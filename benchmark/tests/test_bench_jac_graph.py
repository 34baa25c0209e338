"""metrics/chem.jac_graph_share.py on synthetic kept tables: the
program's own spans, entered as a sweep with its rounds, Jacobian
refreshes and graph replays would enter them (no card, no model).  It
reads 100 x replays / refreshes where the table matches the window, and
nothing where it does not or where the program has no graphed
Jacobian."""

import pytest

import run
from harness import spec
from rac2d_torch.ops import odesys
from rac2d_torch.utils.spans import span

READER = spec.load_module("metrics", "chem.jac_graph_share")


def sweep(rounds, refreshes, replays):
    """A kept chem.sweep table with `rounds` chem.step entries,
    `refreshes` chem.jac entries and a chem.jac.graph marker inside the
    first `replays` of them; the window's record of that one sweep."""
    with span("chem.sweep", keep=True):
        for i in range(rounds):
            with span("chem.step"):
                if i < refreshes:
                    with span("chem.jac"):
                        if i < replays:
                            with span("chem.jac.graph"):
                                pass
    record = {"sweeps": [{"rounds": rounds}], "timed": {"rounds": rounds}}
    return run.Run(record, None, 0.0, "cpu")


@pytest.mark.parametrize("refreshes, replays", [(3, 3), (3, 2), (4, 0)])
def test_reads_the_share_of_replays(refreshes, replays):
    r = sweep(10, refreshes, replays)
    assert READER.read(r) == pytest.approx(100.0 * replays / refreshes,
                                           rel=1e-12)


def test_nothing_read_where_the_table_does_not_match_the_window():
    r = sweep(10, 3, 3)
    r.record["sweeps"][0]["rounds"] = 11
    assert READER.read(r) is None


def test_nothing_read_without_a_refresh():
    assert READER.read(sweep(10, 0, 0)) is None


def test_nothing_read_without_a_graphed_jacobian(monkeypatch):
    r = sweep(10, 3, 3)
    monkeypatch.delattr(odesys, "JAC_GRAPHS")
    assert READER.read(r) is None
