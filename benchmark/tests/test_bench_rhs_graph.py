"""metrics/chem.rhs_graph_share.py on synthetic kept tables: the
program's own spans, entered as a sweep with its rounds, Newton
right-hand sides and graph replays would enter them (no card, no
model).  It reads 100 x replays / right-hand sides where the table
matches the window, and nothing where it does not or where the program
has no graphed right-hand side."""

import pytest

import run
from harness import spec
from rac2d_torch.ops import odesys
from rac2d_torch.utils.spans import span

READER = spec.load_module("metrics", "chem.rhs_graph_share")


def sweep(rounds, rhs, replays):
    """A kept chem.sweep table with `rounds` chem.step entries, `rhs`
    chem.rhs entries and a chem.rhs.graph marker inside the first
    `replays` of them; the window's record of that one sweep."""
    with span("chem.sweep", keep=True):
        for _ in range(rounds):
            with span("chem.step"):
                pass
        for i in range(rhs):
            with span("chem.rhs"):
                if i < replays:
                    with span("chem.rhs.graph"):
                        pass
    record = {"sweeps": [{"rounds": rounds}], "timed": {"rounds": rounds}}
    return run.Run(record, None, 0.0, "cpu")


@pytest.mark.parametrize("rhs, replays", [(30, 30), (30, 29), (7, 0)])
def test_reads_the_share_of_replays(rhs, replays):
    r = sweep(10, rhs, replays)
    assert READER.read(r) == pytest.approx(100.0 * replays / rhs, rel=1e-12)


def test_nothing_read_where_the_table_does_not_match_the_window():
    r = sweep(10, 30, 30)
    r.record["sweeps"][0]["rounds"] = 11
    assert READER.read(r) is None


def test_nothing_read_without_a_graphed_rhs(monkeypatch):
    r = sweep(10, 30, 30)
    monkeypatch.delattr(odesys, "RHS_GRAPHS")
    assert READER.read(r) is None
