"""The fixed-temperature cell twhya_eqT.chem on the CPU, at the size of
tests/tiny_eqT.json (tests/tiny.json with evolT false: 3 cells a sweep
through a window of 2, to 2e-8 yr, the gas temperature set after the
pool by the equilibrium-T bisection): its entries in BENCHMARK.json, a
sound window correct against the plain reference with the four metrics
of the equilibrium-T solve reading numbers, the metrics' arithmetic and
their silence on a program without the solve's spans, the control and
the faults of the equilibrium-T stage that the check has to catch.  The
fixture drv is test_bench_chem.py's.  A few minutes on one CPU thread."""

import json

import pytest
import torch

import run
from chemref import compare
from harness import spec
from rac2d_torch.utils.spans import span

from test_bench_chem import SEED, TRAFFIC, drv  # noqa: F401 (fixture)

TINY_EQT = json.loads((spec.BENCH / "tests" / "tiny_eqT.json").read_text())
BENCH = spec.load_spec()
CELL = "twhya_eqT.chem"
NEW = ["chem.eqT_ms", "chem.eqT_read_ms", "chem.eqT_evals_per_window",
       "chem.fixedT_round_ms"]


def readers(names):
    return {n: spec.load_module("metrics", n) for n in names}


@pytest.fixture(scope="module")
def st(drv):  # noqa: F811
    torch.set_num_threads(1)
    return drv.setup(TINY_EQT, TRAFFIC, SEED, torch.device("cpu"))


@pytest.fixture(scope="module")
def sound(drv, st):  # noqa: F811
    """A sound window of one sweep, the metrics read right after it (from
    the program's kept tables as they then stand), the program's state
    and the check."""
    record, _ = drv.window(st, 0.0, False)
    r = run.Run(record, None, 0.0, "cpu")
    vals = {n: f.read(r)
            for n, f in readers(NEW + ["chem.round_ms"]).items()}
    prog = drv.reference_inputs(st, record)
    return record, vals, prog, compare.check(prog, record, TRAFFIC)


def test_cell_is_declared():
    """The configuration is twhya's with evolT false; the cell runs it
    under the chem traffic on one card; the four metrics read it alone."""
    cell, conf = spec.cell_of(BENCH, CELL)
    assert (cell["traffic"], cell["chips"]) == ("chem", 1)
    cfg = spec.read_json(conf["file"])
    base = spec.read_json(spec.cell_of(BENCH, "twhya.chem")[1]["file"])
    assert cfg["evolT"] is False and base["evolT"] is True
    differ = {k for k in set(cfg) | set(base) if cfg.get(k) != base.get(k)}
    assert differ == {"name", "source", "evolT"}
    assert conf["reduced"] == ["t_max", "cells_per_sweep"]
    per_layer = {m["name"]: m for m in BENCH["per_layer"]}
    for n in NEW:
        assert per_layer[n]["workloads"] == [CELL]
        assert per_layer[n]["moves"] == "chem_cells_per_s"
    assert [m["name"] for m in spec.metrics_of(BENCH, CELL, True)] == NEW


def test_sound_window_is_correct(sound):
    record, _, _, (checks, correct) = sound
    assert correct, checks
    # the equilibrium T moved the cells' gas temperature off its start
    s = record["sweeps"][0]
    assert (s["Tgas"] != s["Tgas0"]).any()


def test_new_metrics_read_numbers(sound):
    vals = sound[1]
    assert all(isinstance(v, float) and v > 0.0 for v in vals.values()), \
        vals
    assert vals["chem.eqT_evals_per_window"] >= 2.0
    assert vals["chem.eqT_read_ms"] < vals["chem.eqT_ms"]
    assert vals["chem.fixedT_round_ms"] < vals["chem.round_ms"]


def table(rounds, evals, reads, cells=3, width=2, seconds=1.0, eqt=True):
    """A kept chem.sweep table of one sweep of `rounds` BDF rounds and
    (eqt) an equilibrium-T solve of `evals` evaluations and `reads` reads
    (each span's body empty), and the window's record of it."""
    with span("chem.sweep", keep=True):
        for _ in range(rounds):
            with span("chem.step"):
                pass
        if eqt:
            with span("chem.eqT"):
                for i in range(max(evals, reads)):
                    if i < reads:
                        with span("chem.eqT.read"):
                            pass
                    if i < evals:
                        with span("chem.eqT.eval"):
                            pass
    record = {"sweeps": [{"rounds": rounds, "cells": list(range(cells))}],
              "width": width,
              "timed": {"rounds": rounds, "sweeps": 1, "wall_s": seconds,
                        "fields_s": 0.25 * seconds}}
    return run.Run(record, None, 0.0, "cpu")


def test_metrics_arithmetic():
    """On a synthetic table: evaluations over ceil(cells / width) windows,
    the eqT time out of the round, the read time inside the eqT time."""
    from harness import chem_spans
    r = table(rounds=10, evals=14, reads=12, cells=3, width=2)
    vals = {n: f.read(r) for n, f in readers(NEW).items()}
    assert vals["chem.eqT_evals_per_window"] == 7.0
    w = chem_spans.window(r)
    eqt = sum(w[n][0] for n in ("chem.eqT", "chem.eqT.eval",
                                "chem.eqT.read"))
    assert vals["chem.eqT_ms"] == pytest.approx(1e3 * eqt, rel=1e-12)
    assert vals["chem.eqT_read_ms"] == pytest.approx(
        1e3 * w["chem.eqT.read"][0], rel=1e-12)
    assert vals["chem.fixedT_round_ms"] == pytest.approx(
        1e3 * (0.75 - eqt) / 10, rel=1e-12)


def test_nothing_read_without_the_solve_spans():
    """A fixed-T window of a program whose solve has no chem.eqT.eval
    (the parent of these spans) reads null, as does a table that does
    not match the window."""
    assert all(f.read(table(10, 0, 0)) is None
               for f in readers(NEW).values())
    r = table(10, 14, 12)
    r.record["sweeps"][0]["rounds"] = 11
    assert all(f.read(r) is None for f in readers(NEW).values())


def test_a_coupled_window_spends_nothing_there():
    """A window with no equilibrium-T solve (a coupled cell: no chem.eqT)
    reads no time and no evaluations in it, and its whole round."""
    r = table(10, 0, 0, eqt=False)
    vals = {n: f.read(r) for n, f in readers(NEW).items()}
    assert vals == {"chem.eqT_ms": 0.0, "chem.eqT_read_ms": 0.0,
                    "chem.eqT_evals_per_window": 0.0,
                    "chem.fixedT_round_ms": pytest.approx(75.0, rel=1e-12)}


def test_control_fails(sound):
    """The reference in float32 at the configuration's tolerances, in the
    program's place, fails a limit."""
    record, _, prog, _ = sound
    _, _, ctl = compare.readings(prog, record, TRAFFIC, ["f32:config"])
    r = ctl["f32:config"]
    assert any(r[k] > compare.LIMITS[k] for k in r), r


def no_equilibrium_T(model):
    """The evolT=False stage skipped: Tgas stays at its restored value."""
    model._equilibrium_T = lambda act, ok, W: None


def loose_bisection(model):
    """The bisection stopped at rtol 1e-2 in place of the configuration's
    1e-5: less accuracy than the deployment states."""
    orig = model.thermal.solve_equilibrium_T

    def solve(*a, **k):
        return orig(*a, **dict(k, rtol=1e-2))
    model.thermal.solve_equilibrium_T = solve


@pytest.mark.parametrize("fault", [no_equilibrium_T, loose_bisection],
                         ids=lambda f: f.__name__)
def test_check_catches_the_faults(drv, st, fault):  # noqa: F811
    m = st.model
    fault(m)
    try:
        record, _ = drv.window(st, 0.0, False)
    finally:
        m.__dict__.pop("_equilibrium_T", None)
        m.thermal.__dict__.pop("solve_equilibrium_T", None)
    prog = drv.reference_inputs(st, record)
    checks, correct = compare.check(prog, record, TRAFFIC)
    assert not correct, checks


def test_traced_line_reads_the_new_metrics():
    """A traced run of the cell: correct, and its line carries the four
    metrics (the traced sweep's table left out of what they read)."""
    cell, _ = spec.cell_of(BENCH, CELL)
    line = run.run_cell(BENCH, cell, TINY_EQT, SEED, 0.0, True,
                        torch.device("cpu"))
    assert line["correct"], line["checks"]
    assert set(line["metrics"]) == set(NEW)
    assert {"busy_s", "window_s"} <= set(line["device"])
    json.dumps(line)
