"""The per-layer metrics read from the program's chemistry spans
(harness/chem_spans.py, metrics/chem.*_ms.py and chem.*_per_round.py),
on the CPU at the size of tests/tiny.json: finite on a traced window,
each sweep's spans adding up to its wall time, chem.step entered once a
BDF round, the metrics that were there reading the same record as
before, and nothing read where the program has no spans."""

import json
import math
import sys

import pytest
import torch

import run
from harness import chem_spans, spec

SEED = 2 ** 31 + 13
TINY = json.loads((spec.BENCH / "tests" / "tiny.json").read_text())
TRAFFIC = json.loads(spec.traffic_file("chem").read_text())
BENCH = spec.load_spec()
NEW = ["chem.step_ms", "chem.rhs_ms", "chem.jac_ms", "chem.lu_ms",
       "chem.sync_ms", "chem.pool_ms", "chem.syncs_per_round",
       "chem.newton_per_round"]
MS = NEW[:6]


@pytest.fixture(scope="module")
def st():
    torch.set_num_threads(1)
    drv = spec.load_module("drivers", "chem_sweeps")
    return drv, drv.setup(TINY, TRAFFIC, SEED, torch.device("cpu"))


@pytest.fixture(scope="module", params=[True, False],
                ids=["traced", "untraced"])
def window(st, request):
    """A window of one sweep, traced or not, with the program's kept
    tables of its sweeps as they stand after it."""
    from rac2d_torch.utils import spans
    drv, s = st
    record, trace = drv.window(s, 0.0, request.param)
    return run.Run(record, trace, 0.0, "cpu"), spans.kept()


def readers(names):
    return {n: spec.load_module("metrics", n) for n in names}


def test_new_metrics_are_declared():
    per_layer = {m["name"]: m for m in BENCH["per_layer"]}
    for n in NEW:
        m = per_layer[n]
        assert m["moves"] == "chem_cells_per_s"
        assert m["workloads"] == ["twhya.chem"]


def test_new_metrics_read_finite_numbers(window):
    r, _ = window
    vals = {n: f.read(r) for n, f in readers(NEW).items()}
    assert all(isinstance(v, float) and math.isfinite(v) and v >= 0.0
               for v in vals.values()), vals
    assert vals["chem.newton_per_round"] >= 1.0
    assert vals["chem.syncs_per_round"] >= 3.0
    assert vals["chem.rhs_ms"] > 0.0 and vals["chem.lu_ms"] > 0.0
    # the six ms metrics and the sweep's own self time make up the round
    # less the fields (chem.round_ms) within the host's time outside
    # chemistry_step
    w = chem_spans.window(r)
    t = r.record["timed"]
    sweep = 1e3 * w["chem.sweep"][0] / t["rounds"]
    round_ms = readers(["chem.round_ms"])["chem.round_ms"].read(r)
    assert sum(vals[n] for n in MS) + sweep == pytest.approx(round_ms,
                                                             rel=0.02)


def test_each_sweep_adds_up_to_its_wall(window):
    r, kept = window
    sweeps = r.record["sweeps"]
    tables = [t for name, t in kept if name == "chem.sweep"]
    if r.trace is not None:
        tables = tables[:-1]
    for t, sw in zip(tables[-len(sweeps):], sweeps):
        assert t["chem.step"][1] == sw["rounds"]
        assert set(t) <= {"chem.sweep", "chem.shield", "chem.envs",
                          "chem.pool", "chem.step", "chem.rhs", "chem.jac",
                          "chem.factor", "chem.solve", "chem.sync"}
        assert sum(s for s, _ in t.values()) == pytest.approx(sw["wall_s"],
                                                              rel=0.02)


def test_existing_metrics_read_the_same_record(window):
    """The metrics that were there read the record as before: the
    record's keys are the driver's own, and reading the new metrics
    changes none of their values."""
    r, _ = window
    assert set(r.record["timed"]) == {"wall_s", "fields_s", "rounds",
                                      "steps", "cells", "sweeps"}
    old = [m["name"] for m in BENCH["per_layer"] + BENCH["end_to_end"]
           if m["name"] not in NEW and m["source"] != "device_trace"]
    old_r = readers(old)
    before = {n: f.read(r) for n, f in old_r.items()}
    for f in readers(NEW).values():
        f.read(r)
    assert {n: f.read(r) for n, f in old_r.items()} == before
    assert all(v is not None for v in before.values()), before


def test_nothing_read_without_the_program_spans(window, monkeypatch):
    import rac2d_torch.utils
    r, _ = window
    monkeypatch.delattr(rac2d_torch.utils, "spans")
    monkeypatch.setitem(sys.modules, "rac2d_torch.utils.spans", None)
    assert all(f.read(r) is None for f in readers(NEW).values())


def test_nothing_read_from_sweeps_that_do_not_match(window):
    r, _ = window
    other = dict(r.record, sweeps=[dict(s, rounds=s["rounds"] + 1)
                                   for s in r.record["sweeps"]])
    bad = run.Run(other, r.trace, 0.0, "cpu")
    assert all(f.read(bad) is None for f in readers(NEW).values())
