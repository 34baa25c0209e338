"""The chemistry cells' driver and check on the CPU, at the size of
tests/tiny.json (a 5-column disk, 3 cells a sweep through a window of 2,
to 2e-8 yr): the stratified cells, the snapshot's restore, the result
line, the control and the faults that the check has to catch.  About four
minutes on one CPU thread."""

import json

import numpy as np
import pytest
import torch

import run
from chemref import compare
from harness import spec

SEED = 2 ** 31 + 11
TINY = json.loads((spec.BENCH / "tests" / "tiny.json").read_text())
TRAFFIC = json.loads(spec.traffic_file("chem").read_text())


@pytest.fixture(scope="module")
def drv():
    return spec.load_module("drivers", "chem_sweeps")


@pytest.fixture(scope="module")
def st(drv):
    torch.set_num_threads(1)
    return drv.setup(TINY, TRAFFIC, SEED, torch.device("cpu"))


@pytest.fixture(scope="module")
def sound(drv, st):
    """A sound window of one sweep, the program's state and the check."""
    record, _ = drv.window(st, 0.0, False)
    prog = drv.reference_inputs(st, record)
    return record, prog, compare.check(prog, record, TRAFFIC)


def test_draws_repeat_and_stratify(drv, st, sound):
    """A sweep holds the middle cell of each density stratum, the same in
    every sweep and for every seed."""
    strata = np.array_split(st.by_density, st.n_per_sweep)
    assert [s[len(s) // 2] for s in strata] == list(st.cells)
    assert np.array_equal(drv.strata_middles(st.by_density, st.n_per_sweep),
                          st.cells)
    for s in sound[0]["sweeps"]:
        assert np.array_equal(np.sort(s["cells"]), np.sort(st.cells))


def test_restore_leaves_the_snapshot(drv, st, sound):
    m = st.model
    X0, T0, q0 = st.snap
    assert np.array_equal(m.X, X0) and np.array_equal(m.Tgas, T0)
    assert np.array_equal(m.quality, q0)
    assert np.array_equal(m.grid.using, st.using)
    # the sweep itself moved its cells
    s = sound[0]["sweeps"][0]
    assert not np.array_equal(s["X"], X0[:, s["cells"]])


def test_sound_window_is_correct(sound):
    checks, correct = sound[2]
    assert correct, checks
    assert set(checks) == set(compare.LIMITS) | {"sweeps_past_deadline"}


def test_control_fails(sound):
    """The reference in float32 at the configuration's tolerances, in the
    program's place, fails a limit."""
    record, prog, _ = sound
    _, _, ctl = compare.readings(prog, record, TRAFFIC, ["f32:config"])
    r = ctl["f32:config"]
    assert any(r[k] > compare.LIMITS[k] for k in r), r


def unchanged(orig):
    def solve_pool(envs, y0, T0, *a, **k):
        res = orig(envs, y0, T0, *a, **k)
        y = torch.cat([y0, T0[:, None]], dim=1).cpu()
        return res._replace(ys=y[:, None, :])
    return solve_pool


def half_left_out(orig):
    def solve_pool(envs, y0, T0, *a, **k):
        n = y0.shape[0]
        h = n // 2

        def first(t):
            return type(t)(*(f[:h] for f in t))
        res = orig(first(envs), y0[:h], T0[:h], *a,
                   **dict(k, tenvs=first(k["tenvs"])))
        y = torch.cat([y0, T0[:, None]], dim=1).cpu()
        y[:h] = res.ys[:, -1]

        def grow(t, fill):
            out = torch.full((n,) + t.shape[1:], fill, dtype=t.dtype)
            out[:h] = t
            return out
        return res._replace(ys=y[:, None, :], fail=grow(res.fail, False),
                            n_steps=grow(res.n_steps, 0),
                            retry_level=grow(res.retry_level, 0))
    return solve_pool


def altered(orig, i):
    def solve_pool(*a, **k):
        res = orig(*a, **k)
        ys = res.ys.clone()
        ys[:, -1, i] *= 1.01
        return res._replace(ys=ys)
    return solve_pool


@pytest.mark.parametrize("fault", ["unchanged", "half_left_out", "altered"])
def test_check_catches_the_faults(drv, st, fault):
    """With the timed path broken underneath, the rest of a run reads
    `correct` false: a step that returns its state unchanged, half of the
    pool left out, an answer altered where it is produced (CO by 1%)."""
    ode = st.model.ode
    orig = ode.solve_pool
    ode.solve_pool = {"unchanged": lambda: unchanged(orig),
                      "half_left_out": lambda: half_left_out(orig),
                      "altered": lambda: altered(
                          orig, st.model.net.idx["CO"])}[fault]()
    try:
        record, _ = drv.window(st, 0.0, False)
    finally:
        del ode.solve_pool
    prog = drv.reference_inputs(st, record)
    checks, correct = compare.check(prog, record, TRAFFIC)
    assert not correct, checks


@pytest.mark.parametrize("traced", [False, True])
def test_result_line(traced):
    """The keys of a run's last line; the breakdown only when traced."""
    bench = spec.load_spec()
    cell, _ = spec.cell_of(bench, "twhya.chem")
    line = run.run_cell(bench, cell, TINY, SEED, 0.0, traced,
                        torch.device("cpu"))
    want = ["correct", "attempted", "failed", "metrics", "device"] + (
        ["breakdown"] if traced else []) + ["checks"]
    assert list(line) == want
    assert set(line["metrics"]) <= {
        m["name"] for m in spec.metrics_of(bench, "twhya.chem", traced)}
    assert {"platform", "kind", "count", "memory_peak_bytes"} \
        <= set(line["device"])
    if traced:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(line)
