"""The port's host-time spans (rac2d_torch.utils.spans), on the CPU.

The registry itself: nested spans' self times add up to the outer
span's wall time, entries are counted, reset/totals/kept.  The BDF
round's spans on a small pool solve (tests/test_torch_bdf.py's Robertson
batch): no record_function is entered while no profiler runs; under
torch.profiler the round's spans appear as labels nested as in
utils/spans.py; chem.step is entered once a round; the solve's arrays
do not change with the profiler on.  Then one iteration of DiskModel.run
on tests/test_torch_run.py's one-column model through each sweep: the
kept table of the sweep, the fields' timers read from the spans, the
log's "chem spans" line and the MC pass's labels.  About a minute on one
CPU thread.
"""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rac2d_torch.ops import bdf
from rac2d_torch.utils import spans
from rac2d_torch.utils.spans import span

from test_torch_bdf import _batch, _rows
from torch_mc_fixtures import one_torch_thread  # noqa: F401 (autouse)

ROUND_SPANS = ("chem.rhs", "chem.jac", "chem.factor", "chem.solve")


def busy(s):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < s:
        pass


def test_self_times_add_up_to_the_outer_wall():
    spans.reset()
    with span("t.outer") as outer:
        busy(2e-3)
        for _ in range(3):
            with span("t.inner"):
                busy(1e-3)
                with span("t.leaf"):
                    busy(1e-3)
        busy(1e-3)
    tot = spans.totals()
    assert {k: n for k, (_, n) in tot.items()} == {
        "t.outer": 1, "t.inner": 3, "t.leaf": 3}
    assert sum(s for s, _ in tot.values()) == pytest.approx(outer.seconds,
                                                            abs=1e-9)
    assert tot["t.leaf"][0] >= 3e-3 and tot["t.inner"][0] >= 3e-3
    assert tot["t.outer"][0] >= 3e-3
    assert tot["t.outer"][0] < outer.seconds - 6e-3
    spans.reset()
    assert spans.totals() == {} and spans.kept() == []


def test_kept_table_holds_what_ran_inside():
    spans.reset()
    with span("t.before"):
        pass
    with span("t.kept", keep=True) as k:
        with span("t.inner"):
            busy(1e-3)
        with span("t.inner"):
            pass
    (name, table), = spans.kept()
    assert name == "t.kept"
    assert {n: c for n, (_, c) in table.items()} == {"t.kept": 1,
                                                     "t.inner": 2}
    assert sum(s for s, _ in table.values()) == pytest.approx(k.seconds,
                                                              abs=1e-9)


def pool_solve():
    """A small pool solve: 6 Robertson lanes through a window of 4, 8
    rounds a call (refill, flush and every branch of the round)."""
    f_b, jac_b = _batch()
    N = 6
    y0 = torch.zeros(N, 3, dtype=torch.float64)
    y0[:, 0] = torch.linspace(0.5, 1.0, N)
    return bdf.bdf_solve_batch_pool(
        f_b, jac_b, y0, 0.0, np.logspace(-5, 0, 6), _rows(1e-6, N),
        _rows(1e-10, N), 1e-6, width=4, rounds_per_call=8)


def test_no_record_function_without_a_profiler(monkeypatch):
    entered = []

    def fake(name):
        entered.append(name)
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(spans, "record_function", fake)
    spans.reset()
    res = pool_solve()
    assert entered == []
    assert spans.totals()["chem.step"][1] == res.n_rounds


def test_round_spans_under_the_profiler():
    """(b) the labels and their nesting, (c) the counts, (d) the arrays
    bit-equal with and without the profiler."""
    spans.reset()
    plain = pool_solve()
    counts = {k: n for k, (_, n) in spans.totals().items()}
    assert counts["chem.step"] == plain.n_rounds
    assert counts["chem.jac"] <= counts["chem.factor"] <= counts["chem.step"]
    assert counts["chem.rhs"] == counts["chem.solve"] > counts["chem.step"]

    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = pool_solve()
    assert {k: n for k, (_, n) in spans.totals().items()} == counts
    for f in plain._fields:
        a, b = getattr(plain, f), getattr(traced, f)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f
        else:
            assert a == b, f

    ev = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("chem."):
            ev.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    assert {k: len(v) for k, v in ev.items()} == counts
    steps = np.array(sorted(ev["chem.step"]))

    def in_step(s, e):
        j = np.searchsorted(steps[:, 0], s, side="right") - 1
        return j >= 0 and steps[j, 0] <= s and e <= steps[j, 1]

    for name in ROUND_SPANS:
        assert all(in_step(s, e) for s, e in ev[name]), name
    inside = [in_step(s, e) for s, e in ev["chem.sync"]]
    # the round's own reads, and the pool loop's between the rounds
    assert any(inside) and not all(inside)


@pytest.mark.parametrize("stream", [True, False])
def test_sweep_spans(stream):
    """One iteration of run() through the pool sweep or the chunked sweep
    with evolT=False: the sweep's kept table, the fields' timers, the
    log line, the MC pass's labels."""
    from test_torch_run import tiny_cfg
    driver, cfg = tiny_cfg("torch", 2e-8, "one", chem_chunk=2,
                           evolT=False, chem_stream=stream)
    m = driver.DiskModel(cfg, device="cpu")
    m.prepare()
    spans.reset()
    m.run(n_iter=1)
    name, table = spans.kept()[-1]
    assert name == "chem.sweep"
    assert {"chem.sweep", "chem.shield", "chem.envs", "chem.pool",
            "chem.step", "chem.rhs", "chem.jac", "chem.factor",
            "chem.solve", "chem.sync", "chem.eqT", "chem.eqT.eval",
            "chem.eqT.read"} == set(table)
    rounds = m.pool_result.n_rounds if stream else m.chunk_rounds
    assert table["chem.step"][1] == rounds > 0
    assert table["chem.sweep"][1] == 1
    # the fields' timers are the spans' inclusive times (nothing opens
    # inside chem.shield; the equilibrium T's assembly is not in _t_envs)
    assert m._t_shield == table["chem.shield"][0]
    assert 0.0 < m._t_envs < table["chem.envs"][0]
    wall = m.stage_times[0]["chemistry"]
    assert sum(s for s, _ in table.values()) == pytest.approx(wall,
                                                              rel=0.02)
    line = [ln for ln in m.log if ln.startswith("  chem spans: ")]
    assert len(line) == 1 and "chem.step " in line[0]
    assert f"chem.step {table['chem.step'][0]:.3f}s/{rounds}" in line[0]
    assert {"mc.launch", "mc.walk", "mc.live_count", "mc.finish",
            "mc.rescale"} <= set(spans.totals())


@pytest.mark.parametrize("T0, n_expand", [(20.0, 60), (3e4, 1)])
def test_equilibrium_T_spans(monkeypatch, T0, n_expand):
    """One solve_equilibrium_T call on two lanes enters chem.eqT.eval once
    for each evaluation of the net rate and chem.eqT.read once for each
    loop test read back to the host, counted by wrapping the solve's own
    calls (ThermalBalance.net_rate, Tensor.any); with a bracket found the
    loops end at their tests, and from T0 = 3e4 K with one expansion step
    the expansion runs out after one evaluation and the bisection's first
    test ends it."""
    from test_torch_eq_temperature_ref import CELLS, port_inputs
    p = port_inputs(CELLS[:2])
    tb = p["tb"]
    counts = {"eval": 0, "read": 0}

    def net_rate(*a, **k):
        counts["eval"] += 1
        return type(tb).net_rate(tb, *a, **k)

    any_ = torch.Tensor.any

    def read(t, *a, **k):
        counts["read"] += 1
        return any_(t, *a, **k)

    monkeypatch.setattr(tb, "net_rate", net_rate)
    monkeypatch.setattr(torch.Tensor, "any", read)
    spans.reset()
    T, brk = tb.solve_equilibrium_T(
        p["y"], p["env"], p["tenv"],
        torch.full((2,), T0, dtype=torch.float64), p["tab"],
        n_expand=n_expand)
    monkeypatch.undo()
    tot = {k: n for k, (_, n) in spans.totals().items()}
    assert tot == {"chem.eqT.eval": counts["eval"],
                   "chem.eqT.read": counts["read"]}
    if n_expand == 1:
        assert not brk.any() and counts == {"eval": 3, "read": 2}
    else:
        assert brk.all() and counts["eval"] >= 4
        assert counts["read"] == counts["eval"]
