"""The batch Jacobian replayed from a CUDA graph
(rac2d_torch.ops.odesys: ChemicalODE._batch_fns's jac_b, _graphed).

On the CPU: jac_b is the eager closure bit for bit, captures nothing and
enters no chem.jac.graph marker; make_jac's key-species indices, built
once on the ODE's device, give the output that indices built at each
call (as a host-to-device copy, which no graph can capture) give.
Tests marked `cuda` need the card and skip without one; this file
imports neither JAX nor the JAX package, so on the card run it without
the repository's conftest (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_jac_graph.py

On the card, on the shipped network at small widths and for evolT True
and False: the graphed jac_b against the eager closure from the same
inputs, after a fresh args object (a pool refill) and after an in-place
write to one leaf.  With CUDA's atomic f64 sums (the default, as the
solvers run) the species block and the key-species T row agree to at
most 1e-12 relative over their non-zero entries; the FD T column is left
to the next case, since the eager closure does not reproduce it itself
(two eager calls at 256 lanes differ in which of its entries are 0, by
up to 1.3e-11 of the lane's largest, on an H100).  Under torch's
deterministic algorithms, captured in that mode, the whole J is the
eager one bit for bit.  A returned J is the caller's, unchanged by the
next replay; a width past JAC_GRAPHS runs eager; the RHS's graphs,
counted apart, still capture and replay after the Jacobian's; the
marker chem.jac.graph counts one entry per replay inside chem.jac and
none for an eager call.
"""

import contextlib

import pytest
import torch

from rac2d_torch.ops import odesys
from rac2d_torch.utils import spans
from rac2d_torch.utils.spans import span
from torch_graph_fixtures import (cuda_device, entries, inputs,  # noqa: F401
                                  net, ode_on, rel_nonzero, small_net)
from torch_mc_fixtures import one_torch_thread  # noqa: F401 (autouse)


def with_rates(ode, evolT, y, args):
    """args as the solvers pass them: rate vectors once a solve for a
    fixed temperature, None for a live one."""
    envs, tenvs, _ = args
    return y, (envs, tenvs, None if evolT else ode._rates(envs, envs.Tgas))


def lanes(ode, net, evolT, W, seed, device):
    return with_rates(ode, evolT, *inputs(net, W, seed, device))


def eager(ode, evolT, y, args):
    envs, tenvs, kb = args
    return ode.make_jac(envs, evolT, tenvs, k=kb)(y)


def replays():
    return entries("chem.jac.graph")


def gap(a, b, ode, evolT):
    """rel_nonzero over the species block and, with evolT, the key-species
    T row: every entry of J that does not come from the FD T column."""
    nS, ki = ode.n_species, ode.key_idx
    g = rel_nonzero(a[:, :nS, :nS], b[:, :nS, :nS])
    return max(g, rel_nonzero(a[:, nS, ki], b[:, nS, ki])) if evolT else g


@contextlib.contextmanager
def summed_in(mode, monkeypatch):
    """CUDA's scatter sums as atomics ("atomic", the default) or in a
    fixed order ("fixed": torch's deterministic algorithms, strict)."""
    was = torch.are_deterministic_algorithms_enabled()
    if mode == "fixed":
        monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


@pytest.mark.parametrize("evolT", [True, False])
def test_jac_b_on_the_cpu_is_the_eager_closure(net, evolT):
    ode = ode_on(net, "cpu")
    y, args = lanes(ode, net, evolT, 3, 1, "cpu")
    _, jac_b, _ = ode._batch_fns(evolT)
    spans.reset()
    with span("chem.jac"):
        out = jac_b(y, args)
    assert out.dtype == torch.float64
    assert torch.equal(out, eager(ode, evolT, y, args))
    assert ode._graphs == {} and replays() == 0


@pytest.mark.parametrize("W", [1, 3])
def test_key_rows_built_once_give_the_per_call_arithmetic(small_net, W):
    ode = ode_on(small_net, "cpu")
    nk = len(ode.key_idx)
    assert ode._key_idx_t.device == ode.device == ode._key_rows.device
    assert ode._key_idx_t.tolist() == ode.key_idx
    assert ode._key_rows.tolist() == list(range(nk))
    y, args = inputs(small_net, W, 4, "cpu")
    # a negative key species takes the row's other branch (zero)
    y[0, ode.key_idx[2]] = -1e-20
    once = eager(ode, True, y, args)
    assert torch.count_nonzero(once[:, ode.n_species, ode.key_idx]) > 0
    # the indices as make_jac built them at each call before: the key
    # list copied from the host, the rows a host arange
    ode._key_idx_t = torch.as_tensor(ode.key_idx, device=y.device)
    ode._key_rows = torch.arange(nk)
    assert torch.equal(eager(ode, True, y, args), once)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["atomic", "fixed"])
@pytest.mark.parametrize("evolT", [True, False])
def test_graphed_jac_b_against_eager(net, cuda_device, monkeypatch, evolT,
                                     mode):
    with summed_in(mode, monkeypatch):
        graphed_against_eager(net, cuda_device, evolT, mode)


def graphed_against_eager(net, device, evolT, mode):
    ode = ode_on(net, device)
    _, jac_b, _ = ode._batch_fns(evolT)

    def same(out, ref):
        if mode == "fixed":
            return torch.equal(out, ref)
        return gap(out, ref, ode, evolT) <= 1e-12

    spans.reset()
    n = 0
    for W, seed in ((5, 2), (3, 3)):
        y, args = lanes(ode, net, evolT, W, seed, device)
        with span("chem.jac"):
            first = jac_b(y, args)
            again = jac_b(y, args)
        n += 2
        assert first.dtype == torch.float64
        assert same(first, eager(ode, evolT, y, args))
        assert same(again, first)
        # the result is the caller's: the next replay leaves it alone
        keep = first.clone()
        with span("chem.jac"):
            jac_b(y * 1.5, args)
        n += 1
        assert torch.equal(first, keep)
        # a fresh args object with other values, as after a refill
        y2, args2 = lanes(ode, net, evolT, W, seed + 10, device)
        with span("chem.jac"):
            out = jac_b(y2, args2)
        n += 1
        assert same(out, eager(ode, evolT, y2, args2))
        # an in-place write to one leaf of the same args object
        (args2[0].n_gas if evolT else args2[2]).mul_(3.0)
        with span("chem.jac"):
            out = jac_b(y2, args2)
        n += 1
        assert same(out, eager(ode, evolT, y2, args2))
    assert len(ode._graphs) == 2
    assert replays() == n
    # a replay outside chem.jac enters no marker
    jac_b(y2, args2)
    assert replays() == n


@pytest.mark.cuda
def test_jac_width_past_the_limit_runs_eager(net, cuda_device):
    ode = ode_on(net, cuda_device)
    _, jac_b, _ = ode._batch_fns(True)
    widths = [1 + i for i in range(odesys.JAC_GRAPHS)]
    for W in widths:
        jac_b(*inputs(net, W, 5 + W, cuda_device))
    assert len(ode._graphs) == odesys.JAC_GRAPHS
    y, args = inputs(net, odesys.JAC_GRAPHS + 3, 6, cuda_device)
    spans.reset()
    with span("chem.jac"):
        out = jac_b(y, args)
    assert replays() == 0 and len(ode._graphs) == odesys.JAC_GRAPHS
    assert gap(out, eager(ode, True, y, args), ode, True) <= 1e-12
    # a width held before still replays
    y, args = inputs(net, widths[0], 7, cuda_device)
    with span("chem.jac"):
        out = jac_b(y, args)
    assert replays() == 1
    assert gap(out, eager(ode, True, y, args), ode, True) <= 1e-12


@pytest.mark.cuda
def test_rhs_graphs_outlive_the_jacobian_captures(net, cuda_device):
    ode = ode_on(net, cuda_device)
    f_b, jac_b, _ = ode._batch_fns(True)
    y, args = inputs(net, 4, 8, cuda_device)
    f_b(y, args)
    # the Jacobian's cap filled, its first width the RHS's
    for W in [4] + [10 + i for i in range(odesys.JAC_GRAPHS - 1)]:
        jac_b(*inputs(net, W, 20 + W, cuda_device))
    spans.reset()
    with span("chem.rhs"):
        out = f_b(y, args)
    assert entries("chem.rhs.graph") == 1
    assert rel_nonzero(out, ode.make_f(args[0], True, args[1])(y)) <= 1e-12
    # an RHS width not yet seen is still captured
    y, args = inputs(net, 6, 9, cuda_device)
    with span("chem.rhs"):
        out = f_b(y, args)
    assert entries("chem.rhs.graph") == 2
    assert rel_nonzero(out, ode.make_f(args[0], True, args[1])(y)) <= 1e-12
    assert len(ode._graphs) == 2 + odesys.JAC_GRAPHS
