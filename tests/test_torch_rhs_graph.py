"""The batch right-hand side replayed from a CUDA graph
(rac2d_torch.ops.odesys: ChemicalODE._batch_fns's f_b, _graphed,
stale_leaves).

On the CPU: the stale check fires on a swapped leaf and on a leaf
written in place, and on nothing else; f_b is the eager closure bit for
bit, captures nothing and enters no chem.rhs.graph marker.  Tests marked
`cuda` need the card and skip without one; this file imports neither
JAX nor the JAX package, so on the card run it without the repository's
conftest (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_rhs_graph.py

On the card, on the shipped network at small widths: the graphed f_b
against the eager closure from the same inputs, at most 1e-12 relative
over the non-zero entries (the same kernels; only the order of the f64
atomics of the network's index_add_ may differ), after a fresh args
object (a pool refill), after an in-place write to one leaf, and at a
width past RHS_GRAPHS, which runs eager; the marker chem.rhs.graph
counts one entry per replay inside chem.rhs and none for an eager call.
"""

import pytest
import torch

from rac2d_torch.ops import odesys
from rac2d_torch.utils import spans
from rac2d_torch.utils.spans import span
from torch_graph_fixtures import (cuda_device, entries, inputs,  # noqa: F401
                                  net, ode_on, rel_nonzero)
from torch_mc_fixtures import one_torch_thread  # noqa: F401 (autouse)


def eager(ode, y, args):
    envs, tenvs, kb = args
    return ode.make_f(envs, True, tenvs, k=kb)(y)


def replays():
    return entries("chem.rhs.graph")


def test_stale_check_fires_on_a_swapped_or_written_leaf_only():
    a, b = torch.arange(4.0), torch.ones(3, 2)
    c = torch.zeros(5)
    leaves = [a, b, c]
    seen = [(x, x._version) for x in leaves]
    assert odesys.stale_leaves(leaves, seen) == []
    # equal values in another tensor (a refill's clone) is a swap
    assert odesys.stale_leaves([a, b.clone(), c], seen) == [1]
    # reading leaves nothing stale; writing in place does, through a view
    # of the leaf as well
    _ = a * 2.0 + c.sum()
    assert odesys.stale_leaves(leaves, seen) == []
    c.add_(1.0)
    b[:, 0].fill_(2.0)
    assert odesys.stale_leaves(leaves, seen) == [1, 2]
    seen = [(x, x._version) for x in leaves]
    assert odesys.stale_leaves(leaves, seen) == []


def test_spans_inside_names_the_innermost_span():
    assert not spans.inside("chem.rhs")
    with span("chem.rhs"):
        assert spans.inside("chem.rhs")
        with span("t.other"):
            assert not spans.inside("chem.rhs")
        assert spans.inside("chem.rhs")
    assert not spans.inside("chem.rhs")


def test_f_b_on_the_cpu_is_the_eager_closure(net):
    ode = ode_on(net, "cpu")
    y, args = inputs(net, 3, 1, "cpu")
    f_b, _, _ = ode._batch_fns(True)
    spans.reset()
    with span("chem.rhs"):
        out = f_b(y, args)
    assert torch.equal(out, eager(ode, y, args))
    assert ode._graphs == {} and replays() == 0


@pytest.mark.cuda
def test_graphed_f_b_against_eager(net, cuda_device):
    ode = ode_on(net, cuda_device)
    f_b, _, _ = ode._batch_fns(True)
    spans.reset()
    n = 0
    for W, seed in ((5, 2), (3, 3)):
        y, args = inputs(net, W, seed, cuda_device)
        with span("chem.rhs"):
            first = f_b(y, args)
            again = f_b(y, args)
        n += 2
        assert rel_nonzero(first, eager(ode, y, args)) <= 1e-12
        assert rel_nonzero(again, first) <= 1e-12
        # the result is the caller's: the next replay leaves it alone
        keep = first.clone()
        with span("chem.rhs"):
            f_b(y * 1.5, args)
        n += 1
        assert torch.equal(first, keep)
        # a fresh args object with other values, as after a refill
        y2, args2 = inputs(net, W, seed + 10, cuda_device)
        with span("chem.rhs"):
            out = f_b(y2, args2)
        n += 1
        assert rel_nonzero(out, eager(ode, y2, args2)) <= 1e-12
        # an in-place write to one leaf of the same args object
        args2[0].n_gas.mul_(3.0)
        with span("chem.rhs"):
            out = f_b(y2, args2)
        n += 1
        assert rel_nonzero(out, eager(ode, y2, args2)) <= 1e-12
    assert len(ode._graphs) == 2
    assert replays() == n
    # a replay outside chem.rhs (a solve's initial RHS) enters no marker
    f_b(y2, args2)
    assert replays() == n


@pytest.mark.cuda
def test_width_past_the_limit_runs_eager(net, cuda_device):
    ode = ode_on(net, cuda_device)
    f_b, _, _ = ode._batch_fns(True)
    widths = [1 + i for i in range(odesys.RHS_GRAPHS)]
    for W in widths:
        f_b(*inputs(net, W, 5 + W, cuda_device))
    assert len(ode._graphs) == odesys.RHS_GRAPHS
    y, args = inputs(net, odesys.RHS_GRAPHS + 3, 6, cuda_device)
    spans.reset()
    with span("chem.rhs"):
        out = f_b(y, args)
    assert replays() == 0 and len(ode._graphs) == odesys.RHS_GRAPHS
    assert rel_nonzero(out, eager(ode, y, args)) <= 1e-12
    # a width held before still replays
    y, args = inputs(net, widths[0], 7, cuda_device)
    with span("chem.rhs"):
        out = f_b(y, args)
    assert replays() == 1
    assert rel_nonzero(out, eager(ode, y, args)) <= 1e-12
