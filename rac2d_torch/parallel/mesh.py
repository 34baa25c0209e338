"""Sharding the disk solver over several processes with torch.distributed.

Counterpart of the JAX package's ``parallel/mesh.py``.  The JAX package
runs one SPMD program over a device mesh; here each card is one process
(``torchrun --nproc-per-node N``), NCCL carries the collectives between
cards, and gloo does on the CPU (the tests) or wherever the caller asks
for it.  The decomposition is the JAX package's:

  - axis "cells": the (r, z) grid cells.  The per-cell stiff chemistry
    solves are independent: each rank solves its block of a chunk's
    lanes, the batch-global decisions of the solver are all-reduced so
    that every rank takes the same branches, and the results are
    gathered (``sharded_chemistry_solve``).
  - axis "pkt": Monte Carlo packets.  Each rank walks its block of the
    packet pool through the (replicated) cell optics with its own random
    stream; the per-cell tallies and the packet fates are summed over the
    ranks at the end of the pass (``mc_pass_sharded``).

Both solves use every rank of a process group, the default group unless
the caller gives another (the JAX package flattens its mesh for them).
The mesh helpers (``make_mesh``, ``put_global``, ``shard_batch``,
``replicate``, ``host_local_batch``) keep the JAX package's names for
placing arrays; the solver and the driver need only the group.  A
collective goes through the device of the group's backend: the rank's card for NCCL, the host for gloo (a CUDA
tensor is staged through host memory there).  Nothing falls back: a
failed init raises, and a collective that waits longer than the group's
timeout raises.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

# seconds a collective may wait for the other ranks before it raises
DEFAULT_TIMEOUT_S = 600.0


def init_distributed(coordinator=None, num_processes=None, process_id=None,
                     device="cuda", timeout_s=DEFAULT_TIMEOUT_S):
    """Join the process group: one process per card.

    With no coordinator, the rank, world size and address come from
    torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT);
    otherwise coordinator is "host:port" and num_processes/process_id are
    the world size and this rank.  device "cuda" (the default) uses NCCL
    and binds this process to cuda:LOCAL_RANK; "cpu" uses gloo.  A no-op
    when a group is already initialized.  Returns this rank's device."""
    dev = torch.device(device)
    if dist.is_initialized():
        return rank_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device for NCCL "
                               "(device='cpu' joins with gloo)")
        torch.cuda.set_device(_local_rank())
    kw = dict(backend=backend,
              timeout=datetime.timedelta(seconds=timeout_s))
    if coordinator is None:
        dist.init_process_group(init_method="env://", **kw)
    else:
        dist.init_process_group(init_method=f"tcp://{coordinator}",
                                world_size=int(num_processes),
                                rank=int(process_id), **kw)
    return rank_device(dev)


def _local_rank():
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    n = torch.cuda.device_count()
    return (dist.get_rank() if dist.is_initialized() else 0) % max(n, 1)


def rank_device(device):
    """The device this rank works on for `device`: "cuda" without an index
    is cuda:LOCAL_RANK once a group of several ranks is initialized (the
    card torchrun gives this process); any other device, or any device
    in a single process, is itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and world_size() > 1:
        return torch.device("cuda", _local_rank())
    return dev


def world_size(group=None) -> int:
    """Ranks in the group (1 without an initialized group)."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def rank(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def group_of():
    """The process group the solver shards over: the default group when
    one of several ranks is initialized, else None (one process)."""
    return dist.group.WORLD if world_size() > 1 else None


def collective_device(group=None):
    """Where the group's collectives run: this rank's card for NCCL, the
    host for gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_(t, op=dist.ReduceOp.SUM, group=None):
    """In-place all_reduce of a tensor on any device (staged through the
    group's collective device)."""
    cdev = collective_device(group)
    if t.device == cdev:
        dist.all_reduce(t, op=op, group=group)
        return t
    s = t.to(cdev)
    dist.all_reduce(s, op=op, group=group)
    t.copy_(s)
    return t


def any_rank(flag, group=None) -> bool:
    """Whether `flag` (a host bool or a 0-d/1-element tensor) is true on
    any rank of the group: one all_reduce (MAX) of a 0/1 value, so that
    every rank takes the same branch."""
    if isinstance(flag, torch.Tensor):
        t = flag.reshape(1).to(device=collective_device(group),
                               dtype=torch.int32)
    else:
        t = torch.tensor([1 if flag else 0], dtype=torch.int32,
                         device=collective_device(group))
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())


def any_rank_each(flags, group=None):
    """any_rank of each entry of a 1-D bool tensor, in one all_reduce."""
    t = flags.to(device=collective_device(group), dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return [bool(v) for v in t.tolist()]


def min_rank(value: float, group=None) -> float:
    """The smallest of a host float over the ranks of the group."""
    t = torch.tensor([value], dtype=torch.float64,
                     device=collective_device(group))
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
    return float(t.item())


def all_gather_rows(t, group=None):
    """The ranks' tensors (same shape on every rank) concatenated along
    the leading axis in rank order, on t's device."""
    cdev = collective_device(group)
    src = t.to(torch.uint8) if t.dtype == torch.bool else t
    src = src.contiguous().to(cdev)
    parts = [torch.empty_like(src) for _ in range(world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=0).to(t.device)
    return out.to(torch.bool) if t.dtype == torch.bool else out


def broadcast_(t, src=0, group=None):
    """In-place broadcast of a tensor from rank src (through the group's
    collective device)."""
    cdev = collective_device(group)
    if t.device == cdev:
        dist.broadcast(t, src=src, group=group)
        return t
    s = t.to(cdev)
    dist.broadcast(s, src=src, group=group)
    t.copy_(s)
    return t


def broadcast_array(a, src=0, group=None):
    """A host numpy array as rank src holds it (same shape and dtype on
    every rank)."""
    t = torch.from_numpy(np.ascontiguousarray(a)).clone()
    broadcast_(t, src=src, group=group)
    return t.numpy()


# --------------------------------------------------------------------
# the mesh and placement

def make_mesh(n_cells_shards=None, n_pkt_shards=None):
    """A 2D ("cells", "pkt") DeviceMesh over every rank of the initialized
    group, by default all on the packet axis (the MC is where the JAX
    package expected the time to go).  CUDA for NCCL, CPU for gloo."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "init_distributed() first")
    n = world_size()
    if n_cells_shards is None:
        n_cells_shards = 1
        n_pkt_shards = n
    if n_pkt_shards is None:
        n_pkt_shards = n // n_cells_shards
    if n_cells_shards * n_pkt_shards != n:
        raise ValueError(f"mesh {n_cells_shards} x {n_pkt_shards} does not "
                         f"cover {n} ranks")
    dev_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(dev_type, (n_cells_shards, n_pkt_shards),
                            mesh_dim_names=("cells", "pkt"))


def _mesh_device(mesh):
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def put_global(mesh, arr, axis=None):
    """This rank's part of a host-global array, as a tensor on the mesh's
    device for this rank (its card for a CUDA mesh): with axis, the block
    of leading-axis rows of this rank's coordinate along that mesh axis
    (the rows must divide evenly, as for a JAX NamedSharding); without,
    the whole array (replicated)."""
    dev = _mesh_device(mesh)
    a = torch.as_tensor(arr)
    if axis is None:
        return a.to(dev)
    n, k = a.shape[0], mesh.size(mesh.mesh_dim_names.index(axis))
    if n % k:
        raise ValueError(f"{n} rows do not divide over {k} shards of "
                         f"axis {axis!r}")
    per = n // k
    i = mesh.get_local_rank(axis)
    return a[i * per:(i + 1) * per].to(dev)


def shard_batch(mesh, arr, axis="cells"):
    """Put an array with its leading axis sharded over `axis`: this
    rank's rows."""
    return put_global(mesh, arr, axis=axis)


def replicate(mesh, arr):
    """The whole array on this rank's device."""
    return put_global(mesh, arr)


def host_local_batch(global_arr):
    """This process's rows of a host-global numpy batch: the block of
    len // world_size rows at its rank (as the JAX package slices by
    process)."""
    per = global_arr.shape[0] // world_size()
    return global_arr[rank() * per:(rank() + 1) * per]


# --------------------------------------------------------------------
# the sharded solves

def sharded_chemistry_solve(ode, envs, tenvs, y0b, T0b, touts, rtol_b,
                            atol_b, first_step, evolT,
                            max_steps_per_interval=2000, max_wall_s=None,
                            progress_cb=None, lu_backend=None, group=None):
    """Batched chemistry solve with the lanes sharded over every rank of
    the group (the default group when None): each rank gets the whole chunk (envs, tenvs, y0b, T0b,
    rtol_b, atol_b with a leading lane axis, on its device), solves its
    block of B / world lanes with the record driver (a barrier at every
    output time, ChemicalODE.solve_batched(host_loop=True), with the
    batch-global decisions all-reduced over the group), and the results
    are gathered, so that every rank returns the BDFResult of the whole
    chunk.  B must divide by the number of ranks (pad the chunk, as the
    driver does).  The same lanes, solved in one process, give the same
    numbers: every decision that couples lanes is taken over all of
    them."""
    from ..ops import bdf as bdfmod
    from ..utils.tree import tree_map
    group = group or dist.group.WORLD
    k, i = world_size(group), rank(group)
    B = y0b.shape[0]
    if B % k:
        raise ValueError(f"{B} lanes do not divide over {k} ranks")
    per = B // k

    def mine(a):
        return a[i * per:(i + 1) * per]
    res = ode.solve_batched(
        tree_map(mine, envs), mine(y0b), mine(T0b), touts,
        mine(rtol_b), mine(atol_b), first_step=first_step, evolT=evolT,
        tenvs=tree_map(mine, tenvs) if tenvs is not None else None,
        max_steps_per_interval=max_steps_per_interval, host_loop=True,
        max_wall_s=max_wall_s, progress_cb=progress_cb,
        lu_backend=lu_backend, group=group)
    full = {f: all_gather_rows(getattr(res, f), group)
            for f in ("ts", "ys", "t_final", "fail", "n_steps", "n_feval",
                      "n_jeval", "n_lu")}
    return bdfmod.BDFResult(**full, n_rounds=res.n_rounds)


def rank_seed(key_seed: int, rank_i: int, n_ranks: int) -> int:
    """The random seed of rank rank_i's generator for a pass keyed
    key_seed: key_seed * n_ranks + rank_i (one rank: the key itself, the
    unsharded pass's seed)."""
    return int(key_seed) * int(n_ranks) + int(rank_i)


def mc_pass_sharded(model, key_seed, lam_all, en_all, minw, maxw, tallies,
                    stats=None, group=None, **kw):
    """One streamed MC pass with the packet pool sharded over every rank
    of the group (the default group when None): rank r walks its contiguous block of len / world packets
    (mcrt.mc_pass_streamed, kernels K3/K4 on a CUDA device) with its own
    generator, seeded rank_seed(key_seed, r, world), into its own zeroed
    copy of the tallies; at the end every tally channel is all-reduced
    (SUM) into `tallies` on every rank, and the fates are summed.  The
    pool (host arrays, the same on every rank) must divide by the number
    of ranks: pad it with zero-energy packets, as the driver does.  A
    sharded pass cannot repeat the unsharded pass packet for packet (a
    refill draws from the generator); on one rank it is that pass.
    Returns (this rank's final packets, tallies, fates); stats (a dict)
    gets this rank's pass counters and "ranks"."""
    from ..ops import mcrt
    group = group or dist.group.WORLD
    k, i = world_size(group), rank(group)
    lam_all = np.asarray(lam_all, dtype=np.float64)
    en_all = np.asarray(en_all, dtype=np.float64)
    if len(lam_all) % k:
        raise ValueError(f"{len(lam_all)} packets do not divide over {k} "
                         "ranks; pad the pool with zero-energy packets")
    per = len(lam_all) // k
    dev = tallies.flux.device
    gen = torch.Generator(device=dev).manual_seed(rank_seed(key_seed, i, k))
    mine = mcrt.McTallies(*(torch.zeros_like(t) for t in tallies))
    packets, mine, fates = mcrt.mc_pass_streamed(
        model, gen, lam_all[i * per:(i + 1) * per],
        en_all[i * per:(i + 1) * per], minw, maxw, mine, stats=stats, **kw)
    for total, part in zip(tallies, mine):
        total.add_(all_reduce_(part, group=group))
    names = sorted(fates)
    cnt = torch.tensor([fates[n] for n in names], dtype=torch.int64)
    all_reduce_(cnt, group=group)
    fates = dict(zip(names, (int(v) for v in cnt)))
    if stats is not None:
        stats["ranks"] = k
    return packets, tallies, fates
