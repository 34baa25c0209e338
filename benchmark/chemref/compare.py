"""What decides `correct` in the chemistry cells.

The window's sweeps produce, for every cell they finish, its abundances
and gas temperature at the configuration's t_max.  Two numbers are
compared, each with its limit:

- element_drift: over every finished cell of the window, the largest
  change of an element's (or the charge's) abundance between the
  initial abundances and the sweep's result, relative to that element's
  total (or the charged species' total) in the initial abundances.  The
  network conserves each element and the charge in every reaction, so a
  sound integration changes them only by its rounding.
- ref_gap: on a sample of the finished cells drawn from the seed (the
  cell with the most steps among them), the widest relative gap between
  the sweep's result and the reference's integration of the same cell
  from the same start: the 10 key species where either side is above
  KEY_FLOOR, and the gas temperature (after the equilibrium-T solve in
  an evolT=False cell).  Cells that the pool finished only at a relaxed
  tolerance level are not drawn.

The reference (this package) parses the network and the initial
abundances itself, builds the grid from the configuration (grid.py),
works out each drawn cell's columns, shielding and environments itself
(fields.py), and integrates with scipy's BDF on the CPU (integrate.py):
the rates, right-hand side and Jacobian are the arithmetic of the
repository's independent oracle (oracle.py); the heating and cooling are
a frozen copy of the port's (thermal.py), the one part of the chemistry
with no independent implementation.  It follows the program's state in
one thing only, which it cannot work out again: the fields of the MC
stage (Tdust, the UV and X-ray fields, Av to the star, the Ly-alpha
flux, the dust's absorbed energy), which are stochastic and not part of
the chemistry window.
"""

import sys

import numpy as np
import torch

from . import fields as fieldsmod, grid as gridmod, integrate, umist
from .data import DATA

KEY_FLOOR = 1e-12
# limits: PERF.md gives the readings they were set from
LIMITS = {"element_drift": 1e-10, "ref_gap": 1e-3, "unmoved_cells": 0}
MC_FIELDS = ("Tdust", "G0_UV_toStar", "G0_UV_H2phd",
             "G0_UV_toStar_photoDesorb", "Av_toStar", "zeta_Xray",
             "phflux_Lya")


def program_state(model, cfg):
    """Host copies of the MC stage's fields, and the reference's grid."""
    f = model.fields
    mc = {k: getattr(f, k).double().cpu().numpy() for k in MC_FIELDS}
    mc["Tdusts"] = f.Tdusts.double().cpu().numpy()
    mc["en_gain"] = model.tallies.en_gain.double().cpu().numpy()
    return dict(mc=mc, cfg=cfg, grid=gridmod.make_grid(cfg))


class Reference:
    def __init__(self, prog):
        cfg = prog["cfg"]
        self.cfg = cfg
        root = DATA.parent.parent
        self.chem = integrate.Chemistry(str(root / cfg["network_file"]),
                                        str(root / cfg["enthalpy_file"]))
        net = self.chem.net
        self.y0 = umist.load_initial_abundances(
            net, str(root / cfg["init_abundances_file"]))
        self.fields = fieldsmod.Fields(prog["grid"], prog["mc"], cfg, net,
                                       self.y0)
        self.key = np.asarray(net.key_species_idx)

    def solve(self, cell, rtol, atol, prec="f64"):
        """(X [nS], Tgas) of the cell at t_max, or None if the
        integration failed."""
        cfg, nS = self.cfg, self.chem.nS
        T0 = max(self.fields.mc["Tdust"][cell] * 1.1 + 10.0, 0.0)
        env, tenv = self.fields.envs(cell, T0)
        c = integrate.Cell(self.chem, env, tenv, cfg["evolT"], prec)
        y0 = np.concatenate([self.y0, [T0]])
        atol_v = np.full(nS + 1, atol)
        atol_v[nS] = 1e-6
        y, ok = integrate.integrate(c, y0, cfg["t_max"], rtol, atol_v,
                                    cfg["dt_first"])
        if not ok:
            return None
        T = y[nS] if cfg["evolT"] else c.equilibrium_T(y, T0)
        return y[:nS], T

    def element_totals(self, X):
        """[conserved, cells] totals of X [nS, cells] of the charge, the
        grains and each element, and the normalisation of each row: the
        initial abundances' total of |count| x abundance.  (The network's
        electron count, umist.ELEMENTS[1], is not conserved: ionization
        makes electrons.)"""
        E = self.chem.net.elements.astype(np.float64)       # [nS, nE]
        E = np.delete(E, umist.ELEMENTS.index("E"), axis=1)
        return E.T @ X, np.abs(E).T @ self.y0


def drift(ref, X):
    """The worst relative drift of an element, the grains or the charge
    over the cells of X [nS, cells]: each element's change against its
    initial total; the net charge against the charged species' total in
    the same cell (the initial abundances hold no ions)."""
    tot0, norm0 = ref.element_totals(ref.y0[:, None])
    tot, norm = ref.element_totals(X)
    absq = np.abs(ref.chem.net.elements[:, 0]).astype(np.float64) @ np.abs(X)
    d = np.abs(tot - tot0)
    rel = np.where(norm0[:, None] > 0.0,
                   d / np.where(norm0 > 0.0, norm0, 1.0)[:, None], 0.0)
    rel[0] = d[0] / np.maximum(absq, 1e-300)
    return float(rel.max()) if rel.size else 0.0


def gap(ref, x, T, x_ref, T_ref):
    """The widest relative gap of the key species above KEY_FLOOR on
    either side, and of the gas temperature."""
    k = ref.key
    a, b = x[k], x_ref[k]
    big = np.maximum(np.abs(a), np.abs(b)) > KEY_FLOOR
    g = np.abs(a - b)[big] / np.maximum(np.abs(a), np.abs(b))[big]
    return max(float(g.max()) if g.size else 0.0, abs(T / T_ref - 1.0))


def draw(record, n, seed):
    """n (sweep, lane) pairs of cells finished at the first tolerance
    level, drawn from the seed, the one with the most steps first."""
    cand = [(i, j, s["n_steps"][j]) for i, s in enumerate(record["sweeps"])
            for j in range(len(s["cells"]))
            if not s["failed"][j] and s["retry_level"][j] == 0]
    if not cand:
        return []
    longest = max(range(len(cand)), key=lambda q: cand[q][2])
    rest = [q for q in range(len(cand)) if q != longest]
    rng = np.random.default_rng([seed % 2 ** 63, 2 ** 33])
    pick = [longest] + [int(q) for q in rng.choice(
        rest, min(n - 1, len(rest)), replace=False)]
    return [cand[q][:2] for q in pick]


BLAS_THREADS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
# one Reference per worker process
_REF = None
_PROG = None


def _init(prog):
    global _PROG
    torch.set_num_threads(1)
    _PROG = prog


def _solve(task):
    global _REF
    if _REF is None:
        _REF = Reference(_PROG)
    return _REF.solve(*task)


def solve_all(prog, tasks):
    """Each (cell, rtol, atol, precision) task's result, one worker
    process a task (spawned, one thread each)."""
    import concurrent.futures
    import multiprocessing
    import os
    from multiprocessing import resource_tracker
    # one thread a worker, BLAS's too (the workers inherit the variables)
    saved = {k: os.environ.get(k) for k in BLAS_THREADS}
    os.environ.update({k: "1" for k in BLAS_THREADS})
    try:
        with concurrent.futures.ProcessPoolExecutor(
                max_workers=min(len(tasks), 8),
                mp_context=multiprocessing.get_context("spawn"),
                initializer=_init, initargs=(prog,)) as ex:
            return list(ex.map(_solve, tasks))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        # the pool leaves its resource tracker running until this process
        # ends: stop it and wait for it
        resource_tracker._resource_tracker._stop()


def readings(prog, record, traffic, controls=()):
    """({number: reading}, {diagnostic: reading}, {control: {number:
    reading}}) of the window's sweeps against the reference.  A control,
    "precision:tolerances", puts the reference in a lower precision
    (integrate.PRECISIONS) at the configuration's tolerances ("config")
    or the reference's ("reference") in the program's place on the drawn
    cells.  The diagnostics: what a sweep that left every drawn cell as
    it started would read as ref_gap, and how many of the drawn cells'
    reference integrations failed."""
    ref = Reference(prog)
    cfg = prog["cfg"]
    sweeps = record["sweeps"]
    pairs = draw(record, traffic["reference_cells"], record["seed"])
    cells = [int(sweeps[i]["cells"][j]) for i, j in pairs]
    tol = {"reference": (traffic["reference_rtol"], traffic["reference_atol"]),
           "config": (cfg["rtol_chem"], cfg["atol_chem"])}
    tasks = [(c, *tol["reference"], "f64") for c in cells]
    for ctl in controls:
        prec, t = ctl.split(":")
        tasks += [(c, *tol[t], prec) for c in cells]
    out = solve_all(prog, tasks) if tasks else []
    n = len(cells)
    truth = out[:n]
    inits = [(ref.y0, sweeps[i]["Tgas0"][j]) for i, j in pairs]
    prog_got = [(sweeps[i]["X"][:, j], sweeps[i]["Tgas"][j]) for i, j in pairs]
    X = np.concatenate([s["X"][:, ~s["failed"]] for s in sweeps], axis=1)
    mine = read(ref, prog_got, X, truth, bool(pairs))
    diag = {"unchanged_state_ref_gap": read(ref, inits, X, truth,
                                            True)["ref_gap"],
            "reference_failures": sum(t is None for t in truth)}
    ctl_r = {}
    for q, ctl in enumerate(controls):
        got = out[n * (q + 1):n * (q + 2)]
        if any(g is None for g in got):
            inf = float("inf")
            ctl_r[ctl] = {"element_drift": inf, "ref_gap": inf,
                          "unmoved_cells": 0}
            continue
        Xc = np.stack([g[0] for g in got], axis=1) if got else \
            np.zeros((ref.chem.nS, 0))
        ctl_r[ctl] = read(ref, got, Xc, truth, bool(pairs))
    return mine, diag, ctl_r


def read(ref, got, X, truth, any_drawn):
    """The compared numbers of the answers `got` [(X, T)] for the drawn
    cells against `truth`, and of X [nS, cells] (every finished cell)."""
    worst = 0.0
    for g, t in zip(got, truth):
        worst = float("inf") if t is None else max(worst, gap(ref, *g, *t))
    return {"element_drift": drift(ref, X),
            "ref_gap": worst if any_drawn else float("inf"),
            "unmoved_cells": int((X == ref.y0[:, None]).all(axis=0).sum())}


def check(prog, record, traffic):
    """({number: {value, limit}}, correct)."""
    r, diag, _ = readings(prog, record, traffic)
    for k, v in diag.items():
        print(f"diagnostic {k}: {v!r}", file=sys.stderr)
    checks = {k: {"value": v, "limit": LIMITS[k]} for k, v in r.items()}
    n_late = sum(bool(s["deadline_hit"]) for s in record["sweeps"])
    checks["sweeps_past_deadline"] = {"value": n_late, "limit": 0}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    return checks, correct
