"""Shared inputs of the CLI and imaging parity tests (tests/test_torch_cli.py,
tests/test_torch_imaging.py): a tiny disk prepared by both packages, with
one state made from a seed and carried from the JAX model into the port's
by ``convert.model_state``.  No chemistry sweep and no Monte Carlo pass run:
the radiation fields and the tallies are seeded numpy arrays."""

import numpy as np

from rac2d_torch import convert

from torch_mc_fixtures import disk_cfg

NCOL = 5
MAX_CELLS = 64


def seeded_models(seed=0):
    """(JAX DiskModel, port DiskModel on the CPU): the same tiny bench disk
    (NCOL columns, at most MAX_CELLS cells) with the same state: a warm
    Tdust(r), Tgas above it, abundances perturbed per cell, and seeded
    radiation fields and MC tallies."""
    from rac2d_tpu.ops import fields as jfields
    from rac2d_tpu.ops import mcrt as jmcrt
    jdriver, jcfg = disk_cfg("jax", ncol=NCOL, max_cells=MAX_CELLS)
    tdriver, tcfg = disk_cfg("torch", ncol=NCOL, max_cells=MAX_CELLS)
    jm = jdriver.DiskModel(jcfg)
    jm.prepare()
    tm = tdriver.DiskModel(tcfg, device="cpu")
    tm.prepare()
    rng = np.random.default_rng(seed)
    n = jm.grid.n_cells
    nlam = len(jm.tab.lam)
    rc, _ = jm.grid.centers()
    jm.Tdusts = np.clip(150.0 * rc ** -0.5, 10.0, 1500.0)[None, :] \
        * rng.uniform(0.9, 1.1, (1, n))
    jm.Tdust = jm.Tdusts[0].copy()
    jm.Tgas = jm.Tdust * rng.uniform(1.0, 3.0, n)
    jm.X = jm.X * 10 ** rng.uniform(-0.5, 0.5, jm.X.shape)
    jm.quality = rng.integers(0, 2, n) * 512
    fl = {f: rng.uniform(0.5, 2.0, n) for f in jfields.RadiationFields._fields}
    fl.update(flux=10 ** rng.uniform(-6, 2, (n, nlam)), Tdusts=jm.Tdusts,
              Tdust=jm.Tdust, dir_flux=rng.normal(size=(n, 3)))
    jm.fields = jfields.RadiationFields(**fl)
    u = rng.uniform
    jm.tallies = jmcrt.McTallies(
        flux=u(0, 1, (n, nlam)), phc=u(0, 1, (n, nlam)),
        dir_flux=u(0, 1, (n, 3)), en_gain=u(0, 1, (1, n)),
        en_gain_abso=u(0, 1, (1, n)), ab_en_water=u(0, 1, n),
        cr_count=u(0, 1, n), collector=10 ** u(20, 30, (5, nlam)),
        collector_img=u(0, 1, (5, 8, 8, nlam)), mrw_path=u(0, 1, n),
        en_gain_mrw=u(0, 1, (1, n)))
    jm.mc_counts = {}
    convert.model_state(jm, tm)
    return jm, tm
