"""Shared inputs of the Monte Carlo parity tests (tests/test_torch_mc_*.py):
the same small disk and the same hand-built one-cell gray model for the
JAX package and its PyTorch port; and the one-thread fixture that every
port test module (tests/test_torch_*.py) imports."""

import numpy as np
import pytest
import torch

from rac2d_torch import convert
from rac2d_torch.ops import mcrt as tmcrt


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run the module's torch ops on one CPU thread (autouse where a test
    module imports it; every tests/test_torch_*.py does, and
    tests/test_torch_device.py checks that).  The plain walk is hundreds
    of small ops a step; with several pytest workers on the same cores,
    torch's intra-op threads contend and a 40000-packet pass runs 20x
    slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def disk_cfg(pkg, ncol=10, max_cells=100, nph=2000, **mc):
    """The bench.py disk (TW Hya-like, one silicate component, L_X=1e30)
    at a small grid, as `pkg`'s DiskConfig (pkg: "jax" or "torch")."""
    if pkg == "jax":
        from rac2d_tpu import defaults
        from rac2d_tpu.models import density, driver
        from rac2d_tpu.models.grid import GridConfig
        from rac2d_tpu.ops import optics
    else:
        from rac2d_torch import defaults
        from rac2d_torch.models import density, driver
        from rac2d_torch.models.grid import GridConfig
        from rac2d_torch.ops import optics
    mc_kw = dict(nph=nph, nlen_lut=256, n_quantile=128)
    mc_kw.update(mc)
    return driver, driver.DiskConfig(
        star_mass=0.6, star_radius=1.0, star_T=4000.0, lumi_Xray=1e30,
        andrews=density.AndrewsDisk(Md=0.01, rin=1.0, rout=100.0, rc=50.0,
                                    hc=10.0),
        grid=GridConfig(rmin=1.0, rmax=100.0, zmax=100.0, ncol=ncol,
                        max_num_of_cells=max_cells),
        dust=[driver.DustComponent(opti_files=[defaults.SILICATE_OPTI],
                                   weights=[1.0], d2g_mass=0.01)],
        network_file=defaults.NETWORK, enthalpy_file=defaults.ENTHALPIES,
        init_abundances_file=defaults.INIT_ABUNDANCES,
        h2o_cross_file=defaults.H2O_PHOTOXS,
        mc=optics.McConfig(**mc_kw), nph_per_pass=nph, n_mc_passes=1)


def warm_tdust(r_cells):
    """A warm Tdust(r) profile, so that re-emission and MRW run."""
    return np.clip(150.0 * np.asarray(r_cells) ** -0.5, 10.0, 1500.0)[None, :]


def torch_model(jmodel, device):
    """The port's McModel holding the same tables, grid and cells."""
    return tmcrt.McModel(convert.mc_tables(jmodel.tab),
                         convert.grid_index(jmodel.gi, device),
                         convert.mc_cells(jmodel.cells, device),
                         float(jmodel.star_mass))
