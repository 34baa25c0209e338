"""Shared inputs of the tests of the graphed batch closures
(tests/test_torch_rhs_graph.py, tests/test_torch_jac_graph.py): the
card fixture, the shipped network, a small one cut from it, and lane
inputs drawn from a seed.  Imports neither JAX nor the JAX package."""

import numpy as np
import pytest
import torch

from rac2d_torch import defaults
from rac2d_torch.io import umist
from rac2d_torch.ops import odesys
from rac2d_torch.ops.rates import CellEnv
from rac2d_torch.ops.thermal import ThermalBalance, ThermalEnv
from rac2d_torch.utils import spans
from rac2d_torch.utils.tree import stack

F64 = torch.float64

# the species of the small network: the key species, the grain charge
# states and enough ions and ices to keep every reaction class
SMALL_SPECIES = set(umist.KEY_SPECIES) | {
    "He", "He+", "H+", "H2+", "H3+", "Grain0", "Grain-", "Grain+", "gH",
    "gH2", "gO", "gOH", "gCO", "gH2O", "HCO+", "CH", "CH+", "CH2", "O+",
    "OH+", "H2O+", "H3O+", "CO+"}


@pytest.fixture
def cuda_device():
    """The card, for tests marked `cuda`; decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run `python -m pytest --noconftest "
                    "-m cuda tests/test_torch_rhs_graph.py "
                    "tests/test_torch_jac_graph.py` on the card")
    return torch.device("cuda")


def with_abundances(n):
    return n, umist.load_initial_abundances(n, defaults.INIT_ABUNDANCES)


@pytest.fixture(scope="module")
def net():
    """(the shipped network, its initial abundances)."""
    return with_abundances(umist.load_network(
        defaults.NETWORK, enthalpy_path=defaults.ENTHALPIES))


@pytest.fixture(scope="module")
def small_net(tmp_path_factory):
    """(the shipped network's reactions among SMALL_SPECIES alone, 33
    species, its initial abundances)."""
    path = tmp_path_factory.mktemp("net") / "small.dat"
    keep = []
    with open(defaults.NETWORK) as f:
        for line in f:
            if not line.rstrip("\n") or line[0] in ("!", " "):
                continue
            names = umist._parse_line(line.rstrip("\n"))[0]
            if all(s in SMALL_SPECIES for s in names if s
                   and s not in umist.PSEUDO_REACTANTS
                   and s not in umist.PSEUDO_PRODUCTS):
                keep.append(line)
    path.write_text("".join(keep))
    return with_abundances(umist.load_network(
        str(path), enthalpy_path=defaults.ENTHALPIES))


def ode_on(net, device):
    n, _ = net
    return odesys.ChemicalODE(n, thermal=ThermalBalance(n, device=device),
                              device=device)


def inputs(net, W, seed, device):
    """(y [W, NEQ], args) for W lanes of distinct environments and states
    drawn from seed."""
    _, y0 = net
    rng = np.random.default_rng(seed)
    envs = stack([CellEnv.default(
        device, Tgas=T, Tdust=0.8 * T, n_gas=ng, Av_toISM=av,
        G0_UV_toStar=g0, zeta_Xray_H2=1e-16)
        for T, ng, av, g0 in zip(rng.uniform(15.0, 300.0, W),
                                 10.0 ** rng.uniform(4.0, 9.0, W),
                                 rng.uniform(0.1, 5.0, W),
                                 10.0 ** rng.uniform(0.0, 3.0, W))])
    tenvs = stack([ThermalEnv.default(device) for _ in range(W)])
    ys = y0[None] * 10.0 ** rng.uniform(-0.5, 0.5, (W, len(y0)))
    T = rng.uniform(15.0, 300.0, (W, 1))
    y = torch.as_tensor(np.concatenate([ys, T], axis=1), dtype=F64,
                        device=device)
    return y, (envs, tenvs, None)


def rel_nonzero(a, b):
    """The largest |a - b| / |b| over the entries where b is not 0."""
    a, b = a.cpu(), b.cpu()
    nz = b != 0.0
    assert torch.equal(a != 0.0, nz)
    return float(((a - b).abs()[nz] / b.abs()[nz]).max())


def entries(name):
    """The entries of span `name` since the last spans.reset()."""
    return spans.totals().get(name, (0.0, 0))[1]
