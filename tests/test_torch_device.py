"""The port's device contract (rac2d_torch), on the CPU.

- The public entry points default to the card (``device="cuda"``); no
  function or method of the package defaults to any other device, and
  internal helpers have no device default at all.
- Without CUDA, a call that names no device raises rather than run on
  the CPU (decided inside the test, never when this file is imported).
- The port imports neither JAX nor the JAX package.
- Every port test module (tests/test_torch_*.py) runs torch on one CPU
  thread through the shared ``one_torch_thread`` fixture.
"""

import ast
import importlib
import inspect
import pathlib
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import rac2d_torch

from torch_mc_fixtures import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent

# (module, qualified name) of every public entry point that holds state on
# a device; each defaults to the card
ENTRY_POINTS = [
    ("rac2d_torch.models.driver", "DiskModel"),
    ("rac2d_torch.ops.odesys", "ChemicalODE"),
    ("rac2d_torch.ops.odesys", "tolerance_ladder"),
    ("rac2d_torch.ops.thermal", "ThermalBalance"),
    ("rac2d_torch.convert", "rate_tables"),
    ("rac2d_torch.convert", "incidence"),
    ("rac2d_torch.convert", "cell_env"),
    ("rac2d_torch.convert", "thermal_env"),
    ("rac2d_torch.convert", "thermal_balance"),
    ("rac2d_torch.convert", "grid_index"),
    ("rac2d_torch.convert", "mc_cells"),
    ("rac2d_torch.convert", "packets"),
    ("rac2d_torch.convert", "mc_tallies"),
    ("rac2d_torch.convert", "path_matrix"),
    ("rac2d_torch.ops.columns", "build_path_matrices"),
    ("rac2d_torch.parallel.mesh", "init_distributed"),
]

# DiskModel methods that build tensors: they take no device of their own
# and follow the model's, which defaults to the card
MODEL_METHODS = ["prepare", "run_mc", "prepare_sweep_fields",
                 "assemble_envs", "chemistry_step", "run"]


def _device_param(obj):
    fn = obj.__init__ if inspect.isclass(obj) else obj
    return inspect.signature(fn).parameters.get("device")


def _package_functions():
    """(module.qualname, function) of every function and method defined
    in the package."""
    for info in pkgutil.walk_packages(rac2d_torch.__path__, "rac2d_torch."):
        mod = importlib.import_module(info.name)
        for name, obj in vars(mod).items():
            if getattr(obj, "__module__", None) != info.name:
                continue
            if inspect.isfunction(obj):
                yield f"{info.name}.{name}", obj
            elif inspect.isclass(obj):
                for mname, m in vars(obj).items():
                    if isinstance(m, (staticmethod, classmethod)):
                        m = m.__func__
                    if inspect.isfunction(m):
                        yield f"{info.name}.{name}.{mname}", m


@pytest.mark.parametrize("module,name", ENTRY_POINTS)
def test_entry_point_defaults_to_the_card(module, name):
    p = _device_param(getattr(importlib.import_module(module), name))
    assert p is not None, f"{module}.{name} takes no device"
    assert p.default == "cuda", f"{module}.{name}: device={p.default!r}"


def test_no_other_device_default():
    """Only the entry points default to the card; every other function
    that takes a device has no default."""
    public = {f"{m}.{n}" for m, n in ENTRY_POINTS}
    public |= {f"{m}.{n}.__init__" for m, n in ENTRY_POINTS}
    seen = 0
    for qual, fn in _package_functions():
        p = inspect.signature(fn).parameters.get("device")
        if p is None:
            continue
        seen += 1
        if qual in public:
            assert p.default == "cuda", qual
        else:
            assert p.default is inspect.Parameter.empty, \
                f"{qual}: device={p.default!r}"
    assert seen > len(ENTRY_POINTS)


@pytest.mark.parametrize("name", MODEL_METHODS)
def test_model_methods_follow_the_model_device(name):
    from rac2d_torch.models import driver
    fn = getattr(driver.DiskModel, name)
    assert "device" not in inspect.signature(fn).parameters, name
    assert _device_param(driver.DiskModel).default == "cuda"


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs there")
    from rac2d_torch import defaults
    from rac2d_torch.io import umist
    from rac2d_torch.models import driver
    from rac2d_torch.ops import odesys
    from torch_mc_fixtures import disk_cfg
    _, cfg = disk_cfg("torch")
    with pytest.raises((AssertionError, RuntimeError)):
        driver.DiskModel(cfg)
    net = umist.load_network(defaults.NETWORK,
                             enthalpy_path=defaults.ENTHALPIES)
    with pytest.raises((AssertionError, RuntimeError)):
        odesys.ChemicalODE(net)
    # the same calls with device="cpu" run
    assert driver.DiskModel(cfg, device="cpu").device.type == "cpu"


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import rac2d_torch.models.driver, rac2d_torch.ops.odesys, "
            "rac2d_torch.ops.mcrt, rac2d_torch.ops.columns, "
            "rac2d_torch.io.native, rac2d_torch.models.depletion, "
            "rac2d_torch.convert, rac2d_torch.__main__, rac2d_torch.config, "
            "rac2d_torch.checkpoint, rac2d_torch.models.output, "
            "rac2d_torch.models.imaging, rac2d_torch.ops.raytrace, "
            "rac2d_torch.ops.stateq, rac2d_torch.ops.linalg, "
            "rac2d_torch.ops.vertical, rac2d_torch.models.amr, "
            "rac2d_torch.ops.analysis, rac2d_torch.ops.bdf, "
            "rac2d_torch.ops.thermal, rac2d_torch.postprocess, "
            "rac2d_torch.io.radmc, rac2d_torch.parallel.mesh, "
            "rac2d_torch.ops.blocklu\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in "
            "('jax', 'jaxlib', 'rac2d_tpu'))\n"
            "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout


def test_every_port_test_module_takes_one_torch_thread():
    """Each tests/test_torch_*.py imports the autouse fixture
    torch_mc_fixtures.one_torch_thread at module level: the suite runs
    several pytest workers on the same cores, and torch's default
    intra-op threads, one per core in each worker, oversubscribe them."""
    def takes_it(path):
        return any(isinstance(node, ast.ImportFrom)
                   and node.module == "torch_mc_fixtures"
                   and "one_torch_thread" in [a.name for a in node.names]
                   for node in ast.parse(path.read_text()).body)
    files = sorted((ROOT / "tests").glob("test_torch_*.py"))
    assert files
    assert [p.name for p in files if not takes_it(p)] == []


def test_cli_device_defaults_to_the_card(tmp_path):
    """python -m rac2d_torch runs on the card unless --device says
    otherwise; without CUDA the default fails with torch's own error."""
    from rac2d_torch import __main__ as cli
    assert cli.parser().parse_args(["model.toml"]).device == "cuda"
    assert cli.parser().parse_args(
        ["model.toml", "--device", "cpu"]).device == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs there")
    with pytest.raises((AssertionError, RuntimeError)):
        cli.main([str(ROOT / "examples" / "verify_model.toml"),
                  "--save-only-structure", "--out", str(tmp_path)])


# the imaging and analysis entry points: the device is the model's
FOLLOW_THE_MODEL = [
    ("rac2d_torch.models.imaging", "LineImaging"),
    ("rac2d_torch.models.imaging", "make_continuum_cube"),
    ("rac2d_torch.models.imaging", "continuum_model"),
    ("rac2d_torch.ops.analysis", "analyse_model_points"),
    ("rac2d_torch.checkpoint", "save_state"),
    ("rac2d_torch.checkpoint", "load_state"),
    ("rac2d_torch.checkpoint", "save_state_dist"),
    ("rac2d_torch.checkpoint", "load_state_dist"),
    ("rac2d_torch.models.output", "save_iter_npz"),
]


@pytest.mark.parametrize("module,name", FOLLOW_THE_MODEL)
def test_imaging_follows_the_model_device(module, name):
    assert _device_param(getattr(importlib.import_module(module),
                                 name)) is None, f"{module}.{name}"


def test_mol_tables_take_the_callers_device():
    """build_mol_tables has no device default, and puts every table on
    the device it is given."""
    from rac2d_torch import defaults
    from rac2d_torch.io import lamda
    from rac2d_torch.ops import stateq
    p = inspect.signature(stateq.build_mol_tables).parameters["device"]
    assert p.default is inspect.Parameter.empty
    tab = stateq.build_mol_tables(lamda.load_lamda(defaults.CO_LAMDA),
                                  "meta")
    tensors = [t for t in tab if isinstance(t, torch.Tensor)]
    tensors += [t for f in ("p_iup", "p_ilow", "p_T", "p_Cul")
                for t in getattr(tab, f)]
    assert len(tensors) > 10
    assert all(t.device.type == "meta" for t in tensors)


# the solver drivers: no device of their own, they run where their
# inputs are; ChemicalODE's solvers run on the ODE's device (the card by
# default)
BDF_DRIVERS = ["bdf_solve", "bdf_solve_batch", "bdf_solve_batch_host",
               "bdf_solve_batch_cont", "bdf_solve_batch_pool"]


@pytest.mark.parametrize("name", BDF_DRIVERS)
def test_bdf_drivers_follow_their_inputs(name):
    from rac2d_torch.ops import bdf
    assert _device_param(getattr(bdf, name)) is None, name


@pytest.mark.parametrize("name", ["solve", "solve_batched", "solve_pool"])
def test_ode_solvers_follow_the_ode_device(name):
    from rac2d_torch.ops import odesys
    assert _device_param(getattr(odesys.ChemicalODE, name)) is None, name
    assert _device_param(odesys.ChemicalODE).default == "cuda"


def test_thermal_lut_defaults_to_the_card():
    """ThermalBalance(tdust_lut=...) holds its LUT on its device, the card
    unless the caller names another; without CUDA the default raises."""
    from rac2d_torch import defaults
    from rac2d_torch.io import umist
    from rac2d_torch.ops.thermal import HcConfig, ThermalBalance
    sig = inspect.signature(ThermalBalance.__init__).parameters
    assert sig["tdust_lut"].default is None
    assert sig["device"].default == "cuda"
    net = umist.load_network(defaults.NETWORK,
                             enthalpy_path=defaults.ENTHALPIES)
    lut = (np.linspace(1.0, 2000.0, 8), np.linspace(0.0, 1.0, 8)[None])
    cfg = HcConfig(tdust_iter_tandem=True, allow_gas_dust_en_exch=True)
    tb = ThermalBalance(net, cfg, device="cpu", tdust_lut=lut)
    assert all(t.device.type == "cpu" and t.dtype == torch.float64
               for t in tb.tdust_lut)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs there")
    with pytest.raises((AssertionError, RuntimeError)):
        ThermalBalance(net, cfg, tdust_lut=lut)


def test_init_distributed_defaults_to_the_card():
    """init_distributed joins with NCCL on the card unless told "cpu";
    without CUDA the default raises before any group exists."""
    import torch.distributed as dist
    from rac2d_torch.parallel import mesh
    assert _device_param(mesh.init_distributed).default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs there")
    with pytest.raises((AssertionError, RuntimeError)):
        mesh.init_distributed("127.0.0.1:1", 1, 0)
    assert not dist.is_initialized()


def test_rank_device_binds_the_local_rank(monkeypatch):
    """In a group of several ranks, "cuda" is the card of LOCAL_RANK; an
    explicit card or the CPU stays as given; in one process "cuda" stays
    "cuda"."""
    from rac2d_torch.parallel import mesh
    assert mesh.rank_device("cuda") == torch.device("cuda")
    monkeypatch.setattr(mesh, "world_size", lambda group=None: 4)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert mesh.rank_device("cuda") == torch.device("cuda", 3)
    assert mesh.rank_device("cuda:0") == torch.device("cuda", 0)
    assert mesh.rank_device("cpu") == torch.device("cpu")


def test_device_list_names_the_torchrun_launch():
    from rac2d_torch.models import driver
    from torch_mc_fixtures import disk_cfg
    _, cfg = disk_cfg("torch")
    with pytest.raises(NotImplementedError, match="torchrun"):
        driver.DiskModel(cfg, device=["cuda:0", "cuda:1"])
    m = driver.DiskModel(cfg, device=["cpu"])
    assert m.device.type == "cpu" and (m.rank, m.world) == (0, 1)
    assert m.group is None
