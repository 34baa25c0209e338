"""The port's device contract (rac2d_torch), on the CPU.

- The public entry points default to the card (``device="cuda"``); no
  function or method of the package defaults to any other device, and
  internal helpers have no device default at all.
- Without CUDA, a call that names no device raises rather than run on
  the CPU (decided inside the test, never when this file is imported).
- The port imports neither JAX nor the JAX package.
"""

import importlib
import inspect
import pathlib
import pkgutil
import subprocess
import sys

import pytest
import torch

import rac2d_torch

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
            "rac2d_torch.convert\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in "
            "('jax', 'jaxlib', 'rac2d_tpu'))\n"
            "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout
