"""Port parity: the config reader, the checkpoint, the per-iteration
outputs, the SED and the command line (``python -m rac2d_torch``) against
the JAX package, on the CPU (JAX on the CPU).

No chemistry sweep runs: states come from tests/torch_cli_fixtures.py (a
tiny disk prepared by both packages with one seeded state); the command
line runs with --save-only-structure, and with --iters 0 (one small MC
pass, then the SED, the analysis, a continuum and an NLTE line cube).

Tolerances: config values equal; checkpoint arrays bit-equal both ways;
iter_table host arrays bit-equal, device-computed columns within 1e-12
relative; the ASCII table's header equal and its numbers within 1e-9
relative; the SED within 1e-12 relative.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from torch_cli_fixtures import MAX_CELLS, NCOL, seeded_models
from torch_mc_fixtures import one_torch_thread  # noqa: F401 (autouse)

FULL_TOML = """
[star]
mass = 0.7
radius = 1.1
T = 4100.0
spectrum_file = "tw_hya_spec_combined.dat"
lumi_Xray = 2e30
T_Xray = 2e7

[disk]
Md = 0.02
rin = 1.5
rout = 80.0
rc = 40.0
hc = 8.0
gam = 0.9

[grid]
rmin = 1.5
rmax = 80.0
zmax = 70.0
ncol = 9
max_num_of_cells = 300

[[dust]]
opti_files = ["silicate_draine.opti"]
weights = [1.0]
d2g_mass = 0.008
mrn_rmax = 0.5

[[dust]]
opti_files = ["silicate_draine.opti", "graphite_draine_pa_0.01.opti"]
weights = [0.6, 0.4]
rho_material = 2.5

[chemistry]
h2o_cross_file = "H2O.photoxs"
t_max = 1e-4
dt_first = 1e-9
ratio_tstep = 1.2
rtol_chem = 1e-5
atol_chem = 1e-28
evolT = true
nlocal_iter = 3
chem_chunk = 128
max_steps_per_interval = 400
chunk_wall_s = 60.0

[montecarlo]
nph = 20000
n_mc_passes = 2
maxw = 0.9
nlen_lut = 256
n_quantile = 128
use_mrw = false

[iteration]
n_iter = 3
rtol_abun = 0.1
atol_abun = 1e-13
converged_fraction = 0.9
UV_G0_background = 2.0
zeta_cosmicray_H2 = 1e-17
base_alpha = 0.02
minimum_Tdust = 2.0
dust_depletion = 0.5
do_vertical_with_Tdust = false
n_vert_iter_tdust = 3
do_vertical_every = 0
disk_gas_mass_preset = 0.01
vertical_moving = true
calc_zetaXray_from_Ncol = true
shard_chemistry = false
chem_stream = true
do_refine = false
do_merge = false
refine_watch_species = ["H2", "CO"]
refine_watch_file = "watch.dat"
refine_threshold = 5.0
merge_tol = 2.0

[depletion]
method = "radial"
f_depl_O = 0.1
[depletion.o]
r0 = 30.0
[depletion.c]
gam = 1.5

[heating_cooling]
heating_eff_chem = 0.5
use_Xray_heating = false

[output]
dir = "out"
per_iteration = true

[continuum]
lam_A = [8e6, 1.3e7]
view_thetas = [7.0, 45.0]
nx = 33

[[lines]]
mol_file = "co_lamda.dat"
mole_name = "CO"
useLTE = false
nf = 20

[analysis]
points = [[10.0, 1.0]]
species = ["CO"]
"""


def _configs():
    from rac2d_torch import config as tconf
    from rac2d_tpu import config as jconf
    return jconf, tconf


def _plain(cfg):
    """A DiskConfig (or the extras' dict) as plain Python values."""
    if dataclasses.is_dataclass(cfg):
        cfg = dataclasses.asdict(cfg)
    return json.loads(json.dumps(cfg, default=str))


def test_config_equal_jax(tmp_path):
    p = tmp_path / "model.toml"
    p.write_text(FULL_TOML)
    jconf, tconf = _configs()
    a, b = jconf.load_config(str(p)), tconf.load_config(str(p))
    assert type(b).__module__ == "rac2d_torch.models.driver"
    assert _plain(a) == _plain(b)
    assert b.dust[1].weights == [0.6, 0.4] and b.mc.nph == 20000 \
        and b.nph_per_pass == 20000 and b.hc.heating_eff_chem == 0.5 \
        and b.depletion.o.r0 == 30.0 and b.shard_chemistry is False
    assert _plain(jconf.load_extras(str(p))) \
        == _plain(tconf.load_extras(str(p)))
    # an empty file: every default
    e = tmp_path / "empty.toml"
    e.write_text("")
    assert _plain(jconf.load_config(str(e))) \
        == _plain(tconf.load_config(str(e)))


def test_config_of_the_verify_model_equal_jax():
    """The known-good model the command line runs on the card."""
    path = str(pathlib.Path(__file__).resolve().parent.parent
               / "examples" / "verify_model.toml")
    jconf, tconf = _configs()
    assert _plain(jconf.load_config(path)) == _plain(tconf.load_config(path))
    assert _plain(jconf.load_extras(path)) == _plain(tconf.load_extras(path))


@pytest.mark.parametrize("section,table", [
    ("disk", "[disk]"), ("grid", "[grid]"), ("dust", "[[dust]]"),
    ("montecarlo", "[montecarlo]"), ("depletion", "[depletion]"),
    ("depletion.o", "[depletion.o]"), ("heating_cooling",
                                       "[heating_cooling]")])
def test_config_unknown_key_raises(tmp_path, section, table):
    p = tmp_path / "bad.toml"
    extra = "opti_files = []\nweights = []\n" if section == "dust" else ""
    p.write_text(f"{table}\n{extra}no_such_key = 1\n")
    jconf, tconf = _configs()
    for mod in (jconf, tconf):
        with pytest.raises(KeyError):
            mod.load_config(str(p))


# --------------------------------------------------------------- the state

@pytest.fixture(scope="module")
def models():
    jm, tm = seeded_models(seed=5)
    jm.prepare_sweep_fields()
    tm.prepare_sweep_fields()
    return jm, tm


_STATE = ("X", "Tgas", "Tdust", "Tdusts", "quality")


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_checkpoint_loads_in_the_other_package(models, tmp_path, writer):
    from rac2d_torch import checkpoint as tck
    from rac2d_tpu import checkpoint as jck
    jm, tm = models
    src, dst = (tm, jm) if writer == "torch" else (jm, tm)
    wmod, rmod = (tck, jck) if writer == "torch" else (jck, tck)
    path = tmp_path / "ck.npz"
    wmod.save_state(path, src, 7)
    saved = {k: getattr(dst, k).copy() for k in _STATE}
    try:
        for k in _STATE:
            setattr(dst, k, np.zeros_like(getattr(dst, k)))
        assert rmod.load_state(path, dst, restore_grid=False) == 7
        for k in _STATE:
            got, want = getattr(dst, k), getattr(src, k)
            assert got.dtype == want.dtype and got.shape == want.shape, k
            np.testing.assert_array_equal(got, want, k)
    finally:
        for k in _STATE:
            setattr(dst, k, saved[k])


def test_checkpoint_files_equal(models, tmp_path):
    """From the same state, both packages write the same keys, dtypes and
    values."""
    from rac2d_torch import checkpoint as tck
    from rac2d_tpu import checkpoint as jck
    jm, tm = models
    jck.save_state(tmp_path / "j.npz", jm, 3)
    tck.save_state(tmp_path / "t.npz", tm, 3)
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "t.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], k)
    tck.save_grid(tmp_path / "g.npz", tm.grid)
    g = tck.load_grid(tmp_path / "g.npz")
    assert tck._grid_hash(g) == jck._grid_hash(jm.grid)


def test_load_state_onto_another_grid_raises(models, tmp_path):
    from rac2d_torch import checkpoint as tck
    from torch_mc_fixtures import disk_cfg
    _, tm = models
    tck.save_state(tmp_path / "ck.npz", tm, 1)
    tdriver, cfg = disk_cfg("torch", ncol=NCOL + 1, max_cells=MAX_CELLS)
    other = tdriver.DiskModel(cfg, device="cpu")
    other.prepare()
    with pytest.raises(ValueError, match="grid hash"):
        tck.load_state(tmp_path / "ck.npz", other, restore_grid=False)
    # by default the checkpoint's grid is adopted, with its geometry
    assert tck.load_state(tmp_path / "ck.npz", other) == 1
    assert tck._grid_hash(other.grid) == tck._grid_hash(tm.grid)
    for k in tck._GRID_FIELDS:
        np.testing.assert_array_equal(getattr(other.grid, k),
                                      getattr(tm.grid, k), k)
    for k in ("X", "Tgas", "Tdust", "Tdusts", "quality", "rho_dust"):
        np.testing.assert_array_equal(getattr(other, k), getattr(tm, k), k)
    assert other.gi.cell_of.shape == tm.gi.cell_of.shape
    for W in ("W_star", "W_ism"):
        assert torch.equal(getattr(other, W).rows, getattr(tm, W).rows)
    assert other.fields is None


def test_iter_table_equal_jax(models, tmp_path):
    from rac2d_torch.models import output as tout
    from rac2d_tpu.models import output as jout
    jm, tm = models
    assert tout.PHYS_COLUMNS == jout.PHYS_COLUMNS
    jout.save_iter_npz(tmp_path / "j.npz", jm, 2)
    tout.save_iter_npz(tmp_path / "t.npz", tm, 2)
    a = jout.load_iter_npz(tmp_path / "j.npz")
    b = tout.load_iter_npz(tmp_path / "t.npz")
    assert sorted(a) == sorted(b)
    assert {"Ncol_toISM", "Ncol_toStar", "collector", "zeta_X"} <= set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        if k.startswith("Ncol_"):         # computed on the model's device
            np.testing.assert_allclose(b[k], a[k], rtol=1e-12, atol=0,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(b[k], a[k], k)


def _numbers_close(la, lb, rtol):
    fa = np.array([float(v) for v in la.split()])
    fb = np.array([float(v) for v in lb.split()])
    np.testing.assert_allclose(fb, fa, rtol=rtol, atol=0)


@pytest.mark.parametrize("species", [None, "all"])
def test_save_iter_ascii_equal_jax(models, tmp_path, species):
    from rac2d_torch.models import output as tout
    from rac2d_tpu.models import output as jout
    jm, tm = models
    jout.save_iter_ascii(tmp_path / "j.dat", jm, 4, species=species)
    tout.save_iter_ascii(tmp_path / "t.dat", tm, 4, species=species)
    la = (tmp_path / "j.dat").read_text().splitlines()
    lb = (tmp_path / "t.dat").read_text().splitlines()
    assert len(la) == len(lb) == jm.grid.n_cells + 2
    assert la[:2] == lb[:2]
    for x, y in zip(la[2:], lb[2:]):
        _numbers_close(x, y, 1e-9)


def test_sed_equal_jax(models):
    jm, tm = models
    for dist in (100.0, 56.0):
        lj, Fj = jm.sed(dist)
        lt, Ft = tm.sed(dist)
        assert Ft.dtype == np.float64
        np.testing.assert_allclose(lt, lj, rtol=1e-12, atol=0)
        np.testing.assert_allclose(Ft, Fj, rtol=1e-12, atol=0)


def test_run_writes_per_iteration_tables(models, tmp_path, monkeypatch):
    """run(save_dir=...) writes iter_NNNN.npz after each iteration's
    chemistry step, the converged one too (the sweep and the MC are
    stubbed: the loop's bookkeeping only)."""
    from rac2d_torch.models import output as tout
    _, tm = models
    fracs = iter([0.0, 1.0])
    monkeypatch.setattr(tm, "run_mc", lambda *a, **k: None)

    def step(iiter):
        tm._t_shield = 0.0
        tm.Tgas = tm.Tgas + iiter
        return next(fracs)

    monkeypatch.setattr(tm, "chemistry_step", step)
    T0 = tm.Tgas.copy()
    try:
        tm.run(n_iter=4, save_dir=tmp_path)
        files = sorted(p.name for p in tmp_path.iterdir())
        assert files == ["iter_0001.npz", "iter_0002.npz"]
        for it, dT in ((1, 1), (2, 3)):
            d = tout.load_iter_npz(tmp_path / f"iter_{it:04d}.npz")
            assert int(d["iiter"]) == it
            np.testing.assert_array_equal(d["Tgas"], T0 + dT)
        assert any("saved" in ln for ln in tm.log)
    finally:
        tm.Tgas = T0


# ------------------------------------------------------------ the command line

def _model_toml(tmp_path, extra=""):
    p = tmp_path / "model.toml"
    p.write_text(f"""
[star]
mass = 0.6
radius = 1.0
T = 4000.0
lumi_Xray = 1e30

[disk]
Md = 0.01
rin = 1.0
rout = 100.0
rc = 50.0
hc = 10.0

[grid]
rmin = 1.0
rmax = 100.0
zmax = 100.0
ncol = {NCOL}
max_num_of_cells = {MAX_CELLS}

[[dust]]
opti_files = ["silicate_draine.opti"]
weights = [1.0]
d2g_mass = 0.01

[chemistry]
h2o_cross_file = "H2O.photoxs"

[montecarlo]
nph = 1000
n_mc_passes = 1
nlen_lut = 256
n_quantile = 128
{extra}""")
    return p


def test_cli_save_only_structure_equal_jax(tmp_path):
    from rac2d_torch import __main__ as tmain
    from rac2d_tpu import __main__ as jmain
    toml = _model_toml(tmp_path)
    jmain.main([str(toml), "--save-only-structure", "--out",
                str(tmp_path / "j")])
    tmain.main([str(toml), "--device", "cpu", "--save-only-structure",
                "--out", str(tmp_path / "t")])
    for name in ("iter_final.npz", "checkpoint.npz"):
        with np.load(tmp_path / "j" / name) as a, \
                np.load(tmp_path / "t" / name) as b:
            assert sorted(a.files) == sorted(b.files), name
            for k in a.files:
                assert a[k].dtype == b[k].dtype, (name, k)
                np.testing.assert_array_equal(b[k], a[k], f"{name}: {k}")
    assert (tmp_path / "t" / "config_used.toml").read_text() \
        == toml.read_text()
    assert "structure saved" in (tmp_path / "t" / "log.txt").read_text()


def test_cli_pipeline_on_the_cpu(tmp_path):
    """python -m rac2d_torch model.toml --device cpu --iters 0: one MC
    pass, the SED, the point analysis, a continuum and an NLTE line cube
    (on a model that ran no sweep: the excitation computes its columns);
    then a resume from its checkpoint."""
    from rac2d_torch import __main__ as tmain
    from rac2d_torch.io import fits
    toml = _model_toml(tmp_path, """
[output]
per_iteration = true

[continuum]
lam_A = [1.3e7]
view_thetas = [45.0]
nx = 7
ny = 7

[[lines]]
mol_file = "co_lamda.dat"
mole_name = "CO"
useLTE = false
freq_min = 2e11
freq_max = 2.4e11
nx = 7
ny = 7
nf = 8
view_thetas = [45.0]

[analysis]
points = [[10.0, 1.0]]
""")
    out = tmp_path / "out"
    assert tmain.main([str(toml), "--device", "cpu", "--out", str(out),
                       "--iters", "0"]) == 0
    names = sorted(p.name for p in out.iterdir())
    assert names == ["ana", "checkpoint.npz", "config_used.toml",
                     "cont_13000000A_th45.fits", "iter_final.npz",
                     "line_CO_230.537GHz_th45.fits", "log.txt", "sed.json"]
    sed = json.loads((out / "sed.json").read_text())
    assert len(sed["flam_per_mu_bin"][0]) == len(sed["lam_A"])
    assert np.isfinite(np.array(sed["flam_per_mu_bin"])).all()
    for f in ("cont_13000000A_th45.fits", "line_CO_230.537GHz_th45.fits"):
        data, hdr = fits.read_fits_image(str(out / f))
        assert np.isfinite(data).all() and float(hdr["THETA"]) == 45.0
    data, hdr = fits.read_fits_image(str(out / "line_CO_230.537GHz_th45.fits"))
    assert data.shape == (8, 7, 7) and "LINE" in hdr
    assert (out / "ana" / "ana_r10_z1.txt").exists()
    log = (out / "log.txt").read_text()
    assert "kernel launches: K1 0, K2 0, K3 0, K4 0" in log
    # resume: the checkpoint's state comes back
    out2 = tmp_path / "out2"
    assert tmain.main([str(toml), "--device", "cpu", "--out", str(out2),
                       "--resume", str(out / "checkpoint.npz"),
                       "--iters", "0"]) == 0
    assert "resumed from" in (out2 / "log.txt").read_text()
    with np.load(out / "checkpoint.npz") as a, \
            np.load(out2 / "checkpoint.npz") as b:
        np.testing.assert_array_equal(a["X"], b["X"])
        np.testing.assert_array_equal(a["Tgas"], b["Tgas"])

