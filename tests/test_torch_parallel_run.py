"""Port parity: the slice as a whole on 2 ranks over torch.distributed,
on the CPU (the multi-rank machinery and its bars as in
tests/test_torch_parallel.py).

- ``DiskModel(cfg).run(n_iter=1)`` on 2 gloo ranks on
  tests/test_torch_run.py's smallest disk (4 active cells in one chunk
  of 4, so 2 lanes a rank; 40000 packets, t_max 1e-4 yr): the MC pass
  and the chunked sweep sharded.
  Held to a single-process chunked ``chemistry_step`` (chem_stream=False)
  started from the 2-rank run's own post-MC state: rtol 1e-8, atol
  1e-25, the same quality and converged cells; and its post-MC Tdust
  against a single-process ``run_mc`` (other random numbers) within
  chip_smoke.py phase 10's bar (median |dTdust|/Tdust below 0.03, the
  absorbed energy within 2%).  Both ranks end with the same state.
- ``python -m rac2d_torch --iters 0`` on 2 ranks, as torchrun starts it:
  rank 0 writes every output file, one MC pass in its log.
"""

import numpy as np

import torch_dist_worker as w
from test_torch_parallel import _tdust_bar
from torch_mc_fixtures import one_torch_thread  # noqa: F401 (autouse)

SLICE_NPH = 40000
SLICE_T_MAX = 1e-4        # yr


def test_model_run_on_two_ranks():
    """The slice as a whole: run(n_iter=1) with the MC pass and the
    chunked sweep sharded over 2 ranks."""
    r0, r1 = w.run_ranks(w.model_run, SLICE_NPH, SLICE_T_MAX)
    assert (r0["rank"], r1["rank"], r0["world"]) == (0, 1, 2)
    for k in w.STATE:
        np.testing.assert_array_equal(r0["final"][k], r1["final"][k],
                                      err_msg=k)
        np.testing.assert_array_equal(r0["snap"][k], r1["snap"][k],
                                      err_msg=k)
    assert len(r1["log"]) == len(r0["log"])
    assert any("chunk 0 (level 1): 4 cells" in ln for ln in r0["log"])
    assert r0["chunk_rounds"] == r1["chunk_rounds"] > 0
    # one process: the MC pass (other random numbers), then the chunked
    # sweep from the 2-rank run's own post-MC state
    snap = r0["snap"]
    m = w.tiny_model(chem_chunk=4, nph_per_pass=SLICE_NPH,
                     chem_stream=False, t_max=SLICE_T_MAX)
    m.run_mc()
    med, de = _tdust_bar(m, snap["tallies"], m.tallies)
    print(f"2 ranks vs 1: median |dTdust|/Tdust {med:.4f}, absorbed "
          f"energy {de:.4f}")
    assert med < 0.03 and de < 0.02
    for k in w.STATE:
        setattr(m, k, np.copy(snap[k]))
    m.tallies = snap["tallies"]
    m.fields = m.fields._replace(**snap["fields"])
    m.mc_counts = snap["mc_counts"]
    m.chemistry_step(iiter=1)
    act = m.grid.using
    assert act.sum() == 4
    fin = r0["final"]
    np.testing.assert_array_equal(fin["quality"], m.quality)
    np.testing.assert_array_equal(r0["converged"], m.converged_cells)
    np.testing.assert_allclose(fin["X"], m.X, rtol=1e-8, atol=1e-25)
    np.testing.assert_allclose(fin["Tgas"], m.Tgas, rtol=1e-8)
    # the chemistry moved
    assert (np.abs(fin["X"][:, act] - snap["X"][:, act])
            > 0.1 * np.abs(snap["X"][:, act]) + 1e-12).any()


def test_cli_on_two_ranks(tmp_path):
    from test_torch_cli import _model_toml
    toml = _model_toml(tmp_path, "")
    out = tmp_path / "out"
    assert w.run_ranks(w.cli_run, str(toml), str(out)) == [0, 0]
    names = sorted(p.name for p in out.iterdir())
    assert names == ["checkpoint.npz", "config_used.toml", "iter_final.npz",
                     "log.txt", "sed.json"]
    log = (out / "log.txt").read_text()
    assert log.count("MC pass 1/") == 1
