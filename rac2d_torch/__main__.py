"""CLI entry point: ``python -m rac2d_torch model.toml``.

Counterpart of the JAX package's ``__main__.py``, with the same flags,
stages and output files, plus ``--device`` (default ``cuda``: without a
card the run fails with torch's own error; ``--device cpu`` runs on the
CPU).  The analogue of the reference's ``main.f90``: read the single
config file, run the thermo-chemical iteration, then (optionally) the
continuum and/or line transfer stages (reference src/main.f90:48-105).
Stages can be skipped/resumed via the [output] section and a checkpoint
file, mirroring the reference's use_backup_* dump/restore flow
(src/data_dump.f90, src/disk.f90:123-131).

Several cards: ``torchrun --nproc-per-node N -m rac2d_torch model.toml``
starts one process per card (WORLD_SIZE > 1): each joins the process
group (NCCL; gloo with ``--device cpu``) and runs the model on its card,
cuda:LOCAL_RANK, with the MC passes and the chemistry chunks sharded over
the ranks (``parallel.mesh``); rank 0 alone writes the log, the tables,
the checkpoint, the SED, the analysis and the cubes.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time


def parser():
    p = argparse.ArgumentParser(
        prog="rac2d_torch",
        description="protoplanetary-disk thermo-chemical model (PyTorch)")
    p.add_argument("config", help="TOML configuration file")
    p.add_argument("--out", default=None,
                   help="output directory (overrides [output].dir)")
    p.add_argument("--resume", default=None,
                   help="checkpoint .npz to resume from")
    p.add_argument("--iters", type=int, default=None,
                   help="override number of outer iterations")
    p.add_argument("--skip-chemistry", action="store_true",
                   help="only run the Monte Carlo + SED stage")
    p.add_argument("--save-only-structure", action="store_true",
                   help="write the structure outputs (iter npz + "
                        "checkpoint) from the prepared/resumed state "
                        "and exit without running MC or chemistry "
                        "(reference do_save_only_structure rerun mode, "
                        "src/main.f90:66-105)")
    p.add_argument("--device", default="cuda",
                   help="torch device the model runs on (default cuda)")
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        # started by torchrun: one process per card
        from .parallel import mesh
        mesh.init_distributed(device=args.device)
        try:
            return _main(args)
        finally:
            import torch.distributed as dist
            dist.destroy_process_group()
    return _main(args)


def _main(args):
    from . import checkpoint, config as cfgmod
    from .models import output as outmod
    from .ops import kernels

    cfg = cfgmod.load_config(args.config)
    extras = cfgmod.load_extras(args.config)
    outdir = pathlib.Path(args.out or extras.get("dir", "./rac2d_out"))

    from .models import driver
    m = driver.DiskModel(cfg, device=args.device)
    if m.rank == 0:
        outdir.mkdir(parents=True, exist_ok=True)
        # config echo + streaming log from the very start (reference
        # echoes the config into the log before running,
        # configure.f90:64-74)
        with open(args.config) as src, open(outdir / "config_used.toml",
                                            "w") as dst:
            dst.write(src.read())
        m.log_path = outdir / "log.txt"
        with open(m.log_path, "w"):
            pass
    t0 = time.time()
    m.prepare()

    start_iter = 0
    if args.resume:
        start_iter = checkpoint.load_state(args.resume, m)
        m.say(f"resumed from {args.resume} at iteration {start_iter}")

    n_iter = args.iters if args.iters is not None else cfg.n_iter
    if args.save_only_structure:
        if m.rank:
            return 0
        outmod.save_iter_npz(outdir / "iter_final.npz", m, start_iter)
        checkpoint.save_state(outdir / "checkpoint.npz", m, start_iter)
        m.say(f"structure saved (no compute) in {time.time() - t0:.0f}s")
        return
    kernels.reset_launches()
    if args.skip_chemistry:
        m.run_mc(n_passes=cfg.n_mc_passes)
    else:
        m.run(n_iter=n_iter,
              save_dir=outdir if extras.get("per_iteration") else None)
    m.say(f"iteration finished in {time.time() - t0:.0f}s")
    # the hand-written kernels launched by the run (0 on the CPU, where
    # each wrapper computes its plain version)
    m.say("kernel launches: " + ", ".join(
        f"{k} {v}" for k, v in kernels.launch_counts().items()))
    if m.rank:
        # the state is rank 0's on every rank; rank 0 writes the outputs
        return 0

    # --- persist state + per-cell tables + SED -------------------------
    outmod.save_iter_npz(outdir / "iter_final.npz", m, n_iter)
    checkpoint.save_state(outdir / "checkpoint.npz", m, n_iter)
    lam, flam = m.sed()          # flam: [n_mu_bins, nlam-1]
    with open(outdir / "sed.json", "w") as f:
        json.dump({"lam_A": [float(v) for v in lam],
                   "flam_per_mu_bin": [[float(v) for v in row]
                                       for row in flam]}, f)

    # --- per-point chemical analysis ----------------------------------
    ana = extras.get("analysis")
    if ana and not args.skip_chemistry:
        from .ops import analysis
        t1 = time.time()
        files = analysis.analyse_model_points(
            m, ana.get("points", []), ana.get("species", ["CO", "H2O"]),
            outdir / "ana")
        for fp in files:
            m.say(f"wrote {fp}")
        m.say(f"analysis in {time.time() - t1:.1f}s")

    # --- continuum images ---------------------------------------------
    cont = extras.get("continuum")
    if cont:
        from .models import imaging
        for lam_A in cont.get("lam_A", []):
            for th in cont.get("view_thetas", [7.0]):
                t1 = time.time()
                fits_path = outdir / f"cont_{lam_A:.0f}A_th{th:g}.fits"
                imaging.make_continuum_cube(
                    m, lam_A, th, nx=cont.get("nx", 201),
                    ny=cont.get("ny", 201),
                    dist_pc=cont.get("dist_pc", 100.0),
                    out_fits=str(fits_path))
                m.say(f"wrote {fits_path} in {time.time() - t1:.1f}s")

    # --- line cubes ----------------------------------------------------
    for ln in extras.get("lines", []):
        from .models import imaging
        lcfg = imaging.LineConfig(**ln)
        li = imaging.LineImaging(m, lcfg)
        for itr in li.transitions:
            for th in lcfg.view_thetas:
                t1 = time.time()
                f0 = float(li.mol.freq[itr])
                fits_path = outdir / \
                    f"line_{li.mol.name.strip()}_{f0/1e9:.3f}GHz_th{th:g}.fits"
                li.make_cube(int(itr), th, out_fits=str(fits_path))
                m.say(f"wrote {fits_path} in {time.time() - t1:.1f}s")

    # final rewrite of the full log (say() already streamed it)
    with open(outdir / "log.txt", "w") as f:
        f.write("\n".join(m.log) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
