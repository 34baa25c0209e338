"""Readings of a chemistry cell's compared numbers on several seeds in one
process: the program's (sound runs: the lower readings) and the
controls' (the reference in a lower precision in the program's place:
the upper readings).

    python3 benchmark/control.py --workload twhya.chem \
        --seeds 11 12 13 --control-seeds 11 12 \
        --controls f32:config f32_rates:config f32_rates:reference

A control is precision:tolerances (chemref/integrate.py PRECISIONS; the
configuration's tolerances or the reference's).

Set-up as a run of the cell (from the first seed), then for each seed
one window of one sweep, as a run draws it, and its readings; one JSON
line a seed.  It needs the card, as a run does.
"""

import json
import sys
import time

import run  # sets the paths and the cache directories

from harness import spec


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--controls", nargs="*", default=["f32:config"])
    args = ap.parse_args(argv)
    bench = spec.load_spec()
    cell, conf = spec.cell_of(bench, args.workload)
    cfg = spec.read_json(conf["file"])
    traffic = json.loads(spec.traffic_file(cell["traffic"]).read_text())
    driver = spec.load_module("drivers", traffic["driver"])
    from chemref import compare
    import torch
    if not torch.cuda.is_available():
        print("control.py: no CUDA device", file=sys.stderr)
        return 1
    st = driver.setup(cfg, traffic, args.seeds[0], torch.device("cuda", 0))
    prog = driver.reference_inputs(st, None)
    for seed in args.seeds:
        st.seed = seed
        t0 = time.time()
        record, _ = driver.window(st, 0.0, False)
        t1 = time.time()
        out = {"workload": args.workload, "seed": seed,
               "sweep_s": t1 - t0, "rounds": record["timed"]["rounds"],
               "failed": record["failed"]}
        out["program"], out["diag"], out["control"] = compare.readings(
            prog, record, traffic,
            args.controls if seed in args.control_seeds else ())
        out["check_s"] = time.time() - t1
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
