"""Run one cell of the benchmark of rac2d_torch once and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for.  The cell (BENCHMARK.json "workloads") names a configuration file
and a traffic file; the traffic file names its driver
(benchmark/drivers/<driver>.py), which sets the model up from the seed,
runs the measured window and checks what the window produced against the
plain reference.  Each metric is read by benchmark/metrics/<name>.py.
With --trace 0 the line carries the cell's end-to-end metrics, with
--trace 1 its per-layer metrics, read from a torch.profiler trace of part
of the window.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device, (traced) breakdown, and last "checks": each
compared number beside its limit, also printed as the last lines of
standard error.  Without CUDA, or with fewer cards than the cell asks
for, it prints no result and exits 1.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
# every build and kernel cache of the program at a fixed path inside the
# checkout (the program builds its CUDA and C++ libraries under build/)
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / "build" / "torch_extensions"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(BENCH))

from harness import imports, spec  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


class Run:
    """What the metric readers see: the driver's record of the window,
    the trace's summary (traced runs), the set-up seconds and the card."""

    def __init__(self, record, trace, setup_s, kind):
        self.record = record
        self.trace = trace
        self.setup_s = setup_s
        self.kind = kind


def fail(msg, code=1):
    print(f"run.py: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None):
    args = parse(argv)
    bench = spec.load_spec()
    cell, conf = spec.cell_of(bench, args.workload)
    cfg = spec.read_json(conf["file"])

    import torch
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False: this benchmark "
                    "measures the card and has no CPU fallback")
    if torch.cuda.device_count() < cell["chips"]:
        return fail(f"the cell asks for {cell['chips']} cards, "
                    f"{torch.cuda.device_count()} present")
    line = run_cell(bench, cell, cfg, args.seed, args.seconds,
                    bool(args.trace), torch.device("cuda", 0))
    found = imports.forbidden_loaded()
    if found:
        return fail("modules of JAX or the JAX package are loaded: "
                    + ", ".join(found))
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"correct: {line['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


def run_cell(bench, cell, cfg, seed, seconds, traced, dev):
    """Set up, measure and check one cell on `dev` (the card; the CPU in
    the harness's own tests); the result line."""
    import torch
    traffic = json.loads(spec.traffic_file(cell["traffic"]).read_text())
    driver = spec.load_module("drivers", traffic["driver"])
    wanted = spec.metrics_of(bench, cell["name"], traced)
    readers = {m["name"]: spec.load_module("metrics", m["name"])
               for m in wanted}
    cuda = dev.type == "cuda"
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"

    state = driver.setup(cfg, traffic, seed, dev)
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - T_PROCESS
    record, trace = driver.window(state, seconds, traced)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    run = Run(record, trace, setup_s, kind)
    metrics = {}
    for m in wanted:
        v = readers[m["name"]].read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    ref_in = driver.reference_inputs(state, record)
    del state
    if cuda:
        torch.cuda.empty_cache()
    checks, correct = driver.check(ref_in, record, traffic)
    line = {"correct": bool(correct), "attempted": record["attempted"],
            "failed": record["failed"], "metrics": metrics,
            "device": {"platform": "gpu", "kind": kind,
                       "count": cell["chips"],
                       "memory_peak_bytes": int(peak)}}
    if trace is not None:
        line["device"]["busy_s"] = trace["busy_s"]
        line["device"]["window_s"] = trace["window_s"]
        line["breakdown"] = {"device_ops": trace["device_ops"],
                             "idle_gaps": trace["idle_gaps"]}
    line["checks"] = checks
    return line


if __name__ == "__main__":
    sys.exit(main())
