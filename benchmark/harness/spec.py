"""What a run reads: BENCHMARK.json, the cell's configuration and traffic
files, and the files of its driver, metric readers and kernel bounds,
each found by the name that BENCHMARK.json or the traffic file gives.

A later cell, configuration, traffic mix, metric or bound is a new file
here; no file of the harness names one.
"""

import importlib.util
import json
import pathlib
import re

BENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
SPEC = ROOT / "BENCHMARK.json"


def load_spec(path=SPEC):
    with open(path) as f:
        return json.load(f)


def cell_of(spec, workload):
    """(the cell's entry, its configuration's entry) by the cell's name."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(there are {sorted(cells)})")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    return cell, configs[cell["config"]]


def read_json(rel):
    with open(ROOT / rel) as f:
        return json.load(f)


def traffic_file(traffic):
    return BENCH / "traffic" / f"{traffic}.json"


def load_module(kind, name):
    """The module in benchmark/<kind>/<name>.py (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT)}")
    mod_name = f"bench_{kind}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}"
    sp = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod


def metrics_of(spec, workload, traced):
    """The cell's metric entries: the end-to-end ones (traced=False) or
    the per-layer ones (traced=True).  A metric without a "workloads"
    list belongs to every cell."""
    key = "per_layer" if traced else "end_to_end"
    return [m for m in spec[key]
            if workload in m.get("workloads", [workload])]
