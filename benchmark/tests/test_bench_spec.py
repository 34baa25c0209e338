"""BENCHMARK.json against the contract's limits, and every file it names
found by name: configurations, traffic, drivers, metric readers, kernel
bounds."""

import json
import re

import pytest

from harness import spec

BENCH = spec.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def line_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_and_limits():
    assert set(BENCH) == KEYS["top"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert all(line_ok(w) for w in BENCH["command"])
    assert len(BENCH["command"]) <= 32
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p
        assert (spec.ROOT / p).is_dir()
    for section, key in (("configs", "configs"), ("workloads", "workloads"),
                         ("end_to_end", "end_to_end"),
                         ("per_layer", "per_layer")):
        names = [e["name"] for e in BENCH[section]]
        assert len(names) == len(set(names)), section
        for e in BENCH[section]:
            extra = set(e) - KEYS[key]
            assert extra <= {"workloads"} and (
                not extra or section in ("end_to_end", "per_layer")), e
            assert KEYS[key] <= set(e), e
            assert NAME.match(e["name"]), e["name"]
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_metrics():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = set()
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line_ok(m["layer"])
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        # every cell that reports the metric reports what it moves
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        layers.add(m["layer"])
    for w in cells:
        assert "setup_s" in [m["name"] for m in spec.metrics_of(BENCH, w,
                                                                False)]
        assert len(spec.metrics_of(BENCH, w, False)) >= 2
        assert spec.metrics_of(BENCH, w, True)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_files_found_by_name(cell):
    w, conf = spec.cell_of(BENCH, cell)
    assert w["chips"] in (1, 4)
    assert line_ok(w["why"]) and line_ok(conf["why"]) \
        and line_ok(conf["source"])
    cfg = spec.read_json(conf["file"])
    assert conf["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
    for key in conf["reduced"]:
        assert NAME.match(key) and key in cfg and key in cfg["reduced"]
    traffic = json.loads(spec.traffic_file(w["traffic"]).read_text())
    spec.load_module("drivers", traffic["driver"])
    for traced in (False, True):
        for m in spec.metrics_of(BENCH, cell, traced):
            assert callable(spec.load_module("metrics", m["name"]).read)


def test_configuration_files_distinct():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("kernel, B, n, flop, nbytes", [
    ("k1", 1024, 485, 7.90e10, None),
    ("k2", 1024, 485, None, 9.67e8),
])
def test_bounds_reproduce_the_kernel_table(kernel, B, n, flop, nbytes):
    """PERF.md's kernel table: K1 7.90e10 flop and K2 9.67e8 bytes at
    B = 1024, n = 485."""
    f, b = spec.load_module("bounds", kernel).work(B, n)
    if flop is not None:
        assert f == pytest.approx(flop, rel=5e-3)
    if nbytes is not None:
        assert b == pytest.approx(nbytes, rel=5e-3)
