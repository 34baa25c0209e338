"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain reference imports nothing of the program; without a card a run
fails and prints no result."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

from harness import imports, spec

FILES = sorted(spec.BENCH.rglob("*.py"))


def imported(path):
    """The top-level names a file imports (absolute imports only)."""
    tree = ast.parse(pathlib.Path(path).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {imports.top_level(a.name) for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(imports.top_level(node.module))
    return names


def test_top_level_names_compared_whole():
    assert imports.forbidden_loaded(["rac2d_torch", "rac2d_torch.ops",
                                     "jaxtyping", "flaxen.x"]) == []
    assert imports.forbidden_loaded(["rac2d_tpu.ops", "jax.numpy",
                                     "jaxlib"]) == ["jax", "jaxlib",
                                                    "rac2d_tpu"]


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(spec.BENCH)) for p in FILES])
def test_no_file_imports_jax(path):
    assert not imported(path) & set(imports.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((spec.BENCH / "chemref").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "rac2d_torch" not in imported(path)


def test_loaded_modules_after_import():
    """The harness, the driver and the reference import no forbidden
    module, also indirectly (through the port)."""
    code = ("import sys; sys.path[:0] = [%r, %r]; import run; "
            "from harness import spec, imports; "
            "spec.load_module('drivers', 'chem_sweeps'); "
            "from chemref import compare; "
            "print(imports.forbidden_loaded())"
            % (str(spec.ROOT), str(spec.BENCH)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=spec.ROOT)
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def test_run_fails_without_a_card():
    """No CPU fallback: exit code 1 and no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    cell = spec.load_spec()["workloads"][0]["name"]
    out = subprocess.run(
        [sys.executable, str(spec.BENCH / "run.py"), "--workload", cell,
         "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=env, cwd=spec.ROOT, timeout=120)
    assert out.returncode == 1
    assert "{" not in out.stdout
    assert "cuda" in out.stderr.lower()


def test_run_fails_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run exits non-zero and prints no result."""
    import shutil
    shutil.copy(spec.SPEC, tmp_path / "BENCHMARK.json")
    for p in spec.load_spec()["paths"]:
        shutil.copytree(spec.ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    cell = spec.load_spec()["workloads"][0]["name"]
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=120,
        env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0
    assert "{" not in out.stdout
