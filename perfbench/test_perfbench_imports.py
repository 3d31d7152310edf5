"""What the benchmark may load, and what it does without a card."""
import ast
import os
import shutil
import subprocess
import sys

import pytest

from perfbench import harness
from perfbench.harness import ROOT

FILES = sorted((ROOT / "perfbench").rglob("*.py"))


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_package(path):
    found = top_level_imports(path) & {"jax", "jaxlib", "flax", "repro"}
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("path", sorted((ROOT / "perfbench" / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not top_level_imports(path) & {"repro_torch", "repro", "jax"}


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.models", "reprox", "jaxtyping",
                                      "numpy", "torch._C"]) == []
    assert harness.forbidden_modules(["repro_torch.models", "repro.core.mma", "jax._src",
                                      "flax"]) == ["flax", "jax", "repro"]


def run_command(cwd, env_extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra)
    return subprocess.run([sys.executable, "perfbench/run.py", "--workload", "unet.brats-c8",
                           "--seed", "2147483701", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=120)


def test_the_command_fails_without_a_card():
    out = run_command(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "cuda" in out.stderr.lower()


def test_the_command_fails_with_only_the_benchmark(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    out = run_command(tmp_path, {})
    assert out.returncode != 0 and out.stdout.strip() == ""
