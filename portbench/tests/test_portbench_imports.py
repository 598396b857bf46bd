"""Nothing the benchmark runs imports JAX or the JAX package, judged by
whole top-level module names (the port's name begins with the JAX
package's), and the reference takes nothing from the port."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "crane_scheduler_tpu"}
SOURCES = sorted(p for p in (ROOT / "portbench").rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "portbench" / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_takes_nothing_from_the_port(path):
    assert "crane_scheduler_tpu_torch" not in top_level_imports(path)


def test_guard_names_whole_top_level_modules():
    from portbench.harness import forbidden_modules

    code = ("import sys; sys.path.insert(0, %r); import crane_scheduler_tpu_torch; "
            "from portbench.harness import forbidden_modules; print(forbidden_modules())"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]"  # the port is not the JAX package
    assert callable(forbidden_modules)


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from portbench.harness import load_manifest

    cell = load_manifest()["workloads"][0]["name"]
    out = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
                          cell, "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr
