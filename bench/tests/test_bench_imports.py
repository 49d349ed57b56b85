"""What the benchmark may load: nothing of the JAX stack or the JAX
package (``repro``), judged by each import's whole top-level name, since
``repro_torch`` begins with ``repro``; nothing of the program in the plain
reference; no file of the older ``benchmarks/`` folder."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
BARRED = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not _imports(path) & BARRED


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not _imports(path) & (BARRED | {"repro_torch", "harness"})


def test_whole_name_comparison():
    src = "import repro_torch.serving\nfrom repro_torch import x\n"
    tmp = BENCH / "tests" / "_probe_imports.py"
    try:
        tmp.write_text(src)
        assert _imports(tmp) == {"repro_torch"}
        assert not _imports(tmp) & BARRED
    finally:
        tmp.unlink()


def test_nothing_reads_the_older_benchmarks_folder():
    for p in SOURCES:
        text = p.read_text()
        assert "benchmarks/" not in text and '"benchmarks"' not in text, p


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from harness import runner
    monkeypatch.setitem(sys.modules, "repro_torchx", sys)
    assert "repro" not in runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.serving", sys)
    assert runner.forbidden_modules() == ["repro"]


def test_run_refuses_without_a_card():
    """On a machine with no CUDA device the entry exits non-zero and prints
    no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        "sdar8b-sharegpt-0.8knee", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, env=env,
                       cwd=BENCH.parent, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
