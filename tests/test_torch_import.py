"""``repro_torch`` stands alone: every module imports with jax blocked, and
no file of the port (nor ``chip_smoke.py``, ``chip_ab.py``,
``chip_spans.py`` or the example twins ``examples/*_torch.py``) imports
jax or the JAX package."""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
EXAMPLE_TWINS = [ROOT / "examples" / f"{name}_torch.py" for name in (
    "quickstart", "scheduler_sim", "serve_elastic", "cluster_sim",
    "train_diffusion_lm")]
PORT_FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "chip_ab.py",
                                         ROOT / "chip_spans.py"] + \
    EXAMPLE_TWINS


def _modules():
    names = ["repro_torch"]
    for m in pkgutil.walk_packages([str(PKG)], prefix="repro_torch."):
        names.append(m.name)
    return names


def test_every_module_imports_without_jax():
    mods = _modules()
    assert "repro_torch.kernels.chunked_paged_attn" in mods
    assert "repro_torch.launch.serve" in mods
    for name in ("repro_torch.training.train_loop", "repro_torch.launch.train",
                 "repro_torch.models.encdec", "repro_torch.common.faults",
                 "repro_torch.cluster.engine",
                 "repro_torch.launch.serve_cluster",
                 "repro_torch.launch.trace_view",
                 "repro_torch.distributed.collectives",
                 "repro_torch.launch.mesh", "repro_torch.analysis",
                 "repro_torch.analysis.check", "repro_torch.analysis.rules",
                 "repro_torch.analysis.optrace",
                 "repro_torch.analysis.inventory",
                 "repro_torch.launch.specs", "repro_torch.launch.dryrun"):
        assert name in mods
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            f"for name in {mods!r}:\n"
            "    importlib.import_module(name)\n"
            "from repro_torch.models.moe import (moe_block, moe_block_2d,\n"
            "    moe_block_sharded, _moe_local_2d, takes_sorted_path)\n"
            "from repro_torch.distributed import (NamedSharding, psum,\n"
            "    shard_tensor, unshard_tensor)\n"
            "from repro_torch.training.checkpoint import (CheckpointManager,\n"
            "    restore)\n"
            "assert 'jax' not in [m for m in sys.modules if sys.modules[m]]\n"
            "print('ok', len(sys.modules))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_imports(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "ml_dtypes"), \
            f"{path.relative_to(ROOT)} imports {name}"


def test_scheduler_sim_twin_runs_without_jax():
    """``examples/scheduler_sim_torch.py``'s ``main`` runs with jax and the
    JAX package blocked."""
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "g = runpy.run_path('examples/scheduler_sim_torch.py')\n"
            "res = g['main'](['--device', 'h100-sxm'])\n"
            "assert 'jax' not in [m for m in sys.modules if sys.modules[m]]\n"
            "print('ok', sorted(res['selections'].items()))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "device=h100-sxm" in out.stdout
    assert "ok [(1, " in out.stdout


def test_trains_and_decodes_encdec_on_cpu_without_jax(tmp_path):
    """The training launcher (3 steps of the default SMOKE config) and one
    encdec admission and window run with jax and the JAX package
    blocked."""
    code = ("import sys, torch\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "from repro_torch.launch import train\n"
            "losses = train.main(['--smoke', '--torch-device', 'cpu',\n"
            "                     '--steps', '3', '--seq', '16', '--batch',\n"
            f"                     '2', '--ckpt-dir', {str(tmp_path)!r}])\n"
            "from repro_torch.configs import get_smoke_config\n"
            "from repro_torch.models import build_model\n"
            "m = build_model(get_smoke_config('seamless-m4t-large-v2'))\n"
            "p = m.init_params(device='cpu')\n"
            "c = m.init_cache(2, 16, 8, dtype=torch.float32, device='cpu')\n"
            "m.admit(p, c, torch.randn(2, 8, m.cfg.d_model),\n"
            "        torch.arange(8)[None] < torch.tensor([[8], [3]]))\n"
            "lg, kv = m.chunk_forward(p, c, torch.full((2, 4), 3),\n"
            "                         c['len'].long(), torch.full((2,), 4))\n"
            "assert torch.isfinite(lg).all()\n"
            "assert 'jax' not in [m for m in sys.modules if sys.modules[m]]\n"
            "print('ok', len(losses))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "ok 3" in out.stdout


def test_serves_on_cpu_without_jax():
    """The port's serving CLI runs end to end with jax and the JAX package
    blocked (model backend, plain kernel versions on the CPU)."""
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "sys.argv = ['serve', '--backend', 'model', '--torch-device',\n"
            "            'cpu', '--requests', '3', '--rate', '8']\n"
            "runpy.run_module('repro_torch.launch.serve',\n"
            "                 run_name='__main__')\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "requests: 3" in out.stdout


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-1.5-large-398b"])
def test_serves_recurrent_families_on_cpu_without_jax(arch):
    """The serving CLI serves the ssm and hybrid SMOKE configs (the
    recurrent-slot backend mode) with jax and the JAX package blocked."""
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "sys.argv = ['serve', '--backend', 'model', '--torch-device',\n"
            f"            'cpu', '--arch', {arch!r}, '--requests', '2',\n"
            "            '--rate', '8']\n"
            "runpy.run_module('repro_torch.launch.serve',\n"
            "                 run_name='__main__')\n")
    # one thread: the SMOKE model's ops are tiny, and the test workers
    # already load every core
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "requests: 2" in out.stdout
