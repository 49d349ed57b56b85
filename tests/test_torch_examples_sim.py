"""The host-only example twins (``examples/scheduler_sim_torch.py``,
``examples/cluster_sim_torch.py``) against the reference scripts beside
them: the same stdout, character for character, on the reference's
devices.  Each reference script runs in this process through
``runpy.run_path`` under a patched ``sys.argv``; no reference file
changes."""

import contextlib
import importlib.util
import io
import runpy
import sys
from pathlib import Path

import pytest

from repro_torch.core.latency_model import TPU_V5E

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _twin(name):
    """The example twin ``examples/<name>_torch.py`` as a module."""
    path = EXAMPLES / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stdout(fn, *a, **kw) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*a, **kw)
    return buf.getvalue()


def _reference(name, argv) -> str:
    """The reference script's stdout, run as ``__main__`` with ``argv``."""
    path = str(EXAMPLES / f"{name}.py")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", [path, *argv])
        return _stdout(runpy.run_path, path, run_name="__main__")


@pytest.mark.parametrize("device", ["tpu-v5e", "a100-80g", "cpu-host"])
def test_scheduler_sim_prints_reference_stdout(device):
    twin = _twin("scheduler_sim")
    argv = ["--device", device, "--dataset", "sharegpt"]
    want = _reference("scheduler_sim", argv)
    got = _stdout(twin.main, argv)
    assert got == want


def test_scheduler_sim_defaults_to_h100_and_returns_numbers():
    """The twin's default device is the port's H100 (absent from the
    reference's list); what it returns is what it printed."""
    twin = _twin("scheduler_sim")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = twin.main([])
    out = buf.getvalue()
    assert out.startswith("model=sdar-8b device=h100-sxm dataset=sharegpt")
    assert f"{res['saturation_ew']:.0f}" in out.splitlines()[1]
    assert set(res["table"]) == set(twin.BATCHES)
    assert all(c in twin.CHUNKS for c in res["selections"].values())
    assert str(res["selections"]) in out


@pytest.fixture(scope="module")
def cluster_reference():
    """The reference ``examples/cluster_sim.py``'s stdout, split into its
    three sections (``main`` prints a blank line between them)."""
    out = _reference("cluster_sim", [])
    parts = out.split("\n\n")
    assert len(parts) == 3
    return [p + ("" if p.endswith("\n") else "\n") for p in parts]


SECTIONS = ["router_comparison", "kv_pressure", "priority_preemption"]


@pytest.mark.parametrize("section", SECTIONS)
def test_cluster_sim_prints_reference_stdout(cluster_reference, section):
    """``cluster_sim_torch`` on the reference's device (``TPU_V5E``): each
    section's stdout equals the reference's, and ``main`` prints them
    joined as the reference's ``main`` does."""
    twin = _twin("cluster_sim")
    got = _stdout(getattr(twin, section), TPU_V5E)
    assert got == cluster_reference[SECTIONS.index(section)]


def test_cluster_sim_main_joins_the_sections(monkeypatch):
    """``main`` prints the three sections in the reference's order, a
    blank line between them, on the device it is given (the port's
    ``H100_SXM`` by default), and returns each section's numbers."""
    twin = _twin("cluster_sim")
    seen = []
    for name in SECTIONS:
        def fake(device, name=name):
            seen.append(device)
            print(f"<{name}>")
            return {"section": name}
        monkeypatch.setattr(twin, name, fake)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = twin.main([], device=TPU_V5E)
    assert buf.getvalue() == ("<router_comparison>\n\n<kv_pressure>\n\n"
                              "<priority_preemption>\n")
    assert seen == [TPU_V5E] * 3
    assert [r["section"] for r in res.values()] == SECTIONS
    seen.clear()
    _stdout(twin.main, [])
    assert [d.name for d in seen] == ["h100-sxm"] * 3
