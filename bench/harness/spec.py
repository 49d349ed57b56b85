"""Find a cell and everything it names, by name.

``BENCHMARK.json`` at the checkout's root lists the configurations, the
cells (``workloads``) and the metrics.  A cell names a configuration
(``bench/configs/<name>.json`` through the entry's ``file``) and a traffic
mix (``bench/traffic/<traffic>.json``); a metric is read by
``bench/metrics/<name>.py``.  ``bench/pending.json`` has the same layout for
cells that are defined but not in the benchmark yet (see PERF.md); a name
in ``BENCHMARK.json`` wins.  Adding a cell adds files and list entries only.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclass
class Cell:
    name: str
    config: dict            # the configuration file's contents
    traffic: dict           # the mix file's contents
    end_to_end: list = field(default_factory=list)   # metric entries
    per_layer: list = field(default_factory=list)
    chips: int = 1


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    """A metric with ``workloads`` is reported in those cells; without, an
    end-to-end metric in every cell and a per-layer one wherever the metric
    it moves is."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` from ``BENCHMARK.json``, else from
    ``bench/pending.json``.  Raises KeyError for an unknown name."""
    for path in (root / "BENCHMARK.json", root / "bench" / "pending.json"):
        if not path.exists():
            continue
        spec = json.loads(path.read_text())
        cells = {w["name"]: w for w in spec.get("workloads", [])}
        if name not in cells:
            continue
        w = cells[name]
        cfg_entry = next(c for c in spec["configs"]
                         if c["name"] == w["config"])
        config = json.loads((root / cfg_entry["file"]).read_text())
        traffic = json.loads(
            (root / "bench" / "traffic" / f"{w['traffic']}.json").read_text())
        e2e = [m for m in spec["end_to_end"]
               if _reports(m, name, set())]
        names = {m["name"] for m in e2e}
        per_layer = [m for m in spec["per_layer"]
                     if _reports(m, name, names)]
        return Cell(name, config, traffic, e2e, per_layer, w["chips"])
    raise KeyError(f"no cell named {name!r}")
