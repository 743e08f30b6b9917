"""Find a cell's pieces by name: ``BENCHMARK.json`` at the checkout's
root names the cells and metrics; a configuration is
``configs/<name>.json``, a traffic mix ``traffic/<name>.json`` and a
metric's reader ``metrics/<name>.py`` under this folder.  Adding a cell or
a metric adds files and entries; no file here changes."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent


class Cell:
    """One ``workloads`` entry with its configuration, traffic and
    metrics (``end_to_end`` with ``--trace 0``, ``per_layer`` with
    ``--trace 1``), loaded from ``root`` (this folder by default)."""

    def __init__(self, bench: Dict, name: str, root: Path = HERE):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.entry = cells[name]
        self.name = name
        self.root = Path(root)
        self.config = _load_json(self.root / "configs" /
                                 f"{self.entry['config']}.json")
        self.traffic = _load_json(self.root / "traffic" /
                                  f"{self.entry['traffic']}.json")
        self.bench = bench

    def metrics(self, trace: bool) -> List[Dict]:
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if self.name in m.get("workloads", [self.name])]

    def reader(self, metric: str) -> Callable:
        """``read(run)`` of ``metrics/<metric>.py``: the metric's value
        from a finished run, or None where the run holds nothing to
        read."""
        path = self.root / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def _load_json(path: Path) -> Dict:
    with open(path) as fh:
        return json.load(fh)


def load_bench(checkout: Path) -> Dict:
    return _load_json(Path(checkout) / "BENCHMARK.json")

