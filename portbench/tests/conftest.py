"""Shared pieces of the benchmark's CPU tests: toy cells (the golden toy's
widths) in a folder of their own, loaded the way the harness loads the
real ones."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

PORTBENCH = Path(__file__).resolve().parents[1]
CHECKOUT = PORTBENCH.parent
for _p in (str(CHECKOUT), str(CHECKOUT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

# tests/data/gen_golden.py's and gen_golden_llama.py's widths
TOY_BLOCKS = {
    "toy-gpt2": dict(family="gpt2", d=8, dff=16, heads=1, kv_heads=1, dh=8,
                     layers=1),
    "toy-llama": dict(family="llama", d=8, dff=16, heads=2, kv_heads=1,
                      dh=4, layers=1),
}


def toy_bench(root: Path, extra_e2e=()):
    """A copy of the benchmark's metric readers under ``root`` with the toy
    configurations and a toy traffic mix as new files, and a
    BENCHMARK.json-shaped dict whose cells are the toys."""
    shutil.copytree(PORTBENCH / "metrics", root / "metrics")
    (root / "configs").mkdir()
    (root / "traffic").mkdir()
    for name, block in TOY_BLOCKS.items():
        (root / "configs" / f"{name}.json").write_text(
            json.dumps(dict(block=block)))
    traffic = json.loads((PORTBENCH / "traffic" / "attest-s8.json").read_text())
    traffic.update(seq=4, pcs_queries=2, workers=1)
    (root / "traffic" / "toy.json").write_text(json.dumps(traffic))
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    cells = [dict(name=f"{n}.toy", config=n, traffic="toy", chips=1,
                  why="toy") for n in TOY_BLOCKS]
    bench["workloads"] = cells
    toys = [c["name"] for c in cells]
    for m in bench["per_layer"]:
        m["workloads"] = toys
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"] = toys
    bench["end_to_end"] += list(extra_e2e)
    return bench


@pytest.fixture
def toy(tmp_path):
    root = tmp_path / "portbench"
    root.mkdir()
    return root, toy_bench(root)
