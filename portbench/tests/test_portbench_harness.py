"""The harness on the CPU: pieces found by name, the result line's keys,
the refusal without a card, the forbidden-module check, and the shape of
BENCHMARK.json against the benchmark's contract."""
from __future__ import annotations

import hashlib
import json
import re
import subprocess
import sys

import pytest
import torch

from conftest import CHECKOUT, PORTBENCH

from portbench import run as R
from portbench import spec

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _tree_digest() -> str:
    h = hashlib.sha256()
    for p in sorted(PORTBENCH.rglob("*")):
        if p.is_file() and "__pycache__" not in p.parts:
            h.update(str(p.relative_to(PORTBENCH)).encode())
            h.update(p.read_bytes())
    return h.hexdigest()


def test_pieces_found_by_name_from_new_files(toy):
    """A new configuration, traffic mix and metric reader, each a new file
    beside copies of the benchmark's own, run with no edit to any file."""
    root, bench = toy
    before = _tree_digest()
    (root / "metrics" / "toy_cycles.py").write_text(
        "def read(run):\n    return len(run.cycles)\n")
    bench["end_to_end"].append(dict(name="toy_cycles", unit="cycles",
                                    better="higher", bound=0.25,
                                    source="host_clock"))
    cell = spec.Cell(bench, "toy-gpt2.toy", root)
    assert cell.config["block"]["d"] == 8 and cell.traffic["seq"] == 4
    out = R.run_cell(cell, 2**31 + 17, 0.0, False, torch.device("cpu"))
    assert list(out) == RESULT_KEYS
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] == out["metrics"]["toy_cycles"]["value"] == 2
    assert set(out["metrics"]) == {m["name"] for m in bench["end_to_end"]}
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert {k: v["value"] for k, v in out["checks"].items()} == dict(
        weight_roots_off=0, boundary_roots_off=0, columns_off=0, rejected=0,
        attestations=2)
    assert _tree_digest() == before


def test_traced_line_has_breakdown(toy):
    root, bench = toy
    cell = spec.Cell(bench, "toy-llama.toy", root)
    out = R.run_cell(cell, 5, 0.0, True, torch.device("cpu"))
    assert list(out) == RESULT_KEYS[:5] + ["breakdown", "checks"]
    assert out["correct"] is True
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(out["device"])
    # a CPU run has no device trace: the kernels' rooflines are left out
    names = {m["name"] for m in cell.metrics(True)}
    assert names - set(out["metrics"]) == {"k1_roofline", "k3_roofline"}
    json.dumps(out)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    cell = bench["workloads"][0]["name"]
    p = subprocess.run([sys.executable, str(PORTBENCH / "run.py"),
                        "--workload", cell, "--seed", "3", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=CHECKOUT, timeout=300)
    assert p.returncode == 2 and p.stdout == ""


def test_forbidden_modules_by_top_level_name(monkeypatch):
    assert R.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", object())
    assert R.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert R.forbidden_modules() == ["repro"]


def _text(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json_keeps_the_contract():
    raw = (CHECKOUT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 << 10
    b = json.loads(raw)
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and 1 <= b["run_seconds"] <= 51
    assert b["command"] == ["python3", "portbench/run.py"]
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _text(c["why"]) and _text(c["source"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        cfg = json.loads((CHECKOUT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert all(NAME.match(k) and not k.endswith(("_dim", "_rank"))
                   for k in c["reduced"])
        names.add(c["name"])
    used = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and _text(w["why"]) and w["chips"] == 1
        assert w["config"] in names
        assert (PORTBENCH / "traffic" / f"{w['traffic']}.json").is_file()
        used.add(w["config"])
    assert used == names
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in SOURCES
        assert _text(m["layer"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (PORTBENCH / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len({m["name"] for m in b["end_to_end"] + b["per_layer"]}) == \
        len(b["end_to_end"]) + len(b["per_layer"])
    # every cell reports setup_s, another end-to-end metric and a per-layer
    # one, and each metric's cells report the end-to-end metric it moves
    cells = [w["name"] for w in b["workloads"]]
    reports = {m["name"]: set(m.get("workloads", cells))
               for m in b["end_to_end"]}
    assert all(reports[m["moves"]] >= set(m.get("workloads", cells))
               for m in b["per_layer"])
    for w in cells:
        e2e_here = {n for n, ws in reports.items() if w in ws}
        assert "setup_s" in e2e_here and len(e2e_here) >= 2
        assert any(w in m.get("workloads", cells) for m in b["per_layer"])
