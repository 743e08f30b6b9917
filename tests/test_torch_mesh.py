"""``repro_torch.launch.mesh`` against the JAX package's meshes, the dry
run's command line, and ``train`` on a one-device mesh.

The JAX package's production meshes need 256 and 512 devices, so they are
built in a subprocess with ``XLA_FLAGS`` set there, not in this process
(where it would reach every later JAX test of the same worker)."""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro.launch import mesh as JMESH
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as MESH

ROOT = os.path.join(os.path.dirname(__file__), "..")
ENV = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
           PYTHONPATH=os.path.join(ROOT, "src"))

REFERENCE = r'''
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
from repro.launch.mesh import make_production_mesh
out = {}
for mp in (False, True):
    m = make_production_mesh(multi_pod=mp)
    out[str(mp)] = {"shape": list(m.shape.items()),
                    "axis_names": list(m.axis_names), "size": m.size}
json.dump(out, sys.stdout)
'''


def test_production_meshes_match_the_reference():
    r = subprocess.run([sys.executable, "-c", REFERENCE], capture_output=True,
                       text=True, env=ENV, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    ref = json.loads(r.stdout)
    for mp in (False, True):
        m = MESH.make_production_mesh(multi_pod=mp)
        want = ref[str(mp)]
        assert [list(kv) for kv in m.shape.items()] == want["shape"]
        assert list(m.axis_names) == want["axis_names"]
        assert m.size == want["size"]
        assert MESH.mesh_axes(mp) == JMESH.mesh_axes(mp)
        assert m.axes() == JMESH.mesh_axes(mp)


def test_debug_mesh_needs_the_cards():
    n = torch.cuda.device_count()
    if n:
        m = MESH.make_debug_mesh(1, 1)
        assert m.shape == {"data": 1, "model": 1} and m.size == 1
    with pytest.raises(RuntimeError, match="CUDA cards"):
        MESH.make_debug_mesh(1, n + 1)
    with pytest.raises(RuntimeError, match="CUDA cards"):
        MESH.make_debug_mesh(0, 1)


def _cli(tmp_path, *args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
         "--out", str(tmp_path)], capture_output=True, text=True, env=ENV,
        timeout=300)


RECORD_KEYS = {"cell", "arch", "shape", "mesh", "status", "n_chips",
               "trace_s", "per_device_batch", "flops_per_dev",
               "bytes_per_dev", "memory", "compute_s", "memory_s",
               "collective_s", "bottleneck", "fits", "notes"}


def test_cli_writes_one_record(tmp_path):
    r = _cli(tmp_path, "--arch", "qwen1_5_0_5b", "--shape", "decode_32k")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "1 ok, 0 skip, 0 fail" in r.stdout
    assert os.listdir(tmp_path) == ["qwen1_5_0_5b.decode_32k.16x16.json"]
    with open(tmp_path / "qwen1_5_0_5b.decode_32k.16x16.json") as f:
        rec = json.load(f)
    assert RECORD_KEYS <= set(rec)
    assert rec["status"] == "ok" and rec["n_chips"] == 256
    assert rec["per_device_batch"] == 8 and rec["collective_s"] is None
    assert rec["collectives_per_dev"] is None
    m = rec["memory"]
    assert m["argument_bytes_per_dev"] == (
        m["param_bytes_per_dev"] + m["cache_bytes_per_dev"]
        + m["input_bytes_per_dev"])
    assert rec["compute_s"] == rec["flops_per_dev"] / D.PEAK_FLOPS
    assert rec["memory_s"] == rec["bytes_per_dev"] / D.HBM_BW
    assert rec["bottleneck"] == "memory_s" and rec["fits"] is True
    assert any("collective" in n for n in rec["notes"])
    assert "compile_s" not in rec


def test_cli_skip_writes_its_reason(tmp_path):
    r = _cli(tmp_path, "--arch", "qwen1_5_0_5b", "--shape", "long_500k",
             "--multi-pod")
    assert r.returncode == 0, r.stderr[-2000:]
    with open(tmp_path / "qwen1_5_0_5b.long_500k.2x16x16.json") as f:
        rec = json.load(f)
    assert rec["status"] == "skip"
    assert rec["reason"].startswith("pure full attention")


def test_failed_cell_fails_the_run(tmp_path, monkeypatch, capsys):
    """A cell's exception makes that cell ``fail`` (with its error), and
    ``main`` returns 1."""
    def broken(*a, **k):
        raise RuntimeError("boom")
    monkeypatch.setattr(D, "estimate", broken)
    assert D.main(["--arch", "qwen1_5_0_5b", "--shape", "decode_32k",
                   "--out", str(tmp_path)]) == 1
    with open(tmp_path / "qwen1_5_0_5b.decode_32k.16x16.json") as f:
        rec = json.load(f)
    assert rec["status"] == "fail" and rec["error"] == "RuntimeError: boom"
    assert "0 ok, 0 skip, 1 fail" in capsys.readouterr().out


def test_train_on_a_one_device_mesh(tmp_path):
    from repro_torch.launch.train import TrainCfg, train
    tc = TrainCfg(steps=2, batch=2, seq=16, ckpt_dir=str(tmp_path / "ck"),
                  log_every=100)
    out = train("gpt2_small", tc, mesh=MESH.Mesh(("data", "model"), (1, 1)),
                device="cpu")
    assert len(out["losses"]) == 2
