"""The port stands alone: no module of ``src/repro_torch``, not
``chip_smoke.py`` and not the port's examples (``examples/*_torch.py``)
imports ``jax``, ``ml_dtypes`` or anything of the JAX package ``repro``;
and asking for the card where there is none raises instead of falling back
to the CPU."""
import ast
import os
from pathlib import Path

import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
PORT = os.path.join(ROOT, "src", "repro_torch")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    examples = os.path.join(ROOT, "examples")
    out += [os.path.join(examples, f) for f in os.listdir(examples)
            if f.endswith("_torch.py")]
    for dirpath, _, files in os.walk(PORT):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_modules(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_and_no_reference_package():
    files = _port_files()
    assert len(files) > 20
    for module in ("dryrun.py", "mesh.py"):
        assert os.path.join(PORT, "launch", module) in files
    assert sum(f.endswith("_torch.py") for f in files) == 4
    bad = []
    for path in files:
        for mod in _imported_modules(path):
            root = mod.split(".")[0]
            if root in ("jax", "jaxlib", "repro", "ml_dtypes"):
                bad.append((os.path.relpath(path, ROOT), mod))
    assert not bad, bad


def _defaults_to_the_device(node, device: str) -> bool:
    """A default of ``device`` or torch.device(``device``)."""
    if isinstance(node, ast.Constant):
        return node.value == device
    return (isinstance(node, ast.Call) and len(node.args) == 1
            and _defaults_to_the_device(node.args[0], device))


def _defaults_to(device: str):
    """(file, line) of every function of the port with a default argument
    of ``device`` or ``torch.device(device)``."""
    bad = []
    for path in _port_files():
        with open(path) as fh:
            tree = ast.parse(fh.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                args = node.args
                for d in args.defaults + [d for d in args.kw_defaults if d]:
                    if _defaults_to_the_device(d, device):
                        bad.append((os.path.relpath(path, ROOT), node.lineno))
    return bad


def test_no_function_defaults_to_the_cpu():
    """The CPU runs only where a caller names it: no default argument of
    the port says "cpu"."""
    bad = _defaults_to("cpu")
    assert not bad, bad


def test_no_function_defaults_to_meta():
    """``meta`` tensors (the dry run's) are made only where a caller names
    the device: no default argument of the port says "meta"."""
    bad = _defaults_to("meta")
    assert not bad, bad


def test_meta_only_when_named():
    """``resolve_device`` returns ``meta`` when asked for it, and never in
    place of a missing card."""
    from repro_torch.device import resolve_device
    assert resolve_device("meta") == torch.device("meta")
    assert resolve_device(torch.device("meta")).type == "meta"
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device(device)


def test_build_dir_is_the_checkout_or_the_user_cache(tmp_path, monkeypatch):
    from repro_torch.kernels import _build
    assert _build.BUILD_DIR == Path(ROOT).resolve() / "build" / "repro_torch"
    installed = (tmp_path / "lib" / "python3.12" / "site-packages"
                 / "repro_torch" / "kernels" / "_build.py")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert _build.build_dir(installed) == tmp_path / "cache" / "repro_torch"
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert _build.build_dir(installed) == (tmp_path / "home" / ".cache"
                                           / "repro_torch")


def test_cuda_without_a_card_raises():
    from repro_torch import api
    from repro_torch.core import blocks as B
    from repro_torch.core import merkle as M
    from repro_torch.core.transcript import Transcript
    from repro_torch.device import resolve_device
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    for make in (lambda: resolve_device(None), lambda: resolve_device("cuda"),
                 lambda: Transcript("x"),
                 lambda: M.verify_multiproof(None, None),
                 lambda: api.ProofService([B.BlockCfg(
                     family="gpt2", d=8, dff=16, heads=1, kv_heads=1, dh=8,
                     seq=4)], [{}])):
        with pytest.raises(RuntimeError, match="cuda"):
            make()


def test_wrappers_reject_bad_operands():
    from repro_torch.kernels import ntt_kernel as K2
    from repro_torch.kernels import poseidon2_kernel as K1
    from repro_torch.kernels import sumcheck_round as K3
    with pytest.raises(ValueError):
        K1.permute_batch(torch.zeros((3, 15), dtype=torch.int64))
    with pytest.raises(ValueError):
        K2.ntt_rows(torch.zeros((2, 6), dtype=torch.int64))
    with pytest.raises(ValueError):
        K3.prove_rounds([torch.zeros((1, 3, 4), dtype=torch.int64)],
                        torch.zeros((1, 16), dtype=torch.int64))


def test_train_without_a_card_raises(tmp_path):
    """``train()`` and the CLI default to the card: without one they raise
    before they draw a weight or touch the checkpoint directory."""
    from repro_torch.launch import train as T
    if torch.cuda.is_available():
        return
    tc = T.TrainCfg(steps=1, ckpt_dir=str(tmp_path / "ck"))
    with pytest.raises(RuntimeError, match="cuda"):
        T.train("gpt2_small", tc)
    with pytest.raises(RuntimeError, match="cuda"):
        T.main(["--smoke", "--steps", "1", "--ckpt-dir", tc.ckpt_dir])
    assert not os.path.exists(tc.ckpt_dir)
