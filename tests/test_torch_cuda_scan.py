"""The stacked-layer layout (``scan_layers``) on the card.  Skipped where
there is no card; on one:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda_scan.py

(``--noconftest``: the suite's conftest imports the JAX package, which the
card's machine need not have; nothing here imports it.)  The layout runs
no kernel of the port: these hold its plain PyTorch ops on the card
against the CPU and against the per-layer layout."""
import dataclasses

import pytest
import torch

pytestmark = pytest.mark.cuda

# the smoke configs with a stacked period (jamba, xlstm), an encoder
# (whisper), and gemma3 with 14 layers of its full config's pattern
# (6 x 2 stacked and a tail of 2; windows cut to 4), as
# tests/test_torch_scan.py builds it
ARCHS = ["jamba_v0_1_52b", "xlstm_350m", "whisper_small", "gemma3_tail"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def _cfg(arch):
    from repro_torch.configs import get_arch
    if arch != "gemma3_tail":
        return dataclasses.replace(get_arch(arch).smoke, dtype=torch.float32)
    b = get_arch("gemma3_1b")
    layers = tuple(dataclasses.replace(s, window=4) if s.window else s
                   for s in b.cfg.layers[:14])
    return dataclasses.replace(b.smoke, n_layers=14, layers=layers,
                               dtype=torch.float32)


def _run(arch, device, scan_layers):
    """Stacked weights drawn on the CPU from seed 0 (embedding x 50), on
    ``device`` stacked or as their per-layer tree of views: no-cache
    logits (whisper with a seeded enc_input) and 6 greedy tokens of
    ``generate`` (LUT ops off), on the host."""
    from repro_torch._tree import tree_map
    from repro_torch.launch import serve as S
    from repro_torch.models import model as M
    cfg = _cfg(arch)
    sh = cfg.shard_cfg(dp=("data",), tp_size=1, dp_size=1)
    gen = torch.Generator().manual_seed(0)
    params = M.init(cfg, sh, gen, "cpu", scan_layers=True)
    params["embed"] = params["embed"] * 50.0
    prompt = torch.randint(0, cfg.vocab, (2, 16), generator=gen)
    enc = None
    if cfg.encoder is not None:
        enc = torch.randn((2, cfg.encoder.frames, cfg.d), generator=gen)
        enc = enc.to(device)
    params = tree_map(lambda p: p.to(device), params)
    if not scan_layers:
        params = M.unstack(cfg, params)
    with torch.no_grad():
        logits, _, _ = M.forward(cfg, sh, params, prompt.to(device),
                                 enc_input=enc)
    toks = S.generate(cfg, sh, params, prompt[:, :3].to(device),
                      S.ServeCfg(max_new_tokens=6), use_lut=False)
    return logits.cpu(), toks.cpu()


@pytest.mark.parametrize("arch", ARCHS)
def test_stacked_layout_on_card(dev, arch):
    """On the card the stacked and the per-layer layout give the same
    logits bit for bit and the same tokens, and the stacked run is the
    CPU's within tests/test_torch_models.py's exact-path tolerance (rtol
    1e-4, atol 1e-4 x the largest |logit|), tokens equal."""
    stacked, st_toks = _run(arch, dev, True)
    per_layer, pl_toks = _run(arch, dev, False)
    assert torch.equal(stacked, per_layer)
    assert torch.equal(st_toks, pl_toks)
    cpu, cpu_toks = _run(arch, torch.device("cpu"), True)
    scale = float(cpu.abs().max())
    torch.testing.assert_close(stacked, cpu, rtol=1e-4, atol=1e-4 * scale)
    assert torch.equal(st_toks, cpu_toks)
