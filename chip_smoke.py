#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. device  — requires CUDA; the card's name and power limit (nvidia-smi).
2. build   — compiles the five CUDA kernels (K1 Poseidon2, K2 NTT, K3
             sum-check rounds, K4 modular matmul, K5 sum-check fold) from
             ``src/repro_torch/csrc`` for sm_90a, one nvcc per source, all
             at once.
3. kernels — each kernel against its plain PyTorch version on the card, at
             the shapes of the d=128 attestation path (K2's RS encode and
             K4 at every shape one attest and the setup launch; K5 at the
             largest sum-check claim of that path, and a sweep of small
             ones; K2's long rows at 2^16 and 2^17 words
             and the verifier's 4x2^14 -> 2^16 encode), with the edge words
             0, 1, P-1, P-2; results must be equal element for element.
             Times kernel and plain version with CUDA events (K2, K4, K5
             also by torch.profiler).  K5 (time_k5) at d=2
             n=2^19, d=3 n=2^17, the analysis's (16, 4) and d=2 n=2^27
             (the TinyLlama-width opening's claim, against the plain
             version in chunks of pairs): event ms, device ms, cold-L2
             device ms, host us and launches per call, device operations
             per call, both bounds.
   k1k3    — K1 and K3 at the main path's dominant shapes (a one-row
             4096-word and 4-word sponge, hash_rows 4096x512, K3 at d = 2
             and 3 for n = 1024 and d = 2 for n = 2^19): CUDA-event and
             profiler device ms per call, launches per call, bound, and for
             K1 the microseconds per permutation of the serial chain.
   k2k4    — K2's RS encode (pcs._rs_encode) and K4 at the shapes one
             attest launches (the helper's, the aux witness's; the weight
             shape K4 opens every attest and K2 encodes at setup), K2's
             plain transform and an encode at blowup 8: profiler device ms
             per call (the kernel's own apart from the rest, e.g. an older
             checkout's pad), CUDA-event ms over >= 20 calls, host us per
             call, launches per call, bound, int64-byte floor.
4. golden  — attests the repository's 1-layer golden model on the card;
             the v1/v2 bytes must equal tests/data/golden_v{1,2}.bin, the
             port's verifier must accept both and reject a flipped byte.
5. serve   — a ProofService on a 4-layer gpt2 chain at d=128 (random
             weights from a seed) answers 3 seeded queries; each attestation
             is verified against the ModelCard bytes.  The kernels' launch
             counters are zeroed just before and read just after: K1-K4
             must have launched.  The last attest runs under
             torch.profiler, for the device's busy share and K2/K4's device
             ms; its K2 and K4 calls are counted by shape and must be the
             shapes k2k4 times (ATTEST_K2, ATTEST_K4).  The first attest's
             eq-vector builds are replayed batched and one table at a
             time (time_e_vec): equal words, the two times.  Then 2 of the
             queries again, one attest each at ProofService's default
             worker count (2 threads, the round batcher on): bytes equal,
             seconds against the serial ones, the batcher's counters and
             its claims' waits.  Last, the chain's first layer alone (a
             one-layer service from the same seed) attests query 0: its
             canonical v2 bytes and ModelCard must equal the JAX package's
             tests/data/golden_d128_{v2,card}.bin, and the card's verifier
             must accept the golden and reject it with a flipped byte.
6. analysis — the soundness analysis in-process on the card
             (``python -m repro_torch.analysis --all --mutants``): zero
             findings, every kernel equal to its plain version on edge
             words, all six mutants caught.  Then one more attestation of
             the served chain, recorded, and the Fiat-Shamir and tape
             lints over it: zero findings.  The counters are zeroed just
             before and read just after: all five kernels, K5 among them
             (it runs on this path only), must have launched.
7. llama   — first the llama golden toy (tests/data/gen_golden_llama.py)
             on the card, its bytes equal to golden_llama_{card,v1,v2}.bin,
             accepted by the port's verifier, a flipped byte rejected;
             then the llama family at TinyLlama-1.1B width (d=2048, dff=5632,
             32 query heads on 4 KV heads, dh=64, seq=8), 2 of its 22
             layers (depth cut for the card's memory), random weights from
             a seed: Fisher scores from ``fisher_from_logprob_fn`` on the
             card over a small float function of the two layers'
             dequantized weights (and again on the CPU: the same scores);
             a ProofService holding them publishes its ModelCard, answers
             2 attests at budget 1.0 and 1 at budget 0.5 with the fisher
             selector, each verified by the port on the card; the Fisher
             attest must prove exactly the layer ``select_fisher`` picks.
             Per request: seconds, forward / commit / prove seconds, verify
             seconds, wire bytes, checked layers, launches per kernel, the
             K2/K4 shape histogram, peak device memory; for the setup, its
             peak by stage (MemoryStages).  The counters are zeroed just
             before and read just after: K1-K4 must have launched, K2 on
             rows of 2^16 and 2^17 words (its two-launch long-row path,
             counted apart as ``ntt_long_rows``).  The kernels phase holds
             that path against the plain version; k2long times it at the
             llama path's shapes and holds it against the plain version
             at 512 rows, then commits a 2^16-word vector in codeword rows
             of 2^16 words and opens it at one point: root, ``us``,
             ``u_prox``, columns, Merkle paths and transcript state equal
             to the JAX package's tests/data/golden_pcs_long.npz word for
             word, the golden bundle accepted by the card's verifier.

8. gateway — the serving tier on the serve phase's chain: two clients
             each send 2 queries at once (one connection a query) to an
             AttestationGateway (windows of up to 4) over
             ProofService(workers=2), on a socket on 127.0.0.1; each
             request stream-verifies as its chunks arrive.  Every
             attestation's v2 bytes (prove_seconds set to 0) must equal a
             serial workers=1 attest of its query.  Per window: size, the
             round batcher's batched claims, waves and their (d, n,
             claims), its flushes and the seconds its claims waited for
             them (the straggler timeout's apart), K3 launches against the
             serial sum, seconds; per
             query: verify seconds.  Some claims must share a K3 call and
             K3 launches per query must fall below serial.
   k3batch — K3 at every (d, n, claims) those waves met, padded to a power
             of two with zero claims and zero states as the batcher pads
             them: the real rows equal the plain version and per-claim
             K = 1 launches word for word; the most frequent shape timed.
9. process — 3 attests on ProofService(workers=2, backend="process"):
             bytes equal to the serial ones; the first attest's seconds
             apart from the warm ones; each job's pickled payload bytes
             (they must stay below the weight commitment's device bytes:
             tensors cross as IPC handles) and each child's allocated
             device bytes once its payload is in; the children's kernel
             launches come back with their jobs.  Once the service is
             closed the parent's allocated bytes must be back where they
             were before it (the workers released all they were sent).
10. llama_batch — on the llama phase's weights and commitments:
             attest_many of 2 queries on 2 threads, then one attest on 2
             worker processes, bytes equal to the llama phase's serial
             attests; peak device memory by stage in the parent and in
             each child; the parent's allocation back at its baseline
             once the process-backed service is closed.
11. matmul_proof — ``core.matmul_proof`` prove and verify for C = A.B at
             (n, k, m) = (8, 2048, 2048), a TinyLlama-width projection at
             seq 8: the proof and its three claims equal the same call on
             the CPU word for word, a flipped c_claim is rejected; prove
             and verify ms and the K3/K4 launches (counts zeroed just
             before the timed prove, read just after).
12. model  — ``launch.serve.generate`` at full width: TinyLlama-1.1B (22
             layers, d=2048, 32 heads on 4 KV heads, vocab 32000) and
             GPT-2 Small (12 layers, d=768, vocab 50257), bf16, random
             weights from a torch.Generator; batch 2, a 16-token prompt,
             16 new tokens, LUT ops on and off.  Logits finite, tokens in
             [0, vocab), the cached decode's last token the argmax of a
             no-cache forward over the same tokens (a bf16 near-tie
             within ARGMAX_TIE accepted and reported); prefill ms, decode
             ms per token, tokens/s, peak allocated bytes.
13. zoo    — the rest of the float model zoo at full width (bf16, random
             weights from a torch.Generator, batch 2, a 16-token prompt,
             8 new tokens, LUT ops on and off): Moonlight-16B-A3B whole
             (48 layers, ~56 GB), jamba-v0.1-52b's first 8 of 32 layers
             and qwen2-vl-72b's first 4 of 80 (depth cut for the card's
             memory), whisper-small whole with its encoder over 1500
             seeded frames, xlstm-350m whole.  Logits finite, tokens in
             [0, vocab); qwen2-vl and whisper: the model phase's argmax
             check (whisper through forward and decode_step with its
             enc_input); Moonlight, jamba and xlstm, whose reference
             makes a cached decode differ from a full forward: a cached
             prefill equal to the no-cache forward, and two generate runs
             giving equal tokens.  Init s, prefill ms, decode ms per
             token, tokens/s, peak allocated, one profiled decode step
             against the weights' read floor.  Then the six new archs'
             smoke configs at float32 on the card against the CPU, and
             the serving CLI in process on each.
14. serve_cli — ``launch.serve.emit_attestation`` of the serving golden's
             tokens on the card, its files equal to
             tests/data/golden_serve_v{1,2}.bin and sidecars
             (tests/data/gen_golden_serve.py; K1-K4 must launch); then
             ``python -m repro_torch.launch.serve --arch gpt2_small
             --with-proof --emit`` and ``--verify-file --stream-verify``
             in two fresh processes, each exiting 0 with verified=True;
             the seconds of each.
15. train  — ``launch.train.train`` at full width and depth, bf16 weights
             from TrainCfg's seed, batch 8 x seq 128 in 2 microbatches,
             int8 gradient compression on: GPT-2 Small 20 steps to a
             checkpoint at step 20, then a second ``train`` on the same
             directory that must resume at 20 and run to 40 (its last
             loss below the first run's first), then 4 steps with remat
             off; TinyLlama-1.1B 4 steps with remat on and 4 with it off
             (finite losses, no checkpoint).  Per run: step ms (median
             after the first), tokens/s, the 6 N tokens FLOP estimate and
             its share of the 989 TFLOP/s bf16 peak, the pipeline's host
             ms per batch, peak allocated bytes; for GPT-2 the checkpoint's
             bytes, ``save_async``, ``wait_pending`` and ``restore``
             seconds; one step of each model under torch.profiler (the
             device's busy share, kernel launches); one JSON line a
             model, then the phase's own line.  First, the smoke
             config's ``make_train_step`` at float32 on the card against
             the CPU: 3 steps without compression and 1 with, losses and
             grad norms within rtol 1e-4, weights within
             tests/test_torch_train_step.py's bound.  No kernel of the
             port runs here: the training step is PyTorch's matmuls and
             autograd, as the JAX package's is plain ``jnp``.
16. dryrun — ``launch.dryrun`` (no kernel of the port runs here), every
             cell on the stacked parameter tree (``scan_layers``): the
             records of two production cells traced on meta
             (DRYRUN_PRODUCTION); then three one-device cells
             (DRYRUN_CARD_CELLS, batch cuts printed as ``reduced``) whose
             estimate is held against the same step run for real on the
             card from ``model.init`` weights (``dryrun.check_on_card``):
             the bytes ``memory_allocated`` gains for the arguments
             within the caching allocator's rule applied to each tensor
             (512 B rounding, an unsplit tail of up to 1 MiB a block over
             1 MiB: ``argument_alloc_{min,max}_per_dev``), the bytes
             requested equal to ``argument_bytes_per_dev``, the step's
             peak allocated within 10% of arguments plus
             ``temp_bytes_per_dev``, FlopCounterMode's count on the card
             equal to the meta trace's; the step's wall ms (median of 3
             after the counted step) beside the roofline's, reported
             only.  Last, the sequence-sharded decode cache: a cached
             prefill and 4 greedy decode steps of the tinyllama smoke
             config with and without ``ShardCfg.cache_seq``, logits and
             tokens equal bit for bit.
17. scan   — the stacked-layer layout (``scan_layers``; no kernel of the
             port runs here): gemma3-1b (26 layers: 6 x 4 stacked and a
             tail of 2) and xlstm-350m (24: 4 x 6) at full width and
             depth, bf16, weights from a torch.Generator; ``generate``
             (batch 2, a 16-token prompt, 8 new tokens, LUT ops on) and a
             no-cache forward on the stacked tree and on the per-layer
             tree of the same weights: tokens equal, the largest logit
             difference printed and within ARGMAX_TIE of the largest
             |logit|; decode ms per step and peak allocated of each.  GPT-2
             Small trained 4 steps on the stacked tree (TRAIN_CFG, int8
             compression on): the first batch's loss must fall.  The
             smoke config's stacked train step (compression on) on the
             card against the CPU's, as the train phase's twin.

Then one ``{"kernels": [...]}`` line (K3's multi-claim calls as a row of
their own), the nvidia-smi line, and the final ``{"ok": true, "device":
{...}}`` line.  Imports nothing of JAX.
"""
from __future__ import annotations

import gc
import inspect
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
DATA = os.path.join(ROOT, "tests", "data")
P = 2013265921
EDGE_WORDS = (0, 1, P - 1, P - 2)

# The served configuration: the paper's headline width, also the full-run
# width of benchmarks/table3_block_proof.py; depth and width are not cut.
SERVE_CFG = dict(family="gpt2", d=128, dff=512, heads=4, kv_heads=4, dh=32,
                 seq=8)
SERVE_LAYERS = 4
SERVE_QUERIES = 3
PCS_BLOWUP = 4
PCS_QUERIES = 16
SEED = 0

# Golden toy model: the config and seeds of tests/data/gen_golden.py.
GOLDEN_CFG = dict(family="gpt2", d=8, dff=16, heads=1, kv_heads=1, dh=8,
                  seq=4)
GOLDEN_WEIGHT_SEED = 1234
GOLDEN_QUERY_SEED = 5678
# The llama golden toy: the config and seeds of tests/data/gen_golden_llama.py.
GOLDEN_LLAMA_CFG = dict(family="llama", d=8, dff=16, heads=2, kv_heads=1,
                        dh=4, seq=4)
GOLDEN_LLAMA_WEIGHT_SEED = 4321
GOLDEN_LLAMA_QUERY_SEED = 8765

# Peak rates of one H100 SXM (at its 700 W limit): HBM bandwidth, and the
# INT32 issue rate = 132 SMs x 64 INT32 lanes x 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# Montgomery products in one Poseidon2 permutation: 4 per S-box (8 full
# rounds x 16 lanes + 13 partial rounds x 1) and 16 per internal layer.
PERM_MULS = 4 * (8 * 16 + 13) + 16 * 13
F4_MULS = 16
# Bytes of one field word in the bounds: the functions work on u32 words
# (the port stores them in int64 tensors, which moves twice as many bytes).
WORD_BYTES = 4
INT64_BYTES = 8

# The K2 and K4 calls of one attest of the served chain, as the serve
# phase's histogram reports them: K2 by (rows, n, c), an RS encode of
# rows x c message words into rows x n; K4 by (M, K, N).  K2: the LogUp
# helper (2^20 words), the aux witness, the boundary batch; K4: the opening
# rows of the helper, weight, aux and short commitments.  SETUP_*: the calls
# made once per service (weight commitment; its range proof's helper,
# encoded again for the opened columns).
ATTEST_K2 = {(1024, 4096, 1024): 4, (256, 2048, 512): 4, (160, 256, 64): 1}
ATTEST_K4 = {(4, 1024, 1024): 4, (4, 512, 1024): 4, (4, 256, 512): 4,
             (4, 32, 64): 8}
SETUP_K2 = {(512, 4096, 1024): 4, (1024, 8192, 2048): 8}
SETUP_K4 = {(4, 1024, 2048): 4}

# The llama family at the width of TinyLlama-1.1B
# (src/repro/configs/tinyllama_1_1b.py: d=2048, ffn 5632, 32 heads on 4 KV
# heads of 64), at seq 8.  Depth is cut from 22 layers to 2: a layer's
# weight commitment keeps ~5 GiB of int64 words on the card and its setup
# passes through ~50 GiB more, so 22 would not fit in 80 GB.
LLAMA_CFG = dict(family="llama", d=2048, dff=5632, heads=32, kv_heads=4,
                 dh=64, seq=8)
LLAMA_LAYERS = 2
LLAMA_FULL_LAYERS = 22
LLAMA_ATTESTS = 2              # at budget 1.0; then one Fisher-selected
LLAMA_FISHER_BUDGET = 0.5
LLAMA_FISHER_RTOL = 1e-5       # card against CPU, as tests/test_torch_fisher.py
LLAMA_VOCAB = 64               # the Fisher function's readout classes

# The serving tier on the served d=128 chain: 2 attests at ProofService's
# default worker count; two clients each send 2 queries at once
# (serve_query(0..3), one connection per query; 2, not more, to keep the
# whole smoke well inside its 1200 s with the train phase)
# through a gateway over ProofService(workers=2), windows of up to 4; the
# process backend answers
# 3 attests on 2 worker processes; the llama chain answers 2 queries in one
# attest_many window on 2 threads, then 1 attest on 2 worker processes.
DEFAULT_WORKER_ATTESTS = 2
GATEWAY_CLIENTS = 2
GATEWAY_QUERIES_PER_CLIENT = 2
GATEWAY_MAX_BATCH = 4
GATEWAY_WINDOW_SECONDS = 0.5
SERVE_WORKERS = 2
PROCESS_ATTESTS = 3
LLAMA_BATCH = 2

# The matmul sum-check at a TinyLlama-width projection (d=2048) at seq 8.
MATMUL_SHAPE = (8, 2048, 2048)
# The float model at full width: the paper's two evaluation models
# (src/repro_torch/configs/{tinyllama_1_1b,gpt2_small}.py, all their layers,
# bf16), random weights; the embedding scaled as tests/test_torch_models.py
# scales it; a near-tie of the bf16 argmax is accepted within ARGMAX_TIE of
# the largest |logit|.
MODEL_ARCHS = ("tinyllama_1_1b", "gpt2_small")
MODEL_BATCH = 2
MODEL_PROMPT = 16
MODEL_NEW_TOKENS = 16
EMBED_SCALE = 50.0
ARGMAX_TIE = 2.0 ** -6
# The rest of the float model zoo at full width (src/repro_torch/configs/,
# bf16, random weights as in the model phase): (arch, layers run or None
# for all).  Moonlight-16B-A3B whole (its ~56 GB of bf16 weights fit the
# card); jamba-v0.1-52b cut to its first period of 8 layers (all 32 need
# ~104 GB) and qwen2-vl-72b to 4 of 80 (all need ~145 GB); whisper-small's
# 12 + 12 layers, its encoder over ENCODER frames of a seeded enc_input;
# xlstm-350m whole.
ZOO_RUNS = (("moonshot_v1_16b_a3b", None), ("jamba_v0_1_52b", 8),
            ("qwen2_vl_72b", 4), ("whisper_small", None), ("xlstm_350m", None))
ZOO_NEW_TOKENS = 8
# Archs whose reference makes a cached decode differ from a full forward
# (the MoE's capacity grows with the token count; the mLSTM decode step
# floors its normaliser at 1.0): checked by a cached prefill against a
# no-cache forward over the same tokens, relative to the largest |logit|
# (the two run the same operations on the same shapes), and by two
# generate runs giving equal tokens (the MoE's combine has no atomics).
ZOO_PREFILL_ARCHS = ("moonshot_v1_16b_a3b", "jamba_v0_1_52b", "xlstm_350m")
ZOO_PREFILL_RTOL = 1e-3
# The smoke twin: the six new archs' smoke configs at float32 on the card
# and on the CPU through the port, tests/test_torch_models.py's exact-path
# tolerance (rtol 1e-4, atol 1e-4 x the largest |logit|); greedy tokens
# equal.
ZOO_SMOKE_ARCHS = ("grok_1_314b", "moonshot_v1_16b_a3b", "jamba_v0_1_52b",
                   "qwen2_vl_72b", "whisper_small", "xlstm_350m")
ZOO_TWIN_RTOL = 1e-4
# The serving CLI's demo attestation (tests/data/gen_golden_serve.py).
SERVE_CLI_QUERIES = 8
SERVE_CLI_LAYERS = 2
SERVE_CLI_TIMEOUT = 300
# Training at full width and depth (src/repro_torch/configs/{gpt2_small,
# tinyllama_1_1b}.py CFG, random weights from TrainCfg's seed):
# launch.train.train with batch 8 x seq 128 in 2 microbatches, int8
# gradient compression; GPT-2 Small to a checkpoint at step
# TRAIN_GPT2_STEPS[0], then resumed on the same directory to
# TRAIN_GPT2_STEPS[1] (AdamW's 100 warmup steps keep the learning rate
# small: the loss needs tens of steps to fall), then a few steps with
# remat off; TinyLlama-1.1B a few steps with remat on and off, no
# checkpoint.  The smoke config's train step on the card is held against
# the CPU's within tests/test_torch_train_step.py's tolerances
# (TRAIN_TWIN_*).
TRAIN_CFG = dict(batch=8, seq=128, microbatches=2, compress_grads=True,
                 log_every=10)
TRAIN_GPT2_STEPS = (20, 40)
TRAIN_REMAT_OFF_STEPS = 4
TRAIN_LLAMA_STEPS = 4
TRAIN_TWIN_ARCH = "gpt2_small"
TRAIN_TWIN_RUNS = ((False, 3), (True, 1))      # (compression, steps)
TRAIN_TWIN_LR = 1e-3
TRAIN_TWIN_RTOL = 1e-4
TRAIN_TWIN_CHANGED_SHARE = 0.005
BF16_PEAK_FLOPS = 989e12        # H100 SXM dense bf16 (NVIDIA's data sheet)

# the dry run: production cells traced on meta, and one-device cells whose
# estimates are held against the card, (arch, shape, batch cut or None)
DRYRUN_PRODUCTION = (("qwen1_5_0_5b", "decode_32k"),
                     ("xlstm_350m", "long_500k"))
DRYRUN_CARD_CELLS = (("qwen1_5_0_5b", "decode_32k", 4),
                     ("qwen1_5_0_5b", "train_4k", 1),
                     ("xlstm_350m", "long_500k", None))
DRYRUN_CACHE_SEQ_STEPS = 4

# The stacked-layer layout (model.scan_split) at full width and depth,
# bf16, random weights as in the zoo phase: gemma3-1b (6 x 4 stacked, a
# tail of 2) and xlstm-350m (4 x 6), generate on the stacked tree and on
# the per-layer tree of the same weights (views); GPT-2 Small trained
# SCAN_TRAIN_STEPS steps on the stacked tree (TRAIN_CFG, compression on).
SCAN_ARCHS = ("gemma3_1b", "xlstm_350m")
SCAN_TRAIN_STEPS = 4

# JAX-made goldens: the served chain's first layer at d=128
# (tests/data/gen_golden_d128.py) and the long-row PCS opening at one point
# (tests/data/gen_golden_pcs_long.py: 2^16 words from seed 61 committed at
# aspect -6, opened at the point from seed 70 from a fresh transcript).
GOLDEN_PCS_LONG = dict(words=1 << 16, aspect=-6, vec_seed=61, point_seed=70,
                       label="long-rows")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def progress(phase: str, what: str, t0: float) -> None:
    """A line on standard error as a long phase goes (its JSON comes at
    the end)."""
    print(f"[{phase}] {what} at {time.monotonic() - t0:.1f} s", file=sys.stderr,
          flush=True)


def fail(phase: str, msg: str) -> None:
    emit({"phase": phase, "ok": False, "error": msg})
    sys.exit(1)


# ---------------------------------------------------------------------------
# Helpers.
# ---------------------------------------------------------------------------
def rand_words(gen, shape, dev):
    """Uniform Montgomery words with the edge words planted at the front."""
    import numpy as np
    import torch
    a = gen.integers(0, P, size=shape, dtype=np.int64)
    flat = a.reshape(-1)
    flat[:min(len(EDGE_WORDS), flat.size)] = EDGE_WORDS[:flat.size]
    return torch.as_tensor(a, device=dev)


def max_abs_err(a, b) -> int:
    if a.shape != b.shape:
        return -1
    return int((a - b).abs().max().item()) if a.numel() else 0


def gpu_ms(fn, iters: int = 3) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, mulmods: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = mulmods / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main_path_shapes():
    """Shapes the d=128 path hands each kernel: the weight commitment
    (the largest: 2^19 words as 512 x 1024) and the aux commitment."""
    from repro_torch.core import blocks as B
    from repro_torch.core import circuit as C
    from repro_torch.core import pcs as PCS
    cfg = B.BlockCfg(**SERVE_CFG)
    out = {}
    for name, declare in (("wt", B.declare_weights), ("aux", B.declare_aux)):
        wb = C.WitnessBuilder(name)
        declare(cfg, wb, None)
        _, _, total = wb.pack()
        out[name] = PCS.shape_for(total)
    return out


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions.
# ---------------------------------------------------------------------------
def check_kernels(dev, shapes, gen):
    """Returns {name: record} with max_abs_err, ms, plain_ms, bound."""
    from repro_torch.kernels import modmatmul as K4
    from repro_torch.kernels import ntt_kernel as K2
    from repro_torch.kernels import poseidon2_kernel as K1
    from repro_torch.kernels import sumcheck_fold as K5
    from repro_torch.kernels import sumcheck_round as K3

    (wr, wc), (ar, ac) = shapes["wt"], shapes["aux"]
    R, C = 1 << wr, 1 << wc
    nw = C * PCS_BLOWUP                       # encoded row length
    rec = {}
    errs = {"poseidon2": 0, "ntt": 0, "ntt_long_rows": 0, "sumcheck_round": 0,
            "modmatmul": 0, "sumcheck_fold": 0}
    owner = {"K1": "poseidon2", "K2": "ntt", "K2long": "ntt_long_rows",
             "K3": "sumcheck_round", "K4": "modmatmul", "K5": "sumcheck_fold"}

    def check(what, a, b):
        e = max_abs_err(a, b)
        name = owner[what.split()[0]]
        errs[name] = max(errs[name], e) if e >= 0 else e
        if e != 0:
            fail("kernels", f"{what}: kernel != plain (max abs err {e})")

    # K1: leaf hashing of the weight commitment (nw columns of R words),
    # compress, permute, squeeze, multi-segment absorb from given states.
    leaves = rand_words(gen, (nw, R), dev)
    check("K1 hash_rows", K1.hash_rows(leaves),
          K1.sponge_plain(None, leaves, R, 1, 8))
    odd = rand_words(gen, (37, 13), dev)
    check("K1 hash_rows L=13", K1.hash_rows(odd),
          K1.sponge_plain(None, odd, 13, 1, 8))
    l8, r8 = rand_words(gen, (nw // 2, 8), dev), rand_words(gen, (nw // 2, 8), dev)
    check("K1 compress_pairs", K1.compress_pairs(l8, r8), K1.compress_plain(l8, r8))
    st = rand_words(gen, (nw, 16), dev)
    check("K1 permute_batch", K1.permute_batch(st), K1.permute_plain(st))
    for a, b in zip(K1.squeeze(st[:3].contiguous(), 3), K1.squeeze_plain(st[:3], 3)):
        check("K1 squeeze", a, b)
    vals = rand_words(gen, (1, 4 * 21), dev)
    check("K1 sponge segments", K1.sponge(st[:1].contiguous(), vals, 4, 21),
          K1.sponge_plain(st[:1], vals, 4, 21))
    # the transcript's one-row absorbs from a given state (4 words per
    # gadget value; 3243 and 4096 words in the PCS), rows that leave warps
    # partly full, squeezes of 1..9 blocks
    st1 = st[:1].contiguous()
    for L in (1, 4, 9, 3243, 4096):
        e = rand_words(gen, (1, L), dev)
        check(f"K1 sponge 1x{L}", K1.sponge(st1, e, L), K1.sponge_plain(st1, e, L))
    for n in (1, 3, 17, 33):
        e = rand_words(gen, (n, 24), dev)
        check(f"K1 hash_rows {n}x24", K1.hash_rows(e),
              K1.sponge_plain(None, e, 24, 1, 8))
    for nb in (1, 9):
        for a, b in zip(K1.squeeze(st[:3].contiguous(), nb),
                        K1.squeeze_plain(st[:3], nb)):
            check(f"K1 squeeze nblocks={nb}", a, b)
    k1_bytes = (leaves.numel() + nw * 8) * WORD_BYTES
    k1_ops = nw * (-(-R // 8)) * PERM_MULS
    rec["poseidon2"] = dict(
        ms=gpu_ms(lambda: K1.hash_rows(leaves)),
        plain_ms=gpu_ms(lambda: K1.sponge_plain(None, leaves, R, 1, 8), 1),
        bound=bound_ms(k1_bytes, k1_ops),
        shape=f"hash_rows {nw}x{R} (weight-commitment leaves)")

    # K2: the RS encode entry at every shape an attest and the setup give
    # it (unpadded message rows in, codewords out); c = 1 and 2, rows that
    # leave a block part full, blowups 1..8; the plain transform both ways
    # at the weight codeword length and on short rows packed to a block.
    for (r, n, c) in list(ATTEST_K2) + list(SETUP_K2):
        msg = rand_words(gen, (r, c), dev)
        check(f"K2 rs_encode {r}x{c} -> {r}x{n}", K2.rs_encode_rows(msg, n // c),
              K2.rs_encode_rows_plain(msg, n // c))
    for c in (1, 2, 64, 512):
        for blowup in (1, 2, 4, 8):
            if c * blowup > 1:
                msg = rand_words(gen, (37, c), dev)
                check(f"K2 rs_encode 37x{c} blowup={blowup}",
                      K2.rs_encode_rows(msg, blowup),
                      K2.rs_encode_rows_plain(msg, blowup))
    rows = rand_words(gen, (R, nw), dev)
    for inv in (False, True):
        check(f"K2 ntt inverse={inv}", K2.ntt_rows(rows, inv),
              K2.ntt_rows_plain(rows, inv))
    for n in (2, 4, 8, 16, 64, 256, 2048, 16384, 32768):
        small = rand_words(gen, (9, n), dev)
        for inv in (False, True):
            check(f"K2 ntt n={n} inverse={inv}", K2.ntt_rows(small, inv),
                  K2.ntt_rows_plain(small, inv))
    # rows longer than 2^15 words: the two-launch path, both entries, at
    # the llama path's row lengths (2^16: weights and the verifier's Fp4
    # row; 2^17: the setup's LogUp helper), and the verifier's exact shape;
    # k2long holds 512-row shapes, where both launches' loops take turns
    for lg in (16, 17):
        n = 1 << lg
        x = rand_words(gen, (3, n), dev)
        for inv in (False, True):
            check(f"K2long ntt n=2^{lg} inverse={inv}", K2.ntt_rows(x, inv),
                  K2.ntt_rows_plain(x, inv))
        msg = rand_words(gen, (3, n // PCS_BLOWUP), dev)
        check(f"K2long rs_encode 3x{n // PCS_BLOWUP} -> 3x{n}",
              K2.rs_encode_rows(msg, PCS_BLOWUP),
              K2.rs_encode_rows_plain(msg, PCS_BLOWUP))
    for (r, n, c), what in K2_LONG_PATH:
        if r * n <= 1 << 20:
            msg = rand_words(gen, (r, c), dev)
            check(f"K2long rs_encode {r}x{c} -> {r}x{n} ({what})",
                  K2.rs_encode_rows(msg, n // c), K2.rs_encode_rows_plain(msg, n // c))
    (hr, hn, hc) = max(ATTEST_K2, key=lambda k: k[0] * k[1])
    hmsg = rand_words(gen, (hr, hc), dev)
    _, prof = profiled_call(lambda: [K2.rs_encode_rows(hmsg, hn // hc) for _ in range(20)])
    rec["ntt"] = dict(
        ms=gpu_ms(lambda: K2.rs_encode_rows(hmsg, hn // hc), 20),
        device_ms=prof["device_busy_ms"] / 20 if prof["device_busy_ms"] else None,
        plain_ms=gpu_ms(lambda: K2.rs_encode_rows_plain(hmsg, hn // hc), 1),
        bound=k2_bound(hr, hn, hc),
        shape=f"rs_encode_rows {hr}x{hc} -> {hr}x{hn} (the LogUp helper, 4 per attest)")

    # K3: d = 1, 2, 3 at the aux commitment's length; the weight opening
    # (d = 2 over R*C) for timing; K = 3 claims at once.
    def k3_case(d, K, n):
        fs = [rand_words(gen, (K, n, 4), dev) for _ in range(d)]
        sts = rand_words(gen, (K, 16), dev)
        for a, b in zip(K3.prove_rounds(fs, sts), K3.prove_rounds_plain(fs, sts)):
            check(f"K3 d={d} K={K} n={n}", a, b)
        return fs, sts

    n_aux = 1 << (ar + ac)
    for d in (1, 2, 3):
        k3_case(d, 1, n_aux)
    for d in (1, 2, 3):
        k3_case(d, 3, 64)
    # around the tail length (one block per claim) and the main path's
    # short claims
    for d in (1, 2, 3):
        for n in (K3.tail_len(d), 2 * K3.tail_len(d)):
            k3_case(d, 1, n)
    for d in (2, 3):
        k3_case(d, 1, 1024)
    # K claims padded as the round batcher pads them (K = 2 at the aux and
    # weight lengths, 3 real claims padded to K = 4 at n = 1024); the
    # shapes the gateway phase's waves meet are checked after it (k3batch)
    for d, n, k in ((2, n_aux, 2), (3, n_aux, 2), (3, 1024, 3), (2, 1024, 3),
                    (2, R * C, 2)):
        e = k3_padded_check(gen, dev, d, n, k)
        errs["sumcheck_round"] = max(errs["sumcheck_round"], e)
    fs, sts = k3_case(2, 1, R * C)
    rec["sumcheck_round"] = dict(
        ms=gpu_ms(lambda: K3.prove_rounds(fs, sts)),
        plain_ms=gpu_ms(lambda: K3.prove_rounds_plain(fs, sts), 1),
        bound=k3_bound(2, R * C),
        shape=f"prove_rounds d=2 K=1 n={R * C} (weight-commitment opening)")

    # K4: the opening rows u = eq^T . mat at every shape an attest and the
    # setup give it; M = 1, 5, 11 (two blocks of A rows), 64; odd K, K below
    # a warp of pairs, long K at narrow N, ragged and odd N.
    mm = list(ATTEST_K4) + list(SETUP_K4) + [
        (1, 512, 1024), (5, 33, 70), (11, 33, 70), (4, 1, 3), (4, 7, 9),
        (4, 2048, 64), (4, 1024, 40), (3, 1025, 38), (4, 1026, 36),
        (4, 1026, 1024), (64, 256, 4)]
    for (M, K, N) in mm:
        a, b = rand_words(gen, (M, K), dev), rand_words(gen, (K, N), dev)
        check(f"K4 modmatmul {M}x{K} @ {K}x{N}", K4.modmatmul(a, b),
              K4.modmatmul_plain(a, b))
    a = rand_words(gen, (4, R), dev)
    b = rand_words(gen, (R, C), dev)
    _, prof = profiled_call(lambda: [K4.modmatmul(a, b) for _ in range(50)])
    rec["modmatmul"] = dict(
        ms=gpu_ms(lambda: K4.modmatmul(a, b), 50),
        device_ms=prof["device_busy_ms"] / 50 if prof["device_busy_ms"] else None,
        plain_ms=gpu_ms(lambda: K4.modmatmul_plain(a, b), 1),
        bound=k4_bound(4, R, C),
        shape=f"modmatmul 4x{R} @ {R}x{C} (weight-commitment opening row)")

    # K5: one round with a known challenge at the largest sum-check claim
    # of the path (d = 2 over R*C, K3's timed shape), d = 3 at 2^17, the
    # single pair n = 2, and a sweep of small n; then time_k5 at its
    # shapes (2^27 among them).
    def k5_case(d, n):
        fs = [rand_words(gen, (n, 4), dev) for _ in range(d)]
        c = rand_words(gen, (4,), dev)
        pg, pfolded = K5.fold_round_plain(fs, c)
        g, folded = K5.fold_round(fs, c)
        check(f"K5 d={d} n={n} g", g, pg)
        for t, (a, b) in enumerate(zip(folded, pfolded)):
            check(f"K5 d={d} n={n} folded[{t}]", a, b)

    k5_case(3, 1 << 17)
    k5_case(1, 2)
    for d in (1, 2, 3):
        for lg in (1, 2, 3, 4, 6, 8, 9, 10, 12):
            k5_case(d, 1 << lg)
    k5_case(2, R * C)
    k5 = time_k5(dev, gen)
    errs["sumcheck_fold"] = max(errs["sumcheck_fold"], *(t["max_abs_err"] for t in k5))
    t = k5[0]                                                # K5_SHAPES[0]
    rec["sumcheck_fold"] = dict(
        ms=t["ms"], device_ms=t["device_ms"], plain_ms=t["plain_ms"],
        bound=(t["bound_ms"], t["bound_by"]), shapes=k5, shape=t["shape"])
    for name, r in rec.items():
        r["max_abs_err"] = errs[name]
    rec["ntt"]["long_rows_max_abs_err"] = errs["ntt_long_rows"]
    return rec


def k3_padded(gen, dev, d: int, n: int, k: int):
    """k random claims (edge words planted) padded to a power of two with
    all-zero claims and zero states, as the round batcher pads them."""
    import torch
    kp = 1 << max(k - 1, 0).bit_length()
    fs = [torch.cat([rand_words(gen, (k, n, 4), dev),
                     torch.zeros((kp - k, n, 4), dtype=torch.int64, device=dev)])
          for _ in range(d)]
    sts = torch.cat([rand_words(gen, (k, 16), dev),
                     torch.zeros((kp - k, 16), dtype=torch.int64, device=dev)])
    return fs, sts


def k3_padded_check(gen, dev, d: int, n: int, k: int, phase="kernels") -> int:
    """The padded call's real rows against the plain version on the same
    inputs and against k separate K = 1 launches, word for word: the max
    abs err (the run fails on any difference)."""
    from repro_torch.kernels import sumcheck_round as K3
    fs, sts = k3_padded(gen, dev, d, n, k)
    got = K3.prove_rounds(fs, sts)
    want = K3.prove_rounds_plain(fs, sts)
    err = 0
    for a, b in zip(got, want):
        err = max(err, max_abs_err(a[:k], b[:k]))
    for i in range(k):
        one = K3.prove_rounds([f[i:i + 1].contiguous() for f in fs],
                              sts[i:i + 1].contiguous())
        for a, b in zip(got, one):
            err = max(err, max_abs_err(a[i:i + 1], b))
    if err != 0:
        fail(phase, f"K3 d={d} n={n} {k} claims padded to "
             f"K={fs[0].shape[0]}: rows differ (max abs err {err})")
    return err


def k3_bound(d: int, n: int, K: int = 1):
    """Bound of one prove_rounds call over K claims: per claim, read d n Fp4
    factor words and the state, write g, c, the finals and the state; n - 1
    pairs over all rounds, each with (d + 1)(d - 1) + d Fp4 products, and
    the sponge's permutations."""
    m = n.bit_length() - 1
    perms = m * (-(-4 * (d + 1) // 8) + 1) + -(-4 * d // 8)
    words = d * n * 4 + 16 + m * (d + 1) * 4 + m * 4 + d * 4 + 16
    ops = (n - 1) * ((d + 1) * (d - 1) + d) * F4_MULS + perms * PERM_MULS
    return bound_ms(K * words * WORD_BYTES, K * ops)


def k2_bound(rows: int, n: int, c: int, word_bytes: int = WORD_BYTES):
    """RS encode of rows x c into rows x n (c = n is the plain transform):
    read the message and the n-word twiddle table, write the codewords;
    rows (n / 2) log2 c butterflies, one modular product each."""
    stages = c.bit_length() - 1
    return bound_ms((rows * c + n + rows * n) * word_bytes,
                    rows * (n // 2) * stages)


def k4_bound(M: int, K: int, N: int, word_bytes: int = WORD_BYTES):
    return bound_ms((M * K + K * N + M * N) * word_bytes, M * K * N)


def k5_bound(d: int, n: int, word_bytes: int = WORD_BYTES):
    """One fold_round: read d n Fp4 words and c, write d n/2 folded words
    and g; (d + 1)(d - 1) + d Fp4 products per pair."""
    half = n // 2
    words = d * n * 4 + 4 + d * half * 4 + (d + 1) * 4
    return bound_ms(words * word_bytes, half * ((d + 1) * (d - 1) + d) * F4_MULS)


# K5 at the shapes time_k5 times: (d, n, what).  The first is the timed
# shape of the kernels line.
K5_SHAPES = ((2, 1 << 19, "the d=128 weight-commitment opening's claim"),
             (3, 1 << 17, "d = 3"),
             (2, 16, "the analysis's shape"),
             (2, 1 << 27, "the TinyLlama-width weight opening's claim"))
K5_PLAIN_CHUNK = 1 << 22       # pairs per plain call at 2^27
L2_FLUSH_BYTES = 256 << 20     # read between launches for the cold-L2 time


def k5_inputs(dev, gen, d: int, n: int):
    """d factors (n, 4) and c, made on the card, edge words planted."""
    import torch
    g = torch.Generator(device=dev).manual_seed(int(gen.integers(1 << 31)))
    fs = []
    for _ in range(d):
        x = torch.randint(0, P, (n, 4), generator=g, device=dev)
        x.view(-1)[:len(EDGE_WORDS)] = torch.tensor(EDGE_WORDS, device=dev)
        fs.append(x)
    return fs, torch.randint(0, P, (4,), generator=g, device=dev)


def k5_err(fs, c, g, folded) -> int:
    """Max abs err of one fold_round's (g, folded) against the plain version
    on the same inputs: in one call, or over chunks of K5_PLAIN_CHUNK pairs
    (the halves of each chunk as a claim of their own, g summed mod P) when
    the whole would not fit on the card beside its inputs."""
    import torch
    from repro_torch.kernels import sumcheck_fold as K5
    half = fs[0].shape[0] // 2
    if half <= K5_PLAIN_CHUNK:
        pg, pf = K5.fold_round_plain(fs, c)
        return max([max_abs_err(g, pg)] + [max_abs_err(a, b) for a, b in zip(folded, pf)])
    err, gsum = 0, torch.zeros_like(g)
    for a in range(0, half, K5_PLAIN_CHUNK):
        b = a + K5_PLAIN_CHUNK
        sub = [torch.cat([f[a:b], f[half + a:half + b]]) for f in fs]
        pg, pf = K5.fold_round_plain(sub, c)
        gsum = (gsum + pg) % P
        err = max([err] + [max_abs_err(x[a:b], y) for x, y in zip(folded, pf)])
        del sub, pf
    return max(err, max_abs_err(g, gsum))


def time_k5(dev, gen):
    """K5 at K5_SHAPES through ``fold_round`` (so an older checkout's
    kernel is timed too when its ``src`` is first on ``sys.path``):
    CUDA-event ms per call (warm: the same inputs again), device ms per
    call and device operations per call (torch.profiler), cold-L2 device
    ms (a 256 MB read between launches), the wrapper's host us per call,
    launches per call, the bound (u32 words) and the int64-byte floor, the
    plain version's ms up to 2^19, and the max abs err against the plain
    version (any difference fails)."""
    import torch
    from repro_torch.kernels import sumcheck_fold as K5
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev).fill_(1)
    out = []
    for d, n, what in K5_SHAPES:
        fs, c = k5_inputs(dev, gen, d, n)
        fn = (lambda fs=fs, c=c: K5.fold_round(fs, c))
        iters = 5 if n > 1 << 24 else 200 if n <= 1 << 10 else 50
        before = K5.launches
        g, folded = fn()
        launches = K5.launches - before
        err = k5_err(fs, c, g, folded)
        name = f"fold_round d={d} n={n} ({what})"
        if err != 0:
            fail("kernels", f"K5 {name}: kernel != plain (max abs err {err})")
        del g, folded
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_us = (time.perf_counter() - t0) / iters * 1e6
        ms = gpu_ms(fn, iters)

        def warm():
            for _ in range(iters):
                fn()

        def cold():
            for _ in range(iters):
                flush.sum()
                fn()
        _, prof = profiled_call(warm, match=("(anonymous namespace)::",))
        kern, seen = prof["match"]["(anonymous namespace)::"]
        _, cprof = profiled_call(cold, match=("(anonymous namespace)::",))
        ckern, cseen = cprof["match"]["(anonymous namespace)::"]
        bnd, by = k5_bound(d, n)
        out.append(dict(
            shape=name, d=d, n=n, ms=ms,
            device_ms=kern / seen * launches if seen else None,
            cold_ms=ckern / cseen * launches if cseen else None,
            host_us=host_us, launches=launches,
            device_ops=sum(t["count"] for t in prof["top"]) / iters,
            kernel_events_seen=seen / (iters * launches),
            bound_ms=bnd, bound_by=by, int64_floor_ms=k5_bound(d, n, INT64_BYTES)[0],
            plain_ms=(gpu_ms(lambda fs=fs, c=c: K5.fold_round_plain(fs, c), 1)
                      if n <= 1 << 19 else None),
            max_abs_err=err))
        del fs, c, fn
        torch.cuda.empty_cache()
    return out


def time_k2k4(dev, gen):
    """K2's RS encode and K4 at the shapes one attest launches them (and
    the weight shape of the setup), K2's plain transform at the weight
    codeword length, and an encode at blowup 8 (an instance that reads its
    shape at run time): device ms per call (torch.profiler, the
    K2/K4 kernels apart from every other kernel of the call, e.g. a pad),
    CUDA-event ms per call over >= 20 calls, the wrapper's host microseconds
    per call, launches per call, the bound (u32 words) and the int64-byte
    floor.  The profiler may drop kernel events, so the kernel's device ms
    is its mean over the launches seen, times the launches per call, and
    the share seen is reported.  Uses only ``pcs._rs_encode(rows, blowup)``,
    ``K2.ntt_rows(x)`` and ``K4.modmatmul(a, b)``, so it times an older
    checkout's kernels too when that checkout's ``src`` is first on
    ``sys.path``."""
    import torch
    from repro_torch.core import pcs as PCS
    from repro_torch.kernels import modmatmul as K4
    from repro_torch.kernels import ntt_kernel as K2
    cases = []
    for (r, n, c), what in (((1024, 4096, 1024), "LogUp helper, attest"),
                            ((256, 2048, 512), "aux witness, attest"),
                            ((512, 4096, 1024), "weights, setup")):
        msg = rand_words(gen, (r, c), dev)
        cases.append((f"K2 encode {r}x{c} -> {r}x{n} ({what})", K2, "ntt_kernel",
                      (lambda msg=msg, b=n // c: PCS._rs_encode(msg, b)), 20,
                      k2_bound(r, n, c), k2_bound(r, n, c, INT64_BYTES)[0]))
    x = rand_words(gen, (512, 4096), dev)
    cases.append(("K2 ntt_rows 512x4096 (plain transform)", K2, "ntt_kernel",
                  lambda: K2.ntt_rows(x), 20, k2_bound(512, 4096, 4096),
                  k2_bound(512, 4096, 4096, INT64_BYTES)[0]))
    msg8 = rand_words(gen, (1024, 512), dev)
    cases.append(("K2 encode 1024x512 -> 1024x4096 (blowup 8)", K2, "ntt_kernel",
                  lambda: PCS._rs_encode(msg8, 8), 20, k2_bound(1024, 4096, 512),
                  k2_bound(1024, 4096, 512, INT64_BYTES)[0]))
    for (M, K, N), what in (((4, 512, 1024), "weights, attest"),
                            ((4, 1024, 1024), "LogUp helper, attest"),
                            ((4, 256, 512), "aux witness, attest")):
        a, b = rand_words(gen, (M, K), dev), rand_words(gen, (K, N), dev)
        cases.append((f"K4 {M}x{K} @ {K}x{N} ({what})", K4, "modmatmul",
                      (lambda a=a, b=b: K4.modmatmul(a, b)), 50,
                      k4_bound(M, K, N), k4_bound(M, K, N, INT64_BYTES)[0]))
    out = []
    for name, mod, kname, fn, iters, (bnd, by), floor64 in cases:
        fn()
        torch.cuda.synchronize()
        before = mod.launches
        fn()
        launches = mod.launches - before
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_us = (time.perf_counter() - t0) / iters * 1e6
        torch.cuda.synchronize()
        ms = gpu_ms(fn, iters)
        _, prof = profiled_call(lambda: [fn() for _ in range(iters)],
                                match=(kname,))
        busy = prof["device_busy_ms"]
        kern, seen = prof["match"][kname]
        out.append(dict(
            shape=name, ms=ms, device_ms=busy / iters if busy else None,
            kernel_device_ms=kern / seen * launches if seen else None,
            kernel_events_seen=seen / (iters * launches),
            other_device_ms=(busy - kern) / iters if busy else None,
            host_us=host_us, launches=launches, bound_ms=bnd, bound_by=by,
            int64_floor_ms=floor64,
            kernels=[dict(name=t["name"], ms=t["ms"] / iters, count=t["count"] / iters)
                     for t in prof["top"][:4]]))
    return out


# K2's long rows as the llama path gives them (rows, n, c): the weight
# commitment's encode at setup, the setup's LogUp helper, the verifier's Fp4
# opening row (4 coefficient rows); then the shapes timed against the plain
# version, which at full size would need tens of GiB.
K2_LONG_PATH = (((8192, 1 << 16, 1 << 14), "llama weights, setup"),
                ((16384, 1 << 17, 1 << 15), "llama LogUp helper, setup"),
                ((4, 1 << 16, 1 << 14), "llama verifier's Fp4 row"))
K2_LONG_TIMED = (((512, 1 << 17, 1 << 15), "helper rows, 512 of them"),
                 ((512, 1 << 16, 1 << 14), "weight rows, 512 of them"),
                 ((512, 1 << 16, 1 << 16), "plain transform"))


def time_k2_long(dev, gen):
    """K2's two-launch path for rows longer than 2^15 words: CUDA-event ms
    per call (>= 3 calls), launches per call, the bound (u32 words) and the
    int64-byte floor at the llama path's shapes; at the timed shapes (512
    rows: both launches' loops over rows take several turns) also the plain
    version's ms on the same inputs, and its output against the kernel's,
    edge words planted: any difference fails."""
    import torch
    from repro_torch.kernels import ntt_kernel as K2
    out = []
    g = torch.Generator(device=dev).manual_seed(int(gen.integers(1 << 31)))
    for (r, n, c), what in K2_LONG_PATH + K2_LONG_TIMED:
        x = torch.randint(0, P, (r, c), generator=g, device=dev)
        x.view(-1)[:len(EDGE_WORDS)] = torch.tensor(EDGE_WORDS, device=dev)
        if c < n:
            fn = (lambda x=x, b=n // c: K2.rs_encode_rows(x, b))
            plain = (lambda x=x, b=n // c: K2.rs_encode_rows_plain(x, b))
        else:
            fn, plain = (lambda x=x: K2.ntt_rows(x)), (lambda x=x: K2.ntt_rows_plain(x))
        before = K2.launches
        got = fn()
        launches = K2.launches - before
        bnd, by = k2_bound(r, n, c)
        name = f"{'encode' if c < n else 'ntt_rows'} {r}x{c} -> {r}x{n} ({what})"
        rec = dict(shape=name, rows=r, n=n, c=c,
                   ms=gpu_ms(fn, 5 if r * n <= 1 << 28 else 3),
                   launches=launches, bound_ms=bnd, bound_by=by,
                   int64_floor_ms=k2_bound(r, n, c, INT64_BYTES)[0])
        if ((r, n, c), what) in K2_LONG_TIMED:
            rec["plain_ms"] = gpu_ms(plain, 1)
            rec["max_abs_err"] = max_abs_err(got, plain())
            if rec["max_abs_err"] != 0:
                fail("k2long", f"{name}: kernel != plain "
                     f"(max abs err {rec['max_abs_err']})")
        out.append(rec)
        del x, got
        torch.cuda.empty_cache()
    return out


def golden_pcs_long(dev):
    """The long-row PCS opening at one point on the card against the JAX
    package's (tests/data/golden_pcs_long.npz): commit the 2^16-word vector
    at aspect -6 (codeword rows of 2^16 words: K2's two-launch path) and
    open it at one point from a fresh transcript; the root, ``us``,
    ``u_prox``, the columns, the Merkle paths and the transcript's state
    must equal the golden word for word, and the card's verifier must
    accept the golden bundle at its value.  Launches per kernel over the
    commit and the opening."""
    import numpy as np
    from repro_torch.core import field as F
    from repro_torch.core import pcs as PCS
    from repro_torch.core.merkle import MerklePath
    from repro_torch.core.transcript import Transcript
    g = GOLDEN_PCS_LONG
    gold = dict(np.load(os.path.join(DATA, "golden_pcs_long.npz")))

    def words(seed, shape):
        a = np.random.default_rng(seed).integers(0, P, size=shape,
                                                 dtype=np.int64)
        a.reshape(-1)[:len(EDGE_WORDS)] = EDGE_WORDS
        return a.astype(np.uint32)
    params = PCS.PCSParams()
    reset_counts()
    t0 = time.monotonic()
    com = PCS.commit(F.tensor(words(g["vec_seed"], (g["words"],)), dev),
                     params, aspect=g["aspect"])
    point = words(g["point_seed"], (com.log_r + com.log_c, 4))
    tr = Transcript(g["label"], dev)
    bundle = PCS.prove_openings(com, [F.tensor(point, dev)], tr, params)
    seconds = time.monotonic() - t0
    launches = launch_counts()
    got = dict(root=np.asarray(com.root), us=np.asarray(bundle.us),
               u_prox=np.asarray(bundle.u_prox),
               columns=np.asarray(bundle.columns),
               path_index=np.asarray([p.index for p in bundle.paths]),
               path_siblings=np.stack([np.asarray(p.siblings)
                                       for p in bundle.paths]),
               state=F.to_np(tr.state))
    differ = [k for k, v in got.items()
              if v.shape != gold[k].shape or not np.array_equal(v, gold[k])]
    if differ:
        fail("k2long", f"1-point long-row opening differs from "
             f"golden_pcs_long.npz in {differ}")
    if launches["ntt_long_rows"] == 0:
        fail("k2long", "the long-row commit launched no long-row K2")
    golden = PCS.OpeningBundle(
        us=gold["us"], u_prox=gold["u_prox"], columns=gold["columns"],
        paths=[MerklePath(int(i), sib) for i, sib in
               zip(gold["path_index"], gold["path_siblings"])])
    vt = Transcript(g["label"], dev)
    if not PCS.verify_openings(gold["root"], com.log_r, com.log_c,
                               [F.tensor(point, dev)],
                               [F.tensor(gold["value"], dev)], golden, vt,
                               params) or \
            not np.array_equal(F.to_np(vt.state), gold["state"]):
        fail("k2long", "the card's verifier rejected golden_pcs_long.npz")
    return dict(words=g["words"], rows=1 << com.log_r, row_words=1 << com.log_c,
                codeword_words=int(com.enc.shape[1]), seconds=seconds,
                launches=launches, equal=sorted(got))


def time_k1k3(dev, gen):
    """K1 and K3 at the main path's dominant shapes: CUDA-event ms per call,
    device ms per call (torch.profiler), launches per call, bound.  Uses only
    the wrappers' public signatures, so it times an older checkout's
    kernels too when that checkout's ``src`` is first on ``sys.path``."""
    from repro_torch.kernels import poseidon2_kernel as K1
    from repro_torch.kernels import sumcheck_round as K3
    st1 = rand_words(gen, (1, 16), dev)
    e4096 = rand_words(gen, (1, 4096), dev)
    e4 = rand_words(gen, (1, 4), dev)
    leaves = rand_words(gen, (4096, 512), dev)
    cases = [
        ("K1 sponge 1x4096 (one-row transcript absorb)", 20,
         lambda: K1.sponge(st1, e4096, 4096), 512,
         bound_ms((16 + 4096 + 16) * WORD_BYTES, 512 * PERM_MULS)),
        ("K1 sponge 1x4 (one-row transcript absorb)", 200,
         lambda: K1.sponge(st1, e4, 4), 1,
         bound_ms((16 + 4 + 16) * WORD_BYTES, PERM_MULS)),
        ("K1 hash_rows 4096x512 (weight-commitment leaves)", 20,
         lambda: K1.hash_rows(leaves), 64,
         bound_ms((4096 * 512 + 4096 * 8) * WORD_BYTES, 4096 * 64 * PERM_MULS)),
    ]
    for d, n, iters in ((2, 1024, 50), (3, 1024, 50), (2, 1 << 19, 20)):
        fs = [rand_words(gen, (1, n, 4), dev) for _ in range(d)]
        st = rand_words(gen, (1, 16), dev)
        cases.append((f"K3 prove_rounds d={d} K=1 n={n}", iters,
                      (lambda fs=fs, st=st: K3.prove_rounds(fs, st)), None,
                      k3_bound(d, n)))
    out = []
    for name, iters, fn, perms, (bnd, by) in cases:
        fn()
        before = (K1.launches, K3.launches)
        fn()
        launches = dict(K1=K1.launches - before[0], K3=K3.launches - before[1])
        ms = gpu_ms(fn, iters)
        _, prof = profiled_call(lambda: [fn() for _ in range(iters)])
        dev_ms = prof["device_busy_ms"] / iters if prof["device_busy_ms"] else None
        r = dict(shape=name, ms=ms, device_ms=dev_ms, launches=launches,
                 bound_ms=bnd, bound_by=by)
        if perms:
            r["serial_perms"] = perms
            r["us_per_serial_perm"] = ms * 1e3 / perms
            r["device_us_per_serial_perm"] = dev_ms * 1e3 / perms if dev_ms else None
        out.append(r)
    return out


# ---------------------------------------------------------------------------
# Phase 4: the golden toy on the card.
# ---------------------------------------------------------------------------
def golden_phase(dev, phase="golden", fields=GOLDEN_CFG,
                 seeds=(GOLDEN_WEIGHT_SEED, GOLDEN_QUERY_SEED),
                 prefix="golden", name="golden-model"):
    """Attest a golden toy on the card: its card and v1/v2 bytes must equal
    tests/data/<prefix>_{card,v1,v2}.bin; the port's verifier accepts both
    and rejects a flipped byte."""
    import numpy as np
    from repro_torch import api
    from repro_torch.core import blocks as B
    cfg = B.BlockCfg(**fields)
    weights = [B.init_weights(cfg, np.random.default_rng(seeds[0]))]
    qrng = np.random.default_rng(seeds[1])
    query = np.clip(np.round(qrng.normal(0, 0.5, (cfg.d_pad, cfg.seq)) * 256),
                    -32768, 32767).astype(np.int64)
    gold = {}
    for v in ("card", "v1", "v2"):
        with open(os.path.join(DATA, f"{prefix}_{v}.bin"), "rb") as fh:
            gold[v] = fh.read()
    policy = api.VerifyPolicy(pcs_queries=1)
    t0 = time.monotonic()
    with api.ProofService([cfg], weights, default_queries=1, workers=1,
                          name=name, device=dev) as svc:
        card = svc.model_card.to_bytes()
        att = svc.attest(query, policy, tokens=np.arange(3, dtype=np.int32))
    prove_s = time.monotonic() - t0
    if card != gold["card"]:
        fail(phase, f"ModelCard bytes differ from {prefix}_card.bin")
    att.prove_seconds = api.Attestation.from_bytes(gold["v1"]).prove_seconds
    att.__dict__.pop("_wire_cache", None)
    if att.to_bytes(1) != gold["v1"] or att.to_bytes(2) != gold["v2"]:
        fail(phase, f"attestation bytes differ from {prefix}_v1/v2.bin")
    for v in ("v1", "v2"):
        rep = api.verify(gold[v], query, card, policy, device=dev)
        if not rep.ok:
            fail(phase, f"verify rejected {prefix} {v}: {rep.reason}")
        flipped = bytearray(gold[v])
        flipped[len(flipped) // 2] ^= 0x01
        if api.verify(bytes(flipped), query, card, policy, device=dev).ok:
            fail(phase, f"verify accepted a flipped {prefix} {v}")
    return dict(prove_seconds=prove_s, v1_bytes=len(gold["v1"]),
                v2_bytes=len(gold["v2"]))


# ---------------------------------------------------------------------------
# Phase 5: serve 3 verified attestations at full width.
# ---------------------------------------------------------------------------
def serve_service(dev, workers=1, **kw):
    """The served ProofService: a 4-layer d=128 chain, weights from SEED
    (``kw``: backend, weight_cache)."""
    import numpy as np
    from repro_torch import api
    from repro_torch.core import blocks as B
    cfg = B.BlockCfg(**SERVE_CFG)
    rng = np.random.default_rng(SEED)
    weights = [B.init_weights(cfg, rng) for _ in range(SERVE_LAYERS)]
    return api.ProofService([cfg] * SERVE_LAYERS, weights,
                            pcs_blowup=PCS_BLOWUP, default_queries=PCS_QUERIES,
                            workers=workers, name="chip-smoke", device=dev,
                            **kw)


def canonical_v2(att) -> bytes:
    """v2 bytes with ``prove_seconds``, the one telemetry field, set to 0."""
    att.prove_seconds = 0.0
    att.__dict__.pop("_wire_cache", None)
    return att.to_bytes(2)


def serve_query(q: int):
    """Request q's query (seeded), shaped for SERVE_CFG."""
    import numpy as np
    from repro_torch.core import blocks as B
    cfg = B.BlockCfg(**SERVE_CFG)
    qrng = np.random.default_rng(SEED + 1 + q)
    return np.clip(np.round(qrng.normal(0, 0.5, (cfg.d_pad, cfg.seq)) * 256),
                   -32768, 32767).astype(np.int64)


def serve_phase(dev, cache, twins):
    """The last request's attest runs under torch.profiler (its time then
    includes the profiler's cost; it is flagged ``profiled``); its K2 and K4
    calls are counted by shape, and its K2/K4 kernels' device ms read from
    the trace.  Each request's canonical v2 bytes, seconds and K3
    launches go to ``twins`` (the serial twins of later phases); the weight
    commitments stay in ``cache``."""
    from repro_torch import api
    from repro_torch.kernels import modmatmul as K4
    from repro_torch.kernels import ntt_kernel as K2
    policy = api.VerifyPolicy(pcs_queries=PCS_QUERIES)
    out = dict(config=SERVE_CFG, layers=SERVE_LAYERS, pcs_blowup=PCS_BLOWUP,
               pcs_queries=PCS_QUERIES, requests=[])
    with serve_service(dev, weight_cache=cache) as svc:
        t0 = time.monotonic()
        card = svc.model_card.to_bytes()
        out["setup_seconds"] = time.monotonic() - t0
        for q in range(SERVE_QUERIES):
            x = serve_query(q)
            profiled = q == SERVE_QUERIES - 1
            before = launch_counts()
            t0 = time.monotonic()
            if profiled:
                K2.launch_shapes.clear()
                K4.launch_shapes.clear()
                att, out["profile"] = profiled_call(
                    svc.attest, x, policy,
                    match=("ntt_kernel", "modmatmul_kernel"))
                out["attest_shapes"] = dict(
                    K2=sorted([*k, v] for k, v in K2.launch_shapes.items()),
                    K4=sorted([*k, v] for k, v in K4.launch_shapes.items()))
            elif q == 0:
                att, e_vec_calls = recorded_e_vec_calls(svc.attest, x, policy)
            else:
                att = svc.attest(x, policy)
            wire = att.to_bytes(2)
            t_att = time.monotonic() - t0
            after = launch_counts()
            rep = api.verify(wire, x, card, policy, device=dev)
            if not rep.ok:
                fail("serve", f"request {q}: verify rejected: {rep.reason}")
            r = svc.last_report
            twins.append(dict(wire=canonical_v2(att), seconds=t_att,
                              profiled=profiled,
                              k3=after["sumcheck_round"] - before["sumcheck_round"]))
            out["requests"].append(dict(
                seconds=t_att, forward_seconds=r.forward_seconds,
                commit_seconds=r.commit_seconds,
                prove_seconds=r.prove_seconds,
                verify_seconds=rep.verify_seconds, wire_bytes=len(wire),
                checked_layers=rep.checked_layers, profiled=profiled,
                attest_launches={k: after[k] - before[k] for k in after}))
    # the shapes time_k2k4 times must be the ones the attest launched
    for k, want in (("K2", ATTEST_K2), ("K4", ATTEST_K4)):
        got = {tuple(e[:3]): e[3] for e in out["attest_shapes"][k]}
        if got != want:
            fail("serve", f"{k} calls of one attest {got} != {want}")
    out["e_vec"] = time_e_vec(e_vec_calls)
    out["default_workers"] = default_worker_attests(dev, cache, twins)
    out["golden_d128"] = golden_d128(dev)
    plain = sorted(r["seconds"] for r in out["requests"] if not r["profiled"])
    if plain and out["profile"]["device_busy_ms"] is not None:
        # device busy time of the traced attest over the median untraced one
        out["profile"]["busy_share_of_untraced_request"] = (
            out["profile"]["device_busy_ms"] / 1e3 / plain[len(plain) // 2])
    return out


def golden_d128(dev):
    """The served chain's first layer (a one-layer service from SEED's
    first weight draw) attests serve_query(0) once on the card: its
    canonical v2 bytes must equal tests/data/golden_d128_v2.bin and its
    ModelCard golden_d128_card.bin (the JAX package's, from
    tests/data/gen_golden_d128.py); the card's verifier must accept the
    golden and reject it with one byte flipped."""
    import numpy as np
    from repro_torch import api
    from repro_torch.core import blocks as B
    gold = {}
    for k in ("v2", "card"):
        with open(os.path.join(DATA, f"golden_d128_{k}.bin"), "rb") as fh:
            gold[k] = fh.read()
    cfg = B.BlockCfg(**SERVE_CFG)
    weights = [B.init_weights(cfg, np.random.default_rng(SEED))]
    policy = api.VerifyPolicy(pcs_queries=PCS_QUERIES)
    x = serve_query(0)
    t0 = time.monotonic()
    with api.ProofService([cfg], weights, pcs_blowup=PCS_BLOWUP,
                          default_queries=PCS_QUERIES, workers=1,
                          name="chip-smoke", device=dev) as svc:
        card = svc.model_card.to_bytes()
        setup_s = time.monotonic() - t0
        t0 = time.monotonic()
        att = svc.attest(x, policy)
        attest_s = time.monotonic() - t0
    if card != gold["card"]:
        fail("serve", "d=128 ModelCard bytes differ from golden_d128_card.bin")
    wire = canonical_v2(att)
    if wire != gold["v2"]:
        first = next((i for i, (a, b) in enumerate(zip(wire, gold["v2"]))
                      if a != b), min(len(wire), len(gold["v2"])))
        fail("serve", f"d=128 attestation ({len(wire)} B) differs from "
             f"golden_d128_v2.bin ({len(gold['v2'])} B) from byte {first}")
    t0 = time.monotonic()
    rep = api.verify(gold["v2"], x, card, policy, device=dev)
    verify_s = time.monotonic() - t0
    if not rep.ok:
        fail("serve", f"verify rejected golden_d128_v2.bin: {rep.reason}")
    flipped = bytearray(gold["v2"])
    flipped[len(flipped) // 2] ^= 0x01
    if api.verify(bytes(flipped), x, card, policy, device=dev).ok:
        fail("serve", "verify accepted a flipped golden_d128_v2.bin")
    return dict(layers=1, setup_seconds=setup_s, attest_seconds=attest_s,
                verify_seconds=verify_s, v2_bytes=len(wire),
                bytes_equal=True, card_equal=True)


def batcher_waits(r) -> dict:
    """The round batcher's counters from an EngineReport: its flushes, and
    the seconds its claims waited for them (gather), the straggler
    timeout's flushes apart, and the seconds in its K3 calls and reads."""
    return dict(batched_claims=r.batched_claims, launch_waves=r.launch_waves,
                claims=sum(n * k for (_, _, k), n in r.wave_shapes.items()),
                flushes=r.flushes, timeout_flushes=r.timeout_flushes,
                gather_seconds=r.gather_seconds,
                timeout_gather_seconds=r.timeout_gather_seconds,
                flush_seconds=r.flush_seconds)


def default_worker_attests(dev, cache, twins):
    """DEFAULT_WORKER_ATTESTS of the serve phase's queries, one attest each
    at ProofService's default worker count: bytes equal to the serial
    twins, seconds beside theirs, the batcher's counters and waits."""
    from repro_torch import api
    workers = inspect.signature(api.ProofService).parameters["workers"].default
    policy = api.VerifyPolicy(pcs_queries=PCS_QUERIES)
    out = dict(workers=workers, requests=[])
    with serve_service(dev, workers=workers, weight_cache=cache) as svc:
        for q in range(DEFAULT_WORKER_ATTESTS):
            t0 = time.monotonic()
            att = svc.attest(serve_query(q), policy)
            seconds = time.monotonic() - t0
            if canonical_v2(att) != twins[q]["wire"]:
                fail("serve", f"request {q} at {workers} workers: bytes differ "
                     "from the serial attest")
            r = svc.last_report
            out["requests"].append(dict(
                query=q, seconds=seconds, serial_seconds=twins[q]["seconds"],
                forward_seconds=r.forward_seconds,
                commit_seconds=r.commit_seconds,
                prove_seconds=r.prove_seconds, **batcher_waits(r)))
    return out


def recorded_e_vec_calls(fn, *args):
    """fn(*args), and the arguments of every ``pcs._build_e_vec`` call it
    made."""
    from repro_torch.core import pcs as PCS
    calls, build = [], PCS._build_e_vec

    def record(*a):
        calls.append(a)
        return build(*a)
    PCS._build_e_vec = record
    try:
        return fn(*args), calls
    finally:
        PCS._build_e_vec = build


def time_e_vec(calls):
    """Wall ms of one attest's eq-vector builds (``pcs._build_e_vec``),
    replayed as the attest makes them (eq tables batched per bucket) and
    with every table taken one at a time in place (the path past
    E_VEC_BATCH words), in turns batched / one at a time / one at a time /
    batched; the two must give the same words."""
    import torch
    from repro_torch.core import pcs as PCS
    batch = PCS.E_VEC_BATCH

    def run(limit):
        PCS.E_VEC_BATCH = limit
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = [PCS._build_e_vec(*a) for a in calls]
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3, res
        finally:
            PCS.E_VEC_BATCH = batch
    run(batch)
    times = {"batched": [], "one_table_at_a_time": []}
    for limit, key in ((batch, "batched"), (0, "one_table_at_a_time"),
                       (0, "one_table_at_a_time"), (batch, "batched")):
        ms, res = run(limit)
        times[key].append(ms)
        if key == "batched":
            want = res
        elif not all(torch.equal(a, b) for a, b in zip(res, want)):
            fail("serve", "eq vector one table at a time != batched")
    return dict(calls=len(calls), tables=sum(len(a[1]) for a in calls),
                ms=times)


# ---------------------------------------------------------------------------
# Phase 6: the soundness analysis on the card, and a recorded full-width
# attestation linted.
# ---------------------------------------------------------------------------
def analysis_phase(dev):
    from repro_torch import api
    from repro_torch.analysis import fs_lint, tape_lint
    from repro_torch.analysis.__main__ import main as analysis_main
    from repro_torch.analysis.replay import ReplayLog, recording
    out = {}
    t0 = time.monotonic()
    rc = analysis_main(["--all", "--mutants", "--device", dev.type])
    out["analysis_seconds"] = time.monotonic() - t0
    if rc != 0:
        fail("analysis", f"python -m repro_torch.analysis exited {rc}")
    log = ReplayLog()
    t0 = time.monotonic()
    with serve_service(dev) as svc, recording(log):
        svc.attest(serve_query(SERVE_QUERIES),
                   api.VerifyPolicy(pcs_queries=PCS_QUERIES))
    out["replay_attest_seconds"] = time.monotonic() - t0
    t0 = time.monotonic()
    findings = fs_lint.replay_checks(log) + tape_lint.replay_checks(log)
    out["replay_lint_seconds"] = time.monotonic() - t0
    out["replay_events"] = len(log.events)
    # fs_lint sums the union bound k n / (4P) of every index sample of a
    # prove against a ceiling sized for the golden prove (BIAS_TOTAL_MAX,
    # the JAX package's constant); a full-width prove exceeds it by
    # construction, in both packages.  It is reported here, not failed on.
    # The per-index bias n / (4P) that the soundness budget charges is
    # checked per call and fails this phase like every other finding.
    tripwire = [f for f in findings
                if (f.category, f.where) == ("index-bias", "golden-prove")]
    out["golden_sized_bias_tripwire"] = [f.detail for f in tripwire]
    findings = [f for f in findings if f not in tripwire]
    if findings:
        fail("analysis", "full-width replay: "
             + "; ".join(str(f) for f in findings[:10]))
    return out


# ---------------------------------------------------------------------------
# Phase 7: the llama family at TinyLlama-1.1B width, Fisher-guided.
# ---------------------------------------------------------------------------
def llama_query(q: int):
    """Request q's query (seeded), shaped for LLAMA_CFG."""
    import numpy as np
    from repro_torch.core import blocks as B
    cfg = B.BlockCfg(**LLAMA_CFG)
    qrng = np.random.default_rng(SEED + 100 + q)
    return np.clip(np.round(qrng.normal(0, 0.5, (cfg.d_pad, cfg.seq)) * 256),
                   -32768, 32767).astype(np.int64)


def llama_fisher(weights, device):
    """Fisher scores of the served layers from ``fisher_from_logprob_fn``:
    a small float64 function of each layer's dequantized weights (RMS norm,
    the q and o projections, the SiLU-gated MLP, residuals; a seeded
    readout to LLAMA_VOCAB classes) on the dequantized query of request 0,
    labels drawn from its own distribution with a seeded CPU generator.
    Returns (scores, seconds)."""
    import numpy as np
    import torch
    from repro_torch.core import fisher as FI
    d = weights[0]["wqT"].shape[1]
    params = [{k: torch.as_tensor(w[k], dtype=torch.float64, device=device) / 256
               for k in ("wqT", "woT", "w1T", "w3T", "w2T")} for w in weights]
    rng = np.random.default_rng(SEED + 200)
    readout = torch.as_tensor(rng.normal(0, 1 / np.sqrt(d), (d, LLAMA_VOCAB)),
                              device=device)
    x = torch.as_tensor(llama_query(0).T / 256.0, device=device)      # (seq, d)

    def rms(h):
        return h * torch.rsqrt((h * h).mean(-1, keepdim=True) + 1e-6)

    def logprob(ps, h, generator):
        for p in ps:
            h = h + (rms(h) @ p["wqT"].T) @ p["woT"].T
            n = rms(h)
            h = h + (torch.nn.functional.silu(n @ p["w1T"].T)
                     * (n @ p["w3T"].T)) @ p["w2T"].T
        lp = torch.log_softmax(h @ readout, dim=-1)
        y = torch.multinomial(lp.detach().exp().cpu(), 1, generator=generator)
        y = y[:, 0].to(lp.device)
        return lp[torch.arange(lp.shape[0], device=lp.device), y].mean()

    t0 = time.monotonic()
    scores = FI.fisher_from_logprob_fn(logprob, params, x,
                                       torch.Generator().manual_seed(SEED),
                                       n_samples=2)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return scores, time.monotonic() - t0


class MemoryStages:
    """While active, wraps prover functions so each call records the device
    memory allocated when it starts and the allocator's peak before and
    when it ends.  The stage that set the peak is the first call to end
    (the innermost, when calls nest) whose end peak is the final one and
    above its start peak."""

    def __init__(self, dev):
        from repro_torch.core import field as F
        from repro_torch.core import pcs as PCS
        from repro_torch.core import sumcheck as SC
        self.dev, self.events, self._saved = dev, [], []
        self.targets = [
            ("commit", PCS, "commit", lambda vec, *a, **k: vec.shape[0]),
            ("Fp4 inverse", F, "f4inv", lambda a: a.shape[0] if a.ndim > 1 else 1),
            ("eq vector", PCS, "_build_e_vec", lambda n, *a, **k: n),
            ("sum-check (K3 + scratch)", SC, "prove",
             lambda fs, *a, **k: fs[0].shape[0]),
            ("open columns", PCS, "_open_columns",
             lambda com, *a, **k: com.mat.numel())]

    def __enter__(self):
        import torch
        for label, mod, attr, size in self.targets:
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))

            def wrapped(*a, _fn=fn, _label=label, _size=size, **k):
                n = _size(*a, **k)
                alloc = torch.cuda.memory_allocated(self.dev)
                peak_in = torch.cuda.max_memory_allocated(self.dev)
                r = _fn(*a, **k)
                self.events.append((_label, n, alloc, peak_in,
                                    torch.cuda.max_memory_allocated(self.dev)))
                return r
            setattr(mod, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved.clear()

    def summary(self):
        """{stage at 2^m words: calls, GiB allocated at the start (max), the
        peak at the end (max)}, and the stage that set the peak."""
        gib = 1 << 30
        stages = {}
        for label, n, alloc, _, peak in self.events:
            key = f"{label} at 2^{n.bit_length() - 1}"
            st = stages.setdefault(key, dict(calls=0, start_gib=0.0, peak_gib=0.0))
            st["calls"] += 1
            st["start_gib"] = max(st["start_gib"], alloc / gib)
            st["peak_gib"] = max(st["peak_gib"], peak / gib)
        top = max((e[4] for e in self.events), default=0)
        setter = next((f"{e[0]} at 2^{e[1].bit_length() - 1}" for e in self.events
                       if e[4] == top and e[4] > e[3]), None)
        return dict(stages=stages, peak_set_by=setter)


def _shape_delta(after, before):
    return sorted([*k, v - before.get(k, 0)] for k, v in after.items()
                  if v != before.get(k, 0))


def llama_phase(dev, cache, twins):
    """Setup, 2 attests at budget 1.0 and a Fisher-selected one at 0.5 on
    the 2-layer TinyLlama-width chain, each verified on the card.  The
    weight commitments stay in ``cache`` and the budget-1.0 attests'
    canonical v2 bytes go to ``twins``, for llama_batch.  Returns (the
    phase's record, the weights)."""
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.core import blocks as B
    from repro_torch.core import fisher as FI
    from repro_torch.kernels import modmatmul as K4
    from repro_torch.kernels import ntt_kernel as K2
    cfg = B.BlockCfg(**LLAMA_CFG)
    out = dict(config=LLAMA_CFG, layers=LLAMA_LAYERS,
               depth_cut=f"{LLAMA_LAYERS} of {LLAMA_FULL_LAYERS} layers",
               pcs_blowup=PCS_BLOWUP, pcs_queries=PCS_QUERIES, requests=[])
    start = time.monotonic()
    # the llama golden toy first: the card's llama path, byte for byte
    out["golden_llama"] = golden_phase(
        dev, "llama", GOLDEN_LLAMA_CFG,
        (GOLDEN_LLAMA_WEIGHT_SEED, GOLDEN_LLAMA_QUERY_SEED), "golden_llama",
        "golden-llama")
    progress("llama", "llama golden bytes equal", start)
    t0 = time.monotonic()
    rng = np.random.default_rng(SEED + 10)
    weights = [B.init_weights(cfg, rng) for _ in range(LLAMA_LAYERS)]
    out["weights_seconds"] = time.monotonic() - t0
    progress("llama", "weights made", start)
    scores, fisher_s = llama_fisher(weights, dev)
    cpu_scores, cpu_s = llama_fisher(weights, torch.device("cpu"))
    rel = np.abs(scores.per_layer_trace - cpu_scores.per_layer_trace) / \
        np.abs(cpu_scores.per_layer_trace)
    out["fisher"] = dict(trace=scores.per_layer_trace.tolist(),
                         params=scores.per_layer_params.tolist(),
                         importance=scores.importance.tolist(),
                         cpu_trace=cpu_scores.per_layer_trace.tolist(),
                         max_rel_diff_cpu=float(rel.max()),
                         seconds=fisher_s, cpu_seconds=cpu_s)
    if not np.allclose(scores.per_layer_trace, cpu_scores.per_layer_trace,
                       rtol=LLAMA_FISHER_RTOL, atol=0):
        fail("llama", f"Fisher scores on the card {scores.per_layer_trace} "
             f"!= CPU {cpu_scores.per_layer_trace} (rtol {LLAMA_FISHER_RTOL})")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    K2.launch_shapes.clear()
    K4.launch_shapes.clear()
    gib = 1 << 30
    policies = [api.VerifyPolicy(pcs_queries=PCS_QUERIES)] * LLAMA_ATTESTS + [
        api.VerifyPolicy(budget=LLAMA_FISHER_BUDGET, selector="fisher",
                         pcs_queries=PCS_QUERIES)]
    with api.ProofService([cfg] * LLAMA_LAYERS, weights, pcs_blowup=PCS_BLOWUP,
                          default_queries=PCS_QUERIES, workers=1,
                          fisher_scores=scores, name="chip-smoke-llama",
                          weight_cache=cache, device=dev) as svc:
        t0 = time.monotonic()
        with MemoryStages(dev) as stages:
            card = svc.model_card.to_bytes()
        torch.cuda.synchronize(dev)
        out["setup_seconds"] = time.monotonic() - t0
        progress("llama", "setup done", start)
        out["setup_max_memory_gib"] = torch.cuda.max_memory_allocated(dev) / gib
        out["setup_max_reserved_gib"] = torch.cuda.max_memory_reserved(dev) / gib
        out["setup_memory_stages"] = stages.summary()
        out["resident_memory_gib"] = torch.cuda.memory_allocated(dev) / gib
        out["setup_shapes"] = dict(
            K2=_shape_delta(K2.launch_shapes, {}),
            K4=_shape_delta(K4.launch_shapes, {}))
        for q, policy in enumerate(policies):
            x = llama_query(q)
            torch.cuda.reset_peak_memory_stats(dev)
            before = launch_counts()
            s2, s4 = dict(K2.launch_shapes), dict(K4.launch_shapes)
            t0 = time.monotonic()
            att = svc.attest(x, policy)
            wire = att.to_bytes(2)
            t_att = time.monotonic() - t0
            mid = launch_counts()
            a2, a4 = dict(K2.launch_shapes), dict(K4.launch_shapes)
            mem = torch.cuda.max_memory_allocated(dev) / gib
            rep = api.verify(wire, x, card, policy, device=dev)
            if not rep.ok:
                fail("llama", f"request {q}: verify rejected: {rep.reason}")
            r = svc.last_report
            rec = dict(
                policy=dict(budget=policy.budget, selector=policy.selector),
                proved_layers=list(att.proved_layers), seconds=t_att,
                forward_seconds=r.forward_seconds,
                commit_seconds=r.commit_seconds, prove_seconds=r.prove_seconds,
                verify_seconds=rep.verify_seconds, wire_bytes=len(wire),
                checked_layers=rep.checked_layers, max_memory_gib=mem,
                attest_launches={k: mid[k] - before[k] for k in mid},
                verify_launches={k: v - mid[k] for k, v in launch_counts().items()},
                attest_shapes=dict(K2=_shape_delta(a2, s2), K4=_shape_delta(a4, s4)),
                verify_shapes=dict(K2=_shape_delta(K2.launch_shapes, a2),
                                   K4=_shape_delta(K4.launch_shapes, a4)))
            out["requests"].append(rec)
            progress("llama", f"request {q} verified ({t_att:.1f} s attest, "
                     f"{rep.verify_seconds:.1f} s verify, {mem:.1f} GiB)", start)
            if policy.budget < 1.0:
                want = FI.select_fisher(scores, policy.expected_layers(LLAMA_LAYERS))
                if att.proved_layers != want or rep.checked_layers != len(want):
                    fail("llama", f"Fisher attest proved {att.proved_layers}, "
                         f"checked {rep.checked_layers}; select_fisher: {want}")
            elif rep.checked_layers != LLAMA_LAYERS:
                fail("llama", f"request {q}: checked {rep.checked_layers} layers")
            else:
                twins.append(dict(wire=canonical_v2(att), seconds=t_att))
    ns = {k[1] for k in K2.launch_shapes}
    out["k2_row_lengths"] = sorted(ns)
    if not {1 << 16, 1 << 17} <= ns:
        fail("llama", f"K2 never ran rows of 2^16 and 2^17 words: {sorted(ns)}")
    return out, weights


# ---------------------------------------------------------------------------
# Phase 8: the serving tier on the d=128 chain: a gateway over two worker
# threads whose sum-checks meet in multi-claim K3 calls.
# ---------------------------------------------------------------------------
def recording_client():
    """GatewayClient whose attest_verify runs as it is, keeping the wire's
    chunks and the time the first one arrived."""
    from repro_torch.gateway import GatewayClient

    class RecordingClient(GatewayClient):
        def _stream_response(self, on_chunk):
            self.chunks, self.first_chunk_at = [], None

            def keep(b):
                if self.first_chunk_at is None:
                    self.first_chunk_at = time.monotonic()
                self.chunks.append(b)
                on_chunk(b)
            self.done_info = super()._stream_response(keep)
            return self.done_info
    return RecordingClient


def record_windows(svc, windows):
    """Wrap ``svc.attest_many`` (the gateway's call per window) to record
    each window: its queries, wall seconds, K3 launches, and the engine
    report's batcher counters and waits (``batcher_waits``)."""
    from repro_torch.kernels import sumcheck_round as K3
    inner = svc.attest_many

    def attest_many(queries, policies=None, tokens=None):
        k0, t0 = K3.launches, time.monotonic()
        atts = inner(queries, policies, tokens)
        r = svc.last_report
        windows.append(dict(
            queries=list(queries), size=len(queries),
            seconds=time.monotonic() - t0, k3_launches=K3.launches - k0,
            wave_shapes=dict(r.wave_shapes), **batcher_waits(r),
            forward_seconds=r.forward_seconds,
            commit_seconds=r.commit_seconds, prove_seconds=r.prove_seconds))
        return atts
    svc.attest_many = attest_many


def spawned_process():
    """One spawned worker process (a dead one raises, not hangs)."""
    import torch
    from concurrent.futures import ProcessPoolExecutor
    return ProcessPoolExecutor(
        1, mp_context=torch.multiprocessing.get_context("spawn"))


def gateway_clients(host, port, card, queries, per_client, pcs_queries,
                    device):
    """The gateway phase's clients, in a process of their own as clients
    are (their verification must not share the server's interpreter
    lock): each client sends ``per_client`` of the queries at once, one
    connection a query, all released together, and stream-verifies on
    ``device`` as its chunks arrive.  Returns {query: record}, errors."""
    import threading
    import torch
    from repro_torch import api
    dev = torch.device(device)
    policy = api.VerifyPolicy(pcs_queries=pcs_queries)
    client_cls = recording_client()
    results, errors = {}, []
    gate = threading.Barrier(len(queries))

    def request(q, client_id):
        try:
            with client_cls(host, port, client_id=client_id, timeout=900,
                            device=dev) as cli:
                gate.wait(timeout=120)
                t1 = time.monotonic()
                rep = cli.attest_verify(queries[q], card, policy)
                t2 = time.monotonic()
                results[q] = dict(ok=rep.ok, complete=rep.complete,
                                  reason=rep.reason,
                                  checked_layers=rep.checked_layers,
                                  wire=b"".join(cli.chunks), seconds=t2 - t1,
                                  verify_seconds=t2 - cli.first_chunk_at,
                                  batch_size=cli.done_info["batch_size"])
        except BaseException as e:  # noqa: BLE001 — reported to the parent
            errors.append(f"query {q}: {e!r}")

    threads = [threading.Thread(target=request,
                                args=(q, f"client-{q // per_client}"))
               for q in range(len(queries))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if any(t.is_alive() for t in threads):
        errors.append("a client did not finish within 900 s")
    return results, errors


def gateway_phase(dev, cache, twins):
    """An AttestationGateway (windows of up to GATEWAY_MAX_BATCH) over
    ProofService(workers=SERVE_WORKERS), served on a socket on 127.0.0.1,
    answers the clients of ``gateway_clients`` (a process of their own).
    Every attestation's canonical v2 bytes must equal its serial twin
    (workers=1: the serve phase's requests, then the rest here).  Per
    window: its size, the batcher's counters, K3 launches against the
    serial sum for the same queries, wall seconds and seconds per query;
    per query: verify seconds (first chunk to verdict)."""
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.gateway import AttestationGateway, GatewayConfig
    policy = api.VerifyPolicy(pcs_queries=PCS_QUERIES)
    n = GATEWAY_CLIENTS * GATEWAY_QUERIES_PER_CLIENT
    out = dict(config=SERVE_CFG, layers=SERVE_LAYERS, pcs_queries=PCS_QUERIES,
               clients=GATEWAY_CLIENTS, queries_per_client=GATEWAY_QUERIES_PER_CLIENT,
               max_batch=GATEWAY_MAX_BATCH, window_seconds=GATEWAY_WINDOW_SECONDS,
               workers=SERVE_WORKERS)
    t0 = time.monotonic()
    with serve_service(dev, weight_cache=cache) as serial:
        for q in range(len(twins), n):
            before = launch_counts()
            t1 = time.monotonic()
            att = serial.attest(serve_query(q), policy)
            att.to_bytes(2)
            twins.append(dict(wire=canonical_v2(att), seconds=time.monotonic() - t1,
                              profiled=False, k3=launch_counts()["sumcheck_round"]
                              - before["sumcheck_round"]))
    out["serial_twins_seconds"] = time.monotonic() - t0
    progress("gateway", "serial twins attested", t0)
    queries = [serve_query(q) for q in range(n)]
    windows = []
    reset_counts()
    t0 = time.monotonic()
    with serve_service(dev, workers=SERVE_WORKERS, weight_cache=cache) as svc:
        card = svc.model_card.to_bytes()
        record_windows(svc, windows)
        cfg = GatewayConfig(max_batch=GATEWAY_MAX_BATCH,
                            window_seconds=GATEWAY_WINDOW_SECONDS)
        with AttestationGateway(svc, cfg) as gw, spawned_process() as pool:
            host, port = gw.serve(host="127.0.0.1", port=0).address
            results, errors = pool.submit(
                gateway_clients, host, port, card, queries,
                GATEWAY_QUERIES_PER_CLIENT, PCS_QUERIES, str(dev)).result()
            out["metrics"] = gw.metrics_snapshot()
        out["seconds"] = time.monotonic() - t0
        torch.cuda.synchronize(dev)
    if errors:
        fail("gateway", "; ".join(errors))
    k3_serial = [t["k3"] for t in twins]
    out["requests"] = []
    for q in range(n):
        r = results[q]
        if not (r["ok"] and r["complete"] and r["checked_layers"] == SERVE_LAYERS):
            fail("gateway", f"query {q}: stream verify rejected: {r['reason']}")
        got = canonical_v2(api.Attestation.from_bytes(r["wire"], device=dev))
        if got != twins[q]["wire"]:
            fail("gateway", f"query {q}: attestation bytes differ from the "
                 "serial workers=1 attest")
        out["requests"].append(dict(query=q, seconds=r["seconds"],
                                    verify_seconds=r["verify_seconds"],
                                    batch_size=r["batch_size"],
                                    wire_bytes=len(r["wire"])))
    out["windows"] = []
    for w in windows:
        qs = [next(q for q in range(n) if np.array_equal(x, queries[q]))
              for x in w.pop("queries")]
        w.update(query_ids=qs, k3_serial=sum(k3_serial[q] for q in qs),
                 seconds_per_query=w["seconds"] / w["size"],
                 wave_shapes=sorted([d, m, k, c] for (d, m, k), c
                                    in w["wave_shapes"].items()))
        out["windows"].append(w)
    claims = sum(w["claims"] for w in out["windows"])
    batched = sum(w["batched_claims"] for w in out["windows"])
    out["batched_share_of_claims"] = batched / claims if claims else None
    out["k3_launches_per_query"] = sum(w["k3_launches"] for w in out["windows"]) / n
    out["serial_k3_launches_per_query"] = sum(k3_serial[:n]) / n
    out["serial_seconds_per_query"] = sorted(t["seconds"] for t in twins[:n]
                                             if not t["profiled"])
    if not batched:
        fail("gateway", "no sum-check claim shared a K3 call")
    if out["k3_launches_per_query"] >= out["serial_k3_launches_per_query"]:
        fail("gateway", f"K3 launches per query {out['k3_launches_per_query']} "
             f"not below serial {out['serial_k3_launches_per_query']}")
    return out


def batched_shapes(windows):
    """(d, n, claims) of the gateway phase's multi-claim K3 calls, most
    frequent first."""
    count = {}
    for w in windows:
        for d, n, k, c in w["wave_shapes"]:
            if k > 1:
                count[(d, n, k)] = count.get((d, n, k), 0) + c
    return sorted(count, key=lambda s: -count[s]), count


def time_k3_padded(device, seed, d, n, k, iters=20):
    """K3 at one padded multi-claim shape: CUDA-event ms and profiler
    device ms per call, the plain version's ms, launches per call.  Run in
    a fresh process (the profiler saw no device time after the gateway
    phase's threads in the smoke's own process)."""
    import numpy as np
    import torch
    from repro_torch.kernels import sumcheck_round as K3
    dev = torch.device(device)
    fs, sts = k3_padded(np.random.default_rng(seed), dev, d, n, k)
    _, prof = profiled_call(lambda: [K3.prove_rounds(fs, sts) for _ in range(iters)])
    return dict(ms=gpu_ms(lambda: K3.prove_rounds(fs, sts), iters),
                device_ms=(prof["device_busy_ms"] / iters
                           if prof["device_busy_ms"] else None),
                plain_ms=gpu_ms(lambda: K3.prove_rounds_plain(fs, sts), 1),
                launches_per_call=K3.plan(d, n, fs[0].shape[0]).launches)


def k3batch_phase(dev, gen, windows):
    """K3 at every (d, n, claims) the gateway phase's waves met, padded as
    the batcher pads them, against the plain version and per-claim K = 1
    launches (word for word); the most frequent one timed (time_k3_padded)
    with its bound."""
    import torch
    shapes, count = batched_shapes(windows)
    err = 0
    for d, n, k in shapes:
        err = max(err, k3_padded_check(gen, dev, d, n, k, "k3batch"))
        torch.cuda.empty_cache()
    d, n, k = shapes[0]
    kp = 1 << max(k - 1, 0).bit_length()
    with spawned_process() as pool:
        timed = pool.submit(time_k3_padded, str(dev), SEED + 5, d, n,
                            k).result()
    bnd, by = k3_bound(d, n, kp)
    return dict(shapes=[[*s, count[s]] for s in shapes], max_abs_err=err,
                timed=dict(d=d, n=n, claims=k, K=kp, waves=count[shapes[0]],
                           bound_ms=bnd, bound_by=by, **timed))


# ---------------------------------------------------------------------------
# Phase 9: the process backend on the d=128 chain.
# ---------------------------------------------------------------------------
def commitment_bytes(com) -> int:
    """Device bytes of a commitment's matrix, codewords and Merkle levels."""
    ts = [com.mat] + ([com.enc] if com.enc is not None else []) + list(com.tree.levels)
    return sum(t.numel() * t.element_size() for t in ts)


def parent_allocated(dev) -> int:
    """The smoke's own allocated device bytes, after a collection."""
    import torch
    gc.collect()
    return torch.cuda.memory_allocated(dev)


def released(dev, base: int, phase: str) -> int:
    """Fails unless the smoke's process is back at ``base`` allocated
    bytes: a tensor sent to a worker process that the worker still held
    when the parent dropped it would stay allocated."""
    now = parent_allocated(dev)
    if now != base:
        fail(phase, f"{now - base} B still allocated after the process-backed "
             "service closed")
    return now - base


def process_phase(dev, cache, twins):
    """PROCESS_ATTESTS attests on ProofService(workers=SERVE_WORKERS,
    backend="process"): the first one's seconds (spawn and warm-up) apart
    from the warm ones; each job's pickled payload bytes against the
    device bytes of the weight commitment it carries by IPC; each child's
    allocated device bytes once its payload is in, and its peak; kernel
    launches of the parent and of the children.  Bytes must equal the
    serial twins."""
    from repro_torch import api
    policy = api.VerifyPolicy(pcs_queries=PCS_QUERIES)
    out = dict(config=SERVE_CFG, layers=SERVE_LAYERS, workers=SERVE_WORKERS,
               backend="process", requests=[])
    totals = {}
    base = parent_allocated(dev)
    with serve_service(dev, workers=SERVE_WORKERS, backend="process",
                       weight_cache=cache) as svc:
        wt_bytes = commitment_bytes(svc.engine_for(PCS_QUERIES).wt_commits[0].com)
        out["weight_commitment_device_bytes"] = wt_bytes
        for q in range(PROCESS_ATTESTS):
            t0 = time.monotonic()
            att = svc.attest(serve_query(q), policy)
            seconds = time.monotonic() - t0
            if canonical_v2(att) != twins[q]["wire"]:
                fail("process", f"request {q}: bytes differ from the serial twin")
            jobs = svc.last_report.process_jobs
            child = {}
            for j in jobs:
                for k, v in j["launches"].items():
                    child[k] = child.get(k, 0) + v
                    totals[k] = totals.get(k, 0) + v
            if max(j["payload_bytes"] for j in jobs) >= wt_bytes:
                fail("process", "a job's payload carries the commitment as bytes")
            out["requests"].append(dict(
                seconds=seconds, first=q == 0,
                payload_bytes=[j["payload_bytes"] for j in jobs],
                child_pids=sorted({j["pid"] for j in jobs}),
                child_allocated_after_payload=[j.get("allocated_after_payload")
                                               for j in jobs],
                child_max_allocated_gib=[j.get("max_allocated", 0) / (1 << 30)
                                         for j in jobs],
                child_launches=child))
    del svc
    out["parent_allocated_after_close"] = released(dev, base, "process")
    out["child_launches"] = totals
    warm = sorted(r["seconds"] for r in out["requests"] if not r["first"])
    out["warm_seconds"] = warm
    out["thread_serial_seconds"] = sorted(t["seconds"] for t in twins[:PROCESS_ATTESTS]
                                          if not t["profiled"])
    return out


# ---------------------------------------------------------------------------
# Phase 10: the llama chain batched and on worker processes.
# ---------------------------------------------------------------------------
def staged_child_prove(device, blob):
    """The process backend's worker function under MemoryStages (the
    llama_batch phase installs it in the parent; the child runs it)."""
    import torch
    from repro_torch.runtime import engine as E
    with MemoryStages(torch.device(device)) as stages:
        lp, info = E._child_prove(device, blob)
    info["memory_stages"] = stages.summary()
    return lp, info


def llama_batch_phase(dev, weights, cache, twins):
    """On the llama phase's weights and commitments (``cache``): attest_many
    of llama_query(0..LLAMA_BATCH-1) on 2 worker threads (the batcher on),
    then one attest on 2 worker processes; bytes equal to the llama phase's
    serial attests.  Peak device memory by stage (MemoryStages) in the
    parent and in each child, and the stage that set the peak."""
    import torch
    from repro_torch import api
    from repro_torch.core import blocks as B
    from repro_torch.runtime import engine as E
    cfg = B.BlockCfg(**LLAMA_CFG)
    policy = api.VerifyPolicy(pcs_queries=PCS_QUERIES)
    gib = 1 << 30
    out = dict(config=LLAMA_CFG, layers=LLAMA_LAYERS, workers=2,
               batch=LLAMA_BATCH, pcs_queries=PCS_QUERIES)

    def service(**kw):
        return api.ProofService([cfg] * LLAMA_LAYERS, weights,
                                pcs_blowup=PCS_BLOWUP, default_queries=PCS_QUERIES,
                                workers=2, name="chip-smoke-llama",
                                weight_cache=cache, device=dev, **kw)
    start = time.monotonic()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    out["resident_memory_gib"] = torch.cuda.memory_allocated(dev) / gib
    with service() as svc:
        t0 = time.monotonic()
        with MemoryStages(dev) as stages:
            atts = svc.attest_many([llama_query(q) for q in range(LLAMA_BATCH)],
                                   [policy] * LLAMA_BATCH)
        torch.cuda.synchronize(dev)
        seconds = time.monotonic() - t0
        r = svc.last_report
        for q, att in enumerate(atts):
            if canonical_v2(att) != twins[q]["wire"]:
                fail("llama_batch", f"batched query {q}: bytes differ from "
                     "the serial attest")
        out["batched"] = dict(
            seconds=seconds, seconds_per_query=seconds / LLAMA_BATCH,
            serial_seconds=[t["seconds"] for t in twins[:LLAMA_BATCH]],
            forward_seconds=r.forward_seconds, commit_seconds=r.commit_seconds,
            prove_seconds=r.prove_seconds, batched_claims=r.batched_claims,
            launch_waves=r.launch_waves,
            wave_shapes=sorted([d, n, k, c] for (d, n, k), c in r.wave_shapes.items()),
            max_memory_gib=torch.cuda.max_memory_allocated(dev) / gib,
            memory_stages=stages.summary())
    progress("llama_batch", f"attest_many of {LLAMA_BATCH} ({seconds:.1f} s, "
             f"{out['batched']['max_memory_gib']:.1f} GiB)", start)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    inner = E._child_prove
    E._child_prove = staged_child_prove
    base = parent_allocated(dev)
    try:
        with service(backend="process") as svc:
            t0 = time.monotonic()
            with MemoryStages(dev) as stages:
                att = svc.attest(llama_query(0), policy)
            seconds = time.monotonic() - t0
            jobs = svc.last_report.process_jobs
        del svc
    finally:
        E._child_prove = inner
    after_close = released(dev, base, "llama_batch")
    if canonical_v2(att) != twins[0]["wire"]:
        fail("llama_batch", "process-backend attest: bytes differ from the "
             "serial attest")
    child = {}
    for j in jobs:
        for k, v in j["launches"].items():
            child[k] = child.get(k, 0) + v
    out["process"] = dict(
        seconds=seconds, parent_allocated_after_close=after_close,
        parent_max_memory_gib=torch.cuda.max_memory_allocated(dev) / gib,
        parent_memory_stages=stages.summary(), child_launches=child,
        children=[dict(pid=j["pid"], payload_bytes=j["payload_bytes"],
                       allocated_after_payload=j.get("allocated_after_payload"),
                       max_allocated_gib=j.get("max_allocated", 0) / gib,
                       memory_stages=j["memory_stages"]) for j in jobs])
    progress("llama_batch", f"process attest ({seconds:.1f} s)", start)
    return out


# ---------------------------------------------------------------------------
# Phases 11-13: the matmul sum-check, the float model, the serving CLI.
# ---------------------------------------------------------------------------
def matmul_proof_phase(dev):
    """``core.matmul_proof`` prove and verify for C = A.B at MATMUL_SHAPE
    (a TinyLlama-width projection at seq 8) on the card; the proof and its
    three claims equal the same call on the CPU (the kernels' plain
    versions) word for word, and a flipped c_claim is rejected."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import field as F
    from repro_torch.core import matmul_proof as MM
    from repro_torch.core.transcript import Transcript
    n, k, m = MATMUL_SHAPE
    rng = np.random.default_rng(SEED + 5)
    A = rng.integers(-(1 << 15), 1 << 15, (n, k))
    Bm = rng.integers(-(1 << 15), 1 << 15, (k, m))
    Cm = A @ Bm                          # |entries| < k 2^30 < 2^41: exact
    names = ("A", "B", "C")

    def prove(device):
        ops = [F.f_from_int(x, device) for x in (A, Bm, Cm)]
        return MM.prove("A", ops[0], "B", ops[1], "C", ops[2],
                        Transcript("matmul", device=device))

    def verify(pf, device):
        return MM.verify(pf, (n, k, m), names, Transcript("matmul", device=device))

    prove(dev)                           # warm-up: the first launches
    torch.cuda.synchronize(dev)
    reset_counts()
    t0 = time.perf_counter()
    pf, claims = prove(dev)
    torch.cuda.synchronize(dev)
    prove_ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()
    t0 = time.perf_counter()
    ok, vclaims = verify(pf, dev)
    torch.cuda.synchronize(dev)
    verify_ms = (time.perf_counter() - t0) * 1e3
    if not ok:
        fail("matmul_proof", "the card's verifier rejected the card's proof")
    cpu_pf, cpu_claims = prove(torch.device("cpu"))

    def words(p, cl):
        return [p.c_claim, p.sumcheck.round_polys, p.sumcheck.final_evals] + \
            [a for c in cl for a in (c.point, c.value)]
    for a, b in zip(words(pf, claims) + words(pf, vclaims),
                    words(cpu_pf, cpu_claims) * 2):
        if a.dtype != b.dtype or not np.array_equal(a, b):
            fail("matmul_proof", "the card's proof or claims differ from the "
                 "CPU's")
    if [c.tensor for c in claims] != ["C", "A", "B"]:
        fail("matmul_proof", f"claims name {[c.tensor for c in claims]}")
    bad = dataclasses.replace(pf, c_claim=pf.c_claim ^ np.uint32(1))
    if verify(bad, dev)[0]:
        fail("matmul_proof", "verify accepted a flipped c_claim")
    idle = [name for name in ("sumcheck_round", "modmatmul") if launches[name] == 0]
    if idle:
        fail("matmul_proof", f"kernels never launched on the matmul path: {idle}")
    return dict(shape=[n, k, m], prove_ms=prove_ms, verify_ms=verify_ms,
                launches=launches, rounds=int(pf.sumcheck.round_polys.shape[0]))


def model_phase(dev):
    """``launch.serve.generate`` at full width for each of MODEL_ARCHS
    (bf16, weights from a torch.Generator seeded with SEED, the embedding
    scaled by EMBED_SCALE as the CPU tests do so that the LUT path runs in
    its tables' domains): batch 2, a 16-token prompt, 16 new tokens, with
    the LUT ops on and off.  Logits finite, tokens in [0, vocab), and the
    last cached decode step's token is the argmax of a no-cache forward
    over the same tokens (or within ARGMAX_TIE of it: a bf16 near-tie).
    Prefill ms, decode ms per token, tokens/s, peak allocated bytes."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve as S
    from repro_torch.models import model as M
    out = {}
    for arch in MODEL_ARCHS:
        cfg = get_arch(arch).cfg
        sh = cfg.shard_cfg(dp=("data",), tp_size=1, dp_size=1)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        t0 = time.monotonic()
        params = M.init(cfg, sh, gen, dev)
        params["embed"] = params["embed"] * EMBED_SCALE
        prompt = torch.randint(0, cfg.vocab, (MODEL_BATCH, MODEL_PROMPT),
                               generator=gen, device=dev)
        init_s = time.monotonic() - t0
        n_params = sum(p.numel() for p in _leaves(params))
        rec = dict(layers=cfg.n_layers, d=cfg.d, heads=cfg.heads,
                   kv_heads=cfg.kv_heads, vocab=cfg.vocab, params=n_params,
                   dtype=str(cfg.dtype), init_seconds=init_s, runs={})
        sc = S.ServeCfg(max_new_tokens=MODEL_NEW_TOKENS)
        for use_lut in (True, False):
            S.generate(cfg, sh, params, prompt, sc, use_lut=use_lut)   # warm
            stats = {}
            toks = S.generate(cfg, sh, params, prompt, sc, use_lut=use_lut,
                              stats=stats)
            if tuple(toks.shape) != (MODEL_BATCH, MODEL_NEW_TOKENS):
                fail("model", f"{arch}: tokens of shape {tuple(toks.shape)}")
            if int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab:
                fail("model", f"{arch}: a token outside [0, {cfg.vocab})")
            full = torch.cat([prompt, toks[:, :-1]], dim=1)
            with torch.no_grad():
                logits, _, _ = M.forward(cfg, sh, params, full, use_lut=use_lut)
            last = logits[:, -1, :cfg.vocab].float()
            if not bool(torch.isfinite(logits).all()):
                fail("model", f"{arch} use_lut={use_lut}: non-finite logits")
            agree, gap = argmax_check("model", f"{arch} use_lut={use_lut}",
                                      last, toks)
            total = stats["prefill_seconds"] + stats["decode_seconds"]
            rec["runs"]["lut" if use_lut else "exact"] = dict(
                prefill_ms=stats["prefill_seconds"] * 1e3,
                decode_ms_per_token=stats["decode_seconds"] * 1e3
                / stats["decode_steps"],
                tokens_per_s=MODEL_BATCH * MODEL_NEW_TOKENS / total,
                argmax_equal=agree, argmax_gap=gap,
                distinct_tokens=int(toks.unique().numel()))
        rec["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
        out[arch] = rec
        del params, logits
        progress("model", f"{arch} done", t0)
    return out


def zoo_config(arch: str, layers):
    """The arch's full config, cut to its first ``layers`` layers."""
    import dataclasses
    from repro_torch.configs import get_arch
    cfg = get_arch(arch).cfg
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers,
                                  layers=cfg.layers[:layers])
    return cfg


def greedy_with_encoder(cfg, sh, params, prompt, enc, new_tokens, use_lut,
                        stats):
    """``generate``'s greedy loop, with ``enc_input`` passed to the prefill
    and to every decode step (each reruns the encoder, as in the JAX
    package); the prefill's and the decode steps' seconds into stats."""
    import torch
    from repro_torch.models import model as M
    B, S = prompt.shape
    dev = prompt.device
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    caches = M.make_caches(cfg, sh, B, S + new_tokens, dev)
    logits, caches, _ = M.forward(cfg, sh, params, prompt, caches=caches,
                                  use_lut=use_lut, enc_input=enc)
    tok = torch.argmax(logits[:, -1, :cfg.vocab], dim=-1)[:, None]
    torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    out = [tok]
    for i in range(new_tokens - 1):
        lg, caches = M.decode_step(cfg, sh, params, tok,
                                   torch.full((B,), S + i, dtype=torch.int64,
                                              device=dev),
                                   caches, enc_input=enc, use_lut=use_lut)
        tok = torch.argmax(lg[:, :cfg.vocab], dim=-1)[:, None]
        out.append(tok)
    torch.cuda.synchronize(dev)
    stats.update(prefill_seconds=t1 - t0,
                 decode_seconds=time.perf_counter() - t1,
                 decode_steps=new_tokens - 1)
    return torch.cat(out, dim=1)


def argmax_check(phase, name, last, toks):
    """The last cached decode step's token against the argmax of a
    no-cache forward's last logits (float32): (equal, gap); a gap above
    ARGMAX_TIE x the largest |logit| fails."""
    import torch
    top = last.max(dim=-1).values
    picked = last.gather(1, toks[:, -1:])[:, 0]
    gap = float((top - picked).max())
    tie = ARGMAX_TIE * float(last.abs().max())
    agree = bool(torch.equal(last.argmax(dim=-1), toks[:, -1]))
    if not agree and gap > tie:
        fail(phase, f"{name}: the cached decode's token trails the no-cache "
             f"argmax by {gap} (> {tie})")
    return agree, gap


def zoo_run(dev, arch: str, layers):
    """One full-width config of ZOO_RUNS: init, then for the LUT ops on and
    off a warm ``generate`` and a timed one (whisper: the greedy loop with
    its enc_input), with the arch's checks (see zoo_phase)."""
    import torch
    from repro_torch.launch import serve as S
    from repro_torch.models import model as M
    cfg = zoo_config(arch, layers)
    sh = cfg.shard_cfg(dp=("data",), tp_size=1, dp_size=1)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    rec = dict(layers=cfg.n_layers, layers_of=len(zoo_config(arch, None).layers),
               d=cfg.d, heads=cfg.heads, kv_heads=cfg.kv_heads, vocab=cfg.vocab,
               dtype=str(cfg.dtype), allocated_before_init=
               torch.cuda.memory_allocated(dev), runs={})
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.monotonic()
    params = M.init(cfg, sh, gen, dev)
    params["embed"] = params["embed"] * EMBED_SCALE
    prompt = torch.randint(0, cfg.vocab, (MODEL_BATCH, MODEL_PROMPT),
                           generator=gen, device=dev)
    enc = None
    if cfg.encoder is not None:
        enc = torch.randn((MODEL_BATCH, cfg.encoder.frames, cfg.d),
                          generator=gen, device=dev, dtype=torch.float32)
        rec["encoder"] = dict(layers=cfg.encoder.n_layers,
                              frames=cfg.encoder.frames)
    torch.cuda.synchronize(dev)
    rec["init_seconds"] = time.monotonic() - t0
    rec["params"] = sum(p.numel() for p in _leaves(params))
    rec["param_bytes"] = sum(p.numel() * p.element_size()
                             for p in _leaves(params))
    sc = S.ServeCfg(max_new_tokens=ZOO_NEW_TOKENS)

    def run(use_lut, stats):
        if enc is not None:
            return greedy_with_encoder(cfg, sh, params, prompt, enc,
                                       ZOO_NEW_TOKENS, use_lut, stats)
        return S.generate(cfg, sh, params, prompt, sc, use_lut=use_lut,
                          stats=stats)

    for use_lut in (True, False):
        name = f"{arch} use_lut={use_lut}"
        first = run(use_lut, {})                                  # warm
        stats = {}
        toks = run(use_lut, stats)
        if tuple(toks.shape) != (MODEL_BATCH, ZOO_NEW_TOKENS):
            fail("zoo", f"{name}: tokens of shape {tuple(toks.shape)}")
        if int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab:
            fail("zoo", f"{name}: a token outside [0, {cfg.vocab})")
        full = torch.cat([prompt, toks[:, :-1]], dim=1)
        with torch.no_grad():
            logits, _, aux = M.forward(cfg, sh, params, full, use_lut=use_lut,
                                       enc_input=enc)
        if not bool(torch.isfinite(logits).all()):
            fail("zoo", f"{name}: non-finite logits")
        total = stats["prefill_seconds"] + stats["decode_seconds"]
        r = dict(prefill_ms=stats["prefill_seconds"] * 1e3,
                 decode_ms_per_token=stats["decode_seconds"] * 1e3
                 / stats["decode_steps"],
                 tokens_per_s=MODEL_BATCH * ZOO_NEW_TOKENS / total,
                 aux=float(aux), distinct_tokens=int(toks.unique().numel()))
        if arch in ZOO_PREFILL_ARCHS:
            # a cached prefill over the same tokens (caches of exactly their
            # length) against the no-cache forward, then determinism
            with torch.no_grad():
                caches = M.make_caches(cfg, sh, MODEL_BATCH, full.shape[1], dev)
                cached, _, _ = M.forward(cfg, sh, params, full, caches=caches,
                                         use_lut=use_lut)
            scale = float(logits.float().abs().max())
            rel = float((cached.float() - logits.float()).abs().max()) / scale
            if not rel <= ZOO_PREFILL_RTOL:
                fail("zoo", f"{name}: cached prefill logits differ from the "
                     f"no-cache forward by {rel} of the largest |logit| "
                     f"(> {ZOO_PREFILL_RTOL})")
            same = bool(torch.equal(first, toks))
            if not same:
                fail("zoo", f"{name}: two generate runs gave different tokens")
            r.update(prefill_rel_diff=rel, repeat_tokens_equal=same)
        else:
            last = logits[:, -1, :cfg.vocab].float()
            r["argmax_equal"], r["argmax_gap"] = argmax_check(
                "zoo", name, last, toks)
        rec["runs"]["lut" if use_lut else "exact"] = r
    rec["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    # one decode step (LUT ops on) under torch.profiler, against the time
    # the card needs to read every weight but the embedding (its rows are
    # gathered) once: a decode step at T = 2 reads all of them, every
    # expert included (the capacity gives each at least 4 slots)
    with torch.no_grad():
        caches = M.make_caches(cfg, sh, MODEL_BATCH, MODEL_PROMPT + 1, dev)
        _, caches, _ = M.forward(cfg, sh, params, prompt, caches=caches,
                                 use_lut=True, enc_input=enc)
        pos = torch.full((MODEL_BATCH,), MODEL_PROMPT, dtype=torch.int64,
                         device=dev)
        _, rec["decode_profile"] = profiled_call(
            M.decode_step, cfg, sh, params, prompt[:, -1:], pos, caches,
            enc, True)
    embed = params["embed"]
    rec["weight_read_floor_ms"] = (rec["param_bytes"] - embed.numel()
                                   * embed.element_size()) / HBM_BYTES_PER_S * 1e3
    del params, logits, caches
    return rec


def zoo_twin(dev):
    """The six new archs' smoke configs at float32, the port's weights drawn
    on the CPU (embedding x EMBED_SCALE) and copied to the card: no-cache
    forward logits (whisper with a seeded enc_input) within ZOO_TWIN_RTOL
    of the CPU's, and ``generate``'s greedy tokens (LUT ops off) equal."""
    import dataclasses
    import torch
    from repro_torch._tree import tree_map
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve as S
    from repro_torch.models import model as M
    cpu = torch.device("cpu")
    out = {}
    for arch in ZOO_SMOKE_ARCHS:
        cfg = dataclasses.replace(get_arch(arch).smoke, dtype=torch.float32)
        sh = cfg.shard_cfg(dp=("data",), tp_size=1, dp_size=1)
        gen = torch.Generator().manual_seed(SEED)
        params = M.init(cfg, sh, gen, cpu)
        params["embed"] = params["embed"] * EMBED_SCALE
        prompt = torch.randint(0, cfg.vocab, (MODEL_BATCH, MODEL_PROMPT),
                               generator=gen)
        enc = None
        if cfg.encoder is not None:
            enc = torch.randn((MODEL_BATCH, cfg.encoder.frames, cfg.d),
                              generator=gen)
        sc = S.ServeCfg(max_new_tokens=ZOO_NEW_TOKENS)
        res = []
        for where in (cpu, dev):
            p = tree_map(lambda t: t.to(where), params)
            e = enc.to(where) if enc is not None else None
            with torch.no_grad():
                logits, _, _ = M.forward(cfg, sh, p, prompt.to(where),
                                         enc_input=e)
            toks = S.generate(cfg, sh, p, prompt.to(where), sc, use_lut=False)
            res.append((logits.cpu(), toks.cpu()))
        (lc, tc), (lg, tg) = res
        scale = float(lc.abs().max())
        err = float((lg - lc).abs().max())
        close = bool(torch.allclose(lg, lc, rtol=ZOO_TWIN_RTOL,
                                    atol=ZOO_TWIN_RTOL * scale))
        if not close:
            fail("zoo", f"smoke twin {arch}: card logits differ from the CPU's "
                 f"(max abs {err}, scale {scale})")
        if not torch.equal(tg, tc):
            fail("zoo", f"smoke twin {arch}: greedy tokens differ from the CPU's")
        out[arch] = dict(max_abs_err=err, scale=scale, tokens_equal=True)
    return out


def zoo_cli(dev):
    """``launch.serve.main`` in process for each of the six new archs at its
    smoke config on the card, 4 new tokens: the seconds and the token
    line of each."""
    import contextlib
    import io
    from repro_torch.launch import serve as S
    out = {}
    for arch in ZOO_SMOKE_ARCHS:
        buf = io.StringIO()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(buf):
            S.main(["--arch", arch, "--device", str(dev), "--max-new-tokens",
                    "4"])
        text = buf.getvalue()
        if not text.startswith("generated:"):
            fail("zoo", f"serve CLI --arch {arch}: {text!r}")
        out[arch] = dict(seconds=time.monotonic() - t0,
                         output=" ".join(text.split()))
    return out


def zoo_phase(dev, smi_line: str):
    """The rest of the float model zoo on the card: each config of ZOO_RUNS
    at full width (the depth cuts listed there; bf16, weights from a
    torch.Generator seeded with SEED, embedding x EMBED_SCALE; batch 2, a
    16-token prompt, 8 new tokens, LUT ops on and off).  Logits finite,
    tokens in [0, vocab); init seconds, prefill ms, decode ms per token,
    tokens/s, peak allocated bytes.  qwen2-vl and whisper: the last cached
    decode token is the argmax of a no-cache forward (within ARGMAX_TIE),
    whisper with its enc_input through forward and decode_step.  moonshot,
    jamba and xlstm (ZOO_PREFILL_ARCHS): a cached prefill equals the
    no-cache forward within ZOO_PREFILL_RTOL, and two generate runs give
    equal tokens.  Then the smoke twin (zoo_twin) and the serving CLI on
    each new arch (zoo_cli)."""
    out = {"nvidia_smi": smi_line, "models": {}}
    for arch, layers in ZOO_RUNS:
        t0 = time.monotonic()
        out["models"][arch] = zoo_run(dev, arch, layers)
        out["models"][arch]["seconds"] = time.monotonic() - t0
        progress("zoo", f"{arch} done", t0)
    gc.collect()
    import torch
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    out["smoke_twin"] = zoo_twin(dev)
    out["smoke_twin_seconds"] = time.monotonic() - t0
    t0 = time.monotonic()
    out["cli"] = zoo_cli(dev)
    out["cli_seconds"] = time.monotonic() - t0
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def serve_cli_phase(dev):
    """``launch.serve.emit_attestation`` of the serving golden's tokens on
    the card: its files equal tests/data/golden_serve_v2.bin{,.card,
    .policy,.query.npy} (the attestation with the golden's prove_seconds)
    and the v1 re-encoding golden_serve_v1.bin.  Then the CLI in two fresh
    processes: ``--with-proof --emit`` and ``--verify-file
    --stream-verify``, each exiting 0 and printing verified=True."""
    import tempfile
    import numpy as np
    from repro_torch import api
    from repro_torch.launch import serve as S
    gold_path = os.path.join(DATA, "golden_serve_v2.bin")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "att.bin")
        policy = api.VerifyPolicy(pcs_queries=SERVE_CLI_QUERIES)
        # the attestation object, for its v1 envelope (a decoded v2 tape
        # no longer carries its opened columns inline)
        attested = []
        attest = api.ProofService.attest

        def recording_attest(self, *args, **kw):
            attested.append(attest(self, *args, **kw))
            return attested[-1]
        api.ProofService.attest = recording_attest
        reset_counts()
        t0 = time.monotonic()
        try:
            rep = S.emit_attestation(path, np.arange(16), policy,
                                     layers=SERVE_CLI_LAYERS, device=dev)
        finally:
            api.ProofService.attest = attest
        out["emit_seconds"] = time.monotonic() - t0
        out["launches"] = launch_counts()
        if not rep.ok:
            fail("serve_cli", f"self-check rejected: {rep.reason}")
        for suffix in (".card", ".policy", ".query.npy"):
            with open(path + suffix, "rb") as a, open(gold_path + suffix, "rb") as b:
                if a.read() != b.read():
                    fail("serve_cli", f"{suffix} differs from the golden's")
        with open(gold_path, "rb") as fh:
            gold_v2 = fh.read()
        with open(os.path.join(DATA, "golden_serve_v1.bin"), "rb") as fh:
            gold_v1 = fh.read()
        (att,) = attested
        with open(path, "rb") as fh:
            if fh.read() != att.to_bytes(2, device=dev):
                fail("serve_cli", "the written attestation is not the attest's")
        att.prove_seconds = api.Attestation.from_bytes(
            gold_v2, device=dev).prove_seconds
        att.__dict__.pop("_wire_cache", None)
        if att.to_bytes(2, device=dev) != gold_v2 or \
                att.to_bytes(1, device=dev) != gold_v1:
            fail("serve_cli", "attestation bytes differ from golden_serve_v1/v2")
        idle = [n for n in SERVE_KERNELS if out["launches"][n] == 0]
        if idle:
            fail("serve_cli", f"kernels never launched on the CLI's path: {idle}")
        env = dict(os.environ, PYTHONPATH=SRC + os.pathsep +
                   os.environ.get("PYTHONPATH", ""))
        cli = [sys.executable, "-m", "repro_torch.launch.serve"]
        for step, args in (
                ("emit", ["--arch", "gpt2_small", "--with-proof",
                          "--emit", os.path.join(tmp, "cli.bin")]),
                ("verify", ["--verify-file", os.path.join(tmp, "cli.bin"),
                            "--stream-verify"])):
            t0 = time.monotonic()
            r = subprocess.run(cli + args, capture_output=True, text=True,
                               env=env, cwd=tmp, timeout=SERVE_CLI_TIMEOUT)
            out[f"cli_{step}_seconds"] = time.monotonic() - t0
            tail = (r.stdout + r.stderr)[-2000:]
            if r.returncode != 0 or "verified=True" not in r.stdout:
                fail("serve_cli", f"CLI {step} exited {r.returncode}: {tail}")
            out[f"cli_{step}_last_line"] = r.stdout.strip().splitlines()[-1]
    return out


def train_step_twin(device, compress: bool, steps: int,
                    scan_layers: bool = False):
    """``make_train_step`` on TRAIN_TWIN_ARCH's smoke config at float32
    compute, weights drawn on the CPU from seed 0 (the stacked tree with
    ``scan_layers``): ``steps`` steps at lr TRAIN_TWIN_LR, 2 microbatches,
    int8 compression on or off.  The losses, grad norms and final weights
    (float32 host arrays)."""
    import dataclasses
    import torch
    from repro_torch._tree import leaves, tree_map
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataPipeline, SyntheticCorpus
    from repro_torch.launch import train as T
    from repro_torch.models import model as M
    from repro_torch.optim import adamw, compression
    cfg = dataclasses.replace(get_arch(TRAIN_TWIN_ARCH).smoke,
                              dtype=torch.float32)
    sh = cfg.shard_cfg(dp=("data",), tp_size=1, dp_size=1)
    params = tree_map(lambda p: p.to(device), M.init(
        cfg, sh, torch.Generator().manual_seed(SEED), torch.device("cpu"),
        scan_layers))
    opt = adamw.AdamWCfg(lr=TRAIN_TWIN_LR, warmup_steps=1, total_steps=steps)
    step = T.make_train_step(cfg, sh, opt, T.TrainCfg(
        microbatches=2, compress_grads=compress, remat=True,
        scan_layers=scan_layers))
    st, ef = adamw.init(params), compression.init_ef(params)
    pipe = DataPipeline(SyntheticCorpus(cfg.vocab, SEED), 4, 16)
    metrics = []
    for _ in range(steps):
        toks, labels = (torch.from_numpy(a).to(device, torch.int64)
                        for a in pipe.next_batch())
        params, st, ef, m = step(params, st, ef, toks, labels)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics, [p.float().cpu().numpy() for p in leaves(params)]


def check_train_twin(dev, compress: bool, steps: int,
                     scan_layers: bool = False, phase: str = "train"):
    """The card's smoke-config steps against the CPU's: losses and grad
    norms within TRAIN_TWIN_RTOL; every weight within 2 lr k + 2^-7 |p|
    (a near-zero gradient or an int8 code that rounds the other way moves
    a weight 2 lr a step, a last-bit difference one bf16 ulp), at most
    TRAIN_TWIN_CHANGED_SHARE of them different at all.  With compression
    one step: a flipped code moves its weight by 2 lr, which changes the
    next step's gradients well past float32 rounding."""
    import numpy as np
    import torch
    if torch.backends.cuda.matmul.allow_tf32:
        fail(phase, "TF32 matmuls are on: the twin must compare float32")
    card, card_w = train_step_twin(dev, compress, steps, scan_layers)
    cpu, cpu_w = train_step_twin(torch.device("cpu"), compress, steps,
                                 scan_layers)
    rel = max(abs(a - c) / abs(c) for x, y in zip(card, cpu)
              for a, c in zip(x, y))
    if rel > TRAIN_TWIN_RTOL:
        fail(phase, f"compress={compress}: card loss/grad norm {card} != "
             f"CPU {cpu}")
    bound = 2 * TRAIN_TWIN_LR * steps
    changed = total = 0
    worst = 0.0
    for a, b in zip(card_w, cpu_w):
        d = np.abs(a - b)
        if not np.all(d <= bound + 2.0 ** -7 * np.abs(b)):
            fail(phase, f"compress={compress}: a weight differs by "
                 f"{float(d.max())} between the card's step and the CPU's")
        changed += int(np.count_nonzero(d))
        total += b.size
        worst = max(worst, float(d.max()))
    if changed > TRAIN_TWIN_CHANGED_SHARE * total:
        fail(phase, f"compress={compress}: {changed} of {total} weights "
             "differ between the card's step and the CPU's")
    return dict(arch=TRAIN_TWIN_ARCH, compress=compress, steps=steps,
                scan_layers=scan_layers,
                card=card, cpu=cpu, max_rel=rel, weights_changed=changed,
                weights=total, max_weight_diff=worst)


class _Timed:
    """Wraps a module function for the phase, recording each call's
    seconds (the device synchronised at the end)."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.seconds = []

    def __enter__(self):
        import torch

        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = self.fn(*a, **kw)
            torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)
            return out
        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def train_run(dev, arch, rec_key, rec, resume=False, **tc_kw):
    """One ``launch.train.train`` at full width (its stdout to stderr):
    its record (steps, losses, step ms as the median after the first,
    tokens/s, the 6 N tokens FLOP share of BF16_PEAK_FLOPS, the pipeline's
    host ms per batch, peak allocated bytes) under ``rec[rec_key]``, and
    the run's output."""
    import contextlib
    import io
    import statistics
    import torch
    from repro_torch.launch import train as T
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = T.train(arch, T.TrainCfg(**TRAIN_CFG, **tc_kw), smoke=False,
                      resume=resume, device=dev)
    sys.stderr.write(buf.getvalue())
    losses = out["losses"]
    if not losses or not all(map(math.isfinite, losses)):
        fail("train", f"{arch} {rec_key}: losses {losses}")
    step_s = statistics.median(out["step_seconds"][1:])
    tokens = TRAIN_CFG["batch"] * TRAIN_CFG["seq"]
    n_params = sum(p.numel() for p in _leaves(out["params"]))
    rec[rec_key] = dict(
        steps=len(losses), first_loss=losses[0], last_loss=losses[-1],
        first_step_ms=out["step_seconds"][0] * 1e3, step_ms=step_s * 1e3,
        tokens_per_s=tokens / step_s,
        flops_6nt=6 * n_params * tokens,
        bf16_peak_share=6 * n_params * tokens / step_s / BF16_PEAK_FLOPS,
        pipeline_ms=statistics.median(out["data_seconds"]) * 1e3,
        max_memory_allocated=torch.cuda.max_memory_allocated(dev))
    rec["params"] = n_params
    return out, buf.getvalue()


def profile_train_step(dev, arch: str):
    """One ``make_train_step`` call at full width (TRAIN_CFG, remat on,
    fresh weights and state, the pipeline's first batch) under
    torch.profiler, after two warm steps: the device's busy share of the
    step's wall time, its kernel launches and the top kernels."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataPipeline, SyntheticCorpus
    from repro_torch.launch import train as T
    from repro_torch.models import model as M
    from repro_torch.optim import adamw, compression
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_arch(arch).cfg
    sh = cfg.shard_cfg(dp=("data",), tp_size=1, dp_size=1)
    tc = T.TrainCfg(**TRAIN_CFG)
    params = M.init(cfg, sh, torch.Generator(device=dev).manual_seed(SEED), dev)
    state = [params, adamw.init(params), compression.init_ef(params)]
    step = T.make_train_step(cfg, sh, adamw.AdamWCfg(), tc)
    toks, labels = (torch.from_numpy(a).to(dev, torch.int64) for a in
                    DataPipeline(SyntheticCorpus(cfg.vocab, SEED), tc.batch,
                                 tc.seq).next_batch())

    def one():
        p, o, e, metrics = step(*state, toks, labels)
        state[:] = [p, o, e]
        return float(metrics["loss"])
    one()
    one()
    _, prof = profiled_call(one)
    del state
    return prof


def train_phase(dev, smi_line: str):
    """Training at full width: GPT-2 Small to a checkpoint and resumed
    from it, TinyLlama-1.1B with remat on and off (one JSON line for each
    model), after the smoke config's step on the card against the CPU's
    (see TRAIN_*), which the phase returns."""
    import tempfile
    from repro_torch.checkpoint import checkpoint as ckpt
    out = {"twin": [check_train_twin(dev, compress, steps)
                    for compress, steps in TRAIN_TWIN_RUNS]}
    k, total = TRAIN_GPT2_STEPS
    gpt2 = {}
    with tempfile.TemporaryDirectory() as tmp:
        d = os.path.join(tmp, "ck")
        with _Timed(ckpt, "save_async") as save, \
                _Timed(ckpt, "wait_pending") as wait:
            first, _ = train_run(dev, "gpt2_small", "remat_to_checkpoint",
                                 gpt2, steps=k, ckpt_dir=d, ckpt_every=k)
        if ckpt.latest_step(d) != k:
            fail("train", f"gpt2_small: no checkpoint at step {k}")
        files = os.listdir(os.path.join(d, f"step_{k}"))
        gpt2["checkpoint"] = dict(
            step=k, files=len(files),
            bytes=sum(os.path.getsize(os.path.join(d, f"step_{k}", f))
                      for f in files),
            save_async_seconds=save.seconds, wait_pending_seconds=wait.seconds)
        with _Timed(ckpt, "restore") as restore:
            second, log = train_run(dev, "gpt2_small", "remat_resumed", gpt2,
                                    resume=True, steps=total, ckpt_dir=d,
                                    ckpt_every=total)
        gpt2["checkpoint"]["restore_seconds"] = restore.seconds
        if f"[train] elastic resume from step {k}" not in log or \
                len(second["losses"]) != total - k:
            fail("train", f"gpt2_small did not resume at step {k}: ran "
                 f"{len(second['losses'])} steps")
        if not second["losses"][-1] < first["losses"][0]:
            fail("train", f"gpt2_small: the last loss {second['losses'][-1]} "
                 f"is not below the first {first['losses'][0]}")
        del first, second
        train_run(dev, "gpt2_small", "no_remat", gpt2, remat=False,
                  steps=TRAIN_REMAT_OFF_STEPS, ckpt_dir=os.path.join(tmp, "x"),
                  ckpt_every=TRAIN_REMAT_OFF_STEPS + 1)
        gpt2["profiled_step"] = profile_train_step(dev, "gpt2_small")
        emit({"phase": "train", "model": "gpt2_small", "ok": True,
              "nvidia_smi": smi_line, **gpt2})
        llama = {}
        for remat in (True, False):
            train_run(dev, "tinyllama_1_1b", "remat" if remat else "no_remat",
                      llama, remat=remat, steps=TRAIN_LLAMA_STEPS,
                      ckpt_dir=os.path.join(tmp, "y"),
                      ckpt_every=TRAIN_LLAMA_STEPS + 1)
        llama["profiled_step"] = profile_train_step(dev, "tinyllama_1_1b")
        emit({"phase": "train", "model": "tinyllama_1_1b", "ok": True,
              "nvidia_smi": smi_line, **llama})
    return out


def dryrun_cache_seq(dev):
    """A cached prefill and DRYRUN_CACHE_SEQ_STEPS greedy decode steps of
    the tinyllama smoke config (bf16, init weights) with and without
    ``ShardCfg.cache_seq``: the logits and tokens of every step must be
    equal bit for bit."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import model as M
    cfg = get_arch("tinyllama_1_1b").smoke
    params = M.init(cfg, cfg.shard_cfg(dp=("data",), tp_size=1, dp_size=1),
                    torch.Generator(device=dev).manual_seed(SEED), dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    prompt = torch.randint(0, cfg.vocab, (MODEL_BATCH, MODEL_PROMPT),
                           generator=gen, device=dev)
    runs = []
    for cache_seq in ((), ("model",)):
        sh = cfg.shard_cfg(dp=("data",), tp_size=1, dp_size=1,
                           cache_seq=cache_seq, cache_seq_size=1)
        caches = M.make_caches(cfg, sh, MODEL_BATCH,
                               MODEL_PROMPT + DRYRUN_CACHE_SEQ_STEPS, dev)
        with torch.no_grad():
            logits, caches, _ = M.forward(cfg, sh, params, prompt,
                                          caches=caches)
            out, tok = [logits], logits[:, -1].argmax(-1)
            for i in range(DRYRUN_CACHE_SEQ_STEPS):
                lg, caches = M.decode_step(
                    cfg, sh, params, tok[:, None],
                    torch.full((MODEL_BATCH,), MODEL_PROMPT + i, device=dev),
                    caches)
                tok = lg.argmax(-1)
                out += [lg, tok]
        runs.append(out)
    torch.cuda.synchronize(dev)
    equal = all(torch.equal(a, b) for a, b in zip(*runs))
    if not equal:
        fail("dryrun", "cache_seq decode differs from the unsharded decode")
    return {"steps": DRYRUN_CACHE_SEQ_STEPS, "bit_equal": equal,
            "tokens": runs[0][-1].tolist()}


def dryrun_phase(dev, smi_line: str):
    """The dry run's estimates: production cells on meta, one-device
    cells against the card, the sequence-sharded cache (see the module's
    docstring, phase 16)."""
    import contextlib
    import tempfile
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_debug_mesh
    out = {"nvidia_smi": smi_line, "production": [], "cells": []}
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(sys.stderr):
        for arch, shape in DRYRUN_PRODUCTION:
            rec = D.run_cell(arch, shape, False, tmp)
            if rec["status"] != "ok":
                fail("dryrun", f"{rec['cell']}: {rec.get('error')}")
            out["production"].append(rec)
    mesh = make_debug_mesh(1, 1)
    for arch, shape, batch in DRYRUN_CARD_CELLS:
        t0 = time.monotonic()
        cell, _ = D.build_cell(arch, shape, mesh=mesh, batch=batch)
        full = get_arch(arch).shape_params(shape)["batch"]
        gc.collect()
        torch.cuda.empty_cache()
        got = D.check_on_card(cell, dev, torch.Generator(
            device=dev).manual_seed(SEED))
        est = got.pop("estimate")
        rec = {"cell": f"{arch}.{shape}.{D.mesh_name(mesh)}",
               "scan_layers": cell.scan_layers,
               "reduced": {"batch": [full, cell.batch]} if batch else {},
               "nvidia_smi": smi_line, "seconds": time.monotonic() - t0,
               "estimate": {k: est[k] for k in (
                   "flops_traced", "bytes_unfused", "memory", "compute_s",
                   "memory_s", "bottleneck", "fits", "trace_s")}, **got}
        out["cells"].append(rec)
        progress("dryrun", f"{rec['cell']} done", t0)
        if got["misses"]:
            emit({"phase": "dryrun", "cell": rec})
            fail("dryrun", f"{rec['cell']}: {'; '.join(got['misses'])}")
    gc.collect()
    torch.cuda.empty_cache()
    out["cache_seq"] = dryrun_cache_seq(dev)
    return out


def scan_generate(dev, arch: str):
    """SCAN_ARCHS' run: the full config at full width and depth, bf16,
    weights drawn by ``model.init(..., scan_layers=True)`` from SEED
    (embedding x EMBED_SCALE); ``generate`` (LUT ops on; a warm run of
    each layout, then two timed runs of each in turns) and a no-cache
    forward over the generated tokens on the stacked tree and on its
    per-layer tree of views (``model.unstack``): tokens equal, the
    largest logit difference within ARGMAX_TIE of the largest |logit|;
    prefill ms, decode ms per step and the peak allocated above the
    weights of each timed run."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve as S
    from repro_torch.models import model as M
    cfg = get_arch(arch).cfg
    sh = cfg.shard_cfg(dp=("data",), tp_size=1, dp_size=1)
    gc.collect()
    torch.cuda.empty_cache()
    period, reps = M.scan_split(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = M.init(cfg, sh, gen, dev, scan_layers=True)
    params["embed"] = params["embed"] * EMBED_SCALE
    prompt = torch.randint(0, cfg.vocab, (MODEL_BATCH, MODEL_PROMPT),
                           generator=gen, device=dev)
    rec = dict(layers=cfg.n_layers, period=period, reps=reps,
               tail=cfg.n_layers - period * reps, d=cfg.d, vocab=cfg.vocab,
               dtype=str(cfg.dtype), new_tokens=ZOO_NEW_TOKENS,
               param_bytes=sum(p.numel() * p.element_size()
                               for p in _leaves(params)), layouts={})
    sc = S.ServeCfg(max_new_tokens=ZOO_NEW_TOKENS)
    trees = {"stacked": params, "per_layer": M.unstack(cfg, params)}
    runs = {}
    for name, tree in trees.items():
        S.generate(cfg, sh, tree, prompt, sc)                      # warm
        rec["layouts"][name] = dict(prefill_ms=[], decode_ms_per_step=[],
                                    peak_over_weights=[])
    # timed in turns (stacked, per-layer, per-layer, stacked): the host's
    # speed drifts within a call
    for name in ("stacked", "per_layer", "per_layer", "stacked"):
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        stats = {}
        toks = S.generate(cfg, sh, trees[name], prompt, sc, stats=stats)
        r = rec["layouts"][name]
        r["peak_over_weights"].append(torch.cuda.max_memory_allocated(dev)
                                      - base)
        r["prefill_ms"].append(stats["prefill_seconds"] * 1e3)
        r["decode_ms_per_step"].append(stats["decode_seconds"] * 1e3
                                       / stats["decode_steps"])
        if name in runs:
            continue
        with torch.no_grad():
            logits, _, _ = M.forward(cfg, sh, trees[name],
                                     torch.cat([prompt, toks[:, :-1]], 1),
                                     use_lut=True)
        runs[name] = (toks, logits)
    (ts, ls), (tp, lp) = runs["stacked"], runs["per_layer"]
    if not torch.equal(ts, tp):
        fail("scan", f"{arch}: generate gave different tokens on the stacked "
             "and the per-layer tree")
    diff = float((ls.float() - lp.float()).abs().max())
    scale = float(lp.float().abs().max())
    if not diff <= ARGMAX_TIE * scale:
        fail("scan", f"{arch}: logits differ by {diff} between the layouts "
             f"(> {ARGMAX_TIE} x {scale})")
    rec.update(tokens_equal=True, max_abs_logit_diff=diff,
               logits_bit_equal=bool(torch.equal(ls, lp)), logit_scale=scale)
    del params, trees, runs, ls, lp
    return rec


def scan_train(dev, tmp):
    """GPT-2 Small at full width and depth trained SCAN_TRAIN_STEPS steps on
    the stacked tree (TRAIN_CFG: compression on), then the loss of the
    first step's batch before and after (it must fall)."""
    import torch
    from repro_torch.data.pipeline import DataPipeline, SyntheticCorpus
    from repro_torch.launch import train as T
    from repro_torch.models import model as M
    rec = {}
    out, _ = train_run(dev, "gpt2_small", "run", rec, steps=SCAN_TRAIN_STEPS,
                       scan_layers=True, ckpt_dir=os.path.join(tmp, "scan"),
                       ckpt_every=SCAN_TRAIN_STEPS + 1)
    cfg, sh = out["cfg"], out["sh"]
    if "blocks" not in out["params"]:
        fail("scan", "gpt2_small trained on the per-layer tree")
    tc = T.TrainCfg(**TRAIN_CFG)
    toks, labels = (torch.from_numpy(a).to(dev, torch.int64) for a in
                    DataPipeline(SyntheticCorpus(cfg.vocab, tc.seed),
                                 tc.batch, tc.seq).next_batch())
    init = M.init(cfg, sh, torch.Generator(device=dev).manual_seed(tc.seed),
                  dev, scan_layers=True)
    with torch.no_grad():
        before = float(M.loss_fn(cfg, sh, init, toks, labels, remat=False))
        after = float(M.loss_fn(cfg, sh, out["params"], toks, labels,
                                remat=False))
    if not after < before:
        fail("scan", f"gpt2_small stacked: the first batch's loss {after} "
             f"after {SCAN_TRAIN_STEPS} steps is not below {before}")
    rec.update(first_batch_loss_before=before, first_batch_loss_after=after,
               period=M.scan_split(cfg)[0], reps=M.scan_split(cfg)[1])
    del out, init
    return rec


def scan_phase(dev, smi_line: str):
    """The stacked-layer layout on the card (see the module's docstring,
    phase 17)."""
    import tempfile
    out = {"nvidia_smi": smi_line, "generate": {}}
    for arch in SCAN_ARCHS:
        t0 = time.monotonic()
        out["generate"][arch] = scan_generate(dev, arch)
        out["generate"][arch]["seconds"] = time.monotonic() - t0
        progress("scan", f"{arch} done", t0)
    gc.collect()
    import torch
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        out["train"] = scan_train(dev, tmp)
    out["train"]["seconds"] = time.monotonic() - t0
    out["twin"] = check_train_twin(dev, True, 1, scan_layers=True,
                                   phase="scan")
    return out


def profiled_call(fn, *args, match=()):
    """Run fn under torch.profiler, tracing device activity only; report
    the device's busy time (the sum of kernel times) against the wall
    time, the top kernels, and for each substring in ``match`` the device
    ms and count of the kernels whose names hold it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    t0 = time.monotonic()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        result = fn(*args)
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us:
            rows.append((ev.key, dev_us / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    summary = dict(wall_ms=wall * 1e3,
                   device_busy_ms=busy if rows else None,
                   busy_share=busy / (wall * 1e3) if rows else None,
                   top=[dict(name=k[:80], ms=ms, count=c)
                        for k, ms, c in rows[:12]],
                   launches=sum(r[2] for r in rows))
    if match:
        summary["match"] = {
            m: [sum(r[1] for r in rows if m in r[0]),
                sum(r[2] for r in rows if m in r[0])] for m in match}
    return result, summary


def kernel_modules():
    from repro_torch.kernels import modmatmul as K4
    from repro_torch.kernels import ntt_kernel as K2
    from repro_torch.kernels import poseidon2_kernel as K1
    from repro_torch.kernels import sumcheck_fold as K5
    from repro_torch.kernels import sumcheck_round as K3
    return [
        ("poseidon2", K1, "src/repro_torch/csrc/poseidon2.cu",
         "src/repro/kernels/poseidon2_kernel.py:103"),
        ("ntt", K2, "src/repro_torch/csrc/ntt.cu",
         "src/repro/kernels/ntt_kernel.py:66"),
        ("sumcheck_round", K3, "src/repro_torch/csrc/sumcheck_round.cu",
         "src/repro/kernels/sumcheck_round.py:167"),
        ("modmatmul", K4, "src/repro_torch/csrc/modmatmul.cu",
         "src/repro/kernels/modmatmul.py:64"),
        ("sumcheck_fold", K5, "src/repro_torch/csrc/sumcheck_fold.cu",
         "src/repro/kernels/sumcheck_fold.py:84"),
    ]


# The kernels each path must launch: the serve path runs K1-K4 (nothing on
# it calls K5); the analysis path runs all five.
SERVE_KERNELS = ("poseidon2", "ntt", "sumcheck_round", "modmatmul")
ANALYSIS_KERNELS = SERVE_KERNELS + ("sumcheck_fold",)


def reset_counts() -> None:
    from repro_torch.kernels import ntt_kernel as K2
    for _, mod, _, _ in kernel_modules():
        mod.launches = 0
    K2.long_launches = 0


def launch_counts():
    """Launches per kernel since reset_counts; ``ntt_long_rows`` is the
    part of K2's made on rows longer than 2^15 words."""
    from repro_torch.kernels import launch_counts as counts
    return counts()


def add_counts(a, b):
    return {k: a[k] + b.get(k, 0) for k in a}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs one CUDA card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import numpy as np
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi unavailable"
    emit({"phase": "device", "ok": True, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi_line,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.monotonic()
    try:
        _build.build_all()
    except RuntimeError as e:
        fail("build", str(e))
    emit({"phase": "build", "ok": True, "seconds": time.monotonic() - t0,
          "libraries": [str(_build.library_path(n)) for n in _build.SOURCES]})

    t0 = time.monotonic()
    recs = check_kernels(dev, main_path_shapes(), np.random.default_rng(SEED))
    emit({"phase": "kernels", "ok": True, "seconds": time.monotonic() - t0,
          "max_abs_err": {**{k: v["max_abs_err"] for k, v in recs.items()},
                          "ntt_long_rows": recs["ntt"]["long_rows_max_abs_err"]},
          "ms": {k: dict(kernel=v["ms"], plain=v["plain_ms"], shape=v["shape"],
                         kernels_device_ms=v.get("device_ms"))
                 for k, v in recs.items()},
          "k5": recs["sumcheck_fold"]["shapes"]})

    t0 = time.monotonic()
    k1k3 = time_k1k3(dev, np.random.default_rng(SEED + 1))
    emit({"phase": "k1k3", "ok": True, "seconds": time.monotonic() - t0,
          "times": k1k3})

    t0 = time.monotonic()
    k2k4 = time_k2k4(dev, np.random.default_rng(SEED + 2))
    emit({"phase": "k2k4", "ok": True, "seconds": time.monotonic() - t0,
          "times": k2k4})

    golden = golden_phase(dev)
    emit({"phase": "golden", "ok": True, **golden})

    from repro_torch.runtime.engine import WeightCommitCache
    d128_cache, d128_twins = WeightCommitCache(), []
    reset_counts()
    serve = serve_phase(dev, d128_cache, d128_twins)
    serve_launches = launch_counts()
    emit({"phase": "serve", "ok": True, "launches": serve_launches, **serve})
    idle = [n for n in SERVE_KERNELS if serve_launches[n] == 0]
    if idle:
        fail("serve", f"kernels never launched on the main path: {idle}")

    reset_counts()
    analysis = analysis_phase(dev)
    analysis_launches = launch_counts()
    emit({"phase": "analysis", "ok": True, "launches": analysis_launches,
          **analysis})
    idle = [n for n in ANALYSIS_KERNELS if analysis_launches[n] == 0]
    if idle:
        fail("analysis", f"kernels never launched on the analysis path: {idle}")

    torch.cuda.empty_cache()
    t0 = time.monotonic()
    k2long = time_k2_long(dev, np.random.default_rng(SEED + 3))
    pcs_long = golden_pcs_long(dev)
    emit({"phase": "k2long", "ok": True, "seconds": time.monotonic() - t0,
          "times": k2long, "golden_pcs_long": pcs_long})

    # the serving tier on the d=128 chain; each path's counts zeroed just
    # before it and read just after (gateway_phase zeroes them after its
    # serial twins; a worker process's launches come back with its job)
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    gateway = gateway_phase(dev, d128_cache, d128_twins)
    gateway_launches = launch_counts()
    emit({"phase": "gateway", "ok": True, "seconds": time.monotonic() - t0,
          "launches": gateway_launches, **gateway})
    idle = [n for n in SERVE_KERNELS if gateway_launches[n] == 0]
    if idle:
        fail("gateway", f"kernels never launched on the gateway path: {idle}")

    t0 = time.monotonic()
    k3b = k3batch_phase(dev, np.random.default_rng(SEED + 4), gateway["windows"])
    emit({"phase": "k3batch", "ok": True, "seconds": time.monotonic() - t0, **k3b})

    reset_counts()
    t0 = time.monotonic()
    process = process_phase(dev, d128_cache, d128_twins)
    process_launches = add_counts(launch_counts(), process["child_launches"])
    emit({"phase": "process", "ok": True, "seconds": time.monotonic() - t0,
          "launches": process_launches, **process})
    idle = [n for n in SERVE_KERNELS if process_launches[n] == 0]
    if idle:
        fail("process", f"kernels never launched on the process path: {idle}")

    torch.cuda.empty_cache()
    llama_cache, llama_twins = WeightCommitCache(), []
    reset_counts()
    t0 = time.monotonic()
    llama, llama_weights = llama_phase(dev, llama_cache, llama_twins)
    llama_launches = launch_counts()
    emit({"phase": "llama", "ok": True, "seconds": time.monotonic() - t0,
          "launches": llama_launches, **llama})
    idle = [n for n in SERVE_KERNELS + ("ntt_long_rows",)
            if llama_launches[n] == 0]
    if idle:
        fail("llama", f"kernels never launched on the llama path: {idle}")

    # llama batched and on worker processes, its weights and commitments
    # still resident (a worker process's launches come back with its job)
    reset_counts()
    t0 = time.monotonic()
    llama_batch = llama_batch_phase(dev, llama_weights, llama_cache, llama_twins)
    lb_launches = add_counts(launch_counts(), llama_batch["process"]["child_launches"])
    emit({"phase": "llama_batch", "ok": True, "seconds": time.monotonic() - t0,
          "launches": lb_launches, **llama_batch})
    idle = [n for n in SERVE_KERNELS if lb_launches[n] == 0]
    if idle:
        fail("llama_batch", f"kernels never launched on the llama_batch path: {idle}")

    # the float model and the serving CLI: the llama phases' weights and
    # commitments go first
    del llama_weights, llama_cache, llama_twins
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    mm = matmul_proof_phase(dev)
    emit({"phase": "matmul_proof", "ok": True, "seconds": time.monotonic() - t0,
          **mm})

    t0 = time.monotonic()
    model = model_phase(dev)
    emit({"phase": "model", "ok": True, "seconds": time.monotonic() - t0,
          "nvidia_smi": smi_line, "models": model})

    # the rest of the zoo: the model phase's weights are gone
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    zoo = zoo_phase(dev, smi_line)
    emit({"phase": "zoo", "ok": True, "seconds": time.monotonic() - t0, **zoo})

    t0 = time.monotonic()
    cli = serve_cli_phase(dev)
    emit({"phase": "serve_cli", "ok": True, "seconds": time.monotonic() - t0,
          **cli})

    t0 = time.monotonic()
    twin = train_phase(dev, smi_line)
    emit({"phase": "train", "ok": True, "seconds": time.monotonic() - t0,
          **twin})

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    dry = dryrun_phase(dev, smi_line)
    emit({"phase": "dryrun", "ok": True, "seconds": time.monotonic() - t0,
          **dry})

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    scan = scan_phase(dev, smi_line)
    emit({"phase": "scan", "ok": True, "seconds": time.monotonic() - t0,
          **scan})

    kernels = []
    for name, _, src, replaces in kernel_modules():
        r = recs[name]
        launches = (serve_launches if name in SERVE_KERNELS
                    else analysis_launches)[name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches, max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
            bound_by=r["bound"][1], library_ms=None))
    # K2's long-row path (the llama path's rows): its launches there, its
    # checks against the plain version (kernels and k2long phases), and the
    # helper-row shape timed against the plain version
    t = next(t for t in k2long if "plain_ms" in t)
    long_err = max(recs["ntt"]["long_rows_max_abs_err"],
                   *(t["max_abs_err"] for t in k2long if "max_abs_err" in t))
    kernels.append(dict(
        name="ntt_long_rows", route="cuda", source="src/repro_torch/csrc/ntt.cu",
        replaces="src/repro/kernels/ntt_kernel.py:66",
        launches=llama_launches["ntt_long_rows"], max_abs_err=long_err,
        ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        bound_by=t["bound_by"], library_ms=None))
    # K3's multi-claim calls (the round batcher's): the gateway path's K3
    # launches, the padded checks (kernels and k3batch phases), and the
    # most frequent batched shape timed
    kt = k3b["timed"]
    kernels.append(dict(
        name="sumcheck_round_batched", route="cuda",
        source="src/repro_torch/csrc/sumcheck_round.cu",
        replaces="src/repro/kernels/sumcheck_round.py:167",
        launches=gateway_launches["sumcheck_round"],
        max_abs_err=max(recs["sumcheck_round"]["max_abs_err"], k3b["max_abs_err"]),
        ms=kt["ms"], plain_ms=kt["plain_ms"], bound_ms=kt["bound_ms"],
        bound_by=kt["bound_by"], library_ms=None))
    emit({"kernels": kernels})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
