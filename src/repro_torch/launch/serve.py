"""Verifiable serving (mirrors ``repro.launch.serve``): batched decode with
``--with-proof``.

Serving runs the LUT-approximated float model (``use_lut=True``) to
generate tokens; when a client asks for verification, a quantized query
bound to the served tokens is proved layer by layer through
``repro_torch.api`` and written to wire files that a fresh process
verifies.  The public proving surface is ``repro_torch.api``;
``prove_query`` and ``verify_response`` are the JAX package's legacy
shims, kept for its callers.

    python -m repro_torch.launch.serve --arch gpt2_small --with-proof \\
        --emit att.bin
    python -m repro_torch.launch.serve --verify-file att.bin --stream-verify

Everything runs on ``cuda`` unless ``--device`` (or ``device=``) names
another device; without a card it raises.  Greedy decoding is the path
held against the JAX package; temperature sampling draws from an explicit
``torch.Generator``.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import api
from repro_torch.configs import get_arch
from repro_torch.core import blocks as BLK
from repro_torch.core import chain as CHAIN
from repro_torch.core import fisher as FISH
from repro_torch.core import layer_proof as LPF
from repro_torch.core import pcs as PCS
from repro_torch.device import resolve_device
from repro_torch.models import model as MDL
from repro_torch.runtime.engine import ProverEngine, WeightCommitCache


@dataclasses.dataclass
class ServeCfg:
    max_new_tokens: int = 16
    with_proof: bool = False
    verify_budget: float = 1.0        # fraction of layers proven
    selector: str = "fisher"          # fisher | random | uniform
    audit_random: int = 0             # extra random layers (paper §5.2)
    pcs_queries: int = 16
    temperature: float = 0.0
    prove_workers: int = 2            # prover fleet size (engine stage 3)
    prove_backend: str = "thread"     # thread | process


@torch.no_grad()
def generate(cfg, sh, params, prompt: torch.Tensor, serve_cfg: ServeCfg,
             gen: Optional[torch.Generator] = None, use_lut: bool = True,
             stats: Optional[dict] = None) -> torch.Tensor:
    """Greedy (or, with a temperature and ``gen``, sampled) decode with KV
    caches, LUT ops on unless ``use_lut`` is False; runs where ``prompt``
    lies.  A ``stats`` dict receives the prefill's and the decode steps'
    wall seconds (the device synchronised at each end).  A stacked
    parameter tree (``scan_layers``) decodes through stacked caches."""
    B, S = prompt.shape
    dev = prompt.device
    clock = _Clock(dev, stats)
    max_len = S + serve_cfg.max_new_tokens
    caches = MDL.make_caches(cfg, sh, B, max_len, dev,
                             scan_layers="blocks" in params)
    logits, caches, _ = MDL.forward(cfg, sh, params, prompt,
                                    caches=caches, use_lut=use_lut)
    tok = torch.argmax(logits[:, -1, :cfg.vocab], dim=-1)[:, None]
    clock.lap("prefill_seconds")
    out = [tok]
    pos = torch.full((B,), S, dtype=torch.int64, device=dev)
    for _ in range(serve_cfg.max_new_tokens - 1):
        lg, caches = MDL.decode_step(cfg, sh, params, tok, pos, caches,
                                     use_lut=use_lut)
        if serve_cfg.temperature > 0 and gen is not None:
            probs = torch.softmax(lg[:, :cfg.vocab].float()
                                  / serve_cfg.temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=gen)
        else:
            tok = torch.argmax(lg[:, :cfg.vocab], dim=-1)[:, None]
        pos = pos + 1
        out.append(tok)
    clock.lap("decode_seconds")
    if stats is not None:
        stats["decode_steps"] = serve_cfg.max_new_tokens - 1
    return torch.cat(out, dim=1)


class _Clock:
    """Wall seconds between laps, the device synchronised at each lap;
    does nothing without a ``stats`` dict."""

    def __init__(self, device: torch.device, stats: Optional[dict]):
        self.device, self.stats = device, stats
        self.t = self._now() if stats is not None else 0.0

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def lap(self, key: str) -> None:
        if self.stats is not None:
            now = self._now()
            self.stats[key] = now - self.t
            self.t = now


# ---------------------------------------------------------------------------
# Proof generation for a served query (quantized replay).
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class VerifiableResponse:
    """Legacy in-process proof carrier; ``api.Attestation`` is the
    serializable form for anything that crosses a process."""
    tokens: np.ndarray
    model_proof: Optional[CHAIN.ModelProof]
    proved_layers: List[int]
    prove_seconds: float
    proof_bytes: int
    in_root: Optional[np.ndarray] = None   # query binding (Eq. 3): c_0
    out_root: Optional[np.ndarray] = None  # and c_L of this query's chain
    engine_report: Optional[object] = None
    pcs_queries: Optional[int] = None      # params the prover used


def select_layers(serve_cfg: ServeCfg, L: int,
                  fisher_scores: Optional[FISH.FisherScores] = None,
                  seed: int = 0) -> List[int]:
    """Selective-verification layer choice (paper §5), through the one
    implementation in ``api.select_layers``."""
    policy = api.VerifyPolicy(budget=serve_cfg.verify_budget,
                              selector=serve_cfg.selector,
                              audit_random=serve_cfg.audit_random,
                              pcs_queries=serve_cfg.pcs_queries,
                              seed=seed)
    return api.select_layers(policy, L, fisher_scores)


def prove_query(block_cfgs: List[BLK.BlockCfg],
                weights_raw, wt_commits, x0: np.ndarray,
                serve_cfg: ServeCfg,
                fisher_scores: Optional[FISH.FisherScores] = None,
                seed: int = 0,
                tokens: Optional[np.ndarray] = None,
                weight_cache: Optional[WeightCommitCache] = None,
                fail_claims=None,
                engine: Optional[ProverEngine] = None,
                device=None) -> VerifiableResponse:
    """Legacy shim over the staged ProverEngine (use
    ``api.ProofService.attest``).  The response carries the chain's c_0
    and c_L so that ``verify_response`` enforces the query binding.  A
    long-lived ``engine`` is the caller's to close."""
    params = PCS.PCSParams(queries=serve_cfg.pcs_queries)
    subset = select_layers(serve_cfg, len(block_cfgs), fisher_scores, seed)
    own_engine = engine is None
    if own_engine:
        engine = ProverEngine(block_cfgs, weights_raw, params,
                              wt_commits=wt_commits,
                              weight_cache=weight_cache,
                              workers=serve_cfg.prove_workers,
                              fail_claims=fail_claims,
                              backend=serve_cfg.prove_backend,
                              device=device)
    t0 = time.time()
    try:
        proof, report = engine.prove(x0, layer_subset=subset)
    finally:
        if own_engine:
            engine.close()
    dt = time.time() - t0
    return VerifiableResponse(
        tokens=np.asarray(tokens) if tokens is not None else np.zeros(0),
        model_proof=proof, proved_layers=list(subset), prove_seconds=dt,
        proof_bytes=proof.size_bytes(),
        in_root=proof.boundary_roots[0], out_root=proof.boundary_roots[-1],
        engine_report=report, pcs_queries=serve_cfg.pcs_queries)


def verify_response(block_cfgs, resp: VerifiableResponse, wt_roots,
                    pcs_queries: Optional[int] = None,
                    x0: Optional[np.ndarray] = None,
                    device=None) -> bool:
    """Client-side check: layer proofs, Eq. 3 adjacency and the query
    binding.  ``pcs_queries`` defaults to the prover's count (on the
    response).  The input binding means something only when the client
    passes its own ``x0``: c_0 is then recomputed from it."""
    if pcs_queries is None:
        pcs_queries = resp.pcs_queries if resp.pcs_queries else 16
    params = PCS.PCSParams(queries=pcs_queries)
    in_root = resp.in_root
    if x0 is not None:
        in_root = LPF.commit_boundary(block_cfgs[0], x0, params,
                                      device=device).root
    return CHAIN.verify_model(block_cfgs, resp.model_proof, wt_roots,
                              params, in_root=in_root,
                              out_root=resp.out_root, device=device)


# ---------------------------------------------------------------------------
# CLI: generate, optionally attest to a wire file, verify a wire file.
# ---------------------------------------------------------------------------
def _demo_chain(layers: int, d: int = 16, seed: int = 0):
    """Tiny provable block chain for the CLI's attestation demo (weights in
    the circuit's provable ranges)."""
    cfg = BLK.BlockCfg(family="gpt2", d=d, dff=2 * d, heads=2, kv_heads=2,
                       dh=8, seq=8)
    rng = np.random.default_rng(seed)
    weights = [BLK.init_weights(cfg, rng) for _ in range(layers)]
    return [cfg] * layers, weights


def _query_from_tokens(cfg: BLK.BlockCfg, tokens: np.ndarray) -> np.ndarray:
    """Deterministic quantized query input derived from the served tokens
    (binds the demo attestation to this generation); numpy seeding, so
    the JAX package derives the same query from the same tokens."""
    rng = np.random.default_rng(np.asarray(tokens).astype(np.uint64).sum())
    x = np.round(rng.normal(0, 0.5, (cfg.d_pad, cfg.seq)) * 256)
    return np.clip(x, -32768, 32767).astype(np.int64)


def emit_attestation(path: str, tokens: np.ndarray, policy: api.VerifyPolicy,
                     layers: int = 2, workers: int = 2,
                     backend: str = "thread", wire_version: int = 2,
                     device=None) -> api.VerifyReport:
    """Attest the demo chain for this generation and write the wire files:
    ``path`` (attestation), ``path + ".card"`` (model card),
    ``path + ".policy"`` (the client's pinned policy) and
    ``path + ".query.npy"`` (the bound query).  ``wire_version=2`` is the
    framed stream a ``--stream-verify`` client checks as it reads; 1 the
    legacy envelope.  Returns the self-check's report."""
    dev = resolve_device(device)
    cfgs, weights = _demo_chain(layers)
    x0 = _query_from_tokens(cfgs[0], tokens)
    with api.ProofService(cfgs, weights, workers=workers, backend=backend,
                          default_queries=policy.pcs_queries,
                          device=dev) as svc:
        card = svc.model_card
        att = svc.attest(x0, policy, tokens=tokens)
    wire = att.to_bytes(wire_version, device=dev)
    with open(path, "wb") as f:
        f.write(wire)
    with open(path + ".card", "wb") as f:
        f.write(card.to_bytes())
    # the client-requested policy, pinned apart from the attestation: a
    # re-encoded attestation with a downgraded embedded policy must fail
    with open(path + ".policy", "wb") as f:
        f.write(api.pack(b"PLCY", policy))
    np.save(path + ".query.npy", x0)
    kb_layer = len(wire) / max(1, len(att.proved_layers)) / 1024
    print(f"attestation: {path} (wire v{wire_version}, {len(wire)} bytes on "
          f"the wire, {kb_layer:.1f} KB/layer, proved layers "
          f"{att.proved_layers})")
    return api.verify(att, x0, card, policy=policy, device=dev)


def verify_attestation_file(path: str, stream: bool = False,
                            chunk_size: int = 1 << 16,
                            device=None) -> api.VerifyReport:
    """Stateless client: reload the wire files and verify, pinning the
    requested policy.  With ``stream=True`` the attestation goes to a
    ``StreamingVerifier`` in ``chunk_size`` pieces, each layer checked as
    it lands; the verdict equals the one-shot path's."""
    dev = resolve_device(device)
    with open(path + ".card", "rb") as f:
        card_bytes = f.read()
    x0 = np.load(path + ".query.npy")
    policy = None
    if os.path.exists(path + ".policy"):
        with open(path + ".policy", "rb") as f:
            policy = api.unpack(b"PLCY", f.read())
    if stream:
        sv = api.StreamingVerifier(x0, card_bytes, policy=policy, device=dev)
        with open(path, "rb") as f:
            while True:
                chunk = f.read(chunk_size)
                if not chunk:
                    break
                for rep in sv.feed(chunk):
                    if not rep.complete:
                        print(f"  ... {rep.checked_layers} layer(s) "
                              f"verified, {rep.attestation_bytes} bytes in")
        return sv.finish()
    with open(path, "rb") as f:
        att_bytes = f.read()
    return api.verify(att_bytes, x0, card_bytes, policy=policy, device=dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2_small")
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--with-proof", action="store_true")
    ap.add_argument("--verify-budget", type=float, default=1.0)
    ap.add_argument("--selector", default="fisher")
    ap.add_argument("--pcs-queries", type=int, default=8)
    ap.add_argument("--proof-layers", type=int, default=2)
    ap.add_argument("--emit", metavar="attestation.bin", default=None,
                    help="with --with-proof: write the attestation + model "
                         "card + bound query to wire files")
    ap.add_argument("--verify-file", metavar="attestation.bin", default=None,
                    help="verify a previously emitted attestation and exit")
    ap.add_argument("--wire-version", type=int, default=2, choices=(1, 2),
                    help="attestation container: 2 = framed/deduplicated "
                         "stream (default), 1 = legacy envelope")
    ap.add_argument("--stream-verify", action="store_true",
                    help="with --verify-file: feed the attestation to the "
                         "StreamingVerifier chunk by chunk")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: cuda; 'cpu' "
                         "runs the kernels' plain PyTorch versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.emit:
        args.with_proof = True            # --emit implies --with-proof

    if args.verify_file:
        rep = verify_attestation_file(args.verify_file,
                                      stream=args.stream_verify, device=dev)
        print(f"verified={rep.ok}" +
              (f" ({rep.checked_layers} layers, "
               f"{rep.verify_seconds:.1f}s)" if rep.ok
               else f" reason: {rep.reason}"))
        raise SystemExit(0 if rep.ok else 1)

    bundle = get_arch(args.arch)
    cfg = bundle.smoke
    sh = cfg.shard_cfg(dp=("data",), tp_size=1, dp_size=1)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = MDL.init(cfg, sh, gen, dev)
    prompt = torch.randint(0, cfg.vocab, (2, 16), generator=gen, device=dev)
    sc = ServeCfg(max_new_tokens=args.max_new_tokens,
                  with_proof=args.with_proof,
                  verify_budget=args.verify_budget, selector=args.selector,
                  pcs_queries=args.pcs_queries)
    # int32, the dtype of the JAX package's tokens (the attestation
    # carries them)
    toks = generate(cfg, sh, params, prompt, sc).cpu().numpy().astype(np.int32)
    print("generated:", toks)
    if args.with_proof and args.emit:
        policy = api.VerifyPolicy(budget=args.verify_budget,
                                  selector=args.selector,
                                  pcs_queries=args.pcs_queries)
        rep = emit_attestation(args.emit, toks.reshape(-1), policy,
                               layers=args.proof_layers,
                               wire_version=args.wire_version, device=dev)
        print(f"self-check verified={rep.ok}")
        raise SystemExit(0 if rep.ok else 1)
    elif args.with_proof:
        print("(pass --emit attestation.bin to write a verifiable "
              "attestation)")


if __name__ == "__main__":
    main()
