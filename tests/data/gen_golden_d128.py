"""Regenerate the d=128 golden of the served chain (run from the repo root):

    PYTHONPATH=src python tests/data/gen_golden_d128.py

Builds the first layer of chip_smoke's served chain, the paper's headline
width (``BlockCfg(family="gpt2", d=128, dff=512, heads=4, kv_heads=4,
dh=32, seq=8)``, weights the first ``B.init_weights(cfg,
np.random.default_rng(0))`` draw, ``pcs_blowup=4``, ``default_queries=16``,
``workers=1``, ``name="chip-smoke"``), attests chip_smoke's
``serve_query(0)`` under ``VerifyPolicy(pcs_queries=16)`` and keeps, under
tests/data/:

    golden_d128_v2.bin    the v2 attestation, ``prove_seconds`` set to 0
    golden_d128_card.bin  the ModelCard

One layer, not the chain's four: it already runs every gadget at d=128
(attention, MLP, LogUp, the batched openings) and the chain's boundary
adjacency is covered by the toy goldens; four layers would take hours of
JAX on a CPU.  ``prove_seconds`` is the attestation's one telemetry field;
every other byte follows from the fixed seeds and Fiat-Shamir.  Nothing
is written unless ``repro.api.verify`` accepts the attestation.  The prove
and the self-check take long on a CPU (with the XLA flag below): run it
detached.
"""
import os
import sys
import time

# XLA:CPU's fusion emitters make the verifier's unrolled eq evaluations
# (``repro.core.mle.eq_eval``) take seconds to minutes a call; without them
# a call takes under a millisecond after its compile.  Integer results are
# the same either way.
os.environ.setdefault("XLA_FLAGS", "--xla_cpu_use_fusion_emitters=false")

import numpy as np                                      # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

from repro import api                                   # noqa: E402
from repro.core import blocks as B                      # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CFG = B.BlockCfg(family="gpt2", d=128, dff=512, heads=4, kv_heads=4, dh=32,
                 seq=8)
PCS_BLOWUP = 4
PCS_QUERIES = 16
SEED = 0


def query(q: int) -> np.ndarray:
    """chip_smoke's ``serve_query(q)``."""
    qrng = np.random.default_rng(SEED + 1 + q)
    return np.clip(np.round(qrng.normal(0, 0.5, (CFG.d_pad, CFG.seq)) * 256),
                   -32768, 32767).astype(np.int64)


def main():
    weights = [B.init_weights(CFG, np.random.default_rng(SEED))]
    x = query(0)
    policy = api.VerifyPolicy(pcs_queries=PCS_QUERIES)
    t0 = time.time()
    with api.ProofService([CFG], weights, pcs_blowup=PCS_BLOWUP,
                          default_queries=PCS_QUERIES, workers=1,
                          name="chip-smoke") as svc:
        card = svc.model_card.to_bytes()
        print(f"setup: {time.time() - t0:.1f} s", flush=True)
        t1 = time.time()
        att = svc.attest(x, policy)
        print(f"attest: {time.time() - t1:.1f} s", flush=True)
    att.prove_seconds = 0.0
    att.__dict__.pop("_wire_cache", None)
    v2 = att.to_bytes(2)
    t1 = time.time()
    rep = api.verify(v2, x, card, policy=policy)
    print(f"self-check: ok={rep.ok} reason={rep.reason!r} "
          f"({time.time() - t1:.1f} s)", flush=True)
    assert rep.ok
    out = {"golden_d128_v2.bin": v2, "golden_d128_card.bin": card}
    for name, data in out.items():
        with open(os.path.join(HERE, name), "wb") as fh:
            fh.write(data)
        print(f"{name}: {len(data)} B")
    print(f"total: {time.time() - t0:.1f} s")


if __name__ == "__main__":
    main()
