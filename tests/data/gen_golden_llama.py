"""Regenerate the llama golden wire-format vectors (run from the repo root):

    PYTHONPATH=src python tests/data/gen_golden_llama.py

Produces, under tests/data/:

    golden_llama_card.bin   ModelCard envelope for the 1-layer llama model
    golden_llama_query.bin  codec envelope holding the canonical query
    golden_llama_v1.bin     legacy v1 attestation envelope
    golden_llama_v2.bin     v2 framed stream

The model is one llama block with grouped-query attention (2 query heads
sharing 1 KV head), RMSNorm, RoPE and the SiLU-gated MLP.  The files are
written only after ``repro.api.verify`` accepts the v2 bytes.  The prove
takes minutes on a CPU and the self-check verify longer, so run it
detached.  Like tests/data/gen_golden.py, everything derives from fixed
seeds and Fiat-Shamir, so the bytes are reproducible.
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

from repro import api                                   # noqa: E402
from repro.api import codec                             # noqa: E402
from repro.core import blocks as B                      # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CFG = B.BlockCfg(family="llama", d=8, dff=16, heads=2, kv_heads=1, dh=4,
                 seq=4)
QUERIES = 1


def main():
    rng = np.random.default_rng(4321)
    weights = [B.init_weights(CFG, rng)]
    qrng = np.random.default_rng(8765)
    query = np.clip(
        np.round(qrng.normal(0, 0.5, (CFG.d_pad, CFG.seq)) * 256),
        -32768, 32767).astype(np.int64)
    policy = api.VerifyPolicy(pcs_queries=QUERIES)
    t0 = time.time()
    with api.ProofService([CFG], weights, default_queries=QUERIES,
                          workers=1, name="golden-llama") as svc:
        att = svc.attest(query, policy,
                         tokens=np.arange(3, dtype=np.int32))
        card = svc.model_card.to_bytes()
    print(f"prove: {time.time() - t0:.1f} s", flush=True)
    out = {
        "golden_llama_card.bin": card,
        "golden_llama_query.bin": codec.pack(b"QURY", query),
        "golden_llama_v1.bin": att.to_bytes(1),
        "golden_llama_v2.bin": att.to_bytes(2),
    }
    t0 = time.time()
    rep = api.verify(out["golden_llama_v2.bin"], query, card, policy=policy)
    print(f"self-check: ok={rep.ok} reason={rep.reason!r} "
          f"({time.time() - t0:.1f} s)", flush=True)
    assert rep.ok
    for name, data in out.items():
        with open(os.path.join(HERE, name), "wb") as fh:
            fh.write(data)
        print(f"{name}: {len(data)} B")


if __name__ == "__main__":
    main()
