"""Quickstart on the PyTorch/CUDA port: attest and verify one transformer
block over the wire.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

The counterpart of ``examples/quickstart.py`` on ``repro_torch`` (the same
model, query and policy; the same bytes on the wire).  The provider stands
up a ``ProofService``, publishes its content-addressed ``ModelCard`` and
answers a query with a serializable ``Attestation``; the client holds only
the wire bytes, its own query and the card.  Runs on ``cuda`` unless
``--device`` names another device.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch import api
from repro_torch.core import blocks as B
from repro_torch.core import chain as CH
from repro_torch.core import pcs as PCS
from repro_torch.device import resolve_device


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain PyTorch versions)")
    dev = resolve_device(ap.parse_args().device)
    t_start = time.time()
    cfg = B.BlockCfg(family="gpt2", d=16, dff=32, heads=2, kv_heads=2,
                     dh=8, seq=8)
    rng = np.random.default_rng(0)
    weights = [B.init_weights(cfg, rng)]
    x = np.clip(np.round(rng.normal(0, 0.5,
                                    (cfg.d_pad, cfg.seq)) * 256),
                -32768, 32767).astype(np.int64)
    policy = api.VerifyPolicy(pcs_queries=4)

    print(f"1. provider on {dev}: stand up the ProofService (weight setup "
          "runs once, amortized)...")
    t0 = time.time()
    with api.ProofService([cfg], weights, default_queries=4,
                          device=dev) as svc:
        card = svc.model_card
        print(f"   model card published in {time.time()-t0:.1f}s, "
              f"id={card.model_id}")

        print("2. provider: attest the quantized forward of the query...")
        att = svc.attest(x, policy)
        wire = att.to_bytes(device=dev)
        print(f"   proved in {att.prove_seconds:.1f}s — "
              f"{len(wire)/1024:.0f} KB on the wire "
              f"({att.bytes_per_layer/1024:.1f} KB/layer encoded)")

    print("3. client: reload from bytes, verify with only (query, card)...")
    att2 = api.Attestation.from_bytes(wire, device=dev)
    report = api.verify(att2, x, card, policy=policy, device=dev)
    print(f"   verified={report.ok} in {report.verify_seconds:.1f}s "
          f"({report.checked_layers} layers)")
    assert report.ok, report.reason

    print("4. client: a tampered wire copy is rejected with a reason...")
    bad = bytearray(wire)
    bad[len(bad) // 2] ^= 1
    rej = api.verify(bytes(bad), x, card, device=dev)
    print(f"   verified={rej.ok} — {rej.reason}")
    assert not rej.ok

    params = PCS.PCSParams(blowup=4, queries=policy.pcs_queries)
    rep = CH.soundness_bound([cfg], params)
    print("5. soundness (Thm 3.1 accounting): eps_layer <= "
          f"{min(rep.eps_layer, 1.0):.2g} at SMOKE params (queries=4 — "
          "demo speed, not security)")
    prod = PCS.PCSParams(blowup=8, queries=128)
    rep2 = CH.soundness_bound([cfg], prod)
    print("   production params (blowup=8, queries=128): eps_layer <= "
          f"2^-{rep2.bits_layer:.0f}")
    print(f"quickstart done in {time.time() - t_start:.1f}s")


if __name__ == "__main__":
    main()
