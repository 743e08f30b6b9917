"""Verifiable serving end-to-end on the PyTorch/CUDA port's attestation API.

    PYTHONPATH=src python examples/verifiable_serving_torch.py [--device cpu]

The counterpart of ``examples/verifiable_serving.py`` on ``repro_torch``:
a 2-layer quantized model serves queries through a resident
``ProofService`` (staged ProverEngine + WeightCommitCache, paper §3.3 /
§4); the provider publishes one content-addressed ``ModelCard``, each
query returns a serializable ``Attestation``, and the client verifies
with ``api.verify`` holding nothing but its query and the card,
including the Eq. 3 adjacency chain and the query binding.  Also shows
setup amortization across queries, Fisher-guided selective verification
(§5), rejection of spliced / replayed / tampered attestations, each with
a reason string, and the same service behind the gateway.  Runs on
``cuda`` unless ``--device`` names another device.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import dataclasses
import numpy as np

from repro_torch import api
from repro_torch.core import blocks as B
from repro_torch.core import fisher as FI
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
    L = 2
    rng = np.random.default_rng(0)
    weights = [B.init_weights(cfg, rng) for _ in range(L)]
    imp = np.array([3.0, 1.0])
    scores = FI.FisherScores(imp, np.ones(L), imp)
    policy = api.VerifyPolicy(pcs_queries=8)

    def query_input():
        return np.clip(np.round(rng.normal(0, 0.5,
                                           (cfg.d_pad, cfg.seq)) * 256),
                       -32768, 32767).astype(np.int64)

    svc = api.ProofService([cfg] * L, weights, default_queries=8,
                           workers=2, fisher_scores=scores, device=dev)
    cache = svc.weight_cache
    with svc:
        print("provider publishes its model card (weight roots + LUT "
              "digests + PCS rate)...")
        card = svc.model_card
        print(f"model_id={card.model_id} ({card.n_layers} layers)")

        print("\nclient query arrives; provider attests via the resident "
              f"service ({svc.workers} prover workers)...")
        x0 = query_input()
        t0 = time.time()
        att = svc.attest(x0, policy, tokens=np.arange(5))
        wire = att.to_bytes(device=dev)
        print(f"full attestation ({L} layers) in {time.time()-t0:.1f}s "
              f"(setup included), {len(wire)/1024:.0f} KB on the wire")

        print("client verifies from bytes (Eq. 3 adjacency + query "
              "binding on its own x0)...")
        rep = api.verify(wire, x0, card, policy=policy, device=dev)
        print(f"verified={rep.ok} in {rep.verify_seconds:.1f}s")
        assert rep.ok, rep.reason

        print("\nsecond query, same model: weight setup amortized "
              "(WeightCommitCache)...")
        x1 = query_input()
        t0 = time.time()
        att1 = svc.attest(x1, policy)
        print(f"attested in {time.time()-t0:.1f}s — cache hits "
              f"{cache.hits}, misses {cache.misses} (range-proof setup "
              "ran only for query 1)")
        assert cache.misses == L

        print("\nselective verification (paper §5): 50% budget...")
        sel = dataclasses.replace(policy, budget=0.5)
        att_sel = svc.attest(x1, sel)
        cov = FI.importance_coverage(scores, att_sel.proved_layers)
        print(f"proved layers {att_sel.proved_layers}: coverage "
              f"{cov*100:.0f}% of Fisher mass at 50% cost")
        rep_sel = api.verify(att_sel, x1, card, policy=sel, device=dev)
        assert rep_sel.ok, rep_sel.reason

    print("\nmix-and-match attack (splice a layer proof from another "
          "query)...")
    frank = dataclasses.replace(
        att, proof=dataclasses.replace(
            att.proof,
            layer_proofs=[att.proof.layer_proofs[0],
                          att1.proof.layer_proofs[1]]))
    rep = api.verify(frank, x0, card, device=dev)
    print(f"rejected={not rep.ok} — {rep.reason}")
    assert not rep.ok

    print("\nquery-binding attack (replay query-1 attestation for "
          "query 2)...")
    rep = api.verify(att, x1, card, device=dev)
    print(f"rejected={not rep.ok} — {rep.reason}")
    assert not rep.ok

    print("\nwire tampering (bit flip in transit)...")
    bad = bytearray(wire)
    bad[-100] ^= 0x40
    rep = api.verify(bytes(bad), x0, card, device=dev)
    print(f"rejected={not rep.ok} — {rep.reason}")
    assert not rep.ok

    print("\npolicy downgrade (attacker rewrites pcs_queries)...")
    weak = dataclasses.replace(
        att, policy=dataclasses.replace(att.policy, pcs_queries=2))
    rep = api.verify(weak, x0, card, policy=policy, device=dev)
    print(f"rejected={not rep.ok} — {rep.reason}")
    assert not rep.ok

    gateway_demo(cfg, L, weights, policy, query_input, dev)
    print(f"\nverifiable serving done in {time.time() - t_start:.1f}s")


def gateway_demo(cfg, L, weights, policy, query_input, dev):
    """The same service behind the network gateway: concurrent clients
    over sockets, coalesced commits, batch verify, visible backpressure."""
    import threading

    from repro_torch.gateway import (AdmissionRejected, AttestationGateway,
                                     GatewayClient, GatewayConfig)

    print("\n--- gateway: the socket path ---")
    svc = api.ProofService([cfg] * L, weights, default_queries=8, workers=2,
                           device=dev)
    card = svc.model_card
    gw = AttestationGateway(svc, GatewayConfig(max_batch=4,
                                               window_seconds=0.2))
    with svc, gw:
        server = gw.serve(port=0)
        host, port = server.address
        print(f"gateway serving on {host}:{port}; 4 concurrent clients "
              "connect...")

        queries, reports, wires = [query_input() for _ in range(4)], {}, {}

        def client(i):
            with GatewayClient(host, port, client_id=f"client-{i}",
                               device=dev) as cli:
                # stream-verified round trip: LAYR frames are checked as
                # they arrive, the client never holds the whole proof
                reports[i] = cli.attest_verify(queries[i], card, policy)
            with GatewayClient(host, port, client_id=f"client-{i}") as cli:
                wires[i], _ = cli.attest_bytes(queries[i], policy)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i in range(4):
            assert reports[i].ok, reports[i].reason
        snap = gw.metrics_snapshot()
        co = snap["coalesce"]
        print(f"all 4 stream-verified ok; {co['coalesced_queries']} queries "
              f"shared coalesced commit windows ({co['solo_queries']} solo)")

        print("\nbatch verify (amortized LUT digests + audit selectors)...")
        t0 = time.time()
        batch_reports = api.verify_batch(
            [wires[i] for i in range(4)], [queries[i] for i in range(4)],
            card, policies=policy, device=dev)
        assert all(r.ok for r in batch_reports), \
            [r.reason for r in batch_reports]
        print(f"4 attestations verified in {time.time()-t0:.1f}s "
              "(one card decode, one LUT audit, shared selectors)")

    print("\nbackpressure on the wire (queue depth 1)...")
    tiny = api.ProofService([cfg] * L, weights, default_queries=8, workers=2,
                            device=dev)
    with tiny, AttestationGateway(
            tiny, GatewayConfig(max_queue_depth=1, max_batch=1,
                                window_seconds=0.05)) as gw2:
        server = gw2.serve(port=0)
        host, port = server.address
        with GatewayClient(host, port, client_id="g1") as c1, \
                GatewayClient(host, port, client_id="g2") as c2:
            c1._request(query_input(), policy, None)  # -> proving window
            time.sleep(0.5)                           # dispatcher takes it
            c2._request(query_input(), policy, None)  # queued: depth 1/1
            rejected = False
            try:
                with GatewayClient(host, port, client_id="late") as c3:
                    c3.attest_bytes(query_input(), policy)
            except AdmissionRejected as rej:
                rejected = True
                print(f"late client rejected on the wire: {rej}")
                assert rej.reason == "queue_full"
            assert rejected, "expected a queue_full rejection"
            c1._stream_response(lambda b: None)       # drain both proofs
            c2._stream_response(lambda b: None)
    print("gateway drained and closed cleanly")


if __name__ == "__main__":
    main()
