"""Gateway smoke drive on the PyTorch/CUDA port: server + concurrent
clients + out-of-process verification + clean shutdown.

    PYTHONPATH=src python examples/gateway_smoke_torch.py [--device cpu]

The counterpart of ``examples/gateway_smoke.py`` on ``repro_torch``.
Starts a gateway server on a loopback socket, runs >=4 concurrent clients
against it (stream-verified AND raw-wire round trips), then verifies
every attestation in a FRESH python process: nothing but wire bytes, the
query and the published model card cross the process boundary.  Finally
asserts the shutdown left no orphans: the listener is closed, no gateway
threads survive, and no child processes linger.  Runs on ``cuda`` unless
``--device`` names another device.
"""
import argparse
import os
import subprocess
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch import api
from repro_torch.core import blocks as B
from repro_torch.device import resolve_device
from repro_torch.gateway import AttestationGateway, GatewayClient, GatewayConfig

N_CLIENTS = 4

VERIFY_SNIPPET = """\
import sys
import numpy as np
from repro_torch import api

card = api.ModelCard.from_bytes(open(sys.argv[1], 'rb').read())
wires, queries = [], []
for i in range(int(sys.argv[2])):
    wires.append(open(sys.argv[3] + f'/att_{i}.bin', 'rb').read())
    queries.append(np.load(sys.argv[3] + f'/q_{i}.npy'))
policy = api.VerifyPolicy(pcs_queries=2)
reports = api.verify_batch(wires, queries, card, policies=policy,
                           device=sys.argv[4])
for i, rep in enumerate(reports):
    assert rep.ok, f'attestation {i} rejected: {rep.reason}'
print(f'fresh-process verify: {len(reports)} attestations ok')
"""


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
    policy = api.VerifyPolicy(pcs_queries=2)
    queries = [
        np.clip(np.round(rng.normal(0, 0.5, (cfg.d_pad, cfg.seq)) * 256),
                -32768, 32767).astype(np.int64) for _ in range(N_CLIENTS)]

    svc = api.ProofService([cfg] * L, weights, default_queries=2, workers=2,
                           device=dev)
    card = svc.model_card
    gw = AttestationGateway(
        svc, GatewayConfig(max_batch=N_CLIENTS, window_seconds=0.3))
    threads_before = {t.name for t in threading.enumerate()}

    with svc, gw:
        server = gw.serve(port=0)
        host, port = server.address
        print(f"gateway up on {host}:{port}; {N_CLIENTS} concurrent "
              "clients...", flush=True)

        wires, reports, errors = {}, {}, []

        def client(i):
            try:
                with GatewayClient(host, port, client_id=f"smoke-{i}") as c:
                    wires[i], info = c.attest_bytes(queries[i], policy)
                with GatewayClient(host, port, client_id=f"smoke-{i}",
                                   device=dev) as c:
                    reports[i] = c.attest_verify(queries[i], card, policy)
            except BaseException as e:  # noqa: BLE001 — smoke must report, not hang
                errors.append((i, e))

        t0 = time.time()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(N_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors
        for i in range(N_CLIENTS):
            assert reports[i].ok, f"client {i}: {reports[i].reason}"
        snap = gw.metrics_snapshot()
        co = snap["coalesce"]
        print(f"{2 * N_CLIENTS} round trips in {time.time() - t0:.1f}s; "
              f"stream-verified ok; coalesced {co['coalesced_queries']} "
              f"queries ({co['solo_queries']} solo), peak queue depth "
              f"{snap['queue_depth_peak']}", flush=True)

        # out-of-process verification: a fresh interpreter holding only
        # wire bytes + queries + the model card
        with tempfile.TemporaryDirectory() as td:
            with open(os.path.join(td, "card.bin"), "wb") as f:
                f.write(card.to_bytes())
            for i in range(N_CLIENTS):
                with open(os.path.join(td, f"att_{i}.bin"), "wb") as f:
                    f.write(wires[i])
                np.save(os.path.join(td, f"q_{i}.npy"), queries[i])
            env = dict(os.environ)
            env["PYTHONPATH"] = os.path.join(
                os.path.dirname(__file__), "..", "src") + os.pathsep + \
                env.get("PYTHONPATH", "")
            out = subprocess.run(
                [sys.executable, "-c", VERIFY_SNIPPET,
                 os.path.join(td, "card.bin"), str(N_CLIENTS), td, str(dev)],
                env=env, capture_output=True, text=True, timeout=900)
            sys.stdout.write(out.stdout)
            assert out.returncode == 0, out.stderr

    # clean shutdown: listener closed, no gateway threads, no orphans
    import socket as socketlib
    try:
        socketlib.create_connection((host, port), timeout=1).close()
        raise AssertionError("listener still accepting after close()")
    except (ConnectionRefusedError, OSError):
        pass
    time.sleep(0.5)
    leftover = {t.name for t in threading.enumerate()} - threads_before
    leftover = {n for n in leftover if n.startswith("gateway")}
    assert not leftover, f"orphan gateway threads: {leftover}"
    import multiprocessing
    kids = multiprocessing.active_children()
    assert not kids, f"orphan child processes: {kids}"
    print("shutdown clean: listener closed, no orphan threads/processes")
    print(f"GATEWAY SMOKE PASS in {time.time() - t_start:.1f}s")


if __name__ == "__main__":
    main()
