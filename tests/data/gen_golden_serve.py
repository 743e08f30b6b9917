"""Regenerate the serving-CLI golden wire files (run from the repo root):

    PYTHONPATH=src python tests/data/gen_golden_serve.py

Runs ``repro.launch.serve.emit_attestation`` once, on fixed tokens
(``np.arange(16)``), over the CLI's 2-layer demo chain with
``VerifyPolicy(pcs_queries=8)``, and keeps what it writes, under
tests/data/:

    golden_serve_v2.bin            the v2 attestation, as the CLI wrote it
    golden_serve_v2.bin.card       the ModelCard
    golden_serve_v2.bin.policy     the client's pinned policy
    golden_serve_v2.bin.query.npy  the query bound to the tokens
    golden_serve_v1.bin            the same attestation as a v1 envelope

The CLI writes its files before it checks them, so this script lets it
write into a scratch directory and copies them here only after
``repro.api.verify`` accepts the attestation (the self-check
``emit_attestation`` runs and returns; the v2 bytes written are asserted
to be that attestation's).  The v1 envelope is encoded
from the attestation object ``ProofService.attest`` returned (recorded
on its way out): decoding the v2 stream and encoding v1 from that would
not do, since a decoded v2 tape has its opened columns moved out to the
per-root multiproofs and a v1 envelope carries them inline.
The attestation carries the prove's wall seconds (``prove_seconds``,
telemetry); every other byte follows from the fixed seeds and
Fiat-Shamir.  The prove and the self-check take minutes on a CPU (with
the XLA flag below; hours without it): run it detached.
"""
import os
import shutil
import sys
import tempfile
import time

# XLA:CPU's fusion emitters make the verifier's unrolled eq evaluations
# (``repro.core.mle.eq_eval``) take ~2 s a call at 14 variables and
# minutes at 17; without them a call takes under a millisecond after its
# compile.  Integer results are the same either way.
os.environ.setdefault("XLA_FLAGS", "--xla_cpu_use_fusion_emitters=false")

import numpy as np                                      # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

from repro import api                                   # noqa: E402
from repro.launch import serve                          # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
TOKENS = np.arange(16)
LAYERS = 2
PCS_QUERIES = 8
SUFFIXES = ("", ".card", ".policy", ".query.npy")


def main():
    attested = []
    attest = api.ProofService.attest

    def recording_attest(self, *args, **kw):
        att = attest(self, *args, **kw)
        attested.append(att)
        return att
    api.ProofService.attest = recording_attest

    policy = api.VerifyPolicy(pcs_queries=PCS_QUERIES)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "att.bin")
        t0 = time.time()
        rep = serve.emit_attestation(path, TOKENS, policy, layers=LAYERS)
        print(f"emit + self-check: ok={rep.ok} reason={rep.reason!r} "
              f"({time.time() - t0:.1f} s)", flush=True)
        assert rep.ok and len(attested) == 1
        with open(path, "rb") as fh:
            assert fh.read() == attested[0].to_bytes(2)
        v1 = attested[0].to_bytes(1)
        for suffix in SUFFIXES:
            shutil.copyfile(path + suffix,
                            os.path.join(HERE, "golden_serve_v2.bin" + suffix))
        with open(os.path.join(HERE, "golden_serve_v1.bin"), "wb") as fh:
            fh.write(v1)
    for suffix in SUFFIXES:
        name = "golden_serve_v2.bin" + suffix
        print(f"{name}: {os.path.getsize(os.path.join(HERE, name))} B")
    print(f"golden_serve_v1.bin: {len(v1)} B")


if __name__ == "__main__":
    main()
