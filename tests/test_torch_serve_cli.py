"""The serving CLI of repro_torch (``repro_torch.launch.serve``) against the
JAX package's: ``emit_attestation`` writes the bytes that
tests/data/gen_golden_serve.py had ``repro.launch.serve.emit_attestation``
write (the demo chain on the tokens 0..15), ``verify_attestation_file``
accepts those JAX-written files one-shot and streamed, and the CLI's emit
and verify run in fresh processes.  Nothing is proved on JAX here."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.launch import serve as S

ROOT = os.path.join(os.path.dirname(__file__), "..")
DATA = os.path.join(os.path.dirname(__file__), "data")
GOLD = os.path.join(DATA, "golden_serve_v2.bin")
SIDECARS = (".card", ".policy", ".query.npy")
# the arguments of tests/data/gen_golden_serve.py
TOKENS, LAYERS, PCS_QUERIES = np.arange(16), 2, 8


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The proves are thousands of tiny ops, which torch's intra-op
    threads only slow down on a CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


def test_emit_attestation_writes_the_golden(tmp_path, monkeypatch):
    """The port's files equal the JAX-written ones: the card, the policy
    and the query byte for byte; the attestation too once its
    ``prove_seconds`` (wall-clock telemetry) is the golden's, in v2 as
    written and as a v1 envelope.  The v1 bytes are encoded from the
    attestation object ``ProofService.attest`` returned, as the generator
    encodes them (a decoded v2 tape no longer carries its opened columns
    inline)."""
    attested = []
    attest = api.ProofService.attest

    def recording_attest(self, *args, **kw):
        attested.append(attest(self, *args, **kw))
        return attested[-1]
    monkeypatch.setattr(api.ProofService, "attest", recording_attest)
    path = str(tmp_path / "att.bin")
    rep = S.emit_attestation(path, TOKENS,
                             api.VerifyPolicy(pcs_queries=PCS_QUERIES),
                             layers=LAYERS, device="cpu")
    assert rep.ok and rep.checked_layers == LAYERS
    for suffix in SIDECARS:
        assert _read(path + suffix) == _read(GOLD + suffix), suffix
    gold_v2 = _read(GOLD)
    (att,) = attested
    assert att.to_bytes(2, device="cpu") == _read(path)
    att.prove_seconds = api.Attestation.from_bytes(
        gold_v2, device="cpu").prove_seconds
    att.__dict__.pop("_wire_cache", None)
    assert att.to_bytes(2, device="cpu") == gold_v2
    assert att.to_bytes(1, device="cpu") == \
        _read(os.path.join(DATA, "golden_serve_v1.bin"))


@pytest.mark.parametrize("stream", [False, True])
def test_verify_attestation_file_accepts_the_jax_golden(tmp_path, stream):
    """One-shot: the v2 file and its v1 envelope (beside the same
    sidecars).  Streamed: the v2 file, and a copy with a flipped byte,
    which is rejected."""
    rep = S.verify_attestation_file(GOLD, stream=stream, device="cpu")
    assert rep.ok and rep.checked_layers == LAYERS, rep.reason
    other = str(tmp_path / "other.bin")
    if stream:
        bad = bytearray(_read(GOLD))
        bad[len(bad) // 2] ^= 0x01
        with open(other, "wb") as fh:
            fh.write(bytes(bad))
    else:
        shutil.copyfile(os.path.join(DATA, "golden_serve_v1.bin"), other)
    for suffix in SIDECARS:
        shutil.copyfile(GOLD + suffix, other + suffix)
    rep = S.verify_attestation_file(other, stream=stream, device="cpu")
    assert rep.ok != stream, rep.reason


def test_cli_emit_and_stream_verify_in_fresh_processes(tmp_path):
    """``--with-proof --emit`` (a 1-layer demo chain at 2 PCS queries, to
    keep the CPU run short) and ``--verify-file --stream-verify``, each in
    a process of its own under a timeout."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    cli = [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu"]
    att = str(tmp_path / "cli.bin")
    for args in (["--arch", "gpt2_small", "--max-new-tokens", "2",
                  "--with-proof", "--proof-layers", "1", "--pcs-queries", "2",
                  "--emit", att],
                 ["--verify-file", att, "--stream-verify"]):
        r = subprocess.run(cli + args, capture_output=True, text=True,
                           env=env, cwd=str(tmp_path), timeout=240)
        assert r.returncode == 0, r.stdout + r.stderr
        assert "verified=True" in r.stdout, r.stdout
