"""repro_torch.api — the port's public surface for verifiable serving.

Provider side::

    service = ProofService(block_cfgs, weights, default_queries=16)
    card = service.model_card            # publish once (content-addressed)
    att = service.attest(x0, VerifyPolicy(pcs_queries=16))
    wire = att.to_bytes()                # the JAX package's bytes

Client side::

    report = api.verify(wire, x0, card)  # VerifyReport(ok=..., reason=...)
    sv = api.StreamingVerifier(x0, card)  # or chunk by chunk, as v2
    for chunk in chunks:                  # frames arrive
        sv.feed(chunk)
    report = sv.finish()
"""
from .codec import CodecError, decode_obj, encode_obj, pack, unpack
from .service import (ProofService, StreamingVerifier, select_layers,
                      verify, verify_batch)
from .types import (PROTOCOL_VERSION, Attestation, ModelCard, VerifyPolicy,
                    VerifyReport, lut_table_digests)

__all__ = [
    "Attestation", "CodecError", "ModelCard", "PROTOCOL_VERSION",
    "ProofService", "StreamingVerifier", "VerifyPolicy", "VerifyReport",
    "decode_obj", "encode_obj", "lut_table_digests", "pack",
    "select_layers", "unpack", "verify", "verify_batch",
]
