"""Public attestation objects: ModelCard / VerifyPolicy / Attestation
(mirrors ``repro.api.types``; the same wire forms byte for byte).

These three types are the whole trust interface between an untrusting
client and the serving provider (paper §2):

* ``ModelCard`` — what the provider PUBLISHES once per model: the layer
  architecture, the weight commitment roots from setup, digests of the
  LUT tables the circuit semantics depend on, and the PCS rate.  It is
  content-addressed (``model_id``), so a card cannot silently drift.
* ``VerifyPolicy`` — what the client REQUESTS per query: verification
  budget, layer selector, random audit count, and the PCS query count.
  The policy rides inside the attestation, so prover and verifier can
  never disagree about ``pcs_queries`` (the drift bug the old
  ``verify_response(pcs_queries=16)`` default had).
* ``Attestation`` — what the provider RETURNS: tokens + layer proofs +
  boundary/weight roots + the policy actually used, with a versioned
  wire form.  ``api.verify(attestation, query, model_card)`` needs no
  other server-side object.

Note on tokens: the proof system attests the quantized layer chain
(h_0 -> h_L) for the bound query; the token array travels under the
envelope integrity digest but is not itself inside the circuit statement.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import blocks as B
from repro_torch.core import chain as CH
from repro_torch.core import layer_proof as LP
from repro_torch.core import luts as LUTS
from repro_torch.core import merkle as M
from repro_torch.core import pcs as PCS

from . import codec

KIND_CARD = b"CARD"
KIND_ATTESTATION = b"ATTN"

#: protocol version of the proof system itself (transcript layout, batched
#: PCS openings, m-in-the-clear lookups).  Distinct from the WIRE container
#: version (codec v1 envelope vs v2 framed stream) — both containers can
#: carry a protocol-2 attestation.
PROTOCOL_VERSION = 2


def lut_table_digests() -> Dict[str, bytes]:
    """sha256 of every published quantized LUT table (circuit semantics)."""
    return {name: hashlib.sha256(
                np.ascontiguousarray(LUTS.table_q(name)).tobytes()).digest()
            for name in sorted(LUTS.ALL_SPECS)}


@dataclasses.dataclass(frozen=True)
class VerifyPolicy:
    """Client-chosen verification knobs for one query (paper §5)."""
    budget: float = 1.0          # fraction of layers proven
    selector: str = "fisher"     # fisher | random | uniform
    audit_random: int = 0        # extra random audit layers (§5.2)
    pcs_queries: int = 16        # Ligero spot-check count (soundness knob)
    seed: int = 0                # selector randomness (public)
    min_wire_version: int = 1    # reject wire containers older than this
                                 # (1 accepts legacy enveloped attestations;
                                 # 2 demands the framed/deduplicated form)

    def expected_layers(self, n_layers: int) -> int:
        """Budget-implied layer count, excluding random audits."""
        if self.budget >= 1.0:
            return n_layers
        return max(1, int(round(self.budget * n_layers)))

    def min_proved_layers(self, n_layers: int) -> int:
        """Client-enforceable floor on the proved set: budget layers PLUS
        the random audits — a prover must not get to drop the audit
        layers (paper §5.2)."""
        k = self.expected_layers(n_layers)
        if self.budget >= 1.0:
            return k
        return min(n_layers, k + min(self.audit_random,
                                     max(0, n_layers - k)))


@dataclasses.dataclass(eq=False)
class ModelCard:
    """Published commitment to a served model (content-addressed)."""
    arch: Tuple[B.BlockCfg, ...]          # per-layer circuit configs
    wt_roots: Tuple[np.ndarray, ...]      # setup weight commitment roots
    lut_digests: Dict[str, bytes]         # LUT table sha256s
    pcs_blowup: int                       # RS rate 1/blowup (commitment)
    name: str = ""
    version: int = 1

    @property
    def n_layers(self) -> int:
        return len(self.arch)

    @property
    def model_id(self) -> str:
        """Content address over the canonical wire encoding of the card."""
        body = (self.version, self.name, list(self.arch),
                [np.asarray(r) for r in self.wt_roots],
                self.lut_digests, self.pcs_blowup)
        return codec.content_digest(body)[:16].hex()

    def to_bytes(self) -> bytes:
        return codec.pack(KIND_CARD, self)

    @classmethod
    def from_bytes(cls, data: bytes) -> "ModelCard":
        obj = codec.unpack(KIND_CARD, data)
        if not isinstance(obj, cls):
            raise codec.CodecError("wire object is not a ModelCard")
        return obj


codec.register("api.VerifyPolicy", VerifyPolicy)
codec.register("api.ModelCard", ModelCard)


# ---------------------------------------------------------------------------
# v2 wire helpers: strip inline Merkle paths from a proof tape, regroup the
# opened columns per commitment root into ONE deduplicated multiproof.
# ---------------------------------------------------------------------------
def _strip_tape(tape, device=None):
    """Split a prover tape into (stripped_tape, stores).

    Every ``("open", name, bundle)`` item loses its inline columns + paths;
    the queried columns of ALL bundles that open against the same Merkle
    root are regrouped into one :class:`merkle.MerkleMultiProof` per root,
    so shared authentication-path prefixes ship exactly once.  ``stores``
    is ``[(root, multiproof), ...]`` in first-seen root order.
    """
    groups: Dict[bytes, Tuple[np.ndarray, Dict]] = {}
    stripped = []
    for item in tape:
        if not (isinstance(item, tuple) and len(item) == 3
                and item[0] == "open"
                and isinstance(item[2], PCS.OpeningBundle)
                and item[2].columns is not None and item[2].paths):
            stripped.append(item)
            continue
        bundle = item[2]
        root = M.root_from_path(bundle.columns[0], bundle.paths[0], device)
        _, by_idx = groups.setdefault(root.tobytes(), (root, {}))
        for col, path in zip(bundle.columns, bundle.paths):
            prev = by_idx.get(path.index)
            if prev is not None and not np.array_equal(prev[0], col):
                raise codec.CodecError(
                    f"inconsistent duplicate column {path.index} under one "
                    "root — tape cannot be re-encoded")
            by_idx[path.index] = (col, path)
        stripped.append((item[0], item[1], dataclasses.replace(
            bundle, columns=None, paths=None)))
    stores = []
    for root, by_idx in groups.values():
        idxs = sorted(by_idx)
        leaf_rows = np.stack([by_idx[i][0] for i in idxs])
        paths = [by_idx[i][1] for i in idxs]
        mp = M.multiproof_from_paths(idxs, leaf_rows, paths,
                                     paths[0].siblings.shape[0])
        stores.append((np.asarray(root), mp))
    return stripped, stores


def _layer_frame(lp: LP.LayerProof, stores) -> Dict:
    return dict(layer_index=int(lp.layer_index),
                in_root=np.asarray(lp.in_root),
                out_root=np.asarray(lp.out_root),
                wt_root=np.asarray(lp.wt_root),
                tape=list(lp.tape),
                stores=[(np.asarray(r), mp) for r, mp in stores])


@dataclasses.dataclass(eq=False)
class Attestation:
    """One query's verifiable response, in serializable form.

    Two wire containers exist for the same object:

    * v1 — one codec envelope over the whole tree; every opened column
      carries its own Merkle path inline.
    * v2 (default) — a framed stream (``codec.pack_stream``): a HEAD frame
      with the attestation metadata + a signed manifest, then one LAYR
      frame per layer proof whose column openings travel as per-root
      deduplicated multiproofs.

    Re-encoding to v2 recomputes each opened root on a device: the one
    passed to ``to_bytes``, else the one the service proved on or
    ``from_bytes`` was given (``_device``, not a field, never on the wire),
    else ``cuda``.
    """
    version: int
    model_id: str
    tokens: np.ndarray                    # served tokens (see module note)
    proof: CH.ModelProof                  # layer proofs + c_0..c_L + roots
    proved_layers: List[int]
    policy: VerifyPolicy
    prove_seconds: float = 0.0

    def _head_obj(self) -> Dict:
        return dict(version=int(self.version), model_id=str(self.model_id),
                    tokens=np.asarray(self.tokens),
                    proved_layers=[int(x) for x in self.proved_layers],
                    policy=self.policy,
                    prove_seconds=float(self.prove_seconds),
                    boundary_roots=[np.asarray(r)
                                    for r in self.proof.boundary_roots],
                    wt_roots=[np.asarray(r) for r in self.proof.wt_roots])

    def _stripped(self, device=None) -> Tuple[List, List[List]]:
        """(stripped layer proofs, per-layer stores), parallel lists.

        A tape whose bundles already travel in store mode (a v2 decode)
        strips to itself and reuses the decoded multiproofs; an in-process
        attestation (inline paths) is deduplicated here.  ``self.proof``
        is never mutated, so ``to_bytes(1)`` keeps working either way.
        """
        cached = self.__dict__.get("_stripped_cache")
        if cached is None:
            primed = self.__dict__.get("_layer_stores")
            stripped_lps, stores = [], []
            for k, lp in enumerate(self.proof.layer_proofs):
                tape, st = _strip_tape(lp.tape, device)
                if primed is not None and not st:
                    st = primed[k]       # already store-mode on arrival
                stripped_lps.append(dataclasses.replace(lp, tape=tape))
                stores.append(st)
            cached = (stripped_lps, stores)
            self.__dict__["_stripped_cache"] = cached
        return cached

    def layer_stores(self) -> Optional[List[List]]:
        """Per-layer ``[(root, MerkleMultiProof), ...]`` for a v2-decoded
        attestation (parallel to ``proof.layer_proofs``), else None."""
        return self.__dict__.get("_layer_stores")

    def to_bytes(self, wire_version: int = 2, device=None) -> bytes:
        # multi-MB proof trees: cache the encoding (not a dataclass field,
        # so it never reaches the wire; dataclasses.replace() drops it —
        # mutate via replace(), not in place, or the cache goes stale)
        cache = self.__dict__.setdefault("_wire_cache", {})
        cached = cache.get(wire_version)
        if cached is not None:
            return cached
        if wire_version == 1:
            data = codec.pack(KIND_ATTESTATION, self)
        elif wire_version == 2:
            head = self._head_obj()
            lps, stores = self._stripped(
                device if device is not None else self.__dict__.get("_device"))
            frames = [(codec.FRAME_LAYER, _layer_frame(lp, st))
                      for lp, st in zip(lps, stores)]
            data = codec.pack_stream(KIND_ATTESTATION, head, frames)
        else:
            raise codec.CodecError(f"unknown wire version {wire_version}")
        cache[wire_version] = data
        return data

    @classmethod
    def from_bytes(cls, data: bytes, device=None) -> "Attestation":
        """Decode v1 or v2 bytes; ``device`` is where a later v2
        re-encoding runs (decoding itself runs on the host)."""
        data = bytes(data)
        if codec.sniff_version(data) == 2:
            obj = cls._from_stream(data)
            obj.__dict__["_wire_version"] = 2
            obj.__dict__["_wire_cache"] = {2: data}
            obj.__dict__["_device"] = device
            return obj
        obj = codec.unpack(KIND_ATTESTATION, data)
        if not isinstance(obj, cls):
            raise codec.CodecError("wire object is not an Attestation")
        # decode->encode is canonical (deterministic codec), so the input
        # bytes ARE this object's encoding
        obj.__dict__["_wire_version"] = 1
        obj.__dict__["_wire_cache"] = {1: data}
        obj.__dict__["_device"] = device
        return obj

    @classmethod
    def _from_stream(cls, data: bytes) -> "Attestation":
        head, frames = codec.unpack_stream(KIND_ATTESTATION, data)
        try:
            lps, stores = [], []
            for fkind, obj in frames:
                if fkind != codec.FRAME_LAYER:
                    raise codec.CodecError(
                        f"unexpected frame kind {fkind!r}")
                lp, st = _layer_from_frame(obj)
                lps.append(lp)
                stores.append(st)
            proof = CH.ModelProof(
                layer_proofs=lps,
                boundary_roots=list(head["boundary_roots"]),
                wt_roots=list(head["wt_roots"]))
            obj = cls(version=head["version"], model_id=head["model_id"],
                      tokens=head["tokens"],
                      proof=proof, proved_layers=head["proved_layers"],
                      policy=head["policy"],
                      prove_seconds=head["prove_seconds"])
        except codec.CodecError:
            raise
        except Exception as e:   # hostile head/frame shapes
            raise codec.CodecError(
                f"malformed v2 attestation ({type(e).__name__}): {e}") from e
        obj.__dict__["_layer_stores"] = stores
        return obj

    @property
    def size_bytes(self) -> int:
        """ENCODED size — the paper's KB/layer claim, on the wire."""
        return len(self.to_bytes())

    @property
    def bytes_per_layer(self) -> float:
        return self.size_bytes / max(1, len(self.proved_layers))


def _layer_from_frame(obj) -> Tuple[LP.LayerProof, List]:
    if not isinstance(obj, dict):
        raise codec.CodecError("LAYR frame body is not a dict")
    lp = LP.LayerProof(layer_index=obj["layer_index"],
                       in_root=obj["in_root"], out_root=obj["out_root"],
                       wt_root=obj["wt_root"], tape=obj["tape"])
    stores = obj["stores"]
    if not isinstance(stores, list):
        raise codec.CodecError("LAYR stores is not a list")
    return lp, stores


codec.register("api.Attestation", Attestation)


@dataclasses.dataclass
class VerifyReport:
    """Outcome of ``api.verify``: accept/reject + a human-readable reason.

    ``complete`` is False on the interim progress snapshots a
    ``StreamingVerifier`` emits while layer frames are still in flight;
    the one-shot path and ``finish()`` always return a complete report.
    """
    ok: bool
    reason: str = ""                      # empty iff ok
    model_id: str = ""
    checked_layers: int = 0
    proved_layers: Optional[List[int]] = None
    attestation_bytes: int = 0
    verify_seconds: float = 0.0
    complete: bool = True

    def __bool__(self) -> bool:
        return self.ok
