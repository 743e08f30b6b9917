"""ProofService (persistent proving facade) + stateless ``verify``
(mirrors ``repro.api.service``).

``ProofService`` owns the staged ``ProverEngine``s (one per PCS query
count), their worker fleets and the shared ``WeightCommitCache``;
``attest`` returns a serializable ``Attestation`` whose v1/v2 bytes equal
the JAX package's, and ``attest_many`` proves a window of queries with one
coalesced commit pass (the gateway's entry point).
``verify(attestation, query, model_card)`` is the client side: it needs
only the query and the published ``ModelCard``, re-derives c_0 from the
query, checks the Eq. 3 adjacency and every layer proof, and never raises
on malformed input.  ``StreamingVerifier`` runs the same checks frame by
frame as v2 bytes arrive (one-shot ``verify`` of v2 bytes goes through
it), and ``verify_batch`` verifies many attestations against one card.

Lock order (ranked in repro_torch.analysis.locks): ``ProofService._lock`` is
rank 20, taken under the gateway lock (rank 10) only.  It may be held
while acquiring the engine pool (rank 30), weight-cache (rank 40),
scheduler (rank 50), batcher (rank 60) or leaf (rank 70) locks, the
kernel build lock among them.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core import fisher as FISH
from repro_torch.core import layer_proof as LP
from repro_torch.core import merkle as MK
from repro_torch.core import pcs as PCS
from repro_torch.device import resolve_device
from repro_torch.runtime.engine import ProverEngine, WeightCommitCache

from . import codec
from .types import (KIND_ATTESTATION, PROTOCOL_VERSION, Attestation,
                    ModelCard, VerifyPolicy, VerifyReport, _layer_from_frame,
                    lut_table_digests)

_LUT_DIGEST_CACHE: Optional[Dict[str, bytes]] = None


def _local_lut_digests() -> Dict[str, bytes]:
    global _LUT_DIGEST_CACHE
    if _LUT_DIGEST_CACHE is None:
        _LUT_DIGEST_CACHE = lut_table_digests()
    return _LUT_DIGEST_CACHE


def select_layers(policy: VerifyPolicy, n_layers: int,
                  fisher_scores: Optional[FISH.FisherScores] = None
                  ) -> List[int]:
    """Selective-verification layer choice for a policy (paper §5): every
    layer at budget 1.0, else the fisher (given scores), uniform or seeded
    random selector.  ``audit_random`` adds seed-derived audit layers on
    top of every partial-budget selector: the seed is public, so the audit
    set is recomputable by the verifier yet unpredictable to a prover that
    cannot choose the policy."""
    if policy.budget >= 1.0:
        return list(range(n_layers))
    k = policy.expected_layers(n_layers)
    extra = min(policy.audit_random, max(0, n_layers - k))
    if policy.selector == "fisher" and fisher_scores is not None:
        if extra:
            return FISH.fisher_plus_random(fisher_scores, k, extra,
                                           policy.seed)
        return FISH.select_fisher(fisher_scores, k)
    if policy.selector == "uniform":
        base = FISH.select_uniform(n_layers, k)
        if extra:
            rest = [i for i in range(n_layers) if i not in set(base)]
            rng = np.random.default_rng(policy.seed)
            audit = rng.choice(len(rest), size=min(extra, len(rest)),
                               replace=False)
            return sorted(set(base) | {rest[int(i)] for i in audit})
        return base
    return FISH.select_random(n_layers, min(n_layers, k + extra),
                              policy.seed)


class ProofService:
    """Long-lived provider facade: one resident service, many queries.

    Engines are cached per ``pcs_queries`` and share one
    ``WeightCommitCache``.  ``backend="process"`` keeps a spawned worker
    fleet resident across ``attest`` calls until ``close()``."""

    def __init__(self, block_cfgs: Sequence, weights: Sequence[Dict],
                 pcs_blowup: int = 4, default_queries: int = 16,
                 workers: int = 2, backend: str = "thread",
                 fisher_scores: Optional[FISH.FisherScores] = None,
                 weight_cache: Optional[WeightCommitCache] = None,
                 fail_claims=None, name: str = "", device=None):
        assert len(block_cfgs) == len(weights)
        self.device = resolve_device(device)
        self.block_cfgs = list(block_cfgs)
        self.weights = list(weights)
        self.pcs_blowup = int(pcs_blowup)
        self.default_queries = int(default_queries)
        self.workers = workers
        self.backend = backend
        self.fisher_scores = fisher_scores
        self.fail_claims = fail_claims
        self.name = name
        self.weight_cache = (weight_cache if weight_cache is not None
                             else WeightCommitCache())
        self._engines: Dict[int, ProverEngine] = {}
        self._card: Optional[ModelCard] = None
        self._lock = threading.Lock()
        self.queries_served = 0
        self.last_report = None           # EngineReport of the last attest

    def close(self) -> None:
        for eng in self._engines.values():
            eng.close()
        self._engines.clear()

    def __enter__(self) -> "ProofService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def engine_for(self, pcs_queries: int) -> ProverEngine:
        with self._lock:
            eng = self._engines.get(pcs_queries)
            if eng is None:
                params = PCS.PCSParams(blowup=self.pcs_blowup,
                                       queries=pcs_queries)
                eng = ProverEngine(self.block_cfgs, self.weights, params,
                                   weight_cache=self.weight_cache,
                                   workers=self.workers,
                                   fail_claims=self.fail_claims,
                                   backend=self.backend, device=self.device)
                self._engines[pcs_queries] = eng
            return eng

    @property
    def model_card(self) -> ModelCard:
        """The card the provider publishes (weight setup runs on first use)."""
        if self._card is None:
            eng = self.engine_for(self.default_queries)
            card = ModelCard(
                arch=tuple(self.block_cfgs),
                wt_roots=tuple(np.asarray(w.root) for w in eng.wt_commits),
                lut_digests=_local_lut_digests(),
                pcs_blowup=self.pcs_blowup,
                name=self.name)
            with self._lock:
                if self._card is None:
                    self._card = card
        return self._card

    def attest(self, query: np.ndarray,
               policy: Optional[VerifyPolicy] = None,
               tokens: Optional[np.ndarray] = None) -> Attestation:
        """Prove the quantized forward of ``query`` under ``policy``."""
        if policy is None:
            policy = VerifyPolicy(pcs_queries=self.default_queries)
        subset = select_layers(policy, len(self.block_cfgs),
                               self.fisher_scores)
        eng = self.engine_for(policy.pcs_queries)
        t0 = time.monotonic()
        proof, report = eng.prove(np.asarray(query), layer_subset=subset)
        dt = time.monotonic() - t0
        self.queries_served += 1
        self.last_report = report
        att = Attestation(
            version=PROTOCOL_VERSION, model_id=self.model_card.model_id,
            tokens=(np.asarray(tokens) if tokens is not None
                    else np.zeros(0, np.int32)),
            proof=proof, proved_layers=list(subset), policy=policy,
            prove_seconds=dt)
        att.__dict__["_device"] = self.device
        return att

    def attest_many(self, queries: Sequence[np.ndarray],
                    policies: Optional[Sequence[VerifyPolicy]] = None,
                    tokens: Optional[Sequence[np.ndarray]] = None
                    ) -> List[Attestation]:
        """Attest a WINDOW of queries (``ProverEngine.prove_many``): one
        coalesced boundary-commit pass, and every ``(query, layer)`` job on
        the same resident fleet.  The window's policies must agree on
        ``pcs_queries`` (it fixes the commitment shape); budgets and
        selectors may differ.  Each attestation equals the serial
        ``attest`` of its query byte for byte, but for ``prove_seconds``:
        the window's wall time over its size."""
        K = len(queries)
        if policies is None:
            policies = [VerifyPolicy(pcs_queries=self.default_queries)] * K
        policies = list(policies)
        assert len(policies) == K
        qcounts = {p.pcs_queries for p in policies}
        assert len(qcounts) <= 1, \
            f"attest_many window mixes pcs_queries {sorted(qcounts)}"
        if K == 0:
            return []
        subsets = [select_layers(p, len(self.block_cfgs),
                                 self.fisher_scores) for p in policies]
        eng = self.engine_for(policies[0].pcs_queries)
        t0 = time.monotonic()
        proofs, report = eng.prove_many([np.asarray(q) for q in queries],
                                        subsets)
        dt = time.monotonic() - t0
        self.queries_served += K
        self.last_report = report
        model_id = self.model_card.model_id
        out = []
        for i in range(K):
            att = Attestation(
                version=PROTOCOL_VERSION, model_id=model_id,
                tokens=(np.asarray(tokens[i])
                        if tokens is not None and tokens[i] is not None
                        else np.zeros(0, np.int32)),
                proof=proofs[i], proved_layers=list(subsets[i]),
                policy=policies[i], prove_seconds=dt / K)
            att.__dict__["_device"] = self.device
            out.append(att)
        return out


# ---------------------------------------------------------------------------
# Stateless client-side verification.
#
# ``_VerifySession`` holds the pre-layer checks, the per-layer check and
# the final accounting.  One-shot ``verify`` drives it over a decoded
# object; ``StreamingVerifier`` drives the same session frame by frame as
# v2 bytes arrive, so the two verdicts agree by construction.
# ---------------------------------------------------------------------------
def _reject(reason: str, t0: float, **kw) -> VerifyReport:
    return VerifyReport(ok=False, reason=reason,
                        verify_seconds=time.monotonic() - t0, **kw)


class _VerifySession:
    """Verification state machine: ``head`` (checks needing no layer
    proof), ``layer`` per layer proof, ``final``.  All input is treated as
    attacker-typed — malformed material rejects, never raises."""

    def __init__(self, query, model_card, req_policy, device,
                 t0: Optional[float] = None,
                 wire_version: Optional[int] = None,
                 shared: Optional[Dict] = None):
        self.t0 = time.monotonic() if t0 is None else t0
        self.query = query
        self.card = model_card
        self.req_policy = req_policy
        self.device = device
        self.wire_version = wire_version
        # batch-verify memo (one card, many attestations): the card's
        # content address, the LUT-digest audit, and the recomputed
        # selection per (policy, n_layers)
        self.shared: Dict = {} if shared is None else shared
        self.base: Dict = dict(attestation_bytes=0)
        self.cfgs: List = []
        self.params: Optional[PCS.PCSParams] = None
        self.boundary_roots: List = []
        self.proved: set = set()
        self.seen: set = set()
        self.checked = 0
        self.report: Optional[VerifyReport] = None
        self._head_ok = False

    def _reject(self, reason: str) -> VerifyReport:
        self.report = _reject(reason, self.t0, **self.base)
        return self.report

    def progress(self) -> VerifyReport:
        """Interim accept-so-far snapshot (streaming progress)."""
        return VerifyReport(ok=True, reason="", complete=False,
                            checked_layers=self.checked,
                            verify_seconds=time.monotonic() - self.t0,
                            **self.base)

    def head(self, info: Dict) -> Optional[VerifyReport]:
        if self.report is not None:
            return self.report
        try:
            base_bytes = self.base.get("attestation_bytes", 0)
            self.base = dict(model_id=str(info["model_id"]),
                             proved_layers=[int(x)
                                            for x in info["proved_layers"]],
                             attestation_bytes=base_bytes)
        except Exception as e:  # hostile metadata must not crash the client
            return self._reject(
                f"malformed attestation ({type(e).__name__}): {e}")
        try:
            return self._head_checks(info)
        except Exception as e:  # hostile metadata must not crash the client
            return self._reject(
                f"verification error ({type(e).__name__}): {e}")

    def _head_checks(self, info: Dict) -> Optional[VerifyReport]:
        version = info["version"]
        pol = info["policy"]
        if version != PROTOCOL_VERSION:
            return self._reject(f"unsupported attestation version {version}")
        if not isinstance(pol, VerifyPolicy):
            return self._reject("attestation carries no policy")
        if self.req_policy is not None and pol != self.req_policy:
            return self._reject(
                "policy mismatch: attestation was produced under "
                f"{pol}, client requested {self.req_policy}")
        min_wire = getattr(pol, "min_wire_version", 1)
        if self.wire_version is not None and self.wire_version < min_wire:
            return self._reject(
                f"wire container v{self.wire_version} below the policy "
                f"minimum v{min_wire}")
        if not isinstance(self.card, ModelCard):
            return self._reject("model card unavailable")
        card_id = self.shared.get("model_id")
        if card_id is None:      # content address: one encode per batch
            card_id = self.card.model_id
            self.shared["model_id"] = card_id
        if info["model_id"] != card_id:
            return self._reject(
                "model id mismatch: attestation is for "
                f"{info['model_id']}, card is {card_id}")
        if not self.shared.get("lut_ok"):
            local_luts = _local_lut_digests()
            for lname, digest in sorted(self.card.lut_digests.items()):
                if local_luts.get(lname) != digest:
                    return self._reject(
                        f"LUT table digest mismatch for {lname!r}: verifier "
                        "tables differ from the published card")
            self.shared["lut_ok"] = True

        cfgs = list(self.card.arch)
        L = len(cfgs)
        params = PCS.PCSParams(blowup=self.card.pcs_blowup,
                               queries=pol.pcs_queries)
        boundary_roots = list(info["boundary_roots"])
        wt_roots = list(info["wt_roots"])
        if len(boundary_roots) != L + 1:
            return self._reject(
                f"malformed proof: {len(boundary_roots)} boundary roots "
                f"for {L} layers")
        if len(wt_roots) != L or len(self.card.wt_roots) != L:
            return self._reject("malformed proof: weight root count mismatch")
        for l in range(L):
            if not np.array_equal(np.asarray(wt_roots[l]),
                                  np.asarray(self.card.wt_roots[l])):
                return self._reject(
                    f"published weight root mismatch at layer {l}: proof "
                    "does not use the card's committed weights")

        # Eq. 3 query binding: c_0 re-derived from the client's own query.
        if self.query is not None:
            in_root = LP.commit_boundary(cfgs[0], np.asarray(self.query),
                                         params, device=self.device).root
            if not np.array_equal(np.asarray(boundary_roots[0]),
                                  np.asarray(in_root)):
                return self._reject(
                    "query binding failed: attestation's c_0 does not "
                    "commit the client's query")

        idxs = self.base["proved_layers"]
        if len(set(idxs)) != len(idxs):
            return self._reject("duplicate layer proofs")
        if any(l < 0 or l >= L for l in idxs):
            return self._reject("layer proof index out of range")
        floor = pol.min_proved_layers(L)
        if len(idxs) < floor:
            return self._reject(
                f"budget not met: policy requires >= {floor} layers "
                f"(incl. {pol.audit_random} random audits), "
                f"got {len(idxs)}")
        if pol.budget < 1.0 and pol.selector in ("uniform", "random"):
            # deterministic selectors are recomputable from the public
            # policy; Fisher selection depends on server-side scores, so
            # there only the count is enforceable.  A policy carrying
            # unhashable attacker fields lands in the reject handler.
            expected = self.shared.get(("sel", pol, L))
            if expected is None:
                expected = select_layers(pol, L)
                self.shared[("sel", pol, L)] = expected
            if sorted(idxs) != sorted(expected):
                return self._reject(
                    f"proved layers {sorted(idxs)} do not match the "
                    f"policy's {pol.selector} selection "
                    f"{sorted(expected)}")

        self.cfgs = cfgs
        self.params = params
        self.boundary_roots = boundary_roots
        self.proved = set(idxs)
        self._head_ok = True
        return None

    def layer(self, lp, stores) -> Optional[VerifyReport]:
        if self.report is not None:
            return self.report
        if not self._head_ok:
            return self._reject("layer proof before attestation head")
        try:
            return self._layer_checks(lp, stores)
        except Exception as e:  # malformed proofs must not crash the client
            return self._reject(
                f"verification error ({type(e).__name__}): {e}")

    def _layer_checks(self, lp, stores) -> Optional[VerifyReport]:
        l = int(lp.layer_index)
        if l not in self.proved:
            return self._reject(
                "proved_layers disagrees with the layer proofs")
        if l in self.seen:
            return self._reject("duplicate layer proofs")
        self.seen.add(l)
        if not np.array_equal(np.asarray(lp.in_root),
                              np.asarray(self.boundary_roots[l])):
            return self._reject(
                f"layer {l}: commitment-chain adjacency broken at input "
                "(Eq. 3)")
        if not np.array_equal(np.asarray(lp.out_root),
                              np.asarray(self.boundary_roots[l + 1])):
            return self._reject(
                f"layer {l}: commitment-chain adjacency broken at output "
                "(Eq. 3)")
        store = None
        if stores:
            store = PCS.ColumnStore()
            for ent in stores:
                if (not isinstance(ent, (tuple, list)) or len(ent) != 2
                        or not isinstance(ent[1], MK.MerkleMultiProof)):
                    return self._reject(
                        f"layer {l}: malformed column store entry")
                root, mp = ent
                if not MK.verify_multiproof(np.asarray(root), mp,
                                            self.device):
                    return self._reject(
                        f"layer {l}: column multiproof rejected (root "
                        "mismatch or non-canonical node set)")
                store.add_root(np.asarray(root), mp.indices, mp.leaves)
        if not LP.verify_layer(self.cfgs[l], lp, self.card.wt_roots[l],
                               self.params, check_input_range=(l == 0),
                               store=store, device=self.device):
            return self._reject(f"layer {l}: proof rejected")
        self.checked += 1
        return None

    def final(self) -> VerifyReport:
        if self.report is not None:
            return self.report
        if not self._head_ok:
            return self._reject("attestation head missing")
        if self.seen != self.proved:
            return self._reject(
                "proved_layers disagrees with the layer proofs")
        self.report = VerifyReport(
            ok=True, reason="", checked_layers=self.checked,
            verify_seconds=time.monotonic() - self.t0, **self.base)
        return self.report


class StreamingVerifier:
    """Incremental verifier for a v2 framed attestation stream.

    Feed wire chunks as they arrive; each completed LAYR frame is verified
    the moment its bytes are in.  ``feed`` returns interim ``VerifyReport``
    snapshots (``complete=False``) after the head and each verified layer,
    or the final (latched) rejection; ``finish`` returns the final verdict.
    Malformed, truncated, reordered or tampered streams come back as
    reasoned rejections, never exceptions.

    Flood caps: ``max_buffered_bytes`` bounds the bytes buffered ahead of
    the next completed frame, ``max_stalled_feeds`` the consecutive
    zero-byte ``feed`` calls; crossing either is a reasoned rejection.
    ``device`` is where the verifier's field work runs.
    """

    def __init__(self, query: Optional[np.ndarray],
                 model_card: Union[ModelCard, bytes, bytearray, memoryview],
                 policy: Optional[VerifyPolicy] = None,
                 max_buffered_bytes: int = 256 << 20,
                 max_stalled_feeds: int = 256,
                 shared: Optional[Dict] = None, device=None):
        t0 = time.monotonic()
        dev = resolve_device(device)
        card_err = None
        if isinstance(model_card, (bytes, bytearray, memoryview)):
            try:
                model_card = ModelCard.from_bytes(bytes(model_card))
            except codec.CodecError as e:
                card_err = f"model card decode failed: {e}"
                model_card = None
        self.session = _VerifySession(query, model_card, policy, dev, t0=t0,
                                      wire_version=2, shared=shared)
        self.reader = codec.FrameReader(KIND_ATTESTATION)
        self.fed = 0
        self.max_buffered_bytes = int(max_buffered_bytes)
        self.max_stalled_feeds = int(max_stalled_feeds)
        self._stalled = 0
        self.final_report: Optional[VerifyReport] = None
        if card_err is not None:
            self.final_report = self.session._reject(card_err)

    def feed(self, chunk) -> List[VerifyReport]:
        if self.final_report is not None:
            return []
        chunk = bytes(chunk)
        self.fed += len(chunk)
        self.session.base["attestation_bytes"] = self.fed
        if not chunk:
            self._stalled += 1
            if self._stalled > self.max_stalled_feeds:
                self.final_report = self.session._reject(
                    f"attestation stream rejected: {self._stalled} "
                    "consecutive zero-progress chunks")
                return [self.final_report]
            return []
        self._stalled = 0
        try:
            frames = self.reader.feed(chunk)
        except codec.CodecError as e:
            self.final_report = self.session._reject(
                f"attestation stream rejected: {e}")
            return [self.final_report]
        if len(self.reader.buf) > self.max_buffered_bytes:
            self.final_report = self.session._reject(
                "attestation stream rejected: "
                f"{len(self.reader.buf)} bytes buffered without a "
                f"completed frame exceeds the {self.max_buffered_bytes}"
                "-byte cap")
            return [self.final_report]
        out: List[VerifyReport] = []
        for fkind, obj in frames:
            rep = self._frame(fkind, obj)
            if rep is not None:
                out.append(rep)
            if self.final_report is not None:
                break
        return out

    def _frame(self, fkind, obj) -> Optional[VerifyReport]:
        sess = self.session
        if fkind == codec.FRAME_HEAD:
            if not isinstance(obj, dict):
                self.final_report = sess._reject("malformed HEAD frame")
                return self.final_report
            rep = sess.head(obj)
            if rep is not None:
                self.final_report = rep
                return rep
            return sess.progress()
        if fkind == codec.FRAME_LAYER:
            try:
                lp, stores = _layer_from_frame(obj)
            except codec.CodecError as e:
                self.final_report = sess._reject(f"bad LAYR frame: {e}")
                return self.final_report
            rep = sess.layer(lp, stores)
            if rep is not None:
                self.final_report = rep
                return rep
            return sess.progress()
        if fkind == codec.FRAME_END:
            self.final_report = sess.final()
            return self.final_report
        self.final_report = sess._reject(f"unexpected frame kind {fkind!r}")
        return self.final_report

    def finish(self) -> VerifyReport:
        if self.final_report is None:
            try:
                self.reader.finish()
            except codec.CodecError as e:
                self.final_report = self.session._reject(
                    f"attestation stream rejected: {e}")
            else:   # reader done but no END routed (cannot happen)
                self.final_report = self.session.final()
        return self.final_report


def verify(attestation: Union[Attestation, bytes, bytearray, memoryview],
           query: Optional[np.ndarray],
           model_card: Union[ModelCard, bytes, bytearray, memoryview],
           policy: Optional[VerifyPolicy] = None,
           device=None, _shared: Optional[Dict] = None) -> VerifyReport:
    """Verify an attestation (object or v1/v2 wire bytes) against the
    client's own query and the model card; every failure is a reasoned
    rejection.  v2 bytes go through :class:`StreamingVerifier` fed in one
    shot, so one-shot and chunked verification share every check.
    ``device`` is where the verifier's field work runs."""
    t0 = time.monotonic()
    dev = resolve_device(device)
    if isinstance(model_card, (bytes, bytearray, memoryview)):
        try:
            model_card = ModelCard.from_bytes(bytes(model_card))
        except codec.CodecError as e:
            return _reject(f"model card decode failed: {e}", t0)

    wire_len = 0
    wire_version = None
    if isinstance(attestation, (bytes, bytearray, memoryview)):
        data = bytes(attestation)
        if codec.sniff_version(data) == 2:
            sv = StreamingVerifier(query, model_card, policy, shared=_shared,
                                   device=dev)
            sv.feed(data)
            return sv.finish()
        wire_len = len(data)
        wire_version = 1
        try:
            attestation = Attestation.from_bytes(data, dev)
        except codec.CodecError as e:
            return _reject(f"attestation decode failed: {e}", t0,
                           attestation_bytes=wire_len)
    elif isinstance(attestation, Attestation):
        wire_version = attestation.__dict__.get("_wire_version")

    sess = _VerifySession(query, model_card, policy, dev, t0=t0,
                          wire_version=wire_version, shared=_shared)
    sess.base["attestation_bytes"] = wire_len
    try:
        info = dict(version=attestation.version,
                    model_id=attestation.model_id,
                    proved_layers=attestation.proved_layers,
                    policy=attestation.policy,
                    boundary_roots=attestation.proof.boundary_roots,
                    wt_roots=attestation.proof.wt_roots)
    except Exception as e:  # attacker-typed fields
        return sess._reject(
            f"malformed attestation ({type(e).__name__}): {e}")
    rep = sess.head(info)
    if rep is not None:
        return rep
    try:
        layer_proofs = list(attestation.proof.layer_proofs)
        stores = attestation.layer_stores() \
            if isinstance(attestation, Attestation) else None
        if stores is not None and len(stores) != len(layer_proofs):
            return sess._reject("column store / layer proof count mismatch")
    except Exception as e:  # attacker-typed fields
        return sess._reject(
            f"malformed attestation ({type(e).__name__}): {e}")
    for k, lp in enumerate(layer_proofs):
        rep = sess.layer(lp, stores[k] if stores is not None else [])
        if rep is not None:
            return rep
    return sess.final()


def verify_batch(attestations: Sequence,
                 queries: Sequence[Optional[np.ndarray]],
                 model_card: Union[ModelCard, bytes, bytearray, memoryview],
                 policies: Union[VerifyPolicy, Sequence[Optional[
                     VerifyPolicy]], None] = None,
                 device=None) -> List[VerifyReport]:
    """Verify MANY attestations against ONE published ``ModelCard``: each
    gets its own full verification and its own ``VerifyReport`` (one bad
    item never poisons its neighbours), while the per-card work is paid
    once: the card decode and content address, the LUT-digest audit, and
    the selector recomputation per distinct ``(policy, n_layers)``.
    ``policies`` is one policy for all, one per item, or None."""
    t0 = time.monotonic()
    dev = resolve_device(device)
    n = len(attestations)
    assert len(queries) == n, "attestations/queries length mismatch"
    if isinstance(model_card, (bytes, bytearray, memoryview)):
        try:
            model_card = ModelCard.from_bytes(bytes(model_card))
        except codec.CodecError as e:
            rep = _reject(f"model card decode failed: {e}", t0)
            return [rep] * n
    if policies is None or isinstance(policies, VerifyPolicy):
        policies = [policies] * n
    assert len(policies) == n, "attestations/policies length mismatch"
    shared: Dict = {}
    return [verify(att, q, model_card, policy=pol, device=dev,
                   _shared=shared)
            for att, q, pol in zip(attestations, queries, policies)]
