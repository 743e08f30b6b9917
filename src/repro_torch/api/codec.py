"""Versioned, numpy-aware wire codec for the attestation API — a copy of
``repro.api.codec``: the same tags, the same registry names and the same
dataclass field order, so the port's bytes are the JAX package's bytes.
Proof objects reach it as numpy (tensors leave the device at the tape).

Proof objects are trees of dataclasses, tuples, dicts, and numpy arrays
(proof tapes, opening bundles, Merkle paths).  This module gives them a
deterministic self-describing binary form WITHOUT pickle: every value is
tagged, arrays carry their exact dtype + shape, and dataclasses are
encoded by a closed registry of known proof/API types — decoding never
executes arbitrary code, and a corrupted buffer raises ``CodecError``
instead of crashing deeper in verification.

Envelope (``pack``/``unpack``): a fixed header

    MAGIC(4) | version(1) | kind(4) | sha256(body)(32) | body_len(8) | body

so any single flipped byte — header or body — is rejected deterministically
at decode time with a reason, before verification even starts.  The digest
is an *integrity* check (storage/transit corruption and naive tampering);
cryptographic soundness against a motivated adversary comes from the proof
verification itself (``repro_torch.api.verify``).

Determinism matters beyond aesthetics: ``Attestation.size_bytes`` is the
encoded size (the paper's KB/layer claim, measured on the wire), and
``ModelCard`` ids are content addresses over this encoding.
"""
from __future__ import annotations

import dataclasses
import hashlib
import struct
from typing import Any, Dict

import numpy as np

MAGIC = b"NZK1"
VERSION = 1
MAGIC2 = b"NZK2"
VERSION2 = 2

# BabyBear modulus — every uint32 array in this codebase holds Montgomery
# field elements < P, so they pack into 31-bit limbs (tag "P").  Kept as a
# literal so the codec needs no field/jax import at definition time.
_P = 2013265921

_U8 = struct.Struct(">B")
_U32 = struct.Struct(">I")
_U64 = struct.Struct(">Q")
_F64 = struct.Struct(">d")

# Byte budget guard: a corrupt length prefix must not trigger a giant
# allocation before the overrun check fires.
_MAX_LEN = 1 << 34


class CodecError(Exception):
    """Malformed, truncated, or integrity-failed wire bytes."""


# ---------------------------------------------------------------------------
# Dataclass registry: the closed set of types allowed on the wire.
# ---------------------------------------------------------------------------
_REGISTRY: Dict[str, type] = {}
_REGISTRY_BY_CLS: Dict[type, str] = {}


def register(name: str, cls: type) -> None:
    """Register a dataclass for wire encoding under a stable name."""
    assert dataclasses.is_dataclass(cls), cls
    _REGISTRY[name] = cls
    _REGISTRY_BY_CLS[cls] = name


def _register_core_types() -> None:
    """Stable serializable forms for the proof-system dataclasses."""
    from repro_torch.core import chain as CH
    from repro_torch.core import layer_proof as LP
    from repro_torch.core import merkle as M
    from repro_torch.core import pcs as PCS
    from repro_torch.core import sumcheck as SC

    register("pcs.PCSParams", PCS.PCSParams)
    register("pcs.OpeningBundle", PCS.OpeningBundle)
    register("merkle.MerklePath", M.MerklePath)
    register("merkle.MerkleMultiProof", M.MerkleMultiProof)
    register("sumcheck.SumcheckProof", SC.SumcheckProof)
    register("layer_proof.LayerProof", LP.LayerProof)
    register("chain.ModelProof", CH.ModelProof)

    from repro_torch.core import blocks as B
    register("blocks.BlockCfg", B.BlockCfg)


_register_core_types()


# ---------------------------------------------------------------------------
# Value encoding (tagged, deterministic).
# ---------------------------------------------------------------------------
def _enc_varint(out: bytearray, n: int) -> None:
    """Unsigned LEB128 — lengths, counts and array dims are usually tiny,
    so one byte instead of a fixed u32/u64 is the common case."""
    assert n >= 0
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes((b | 0x80,))
        else:
            out += bytes((b,))
            return


def _enc_str(out: bytearray, s: str, strtab: dict) -> None:
    """Interned string: varint(2*len)+bytes on first sight, varint(2*id+1)
    back-reference after.  Tape tags, dataclass/field names and dict keys
    repeat hundreds of times per layer proof — each repeat costs 1 byte."""
    idx = strtab.get(s)
    if idx is not None:
        _enc_varint(out, idx * 2 + 1)
        return
    strtab[s] = len(strtab)
    b = s.encode("utf-8")
    _enc_varint(out, len(b) * 2)
    out += b


def _pack31(flat: np.ndarray) -> bytes:
    """Pack canonical field elements (< 2^31) into 31-bit limbs."""
    if flat.size == 0:
        return b""
    bits = np.unpackbits(flat.astype(">u4").view(np.uint8).reshape(-1, 4),
                         axis=1)                       # (n, 32), MSB first
    return np.packbits(bits[:, 1:]).tobytes()          # drop the zero top bit


def _unpack31(raw: bytes, count: int) -> np.ndarray:
    nbits = 31 * count
    bits = np.unpackbits(np.frombuffer(raw, np.uint8))
    if bits.shape[0] < nbits:
        raise CodecError("packed field array truncated")
    if bits[nbits:].any():
        raise CodecError("nonzero padding in packed field array")
    b31 = bits[:nbits].reshape(count, 31)
    full = np.concatenate([np.zeros((count, 1), np.uint8), b31], axis=1)
    vals = np.packbits(full, axis=1).view(">u4").reshape(-1).astype(np.uint32)
    if vals.size and int(vals.max()) >= _P:
        raise CodecError("packed field element exceeds modulus")
    return vals


def _enc(out: bytearray, obj: Any, strtab: dict) -> None:
    if obj is None:
        out += b"N"
    elif obj is True:
        out += b"T"
    elif obj is False:
        out += b"F"
    elif isinstance(obj, int):
        nbytes = max(1, (obj.bit_length() + 8) // 8)
        out += b"I"
        out += _U8.pack(nbytes)
        out += obj.to_bytes(nbytes, "big", signed=True)
    elif isinstance(obj, float):
        out += b"f"
        out += _F64.pack(obj)
    elif isinstance(obj, str):
        out += b"S"
        _enc_str(out, obj, strtab)
    elif isinstance(obj, (bytes, bytearray)):
        out += b"B"
        _enc_varint(out, len(obj))
        out += bytes(obj)
    elif isinstance(obj, np.generic):
        a = np.asarray(obj)
        out += b"G"
        _enc_str(out, a.dtype.str, strtab)
        out += a.tobytes()
    elif isinstance(obj, (list, tuple)):
        out += b"L" if isinstance(obj, list) else b"U"
        _enc_varint(out, len(obj))
        for item in obj:
            _enc(out, item, strtab)
    elif isinstance(obj, dict):
        out += b"D"
        _enc_varint(out, len(obj))
        for k, v in obj.items():
            assert isinstance(k, str), f"wire dicts need str keys, got {k!r}"
            _enc_str(out, k, strtab)
            _enc(out, v, strtab)
    elif type(obj) in _REGISTRY_BY_CLS:
        out += b"C"
        _enc_str(out, _REGISTRY_BY_CLS[type(obj)], strtab)
        flds = dataclasses.fields(obj)
        _enc_varint(out, len(flds))
        for f in flds:
            _enc_str(out, f.name, strtab)
            _enc(out, getattr(obj, f.name), strtab)
    else:
        # numpy arrays land here.  A tensor holds int64 words and would
        # encode as another dtype than the uint32 wire form: refuse it.
        if type(obj).__module__.startswith("torch"):
            raise TypeError("tensors must become numpy uint32 before encoding")
        try:
            a = np.asarray(obj)
        except Exception as e:
            raise TypeError(f"not wire-encodable: {type(obj)!r}") from e
        if a.dtype == object:
            raise TypeError(f"not wire-encodable: {type(obj)!r}")
        if not a.flags["C_CONTIGUOUS"]:
            # NB: ascontiguousarray only when needed — it promotes 0-d to 1-d
            a = np.ascontiguousarray(a).reshape(a.shape)
        if a.dtype == np.uint32 and (a.size == 0 or int(a.max()) < _P):
            # field elements: 31-bit limb packing (saves 1 bit per limb and
            # makes out-of-field bytes a decode error, not a crash later)
            out += b"P"
            out += _U8.pack(a.ndim)
            for dim in a.shape:
                _enc_varint(out, dim)
            out += _pack31(a.reshape(-1))
            return
        out += b"A"
        _enc_str(out, a.dtype.str, strtab)
        out += _U8.pack(a.ndim)
        for dim in a.shape:
            _enc_varint(out, dim)
        out += a.tobytes()


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.strings: list = []
        self._seen: set = set()

    def take(self, n: int) -> bytes:
        if n < 0 or n > _MAX_LEN or self.pos + n > len(self.data):
            raise CodecError("buffer overrun")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def u8(self) -> int:
        return _U8.unpack(self.take(1))[0]

    def u32(self) -> int:
        return _U32.unpack(self.take(4))[0]

    def u64(self) -> int:
        return _U64.unpack(self.take(8))[0]

    def varint(self) -> int:
        n, shift = 0, 0
        while True:
            b = self.take(1)[0]
            n |= (b & 0x7F) << shift
            if not (b & 0x80):
                if shift and b == 0:
                    raise CodecError("non-canonical varint")
                return n
            shift += 7
            if shift > 56:       # > _MAX_LEN is rejected downstream anyway
                raise CodecError("varint too large")

    def string(self) -> str:
        n = self.varint()
        if n & 1:                        # back-reference into the table
            idx = n >> 1
            if idx >= len(self.strings):
                raise CodecError("string back-reference out of range")
            return self.strings[idx]
        try:
            s = self.take(n >> 1).decode("utf-8")
        except UnicodeDecodeError as e:
            raise CodecError(f"bad utf-8 string: {e}") from e
        if s in self._seen:              # canonical form = always back-ref
            raise CodecError("non-canonical string literal")
        self._seen.add(s)
        self.strings.append(s)
        return s


def _dtype(s: str) -> np.dtype:
    try:
        dt = np.dtype(s)
    except TypeError as e:
        raise CodecError(f"bad dtype {s!r}: {e}") from e
    if dt.hasobject:
        raise CodecError(f"refusing object dtype {s!r}")
    return dt


def _dec(r: _Reader) -> Any:
    tag = r.take(1)
    if tag == b"N":
        return None
    if tag == b"T":
        return True
    if tag == b"F":
        return False
    if tag == b"I":
        return int.from_bytes(r.take(r.u8()), "big", signed=True)
    if tag == b"f":
        return _F64.unpack(r.take(8))[0]
    if tag == b"S":
        return r.string()
    if tag == b"B":
        return r.take(r.varint())
    if tag == b"G":
        dt = _dtype(r.string())
        if dt.itemsize == 0:
            raise CodecError(f"zero-itemsize dtype {dt!r}")
        return np.frombuffer(r.take(dt.itemsize), dtype=dt)[0]
    if tag in (b"L", b"U"):
        n = r.varint()
        items = [_dec(r) for _ in range(n)]
        return items if tag == b"L" else tuple(items)
    if tag == b"D":
        n = r.varint()
        out = {}
        for _ in range(n):
            key = r.string()          # key strictly before value
            out[key] = _dec(r)
        return out
    if tag == b"C":
        name = r.string()
        cls = _REGISTRY.get(name)
        if cls is None:
            raise CodecError(f"unknown wire type {name!r}")
        n = r.varint()
        kwargs = {}
        for _ in range(n):
            fname = r.string()        # field name strictly before value
            kwargs[fname] = _dec(r)
        try:
            return cls(**kwargs)
        except Exception as e:
            raise CodecError(f"cannot rebuild {name}: {e}") from e
    if tag == b"P":
        ndim = r.u8()
        if ndim > 32:
            raise CodecError("packed array rank too large")
        shape = tuple(r.varint() for _ in range(ndim))
        count = 1
        for dim in shape:
            count *= dim
            if count * 4 > _MAX_LEN:
                raise CodecError("array too large")
        raw = r.take((31 * count + 7) // 8)
        return _unpack31(raw, count).reshape(shape)
    if tag == b"A":
        dt = _dtype(r.string())
        if dt.itemsize == 0:
            raise CodecError(f"zero-itemsize dtype {dt!r}")
        ndim = r.u8()
        shape = tuple(r.varint() for _ in range(ndim))
        count = 1
        for dim in shape:          # python ints: no int64 overflow wrap
            count *= dim
            if count * dt.itemsize > _MAX_LEN:
                raise CodecError("array too large")
        raw = r.take(count * dt.itemsize)
        # copy: frombuffer views are read-only and pin the input buffer
        return np.frombuffer(raw, dtype=dt).reshape(shape).copy()
    raise CodecError(f"unknown tag {tag!r}")


def encode_obj(obj: Any) -> bytes:
    out = bytearray()
    _enc(out, obj, {})
    return bytes(out)


def decode_obj(data: bytes) -> Any:
    r = _Reader(data)
    try:
        obj = _dec(r)
    except CodecError:
        raise
    except Exception as e:  # hostile bytes must never escape as other types
        raise CodecError(
            f"malformed wire data ({type(e).__name__}): {e}") from e
    if r.pos != len(data):
        raise CodecError("trailing bytes after value")
    return obj


def content_digest(obj: Any) -> bytes:
    """sha256 over the canonical encoding — used for content addressing."""
    return hashlib.sha256(encode_obj(obj)).digest()


# ---------------------------------------------------------------------------
# Envelope.
# ---------------------------------------------------------------------------
_HEADER = len(MAGIC) + 1 + 4 + 32 + 8


def pack(kind: bytes, obj: Any) -> bytes:
    """Serialize ``obj`` with the integrity envelope. ``kind`` is 4 bytes."""
    assert len(kind) == 4, kind
    body = encode_obj(obj)
    return (MAGIC + _U8.pack(VERSION) + kind +
            hashlib.sha256(body).digest() + _U64.pack(len(body)) + body)


def unpack(kind: bytes, data: bytes) -> Any:
    assert len(kind) == 4, kind
    if len(data) < _HEADER:
        raise CodecError("truncated header")
    if data[:4] != MAGIC:
        raise CodecError("bad magic (not a NANOZK wire object)")
    ver = data[4]
    if ver != VERSION:
        raise CodecError(f"unsupported wire version {ver}")
    if data[5:9] != kind:
        raise CodecError(
            f"wrong object kind {data[5:9]!r} (expected {kind!r})")
    digest = data[9:41]
    (body_len,) = _U64.unpack(data[41:49])
    body = data[_HEADER:]
    if len(body) != body_len:
        raise CodecError("body length mismatch")
    if hashlib.sha256(body).digest() != digest:
        raise CodecError("integrity digest mismatch (corrupt or tampered)")
    return decode_obj(body)


# ---------------------------------------------------------------------------
# v2 framed streams (chunked / streaming attestations).
#
#   stream := MAGIC2 | version(1)=2 | kind(4) | frame*
#   frame  := fkind(4) | body_len(8) | sha256(body)(32) | body
#
# The first frame MUST be HEAD; its body is {"head": <obj>, "manifest":
# [(fkind, length, digest), ...]} covering every subsequent frame in order,
# ending with an empty END frame.  A streaming consumer can therefore
# verify each frame's integrity and position the moment its bytes arrive:
# out-of-order delivery, substitution, duplication, and truncation all
# surface as deterministic CodecErrors without buffering the whole stream.
# ---------------------------------------------------------------------------
FRAME_HEAD = b"HEAD"
FRAME_LAYER = b"LAYR"
FRAME_END = b"END."
_STREAM_PREFIX = len(MAGIC2) + 1 + 4
_FRAME_HEADER = 4 + 8 + 32
_MAX_FRAMES = 1 << 20


def _frame_bytes(fkind: bytes, body: bytes) -> bytes:
    assert len(fkind) == 4, fkind
    return (fkind + _U64.pack(len(body)) + hashlib.sha256(body).digest()
            + body)


def pack_stream(kind: bytes, head_obj: Any, frames) -> bytes:
    """Serialize a v2 framed stream: HEAD (with manifest), frames, END."""
    assert len(kind) == 4, kind
    bodies = [(fkind, encode_obj(obj)) for fkind, obj in frames]
    bodies.append((FRAME_END, b""))
    manifest = [(fk, len(b), hashlib.sha256(b).digest()) for fk, b in bodies]
    head_body = encode_obj({"head": head_obj, "manifest": manifest})
    out = bytearray()
    out += MAGIC2 + _U8.pack(VERSION2) + kind
    out += _frame_bytes(FRAME_HEAD, head_body)
    for fk, b in bodies:
        out += _frame_bytes(fk, b)
    return bytes(out)


class FrameReader:
    """Incremental v2 stream parser.

    ``feed(chunk)`` returns the list of frames completed by that chunk as
    ``(fkind, obj)`` pairs (END frames are reported with obj None).  The
    reader checks the stream prefix, decodes HEAD, then holds every later
    frame to the HEAD manifest: wrong order, wrong length, wrong digest,
    unknown trailing bytes, or a missing END all raise CodecError.  After a
    raise the reader is poisoned and rejects further input.
    """

    def __init__(self, kind: bytes):
        assert len(kind) == 4, kind
        self.kind = kind
        self.buf = bytearray()
        self.head: Any = None
        self.manifest = None
        self.mpos = 0
        self.done = False
        self.failed = False
        self._prefix_ok = False

    def _fail(self, msg: str):
        self.failed = True
        raise CodecError(msg)

    def feed(self, chunk: bytes):
        if self.failed:
            raise CodecError("stream already failed")
        if self.done and chunk:
            self._fail("bytes after END frame")
        self.buf += bytes(chunk)
        out = []
        while True:
            if not self._prefix_ok:
                if len(self.buf) < _STREAM_PREFIX:
                    break
                if bytes(self.buf[:4]) != MAGIC2:
                    self._fail("bad magic (not a NANOZK v2 stream)")
                if self.buf[4] != VERSION2:
                    self._fail(f"unsupported stream version {self.buf[4]}")
                if bytes(self.buf[5:9]) != self.kind:
                    self._fail(f"wrong stream kind {bytes(self.buf[5:9])!r}")
                del self.buf[:_STREAM_PREFIX]
                self._prefix_ok = True
            frame = self._try_frame()
            if frame is None:
                break
            out.append(frame)
        return out

    def _try_frame(self):
        if self.done:
            if self.buf:
                self._fail("bytes after END frame")
            return None
        if len(self.buf) < _FRAME_HEADER:
            return None
        fkind = bytes(self.buf[:4])
        (blen,) = _U64.unpack(bytes(self.buf[4:12]))
        digest = bytes(self.buf[12:44])
        if blen > _MAX_LEN:
            self._fail("frame too large")
        if len(self.buf) < _FRAME_HEADER + blen:
            return None
        body = bytes(self.buf[_FRAME_HEADER:_FRAME_HEADER + blen])
        del self.buf[:_FRAME_HEADER + blen]
        if hashlib.sha256(body).digest() != digest:
            self._fail(f"frame digest mismatch ({fkind!r})")
        if self.manifest is None:
            if fkind != FRAME_HEAD:
                self._fail(f"first frame must be HEAD, got {fkind!r}")
            try:
                head = decode_obj(body)
            except CodecError as e:
                self._fail(f"bad HEAD frame: {e}")
            if (not isinstance(head, dict) or "head" not in head
                    or "manifest" not in head
                    or not isinstance(head["manifest"], list)
                    or len(head["manifest"]) > _MAX_FRAMES):
                self._fail("malformed HEAD frame")
            for ent in head["manifest"]:
                if (not isinstance(ent, tuple) or len(ent) != 3
                        or not isinstance(ent[0], bytes) or len(ent[0]) != 4
                        or not isinstance(ent[1], int) or ent[1] < 0
                        or ent[1] > _MAX_LEN
                        or not isinstance(ent[2], bytes)
                        or len(ent[2]) != 32):
                    self._fail("malformed manifest entry")
            if (not head["manifest"]
                    or head["manifest"][-1][0] != FRAME_END
                    or head["manifest"][-1][1] != 0):
                self._fail("manifest must end with an empty END frame")
            self.head = head["head"]
            self.manifest = head["manifest"]
            return (FRAME_HEAD, self.head)
        if self.mpos >= len(self.manifest):
            self._fail("frame beyond manifest")
        want_kind, want_len, want_digest = self.manifest[self.mpos]
        if fkind != want_kind or blen != want_len or digest != want_digest:
            self._fail(
                f"frame {self.mpos} does not match manifest "
                f"(got {fkind!r}, want {want_kind!r}) — out-of-order, "
                "substituted, or corrupted chunk")
        self.mpos += 1
        if fkind == FRAME_END:
            self.done = True
            if self.mpos != len(self.manifest):
                self._fail("END frame before manifest exhausted")
            if self.buf:
                self._fail("bytes after END frame")
            return (FRAME_END, None)
        try:
            obj = decode_obj(body)
        except CodecError as e:
            self._fail(f"bad frame body: {e}")
        return (fkind, obj)

    def finish(self):
        """Assert the stream completed exactly (END seen, no leftovers)."""
        if self.failed:
            raise CodecError("stream already failed")
        if not self.done:
            self._fail("truncated stream (END frame missing)")
        if self.buf:
            self._fail("trailing bytes after END frame")


def unpack_stream(kind: bytes, data: bytes):
    """One-shot v2 stream decode -> (head_obj, [(fkind, obj), ...])."""
    fr = FrameReader(kind)
    frames = fr.feed(bytes(data))
    fr.finish()
    payload = [(fk, obj) for fk, obj in frames
               if fk not in (FRAME_HEAD, FRAME_END)]
    return fr.head, payload


def sniff_version(data: bytes) -> int:
    """Wire container version of an encoded object (1 or 2)."""
    if len(data) >= 4 and data[:4] == MAGIC2:
        return 2
    return 1
