"""Merkle trees over Poseidon2 digests (mirrors ``repro.core.merkle``).

Leaves are rows of Montgomery field elements.  Every leaf hash and every
level goes through the K1 kernel (one sponge launch for the leaves, one
compress launch per level).  Tree levels stay on the device; paths,
multiproofs and roots leave it as numpy uint32 (the wire form).
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import poseidon2_kernel as K1

from . import field as F
from . import poseidon2 as P2


def _compress_level(cur: torch.Tensor) -> torch.Tensor:
    """(..., 2m, 8) level -> (..., m, 8) parents."""
    pairs = cur.reshape(*cur.shape[:-2], -1, 2, P2.DIGEST)
    return K1.compress_pairs(pairs[..., 0, :].contiguous(),
                             pairs[..., 1, :].contiguous())


def _pad_leaves(digests: torch.Tensor) -> torch.Tensor:
    n = digests.shape[-2]
    n_pad = 1 << max((n - 1).bit_length(), 0) if n > 1 else 1
    if n_pad == n:
        return digests
    return torch.nn.functional.pad(digests, (0, 0, 0, n_pad - n))


@dataclasses.dataclass
class MerkleTree:
    levels: List[torch.Tensor]  # levels[0]: (n, DIGEST) leaf digests ... root last

    @property
    def root(self) -> torch.Tensor:
        return self.levels[-1][0]

    @property
    def num_leaves(self) -> int:
        return self.levels[0].shape[0]


def commit(leaves: torch.Tensor) -> MerkleTree:
    """leaves: (n, leaf_len) field elements; n padded to a power of two."""
    levels = [_pad_leaves(K1.hash_rows(leaves))]
    while levels[-1].shape[0] > 1:
        levels.append(_compress_level(levels[-1]))
    return MerkleTree(levels=levels)


def commit_batch(leaves: torch.Tensor) -> List[MerkleTree]:
    """Commit B same-shape leaf sets at once: leaves (B, n, leaf_len); one
    sponge launch for all B*n leaves and one compress launch per level."""
    b = leaves.shape[0]
    levels = [_pad_leaves(K1.hash_rows(leaves))]
    while levels[-1].shape[1] > 1:
        levels.append(_compress_level(levels[-1]))
    return [MerkleTree(levels=[lv[i] for lv in levels]) for i in range(b)]


@dataclasses.dataclass
class MerklePath:
    index: int
    siblings: np.ndarray  # (depth, DIGEST) uint32 (Montgomery), host-side


def open_paths(tree: MerkleTree, indices) -> List[MerklePath]:
    """Authentication paths of many leaves, one device gather per level."""
    idx = np.asarray([int(i) for i in indices], dtype=np.int64)
    sibs = []
    cur = idx
    for level in tree.levels[:-1]:
        sel = torch.as_tensor(cur ^ 1, device=level.device)
        sibs.append(F.to_np(level[sel]))
        cur = cur >> 1
    depth = len(tree.levels) - 1
    out = []
    for k, i in enumerate(idx):
        s = (np.stack([lv[k] for lv in sibs]) if depth
             else np.zeros((0, P2.DIGEST), np.uint32))
        out.append(MerklePath(index=int(i), siblings=s))
    return out


def open_path(tree: MerkleTree, index: int) -> MerklePath:
    return open_paths(tree, [index])[0]


def batch_open(tree: MerkleTree, indices) -> List[MerklePath]:
    return open_paths(tree, indices)


def root_from_path(leaf, path: MerklePath, device=None) -> np.ndarray:
    """Recompute the root implied by a leaf + path (no comparison)."""
    device = resolve_device(device)
    node = K1.hash_rows(F.tensor(leaf, device).reshape(1, -1))
    idx = path.index
    for sib in path.siblings:
        s = F.tensor(sib, device).reshape(1, -1)
        node = K1.compress_pairs(s, node) if idx & 1 else \
            K1.compress_pairs(node, s)
        idx >>= 1
    return F.to_np(node[0])


def verify_path(root: np.ndarray, leaf, path: MerklePath,
                device=None) -> bool:
    return bool(np.array_equal(root_from_path(leaf, path, device),
                               np.asarray(root)))


def verify_paths_batch(root: np.ndarray, leaves: torch.Tensor,
                       paths: List[MerklePath]) -> bool:
    """Verify many authentication paths with one compress per level."""
    t = len(paths)
    if t == 0:
        return True
    depth = paths[0].siblings.shape[0]
    if any(p.siblings.shape[0] != depth for p in paths):
        return False
    dev = leaves.device
    idx = np.array([p.index for p in paths], dtype=np.int64)
    sibs = F.tensor(np.stack([p.siblings for p in paths]), dev)  # (t, d, 8)
    node = K1.hash_rows(leaves)                                   # (t, 8)
    for d in range(depth):
        bit = torch.as_tensor((idx >> d) & 1, device=dev).bool()[:, None]
        sib = sibs[:, d]
        left = torch.where(bit, sib, node).contiguous()
        right = torch.where(bit, node, sib).contiguous()
        node = K1.compress_pairs(left, right)
    got = F.to_np(node)
    return bool(np.all(got == np.asarray(root)[None, :]))


# ---------------------------------------------------------------------------
# Multiproofs: one deduplicated authentication structure for a set of
# leaves of one tree (level by level, leaf level first, position-ascending).
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class MerkleMultiProof:
    indices: np.ndarray   # (k,) int64, sorted unique leaf positions
    leaves: np.ndarray    # (k, leaf_len) uint32 leaf rows (the columns)
    nodes: np.ndarray     # (n_nodes, DIGEST) uint32, canonical order
    depth: int            # tree depth (2^depth leaves)


def _multiproof_node_positions(indices: np.ndarray, depth: int):
    """Canonical (level, position) list of non-derivable sibling nodes."""
    known = sorted({int(i) for i in indices})
    needed = []
    for _d in range(depth):
        kset = set(known)
        level_needed = sorted({p ^ 1 for p in kset} - kset)
        needed.append(level_needed)
        known = sorted({p >> 1 for p in kset})
    return needed


def build_multiproof(tree: MerkleTree, all_leaves: torch.Tensor,
                     indices) -> MerkleMultiProof:
    """Open a set of leaf positions with shared prefixes deduplicated."""
    idx = np.array(sorted({int(i) for i in indices}), dtype=np.int64)
    depth = len(tree.levels) - 1
    nodes = []
    for d, level_needed in enumerate(_multiproof_node_positions(idx, depth)):
        if level_needed:
            sel = torch.as_tensor(level_needed, device=tree.levels[d].device)
            nodes.append(F.to_np(tree.levels[d][sel]))
    leaves = F.to_np(all_leaves[torch.as_tensor(idx, device=all_leaves.device)])
    return MerkleMultiProof(
        indices=idx, leaves=leaves,
        nodes=np.concatenate(nodes) if nodes else np.zeros((0, P2.DIGEST),
                                                           np.uint32),
        depth=depth)


def multiproof_from_paths(indices, leaf_rows: np.ndarray,
                          paths: List[MerklePath], depth: int
                          ) -> MerkleMultiProof:
    """Rebuild the deduplicated multiproof from per-leaf paths (used when
    re-encoding a v1 attestation to v2 without access to the tree)."""
    order = np.argsort(np.asarray(indices, dtype=np.int64), kind="stable")
    seen = {}
    for o in order:
        i = int(indices[o])
        if i not in seen:
            seen[i] = (np.asarray(leaf_rows[o]), paths[o])
    idx = np.array(sorted(seen), dtype=np.int64)
    leaves = np.stack([seen[i][0] for i in idx]) if len(idx) else \
        np.zeros((0, 0), np.uint32)
    by_level: List[dict] = [{} for _ in range(depth)]
    for i in idx:
        _, path = seen[int(i)]
        assert path.siblings.shape[0] == depth, "path depth mismatch"
        for d in range(depth):
            by_level[d][(int(i) >> d) ^ 1] = path.siblings[d]
    nodes = []
    for d, level_needed in enumerate(
            _multiproof_node_positions(idx, depth)):
        for p in level_needed:
            nodes.append(np.asarray(by_level[d][p]))
    return MerkleMultiProof(
        indices=idx, leaves=leaves.astype(np.uint32),
        nodes=np.stack(nodes) if nodes else np.zeros((0, P2.DIGEST),
                                                     np.uint32),
        depth=depth)


def verify_multiproof(root: np.ndarray, mp: MerkleMultiProof,
                      device=None) -> bool:
    """Recompute the root from a multiproof; every node must be consumed.
    Each level's compressions run as one batched launch."""
    device = resolve_device(device)
    if not isinstance(mp, MerkleMultiProof):
        return False
    idx = np.asarray(mp.indices)
    nodes = np.asarray(mp.nodes)
    leaves = np.asarray(mp.leaves)
    if (idx.ndim != 1 or not np.issubdtype(idx.dtype, np.integer)
            or leaves.ndim != 2 or leaves.shape[0] != idx.shape[0]
            or nodes.ndim != 2 or nodes.shape[1:] != (P2.DIGEST,)
            or not isinstance(mp.depth, int) or mp.depth < 0
            or mp.depth > 40):
        return False
    if idx.shape[0] == 0:
        return False
    if idx.min() < 0 or idx.max() >= (1 << mp.depth):
        return False
    if np.any(np.diff(idx) <= 0):        # sorted + unique is canonical
        return False
    if not (np.issubdtype(leaves.dtype, np.integer)
            and np.issubdtype(nodes.dtype, np.integer)):
        return False
    digs = K1.hash_rows(F.tensor(leaves, device))
    digests = {int(i): digs[k] for k, i in enumerate(idx)}
    node_t = F.tensor(nodes, device)
    cursor = 0
    for _d in range(mp.depth):
        kset = set(digests)
        level_needed = sorted({p ^ 1 for p in kset} - kset)
        for p in level_needed:
            if cursor >= nodes.shape[0]:
                return False
            digests[p] = node_t[cursor]
            cursor += 1
        parents = sorted({q >> 1 for q in kset})
        left = torch.stack([digests[2 * p] for p in parents])
        right = torch.stack([digests[2 * p + 1] for p in parents])
        out = K1.compress_pairs(left.contiguous(), right.contiguous())
        digests = {p: out[k] for k, p in enumerate(parents)}
    if cursor != nodes.shape[0]:         # extra nodes = non-canonical proof
        return False
    return bool(np.array_equal(F.to_np(digests[0]), np.asarray(root)))
