"""Regenerate the long-row PCS golden (run from the repo root):

    PYTHONPATH=src python tests/data/gen_golden_pcs_long.py

The vector of tests/test_torch_pcs_long.py: 2^16 field words from
``np.random.default_rng(61)`` (the first four set to 0, 1, P-1, P-2),
committed by ``repro.core.pcs.commit`` at ``aspect=-6`` (4 rows of 2^14
words, codewords of 2^16, longer than one launch of the card's row NTT
holds) and opened at ONE point, the test's first (seed 70), from a fresh
``Transcript("long-rows")``: the unbatched opening with its proximity row
``u_prox``.  Keeps, in tests/data/golden_pcs_long.npz:

    root           the commitment's Merkle root
    us             the opening's row (1, 2^14, 4)
    u_prox         the proximity row (2^14, 4)
    columns        the queried columns (queries, 4)
    path_index     each column's index
    path_siblings  each column's Merkle path (queries, depth, 8)
    state          the transcript's state after the opening
    value          the committed polynomial's value at the point

Nothing is written unless ``repro.core.pcs.verify_openings`` accepts the
bundle and the verifier's transcript ends in the prover's state.

Every word follows from the seeds and Fiat-Shamir.
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..",
                                "src"))

import jax.numpy as jnp                                 # noqa: E402

from repro.core import field as F                       # noqa: E402
from repro.core import pcs as PCS                       # noqa: E402
from repro.core.transcript import Transcript            # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
N_WORDS = 1 << 16
ASPECT = -6
VEC_SEED = 61
POINT_SEED = 70
LABEL = "long-rows"


def words(seed, shape):
    """The test's words: uniform below P, the first four at the edges."""
    a = np.random.default_rng(seed).integers(0, F.P, size=shape,
                                             dtype=np.int64)
    flat = a.reshape(-1)
    flat[:4] = [0, 1, F.P - 1, F.P - 2]
    return a.astype(np.uint32)


def main():
    params = PCS.PCSParams()
    com = PCS.commit(jnp.asarray(words(VEC_SEED, (N_WORDS,))), params,
                     aspect=ASPECT)
    point = words(POINT_SEED, (com.log_r + com.log_c, 4))
    tr = Transcript(LABEL)
    bundle = PCS.prove_openings(com, [jnp.asarray(point)], tr, params)
    assert bundle.u_prox is not None and bundle.batch_sc is None
    out = dict(root=np.asarray(com.root),
               us=np.asarray(bundle.us),
               u_prox=np.asarray(bundle.u_prox),
               columns=np.asarray(bundle.columns),
               path_index=np.asarray([p.index for p in bundle.paths],
                                     np.int64),
               path_siblings=np.stack([np.asarray(p.siblings)
                                       for p in bundle.paths]),
               state=np.asarray(tr.state))
    value = PCS.eval_at(com, jnp.asarray(point))
    vt = Transcript(LABEL)
    assert PCS.verify_openings(com.root, com.log_r, com.log_c,
                               [jnp.asarray(point)], [value], bundle, vt,
                               params)
    assert np.array_equal(np.asarray(vt.state), out["state"])
    out["value"] = np.asarray(value)
    path = os.path.join(HERE, "golden_pcs_long.npz")
    np.savez_compressed(path, **out)
    print(f"golden_pcs_long.npz: {os.path.getsize(path)} B; "
          + ", ".join(f"{k} {v.shape} {v.dtype}" for k, v in out.items()))


if __name__ == "__main__":
    main()
