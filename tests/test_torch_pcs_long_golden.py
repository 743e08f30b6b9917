"""The long-row PCS opening at ONE point (the unbatched opening, with its
proximity row ``u_prox``) against the JAX package's, stored by
tests/data/gen_golden_pcs_long.py: the port commits the 2^16-word vector
of tests/test_torch_pcs_long.py at ``aspect=-6`` (codeword rows of 2^16
words, which K2 encodes in two launches on the card; its plain version
here) and opens it at the first point, from a fresh transcript.  Equal
word for word: the root, ``us``, ``u_prox``, the queried columns, their
Merkle paths and the transcript's final state; the port's verifier
accepts the golden bundle at the golden value and ends in the same
state.  The same check runs on the card in chip_smoke's k2long phase."""
import os

import numpy as np
import pytest

from repro_torch.core import field as F
from repro_torch.core import pcs as PCS
from repro_torch.core.merkle import MerklePath
from repro_torch.core.transcript import Transcript
from test_torch_pcs_long import ASPECT, N_WORDS, _one_thread, _words

GOLD = os.path.join(os.path.dirname(__file__), "data", "golden_pcs_long.npz")


@pytest.fixture(scope="module")
def opened():
    gold = dict(np.load(GOLD))
    params = PCS.PCSParams()
    with _one_thread():
        com = PCS.commit(F.tensor(_words(61, (N_WORDS,)), "cpu"), params,
                         aspect=ASPECT)
        point = _words(70, (com.log_r + com.log_c, 4))
        tr = Transcript("long-rows", "cpu")
        bundle = PCS.prove_openings(com, [F.tensor(point, "cpu")], tr, params)
    return gold, params, com, point, bundle, tr


def test_one_point_opening_equals_the_golden(opened):
    gold, _, com, _, bundle, tr = opened
    assert (com.log_r, com.log_c) == (2, 14)
    assert np.array_equal(np.asarray(com.root), gold["root"])
    assert bundle.batch_sc is None
    assert np.array_equal(np.asarray(bundle.us), gold["us"])
    assert np.array_equal(np.asarray(bundle.u_prox), gold["u_prox"])
    assert np.array_equal(np.asarray(bundle.columns), gold["columns"])
    assert [p.index for p in bundle.paths] == gold["path_index"].tolist()
    assert np.array_equal(np.stack([np.asarray(p.siblings)
                                    for p in bundle.paths]),
                          gold["path_siblings"])
    assert np.array_equal(F.to_np(tr.state), gold["state"])


def test_port_verifies_the_golden_bundle(opened):
    gold, params, com, point, _, _ = opened
    bundle = PCS.OpeningBundle(
        us=gold["us"], u_prox=gold["u_prox"], columns=gold["columns"],
        paths=[MerklePath(int(i), s) for i, s in
               zip(gold["path_index"], gold["path_siblings"])])
    vt = Transcript("long-rows", "cpu")
    with _one_thread():
        ok = PCS.verify_openings(gold["root"], com.log_r, com.log_c,
                                 [F.tensor(point, "cpu")],
                                 [F.tensor(gold["value"], "cpu")], bundle,
                                 vt, params)
    assert ok
    assert np.array_equal(F.to_np(vt.state), gold["state"])
