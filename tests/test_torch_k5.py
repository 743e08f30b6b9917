"""K5's launch plan (``repro_torch.kernels.sumcheck_fold.plan``) on the
CPU: for every d and every n = 2 .. 2^27, on an H100 SXM's 132 SMs and on
a PCIe card's 114, a numpy transliteration of the kernel's indexing visits
every pair exactly once, every pair's words start on a 16-byte boundary,
the grid fits what the card holds at once, and the scratch holds every
block's partial row of g.  The kernel itself runs only on the card
(tests/test_torch_cuda.py::test_k5_sumcheck_fold)."""
import numpy as np
import pytest

from repro_torch.kernels import sumcheck_fold as K5

CASES = [(d, lg) for d in (1, 2, 3) for lg in range(1, 28)]
SM_COUNTS = (K5.SMS, 114)           # H100 SXM, H100 PCIe
FULL_SIMULATION_PAIRS = 1 << 21     # above it, tiles are simulated, not pairs


def _visits(p):
    """Tile indices in the order the kernel's blocks take them: block b
    counts its tiles as mine = (tiles - 1 - b) / grid + 1 and walks k two
    at a time (tile b + k grid, and b + (k + 1) grid when k + 1 < mine)."""
    out = []
    for b in range(p.grid):
        mine = (p.tiles - 1 - b) // p.grid + 1
        first = b + np.arange(0, mine, 2) * p.grid
        second = (first + p.grid)[np.arange(0, mine, 2) + 1 < mine]
        out += [first, second]
    return np.concatenate(out)


@pytest.mark.parametrize("sms", SM_COUNTS)
@pytest.mark.parametrize("d,lg", CASES)
def test_plan_covers_every_pair_once(d, lg, sms):
    n = 1 << lg
    half = n // 2
    p = K5.plan(d, n, sms)
    # a persistent grid: never more blocks than tiles or than the card
    # holds at once (a cooperative launch refuses more)
    assert 1 <= p.grid <= min(p.tiles, sms * K5.BLOCKS_PER_SM)
    assert p.tiles == -(-half // K5.THREADS)
    # a tile is THREADS pairs, or the only one when half is smaller
    assert p.tile == min(half, K5.THREADS)
    assert p.tiles == 1 or half % K5.THREADS == 0
    tiles = _visits(p)
    assert np.array_equal(np.bincount(tiles, minlength=p.tiles), np.ones(p.tiles))
    if half <= FULL_SIMULATION_PAIRS:
        # thread j of a block takes pair j of each of its tiles, j < tile
        pairs = (tiles[:, None] * K5.THREADS + np.arange(p.tile)[None, :]).ravel()
        assert pairs.max() < half
        assert np.array_equal(np.bincount(pairs, minlength=half), np.ones(half))


@pytest.mark.parametrize("d", [1, 2, 3])
def test_plan_alignment_and_scratch(d):
    for sms in SM_COUNTS:
        for lg in range(1, 28):
            n = 1 << lg
            half = n // 2
            p = K5.plan(d, n, sms)
            # each pair's lo and hi words (4 int64, 32 bytes) start on a
            # 16-byte boundary of an aligned factor: two 16-byte loads
            first = np.arange(p.tiles, dtype=np.int64) * K5.THREADS
            assert not np.any((first * 32) % 16)
            assert not np.any(((first + half) * 32) % 16)
            # a (d + 1) x 4 row for every block when there is more than one
            assert p.scratch_words == (p.grid * (d + 1) * 4 if p.grid > 1 else 0)
            # the one allocation (folded factors, g, partials) stays whole rows
            assert p.scratch_words % 4 == 0


def test_plan_is_a_pure_function_of_its_arguments():
    assert K5.plan(2, 1 << 19) == K5.plan(2, 1 << 19, K5.SMS)
    assert K5.plan(2, 1 << 19, 114).grid == 114 * K5.BLOCKS_PER_SM
    assert K5.plan(2, 16).grid == 1 and K5.plan(2, 16).scratch_words == 0
