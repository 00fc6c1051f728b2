"""Port's plain MEA walker vs the JAX package's walkers.

The same direction codes go to the port's plain walker, the JAX Pallas
walker (interpret mode, CHUNK patched small) and the XLA scan walker:
the op codes must be identical, and so must the cigars.  Random codes
exercise every move and fallback rule.
"""

import numpy as np
import pytest
import torch

import nanopore_tpu.ops.traceback_pallas as tbp
from nanopore_tpu.io.sam import CIG
from nanopore_tpu.ops.mea import _traceback_ops_jit
from nanopore_tpu.ops.mea import mea_traceback_fwd as jax_walk_host
from nanopore_tpu.ops.mea import rle_ops_batch as jax_rle
from nanopore_tpu_torch.ops.pairhmm import band_offsets_from_cigar
from nanopore_tpu_torch.ops.traceback import (
    DIR_DEL,
    DIR_DIAG,
    DIR_INS,
    DIR_NONE,
    OP_NONE,
    mea_traceback_fwd,
    mea_walk,
    mea_walk_plain,
    rle_ops_batch,
)

GUIDES = [
    [(CIG.M, 60)],
    [(CIG.M, 20), (CIG.D, 10), (CIG.M, 25)],
    [(CIG.M, 25), (CIG.I, 12), (CIG.M, 25)],
    [(CIG.I, 5), (CIG.M, 40), (CIG.D, 7), (CIG.M, 10)],
    [(CIG.D, 9), (CIG.M, 30), (CIG.I, 3)],
    [(CIG.M, 4)],
]


@pytest.fixture(scope="module", autouse=True)
def small_walker_chunk():
    old = tbp.CHUNK
    tbp.CHUNK = 64
    yield
    tbp.CHUNK = old
    tbp._mea_tb_call.clear_cache()


def _case(seed, W, p_diag):
    """Direction codes biased towards diag moves (p_diag) plus the band
    deltas in bit 6 of an otherwise empty code tensor."""
    rng = np.random.default_rng(seed)
    ms, ns = [], []
    for cig in GUIDES:
        ns.append(sum(ln for op, ln in cig if op in (CIG.M, CIG.D)))
        ms.append(sum(ln for op, ln in cig if op in (CIG.M, CIG.I)))
    K = max(m + n for m, n in zip(ms, ns)) + 3
    offsets = np.stack([
        band_offsets_from_cigar(cig, m, n, W, K)
        for cig, m, n in zip(GUIDES, ms, ns)
    ])
    B = len(GUIDES)
    p = [p_diag, (1 - p_diag) * 0.4, (1 - p_diag) * 0.4,
         (1 - p_diag) * 0.2]
    dirs = rng.choice(4, size=(B, K + 1, W), p=p).astype(np.int8)
    d1 = (offsets[:, 1:] - offsets[:, :-1]).astype(np.uint8)
    xyc = np.broadcast_to((d1 << 6)[:, :, None], (B, K, W))
    return (dirs, np.ascontiguousarray(xyc).view(np.int8), offsets,
            np.array(ms, np.int32), np.array(ns, np.int32))


@pytest.mark.parametrize("W", [8, 32])
@pytest.mark.parametrize("p_diag", [0.9, 0.4])
def test_plain_walker_matches_jax_walkers(W, p_diag):
    dirs, xyc, offsets, ms, ns = _case(5, W, p_diag)
    B, K1, _ = dirs.shape
    t = torch.from_numpy
    got = mea_walk_plain(t(dirs), t(xyc), t(ms), t(ns)).numpy()

    xla = np.asarray(_traceback_ops_jit(dirs, offsets, ms, ns))
    np.testing.assert_array_equal(got, xla)

    raw = np.full((1, K1, W, tbp.BT), 3, np.int8)
    raw[0, :, :, :B] = dirs.transpose(1, 2, 0)
    pallas = tbp.mea_traceback_ops_pallas(raw, offsets, ms, ns,
                                          interpret=True)
    np.testing.assert_array_equal(got, pallas)

    cigars = rle_ops_batch(got)
    assert cigars == jax_rle(got)
    for b in range(B):
        host = mea_traceback_fwd(dirs[b], offsets[b], int(ms[b]), int(ns[b]))
        assert cigars[b] == host
        assert host == jax_walk_host(dirs[b], offsets[b], int(ms[b]),
                                     int(ns[b]))
        assert sum(ln for op, ln in host if op in (CIG.M, CIG.I)) == ms[b]
        assert sum(ln for op, ln in host if op in (CIG.M, CIG.D)) == ns[b]


def test_wrapper_routes_cpu_and_checks_inputs():
    dirs, xyc, _, ms, ns = _case(9, 32, 0.7)
    t = torch.from_numpy
    assert torch.equal(
        mea_walk(t(dirs), t(xyc), t(ms), t(ns)),
        mea_walk_plain(t(dirs), t(xyc), t(ms), t(ns)),
    )
    with pytest.raises(ValueError):
        mea_walk(t(dirs), t(xyc[:, :-1]), t(ms), t(ns))


def test_rle_of_empty_rows():
    ops = np.full((3, 7), 3, np.int8)
    ops[1, 2:5] = [0, 0, 1]
    assert rle_ops_batch(ops) == [[], [(CIG.M, 2), (CIG.D, 1)], []]


# ---- ragged batches, as the walker kernels see them ----

# (m, n) per read: unequal ends, one read about five times the others,
# one whose path must leave the band (m far from n), and one whose
# m + n lies above k_pad (a capped batch: its walk is cut at k_pad)
RAGGED_MN = [(20, 22), (25, 18), (30, 30), (12, 44), (150, 140), (18, 20),
             (200, 150)]
RAGGED_K = 300


def ragged_layout(rng, W):
    """The ragged batch's m, n, random Lipschitz band offsets (o[0] = 0,
    d1 in {0, 1}, drawn from ``rng``) and packed codes (B, RAGGED_K, W)
    carrying the deltas in bit 6, as the walkers read them."""
    B = len(RAGGED_MN)
    ms = np.array([m for m, _ in RAGGED_MN], np.int32)
    ns = np.array([n for _, n in RAGGED_MN], np.int32)
    d1 = (rng.random((B, RAGGED_K)) < 0.5).astype(np.int32)
    offsets = np.concatenate([np.zeros((B, 1), np.int32),
                              np.cumsum(d1, axis=1, dtype=np.int32)], axis=1)
    xyc = np.ascontiguousarray(np.broadcast_to(
        (d1.astype(np.uint8) << 6)[:, :, None], (B, RAGGED_K, W)))
    return ms, ns, offsets, xyc.view(np.int8)


def _ragged(seed, W, p_diag):
    """Random direction codes over :func:`ragged_layout`."""
    rng = np.random.default_rng(seed)
    ms, ns, offsets, xyc = ragged_layout(rng, W)
    p = [p_diag, (1 - p_diag) * 0.4, (1 - p_diag) * 0.4,
         (1 - p_diag) * 0.2]
    dirs = rng.choice(4, size=(len(ms), RAGGED_K + 1, W),
                      p=p).astype(np.int8)
    return dirs, xyc, offsets, ms, ns


def _off_band_steps(dirs, offsets, m, n):
    """Steps of the walk of one read whose cell lies outside the band."""
    W = dirs.shape[1]
    i = j = count = 0
    while (i < m or j < n) and i + j < len(offsets):
        k = i + j
        b = j - offsets[k]
        count += not 0 <= b < W
        d = dirs[k, b] if 0 <= b < W else DIR_NONE
        if d == DIR_DIAG and i < m and j < n:
            i, j = i + 1, j + 1
        elif d == DIR_DEL and j < n:
            j += 1
        elif d == DIR_INS and i < m:
            i += 1
        elif j < n:
            j += 1
        else:
            i += 1
    return count


@pytest.mark.parametrize("W", [32, 64])
@pytest.mark.parametrize("p_diag", [0.9, 0.4])
def test_ragged_batch_matches_jax_walkers(W, p_diag):
    """Reads of unequal m + n, one five times the others, k_pad well
    above most reads' ends, paths that leave the band, and a read cut at
    k_pad: the plain walker gives the XLA scan's and the Pallas walker's
    op codes, and 3 on every diagonal past each read's end."""
    dirs, xyc, offsets, ms, ns = _ragged(7 + W, W, p_diag)
    B, K1, _ = dirs.shape
    t = torch.from_numpy
    got = mea_walk_plain(t(dirs), t(xyc), t(ms), t(ns)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(_traceback_ops_jit(dirs, offsets, ms, ns)))
    raw = np.full((1, K1, W, tbp.BT), 3, np.int8)
    raw[0, :, :, :B] = dirs.transpose(1, 2, 0)
    np.testing.assert_array_equal(
        got, tbp.mea_traceback_ops_pallas(raw, offsets, ms, ns,
                                          interpret=True))
    ends = ms + ns
    assert ends[4] >= 5 * np.median(np.delete(ends, [4, 6]))
    assert ends[4] < K1 - 1 < ends[6]
    for b in range(B):
        assert (got[b, ends[b]:] == OP_NONE).all()
    # the band-escaping read takes fallback moves off the band
    assert _off_band_steps(dirs[3], offsets[3], ms[3], ns[3]) > 0
    assert mea_walk(t(dirs), t(xyc), t(ms), t(ns)).equal(t(got))


def test_cuda_wrapper_refuses_other_widths():
    """The kernels serve W = 32 and 64; a non-CPU tensor of another
    width raises before any launch (the meta device stands in for the
    card; CPU tensors of any width take the plain walker)."""
    dirs, xyc, _, ms, ns = _case(9, 8, 0.7)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="serve W"):
        mea_walk(t(dirs).to("meta"), t(xyc).to("meta"), t(ms).to("meta"),
                 t(ns).to("meta"))
