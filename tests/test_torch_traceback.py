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
