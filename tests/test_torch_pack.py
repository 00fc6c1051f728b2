"""Port's stream pack and plain band pack vs the JAX package.

The plain pack must write the same bytes as the JAX packer kernel
(``materialize_xyc``, interpret mode) and the JAX host pack, once the
JAX package's lane tiling is undone.
"""

import numpy as np
import pytest
import torch

from nanopore_tpu.align.model import PairHmmModel as JaxModel
from nanopore_tpu.io.sam import CIG
from nanopore_tpu.ops.pack_pallas import materialize_xyc
from nanopore_tpu.ops.pack_pallas import pack_stream_pairs as jax_stream
from nanopore_tpu.ops.pairhmm import make_kernel_params as jax_params
from nanopore_tpu.ops.pairhmm_pallas_realign import pack_pallas_pairs
from nanopore_tpu_torch.ops.pack import pack_stream_pairs, pack_xyc
from nanopore_tpu_torch.ops.realign import untile


def _guide_pairs(rng):
    """The mixed geometries of tests/test_pack_pallas.py: pure match,
    deletions, insertions, leading indels, N bases, very short reads."""
    pairs = []
    for cig in [
        [(CIG.M, 60)],
        [(CIG.M, 20), (CIG.D, 10), (CIG.M, 25)],
        [(CIG.M, 25), (CIG.I, 12), (CIG.M, 25)],
        [(CIG.I, 5), (CIG.M, 40), (CIG.D, 7), (CIG.M, 10)],
        [(CIG.D, 9), (CIG.M, 30), (CIG.I, 3)],
        [(CIG.M, 4)],
    ]:
        n = sum(ln for op, ln in cig if op in (CIG.M, CIG.D))
        m = sum(ln for op, ln in cig if op in (CIG.M, CIG.I))
        x = rng.integers(0, 4, n).astype(np.int8)
        y = rng.integers(0, 5, m).astype(np.int8)  # incl. N codes
        pairs.append((x, y, cig))
    return pairs


@pytest.fixture(scope="module")
def jparams():
    return jax_params(JaxModel.default())


def _port_xyc(prep):
    t = torch.from_numpy
    return pack_xyc(
        t(prep["stream"]), t(prep["initx"]), t(prep["m"]), t(prep["n"])
    ).numpy()


@pytest.mark.parametrize("W", [32, 64])
def test_host_stream_matches_jax(jparams, W):
    pairs = _guide_pairs(np.random.default_rng(7))
    want = jax_stream(pairs, jparams, band_width=W)
    got = pack_stream_pairs(pairs, band_width=W)
    B = len(pairs)
    assert (got["k_pad"], got["K"], got["B"], got["W"]) == (
        want["k_pad"], want["K"], want["B"], want["W"]
    )
    np.testing.assert_array_equal(
        got["stream"], untile(want["stream"], B).reshape(B, -1).view(np.uint8)
    )
    np.testing.assert_array_equal(
        got["initx"], untile(want["initx"], B).view(np.uint8)
    )
    np.testing.assert_array_equal(got["offsets"], want["offsets"])
    np.testing.assert_array_equal(got["m"], want["m"])
    np.testing.assert_array_equal(got["n"], want["n"])
    np.testing.assert_array_equal(got["k_end"], want["k_end"])


@pytest.mark.parametrize("W", [32, 64])
def test_plain_pack_matches_jax_kernel_and_host_pack(jparams, W):
    pairs = _guide_pairs(np.random.default_rng(7))
    B = len(pairs)
    got = _port_xyc(pack_stream_pairs(pairs, band_width=W))
    kernel = materialize_xyc(jax_stream(pairs, jparams, band_width=W),
                             interpret=True)
    np.testing.assert_array_equal(got, untile(kernel["xyc"], B))
    host = pack_pallas_pairs(pairs, jparams, band_width=W)
    np.testing.assert_array_equal(got, untile(host["xyc"], B))


def test_tight_kmax_multi_chunk(jparams):
    """k_pad over several 128-diagonal chunks and an explicit k_max."""
    rng = np.random.default_rng(11)
    n = 200
    x = rng.integers(0, 4, n).astype(np.int8)
    y = x.copy()
    y[rng.integers(0, n, 30)] = rng.integers(0, 4, 30)
    pairs = [
        (x, y, [(CIG.M, n)]),
        (x[:150], y[:120], [(CIG.M, 100), (CIG.D, 50), (CIG.I, 20)]),
    ]
    got = _port_xyc(pack_stream_pairs(pairs, 64, k_max=512))
    want = pack_pallas_pairs(pairs, jparams, 64, k_max=512)
    np.testing.assert_array_equal(got, untile(want["xyc"], len(pairs)))


def test_kernel_wrapper_checks_inputs():
    prep = pack_stream_pairs(_guide_pairs(np.random.default_rng(3)), 32)
    t = torch.from_numpy
    with pytest.raises(TypeError):
        pack_xyc(t(prep["stream"]).to(torch.int32), t(prep["initx"]),
                 t(prep["m"]), t(prep["n"]))
    with pytest.raises(ValueError):
        pack_xyc(t(prep["stream"]), t(prep["initx"]), t(prep["m"][:2]),
                 t(prep["n"]))


# ---- the identity the pack kernel rests on (csrc/pack.cu) ----

CHUNK = 256  # the kernel's diagonals a chunk


def _scan_lookup_pack(stream, initx, m, n):
    """A numpy model of csrc/pack.cu: per chunk of 256 diagonals, the
    band offsets o_k by a prefix sum of bit 6 carried across chunks, the
    entering symbols scattered into the chunk's linear X and reversed Y
    buffers headed by the last W symbols of the chunk before, and every
    cell a lookup at X[o_k + w] and Y[c_k - w].  Each buffer is cleared
    (-1) before the chunk writes it and every read is bounds-checked, so
    a match shows that the kernel's lookups touch only what that chunk
    wrote, at its shared-memory positions."""
    B, k_pad = stream.shape
    W = initx.shape[1]
    size = CHUNK + W
    w = np.arange(W)
    out = np.empty((B, k_pad, W), np.uint8)

    def at(buf, pos, used):
        assert pos.min() >= 0 and pos.max() < size
        vals = buf[pos]
        assert (vals[used] >= 0).all(), "read a position the chunk never wrote"
        return vals

    for r in range(B):
        xb = np.full((2, size), -1, np.int64)
        yb = np.full((2, size), -1, np.int64)
        o_base = c_base = o_prev = c_prev = 0
        for q in range(-(-k_pad // CHUNK)):
            cur, base = q & 1, q * CHUNK
            rows = min(CHUNK, k_pad - base)
            xb[cur] = -1
            yb[cur] = -1
            sb = stream[r, base:base + rows].astype(np.int64)
            d1 = (sb >> 6) & 1
            o = o_base + np.cumsum(d1)
            c = base + 1 + np.arange(rows) - o
            ent = sb & 7
            xs, ys = W - 1 + o[d1 == 1] - o_base, c_base + CHUNK - c[d1 == 0]
            for pos in (xs, ys):
                assert pos.size == 0 or (pos.min() >= 0 and pos.max() < size)
            xb[cur, xs] = ent[d1 == 1]
            yb[cur, ys] = ent[d1 == 0]
            if q == 0:
                xb[cur, :W] = initx[r]
            else:
                xb[cur, :W] = xb[cur ^ 1, o_base - o_prev + w]
                yb[cur, CHUNK + w] = yb[cur ^ 1, c_prev + CHUNK - c_base + w]
            j = o[:, None] + w
            i = c[:, None] - w
            ok = (j <= n[r]) & (i >= 0) & (i <= m[r])
            xv = np.where(ok & (j >= 1), at(xb[cur], (o - o_base)[:, None] + w,
                                            ok & (j >= 1)), 5)
            yv = np.where(ok & (i >= 1),
                          at(yb[cur], (c_base + CHUNK - c)[:, None] + w,
                             ok & (i >= 1)), 5)
            out[r, base:base + rows] = (xv * 8 + yv + (sb & 0xC0)[:, None]) & 0xFF
            o_prev, c_prev = o_base, c_base
            o_base += int(d1.sum())
            c_base += rows - int(d1.sum())
    return out.view(np.int8)


def _plain(stream, initx, m, n):
    t = torch.from_numpy
    return pack_xyc(t(stream), t(initx), t(m), t(n)).numpy()


@pytest.mark.parametrize("W", [32, 64])
@pytest.mark.parametrize("k_pad", [128, 896])
def test_scan_lookup_model_matches_plain_pack_on_random_bytes(W, k_pad):
    """Arbitrary stream bytes (every d1 pattern, symbols 0-7 and top bits
    the host never sends), arbitrary initx bytes, reads shorter than one
    chunk, across chunks and past k_pad: byte for byte the plain pack."""
    rng = np.random.default_rng(W + k_pad)
    B = 6
    stream = rng.integers(0, 256, (B, k_pad)).astype(np.uint8)
    stream[1] &= 0xBF  # never shifts: Y alone
    stream[2] |= 0x40  # always shifts: X alone
    initx = rng.integers(0, 256, (B, W)).astype(np.uint8)
    m = np.array([40, 300, k_pad + 50, 0, 7, k_pad // 2], np.int32)
    n = np.array([90, k_pad + 9, 60, 5, 0, k_pad // 2], np.int32)
    np.testing.assert_array_equal(_scan_lookup_pack(stream, initx, m, n),
                                  _plain(stream, initx, m, n))


@pytest.mark.parametrize("W", [32, 64])
def test_scan_lookup_model_matches_plain_pack_on_host_streams(W):
    """The host's streams of guided pairs over several chunks, beside a
    read shorter than one chunk."""
    rng = np.random.default_rng(5 + W)
    pairs = _guide_pairs(rng)
    for L in (300, 520):
        x = rng.integers(0, 4, L).astype(np.int8)
        y = np.concatenate([x[:L // 3], x[L // 3 + 12:]])
        y = np.where(rng.random(len(y)) < 0.1, 4, y).astype(np.int8)
        pairs.append((x, y, [(CIG.M, L // 3), (CIG.D, 12),
                             (CIG.M, len(y) - L // 3)]))
    prep = pack_stream_pairs(pairs, band_width=W)
    assert prep["k_pad"] > 3 * CHUNK
    args = (prep["stream"], prep["initx"], prep["m"], prep["n"])
    np.testing.assert_array_equal(_scan_lookup_pack(*args), _plain(*args))
