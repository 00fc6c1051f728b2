"""The port's ``ops/reductions.py`` against the JAX package's, on the CPU.

Seeded numpy inputs through both; counts must be identical (the port's
are int64), ``positional_base_expectations`` within 1e-6 relative.  The
edge cases: an empty input, fewer than k + 1 codes, N codes, lengths
above ``num_bins``, repeated and negative positions.
"""

import numpy as np
import pytest
import torch

from nanopore_tpu.ops import reductions as jax_red
from nanopore_tpu_torch.ops import reductions as red


def _codes(rng, n, n_share=0.0):
    codes = rng.integers(0, 4, n).astype(np.int8)
    codes[rng.random(n) < n_share] = 4
    return codes


def _jax_length_histogram(lengths, num_bins):
    """The JAX function jits ``num_bins`` as a traced value, so only its
    default traces; other bin counts run its body eagerly."""
    if num_bins == 1 << 16:
        return jax_red.length_histogram(lengths)
    return jax_red.length_histogram.__wrapped__(lengths, num_bins)


def _same_counts(port, jax_out):
    assert port.dtype == torch.int64
    np.testing.assert_array_equal(port.numpy(), np.asarray(jax_out))


@pytest.mark.parametrize("n,n_share", [(0, 0.0), (1, 0.0), (500, 0.0),
                                       (500, 0.1), (64, 1.0)])
def test_substitution_counts(n, n_share):
    rng = np.random.default_rng(n + int(10 * n_share))
    ref, read = _codes(rng, n, n_share), _codes(rng, n, n_share)
    port = red.substitution_counts(torch.from_numpy(ref),
                                   torch.from_numpy(read))
    assert port.shape == (5, 5)
    _same_counts(port, jax_red.substitution_counts(ref, read))


@pytest.mark.parametrize("n,k,n_share", [
    (0, 5, 0.0),  # empty
    (3, 3, 0.0),  # n < k + 1: zeros
    (4, 3, 0.0),  # n == k + 1: the one window kept
    (6, 5, 0.0),
    (300, 5, 0.0),
    (300, 5, 0.05),  # windows with an N go to the cut overflow bin
    (200, 3, 1.0),  # all N
    (1000, 1, 0.2),
])
def test_kmer_count_vector(n, k, n_share):
    rng = np.random.default_rng(7 * n + k)
    codes = _codes(rng, n, n_share)
    port = red.kmer_count_vector(torch.from_numpy(codes), k)
    assert port.shape == (4**k,)
    _same_counts(port, jax_red.kmer_count_vector(codes, k))


@pytest.mark.parametrize("k", [1, 2, 5])
def test_revcomp_kmer_counts(k):
    rng = np.random.default_rng(k)
    counts = rng.integers(0, 50, 4**k).astype(np.int64)
    port = red.revcomp_kmer_counts(torch.from_numpy(counts), k)
    _same_counts(port, jax_red.revcomp_kmer_counts(counts, k))


@pytest.mark.parametrize("num_bins", [1, 16, 1 << 16])
def test_length_histogram(num_bins):
    rng = np.random.default_rng(num_bins)
    lengths = rng.integers(-5, 3 * num_bins + 5, 400).astype(np.int32)
    lengths[:3] = [0, num_bins - 1, num_bins]  # the top bin and past it
    port = red.length_histogram(torch.from_numpy(lengths), num_bins)
    _same_counts(port, _jax_length_histogram(lengths, num_bins))


def test_length_histogram_empty():
    lengths = np.zeros(0, np.int32)
    port = red.length_histogram(torch.from_numpy(lengths), 8)
    _same_counts(port, _jax_length_histogram(lengths, 8))


@pytest.mark.parametrize("n,ref_len,lo", [
    (0, 10, 0),  # empty
    (400, 50, 0),  # repeated positions
    (400, 50, -50),  # negative positions wrap, as .at[].add does
    (300, 1000, 0),
])
def test_positional_base_expectations(n, ref_len, lo):
    rng = np.random.default_rng(n + ref_len)
    pos = rng.integers(lo, ref_len, n).astype(np.int32)
    codes = _codes(rng, n, 0.1)
    probs = rng.random(n).astype(np.float32)
    port = red.positional_base_expectations(
        torch.from_numpy(pos), torch.from_numpy(codes),
        torch.from_numpy(probs), ref_len)
    want = np.asarray(jax_red.positional_base_expectations(
        pos, codes, probs, ref_len))
    assert port.shape == (ref_len, 4) and port.dtype == torch.float32
    np.testing.assert_allclose(port.numpy(), want, rtol=1e-6, atol=0)


def test_reductions_take_numpy_and_stay_on_the_tensors_device():
    """Array-likes go to the CPU; a tensor's device is kept (``meta``
    stands in for a card here: shapes and dtypes only)."""
    codes = np.array([0, 1, 2, 3, 0, 1], np.int8)
    assert red.kmer_count_vector(codes, 2).device.type == "cpu"
    meta = torch.empty(6, dtype=torch.int8, device="meta")
    out = red.revcomp_kmer_counts(
        torch.empty(16, dtype=torch.int64, device="meta"), 2)
    assert out.device.type == "meta"
    assert red.kmer_count_vector(meta[:2], 2).device.type == "meta"
