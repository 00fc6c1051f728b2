"""Statistical reductions shared by the analyses, on the caller's device.

Counterpart of ``nanopore_tpu/ops/reductions.py``, whose functions are
XLA ops (``jnp.bincount``, scatter-add), not Pallas kernels: here they
are torch library calls (``torch.bincount``, ``index_add_``) on the
device of the tensors they are given.  Array-likes that are not tensors
go to the CPU; the analyses hand in tensors on their own device.
Counts are int64 on every device.

The JAX module's quirks are kept:
- ``kmer_count_vector`` counts windows [i-k, i) for i in [k, len), so
  the final window is dropped (the reference's enumeration,
  kmerAnalysis.py:16-19), and a sequence with fewer than k + 1 codes
  counts nothing;
- a window holding an N goes to an overflow bin that is cut off;
- ``length_histogram`` clips lengths into [0, num_bins - 1];
- ``positional_base_expectations`` wraps negative positions once and
  drops those outside [0, ref_len), as ``.at[].add`` does.
"""

from __future__ import annotations

import torch


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def substitution_counts(ref_codes, read_codes) -> torch.Tensor:
    """(5, 5) int64 substitution count matrix over aligned pairs.

    Index = refBase * 5 + readBase with N bucketed at 4 — the
    SubstitutionMatrix layout (reference substitutions.py:9-56).
    """
    ref_codes, read_codes = _tensor(ref_codes), _tensor(read_codes)
    idx = ref_codes.long() * 5 + read_codes.long()
    return torch.bincount(idx, minlength=25)[:25].reshape(5, 5)


def kmer_count_vector(codes, k: int) -> torch.Tensor:
    """(4^k,) int64 counts of valid (N-free) k-mers over a code array."""
    codes = _tensor(codes)
    n = codes.shape[0]
    if n < k + 1:
        return torch.zeros(4**k, dtype=torch.int64, device=codes.device)
    windows = codes.long().unfold(0, k, 1)[:-1]  # drop the final window
    powers = 4 ** torch.arange(k - 1, -1, -1, device=codes.device)
    ok = windows < 4
    idx = (torch.where(ok, windows, 0) * powers).sum(dim=1)
    idx = torch.where(ok.all(dim=1), idx, 4**k)  # the overflow bin
    return torch.bincount(idx, minlength=4**k + 1)[: 4**k]


def revcomp_kmer_counts(counts, k: int) -> torch.Tensor:
    """counts[kmer] -> counts[revcomp(kmer)]."""
    counts = _tensor(counts)
    tmp = torch.arange(4**k, device=counts.device)
    rc = torch.zeros_like(tmp)
    for _ in range(k):
        rc = rc * 4 + (3 - tmp % 4)
        tmp = tmp // 4
    return torch.zeros_like(counts).index_add_(0, rc, counts)


def length_histogram(lengths, num_bins: int = 1 << 16) -> torch.Tensor:
    lengths = _tensor(lengths).long()
    return torch.bincount(lengths.clamp(0, num_bins - 1), minlength=num_bins)


def positional_base_expectations(
    ref_positions, read_codes, probs, ref_len: int
) -> torch.Tensor:
    """(ref_len, 4) expected base observations per reference position.

    The SNP caller's accumulation of posterior base expectations
    (reference marginAlignSnpCaller.py:149-155) as one scatter-add.
    """
    ref_positions = _tensor(ref_positions).long()
    read_codes, probs = _tensor(read_codes), _tensor(probs)
    bases = torch.arange(4, device=read_codes.device)
    onehot = (read_codes.long()[:, None] == bases[None, :]).to(probs.dtype)
    onehot = onehot * probs[:, None]
    pos = torch.where(ref_positions < 0, ref_positions + ref_len,
                      ref_positions)
    keep = (pos >= 0) & (pos < ref_len)
    out = torch.zeros((ref_len, 4), dtype=probs.dtype, device=probs.device)
    return out.index_add_(0, pos[keep], onehot[keep])
