"""Pair-HMM tables and guide-band geometry for the kernels.

Counterpart of ``nanopore_tpu/ops/pairhmm.py:58-162``: the dense f32
probability tables the kernels read (``KernelParams``) and the host-side
band construction (``band_offsets_from_cigar``).

The DP lattice over cells (i, j) = (read consumed, ref consumed) is
restricted to a band of width W around the guide alignment and swept
along anti-diagonals k = i + j.  ``offsets[k]`` is the leftmost ref
coordinate j of the band on diagonal k: nondecreasing with steps in
{0, 1} (Lipschitz-1), and the first cell (0, 0) and the last cell (m, n)
sit at band index 0 of their diagonals.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from nanopore_tpu_torch.align.model import PairHmmModel
from nanopore_tpu_torch.io.sam import cigar_columns

DEFAULT_BAND_WIDTH = 64


@dataclass(frozen=True)
class KernelParams:
    """Dense f32 probability tables.

    t:            (5, 5) transitions [from, to]
    e_match_flat: (25,) match emissions [xcode * 5 + ycode] incl. N
    e_gap_flat:   (25,) per-state single-base emissions [state * 5 + base]
    """

    t: torch.Tensor
    e_match_flat: torch.Tensor
    e_gap_flat: torch.Tensor


def params_from_numpy(t, e_match_flat, e_gap_flat, device="cpu") -> KernelParams:
    """KernelParams from numpy tables (e.g. the JAX package's, pulled
    with ``np.asarray``), as f32 tensors on ``device``."""

    def f32(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    return KernelParams(
        t=f32(t).reshape(5, 5),
        e_match_flat=f32(e_match_flat).reshape(25),
        e_gap_flat=f32(e_gap_flat).reshape(25),
    )


def make_kernel_params(model: PairHmmModel, device="cpu") -> KernelParams:
    """The kernel tables of a model.  N (code 4) gets the mean row and
    column of the match table and the mean of each gap row."""
    match = model.match_emissions()
    e_match = np.zeros((5, 5), dtype=np.float32)
    e_match[:4, :4] = match
    e_match[4, :4] = match.mean(axis=0)
    e_match[:4, 4] = match.mean(axis=1)
    e_match[4, 4] = match.mean()
    gap = model.gap_emissions()
    e_gap = np.zeros((5, 5), dtype=np.float32)
    e_gap[:, :4] = gap
    e_gap[:, 4] = gap.mean(axis=1)
    return params_from_numpy(
        np.asarray(model.transitions, np.float32), e_match.reshape(-1),
        e_gap.reshape(-1), device,
    )


def kernel_tables(params: KernelParams) -> torch.Tensor:
    """(91,) f32 CPU tensor: transitions (25) | match emissions padded
    to (6, 6) (36) | gap emissions padded to (5, 6) (30).

    The zero row and column 5 make code 5 (the out-of-lattice sentinel)
    emit nothing, so a table lookup ``emf[x * 6 + y]`` needs no validity
    mask.  Derived anew from all three tables at every launch (91
    floats): no cache keyed on a table's identity.
    """
    t = params.t.detach().to("cpu", torch.float32).reshape(25)
    em = torch.zeros(6, 6, dtype=torch.float32)
    em[:5, :5] = params.e_match_flat.detach().to("cpu", torch.float32).reshape(5, 5)
    eg = torch.zeros(5, 6, dtype=torch.float32)
    eg[:, :5] = params.e_gap_flat.detach().to("cpu", torch.float32).reshape(5, 5)
    return torch.cat([t, em.reshape(36), eg.reshape(30)])


def band_offsets_from_cigar(
    cigar: list[tuple[int, int]], m: int, n: int, band_width: int,
    k_max: int | None = None,
) -> np.ndarray:
    """Band offsets o[k] for k in [0, k_max] from a guide alignment.

    ``cigar`` is a SAM-op cigar describing a global alignment of the read
    (length m, consumed by M/I) against the ref window (length n, consumed
    by M/D), soft/hard clips ignored.  The band on diagonal k covers ref
    coordinates [o[k], o[k] + W), centred on the guide path and clipped
    to the lattice.
    """
    if k_max is None:
        k_max = m + n
    di, dj = cigar_columns(cigar)
    i_path = np.concatenate([[0], np.cumsum(di)])
    j_path = np.concatenate([[0], np.cumsum(dj)])
    if i_path[-1] > m or j_path[-1] > n:
        raise ValueError("guide cigar overruns sequences")
    k_path = i_path + j_path
    ks = np.arange(k_max + 1)
    # centre c(k): guide path j at the first vertex with k_path >= k
    idx = np.searchsorted(k_path, np.minimum(ks, k_path[-1]))
    center = j_path[idx]
    lo = np.maximum(0, ks - m)
    hi = np.maximum(lo, np.minimum(ks, n) - band_width + 1)
    o = np.clip(center - band_width // 2, lo, hi)
    # Lipschitz-1 nondecreasing past the end of the real lattice
    o[ks > m + n] = o[m + n] if m + n <= k_max else o[-1]
    d = np.diff(o)
    if not ((d >= 0) & (d <= 1)).all():
        raise ValueError("band offsets not Lipschitz-1")
    return o.astype(np.int32)
