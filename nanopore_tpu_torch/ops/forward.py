"""Forward-only banded pair-HMM: the log-likelihood of each read.

Counterpart of ``nanopore_tpu/ops/pairhmm_pallas.py`` (its forward-only
kernel and ``pallas_forward_loglik``).  The JAX kernel needs one band
geometry for the whole batch (per-diagonal d1/d2 scalars); the port's
reads the packed codes every other kernel reads (per-read band deltas
in bits 6/7, sentinel 5), so a batch of mixed geometry is served too.
On a batch of one geometry it computes what the JAX kernel computes.

Numerics, shared by the kernel (``csrc/forward.cu``) and the plain
version below, operation for operation (the forward of
``ops.realign`` but for the log-scale sum):

* five-state scaled f32 recursion over the anti-diagonals, transitions
  summed before the band shift, match emission times (shifted sum times
  the rescale ratio r);
* rescale on even diagonals only, by the band maximum (``safe`` = 1
  where the maximum is not above 0, or is NaN), with
  ``ls += log(safe)``: a plain f32 sum, no Kahan term (the JAX
  kernel's);
* ``loglik = log(max(fin, 1e-37)) + ls`` at band cell 0 of diagonal
  m + n, ``fin`` the sum of the 5 states there (a NaN ``fin`` stays
  NaN).

The kernel's two-term gap sum: where the 12 transitions between two
different gap states are 0 (the canonical fiveState structure, every
shipped model; :func:`two_term_sum`), a gap state d sums only
``tf[0->d] p0 + tf[d->d] pd``.  The three other gap terms of the 5-way
sum are ``0 * ps``, a zero while ``ps`` is finite, and adding a zero
changes nothing, so the two sums agree to the bit on finite states.  A
non-finite state (after a rescale by a subnormal band maximum, whose
inverse overflows, or an overflow) makes ``0 * ps`` NaN; the kernel
checks every pair of diagonals before it keeps it and, at the first
check that fails, runs the rest of the read with the 5-way sum from
the states before that pair (``csrc/forward.cu`` gives the argument).
The plain version is the 5-way sum throughout.
"""

from __future__ import annotations

import ctypes

import torch

from nanopore_tpu_torch.kernels import build as kb
from nanopore_tpu_torch.ops.pack import VITERBI_BAND_WIDTHS
from nanopore_tpu_torch.ops.pairhmm import KernelParams, kernel_tables
from nanopore_tpu_torch.ops.realign import (
    NUM_STATES,
    _check_inputs,
    _forward_lookups,
    _seq_sum,
    _shift_at,
)

LAUNCHES = kb.LaunchCounter("forward")
_SIG = {
    "np_forward_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
    + [ctypes.c_void_p] * 3,
    "np_forward_attrs": [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "np_forward_rcp_check": [ctypes.c_void_p] * 2,
}


def two_term_sum(tables: torch.Tensor) -> bool:
    """True when the kernel may take its two-term gap sum: every one of
    the 12 transitions from one gap state to another, ``tf[g -> h]`` with
    g != h in 1..4, is exactly 0 (the canonical fiveState structure).
    ``tables`` is ``ops.pairhmm.kernel_tables``' output.  Not a user
    switch: where this holds both sums give the same bits
    (``csrc/forward.cu`` gives the argument)."""
    tf = tables[:25].reshape(NUM_STATES, NUM_STATES)  # [from, to]
    return all(bool(tf[g, h] == 0) for g in range(1, NUM_STATES)
               for h in range(1, NUM_STATES) if g != h)


def kernel_attributes(W: int, two_term: bool = True) -> dict:
    """The compiled kernel's registers, local-memory (spill) bytes per
    thread, static and dynamic shared memory per block (its staged
    chunks are dynamic above W = 256), and threads and reads per block at
    band width ``W`` (32, 64, 128, 256, 384, 512, 768 or 1024), for the
    two-term or
    the 5-way gap sum (needs the card: builds the kernel)."""
    lib = kb.library("forward", _SIG)
    vals = (ctypes.c_int * 6)()
    kb.check(lib, lib.np_forward_attrs(W, int(two_term), vals),
             "forward attrs")
    return dict(zip(("registers", "local_bytes", "static_smem",
                     "dynamic_smem", "threads", "reads"), vals))


def reciprocal_mismatches(device="cuda") -> int:
    """How many positive floats x (subnormals and inf included) get
    another bit pattern from the kernel's call-free reciprocal of the
    band maximum than from ``__frcp_rn`` (needs the card: builds and
    runs the kernel's check over all 2.1e9 of them; 0 is the claim)."""
    lib = kb.library("forward", _SIG)
    dev = torch.device(device)
    bad = torch.zeros(1, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = lib.np_forward_rcp_check(kb.ptr(bad), kb.stream_of(bad))
    kb.check(lib, rc, "forward rcp check")
    return int(bad.item())


def forward_loglik(xyc, m, n, params: KernelParams) -> torch.Tensor:
    """Forward log-likelihood (B,) f32 over packed band codes.

    xyc (B, k_pad, W) int8, m / n (B,) int32 read / window lengths.
    CUDA tensors launch the kernel, CPU tensors run the plain version.
    """
    _check_inputs(xyc, m, n)
    if xyc.device.type == "cpu":
        return forward_loglik_plain(xyc, m, n, params)
    tables = kernel_tables(params)
    return _launch(xyc, m, n, tables, two_term_sum(tables))["loglik"]


def _launch(xyc, m, n, tables, two_term: bool) -> dict:
    """The kernel on CUDA tensors with ``tables`` (``kernel_tables``), at
    its two-term or 5-way gap sum (:func:`forward_loglik` picks it with
    :func:`two_term_sum`); one count per launch.  Returns ``loglik`` and
    ``switched`` (B,) int32: the first diagonal a read computed with the
    5-way sum after a failed check of the two-term sum, or -1."""
    B, k_pad, W = xyc.shape
    if W not in VITERBI_BAND_WIDTHS or k_pad % 2:
        raise ValueError(
            "forward kernel serves W in %s and even k_pad, got W=%d k_pad=%d"
            % (VITERBI_BAND_WIDTHS, W, k_pad)
        )
    out = {"loglik": xyc.new_empty(B, dtype=torch.float32),
           "switched": xyc.new_empty(B, dtype=torch.int32)}
    if B == 0:
        return out
    lib = kb.library("forward", _SIG)
    with torch.cuda.device(xyc.device):
        rc = lib.np_forward_launch(
            ctypes.c_void_p(tables.data_ptr()), kb.ptr(xyc), kb.ptr(m),
            kb.ptr(n), B, k_pad, W, int(two_term), kb.ptr(out["loglik"]),
            kb.ptr(out["switched"]), kb.stream_of(xyc),
        )
    kb.check(lib, rc, "forward")
    LAUNCHES.add()
    return out


def forward_loglik_plain(xyc, m, n, params: KernelParams) -> torch.Tensor:
    """The forward in plain PyTorch: vectorised over batch and band, one
    loop step per diagonal; the kernel's arithmetic in its order."""
    B, k_pad, W = xyc.shape
    dev = xyc.device
    f32 = torch.float32
    tab = kernel_tables(params).to(dev)
    tfT = tab[:25].reshape(5, 5).t().contiguous()  # [to, from]
    emf = tab[25:61]
    egf = tab[61:91]
    kend = m.to(torch.int64) + n.to(torch.int64)
    base = torch.arange(W, device=dev) + 1
    lookup = _forward_lookups(xyc.to(torch.int32) & 0xFF, emf, egf, base)
    prev = torch.zeros((B, NUM_STATES, W), dtype=f32, device=dev)
    prev[:, :, 0] = 1.0 / NUM_STATES  # diagonal 0
    prevprev = torch.zeros((B, NUM_STATES, W), dtype=f32, device=dev)
    rs = torch.ones(B, dtype=f32, device=dev)
    ones = torch.ones(B, dtype=f32, device=dev)
    pad = torch.zeros((B, NUM_STATES, 1), dtype=f32, device=dev)
    ls = torch.zeros(B, dtype=f32, device=dev)
    acc = torch.zeros(B, dtype=f32, device=dev)
    tiny = torch.tensor(1e-37, dtype=f32, device=dev)
    for k in range(1, k_pad + 1):
        rescale = k % 2 == 0
        E, idx = lookup(k)
        src = torch.cat([
            prevprev[:, None], prev[:, None].expand(B, 4, NUM_STATES, W)
        ], dim=1)
        T = _seq_sum(tfT[None, :, :, None] * src)
        Ts = _shift_at(T, idx, pad)
        r = rs if not rescale else ones
        Ts = torch.cat([(Ts[:, 0] * r[:, None])[:, None], Ts[:, 1:]], dim=1)
        new = E * Ts
        if rescale:
            scale = new.amax(dim=(1, 2))
            safe = torch.where(scale > 0, scale, ones)
            inv = 1.0 / safe
            new = new * inv[:, None, None]
            ls = ls + torch.log(safe)
            rs = inv
        fin = new[:, 0, 0]
        for s in range(1, NUM_STATES):
            fin = fin + new[:, s, 0]
        acc = torch.where(kend == k,
                          acc + (torch.log(torch.maximum(fin, tiny)) + ls), acc)
        prevprev, prev = prev, new
    return acc
