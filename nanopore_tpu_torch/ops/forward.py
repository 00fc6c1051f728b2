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
  where the band is all zero), with ``ls += log(safe)``: a plain f32
  sum, no Kahan term (the JAX kernel's);
* ``loglik = log(max(fin, 1e-37)) + ls`` at band cell 0 of diagonal
  m + n, ``fin`` the sum of the 5 states there.
"""

from __future__ import annotations

import ctypes

import torch

from nanopore_tpu_torch.kernels import build as kb
from nanopore_tpu_torch.ops.pack import KERNEL_BAND_WIDTHS
from nanopore_tpu_torch.ops.pairhmm import KernelParams, kernel_tables
from nanopore_tpu_torch.ops.realign import (
    NUM_STATES,
    _check_inputs,
    _seq_sum,
    _shift,
)

LAUNCHES = kb.LaunchCounter("forward")
_SIG = {
    "np_forward_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
    + [ctypes.c_void_p] * 2,
}


def forward_loglik(xyc, m, n, params: KernelParams) -> torch.Tensor:
    """Forward log-likelihood (B,) f32 over packed band codes.

    xyc (B, k_pad, W) int8, m / n (B,) int32 read / window lengths.
    CUDA tensors launch the kernel, CPU tensors run the plain version.
    """
    _check_inputs(xyc, m, n)
    if xyc.device.type == "cpu":
        return forward_loglik_plain(xyc, m, n, params)
    B, k_pad, W = xyc.shape
    if W not in KERNEL_BAND_WIDTHS or k_pad % 2:
        raise ValueError(
            "forward kernel serves W in %s and even k_pad, got W=%d k_pad=%d"
            % (KERNEL_BAND_WIDTHS, W, k_pad)
        )
    loglik = xyc.new_empty(B, dtype=torch.float32)
    if B == 0:
        return loglik
    tables = kernel_tables(params)
    lib = kb.library("forward", _SIG)
    with torch.cuda.device(xyc.device):
        rc = lib.np_forward_launch(
            ctypes.c_void_p(tables.data_ptr()), kb.ptr(xyc), kb.ptr(m),
            kb.ptr(n), B, k_pad, W, kb.ptr(loglik), kb.stream_of(xyc),
        )
    kb.check(lib, rc, "forward")
    LAUNCHES.add()
    return loglik


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
    codes = xyc.to(torch.int32) & 0xFF
    prev = torch.zeros((B, NUM_STATES, W), dtype=f32, device=dev)
    prev[:, :, 0] = 1.0 / NUM_STATES  # diagonal 0
    prevprev = torch.zeros((B, NUM_STATES, W), dtype=f32, device=dev)
    rs = torch.ones(B, dtype=f32, device=dev)
    ls = torch.zeros(B, dtype=f32, device=dev)
    acc = torch.zeros(B, dtype=f32, device=dev)
    tiny = torch.tensor(1e-37, dtype=f32, device=dev)
    for k in range(1, k_pad + 1):
        rescale = k % 2 == 0
        c = codes[:, k - 1]
        x = (c >> 3) & 7
        y = c & 7
        E = torch.stack([
            emf[x * 6 + y], egf[6 + x], egf[12 + y], egf[18 + x],
            egf[24 + y],
        ], dim=1)
        top = c[:, 0]
        d1 = (top >> 6) & 1
        d1p = (top >> 7) & 1
        src = torch.cat([
            prevprev[:, None], prev[:, None].expand(B, 4, NUM_STATES, W)
        ], dim=1)
        T = _seq_sum(tfT[None, :, :, None] * src)
        S = torch.stack([d1 + d1p - 1, d1 - 1, d1, d1 - 1, d1], dim=1)
        Ts = _shift(T, S, 0.0, base)
        r = rs if not rescale else torch.ones_like(rs)
        Ts = torch.cat([(Ts[:, 0] * r[:, None])[:, None], Ts[:, 1:]], dim=1)
        new = E * Ts
        if rescale:
            scale = new.amax(dim=(1, 2))
            safe = torch.where(scale > 0, scale, torch.ones_like(scale))
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
