"""From (ref, read, guide) pairs to decoded cigars, EM sums,
posteriors or log-likelihoods on one device.

Counterpart of ``nanopore_tpu/ops/dispatch.py`` for the MEA and Viterbi
decodes, the EM E-step, the posteriors and the forward-only
log-likelihood: ``prepared_from_pairs`` packs a batch on
the host, uploads the byte stream and runs the pack kernel;
``PreparedRealign.launch()`` enqueues the fused realign (with
``emit_gamma`` its decode + gamma mode) and ``decode()`` walks the
direction codes on the device, pulling only the (B, K1) op codes and the
logliks to the host; ``PreparedEm.run(params)`` launches the realign
kernel's EM mode on the resident codes with new model tables;
``PreparedPosteriors`` launches its gamma or exp mode, whose outputs
stay on the device for ``ops.posteriors``; ``PreparedViterbi.launch()``
enqueues the Viterbi kernel and ``decode()`` walks its backpointer plane
on the device, pulling only the op codes, end cells and scores (the
byte plane for a model in the canonical fiveState structure, the full
plane for any other; ``ops.viterbi``);
``PreparedForward.run()`` launches the forward-only kernel (the
counterpart of the JAX package's ``PallasForwardPlan``).

A band of live width w (``band_width``) is laid into the narrowest of
W = 32, 64, 128, 256, 384, 512, 768, 1024, 1536 and 2048 lanes that
holds it (``ops.pack.padded_width``; the CPU keeps a band wider than
2048 unpadded), its dead lanes all sentinel, on either device: so the
CPU runs exactly the layout the card runs.  On the card the MEA path's
kernels serve W = 32 to 2048 (above 1024 a read's band on a cluster of
two blocks) and the Viterbi path's W = 32 to 1024, so
``PreparedRealign``, ``PreparedEm`` and ``PreparedPosteriors`` take the
live widths 2 to 2048, ``PreparedViterbi`` and ``PreparedForward`` 2 to
1024 (``check_band_width``, ROADMAP C10, C11).  The
batch carries w (``LitePack.band_width``) to the realign kernel's
launches, and ``run()`` gives the gamma band and the flush sliced to
the w live lanes; the direction codes and the Viterbi plane keep W
lanes beside the codes, which the walkers read.

Tensors on the card go through the CUDA kernels, tensors on the CPU
through their plain PyTorch versions.  Every launch goes to the calling
thread's current stream, and results reach the host through a copy
that synchronises with it.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch

from nanopore_tpu_torch.device import resolve_device
from nanopore_tpu_torch.ops.pack import (
    MEA,
    VITERBI,
    check_band_width,
    pack_stream_pairs,
    pack_xyc,
    padded_width,
)
from nanopore_tpu_torch.ops.pairhmm import KernelParams
from nanopore_tpu_torch.ops.realign import (
    realign_decode,
    realign_em,
    realign_exp,
    realign_gamma,
)
from nanopore_tpu_torch.ops.forward import forward_loglik
from nanopore_tpu_torch.ops.traceback import (
    mea_walk,
    rle_ops_batch,
    viterbi_walk,
)
from nanopore_tpu_torch.ops.viterbi import viterbi_forward

logger = logging.getLogger(__name__)


@dataclass
class LitePack:
    """Host-side metadata of a packed batch (numpy arrays)."""

    offsets: np.ndarray  # (B, k_pad + 1) int32
    m: np.ndarray
    n: np.ndarray
    k_end: np.ndarray
    band_width: int  # the live width w; the codes' lanes are xyc.shape[2]


def _live_width(lite: LitePack | None, xyc) -> int:
    """The live band width of a packed batch (every lane without the
    metadata)."""
    return xyc.shape[2] if lite is None else lite.band_width


def _live_lanes(out: dict, wl: int) -> dict:
    """A run output with its gamma band and flush sliced (as views) to
    the ``wl`` live lanes."""
    for key in ("gamma", "flush"):
        if key in out:
            out[key] = out[key][..., :wl]
    return out


def _kend(lite: LitePack | None):
    """The host's m + n of a packed batch, for the realign kernel's
    launch plan (None without the metadata: the plan then reads m and n
    back from the device)."""
    return None if lite is None else lite.k_end


def _pairs_k_max(pairs, k_max, step: int = 2048) -> int:
    """Tighten k_max to the batch's real diagonal need, rounded to a
    coarse step so the count of distinct shapes stays bounded."""
    need = max(len(x) + len(y) for x, y, _ in pairs)
    tight = -(-need // step) * step
    return min(k_max, tight) if k_max else tight


class PreparedRealign:
    """A packed realign batch resident on its device (decode mode;
    ``emit_gamma`` adds the gamma_match band of the same launch)."""

    def __init__(self, lite: LitePack, params: KernelParams, xyc, m, n,
                 gap_gamma: float = 0.5, match_gamma: float = 0.0,
                 emit_gamma: bool = False):
        self.batch = lite
        self.params = params
        self.xyc = xyc
        self.m = m
        self.n = n
        self._gg = gap_gamma
        self._mg = match_gamma
        self._gamma = emit_gamma
        self._out = None

    @property
    def has_gamma(self) -> bool:
        """True when run() includes the gamma_match band."""
        return self._gamma

    def launch(self) -> "PreparedRealign":
        """Enqueue the realign kernel now (returns before it ends)."""
        if self._out is None:
            self._out = realign_decode(
                self.xyc, self.m, self.n, self.params, self._gg, self._mg,
                emit_gamma=self._gamma, kend=_kend(self.batch),
                band_width=_live_width(self.batch, self.xyc),
            )
        return self

    def run(self) -> dict:
        """loglik / score (B,) and dirs (B, k_pad + 1, W) on the device,
        and ``gamma`` (B, k_pad + 1, w) with ``emit_gamma`` (w the live
        width)."""
        self.launch()
        out, self._out = self._out, None
        return _live_lanes(out, _live_width(self.batch, self.xyc))

    def decode(self):
        """(logliks (B,) float64, cigars, run output)."""
        out = self.run()
        ops = mea_walk(out["dirs"], self.xyc, self.m, self.n)
        ops_h = ops.cpu().numpy()
        loglik = out["loglik"].cpu().numpy().astype(np.float64)
        return loglik, rle_ops_batch(ops_h), out


class PreparedEm:
    """An EM E-step batch resident on its device.

    The packed codes and lengths are uploaded once; ``run(params)``
    launches the realign kernel's EM mode on them with that iteration's
    model tables (91 floats by value), so nothing is packed or uploaded
    again between EM iterations.  The forward-state workspace lives only
    for the duration of a ``run``.
    """

    def __init__(self, lite: LitePack, xyc, m, n):
        self.batch = lite
        self.xyc = xyc
        self.m = m
        self.n = n

    def run(self, params: KernelParams) -> dict:
        """loglik (B,), trans (B, 5, 5), emis (B, 5, 16) on the device."""
        return realign_em(self.xyc, self.m, self.n, params,
                          kend=_kend(self.batch),
                          band_width=_live_width(self.batch, self.xyc))


class PreparedPosteriors:
    """Posterior outputs of a packed batch, resident on its device.

    ``emit_gamma`` (AlignmentUncertainty): run() returns loglik (B,) and
    the gamma_match band ``gamma`` (B, k_pad + 1, w) f32 (w the live
    width) for ``ops.posteriors.rescore_from_post``.  ``emit_exp`` (the
    SNP caller): loglik, the retire stream ``ret`` (B, k_pad + 1, 4) and
    the ``flush`` (B, 4, w) of the gammas above ``exp_threshold``, for
    ``ops.posteriors.expectations_from_post``.  One of the two, one
    launch of the realign kernel's gamma or exp mode.
    """

    def __init__(self, lite: LitePack, params: KernelParams, xyc, m, n,
                 emit_gamma: bool = True, emit_exp: bool = False,
                 exp_threshold: float = 1e-3):
        if emit_gamma == emit_exp:
            raise ValueError("PreparedPosteriors serves one of emit_gamma "
                             "and emit_exp")
        self.batch = lite
        self.params = params
        self.xyc = xyc
        self.m = m
        self.n = n
        self._gamma = emit_gamma
        self.exp_threshold = float(exp_threshold)
        self._out = None

    def launch(self) -> "PreparedPosteriors":
        """Enqueue the kernel now (returns before it ends)."""
        if self._out is None:
            if self._gamma:
                self._out = realign_gamma(
                    self.xyc, self.m, self.n, self.params,
                    kend=_kend(self.batch),
                    band_width=_live_width(self.batch, self.xyc))
            else:
                self._out = realign_exp(
                    self.xyc, self.m, self.n, self.params,
                    self.exp_threshold, kend=_kend(self.batch),
                    band_width=_live_width(self.batch, self.xyc))
        return self

    def run(self) -> dict:
        self.launch()
        out, self._out = self._out, None
        return _live_lanes(out, _live_width(self.batch, self.xyc))


class PreparedViterbi:
    """A max-product decode batch resident on its device (the mapping
    engine's ``decode="viterbi"`` extension), for a model of any
    transition structure: one in the canonical fiveState structure (gap
    states entered from match or themselves only) takes the byte plane,
    any other the full plane, on either device (``ops.viterbi``)."""

    def __init__(self, lite: LitePack, params: KernelParams, xyc, m, n):
        self.batch = lite
        self.params = params
        self.xyc = xyc
        self.m = m
        self.n = n
        self._out = None

    def launch(self) -> "PreparedViterbi":
        """Enqueue the Viterbi kernel now (returns before it ends)."""
        if self._out is None:
            self._out = viterbi_forward(self.xyc, self.m, self.n, self.params)
        return self

    def run(self) -> dict:
        """score (B,), fstate (B,) and bp (B, k_pad + 1, W) on the
        device (int8 byte plane or int16 full plane)."""
        self.launch()
        out, self._out = self._out, None
        return out

    def decode(self):
        """(scores (B,) float64, cigars): the backpointer plane is walked
        on the device.  A read whose walk does not reach the origin gets
        an empty cigar (its record is dropped) and a logged error."""
        out = self.run()
        ops, end = viterbi_walk(out["bp"], self.xyc, self.m, self.n,
                                out["fstate"])
        cigars = rle_ops_batch(ops.cpu().numpy())
        end = end.cpu().numpy()
        for b in np.nonzero(end.any(axis=1))[0]:
            logger.error(
                "viterbi traceback left the band for read %d (stopped at "
                "i=%d j=%d); emitting no alignment", b, end[b, 0], end[b, 1])
            cigars[b] = []
        return out["score"].cpu().numpy().astype(np.float64), cigars


class PreparedForward:
    """A forward-only batch resident on its device: ``run()`` returns
    the log-likelihoods (B,) f32 on the device (the counterpart of the
    JAX package's ``PallasForwardPlan``, without its uniform-band
    requirement)."""

    def __init__(self, lite: LitePack, params: KernelParams, xyc, m, n):
        self.batch = lite
        self.params = params
        self.xyc = xyc
        self.m = m
        self.n = n

    def run(self) -> torch.Tensor:
        return forward_loglik(self.xyc, self.m, self.n, self.params)


def prepared_from_pairs(
    cls_kwargs: dict,
    pairs,
    params: KernelParams,
    band_width: int = 64,
    k_max: int | None = None,
    prepared_cls=PreparedRealign,
    exact_k: bool = False,
):
    """Pack (ref, read, guide) pairs onto ``cls_kwargs['device']`` and
    wrap them as ``prepared_cls`` (``PreparedRealign``,
    ``PreparedPosteriors``, ``PreparedViterbi``, ``PreparedForward`` or
    ``PreparedEm``; ``params`` serve all but the last, which takes its
    model at every ``run``).  ``exact_k=True`` pins the diagonal count
    to ``k_max`` (k-bin bucketing) instead of tightening it.  The band of
    live width ``band_width`` is laid into ``padded_width(band_width)``
    lanes; the card refuses a width its kernels do not serve before any
    work (``check_band_width``, ROADMAP C10, C11: 2 to 2048 on the MEA
    path, for the realign classes, and 2 to 1024 on the Viterbi path, for
    ``PreparedViterbi`` and ``PreparedForward``)."""
    kwargs = dict(cls_kwargs)
    device = kwargs.pop("device", None)
    check_band_width(band_width, device,
                     VITERBI if issubclass(prepared_cls, (PreparedViterbi,
                                                          PreparedForward))
                     else MEA)
    device = resolve_device(device)
    if not exact_k:
        k_max = _pairs_k_max(pairs, k_max)
    prep = pack_stream_pairs(pairs, band_width, k_max,
                             lanes=padded_width(band_width))

    def put(a):
        return torch.from_numpy(a).to(device)

    m = put(prep["m"])
    n = put(prep["n"])
    xyc = pack_xyc(put(prep["stream"]), put(prep["initx"]), m, n,
                   band_width=band_width)
    lite = LitePack(
        offsets=prep["offsets"], m=prep["m"], n=prep["n"],
        k_end=prep["k_end"], band_width=band_width,
    )
    if prepared_cls is PreparedEm:
        return PreparedEm(lite, xyc, m, n, **kwargs)
    return prepared_cls(lite, params, xyc, m, n, **kwargs)


def local_dp_devices(device) -> list[torch.device]:
    """The devices a single process round-robins its batches over.

    Counterpart of the JAX package's ``local_dp_devices``: it replaces
    the reference's per-node process fan-out (batch-system maxThreads,
    reference Makefile:1-3).  A host with several cards places each
    prepared realign, EM or mapping batch on the next card, and its
    kernels run there while the other cards run theirs.  Every local card
    when ``device`` is a card and there are several, else ``[device]``.
    """
    device = resolve_device(device)
    if device.type == "cuda" and torch.cuda.device_count() > 1:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def preferred_realign_batch_size(requested: int | None = None,
                                 device=None) -> int:
    """Reads per realign or EM batch.

    The realign kernel runs one warp per read, a long serial chain of
    diagonals, so the card needs several warps per SM to hide latency:
    512 reads give ~4 warps on each of the H100's 132 SMs.  Each read's
    forward-state workspace is sized by its own diagonals (1,284 bytes a
    diagonal at W = 64, ~13 MB for a 5 kb read and its window), so 512
    such reads fit one launch under the 8 GiB cap
    (``ops.realign.workspace_plan``); a batch that needs more launches
    over runs of its reads.  On the CPU the plain version runs, and small
    batches bound its memory.  An explicit request wins.
    """
    if requested:
        return requested
    dev = torch.device("cuda" if device is None else device)
    return 512 if dev.type == "cuda" else 4
