"""The Viterbi and forward-only path at band widths 65 to 128 in the
port's W = 128 layout, on the CPU, against the JAX package's XLA-scan
route at the same width.

A band of live width 64 < w <= 128 lies in the first w lanes of W = 128
lanes (``ops.pack.padded_width``), its dead lanes all sentinel, on
either device; on the card the Viterbi kernel (both planes), its walker
and the forward-only kernel serve it in their W = 128 instantiations,
whose plain versions these tests run.  tests/test_torch_wide.py holds
the MEA path at these widths.  At w = 96 (dead lanes 96..127) and
w = 128 (none), on tests/test_torch_widths.py's reads:

* the byte-plane Viterbi (the default model): score within 1e-5
  relative of ``viterbi_decode_batch`` (the loglik bar: another order of
  log-table rounding), fstate identical, and the walker's cigars
  (``rle_ops_batch(viterbi_walk(...))``) equal to ``viterbi_traceback``'s
  for every read;
* the full plane under tests/test_torch_viterbi_full.py's model (i) (the
  default with t[1 -> 2] = 0.05): that file's bar, on its reads and
  these: the plain recursion on the scan's own log tables gives the
  scan's scores bit for bit, its fstates and its backpointers on every
  lattice cell; on the port's tables the score within 1e-5 relative,
  fstate, plane on every lattice cell and cigars identical (the table
  entries that XLA's ``log`` rounds another way are counted);
* the forward-only loglik within 1e-5 relative of the JAX package's
  ``forward_loglik`` (its own bar), under both gap sums' models;
* the padded layout: the Viterbi's score, fstate and both planes' live
  lanes, the walkers' ops and end cells and the forward loglik, bit for
  bit what the plain versions give on the unpadded band of width w;
* ``MappingEngine(band_width=96, decode="viterbi")``: records equal to
  the JAX engine's at the same width;
* on random codes at w = 96 no Viterbi walk leaves the live band, on
  either plane.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanopore_tpu.mapping.engine import MappingEngine as JaxEngine
from nanopore_tpu.mapping.presets import MAPPER_REGISTRY as JAX_PRESETS
from nanopore_tpu.io.seqio import read_fasta_dict as jax_read_fasta_dict
from nanopore_tpu.ops.pairhmm import forward_loglik as jax_forward_loglik
from nanopore_tpu.ops.pairhmm import prepare_banded_batch
from nanopore_tpu.ops.viterbi import viterbi_decode_batch, viterbi_traceback
from nanopore_tpu_torch.io.sam import CIG
from nanopore_tpu_torch.io.seqio import read_fasta_dict
from nanopore_tpu_torch.mapping.engine import MappingEngine
from nanopore_tpu_torch.mapping.presets import MAPPER_REGISTRY
from nanopore_tpu_torch.ops import viterbi as V
from nanopore_tpu_torch.ops.forward import forward_loglik, two_term_sum
from nanopore_tpu_torch.ops.pack import padded_width
from nanopore_tpu_torch.ops.pairhmm import kernel_tables
from nanopore_tpu_torch.ops.traceback import rle_ops_batch, viterbi_walk
from test_torch_chain_realign import sam_records, write_small_inputs
from test_torch_viterbi import lattice_cells
from test_torch_viterbi_full import both_params, full_pairs
from test_torch_widths import (
    _jparams,
    _lanes_walked,
    _packed,
    _params,
    width_pairs,
)

WIDE = (96, 128)  # dead lanes 96..127; none


@pytest.fixture(scope="module")
def pairs():
    return width_pairs()


def _case(pairs, w):
    """The padded port batch at live width w, the unpadded one, and the
    JAX package's banded batch over the same diagonals."""
    pad = _packed(pairs, w, padded_width(w))
    return {"pad": pad, "bare": _packed(pairs, w),
            "jax": prepare_banded_batch(pairs, band_width=w,
                                        k_max=pad[0]["k_pad"])}


@pytest.fixture(scope="module")
def layouts(pairs):
    return {w: _case(pairs, w) for w in WIDE}


def _xla_cigars(pairs, batch, fstates, bps):
    offsets = np.asarray(batch.offsets)
    return [viterbi_traceback(np.asarray(bps)[b], offsets[b], len(y), len(x),
                              int(np.asarray(fstates)[b]))
            for b, (x, y, _) in enumerate(pairs)]


def _cigars(out, xyc, m, n):
    ops, end = viterbi_walk(out["bp"], xyc, m, n, out["fstate"])
    assert not end.any()  # every walk reaches the origin
    return rle_ops_batch(ops.numpy())


# ---- the byte plane and the forward-only loglik -------------------------- #

def viterbi_matches_jax(pairs, layouts, w):
    """Score <= 1e-5 relative, fstate and cigars identical (the byte
    plane in w's padded layout)."""
    batch = layouts[w]["jax"]
    scores, fstates, bps = viterbi_decode_batch(batch, _jparams())
    prep, xyc, m, n = layouts[w]["pad"]
    assert xyc.shape[2] == padded_width(w)
    got = V.viterbi_forward(xyc, m, n, _params())
    assert got["bp"].dtype == torch.int8
    np.testing.assert_allclose(got["score"].numpy(), np.asarray(scores),
                               rtol=1e-5)
    np.testing.assert_array_equal(got["fstate"].numpy(), np.asarray(fstates))
    assert _cigars(got, xyc, m, n) == _xla_cigars(pairs, batch, fstates, bps)


@pytest.mark.parametrize("w", WIDE)
def test_viterbi_matches_viterbi_decode_batch(pairs, layouts, w):
    """Score <= 1e-5 relative, fstate and cigars identical."""
    viterbi_matches_jax(pairs, layouts, w)


def forward_matches_jax(layouts, w):
    """Loglik <= 1e-5 relative of ``forward_loglik`` in w's padded
    layout, under both gap sums' models."""
    for name in (None, "i"):
        if name is None:
            jp, pp = _jparams(), _params()
        else:
            jp, pp = both_params(name)
        assert two_term_sum(kernel_tables(pp)) == (name is None)
        want = np.asarray(jax_forward_loglik(layouts[w]["jax"], jp))
        _, xyc, m, n = layouts[w]["pad"]
        got = forward_loglik(xyc, m, n, pp).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("w", WIDE)
def test_forward_loglik_matches_jax(pairs, layouts, w):
    """Loglik <= 1e-5 relative of ``forward_loglik``, under the default
    model (the kernel's two-term gap sum) and model (i) (its 5-way
    sum)."""
    forward_matches_jax(layouts, w)


# ---- the full plane (a model outside the canonical structure) ------------ #

def _scan_tables(pp):
    """The XLA scan's log tables in the port's layout (as
    tests/test_torch_viterbi_full.py takes them)."""
    tab = kernel_tables(pp).numpy()
    return torch.from_numpy(np.array(jnp.log(jnp.maximum(tab, 1e-37))))


def _plane_diff(pairs, offsets, bps, bp, w):
    """Lattice cells x state where the port's full plane ``bp`` holds
    another predecessor than the scan's ``bps``."""
    bp = bp.numpy()
    differ = 0
    for b, (x, y, _) in enumerate(pairs):
        ks, ws = np.array(lattice_cells(offsets[b], len(y), len(x), w)).T
        for s in range(5):
            differ += int((((bp[b, ks, ws] >> (3 * s)) & 7)
                           != bps[b, ks - 1, s, ws]).sum())
    return differ


@pytest.fixture(scope="module")
def full_cases():
    jp, pp = both_params("i")
    pairs = full_pairs() + width_pairs()[:2]
    return pairs, jp, pp, {w: _case(pairs, w) for w in WIDE}


def full_plane_matches_jax(full_cases, w):
    """tests/test_torch_viterbi_full.py's bar at w (in its padded
    layout)."""
    pairs, jp, pp, cases = full_cases
    batch = cases[w]["jax"]
    scores, fstates, bps = (np.asarray(a) for a in
                            viterbi_decode_batch(batch, jp))
    offsets = np.asarray(batch.offsets)
    _, xyc, m, n = cases[w]["pad"]
    assert not V.viterbi_structure_ok(pp)
    own = V.plain_forward(xyc, m, n, _scan_tables(pp), full=True)
    np.testing.assert_array_equal(own["score"].numpy().view(np.int32),
                                  scores.view(np.int32))
    np.testing.assert_array_equal(own["fstate"].numpy(), fstates)
    assert _plane_diff(pairs, offsets, bps, own["bp"], w) == 0
    got = V.viterbi_forward(xyc, m, n, pp)
    assert got["bp"].dtype == torch.int16
    ft = V.viterbi_full_tables(pp).numpy()
    st = _scan_tables(pp).numpy()
    used = np.r_[0:25, [25 + x * 6 + y for x in range(5) for y in range(5)],
                 [61 + s * 6 + c for s in range(1, 5) for c in range(5)]]
    print("w=%d: %d of %d log table entries differ from the scan's by "
          "rounding" % (w, int((ft[used] != st[used]).sum()), len(used)))
    np.testing.assert_allclose(got["score"].numpy(), scores, rtol=1e-5)
    np.testing.assert_array_equal(got["fstate"].numpy(), fstates)
    assert _plane_diff(pairs, offsets, bps, got["bp"], w) == 0
    assert _cigars(got, xyc, m, n) == _xla_cigars(pairs, batch, fstates, bps)


@pytest.mark.parametrize("w", WIDE)
def test_full_plane_matches_the_xla_scan(full_cases, w):
    """tests/test_torch_viterbi_full.py's bar at w: on the scan's own
    tables the scan's scores bit for bit, its fstates and backpointers;
    on the port's tables score 1e-5 relative, fstate, the plane on every
    lattice cell and the cigars identical."""
    full_plane_matches_jax(full_cases, w)


# ---- the padded layout --------------------------------------------------- #

def _path_outputs(batch, pp):
    """The Viterbi (its plane by the model's structure), the walker on
    its plane and the forward loglik of one packed batch."""
    _, xyc, m, n = batch
    vit = V.viterbi_forward(xyc, m, n, pp)
    ops, end = viterbi_walk(vit["bp"], xyc, m, n, vit["fstate"])
    return dict(vit, ops=ops, end=end, loglik=forward_loglik(xyc, m, n, pp))


def padded_gives_unpadded(full_cases, w):
    """Both planes in w's padded layout against the unpadded band."""
    pairs, _, pp_full, cases = full_cases
    for pp, dtype in ((_params(), torch.int8), (pp_full, torch.int16)):
        got = _path_outputs(cases[w]["pad"], pp)
        want = _path_outputs(cases[w]["bare"], pp)
        assert got["bp"].dtype == dtype
        assert got["bp"].shape[2] == padded_width(w)
        assert torch.equal(got["bp"][:, :, :w], want["bp"])
        for key in ("score", "fstate", "ops", "end", "loglik"):
            assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("w", WIDE)
def test_padded_layout_gives_the_unpadded_bits(full_cases, w):
    """Both planes: the live lanes of the plane and every other output
    bit for bit the unpadded band's (a dead lane's backpointer may be
    set: lane w reads lane w - 1 through a delete's shift; its value
    clamps to NEG and no walk visits it)."""
    padded_gives_unpadded(full_cases, w)


# ---- end to end ---------------------------------------------------------- #

def engine_matches_jax(tmp_path, w):
    """``MappingEngine(band_width=w, decode="viterbi")`` on the CPU
    against the JAX engine at w: every record equal."""
    fa, fq = write_small_inputs(tmp_path, 5, n_reads=4)
    jax_sam, port_sam = str(tmp_path / "jax.sam"), str(tmp_path / "port.sam")
    JaxEngine(jax_read_fasta_dict(fa), dataclasses.replace(
        JAX_PRESETS["Viterbi"].config, band_width=w)).map_fastq(
            fq, jax_sam)
    cfg = dataclasses.replace(MAPPER_REGISTRY["Viterbi"].config,
                              band_width=w)
    assert cfg.decode == "viterbi"
    MappingEngine(read_fasta_dict(fa), cfg, device="cpu").map_fastq(
        fq, port_sam)
    got = sam_records(port_sam)
    assert len({r[0] for r in got}) == 4
    assert got == sam_records(jax_sam)


def test_viterbi_engine_matches_the_jax_engine_at_96(tmp_path):
    """``MappingEngine(band_width=96, decode="viterbi")`` on the CPU:
    every record equal to the JAX engine's at the same width (its XLA
    scan), field by field."""
    engine_matches_jax(tmp_path, 96)


def no_walk_leaves_the_live_band(w):
    """Unrelated random sequences under random guides at live width w
    (seeded by w): no Viterbi walk on either plane leaves lanes
    0..w-1 of its padded layout."""
    rng = np.random.default_rng(w)
    pairs = []
    lo, hi = w * 5 // 4, w * 23 // 10  # 120 to 220 at w = 96
    for _ in range(4):
        n, m = int(rng.integers(lo, hi)), int(rng.integers(lo, hi))
        d = int(rng.integers(0, min(n, m)))
        guide = [(CIG.M, d), (CIG.D, n - d), (CIG.I, m - d)]
        pairs.append((rng.integers(0, 5, n).astype(np.int8),
                      rng.integers(0, 5, m).astype(np.int8), guide))
    prep, xyc, m, n = _packed(pairs, w, padded_width(w))
    for pp in (_params(), both_params("i")[1]):
        cigars = _cigars(V.viterbi_forward(xyc, m, n, pp), xyc, m, n)
        for b, (x, y, _) in enumerate(pairs):
            lanes = _lanes_walked(cigars[b], prep["offsets"][b], len(y),
                                  len(x))
            assert lanes.min() >= 0 and lanes.max() < w


def test_no_viterbi_walk_leaves_the_live_band_on_random_codes():
    """Unrelated random sequences under random guides at w = 96: the
    paths press on the band's edges, and no walk on either plane leaves
    lanes 0..95 of its 128."""
    no_walk_leaves_the_live_band(96)
