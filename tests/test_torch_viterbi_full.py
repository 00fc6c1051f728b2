"""The port's full-plane Viterbi (a model of any transition structure)
against the JAX package's XLA scan.

A model outside the canonical fiveState structure (a gap state entered
from another gap state) takes the full plane: int16, ``p = sum_s b_s <<
3s``, each state's predecessor state, on log tables that keep every
structure zero at log(1e-37), as ``nanopore_tpu/ops/viterbi.py`` does.
The same seeded pairs (the mixed guides of ``test_torch_viterbi.py`` and
two reads of 250 and 300 bases), packed by each package, at W = 8, 32
and 64, on three models:

* (i) ``tests/test_viterbi.py``'s: the default with t[1 -> 2] = 0.05;
* (ii) a dense random one: every transition > 0, random emissions;
* (iii) one where a structure zero decides: no state enters an insert
  state (t[0 -> 2] = t[0 -> 4] = t[2 -> 2] = t[4 -> 4] = 0) and
  t[1 -> 3] = 0.05, so a read longer than its window pays log(1e-37) a
  base; with the structure zeros at ``NEG`` it would score ``NEG``.

Bars, the repo's own: score within 1e-5 relative (the loglik bar),
fstate identical, the plane equal to the scan's ``bps`` on every lattice
cell, cigars identical.  The scan takes its logs with XLA's ``log``,
which may round a table entry one ulp away from numpy's: the port's
recursion on the scan's own tables must give the scan's scores and
backpointers bit for bit, and on its own tables the same decode (the
number of table entries that differ is printed).

End to end: ``MappingEngine(model=<model (i)>, decode="viterbi")`` of
each package on the CPU (the JAX package takes its XLA route there):
records equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanopore_tpu.align.model import PairHmmModel as JaxModel
from nanopore_tpu.io.sam import CIG
from nanopore_tpu.io.sam import SamReader as JaxSamReader
from nanopore_tpu.mapping.engine import MapperConfig as JaxConfig
from nanopore_tpu.mapping.engine import MappingEngine as JaxEngine
from nanopore_tpu.ops.pairhmm import make_kernel_params as jax_params
from nanopore_tpu.ops.pairhmm import prepare_banded_batch
from nanopore_tpu.ops.viterbi import viterbi_decode_batch, viterbi_traceback
from nanopore_tpu_torch.align.model import PairHmmModel
from nanopore_tpu_torch.io.encoding import decode, revcomp_codes
from nanopore_tpu_torch.io.seqio import read_fasta_dict
from nanopore_tpu_torch.mapping.engine import MapperConfig, MappingEngine
from nanopore_tpu_torch.ops import dispatch
from nanopore_tpu_torch.ops import viterbi as V
from nanopore_tpu_torch.ops.pack import pack_stream_pairs, pack_xyc
from nanopore_tpu_torch.ops.pairhmm import kernel_tables, make_kernel_params
from nanopore_tpu_torch.ops.traceback import (
    OP_NONE,
    rle_ops_batch,
    viterbi_walk,
    viterbi_walk_plain,
)
from test_torch_viterbi import (
    _past_the_width_check,
    _PastTheWidthCheck,
    cigar_consumes,
    lattice_cells,
    mixed_pairs,
)

WIDTHS = (8, 32, 64)
MODELS = ("i", "ii", "iii")


def model_arrays(name):
    """(transitions (5, 5), emissions (5, 16)) float64 of model ``name``,
    rows renormalised."""
    base = PairHmmModel.default()
    t = np.array(base.transitions, np.float64)
    e = np.array(base.emissions, np.float64)
    if name == "i":
        t[1, 2] = 0.05
    elif name == "ii":
        rng = np.random.default_rng(7)
        t = rng.uniform(0.02, 1.0, (5, 5))
        e = rng.uniform(0.05, 1.0, (5, 16))
    elif name == "iii":
        t[0, 2] = t[0, 4] = t[2, 2] = t[4, 4] = 0.0
        t[1, 3] = 0.05
    t /= t.sum(axis=1, keepdims=True)
    e /= e.sum(axis=1, keepdims=True)
    return t, e


def both_params(name):
    """(JAX KernelParams, port KernelParams) of model ``name``, built
    afresh (the JAX package caches tables on the transition table's
    identity)."""
    t, e = model_arrays(name)
    return (jax_params(JaxModel(t.copy(), e.copy())),
            make_kernel_params(PairHmmModel(t.copy(), e.copy())))


def long_pairs(rng):
    """Two reads of 250 and 300 bases, 8 % substitutions, one with a
    deletion of 7 and one with an insertion of 5 (guided)."""
    x0 = rng.integers(0, 4, 257).astype(np.int8)
    y0 = np.concatenate([x0[:120], x0[127:]])
    x1 = rng.integers(0, 4, 295).astype(np.int8)
    y1 = np.concatenate([x1[:150], rng.integers(0, 4, 5).astype(np.int8),
                         x1[150:]])
    out = []
    for x, y, guide in ((x0, y0, [(CIG.M, 120), (CIG.D, 7), (CIG.M, 130)]),
                        (x1, y1, [(CIG.M, 150), (CIG.I, 5), (CIG.M, 145)])):
        sub = rng.random(len(y)) < 0.08
        y = np.where(sub, rng.integers(0, 4, len(y)), y).astype(np.int8)
        out.append((x, y, guide))
    return out


def full_pairs():
    return mixed_pairs(np.random.default_rng(41)) + long_pairs(
        np.random.default_rng(43))


def scan_tables(pp):
    """The XLA scan's log tables in the port's layout: ``jnp.log`` of the
    floored transitions and emissions, as ``_viterbi_scan_single`` takes
    them (the sentinel entries are unused: a sentinel code emits NEG)."""
    tab = kernel_tables(pp).numpy()
    return torch.from_numpy(np.array(jnp.log(jnp.maximum(tab, 1e-37))))


def full_bps_plane(bps, K1):
    """The scan's bps (K, 5, W) as a full plane (K1, W) int16: row k
    holds diagonal k, p = sum_s bps[k - 1, s] << 3s."""
    K, _, W = bps.shape
    plane = np.zeros((K1, W), np.int16)
    rows = min(K, K1 - 1)
    for s in range(5):
        plane[1:rows + 1] |= (bps[:rows, s].astype(np.int16) << (3 * s))
    return plane


@pytest.fixture(scope="module", params=[(mo, W) for mo in MODELS
                                        for W in WIDTHS],
                ids=["%s-W%d" % (mo, W) for mo in MODELS for W in WIDTHS])
def case(request):
    name, W = request.param
    jp, pp = both_params(name)
    pairs = full_pairs()
    batch = prepare_banded_batch(pairs, band_width=W)
    scores, fstates, bps = (np.asarray(a) for a in
                            viterbi_decode_batch(batch, jp))
    offsets = np.asarray(batch.offsets)
    xla = [viterbi_traceback(bps[b], offsets[b], len(y), len(x),
                             int(fstates[b]))
           for b, (x, y, _) in enumerate(pairs)]
    prep = pack_stream_pairs(pairs, W, batch.k_max)
    t = torch.from_numpy
    m, n = t(prep["m"]), t(prep["n"])
    xyc = pack_xyc(t(prep["stream"]), t(prep["initx"]), m, n)
    got = V.viterbi_forward(xyc, m, n, pp)
    return dict(name=name, W=W, pairs=pairs, pp=pp, offsets=offsets,
                prep=prep, scores=scores, fstates=fstates, bps=bps, xla=xla,
                xyc=xyc, m=m, n=n, got=got)


def plane_diff(case, bp):
    """Lattice cells (k, w) x state where ``bp`` (the port's full plane,
    (B, K1, W)) holds another predecessor than the scan's bps."""
    bp = bp.numpy()
    bps, W = case["bps"], case["W"]
    differ = 0
    for b, (x, y, _) in enumerate(case["pairs"]):
        ks, ws = np.array(lattice_cells(case["offsets"][b], len(y), len(x),
                                        W)).T
        for s in range(5):
            differ += int((((bp[b, ks, ws] >> (3 * s)) & 7)
                           != bps[b, ks - 1, s, ws]).sum())
    return differ


def test_model_takes_the_full_plane(case):
    """Every model of the three is outside the canonical structure, so
    the CPU route gives the int16 full plane (the plain version of the
    kernel's full step), its rows 0 and past each read's end 0."""
    pp, got = case["pp"], case["got"]
    assert not V.viterbi_structure_ok(pp)
    assert got["bp"].dtype == torch.int16
    want = V.viterbi_forward_full_plain(case["xyc"], case["m"], case["n"], pp)
    for key in ("score", "fstate", "bp"):
        assert torch.equal(got[key], want[key])
    kend = (case["m"] + case["n"]).long()
    rows = torch.arange(got["bp"].shape[1])[None, :]
    assert not got["bp"][(rows > kend[:, None]) | (rows == 0)].any()
    ltf = V.viterbi_full_tables(pp)[:25]
    # no transition at NEG: a structure zero is log(1e-37)
    assert bool((ltf >= float(np.log(np.float32(1e-37)))).all())


def test_recursion_on_the_scan_tables_is_the_scan_bit_for_bit(case):
    """The port's plain recursion on the scan's own log tables: the
    scan's scores bit for bit, its fstates, and its backpointers on every
    lattice cell."""
    out = V.plain_forward(case["xyc"], case["m"], case["n"],
                          scan_tables(case["pp"]), full=True)
    np.testing.assert_array_equal(out["score"].numpy().view(np.int32),
                                  case["scores"].view(np.int32))
    np.testing.assert_array_equal(out["fstate"].numpy(), case["fstates"])
    assert plane_diff(case, out["bp"]) == 0


def test_full_plane_matches_the_xla_scan(case):
    """The port's own tables: score 1e-5 relative, fstate identical, the
    plane equal to the scan's on every lattice cell."""
    got = case["got"]
    ft = V.viterbi_full_tables(case["pp"]).numpy()
    st = scan_tables(case["pp"]).numpy()
    used = np.r_[0:25, [25 + x * 6 + y for x in range(5) for y in range(5)],
                 [61 + s * 6 + c for s in range(1, 5) for c in range(5)]]
    print("model %s W=%d: %d of %d log table entries differ from the scan's "
          "by rounding" % (case["name"], case["W"],
                           int((ft[used] != st[used]).sum()), len(used)))
    np.testing.assert_allclose(got["score"].numpy(), case["scores"],
                               rtol=1e-5)
    np.testing.assert_array_equal(got["fstate"].numpy(), case["fstates"])
    differ = plane_diff(case, got["bp"])
    print("plane cells differing from the scan's on the lattice: %d" % differ)
    assert differ == 0


def test_walker_gives_the_xla_traceback_cigars(case):
    """The plain walker on the port's full plane: the cigars of
    ``viterbi_traceback`` on the scan's plane, each walk reaching the
    origin, one op per path diagonal."""
    got = case["got"]
    ops, end = viterbi_walk(got["bp"], case["xyc"], case["m"], case["n"],
                            got["fstate"])
    assert not end.any()
    cigars = rle_ops_batch(ops.numpy())
    for b, (x, y, _) in enumerate(case["pairs"]):
        assert cigars[b] == case["xla"][b]
        assert cigar_consumes(cigars[b], len(y), len(x))
        assert (ops[b] != OP_NONE).sum() == sum(ln for _, ln in cigars[b])


def test_walker_on_the_scan_plane(case):
    """The plain walker on the scan's own backpointers, laid out as the
    full plane: ``viterbi_traceback``'s cigars (the walker alone, apart
    from the forward)."""
    K1 = case["xyc"].shape[1] + 1
    plane = np.stack([full_bps_plane(case["bps"][b], K1)
                      for b in range(len(case["pairs"]))])
    ops, end = viterbi_walk_plain(
        torch.from_numpy(plane), case["xyc"], case["m"], case["n"],
        torch.from_numpy(case["fstates"].astype(np.int32)))
    assert not end.any()
    assert rle_ops_batch(ops.numpy()) == case["xla"]


def test_structure_zero_decides_model_iii():
    """Model (iii): the reads longer than their window score about
    log(1e-37) an inserted base under the full tables, and NEG under
    tables that put the structure zeros at NEG (the byte plane's):
    the two tables decode differently, and the scan takes the former."""
    jp, pp = both_params("iii")
    pairs = full_pairs()
    W = 32
    batch = prepare_banded_batch(pairs, band_width=W)
    scores = np.asarray(viterbi_decode_batch(batch, jp)[0])
    prep = pack_stream_pairs(pairs, W, batch.k_max)
    t = torch.from_numpy
    m, n = t(prep["m"]), t(prep["n"])
    xyc = pack_xyc(t(prep["stream"]), t(prep["initx"]), m, n)
    full = V.viterbi_forward_full_plain(xyc, m, n, pp)["score"].numpy()
    neg = V.plain_forward(xyc, m, n, V.viterbi_tables(pp),
                          full=True)["score"].numpy()
    longer = prep["m"] > prep["n"]
    assert longer.sum() >= 2
    assert (full[longer] > -1e4).all() and (neg[longer] < -1e29).all()
    floor = float(np.log(np.float32(1e-37)))
    assert (full[longer] < floor * (prep["m"] - prep["n"])[longer]).all()
    np.testing.assert_allclose(full, scores, rtol=1e-5)


def test_prepared_viterbi_serves_every_structure():
    """``prepared_from_pairs(..., PreparedViterbi)`` on the CPU: model
    (i) decodes on the full plane to the JAX package's XLA route (its
    ``prepared_from_pairs`` with the same model), the default model on
    the byte plane."""
    from nanopore_tpu.ops import dispatch as jax_dispatch

    pairs = full_pairs()
    for name, dtype in (("i", torch.int16), (None, torch.int8)):
        if name is None:
            jp = jax_params(JaxModel.default())
            pp = make_kernel_params(PairHmmModel.default())
        else:
            jp, pp = both_params(name)
        prep = dispatch.prepared_from_pairs(
            {"device": "cpu"}, pairs, pp, band_width=64,
            prepared_cls=dispatch.PreparedViterbi)
        assert prep.run()["bp"].dtype == dtype
        scores, cigars = prep.decode()
        want_scores, want = jax_dispatch.prepared_from_pairs(
            {}, pairs, jp, band_width=64,
            prepared_cls=jax_dispatch.PreparedViterbi).decode()
        np.testing.assert_allclose(scores, want_scores, rtol=1e-5)
        assert [list(c) for c in cigars] == [list(c) for c in want]


def test_walker_wrapper_takes_both_planes_and_checks_them(monkeypatch):
    """``viterbi_walk`` takes the int8 and the int16 plane; another
    dtype raises, and a non-CPU int16 plane of a width the kernel does
    not serve raises before any launch, while W = 32, 64 and 128 pass
    the check, to the kernel's build (the meta device stands in for the
    card)."""
    B, K, W = 3, 10, 8
    m = torch.full((B,), 4, dtype=torch.int32)
    xyc = torch.zeros((B, K, W), dtype=torch.int8)
    for dtype in (torch.int8, torch.int16):
        ops, end = viterbi_walk(torch.zeros((B, K + 1, W), dtype=dtype),
                                xyc, m, m, torch.zeros_like(m))
        assert ops.shape == (B, K + 1) and end.shape == (B, 2)
    with pytest.raises(ValueError, match="int16"):
        viterbi_walk(torch.zeros((B, K + 1, W), dtype=torch.int32), xyc, m,
                     m, torch.zeros_like(m))
    meta = dict(device="meta")

    def walk(W):
        viterbi_walk(torch.zeros((B, K + 1, W), dtype=torch.int16, **meta),
                     torch.zeros((B, K, W), dtype=torch.int8, **meta),
                     *(torch.zeros(B, dtype=torch.int32, **meta)
                       for _ in range(3)))

    with pytest.raises(ValueError, match="serve W"):
        walk(W)
    monkeypatch.setattr("nanopore_tpu_torch.kernels.build.library",
                        _past_the_width_check)
    for wide in (32, 64, 128):
        with pytest.raises(_PastTheWidthCheck):
            walk(wide)


def test_random_full_plane_walks_field_by_field():
    """The plain walker's full-plane rule on a random plane: each step
    takes field s of the cell's word, (p >> 3s) & 7, checked against a
    scalar walk of the same rule."""
    rng = np.random.default_rng(5)
    B, K, W = 4, 60, 8
    fields = rng.integers(0, 5, (B, K + 1, W, 5))
    plane = (fields << (3 * np.arange(5))).sum(axis=3).astype(np.int16)
    ms = np.array([20, 25, 18, 22], np.int32)
    ns = np.array([22, 20, 25, 21], np.int32)
    # a band that steps right every second diagonal (bit 6 of column 0)
    xyc = np.zeros((B, K, W), np.int8)
    xyc[:, 1::2, 0] = 1 << 6
    offs = np.concatenate([np.zeros((B, 1), np.int64),
                           np.cumsum((xyc[:, :, 0] >> 6) & 1, axis=1)], 1)
    fstate = rng.integers(0, 5, B).astype(np.int32)
    t = torch.from_numpy
    ops, end = viterbi_walk_plain(t(plane), t(xyc), t(ms), t(ns), t(fstate))
    for b in range(B):
        i, j, s = int(ms[b]), int(ns[b]), int(fstate[b])
        want = np.full(K + 1, OP_NONE, np.int8)
        while (i, j) != (0, 0) and i + j >= 0:
            k = i + j
            w = j - offs[b, k]
            p = int(plane[b, k, w]) if 0 <= w < W else 0
            want[k] = 0 if s == 0 else (1 if s in (1, 3) else 2)
            i -= s != 1 and s != 3
            j -= s in (0, 1, 3)
            s = (p >> (3 * s)) & 7
        np.testing.assert_array_equal(ops[b].numpy(), want)
        assert tuple(end[b].tolist()) == (i, j)


# ---- end to end: the mapping engine with model (i) ----


def _write_small_inputs(d):
    rng = np.random.default_rng(11)
    ref = rng.integers(0, 4, 6000).astype(np.int8)
    fa = d / "ref.fa"
    seq = decode(ref)
    fa.write_text(">chrS\n" + "\n".join(
        seq[i:i + 70] for i in range(0, len(seq), 70)) + "\n")
    lines = []
    for r in range(6):
        L = int(rng.integers(300, 500))
        start = int(rng.integers(0, len(ref) - L))
        x = ref[start:start + L]
        y = x[rng.random(L) > 0.05]
        sub = rng.random(len(y)) < 0.08
        y = np.where(sub, rng.integers(0, 4, len(y)), y).astype(np.int8)
        ins = rng.random(len(y)) < 0.03
        y = np.insert(y, np.nonzero(ins)[0],
                      rng.integers(0, 4, int(ins.sum())).astype(np.int8))
        if r % 2:
            y = revcomp_codes(y)
        lines.append("@read_%d_%d_%d\n%s\n+\n%s\n"
                     % (r, start, r % 2, decode(y), "I" * len(y)))
    fq = d / "reads.fq"
    fq.write_text("".join(lines))
    return str(fa), str(fq)


def test_engine_with_a_noncanonical_model_matches_jax(tmp_path):
    """``MappingEngine(model=<model (i)>, decode="viterbi")`` on the CPU
    in both packages: the same SAM records, field by field with the AS
    tag (the port through the full plane, the JAX package through its
    XLA scan)."""
    fa, fq = _write_small_inputs(tmp_path)
    ref = read_fasta_dict(fa)
    t, e = model_arrays("i")
    jax_engine = JaxEngine(ref, JaxConfig(decode="viterbi"),
                           model=JaxModel(t.copy(), e.copy()))
    jax_engine.map_fastq(fq, str(tmp_path / "jax.sam"))
    engine = MappingEngine(ref, MapperConfig(decode="viterbi"),
                           model=PairHmmModel(t.copy(), e.copy()),
                           device="cpu")
    assert not V.viterbi_structure_ok(engine.params)
    engine.map_fastq(fq, str(tmp_path / "port.sam"))
    fields = ("qname", "flag", "rname", "pos", "mapq", "cigar", "seq")

    def records(path):
        return [tuple(getattr(r, f) for f in fields)
                + (dict((tg[0], tg[2]) for tg in r.tags).get("AS"),)
                for r in JaxSamReader(path)]

    want = records(str(tmp_path / "jax.sam"))
    got = records(str(tmp_path / "port.sam"))
    assert len({r[0] for r in got}) == 6
    assert got == want
