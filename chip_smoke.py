#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), the torch
   version, and builds the three kernels from ``nanopore_tpu_torch/csrc``
   with nvcc (one process per source, in parallel).
2. Makes a seeded workload: a 1 Mb random reference and 512 reads of
   5 kb (5 % deletions, 10 % substitutions, both strands, origin and
   strand in each read name).
3. Takes one realign batch of the mapping main path (the engine's own
   seeding, chaining and guide cigars; the preferred batch size, W = 64)
   and holds every kernel against its plain PyTorch version on the card:
   pack byte-identical; realign loglik within 1e-5 and score within 1e-4
   relative, cigars identical on at least 99 % of reads (a differing read
   must still agree in loglik and score: an MEA tie); walker ops
   identical.  Times each kernel with CUDA events beside its bound and
   the plain version's time.
4. Maps the reads end to end with ``run_mapper("LastParams", ...)``
   twice (the second run is the warm one), with every launch counter
   set to 0 just before the warm run and read just after; each must be
   > 0, and >= 99 % of the reads' primary records must land at their
   origin.
5. Prints one ``{"kernels": [...]}`` line and, last,
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero; it also exits
non-zero, printing no result, without a CUDA device or without the
``nanopore_tpu_torch`` package beside it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
REF_LEN = 1_000_000
N_READS = 512
READ_LEN = 5000
W = 64
# H100 SXM data-sheet peaks (dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations per band cell per diagonal of the decode-mode realign
# (csrc/realign.cu): forward 45 transition + 6 emission + 5 rescale
# (amortised), backward 6 destination + 45 transition + 5 rescale + 12
# posterior + 11 MEA
REALIGN_OPS_PER_CELL = 56 + 79


def fail(msg: str) -> None:
    raise SystemExit("chip_smoke: FAILED: " + msg)


def write_workload(workdir: str):
    """1 Mb reference and 512 noisy 5 kb reads (names r<i>_<start>_<strand>)."""
    from nanopore_tpu_torch.io.encoding import decode, revcomp_codes

    rng = np.random.default_rng(SEED)
    ref = rng.integers(0, 4, REF_LEN).astype(np.int8)
    fa = os.path.join(workdir, "ref.fa")
    seq = decode(ref)
    with open(fa, "w") as fh:
        fh.write(">chr1\n")
        for i in range(0, len(seq), 80):
            fh.write(seq[i:i + 80] + "\n")
    fq = os.path.join(workdir, "reads.fq")
    with open(fq, "w") as fh:
        for r in range(N_READS):
            start = int(rng.integers(0, REF_LEN - READ_LEN))
            x = ref[start:start + READ_LEN]
            y = x[rng.random(READ_LEN) > 0.05]
            sub = rng.random(len(y)) < 0.10
            y = np.where(sub, rng.integers(0, 4, len(y)), y).astype(np.int8)
            strand = int(rng.integers(0, 2))
            if strand:
                y = revcomp_codes(y)
            s = decode(y)
            fh.write("@r%d_%d_%d\n%s\n+\n%s\n" % (r, start, strand, s,
                                                    "I" * len(s)))
    return fa, fq


def cuda_ms(fn, reps: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed(fn):
    """(result, ms) of one call, timed with CUDA events."""
    box = []
    ms = cuda_ms(lambda: box.append(fn()), 1)
    return box[0], ms


def launches_per_call(counter, fn) -> int:
    """Kernel launches one wrapper call makes (a batch's worth)."""
    before = counter.count
    fn()
    return counter.count - before


def main_path_batch(engine, fq: str, batch_size: int):
    """One realign batch as the engine forms it: primary candidates of
    the first reads, seeded and chained by the engine itself."""
    from nanopore_tpu_torch.io.seqio import fastq_read_raw

    cands = []
    for header, seq, _ in fastq_read_raw(fq):
        cands.extend(
            c for c in engine._candidates_for_read(header.split()[0], seq)
            if c.primary
        )
        if len(cands) >= batch_size:
            break
    return engine.candidate_pairs(cands[:batch_size])


def kernel_phase(engine, fq: str, dev) -> dict:
    import torch

    from nanopore_tpu_torch.ops import pack, realign, traceback
    from nanopore_tpu_torch.ops.dispatch import (
        _pairs_k_max,
        preferred_realign_batch_size,
    )
    from nanopore_tpu_torch.ops.pack import (
        pack_stream_pairs,
        pack_xyc,
        pack_xyc_plain,
    )
    from nanopore_tpu_torch.ops.realign import (
        realign_decode,
        realign_decode_plain,
    )
    from nanopore_tpu_torch.ops.traceback import (
        mea_walk,
        mea_walk_plain,
        rle_ops_batch,
    )

    B = preferred_realign_batch_size(None, dev)
    pairs = main_path_batch(engine, fq, B)
    if len(pairs) != B:
        fail("only %d candidates for a batch of %d" % (len(pairs), B))
    prep = pack_stream_pairs(pairs, W, _pairs_k_max(pairs, None))
    k_pad = prep["k_pad"]
    print("main-path batch: B=%d K=%d k_pad=%d W=%d" % (B, prep["K"], k_pad, W))
    if k_pad < 2048:
        fail("k_pad %d below 2048" % k_pad)

    def put(a):
        return torch.from_numpy(a).to(dev)

    m, n = put(prep["m"]), put(prep["n"])
    stream, initx = put(prep["stream"]), put(prep["initx"])
    need_diags = int((prep["m"].astype(np.int64) + prep["n"] + 1).sum())
    params = engine.params
    cfg = engine.config
    res = {}

    # ---- K1 pack ----
    xyc = pack_xyc(stream, initx, m, n)
    t0 = time.perf_counter()
    xyc_p, plain_ms = timed(lambda: pack_xyc_plain(stream, initx, m, n))
    if not torch.equal(xyc, xyc_p):
        fail("pack kernel differs from its plain version")
    pack_err = float((xyc.int() - xyc_p.int()).abs().max())
    ms = cuda_ms(lambda: pack_xyc(stream, initx, m, n), 20)
    nbytes = B * k_pad + B * W + 8 * B + B * k_pad * W
    res["pack"] = dict(
        per_batch=launches_per_call(
            pack.LAUNCHES, lambda: pack_xyc(stream, initx, m, n)),
        ms=ms, plain_ms=plain_ms, max_abs_err=pack_err,
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
    )
    del xyc_p
    print("K1 pack: byte-identical; %.4f ms (plain %.1f ms, %.1f s wall)"
          % (ms, plain_ms, time.perf_counter() - t0))

    # ---- K2 realign ----
    t0 = time.perf_counter()
    out_k = realign_decode(xyc, m, n, params, cfg.gap_gamma, cfg.match_gamma)
    out_p, plain_ms = timed(lambda: realign_decode_plain(
        xyc, m, n, params, cfg.gap_gamma, cfg.match_gamma))
    for key in ("loglik", "score"):
        if not bool(torch.isfinite(out_k[key]).all()):
            fail("non-finite realign %s" % key)
    ll_rel = float(((out_k["loglik"] - out_p["loglik"]).abs()
                    / out_p["loglik"].abs()).max())
    sc_rel = float(((out_k["score"] - out_p["score"]).abs()
                    / out_p["score"].abs().clamp_min(1e-30)).max())
    err = float(torch.maximum(
        (out_k["loglik"] - out_p["loglik"]).abs().max(),
        (out_k["score"] - out_p["score"]).abs().max()))
    dirs_rows = int((out_k["dirs"] != out_p["dirs"]).flatten(1).any(1).sum())
    ops_k = mea_walk(out_k["dirs"], xyc, m, n)
    cig_k = rle_ops_batch(ops_k.cpu().numpy())
    cig_p = rle_ops_batch(mea_walk(out_p["dirs"], xyc, m, n).cpu().numpy())
    cig_diff = sum(a != b for a, b in zip(cig_k, cig_p))
    print("K2 realign: loglik max rel %.3g, score max rel %.3g, reads with "
          "differing dirs %d, with differing cigars %d of %d (%.1f s wall)"
          % (ll_rel, sc_rel, dirs_rows, cig_diff, B,
             time.perf_counter() - t0))
    if ll_rel > 1e-5 or sc_rel > 1e-4:
        fail("realign kernel outside tolerance")
    if cig_diff > 0.01 * B:
        fail("%d reads' cigars differ (> 1%%)" % cig_diff)
    ms = cuda_ms(lambda: realign_decode(xyc, m, n, params, cfg.gap_gamma,
                                        cfg.match_gamma), 3)
    nbytes = B * k_pad * W + B * (k_pad + 1) * W + 8 * B + 8 * B
    nops = REALIGN_OPS_PER_CELL * W * need_diags
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = nops / F32_OPS_PER_S * 1e3
    res["realign"] = dict(
        per_batch=launches_per_call(realign.LAUNCHES, lambda: realign_decode(
            xyc, m, n, params, cfg.gap_gamma, cfg.match_gamma)),
        ms=ms, plain_ms=plain_ms, max_abs_err=err,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="operations" if ops_ms >= bytes_ms else "bytes",
    )
    del out_p
    print("K2 realign: %.3f ms per batch (plain %.1f ms)" % (ms, plain_ms))

    # ---- K3 walker ----
    dirs = out_k["dirs"]
    t0 = time.perf_counter()
    ops_p, plain_ms = timed(lambda: mea_walk_plain(dirs, xyc, m, n))
    if not torch.equal(ops_k, ops_p):
        fail("walker kernel differs from its plain version")
    walk_err = float((ops_k.int() - ops_p.int()).abs().max())
    ms = cuda_ms(lambda: mea_walk(dirs, xyc, m, n), 10)
    nbytes = need_diags + B * k_pad + B * (k_pad + 1) + 8 * B
    res["traceback"] = dict(
        per_batch=launches_per_call(
            traceback.LAUNCHES, lambda: mea_walk(dirs, xyc, m, n)),
        ms=ms, plain_ms=plain_ms, max_abs_err=walk_err,
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
    )
    print("K3 walker: ops identical; %.3f ms (plain %.1f ms, %.1f s wall)"
          % (ms, plain_ms, time.perf_counter() - t0))
    for name, r in res.items():
        print("%s: %.4f ms per batch, %d launch(es) per batch, bound %.4f ms "
              "(%s), plain %.1f ms, library_ms null (no single PyTorch call)"
              % (name, r["ms"], r["per_batch"], r["bound_ms"], r["bound_by"],
                 r["plain_ms"]))
    return res


def origin_share(sam_path: str) -> float:
    """Share of reads whose primary record is on their strand within
    100 bp of their origin."""
    from nanopore_tpu_torch.io.sam import SamReader

    hits = 0
    for rec in SamReader(sam_path):
        if rec.flag & 0x904:
            continue
        _, start, strand = rec.qname[1:].split("_")
        if bool(rec.flag & 0x10) == bool(int(strand)) and abs(
            rec.pos - int(start)
        ) <= 100:
            hits += 1
    return hits / N_READS


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "nanopore_tpu_torch", "csrc")):
        print("chip_smoke: nanopore_tpu_torch is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from nanopore_tpu_torch.kernels import build
    from nanopore_tpu_torch.mapping.engine import MappingEngine
    from nanopore_tpu_torch.mapping.presets import MAPPER_REGISTRY
    from nanopore_tpu_torch.mapping.runner import run_mapper
    from nanopore_tpu_torch.io.seqio import read_fasta_dict
    from nanopore_tpu_torch.ops import pack, realign, traceback
    from nanopore_tpu_torch.runtime import native_index

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    print("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                     torch.cuda.get_device_name(0)))
    print("build: %.1f s" % build.build())
    # seeding and chaining run only in the native library: build it here
    # so a failure stops the run before any timing
    print("native seedchain: %s" % native_index.get_lib()._name)

    dev = torch.device("cuda", 0)
    workdir = os.path.join(build.BUILD_DIR, "smoke")
    os.makedirs(workdir, exist_ok=True)
    fa, fq = write_workload(workdir)

    spec = MAPPER_REGISTRY["LastParams"]
    engine = MappingEngine(read_fasta_dict(fa), spec.config, device=dev)
    res = kernel_phase(engine, fq, dev)

    # ---- end to end: cold run, then the warm run that counts ----
    sam = os.path.join(workdir, "out.sam")
    run_mapper(spec, fq, "reads", fa, sam, device=dev)
    counters = (pack.LAUNCHES, realign.LAUNCHES, traceback.LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    warm = run_mapper(spec, fq, "reads", fa, sam, device=dev)
    wall = time.perf_counter() - t0
    launches = {c.name: c.count for c in counters}
    peak = torch.cuda.max_memory_allocated(dev)
    share = origin_share(sam)
    print("end to end: %d reads in %.3f s warm = %.1f reads/s; peak device "
          "memory %.3f GB; primaries at origin %.4f; launches %s"
          % (N_READS, wall, N_READS / wall, peak / 1e9, share, launches))
    print("stage_stats " + json.dumps(warm.stage_stats.snapshot()))
    if min(launches.values()) <= 0:
        fail("a kernel of the main path was not launched: %s" % launches)
    if share < 0.99:
        fail("only %.4f of primaries at their origin" % share)

    meta = {
        "pack": ("csrc/pack.cu", "nanopore_tpu/ops/pack_pallas.py:61"),
        "realign": ("csrc/realign.cu",
                    "nanopore_tpu/ops/pairhmm_pallas_realign.py:69"),
        "traceback": ("csrc/traceback.cu",
                      "nanopore_tpu/ops/traceback_pallas.py:44"),
    }
    kernels = []
    for name, (src, replaces) in meta.items():
        r = res[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "nanopore_tpu_torch/" + src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
