#!/usr/bin/env python3
"""Time the realign kernel's modes, the Viterbi kernel, the forward-only
kernel, the two walkers and the pack kernel of several checkouts of the
port, in turns, on the batches that ``chip_smoke.py`` drives.

    python3 realign_ab.py TREE [TREE ...] [--reps 3] [--repeat N] [--out FILE]

Each TREE is the root of a checkout that holds ``nanopore_tpu_torch/``
(``.`` for this one); list them in the order to run them, for example
``scratch_chip/parent . . scratch_chip/parent``.  The script first
builds, with this checkout's package and ``chip_smoke.py``'s helpers, the
pack inputs of the realign batches of chip_smoke's paths, all from
``SEED = 0``:

* ``decode_w64``: the mapping path's batch (B = 512, W = 64, decode);
* ``viterbi_w64``: the Viterbi kernel on ``decode_w64``'s codes under
  the default model (the digest covers ``score``, ``fstate`` and the
  whole backpointer plane);
* ``forward_w64``: the forward-only kernel on ``decode_w64``'s codes
  under the default model (the digest covers the loglik bits);
* ``em``: the EM path's batch (B = 512, W = 64, windows of pad 256,
  under chip_smoke's random model), and ``em_split_<s>``, the same batch
  in consecutive calls of s reads, the launches that a workspace of
  k_pad rows a read gives under the 8 GiB cap;
* ``forward_em``: the forward-only kernel on the EM batch's codes under
  its random model (the far-end windows of ROADMAP C6 among them);
* ``decode_w32``: the realign stage's fullest bucket (W = 32), and
  ``forward_w32`` and ``viterbi_w32``, the forward-only and the Viterbi
  kernel on its codes;
* ``gamma``: AlignmentUncertainty's fullest batch (W = 64, blasr_hmm_0);
* ``decode_gamma``: the rescore's fullest batch (W = 32);
* ``exp``: the SNP caller's main bucket and ``exp_far_<n>x<m>``, each of
  its other buckets (W = 64, threshold 1e-3, default model);
* ``walk_mea_w64`` and ``walk_mea_w32``: the MEA walker on the direction
  codes of ``decode_w64`` and ``decode_w32`` (each tree's realign kernel
  makes them, untimed), and ``walk_viterbi_w64``: the Viterbi walker on
  the Viterbi kernel's plane of the ``decode_w64`` batch;
* ``pack_w64`` and ``pack_w32``: the pack kernel on the streams of
  ``decode_w64`` and ``decode_w32``.

Then, for each TREE in turn, a child process with that TREE first on
``sys.path`` builds its kernels, packs each batch with its own pack
kernel and times each call with CUDA events (one warm-up call, then
``--reps`` calls), also counting launches per call and taking a digest
of every output.  Prints one line per tree and batch and, last, a JSON
object with every time (also written to ``--out``); it fails if two
trees' outputs differ on any batch.  Needs one CUDA card.

``--repeat N`` tiles every batch's reads N times (N reads a warp
scheduler where the batch held one: an occupancy probe) and raises the
realign workspace cap N-fold so that each batch keeps its launches.

``--only PREFIX[,PREFIX...]`` exists for ablation runs, where the trees
differ in one kernel (``--only walk_`` for the walkers, ``--only
forward_`` for the forward-only kernel): it times only the batches
whose names start with one of the prefixes, builds only the kernels
they launch, and the JSON lists the others under ``left_out``.  A
comparison of two commits times every batch.

``--summary FILE`` times nothing: it reads a JSON this script wrote and
prints, per batch, each tree's median time, its change against the
first tree's and its spread (the interquartile range); for two trees
run in pairs (A B, then B A, ...) also the pairs the second tree won
(faster) and lost: the figures a claim of no change or of a gain rests
on.

``--sass`` times nothing: it compiles every ``csrc/*.cu`` of each TREE
with that tree's nvcc flags into a cubin, disassembles it
(``cuobjdump -sass``), and reports, for each kernel of the first TREE,
whether a kernel of each other TREE has the same machine code (the
instructions, without names or encodings), so that an edit that must
leave a build unchanged can be shown to.  Needs the CUDA toolkit, not a
card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def _model(name: str):
    from nanopore_tpu_torch.align.model import PairHmmModel
    from nanopore_tpu_torch.analyses.alignment_uncertainty import (
        trained_hmm_path,
    )

    if name == "default":
        return PairHmmModel.default()
    if name == "random":
        return PairHmmModel.random(np.random.default_rng(0))
    return PairHmmModel.load(trained_hmm_path(name))


def build_batches(workdir: str) -> list[dict]:
    """The pack inputs of chip_smoke's realign batches, saved as .npz
    under ``workdir``; returns their descriptions."""
    import torch

    import chip_smoke as cs
    from nanopore_tpu_torch.align.chain_sam import chain_sam_file
    from nanopore_tpu_torch.analyses.common import ExperimentData
    from nanopore_tpu_torch.analyses.mutate_reference import (
        mutate_reference_sequences,
    )
    from nanopore_tpu_torch.align.realign import window_global_pair
    from nanopore_tpu_torch.io.encoding import encode
    from nanopore_tpu_torch.io.sam import CIG
    from nanopore_tpu_torch.io.seqio import read_fasta_dict
    from nanopore_tpu_torch.mapping.engine import MappingEngine
    from nanopore_tpu_torch.mapping.presets import MAPPER_REGISTRY
    from nanopore_tpu_torch.mapping.runner import run_mapper
    from nanopore_tpu_torch.ops.dispatch import _pairs_k_max
    from nanopore_tpu_torch.ops.pack import pack_stream_pairs

    dev = torch.device("cuda", 0)
    B = 512
    out = []

    def save(name, pairs, W, k_max, mode, model, **extra):
        prep = pack_stream_pairs(pairs, W, _pairs_k_max(pairs, k_max))
        path = os.path.join(workdir, name + ".npz")
        np.savez(path, stream=prep["stream"], initx=prep["initx"],
                 m=prep["m"], n=prep["n"])
        need = int((prep["m"].astype(np.int64) + prep["n"] + 1).sum())
        out.append(dict(name=name, path=path, W=W, mode=mode, model=model,
                        B=len(pairs), k_pad=prep["k_pad"], need_diags=need,
                        **extra))
        print("batch %s: B=%d k_pad=%d W=%d %s" % (name, len(pairs),
                                                  prep["k_pad"], W, mode))

    # the mapping path
    fa, fq = cs.write_workload(workdir, cs.REF_LEN)
    engine = MappingEngine(read_fasta_dict(fa),
                           MAPPER_REGISTRY["LastParams"].config, device=dev)
    save("decode_w64", cs.main_path_batch(engine, fq, B), 64, None, "decode",
         "default")
    out.append(dict(out[-1], name="viterbi_w64", mode="viterbi"))
    out.append(dict(out[-1], name="forward_w64", mode="forward"))
    out.append(dict(out[-1], name="walk_mea_w64", mode="walk_mea"))
    out.append(dict(out[-1], name="walk_viterbi_w64", mode="walk_viterbi"))
    out.append(dict(out[-1], name="pack_w64", mode="pack"))
    del engine
    # the EM path
    em_dir = os.path.join(workdir, "em")
    fa2, fq2 = cs.write_workload(em_dir, cs.EM_REF_LEN)
    mapped = os.path.join(em_dir, "mapped.sam")
    chained = os.path.join(em_dir, "chained.sam")
    run_mapper("LastParams", fq2, "reads", fa2, mapped, device=dev)
    chain_sam_file(mapped, chained, fq2, fa2)
    em_pairs = cs.chained_pairs(chained, fa2, 256)[:B]
    save("em", em_pairs, 64, None, "em", "random")
    out.append(dict(out[-1], name="forward_em", mode="forward"))
    # the parent's plan: B x k_pad rows of workspace, cut by read count
    k_pad = out[-2]["k_pad"]
    split = (8 << 30) // (k_pad * 5 * 64 * 4 + (k_pad + 1) * 4)
    out.append(dict(out[-2], name="em_split_%d" % split, split=split))
    pairs, k_max, _ = cs.fullest_bucket(cs.chained_pairs(chained, fa2, 128))
    save("decode_w32", pairs[:B], 32, k_max, "decode", "default")
    out.append(dict(out[-1], name="forward_w32", mode="forward"))
    out.append(dict(out[-2], name="walk_mea_w32", mode="walk_mea"))
    out.append(dict(out[-3], name="pack_w32", mode="pack"))
    out.append(dict(out[-4], name="viterbi_w32", mode="viterbi"))
    # the posterior path
    post_dir = os.path.join(workdir, "post")
    os.makedirs(post_dir, exist_ok=True)
    ref = os.path.join(post_dir, "ref.fa")
    with open(fa2) as src, open(ref, "w") as dst:
        dst.write(src.read())
    _, mut_fa = mutate_reference_sequences([ref], rates=(cs.MUTATION_RATE,),
                                           seed=cs.SEED)
    local_sam = os.path.join(post_dir, "local.sam")
    global_sam = os.path.join(post_dir, "realigned.sam")
    run_mapper("LastParams", fq2, "reads", mut_fa, local_sam, device=dev)
    run_mapper("LastParamsRealign", fq2, "reads", mut_fa, global_sam,
               device=dev)

    def guide_of(rec):
        return [(op, ln) for op, ln in rec.cigar
                if op in (CIG.M, CIG.I, CIG.D)]

    data = ExperimentData(fq2, mut_fa, local_sam)
    items = [(data.ref_codes[rec.rname][rec.pos:rec.aend], encode(rec.query),
              guide_of(rec)) for rec in data.records]
    pairs, k_max, _ = cs.fullest_bucket(items)
    save("gamma", pairs[:B], 64, k_max, "gamma", "blasr_hmm_0.txt")
    pairs, k_max, _ = cs.fullest_bucket(cs.chained_pairs(global_sam, mut_fa,
                                                         128))
    save("decode_gamma", pairs[:B], 32, k_max, "decode_gamma", "default")
    data = ExperimentData(fq2, mut_fa, global_sam)
    items = []
    for rec in data.records:
        xw, guide, _, _ = window_global_pair(data.ref_codes[rec.rname],
                                             guide_of(rec))
        items.append((xw, encode(rec.query), guide))
    buckets = cs.shape_buckets(items)
    main_key = max(buckets, key=lambda k: len(buckets[k]))
    for key in sorted(buckets, key=sum):
        name = "exp" if key == main_key else "exp_far_%dx%d" % key
        save(name, [items[i] for i in buckets[key][:B]], 64, sum(key), "exp",
             "default")
    return out


def _digest(outs: dict) -> str:
    """A digest of every output tensor's bytes (NaN patterns included)."""
    import torch

    h = hashlib.sha1()
    for key in sorted(outs):
        h.update(key.encode())
        h.update(outs[key].contiguous().view(-1).view(torch.uint8).cpu()
                 .numpy().tobytes())
    return h.hexdigest()[:16]


def time_tree(batches: list[dict], reps: int, repeat: int = 1) -> list[dict]:
    """Child process: time every batch with the checkout first on
    sys.path, each batch's reads tiled ``repeat`` times."""
    import inspect

    import torch

    from nanopore_tpu_torch.kernels import build
    from nanopore_tpu_torch.ops import forward as F
    from nanopore_tpu_torch.ops import pack as P
    from nanopore_tpu_torch.ops import realign as R
    from nanopore_tpu_torch.ops import traceback as T
    from nanopore_tpu_torch.ops import viterbi as V
    from nanopore_tpu_torch.ops.pack import pack_xyc
    from nanopore_tpu_torch.ops.pairhmm import make_kernel_params
    from nanopore_tpu_torch.ops.viterbi import viterbi_forward

    # the kernels each batch launches, its untimed inputs included
    libs = {"pack": ("pack",), "forward": ("pack", "forward"),
            "viterbi": ("pack", "viterbi"),
            "walk_viterbi": ("pack", "viterbi", "viterbi_traceback"),
            "walk_mea": ("pack", "realign", "traceback")}
    names = sorted({lib for bt in batches
                    for lib in libs.get(bt["mode"], ("pack", "realign"))})
    print("tree %s: build %.1f s" % (os.path.dirname(os.path.dirname(
        R.__file__)), build.build(names)), flush=True)
    dev = torch.device("cuda", 0)
    R.WORKSPACE_BYTES *= repeat
    takes_kend = "kend" in inspect.signature(R.realign_em).parameters
    counters = (P.LAUNCHES, R.LAUNCHES, R.EM_LAUNCHES, R.GAMMA_LAUNCHES,
                R.DECODE_GAMMA_LAUNCHES, R.EXP_LAUNCHES, T.LAUNCHES,
                T.VIT_LAUNCHES, V.LAUNCHES, F.LAUNCHES)
    res = []
    for bt in batches:
        z = {k: np.concatenate([v] * repeat)
             for k, v in np.load(bt["path"]).items()}
        put = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        m, n = put(z["m"]), put(z["n"])
        stream, initx = put(z["stream"]), put(z["initx"])
        xyc = pack_xyc(stream, initx, m, n)
        kend = (z["m"].astype(np.int64) + z["n"]).astype(np.int32)
        params = make_kernel_params(_model(bt["model"]))
        split = bt.get("split") or len(kend)
        parts = [(xyc[r0:r0 + split], m[r0:r0 + split], n[r0:r0 + split],
                  kend[r0:r0 + split]) for r0 in range(0, len(kend), split)]

        dirs = vit = None  # the walkers' inputs, made untimed
        if bt["mode"] == "walk_mea":
            dirs = R.realign_decode(xyc, m, n, params)["dirs"]
        elif bt["mode"] == "walk_viterbi":
            vit = viterbi_forward(xyc, m, n, params)

        def call(x, mm, nn, ke):
            kw = {"kend": ke} if takes_kend else {}
            if bt["mode"] == "pack":
                return {"xyc": pack_xyc(stream, initx, mm, nn)}
            if bt["mode"] == "walk_mea":
                return {"ops": T.mea_walk(dirs, x, mm, nn)}
            if bt["mode"] == "walk_viterbi":
                ops, end = T.viterbi_walk(vit["bp"], x, mm, nn, vit["fstate"])
                return {"ops": ops, "end": end}
            if bt["mode"] == "viterbi":
                return viterbi_forward(x, mm, nn, params)
            if bt["mode"] == "forward":
                return {"loglik": F.forward_loglik(x, mm, nn, params)}
            if bt["mode"] == "decode":
                return R.realign_decode(x, mm, nn, params, **kw)
            if bt["mode"] == "decode_gamma":
                return R.realign_decode(x, mm, nn, params, emit_gamma=True,
                                        **kw)
            if bt["mode"] == "gamma":
                return R.realign_gamma(x, mm, nn, params, **kw)
            if bt["mode"] == "exp":
                return R.realign_exp(x, mm, nn, params, 1e-3, **kw)
            return R.realign_em(x, mm, nn, params, **kw)

        def run():
            return [call(*p) for p in parts]

        outs = run()
        digest = _digest({"%d_%s" % (i, k): v for i, o in enumerate(outs)
                          for k, v in o.items()})
        del outs
        before = sum(c.count for c in counters)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            start.record()
            run()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        launches = (sum(c.count for c in counters) - before) // reps
        row = dict(name=bt["name"], ms=float(np.mean(times)), ms_all=times,
                   launches=launches, digest=digest)
        print("  %-18s %10.3f ms (%s) %d launch(es), digest %s"
              % (bt["name"], row["ms"], " ".join("%.3f" % t for t in times),
                 launches, digest), flush=True)
        res.append(row)
        del xyc, dirs, vit, stream, initx
    return res


def _sass(tree: str, workdir: str) -> dict:
    """{source: {kernel: its instructions}} of every csrc/*.cu of TREE,
    built with that tree's flags."""
    import importlib.util
    import re

    spec = importlib.util.spec_from_file_location(
        "build_%d" % abs(hash(tree)),
        os.path.join(tree, "nanopore_tpu_torch", "kernels", "build.py"))
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)
    tools = os.path.dirname(build.nvcc())
    procs = []
    for name in build.SOURCES:  # one nvcc a source, all at once
        flags = [f for f in build._flags(name) if f not in (
            "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")]
        cubin = os.path.join(workdir, "%s-%s.cubin" % (
            name, hashlib.sha1(tree.encode()).hexdigest()[:8]))
        procs.append((name, cubin, subprocess.Popen(
            [build.nvcc()] + flags + [
                "-cubin", os.path.join(build.CSRC, name + ".cu"), "-o", cubin],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    out = {}
    for name, cubin, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed for %s:\n%s" % (name, log))
        dump = subprocess.run([os.path.join(tools, "cuobjdump"), "-sass",
                               cubin], check=True, capture_output=True,
                              text=True).stdout
        kernels, cur = {}, None
        for line in dump.splitlines():
            m = re.match(r"\s*Function : (\S+)", line)
            if m:
                cur = kernels.setdefault(m.group(1), [])
                continue
            # no encodings, and no anonymous namespace's per-file hash
            body = re.sub(r"_GLOBAL__N__\w+", "_ANON", re.sub(
                r"/\*.*?\*/", "", line)).strip()
            if cur is not None and body and not body.startswith(
                    (".", "-", "=")):
                cur.append(" ".join(body.split()))
        out[name] = kernels
    return out


def sass_compare(trees: list[str], out_dir: str | None = None) -> int:
    """Print, for each kernel of trees[0], whether each other tree has a
    kernel of the same machine code; the JSON summary last.  With
    ``out_dir``, every kernel's instructions are written to
    ``out_dir/<tree index>/<source>/<kernel>.sass``, one a line."""
    workdir = os.path.join(ROOT, "nanopore_tpu_torch", "_build", "sass_ab")
    os.makedirs(workdir, exist_ok=True)
    dumps = [_sass(os.path.abspath(t), workdir) for t in trees]
    mangled = sorted({k for d in dumps for ks in d.values() for k in ks})
    try:
        filt = subprocess.run(["c++filt"], input="\n".join(mangled),
                              capture_output=True,
                              text=True).stdout.splitlines()
    except OSError:  # no demangler: the mangled names
        filt = []
    plain = dict(zip(mangled, (f.replace("(anonymous namespace)::", "")
                               for f in filt))) if len(filt) == len(
        mangled) else {k: k for k in mangled}
    if out_dir:
        for i, d in enumerate(dumps):
            for name, kernels in d.items():
                os.makedirs(os.path.join(out_dir, str(i), name), exist_ok=True)
                for kernel, body in kernels.items():
                    label = plain[kernel].split("(")[0].replace(" ", "")
                    with open(os.path.join(out_dir, str(i), name,
                                           label + ".sass"), "w") as fh:
                        fh.write("\n".join(body) + "\n")
    summary = {}
    for name, kernels in dumps[0].items():
        for kernel, body in sorted(kernels.items()):
            same = [any(b == body for b in d.get(name, {}).values())
                    for d in dumps[1:]]
            label = plain[kernel].split("(")[0]
            summary.setdefault(name, {})[label] = same
            print("%-18s %-50s %5d %s" % (name, label, len(body), " ".join(
                "same" if x else "DIFFERS" for x in same)))
    print(json.dumps({"trees": trees, "same_machine_code": summary}))
    return 0


def pair_summary(path: str) -> int:
    """Per batch: each tree's median and interquartile range, and its
    median against the first tree's; for two trees run in pairs, also
    the second tree's wins and losses over the consecutive pairs."""
    with open(path) as fh:
        result = json.load(fh)
    runs = result["runs"]
    trees = list(dict.fromkeys(run["tree"] for run in runs))
    paired = len(trees) == 2 and len(runs) % 2 == 0
    print(result.get("card", ""), "|", " / ".join(
        "%s (%d runs)" % (t, sum(r["tree"] == t for r in runs))
        for t in trees))
    for i, bt in enumerate(result["batches"]):
        ms = {t: [r["rows"][i]["ms"] for r in runs if r["tree"] == t]
              for t in trees}
        med = {t: float(np.median(v)) for t, v in ms.items()}
        iqr = {t: float(np.subtract(*np.percentile(v, [75, 25])))
               for t, v in ms.items()}
        line = "%-20s %s" % (bt["name"], "  ".join(
            "%.3f ms (%+.1f %%, IQR %.3f)" % (
                med[t], 100 * (med[t] / med[trees[0]] - 1), iqr[t])
            for t in trees))
        if paired:
            pairs = [{r["tree"]: r["rows"][i]["ms"] for r in runs[j:j + 2]}
                     for j in range(0, len(runs), 2)]
            a, b = trees
            line += ", won %d lost %d of %d" % (
                sum(p[b] < p[a] for p in pairs),
                sum(p[b] > p[a] for p in pairs), len(pairs))
        print(line)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--repeat", type=int, default=1,
                    help="tile every batch's reads N times (an occupancy "
                    "probe: N reads a warp scheduler)")
    ap.add_argument("--out", help="where to write the JSON (default: "
                    "nanopore_tpu_torch/_build/realign_ab/result.json); "
                    "with --sass, a directory for each kernel's "
                    "instructions")
    ap.add_argument("--only", default="",
                    help="for ablation runs: time only the batches whose "
                    "names start with one of these comma-separated prefixes "
                    "(the JSON lists the rest as left_out)")
    ap.add_argument("--summary", metavar="FILE",
                    help="summarise a JSON of two trees run in pairs, "
                    "and time nothing")
    ap.add_argument("--sass", action="store_true",
                    help="compare the trees' machine code, kernel by "
                    "kernel, and time nothing")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.summary:
        return pair_summary(args.summary)
    if not args.trees:
        ap.error("name at least one TREE")
    if args.sass:
        return sass_compare(args.trees, args.out)
    import torch

    if not torch.cuda.is_available():
        print("realign_ab: no CUDA device", file=sys.stderr)
        return 1
    if args.child:  # time one tree: trees[0] is its root
        sys.path.insert(0, os.path.abspath(args.trees[0]))
        with open(args.child) as fh:
            batches = json.load(fh)
        print("RESULT " + json.dumps(time_tree(batches, args.reps,
                                               args.repeat)))
        return 0
    sys.path.insert(0, ROOT)
    from nanopore_tpu_torch.kernels import build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    t0 = time.perf_counter()
    workdir = os.path.join(build.BUILD_DIR, "realign_ab")
    os.makedirs(workdir, exist_ok=True)
    out_path = args.out or os.path.join(workdir, "result.json")
    every = build_batches(workdir)
    only = tuple(args.only.split(","))
    batches = [bt for bt in every if bt["name"].startswith(only)]
    left_out = [bt["name"] for bt in every
                if not bt["name"].startswith(only)]
    spec = os.path.join(workdir, "batches.json")
    with open(spec, "w") as fh:
        json.dump(batches, fh)
    print("batches: %.1f s" % (time.perf_counter() - t0), flush=True)
    runs = []
    for tree in args.trees:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), tree, "--reps",
             str(args.reps), "--repeat", str(args.repeat), "--child", spec],
            capture_output=True, text=True)
        sys.stdout.write("".join(ln + "\n" for ln in proc.stdout.splitlines()
                                 if not ln.startswith("RESULT ")))
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            print("realign_ab: tree %s failed" % tree, file=sys.stderr)
            return 1
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("RESULT ")][-1]
        runs.append(dict(tree=tree, rows=json.loads(line[len("RESULT "):])))
    bad = [bt["name"] for i, bt in enumerate(batches)
           if len({run["rows"][i]["digest"] for run in runs}) > 1]
    result = {"card": card, "repeat": args.repeat, "batches": batches,
              "runs": runs,
              "outputs_differ": bad, "left_out": left_out}
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as fh:
        json.dump(result, fh, indent=1)
    for i, bt in enumerate(batches):
        print("%-18s %s" % (bt["name"], "  ".join(
            "%s %.3f" % (run["tree"], run["rows"][i]["ms"]) for run in runs)))
    print("realign_ab wall: %.1f s" % (time.perf_counter() - t0))
    print(json.dumps({"outputs_differ": bad, "left_out": left_out, "ms": {
        bt["name"]: [run["rows"][i]["ms"] for run in runs]
        for i, bt in enumerate(batches)}}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
