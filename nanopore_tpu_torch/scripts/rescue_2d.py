"""2D-read rescue analysis: align template/complement reads to the
reference window their 2D read mapped to.

Counterpart of the JAX package's ``scripts/rescue_2d.py``.  Reproduces
the reference's scripts/muscle_compare_2d/muscle_compare_2d.py
WITHOUT the external MUSCLE binary: the pairwise global alignment of
each template/complement read against its 2D-aligned reference window
runs through the pack kernel, the fused realign kernel in decode mode
and the MEA walker (the realigner's path), and the metrics match the
reference's gapped-column walk (muscle_compare_2d.py:72-88).  It runs on
the card unless ``device="cpu"`` (``--device cpu``) asks for the plain
PyTorch path; on the card the band width must be 2 to 2048 (ROADMAP C10,
C11).

Usage: python -m nanopore_tpu_torch.scripts.rescue_2d \\
           <template.sam> <complement.sam> <twod.sam> \\
           --working-dir <dir with readFastqFiles/ referenceFastaFiles/> \\
           --output-dir <out> [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

from nanopore_tpu_torch.align.model import PairHmmModel
from nanopore_tpu_torch.device import resolve_device
from nanopore_tpu_torch.io.encoding import encode
from nanopore_tpu_torch.io.sam import SamReader, CIG
from nanopore_tpu_torch.io.seqio import fasta_read, fastq_read
from nanopore_tpu_torch.ops.dispatch import (
    PreparedRealign,
    preferred_realign_batch_size,
    prepared_from_pairs,
)
from nanopore_tpu_torch.ops.pack import MEA, check_band_width
from nanopore_tpu_torch.ops.pairhmm import KernelParams, make_kernel_params

HEADER = (
    "Read\tReference\tMatches\tMismatches\tReadDeletionLength\t"
    "ReadInsertionLength\tIdentity\tReferenceCoverage\n"
)


def alignment_metrics(cigar, read_codes, ref_codes):
    """Matches/mismatches/indel lengths/identity/refCoverage per the
    reference's gapped-column metrics (muscle_compare_2d.py:72-88)."""
    i = j = matches = mismatches = 0
    read_del = read_ins = 0
    for op, length in cigar:
        if op == CIG.M:
            r = ref_codes[j : j + length]
            q = read_codes[i : i + length]
            matches += int((r == q).sum())
            mismatches += int((r != q).sum())
            i += length
            j += length
        elif op == CIG.I:
            read_ins += length
            i += length
        else:
            read_del += length
            j += length
    identity = matches / (matches + mismatches) if matches + mismatches else 0.0
    ref_cov = (
        (matches + mismatches) / (matches + mismatches + read_del)
        if matches + mismatches + read_del
        else 0.0
    )
    return [
        float(matches), float(mismatches), float(read_del), float(read_ins),
        identity, ref_cov,
    ]


def guide_pair(seq: str, window: str):
    """(window codes, read codes, guide): ``M d`` on the shorter length,
    then the read's or the window's remainder as ``I`` or ``D``."""
    x = encode(window)
    y = encode(seq)
    d = min(len(y), len(x))
    guide = [(CIG.M, d)]
    if len(y) > d:
        guide.append((CIG.I, len(y) - d))
    if len(x) > d:
        guide.append((CIG.D, len(x) - d))
    return x, y, guide


def rescue_metrics(jobs, params: KernelParams, band_width: int,
                   batch_size: int, device) -> list[str]:
    """One TSV row (newline included) per ``(name, ref_name, seq,
    window)`` job, in job order: the read MEA-aligned to its window in
    batches of ``batch_size``, on ``device`` (where ``params`` lie).  A
    read's cigar does not depend on its batch."""
    rows = []
    for s in range(0, len(jobs), batch_size):
        sub = jobs[s : s + batch_size]
        pairs = [guide_pair(seq, window) for _, _, seq, window in sub]
        prep = prepared_from_pairs(
            {"device": device},
            pairs,
            params,
            band_width=band_width,
            prepared_cls=PreparedRealign,
        )
        _, cigars, _ = prep.decode()
        for (name, ref_name, _, _), (x, y, _), cigar in zip(sub, pairs,
                                                            cigars):
            metrics = alignment_metrics(cigar, y, x)
            rows.append(
                "\t".join([name, ref_name] + [str(v) for v in metrics])
                + "\n"
            )
    return rows


def rescue(template_sam, complement_sam, twod_sam, working_dir, output_dir,
           band_width=64, device=None):
    """Write ``template_metrics.tsv`` and ``complement_metrics.tsv`` into
    ``output_dir``: one row per 2D-mapped read that neither the template
    nor the complement SAM maps.  Runs on the card unless
    ``device="cpu"``, in the preferred realign batches (512 reads on the
    card, 4 on the CPU)."""
    check_band_width(band_width, device, MEA)
    dev = resolve_device(device)
    batch_size = preferred_realign_batch_size(None, dev)
    os.makedirs(output_dir, exist_ok=True)
    template_mapped = {r.qname for r in SamReader(template_sam).mapped()}
    complement_mapped = {r.qname for r in SamReader(complement_sam).mapped()}
    twod = {r.qname: r for r in SamReader(twod_sam).mapped()}

    # 2D-mappable reads that neither template nor complement mapped
    # (muscle_compare_2d.py:113-118)
    to_analyze = {}
    for name, rec in twod.items():
        if name not in template_mapped and name not in complement_mapped:
            aln_len = rec.aend - rec.pos
            to_analyze[name] = (rec.rname, rec.aend - aln_len, rec.aend)
    if not to_analyze:
        raise RuntimeError(
            "none of the mappable 2D reads failed to map as "
            "template/complement"
        )

    references = {}
    ref_dir = os.path.join(working_dir, "referenceFastaFiles")
    for fname in os.listdir(ref_dir):
        if fname.endswith(".fa") or fname.endswith(".fasta"):
            for header, seq in fasta_read(os.path.join(ref_dir, fname)):
                references[header.split()[0]] = seq

    params = make_kernel_params(PairHmmModel.default(), device=dev)

    for read_type in ("template", "complement"):
        fq_dir = os.path.join(working_dir, "readFastqFiles", read_type)
        if not os.path.isdir(fq_dir):
            raise RuntimeError(
                "readFastqFiles does not contain a %s folder" % read_type
            )
        jobs = []
        for fname in os.listdir(fq_dir):
            if not (fname.endswith(".fq") or fname.endswith(".fastq")):
                continue
            for header, seq, _ in fastq_read(os.path.join(fq_dir, fname)):
                name = header.split()[0]
                if name in to_analyze:
                    ref_name, start, stop = to_analyze[name]
                    window = references[ref_name][start:stop]
                    jobs.append((name, ref_name, seq, window))

        rows = rescue_metrics(jobs, params, band_width, batch_size, dev)
        out_path = os.path.join(output_dir, read_type + "_metrics.tsv")
        with open(out_path, "w") as fh:
            fh.write(HEADER)
            fh.writelines(rows)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("template_sam")
    parser.add_argument("complement_sam")
    parser.add_argument("twod_sam")
    parser.add_argument("--working-dir", default="..")
    parser.add_argument("--output-dir", default="muscle_compare_2d/output")
    parser.add_argument("--device", choices=("cuda", "cpu"), default=None,
                        help="default: cuda (raises when no card is present)")
    args = parser.parse_args(argv)
    rescue(
        args.template_sam, args.complement_sam, args.twod_sam,
        args.working_dir, args.output_dir, device=args.device,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
