"""Command-line interface of the PyTorch/CUDA port.

``python -m nanopore_tpu_torch run <workingDir>`` runs the whole
pipeline on a working directory (the reference's ``make run`` /
``pipeline.sh <workingDir>``, reference Makefile:8-12), with the
mapper, analysis and meta-analysis lists as flags.
``python -m nanopore_tpu_torch map reads.fq ref.fa out.sam`` maps a FASTQ
against a reference; ``chain``, ``realign``, ``em`` and ``modify-hmm``
expose the post-processing building blocks; ``sam2bam`` and ``bam2sam``
convert between SAM and a sorted, indexed BAM on the host.  Every
subcommand that computes on a device runs on the card unless ``--device
cpu`` asks for the plain PyTorch path on the CPU.  The kernels build
with nvcc on first use.
"""

from __future__ import annotations

import argparse
import logging
import sys


def cmd_run(args) -> int:
    from nanopore_tpu_torch.align.em import EmOptions
    from nanopore_tpu_torch.pipeline import PipelineConfig, run_pipeline

    config = PipelineConfig(device=args.device)
    if args.mappers:
        config.mappers = args.mappers.split(",")
    if args.analyses:
        config.analyses = args.analyses.split(",")
    if args.meta_analyses is not None:
        config.meta_analyses = (
            args.meta_analyses.split(",") if args.meta_analyses else []
        )
    config.max_workers = args.max_threads
    config.em_options = EmOptions(
        trials=args.em_trials, iterations=args.em_iterations
    )
    config.mutate_references = args.mutate_references
    config.sample_reads = args.sample_reads
    out = run_pipeline(args.working_dir, config)
    print("pipeline complete: %s" % out)
    return 0


def cmd_map(args) -> int:
    from nanopore_tpu_torch.mapping.runner import run_mapper

    run_mapper(
        args.mapper, args.reads, "reads", args.reference, args.output,
        args.hmm_out, device=args.device,
    )
    print("wrote %s" % args.output)
    return 0


def cmd_chain(args) -> int:
    from nanopore_tpu_torch.align.chain_sam import chain_sam_file

    chain_sam_file(args.input, args.output, args.reads, args.reference)
    print("wrote %s" % args.output)
    return 0


def cmd_realign(args) -> int:
    from nanopore_tpu_torch.align.model import PairHmmModel
    from nanopore_tpu_torch.align.realign import realign_sam_file

    model = PairHmmModel.load(args.hmm) if args.hmm else None
    realign_sam_file(
        args.input, args.output, args.reads, args.reference,
        gap_gamma=args.gap_gamma, match_gamma=args.match_gamma,
        hmm_model=model, band_width=args.band_width, device=args.device,
    )
    print("wrote %s" % args.output)
    return 0


def cmd_em(args) -> int:
    from nanopore_tpu_torch.align.em import (
        EmOptions,
        learn_model_from_sam_file,
    )

    learn_model_from_sam_file(
        args.input, args.reference, args.output,
        EmOptions(trials=args.trials, iterations=args.iterations),
        device=args.device,
    )
    print("wrote %s (+ _unnormalised, .xml)" % args.output)
    return 0


def cmd_modify_hmm(args) -> int:
    """scripts/modifyHmm.py equivalent (reference scripts/modifyHmm.py)."""
    from nanopore_tpu_torch.align.model import PairHmmModel

    model = PairHmmModel.load(args.input)
    if args.flatten_indels:
        model.set_indel_emissions_flat()
    model.normalise_by_reference_gc_content(args.gc_content)
    if args.substitution_rate > 0:
        model.modify_emissions_by_expected_variation_rate(
            args.substitution_rate
        )
    model.write(args.output)
    print("wrote %s" % args.output)
    return 0


def cmd_sam2bam(args) -> int:
    """samtools view -b | sort | index equivalent (utils.py:222-230)."""
    from nanopore_tpu_torch.io.bam import sam_to_sorted_bam

    out = args.output or (args.input.rsplit(".", 1)[0] + ".bam")
    sam_to_sorted_bam(args.input, out, out + ".bai")
    print("wrote %s (+ .bai)" % out)
    return 0


def cmd_bam2sam(args) -> int:
    """samtools view equivalent: BAM back to SAM text."""
    from nanopore_tpu_torch.io.bam import BamReader
    from nanopore_tpu_torch.io.sam import SamWriter

    out = args.output or (args.input.rsplit(".", 1)[0] + ".sam")
    with BamReader(args.input) as br:
        with SamWriter(out, br.reference_lengths) as w:
            for rec in br:
                w.write(rec)
    print("wrote %s" % out)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="nanopore_tpu_torch",
        description="nanopore mapping on NVIDIA GPUs (PyTorch/CUDA port)",
    )
    parser.add_argument("--log-level", default="INFO")
    sub = parser.add_subparsers(dest="command", required=True)

    def add_device(p):
        p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                       help="default: cuda (raises when no card is present)")

    p = sub.add_parser("run", help="run the full pipeline on a working dir")
    p.add_argument("working_dir")
    p.add_argument("--mappers", default="", help="comma-separated mapper names")
    p.add_argument("--analyses", default="", help="comma-separated analyses")
    p.add_argument("--meta-analyses", default=None)
    p.add_argument("--max-threads", type=int, default=4)
    p.add_argument("--em-trials", type=int, default=3)
    p.add_argument("--em-iterations", type=int, default=100)
    p.add_argument("--mutate-references", action="store_true")
    p.add_argument("--sample-reads", action="store_true")
    add_device(p)
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("map", help="map a FASTQ against a reference")
    p.add_argument("reads")
    p.add_argument("reference")
    p.add_argument("output")
    p.add_argument("--mapper", default="LastParams")
    p.add_argument("--hmm-out", default=None)
    add_device(p)
    p.set_defaults(fn=cmd_map)

    p = sub.add_parser("chain", help="chain a SAM into global alignments")
    p.add_argument("input")
    p.add_argument("reads")
    p.add_argument("reference")
    p.add_argument("output")
    p.set_defaults(fn=cmd_chain)

    p = sub.add_parser("realign", help="chain + MEA-realign a SAM")
    p.add_argument("input")
    p.add_argument("reads")
    p.add_argument("reference")
    p.add_argument("output")
    p.add_argument("--hmm", default=None)
    p.add_argument("--gap-gamma", type=float, default=0.5)
    p.add_argument("--match-gamma", type=float, default=0.0)
    # the realign-parity band: the reference's production band is 21
    # cells (--diagonalExpansion=10); 32 covers it at half the cells
    # of 64 (MapperSpec.band_width default)
    p.add_argument("--band-width", type=int, default=32,
                   help="live band width; on the card 2 to 2048 (the MEA "
                   "path's kernels), any width with --device cpu")
    add_device(p)
    p.set_defaults(fn=cmd_realign)

    p = sub.add_parser("em", help="Baum-Welch train an HMM on a chained SAM")
    p.add_argument("input")
    p.add_argument("reference")
    p.add_argument("output")
    p.add_argument("--trials", type=int, default=3)
    p.add_argument("--iterations", type=int, default=100)
    add_device(p)
    p.set_defaults(fn=cmd_em)

    p = sub.add_parser("sam2bam", help="SAM -> sorted BAM + .bai index")
    p.add_argument("input")
    p.add_argument("-o", "--output", default=None)
    p.set_defaults(fn=cmd_sam2bam)

    p = sub.add_parser("bam2sam", help="BAM -> SAM text")
    p.add_argument("input")
    p.add_argument("-o", "--output", default=None)
    p.set_defaults(fn=cmd_bam2sam)

    p = sub.add_parser(
        "modify-hmm", help="renormalise an HMM (scripts/modifyHmm.py)"
    )
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--gc-content", type=float, default=0.5)
    p.add_argument("--substitution-rate", type=float, default=0.0)
    p.add_argument("--flatten-indels", action="store_true")
    p.set_defaults(fn=cmd_modify_hmm)

    args = parser.parse_args(argv)
    logging.basicConfig(
        level=getattr(logging, args.log_level.upper()),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
