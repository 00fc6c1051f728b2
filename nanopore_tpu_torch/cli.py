"""Command-line interface of the PyTorch/CUDA port.

``python -m nanopore_tpu_torch map reads.fq ref.fa out.sam`` maps a FASTQ
against a reference on the card (``--device cpu`` runs the plain
PyTorch path on the CPU).  The kernels build with nvcc on first use.
"""

from __future__ import annotations

import argparse
import logging
import sys


def cmd_map(args) -> int:
    from nanopore_tpu_torch.mapping.runner import run_mapper

    run_mapper(
        args.mapper, args.reads, "reads", args.reference, args.output,
        device=args.device,
    )
    print("wrote %s" % args.output)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="nanopore_tpu_torch",
        description="nanopore mapping on NVIDIA GPUs (PyTorch/CUDA port)",
    )
    parser.add_argument("--log-level", default="INFO")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("map", help="map a FASTQ against a reference")
    p.add_argument("reads")
    p.add_argument("reference")
    p.add_argument("output")
    p.add_argument("--mapper", default="LastParams")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="default: cuda (raises when no card is present)")
    p.set_defaults(fn=cmd_map)

    args = parser.parse_args(argv)
    logging.basicConfig(
        level=getattr(logging, args.log_level.upper()),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
