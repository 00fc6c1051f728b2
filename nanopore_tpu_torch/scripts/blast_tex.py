"""LaTeX table of BLAST species hits.

A copy of the JAX package's ``scripts/blast_tex.py``.

Reproduces the reference's scripts/blast_combined/make_blast_tex.py:
turn the per-readType blast reports from
nanopore_tpu_torch.scripts.blast_unmapped into one LaTeX document with a
species-count table per read type.

Usage: python -m nanopore_tpu_torch.scripts.blast_tex <blast_output_dir> <out.tex>
"""

from __future__ import annotations

import os
import sys

from nanopore_tpu_torch.scripts import textable as tex

READ_TYPES = ["2D", "template", "complement"]


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    blast_dir, out_path = argv
    with open(out_path, "w") as fh:
        tex.write_document_preliminaries(fh)
        for read_type in READ_TYPES:
            report = os.path.join(blast_dir, read_type + "_blast_report.txt")
            if not os.path.exists(report):
                continue
            rows = []
            with open(report) as inp:
                inp.readline()  # header
                for line in inp:
                    parts = line.rstrip("\n").split("\t")
                    if len(parts) >= 4:
                        rows.append((parts[1], parts[3]))
            if not rows:
                continue
            tex.write_preliminaries(2, fh)
            tex.write_row(["Species", "Hits"], fh)
            fh.write("\\hline\n")
            for species, count in rows[:30]:
                tex.write_row([species.replace("_", "\\_"), count], fh)
            tex.write_end(
                fh,
                "blast_%s" % read_type,
                "BLAST species hits for unmappable %s reads" % read_type,
            )
        tex.write_document_end(fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
