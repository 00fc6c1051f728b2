"""Supplementary SNV-detection LaTeX tables.

A copy of the JAX package's ``scripts/variant_table.py``.

Reproduces the reference's scripts/variantTable.py: parse the
MarginAlignMetaAnalysis ``marginAlignSquares.txt`` and emit one
sideways LaTeX table per (readType, mapper, caller) block with
recall/precision/F-score rows per mutation frequency and coverage.

Usage: python -m nanopore_tpu_torch.scripts.variant_table \\
           <out.tex> <marginAlignSquares.txt>
"""

from __future__ import annotations

import sys

from nanopore_tpu_torch.scripts import textable as tex


def pct(x: str) -> str:
    return "%.2f" % (100 * float(x))


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    out_path, squares_path = argv
    with open(out_path, "w") as fh:
        tex.write_document_preliminaries(fh)
        with open(squares_path) as inp:
            header = inp.readline().split("\t")
            # coverage labels from the header columns
            cov_labels = [
                h.split("_coverage_")[-1].strip()
                for h in header
                if h.startswith("avg_recall_coverage_")
            ]
            n_cov = len(cov_labels)
            table_no = 1
            for line in inp:
                tokens = line.rstrip("\n").split("\t")
                if len(tokens) < 4 + 9 * n_cov:
                    continue
                read_type, mapper, caller, held_out = tokens[:4]
                vals = tokens[4:]
                # layout: 3n recall, 3n precision, 3n fscore; avg = [1::3]
                recall = vals[0 : 3 * n_cov][1::3]
                precision = vals[3 * n_cov : 6 * n_cov][1::3]
                fscore = vals[6 * n_cov : 9 * n_cov][1::3]

                tex.write_preliminaries(2 + n_cov, fh)
                tex.write_row(
                    ["Metric", "\\% held out"]
                    + ["cov. %s" % c for c in cov_labels],
                    fh,
                )
                fh.write("\\hline\n")
                tex.write_row(
                    ["Recall", pct(held_out)] + [pct(v) for v in recall], fh
                )
                tex.write_row(
                    ["Precision", ""] + [pct(v) for v in precision], fh
                )
                tex.write_row(
                    ["F-score", ""] + [pct(v) for v in fscore], fh
                )
                tex.write_end(
                    fh,
                    "table%d" % table_no,
                    "SNV detection: %s reads, %s, %s"
                    % (
                        read_type,
                        mapper.replace("_", "\\_"),
                        caller.replace("_", "\\_"),
                    ),
                )
                table_no += 1
        tex.write_document_end(fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
