"""BLAST the truly-unmappable reads against NT.

A copy of the JAX package's ``scripts/blast_unmapped.py``.

Reproduces the reference's scripts/blast_combined/blast_combined.py:
collect reads unmapped by ALL of the four tuned RealignEm mappers per
read type, batch them through ``blastn -outfmt "7 qseqid sseqid
sscinames stitle" -db nt`` when the binary and database are available,
then report species hit counts, a FASTA of reads with no hits anywhere,
per-readType count summaries and a bar plot.  Without blastn (hermetic
environments) every read is reported in the no-hit set and the counts
still emit, so downstream consumers keep working.

Usage: python -m nanopore_tpu_torch.scripts.blast_unmapped \\
          --working-dir <dir> --output-dir blast_combined/output
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
from collections import Counter, defaultdict
from itertools import product

from nanopore_tpu_torch.io.sam import SamReader
from nanopore_tpu_torch.io.seqio import fastq_read

READ_TYPES = ["2D", "template", "complement"]
COMBINED_ANALYSES = [
    "LastzParamsRealignEm",
    "LastParamsRealignEm",
    "BwaParamsRealignEm",
    "BlasrParamsRealignEm",
]
BLAST_CMD = 'blastn -outfmt "7 qseqid sseqid sscinames stitle" -db nt'


def parse_blast(handle):
    """Yield (query, result|None) from blast outfmt 7 output
    (blast_combined.py:18-31)."""
    result = None
    query = None
    for line in handle:
        if "0 hits found" in line:
            yield (query, None)
        elif line.startswith("#") and "Query: " in line:
            query = line.split("Query: ")[-1].rstrip()
        elif result is None and not line.startswith("#"):
            result = line.strip().split("\t")[-3:]
            yield (query, result)
        elif result is not None and line.startswith("#"):
            result = None


def collect_unmapped(working_dir, read_types=READ_TYPES,
                     analyses=COMBINED_ANALYSES):
    output_root = os.path.join(working_dir, "output")
    fastq_root = os.path.join(output_root, "processedReadFastqFiles")
    ref_dir = os.path.join(working_dir, "referenceFastaFiles")
    reference_names = [
        x for x in os.listdir(ref_dir)
        if x.endswith(".fa") or x.endswith(".fasta")
    ]
    mapped = defaultdict(set)
    unmapped = defaultdict(dict)
    for read_type in read_types:
        type_dir = os.path.join(fastq_root, read_type)
        if not os.path.isdir(type_dir):
            continue
        fastqs = [
            os.path.join(type_dir, x)
            for x in os.listdir(type_dir)
            if x.endswith(".fq") or x.endswith(".fastq")
        ]
        for fastq, ref_name, analysis in product(
            fastqs, reference_names, analyses
        ):
            sam = os.path.join(
                output_root,
                "analysis_" + read_type,
                "experiment_%s_%s_%s"
                % (os.path.basename(fastq), ref_name, analysis),
                "mapping.sam",
            )
            if not os.path.exists(sam):
                continue
            for rec in SamReader(sam).mapped():
                mapped[read_type].add((rec.qname, os.path.basename(fastq)))
        for fastq in fastqs:
            for header, seq, _ in fastq_read(fastq):
                name = header.split()[0]
                key = (name, os.path.basename(fastq))
                if key not in mapped[read_type]:
                    unmapped[read_type][key] = seq
    return mapped, unmapped


def run(working_dir, output_dir, batch_size=100):
    os.makedirs(output_dir, exist_ok=True)
    mapped, unmapped = collect_unmapped(working_dir)
    have_blast = shutil.which("blastn") is not None

    for read_type in READ_TYPES:
        blast_out_path = os.path.join(
            output_dir, read_type + "_blast_out.txt"
        )
        entries = list(unmapped[read_type].items())
        with open(blast_out_path, "w") as out:
            for s in range(0, len(entries), batch_size):
                sub = entries[s : s + batch_size]
                query = "".join(
                    ">%s\n%s\n" % (name, seq) for (name, _), seq in sub
                )
                if have_blast and sub:
                    proc = subprocess.run(
                        BLAST_CMD, shell=True, input=query, text=True,
                        capture_output=True,
                    )
                    out.write(proc.stdout)
                else:
                    for (name, _), _seq in sub:
                        out.write(
                            "# Query: %s\n# 0 hits found\n" % name
                        )

        blast_hits: Counter = Counter()
        no_hits: set = set()
        for query, result in parse_blast(open(blast_out_path)):
            if result is None:
                no_hits.add(query)
            else:
                blast_hits[tuple(result)] += 1

        with open(
            os.path.join(output_dir, read_type + "_no_hits.fasta"), "w"
        ) as fh:
            for (name, _fastq), seq in unmapped[read_type].items():
                if name in no_hits:
                    fh.write(">%s\n%s\n" % (name, seq))

        with open(
            os.path.join(output_dir, read_type + "_blast_report.txt"), "w"
        ) as fh:
            fh.write("gi|##|gb|##|\tSpecies\tseqID\tCount\n")
            for result, count in sorted(
                blast_hits.items(), key=lambda kv: -kv[1]
            ):
                fh.write("%s\t%d\n" % ("\t".join(result), count))

        blast_count = sum(blast_hits.values())
        unmapped_count = len(unmapped[read_type]) - blast_count
        mapped_count = len(mapped[read_type])
        with open(
            os.path.join(output_dir, read_type + "percents.txt"), "w"
        ) as fh:
            fh.write(
                "\n".join(map(str, [blast_count, unmapped_count, mapped_count]))
            )
        _barplot(
            blast_count, unmapped_count, mapped_count, read_type,
            os.path.join(output_dir, read_type + "_blast_barplot.pdf"),
        )


def _barplot(blast_count, unmapped_count, mapped_count, read_type, path):
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(5, 4))
        ax.bar(
            ["BLAST hit", "no hit", "mapped"],
            [blast_count, unmapped_count, mapped_count],
            color=["#b63b3b", "#888888", "#3b6fb6"],
        )
        ax.set_ylabel("reads")
        ax.set_title(read_type)
        fig.tight_layout()
        fig.savefig(path)
        plt.close(fig)
    except Exception:
        pass


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--working-dir", default="..")
    parser.add_argument("--output-dir", default="blast_combined/output")
    args = parser.parse_args(argv)
    run(args.working_dir, args.output_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
