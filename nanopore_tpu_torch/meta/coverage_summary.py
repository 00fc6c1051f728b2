"""CoverageSummary meta-analysis.

A copy of the JAX package's ``meta/coverage_summary.py``.  Reproduces
the reference's nanopore/metaAnalyses/coverageSummary.py:
collate every experiment's coverage_bestPerRead.xml into CSVs grouped
(1) by base-mapper x readType x reference, (2) by base-mapper x read
file, (3) by reference — with the reference's duplicate-rowname
resolution — plus identity-distribution CSVs and summary plots.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from itertools import product

from nanopore_tpu_torch.meta.base import MetaAnalysis, base_mapper_name


@dataclass
class Entry:
    read_type: str
    read_fastq_file: str
    reference_fasta_file: str
    mapper: str
    xml: ET.Element

    @property
    def base_mapper(self) -> str:
        return base_mapper_name(self.mapper)


class CoverageSummary(MetaAnalysis):
    def build_db(self) -> list[Entry]:
        db = []
        for (fastq, read_type) in self.read_fastq_files:
            for ref in self.reference_fasta_files:
                for mapper in self.mappers:
                    results_dir = self.experiment_hash[
                        ((fastq, read_type), ref, mapper)
                    ]
                    path = os.path.join(
                        results_dir,
                        "analysis_GlobalCoverage",
                        "coverage_bestPerRead.xml",
                    )
                    if os.path.exists(path):
                        db.append(
                            Entry(
                                read_type,
                                os.path.basename(fastq),
                                os.path.basename(ref),
                                mapper,
                                ET.parse(path).getroot(),
                            )
                        )
        return db

    @staticmethod
    def resolve_duplicate_rownames(entries, multiple_read_types=False):
        """coverageSummary.py:84-117 semantics."""
        def label(e):
            return (
                e.mapper + "_" + e.read_type
                if multiple_read_types
                else e.mapper
            )

        names, count, start = [], 0, True
        last = label(entries[0]) if entries else None
        for e in entries:
            if label(e) == last:
                count += 1
                if not start:
                    names.append(label(e) + "." + str(count))
                else:
                    names.append(label(e))
                    start = False
            else:
                names.append(label(e))
                count = 1
            last = label(e)
        return names

    def write_file_analyze(self, entries, name, multiple_read_types=False):
        if not entries:
            return
        path = self.out(name + ".csv")
        entries = sorted(
            entries, key=lambda e: (e.mapper, e.read_type, e.read_fastq_file)
        )
        names = self.resolve_duplicate_rownames(entries, multiple_read_types)
        with open(path, "w") as fh:
            fh.write(
                ",".join(
                    [
                        "Name", "Mapper", "ReadType", "ReadFile",
                        "ReferenceFile", "AvgReadCoverage",
                        "AvgReferenceCoverage", "AvgIdentity",
                        "AvgMismatchesPerReadBase",
                        "AvgDeletionsPerReadBase",
                        "AvgInsertionsPerReadBase", "NumberOfMappedReads",
                        "NumberOfUnmappedReads", "NumberOfReads",
                    ]
                )
                + "\n"
            )
            for entry, n in zip(entries, names):
                a = entry.xml.attrib
                fh.write(
                    ",".join(
                        [
                            n, entry.mapper, entry.read_type,
                            entry.read_fastq_file, entry.reference_fasta_file,
                            a["avgreadCoverage"], a["avgreferenceCoverage"],
                            a["avgidentity"], a["avgmismatchesPerReadBase"],
                            a["avgdeletionsPerReadBase"],
                            a["avginsertionsPerReadBase"],
                            a["numberOfMappedReads"],
                            a["numberOfUnmappedReads"], a["numberOfReads"],
                        ]
                    )
                    + "\n"
                )
        dist_path = self.out(name + "_distribution.csv")
        with open(dist_path, "w") as fh:
            for entry, n in zip(entries, names):
                fh.write(
                    ",".join(
                        [n] + entry.xml.attrib["distributionidentity"].split()
                    )
                    + "\n"
                )
        self._plots(path, dist_path, name)

    def _plots(self, csv_path, dist_path, name):
        if not _HAVE_MPL:
            return
        try:
            import numpy as np

            rows = []
            with open(csv_path) as fh:
                header = fh.readline().strip().split(",")
                for line in fh:
                    rows.append(line.strip().split(","))
            if not rows:
                return
            idx = header.index("AvgIdentity")
            labels = [r[0] for r in rows]
            vals = [float(r[idx]) if r[idx] != "nan" else 0.0 for r in rows]
            fig, ax = plt.subplots(figsize=(max(6, len(labels)), 4))
            ax.bar(range(len(labels)), vals, color="#3b6fb6")
            ax.set_xticks(range(len(labels)), labels, rotation=45,
                          ha="right", fontsize=7)
            ax.set_ylabel("avg identity")
            ax.set_title(name)
            fig.tight_layout()
            fig.savefig(self.out(name + "_summary_plots.pdf"))
            plt.close(fig)

            fig, ax = plt.subplots(figsize=(max(6, len(labels)), 4))
            data, used = [], []
            with open(dist_path) as fh:
                for line in fh:
                    parts = line.strip().split(",")
                    vals = [
                        float(x) for x in parts[1:]
                        if x not in ("nan", "")
                    ]
                    if vals:
                        data.append(vals)
                        used.append(parts[0])
            if data:
                ax.boxplot(data, labels=used)
                ax.tick_params(axis="x", rotation=45, labelsize=7)
                ax.set_ylabel("identity")
                fig.tight_layout()
                fig.savefig(self.out(name + "_distribution.pdf"))
            plt.close(fig)
        except Exception:
            pass

    def run(self) -> None:
        self.db = self.build_db()
        ref_names = [os.path.basename(x) for x in self.reference_fasta_files]
        # by base-mapper x readType x reference (coverageSummary.py:36-42)
        groups = {
            key: []
            for key in product(self.base_mappers, self.read_types, ref_names)
        }
        for e in self.db:
            groups[(e.base_mapper, e.read_type, e.reference_fasta_file)].append(e)
        for (bm, rt, ref), entries in groups.items():
            self.write_file_analyze(entries, "_".join([bm, rt, ref]))
        # by base-mapper x read file (coverageSummary.py:44-50)
        fq_names = [os.path.basename(x[0]) for x in self.read_fastq_files]
        groups = {key: [] for key in product(self.base_mappers, fq_names)}
        for e in self.db:
            groups[(e.base_mapper, e.read_fastq_file)].append(e)
        for (bm, fq), entries in groups.items():
            self.write_file_analyze(entries, "_".join([bm, fq]))
        # by reference (coverageSummary.py:52-57)
        groups = {name: [] for name in ref_names}
        for e in self.db:
            groups[e.reference_fasta_file].append(e)
        for ref, entries in groups.items():
            self.write_file_analyze(entries, ref, multiple_read_types=True)


try:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    _HAVE_MPL = True
except Exception:  # pragma: no cover
    _HAVE_MPL = False
