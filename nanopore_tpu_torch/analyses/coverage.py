"""Coverage / identity analysis (local + global variants).

Reproduces the reference LocalCoverage / GlobalCoverage
(reference nanopore/analyses/coverage.py): per-alignment counters
-> coverage_all.xml / coverage_bestPerRead.xml with full distributions,
plus the line-per-statistic .txt files and distribution plots.  The
per-aligned-pair loop is replaced by the vectorised counters of
analyses.stats_core.  A copy of the JAX package's ``analyses/coverage.py``.
"""

from __future__ import annotations

import numpy as np
import xml.etree.ElementTree as ET

from nanopore_tpu_torch.analyses.base import Analysis
from nanopore_tpu_torch.analyses.common import ExperimentData
from nanopore_tpu_torch.analyses.stats_core import CoverageView
from nanopore_tpu_torch.io.xmlio import pretty_xml

_METRICS = (
    "readCoverage",
    "referenceCoverage",
    "identity",
    "mismatchesPerReadBase",
    "deletionsPerReadBase",
    "insertionsPerReadBase",
    "readLength",
)


def coverage_xml(view: CoverageView) -> ET.Element:
    """readAlignmentCoverage node (coverage.py:87-95)."""
    c = view.counts
    return ET.Element(
        "readAlignmentCoverage",
        {
            "refSeqName": c.rname,
            "readSeqName": c.qname,
            "readLength": str(view.readLength()),
            "readCoverage": str(view.readCoverage()),
            "referenceCoverage": str(view.referenceCoverage()),
            "identity": str(view.identity()),
            "mismatchesPerReadBase": str(view.mismatchesPerReadBase()),
            "insertionsPerReadBase": str(view.insertionsPerReadBase()),
            "deletionsPerReadBase": str(view.deletionsPerReadBase()),
        },
    )


def aggregate_coverage_xml(
    views: list[CoverageView],
    tag_name: str,
    ref_seqs: dict[str, str],
    read_seqs: dict[str, str],
    reads_to_views: dict[str, list[CoverageView]],
    typeof: str,
) -> ET.Element:
    """getAggregateCoverageStats schema (coverage.py:97-125)."""
    if typeof == "coverage_all":
        mapped_read_lengths = [
            len(read_seqs[name])
            for name in read_seqs
            if name in reads_to_views
            for _ in reads_to_views[name]
        ]
    else:
        mapped_read_lengths = [
            len(read_seqs[name]) for name in read_seqs if name in reads_to_views
        ]
    unmapped_read_lengths = [
        len(read_seqs[name])
        for name in read_seqs
        if name not in reads_to_views
    ]

    attribs = {
        "numberOfReadAlignments": str(len(views)),
        "numberOfReads": str(len(read_seqs)),
        "numberOfReferenceSequences": str(len(ref_seqs)),
        "numberOfMappedReads": str(len(mapped_read_lengths)),
        "mappedReadLengths": " ".join(map(str, mapped_read_lengths)),
        "numberOfUnmappedReads": str(len(unmapped_read_lengths)),
        "unmappedReadLengths": " ".join(map(str, unmapped_read_lengths)),
    }
    for metric in _METRICS:
        values = [getattr(v, metric)() for v in views]
        ordered = sorted(values)
        attribs["min" + metric] = str(ordered[0])
        attribs["avg" + metric] = str(float(np.average(ordered)))
        attribs["median" + metric] = str(float(np.median(ordered)))
        attribs["max" + metric] = str(ordered[-1])
        # distribution keeps the ORIGINAL record order (coverage.py:110)
        attribs["distribution" + metric] = " ".join(map(str, values))

    parent = ET.Element(tag_name, attribs)
    for view in views:
        parent.append(coverage_xml(view))
    return parent


class LocalCoverage(Analysis):
    global_mode = False

    def run(self) -> None:
        data = ExperimentData(
            self.read_fastq_file, self.reference_fasta_file, self.sam_file
        )
        reads_to_views: dict[str, list[CoverageView]] = {}
        for c in data.all_counts:
            view = CoverageView(c, self.global_mode)
            reads_to_views.setdefault(c.qname, []).append(view)
        if not reads_to_views:
            return

        all_views = [v for vs in reads_to_views.values() for v in vs]
        best_views = [
            max(vs, key=lambda v: v.readCoverage())
            for vs in reads_to_views.values()
        ]
        for views, name in (
            (all_views, "coverage_all"),
            (best_views, "coverage_bestPerRead"),
        ):
            parent = aggregate_coverage_xml(
                views, name, data.ref_seqs, data.read_seqs, reads_to_views, name
            )
            with open(self.out(name + ".xml"), "w") as fh:
                fh.write(pretty_xml(parent))
            # line-per-statistic text file (coverage.py:149-158)
            with open(self.out(name + ".txt"), "w") as fh:
                fh.write("MappedReadLengths " + parent.get("mappedReadLengths") + "\n")
                fh.write("UnmappedReadLengths " + parent.get("unmappedReadLengths") + "\n")
                fh.write("ReadCoverage " + parent.get("distributionreadCoverage") + "\n")
                fh.write("MismatchesPerReadBase " + parent.get("distributionmismatchesPerReadBase") + "\n")
                fh.write("ReadIdentity " + parent.get("distributionidentity") + "\n")
                fh.write("InsertionsPerBase " + parent.get("distributioninsertionsPerReadBase") + "\n")
                fh.write("DeletionsPerBase " + parent.get("distributiondeletionsPerReadBase") + "\n")
            from nanopore_tpu_torch.analyses import plots

            plots.coverage_plot(self.out(name + ".txt"), self.out(name + ".pdf"))


class GlobalCoverage(LocalCoverage):
    """Counts trailing/leading indels (coverage.py:162-166)."""

    global_mode = True
