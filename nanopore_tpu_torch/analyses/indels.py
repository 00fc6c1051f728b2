"""Indel length-distribution analysis.

Reproduces the reference Indels analysis
(reference nanopore/analyses/indels.py): per-alignment insertion /
deletion length lists and match-block lengths, aggregated into indels.xml
and the transposed indels.tsv consumed by the plots.  A copy of the JAX
package's ``analyses/indels.py``.
"""

from __future__ import annotations

import numpy as np
import xml.etree.ElementTree as ET

from nanopore_tpu_torch.analyses.base import Analysis
from nanopore_tpu_torch.analyses.common import ExperimentData
from nanopore_tpu_torch.analyses.stats_core import AlignmentCounts
from nanopore_tpu_torch.io.xmlio import pretty_xml


def _stats_str(values) -> dict[str, str]:
    ordered = sorted(values)
    return {
        "min": str(ordered[0]),
        "avg": str(float(np.average(ordered))),
        "median": str(float(np.median(ordered))),
        "max": str(ordered[-1]),
        "distribution": " ".join(map(str, values)),
    }


def indel_counter_xml(c: AlignmentCounts) -> ET.Element:
    """Per-alignment node (indels.py:33-45)."""
    ins = c.interior_ins_lengths.tolist()
    dels = c.interior_del_lengths.tolist()
    return ET.Element(
        "indels",
        {
            "refSeqName": c.rname,
            "refSeqLength": str(c.ref_len),
            "readSeqName": c.qname,
            "readSeqLength": str(c.read_len),
            "numberReadInsertions": str(len(ins)),
            "numberReadDeletions": str(len(dels)),
            "avgReadInsertionLength": str(float(np.average(ins)) if ins else float("nan")),
            "avgReadDeletionLength": str(float(np.average(dels)) if dels else float("nan")),
            "medianReadInsertionLength": str(float(np.median(ins)) if ins else float("nan")),
            "medianReadDeletionLength": str(float(np.median(dels)) if dels else float("nan")),
            "readInsertionLengths": " ".join(map(str, ins)),
            "readDeletionLengths": " ".join(map(str, dels)),
        },
    )


def aggregate_indel_xml(all_counts: list[AlignmentCounts]) -> ET.Element:
    """getAggregateIndelStats schema (indels.py:47-82)."""
    ins_lengths = [
        int(v) for c in all_counts for v in c.interior_ins_lengths
    ]
    del_lengths = [
        int(v) for c in all_counts for v in c.interior_del_lengths
    ]
    attribs = {
        "numberOfReadAlignments": str(len(all_counts)),
        "readInsertionLengths": " ".join(map(str, ins_lengths)),
        "readDeletionLengths": " ".join(map(str, del_lengths)),
    }
    named = {
        "ReadSequenceLengths": [c.read_len for c in all_counts],
        "NumberReadInsertions": [
            len(c.interior_ins_lengths) for c in all_counts
        ],
        "NumberReadDeletions": [
            len(c.interior_del_lengths) for c in all_counts
        ],
        "MedianReadInsertionLengths": [
            float(np.median(c.interior_ins_lengths))
            if len(c.interior_ins_lengths)
            else float("nan")
            for c in all_counts
        ],
        "MedianReadDeletionLengths": [
            float(np.median(c.interior_del_lengths))
            if len(c.interior_del_lengths)
            else float("nan")
            for c in all_counts
        ],
    }
    # NOTE: the reference overwrites attribs[name] with the last stats()
    # value (the distribution string) — indels.py:76-77 assigns attribs
    # [name] inside the zip loop; we reproduce the final distribution
    # value, which is what the TSV consumer reads (indels.py:101-103).
    for name, values in named.items():
        attribs[name] = " ".join(map(str, values))

    parent = ET.Element("indels", attribs)
    for c in all_counts:
        parent.append(indel_counter_xml(c))
    return parent


class Indels(Analysis):
    def run(self) -> None:
        data = ExperimentData(
            self.read_fastq_file, self.reference_fasta_file, self.sam_file
        )
        all_counts = data.all_counts
        if not all_counts:
            return
        xml = aggregate_indel_xml(all_counts)
        with open(self.out("indels.xml"), "w") as fh:
            fh.write(pretty_xml(xml))
        # transposed TSV for the plots (indels.py:98-108)
        var = [
            "readInsertionLengths",
            "readDeletionLengths",
            "ReadSequenceLengths",
            "NumberReadInsertions",
            "NumberReadDeletions",
            "MedianReadInsertionLengths",
            "MedianReadDeletionLengths",
        ]
        columns = [[name] + xml.attrib[name].split() for name in var]
        depth = max(len(col) for col in columns)
        with open(self.out("indels.tsv"), "w") as fh:
            for row in range(depth):
                fh.write(
                    "\t".join(
                        str(col[row]) if row < len(col) else "None"
                        for col in columns
                    )
                    + "\n"
                )
        from nanopore_tpu_torch.analyses import plots

        plots.indel_plots(self.out("indels.tsv"), self.out("indel_plots.pdf"))
