"""Substitution matrix analysis.

Reproduces the reference Substitutions analysis
(reference nanopore/analyses/substitutions.py): a 5x5 (ACGT+N)
count matrix over every aligned pair, written as substitutions.xml +
subst.tsv + a heatmap plot.  The per-pair Python loop becomes one
bincount on the analysis's device (ops.reductions.substitution_counts).
A copy of the JAX package's ``analyses/substitutions.py``.
"""

from __future__ import annotations

import numpy as np
import torch
import xml.etree.ElementTree as ET

from nanopore_tpu_torch.analyses.base import Analysis
from nanopore_tpu_torch.analyses.common import ExperimentData
from nanopore_tpu_torch.device import resolve_device
from nanopore_tpu_torch.io.xmlio import pretty_xml
from nanopore_tpu_torch.ops.reductions import substitution_counts

_ORDER = "ACGT"
_XML_BASES = "ACGTN"
_IDX = {b: i for i, b in enumerate("ACGTN")}


def substitution_matrix_xml(matrix: np.ndarray) -> ET.Element:
    """XML schema of SubstitutionMatrix.getXML (substitutions.py:33-49)."""

    def identity(matches, mismatches):
        if matches + mismatches == 0:
            return "NaN"
        return str(matches / (mismatches + matches))

    def count(ref_base, read_base):
        return matrix[_IDX[ref_base], _IDX[read_base]]

    matches = sum(count(b, b) for b in "ACTG")
    mismatches = sum(
        count(rb, qb) for rb in "ACTG" for qb in "ACTG" if qb != rb
    )
    node = ET.Element(
        "substitutions",
        {
            "matches": str(matches),
            "mismatches": str(mismatches),
            "identity": identity(matches, mismatches),
        },
    )
    for ref_base in _XML_BASES:
        b_matches = count(ref_base, ref_base)
        b_mismatches = sum(
            count(ref_base, qb) for qb in "ACTG" if qb != ref_base
        )
        base_node = ET.SubElement(
            node,
            ref_base,
            {
                "matches": str(b_matches),
                "mismatches": str(b_mismatches),
                "identity": identity(b_matches, b_mismatches),
            },
        )
        for read_base in _XML_BASES:
            ET.SubElement(
                base_node, read_base, {"count": str(count(ref_base, read_base))}
            )
    return node


def substitution_freqs(matrix: np.ndarray, ref_base: str) -> list[float]:
    """Row of relative frequencies over ACGT (substitutions.py:22-31)."""
    row = [matrix[_IDX[ref_base], _IDX[b]] for b in _ORDER]
    total = sum(row)
    if total == 0:
        return [0.0] * len(row)
    return [x / total for x in row]


class Substitutions(Analysis):
    def run(self) -> None:
        data = ExperimentData(
            self.read_fastq_file, self.reference_fasta_file, self.sam_file
        )
        ref_concat = []
        read_concat = []
        for c in data.all_counts:
            ref_concat.append(c.pair_ref_codes)
            read_concat.append(c.pair_read_codes)
        if ref_concat:
            dev = resolve_device(self.device)
            counts = substitution_counts(
                torch.as_tensor(np.concatenate(ref_concat), device=dev),
                torch.as_tensor(np.concatenate(read_concat), device=dev),
            )
            matrix = counts.cpu().numpy().astype(np.float64)
        else:
            matrix = np.zeros((5, 5))

        with open(self.out("substitutions.xml"), "w") as fh:
            fh.write(pretty_xml(substitution_matrix_xml(matrix)))

        with open(self.out("subst.tsv"), "w") as fh:
            fh.write("A\tC\tG\tT\n")
            for base in _ORDER:
                freqs = substitution_freqs(matrix, base)
                fh.write("%s\t%s\n" % (base, "\t".join(map(str, freqs))))

        from nanopore_tpu_torch.analyses import plots

        title = (
            self.output_dir.rstrip("/").split("/")[-2].split("_")[-1]
            + "_Substitution_Levels"
            if "/" in self.output_dir
            else "Substitution_Levels"
        )
        plots.substitution_plot(
            self.out("subst.tsv"), self.out("substitution_plot.pdf"), title
        )
