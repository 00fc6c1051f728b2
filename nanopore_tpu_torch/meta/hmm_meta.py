"""HMM meta-analysis: aggregate per-experiment trained models.

A copy of the JAX package's ``meta/hmm_meta.py``.  Reproduces the
reference's nanopore/metaAnalyses/hmmMetaAnalysis.py:
per readType, average the hmm.txt.xml transition expectations into a dot
graph and write normalised / unnormalised / std-error substitution
matrices with their plots.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from itertools import product

import numpy as np

from nanopore_tpu_torch.meta.base import MetaAnalysis

_STATE_LABELS = {
    0: "match",
    1: "short delete",
    2: "short insert",
    3: "long insert",
    4: "long delete",
}

_BASES = "ACGT"


class HmmMetaAnalysis(MetaAnalysis):
    def run(self) -> None:
        for read_type in self.read_types:
            transitions: dict[tuple[str, str], list] = {}
            subst: dict[tuple[str, str], list] = {
                key: [] for key in product(_BASES, _BASES)
            }
            for ref in self.reference_fasta_files:
                for fastq, ft in self.read_fastq_files:
                    if ft != read_type:
                        continue
                    for mapper in self.mappers:
                        results_dir = self.experiment_hash[
                            ((fastq, read_type), ref, mapper)
                        ]
                        path = os.path.join(results_dir, "hmm.txt.xml")
                        if not os.path.exists(path):
                            continue
                        root = ET.parse(path).getroot()
                        for tr in root.findall("transition"):
                            if float(tr.attrib["avg"]) > 0.0:
                                key = (tr.attrib["from"], tr.attrib["to"])
                                transitions.setdefault(key, []).append(
                                    (
                                        float(tr.attrib["avg"]),
                                        float(tr.attrib["std"]),
                                    )
                                )
                        for em in root.findall("emission"):
                            if em.attrib["state"] == "0":
                                subst[
                                    (em.attrib["x"], em.attrib["y"])
                                ].append(
                                    (
                                        float(em.attrib["avg"]),
                                        float(em.attrib["std"]),
                                    )
                                )

            if not transitions:
                continue

            # dot graph of averaged transitions (hmmMetaAnalysis.py:52-73)
            with open(self.out("hmm_%s.dot" % read_type), "w") as fh:
                fh.write("graph G {\noverlap=false\n")
                for state, label in _STATE_LABELS.items():
                    fh.write(
                        'n%dn [label="%s", fontsize=14, shape=circle];\n'
                        % (state, label)
                    )
                for (src, dst), vals in transitions.items():
                    avgs = [v[0] for v in vals]
                    fh.write(
                        'n%sn -- n%sn [dir=arrow, label="%.3f,%.3f"];\n'
                        % (src, dst, float(np.average(avgs)),
                           float(np.std(avgs)))
                    )
                fh.write("}\n")

            # substitution matrices (hmmMetaAnalysis.py:75-105)
            def write_matrix(fname, value_fn):
                path = self.out(fname % read_type)
                with open(path, "w") as fh:
                    fh.write("\t".join(_BASES) + "\n")
                    for x in _BASES:
                        fh.write(
                            "\t".join(
                                [x] + [str(value_fn(x, y)) for y in _BASES]
                            )
                            + "\n"
                        )
                return path

            def avg0(x, y):
                vals = subst[(x, y)]
                return float(np.average(vals[0][0])) if vals else 0.0

            def std0(x, y):
                vals = subst[(x, y)]
                return float(np.average(vals[0][1])) if vals else 0.0

            from nanopore_tpu_torch.analyses import plots

            p = write_matrix(
                "matchEmissionsNormalisedByReference_%s.tsv",
                lambda x, y: avg0(x, y)
                / max(sum(avg0(x, yy) for yy in _BASES), 1e-30),
            )
            plots.substitution_plot(
                p,
                self.out(
                    "substitutionPlotNormalisedByReference_%s.pdf" % read_type
                ),
                "Avg. of ML substitution rates given the reference base",
            )
            p = write_matrix("matchEmissionsUnnormalised_%s.tsv", avg0)
            plots.substitution_plot(
                p,
                self.out("substitutionPlotUnnormalised_%s.pdf" % read_type),
                "Avg. ML substitution estimates",
            )
            p = write_matrix(
                "matchEmissionsUnnormalisedStdErrors_%s.tsv", std0
            )
            plots.substitution_plot(
                p,
                self.out(
                    "substitutionPlotUnnormalisedStdErrors_%s.pdf" % read_type
                ),
                "Avg. ML substitution estimates",
            )
