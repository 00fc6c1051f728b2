"""MarginAlign meta-analysis: collate SNP-caller results across runs.

A copy of the JAX package's ``meta/margin_align_meta.py``.

Reproduces the reference's nanopore/metaAnalyses/marginAlignMetaAnalysis.py:
gather every experiment's marginaliseConsensus.xml, bucket by (readType,
mapper, caller tag, held-out proportion, reference), drop coverage 10,
rename >1000 to "ALL", quantise the held-out proportion into
{0.01, 0.05, 0.1, 0.2}, then emit min/median/max tables, the "squares"
table, and averaged ROC-curve TSVs with grid plots.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from itertools import product

import numpy as np

from nanopore_tpu_torch.meta.base import MetaAnalysis


def _quantise_held_out(p: float) -> float | None:
    if p == 0:
        return None
    if p < 0.04:
        return 0.01
    if p < 0.09:
        return 0.05
    if p < 0.18:
        return 0.1
    return 0.2


class MarginAlignMetaAnalysis(MetaAnalysis):
    def run(self) -> None:
        coverage_levels: set = set()
        buckets: dict[tuple, dict] = {}
        algorithms: set[str] = set()
        proportions: set[float] = set()

        for ref in self.reference_fasta_files:
            for read_type in self.read_types:
                for fastq, ft in self.read_fastq_files:
                    if ft != read_type:
                        continue
                    for mapper in self.mappers:
                        results_dir = self.experiment_hash[
                            ((fastq, read_type), ref, mapper)
                        ]
                        path = os.path.join(
                            results_dir,
                            "analysis_MarginAlignSnpCaller",
                            "marginaliseConsensus.xml",
                        )
                        if not os.path.exists(path):
                            continue
                        node = ET.parse(path).getroot()
                        for c in node:
                            coverage = int(c.attrib["coverage"])
                            if coverage == 10:
                                continue  # dead coverage plot (:29-30)
                            cov_key = "ALL" if coverage > 1000 else coverage
                            held = float(c.attrib["totalHeldOut"])
                            non_held = float(c.attrib["totalNonHeldOut"])
                            prop = _quantise_held_out(
                                held / (held + non_held)
                                if held + non_held
                                else 0.0
                            )
                            if prop is None:
                                continue
                            coverage_levels.add(cov_key)
                            algorithms.add(c.tag)
                            proportions.add(prop)
                            key = (read_type, mapper, c.tag, prop, ref)
                            buckets.setdefault(key, {}).setdefault(
                                cov_key, []
                            ).append(c)

        coverage_levels = sorted(coverage_levels, key=str)

        recall = lambda c: float(c.attrib["recall"])
        precision = lambda c: float(c.attrib["precision"])

        def f_score(c):
            p, r = precision(c), recall(c)
            return 2 * p * r / (p + r) if p + r > 0 else 0.0

        def not_called(c):
            return float(c.attrib["totalNoCalls"]) / (
                float(c.attrib["totalHeldOut"])
                + float(c.attrib["totalNonHeldOut"])
            )

        actual_coverage = lambda c: float(c.attrib["actualCoverage"])

        roc_curves: dict[tuple, tuple] = {}
        with open(self.out("marginAlignAll.txt"), "w") as fh, open(
            self.out("marginAlignSquares.txt"), "w"
        ) as fh2:
            fh.write(
                "\t".join(
                    [
                        "readType", "mapper", "caller", "%heldOut",
                        "coverage", "fScoreMin", "fScoreMedian", "fScoreMax",
                        "recallMin", "recallMedian", "recallMax",
                        "precisionMin", "precisionMedian", "precisionMax",
                        "%notCalledMin", "%notCalledMedian", "%notCalledMax",
                        "actualCoverageMin", "actualCoverageMedian",
                        "actualCoverageMax",
                    ]
                )
                + "\n"
            )
            fh2.write(
                "\t".join(
                    ["readType", "mapper", "caller", "%heldOut"]
                    + [
                        "min_%s_coverage_%s\tavg_%s_coverage_%s\t"
                        "max_%s_coverage_%s" % (m, c, m, c, m, c)
                        for m in ("recall", "precision", "fscore")
                        for c in coverage_levels
                    ]
                )
                + "\n"
            )
            for key in sorted(buckets, key=str):
                read_type, mapper, algorithm, prop, ref = key
                nodes = buckets[key]

                def rng3(fn, cov):
                    vals = [fn(c) for c in nodes.get(cov, [])]
                    if not vals:
                        return (0.0, 0.0, 0.0)
                    return (min(vals), float(np.median(vals)), max(vals))

                for cov in coverage_levels:
                    if cov not in nodes:
                        continue
                    row = [read_type, mapper, algorithm, str(prop), str(cov)]
                    for fn in (f_score, recall, precision, not_called,
                               actual_coverage):
                        row.extend(str(v) for v in rng3(fn, cov))
                    fh.write("\t".join(row) + "\n")

                row2 = [read_type, mapper, algorithm, str(prop)]
                for fn in (recall, precision, f_score):
                    for cov in coverage_levels:
                        vals = [fn(c) for c in nodes.get(cov, [])]
                        if vals:
                            row2.extend(
                                [
                                    str(min(vals)),
                                    str(float(np.average(vals))),
                                    str(max(vals)),
                                ]
                            )
                        else:
                            row2.extend(["0", "0", "0"])
                fh2.write("\t".join(row2) + "\n")

                for cov in coverage_levels:
                    if cov not in nodes:
                        continue
                    recalls = np.array(
                        [
                            [float(x) for x in c.attrib[
                                "recallByProbability"].split()]
                            for c in nodes[cov]
                        ]
                    )
                    precisions = np.array(
                        [
                            [float(x) for x in c.attrib[
                                "precisionByProbability"].split()]
                            for c in nodes[cov]
                        ]
                    )
                    avg_r = recalls.mean(axis=0)
                    avg_p = precisions.mean(axis=0)
                    # trim trailing zero-recall points (:108-110)
                    end = len(avg_r)
                    while end > 0 and avg_r[end - 1] == 0.0:
                        end -= 1
                    roc_curves[
                        (read_type, mapper, algorithm, prop, cov)
                    ] = (avg_p[:end], avg_r[:end])

        # per (readType, mapper) ROC TSVs + grid plots (:121-134)
        for read_type, mapper in product(self.read_types, self.mappers):
            tsv = self.out(read_type + "_" + mapper + ".tsv")
            wrote = False
            with open(tsv, "w") as fh:
                for algorithm in sorted(algorithms):
                    for prop in sorted(proportions):
                        for cov in coverage_levels:
                            key = (read_type, mapper, algorithm, prop, cov)
                            if key not in roc_curves:
                                continue
                            avg_p, avg_r = roc_curves[key]
                            fh.write(
                                "FPR\t%s\t%s\t%s\t%s\nTPR\t%s\t%s\t%s\t%s\n"
                                % (
                                    algorithm, prop, cov,
                                    "\t".join(map(str, avg_p)),
                                    algorithm, prop, cov,
                                    "\t".join(map(str, avg_r)),
                                )
                            )
                            wrote = True
            if wrote:
                self._roc_plot(read_type, mapper, roc_curves,
                               sorted(algorithms), sorted(proportions),
                               coverage_levels)

    def _roc_plot(self, read_type, mapper, roc_curves, algorithms,
                  proportions, coverage_levels):
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            out_dir = self.out(read_type + "_" + mapper)
            os.makedirs(out_dir, exist_ok=True)
            rows = max(len(algorithms), 1)
            cols = max(len(proportions), 1)
            fig, axes = plt.subplots(
                rows, cols, figsize=(4 * cols, 3 * rows), squeeze=False
            )
            for i, algorithm in enumerate(algorithms):
                for j, prop in enumerate(proportions):
                    ax = axes[i][j]
                    for cov in coverage_levels:
                        key = (read_type, mapper, algorithm, prop, cov)
                        if key in roc_curves:
                            avg_p, avg_r = roc_curves[key]
                            ax.plot(avg_r, avg_p, label=str(cov), lw=1)
                    ax.set_xlabel("recall")
                    ax.set_ylabel("precision")
                    ax.set_title(
                        "%s @ %s" % (algorithm[:30], prop), fontsize=7
                    )
                    ax.legend(fontsize=6)
            fig.tight_layout()
            fig.savefig(os.path.join(out_dir, "_ROC_curves.pdf"))
            plt.close(fig)
        except Exception:
            pass
