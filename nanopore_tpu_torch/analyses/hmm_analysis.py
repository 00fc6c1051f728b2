"""HMM-inspection analysis: plots of a trained model's parameters.

Reproduces the reference Hmm analysis
(reference nanopore/analyses/hmm.py): read the ``hmm.txt.xml``
written next to mapping.sam by EM training, emit a graphviz dot of the
five-state machine, the match-emission matrix plot, insert/delete gap
emission plots and the EM convergence traces.  A copy of the JAX
package's ``analyses/hmm_analysis.py``.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

from nanopore_tpu_torch.analyses.base import Analysis

_STATE_LABELS = {
    0: "match",
    1: "short delete",
    2: "short insert",
    3: "long insert",
    4: "long delete",
}  # labels as the reference names them (analyses/hmm.py:24-28)


class Hmm(Analysis):
    def run(self) -> None:
        hmm_file = os.path.join(
            os.path.dirname(self.sam_file), "hmm.txt.xml"
        )
        if not os.path.exists(hmm_file):
            return
        root = ET.parse(hmm_file).getroot()

        # graphviz dot of transitions (analyses/hmm.py:21-40)
        with open(self.out("hmm.dot"), "w") as fh:
            fh.write("graph G {\n")
            fh.write("overlap=false\n")
            for state, label in _STATE_LABELS.items():
                fh.write(
                    'n%dn [label="%s", fontsize=14, shape=circle];\n'
                    % (state, label)
                )
            for tr in root.findall("transition"):
                if float(tr.attrib["avg"]) > 0.0:
                    fh.write(
                        'n%sn -- n%sn [dir=arrow, label="%.3f,%.3f"];\n'
                        % (
                            tr.attrib["from"],
                            tr.attrib["to"],
                            float(tr.attrib["avg"]),
                            float(tr.attrib["std"]),
                        )
                    )
            fh.write("}\n")

        # match emission matrix (analyses/hmm.py:42-53)
        emissions = {
            (e.attrib["x"], e.attrib["y"]): e.attrib["avg"]
            for e in root.findall("emission")
            if e.attrib["state"] == "0"
        }
        bases = "ACGT"
        match_tsv = self.out("matchEmissions.tsv")
        with open(match_tsv, "w") as fh:
            fh.write("\t".join(bases) + "\n")
            for x in bases:
                fh.write(
                    "\t".join([x] + [emissions[(x, y)] for y in bases]) + "\n"
                )
        from nanopore_tpu_torch.analyses import plots

        plots.substitution_plot(
            match_tsv,
            self.out("substitution_plot.pdf"),
            "Per-Base Substitutions after HMM",
        )

        # insert/delete gap emissions (analyses/hmm.py:62-78)
        insert_em = {b: 0.0 for b in bases}
        delete_em = {b: 0.0 for b in bases}
        for e in root.findall("emission"):
            if e.attrib["state"] == "2":
                insert_em[e.attrib["x"]] += float(e.attrib["avg"])
            elif e.attrib["state"] == "1":
                delete_em[e.attrib["y"]] += float(e.attrib["avg"])
        indel_tsv = self.out("indelEmissions.tsv")
        with open(indel_tsv, "w") as fh:
            fh.write("\t".join(bases) + "\n")
            fh.write("\t".join(str(insert_em[b]) for b in bases) + "\n")
            fh.write("\t".join(str(delete_em[b]) for b in bases) + "\n")
        plots.emissions_plot(indel_tsv, self.out("indelEmissions_plot.pdf"))

        # EM convergence (analyses/hmm.py:80-86)
        rl_tsv = self.out("runninglikelihoods.tsv")
        with open(rl_tsv, "w") as fh:
            for hmm_node in root.findall("hmm"):
                fh.write(
                    "\t".join(hmm_node.attrib["runningLikelihoods"].split())
                    + "\n"
                )
        plots.running_likelihood_plot(
            rl_tsv, self.out("running_likelihood.pdf")
        )
