"""Per-channel mappability analysis.

Reproduces the reference ChannelMappability
(reference nanopore/analyses/channelMappability.py): parse
``channel_<c>_read_<r>`` names, count total vs mapped reads per channel
over at least 512 channels, write the TSV and four plots.  A copy of
the JAX package's ``analyses/channel.py``.
"""

from __future__ import annotations

import re
from collections import Counter

from nanopore_tpu_torch.analyses.base import Analysis
from nanopore_tpu_torch.analyses.common import ExperimentData

_NAME_RE = re.compile(r"channel_[0-9]+_read_[0-9]+")


class ChannelMappability(Analysis):
    def run(self) -> None:
        data = ExperimentData(
            self.read_fastq_file, self.reference_fasta_file, self.sam_file
        )
        per_channel = Counter(
            int(name.split("_")[1])
            for name in data.read_seqs
            if _NAME_RE.match(name)
        )
        mapped = Counter(
            int(rec.qname.split("_")[1])
            for rec in data.records
            if _NAME_RE.match(rec.qname)
        )
        if not per_channel or not mapped:
            return
        out_tsv = self.out("channel_mappability.tsv")
        max_channel = max(513, max(per_channel.keys()))
        with open(out_tsv, "w") as fh:
            fh.write("Channel\tReadCount\tMappableReadCount\n")
            for channel in range(1, max_channel):
                fh.write(
                    "%d\t%d\t%d\n"
                    % (channel, per_channel[channel], mapped[channel])
                )
        from nanopore_tpu_torch.analyses import plots

        plots.channel_plots(
            out_tsv,
            self.out("channel_mappability.pdf"),
            self.out("channel_mappability_sorted.png"),
            self.out("mappability_levelplot.png"),
            self.out("mappability_leveplot_percent.png"),
        )
