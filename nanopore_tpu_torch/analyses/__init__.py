"""Per-experiment analyses (reference ``nanopore/analyses/``).

The registry of the JAX package's ``analyses/__init__.py``: the
reference's enabled set (pipeline.py:81) plus the default-disabled
extras.  Every analysis takes a ``device`` (``None``: the card,
``"cpu"``: the plain path); those that compute only on the host
ignore it.
"""

from nanopore_tpu_torch.analyses.base import Analysis
from nanopore_tpu_torch.analyses.substitutions import Substitutions
from nanopore_tpu_torch.analyses.coverage import LocalCoverage, GlobalCoverage
from nanopore_tpu_torch.analyses.indels import Indels
from nanopore_tpu_torch.analyses.kmer import KmerAnalysis, IndelKmerAnalysis
from nanopore_tpu_torch.analyses.channel import ChannelMappability
from nanopore_tpu_torch.analyses.alignment_uncertainty import (
    AlignmentUncertainty,
)
from nanopore_tpu_torch.analyses.hmm_analysis import Hmm
from nanopore_tpu_torch.analyses.snp_caller import MarginAlignSnpCaller
from nanopore_tpu_torch.analyses.consensus import Consensus
from nanopore_tpu_torch.analyses.qc import FastQC, QualiMap

# default-enabled analyses (reference pipeline.py:81)
DEFAULT_ANALYSES = [
    Hmm,
    GlobalCoverage,
    LocalCoverage,
    Substitutions,
    Indels,
    AlignmentUncertainty,
    ChannelMappability,
    KmerAnalysis,
    IndelKmerAnalysis,
]

ALL_ANALYSES = {
    cls.__name__: cls
    for cls in [
        Hmm,
        GlobalCoverage,
        LocalCoverage,
        Substitutions,
        Indels,
        AlignmentUncertainty,
        ChannelMappability,
        KmerAnalysis,
        IndelKmerAnalysis,
        MarginAlignSnpCaller,
        Consensus,
        FastQC,
        QualiMap,
    ]
}

__all__ = ["Analysis", "ALL_ANALYSES", "DEFAULT_ANALYSES"] + list(ALL_ANALYSES)
