"""Per-experiment analyses (reference ``nanopore/analyses/``).

The ported ones so far: the two posterior analyses.  The registry of
the JAX package's ``analyses/__init__.py`` comes with the pipeline
(ROADMAP A7).
"""

from nanopore_tpu_torch.analyses.base import Analysis
from nanopore_tpu_torch.analyses.alignment_uncertainty import (
    AlignmentUncertainty,
)
from nanopore_tpu_torch.analyses.snp_caller import MarginAlignSnpCaller

__all__ = ["Analysis", "AlignmentUncertainty", "MarginAlignSnpCaller"]
