"""Cross-experiment meta-analyses (reference ``nanopore/metaAnalyses/``).

``ALL_META_ANALYSES`` holds the JAX package's eight names and classes:
the pipeline's five defaults, ``CoverageDepth``,
``MarginAlignMetaAnalysis`` and ``CustomTrackAssemblyHub``.
"""

from nanopore_tpu_torch.meta.base import (
    MetaAnalysis,
    UnmappedMetaAnalysis,
    Read,
)
from nanopore_tpu_torch.meta.coverage_summary import CoverageSummary
from nanopore_tpu_torch.meta.unmapped import (
    UnmappedKmerAnalysis,
    UnmappedLengthDistributionAnalysis,
    ComparePerReadMappabilityByMapper,
)
from nanopore_tpu_torch.meta.hmm_meta import HmmMetaAnalysis
from nanopore_tpu_torch.meta.coverage_depth import CoverageDepth
from nanopore_tpu_torch.meta.margin_align_meta import MarginAlignMetaAnalysis
from nanopore_tpu_torch.meta.assembly_hub import CustomTrackAssemblyHub

ALL_META_ANALYSES = {
    cls.__name__: cls
    for cls in [
        CoverageSummary,
        UnmappedKmerAnalysis,
        UnmappedLengthDistributionAnalysis,
        ComparePerReadMappabilityByMapper,
        HmmMetaAnalysis,
        CoverageDepth,
        MarginAlignMetaAnalysis,
        CustomTrackAssemblyHub,
    ]
}

__all__ = [
    "ALL_META_ANALYSES", "MetaAnalysis", "Read",
    "UnmappedMetaAnalysis",
] + list(ALL_META_ANALYSES)
