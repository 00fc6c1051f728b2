"""Cross-experiment meta-analyses (reference ``nanopore/metaAnalyses/``).

``ALL_META_ANALYSES`` holds the JAX package's eight names.  Five are
ported: the pipeline's defaults.  ``CoverageDepth``,
``MarginAlignMetaAnalysis`` and ``CustomTrackAssemblyHub`` are not yet
(ROADMAP A7.5; the last reads BAM and 2bit files, A7.3): their classes
raise ``NotImplementedError``, and the pipeline refuses their names
before any task runs.
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


class NotPorted(MetaAnalysis):
    """A meta-analysis of the JAX package that the port lacks."""

    roadmap = "A7.5"

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(self.not_ported_message())

    @classmethod
    def not_ported_message(cls) -> str:
        return "meta-analysis %s is not ported yet: ROADMAP %s" % (
            cls.__name__, cls.roadmap,
        )


class CoverageDepth(NotPorted):
    pass


class MarginAlignMetaAnalysis(NotPorted):
    pass


class CustomTrackAssemblyHub(NotPorted):
    roadmap = "A7.5, after A7.3 (it reads BAM and 2bit files)"


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
    "ALL_META_ANALYSES", "MetaAnalysis", "NotPorted", "Read",
    "UnmappedMetaAnalysis",
] + list(ALL_META_ANALYSES)
