"""Mapper-variant registry: the reference's ~50 mapper classes as presets.

A copy of ``nanopore_tpu/mapping/presets.py`` (host data).  This package
runs every preset, the Viterbi-decode family (``decode="viterbi"``: the
Viterbi kernel and its walker) included.

The reference enumerates 4 aligners x {stock, Params} x {plain, Chain,
Realign, RealignEm, RealignTrainedModel[20/40]} plus Combined variants as
~50 Python classes (imported at reference pipeline.py:12-20).  Here each
is a MapperSpec: one unified engine configuration (seeding/chaining
tunables standing in for the aligner's seeding behaviour) plus a
post-processing mode.  Experiment directory names therefore stay
compatible (``experiment_<fastq>_<fasta>_<MapperName>``).

Preset rationale (per aligner, from their invocation flags):
- Bwa / BwaParams: bwa mem [-x pacbio] (mappers/bwa.py:9-10,
  bwa_params.py:7) — moderate seeds; the pacbio preset shortens seeds.
- Last / LastParams: lastal [-s 2 -T 0 -Q 0 -a 1] (mappers/last.py:24-26,
  last_params.py:8) — adaptive seeding; Params = most sensitive preset.
- Lastz / LastzParams: --hspthresh=1800 --gap=100,100
  (mappers/lastz.py:11, lastzParams.py:11) — HSP threshold maps to the
  min chain score.
- Blasr / BlasrParams: -sdpTupleSize 8 -bestn 1 -m 0
  (mappers/blasr.py:10, blasr_params.py:7) — short sdp tuples, Params
  emits only the best alignment (best_n=1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from nanopore_tpu_torch.mapping.engine import MapperConfig


@dataclass(frozen=True)
class MapperSpec:
    name: str
    config: MapperConfig
    post: str = ""  # "", "chain", "realign", "realign_em", "realign_trained"
    trained_model: Optional[str] = None
    combined: bool = False
    gap_gamma: float = 0.5  # abstractMapper.py:25 defaults
    match_gamma: float = 0.0
    # band width for the realign/EM post-passes (the mapping extension
    # keeps MapperConfig.band_width=64: its guide is a coarse anchor
    # chain).  The reference's production realign band is 21 cells
    # (--diagonalExpansion=10, analyses/utils.py:587); W=32 covers it.
    band_width: int = 32

    @property
    def base_name(self) -> str:
        """Leading [A-Z][a-z]* token — the reference's baseMapper regex
        (metaAnalyses/abstractMetaAnalysis.py:32)."""
        import re

        m = re.match(r"[A-Z][a-z]*", self.name)
        return m.group(0) if m else self.name


_BASE_CONFIGS = {
    "Bwa": MapperConfig(k=15, max_occ=256, min_chain_score=25.0),
    "BwaParams": MapperConfig(k=13, max_occ=384, min_chain_score=20.0),
    "Last": MapperConfig(k=14, max_occ=256, min_chain_score=25.0),
    "LastParams": MapperConfig(k=12, max_occ=512, min_chain_score=18.0),
    "Lastz": MapperConfig(k=14, max_occ=256, min_chain_score=30.0),
    "LastzParams": MapperConfig(k=13, max_occ=384, min_chain_score=22.0),
    "Blasr": MapperConfig(k=13, max_occ=256, min_chain_score=25.0),
    "BlasrParams": MapperConfig(k=12, max_occ=512, min_chain_score=20.0,
                                best_n=1),
}

_POSTS = {
    "": "",
    "Chain": "chain",
    "Realign": "realign",
    "RealignEm": "realign_em",
    "RealignTrainedModel": "realign_trained",
}


def _build_registry() -> dict[str, MapperSpec]:
    registry: dict[str, MapperSpec] = {}
    for base, config in _BASE_CONFIGS.items():
        for suffix, post in _POSTS.items():
            name = base + suffix
            trained = "blasr_hmm_0.txt" if post == "realign_trained" else None
            registry[name] = MapperSpec(
                name=name, config=config, post=post, trained_model=trained
            )
    # TrainedModel20/40 variants exist for LastParams and BlasrParams
    # (reference pipeline.py:18-19)
    for base in ("LastParams", "BlasrParams"):
        for pct in (20, 40):
            name = "%sRealignTrainedModel%d" % (base, pct)
            registry[name] = MapperSpec(
                name=name,
                config=_BASE_CONFIGS[base],
                post="realign_trained",
                trained_model="blasr_hmm_%d.txt" % pct,
            )
    # Viterbi family (no reference analogue by name): the single-pass
    # max-product extension standing in for the reference aligners' own
    # non-probabilistic extension DP.
    from dataclasses import replace as _replace

    viterbi_cfg = _replace(_BASE_CONFIGS["LastParams"], decode="viterbi")
    for suffix, post in _POSTS.items():
        name = "Viterbi" + suffix
        trained = "blasr_hmm_0.txt" if post == "realign_trained" else None
        registry[name] = MapperSpec(
            name=name, config=viterbi_cfg, post=post, trained_model=trained
        )
    # Combined mapper family (mappers/combinedMapper.py)
    combined_cfg = _BASE_CONFIGS["LastParams"]
    for suffix, post in _POSTS.items():
        name = "CombinedMapper" + suffix
        trained = "blasr_hmm_0.txt" if post == "realign_trained" else None
        registry[name] = MapperSpec(
            name=name,
            config=combined_cfg,
            post=post,
            trained_model=trained,
            combined=True,
        )
    return registry


MAPPER_REGISTRY: dict[str, MapperSpec] = _build_registry()

# the reference's default-enabled mapper list (pipeline.py:45-77)
DEFAULT_MAPPERS = [
    "BwaChain",
    "BwaParamsChain",
    "BwaParamsRealign",
    "BwaParamsRealignEm",
    "BlasrChain",
    "BlasrParamsChain",
    "BlasrParamsRealign",
    "BlasrParamsRealignEm",
    "LastChain",
    "LastParamsChain",
    "LastParamsRealign",
    "LastParamsRealignEm",
    "LastzChain",
    "LastzParamsChain",
    "LastzParamsRealign",
    "LastzParamsRealignEm",
]

COMBINED_MEMBERS = ["LastParams", "LastzParams", "BwaParams", "BlasrParams"]
