"""Mapper execution: run a MapperSpec's map stage end to end.

Counterpart of the map stage of ``nanopore_tpu/mapping/runner.py``: map
the FASTQ against the reference and write ``mapping.sam``.  The
post-processing stages (chain, realign, EM) and the combined mapper are
not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import logging
import os
import threading

from nanopore_tpu_torch.device import resolve_device
from nanopore_tpu_torch.io.seqio import read_fasta_dict
from nanopore_tpu_torch.mapping.engine import MappingEngine
from nanopore_tpu_torch.mapping.index import KmerIndex
from nanopore_tpu_torch.mapping.presets import MapperSpec, MAPPER_REGISTRY

logger = logging.getLogger("nanopore_tpu_torch")

# Cache only the expensive, shareable artifact (the k-mer index, keyed
# by what determines it); each call gets its own engine, so two presets
# sharing (k, max_occ) can run concurrently without sharing a config.
_INDEX_CACHE: dict[tuple, tuple[dict, KmerIndex]] = {}
_INDEX_LOCK = threading.Lock()


def _engine_for(reference_fasta_file: str, spec: MapperSpec,
                device) -> MappingEngine:
    key = (
        os.path.abspath(reference_fasta_file),
        spec.config.k,
        spec.config.max_occ,
    )
    with _INDEX_LOCK:
        cached = _INDEX_CACHE.get(key)
        if cached is None:
            ref = read_fasta_dict(reference_fasta_file)
            index = KmerIndex.build(
                ref, k=spec.config.k, max_occ=spec.config.max_occ
            )
            cached = (ref, index)
            _INDEX_CACHE[key] = cached
    ref, index = cached
    return MappingEngine(ref, spec.config, index=index, device=device)


def run_mapper(
    spec: MapperSpec | str,
    read_fastq_file: str,
    read_type: str,
    reference_fasta_file: str,
    output_sam_file: str,
    device=None,
) -> MappingEngine:
    """Map ``read_fastq_file`` to ``output_sam_file`` with ``spec``.

    Runs on the card unless ``device="cpu"``.  Returns the engine used,
    whose ``stage_stats`` hold the per-stage host seconds.
    """
    if isinstance(spec, str):
        spec = MAPPER_REGISTRY[spec]
    if spec.combined or spec.post:
        raise NotImplementedError(
            "%s: only the map stage is ported (post=%r, combined=%s)"
            % (spec.name, spec.post, spec.combined)
        )
    device = resolve_device(device)
    engine = _engine_for(reference_fasta_file, spec, device)
    n = engine.map_fastq(read_fastq_file, output_sam_file)
    logger.info("%s: %d alignments -> %s", spec.name, n, output_sam_file)
    return engine
