"""Mapper execution: run a MapperSpec end to end (map + post-process).

Counterpart of ``nanopore_tpu/mapping/runner.py`` on one device: the
equivalent of one concrete reference mapper class's ``run()`` (e.g.
LastParamsRealignEm at mappers/last_params.py:20-23): map the FASTQ,
then optionally chain / realign / EM-train, writing ``mapping.sam`` (and
``hmm.txt`` when training).  The cooperative multi-host run
(``distributed=True``) is not ported yet (ROADMAP A5) and raises
``NotImplementedError``.
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile
import threading
import time

from nanopore_tpu_torch.align.chain_sam import chain_sam_file, combine_sam_files
from nanopore_tpu_torch.align.em import EmOptions, learn_model_from_sam_file
from nanopore_tpu_torch.align.model import PairHmmModel
from nanopore_tpu_torch.align.realign import realign_sam_file
from nanopore_tpu_torch.device import resolve_device
from nanopore_tpu_torch.io.seqio import read_fasta_dict
from nanopore_tpu_torch.mapping.engine import MappingEngine
from nanopore_tpu_torch.mapping.index import KmerIndex
from nanopore_tpu_torch.mapping.presets import (
    COMBINED_MEMBERS,
    MAPPER_REGISTRY,
    MapperSpec,
)

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


def trained_model_path(name: str) -> str:
    """Path of a trained model shipped with the package (models/)."""
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "models",
        name,
    )


def run_mapper(
    spec: MapperSpec | str,
    read_fastq_file: str,
    read_type: str,
    reference_fasta_file: str,
    output_sam_file: str,
    hmm_file_to_train: str | None = None,
    em_options: EmOptions | None = None,
    distributed: bool = False,
    device=None,
) -> MappingEngine:
    """Run ``spec`` on ``read_fastq_file``, writing ``output_sam_file``
    (and, for ``post="realign_em"``, the trained model's three files at
    ``hmm_file_to_train``).

    Runs on the card unless ``device="cpu"``.  Returns the engine that
    mapped (the last member's for a combined mapper); its
    ``stage_stats`` hold the per-stage host seconds of the mapping and
    of the post stages (``post_chain``, ``post_em`` with the ``em_*``
    stages of ``align.em.em_train``, ``post_realign``).
    """
    if isinstance(spec, str):
        spec = MAPPER_REGISTRY[spec]
    if distributed:
        raise NotImplementedError(
            "the multi-host run (distributed=True) is not ported yet: "
            "ROADMAP A5"
        )
    if spec.post == "realign_em" and not hmm_file_to_train:
        raise ValueError("realign_em needs an hmm output path")
    device = resolve_device(device)

    # --- map ----------------------------------------------------------- #
    if spec.combined:
        # run all four tuned presets, concatenate (combinedMapper.py:12-23)
        with tempfile.TemporaryDirectory() as tmp:
            member_sams = []
            for member in COMBINED_MEMBERS:
                sam = os.path.join(tmp, "mapping_%s.sam" % member)
                engine = _engine_for(
                    reference_fasta_file, MAPPER_REGISTRY[member], device
                )
                engine.map_fastq(read_fastq_file, sam)
                member_sams.append(sam)
            combine_sam_files(
                member_sams[0], member_sams[1:], output_sam_file
            )
    else:
        engine = _engine_for(reference_fasta_file, spec, device)
        n = engine.map_fastq(read_fastq_file, output_sam_file)
        logger.info("%s: %d alignments -> %s", spec.name, n, output_sam_file)
    stats = engine.stage_stats

    # --- post-process --------------------------------------------------- #
    if spec.post == "chain":
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            src = os.path.join(tmp, "temp.sam")
            shutil.move(output_sam_file, src)
            chain_sam_file(src, output_sam_file, read_fastq_file,
                           reference_fasta_file)
        stats.add("post_chain", time.perf_counter() - t0)
    elif spec.post in ("realign", "realign_em", "realign_trained"):
        model = None
        if spec.post == "realign_trained":
            model = PairHmmModel.load(trained_model_path(spec.trained_model))
        elif spec.post == "realign_em":
            # chain first, then train on the chained alignments
            # (realignSamFileTargetFn, utils.py:540-555)
            with tempfile.TemporaryDirectory() as tmp:
                chained = os.path.join(tmp, "chained.sam")
                t0 = time.perf_counter()
                chain_sam_file(
                    output_sam_file, chained, read_fastq_file,
                    reference_fasta_file,
                )
                stats.add("post_chain", time.perf_counter() - t0)
                t0 = time.perf_counter()
                model = learn_model_from_sam_file(
                    chained, reference_fasta_file, hmm_file_to_train,
                    em_options, device=device, stats=stats,
                )
                stats.add("post_em", time.perf_counter() - t0)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            src = os.path.join(tmp, "temp.sam")
            shutil.move(output_sam_file, src)
            realign_sam_file(
                src,
                output_sam_file,
                read_fastq_file,
                reference_fasta_file,
                gap_gamma=spec.gap_gamma,
                match_gamma=spec.match_gamma,
                hmm_model=model,
                band_width=spec.band_width,
                device=device,
            )
        stats.add("post_realign", time.perf_counter() - t0)
    elif spec.post:
        raise ValueError("unknown post stage %r" % spec.post)
    return engine
