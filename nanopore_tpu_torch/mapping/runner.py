"""Mapper execution: run a MapperSpec end to end (map + post-process).

Counterpart of ``nanopore_tpu/mapping/runner.py``: the equivalent of
one concrete reference mapper class's ``run()`` (e.g.
LastParamsRealignEm at mappers/last_params.py:20-23): map the FASTQ,
then optionally chain / realign / EM-train, writing ``mapping.sam`` (and
``hmm.txt`` when training).  ``distributed=True`` in a process group of
several ranks runs the cooperative multi-host mapper
(:func:`_run_mapper_distributed`).
"""

from __future__ import annotations

import dataclasses
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
from nanopore_tpu_torch.parallel import distributed as dist

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

    ``distributed=True`` with more than one rank in the process group
    (``parallel.distributed``) runs :func:`_run_mapper_distributed`, which
    every rank must call together; in a single process it is the path
    below.
    """
    if isinstance(spec, str):
        spec = MAPPER_REGISTRY[spec]
    if spec.post == "realign_em" and not hmm_file_to_train:
        raise ValueError("realign_em needs an hmm output path")
    device = resolve_device(device)
    if distributed and dist.process_info()[1] > 1:
        return _run_mapper_distributed(
            spec, read_fastq_file, reference_fasta_file, output_sam_file,
            hmm_file_to_train, em_options, device,
        )

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
        _chain_in_place(output_sam_file, read_fastq_file,
                        reference_fasta_file, stats)
    elif spec.post in ("realign", "realign_em", "realign_trained"):
        model = None
        if spec.post == "realign_trained":
            model = PairHmmModel.load(trained_model_path(spec.trained_model))
        elif spec.post == "realign_em":
            model = _train_em(output_sam_file, read_fastq_file,
                              reference_fasta_file, hmm_file_to_train,
                              em_options, device, stats)
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


def _chain_in_place(sam_file, read_fastq_file, reference_fasta_file,
                    stats) -> None:
    """Replace a mapping SAM by its chained global records."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "temp.sam")
        shutil.move(sam_file, src)
        chain_sam_file(src, sam_file, read_fastq_file, reference_fasta_file)
    stats.add("post_chain", time.perf_counter() - t0)


def _train_em(sam_file, read_fastq_file, reference_fasta_file,
              hmm_file_to_train, em_options, device, stats,
              write_files: bool = True) -> PairHmmModel:
    """Chain a mapping SAM, then train the model on the chained
    alignments (realignSamFileTargetFn, utils.py:540-555)."""
    with tempfile.TemporaryDirectory() as tmp:
        chained = os.path.join(tmp, "chained.sam")
        t0 = time.perf_counter()
        chain_sam_file(sam_file, chained, read_fastq_file,
                       reference_fasta_file)
        stats.add("post_chain", time.perf_counter() - t0)
        t0 = time.perf_counter()
        model = learn_model_from_sam_file(
            chained, reference_fasta_file, hmm_file_to_train, em_options,
            device=device, stats=stats, write_files=write_files,
        )
        stats.add("post_em", time.perf_counter() - t0)
    return model


def _run_mapper_distributed(
    spec: MapperSpec,
    read_fastq_file: str,
    reference_fasta_file: str,
    output_sam_file: str,
    hmm_file_to_train: str | None,
    em_options: EmOptions | None,
    device,
) -> MappingEngine:
    """Multi-host run_mapper: every rank executes this cooperatively.

    The replacement for the reference's batch-system target placement
    (jobTree over parasol/gridEngine, reference Makefile:2): FASTQ reads
    are strided-sharded across ranks for mapping, chained records are
    strided-sharded for realignment, EM sums all-reduce over the mesh of
    the process group, and rank 0 merges SAM and model files on the
    shared filesystem.  Every barrier runs on the caller's thread and
    carries the JAX package's tag.  Returns this rank's engine (its
    ``stage_stats`` cover this rank's share).
    """
    pi, pc = dist.process_info()

    # --- map: each rank its read shard, rank 0 merges ------------------ #
    if spec.combined:
        member_bases = []
        for mi, member in enumerate(COMBINED_MEMBERS):
            base = "%s.m%d" % (output_sam_file, mi)
            engine = _engine_for(
                reference_fasta_file, MAPPER_REGISTRY[member], device
            )
            engine.map_fastq(
                read_fastq_file, "%s.shard%d" % (base, pi), shard=(pi, pc)
            )
            member_bases.append(base)
        dist.barrier("map:" + output_sam_file)
        if pi == 0:
            for base in member_bases:
                dist.merge_sam_shards(dist.shard_paths(base, pc), base)
            combine_sam_files(
                member_bases[0], member_bases[1:], output_sam_file
            )
            for base in member_bases:
                os.remove(base)
    else:
        engine = _engine_for(reference_fasta_file, spec, device)
        n = engine.map_fastq(
            read_fastq_file, "%s.shard%d" % (output_sam_file, pi),
            shard=(pi, pc),
        )
        logger.info("%s[rank %d/%d]: %d alignments", spec.name, pi, pc, n)
        dist.barrier("map:" + output_sam_file)
        if pi == 0:
            dist.merge_sam_shards(
                dist.shard_paths(output_sam_file, pc), output_sam_file
            )
    dist.barrier("mapmerge:" + output_sam_file)
    stats = engine.stage_stats

    # --- post-process ---------------------------------------------------- #
    if spec.post == "chain":
        if pi == 0:
            _chain_in_place(output_sam_file, read_fastq_file,
                            reference_fasta_file, stats)
        dist.barrier("chain:" + output_sam_file)
    elif spec.post in ("realign", "realign_em", "realign_trained"):
        model = None
        if spec.post == "realign_trained":
            model = PairHmmModel.load(trained_model_path(spec.trained_model))
        elif spec.post == "realign_em":
            # EM at the preset's band width, as the JAX package's
            # multi-host path trains (its single-process path, like this
            # package's, keeps EmOptions())
            opts = dataclasses.replace(
                em_options or EmOptions(band_width=spec.band_width),
                use_mesh=True)
            if opts.checkpoint_path is None:
                # a shared-filesystem path: every rank resumes in lockstep
                opts = dataclasses.replace(
                    opts, checkpoint_path=hmm_file_to_train + ".ckpt.npz"
                )
            # the sums all-reduce over the mesh: every rank computes the
            # same model; rank 0 owns the files
            model = _train_em(output_sam_file, read_fastq_file,
                              reference_fasta_file, hmm_file_to_train, opts,
                              device, stats, write_files=pi == 0)
        # realign: chain deterministically everywhere, realign a strided
        # record shard each, rank 0 splices chained order back together
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            src = os.path.join(tmp, "temp.sam")
            shutil.copyfile(output_sam_file, src)
            dist.barrier("precopy:" + output_sam_file)
            realign_sam_file(
                src,
                "%s.rshard%d" % (output_sam_file, pi),
                read_fastq_file,
                reference_fasta_file,
                gap_gamma=spec.gap_gamma,
                match_gamma=spec.match_gamma,
                hmm_model=model,
                band_width=spec.band_width,
                shard=(pi, pc),
                device=device,
            )
            dist.barrier("realign:" + output_sam_file)
            if pi == 0:
                dist.merge_sam_shards(
                    ["%s.rshard%d" % (output_sam_file, i)
                     for i in range(pc)],
                    output_sam_file,
                    order="interleave",
                )
            dist.barrier("realignmerge:" + output_sam_file)
        stats.add("post_realign", time.perf_counter() - t0)
    elif spec.post:
        raise ValueError("unknown post stage %r" % spec.post)
    return engine
