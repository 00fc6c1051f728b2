"""The pipeline: experiment cross-product over a working directory.

Counterpart of ``nanopore_tpu/pipeline.py``.  It reproduces
the reference's pipeline (reference nanopore/pipeline.py): discover
``readFastqFiles/<readType>/*.fq`` and ``referenceFastaFiles/*.fa``,
uniquify sequence names into ``output/processed*Files``, then for every
(readType, fastq, reference, mapper) run map -> analyses, and after ALL
experiments the meta-analyses — with the same directory naming and
resume semantics (mapping.sam existence, per-analysis DONE markers;
pipeline.py:98-149, 173-191).  jobTree is replaced by the host DAG
scheduler (``runtime/scheduler.py``).

Every mapping and analysis runs on ``PipelineConfig.device``: the card
unless it is ``"cpu"``.  Where ``NANOPORE_TPU_COORDINATOR``,
``NANOPORE_TPU_NUM_PROCESSES`` (> 1) and ``NANOPORE_TPU_PROCESS_ID`` are
set, one process per host joins a gloo process group
(``parallel/distributed.py``) and the hosts run the pipeline together
(:func:`_run_pipeline_distributed`).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field

from nanopore_tpu_torch.align.em import EmOptions
from nanopore_tpu_torch.analyses import ALL_ANALYSES, DEFAULT_ANALYSES, Analysis
from nanopore_tpu_torch.device import resolve_device
from nanopore_tpu_torch.io.seqio import (
    make_fasta_names_unique,
    make_fastq_names_unique,
)
from nanopore_tpu_torch.mapping.presets import DEFAULT_MAPPERS, MAPPER_REGISTRY
from nanopore_tpu_torch.mapping.runner import run_mapper
from nanopore_tpu_torch.meta import ALL_META_ANALYSES
from nanopore_tpu_torch.parallel import distributed as dist
from nanopore_tpu_torch.runtime.scheduler import Scheduler

logger = logging.getLogger("nanopore_tpu_torch")

DEFAULT_META_ANALYSES = [
    "UnmappedKmerAnalysis",
    "CoverageSummary",
    "UnmappedLengthDistributionAnalysis",
    "ComparePerReadMappabilityByMapper",
    "HmmMetaAnalysis",
]


@dataclass
class Experiment:
    read_fastq_file: str
    read_type: str
    reference_fasta_file: str
    mapper_name: str
    experiment_dir: str

    @property
    def sam_file(self) -> str:
        return os.path.join(self.experiment_dir, "mapping.sam")

    @property
    def hmm_file(self) -> str:
        return os.path.join(self.experiment_dir, "hmm.txt")


@dataclass
class PipelineConfig:
    mappers: list[str] = field(default_factory=lambda: list(DEFAULT_MAPPERS))
    analyses: list[str] = field(
        default_factory=lambda: [cls.__name__ for cls in DEFAULT_ANALYSES]
    )
    meta_analyses: list[str] = field(
        default_factory=lambda: list(DEFAULT_META_ANALYSES)
    )
    max_workers: int = 4
    em_options: EmOptions = field(default_factory=EmOptions)
    mutate_references: bool = False  # pipeline.py:193-194 (disabled)
    sample_reads: bool = False  # pipeline.py:162-163 (disabled)
    device: str | None = None  # None: the card; "cpu": the plain path


def discover_inputs(
    working_dir: str, output_dir: str
) -> tuple[list[tuple[str, list[str]]], list[str]]:
    """Uniquify names into output/processed*Files (pipeline.py:173-191)."""
    processed_fastq = os.path.join(output_dir, "processedReadFastqFiles")
    os.makedirs(processed_fastq, exist_ok=True)
    fastq_parent = os.path.join(working_dir, "readFastqFiles")
    read_fastq_files: list[tuple[str, list[str]]] = []
    for entry in sorted(os.listdir(fastq_parent)):
        sub = os.path.join(fastq_parent, entry)
        if not os.path.isdir(sub):
            continue
        read_type = entry
        out_sub = os.path.join(processed_fastq, read_type)
        os.makedirs(out_sub, exist_ok=True)
        files = []
        for fname in sorted(os.listdir(sub)):
            if fname.endswith(".fq") or fname.endswith(".fastq"):
                out_path = os.path.join(out_sub, fname)
                if not os.path.exists(out_path):
                    make_fastq_names_unique(
                        os.path.join(sub, fname), out_path
                    )
                files.append(out_path)
        read_fastq_files.append((read_type, files))

    processed_fasta = os.path.join(output_dir, "processedReferenceFastaFiles")
    os.makedirs(processed_fasta, exist_ok=True)
    fasta_parent = os.path.join(working_dir, "referenceFastaFiles")
    reference_fasta_files = []
    for fname in sorted(os.listdir(fasta_parent)):
        if fname.endswith(".fa") or fname.endswith(".fasta"):
            out_path = os.path.join(processed_fasta, fname)
            if not os.path.exists(out_path):
                make_fasta_names_unique(
                    os.path.join(fasta_parent, fname), out_path
                )
            reference_fasta_files.append(out_path)
    return read_fastq_files, reference_fasta_files


def build_experiments(
    output_dir: str,
    read_fastq_files: list[tuple[str, list[str]]],
    reference_fasta_files: list[str],
    mappers: list[str],
) -> list[Experiment]:
    experiments = []
    for read_type, fastq_files in read_fastq_files:
        base = os.path.join(output_dir, "analysis_" + read_type)
        os.makedirs(base, exist_ok=True)
        for fastq in fastq_files:
            for ref in reference_fasta_files:
                for mapper in mappers:
                    exp_dir = os.path.join(
                        base,
                        "experiment_%s_%s_%s"
                        % (
                            os.path.basename(fastq),
                            os.path.basename(ref),
                            mapper,
                        ),
                    )
                    experiments.append(
                        Experiment(fastq, read_type, ref, mapper, exp_dir)
                    )
    return experiments


def run_pipeline(
    working_dir: str, config: PipelineConfig | None = None
) -> str:
    """Run the full pipeline; returns the output directory.

    Tracing: set ``NANOPORE_TPU_PROFILE=<dir>`` to record the whole run
    with ``torch.profiler`` (host ops, and the card's kernels when it
    runs on the card) into ``<dir>/pipeline_trace.json``, a Chrome
    trace (Perfetto reads it), one per rank (``pipeline_trace.host<i>.json``
    on rank i > 0); per-task wall/CPU stats land in
    output/pipeline_stats.json either way (runtime/scheduler.py).
    """
    config = config or PipelineConfig()
    device = resolve_device(config.device)
    # the group a multi-host run joins (``_run_pipeline_impl``) it leaves
    # after its last barrier and its trace; a caller's group stays
    joins = dist.process_info()[1] == 1
    try:
        return _run_pipeline_traced(working_dir, config, device)
    finally:
        if joins:
            dist.shutdown_distributed()


def _run_pipeline_traced(working_dir: str, config: PipelineConfig,
                         device) -> str:
    profile_dir = os.environ.get("NANOPORE_TPU_PROFILE")
    if not profile_dir:
        return _run_pipeline_impl(working_dir, config, device)
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        out = _run_pipeline_impl(working_dir, config, device)
    os.makedirs(profile_dir, exist_ok=True)
    pi = dist.process_info()[0]
    prof.export_chrome_trace(os.path.join(
        profile_dir,
        "pipeline_trace.json" if pi == 0 else "pipeline_trace.host%d.json" % pi,
    ))
    return out


def _run_pipeline_impl(
    working_dir: str, config: PipelineConfig, device
) -> str:
    for kind, names, registry in (
        ("mapper", config.mappers, MAPPER_REGISTRY),
        ("analysis", config.analyses, ALL_ANALYSES),
        ("meta-analysis", config.meta_analyses, ALL_META_ANALYSES),
    ):
        unknown = [n for n in names if n not in registry]
        if unknown:
            raise ValueError("unknown %s %s" % (kind, ", ".join(unknown)))

    output_dir = os.path.join(working_dir, "output")
    os.makedirs(output_dir, exist_ok=True)

    if dist.initialize_distributed()[1] > 1:
        return _run_pipeline_distributed(working_dir, config, output_dir,
                                         device)

    _sample_reads(working_dir, config)
    read_fastq_files, reference_fasta_files = _prepare_inputs(
        working_dir, config, output_dir)
    experiments = build_experiments(
        output_dir, read_fastq_files, reference_fasta_files, config.mappers
    )
    logger.info(
        "pipeline: %d experiments (%d mappers x inputs) on %s",
        len(experiments),
        len(config.mappers),
        device,
    )

    sched = Scheduler(max_workers=config.max_workers)
    analysis_task_names = []
    for exp in experiments:
        os.makedirs(exp.experiment_dir, exist_ok=True)
        map_task = "map:%s" % exp.experiment_dir

        def map_fn(exp=exp):
            run_mapper(
                exp.mapper_name,
                exp.read_fastq_file,
                exp.read_type,
                exp.reference_fasta_file,
                exp.sam_file,
                exp.hmm_file,
                config.em_options,
                device=device,
            )

        sched.add_task(
            map_task,
            map_fn,
            skip_if=lambda exp=exp: os.path.exists(exp.sam_file),
        )
        for analysis_name in config.analyses:
            analysis_task_names.append(_add_analysis_task(
                sched, exp, analysis_name, device, deps=[map_task]))

    # meta-analyses run after every experiment (pipeline.py:112,144-149)
    for meta_name in config.meta_analyses:
        meta_cls = ALL_META_ANALYSES[meta_name]
        meta_dir = os.path.join(output_dir, "metaAnalysis_" + meta_name)
        os.makedirs(meta_dir, exist_ok=True)

        def meta_fn(meta_cls=meta_cls, meta_dir=meta_dir):
            meta_cls(meta_dir, experiments, config.analyses).run()

        sched.add_task(
            "meta:%s" % meta_name, meta_fn, deps=list(analysis_task_names)
        )

    sched.run(stats_path=os.path.join(output_dir, "pipeline_stats.json"))
    return output_dir


def _add_analysis_task(sched: Scheduler, exp: Experiment, analysis_name: str,
                       device, deps=()) -> str:
    """Add the task of one analysis of one experiment (skipped when its
    DONE marker is there); returns the task's name."""
    cls = ALL_ANALYSES[analysis_name]
    analysis_dir = os.path.join(exp.experiment_dir, "analysis_" + analysis_name)
    os.makedirs(analysis_dir, exist_ok=True)
    task_name = "analysis:%s:%s" % (analysis_name, exp.experiment_dir)

    def analysis_fn():
        Analysis.reset(analysis_dir)
        cls(
            exp.read_fastq_file,
            exp.read_type,
            exp.reference_fasta_file,
            exp.sam_file,
            analysis_dir,
            device=device,
        ).execute()

    sched.add_task(
        task_name,
        analysis_fn,
        deps=deps,
        skip_if=lambda: Analysis.is_finished(analysis_dir),
    )
    return task_name


def _sample_reads(working_dir: str, config: PipelineConfig) -> None:
    """The read sampler, when configured (pipeline.py:162-163)."""
    if config.sample_reads:
        from nanopore_tpu_torch.analyses.read_sampler import sample_reads

        sample_reads(working_dir)


def _prepare_inputs(working_dir: str, config: PipelineConfig,
                    output_dir: str):
    """The uniquified inputs and, when configured, the mutated
    references (pipeline.py:173-194)."""
    read_fastq_files, reference_fasta_files = discover_inputs(
        working_dir, output_dir
    )
    if config.mutate_references:
        from nanopore_tpu_torch.analyses.mutate_reference import (
            mutate_reference_sequences,
        )

        reference_fasta_files = mutate_reference_sequences(
            reference_fasta_files
        )
    return read_fastq_files, reference_fasta_files


def _run_pipeline_distributed(
    working_dir: str, config: PipelineConfig, output_dir: str, device
) -> str:
    """Multi-host pipeline: every rank runs this cooperatively.

    The reference places jobTree targets on cluster nodes over a shared
    filesystem (Makefile:2, pipeline.sh:9); here the mapping, realign and
    EM work of each experiment is read-sharded across ranks
    (``mapping.runner._run_mapper_distributed``: EM sums all-reduce over
    the mesh), analysis tasks are strided whole across ranks, and the
    meta-analyses run on rank 0 after a global barrier.  Every collective
    runs on this (main) thread: the cooperative mapping runs before the
    scheduler starts, and the analyses under it call none.
    """
    pi, pc = dist.process_info()
    logger.info("distributed pipeline: rank %d/%d on %s", pi, pc, device)

    # --- inputs: rank 0 writes processed*Files, the others read them --- #
    if pi == 0:
        _sample_reads(working_dir, config)
        read_fastq_files, reference_fasta_files = _prepare_inputs(
            working_dir, config, output_dir)
    dist.barrier("inputs")
    if pi != 0:
        read_fastq_files, reference_fasta_files = _prepare_inputs(
            working_dir, config, output_dir)
    experiments = build_experiments(
        output_dir, read_fastq_files, reference_fasta_files, config.mappers
    )

    # --- mapping: cooperative per experiment, in one order ------------- #
    for exp in experiments:
        os.makedirs(exp.experiment_dir, exist_ok=True)
        # rank 0 decides the skip, so no rank diverges on what the
        # filesystem shows it
        if dist.coordinator_decision(os.path.exists(exp.sam_file)):
            continue
        run_mapper(
            exp.mapper_name,
            exp.read_fastq_file,
            exp.read_type,
            exp.reference_fasta_file,
            exp.sam_file,
            exp.hmm_file,
            config.em_options,
            distributed=True,
            device=device,
        )
    dist.barrier("mapping")

    # --- analyses: whole tasks strided across ranks --------------------- #
    tasks = [(exp, name) for exp in experiments for name in config.analyses]
    sched = Scheduler(max_workers=config.max_workers)
    for exp, analysis_name in dist.host_shard(tasks):
        _add_analysis_task(sched, exp, analysis_name, device)
    sched.run(stats_path=os.path.join(
        output_dir,
        "pipeline_stats.json" if pi == 0 else "pipeline_stats.host%d.json" % pi,
    ))
    dist.barrier("analyses")

    # --- meta-analyses: rank 0, after every experiment ------------------ #
    if pi == 0:
        for meta_name in config.meta_analyses:
            meta_dir = os.path.join(output_dir, "metaAnalysis_" + meta_name)
            os.makedirs(meta_dir, exist_ok=True)
            ALL_META_ANALYSES[meta_name](
                meta_dir, experiments, config.analyses).run()
    dist.barrier("meta")
    return output_dir
