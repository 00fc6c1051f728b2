"""Read subsampler: write FASTQ subsets at fixed fractions.

A copy of the JAX package's ``analyses/read_sampler.py``.  Reproduces
the reference's nanopore/analyses/read_sampler.py
(``SampleReads``): for each input FASTQ under readFastqFiles/<type>,
write sampled copies at the requested fractions (default 75/50/25%,
matching the reference pipeline's comment at pipeline.py:162-163).
"""

from __future__ import annotations

import os

import numpy as np

from nanopore_tpu_torch.io.seqio import fastq_read, fastq_write

DEFAULT_FRACTIONS = (0.75, 0.5, 0.25)


def sample_reads_file(
    fastq_path: str, fraction: float, output_path: str, seed: int = 0
) -> str:
    rng = np.random.default_rng(seed)
    records = list(fastq_read(fastq_path))
    take = rng.random(len(records)) < fraction
    with open(output_path, "w") as fh:
        for keep, (name, seq, quals) in zip(take, records):
            if keep:
                fastq_write(fh, name, seq, quals)
    return output_path


def sample_reads(working_dir: str, fractions=DEFAULT_FRACTIONS, seed: int = 0):
    """Augment every readFastqFiles/<type>/ with sampled copies."""
    parent = os.path.join(working_dir, "readFastqFiles")
    created = []
    for read_type in os.listdir(parent):
        sub = os.path.join(parent, read_type)
        if not os.path.isdir(sub):
            continue
        for fname in list(os.listdir(sub)):
            if not (fname.endswith(".fq") or fname.endswith(".fastq")):
                continue
            base = os.path.join(sub, fname)
            for frac in fractions:
                out = "%s_sampled_%d.fq" % (base.rsplit(".", 1)[0], int(frac * 100))
                if not os.path.exists(out):
                    sample_reads_file(base, frac, out, seed)
                created.append(out)
    return created
