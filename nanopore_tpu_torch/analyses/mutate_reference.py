"""Reference mutator: inject random SNPs and record the truth index.

Reproduces reference nanopore/analyses/mutate_reference.py: for
each mutation rate, write a mutated FASTA plus a ``<file>_Index.txt``
pairing each original sequence (``name``) with its mutated twin
(``name_mutated``) — the held-out truth the SNP caller scores against.
"""

from __future__ import annotations

import os

import numpy as np

from nanopore_tpu_torch.io.encoding import encode, decode
from nanopore_tpu_torch.io.seqio import fasta_read, fasta_write

DEFAULT_RATES = (0.01, 0.05)  # pipeline.py:193-194 enables 1% and 5%


def mutate_sequence(seq: str, rate: float, rng: np.random.Generator) -> str:
    """Substitute each base with prob ``rate`` to a different random base."""
    codes = encode(seq)
    mask = (rng.random(len(codes)) < rate) & (codes < 4)
    shift = rng.integers(1, 4, len(codes))
    mutated = codes.copy()
    mutated[mask] = (codes[mask] + shift[mask]) % 4
    return decode(mutated)


def mutate_reference_sequences(
    reference_fasta_files: list[str],
    rates=DEFAULT_RATES,
    seed: int = 0,
) -> list[str]:
    """Write mutated FASTAs + truth indices; returns originals + mutants."""
    rng = np.random.default_rng(seed)
    out = list(reference_fasta_files)
    for path in reference_fasta_files:
        for rate in rates:
            pct = int(rate * 100)
            mutated_path = "%s_%dpct_mutated.fa" % (
                path[:-3] if path.endswith(".fa") else path, pct,
            )
            index_path = mutated_path + "_Index.txt"
            if os.path.exists(mutated_path):
                out.append(mutated_path)
                continue
            with open(mutated_path, "w") as mf, open(index_path, "w") as xf:
                for name, seq in fasta_read(path):
                    name = name.split()[0]
                    mutated = mutate_sequence(seq, rate, rng)
                    fasta_write(mf, name, mutated)
                    fasta_write(xf, name, seq)
                    fasta_write(xf, name + "_mutated", mutated)
            out.append(mutated_path)
    return out
