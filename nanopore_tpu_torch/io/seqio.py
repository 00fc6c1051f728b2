"""FASTA / FASTQ streaming I/O with the reference pipeline's semantics.

Replaces the sonLib/jobTree ``bioio`` surface used by the reference
(fastaRead/fastqRead/fastaWrite/fastqWrite, reference
nanopore/analyses/utils.py:2) plus the name-uniquification
pre-pass of the reference pipeline (utils.py:247-285, pipeline.py:173-191).
"""

from __future__ import annotations

import os
import logging
from typing import Iterator, Optional

import numpy as np

logger = logging.getLogger("nanopore_tpu_torch")


def fasta_read(path_or_handle) -> Iterator[tuple[str, str]]:
    """Yield (header, sequence) tuples from a FASTA file.

    The header is everything after '>', whitespace included (callers take
    the first word when they need a name, matching
    utils.py:getFastaDictionary:233-238).
    """
    close = False
    if isinstance(path_or_handle, str):
        handle = open(path_or_handle)
        close = True
    else:
        handle = path_or_handle
    try:
        name = None
        chunks: list[str] = []
        for line in handle:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(chunks)
                name = line[1:]
                chunks = []
            else:
                chunks.append(line)
        if name is not None:
            yield name, "".join(chunks)
    finally:
        if close:
            handle.close()


def fasta_write(handle, name: str, seq: str, line_width: int = 60) -> None:
    if isinstance(handle, str):
        with open(handle, "w") as f:
            fasta_write(f, name, seq, line_width)
        return
    handle.write(">%s\n" % name)
    for i in range(0, len(seq), line_width):
        handle.write(seq[i : i + line_width] + "\n")


def fastq_read_raw(path_or_handle) -> Iterator[tuple[str, str, str]]:
    """Yield (name, sequence, qual STRING) from a FASTQ file.

    The mapper's hot path: it only re-emits the phred string into SAM,
    so decoding to ints and re-encoding (~0.8 ms per 5 kb read) is
    pure waste there.  Use fastq_read for phred-value consumers."""
    close = False
    if isinstance(path_or_handle, str):
        handle = open(path_or_handle)
        close = True
    else:
        handle = path_or_handle
    try:
        while True:
            header = handle.readline()
            if not header:
                break
            header = header.strip()
            if not header:
                continue
            assert header.startswith("@"), "bad fastq header: %r" % header
            seq = handle.readline().strip()
            plus = handle.readline().strip()
            assert plus.startswith("+"), "bad fastq separator: %r" % plus
            qual = handle.readline().strip()
            # same contract as fastq_read: a truncated/malformed record
            # must fail at parse time, not flow into SAM with
            # mismatched SEQ/QUAL lengths ('*' = no quals is allowed)
            assert qual == "*" or len(qual) == len(seq), (
                "fastq record %r: qual length %d != seq length %d"
                % (header[1:], len(qual), len(seq))
            )
            yield header[1:], seq, qual
    finally:
        if close:
            handle.close()


def fastq_read(path_or_handle) -> Iterator[tuple[str, str, Optional[list[int]]]]:
    """Yield (name, sequence, quals) from a FASTQ file.

    quals is a list of phred ints (qual char - 33), or None when the quality
    line is '*' — matching bioio fastqRead as consumed by
    utils.py:normaliseQualValues:276-285.
    """
    close = False
    if isinstance(path_or_handle, str):
        handle = open(path_or_handle)
        close = True
    else:
        handle = path_or_handle
    try:
        while True:
            header = handle.readline()
            if not header:
                break
            header = header.strip()
            if not header:
                continue
            assert header.startswith("@"), "bad fastq header: %r" % header
            seq = handle.readline().strip()
            plus = handle.readline().strip()
            assert plus.startswith("+"), "bad fastq separator: %r" % plus
            qual = handle.readline().strip()
            quals = None if qual == "*" else (
                np.frombuffer(qual.encode("latin-1"), np.uint8).astype(
                    np.int64) - 33).tolist()
            if quals is not None:
                assert len(quals) == len(seq)
            yield header[1:], seq, quals
    finally:
        if close:
            handle.close()


def fastq_write(handle, name: str, seq: str, quals: Optional[list[int]]) -> None:
    if quals is None:
        qual_str = "*"
    else:
        assert len(quals) == len(seq)
        qual_str = "".join(chr(q + 33) for q in quals)
    handle.write("@%s\n%s\n+\n%s\n" % (name, seq, qual_str))


def read_fasta_dict(path: str) -> dict[str, str]:
    """First word of each FASTA header -> sequence; names must be unique.

    Semantics of utils.py:getFastaDictionary:233-238.
    """
    d: dict[str, str] = {}
    for header, seq in fasta_read(path):
        name = header.split()[0]
        assert name not in d, "duplicate fasta name: %s" % name
        d[name] = seq
    return d


def read_fastq_dict(path: str) -> dict[str, str]:
    """First word of each FASTQ header -> sequence; names must be unique.

    Semantics of utils.py:getFastqDictionary:240-245.
    """
    d: dict[str, str] = {}
    for header, seq, _ in fastq_read(path):
        name = header.split()[0]
        assert name not in d, "duplicate fastq name: %s" % name
        d[name] = seq
    return d


def read_fastq_quals(path: str) -> dict[str, Optional[list[int]]]:
    """First word of each FASTQ header -> qual list (or None)."""
    return {header.split()[0]: quals for header, _, quals in fastq_read(path)}


def make_fasta_names_unique(input_path: str, output_path: str) -> str:
    """Rewrite a FASTA file appending 'i' to duplicated names.

    Semantics of utils.py:makeFastaSequenceNamesUnique:247-259 (note: the
    reference keeps the full header for FASTA and only uniquifies on it).
    """
    names: set[str] = set()
    with open(output_path, "w") as out:
        for name, seq in fasta_read(input_path):
            while name in names:
                logger.warning("duplicate fasta sequence name: %s", name)
                name += "i"
            names.add(name)
            fasta_write(out, name, seq)
    return output_path


def make_fastq_names_unique(input_path: str, output_path: str) -> str:
    """Rewrite a FASTQ file: names truncated at whitespace, 'i'-suffixed dups.

    Semantics of utils.py:makeFastqSequenceNamesUnique:261-274.
    """
    names: set[str] = set()
    with open(output_path, "w") as out:
        for name, seq, quals in fastq_read(input_path):
            name = name.split()[0]
            while name in names:
                logger.warning("duplicate fastq sequence name: %s", name)
                name += "i"
            names.add(name)
            fastq_write(out, name, seq, quals)
    return output_path


def normalise_qual_values(input_path: str, output_path: str) -> str:
    """Rewrite a FASTQ replacing missing quals with phred 33 everywhere.

    Semantics of utils.py:normaliseQualValues:276-285 (used by the lastz
    wrapper, mappers/lastz.py:10).
    """
    with open(output_path, "w") as out:
        for name, seq, quals in fastq_read(input_path):
            if quals is None:
                quals = [33] * len(seq)
            fastq_write(out, name, seq, quals)
    return output_path
