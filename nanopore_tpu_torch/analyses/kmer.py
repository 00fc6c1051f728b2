"""K-mer composition analyses (plain + indel-boundary variants).

Reproduces the reference KmerAnalysis
(reference nanopore/analyses/kmerAnalysis.py) and
IndelKmerAnalysis (indelKmerAnalysis.py): 5-mer spectra of reference vs
reads (both strands), per-kmer fractions and -log fold change, plus the
significance table / volcano (kmer_analysis.R reimplemented in
analyses.plots).  Plain counting runs as a bincount on the analysis's
device.  A copy of the JAX package's ``analyses/kmer.py``.

Reference quirks preserved for table parity:
- window enumeration skips the final k-mer of each sequence
  (kmerAnalysis.py:16, ``xrange(kmerSize, len(seq))``),
- output rows iterate itertools.product("ATGC") — ATGC order, not ACGT
  (kmerAnalysis.py:37).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from nanopore_tpu_torch.analyses.base import Analysis
from nanopore_tpu_torch.analyses.common import ExperimentData
from nanopore_tpu_torch.device import resolve_device
from nanopore_tpu_torch.io.encoding import encode
from nanopore_tpu_torch.io.seqio import fasta_read, fastq_read
from nanopore_tpu_torch.ops.reductions import (
    kmer_count_vector,
    revcomp_kmer_counts,
)

_CODE = {"A": 0, "C": 1, "G": 2, "T": 3}


def _kmer_to_index(kmer: str) -> int:
    idx = 0
    for ch in kmer:
        idx = idx * 4 + _CODE[ch]
    return idx


# codes a batch of sequences joins before one count on the device
KMER_BATCH_CODES = 1 << 24


def count_kmers_both_strands(seqs, k: int, device=None) -> np.ndarray:
    """(4^k,) counts including reverse complements (kmerAnalysis.py:15-28).

    The JAX package counts each sequence with one ``kmer_count_vector``;
    here a batch of sequences is one call on ``device`` (the card unless
    ``"cpu"``), each sequence but its last code followed by an N.  A
    window of the joined codes is then a window of one sequence that the
    reference counts (one that ends before the sequence's last code), or
    holds the N and goes to the overflow bin; so the counts are the sum
    of the per-sequence counts.  The host gets the total once.
    """
    dev = resolve_device(device)
    total = torch.zeros(4**k, dtype=torch.int64, device=dev)
    sep = np.full(1, 4, np.int8)  # N

    def count(parts):
        joined = torch.as_tensor(np.concatenate(parts), device=dev)
        counts = kmer_count_vector(joined, k)
        total.add_(counts).add_(revcomp_kmer_counts(counts, k))

    parts, size = [], 0
    for seq in seqs:
        parts += [encode(seq)[:-1], sep]
        size += len(seq)
        if size >= KMER_BATCH_CODES:
            count(parts)
            parts, size = [], 0
    if parts:
        count(parts)
    return total.cpu().numpy()


def write_kmer_table(
    path: str, ref_counts: np.ndarray, read_counts: np.ndarray, k: int
) -> None:
    """kmer_counts.txt schema (kmerAnalysis.py:32-47)."""
    ref_size = int(ref_counts.sum())
    read_size = int(read_counts.sum())
    with open(path, "w") as fh:
        fh.write(
            "kmer\trefCount\trefFraction\treadCount\treadFraction\t"
            "logFoldChange\n"
        )
        for kmer_tuple in itertools.product("ATGC", repeat=k):
            kmer = "".join(kmer_tuple)
            idx = _kmer_to_index(kmer)
            rc = int(ref_counts[idx])
            qc = int(read_counts[idx])
            rf = rc / ref_size if ref_size else 0.0
            qf = qc / read_size if read_size else 0.0
            if rf == 0:
                fold = "-Inf"
            elif qf == 0:
                fold = "Inf"
            else:
                fold = str(-np.log(qf / rf))
            fh.write(
                "\t".join(map(str, [kmer, rc, rf, qc, qf, fold])) + "\n"
            )


class KmerAnalysis(Analysis):
    kmer_size = 5

    def run(self) -> None:
        k = self.kmer_size
        ref_counts = count_kmers_both_strands(
            (seq for _, seq in fasta_read(self.reference_fasta_file)), k,
            self.device,
        )
        read_counts = count_kmers_both_strands(
            (seq for _, seq, _ in fastq_read(self.read_fastq_file)), k,
            self.device,
        )
        if ref_counts.sum() == 0 or read_counts.sum() == 0:
            return
        name = "all_bases_"
        table = self.out(name + "kmer_counts.txt")
        write_kmer_table(table, ref_counts, read_counts, k)
        from nanopore_tpu_torch.analyses import plots

        plots.kmer_significance(
            table,
            self.out(name + "pval_kmer_counts.txt"),
            self.out(name + "top_bot_sigkmer_counts.txt"),
            self.out(name + "volcano_plot.pdf"),
            "Kmer",
        )


class IndelKmerAnalysis(Analysis):
    """K-mers spanning indel boundaries (indelKmerAnalysis.py).

    The reference slides an ordered-unique window (UniqueList) of k+1
    entries over each alignment column list, yielding (start, end) spans
    whose interior contains a gap; the spanned read (resp. ref) substring
    is counted, plus its reversal.  We reproduce the algorithm directly —
    it is O(#columns) — over the aligned-pair columns that can reach a
    span (``_span_tokens``).
    """

    kmer_size = 5

    @staticmethod
    def _span_tokens(columns: np.ndarray, k: int) -> list:
        """The columns ``_indel_kmer_spans`` needs, in order, as a list
        (-1 read as None); it yields the same spans on them as on all.

        A span ends k positions into a window holding a None, so only
        columns near a None can be in one.  Past a None the window drops
        its None within k + 1 integers, and an integer run longer than
        k + 1 leaves the last k integers in it, so of each integer run
        the first 2k + 2 after a None and the last k + 1 before one are
        kept; a None run leaves the window as its first two Nones do.  A
        global record's long flanks (a read's leading and trailing
        deletions, a reference's unaligned ends) drop out.
        """
        none = columns < 0
        if not none.any():
            return []
        n = len(columns)
        idx = np.arange(n)
        last_none = np.maximum.accumulate(np.where(none, idx, -1))
        next_none = np.minimum.accumulate(np.where(none, idx, n)[::-1])[::-1]
        twice = none & np.r_[False, none][:n] & np.r_[False, False, none][:n]
        near = ((last_none >= 0) & (idx - last_none <= 2 * k + 2)) | (
            next_none - idx <= k + 1)
        keep = np.where(none, ~twice, near)
        return [None if v < 0 else v for v in columns[keep].tolist()]

    @staticmethod
    def _indel_kmer_spans(aligned: list, k: int):
        """Port of indelKmerFinder semantics (indelKmerAnalysis.py:11-19)."""
        window: list = []  # ordered unique values
        s = k + 1
        for value in aligned:
            if value not in window:
                window.append(value)
            if (
                window[0] is None
                or (len(window) == s and window[k] is None)
                or (None not in window and len(window) == s)
            ):
                window.pop(0)
            elif None in window and len(window) == s:
                yield (window[0], window[k])
                window.pop(0)

    def run(self) -> None:
        k = self.kmer_size
        data = ExperimentData(
            self.read_fastq_file, self.reference_fasta_file, self.sam_file
        )
        ref_counts: dict[tuple, int] = {}
        read_counts: dict[tuple, int] = {}

        def bump(d, key):
            d[key] = d.get(key, 0) + 1

        for rec in data.records:
            ref_seq = data.ref_seqs[rec.rname]
            read_seq = rec.query
            read_cols, ref_cols = rec.aligned_columns()
            read_aligned = self._span_tokens(read_cols, k)
            ref_aligned = self._span_tokens(ref_cols, k)
            for start, end in self._indel_kmer_spans(read_aligned, k):
                s = tuple(read_seq[start : end + 1])
                bump(read_counts, s)
                bump(ref_counts, s[::-1])
            for start, end in self._indel_kmer_spans(ref_aligned, k):
                s = tuple(ref_seq[start : end + 1])
                bump(ref_counts, s)
                bump(ref_counts, s[::-1])

        if not ref_counts or not read_counts:
            return
        ref_size = sum(ref_counts.values())
        read_size = sum(read_counts.values())
        name = "indel_bases_"
        table = self.out(name + "kmer_counts.txt")
        with open(table, "w") as fh:
            fh.write(
                "kmer\trefCount\trefFraction\treadCount\treadFraction\t"
                "logFoldChange\n"
            )
            for kmer_tuple in itertools.product("ATGC", repeat=k):
                rc = ref_counts.get(kmer_tuple, 0)
                qc = read_counts.get(kmer_tuple, 0)
                rf = rc / ref_size if ref_size else 0.0
                qf = qc / read_size if read_size else 0.0
                if rf == 0:
                    fold = "-Inf"
                elif qf == 0:
                    fold = "Inf"
                else:
                    fold = str(-np.log(qf / rf))
                fh.write(
                    "\t".join(
                        map(str, ["".join(kmer_tuple), rc, rf, qc, qf, fold])
                    )
                    + "\n"
                )
        from nanopore_tpu_torch.analyses import plots

        plots.kmer_significance(
            table,
            self.out(name + "pval_kmer_counts.txt"),
            self.out(name + "top_bot_sigkmer_counts.txt"),
            self.out(name + "volcano_plot.pdf"),
            "Indel_Kmer",
        )
