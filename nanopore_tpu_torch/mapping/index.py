"""Reference k-mer index: the seeding stage of the unified mapper.

Replaces the index structures of the four reference aligners (bwa's
FM-index, LAST/BLASR suffix arrays, lastz seed tables — reference
``nanopore/mappers/{bwa,last,lastz,blasr}.py``) with one sorted k-mer
table, built and searched by the native seed/chain runtime
(runtime/native_index.py).

Coordinates are global over the concatenated contigs; contigs are
separated by k-1 N sentinels so no k-mer spans a boundary.
"""

from __future__ import annotations

import numpy as np
from dataclasses import dataclass

from nanopore_tpu_torch.io.encoding import encode, BASE_N


@dataclass
class KmerIndex:
    k: int
    contig_names: list[str]
    contig_offsets: np.ndarray  # (C+1,) global start offsets
    ref_codes: np.ndarray  # (total,) int8 concatenated with sentinels
    sorted_kmers: np.ndarray  # (H,) int64 sorted kmer codes of kept positions
    sorted_positions: np.ndarray  # (H,) int32 global positions, kmer-sorted
    max_occ: int

    @staticmethod
    def build(
        ref_dict: dict[str, str], k: int = 13, max_occ: int = 256
    ) -> "KmerIndex":
        names = list(ref_dict.keys())
        sep = np.full(k - 1, BASE_N, np.int8)
        parts, offsets = [], [0]
        total = 0
        for i, name in enumerate(names):
            codes = encode(ref_dict[name])
            parts.append(codes)
            total += len(codes)
            offsets.append(total + (k - 1) * (i + 1))
            parts.append(sep)
        ref_codes = (
            np.concatenate(parts) if parts else np.empty(0, np.int8)
        )
        offsets = np.array(
            [0] + [offsets[i + 1] for i in range(len(names))], np.int64
        )

        from nanopore_tpu_torch.runtime import native_index

        sorted_kmers, sorted_positions = native_index.mask_repeats(
            *native_index.build_index(ref_codes, k), max_occ
        )

        return KmerIndex(
            k=k,
            contig_names=names,
            contig_offsets=offsets,
            ref_codes=ref_codes,
            sorted_kmers=sorted_kmers,
            sorted_positions=sorted_positions,
            max_occ=max_occ,
        )

    # ------------------------------------------------------------------ #
    def global_to_contig(self, gpos: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Global positions -> (contig index, local position)."""
        cidx = (
            np.searchsorted(self.contig_offsets, gpos, side="right") - 1
        ).clip(0, len(self.contig_names) - 1)
        return cidx, gpos - self.contig_offsets[cidx]

    def contig_length(self, cidx: int) -> int:
        end = self.contig_offsets[cidx + 1] if cidx + 1 < len(
            self.contig_offsets
        ) else len(self.ref_codes) + self.k - 1
        return int(end - self.contig_offsets[cidx] - (self.k - 1))

    def contig_codes(self, cidx: int) -> np.ndarray:
        start = int(self.contig_offsets[cidx])
        return self.ref_codes[start : start + self.contig_length(cidx)]

    # ------------------------------------------------------------------ #
    def lookup(
        self, read_codes: np.ndarray, stride: int = 1
    ) -> tuple[np.ndarray, np.ndarray]:
        """All seed hits of a read: (global ref positions, read positions).

        ``stride > 1`` probes only every stride-th read k-mer (sparse
        seeding — the standard long-read mapper trade; the chainer
        absorbs the anchor-density loss on multi-kb reads).
        """
        from nanopore_tpu_torch.runtime import native_index

        return native_index.lookup(
            self.sorted_kmers, self.sorted_positions, read_codes, self.k,
            stride=stride,
        )
