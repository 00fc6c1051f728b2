"""The unified seed -> chain -> banded-extend mapping engine.

Counterpart of ``nanopore_tpu/mapping/engine.py``.  One engine replaces
the reference's four-aligner zoo (bwa mem / lastal / lastz / blasr,
reference ``nanopore/mappers/*.py``): host-side k-mer seeding and anchor
chaining select candidate (ref window, strand) placements, and the
banded pair-HMM decode on the device produces the base-level
alignment: the posterior MEA (the fused realign and its walker) or, for
``decode="viterbi"``, the max-product Viterbi and its walker.  On a card
the batch pack, the decode and the walker are CUDA kernels; with
``device="cpu"`` their plain PyTorch versions run.

Per-aligner behaviour differences become config presets
(nanopore_tpu_torch.mapping.presets).
"""

from __future__ import annotations

import itertools

import numpy as np
from dataclasses import dataclass

from nanopore_tpu_torch.align.model import PairHmmModel
from nanopore_tpu_torch.io.encoding import encode, revcomp_codes
from nanopore_tpu_torch.io.sam import SamRecord, SamWriter, CIG
from nanopore_tpu_torch.io.seqio import fastq_read_raw
from nanopore_tpu_torch.mapping.index import KmerIndex
from nanopore_tpu_torch.mapping.chain import merge_hits_to_anchors, chain_anchors, Chain
from nanopore_tpu_torch.device import resolve_device
from nanopore_tpu_torch.ops.pack import check_band_width
from nanopore_tpu_torch.ops.pairhmm import make_kernel_params
from nanopore_tpu_torch.ops.dispatch import (
    PreparedRealign,
    PreparedViterbi,
    local_dp_devices,
    preferred_realign_batch_size,
    prepared_from_pairs,
)


class StageStats:
    """Cumulative per-stage host cost of the mapping pipeline.

    Thread-safe accumulator (the stages run concurrently on worker
    pools, so per-stage seconds are CPU-thread seconds — they can sum
    past wall time; ``wall`` is the map_fastq wall clock).  Cost: two
    perf_counter calls per stage call — noise against the
    milliseconds-per-batch stages being measured.  Snapshot with
    ``engine.stage_stats.snapshot()``.
    """

    def __init__(self):
        import threading

        self._lock = threading.Lock()
        self.seconds: dict[str, float] = {}
        self.calls: dict[str, int] = {}

    def add(self, stage: str, dt: float) -> None:
        with self._lock:
            self.seconds[stage] = self.seconds.get(stage, 0.0) + dt
            self.calls[stage] = self.calls.get(stage, 0) + 1

    def reset(self) -> None:
        with self._lock:
            self.seconds.clear()
            self.calls.clear()

    def snapshot(self) -> dict:
        with self._lock:
            return {
                k: {"seconds": round(v, 4), "calls": self.calls[k]}
                for k, v in sorted(self.seconds.items())
            }


def _next_pow2(x: int) -> int:
    return 1 << max(6, (x - 1).bit_length())


@dataclass
class MapperConfig:
    """Tunables of the unified engine (presets select these)."""

    k: int = 13
    max_occ: int = 256
    min_chain_score: float = 20.0
    max_chains_per_strand: int = 4
    secondary_ratio: float = 0.3  # keep secondaries >= ratio * best score
    best_n: int = 0  # >0: emit at most N records/read (blasr -bestn)
    band_width: int = 64
    window_pad: int = 64
    gap_gamma: float = 0.5
    match_gamma: float = 0.0
    batch_size: int | None = None  # None: ops.dispatch picks per kernel
    # sparse seeding: probe every seed_stride-th read k-mer (1 = every
    # k-mer).  Long noisy reads keep ample anchors at stride 2-4; the
    # k-mer index probe is the mapper's dominant host cost per read.
    seed_stride: int = 1
    max_ref_gap: int = 5000
    max_diag_drift: int = 500
    # extension decode: "viterbi" = single-pass max-product (the Viterbi
    # kernel and its walker, on the byte plane for a model in the
    # canonical fiveState structure, else on the full plane: any model
    # decodes); anything else = posterior MEA (the fused realign kernel)
    decode: str = "mea"
    # mixed-length batching policy: when set, candidates bucket by the
    # smallest bin >= n + m (their diagonal need) and each bucket runs
    # at exactly that diagonal count (k_max pinned to the bin), at the
    # cost of padded diagonals inside a bin.  None (default): per-batch
    # k_max tightened in 2048 steps (waste-optimal for
    # length-homogeneous workloads).  Bins must be multiples of 128.
    k_bins: tuple | None = None


@dataclass
class _Candidate:
    name: str
    strand: int  # 0 fwd, 1 rev
    contig: int
    window_start: int  # local coords on contig
    window_end: int
    guide: list[tuple[int, int]]
    read_codes: np.ndarray
    score: float
    primary: bool
    chain_s1: float = 0.0  # read's best chain score
    chain_s2: float = 0.0  # read's second-best chain score (0 if unique)


class MappingEngine:
    def __init__(
        self,
        ref_dict: dict[str, str],
        config: MapperConfig | None = None,
        model: PairHmmModel | None = None,
        index: KmerIndex | None = None,
        device=None,
    ):
        self.config = config or MapperConfig()
        # on the card the MEA decode serves widths 2 to 2048 and the
        # Viterbi 2 to 1024 (ROADMAP C10, C11): the decode names its path
        check_band_width(self.config.band_width, device, self.config.decode)
        # the card unless the caller asks for the CPU; raises when no
        # card is present
        self.device = resolve_device(device)
        self.ref_dict = ref_dict
        if index is not None:
            assert index.k == self.config.k
            self.index = index
        else:
            self.index = KmerIndex.build(
                ref_dict, k=self.config.k, max_occ=self.config.max_occ
            )
        self.params = make_kernel_params(model or PairHmmModel.default())
        # several local cards: batches round-robin over them, each packed
        # onto and decoded on its own card (itertools.count: _prepare_batch
        # runs on prefetch worker threads, and count().__next__ is atomic
        # under CPython)
        self._devices = local_dp_devices(self.device)
        self._batch_counter = itertools.count()
        self.stage_stats = StageStats()

    # ------------------------------------------------------------------ #
    def _candidates_for_read(
        self, name: str, seq: str
    ) -> list[_Candidate]:
        cfg = self.config
        codes_fwd = encode(seq)
        codes_rev = revcomp_codes(codes_fwd)
        m = len(codes_fwd)
        all_chains: list[tuple[Chain, int]] = []
        for strand, codes in ((0, codes_fwd), (1, codes_rev)):
            ref_pos, read_pos = self.index.lookup(
                codes, stride=cfg.seed_stride
            )
            anchors = merge_hits_to_anchors(ref_pos, read_pos, self.index.k)
            chains = chain_anchors(
                anchors,
                max_ref_gap=cfg.max_ref_gap,
                max_diag_drift=cfg.max_diag_drift,
                min_chain_score=cfg.min_chain_score,
                max_chains=cfg.max_chains_per_strand,
            )
            all_chains.extend((c, strand) for c in chains)
        if not all_chains:
            return []
        all_chains.sort(key=lambda cs: -cs[0].score)
        best_score = all_chains[0][0].score
        second_score = all_chains[1][0].score if len(all_chains) > 1 else 0.0
        keep = [
            (c, s)
            for c, s in all_chains
            if c.score >= cfg.secondary_ratio * best_score
        ]
        if cfg.best_n > 0:
            keep = keep[: cfg.best_n]

        out = []
        for rank, (chain, strand) in enumerate(keep):
            cidx_arr, local = self.index.global_to_contig(
                np.array([chain.r_start, chain.r_end - 1])
            )
            if cidx_arr[0] != cidx_arr[1]:
                continue  # chain crossing a contig boundary: drop
            cidx = int(cidx_arr[0])
            clen = self.index.contig_length(cidx)
            r0, r1 = int(local[0]), int(local[1]) + 1
            codes = codes_rev if strand else codes_fwd
            ws = max(0, r0 - chain.q_start - cfg.window_pad)
            we = min(clen, r1 + (m - chain.q_end) + cfg.window_pad)
            guide = self._guide_from_chain(chain, ws, m, we - ws)
            out.append(
                _Candidate(
                    name=name,
                    strand=strand,
                    contig=cidx,
                    window_start=ws,
                    window_end=we,
                    guide=guide,
                    read_codes=codes,
                    score=chain.score,
                    primary=rank == 0,
                    chain_s1=best_score,
                    chain_s2=second_score,
                )
            )
        return out

    def _guide_from_chain(
        self, chain: Chain, window_start: int, m: int, n: int
    ) -> list[tuple[int, int]]:
        """Monotone global guide cigar through the chain's anchor points."""
        offset = int(
            self.index.contig_offsets[
                self.index.global_to_contig(np.array([chain.r_start]))[0][0]
            ]
        )
        pts = [(0, 0)]
        for a in chain.anchors:
            q0, j0 = a.q_start, a.r_start - offset - window_start
            q1, j1 = a.q_end, a.r_end - offset - window_start
            if q0 > pts[-1][0] and j0 > pts[-1][1]:
                pts.append((q0, j0))
            if q1 > pts[-1][0] and j1 > pts[-1][1]:
                pts.append((q1, j1))
        if pts[-1] != (m, n):
            pts.append((m, n))
        cigar: list[tuple[int, int]] = []
        for (i0, j0), (i1, j1) in zip(pts, pts[1:]):
            di, dj = i1 - i0, j1 - j0
            assert di >= 0 and dj >= 0
            d = min(di, dj)
            if d:
                cigar.append((CIG.M, d))
            if di > d:
                cigar.append((CIG.I, di - d))
            if dj > d:
                cigar.append((CIG.D, dj - d))
        return cigar

    # ------------------------------------------------------------------ #
    def _bucket_key(self, n: int, m: int) -> tuple:
        """Shape bucket for a candidate: a fixed k-bin when
        config.k_bins is set (one diagonal count per bin), else the
        padded (n, m) pow2 pair (k_max tightened per batch)."""
        bins = self.config.k_bins
        if bins:
            need = n + m
            for b in sorted(bins):
                if need <= b:
                    return ("k", int(b))
            # overflow: fall through to the pow2 policy for outliers
        return ("p", _next_pow2(n), _next_pow2(m))

    def _align_candidates(
        self, cands: list[_Candidate], quals: dict[str, str]
    ) -> list[SamRecord]:
        """Batch candidates through the banded kernel, build SAM records."""
        cfg = self.config
        # bucket by shape so a batch's reads need similar diagonals
        buckets: dict[tuple, list[_Candidate]] = {}
        for c in cands:
            n = c.window_end - c.window_start
            m = len(c.read_codes)
            buckets.setdefault(self._bucket_key(n, m), []).append(c)

        bs = preferred_realign_batch_size(cfg.batch_size, self.device)
        results: list[tuple[_Candidate, SamRecord, float]] = []
        for key, group in buckets.items():
            for i in range(0, len(group), bs):
                sub = group[i : i + bs]
                results.extend(self._align_batch(sub, key, quals))
        by_read: dict[str, list[tuple[_Candidate, SamRecord, float]]] = {}
        for item in results:
            by_read.setdefault(item[0].name, []).append(item)
        records = []
        for items in by_read.values():
            self._assign_mapq(items)
            records.extend(rec for _, rec, _ in items)
        return records

    def _assign_mapq(
        self, items: list[tuple[_Candidate, SamRecord, float]]
    ) -> None:
        """Calibrated mapping quality for one read's placements.

        The reference emits the aligners' own MAPQs (e.g. ``bwa mem``,
        mappers/bwa.py:10); the unified engine derives one from the same
        two signals those aligners use, both already computed here:

        1. chain-score gap: ``60 * (1 - s2/s1)``, attenuated for weak
           absolute support (minimap2/bwa-mem construction), covering
           alternatives pruned before extension;
        2. pair-HMM placement posterior: softmax over the extended
           candidates' log-likelihoods (length-normalised to a common
           lattice size), giving P(primary placement), hence
           ``-10 log10(1 - p)``.

        The primary record gets ``min`` of the two, clipped to [0, 60];
        secondaries get 0 (SAM convention, as bwa emits).
        """
        import math

        primary_q = 0
        for c, _rec, _ll in items:
            if not c.primary:
                continue
            s1, s2 = c.chain_s1, c.chain_s2
            if s1 > 0:
                # min_chain_score <= 0 (fully permissive mapping) means
                # every chain has "full" support — avoid the zero divide
                support = min(
                    1.0, s1 / max(4.0 * self.config.min_chain_score, 1e-9)
                )
                primary_q = 60.0 * (1.0 - s2 / s1) * support
            if len(items) >= 2:
                lens = np.array(
                    [
                        len(it[0].read_codes)
                        + (it[0].window_end - it[0].window_start)
                        for it in items
                    ],
                    dtype=np.float64,
                )
                lls = np.array([it[2] for it in items], dtype=np.float64)
                lls = lls / lens * lens.mean()  # common-length scale
                p = np.exp(lls - lls.max())
                p /= p.sum()
                idx = next(
                    i for i, it in enumerate(items) if it[0] is c
                )
                q_hmm = -10.0 * math.log10(max(1.0 - float(p[idx]), 1e-7))
                primary_q = min(primary_q, q_hmm)
        for c, rec, _ll in items:
            rec.mapq = (
                int(max(0, min(60, round(primary_q)))) if c.primary else 0
            )

    def candidate_pairs(self, sub) -> list:
        """(ref window codes, read codes, guide cigar) per candidate."""
        return [
            (
                self.index.contig_codes(c.contig)[
                    c.window_start : c.window_end
                ],
                c.read_codes,
                c.guide,
            )
            for c in sub
        ]

    def _prepare_batch(self, sub, key):
        """Host pack, upload, pack kernel and decode launch (the realign,
        or the Viterbi for ``decode="viterbi"``) for one candidate batch
        (runs on a prefetch worker thread), on this batch's round-robin
        device.

        k_max is tightened to the batch's real diagonal need, or pinned
        to the bucket's k-bin.
        """
        cfg = self.config
        dev = self._devices[next(self._batch_counter) % len(self._devices)]
        if key[0] == "k":
            k_max, exact_k = key[1], True
        else:
            k_max, exact_k = key[1] + key[2], False
        if cfg.decode == "viterbi":
            cls, kwargs = PreparedViterbi, {"device": dev}
        else:
            cls, kwargs = PreparedRealign, {
                "gap_gamma": cfg.gap_gamma,
                "match_gamma": cfg.match_gamma,
                "device": dev,
            }
        prep = prepared_from_pairs(
            kwargs,
            self.candidate_pairs(sub),
            self.params,
            band_width=cfg.band_width,
            k_max=k_max,
            prepared_cls=cls,
            exact_k=exact_k,
        )
        return sub, prep.launch()

    def _align_batch(
        self, sub, key, quals
    ) -> list[tuple[_Candidate, SamRecord, float]]:
        _, prep = self._prepare_batch(sub, key)
        return self._consume_batch(sub, prep, quals)

    def _consume_batch(
        self, sub, prep, quals
    ) -> list[tuple[_Candidate, SamRecord, float]]:
        """Kernel + traceback + record construction for a prepared batch."""
        import time

        t0 = time.perf_counter()
        # the walk runs on the device too: only op codes and logliks (or
        # Viterbi scores) cross to the host; the MEA decode returns its
        # run output third
        logliks, cigars = prep.decode()[:2]
        t1 = time.perf_counter()
        self.stage_stats.add("decode_wait", t1 - t0)
        out = []
        for b, (c, cigar) in enumerate(zip(sub, cigars)):
            rec = self._record_from_window_cigar(c, cigar, quals)
            if rec is not None:
                out.append((c, rec, float(logliks[b])))
        self.stage_stats.add("record_build", time.perf_counter() - t1)
        return out

    def _record_from_window_cigar(
        self, c: _Candidate, cigar: list[tuple[int, int]], quals
    ) -> SamRecord | None:
        """Trim the global-in-window cigar to a local SAM record."""
        pos = c.window_start
        # leading: D advances pos, I becomes soft clip
        lead_clip = 0
        while cigar and cigar[0][0] in (CIG.D, CIG.I):
            op, length = cigar.pop(0)
            if op == CIG.D:
                pos += length
            else:
                lead_clip += length
        tail_clip = 0
        while cigar and cigar[-1][0] in (CIG.D, CIG.I):
            op, length = cigar.pop()
            if op == CIG.I:
                tail_clip += length
        if not cigar:
            return None
        full = []
        if lead_clip:
            full.append((CIG.S, lead_clip))
        full.extend(cigar)
        if tail_clip:
            full.append((CIG.S, tail_clip))

        from nanopore_tpu_torch.io.encoding import decode

        seq = decode(c.read_codes)
        qual = quals.get(c.name, "*")
        if c.strand and qual != "*":
            qual = qual[::-1]
        flag = 0x10 if c.strand else 0
        if not c.primary:
            flag |= 0x100
        return SamRecord(
            qname=c.name,
            flag=flag,
            rname=self.index.contig_names[c.contig],
            pos=pos,
            mapq=0,  # assigned by _assign_mapq once all placements exist
            cigar=full,
            seq=seq,
            qual=qual,
            tags=[("AS", "i", int(c.score))],
        )

    # ------------------------------------------------------------------ #
    def map_read(self, name: str, seq: str, qual: str = "*") -> list[SamRecord]:
        cands = self._candidates_for_read(name, seq)
        return self._align_candidates(cands, {name: qual})

    def map_fastq(
        self,
        fastq_path: str,
        output_sam_path: str,
        shard: tuple[int, int] | None = None,
    ) -> int:
        """Map a FASTQ file to SAM.  Returns the number of records written.

        Mirrors one ``mapper.run()`` of the reference (e.g.
        mappers/last.py:24-26): reads in, ``mapping.sam`` out, with @SQ
        lines for every reference contig.  ``shard=(i, n)`` maps only
        every n-th read starting at i.
        """
        import time

        from nanopore_tpu_torch.runtime.prefetch import prefetched_map

        cfg = self.config
        quals: dict[str, str] = {}

        def reads_stream():
            """FASTQ parse + qual capture (cheap, feeder thread): the
            phred STRING passes through untouched — the engine only
            re-emits it into the SAM record."""
            for ridx, (header, seq, qual) in enumerate(
                fastq_read_raw(fastq_path)
            ):
                if shard is not None and ridx % shard[1] != shard[0]:
                    continue
                name = header.split()[0]
                quals[name] = qual if qual else "*"
                yield name, seq

        def batch_descriptors():
            """Seed/chain on a WORKER POOL, bucketed into batches.

            Seed + chain is the pipeline's serial host stage once the
            pack is streamed; the native seedchain calls release the GIL
            (ctypes), so a small pool scales it across cores.  Buckets
            flush as they fill; the pack + upload + async kernel launch
            (_prepare_batch) runs on a SECOND prefetched_map pool so
            several batches pack/upload concurrently while earlier
            ones compute.
            """
            bs = preferred_realign_batch_size(cfg.batch_size, self.device)
            buckets: dict[tuple, list[_Candidate]] = {}

            def seed_one(it):
                t0 = time.perf_counter()
                out = self._candidates_for_read(*it)
                self.stage_stats.add(
                    "seed_chain", time.perf_counter() - t0
                )
                return out

            for cands in prefetched_map(
                seed_one,
                reads_stream(),
                depth=4 * bs,
            ):
                for c in cands:
                    n = c.window_end - c.window_start
                    m = len(c.read_codes)
                    key = self._bucket_key(n, m)
                    group = buckets.setdefault(key, [])
                    group.append(c)
                    if len(group) >= bs:
                        buckets[key] = []
                        yield group, key
            for key, group in buckets.items():
                for i in range(0, len(group), bs):
                    yield group[i : i + bs], key

        def full_batch(d):
            """Pack + launch + decode + record build, all on the worker
            pool: with N workers, N batches run their host stages in
            parallel while their kernels overlap on device — the main
            thread only collects, so no stage serialises on it.  Each
            worker's launches go to its current stream on the device."""
            t0 = time.perf_counter()
            sub, prep = self._prepare_batch(d[0], d[1])
            self.stage_stats.add(
                "pack_launch", time.perf_counter() - t0
            )
            return self._consume_batch(sub, prep, quals)

        wall0 = time.perf_counter()
        results: list[tuple[_Candidate, SamRecord, float]] = []
        for recs in prefetched_map(
            full_batch,
            batch_descriptors(),
            depth=max(2, len(self._devices) + 1),
        ):
            results.extend(recs)

        t_tail = time.perf_counter()
        by_read: dict[str, list] = {}
        for item in results:
            by_read.setdefault(item[0].name, []).append(item)
        records: list[SamRecord] = []
        for items in by_read.values():
            self._assign_mapq(items)
            records.extend(rec for _, rec, _ in items)
        records.sort(key=SamRecord.sort_key)
        ref_lengths = {
            name: len(seq) for name, seq in self.ref_dict.items()
        }
        with SamWriter(output_sam_path, ref_lengths) as writer:
            for rec in records:
                writer.write(rec)
        now = time.perf_counter()
        self.stage_stats.add("mapq_sort_write", now - t_tail)
        self.stage_stats.add("wall", now - wall0)
        return len(records)
