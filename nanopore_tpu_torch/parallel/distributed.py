"""Multi-host runtime initialisation and host-sharded input streams.

Counterpart of ``nanopore_tpu/parallel/distributed.py`` on
``torch.distributed``.  It replaces the reference's cluster batch systems
(parasol / gridEngine over a shared filesystem, reference Makefile:2):
one process per host, reads streamed host-sharded, and the host-side
statistics of EM (5x5 + 5x16 expectation sums and a log-likelihood per
trial) and the skip decisions reduced across hosts.  The process group is
gloo over TCP: what crosses hosts is a few hundred float64 numbers on the
host, while each process runs the kernels on its own card(s).

Every collective here (``barrier``, ``coordinator_decision`` and the EM
reductions of ``parallel/sharded_em.py``) must be called from the main
thread, by every rank, in the same order: a collective issued from a
worker thread would reorder the global stream and deadlock.
"""

from __future__ import annotations

import datetime
import heapq
import logging
import os

import torch
import torch.distributed as dist

from nanopore_tpu_torch.io.sam import SamReader, SamWriter

logger = logging.getLogger("nanopore_tpu_torch")

# a peer that died or took another path fails the run after this long
# instead of hanging it
TIMEOUT = datetime.timedelta(minutes=30)


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> tuple[int, int]:
    """Join the gloo process group from arguments or the environment
    (``NANOPORE_TPU_COORDINATOR`` as ``host:port``,
    ``NANOPORE_TPU_NUM_PROCESSES``, ``NANOPORE_TPU_PROCESS_ID``, read as
    the JAX package reads them).

    Returns (process_index, process_count).  A no-op without a
    coordinator or with one process, and when the group already exists.
    """
    coordinator = coordinator_address or os.environ.get(
        "NANOPORE_TPU_COORDINATOR"
    )
    if num_processes is None:
        num_processes = int(os.environ.get("NANOPORE_TPU_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("NANOPORE_TPU_PROCESS_ID", "0"))
    if coordinator and num_processes > 1 and not dist.is_initialized():
        dist.init_process_group(
            "gloo",
            init_method="tcp://" + coordinator,
            world_size=num_processes,
            rank=process_id,
            timeout=TIMEOUT,
        )
        logger.info("distributed runtime: process %d/%d (gloo, %s)",
                    dist.get_rank(), dist.get_world_size(), coordinator)
    return process_info()


def process_info() -> tuple[int, int]:
    """(this process's rank, the number of processes); (0, 1) when no
    process group exists."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shutdown_distributed() -> None:
    """Leave the process group: ``destroy_process_group()`` when a group
    exists, nothing otherwise.  Whoever joined the group calls it after
    the last barrier (the multi-host ``run``, or a rank's own code
    around ``run_mapper(distributed=True)`` or sharded EM, which use the
    caller's group and leave it to the caller): a group left to the
    interpreter's exit can abort the process there, "terminate called
    without an active exception" (ROADMAP C13)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def is_coordinator() -> bool:
    return process_info()[0] == 0


def host_shard(items: list, process_index: int | None = None,
               process_count: int | None = None) -> list:
    """This host's strided shard of a work list (reads, experiments...).

    Strided rather than blocked so read-length skew balances across
    hosts without a length-sort pass.
    """
    pi, pc = process_info()
    pi = pi if process_index is None else process_index
    pc = pc if process_count is None else process_count
    return items[pi::pc]


def barrier(tag: str) -> None:
    """Cross-host sync point; no-op in single-process runs.

    The analogue of the reference's follow-on-target joins (jobTree
    setFollowOnTarget, e.g. utils.py:572).  Every rank must reach the same
    barriers in the same order: the tags are gathered from every rank and
    compared, and a mismatch raises on every rank (as the JAX package's
    ``sync_global_devices`` checks its name), then the ranks synchronise.
    """
    if process_info()[1] <= 1:
        return
    data = tag.encode()
    size = torch.tensor([len(data)], dtype=torch.int64)
    dist.all_reduce(size, op=dist.ReduceOp.MAX)
    mine = torch.zeros(int(size.item()), dtype=torch.uint8)
    mine[:len(data)] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    tags = [torch.empty_like(mine) for _ in range(process_info()[1])]
    dist.all_gather(tags, mine)
    names = [bytes(t.tolist()).rstrip(b"\0").decode() for t in tags]
    if any(name != tag for name in names):
        raise RuntimeError(
            "ranks reached different barriers: %s"
            % ", ".join("rank %d at %r" % rn for rn in enumerate(names))
        )
    dist.barrier()


def coordinator_decision(value: bool) -> bool:
    """Host 0's boolean, agreed by every host (skip/run consensus).

    Control decisions that depend on shared-filesystem state (e.g. "does
    mapping.sam already exist?") must not diverge across hosts: a host
    that skips a cooperative step while another enters its barriers
    deadlocks the collective stream.  Single-process: returns value.
    """
    if process_info()[1] <= 1:
        return value
    flag = torch.tensor([1 if value else 0], dtype=torch.int32)
    dist.broadcast(flag, src=0)
    return bool(flag.item())


def shard_paths(base_path: str, process_count: int | None = None) -> list[str]:
    pc = process_info()[1] if process_count is None else process_count
    return ["%s.shard%d" % (base_path, pi) for pi in range(pc)]


def merge_sam_shards(
    paths: list[str], output_path: str, order: str = "sorted"
) -> int:
    """Host-0 merge of per-host SAM shards into one file.

    ``order="sorted"``: records re-sorted by the deterministic
    SamRecord.sort_key — what map_fastq does single-host.
    ``order="interleave"``: round-robin by record across shards, which
    reconstructs the original list order when shard i held items
    [i::n] of an ordered record list (the realign case: one global
    record per (read, ref) in chained order).  Shard files are removed
    after the merge.  Returns the merged record count.

    Both orders stream: memory is O(shards), not O(records).  The sorted
    merge is a k-way heap merge relying on each shard being internally
    sorted by SamRecord.sort_key (map_fastq sorts before writing); shard
    order is verified while streaming and an unsorted shard falls back to
    an in-memory sort of that merge.
    """
    if order not in ("sorted", "interleave"):
        raise ValueError("unknown merge order %r" % order)
    readers = [SamReader(p) for p in paths]
    count = 0
    with SamWriter(output_path, template=readers[0]) as writer:
        if order == "interleave":
            # original index of shard i's j-th record is j*n + i, so
            # taking row j across shards in shard order reconstructs
            # list order
            live = [iter(r) for r in readers]
            while live:
                nxt = []
                for it in live:
                    rec = next(it, None)
                    if rec is not None:
                        writer.write(rec)
                        count += 1
                        nxt.append(it)
                live = nxt
        else:
            # same key map_fastq sorts with single-host; a read's
            # candidates all live in one shard (reads are sharded
            # whole), so the k-way merge reproduces single-host order
            def checked(reader):
                prev_key = None
                for rec in reader:
                    key = rec.sort_key()
                    if prev_key is not None and key < prev_key:
                        raise _UnsortedShard(reader.path)
                    prev_key = key
                    yield key, rec

            try:
                for _, rec in heapq.merge(
                    *(checked(r) for r in readers), key=lambda kr: kr[0]
                ):
                    writer.write(rec)
                    count += 1
            except _UnsortedShard:
                merged = [rec for r in readers for rec in r]
                merged.sort(key=lambda r: r.sort_key())
                writer._fh.seek(0)
                writer._fh.truncate()
                writer._fh.write("@HD\tVN:1.6\tSO:unknown\n")
                for line in readers[0].header_lines:
                    if not line.startswith("@HD"):
                        writer._fh.write(line + "\n")
                for rec in merged:
                    writer.write(rec)
                count = len(merged)
    for p in paths:
        try:
            os.remove(p)
        except OSError:  # pragma: no cover
            pass
    return count


class _UnsortedShard(Exception):
    pass
