"""Host/device overlap: background preparation of device batches.

FASTQ streaming, seeding, packing and SAM writing must overlap the
card's kernels, or the mapper waits on its host stages.

``prefetched(thunks, depth)`` runs the thunk iterator on a background
thread, keeping up to ``depth`` prepared results queued while the caller
consumes them: batch i+1's host pack + upload overlaps batch i's kernel.
The consumer only ever touches completed results.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")
U = TypeVar("U")

_SENTINEL = object()


def default_pack_workers() -> int:
    """Worker count for prefetched_map: the host pack parallelism.

    At most four workers, fewer on hosts with fewer cores.
    """
    return max(1, min(4, os.cpu_count() or 1))


def prefetched_map(
    fn: Callable[[T], U],
    items: Iterable[T],
    depth: int = 2,
    workers: int | None = None,
) -> Iterator[U]:
    """Ordered parallel map with bounded lookahead.

    Like ``prefetched`` but the expensive per-item work (``fn``) runs on
    a POOL of worker threads instead of one: the host pack + upload of
    several batches proceed concurrently (numpy, the native
    seed/chain calls and torch copies release the GIL), which is what keeps multiple chips fed and the
    upload link busy while another batch packs.  Results are yielded in
    input order; at most ``depth + workers`` items are in flight.
    Cancellation mirrors ``prefetched``: abandoning the iterator stops
    the feeder and the pool.
    """
    workers = workers or default_pack_workers()
    if workers <= 1:
        return prefetched((fn(it) for it in items), depth=depth)

    def gen() -> Iterator[U]:
        task_q: queue.Queue = queue.Queue(maxsize=depth + workers)
        done: dict[int, object] = {}
        lock = threading.Condition()
        errs: list[BaseException] = []
        cancel = threading.Event()
        n_items = [None]  # total count, known once the feeder finishes

        def feeder():
            i = 0
            try:
                for it in items:
                    if cancel.is_set():
                        return
                    while not cancel.is_set():
                        try:
                            task_q.put((i, it), timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    i += 1
            except BaseException as exc:  # noqa: BLE001
                with lock:
                    errs.append(exc)
                    lock.notify_all()
            finally:
                with lock:
                    n_items[0] = i
                    lock.notify_all()
                for _ in range(workers):
                    while not cancel.is_set():
                        try:
                            task_q.put(_SENTINEL, timeout=0.1)
                            break
                        except queue.Full:
                            continue

        def worker():
            while not cancel.is_set():
                # backpressure on COMPLETED results: without this, a fast
                # fn (pack + async launch) runs ahead of the consumer and
                # the unbounded `done` dict accumulates the whole input
                # stream as launched device batches — busting the
                # documented "at most depth + workers in flight" bound
                # (each Prepared* pins large device tensors).  Wait until
                # the consumer drains below `depth` before taking work.
                with lock:
                    while len(done) >= depth and not cancel.is_set():
                        lock.wait(timeout=0.2)
                if cancel.is_set():
                    return
                try:
                    # timeout + re-check: when the consumer abandons the
                    # iterator mid-stream the feeder may exit before
                    # delivering every worker a sentinel — a bare get()
                    # would park this thread forever.
                    task = task_q.get(timeout=0.2)
                except queue.Empty:
                    continue
                if task is _SENTINEL:
                    return
                i, it = task
                try:
                    res = fn(it)
                except BaseException as exc:  # noqa: BLE001
                    with lock:
                        errs.append(exc)
                        lock.notify_all()
                    return
                with lock:
                    done[i] = res
                    lock.notify_all()

        threads = [
            threading.Thread(
                target=feeder, name="nanopore-prefetch-feed", daemon=True
            )
        ] + [
            threading.Thread(
                target=worker,
                name="nanopore-prefetch-%d" % w,
                daemon=True,
            )
            for w in range(workers)
        ]
        for t in threads:
            t.start()
        try:
            nxt = 0
            while True:
                with lock:
                    while (
                        nxt not in done
                        and not errs
                        and not (
                            n_items[0] is not None and nxt >= n_items[0]
                        )
                    ):
                        lock.wait(timeout=0.5)
                    if errs:
                        raise errs[0]
                    if n_items[0] is not None and nxt >= n_items[0]:
                        return
                    if nxt not in done:
                        continue
                    res = done.pop(nxt)
                    lock.notify_all()  # wake workers waiting on backpressure
                nxt += 1
                yield res
        finally:
            cancel.set()

    return gen()


def prefetched(
    thunks: Iterable[Callable[[], T]] | Iterator[T], depth: int = 2
) -> Iterator[T]:
    """Yield items of ``thunks`` with background preparation.

    ``thunks`` may be an iterator of zero-arg callables (each is called
    on the worker thread) or a generator whose ``next()`` itself does
    the expensive preparation — both run off the consumer thread.
    Exceptions on the worker re-raise at the consumption point.

    If the consumer abandons the generator (raises, breaks, or is
    garbage-collected), the worker is cancelled: it stops preparing new
    items and exits instead of blocking forever on a full queue holding
    device batches alive (long-lived pipeline processes otherwise leak
    a thread + queued device arrays per abandoned iteration).
    """
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    errs: list[BaseException] = []
    cancel = threading.Event()

    def put(item) -> bool:
        """Bounded put that gives up when the consumer cancelled."""
        while not cancel.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in thunks:
                if cancel.is_set():
                    return
                if callable(item):
                    item = item()
                if not put(item):
                    return
        except BaseException as exc:  # noqa: BLE001 — re-raised below
            errs.append(exc)
        finally:
            put(_SENTINEL)

    t = threading.Thread(
        target=worker, name="nanopore-prefetch", daemon=True
    )
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            yield item
        t.join()
        if errs:
            raise errs[0]
    finally:
        cancel.set()
