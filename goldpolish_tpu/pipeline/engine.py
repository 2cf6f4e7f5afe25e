"""Single-process async batch engine.

Replaces the reference's process/FIFO runtime — the orchestrator that spawns
up to 200 batch-worker processes coordinated through named pipes and flock'd
counter files in /dev/shm (reference: scripts/goldpolish:446-583,
goldpolish_utils.py:59-157, goldpolish-polish-batch, goldpolish-reaper,
goldpolish-autoclean) — with asyncio stages inside one process:

 * batching: contigs are grouped like get_next_batch_of_contigs
   (reference: scripts/goldpolish:344-361) — by count (-b) or by total
   length with single-long-contig splitting out,
 * a bounded worker pool (semaphore instead of flock'd thread tokens),
 * an ordered writer: results are emitted strictly in batch order whatever
   order they finish (the reaper's contract, goldpolish-reaper:51-73),
 * checkpoint/resume: a manifest records finished batch ids so a preempted
   run (preemptible machines) can skip completed work — capability the
   reference lacks (SURVEY §5: restart = redo),
 * failure propagation: a failed batch cancels the run (watch_process
   semantics) and the workspace cleanup always runs (autocleaner semantics).
"""

from __future__ import annotations

import asyncio
import json
import os
import time
from dataclasses import dataclass
from typing import Awaitable, Callable, Iterable

from ..utils.log import get_logger

log = get_logger("engine")


@dataclass
class Batch:
    index: int
    records: list  # list[(header, seq)] or any payload


def make_batches(records: Iterable, batch_size: int, max_batch_bases: int | None = None):
    """Group records into batches.

    batch_size: number of contigs per batch (-b flag semantics,
    reference scripts/goldpolish:127-133,344-361).  When max_batch_bases is
    set, a batch also closes once its total sequence length exceeds it, and
    any single contig longer than the cap forms its own batch.
    """
    batch: list = []
    bases = 0
    index = 0
    for rec in records:
        seq_len = len(rec[1]) if isinstance(rec, tuple) else len(rec.seq)
        if batch and (
            len(batch) >= batch_size
            or (max_batch_bases is not None and bases + seq_len > max_batch_bases)
        ):
            yield Batch(index, batch)
            index += 1
            batch = []
            bases = 0
        batch.append(rec)
        bases += seq_len
    if batch:
        yield Batch(index, batch)


class CheckpointManifest:
    """Records completed batch indices for preemption-safe resume."""

    def __init__(self, path: str | None):
        self.path = path
        self.done: set[int] = set()
        if path and os.path.exists(path):
            with open(path) as f:
                for line in f:
                    try:
                        self.done.add(int(json.loads(line)["batch"]))
                    except (ValueError, KeyError):
                        continue
            if self.done:
                log.info("resuming: %d batches already complete", len(self.done))
        self._fh = open(path, "a") if path else None

    def mark(self, index: int, meta: dict | None = None) -> None:
        # idempotent: a re-polished batch (replay file vanished) must not
        # append a duplicate line — manifest line count == done-batch count
        if index in self.done:
            return
        self.done.add(index)
        if self._fh:
            rec = {"batch": index, "t": time.time()}
            if meta:
                rec.update(meta)
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def close(self) -> None:
        if self._fh:
            self._fh.close()


class OrderedWriter:
    """Emit results strictly in batch order (reaper semantics)."""

    def __init__(self, sink: Callable[[object], None]):
        self.sink = sink
        self._pending: dict[int, object] = {}
        self._next = 0

    def push(self, index: int, result) -> None:
        self._pending[index] = result
        while self._next in self._pending:
            self.sink(self._pending.pop(self._next))
            self._next += 1

    @property
    def flushed_through(self) -> int:
        return self._next


async def run_pipeline(
    batches: Iterable[Batch],
    worker: Callable[[Batch], Awaitable[object]],
    sink: Callable[[object], None],
    max_concurrent: int = 4,
    manifest: CheckpointManifest | None = None,
    skip_result: Callable[[Batch], object] | None = None,
):
    """Run `worker` over batches with bounded concurrency + ordered output.

    Results reach `sink` strictly in batch order.  Batches recorded complete
    in `manifest` are skipped (skip_result provides their replay value, e.g.
    re-reading the batch's checkpointed output file); a skip_result that
    returns None declines the skip (e.g. the file vanished) and the batch
    re-polishes.  The first worker exception cancels outstanding work and
    re-raises.
    """
    writer = OrderedWriter(sink)
    sem = asyncio.Semaphore(max_concurrent)
    results: asyncio.Queue = asyncio.Queue()
    batch_list = list(batches)

    async def run_one(b: Batch):
        async with sem:
            res = None
            if manifest and b.index in manifest.done and skip_result is not None:
                res = skip_result(b)
            if res is None:
                res = await worker(b)
                if manifest:
                    manifest.mark(b.index)
            await results.put((b.index, res, None))

    async def guard(b: Batch):
        try:
            await run_one(b)
        except Exception as e:  # noqa: BLE001 — propagate via queue
            await results.put((b.index, None, e))

    tasks = [asyncio.ensure_future(guard(b)) for b in batch_list]
    try:
        for _ in range(len(batch_list)):
            index, res, err = await results.get()
            if err is not None:
                raise err
            writer.push(index, res)
    finally:
        for t in tasks:
            t.cancel()
    return writer.flushed_through


class Workspace:
    """Scratch directory with guaranteed cleanup (autocleaner semantics,
    reference: scripts/goldpolish-autoclean:42-64).  Prefers /dev/shm like
    the reference (scripts/goldpolish:612-619).

    signal_safe=True additionally scrubs the workspace on SIGTERM / SIGINT /
    SIGHUP and at interpreter exit (the reference autocleaner registers
    TERM/INT/SEGV/PIPE + atexit) — without it, a kill mid-run leaks the
    /dev/shm directory.  The original signal disposition is restored and the
    signal re-delivered, so exit codes are unchanged.
    """

    def __init__(self, prefix: str, base: str | None = None, keep: bool = False,
                 signal_safe: bool = False):
        if base is None:
            base = "/dev/shm" if os.path.isdir("/dev/shm") and os.access(
                "/dev/shm", os.W_OK
            ) else "."
        self.dir = os.path.join(base, prefix)
        self.keep = keep
        self._restore: list = []
        self._owner_pid = os.getpid()
        os.makedirs(self.dir, exist_ok=True)
        if signal_safe:
            self._install_handlers()

    def _install_handlers(self) -> None:
        import atexit
        import signal

        atexit.register(self.cleanup)
        self._atexit_registered = True
        for sig in (signal.SIGTERM, signal.SIGINT, signal.SIGHUP):
            try:
                prev = signal.getsignal(sig)

                def handler(signum, frame, prev=prev):
                    self.cleanup()
                    try:
                        signal.signal(
                            signum,
                            prev if prev is not None else signal.SIG_DFL,
                        )
                    except (TypeError, ValueError):
                        signal.signal(signum, signal.SIG_DFL)
                    os.kill(os.getpid(), signum)  # re-deliver

                signal.signal(sig, handler)
                self._restore.append((sig, prev))
            except (ValueError, OSError):  # non-main thread / exotic env
                continue

    def path(self, *parts: str) -> str:
        return os.path.join(self.dir, *parts)

    def cleanup(self) -> None:
        # forked children inherit handlers/atexit; only the creator cleans
        if os.getpid() != self._owner_pid:
            return
        if getattr(self, "_atexit_registered", False):
            import atexit

            atexit.unregister(self.cleanup)
            self._atexit_registered = False
        if self._restore:
            import signal

            for sig, prev in self._restore:
                try:
                    signal.signal(sig, prev if prev is not None else signal.SIG_DFL)
                except (TypeError, ValueError, OSError):
                    pass
            self._restore = []
        if self.keep:
            return
        import shutil

        shutil.rmtree(self.dir, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.cleanup()
