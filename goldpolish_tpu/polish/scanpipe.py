"""Chunked, lookahead-pipelined device presence scans.

The dense detection scan (a Bloom probe of every draft window) runs on the
device as a short sequence of fixed-shape device programs (ops/scan_conv
fused hash+probe), dispatched ASYNCHRONOUSLY ahead of the consumer: while
the host walks the hot sites of the sequences already scanned (the sparse,
branchy phase B that belongs on the CPU), the device is already scanning
the next call.  Pipeline throughput is max(walk, device-scan) instead of
host-scan + walk.

Packing: every device call has ONE static shape [ROWS, ROW_BYTES].  Each
row is a dense byte stream of SEGMENTS — window ranges of the input jobs —
placed back to back; a segment covering windows [a, b) of a job contributes
bytes [a, b+k-1), so its presence bits are exact and stitch back
byte-identically to a whole-contig scan (window hashes read only their own
k bytes; the k-1 garbage windows spanning a segment boundary are sliced
off by the segment map).  This keeps call count ~ total_bases / call
capacity regardless of contig count or size — the per-call dispatch cost is
paid a handful of times per batch, and padding waste is at most one row.

Replaces the reference's one-rolling-probe-per-position inner loop
(reference: subprojects/ntedit/ntedit.cpp:1414-1486) as the production
device scan.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np

# Call shape and lookahead.  These values were not tuned on the GPU (they
# carry over unchanged; ROADMAP.md lists them for a perf PR).
ROWS = 4
ROW_WINDOWS = 1 << 19  # 512 K windows per row -> 2 M windows per call
DEPTH = 2  # calls in flight beyond the one being consumed


@dataclass
class _Seg:
    job: int
    w0: int     # first window of the job this segment covers
    nw: int     # windows in this segment
    row: int    # row within the call
    off: int    # byte offset within the row


@dataclass
class _Call:
    segs: list[_Seg] = field(default_factory=list)


class ScanPipe:
    """Runs fused device scans for a stream of byte-code jobs with lookahead.

    jobs: list of (job_id, codes uint8[n]).  `run()` yields
    (job_id, present bool[n-k+1]) in input order while later calls scan on
    the device in the background.
    """

    EXC_BUCKET = 256  # per-row non-ACGT exception slots in the packed path
    total_calls = 0  # device calls across all pipes (device-work evidence)

    def __init__(self, scanner, k: int, row_windows: int | None = None,
                 rows: int = ROWS, depth: int = DEPTH):
        self.scanner = scanner
        self.k = k
        # module-global default read at call time (tunable / patchable)
        self.row_windows = int(row_windows if row_windows is not None
                               else ROW_WINDOWS)
        self.rows = int(rows)
        self.depth = max(1, int(depth))
        self.row_bytes = self.row_windows + k - 1
        # 2-bit packed transfer (1/4 the wire bytes) when the native packer
        # is available; calls with exception-dense rows fall back to raw
        self._pack2 = None
        try:
            from .. import native

            native.lib()
            self._pack2 = native.pack2
        except Exception:  # noqa: BLE001
            pass
        # observability for adaptive placement: how often the consumer had
        # to wait on the device vs found the result already materialized
        self.waits = 0
        self.calls = 0
        self.wait_s = 0.0
        # wait excluding the first call, which bears XLA compile + device
        # warmup — the number adaptive placement should reason about
        self.wait_steady_s = 0.0

    # -- planning ---------------------------------------------------------
    def _call_rows(self, call_idx: int) -> int:
        """Ramp-up: the first calls are small so the first walk can start
        after ~one row's scan latency instead of a full call's."""
        return min(self.rows, 1 << call_idx)

    def _plan(self, jobs) -> list[_Call]:
        k = self.k
        calls: list[_Call] = [_Call()]
        row, off = 0, 0
        for ji, (_job_id, codes) in enumerate(jobs):
            nw = len(codes) - k + 1
            a = 0
            while a < nw:
                if off + k > self.row_bytes:  # no room for even one window
                    row += 1
                    off = 0
                    if row == self._call_rows(len(calls) - 1):
                        calls.append(_Call())
                        row = 0
                take = min(nw - a, self.row_bytes - off - (k - 1))
                calls[-1].segs.append(_Seg(ji, a, take, row, off))
                off += take + k - 1
                a += take
        return [c for c in calls if c.segs]

    def _dispatch(self, jobs, call: _Call, call_idx: int):
        rows = self._call_rows(call_idx)
        # pad with 'A' (not 0): padding windows are sliced off by the
        # segment map either way, but the 2-bit packer would book every
        # zero byte as a non-ACGT exception
        buf = np.full((rows, self.row_bytes), ord("A"), np.uint8)
        for s in call.segs:
            codes = jobs[s.job][1]
            buf[s.row, s.off : s.off + s.nw + self.k - 1] = codes[
                s.w0 : s.w0 + s.nw + self.k - 1
            ]
        self.calls += 1
        ScanPipe.total_calls += 1
        if getattr(self.scanner, "eval_enabled", False):
            # fused scan + site eval (raw transfer; the table d2h dwarfs
            # the packed-transfer savings at this call size)
            return self.scanner.scan_eval_packed(buf, self.k)
        if self._pack2 is not None:
            p4 = -(-self.row_bytes // 4)
            packed = np.zeros((rows, p4), np.uint8)
            exc_idx = np.full((rows, self.EXC_BUCKET), self.row_bytes, np.int64)
            exc_byte = np.zeros((rows, self.EXC_BUCKET), np.uint8)
            ok = True
            for r in range(rows):
                res = self._pack2(buf[r], self.EXC_BUCKET)
                if res is None:  # exception-dense row: raw transfer instead
                    ok = False
                    break
                packed[r], pos, byt = res[0], res[1], res[2]
                exc_idx[r, : len(pos)] = pos
                exc_byte[r, : len(byt)] = byt
            if ok:
                return self.scanner.scan_packed2(
                    packed, exc_idx, exc_byte, self.k, self.row_bytes
                )
        return self.scanner.scan_packed(buf, self.k)

    # -- execution --------------------------------------------------------
    def run(self, jobs):
        """Returns a generator of (job_id, present) in input order.

        The first `depth+1` device calls are dispatched EAGERLY (before the
        first next()), so a caller may start host work between run() and
        iteration with the device already scanning.
        """
        import time

        k = self.k
        jobs = list(jobs)
        calls = self._plan(jobs)
        inflight: deque = deque()
        state = {"pos": 0}

        def pump():
            while state["pos"] < len(calls) and len(inflight) < self.depth + 1:
                pos = state["pos"]
                inflight.append((calls[pos], self._dispatch(jobs, calls[pos], pos)))
                state["pos"] += 1

        pump()  # eager: the device is busy before the generator is consumed

        eval_mode = getattr(self.scanner, "eval_enabled", False)
        nw_row = self.row_windows

        def gen():
            first_wait = True
            parts: dict[int, list[np.ndarray]] = {}
            tab_parts: dict[int, list[tuple]] = {}
            done: dict[int, np.ndarray] = {}
            done_tabs: dict[int, tuple] = {}
            need = {
                ji: max(0, len(c) - k + 1) for ji, (_j, c) in enumerate(jobs)
            }
            next_ji = 0

            def assemble_tabs(ji: int):
                ps = tab_parts.pop(ji, [])
                if not ps:
                    return None
                cols = list(zip(*ps))
                return tuple(np.concatenate(c) for c in cols)

            def emit_ready():
                nonlocal next_ji
                while next_ji < len(jobs):
                    if need[next_ji] == 0:
                        out = (jobs[next_ji][0], np.zeros(0, bool))
                    elif next_ji in done:
                        out = (jobs[next_ji][0], done.pop(next_ji))
                    else:
                        return
                    if eval_mode:
                        yield (*out, done_tabs.pop(next_ji, None))
                    else:
                        yield out
                    next_ji += 1

            while inflight:
                call, fut = inflight.popleft()
                pump()  # keep the device queue full before blocking
                t0 = time.perf_counter()
                if eval_mode:
                    (packed, _n_sites, site, gate, sub_sup, del_sup,
                     ins_lane, ins_ok, ins_sup) = (np.asarray(x) for x in fut)
                    if site.ndim == 2:
                        # mesh-sharded call: site-ish outputs carry a
                        # leading shard axis with SHARD-ROW-LOCAL indices;
                        # merge into one globally-ascending site array
                        n_sh = site.shape[0]
                        rows_per = packed.shape[0] // n_sh
                        parts_i = []
                        keep_rows = []
                        for sh in range(n_sh):
                            v = site[sh][site[sh] >= 0]
                            parts_i.append(v + sh * rows_per * nw_row)
                            keep_rows.append(
                                np.arange(len(v)) + sh * site.shape[1]
                            )
                        rows_sel = np.concatenate(keep_rows).astype(np.int64)
                        site = np.concatenate(parts_i).astype(site.dtype)
                        gate = gate.reshape(-1, 4)[rows_sel]
                        sub_sup = sub_sup.reshape(-1, 4)[rows_sel]
                        del_sup = del_sup.reshape(
                            n_sh * del_sup.shape[1], -1
                        )[rows_sel]
                        ins_lane = ins_lane.reshape(-1)[rows_sel]
                        ins_ok = ins_ok.reshape(-1)[rows_sel]
                        ins_sup = ins_sup.reshape(
                            n_sh * ins_sup.shape[1], -1
                        )[rows_sel]
                else:
                    packed = np.asarray(fut)  # blocks for THIS call only
                dt = time.perf_counter() - t0
                self.wait_s += dt
                if not first_wait:
                    self.wait_steady_s += dt
                first_wait = False
                if dt > 0.002:
                    self.waits += 1
                bits = np.unpackbits(packed, axis=1, bitorder="little")
                if eval_mode:
                    valid = site[site >= 0]  # ascending prefix
                for s in call.segs:
                    parts.setdefault(s.job, []).append(
                        bits[s.row, s.off : s.off + s.nw].astype(bool)
                    )
                    if eval_mode:
                        # interior sites only (the drop rule: a device-
                        # evaluated site needs k+max_del suffix bytes inside
                        # its own segment; 2k covers every table consumer)
                        g0 = s.row * nw_row + s.off
                        lo = int(np.searchsorted(valid, g0))
                        hi = int(np.searchsorted(
                            valid, g0 + max(0, s.nw - 2 * k), side="right"
                        ))
                        if hi > lo:
                            wins = (valid[lo:hi] - g0 + s.w0).astype(np.int64)
                            # valid is the ascending PREFIX of site, so the
                            # table row of valid[j] is j itself
                            rows_i = np.arange(lo, hi)
                            tab_parts.setdefault(s.job, []).append((
                                wins, gate[rows_i], sub_sup[rows_i],
                                del_sup[rows_i], ins_lane[rows_i],
                                ins_ok[rows_i], ins_sup[rows_i],
                            ))
                    got = sum(len(p) for p in parts[s.job])
                    if got == need[s.job]:
                        ps = parts.pop(s.job)
                        done[s.job] = (
                            ps[0] if len(ps) == 1 else np.concatenate(ps)
                        )
                        if eval_mode:
                            done_tabs[s.job] = assemble_tabs(s.job)
                yield from emit_ready()
            yield from emit_ready()
            assert next_ji == len(jobs), "scan pipe under-delivered"

        return gen()
