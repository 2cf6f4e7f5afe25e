"""Sort-based device Bloom-filter build — the scatter-light fill redesign.

The round-3 device fill (ops/bloom_jax scatter emulation driven by
bf_builder.device_fill_bfs) paid two N*h-scale scatter/gather passes per k
(N = window count, h = hash count; ~40 M elements at the bench batch
grain) plus a recompile storm from unpadded chunk shapes.  This build
produces the same bits with ONE fused dispatch per k whose heavy ops run
at N- or D-scale (D = distinct k-mers, typically N/coverage):

  1. conv-hash every window (ops/scan_conv formulation),
  2. 3-key sort (hash_hi, hash_lo, window threshold) — duplicates of a
     k-mer become adjacent, smallest applicable threshold first,
  3. run detection + run lengths via cumsum/slice arithmetic (no gathers),
  4. compact one representative per distinct k-mer (scatter-min),
  5. CBF-collision emulation at D-scale: weighted scatter-add of run
     counts into per-slot totals, gather the min over the h slots,
  6. promote distinct k-mers whose min slot total reaches their smallest
     threshold; set their bits (ops/bloom_jax.build_words).

Reads are packed host-side into a halo'd row grid ([R, ROW_NW + KHALO])
so every stream window appears exactly once and shapes come from a small
power-of-two bucket set (compile once per bucket, reuse forever — the
round-3 fill recompiled per batch).  Read boundaries and per-read
thresholds travel as a tiny offsets/thresholds upload and are expanded
on device with cumsum / segmented-scan tricks (no large gathers).

Exactness contract (unchanged from round 3): the host fill is the
anchor; this build produces BIT-IDENTICAL filters to the round-3 device
scatter build — a documented SUPERSET of the host fill:

  * per-slot totals count every occurrence at every slot, which
    upper-bounds btllib's conservative-update counts
    (reference: src/utils.cpp:96-123 semantics), and
  * a k-mer seen under several per-target thresholds promotes at the
    smallest (the host promotes only if the running count crosses a
    threshold in stream order).

Drift vs host is pinned by tests/test_bf_builder_device.py; equality vs
the round-3 scatter build by tests/test_bloom_sort.py.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from . import bloom_jax, nthash_jax, scan_conv

ROW_NW = 16384  # windows per packed row
KHALO = 32      # halo bases appended per row; supports any k <= KHALO + 1
MAX_THR = 15    # per-read thresholds must fit 4 bits (reference caps at 13)


# --------------------------------------------------------------------------
# host-side stream packing


class PackedReadStream:
    """Reads packed end-to-end into a halo'd row grid, one per batch.

    codes: uint8 [R, ROW_NW + KHALO] — row r covers stream positions
    [r*ROW_NW, r*ROW_NW + ROW_NW + KHALO); window (r, c) with c < ROW_NW
    is stream window r*ROW_NW + c, each exactly once.  R is padded to the
    next power of two (shape-bucketed compiles).  offsets: int32
    [n_reads + 1] stream start offsets; thrs: uint8 [n_reads] per-read
    promotion thresholds BEFORE the per-k escalation (the device kernel
    adds ki - 2).
    """

    def __init__(self, reads: list[bytes], thrs: list[int]):
        if len(reads) != len(thrs):
            raise ValueError("reads and thresholds must align")
        if not all(0 < t <= MAX_THR for t in thrs):
            # the device packs pos*16 + thr (_stream_meta); a threshold
            # outside 4 bits would silently corrupt the fill-forward
            raise ValueError(f"thresholds must be in 1..{MAX_THR}")
        # zero-length reads contribute no k-mers but their zero-width span
        # would collide with the NEXT read's start tag in the threshold
        # fill-forward (max of tied offsets wins) — drop them up front
        keep = [(r, t) for r, t in zip(reads, thrs) if len(r)]
        reads = [r for r, _ in keep]
        thrs = [t for _, t in keep]
        total = sum(len(r) for r in reads)
        rows = max(1, -(-total // ROW_NW))
        rows_padded = 1 << (rows - 1).bit_length()
        # one extra ROW_NW of padding (not just KHALO) so the device can
        # build the halo columns of EVERY row with plain reshapes of the
        # flat stream (see _stream_onehot_packed)
        buf = np.full(rows_padded * ROW_NW + ROW_NW, ord("A"), np.uint8)
        offsets = np.zeros(len(reads) + 1, np.int64)
        off = 0
        for i, r in enumerate(reads):
            buf[off : off + len(r)] = np.frombuffer(r, np.uint8)
            offsets[i] = off
            off += len(r)
        offsets[-1] = off
        self.buf = buf
        self.codes = np.lib.stride_tricks.as_strided(
            buf, (rows_padded, ROW_NW + KHALO), (ROW_NW, 1)
        )
        self.total = total
        self.rows = rows_padded
        self.offsets = offsets.astype(np.int32)
        self.thrs = np.asarray(thrs, np.uint8)
        self.n_windows = rows_padded * ROW_NW


# --------------------------------------------------------------------------
# device kernels


def _stream_meta(offsets, thrs, n_stream: int, k_pad: int):
    """Per-base read metadata, expanded on device from the tiny upload.

    Returns (cs, thr_base): cs int32 [n_stream + k_pad] inclusive cumsum
    of read-start indicators (window p stays within one read iff
    cs[p + k - 1] == cs[p] — both pure slices); thr_base int32
    [n_stream + k_pad] threshold of the read owning each base, via a
    position-tagged segmented cummax fill-forward (tag = pos*16 + thr,
    monotone in pos; thr < 16 guaranteed by PackedReadStream).  Tags are
    int64 (x64 is on package-wide) so stream length is not capped by the
    packing — the former 2^27-base bound came from int32 tags.
    """
    n = n_stream + k_pad
    bnd = jnp.zeros(n + 1, jnp.int32).at[offsets].add(1, mode="drop")[:n]
    cs = jnp.cumsum(bnd)
    ro = offsets[:-1].astype(jnp.int64)
    tags = jnp.zeros(n + 1, jnp.int64).at[offsets[:-1]].max(
        ro * 16 + thrs.astype(jnp.int64), mode="drop"
    )[:n]
    thr_base = (
        jax.lax.associative_scan(jnp.maximum, tags) & 15
    ).astype(jnp.int32)
    return cs, thr_base


_stream_meta_jit = jax.jit(_stream_meta, static_argnums=(2, 3))


_EXC_CAP = 8192  # non-ACGT positions carried alongside the packed upload


def _stream_onehot_packed(packed, exc_idx, exc_byte, R: int):
    """2-bit packed flat stream (+ exceptions) -> one-hot rows
    [R, ROW_NW + KHALO, 12] bf16, shared by every k's conv.

    The halo columns of row r are the first KHALO bases of row r+1's
    span, so both the main and halo parts are plain reshapes of the flat
    decoded bytes — no gathers, no strided views on device."""
    Lt = R * ROW_NW + ROW_NW
    x = scan_conv._codes_from_packed(
        packed[None, :], Lt, exc_idx[None, :], exc_byte[None, :]
    )
    main = x[:, : R * ROW_NW].reshape(R, ROW_NW)
    halo = x[:, ROW_NW : ROW_NW + R * ROW_NW].reshape(R, ROW_NW)[:, :KHALO]
    return scan_conv._onehot12(jnp.concatenate([main, halo], axis=1))


def _stream_onehot_raw(codes):
    """Raw byte rows fallback (exception-dense streams)."""
    return scan_conv._onehot12(codes)


_stream_onehot_packed_jit = jax.jit(_stream_onehot_packed,
                                    static_argnums=(3,))
_stream_onehot_raw_jit = jax.jit(_stream_onehot_raw)


def _distinct_runs(oh, cs, thr_base, total, k: int, thresh_delta: int,
                   dmax: int):
    """Shared core: hash every window, sort, compact one representative
    per distinct k-mer.  Returns (hv u64[dmax], cnt i32[dmax],
    th_r i32[dmax], live bool[dmax], n_runs).

    oh: one-hot rows [R, ROW_NW + KHALO, 12] (built once per batch,
    shared by every k).  total: traced scalar — stream length (padding
    windows past it are masked without a shape change).  thresh_delta:
    the per-k escalation ki - 2 (reference src/utils.cpp:105-107);
    effective thresholds clamp to >= 1 (an occurring k-mer always meets
    a <= 0 threshold — matching the scatter build's unconditional
    promote at eff <= 0; an unclamped negative wrapped to ~2^32 via the
    uint32 sort key and inverted the smallest-threshold-first rule).
    """
    R, Lr = oh.shape[0], oh.shape[1]
    nw = Lr - k + 1
    n_stream = R * ROW_NW
    fh, rh = scan_conv._strand_hashes_from_onehot(oh, k)
    base = fh + rh  # [R, nw] u64

    # validity + threshold per window, all via slices of the stream arrays
    cs0 = jax.lax.dynamic_slice(cs, (0,), (n_stream,)).reshape(R, ROW_NW)
    csk = jax.lax.dynamic_slice(cs, (k - 1,), (n_stream,)).reshape(R, ROW_NW)
    pos = (
        jnp.arange(R, dtype=jnp.int32)[:, None] * ROW_NW
        + jnp.arange(ROW_NW, dtype=jnp.int32)[None, :]
    )
    thr_w = jnp.maximum(
        jax.lax.dynamic_slice(thr_base, (0,), (n_stream,)).reshape(R, ROW_NW)
        + thresh_delta,
        1,
    )
    valid = (cs0 == csk) & (pos + k <= total)
    pad_cols = nw - ROW_NW
    if pad_cols:
        valid = jnp.pad(valid, ((0, 0), (0, pad_cols)))
        thr_w = jnp.pad(thr_w, ((0, 0), (0, pad_cols)), constant_values=255)
    thr_w = jnp.where(valid, thr_w, 255).astype(jnp.uint32)

    hashes = base.reshape(-1)
    vflat = valid.reshape(-1)
    hi = jnp.where(vflat, (hashes >> jnp.uint64(32)).astype(jnp.uint32),
                   jnp.uint32(0xFFFFFFFF))
    lo = jnp.where(vflat, hashes.astype(jnp.uint32), jnp.uint32(0xFFFFFFFF))
    hi_s, lo_s, th_s = jax.lax.sort((hi, lo, thr_w.reshape(-1)), num_keys=3)
    n = hi_s.shape[0]

    same = (hi_s[1:] == hi_s[:-1]) & (lo_s[1:] == lo_s[:-1])
    is_start = jnp.concatenate([jnp.ones(1, bool), ~same])
    ridx = jnp.cumsum(is_start.astype(jnp.int32)) - 1
    n_runs = ridx[-1] + 1

    # compact one representative per run: start position per run id
    tgt = jnp.where(is_start & (ridx <= dmax), ridx, dmax + 1)
    start = jnp.full(dmax + 2, n, jnp.int32).at[tgt].min(
        jnp.arange(n, dtype=jnp.int32), mode="drop"
    )
    cnt = start[1 : dmax + 1] - start[:dmax]  # run lengths, 0 for absent
    sp = jnp.minimum(start[:dmax], n - 1)
    th_r = th_s[sp].astype(jnp.int32)  # smallest threshold in the run
    hv = (hi_s[sp].astype(jnp.uint64) << jnp.uint64(32)) | lo_s[sp].astype(
        jnp.uint64
    )
    live = (th_r < 255) & (cnt > 0)
    return hv, cnt, th_r, live, n_runs


def _fill_k(oh, cs, thr_base, total, k: int, h: int, thresh_delta: int,
            cbf_size: int, bits: int, dmax: int):
    """One k's full single-dispatch build: (bf words u32[bits/32], n_runs)."""
    hv, cnt, th_r, live, n_runs = _distinct_runs(
        oh, cs, thr_base, total, k, thresh_delta, dmax
    )
    # CBF-collision emulation at D-scale (superset parity with the host
    # conservative-update counts — see module docstring)
    hs = nthash_jax.multi_hashes(hv, k, h)  # [dmax, h] u64
    slot = (hs % jnp.uint64(cbf_size)).astype(jnp.int32)
    slot = jnp.where(live[:, None], slot, cbf_size)
    totals = jnp.zeros(cbf_size + 1, jnp.int32).at[slot.reshape(-1)].add(
        jnp.repeat(cnt, h), mode="drop"
    )
    mins = totals[slot].min(axis=-1)
    promote = live & (mins >= th_r)
    words = bloom_jax.build_words(bits, hs, mask=promote)
    return words, n_runs


_fill_k_jit = jax.jit(_fill_k, static_argnums=(4, 5, 6, 7, 8, 9))


def _count_k(oh, cs, thr_base, total, totals, k: int, h: int,
             thresh_delta: int, cbf_size: int, dmax: int):
    """Chunked build phase A: accumulate this chunk's occurrence counts
    into the running per-slot totals and emit the chunk's distinct-k-mer
    representatives.  Returns (totals', hv u64[dmax], th i32[dmax],
    n_runs); dead lanes carry hv=~0, th=255.  Functional on totals —
    a dmax retry simply re-runs against the caller's original array."""
    hv, cnt, th_r, live, n_runs = _distinct_runs(
        oh, cs, thr_base, total, k, thresh_delta, dmax
    )
    hs = nthash_jax.multi_hashes(hv, k, h)  # [dmax, h] u64
    slot = (hs % jnp.uint64(cbf_size)).astype(jnp.int32)
    slot = jnp.where(live[:, None], slot, cbf_size)
    totals = totals.at[slot.reshape(-1)].add(
        jnp.repeat(cnt, h), mode="drop"
    )
    hv_out = jnp.where(live, hv, jnp.uint64(0xFFFFFFFFFFFFFFFF))
    th_out = jnp.where(live, th_r, 255)
    return totals, hv_out, th_out, n_runs


_count_k_jit = jax.jit(_count_k, static_argnums=(5, 6, 7, 8, 9))


def _promote_k(hv_all, th_all, totals, k: int, h: int, cbf_size: int,
               bits: int):
    """Chunked build phase B: dedupe representatives ACROSS chunks (sort
    brings duplicates adjacent, smallest threshold first — same rule as
    the in-chunk sort), then promote each distinct k-mer whose min slot
    total reaches its global smallest threshold.  Returns bf words."""
    hi = (hv_all >> jnp.uint64(32)).astype(jnp.uint32)
    lo = hv_all.astype(jnp.uint32)
    hi_s, lo_s, th_s = jax.lax.sort(
        (hi, lo, th_all.astype(jnp.uint32)), num_keys=3
    )
    same = (hi_s[1:] == hi_s[:-1]) & (lo_s[1:] == lo_s[:-1])
    is_start = jnp.concatenate([jnp.ones(1, bool), ~same])
    live = is_start & (th_s < 255)
    hv = (hi_s.astype(jnp.uint64) << jnp.uint64(32)) | lo_s.astype(jnp.uint64)
    hs = nthash_jax.multi_hashes(hv, k, h)
    slot = (hs % jnp.uint64(cbf_size)).astype(jnp.int32)
    slot = jnp.where(live[:, None], slot, cbf_size)
    mins = totals[slot].min(axis=-1)
    promote = live & (mins >= th_s.astype(jnp.int32))
    return bloom_jax.build_words(bits, hs, mask=promote)


_promote_k_jit = jax.jit(_promote_k, static_argnums=(3, 4, 5, 6))


def _stream_arrays(stream: PackedReadStream):
    """Upload one packed stream and expand its device arrays.

    Returns (oh, cs, thr_base, total).  2-bit packed transfer (4x smaller
    upload) when the native packer is available and the stream is not
    exception-dense; raw bytes otherwise.
    """
    oh = None
    try:
        from .. import native

        res = native.pack2(stream.buf, _EXC_CAP)
    except Exception:  # noqa: BLE001 — no native lib: raw transfer
        res = None
    if res is not None:
        packed, exc_pos, exc_byte = res
        Lt = len(stream.buf)
        exc_idx_a = np.full(_EXC_CAP, Lt, np.int64)
        exc_byte_a = np.zeros(_EXC_CAP, np.uint8)
        exc_idx_a[: len(exc_pos)] = exc_pos
        exc_byte_a[: len(exc_byte)] = exc_byte
        oh = _stream_onehot_packed_jit(
            jax.device_put(packed), jax.device_put(exc_idx_a),
            jax.device_put(exc_byte_a), stream.rows,
        )
    if oh is None:
        oh = _stream_onehot_raw_jit(
            jax.device_put(np.ascontiguousarray(stream.codes))
        )
    offsets = jax.device_put(stream.offsets)
    thrs_a = jax.device_put(stream.thrs)
    total = jnp.int32(stream.total)
    k_pad = KHALO + 1
    cs, thr_base = _stream_meta_jit(offsets, thrs_a, stream.n_windows, k_pad)
    return oh, cs, thr_base, total


# default chunk bound for the two-phase build (GPTPU_SORT_CHUNK_BASES
# overrides).  Results are bit-identical at any chunking, so only time
# decides; the working set is ~24 B/base (sort keys + one-hot rows).
# Chosen by measurement on an H100 at 400 W (PERF.md, fill-chunk finding),
# over one batch's ~20 Mbp read stream and 4 k, each size in a fresh
# process with no compile cache: cold (compile included) / warm median
# 118.7 / 0.80 s at 2^21, 133.1 / 0.40 s at 2^23, 70.3 / 0.56 s at 2^25
# (one dispatch for that stream).  2^25 costs least for a first run of
# ten such batches (cold + 9 warm); a warm cache would favour 2^23 after
# ~380 batches.  It still bounds the working set on larger streams.
DEFAULT_CHUNK_BASES = 1 << 25


def device_fill_bfs_sorted(reads: list[bytes], thrs: list[int],
                           k_values: list[int], hash_num: int,
                           cbf_bytes: int, bf_bytes: int,
                           chunk_bases: int | None = None):
    """Full multi-k device build from per-read thresholds.

    Returns list[bloom.BloomFilter] (no CBFs — the slot totals live only
    on device).  Bit-identical to the round-3 scatter build; a documented
    superset of the host fill (module docstring).

    Streams larger than chunk_bases run the two-phase chunked build:
    phase A accumulates per-slot occurrence totals chunk by chunk
    (_count_k, chunks split at read boundaries so no window spans two),
    phase B dedupes the chunk representatives and promotes against the
    GLOBAL totals (_promote_k) — bit-identical to the single-dispatch
    build (pinned by tests/test_bloom_sort.py), so stream size is
    unbounded (the former 2^27-base int32-tag cap is gone).
    """
    import os as _os

    from . import bloom

    if any(k > KHALO + 1 for k in k_values):
        raise ValueError(
            f"sorted device build supports k <= {KHALO + 1}"
            f" (KHALO + 1); got {k_values}"
        )
    if not reads:
        return [bloom.BloomFilter(bf_bytes, hash_num, k) for k in k_values]
    # per-slot occurrence totals are int32; a stream this large could in
    # principle alias > 2^31 occurrences into one slot and wrap it
    # negative, silently DEMOTING a frequent k-mer (breaking the
    # superset-of-host contract).  Explicit error beats silent blindness.
    if sum(len(r) for r in reads) >= (1 << 31):
        raise ValueError(
            "read stream >= 2^31 bases: int32 slot totals could overflow;"
            " split the batch"
        )
    if chunk_bases is None:
        chunk_bases = int(_os.environ.get(
            "GPTPU_SORT_CHUNK_BASES", DEFAULT_CHUNK_BASES
        ))
    bits = bf_bytes * 8
    total_bases = sum(len(r) for r in reads)

    if total_bases <= chunk_bases:
        stream = PackedReadStream(reads, thrs)
        oh, cs, thr_base, total = _stream_arrays(stream)
        bfs = []
        for ki, k in enumerate(k_values):
            n = stream.rows * (ROW_NW + KHALO - k + 1)
            words = None
            for dmax in (max(1024, n // 4), max(1024, n // 2), n):
                w, n_runs = _fill_k_jit(
                    oh, cs, thr_base, total, k, hash_num, ki - 2,
                    cbf_bytes, bits, dmax,
                )
                if int(n_runs) <= dmax:
                    words = w
                    break
            assert words is not None  # dmax == n always fits
            bf = bloom.BloomFilter(bf_bytes, hash_num, k)
            bf.array[: bits // 8] = np.asarray(words).view(np.uint8)
            bfs.append(bf)
        return bfs

    # ---- chunked two-phase build ----
    groups: list[tuple[list[bytes], list[int]]] = []
    cur_r: list[bytes] = []
    cur_t: list[int] = []
    cur_n = 0
    for r, t in zip(reads, thrs):
        if cur_n and cur_n + len(r) > chunk_bases:
            groups.append((cur_r, cur_t))
            cur_r, cur_t, cur_n = [], [], 0
        cur_r.append(r)
        cur_t.append(t)
        cur_n += len(r)
    if cur_r:
        groups.append((cur_r, cur_t))

    totals = {k: jnp.zeros(cbf_bytes + 1, jnp.int32) for k in k_values}
    reps: dict[int, list] = {k: [] for k in k_values}
    for g_reads, g_thrs in groups:
        stream = PackedReadStream(g_reads, g_thrs)
        oh, cs, thr_base, total = _stream_arrays(stream)
        for ki, k in enumerate(k_values):
            n = stream.rows * (ROW_NW + KHALO - k + 1)
            placed = False
            for dmax in (max(1024, n // 4), max(1024, n // 2), n):
                t2, hv, th, n_runs = _count_k_jit(
                    oh, cs, thr_base, total, totals[k], k, hash_num,
                    ki - 2, cbf_bytes, dmax,
                )
                nr = int(n_runs)
                if nr <= dmax:
                    totals[k] = t2
                    # keep only the live prefix, power-of-two padded so
                    # phase B shapes bucket (runs occupy ids [0, n_runs))
                    p = min(dmax, 1 << (max(nr, 1) - 1).bit_length())
                    reps[k].append((hv[:p], th[:p]))
                    placed = True
                    break
            assert placed  # dmax == n always fits
    bfs = []
    for k in k_values:
        hv_all = jnp.concatenate([h_ for h_, _ in reps[k]])
        th_all = jnp.concatenate([t_ for _, t_ in reps[k]])
        m = hv_all.shape[0]
        mp = 1 << (m - 1).bit_length()
        if mp != m:
            hv_all = jnp.pad(
                hv_all, (0, mp - m),
                constant_values=np.uint64(0xFFFFFFFFFFFFFFFF),
            )
            th_all = jnp.pad(th_all, (0, mp - m), constant_values=255)
        words = _promote_k_jit(
            hv_all, th_all, totals[k], k, hash_num, cbf_bytes, bits
        )
        bf = bloom.BloomFilter(bf_bytes, hash_num, k)
        bf.array[: bits // 8] = np.asarray(words).view(np.uint8)
        bfs.append(bf)
    return bfs
