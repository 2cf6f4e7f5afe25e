"""Per-batch targeted Bloom filter construction.

The in-process, async-friendly equivalent of the reference's
goldpolish-targeted-bfs FIFO server (reference:
src/goldpolish_targeted_bfs.cpp): for each target contig in a batch,

 1. cap the mapped-read count at trunc(len * subsample_per_10kbp / 10000)
    (reference :96-100 — note the size_t cast truncates, unlike the ceil in
    the minimizer filter),
 2. sort mapped reads by (mean phred desc, read id asc) (reference :108-115),
 3. compute the adaptive k-mer count threshold
    min(round(4.66943 + 2.11391e-7 * mapped_bases), 13) (reference :45-53),
 4. stream each chosen read's k-mers into one shared (counting BF -> plain
    BF) pair per k with the escalating per-k threshold (fill_bfs semantics,
    reference src/utils.cpp:96-123).

The fill uses the native C++ path when available (the hot loop), falling
back to the NumPy oracle.  Instead of the reference's /dev/shm BF files +
FIFO handshakes, the result is returned in memory (and convertible to device
words for the device editor).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .ops import bloom

# reference: src/goldpolish_targeted_bfs.cpp:45-53
KMER_THRESHOLD_A = 4.66943
KMER_THRESHOLD_B = 2.11391e-07
KMER_THRESHOLD_MAX = 13


def mappings_bases_to_kmer_threshold(mapped_bases: int) -> int:
    t = int(round(KMER_THRESHOLD_A + float(mapped_bases) * KMER_THRESHOLD_B))
    return min(t, KMER_THRESHOLD_MAX)


@dataclass
class BatchBFs:
    """The per-batch filters: one (CBF, BF) pair per k."""

    k_values: list[int]
    cbfs: list[bloom.CountingBloomFilter8]
    bfs: list[bloom.BloomFilter]

    def bf_for_k(self, k: int) -> bloom.BloomFilter:
        return self.bfs[self.k_values.index(k)]

    def save(self, prefix: str) -> list[str]:
        """Write '<prefix>-k<k>.bf' files (reference naming,
        goldpolish_targeted_bfs.cpp:214-218)."""
        paths = []
        for k, bf in zip(self.k_values, self.bfs):
            p = f"{prefix}-k{k}.bf"
            bf.save(p)
            paths.append(p)
        return paths


class BFBuilder:
    """Builds per-batch multi-k Bloom filters from mapped reads.

    `device_fills` counts completed device builds across all instances
    (device-work evidence for the chip smoke run)."""

    device_fills = 0

    def __init__(self, target_index, mapped_index, all_mappings, k_values,
                 hash_num: int = bloom.DEFAULT_HASH_NUM,
                 cbf_bytes: int = bloom.DEFAULT_CBF_BYTES,
                 bf_bytes: int = bloom.DEFAULT_BF_BYTES,
                 subsample_max_mapped_seqs_per_target_10kbp: float = 100.0,
                 use_native: bool = True, autoscale_bf: bool = True):
        self.target_index = target_index
        self.mapped_index = mapped_index
        self.all_mappings = all_mappings
        self.k_values = list(k_values)
        self.hash_num = hash_num
        self.cbf_bytes = cbf_bytes
        self.bf_bytes = bf_bytes
        self.subsample = subsample_max_mapped_seqs_per_target_10kbp
        self.autoscale_bf = autoscale_bf
        self._fill = None
        self._fill_stream = None
        if use_native:
            try:
                from . import native

                native.lib()
                self._fill = native.fill_bfs
                self._fill_stream = native.fill_bfs_stream
            except Exception:  # noqa: BLE001
                self._fill = None
        if self._fill is None:
            self._fill = bloom.fill_bfs

    def build_batch(self, target_ids: list[str]) -> BatchBFs:
        """serve_batch semantics (reference goldpolish_targeted_bfs.cpp:55-146).

        BF sizing: the reference uses a fixed 512 KiB
        (goldpolish_targeted_bfs.cpp:271), which overloads once a batch holds
        more than ~300 kbp of target sequence (>= ~10% false positives at 1
        Mbp — the editor then sees error k-mers as present and stops
        editing).  With autoscale_bf (default) the plain BF grows to ~16
        bits per expected distinct k-mer, power-of-two sized for the fast
        masked probe; set autoscale_bf=False for strict reference parity.
        """
        bf_bytes = self._batch_bf_bytes(target_ids)
        cbfs = [
            bloom.CountingBloomFilter8(self.cbf_bytes, self.hash_num, k)
            for k in self.k_values
        ]
        bfs = [
            bloom.BloomFilter(bf_bytes, self.hash_num, k)
            for k in self.k_values
        ]
        if self._fill_stream is not None:
            # whole batch in one native call: per-k OpenMP threads live
            # across all reads (vs one omp region per read) and the Python
            # per-read dispatch disappears — bit-identical filters
            reads: list[bytes] = []
            thresholds: list[int] = []
            for _tid, chosen, kmer_threshold in self._choose_reads(target_ids):
                for rid in chosen:
                    reads.append(self.mapped_index.get_seq(rid))
                    thresholds.append(kmer_threshold)
            if reads:
                self._fill_stream(
                    reads, thresholds, self.hash_num, self.k_values, cbfs, bfs
                )
            return BatchBFs(self.k_values, cbfs, bfs)
        for _target_id, chosen, kmer_threshold in self._choose_reads(target_ids):
            for rid in chosen:
                seq = self.mapped_index.get_seq(rid)
                codes = np.frombuffer(seq, np.uint8)
                self._fill(
                    codes, self.hash_num, self.k_values, kmer_threshold, cbfs, bfs
                )
        return BatchBFs(self.k_values, cbfs, bfs)

    def _batch_bf_bytes(self, target_ids: list[str]) -> int:
        bf_bytes = self.bf_bytes
        if self.autoscale_bf:
            total = sum(self.target_index.get_seq_len(t) for t in target_ids)
            while bf_bytes < total * 2:  # 2 bytes = 16 bits per expected k-mer
                bf_bytes *= 2
        return bf_bytes

    def _choose_reads(self, target_ids: list[str]):
        """Per-target (target_id, chosen_read_ids, kmer_threshold) with the
        reference's subsample rules (serve_batch,
        goldpolish_targeted_bfs.cpp:96-123): truncating per-10kbp cap,
        phred-desc/id-asc sort, adaptive threshold regression.  Shared by
        the host and device builds so the read sets cannot desynchronize."""
        out = []
        for target_id in target_ids:
            target_len = self.target_index.get_seq_len(target_id)
            mappings = self.all_mappings.get_mappings(target_id)
            if not mappings:
                continue
            num_max = int(float(target_len) * self.subsample / 10_000.0)
            num = min(len(mappings), num_max)
            by_phred = sorted(
                mappings,
                key=lambda rid: (-self.mapped_index.get_phred_avg(rid), rid),
            )
            chosen = by_phred[:num]
            mapped_bases = sum(self.mapped_index.get_seq_len(r) for r in chosen)
            kmer_threshold = mappings_bases_to_kmer_threshold(mapped_bases)
            if kmer_threshold <= 0:
                raise ValueError("k-mer threshold must be > 0")
            out.append((target_id, chosen, kmer_threshold))
        return out

    def build_batch_device(self, target_ids: list[str],
                           chunk_elems: int = 32_000_000) -> BatchBFs:
        """Fast-mode device BF build (sort-based, ops/bloom_sort).

        DEVIATION from the host/native fill (documented, like autoscale_bf):
        per-slot occurrence totals upper-bound conservative-update counts
        and promotion ignores occurrence order, so the resulting filter is
        a slight SUPERSET of the reference fill's (every host-promoted
        k-mer is device-promoted; a few extra k-mers near the threshold
        may join — drift quantified in tests/test_bf_builder_device.py).
        Use where the fill competes for host cores (or overlapped with host
        polish); the host path stays the exactness anchor.  A device
        failure raises — it never turns into a host fill here.  Each read promotes with ITS TARGET's adaptive threshold,
        matching the host fill's per-target semantics (shared
        _choose_reads — read sets cannot desynchronize).
        GPTPU_SCATTER_FILL=1 selects the round-3 scatter build (kept as a
        bit-identical reference implementation).
        """
        import os as _os

        bf_bytes = self._batch_bf_bytes(target_ids)
        if _os.environ.get("GPTPU_SCATTER_FILL"):
            by_thresh: dict[int, list[bytes]] = {}
            for _tid, chosen, kmer_threshold in self._choose_reads(target_ids):
                by_thresh.setdefault(kmer_threshold, []).extend(
                    self.mapped_index.get_seq(r) for r in chosen
                )
            bfs = device_fill_bfs(
                by_thresh, self.k_values, self.hash_num, self.cbf_bytes,
                bf_bytes, chunk_elems=chunk_elems,
            )
            return BatchBFs(self.k_values, [], bfs)
        from .ops import bloom_sort

        if any(k > bloom_sort.KHALO + 1 for k in self.k_values):
            raise ValueError(
                f"device BF build supports k <= {bloom_sort.KHALO + 1};"
                f" got {self.k_values} — use the host fill for larger k"
            )
        reads: list[bytes] = []
        thrs: list[int] = []
        for _tid, chosen, kmer_threshold in self._choose_reads(target_ids):
            for rid in chosen:
                reads.append(self.mapped_index.get_seq(rid))
                thrs.append(kmer_threshold)
        bfs = bloom_sort.device_fill_bfs_sorted(
            reads, thrs, self.k_values, self.hash_num, self.cbf_bytes,
            bf_bytes,
        )
        BFBuilder.device_fills += 1
        return BatchBFs(self.k_values, [], bfs)


def device_fill_bfs(reads_by_thresh: dict[int, list[bytes]],
                    k_values: list[int], hash_num: int, cbf_bytes: int,
                    bf_bytes: int, chunk_elems: int = 32_000_000
                    ) -> list[bloom.BloomFilter]:
    """Device Bloom-filter fill core (used by BFBuilder.build_batch_device
    and benchmarked standalone by bench.py's fill A/B).

    Two device passes per k over the reads: (1) scatter-add all k-mer
    occurrences into an int32 counter array, (2) promote k-mers whose min
    counter reaches the per-k escalating threshold into the bit array.
    Reads are hashed in padded [B, L] buckets of at most chunk_elems
    window-hash elements per pass; buckets upload once and are reused by
    both passes for every k.  Hashing uses the conv formulation
    (ops/scan_conv).  See build_batch_device for the (documented) superset
    deviation vs the host fill.
    """
    import jax
    import jax.numpy as jnp

    from .ops import bloom_jax, nthash_jax, scan_conv

    h = hash_num
    cbf_size = cbf_bytes  # one int32 counter per reference counter

    def count_chunk(counters, codes, lens, k: int):
        base = scan_conv.canonical_hashes_conv(codes, k)  # [B, nw]
        hashes = nthash_jax.multi_hashes(base, k, h)  # [B, nw, h]
        nw = base.shape[-1]
        valid = jnp.arange(nw)[None, :] <= (lens[:, None] - k)
        idx = (hashes.reshape(-1) % jnp.uint64(cbf_size)).astype(jnp.int32)
        idx = jnp.where(jnp.repeat(valid.reshape(-1), h), idx, cbf_size)
        return counters.at[idx].add(1, mode="drop")

    def promote_chunk(words, counters, codes, lens, k: int, thresh: int,
                      bits: int):
        base = scan_conv.canonical_hashes_conv(codes, k)
        hashes = nthash_jax.multi_hashes(base, k, h)
        nw = base.shape[-1]
        valid = jnp.arange(nw)[None, :] <= (lens[:, None] - k)
        cidx = (hashes % jnp.uint64(cbf_size)).astype(jnp.int32)
        counts = counters[cidx].min(axis=-1)
        promote = valid & (counts >= thresh)
        return words | bloom_jax.build_words(
            bits, hashes.reshape(-1, h), mask=promote.reshape(-1)
        )

    count_jit = jax.jit(count_chunk, static_argnums=(3,))
    promote_jit = jax.jit(promote_chunk, static_argnums=(4, 5, 6))
    bits = bf_bytes * 8

    def make_chunks(reads: list[bytes]) -> list[tuple]:
        # pad + upload once (sorted by length so buckets pad to their
        # own max, not the global one); reused by both passes, every k
        reads = sorted(reads, key=len)
        out: list[tuple] = []
        i = 0
        while i < len(reads):
            L = max(64, 1 << (len(reads[i]) - 1).bit_length())
            B = max(1, chunk_elems // (L * h))
            j = i
            grp = []
            while j < len(reads) and len(grp) < B and len(reads[j]) <= L:
                grp.append(reads[j])
                j += 1
            codes = np.zeros((len(grp), L), np.uint8)
            lens = np.zeros(len(grp), np.int32)
            for r, rd in enumerate(grp):
                codes[r, : len(rd)] = np.frombuffer(rd, np.uint8)
                lens[r] = len(rd)
            out.append((jnp.asarray(codes), jnp.asarray(lens)))
            i = j
        return out

    groups = [
        (thr, make_chunks(reads))
        for thr, reads in sorted(reads_by_thresh.items())
    ]
    bfs = []
    for ki, k in enumerate(k_values):
        counters = jnp.zeros(cbf_size, jnp.int32)
        for _thr, chunks in groups:
            for codes, lens in chunks:
                counters = count_jit(counters, codes, lens, k)
        words = jnp.zeros(bits // 32, jnp.uint32)
        for thr, chunks in groups:
            eff = thr - 2 + ki
            for codes, lens in chunks:
                words = promote_jit(words, counters, codes, lens, k, eff, bits)
        bf = bloom.BloomFilter(bf_bytes, h, k)
        bf.array[:] = np.asarray(words).view(np.uint8)
        bfs.append(bf)
    return bfs
