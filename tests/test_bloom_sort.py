"""Sort-based device BF build: equality with the round-3 scatter build,
superset of the host fill, threshold mixing, and the dmax fallback."""

import numpy as np
import pytest

from goldpolish_tpu import bf_builder
from goldpolish_tpu.ops import bloom, bloom_sort, nthash as nt

H = 4
CBF_BYTES = 1 << 20
BF_BYTES = 1 << 17


def _reads_cov(truth: bytes, cov: int, frag: int = 1500):
    reads = []
    for rep in range(cov):
        off = rep * (frag // max(cov, 1))
        reads.append(truth[: frag + 32])
        for s in range(off, len(truth), frag):
            reads.append(truth[s : s + frag + 32])
    return reads


def _host_fill(reads, thrs, ks):
    cbfs = [bloom.CountingBloomFilter8(CBF_BYTES, H, k) for k in ks]
    bfs = [bloom.BloomFilter(BF_BYTES, H, k) for k in ks]
    from goldpolish_tpu import native

    native.fill_bfs_stream(reads, thrs, H, ks, cbfs, bfs)
    return bfs


@pytest.mark.slow
def test_sorted_equals_scatter_build():
    rng = np.random.default_rng(0)
    truth = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 30000)].tobytes()
    reads = _reads_cov(truth, 6)
    ks = [32, 28]
    srt = bloom_sort.device_fill_bfs_sorted(
        reads, [5] * len(reads), ks, H, CBF_BYTES, BF_BYTES
    )
    old = bf_builder.device_fill_bfs(
        {5: reads}, ks, H, CBF_BYTES, BF_BYTES
    )
    for k, a, b in zip(ks, srt, old):
        assert bytes(a.array) == bytes(b.array), k


@pytest.mark.slow
def test_sorted_superset_of_host():
    rng = np.random.default_rng(1)
    truth = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 30000)].tobytes()
    reads = _reads_cov(truth, 6)
    ks = [32, 28]
    srt = bloom_sort.device_fill_bfs_sorted(
        reads, [5] * len(reads), ks, H, CBF_BYTES, BF_BYTES
    )
    host = _host_fill(reads, [5] * len(reads), ks)
    for k, d, hh in zip(ks, srt, host):
        assert np.all((hh.array & ~d.array) == 0), k
        extra = np.unpackbits(d.array & ~hh.array).sum()
        totalb = max(1, np.unpackbits(hh.array).sum())
        assert extra / totalb < 0.05, (k, extra, totalb)


@pytest.mark.slow
def test_sorted_mixed_thresholds_min_rule():
    """A k-mer covered by low- and high-threshold reads promotes at the
    smallest — equality with the scatter build's per-group union."""
    rng = np.random.default_rng(2)
    truth = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 12000)].tobytes()
    reads_lo = _reads_cov(truth[:8000], 5)
    reads_hi = _reads_cov(truth[4000:], 9)
    reads = reads_lo + reads_hi
    thrs = [4] * len(reads_lo) + [9] * len(reads_hi)
    ks = [32, 28]
    srt = bloom_sort.device_fill_bfs_sorted(reads, thrs, ks, H, CBF_BYTES,
                                            BF_BYTES)
    old = bf_builder.device_fill_bfs(
        {4: reads_lo, 9: reads_hi}, ks, H, CBF_BYTES, BF_BYTES
    )
    for k, a, b in zip(ks, srt, old):
        assert bytes(a.array) == bytes(b.array), k
    # sanity: the low-threshold region's truth k-mers are present
    region = truth[100:2000]
    base = nt.canonical_hashes(nt.encode(region), 32)
    hits = srt[0].contains(nt.multi_hashes(base, 32, H)).mean()
    assert hits > 0.95


def test_sorted_dmax_fallback_unique_kmers():
    """Coverage-1 random reads: nearly every k-mer distinct, so the n//4
    and n//2 dmax buckets overflow and the full-size variant runs."""
    rng = np.random.default_rng(3)
    reads = [
        np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 4000)].tobytes()
        for _ in range(4)
    ]
    ks = [32]
    srt = bloom_sort.device_fill_bfs_sorted(reads, [4] * 4, ks, H,
                                            CBF_BYTES, BF_BYTES)
    old = bf_builder.device_fill_bfs({4: reads}, ks, H, CBF_BYTES, BF_BYTES)
    assert bytes(srt[0].array) == bytes(old[0].array)


@pytest.mark.slow
def test_sorted_empty_read_does_not_corrupt_next_threshold():
    """A zero-length read with a HIGHER threshold must not raise the
    following read's effective threshold (zero-width spans collide with
    the next read's start tag in the fill-forward — review r4 finding)."""
    rng = np.random.default_rng(7)
    truth = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 6000)].tobytes()
    reads_real = _reads_cov(truth, 6)
    reads = [b""] + reads_real
    thrs = [13] + [5] * len(reads_real)
    srt = bloom_sort.device_fill_bfs_sorted(reads, thrs, [32], H,
                                            CBF_BYTES, BF_BYTES)
    old = bf_builder.device_fill_bfs({5: reads_real}, [32], H, CBF_BYTES,
                                     BF_BYTES)
    assert bytes(srt[0].array) == bytes(old[0].array)
    host = _host_fill(reads_real, [5] * len(reads_real), [32])
    assert np.all((host[0].array & ~srt[0].array) == 0)


@pytest.mark.slow
def test_sorted_packed_transfer_full_alphabet():
    """The 2-bit packed upload (+ exception scatter) is bit-exact with the
    raw-byte path for lowercase and non-ACGT bytes."""
    rng = np.random.default_rng(6)
    t = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 9000)].tobytes()
    # sprinkle lowercase + N + IUPAC into the reads
    tl = bytearray(t)
    for p in range(50, 8900, 137):
        tl[p] = ord("acgtNRYn"[p % 8])
    t2 = bytes(tl)
    reads = [t2[s : s + 1500 + 32] for s in range(0, 7500, 300)]
    ks = [32, 28]
    srt = bloom_sort.device_fill_bfs_sorted(
        reads, [4] * len(reads), ks, H, CBF_BYTES, BF_BYTES
    )
    old = bf_builder.device_fill_bfs({4: reads}, ks, H, CBF_BYTES, BF_BYTES)
    for k, a, b in zip(ks, srt, old):
        assert bytes(a.array) == bytes(b.array), k


@pytest.mark.slow
def test_sorted_randomized_soak():
    """Randomized read sets (mixed lengths incl. <k and empty, mixed
    thresholds, shared + unique content) stay bit-identical to the
    scatter build across several seeds."""
    for seed in range(4):
        rng = np.random.default_rng(100 + seed)
        base = np.frombuffer(b"ACGT", np.uint8)[
            rng.integers(0, 4, 4000)
        ].tobytes()
        reads, thrs, by_thresh = [], [], {}
        for _ in range(int(rng.integers(5, 25))):
            if rng.random() < 0.15:  # unique random read
                ln = int(rng.integers(0, 900))
                r = np.frombuffer(b"ACGT", np.uint8)[
                    rng.integers(0, 4, ln)
                ].tobytes()
            else:  # slice of the shared genome (coverage)
                a = int(rng.integers(0, 3500))
                r = base[a : a + int(rng.integers(10, 1200))]
            t = int(rng.integers(4, 14))
            reads.append(r)
            thrs.append(t)
            if r:
                by_thresh.setdefault(t, []).append(r)
        ks = [32, 28][: 1 + seed % 2]
        srt = bloom_sort.device_fill_bfs_sorted(reads, thrs, ks, H,
                                                CBF_BYTES, BF_BYTES)
        old = bf_builder.device_fill_bfs(by_thresh, ks, H, CBF_BYTES,
                                         BF_BYTES)
        for k, a, b in zip(ks, srt, old):
            assert bytes(a.array) == bytes(b.array), (seed, k)


def test_sorted_chunked_equals_single_dispatch():
    """The two-phase chunked build (stream > chunk_bases: per-chunk count
    accumulation + cross-chunk dedupe/promote) is bit-identical to the
    single-dispatch build.  chunk_bases forced tiny so several chunks run;
    the same code path handles the former 2^27-base cap's regime."""
    rng = np.random.default_rng(11)
    truth = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 9000)].tobytes()
    reads = _reads_cov(truth, 5)
    thrs = [5] * len(reads)
    ks = [32, 28]
    single = bloom_sort.device_fill_bfs_sorted(
        reads, thrs, ks, H, CBF_BYTES, BF_BYTES, chunk_bases=1 << 40
    )
    chunked = bloom_sort.device_fill_bfs_sorted(
        reads, thrs, ks, H, CBF_BYTES, BF_BYTES, chunk_bases=4096
    )
    for k, a, b in zip(ks, single, chunked):
        assert bytes(a.array) == bytes(b.array), k
        assert a.pop_count > 0


@pytest.mark.slow
def test_sorted_chunked_mixed_thresholds():
    """Cross-chunk min-threshold rule: a k-mer seen under a low threshold
    in one chunk and a high threshold in another promotes at the low one
    — equality with both the single dispatch and the scatter build."""
    rng = np.random.default_rng(12)
    truth = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 8000)].tobytes()
    reads_lo = _reads_cov(truth[:5000], 4)
    reads_hi = _reads_cov(truth[2500:], 8)
    reads = reads_lo + reads_hi
    thrs = [4] * len(reads_lo) + [9] * len(reads_hi)
    ks = [32, 28]
    single = bloom_sort.device_fill_bfs_sorted(
        reads, thrs, ks, H, CBF_BYTES, BF_BYTES, chunk_bases=1 << 40
    )
    chunked = bloom_sort.device_fill_bfs_sorted(
        reads, thrs, ks, H, CBF_BYTES, BF_BYTES, chunk_bases=3000
    )
    old = bf_builder.device_fill_bfs(
        {4: reads_lo, 9: reads_hi}, ks, H, CBF_BYTES, BF_BYTES
    )
    for k, a, b, c in zip(ks, single, chunked, old):
        assert bytes(a.array) == bytes(b.array), k
        assert bytes(a.array) == bytes(c.array), k


@pytest.mark.slow
def test_sorted_low_threshold_clamp():
    """Per-read thresholds 1..2 push the k32 effective threshold (thr - 2)
    to <= 0; the scatter build promotes any occurring k-mer there and the
    sorted build must match (an unclamped negative wrapped to ~2^32 via
    the uint32 sort key and inverted the min-threshold rule)."""
    rng = np.random.default_rng(13)
    truth = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 6000)].tobytes()
    reads = _reads_cov(truth, 3)
    for thr in (1, 2):
        srt = bloom_sort.device_fill_bfs_sorted(
            reads, [thr] * len(reads), [32, 28], H, CBF_BYTES, BF_BYTES
        )
        old = bf_builder.device_fill_bfs(
            {thr: reads}, [32, 28], H, CBF_BYTES, BF_BYTES
        )
        for k, a, b in zip([32, 28], srt, old):
            assert bytes(a.array) == bytes(b.array), (thr, k)
        assert srt[0].pop_count > 0  # unconditional promote actually fired
        # mixed with a high threshold: min rule still holds across groups
        thrs = [thr] * len(reads[:3]) + [9] * len(reads[3:])
        srt2 = bloom_sort.device_fill_bfs_sorted(
            reads, thrs, [32], H, CBF_BYTES, BF_BYTES
        )
        old2 = bf_builder.device_fill_bfs(
            {thr: reads[:3], 9: reads[3:]}, [32], H, CBF_BYTES, BF_BYTES
        )
        assert bytes(srt2[0].array) == bytes(old2[0].array), thr


def test_sorted_rejects_oversize_k():
    with pytest.raises(ValueError, match="k <= 33"):
        bloom_sort.device_fill_bfs_sorted(
            [b"A" * 100], [4], [40], H, CBF_BYTES, BF_BYTES
        )


@pytest.mark.slow
def test_sorted_edge_cases():
    # reads shorter than k contribute nothing; empty list yields empty BFs
    short = b"ACGTACGT"
    srt = bloom_sort.device_fill_bfs_sorted([short], [4], [32], H,
                                            CBF_BYTES, BF_BYTES)
    assert srt[0].pop_count == 0
    empty = bloom_sort.device_fill_bfs_sorted([], [], [32], H, CBF_BYTES,
                                              BF_BYTES)
    assert empty[0].pop_count == 0
    # k == KHALO + 1 boundary (largest supported halo)
    rng = np.random.default_rng(4)
    truth = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 5000)].tobytes()
    reads = _reads_cov(truth, 5)
    srt = bloom_sort.device_fill_bfs_sorted(reads, [4] * len(reads),
                                            [33], H, CBF_BYTES, BF_BYTES)
    old = bf_builder.device_fill_bfs({4: reads}, [33], H, CBF_BYTES, BF_BYTES)
    assert bytes(srt[0].array) == bytes(old[0].array)
    assert srt[0].pop_count > 0


@pytest.mark.slow
def test_sorted_default_chunking_at_production_size(monkeypatch):
    """Streams above DEFAULT_CHUNK_BASES take the chunked path by DEFAULT
    (chunk_bases=None).  The default is 2^25; it is patched to 2^23 here
    so that the CPU can hold the single-dispatch build of a stream above
    it (~10 Mb of reads).  Bits must equal an explicit single-dispatch
    build."""
    monkeypatch.delenv("GPTPU_SORT_CHUNK_BASES", raising=False)
    monkeypatch.setattr(bloom_sort, "DEFAULT_CHUNK_BASES", 1 << 23)
    rng = np.random.default_rng(21)
    truth = np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, bloom_sort.DEFAULT_CHUNK_BASES // 4)
    ].tobytes()
    reads = _reads_cov(truth, 5, frag=20_000)  # > DEFAULT_CHUNK_BASES
    total = sum(len(r) for r in reads)
    assert total > bloom_sort.DEFAULT_CHUNK_BASES  # actually exercises it
    thrs = [5] * len(reads)
    chunked = bloom_sort.device_fill_bfs_sorted(
        reads, thrs, [32], H, CBF_BYTES, 1 << 21
    )
    single = bloom_sort.device_fill_bfs_sorted(
        reads, thrs, [32], H, CBF_BYTES, 1 << 21, chunk_bases=1 << 40
    )
    assert bytes(chunked[0].array) == bytes(single[0].array)
    assert chunked[0].pop_count > 0
