"""ops/scan_conv: conv-hash + fused gather scan vs the scalar ntHash oracle."""

import numpy as np
import pytest

from goldpolish_tpu.ops import bloom, nthash as nt

sc = pytest.importorskip("goldpolish_tpu.ops.scan_conv")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def _rand_codes(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].copy()


@pytest.mark.parametrize("k", [20, 24, 28, 32, 55, 64])
def test_conv_hash_matches_oracle(k):
    codes = _rand_codes(500, seed=k)
    got = np.asarray(
        jax.jit(sc.canonical_hashes_conv, static_argnums=1)(codes[None], k)
    )[0]
    want = nt.canonical_hashes(codes, k)
    assert np.array_equal(got, want)


def test_conv_hash_full_alphabet():
    """Lowercase, IUPAC, N and arbitrary bytes hash exactly like the oracle
    (the 12-channel one-hot carries all information the seed tables read)."""
    raw = (b"ACGTacgtNnYyRrWwSsKkMmBbDdHhVv" + bytes(range(33, 127))) * 6
    codes = np.frombuffer(raw, np.uint8)
    got = np.asarray(
        jax.jit(sc.canonical_hashes_conv, static_argnums=1)(codes[None], 32)
    )[0]
    want = nt.canonical_hashes(codes, 32)
    assert np.array_equal(got, want)


def test_conv_strand_hashes_match():
    codes = _rand_codes(300, seed=3)
    fh, rh = jax.jit(sc.strand_hashes_conv, static_argnums=1)(codes[None], 32)
    assert np.array_equal(np.asarray(fh)[0], nt.forward_hashes(codes, 32))
    assert np.array_equal(np.asarray(rh)[0], nt.reverse_hashes(codes, 32))


def _bf_with(codes, k, h, bf_bytes=1 << 16):
    bf = bloom.BloomFilter(bf_bytes, h, k)
    hashes = nt.multi_hashes(nt.canonical_hashes(codes, k), k, h)
    bf.insert(hashes[::3])
    return bf, bf.contains(hashes)


def test_device_scanner_parity():
    k, h = 32, 4
    codes = _rand_codes(4000, seed=7)
    bf, want = _bf_with(codes, k, h)
    scanner = sc.DeviceScanner(bf)
    packed = np.asarray(scanner.scan_packed(codes, k))
    pres = scanner.unpack_present(packed[0], len(codes) - k + 1)
    assert np.array_equal(pres, want)


def test_device_scanner_non_pow2_filter():
    """A filter whose bit count is not a power of two indexes with the
    full u64 hash % bits (the low 32 bits alone are not enough), through
    both the raw and the 2-bit packed transfer."""
    from goldpolish_tpu import native

    k, h = 32, 4
    codes = _rand_codes(5000, seed=19)
    bf, want = _bf_with(codes, k, h, bf_bytes=3 * 1000 + 4)
    assert int(bf.bits) & (int(bf.bits) - 1)
    scanner = sc.DeviceScanner(bf)
    got = scanner.unpack_present(np.asarray(scanner.scan_packed(codes, k))[0],
                                 len(codes) - k + 1)
    assert np.array_equal(got, want)
    packed, pos, byt = native.pack2(codes, 64)
    exc_idx = np.full((1, 64), len(codes), np.int64)
    exc_byte = np.zeros((1, 64), np.uint8)
    exc_idx[0, : len(pos)] = pos
    exc_byte[0, : len(byt)] = byt
    out = scanner.scan_packed2(packed[None], exc_idx, exc_byte, k, len(codes))
    assert np.array_equal(scanner.unpack_present(np.asarray(out)[0],
                                                 len(codes) - k + 1), want)


def test_scanpipe_multi_chunk_stitching():
    """Chunked scans stitch byte-identically to a whole-contig scan."""
    from goldpolish_tpu.polish.scanpipe import ScanPipe

    k, h = 32, 3
    codes = _rand_codes(5000, seed=11)
    bf, want = _bf_with(codes, k, h)
    scanner = sc.DeviceScanner(bf)
    pipe = ScanPipe(scanner, k, row_windows=700, rows=2, depth=2)
    jobs = [(0, codes), (1, codes[:10]), (2, codes[100:2100])]
    got = dict(pipe.run(jobs))
    assert np.array_equal(got[0], want)
    assert got[1].size == 0
    want2 = bf.contains(
        nt.multi_hashes(nt.canonical_hashes(codes[100:2100], k), k, h)
    )
    assert np.array_equal(got[2], want2)


@pytest.mark.slow
def test_pipelined_polish_many_matches_numpy():
    """Hybrid polish_many (scanner + pipeline) is byte-identical to the
    numpy backend, serial and fork-pool, incl. a sharded long contig."""
    from goldpolish_tpu.polish import ntedit_oracle as ne
    from goldpolish_tpu.polish.ntedit_tpu import NtEditTPU

    rng = np.random.default_rng(5)
    k, h = 32, 4
    truth = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 30000)].copy()
    bf = bloom.BloomFilter(1 << 18, h, k)
    bf.insert(nt.multi_hashes(nt.canonical_hashes(truth, k), k, h))
    drafts = []
    for lo, hi in ((0, 9000), (9000, 12000), (12000, 30000)):
        d = bytearray(truth[lo:hi].tobytes())
        for p in range(300, len(d) - 300, 900):
            d[p] = ord("A") if d[p] != ord("A") else ord("G")
        drafts.append(bytes(d))
    cfg = ne.Config(k=k, h=h, use_ratio=True, mode=1, mask=1)
    want = [
        NtEditTPU(cfg, bf, backend="numpy").polish_contig(d)[0] for d in drafts
    ]
    import os

    os.environ["GPTPU_FORCE_DEVICE_SCAN"] = "1"
    try:
        eng = NtEditTPU(cfg, bf, backend="hybrid")
        assert eng._scanner is None  # lazy: no upload until device use
        eng._ensure_scanner()
        assert eng._scanner is not None
        got_serial = eng.polish_many(drafts)
        assert [o for o, _r, _e in got_serial] == want
        got_pool = eng.polish_many(drafts, processes=2, shard_bases=8000)
        assert [o for o, _r, _e in got_pool] == want
    finally:
        os.environ.pop("GPTPU_FORCE_DEVICE_SCAN", None)


def test_packed2_scan_parity_full_alphabet():
    """The 2-bit packed-transfer scan (gp_pack2 + exception scatter) is
    bit-identical to the raw scan for sequences with lowercase, IUPAC and N
    bytes."""
    from goldpolish_tpu import native

    try:
        native.lib()
    except Exception:
        pytest.skip("native lib unavailable")
    k, h = 32, 4
    rng = np.random.default_rng(31)
    codes = _rand_codes(3000, seed=31).copy()
    # sprinkle exceptions: lowercase (packable), N/IUPAC (exceptions)
    for p in range(100, 2800, 173):
        codes[p] = ord("NnYRWSkm"[p % 8])
    for p in range(150, 2800, 311):
        codes[p] = ord("acgt"[p % 4])
    bf, want = _bf_with(codes, k, h)
    res = native.pack2(codes, 64)
    assert res is not None
    packed, pos, byt = res
    E = 64
    exc_idx = np.full((1, E), len(codes), np.int64)
    exc_byte = np.zeros((1, E), np.uint8)
    exc_idx[0, : len(pos)] = pos
    exc_byte[0, : len(byt)] = byt
    scanner = sc.DeviceScanner(bf)
    out = np.asarray(scanner.scan_packed2(
        packed[None], exc_idx, exc_byte, k, len(codes)
    ))
    pres = scanner.unpack_present(out[0], len(codes) - k + 1)
    assert np.array_equal(pres, want)
    # overflow: > cap exceptions returns None (caller falls back to raw)
    noisy = np.full(1000, ord("N"), np.uint8)
    assert native.pack2(noisy, 64) is None


def test_scanpipe_packed_transfer_matches_raw():
    """ScanPipe with the packed transfer stitches identically to raw."""
    from goldpolish_tpu.polish.scanpipe import ScanPipe

    k, h = 32, 3
    codes = _rand_codes(4000, seed=13).copy()
    codes[500] = ord("N")
    codes[1500] = ord("y")
    bf, want = _bf_with(codes, k, h)
    scanner = sc.DeviceScanner(bf)
    pipe = ScanPipe(scanner, k, row_windows=900, rows=2)
    got = dict(pipe.run([(0, codes)]))
    assert np.array_equal(got[0], want)
    pipe_raw = ScanPipe(scanner, k, row_windows=900, rows=2)
    pipe_raw._pack2 = None
    got_raw = dict(pipe_raw.run([(0, codes)]))
    assert np.array_equal(got_raw[0], want)


@pytest.mark.slow
def test_pipelined_polish_many_shape_fuzz():
    """Random contig-size mixes (sub-k, exactly k, k+1, row-boundary sizes,
    exception bytes) through the pipelined path match the numpy backend."""
    import os

    from goldpolish_tpu.polish import ntedit_oracle as ne
    from goldpolish_tpu.polish.ntedit_tpu import NtEditTPU

    rng = np.random.default_rng(99)
    k, h = 32, 3
    truth = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 40000)].copy()
    bf = bloom.BloomFilter(1 << 18, h, k)
    bf.insert(nt.multi_hashes(nt.canonical_hashes(truth, k), k, h))
    sizes = [10, k, k + 1, 255, 256, 257, 1000, 7000]
    drafts = []
    a = 0
    for n in sizes:
        d = bytearray(truth[a : a + n].tobytes())
        if n > 3 * k:
            p = n // 2
            d[p] = ord("A") if d[p] != ord("A") else ord("C")
            d[p + 40] = ord("N")  # exception byte inside a draft
        drafts.append(bytes(d))
        a += n
    cfg = ne.Config(k=k, h=h, use_ratio=True, mode=1, mask=1)
    want = [
        NtEditTPU(cfg, bf, backend="numpy").polish_contig(d)[0] for d in drafts
    ]
    os.environ["GPTPU_FORCE_DEVICE_SCAN"] = "1"
    try:
        from goldpolish_tpu.polish import scanpipe

        eng = NtEditTPU(cfg, bf, backend="hybrid")
        # small rows force many calls + ramp + tail paths
        old_rw = scanpipe.ROW_WINDOWS
        scanpipe.ROW_WINDOWS = 512
        try:
            got = eng.polish_many(drafts)
        finally:
            scanpipe.ROW_WINDOWS = old_rw
        assert [o for o, _r, _e in got] == want
        got2 = eng.polish_many(drafts, processes=2, shard_bases=3000)
        assert [o for o, _r, _e in got2] == want
    finally:
        os.environ.pop("GPTPU_FORCE_DEVICE_SCAN", None)


def test_device_scanner_mesh_shards_both_transfers():
    """With >1 device the scan rows shard over the dp mesh, for the raw
    and the 2-bit packed transfer alike."""
    k, h = 32, 4
    n_dev = len(jax.devices())
    if n_dev < 2:
        pytest.skip("needs a multi-device mesh (conftest provides 8 CPUs)")
    codes = _rand_codes(6000, seed=17)
    bf, want = _bf_with(codes, k, h)
    scanner = sc.DeviceScanner(bf)
    assert scanner._mesh is not None, "mesh must exist on >1 device"
    # B rows divisible by the device count -> no pad slice, sharding visible
    rows = np.zeros((n_dev, 6000), np.uint8)
    rows[:] = codes
    out = scanner.scan_packed(rows, k)
    assert len(out.sharding.device_set) == n_dev, (
        "scan output must be sharded across all mesh devices"
    )
    pres = scanner.unpack_present(np.asarray(out)[0], len(codes) - k + 1)
    assert np.array_equal(pres, want)
    # packed2 path shards too
    from goldpolish_tpu import native

    try:
        native.lib()
    except Exception:
        pytest.skip("native lib unavailable")
    res = native.pack2(codes, 64)
    assert res is not None
    packed, pos, byt = res
    E = 64
    packed_rows = np.tile(packed[None], (n_dev, 1))
    exc_idx = np.full((n_dev, E), len(codes), np.int64)
    exc_byte = np.zeros((n_dev, E), np.uint8)
    out2 = scanner.scan_packed2(packed_rows, exc_idx, exc_byte, k, len(codes))
    assert len(out2.sharding.device_set) == n_dev
    pres2 = scanner.unpack_present(np.asarray(out2)[0], len(codes) - k + 1)
    assert np.array_equal(pres2, want)
