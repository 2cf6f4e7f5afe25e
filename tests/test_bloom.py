"""Bloom filter behavior: host semantics, device parity, counting dynamics."""

import numpy as np
import pytest

from goldpolish_tpu.ops import bloom, nthash as nt


def _hashes_for(seq, k, h):
    base = nt.canonical_hashes(nt.encode(seq), k)
    return nt.multi_hashes(base, k, h)


def test_insert_contains_roundtrip(tmp_path):
    k, h = 32, 4
    rng = np.random.default_rng(0)
    seq = "".join(rng.choice(list("ACGT")) for _ in range(500))
    bf = bloom.BloomFilter(1024, h, k)
    hashes = _hashes_for(seq, k, h)
    bf.insert(hashes)
    assert bf.contains(hashes).all()
    other = "".join(rng.choice(list("ACGT")) for _ in range(500))
    other_h = _hashes_for(other, k, h)
    # overwhelming majority of foreign k-mers must miss at this load factor
    assert bf.contains(other_h).mean() < 0.5
    # save/load round trip
    p = tmp_path / "t.bf"
    bf.save(str(p))
    bf2 = bloom.BloomFilter.load(str(p))
    assert np.array_equal(bf.array, bf2.array)
    assert (bf2.k, bf2.hash_num, bf2.bytes) == (k, h, 1024)


def test_counting_threshold_promotion():
    """fill_bfs promotes a k-mer only once seen >= threshold times
    (reference src/utils.cpp:108-121: first k uses kmer_threshold-2)."""
    k, h, thresh = 32, 4, 4
    rng = np.random.default_rng(1)
    seq = "".join(rng.choice(list("ACGT")) for _ in range(100))
    cbfs = [bloom.CountingBloomFilter8(1 << 16, h, k)]
    bfs = [bloom.BloomFilter(1 << 14, h, k)]
    codes = nt.encode(seq)
    adjusted = thresh - 2  # == 2 for the first (and only) k
    for copies in range(1, adjusted + 1):
        bloom.fill_bfs(codes, h, [k], thresh, cbfs, bfs)
        hashes = _hashes_for(seq, k, h)
        if copies < adjusted:
            assert not bfs[0].contains(hashes).any(), f"promoted too early at copy {copies}"
        else:
            assert bfs[0].contains(hashes).all(), "not promoted at threshold"


def test_fill_bfs_escalating_thresholds():
    """Threshold escalates +1 per k in k_values order (utils.cpp:108-121)."""
    h, thresh = 4, 5
    ks = [32, 28]
    rng = np.random.default_rng(2)
    seq = "".join(rng.choice(list("ACGT")) for _ in range(200))
    cbfs = [bloom.CountingBloomFilter8(1 << 16, h, k) for k in ks]
    bfs = [bloom.BloomFilter(1 << 14, h, k) for k in ks]
    codes = nt.encode(seq)
    # after 3 (=thresh-2) passes: k=32 promoted, k=28 (threshold 4) not yet
    for _ in range(thresh - 2):
        bloom.fill_bfs(codes, h, ks, thresh, cbfs, bfs)
    assert bfs[0].contains(_hashes_for(seq, 32, h)).all()
    assert not bfs[1].contains(_hashes_for(seq, 28, h)).any()
    bloom.fill_bfs(codes, h, ks, thresh, cbfs, bfs)
    assert bfs[1].contains(_hashes_for(seq, 28, h)).all()


def test_fill_bfs_rejects_low_threshold():
    with pytest.raises(ValueError):
        bloom.fill_bfs(nt.encode("ACGT" * 10), 4, [8], 3, [], [])


def test_device_probe_matches_host():
    jnp_bloom = pytest.importorskip("goldpolish_tpu.ops.bloom_jax")
    import jax.numpy as jnp

    k, h = 32, 4
    rng = np.random.default_rng(3)
    seq = "".join(rng.choice(list("ACGT")) for _ in range(2000))
    bf = bloom.BloomFilter(bloom.DEFAULT_BF_BYTES, h, k)
    hashes = _hashes_for(seq, k, h)
    bf.insert(hashes[::2])  # half in, half out
    words = jnp_bloom.to_device_words(bf)
    got = np.asarray(jnp_bloom.probe_words_jit(words, int(bf.bits), jnp.asarray(hashes)))
    want = bf.contains(hashes)
    assert np.array_equal(got, want)
    # full-pipeline probe from codes
    got2 = np.asarray(
        jnp_bloom.probe_kmers_jit(words, int(bf.bits), h, k, jnp.asarray(nt.encode(seq)))
    )
    assert np.array_equal(got2, want)


def test_lo32_equivalence():
    """Probing with only the low 32 bits equals full-u64 probing when the
    bit count is a power of two (h % 2^m only reads low bits), so the
    mask probe may narrow indices to u32 (bloom_jax.probe_index)."""
    import jax.numpy as jnp

    from goldpolish_tpu.ops import bloom_jax

    k, h = 32, 4
    rng = np.random.default_rng(0)
    seq = "".join(rng.choice(list("ACGT")) for _ in range(3000 + k))
    bf = bloom.BloomFilter(bloom.DEFAULT_BF_BYTES, h, k)
    hashes = _hashes_for(seq, k, h)
    bf.insert(hashes[::2])
    lo = (hashes & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    want = bf.contains(hashes)
    got = np.asarray(bloom_jax.probe_words_jit(
        jnp.asarray(bf.words_u32()), int(bf.bits), jnp.asarray(lo)
    ))
    assert np.array_equal(got, want)


def test_device_build_matches_host():
    jnp_bloom = pytest.importorskip("goldpolish_tpu.ops.bloom_jax")
    import jax.numpy as jnp

    k, h = 24, 4
    rng = np.random.default_rng(4)
    seq = "".join(rng.choice(list("ACGT")) for _ in range(3000))
    hashes = _hashes_for(seq, k, h)
    host = bloom.BloomFilter(bloom.DEFAULT_BF_BYTES, h, k)
    host.insert(hashes)
    dev_words = np.asarray(jnp_bloom.build_words_jit(int(host.bits), jnp.asarray(hashes)))
    assert np.array_equal(dev_words, host.words_u32())


def test_device_counted_build_promotes_at_threshold():
    jnp_bloom = pytest.importorskip("goldpolish_tpu.ops.bloom_jax")
    import jax
    import jax.numpy as jnp

    k, h, thresh = 24, 4, 3
    rng = np.random.default_rng(5)
    seq = "".join(rng.choice(list("ACGT")) for _ in range(500))
    hashes = _hashes_for(seq, k, h)
    # one copy: nothing promoted; three copies: everything promoted
    build = jax.jit(jnp_bloom.counted_build_words, static_argnums=(0, 1, 2, 4))
    bits = 1 << 18
    words1 = np.asarray(build(bits, 1 << 16, h, jnp.asarray(hashes), thresh))
    assert words1.sum() == 0
    rep = np.concatenate([hashes] * 3, axis=0)
    words3 = np.asarray(build(bits, 1 << 16, h, jnp.asarray(rep), thresh))
    host = bloom.BloomFilter(bits // 8, h, k)
    host.insert(hashes)
    # every true k-mer bit must be set (fast mode is a superset filter)
    set_bits = np.unpackbits(words3.view(np.uint8))
    want_bits = np.unpackbits(host.words_u32().view(np.uint8))
    assert (set_bits >= want_bits).all()


def test_native_stream_fill_matches_per_read():
    """gp_fill_bfs_stream (whole-batch, per-k threads) produces filters
    byte-identical to the per-read native fill AND to the numpy oracle,
    including mixed per-read thresholds."""
    pytest.importorskip("goldpolish_tpu.native")
    from goldpolish_tpu import native

    try:
        native.lib()
    except Exception:
        pytest.skip("native lib unavailable")
    rng = np.random.default_rng(42)
    ks, h = [32, 28, 24], 3
    reads = [
        np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].tobytes()
        for n in (500, 90, 17, 700, 260)
    ]
    # repeat reads so promotions actually happen
    reads = reads * 6
    thresholds = [5 if i % 2 else 6 for i in range(len(reads))]

    def fresh():
        return (
            [bloom.CountingBloomFilter8(1 << 16, h, k) for k in ks],
            [bloom.BloomFilter(1 << 14, h, k) for k in ks],
        )

    cbf_a, bf_a = fresh()
    for r, t in zip(reads, thresholds):
        native.fill_bfs(np.frombuffer(r, np.uint8), h, ks, t, cbf_a, bf_a,
                        skip_promoted=False)
    cbf_b, bf_b = fresh()
    native.fill_bfs_stream(reads, thresholds, h, ks, cbf_b, bf_b,
                           skip_promoted=False)
    cbf_c, bf_c = fresh()
    for r, t in zip(reads, thresholds):
        bloom.fill_bfs(np.frombuffer(r, np.uint8), h, ks, t, cbf_c, bf_c)
    for ki in range(len(ks)):
        assert np.array_equal(bf_a[ki].array, bf_b[ki].array)
        assert np.array_equal(cbf_a[ki].counters, cbf_b[ki].counters)
        assert np.array_equal(bf_b[ki].array, bf_c[ki].array)
        assert np.array_equal(cbf_b[ki].counters, cbf_c[ki].counters)
    # skip_promoted mode: BF arrays still identical (CBF may diverge)
    cbf_d, bf_d = fresh()
    native.fill_bfs_stream(reads, thresholds, h, ks, cbf_d, bf_d,
                           skip_promoted=True)
    for ki in range(len(ks)):
        assert np.array_equal(bf_d[ki].array, bf_c[ki].array)


def test_ntedit_bf_format_roundtrip(tmp_path):
    """'BlOOMFXX' interop (the reference's vendored ntEdit BloomFilter.hpp):
    header layout + MSB-first bit order convert losslessly."""
    import struct

    rng = np.random.default_rng(9)
    bf = bloom.BloomFilter(1 << 12, 3, 24)
    hashes = rng.integers(0, 1 << 63, (500, 3), dtype=np.uint64)
    bf.insert(hashes)
    p = str(tmp_path / "f.bf")
    bloom.save_ntedit_bf(bf, p)
    # pinned header layout (BloomFilter.hpp:32-41, pack(1))
    raw = open(p, "rb").read(52)
    magic, hlen, size, nhash, kmer = struct.unpack("<8sIQII", raw[:28])
    assert magic == b"BlOOMFXX" and hlen == 52
    assert size == bf.bytes * 8 and nhash == 3 and kmer == 24
    # the on-disk filter addresses bit i MSB-first: spot-check one set bit
    bit0 = int((hashes[0, 0] % bf.bits))
    disk = np.frombuffer(open(p, "rb").read()[52:], np.uint8)
    assert (disk[bit0 // 8] >> (7 - bit0 % 8)) & 1
    back = bloom.load_any(p)
    assert np.array_equal(back.array, bf.array)
    assert (back.hash_num, back.k) == (3, 24)
    assert np.array_equal(back.contains(hashes), bf.contains(hashes))


def test_btllib_bf_container_roundtrip(tmp_path):
    """btllib KmerBloomFilter v6 container (best-effort; reference writes
    these at src/goldpolish_targeted_bfs.cpp:139 and ntedit-gr reads k/h
    back at ntedit.cpp:2012-2022).  Round-trip + pinned header layout;
    byte-diff vs a real btllib file is unverifiable offline (PARITY.md)."""
    rng = np.random.default_rng(10)
    bf = bloom.BloomFilter(1 << 12, 4, 32)
    hashes = rng.integers(0, 1 << 63, (500, 4), dtype=np.uint64)
    bf.insert(hashes)
    p = str(tmp_path / "k32.bf")
    bloom.save_btllib_bf(bf, p)
    raw = open(p, "rb").read()
    header, _, payload = raw.partition(b"[HeaderEnd]\n")
    assert header.startswith(b"[BTLKmerBloomFilter_v6]\n")
    # cpptoml layout: alphabetical keys, LSB-first payload (no bit swap)
    assert (b"bytes = 4096" in header and b"hash_num = 4" in header
            and b"k = 32" in header)
    assert payload == bf.array.tobytes()
    back = bloom.load_any(p)
    assert np.array_equal(back.array, bf.array)
    assert (back.hash_num, back.k) == (4, 32)
    assert np.array_equal(back.contains(hashes), bf.contains(hashes))
    # tolerant reader: unindented keys, reordered, other signature version
    q = str(tmp_path / "alt.bf")
    with open(q, "wb") as f:
        f.write(b"[BTLBloomFilter_v5]\nk = 32\nbytes = 4096\n"
                b"hash_num = 4\n[HeaderEnd]\n")
        f.write(bf.array.tobytes())
    alt = bloom.load_any(q)
    assert np.array_equal(alt.array, bf.array)
    # truncated payload and missing terminator are hard errors
    t = str(tmp_path / "trunc.bf")
    with open(t, "wb") as f:
        f.write(open(p, "rb").read()[:-100])
    with pytest.raises(ValueError, match="truncated"):
        bloom.load_any(t)
    n = str(tmp_path / "noend.bf")
    with open(n, "wb") as f:
        f.write(b"[BTLKmerBloomFilter_v6]\nbytes = 4096\n")
    with pytest.raises(ValueError, match="HeaderEnd"):
        bloom.load_btllib_bf(n)
