"""Device BF-fill micro: where does device_fill_bfs spend its time?

Re-implements device_fill_bfs's phases inline with per-phase host fetches
so upload / count / promote / download each get their own wall time on
bench-shaped input (~10 Mb of 20 kb reads, k=32, h=4, 10 MiB CBF).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main():
    import jax
    import jax.numpy as jnp

    from goldpolish_tpu.ops import bloom_jax, nthash_jax, scan_conv
    from goldpolish_tpu.utils.device import require_device

    require_device("tools/fill_micro.py")

    rng = np.random.default_rng(0)
    n_bases = int(os.environ.get("FILL_BASES", 10_000_000))
    frag = 20_000
    truth = np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, n_bases // 5)
    ].tobytes()
    reads = []
    for rep in range(5):
        off = rep * (frag // 5)
        for s in range(off, len(truth), frag):
            reads.append(truth[s : s + frag + 32])
    read_bases = sum(len(r) for r in reads)
    bf_bytes = 512 * 1024
    while bf_bytes < len(truth) * 2:
        bf_bytes *= 2
    h, k, thresh = 4, 32, 5
    cbf_size = 10 * 1024 * 1024
    bits = bf_bytes * 8
    print(f"# reads={len(reads)} bases={read_bases/1e6:.1f}M bf={bf_bytes>>20}MiB")

    def mark(msg, t0):
        t = time.perf_counter() - t0
        print(f"  {msg}: {t:.3f}s", flush=True)
        return time.perf_counter()

    def count_chunk(counters, codes, lens):
        base = scan_conv.canonical_hashes_conv(codes, k)
        hashes = nthash_jax.multi_hashes(base, k, h)
        nw = base.shape[-1]
        valid = jnp.arange(nw)[None, :] <= (lens[:, None] - k)
        idx = (hashes.reshape(-1) % jnp.uint64(cbf_size)).astype(jnp.int32)
        idx = jnp.where(jnp.repeat(valid.reshape(-1), h), idx, cbf_size)
        return counters.at[idx].add(1, mode="drop")

    def hash_only(codes, lens):
        base = scan_conv.canonical_hashes_conv(codes, k)
        hashes = nthash_jax.multi_hashes(base, k, h)
        return hashes.reshape(-1)[::4097].astype(jnp.uint32).sum()

    def promote_chunk(words, counters, codes, lens):
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

    count_jit = jax.jit(count_chunk)
    hash_jit = jax.jit(hash_only)
    promote_jit = jax.jit(promote_chunk)

    # one big padded chunk (all reads same length here)
    L = max(len(r) for r in reads)
    codes = np.zeros((len(reads), L), np.uint8)
    lens = np.zeros(len(reads), np.int32)
    for r, rd in enumerate(reads):
        codes[r, : len(rd)] = np.frombuffer(rd, np.uint8)
        lens[r] = len(rd)
    nwin = int((lens - k + 1).clip(0).sum())
    print(f"# windows={nwin/1e6:.1f}M  hash-elems={nwin*h/1e6:.1f}M")

    for rep in range(3):
        t0 = time.perf_counter()
        dcodes = jax.device_put(codes)
        dlens = jax.device_put(lens)
        jax.block_until_ready((dcodes, dlens))
        t0 = mark(f"rep{rep} upload {codes.nbytes/1e6:.0f}MB", t0)
        _ = np.asarray(hash_jit(dcodes, dlens))
        t0 = mark(f"rep{rep} hash-only", t0)
        counters = jnp.zeros(cbf_size + 1, jnp.int32)
        counters = count_jit(counters, dcodes, dlens)
        _ = np.asarray(counters[:1])
        t0 = mark(f"rep{rep} count pass", t0)
        words = jnp.zeros(bits // 32, jnp.uint32)
        words = promote_jit(words, counters[:cbf_size], dcodes, dlens)
        _ = np.asarray(words[:1])
        t0 = mark(f"rep{rep} promote pass", t0)
        arr = np.asarray(words)
        t0 = mark(f"rep{rep} download {arr.nbytes/1e6:.0f}MB", t0)


if __name__ == "__main__":
    main()


def bench_sorted():
    """Steady-state wall of the sort-based build vs host, bench shapes."""
    import jax

    from goldpolish_tpu import native
    from goldpolish_tpu.ops import bloom, bloom_sort

    rng = np.random.default_rng(0)
    n_bases = int(os.environ.get("FILL_BASES", 10_000_000))
    frag = 20_000
    truth = np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, n_bases // 5)
    ].tobytes()
    reads = []
    for rep in range(5):
        off = rep * (frag // 5)
        for s in range(off, len(truth), frag):
            reads.append(truth[s : s + frag + 32])
    read_bases = sum(len(r) for r in reads)
    bf_bytes = 512 * 1024
    while bf_bytes < len(truth) * 2:
        bf_bytes *= 2
    ks = [32, 28]
    print(f"# reads={len(reads)} bases={read_bases/1e6:.1f}M bf={bf_bytes>>20}MiB ks={ks}")
    thrs = [5] * len(reads)
    for rep in range(4):
        t0 = time.perf_counter()
        bfs = bloom_sort.device_fill_bfs_sorted(
            reads, thrs, ks, 4, 10 * 1024 * 1024, bf_bytes
        )
        print(f"sorted build rep{rep}: {time.perf_counter()-t0:.3f}s", flush=True)
    for rep in range(2):
        cbfs = [bloom.CountingBloomFilter8(10 * 1024 * 1024, 4, k) for k in ks]
        hbfs = [bloom.BloomFilter(bf_bytes, 4, k) for k in ks]
        t0 = time.perf_counter()
        native.fill_bfs_stream(reads, thrs, 4, ks, cbfs, hbfs)
        print(f"host fill rep{rep}: {time.perf_counter()-t0:.3f}s", flush=True)
    missing = [
        int(np.bitwise_and(hh.array, np.invert(d.array)).sum())
        for d, hh in zip(bfs, hbfs)
    ]
    print(f"host-bits-missing-from-device (must be 0): {missing}")
