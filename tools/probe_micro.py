"""Probe-formulation microbench: where does the device dense scan spend time?

Variants measured on-device (all jitted, min-of-N, block_until_ready):
  A. canonical base hash only (prefix-XOR ntHash)
  B. base hash + 3 derived multi-hashes
  C. full current scan: hash + 4-gather probe + bitpack (probe_kmers_packed)
  D. hash(base) + single-gather blocked probe (word from base hash, 4 bits
     within the word from other base-hash bits) + bitpack
  E. 4-gather probe alone on precomputed hashes
  F. 1-gather probe alone on precomputed base hashes
"""

import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np  # noqa: E402


def bench(fn, reps=5):
    fn()  # compile
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        r = fn()
        r.block_until_ready()
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    import goldpolish_tpu  # noqa: F401
    import jax
    import jax.numpy as jnp

    from goldpolish_tpu.ops import bloom_jax, nthash_jax as ntj
    from goldpolish_tpu.utils.device import require_device

    require_device("tools/probe_micro.py")

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8 << 20
    k, h = 32, 4
    bits = 1 << 25  # 4 MiB filter
    rng = np.random.default_rng(0)
    codes = jnp.asarray(
        np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].copy()
    )
    words = jnp.asarray(rng.integers(0, 2**32, bits // 32, dtype=np.uint32))
    print(f"n={n>>20}M windows, bits=2^{bits.bit_length()-1}", flush=True)

    f_base = jax.jit(lambda c: ntj.canonical_hashes(c, k))
    dt = bench(lambda: f_base(codes))
    print(f"A base hash:        {n/dt/1e6:7.1f} M win/s ({dt*1e3:.0f} ms)", flush=True)

    f_multi = jax.jit(
        lambda c: ntj.multi_hashes(ntj.canonical_hashes(c, k), k, h)
    )
    dt = bench(lambda: f_multi(codes))
    print(f"B base+3 derived:   {n/dt/1e6:7.1f} M win/s ({dt*1e3:.0f} ms)", flush=True)

    f_cur = jax.jit(
        lambda w, c: bloom_jax.probe_kmers_packed(w, bits, h, k, c),
    )
    dt = bench(lambda: f_cur(words, codes))
    print(f"C current scan:     {n/dt/1e6:7.1f} M win/s ({dt*1e3:.0f} ms)", flush=True)

    def blocked_scan(w, c):
        base = ntj.canonical_hashes(c, k)
        n_words = bits // 32
        widx = (base & jnp.uint64(n_words - 1)).astype(jnp.int32)
        word = w[widx]
        b = (base >> jnp.uint64(33)).astype(jnp.uint32)
        ok = jnp.ones(word.shape, jnp.bool_)
        for i in range(4):
            bp = (b >> jnp.uint32(5 * i)) & jnp.uint32(31)
            ok = ok & (((word >> bp) & jnp.uint32(1)) != 0)
        nb = ok.shape[-1]
        pad = (-nb) % 8
        if pad:
            ok = jnp.pad(ok, [(0, pad)])
        bb = ok.reshape(-1, 8).astype(jnp.uint8)
        weights = jnp.uint8(1) << jnp.arange(8, dtype=jnp.uint8)
        return (bb * weights).sum(axis=-1, dtype=jnp.uint8)

    f_blk = jax.jit(blocked_scan)
    dt = bench(lambda: f_blk(words, codes))
    print(f"D blocked scan:     {n/dt/1e6:7.1f} M win/s ({dt*1e3:.0f} ms)", flush=True)

    hashes = f_multi(codes)
    f_p4 = jax.jit(lambda w, hs: bloom_jax.probe_words(w, bits, hs))
    dt = bench(lambda: f_p4(words, hashes))
    print(f"E 4-gather probe:   {n/dt/1e6:7.1f} M win/s ({dt*1e3:.0f} ms)", flush=True)

    base = f_base(codes)

    def probe1(w, bh):
        widx = (bh & jnp.uint64(bits // 32 - 1)).astype(jnp.int32)
        word = w[widx]
        b = (bh >> jnp.uint64(33)).astype(jnp.uint32)
        ok = jnp.ones(word.shape, jnp.bool_)
        for i in range(4):
            bp = (b >> jnp.uint32(5 * i)) & jnp.uint32(31)
            ok = ok & (((word >> bp) & jnp.uint32(1)) != 0)
        return ok

    f_p1 = jax.jit(probe1)
    dt = bench(lambda: f_p1(words, base))
    print(f"F 1-gather probe:   {n/dt/1e6:7.1f} M win/s ({dt*1e3:.0f} ms)", flush=True)


if __name__ == "__main__":
    main()
