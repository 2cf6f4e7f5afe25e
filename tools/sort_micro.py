"""Device sort/scan/scatter micro-benchmark — the primitives of the
sort-based device Bloom fill (ops/bloom_sort).

Measures steady-state device wall (block_until_ready, fresh inputs per rep
— the jax result-buffer caching artifact makes same-input timing report
~0) for the primitives the scatter-free build composes from:

  * jnp.sort of u32 / u64(emulated) / f32 keys at 1M/10M/40M
  * key+payload pair sort (lax.sort variadic) at 10M
  * argsort u32 10M (the inverse-permutation trick costs two of these)
  * cumsum i32 10M/40M (segment boundaries / run lengths)
  * gather 10M from 10M (permutation apply)
  * scatter-add 10M into 10M i32 (the wall the redesign removes)

Usage: python tools/sort_micro.py  (needs a GPU, or JAX_PLATFORMS=cpu)
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def timed(fn, make_args, reps=5):
    import jax

    outs = fn(*make_args(0))
    jax.block_until_ready(outs)
    best = float("inf")
    for r in range(1, reps + 1):
        args = make_args(r)
        jax.block_until_ready(args)
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    import jax
    import jax.numpy as jnp

    from goldpolish_tpu.utils.device import require_device

    require_device("tools/sort_micro.py")
    dev = jax.devices()[0]
    print(f"# device: {dev.platform} {getattr(dev, 'device_kind', '?')}")
    rng = np.random.default_rng(0)

    def dput(x):
        return jax.device_put(x, dev)

    results = {}

    for n in (1_000_000, 10_000_000, 40_000_000):
        sort32 = jax.jit(jnp.sort)
        t = timed(sort32, lambda r: (dput(rng.integers(0, 1 << 31, n).astype(np.uint32)),))
        results[f"sort_u32_{n}"] = t
        print(f"sort u32   n={n:>9}: {t*1e3:8.1f} ms  {n/t/1e6:8.1f} M/s")

    for n in (10_000_000,):
        t = timed(jax.jit(jnp.sort),
                  lambda r: (dput(rng.integers(0, 1 << 62, n).astype(np.uint64)),))
        results[f"sort_u64_{n}"] = t
        print(f"sort u64   n={n:>9}: {t*1e3:8.1f} ms  {n/t/1e6:8.1f} M/s")

    # pair sort: u32 key + u32 payload
    def pair_sort(k, v):
        import jax.lax as lax

        return lax.sort((k, v), dimension=0, num_keys=1)

    for n in (10_000_000,):
        t = timed(jax.jit(pair_sort),
                  lambda r: (dput(rng.integers(0, 1 << 31, n).astype(np.uint32)),
                             dput(np.arange(n, dtype=np.uint32))))
        results[f"pairsort_u32_{n}"] = t
        print(f"pair sort  n={n:>9}: {t*1e3:8.1f} ms  {n/t/1e6:8.1f} M/s")

    for n in (10_000_000,):
        t = timed(jax.jit(jnp.argsort),
                  lambda r: (dput(rng.integers(0, 1 << 31, n).astype(np.uint32)),))
        results[f"argsort_u32_{n}"] = t
        print(f"argsort    n={n:>9}: {t*1e3:8.1f} ms  {n/t/1e6:8.1f} M/s")

    for n in (10_000_000, 40_000_000):
        t = timed(jax.jit(jnp.cumsum),
                  lambda r: (dput(rng.integers(0, 3, n).astype(np.int32)),))
        results[f"cumsum_i32_{n}"] = t
        print(f"cumsum i32 n={n:>9}: {t*1e3:8.1f} ms  {n/t/1e6:8.1f} M/s")

    for n in (10_000_000,):
        gather = jax.jit(lambda a, i: a[i])
        t = timed(gather,
                  lambda r: (dput(rng.integers(0, 1 << 20, n).astype(np.int32)),
                             dput(rng.integers(0, n, n).astype(np.int32))))
        results[f"gather_{n}"] = t
        print(f"gather     n={n:>9}: {t*1e3:8.1f} ms  {n/t/1e6:8.1f} M/s")

    for n in (10_000_000,):
        scat = jax.jit(lambda a, i: a.at[i].add(1, mode="drop"))
        t = timed(scat,
                  lambda r: (dput(np.zeros(n, np.int32)),
                             dput(rng.integers(0, n, n).astype(np.int32))))
        results[f"scatter_add_{n}"] = t
        print(f"scatteradd n={n:>9}: {t*1e3:8.1f} ms  {n/t/1e6:8.1f} M/s")

    import json

    print(json.dumps({k: round(v, 5) for k, v in results.items()}))


if __name__ == "__main__":
    main()
