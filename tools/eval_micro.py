"""Device site-eval microbenchmark: what can the device deliver for the
fused phase-A offload?

Measures on the GPU (min-of-reps, fresh inputs per rep to dodge the
jax result-cache artifact):
  * gather-probe rate: [N, h] random u32 indices into a words array of the
    bench's two filter sizes (1 MiB and 4 MiB),
  * eval_sites_jax (existing device eval, full C=341) sites/s at S=256,
  * native host eval_sites sites/s on the same sites (1 core),
  * the fused scan+eval candidate: scan_present + hot-site detect on device.

Decides whether the fused scan+eval path can beat the host cores' walks.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

N_BASES = int(os.environ.get("N", 2_000_000))
K, H = 32, 4
S = int(os.environ.get("S", 256))


def t_min(fn, reps=5):
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    import jax
    import jax.numpy as jnp

    from goldpolish_tpu.utils.device import require_device

    require_device("tools/eval_micro.py")

    import bench
    from goldpolish_tpu import native
    from goldpolish_tpu.ops import siteeval, siteeval_jax, bloom_jax
    from goldpolish_tpu.polish.multik import ntedit_config_for_k

    print(f"# devices: {jax.devices()}", file=sys.stderr)
    truths, drafts, bf_by_k, n_err, _s, _rb = bench.build_scenario_flat(
        N_BASES, 2
    )
    cfg = ntedit_config_for_k(K)
    bf = bf_by_k[K]
    tables = siteeval.make_tables(cfg.k, cfg.jump, cfg.max_insertions,
                                  cfg.max_deletions)
    print(f"# scenario {N_BASES} bases, bf={bf.bytes>>20} MiB, h={H}")

    # ---- raw gather-probe rate at two filter sizes
    rng = np.random.default_rng(0)
    for mib in (1, 4):
        bits = mib << 23
        words = jnp.asarray(rng.integers(0, 2**32, bits // 32, np.uint32))
        NV = 4_000_000

        @jax.jit
        def probe(words, idx):
            word = words[(idx >> jnp.uint32(5)).astype(jnp.int32)]
            pres = ((word >> (idx & jnp.uint32(31))) & jnp.uint32(1) != 0)
            return pres.all(axis=-1).sum()

        idxs = [
            jnp.asarray(
                rng.integers(0, bits, (NV, H)).astype(np.uint32)
            )
            for _ in range(3)
        ]
        probe(words, idxs[0]).block_until_ready()
        best = float("inf")
        for rep in range(6):
            t0 = time.perf_counter()
            probe(words, idxs[rep % 3]).block_until_ready()
            best = min(best, time.perf_counter() - t0)
        print(f"gather-probe {mib}MiB: {NV*H/best/1e6:8.1f} M gathers/s "
              f"({NV/best/1e6:6.1f} M win/s)")

    # ---- existing device eval (full combos) vs native host eval
    codes = np.frombuffer(drafts[0], np.uint8)
    # hot-ish sites: every 400 bases (the bench's error spacing)
    sites = np.arange(2 * K, len(codes) - 4 * K, 400, np.int64)[:S]
    words_bf = bloom_jax.to_device_words(bf)
    codes_dev = jnp.asarray(codes)

    def dev_eval():
        return siteeval_jax.eval_sites_jax(
            codes, sites, words_bf, int(bf.bits), tables, H,
            tables.n_combos, s_bucket=S, codes_dev=codes_dev,
        )

    dev_eval()  # compile
    t_dev = t_min(dev_eval, reps=4)
    print(f"device eval_sites (C=341, S={S}): {t_dev*1e3:8.1f} ms "
          f"= {S/t_dev:8.0f} sites/s")

    def host_eval():
        return native.eval_sites(
            codes, sites, bf, tables, H, tables.n_combos,
            bail_edit=cfg.thr_edit, bail_del=cfg.thr_del, skip_unused=True,
        )

    t_host = t_min(host_eval, reps=4)
    print(f"native eval_sites (skip_unused, S={S}): {t_host*1e3:8.1f} ms "
          f"= {S/t_host:8.0f} sites/s (2-core omp)")

    # lower bound for the host walk's per-site trial cost at these sites
    # (native eval without skip approximates the mode-2 worst case)
    def host_eval_full():
        return native.eval_sites(
            codes, sites, bf, tables, H, tables.n_combos,
            bail_edit=cfg.thr_edit, bail_del=cfg.thr_del, skip_unused=False,
        )

    t_hostf = t_min(host_eval_full, reps=3)
    print(f"native eval_sites (full,       S={S}): {t_hostf*1e3:8.1f} ms "
          f"= {S/t_hostf:8.0f} sites/s (2-core omp)")


if __name__ == "__main__":
    main()
