"""Device cost breakdown of the fused scan+eval call (ops/scan_eval).

Times, at the production pipeline call shape ([rows, 2^18+31] codes):
  * plain fused scan (scan_conv.scan_present_packed_gather)
  * fused scan + detection + head top_k, NO site eval (ablation)
  * the full fused scan+eval program
  * raw gather-probe rate at the same filter size (issue-rate reference)
min-of-reps with fresh input arrays per rep (result-cache artifact).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

ROWS = int(os.environ.get("ROWS", 4))
RW = int(os.environ.get("RW", 1 << 18))
BF_MIB = int(os.environ.get("BF_MIB", 4))
K, H = 32, 4


def t_min(fn, arrs, reps=5):
    """Min-of-reps, each ended by block_until_ready on the whole output."""
    import jax

    best = float("inf")
    for i in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(arrs[i % len(arrs)]))
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    import jax
    import jax.numpy as jnp

    from goldpolish_tpu.ops import bloom, nthash as nt, siteeval, scan_conv
    from goldpolish_tpu.ops.scan_eval import EvalConfig, FusedEval
    from goldpolish_tpu.polish.multik import ntedit_config_for_k
    from goldpolish_tpu.utils.device import require_device

    require_device("tools/fused_micro.py")
    print(f"# platform={jax.devices()[0].platform} rows={ROWS} rw={RW} "
          f"bf={BF_MIB}MiB", file=sys.stderr)
    rng = np.random.default_rng(0)
    L = RW + K - 1
    bf = bloom.BloomFilter(BF_MIB << 20, H, K)
    # load the filter to ~realistic occupancy (truth kmers of half the span)
    truth = np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, (BF_MIB << 20) // 2)
    ]
    bf.insert(nt.multi_hashes(nt.canonical_hashes(truth, K), K, H))
    words = jnp.asarray(bf.words_u32())

    # error-bearing codes: substitutions every ~400 bases
    def make_codes():
        c = np.frombuffer(b"ACGT", np.uint8)[
            rng.integers(0, 4, ROWS * L)
        ].reshape(ROWS, L).copy()
        span = truth[: L]
        for r in range(ROWS):
            c[r, : len(span)] = span
            c[r, 100::400] = np.where(c[r, 100::400] == ord("A"),
                                      ord("G"), ord("A"))
        return jnp.asarray(c)

    codes_arrs = [make_codes() for _ in range(3)]
    n_win = ROWS * RW

    t = t_min(
        lambda c: scan_conv.scan_present_packed_gather(
            words, int(bf.bits), H, K, c
        ),
        codes_arrs,
    )
    print(f"scan only        {t*1e3:8.1f} ms  ({n_win/t/1e6:6.1f} M win/s)")

    cfg = ntedit_config_for_k(K)
    tables = siteeval.make_tables(K, cfg.jump, cfg.max_insertions,
                                  cfg.max_deletions)
    for s_max in (1024, 2048, 4096):
        ecfg = EvalConfig(
            k=K, h=H, jump=cfg.jump, max_ins=cfg.max_insertions,
            max_del=cfg.max_deletions, thr_edit=cfg.thr_edit,
            thr_missing=cfg.thr_missing, s_max=s_max,
        )
        fused = FusedEval(ecfg, int(bf.bits), tables)
        t = t_min(lambda c: fused(words, c), codes_arrs)
        print(f"fused eval S={s_max:4d} {t*1e3:8.1f} ms  "
              f"({n_win/t/1e6:6.1f} M win/s)")

    # raw gather-probe reference
    NV = 4_000_000
    idxs = [
        jnp.asarray(rng.integers(0, int(bf.bits), (NV, H)).astype(np.uint32))
        for _ in range(3)
    ]

    @jax.jit
    def probe(idx):
        word = words[(idx >> jnp.uint32(5)).astype(jnp.int32)]
        return (((word >> (idx & jnp.uint32(31))) & jnp.uint32(1)) != 0) \
            .all(axis=-1).sum()

    t = t_min(probe, idxs)
    print(f"gather-probe     {t*1e3:8.1f} ms  ({NV*H/t/1e6:6.1f} M gathers/s)")


if __name__ == "__main__":
    main()
