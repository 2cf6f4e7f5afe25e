"""DeviceBFS microbench: per-level device cost + dispatch count of the
device sealer BFS (shadow-set kernel) against the host search.

Scenario: a truth genome's BF (well-populated de Bruijn graph), N gap
searches shaped like the sealer's (start/goal anchors k bases apart on
the truth, depth budget = gap length + slack, both directions).  Measures

  * host search: fill/konnector._BidiSearch via connect_pairs_batch's
    native packed walk (the production host path),
  * DeviceBFS.run(): first call (compiles) and steady state, with the
    level count derived from the depth budgets — per-level cost =
    steady_s / max_levels,

and prints one line per arm.  The device kernel runs ONE dispatch per
width tier per batch (lax.while_loop over levels) by construction; run
with JAX_PLATFORMS=cpu + 8 virtual devices to sanity-check dispatch
behavior on the CPU, or on the GPU for the numbers.

Run: python tools/dbg_bfs_micro.py [n_gaps] [gap_len]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main():
    n_gaps = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    gap_len = int(sys.argv[2]) if len(sys.argv) > 2 else 200
    total = 2_000_000
    k, h = 32, 4

    from goldpolish_tpu import native
    from goldpolish_tpu.fill import konnector as kn
    from goldpolish_tpu.ops import bloom, dbg_bfs

    rng = np.random.default_rng(0)
    truth = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, total)]
    bf_bytes = bloom.DEFAULT_BF_BYTES
    while bf_bytes < total * 2:
        bf_bytes *= 2
    cbf = bloom.CountingBloomFilter8(bloom.DEFAULT_CBF_BYTES, h, k)
    bf = bloom.BloomFilter(bf_bytes, h, k)
    frag = 20_000
    reads = [truth[: frag + 64].tobytes()]
    for rep in range(5):
        off = rep * (frag // 5)
        for s in range(off, total, frag):
            reads.append(truth[s : s + frag + 64].tobytes())
    native.fill_bfs_stream(reads, [5] * len(reads), h, [k], [cbf], [bf])
    seq = truth.tobytes().decode()

    # sealer-shaped flank pseudo-read pairs (fill/sealer.find_flanks
    # geometry; reference makePseudoReads sealer.cpp:560-577): left flank,
    # RC'd right flank, gap_len truth bases between them
    flank = 100
    pairs_host = []
    step = (total - 4 * frag) // n_gaps
    for i in range(n_gaps):
        p = 2 * frag + i * step
        left = seq[p : p + flank]
        right = kn.revcomp(seq[p + flank + gap_len
                               : p + flank + gap_len + flank])
        pairs_host.append((left, right))

    # host arm: the packed bidirectional search on the probing DBG
    dbg = kn.DBG(bf, k)
    params = kn.ConnectPairsParams(
        max_merged_seq_len=gap_len + 2 * flank + 100, max_paths=2,
        max_branches=1000, max_cost=100_000,
    )
    # device searches exactly as connect_pairs_batch_masks derives them
    prepped = [kn._prepare_search(dbg, r1, r2, params)
               for r1, r2 in pairs_host]
    searches = [
        (s.start_str, s.goal_str, s.max_depth[0], s.max_depth[1])
        for _res, s in prepped if s is not None and s.packed
    ]
    if not searches:
        print("no live searches — geometry bug", flush=True)
        return
    max_levels = max(max(mf, mr) for _s, _g, mf, mr in searches) + 1
    print(f"{len(searches)} live searches, depth budgets to "
          f"{max_levels - 1}", flush=True)
    t_host = float("inf")
    res = None
    for _ in range(3):
        t0 = time.perf_counter()
        res = kn.connect_pairs_batch(dbg, pairs_host, params)
        t_host = min(t_host, time.perf_counter() - t0)
    n_found = sum(1 for r in res if r.path_result == "FOUND_PATH")
    print(
        f"host:   {t_host:.3f}s  {n_gaps/t_host:.0f} gaps/s "
        f"(paths found {n_found}/{n_gaps})", flush=True,
    )

    from goldpolish_tpu.utils.device import require_device

    platform = require_device("tools/dbg_bfs_micro.py")
    dev = dbg_bfs.DeviceBFS(bf, k)
    t0 = time.perf_counter()
    out = dev.run(searches)
    t_first = time.perf_counter() - t0
    n_ok = sum(1 for a, b in out if a is not None and b is not None)
    t_dev = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        out = dev.run(searches)
        t_dev = min(t_dev, time.perf_counter() - t0)
    print(
        f"device[{platform}]: first {t_first:.2f}s (compiles), steady "
        f"{t_dev:.3f}s  {n_gaps/t_dev:.0f} gaps/s; mask dicts ok "
        f"{n_ok}/{n_gaps}; ~{max_levels} levels -> "
        f"{t_dev/max_levels*1e3:.2f} ms/level in ONE dispatch/tier",
        flush=True,
    )

    # replay arm: the production hybrid (device masks + host replay)
    t_replay = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        kn.connect_pairs_batch_masks(dbg, pairs_host, params, dev)
        t_replay = min(t_replay, time.perf_counter() - t0)
    print(
        f"hybrid (device masks + host replay): {t_replay:.3f}s "
        f"{n_gaps/t_replay:.0f} gaps/s", flush=True,
    )


if __name__ == "__main__":
    main()
