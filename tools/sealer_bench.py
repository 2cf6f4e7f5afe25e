"""Sealer-stage benchmark: gap-heavy batch fill rate, host vs DeviceDBG.

Scenario: a truth genome, a draft whose every gap is a masked (lowercase)
run of real truth content (the post-ntEdit `-a1` regime that dominates real
noisy batches), per-k BFs filled from the truth.  Measures seal_records
wall time per k-sweep for the host DBG and (on an accelerator) the
DeviceDBG lockstep path, and reports gaps/s + closure counters.

Run: python tools/sealer_bench.py [total_bases] [n_gaps]
"""

import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import numpy as np  # noqa: E402


def main():
    total = int(sys.argv[1]) if len(sys.argv) > 1 else 2_000_000
    n_gaps = int(sys.argv[2]) if len(sys.argv) > 2 else 400
    from goldpolish_tpu import native
    from goldpolish_tpu.fill import sealer as sl
    from goldpolish_tpu.ops import bloom

    rng = np.random.default_rng(0)
    truth = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, total)]
    ks = [32, 28]
    bf_bytes = bloom.DEFAULT_BF_BYTES
    while bf_bytes < total * 2:
        bf_bytes *= 2
    cbfs = [bloom.CountingBloomFilter8(bloom.DEFAULT_CBF_BYTES, 4, k) for k in ks]
    bfs = [bloom.BloomFilter(bf_bytes, 4, k) for k in ks]
    frag = 20_000
    reads = []
    for rep in range(5):
        off = rep * (frag // 5)
        reads.append(truth[: frag + 64].tobytes())
        for s in range(off, total, frag):
            reads.append(truth[s : s + frag + 64].tobytes())
    t0 = time.time()
    native.fill_bfs_stream(reads, [5] * len(reads), 4, ks, cbfs, bfs)
    print(f"bf fill: {time.time()-t0:.2f}s", flush=True)

    # draft: lowercase (masked) runs of 60-300 bp spread across the contig
    seq = truth.tobytes().decode()
    gap_positions = np.linspace(2000, total - 2000, n_gaps).astype(int)
    chars = list(seq)
    for i, p in enumerate(gap_positions):
        glen = 60 + (i * 37) % 240
        chars[p : p + glen] = [c.lower() for c in chars[p : p + glen]]
    draft = "".join(chars)
    records = [("ctg0", draft)]
    bfs_by_k = {k: bf for k, bf in zip(ks, bfs)}
    cfg = sl.SealerConfig(k_values=ks, flank_length=ks[0])

    for backend in ("numpy", "hybrid", "jax"):
        if backend == "hybrid":
            # whole-search device BFS (ops/dbg_bfs): one dispatch per gap
            # batch; host replays the exact bookkeeping from the masks
            try:
                import jax

                if jax.devices()[0].platform == "cpu":
                    print("hybrid backend: cpu only, skipping device timing",
                          flush=True)
                    continue
            except Exception:
                continue
            # untimed warmup at the REAL gap count: the kernel batch size
            # G adapts to it, so a small warmup would compile the wrong
            # shapes and the timed run would pay them
            t0 = time.time()
            sl.seal_records(records, bfs_by_k, cfg, backend=backend)
            print(f"hybrid warmup (compiles): {time.time()-t0:.1f}s",
                  flush=True)
        if backend == "jax":
            import os

            if not os.environ.get("GPTPU_SEALER_BENCH_DEVICE"):
                # the lockstep DeviceDBG makes one device round trip per BFS
                # level (not measured on the GPU); opt in explicitly
                print("jax backend: skipped by default "
                      "(GPTPU_SEALER_BENCH_DEVICE=1 to run)", flush=True)
                continue
            try:
                import jax

                if jax.devices()[0].platform == "cpu":
                    print("jax backend: cpu only, skipping device timing",
                          flush=True)
                    continue
            except Exception:
                continue
        t0 = time.time()
        sealed, stats = sl.seal_records(records, bfs_by_k, cfg, backend=backend)
        dt = time.time() - t0
        print(
            f"{backend}: {dt:.2f}s ({n_gaps/dt:.0f} gaps/s, "
            f"{total/dt/1e6:.1f} Mbp/s) closed={stats['gaps_closed']}"
            f"/{stats['gaps_found']} k{ks[0]}={stats[ks[0]]}",
            flush=True,
        )


if __name__ == "__main__":
    main()
