"""Device measurements that decide four kept paths (PERF.md, Findings).

At the scan pipeline's real shapes (2 M windows per call, h = 4, filters
of 2^22-2^26 bits) and on one real batch's read stream, times:

  probe   XLA's gather probe against a one-hot formulation in plain jnp
          (an int8 contraction XLA can place on the tensor cores), plus a
          coalesced read of the same number of words as the L2 reference;
  hash    the fused scan with the conv hash (ops/scan_conv) against the
          production scan, which hashes with the prefix-XOR ladder
          (ops/nthash_jax);
  fill    the sort-based device fill (ops/bloom_sort) over ~20 Mbp of
          reads at chunk_bases 2^21, 2^23, 2^25 and one dispatch: each
          chunk size in a fresh process with the persistent compile cache
          off, so "cold" is the first call with every compile in it, then
          WARM_REPS warm calls (min / median / max);
  sealer  the Sealer's gap search on one 2 Mbp batch with one 60-base gap:
          the host Konnector search (backend numpy) against DeviceBFS
          (backend hybrid), warm, WARM_REPS reps each;

and finally checks that the persistent fork pool still works after the
GPU client has started (bench.py's host arms fork it then).

Kernel timings are the min over reps of a block_until_ready'd call.  Needs
a GPU (or JAX_PLATFORMS=cpu for a rehearsal: --small shrinks every shape).
The fill children run one after another, before this process first
touches the device, so one process holds the card at a time.  Prints one
line per measurement and writes them all as JSON to
chiprun_out/path_choice.json.

Run: python tools/path_choice_micro.py [--small]
"""

import argparse
import functools
import json
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

K, H = 32, 4
WARM_REPS = 7
FILL_K = [32, 28, 24, 20]
FILL_CBF_BYTES = 10 * 1024 * 1024


def t_min(fn, reps=5):
    import jax

    jax.block_until_ready(fn())  # compile + warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def spread(times):
    t = sorted(times)
    return {"min_s": t[0], "median_s": t[len(t) // 2], "max_s": t[-1],
            "reps": len(t)}


def truth_and_reads(small: bool):
    """One 2 Mbp contig (50 kbp small) and the pipeline_bench tiling of
    ~10x 20 kbp reads over it."""
    rng = np.random.default_rng(0)
    clen = 50_000 if small else 2_000_000
    truth = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, clen)].tobytes()
    reads = []
    for rep in range(5):
        off = rep * 10_000 // 5
        for s in [0, *range(-off, clen, 10_000)]:
            a, e = max(0, s), min(clen, s + 20_000)
            if e - a >= 1000:
                reads.append(truth[a:e])
    return truth, reads


def autoscaled_bf_bytes(clen: int) -> int:
    bf_bytes = 512 * 1024  # BFBuilder's autoscale: ~16 bits per base
    while bf_bytes < clen * 2:
        bf_bytes *= 2
    return bf_bytes


def fill_child(chunks: list[int], small: bool) -> int:
    """One fresh process: each chunk size's cold call, then warm reps."""
    import hashlib

    from goldpolish_tpu.bf_builder import mappings_bases_to_kmer_threshold
    from goldpolish_tpu.ops import bloom_sort
    from goldpolish_tpu.utils.device import require_device

    require_device("tools/path_choice_micro.py --fill-child")
    truth, reads = truth_and_reads(small)
    n_bases = sum(len(r) for r in reads)
    thrs = [mappings_bases_to_kmer_threshold(n_bases)] * len(reads)

    def build(cb):
        return bloom_sort.device_fill_bfs_sorted(
            reads, thrs, FILL_K, H, FILL_CBF_BYTES,
            autoscaled_bf_bytes(len(truth)), chunk_bases=cb)

    for cb in chunks:
        t0 = time.perf_counter()
        bfs = build(cb)
        cold = time.perf_counter() - t0
        warm = []
        for _ in range(WARM_REPS):
            t0 = time.perf_counter()
            build(cb)
            warm.append(time.perf_counter() - t0)
        digest = hashlib.sha256(b"".join(bf.array.tobytes() for bf in bfs))
        print(json.dumps({"chunk_bases": cb, "read_bases": n_bases,
                          "cold_s": cold, "warm": spread(warm),
                          "digest": digest.hexdigest()}), flush=True)
    return 0


def fill_section(small: bool) -> dict:
    """Runs the fill children in turn (cache off, one process at a time)."""
    groups = ([[1 << 15], [1 << 17], [1 << 62]] if small
              else [[1 << 21], [1 << 23], [1 << 25, 1 << 62]])
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR="")  # cache off
    fill, digests = {}, set()
    for chunks in groups:
        cmd = [sys.executable, os.path.abspath(__file__), "--fill-child",
               ",".join(map(str, chunks))] + (["--small"] if small else [])
        res = subprocess.run(cmd, env=env, capture_output=True, text=True,
                             timeout=900)
        if res.returncode != 0:
            raise RuntimeError(f"fill child {chunks} failed:\n{res.stderr}")
        for line in res.stdout.splitlines():
            rec = json.loads(line)
            cb = rec.pop("chunk_bases")
            name = "single" if cb == 1 << 62 else f"2^{cb.bit_length() - 1}"
            digests.add(rec.pop("digest"))
            fill[name] = rec
            w = rec["warm"]
            print(f"fill chunk {name} ({rec['read_bases']} read bases, "
                  f"{len(FILL_K)} k): cold {rec['cold_s']:.3f} s, warm min "
                  f"{w['min_s']:.3f} / median {w['median_s']:.3f} / max "
                  f"{w['max_s']:.3f} s over {w['reps']} reps", flush=True)
    fill["all_equal"] = len(digests) == 1
    print(f"fill outputs bit-identical across chunk sizes: "
          f"{fill['all_equal']}", flush=True)
    return fill


def sealer_section(small: bool) -> dict:
    """Host Konnector search vs DeviceBFS on one batch with one gap."""
    from goldpolish_tpu.fill import sealer as sl
    from goldpolish_tpu.ops import bloom, nthash as nt
    from goldpolish_tpu.ops.dbg_bfs import DeviceBFS

    truth, _reads = truth_and_reads(small)
    clen = len(truth)
    codes = np.frombuffer(truth, np.uint8)
    bfs_by_k = {}
    for k in FILL_K:
        bf = bloom.BloomFilter(autoscaled_bf_bytes(clen), H, k)
        bf.insert(nt.multi_hashes(nt.canonical_hashes(codes, k), k, H))
        bfs_by_k[k] = bf
    t = truth.decode()
    records = [("c0 gapped", t[: clen // 2] + "n" * 60 + t[clen // 2 + 60:])]
    cfg = sl.SealerConfig(k_values=FILL_K, flank_length=FILL_K[0])
    out = {}
    results = {}
    for backend in ("numpy", "hybrid"):
        d0 = DeviceBFS.dispatches
        results[backend] = sl.seal_records(records, bfs_by_k, cfg,
                                           backend=backend)  # warm-up
        times = []
        for _ in range(WARM_REPS):
            t0 = time.perf_counter()
            sl.seal_records(records, bfs_by_k, cfg, backend=backend)
            times.append(time.perf_counter() - t0)
        out[backend] = {**spread(times),
                        "dispatches": DeviceBFS.dispatches - d0}
    same = results["numpy"] == results["hybrid"]
    out["equal"] = same
    out["gaps_closed"] = results["numpy"][1]["gaps_closed"]
    for backend in ("numpy", "hybrid"):
        r = out[backend]
        print(f"sealer {backend} (one {clen} bp batch, one 60-base gap, "
              f"{len(FILL_K)} k): min {r['min_s'] * 1e3:.2f} / median "
              f"{r['median_s'] * 1e3:.2f} / max {r['max_s'] * 1e3:.2f} ms "
              f"over {r['reps']} reps, DeviceBFS dispatches "
              f"{r['dispatches']}", flush=True)
    print(f"sealer outputs equal: {same}; gaps closed "
          f"{out['gaps_closed']}", flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="tiny shapes (CPU rehearsal)")
    ap.add_argument("--fill-child", default=None,
                    help="internal: time these chunk sizes in this process")
    args = ap.parse_args()
    if args.fill_child:
        return fill_child([int(c) for c in args.fill_child.split(",")],
                          args.small)

    # before this process first touches the device (one process per card)
    fill = fill_section(args.small)

    import jax
    import jax.numpy as jnp

    from goldpolish_tpu.ops import scan_conv
    from goldpolish_tpu.utils.device import require_device

    platform = require_device("tools/path_choice_micro.py")
    dev = jax.devices()[0]
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        card = f"no nvidia-smi ({platform})"
    print(f"# device {platform} {dev.device_kind}; card: {card}", flush=True)
    out = {"card": card, "platform": platform, "kind": dev.device_kind}

    rows, rw = (4, 1 << 12) if args.small else (4, 1 << 19)
    n_win = rows * rw
    L = rw + K - 1
    key = jax.random.PRNGKey(0)

    # ---------------- probe -------------------------------------------------
    probe = {}
    bit_sizes = [1 << 22, 1 << 24] if args.small else [1 << 22, 1 << 24, 1 << 26]
    for bits in bit_sizes:
        nwords = bits // 32
        words = jax.random.bits(key, (nwords,), jnp.uint32)
        lo = jax.random.bits(jax.random.PRNGKey(1), (n_win, H), jnp.uint32)

        @jax.jit
        def gather(words, lo, bits=bits):
            idx = lo & jnp.uint32(bits - 1)
            w = words[(idx >> jnp.uint32(5)).astype(jnp.int32)]
            pres = ((w >> (idx & jnp.uint32(31))) & jnp.uint32(1) != 0).all(-1)
            return scan_conv._pack_bits(pres)

        @jax.jit
        def coalesced(words, lo):
            # the same number of 4-byte reads, in order: the L2 reference
            idx = jnp.arange(lo.size, dtype=jnp.int32).reshape(lo.shape) \
                % jnp.int32(words.shape[0])
            w = words[idx]
            return scan_conv._pack_bits((w & jnp.uint32(1) != 0).all(-1))

        t_g = t_min(lambda: gather(words, lo))
        t_c = t_min(lambda: coalesced(words, lo))
        rec = {"gather_ms": t_g * 1e3, "coalesced_ms": t_c * 1e3,
               "gather_Mprobes_s": n_win * H / t_g / 1e6,
               "gather_sector_GB_s": n_win * H * 32 / t_g / 1e9,
               "coalesced_GB_s": n_win * H * 4 / t_c / 1e9}
        if bits <= (1 << 24):
            n_rows = nwords // 128
            planes = jnp.stack([
                ((words.reshape(n_rows, 128) >> jnp.uint32(8 * b))
                 & jnp.uint32(0xFF)).astype(jnp.int32) - 128
                for b in range(4)
            ]).astype(jnp.int8)  # [4, R, 128] offset byte planes
            chunk = max(256, (1 << 30) // n_rows)  # one-hot <= 1 GiB

            @jax.jit
            def onehot(planes, lo, bits=bits, n_rows=n_rows, chunk=chunk):
                flat = (lo & jnp.uint32(bits - 1)).reshape(-1)
                pad = (-flat.shape[0]) % chunk
                flat = jnp.pad(flat, (0, pad)).reshape(-1, chunk)

                def one(idx):
                    widx = (idx >> jnp.uint32(5)).astype(jnp.int32)
                    oh = (widx[:, None] >> 7 == jnp.arange(n_rows)[None, :]
                          ).astype(jnp.int8)
                    word = jnp.zeros(idx.shape, jnp.uint32)
                    for b in range(4):
                        sel = jax.lax.dot_general(
                            oh, planes[b], (((1,), (0,)), ((), ())),
                            preferred_element_type=jnp.int32,
                        ) + 128  # [chunk, 128]
                        byte = jnp.take_along_axis(
                            sel, (widx & 127)[:, None], axis=1)[:, 0]
                        word = word | (byte.astype(jnp.uint32)
                                       << jnp.uint32(8 * b))
                    return (word >> (idx & jnp.uint32(31))) & jnp.uint32(1)

                bits_ = jax.lax.map(one, flat).reshape(-1)[: lo.size]
                pres = bits_.reshape(lo.shape).astype(bool).all(-1)
                return scan_conv._pack_bits(pres)

            same = bool((np.asarray(onehot(planes, lo))
                         == np.asarray(gather(words, lo))).all())
            t_o = t_min(lambda: onehot(planes, lo), reps=3)
            rec.update(onehot_ms=t_o * 1e3, onehot_equal=same)
        probe[f"2^{bits.bit_length() - 1}"] = rec
        print(f"probe bits=2^{bits.bit_length() - 1}: " + ", ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in rec.items()), flush=True)
    out["probe"] = probe

    # ---------------- hash ---------------------------------------------------
    rng = np.random.default_rng(0)
    codes = jnp.asarray(np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, (rows, L))])
    bits = 1 << 25
    words = jax.random.bits(key, (bits // 32,), jnp.uint32)

    @functools.partial(jax.jit, static_argnums=(1, 2, 3))
    def scan_conv_hash(words, bits, h, k, codes):
        base = scan_conv.canonical_hashes_conv(codes, k)
        return scan_conv._present_packed(words, bits, h, k, base)

    hashes = {}
    for k in (32, 20):
        conv = lambda: scan_conv_hash(words, bits, H, k, codes)  # noqa: E731
        ladder = lambda: scan_conv.scan_present_packed_gather(  # noqa: E731
            words, bits, H, k, codes)
        same = bool((np.asarray(conv()) == np.asarray(ladder())).all())
        t_conv, t_lad = t_min(conv), t_min(ladder)
        hashes[f"k{k}"] = {"conv_ms": t_conv * 1e3, "ladder_ms": t_lad * 1e3,
                           "equal": same}
        print(f"hash k={k} fused scan [{rows} x {rw}]: conv "
              f"{t_conv * 1e3:.3f} ms, ladder {t_lad * 1e3:.3f} ms, "
              f"equal={same}", flush=True)
    out["hash"] = hashes

    out["fill"] = fill
    out["sealer"] = sealer_section(args.small)

    # ---------------- fork pool after the GPU client -------------------------
    from goldpolish_tpu.ops import bloom, nthash as nt
    from goldpolish_tpu.polish.multik import ntedit_config_for_k
    from goldpolish_tpu.polish.ntedit_tpu import NtEditTPU

    truth, _reads = truth_and_reads(args.small)
    t = np.frombuffer(truth[:200_000], np.uint8)
    bf = bloom.BloomFilter(1 << 19, H, K)
    bf.insert(nt.multi_hashes(nt.canonical_hashes(t, K), K, H))
    drafts = []
    for lo_ in range(0, len(t), 50_000):
        d = bytearray(t[lo_: lo_ + 50_000].tobytes())
        d[1000::997] = b"A" * len(d[1000::997])
        drafts.append(bytes(d))
    eng = NtEditTPU(ntedit_config_for_k(K, hash_num=H), bf, backend="numpy")
    want = [o for o, _r, _e in eng.polish_many(drafts)]
    res = {}

    def pooled():
        res["out"] = [o for o, _r, _e in eng.polish_many(drafts, processes=4)]

    th = threading.Thread(target=pooled, daemon=True)
    t0 = time.perf_counter()
    th.start()
    th.join(120)
    ok = (not th.is_alive() and res.get("out") == want
          and fill["all_equal"] and out["sealer"]["equal"])
    out["fork_pool_after_gpu"] = {"ok": ok, "s": time.perf_counter() - t0}
    print(f"fork pool after GPU use: ok={ok} "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "path_choice.json"), "w") as f:
        json.dump(out, f, indent=1)
    from goldpolish_tpu.utils.procs import shutdown_pools

    shutdown_pools()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
