"""End-to-end pipeline benchmark: synthetic multi-contig assembly at scale.

Generates a truth genome (default 10 x 2 Mbp contigs), a draft with ~0.25%
mixed errors, ~10x tiled reads (starts staggered across passes so coverage
is uniform, including contig heads), and a PAF mapping; then runs the full
bulk pipeline (map -> per-batch multi-k BFs -> ntEdit chain -> mask ->
sealer -> upper) through the CLI path and reports wall time, per-stage CPU
sums, and exact-recovery status against the truth.

Usage: python tools/pipeline_bench.py [--bases 20000000] [--contigs 10]
           [--workers 4] [--workspace /tmp/gp_bench] [--keep]
"""

import argparse
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def generate(workspace: str, n_contigs: int, clen: int, seed: int = 0,
             frag: int = 20000, step: int = 10000, passes: int = 5,
             gap_len: int = 0):
    """Truth contigs, a mutated draft, tiled reads and their PAF.

    Errors every 400 bp cycle substitution / deletion / insertion; with
    gap_len > 0 each contig also gets one lowercase `n` gap of that length
    at its middle (the tests/refscale.py:_mutate shape) for the Sealer.
    Returns (truths, draft_path, reads_path, paf_path, n_errors)."""
    rng = np.random.default_rng(seed)
    os.makedirs(workspace, exist_ok=True)
    truths = []
    draft_path = os.path.join(workspace, "draft.fa")
    reads_path = os.path.join(workspace, "reads.fq")
    paf_path = os.path.join(workspace, "map.paf")
    n_err = 0
    with open(draft_path, "w") as df, open(reads_path, "w") as rf, \
            open(paf_path, "w") as pf:
        rn = 0
        for ci in range(n_contigs):
            t = np.frombuffer(b"ACGT", np.uint8)[
                rng.integers(0, 4, clen)
            ].tobytes().decode()
            truths.append(t)
            d = list(t)
            for i, p in enumerate(range(200, clen - 200, 400)):
                kind = i % 3
                if kind == 0:
                    d[p] = "A" if d[p] != "A" else "G"
                elif kind == 1:
                    d[p] = ""
                else:
                    d[p] = "T" + d[p]
                n_err += 1
            if gap_len:
                mid = clen // 2
                d[mid : mid + gap_len] = ["n"] * gap_len
            ds = "".join(d)
            df.write(f">c{ci}\n{ds}\n")
            # staggered tiling: each pass shifts its read starts so no
            # contig position sits at a coverage cliff (aligned starts
            # leave boundary-crossing k-mers at half coverage)
            for rep in range(passes):
                off = (rep * step) // passes
                # the head is only reachable by reads clamped to start 0 —
                # one per pass; double them up so head k-mer counts clear
                # the promotion threshold like the interior does
                starts = [0, *range(-off, clen, step)]
                for s in starts:
                    a, e = max(0, s), min(clen, s + frag)
                    if e - a < 1000:
                        continue
                    rf.write(f"@r{rn}\n{t[a:e]}\n+\n{'I' * (e - a)}\n")
                    pf.write(
                        f"r{rn}\t{e-a}\t0\t{e-a}\t+\tc{ci}\t{len(ds)}\t{a}\t"
                        f"{e}\t{e-a}\t{e-a}\t60\n"
                    )
                    rn += 1
    return truths, draft_path, reads_path, paf_path, n_err


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--bases", type=int, default=20_000_000)
    ap.add_argument("--contigs", type=int, default=10)
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 4)
    ap.add_argument("--workspace", default="/tmp/gp_pipeline_bench")
    ap.add_argument("--k", type=int, nargs="+", default=[32, 28])
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    clen = args.bases // args.contigs
    t0 = time.time()
    truths, draft, reads, paf, n_err = generate(
        args.workspace, args.contigs, clen, args.seed
    )
    gen_s = time.time() - t0

    from goldpolish_tpu.config import PipelineConfig
    from goldpolish_tpu.io import fasta
    from goldpolish_tpu.pipeline import bulk

    out = os.path.join(args.workspace, "polished.fa")
    cfg = PipelineConfig(
        seqs_to_polish=draft, polishing_seqs=reads, output_seqs=out,
        k_values=list(args.k), batch_size=1, mappings_path=paf,
        workspace=args.workspace, max_concurrent_batches=args.workers,
        process_pool=True,
    )
    t0 = time.time()
    totals = bulk.run_bulk(cfg)
    wall = time.time() - t0

    recs = {r.name.split()[0]: r.seq for r in fasta.read_seqs(out)}
    residual = 0
    recovered = 0
    for ci, t in enumerate(truths):
        o = recs[f"c{ci}"].upper()
        if o == t:
            recovered += 1
        elif len(o) == len(t):
            residual += sum(1 for a, b in zip(o, t) if a != b)
        else:
            residual += abs(len(o) - len(t))
    print(
        f"pipeline: {args.bases} bases, {args.contigs} contigs, "
        f"{n_err} errors, {args.workers} workers"
    )
    print(
        f"wall {wall:.1f}s ({args.bases/wall/1e6:.2f} Mbp/s) gen {gen_s:.1f}s; "
        f"recovered {recovered}/{args.contigs} contigs, residual {residual}"
    )
    print(f"totals: {totals}")
    if not args.keep:
        shutil.rmtree(args.workspace, ignore_errors=True)


if __name__ == "__main__":
    main()
