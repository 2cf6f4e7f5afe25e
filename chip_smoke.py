#!/usr/bin/env python3
"""Smoke run of the polishing pipeline on a GPU, checked against the host.

Drives the bulk pipeline through its CLI entry point
(goldpolish_tpu.cli.main) on a generated small-eukaryote assembly — a
20 Mbp draft of 10 x 2 Mbp contigs with a substitution, deletion or
insertion every 400 bp and one 60-base `n` gap per contig, ~10x tiled
20 kbp reads with a PAF, the reference's default k sweep 32/28/24/20,
Sealer on, -b 1, autoscaled per-batch filters — in these legs:

  L0  --backend numpy: the host anchor (native walk, host fill, host
      Konnector search);
  L1  --backend hybrid, device scan forced: must equal L0 byte for byte;
  L2  --backend jax on the first contigs: must equal L0 on those contigs;
  L3  --backend hybrid --fill-overlap, device scan forced: must recover
      the truth;
  P   kernel parity at real widths, integer results, zero tolerance.

After each device leg it asserts that device work happened (dispatch
counters).  Any failed check exits nonzero and prints no result line;
exceptions propagate.  Wall times printed here are smoke timings, not
benchmark results.

  python chip_smoke.py                  # one GPU (the default)
  python chip_smoke.py --four           # four GPUs: L0, L1 sharded over a
                                        # 4-device mesh, sharded scan parity
  python chip_smoke.py --cpu-rehearsal [--four]
                                        # tiny scenario on the CPU (virtual
                                        # devices for --four); never a result
                                        # for the GPU

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
K_SWEEP = [32, 28, 24, 20]
H = 4
L2_CONTIGS = 1  # the jax backend's Python walk is slow at full size


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


def result_line(platform: str, kind: str, count: int) -> str:
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count,
    }})


class Checks:
    """Collects pass/fail of every comparison; prints each as it lands."""

    def __init__(self):
        self.failed: list[str] = []

    def __call__(self, ok: bool, what: str) -> bool:
        print(f"{'ok  ' if ok else 'FAIL'} {what}", flush=True)
        if not ok:
            self.failed.append(what)
        return ok

    def parity(self, what: str, n_bad: int, n_total: int) -> None:
        self(n_bad == 0 and n_total > 0,
             f"parity {what}: mismatches={n_bad} of {n_total}")


def read_records(path: str) -> list[tuple[str, str]]:
    from goldpolish_tpu.io import fasta

    return [(r.id, r.seq) for r in fasta.read_seqs(path)]


def subset_inputs(draft: str, paf: str, ids: set[str], work: str):
    """Draft FASTA and PAF restricted to the contigs in `ids`."""
    from goldpolish_tpu.io import fasta

    sub_draft = os.path.join(work, "draft_subset.fa")
    fasta.write_fasta(sub_draft, [
        (r.name, r.seq) for r in fasta.read_seqs(draft) if r.id in ids
    ])
    sub_paf = os.path.join(work, "map_subset.paf")
    with open(paf) as src, open(sub_paf, "w") as dst:
        for line in src:
            if line.split("\t", 6)[5] in ids:
                dst.write(line)
    return sub_draft, sub_paf


def counters() -> dict:
    """Process-wide device dispatch counters of every device path."""
    from goldpolish_tpu.bf_builder import BFBuilder
    from goldpolish_tpu.fill.konnector import DeviceDBG
    from goldpolish_tpu.ops.dbg_bfs import DeviceBFS
    from goldpolish_tpu.ops.scan_eval import FusedEval
    from goldpolish_tpu.polish.ntedit_tpu import NtEditTPU
    from goldpolish_tpu.polish.scanpipe import ScanPipe

    return {
        "scanpipe_calls": ScanPipe.total_calls,
        "fused_eval_calls": FusedEval.calls,
        "device_bfs_dispatches": DeviceBFS.dispatches,
        "device_dbg_calls": DeviceDBG.device_calls,
        "jax_scan_calls": NtEditTPU.device_scan_calls,
        "device_fills": BFBuilder.device_fills,
    }


class _LegLog(logging.Handler):
    """Counts a leg's logged errors and keeps its pipeline timing line."""

    def __init__(self):
        super().__init__(level=logging.INFO)
        self.n_errors = 0
        self.timing = ""

    def emit(self, record):
        if record.levelno >= logging.ERROR:
            self.n_errors += 1
        msg = record.getMessage()
        if msg.startswith("timing:"):
            self.timing = msg


def run_leg(name: str, argv: list[str], force_device_scan: bool = False):
    """One pipeline run through the CLI; returns (device counter deltas,
    number of errors logged)."""
    from goldpolish_tpu import cli

    before = counters()
    leg_log = _LegLog()
    logging.getLogger("goldpolish_tpu").addHandler(leg_log)
    if force_device_scan:
        os.environ["GPTPU_FORCE_DEVICE_SCAN"] = "1"
    t0 = time.monotonic()
    try:
        rc = cli.main(argv)
    finally:
        os.environ.pop("GPTPU_FORCE_DEVICE_SCAN", None)
        logging.getLogger("goldpolish_tpu").removeHandler(leg_log)
    wall = time.monotonic() - t0
    if rc != 0:
        raise RuntimeError(f"{name}: cli.main returned {rc}")
    after = counters()
    delta = {k: after[k] - before[k] for k in after}
    print(f"smoke timing (not a benchmark result): {name} wall "
          f"{wall:.1f} s; device counters {delta}", flush=True)
    print(f"smoke timing (not a benchmark result): {name} pipeline "
          f"{leg_log.timing}", flush=True)
    return delta, leg_log.n_errors


def print_memory(what: str, compiled) -> None:
    print(f"memory_analysis {what}: {compiled.memory_analysis()}", flush=True)


# --- phase P: kernel parity at real widths -----------------------------------

def parity_hashes(check: Checks, contig: bytes) -> None:
    """Both device hashes — the conv (device fill) and the prefix-XOR
    ladder (scan path) — vs the scalar-spec ntHash over a full contig
    carrying lowercase, IUPAC and N bytes."""
    import jax
    import numpy as np

    from goldpolish_tpu.ops import nthash as nt, nthash_jax, scan_conv

    codes = np.frombuffer(contig, np.uint8).copy()
    odd = np.frombuffer(b"acgtNnRYKMSWBDHVryk", np.uint8)
    pos = np.arange(7, len(codes), 997)
    codes[pos] = odd[np.arange(len(pos)) % len(odd)]
    for name, fn in (("conv", scan_conv.canonical_hashes_conv),
                     ("ladder", nthash_jax.canonical_hashes)):
        jfn = jax.jit(fn, static_argnums=1)
        for k in K_SWEEP:
            got = np.asarray(jfn(codes[None], k))[0]
            want = nt.canonical_hashes(codes, k)
            check.parity(f"{name} hash k={k} ({len(codes)} bases)",
                         int((got != want).sum()), len(want))


def parity_scan(check: Checks, batch_bfs, draft: bytes) -> None:
    """Fused gather scan through the production ScanPipe vs the host
    filter's contains, at the batch's autoscaled filter."""
    import numpy as np

    from goldpolish_tpu.ops import nthash as nt, scan_conv
    from goldpolish_tpu.polish.scanpipe import ScanPipe

    codes = np.frombuffer(draft, np.uint8)
    for k in K_SWEEP:
        bf = batch_bfs.bf_for_k(k)
        scanner = scan_conv.DeviceScanner(bf)
        pipe = ScanPipe(scanner, k)
        (_job, got), = list(pipe.run([(0, codes)]))
        want = bf.contains(nt.multi_hashes(nt.canonical_hashes(codes, k), k, H))
        check.parity(f"fused gather scan k={k} (filter 2^{int(bf.bits).bit_length() - 1}"
                     f" bits)", int((got != want).sum()), len(want))
        if k == K_SWEEP[0]:
            L = pipe.row_bytes
            p4 = -(-L // 4)
            args = (scanner._words, scanner.bits, H, k, L,
                    np.zeros((pipe.rows, p4), np.uint8),
                    np.full((pipe.rows, pipe.EXC_BUCKET), L, np.int64),
                    np.zeros((pipe.rows, pipe.EXC_BUCKET), np.uint8))
            print_memory(
                f"fused scan [{pipe.rows} x {pipe.row_windows} windows]",
                scan_conv.scan_present_packed2_gather.lower(*args).compile(),
            )


def _heads_ref(hot, k: int):
    import numpy as np

    heads = [w for w in np.nonzero(hot)[0] if not hot[max(0, w - k + 1):w].any()]
    return np.array(heads, np.int64)


def parity_fused_eval(check: Checks, bf, draft: bytes) -> None:
    """FusedEval at s_max=4096 and the pipeline's eval call shape
    ([4, 2^18 + k - 1]) against the host spec: presence bits, cluster
    heads, and the substitution / deletion / insertion tables."""
    import jax.numpy as jnp
    import numpy as np

    from goldpolish_tpu.ops import siteeval
    from goldpolish_tpu.ops.scan_eval import EvalConfig, FusedEval
    from goldpolish_tpu.polish.multik import ntedit_config_for_k
    from goldpolish_tpu.polish.ntedit_tpu import NtEditTPU

    k = K_SWEEP[0]
    cfg = ntedit_config_for_k(k, hash_num=H)
    tables = siteeval.make_tables(k, cfg.jump, cfg.max_insertions,
                                  cfg.max_deletions)
    ecfg = EvalConfig(k=k, h=H, jump=cfg.jump, max_ins=cfg.max_insertions,
                      max_del=cfg.max_deletions, thr_edit=cfg.thr_edit,
                      thr_missing=cfg.thr_missing, s_max=4096)
    fused = FusedEval(ecfg, int(bf.bits), tables)
    rows, rw = 4, 1 << 18
    codes = np.frombuffer(draft, np.uint8)
    L = rw + k - 1
    rows = min(rows, max(1, (len(codes) - k + 1) // rw))
    if rows * rw + k - 1 > len(codes):  # short contig (rehearsal sizes)
        rw = (len(codes) - k + 1) // rows
        L = rw + k - 1
    buf = np.stack([codes[r * rw: r * rw + L] for r in range(rows)])
    words = jnp.asarray(bf.words_u32())
    print_memory(f"fused eval [{rows} x {rw} windows, s_max 4096]",
                 fused._run.lower(words, jnp.asarray(buf)).compile())
    (packed, n_sites, site, gate, sub_sup, del_sup, ins_lane, ins_ok,
     ins_sup) = (np.asarray(x) for x in fused(words, jnp.asarray(buf)))
    eng = NtEditTPU(cfg, bf, backend="numpy")
    bits = np.unpackbits(packed, axis=1, bitorder="little")[:, :rw].astype(bool)
    heads = []
    bad_pres = 0
    for r in range(rows):
        pres = eng._present_host(buf[r])
        bad_pres += int((bits[r] != pres).sum())
        heads.extend(r * rw + _heads_ref(eng._masks(buf[r], pres).hot, k))
    check.parity("fused eval presence bits", bad_pres, rows * rw)
    heads = np.array(sorted(heads), np.int64)
    got_sites = site[site >= 0].astype(np.int64)
    n_cmp = min(len(got_sites), len(heads))
    check(int(n_sites) == len(heads) and len(heads) <= ecfg.s_max,
          f"fused eval head count {int(n_sites)} == host {len(heads)} "
          f"(<= s_max {ecfg.s_max})")
    check.parity("fused eval head positions",
                 int((got_sites[:n_cmp] != heads[:n_cmp]).sum()), n_cmp)
    thr = np.float32(cfg.thr_edit)
    bad, checked = 0, 0
    interior = [(gi, s) for gi, s in enumerate(got_sites) if s % rw <= rw - 2 * k]
    for lo in range(0, len(interior), 256):
        part = interior[lo: lo + 256]
        by_row: dict[int, list] = {}
        for gi, s in part:
            by_row.setdefault(int(s // rw), []).append((gi, int(s % rw)))
        for r, items in by_row.items():
            sup = siteeval.eval_sites_np(
                buf[r], np.array([w for _g, w in items]), bf, tables, H,
                tables.n_combos,
            )
            for j, (gi, _w) in enumerate(items):
                ok = (np.array_equal(gate[gi], sup.gate[j].astype(np.uint8))
                      and np.array_equal(sub_sup[gi], sup.sub_support[j])
                      and np.array_equal(del_sup[gi], sup.del_support[j]))
                acc = sup.gate[j] & (sup.sub_support[j].astype(np.float32) >= thr)
                need = -1
                for ci in range(4):
                    if acc[:ci].any():
                        break
                    if (sup.gate[j][ci] and not acc[ci]
                            and sup.sub_cand[j][ci] != 0):
                        need = ci
                        break
                ok = ok and int(ins_lane[gi]) == need
                if ok and need >= 0 and ins_ok[gi]:
                    host = sup.ins_support[j][need]
                    dev = ins_sup[gi]
                    passing = host.astype(np.float32) >= thr
                    other = dev[~passing]
                    ok = (bool((host[passing] == dev[passing]).all())
                          and bool(((other == host[~passing]) | (other == 0)).all())
                          and bool((other.astype(np.float32) < thr).all()))
                bad += not ok
                checked += 1
    check.parity("fused eval site tables vs eval_sites_np", bad, checked)


def parity_siteeval(check: Checks, bf, draft: bytes) -> None:
    """siteeval_jax.eval_sites_jax vs the host: full tables against the
    spec (eval_sites_np), and the editor's trial decision at every site
    against native.eval_sites (whose early bails leave decision-unread
    entries unset)."""
    import jax.numpy as jnp
    import numpy as np

    from goldpolish_tpu import native
    from goldpolish_tpu.ops import siteeval, siteeval_jax
    from goldpolish_tpu.polish import ntedit_tpu
    from goldpolish_tpu.polish.multik import ntedit_config_for_k

    k = K_SWEEP[0]
    cfg = ntedit_config_for_k(k, hash_num=H)
    tables = siteeval.make_tables(k, cfg.jump, cfg.max_insertions,
                                  cfg.max_deletions)
    codes = np.frombuffer(draft, np.uint8)
    eng = ntedit_tpu.NtEditTPU(cfg, bf, backend="numpy")
    sites = np.nonzero(eng._masks(codes).hot)[0][:1024].astype(np.int64)
    dev = siteeval_jax.eval_sites_jax(
        codes, sites, jnp.asarray(bf.words_u32()), int(bf.bits), tables, H,
        tables.n_combos,
    )
    bad = np.zeros(len(sites), bool)
    for lo in range(0, len(sites), 256):
        spec = siteeval.eval_sites_np(codes, sites[lo: lo + 256], bf, tables,
                                      H, tables.n_combos)
        for f in ("sub_cand", "gate", "sub_support", "ins_support",
                  "del_support"):
            a = np.asarray(getattr(dev, f))[lo: lo + 256]
            b = np.asarray(getattr(spec, f))
            bad[lo: lo + len(b)] |= (a.reshape(len(b), -1)
                                     != b.reshape(len(b), -1)).any(axis=1)
    check.parity(f"eval_sites_jax vs eval_sites_np ({len(sites)} sites, "
                 "full tables)", int(bad.sum()), len(sites))
    host = native.eval_sites(codes, sites, bf, tables, H, tables.n_combos)
    n_bad = 0
    for i, w in enumerate(sites):
        p = int(w) + k - 1
        draft_char = ntedit_tpu._upper(int(codes[p]))
        decided = [
            ntedit_tpu._engine_run_trials(cfg, draft_char,
                                          ntedit_tpu._TableProvider(
                                              sup, i, draft, p))
            for sup in (dev, host)
        ]
        n_bad += decided[0] != decided[1]
    check.parity(f"eval_sites_jax vs native.eval_sites ({len(sites)} sites, "
                 "trial decisions)", n_bad, len(sites))


FILL_CHUNKED = 1 << 21  # well below a ~20 Mb stream: the chunked build


def parity_device_fill(check: Checks, builder, ids: list[str]) -> None:
    """build_batch_device: a bitwise superset of the host build, and equal
    to the explicitly chunked device build, for each given batch.  At the
    default chunk size a batch's ~20 Mb stream is one dispatch, so the
    chunked two-phase build is the one to compare it with."""
    import numpy as np

    from goldpolish_tpu.ops import bloom_sort

    for tid in ids:
        dev = builder.build_batch_device([tid])
        host = builder.build_batch([tid])
        reads, thrs = [], []
        for _t, chosen, thr in builder._choose_reads([tid]):
            for rid in chosen:
                reads.append(builder.mapped_index.get_seq(rid))
                thrs.append(thr)
        n_bases = sum(len(r) for r in reads)
        chunk = min(FILL_CHUNKED, n_bases // 4)  # chunked at any size
        chunked = bloom_sort.device_fill_bfs_sorted(
            reads, thrs, builder.k_values, builder.hash_num,
            builder.cbf_bytes, builder._batch_bf_bytes([tid]),
            chunk_bases=chunk,
        )
        for k, d, h, c in zip(builder.k_values, dev.bfs, host.bfs, chunked):
            lost = int(np.unpackbits(h.array & ~d.array).sum())
            check.parity(f"device fill {tid} k={k} superset of host "
                         f"({n_bases} read bases)",
                         lost, int(np.unpackbits(h.array).sum()))
            check.parity(f"device fill {tid} k={k} default (chunk 2^"
                         f"{bloom_sort.DEFAULT_CHUNK_BASES.bit_length() - 1})"
                         f" == chunked at {chunk} bases",
                         int((d.array != c.array).sum()), len(d.array))


def parity_sealer(check: Checks, batch_bfs, records) -> None:
    """Sealer closures with DeviceBFS masks (hybrid) vs the host search."""
    from goldpolish_tpu.fill import sealer as sl

    cfg = sl.SealerConfig(k_values=K_SWEEP, flank_length=K_SWEEP[0])
    bfs_by_k = {k: batch_bfs.bf_for_k(k) for k in K_SWEEP}
    out_h, st_h = sl.seal_records(records, bfs_by_k, cfg, backend="numpy")
    out_d, st_d = sl.seal_records(records, bfs_by_k, cfg, backend="hybrid")
    check(out_h == out_d and st_h == st_d,
          f"sealer DeviceBFS == host search ({st_d['gaps_closed']} of "
          f"{st_d['gaps_found']} gaps closed by both)")
    check(st_h["gaps_closed"] > 0, "sealer parity closed at least one gap")


def phase_p(check: Checks, argv: list[str], work: str, draft: str, truths,
            l0, clen: int) -> None:
    """Kernel parity at real widths, on the scenario's own batch filters."""
    from goldpolish_tpu import cli
    from goldpolish_tpu.bf_builder import BFBuilder
    from goldpolish_tpu.pipeline import bulk

    cfg = cli.args_to_config(cli.build_parser().parse_args(argv))
    target_index, reads_index = bulk.build_indexes(cfg, work)
    builder = BFBuilder(
        target_index, reads_index,
        bulk.resolve_mappings(cfg, target_index, work),
        cfg.k_values, hash_num=cfg.hash_num,
        cbf_bytes=cfg.cbf_bytes, bf_bytes=cfg.bf_bytes,
        subsample_max_mapped_seqs_per_target_10kbp=cfg.resolved_subsample(),
    )
    drafts = dict(read_records(draft))
    c0 = l0[0][0]
    batch0 = builder.build_batch([c0])
    draft0 = drafts[c0].encode()
    t0 = time.monotonic()
    parity_hashes(check, truths[0].encode())
    parity_scan(check, batch0, draft0)
    parity_fused_eval(check, batch0.bf_for_k(32), draft0)
    parity_siteeval(check, batch0.bf_for_k(32), draft0)
    fills0 = BFBuilder.device_fills
    parity_device_fill(check, builder, [t for t, _ in l0[:2]])
    check(BFBuilder.device_fills > fills0,
          f"P completed {BFBuilder.device_fills - fills0} device fills")
    dbfs0 = counters()["device_bfs_dispatches"]
    gapped = [
        (f"{t_id} c", t[: clen // 2] + "n" * 60 + t[clen // 2 + 60:])
        for (t_id, _s), t in zip(l0[:2], truths[:2])
    ]
    parity_sealer(check, builder.build_batch([t for t, _ in l0[:2]]), gapped)
    check(counters()["device_bfs_dispatches"] > dbfs0, "P ran DeviceBFS")
    print(f"smoke timing (not a benchmark result): P "
          f"{time.monotonic() - t0:.1f} s", flush=True)


def sharded_scan_parity(check: Checks, truth: str, clen: int,
                        n_dev: int) -> None:
    """The gather scan sharded over the n_dev-device dp mesh at real width:
    a mesh of every device, non-degenerate shards, host-equal bits."""
    import numpy as np

    from goldpolish_tpu.ops import bloom, nthash as nt, scan_conv

    bf_bytes = 512 * 1024  # BFBuilder's autoscale: ~16 bits per base
    while bf_bytes < 2 * clen:
        bf_bytes *= 2
    bf = bloom.BloomFilter(bf_bytes, H, 32)
    codes = np.frombuffer(truth.encode(), np.uint8)
    hashes = nt.multi_hashes(nt.canonical_hashes(codes, 32), 32, H)
    bf.insert(hashes[::3])
    scanner = scan_conv.DeviceScanner(bf)
    check(scanner._mesh is not None and scanner._mesh.devices.size == n_dev,
          f"scanner mesh spans {n_dev} devices")
    packed = scanner.scan_packed(np.tile(codes[None], (n_dev, 1)), 32)
    check(len(packed.sharding.device_set) == n_dev,
          f"scan output sharded over {n_dev} devices ({packed.sharding})")
    got = np.unpackbits(np.asarray(packed), axis=1,
                        bitorder="little")[:, : len(hashes)]
    check.parity(f"sharded gather scan ({n_dev} rows x {len(codes)} bases)",
                 int((got != bf.contains(hashes)[None]).sum()), got.size)


# --- main ------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="the four-GPU path only (L0, L1 sharded, sharded "
                         "scan parity)")
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="tiny scenario on the CPU (never a GPU result)")
    args = ap.parse_args(argv)
    want = 4 if args.four else 1
    if args.cpu_rehearsal:
        os.environ["JAX_PLATFORMS"] = "cpu"
        if args.four:
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "")
                + " --xla_force_host_platform_device_count=4"
            )
    elif not args.four:
        os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    # the scenario is fixed: 10 x 2 Mbp on the GPU; the rehearsal's tiny
    # size exists only behind --cpu-rehearsal
    n_contigs, clen = (3, 60_000) if args.cpu_rehearsal else (10, 2_000_000)

    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import jax

    import goldpolish_tpu  # noqa: F401 — x64 + compile cache
    from goldpolish_tpu import native

    devs = jax.devices()
    platform = devs[0].platform
    print(f"jax.devices(): {devs}", flush=True)
    if platform != "gpu" and not args.cpu_rehearsal:
        print(f"no GPU: JAX's first device is {platform!r}", file=sys.stderr)
        return 2
    if len(devs) != want:
        print(f"need {want} device(s), JAX sees {len(devs)}", file=sys.stderr)
        return 2
    if args.cpu_rehearsal:
        print(f"card: none — CPU rehearsal on platform {platform!r}, "
              "not a GPU result", flush=True)
    else:
        print(f"card: {card_line()}", flush=True)
    lib = native.lib()
    print(f"native library: {lib._name}", flush=True)
    print(f"scenario: {n_contigs} x {clen} bp contigs ({n_contigs * clen} bp "
          f"draft), errors every 400 bp, one 60-base n gap per contig, ~10x "
          f"20 kbp reads, k {K_SWEEP}, Sealer on, -b 1, seed {args.seed}",
          flush=True)

    import pipeline_bench

    check = Checks()
    work = os.path.join(REPO, ".smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    try:
        truths, draft, reads, paf, n_err = pipeline_bench.generate(
            work, n_contigs, clen, args.seed, gap_len=60,
        )
        ws = os.path.join(work, "ws")

        def leg_argv(out, *extra, d=draft, p=None):
            return [d, reads, out, "--mappings", p or paf, "-m", ws, *extra]

        out0 = os.path.join(work, "L0.fa")
        run_leg("L0 numpy (host anchor)", leg_argv(out0))
        l0 = read_records(out0)
        n_rec = sum(s.upper() == t for (_i, s), t in zip(l0, truths))
        print(f"L0 recovered {n_rec} of {len(truths)} contigs "
              f"({n_err} draft errors)", flush=True)
        if not args.four:
            # P before the device legs: it compiles the device fill that
            # L3's overlapped fill then reuses
            phase_p(check, leg_argv(os.path.join(work, "P.fa")), work, draft,
                    truths, l0, clen)

        out1 = os.path.join(work, "L1.fa")
        d1, _e = run_leg(f"L1 hybrid on {want} device(s)",
                             leg_argv(out1, "--backend", "hybrid"),
                             force_device_scan=True)
        check(open(out1, "rb").read() == open(out0, "rb").read(),
              "L1 hybrid output byte-identical to L0")
        check(d1["scanpipe_calls"] > 0 and d1["fused_eval_calls"] > 0,
              "L1 ran the scan pipeline and the fused eval on the device")

        if args.four:
            sharded_scan_parity(check, truths[0], clen, want)
        else:
            ids = [t for t, _ in l0[:L2_CONTIGS]]
            print(f"L2 cut: the jax backend polishes the first "
                  f"{len(ids)} of {len(l0)} contigs", flush=True)
            sd, sp = subset_inputs(draft, paf, set(ids), work)
            out2 = os.path.join(work, "L2.fa")
            d2, _e = run_leg("L2 jax", leg_argv(out2, "--backend", "jax",
                                                    d=sd, p=sp))
            check(read_records(out2) == l0[: len(ids)],
                  f"L2 jax output identical to L0 on {len(ids)} contig(s)")
            check(d2["jax_scan_calls"] > 0, "L2 ran device scans")
            check(d2["device_dbg_calls"] > 0, "L2 ran DeviceDBG probes")

            out3 = os.path.join(work, "L3.fa")
            d3, errs = run_leg(
                "L3 hybrid --fill-overlap",
                leg_argv(out3, "--backend", "hybrid", "--fill-overlap"),
                force_device_scan=True,
            )
            l3 = read_records(out3)
            n_ok = sum(s == t for (_i, s), t in zip(l3, truths))
            check(n_ok == len(truths),
                  f"L3 recovered the truth on {n_ok} of {len(truths)} contigs")
            check(d3["scanpipe_calls"] > 0 and d3["fused_eval_calls"] > 0,
                  "L3 ran the scan pipeline and the fused eval on the device")
            check(errs == 0, f"L3 logged {errs} errors (device fill failures)")
            print(f"L3 device-claimed fills completed: {d3['device_fills']}",
                  flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    if check.failed:
        print(f"{len(check.failed)} check(s) failed: {check.failed}",
              file=sys.stderr)
        return 1
    print(result_line(platform, devs[0].device_kind, len(devs)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
