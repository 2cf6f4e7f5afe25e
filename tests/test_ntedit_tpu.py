"""Differential testing: two-phase engine vs the exact oracle editor.

The engine must produce byte-identical output and identical substitution
records on adversarial inputs: clustered errors (inside one k-window),
indels, IUPAC codes, N runs, errors at contig boundaries, lowercase bases,
and a deliberately undersized Bloom filter (high false-positive rate) that
maximizes weird decision paths.
"""

import numpy as np
import pytest

from goldpolish_tpu.ops import bloom, nthash as nt
from goldpolish_tpu.polish import ntedit_oracle as ne
from goldpolish_tpu.polish.ntedit_tpu import NtEditTPU

K, H = 32, 4


def _bf_from(truth: str, bytes_size=1 << 17):
    bf = bloom.BloomFilter(bytes_size, H, K)
    base = nt.canonical_hashes(nt.encode(truth), K)
    bf.insert(nt.multi_hashes(base, K, H))
    return bf


def _genome(rng, n):
    return "".join(rng.choice(list("ACGT")) for _ in range(n))


def _mutate(rng, truth, n_err, kinds="sid", span=None):
    draft = list(truth)
    lo, hi = span or (K, len(truth) - K)
    positions = sorted(rng.choice(np.arange(lo, hi), n_err, replace=False))[::-1]
    for i, p in enumerate(positions):
        kind = kinds[i % len(kinds)]
        if kind == "s":
            draft[p] = "ACGT"[(("ACGT".index(draft[p])) + 1 + int(rng.integers(3))) % 4]
        elif kind == "i":
            draft.insert(p, str(rng.choice(list("ACGT"))))
        elif kind == "d":
            del draft[p]
    return "".join(draft)


def _check_equal(draft: bytes, bf, cfg, backend="numpy"):
    """Both engine paths — the native walk (gp_polish_contig, the default)
    and the Python two-phase engine (GPTPU_NO_NATIVE_WALK=1) — must match
    the oracle byte-for-byte."""
    import os

    out_o, recs_o, ed_o = ne.polish_contig(draft, bf, cfg)
    for no_walk in ("", "1"):
        os.environ["GPTPU_NO_NATIVE_WALK"] = no_walk
        try:
            eng = NtEditTPU(cfg, bf, backend=backend)
            out_t, recs_t, ed_t = eng.polish_contig(draft)
        finally:
            del os.environ["GPTPU_NO_NATIVE_WALK"]
        path = "two-phase" if no_walk else "native-walk"
        assert out_t == out_o, (
            f"[{path}] output mismatch: lens {len(out_t)} vs {len(out_o)}, "
            f"first diff at "
            f"{next((i for i, (a, b) in enumerate(zip(out_t, out_o)) if a != b), -1)}"
        )
        assert recs_t == recs_o, f"[{path}] records mismatch"
        assert (ed_t.n_subs, ed_t.n_ins, ed_t.n_dels) == (
            ed_o.n_subs, ed_o.n_ins, ed_o.n_dels,
        ), f"[{path}] stats mismatch"
    return out_o, ed_o


CFG = dict(k=K, h=H, use_ratio=True)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_mixed_errors_match(seed):
    rng = np.random.default_rng(seed)
    truth = _genome(rng, 3000)
    bf = _bf_from(truth)
    draft = _mutate(rng, truth, 12, "sid").encode()
    cfg = ne.Config(**CFG)
    out, ed = _check_equal(draft, bf, cfg)
    assert ed.n_subs + ed.n_ins + ed.n_dels > 0


def test_clustered_errors_match():
    """Errors within one k-window interact; dirty-zone handling must agree."""
    rng = np.random.default_rng(10)
    truth = _genome(rng, 2000)
    bf = _bf_from(truth)
    draft = bytearray(truth.encode())
    # two substitutions 5bp apart, and a sub+del 7bp apart
    draft[500] = ord("A") if draft[500] != ord("A") else ord("C")
    draft[505] = ord("G") if draft[505] != ord("G") else ord("T")
    draft[900] = ord("A") if draft[900] != ord("A") else ord("C")
    del draft[907]
    _check_equal(bytes(draft), bf, ne.Config(**CFG))


def test_dense_error_storm_matches():
    """1% error rate — many overlapping dirty zones."""
    rng = np.random.default_rng(11)
    truth = _genome(rng, 4000)
    bf = _bf_from(truth)
    draft = _mutate(rng, truth, 40, "ssid").encode()
    _check_equal(draft, bf, ne.Config(**CFG))


def test_high_fp_bloom_matches():
    """Tiny BF -> massive false-positive rate -> pathological decisions."""
    rng = np.random.default_rng(12)
    truth = _genome(rng, 1500)
    bf = _bf_from(truth, bytes_size=1 << 11)  # tiny -> high FP
    draft = _mutate(rng, truth, 8, "sid").encode()
    _check_equal(draft, bf, ne.Config(**CFG))


def test_iupac_and_n_runs_match():
    rng = np.random.default_rng(13)
    truth = _genome(rng, 2000)
    bf = _bf_from(truth)
    draft = bytearray(_mutate(rng, truth, 6, "s").encode())
    draft[400:410] = b"N" * 10
    draft[800] = ord("R")
    draft[1200:1203] = b"ryw"  # lowercase IUPAC
    _check_equal(bytes(draft), bf, ne.Config(**CFG))


def test_lowercase_draft_matches():
    rng = np.random.default_rng(14)
    truth = _genome(rng, 1500)
    bf = _bf_from(truth)
    draft = _mutate(rng, truth, 6, "sd").lower().encode()
    _check_equal(draft, bf, ne.Config(**CFG))


def test_errors_near_boundaries_match():
    rng = np.random.default_rng(15)
    truth = _genome(rng, 1200)
    bf = _bf_from(truth)
    draft = bytearray(truth.encode())
    draft[K + 2] = ord("A") if draft[K + 2] != ord("A") else ord("C")
    p = len(draft) - K - 3
    draft[p] = ord("A") if draft[p] != ord("A") else ord("C")
    _check_equal(bytes(draft), bf, ne.Config(**CFG))


def test_threshold_mode_xy_matches():
    """x/y thresholds (use_ratio=False) decision parity."""
    rng = np.random.default_rng(16)
    truth = _genome(rng, 2000)
    bf = _bf_from(truth)
    draft = _mutate(rng, truth, 10, "sid").encode()
    cfg = ne.Config(k=K, h=H, use_ratio=False, missing_threshold=5.0, edit_threshold=9.0)
    _check_equal(draft, bf, cfg)


def test_mask_mode_matches():
    rng = np.random.default_rng(17)
    truth = _genome(rng, 1500)
    bf = _bf_from(truth)
    draft = bytearray(truth.encode())
    for p in range(600, 640):  # unfixable corruption
        draft[p] = ord(rng.choice(list("ACGT")))
    _check_equal(bytes(draft), bf, ne.Config(**CFG, mask=1))


def test_mode1_matches():
    rng = np.random.default_rng(18)
    truth = _genome(rng, 1500)
    bf = _bf_from(truth)
    draft = _mutate(rng, truth, 8, "sid").encode()
    _check_equal(draft, bf, ne.Config(**CFG, mode=1))


def test_multibase_indels_match():
    rng = np.random.default_rng(19)
    truth = _genome(rng, 2500)
    bf = _bf_from(truth)
    draft = list(truth)
    # 3-base deletion from draft (engine must insert 3 bases back)
    del draft[700:703]
    # 4-base insertion into draft (engine must delete 4 bases)
    for c in "TGCA":
        draft.insert(1500, c)
    draft = "".join(draft).encode()
    out, ed = _check_equal(draft, bf, ne.Config(**CFG))
    assert out == truth.encode()


def test_clean_contig_fast_path():
    rng = np.random.default_rng(20)
    truth = _genome(rng, 5000)
    bf = _bf_from(truth)
    out, recs, _ = NtEditTPU(ne.Config(**CFG), bf).polish_contig(truth.encode())
    assert out == truth.encode() and recs == []


def test_jax_backend_matches_numpy_backend():
    rng = np.random.default_rng(30)
    truth = _genome(rng, 3000)
    bf = _bf_from(truth)
    draft = _mutate(rng, truth, 15, "sid").encode()
    cfg = ne.Config(**CFG)
    out_n, recs_n, _ = NtEditTPU(cfg, bf, backend="numpy").polish_contig(draft)
    out_j, recs_j, _ = NtEditTPU(cfg, bf, backend="jax").polish_contig(draft)
    assert out_j == out_n and recs_j == recs_n


def test_fuzz_many_seeds():
    """Broad randomized differential sweep."""
    for seed in range(40, 52):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(400, 2500))
        truth = _genome(rng, n)
        bf = _bf_from(truth, bytes_size=1 << int(rng.integers(12, 18)))
        n_err = int(rng.integers(0, max(2, n // 150)))
        kinds = rng.choice(["s", "si", "sd", "sid", "i", "d"])
        draft = _mutate(rng, truth, n_err, kinds) if n_err else truth
        cfg = ne.Config(
            k=K, h=H,
            use_ratio=bool(rng.integers(2)),
            mode=int(rng.choice([0, 0, 0, 1])),
            mask=int(rng.integers(2)),
        )
        _check_equal(draft.encode(), bf, cfg)


def test_polish_many_matches_single_jax():
    rng = np.random.default_rng(33)
    truth = _genome(rng, 2500)
    bf = _bf_from(truth)
    cfg = ne.Config(**CFG)
    seqs = []
    for i in range(5):
        d = _mutate(np.random.default_rng(40 + i), truth, 6, "sid")
        seqs.append(d.encode())
    eng = NtEditTPU(cfg, bf, backend="jax")
    many = eng.polish_many(seqs)
    for s, (out_m, recs_m, _) in zip(seqs, many):
        out_1, recs_1, _ = NtEditTPU(cfg, bf, backend="numpy").polish_contig(s)
        assert out_m == out_1 and recs_m == recs_1


def test_hybrid_backend_matches():
    rng = np.random.default_rng(50)
    truth = _genome(rng, 2500)
    bf = _bf_from(truth)
    draft = _mutate(rng, truth, 10, "sid").encode()
    cfg = ne.Config(**CFG)
    out_n, recs_n, _ = NtEditTPU(cfg, bf, backend="numpy").polish_contig(draft)
    out_h, recs_h, _ = NtEditTPU(cfg, bf, backend="hybrid").polish_contig(draft)
    assert out_h == out_n and recs_h == recs_n


def test_polish_many_processes_matches():
    """Fork-pool commit walks produce identical output + records; the third
    element degrades to a picklable EditStats with matching counters."""
    rng = np.random.default_rng(61)
    truth = _genome(rng, 2500)
    bf = _bf_from(truth)
    cfg = ne.Config(**CFG)
    seqs = [
        _mutate(np.random.default_rng(70 + i), truth, 6, "sid").encode()
        for i in range(5)
    ]
    eng = NtEditTPU(cfg, bf, backend="jax")
    base = eng.polish_many(seqs)
    pooled = eng.polish_many(seqs, processes=3)
    for (out_b, recs_b, ed_b), (out_p, recs_p, st_p) in zip(base, pooled):
        assert out_p == out_b and recs_p == recs_b
        assert (st_p.n_subs, st_p.n_ins, st_p.n_dels, st_p.n_masked) == (
            ed_b.n_subs, ed_b.n_ins, ed_b.n_dels, ed_b.n_masked
        )


@pytest.mark.slow
def test_fastwalk_off_matches(monkeypatch):
    """The native bulk clean-run must be a pure optimization: output with
    GPTPU_NO_FASTWALK=1 (scalar walk) is byte-identical, for both the
    engine and the raw oracle.  Guards against a shared fast-path bug
    cancelling out in the engine-vs-oracle differentials."""
    for seed in range(80, 88):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(600, 3000))
        truth = _genome(rng, n)
        bf = _bf_from(truth, bytes_size=1 << int(rng.integers(13, 18)))
        n_err = int(rng.integers(0, max(2, n // 120)))
        kinds = rng.choice(["s", "si", "sd", "sid", "i", "d"])
        draft = (_mutate(rng, truth, n_err, kinds) if n_err else truth).encode()
        cfg = ne.Config(
            k=K, h=H, use_ratio=True,
            mode=int(rng.choice([0, 1])), mask=int(rng.integers(2)),
        )
        fast_o = ne.polish_contig(draft, bf, cfg)
        fast_e = NtEditTPU(cfg, bf, backend="numpy").polish_contig(draft)
        monkeypatch.setenv("GPTPU_NO_FASTWALK", "1")
        slow_o = ne.polish_contig(draft, bf, cfg)
        slow_e = NtEditTPU(cfg, bf, backend="numpy").polish_contig(draft)
        monkeypatch.delenv("GPTPU_NO_FASTWALK")
        assert fast_o[0] == slow_o[0] and fast_o[1] == slow_o[1], seed
        assert fast_e[0] == slow_e[0] and fast_e[1] == slow_e[1], seed


def test_advance_n_matches_increment():
    """_advance_n == m sequential increments on randomized ropes."""
    from goldpolish_tpu.polish.ntedit_oracle import Node, _Editor, _advance_n

    rng = np.random.default_rng(5)
    for trial in range(200):
        # random rope: draft spans interleaved with literal nodes
        rope = []
        p = 0
        for _ in range(int(rng.integers(1, 6))):
            span = int(rng.integers(1, 30))
            rope.append(Node(0, p, p + span - 1, 0, 0))
            p += span
            if rng.integers(2):
                for _ in range(int(rng.integers(1, 3))):
                    rope.append(Node(1, 0, 0, ord("A"), 0))
        pos, ni = rope[0].s_pos, 0
        m = int(rng.integers(0, p + 5))
        want = (pos, ni)
        steps = 0
        for _ in range(m):
            if want[1] >= len(rope):  # roll() guards this before increment
                break
            want = _Editor.increment(want[0], want[1], rope)
            steps += 1
        got = _advance_n(pos, ni, steps, rope)
        assert got == want, (trial, m)


def test_polish_many_sharded_matches():
    """A long contig split at clean cut points polishes byte-identically
    (and records carry global positions)."""
    rng = np.random.default_rng(91)
    truth = _genome(rng, 60_000)
    bf = _bf_from(truth, bytes_size=1 << 18)
    cfg = ne.Config(**CFG, mode=1, mask=1)
    d = list(truth)
    for p in range(500, 59_000, 2_111):
        d[p] = "ACGT"[("ACGT".index(d[p]) + 1) % 4]
    # an insertion and a deletion so coordinates shift inside slices
    d.insert(20_000, "T")
    del d[40_000]
    draft = "".join(d).encode()
    eng = NtEditTPU(cfg, bf, backend="numpy")
    base_out, base_recs, base_ed = eng.polish_contig(draft)
    out, recs, st = eng.polish_many([draft], processes=3, shard_bases=15_000)[0]
    assert out == base_out
    assert recs == base_recs
    assert (st.n_subs, st.n_ins, st.n_dels, st.n_masked) == (
        base_ed.n_subs, base_ed.n_ins, base_ed.n_dels, base_ed.n_masked
    )


def test_find_cuts_avoids_dirty_zones():
    from goldpolish_tpu.polish.ntedit_tpu import _find_cuts

    present = np.ones(10_000, bool)
    present[4_950:5_050] = False  # dirty neighbourhood at the midpoint
    cuts = _find_cuts(present, 32, 10_031, 2)
    assert cuts, "a clean cut must exist away from the dirty zone"
    for c in cuts:
        assert present[c - 64 : c + 64].all()


def test_polish_many_sharded_fuzz():
    for seed in (101, 102, 103):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(20_000, 50_000))
        truth = _genome(rng, n)
        bf = _bf_from(truth, bytes_size=1 << 18)
        kinds = rng.choice(["s", "si", "sd", "sid"])
        draft = _mutate(rng, truth, n // 900, kinds).encode()
        cfg = ne.Config(**CFG, mode=1, mask=1)
        eng = NtEditTPU(cfg, bf, backend="numpy")
        base_out, base_recs, _ = eng.polish_contig(draft)
        out, recs, _ = eng.polish_many(
            [draft], processes=4, shard_bases=8_000
        )[0]
        assert out == base_out and recs == base_recs, seed
