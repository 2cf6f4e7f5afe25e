"""Multi-k ntEdit chain + masker unit tests."""

import numpy as np

from goldpolish_tpu.bf_builder import BatchBFs
from goldpolish_tpu.ops import bloom, nthash as nt
from goldpolish_tpu.polish import mask, multik


def _bfs_for(truth, ks, h=4):
    cbfs, bfs = [], []
    for k in ks:
        bf = bloom.BloomFilter(1 << 17, h, k)
        bf.insert(nt.multi_hashes(nt.canonical_hashes(nt.encode(truth), k), k, h))
        bfs.append(bf)
        cbfs.append(bloom.CountingBloomFilter8(1 << 16, h, k))
    return BatchBFs(list(ks), cbfs, bfs)


def test_multik_chain_fixes_with_smaller_k():
    rng = np.random.default_rng(0)
    truth = "".join(rng.choice(list("ACGT")) for _ in range(2000))
    ks = [32, 28]
    batch = _bfs_for(truth, ks)
    draft = bytearray(truth.encode())
    draft[700] = ord("A") if draft[700] != ord("A") else ord("C")
    out, stats = multik.polish_multik([("c1", bytes(draft).decode())], batch)
    assert out[0][1] == truth
    assert len(stats.per_k) == 2
    assert sum(s["subs"] for s in stats.per_k) >= 1
    assert not stats.rolled_back


def test_multik_rollback_guard():
    """If the chain shrinks output below 75%, input passes through
    (reference goldpolish-ntedit:31-40)."""
    recs = [("c1", "ACGT" * 300)]
    shrunk = [("c1", "ACGT" * 10)]
    assert multik._fasta_bytes(shrunk) / multik._fasta_bytes(recs) < 0.75


def test_ntedit_config_matches_pipeline_flags():
    cfg = multik.ntedit_config_for_k(28)
    # goldpolish-ntedit: -d5 -i5 -m1 -a1 -X0.5 -Y0.5
    assert (cfg.k, cfg.mode, cfg.mask) == (28, 1, 1)
    assert cfg.use_ratio and cfg.missing_ratio == 0.5 and cfg.edit_ratio == 0.5
    assert cfg.max_insertions == 5 and cfg.max_deletions == 5


def test_mask_short_runs_soft():
    # short uppercase ACTG run between masked regions is lowercased;
    # the k-length sequence ends are uppercased first
    seq = "acgt" * 20 + "ACGTACG" + "acgt" * 20
    out = mask.mask_short_runs(seq, 32, soft=True)
    mid = out[32:-32]  # exclude the uppercased ends
    assert mid == mid.lower()  # the 7-char upper run got lowercased
    assert out[:32].isupper() and out[-32:].isupper()
    assert out == out.strip("Nn")


def test_mask_short_runs_hard():
    # hard mode: short run becomes N, then flanking N runs are stripped,
    # leaving only the long tail
    seq = "N" * 40 + "ACG" + "N" * 40 + "ACGT" * 20
    out = mask.mask_short_runs(seq, 32, soft=False)
    assert out == "ACGT" * 20
    assert not out.startswith("N")


def test_mask_uppercases_k_ends():
    seq = "acgt" * 30  # all lowercase, len 120 >= 2k
    out = mask.mask_short_runs(seq, 32, soft=True)
    assert out == out  # ends uppercased then stripped rules applied
    assert out[:1].isupper() or out == "N"


def test_mask_empty_becomes_N():
    assert mask.mask_short_runs("nnnn", 32) == "N"


def test_to_upper():
    assert mask.to_upper("acgTn") == "ACGTN"


def test_multik_chain_differential_vs_oracle():
    """The full multi-k chain through the two-phase engine must equal the same
    chain driven by the exact oracle editor."""
    from goldpolish_tpu.polish import ntedit_oracle as ne

    rng = np.random.default_rng(9)
    truth = "".join(rng.choice(list("ACGT")) for _ in range(3000))
    ks = [32, 28, 24]
    batch = _bfs_for(truth, ks)
    draft = list(truth)
    for i, p in enumerate(range(300, 2700, 240)):
        kind = i % 3
        if kind == 0:
            draft[p] = "ACGT"[("ACGT".index(draft[p]) + 1) % 4]
        elif kind == 1:
            draft[p] = ""
        else:
            draft[p] = draft[p] + "G"
    draft = "".join(draft)

    engine_out, _ = multik.polish_multik([("c", draft)], batch, k_values=ks)

    cur = draft.encode()
    for k in ks:
        cfg = multik.ntedit_config_for_k(k)
        cur, _, _ = ne.polish_contig(cur, batch.bf_for_k(k), cfg)
    if len(cur) / max(1, len(draft)) >= 0.75:  # chain rollback guard parity
        assert engine_out[0][1] == cur.decode()
