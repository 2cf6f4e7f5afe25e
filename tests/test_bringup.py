"""GPU bring-up contracts that the CPU can check: exact hash-bit
recombination, the device-required check, compile-cache placement, the
native build key, device-fill failures that surface, and the chip smoke
script's own helpers."""

import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --- _bits_to_u64: integer recombination, exact for every pattern ---------

@pytest.mark.parametrize("pattern", ["ones", "zeros", "random", "single"])
def test_bits_to_u64_exact(pattern):
    import jax
    import jax.numpy as jnp

    from goldpolish_tpu.ops import scan_conv

    rng = np.random.default_rng(5)
    if pattern == "ones":
        bits = np.ones((3, 64), np.int32)
    elif pattern == "zeros":
        bits = np.zeros((3, 64), np.int32)
    elif pattern == "random":
        bits = rng.integers(0, 2, (257, 64)).astype(np.int32)
    else:  # each single bit alone, the top ones included
        bits = np.eye(64, dtype=np.int32)
    want = np.zeros(len(bits), np.uint64)
    for i in range(64):
        want |= bits[:, i].astype(np.uint64) << np.uint64(i)
    got = np.asarray(jax.jit(scan_conv._bits_to_u64)(jnp.asarray(bits)))
    assert got.dtype == np.uint64
    assert np.array_equal(got, want)


# --- require_device ---------------------------------------------------------

class _Dev:
    def __init__(self, platform):
        self.platform = platform


@pytest.mark.parametrize("case", ["cpu_not_requested", "explicit_cpu", "gpu"])
def test_require_device(case, monkeypatch):
    import jax

    from goldpolish_tpu.utils import device

    if case == "cpu_not_requested":
        monkeypatch.setattr(device, "cpu_requested", lambda: False)
        with pytest.raises(RuntimeError, match="not a GPU"):
            device.require_device("--backend hybrid")
    elif case == "explicit_cpu":
        # the test session asked for the CPU through the jax config
        assert device.cpu_requested()
        assert device.require_device("--backend jax") == "cpu"
    else:
        monkeypatch.setattr(jax, "devices", lambda *a: [_Dev("gpu")])
        monkeypatch.setattr(device, "cpu_requested", lambda: False)
        assert device.require_device("--fill-overlap") == "gpu"


def test_device_path_of_names_every_device_option():
    from goldpolish_tpu.config import PipelineConfig
    from goldpolish_tpu.utils.device import device_path_of

    assert device_path_of(PipelineConfig()) is None
    assert device_path_of(PipelineConfig(backend="hybrid")) == "--backend hybrid"
    assert device_path_of(PipelineConfig(fill_overlap=True)) == "--fill-overlap"
    assert device_path_of(PipelineConfig(device_bf_build=True)) == \
        "device_bf_build"


def test_bulk_refuses_device_path_without_gpu(tmp_path, monkeypatch):
    from goldpolish_tpu.config import PipelineConfig
    from goldpolish_tpu.pipeline import bulk
    from goldpolish_tpu.utils import device

    monkeypatch.setattr(device, "cpu_requested", lambda: False)
    cfg = PipelineConfig(seqs_to_polish=str(tmp_path / "none.fa"),
                         backend="hybrid")
    with pytest.raises(RuntimeError, match="--backend hybrid"):
        bulk.run_bulk(cfg)


# --- compile cache placement -----------------------------------------------

@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(env_set, monkeypatch):
    import jax

    import goldpolish_tpu

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, val: calls.append((name, val)))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
        goldpolish_tpu._configure_compile_cache()
        assert calls == []  # JAX's own setting wins untouched
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        goldpolish_tpu._configure_compile_cache()
        assert ("jax_compilation_cache_dir", goldpolish_tpu.CACHE_DIR) in calls
        assert goldpolish_tpu.CACHE_DIR == os.path.join(ROOT, ".jax_cache")


# --- native build key --------------------------------------------------------

def test_native_build_key_tracks_flags_and_cpu():
    from goldpolish_tpu import native

    src = b"int f() { return 1; }"
    base = native.build_key(src, ("-O3",), "x86_64|avx2 sse4_2")
    assert base == native.build_key(src, ("-O3",), "x86_64|avx2 sse4_2")
    assert base != native.build_key(src, ("-O2",), "x86_64|avx2 sse4_2")
    assert base != native.build_key(src, ("-O3",), "x86_64|avx512f sse4_2")
    assert base != native.build_key(src, ("-O3",), "aarch64|avx2 sse4_2")
    assert base != native.build_key(src + b" ", ("-O3",), "x86_64|avx2 sse4_2")
    # the loaded library carries the key of this host's CPU and flags
    with open(native._SRC, "rb") as f:
        key = native.build_key(f.read())
    assert os.path.basename(native.lib()._name) == f"gp_native_{key}.so"


# --- device fills surface their failures --------------------------------------

def test_device_fill_failure_raises(tmp_path, monkeypatch):
    from test_pipeline import _write_synthetic

    from goldpolish_tpu.bf_builder import BFBuilder
    from goldpolish_tpu.io import seqindex
    from goldpolish_tpu.mappings import AllMappings
    from goldpolish_tpu.ops import bloom_sort

    draft, reads, paf, _t = _write_synthetic(tmp_path, n_contigs=1)
    t_idx = seqindex.SeqIndex.build(draft)
    r_idx = seqindex.SeqIndex.build(reads)
    builder = BFBuilder(t_idx, r_idx, AllMappings.load(paf, t_idx), [32])

    def boom(*a, **k):
        raise RuntimeError("device fill exploded")

    monkeypatch.setattr(bloom_sort, "device_fill_bfs_sorted", boom)
    fills = BFBuilder.device_fills
    with pytest.raises(RuntimeError, match="exploded"):
        builder.build_batch_device(["ctg0"])
    assert BFBuilder.device_fills == fills


def test_hedge_surfaces_device_exception(tmp_path, monkeypatch):
    """A failed device-claimed fill is counted and logged, the host arm
    fills that batch, and the output is unchanged."""
    import logging

    from goldpolish_tpu.bf_builder import BFBuilder
    from goldpolish_tpu.config import PipelineConfig
    from goldpolish_tpu.io import fasta
    from goldpolish_tpu.pipeline import bulk
    from test_pipeline import _write_synthetic

    draft, reads, paf, truths = _write_synthetic(tmp_path, n_contigs=4)
    calls = []

    def failing(self, ids):
        calls.append(tuple(ids))
        raise RuntimeError("device fill exploded")

    monkeypatch.setattr(BFBuilder, "build_batch_device", failing)
    seen = []

    class Grab(logging.Handler):
        def emit(self, record):
            seen.append(record)

    grab = Grab(level=logging.ERROR)
    logging.getLogger("goldpolish_tpu").addHandler(grab)
    try:
        out = str(tmp_path / "hedge.fa")
        totals = bulk.run_bulk(PipelineConfig(
            seqs_to_polish=draft, polishing_seqs=reads, output_seqs=out,
            k_values=[32], batch_size=1, mappings_path=paf,
            workspace=str(tmp_path), max_concurrent_batches=1,
            backend="hybrid", fill_overlap=True, run_sealer=False,
        ))
    finally:
        logging.getLogger("goldpolish_tpu").removeHandler(grab)
    assert calls, "the device claimer never fired"
    assert totals["device_fill_errors"] == len(calls)
    assert any("device fill failed" in r.getMessage() for r in seen)
    for r, t in zip(fasta.read_seqs(out), truths):
        assert r.seq.rstrip("Nn") == t.strip("N")


# --- chip_smoke.py helpers ---------------------------------------------------

def _chip_smoke():
    sys.path.insert(0, ROOT)
    import chip_smoke

    return chip_smoke


def test_chip_smoke_scenario_generator(tmp_path):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import pipeline_bench

    truths, draft, reads, paf, n_err = pipeline_bench.generate(
        str(tmp_path), 2, 5000, seed=3, frag=2000, step=1000, gap_len=60,
    )
    from goldpolish_tpu.io import fasta

    recs = list(fasta.read_seqs(draft))
    assert [r.id for r in recs] == ["c0", "c1"]
    assert n_err == 2 * len(range(200, 5000 - 200, 400))
    for r in recs:
        assert "n" * 60 in r.seq and "n" * 61 not in r.seq
    assert all(set(t) <= set("ACGT") and len(t) == 5000 for t in truths)
    with open(paf) as f:
        lines = [ln.split("\t") for ln in f]
    assert {ln[5] for ln in lines} == {"c0", "c1"}
    assert len(lines) == sum(1 for ln in open(reads)) // 4


def test_chip_smoke_comparator_and_result_line(capsys):
    import json

    cs = _chip_smoke()
    check = cs.Checks()
    check.parity("same", 0, 10)
    check.parity("empty", 0, 0)  # nothing compared is not a pass
    check.parity("differs", 2, 10)
    assert check(True, "plain")
    assert check.failed == ["parity empty: mismatches=0 of 0",
                            "parity differs: mismatches=2 of 10"]
    out = capsys.readouterr().out
    assert "ok   parity same: mismatches=0 of 10" in out
    line = cs.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert "\n" not in line


def test_chip_smoke_refuses_without_gpu(monkeypatch, capsys):
    """With no GPU and no rehearsal option the script exits nonzero and
    prints no result line."""
    cs = _chip_smoke()
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    assert cs.main([]) == 2
    assert '"ok"' not in capsys.readouterr().out
