"""End-to-end backend-invariance golden: the SAME
reference-scale inputs must polish byte-identically across

  * backend="numpy" (the exactness anchor),
  * backend="hybrid" with the device scan AND fused site eval forced on
    (GPTPU_FORCE_DEVICE_SCAN / GPTPU_DEVICE_EVAL — the CPU mesh would
    otherwise A/B them to host),
  * the fork-pool path (process_pool=True).

k values are subset to [32, 28] to bound runtime; the full 4-k sweep's
bytes are pinned separately by test_golden_refscale."""

import os

import pytest

import refscale
from goldpolish_tpu.pipeline import bulk


@pytest.mark.skipif(
    not os.path.exists(refscale.REF_BULK_DRAFT), reason="reference data absent"
)
@pytest.mark.slow
def test_bulk_backend_invariance(tmp_path, monkeypatch):
    outs = {}
    for name, backend, pool, env in (
        ("numpy", "numpy", False, {}),
        ("numpy_pool", "numpy", True, {}),
        ("hybrid_forced", "hybrid", False,
         {"GPTPU_FORCE_DEVICE_SCAN": "1", "GPTPU_DEVICE_EVAL": "1"}),
    ):
        for key, val in env.items():
            monkeypatch.setenv(key, val)
        sub = tmp_path / name
        sub.mkdir()
        cfg = refscale.build_bulk_inputs(str(sub))
        cfg.k_values = [32, 28]
        cfg.backend = backend
        cfg.process_pool = pool
        totals = bulk.run_bulk(cfg)
        assert totals["contigs"] == 152
        outs[name] = open(cfg.output_seqs, "rb").read()
        for key in env:
            monkeypatch.delenv(key)
    assert outs["numpy_pool"] == outs["numpy"], "fork-pool path diverged"
    assert outs["hybrid_forced"] == outs["numpy"], (
        "hybrid (device scan + fused eval) diverged from the host backend"
    )
