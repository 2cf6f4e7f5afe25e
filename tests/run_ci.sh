#!/usr/bin/env bash
# CI runner for goldpolish-tpu — encodes the test-tier contract
# (reference analogue: azure-pipelines.yml's 6-job matrix running the
# golden shell tests; here the tiers are pytest markers).
#
# Usage:
#   tests/run_ci.sh            # fast tier (default): ~50s, always run
#   tests/run_ci.sh fast       # same
#   tests/run_ci.sh slow       # slow tier only (golden refscale, soaks): ~6 min
#   tests/run_ci.sh full       # fast + slow (the whole suite)
#   tests/run_ci.sh bench      # explicit host-only bench run (no GPU needed)
#   tests/run_ci.sh all        # full suite, then host bench
#
# Exit code is the first failing stage's.  All stages run from the repo
# root on the CPU backend (tests/conftest.py forces 8 virtual CPU jax
# devices; the bench stage uses GPTPU_BENCH_BACKEND=numpy, an explicit
# host-only run).  GPU runs: `python chip_smoke.py` and the card-only
# tests, `GPTPU_TEST_GPU=1 python -m pytest -m gpu tests/` (README).

set -u
cd "$(dirname "$0")/.."

tier="${1:-fast}"

run_fast() { python -m pytest tests/ -m "not slow" -q; }
run_slow() { python -m pytest tests/ -m "slow" -q; }
run_full() { python -m pytest tests/ -q; }
run_bench() {
    GPTPU_BENCH_BACKEND=numpy GPTPU_BENCH_BASES="${GPTPU_BENCH_BASES:-4000000}" \
        python bench.py
}

case "$tier" in
    fast)  run_fast ;;
    slow)  run_slow ;;
    full)  run_full ;;
    bench) run_bench ;;
    all)   run_full && run_bench ;;
    *)
        echo "usage: tests/run_ci.sh [fast|slow|full|bench|all]" >&2
        exit 2
        ;;
esac
