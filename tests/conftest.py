"""Test configuration: an 8-device virtual CPU mesh, or the GPU on request.

By default the tests run on the CPU: the jax platform is set to "cpu"
through jax.config before any backend initializes, with 8 virtual devices
so the sharding tests exercise a real mesh, and the device code paths run
on the CPU on purpose (goldpolish_tpu.utils.device allows that explicit
request).  GPTPU_TEST_GPU=1 leaves JAX on its default platform for the
card-only tests (marker `gpu`, see tests/test_gpu.py); they skip through
the `gpu` fixture wherever JAX's first device is not a GPU.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

if not os.environ.get("GPTPU_TEST_GPU"):
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)


def pytest_sessionstart(session):
    """Fail the whole run loudly when the native .so does not build.

    Most modules fall back to slow NumPy paths silently, so a compile
    error would otherwise show up only as mysterious slowness while every
    test still passes (it happened: a mid-file symbol-order bug cost an
    entire perf investigation).  GPTPU_NATIVE_OPTIONAL=1 restores the
    lenient behavior for environments without a toolchain.
    """
    if os.environ.get("GPTPU_NATIVE_OPTIONAL"):
        return
    from goldpolish_tpu import native

    try:
        native.lib()
    except native.NativeUnavailable as e:
        raise RuntimeError(f"native build failed (broken commit?): {e}") from e


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running tests (> ~2s); `-m 'not slow'` is the fast "
        "tier (< 60s) for mid-iteration runs",
    )
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA GPU; run on the card with "
        "`GPTPU_TEST_GPU=1 python -m pytest -m gpu tests/` (skips elsewhere)",
    )


@pytest.fixture
def gpu():
    """The GPU device; skips the test where JAX's first device is not one."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a CUDA GPU (JAX's first device is {dev.platform})")
    return dev
