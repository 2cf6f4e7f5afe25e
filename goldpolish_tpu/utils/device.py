"""The one check that a requested device path really runs on the GPU.

JAX falls back to the CPU without a word when it finds no GPU, so a run
that asked for a device path (``--backend jax|hybrid``, ``--fill-overlap``,
``device_bf_build``) would otherwise time XLA's CPU backend and report it
as device work.  Every entry point that takes a device path calls
`require_device` first.  The CPU stays allowed when it was asked for
explicitly (``JAX_PLATFORMS=cpu`` or the ``jax_platforms`` config), which is
how the tests run the device code paths.
"""

from __future__ import annotations


def cpu_requested() -> bool:
    """True when JAX was told to use the CPU first (env or config)."""
    import jax

    platforms = jax.config.jax_platforms or ""
    return platforms.split(",")[0].strip() == "cpu"


def device_path_of(cfg) -> str | None:
    """Name of the device path a PipelineConfig asks for, or None."""
    if cfg.backend in ("jax", "hybrid"):
        return f"--backend {cfg.backend}"
    if cfg.fill_overlap:
        return "--fill-overlap"
    if cfg.device_bf_build:
        return "device_bf_build"
    return None


def require_device(what: str) -> str:
    """Raise unless JAX's first device is a GPU or the CPU was asked for
    explicitly.  Returns the platform name."""
    import jax

    platform = jax.devices()[0].platform
    if platform == "gpu" or (platform == "cpu" and cpu_requested()):
        return platform
    raise RuntimeError(
        f"{what} asks for the device path, but JAX's first device is "
        f"{platform!r}, not a GPU.  Run on a machine with a CUDA GPU, or set "
        "JAX_PLATFORMS=cpu to run the device code on the CPU on purpose."
    )
