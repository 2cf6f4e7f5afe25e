"""goldpolish_tpu — a JAX long-read genome polishing framework.

A from-scratch JAX/XLA reimplementation of the GoldPolish (GoldRush-Edit)
assembly-polishing pipeline (reference: bcgsc/goldpolish).  The pipeline
semantics are preserved — SeqIndex + read->contig mappings -> per-batch
multi-k Bloom filters -> ntEdit-style k-mer edit scan -> Sealer-style de
Bruijn gap fill -> ordered merge — but the compute path is redesigned for an
accelerator (an NVIDIA GPU) next to a multi-core host:

 * ntHash rolling hashes are computed for *all* windows at once (a conv over
   one-hot bases, or a prefix-XOR scan + per-position split-rotations)
   instead of the reference's sequential O(n) roll (reference:
   subprojects/ntedit/lib/nthash.hpp:100-131).
 * Bloom filter probes are batched device gathers against device-resident
   bit arrays instead of per-position pointer chasing.
 * The ntEdit editor runs as a two-phase engine: a batched detect+propose
   device pass over fixed-shape candidate lanes, then a cheap sequential
   host commit that replays the reference's exact edit-interaction semantics
   (reference: subprojects/ntedit/ntedit.cpp:1414-1771).
 * Process/FIFO orchestration (reference: scripts/goldpolish:446-583) is
   replaced by a single-process async engine; multi-host scale-out uses
   jax.sharding.Mesh + collectives instead of /dev/shm + named pipes.

64-bit integer support: ntHash is a 64-bit hash, so jax x64 is enabled at
import and jnp.uint64 is available on every backend.
"""

import os as _os

import jax as _jax

_jax.config.update("jax_enable_x64", True)

# Persistent compilation cache.  JAX_COMPILATION_CACHE_DIR, when set, is
# JAX's own setting and wins untouched (an empty value switches the cache
# off).  Otherwise the cache lives at one fixed path inside the checkout
# (git-ignored): the path is part of the cache key, so it must not move.
CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache",
)


def _configure_compile_cache() -> None:
    if "JAX_COMPILATION_CACHE_DIR" in _os.environ:
        return
    try:
        _os.makedirs(CACHE_DIR, exist_ok=True)
    except OSError:  # read-only checkout: run without a persistent cache
        return
    _jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


_configure_compile_cache()

__version__ = "0.1.0"
