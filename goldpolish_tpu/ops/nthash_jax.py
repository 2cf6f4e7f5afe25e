"""ntHash v1 — JAX device path (batched, XLA-compiled).

Same closed-form prefix-XOR formulation as ops/nthash.py, expressed in jnp
so XLA can fuse the whole hash computation into a handful of vector ops:

  * table lookup (gather) of per-base seeds,
  * variable split-rotation (shifts/or/and on the VPU),
  * an associative XOR scan (log-depth),
  * windowed XOR + final rotation.

Hashes are uint64 (everything here is bitwise/add, which 32-bit hardware
lanes emulate cheaply).  All
functions are shape-polymorphic over leading batch dimensions and jit-safe
(static k/m only).

Reference semantics: subprojects/ntedit/lib/nthash.hpp (see ops/nthash.py for
the derivation and the bit-exactness tests against the scalar recurrences).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import nthash as _ref

SROL_PERIOD = _ref.SROL_PERIOD
MULTI_SHIFT = _ref.MULTI_SHIFT

SEED_TAB = jnp.asarray(_ref.SEED_TAB)
RC_SEED_TAB = jnp.asarray(_ref.RC_SEED_TAB)
_MULTI_SEED = jnp.uint64(int(_ref.MULTI_SEED))
_M31 = jnp.uint64(_ref.MASK31)
_M33 = jnp.uint64(_ref.MASK33)


def srol_n(v, n):
    """srol^n with per-element rotation counts (uint64 arrays)."""
    n = jnp.asarray(n)
    s31 = (n % 31).astype(jnp.uint64)
    s33 = (n % 33).astype(jnp.uint64)
    hi = v >> jnp.uint64(33)
    lo = v & _M33
    hi = ((hi << s31) | (hi >> (jnp.uint64(31) - s31))) & _M31
    lo = ((lo << s33) | (lo >> (jnp.uint64(33) - s33))) & _M33
    return (hi << jnp.uint64(33)) | lo


def cumxor(a):
    """Inclusive prefix-XOR along the last axis (Hillis-Steele, log-depth).

    Chosen over lax.associative_scan: the unrolled shift/XOR ladder compiles
    in ~1s where associative_scan's odd/even recursion takes tens of seconds
    for uint64 inputs.
    """
    n = a.shape[-1]
    pad = [(0, 0)] * (a.ndim - 1)
    shift = 1
    while shift < n:
        a = a ^ jnp.pad(a, pad + [(shift, 0)])[..., :n]
        shift *= 2
    return a


def _window_xor(prefix, k):
    """XOR over each k-window given a prefix-XOR array (last axis)."""
    n = prefix.shape[-1]
    w = prefix[..., k - 1 :]
    w = w.at[..., 1:].set(w[..., 1:] ^ prefix[..., : n - k])
    return w


def forward_hashes(codes, k: int):
    """Forward-strand hash of every k-window; codes uint8[..., n]."""
    n = codes.shape[-1]
    idx = jnp.arange(n, dtype=jnp.int32)
    a = srol_n(SEED_TAB[codes], (-idx) % SROL_PERIOD)
    p = cumxor(a)
    w = _window_xor(p, k)
    wi = jnp.arange(n - k + 1, dtype=jnp.int32)
    return srol_n(w, (wi + k - 1) % SROL_PERIOD)


def reverse_hashes(codes, k: int):
    """Reverse-strand hash of every k-window; codes uint8[..., n]."""
    n = codes.shape[-1]
    idx = jnp.arange(n, dtype=jnp.int32)
    b = srol_n(RC_SEED_TAB[codes], idx % SROL_PERIOD)
    q = cumxor(b)
    w = _window_xor(q, k)
    wi = jnp.arange(n - k + 1, dtype=jnp.int32)
    return srol_n(w, (-wi) % SROL_PERIOD)


def canonical_hashes(codes, k: int):
    """Canonical (fh+rh, wrapping) hash of every k-window."""
    return forward_hashes(codes, k) + reverse_hashes(codes, k)


def strand_hashes(codes, k: int):
    """(forward, reverse) hash arrays of every k-window — when the caller
    needs the split state (e.g. for changelast-style candidate deltas)."""
    return forward_hashes(codes, k), reverse_hashes(codes, k)


def nte64(base_hash, k: int, i):
    """Extra hash i (>=1) from the canonical base hash (nthash.hpp:261-266)."""
    mult = jnp.asarray(i, jnp.uint64) ^ (jnp.uint64(k) * _MULTI_SEED)
    t = base_hash * mult
    return t ^ (t >> jnp.uint64(MULTI_SHIFT))


def multi_hashes(base_hash, k: int, m: int):
    """All m hashes; appends a trailing axis of size m."""
    outs = [base_hash]
    for i in range(1, m):
        outs.append(nte64(base_hash, k, i))
    return jnp.stack(outs, axis=-1)


# Jitted entry points (eager-mode u64 dispatch is extremely slow; always go
# through these from host code).  Recompiles per input shape — callers
# bucket/pad shapes.
canonical_hashes_jit = jax.jit(canonical_hashes, static_argnums=1)
strand_hashes_jit = jax.jit(strand_hashes, static_argnums=1)
multi_hashes_jit = jax.jit(multi_hashes, static_argnums=(1, 2))
