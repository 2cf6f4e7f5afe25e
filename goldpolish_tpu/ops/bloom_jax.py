"""Device-side Bloom filter probes and builders (JAX).

The plain BF (512 KiB default) is the hot data structure of the whole
pipeline: every candidate edit in the ntEdit scan and every BFS expansion in
the Sealer gap fill is a membership probe.  On the device the filter lives
as a uint32 word array (little-endian view of the byte array, which preserves
bit indexing — see ops/bloom.py) and probes are batched gathers + bit tests,
replacing the reference's per-position pointer chasing
(reference: subprojects/ntedit/ntedit.cpp:1470,1503; Konnector DBGBloom.h).

With the default sizing the bit count is a power of two, so hash % bits is a
mask — checked statically below.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import nthash_jax as ntj


def to_device_words(bf) -> jnp.ndarray:
    """Upload a host BloomFilter's bit array as uint32 words."""
    return jnp.asarray(bf.words_u32())


def probe_words(words: jnp.ndarray, bits: int, hashes: jnp.ndarray) -> jnp.ndarray:
    """Membership test for hash tuples.

    words: uint32[bits/32] device array.
    bits:  static total bit count.
    hashes: uint64[..., hash_num].
    returns bool[...] — True where all hash_num bits are set.
    """
    return bit_set(words, probe_index(hashes, bits)).all(axis=-1)


def probe_index(hashes: jnp.ndarray, bits: int) -> jnp.ndarray:
    """Bit index (uint32) of each hash in a `bits`-bit filter."""
    if bits & (bits - 1) == 0:
        return (hashes & jnp.uint64(bits - 1)).astype(jnp.uint32)
    return (hashes % jnp.uint64(bits)).astype(jnp.uint32)


def bit_set(words: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """bool: is bit `idx` of the uint32 word array set (a gather)."""
    word = words[(idx >> jnp.uint32(5)).astype(jnp.int32)]
    return (word >> (idx & jnp.uint32(31))) & jnp.uint32(1) != 0


def probe_kmers(words: jnp.ndarray, bits: int, hash_num: int, k: int, codes: jnp.ndarray) -> jnp.ndarray:
    """Probe every k-window of `codes` (uint8[..., n]) -> bool[..., n-k+1]."""
    base = ntj.canonical_hashes(codes, k)
    hashes = ntj.multi_hashes(base, k, hash_num)
    return probe_words(words, bits, hashes)




def build_words(bits: int, hashes: jnp.ndarray, mask=None) -> jnp.ndarray:
    """Build a plain BF on device from a batch of hash tuples.

    hashes: uint64[..., hash_num]; mask: optional bool[...] selecting valid
    tuples (padding lanes scatter to a dead slot).  Returns uint32 words.

    XLA scatter has no bitwise-or mode, so bits are first set in a per-bit
    uint8 array (duplicate writes all store 1 — order-free) and then packed
    into uint32 words with a sum of distinct powers of two (equal to OR
    because every bit position within a word is distinct).
    """
    flat = hashes.reshape(-1)
    if bits & (bits - 1) == 0:
        idx = (flat & jnp.uint64(bits - 1)).astype(jnp.int32)
    else:
        idx = (flat % jnp.uint64(bits)).astype(jnp.int32)
    if mask is not None:
        h = hashes.shape[-1]
        mflat = jnp.repeat(mask.reshape(-1), h)
        # out-of-bounds sentinel: mode="drop" discards OOB indices, but a
        # negative index would *wrap* like numpy indexing
        idx = jnp.where(mflat, idx, bits)
    bitarr = jnp.zeros(bits, dtype=jnp.uint8).at[idx].set(1, mode="drop")
    pows = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[None, :]
    return (bitarr.reshape(-1, 32).astype(jnp.uint32) * pows).sum(
        axis=1, dtype=jnp.uint32
    )


def counted_build_words(
    bits_bf: int,
    cbf_size: int,
    hash_num: int,
    hashes: jnp.ndarray,
    threshold: int,
    mask=None,
) -> jnp.ndarray:
    """Fast-mode device BF build with counting semantics.

    Promotes a k-mer into the BF when the *minimum CBF slot count* over its
    hash tuple reaches `threshold`, with counts accumulated by scatter-add
    (not conservative update).  This upper-bounds the reference's
    conservative-update counts, so it is a slight superset filter; the
    bit-exact path is the host/native fill (ops/bloom.py fill_bfs).

    hashes: uint64[n, hash_num] of *all occurrences* (multiset).
    """
    flat = hashes.reshape(-1)
    cidx = (flat % jnp.uint64(cbf_size)).astype(jnp.int32)
    if mask is not None:
        mflat = jnp.repeat(mask.reshape(-1), hash_num)
        cidx = jnp.where(mflat, cidx, cbf_size)  # OOB sentinel (see build_words)
    counters = jnp.zeros(cbf_size, dtype=jnp.int32).at[cidx].add(1, mode="drop")
    counts = counters[cidx.reshape(-1, hash_num)].min(axis=-1)
    promote = counts >= threshold
    if mask is not None:
        promote = promote & mask.reshape(-1)
    return build_words(bits_bf, hashes.reshape(-1, hash_num), mask=promote)

# Jitted entry points (always use these from host code; eager u64 dispatch
# is pathologically slow).
def probe_kmers_packed(words, bits: int, hash_num: int, k: int, codes):
    """probe_kmers with the boolean output bit-packed into uint8 (1/8 the
    host<->device transfer; unpack with np.unpackbits(..., bitorder='little')).
    The window count is padded up to a multiple of 8."""
    pres = probe_kmers(words, bits, hash_num, k, codes)
    n = pres.shape[-1]
    pad = (-n) % 8
    if pad:
        pres = jnp.pad(pres, [(0, 0)] * (pres.ndim - 1) + [(0, pad)])
    b = pres.reshape(pres.shape[:-1] + (-1, 8)).astype(jnp.uint8)
    weights = (jnp.uint8(1) << jnp.arange(8, dtype=jnp.uint8))
    return (b * weights).sum(axis=-1, dtype=jnp.uint8)


probe_kmers_jit = jax.jit(probe_kmers, static_argnums=(1, 2, 3))
probe_kmers_packed_jit = jax.jit(probe_kmers_packed, static_argnums=(1, 2, 3))
probe_words_jit = jax.jit(probe_words, static_argnums=1)
build_words_jit = jax.jit(build_words, static_argnums=0)
