"""Fused dense-scan device program: all-window ntHash + gather Bloom probe.

The device formulation of the editor's detection scan (the probe of every
draft k-mer window, reference: subprojects/ntedit/ntedit.cpp:1414-1486, one
rolling probe per position).  The whole program — decode, hash, extra
hashes, probe, bit-pack — compiles to ONE device computation, so a scan
chunk costs one dispatch; presence bits come back packed 8 per byte.

Hash.  ntHash's window hash is an XOR of per-position rotated seeds,

    fh(w) = XOR_{j=0..k-1} srol^{k-1-j}( seed(s[w+j]) )
    rh(w) = XOR_{j=0..k-1} srol^{j}( rcseed(s[w+j]) )

(see ops/nthash.py for the derivation from the reference recurrences,
reference: subprojects/ntedit/lib/nthash.hpp:100-131).  Two device
formulations compute it bit-exactly:

  * the prefix-XOR ladder (ops/nthash_jax.py): seed lookup, per-position
    rotation, a log-depth XOR scan — the SCAN PATH uses it (scan, fused
    phase A), measured faster than the conv on the GPU (PERF.md);
  * the conv hash below: each output BIT of fh/rh is the parity of a
    {0,1}-count, i.e. a conv1d between a one-hot encoding of the sequence
    and a constant kernel of seed bits ([k, 12, 128]: 4 forward base
    classes + 8 reverse-complement classes (c&7) in, 64 fh || 64 rh bits
    out).  Counts are <= k <= 64, exact with bf16 operands and a float32
    accumulator, and the bits recombine by integer shift-or.  The sorted
    device fill (ops/bloom_sort) hashes with it, sharing one one-hot
    encoding across all k.

Probe.  The per-batch filter (a few MiB, autoscaled by the BF builder) is a
u32 word array on the device; each window's h derived hashes index it
directly and XLA lowers the lookup to a gather.

Exactness: both hashes are bit-exact for the FULL byte alphabet
(lowercase, IUPAC, N, arbitrary bytes): the ladder indexes the 256-entry
seed tables by raw byte, and the conv's 12 channels carry exactly what
those tables read (forward seed nonzero only for [ACGTacgt]; rc seed
seedTab[c & 7]).  Pinned against the scalar oracle in
tests/test_scan_conv.py and tests/test_nthash_jax.py.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from . import bloom_jax
from . import nthash as nt
from . import nthash_jax as ntj


@functools.lru_cache(maxsize=8)
def _conv_weights(k: int) -> np.ndarray:
    """Constant conv kernel [k, 12, 128] of rotated-seed bits (float32).

    Channels 0..3: forward classes A,C,G,T (case-folded); channels 4..11:
    reverse-complement classes c & 7.  Output lanes 0..63 = fh bits,
    64..127 = rh bits.
    """
    w = np.zeros((k, 12, 128), np.float32)
    fwd = [nt.SEED_A, nt.SEED_C, nt.SEED_G, nt.SEED_T]
    bit = np.arange(64, dtype=np.uint64)
    for j in range(k):
        for c in range(4):
            v = np.uint64(nt.srol_n(np.uint64(fwd[c]), k - 1 - j))
            w[j, c, :64] = ((v >> bit) & np.uint64(1)).astype(np.float32)
        for cc in range(8):
            v = np.uint64(nt.srol_n(nt.SEED_TAB[cc], j))
            w[j, 4 + cc, 64:] = ((v >> bit) & np.uint64(1)).astype(np.float32)
    return w


def _onehot12(codes: jnp.ndarray) -> jnp.ndarray:
    """uint8 codes [..., L] -> one-hot [..., L, 12] bf16 (see _conv_weights):
    forward class (0..3 ACGT case-folded, 4 other) + rc class (c & 7)."""
    lo = codes | jnp.uint8(32)  # case fold; non-letters stay non-acgt
    clsf = jnp.full(codes.shape, 4, jnp.int32)
    for i, ch in enumerate(b"acgt"):
        clsf = jnp.where(lo == ch, i, clsf)
    clsr = (codes & jnp.uint8(7)).astype(jnp.int32)
    oh_f = (clsf[..., None] == jnp.arange(4, dtype=jnp.int32)).astype(jnp.bfloat16)
    oh_r = (clsr[..., None] == jnp.arange(8, dtype=jnp.int32)).astype(jnp.bfloat16)
    return jnp.concatenate([oh_f, oh_r], axis=-1)


def _bits_to_u64(bits: jnp.ndarray) -> jnp.ndarray:
    """[..., 64] {0,1} int32 -> uint64 by integer shift-or.

    Each 32-bit half is a sum of distinct powers of two (equal to the OR),
    so no float arithmetic — and no TF32 rounding — can touch the result."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    b = bits.astype(jnp.uint32)
    lo = (b[..., :32] << shifts).sum(axis=-1, dtype=jnp.uint32)
    hi = (b[..., 32:] << shifts).sum(axis=-1, dtype=jnp.uint32)
    return lo.astype(jnp.uint64) | (hi.astype(jnp.uint64) << jnp.uint64(32))


def _strand_hashes_from_onehot(x: jnp.ndarray, k: int):
    w = jnp.asarray(_conv_weights(k), jnp.bfloat16)
    out = jax.lax.conv_general_dilated(
        x, w, window_strides=(1,), padding="VALID",
        dimension_numbers=("NWC", "WIO", "NWC"),
        preferred_element_type=jnp.float32,
    )  # [B, nw, 128] exact integer counts <= k
    bits = out.astype(jnp.int32) & 1
    return _bits_to_u64(bits[..., :64]), _bits_to_u64(bits[..., 64:])


def strand_hashes_conv(codes: jnp.ndarray, k: int):
    """(fh, rh) u64 arrays of every k-window via the conv hash; codes [B, L]."""
    return _strand_hashes_from_onehot(_onehot12(codes), k)


def canonical_hashes_conv(codes: jnp.ndarray, k: int) -> jnp.ndarray:
    """Canonical (fh + rh, wrapping u64) hash of every window; codes [B, L]."""
    fh, rh = strand_hashes_conv(codes, k)
    return fh + rh


def _pack_bits(pres: jnp.ndarray) -> jnp.ndarray:
    """bool [..., n] -> uint8 [..., ceil(n/8)] little-endian bit packing."""
    n = pres.shape[-1]
    pad = (-n) % 8
    if pad:
        pres = jnp.pad(pres, [(0, 0)] * (pres.ndim - 1) + [(0, pad)])
    b = pres.reshape(*pres.shape[:-1], -1, 8).astype(jnp.uint8)
    weights = jnp.uint8(1) << jnp.arange(8, dtype=jnp.uint8)
    return (b * weights).sum(axis=-1, dtype=jnp.uint8)


def _codes_from_packed(packed: jnp.ndarray, L: int, exc_idx, exc_byte):
    """2-bit packed [B, ceil(L/4)] (+ sparse exceptions) -> raw codes
    u8 [B, L].  Exception entries carry the RAW byte of every non-ACGT
    position; padding entries use idx >= L and are dropped by the
    scatter."""
    b_dim = packed.shape[0]
    shifts = jnp.arange(4, dtype=jnp.uint8) * 2
    cls = ((packed[..., None] >> shifts) & jnp.uint8(3)).reshape(b_dim, -1)
    cls = cls[:, :L]
    # selects, NOT a table gather: an 8M-element gather costs more than
    # the transfer the packing saves
    codes = jnp.where(cls == 0, jnp.uint8(65), jnp.where(
        cls == 1, jnp.uint8(67), jnp.where(cls == 2, jnp.uint8(71),
                                           jnp.uint8(84))))
    if exc_idx is not None and exc_idx.shape[-1]:
        rows = jnp.broadcast_to(
            jnp.arange(b_dim, dtype=jnp.int32)[:, None], exc_idx.shape
        ).reshape(-1)
        flat_idx = rows * L + jnp.minimum(
            exc_idx.astype(jnp.int32), L
        ).reshape(-1)
        flat_idx = jnp.where((exc_idx >= L).reshape(-1), b_dim * L, flat_idx)
        codes = codes.reshape(-1).at[flat_idx].set(
            exc_byte.reshape(-1), mode="drop"
        ).reshape(b_dim, L)
    return codes


def _present_packed(words, bits: int, h: int, k: int, base):
    """Gather-probe the h derived hashes of every window -> packed bits."""
    return _pack_bits(bloom_jax.probe_words(
        words, bits, ntj.multi_hashes(base, k, h)))


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def scan_present_packed_gather(words, bits: int, h: int, k: int, codes):
    """Fused scan, gather probe (any filter size): codes u8 [B, L] ->
    packed presence u8 [B, ceil((L-k+1)/8)]."""
    return _present_packed(words, bits, h, k, ntj.canonical_hashes(codes, k))


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def scan_present_packed2_gather(words, bits: int, h: int, k: int, L: int,
                                packed, exc_idx, exc_byte):
    """Fused scan over a 2-BIT PACKED transfer (1/4 the h2d bytes of the
    raw path): packed u8 [B, ceil(L/4)] + sparse non-ACGT exceptions ->
    packed presence u8 [B, ceil((L-k+1)/8)].  Bit-exact with the raw scan
    for the full byte alphabet (the exceptions carry the raw bytes)."""
    codes = _codes_from_packed(packed, L, exc_idx, exc_byte)
    return _present_packed(words, bits, h, k, ntj.canonical_hashes(codes, k))


class DeviceScanner:
    """Holds a Bloom filter's device residency and runs fused scans.

    Uploads the filter's words once; every `scan_packed` call is one async
    device computation whose result the caller unpacks with
    `unpack_present`.

    Multi-device: with >1 visible device the scan SPMD-shards its rows over
    a 1-D ("dp",) jax Mesh with the filter replicated.  Because the scan
    pipeline (polish/scanpipe.py) packs CONTIG SEGMENTS into rows with a
    k-1-byte halo at every boundary, row sharding subsumes both contig data
    parallelism and sequence parallelism of long contigs — the halo
    exchange sequence-parallel scans normally need is already materialized
    in the packing, so devices need no collectives on the critical path
    (stats/outputs gather once per call).
    """

    def __init__(self, bf):
        self.bits = int(bf.bits)
        self.h = int(bf.hash_num)
        self._mesh = None
        self._sharded_cache: dict = {}
        self.n_devices = len(jax.devices())
        words = bf.words_u32()
        if self.n_devices > 1:
            # dp row sharding: the filter is replicated — it is <= a few MiB
            # next to device memory — and scan rows split over the mesh (the
            # packing already carries the k-1 halos, so shards need no
            # collectives)
            from jax.sharding import Mesh, NamedSharding, PartitionSpec

            self._mesh = Mesh(np.array(jax.devices()), ("dp",))
            self._row_sharding = NamedSharding(
                self._mesh, PartitionSpec("dp", None)
            )
            repl = NamedSharding(self._mesh, PartitionSpec())
            self._words = jax.device_put(words, repl)
        else:
            self._words = jnp.asarray(words)

    def _sharded_scan(self, kind: str, k: int, L: int = 0):
        """shard_map-wrapped scan for the dp mesh; cached per (kind, k, L):
        each device runs the full fused program on its row shard against
        the replicated filter."""
        key = (kind, k, L)
        fn = self._sharded_cache.get(key)
        if fn is not None:
            return fn
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        bits, h = self.bits, self.h
        row = P("dp", None)
        if kind == "scan":
            def body(filt, codes):
                return scan_present_packed_gather(filt, bits, h, k, codes)

            in_specs = (P(), row)
        else:
            def body(filt, packed, exc_idx, exc_byte):
                return scan_present_packed2_gather(
                    filt, bits, h, k, L, packed, exc_idx, exc_byte
                )

            in_specs = (P(), row, row, row)
        fn = jax.jit(shard_map(
            body, mesh=self._mesh, in_specs=in_specs, out_specs=row,
            check_vma=False,
        ))
        self._sharded_cache[key] = fn
        return fn

    # -- fused phase-A (scan + hot-site detect + candidate eval) ------------
    def enable_eval(self, eval_cfg, site_tables) -> None:
        """Arm the fused scan+eval program (ops/scan_eval).

        On a dp mesh the program shard_maps over scan rows exactly like the
        plain scan (filter replicated): each device detects heads and
        evaluates sites on its own row shard, and the outputs stack on a
        leading shard axis that scan_eval_shards tells the consumer to
        merge (per-shard site indices are shard-row-local)."""
        from . import scan_eval

        self._eval = scan_eval.FusedEval(eval_cfg, self.bits, site_tables)
        self._eval_s_max = eval_cfg.s_max
        self._eval_sharded = None
        if self._mesh is not None:
            from jax import shard_map
            from jax.sharding import PartitionSpec as P

            row = P("dp", None)
            raw = self._eval.raw

            def body(filt, codes):
                (packed, n_sites, site, gate, sub, dele, lane, ok,
                 ins) = raw(filt, codes)
                # leading shard axis on the site-ish outputs (site indices
                # stay SHARD-ROW-LOCAL; the consumer adds the row offset)
                return (packed, n_sites[None], site[None], gate[None],
                        sub[None], dele[None], lane[None], ok[None],
                        ins[None])

            sh = lambda *rest: P("dp", *rest)  # noqa: E731
            self._eval_sharded = jax.jit(shard_map(
                body, mesh=self._mesh,
                in_specs=(P(), row),
                out_specs=(row, sh(), sh(None), sh(None, None),
                           sh(None, None), sh(None, None), sh(None),
                           sh(None), sh(None, None)),
                check_vma=False,
            ))

    @property
    def eval_enabled(self) -> bool:
        return getattr(self, "_eval", None) is not None

    @property
    def eval_shards(self) -> int:
        """Shard count of scan_eval_packed outputs (1 = unsharded).  When
        >1, the site-ish outputs stack per shard: site u32[n*S] with
        SHARD-ROW-LOCAL indices, n_sites i32[n], and the consumer maps
        shard s, local row r to global row s*rows_per_shard + r."""
        if getattr(self, "_eval_sharded", None) is not None:
            return self.n_devices
        return 1

    def scan_eval_packed(self, codes: np.ndarray, k: int):
        """Fused scan+eval call: codes u8 [R, L] -> 9-tuple of device arrays
        (see scan_eval.build_fused).  Async like scan_packed.  On a mesh
        the rows shard over dp (padded to a multiple of the device count;
        see eval_shards for the output layout)."""
        if getattr(self, "_eval_sharded", None) is not None:
            codes = np.asarray(codes)
            if codes.ndim == 1:
                codes = codes[None, :]
            b = codes.shape[0]
            pad = (-b) % self.n_devices
            if pad:
                # pad rows with 'A': pad windows probe like real sequence
                # and any heads they produce fall outside every segment
                codes = np.pad(codes, ((0, pad), (0, 0)),
                               constant_values=ord("A"))
            codes = jax.device_put(codes, self._row_sharding)
            type(self._eval).calls += 1
            return self._eval_sharded(self._words, codes)
        return self._eval(self._words, jnp.asarray(codes))

    @property
    def preferred_rows(self) -> int:
        """Scan-call row count the pipeline should use (>=1 per device)."""
        return max(4, self.n_devices) if self._mesh is not None else 4

    def scan_packed(self, codes: np.ndarray, k: int):
        """codes u8 [B, L] (host or device) -> device u8 [B, ceil(nw/8)].

        Returns the un-fetched device array (async); np.asarray() it to
        materialize.
        """
        if self._mesh is not None:
            codes = np.asarray(codes)
            if codes.ndim == 1:
                codes = codes[None, :]
            b = codes.shape[0]
            pad = (-b) % self.n_devices
            if pad:
                codes = np.pad(codes, ((0, pad), (0, 0)))
            codes = jax.device_put(codes, self._row_sharding)
            out = self._sharded_scan("scan", k)(self._words, codes)
            return out[:b]
        codes = jnp.asarray(codes)
        if codes.ndim == 1:
            codes = codes[None, :]
        return scan_present_packed_gather(
            self._words, self.bits, self.h, k, codes
        )

    def scan_packed2(self, packed: np.ndarray, exc_idx: np.ndarray,
                     exc_byte: np.ndarray, k: int, L: int):
        """2-bit-packed-transfer variant of scan_packed: packed u8
        [B, ceil(L4/4)] + per-row exception arrays (idx >= L entries are
        padding).  1/4 the h2d bytes of the raw path."""
        if self._mesh is not None:
            b = packed.shape[0]
            pad = (-b) % self.n_devices
            if pad:
                packed = np.pad(packed, ((0, pad), (0, 0)))
                exc_idx = np.pad(
                    exc_idx, ((0, pad), (0, 0)), constant_values=L
                )
                exc_byte = np.pad(exc_byte, ((0, pad), (0, 0)))
            args = (
                jax.device_put(packed, self._row_sharding),
                jax.device_put(exc_idx, self._row_sharding),
                jax.device_put(exc_byte, self._row_sharding),
            )
            out = self._sharded_scan("scan2", k, L)(self._words, *args)
            return out[:b]
        args = (jnp.asarray(packed), jnp.asarray(exc_idx), jnp.asarray(exc_byte))
        return scan_present_packed2_gather(
            self._words, self.bits, self.h, k, L, *args
        )

    @staticmethod
    def unpack_present(packed: np.ndarray, nw: int) -> np.ndarray:
        """Packed u8 row -> bool[nw]."""
        return np.unpackbits(packed, bitorder="little")[:nw].astype(bool)
