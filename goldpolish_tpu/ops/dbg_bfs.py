"""Device-resident de Bruijn BFS for the gap filler (SURVEY §7.5's
"batched frontier kernel").

The sealer's Konnector search (fill/konnector._BidiSearch; reference
Graph/BidirectionalBFS.h:80-156 + Konnector/DBGBloom.h:107-150) interleaves
two frontiers vertex-by-vertex with order-dependent abort bookkeeping
(cost/branch/path caps) — inherently sequential.  What IS parallel is the
graph itself: which k-mers exist (Bloom membership) and each vertex's 4-way
extension mask are pure functions.  So the device kernel computes, for a
BATCH of gaps in ONE dispatch (a `lax.while_loop` over BFS levels — no
per-level host round trips, which the lockstep DeviceDBG pays once per
level):

    for every vertex reachable from each gap's start (forward) and goal
    (reverse) within its depth budget: the vertex's 4-bit extension mask,

and the host then REPLAYS `_BidiSearch` exactly — same vertex-alternating
order, same cost counters, same aborts — against a mask dictionary instead
of Bloom probes.  Replay outcomes are byte-identical by construction
(membership is pure); any gap that overflows the kernel's fixed frontier/
visited capacities is flagged and searched natively on the host instead.

k-mers are 2-bit packed uint64 (k <= 32 — the pipeline's k set; the
reference's packed Kmer plays the same role, sealer/Common/Kmer.h:58-144).
Hashes roll from parent to child in O(1) (ntc64 roll / changefirst), so the
kernel performs exactly 4*h Bloom-bit gathers per expanded vertex.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from . import nthash as nt
from . import nthash_jax as ntj

# base codes 0..3 = A, C, G, T; codec shared with the host packed search
# (ops/kmers — the reference Common/Kmer.h role)
from .kmers import BASES, pack_kmer, unpack_kmer  # noqa: F401 (re-export)

_FSEED4 = np.array([nt.SEED_TAB[b] for b in BASES], np.uint64)
_RSEED4 = np.array([nt.RC_SEED_TAB[b] for b in BASES], np.uint64)


def _srol_const(v, n: int):
    n31, n33 = n % 31, n % 33
    hi = v >> jnp.uint64(33)
    lo = v & jnp.uint64(nt.MASK33)
    if n31:
        hi = ((hi << jnp.uint64(n31)) | (hi >> jnp.uint64(31 - n31))) \
            & jnp.uint64(nt.MASK31)
    if n33:
        lo = ((lo << jnp.uint64(n33)) | (lo >> jnp.uint64(33 - n33))) \
            & jnp.uint64(nt.MASK33)
    return (hi << jnp.uint64(33)) | lo


def _sror1(v):
    hi = v >> jnp.uint64(33)
    lo = v & jnp.uint64(nt.MASK33)
    hi = ((hi >> jnp.uint64(1)) | (hi << jnp.uint64(30))) & jnp.uint64(nt.MASK31)
    lo = ((lo >> jnp.uint64(1)) | (lo << jnp.uint64(32))) & jnp.uint64(nt.MASK33)
    return (hi << jnp.uint64(33)) | lo


def _probe(words, bits: int, base, k: int, h: int):
    def bit(idx):
        word = words[(idx >> jnp.uint32(5)).astype(jnp.int32)]
        return (word >> (idx & jnp.uint32(31))) & jnp.uint32(1) != 0

    def idx_of(hashes):
        if bits & (bits - 1) == 0:
            return (hashes & jnp.uint64(bits - 1)).astype(jnp.uint32)
        return (hashes % jnp.uint64(bits)).astype(jnp.uint32)

    pres = bit(idx_of(base))
    for i in range(1, h):
        pres &= bit(idx_of(ntj.nte64(base, k, i)))
    return pres


@functools.lru_cache(maxsize=16)
def _build_kernel(k: int, h: int, bits: int, W: int, V: int, G: int,
                  shadow_log: int = 18):
    """Jitted batched bidirectional-reachability kernel.

    Shapes: G gaps, frontier cap W, visited cap V (per direction).
    Inputs: words u32[], start/goal kmers u64[G], start/goal (fh, rh)
    u64[G] each, max_depth i32[G, 2].
    Outputs: vis u64[G, 2, V] (sorted, padded 0xFF..), mask u8[G, 2, V],
    n_vis i32[G, 2], overflow bool[G].
    """
    kmask = jnp.uint64((1 << (2 * k)) - 1) if k < 32 else jnp.uint64(2**64 - 1)
    top_shift = jnp.uint64(2 * (k - 1))
    fseed = jnp.asarray(_FSEED4)
    rseed = jnp.asarray(_RSEED4)
    PAD = jnp.uint64(2**64 - 1)

    def roll_fwd(kmers, fh, rh):
        """4 successors (u[1:] + b) of each kmer; returns child kmers,
        fh, rh with a trailing base axis of 4."""
        c_out = ((kmers >> top_shift) & jnp.uint64(3)).astype(jnp.int32)
        ck = ((kmers << jnp.uint64(2)) & kmask)[..., None] \
            | jnp.arange(4, dtype=jnp.uint64)[None, :]
        f_out = fseed[c_out][..., None]
        r_out = rseed[c_out][..., None]
        f_in = fseed[jnp.arange(4)][None, :]
        r_in = rseed[jnp.arange(4)][None, :]
        cfh = _srol_const(fh[..., None], 1) ^ f_in \
            ^ _srol_const(f_out, k % nt.SROL_PERIOD)
        crh = _sror1(rh[..., None] ^ _srol_const(r_in, k % nt.SROL_PERIOD)
                     ^ r_out)
        return ck, cfh, crh

    def roll_rev(kmers, fh, rh):
        """4 predecessors (b + u[:-1]): the roll inverse."""
        c_in = (kmers & jnp.uint64(3)).astype(jnp.int32)  # last base of u
        ck = (kmers >> jnp.uint64(2))[..., None] \
            | (jnp.arange(4, dtype=jnp.uint64) << top_shift)[None, :]
        f_in = fseed[c_in][..., None]
        r_in = rseed[c_in][..., None]
        f_out = fseed[jnp.arange(4)][None, :]  # c_out = new first base b
        r_out = rseed[jnp.arange(4)][None, :]
        cfh = _sror1(fh[..., None] ^ f_in
                     ^ _srol_const(f_out, k % nt.SROL_PERIOD))
        crh = _srol_const(rh[..., None], 1) \
            ^ _srol_const(r_in, k % nt.SROL_PERIOD) ^ r_out
        return ck, cfh, crh

    # visited-set membership: a per-(gap, direction) shadow bit-set tested
    # with 3 derived hash bits.  A false positive silently drops a vertex
    # from the output dictionary; the host replay then MISSES that mask and
    # re-runs the gap natively (MaskDBG.missed) — a perf blip, never a
    # wrong answer.  The per-test FP rate is (1 - exp(-3n / 2^SHADOW_LOG))^3
    # for n inserts (see DeviceBFS for the default's numbers).  This
    # replaces a per-level sorted-array merge (u64 sorts of V+4W per level).
    SHADOW_LOG = shadow_log
    S_BYTES = 1 << SHADOW_LOG  # one u8 per slot: max-scatter IS the OR,
    # and (unlike a bit-packed read-modify-write scatter) stays correct
    # under duplicate slot indices within one call

    def shadow_slots(x):
        m = x * jnp.uint64(0x9E3779B97F4A7C15)
        m = m ^ (m >> jnp.uint64(29))
        m = m * jnp.uint64(0xBF58476D1CE4E5B9)
        m = m ^ (m >> jnp.uint64(32))
        smask = jnp.uint64(S_BYTES - 1)
        return [
            ((m >> jnp.uint64(s)) & smask).astype(jnp.int32)
            for s in (0, 18, 36)
        ]

    def shadow_member(shadow_d, x):
        """shadow_d [G, S_BYTES] u8; x [G, M] u64 -> [G, M] bool."""
        gi = jnp.arange(G)[:, None]
        out = None
        for slot in shadow_slots(x):
            b = shadow_d[gi, slot] != 0
            out = b if out is None else out & b
        return out

    def shadow_insert(shadow_d, x, valid):
        gi = jnp.arange(G)[:, None]
        for slot in shadow_slots(x):
            shadow_d = shadow_d.at[
                gi, jnp.where(valid, slot, S_BYTES)
            ].max(jnp.uint8(1), mode="drop")
        return shadow_d

    def expand(words, dirn: int, level, st):
        """One level of one direction for every gap (dirn is static)."""
        (vis_k, vis_m, n_vis, shadow, fk, ff, fr, nf, max_d, over) = st
        active = (level <= max_d[:, dirn]) & (nf > 0) & ~over  # [G]
        slot_valid = jnp.arange(W)[None, :] < nf[:, None]  # [G, W]
        ck, cfh, crh = (
            roll_fwd(fk, ff, fr) if dirn == 0 else roll_rev(fk, ff, fr)
        )  # [G, W, 4]
        pres = _probe(words, bits, cfh + crh, k, h)  # [G, W, 4]
        pres = pres & slot_valid[..., None] & active[:, None, None]
        mask4 = (
            pres[..., 0].astype(jnp.uint8)
            | (pres[..., 1].astype(jnp.uint8) << 1)
            | (pres[..., 2].astype(jnp.uint8) << 2)
            | (pres[..., 3].astype(jnp.uint8) << 3)
        )  # [G, W]
        # append (kmer, mask) of the expanded frontier to the output log
        gi = jnp.arange(G)[:, None]
        rec = slot_valid & active[:, None]
        dst_log = jnp.where(rec, n_vis[:, dirn : dirn + 1]
                            + jnp.arange(W)[None, :], V)
        vis_k = vis_k.at[:, dirn].set(
            vis_k[:, dirn].at[gi, dst_log].set(fk, mode="drop")
        )
        vis_m = vis_m.at[:, dirn].set(
            vis_m[:, dirn].at[gi, dst_log].set(mask4, mode="drop")
        )
        n_vis = n_vis.at[:, dirn].add(jnp.where(active, nf, 0))
        over = over | (n_vis[:, dirn] > V)
        # children survive only below the depth cap
        grow = active & (level < max_d[:, dirn])
        keep = pres & grow[:, None, None]
        ckf = jnp.where(keep, ck, PAD).reshape(G, W * 4)
        cff = cfh.reshape(G, W * 4)
        crf = crh.reshape(G, W * 4)
        # sort children by kmer (hashes ride along), dedup within the level
        order = jnp.argsort(ckf, axis=1)
        ckf = jnp.take_along_axis(ckf, order, axis=1)
        cff = jnp.take_along_axis(cff, order, axis=1)
        crf = jnp.take_along_axis(crf, order, axis=1)
        first = jnp.concatenate(
            [jnp.ones((G, 1), bool), ckf[:, 1:] != ckf[:, :-1]], axis=1
        )
        seen = shadow_member(shadow[:, dirn], ckf)
        new = first & ~seen & (ckf != PAD)
        n_new = new.sum(axis=1)
        # compact the new children to the front as the next frontier
        rank = jnp.cumsum(new.astype(jnp.int32), axis=1) - 1
        dst = jnp.where(new, rank, W * 4)  # >= W drops below
        nfk = jnp.full((G, W), PAD).at[gi, dst].set(ckf, mode="drop")
        nff = jnp.zeros((G, W), jnp.uint64).at[gi, dst].set(cff, mode="drop")
        nfr = jnp.zeros((G, W), jnp.uint64).at[gi, dst].set(crf, mode="drop")
        over = over | (n_new > W)
        shadow = shadow.at[:, dirn].set(
            shadow_insert(shadow[:, dirn], ckf, new)
        )
        nf_new = jnp.where(grow, jnp.minimum(n_new, W), 0)
        return (vis_k, vis_m, n_vis, shadow, nfk, nff, nfr,
                nf_new.astype(jnp.int32), max_d, over)

    @jax.jit
    def run(words, start_k, goal_k, sfh, srh, gfh, grh, max_d):
        vis_k = jnp.full((G, 2, V), PAD)
        vis_m = jnp.zeros((G, 2, V), jnp.uint8)
        n_vis = jnp.zeros((G, 2), jnp.int32)
        shadow = jnp.zeros((G, 2, S_BYTES), jnp.uint8)
        shadow = shadow.at[:, 0].set(
            shadow_insert(shadow[:, 0], start_k[:, None],
                          jnp.ones((G, 1), bool))
        )
        shadow = shadow.at[:, 1].set(
            shadow_insert(shadow[:, 1], goal_k[:, None],
                          jnp.ones((G, 1), bool))
        )
        fkF = jnp.full((G, W), PAD).at[:, 0].set(start_k)
        ffF = jnp.zeros((G, W), jnp.uint64).at[:, 0].set(sfh)
        frF = jnp.zeros((G, W), jnp.uint64).at[:, 0].set(srh)
        fkR = jnp.full((G, W), PAD).at[:, 0].set(goal_k)
        ffR = jnp.zeros((G, W), jnp.uint64).at[:, 0].set(gfh)
        frR = jnp.zeros((G, W), jnp.uint64).at[:, 0].set(grh)
        nfF = jnp.ones(G, jnp.int32)
        nfR = jnp.ones(G, jnp.int32)
        over = jnp.zeros(G, bool)

        def cond(c):
            (level, _vk, _vm, _nv, _sh, fF, fR, over) = c
            (_fk, _ff, _fr, nfF) = fF
            (_fk2, _ff2, _fr2, nfR) = fR
            alive = ((nfF > 0) & (level <= max_d[:, 0])) | (
                (nfR > 0) & (level <= max_d[:, 1])
            )
            return (alive & ~over).any()

        def body(c):
            (level, vis_k, vis_m, n_vis, shadow, fF, fR, over) = c
            (fkF, ffF, frF, nfF) = fF
            (fkR, ffR, frR, nfR) = fR
            st = (vis_k, vis_m, n_vis, shadow, fkF, ffF, frF, nfF, max_d,
                  over)
            st = expand(words, 0, level, st)
            (vis_k, vis_m, n_vis, shadow, fkF, ffF, frF, nfF, _md, over) = st
            st = (vis_k, vis_m, n_vis, shadow, fkR, ffR, frR, nfR, max_d,
                  over)
            st = expand(words, 1, level, st)
            (vis_k, vis_m, n_vis, shadow, fkR, ffR, frR, nfR, _md, over) = st
            return (level + 1, vis_k, vis_m, n_vis, shadow,
                    (fkF, ffF, frF, nfF), (fkR, ffR, frR, nfR), over)

        init = (jnp.int32(0), vis_k, vis_m, n_vis, shadow,
                (fkF, ffF, frF, nfF), (fkR, ffR, frR, nfR), over)
        (_lvl, vis_k, vis_m, n_vis, _sh, _fF, _fR, over) = jax.lax.while_loop(
            cond, body, init
        )
        return vis_k, vis_m, n_vis, over

    return run


class DeviceBFS:
    """Batched whole-search mask precomputation for Konnector gaps.

    One __call__ = one device dispatch covering every level of every gap in
    the batch.  Returns per-gap {kmer: mask4} dicts for both directions
    (None where the kernel overflowed — search those natively).
    `dispatches` counts kernel calls across all instances."""

    dispatches = 0

    def __init__(self, bf, k: int, w_cap: int = 32, v_cap: int = 2048,
                 batch: int = 128, w_cap2: int = 256,
                 shadow_log: int | None = None):
        import os as _os

        if k > 32:
            raise ValueError("DeviceBFS packs k-mers into u64 (k <= 32)")
        # shadow visited-set size per (gap, direction).  The while-loop
        # state scales with G * 2^shadow_log bytes, which is why the default
        # is small; the false-positive rate, whose only cost is a host
        # re-run on a mask miss, is (1 - exp(-3n/2^15))^3 per test for n
        # inserts: ~5e-3 at n = V = 2048, and up to ~1e-2 when a last level
        # overshoots V by its 4*W children before the overflow check — not
        # the ~2e-4 an earlier estimate gave.  This default, w_cap, v_cap
        # and the batch G were not tuned on the GPU (ROADMAP.md lists them
        # for a perf PR).
        self.shadow_log = (
            int(_os.environ.get("GPTPU_BFS_SHADOW_LOG", 15))
            if shadow_log is None else shadow_log
        )
        self.bf = bf
        self.k = k
        self.h = int(bf.hash_num)
        self.bits = int(bf.bits)
        self.W = w_cap
        self.W2 = w_cap2  # wide-retry tier for frontier-cap overflows
        self.V = v_cap
        self.G = batch
        self._words = None

    def words(self):
        if self._words is None:
            self._words = jnp.asarray(self.bf.words_u32())
        return self._words

    def run(self, searches):
        """searches: list of (start_kmer str, goal_kmer str,
        max_depth_fwd int, max_depth_rev int).  Returns a list of
        (succ_masks dict | None, pred_masks dict | None).

        Two width tiers: most Konnector searches run 1-2 vertices wide
        (thin de Bruijn paths), so the first sweep uses a narrow frontier
        cap; gaps that overflow it retry once at W2 before falling back to
        the host search (None)."""
        out = self._run_tier(searches, self.W)
        retry = [i for i, r in enumerate(out) if r == (None, None)]
        if retry and self.W2 > self.W:
            redo = self._run_tier([searches[i] for i in retry], self.W2)
            for i, r in zip(retry, redo):
                out[i] = r
        return out

    def _run_tier(self, searches, W: int):
        # the level loop's fixed per-iteration cost dominates thin searches,
        # so the batch should swallow as many gaps as memory allows: one
        # call for ALL gaps when possible (pow2 G keeps kernel-cache reuse
        # across sweeps)
        G = self.G
        while G < len(searches) and G < 512:
            G *= 2
        out = []
        run = _build_kernel(self.k, self.h, self.bits, W, self.V, G,
                            self.shadow_log)
        for lo in range(0, len(searches), G):
            chunk = searches[lo : lo + G]
            n = len(chunk)
            sk = np.zeros(G, np.uint64)
            gk = np.zeros(G, np.uint64)
            sfh = np.zeros(G, np.uint64)
            srh = np.zeros(G, np.uint64)
            gfh = np.zeros(G, np.uint64)
            grh = np.zeros(G, np.uint64)
            md = np.zeros((G, 2), np.int32)
            md[:, :] = -1  # inactive pad gaps never expand
            for i, (s, g, mf, mr) in enumerate(chunk):
                sk[i] = pack_kmer(s)
                gk[i] = pack_kmer(g)
                f, r = nt.ntc64_base_i(s.encode(), 0, self.k)
                sfh[i], srh[i] = f, r
                f, r = nt.ntc64_base_i(g.encode(), 0, self.k)
                gfh[i], grh[i] = f, r
                md[i, 0] = mf
                md[i, 1] = mr
            DeviceBFS.dispatches += 1
            vis, msk, n_vis, over = (np.asarray(x) for x in run(
                self.words(), jnp.asarray(sk), jnp.asarray(gk),
                jnp.asarray(sfh), jnp.asarray(srh), jnp.asarray(gfh),
                jnp.asarray(grh), jnp.asarray(md),
            ))
            for i in range(n):
                if over[i]:
                    out.append((None, None))
                    continue
                pair = []
                for d in range(2):
                    nv = int(n_vis[i, d])
                    # dicts key on PACKED ints — the host search's vertex
                    # type (fill/konnector.PackedDBG) — so the replay does
                    # zero string conversions
                    pair.append(dict(zip(
                        vis[i, d, :nv].tolist(), msk[i, d, :nv].tolist()
                    )))
                out.append((pair[0], pair[1]))
        return out
