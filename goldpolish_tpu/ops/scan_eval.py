"""Fused device phase-A: dense scan + hot-site detection + candidate eval.

One device dispatch per scan chunk computes everything the editor's host
walk needs from phase A (reference: the per-position probe loop AND the
per-site trial loop, subprojects/ntedit/ntedit.cpp:1414-1713):

  1. presence bits of every window (the dense scan, as ops/scan_conv),
  2. the detection masks (visited/eligible/check_missing -> hot) and the
     predicted *visited* hot sites (cluster heads),
  3. for up to S_max heads, the candidate-trial support tables the walk's
     decision loop consumes: substitution gates + supports, deletion
     supports, and the needing lane's insertion-combo supports.

The host walker then replays the reference decision loop from the tables
(zero Bloom probes at covered sites) and falls back to native probing at
any site the tables do not cover — prediction misses cost time, never
correctness.

Hash construction is XOR-delta, not patch re-hashing: ntHash is XOR-linear
in per-position seeds, so every candidate window hash derives from the
scan's (fh, rh) arrays (substitutions), from 5 short rolled chains per site
(deletions / per-length insertion references), or from a *precomputed
constant* delta table (all 341 insertion combos; combos of one length
differ from the reference combo only in their own static chars).  The
insertion scan is two-stage: an h1-only prescreen bounds each combo's
support from above (a window is present only if every hash bit is set, so
the h1-bit count is a sound upper bound); only combos whose bound passes
the accept threshold get full-h exact probes.  Decision-equivalent for the
same reason the native early-bails are (gp_native.cpp probes_ahead):
non-accepted counts are read only through the accept test.

Exactness is pinned against ops/siteeval.eval_sites_np (the host spec) in
tests/test_scan_eval.py.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

import jax
import jax.numpy as jnp

from . import nthash as nt
from . import nthash_jax as ntj
from .bloom_jax import bit_set, probe_index
from .siteeval import SiteTables

T_SURVIVORS = 48  # max full-h insertion combos per site (overflow -> host).
# At 25% filter-bit occupancy the h1 prescreen passes ~12-30 of 341 combos
# (measured; inter-combo correlation at real indel sites pushes the tail
# well past the independence estimate), so 16 overflowed ~38% of sites.


# --- constant tables (numpy, baked into the jitted program) -----------------
@functools.lru_cache(maxsize=8)
def _sub_delta_tables():
    """Changelast seed deltas for substitution candidates.

    D_F[draft, lane] = fseed[draft] ^ fseed[cand];
    D_R[draft, lane] = rcseed[draft] ^ rcseed[cand]  (pre-rotation).
    Draft chars index by raw byte (uppercased by the caller); lanes by the
    sub_cand table."""
    from .siteeval import make_tables

    t = make_tables(32)  # sub_cand is k-independent
    # the seed tables index c & 7 for EVERY byte (non-ACGT included)
    fwd = nt.SEED_TAB.copy()
    rc = nt.RC_SEED_TAB.copy()
    cand = t.sub_cand  # [256, 4]
    d_f = fwd[np.arange(256)][:, None] ^ fwd[cand]
    d_r = rc[np.arange(256)][:, None] ^ rc[cand]
    return d_f.astype(np.uint64), d_r.astype(np.uint64)


@functools.lru_cache(maxsize=8)
def _ins_delta_tables(k: int, jump: int, max_ins: int):
    """Constant insertion-combo deltas D_F/D_R [C, T] (see module doc).

    Probe point t sits after s = j_ins[t] rolls; the window then covers
    patch[s .. s+k-1] with combo char j (1 <= j < L) at patch pos k-1+j.
    fh contribution of pos q is srol^{s+k-1-q}, rh contribution srol^{q-s}:
      D_F[c, t] = XOR_{1<=j<L, j<=s} srol^{s-j}(fseed[cc_j] ^ fseed['A'])
      D_R[c, t] = XOR_{1<=j<L, j<=s} srol^{k-1+j-s}(rcseed[cc_j] ^ rcseed['A'])
    (combo chars past position 0 are shared across index-char rows)."""
    from .siteeval import make_tables

    t = make_tables(k, jump, max_ins, 5)
    C = t.n_combos
    s_pts = t.j_ins.astype(np.int64)  # roll counts at probe points
    T = len(s_pts)
    d_f = np.zeros((C, T), np.uint64)
    d_r = np.zeros((C, T), np.uint64)
    fa = np.uint64(nt.SEED_TAB[ord("A")])
    ra = np.uint64(nt.RC_SEED_TAB[ord("A")])
    codes = t.combo_codes[0]  # rows share chars past pos 0
    for c in range(C):
        L = int(t.combo_len[c])
        for ti, s in enumerate(s_pts):
            acc_f = np.uint64(0)
            acc_r = np.uint64(0)
            for j in range(1, L):
                if j > s:
                    continue
                ch = int(codes[c, j])
                fd = np.uint64(nt.SEED_TAB[ch]) ^ fa
                rd = np.uint64(nt.RC_SEED_TAB[ch]) ^ ra
                acc_f ^= nt.srol_n(fd, int(s - j) % nt.SROL_PERIOD)
                acc_r ^= nt.srol_n(rd, int(k - 1 + j - s) % nt.SROL_PERIOD)
            d_f[c, ti] = acc_f
            d_r[c, ti] = acc_r
    return d_f, d_r, t.combo_len.astype(np.int32).copy()


def _srol_const(v, n: int):
    """srol^n with a STATIC rotation count (compiles to plain shifts)."""
    n31 = n % 31
    n33 = n % 33
    hi = v >> jnp.uint64(33)
    lo = v & jnp.uint64(nt.MASK33)
    if n31:
        hi = ((hi << jnp.uint64(n31)) | (hi >> jnp.uint64(31 - n31))) & jnp.uint64(nt.MASK31)
    if n33:
        lo = ((lo << jnp.uint64(n33)) | (lo >> jnp.uint64(33 - n33))) & jnp.uint64(nt.MASK33)
    return (hi << jnp.uint64(33)) | lo


def _changelast(fh, rh, k: int, f_out, f_in, r_out, r_in):
    """ntc64_changelast on (possibly batched) u64 state; seed args are the
    per-element seed values (already gathered)."""
    fh2 = fh ^ f_out ^ f_in
    v = _srol_const(rh, 1) ^ _srol_const(r_out ^ r_in, k % nt.SROL_PERIOD)
    # split right-rotation by 1 (the native hash_changelast tail)
    hi = v >> jnp.uint64(33)
    lo = v & jnp.uint64(nt.MASK33)
    hi = ((hi >> jnp.uint64(1)) | (hi << jnp.uint64(30))) & jnp.uint64(nt.MASK31)
    lo = ((lo >> jnp.uint64(1)) | (lo << jnp.uint64(32))) & jnp.uint64(nt.MASK33)
    return fh2, (hi << jnp.uint64(33)) | lo


def _roll(fh, rh, k: int, f_out, f_in, r_out, r_in):
    """One ntHash roll with pre-gathered seed values."""
    fh2 = _srol_const(fh, 1) ^ f_in ^ _srol_const(f_out, k % nt.SROL_PERIOD)
    v = rh ^ _srol_const(r_in, k % nt.SROL_PERIOD) ^ r_out
    hi = v >> jnp.uint64(33)
    lo = v & jnp.uint64(nt.MASK33)
    hi = ((hi >> jnp.uint64(1)) | (hi << jnp.uint64(30))) & jnp.uint64(nt.MASK31)
    lo = ((lo >> jnp.uint64(1)) | (lo << jnp.uint64(32))) & jnp.uint64(nt.MASK33)
    return fh2, (hi << jnp.uint64(33)) | lo


def _probe_full(words, bits: int, base, k: int, h: int):
    """Full multi-hash probe of canonical base hashes (any shape)."""
    pres = bit_set(words, probe_index(base, bits))
    for i in range(1, h):
        pres &= bit_set(words, probe_index(ntj.nte64(base, k, i), bits))
    return pres


@dataclass
class EvalConfig:
    """Static decision parameters the fused program needs (from the editor
    Config — polish/ntedit_oracle.py:82)."""

    k: int
    h: int
    jump: int
    max_ins: int
    max_del: int
    thr_edit: float
    thr_missing: float
    s_max: int = 2048
    # insertion-stage site budget: the [s_ins, C, T] combo prescreen is the
    # program's dominant probe volume, and the walker only reads ins tables
    # at sites whose needing lane exists — most heads (accepted subs,
    # detection noise) never reach the indel branch.  0 -> max(64, s_max/4).
    # Needing sites beyond the budget get ins_ok=0 (host redo — cost,
    # never correctness).
    s_ins: int = 0

    def resolved_s_ins(self) -> int:
        return self.s_ins or max(64, self.s_max // 4)

    def key(self):
        return (self.k, self.h, self.jump, self.max_ins, self.max_del,
                float(np.float32(self.thr_edit)),
                float(np.float32(self.thr_missing)), self.s_max,
                self.resolved_s_ins())


def _accepted_mask(codes):
    """is_accepted(upper(c)) for raw byte codes (ATGC + IUPAC RYSWKMBDHV)."""
    up = jnp.where((codes >= 97) & (codes <= 122), codes - 32, codes)
    acc = jnp.zeros(codes.shape, bool)
    for ch in b"ATGCRYSWKMBDHV":
        acc = acc | (up == ch)
    return acc


@functools.lru_cache(maxsize=32)
def _fused_cached(key: tuple, bits: int, k: int, jump: int, max_ins: int,
                  max_del: int):
    """Program cache: per-batch engines construct fresh FusedEval objects,
    and an uncached build would re-trace (and re-look-up) the large fused
    graph once per (batch, k) — measured at seconds per program."""
    cfg = EvalConfig(
        k=k, h=key[1], jump=jump, max_ins=max_ins, max_del=max_del,
        thr_edit=key[5], thr_missing=key[6], s_max=key[7], s_ins=key[8],
    )
    from .siteeval import make_tables

    return build_fused(cfg, bits, make_tables(k, jump, max_ins, max_del))


@functools.lru_cache(maxsize=32)
def _fused_jitted(*args):
    """Jitted twin of _fused_cached (one jit wrapper per program — fresh
    wrappers re-trace, which is seconds for this graph)."""
    return jax.jit(_fused_cached(*args))


def build_fused(cfg: EvalConfig, bits: int, tables: SiteTables):
    """Returns the fused program: (words, codes[R, L]) -> outputs, where
    words is the filter's u32 word array (any filter size) and every Bloom
    test is an XLA gather into it.

    Outputs (fixed shapes; S = cfg.s_max, C = tables.n_combos):
      packed   u8 [R, ceil(nw/8)]   presence bits
      n_sites  i32                  heads found (may exceed S)
      site     i32 [S]              row-major global window index (pad -1)
      gate     u8 [S, 4]
      sub_sup  i8 [S, 4]
      del_sup  i8 [S, MD]
      ins_lane i8 [S]               lane whose ins table was computed (-1)
      ins_ok   u8 [S]               0 -> survivor overflow, host must eval
      ins_sup  i8 [S, C]            exact counts for sound survivors, else 0
    """
    k, h, jump = cfg.k, cfg.h, cfg.jump
    S, MD, MI = cfg.s_max, cfg.max_del, cfg.max_ins
    SI = cfg.resolved_s_ins()
    C = tables.n_combos
    thr_edit = np.float32(cfg.thr_edit)
    thr_missing = np.float32(cfg.thr_missing)
    d_f_sub, d_r_sub = _sub_delta_tables()
    d_f_ins, d_r_ins, combo_len = _ins_delta_tables(k, jump, MI)
    j_sub = [int(x) for x in tables.j_sub]
    j_ins = [int(x) for x in tables.j_ins]
    j_del = [int(x) for x in tables.j_del]
    sub_cand_t = jnp.asarray(tables.sub_cand)  # [256, 4]
    d_f_sub_t = jnp.asarray(d_f_sub)
    d_r_sub_t = jnp.asarray(d_r_sub)
    d_f_ins_t = jnp.asarray(d_f_ins)  # [C, T]
    d_r_ins_t = jnp.asarray(d_r_ins)
    combo_len_t = jnp.asarray(combo_len)  # [C]
    fseed_t = jnp.asarray(nt.SEED_TAB)
    rseed_t = jnp.asarray(nt.RC_SEED_TAB)
    fa = jnp.uint64(int(nt.SEED_TAB[ord("A")]))
    ra = jnp.uint64(int(nt.RC_SEED_TAB[ord("A")]))

    def probe_full(filt, base):
        return _probe_full(filt, bits, base, k, h)

    def probe_h1(filt, base):
        return bit_set(filt, probe_index(base, bits))

    def run(words, codes):
        R, L = codes.shape
        nw = L - k + 1
        from . import scan_conv

        fh, rh = ntj.strand_hashes(codes, k)  # [R, nw] u64
        base = fh + rh
        present = probe_full(words, base)  # [R, nw]

        # --- detection masks (polish/ntedit_tpu._masks semantics)
        acc = _accepted_mask(codes)  # [R, L]
        badc = jnp.cumsum(~acc, axis=-1)  # inclusive
        # clean[w] = no bad char in [w, w+k-1]
        clean = (badc[:, k - 1 :] - jnp.pad(badc, ((0, 0), (1, 0)))[:, :nw]) == 0
        miss = ~present
        cm = jnp.zeros((R, nw), jnp.int32)
        for kk in range(0, k, jump):
            off = kk + 1
            if off < nw:
                cm = cm.at[:, : nw - off].add(miss[:, off:].astype(jnp.int32))
        # eligible: w <= L-2k and window [w+k, w+2k-1] clean
        eligible = jnp.zeros((R, nw), bool)
        lim = L - 2 * k
        if lim >= 0:
            eligible = eligible.at[:, : lim + 1].set(clean[:, k : k + lim + 1])
        hot = clean & miss & eligible & (cm.astype(jnp.float32) >= thr_missing)

        # --- cluster heads: first hot window with no hot in [w-k+1, w-1]
        hs = jnp.cumsum(hot.astype(jnp.int32), axis=-1)
        hs_pad = jnp.pad(hs, ((0, 0), (k, 0)))  # hs_pad[w+k] = hs[w]
        prev_any = (hs_pad[:, k - 1 : k - 1 + nw]
                    - hs_pad[:, 0:nw]) > 0  # hot in [w-k+1, w-1]
        head = hot & ~prev_any
        n_sites = head.sum(dtype=jnp.int32)
        flat = head.reshape(-1)
        gidx = jnp.arange(R * nw, dtype=jnp.int32)
        big = jnp.int32(R * nw + 1)
        score = jnp.where(flat, big - gidx, 0)
        top, _ = jax.lax.top_k(score, S)
        site = jnp.where(top > 0, big - top, -1)  # ascending w, pad -1
        sidx = jnp.maximum(site, 0)
        r_i = sidx // nw
        w_i = sidx % nw
        # clamp so out-of-range gathers stay in-row (host drops pad sites)
        w_safe = jnp.minimum(w_i, jnp.int32(max(0, nw - 1)))
        p_i = jnp.minimum(w_safe + k - 1, L - 1)

        def code_at(off):
            """codes[r, w + off] gather, clamped to the row."""
            return codes[r_i, jnp.minimum(w_safe + off, L - 1)]

        draft_raw = codes[r_i, p_i]
        draft = jnp.where(
            (draft_raw >= 97) & (draft_raw <= 122), draft_raw - 32, draft_raw
        ).astype(jnp.uint8)
        cand = sub_cand_t[draft]  # [S, 4]
        fh0 = fh[r_i, w_safe]
        rh0 = rh[r_i, w_safe]

        # --- substitutions: gate (j=0) + supports over j_sub
        df = d_f_sub_t[draft]  # [S, 4]
        dr = d_r_sub_t[draft]
        sub_bases = []
        for j in [0] + j_sub:
            wj = jnp.minimum(w_safe + j, jnp.int32(max(0, nw - 1)))
            fh_j = fh[r_i, wj][:, None] ^ _srol_const(df, j % nt.SROL_PERIOD)
            rh_j = rh[r_i, wj][:, None] ^ _srol_const(
                dr, (k - 1 - j) % nt.SROL_PERIOD
            )
            sub_bases.append(fh_j + rh_j)
        sub_pres = probe_full(
            words, jnp.stack(sub_bases, axis=0)
        )  # [1+nj, S, 4]
        gate = sub_pres[0]  # [S, 4] bool
        sub_sup = sub_pres[1:].astype(jnp.int8).sum(axis=0)

        # --- deletions: MD rolled chains from changelast(draft -> s[p+d])
        f_draft = fseed_t[draft]  # [S]
        r_draft = rseed_t[draft]
        d_off = jnp.arange(1, MD + 1, dtype=jnp.int32)  # [MD]
        nxt = codes[r_i[:, None],
                    jnp.minimum(p_i[:, None] + d_off[None, :], L - 1)]  # [S,MD]
        fh_d, rh_d = _changelast(
            fh0[:, None], rh0[:, None], k,
            f_draft[:, None], fseed_t[nxt], r_draft[:, None], rseed_t[nxt],
        )
        del_bases = [fh_d + rh_d]  # j=0
        for kk in range(1, k - 1):
            c_out = code_at(kk - 1)  # [S]
            c_in = codes[r_i[:, None], jnp.minimum(
                p_i[:, None] + d_off[None, :] + kk, L - 1
            )]
            fh_d, rh_d = _roll(
                fh_d, rh_d, k,
                fseed_t[c_out][:, None], fseed_t[c_in],
                rseed_t[c_out][:, None], rseed_t[c_in],
            )
            if kk % jump == 0:
                del_bases.append(fh_d + rh_d)
        assert len(del_bases) == len(j_del)
        del_pres = probe_full(words, jnp.stack(del_bases, axis=0))
        del_sup = del_pres.astype(jnp.int8).sum(axis=0)

        # --- insertion lane: first gated candidate whose sub was NOT
        # accepted and with no accepted sub at an earlier lane
        accepted = gate & (sub_sup.astype(jnp.float32) >= thr_edit)
        acc_before = jnp.cumsum(accepted.astype(jnp.int32), axis=1) \
            - accepted.astype(jnp.int32)
        needs = gate & ~accepted & (acc_before == 0) \
            & (cand != 0)  # zero-padded lanes never trial
        any_needs = needs.any(axis=1)
        ins_lane = jnp.where(
            any_needs, jnp.argmax(needs, axis=1).astype(jnp.int8),
            jnp.int8(-1),
        )
        # --- compact the needing sites into the ins-stage budget SI:
        # the walker reads ins tables only where the needing lane exists;
        # for every other head (an accepted sub, detection noise) the
        # [*, C, T] combo prescreen below — the program's dominant probe
        # volume — would be dead weight.  Needing sites beyond the budget
        # get ins_ok=0 and are redone natively (cost, never correctness).
        need_flag = any_needs & (site >= 0)
        nbig = jnp.int32(S + 1)
        nscore = jnp.where(
            need_flag, nbig - jnp.arange(S, dtype=jnp.int32), 0
        )
        ntop, _ = jax.lax.top_k(nscore, SI)
        nvalid = ntop > 0
        nsel = jnp.where(nvalid, nbig - ntop, 0)  # [SI] indices into [S]

        r_n = r_i[nsel]
        w_n = w_safe[nsel]
        p_n = p_i[nsel]
        f_draft_n = f_draft[nsel]
        r_draft_n = r_draft[nsel]
        fh0_n = fh0[nsel]
        rh0_n = rh0[nsel]
        lane_n = jnp.maximum(ins_lane[nsel], 0).astype(jnp.int32)
        index_char_n = jnp.take_along_axis(
            cand[nsel], lane_n[:, None], axis=1
        )[:, 0]

        def code_at_n(off):
            return codes[r_n, jnp.minimum(w_n + off, L - 1)]

        # --- per-length reference chains: ref combo = index_char + 'A'*(L-1)
        # chain state [SI, MI] (length group L = 1..MI); c_in at roll s:
        #   'A'            s <  L
        #   draft          s == L
        #   codes[p+s-L]   s >  L
        fh_i, rh_i = _changelast(
            fh0_n[:, None], rh0_n[:, None], k,
            f_draft_n[:, None],
            jnp.broadcast_to(fseed_t[index_char_n][:, None], (SI, MI)),
            r_draft_n[:, None],
            jnp.broadcast_to(rseed_t[index_char_n][:, None], (SI, MI)),
        )
        l_grp = jnp.arange(1, MI + 1, dtype=jnp.int32)[None, :]  # [1, MI]
        ref_f = []
        ref_r = []
        for s in range(1, k):  # rolls; probe points at j_ins
            c_out = code_at_n(s - 1)
            suf = codes[r_n[:, None], jnp.minimum(
                jnp.maximum(p_n[:, None] + s - l_grp, 0), L - 1
            )]
            f_in = jnp.where(
                s < l_grp, fa,
                jnp.where(s == l_grp, f_draft_n[:, None], fseed_t[suf]),
            )
            r_in = jnp.where(
                s < l_grp, ra,
                jnp.where(s == l_grp, r_draft_n[:, None], rseed_t[suf]),
            )
            fh_i, rh_i = _roll(
                fh_i, rh_i, k,
                fseed_t[c_out][:, None], f_in, rseed_t[c_out][:, None], r_in,
            )
            if s in j_ins:
                ref_f.append(fh_i)
                ref_r.append(rh_i)
        ref_f = jnp.stack(ref_f, axis=-1)  # [SI, MI, T]
        ref_r = jnp.stack(ref_r, axis=-1)
        T = ref_f.shape[-1]

        # --- stage 1: h1-only upper bound for every combo
        grp = combo_len_t - 1  # [C] length-group index
        cf = ref_f[:, grp, :] ^ d_f_ins_t[None, :, :]  # [SI, C, T]
        cr = ref_r[:, grp, :] ^ d_r_ins_t[None, :, :]
        cbase = cf + cr
        maybe = probe_h1(words, cbase)  # h1 bit only
        maybe_cnt = maybe.sum(axis=-1, dtype=jnp.int32)  # [SI, C]
        can_pass = maybe_cnt.astype(jnp.float32) >= thr_edit
        n_surv = can_pass.sum(axis=1)
        ins_ok_n = ((n_surv <= T_SURVIVORS) & nvalid).astype(jnp.uint8)

        # --- stage 2: full-h exact probes for the survivors
        surv_score = jnp.where(can_pass, jnp.int32(C) - jnp.arange(C)[None, :], 0)
        top_s, _ = jax.lax.top_k(surv_score, T_SURVIVORS)  # [SI, T_SURV]
        surv_idx = jnp.where(top_s > 0, jnp.int32(C) - top_s, 0)
        surv_valid = top_s > 0
        sbase = jnp.take_along_axis(cbase, surv_idx[:, :, None], axis=1)
        exact = probe_full(words, sbase).sum(
            axis=-1, dtype=jnp.int8
        )  # [SI, T_SURV]
        ins_sup_n = jnp.zeros((SI, C), jnp.int8)
        ins_sup_n = ins_sup_n.at[
            jnp.arange(SI, dtype=jnp.int32)[:, None], surv_idx
        ].max(jnp.where(surv_valid, exact, 0), mode="drop")

        # --- scatter the compacted results back to the [S] site lanes
        scat = jnp.where(nvalid, nsel, jnp.int32(S))
        ins_ok = jnp.zeros(S + 1, jnp.uint8).at[scat].max(
            ins_ok_n, mode="drop"
        )[:S]
        ins_sup = jnp.zeros((S + 1, C), jnp.int8).at[scat].max(
            jnp.where(nvalid[:, None], ins_sup_n, 0), mode="drop"
        )[:S]

        packed = scan_conv._pack_bits(present)
        return (packed, n_sites, site, gate.astype(jnp.uint8),
                sub_sup, del_sup, ins_lane, ins_ok, ins_sup)

    return run  # raw (FusedEval jits; DeviceScanner may shard_map first)


class FusedEval:
    """Host-side handle on the (process-cached) jitted fused program.

    `calls` counts dispatches across all instances (device-work evidence
    for the chip smoke run)."""

    calls = 0

    def __init__(self, cfg: EvalConfig, bits: int, tables: SiteTables):
        self.cfg = cfg
        self.bits = bits
        self.tables = tables
        args = (cfg.key(), bits, cfg.k, cfg.jump, cfg.max_ins, cfg.max_del)
        self.raw = _fused_cached(*args)
        self._run = _fused_jitted(*args)

    def __call__(self, words, codes):
        FusedEval.calls += 1
        return self._run(words, codes)
