"""JAX/device backend for batched site evaluation.

v2: everything on device.  The contig's byte codes are uploaded once per
contig (shared with the present[] probe pass); each eval call ships only the
site indices (a few KB) and downloads compact int8 supports — patch tensors
are *constructed on device* by gathers from the codes array, mirroring
ops/siteeval.py's patch geometry exactly, so host<->device traffic stays
proportional to the number of sites, not to the contig.

Produces SiteSupports numerically identical to eval_sites_np
(differentially tested through the engine equivalence suite).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from . import nthash_jax as ntj
from .siteeval import SiteSupports, SiteTables


def _probe(words, bits: int, hashes):
    if bits & (bits - 1) == 0:
        idx = (hashes & jnp.uint64(bits - 1)).astype(jnp.uint32)
    else:
        idx = (hashes % jnp.uint64(bits)).astype(jnp.uint32)
    word = words[(idx >> jnp.uint32(5)).astype(jnp.int32)]
    return ((word >> (idx & jnp.uint32(31))) & jnp.uint32(1) != 0).all(axis=-1)


def _window_probes(words, bits, patches, k, h, j_idx):
    f = ntj.forward_hashes(patches, k)
    r = ntj.reverse_hashes(patches, k)
    hashes = ntj.multi_hashes((f + r)[..., j_idx], k, h)
    return _probe(words, bits, hashes)


@lru_cache(maxsize=32)
def _kernel(k: int, h: int, jump: int, bits: int, C: int, max_ins: int,
            max_del: int, suffix_len: int,
            j_sub: tuple, j_ins: tuple, j_del: tuple,
            sub_cand_b: bytes, combo_codes_b: bytes, combo_len_b: bytes):
    """Jitted device program: (codes, sites, n, words) -> supports.

    All static tables are baked in as device constants.
    """
    j_sub_d = jnp.asarray(np.array(j_sub, np.int32))
    j_ins_d = jnp.asarray(np.array(j_ins, np.int32))
    j_del_d = jnp.asarray(np.array(j_del, np.int32))
    sub_cand = jnp.asarray(np.frombuffer(sub_cand_b, np.uint8).reshape(256, 4))
    combo_codes = jnp.asarray(
        np.frombuffer(combo_codes_b, np.uint8).reshape(4, -1, max_ins)[:, :C, :]
    )
    combo_len = jnp.asarray(np.frombuffer(combo_len_b, np.int32)[:C])
    base_row_np = np.zeros(256, np.int32)
    for bi, b in enumerate(b"ACGT"):
        base_row_np[b] = bi
    base_row = jnp.asarray(base_row_np)
    L_sub, L_ins, L_del = 2 * k, 2 * k + max_ins, 2 * k - 1

    @jax.jit
    def run(codes, sites, n, words):
        S = sites.shape[0]
        p = sites + k - 1
        pref = codes[sites[:, None] + jnp.arange(k - 1)[None, :]]
        draft_raw = codes[p]
        draft = jnp.where(
            (draft_raw >= 97) & (draft_raw <= 122), draft_raw - 32, draft_raw
        ).astype(jnp.uint8)
        suf_idx = p[:, None] + 1 + jnp.arange(suffix_len)[None, :]
        suffix = jnp.where(
            suf_idx < n, codes[jnp.minimum(suf_idx, codes.shape[0] - 1)], 0
        ).astype(jnp.uint8)
        cand = sub_cand[draft]  # [S,4]

        # --- substitution patches [S,4,L_sub]
        sub_patches = jnp.concatenate(
            [
                jnp.broadcast_to(pref[:, None, :], (S, 4, k - 1)),
                cand[:, :, None],
                jnp.broadcast_to(suffix[:, None, :k], (S, 4, k)),
            ],
            axis=-1,
        )
        sub_pr = _window_probes(
            words, bits, sub_patches, k, h,
            jnp.concatenate([jnp.zeros(1, jnp.int32), j_sub_d]),
        )
        gate = sub_pr[..., 0]
        sub_sup = sub_pr[..., 1:].sum(axis=-1, dtype=jnp.int8)

        # --- insertion patches [S,4,C,L_ins]
        rows = base_row[cand]  # [S,4]
        combos = combo_codes[rows]  # [S,4,C,max_ins]
        rel = jnp.arange(L_ins - (k - 1))[None, :]  # [1, L-k+1]
        cl = combo_len[:, None]  # [C,1]
        is_combo = rel < cl
        is_draft = rel == cl
        suf_off = jnp.maximum(rel - cl - 1, 0)  # [C, L-k+1]
        combo_vals = jnp.take_along_axis(
            combos,
            jnp.broadcast_to(
                jnp.minimum(rel, max_ins - 1)[None, None, :, :],
                (S, 4, C, L_ins - (k - 1)),
            ),
            axis=3,
        )
        suf_vals = jnp.take_along_axis(
            jnp.broadcast_to(suffix[:, None, None, :], (S, 4, C, suffix_len)),
            jnp.broadcast_to(suf_off[None, None, :, :], (S, 4, C, L_ins - (k - 1))),
            axis=3,
        )
        tail = jnp.where(
            is_combo[None, None],
            combo_vals,
            jnp.where(is_draft[None, None], draft[:, None, None, None], suf_vals),
        )
        ins_patches = jnp.concatenate(
            [jnp.broadcast_to(pref[:, None, None, :], (S, 4, C, k - 1)), tail],
            axis=-1,
        )
        ins_pr = _window_probes(words, bits, ins_patches, k, h, j_ins_d)
        ins_sup = ins_pr.sum(axis=-1, dtype=jnp.int8)

        # --- deletion patches [S,max_del,L_del]
        didx = (jnp.arange(max_del)[:, None] + jnp.arange(k)[None, :])  # [MD,k]
        del_patches = jnp.concatenate(
            [
                jnp.broadcast_to(pref[:, None, :], (S, max_del, k - 1)),
                suffix[:, didx],
            ],
            axis=-1,
        )
        del_pr = _window_probes(words, bits, del_patches, k, h, j_del_d)
        return gate, sub_sup, ins_sup, del_pr

    return run


def eval_sites_jax(seq_codes, sites_w: np.ndarray, words, bits: int,
                   tables: SiteTables, h: int, n_combos: int | None = None,
                   s_bucket: int = 256, codes_dev=None) -> SiteSupports:
    """Device evaluator; same results as siteeval.eval_sites_np.

    seq_codes: host uint8 array (used for the sub_cand lookup + fallback
    upload); codes_dev: optional already-on-device codes (reused across the
    contig's eval calls — upload once).
    """
    k = tables.k
    C = tables.n_combos if n_combos is None else n_combos
    n = len(seq_codes)
    S = len(sites_w)
    SB = s_bucket
    while SB < S:
        SB *= 2
    sites_padded = np.zeros(SB, np.int64)
    sites_padded[:S] = sites_w
    if codes_dev is None:
        codes_dev = jnp.asarray(np.ascontiguousarray(seq_codes))

    run = _kernel(
        k, h, tables.jump, bits, C, tables.max_ins, tables.max_del,
        tables.suffix_len,
        tuple(tables.j_sub.tolist()), tuple(tables.j_ins.tolist()),
        tuple(tables.j_del.tolist()),
        tables.sub_cand.tobytes(),
        tables.combo_codes.tobytes(),
        tables.combo_len.tobytes(),
    )
    gate, sub_sup, ins_sup, del_pr = run(
        codes_dev, jnp.asarray(sites_padded), jnp.int64(n), words
    )
    gate = np.asarray(gate)[:S]
    sub_sup = np.asarray(sub_sup)[:S].astype(np.int32)
    ins_sup = np.asarray(ins_sup)[:S].astype(np.int32)
    del_pr = np.asarray(del_pr)[:S]

    # deletion validity masks (end-of-contig roll bounds) on host
    p = sites_w + k - 1
    d = np.arange(1, tables.max_del + 1)[None, :, None]
    jj = tables.j_del[None, None, :]
    valid = np.where(
        jj == 0, (p[:, None, None] + d) <= n - 1,
        (p[:, None, None] + d + jj + 1) <= n - 1,
    )
    del_sup = (del_pr & valid).sum(axis=-1).astype(np.int32)

    draft = seq_codes[sites_w + k - 1]
    draft = np.where((draft >= 97) & (draft <= 122), draft - 32, draft).astype(np.uint8)
    return SiteSupports(
        sub_cand=tables.sub_cand[draft], gate=gate, sub_support=sub_sup,
        ins_support=ins_sup, del_support=del_sup, n_combos=C,
    )
