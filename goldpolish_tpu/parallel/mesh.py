"""Multi-chip scale-out: device mesh + sharded polishing step.

The reference's parallelism is process-level batch fan-out over one host
(reference: scripts/goldpolish:43,527-533 — up to 200 worker processes over
/dev/shm).  The accelerator-native equivalent (SURVEY §2.3) is SPMD over a
jax.sharding.Mesh:

 * axis "dp"  — contig-batch data parallelism (the reference's batch axis),
 * axis "sp"  — sequence parallelism: each contig's window axis is split
   into chunks with a (k-1)-base halo so every device computes the hashes
   and Bloom probes of its window shard independently (window stitching
   plays the role the reference's per-batch windowing does, SURVEY §5),
 * the per-batch Bloom filter is replicated (512 KiB — tiny next to HBM),
   exactly like the reference replicates BF files per worker,
 * per-shard detection statistics merge with psum over both axes; polished
   output ordering is preserved by indexing (the reaper contract).

Works identically on a virtual CPU mesh (tests / dry-run) and on real
multi-GPU hosts; multi-host runs only need jax.distributed.initialize() before
make_mesh().
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import bloom_jax, nthash_jax as ntj


def make_mesh(n_devices: int | None = None, dp: int | None = None) -> Mesh:
    """Mesh over the first n devices with axes (dp, sp)."""
    devs = jax.devices()
    n = n_devices or len(devs)
    if n > len(devs):
        raise RuntimeError(
            f"mesh needs {n} devices but only {len(devs)} available "
            f"({devs[0].platform}); for virtual CPU devices set "
            "jax.config jax_platforms='cpu' + jax_num_cpu_devices before "
            "any backend initialization"
        )
    devs = devs[:n]
    if dp is None:
        # prefer a 2D mesh when possible so both axes are exercised
        dp, sp = n, 1
        for cand in (2, 4, 8):
            if n % cand == 0 and n // cand >= 1:
                dp, sp = n // cand, cand
                break
    else:
        sp = n // dp
    return Mesh(np.array(devs).reshape(dp, sp), ("dp", "sp"))


def haloed_windows(codes: np.ndarray, sp: int, k: int) -> np.ndarray:
    """Split [B, L] byte arrays into [B, sp, L/sp + k-1] haloed chunks so
    each sequence shard can hash all windows beginning in its chunk."""
    b, length = codes.shape
    chunk = -(-length // sp)
    padded = np.zeros((b, sp * chunk + k - 1), np.uint8)
    padded[:, :length] = codes
    out = np.zeros((b, sp, chunk + k - 1), np.uint8)
    for s in range(sp):
        out[:, s] = padded[:, s * chunk : s * chunk + chunk + k - 1]
    return out


def sharded_scan_step(mesh: Mesh, k: int, hash_num: int, bits: int):
    """Jitted SPMD polishing scan step.

    fn(words u32[W], windows u8[B, sp, C+k-1]) ->
        (present bool[B, sp, C], stats i64[2])

    `windows` is sharded (dp, sp, None); `words` replicated; stats are the
    psum-merged (windows_probed, windows_missing) counts.
    """

    def step(words, win):
        # win: [B/dp, 1, C+k-1] on each device
        present = bloom_jax.probe_kmers(words, bits, hash_num, k, win)
        missing = (~present).sum(dtype=jnp.int64)
        # derive `probed` from data so it carries the sharded axes' varying
        # state (a bare constant would be rejected by psum's vma check)
        probed = missing * 0 + present.size
        stats = jax.lax.psum(
            jnp.stack([probed, missing]).reshape(1, 2), ("dp", "sp")
        )
        return present, stats

    smapped = shard_map(
        step,
        mesh=mesh,
        in_specs=(P(), P("dp", "sp", None)),
        out_specs=(P("dp", "sp", None), P()),
    )
    return jax.jit(smapped)


def sharded_site_eval_step(mesh: Mesh, k: int, hash_num: int, bits: int,
                           j_idx: np.ndarray):
    """Jitted SPMD candidate-support step: patches u8[S, C, L] sharded on dp
    (candidate batches), BF replicated -> supports i32[S, C] + psum totals."""
    j = jnp.asarray(j_idx)

    def step(words, patches):
        f = ntj.forward_hashes(patches, k)
        r = ntj.reverse_hashes(patches, k)
        hashes = ntj.multi_hashes((f + r)[..., j], k, hash_num)
        pr = bloom_jax.probe_words(words, bits, hashes)
        sup = pr.sum(axis=-1, dtype=jnp.int32)
        # patches vary only over dp (sp sees identical candidate shards),
        # so the cross-device total reduces over dp alone
        total = jax.lax.psum(sup.sum(dtype=jnp.int64).reshape(1, 1), ("dp",))
        return sup, total

    smapped = shard_map(
        step,
        mesh=mesh,
        in_specs=(P(), P("dp", None, None)),
        out_specs=(P("dp", None), P()),
    )
    return jax.jit(smapped)


def replicate(mesh: Mesh, x):
    return jax.device_put(x, NamedSharding(mesh, P()))


def shard_windows(mesh: Mesh, windows: np.ndarray):
    return jax.device_put(windows, NamedSharding(mesh, P("dp", "sp", None)))
