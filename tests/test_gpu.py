"""Card-only checks of the device kernels as the GPU compiles them.

Each test takes the `gpu` fixture and skips where JAX has no GPU; run them
on the card with `GPTPU_TEST_GPU=1 python -m pytest -m gpu tests/`.  The
same comparisons run on the CPU elsewhere in the suite; here the GPU's own
compiler (cuDNN convs, TF32 policy, XLA's GPU gathers) is what is tested.
"""

import numpy as np
import pytest

from goldpolish_tpu.ops import bloom, nthash as nt

pytestmark = pytest.mark.gpu

K, H = 32, 4


def _codes(n, seed):
    rng = np.random.default_rng(seed)
    codes = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].copy()
    codes[5::997] = np.frombuffer(b"acgtNnRYKM", np.uint8)[
        np.arange(len(codes[5::997])) % 10]
    return codes


@pytest.mark.parametrize("k", [20, 24, 28, 32])
def test_gpu_conv_hash_exact(gpu, k):
    import jax

    from goldpolish_tpu.ops import scan_conv

    codes = _codes(1 << 20, k)
    got = np.asarray(jax.jit(scan_conv.canonical_hashes_conv,
                             static_argnums=1)(codes[None], k))[0]
    assert np.array_equal(got, nt.canonical_hashes(codes, k))


def test_gpu_fused_scan_matches_host(gpu):
    from goldpolish_tpu.ops import scan_conv
    from goldpolish_tpu.polish.scanpipe import ScanPipe

    codes = _codes(1 << 20, 7)
    hashes = nt.multi_hashes(nt.canonical_hashes(codes, K), K, H)
    bf = bloom.BloomFilter(1 << 22, H, K)
    bf.insert(hashes[::2])
    (_j, got), = list(ScanPipe(scan_conv.DeviceScanner(bf), K).run(
        [(0, codes)]))
    assert np.array_equal(got, bf.contains(hashes))


def test_gpu_device_fill_superset_of_host(gpu):
    from goldpolish_tpu import native
    from goldpolish_tpu.ops import bloom_sort

    rng = np.random.default_rng(3)
    truth = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 200_000)]
    reads = [truth[s: s + 20_000].tobytes()
             for rep in range(5) for s in range(rep * 2000, 180_000, 10_000)]
    thrs = [5] * len(reads)
    cbfs = [bloom.CountingBloomFilter8(bloom.DEFAULT_CBF_BYTES, H, k)
            for k in (32, 20)]
    host = [bloom.BloomFilter(1 << 19, H, k) for k in (32, 20)]
    native.fill_bfs_stream(reads, thrs, H, [32, 20], cbfs, host)
    dev = bloom_sort.device_fill_bfs_sorted(
        reads, thrs, [32, 20], H, bloom.DEFAULT_CBF_BYTES, 1 << 19)
    for h_bf, d_bf in zip(host, dev):
        assert not (h_bf.array & ~d_bf.array).any()
