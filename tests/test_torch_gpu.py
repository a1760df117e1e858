"""CUDA kernels of the port against their plain PyTorch versions, on the
card.  Marked ``gpu``; each test skips without a CUDA device.

This file imports neither jax nor the JAX package's engine, so it also
runs where jax is not installed, without tests/conftest.py:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from kmer_denovo_filter_tpu_torch import engine as eng
from kmer_denovo_filter_tpu_torch.ops import device as dev
from kmer_denovo_filter_tpu_torch.ops import extract, probe
from kmer_denovo_filter_tpu_torch.ops import keys as keys64

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _batch(seed, n=2048, length=152):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (n, length), dtype=np.uint8)
    codes[rng.random((n, length)) < 0.01] = 4
    lengths = rng.integers(0, length + 1, n).astype(np.int32)
    lengths[::2] = length
    return torch.from_numpy(codes), torch.from_numpy(lengths)


@pytest.mark.parametrize("k", [3, 15, 17, 21, 31])
def test_extract_kernel_matches_plain(cuda, k):
    codes, lengths = (t.to(cuda) for t in _batch(k))
    before = extract.launches
    got = extract.extract_canonical(codes, lengths, k)
    ref = dev.extract_canonical_windows(codes, lengths, k)[0]
    torch.cuda.synchronize()
    assert extract.launches == before + 1
    assert torch.equal(got, ref)


@pytest.mark.parametrize("m", [1, 777, 6144, 6145, 100_000])
def test_probe_kernel_matches_plain(cuda, m):
    """Table sizes around the 48 KB shared-memory staging edge."""
    codes, lengths = (t.to(cuda) for t in _batch(m))
    keys = extract.extract_canonical(codes, lengths, 31).reshape(-1)
    live = torch.unique(keys[keys != keys64.SENTINEL])
    gen = torch.Generator(device="cpu").manual_seed(m)
    from_batch = live[torch.randperm(live.numel(), generator=gen)[
        :max(1, m // 2)].to(cuda)]
    rand = torch.randint(0, 4 ** 31, (m - from_batch.numel(),),
                         generator=gen).to(cuda)
    table = torch.unique(torch.cat([from_batch, rand]))
    acc = torch.full((table.numel(),), 5, dtype=torch.int64, device=cuda)
    before = probe.launches
    probe.probe_tally(keys, table, acc)
    ref = 5 + dev.small_table_tally(table, keys)
    torch.cuda.synchronize()
    assert probe.launches == before + 1
    assert torch.equal(acc, ref)
    assert int(ref.sum()) > 5 * table.numel()


def test_filtered_counter_cuda_matches_cpu(cuda):
    codes, lengths = _batch(99, n=3000)
    keys = dev.extract_canonical_windows(codes, lengths, 31)[0]
    live = torch.unique(keys[keys != keys64.SENTINEL])[::7]
    words = keys64.keys64_to_words(live, 31)
    results = []
    for device in (cuda, torch.device("cpu")):
        fc = eng.FilteredCounter(eng.KmerIndex(words, 31, device=device))
        fc.feed(codes.numpy(), lengths.numpy())
        fc.feed(codes[:1000].numpy(), lengths[:1000].numpy())
        results.append(fc.result())
    assert np.array_equal(results[0], results[1])
    assert results[0].sum() > 0
