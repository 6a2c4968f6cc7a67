"""The port's CUDA kernels on the card: each kernel against its plain
PyTorch version on the same CUDA tensors (ids and values bit-identical:
both sum the k gathers in j order in f32), its input checks, and the
retrieval drill launching the kernel once per decode step.

Marked ``cuda``; every test skips without a GPU.  On a machine with one:
    PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py
This file imports no JAX, so it runs where only PyTorch is installed."""
import math

import pytest
import torch

from repro_torch.configs.retrieval import get_retrieval_config
from repro_torch.kernels import bloom_decode_topk as dt
from repro_torch.kernels import common
from repro_torch.serving import retrieval

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _inputs(B, m, d, k, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    logp = torch.log_softmax(torch.randn(B, m, generator=g), -1)
    H = torch.randint(0, m, (d, k), generator=g, dtype=torch.int32)
    return logp.to(dev), H.to(dev)


@pytest.mark.parametrize("B,m,d,k,topk", [
    (1, 32, 100, 1, 1), (5, 64, 333, 3, 8), (8, 128, 1024, 4, 16),
    (3, 96, 50, 2, 50), (6, 8192, 100_003, 2, 10), (4, 256, 70_001, 3, 64),
    (2, 56 * 1024, 5000, 2, 17)])
@pytest.mark.parametrize("live", ["all", "some", "none"])
def test_kernel_bit_identical_to_plain(cuda, B, m, d, k, topk, live):
    logp, H = _inputs(B, m, d, k, cuda)
    active = None
    if live != "all":
        active = torch.zeros(B, dtype=torch.bool, device=cuda)
        if live == "some":
            active[::2] = True
    kv, ki = dt.bloom_decode_topk_cuda(logp, H, topk, active)
    torch.cuda.synchronize()
    pv, pi = dt.bloom_decode_topk_plain(logp, H, topk, active)
    assert torch.equal(ki, pi) and torch.equal(kv, pv)


def test_full_tie_returns_lowest_ids(cuda):
    logp = torch.full((3, 64), -math.log(64), device=cuda)
    _, H = _inputs(3, 64, 5000, 2, cuda)
    _, ids = dt.bloom_decode_topk_cuda(logp, H, 20)
    assert torch.equal(ids.cpu(), torch.arange(20, dtype=torch.int32)
                       .expand(3, 20))


def test_entry_launches_the_kernel_on_cuda_tensors(cuda):
    logp, H = _inputs(2, 64, 1000, 2, cuda)
    common.reset_launches()
    dt.bloom_decode_topk(logp, H, 5)
    assert common.LAUNCHES[dt.NAME] == 1


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    logp, H = _inputs(2, 64, 1000, 2, cuda)
    with pytest.raises(ValueError, match="maximum"):
        dt.bloom_decode_topk_cuda(logp, H, 65)
    with pytest.raises(TypeError):
        dt.bloom_decode_topk_cuda(logp.double(), H, 5)
    with pytest.raises(TypeError):
        dt.bloom_decode_topk_cuda(logp, H.long(), 5)
    with pytest.raises(ValueError, match="contiguous"):
        dt.bloom_decode_topk_cuda(logp.t().contiguous().t(), H, 5)
    with pytest.raises(ValueError, match="shared-memory"):
        big, _ = _inputs(1, dt.MAX_M + 1, 10, 2, cuda)
        dt.bloom_decode_topk_cuda(big, H, 5)
    with pytest.raises(ValueError, match="one device"):
        dt.bloom_decode_topk(logp, H.cpu(), 5)
    odd = H.reshape(-1)
    odd = torch.cat([odd[:1], odd])[1:].view(H.shape)   # 4-byte offset
    assert odd.is_contiguous() and odd.data_ptr() % 8 == 4
    with pytest.raises(ValueError, match="8-byte"):
        dt.bloom_decode_topk_cuda(logp, odd, 5)


def test_drill_launches_the_kernel_every_decode_step(cuda):
    common.reset_launches()
    report = retrieval._drill(get_retrieval_config("smoke"), 8, 4, 0, cuda)
    assert report["impl"] == "kernel"
    assert common.LAUNCHES[dt.NAME] == 2 * report["decode_steps"]
