"""The port's CUDA kernels on the card: each kernel against its plain
PyTorch version on the same CUDA tensors (bit-identical: both sum the k
gathers in j order in f32, and the embedding rounds once to the table's
dtype), their input checks, the retrieval drill launching the decode
kernel once per decode step, and the LM engine launching both kernels
once per prefill and per decode step.

Marked ``cuda``; every test skips without a GPU.  On a machine with one:
    PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py
This file imports no JAX, so it runs where only PyTorch is installed."""
import math

import pytest
import torch

from repro_torch import configs
from repro_torch.configs.retrieval import get_retrieval_config
from repro_torch.core.bloom import cached_hash_matrix
from repro_torch.kernels import bloom_decode_topk as dt
from repro_torch.kernels import bloom_embed as be
from repro_torch.kernels import common, ops
from repro_torch.launch import serve
from repro_torch.models import io as io_lib
from repro_torch.serving import retrieval
from repro_torch.serving.engine import Engine
from repro_torch.serving.loadgen import mixed_length_workload

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


@pytest.mark.parametrize("T,D,k", [(1, 1024, 4), (14, 1024, 4), (8, 1024, 1),
                                   (8, 1024, 3), (14, 1000, 4), (7, 1020, 4),
                                   (3, 37, 2), (300, 64, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embed_kernel_bit_identical_to_plain(cuda, T, D, k, dtype):
    g = torch.Generator().manual_seed(T * D + k)
    m = 512
    table = torch.randn(m, D, generator=g).to(dtype).to(cuda)
    idx = torch.randint(0, m, (T, k), generator=g,
                        dtype=torch.int32).to(cuda)
    got = be.bloom_embed_cuda(table, idx)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got,
                                              be.bloom_embed_plain(table, idx))


def test_embed_kernel_takes_an_unaligned_table(cuda):
    table = torch.randn(65 * 64 + 1, device=cuda)[1:].view(65, 64)
    assert table.is_contiguous() and table.data_ptr() % 16
    idx = torch.randint(0, 65, (5, 3), dtype=torch.int32, device=cuda)
    assert torch.equal(be.bloom_embed_cuda(table, idx),
                       be.bloom_embed_plain(table, idx))


def test_embed_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    table = torch.randn(16, 8, device=cuda)
    idx = torch.zeros((4, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        be.bloom_embed_cuda(table.double(), idx)
    with pytest.raises(TypeError):
        be.bloom_embed_cuda(table, idx.long())
    with pytest.raises(ValueError, match="contiguous"):
        be.bloom_embed_cuda(table.t().contiguous().t(), idx)
    with pytest.raises(ValueError, match="one device"):
        be.bloom_embed(table, idx.cpu())


def test_ops_embed_raises_under_grad_on_cuda(cuda):
    spec = io_lib.vocab_spec(configs.get_smoke_config("qwen1.5-0.5b"))
    table = torch.randn(spec.m, 16, device=cuda, requires_grad=True)
    tokens = torch.tensor([[1, 2, 3]], device=cuda)
    with pytest.raises(NotImplementedError, match="B4/B6"):
        ops.bloom_embed(table, tokens, spec)
    with torch.no_grad():
        out = ops.bloom_embed(table, tokens, spec)
    assert out.shape == (1, 3, 16)


@pytest.mark.parametrize("B,live", [(1, None), (8, None), (8, [0, 3, 7])])
def test_decode_topk_at_the_lm_shapes(cuda, B, live):
    spec = io_lib.vocab_spec(configs.get_config("qwen1.5-0.5b"))
    H = cached_hash_matrix(spec, cuda)
    g = torch.Generator().manual_seed(B)
    logp = torch.log_softmax(torch.randn(B, spec.m, generator=g), -1)
    logp = logp.to(cuda)
    active = None
    if live is not None:
        active = torch.zeros(B, dtype=torch.bool, device=cuda)
        active[live] = True
    kv, ki = dt.bloom_decode_topk_cuda(logp, H, 8, active)
    torch.cuda.synchronize()
    pv, pi = dt.bloom_decode_topk_plain(logp, H, 8, active)
    assert torch.equal(ki, pi) and torch.equal(kv, pv)


def test_lm_engine_launches_both_kernels_every_step(cuda):
    cfg = configs.get_smoke_config("qwen1.5-0.5b", dtype="bfloat16")
    model = serve.build_model(cfg, 0, cuda)
    engine = Engine(cfg, model, n_slots=3, max_len=40, topk=4)
    wl = mixed_length_workload(cfg.vocab, 10, seed=0)
    tokens = []
    for run in (engine.run, engine.run_static):
        common.reset_launches()
        res, st = run([r.fresh_copy() for r in wl])
        want = st.prefills + st.decode_steps
        assert common.LAUNCHES[be.NAME] == want
        assert common.LAUNCHES[dt.NAME] == want
        tokens.append({rid: r.tokens for rid, r in res.items()})
    assert tokens[0] == tokens[1]
