"""The port's CUDA kernels on the card: each kernel against its plain
PyTorch version on the same CUDA tensors (decode-top-k and embedding
bit-identical: both sum the k gathers in j order in f32, and the
embedding rounds once to the table's dtype; the CSR scatter-add
bit-identical to its plain version on a CPU copy, where ``index_add_``
adds in index order; the Bloom CE within loss rtol 1e-6 / atol 1e-5 and
dz atol 1e-7, since the kernel's expf and exp-sum order differ from
torch's in the last ulp; also on the cases the CE kernels branch on:
k = 1, 2, 4, 8 and others, ragged m, -inf columns and rows, the ranged
pair with a row's labels all outside the shard), their input checks,
the retrieval drill launching the decode kernel once per decode step,
the LM engine launching
the decode and embedding kernels once per prefill and per decode step, and
a training step launching the embedding, CSR and CE kernels once each;
and the quantized variants (``table_dtype``): the embedding over f32, bf16,
int8 (+ scales) and fp8 storage bit-identical to its plain version, the
decode over the same storages with the in-kernel hash bit-identical to its
plain version and to the explicit-H kernel, and the retrieval drill, the
LM engine and a train step launching them once per step; and the
differentiable Eq. 3 decode and the dense backwards (``bwd_impl``): the
decode forward over f32, bf16, int8 and fp8 logp bit-identical to its
plain version (NaN where the plain version has NaN), the dense decode and
embedding backwards bit-identical to their plain versions on a CPU copy,
to the CSR kernel and to themselves on a second launch, ``ops.bloom_decode``
and its gradient equal to the CPU path under both backwards, and a dense
train step launching the dense embedding backward; and the card's CSR
binning equal to ``bin_csr_plain``'s on both of its paths (segments longer
than a warp and than a block, all entries in one row, empty rows, -1 pads,
an m past one launch's buckets, the spec's full hash matrix), with the
dense decode backward equal to the CSR one on that matrix for B = 1, 8, 9;
and the decode-top-k kernel's row tiles and live-row mapping (B = 13 and
600, one, none and all but one of 8 rows live, topk 1, 8, 10, 64, each
storage, with the hash and with H) bit-identical to the plain version, to
each other and to a second launch, and full ties giving the lowest ids.

Marked ``cuda``; every test skips without a GPU.  On a machine with one:
    PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py
This file imports no JAX, so it runs where only PyTorch is installed."""
import math

import pytest
import torch

from repro_torch import configs
from repro_torch.configs.retrieval import get_retrieval_config
from repro_torch.core import bloom
from repro_torch.core.bloom import cached_hash_matrix
from repro_torch.configs.base import TrainConfig
from repro_torch.kernels import bloom_ce as ce
from repro_torch.kernels import bloom_csr as csr
from repro_torch.kernels import bloom_decode as bd
from repro_torch.kernels import bloom_decode_topk as dt
from repro_torch.kernels import bloom_embed as be
from repro_torch.kernels import common, ops
from repro_torch.launch import serve
from repro_torch.launch import steps as steps_lib
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


def test_ops_embed_grad_flows_through_the_kernel_pair_on_cuda(cuda):
    spec = io_lib.vocab_spec(configs.get_smoke_config("qwen1.5-0.5b"))
    g = torch.Generator().manual_seed(0)
    base = torch.randn(spec.m, 16, generator=g)
    tokens = torch.randint(0, spec.d, (2, 9), generator=g)
    cot = torch.randn(2, 9, 16, generator=g)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        table = base.to(dev).requires_grad_()
        common.reset_launches()
        out = ops.bloom_embed(table, tokens.to(dev), spec)
        (out * cot.to(dev)).sum().backward()
        grads.append(table.grad.cpu())
        if dev.type == "cuda":
            assert common.LAUNCHES == {"bloom_embed.hash": 1, csr.BIN: 1,
                                       csr.NAME: 1}
    assert torch.equal(grads[0], grads[1])
    with torch.inference_mode():
        common.reset_launches()
        out = ops.bloom_embed(base.to(cuda), tokens.to(cuda), spec)
    assert out.shape == (2, 9, 16) and \
        common.LAUNCHES == {"bloom_embed.hash": 1}


def _ce_inputs(T, m, k, dev, seed=0, dup=False):
    g = torch.Generator().manual_seed(seed)
    z = 3.0 * torch.randn(T, m, generator=g)
    h = torch.randint(0, m, (T, k), generator=g, dtype=torch.int32)
    if dup and k > 1:
        h[::2, 1] = h[::2, 0]
    return (z.to(dev), h.to(dev),
            torch.randn(T, generator=g).to(dev))


@pytest.mark.parametrize("T,m,k", [(1, 8, 1), (7, 128, 3), (16, 1000, 4),
                                   (5, 37, 2), (512, 30208, 4),
                                   (3, 30211, 4)])
@pytest.mark.parametrize("dup", [False, True])
def test_ce_kernels_match_plain(cuda, T, m, k, dup):
    z, h, g = _ce_inputs(T, m, k, cuda, dup=dup)
    loss, lse = ce.bloom_ce_cuda(z, h)
    dz = ce.bloom_ce_bwd_cuda(g, z, h, lse)
    torch.cuda.synchronize()
    ploss, plse = ce.bloom_ce_plain(z, h)
    torch.testing.assert_close(loss, ploss, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(lse, plse, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(dz, ce.bloom_ce_bwd_plain(g, z, h, lse),
                               rtol=0, atol=1e-7)


def test_ce_kernels_take_an_unaligned_row(cuda):
    z = torch.randn(6 * 64 + 1, device=cuda)[1:].view(6, 64)
    assert z.is_contiguous() and z.data_ptr() % 16
    h = torch.randint(0, 64, (6, 3), dtype=torch.int32, device=cuda)
    g = torch.randn(6, device=cuda)
    loss, lse = ce.bloom_ce_cuda(z, h)
    torch.testing.assert_close(loss, ce.bloom_ce_plain(z, h)[0], rtol=1e-6,
                               atol=1e-5)
    torch.testing.assert_close(ce.bloom_ce_bwd_cuda(g, z, h, lse),
                               ce.bloom_ce_bwd_plain(g, z, h, lse),
                               rtol=0, atol=1e-7)


def _finite_close(got, want, what, rtol, atol):
    """Equal where finite, the same entries non-finite."""
    assert torch.equal(torch.isfinite(got), torch.isfinite(want)), what
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=rtol, atol=atol,
                               msg=what)


@pytest.mark.parametrize("k", [1, 2, 4, 8, 3, 40])
@pytest.mark.parametrize("m", [37, 1000, 10240])
def test_ce_kernels_on_the_branch_cases(cuda, k, m):
    """The cases the kernels branch on: k held in registers (1, 2, 4, 8)
    or read per element (3; 40, past one warp's picked lanes), m ragged
    (37) or a multiple of 4, a column hashed three times, -inf columns and
    a row of -inf alone; the forward within rtol 1e-6 / atol 1e-5 and dz
    within atol 1e-7 of the plain versions, non-finite where they are;
    the ranged pair at lo = 100 (one row's labels all outside the shard)
    likewise, and at lo = 0 bit-identical to the unranged pair."""
    gen = torch.Generator().manual_seed(k * 7 + m)
    lo = 100
    zf = 3.0 * torch.randn(7, lo + m, generator=gen)
    zf[1, lo + 5:lo + 9] = -float("inf")
    zf[2] = -float("inf")
    h = torch.randint(0, lo + m, (7, k), generator=gen, dtype=torch.int32)
    if k >= 3:
        h[0, 2] = h[0, 1] = h[0, 0]
    h[3] = torch.randint(0, lo, (k,), generator=gen)
    g = torch.randn(7, generator=gen).to(cuda)
    zf, h = zf.to(cuda), h.to(cuda)
    z = zf[:, lo:].contiguous()
    hz = (h - lo).clamp(0, m - 1).contiguous()
    loss, lse = ce.bloom_ce_cuda(z, hz)
    dz = ce.bloom_ce_bwd_cuda(g, z, hz, lse)
    ploss, plse = ce.bloom_ce_plain(z, hz)
    _finite_close(loss, ploss, "loss", 1e-6, 1e-5)
    _finite_close(lse, plse, "lse", 1e-6, 1e-5)
    _finite_close(dz, ce.bloom_ce_bwd_plain(g, z, hz, lse), "dz", 0, 1e-7)
    l0, hits0 = ce.bloom_ce_shard_cuda(z, hz, 0)
    assert torch.equal(l0.nan_to_num(), lse.nan_to_num())
    # the hit sum is the plain version's bit for bit (both add in j order)
    assert torch.equal(hits0.nan_to_num(),
                       ce.bloom_ce_shard_plain(z, hz, 0)[1].nan_to_num())
    assert torch.equal(ce.bloom_ce_bwd_cuda(g, z, hz, lse, 0).nan_to_num(),
                       dz.nan_to_num())
    slse, hits = ce.bloom_ce_shard_cuda(z, h, lo)
    pslse, phits = ce.bloom_ce_shard_plain(z, h, lo)
    _finite_close(slse, pslse, "ranged lse", 1e-6, 1e-5)
    _finite_close(hits, phits, "hits", 1e-6, 1e-5)
    assert float(hits[3]) == 0.0
    glse = torch.logsumexp(zf, -1)
    _finite_close(ce.bloom_ce_bwd_cuda(g, z, h, glse, lo),
                  ce.bloom_ce_bwd_plain(g, z, h, glse, lo), "ranged dz", 0,
                  1e-7)


def test_ce_wrappers_reject_what_the_kernels_do_not_take(cuda):
    z, h, g = _ce_inputs(4, 64, 3, cuda)
    with pytest.raises(TypeError):
        ce.bloom_ce_cuda(z.double(), h)
    with pytest.raises(TypeError):
        ce.bloom_ce_cuda(z, h.long())
    with pytest.raises(ValueError, match="contiguous"):
        ce.bloom_ce_cuda(z.t().contiguous().t(), h)
    with pytest.raises(ValueError, match="shape"):
        ce.bloom_ce_bwd_cuda(g[:3], z, h, g)
    with pytest.raises(ValueError, match="one device"):
        ce.bloom_ce(z, h.cpu())


def _index_set(T, k, m, rows, g):
    """(T, k) int32 indices: uniform over [0, m) (rows None), drawn from
    the listed rows, or uniform with every third token's first index a -1
    pad and every fifth one's last index m ("pads")."""
    if rows is None or rows == "pads":
        idx = torch.randint(0, m, (T, k), generator=g, dtype=torch.int32)
        if rows == "pads":
            idx[::3, 0] = -1
            idx[::5, -1] = m
        return idx
    pick = torch.randint(0, len(rows), (T, k), generator=g)
    return torch.tensor(rows, dtype=torch.int32)[pick]


# (T, k, m, rows): the train step's shape; a segment longer than a warp;
# segments longer than a block; every entry in one row; mostly empty rows;
# -1 pads and values past m; an m past one launch's buckets, with few and
# with many entries; more entries than one launch bins, also all in one row
BIN_CASES = {
    "train": (520, 4, 30208, None), "warp": (40, 1, 64, [3]),
    "block": (700, 4, 4096, [0, 5, 5, 9]), "one row": (520, 4, 30208, [7]),
    "empty rows": (5, 2, 30208, None), "pads": (300, 3, 500, "pads"),
    "m past smem": (520, 4, 70000, None),
    "m past smem, many": (6000, 4, 70000, "pads"),
    "many entries": (5000, 4, 1000, [1, 2, 2, 999]),
    "one row, many": (20000, 4, 1000, [7])}


@pytest.mark.parametrize("case", sorted(BIN_CASES))
def test_device_bins_equal_bin_csr(cuda, case):
    T, k, m, rows = BIN_CASES[case]
    idx = _index_set(T, k, m, rows, torch.Generator().manual_seed(T + m))
    common.reset_launches()
    a = csr.bin_csr(idx.to(cuda), m)
    b = csr.bin_csr(idx.to(cuda), m)
    torch.cuda.synchronize()
    assert common.LAUNCHES == {csr.BIN: 2}
    want = csr.bin_csr_plain(idx, m)
    for x, y, w in zip(a, b, want):
        assert x.dtype == torch.int32 and torch.equal(x, y)
        assert torch.equal(x.cpu(), w)


def test_device_bins_of_the_spec_hash_matrix(cuda):
    spec = io_lib.vocab_spec(configs.get_config("qwen1.5-0.5b"))
    H = cached_hash_matrix(spec, cuda)
    got = csr.bin_csr(H, spec.m)
    want = csr.bin_csr_plain(H.cpu(), spec.m)
    assert all(torch.equal(x.cpu(), w) for x, w in zip(got, want))
    assert all(torch.equal(x.cpu(), w) for x, w in
               zip(bloom.cached_decode_bins(spec, cuda), want))


@pytest.mark.parametrize("T,k,D,m,rows", [
    (520, 4, 1024, 30208, None), (14, 4, 1000, 512, None),
    (9, 3, 37, 64, None), (300, 4, 64, 4096, [0, 5, 5, 9]),
    (40, 2, 1020, 128, [7]), (40, 1, 1024, 64, [3]),
    (700, 4, 8, 4096, [0, 5, 5, 9]), (300, 3, 1000, 500, "pads"),
    (520, 4, 8, 70000, None), (2000, 4, 8, 30208, None)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_csr_kernel_bit_identical_to_plain_on_the_cpu(cuda, T, k, D, m,
                                                      rows, dtype):
    g = torch.Generator().manual_seed(T + D)
    cot = torch.randn(T, D, generator=g).to(dtype)
    idx = _index_set(T, k, m, rows, g)
    got = csr.csr_scatter_add(cot.to(cuda), idx.to(cuda), m)
    again = csr.csr_scatter_add(cot.to(cuda), idx.to(cuda), m)
    torch.cuda.synchronize()
    want = csr.csr_scatter_add(cot, idx, m)
    assert got.dtype == torch.float32 and torch.equal(got.cpu(), want)
    assert torch.equal(got, again)


def test_csr_kernel_takes_an_unaligned_cotangent(cuda):
    cot = torch.randn(7 * 64 + 1, device=cuda)[1:].view(7, 64)
    assert cot.is_contiguous() and cot.data_ptr() % 16
    idx = torch.randint(0, 32, (7, 3), dtype=torch.int32, device=cuda)
    assert torch.equal(csr.csr_scatter_add(cot, idx, 32).cpu(),
                       csr.csr_scatter_add(cot.cpu(), idx.cpu(), 32))


def test_csr_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    cot = torch.randn(4, 8, device=cuda)
    bins = csr.bin_csr(torch.zeros((4, 2), dtype=torch.int32, device=cuda),
                       16)
    with pytest.raises(TypeError):
        csr.csr_scatter_add_cuda(cot.double(), bins, 16)
    with pytest.raises(ValueError, match="contiguous"):
        csr.csr_scatter_add_cuda(cot.t().contiguous().t(), bins, 16)
    with pytest.raises(ValueError, match="row_ptr"):
        csr.csr_scatter_add_cuda(cot, bins, 15)
    with pytest.raises(ValueError, match="one device"):
        csr.csr_scatter_add(cot, torch.zeros((4, 2), dtype=torch.int32), 16)
    idx = torch.zeros((3000, 3), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        csr.bin_csr_cuda(idx.long(), 16)
    with pytest.raises(ValueError, match="contiguous"):
        csr.bin_csr_cuda(idx.t(), 16)
    with pytest.raises(ValueError, match="entries need m"):
        csr.bin_csr_cuda(idx, csr.GROUP * csr.MAX_GROUPS)


def test_train_step_launches_each_training_kernel_once(cuda):
    cfg = configs.get_smoke_config("qwen1.5-0.5b", dtype="bfloat16")
    model = steps_lib.init_fn_for(cfg)(0).to(cuda)
    step, opt = steps_lib.make_train_step(cfg, TrainConfig(optimizer="adamw"))
    state = opt.init({n: p.detach() for n, p in model.named_parameters()})
    tokens = torch.randint(0, cfg.vocab, (4, 17), device=cuda)
    for _ in range(3):
        common.reset_launches()
        state, metrics = step(model, state, {"tokens": tokens})
        assert common.LAUNCHES == {"bloom_embed.hash": 1, csr.BIN: 1,
                                   csr.NAME: 1, ce.FWD: 1, ce.BWD: 1}
        assert bool(torch.isfinite(metrics["loss"]))
    assert all(p.dtype == torch.float32 for p in model.parameters())


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
        assert common.LAUNCHES["bloom_embed.hash"] == want
        assert common.LAUNCHES[dt.NAME] == want
        tokens.append({rid: r.tokens for rid, r in res.items()})
    assert tokens[0] == tokens[1]


# ---------------------------------------------------------------------------
# quantized tables (table_dtype): the B5 embed and B3 decode variants
# ---------------------------------------------------------------------------

QUANT_TDS = ("float32", "bfloat16", "int8", "fp8_e4m3")


@pytest.mark.parametrize("T,D,k", [(1, 1024, 4), (14, 1024, 4), (8, 1024, 1),
                                   (8, 1024, 3), (14, 1000, 4), (7, 1020, 4),
                                   (3, 37, 2), (300, 64, 4)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("td", QUANT_TDS)
def test_quantized_embed_kernel_bit_identical_to_plain(cuda, td, out_dtype,
                                                       T, D, k):
    from repro_torch.core import quant
    g = torch.Generator().manual_seed(T * D + k)
    m = 512
    q, s = quant.quantize_table(torch.randn(m, D, generator=g).to(cuda), td)
    idx = torch.randint(0, m, (T, k), generator=g,
                        dtype=torch.int32).to(cuda)
    common.reset_launches()
    got = be.bloom_embed_quantized_cuda(q, s, idx, out_dtype)
    torch.cuda.synchronize()
    assert common.LAUNCHES == {be.variant_name(q.dtype): 1}
    want = be.bloom_embed_quantized_plain(q, s, idx, out_dtype)
    assert got.dtype == out_dtype and torch.equal(got, want)


@pytest.mark.parametrize("td", QUANT_TDS)
def test_quantize_table_on_cuda_equals_the_cpu(cuda, td):
    """The one-time table quantize and the per-step logp quantize run on
    the card: the same stored values and scales as on the CPU, where they
    equal the reference's (tests/test_torch_quant.py)."""
    from repro_torch.core import quant
    g = torch.Generator().manual_seed(7)
    x = torch.randn(300, 257, generator=g) * torch.exp(
        6 * torch.rand(300, 1, generator=g) - 3)
    x[0] = 0.0
    x[1, :4] = torch.tensor([464.0, -464.0001, float("inf"), 500.0])
    cq, cs = quant.quantize_table(x.to(cuda), td)
    q, s = quant.quantize_table(x, td)
    bits = (lambda t: t.view(torch.uint8)) if q.element_size() == 1 else \
        (lambda t: t)
    assert torch.equal(bits(cq.cpu()), bits(q))
    assert (cs is None and s is None) or torch.equal(cs.cpu(), s)


def test_quantized_embed_kernel_takes_an_unaligned_table(cuda):
    from repro_torch.core import quant
    q, s = quant.quantize_table(torch.randn(65, 64, device=cuda), "int8")
    flat = torch.empty(65 * 64 + 1, dtype=torch.int8, device=cuda)
    qu = flat[1:].view(65, 64)
    qu.copy_(q)
    assert qu.is_contiguous() and qu.data_ptr() % 16
    idx = torch.randint(0, 65, (5, 3), dtype=torch.int32, device=cuda)
    assert torch.equal(be.bloom_embed_quantized_cuda(qu, s, idx),
                       be.bloom_embed_quantized_plain(q, s, idx))


def test_quantized_embed_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from repro_torch.core import quant
    q, s = quant.quantize_table(torch.randn(16, 8, device=cuda), "int8")
    idx = torch.zeros((4, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="scales"):
        be.bloom_embed_quantized_cuda(q, None, idx)
    with pytest.raises(TypeError, match="out_dtype"):
        be.bloom_embed_quantized_cuda(q, s, idx, torch.float16)
    with pytest.raises(ValueError, match="one CUDA device"):
        be.bloom_embed_quantized_cuda(q, s.cpu(), idx)
    with pytest.raises(ValueError, match="contiguous"):
        be.bloom_embed_quantized_cuda(q.t().contiguous().t(), s, idx)


def test_quantized_embed_grad_is_straight_through_on_cuda(cuda):
    """The quantized forward (kernel) with the CSR backward (kernel): the
    gradient equals the CPU plain pair's bit for bit."""
    spec = io_lib.vocab_spec(configs.get_smoke_config("qwen1.5-0.5b"))
    g = torch.Generator().manual_seed(1)
    base = torch.randn(spec.m, 16, generator=g)
    tokens = torch.randint(0, spec.d, (2, 9), generator=g)
    cot = torch.randn(2, 9, 16, generator=g)
    grads, outs = [], []
    for dev in (cuda, torch.device("cpu")):
        table = base.to(dev).requires_grad_()
        common.reset_launches()
        out = ops.bloom_embed(table, tokens.to(dev), spec, table_dtype="int8",
                              out_dtype=torch.float32)
        (out * cot.to(dev)).sum().backward()
        grads.append(table.grad.cpu())
        outs.append(out.detach().cpu())
        if dev.type == "cuda":
            assert common.LAUNCHES == {"bloom_embed.int8.hash": 1,
                                       csr.BIN: 1, csr.NAME: 1}
    assert torch.equal(grads[0], grads[1]) and torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("B,m,d,k,topk", [
    (1, 32, 100, 1, 1), (5, 64, 333, 3, 8), (3, 96, 50, 2, 50),
    (6, 8192, 100_003, 2, 10), (4, 256, 70_001, 3, 64),
    (8, 30208, 151_936, 4, 8), (2, 56 * 1024, 5000, 2, 17)])
@pytest.mark.parametrize("live", ["all", "some"])
@pytest.mark.parametrize("td", QUANT_TDS)
def test_quantized_decode_kernel_bit_identical_to_plain(cuda, td, B, m, d,
                                                        k, topk, live):
    """Each storage dtype with the in-kernel hash, against the plain version
    and against the explicit-H kernel on the same logp (so the kernel's
    hashes equal cached_hash_matrix)."""
    from repro_torch.core import hashing, quant
    seed = B + k
    # what cached_hash_matrix holds for an on-the-fly spec (and for m > d,
    # where no BloomSpec exists, what the kernel's hash still computes)
    H = hashing.double_hash(torch.arange(d, device=cuda), k, m, seed)
    g = torch.Generator().manual_seed(d)
    logp = torch.log_softmax(torch.randn(B, m, generator=g), -1).to(cuda)
    q, s = quant.quantize_table(logp, td)
    active = None
    if live == "some":
        active = torch.zeros(B, dtype=torch.bool, device=cuda)
        active[::2] = True
    hs = (d, k, seed)
    common.reset_launches()
    kv, ki = dt.bloom_decode_topk_cuda(q, None, topk, active, s, hs)
    ev, ei = dt.bloom_decode_topk_cuda(q, H, topk, active, s)
    torch.cuda.synchronize()
    assert common.LAUNCHES == {dt.variant_name(q.dtype, True): 1,
                               dt.variant_name(q.dtype, False): 1}
    pv, pi = dt.bloom_decode_topk_plain(q, None, topk, active, s, hs)
    assert torch.equal(ki, pi) and torch.equal(kv, pv)
    assert torch.equal(ki, ei) and torch.equal(kv, ev)


# the row-tile and live-row cases: (B, live rows or None for all)
TILE_CASES = {"B13": (13, None), "one-of-8": (8, [3]), "none-of-8": (8, []),
              "all-but-one-of-8": (8, [0, 1, 2, 3, 4, 6, 7])}


@pytest.mark.parametrize("shape", [(8192, 200_003, 2), (30208, 151_936, 4),
                                   (1024, 2_000_003, 2)])
@pytest.mark.parametrize("topk", [1, 8, 10, 64])
@pytest.mark.parametrize("case", sorted(TILE_CASES))
@pytest.mark.parametrize("td", QUANT_TDS)
def test_decode_row_tiles_and_live_rows(cuda, td, case, topk, shape):
    """More rows than one tile holds (B = 13, a ragged last tile), one live
    row, none, all but one, at topk 1, 8, 10, 64: the in-kernel hash and
    the explicit H, each storage, bit-identical to the plain version, to
    each other and to a second launch.  The last shape's long catalog has
    the plan stage narrow rows as f32."""
    from repro_torch.core import hashing, quant
    m, d, k = shape
    B, live = TILE_CASES[case]
    H = hashing.double_hash(torch.arange(d, device=cuda), k, m, 3)
    g = torch.Generator().manual_seed(B + topk)
    logp = torch.log_softmax(torch.randn(B, m, generator=g), -1).to(cuda)
    q, s = quant.quantize_table(logp, td)
    active = None
    if live is not None:
        active = torch.zeros(B, dtype=torch.bool, device=cuda)
        active[live] = True
    hs = (d, k, 3)
    kv, ki = dt.bloom_decode_topk_cuda(q, None, topk, active, s, hs)
    ev, ei = dt.bloom_decode_topk_cuda(q, H, topk, active, s)
    rv, ri = dt.bloom_decode_topk_cuda(q, None, topk, active, s, hs)
    torch.cuda.synchronize()
    pv, pi = dt.bloom_decode_topk_plain(q, H, topk, active, s)
    assert torch.equal(ki, pi) and torch.equal(kv, pv)
    assert torch.equal(ei, pi) and torch.equal(ev, pv)
    assert torch.equal(ri, ki) and torch.equal(rv, kv)


@pytest.mark.parametrize("live", ["all", "every third"])
def test_decode_more_row_tiles_than_blocks(cuda, live):
    """B = 600: more live rows than one pass of the block over the mask,
    and more row tiles than blocks, so blocks take several tiles."""
    from repro_torch.core import hashing
    B, m, d, k, topk = 600, 64, 3000, 3, 5
    H = hashing.double_hash(torch.arange(d, device=cuda), k, m, 2)
    g = torch.Generator().manual_seed(600)
    logp = torch.log_softmax(torch.randn(B, m, generator=g), -1).to(cuda)
    active = None
    if live != "all":
        active = torch.zeros(B, dtype=torch.bool, device=cuda)
        active[::3] = True
    kv, ki = dt.bloom_decode_topk_cuda(logp, None, topk, active, None,
                                       (d, k, 2))
    ev, ei = dt.bloom_decode_topk_cuda(logp, H, topk, active)
    torch.cuda.synchronize()
    pv, pi = dt.bloom_decode_topk_plain(logp, H, topk, active)
    assert torch.equal(ki, pi) and torch.equal(kv, pv)
    assert torch.equal(ei, pi) and torch.equal(ev, pv)


@pytest.mark.parametrize("topk", [1, 8, 10, 64])
@pytest.mark.parametrize("td", QUANT_TDS)
def test_decode_full_tie_returns_lowest_ids_per_storage(cuda, td, topk):
    from repro_torch.core import hashing, quant
    m, d, k = 8192, 200_003, 2
    logp = torch.full((13, m), -math.log(m), device=cuda)
    q, s = quant.quantize_table(logp, td)
    H = hashing.double_hash(torch.arange(d, device=cuda), k, m, 1)
    want = torch.arange(topk, dtype=torch.int32).expand(13, topk)
    for h, hs in ((None, (d, k, 1)), (H, None)):
        _, ids = dt.bloom_decode_topk_cuda(q, h, topk, None, s, hs)
        assert torch.equal(ids.cpu(), want)


def test_quantized_decode_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from repro_torch.core import quant
    logp = torch.log_softmax(torch.randn(2, 64, device=cuda), -1)
    q, s = quant.quantize_table(logp, "int8")
    with pytest.raises(ValueError, match="in-kernel hash"):
        dt.bloom_decode_topk_cuda(q, None, 5, None, s, (1000, 33, 0))
    with pytest.raises(ValueError, match="scales"):
        dt.bloom_decode_topk_cuda(q, None, 5, None, None, (1000, 2, 0))
    with pytest.raises(ValueError, match="one CUDA device"):
        dt.bloom_decode_topk_cuda(q, None, 5, None, s.cpu(), (1000, 2, 0))
    with pytest.raises(ValueError, match="contiguous"):
        dt.bloom_decode_topk_cuda(q.t().contiguous().t(), None, 5, None, s,
                                  (1000, 2, 0))


@pytest.mark.parametrize("td", QUANT_TDS)
def test_quantized_drill_launches_the_hash_variant_every_step(cuda, td):
    from repro_torch.core import quant
    common.reset_launches()
    report = retrieval._drill(get_retrieval_config("smoke", table_dtype=td),
                              8, 4, 0, cuda)
    name = dt.variant_name(quant.storage_dtype(td), True)
    assert common.LAUNCHES == {name: 2 * report["decode_steps"]}


@pytest.mark.parametrize("td", QUANT_TDS)
def test_quantized_lm_engine_launches_both_variants_every_step(cuda, td):
    from repro_torch.core import quant
    cfg = configs.get_smoke_config("qwen1.5-0.5b", dtype="bfloat16",
                                   table_dtype=td)
    model = serve.build_model(cfg, 0, cuda)
    engine = Engine(cfg, model, n_slots=3, max_len=40, topk=4)
    wl = mixed_length_workload(cfg.vocab, 10, seed=0)
    tokens = []
    sd = quant.storage_dtype(td)
    for run in (engine.run, engine.run_static):
        common.reset_launches()
        res, st = run([r.fresh_copy() for r in wl])
        want = st.prefills + st.decode_steps
        assert common.LAUNCHES == {be.variant_name(sd) + ".hash": want,
                                   dt.variant_name(sd, True): want}
        tokens.append({rid: r.tokens for rid, r in res.items()})
    assert tokens[0] == tokens[1]


def test_quantized_train_step_launches_the_embed_variant(cuda):
    cfg = configs.get_smoke_config("qwen1.5-0.5b", dtype="bfloat16",
                                   table_dtype="int8")
    model = steps_lib.init_fn_for(cfg)(0).to(cuda)
    step, opt = steps_lib.make_train_step(cfg, TrainConfig(optimizer="adamw"))
    state = opt.init({n: p.detach() for n, p in model.named_parameters()})
    tokens = torch.randint(0, cfg.vocab, (4, 17), device=cuda)
    for _ in range(2):
        common.reset_launches()
        state, metrics = step(model, state, {"tokens": tokens})
        assert common.LAUNCHES == {"bloom_embed.int8.hash": 1, csr.BIN: 1,
                                   csr.NAME: 1, ce.FWD: 1, ce.BWD: 1}
        assert bool(torch.isfinite(metrics["loss"]))


def _equal_nan(a, b):
    """Equal values, and NaN in the same places."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


@pytest.mark.parametrize("B,m,d,k", [
    (1, 30208, 151936, 4), (8, 30208, 151936, 4), (3, 1001, 5003, 3),
    (2, 56 * 1024, 1000, 2), (5, 64, 333, 1)])
@pytest.mark.parametrize("td", [None, *QUANT_TDS])
def test_decode_kernel_bit_identical_to_plain(cuda, td, B, m, d, k):
    from repro_torch.core import quant
    logp, H = _inputs(B, m, d, k, cuda, seed=B + d)
    logp[0, :3] = -500.0               # past fp8's range: NaN, as in JAX
    H[0, 0] = 1                        # id 0 reads one of them
    q, s = (logp, None) if td is None else quant.quantize_table(logp, td)
    common.reset_launches()
    got = bd.bloom_decode_cuda(q, H, s)
    torch.cuda.synchronize()
    assert common.LAUNCHES == {bd.variant_name(q.dtype): 1}
    want = bd.bloom_decode_plain(q, H, s)
    assert got.shape == (B, d) and _equal_nan(got, want)
    assert torch.isnan(got).any() == (td == "fp8_e4m3")


def test_decode_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    logp, H = _inputs(2, 64, 100, 2, cuda)
    with pytest.raises(TypeError):
        bd.bloom_decode_cuda(logp.double(), H)
    with pytest.raises(TypeError):
        bd.bloom_decode_cuda(logp, H.long())
    with pytest.raises(ValueError, match="contiguous"):
        bd.bloom_decode_cuda(logp.t().contiguous().t(), H)
    with pytest.raises(ValueError, match="shared-memory"):
        big, _ = _inputs(1, bd.MAX_M + 1, 10, 2, cuda)
        bd.bloom_decode_cuda(big, H)
    with pytest.raises(ValueError, match="scales"):
        bd.bloom_decode_cuda(logp.to(torch.int8), H)
    with pytest.raises(ValueError, match="one device"):
        bd.bloom_decode_fwd(logp, H.cpu())
    with pytest.raises(TypeError):
        bd.bloom_decode_bwd_cuda(logp.double(), H[:64], 64)
    with pytest.raises(ValueError, match="pack_h"):
        bd.bloom_decode_cuda(logp, H, packed=H)
    assert torch.equal(bd.bloom_decode_cuda(logp, H, packed=bd.pack_h(H)),
                       bd.bloom_decode_cuda(logp, H))


@pytest.mark.parametrize("B,d,m,k,pads", [
    (8, 151936, 30208, 4, False), (3, 1000, 77, 3, True),
    (11, 5000, 300, 2, False), (1, 20000, 600, 1, True),
    (9, 30000, 70000, 4, True), (8, 3000, 7, 4, False)])
def test_dense_decode_backward_bit_identical(cuda, B, d, m, k, pads):
    g = torch.Generator().manual_seed(d)
    cot = torch.randn(B, d, generator=g)
    H = torch.randint(0, m, (d, k), generator=g, dtype=torch.int32)
    if pads:
        H[::5, -1] = -1
    common.reset_launches()
    got = bd.bloom_decode_bwd_cuda(cot.to(cuda), H.to(cuda), m)
    again = bd.bloom_decode_bwd_cuda(cot.to(cuda), H.to(cuda), m)
    torch.cuda.synchronize()
    assert common.LAUNCHES == {bd.BWD: 2, csr.BIN: 2}
    assert torch.equal(got, again)
    assert torch.equal(got.cpu(), bd.bloom_decode_bwd_plain(cot, H, m))
    via_csr = csr.bloom_decode_bwd_csr(cot.to(cuda), H.to(cuda), m)
    assert common.LAUNCHES[csr.DECODE] == 1
    assert torch.equal(got, via_csr)


@pytest.mark.parametrize("B", [1, 8, 9])
def test_dense_decode_backward_equals_csr_on_the_spec_hash_matrix(cuda, B):
    """Exact on the full-width spec's H, whose rows repeat an index in 33
    places: both backwards add in the CSR bins' order."""
    spec = io_lib.vocab_spec(configs.get_config("qwen1.5-0.5b"))
    H = cached_hash_matrix(spec, cuda)
    cot = torch.randn(B, spec.d, generator=torch.Generator().manual_seed(B))
    dense = bd.bloom_decode_bwd_cuda(cot.to(cuda), H, spec.m)
    via_csr = csr.bloom_decode_bwd_csr(cot.to(cuda), H, spec.m,
                                       bloom.cached_decode_bins(spec, cuda))
    torch.cuda.synchronize()
    assert torch.equal(dense, via_csr)
    assert torch.equal(dense.cpu(), bd.bloom_decode_bwd_plain(
        cot, H.cpu(), spec.m))


@pytest.mark.parametrize("T,k,D,m,rows", [
    (520, 4, 1024, 30208, None), (14, 4, 1000, 512, None),
    (9, 3, 37, 64, None), (300, 4, 2500, 4096, [0, 5, 5, 9]),
    (40, 2, 1020, 128, [7]), (3000, 4, 64, 40, None)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_embed_backward_bit_identical(cuda, T, k, D, m, rows, dtype):
    g = torch.Generator().manual_seed(T + D)
    cot = torch.randn(T, D, generator=g).to(dtype)
    if rows is None:
        idx = torch.randint(0, m, (T, k), generator=g, dtype=torch.int32)
    else:
        pick = torch.randint(0, len(rows), (T, k), generator=g)
        idx = torch.tensor(rows, dtype=torch.int32)[pick]
    common.reset_launches()
    got = be.bloom_embed_bwd_cuda(cot.to(cuda), idx.to(cuda), m)
    again = be.bloom_embed_bwd_cuda(cot.to(cuda), idx.to(cuda), m)
    torch.cuda.synchronize()
    assert common.LAUNCHES == {be.BWD: 2}
    assert got.dtype == torch.float32 and torch.equal(got, again)
    assert torch.equal(got.cpu(), be.bloom_embed_bwd_plain(cot, idx, m))
    assert torch.equal(got, csr.csr_scatter_add(cot.to(cuda), idx.to(cuda),
                                                m))
    padded = idx.clone()
    padded[::3, 0] = -1
    assert torch.equal(
        be.bloom_embed_bwd_cuda(cot.to(cuda), padded.to(cuda), m).cpu(),
        be.bloom_embed_bwd_plain(cot, padded, m))


def test_dense_embed_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    cot = torch.randn(4, 8, device=cuda)
    idx = torch.zeros((4, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        be.bloom_embed_bwd_cuda(cot.double(), idx, 16)
    with pytest.raises(ValueError, match="contiguous"):
        be.bloom_embed_bwd_cuda(cot.t().contiguous().t(), idx, 16)
    with pytest.raises(ValueError, match="one device"):
        be.bloom_embed_bwd(cot, idx.cpu(), 16)


@pytest.mark.parametrize("td", [None, "int8"])
@pytest.mark.parametrize("bwd_impl", ["csr", "dense"])
def test_ops_decode_and_its_gradient_equal_the_cpu_path(cuda, bwd_impl, td):
    spec = io_lib.vocab_spec(configs.get_smoke_config("qwen1.5-0.5b"))
    g = torch.Generator().manual_seed(1)
    base = torch.log_softmax(torch.randn(2, 3, spec.m, generator=g), -1)
    cot = torch.randn(2, 3, spec.d, generator=g)
    bloom.cached_decode_bins(spec, cuda)    # built once, ahead of the count
    out = []
    for dev in (cuda, torch.device("cpu")):
        logp = base.to(dev).requires_grad_()
        common.reset_launches()
        scores = ops.bloom_decode(logp, spec, bwd_impl=bwd_impl,
                                  table_dtype=td)
        (scores * cot.to(dev)).sum().backward()
        out.append((scores.detach().cpu(), logp.grad.cpu()))
        if dev.type == "cuda":
            name = bd.variant_name(torch.int8 if td else torch.float32)
            assert common.LAUNCHES == ({name: 1, csr.DECODE: 1}
                                       if bwd_impl == "csr" else
                                       {name: 1, csr.BIN: 1, bd.BWD: 1})
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])


def test_dense_train_step_launches_the_dense_embed_backward(cuda):
    cfg = configs.get_smoke_config("qwen1.5-0.5b", dtype="bfloat16",
                                   bwd_impl="dense")
    model = steps_lib.init_fn_for(cfg)(0).to(cuda)
    step, opt = steps_lib.make_train_step(cfg, TrainConfig(optimizer="adamw"))
    state = opt.init({n: p.detach() for n, p in model.named_parameters()})
    tokens = torch.randint(0, cfg.vocab, (4, 17), device=cuda)
    for _ in range(2):
        common.reset_launches()
        state, metrics = step(model, state, {"tokens": tokens})
        assert common.LAUNCHES == {"bloom_embed.hash": 1, be.BWD: 1,
                                   ce.FWD: 1, ce.BWD: 1}
        assert bool(torch.isfinite(metrics["loss"]))


# ---------------------------------------------------------------------------
# the embed kernel's token entry; the Eq. 3 decode forward's row tiles
# ---------------------------------------------------------------------------

def _token_specs():
    import dataclasses
    lm = io_lib.vocab_spec(configs.get_config("qwen1.5-0.5b"))
    specs = {f"{'hash' if fly else 'H'} k={k}": dataclasses.replace(
        lm, k=k, on_the_fly=fly) for k in (1, 2, 3, 4, 8)
        for fly in (True, False)}
    specs["identity"] = bloom.identity_spec(lm.m)
    return specs


@pytest.mark.parametrize("T,D", [(1, 1024), (8, 1024), (14, 1024),
                                 (520, 1024), (4096, 1024), (14, 1000),
                                 (14, 1020)])
@pytest.mark.parametrize("td", [None, *QUANT_TDS])
def test_token_entry_bit_identical_to_plain(cuda, td, T, D):
    """Every spec kind at k = 1, 2, 3, 4, 8, every storage into f32 and
    bf16, int32 and int64 token ids with 0, d - 1 and -1 among them: the
    output bit-identical to the plain version and the indices written
    beside it equal to spec.indices_for."""
    from repro_torch.core import quant
    g = torch.Generator().manual_seed(T * D)
    m = 30208
    base = torch.randn(m, D, generator=g).to(cuda)
    if td is None:
        tables = [(base.to(dt_), None, dt_) for dt_ in be.DTYPES]
    else:
        q, s = quant.quantize_table(base, td)
        tables = [(q, s, od) for od in be.DTYPES]
    for n, (name, spec) in enumerate(sorted(_token_specs().items())):
        tok = torch.randint(0, spec.d, (T,), generator=g)
        tok[:3] = torch.tensor([0, spec.d - 1, -1])[:T]
        tok = tok.to(cuda).to(torch.int64 if n % 2 else torch.int32)
        for q, s, od in tables:
            common.reset_launches()
            if td is None:
                got, idx = be.bloom_embed_tokens_cuda(q, tok, spec, True)
            else:
                got, idx = be.bloom_embed_tokens_quantized_cuda(
                    q, s, tok, spec, od, True)
            torch.cuda.synchronize()
            assert common.LAUNCHES == {be.token_variant_name(
                spec, None if td is None else q.dtype): 1}
            want, widx = be.bloom_embed_tokens_plain(q, s, tok, spec, od)
            assert got.dtype == od and torch.equal(got, want), name
            assert torch.equal(idx, widx), name


def test_ops_embed_is_one_launch_without_a_host_sync(cuda):
    from torch.profiler import ProfilerActivity, profile
    spec = io_lib.vocab_spec(configs.get_config("qwen1.5-0.5b"))
    table = torch.randn(spec.m, 1024, device=cuda).to(torch.bfloat16)
    tokens = torch.randint(0, spec.d, (8, 1), device=cuda)
    ops.bloom_embed(table, tokens, spec)
    torch.cuda.synchronize()
    common.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = ops.bloom_embed(table, tokens, spec)
            torch.cuda.synchronize()
        ops.bloom_ce(torch.randn(16, spec.m, device=cuda),
                     torch.randint(0, spec.d, (16,), device=cuda), spec)
        bloom.encode(spec, torch.randint(-1, spec.d, (4, 8), device=cuda))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert common.LAUNCHES == {"bloom_embed.hash": 1, ce.FWD: 1}
    kernels = [e.key for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "embed_fwd" in kernels[0], kernels
    assert torch.equal(out.cpu(), ops.bloom_embed(table.cpu(), tokens.cpu(),
                                                  spec))


def test_ops_embed_takes_a_strided_token_column(cuda):
    spec = io_lib.vocab_spec(configs.get_smoke_config("qwen1.5-0.5b"))
    table = torch.randn(spec.m, 64, device=cuda)
    tokens = torch.randint(0, spec.d, (4, 6), device=cuda)
    column = tokens[:, -1:]                      # (4, 1), not contiguous
    assert not column.reshape(-1).is_contiguous()
    out = ops.bloom_embed(table, column, spec)
    assert torch.equal(out.cpu(), ops.bloom_embed(table.cpu(), column.cpu(),
                                                  spec))


def test_token_entry_counts_only_what_it_launches(cuda):
    spec = io_lib.vocab_spec(configs.get_smoke_config("qwen1.5-0.5b"))
    table = torch.randn(spec.m, 64, device=cuda)
    common.reset_launches()
    out, _ = be.bloom_embed_tokens_cuda(
        table, torch.zeros(0, dtype=torch.int64, device=cuda), spec)
    assert out.shape == (0, 64) and not common.LAUNCHES
    be.bloom_embed_tokens_cuda(table[:, :0].contiguous(),
                               torch.zeros(3, dtype=torch.int64,
                                           device=cuda), spec)
    assert not common.LAUNCHES
    be.bloom_embed_tokens_cuda(table, torch.zeros(3, dtype=torch.int64,
                                                  device=cuda), spec)
    assert common.LAUNCHES == {be.token_variant_name(spec): 1}


def test_token_entry_rejects_what_the_kernel_does_not_take(cuda):
    spec = io_lib.vocab_spec(configs.get_smoke_config("qwen1.5-0.5b"))
    table = torch.randn(spec.m, 8, device=cuda)
    tok = torch.zeros(4, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError):
        be.bloom_embed_tokens_cuda(table, tok.to(torch.int16), spec)
    with pytest.raises(TypeError):
        be.bloom_embed_tokens_cuda(table, tok[:, None], spec)
    with pytest.raises(ValueError, match="rows"):
        be.bloom_embed_tokens_cuda(table[1:], tok, spec)
    with pytest.raises(ValueError, match="contiguous"):
        be.bloom_embed_tokens_cuda(table, torch.zeros(8, dtype=torch.int64,
                                                      device=cuda)[::2],
                                   spec)


@pytest.mark.parametrize("B", [1, 3, 8, 13])
@pytest.mark.parametrize("k", [1, 3, 4, 8])
@pytest.mark.parametrize("td", [None, *QUANT_TDS])
def test_decode_row_tiles_bit_identical_to_plain(cuda, td, k, B):
    """Row tiles of 4 / itemsize rows, ragged when B is not a multiple,
    the largest tile (m = MAX_M), k = 3's 12-byte H rows and a d that is
    not a multiple of 4."""
    from repro_torch.core import quant
    logp, H = _inputs(B, bd.MAX_M, 10_007, k, cuda, seed=B * k)
    q, s = (logp, None) if td is None else quant.quantize_table(logp, td)
    got = bd.bloom_decode_cuda(q, H, s)
    torch.cuda.synchronize()
    assert _equal_nan(got, bd.bloom_decode_plain(q, H, s))


@pytest.mark.parametrize("td", [None, *QUANT_TDS])
def test_decode_takes_unaligned_rows_and_h(cuda, td):
    from repro_torch.core import quant
    g = torch.Generator().manual_seed(5)
    m, d, k = 1001, 5003, 4
    flat = torch.randn(3 * m + 1, generator=g).to(cuda)
    logp = torch.log_softmax(flat[1:].view(3, m), -1)
    lp = torch.empty(3 * m + 1, device=cuda)[1:].view(3, m)
    lp.copy_(logp)
    hflat = torch.randint(0, m, (d * k + 1,), generator=g,
                          dtype=torch.int32).to(cuda)
    H = hflat[1:].view(d, k)
    assert lp.data_ptr() % 16 and H.data_ptr() % 16
    q, s = (lp, None) if td is None else quant.quantize_table(lp, td)
    assert _equal_nan(bd.bloom_decode_cuda(q, H, s),
                      bd.bloom_decode_plain(q, H, s))
