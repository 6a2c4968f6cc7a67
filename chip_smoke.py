#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, one line of numbers each:
  1. build    — compile every kernel in src/repro_torch/kernels/csrc/, one
                nvcc per source, all started together;
  2. kernels  — each kernel against its plain PyTorch version on the same
                tensors on the card, at the main paths' shapes and at edge
                cases, bit-identical (same f32 sum order):
                bloom_decode_topk at web10m (B = 8, m = 8192, d = 10M,
                k = 2, topk = 10) and at the LM shapes (B = 1 and 8,
                m = 30,208, d = 151,936, k = 4, topk = 8); bloom_embed in
                f32 and bf16 at T = 1, 8, 14, 4096, D = 1024, k = 4,
                m = 30,208, at a ragged D and at k = 1 and 3; then each
                kernel's time, the plain version's, one library call
                computing the same function, and the least time the card
                could take (bytes over 3.35 TB/s, or f32 adds over
                67 TFLOP/s);
  3. serve    — the web10m retrieval drill (8 requests, 8 slots, two
                replays) through RetrievalEngine on CUDA, with the launch
                counts reset just before and read just after; every decode
                step must have launched the kernel, and the served top-k
                must equal the plain version's on the same tower outputs;
  4. eval     — the untrained smoke-scale ranking eval on CUDA (RR and
                MAP below 0.1);
  5. serve-lm — qwen1.5-0.5b at full width (24 layers, d_model 1024, vocab
                151,936, Bloom m = 30,208, k = 4, bf16, random weights from
                seed 0) through Engine: 8 slots, 16 mixed-length requests,
                continuous twice and static once, counts reset just before
                each run and read just after it; every prefill and decode
                step must launch bloom_embed once and bloom_decode_topk
                once, replays and static must serve the same tokens, and a
                served first token must equal the plain versions' on the
                same prompt;
  6. kernels-train — bloom_ce forward and backward against their plain
                versions at (T = 512, m = 30,208, k = 4), at T = 4,088 and
                with rows whose hashes repeat a column (loss rtol 1e-6 /
                atol 1e-5, dz atol 1e-7: expf and the exp-sum order differ
                from torch's in the last ulp), the card's CSR bins
                (bloom_csr.bin) equal to bin_csr_plain's and the CSR
                scatter-add bit-identical to its plain version on a CPU copy
                and to a second launch at (T = 520, k = 4, D = 1024,
                m = 30,208, bf16), on index sets with every entry in a few
                rows, with -1 pads, at D = 8 and at an unaligned D; then
                each one's device time, back-to-back time, plain and
                library times and bound, and the binning's and the CSR
                backward's as called (binning plus kernel), with the
                latter's device time by kernel from a torch.profiler trace;
  7. train-lm — qwen1.5-0.5b at full width (24 layers, d_model 1024, m =
                30,208, k = 4, bf16 compute, f32 master, random weights
                from seed 0, batch 8, seq 64) trained 8 steps through
                launch/train.run, counts reset just before and read just
                after: every step must launch bloom_embed, the binning,
                bloom_csr and the bloom_ce forward and backward once each,
                every loss be
                finite and step 8's below step 1's; then a resume drill (4
                steps with a checkpoint, then a fresh run that restores it
                and trains to 8) whose losses 5-8 equal the straight run's
                within rtol 1e-6;
  8. kernels-quant — the quantized variants (table_dtype) against their
                plain versions on the same tensors on the card,
                bit-identical: bloom_embed over f32, bf16, int8 (+ per-row
                scales) and fp8 storage into bf16 and f32 outputs at T = 1,
                8, 14, 4096, D = 1024, k = 4, m = 30,208, at a ragged D and
                at k = 1 and 3; bloom_decode_topk over f32, bf16, int8 and
                fp8 logp with the in-kernel hash at web10m (all rows, and
                rows 0, 3, 7) and at the LM shapes (B = 1 and 8), and int8
                with the explicit H; the in-kernel-hash result must equal
                the explicit-H result on the same logp (the hashes equal
                cached_hash_matrix).  Then each variant's device and
                back-to-back time, its plain version's, a one-call library
                yardstick, and the bound (bytes over 3.35 TB/s, or the
                hash's integer operations once per id over the int32 rate);
  9. serve-quant — the web10m drill through RetrievalEngine with
                table_dtype int8 (and once each with fp8_e4m3, bfloat16,
                float32), and qwen1.5-0.5b at full width, bf16, 8 slots, 16
                mixed-length requests, continuous, with table_dtype int8,
                fp8_e4m3, bfloat16 and float32, and int8 with the
                precomputed hash matrix (bloom on_the_fly off); counts
                reset just before each run and read just after it: every
                decode step (and LM prefill) must launch that dtype's
                embed and decode variants once each, the served ids and a
                served first token must equal the plain versions' on the
                same inputs; then the median decode step time of the int8
                path beside the auto path's.
 10. kernels-decode — the full Eq. 3 decode (bloom_decode) over f32, bf16,
                int8 and fp8 e4m3 logp at the LM vocabulary (B = 1 and 8,
                d = 151,936, m = 30,208, k = 4) and at an edge shape (B = 3,
                m = 1,001, d = 5,003, k = 3, with values past fp8's range),
                bit-identical to its plain version (NaN in the same places;
                int8 as (sum q) * s); the card's bins of the spec's H (per
                call and cached) equal to bin_csr_plain's; the dense decode
                backward (H binned per call, then the CSR kernel)
                bit-identical to its plain version on a CPU copy, to the CSR
                decode caller on the spec's H and on an H without repeated
                indices, and to a second launch; the dense embedding
                backward at
                (T = 520, k = 4, D = 1024, m = 30,208) and edge cases
                bit-identical to its plain version on a CPU copy, to the CSR
                kernel and to a second launch; then the times, plain and
                library times (device and back to back) and bounds, and
                the dense decode backward's device time by kernel
                (torch.profiler);
 11. decode-grad — ops.bloom_decode on the last-position log_softmax of
                full-width qwen1.5-0.5b (seed 0, 8 prompts of 16 tokens), in
                f32 and with each table_dtype, differentiated under bwd_impl
                csr and dense with a seeded cotangent: counts reset before
                and read after each run (one forward and one backward
                launch, and under dense one binning), scores equal to the
                plain version's, the csr and dense gradients bit-identical,
                the quantized gradients straight-through;
 12. train-lm-dense — 8 full-width training steps through launch/train.run
                with bwd_impl="dense", twice, in turns with a CSR run: every
                step launches bloom_embed_bwd (and never bloom_csr), losses
                finite and falling, the first loss equal to the CSR run's,
                the first step's embedding gradient bit-identical to the CSR
                backward's off the rows of tokens that repeat a row (within
                1e-6 there), and the median step walls side by side.
Then the card's name and power limit, one JSON line of kernel numbers, and
last ``{"ok": true, "device": {...}}``.  Any failure raises: the exit code
is not 0 and the last line is not printed.  Without a CUDA device, or
without the repository's src/ beside this file, it exits non-zero at once.
"""
from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate and f32 outside the tensor
# cores; the bound of a kernel is the larger of bytes/rate and ops/peak
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# int32 operations outside the tensor cores: 132 SMs x 64 INT32 lanes per
# SM per clock (4 sub-partitions of 16) x 1.98 GHz, the H100 SXM's maximum
# boost clock (NVIDIA's Hopper white paper and data sheet)
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _max_abs_err(a, b) -> float:
    import torch
    both = torch.isfinite(a) & torch.isfinite(b)
    _check(torch.equal(torch.isfinite(a), torch.isfinite(b)),
           "kernel and plain version disagree on which values are finite")
    return float((a[both] - b[both]).abs().max()) if both.any() else 0.0


def phase_kernels(torch, dt, common, bloom, get_retrieval_config):
    """Kernel vs plain version on the card; returns the kernel's JSON row."""
    rcfg = get_retrieval_config("web10m")
    dev = torch.device("cuda")
    B, m, topk = 8, rcfg.m, rcfg.topk
    gen = torch.Generator().manual_seed(0)
    logp = torch.log_softmax(torch.randn(B, m, generator=gen), -1).to(dev)
    H = bloom.cached_hash_matrix(rcfg.spec(), dev)
    d, k = H.shape
    partial = torch.zeros(B, dtype=torch.bool, device=dev)
    partial[[0, 3, 7]] = True
    const = torch.full((B, m), -math.log(m), device=dev)
    ragged = H[:1_000_003].contiguous()
    cases = [("web10m all rows", logp, H, topk, None),
             ("web10m rows 0,3,7", logp, H, topk, partial),
             ("web10m constant logp", const, H, topk, None)]
    cases += [(f"ragged d=1000003 topk={t}", logp, ragged, t, partial)
              for t in (1, 10, 64)]
    err = 0.0
    for label, lp, h, t, act in cases:
        kv, ki = dt.bloom_decode_topk_cuda(lp, h, t, act)
        torch.cuda.synchronize()
        pv, pi = dt.bloom_decode_topk_plain(lp, h, t, act)
        _check(torch.equal(ki, pi), f"{label}: kernel ids != plain ids")
        _check(torch.equal(kv, pv), f"{label}: kernel values != plain values")
        err = max(err, _max_abs_err(kv, pv))
        print(f"kernels: {label}: bit-identical ({t} of {h.shape[0]})",
              flush=True)
    _check(torch.equal(dt.bloom_decode_topk_cuda(const, H, topk)[1].cpu(),
                       torch.arange(topk, dtype=torch.int32).expand(B, topk)),
           "a full tie must return ids 0..topk-1")

    time_ms = common.time_ms
    ms = time_ms(lambda: dt.bloom_decode_topk_cuda(logp, H, topk), 50, 5)
    ms_partial = time_ms(
        lambda: dt.bloom_decode_topk_cuda(logp, H, topk, partial), 50, 5)
    plain_ms = time_ms(lambda: dt.bloom_decode_topk_plain(logp, H, topk), 3)
    Hl = H.long()
    library = lambda: torch.topk(logp[:, Hl].sum(-1), topk)  # noqa: E731
    library_ms = time_ms(library, 3)
    library_dev_ms = common.graph_time_ms(library, 3, 2)
    nbytes = dt.min_bytes(B, B, m=m, d=d, k=k, topk=topk)
    ops = d * B * (k - 1)
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = ops / F32_OPS_PER_S * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    bound_partial_ms, _ = _bound(dt.min_bytes(3, B, m=m, d=d, k=k,
                                              topk=topk), d * 3 * (k - 1))
    print(f"kernels: bloom_decode_topk web10m B={B} m={m} d={d} k={k} "
          f"topk={topk}: kernel {ms:.6f} ms, rows 0,3,7 {ms_partial:.6f} ms "
          f"(bound {bound_partial_ms * 1e3:.3f} us), "
          f"plain {plain_ms:.6f} ms, torch.topk {library_dev_ms:.6f} ms on "
          f"the device / {library_ms:.6f} ms back to back, bound "
          f"{bound_ms * 1e3:.3f} us ({nbytes} bytes), max_abs_err {err}",
          flush=True)
    return {"name": dt.NAME, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/bloom_decode_topk.cu",
            "replaces": "src/repro/kernels/bloom_decode_topk.py:249",
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": ("bytes" if bound_bytes_ms >= bound_ops_ms
                         else "operations"),
            "library_ms": library_dev_ms}


def _bound(nbytes: int, ops: int):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and f32
    operations over the f32 peak."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = ops / F32_OPS_PER_S * 1e3
    return max(b_ms, o_ms), ("bytes" if b_ms >= o_ms else "operations")


def lm_decode_topk(torch, dt, common, bloom):
    """bloom_decode_topk at the LM serving shapes: B = 1 (a prefill's
    first token) and B = 8 (a decode step of 8 slots)."""
    from repro_torch import configs
    from repro_torch.models import io as io_lib
    cfg = configs.get_config("qwen1.5-0.5b")
    spec = io_lib.vocab_spec(cfg)
    dev = torch.device("cuda")
    H = bloom.cached_hash_matrix(spec, dev)
    (d, k), m, topk = H.shape, spec.m, 8
    gen = torch.Generator().manual_seed(1)
    logp8 = torch.log_softmax(torch.randn(8, m, generator=gen), -1).to(dev)
    partial = torch.zeros(8, dtype=torch.bool, device=dev)
    partial[[0, 3, 7]] = True
    Hl = H.long()
    for label, lp, act in (("B=1", logp8[:1].contiguous(), None),
                           ("B=8 all rows", logp8, None),
                           ("B=8 rows 0,3,7", logp8, partial)):
        kv, ki = dt.bloom_decode_topk_cuda(lp, H, topk, act)
        torch.cuda.synchronize()
        pv, pi = dt.bloom_decode_topk_plain(lp, H, topk, act)
        _check(torch.equal(ki, pi) and torch.equal(kv, pv),
               f"LM {label}: kernel != plain version")
        B = lp.shape[0]
        n_live = B if act is None else int(act.sum())
        ms = common.time_ms(
            lambda: dt.bloom_decode_topk_cuda(lp, H, topk, act), 100, 5)
        dev_ms = common.graph_time_ms(
            lambda: dt.bloom_decode_topk_cuda(lp, H, topk, act))
        plain_ms = common.time_ms(
            lambda: dt.bloom_decode_topk_plain(lp, H, topk, act), 5)
        lib = lambda: torch.topk(lp[:, Hl].sum(-1), topk)  # noqa: E731
        lib_ms = common.time_ms(lib, 20)
        lib_dev_ms = common.graph_time_ms(lib, 10, 3)
        nbytes = dt.min_bytes(n_live, B, m=m, d=d, k=k, topk=topk)
        bound_ms, by = _bound(nbytes, d * n_live * (k - 1))
        print(f"kernels: bloom_decode_topk LM {label} m={m} d={d} k={k} "
              f"topk={topk}: bit-identical, kernel {ms:.6f} ms back to "
              f"back (events), {dev_ms:.6f} ms on the device (graph), plain "
              f"{plain_ms:.6f} ms, torch.topk {lib_dev_ms:.6f} ms on the "
              f"device / {lib_ms:.6f} ms back to back, bound "
              f"{bound_ms * 1e3:.3f} us ({by}, {nbytes} bytes)", flush=True)


def phase_embed(torch, be, common):
    """bloom_embed against its plain version; returns its JSON row, timed
    at T = 8 (one decode step of 8 slots) in bf16, on the device alone
    (CUDA graph replays: one call is shorter than the host's launch
    cost)."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    m, D, k = 30208, 1024, 4
    gen = torch.Generator().manual_seed(2)
    base = torch.randn(m, D, generator=gen)
    err = 0.0
    cases = [(T, D, k) for T in (1, 8, 14, 4096)]
    cases += [(14, 1000, 4), (14, 1020, 4), (8, 1024, 1), (8, 1024, 3)]
    for dtype in (torch.float32, torch.bfloat16):
        for T, Dc, kc in cases:
            table = base[:, :Dc].to(dtype).contiguous().to(dev)
            idx = torch.randint(0, m, (T, kc), generator=gen,
                                dtype=torch.int32).to(dev)
            got = be.bloom_embed_cuda(table, idx)
            torch.cuda.synchronize()
            want = be.bloom_embed_plain(table, idx)
            _check(got.dtype == dtype and torch.equal(got, want),
                   f"bloom_embed {dtype} T={T} D={Dc} k={kc}: kernel != "
                   "plain version")
            err = max(err, _max_abs_err(got.float(), want.float()))
        print(f"kernels: bloom_embed {dtype}: bit-identical on "
              f"{len(cases)} cases (T, D, k) = {cases}", flush=True)

    table = base.to(torch.bfloat16).to(dev)
    row = None
    for T in (8, 14):
        idx = torch.randint(0, m, (T, k), generator=gen,
                            dtype=torch.int32).to(dev)
        idx64 = idx.long()
        fns = {"kernel": lambda: be.bloom_embed_cuda(table, idx),
               "plain": lambda: be.bloom_embed_plain(table, idx),
               "embedding_bag": lambda: F.embedding_bag(idx64, table,
                                                        mode="sum")}
        # back to back with CUDA events, the host's launch cost included;
        # and on the device alone, from CUDA graph replays
        host = {n: common.time_ms(f, 200, 5) for n, f in fns.items()}
        device = {n: common.graph_time_ms(f) for n, f in fns.items()}
        n_rows = int(torch.unique(idx).numel())
        nbytes = be.min_bytes(n_rows, T, k, D, 2)
        bound_ms, by = _bound(nbytes, T * (k - 1) * D)
        print(f"kernels: bloom_embed bf16 T={T} m={m} D={D} k={k}: "
              "device ms (graph) / back-to-back ms (events): "
              + ", ".join(f"{n} {device[n]:.6f} / {host[n]:.6f}"
                          for n in fns)
              + f", bound {bound_ms * 1e3:.3f} us ({by}, {nbytes} bytes)",
              flush=True)
        if row is None:
            row = {"name": be.NAME, "route": "cuda",
                   "source": "src/repro_torch/kernels/csrc/bloom_embed.cu",
                   "replaces": "src/repro/kernels/bloom_embed.py:294",
                   "launches": None, "max_abs_err": err,
                   "ms": device["kernel"], "plain_ms": device["plain"],
                   "bound_ms": bound_ms, "bound_by": by,
                   "library_ms": device["embedding_bag"]}
    return row


def phase_serve_lm(torch, be, dt, common):
    """qwen1.5-0.5b at full width through Engine on CUDA; returns the
    launches of each kernel summed over the three runs."""
    from repro_torch import configs
    from repro_torch.core import bloom
    from repro_torch.launch import serve, steps as steps_lib
    from repro_torch.models import io as io_lib
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.loadgen import mixed_length_workload
    dev = torch.device("cuda")
    cfg = configs.get_config("qwen1.5-0.5b")
    t0 = time.perf_counter()
    model = serve.build_model(cfg, 0, dev)
    _check(next(model.parameters()).dtype == torch.bfloat16
           and model.final_norm.dtype == torch.float32,
           "serving params not cast like the reference")
    engine = Engine(cfg, model, n_slots=8, max_len=40, topk=8)
    wl = mixed_length_workload(cfg.vocab, 16, seed=0)
    torch.cuda.synchronize()
    print(f"serve-lm: {cfg.name} {cfg.num_layers}L d_model {cfg.d_model} "
          f"vocab {cfg.vocab} m {cfg.m_vocab} k {cfg.bloom.k} "
          f"{cfg.param_count():,} params bf16, set-up "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    totals, tokens = {be.NAME: 0, dt.NAME: 0}, []
    for label, run in (("continuous", engine.run),
                       ("continuous replay", engine.run),
                       ("static", engine.run_static)):
        reqs = [r.fresh_copy() for r in wl]
        torch.cuda.synchronize()
        common.reset_launches()
        res, st = run(reqs)
        torch.cuda.synchronize()
        counts = dict(common.LAUNCHES)
        _check(all(r.done and not r.rejected for r in res.values()),
               f"{label}: a request was not served")
        want = st.prefills + st.decode_steps
        for name in (be.NAME, dt.NAME):
            _check(counts.get(name, 0) == want,
                   f"{label}: {counts.get(name, 0)} {name} launches for "
                   f"{st.prefills} prefills + {st.decode_steps} decode steps")
            totals[name] += counts[name]
        for r in res.values():
            _check(len(r.tokens) == r.max_gen
                   and all(0 <= t < cfg.vocab for t in r.tokens),
                   f"{label}: rid {r.rid} tokens {r.tokens}")
        tokens.append({rid: r.tokens for rid, r in res.items()})
        print(f"serve-lm: {label}: {st.decode_steps} decode steps, "
              f"{st.prefills} prefills, {st.tokens_out} tokens out, "
              f"utilization {st.utilization:.4f}, wall {st.wall_s:.3f} s, "
              f"launches {counts}", flush=True)
    _check(tokens[0] == tokens[1], "continuous replay served other tokens")
    _check(tokens[0] == tokens[2], "static served other tokens")

    # request 0's first token through the plain versions on the same card
    r0 = wl[0]
    prompt = torch.as_tensor(r0.prompt, dtype=torch.int64, device=dev)[None]
    spec = io_lib.vocab_spec(cfg)
    with torch.inference_mode():
        idx = spec.indices_for(prompt.reshape(-1)).contiguous()
        _check(torch.equal(be.bloom_embed_cuda(model.embed, idx),
                           be.bloom_embed_plain(model.embed, idx)),
               "prompt embedding: kernel != plain version")
        last = steps_lib.make_prefill_step(cfg)(model, prompt)["last_logits"]
        _check(tuple(last.shape) == (1, cfg.m_vocab)
               and bool(torch.isfinite(last).all()), "prefill logits")
        logp = torch.log_softmax(last.float(), -1)
        _, ids = dt.bloom_decode_topk_plain(
            logp, bloom.cached_hash_matrix(spec, dev), 8)
    _check(int(ids[0, 0]) == tokens[0][r0.rid][0],
           "served first token != plain decode of the same logits")
    print(f"serve-lm: replay and static tokens identical for {len(wl)} "
          "requests; request 0's first token equals the plain decode",
          flush=True)
    return totals


def _times(common, fns, calls=20, replays=5, iters=20):
    """{name: (device ms from CUDA graph replays, back-to-back ms from CUDA
    events)} of each zero-argument call in ``fns``."""
    return {n: (common.graph_time_ms(f, calls, replays),
                common.time_ms(f, iters, 3)) for n, f in fns.items()}


def _times_kernels(common, kernels, others, iters=20):
    """As ``_times`` for the calls in ``kernels``; the calls in ``others``
    (plain versions and library calls, some of which sync the host and so
    cannot be captured in a graph) back to back only, their one time
    given twice."""
    times = _times(common, kernels, iters=iters)
    for n, f in others.items():
        t = common.time_ms(f, iters, 3)
        times[n] = (t, t)
    return times


def _device_split(torch, fn, calls=20):
    """{kernel name: device us per call} of ``fn()`` from a torch.profiler
    trace of ``calls`` calls (names cut to the function's)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.key.removeprefix("void ").removeprefix(
                "(anonymous namespace)::")
            name = name.split("(")[0].split("<")[0].strip()
            split[name] = split.get(name, 0.0) + us / calls
    return split


def _split_line(split) -> str:
    return ", ".join(f"{n} {us:.3f} us" for n, us in
                     sorted(split.items(), key=lambda kv: -kv[1]))


def _times_line(times) -> str:
    return ", ".join(f"{n} {d:.6f} / {h:.6f}" for n, (d, h) in times.items())


def phase_ce(torch, ce, common):
    """bloom_ce forward and backward against their plain versions; returns
    their JSON rows, timed at the training step's shape (T = 512)."""
    dev = torch.device("cuda")
    m, k = 30208, 4
    gen = torch.Generator().manual_seed(3)
    err_fwd = err_bwd = 0.0
    cases = [(512, False), (4088, False), (512, True), (37, True)]
    for T, dup in cases:
        z = (3.0 * torch.randn(T, m, generator=gen)).to(dev)
        h = torch.randint(0, m, (T, k), generator=gen, dtype=torch.int32)
        if dup:
            h[::2, 1] = h[::2, 0]
            h[::3, 3] = h[::3, 0]
        h = h.to(dev)
        g = torch.randn(T, generator=gen).to(dev)
        loss, lse = ce.bloom_ce_cuda(z, h)
        dz = ce.bloom_ce_bwd_cuda(g, z, h, lse)
        torch.cuda.synchronize()
        ploss, plse = ce.bloom_ce_plain(z, h)
        pdz = ce.bloom_ce_bwd_plain(g, z, h, lse)
        torch.testing.assert_close(loss, ploss, rtol=1e-6, atol=1e-5)
        torch.testing.assert_close(lse, plse, rtol=1e-6, atol=1e-5)
        torch.testing.assert_close(dz, pdz, rtol=0, atol=1e-7)
        err_fwd = max(err_fwd, _max_abs_err(loss, ploss),
                      _max_abs_err(lse, plse))
        err_bwd = max(err_bwd, _max_abs_err(dz, pdz))
    print(f"kernels-train: bloom_ce forward and backward within tolerance "
          f"on (T, repeated hashes) = {cases}, m={m} k={k}: max abs err "
          f"loss/lse {err_fwd}, dz {err_bwd}", flush=True)

    T = 512
    z = (3.0 * torch.randn(T, m, generator=gen)).to(dev)
    h = torch.randint(0, m, (T, k), generator=gen, dtype=torch.int32).to(dev)
    g = torch.randn(T, generator=gen).to(dev)
    hl = h.long()
    _, lse = ce.bloom_ce_cuda(z, h)
    neg = torch.full((T, k), -1.0 / k, device=dev)
    fwd = _times(common, {
        "kernel": lambda: ce.bloom_ce_cuda(z, h),
        "plain": lambda: ce.bloom_ce_plain(z, h),
        "library": lambda: torch.logsumexp(z, -1) - z.gather(1, hl).mean(-1)})
    bwd = _times(common, {
        "kernel": lambda: ce.bloom_ce_bwd_cuda(g, z, h, lse),
        "plain": lambda: ce.bloom_ce_bwd_plain(g, z, h, lse),
        "library": lambda: torch.softmax(z, -1).scatter_add_(1, hl, neg)
        * g[:, None]})
    rows = []
    for label, name, times, nbytes, ops, err, line in (
            ("forward", ce.FWD, fwd, ce.min_bytes(T, m, k), 4 * T * m,
             err_fwd, 145),
            ("backward", ce.BWD, bwd, ce.min_bytes(T, m, k, backward=True),
             5 * T * m + T * m * k, err_bwd, 87)):
        bound_ms, by = _bound(nbytes, ops)
        print(f"kernels-train: bloom_ce {label} T={T} m={m} k={k}: device "
              f"ms (graph) / back-to-back ms (events): "
              f"{_times_line(times)}, bound {bound_ms * 1e3:.3f} us ({by}, "
              f"{nbytes} bytes)", flush=True)
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/bloom_ce.cu",
                     "replaces": f"src/repro/kernels/bloom_ce.py:{line}",
                     "launches": None, "max_abs_err": err,
                     "ms": times["kernel"][0], "plain_ms": times["plain"][0],
                     "bound_ms": bound_ms, "bound_by": by,
                     "library_ms": times["library"][0]})
    return rows


def phase_csr(torch, csr, common):
    """The card's CSR bins equal to ``bin_csr_plain``'s on a CPU copy, and
    the CSR scatter-add bit-identical against its plain version on a CPU
    copy; returns the JSON rows of the scatter kernel and of the binning,
    timed at the training step's shape."""
    dev = torch.device("cuda")
    T, k, D, m = 520, 4, 1024, 30208
    gen = torch.Generator().manual_seed(4)
    cases = [("main", T, D, None), ("rows 0,5,9", T, D, [0, 5, 5, 9]),
             ("row 7", T, D, [7]), ("D=1020", T, 1020, None),
             ("D=1000 rows 3,4", 64, 1000, [3, 4]), ("D=8", T, 8, None),
             ("D=1024 -1 pads", T, D, "pads")]
    for dtype in (torch.bfloat16, torch.float32):
        for label, Tc, Dc, rows in cases:
            g = torch.randn(Tc, Dc, generator=gen).to(dtype)
            if rows is None or rows == "pads":
                idx = torch.randint(0, m, (Tc, k), generator=gen,
                                    dtype=torch.int32)
                if rows == "pads":
                    idx[::3, 0] = -1
            else:
                pick = torch.randint(0, len(rows), (Tc, k), generator=gen)
                idx = torch.tensor(rows, dtype=torch.int32)[pick]
            bins = csr.bin_csr(idx.to(dev), m)
            got = csr.csr_scatter_add(g.to(dev), idx.to(dev), m)
            again = csr.csr_scatter_add(g.to(dev), idx.to(dev), m)
            torch.cuda.synchronize()
            _check(all(torch.equal(x.cpu(), w) for x, w in
                       zip(bins, csr.bin_csr_plain(idx, m))),
                   f"bloom_csr.bin {label}: device bins != bin_csr_plain's")
            _check(torch.equal(got.cpu(), csr.csr_scatter_add(g, idx, m)),
                   f"bloom_csr {dtype} {label}: kernel != plain version")
            _check(torch.equal(got, again),
                   f"bloom_csr {dtype} {label}: two launches differ")
        print(f"kernels-train: bloom_csr {dtype}: device bins equal "
              f"bin_csr_plain's, and the kernel is bit-identical to the "
              f"plain version on the CPU and to a second launch, for "
              f"{[c[0] for c in cases]} (T={T}, k={k}, m={m})", flush=True)

    g = torch.randn(T, D, generator=gen).to(torch.bfloat16).to(dev)
    idx = torch.randint(0, m, (T, k), generator=gen,
                        dtype=torch.int32).to(dev)
    bins = csr.bin_csr(idx, m)
    flat, rows = idx.reshape(-1).long(), torch.arange(
        T, device=dev).repeat_interleave(k)
    times = _times(common, {
        "kernel": lambda: csr.csr_scatter_add_cuda(g, bins, m),
        "binning": lambda: csr.bin_csr(idx, m),
        "kernel+binning": lambda: csr.csr_scatter_add(g, idx, m),
        "plain": lambda: csr.csr_scatter_add_plain(g, bins, m),
        "plain binning": lambda: csr.bin_csr_plain(idx, m),
        "library": lambda: torch.zeros(m, D, device=dev).index_add_(
            0, flat, g[rows].float())})
    nbytes = csr.min_bytes(T * k, T, m, D, 2)
    bound_ms, by = _bound(nbytes, T * k * D)
    bin_bytes = csr.bin_min_bytes(T * k, m)
    bin_bound_ms, bin_by = _bound_int(bin_bytes, T * k + m)
    print(f"kernels-train: bloom_csr bf16 T={T} k={k} D={D} m={m}: device "
          f"ms (graph) / back-to-back ms (events): {_times_line(times)}, "
          f"bound {bound_ms * 1e3:.3f} us ({by}, {nbytes} bytes); binning "
          f"bound {bin_bound_ms * 1e3:.3f} us ({bin_by}, {bin_bytes} bytes)",
          flush=True)
    print("kernels-train: the CSR backward as called, device time by kernel "
          "(torch.profiler): " + _split_line(_device_split(
              torch, lambda: csr.csr_scatter_add(g, idx, m))), flush=True)
    return [{"name": csr.NAME, "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/bloom_csr.cu",
             "replaces": "src/repro/kernels/bloom_csr.py:204",
             "launches": None, "max_abs_err": 0.0,
             "ms": times["kernel"][0], "plain_ms": times["plain"][0],
             "bound_ms": bound_ms, "bound_by": by,
             "library_ms": times["library"][0]},
            {"name": csr.BIN, "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/bloom_csr.cu",
             "replaces": "src/repro/kernels/bloom_csr.py:110",
             "launches": None, "max_abs_err": 0.0,
             "ms": times["binning"][0], "plain_ms": times["plain binning"][0],
             "bound_ms": bin_bound_ms, "bound_by": bin_by,
             "library_ms": None}]


def phase_train_lm(torch, common, names):
    """qwen1.5-0.5b at full width, 8 steps through launch/train.run, then
    the resume drill; returns each training kernel's launches in the
    8-step run, its losses and its step walls (ms, steps 2-8)."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.launch import train
    cfg = configs.get_config("qwen1.5-0.5b")
    steps, batch, seq = 8, 8, 64
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    common.reset_launches()
    t0 = time.perf_counter()
    _, hist = train.run("qwen1.5-0.5b", steps=steps, batch=batch, seq=seq,
                        full=True, log_every=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(common.LAUNCHES)
    for name in names:
        _check(counts.get(name, 0) == steps,
               f"train-lm: {counts.get(name, 0)} {name} launches for "
               f"{steps} steps")
    losses = [h["loss"] for h in hist]
    _check(len(losses) == steps and all(math.isfinite(x) for x in losses),
           f"train-lm: losses {losses}")
    _check(losses[-1] < losses[0], f"train-lm: loss did not fall {losses}")
    step_ms = [h["step_s"] * 1e3 for h in hist[1:]]
    med = float(np.median(step_ms))
    print(f"train-lm: {cfg.name} {cfg.num_layers}L d_model {cfg.d_model} m "
          f"{cfg.m_vocab} k {cfg.bloom.k} {cfg.param_count():,} params, "
          f"batch {batch} seq {seq}, {steps} steps in {wall:.3f} s with "
          f"set-up: losses {losses}; median step wall {med:.6f} ms (steps "
          f"2-{steps}: {[round(x, 3) for x in step_ms]}), "
          f"{batch * seq / med * 1e3:.1f} tokens/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB, "
          f"launches {counts}", flush=True)

    ckpt = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        _, first = train.run("qwen1.5-0.5b", steps=4, batch=batch, seq=seq,
                             full=True, log_every=1, ckpt_dir=str(ckpt))
        _, rest = train.run("qwen1.5-0.5b", steps=steps, batch=batch,
                            seq=seq, full=True, log_every=1,
                            ckpt_dir=str(ckpt))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    _check([h["step"] for h in rest] == [5, 6, 7, 8],
           f"resume: steps {[h['step'] for h in rest]}")
    drill = [h["loss"] for h in first + rest]
    np.testing.assert_allclose(drill, losses, rtol=1e-6)
    print(f"train-lm: resume drill (4 steps, checkpoint, restore, to 8): "
          f"losses {drill} equal the straight run's within rtol 1e-6",
          flush=True)
    return counts, losses, step_ms


def phase_serve(torch, dt, common, bloom, retrieval, get_retrieval_config):
    """The web10m drill on CUDA; returns the kernel launches it made."""
    from repro_torch.launch import steps as steps_lib
    from repro_torch.serving.loadgen import (RetrievalLoadSpec,
                                             retrieval_workload)
    rcfg = get_retrieval_config("web10m")
    dev = torch.device("cuda")
    common.reset_launches()
    t0 = time.perf_counter()
    report = retrieval._drill(rcfg, 8, 8, 0, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = common.LAUNCHES.get(dt.NAME, 0)
    _check(launches > 0, "the main path launched no decode kernel")
    _check(launches == 2 * report["decode_steps"],
           f"{launches} kernel launches for 2 x {report['decode_steps']} "
           "decode steps")
    _check(report["impl"] == "kernel", f"impl {report['impl']}")

    # the served ids against the plain version on the same tower outputs
    wl = retrieval_workload(RetrievalLoadSpec(
        n_requests=8, catalog=rcfg.d, c_max=rcfg.c_max, rate=2.0, seed=0))
    params = retrieval.init_retrieval_params(rcfg, device=dev)
    engine = retrieval.RetrievalEngine(rcfg, params, n_slots=8)
    served, _ = engine.run([r.fresh_copy() for r in wl])
    # one B = 1 prefill per request, as the engine runs them
    prefill = steps_lib.make_retrieval_prefill_step(rcfg)
    rows = []
    for r in wl:
        items = torch.full((1, rcfg.c_max), -1, dtype=torch.int32)
        items[0, :r.prompt_len] = torch.as_tensor(r.prompt)
        rows.append(prefill(params, items.to(dev))[0])
    logp = torch.log_softmax(torch.stack(rows).float(), -1)
    _check(tuple(logp.shape) == (len(wl), rcfg.m)
           and bool(torch.isfinite(logp).all()), "tower output not finite")
    H = bloom.cached_hash_matrix(rcfg.spec(), dev)
    pv, pi = dt.bloom_decode_topk_plain(logp, H, rcfg.topk)
    for i, r in enumerate(wl):
        got = served[r.rid]
        _check(got.topk_ids == pi[i].tolist(),
               f"rid {r.rid}: served ids != plain version's")
        _check(got.topk_scores == pv[i].tolist(),
               f"rid {r.rid}: served scores != plain version's")
    print(f"serve: web10m drill d={report['d']} decode_steps="
          f"{report['decode_steps']} x2 replays, {launches} kernel launches, "
          f"utilization {report['utilization']}, replay walls "
          f"{report['wall_s']} s and {report['wall_s_replay']} s, drill wall "
          f"{wall:.3f} s with set-up, served "
          f"top-{rcfg.topk} == plain version for {len(wl)} requests",
          flush=True)
    return launches


def _bound_int(nbytes: int, int_ops: int):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    int32 operations over the int32 rate."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = int_ops / INT32_OPS_PER_S * 1e3
    return max(b_ms, o_ms), ("bytes" if b_ms >= o_ms else "operations")


def phase_embed_quant(torch, be, common, quant):
    """The quantized bloom_embed variants against their plain version;
    returns one JSON row per storage dtype, timed at T = 8 (one decode
    step of 8 slots) into bf16 (the LM's compute dtype)."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    m, D, k = 30208, 1024, 4
    gen = torch.Generator().manual_seed(5)
    base = torch.randn(m, D, generator=gen).to(dev)
    cases = [(T, D, k) for T in (1, 8, 14, 4096)]
    cases += [(14, 1000, 4), (14, 1020, 4), (8, 1024, 1), (8, 1024, 3)]
    rows = []
    for td in quant.TABLE_DTYPES:
        err = 0.0
        for out_dtype in (torch.bfloat16, torch.float32):
            for T, Dc, kc in cases:
                q, s = quant.quantize_table(base[:, :Dc].contiguous(), td)
                idx = torch.randint(0, m, (T, kc), generator=gen,
                                    dtype=torch.int32).to(dev)
                got = be.bloom_embed_quantized_cuda(q, s, idx, out_dtype)
                torch.cuda.synchronize()
                want = be.bloom_embed_quantized_plain(q, s, idx, out_dtype)
                _check(got.dtype == out_dtype and torch.equal(got, want),
                       f"bloom_embed {td} -> {out_dtype} T={T} D={Dc} "
                       f"k={kc}: kernel != plain version")
                err = max(err, _max_abs_err(got.float(), want.float()))
        print(f"kernels-quant: bloom_embed {td} into bf16 and f32: "
              f"bit-identical on {len(cases)} cases (T, D, k) = {cases}",
              flush=True)

        T = 8
        q, s = quant.quantize_table(base, td)
        idx = torch.randint(0, m, (T, k), generator=gen,
                            dtype=torch.int32).to(dev)
        idx64 = idx.long()
        # the library yardstick reads the stored values widened to the
        # output dtype ahead of the call, with the int8 scales as
        # per-sample weights
        wide = q.to(torch.bfloat16) if td != "int8" else q.float()
        psw = None if s is None else s[idx64]
        times = _times(common, {
            "kernel": lambda: be.bloom_embed_quantized_cuda(
                q, s, idx, torch.bfloat16),
            "plain": lambda: be.bloom_embed_quantized_plain(
                q, s, idx, torch.bfloat16),
            "embedding_bag": lambda: F.embedding_bag(
                idx64, wide, mode="sum", per_sample_weights=psw)})
        n_rows = int(torch.unique(idx).numel())
        nbytes = be.min_bytes(n_rows, T, k, D, quant.table_itemsize(td),
                              out_itemsize=2, row_scales=s is not None)
        bound_ms, by = _bound(nbytes, T * (k - 1) * D
                              + (T * k * D if s is not None else 0))
        print(f"kernels-quant: bloom_embed {td} -> bf16 T={T} m={m} D={D} "
              f"k={k}: device ms (graph) / back-to-back ms (events): "
              f"{_times_line(times)}, bound {bound_ms * 1e3:.3f} us ({by}, "
              f"{nbytes} bytes)", flush=True)
        rows.append({"name": be.variant_name(q.dtype), "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/bloom_embed.cu",
                     "replaces": ("src/repro/kernels/bloom_embed.py:71"
                                  if td == "int8" else
                                  "src/repro/kernels/bloom_embed.py:294"),
                     "launches": None, "max_abs_err": err,
                     "ms": times["kernel"][0], "plain_ms": times["plain"][0],
                     "bound_ms": bound_ms, "bound_by": by,
                     "library_ms": times["embedding_bag"][0]})
    return rows


def phase_decode_quant(torch, dt, common, bloom, quant, get_retrieval_config):
    """The quantized and in-kernel-hash bloom_decode_topk variants against
    their plain version, and against the explicit-H kernel on the same
    logp; returns one JSON row per variant, timed at web10m (B = 8)."""
    from repro_torch import configs
    from repro_torch.models import io as io_lib
    dev = torch.device("cuda")
    rcfg = get_retrieval_config("web10m")
    lm_spec = io_lib.vocab_spec(configs.get_config("qwen1.5-0.5b"))
    gen = torch.Generator().manual_seed(6)
    partial = torch.zeros(8, dtype=torch.bool, device=dev)
    partial[[0, 3, 7]] = True
    shapes = [("web10m", rcfg.spec(), 8, rcfg.topk),
              ("LM B=1", lm_spec, 1, 8), ("LM B=8", lm_spec, 8, 8)]
    variants = [(td, True) for td in quant.TABLE_DTYPES] + [("int8", False)]
    rows, errs = {}, {}
    for label, spec, B, topk in shapes:
        H = bloom.cached_hash_matrix(spec, dev)
        logp = torch.log_softmax(
            torch.randn(B, spec.m, generator=gen), -1).to(dev)
        hs = (spec.d, spec.k, spec.seed)
        for td, hashed in variants:
            q, s = quant.quantize_table(logp, td)
            name = dt.variant_name(q.dtype, hashed)
            h, spec_arg = (None, hs) if hashed else (H, None)
            acts = [None] + ([partial] if B == 8 else [])
            for act in acts:
                kv, ki = dt.bloom_decode_topk_cuda(q, h, topk, act, s,
                                                   spec_arg)
                ev, ei = dt.bloom_decode_topk_cuda(q, H, topk, act, s)
                torch.cuda.synchronize()
                pv, pi = dt.bloom_decode_topk_plain(q, h, topk, act, s,
                                                    spec_arg)
                what = f"{name} {label} active={act is not None}"
                _check(torch.equal(ki, pi) and torch.equal(kv, pv),
                       f"{what}: kernel != plain version")
                _check(torch.equal(ki, ei) and torch.equal(kv, ev),
                       f"{what}: in-kernel hash != explicit H")
                errs[name] = max(errs.get(name, 0.0), _max_abs_err(kv, pv))
            Hl = H.long()
            # the kernel on the device alone (CUDA graph replays) and back
            # to back (events); the plain version and the library yardstick
            # back to back only (the plain hash builds small host tensors,
            # which a graph capture refuses)
            kernel = lambda: dt.bloom_decode_topk_cuda(  # noqa: E731
                q, h, topk, None, s, spec_arg)
            times = {"kernel": (common.graph_time_ms(kernel, 10, 3),
                                common.time_ms(kernel, 10, 2))}
            plain = lambda: dt.bloom_decode_topk_plain(  # noqa: E731
                q, h, topk, None, s, spec_arg)
            t = common.time_ms(plain, 3, 1)
            times["plain"] = (t, t)
            library = lambda: torch.topk(  # noqa: E731
                quant.dequantize_table(q, s)[:, Hl].sum(-1), topk)
            times["library"] = (common.graph_time_ms(library, 3, 2),
                                common.time_ms(library, 3, 1))
            nbytes = dt.min_bytes(B, B, m=spec.m, d=spec.d, k=spec.k,
                                  topk=topk,
                                  logp_itemsize=quant.table_itemsize(td),
                                  inkernel_hash=hashed,
                                  row_scales=s is not None)
            int_ops = dt.hash_ops(spec.d, spec.k) if hashed else 0
            bound_ms, by = _bound_int(nbytes, int_ops)
            print(f"kernels-quant: {name} {label} m={spec.m} d={spec.d} "
                  f"k={spec.k} topk={topk}: bit-identical to plain and to "
                  f"the explicit-H kernel (all rows"
                  f"{', rows 0,3,7' if B == 8 else ''}); device ms (graph) / "
                  f"back-to-back ms (events; plain: events only): "
                  f"{_times_line(times)}, bound "
                  f"{bound_ms * 1e3:.3f} us ({by}, {nbytes} bytes, "
                  f"{int_ops} int ops)", flush=True)
            if label == "web10m":
                rows[name] = {
                    "name": name, "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/"
                              "bloom_decode_topk.cu",
                    "replaces": "src/repro/kernels/bloom_decode_topk.py:249",
                    "launches": None, "max_abs_err": None,
                    "ms": times["kernel"][0], "plain_ms": times["plain"][1],
                    "bound_ms": bound_ms, "bound_by": by,
                    "library_ms": times["library"][0]}
    for name, row in rows.items():
        row["max_abs_err"] = errs[name]
    return list(rows.values())


def phase_serve_quant(torch, be, dt, common, bloom, quant, retrieval,
                      get_retrieval_config):
    """The quantized serving paths on CUDA; returns each quantized
    variant's launches summed over the runs."""
    import dataclasses
    import numpy as np
    from repro_torch import configs
    from repro_torch.launch import profile_step, serve, steps as steps_lib
    from repro_torch.models import io as io_lib
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.loadgen import (RetrievalLoadSpec,
                                             mixed_length_workload,
                                             retrieval_workload)
    dev = torch.device("cuda")
    totals = {}

    def add(counts):
        for n, c in counts.items():
            if n.startswith((dt.NAME + ".", be.NAME + ".")):
                totals[n] = totals.get(n, 0) + c

    # web10m through RetrievalEngine, one decode variant per dtype
    for td in ("int8", "fp8_e4m3", "bfloat16", "float32"):
        rcfg = get_retrieval_config("web10m", table_dtype=td)
        wl = retrieval_workload(RetrievalLoadSpec(
            n_requests=8, catalog=rcfg.d, c_max=rcfg.c_max, rate=2.0,
            seed=0))
        params = retrieval.init_retrieval_params(rcfg, device=dev)
        engine = retrieval.RetrievalEngine(rcfg, params, n_slots=8)
        torch.cuda.synchronize()
        common.reset_launches()
        t0 = time.perf_counter()
        served, st = engine.run([r.fresh_copy() for r in wl])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(common.LAUNCHES)
        name = dt.variant_name(quant.storage_dtype(td), True)
        _check(counts == {name: st.decode_steps},
               f"web10m {td}: launches {counts} for {st.decode_steps} "
               "decode steps")
        add(counts)
        prefill = steps_lib.make_retrieval_prefill_step(rcfg)
        logits = []
        for r in wl:
            items = torch.full((1, rcfg.c_max), -1, dtype=torch.int32)
            items[0, :r.prompt_len] = torch.as_tensor(r.prompt)
            logits.append(prefill(params, items.to(dev))[0])
        logp = torch.log_softmax(torch.stack(logits).float(), -1)
        q, s = quant.quantize_table(logp, td)
        spec = rcfg.spec()
        pv, pi = dt.bloom_decode_topk_plain(q, None, rcfg.topk, None, s,
                                            (spec.d, spec.k, spec.seed))
        for i, r in enumerate(wl):
            _check(served[r.rid].topk_ids == pi[i].tolist()
                   and served[r.rid].topk_scores == pv[i].tolist(),
                   f"web10m {td} rid {r.rid}: served != plain version")
        print(f"serve-quant: web10m table_dtype {td}: {st.decode_steps} "
              f"decode steps, launches {counts}, wall {wall:.3f} s, served "
              f"top-{rcfg.topk} == plain version for {len(wl)} requests",
              flush=True)

    # full-width qwen1.5-0.5b, one model, one Engine per table dtype
    cfg = configs.get_config("qwen1.5-0.5b")
    model = serve.build_model(cfg, 0, dev)
    wl = mixed_length_workload(cfg.vocab, 16, seed=0)
    runs = [(td, cfg.bloom.on_the_fly) for td in
            ("int8", "fp8_e4m3", "bfloat16", "float32")]
    runs.append(("int8", False))
    for td, fly in runs:
        qcfg = dataclasses.replace(
            cfg, table_dtype=td,
            bloom=dataclasses.replace(cfg.bloom, on_the_fly=fly))
        engine = Engine(qcfg, model, n_slots=8, max_len=40, topk=8)
        reqs = [r.fresh_copy() for r in wl]
        torch.cuda.synchronize()
        common.reset_launches()
        res, st = engine.run(reqs)
        torch.cuda.synchronize()
        counts = dict(common.LAUNCHES)
        _check(all(r.done and not r.rejected for r in res.values()),
               f"LM {td}: a request was not served")
        sd = quant.storage_dtype(td)
        want = {be.variant_name(sd): st.prefills + st.decode_steps,
                dt.variant_name(sd, fly): st.prefills + st.decode_steps}
        _check(counts == want, f"LM {td} on_the_fly={fly}: launches "
               f"{counts}, want {want}")
        add(counts)
        for r in res.values():
            _check(len(r.tokens) == r.max_gen
                   and all(0 <= t < cfg.vocab for t in r.tokens),
                   f"LM {td}: rid {r.rid} tokens {r.tokens}")
        # request 0's first token through the plain versions
        r0 = wl[0]
        spec = io_lib.vocab_spec(qcfg)
        prompt = torch.as_tensor(r0.prompt, dtype=torch.int64,
                                 device=dev)[None]
        with torch.inference_mode():
            idx = spec.indices_for(prompt.reshape(-1)).contiguous()
            qt, st_ = bloom.cached_quantized_table(spec, model.embed, td)
            _check(torch.equal(
                be.bloom_embed_quantized_cuda(qt, st_, idx, torch.bfloat16),
                be.bloom_embed_quantized_plain(qt, st_, idx,
                                               torch.bfloat16)),
                f"LM {td}: prompt embedding kernel != plain version")
            last = steps_lib.make_prefill_step(qcfg)(model,
                                                     prompt)["last_logits"]
            q, s = quant.quantize_table(
                torch.log_softmax(last.float(), -1), td)
            H = None if fly else bloom.cached_hash_matrix(spec, dev)
            _, ids = dt.bloom_decode_topk_plain(
                q, H, 8, None, s,
                (spec.d, spec.k, spec.seed) if fly else None)
        _check(int(ids[0, 0]) == res[r0.rid].tokens[0],
               f"LM {td}: served first token != plain decode")
        print(f"serve-quant: {cfg.name} table_dtype {td} on_the_fly {fly}: "
              f"{st.decode_steps} decode steps, {st.prefills} prefills, "
              f"{st.tokens_out} tokens out, wall {st.wall_s:.3f} s, "
              f"launches {counts}; request 0's first token equals the "
              f"plain decode", flush=True)
    del model, engine

    # decode step time, int8 beside auto: 8 live slots, host clock with a
    # synchronise per step, the two paths in turns (auto, int8, int8, auto)
    # so that the host's drift falls on both; then the Eq. 3 recovery alone
    # (io.recover_topk: the logp quantize and the decode kernel, or the
    # decode kernel on H), back to back with CUDA events
    fns = {td: profile_step.decode_step(
        configs.get_config("qwen1.5-0.5b", table_dtype=td), dev, 24)
        for td in ("auto", "int8")}
    walls = {td: [] for td in fns}
    for i in range(24):
        for td in (("auto", "int8") if i % 2 == 0 else ("int8", "auto")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[td]()
            torch.cuda.synchronize()
            if i >= 2:
                walls[td].append((time.perf_counter() - t0) * 1e3)
    del fns
    med = {td: float(np.median(w)) for td, w in walls.items()}
    logits = torch.randn(8, cfg.m_vocab, device=dev)
    active = torch.ones(8, dtype=torch.bool, device=dev)
    rec = {td: common.time_ms(lambda: io_lib.recover_topk(
        configs.get_config("qwen1.5-0.5b", table_dtype=td), logits, 8,
        active=active), 50, 5) for td in ("auto", "int8")}
    print(f"serve-quant: full-width decode step, 8 live slots, median of "
          f"{len(walls['auto'])} each, in turns (host clock, synchronised):"
          f" int8 {med['int8']:.6f} ms, auto {med['auto']:.6f} ms; the "
          f"Eq. 3 recovery alone (back to back, events): int8 "
          f"{rec['int8']:.6f} ms, auto {rec['auto']:.6f} ms", flush=True)
    return totals


def _equal_nan(torch, a, b) -> bool:
    """Equal values, and NaN in the same places."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


def _no_repeats(torch, H, m):
    """H with each row that repeats an index replaced by k distinct ones."""
    k = H.shape[1]
    srt = H.sort(dim=1).values
    rep = (srt[:, 1:] == srt[:, :-1]).any(dim=1)
    fix = (H[:, :1] + torch.arange(k, device=H.device, dtype=H.dtype)) % m
    return torch.where(rep[:, None], fix, H).contiguous(), int(rep.sum())


def phase_kernels_decode(torch, bd, csr, be, common, bloom, quant):
    """The full Eq. 3 decode (B8) over f32, bf16, int8 and fp8 logp, bit-
    identical to its plain version; the dense decode backward (B9) against
    its plain version, the CSR decode caller and itself; the dense
    embedding backward (B9) at the training shape against its plain
    version, the CSR kernel and itself.  Returns one JSON row per kernel
    and variant, timed at the LM shapes (B = 8; T = 520)."""
    import torch.nn.functional as F
    from repro_torch import configs
    from repro_torch.models import io as io_lib
    dev = torch.device("cuda")
    spec = io_lib.vocab_spec(configs.get_config("qwen1.5-0.5b"))
    H = bloom.cached_hash_matrix(spec, dev)
    (d, k), m = H.shape, spec.m
    gen = torch.Generator().manual_seed(7)
    logp8 = torch.log_softmax(3 * torch.randn(8, m, generator=gen), -1)
    edge_H = torch.randint(0, 1001, (5003, 3), generator=gen,
                           dtype=torch.int32)
    edge_lp = torch.log_softmax(torch.randn(3, 1001, generator=gen), -1)
    edge_lp[0, :5] = -500.0            # past fp8's range: NaN there
    edge_H[:4, 0] = torch.arange(4, dtype=torch.int32)
    cases = [("LM B=1", logp8[:1], H), ("LM B=8", logp8, H),
             ("edge B=3 m=1001 d=5003 k=3", edge_lp, edge_H.to(dev))]
    rows, Hl = [], H.long()
    for td in (None, "bfloat16", "int8", "fp8_e4m3"):
        err = 0.0
        for label, lp, h in cases:
            lp = lp.to(dev).contiguous()
            q, s = (lp, None) if td is None else quant.quantize_table(lp, td)
            got = bd.bloom_decode_cuda(q, h, s)
            torch.cuda.synchronize()
            want = bd.bloom_decode_plain(q, h, s)
            _check(_equal_nan(torch, got, want),
                   f"bloom_decode {td} {label}: kernel != plain version")
            if td == "int8":       # (sum q) * s, one rounding per output
                raw = bd.bloom_decode_plain(q.float(), h) * s[:, None]
                _check(torch.equal(got, raw), f"int8 {label}: not (sum q)*s")
            if td == "fp8_e4m3" and label.startswith("edge"):
                _check(bool(torch.isnan(got[0, :4]).all()),
                       "fp8: no NaN where the reference has one")
            err = max(err, _max_abs_err(got[~torch.isnan(got)],
                                        want[~torch.isnan(want)]))
        q, s = ((logp8.to(dev), None) if td is None
                else quant.quantize_table(logp8.to(dev), td))
        name = bd.variant_name(q.dtype)
        wide_t = quant.dequantize_table(q, s).t().contiguous()
        lp_t = logp8.to(dev)
        library = ((lambda: F.embedding_bag(Hl, lp_t.t().contiguous(),
                                            mode="sum").t())
                   if td is None else
                   (lambda: F.embedding_bag(Hl, wide_t, mode="sum").t()))
        times = _times_kernels(
            common, {"kernel": lambda: bd.bloom_decode_cuda(q, H, s),
                     "library": library},
            {"plain": lambda: bd.bloom_decode_plain(q, H, s)})
        itemsize = quant.table_itemsize(td)
        nbytes = bd.min_bytes(8, m, d, k, itemsize, s is not None)
        bound_ms, by = _bound(nbytes, 8 * d * (k - 1)
                              + (8 * d if s is not None else 0))
        print(f"kernels-decode: {name} B=8 m={m} d={d} k={k}: bit-identical "
              f"to plain on {[c[0] for c in cases]}; device ms (graph) / "
              f"back-to-back ms (events; plain: events only): "
              f"{_times_line(times)}, bound "
              f"{bound_ms * 1e3:.3f} us ({by}, {nbytes} bytes)", flush=True)
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/bloom_decode.cu",
                     "replaces": ("src/repro/kernels/bloom_decode.py:58"
                                  if td == "int8" else
                                  "src/repro/kernels/bloom_decode.py:203"),
                     "launches": None, "max_abs_err": err,
                     "ms": times["kernel"][0], "plain_ms": times["plain"][0],
                     "bound_ms": bound_ms, "bound_by": by,
                     "library_ms": times["library"][0]})

    # the decode backwards: the card's bins of H equal bin_csr_plain's (per
    # call and cached); the dense backward against its plain version (CPU
    # copy), the CSR caller and itself, on the spec's H exactly
    g = torch.randn(8, d, generator=gen).to(dev)
    want_bins = csr.bin_csr_plain(H.cpu(), m)
    bins = bloom.cached_decode_bins(spec, dev)
    for label, got_bins in (("per call", csr.bin_csr(H, m)),
                            ("cached", bins)):
        _check(all(torch.equal(x.cpu(), w)
                   for x, w in zip(got_bins, want_bins)),
               f"bins of the spec's H ({label}) != bin_csr_plain's")
    Hn, n_rep = _no_repeats(torch, H, m)
    dense = bd.bloom_decode_bwd_cuda(g, Hn, m)
    via_csr = csr.bloom_decode_bwd_csr(g, Hn, m)
    dense_r = bd.bloom_decode_bwd_cuda(g, H, m)
    again = bd.bloom_decode_bwd_cuda(g, H, m)
    csr_r = csr.bloom_decode_bwd_csr(g, H, m, bins)
    torch.cuda.synchronize()
    _check(torch.equal(dense_r, again), "dense decode backward: two launches "
           "gave other bits")
    _check(torch.equal(dense, via_csr), "dense decode backward != CSR on an "
           "H without repeated indices")
    _check(torch.equal(dense.cpu(), bd.bloom_decode_bwd_plain(
        g.cpu(), Hn.cpu(), m)), "dense decode backward != plain version")
    _check(torch.equal(dense_r, csr_r), "dense decode backward != CSR on the "
           "spec's H")
    _check(torch.equal(dense_r.cpu(), bd.bloom_decode_bwd_plain(
        g.cpu(), H.cpu(), m)), "dense decode backward != plain (spec H)")
    print(f"kernels-decode: decode backwards: the card's bins of the spec's "
          f"H (per call and cached) equal bin_csr_plain's; dense == CSR == "
          f"plain bit for bit on the spec's H and on an H without repeats "
          f"({n_rep} of {d} spec rows repeat an index and were replaced), "
          f"dense twice equal", flush=True)
    flat, src = H.reshape(-1).long(), torch.arange(
        d, device=dev).repeat_interleave(k)
    nbytes = bd.min_bytes(8, m, d, k)
    bound_ms, by = _bound(nbytes, 8 * d * k)
    dec_times = _times_kernels(common, {
        "dense kernel": lambda: bd.bloom_decode_bwd_cuda(g, H, m),
        "CSR caller": lambda: csr.bloom_decode_bwd_csr(g, H, m, bins),
        "binning": lambda: csr.bin_csr(H, m),
        "library": lambda: torch.zeros(m, 8, device=dev).index_add_(
            0, flat, g.t()[src]).t()}, {
        "plain": lambda: bd.bloom_decode_bwd_plain(g, H, m),
        "plain binning": lambda: csr.bin_csr_plain(H, m)})
    bin_bytes = csr.bin_min_bytes(d * k, m)
    bin_bound_ms, bin_by = _bound_int(bin_bytes, d * k + m)
    print(f"kernels-decode: decode backward B=8 d={d} m={m} k={k}: device ms "
          f"(graph) / back-to-back ms (events; plain and plain binning: "
          f"events only): "
          f"{_times_line(dec_times)}, "
          f"bound {bound_ms * 1e3:.3f} us ({by}, {nbytes} bytes); binning "
          f"bound {bin_bound_ms * 1e3:.3f} us ({bin_by}, {bin_bytes} bytes)",
          flush=True)
    print("kernels-decode: dense decode backward, device time by kernel "
          "(torch.profiler): " + _split_line(_device_split(
              torch, lambda: bd.bloom_decode_bwd_cuda(g, H, m))), flush=True)
    for name, key in ((bd.BWD, "dense kernel"), (csr.DECODE, "CSR caller")):
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/bloom_csr.cu",
                     "replaces": ("src/repro/kernels/bloom_decode.py:128"
                                  if name == bd.BWD else
                                  "src/repro/kernels/bloom_csr.py:282"),
                     "launches": None, "max_abs_err": 0.0,
                     "ms": dec_times[key][0],
                     "plain_ms": dec_times["plain"][0],
                     "bound_ms": bound_ms, "bound_by": by,
                     "library_ms": dec_times["library"][0]})

    # the dense embedding backward at the training shape and edge cases
    T, D = 520, 1024
    cases = [("main", T, D, None), ("rows 0,5,9", T, D, [0, 5, 5, 9]),
             ("D=1000", T, 1000, None), ("D=2500 row 7", 64, 2500, [7])]
    for dtype in (torch.bfloat16, torch.float32):
        for label, Tc, Dc, rows_ in cases:
            gc = torch.randn(Tc, Dc, generator=gen).to(dtype)
            if rows_ is None:
                idx = torch.randint(0, m, (Tc, k), generator=gen,
                                    dtype=torch.int32)
            else:
                pick = torch.randint(0, len(rows_), (Tc, k), generator=gen)
                idx = torch.tensor(rows_, dtype=torch.int32)[pick]
            got = be.bloom_embed_bwd_cuda(gc.to(dev), idx.to(dev), m)
            again = be.bloom_embed_bwd_cuda(gc.to(dev), idx.to(dev), m)
            via_csr = csr.csr_scatter_add(gc.to(dev), idx.to(dev), m)
            torch.cuda.synchronize()
            _check(torch.equal(got, again), f"dense embed backward {label}: "
                   "two launches gave other bits")
            _check(torch.equal(got, via_csr), f"dense embed backward "
                   f"{label}: != CSR kernel")
            want = be.bloom_embed_bwd_plain(gc, idx, m)
            _check(torch.equal(got.cpu(), want), f"dense embed backward "
                   f"{dtype} {label}: != plain version")
        print(f"kernels-decode: bloom_embed_bwd {dtype}: bit-identical to the "
              f"plain version on the CPU, to the CSR kernel and to a second "
              f"launch for {[c[0] for c in cases]} (m={m}, k={k})",
              flush=True)
    gc = torch.randn(T, D, generator=gen).to(torch.bfloat16).to(dev)
    idx = torch.randint(0, m, (T, k), generator=gen,
                        dtype=torch.int32).to(dev)
    flat, src = idx.reshape(-1).long(), torch.arange(
        T, device=dev).repeat_interleave(k)
    times = _times_kernels(common, {
        "kernel": lambda: be.bloom_embed_bwd_cuda(gc, idx, m),
        "library": lambda: torch.zeros(m, D, device=dev).index_add_(
            0, flat, gc[src].float())}, {
        "plain": lambda: be.bloom_embed_bwd_plain(gc, idx, m)})
    nbytes = m * D * 4 + T * D * 2 + T * k * 4
    bound_ms, by = _bound(nbytes, T * k * D)
    print(f"kernels-decode: bloom_embed_bwd bf16 T={T} k={k} D={D} m={m}: "
          f"device ms (graph) / back-to-back ms (events; plain: events "
          f"only): "
          f"{_times_line(times)}, bound {bound_ms * 1e3:.3f} us ({by}, "
          f"{nbytes} bytes)", flush=True)
    rows.append({"name": be.BWD, "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/bloom_embed.cu",
                 "replaces": "src/repro/kernels/bloom_embed.py:189",
                 "launches": None, "max_abs_err": 0.0,
                 "ms": times["kernel"][0], "plain_ms": times["plain"][0],
                 "bound_ms": bound_ms, "bound_by": by,
                 "library_ms": times["library"][0]})
    return rows


def phase_decode_grad(torch, bd, csr, common, bloom, quant):
    """ops.bloom_decode on the logits of full-width qwen1.5-0.5b (seed 0):
    8 prompts, last positions, log_softmax, scores at d = 151,936 in f32
    and with each table_dtype, and a seeded cotangent's gradient under
    bwd_impl csr and dense; returns the launches of each kernel."""
    from repro_torch import configs
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops
    from repro_torch.launch import serve, steps as steps_lib
    from repro_torch.models import io as io_lib
    from repro_torch.models import transformer as tf
    dev = torch.device("cuda")
    cfg = configs.get_config("qwen1.5-0.5b")
    spec = io_lib.vocab_spec(cfg)
    model = serve.build_model(cfg, 0, dev)
    steps_lib.warm_bloom_caches(cfg, model, decode_grad=True)
    tokens = torch.as_tensor(synthetic.make_token_stream(
        8 * 16, cfg.vocab, seed=0).reshape(8, 16)).to(dev)
    with torch.no_grad():
        last = tf.lm_apply(model, cfg, tokens, mode="prefill")["logits"][:, -1]
    logp = torch.log_softmax(last.float(), -1)
    _check(tuple(logp.shape) == (8, spec.m)
           and bool(torch.isfinite(logp).all()), "decode-grad: logits")
    cot = torch.randn(8, spec.d, generator=torch.Generator().manual_seed(8)
                      ).to(dev)
    del model
    runs = [(None, "csr"), (None, "dense"), ("float32", "csr"),
            ("bfloat16", "csr"), ("int8", "csr"), ("int8", "dense"),
            ("fp8_e4m3", "dense")]
    totals, grads = {}, {}
    H = bloom.cached_hash_matrix(spec, dev)
    for td, impl in runs:
        x = logp.detach().requires_grad_()
        torch.cuda.synchronize()
        common.reset_launches()
        t0 = time.perf_counter()
        scores = ops.bloom_decode(x, spec, bwd_impl=impl, table_dtype=td)
        dlogp, = torch.autograd.grad(scores, x, cot)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = dict(common.LAUNCHES)
        q, s = ((logp, None) if td is None
                else quant.quantize_table(logp, td))
        want = {bd.variant_name(q.dtype): 1}
        want.update({csr.DECODE: 1} if impl == "csr"
                    else {csr.BIN: 1, bd.BWD: 1})
        _check(counts == want, f"decode-grad {td} {impl}: launches {counts}")
        for n, c in counts.items():
            totals[n] = totals.get(n, 0) + c
        _check(tuple(scores.shape) == (8, spec.d)
               and _equal_nan(torch, scores.detach(),
                              bd.bloom_decode_plain(q, H, s)),
               f"decode-grad {td} {impl}: scores != plain version")
        _check(dlogp.dtype == torch.float32
               and bool(torch.isfinite(dlogp).all()),
               f"decode-grad {td} {impl}: gradient")
        grads[(td, impl)] = dlogp
        print(f"decode-grad: table_dtype {td} bwd_impl {impl}: scores "
              f"(8, {spec.d}) == plain version, forward + backward "
              f"{wall:.3f} ms (host clock, synchronised), launches {counts}",
              flush=True)
    _check(torch.equal(grads[(None, "csr")], grads[(None, "dense")]),
           "decode-grad: csr and dense gradients differ")
    _check(torch.equal(grads[("int8", "csr")], grads[(None, "csr")])
           and torch.equal(grads[("int8", "dense")], grads[(None, "dense")]),
           "decode-grad: int8 gradient is not straight-through")
    print("decode-grad: the csr and dense dlogp are bit-identical; the int8 "
          "and fp8 gradients equal the f32 ones (straight-through)",
          flush=True)
    return totals


def phase_train_lm_dense(torch, be, common, names, csr_losses, csr_ms):
    """qwen1.5-0.5b at full width, 8 steps through launch/train.run with
    bwd_impl="dense", twice, in turns with a CSR run; the first step's
    loss and embedding gradient against the CSR run's.  Returns the
    launches of the first dense run."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.data import synthetic
    from repro_torch.data.pipeline import BatchIterator, lm_batches
    from repro_torch.launch import steps as steps_lib, train
    from repro_torch.models import io as io_lib
    dev = torch.device("cuda")
    steps, batch, seq = 8, 8, 64
    step_ms = {"csr": list(csr_ms), "dense": []}
    counts = None
    for impl in ("dense", "csr", "dense"):
        torch.cuda.synchronize()
        common.reset_launches()
        _, hist = train.run("qwen1.5-0.5b", steps=steps, batch=batch,
                            seq=seq, full=True, log_every=1, bwd_impl=impl)
        torch.cuda.synchronize()
        step_ms[impl] += [h["step_s"] * 1e3 for h in hist[1:]]
        losses = [h["loss"] for h in hist]
        if impl == "dense" and counts is None:
            counts = dict(common.LAUNCHES)
            for name in names:
                _check(counts.get(name, 0) == steps,
                       f"train-lm-dense: {counts.get(name, 0)} {name} "
                       f"launches for {steps} steps")
            _check(all(math.isfinite(x) for x in losses)
                   and losses[-1] < losses[0],
                   f"train-lm-dense: losses {losses}")
            _check(losses[0] == csr_losses[0], f"train-lm-dense: first loss "
                   f"{losses[0]} != the CSR run's {csr_losses[0]}")
            print(f"train-lm-dense: losses {losses} (CSR run: "
                  f"{csr_losses}); launches {counts}", flush=True)

    # the first step's gradients under both backwards, same params, batch
    cfg = configs.get_config("qwen1.5-0.5b")
    model = steps_lib.init_fn_for(cfg)(0).to(dev)
    stream = synthetic.make_token_stream(
        n_tokens=batch * (seq + 1) * 64, vocab=cfg.vocab, seed=0)
    tokens = torch.as_tensor(next(BatchIterator(
        [lm_batches(stream, batch, seq)], batch, seed=0))[0]).to(dev)
    out = {}
    for impl in ("csr", "dense"):
        c = configs.get_config("qwen1.5-0.5b", bwd_impl=impl)
        loss, _, grads = steps_lib.value_and_grad(model, c,
                                                  {"tokens": tokens})
        out[impl] = (float(loss), grads["embed"])
    _check(out["csr"][0] == out["dense"][0], "first-step losses differ")
    idx = io_lib.vocab_spec(cfg).indices_for(
        tokens.reshape(-1)).long()
    srt = idx.sort(dim=1).values
    rep = (srt[:, 1:] == srt[:, :-1]).any(dim=1)
    touched = torch.zeros(cfg.m_vocab, dtype=torch.bool, device=dev)
    touched[idx[rep].reshape(-1)] = True
    a, b = out["csr"][1], out["dense"][1]
    err = float((a - b).abs().max())
    _check(torch.equal(a[~touched], b[~touched]),
           "first-step embedding gradient differs off the repeating rows")
    _check(err <= 1e-6, f"first-step embedding gradient err {err}")
    med = {n: float(np.median(v)) for n, v in step_ms.items()}
    print(f"train-lm-dense: first-step loss equal to the CSR run's; "
          f"embedding gradient bit-identical on the rows no repeating token "
          f"reaches ({int(rep.sum())} of {idx.shape[0]} tokens repeat a row; "
          f"max abs err {err} over all rows, bit-identical: "
          f"{torch.equal(a, b)}); median step wall, steps 2-8 of each run, "
          f"runs in turns (csr, dense, csr, dense): dense {med['dense']:.6f} "
          f"ms ({batch * seq / med['dense'] * 1e3:.1f} tokens/s), csr "
          f"{med['csr']:.6f} ms ({batch * seq / med['csr'] * 1e3:.1f} "
          f"tokens/s)", flush=True)
    return counts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: the port is not at {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs.retrieval import get_retrieval_config
    from repro_torch.core import bloom
    from repro_torch.kernels import bloom_ce as ce
    from repro_torch.kernels import bloom_csr as csr
    from repro_torch.kernels import bloom_decode as bd
    from repro_torch.kernels import bloom_decode_topk as dt
    from repro_torch.kernels import bloom_embed as be
    from repro_torch.kernels import common
    from repro_torch.serving import retrieval

    t0 = time.perf_counter()
    built = common.build()
    print("build: " + ", ".join(f"{n} {s:.3f} s" for n, s in built.items())
          + f" (wall {time.perf_counter() - t0:.3f} s)", flush=True)
    _check(set(built) == {dt.NAME, be.NAME, ce.NAME, csr.NAME, bd.NAME},
           f"unexpected kernels {sorted(built)}")

    row = phase_kernels(torch, dt, common, bloom, get_retrieval_config)
    lm_decode_topk(torch, dt, common, bloom)
    embed_row = phase_embed(torch, be, common)
    row["launches"] = phase_serve(torch, dt, common, bloom, retrieval,
                                  get_retrieval_config)
    ev = retrieval._smoke_eval(torch.device("cuda"), 0)
    print(f"eval: smoke untrained rr={ev['rr']:.6f} map={ev['map']:.6f} "
          f"n={ev['n_evaluated']}", flush=True)
    lm = phase_serve_lm(torch, be, dt, common)
    row["launches"] += lm[dt.NAME]
    embed_row["launches"] = lm[be.NAME]
    train_rows = phase_ce(torch, ce, common) + phase_csr(torch, csr, common)
    trained, csr_losses, csr_ms = phase_train_lm(
        torch, common, [be.NAME, csr.BIN, csr.NAME, ce.FWD, ce.BWD])
    embed_row["launches"] += trained[be.NAME]
    for r in train_rows:
        r["launches"] = trained[r["name"]]
    from repro_torch.core import quant
    quant_rows = (phase_embed_quant(torch, be, common, quant)
                  + phase_decode_quant(torch, dt, common, bloom, quant,
                                       get_retrieval_config))
    served = phase_serve_quant(torch, be, dt, common, bloom, quant,
                               retrieval, get_retrieval_config)
    _check(set(served) == {r["name"] for r in quant_rows},
           f"quantized variants launched {sorted(served)}, rows "
           f"{sorted(r['name'] for r in quant_rows)}")
    for r in quant_rows:
        r["launches"] = served[r["name"]]
    decode_rows = phase_kernels_decode(torch, bd, csr, be, common, bloom,
                                       quant)
    launched = phase_decode_grad(torch, bd, csr, common, bloom, quant)
    dense_counts = phase_train_lm_dense(
        torch, be, common, [be.NAME, be.BWD, ce.FWD, ce.BWD], csr_losses,
        csr_ms)
    _check(csr.NAME not in dense_counts and csr.BIN not in dense_counts,
           "the dense training run launched the CSR kernel or its binning")
    launched.update(dense_counts)
    for r in decode_rows:
        r["launches"] = launched.get(r["name"], 0)
    rows = [row, embed_row, *train_rows, *quant_rows, *decode_rows]
    _check(all(r["launches"] > 0 for r in rows),
           "a kernel of the main paths was never launched")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
