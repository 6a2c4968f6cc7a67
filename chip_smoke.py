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
                from torch's in the last ulp), and the CSR scatter-add
                bit-identical to its plain version on a CPU copy at
                (T = 520, k = 4, D = 1024, m = 30,208, bf16), on index sets
                with every entry in a few rows and at an unaligned D; then
                each one's device time, back-to-back time, plain and
                library times and bound;
  7. train-lm — qwen1.5-0.5b at full width (24 layers, d_model 1024, m =
                30,208, k = 4, bf16 compute, f32 master, random weights
                from seed 0, batch 8, seq 64) trained 8 steps through
                launch/train.run, counts reset just before and read just
                after: every step must launch bloom_embed, bloom_csr and
                the bloom_ce forward and backward once each, every loss be
                finite and step 8's below step 1's; then a resume drill (4
                steps with a checkpoint, then a fresh run that restores it
                and trains to 8) whose losses 5-8 equal the straight run's
                within rtol 1e-6.
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
    library_ms = time_ms(lambda: torch.topk(logp[:, Hl].sum(-1), topk), 3)
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
          f"plain {plain_ms:.6f} ms, torch.topk {library_ms:.6f} ms, bound "
          f"{bound_ms * 1e3:.3f} us ({nbytes} bytes), max_abs_err {err}",
          flush=True)
    return {"name": dt.NAME, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/bloom_decode_topk.cu",
            "replaces": "src/repro/kernels/bloom_decode_topk.py:249",
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": ("bytes" if bound_bytes_ms >= bound_ops_ms
                         else "operations"),
            "library_ms": library_ms}


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
        lib_ms = common.time_ms(
            lambda: torch.topk(lp[:, Hl].sum(-1), topk), 20)
        nbytes = dt.min_bytes(n_live, B, m=m, d=d, k=k, topk=topk)
        bound_ms, by = _bound(nbytes, d * n_live * (k - 1))
        print(f"kernels: bloom_decode_topk LM {label} m={m} d={d} k={k} "
              f"topk={topk}: bit-identical, kernel {ms:.6f} ms back to "
              f"back (events), {dev_ms:.6f} ms on the device (graph), plain "
              f"{plain_ms:.6f} ms, torch.topk {lib_ms:.6f} ms, bound "
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
    """The CSR scatter-add bit-identical against its plain version on a CPU
    copy; returns its JSON row, timed at the training step's shape."""
    dev = torch.device("cuda")
    T, k, D, m = 520, 4, 1024, 30208
    gen = torch.Generator().manual_seed(4)
    cases = [("main", T, D, None), ("rows 0,5,9", T, D, [0, 5, 5, 9]),
             ("row 7", T, D, [7]), ("D=1020", T, 1020, None),
             ("D=1000 rows 3,4", 64, 1000, [3, 4])]
    for dtype in (torch.bfloat16, torch.float32):
        for label, Tc, Dc, rows in cases:
            g = torch.randn(Tc, Dc, generator=gen).to(dtype)
            if rows is None:
                idx = torch.randint(0, m, (Tc, k), generator=gen,
                                    dtype=torch.int32)
            else:
                pick = torch.randint(0, len(rows), (Tc, k), generator=gen)
                idx = torch.tensor(rows, dtype=torch.int32)[pick]
            got = csr.csr_scatter_add(g.to(dev), idx.to(dev), m)
            torch.cuda.synchronize()
            _check(torch.equal(got.cpu(), csr.csr_scatter_add(g, idx, m)),
                   f"bloom_csr {dtype} {label}: kernel != plain version")
        print(f"kernels-train: bloom_csr {dtype}: bit-identical to the plain "
              f"version on the CPU for {[c[0] for c in cases]} (T={T}, "
              f"k={k}, m={m})", flush=True)

    g = torch.randn(T, D, generator=gen).to(torch.bfloat16).to(dev)
    idx = torch.randint(0, m, (T, k), generator=gen,
                        dtype=torch.int32).to(dev)
    bins = csr.bin_csr(idx, m)
    flat, rows = idx.reshape(-1).long(), torch.arange(
        T, device=dev).repeat_interleave(k)
    times = _times(common, {
        "kernel": lambda: csr.csr_scatter_add_cuda(g, bins, m),
        "kernel+binning": lambda: csr.csr_scatter_add(g, idx, m),
        "plain": lambda: csr.csr_scatter_add_plain(g, bins, m),
        "library": lambda: torch.zeros(m, D, device=dev).index_add_(
            0, flat, g[rows].float())})
    nbytes = csr.min_bytes(T * k, T, m, D, 2)
    bound_ms, by = _bound(nbytes, T * k * D)
    print(f"kernels-train: bloom_csr bf16 T={T} k={k} D={D} m={m}: device "
          f"ms (graph) / back-to-back ms (events): {_times_line(times)}, "
          f"bound {bound_ms * 1e3:.3f} us ({by}, {nbytes} bytes)",
          flush=True)
    return {"name": csr.NAME, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/bloom_csr.cu",
            "replaces": "src/repro/kernels/bloom_csr.py:204",
            "launches": None, "max_abs_err": 0.0,
            "ms": times["kernel"][0], "plain_ms": times["plain"][0],
            "bound_ms": bound_ms, "bound_by": by,
            "library_ms": times["library"][0]}


def phase_train_lm(torch, common, names):
    """qwen1.5-0.5b at full width, 8 steps through launch/train.run, then
    the resume drill; returns each training kernel's launches in the
    8-step run."""
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
    return counts


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
    from repro_torch.kernels import bloom_decode_topk as dt
    from repro_torch.kernels import bloom_embed as be
    from repro_torch.kernels import common
    from repro_torch.serving import retrieval

    t0 = time.perf_counter()
    built = common.build()
    print("build: " + ", ".join(f"{n} {s:.3f} s" for n, s in built.items())
          + f" (wall {time.perf_counter() - t0:.3f} s)", flush=True)
    _check(set(built) == {dt.NAME, be.NAME, ce.NAME, csr.NAME},
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
    train_rows = phase_ce(torch, ce, common) + [phase_csr(torch, csr, common)]
    trained = phase_train_lm(torch, common,
                             [be.NAME, csr.NAME, ce.FWD, ce.BWD])
    embed_row["launches"] += trained[be.NAME]
    for r in train_rows:
        r["launches"] = trained[r["name"]]
    rows = [row, embed_row, *train_rows]
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
