#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it.

    python3 chip_smoke.py        # from the repository root, one CUDA card
    python3 chip_smoke.py --parent DIR   # also time the parent commit's
        # csrc/bloom_embed.cu and bloom_decode.cu (copied into DIR with the
        # headers they include, and its core/hashing.py) beside this
        # tree's: phase 18

Phases, one line of numbers each:
  1. build    — compile every kernel in src/repro_torch/kernels/csrc/, one
                nvcc per source, all started together;
  2. kernels  — each kernel against its plain PyTorch version on the same
                tensors on the card, at the main paths' shapes and at edge
                cases, bit-identical (same f32 sum order):
                bloom_decode_topk at web10m (B = 8, m = 8192, d = 10M,
                k = 2, topk = 10) and at the LM shapes (B = 1 and 8,
                m = 30,208, d = 151,936, k = 4, topk = 8); bloom_embed's
                index entry in f32 and bf16 at T = 1, 8, 14, 4096,
                D = 1024, k = 4, m = 30,208, at a ragged D and at k = 1
                and 3; then the decode kernel's time, the plain version's,
                one library call computing the same function, and the
                least time the card could take (bytes over 3.35 TB/s, or
                f32 adds over 67 TFLOP/s); and bloom_decode_topk at the
                eval2k sweep's decode shapes (d = 2,000, m = 2,000 / 1,000
                / 400 / 200, k = 2, topk = 10, B = 1 and 8 and rows 0, 3,
                7 of 8), f32 with H and int8 with the hash and with H;
  2b. kernels-embed — the embed kernel's token entry (token ids in, hashed
                in the kernel), the main paths' embedding: bit-identical to
                its plain version, and its (T, k) indices equal to
                spec.indices_for, at T = 1, 8, 14, 520, 4096 (D = 1024)
                and D = 1000, 1020, over f32 and bf16 tables read as they
                are and each table_dtype into f32 and bf16, for the
                double hash and the precomputed hash matrix at k = 1, 2,
                3, 4, 8 and the identity spec, int32 and int64 tokens with
                0, d-1 and -1 among them; ops.bloom_embed launching it
                once, with one kernel in its torch.profiler trace and no
                host sync under set_sync_debug_mode("error") (nor
                ops.bloom_ce or core.bloom.encode); then, at T = 8, 14 and
                520 per storage (and int8 with the precomputed matrix), in
                turns, the token kernel, the index kernel, the embedding as
                the main path called it before (spec.indices_for, then the
                index kernel) and now (ops.bloom_embed), the plain version
                and F.embedding_bag: device (graph), back-to-back (events)
                and L2-cold (profiler, a 96 MB write before each call)
                times, beside the bound and an empty kernel's time (the
                launch floor);
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
                step must launch the embed kernel's token entry
                (bloom_embed.hash) once and bloom_decode_topk once,
                replays and static must serve the same tokens, and a
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
                after: every step must launch bloom_embed.hash, the binning,
                bloom_csr and the bloom_ce forward and backward once each,
                every loss be
                finite and step 8's below step 1's; then a resume drill (4
                steps with a checkpoint, then a fresh run that restores it
                and trains to 8) whose losses 5-8 equal the straight run's
                within rtol 1e-6;
  8. kernels-quant — the quantized variants (table_dtype) against their
                plain versions on the same tensors on the card,
                bit-identical: bloom_embed's index entry over f32, bf16,
                int8 (+ per-row scales) and fp8 storage into bf16 and f32
                outputs at T = 1, 8, 14, 4096, D = 1024, k = 4,
                m = 30,208, at a ragged D and at k = 1 and 3;
                bloom_decode_topk over f32, bf16, int8 and fp8 logp with
                the in-kernel hash at web10m (all rows, and rows 0, 3, 7)
                and at the LM shapes (B = 1 and 8), and int8 with the
                explicit H; the in-kernel-hash result must equal
                the explicit-H result on the same logp (the hashes equal
                cached_hash_matrix); and at both shapes, for each storage
                with the hash and with H, the cases the kernel's row tiles
                and live-row mapping could break: B = 13 (a ragged last
                tile), one, none and all but one of 8 rows live, at topk 1,
                8, 10 and 64, each bit-identical to the plain version, to
                the explicit-H kernel and to a second launch, and a
                constant logp giving ids 0..topk-1.  Then each decode
                variant's device and back-to-back time, its plain
                version's, a one-call library yardstick, and the bound (bytes over 3.35 TB/s, or the
                hash's integer operations once per id over the int32 rate);
  9. serve-quant — the web10m drill through RetrievalEngine with
                table_dtype int8 (and once each with fp8_e4m3, bfloat16,
                float32), and qwen1.5-0.5b at full width, bf16, 8 slots, 16
                mixed-length requests, continuous, with table_dtype int8,
                fp8_e4m3, bfloat16 and float32, and int8 with the
                precomputed hash matrix (bloom on_the_fly off); counts
                reset just before each run and read just after it: every
                decode step (and LM prefill) must launch that dtype's
                embed (token entry) and decode variants once each, the
                served ids and a served first token must equal the plain
                versions' on the same inputs; then the median decode step
                time of the int8 path beside the auto path's.
 10. kernels-decode — the full Eq. 3 decode (bloom_decode) over f32, bf16, int8
                and fp8 e4m3 logp at the LM vocabulary (B = 1 and 8, d =
                151,936, m = 30,208, k = 4), at an edge shape (B = 3, m =
                1,001, d = 5,003, k = 3, with values past fp8's range), at B =
                1, 3, 8, 13 x k = 1, 3, 4, 8 (m = MAX_M, d = 10,007), with an H
                and with logp rows off 16 bytes, bit-identical to its plain
                version (NaN in the same places; int8 as (sum q) * s), timed at
                B = 8 (reading the spec's H packed to 16 bits, as
                ops.bloom_decode passes it) in turns beside the f32 kernel on
                the narrow rows widened ahead (device, back to back, L2-cold);
                the card's bins of the spec's H (per call and cached) equal to
                bin_csr_plain's; the dense decode backward (H binned per call,
                then the CSR kernel) bit-identical to its plain version on a
                CPU copy, to the CSR decode caller on the spec's H and on an H
                without repeated indices, and to a second launch; the dense
                embedding backward at (T = 520, k = 4, D = 1024, m = 30,208)
                and edge cases bit-identical to its plain version on a CPU
                copy, to the CSR kernel and to a second launch; then the times,
                plain and library times (device and back to back) and bounds,
                and the dense decode backward's device time by kernel
                (torch.profiler);
 11. decode-grad — ops.bloom_decode on the last-position log_softmax of
                full-width qwen1.5-0.5b (seed 0, 8 prompts of 16 tokens), in
                f32 and with each table_dtype, differentiated under bwd_impl
                csr and dense with a seeded cotangent: counts reset before and
                read after each run (one forward and one backward launch, and
                under dense one binning), scores equal to the plain version's,
                the csr and dense gradients bit-identical, the quantized
                gradients straight-through;
 12. train-lm-dense — 8 full-width training steps through launch/train.run with
                bwd_impl="dense", twice, in turns with a CSR run: every step
                launches bloom_embed_bwd (and never bloom_csr), losses finite
                and falling, the first loss equal to the CSR run's, the first
                step's embedding gradient bit-identical to the CSR backward's
                off the rows of tokens that repeat a row (within 1e-6 there),
                and the median step walls side by side.
 13. train-retrieval — the recommender's train -> serve -> eval loop on
                CUDA, counts reset just before each run and read just
                after: the eval2k compression sweep of the bench twin
                (repro_torch.benchmarks.bench_retrieval: m/d 1/1, 1/2, 1/5,
                1/10, 300 steps each, trained and untrained towers served
                through RetrievalEngine), its integers equal to
                BENCH_retrieval.json's, its three gates held on the fresh
                values, one kernel launch per decode step; a crash at step
                120 (checkpoint every 50) and a resume equal to the straight
                run (params and history, rtol 1e-6); web10m (d = 10M, m =
                8,192, k = 2, hidden (64, 64)) trained 300 steps and served
                64 eval-seed requests on 8 slots in f32 and int8, each
                decode step one launch of its variant and the served top-k
                equal to the plain version's on the same tower outputs;
                then a train step's median wall, device time by kernel
                (torch.profiler), the GEMMs' and the optimizer's share, and
                the serve walls.
 14. paper — the paper's own benches (repro_torch.benchmarks.paper_phase) on
                CUDA at run.py's full budget (150 steps, scale 0.6) and the
                PAPER_TASKS widths: Fig. 1 on MSD (every m/d), Fig. 2 on MSD
                (k = 1, 2, 4, 8, 16), Fig. 3 on MSD, Table 3 at (MSD, 0.1)
                and (YC, 0.1), Table 5 at (MSD, 0.1), CountingBloomIO on
                MSD at m/d 0.1, PTB and CADE at Baseline and BE k = 4,
                m/d 0.2; every CSV row and trained run printed, counts
                reset just before and read just after: every Bloom-style
                evaluation's scores bit-equal to decode_scores on the same
                logits (the identity Baseline, HT, k = 16, the CBE H_out
                and CountingBloomIO among them), the bloom_decode launches
                equal to the Bloom evaluations, every score finite and in
                range, each at least 3x the same metric on seeded uniform
                random scores; then the kernel at every eval shape against
                its plain version, timed, and at MSD's (B = 600, m = 480,
                d = 2,400, k = 4) beside the plain version and
                F.embedding_bag, with its bound.  Re-executes itself with
                PYTHONHASHSEED=0 when that is unset (the tasks' data seed
                is hash(name)).
 15. serve-batch — qwen3-4b at full width (36 layers, d_model 2560, 32
                heads, GQA kv 8, head_dim 128, qk_norm, vocab 151,936, Bloom
                m = 30,208, k = 4, untied head, bf16, random weights drawn on
                the card from seed 0) through launch.serve.run (the
                whole-batch path: batch 4, prompt 32, gen 12, topk 8) twice,
                counts reset just before and read just after each run: the
                embed kernel's token entry and bloom_decode_topk launch gen
                times each (one prefill, gen - 1 decode steps), the replay
                gives the same ids; then the same loop walked through
                make_prefill_step and make_decode_step, every step's
                embedding bit-equal to the plain gather-sum and its top-k ids
                and scores bit-equal to bloom_decode_topk_plain, the ids equal
                to run's; then granite-8b and phi3-mini-3.8b at full width
                with the depth cut to 2 layers (embed D = 4096 / 3072, decode
                m 9,728 / 6,400 over d 49,152 / 32,064), the same walk and
                serve.generate with its counts; per arch the set-up seconds,
                the prefill ms and decode tok/s, and the decode-top-k kernel
                (B = 4) and the embed token kernel (T = 128 and 4) timed
                beside their plain versions, a library call and the bound;
 15b. serve-families — the MoE, SSM and hybrid archs at full width, bf16,
                random weights drawn on the card from seed 0 block by block
                (serve.build_model: the peak is the bf16 model plus one f32
                block, printed): deepseek-moe-16b (28 layers, d_model 2048,
                MHA 16 x 128, 64 routed experts top-6 + 2 shared,
                d_ff_expert 1408, vocab 102,400, m 20,480), olmoe-1b-7b
                (16 layers, 64 experts top-8, d_ff_expert 1024, vocab
                50,304, m 9,984), mamba2-1.3b (48 layers, d_inner 4096, 64
                heads of 64, d_state 128, chunk 256, vocab 50,280, m 9,984)
                and jamba-v0.1-52b with its depth cut to 8 of 32 layers
                (one period: attention at offset 4, no RoPE, GQA 32/8, 7
                Mamba layers of d_state 16, MoE 16 experts top-2 of
                d_ff_expert 14,336 on the odd layers; all 51.0 B params do
                not fit on one card); each through launch.serve.run
                twice as serve-batch (launch counts exactly gen each, the
                replay's ids equal), then the loop walked step by step
                with both kernels bit-equal to their plain versions and the
                walk's ids equal to run's; for the MoE archs the first MoE
                layer's capacity path held to moe_apply_reference at the
                prefill and at the first decode step on the tokens with no
                copy dropped (bf16 within 2^-5 x max |ref|, an f32 copy
                within 1e-4 x), with the dropped copies counted;
                olmoe-1b-7b also through the continuous Engine (8 slots, 16
                mixed-length requests) twice, mamba2-1.3b through the
                continuous and static Engine twice each (the same tokens
                every time), and a 300-token prompt through its prefill
                step, the first Mamba layer's last output held to
                mamba_reference (f32 copy within 1e-4 x max |ref|, bf16
                within 2^-5 x); every Engine launch held against its plain
                version as it happens (``held_to_plain``, as phase 16);
                per arch the set-up seconds and peak
                memory, serve.run's prefill ms and decode tok/s, a walked
                decode step's wall and device-busy share, and the two
                kernels timed at the arch's shapes;
 16. bench-serving — the serving bench twin's 16 rows
                (repro_torch.benchmarks.bench_serving; the mamba2-1.3b
                rows since the SSM family's port) on the card, held to
                BENCH_serving.json by its check_against, counts reset just
                before and
                read just after; every kernel launch of the run held
                against its plain version on the same tensors as it
                happens (``held_to_plain``), with as many checks as
                launches, kernel by kernel;
 17. examples — each example twin's main on the card at its smallest
                documented budget: quickstart, train_recommender --quick,
                cbe_cooccurrence, serve_bloom_lm (qwen3-4b smoke, gen 12)
                and train_lm_100m --steps 4 into a temporary checkpoint
                directory under build/, each with its launches, and each
                launch held against its plain version as in phase 16;
 18. parent (only with --parent DIR) — the parent commit's embed and decode
                kernels built from DIR beside this tree's, bit-identical,
                timed in turns (parent, change, change, parent): embed at
                T = 8, 14, 520 per storage (the kernels, and as called:
                the parent's double_hash, which synchronises the host,
                then its kernel), decode per storage at B = 1 and 8.
Then the card's name and power limit, one JSON line of kernel numbers, and
last ``{"ok": true, "device": {...}}``.  Any failure raises: the exit code
is not 0 and the last line is not printed.  Without a CUDA device, or
without the repository's src/ beside this file, it exits non-zero at once.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
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
    kernel = lambda: dt.bloom_decode_topk_cuda(logp, H, topk)  # noqa: E731
    kernel_partial = lambda: dt.bloom_decode_topk_cuda(  # noqa: E731
        logp, H, topk, partial)
    ms = time_ms(kernel, 50, 5)
    ms_partial = time_ms(kernel_partial, 50, 5)
    dev_ms = common.graph_time_ms(kernel, 20, 5)
    dev_ms_partial = common.graph_time_ms(kernel_partial, 20, 5)
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
          f"topk={topk}: kernel {dev_ms:.6f} ms on the device (graph) / "
          f"{ms:.6f} ms back to back (events), rows 0,3,7 "
          f"{dev_ms_partial:.6f} / {ms_partial:.6f} ms "
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


def phase_embed(torch, be):
    """bloom_embed's index entry (the (T, k) indices a caller hashed: the
    tests' and the dense backward checks' entry) against its plain
    version (timed beside the token entry in phase_embed_tokens)."""
    dev = torch.device("cuda")
    m, D, k = 30208, 1024, 4
    gen = torch.Generator().manual_seed(2)
    base = torch.randn(m, D, generator=gen)
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
        print(f"kernels: bloom_embed {dtype}: bit-identical on "
              f"{len(cases)} cases (T, D, k) = {cases}", flush=True)


def _cold_ms(torch, fn, calls=20):
    """Device ms of one ``fn()`` with the L2 cache cold: a 96 MB buffer
    (twice the 50 MB L2) is written before each call, and the call's own
    kernels are summed from a torch.profiler trace (the flush's kernel,
    a random fill, left out by name)."""
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(24 * 2 ** 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush.uniform_()
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        if (t > 0 and e.device_type == torch.autograd.DeviceType.CUDA
                and "distribution" not in e.key):
            us += t
    del flush
    return us / calls / 1e3


def _turns(torch, common, fns, cold=True, no_graph=()):
    """{name: (device ms (graph), back-to-back ms (events), L2-cold device
    ms (profiler) or None)} of each call, every call measured twice in
    turns (a, b, ..., b, a) and the two runs averaged, so that a drift of
    the card falls on every call alike.  The calls in ``no_graph`` (which
    synchronise the host, so no CUDA graph can hold them) get no device
    time (None)."""
    order = list(fns) + list(fns)[::-1]
    runs = {n: [] for n in fns}
    for n in order:
        f = fns[n]
        runs[n].append((None if n in no_graph else
                        common.graph_time_ms(f, 20, 5),
                        common.time_ms(f, 50, 3),
                        _cold_ms(torch, f) if cold else None))
    return {n: tuple(None if r[0][i] is None else (r[0][i] + r[1][i]) / 2
                     for i in range(3)) for n, r in runs.items()}


def _turns_line(times) -> str:
    def ms(x):
        return "-" if x is None else f"{x:.6f}"
    return ", ".join(f"{n} {ms(d)} / {ms(h)}" + ("" if c is None else
                                                  f" / {ms(c)}")
                     for n, (d, h, c) in times.items())


def _embed_specs(bloom, io_lib, configs):
    """The token entry's specs: the LM's (d = 151,936, m = 30,208, k = 4,
    on the fly), the same with k = 1, 2, 3, 8, each also with the
    precomputed hash matrix, and the identity spec over m ids."""
    import dataclasses
    lm = io_lib.vocab_spec(configs.get_config("qwen1.5-0.5b"))
    specs = {}
    for k in (1, 2, 3, 4, 8):
        for fly in (True, False):
            spec = dataclasses.replace(lm, k=k, on_the_fly=fly)
            specs[f"{'hash' if fly else 'H'} k={k}"] = spec
    specs["identity"] = bloom.identity_spec(lm.m)
    return lm, specs


def phase_embed_tokens(torch, be, common, quant):
    """The embed kernel's token entry (the main path's: tokens in,
    hashed in the kernel) against its plain version, bit for bit, with its
    (T, k) indices equal to spec.indices_for; ops.bloom_embed as one launch
    without a host sync; then its times beside the index entry's as the
    main path called it before (spec.indices_for, then the kernel), the
    plain version, F.embedding_bag, the bound and an empty kernel.
    Returns one JSON row per variant the main paths launch."""
    import torch.nn.functional as F
    from repro_torch import configs
    from repro_torch.core import bloom
    from repro_torch.kernels import ops
    from repro_torch.models import io as io_lib
    dev = torch.device("cuda")
    lm, specs = _embed_specs(bloom, io_lib, configs)
    m, D = lm.m, 1024
    gen = torch.Generator().manual_seed(9)
    base = torch.randn(m, D, generator=gen).to(dev)
    shapes = [(T, D) for T in (1, 8, 14, 520, 4096)] + [(14, 1000),
                                                        (14, 1020)]
    # (label, table_dtype or None for a table read as it is, out dtypes)
    storages = [("f32", None, torch.float32), ("bf16", None, torch.bfloat16)]
    storages += [(td, td, None) for td in quant.TABLE_DTYPES]
    n, errs = 0, {}    # the token entry's max |kernel - plain| by variant
    for T, Dc in shapes:
        for label, td, raw in storages:
            if td is None:
                tables = [(base[:, :Dc].to(raw).contiguous(), None, raw)]
            else:
                q, sc = quant.quantize_table(base[:, :Dc].contiguous(), td)
                tables = [(q, sc, od) for od in be.DTYPES]
            for q, sc, od in tables:
                for name, spec in specs.items():
                    tok = torch.randint(0, spec.d, (T,), generator=gen)
                    tok[:3] = torch.tensor([spec.d - 1, -1, 0])[:T]
                    tok = tok.to(dev).to(torch.int32 if n % 3 == 0
                                         else torch.int64)
                    if td is None:
                        got, idx = be.bloom_embed_tokens_cuda(
                            q, tok, spec, want_idx=True)
                    else:
                        got, idx = be.bloom_embed_tokens_quantized_cuda(
                            q, sc, tok, spec, od, want_idx=True)
                    torch.cuda.synchronize()
                    want, widx = be.bloom_embed_tokens_plain(q, sc, tok,
                                                             spec, od)
                    what = f"token entry {label}->{od} T={T} D={Dc} {name}"
                    _check(got.dtype == od and torch.equal(got, want),
                           f"{what}: kernel != plain version")
                    _check(torch.equal(idx, widx),
                           f"{what}: indices != spec.indices_for")
                    vname = be.token_variant_name(
                        spec, None if td is None else q.dtype)
                    errs[vname] = max(errs.get(vname, 0.0),
                                      _max_abs_err(got.float(),
                                                   want.float()))
                    n += 1
    print(f"kernels-embed: token entry bit-identical to the plain version "
          f"and its indices equal to spec.indices_for on {n} cases: "
          f"(T, D) = {shapes} x {len(storages)} storages (f32, bf16 read as "
          f"they are; {', '.join(quant.TABLE_DTYPES)} into f32 and bf16) x "
          f"specs {sorted(specs)}, tokens 0, d-1, -1 among random ones",
          flush=True)

    # ops.bloom_embed on the card: one launch, no double_hash op, no sync
    table = base.to(torch.bfloat16)
    tok = torch.randint(0, lm.d, (8, 1), generator=gen).to(dev)
    common.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            out = ops.bloom_embed(table, tok, lm)
            ops.bloom_ce(torch.randn(16, m, device=dev),
                         torch.randint(0, lm.d, (16,), device=dev), lm)
            bloom.encode(lm, torch.randint(-1, lm.d, (4, 8), device=dev))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    counts = dict(common.LAUNCHES)
    name = be.token_variant_name(lm)
    _check(counts.get(name) == 1 and be.NAME not in counts,
           f"ops.bloom_embed launched {counts}")
    split = _device_split(torch, lambda: ops.bloom_embed(table, tok, lm))
    _check(len(split) == 1 and "embed_fwd" in next(iter(split)),
           f"ops.bloom_embed ran kernels {split}")
    _check(torch.equal(out, ops.bloom_embed(table.cpu(), tok.cpu(),
                                            lm).to(dev)),
           "ops.bloom_embed on the card != on the CPU")
    print(f"kernels-embed: ops.bloom_embed: one launch ({counts}), one "
          f"kernel in its trace ({_split_line(split)}), no host sync under "
          f"set_sync_debug_mode('error') (nor ops.bloom_ce, bloom.encode), "
          f"equal to the CPU path", flush=True)

    # times: the token entry, the index entry as the main path called it
    # before, the plain version, F.embedding_bag; the bound and an empty
    # kernel, the launch floor
    lib = be._library()
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    floor = common.graph_time_ms(lambda: lib.bloom_embed_launch_floor(
        stream()), 50, 20)
    floor_host = common.time_ms(lambda: lib.bloom_embed_launch_floor(
        stream()), 200, 5)
    print(f"kernels-embed: an empty kernel: {floor:.6f} ms on the device "
          f"(graph) / {floor_host:.6f} ms back to back (events): the launch "
          f"floor", flush=True)
    rows = {}
    timed = [(td, lm) for td in (None, *quant.TABLE_DTYPES)]
    timed.append(("int8", specs["H k=4"]))
    for td, spec in timed:
        for T in (8, 14, 520):
            if td is None:
                q, sc, od = table, None, torch.bfloat16
            else:
                q, sc = quant.quantize_table(base, td)
                od = torch.bfloat16
            tok = torch.randint(0, spec.d, (T,), generator=gen).to(dev)
            idx = spec.indices_for(tok).contiguous()
            idx64 = idx.long()
            wide = q.to(torch.bfloat16) if td != "int8" else q.float()
            psw = None if sc is None else sc[idx64]
            if td is None:
                fns = {
                    "token kernel": lambda: be.bloom_embed_tokens_cuda(
                        q, tok, spec),
                    "index kernel": lambda: be.bloom_embed_cuda(q, idx),
                    "as called, before": lambda: be.bloom_embed_cuda(
                        q, spec.indices_for(tok).contiguous()),
                    "as called": lambda: ops.bloom_embed(
                        q, tok[:, None], spec)}
            else:
                fns = {
                    "token kernel":
                        lambda: be.bloom_embed_tokens_quantized_cuda(
                            q, sc, tok, spec, od),
                    "index kernel": lambda: be.bloom_embed_quantized_cuda(
                        q, sc, idx, od),
                    "as called, before":
                        lambda: be.bloom_embed_quantized_cuda(
                            q, sc, spec.indices_for(tok).contiguous(), od),
                    "as called": lambda: be.bloom_embed_tokens_fwd_quantized(
                        q, sc, tok, spec, od)}
            fns["plain"] = lambda: be.bloom_embed_tokens_plain(
                q, sc, tok, spec, od)
            fns["embedding_bag"] = lambda: F.embedding_bag(
                idx64, wide, mode="sum", per_sample_weights=psw)
            with torch.no_grad():
                times = _turns(torch, common, fns)
            n_rows = int(torch.unique(idx).numel())
            nbytes = be.min_bytes(n_rows, T, spec.k, D, q.element_size(),
                                  out_itemsize=2, row_scales=sc is not None,
                                  token_itemsize=8)
            bound_ms, by = _bound(nbytes, T * (spec.k - 1) * D
                                  + (T * spec.k * D if sc is not None else 0))
            vname = be.token_variant_name(
                spec, None if td is None else q.dtype)
            print(f"kernels-embed: {vname} -> bf16 T={T} m={m} D={D} "
                  f"k={spec.k}: device ms (graph) / back-to-back ms (events)"
                  f" / L2-cold device ms (profiler): {_turns_line(times)}; "
                  f"bound {bound_ms * 1e3:.4f} us ({by}, {nbytes} bytes), "
                  f"launch floor {floor * 1e3:.4f} us", flush=True)
            if T == 8:
                rows[vname] = {
                    "name": vname, "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/bloom_embed.cu",
                    "replaces": ("src/repro/kernels/bloom_embed.py:71"
                                 if td == "int8" else
                                 "src/repro/kernels/bloom_embed.py:294"),
                    "launches": None, "max_abs_err": errs[vname],
                    "ms": times["token kernel"][0],
                    "plain_ms": times["plain"][0], "bound_ms": bound_ms,
                    "bound_by": by,
                    "library_ms": times["embedding_bag"][0]}
    return list(rows.values())


def phase_serve_lm(torch, be, dt, common):
    """qwen1.5-0.5b at full width through Engine on CUDA; returns the
    launches of each kernel summed over the three runs."""
    from repro_torch import configs
    from repro_torch.core import bloom
    from repro_torch.kernels import ops
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
    embed_name = be.token_variant_name(io_lib.vocab_spec(cfg))
    totals, tokens = {embed_name: 0, dt.NAME: 0}, []
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
        for name in (embed_name, dt.NAME):
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
        _check(torch.equal(ops.bloom_embed(model.embed, prompt, spec)[0],
                           be.bloom_embed_plain(model.embed, idx)),
               "prompt embedding as served: token kernel != plain version")
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


def phase_embed_quant(torch, be, quant):
    """The quantized variants of bloom_embed's index entry against their
    plain version (timed beside the token entry in phase_embed_tokens)."""
    dev = torch.device("cuda")
    m, D, k = 30208, 1024, 4
    gen = torch.Generator().manual_seed(5)
    base = torch.randn(m, D, generator=gen).to(dev)
    cases = [(T, D, k) for T in (1, 8, 14, 4096)]
    cases += [(14, 1000, 4), (14, 1020, 4), (8, 1024, 1), (8, 1024, 3)]
    for td in quant.TABLE_DTYPES:
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
        print(f"kernels-quant: bloom_embed {td} into bf16 and f32: "
              f"bit-identical on {len(cases)} cases (T, D, k) = {cases}",
              flush=True)


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
    decode_topk_edges(torch, dt, quant, bloom, "web10m", rcfg.spec())
    decode_topk_edges(torch, dt, quant, bloom, "LM", lm_spec)
    return list(rows.values())


def decode_topk_edges(torch, dt, quant, bloom, label, spec):
    """The cases row tiles and live-row mapping can break, at one spec's
    shape, for each storage with the in-kernel hash and with the explicit
    H: B = 13 (more rows than a tile holds, a ragged last tile), one live
    row of 8, none, all but one, at topk 1, 8, 10 and 64, each bit-identical
    to the plain version, to the explicit-H kernel and to a second launch;
    and a constant logp (a full tie) returning ids 0..topk-1."""
    dev = torch.device("cuda")
    H = bloom.cached_hash_matrix(spec, dev)
    hs = (spec.d, spec.k, spec.seed)
    gen = torch.Generator().manual_seed(13)
    logp = torch.log_softmax(torch.randn(13, spec.m, generator=gen), -1)
    logp = logp.to(dev)
    const = torch.full((13, spec.m), -math.log(spec.m), device=dev)
    masks = {"B=13": None}
    for name, live in (("one of 8", [3]), ("none of 8", []),
                       ("all but one of 8", [0, 1, 2, 3, 4, 6, 7])):
        masks[name] = torch.zeros(8, dtype=torch.bool, device=dev)
        masks[name][live] = True
    n = 0
    for td in quant.TABLE_DTYPES:
        for what, act in masks.items():
            B = 13 if act is None else 8
            q, s = quant.quantize_table(logp[:B].contiguous(), td)
            for topk in (1, 8, 10, 64):
                kv, ki = dt.bloom_decode_topk_cuda(q, None, topk, act, s, hs)
                rv, ri = dt.bloom_decode_topk_cuda(q, None, topk, act, s, hs)
                ev, ei = dt.bloom_decode_topk_cuda(q, H, topk, act, s)
                torch.cuda.synchronize()
                pv, pi = dt.bloom_decode_topk_plain(q, H, topk, act, s)
                case = f"{label} {td} {what} topk={topk}"
                _check(torch.equal(ki, pi) and torch.equal(kv, pv),
                       f"{case}: in-kernel hash != plain version")
                _check(torch.equal(ei, pi) and torch.equal(ev, pv),
                       f"{case}: explicit H != plain version")
                _check(torch.equal(ri, ki) and torch.equal(rv, kv),
                       f"{case}: a second launch differs")
                n += 1
        q, s = quant.quantize_table(const, td)
        for topk in (8, 64):
            want = torch.arange(topk, dtype=torch.int32,
                                device=dev).expand(13, topk)
            for h, spec_arg in ((None, hs), (H, None)):
                _, ids = dt.bloom_decode_topk_cuda(q, h, topk, None, s,
                                                   spec_arg)
                _check(torch.equal(ids, want),
                       f"{label} {td} full tie topk={topk}: ids != "
                       "0..topk-1")
    print(f"kernels-quant: bloom_decode_topk {label} edge cases: {n} cases "
          f"(each storage x B=13 / one / none / all but one of 8 live x "
          f"topk 1, 8, 10, 64) bit-identical to plain, to the explicit-H "
          f"kernel and to a second launch; full ties give ids 0..topk-1",
          flush=True)


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
        want = {be.token_variant_name(io_lib.vocab_spec(qcfg), sd):
                st.prefills + st.decode_steps,
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
                be.bloom_embed_tokens_quantized_cuda(
                    qt, st_, prompt.reshape(-1), spec, torch.bfloat16)[0],
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
    H16 = bloom.cached_packed_hash_matrix(spec, dev)
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
    # the row tiles' cases: B = 1, 3, 8, 13 (a ragged last tile),
    # k = 1, 3, 4, 8, m = MAX_M (the largest tile), d = 10,007 (not a
    # multiple of 4: the last ids scalar); an H and logp rows off 16 bytes
    mc = bd.MAX_M
    for B in (1, 3, 8, 13):
        for kc in (1, 3, 4, 8):
            cases.append((f"B={B} k={kc} m={mc} d=10007",
                          torch.log_softmax(3 * torch.randn(
                              B, mc, generator=gen), -1),
                          torch.randint(0, mc, (10_007, kc), generator=gen,
                                        dtype=torch.int32).to(dev)))
    flat_H = torch.randint(0, m, (4 * 5003 + 1,), generator=gen,
                           dtype=torch.int32).to(dev)
    cases.append(("H off 16 bytes", logp8[:3], flat_H[1:].view(5003, 4)))
    rows, Hl = [], H.long()
    for td in (None, "bfloat16", "int8", "fp8_e4m3"):
        err = 0.0
        for label, lp, h in cases + [("rows off 16 bytes", None, H)]:
            if lp is None:   # logp rows of m + 1 elements from offset 1
                lp = torch.empty(3 * (m + 1) + 1, device=dev)[1:].view(
                    3, m + 1)
                lp.copy_(torch.log_softmax(torch.randn(
                    3, m + 1, generator=gen), -1))
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
        # the kernel reads the spec's H packed to 16 bits, as
        # ops.bloom_decode passes it
        fns = {"kernel": lambda: bd.bloom_decode_cuda(q, H, s, H16)}
        if td is not None:
            # the narrow rows widened ahead to f32: the f32 kernel's one row
            # a block against this storage's tile of 4 / itemsize rows
            wide_rows = q.float().contiguous()
            fns["kernel on rows widened to f32"] = (
                lambda: bd.bloom_decode_cuda(wide_rows, H, None, H16))
        fns["library"] = library
        times = _turns(torch, common, fns)
        plain_ms = common.time_ms(lambda: bd.bloom_decode_plain(q, H, s),
                                  20, 3)
        itemsize = quant.table_itemsize(td)
        nbytes = bd.min_bytes(8, m, d, k, itemsize, s is not None,
                              index_bytes=2)
        bound_ms, by = _bound(nbytes, 8 * d * (k - 1)
                              + (8 * d if s is not None else 0))
        pl = bd.plan(8, m, d, k, itemsize, common.sm_count(dev))
        print(f"kernels-decode: {name} B=8 m={m} d={d} k={k}: bit-identical "
              f"to plain on {[c[0] for c in cases]} and rows off 16 bytes; "
              f"{pl}; device ms (graph) / back-to-back ms (events) / L2-cold "
              f"device ms (profiler): {_turns_line(times)}; plain "
              f"{plain_ms:.6f} ms (events); bound "
              f"{bound_ms * 1e3:.3f} us ({by}, {nbytes} bytes)", flush=True)
        times["plain"] = (plain_ms, plain_ms, None)
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


PARENT_KERNELS = ("bloom_embed", "bloom_decode")


def decode_topk_sweep_shapes(torch, dt, quant, bloom, get_retrieval_config):
    """bloom_decode_topk at the eval2k sweep's decode shapes (d = 2,000,
    m = 2,000 / 1,000 / 400 / 200, k = 2, topk = 10, B = 1 and 8, and rows
    0, 3, 7 of 8 live): f32 with H, int8 with the in-kernel hash and int8
    with H, each bit-identical to its plain version, the two int8 kernels
    to each other; far smaller than web10m and the LM shapes (a d below a
    block's share, m = 200).  Returns the largest |kernel - plain|."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(9)
    partial = torch.zeros(8, dtype=torch.bool, device=dev)
    partial[[0, 3, 7]] = True
    err, n = 0.0, 0
    for m in (2000, 1000, 400, 200):
        spec = get_retrieval_config("eval2k", m=m).spec()
        H = bloom.cached_hash_matrix(spec, dev)
        hs = (spec.d, spec.k, spec.seed)
        for B in (1, 8):
            logp = torch.log_softmax(
                3 * torch.randn(B, m, generator=gen), -1).to(dev)
            q, s = quant.quantize_table(logp, "int8")
            for act in [None] + ([partial] if B == 8 else []):
                got = {}
                for label, args in (("f32 H", (logp, H, 10, act)),
                                    ("int8 hash", (q, None, 10, act, s, hs)),
                                    ("int8 H", (q, H, 10, act, s))):
                    kv, ki = dt.bloom_decode_topk_cuda(*args)
                    torch.cuda.synchronize()
                    pv, pi = dt.bloom_decode_topk_plain(*args)
                    _check(torch.equal(ki, pi) and torch.equal(kv, pv),
                           f"eval2k m={m} B={B} {label} active="
                           f"{act is not None}: kernel != plain version")
                    err = max(err, _max_abs_err(kv, pv))
                    got[label] = (kv, ki)
                    n += 1
                _check(all(torch.equal(a, b) for a, b in zip(
                    got["int8 hash"], got["int8 H"])),
                    f"eval2k m={m} B={B}: int8 hash kernel != int8 H kernel")
    print(f"kernels: bloom_decode_topk at the eval2k sweep's shapes (d=2000, "
          f"m=2000/1000/400/200, k=2, topk=10, B=1 and 8, rows 0,3,7 of 8): "
          f"f32 with H, int8 hash, int8 H bit-identical to the plain version "
          f"on {n} cases", flush=True)
    return err


def phase_train_retrieval(torch, dt, common, bloom, quant, retrieval,
                          get_retrieval_config):
    """The recommender's train -> serve -> eval loop on the card: the
    eval2k compression sweep of the bench twin, a crash/resume drill, and
    web10m trained and served f32 and int8.  Returns the decode-top-k
    launches by kernel name, summed over the runs."""
    import dataclasses
    import numpy as np
    from repro_torch.benchmarks import bench_retrieval as bench
    from repro_torch.launch import steps as steps_lib
    from repro_torch.optim import optimizers as opt_lib
    from repro_torch.serving.loadgen import (RetrievalLoadSpec,
                                             retrieval_workload)
    from repro_torch.train import retrieval_trainer as rt
    from repro_torch.train import trainer as trainer_lib
    dev = torch.device("cuda")
    totals = {}

    def read_counts():
        torch.cuda.synchronize()
        counts = dict(common.LAUNCHES)
        for n, c in counts.items():
            totals[n] = totals.get(n, 0) + c
        return counts

    # the bench twin's sweep: 4 points x (300 steps, trained and untrained
    # serves of 64 requests on 8 slots, each decode step one launch)
    torch.cuda.synchronize()
    common.reset_launches()
    t0 = time.perf_counter()
    rows = bench.run_sweep(dev)
    wall = time.perf_counter() - t0
    counts = read_counts()
    want = 2 * sum(r["decode_steps"] for r in rows)
    _check(counts == {dt.NAME: want},
           f"train-retrieval sweep: launches {counts}, want {want} "
           f"{dt.NAME} (one per decode step of each serve)")
    failures = bench.check_against(rows)
    _check(not failures, f"train-retrieval sweep: {failures}")
    for r in rows:
        print(f"train-retrieval: {r['name']} d={r['d']} m={r['m']} "
              f"steps={r['steps']} pairs={r['n_train_pairs']} "
              f"n_evaluated={r['n_evaluated']} decode_steps="
              f"{r['decode_steps']} final_loss={r['final_loss']} map="
              f"{r['map']} rr={r['rr']} untrained_map={r['untrained_map']} "
              f"map_int8={r['map_int8']} int8_retention="
              f"{r['int8_retention']}", flush=True)
    print(f"train-retrieval: eval2k sweep (bench twin) on CUDA in "
          f"{wall:.3f} s: integers equal BENCH_retrieval.json, the three "
          f"gates hold on fresh values, {want} kernel launches = decode "
          "steps of the 8 serves", flush=True)

    # crash/resume drill at eval2k 1/5: train_fault@120, checkpoint every 50
    rcfg = get_retrieval_config("eval2k")
    tc = rt.default_train_config(steps=300, checkpoint_every=50)
    base = Path(__file__).resolve().parent / "build" / "chip_smoke_retrieval"
    shutil.rmtree(base, ignore_errors=True)
    try:
        straight, r1 = rt.train_retrieval(
            rcfg, tc, checkpoint_dir=str(base / "a"), device=dev)
        try:
            rt.train_retrieval(rcfg, tc, checkpoint_dir=str(base / "b"),
                               failpoints="train_fault@120", device=dev)
            raise AssertionError("train_fault@120 did not fire")
        except RuntimeError as e:
            _check("induced fault at step 120" in str(e), str(e))
        resumed, r3 = rt.train_retrieval(
            rcfg, tc, checkpoint_dir=str(base / "b"), device=dev)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    _check([h["step"] for h in r3["history"]] ==
           [h["step"] for h in r1["history"]] == list(range(10, 301, 10)),
           "drill: history steps")
    np.testing.assert_allclose([h["loss"] for h in r3["history"]],
                               [h["loss"] for h in r1["history"]], rtol=1e-6)
    for a, b in zip(straight.parameters(), resumed.parameters()):
        np.testing.assert_allclose(b.detach().cpu().numpy(),
                                   a.detach().cpu().numpy(), rtol=1e-6)
    print(f"train-retrieval: eval2k crash at step 120 (checkpoint every 50) "
          f"and resume: params and the {len(r3['history'])}-entry history "
          f"equal the straight 300-step run within rtol 1e-6 (final loss "
          f"{r3['history'][-1]['loss']})", flush=True)

    # full width: web10m trained, then served f32 and int8 through the kernel
    rcfg = get_retrieval_config("web10m")
    tc = rt.default_train_config(steps=300)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tower, result = rt.train_retrieval(rcfg, tc, device=dev)
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t0
    hist = result["history"]
    _check(result["steps"] == 300 and all(
        math.isfinite(h["loss"]) for h in hist), "web10m: training")
    _check(hist[-1]["loss"] < hist[0]["loss"],
           f"web10m: loss did not fall {[h['loss'] for h in hist]}")
    wl = retrieval_workload(RetrievalLoadSpec(
        n_requests=64, catalog=rcfg.d, c_max=rcfg.c_max, rate=2.0, seed=1))
    prefill = steps_lib.make_retrieval_prefill_step(rcfg)
    rows_logits = []
    for r in wl:
        items = torch.full((1, rcfg.c_max), -1, dtype=torch.int32)
        items[0, :r.prompt_len] = torch.as_tensor(r.prompt)
        rows_logits.append(prefill(tower, items.to(dev))[0])
    logp = torch.log_softmax(torch.stack(rows_logits).float(), -1)
    _check(tuple(logp.shape) == (len(wl), rcfg.m)
           and bool(torch.isfinite(logp).all()), "web10m: tower output")
    spec = rcfg.spec()
    serves = {}                 # table_dtype -> (wall s, decode steps)
    for td in ("auto", "int8"):
        qcfg = dataclasses.replace(rcfg, table_dtype=td)
        engine = retrieval.RetrievalEngine(qcfg, tower, n_slots=8)
        torch.cuda.synchronize()
        common.reset_launches()
        t0 = time.perf_counter()
        served, st = engine.run([r.fresh_copy() for r in wl])
        torch.cuda.synchronize()
        serves[td] = (time.perf_counter() - t0, st.decode_steps)
        counts = read_counts()
        name = (dt.NAME if td == "auto"
                else dt.variant_name(quant.storage_dtype(td), True))
        _check(counts == {name: st.decode_steps},
               f"web10m {td}: launches {counts} for {st.decode_steps} "
               "decode steps")
        if td == "auto":
            pv, pi = dt.bloom_decode_topk_plain(
                logp, bloom.cached_hash_matrix(spec, dev), rcfg.topk)
        else:
            q, s = quant.quantize_table(logp, td)
            pv, pi = dt.bloom_decode_topk_plain(
                q, None, rcfg.topk, None, s, (spec.d, spec.k, spec.seed))
        for i, r in enumerate(wl):
            _check(served[r.rid].done and not served[r.rid].rejected
                   and served[r.rid].topk_ids == pi[i].tolist()
                   and served[r.rid].topk_scores == pv[i].tolist(),
                   f"web10m {td} rid {r.rid}: served != plain version")

    # one train step at web10m: host wall, device time by kernel, and the
    # optimizer's update alone on the same tensors
    loss_fn = rt.make_retrieval_loss(rcfg)
    tx = trainer_lib.make_optimizer(tc)
    step = trainer_lib.make_train_step(loss_fn, tx)
    p, q = rt.make_retrieval_dataset(rcfg, 64, seed=2)
    batch = {"p": torch.from_numpy(p).to(dev),
             "q": torch.from_numpy(q).to(dev)}
    state = [tx.init(dict(tower.named_parameters()))]

    def one_step():
        state[0], metrics = step(tower, state[0], batch)
        return metrics

    def median_wall_ms(fn, n):
        for _ in range(5):
            fn()
        walls = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(walls))

    params = dict(tower.named_parameters())
    grads = {n: torch.randn_like(t) for n, t in params.items()}

    def update_only():          # the optimizer's update on fixed gradients
        return opt_lib.apply_updates(
            params, tx.update(grads, state[0], params)[0])

    step_ms = median_wall_ms(one_step, 50)
    split = _device_split(torch, one_step, calls=20)
    busy_us = sum(split.values())
    gemm_us = sum(us for n, us in split.items() if any(
        t in n.lower() for t in ("gemm", "cutlass", "sm90_", "xmma")))
    opt_ms = median_wall_ms(update_only, 50)
    opt_us = sum(_device_split(torch, update_only, calls=20).values())
    print(f"train-retrieval: web10m d={rcfg.d} m={rcfg.m} k={rcfg.k} hidden "
          f"{rcfg.hidden}, batch 64, 300 steps: training wall "
          f"{train_wall:.3f} s with set-up, loss {hist[0]['loss']:.6f} -> "
          f"{hist[-1]['loss']:.6f}; a train step: median wall "
          f"{step_ms:.6f} ms (host clock, synchronised, 50 steps), device "
          f"busy {busy_us:.3f} us ({busy_us / 1e3 / step_ms:.4f} of the "
          f"step; torch.profiler, 20 steps), GEMMs {gemm_us:.3f} us; the "
          f"optimizer's update alone {opt_ms:.6f} ms wall, {opt_us:.3f} us "
          f"on the device; {len(split)} kernels: {_split_line(split)}",
          flush=True)
    print(f"train-retrieval: web10m trained tower served 64 eval-seed "
          f"requests on 8 slots: f32 {serves['auto'][1]} decode steps in "
          f"{serves['auto'][0]:.6f} s, int8 {serves['int8'][1]} decode "
          f"steps in {serves['int8'][0]:.6f} s (walls, host clock); served "
          f"top-{rcfg.topk} == plain version on the same tower outputs",
          flush=True)
    return totals


def phase_paper(torch, bd, common):
    """The paper's benches on the card (``repro_torch.benchmarks.
    paper_phase``): Figs. 1-3, Tables 3 and 5, counting Bloom, PTB and
    CADE at their full budget and widths, every CSV row printed; the
    Eq. 3 kernel route bit-equal to decode_scores at every evaluated
    shape; the bloom_decode launches equal to the Bloom evaluations; the
    range and "learns" gates; then the kernel at each eval shape and, at
    MSD's (B = 600, m = 480, d = 2,400, k = 4), the plain version and
    F.embedding_bag.  Returns the bloom_decode launches of the runs."""
    import torch.nn.functional as F
    from repro_torch.benchmarks import paper_phase as pp
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    common.reset_launches()
    rows, runs = pp.run(dev, out=lambda line: print(f"paper: {line}",
                                                    flush=True))
    torch.cuda.synchronize()
    counts = dict(common.LAUNCHES)
    wall = time.perf_counter() - t0
    for r in runs:
        print(pp.run_line(r, pp.chance_score(r.task, pp.SCALE)), flush=True)
    failures = pp.check(runs, pp.SCALE, on_card=True)
    _check(not failures, "paper: " + "; ".join(failures))
    evals = sum(r.evals for r in runs)
    _check(counts == {bd.NAME: evals},
           f"paper: launched {counts}, want {{{bd.NAME!r}: {evals}}}")
    # the kernel route held bit-equal on each kind of Eq. 3 decode
    kinds = {"identity Baseline": lambda r: r.method == "Baseline",
             "HT (k = 1)": lambda r: r.method == "HT",
             "k = 16": lambda r: r.k == 16,
             "CBE H_out": lambda r: r.method == "CBE",
             "CountingBloomIO": lambda r: r.method == "CBE-count"}
    for kind, pick in kinds.items():
        _check(any(pick(r) and r.decode_equal for r in runs),
               f"paper: no bit-equal Eq. 3 evaluation of the {kind}")
    margins = [r.score / pp.chance_score(r.task, pp.SCALE) for r in runs]
    fig3 = {kind: ", ".join(f"{n[len('fig3.MSD.'):-len(kind)]} {d:.4f}"
                            for n, _, d in rows
                            if n.startswith("fig3.") and n.endswith(kind))
            for kind in (".train", ".eval")}
    print(f"paper: fig3 MSD train ratio by m/d: {fig3['.train']}; eval "
          f"ratio: {fig3['.eval']}", flush=True)
    print(f"paper: {len(runs)} runs, {len(rows)} rows, {evals} bloom_decode "
          f"launches, every Eq. 3 evaluation bit-equal to decode_scores, "
          f"least margin over chance {min(margins):.2f}x (gate "
          f"{pp.GATE}x), wall {wall:.3f} s", flush=True)

    # the kernel at every eval shape the runs gave it; at MSD's, its plain
    # version and one library call beside it
    gen = torch.Generator().manual_seed(11)
    shapes = sorted({(r.eval_shape[0], r.m, r.eval_shape[1], r.k)
                     for r in runs if r.evals})
    for B, m, d, k in shapes:
        logp = torch.log_softmax(3 * torch.randn(B, m, generator=gen),
                                 -1).to(dev)
        H = torch.randint(0, m, (d, k), generator=gen,
                          dtype=torch.int32).to(dev)
        H16 = bd.pack_h(H)
        got = bd.bloom_decode_cuda(logp, H, packed=H16)
        torch.cuda.synchronize()
        _check(torch.equal(got, bd.bloom_decode_plain(logp, H)),
               f"paper: bloom_decode B={B} m={m} d={d} k={k}: kernel != "
               "plain version")
        fns = {"kernel": lambda: bd.bloom_decode_cuda(logp, H, packed=H16)}
        others = {}
        if (B, m, d, k) == (600, 480, 2400, 4):
            Hl = H.long()
            fns["library"] = lambda: F.embedding_bag(
                Hl, logp.t().contiguous(), mode="sum").t()
            others["plain"] = lambda: bd.bloom_decode_plain(logp, H)
        times = _times_kernels(common, fns, others)
        nbytes = bd.min_bytes(B, m, d, k, index_bytes=2)
        bound_ms, by = _bound(nbytes, B * d * (k - 1))
        print(f"paper: bloom_decode eval shape B={B} m={m} d={d} k={k}: "
              f"device ms (graph) / back-to-back ms (events; plain: events "
              f"only): {_times_line(times)}, bound {bound_ms * 1e3:.3f} us "
              f"({by}, {nbytes} bytes)", flush=True)
    return evals


SERVE_BATCH = (4, 32, 12, 8)     # batch, prompt, gen, topk: the example's


def _walk_batch(torch, be, dt, cfg, model, prompts, gen, topk,
                phase="serve-batch", around=None):
    """serve.generate's whole-batch loop walked step by step through
    make_prefill_step and make_decode_step, holding at every step the
    embedding as the model computes it (the token kernel) bit-equal to
    the plain gather-sum, and the decode-top-k kernel's ids and scores
    bit-equal to bloom_decode_topk_plain on the same logp.  ``around(label,
    step)``, if given, runs the prefill and the first decode step (it
    calls ``step()`` and returns its result), so a phase can hold a layer
    inside them.  Returns the (B, gen) ids."""
    from repro_torch.core import bloom
    from repro_torch.kernels import ops
    from repro_torch.launch import serve, steps as steps_lib
    from repro_torch.models import io as io_lib
    from repro_torch.models import transformer as tf
    dev = model.embed.device
    spec = io_lib.vocab_spec(cfg)
    H = bloom.cached_hash_matrix(spec, dev)
    B, S = prompts.shape
    prefill = steps_lib.make_prefill_step(cfg)
    decode = steps_lib.make_decode_step(cfg, topk, dev)

    def check_embed(tokens, label):
        with torch.inference_mode():
            got = ops.bloom_embed(model.embed, tokens, spec)
            want, _ = be.bloom_embed_tokens_plain(
                model.embed, None, tokens.reshape(-1), spec, model.embed.dtype)
        _check(torch.equal(got.reshape(want.shape), want),
               f"{cfg.name} {label}: embedding kernel != plain gather-sum")

    def check_decode(logits, scores, ids, label):
        _check(bool(torch.isfinite(logits).all()),
               f"{cfg.name} {label}: non-finite logits")
        logp = torch.log_softmax(logits.float(), -1)
        pv, pi = dt.bloom_decode_topk_plain(logp, H, topk)
        _check(torch.equal(ids, pi) and torch.equal(scores, pv),
               f"{cfg.name} {label}: decode-top-k kernel != plain version")

    def run(label, step):
        return step() if around is None else around(label, step)

    tokens = torch.as_tensor(prompts, device=dev)
    check_embed(tokens, "prefill")
    pre = run("prefill", lambda: prefill(model, tokens))
    caches = serve.pad_caches_to(
        pre["caches"], tf.init_lm_cache(cfg, B, S + gen, device=dev))
    with torch.inference_mode():
        scores, ids = io_lib.recover_topk(cfg, pre["last_logits"], topk=topk)
    check_decode(pre["last_logits"], scores, ids, "prefill")
    token, out_ids = ids[:, :1], [ids[:, :1]]
    for t in range(gen - 1):
        check_embed(token, f"decode step {t + 1}")
        step = lambda: decode(model, token, caches, S + t)  # noqa: E731
        out = run("decode step 1", step) if t == 0 else step()
        caches = out["caches"]
        check_decode(out["logits"][:, 0], out["topk_scores"],
                     out["topk_ids"], f"decode step {t + 1}")
        token = out["topk_ids"][:, :1]
        out_ids.append(token)
    # one more decode step at the last position, repeated: its wall (host
    # clock, synchronised) beside its device time by kernel (profiler)
    step = lambda: decode(model, token, caches, S + gen - 1)  # noqa: E731
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 5 * 1e3
    split = _device_split(torch, step, calls=5)
    busy_ms = sum(split.values()) / 1e3
    top = dict(sorted(split.items(), key=lambda kv: -kv[1])[:6])
    print(f"{phase}: {cfg.name} decode step (B = {B}): wall "
          f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({busy_ms / wall_ms:.4f}), top kernels: {_split_line(top)}",
          flush=True)
    return torch.cat(out_ids, 1).cpu().numpy()


def _time_batch_kernels(torch, be, dt, common, cfg, model, B, S, topk,
                        phase="serve-batch"):
    """The decode-top-k kernel at (B, m, d) and the embed token kernel at
    the prefill's and a decode step's T on this arch's table, beside their
    plain versions, one library call and their bounds."""
    import torch.nn.functional as F
    from repro_torch.core import bloom
    from repro_torch.models import io as io_lib
    dev = model.embed.device
    spec = io_lib.vocab_spec(cfg)
    H = bloom.cached_hash_matrix(spec, dev)
    (d, k), m = H.shape, spec.m
    gen = torch.Generator().manual_seed(13)
    logp = torch.log_softmax(torch.randn(B, m, generator=gen), -1).to(dev)
    Hl = H.long()
    times = _times_kernels(common, {
        "kernel": lambda: dt.bloom_decode_topk_cuda(logp, H, topk),
        "torch.topk": lambda: torch.topk(logp[:, Hl].sum(-1), topk)}, {
        "plain": lambda: dt.bloom_decode_topk_plain(logp, H, topk)})
    nbytes = dt.min_bytes(B, B, m=m, d=d, k=k, topk=topk)
    bound_ms, by = _bound(nbytes, d * B * (k - 1))
    print(f"{phase}: {cfg.name} bloom_decode_topk B={B} m={m} d={d} "
          f"k={k} topk={topk}: device ms (graph) / back-to-back ms (events;"
          f" plain: events only): {_times_line(times)}, bound "
          f"{bound_ms * 1e3:.3f} us ({by}, {nbytes} bytes)", flush=True)
    table = model.embed
    D = table.shape[1]
    for T in (B * S, B):
        tok = torch.randint(0, spec.d, (T,), generator=gen).to(dev)
        idx64 = spec.indices_for(tok).long()
        with torch.no_grad():
            times = _times_kernels(common, {
                "token kernel": lambda: be.bloom_embed_tokens_cuda(
                    table, tok, spec),
                "embedding_bag": lambda: F.embedding_bag(idx64, table,
                                                         mode="sum")}, {
                "plain": lambda: be.bloom_embed_tokens_plain(
                    table, None, tok, spec, table.dtype)})
        nbytes = be.min_bytes(int(torch.unique(idx64).numel()), T, k, D,
                              table.element_size(), token_itemsize=8)
        bound_ms, by = _bound(nbytes, T * (k - 1) * D)
        print(f"{phase}: {cfg.name} {be.token_variant_name(spec)} "
              f"{table.dtype} T={T} m={m} D={D} k={k}: device ms (graph) / "
              f"back-to-back ms (events; plain: events only): "
              f"{_times_line(times)}, bound {bound_ms * 1e3:.4f} us ({by}, "
              f"{nbytes} bytes)", flush=True)


def _counted(torch, be, dt, common, phase, totals, label, cfg, fn):
    """Run ``fn`` (a whole-batch generation of SERVE_BATCH's shape, which
    returns the (B, gen) ids) with the counts reset just before and read
    just after: it must launch the embed kernel's token entry and
    bloom_decode_topk ``gen`` times each (one prefill, gen - 1 decode
    steps), and nothing else.  Adds the counts to ``totals``; returns the
    ids."""
    from repro_torch.models import io as io_lib
    B, S, gen, topk = SERVE_BATCH
    torch.cuda.synchronize()
    common.reset_launches()
    ids = fn()
    torch.cuda.synchronize()
    counts = dict(common.LAUNCHES)
    embed_name = be.token_variant_name(io_lib.vocab_spec(cfg))
    _check(counts == {embed_name: gen, dt.NAME: gen},
           f"{phase}: {label}: launched {counts}, want {gen} each "
           f"of {embed_name} and {dt.NAME}")
    _check(ids.shape == (B, gen) and ((0 <= ids) & (ids < cfg.vocab))
           .all(), f"{phase}: {label}: ids {ids}")
    for n, c in counts.items():
        totals[n] = totals.get(n, 0) + c
    print(f"{phase}: {label}: launches {counts}", flush=True)
    return ids


def phase_serve_batch(torch, be, dt, common):
    """qwen3-4b at full width through launch.serve.run twice, counts reset
    just before and read just after each run; then the same loop walked
    through make_prefill_step and make_decode_step with the kernels held
    to their plain versions at every step; then granite-8b and
    phi3-mini-3.8b at full width, depth cut to 2 layers, the same walk and
    serve.generate with its counts.  Returns the launches of the runs by
    kernel."""
    import dataclasses
    import numpy as np
    from repro_torch import configs
    from repro_torch.launch import serve
    dev = torch.device("cuda")
    B, S, gen, topk = SERVE_BATCH
    totals = {}

    def counted(label, cfg, fn):
        return _counted(torch, be, dt, common, "serve-batch", totals, label,
                        cfg, fn)

    cfg = configs.get_config("qwen3-4b")
    _check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.qk_norm, cfg.vocab, cfg.m_vocab,
            cfg.bloom.k, cfg.tie_embeddings, cfg.dtype) ==
           (36, 2560, 32, 8, 128, True, 151936, 30208, 4, False,
            "bfloat16"), f"qwen3-4b config {cfg}")
    runs = [counted(f"qwen3-4b serve.run {i + 1}", cfg, lambda: serve.run(
        "qwen3-4b", batch=B, prompt_len=S, gen=gen, topk=topk, full=True,
        device=dev)) for i in range(2)]
    _check(np.array_equal(runs[0], runs[1]),
           "serve-batch: the replay of serve.run gave other ids")

    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, size=(B, S), dtype=np.int32)
    for arch in ("qwen3-4b", "granite-8b", "phi3-mini-3.8b"):
        cfg = configs.get_config(arch)
        if arch != "qwen3-4b":
            cfg = dataclasses.replace(cfg, num_layers=2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = serve.build_model(cfg, 0, dev)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        reduced = configs.get_config(arch).num_layers != cfg.num_layers
        print(f"serve-batch: {arch} {cfg.num_layers}L"
              + (f" (reduced from {configs.get_config(arch).num_layers})"
                 if reduced else "") +
              f" d_model {cfg.d_model} heads {cfg.num_heads}/"
              f"{cfg.num_kv_heads} head_dim {cfg.resolved_head_dim} d_ff "
              f"{cfg.d_ff} qk_norm {cfg.qk_norm} vocab {cfg.vocab} m "
              f"{cfg.m_vocab} k {cfg.bloom.k}: {n_params:,} params "
              f"{next(model.parameters()).dtype} drawn on the card, set-up "
              f"{setup:.3f} s", flush=True)
        walked = _walk_batch(torch, be, dt, cfg, model, prompts, gen, topk)
        if arch == "qwen3-4b":
            _check(np.array_equal(walked, runs[0]),
                   "serve-batch: the step walk's ids != serve.run's")
        else:
            res = {}

            def gen_ids():
                res["ids"], res["pre"], res["dec"] = serve.generate(
                    cfg, model, prompts, gen, topk)
                return res["ids"]

            ids = counted(f"{arch} serve.generate", cfg, gen_ids)
            _check(np.array_equal(walked, ids),
                   f"serve-batch: {arch}: the step walk's ids != "
                   "serve.generate's")
            print(f"prefill {S} toks x{B}: {res['pre'] * 1e3:.0f} ms")
            print(f"decode  {gen - 1} steps: {res['dec'] * 1e3:.0f} ms "
                  f"({(gen - 1) * B / max(res['dec'], 1e-9):.0f} tok/s)")
        print(f"serve-batch: {arch}: every step's embedding and top-k ids "
              f"and scores bit-equal to the plain versions, logits finite; "
              f"{len(np.unique(walked))} distinct ids of {walked.size}; ids "
              f"(first seq) {walked[0].tolist()}", flush=True)
        _time_batch_kernels(torch, be, dt, common, cfg, model, B, S, topk)
        del model
        torch.cuda.empty_cache()
    return totals


# the MoE, SSM and hybrid archs at full width, each as (depth run: None
# for all its layers, the widths it must have): layers, d_model, (heads,
# kv heads, head_dim), vocab, m, k, tied head, RoPE, (experts, top-k,
# shared, d_ff_expert, MoE period), (d_inner, heads, head_dim, d_state,
# chunk) of the Mamba mixer, (attention period, offset), compute dtype
SERVE_FAMILIES = {
    "deepseek-moe-16b": (None, (
        28, 2048, (16, 16, 128), 102400, 20480, 4, False, True,
        (64, 6, 2, 1408, 1), None, (0, 4), "bfloat16")),
    "olmoe-1b-7b": (None, (
        16, 2048, (16, 16, 128), 50304, 9984, 4, False, True,
        (64, 8, 0, 1024, 1), None, (0, 4), "bfloat16")),
    "mamba2-1.3b": (None, (
        48, 2048, None, 50280, 9984, 4, False, True, None,
        (4096, 64, 64, 128, 256), (0, 4), "bfloat16")),
    # 8 of 32 layers (one period of the 1 attn : 7 mamba pattern): all
    # 51.0 B params (102 GB in bf16) do not fit on one 80 GB card
    "jamba-v0.1-52b": (8, (
        8, 4096, (32, 8, 128), 65536, 13056, 4, False, False,
        (16, 2, 0, 14336, 2), (8192, 128, 64, 16, 256), (8, 4),
        "bfloat16")),
}
# the MoE layer against the dense oracle on the tokens none of whose
# copies were dropped: bf16 as served (the two paths round the expert
# products and sum the gated outputs in other orders, a few bf16 ulps of
# the largest output), and an f32 copy of the layer on the same input
# (TF32 off: only f32 summation order, far below any bf16 rounding)
MOE_TOL_BF16 = 2 ** -5
MOE_TOL_F32 = 1e-4
# the chunked SSD path against the sequential oracle on a 300-token
# prompt (two chunks of 256, the second zero-padded): f32 copy of the
# layer (summation order only), and bf16 as served, where the oracle
# rounds its state to bf16 at each of the 300 steps
MAMBA_LONG = 300
MAMBA_TOL_F32 = 1e-4
MAMBA_TOL_BF16 = 2 ** -5


def _family_shape(cfg):
    mo, mc = cfg.moe, cfg.mamba
    heads = None if cfg.is_attention_free else (
        cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim)
    experts = None if mo is None else (
        mo.num_experts, mo.top_k, mo.num_shared, mo.d_ff_expert,
        cfg.moe_layer_period)
    mamba = None if mc is None else (
        mc.expand * cfg.d_model, mc.expand * cfg.d_model // mc.head_dim,
        mc.head_dim, mc.d_state, mc.chunk)
    return (cfg.num_layers, cfg.d_model, heads, cfg.vocab, cfg.m_vocab,
            cfg.bloom.k, cfg.tie_embeddings, cfg.use_rope, experts, mamba,
            (cfg.attn_layer_period, cfg.attn_layer_offset), cfg.dtype)


@contextlib.contextmanager
def _first_call(mod, name, seen):
    """Patch ``mod.name`` so that its first call's (args, result) lands in
    ``seen``; the model looks the function up on its module per call."""
    fn = getattr(mod, name)

    def rec(*args, **kwargs):
        out = fn(*args, **kwargs)
        if not seen:
            seen.append((args, out))
        return out

    setattr(mod, name, rec)
    try:
        yield seen
    finally:
        setattr(mod, name, fn)


def _hold_moe(torch, cfg, p, x, y, label):
    """One MoE layer's capacity-path output ``y`` on ``x`` against
    moe_apply_reference, on the tokens none of whose copies were dropped:
    in bf16 as served, and for an f32 copy of the layer."""
    import copy
    from repro_torch.models import moe
    D = x.shape[-1]
    T, k = x.numel() // D, cfg.moe.top_k
    C = moe.capacity(T, cfg)

    def held(p, x, y):
        r = moe.route(p.router, x.reshape(T, D), cfg, C)
        whole = r.keep.reshape(T, k).all(1)
        want = moe.moe_apply_reference(p, x, cfg).reshape(T, D)[whole]
        got = y.reshape(T, D)[whole]
        return (float((got.float() - want.float()).abs().max()),
                float(want.float().abs().max()), int(whole.sum()),
                int((~r.keep).sum()))

    with torch.inference_mode():
        err, scale, n_tok, dropped = held(p, x, y)
        p32, x32 = copy.deepcopy(p).float(), x.float()
        err32, scale32, n32, dropped32 = held(
            p32, x32, moe.moe_apply(p32, x32, cfg)[0])
        del p32
    _check(n_tok > 0 and err <= MOE_TOL_BF16 * scale,
           f"serve-families: {cfg.name} {label}: MoE capacity path vs "
           f"moe_apply_reference: max abs err {err} over {n_tok} tokens, "
           f"limit {MOE_TOL_BF16} x {scale}")
    _check(n32 > 0 and err32 <= MOE_TOL_F32 * scale32,
           f"serve-families: {cfg.name} {label}: f32 MoE capacity path vs "
           f"moe_apply_reference: max abs err {err32}, limit {MOE_TOL_F32} "
           f"x {scale32}")
    print(f"serve-families: {cfg.name} {label}: the first MoE layer (T = "
          f"{T}, C = {C}, {T * k} routed copies, {dropped} dropped) held "
          f"to moe_apply_reference on the {n_tok} tokens with no copy "
          f"dropped: bf16 max abs err {err:.6g} (limit {MOE_TOL_BF16} x "
          f"max |ref| {scale:.6g}); f32 copy ({dropped32} dropped, "
          f"{n32} tokens) {err32:.6g} (limit {MOE_TOL_F32} x "
          f"{scale32:.6g})", flush=True)


def _moe_holder(torch, cfg):
    """``around`` for _walk_batch: run the step, then hold its first MoE
    layer against the dense oracle (``_hold_moe``)."""
    from repro_torch.models import moe

    def around(label, step):
        with _first_call(moe, "moe_apply", []) as seen:
            out = step()
        (p, x, _), (y, _) = seen[0][0][:3], seen[0][1]
        _hold_moe(torch, cfg, p, x, y, label)
        return out

    return around


def _hold_mamba_long(torch, cfg, model):
    """A 300-token prompt through the prefill step: the first Mamba
    layer's chunked output (two chunks of 256, the second zero-padded) at
    the last position against mamba_reference on the same input, in bf16
    as served and for an f32 copy of the layer."""
    import copy
    import numpy as np
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import mamba2
    dev = model.embed.device
    prompt = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab, size=(1, MAMBA_LONG)), device=dev)
    with _first_call(mamba2, "mamba_apply", []) as seen:
        pre = steps_lib.make_prefill_step(cfg)(model, prompt)
    _check(bool(torch.isfinite(pre["last_logits"]).all()),
           f"serve-families: {cfg.name}: non-finite logits at 300 tokens")
    (p, _, x), (y, _) = seen[0][0][:3], seen[0][1]
    with torch.inference_mode():
        ref = mamba2.mamba_reference(p, cfg, x)
        err = float((y[:, -1].float() - ref[:, -1].float()).abs().max())
        scale = float(ref[:, -1].float().abs().max())
        p32, x32 = copy.deepcopy(p).float(), x.float()
        y32 = mamba2.mamba_apply(p32, cfg, x32)
        ref32 = mamba2.mamba_reference(p32, cfg, x32)
        err32 = float((y32[:, -1] - ref32[:, -1]).abs().max())
        err32_all = float((y32 - ref32).abs().max())
        scale32 = float(ref32[:, -1].abs().max())
    _check(err32 <= MAMBA_TOL_F32 * scale32,
           f"serve-families: {cfg.name}: f32 chunked SSD vs mamba_reference"
           f" at position {MAMBA_LONG - 1}: {err32}, limit {MAMBA_TOL_F32} "
           f"x {scale32}")
    _check(err <= MAMBA_TOL_BF16 * scale,
           f"serve-families: {cfg.name}: bf16 chunked SSD vs "
           f"mamba_reference: {err}, limit {MAMBA_TOL_BF16} x {scale}")
    print(f"serve-families: {cfg.name}: a {MAMBA_LONG}-token prompt through "
          f"the prefill step (chunk {cfg.mamba.chunk}, padded to "
          f"{-(-MAMBA_LONG // cfg.mamba.chunk) * cfg.mamba.chunk}): the "
          f"first Mamba layer's last output held to mamba_reference: f32 "
          f"copy max abs err {err32:.6g} (limit {MAMBA_TOL_F32} x "
          f"{scale32:.6g}; {err32_all:.6g} over all positions), bf16 as "
          f"served {err:.6g} (limit {MAMBA_TOL_BF16} x {scale:.6g})",
          flush=True)


def _engine_replays(torch, be, dt, common, cfg, model, labels, totals,
                    errs):
    """The continuous (and static) Engine over 8 slots and 16 mixed-length
    requests, once per label, the counts reset just before and read just
    after each run: one launch each of the embed token entry and
    bloom_decode_topk (the row-skipping grid) per prefill and per decode
    step, each held against its plain version on the same tensors as it
    happens (``held_to_plain``, the largest error by kernel into
    ``errs``).  Returns the tokens by label."""
    from repro_torch.models import io as io_lib
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.loadgen import mixed_length_workload
    engine = Engine(cfg, model, n_slots=8, max_len=40, topk=8)
    wl = mixed_length_workload(cfg.vocab, 16, seed=0)
    embed_name = be.token_variant_name(io_lib.vocab_spec(cfg))
    tokens = {}
    for label in labels:
        run = engine.run_static if label.startswith("static") else engine.run
        reqs = [r.fresh_copy() for r in wl]
        torch.cuda.synchronize()
        common.reset_launches()
        with held_to_plain(torch, common,
                           f"serve-families: {cfg.name} {label}", errs):
            res, st = run(reqs)
            torch.cuda.synchronize()
        counts = dict(common.LAUNCHES)
        _check(all(r.done and not r.rejected for r in res.values()),
               f"serve-families: {cfg.name} {label}: a request was not "
               "served")
        want = st.prefills + st.decode_steps
        _check(counts == {embed_name: want, dt.NAME: want},
               f"serve-families: {cfg.name} {label}: launched {counts} for "
               f"{st.prefills} prefills + {st.decode_steps} decode steps")
        for n, c in counts.items():
            totals[n] = totals.get(n, 0) + c
        for r in res.values():
            _check(len(r.tokens) == r.max_gen
                   and all(0 <= t < cfg.vocab for t in r.tokens),
                   f"serve-families: {cfg.name} {label}: rid {r.rid} "
                   f"tokens {r.tokens}")
        tokens[label] = {rid: r.tokens for rid, r in res.items()}
        print(f"serve-families: {cfg.name} Engine {label}: "
              f"{st.decode_steps} decode steps, {st.prefills} prefills, "
              f"{st.tokens_out} tokens out, utilization "
              f"{st.utilization:.4f}, wall {st.wall_s:.3f} s "
              f"({st.tokens_out / max(st.wall_s, 1e-9):.1f} tok/s, each "
              f"launch held against its plain version), launches {counts}",
              flush=True)
    return tokens


def phase_serve_families(torch, be, dt, common):
    """The MoE, SSM and hybrid archs at full width (jamba's depth cut to
    one 8-layer period), weights drawn on the card from seed 0 in bf16:
    each through launch.serve.run twice (batch 4, prompt 32, gen 12, topk
    8), counts reset just before and read just after each run, the replay
    giving the same ids; then the same loop walked through
    make_prefill_step and make_decode_step with both kernels held to
    their plain versions at every step and, for MoE, the first MoE layer
    held to moe_apply_reference at the prefill and the first decode step;
    olmoe-1b-7b also through the continuous Engine twice, mamba2-1.3b
    through the continuous and the static Engine twice each and a
    300-token prompt held to mamba_reference; every Engine launch held
    against its plain version (``held_to_plain``).  Returns (the launches
    of the counted runs by kernel, max abs error by kernel)."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.launch import serve
    dev = torch.device("cuda")
    B, S, gen, topk = SERVE_BATCH
    totals, errs = {}, {}
    for arch, (layers, want) in SERVE_FAMILIES.items():
        over = {} if layers is None else {"num_layers": layers}
        cfg = configs.get_config(arch, **over)
        _check(_family_shape(cfg) == want,
               f"serve-families: {arch} config {_family_shape(cfg)}")
        runs = [_counted(
            torch, be, dt, common, "serve-families", totals,
            f"{arch} serve.run {i + 1}", cfg, lambda: serve.run(
                arch, batch=B, prompt_len=S, gen=gen, topk=topk, full=True,
                device=dev, layers=layers)) for i in range(2)]
        _check(np.array_equal(runs[0], runs[1]),
               f"serve-families: {arch}: the replay of serve.run gave "
               "other ids")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = serve.build_model(cfg, 0, dev)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        n_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
        print(f"serve-families: {arch} {cfg.num_layers}L"
              + (f" (reduced from {configs.get_config(arch).num_layers})"
                 if layers else "") +
              f" {cfg.family} d_model {cfg.d_model} vocab {cfg.vocab} m "
              f"{cfg.m_vocab} k {cfg.bloom.k}: {n_params:,} params "
              f"({n_bytes / 1e9:.3f} GB) drawn on the card block by block, "
              f"set-up {setup:.3f} s, peak allocated "
              f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB", flush=True)
        prompts = np.random.default_rng(0).integers(
            0, cfg.vocab, size=(B, S), dtype=np.int32)
        walked = _walk_batch(
            torch, be, dt, cfg, model, prompts, gen, topk,
            phase="serve-families",
            around=_moe_holder(torch, cfg) if cfg.moe else None)
        _check(np.array_equal(walked, runs[0]),
               f"serve-families: {arch}: the step walk's ids != serve.run's")
        print(f"serve-families: {arch}: every step's embedding and top-k "
              f"ids and scores bit-equal to the plain versions, logits "
              f"finite, ids equal to serve.run's; "
              f"{len(np.unique(walked))} distinct ids of {walked.size}; ids "
              f"(first seq) {walked[0].tolist()}", flush=True)
        if arch == "olmoe-1b-7b":
            tok = _engine_replays(torch, be, dt, common, cfg, model,
                                  ("continuous", "continuous replay"),
                                  totals, errs)
            _check(tok["continuous"] == tok["continuous replay"],
                   f"serve-families: {arch}: the Engine's replay served "
                   "other tokens")
        if arch == "mamba2-1.3b":
            tok = _engine_replays(torch, be, dt, common, cfg, model,
                                  ("continuous", "continuous replay",
                                   "static", "static replay"), totals,
                                  errs)
            _check(tok["continuous"] == tok["continuous replay"]
                   == tok["static"] == tok["static replay"],
                   f"serve-families: {arch}: the Engine's replays or its "
                   "static run served other tokens")
            _hold_mamba_long(torch, cfg, model)
        _time_batch_kernels(torch, be, dt, common, cfg, model, B, S, topk,
                            phase="serve-families")
        del model
        torch.cuda.empty_cache()
    print(f"serve-families: every Engine launch held against its plain "
          f"version, max abs err by kernel {errs}", flush=True)
    return totals, errs


def _plain_checks(torch):
    """(module, wrapper, check) for every kernel wrapper that counts a
    launch.  ``check(out, *args, **kwargs)`` recomputes the wrapper's
    result by its plain version on the same tensors, raises unless it
    agrees within the tolerance the kernel's own phase states (bit-equal;
    bloom_ce's forward within rtol 1e-6 / atol 1e-5 and its backward
    within atol 1e-7, as in phase_ce), and returns the max abs error.  The
    CSR binning, the CSR scatter and the dense embed backward are held
    against their plain version on a CPU copy, as in their phases (on the
    card ``index_add_`` adds in no fixed order)."""
    from repro_torch.kernels import bloom_ce as ce
    from repro_torch.kernels import bloom_csr as csr
    from repro_torch.kernels import bloom_decode as bd
    from repro_torch.kernels import bloom_decode_topk as dt
    from repro_torch.kernels import bloom_embed as be

    def equal(got, want, what):
        _check(got.shape == want.shape and got.dtype == want.dtype
               and _equal_nan(torch, got, want),
               f"{what} {tuple(got.shape)}: kernel != plain version")
        return 0.0

    def close(got, want, what, rtol, atol):
        try:
            torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
        except AssertionError as e:
            raise AssertionError(f"{what} {tuple(got.shape)}: kernel != "
                                 f"plain version: {e}") from None
        return _max_abs_err(got, want)

    def decode_topk(out, logp, H, topk, active=None, scales=None,
                    hash_spec=None):
        pv, pi = dt.bloom_decode_topk_plain(logp, H, topk, active, scales,
                                            hash_spec)
        return max(equal(out[1], pi, "bloom_decode_topk ids"),
                   equal(out[0], pv, "bloom_decode_topk values"))

    def decode(out, logp, H, scales=None, packed=None):
        return equal(out, bd.bloom_decode_plain(logp, H, scales),
                     "bloom_decode")

    def embed(out, table, idx):
        return equal(out, be.bloom_embed_plain(table, idx), "bloom_embed")

    def embed_q(out, qtable, scales, idx, out_dtype=torch.float32):
        return equal(out, be.bloom_embed_quantized_plain(
            qtable, scales, idx, out_dtype), "bloom_embed (stored table)")

    def tokens(out, want_idx, qtable, scales, toks, spec, out_dtype, what):
        want, idx = be.bloom_embed_tokens_plain(qtable, scales, toks, spec,
                                                out_dtype)
        if want_idx:
            equal(out[1], idx, f"{what} indices")
        return equal(out[0], want, what)

    def embed_tok(out, table, toks, spec, want_idx=False):
        return tokens(out, want_idx, table, None, toks, spec, table.dtype,
                      "bloom_embed token entry")

    def embed_tok_q(out, qtable, scales, toks, spec,
                    out_dtype=torch.float32, want_idx=False):
        return tokens(out, want_idx, qtable, scales, toks, spec, out_dtype,
                      "bloom_embed token entry (stored table)")

    def embed_bwd(out, g, idx, m):
        return equal(out.cpu(), be.bloom_embed_bwd_plain(g.cpu(), idx.cpu(),
                                                         m),
                     "bloom_embed_bwd (plain on a CPU copy)")

    def ce_fwd(out, z, h):
        loss, lse = ce.bloom_ce_plain(z, h)
        return max(close(out[0], loss, "bloom_ce loss", 1e-6, 1e-5),
                   close(out[1], lse, "bloom_ce lse", 1e-6, 1e-5))

    def ce_bwd(out, g, z, h, lse):
        return close(out, ce.bloom_ce_bwd_plain(g, z, h, lse),
                     "bloom_ce dz", 0.0, 1e-7)

    def bins(out, idx, m):
        want = csr.bin_csr_plain(idx.cpu(), m)
        _check(all(torch.equal(x.cpu(), w) for x, w in zip(out, want)),
               f"bloom_csr.bin {tuple(idx.shape)} m={m}: device bins != "
               "bin_csr_plain's on a CPU copy")
        return 0.0

    def scatter(out, g, bins_, m, name=csr.NAME):
        cpu_bins = csr.CSRBins(*(x.cpu() for x in bins_))
        return equal(out.cpu(), csr.csr_scatter_add_plain(g.cpu(), cpu_bins,
                                                          m),
                     f"{name} (plain on a CPU copy)")

    return [(dt, "bloom_decode_topk_cuda", decode_topk),
            (bd, "bloom_decode_cuda", decode),
            (be, "bloom_embed_cuda", embed),
            (be, "bloom_embed_quantized_cuda", embed_q),
            (be, "bloom_embed_tokens_cuda", embed_tok),
            (be, "bloom_embed_tokens_quantized_cuda", embed_tok_q),
            (be, "bloom_embed_bwd_cuda", embed_bwd),
            (ce, "bloom_ce_cuda", ce_fwd),
            (ce, "bloom_ce_bwd_cuda", ce_bwd),
            (csr, "bin_csr_cuda", bins),
            (csr, "csr_scatter_add_cuda", scatter)]


@contextlib.contextmanager
def held_to_plain(torch, common, label, errs):
    """Hold every kernel launch of the block against its plain version on
    the same tensors, right after the launch (``_plain_checks``), and
    gather the largest max abs error by kernel name into ``errs``.  The
    wrappers are patched on their modules, where every caller looks them
    up.  On leaving, the checks by kernel name must equal the block's
    launches by kernel name, so no launch went unchecked; the plain
    versions launch no kernel, so the block's counts are the run's."""
    checks = {}
    start = dict(common.LAUNCHES)
    saved = []

    def held(fn, check):
        def call(*args, **kwargs):
            before = dict(common.LAUNCHES)
            out = fn(*args, **kwargs)
            with torch.no_grad():
                err = check(out, *args, **kwargs)
            for n, c in common.LAUNCHES.items():
                if c != before.get(n, 0):
                    checks[n] = checks.get(n, 0) + c - before.get(n, 0)
                    errs[n] = max(errs.get(n, 0.0), err)
            return out
        return call

    for mod, name, check in _plain_checks(torch):
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, held(saved[-1][2], check))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    launched = {n: c - start.get(n, 0) for n, c in common.LAUNCHES.items()
                if c != start.get(n, 0)}
    _check(checks == launched, f"{label}: held {checks} against the plain "
           f"versions, launched {launched}")


def phase_bench_serving(torch, common):
    """The serving bench twin's 16 rows on the card, held to
    BENCH_serving.json by its check_against; counts reset just before and
    read just after; every launch held against its plain version
    (``held_to_plain``).  Returns (launches by kernel, max abs error by
    kernel)."""
    from repro_torch.benchmarks import bench_serving as bs
    dev = torch.device("cuda")
    errs = {}
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    common.reset_launches()
    with held_to_plain(torch, common, "bench-serving", errs):
        rows = bs.run(dev)
        torch.cuda.synchronize()
    counts = dict(common.LAUNCHES)
    for r in rows:
        print(f"bench-serving: {json.dumps(r, sort_keys=True)}", flush=True)
    failures = bs.check_against(rows)
    _check(not failures, "bench-serving: " + "; ".join(failures))
    _check(len(rows) == 16
           and {r["impl"] for r in rows if "impl" in r} == {"kernel"},
           "bench-serving: rows or route")
    print(f"bench-serving: check ok: {len(rows)} rows vs "
          f"{bs.JSON_PATH.name} on {torch.cuda.get_device_name(0)}, "
          f"launches {counts}, each held "
          f"against its plain version (max abs err {errs}), wall "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    return counts, errs


def phase_examples(torch, common, names):
    """Each example twin's main on CUDA at its smallest documented budget,
    counts reset just before and read just after each, every launch held
    against its plain version (``held_to_plain``).  ``names`` are the
    training kernels train_lm_100m must launch once per step.  Returns
    (the launches of the five runs by kernel, max abs error by kernel)."""
    import tempfile
    import numpy as np
    from repro_torch.examples import (cbe_cooccurrence, quickstart,
                                      serve_bloom_lm, train_lm_100m,
                                      train_recommender)
    from repro_torch.kernels import bloom_decode as bd
    from repro_torch.kernels import bloom_decode_topk as dt
    totals, errs = {}, {}

    def counted(label, fn):
        torch.cuda.synchronize()
        common.reset_launches()
        t0 = time.perf_counter()
        with held_to_plain(torch, common, f"examples: {label}", errs):
            out = fn()
            torch.cuda.synchronize()
        counts = dict(common.LAUNCHES)
        for n, c in counts.items():
            totals[n] = totals.get(n, 0) + c
        print(f"examples: {label}: wall {time.perf_counter() - t0:.3f} s "
              f"(each launch held against its plain version), launches "
              f"{counts}", flush=True)
        return out, counts

    (score, ids), c = counted("quickstart", lambda: quickstart.main(
        ["--device", "cuda"]))
    _check(0.01 < score <= 1 and len(set(ids)) == 5 and c.get(dt.NAME) == 1
           and c.get(bd.NAME, 0) >= 1, f"quickstart: {score} {ids} {c}")
    rows, c = counted("train_recommender --quick",
                      lambda: train_recommender.main(["--quick"]))
    _check(len(rows) == 4 and all(0 < r["score"] <= 1 for r in rows)
           and c.get(bd.NAME, 0) >= 4, f"train_recommender: {rows} {c}")
    rows, c = counted("cbe_cooccurrence", lambda: cbe_cooccurrence.main([]))
    _check(len(rows) == 1 and rows[0]["cbe_ratio"] > 0
           and c.get(bd.NAME, 0) >= 3, f"cbe_cooccurrence: {rows} {c}")
    ids, c = counted("serve_bloom_lm", lambda: serve_bloom_lm.main([]))
    gen = 12
    _check(ids.shape == (4, gen) and c.get(dt.NAME) == gen
           and sum(c.values()) == 2 * gen, f"serve_bloom_lm: {ids.shape} {c}")
    ckpt_root = SRC.parent / "build"
    ckpt_root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ckpt_root) as ckpt:
        (_, history), c = counted(
            "train_lm_100m --steps 4", lambda: train_lm_100m.main(
                ["--steps", "4", "--ckpt", ckpt]))
        _check(any(Path(ckpt).iterdir()), "train_lm_100m: no checkpoint")
    losses = [h["loss"] for h in history]
    _check(len(losses) == 4 and all(np.isfinite(losses))
           and all(c.get(n) == 4 for n in names),
           f"train_lm_100m: losses {losses}, launches {c}")
    print(f"examples: every launch held against its plain version, max abs "
          f"err by kernel {errs}", flush=True)
    return totals, errs




def start_parent_build(common, parent: Path):
    """nvcc on the parent commit's csrc/bloom_embed.cu and bloom_decode.cu
    (copied with the headers they include into ``parent``), started now,
    into parent/<name>.so; returns {name: (process, library path)}."""
    procs = {}
    for name in PARENT_KERNELS:
        lib = parent / f"{name}.so"
        cmd = [common._nvcc(), *common.NVCC_FLAGS, "-o", str(lib),
               str(parent / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib)
    return procs


def phase_parent(torch, be, bd, common, quant, procs, parent):
    """The parent commit's embed and decode kernels against this tree's, in
    one process, each timed in turns (parent, change, change, parent):
    device (graph), back to back (events) and L2-cold (profiler); their
    outputs bit-identical.  The embedding as the parent called it hashes
    with the parent's core/hashing.py (``parent``/hashing.py), whose
    host-to-device copy synchronises the host (probed here under
    set_sync_debug_mode("error")), so that call has no graph time."""
    import ctypes
    import importlib.util
    from repro_torch import configs
    from repro_torch.core import bloom
    from repro_torch.kernels import ops
    from repro_torch.models import io as io_lib
    libs = {}
    for name, (proc, path) in procs.items():
        log, _ = proc.communicate()
        _check(proc.returncode == 0, f"parent {name} build failed:\n{log}")
        libs[name] = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    libs["bloom_embed"].bloom_embed_fwd.argtypes = [p, p, p, p, i, i, i, i,
                                                    i, p]
    libs["bloom_decode"].bloom_decode_fwd.argtypes = [p, i, p, p, p, i, i,
                                                      i, i, i, p]
    dev = torch.device("cuda")
    codes = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
             torch.float8_e4m3fn: 3}
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def parent_embed(q, sc, idx, od):
        out = torch.empty((idx.shape[0], q.shape[1]), dtype=od, device=dev)
        libs["bloom_embed"].bloom_embed_fwd(
            q.data_ptr(), None if sc is None else sc.data_ptr(),
            idx.data_ptr(), out.data_ptr(), idx.shape[0], q.shape[1],
            idx.shape[1], codes[q.dtype], codes[od], stream())
        return out

    def parent_decode(q, H, sc):
        (B, m), (d, k) = q.shape, H.shape
        # the parent wrapper's blocks per row (bloom_decode._groups)
        per_sm = max(1, min(4, 228 * 1024 // (m * 4 + 2048)))
        groups = max(1, min(-(-d // 256),
                            per_sm * common.sm_count(dev) // B, 65535))
        out = torch.empty((B, d), dtype=torch.float32, device=dev)
        libs["bloom_decode"].bloom_decode_fwd(
            q.data_ptr(), codes[q.dtype],
            None if sc is None else sc.data_ptr(), H.data_ptr(),
            out.data_ptr(), B, m, d, k, groups, stream())
        return out

    spec = io_lib.vocab_spec(configs.get_config("qwen1.5-0.5b"))
    m, D = spec.m, 1024
    gen = torch.Generator().manual_seed(21)
    base = torch.randn(m, D, generator=gen).to(dev)
    found = importlib.util.spec_from_file_location("parent_hashing",
                                                   parent / "hashing.py")
    old_hash = importlib.util.module_from_spec(found)
    found.loader.exec_module(old_hash)
    probe = torch.arange(8, device=dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        old_hash.double_hash(probe, spec.k, m, spec.seed)
        synced = False
    except RuntimeError:
        synced = True
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print(f"parent: the parent's double_hash on CUDA ids under "
          f"set_sync_debug_mode('error'): "
          f"{'raised (it synchronises the host)' if synced else 'ran'}",
          flush=True)
    for td in (None, *quant.TABLE_DTYPES):
        if td is None:
            q, sc = base.to(torch.bfloat16), None
        else:
            q, sc = quant.quantize_table(base, td)
        for T in (8, 14, 520):
            tok = torch.randint(0, spec.d, (T,), generator=gen).to(dev)
            idx = spec.indices_for(tok).contiguous()
            od = torch.bfloat16
            if td is None:
                new_idx = lambda: be.bloom_embed_cuda(q, idx)  # noqa: E731
                new_tok = lambda: be.bloom_embed_tokens_cuda(  # noqa: E731
                    q, tok, spec)[0]
                called = lambda: ops.bloom_embed(  # noqa: E731
                    q, tok[:, None], spec)
            else:
                new_idx = lambda: be.bloom_embed_quantized_cuda(  # noqa: E731
                    q, sc, idx, od)
                new_tok = lambda: be.bloom_embed_tokens_quantized_cuda(  # noqa
                    q, sc, tok, spec, od)[0]
                called = lambda: be.bloom_embed_tokens_fwd_quantized(  # noqa
                    q, sc, tok, spec, od)
            old_called = lambda: parent_embed(  # noqa: E731
                q, sc, old_hash.double_hash(tok, spec.k, m,
                                            spec.seed).contiguous(), od)
            want = parent_embed(q, sc, idx, od)
            _check(torch.equal(new_idx(), want) and torch.equal(new_tok(),
                                                                want),
                   f"parent embed {td} T={T}: the kernels differ")
            with torch.no_grad():
                times = _turns(torch, common, {
                    "parent kernel": lambda: parent_embed(q, sc, idx, od),
                    "index kernel": new_idx, "token kernel": new_tok,
                    "parent as called": old_called, "as called": called},
                    no_graph=("parent as called",))
            print(f"parent: bloom_embed {td or 'bf16 as is'} -> bf16 T={T} "
                  f"D={D} k={spec.k}, bit-identical; device ms (graph) / "
                  f"back-to-back ms (events) / L2-cold device ms "
                  f"(profiler), in turns: {_turns_line(times)}", flush=True)
    H = bloom.cached_hash_matrix(spec, dev)
    H16 = bloom.cached_packed_hash_matrix(spec, dev)
    logp = torch.log_softmax(3 * torch.randn(8, m, generator=gen), -1)
    logp = logp.to(dev)
    for td in (None, *quant.TABLE_DTYPES):
        for B in (1, 8):
            q, sc = ((logp[:B], None) if td is None
                     else quant.quantize_table(logp[:B].contiguous(), td))
            _check(_equal_nan(torch, parent_decode(q, H, sc),
                              bd.bloom_decode_cuda(q, H, sc)),
                   f"parent decode {td} B={B}: the kernels differ")
            times = _turns(torch, common, {
                "parent kernel": lambda: parent_decode(q, H, sc),
                "kernel": lambda: bd.bloom_decode_cuda(q, H, sc, H16)})
            print(f"parent: bloom_decode {td or 'f32'} B={B} m={m} "
                  f"d={spec.d} k={spec.k}, bit-identical; device ms (graph) "
                  f"/ back-to-back ms (events) / L2-cold device ms "
                  f"(profiler), in turns: {_turns_line(times)}", flush=True)


def main() -> int:
    if "PYTHONHASHSEED" not in os.environ:
        # the paper tasks' data seed is hash(name) (phase paper): pin str
        # hashing so that every run draws the same data
        os.execve(sys.executable, [sys.executable, *sys.argv],
                  {**os.environ, "PYTHONHASHSEED": "0"})
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: the port is not at {SRC}", file=sys.stderr)
        return 2
    parent = None
    if sys.argv[1:2] == ["--parent"]:
        # a directory holding the parent commit's csrc/bloom_embed.cu and
        # bloom_decode.cu with the headers they include, to time them
        # beside this tree's (phase "parent")
        parent = Path(sys.argv[2]).resolve()
    elif sys.argv[1:]:
        print("usage: chip_smoke.py [--parent DIR]", file=sys.stderr)
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
    procs = None if parent is None else start_parent_build(common, parent)
    built = common.build()
    print("build: " + ", ".join(f"{n} {s:.3f} s" for n, s in built.items())
          + f" (wall {time.perf_counter() - t0:.3f} s)", flush=True)
    _check(set(built) == {dt.NAME, be.NAME, ce.NAME, csr.NAME, bd.NAME},
           f"unexpected kernels {sorted(built)}")

    from repro_torch.core import quant
    row = phase_kernels(torch, dt, common, bloom, get_retrieval_config)
    lm_decode_topk(torch, dt, common, bloom)
    row["max_abs_err"] = max(row["max_abs_err"], decode_topk_sweep_shapes(
        torch, dt, quant, bloom, get_retrieval_config))
    phase_embed(torch, be)
    embed_rows = phase_embed_tokens(torch, be, common, quant)
    embed_row = embed_rows[0]       # bloom_embed.hash: the bf16 LM table
    row["launches"] = phase_serve(torch, dt, common, bloom, retrieval,
                                  get_retrieval_config)
    ev = retrieval._smoke_eval(torch.device("cuda"), 0)
    print(f"eval: smoke untrained rr={ev['rr']:.6f} map={ev['map']:.6f} "
          f"n={ev['n_evaluated']}", flush=True)
    lm = phase_serve_lm(torch, be, dt, common)
    row["launches"] += lm[dt.NAME]
    embed_row["launches"] = lm[embed_row["name"]]
    train_rows = phase_ce(torch, ce, common) + phase_csr(torch, csr, common)
    trained, csr_losses, csr_ms = phase_train_lm(
        torch, common, [embed_row["name"], csr.BIN, csr.NAME, ce.FWD,
                        ce.BWD])
    embed_row["launches"] += trained[embed_row["name"]]
    for r in train_rows:
        r["launches"] = trained[r["name"]]
    phase_embed_quant(torch, be, quant)
    quant_rows = embed_rows[1:] + phase_decode_quant(
        torch, dt, common, bloom, quant, get_retrieval_config)
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
        torch, be, common, [embed_row["name"], be.BWD, ce.FWD, ce.BWD],
        csr_losses, csr_ms)
    _check(csr.NAME not in dense_counts and csr.BIN not in dense_counts,
           "the dense training run launched the CSR kernel or its binning")
    launched.update(dense_counts)
    for r in decode_rows:
        r["launches"] = launched.get(r["name"], 0)
    rt_counts = phase_train_retrieval(torch, dt, common, bloom, quant,
                                      retrieval, get_retrieval_config)
    for r in [row, *quant_rows]:
        r["launches"] += rt_counts.pop(r["name"], 0)
    _check(not rt_counts, f"train-retrieval launched {sorted(rt_counts)}, "
           "which no kernel row names")
    paper_launches = phase_paper(torch, bd, common)
    for r in decode_rows:
        if r["name"] == bd.NAME:
            r["launches"] += paper_launches
    rows = [row, embed_row, *train_rows, *quant_rows, *decode_rows]
    by_name = {r["name"]: r for r in rows}
    for counts, errs in ((phase_serve_batch(torch, be, dt, common), {}),
                         phase_serve_families(torch, be, dt, common),
                         phase_bench_serving(torch, common),
                         phase_examples(torch, common, [
                             embed_row["name"], csr.BIN, csr.NAME, ce.FWD,
                             ce.BWD])):
        _check(set(counts) <= set(by_name), f"launched "
               f"{sorted(set(counts) - set(by_name))}, which no kernel row "
               "names")
        for name, c in counts.items():
            by_name[name]["launches"] += c
            by_name[name]["max_abs_err"] = max(by_name[name]["max_abs_err"],
                                               errs.get(name, 0.0))
    _check(all(r["launches"] > 0 for r in rows),
           "a kernel of the main paths was never launched")
    if procs is not None:
        phase_parent(torch, be, bd, common, quant, procs, parent)

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
