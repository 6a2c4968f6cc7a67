#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it.

    python3 chip_smoke.py        # from the repository root, one CUDA card
    python3 chip_smoke.py --phase train-parallel [--transport nccl]
        # build, then that phase alone (a quick check of the parallel
        # step; no result line); nccl needs four cards on one host
    python3 chip_smoke.py --phase serve-parallel-families
        # build, then phase 17e alone (no result line)
    python3 chip_smoke.py --phase train-long
        # build, then phase 17a alone (no result line)
    python3 chip_smoke.py --parent DIR   # also time the parent commit's
        # csrc/bloom_ce.cu (copied into DIR) beside this tree's: phase 18

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
                and L2-cold (``common.cold_ms``: a graph of a 96 MB write
                and the call, less one of the write alone)
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
                from torch's in the last ulp), and on the kernels' branch
                cases (``sweep_ce.edge_cases``: k = 1, 2, 3, 4, 8, 40,
                ragged m, -inf columns and rows, a shard no label of a row
                falls in, an unaligned row), the card's CSR bins
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
                within rtol 1e-6; then the roofline's share of that step,
                beside the card's name and power limit: the analytic
                model FLOPs (``roofline.model_flops``) over the median
                step wall times the bf16 peak, and the same step counted
                on ``meta`` by the dry run for mesh 1x1 (its roofline
                bound against the measured step); the count's
                argument_bytes must equal the bytes of the same tensors
                allocated on the card, and its temp_bytes is printed
                beside torch.cuda.max_memory_allocated;
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
 15c. serve-frontends — the encoder-decoder and vision-frontend archs at
                full width and depth, bf16, drawn on the card from seed 0
                block by block: whisper-small (12 encoder and 12 decoder
                layers, d_model 768, MHA 12 x 64, d_ff 3,072, vocab 51,865,
                m 10,240; the stub audio frontend) and pixtral-12b (40
                layers, d_model 5120, GQA 32/8 x 128, d_ff 14,336, vocab
                131,072, m 26,112; the stub vision frontend); each through
                launch.serve.run twice as serve-batch (the reference's zero
                frames / image embeddings, max(4, 32 // 4) = 8 rows), then
                the loop walked step by step with seeded nonzero inputs
                (whisper 1,500 frames, the reference's 30 s window; pixtral
                32 image rows ahead of 96 tokens, its input_specs rule at
                S_tot 128), every kernel launch held against its plain
                version (``held_to_plain``) and every decode step's logits
                held to a full pass over the prefix and the tokens so far
                within 2^-5 x max |logit| (pixtral decodes at S_emb + S +
                t); the set-up seconds, peak memory, prefill ms, decode
                tok/s, a walked step's wall and device-busy share, and the
                two kernels timed at the arch's shapes; then whisper-small
                trained 8 steps at full width through launch/train.run
                (batch 8, seq 64) twice, once with every launch (embed
                token entry, CSR binning and scatter, bloom_ce forward and
                backward, once a step each) held to its plain version and
                once timed, the losses finite and equal (rtol 1e-6);
 15d. serve-sharded — data-axis-sharded serving (serving/sharded_pool.py)
                at full width: qwen1.5-0.5b (24 layers, d_model 1024, MHA
                16 x 64, vocab 151,936, m 30,208, k 4, bf16, drawn on the
                card from seed 0) through the in-process multi-host sim's
                matrix (serving.sim_multihost.run: 8 hosts x 2 slots on
                the one card, max_len 40, topk 4, gossip delay 1, 2
                prefill workers, LoadSpec(2 requests a host, rate 1.0,
                prompts 6-10, gens 3/6/12, seed 0); ONE ShardedEngine over
                {sim, collective} x {plain, compaction 0.25}, then the
                single-host Engine at 16 slots and each request alone
                through solo static serving), counts reset just before
                and read just after, every launch held against its plain
                version: one bloom_embed.hash and one bloom_decode_topk
                launch per prefill and per pool decode step; every request
                done; tokens bit-equal across the four runs, the
                single-host Engine and solo serving (a difference would
                print the request and its top-2 Eq. 3 gap, and fail);
                each log equal to simulate_sharded_schedule's integer for
                integer (COMPACT included), sim == collective; the compact
                runs compacted; both prefill workers used; slot logs sound
                and linearizable; one decode step object and every pool
                leaf's storage kept; then the chaos drill (4 hosts,
                kill_host:1@3) and the overload drill (surge:3@1,
                slow_decode:3@2, the committed policy) with the
                reference's verifiers, counted and held the same way; one
                pool step walked by hand with 3 of 16 rows live, its
                embedding and top-k ids and scores bit-equal to the plain
                versions, then its wall and device time by kernel (3 and
                16 rows live); the matrix's workload timed unheld in turns
                (sharded collective compact, single-host Engine, sharded
                sim plain: wall, tok/s, wall per decode step) and one
                collective exchange round; serve.run_sharded as the CLI
                calls it (--full --hosts 8 --slots-per-host 2 --transport
                collective --compact-threshold 0.25: 128 requests);
                mamba2-1.3b at full width (48 layers, d_model 2048, vocab
                50,280, m 9,984) through one compacting collective run,
                its tokens equal to the single-host Engine's;
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
 17a. train-long — the chunked flash-style attention and the remat
                policy on qwen1.5-0.5b at full width, one rank: (a) 4 of
                24 layers, f32, batch 2 x 2,048 tokens (two 1,024-key
                chunks), one step's loss and gradients through chunked
                attention with remat none, full and dots, and causal_skip
                (1,024-row q chunks), against attn_impl naive with remat
                none: within 1e-5 relative of it; full and dots within
                1e-6 of none (bit for bit expected); each run's wall and
                peak memory; (b) full depth with the configs' defaults
                (bf16, chunked, remat full), 8 steps at batch 4 x 4,096
                tokens through launch/train.run, counts reset just before
                and read just after: each Bloom kernel launched 8 times,
                losses finite and falling; step walls, tokens/s and
                max_memory_allocated beside the dry run's count of the
                same step on mesh 1x1 (defaults, and naive without
                remat); then one step of a 4-layer cut at (b)'s batch with
                every launch held against its plain version; (c)
                serve.generate of one 32,768-token prompt and 4 tokens,
                f32, chunked and causal_skip (2,048-row q chunks), every
                launch held: tokens equal, top-k ids equal but at ties,
                scores within 1e-4 (17c's rule); each prefill's ms and
                peak memory.  ``--phase train-long`` runs it alone;
 17b. train-parallel — the tensor-, expert- and data-parallel training
                step on four ranks sharing the one card over gloo
                (launch/train.spawn; the kernels built here first).  In
                this process: the ranged kernels (one rank's rows of the
                vocab: the embed token entry, the CSR binning, the dense
                embed backward, the Bloom CE forward and backward) at
                lo = 0 over every row bit-identical to the unranged
                kernels and, at every range, to their plain versions (CE
                within 1e-6), and timed at the full and at the half range
                beside the unranged kernel.  Then (a) qwen1.5-0.5b at full
                width and 8 of 24 layers, f32, mesh 2x2, 3 steps at batch
                8 x seq 64 from the
                weights rank 0 draws on the card, whose losses must equal
                a single-rank run here from the same draw within rtol
                1e-5, and the same in bf16 (its loss gap printed); (b)
                olmoe-1b-7b at full width and 2 of 16 layers (memory
                below), mesh 1x4, moe_impl="ep": one prefill and 2 steps
                against the single-rank dense-MoE path.  Each rank resets
                its counts before its runs and reads them after; its
                ranged embed, binning, scatter and CE launches are held
                against their plain versions on its own shard; it prints
                its step walls, its collective seconds per step and each
                collective's branch (device buffer or host-staged);
 17c. serve-parallel — whole-batch serving (launch/serve.generate under
                a mesh: prefill, then the decode step against each rank's
                cache shards, the vocab-parallel logits all-gathered over
                ``model`` before the decode-top-k kernel) on four ranks
                sharing the card over gloo: qwen1.5-0.5b at full width and
                8 of 24 layers (d_model 1024, 16 heads and 16 kv heads,
                m = 30,208, k = 4), B = 4, prompt 32, 12 tokens, on mesh
                1x4 and 2x2, and olmoe-1b-7b at full width and 2 of 16
                layers on mesh 1x4 with moe_impl="ep", f32 (a bf16 split
                rounds partial sums that one rank does not; the bf16 1x4
                side run, not held, is left out for the time limit),
                from the weights rank 0 draws on the card.  Every token and every top-k id equals
                the same weights' one-rank run here, the top-k scores
                within 1e-4 (two ids whose one-rank scores tie within
                1e-4 may swap, the last of the top k with the one-rank
                run's next-ranked id too; a row whose token falls on such
                a tie is compared no further); each rank holds every
                kernel launch
                against its plain version as it happens
                (``held_to_plain``) and prints each decode step's wall,
                its collective seconds and the busy share (the wall less
                the collective seconds, over the wall);
 17d. dry run — ``python -m repro_torch.launch.dryrun --all --jobs 6``
                (the production grid counted on ``meta`` tensors at the
                H100's rates), started in a subprocess just before the
                build, beside it on the host's cores, and read right
                after it: exactly 32 ``OK`` lines and no ``WAIT`` or
                ``FAIL``; then every train_4k cell's argument + temp
                bytes a rank from its artifact (the configs' defaults:
                chunked attention, remat full), the eight of
                ``FIT_80GB`` held under 80 GB;
 17e. serve-parallel-families — the ssm, audio and vlm families tensor-
                parallel (and mamba2's training step), ranks sharing the
                card over gloo, f32, from the weights rank 0 draws on the
                card, each against the same weights' one-rank run here
                under 17c's rules (tokens and top-k ids equal, scores
                within 1e-4; every launch of every rank held against its
                plain version; each decode step's wall, collective seconds
                and busy share printed): (a) mamba2-1.3b at full width and
                24 of 48 layers (64 SSD heads: 16 a rank) on mesh 1x4, B
                = 4, prompt 32, 8 tokens, then 2 training steps at batch
                4 x seq 64 whose losses equal one rank's within rtol
                1e-5; (b) whisper-small at full width and depth (12 + 12
                layers, 12 heads) on mesh 1x8: neither 12 heads nor 12 kv
                heads divide 8, so every attention runs whole on every
                rank and the self cache (prompt 32 + 8 tokens) and the
                cross cache (64 frames) split their sequence over
                ``model``, the softmax partials merged across the ranks;
                B = 4 with seeded frames; (c) pixtral-12b at full width and
                2 of 40 layers on mesh 2x2 with B = 1: the batch does not
                divide ``data``, so the cache's sequence (8 image
                embeddings + prompt 32 + 8 tokens) splits over it, and the
                8 kv heads split 4 a rank;
 18. parent (only with --parent DIR) — the parent commit's Bloom CE
                kernels, built from DIR/bloom_ce.cu beside this tree's
                (``sweep_ce.start_parent``), timed in turns (parent,
                change, change, parent), warm and L2-cold: the forward
                and backward at T = 512, k = 4 and m = 30,208, 10,240
                and the half range 15,104 of 30,208 (ranged entries), dz
                bit-identical to the parent's and the forward within
                rtol 1e-6 / atol 1e-5 of it.
Then the card's name and power limit, one JSON line of kernel numbers, and
last ``{"ok": true, "device": {...}}``.  Any failure raises: the exit code
is not 0 and the last line is not printed.  Without a CUDA device, or
without the repository's src/ beside this file, it exits non-zero at once.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"


def _rates():
    """The H100 SXM's rates, kept in one place (``launch/roofline.py``):
    the bound of a kernel is the larger of bytes over ``HBM_BW`` and ops
    over ``F32_PEAK_FLOPS`` (or ``INT32_PEAK_OPS``)."""
    from repro_torch.launch import roofline
    return roofline


@functools.lru_cache(maxsize=None)
def _card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


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
    bound_bytes_ms = nbytes / _rates().HBM_BW * 1e3
    bound_ops_ms = ops / _rates().F32_PEAK_FLOPS * 1e3
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
    b_ms = nbytes / _rates().HBM_BW * 1e3
    o_ms = ops / _rates().F32_PEAK_FLOPS * 1e3
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


def _turns(torch, common, fns, cold=True):
    """{name: (device ms (graph), back-to-back ms (events), L2-cold device
    ms (``common.cold_ms``) or None)} of each call, every call measured
    twice in turns (a, b, ..., b, a) and the two runs averaged, so that a
    drift of the card falls on every call alike."""
    order = list(fns) + list(fns)[::-1]
    runs = {n: [] for n in fns}
    for n in order:
        f = fns[n]
        runs[n].append((common.graph_time_ms(f, 20, 5),
                        common.time_ms(f, 50, 3),
                        common.cold_ms(f) if cold else None))
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
                  f" / L2-cold device ms: {_turns_line(times)}; "
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
    from repro_torch.kernels import sweep_ce
    n = sweep_ce.edge_cases(ce._library(), None, gen)
    print(f"kernels-train: bloom_ce on {n} branch cases (k = 1, 2, 3, 4, 8, "
          "40; m = 8, 37, 1,000, 10,240, 30,211; unranged, lo = 0 and 100 "
          "with a row's labels all outside; -inf columns and rows; an "
          "unaligned row) within tolerance of the plain versions",
          flush=True)

    rows = []
    for (name, cold, bound_ms, by), err, line in zip(
            _time_ce(torch, ce, common, 512, m, k, gen, "kernels-train"),
            (err_fwd, err_bwd), (145, 87)):
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/bloom_ce.cu",
                     "replaces": f"src/repro/kernels/bloom_ce.py:{line}",
                     "launches": None, "max_abs_err": err,
                     "ms": cold["kernel"], "plain_ms": cold["plain"],
                     "bound_ms": bound_ms, "bound_by": by,
                     "library_ms": cold["library"]})
    return rows


def _time_ce(torch, ce, common, T, m, k, gen, phase):
    """bloom_ce forward and backward at (T, m, k) on seeded logits, timed
    beside their plain versions and one library call each, warm (graph,
    events) and L2-cold (``common.cold_ms``: the bound is HBM bytes, and
    logits under the 50 MB L2 stay there between graph replays), with
    their bounds; prints a line each and returns [(name, L2-cold ms by
    call, bound ms, bound by)] for the forward and the backward."""
    dev = torch.device("cuda")
    z = (3.0 * torch.randn(T, m, generator=gen)).to(dev)
    h = torch.randint(0, m, (T, k), generator=gen, dtype=torch.int32).to(dev)
    g = torch.randn(T, generator=gen).to(dev)
    hl = h.long()
    _, lse = ce.bloom_ce_cuda(z, h)
    neg = torch.full((T, k), -1.0 / k, device=dev)
    common.graph_time_ms(lambda: ce.bloom_ce_cuda(z, h), 20, 5)  # clocks up
    fwd = {
        "kernel": lambda: ce.bloom_ce_cuda(z, h),
        "plain": lambda: ce.bloom_ce_plain(z, h),
        "library": lambda: torch.logsumexp(z, -1) - z.gather(1, hl).mean(-1)}
    bwd = {
        "kernel": lambda: ce.bloom_ce_bwd_cuda(g, z, h, lse),
        "plain": lambda: ce.bloom_ce_bwd_plain(g, z, h, lse),
        "library": lambda: torch.softmax(z, -1).scatter_add_(1, hl, neg)
        * g[:, None]}
    out = []
    for label, name, fns, nbytes, ops in (
            ("forward", ce.FWD, fwd, ce.min_bytes(T, m, k), 4 * T * m),
            ("backward", ce.BWD, bwd, ce.min_bytes(T, m, k, backward=True),
             5 * T * m + T * m * k)):
        times, cold = _times(common, fns), _cold_times(common, fns)
        bound_ms, by = _bound(nbytes, ops)
        print(f"{phase}: bloom_ce {label} T={T} m={m} k={k}: device "
              f"ms (graph) / back-to-back ms (events): "
              f"{_times_line(times)}; L2-cold device ms: "
              f"{_cold_line(cold)}; bound {bound_ms * 1e3:.3f} us ({by}, "
              f"{nbytes} bytes), share of bound L2-cold "
              f"{bound_ms / cold['kernel']:.3f} (graph "
              f"{bound_ms / times['kernel'][0]:.3f}); {_card()}", flush=True)
        out.append((name, cold, bound_ms, by))
    return out


def _cold_times(common, fns):
    """{name: L2-cold device ms (``common.cold_ms``)} of each call."""
    return {n: common.cold_ms(f) for n, f in fns.items()}


def _cold_line(cold) -> str:
    return ", ".join(f"{n} {c:.6f}" for n, c in cold.items())


def _time_csr(torch, csr, common, T, k, D, m, gen, phase):
    """The CSR scatter-add (bf16 gradient rows) and the card's binning at
    (T, k, D, m) on seeded indices, timed beside their plain versions and
    ``index_add_``, with their bounds; prints one line and returns (times,
    (bound ms, by) of the scatter, (bound ms, by) of the binning, and the
    call as the backward makes it, binning plus kernel)."""
    dev = torch.device("cuda")
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
    bound = _bound(nbytes, T * k * D)
    bin_bytes = csr.bin_min_bytes(T * k, m)
    bin_bound = _bound_int(bin_bytes, T * k + m)
    print(f"{phase}: bloom_csr bf16 T={T} k={k} D={D} m={m}: device "
          f"ms (graph) / back-to-back ms (events): {_times_line(times)}, "
          f"bound {bound[0] * 1e3:.3f} us ({bound[1]}, {nbytes} bytes); "
          f"binning bound {bin_bound[0] * 1e3:.3f} us ({bin_bound[1]}, "
          f"{bin_bytes} bytes)", flush=True)
    return times, bound, bin_bound, lambda: csr.csr_scatter_add(g, idx, m)


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

    times, (bound_ms, by), (bin_bound_ms, bin_by), called = _time_csr(
        torch, csr, common, T, k, D, m, gen, "kernels-train")
    print("kernels-train: the CSR backward as called, device time by kernel "
          "(torch.profiler): " + _split_line(_device_split(torch, called)),
          flush=True)
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
    roofline_share(torch, cfg, batch, seq, med / 1e3,
                   torch.cuda.max_memory_allocated())

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


def roofline_share(torch, cfg, batch: int, seq: int, step_s: float,
                   peak_bytes: int) -> None:
    """The roofline's share of train-lm's measured step (the module's
    docstring): the step's tokens are (batch, seq + 1), the window the
    training loop cuts, so the count's shape is that."""
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.launch import dryrun, sharding
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.mesh import counting_mesh
    roofline = _rates()
    shape = ShapeConfig("train_lm", seq + 1, batch, "train")
    tc = TrainConfig(optimizer="adamw", learning_rate=3e-3,
                     grad_clip_norm=1.0, steps=8, warmup_steps=10)
    dist = sharding.DistContext(counting_mesh((1, 1)))
    count = dryrun.count_step(*dryrun.step_variant(cfg, shape, dist, tc),
                              dist.mesh.transport)
    terms = roofline.roofline_terms(count["flops_dev"], count["bytes_dev"],
                                    count["collectives"]["total_bytes"])
    mf = roofline.model_flops(cfg, shape)
    dev = torch.device("cuda")
    model = steps_lib.init_fn_for(cfg)(0).to(dev)
    params = {n: p.detach() for n, p in model.named_parameters()}
    state = steps_lib.make_train_step(cfg, tc)[1].init(params)
    tokens = torch.zeros(batch, seq + 1, dtype=torch.int32, device=dev)
    on_card = dryrun.storage_bytes((params, state, {"tokens": tokens}))
    mem = count["memory"]
    del model, params, state
    torch.cuda.empty_cache()
    _check(mem["argument_bytes"] == on_card, f"train-lm roofline: meta "
           f"argument_bytes {mem['argument_bytes']} != {on_card} bytes of "
           "the same tensors on the card")
    print(f"train-lm roofline: {cfg.name} batch {batch} x {seq + 1} tokens, "
          f"one rank; model FLOPs {mf:.6e} over (median step "
          f"{step_s * 1e3:.6f} ms x bf16 peak {roofline.PEAK_FLOPS:.4e}) = "
          f"{mf / (step_s * roofline.PEAK_FLOPS):.6f}; counted on meta "
          f"(mesh 1x1): {count['flops_dev']:.6e} FLOPs, "
          f"{count['bytes_dev']:.6e} bytes, bound "
          f"{terms['step_time_s'] * 1e3:.6f} ms ({terms['dominant']}: "
          f"compute {terms['compute_s'] * 1e3:.6f} ms, memory "
          f"{terms['memory_s'] * 1e3:.6f} ms) = "
          f"{terms['step_time_s'] / step_s:.6f} of the measured step; "
          f"argument_bytes {mem['argument_bytes']} == the same tensors on "
          f"the card; temp_bytes {mem['temp_bytes']} (argument + temp "
          f"{(mem['argument_bytes'] + mem['temp_bytes']) / 2 ** 30:.3f} "
          f"GiB) beside max_memory_allocated {peak_bytes / 2 ** 30:.3f} "
          f"GiB; Bloom kernels counted {count['kernels']}; {_card()}",
          flush=True)


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
    b_ms = nbytes / _rates().HBM_BW * 1e3
    o_ms = int_ops / _rates().INT32_PEAK_OPS * 1e3
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
              f"device ms: {_turns_line(times)}; plain "
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
                phase="serve-batch", around=None, embeds=None, hold=None):
    """serve.generate's whole-batch loop walked step by step through
    make_prefill_step and make_decode_step, holding at every step the
    embedding as the model computes it (the token kernel) bit-equal to
    the plain gather-sum, and the decode-top-k kernel's ids and scores
    bit-equal to bloom_decode_topk_plain on the same logp.  ``around(label,
    step)``, if given, runs the prefill and the first decode step (it
    calls ``step()`` and returns its result), so a phase can hold a layer
    inside them.  ``embeds`` (the frontend's image embeddings or frames)
    go into the prefill, and then each decode step's logits are held to a
    full pass over the prefix and every token so far, within
    FRONTEND_TOL x its max |logit|.  ``hold()``, if given, is a context
    the walk (not the timed steps after it) runs in.  Returns the (B,
    gen) ids."""
    from repro_torch.core import bloom
    from repro_torch.kernels import ops
    from repro_torch.launch import serve, steps as steps_lib
    from repro_torch.models import io as io_lib
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

    apply_fn = steps_lib.apply_fn_for(cfg)
    full_errs = []

    def check_full(seq, logits, label):
        with torch.inference_mode():
            ref = apply_fn(model, cfg, seq, mode="train",
                           embeds=embeds)["logits"][:, -1].float()
        err = float((logits.float() - ref).abs().max())
        scale = float(ref.abs().max())
        _check(err <= FRONTEND_TOL * scale,
               f"{cfg.name} {label}: decode step vs a full pass: max abs "
               f"err {err} of max |logit| {scale}")
        full_errs.append(err / scale)

    tokens = torch.as_tensor(prompts, device=dev)
    with contextlib.nullcontext() if hold is None else hold():
        check_embed(tokens, "prefill")
        pre = run("prefill", lambda: prefill(model, tokens, embeds))
        template, n_prefix = serve.decode_caches(cfg, B, S, gen, embeds, dev)
        caches = serve.pad_caches_to(pre["caches"], template)
        with torch.inference_mode():
            scores, ids = io_lib.recover_topk(cfg, pre["last_logits"],
                                              topk=topk)
        check_decode(pre["last_logits"], scores, ids, "prefill")
        token, out_ids = ids[:, :1], [ids[:, :1]]
        for t in range(gen - 1):
            check_embed(token, f"decode step {t + 1}")
            step = lambda: decode(  # noqa: E731
                model, token, caches, n_prefix + t)
            out = run("decode step 1", step) if t == 0 else step()
            caches = out["caches"]
            check_decode(out["logits"][:, 0], out["topk_scores"],
                         out["topk_ids"], f"decode step {t + 1}")
            if embeds is not None:
                check_full(torch.cat([tokens, *out_ids], 1),
                           out["logits"][:, 0], f"decode step {t + 1}")
            token = out["topk_ids"][:, :1]
            out_ids.append(token)
    if full_errs:
        print(f"{phase}: {cfg.name}: every walked decode step (at positions "
              f"{n_prefix}-{n_prefix + gen - 2}) held to a full pass over "
              f"the prefix and the tokens so far: max abs err / max |logit| "
              f"by step {[round(e, 6) for e in full_errs]} (limit "
              f"{FRONTEND_TOL})", flush=True)
    # one more decode step at the last position, repeated: its wall (host
    # clock, synchronised) beside its device time by kernel (profiler)
    step = lambda: decode(  # noqa: E731
        model, token, caches, n_prefix + gen - 1)
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


# the encoder-decoder and vision-frontend archs at full width, each as
# (the widths it must have: decoder layers, encoder layers, d_model,
# (heads, kv heads, head_dim), d_ff, vocab, m, k, frontend, compute dtype;
# the walk's frontend rows and tokens per row, B = 4): whisper's 1,500
# frames are the reference's 30 s window (configs.cache_specs); pixtral's
# S_tot 128 keeps int(128 x frontend_frac) = 32 rows for the image, the
# reference's input_specs rule
SERVE_FRONTENDS = {
    "whisper-small": ((12, 12, 768, (12, 12, 64), 3072, 51865, 10240, 4,
                       "audio_stub", "bfloat16"), 1500, 32),
    "pixtral-12b": ((40, 0, 5120, (32, 8, 128), 14336, 131072, 26112, 4,
                     "vision_stub", "bfloat16"), 32, 96),
}
# a bf16 decode step against a full pass over the same positions: the two
# round their products at other shapes (GEMV vs GEMM), a few bf16 ulps of
# the largest logit after the whole depth
FRONTEND_TOL = 2 ** -5


def _frontend_shape(cfg):
    return (cfg.num_layers, cfg.encoder_layers, cfg.d_model,
            (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim),
            cfg.d_ff, cfg.vocab, cfg.m_vocab, cfg.bloom.k, cfg.frontend,
            cfg.dtype)


def _train_frontend(torch, common, names, errs, held):
    """whisper-small at full width, 8 steps through launch/train.run
    (batch 8, seq 64, the reference's zero frames), counts reset just
    before and read just after: each step launches each kernel of
    ``names`` once; with ``held`` every launch is held against its plain
    version as it happens.  Returns (counts, losses, step walls in ms of
    steps 2-8)."""
    from repro_torch.launch import train
    steps = 8
    torch.cuda.synchronize()
    common.reset_launches()
    with (held_to_plain(torch, common, "serve-frontends: whisper-small "
                        "training", errs) if held
          else contextlib.nullcontext()):
        _, hist = train.run("whisper-small", steps=steps, batch=8, seq=64,
                            full=True, log_every=1)
        torch.cuda.synchronize()
    counts = dict(common.LAUNCHES)
    _check(counts == {n: steps for n in names},
           f"serve-frontends: whisper-small training launched {counts}, "
           f"want {steps} each of {names}")
    losses = [h["loss"] for h in hist]
    _check(len(losses) == steps and all(math.isfinite(x) for x in losses),
           f"serve-frontends: whisper-small losses {losses}")
    return counts, losses, [h["step_s"] * 1e3 for h in hist[1:]]


def phase_serve_frontends(torch, be, dt, common, train_names):
    """The encoder-decoder and vision-frontend archs at full width and
    depth, weights drawn on the card from seed 0 in bf16 block by block:
    whisper-small and pixtral-12b, each through launch.serve.run twice
    (batch 4, prompt 32, gen 12, topk 8; the reference's zero frames /
    image embeddings), counts reset just before and read just after each
    run, the replay giving the same ids; then the loop walked step by step
    with seeded nonzero frames (1,500) / image embeddings (32, ahead of 96
    tokens) inside ``held_to_plain``, every decode step held to a full
    pass; then both kernels timed at the arch's shapes.  Then whisper-small
    trained 8 steps at full width twice, once with every launch held to
    its plain version and once timed, the losses finite and equal.
    Returns (the launches of the counted runs by kernel, max abs error by
    kernel)."""
    import gc
    import numpy as np
    from repro_torch import configs
    from repro_torch.launch import serve
    dev = torch.device("cuda")
    B, S, gen, topk = SERVE_BATCH
    totals, errs = {}, {}
    gc.collect()
    torch.cuda.empty_cache()
    print(f"serve-frontends: {torch.cuda.memory_allocated() / 1e9:.3f} GB "
          "allocated before the phase", flush=True)
    for arch, (want, n_emb, n_tok) in SERVE_FRONTENDS.items():
        cfg = configs.get_config(arch)
        _check(_frontend_shape(cfg) == want,
               f"serve-frontends: {arch} config {_frontend_shape(cfg)}")
        runs = [_counted(
            torch, be, dt, common, "serve-frontends", totals,
            f"{arch} serve.run {i + 1}", cfg, lambda: serve.run(
                arch, batch=B, prompt_len=S, gen=gen, topk=topk, full=True,
                device=dev)) for i in range(2)]
        _check(np.array_equal(runs[0], runs[1]),
               f"serve-frontends: {arch}: the replay of serve.run gave "
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
        print(f"serve-frontends: {arch} {cfg.num_layers}L"
              + (f" + {cfg.encoder_layers}L encoder" if cfg.encoder_layers
                 else "") +
              f" {cfg.family} d_model {cfg.d_model} vocab {cfg.vocab} m "
              f"{cfg.m_vocab} k {cfg.bloom.k}: {n_params:,} params "
              f"({n_bytes / 1e9:.3f} GB) drawn on the card block by block, "
              f"set-up {setup:.3f} s, peak allocated "
              f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB", flush=True)
        prompts = np.random.default_rng(0).integers(
            0, cfg.vocab, size=(B, n_tok), dtype=np.int32)
        embeds = torch.randn(B, n_emb, cfg.d_model, generator=torch.Generator(
            dev).manual_seed(0), device=dev).to(getattr(torch, cfg.dtype))
        walked = _walk_batch(
            torch, be, dt, cfg, model, prompts, gen, topk,
            phase="serve-frontends", embeds=embeds,
            hold=lambda: held_to_plain(  # noqa: B023
                torch, common, f"serve-frontends: {arch} walk", errs))
        print(f"serve-frontends: {arch}: {n_emb} seeded "
              f"{cfg.frontend} rows and {n_tok} tokens a row, every step's "
              f"kernels held against their plain versions; "
              f"{len(np.unique(walked))} distinct ids of {walked.size}; ids "
              f"(first seq) {walked[0].tolist()}", flush=True)
        _time_batch_kernels(torch, be, dt, common, cfg, model, B, n_tok,
                            topk, phase="serve-frontends")
        del model, embeds
        gc.collect()
        torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    counts, losses, _ = _train_frontend(torch, common, train_names, errs,
                                        held=True)
    again, replay, step_ms = _train_frontend(torch, common, train_names,
                                             errs, held=False)
    np.testing.assert_allclose(replay, losses, rtol=1e-6)
    for c in (counts, again):
        for n, k in c.items():
            totals[n] = totals.get(n, 0) + k
    med = float(np.median(step_ms))
    print(f"serve-frontends: whisper-small trained 8 steps at full width "
          f"(batch 8, seq 64, 16 zero frames a row) twice: losses {losses}, "
          f"the second run's equal within rtol 1e-6; every launch of the "
          f"first held against its plain version; the second's median step "
          f"wall {med:.6f} ms (steps 2-8: "
          f"{[round(x, 3) for x in step_ms]}), peak allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB, launches "
          f"{counts} a run", flush=True)
    # the training kernels at whisper-small's shapes: bloom_ce over the
    # 8 x 64 predicted positions, the CSR backward over the 8 x 65 tokens
    from repro_torch.kernels import bloom_ce as ce
    from repro_torch.kernels import bloom_csr as csr
    cfg = configs.get_config("whisper-small")
    gen = torch.Generator().manual_seed(23)
    _time_ce(torch, ce, common, 8 * 64, cfg.m_vocab, cfg.bloom.k, gen,
             "serve-frontends")
    _time_csr(torch, csr, common, 8 * 65, cfg.bloom.k, cfg.d_model,
              cfg.m_vocab, gen, "serve-frontends")
    print(f"serve-frontends: every walked and trained launch held against "
          f"its plain version, max abs err by kernel {errs}", flush=True)
    return totals, errs


# qwen1.5-0.5b at full width (hf:Qwen/Qwen1.5-0.5B), the widths the
# serve-sharded phase must see: layers, d_model, (heads, kv heads,
# head_dim), vocab, m, k, compute dtype; and mamba2-1.3b's (arXiv:
# 2405.21060): layers, d_model, vocab, m, k, dtype
SHARDED_QWEN = (24, 1024, (16, 16, 64), 151936, 30208, 4, "bfloat16")
SHARDED_MAMBA = (48, 2048, 50280, 9984, 4, "bfloat16")


def _counted_sharded(torch, be, dt, common, label, cfg, totals, errs, fn):
    """Run ``fn`` (which returns its model steps, prefills plus decode
    steps, and a result) with the counts reset just before and read just
    after, every launch held against its plain version
    (``held_to_plain``): it must launch the embed kernel's token entry and
    bloom_decode_topk once per model step each, and nothing else.  Adds
    the counts to ``totals``; returns the result."""
    from repro_torch.models import io as io_lib
    embed_name = be.token_variant_name(io_lib.vocab_spec(cfg))
    torch.cuda.synchronize()
    common.reset_launches()
    with held_to_plain(torch, common, f"serve-sharded: {label}", errs):
        steps, out = fn()
        torch.cuda.synchronize()
    counts = dict(common.LAUNCHES)
    _check(counts == {embed_name: steps, dt.NAME: steps},
           f"serve-sharded: {label}: launched {counts} for {steps} "
           f"prefills + decode steps")
    for n, c in counts.items():
        totals[n] = totals.get(n, 0) + c
    print(f"serve-sharded: {label}: {steps} prefills + pool decode steps, "
          f"launches {counts}, each held against its plain version",
          flush=True)
    return out


def _solo_gaps(torch, dt, cfg, model, report):
    """Print, for every request whose pool tokens differ from solo B = 1
    serving, the first differing token and the top-2 gap of the Eq. 3
    scores there (the plain decode of a B = 1 prefill of the prompt and
    the tokens before it).  Returns the differing rids."""
    import numpy as np
    from repro_torch.core import bloom
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import io as io_lib
    from repro_torch.serving.loadgen import LoadSpec, sharded_workload
    from repro_torch.serving import sim_multihost as sim
    pool = report["single"]["tokens"]
    bad = sorted(rid for rid in pool if pool[rid] != report["solo"][rid])
    if not bad:
        return bad
    dev = model.embed.device
    spec = io_lib.vocab_spec(cfg)
    H = bloom.cached_hash_matrix(spec, dev)
    prompts = {r.rid: r.prompt for reqs in sharded_workload(LoadSpec(
        n_requests=2, vocab=cfg.vocab, rate=1.0, prompt_lens=(6, 10),
        gen_lens=(3, 6, 12), seed=0), sim.N_HOSTS) for r in reqs}
    prefill = steps_lib.make_prefill_step(cfg)
    for rid in bad:
        a, b = pool[rid], report["solo"][rid]
        i = next(j for j in range(len(a)) if a[j] != b[j])
        seq = np.concatenate([prompts[rid], np.asarray(a[:i], np.int32)])
        last = prefill(model, torch.as_tensor(seq, device=dev)[None])[
            "last_logits"]
        sc, ids = dt.bloom_decode_topk_plain(
            torch.log_softmax(last.float(), -1), H, 2)
        print(f"serve-sharded: NEAR-TIE rid {rid} token {i}: pool "
              f"{a[i]}, solo {b[i]}; plain top-2 ids {ids[0].tolist()} "
              f"scores {sc[0].tolist()}, gap "
              f"{float(sc[0, 0] - sc[0, 1]):.6g}", flush=True)
    return bad


def _walk_pool_step(torch, be, dt, cfg, engine):
    """One pool decode step of ``engine`` walked by hand: three requests
    prefilled into slots of hosts 0, 2 and 5 (the other 13 rows dead),
    then the stage-0 step: its embedding bit-equal to the plain
    gather-sum, its top-k ids and scores, active mask included, bit-equal
    to bloom_decode_topk_plain on the same logp.  Then the step's wall
    (host clock, synchronised) and device time by kernel, with the 3 rows
    live and with all 16.  Returns (wall ms, busy ms) of the 3-live
    step."""
    from repro_torch.core import bloom
    from repro_torch.kernels import ops
    from repro_torch.models import io as io_lib
    from repro_torch.serving.loadgen import LoadSpec, sharded_workload
    from repro_torch.serving.scheduler import ShardedScheduler
    from repro_torch.serving.sharded_pool import _PoolClient
    dev = engine.mesh.device
    spec = io_lib.vocab_spec(cfg)
    H = bloom.cached_hash_matrix(spec, dev)
    model = engine.params
    client = _PoolClient(engine, ShardedScheduler(engine.n_hosts,
                                                  engine.slots_per_host))
    wl = sharded_workload(LoadSpec(n_requests=1, vocab=cfg.vocab,
                                   prompt_lens=(6, 10), gen_lens=(8,),
                                   seed=7), engine.n_hosts)
    reqs = [wl[h][0] for h in (0, 2, 5)]
    for h, r in zip((0, 2, 5), reqs):
        r.slot = h * engine.slots_per_host + h % engine.slots_per_host
    for r, first in zip(reqs, client.prefill(reqs)):
        client.start_slot(r, first)
    tok = torch.from_numpy(client.tokens).to(dev)
    pos = torch.from_numpy(client.pos).to(dev)
    active = torch.from_numpy(client.active).to(dev)
    step = lambda: engine._decode(  # noqa: E731
        model, tok, client.caches, pos, active)
    with torch.inference_mode():
        got = ops.bloom_embed(model.embed, tok, spec)
        want, _ = be.bloom_embed_tokens_plain(
            model.embed, None, tok.reshape(-1), spec, model.embed.dtype)
        _check(torch.equal(got.reshape(want.shape), want),
               "serve-sharded: walked pool step: embedding kernel != plain "
               "gather-sum")
        out = step()
        logits = out["logits"][:, 0]
        _check(bool(torch.isfinite(logits[active]).all()),
               "serve-sharded: walked pool step: non-finite logits")
        pv, pi = dt.bloom_decode_topk_plain(
            torch.log_softmax(logits.float(), -1), H, engine.topk, active)
        _check(torch.equal(out["topk_ids"], pi)
               and torch.equal(out["topk_scores"], pv),
               "serve-sharded: walked pool step (3 of 16 rows live): "
               "decode-top-k kernel != plain version")
    live = client.active.nonzero()[0].tolist()
    print(f"serve-sharded: walked pool step, rows {live} of "
          f"{engine.n_slots} live: embedding and top-k ids "
          f"and scores bit-equal to the plain versions; live ids "
          f"{out['topk_ids'][active, 0].tolist()}", flush=True)
    res = {}
    for label, act in (("3 of 16 live", active),
                       ("16 of 16 live", torch.ones_like(active))):
        fn = lambda: engine._decode(  # noqa: E731
            model, tok, client.caches, pos, act)
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 10 * 1e3
        split = _device_split(torch, fn, calls=5)
        busy = sum(split.values()) / 1e3
        top = dict(sorted(split.items(), key=lambda kv: -kv[1])[:5])
        print(f"serve-sharded: {cfg.name} pool decode step (B = 16, "
              f"{label}): wall {wall:.3f} ms, device busy {busy:.3f} ms "
              f"({busy / wall:.4f}), top kernels: {_split_line(top)}",
              flush=True)
        res.setdefault("walls", []).append((wall, busy))
    return res["walls"][0]


def _time_sharded(torch, cfg, model, report):
    """The sim's workload served unheld, three turns of (sharded
    collective compact, sharded sim plain, single-host Engine at 16
    slots), alternating the order: each run's wall, tok/s and wall per
    model pass (prefill or pool decode step); then the collective
    gather's cost per round on the card."""
    import numpy as np
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.serving import sim_multihost as sim
    from repro_torch.serving.control import DELTA_FIELDS
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.loadgen import (LoadSpec, merge_workloads,
                                             sharded_workload)
    from repro_torch.serving.sharded_pool import (COLLECTIVE_CAPACITY,
                                                  ShardedEngine)
    spec = LoadSpec(n_requests=2, vocab=cfg.vocab, rate=1.0,
                    prompt_lens=(6, 10), gen_lens=(3, 6, 12), seed=0)
    sharded = ShardedEngine(
        cfg, model, mesh=make_serving_mesh(sim.N_HOSTS, device="cuda"),
        slots_per_host=sim.SLOTS_PER_HOST, max_len=sim.MAX_LEN,
        topk=sim.TOPK, prefill_workers=sim.PREFILL_WORKERS)
    single = Engine(cfg, model, n_slots=sim.N_HOSTS * sim.SLOTS_PER_HOST,
                    max_len=sim.MAX_LEN, topk=sim.TOPK)
    runs = {
        "sharded collective compact": lambda: sharded.run(
            sharded_workload(spec, sim.N_HOSTS), transport="collective",
            compact_threshold=sim.COMPACT_THRESHOLD),
        "sharded sim plain": lambda: sharded.run(
            sharded_workload(spec, sim.N_HOSTS), transport="sim",
            compact_threshold=None),
        "single-host Engine": lambda: single.run(
            merge_workloads(sharded_workload(spec, sim.N_HOSTS)))}
    labels = list(runs)
    order = labels + labels[::-1] + labels     # three turns each
    got = {}
    for label in order:
        torch.cuda.synchronize()
        res, st = runs[label]()
        torch.cuda.synchronize()
        _check(all(r.done for r in res.values()),
               f"serve-sharded: timed {label}: a request was not served")
        toks = {rid: r.tokens for rid, r in res.items()}
        _check(toks == report["single"]["tokens"],
               f"serve-sharded: timed {label}: tokens differ from the held "
               "runs'")
        passes = st.prefills + st.decode_steps
        got.setdefault(label, []).append(
            (st.wall_s * 1e3, st.tokens_out / st.wall_s,
             st.wall_s * 1e3 / passes, passes))
    for label, rows in got.items():
        print(f"serve-sharded: timed {label}: wall "
              f"{[round(r[0], 3) for r in rows]} ms, "
              f"{[round(r[1], 1) for r in rows]} tok/s, wall per model "
              f"pass {[round(r[2], 3) for r in rows]} ms ({rows[0][3]} "
              f"passes: 16 B = 1 prefills and 14 pool decode steps)",
              flush=True)
    g = sharded._gather
    buf = np.zeros((sim.N_HOSTS, COLLECTIVE_CAPACITY + 1,
                    DELTA_FIELDS), np.int32)
    g(buf)
    t0 = time.perf_counter()
    for _ in range(50):
        g(buf)
    ms = (time.perf_counter() - t0) / 50 * 1e3
    coll = [report["runs"][n]["stats"]["decode_steps"]
            for n in ("collective_plain", "collective_compact")]
    print(f"serve-sharded: collective transport: one exchange round "
          f"(commit {sim.N_HOSTS} host buffers of "
          f"{tuple(buf.shape[1:])} int32, {sim.N_HOSTS} gathers on the "
          f"card, one copy back) {ms:.4f} ms on the host clock; the "
          f"matrix's two collective runs ran {report['collective_rounds']} "
          f"rounds over {sum(coll)} decode steps", flush=True)
    return got


def phase_serve_sharded(torch, be, dt, common):
    """Data-axis-sharded serving at full width: qwen1.5-0.5b through the
    reference sim's matrix (serving.sim_multihost.run, 8 hosts x 2 slots,
    {sim, collective} x {plain, compact 0.25}, the single-host Engine and
    solo serving), its chaos and overload drills, a walked pool step,
    mamba2-1.3b through one compact run, serve.run_sharded as the CLI
    calls it, and the timed runs.  Every counted run's launches held
    against their plain versions.  Returns (launches by kernel, max abs
    error by kernel)."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.serving import sim_multihost as sim
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.loadgen import (LoadSpec, merge_workloads,
                                             sharded_workload)
    from repro_torch.serving.sharded_pool import ShardedEngine
    dev = torch.device("cuda")
    totals, errs = {}, {}
    cfg = configs.get_config("qwen1.5-0.5b")
    shape = (cfg.num_layers, cfg.d_model, (cfg.num_heads, cfg.num_kv_heads,
             cfg.resolved_head_dim), cfg.vocab, cfg.m_vocab, cfg.bloom.k,
             cfg.dtype)
    _check(shape == SHARDED_QWEN, f"serve-sharded: qwen config {shape}")
    t0 = time.perf_counter()
    model = serve.build_model(cfg, 0, dev)
    torch.cuda.synchronize()
    print(f"serve-sharded: {cfg.name} {cfg.num_layers}L d_model "
          f"{cfg.d_model} vocab {cfg.vocab} m {cfg.m_vocab} k {cfg.bloom.k} "
          f"bf16 drawn on the card from seed 0, set-up "
          f"{time.perf_counter() - t0:.3f} s", flush=True)

    def matrix():
        report = sim.run(cfg=cfg, model=model)
        return report["model_steps"], report

    report = _counted_sharded(torch, be, dt, common, "matrix", cfg, totals,
                              errs, matrix)
    for name in sim.RUNS:
        r = report["runs"][name]
        print(f"serve-sharded: {name}: {json.dumps(r['stats'])}, wall "
              f"{r['wall_s']:.3f} s", flush=True)
    print(f"serve-sharded: single-host Engine (16 slots): "
          f"{json.dumps(report['single']['stats'])}; prefill pool "
          f"{json.dumps(report['prefill_stats'])}; invariants "
          f"{json.dumps(report['invariants'])}", flush=True)
    bad = _solo_gaps(torch, dt, cfg, model, report)
    _check(not bad, f"serve-sharded: rids {bad}: the pool's tokens differ "
           "from solo B = 1 serving (near-tie lines above)")
    sim.verify_run(report)
    print(f"serve-sharded: matrix verified: {len(report['solo'])} requests "
          "done, tokens bit-equal across the four runs, the single-host "
          "Engine and solo static serving; every log equal to the "
          "model-free sim's (COMPACT included), sim == collective; "
          "compactions "
          f"{[report['runs'][n]['stats']['compactions'] for n in sim.RUNS]}"
          "; both prefill workers used; slot logs sound and linearizable; "
          "one decode step object, pool storage kept", flush=True)

    for drill, fn in (("chaos", sim.run_chaos),
                      ("overload", sim.run_overload)):
        def go(fn=fn):
            d = fn(cfg=cfg, model=model)
            return d["model_steps"], d
        d = _counted_sharded(torch, be, dt, common, f"{drill} drill", cfg,
                             totals, errs, go)
        _check(d.get("verified") is True, f"serve-sharded: {drill} drill "
               "did not verify")
        runs = d["kill_runs"] if drill == "chaos" else d["surge_runs"]
        print(f"serve-sharded: {drill} drill verified ({d['failpoints']}): "
              f"{json.dumps({t: r['stats'] for t, r in runs.items()})}; "
              f"invariants {json.dumps(d['invariants'])}", flush=True)

    engine = ShardedEngine(cfg, model,
                           mesh=make_serving_mesh(sim.N_HOSTS, device=dev),
                           slots_per_host=sim.SLOTS_PER_HOST,
                           max_len=sim.MAX_LEN, topk=sim.TOPK)
    wall, busy = _walk_pool_step(torch, be, dt, cfg, engine)
    del engine
    _time_sharded(torch, cfg, model, report)

    def cli():
        common_kw = dict(slots_per_host=2, requests=16, rate=1.0,
                         prompt_len=32, gen=16, topk=8, seed=0, full=True,
                         gossip_delay=1, transport="collective",
                         prefill_workers=1, compact_threshold=0.25,
                         hosts=8, device=dev)
        res, st = serve.run_sharded("qwen1.5-0.5b", **common_kw)
        _check(len(res) == 128 and all(r.done and len(r.tokens) == r.max_gen
                                       for r in res.values()),
               "serve-sharded: run_sharded left a request unserved")
        _check(st.compactions > 0, "serve-sharded: run_sharded never "
               "compacted")
        return st.prefills + st.decode_steps, st
    _counted_sharded(torch, be, dt, common, "serve.run_sharded (--hosts 8 "
                     "--slots-per-host 2 --transport collective "
                     "--compact-threshold 0.25 --full)", cfg, totals, errs,
                     cli)
    del model
    torch.cuda.empty_cache()

    mcfg = configs.get_config("mamba2-1.3b")
    mshape = (mcfg.num_layers, mcfg.d_model, mcfg.vocab, mcfg.m_vocab,
              mcfg.bloom.k, mcfg.dtype)
    _check(mshape == SHARDED_MAMBA, f"serve-sharded: mamba2 config {mshape}")
    mamba = serve.build_model(mcfg, 0, dev)
    spec = LoadSpec(n_requests=2, vocab=mcfg.vocab, rate=1.0,
                    prompt_lens=(6, 10), gen_lens=(3, 6, 12), seed=0)

    def mamba_runs():
        eng = ShardedEngine(mcfg, mamba,
                            mesh=make_serving_mesh(sim.N_HOSTS, device=dev),
                            slots_per_host=sim.SLOTS_PER_HOST,
                            max_len=sim.MAX_LEN, topk=sim.TOPK,
                            transport="collective",
                            compact_threshold=sim.COMPACT_THRESHOLD,
                            prefill_workers=sim.PREFILL_WORKERS)
        res, st = eng.run(sharded_workload(spec, sim.N_HOSTS))
        _check(st.compactions > 0 and "ssm" in eng._pool[0],
               "serve-sharded: mamba2's compact run never compacted")
        inv = sim.invariants(eng)
        _check(inv["decode_steps_built"] == 1 and inv["pool_storage_kept"],
               f"serve-sharded: mamba2 invariants {inv}")
        sres, sst = Engine(mcfg, mamba, n_slots=eng.n_slots,
                           max_len=sim.MAX_LEN, topk=sim.TOPK).run(
            merge_workloads(sharded_workload(spec, sim.N_HOSTS)))
        got = {rid: r.tokens for rid, r in res.items()}
        _check(all(r.done for r in res.values())
               and got == {rid: r.tokens for rid, r in sres.items()},
               "serve-sharded: mamba2's compact run != the single-host "
               "Engine's tokens")
        print(f"serve-sharded: {mcfg.name} {mcfg.num_layers}L d_model "
              f"{mcfg.d_model}: compact collective run "
              f"{json.dumps(st.as_row())}, wall {st.wall_s:.3f} s, tokens "
              f"equal to the single-host Engine's (wall {sst.wall_s:.3f} s)",
              flush=True)
        return st.prefills + st.decode_steps + sst.prefills + \
            sst.decode_steps, None
    _counted_sharded(torch, be, dt, common, f"{mcfg.name} compact run",
                     mcfg, totals, errs, mamba_runs)
    del mamba
    torch.cuda.empty_cache()
    print(f"serve-sharded: every counted launch held against its plain "
          f"version, max abs err by kernel {errs}; launches {totals}",
          flush=True)
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

    def tokens(out, want_idx, qtable, scales, toks, spec, out_dtype, what,
               lo=None):
        want, idx = be.bloom_embed_tokens_plain(qtable, scales, toks, spec,
                                                out_dtype, lo)
        if want_idx:
            equal(out[1], idx, f"{what} indices")
        return equal(out[0], want, what)

    def embed_tok(out, table, toks, spec, want_idx=False, lo=None):
        return tokens(out, want_idx, table, None, toks, spec, table.dtype,
                      "bloom_embed token entry", lo)

    def embed_tok_q(out, qtable, scales, toks, spec,
                    out_dtype=torch.float32, want_idx=False):
        return tokens(out, want_idx, qtable, scales, toks, spec, out_dtype,
                      "bloom_embed token entry (stored table)")

    def embed_bwd(out, g, idx, m, lo=None):
        return equal(out.cpu(), be.bloom_embed_bwd_plain(g.cpu(), idx.cpu(),
                                                         m, lo),
                     "bloom_embed_bwd (plain on a CPU copy)")

    def ce_fwd(out, z, h):
        loss, lse = ce.bloom_ce_plain(z, h)
        return max(close(out[0], loss, "bloom_ce loss", 1e-6, 1e-5),
                   close(out[1], lse, "bloom_ce lse", 1e-6, 1e-5))

    def ce_shard(out, z, h, lo):
        lse, hits = ce.bloom_ce_shard_plain(z, h, lo)
        return max(close(out[0], lse, "bloom_ce lse (range)", 1e-6, 0.0),
                   close(out[1], hits, "bloom_ce hits (range)", 1e-6, 0.0))

    def ce_bwd(out, g, z, h, lse, lo=None):
        return close(out, ce.bloom_ce_bwd_plain(g, z, h, lse, lo),
                     "bloom_ce dz", 0.0, 1e-7)

    def bins(out, idx, m, lo=None):
        want = csr.bin_csr_plain(idx.cpu(), m, lo)
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
            (ce, "bloom_ce_shard_cuda", ce_shard),
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




# --------------------------------------------------------------------------
# phase 17b: train-parallel
# --------------------------------------------------------------------------

def _draw(torch, cfg, seed: int, device):
    """The f32 model drawn on ``device`` by its generator seeded with
    ``seed``: the same bits in every process on the card."""
    from repro_torch.launch import steps as steps_lib
    with device:
        return steps_lib.model_class_for(cfg)(
            cfg, torch.Generator(device).manual_seed(seed))


def _parallel_batches(cfg, B: int, S: int, n: int, seed: int):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, cfg.vocab, (B, S + 1)).astype(
        np.int32)} for _ in range(n)]


def _single_rank(torch, cfg, tc, batches, seed, prefill=None):
    """The single-rank run here from the same draw: its losses and, with
    ``prefill`` tokens, the prefill's last logits and aux (the dense MoE
    path: no mesh)."""
    from repro_torch.launch import steps as steps_lib
    dev = torch.device("cuda")
    model = _draw(torch, cfg, seed, dev)
    out = {}
    if prefill is not None:
        p = steps_lib.make_prefill_step(cfg)(model,
                                             torch.as_tensor(prefill).to(dev))
        out["last_logits"], out["aux"] = p["last_logits"].float().cpu(), \
            float(p["aux"])
    step, opt = steps_lib.make_train_step(cfg, tc)
    state = opt.init({n: p.detach() for n, p in model.named_parameters()})
    out["losses"] = []
    t0 = time.perf_counter()
    for b in batches:
        state, m = step(model, state,
                        {"tokens": torch.as_tensor(b["tokens"]).to(dev)})
        out["losses"].append(float(m["loss"]))
    torch.cuda.synchronize()
    out["step_s"] = (time.perf_counter() - t0) / len(batches)
    del model, state
    torch.cuda.empty_cache()
    return out


def _rank_twins(torch, be, ce, csr, cfg, model, batch, dist_ctx):
    """This rank's ranged embed, binning, scatter and CE launches on its own
    shard (its vocab rows, its batch rows) held against their plain
    versions: the embed and the bins bit for bit, the scatter bit for bit
    against the plain version on a CPU copy, the CE within 1e-6 (lse and
    hit sum rtol 1e-6, dz atol 1e-7).  Returns the largest abs errors."""
    from repro_torch.launch import sharding
    from repro_torch.models import io as io_lib
    dev = model.embed.device
    spec, dt = io_lib.vocab_spec(cfg), getattr(torch, cfg.dtype)
    table = model.embed.detach().to(dt).contiguous()
    rows = table.shape[0]
    lo = io_lib.vocab_lo(rows, cfg, dist_ctx)
    _check(lo is not None, "train-parallel: the vocab is not sharded")
    tokens = sharding.local_batch(
        {"tokens": torch.as_tensor(batch["tokens"]).to(dev)},
        dist_ctx)["tokens"]
    flat = tokens.reshape(-1).contiguous()
    out, idx = be.bloom_embed_tokens_cuda(table, flat, spec, True, lo)
    pout, pidx = be.bloom_embed_tokens_plain(table, None, flat, spec, dt, lo)
    bins = csr.bin_csr_cuda(idx, rows, lo)
    gen = torch.Generator().manual_seed(11 + dist_ctx.mesh.rank)
    g = torch.randn(flat.shape[0], table.shape[1], generator=gen).to(dt)
    got = csr.csr_scatter_add_cuda(g.to(dev), bins, rows)
    labels = tokens[:, 1:].reshape(-1)
    h = spec.indices_for(labels).contiguous()
    z = (3.0 * torch.randn(h.shape[0], rows, generator=gen)).to(dev)
    lse, hits = ce.bloom_ce_shard_cuda(z, h, lo)
    gy = torch.rand(h.shape[0], generator=gen).to(dev)
    dz = ce.bloom_ce_bwd_cuda(gy, z, h, lse, lo)
    torch.cuda.synchronize()
    _check(torch.equal(out, pout) and torch.equal(idx, pidx),
           "train-parallel: ranged embed != its plain version")
    _check(all(torch.equal(a.cpu(), b) for a, b in
               zip(bins, csr.bin_csr_plain(idx.cpu(), rows, lo))),
           "train-parallel: ranged bins != bin_csr_plain's")
    _check(torch.equal(got.cpu(), csr.csr_scatter_add(g, idx.cpu(), rows,
                                                      lo)),
           "train-parallel: scatter on the ranged bins != plain version")
    plse, phits = ce.bloom_ce_shard_plain(z, h, lo)
    pdz = ce.bloom_ce_bwd_plain(gy, z, h, lse, lo)
    torch.testing.assert_close(lse, plse, rtol=1e-6, atol=0)
    torch.testing.assert_close(hits, phits, rtol=1e-6, atol=0)
    torch.testing.assert_close(dz, pdz, rtol=0, atol=1e-7)
    return {"ce_fwd": max(_max_abs_err(lse, plse),
                          _max_abs_err(hits, phits)),
            "ce_bwd": _max_abs_err(dz, pdz)}


def _rank_parallel(mesh, jobs):
    """One rank of phase train-parallel: each job ({shape, cfg, tc, seed,
    batches, prefill}) in turn on a (data, model) mesh of its shape over
    the same four ranks, from weights rank 0 draws on the card and
    broadcasts.  Returns per job its losses, step walls, collective
    seconds per step, the transport's branches, its launch counts (reset
    just before the job's prefill and steps, read just after), the twin
    checks' errors and its peak memory."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import bloom_ce as ce
    from repro_torch.kernels import bloom_csr as csr
    from repro_torch.kernels import bloom_embed as be
    from repro_torch.kernels import common
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch import train
    tr, dev = mesh.transport, mesh.device
    results = []
    for job in jobs:
        cfg, tc = job["cfg"], job["tc"]
        dist_ctx = sharding.DistContext(
            mesh if job["shape"] == mesh.sizes else mesh_lib.world_mesh(
                job["shape"], mesh.axis_names, dev, tr))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        step, optimizer = steps_lib.make_train_step(cfg, tc, dist_ctx)
        full = (dict(_draw(torch, cfg, job["seed"], dev).named_parameters())
                if mesh.rank == 0 else None)
        model, opt_state, _, _, _, _ = train.parallel_state(
            cfg, optimizer, job["seed"], None, dist_ctx, full)
        del full
        torch.cuda.synchronize()
        r = {"setup_s": time.perf_counter() - t0}
        common.reset_launches()
        tr.branches.clear()
        tr.seconds, tr.timed = 0.0, True
        if job["prefill"] is not None:
            out = steps_lib.make_prefill_step(cfg, dist_ctx)(
                model, torch.as_tensor(job["prefill"]).to(dev))
            r["last_logits"] = out["last_logits"].float().cpu().numpy()
            r["aux"] = float(out["aux"])
        r.update(losses=[], walls=[], coll=[])
        for b in job["batches"]:
            batch = {"tokens": torch.as_tensor(b["tokens"]).to(dev)}
            torch.cuda.synchronize()
            c0, t1 = tr.seconds, time.perf_counter()
            opt_state, m = step(model, opt_state, batch)
            torch.cuda.synchronize()
            r["walls"].append(time.perf_counter() - t1)
            r["coll"].append(tr.seconds - c0)
            r["losses"].append(float(m["loss"]))
        r["counts"] = dict(common.LAUNCHES)
        r["branches"] = {f"{op} {b}": n for (op, b), n in
                         sorted(tr.branches.items())}
        tr.timed = False
        r["twins"] = _rank_twins(torch, be, ce, csr, cfg, model,
                                 job["batches"][0], dist_ctx)
        r["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        del model, opt_state
        torch.cuda.empty_cache()
        results.append(r)
    return results


def _ranged_kernels(torch, be, ce, csr, common):
    """The ranged kernels in this process: bit-identical checks and the
    times at the full range (lo = 0) and the half range beside the
    unranged kernel; returns {name: row} of the kernels line."""
    from repro_torch import configs
    from repro_torch.models import io as io_lib
    dev = torch.device("cuda")
    cfg = configs.get_config("qwen1.5-0.5b")
    spec = io_lib.vocab_spec(cfg)
    m, D, k = spec.m, cfg.d_model, spec.k
    gen = torch.Generator().manual_seed(21)
    base = torch.randn(m, D, generator=gen)
    # embed token entry: lo = 0 over every row == the unranged kernel and
    # the plain version; each range == its plain version
    for dtype in (torch.float32, torch.bfloat16):
        for T, Dc in ((1, D), (8, D), (260, D), (260, 1000)):
            table = base[:, :Dc].to(dtype).contiguous().to(dev)
            tok = torch.randint(-1, spec.d, (T,), generator=gen).to(dev)
            whole, _ = be.bloom_embed_tokens_cuda(table, tok, spec)
            for lo, rows in ((0, m), (m // 2, m // 2), (m // 4, m // 4),
                             (3 * m // 4, m // 4)):
                shard = table[lo:lo + rows].contiguous()
                got, idx = be.bloom_embed_tokens_cuda(shard, tok, spec, True,
                                                      lo)
                want, pidx = be.bloom_embed_tokens_plain(shard, None, tok,
                                                         spec, dtype, lo)
                torch.cuda.synchronize()
                _check(torch.equal(got, want) and torch.equal(idx, pidx),
                       f"bloom_embed.hash.range {dtype} T={T} D={Dc} "
                       f"lo={lo}: kernel != plain version")
                if lo == 0:
                    _check(torch.equal(got, whole), f"bloom_embed.hash."
                           f"range lo=0 {dtype} T={T} D={Dc} != unranged")
    # the CSR binning, the scatter on its bins and the dense backward
    T = 520
    idx = torch.randint(-1, m, (T, k), generator=gen, dtype=torch.int32)
    g = torch.randn(T, D, generator=gen).to(torch.bfloat16)
    whole = csr.csr_scatter_add(g, idx, m)
    for lo, rows in ((0, m), (m // 2, m // 2), (m // 4, m // 4)):
        bins = csr.bin_csr_cuda(idx.to(dev), rows, lo)
        got = csr.csr_scatter_add_cuda(g.to(dev), bins, rows)
        dense = be.bloom_embed_bwd_cuda(g.to(dev), idx.to(dev), rows, lo)
        torch.cuda.synchronize()
        _check(all(torch.equal(a.cpu(), b) for a, b in
                   zip(bins, csr.bin_csr_plain(idx, rows, lo))),
               f"bloom_csr.bin.range lo={lo}: bins != bin_csr_plain's")
        _check(torch.equal(got.cpu(), whole[lo:lo + rows])
               and torch.equal(dense, got),
               f"ranged CSR / dense backward lo={lo} != the whole table's "
               "rows")
        if lo == 0:
            _check(all(torch.equal(a, b) for a, b in zip(
                bins, csr.bin_csr_cuda(idx.to(dev), m))),
                "bloom_csr.bin.range lo=0 != the unranged binning")
    # the CE: lo = 0 == the unranged kernels; every range == plain (1e-6)
    T = 512
    z = (3.0 * torch.randn(T, m, generator=gen)).to(dev)
    h = torch.randint(0, m, (T, k), generator=gen, dtype=torch.int32)
    h[::2, 1] = h[::2, 0]
    h = h.to(dev)
    gy = torch.randn(T, generator=gen).to(dev)
    loss, lse = ce.bloom_ce_cuda(z, h)
    dz = ce.bloom_ce_bwd_cuda(gy, z, h, lse)
    l0, hits0 = ce.bloom_ce_shard_cuda(z, h, 0)
    dz0 = ce.bloom_ce_bwd_cuda(gy, z, h, lse, 0)
    torch.cuda.synchronize()
    _check(torch.equal(l0, lse) and torch.equal(dz0, dz)
           and torch.equal(lse - hits0 / k, loss),
           "bloom_ce ranged at lo=0 != the unranged kernels")
    err_f = err_b = 0.0
    for lo, rows in ((0, m), (m // 2, m // 2), (m // 4, m // 4)):
        zs = z[:, lo:lo + rows].contiguous()
        l_, s_ = ce.bloom_ce_shard_cuda(zs, h, lo)
        d_ = ce.bloom_ce_bwd_cuda(gy, zs, h, lse, lo)
        torch.cuda.synchronize()
        pl, ps = ce.bloom_ce_shard_plain(zs, h, lo)
        pd = ce.bloom_ce_bwd_plain(gy, zs, h, lse, lo)
        torch.testing.assert_close(l_, pl, rtol=1e-6, atol=0)
        torch.testing.assert_close(s_, ps, rtol=1e-6, atol=0)
        torch.testing.assert_close(d_, pd, rtol=0, atol=1e-7)
        err_f = max(err_f, _max_abs_err(l_, pl), _max_abs_err(s_, ps))
        err_b = max(err_b, _max_abs_err(d_, pd))
    print("train-parallel: ranged kernels: bloom_embed.hash.range (f32, "
          "bf16; T = 1, 8, 260; D = 1024, 1000) and the CSR binning and "
          "both embed backwards (T = 520) at lo = 0 over every row "
          "bit-identical to the unranged kernels, and at the half and "
          "quarter ranges to their plain versions (the backwards to the "
          "whole table's rows); bloom_ce's ranged forward and backward at "
          f"lo = 0 bit-identical to the unranged ones, every range within "
          f"1e-6 of the plain versions (max abs err fwd {err_f}, bwd "
          f"{err_b})", flush=True)

    rows_out = {}
    half = m // 2
    table = base.to(torch.bfloat16).to(dev)
    tok = torch.randint(0, spec.d, (520,), generator=gen).to(dev)
    idx_c = spec.indices_for(tok).contiguous()
    shard = table[half:].contiguous()
    rel = idx_c.long() - half
    inside = (rel >= 0) & (rel < half)
    relc = rel.clamp(0, half - 1)
    times = _times_kernels(common, {
        "unranged": lambda: be.bloom_embed_tokens_cuda(table, tok, spec),
        "full": lambda: be.bloom_embed_tokens_cuda(table, tok, spec, False,
                                                   0),
        "kernel": lambda: be.bloom_embed_tokens_cuda(shard, tok, spec,
                                                     False, half)}, {
        "plain": lambda: be.bloom_embed_tokens_plain(
            shard, None, tok, spec, torch.bfloat16, half),
        "library": lambda: torch.nn.functional.embedding_bag(
            relc, shard, mode="sum",
            per_sample_weights=inside.to(torch.bfloat16))})
    n_rows = int(torch.unique(rel[inside]).numel())
    nbytes = be.min_bytes(n_rows, 520, k, D, 2, token_itemsize=8)
    bound_ms, by = _bound(nbytes, 520 * k * D)
    print(f"train-parallel: bloom_embed.hash.range bf16 T=520 D={D} k={k}: "
          f"the half range (rows [{half}, {m})) and the full range (lo = "
          f"0) beside the unranged kernel, device ms (graph) / back-to-back "
          f"ms (events): {_times_line(times)}, bound {bound_ms * 1e3:.3f} us "
          f"({by}, {nbytes} bytes) at the half range", flush=True)
    name = be.token_variant_name(spec) + be.RANGE
    rows_out[name] = {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bloom_embed.cu",
        "replaces": "src/repro/kernels/bloom_embed.py:294",
        "launches": 0, "max_abs_err": 0.0, "ms": times["kernel"][0],
        "plain_ms": times["plain"][0], "bound_ms": bound_ms,
        "bound_by": by, "library_ms": times["library"][0]}

    T = 520
    idx_b = torch.randint(0, m, (T, k), generator=gen,
                          dtype=torch.int32).to(dev)
    times = _times_kernels(common, {
        "unranged": lambda: csr.bin_csr_cuda(idx_b, m),
        "full": lambda: csr.bin_csr_cuda(idx_b, m, 0),
        "kernel": lambda: csr.bin_csr_cuda(idx_b, half, half)}, {
        "plain": lambda: csr.bin_csr_plain(idx_b, half, half)})
    g_b = torch.randn(T, D, generator=gen).to(torch.bfloat16).to(dev)
    dense = _times_kernels(common, {
        "unranged": lambda: be.bloom_embed_bwd_cuda(g_b, idx_b, m),
        "full": lambda: be.bloom_embed_bwd_cuda(g_b, idx_b, m, 0),
        "kernel": lambda: be.bloom_embed_bwd_cuda(g_b, idx_b, half, half)},
        {"plain": lambda: be.bloom_embed_bwd_plain(g_b, idx_b, half, half)})
    print(f"train-parallel: bloom_embed_bwd (dense, off the main path) bf16 "
          f"T={T} k={k} D={D}: the half range and the full range beside the "
          f"unranged kernel: {_times_line(dense)}", flush=True)
    nbytes = csr.bin_min_bytes(T * k, half)
    bound_ms, by = _bound_int(nbytes, T * k + half)
    print(f"train-parallel: bloom_csr.bin.range T={T} k={k}: the half "
          f"range (m = {half}, lo = {half}) and the full range beside the "
          f"unranged binning (m = {m}): {_times_line(times)}, bound "
          f"{bound_ms * 1e3:.3f} us ({by}, {nbytes} bytes) at the half "
          "range", flush=True)
    rows_out[csr.BIN_RANGE] = {
        "name": csr.BIN_RANGE, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bloom_csr.cu",
        "replaces": "src/repro/kernels/bloom_csr.py:110",
        "launches": 0, "max_abs_err": 0.0, "ms": times["kernel"][0],
        "plain_ms": times["plain"][0], "bound_ms": bound_ms,
        "bound_by": by, "library_ms": None}

    T = 512
    zh = z[:, half:].contiguous()
    col = (h.long() - half).clamp(0, half - 1)
    ins = (h.long() >= half)
    neg = torch.where(ins, -1.0 / k, 0.0)
    fwd = {
        "unranged": lambda: ce.bloom_ce_cuda(z, h),
        "full": lambda: ce.bloom_ce_shard_cuda(z, h, 0),
        "kernel": lambda: ce.bloom_ce_shard_cuda(zh, h, half),
        "plain": lambda: ce.bloom_ce_shard_plain(zh, h, half),
        "library": lambda: (torch.logsumexp(zh, -1),
                            (zh.gather(1, col) * ins).sum(-1))}
    bwd = {
        "unranged": lambda: ce.bloom_ce_bwd_cuda(gy, z, h, lse),
        "full": lambda: ce.bloom_ce_bwd_cuda(gy, z, h, lse, 0),
        "kernel": lambda: ce.bloom_ce_bwd_cuda(gy, zh, h, lse, half),
        "plain": lambda: ce.bloom_ce_bwd_plain(gy, zh, h, lse, half),
        "library": lambda: torch.exp(zh - lse[:, None]).scatter_add_(
            1, col, neg) * gy[:, None]}
    for label, name, fns, nbytes, ops, err, line in (
            ("forward", ce.FWD_RANGE, fwd,
             T * half * 4 + T * k * 4 + 2 * T * 4, 4 * T * half, err_f, 145),
            ("backward", ce.BWD_RANGE, bwd,
             ce.min_bytes(T, half, k, backward=True),
             5 * T * half + T * half * k, err_b, 87)):
        # L2-cold as well: the half range's logits (31 MB) stay in the
        # 50 MB L2 between graph replays; the bound is HBM bytes
        times, cold = _times(common, fns), _cold_times(common, fns)
        bound_ms, by = _bound(nbytes, ops)
        print(f"train-parallel: bloom_ce {label} ranged T={T} k={k}: the "
              f"half range (m = {half}, lo = {half}) and the full range "
              f"beside the unranged kernel (m = {m}), device ms (graph) / "
              f"back-to-back ms (events): {_times_line(times)}; L2-cold "
              f"device ms: {_cold_line(cold)}; bound "
              f"{bound_ms * 1e3:.3f} us ({by}, {nbytes} bytes) at the half "
              f"range, share of bound L2-cold "
              f"{bound_ms / cold['kernel']:.3f} (graph "
              f"{bound_ms / times['kernel'][0]:.3f}); {_card()}",
              flush=True)
        rows_out[name] = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/bloom_ce.cu",
            "replaces": f"src/repro/kernels/bloom_ce.py:{line}",
            "launches": 0, "max_abs_err": err, "ms": cold["kernel"],
            "plain_ms": cold["plain"], "bound_ms": bound_ms,
            "bound_by": by, "library_ms": cold["library"]}
    return rows_out


def phase_train_parallel(torch, be, ce, csr, common, transport="gloo"):
    """Phase 17b (the module's docstring), the ranks exchanging over
    ``transport`` (gloo: four ranks on one card; nccl: a card each).
    Returns (the ranged kernels' rows, each with the ranks' launches, and
    the ranks' launches of the other kernels)."""
    import dataclasses
    import numpy as np
    from repro_torch import configs
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import train
    rows = _ranged_kernels(torch, be, ce, csr, common)
    tc = TrainConfig(optimizer="adamw", learning_rate=3e-3,
                     grad_clip_norm=1.0, warmup_steps=0)
    # qwen1.5-0.5b at 8 of its 24 layers: the script's time limit (the
    # full depth's run is recorded in PERF.md section 6)
    q32 = configs.get_config("qwen1.5-0.5b", dtype="float32", num_layers=8)
    q16 = configs.get_config("qwen1.5-0.5b", num_layers=8)
    qb = _parallel_batches(q32, 8, 64, 3, seed=5)
    # olmoe at 2 of its 16 layers: 0.88B params (2 x 420M: attention 16.8M
    # and 64 experts x 6.3M a layer; embed and head 20.4M each); the
    # single-rank f32 master + grads + adam state is 16 B/param = 14.1 GB;
    # an EP rank holds 16 of the 64 experts, a quarter of the heads and of
    # the vocab: 0.22B params, 3.5 GB, plus the broadcast f32 copy (3.5
    # GB) while it takes its shards
    o32 = dataclasses.replace(configs.get_config(
        "olmoe-1b-7b", dtype="float32", moe_impl="ep"), num_layers=2)
    ob = _parallel_batches(o32, 8, 64, 2, seed=6)
    prefill = ob[0]["tokens"][:4, :64]
    print(f"train-parallel: olmoe-1b-7b at {o32.num_layers} of 16 layers: "
          f"{o32.param_count():,} params, f32 master + grads + Adam at 16 "
          f"B/param = {16 * o32.param_count() / 1e9:.1f} GB on one rank; "
          "an EP rank of 1x4 holds a quarter of the experts, heads and "
          "vocab rows (and the broadcast f32 copy while it shards)",
          flush=True)
    t0 = time.perf_counter()
    ref = {"q32": _single_rank(torch, q32, tc, qb, 0),
           "q16": dict(_single_rank(torch, q16, tc, qb, 0), dtype="bf16"),
           "o32": _single_rank(torch, o32, tc, ob, 0, prefill)}
    ref_s = time.perf_counter() - t0
    jobs = [{"shape": (2, 2), "cfg": c, "tc": tc, "seed": 0, "batches": qb,
             "prefill": None} for c in (q32, q16)]
    jobs.append({"shape": (1, 4), "cfg": o32, "tc": tc, "seed": 0,
                 "batches": ob, "prefill": prefill})
    t0 = time.perf_counter()
    out = train.spawn(_rank_parallel, (2, 2), transport, "cuda", (jobs,),
                      timeout=600)
    dense, ep = [r[:2] for r in out], [r[2:] for r in out]
    print(f"train-parallel: single-rank runs {ref_s:.3f} s; the four "
          f"ranks over {transport} {time.perf_counter() - t0:.3f} s "
          "(start, and per job: draw, broadcast, shard, steps, checks)",
          flush=True)

    counts, errs = {}, {}
    for label, results, wants in ((f"qwen1.5-0.5b {q32.num_layers}L 2x2",
                                   dense,
                                   [ref["q32"], ref["q16"]]),
                                  ("olmoe-1b-7b 1x4 ep", ep, [ref["o32"]])):
        for rank, per_job in enumerate(results):
            for job, (r, want) in enumerate(zip(per_job, wants)):
                for n, c in r["counts"].items():
                    counts[n] = counts.get(n, 0) + c
                for n, e in r["twins"].items():
                    errs[n] = max(errs.get(n, 0.0), e)
                dtype = want.get("dtype", "f32")
                print(f"train-parallel: {label} {dtype} rank {rank}: losses "
                      f"{r['losses']} (single rank {want['losses']}), step "
                      f"walls {[round(w * 1e3, 3) for w in r['walls']]} ms "
                      f"(single rank {want['step_s'] * 1e3:.3f} ms), "
                      f"collective time per step "
                      f"{[round(c * 1e3, 3) for c in r['coll']]} ms, set-up "
                      f"{r['setup_s']:.3f} s, peak {r['peak_gib']:.3f} GiB, "
                      f"branches {r['branches']}, launches {r['counts']}, "
                      f"twins {r['twins']}", flush=True)
    for r in dense:
        np.testing.assert_allclose(r[0]["losses"], ref["q32"]["losses"],
                                   rtol=1e-5)
    gap = max(abs(a - b) / abs(b) for r in dense for a, b in
              zip(r[1]["losses"], ref["q16"]["losses"]))
    print(f"train-parallel: qwen1.5-0.5b {q32.num_layers}L 2x2 f32 losses "
          f"equal the single "
          f"rank's within rtol 1e-5; bf16 relative loss gap {gap:.3e} "
          "(not held: bf16 partial sums round where one rank's do not)",
          flush=True)
    want = ref["o32"]
    scale = float(want["last_logits"].abs().max())
    for r in ep:
        r = r[0]
        err = float(np.abs(r["last_logits"] - want["last_logits"].numpy())
                    .max())
        _check(err <= 1e-4 * max(scale, 1.0),
               f"train-parallel: EP prefill logits off by {err} (max "
               f"|logit| {scale})")
        _check(abs(r["aux"] - want["aux"]) <= 1e-4 * abs(want["aux"]),
               f"train-parallel: EP aux {r['aux']} vs {want['aux']}")
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=1e-5)
    print(f"train-parallel: olmoe-1b-7b 2 layers 1x4 ep: prefill last "
          f"logits within 1e-4 x max |logit| ({scale:.3f}), aux within "
          f"rtol 1e-4 ({want['aux']}), losses within rtol 1e-5 of the "
          "single-rank dense-MoE path", flush=True)
    for name, row in rows.items():
        row["launches"] = counts.pop(name, 0)
    rows[ce.FWD_RANGE]["max_abs_err"] = max(
        rows[ce.FWD_RANGE]["max_abs_err"], errs.get("ce_fwd", 0.0))
    rows[ce.BWD_RANGE]["max_abs_err"] = max(
        rows[ce.BWD_RANGE]["max_abs_err"], errs.get("ce_bwd", 0.0))
    return list(rows.values()), counts


def _rank_serve(mesh, jobs):
    """One rank of phases serve-parallel and serve-parallel-families:
    each job on a (data, model) mesh of its shape over this world, from
    weights rank 0 draws on the card (seed 0), inside ``held_to_plain``,
    its launches reset just before and read just after.  A serving job
    ({shape, cfg, prompts, embeds or None, gen, topk, cache_dtype}) runs
    ``serve.generate`` under the mesh and returns its ids and each decode
    step's top-k ids and scores (batch rows gathered); a training job
    ({shape, cfg, tc, batches}) runs ``make_train_step`` and returns its
    losses.  Each returns its step walls and collective seconds, the
    transport's branches, its launches and the held checks' errors."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import common
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import serve, sharding, train
    from repro_torch.launch import steps as steps_lib
    tr, dev = mesh.transport, mesh.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    results = []
    for job in jobs:
        cfg = job["cfg"]
        training = "batches" in job
        dist_ctx = sharding.DistContext(
            mesh if job["shape"] == mesh.sizes else mesh_lib.world_mesh(
                job["shape"], mesh.axis_names, dev, tr))
        t0 = time.perf_counter()
        full = (dict(_draw(torch, cfg, 0, dev).named_parameters())
                if mesh.rank == 0 else None)
        if training:
            step, optimizer = steps_lib.make_train_step(cfg, job["tc"],
                                                        dist_ctx)
            model, opt_state = train.parallel_state(
                cfg, optimizer, 0, None, dist_ctx, full)[:2]
        else:
            model = train.parallel_state(cfg, None, 0, None, dist_ctx,
                                         full)[0]
            steps_lib.cast_params_for_compute(model, cfg)
            model.eval().requires_grad_(False)
        del full
        sync()
        r = {"setup_s": time.perf_counter() - t0, "walls": [], "coll": [],
             "steps": [], "losses": []}
        clock = {}

        def on_step(t, out):
            sync()
            r["walls"].append(time.perf_counter() - clock["t"])
            r["coll"].append(tr.seconds - clock["c"])
            r["steps"].append({k: serve.batch_whole(
                out[k], dist_ctx, len(job["prompts"])).cpu().numpy()
                for k in ("topk_ids", "topk_scores")})
            clock.update(t=time.perf_counter(), c=tr.seconds)

        errs = {}
        sync()
        common.reset_launches()
        tr.branches.clear()
        tr.seconds, tr.timed = 0.0, True
        clock.update(t=time.perf_counter(), c=0.0)
        with held_to_plain(torch, common, f"{job['phase']} rank "
                           f"{mesh.rank}", errs):
            if training:
                for b in job["batches"]:
                    batch = {"tokens": torch.as_tensor(b["tokens"]).to(dev)}
                    opt_state, m = step(model, opt_state, batch)
                    r["losses"].append(float(m["loss"]))
                    sync()
                    r["walls"].append(time.perf_counter() - clock["t"])
                    r["coll"].append(tr.seconds - clock["c"])
                    clock.update(t=time.perf_counter(), c=tr.seconds)
            else:
                embeds = job.get("embeds")
                if embeds is not None:
                    embeds = torch.as_tensor(embeds).to(
                        dev, getattr(torch, cfg.dtype))
                r["ids"] = serve.generate(
                    cfg, model, job["prompts"], job["gen"], job["topk"],
                    embeds, dist=dist_ctx, on_step=on_step,
                    cache_dtype=job["cache_dtype"])[0]
        tr.timed = False
        r["counts"], r["errs"] = dict(common.LAUNCHES), errs
        r["branches"] = {f"{op} {b}": n for (op, b), n in
                         sorted(tr.branches.items())}
        r["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        del model
        if training:
            del opt_state
        torch.cuda.empty_cache()
        results.append(r)
    return results


def _one_rank_generation(torch, cfg, job, device):
    """The same generation in this process on ``device``, from the same
    draw, with no mesh: its ids, each decode step's top-k ids and scores,
    one id wider than the job's top k (the next-ranked id shows a tie at
    the last place)."""
    from repro_torch.launch import serve
    from repro_torch.launch import steps as steps_lib
    model = _draw(torch, cfg, 0, device)
    steps_lib.cast_params_for_compute(model, cfg)
    model.eval().requires_grad_(False)
    steps, walls = [], []
    clock = {"t": time.perf_counter()}

    def on_step(t, out):
        if device.type == "cuda":
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - clock["t"])
        steps.append({k: out[k].cpu().numpy() for k in
                      ("topk_ids", "topk_scores")})
        clock["t"] = time.perf_counter()

    embeds = job.get("embeds")
    if embeds is not None:
        embeds = torch.as_tensor(embeds).to(device, getattr(torch, cfg.dtype))
    t0 = time.perf_counter()
    ids = serve.generate(cfg, model, job["prompts"], job["gen"],
                         job["topk"] + 1, embeds, on_step=on_step,
                         cache_dtype=job["cache_dtype"])[0]
    wall = time.perf_counter() - t0
    del model
    torch.cuda.empty_cache()
    return {"ids": ids, "steps": steps, "wall": wall, "walls": walls}


def _held_generation(label, got, want, tol):
    """``got``'s tokens and top-k ids equal ``want``'s (one id wider),
    scores within ``tol`` (phase serve-parallel's rule on ties); returns
    the largest score difference."""
    import numpy as np
    ids, B = want["ids"], want["ids"].shape[0]
    live, err = np.ones(B, bool), 0.0
    _check(np.array_equal(got["ids"][:, 0], ids[:, 0]),
           f"{label}: first tokens {got['ids'][:, 0]} != {ids[:, 0]}")
    for t, (g, w) in enumerate(zip(got["steps"], want["steps"])):
        k = g["topk_ids"].shape[1]
        d = np.abs(g["topk_scores"][live] - w["topk_scores"][live, :k])
        err = max(err, float(d.max()) if d.size else 0.0)
        _check(err <= tol, f"{label} step {t}: scores off by {err}")
        for b, j in zip(*np.nonzero((g["topk_ids"] != w["topk_ids"][:, :k])
                                    & live[:, None])):
            s = w["topk_scores"][b]
            near = min(abs(s[j] - s[i]) for i in (j - 1, j + 1)
                       if 0 <= i < len(s))
            _check(near <= tol, f"{label} step {t} row {b}: top-k id "
                   f"{j} differs off a tie")
        for b in np.flatnonzero(live & (got["ids"][:, t + 1]
                                        != ids[:, t + 1])):
            s = w["topk_scores"][b]
            _check(s[0] - s[1] <= tol, f"{label} token {t + 1} row {b} "
                   "differs off a tie")
            live[b] = False
    _check(live.sum() >= max(B - 1, 1), f"{label}: {B - live.sum()} rows "
           "diverged")
    return err


def phase_serve_parallel(torch, common):
    """Phase 17c (the module's docstring).  Returns (the ranks' launches
    by kernel, the largest held error by kernel)."""
    import dataclasses
    import numpy as np
    from repro_torch import configs
    from repro_torch.launch import train
    # qwen1.5-0.5b at 8 of its 24 layers: the script's time limit (the
    # full depth's run is recorded in PERF.md section 6)
    q32 = configs.get_config("qwen1.5-0.5b", dtype="float32", num_layers=8)
    o32 = dataclasses.replace(configs.get_config(
        "olmoe-1b-7b", dtype="float32", moe_impl="ep"), num_layers=2)
    rng = np.random.default_rng(27)
    B, S, gen, topk = 4, 32, 12, 8

    def job(shape, cfg, cache_dtype):
        return {"shape": shape, "cfg": cfg, "gen": gen, "topk": topk,
                "cache_dtype": cache_dtype, "phase": "serve-parallel",
                "prompts": rng.integers(0, cfg.vocab, (B, S)).astype(
                    np.int32)}

    jobs = [job((1, 4), q32, torch.float32), job((2, 2), q32, torch.float32),
            job((1, 4), o32, torch.float32)]
    jobs[1]["prompts"] = jobs[0]["prompts"]
    t0 = time.perf_counter()
    want = [_one_rank_generation(torch, j["cfg"], j, torch.device("cuda"))
            for j in jobs]
    ref_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = train.spawn(_rank_serve, (2, 2), "gloo", "cuda", (jobs,),
                      timeout=600)
    print(f"serve-parallel: one-rank runs {ref_s:.3f} s; the four ranks "
          f"over gloo {time.perf_counter() - t0:.3f} s (start, and per "
          "job: draw, broadcast, shard, generate, checks); B = "
          f"{B}, prompt {S}, {gen} tokens, top-{topk}", flush=True)
    counts, errs = {}, {}
    for i, (j, w) in enumerate(zip(jobs, want)):
        cfg = j["cfg"]
        label = (f"serve-parallel: {cfg.name} {cfg.num_layers}L "
                 f"{cfg.dtype} {'x'.join(map(str, j['shape']))}"
                 + (" ep" if cfg.moe is not None else ""))
        for rank, per_job in enumerate(out):
            r = per_job[i]
            for n, c in r["counts"].items():
                counts[n] = counts.get(n, 0) + c
            for n, e in r["errs"].items():
                errs[n] = max(errs.get(n, 0.0), e)
            walls, coll = r["walls"], r["coll"]
            err = _held_generation(f"{label} rank {rank}", r, w, 1e-4)
            print(f"{label} rank {rank}: tokens and top-k ids held, scores "
                  f"within {err:.3e}; step walls "
                  f"{[round(x * 1e3, 3) for x in walls]} ms (the first "
                  f"from the generation's start: prefill and step 1; one "
                  f"rank {w['wall'] * 1e3:.3f} ms in all), collective "
                  f"seconds {[round(x * 1e3, 3) for x in coll]} ms, busy "
                  f"share {[round(1 - c / x, 3) for c, x in zip(coll, walls)]}"
                  f", set-up {r['setup_s']:.3f} s, branches "
                  f"{r['branches']}, launches {r['counts']}, held "
                  f"{r['errs']}", flush=True)
            if rank == 0:
                print(f"{label}: ids (first seq) {r['ids'][0].tolist()} "
                      f"(one rank {w['ids'][0].tolist()}); one rank's step "
                      f"walls {[round(x * 1e3, 3) for x in w['walls']]} "
                      f"ms; {_card()}", flush=True)
    return counts, errs


def _cache_split_line(torch, cfg, job):
    """How ``job``'s decode caches split on its mesh: the first attention
    layer's self (and cross) cache spec, its positions and a rank's (a
    Mamba cache's heads)."""
    from repro_torch.launch import serve, sharding
    from repro_torch.launch.mesh import counting_mesh
    B, S = job["prompts"].shape
    emb = job.get("embeds")
    emb = None if emb is None else torch.empty(emb.shape, device="meta")
    whole = serve.decode_caches(cfg, B, S, job["gen"], emb, "meta")[0]
    dist_ctx = sharding.DistContext(counting_mesh(job["shape"]))
    specs = sharding.cache_pspecs(cfg, whole, dist_ctx, B)
    i = next((i for i, layer in enumerate(whole) if "k" in layer), 0)
    out = []
    for key, what in (("k", "positions"), ("cross_k", "positions"),
                      ("ssm", "heads")):
        if key in whole[i]:
            spec = specs[i][key]
            n = sharding._shard_index(spec[1], dist_ctx.mesh)[0]
            T = whole[i][key].shape[1]
            out.append(f"{key} {spec} ({T} {what}, {T // n} a rank)")
    return ", ".join(out)


def phase_serve_parallel_families(torch, common):
    """Phase 17e (the module's docstring).  Returns (the ranks' launches
    by kernel, the largest held error by kernel)."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import train
    phase = "serve-parallel-families"
    rng = np.random.default_rng(28)
    S, gen, topk = 32, 8, 8
    # mamba2 at 24 of its 48 layers: the script's time limit (the full
    # depth's run is recorded in PERF.md section 6)
    m32 = configs.get_config("mamba2-1.3b", dtype="float32", num_layers=24)
    w32 = configs.get_config("whisper-small", dtype="float32")
    # pixtral at 2 of its 40 layers: the draw and the broadcast of one
    # rank's f32 copy stay within the script's time limit
    p32 = configs.get_config("pixtral-12b", dtype="float32", num_layers=2)

    def serve_job(shape, cfg, B, frames):
        return {"phase": phase, "shape": shape, "cfg": cfg, "gen": gen,
                "topk": topk, "cache_dtype": torch.float32,
                "prompts": rng.integers(0, cfg.vocab, (B, S)).astype(
                    np.int32),
                "embeds": None if not frames else rng.standard_normal(
                    (B, frames, cfg.d_model)).astype(np.float32)}

    tc = TrainConfig(optimizer="adamw", learning_rate=3e-3,
                     grad_clip_norm=1.0, warmup_steps=0)
    train_job = {"phase": phase, "shape": (1, 4), "cfg": m32, "tc": tc,
                 "batches": _parallel_batches(m32, 4, 64, 2, seed=7)}
    four = [serve_job((1, 4), m32, 4, 0), train_job,
            serve_job((2, 2), p32, 1, 8)]
    eight = [serve_job((1, 8), w32, 4, 64)]
    for j in four[::2] + eight:
        print(f"{phase}: {j['cfg'].name} {j['cfg'].num_layers}L on "
              f"{'x'.join(map(str, j['shape']))}, B = "
              f"{j['prompts'].shape[0]}: caches "
              f"{_cache_split_line(torch, j['cfg'], j)}", flush=True)
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    want = {id(j): _one_rank_generation(torch, j["cfg"], j, dev)
            for j in four[::2] + eight}
    want[id(train_job)] = _single_rank(torch, m32, tc, train_job["batches"],
                                       0)
    _check(all(math.isfinite(x) for x in want[id(train_job)]["losses"]),
           f"{phase}: one rank's mamba2 losses "
           f"{want[id(train_job)]['losses']}")
    ref_s = time.perf_counter() - t0
    out = {}
    for jobs, shape in ((four, (2, 2)), (eight, (1, 8))):
        t0 = time.perf_counter()
        res = train.spawn(_rank_serve, shape, "gloo", "cuda", (jobs,),
                          timeout=600)
        print(f"{phase}: the {len(res)} ranks over gloo "
              f"{time.perf_counter() - t0:.3f} s (start, and per job: draw, "
              "broadcast, shard, generate or train, checks)", flush=True)
        for i, j in enumerate(jobs):
            out[id(j)] = [per_job[i] for per_job in res]
    print(f"{phase}: one-rank runs {ref_s:.3f} s; prompt {S}, {gen} "
          f"tokens, top-{topk}", flush=True)
    counts, errs = {}, {}
    for j in four + eight:
        cfg, w = j["cfg"], want[id(j)]
        training = "batches" in j
        label = (f"{phase}: {cfg.name} {cfg.num_layers}L {cfg.dtype} "
                 f"{'x'.join(map(str, j['shape']))}"
                 + (" train" if training else ""))
        for rank, r in enumerate(out[id(j)]):
            for n, c in r["counts"].items():
                counts[n] = counts.get(n, 0) + c
            for n, e in r["errs"].items():
                errs[n] = max(errs.get(n, 0.0), e)
            if training:
                np.testing.assert_allclose(r["losses"], w["losses"],
                                           rtol=1e-5, err_msg=label)
                held = (f"losses {r['losses']} equal one rank's "
                        f"{w['losses']} within rtol 1e-5 (one rank's step "
                        f"{w['step_s'] * 1e3:.3f} ms)")
            else:
                err = _held_generation(f"{label} rank {rank}", r, w, 1e-4)
                held = (f"tokens and top-k ids held, scores within "
                        f"{err:.3e}")
            walls, coll = r["walls"], r["coll"]
            print(f"{label} rank {rank}: {held}; step walls "
                  f"{[round(x * 1e3, 3) for x in walls]} ms, collective "
                  f"seconds {[round(x * 1e3, 3) for x in coll]} ms, busy "
                  f"share {[round(1 - c / x, 3) for c, x in zip(coll, walls)]}"
                  f", set-up {r['setup_s']:.3f} s, peak "
                  f"{r['peak_gib']:.3f} GiB, branches {r['branches']}, "
                  f"launches {r['counts']}, held {r['errs']}", flush=True)
            if rank == 0 and not training:
                print(f"{label}: ids (first seq) {r['ids'][0].tolist()} "
                      f"(one rank {w['ids'][0].tolist()}); one rank's step "
                      f"walls {[round(x * 1e3, 3) for x in w['walls']]} "
                      f"ms; {_card()}", flush=True)
    return counts, errs


# --------------------------------------------------------------------------
# phase 17a: train-long
# --------------------------------------------------------------------------

# (a)'s runs: the chunked paths against the naive oracle without remat
LONG_VARIANTS = {"chunked, remat full": {},
                 "chunked, remat none": {"remat": "none"},
                 "chunked, remat dots": {"remat": "dots"},
                 "causal_skip, remat full": {"causal_skip": True},
                 "naive, remat none": {"attn_impl": "naive", "remat": "none"}}


def _rel_err(torch, got, want) -> float:
    """max |got - want| over max |want| (the tensor's own scale)."""
    scale = float(want.abs().max())
    return float((got - want).abs().max()) / scale if scale else 0.0


def _long_hold(torch, common, errs):
    """(a): qwen1.5-0.5b at full width and 4 of 24 layers, f32, batch 2 x
    2,048 tokens (two 1,024-key chunks; causal_skip with 1,024-row q
    chunks): one step's loss and gradients through each of
    ``LONG_VARIANTS``, every launch held against its plain version.  The
    chunked paths within 1e-5 relative of the naive oracle; remat full and
    dots within 1e-6 of none (bit for bit expected).  Returns the launches
    by kernel."""
    from repro_torch import configs
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import transformer as tf
    base = configs.get_config("qwen1.5-0.5b", num_layers=4, dtype="float32",
                              attn_chunk_q=1024, attn_chunk_k=1024)
    dev = torch.device("cuda")
    model = tf.TransformerLM(base, torch.Generator().manual_seed(0)).to(dev)
    tokens = torch.randint(0, base.vocab, (2, 2048), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1)).to(dev)
    runs = {}
    common.reset_launches()
    with held_to_plain(torch, common, "train-long hold", errs):
        for label, over in LONG_VARIANTS.items():
            model.cfg = cfg = dataclasses.replace(base, **over)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss, _, grads = steps_lib.value_and_grad(model, cfg,
                                                      {"tokens": tokens})
            torch.cuda.synchronize()
            runs[label] = (loss, grads, time.perf_counter() - t0,
                           torch.cuda.max_memory_allocated())
    counts = dict(common.LAUNCHES)
    model.cfg = base
    oracle, none = runs["naive, remat none"], runs["chunked, remat none"]
    for label, (loss, grads, wall, peak) in runs.items():
        to_oracle = max([_rel_err(torch, loss, oracle[0])]
                        + [_rel_err(torch, g, oracle[1][n])
                           for n, g in grads.items()])
        _check(to_oracle <= 1e-5, f"train-long {label}: {to_oracle} "
               "relative to the naive oracle")
        line = (f"train-long hold: {label}: loss {float(loss):.9f}, loss "
                f"and {len(grads)} gradients within {to_oracle:.3e} "
                f"relative of naive/none")
        if "remat" in label and "chunked" in label and label != \
                "chunked, remat none":
            to_none = max([_rel_err(torch, loss, none[0])]
                          + [_rel_err(torch, g, none[1][n])
                             for n, g in grads.items()])
            bits = torch.equal(loss, none[0]) and all(
                torch.equal(g, none[1][n]) for n, g in grads.items())
            _check(to_none <= 1e-6, f"train-long {label}: {to_none} "
                   "relative to remat none")
            line += (f", of chunked/none within {to_none:.3e} (bit for "
                     f"bit: {bits})")
        print(f"{line}; wall {wall * 1e3:.3f} ms, peak memory "
              f"{peak / 2 ** 30:.3f} GiB", flush=True)
    print(f"train-long hold: {base.name} 4 of 24 layers, d_model "
          f"{base.d_model}, f32, batch 2 x 2048 tokens, kv chunks 1024, "
          f"q chunks 1024 (causal_skip); launches {counts}; {_card()}",
          flush=True)
    del model, runs, oracle, none
    torch.cuda.empty_cache()
    return counts


def _train_counts(torch, cfg, batch: int, tokens: int):
    """The dry run's count of one train step of ``cfg`` at batch x tokens
    on mesh 1x1 (``roofline_share``'s), for the defaults and for
    attn_impl naive, remat none: {label: count}, and the count's
    ``shape``."""
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.launch import dryrun, sharding
    from repro_torch.launch.mesh import counting_mesh
    shape = ShapeConfig("train_long", tokens, batch, "train")
    tc = TrainConfig(optimizer="adamw", learning_rate=3e-3,
                     grad_clip_norm=1.0, steps=8, warmup_steps=10)
    dist = sharding.DistContext(counting_mesh((1, 1)))
    out = {"shape": shape}
    for label, over in (("defaults", {}),
                        ("naive/none", {"attn_impl": "naive",
                                        "remat": "none"})):
        c = dataclasses.replace(cfg, **over)
        out[label] = dryrun.count_step(*dryrun.step_variant(c, shape, dist,
                                                            tc),
                                       dist.mesh.transport)
    return out


def _long_train(torch, common, names):
    """(b): qwen1.5-0.5b at full width and depth with the configs'
    defaults (bf16 compute, chunked attention, remat full), 8 steps at
    batch 4 x 4,096 tokens through launch/train.run, counts reset just
    before and read just after: each Bloom kernel launched once a step,
    losses finite and falling; then the dry run's count of the same step
    (defaults and naive/none).  Returns the launches by kernel."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.launch import train
    cfg = configs.get_config("qwen1.5-0.5b")
    n_steps, batch, tokens = 8, 4, 4096
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    common.reset_launches()
    t0 = time.perf_counter()
    # windows of seq + 1 tokens: the model sees 4,096 a row
    _, hist = train.run("qwen1.5-0.5b", steps=n_steps, batch=batch,
                        seq=tokens - 1, full=True, log_every=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(common.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for name in names:
        _check(counts.get(name, 0) == n_steps,
               f"train-long: {counts.get(name, 0)} {name} launches for "
               f"{n_steps} steps")
    losses = [h["loss"] for h in hist]
    _check(len(losses) == n_steps and all(map(math.isfinite, losses)),
           f"train-long: losses {losses}")
    _check(losses[-1] < losses[0], f"train-long: loss did not fall {losses}")
    step_ms = [h["step_s"] * 1e3 for h in hist[1:]]
    med = float(np.median(step_ms))
    print(f"train-long: {cfg.name} {cfg.num_layers}L d_model {cfg.d_model} "
          f"{cfg.dtype}, remat {cfg.remat}, attention {cfg.attn_impl} (kv "
          f"chunks {cfg.attn_chunk_k}), batch {batch} x {tokens} tokens, "
          f"{n_steps} steps in {wall:.3f} s with set-up: losses {losses}; "
          f"median step wall {med:.6f} ms (steps 2-{n_steps}: "
          f"{[round(x, 3) for x in step_ms]}), "
          f"{batch * tokens / med * 1e3:.1f} tokens/s, max_memory_allocated "
          f"{peak / 2 ** 30:.3f} GiB, launches {counts}; {_card()}",
          flush=True)
    roofline = _rates()
    counted = _train_counts(torch, cfg, batch, tokens)
    mf = roofline.model_flops(cfg, counted.pop("shape"))
    print(f"train-long roofline: model FLOPs {mf:.6e} over (median step "
          f"{med:.6f} ms x bf16 peak {roofline.PEAK_FLOPS:.4e}) = "
          f"{mf / (med / 1e3 * roofline.PEAK_FLOPS):.6f}", flush=True)
    for label, c in counted.items():
        terms = roofline.roofline_terms(c["flops_dev"], c["bytes_dev"], 0.0)
        mem = c["memory"]
        print(f"train-long count ({label}, meta, mesh 1x1): "
              f"{c['flops_dev']:.6e} FLOPs, {c['bytes_dev']:.6e} bytes, "
              f"bound {terms['step_time_s'] * 1e3:.6f} ms "
              f"({terms['dominant']}) = "
              f"{terms['step_time_s'] * 1e3 / med:.6f} of the measured "
              f"step; argument + temp "
              f"{(mem['argument_bytes'] + mem['temp_bytes']) / 2 ** 30:.3f} "
              f"GiB (temp {mem['temp_bytes'] / 2 ** 30:.3f}) beside "
              f"max_memory_allocated {peak / 2 ** 30:.3f} GiB; counted in "
              f"{c['compile_s']:.3f} s on the host", flush=True)
    return counts


def _long_shapes_held(torch, common, errs):
    """One step of a 4-layer cut of (b)'s model at (b)'s batch, every
    launch held against its plain version: the Bloom kernels at (b)'s
    shapes (they do not depend on the depth).  Returns the launches."""
    from repro_torch import configs
    from repro_torch.launch import steps as steps_lib
    cfg = configs.get_config("qwen1.5-0.5b", num_layers=4)
    dev = torch.device("cuda")
    model = steps_lib.init_fn_for(cfg)(0).to(dev)
    tokens = torch.randint(0, cfg.vocab, (4, 4096), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(2)).to(dev)
    common.reset_launches()
    with held_to_plain(torch, common, "train-long shapes", errs):
        loss = steps_lib.value_and_grad(model, cfg, {"tokens": tokens})[0]
    _check(math.isfinite(float(loss)), f"train-long shapes: loss {loss}")
    counts = dict(common.LAUNCHES)
    print(f"train-long shapes: one step of 4 layers at batch 4 x 4096, "
          f"bf16, every launch held against its plain version: {counts}; "
          f"held max abs errors {errs}", flush=True)
    del model
    torch.cuda.empty_cache()
    return counts


def _long_prefill(torch, common, errs):
    """(c): serve.generate of one 32,768-token prompt and 4 new tokens,
    qwen1.5-0.5b at full width and depth in f32 (f32 caches), once
    chunked (kv chunks 1,024) and once causal_skip (q chunks 2,048),
    every launch held against its plain version: tokens equal, top-k ids
    equal but at near ties and scores within 1e-4 (phase 17c's rule,
    ``_held_generation``).  The naive path is not run: one layer's scores
    would take 64 GiB.  Returns the launches by kernel."""
    import numpy as np
    from repro_torch import configs
    from repro_torch.launch import serve
    base = configs.get_config("qwen1.5-0.5b", dtype="float32")
    model = serve.build_model(base, 0, "cuda")
    prompt = np.random.default_rng(5).integers(
        0, base.vocab, (1, 32768)).astype(np.int32)
    topk, runs = 8, {}
    common.reset_launches()
    with held_to_plain(torch, common, "train-long prefill", errs):
        for label, over, k in (
                ("chunked", {}, topk),
                ("causal_skip", {"causal_skip": True, "attn_chunk_q": 2048},
                 topk + 1)):
            cfg = dataclasses.replace(base, **over)
            steps = []
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ids, t_pre, t_dec = serve.generate(
                cfg, model, prompt, 4, k, cache_dtype=torch.float32,
                on_step=lambda t, out: steps.append(
                    {n: out[n].cpu().numpy()
                     for n in ("topk_ids", "topk_scores")}))
            runs[label] = {"ids": ids, "steps": steps}
            print(f"train-long prefill: {label}: 32768 tokens, prefill "
                  f"{t_pre * 1e3:.3f} ms, 3 decode steps {t_dec * 1e3:.3f} "
                  f"ms, peak memory "
                  f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB, "
                  f"tokens {ids[0].tolist()}", flush=True)
    counts = dict(common.LAUNCHES)
    err = _held_generation("train-long prefill", runs["chunked"],
                           runs["causal_skip"], 1e-4)
    _check(np.array_equal(runs["chunked"]["ids"], runs["causal_skip"]["ids"]),
           "train-long prefill: chunked and causal_skip tokens differ")
    print(f"train-long prefill: chunked and causal_skip tokens equal, top-k "
          f"ids equal but at ties, scores within {err:.3e} (held 1e-4); "
          f"launches {counts}; {_card()}", flush=True)
    del model
    torch.cuda.empty_cache()
    return counts


def phase_train_long(torch, common, names):
    """Phase 17a (the module's docstring).  Returns (launches by kernel,
    the largest held error by kernel)."""
    errs, total, walls = {}, {}, {}
    for label, part in (
            ("hold", lambda: _long_hold(torch, common, errs)),
            ("train", lambda: _long_train(torch, common, names)),
            ("shapes", lambda: _long_shapes_held(torch, common, errs)),
            ("prefill", lambda: _long_prefill(torch, common, errs))):
        t0 = time.perf_counter()
        for n, c in part().items():
            total[n] = total.get(n, 0) + c
        walls[label] = time.perf_counter() - t0
    print("train-long walls: " + ", ".join(f"{n} {w:.3f} s"
                                          for n, w in walls.items()),
          flush=True)
    return total, errs


class _Background:
    """A command run beside the phases in its own process group, its
    output in ``log``; ``stop`` ends it and every process it started."""

    def __init__(self, args, log: Path):
        log.parent.mkdir(parents=True, exist_ok=True)
        self.log = log
        self._out = open(log, "w")
        self.proc = subprocess.Popen(
            args, stdout=self._out, stderr=subprocess.STDOUT,
            env={**os.environ, "PYTHONPATH": str(SRC)},
            cwd=str(SRC.parent), start_new_session=True)

    def wait(self, timeout: float) -> int:
        rc = self.proc.wait(timeout=timeout)
        self._out.close()
        return rc

    def stop(self) -> None:
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait()
        self._out.close()


def start_dryrun() -> _Background:
    """Phase 17d's subprocess: the dry run of the production grid."""
    build = SRC.parent / "build"
    return _Background([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--all", "--jobs", "6", "--out",
                        str(build / "dryrun_torch")],
                       build / "dryrun_torch.log")


# the train_4k cells whose rank must fit an 80 GB card with the configs'
# defaults (chunked attention, remat full); pixtral-12b and jamba are
# printed, not held
FIT_80GB = ("qwen1.5-0.5b", "qwen3-4b", "granite-8b", "phi3-mini-3.8b",
            "deepseek-moe-16b", "olmoe-1b-7b", "mamba2-1.3b",
            "whisper-small")


def phase_dryrun(dry: _Background) -> None:
    """Phase 17d: the dry run's 32 OK and no WAIT or FAIL lines; every
    train_4k cell's argument + temp bytes from its artifact, those of
    ``FIT_80GB`` under 80 GB."""
    t0 = time.perf_counter()
    rc = dry.wait(timeout=600)
    lines = dry.log.read_text().splitlines()
    ok = [ln for ln in lines if ln.startswith("OK ")]
    wait = [ln for ln in lines if ln.startswith("WAIT ")]
    fail = [ln for ln in lines if ln.startswith("FAIL")]
    for ln in ok:
        print(f"dryrun: {ln}", flush=True)
    print(f"dryrun: {lines[-1] if lines else '(no output)'} (exit {rc}, "
          f"waited {time.perf_counter() - t0:.3f} s after the build); "
          f"roofline at the H100's rates (launch/roofline.py), counted on "
          f"meta tensors", flush=True)
    _check(rc == 0 and len(ok) == 32 and not wait and not fail,
           f"dryrun: exit {rc}, {len(ok)} OK, {len(wait)} WAIT, "
           f"{len(fail)} FAIL; tail {lines[-5:]}")
    from repro_torch import configs
    over = []
    for arch in configs.ARCH_NAMES:
        art = json.loads((dry.log.parent / "dryrun_torch" /
                          f"{arch}__train_4k__singlepod.json").read_text())
        mem = art["full"]["memory"]
        held = mem["argument_bytes"] + mem["temp_bytes"]
        if arch in FIT_80GB and held >= 80e9:
            over.append(arch)
        print(f"dryrun: {arch} train_4k one rank of 16x16 "
              f"({art['execution']}): argument + temp "
              f"{held / 2 ** 30:.3f} GiB (argument "
              f"{mem['argument_bytes'] / 2 ** 30:.3f}, temp "
              f"{mem['temp_bytes'] / 2 ** 30:.3f}); "
              f"{'held under 80 GB' if arch in FIT_80GB else 'printed'}",
              flush=True)
    _check(not over, f"dryrun: train_4k over 80 GB a rank: {over}")


def parent_ce(torch, ce, common, old):
    """The parent's Bloom CE pair (library ``old``) beside this tree's at
    the main path's shapes (``sweep_ce.SHAPES``: qwen1.5-0.5b's m, whisper-
    small's, the half range of a 2-way split), T = 512, k = 4: the
    forward within rtol 1e-6 / atol 1e-5 of the parent's, dz equal to the
    parent's on the same lse (``torch.equal``), each entry timed in
    turns, warm and L2-cold."""
    from repro_torch.kernels import sweep_ce
    gen = torch.Generator().manual_seed(26)
    new = ce._library()
    for label, m, lo in sweep_ce.SHAPES:
        z, h, g = sweep_ce.inputs(m, lo, gen)
        got, want = ce.launch_fwd(new, z, h, lo), ce.launch_fwd(old, z, h, lo)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-5)
        lse = want[0] if lo is not None else want[1]
        dz = ce.launch_bwd(new, g, z, h, lse, lo)
        _check(torch.equal(dz, ce.launch_bwd(old, g, z, h, lse, lo)),
               f"parent bloom_ce {label}: dz differs from the parent's")
        for what, fns, nbytes in (
                ("forward", {"parent kernel": lambda: ce.launch_fwd(
                    old, z, h, lo), "kernel": lambda: ce.launch_fwd(
                        new, z, h, lo)}, ce.min_bytes(sweep_ce.T, m,
                                                      sweep_ce.K)),
                ("backward", {"parent kernel": lambda: ce.launch_bwd(
                    old, g, z, h, lse, lo), "kernel": lambda: ce.launch_bwd(
                        new, g, z, h, lse, lo)}, ce.min_bytes(
                            sweep_ce.T, m, sweep_ce.K, backward=True))):
            for f in fns.values():      # the clocks up before the turns
                common.graph_time_ms(f, 20, 5)
            times = _turns(torch, common, fns)
            bound_ms = _bound(nbytes, 0)[0]
            print(f"parent: bloom_ce {what} {label} T={sweep_ce.T} m={m} "
                  f"k={sweep_ce.K} lo={lo}, dz bit-identical and the "
                  f"forward within 1e-6 of the parent's; device ms (graph) "
                  f"/ back-to-back ms (events) / L2-cold device ms, in "
                  f"turns: {_turns_line(times)}; bound {bound_ms:.6f} ms "
                  f"(bytes), share of bound L2-cold "
                  f"{bound_ms / times['kernel'][2]:.3f} (parent "
                  f"{bound_ms / times['parent kernel'][2]:.3f}), graph "
                  f"{bound_ms / times['kernel'][0]:.3f} (parent "
                  f"{bound_ms / times['parent kernel'][0]:.3f}); {_card()}",
                  flush=True)


WALLS = {}


def _wall(name: str, t0: float) -> float:
    """Print and keep the wall of phase ``name``, begun at ``t0``; returns
    the time now (the next phase's start)."""
    now = time.perf_counter()
    WALLS[name] = now - t0
    print(f"phase {name}: wall {WALLS[name]:.3f} s", flush=True)
    return now


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
    parent = phase_only = None
    transport = "gloo"
    if sys.argv[1:3] == ["--phase", "train-parallel"] and sys.argv[3:] in (
            [], ["--transport", "gloo"], ["--transport", "nccl"]):
        phase_only = "train-parallel"
        transport = sys.argv[4] if sys.argv[3:] else transport
    elif sys.argv[1:] in (["--phase", "serve-parallel-families"],
                          ["--phase", "train-long"]):
        phase_only = sys.argv[2]
    elif sys.argv[1:2] == ["--parent"]:
        # a directory holding the parent commit's csrc/bloom_ce.cu, to
        # time it beside this tree's (phase "parent")
        parent = Path(sys.argv[2]).resolve()
    elif sys.argv[1:]:
        print("usage: chip_smoke.py [--parent DIR | --phase "
              "train-parallel [--transport gloo|nccl] | --phase "
              "serve-parallel-families | --phase train-long]",
              file=sys.stderr)
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

    dry = None if phase_only else start_dryrun()
    t_start = time.perf_counter()
    try:
        t0 = time.perf_counter()
        wait_parent = None
        if parent is not None:
            from repro_torch.kernels import sweep_ce
            wait_parent = sweep_ce.start_parent(parent)
        built = common.build()
        print("build: " + ", ".join(f"{n} {s:.3f} s"
                                    for n, s in built.items())
              + f" (wall {time.perf_counter() - t0:.3f} s)", flush=True)
        _check(set(built) == {dt.NAME, be.NAME, ce.NAME, csr.NAME, bd.NAME},
               f"unexpected kernels {sorted(built)}")
        _wall("build", t0)
        if dry is not None:
            t0 = time.perf_counter()
            phase_dryrun(dry)
            _wall("dryrun (after the build)", t0)
    finally:
        if dry is not None:
            dry.stop()

    if phase_only == "train-parallel":
        prows, pcounts = phase_train_parallel(torch, be, ce, csr, common,
                                              transport)
        print(json.dumps({"kernels": prows, "other_launches": pcounts}))
        return 0
    if phase_only == "train-long":
        counts, errs = phase_train_long(torch, common, [
            be.NAME + ".hash", csr.BIN, csr.NAME, ce.FWD, ce.BWD])
        _wall(phase_only, t_start)
        print(json.dumps({"launches": counts, "max_abs_err": errs}))
        return 0
    if phase_only:
        counts, errs = phase_serve_parallel_families(torch, common)
        _wall(phase_only, t_start)
        print(json.dumps({"launches": counts, "max_abs_err": errs}))
        return 0
    from repro_torch.core import quant
    t0 = time.perf_counter()
    row = phase_kernels(torch, dt, common, bloom, get_retrieval_config)
    lm_decode_topk(torch, dt, common, bloom)
    row["max_abs_err"] = max(row["max_abs_err"], decode_topk_sweep_shapes(
        torch, dt, quant, bloom, get_retrieval_config))
    t0 = _wall("kernels", t0)
    phase_embed(torch, be)
    embed_rows = phase_embed_tokens(torch, be, common, quant)
    t0 = _wall("kernels-embed", t0)
    embed_row = embed_rows[0]       # bloom_embed.hash: the bf16 LM table
    row["launches"] = phase_serve(torch, dt, common, bloom, retrieval,
                                  get_retrieval_config)
    ev = retrieval._smoke_eval(torch.device("cuda"), 0)
    print(f"eval: smoke untrained rr={ev['rr']:.6f} map={ev['map']:.6f} "
          f"n={ev['n_evaluated']}", flush=True)
    t0 = _wall("serve and eval", t0)
    lm = phase_serve_lm(torch, be, dt, common)
    t0 = _wall("serve-lm", t0)
    row["launches"] += lm[dt.NAME]
    embed_row["launches"] = lm[embed_row["name"]]
    train_rows = (phase_ce(torch, ce, common)
                  + phase_csr(torch, csr, common))
    t0 = _wall("kernels-train", t0)
    trained, csr_losses, csr_ms = phase_train_lm(
        torch, common, [embed_row["name"], csr.BIN, csr.NAME, ce.FWD,
                        ce.BWD])
    t0 = _wall("train-lm", t0)
    embed_row["launches"] += trained[embed_row["name"]]
    for r in train_rows:
        r["launches"] = trained[r["name"]]
    phase_embed_quant(torch, be, quant)
    quant_rows = embed_rows[1:] + phase_decode_quant(
        torch, dt, common, bloom, quant, get_retrieval_config)
    t0 = _wall("kernels-quant", t0)
    served = phase_serve_quant(torch, be, dt, common, bloom, quant,
                               retrieval, get_retrieval_config)
    t0 = _wall("serve-quant", t0)
    _check(set(served) == {r["name"] for r in quant_rows},
           f"quantized variants launched {sorted(served)}, rows "
           f"{sorted(r['name'] for r in quant_rows)}")
    for r in quant_rows:
        r["launches"] = served[r["name"]]
    decode_rows = phase_kernels_decode(torch, bd, csr, be, common, bloom,
                                       quant)
    t0 = _wall("kernels-decode", t0)
    launched = phase_decode_grad(torch, bd, csr, common, bloom, quant)
    t0 = _wall("decode-grad", t0)
    dense_counts = phase_train_lm_dense(
        torch, be, common, [embed_row["name"], be.BWD, ce.FWD, ce.BWD],
        csr_losses, csr_ms)
    t0 = _wall("train-lm-dense", t0)
    _check(csr.NAME not in dense_counts and csr.BIN not in dense_counts,
           "the dense training run launched the CSR kernel or its binning")
    launched.update(dense_counts)
    for r in decode_rows:
        r["launches"] = launched.get(r["name"], 0)
    rt_counts = phase_train_retrieval(torch, dt, common, bloom, quant,
                                      retrieval, get_retrieval_config)
    t0 = _wall("train-retrieval", t0)
    for r in [row, *quant_rows]:
        r["launches"] += rt_counts.pop(r["name"], 0)
    _check(not rt_counts, f"train-retrieval launched {sorted(rt_counts)}, "
           "which no kernel row names")
    paper_launches = phase_paper(torch, bd, common)
    t0 = _wall("paper", t0)
    for r in decode_rows:
        if r["name"] == bd.NAME:
            r["launches"] += paper_launches
    rows = [row, embed_row, *train_rows, *quant_rows, *decode_rows]
    by_name = {r["name"]: r for r in rows}
    for name, run in (
            ("serve-batch", lambda: (phase_serve_batch(torch, be, dt,
                                                       common), {})),
            ("serve-families", lambda: phase_serve_families(torch, be, dt,
                                                            common)),
            ("serve-frontends", lambda: phase_serve_frontends(
                torch, be, dt, common, [embed_row["name"], csr.BIN,
                                        csr.NAME, ce.FWD, ce.BWD])),
            ("serve-sharded", lambda: phase_serve_sharded(torch, be, dt,
                                                          common)),
            ("bench-serving", lambda: phase_bench_serving(torch, common)),
            ("examples", lambda: phase_examples(torch, common, [
                embed_row["name"], csr.BIN, csr.NAME, ce.FWD, ce.BWD])),
            ("train-long", lambda: phase_train_long(torch, common, [
                embed_row["name"], csr.BIN, csr.NAME, ce.FWD, ce.BWD]))):
        counts, errs = run()
        t0 = _wall(name, t0)
        _check(set(counts) <= set(by_name), f"launched "
               f"{sorted(set(counts) - set(by_name))}, which no kernel "
               "row names")
        for name, c in counts.items():
            by_name[name]["launches"] += c
            by_name[name]["max_abs_err"] = max(
                by_name[name]["max_abs_err"], errs.get(name, 0.0))
    prows, pcounts = phase_train_parallel(torch, be, ce, csr, common)
    t0 = _wall("train-parallel", t0)
    rows += prows
    by_name.update((r["name"], r) for r in prows)
    for label, run in (
            ("train-parallel", lambda: (pcounts, {})),
            ("serve-parallel", lambda: phase_serve_parallel(torch, common)),
            ("serve-parallel-families",
             lambda: phase_serve_parallel_families(torch, common))):
        counts, errs = run()
        if label != "train-parallel":
            t0 = _wall(label, t0)
        _check(set(counts) <= set(by_name), f"{label} launched "
               f"{sorted(set(counts) - set(by_name))}, which no kernel "
               "row names")
        for name, c in counts.items():
            by_name[name]["launches"] += c
            by_name[name]["max_abs_err"] = max(
                by_name[name]["max_abs_err"], errs.get(name, 0.0))
    _check(all(r["launches"] > 0 for r in rows),
           "a kernel of the main paths was never launched")
    if wait_parent is not None:
        parent_ce(torch, ce, common, wait_parent())
        t0 = _wall("parent", t0)
    print("phase walls: " + ", ".join(f"{n} {w:.3f} s"
                                      for n, w in WALLS.items())
          + f"; the script {time.perf_counter() - t_start:.3f} s after "
          "its imports", flush=True)

    print(_card())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
