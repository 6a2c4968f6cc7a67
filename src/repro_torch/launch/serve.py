"""Serving driver: thin CLI over the continuous-batching engine.

The default mode builds a seeded Poisson workload (serving/loadgen.py) and
serves it through ``serving.engine.Engine``: requests are admitted into
freed cache slots every decode step and retired on per-slot stop
conditions.  Every prefill and decode step embeds its tokens through the
Bloom embedding (the ``bloom_embed`` CUDA kernel on a GPU) and recovers
the next token by the paper's Eq. 3 top-k over the original vocab (the
``bloom_decode_topk`` CUDA kernel).  ``--static`` serves the same workload
by static batching (``Engine.run_static``), the A/B baseline.
``--table-dtype`` (int8, fp8_e4m3, bfloat16, float32) stores the Bloom
tables narrow: the embedding table is quantized once at set-up and
gathered by the quantized ``bloom_embed`` variant, and every Eq. 3 decode
quantizes its logp rows and rehashes the vocab in the kernel.

``--mode retrieval`` serves one-shot Bloom top-k retrieval requests (Zipf
item lookups over a configs/retrieval.py catalog preset) through
``serving.retrieval.RetrievalEngine`` — the same slot loop, so
``--failpoints`` and the overload flags (``--deadline-slack`` /
``--max-queue-depth``) apply there too.

Weights are random, drawn on the CPU from ``--seed`` by the port's own
init, then cast to the compute dtype and moved to the device.  It runs on
CUDA unless ``--device cpu`` is given (smoke size unless ``--full``), and
raises when CUDA is asked for and absent.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
      --full --slots 8 --requests 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
      --device cpu --slots 3 --requests 10 --topk 4 [--static] \\
      [--table-dtype int8]
  PYTHONPATH=src python -m repro_torch.launch.serve --mode retrieval \\
      --retrieval-config smoke --device cpu --requests 16
"""
from __future__ import annotations

import argparse

from repro_torch import configs
from repro_torch.kernels import common as kernels_common
from repro_torch.kernels.common import resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.serving import retrieval as retrieval_lib
from repro_torch.serving.admission import AdmissionPolicy
from repro_torch.serving.engine import Engine, mean_latency
from repro_torch.serving.failpoints import FailPlan
from repro_torch.serving.loadgen import (LoadSpec, RetrievalLoadSpec,
                                         make_workload, retrieval_workload)


def _overload_policy(deadline_slack, max_queue_depth):
    """CLI knobs -> optional AdmissionPolicy: either flag alone activates
    the policy (deadline shedding needs workload deadlines; the ladder
    runs with its default thresholds)."""
    if deadline_slack is None and max_queue_depth is None:
        return None
    return AdmissionPolicy(max_queue_depth=max_queue_depth)


def _tag_deadlines(requests, deadline_slack):
    if deadline_slack is not None:
        for r in requests:
            r.deadline_step = r.arrival_step + deadline_slack
    return requests


def _print_policy(stats):
    if stats.rejects:
        print(f"rejected {stats.rejects} requests "
              f"(prefill attempts exhausted)")
    if stats.sheds or stats.degrades:
        print(f"overload policy: {stats.sheds} shed, "
              f"{stats.degrades} degrade transitions")


def build_model(cfg, seed: int, device):
    """Random serving weights: drawn from ``seed`` in f32 on the CPU, cast
    to the compute dtype once, then moved to ``device``."""
    model = steps_lib.init_fn_for(cfg)(seed)
    model = steps_lib.cast_params_for_compute(model, cfg)
    return model.to(device).eval().requires_grad_(False)


def run_lm(arch: str, slots: int = 4, requests: int = 16,
           rate: float = 1.0, prompt_len: int = 32, gen: int = 16,
           topk: int = 8, seed: int = 0, full: bool = False,
           static: bool = False, eos_id: int | None = None,
           prefill_workers: int = 1, failpoints: str | None = None,
           deadline_slack: int | None = None,
           max_queue_depth: int | None = None,
           table_dtype: str | None = None, device=None):
    """Serve a seeded Poisson workload continuously (or, with ``static``,
    by static batching over the same pool), with the Bloom tables stored
    as ``table_dtype`` (default: the config's, "auto")."""
    device = resolve_device(device)
    if device.type == "cuda":
        kernels_common.build()     # nvcc at first use: not in the run's wall
    over = {} if table_dtype is None else {"table_dtype": table_dtype}
    cfg = (configs.get_config(arch, **over) if full
           else configs.get_smoke_config(arch, **over))
    model = build_model(cfg, seed, device)
    spec = LoadSpec(
        n_requests=requests, vocab=cfg.vocab, rate=rate,
        prompt_lens=(max(prompt_len // 2, 2), prompt_len),
        gen_lens=(max(gen // 4, 1), gen // 2 or 1, gen), seed=seed)
    workload = _tag_deadlines(make_workload(spec), deadline_slack)
    max_len = max(r.prompt_len + r.max_gen for r in workload)

    engine = Engine(cfg, model, n_slots=slots, max_len=max_len, topk=topk,
                    eos_id=eos_id, prefill_workers=prefill_workers,
                    failpoints=FailPlan.parse(failpoints),
                    admission_policy=_overload_policy(deadline_slack,
                                                      max_queue_depth))
    results, stats = (engine.run_static(workload) if static
                      else engine.run(workload))
    _print_policy(stats)
    row = stats.as_row()
    print(f"served {len(results)} requests on {slots} slots "
          f"({'static' if static else 'continuous'}, {cfg.name} "
          f"{cfg.num_layers}L d_model {cfg.d_model}, table_dtype "
          f"{cfg.table_dtype}, {device}): "
          f"{row['decode_steps']} decode steps, "
          f"utilization {row['utilization']:.2f}, "
          f"mean latency {mean_latency(results):.1f} steps")
    print(f"wall {stats.wall_s * 1e3:.0f} ms "
          f"({stats.tokens_out / max(stats.wall_s, 1e-9):.0f} tok/s)")
    for r in list(results.values())[:4]:
        print(f"  req {r.rid}: arrive {r.arrival_step} admit "
              f"{r.admitted_step} finish {r.finish_step} "
              f"tokens {r.tokens[:8]}{'...' if len(r.tokens) > 8 else ''}")
    return results, stats


def run_retrieval(preset: str = "smoke", slots: int = 4,
                  requests: int = 16, rate: float = 2.0, seed: int = 0,
                  prefill_workers: int = 1, failpoints: str | None = None,
                  deadline_slack: int | None = None,
                  max_queue_depth: int | None = None, device=None):
    """One-shot Bloom retrieval serving (--mode retrieval): Zipf item
    lookups from ``loadgen.retrieval_workload`` through RetrievalEngine."""
    device = resolve_device(device)
    rcfg = configs.get_retrieval_config(preset)
    spec = RetrievalLoadSpec(n_requests=requests, catalog=rcfg.d,
                             c_max=rcfg.c_max, rate=rate, seed=seed)
    workload = _tag_deadlines(retrieval_workload(spec), deadline_slack)
    params = retrieval_lib.init_retrieval_params(rcfg, device=device)
    engine = retrieval_lib.RetrievalEngine(
        rcfg, params, n_slots=slots, prefill_workers=prefill_workers,
        failpoints=FailPlan.parse(failpoints),
        admission_policy=_overload_policy(deadline_slack, max_queue_depth))
    results, stats = engine.run(workload)

    row = stats.as_row()
    served = [r for r in results.values() if r.done and not r.shed]
    print(f"served {len(served)}/{len(results)} retrieval requests on "
          f"{slots} slots over a d={rcfg.d:,} catalog ({preset}, {device}): "
          f"{row['decode_steps']} decode steps, "
          f"utilization {row['utilization']:.2f}, "
          f"mean latency {mean_latency(results):.1f} steps")
    _print_policy(stats)
    if rcfg.d <= retrieval_lib.EVAL_MAX_CATALOG and served:
        metrics = retrieval_lib.evaluate_retrieval(rcfg, params, served)
        print(f"offline ranking vs held-out targets: "
              f"map {metrics['map']:.4f}, rr {metrics['rr']:.4f} "
              f"over {metrics['n_evaluated']} requests")
    return results, stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("lm", "retrieval"), default="lm",
                    help="'lm' = token generation (default); 'retrieval' "
                         "= one-shot Bloom top-k over an item catalog")
    ap.add_argument("--retrieval-config",
                    choices=sorted(configs.RETRIEVAL_CONFIGS),
                    default="smoke",
                    help="configs/retrieval.py preset (--mode retrieval)")
    ap.add_argument("--arch", default=None, choices=list(configs.ARCH_NAMES))
    ap.add_argument("--full", action="store_true",
                    help="the full-width config (default: its smoke size)")
    ap.add_argument("--static", action="store_true",
                    help="static batching over the same pool (A/B)")
    ap.add_argument("--slots", type=int, default=4,
                    help="cache-pool slots")
    ap.add_argument("--requests", type=int, default=16,
                    help="workload size")
    ap.add_argument("--rate", type=float, default=None,
                    help="Poisson arrivals per decode step (default 1.0, "
                         "2.0 for --mode retrieval)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--topk", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eos-id", type=int, default=None,
                    help="stop a slot early on this token id")
    ap.add_argument("--prefill-workers", type=int, default=1,
                    help="prefill-pool size")
    ap.add_argument("--failpoints", default=None,
                    help="deterministic fault schedule "
                         "(serving/failpoints.py grammar), e.g. "
                         "'fail_prefill:2:3,surge:3@1'")
    ap.add_argument("--deadline-slack", type=int, default=None,
                    help="tag every request with deadline = arrival + "
                         "SLACK and enable the admission policy")
    ap.add_argument("--max-queue-depth", type=int, default=None,
                    help="bound the visible queue; excess arrivals are "
                         "shed (enables the admission policy)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--sharded", action="store_true",
                    help="not ported yet (ROADMAP A13)")
    ap.add_argument("--transport", choices=("sim", "collective"),
                    default="sim", help="not ported yet (ROADMAP A13)")
    ap.add_argument("--table-dtype", default=None,
                    help="Bloom table storage dtype of LM serving: auto "
                         "(default), float32, bfloat16, int8 or fp8_e4m3 "
                         "(not read by --mode retrieval, as in the "
                         "reference)")
    args = ap.parse_args(argv)
    if args.sharded or args.transport != "sim":
        raise NotImplementedError(
            "--sharded / --transport collective: sharded serving is not "
            "ported yet (ROADMAP A13)")
    common = dict(slots=args.slots, requests=args.requests, seed=args.seed,
                  prefill_workers=args.prefill_workers,
                  failpoints=args.failpoints,
                  deadline_slack=args.deadline_slack,
                  max_queue_depth=args.max_queue_depth, device=args.device)
    if args.mode == "retrieval":
        if args.static:
            ap.error("--mode retrieval has no --static path")
        run_retrieval(args.retrieval_config,
                      rate=2.0 if args.rate is None else args.rate, **common)
        return
    if args.arch is None:
        ap.error("--arch is required with --mode lm")
    run_lm(args.arch, rate=1.0 if args.rate is None else args.rate,
           prompt_len=args.prompt_len, gen=args.gen, topk=args.topk,
           full=args.full, static=args.static, eos_id=args.eos_id,
           table_dtype=args.table_dtype, **common)


if __name__ == "__main__":
    main()
