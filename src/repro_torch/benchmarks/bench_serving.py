"""Serving-engine benchmark of the port, the twin of
``benchmarks/bench_serving.py``: continuous batching vs static batching on
the seeded mixed-length workload (serving/loadgen.py), the web-scale
one-shot retrieval rows, and model-free replays of the gossiped
multi-host schedule (``sched.sharded_*`` rows:
``scheduler.simulate_sharded_schedule`` over per-host loadgen streams),
with the host-kill recovery row (``sched.sharded_kill1``) and the
overload row (``sched.sharded_surge``: surge + slow_decode + admission
policy, beside an in-bench unloaded twin).

Every checked field is a deterministic integer or a rounding of integers
(decode steps, slot steps, tokens, sheds, modeled bytes): a pure function
of the workload seed, the slot count and the gen-length mix, the same on
the CPU and on the card.  Wall-clock fields are recorded and never
checked.  It builds all 16 rows of ``BENCH_serving.json``, the SSM
family's ``mamba2-1.3b`` rows among them.

``--check`` holds the rows it builds to the committed
``BENCH_serving.json`` (read only, never written), fails on any drift of
a ``CHECKED_FIELDS`` entry, on a continuous/static decode-step speedup
below ``MIN_SPEEDUP``, on a retrieval streaming-vs-dense modeled-bytes
ratio below ``MIN_RETRIEVAL_BYTES_RATIO``, and unless the rows it builds
are exactly the committed ones.
``--out F`` writes a snapshot of the fresh rows to F.

``--measure`` times one warm full-occupancy retrieval decode step per
retrieval case on the card (CUDA events, ``kernels.common.time_ms``) into
``measured_us`` beside ``model_vs_measured``: the least bytes that step
must move (``bloom_decode_topk.min_bytes``) over the H100 SXM's HBM3 rate
(3.35 TB/s, NVIDIA's data sheet), divided by the measured time.  It
needs a CUDA device and raises without one; it is never checked.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_serving \\
        [--check] [--device cpu] [--measure] [--out snapshot.json]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

import torch

from repro_torch import configs
from repro_torch.kernels import common as kernels_common
from repro_torch.kernels.bloom_decode_topk import min_bytes
from repro_torch.kernels.common import resolve_device
from repro_torch.launch import serve as serve_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.serving.admission import AdmissionPolicy, slo_attainment
from repro_torch.serving.engine import Engine, mean_latency
from repro_torch.serving.failpoints import FailPlan
from repro_torch.serving.loadgen import (LoadSpec, RetrievalLoadSpec,
                                         assert_fresh_instances,
                                         mixed_length_workload,
                                         overload_workload,
                                         retrieval_workload,
                                         sharded_workload)
from repro_torch.serving.retrieval import (RetrievalEngine,
                                           init_retrieval_params)
from repro_torch.serving.scheduler import simulate_sharded_schedule

JSON_PATH = pathlib.Path(__file__).resolve().parents[3] / \
    "BENCH_serving.json"
MIN_SPEEDUP = 1.5
# H100 SXM HBM3 rate (NVIDIA's data sheet), the --measure model's rate
HBM_BW = 3.35e12
# retrieval.* rows: the streaming decode must model at least this many
# times fewer bytes than the dense-table oracle
MIN_RETRIEVAL_BYTES_RATIO = 3.0

# (arch, n_slots, n_requests, seed): one dense and one attention-free SSM
# arch, as the reference's CASES — the slot pool covers KV caches and
# conv/ssm state alike
CASES = [
    ("qwen1.5-0.5b", 3, 10, 0),
    ("mamba2-1.3b", 3, 10, 0),
]
TOPK = 4
MAX_LEN = 40

# (n_hosts, slots_per_host, n_requests PER HOST, gossip_delay, seed,
#  compact_threshold): the reference's model-free multi-host replays; the
# compaction pair pins the remap's schedule invariance
SHARDED_CASES = [
    (4, 2, 4, 1, 0, None),
    (8, 1, 2, 1, 0, None),
    (4, 2, 4, 0, 0, None),
    (4, 2, 4, 2, 0, None),
    (4, 4, 6, 1, 0, None),
    (4, 4, 6, 1, 0, 0.25),
]
# host 1 killed mid-traffic on the h4x2_d1 workload
SHARDED_KILL_CASES = [
    (4, 2, 4, 1, 0, None, "kill_host:1@3"),
]
# (n_hosts, slots_per_host, n_requests PER HOST, gossip_delay, seed,
#  failpoints, surge_start, surge_factor, deadline_slack)
SHARDED_SURGE_CASES = [
    (4, 2, 4, 1, 0, "surge:3@1,slow_decode:3@2", 1, 2, 8),
]
SURGE_POLICY = dict(max_queue_depth=2, pressure_window=2,
                    degrade_lo=0.25, degrade_hi=0.5, restore_below=0.1)
# (retrieval config, n_slots, n_requests, seed)
RETRIEVAL_CASES = [
    ("web1m", 8, 12, 0),
    ("web10m", 8, 8, 0),
]

# deterministic simulation outputs; wall-clock fields are excluded
CHECKED_FIELDS = ("decode_steps", "slot_steps_total", "slot_steps_active",
                  "utilization", "tokens_out", "mean_latency_steps",
                  "decode_step_speedup", "utilization_gain", "compactions",
                  "host_downs", "requeued", "rejects",
                  "recovery_overhead_steps", "sheds",
                  "degrade_transitions", "slo_attainment",
                  "unloaded_twin_decode_steps", "overhead_steps_vs_twin",
                  "streaming_bytes", "dense_oracle_bytes", "bytes_ratio")


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _run_case(arch: str, n_slots: int, n_requests: int, seed: int,
              device: torch.device):
    cfg = configs.get_smoke_config(arch)
    model = serve_lib.build_model(cfg, seed, device)
    engine = Engine(cfg, model, n_slots=n_slots, max_len=MAX_LEN, topk=TOPK)

    # one workload, two runs, each on its own fresh copies
    wl = mixed_length_workload(cfg.vocab, n_requests, seed=seed)
    wl_c = [r.fresh_copy() for r in wl]
    wl_s = [r.fresh_copy() for r in wl]
    assert_fresh_instances(wl_c, wl_s)
    res_c, st_c = engine.run(wl_c)
    res_s, st_s = engine.run_static(wl_s)
    _check(all(r.done for r in res_c.values()),
           f"{arch}: a continuous request was not served")

    rows = []
    for mode, res, st in (("continuous", res_c, st_c),
                          ("static", res_s, st_s)):
        rows.append({
            "bench": "serving", "name": f"{arch}.{mode}",
            "n_slots": n_slots, "n_requests": n_requests, "seed": seed,
            "decode_steps": st.decode_steps,
            "slot_steps_total": st.slot_steps_total,
            "slot_steps_active": st.slot_steps_active,
            "utilization": round(st.utilization, 4),
            "tokens_out": st.tokens_out,
            "mean_latency_steps": round(mean_latency(res), 4),
            # informational only (wall time: never checked)
            "wall_s": round(st.wall_s, 3),
            "tok_per_s_wall": round(st.tokens_out / max(st.wall_s, 1e-9)),
        })
    rows.append({
        "bench": "serving", "name": f"{arch}.speedup",
        "n_slots": n_slots, "n_requests": n_requests, "seed": seed,
        "decode_step_speedup": round(
            st_s.decode_steps / max(st_c.decode_steps, 1), 4),
        "utilization_gain": round(
            st_c.utilization - st_s.utilization, 4),
    })
    return rows


def _sharded_spec(n_requests: int, seed: int) -> LoadSpec:
    # the canonical mixed-length mix, split into per-host streams
    return LoadSpec(n_requests=n_requests, vocab=1024, rate=2.0,
                    prompt_lens=(6, 10, 14), gen_lens=(3, 6, 20),
                    gen_weights=(0.5, 0.3, 0.2), seed=seed)


def _run_sharded_case(n_hosts: int, slots_per_host: int, n_requests: int,
                      gossip_delay: int, seed: int,
                      compact_threshold=None, failpoints=None):
    per_host = sharded_workload(_sharded_spec(n_requests, seed), n_hosts)
    _, st = simulate_sharded_schedule(
        per_host, slots_per_host, gossip_delay,
        compact_threshold=compact_threshold,
        failpoints=FailPlan.parse(failpoints) if failpoints else None)
    results = {r.rid: r for reqs in per_host for r in reqs}
    name = f"sched.sharded_h{n_hosts}x{slots_per_host}_d{gossip_delay}"
    _check(all(r.done for r in results.values()),
           f"{name}: a request was not served")
    row = {
        "bench": "serving",
        "name": name,
        "n_hosts": n_hosts, "slots_per_host": slots_per_host,
        "n_requests": n_requests * n_hosts, "seed": seed,
        "gossip_delay": gossip_delay,
        "decode_steps": st.decode_steps,
        "slot_steps_total": st.slot_steps_total,
        "slot_steps_active": st.slot_steps_active,
        "utilization": round(st.utilization, 4),
        "tokens_out": st.tokens_out,
        "mean_latency_steps": round(mean_latency(results), 4),
    }
    if compact_threshold is not None:
        row["name"] = f"{name}_c{int(compact_threshold * 100)}"
        row["compact_threshold"] = compact_threshold
        row["compactions"] = st.compactions
        _check(st.compactions > 0,
               f"{row['name']}: the compaction case never compacted")
    if failpoints is not None:
        row["name"] = "sched.sharded_kill1"
        row["fault_free_twin"] = name
        row["failpoints"] = failpoints
        row["host_downs"] = st.host_downs
        row["requeued"] = st.requeued
        row["rejects"] = st.rejects
        _check(st.requeued > 0, f"{row['name']}: the kill reclaimed nothing")
        _check(st.rejects == 0,
               f"{row['name']}: recovery dropped {st.rejects} requests")
    return row


def _run_surge_case(n_hosts: int, slots_per_host: int, n_requests: int,
                    gossip_delay: int, seed: int, failpoints: str,
                    surge_start: int, surge_factor: int,
                    deadline_slack: int):
    spec = _sharded_spec(n_requests, seed)

    def wl():
        # fresh Request instances per replay
        return overload_workload(spec, n_hosts, surge_start=surge_start,
                                 surge_factor=surge_factor,
                                 deadline_slack=deadline_slack)

    per_host = wl()
    _, st = simulate_sharded_schedule(
        per_host, slots_per_host, gossip_delay,
        failpoints=FailPlan.parse(failpoints),
        admission_policy=AdmissionPolicy(**SURGE_POLICY))
    results = {r.rid: r for reqs in per_host for r in reqs}
    shed = [r.rid for r in results.values() if r.shed]
    served = [r for r in results.values()
              if r.done and not r.shed and not r.rejected]
    _check(all(r.done for r in results.values()),
           "sched.sharded_surge: a request is neither served nor shed")
    _check(st.sheds == len(shed) and st.sheds > 0,
           f"sched.sharded_surge: expected sheds under overload, got "
           f"{st.sheds}")
    _check(st.degrades > 0,
           "sched.sharded_surge: the degrade ladder never moved")
    _check(st.rejects == 0,
           f"sched.sharded_surge: overload must shed, never reject "
           f"(got {st.rejects} rejects)")

    # the unloaded twin: same compressed arrivals, no failpoints, no policy
    twin_wl = wl()
    _, twin_st = simulate_sharded_schedule(twin_wl, slots_per_host,
                                           gossip_delay)
    _check(all(r.done and not r.shed and not r.rejected
               for reqs in twin_wl for r in reqs),
           "sched.sharded_surge: the unloaded twin shed or dropped work")

    return {
        "bench": "serving", "name": "sched.sharded_surge",
        "n_hosts": n_hosts, "slots_per_host": slots_per_host,
        "n_requests": n_requests * n_hosts, "seed": seed,
        "gossip_delay": gossip_delay,
        "failpoints": failpoints,
        "surge_start": surge_start, "surge_factor": surge_factor,
        "deadline_slack": deadline_slack,
        "decode_steps": st.decode_steps,
        "slot_steps_total": st.slot_steps_total,
        "slot_steps_active": st.slot_steps_active,
        "utilization": round(st.utilization, 4),
        "tokens_out": st.tokens_out,
        "mean_latency_steps": round(mean_latency(results), 4),
        "sheds": st.sheds,
        "rejects": st.rejects,
        "degrade_transitions": st.degrades,
        "slo_attainment": round(slo_attainment(len(served),
                                               len(results)), 4),
        "unloaded_twin_decode_steps": twin_st.decode_steps,
        "overhead_steps_vs_twin": st.decode_steps - twin_st.decode_steps,
    }


def _measure(rcfg, n_slots: int, seed: int, device: torch.device) -> dict:
    """One warm full-occupancy retrieval decode step on the card: its mean
    time over CUDA events and the least bytes it must move over the
    card's HBM rate, divided by that time."""
    if device.type != "cuda":
        raise RuntimeError("--measure times the card: it needs a CUDA "
                           "device (drop --device cpu)")
    step = steps_lib.make_retrieval_decode_step(rcfg, device)
    gen = torch.Generator(device).manual_seed(seed)
    pool = torch.log_softmax(torch.randn(n_slots, rcfg.m, generator=gen,
                                         device=device), -1)
    active = torch.ones(n_slots, dtype=torch.bool, device=device)
    us = 1e3 * kernels_common.time_ms(lambda: step(pool, active), 20, 3)
    model_us = 1e6 * min_bytes(n_slots, n_slots, m=rcfg.m, d=rcfg.d,
                               k=rcfg.k, topk=rcfg.topk) / HBM_BW
    return {"measured_us": round(us, 1),
            "model_vs_measured": round(model_us / us, 6)}


def _run_retrieval_case(name: str, n_slots: int, n_requests: int,
                        seed: int, device: torch.device,
                        measure: bool = False):
    rcfg = configs.get_retrieval_config(name)
    load = RetrievalLoadSpec(n_requests=n_requests, catalog=rcfg.d,
                             c_max=rcfg.c_max, rate=2.0, seed=seed)
    wl = retrieval_workload(load)
    engine = RetrievalEngine(rcfg, init_retrieval_params(rcfg, device=device),
                             n_slots=n_slots)
    wl_a = [r.fresh_copy() for r in wl]
    wl_b = [r.fresh_copy() for r in wl]
    assert_fresh_instances(wl_a, wl_b)
    res_a, st = engine.run(wl_a)
    res_b, _ = engine.run(wl_b)
    _check(all(r.done and not r.rejected for r in res_a.values()),
           f"retrieval.{name}: a request was not served")
    for rid, ra in res_a.items():
        _check(ra.topk_ids == res_b[rid].topk_ids,
               f"retrieval.{name}: rid {rid} top-k ids drifted across "
               "replays")
    mb = engine.modeled_bytes
    ratio = round(mb["dense_oracle_bytes"]
                  / max(mb["streaming_bytes"], 1), 1)
    return {
        "bench": "serving", "name": f"retrieval.{name}",
        "d": rcfg.d, "m": rcfg.m, "k": rcfg.k, "topk": rcfg.topk,
        "impl": rcfg.resolved_impl(device),
        "n_slots": n_slots, "n_requests": n_requests, "seed": seed,
        "decode_steps": st.decode_steps,
        "slot_steps_total": st.slot_steps_total,
        "slot_steps_active": st.slot_steps_active,
        "utilization": round(st.utilization, 4),
        "tokens_out": st.tokens_out,
        "mean_latency_steps": round(mean_latency(res_a), 4),
        # the reference's decode-bytes model at the run's per-step
        # occupancy vs the dense (d, m)-table oracle over the same steps
        "streaming_bytes": mb["streaming_bytes"],
        "dense_oracle_bytes": mb["dense_oracle_bytes"],
        "bytes_ratio": ratio,
        # informational only (wall time: never checked)
        "wall_s": round(st.wall_s, 3),
        **(_measure(rcfg, n_slots, seed, device) if measure else {}),
    }


def run(device=None, measure: bool = False):
    """Every row this twin builds, on ``device`` (CUDA unless the caller
    asks for the CPU), with the reference's cross-row checks."""
    device = resolve_device(device)
    rows = []
    for arch, n_slots, n_requests, seed in CASES:
        rows.extend(_run_case(arch, n_slots, n_requests, seed, device))
    for case in RETRIEVAL_CASES:
        rows.append(_run_retrieval_case(*case, device=device,
                                        measure=measure))
    for case in SHARDED_CASES:
        rows.append(_run_sharded_case(*case))
    for case in SHARDED_KILL_CASES:
        rows.append(_run_sharded_case(*case))
    for case in SHARDED_SURGE_CASES:
        rows.append(_run_surge_case(*case))
    # compaction schedule invariance: every _c row replays its twin's steps
    by_name = {r["name"]: r for r in rows}
    for r in rows:
        if "compact_threshold" not in r:
            continue
        twin = by_name[r["name"].rsplit("_c", 1)[0]]
        for f in ("decode_steps", "slot_steps_total", "slot_steps_active",
                  "tokens_out", "mean_latency_steps"):
            _check(r[f] == twin[f], f"{r['name']}.{f}: compaction changed "
                   f"the schedule ({twin[f]} -> {r[f]})")
    # recovery overhead: the kill row replays its fault-free twin's work
    for r in rows:
        twin_name = r.get("fault_free_twin")
        if twin_name is None:
            continue
        overhead = r["decode_steps"] - by_name[twin_name]["decode_steps"]
        _check(overhead >= 0, f"{r['name']}: killing a host shortened the "
               "schedule")
        r["recovery_overhead_steps"] = overhead
    return rows


def check_against(rows, path=JSON_PATH) -> list[str]:
    """The fresh rows against the committed baseline (read only): every
    checked field of every row built, the two gates, and every committed
    row built."""
    committed = {r["name"]: r for r in
                 json.loads(path.read_text())["rows"]}
    fresh = {r["name"]: r for r in rows}
    failures = []
    missing = set(committed) - set(fresh)
    if missing:
        failures.append(f"committed rows not built: {sorted(missing)}")
    for name, r in fresh.items():
        old = committed.get(name)
        if old is None:
            failures.append(f"{name}: no such row in {path.name}")
            continue
        for f in CHECKED_FIELDS:
            if (f in old) != (f in r):
                side = "baseline" if f in r else "fresh run"
                failures.append(f"{name}.{f}: checked field missing from "
                                f"the {side}")
            elif f in old and old[f] != r[f]:
                failures.append(f"{name}.{f}: committed {old[f]}, fresh "
                                f"{r[f]}")
        if name.endswith(".speedup") \
                and r.get("decode_step_speedup", 0.0) < MIN_SPEEDUP:
            failures.append(
                f"{name}: continuous/static decode-step speedup "
                f"{r['decode_step_speedup']:.2f} < {MIN_SPEEDUP}")
        if name.startswith("retrieval.") \
                and r.get("bytes_ratio", 0.0) < MIN_RETRIEVAL_BYTES_RATIO:
            failures.append(
                f"{name}: streaming-vs-dense modeled-bytes ratio "
                f"{r.get('bytes_ratio')} < {MIN_RETRIEVAL_BYTES_RATIO}")
    return failures


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help=f"hold the fresh rows against {JSON_PATH.name} "
                         "(read only)")
    ap.add_argument("--measure", action="store_true",
                    help="also time one warm full-occupancy retrieval "
                         "decode step per retrieval case on the card "
                         "(never checked)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--out", default=None,
                    help="write the fresh rows as a snapshot here")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if device.type == "cuda":
        kernels_common.build()     # nvcc at first use: not in the rows' wall
    rows = run(device, measure=args.measure)
    for row in rows:
        print(row)
    if args.out:
        payload = {"generated_by": "PYTHONPATH=src python -m "
                                   "repro_torch.benchmarks.bench_serving",
                   "device": str(device), "min_speedup": MIN_SPEEDUP,
                   "rows": rows}
        pathlib.Path(args.out).write_text(
            json.dumps(payload, indent=1, sort_keys=True) + "\n")
        print(f"wrote {args.out}")
    if args.check:
        failures = check_against(rows)
        for f in failures:
            print("REGRESSION:", f, file=sys.stderr)
        if failures:
            sys.exit(1)
        print(f"check ok: {len(rows)} rows on {device} vs {JSON_PATH.name}")


if __name__ == "__main__":
    main()
