"""Web-scale Bloom retrieval serving.

Top-k item retrieval over a Bloom-compressed catalog of d >= 10M items,
served through the slot-pool machinery — Scheduler / RequestQueue /
ServeStats / PrefillPool — with a per-slot program (engine.SlotProgram):

  * prefill (``RetrievalProgram``): the request's padded item-id set is
    Bloom-encoded (core.bloom.encode, Eq. 1) and pushed through a small
    FF tower (models/recommender.py) to an m-dim logits row — that row
    IS the slot payload (no KV cache, no first token);
  * decode (``steps.make_retrieval_decode_step``): ONE occupancy-aware
    fused Eq. 3 top-k over the whole catalog (io.recover_topk_spec; the
    hand-written CUDA kernel on a GPU), after which every served slot
    retires — the ``oneshot`` request kind.

Never materialized: the (n_slots, d) score matrix and the (d, m) dense
item table (320 GB at d = 10M, m = 8192).

Everything is deterministic: the Zipf workload is a pure function of
(seed, host) (loadgen.retrieval_workload), the schedule is a pure
function of (workload, n_slots), and the decode tie-break (lowest item id
wins on equal Eq. 3 scores) pins the recovered ids bit-identically across
replays.

``python -m repro_torch.serving.retrieval [--config web10m] [--device cpu]``
runs the acceptance drill: a seeded Zipf run through the slot pool, twice,
hard-checking bit-identical top-k ids, a sound slot log, and tie-aware
untrained MAP/RR << 1 at eval scale, then prints ``retrieval: verified``.
It runs on CUDA unless ``--device cpu`` is given, and raises when CUDA is
asked for and absent.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.retrieval import (RetrievalConfig,
                                           get_retrieval_config)
from repro_torch.core import bloom as bloom_lib
from repro_torch.core import quant
from repro_torch.kernels.bloom_decode_topk import min_bytes, modeled_hbm_bytes
from repro_torch.kernels.common import resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.models.recommender import FFTower
from repro_torch.serving import admission as admission_lib
from repro_torch.serving import engine as engine_lib
from repro_torch.serving.admission import AdmissionPolicy
from repro_torch.serving.control import replay_slot_log
from repro_torch.serving.engine import PrefillPool, SlotProgram, run_slot_loop
from repro_torch.serving.failpoints import FailPlan
from repro_torch.serving.loadgen import (RetrievalLoadSpec,
                                         assert_fresh_instances,
                                         retrieval_workload)
from repro_torch.serving.scheduler import Request, ServeStats
from repro_torch.train import metrics as metrics_lib

# full-score eval materializes (B, d) — fine for the smoke/web1m specs,
# a 40 GB allocation at web10m; the serving path never does this
EVAL_MAX_CATALOG = 2_000_000


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def init_retrieval_params(rcfg: RetrievalConfig,
                          generator: Optional[torch.Generator] = None,
                          device=None) -> FFTower:
    """FF tower: m-dim Bloom code in, m-dim logits out, initialised on the
    CPU from ``generator`` (default: seeded with ``rcfg.seed``) and moved
    to ``device`` (default CUDA)."""
    if generator is None:
        generator = torch.Generator().manual_seed(rcfg.seed)
    tower = FFTower(rcfg.m, rcfg.hidden, rcfg.m, generator=generator)
    return tower.to(resolve_device(device)).eval()


@dataclasses.dataclass
class _RetrievalState:
    """Retrieval slot-pool state: the device-resident (n_slots, m) logits
    pool (rows are written in place), a host mirror of the occupancy mask
    (the decode step's ``active`` input AND the bytes models' occupancy
    argument), and the run's accumulated modeled bytes."""
    pool: torch.Tensor
    live: np.ndarray
    streaming_bytes: int = 0
    min_bytes: int = 0


class RetrievalProgram(SlotProgram):
    """The one-shot retrieval slot program (see module doc): prefill
    emits ``(logits_row, None)`` — there is no first token, the slot's
    whole output comes from the single recover step.  The decode half
    (constructed with ``n_slots``) owns the (n_slots, m) logits pool on
    ``device`` and the one occupancy-aware Eq. 3 top-k step over the
    catalog, after which every served slot retires (``oneshot``)."""

    kind = "oneshot"
    oneshot = True
    engine_label = "the retrieval engine"

    def __init__(self, rcfg: RetrievalConfig,
                 n_slots: Optional[int] = None,
                 admission_policy=None, device=None):
        self.rcfg = rcfg
        self.n_slots = n_slots
        self.device = resolve_device(device)
        self._prefill = steps_lib.make_retrieval_prefill_step(rcfg)
        if n_slots is None:
            return                      # prefill-only program
        self._decode = steps_lib.make_retrieval_decode_step(rcfg,
                                                            self.device)
        # degrade ladder (DESIGN.md §14): each stage's narrower decode is
        # pre-built; under the lowest-id tie-break a degraded request's
        # ids are a bit-identical PREFIX of the full-width result
        self._stage = admission_lib.STAGE_NORMAL
        self._stage_topk = {
            st: admission_lib.stage_topk(rcfg.topk, st, admission_policy)
            for st in range(1, admission_policy.max_stage + 1)
        } if admission_policy is not None else {}
        self._stage_topk[admission_lib.STAGE_NORMAL] = rcfg.topk
        self._stage_decodes = engine_lib.build_stage_decodes(
            self._decode, rcfg.topk, admission_policy,
            lambda k: steps_lib.make_retrieval_decode_step(
                dataclasses.replace(rcfg, topk=k), self.device))

    # -- prefill half --------------------------------------------------
    def prefill(self, params, req: Request, device=None):
        items = np.full((1, self.rcfg.c_max), -1, np.int32)
        items[0, :req.prompt_len] = np.asarray(req.prompt, np.int32)
        dev = self.device if device is None else device
        x = torch.from_numpy(items).to(dev)
        return self._prefill(params, x)[0], None

    # -- decode half ---------------------------------------------------
    def check_admit(self, req: Request) -> None:
        _check(req.prompt_len <= self.rcfg.c_max,
               f"request {req.rid}: {req.prompt_len} input items exceeds "
               f"c_max {self.rcfg.c_max}")

    def init_state(self, n_slots: int) -> _RetrievalState:
        _check(n_slots == self.n_slots,
               f"pool of {n_slots} slots, program built for {self.n_slots}")
        return _RetrievalState(
            pool=torch.zeros((n_slots, self.rcfg.m), dtype=torch.float32,
                             device=self.device),
            live=np.zeros((n_slots,), bool))

    def reset_slots(self, state: _RetrievalState) -> None:
        state.live[:] = False

    def insert(self, state: _RetrievalState, req: Request, payload,
               stats: ServeStats) -> bool:
        row, first = payload
        _check(first is None, "oneshot prefill emits no token")
        state.pool[req.slot] = row.to(self.device)
        state.live[req.slot] = True
        return True

    def set_stage(self, stage: int) -> None:
        if stage not in self._stage_decodes:
            raise RuntimeError(
                f"{self.engine_label}: degrade stage {stage} was not "
                "pre-built — construct the program with the run's "
                "admission_policy (DESIGN.md §14)")
        self._stage = stage

    def step(self, params, state: _RetrievalState):
        active = torch.from_numpy(state.live.copy()).to(self.device)
        scores, ids = self._stage_decodes[self._stage](state.pool, active)
        r, topk = self.rcfg, self._stage_topk[self._stage]
        # the reference's TPU grid bytes model (kept for parity), and the
        # least traffic this step needs on any device; both follow the
        # table_dtype knob: a quantized decode reads the logp rows narrow,
        # rehashes in the kernel (no (d, k) read) and, int8 only, reads one
        # f32 scale per live row
        td = None if r.table_dtype == "auto" else r.table_dtype
        narrow = dict(logp_itemsize=quant.table_itemsize(td),
                      inkernel_hash=td is not None,
                      row_scales=quant.resolve_table_dtype(td) == "int8")
        state.streaming_bytes += modeled_hbm_bytes(
            state.live, r.b_tile, m=r.m, d=r.d, k=r.k, topk=topk, **narrow)
        state.min_bytes += min_bytes(int(state.live.sum()), len(state.live),
                                     m=r.m, d=r.d, k=r.k, topk=topk, **narrow)
        return ids.cpu().numpy(), scores.cpu().numpy()

    def emit(self, state: _RetrievalState, req: Request, slot: int, out,
             stats: ServeStats) -> bool:
        # one-shot: every slot that decoded retires with its top-k
        ids_np, scores_np = out
        req.topk_ids = [int(i) for i in ids_np[slot]]
        req.topk_scores = [float(s) for s in scores_np[slot]]
        req.tokens.append(int(ids_np[slot, 0]))
        stats.tokens_out += 1
        state.live[slot] = False
        return True


class RetrievalEngine:
    """Continuous-batching engine for ``oneshot`` retrieval requests.

    Admission, rejection, event logging and stats are the slot loop's
    (Scheduler / PrefillPool); the slot pool is a device-resident
    (n_slots, m) logits buffer + active mask, on the tower's device, and
    every live slot retires right after the step that recovers its top-k.

    After ``run`` the modeled decode bytes of the run are on
    ``self.modeled_bytes``: ``streaming_bytes`` from the reference's TPU
    grid model at each step's occupancy, ``min_bytes`` (the least traffic
    of those steps), and the dense-table oracle twin — all deterministic
    integers.
    """

    def __init__(self, rcfg: RetrievalConfig, params: FFTower, *,
                 n_slots: int, prefill_workers: int = 1,
                 failpoints: Optional[FailPlan] = None,
                 admission_policy: Optional[AdmissionPolicy] = None):
        _check(n_slots >= 1, f"need n_slots >= 1, got {n_slots}")
        self.rcfg = rcfg
        self.params = params
        self.n_slots = n_slots
        self.failpoints = failpoints if failpoints else None
        self.policy = admission_policy
        self.device = next(params.parameters()).device
        self.program = RetrievalProgram(rcfg, n_slots=n_slots,
                                        admission_policy=admission_policy,
                                        device=self.device)
        self.prefill_pool = PrefillPool(
            params, program=self.program, n_workers=prefill_workers,
            failpoints=self.failpoints)
        self.modeled_bytes: Dict[str, int] = {}

    def _dense_oracle_step_bytes(self) -> int:
        """Bytes of ONE dense-table decode step over the full pool: read
        the (d, m) f32 item table and the (B, m) logp rows, write AND
        re-read the (B, d) f32 score matrix (materialize, then top-k),
        flush the (B, topk) f32+i32 outputs."""
        r, B = self.rcfg, self.n_slots
        return (r.d * r.m * 4 + B * r.m * 4 + 2 * B * r.d * 4
                + B * r.topk * 8)

    def run(self, requests: List[Request]
            ) -> Tuple[Dict[int, Request], ServeStats]:
        """Serve ``oneshot`` requests through the generic slot loop
        (engine.run_slot_loop); mutates and returns them with
        ``topk_ids`` / ``topk_scores`` filled (and ``tokens`` holding the
        top-1 item, so shared latency/throughput accounting works)."""
        results, stats, sched, state = run_slot_loop(
            self.program, self.params, self.prefill_pool, requests,
            self.n_slots, failpoints=self.failpoints,
            admission_policy=self.policy)
        self._sched = sched          # exposed for the simulation tests
        self.modeled_bytes = {
            "streaming_bytes": int(state.streaming_bytes),
            "min_bytes": int(state.min_bytes),
            "dense_oracle_bytes": int(self._dense_oracle_step_bytes()
                                      * stats.decode_steps),
            "dense_oracle_step_bytes": self._dense_oracle_step_bytes(),
        }
        return results, stats


@torch.inference_mode()
def evaluate_retrieval(rcfg: RetrievalConfig, params: FFTower,
                       requests: List[Request],
                       table_dtype: Optional[str] = None
                       ) -> Dict[str, float]:
    """Offline ranking eval of served requests against their held-out
    targets, with the user's input items excluded from the ranking.

    Materializes the full (B, d) Eq. 3 score matrix (core.bloom.
    decode_scores, chunked), so it is capped at eval-scale catalogs; the
    SERVING path never does this.  Metrics are the tie-aware
    train/metrics.py: mid-rank RR and stable-sort MAP.  ``table_dtype``
    quantizes and dequantizes the (B, m) logp rows before Eq. 3: the
    values a quantized decode ranks through.
    """
    _check(rcfg.d <= EVAL_MAX_CATALOG,
           f"full-score eval at d={rcfg.d} would materialize a "
           f"(B, {rcfg.d}) matrix; eval on the smoke/web1m specs")
    served = [r for r in requests
              if r.done and not r.rejected and not r.shed
              and r.targets is not None and len(r.targets)]
    if not served:
        return {"map": 0.0, "rr": 0.0, "accuracy": 0.0, "n_evaluated": 0}
    B = len(served)
    prompts = np.full((B, rcfg.c_max), -1, np.int32)
    n_t = max(len(r.targets) for r in served)
    targets = np.full((B, n_t), -1, np.int32)
    for i, r in enumerate(served):
        prompts[i, :r.prompt_len] = np.asarray(r.prompt, np.int32)
        targets[i, :len(r.targets)] = np.asarray(r.targets, np.int32)
    device = next(params.parameters()).device
    logits = steps_lib.make_retrieval_prefill_step(rcfg)(
        params, torch.from_numpy(prompts).to(device))
    logp = torch.log_softmax(logits.float(), dim=-1)
    td = quant.resolve_table_dtype(table_dtype)
    if td is not None:
        logp = quant.dequantize_table(*quant.quantize_table(logp, td))
    scores = bloom_lib.decode_scores(rcfg.spec(), logp,
                                     chunk=rcfg.chunk).cpu().numpy()
    # RR / accuracy score the FIRST held-out target (the single-correct-
    # item measures of Sec. 4.1); MAP scores the full held-out set
    return {
        "map": metrics_lib.mean_average_precision(scores, targets,
                                                  excludes=prompts),
        "rr": metrics_lib.reciprocal_rank(scores, targets[:, 0],
                                          exclude=prompts),
        "accuracy": metrics_lib.accuracy(scores, targets[:, 0],
                                         exclude=prompts),
        "n_evaluated": B,
    }


# ---------------------------------------------------------------------------
# CLI acceptance drill
# ---------------------------------------------------------------------------

def _drill(rcfg: RetrievalConfig, n_requests: int, n_slots: int,
           seed: int, device=None) -> Dict[str, object]:
    """Run the seeded Zipf workload through the slot pool TWICE from
    fresh request copies and hard-check the acceptance criteria."""
    device = resolve_device(device)
    load = RetrievalLoadSpec(n_requests=n_requests, catalog=rcfg.d,
                             c_max=rcfg.c_max, rate=2.0, seed=seed)
    wl = retrieval_workload(load)
    params = init_retrieval_params(rcfg, device=device)
    engine = RetrievalEngine(rcfg, params, n_slots=n_slots)

    wl_a = [r.fresh_copy() for r in wl]
    wl_b = [r.fresh_copy() for r in wl]
    assert_fresh_instances(wl_a, wl_b)
    res_a, st_a = engine.run(wl_a)
    res_b, st_b = engine.run(wl_b)

    _check(all(r.done and not r.rejected for r in res_a.values()),
           "a request was not served")
    for rid, ra in res_a.items():
        rb = res_b[rid]
        _check(len(ra.topk_ids) == rcfg.topk,
               f"rid {rid}: {len(ra.topk_ids)} ids, want {rcfg.topk}")
        _check(all(0 <= i < rcfg.d for i in ra.topk_ids),
               f"rid {rid}: an id outside [0, {rcfg.d})")
        _check(ra.topk_ids == rb.topk_ids,
               f"rid {rid}: top-k ids drifted across replays — the decode "
               "path is not deterministic")
        _check(ra.topk_scores == rb.topk_scores,
               f"rid {rid}: top-k scores drifted across replays")
    _check(st_a.decode_steps == st_b.decode_steps,
           "decode steps differ across replays")
    replay_slot_log(engine._sched.admissions, engine._sched.releases,
                    [], n_slots, rejects=engine._sched.rejects)
    mb = engine.modeled_bytes
    return {
        "config": rcfg.name, "d": rcfg.d, "m": rcfg.m, "k": rcfg.k,
        "impl": rcfg.resolved_impl(device), "device": str(device),
        "n_requests": n_requests, "n_slots": n_slots,
        "decode_steps": st_a.decode_steps,
        "utilization": round(st_a.utilization, 4),
        "min_bytes": mb["min_bytes"],
        "tpu_grid_modeled_bytes": mb["streaming_bytes"],
        "dense_oracle_bytes": mb["dense_oracle_bytes"],
        "wall_s": round(st_a.wall_s, 3),
        "wall_s_replay": round(st_b.wall_s, 3),
    }


def _smoke_eval(device, seed: int) -> Dict[str, float]:
    """Untrained-model ranking sanity at eval scale: with the tie-aware
    metrics a random tower must score << 1."""
    smoke = get_retrieval_config("smoke")
    load = RetrievalLoadSpec(n_requests=8, catalog=smoke.d,
                             c_max=smoke.c_max, rate=2.0, seed=seed)
    sparams = init_retrieval_params(smoke, device=device)
    sengine = RetrievalEngine(smoke, sparams, n_slots=4)
    sres, _ = sengine.run([r.fresh_copy() for r in retrieval_workload(load)])
    ev = evaluate_retrieval(smoke, sparams, list(sres.values()))
    _check(ev["n_evaluated"] > 0, "smoke eval evaluated nothing")
    _check(ev["rr"] < 0.1 and ev["map"] < 0.1,
           f"untrained tower ranks suspiciously well (rr={ev['rr']:.4f}, "
           f"map={ev['map']:.4f}) — tie handling regressed?")
    return ev


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="web10m",
                    help="retrieval config preset (default: web10m — the "
                         "d >= 10M acceptance scale)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--out", default=None, help="write the report JSON")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    rcfg = get_retrieval_config(args.config)
    report = _drill(rcfg, args.requests, args.slots, args.seed, device)
    ev = _smoke_eval(device, args.seed)
    report["eval_smoke"] = {k: round(v, 6) if isinstance(v, float) else v
                            for k, v in ev.items()}
    report["verified"] = True

    print(json.dumps(report, indent=1, sort_keys=True))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
    print(f"retrieval: verified ({rcfg.name}: d={rcfg.d}, "
          f"{report['decode_steps']} decode steps on {device}, "
          f"{report['impl']} decode)")


if __name__ == "__main__":
    main()
