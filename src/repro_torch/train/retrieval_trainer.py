"""Train the retrieval FF tower on the Zipf stream, then serve and evaluate
it (the JAX package's ``train/retrieval_trainer.py``, DESIGN.md §12).

The pure-in-``(seed, host)`` Zipf(1) stream the serving loadgen draws
from is the training distribution: each request's ``c_max`` history
items are the input set, its ``n_targets`` held-out items the target.
The tower is trained with the paper's Bloom multilabel cross-entropy
(``models/recommender.recommender_loss`` over a ``BloomIO`` whose input
AND output spec are the serving spec), through the fault-tolerant
``train.trainer.Trainer`` (checkpoint/resume, ``train_fault@S``).

Spec discipline: serving Bloom-encodes a request with ``rcfg.spec()``
(``launch/steps.make_retrieval_prefill_step``) and recovers items through
the SAME spec (``make_retrieval_decode_step``), so training must too.
``BloomIO.build`` would derive a ``seed + 1`` output spec and train a
tower whose served rankings decode through the wrong hashes, so
``make_retrieval_emb`` builds the BloomIO with ``spec_in = spec_out =
rcfg.spec()``.

Evaluation goes THROUGH the serving stack: a fresh eval-seed workload is
served by ``RetrievalEngine`` with the trained tower (the slot pool and,
on a GPU, the decode-top-k kernel), then ranked with the tie-aware
MAP/RR/accuracy of ``serving/retrieval.evaluate_retrieval``.
``compression_sweep`` repeats train + serve + eval at m/d in {1/1, 1/2,
1/5, 1/10}, the paper's Fig. 2 trade-off at serving scale
(``repro_torch.benchmarks.bench_retrieval`` checks it).  Everything runs
on ``device``: CUDA unless the caller asks for the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.configs.retrieval import RetrievalConfig
from repro_torch.core import bloom as bloom_lib
from repro_torch.core.alternatives import BloomIO
from repro_torch.data.pipeline import BatchIterator
from repro_torch.kernels.common import resolve_device
from repro_torch.serving.loadgen import RetrievalLoadSpec, retrieval_workload
from repro_torch.serving.retrieval import (RetrievalEngine, evaluate_retrieval,
                                           init_retrieval_params)
from repro_torch.train.trainer import Trainer

# the sweep the paper's headline claim lives on: accuracy holds to ~1/5
# compression (ratio = d/m)
SWEEP_RATIOS = (1, 2, 5, 10)


def make_retrieval_emb(rcfg: RetrievalConfig) -> BloomIO:
    """The serving-consistent BloomIO: ONE spec (``rcfg.spec()``) for
    input encode, training loss and Eq. 3 decode (see module doc)."""
    spec = rcfg.spec()
    return BloomIO(name="BE", d=rcfg.d, m_in=rcfg.m, m_out=rcfg.m,
                   spec_in=spec, spec_out=spec)


def make_retrieval_dataset(rcfg: RetrievalConfig, n_pairs: int,
                           seed: int = 0, n_targets: int = 2,
                           host: int = 0, n_hosts: int = 1
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """(history, held-out) training pairs from the generator the serving
    workload draws from (``loadgen.retrieval_workload``).  Returns
    -1-padded int32 arrays: prompts (n_pairs, c_max) and targets
    (n_pairs, n_targets)."""
    load = RetrievalLoadSpec(n_requests=n_pairs, catalog=rcfg.d,
                             c_max=rcfg.c_max, n_targets=n_targets,
                             rate=2.0, seed=seed)
    wl = retrieval_workload(load, host=host, n_hosts=n_hosts)
    prompts = np.full((n_pairs, rcfg.c_max), -1, np.int32)
    targets = np.full((n_pairs, n_targets), -1, np.int32)
    for i, r in enumerate(wl):
        prompts[i, :r.prompt_len] = np.asarray(r.prompt, np.int32)
        targets[i, :len(r.targets)] = np.asarray(r.targets, np.int32)
    return prompts, targets


def make_retrieval_loss(rcfg: RetrievalConfig):
    """loss_fn(tower, batch) -> (scalar, metrics) for the Trainer.

    batch = {"p": (B, c_max), "q": (B, n_targets)} -1-padded ints.  The
    loss is ``recommender_loss``'s (encode, tower, Bloom multilabel CE,
    batch mean), computed here once so that its logits also give the
    metric ``target_mass``: the mean softmax mass the tower puts on the
    target set's Bloom bits, which carries no gradient.  It is a
    per-example mean, so the grad-accumulation path averages it across
    microbatches."""
    emb = make_retrieval_emb(rcfg)
    spec = rcfg.spec()

    def loss_fn(tower, batch):
        p, q = batch["p"], batch["q"]
        logits = tower(emb.encode_input(p))
        loss = emb.loss(logits, q).mean()
        with torch.no_grad():
            code = (bloom_lib.encode(spec, q) > 0).float()
            probs = torch.softmax(logits.float(), dim=-1)
            mass = (probs * code).sum(-1).mean()
        return loss, {"target_mass": mass}

    return loss_fn


def default_train_config(steps: int = 300, microbatch: int = 0,
                         checkpoint_every: int = 0,
                         learning_rate: float = 3e-2) -> TrainConfig:
    return TrainConfig(optimizer="adamw", learning_rate=learning_rate,
                       grad_clip_norm=1.0, steps=steps, warmup_steps=10,
                       checkpoint_every=checkpoint_every,
                       microbatch=microbatch)


def train_retrieval(rcfg: RetrievalConfig, tc: TrainConfig, *,
                    n_pairs: int = 512, batch_size: int = 64,
                    n_targets: int = 2, data_seed: int = 0,
                    checkpoint_dir: Optional[str] = None,
                    failpoints=None, log_every: int = 10, device=None):
    """Train the tower from ``init_retrieval_params(rcfg)`` on ``device``;
    returns (tower, run_result).

    Checkpoint/resume via ``checkpoint_dir`` and chaos via ``failpoints``
    (``train_fault@S`` raises at step S; rerunning the same call resumes
    from the last checkpoint)."""
    device = resolve_device(device)
    prompts, targets = make_retrieval_dataset(
        rcfg, n_pairs, seed=data_seed, n_targets=n_targets)
    it = BatchIterator([prompts, targets], batch_size, seed=data_seed)

    def make_batch(arrays):
        p, q = arrays
        return {"p": torch.from_numpy(p).to(device),
                "q": torch.from_numpy(q).to(device)}

    trainer = Trainer(make_retrieval_loss(rcfg),
                      init_retrieval_params(rcfg, device=device), tc, it,
                      checkpoint_dir=checkpoint_dir,
                      make_batch=make_batch, failpoints=failpoints)
    result = trainer.run(log_every=log_every)
    return trainer.state.params, result


def serve_and_eval(rcfg: RetrievalConfig, params, *,
                   n_requests: int = 64, n_slots: int = 8,
                   eval_seed: int = 1) -> Dict[str, float]:
    """Serve a fresh eval-seed Zipf workload with ``RetrievalEngine`` on
    the tower's device, then rank the served requests with the tie-aware
    metrics (fresh users, same popularity law).  ``map_int8`` re-ranks the
    same requests through int8 fake-quantized logp rows (DESIGN.md §13):
    the values an int8 decode ranks through."""
    load = RetrievalLoadSpec(n_requests=n_requests, catalog=rcfg.d,
                             c_max=rcfg.c_max, rate=2.0, seed=eval_seed)
    wl = [r.fresh_copy() for r in retrieval_workload(load)]
    engine = RetrievalEngine(rcfg, params, n_slots=n_slots)
    results, stats = engine.run(wl)
    served = list(results.values())
    ev = evaluate_retrieval(rcfg, params, served)
    ev["map_int8"] = evaluate_retrieval(rcfg, params, served,
                                        table_dtype="int8")["map"]
    ev["decode_steps"] = stats.decode_steps
    return ev


def train_and_eval_point(rcfg: RetrievalConfig, tc: TrainConfig, *,
                         n_pairs: int = 512, batch_size: int = 64,
                         n_eval: int = 64, n_slots: int = 8,
                         data_seed: int = 0, eval_seed: int = 1,
                         checkpoint_dir: Optional[str] = None,
                         failpoints=None, device=None) -> Dict[str, object]:
    """One sweep point: train, then serve + eval BOTH the trained and the
    untrained (init) tower on the identical eval workload."""
    device = resolve_device(device)
    params, result = train_retrieval(
        rcfg, tc, n_pairs=n_pairs, batch_size=batch_size,
        data_seed=data_seed, checkpoint_dir=checkpoint_dir,
        failpoints=failpoints, device=device)
    trained = serve_and_eval(rcfg, params, n_requests=n_eval,
                             n_slots=n_slots, eval_seed=eval_seed)
    untrained = serve_and_eval(rcfg,
                               init_retrieval_params(rcfg, device=device),
                               n_requests=n_eval, n_slots=n_slots,
                               eval_seed=eval_seed)
    final_loss = (result["history"][-1]["loss"]
                  if result["history"] else float("nan"))
    return {
        "config": rcfg.name, "d": rcfg.d, "m": rcfg.m, "k": rcfg.k,
        "ratio": round(rcfg.d / rcfg.m, 2), "steps": result["steps"],
        "n_train_pairs": n_pairs, "n_eval_requests": n_eval,
        "n_evaluated": trained["n_evaluated"],
        "decode_steps": trained["decode_steps"],
        "final_loss": float(final_loss),
        "map": trained["map"], "rr": trained["rr"],
        "accuracy": trained["accuracy"],
        "untrained_map": untrained["map"], "untrained_rr": untrained["rr"],
        # quantized-store retention: the trained tower's MAP ranked through
        # int8 fake-quantized logits, relative to the f32 MAP
        "map_int8": trained["map_int8"],
        "int8_retention": round(
            trained["map_int8"] / max(trained["map"], 1e-12), 6),
    }


def compression_sweep(base: RetrievalConfig, tc: TrainConfig, *,
                      ratios=SWEEP_RATIOS, n_pairs: int = 512,
                      batch_size: int = 64, n_eval: int = 64,
                      n_slots: int = 8, data_seed: int = 0,
                      eval_seed: int = 1, device=None
                      ) -> List[Dict[str, object]]:
    """Train + serve + eval at m = d/ratio for each ratio; everything else
    (catalog, hash count, tower widths, seeds) is held fixed."""
    rows = []
    for ratio in ratios:
        rcfg = dataclasses.replace(base, m=base.d // ratio,
                                   name=f"{base.name}_r{ratio}")
        rows.append(train_and_eval_point(
            rcfg, tc, n_pairs=n_pairs, batch_size=batch_size,
            n_eval=n_eval, n_slots=n_slots, data_seed=data_seed,
            eval_seed=eval_seed, device=device))
    return rows


def assert_trained_margin(rows: List[Dict[str, object]],
                          min_ratio_at_5: float = 3.0) -> None:
    """The acceptance gate: the trained tower beats the untrained one by
    ``min_ratio_at_5``x MAP at 1/5 compression, and strictly at every
    point.  On fresh values only: float MAPs are never exact-matched
    against a committed file."""
    for row in rows:
        assert row["map"] > row["untrained_map"], (
            f"{row['config']}: trained MAP {row['map']:.4f} <= untrained "
            f"{row['untrained_map']:.4f} — training is not helping")
    at5 = [r for r in rows if abs(r["ratio"] - 5.0) < 1e-6]
    assert at5, "sweep has no 1/5-compression point to gate on"
    r = at5[0]
    floor = min_ratio_at_5 * max(r["untrained_map"], 1e-12)
    assert r["map"] >= floor, (
        f"{r['config']}: trained MAP {r['map']:.4f} < {min_ratio_at_5}x "
        f"untrained {r['untrained_map']:.4f} at 1/5 compression — the "
        "paper's headline margin does not hold")
