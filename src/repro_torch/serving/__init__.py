"""Continuous-batching serving: the retrieval path.

control.py      — control plane: pure replicated state machine, the shared
                  EventLog + replay helper (copied from the JAX package)
failpoints.py   — seeded deterministic fault injection (FailPlan)
admission.py    — overload policy: sheds and the degrade ladder
scheduler.py    — RequestQueue/Scheduler (slot admission policy)
loadgen.py      — deterministic workloads, incl. the Zipf retrieval stream
engine.py       — SlotProgram protocol, PrefillPool, run_slot_loop
retrieval.py    — web-scale one-shot Bloom retrieval over the slot pool
"""
from repro_torch.serving.admission import (AdmissionPolicy, compute_sheds,
                                           plan_stage, stage_topk)
from repro_torch.serving.engine import (PrefillFault, PrefillPool,
                                        PrefillWorker, SlotProgram,
                                        mean_latency, run_slot_loop)
from repro_torch.serving.failpoints import FailPlan
from repro_torch.serving.loadgen import (RetrievalLoadSpec,
                                         assert_fresh_instances,
                                         retrieval_workload)
from repro_torch.serving.retrieval import (RetrievalEngine, RetrievalProgram,
                                           evaluate_retrieval,
                                           init_retrieval_params)
from repro_torch.serving.scheduler import Request, Scheduler, ServeStats

__all__ = ["AdmissionPolicy", "compute_sheds", "plan_stage", "stage_topk",
           "PrefillFault", "PrefillPool", "PrefillWorker", "SlotProgram",
           "mean_latency", "run_slot_loop", "FailPlan", "RetrievalLoadSpec",
           "assert_fresh_instances", "retrieval_workload",
           "RetrievalEngine", "RetrievalProgram", "evaluate_retrieval",
           "init_retrieval_params", "Request", "Scheduler", "ServeStats"]
