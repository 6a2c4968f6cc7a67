"""Continuous-batching serving: the token-LM engine, its sharded pool, and
the retrieval path.

control.py       — control plane: pure replicated state machine, the
                   shared EventLog + replay helper, and the transports
                   (SimTransport, CollectiveTransport) with per-round
                   digest checks and deadlines
failpoints.py    — seeded deterministic fault injection (FailPlan)
collective.py    — the device gather behind CollectiveTransport
admission.py     — overload policy: sheds and the degrade ladder
scheduler.py     — RequestQueue/Scheduler (slot admission policy),
                   ShardedScheduler (transported multi-host admission) and
                   run_schedule, the one loop of the sharded engine and
                   the model-free simulation
loadgen.py       — deterministic workloads: per-host streams, the overload
                   ramp, the Zipf retrieval stream
engine.py        — SlotProgram protocol, PrefillPool, run_slot_loop, Engine
sharded_pool.py  — data plane: the data-axis-sharded slot pool,
                   ShardedEngine, slot compaction
retrieval.py     — web-scale one-shot Bloom retrieval over the slot pool
"""
from repro_torch.serving.admission import (AdmissionPolicy, compute_sheds,
                                           plan_stage, slo_attainment,
                                           stage_topk)
from repro_torch.serving.control import (CollectiveTransport,
                                         ReplicaDivergence, SimTransport,
                                         Transport, TransportTimeout,
                                         replay_slot_log)
from repro_torch.serving.engine import (Engine, PrefillFault, PrefillPool,
                                        PrefillWorker, SlotProgram,
                                        mean_latency, run_slot_loop)
from repro_torch.serving.failpoints import FailPlan, PREFILL_MAX_ATTEMPTS
from repro_torch.serving.loadgen import (LoadSpec, RetrievalLoadSpec,
                                         assert_fresh_instances, host_stream,
                                         merge_workloads, overload_workload,
                                         retrieval_workload, sharded_workload)
from repro_torch.serving.retrieval import (RetrievalEngine, RetrievalProgram,
                                           evaluate_retrieval,
                                           init_retrieval_params)
from repro_torch.serving.scheduler import (Request, Scheduler, ServeStats,
                                           ShardedScheduler, run_schedule,
                                           simulate_sharded_schedule)
from repro_torch.serving.sharded_pool import ShardedEngine

__all__ = ["AdmissionPolicy", "compute_sheds", "plan_stage",
           "slo_attainment", "stage_topk", "CollectiveTransport",
           "ReplicaDivergence", "SimTransport", "Transport",
           "TransportTimeout", "replay_slot_log", "Engine", "PrefillFault",
           "PrefillPool", "PrefillWorker", "SlotProgram", "mean_latency",
           "run_slot_loop", "FailPlan", "PREFILL_MAX_ATTEMPTS", "LoadSpec",
           "RetrievalLoadSpec",
           "assert_fresh_instances", "host_stream", "merge_workloads",
           "overload_workload", "retrieval_workload", "sharded_workload",
           "RetrievalEngine", "RetrievalProgram", "evaluate_retrieval",
           "init_retrieval_params", "Request", "Scheduler", "ServeStats",
           "ShardedScheduler", "run_schedule", "simulate_sharded_schedule",
           "ShardedEngine"]
