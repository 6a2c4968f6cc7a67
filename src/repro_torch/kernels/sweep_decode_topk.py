"""Time the decode-topk kernel's two tuning constants on a GPU.

    PYTHONPATH=src python -m repro_torch.kernels.sweep_decode_topk [--lm]

Builds ``csrc/bloom_decode_topk.cu`` with ``BLOOM_DECODE_TOPK_UNROLL`` (H
loads a pass-1 thread keeps in flight) defined as 1, 2, 4, 8 and 16, one
build each under ``build/kernels/``.  For each build and each
catalog group count G it times the kernel at web10m shapes (B = 8,
m = 8192, d = 10M, k = 2, topk = 10) with every row live and with rows
0, 3, 7 live, with CUDA events, and checks it bit-identical to the plain
version.  Also times topk = 1, 10, 64 with the shipped kernel and prints
its compiler report (registers, spills).  With ``--lm`` it sweeps only G,
with the shipped build, at the LM serving shapes (qwen1.5-0.5b's vocab:
B = 1, and B = 8 with 8, 4, 3 and 1 rows live; m = 30,208, d = 151,936,
k = 4, topk = 8; k = 4 takes the kernel's generic load branch, so the
unroll does not apply there), on the device alone (CUDA graph replays),
three interleaved rounds each, and prints the wrapper's own choice
beside it.  Prints one line per setting
and the card's name and power limit.  Needs a CUDA device.
"""
from __future__ import annotations

import subprocess
import sys

import torch

from repro_torch.configs.retrieval import get_retrieval_config
from repro_torch.core.bloom import cached_hash_matrix
from repro_torch.kernels import bloom_decode_topk as dt
from repro_torch.kernels import common

UNROLLS = (1, 2, 4, 8, 16)
GROUPS = (33, 66, 132, 264, 528)
LM_GROUPS = (8, 16, 24, 33, 48, 66, 132, 264, 528)


def sweep_lm(rounds: int = 3) -> None:
    """G at the LM serving shapes, shipped build: B = 1, and B = 8 with
    every row live and with 4, 3 and 1 rows live (a continuous pool is
    often part full).  Each setting is timed ``rounds`` times on the
    device alone (CUDA graph replays: at these shapes a call is about as
    short as the host's launch cost), the rounds interleaved, to show the
    spread."""
    from repro_torch import configs
    from repro_torch.models import io as io_lib
    dev = torch.device("cuda")
    spec = io_lib.vocab_spec(configs.get_config("qwen1.5-0.5b"))
    H = cached_hash_matrix(spec, dev)
    lib = dt._library()
    gen = torch.Generator().manual_seed(1)
    topk = 8
    logp8 = torch.log_softmax(torch.randn(8, spec.m, generator=gen), -1)
    logp8 = logp8.to(dev)
    cases = [("B=1", logp8[:1].contiguous(), None)]
    for rows in ((0, 1, 2, 3, 4, 5, 6, 7), (0, 2, 4, 6), (0, 3, 7), (5,)):
        act = torch.zeros(8, dtype=torch.int32, device=dev)
        act[list(rows)] = 1
        cases.append((f"B=8 {len(rows)} live", logp8,
                      None if len(rows) == 8 else act))
    for label, logp, act in cases:
        B = logp.shape[0]
        want = dt.bloom_decode_topk_plain(logp, H, topk, act)
        times = {G: [] for G in LM_GROUPS}
        for _ in range(rounds):
            for G in LM_GROUPS:
                got = dt._launch(lib, logp, H, topk, act, G)
                if not (torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1])):
                    raise AssertionError(f"LM {label} groups {G} disagrees")
                times[G].append(common.graph_time_ms(
                    lambda: dt._launch(lib, logp, H, topk, act, G)))
        pick = dt._groups(dev, B, spec.d, spec.m)
        print(f"sweep: LM {label} m={spec.m} d={spec.d} k={spec.k} "
              f"topk={topk} (wrapper picks G={pick}), device ms per call "
              f"over {rounds} rounds: "
              + ", ".join(f"G {G} " + "/".join(f"{t:.6f}" for t in ts)
                          for G, ts in times.items())
              + " (bit-identical)", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("sweep_decode_topk: needs a CUDA device")
    if "--lm" in sys.argv[1:]:
        sweep_lm()
        _print_card()
        return
    dev = torch.device("cuda")
    rcfg = get_retrieval_config("web10m")
    gen = torch.Generator().manual_seed(0)
    logp = torch.log_softmax(torch.randn(8, rcfg.m, generator=gen), -1)
    logp = logp.to(dev)
    H = cached_hash_matrix(rcfg.spec(), dev)
    topk = rcfg.topk
    partial = torch.zeros(logp.shape[0], dtype=torch.int32, device=dev)
    partial[[0, 3, 7]] = 1
    want = {live: dt.bloom_decode_topk_plain(logp, H, topk, act)
            for live, act in (("all", None), ("0,3,7", partial))}
    for u in UNROLLS:
        lib = dt._library((f"-DBLOOM_DECODE_TOPK_UNROLL={u}",))
        for G in GROUPS:
            line = []
            for live, act in (("all", None), ("0,3,7", partial)):
                def run():
                    return dt._launch(lib, logp, H, topk, act, G)
                ms = common.time_ms(run, 30, 3)
                vals, ids = run()
                if not (torch.equal(vals, want[live][0])
                        and torch.equal(ids, want[live][1])):
                    raise AssertionError(
                        f"unroll {u} groups {G} rows {live} disagrees")
                line.append(f"rows {live} {ms:.6f} ms")
            print(f"sweep: unroll {u} groups {G}: " + ", ".join(line)
                  + " (bit-identical)", flush=True)
    for t in (1, 10, 64):
        ms = common.time_ms(lambda: dt.bloom_decode_topk_cuda(logp, H, t),
                            30, 3)
        print(f"sweep: shipped kernel topk {t}: {ms:.6f} ms", flush=True)
    log = common.library_path(dt.NAME).with_suffix(".so.log").read_text()
    for ln in log.splitlines():
        if "Compiling entry" in ln or "registers" in ln or "spill" in ln:
            print("ptxas:", ln.strip())
    _print_card()


def _print_card() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
