"""Time the decode-topk kernel's two tuning constants on a GPU.

    PYTHONPATH=src python -m repro_torch.kernels.sweep_decode_topk

Builds ``csrc/bloom_decode_topk.cu`` with ``BLOOM_DECODE_TOPK_UNROLL`` (H
loads a pass-1 thread keeps in flight) defined as 1, 2, 4, 8 and 16, one
build each under ``build/kernels/``.  For each build and each
catalog group count G it times the kernel at web10m shapes (B = 8,
m = 8192, d = 10M, k = 2, topk = 10) with every row live and with rows
0, 3, 7 live, with CUDA events, and checks it bit-identical to the plain
version.  Also times topk = 1, 10, 64 with the shipped kernel and prints
its compiler report (registers, spills).  Prints one line per setting and
the card's name and power limit.  Needs a CUDA device.
"""
from __future__ import annotations

import subprocess

import torch

from repro_torch.configs.retrieval import get_retrieval_config
from repro_torch.core.bloom import cached_hash_matrix
from repro_torch.kernels import bloom_decode_topk as dt
from repro_torch.kernels import common

UNROLLS = (1, 2, 4, 8, 16)
GROUPS = (33, 66, 132, 264, 528)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("sweep_decode_topk: needs a CUDA device")
    dev = torch.device("cuda")
    rcfg = get_retrieval_config("web10m")
    gen = torch.Generator().manual_seed(0)
    logp = torch.log_softmax(torch.randn(8, rcfg.m, generator=gen), -1)
    logp = logp.to(dev)
    H = cached_hash_matrix(rcfg.spec(), dev)
    (B, m), (d, k), topk = logp.shape, H.shape, rcfg.topk
    partial = torch.zeros(B, dtype=torch.int32, device=dev)
    partial[[0, 3, 7]] = 1
    want = {live: dt.bloom_decode_topk_plain(logp, H, topk, act)
            for live, act in (("all", None), ("0,3,7", partial))}
    vals = torch.empty((B, topk), device=dev)
    ids = torch.empty((B, topk), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for u in UNROLLS:
        lib = dt._library((f"-DBLOOM_DECODE_TOPK_UNROLL={u}",))
        for G in GROUPS:
            part_v = torch.empty((G, B, topk), device=dev)
            part_i = torch.empty((G, B, topk), dtype=torch.int32, device=dev)
            line = []
            for live, act in (("all", None), ("0,3,7", partial)):
                def run():
                    err = lib.bloom_decode_topk_f32(
                        logp.data_ptr(), H.data_ptr(),
                        None if act is None else act.data_ptr(),
                        part_v.data_ptr(), part_i.data_ptr(),
                        vals.data_ptr(), ids.data_ptr(), B, m, d, k, topk,
                        G, stream)
                    if err:
                        raise RuntimeError(f"launch failed: CUDA error {err}")

                ms = common.time_ms(run, 30, 3)
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
