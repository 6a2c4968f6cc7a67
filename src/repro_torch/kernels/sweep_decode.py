"""Profile the Eq. 3 decode forward and sweep its launch plan on a GPU.

    PYTHONPATH=src python -m repro_torch.kernels.sweep_decode

At the LM shapes (qwen1.5-0.5b's vocabulary: m = 30,208, d = 151,936,
k = 4), B = 1 and 8, for f32, bf16, int8 and fp8 logp, reading the spec's
H packed to 16 bits as ``ops.bloom_decode`` passes it:

* the kernel built with per-block timers (``-DBLOOM_DECODE_PROFILE``:
  ``%globaltimer`` read by thread 0 at the block's start, after staging
  its row tile, and at its end after a barrier): the blocks' mean and
  largest staging time and the time by which the last block ends,
  counted from the first block's start, over one call;
* the shipped build's device time (CUDA graph replays) at the plan's ids
  per block ``MIN_IDS`` and at 1,024 to 16,384, each setting checked
  bit-identical to the plain version;
* at the plan's setting, the shipped build against the build that stages
  its row tile with bulk copies (``-DBLOOM_DECODE_BULK``: cp.async.bulk of
  the rows as stored, no transpose), checked bit-identical too, device
  times in turns: shipped, bulk, bulk, shipped.

Prints one line per case and the card's name and power limit.  Needs a
CUDA device."""
from __future__ import annotations

import ctypes
import subprocess

import numpy as np
import torch

from repro_torch.core import bloom, quant
from repro_torch.kernels import bloom_decode as bd
from repro_torch.kernels import common

PROFILE_DEFINE = ("-DBLOOM_DECODE_PROFILE",)
BULK_DEFINE = ("-DBLOOM_DECODE_BULK",)
MIN_IDS = (1024, 2048, 4096, 8192, 16384)


def _equal_nan(a, b) -> bool:
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


def main() -> None:
    from repro_torch import configs
    from repro_torch.models import io as io_lib
    if not torch.cuda.is_available():
        raise SystemExit("sweep_decode: needs a CUDA device")
    dev = torch.device("cuda")
    spec = io_lib.vocab_spec(configs.get_config("qwen1.5-0.5b"))
    m, d, k = spec.m, spec.d, spec.k
    H = bloom.cached_hash_matrix(spec, dev)
    H16 = bloom.cached_packed_hash_matrix(spec, dev)
    n_sm = common.sm_count(dev)
    libs = {}
    for name, defines in (("shipped", ()), ("timers", PROFILE_DEFINE),
                          ("bulk", BULK_DEFINE)):
        lib = common.load_library(bd.NAME, defines)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bloom_decode_fwd.argtypes = [p, i, p, p, p] + [i] * 7 + [p]
        libs[name] = lib
    libs["timers"].bloom_decode_profile.argtypes = [ctypes.c_void_p,
                                                    ctypes.c_int]
    gen = torch.Generator().manual_seed(0)
    logp = torch.log_softmax(3 * torch.randn(8, m, generator=gen), -1)
    logp = logp.to(dev)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    for td in (None, "bfloat16", "int8", "fp8_e4m3"):
        for B in (1, 8):
            q, s = ((logp[:B], None) if td is None
                    else quant.quantize_table(logp[:B].contiguous(), td))
            want = bd.bloom_decode_plain(q, H, s)
            out = torch.empty(B, d, device=dev)

            def call(lib, pl):
                return lib.bloom_decode_fwd(
                    q.data_ptr(), bd._CODES[q.dtype],
                    None if s is None else s.data_ptr(), H16.data_ptr(),
                    out.data_ptr(), B, m, d, k, pl.tiles, pl.chunk, pl.grid,
                    stream())

            times = {}
            for mi in MIN_IDS:
                pl = bd.plan(B, m, d, k, q.element_size(), n_sm, mi)
                out.zero_()
                call(libs["shipped"], pl)
                torch.cuda.synchronize()
                assert _equal_nan(out, want), (td, B, mi)
                times[mi] = common.graph_time_ms(
                    lambda: call(libs["shipped"], pl), 20, 10)
            pl = bd.plan(B, m, d, k, q.element_size(), n_sm)
            out.zero_()
            call(libs["bulk"], pl)
            torch.cuda.synchronize()
            assert _equal_nan(out, want), (td, B, "bulk")
            turns = {"shipped": [], "bulk": []}
            for name in ("shipped", "bulk", "bulk", "shipped"):
                turns[name].append(common.graph_time_ms(
                    lambda: call(libs[name], pl), 20, 10))
            call(libs["timers"], pl)
            call(libs["timers"], pl)
            torch.cuda.synchronize()
            assert _equal_nan(out, want), (td, B, "timers")
            n = min(pl.grid, 4096)
            t = np.zeros((n, 3), np.int64)
            libs["timers"].bloom_decode_profile(t.ctypes.data, n)
            stage = (t[:, 1] - t[:, 0]) / 1e3
            end = (t[:, 2].max() - t[:, 0].min()) / 1e3
            print(f"{bd.variant_name(q.dtype)} B={B} m={m} d={d} k={k}, "
                  f"{pl}: staging mean {stage.mean():.3f} us, largest "
                  f"{stage.max():.3f} us; the last block ends "
                  f"{end:.3f} us after the first starts (timers build); "
                  f"device ms (graph) by ids per block: "
                  + ", ".join(f"{mi} {ms:.6f}" for mi, ms in times.items())
                  + "; staging by 16-byte loads / by bulk copies, device ms "
                  "(graph, in turns): "
                  + " / ".join(", ".join(f"{ms:.6f}" for ms in turns[name])
                               for name in ("shipped", "bulk")),
                  flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
