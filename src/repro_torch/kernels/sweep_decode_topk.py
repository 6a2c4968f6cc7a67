"""Time the decode-topk kernel's tuning constants on a GPU.

    PYTHONPATH=src python -m repro_torch.kernels.sweep_decode_topk \
        [--lm | --profile | --cases]

The constants: ``BLOOM_DECODE_TOPK_IDS`` (ids a lane scores per step, a
``-D`` of the build: 2, 4 and 8, one build each under ``build/kernels/``),
and the launch plan's rows per tile R (1, 2, 4, 8, as far as they fit),
warps per block (8, 16), blocks per call (a half, one and two per SM) and,
for narrow logp, the staged width (stored, or widened to f32).
At web10m shapes (B = 8, m = 8192, d = 10M, k = 2, topk = 10), f32 and
int8 logp with the explicit H, and int8 and bf16 logp with the in-kernel
hash, every row live and rows 0, 3, 7 live.  With ``--lm`` the same at the
LM serving shapes (qwen1.5-0.5b's vocab: m = 30,208, d = 151,936, k = 4,
topk = 8; B = 1, and B = 8 with every row and rows 0, 3, 7 live), shipped
build.  Each setting is checked bit-identical to the plain
version and
timed on the device alone (CUDA graph replays), three interleaved rounds,
beside the wrapper's own plan.  With ``--profile`` the kernel is built with
section timers (``-DBLOOM_DECODE_TOPK_PROFILE``: ``clock64()`` read by
thread 0 after a block-wide barrier at each phase boundary) and one call
per case (web10m and LM B = 8, f32 with H and int8 with the hash) prints the
mean cycles of each phase over the blocks that ran, beside the shipped
build's device time and its CUDA kernels' times by ``torch.profiler``.
With ``--cases`` it times every decode-top-k case of PERF.md §6 through
the public wrapper alone, so that it can time another checkout's kernel in
the same process layout (see ``cases``).  Prints one line per setting, the
compiler's register and spill report, and the card's name and power limit.
Needs a CUDA device.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from repro_torch.configs.retrieval import get_retrieval_config
from repro_torch.core import quant
from repro_torch.core.bloom import cached_hash_matrix
from repro_torch.kernels import bloom_decode_topk as dt
from repro_torch.kernels import common

IDS = (2, 4, 8)
ROWS = (1, 2, 4, 8)
WARPS = (8, 16)
BLOCKS_PER_SM = (0.5, 1, 2)
PROFILE_DEFINE = ("-DBLOOM_DECODE_TOPK_PROFILE",)


def _lm_spec():
    from repro_torch import configs
    from repro_torch.models import io as io_lib
    return io_lib.vocab_spec(configs.get_config("qwen1.5-0.5b"))


def _cases(dev, lm: bool):
    """(label, logp, H, topk, active, scales, hash_spec) of the sweep."""
    gen = torch.Generator().manual_seed(0)
    if lm:
        spec, topk = _lm_spec(), 8
        lives = ((0, 1, 2, 3, 4, 5, 6, 7), (0, 3, 7))
    else:
        spec, topk = get_retrieval_config("web10m").spec(), 10
        lives = ((0, 1, 2, 3, 4, 5, 6, 7), (0, 3, 7))
    logp = torch.log_softmax(torch.randn(8, spec.m, generator=gen), -1)
    logp = logp.to(dev)
    H = cached_hash_matrix(spec, dev)
    q, s = quant.quantize_table(logp, "int8")
    b16, _ = quant.quantize_table(logp, "bfloat16")
    hs = (spec.d, spec.k, spec.seed)
    store = [("f32 H", logp, H, None, None), ("int8 hash", q, None, s, hs),
             ("bf16 hash", b16, None, None, hs), ("int8 H", q, H, s, None)]
    cases = []
    for name, lp, h, sc, spec_arg in store:
        if lm:
            cases.append((f"{name} B=1", lp[:1].contiguous(), h, topk, None,
                          None if sc is None else sc[:1].contiguous(),
                          spec_arg))
        for rows in lives:
            act = None
            if len(rows) < 8:
                act = torch.zeros(8, dtype=torch.int32, device=dev)
                act[list(rows)] = 1
            cases.append((f"{name} B=8 {len(rows)} live", lp, h, topk, act,
                          sc, spec_arg))
    return cases


def _check(got, want, what: str) -> None:
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError(f"{what}: kernel != plain version")


def sweep(lm: bool, rounds: int = 3) -> None:
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    variants = {"ids 4": ()}
    if not lm:
        variants.update({f"ids {u}": (f"-DBLOOM_DECODE_TOPK_IDS={u}",)
                         for u in IDS if u != 4})
    _build_parallel(list(variants.values()))
    builds = {v: dt._library(d) for v, d in variants.items()}
    for label, lp, h, topk, act, sc, hs in _cases(dev, lm):
        B, m = lp.shape
        want = dt.bloom_decode_topk_plain(lp, h, topk, act, sc, hs)
        d = h.shape[0] if h is not None else hs[0]
        shipped = dt._plan_for(dev, B, m, lp.element_size(), topk, d,
                               dt.PLAN_ROWS, None if h is None else False)
        plans = {}
        widths = (False, True) if lp.element_size() < 4 else (False,)
        for r in ROWS:
            for w in WARPS:
                for bps in BLOCKS_PER_SM:
                    for wide in widths:
                        pl = dt.plan(B, m, lp.element_size(), topk, n_sm,
                                     max_rows=r, warps=w,
                                     grid=int(bps * n_sm), widen=wide)
                        if (pl.rows, pl.warps, pl.widen) == (r, w, wide):
                            width = "f32" if wide else "stored"
                            plans[(r, w, bps, width)] = pl
        times = {(u, key): [] for u in builds for key in plans}
        for _ in range(rounds):
            for u, lib in builds.items():
                for key, pl in plans.items():
                    def fn():
                        return dt._launch(lib, lp, h, topk, act, sc, hs, pl)
                    _check(fn(), want, f"{label} ids {u} plan {key}")
                    times[(u, key)].append(common.graph_time_ms(fn, 20, 5))
        best = min(times, key=lambda t: min(times[t]))
        print(f"sweep: {label} m={m} (wrapper plan R={shipped.rows} "
              f"warps={shipped.warps} grid={shipped.grid} staged "
              f"{'f32' if shipped.widen else 'stored'}, ids 4), device ms "
              f"per call over {rounds} rounds (build/R/warps/blocks per SM/"
              f"staged width): "
              + ", ".join(f"{u}/{'/'.join(str(x) for x in k)} "
                          + "/".join(f"{t:.6f}" for t in ts)
                          for (u, k), ts in times.items())
              + f"; fastest {best[0]}/{'/'.join(str(x) for x in best[1])}"
              " (all bit-identical)", flush=True)


def _build_parallel(defines) -> None:
    """Build the kernel once per ``-D`` set (and the shipped build), all
    nvcc processes at once."""
    from concurrent.futures import ThreadPoolExecutor
    sets = [(), *[d for d in defines if d]]
    with ThreadPoolExecutor(len(sets)) as pool:
        list(pool.map(lambda d: common.build([dt.NAME], d), sets))


def profile() -> None:
    """Where a call's time goes, by section timers and ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    dev = torch.device("cuda")
    _build_parallel([PROFILE_DEFINE])
    plib = dt._library(PROFILE_DEFINE)
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn, args, res in (
            (plib.bloom_decode_topk_profile_names, [], ctypes.c_char_p),
            (plib.bloom_decode_topk_profile_slots, [], i),
            (plib.bloom_decode_topk_clock_khz, [], i),
            (plib.bloom_decode_topk_profile_reset, [], i),
            (plib.bloom_decode_topk_profile, [p, i], i),
            (plib.bloom_decode_topk_profile_scan, [p, p, i], i)):
        fn.argtypes, fn.restype = args, res
    names = plib.bloom_decode_topk_profile_names().decode().split(",")
    slots = plib.bloom_decode_topk_profile_slots()
    khz = plib.bloom_decode_topk_clock_khz()
    lib = dt._library()
    web = get_retrieval_config("web10m").spec()
    gen = torch.Generator().manual_seed(0)
    for name, spec, topk in (("web10m", web, 10), ("LM", _lm_spec(), 8)):
        logp = torch.log_softmax(torch.randn(8, spec.m, generator=gen), -1)
        logp = logp.to(dev)
        q, s = quant.quantize_table(logp, "int8")
        for label, lp, H, sc, hs in (
                (f"{name} B=8 f32 with H", logp,
                 cached_hash_matrix(spec, dev), None, None),
                (f"{name} B=8 int8.hash", q, None, s,
                 (spec.d, spec.k, spec.seed))):
            for _ in range(3):
                dt._launch(plib, lp, H, topk, None, sc, hs)
            torch.cuda.synchronize()
            _rc(plib.bloom_decode_topk_profile_reset())
            dt._launch(plib, lp, H, topk, None, sc, hs)
            torch.cuda.synchronize()
            buf = (ctypes.c_longlong * (4096 * slots))()
            _rc(plib.bloom_decode_topk_profile(buf, 4096))
            t = torch.tensor(list(buf), dtype=torch.float64)
            t = t.view(4096, slots)
            t = t[(t[:, 0] > 0) & (t[:, -1] > 0)]
            phase = (t[:, 1:] - t[:, :-1]).mean(0)
            phase_max = (t[:, 1:] - t[:, :-1]).max(0).values
            total = t[:, -1] - t[:, 0]
            n = t.shape[0]
            sbuf = (ctypes.c_longlong * (n * 6))()
            cbuf = (ctypes.c_int * n)()
            _rc(plib.bloom_decode_topk_profile_scan(sbuf, cbuf, n))
            scan = torch.tensor(list(sbuf), dtype=torch.float64).view(n, 6)
            comp = list(cbuf)[:4]
            print(f"profile: {label}: warp 0 mean over blocks: scoring "
                  f"{scan[:, 0].mean():.0f}, offering "
                  f"{scan[:, 1].mean():.0f}, refreshing "
                  f"{scan[:, 2].mean():.0f} cycles; slow paths "
                  f"{scan[:, 3].mean():.1f}, (u, r) hits "
                  f"{scan[:, 4].mean():.1f}, steps {scan[:, 5].mean():.1f}; "
                  f"compactions of blocks 0-3 {comp}", flush=True)

            def fn():
                return dt._launch(lib, lp, H, topk, None, sc, hs)
            _check(fn(), dt.bloom_decode_topk_plain(lp, H, topk, None, sc,
                                                     hs), label)
            dev_ms = common.graph_time_ms(fn)
            with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    fn()
                torch.cuda.synchronize()
            kern = {}
            for ev in prof.key_averages():
                us = (getattr(ev, "device_time_total", None)
                      or getattr(ev, "cuda_time_total", 0.0))
                if us > 0:
                    kern[ev.key.split("(")[0]] = us / 20
            print(f"profile: {label}: {t.shape[0]} blocks, per block mean "
                  + ", ".join(f"{n} {c:.0f} (max {x:.0f})"
                              for n, c, x in zip(names, phase, phase_max))
                  + f" cycles, block total mean {total.mean():.0f} max "
                  f"{total.max():.0f} cycles ({khz / 1e3:.0f} MHz nominal: "
                  f"{total.mean() / khz * 1e3:.3f} us mean); device ms "
                  f"{dev_ms:.6f} (graph, shipped build); per kernel "
                  "(torch.profiler, us a call): "
                  + ", ".join(f"{k} {v:.3f}" for k, v in sorted(kern.items())),
                  flush=True)


def cases() -> None:
    """Every decode-top-k case of PERF.md §6 through the public wrapper
    only (``bloom_decode_topk_cuda``), so the same file times another
    checkout's kernel: ``PYTHONPATH=<checkout>/src python
    <this file> --cases``.  web10m B = 8 and the LM shapes at B = 1 and 8
    (seeded logp), f32 with H, int8 with H and the four storages with the
    in-kernel hash, every row live, and f32 with H with rows 0, 3, 7 live;
    each on the device alone (CUDA graph replays) and back to back (CUDA
    events)."""
    dev = torch.device("cuda")
    web = get_retrieval_config("web10m").spec()
    gen = torch.Generator().manual_seed(0)
    for name, spec, topk, Bs in (("web10m", web, 10, (8,)),
                                 ("LM", _lm_spec(), 8, (1, 8))):
        H = cached_hash_matrix(spec, dev)
        hs = (spec.d, spec.k, spec.seed)
        logp8 = torch.log_softmax(torch.randn(8, spec.m, generator=gen), -1)
        logp8 = logp8.to(dev)
        partial = torch.zeros(8, dtype=torch.bool, device=dev)
        partial[[0, 3, 7]] = True
        for B in Bs:
            logp = logp8[:B].contiguous()
            runs = [("f32 H", logp, H, None, None, None)]
            if B == 8:
                runs.append(("f32 H rows 0,3,7", logp, H, partial, None,
                             None))
            q, sc = quant.quantize_table(logp, "int8")
            runs.append(("int8 H", q, H, None, sc, None))
            for td in quant.TABLE_DTYPES:
                q, sc = quant.quantize_table(logp, td)
                runs.append((f"{td} hash", q, None, None, sc, hs))
            for label, lp, h, act, sc, spec_arg in runs:
                def fn():
                    return dt.bloom_decode_topk_cuda(lp, h, topk, act, sc,
                                                     spec_arg)
                _check(fn(), dt.bloom_decode_topk_plain(lp, h, topk, act, sc,
                                                         spec_arg), label)
                print(f"cases: {name} B={B} {label}: device "
                      f"{common.graph_time_ms(fn, 20, 10):.6f} ms (graph), "
                      f"back to back {common.time_ms(fn, 50, 5):.6f} ms "
                      "(events), bit-identical", flush=True)


def _rc(rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA error {rc}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("sweep_decode_topk: needs a CUDA device")
    if "--cases" in sys.argv[1:]:
        cases()
    else:
        if "--profile" in sys.argv[1:]:
            profile()
        else:
            sweep("--lm" in sys.argv[1:])
        log = common.library_path(dt.NAME).with_suffix(".so.log")
        for ln in log.read_text().splitlines():
            if "Compiling entry" in ln or "registers" in ln or "spill" in ln:
                print("ptxas:", ln.strip())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
