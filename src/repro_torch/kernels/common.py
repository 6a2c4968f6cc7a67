"""Shared plumbing for the port's Hopper kernels.

* Device and implementation resolution.  ``resolve_device`` is the rule of
  every entry point: CUDA unless the caller asks for the CPU, and a raise
  (never a quiet CPU run) when CUDA was asked for and there is none.
  ``resolve_impl`` is the counterpart of the JAX package's
  ``resolve_interpret``: a tensor on a CUDA device goes to the hand-written
  kernel, a tensor on the CPU to the kernel's plain PyTorch version.
* Building and loading the kernels in ``csrc/``.  Each ``csrc/<name>.cu`` is
  compiled by ``nvcc`` for ``sm_90a`` into its own shared library with a
  plain C interface, named by a hash of the sources and flags, under
  ``build/kernels/`` at the repository root, at first use; ``load_library``
  opens it with ``ctypes``.  Nothing is built or loaded at import time.
* Host arithmetic shared by the kernels that hash on the card
  (csrc/bloom_hash.cuh): ``magic_divisor`` (remainders by multiply-shift)
  and ``hash_constants`` (a spec's salts and remainder constants); and
  ``sm_count``, the card's SM count for the launch plans.
* Launch counts: each kernel wrapper adds one to ``LAUNCHES[name]`` where it
  launches its kernel, and nowhere else, so a run can show which kernels
  its main path went through.
* The dry run's meter: ``resolve_impl`` sends ``meta`` tensors (the dry
  run's stand-ins, launch/dryrun.py) to the plain version, for its shapes;
  each dispatcher calls that version through ``run_plain``, which, while
  the dry run counts a step (``METER`` set), counts the call as its
  kernel's least traffic (the kernel module's ``min_bytes``) and not by
  the plain version's own ops, which the card never runs.
* The backward knob: ``resolve_bwd_impl`` validates ``bwd_impl`` ("csr",
  the CSR scatter-add, or "dense", the m-tile sweep), and ``onehot_count``
  is the one-hot count the JAX package's dense backwards contract with,
  kept here as a plain torch function for the oracles.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

from repro_torch.core.hashing import double_hash_salts

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: Dict[str, int] = {}

# the dry run's counter while it counts a step (launch/dryrun.py), else None
METER = None

BWD_IMPLS = ("dense", "csr")


def count_launch(name: str) -> None:
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def reset_launches() -> None:
    LAUNCHES.clear()


def resolve_device(device=None) -> torch.device:
    """None -> ``cuda``.  Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The number of SMs of a CUDA device (132 on an H100 SXM)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def resolve_impl(*tensors: torch.Tensor) -> str:
    """``"kernel"`` when every tensor lies on one CUDA device, ``"plain"``
    when every tensor lies on the CPU or on ``meta`` (the dry run's
    shapes); anything else raises."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"tensors must share one device, got {devices}")
    dev = devices.pop()
    if dev.type == "cuda":
        return "kernel"
    if dev.type in ("cpu", "meta"):
        return "plain"
    raise ValueError(f"unsupported device {dev}")


def run_plain(name, min_bytes, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``: the plain version of the kernel ``name``
    (its launch-count name, or a callable giving it).  While the dry run
    counts a step (``METER`` set) the call counts as that kernel moving
    ``min_bytes()`` bytes (a callable: the kernel's least traffic at
    these shapes), not by ``fn``'s own ops; both callables are called
    after ``fn``, which checks its arguments first."""
    if METER is None:
        return fn(*args, **kwargs)
    return METER.kernel(name, min_bytes, fn, args, kwargs)


def resolve_bwd_impl(bwd_impl: str) -> str:
    """Validate a differentiable entry's ``bwd_impl``: "dense" or "csr"."""
    if bwd_impl not in BWD_IMPLS:
        raise ValueError(f"bwd_impl must be 'dense' or 'csr', "
                         f"got {bwd_impl!r}")
    return bwd_impl


def onehot_count(ids: torch.Tensor, n: int, base: int = 0) -> torch.Tensor:
    """counts[r, c] = #{j : ids[r, j] == base + c} as float32, (rows, n).
    Out-of-range ids (the -1 pad) never match."""
    cols = torch.arange(base, base + n, device=ids.device)
    return (ids.long()[:, :, None] == cols).sum(1).to(torch.float32)


def magic_divisor(d: int) -> tuple[int, int]:
    """Constants (mp, sh) for ``n % d`` over every uint32 n by a multiply
    and shifts (Granlund & Montgomery 1994, Fig. 4.1, the round-up
    method): with l = ceil(log2 d), mp = floor(2^32 (2^l - d) / d) + 1,
    t = umulhi(n, mp), q = (t + ((n - t) >> sh1)) >> sh2 is n // d, where
    sh1 = min(l, 1), sh2 = max(l - 1, 0); ``sh`` packs sh1 | sh2 << 8 as
    ``fastmod`` of csrc/bloom_hash.cuh reads it."""
    if not 1 <= d < 2 ** 32:
        raise ValueError(f"need 1 <= d < 2**32, got {d}")
    l_ = (d - 1).bit_length()
    mp = (2 ** 32 * (2 ** l_ - d)) // d + 1
    return mp, min(l_, 1) | max(l_ - 1, 0) << 8


@functools.lru_cache(maxsize=64)
def hash_constants(m: int, seed: int) -> tuple:
    """(c1, c2, mp_m, sh_m, mp_m1, sh_m1): what csrc/bloom_hash.cuh needs to
    hash like ``core.hashing.double_hash(ids, k, m, seed)``: the salts, and
    the remainder constants of m and of max(m - 1, 1)."""
    return (*double_hash_salts(seed), *magic_divisor(m),
            *magic_divisor(max(m - 1, 1)))


# --------------------------------------------------------------------------
# building and loading csrc/*.cu
# --------------------------------------------------------------------------

def kernel_names() -> list:
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def library_path(name: str, defines: tuple = ()) -> Path:
    """Build output of ``csrc/<name>.cu``, keyed on its source, the shared
    headers in csrc/, the flags and the ``-D`` defines, so an edit always
    rebuilds."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(defines)).encode())
    for src in [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def build(names: Iterable[str] | None = None,
          defines: tuple = ()) -> Dict[str, float]:
    """Compile every named kernel not yet built, one ``nvcc`` per source,
    all started together, with the extra ``-D`` flags ``defines``.
    Returns seconds per kernel built (0.0 for one already built); raises
    with the compiler's output when one fails.  The compiler's report
    (``-Xptxas -v``: registers, shared memory, spills) is kept beside each
    library as ``<library>.log``."""
    names = kernel_names() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, times = {}, {}
    for name in names:
        out = library_path(name, defines)
        if out.exists():
            times[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *defines, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        out.with_suffix(".so.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return times


@functools.lru_cache(maxsize=None)
def load_library(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """``csrc/<name>.cu`` as a loaded library, built first if needed."""
    build([name], defines)
    return ctypes.CDLL(str(library_path(name, defines)))


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of one ``fn()`` on the current CUDA stream, timed
    with CUDA events after ``warmup`` untimed calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(fn, calls: int = 50, replays: int = 20) -> float:
    """Mean device milliseconds of one ``fn()`` without the host's launch
    cost: ``calls`` calls captured in one CUDA graph, replayed
    ``replays`` times between CUDA events.  For calls so short that the
    host, not the card, sets the pace of back-to-back launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def cold_ms(fn, calls: int = 10, replays: int = 5) -> float:
    """Mean device milliseconds of one ``fn()`` with the 50 MB L2 cold: a
    CUDA graph of a 96 MB write (twice the L2) and the call, ``calls``
    times, less a graph of the write alone."""
    flush = torch.empty(24 * 2 ** 20, dtype=torch.float32, device="cuda")
    both = graph_time_ms(lambda: (flush.fill_(1.0), fn()), calls, replays)
    return both - graph_time_ms(lambda: flush.fill_(1.0), calls, replays)
