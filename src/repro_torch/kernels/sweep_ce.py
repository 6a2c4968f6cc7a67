"""Time the Bloom CE forward and backward kernels on a GPU: this tree's
build and, with ``--parent DIR``, another commit's ``csrc/bloom_ce.cu``
(copied into DIR), in turns.

    PYTHONPATH=src python -m repro_torch.kernels.sweep_ce [--parent DIR]

At the main path's shapes, T = 512 rows and k = 4 labels: qwen1.5-0.5b's
m = 30,208; whisper-small's m = 10,240; and the half range of a 2-way
vocab split, m = 15,104 of 30,208 at lo = 15,104 (the ranged entries).
Every build is checked before it is timed: the forward (loss and lse, or
the ranged lse and hit sum) within rtol 1e-6 / atol 1e-5 of the plain
version, dz within atol 1e-7 of it and bit-identical to this tree's
build's (and to the parent's), and at lo = 0 the ranged entries bit-
identical to the unranged ones.  The edge cases (k = 1, 2, 3, 4, 8, 40;
repeated labels; m not a multiple of 4; an unaligned row; -inf columns
and an all -inf row; a ranged call whose labels all fall outside the
shard) hold this tree's build against the plain version and, with
``--parent``, its dz against the parent's.

Times per call, in turns (a, b, ..., b, a, each run averaged): device ms
from CUDA graphs of 20 calls (``common.graph_time_ms``; the inputs stay
in the 50 MB L2 between calls where they fit), back-to-back ms from CUDA
events, and L2-cold device ms (``common.cold_ms``).  Beside them two
PyTorch yardsticks that move the same bytes (never called by the port):
``torch.amax(z, -1)`` for the forward's read and ``out.copy_(z)`` for
the backward's read and write.  Each line gives the bound (bytes over
3.35 TB/s) and the share of it by the L2-cold time; the last line is the
card's name and power limit.  Needs a CUDA device."""
from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import bloom_ce as ce
from repro_torch.kernels import common
from repro_torch.launch.roofline import HBM_BW

T, K = 512, 4
# (label, m of the logits' row, lo) at the main path's shapes
SHAPES = (("qwen1.5-0.5b", 30208, None), ("whisper-small", 10240, None),
          ("half range", 15104, 15104))


def start_parent(parent: Path):
    """nvcc on ``parent``/bloom_ce.cu with this tree's flags, started now;
    returns a function that waits for it and returns the library, bound
    (``bloom_ce.bind``)."""
    lib = parent / "bloom_ce.so"
    proc = subprocess.Popen([common._nvcc(), *common.NVCC_FLAGS, "-o",
                             str(lib), str(parent / "bloom_ce.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)

    def wait() -> ctypes.CDLL:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"parent bloom_ce build failed:\n{log}")
        return ce.bind(ctypes.CDLL(str(lib)))
    return wait


def turns(fns) -> dict:
    """{name: (graph ms, events ms, L2-cold ms)}, each measured in turns
    (a, b, ..., b, a) and the two runs averaged, after one untimed graph
    of each (the card's clocks up before the first is timed)."""
    for f in fns.values():
        common.graph_time_ms(f, 20, 5)
    runs = {n: [] for n in fns}
    for n in list(fns) + list(fns)[::-1]:
        f = fns[n]
        runs[n].append((common.graph_time_ms(f, 20, 5),
                        common.time_ms(f, 50, 3), common.cold_ms(f)))
    return {n: tuple((a[i] + b[i]) / 2 for i in range(3))
            for n, (a, b) in runs.items()}


def inputs(m_row: int, lo, gen, k: int = K, rows: int = T):
    """Seeded logits (rows, m_row), labels over the whole vocabulary
    (m_row + lo columns when ranged; two repeated columns), cotangent."""
    m_full = m_row + (lo or 0)
    z = (3.0 * torch.randn(rows, m_full, generator=gen))[:, lo or 0:]
    h = torch.randint(0, m_full, (rows, k), generator=gen, dtype=torch.int32)
    if k > 1:
        h[::2, 1] = h[::2, 0]
    g = torch.randn(rows, generator=gen)
    return z.contiguous().cuda(), h.cuda(), g.cuda()


def check(lib, z, h, g, lo, want_dz=None, what=""):
    """The forward vs the plain version, dz vs the plain version (atol
    1e-7) and vs ``want_dz`` (bit for bit); returns (fwd, lse, dz)."""
    if lo is None:
        loss, lse = ce.launch_fwd(lib, z, h)
        pl, plse = ce.bloom_ce_plain(z, h)
        got = loss
    else:
        lse, got = ce.launch_fwd(lib, z, h, lo)
        plse, pl = ce.bloom_ce_shard_plain(z, h, lo)
    dz = ce.launch_bwd(lib, g, z, h, plse, lo)
    torch.cuda.synchronize()
    fin = torch.isfinite(plse)
    assert torch.equal(torch.isfinite(lse), fin), what
    torch.testing.assert_close(lse[fin], plse[fin], rtol=1e-6, atol=1e-5,
                               msg=what)
    assert torch.equal(torch.isfinite(got), torch.isfinite(pl)), what
    f2 = torch.isfinite(pl)
    torch.testing.assert_close(got[f2], pl[f2], rtol=1e-6, atol=1e-5,
                               msg=what)
    pdz = ce.bloom_ce_bwd_plain(g, z, h, plse, lo)
    both = torch.isfinite(pdz)
    assert torch.equal(torch.isfinite(dz), both), what
    torch.testing.assert_close(dz[both], pdz[both], rtol=0, atol=1e-7,
                               msg=what)
    if want_dz is not None:
        assert torch.equal(dz.nan_to_num(), want_dz.nan_to_num()) and \
            torch.equal(dz.isnan(), want_dz.isnan()), \
            f"{what}: dz differs from the reference build's"
    return got, lse, dz


def edge_cases(lib, parent, gen) -> int:
    """This tree's build on the kernels' edge cases; returns the count."""
    n = 0
    for k in (1, 2, 3, 4, 8, 40):
        for m in (8, 37, 1000, 10240, 30211):
            for lo in (None, 0, 100):
                if lo == 100 and m < 200:
                    continue
                z, h, g = inputs(m, lo, gen, k=k, rows=7)
                if m >= 37:
                    z[1, 5:9] = -float("inf")
                    z[2] = -float("inf")
                if lo:
                    h[3] = torch.randint(0, lo, (k,), generator=gen)
                _, lse, _ = check(lib, z, h, g, lo, None,
                                  f"k={k} m={m} lo={lo}")
                if parent is not None:
                    a = ce.launch_bwd(lib, g, z, h, lse, lo)
                    b = ce.launch_bwd(parent, g, z, h, lse, lo)
                    assert torch.equal(a.nan_to_num(), b.nan_to_num()) and \
                        torch.equal(a.isnan(), b.isnan()), \
                        f"k={k} m={m} lo={lo}: dz != the parent's"
                n += 1
    # an unaligned row: the element-wise paths
    zu = torch.randn(6 * 64 + 1, device="cuda")[1:].view(6, 64)
    hu = torch.randint(0, 64, (6, 3), dtype=torch.int32, device="cuda")
    check(lib, zu, hu, torch.randn(6, device="cuda"), None, None,
          "unaligned")
    return n + 1


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None,
                    help="a directory holding another commit's bloom_ce.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sweep_ce: needs a CUDA device")
    wait = None if args.parent is None else start_parent(args.parent)
    mine = ce._library()
    parent = None if wait is None else wait()
    libs = {"this tree": mine}
    if parent is not None:
        libs = {"parent": parent, **libs}
    gen = torch.Generator().manual_seed(26)
    print(f"edge cases: {edge_cases(mine, parent, gen)} held to "
          "the plain version" + (", dz bit-identical to the parent's"
                                 if parent is not None else ""), flush=True)
    for label, m, lo in SHAPES:
        z, h, g = inputs(m, lo, gen)
        ref = check(mine, z, h, g, lo, None, label)
        for n, lib in libs.items():
            check(lib, z, h, g, lo, ref[2], f"{label} {n}")
        if lo is not None:    # lo = 0 over the whole row == unranged
            zf, hf, gf = inputs(m + lo, None, gen)
            loss, lse = ce.launch_fwd(mine, zf, hf)
            l0, hits0 = ce.launch_fwd(mine, zf, hf, 0)
            d = ce.launch_bwd(mine, gf, zf, hf, lse)
            d0 = ce.launch_bwd(mine, gf, zf, hf, lse, 0)
            torch.cuda.synchronize()
            assert torch.equal(l0, lse) and torch.equal(d0, d) and \
                torch.equal(lse - hits0 / K, loss), "lo = 0 != unranged"
        lse = (ce.bloom_ce_plain(z, h)[1] if lo is None
               else ce.bloom_ce_shard_plain(z, h, lo)[0])
        fwd = turns({n: (lambda lib=lib: ce.launch_fwd(lib, z, h, lo))
                     for n, lib in libs.items()})
        bwd = turns({n: (lambda lib=lib: ce.launch_bwd(lib, g, z, h, lse,
                                                       lo))
                     for n, lib in libs.items()})
        out = torch.empty_like(z)
        fwd.update(turns({"amax": lambda: torch.amax(z, -1)}))
        bwd.update(turns({"copy_": lambda: out.copy_(z)}))
        for what, times, nbytes in (
                ("forward", fwd, ce.min_bytes(T, m, K)),
                ("backward", bwd, ce.min_bytes(T, m, K, backward=True))):
            bound = nbytes / HBM_BW * 1e3
            print(f"{label} {what} T={T} m={m} k={K} lo={lo}: bound "
                  f"{bound:.6f} ms ({nbytes} bytes); graph / events / "
                  "L2-cold ms (share of bound by graph, by L2-cold): " +
                  "; ".join(f"{n} {a:.6f} / {b:.6f} / {c:.6f} "
                            f"({bound / a:.3f}, {bound / c:.3f})"
                            for n, (a, b, c) in times.items()), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
