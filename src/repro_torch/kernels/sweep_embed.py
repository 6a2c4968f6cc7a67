"""Time the Bloom embed forward with and without programmatic dependent
launch on a GPU.

    PYTHONPATH=src python -m repro_torch.kernels.sweep_embed

At qwen1.5-0.5b's vocabulary spec (m = 30,208, d = 151,936, k = 4, the
on-the-fly double hash) over a bf16 table of D = 1,024 columns, at T = 8
and 520 tokens: the token entry of the shipped build and of the build
with ``-DBLOOM_EMBED_PDL`` (programmatic dependent launch, see
``csrc/bloom_embed.cu``), each checked bit-identical to the plain
version.  Device times per call from CUDA graphs (``common.graph_time_ms``)
of:

* the embed alone, so each call follows an embed;
* a PyTorch add on a (T, D) bf16 tensor and then the embed, as on the
  model's path, where PyTorch kernels run before the embedding;
* the add alone,

in turns: shipped, PDL, PDL, shipped.  Prints one line per case and the
card's name and power limit.  Needs a CUDA device."""
from __future__ import annotations

import subprocess

import torch

from repro_torch.kernels import bloom_embed as be
from repro_torch.kernels import common

PDL_DEFINE = ("-DBLOOM_EMBED_PDL",)


def main() -> None:
    from repro_torch import configs
    from repro_torch.models import io as io_lib
    if not torch.cuda.is_available():
        raise SystemExit("sweep_embed: needs a CUDA device")
    dev = torch.device("cuda")
    spec = io_lib.vocab_spec(configs.get_config("qwen1.5-0.5b"))
    D = 1024
    name = be.token_variant_name(spec)
    builds = {"shipped": (), "PDL": PDL_DEFINE}
    gen = torch.Generator().manual_seed(0)
    table = torch.randn(spec.m, D, generator=gen).to(dev, torch.bfloat16)
    for T in (8, 520):
        tok = torch.randint(0, spec.d, (T,), generator=gen).to(dev)
        x = torch.zeros(T, D, dtype=torch.bfloat16, device=dev)
        want, _ = be.bloom_embed_tokens_plain(table, None, tok, spec,
                                              torch.bfloat16)

        def embed(build):
            return be._launch(table, None, tok, torch.bfloat16, name, spec,
                              defines=builds[build])[0]

        for build in builds:
            got = embed(build)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (T, build)
        times = {b: {"embed": [], "add + embed": []} for b in builds}
        for build in ("shipped", "PDL", "PDL", "shipped"):
            times[build]["embed"].append(common.graph_time_ms(
                lambda: embed(build), 50, 20))
            times[build]["add + embed"].append(common.graph_time_ms(
                lambda: (x.add_(1), embed(build)), 50, 20))
        add = common.graph_time_ms(lambda: x.add_(1), 50, 20)
        print(f"{name} bf16 -> bf16 T={T} m={spec.m} D={D} k={spec.k}: "
              f"device ms per call (graph, in turns shipped, PDL, PDL, "
              f"shipped): "
              + "; ".join(f"{build} {what} "
                          + ", ".join(f"{ms:.6f}" for ms in ms_list)
                          for build in builds
                          for what, ms_list in times[build].items())
              + f"; the add alone {add:.6f}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
