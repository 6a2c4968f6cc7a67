"""End to end: train a ~100M-parameter Bloom-IO LM for a few
hundred steps on a synthetic Zipf token stream.

The model is a qwen-style decoder (12L, d_model=768, GQA 12/4) with the
paper's technique at the IO boundary: vocab 50,304 compressed to
m = 9,984 (m/d ~= 0.2, aligned to 256; k=4).  Checkpoint/resume, LR
schedule, grad clipping: the full production train loop
(``repro_torch.launch.train.run``) at laptop scale, on ``--device``.

The twin of ``examples/train_lm_100m.py``, with the reference's config
whole (64-wide attention chunks, no remat).  The loss is logged every
10 steps, or every step when fewer are run.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm_100m \\
          [--steps 300] [--ckpt DIR] [--device cpu]
"""
import argparse
import dataclasses
import os
import tempfile

from repro_torch import configs
from repro_torch.configs.base import BloomConfig, ModelConfig
from repro_torch.launch import train as train_lm

ARCH = "bloom-lm-100m"


def config_100m() -> ModelConfig:
    return ModelConfig(
        name=ARCH,
        family="dense",
        num_layers=12,
        d_model=768,
        num_heads=12,
        num_kv_heads=4,
        head_dim=64,
        d_ff=2048,
        vocab=50_304,
        dtype="float32",
        attn_chunk_q=64,
        attn_chunk_k=64,
        remat="none",
        bloom=BloomConfig(enabled=True, m_ratio=0.2, k=4),
    )


class _Arch:
    """A registry entry for ``launch.train.run``: the config at every
    size."""
    ARCH = ARCH

    @staticmethod
    def config(bloom: bool = True) -> ModelConfig:
        return config_100m()

    @staticmethod
    def smoke() -> ModelConfig:
        return config_100m()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "ckpt_bloom_lm_100m"))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    cfg = config_100m()
    dense = dataclasses.replace(cfg, bloom=BloomConfig(enabled=False))
    print(f"model: {cfg.param_count() / 1e6:.0f}M params "
          f"(dense-IO equivalent: {dense.param_count() / 1e6:.0f}M) "
          f"m_vocab={cfg.m_vocab} of vocab={cfg.vocab}")

    # launch.train.run looks the arch up in the registry: add ours for the run
    configs.ARCH_MODULES[ARCH] = _Arch
    try:
        model, history = train_lm.run(
            ARCH, steps=args.steps, batch=args.batch, seq=args.seq,
            ckpt_dir=args.ckpt, log_every=10 if args.steps >= 10 else 1,
            learning_rate=6e-4, device=args.device)
    finally:
        del configs.ARCH_MODULES[ARCH]
    if history:
        print(f"loss: {history[0]['loss']:.3f} -> "
              f"{history[-1]['loss']:.3f} over {args.steps} steps")
    return model, history


if __name__ == "__main__":
    main()
