"""Batched serving example: prefill + autoregressive decode with the
paper's Eq. 3 vocabulary recovery at every step.

The twin of ``examples/serve_bloom_lm.py``: the whole-batch path
(``repro_torch.launch.serve.run``) at the arch's reduced smoke config, on
``--device``; on CUDA every step embeds through the Bloom embedding
kernel and recovers the next token through the decode-top-k kernel.  The
port serves the dense archs (``repro_torch.configs.ARCH_NAMES``).

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_bloom_lm \\
          --arch qwen3-4b [--device cpu]
"""
import argparse

from repro_torch import configs
from repro_torch.launch.serve import run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-4b",
                    choices=list(configs.ARCH_NAMES))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=12)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    return run(args.arch, batch=args.batch, prompt_len=args.prompt_len,
               gen=args.gen, device=args.device)


if __name__ == "__main__":
    main()
