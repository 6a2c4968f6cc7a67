"""Quickstart: Bloom embeddings in 60 seconds.

1. Bloom-encode sparse item sets (paper Eq. 1),
2. train a tiny recommender entirely in the compressed m-space,
3. recover a ranking over the original d items (paper Eq. 3).

The twin of ``examples/quickstart.py``.  On CUDA the ranking and the
top-k recovery go through the hand-written Eq. 3 kernels.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse

import torch

from repro_torch.benchmarks.common import bench_step
from repro_torch.core import BloomSpec, encode
from repro_torch.core.alternatives import BloomIO
from repro_torch.data.pipeline import BatchIterator
from repro_torch.data.synthetic import make_recsys
from repro_torch.kernels import ops
from repro_torch.kernels.common import resolve_device
from repro_torch.models import recommender as rec
from repro_torch.optim import optimizers as opt
from repro_torch.train import metrics as M


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # --- 1. the embedding itself ---------------------------------------
    d, m, k = 5000, 1000, 4            # 5x compression (m/d = 0.2)
    spec = BloomSpec(d=d, m=m, k=k)
    items = torch.tensor([[17, 423, 4999, -1]], device=device)  # padded set
    u = encode(spec, items)
    print(f"encoded {int((items >= 0).sum())} items -> {int(u.sum())} of "
          f"{m} bits set (k={k} hashes/item)")

    # --- 2. train a recommender in m-space --------------------------------
    data = make_recsys(n=2000, d=d, mean_items=8, seed=0)
    emb = BloomIO.build(d=d, m=m, k=k, device=device)
    model = rec.recommender_init(emb, [128, 128],
                                 generator=torch.Generator().manual_seed(0),
                                 device=device)
    tx = opt.make_optimizer("adam", 2e-3)
    state = tx.init(dict(model.named_parameters()))
    step = bench_step(model, tx,
                      lambda mdl, b: rec.recommender_loss(mdl, emb, *b))
    it = BatchIterator(list(data.train()), 64, seed=0)
    for _ in range(150):
        state = step(state, tuple(torch.as_tensor(a, device=device)
                                  for a in next(it)))

    # --- 3. recover rankings over the ORIGINAL items ----------------------
    p_te, q_te = data.test()
    with torch.no_grad():
        scores = rec.recommender_scores(
            model, emb, torch.as_tensor(p_te, device=device)).cpu().numpy()
    score = M.mean_average_precision(scores, q_te, p_te)
    print(f"test MAP = {score:.4f} (random ~{1 / d:.5f}) with a "
          f"{m}/{d} = {m / d:.0%} sized model")

    # direct Eq. 3 top-k recovery from a probability vector:
    logp = torch.log_softmax(torch.randn(
        1, m, generator=torch.Generator().manual_seed(1)), -1).to(device)
    _, ids = ops.bloom_decode_topk(logp, spec, 5)
    print("top-5 recovered item ids from an m-dim softmax:",
          ids[0].tolist())
    return score, ids[0].tolist()


if __name__ == "__main__":
    main()
