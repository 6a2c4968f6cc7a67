"""The paper's own 7 experimental setups (Sec. 4.2, Tables 1 & 2) as
configs over the synthetic generators (``data/synthetic.py``).

Copied from the JAX package's ``configs/paper_tasks.py``: the same
fields and values.  Statistics (d, median c, architecture, optimizer,
measure) follow the paper; n is scaled down so each task trains in
seconds while keeping density c/d and the latent co-occurrence structure
in range.  ``benchmarks/common.py`` runs them.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.configs.base import TrainConfig


@dataclasses.dataclass(frozen=True)
class PaperTask:
    name: str
    kind: str                  # recsys | classify | session
    d: int                     # item/vocab dimensionality
    n: int                     # instances (scaled from the paper)
    mean_items: int            # median nonzero components c (Table 1)
    arch_hidden: Tuple[int, ...]
    cell: str = ""             # gru | lstm for sequence tasks
    measure: str = "map"       # map | rr | acc
    optimizer: str = "adam"
    learning_rate: float = 1e-3
    momentum: float = 0.0
    grad_clip: float = 0.0
    epochs: int = 12
    batch: int = 128
    n_classes: int = 0

    def train_config(self, steps: int) -> TrainConfig:
        return TrainConfig(
            learning_rate=self.learning_rate,
            optimizer=self.optimizer,
            momentum=self.momentum,
            grad_clip_norm=self.grad_clip,
            steps=steps,
            warmup_steps=0,
            checkpoint_every=0,
        )


# paper Table 2: architecture + optimizer per task.
PAPER_TASKS = {
    # ML: 3-layer FF + Adam, MAP; d=15,405 c=18 (densest: c/d 1.2e-3)
    "ML": PaperTask("ML", "recsys", d=1600, n=4000, mean_items=18,
                    arch_hidden=(150, 150), measure="map"),
    # MSD: 3-layer FF + Adam, MAP; c=5
    "MSD": PaperTask("MSD", "recsys", d=2400, n=5000, mean_items=5,
                     arch_hidden=(300, 300), measure="map"),
    # AMZ: 4-layer FF + Adam, MAP; c=1-2
    "AMZ": PaperTask("AMZ", "recsys", d=2000, n=5000, mean_items=3,
                     arch_hidden=(300, 300, 300), measure="map"),
    # BC: like MSD with 250 units; c=2
    "BC": PaperTask("BC", "recsys", d=2400, n=2500, mean_items=3,
                    arch_hidden=(250, 250), measure="map"),
    # YC: GRU(100) + Adagrad lr=0.01, RR
    "YC": PaperTask("YC", "session", d=2000, n=5000, mean_items=6,
                    arch_hidden=(100,), cell="gru", measure="rr",
                    optimizer="adagrad", learning_rate=0.01),
    # PTB: LSTM(250) + SGD lr=0.25 momentum=0.99 clip=1, RR
    "PTB": PaperTask("PTB", "session", d=2000, n=6000, mean_items=10,
                     arch_hidden=(250,), cell="lstm", measure="rr",
                     optimizer="sgd", learning_rate=0.25, momentum=0.99,
                     grad_clip=1.0),
    # CADE: 4-layer FF(400,200,100)+RMSprop lr=2e-4, Acc, 12 classes,
    # input-embedding only
    "CADE": PaperTask("CADE", "classify", d=4000, n=3000, mean_items=17,
                      arch_hidden=(400, 200, 100), measure="acc",
                      optimizer="rmsprop", learning_rate=2e-4,
                      n_classes=12),
}
