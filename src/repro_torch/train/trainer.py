"""Training substrate: the optimizer a TrainConfig names.

Ported from the JAX package's ``train/trainer.py``: ``make_optimizer``.
The ``Trainer`` loop and ``TrainState`` wait for the recommender training
stack (ROADMAP A6); the LM trains through ``launch/train.py``.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import TrainConfig
from repro_torch.optim import optimizers as opt_lib


def make_optimizer(tc: TrainConfig, total_steps: Optional[int] = None):
    sched = (opt_lib.warmup_cosine(tc.learning_rate, tc.warmup_steps,
                                   total_steps or tc.steps)
             if tc.warmup_steps else tc.learning_rate)
    return opt_lib.make_optimizer(
        tc.optimizer, sched, b1=tc.beta1, b2=tc.beta2, eps=tc.eps,
        momentum=tc.momentum, weight_decay=tc.weight_decay,
        grad_clip_norm=tc.grad_clip_norm, compression=tc.grad_compression)
