"""Optimizers and the per-step learning-rate schedule.

Port of ``pmce_tpu/core/optim.py`` (the reference's
``funcs_utils.py:77-108``): adam / sgd / rmsprop and a MultiStepLR-style
epoch schedule, applied per optimizer step: at step k (0-based) the rate
is ``lr × factor^n`` with n the number of milestones m for which
k ≥ m × steps_per_epoch — optax's ``piecewise_constant_schedule`` as the
JAX package builds it. Call ``scheduler.step()`` after every
``optimizer.step()``.
"""

from __future__ import annotations

import torch

from pmce_tpu_torch.core.config import TrainConfig


def multistep_schedule(base_lr: float, milestones: list[int], factor: float,
                       steps_per_epoch: int):
    """Learning rate at step k: ``base_lr × factor^#{m : k ≥ m·spe}``."""
    bounds = sorted(int(m) * steps_per_epoch for m in milestones)

    def lr(step: int) -> float:
        return base_lr * factor ** sum(step >= b for b in bounds)

    return lr


def build_optimizer(cfg: TrainConfig, steps_per_epoch: int, params):
    """(optimizer, scheduler) over ``params`` for ``cfg``.

    adam: torch Adam with optax's defaults (β 0.9/0.999, eps 1e-8 outside
    the root); sgd: momentum 0.9, Nesterov; rmsprop: decay 0.9, eps 1e-8
    (torch adds eps outside the root, optax inside: the two differ only
    where the mean squared gradient is below ~1e-8)."""
    if cfg.scheduler == "step":
        schedule = multistep_schedule(cfg.lr, cfg.lr_step, cfg.lr_factor,
                                      max(1, steps_per_epoch))
    else:
        schedule = lambda step: cfg.lr  # noqa: E731
    params = list(params)
    if cfg.optimizer == "adam":
        opt = torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999),
                               eps=1e-8)
    elif cfg.optimizer == "sgd":
        opt = torch.optim.SGD(params, lr=cfg.lr, momentum=0.9, nesterov=True)
    elif cfg.optimizer == "rmsprop":
        opt = torch.optim.RMSprop(params, lr=cfg.lr, alpha=0.9, eps=1e-8)
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: schedule(step) / cfg.lr)
    return opt, scheduler
