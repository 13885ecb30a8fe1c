"""Learning-rate schedule and optimizer, equal to the JAX package's optax chain.

Port of `featurematching_tpu/train/optimizer.py`. The learning rate follows
the canonical rule true_lr = canonical_lr * global_batch_size / canonical_bs,
with a linear or constant warmup in front of a multistep, cosine or
exponential decay; update t (counting from 0) uses the rate at t, as optax's
schedules are read at the update count.

The update is clip-by-global-norm (gradient_clipping, 0.5 by default) and
then AdamW or Adam:
  * the clip is written out, because optax scales by max_norm / norm only
    where norm >= max_norm, while `torch.nn.utils.clip_grad_norm_` divides
    by norm + 1e-6 wherever norm > max_norm;
  * optax.adamw and torch.optim.AdamW are the same update: bias-corrected
    moments m̂ / (sqrt(v̂) + eps) with eps outside the root (optax's eps_root
    is 0), and decoupled decay lr * wd * p subtracted beside it (optax adds
    wd * p to the Adam direction before scaling by -lr; torch multiplies p by
    1 - lr * wd first, the same sum);
  * 'adam' adds adam_decay * p to the gradient before the moments, which
    torch.optim.Adam's weight_decay does too.
Both run fused (one kernel over all the parameters, the same update), and
the clip scales every gradient in one `_foreach_mul_`.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch

from featurematching_tpu_torch.config import OptimizerConfig

Schedule = Callable[[int], float]


def build_lr_schedule(cfg: OptimizerConfig, global_batch_size: int,
                      steps_per_epoch: int) -> Schedule:
    true_lr = cfg.canonical_lr * global_batch_size / cfg.canonical_bs
    if cfg.scheduler == "multistep":
        bounds = sorted(int(m * steps_per_epoch) for m in cfg.mslr_milestones)

        def decay(step):
            return true_lr * cfg.mslr_gamma ** sum(step >= b for b in bounds)
    elif cfg.scheduler == "cosine":
        T = cfg.cosa_tmax * steps_per_epoch

        def decay(step):
            return true_lr * 0.5 * (1.0 + math.cos(math.pi * min(step, T) / T))
    elif cfg.scheduler == "exponential":
        def decay(step):
            return true_lr * cfg.elr_gamma**step
    else:
        raise ValueError(f"unknown scheduler {cfg.scheduler!r}")
    if cfg.warmup_steps <= 0:
        return decay
    base = cfg.warmup_ratio * true_lr
    if cfg.warmup_type == "constant":
        return lambda step: base if step < cfg.warmup_steps else decay(step)

    def linear(step):
        if step >= cfg.warmup_steps:
            return decay(step)
        return base + min(step / cfg.warmup_steps, 1.0) * (true_lr - base)

    return linear


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every entry, in f32 (optax.global_norm)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


class Optimizer:
    """Clip-by-global-norm, then AdamW or Adam at the scheduled rate.

    `step()` reads each parameter's `.grad`, clips in place, updates, and
    returns the global norm of the gradients before the clip."""

    def __init__(self, params: Iterable[torch.nn.Parameter], cfg: OptimizerConfig,
                 global_batch_size: int, steps_per_epoch: int):
        self.params = list(params)
        self.schedule = build_lr_schedule(cfg, global_batch_size, steps_per_epoch)
        self.max_norm = cfg.gradient_clipping
        if cfg.name == "adamw":
            self.opt = torch.optim.AdamW(self.params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                         weight_decay=cfg.adamw_decay, fused=True)
        elif cfg.name == "adam":
            self.opt = torch.optim.Adam(self.params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                        weight_decay=cfg.adam_decay, fused=True)
        else:
            raise ValueError(f"unknown optimizer {cfg.name!r}")
        self.count = 0  # updates applied so far

    def step(self) -> torch.Tensor:
        grads = [p.grad for p in self.params]
        norm = global_norm(grads)
        if self.max_norm and self.max_norm > 0:
            # optax: t unchanged where norm < max_norm, else t / norm * max_norm
            factor = torch.where(norm < self.max_norm, torch.ones_like(norm),
                                 self.max_norm / norm)
            torch._foreach_mul_(grads, factor)
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(self.count)
        self.opt.step()
        self.count += 1
        return norm


def build_optimizer(params: Iterable[torch.nn.Parameter], cfg: OptimizerConfig,
                    global_batch_size: int, steps_per_epoch: int) -> Optimizer:
    return Optimizer(params, cfg, global_batch_size, steps_per_epoch)
