"""Optimizer and LR-schedule factories over ``torch.optim``.

Counterpart of ``lifelong_clip_tpu/utils/train_utils.py`` (optax there).
Decay semantics as the reference's ``select_optimizer``
(``utils/train_utils.py:21-28``): AdamW decoupled with 1e-5; adam (0), radam
(1e-5) and sgd (1e-4) with coupled L2, which is what ``weight_decay`` means
for torch's Adam, RAdam and SGD. Schedules are ``LambdaLR`` multipliers of
the step count, the same functions of it as the optax schedules.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

_REF_WD = {"adam": 0.0, "adamw": 1e-5, "radam": 1e-5, "sgd": 1e-4}


def make_schedule(sched_name: str, *,
                  total_steps: int = 10_000) -> Callable[[int], float]:
    """LR multiplier as a function of the number of updates taken."""
    t = max(total_steps, 1)
    if sched_name in ("default", "const", "constant"):
        return lambda step: 1.0
    if sched_name == "exp":
        return lambda step: 0.9999 ** step
    if sched_name in ("cos", "coslr", "codacosine"):
        return lambda step: 0.5 * (1.0 + math.cos(math.pi * min(step / t, 1.0)))
    if sched_name == "anneal":
        period = max(total_steps // 4, 1)
        return lambda step: 0.5 ** (step // period)
    if sched_name == "multistep":
        bounds = (int(total_steps * 0.5), int(total_steps * 0.75))
        return lambda step: 0.1 ** sum(step >= b for b in bounds)
    raise ValueError(f"unknown scheduler {sched_name!r}")


def make_optimizer(opt_name: str, params, lr: float, *,
                   sched_name: str = "default", total_steps: int = 10_000,
                   weight_decay: Optional[float] = None,
                   momentum: float = 0.0):
    """Returns ``(optimizer, LambdaLR scheduler)`` over ``params``."""
    if weight_decay is None:
        weight_decay = _REF_WD.get(opt_name, 0.0)
    if opt_name == "adam":
        opt = torch.optim.Adam(params, lr=lr, weight_decay=weight_decay)
    elif opt_name == "adamw":
        opt = torch.optim.AdamW(params, lr=lr, weight_decay=weight_decay)
    elif opt_name == "radam":
        opt = torch.optim.RAdam(params, lr=lr, weight_decay=weight_decay)
    elif opt_name == "sgd":
        opt = torch.optim.SGD(params, lr=lr, momentum=momentum,
                              weight_decay=weight_decay)
    else:
        raise ValueError(f"unknown optimizer {opt_name!r}")
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, make_schedule(sched_name, total_steps=total_steps))
    return opt, sched
