"""Learning-rate schedules and the optimizer of the port's trainer.

Port of ``vap_tpu/training/optimizer.py:18-97`` (optax). A schedule is a
function of the optimizer's update count, as an optax schedule is: warmup
schedules give lr 0 at update 0, so the first update of
``constant_with_warmup`` changes nothing (optimizer.py:30-31) and
accumulation micro-batches do not advance it.

``Optimizer`` is the optax chain ``clip_by_global_norm(max_grad_norm)`` then
``adamw``/``adam``: the clip is optax's formula, ``g / norm * max_norm`` in
the gradient's dtype when the global norm reaches ``max_norm`` (torch's
``clip_grad_norm_`` adds 1e-6 to the norm, optax does not), and the update
is torch's AdamW or Adam with the moments in the parameters' dtype, as
optax keeps them. On CUDA the update is ``fused=True``: the default
``foreach`` path makes temporaries the size of all the states, about 11 GB
each for the CogVideoX-5B MoT expert in bf16; elsewhere ``foreach=False``.
A trainable parameter that got no gradient (a branch the loss does not
reach) is stepped with a zero gradient, as optax steps a zero leaf.

Not ported (they raise): ``adafactor`` and the 8-bit optimizers.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple

import torch

Schedule = Callable[[int], float]


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule: constant ``init`` when ``steps`` <= 0."""
    if steps <= 0:
        return lambda count: init
    return lambda count: init + (end - init) * min(max(count, 0), steps) / steps


def _cosine(init: float, steps: int) -> Schedule:
    """optax.cosine_decay_schedule with alpha 0."""
    return lambda count: init * 0.5 * (1 + math.cos(math.pi * min(count, steps) / steps))


def _polynomial(init: float, end: float, power: float, steps: int) -> Schedule:
    if steps <= 0:
        return lambda count: init
    return lambda count: (init - end) * (1 - min(max(count, 0), steps) / steps) ** power + end


def _join(schedules: Sequence[Schedule], boundaries: Sequence[int]) -> Schedule:
    """optax.join_schedules: after each boundary the next schedule runs on
    the count since that boundary."""
    def schedule(count: int) -> float:
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = sched(count - boundary)
        return out
    return schedule


def get_lr_schedule(name: str, lr: float, *, warmup_steps: int = 0, train_steps: int = 10000,
                    num_cycles: float = 0.5, power: float = 1.0,
                    milestones: Optional[Sequence[Tuple[int, float]]] = None) -> Schedule:
    """lr as a function of the update count, as ``get_lr_schedule`` of the
    JAX package builds it from optax schedules."""
    warmup = _linear(0.0, lr, warmup_steps)
    decay_steps = max(1, train_steps - warmup_steps)
    if name in ("constant", "constant_with_warmup"):
        if warmup_steps > 0:
            return _join([warmup, lambda count: lr], [warmup_steps])
        return lambda count: lr
    if name == "linear":
        return _join([warmup, _linear(lr, 0.0, decay_steps)], [warmup_steps])
    if name == "cosine":
        return _join([warmup, _cosine(lr, decay_steps)], [warmup_steps])
    if name == "cosine_with_restarts":
        cycles = max(1, int(num_cycles))
        cycle_len = max(1, (train_steps - warmup_steps) // cycles)
        return _join([warmup] + [_cosine(lr, cycle_len)] * cycles,
                     [warmup_steps + c * cycle_len for c in range(cycles)])
    if name == "polynomial":
        return _join([warmup, _polynomial(lr, 0.0, power, decay_steps)], [warmup_steps])
    if name == "piecewise_constant":
        if not milestones:
            raise ValueError("piecewise_constant needs milestones [(step, scale), ...]")

        def piecewise(count: int) -> float:
            value = lr
            for boundary, scale in sorted(dict(milestones).items()):
                if count >= boundary:
                    value *= scale
            return value
        return piecewise
    raise ValueError(f"unknown lr schedule {name!r}")


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in float32 (optax.global_norm)."""
    norms = [torch.linalg.vector_norm(g, dtype=torch.float32) for g in grads]
    return torch.linalg.vector_norm(torch.stack(norms))


class Optimizer:
    """Global-norm clipping, then AdamW or Adam, with the lr of ``schedule``
    at each update. ``step()`` reads the parameters' ``.grad``, which must
    already be the gradient to apply (the mean over accumulated
    micro-batches), and returns the global norm before clipping."""

    def __init__(self, name: str, params: Iterable[torch.nn.Parameter], schedule: Schedule, *,
                 beta1: float = 0.9, beta2: float = 0.99, epsilon: float = 1e-8,
                 weight_decay: float = 1e-4, max_grad_norm: Optional[float] = 1.0):
        self.params = list(params)
        if not self.params:
            raise ValueError("no trainable parameter")
        self.schedule = schedule
        self.max_grad_norm = max_grad_norm
        self.count = 0  # updates applied (optax's count)
        kw = dict(lr=0.0, betas=(beta1, beta2), eps=epsilon)
        if all(p.is_cuda for p in self.params):
            kw["fused"] = True
        else:
            kw["foreach"] = False
        if name == "adamw":
            self.inner = torch.optim.AdamW(self.params, weight_decay=weight_decay, **kw)
        elif name == "adam":
            self.inner = torch.optim.Adam(self.params, weight_decay=0.0, **kw)
        elif name in ("adafactor", "adamw-8bit", "adamw-bnb-8bit", "adam-8bit", "adam-bnb-8bit"):
            raise NotImplementedError(f"optimizer {name!r} is not ported to PyTorch yet")
        else:
            raise ValueError(f"unknown optimizer {name!r}")

    @property
    def lr(self) -> float:
        """The lr of the next update."""
        return self.schedule(self.count)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = global_norm(grads)
        if self.max_grad_norm and norm.item() >= self.max_grad_norm:
            for g in grads:  # optax: (t / g_norm) * max_norm, in t's dtype
                g.div_(norm.to(g.dtype)).mul_(self.max_grad_norm)
        for group in self.inner.param_groups:
            group["lr"] = self.lr
        self.inner.step()
        self.count += 1
        return norm

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    def state_dict(self) -> Dict:
        return {"count": self.count, "inner": self.inner.state_dict()}

    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        self.inner.load_state_dict(state["inner"])


def get_optimizer(name: str, params: Iterable[torch.nn.Parameter], schedule: Schedule, *,
                  beta1: float = 0.9, beta2: float = 0.99, epsilon: float = 1e-8,
                  weight_decay: float = 1e-4,
                  max_grad_norm: Optional[float] = 1.0) -> Optimizer:
    return Optimizer(name, params, schedule, beta1=beta1, beta2=beta2, epsilon=epsilon,
                     weight_decay=weight_decay, max_grad_norm=max_grad_norm)
