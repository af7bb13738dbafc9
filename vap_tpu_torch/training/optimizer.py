"""Learning-rate schedules and the optimizers of the port's trainer.

Port of ``vap_tpu/training/optimizer.py:18-97`` (optax). A schedule is a
function of the optimizer's update count, as an optax schedule is: warmup
schedules give lr 0 at update 0, so the first update of
``constant_with_warmup`` changes nothing (optimizer.py:30-31) and
accumulation micro-batches do not advance it.

``Optimizer`` is the optax chain ``clip_by_global_norm(max_grad_norm)`` then
the named optimizer: the clip is optax's formula, ``g / norm * max_norm`` in
the gradient's dtype when the global norm reaches ``max_norm`` (torch's
``clip_grad_norm_`` adds 1e-6 to the norm, optax does not). Then:
  * ``adamw`` / ``adam``: torch's AdamW or Adam with the moments in the
    parameters' dtype, as optax keeps them. On CUDA the update is
    ``fused=True``: the default ``foreach`` path makes temporaries the size
    of all the states, about 11 GB each for the CogVideoX-5B MoT expert in
    bf16; elsewhere ``foreach=False``;
  * ``adamw-8bit`` / ``adam-8bit`` (and the ``bnb`` aliases,
    optimizer.py:82-90): the blockwise int8 moments of ``optim8bit.py``;
  * ``adafactor``: ``optax.adafactor(schedule)`` at its defaults
    (optimizer.py:91-92), ``Adafactor`` below.
A trainable parameter that got no gradient (a branch the loss does not
reach) is stepped with a zero gradient, as optax steps a zero leaf.
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel.sharding import (full_tensor, is_sharded, local, local_part, row_squares,
                                 shard_groups, shard_like)

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
    """sqrt of the sum of squares of every gradient, in float32
    (optax.global_norm). Sharded gradients (``parallel/sharding.py``) give
    the norm of the whole gradient on every rank: each rank's sums of
    squares over its pieces, all-reduced over the groups the pieces are cut
    over (a sum of local squares alone would give each rank its own norm)."""
    grads = list(grads)
    groups = shard_groups(grads)
    if not groups:
        norms = [torch.linalg.vector_norm(g, dtype=torch.float32) for g in grads]
        return torch.linalg.vector_norm(torch.stack(norms))
    import torch.distributed as dist

    squares = torch.stack([torch.linalg.vector_norm(local(g), dtype=torch.float32).square()
                           for g in grads])
    for group in groups:
        dist.all_reduce(squares, group=group)
    return torch.linalg.vector_norm(torch.sqrt(squares))


ADAM_8BIT = {"adamw-8bit": True, "adamw-bnb-8bit": True, "adam-8bit": False,
             "adam-bnb-8bit": False}  # name -> with weight decay
OPTIMIZERS = ("adamw", "adam", "adafactor", *ADAM_8BIT)


def _factored_dims(shape: Sequence[int], min_dim_size_to_factor: int = 128):
    """optax's ``_factored_dims``: the (second largest, largest) dims of
    ``shape`` (``np.argsort``; a tie keeps the lower dim first), or None
    below two dims or when the second largest is under the threshold."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape, kind="stable")
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor(torch.optim.Optimizer):
    """``optax.adafactor(lr)`` at its defaults: ``scale_by_factored_rms``
    (g^2 + 1e-30; decay 1 - (t+1)^-0.8 at the update count t; factored over
    the two largest dims once the second is >= 128, else a full second
    moment), ``clip_by_block_rms(1.0)``, the learning rate, then
    ``scale_by_param_block_rms`` (the parameter's RMS, floored at 1e-3); no
    momentum, no weight decay. The state is in the parameters' dtype.

    Everything is computed on the parameter as the JAX package stores it:
    ``kernels[i]`` marks a Linear or Conv weight ([out, in, *k] here, the
    [in * k, out] kernel there: its view ``flatten(1).t()``), so the
    factored dims are JAX's, ties included. ``groups[i]`` names the JAX
    leaf a parameter belongs to: the blocks JAX stacks along a leading
    axis are one leaf, whose update RMS (the clip) and parameter RMS are
    taken over the whole stack (the factoring is per block either way,
    the stack never being one of the two largest dims). None: each
    parameter its own leaf.

    Over sharded parameters each gradient is gathered whole once a step,
    for both passes, the parameter's RMS is summed from ``row_squares``
    (one float a row gathered), each rank applies its piece of the update,
    and the state is whole on every rank."""

    # optax.adafactor's defaults
    DECAY_RATE, EPS, CLIPPING_THRESHOLD, MIN_SCALE = 0.8, 1e-30, 1.0, 1e-3

    def __init__(self, params: Iterable[torch.Tensor], lr: float = 0.0,
                 kernels: Optional[Sequence[bool]] = None, groups: Optional[Sequence] = None):
        super().__init__(params, dict(lr=lr))
        plist = self._params()
        self.kernels = list(kernels) if kernels is not None else [False] * len(plist)
        keys = list(groups) if groups is not None else list(range(len(plist)))
        if len(self.kernels) != len(plist) or len(keys) != len(plist):
            raise ValueError("one kernel flag and one group key per parameter")
        self.groups: Dict[Any, List[int]] = {}
        for i, key in enumerate(keys):
            self.groups.setdefault(key, []).append(i)
        self.count = 0
        for p, kernel in zip(plist, self.kernels):
            shape = self._view_shape(p, kernel)
            dims = _factored_dims(shape)
            kw = dict(dtype=p.dtype, device=p.device)
            if dims is None:
                self.state[p] = {"v": torch.zeros(shape, **kw)}
            else:
                d1, d0 = dims
                self.state[p] = {"v_row": torch.zeros(shape[:d0] + shape[d0 + 1:], **kw),
                                 "v_col": torch.zeros(shape[:d1] + shape[d1 + 1:], **kw)}
            self.state[p]["dims"] = dims

    def _params(self) -> List[torch.Tensor]:
        return [p for group in self.param_groups for p in group["params"]]

    @staticmethod
    def _view(x: torch.Tensor, kernel: bool) -> torch.Tensor:
        return x.flatten(1).t() if kernel and x.ndim >= 2 else x

    @staticmethod
    def _view_shape(p: torch.Tensor, kernel: bool) -> Tuple[int, ...]:
        """The shape of ``_view`` of the whole parameter (sharded or not)."""
        if kernel and p.ndim >= 2:
            return (math.prod(p.shape[1:]), p.shape[0])
        return tuple(p.shape)

    @staticmethod
    def _unview(u: torch.Tensor, like: torch.Tensor, kernel: bool) -> torch.Tensor:
        return u.t().reshape(like.shape) if kernel and like.ndim >= 2 else u

    def state_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for s in self.state.values()
                   for t in s.values() if isinstance(t, torch.Tensor))

    def _scaled(self, g: torch.Tensor, st: Dict) -> torch.Tensor:
        """The factored-RMS update of the view ``g`` from the state (after
        its update), in float32."""
        dims = st["dims"]
        if dims is None:
            return g * st["v"].float() ** -0.5
        d1, d0 = dims
        v_row, v_col = st["v_row"].float(), st["v_col"].float()
        reduced_d1 = d1 - 1 if d1 > d0 else d1
        row_factor = (v_row / v_row.mean(dim=reduced_d1, keepdim=True)) ** -0.5
        col_factor = v_col ** -0.5
        return g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)

    @torch.no_grad()
    def step(self, closure=None):
        # 1 - (t+1)^-0.8 and its complement in float32, as optax takes them
        decay_t = 1.0 - torch.tensor(self.count + 1, dtype=torch.float32) ** -self.DECAY_RATE
        decay, rest = float(decay_t), float(1.0 - decay_t)
        lr = self.param_groups[0]["lr"]
        plist = self._params()
        for members in self.groups.values():
            # pass 1: the second-moment state, the update's and the
            # parameter's sums of squares over the leaf
            usq = psq = 0.0
            numel = 0
            whole = {}  # member -> its whole gradient's view, gathered once for both passes
            for i in members:
                p = plist[i]
                if p.grad is None:
                    continue
                st = self.state[p]
                whole[i] = self._view(full_tensor(p.grad), self.kernels[i])
                g = whole[i].float()
                gsq = g * g + self.EPS
                if st["dims"] is None:
                    st["v"].copy_(decay * st["v"].float() + rest * gsq)
                else:
                    d1, d0 = st["dims"]
                    st["v_row"].copy_(decay * st["v_row"].float()
                                      + rest * gsq.mean(dim=d0))
                    st["v_col"].copy_(decay * st["v_col"].float()
                                      + rest * gsq.mean(dim=d1))
                del gsq
                u = self._scaled(g, st)
                usq = usq + u.square().sum()
                psq = psq + row_squares(p.detach()).sum()
                numel += p.numel()
            if not numel:
                continue
            clip = torch.clamp(torch.sqrt(usq / numel) / self.CLIPPING_THRESHOLD, min=1.0)
            scale = torch.clamp(torch.sqrt(psq / numel), min=self.MIN_SCALE)
            # pass 2: the update again from the stored state (optax reads
            # the state after its cast), clipped, times lr and the RMS
            for i in members:
                p = plist[i]
                if p.grad is None:
                    continue
                g = whole.pop(i).float()
                u = self._scaled(g, self.state[p]) / clip * lr * scale
                u = local_part(self._unview(u, p, self.kernels[i]), p)
                local(p).add_(-u.to(p.dtype))
        self.count += 1
        return None

    def state_dict(self) -> Dict:
        return {"count": self.count,
                "state": [{k: t.clone() for k, t in self.state[p].items()
                           if isinstance(t, torch.Tensor)} for p in self._params()]}

    def load_state_dict(self, state: Dict) -> None:
        params = self._params()
        if len(state["state"]) != len(params):
            raise ValueError(f"an Adafactor state of {len(state['state'])} parameters for "
                             f"{len(params)}")
        self.count = int(state["count"])
        for p, saved in zip(params, state["state"]):
            for k, t in saved.items():
                self.state[p][k].copy_(t)


def jax_layout(model: torch.nn.Module, params: Sequence[torch.Tensor]):
    """(kernel flags, group keys) of ``params`` of ``model`` for
    ``Adafactor`` and ``Adam8bit``: a Linear's or a ConvNd's ``weight`` is a kernel; a
    parameter of a block of a module list (``blocks.{i}.``,
    ``transformer_blocks.{i}.`` ...) groups with its twins of the blocks
    JAX stacks into one leaf: every block of the list, or of its run of
    MoT or plain blocks where the config has ``mot_segments``. A parameter
    outside ``model`` (a LoRA adapter, kept in JAX's layout) is its own
    leaf and no kernel."""
    kernel_ids = {id(m.weight) for m in model.modules()
                  if isinstance(m, (torch.nn.Linear, torch.nn.Conv1d, torch.nn.Conv2d,
                                    torch.nn.Conv3d))}
    names = {id(p): n for n, p in model.named_parameters()}
    segments = getattr(getattr(model, "config", None), "mot_segments", None)

    def key(i: int, p: torch.Tensor):
        name = names.get(id(p))
        if name is None:
            return ("param", i)
        m = re.match(r"^(.*?)\.(\d+)\.(.*)$", name)
        if m is None:
            return ("param", name)
        prefix, idx, rest = m.group(1), int(m.group(2)), m.group(3)
        seg = 0
        if segments and prefix in ("blocks", "transformer_blocks"):
            seg = next(s for s, (start, length, _) in enumerate(segments)
                       if start <= idx < start + length)
        return ("stack", prefix, seg, rest)

    return [id(p) in kernel_ids for p in params], [key(i, p) for i, p in enumerate(params)]


class Optimizer:
    """Global-norm clipping, then the named optimizer (``OPTIMIZERS``), with
    the lr of ``schedule`` at each update. ``step()`` reads the parameters'
    ``.grad``, which must already be the gradient to apply (the mean over
    accumulated micro-batches), and returns the global norm before
    clipping. ``layout`` (``jax_layout``: kernel flags and JAX leaves) serves
    Adafactor and the 8-bit Adam."""

    def __init__(self, name: str, params: Iterable[torch.nn.Parameter], schedule: Schedule, *,
                 beta1: float = 0.9, beta2: float = 0.99, epsilon: float = 1e-8,
                 weight_decay: float = 1e-4, max_grad_norm: Optional[float] = 1.0,
                 layout=None):
        self.params = list(params)
        if not self.params:
            raise ValueError("no trainable parameter")
        self.name = name
        self.schedule = schedule
        self.max_grad_norm = max_grad_norm
        self.count = 0  # updates applied (optax's count)
        kw = dict(lr=0.0, betas=(beta1, beta2), eps=epsilon)
        kernels, groups = layout if layout is not None else (None, None)
        if name in ("adamw", "adam"):
            if all(p.is_cuda for p in self.params):
                kw["fused"] = True
            else:
                kw["foreach"] = False
        if name == "adamw":
            self.inner = torch.optim.AdamW(self.params, weight_decay=weight_decay, **kw)
        elif name == "adam":
            self.inner = torch.optim.Adam(self.params, weight_decay=0.0, **kw)
        elif name in ADAM_8BIT:
            from .optim8bit import Adam8bit

            self.inner = Adam8bit(self.params, weight_decay=weight_decay if ADAM_8BIT[name]
                                  else 0.0, kernels=kernels, groups=groups, **kw)
        elif name == "adafactor":
            self.inner = Adafactor(self.params, kernels=kernels, groups=groups)
        else:
            raise ValueError(f"unknown optimizer {name!r}; valid: {OPTIMIZERS}")

    @property
    def lr(self) -> float:
        """The lr of the next update."""
        return self.schedule(self.count)

    def state_bytes(self) -> int:
        """The bytes of the optimizer's state on its device(s)."""
        if hasattr(self.inner, "state_bytes"):
            return self.inner.state_bytes()
        return sum(t.numel() * t.element_size() for s in self.inner.state.values()
                   for t in s.values() if isinstance(t, torch.Tensor) and t.ndim > 0)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = global_norm(grads)
        if self.max_grad_norm and norm.item() >= self.max_grad_norm:
            for g in grads:  # optax: (t / g_norm) * max_norm, in t's dtype
                local(g).div_(norm.to(g.dtype)).mul_(self.max_grad_norm)
        for group in self.inner.param_groups:
            group["lr"] = self.lr
        self.inner.step()
        self.count += 1
        return norm

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    def state_dict(self) -> Dict:
        """The update count and the inner optimizer's state; over sharded
        parameters AdamW's moments are sharded too (``sharding.full_state``
        gathers them), the 8-bit and Adafactor states are whole on every
        rank."""
        return {"count": self.count, "inner": self.inner.state_dict()}

    def load_state_dict(self, state: Dict) -> None:
        """Restore ``state_dict``'s result, its tensors whole or sharded:
        a whole moment of a sharded parameter is cut to this rank's piece."""
        self.count = int(state["count"])
        inner = state["inner"]
        if isinstance(self.inner, (torch.optim.AdamW, torch.optim.Adam)):
            def placed(i, value):
                p = self.params[i]
                if (is_sharded(p) and torch.is_tensor(value) and not is_sharded(value)
                        and tuple(value.shape) == tuple(p.shape)):
                    return shard_like(value, p)
                return value

            inner = dict(inner, state={i: {k: placed(int(i), v) for k, v in st.items()}
                                       for i, st in inner["state"].items()})
        self.inner.load_state_dict(inner)


def get_optimizer(name: str, params: Iterable[torch.nn.Parameter], schedule: Schedule, *,
                  beta1: float = 0.9, beta2: float = 0.99, epsilon: float = 1e-8,
                  weight_decay: float = 1e-4, max_grad_norm: Optional[float] = 1.0,
                  layout=None) -> Optimizer:
    return Optimizer(name, params, schedule, beta1=beta1, beta2=beta2, epsilon=epsilon,
                     weight_decay=weight_decay, max_grad_norm=max_grad_norm, layout=layout)
