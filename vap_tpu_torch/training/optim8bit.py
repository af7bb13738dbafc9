"""Blockwise 8-bit Adam and AdamW.

Port of ``vap_tpu/training/optim8bit.py`` (an optax transform there). Both
Adam moments are kept as int8 codes in blocks of ``BLOCK_SIZE`` elements of
the flattened leaf, with one float32 absmax scale per block: about 2.004
bytes of state per parameter, where AdamW in the parameters' dtype keeps 4
(bf16) or 8 (f32). The codes are power laws, as JAX's: sign * sqrt for the
first moment (c = 127 sign(m) sqrt(|m| / absmax)), the fourth root for the
non-negative second (c = 127 (v / max)^(1/4)), so small moments keep
resolution.

One update, per leaf (``scale_by_adam_8bit`` :104-114, then
``add_decayed_weights`` and the learning rate for AdamW, :137-144):
m = b1 deq(m) + (1 - b1) g, v = b2 deq(v) + (1 - b2) g^2, the update
(m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps) at the update count t
(``count``), both moments re-quantised; AdamW adds ``weight_decay`` * p,
then p -= lr * update. The tail of the last block is zero, as JAX pads it.

A leaf is JAX's: a Linear or Conv weight (``kernels``) is taken in the
order of its [in * k, out] kernel, and the parameters JAX stacks into one
leaf (``groups``: the twins of a list of blocks) are one stream, member
after member, so that the blocks and their scales are JAX's, a block
running across two layers where a layer is no multiple of ``BLOCK_SIZE``.
The float32 temporaries are those of one chunk of at most ``CHUNK_BLOCKS``
blocks of one leaf at a time, never of the whole trained set (at the
CogVideoX expert's ~5 B parameters one flat float32 pass would take
20 GB). JAX computes the update in XLA, not in a Pallas kernel: it is
plain PyTorch here.

The state (``count``, and per leaf ``m_code``, ``m_scale``, ``v_code``,
``v_scale``) is saved and restored whole by ``state_dict`` /
``load_state_dict``, the scales kept in float32 whatever the parameters'
dtype.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence

import torch

from ..parallel.sharding import full_tensor, local, local_part

BLOCK_SIZE = 2048
# blocks per chunk of the update: 2^13 blocks are 16 Mi elements, 64 MiB in f32
CHUNK_BLOCKS = 1 << 13


def quantize_m(x: torch.Tensor):
    """[nb, block] float32 -> (int8 codes, float32 scales [nb, 1]):
    c = 127 sign(x) sqrt(|x| / absmax) (``_quantize_m``)."""
    scale = x.abs().amax(dim=1, keepdim=True)
    u = torch.sqrt(x.abs() / torch.where(scale > 0, scale, torch.ones_like(scale)))
    code = torch.clamp(torch.round(127.0 * torch.sign(x) * u), -127, 127).to(torch.int8)
    return code, scale


def dequantize_m(code: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    u = code.float() / 127.0
    return scale * torch.sign(u) * u * u


def quantize_v(x: torch.Tensor):
    """[nb, block] non-negative float32 -> (int8 codes, float32 scales):
    c = 127 (x / max)^(1/4) (``_quantize_v``)."""
    scale = x.amax(dim=1, keepdim=True)
    u = (x / torch.where(scale > 0, scale, torch.ones_like(scale))) ** 0.25
    code = torch.clamp(torch.round(127.0 * u), 0, 127).to(torch.int8)
    return code, scale


def dequantize_v(code: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    u = code.float() / 127.0
    return scale * (u * u) * (u * u)


def _blocks(n: int, block: int) -> int:
    return (max(n, 1) + block - 1) // block


class Adam8bit(torch.optim.Optimizer):
    """Adam (``weight_decay`` 0) or AdamW with int8 blockwise moments. The
    learning rate is the group's ``lr``, set by the caller before each
    ``step`` (``training/optimizer.py`` ``Optimizer``). ``kernels[i]`` marks
    a Linear or Conv weight; ``groups[i]`` names the JAX leaf of parameter
    i (``optimizer.jax_layout``; its members in JAX's stacking order), None:
    each parameter its own leaf."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float = 0.0, betas=(0.9, 0.99),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 kernels: Optional[Sequence[bool]] = None, groups: Optional[Sequence] = None):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))
        self.count = 0
        plist = self._params()
        self.kernels = list(kernels) if kernels is not None else [False] * len(plist)
        keys = list(groups) if groups is not None else list(range(len(plist)))
        if len(self.kernels) != len(plist) or len(keys) != len(plist):
            raise ValueError("one kernel flag and one group key per parameter")
        leaves: Dict[Any, List[int]] = {}
        for i, key in enumerate(keys):
            leaves.setdefault(key, []).append(i)
        self.leaves = list(leaves.values())  # each leaf's parameter indices
        for members in self.leaves:
            ps = [plist[i] for i in members]
            if len({tuple(p.shape) for p in ps}) != 1:
                raise ValueError(f"the parameters of one leaf differ in shape: "
                                 f"{[tuple(p.shape) for p in ps]}")
            nb = _blocks(sum(p.numel() for p in ps), BLOCK_SIZE)
            dev = ps[0].device
            self.state[ps[0]] = {  # a leaf's state sits under its first member
                "m_code": torch.zeros((nb, BLOCK_SIZE), dtype=torch.int8, device=dev),
                "m_scale": torch.zeros((nb, 1), dtype=torch.float32, device=dev),
                "v_code": torch.zeros((nb, BLOCK_SIZE), dtype=torch.int8, device=dev),
                "v_scale": torch.zeros((nb, 1), dtype=torch.float32, device=dev)}

    def _params(self) -> List[torch.Tensor]:
        return [p for group in self.param_groups for p in group["params"]]

    def leaf_states(self) -> List[Dict[str, torch.Tensor]]:
        """The state of each leaf, in the order of ``leaves``."""
        plist = self._params()
        return [self.state[plist[members[0]]] for members in self.leaves]

    def state_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for s in self.state.values() for t in s.values())

    @torch.no_grad()
    def step(self, closure=None):
        self.count += 1
        plist = self._params()
        group = self.param_groups[0]
        b1, b2 = group["betas"]
        c = torch.tensor(float(self.count), dtype=torch.float32)
        bc1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** c)
        bc2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** c)
        for members, st in zip(self.leaves, self.leaf_states()):
            if any(plist[i].grad is not None for i in members):
                self._update([plist[i] for i in members], [self.kernels[i] for i in members],
                             st, group, b1, b2, bc1, bc2)
        return None

    @staticmethod
    def _flat_grad(p: torch.Tensor, kernel: bool) -> torch.Tensor:
        """``p``'s whole gradient flattened in JAX's order (zeros where it
        has none; gathered where it is sharded)."""
        if p.grad is None:
            return torch.zeros(p.numel(), dtype=p.dtype, device=p.device)
        g = full_tensor(p.grad)
        return (g.flatten(1).t() if kernel and p.ndim >= 2 else g).reshape(-1)

    def _update(self, ps, kernels, st, group, b1, b2, bc1, bc2) -> None:
        """One leaf: the moments over the stream of its members, chunk by
        chunk; each member, once its update is whole, p -= lr * (update + wd p)."""
        nb, block = st["m_code"].shape
        n, dev = ps[0].numel(), ps[0].device
        total = n * len(ps)
        grads: Dict[int, torch.Tensor] = {}  # member -> flat gradient, while its update builds
        upds: Dict[int, torch.Tensor] = {}
        for r0 in range(0, nb, CHUNK_BLOCKS):
            r1 = min(r0 + CHUNK_BLOCKS, nb)
            e0, e1 = r0 * block, min(r1 * block, total)
            spans = [(j, max(e0, j * n), min(e1, (j + 1) * n))
                     for j in range(e0 // n, (e1 - 1) // n + 1)]
            g = torch.zeros(((r1 - r0) * block,), dtype=torch.float32, device=dev)
            for j, a, b in spans:
                if j not in grads:
                    grads[j] = self._flat_grad(ps[j], kernels[j])
                    upds[j] = torch.empty(n, dtype=ps[j].dtype, device=dev)
                g[a - e0:b - e0] = grads[j][a - j * n:b - j * n]
            g = g.view(r1 - r0, block)
            m = b1 * dequantize_m(st["m_code"][r0:r1], st["m_scale"][r0:r1]) + (1.0 - b1) * g
            v = b2 * dequantize_v(st["v_code"][r0:r1], st["v_scale"][r0:r1]) + (1.0 - b2) * g * g
            upd = ((m / bc1) / (torch.sqrt(v / bc2) + group["eps"])).view(-1)
            st["m_code"][r0:r1], st["m_scale"][r0:r1] = quantize_m(m)
            st["v_code"][r0:r1], st["v_scale"][r0:r1] = quantize_v(v)
            del g, m, v
            for j, a, b in spans:
                upds[j][a - j * n:b - j * n] = upd[a - e0:b - e0]
                if b == (j + 1) * n:  # member j's update is whole
                    del grads[j]
                    self._apply(ps[j], upds.pop(j), kernels[j], group)

    @staticmethod
    def _apply(p: torch.Tensor, upd: torch.Tensor, kernel: bool, group) -> None:
        if kernel and p.ndim >= 2:
            u = upd.view(p.numel() // p.shape[0], p.shape[0]).t().reshape(p.shape)
        else:
            u = upd.view(p.shape)
        u, p = local_part(u, p), local(p)  # a sharded parameter takes its piece
        if group["weight_decay"]:
            u = u + group["weight_decay"] * p
        p.add_(-(group["lr"] * u))

    def state_dict(self) -> Dict:
        return {"count": self.count,
                "state": [{k: t.clone() for k, t in st.items()} for st in self.leaf_states()]}

    def load_state_dict(self, state: Dict) -> None:
        leaves = self.leaf_states()
        if len(state["state"]) != len(leaves):
            raise ValueError(f"an 8-bit Adam state of {len(state['state'])} leaves for "
                             f"{len(leaves)}")
        self.count = int(state["count"])
        for st, saved in zip(leaves, state["state"]):
            for k, t in saved.items():
                if t.shape != st[k].shape:
                    raise ValueError(f"8-bit Adam state {k} of shape {tuple(t.shape)} for "
                                     f"{tuple(st[k].shape)}")
                st[k].copy_(t)
