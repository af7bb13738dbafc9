"""Bytes per rank of the released sharded recipes, on the meta device.

    python -m vap_tpu_torch.scripts.memory_check

The port of ``scripts/memory_check.py``. The transformer is built on the
``meta`` device (no weights), its trained partition marked as the trainer
marks it, and every number is computed from shapes, for one rank of the
recipe's mesh under FSDP2 / HSDP (``parallel/sharding.py``):

  * parameters: bf16, dim 0 of each padded to a multiple of ``fsdp`` and
    cut (``rank_numel``);
  * gradients: the trained parameters' shards (bf16);
  * optimizer state, for AdamW, the 8-bit AdamW and Adafactor: AdamW
    keeps two moments in the parameters' dtype, sharded as they are; the
    8-bit Adam keeps int8 codes and f32 scales over JAX's stacked leaves,
    2048 elements a block, whole on every rank (its blocks cross the shard
    boundaries); Adafactor its factored statistics, whole on every rank;
  * the unit gathers: two blocks' whole parameters (the block running and
    the one prefetched) and one block's whole trained gradients before
    their reduce-scatter;
  * the local batch (f32, as the trainer puts it on the card);
  * beside the bytes held, the bytes a rank receives a step over its fsdp
    group: FSDP2's parameter all-gathers, and the whole gradients the
    8-bit Adam and Adafactor gather (``gather_bytes``);
  * under full remat the block inputs each block keeps for its backward
    (bf16), and an estimate of one block's working set while it is
    recomputed: 12 activations of the joint stream's width (q, k, v, the
    attention out, the norms, the feed-forward's input and its 4x hidden
    twice).

Recipes (``RECIPES``): the Wan VAP expert SFT
(``examples/training/sft/wan/vap_mot/train_single_node.sh``: HSDP 2 x 4,
``config_ori_d_20.json``, 49x480x832, one reference) and the CogVideoX
3-reference SFT (``examples/training/sft/cogvideox/vap_mot/
train_single_node_3ref.sh``: HSDP 4 x 2, ``config_ori.json``, 49x480x720,
three references), each at ``--batch_size 1`` a rank. Every total is set
against the 80 GB of an H100 80GB. Nothing runs on a card; the rows that
are not estimates are exact for the port's layout.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Dict, List, Optional

import torch
from torch import nn

from ..parallel.sharding import blocks, rank_numel

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
GB = 10 ** 9
H100_BYTES = 80 * GB
BF16 = 2
F32 = 4
OPTIMIZERS = ("adamw", "adamw-8bit", "adafactor")


@dataclasses.dataclass(frozen=True)
class Recipe:
    family: str           # cogvideox | wan
    script: str           # the released launch script
    structure: str        # its --model_structure_config
    data: int
    fsdp: int
    frames: int
    height: int
    width: int
    refs: int             # --sample_ref_videos_num
    batch: int = 1        # --batch_size, a rank


RECIPES = {
    "wan_vap_hsdp_2x4": Recipe(
        "wan", "examples/training/sft/wan/vap_mot/train_single_node.sh",
        "examples/training/sft/wan/vap_mot/config_ori_d_20.json", data=2, fsdp=4, frames=49,
        height=480, width=832, refs=1),
    "cogvideox_3ref_hsdp_4x2": Recipe(
        "cogvideox", "examples/training/sft/cogvideox/vap_mot/train_single_node_3ref.sh",
        "examples/training/sft/cogvideox/vap_mot/config_ori.json", data=4, fsdp=2, frames=49,
        height=480, width=720, refs=3),
}


def model_on_meta(family: str, structure: Optional[Dict] = None) -> nn.Module:
    """The family's released transformer (``structure`` overriding its
    fields) on the meta device, its MoT expert marked trainable."""
    from ..models.cogvideox.config import CogVideoXMOTConfig
    from ..models.cogvideox.transformer_mot import CogVideoXTransformer3DMOTModel
    from ..models.wan.config import WanMOTConfig
    from ..models.wan.transformer_mot import WanTransformer3DMOTModel
    from ..training.train_step import trainable_mask

    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in (structure or {}).items()}
    if family == "wan":
        cls, cfg = WanTransformer3DMOTModel, WanMOTConfig.wan_14b_i2v_vap(**kw)
    elif family == "cogvideox":
        cls, cfg = CogVideoXTransformer3DMOTModel, CogVideoXMOTConfig.cogvideox_5b_i2v_vap(**kw)
    else:
        raise ValueError(f"no sharded recipe of {family!r}")
    with torch.device("meta"):
        model = cls(cfg).to(torch.bfloat16)
    trainable_mask(model)
    return model


def sharded_bytes(model: nn.Module, fsdp: int) -> Dict[str, int]:
    """Per rank: the parameters and the trained parameters' gradients,
    FSDP2's layout, in the parameters' dtype."""
    params = trained = 0
    for p in model.parameters():
        n = rank_numel(p.shape, fsdp) * p.element_size()
        params += n
        if p.requires_grad:
            trained += n
    return {"params": params, "grads": trained}


def optimizer_bytes(model: nn.Module, name: str, fsdp: int) -> int:
    """Per rank: the state of optimizer ``name`` over the trained parameters."""
    from ..training.optim8bit import BLOCK_SIZE
    from ..training.optimizer import _factored_dims, jax_layout

    trained = [p for p in model.parameters() if p.requires_grad]
    if name in ("adamw", "adam"):
        return 2 * sum(rank_numel(p.shape, fsdp) * p.element_size() for p in trained)
    kernels, groups = jax_layout(model, trained)
    if name in ("adamw-8bit", "adam-8bit"):
        leaves: Dict = {}
        for p, key in zip(trained, groups):
            leaves[key] = leaves.get(key, 0) + p.numel()
        blocks_ = sum(math.ceil(n / BLOCK_SIZE) for n in leaves.values())
        return blocks_ * (2 * BLOCK_SIZE + 2 * F32)  # two int8 blocks, two f32 scales
    if name == "adafactor":
        total = 0
        for p, kernel in zip(trained, kernels):
            shape = ((math.prod(p.shape[1:]), p.shape[0]) if kernel and p.ndim >= 2
                     else tuple(p.shape))
            dims = _factored_dims(shape)
            if dims is None:
                total += math.prod(shape)
            else:
                total += math.prod(shape) // shape[dims[1]] + math.prod(shape) // shape[dims[0]]
        return total * trained[0].element_size()
    raise ValueError(f"unknown optimizer {name!r}")


def gather_bytes(model: nn.Module, name: str, fsdp: int) -> Dict[str, int]:
    """Per rank and step, the bytes it receives over its fsdp group: FSDP2's
    all-gathers of every parameter (in the forward, and again in the
    backward for the recompute) and, beside them, what optimizer ``name``
    gathers: the 8-bit Adam each trained gradient whole (bf16), Adafactor
    each trained gradient once and a float32 sum of squares a dim-0 row of
    each trained parameter (``row_squares``), AdamW nothing. Left out:
    FSDP2's reduce-scatter of the gradients, HSDP's all-reduce over data
    and the norm's all-reduce (a float a tensor)."""
    def received(shape, size):  # the other ranks' pieces, padded as FSDP2 pads them
        return (fsdp - 1) * rank_numel(shape, fsdp) * size

    trained = [p for p in model.parameters() if p.requires_grad]
    grads = sum(received(p.shape, p.element_size()) for p in trained)
    rows = sum(received(p.shape[:1], F32) for p in trained)
    opt = {"adamw": 0, "adam": 0, "adamw-8bit": grads, "adam-8bit": grads,
           "adafactor": grads + rows}
    if name not in opt:
        raise ValueError(f"unknown optimizer {name!r}")
    return {"fsdp_all_gathers": 2 * sum(received(p.shape, p.element_size())
                                         for p in model.parameters()),
            "optimizer_gathers": opt[name]}


def unit_bytes(model: nn.Module) -> int:
    """The largest FSDP unit's transient bytes: two blocks' whole
    parameters (running, prefetched) and one block's whole trained
    gradients before the reduce-scatter."""
    def whole(block, trained_only=False):
        return sum(p.numel() * p.element_size() for p in block.parameters()
                   if p.requires_grad or not trained_only)

    units = blocks(model)
    return 2 * max(whole(b) for b in units) + max(whole(b, True) for b in units)


def stream_sizes(family: str, cfg, r: Recipe) -> Dict[str, int]:
    """Token counts of one sample: the target's video tokens, its text, the
    references' (all ``refs``), and the latent grid."""
    lat_f, lat_h, lat_w = (r.frames - 1) // 4 + 1, r.height // 8, r.width // 8
    if family == "wan":
        p = cfg.patch_size
        video = lat_f // p[0] * (lat_h // p[1]) * (lat_w // p[2])
        text = cfg.text_len
    else:
        video = lat_f * (lat_h // cfg.patch_size) * (lat_w // cfg.patch_size)
        text = cfg.max_text_seq_length
    return {"video": video, "text": text, "lat": lat_f * lat_h * lat_w}


def activation_bytes(model: nn.Module, family: str, r: Recipe) -> Dict[str, int]:
    """Per rank: the local batch, the block inputs full remat keeps and the
    recomputed block's working set (an estimate)."""
    cfg = model.config
    s = stream_sizes(family, cfg, r)
    b, refs, dim = r.batch, r.refs, cfg.num_attention_heads * cfg.attention_head_dim
    mot = set(cfg.block_idx_with_mot_ref)
    n_blocks = len(blocks(model))
    if family == "wan":
        cond = cfg.in_channels - cfg.out_channels
        latents = s["lat"] * (cfg.out_channels + cond) * (1 + refs)
        context = (cfg.text_len * cfg.text_dim + 257 * cfg.image_dim) * (1 + refs)
        batch = b * (latents + context) * F32
        # per block its stream (the contexts are shared); a MoT block the references' too
        per_plain = s["video"] * dim
        per_mot = (1 + refs) * s["video"] * dim
        joint = (1 + refs) * s["video"]
    else:
        latents = s["lat"] * cfg.in_channels * (1 + refs)  # latents and image latents
        batch = b * (latents + cfg.max_text_seq_length * cfg.text_embed_dim * (1 + refs)) * F32
        per_plain = (s["video"] + s["text"]) * dim
        per_mot = (1 + refs) * (s["video"] + s["text"]) * dim
        joint = (1 + refs) * (s["video"] + s["text"])
    inputs = sum(per_mot if i in mot else per_plain for i in range(n_blocks))
    return {"batch": batch, "block_inputs": b * inputs * BF16,
            "block_working": b * 12 * joint * dim * BF16}


def account(name: str, optimizers=OPTIMIZERS) -> Dict:
    """The bytes of one rank of recipe ``name``: the rows shared by every
    optimizer, then each optimizer's state and total."""
    r = RECIPES[name]
    with open(os.path.join(REPO, r.structure)) as f:
        structure = json.load(f)
    model = model_on_meta(r.family, structure)
    rows = dict(sharded_bytes(model, r.fsdp))
    rows["unit_gathers"] = unit_bytes(model)
    rows.update(activation_bytes(model, r.family, r))
    shared = sum(rows.values())
    n_params = sum(p.numel() for p in model.parameters())
    n_trained = sum(p.numel() for p in model.parameters() if p.requires_grad)
    state = {opt: optimizer_bytes(model, opt, r.fsdp) for opt in optimizers}
    gathers = {opt: gather_bytes(model, opt, r.fsdp) for opt in optimizers}
    return {"recipe": name, "mesh": {"data": r.data, "fsdp": r.fsdp}, "script": r.script,
            "structure": r.structure, "parameters": n_params, "trained": n_trained,
            "rows": rows, "optimizer_state": state, "gathered_a_step": gathers,
            "total": {opt: shared + state[opt] for opt in optimizers},
            "budget": H100_BYTES}


def format_report(rep: Dict) -> List[str]:
    lines = [f"{rep['recipe']} (data {rep['mesh']['data']} x fsdp {rep['mesh']['fsdp']}; "
             f"{rep['script']}, {rep['structure']}): {rep['parameters']} parameters, "
             f"{rep['trained']} trained; bytes per rank:"]
    for key, value in rep["rows"].items():
        lines.append(f"  {key:16s} {value / GB:9.2f} GB")
    for opt, value in rep["optimizer_state"].items():
        total = rep["total"][opt]
        moved = rep["gathered_a_step"][opt]
        lines.append(f"  {opt:16s} state {value / GB:9.2f} GB, total {total / GB:9.2f} GB: "
                     f"{'fits' if total < rep['budget'] else 'does not fit'} in "
                     f"{rep['budget'] / GB:.0f} GB; received a step over fsdp: FSDP2's "
                     f"all-gathers {moved['fsdp_all_gathers'] / GB:.2f} GB, the optimizer's "
                     f"gathers {moved['optimizer_gathers'] / GB:.2f} GB")
    return lines


def main() -> List[Dict]:
    reports = [account(name) for name in RECIPES]
    for rep in reports:
        print("\n".join(format_report(rep)))
    return reports


if __name__ == "__main__":
    main()
