"""Train a Video-As-Prompt transformer from a precomputed cache.

    python -m vap_tpu_torch.train --precomputation_dir CACHE --output_dir OUT \\
        [--model_name cogvideox|wan] [--training_type video_as_prompt_mot|lora] \\
        [--model_structure_config JSON] [--train_steps N] [--lr 1e-5] \\
        [--device cuda|cpu] [--model_config NAME]

The port's counterpart of ``train.py`` for the SFT paths: the flags are the
fields of ``training.args.TrainingArgs`` (the JAX names and defaults), plus
``--device`` (the card unless ``cpu`` is asked for; there is no fallback
when the card is missing) and ``--model_config`` (the family's released
structure, ``cogvideox_5b_i2v_vap`` or ``wan_14b_i2v_vap``, by default; or
``tiny``, for runs on the CPU). ``--model_structure_config`` overrides the
transformer's fields as in JAX's ``train.py`` (a flat JSON, or its
``"transformer"`` section): ``examples/training/sft/wan/crush_smol_lora/
config_plain.json`` makes Wan2.1-I2V-14B the plain model of the LoRA
recipe. The weights are random, from ``--seed``, until a checkpoint loader
is ported. The cache is the JAX trainer's precompute output
(``rank_0/cond_*.npz``, ``lat_*.npz``); its shapes must fit the model
configuration.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import typing
from typing import Any, Dict, List, Optional

import torch

from .models.cogvideox.config import CogVideoXMOTConfig
from .models.cogvideox.transformer_mot import CogVideoXTransformer3DMOTModel
from .models.random_init import build_random
from .models.wan.config import WanMOTConfig
from .models.wan.transformer_mot import WanTransformer3DMOTModel
from .pipelines.cogvideox_i2v_mot import resolve_device
from .training.args import TrainingArgs
from .training.trainer import SFTTrainer

# per model_name: the model class, its config class and its configurations
# by name (the released structure first; ``tiny`` for runs on the CPU)
MODELS = {
    "cogvideox": (CogVideoXTransformer3DMOTModel, CogVideoXMOTConfig, {
        "cogvideox_5b_i2v_vap": CogVideoXMOTConfig.cogvideox_5b_i2v_vap,
        # three blocks, MoT in two
        "tiny": lambda **kw: CogVideoXMOTConfig.tiny(
            **{"in_channels": 8, "out_channels": 4, "num_layers": 3,
               "block_idx_with_mot_ref": (0, 1), **kw}),
    }),
    "wan": (WanTransformer3DMOTModel, WanMOTConfig, {
        "wan_14b_i2v_vap": WanMOTConfig.wan_14b_i2v_vap,
        # two blocks, 4 latent + 4 conditioning channels
        "tiny": lambda **kw: WanMOTConfig.tiny(**{"in_channels": 8, "out_channels": 4, **kw}),
    }),
}
_STRUCTURE_SECTIONS = ("transformer", "vae", "text_encoder", "text_encoder_2", "image_encoder")


def structure_overrides(cfg_cls, structure: Dict[str, Any]) -> Dict[str, Any]:
    """The transformer fields of a structure JSON (``_sections`` and
    ``_cfg_kwargs`` of JAX's ``train.py``): a flat dict is transformer-only;
    a nested one carries a ``"transformer"`` section. Keys that are not
    fields of ``cfg_cls`` are dropped, lists become tuples."""
    if any(k in structure for k in _STRUCTURE_SECTIONS):
        structure = structure.get("transformer", {})
    names = {f.name for f in dataclasses.fields(cfg_cls)}

    def tuplify(v):
        return tuple(tuplify(x) for x in v) if isinstance(v, list) else v

    return {k: tuplify(v) for k, v in structure.items() if k in names}


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("vap_tpu_torch.train")
    hints = typing.get_type_hints(TrainingArgs)
    for f in dataclasses.fields(TrainingArgs):
        hint = hints[f.name]
        if hint is bool:
            parser.add_argument(f"--{f.name}", action=argparse.BooleanOptionalAction,
                                default=f.default)
        else:
            kind = next((t for t in typing.get_args(hint) if t is not type(None)), hint)
            parser.add_argument(f"--{f.name}", type=kind, default=f.default)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    parser.add_argument("--model_config", default=None,
                        help="the model's configuration: its released structure by default "
                             "(cogvideox_5b_i2v_vap, wan_14b_i2v_vap) or tiny")
    return parser


def main(argv: Optional[List[str]] = None) -> SFTTrainer:
    ns = vars(_parser().parse_args(argv))
    device = resolve_device(ns.pop("device"))
    config_name = ns.pop("model_config")
    args = TrainingArgs(**ns)
    model_cls, cfg_cls, configs = MODELS[args.model_name]
    config_name = config_name or next(iter(configs))
    if config_name not in configs:
        raise ValueError(f"unknown model_config {config_name!r} for {args.model_name}; "
                         f"valid: {sorted(configs)}")
    cfg = configs[config_name](**structure_overrides(cfg_cls, args.model_structure()))
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model = build_random(model_cls, cfg, device, dtype, gen)
    trainer = SFTTrainer(args, model)
    trainer.run()
    return trainer


if __name__ == "__main__":
    main()
