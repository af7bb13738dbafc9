"""Train the CogVideoX VAP MoT expert from a precomputed cache.

    python -m vap_tpu_torch.train --precomputation_dir CACHE --output_dir OUT \\
        [--train_steps N] [--lr 1e-5] [--device cuda|cpu] [--model_config NAME]

The port's counterpart of ``train.py`` for the CogVideoX VAP SFT path: the
flags are the fields of ``training.args.TrainingArgs`` (the JAX names and
defaults), plus ``--device`` (the card unless ``cpu`` is asked for; there is
no fallback when the card is missing) and ``--model_config``
(``cogvideox_5b_i2v_vap``, the released structure, or ``tiny``). The
weights are random, from ``--seed``, until a checkpoint loader is ported.
The cache is the JAX trainer's precompute output (``rank_0/cond_*.npz``,
``lat_*.npz``); its shapes must fit the model configuration.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import typing
from typing import List, Optional

import torch

from .models.cogvideox.config import CogVideoXMOTConfig
from .models.cogvideox.transformer_mot import CogVideoXTransformer3DMOTModel
from .models.random_init import build_random
from .pipelines.cogvideox_i2v_mot import resolve_device
from .training.args import TrainingArgs
from .training.trainer import SFTTrainer

MODEL_CONFIGS = {
    "cogvideox_5b_i2v_vap": CogVideoXMOTConfig.cogvideox_5b_i2v_vap,
    # three blocks, MoT in two: for runs on the CPU
    "tiny": lambda: CogVideoXMOTConfig.tiny(in_channels=8, out_channels=4, num_layers=3,
                                            block_idx_with_mot_ref=(0, 1)),
}


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
    parser.add_argument("--model_config", choices=sorted(MODEL_CONFIGS),
                        default="cogvideox_5b_i2v_vap")
    return parser


def main(argv: Optional[List[str]] = None) -> SFTTrainer:
    ns = vars(_parser().parse_args(argv))
    device = resolve_device(ns.pop("device"))
    cfg = MODEL_CONFIGS[ns.pop("model_config")]()
    args = TrainingArgs(**ns)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    gen = torch.Generator(device=device).manual_seed(args.seed)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model = build_random(CogVideoXTransformer3DMOTModel, cfg, device, dtype, gen)
    trainer = SFTTrainer(args, model)
    trainer.run()
    return trainer


if __name__ == "__main__":
    main()
