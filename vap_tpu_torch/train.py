"""Train a Video-As-Prompt transformer from a precomputed cache.

    python -m vap_tpu_torch.train --precomputation_dir CACHE --output_dir OUT \\
        [--model_name cogvideox|wan|hunyuan_video] [--training_type video_as_prompt_mot|lora] \\
        [--model_structure_config JSON] [--train_steps N] [--lr 1e-5] \\
        [--device cuda|cpu] [--model_config NAME]

    torchrun --nproc_per_node N -m vap_tpu_torch.train ... --seq_degree S \\
        [--data_degree D] [--cp_rotate_method allgather|ppermute|ulysses]   # N = D x S

The port's counterpart of ``train.py`` for the SFT paths: the flags are the
fields of ``training.args.TrainingArgs`` (the JAX names and defaults), plus
``--device`` (the card unless ``cpu`` is asked for; there is no fallback
when the card is missing) and ``--model_config`` (the family's released
structure, ``cogvideox_5b_i2v_vap``, ``wan_14b_i2v_vap`` or
``hunyuan_video_t2v``, by default; or ``tiny``, for runs on the CPU). ``--model_structure_config`` overrides the
transformer's fields as in JAX's ``train.py`` (a flat JSON, or its
``"transformer"`` section): ``examples/training/sft/wan/crush_smol_lora/
config_plain.json`` makes Wan2.1-I2V-14B the plain model of the LoRA
recipe. The cache is the JAX trainer's precompute output
(``rank_0/cond_*.npz``, ``lat_*.npz``); its shapes must fit the model
configuration.

The transformer's weights come as in JAX's ``train.py`` (``_build_cogvideox``
:128-191, ``_build_wan`` :193-287, ``_build_hunyuan_video`` :418-470):
``--videoasprompt_mot_name_or_path`` (a finetuned MoT transformer) first;
else the ``transformer/`` component of ``--pretrained_model_name_or_path``
(a directory or a cached hub id; its ``config.json`` sets the structure's
fields under ``--model_structure_config``), a stock CogVideoX or Wan
checkpoint getting its MoT expert cloned from the trunk
(``training.specs``); else random weights from ``--seed``. Only the
transformer loads: the conditions and latents come from the cache. At the
end of the run the trainer exports its weights (``SFTTrainer.export``).

Under ``torchrun`` (``WORLD_SIZE`` > 1) each process starts
``torch.distributed`` from the launcher's environment: NCCL on the card
``cuda:LOCAL_RANK``, or gloo with ``--device cpu``; the world must equal
``data_degree x seq_degree``. Every rank builds the same weights; rank 0
exports.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import typing
from typing import Any, Dict, List, Optional

import torch

from .models.cogvideox.config import CogVideoXMOTConfig
from .models.cogvideox.transformer_mot import CogVideoXTransformer3DMOTModel
from .models.hunyuan_video.config import HunyuanVideoConfig
from .models.hunyuan_video.transformer import HunyuanVideoTransformer3DModel
from .models.loading import load_model
from .models.random_init import build_random
from .models.wan.config import WanMOTConfig
from .models.wan.transformer_mot import WanTransformer3DMOTModel
from .pipelines.cogvideox_i2v_mot import resolve_device
from .training.args import TrainingArgs
from .training.checkpoint import load_safetensors
from .training.specs import build_mot_state_dict_from_base, build_wan_mot_state_dict_from_base
from .training.trainer import SFTTrainer
from .utils.hub import component_config_kwargs, resolve_model_dir

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
    "hunyuan_video": (HunyuanVideoTransformer3DModel, HunyuanVideoConfig, {
        "hunyuan_video_t2v": HunyuanVideoConfig.hunyuan_video_t2v,
        # 2 dual + 2 single blocks, 2 heads of 12, 4 latent channels
        "tiny": HunyuanVideoConfig.tiny,
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


def transformer_dir(base: str) -> Optional[str]:
    """The ``transformer/`` component of a checkpoint (a directory or a
    cached hub id), or None: no ``base``, or no such component."""
    if not base:
        return None
    d = os.path.join(resolve_model_dir(base), "transformer")
    return d if os.path.isdir(d) else None


def transformer_weights(args: TrainingArgs, cfg, base_dir: Optional[str]):
    """The transformer's checkpoint as JAX's family builders pick it, or
    None (random weights): the MoT checkpoint, else the base transformer
    (for CogVideoX and Wan with the expert cloned from the trunk where the
    checkpoint lacks it)."""
    mot_path = args.videoasprompt_mot_name_or_path
    if args.model_name != "hunyuan_video" and mot_path and os.path.exists(mot_path):
        logging.getLogger(__name__).info("loading the MoT transformer from %s", mot_path)
        return load_safetensors(mot_path)
    if base_dir is None:
        return None
    try:
        sd = load_safetensors(base_dir)
    except FileNotFoundError:
        return None
    if args.model_name == "cogvideox":
        return build_mot_state_dict_from_base(sd, cfg)
    if args.model_name == "wan":
        return build_wan_mot_state_dict_from_base(sd, cfg)
    return sd


def build_transformer(args: TrainingArgs, config_name: Optional[str], device: torch.device):
    """The family's transformer at ``config_name`` (the released structure
    when None), in bf16 on the card or f32 on the CPU: loaded from the
    checkpoint ``transformer_weights`` picks, else random from ``--seed``."""
    model_cls, cfg_cls, configs = MODELS[args.model_name]
    config_name = config_name or next(iter(configs))
    if config_name not in configs:
        raise ValueError(f"unknown model_config {config_name!r} for {args.model_name}; "
                         f"valid: {sorted(configs)}")
    base_dir = transformer_dir(args.pretrained_model_name_or_path)
    cfg = configs[config_name](**{**component_config_kwargs(cfg_cls, base_dir),
                                  **structure_overrides(cfg_cls, args.model_structure())})
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    state = transformer_weights(args, cfg, base_dir)
    if state is None:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        return build_random(model_cls, cfg, device, dtype, gen)
    return load_model(model_cls, cfg, state, device, dtype)


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
                             "(cogvideox_5b_i2v_vap, wan_14b_i2v_vap, hunyuan_video_t2v) or tiny")
    return parser


def init_distributed(args: TrainingArgs, device: torch.device):
    """Start ``torch.distributed`` when the launcher (``torchrun``) runs
    more than one process: NCCL on ``cuda:LOCAL_RANK``, gloo on the CPU;
    a group the caller started already is kept. Returns (the device of
    this process, whether this call started the group). Raises when the
    world is not ``data_degree x seq_degree``."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != args.world_size:
        raise ValueError(f"the launcher runs {world} processes, but data_degree x seq_degree = "
                         f"{args.world_size}")
    if world == 1:
        return device, False
    import torch.distributed as dist

    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return device, False
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method="env://",
                            world_size=world, rank=int(os.environ["RANK"]))
    return device, True


def main(argv: Optional[List[str]] = None) -> SFTTrainer:
    ns = vars(_parser().parse_args(argv))
    device = resolve_device(ns.pop("device"))
    config_name = ns.pop("model_config")
    args = TrainingArgs(**ns)
    device, started = init_distributed(args, device)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    trainer = SFTTrainer(args, build_transformer(args, config_name, device))
    try:
        trainer.run()
        if trainer.rank == 0:
            trainer.export()
    finally:
        if started:
            import torch.distributed as dist

            dist.destroy_process_group()
    return trainer


if __name__ == "__main__":
    main()
