"""Train a Video-As-Prompt transformer from clips on disk or a precomputed
cache.

    python -m vap_tpu_torch.train --data_root DATA [--dataset_config training.json] \\
        [--validation_dataset_file validation.json] [--enable_precomputation] \\
        --pretrained_model_name_or_path CKPT --output_dir OUT ...

    python -m vap_tpu_torch.train --precomputation_dir CACHE --output_dir OUT \\
        [--model_name cogvideox|wan|hunyuan_video] \\
        [--training_type video_as_prompt_mot|sft|lora|dpo|control|control_full_finetune] \\
        [--model_structure_config JSON] [--train_steps N] [--lr 1e-5] \\
        [--device cuda|cpu] [--model_config NAME]

    torchrun --nproc_per_node N -m vap_tpu_torch.train ... [--data_degree D] \\
        [--fsdp_degree F] [--seq_degree S] \\
        [--cp_rotate_method allgather|ppermute|ulysses]   # N = D x F x S

With ``--data_root`` or ``--dataset_config`` the trainer reads the clips
(``data/``), bucket-fits and encodes them with the family's text encoder(s)
and VAE (and Wan's image encoder), built as JAX's ``_build_cogvideox``,
``_build_wan`` and ``_build_hunyuan_video`` build them: each component's
weights from ``--pretrained_model_name_or_path/<component>`` (a missing
component raises), random from ``--seed`` only under ``--model_config
tiny`` or without a checkpoint, and never for Wan's VAE at the released
structure, as in JAX; the tokenizer(s) from the checkpoint's
``tokenizer/`` (and ``tokenizer_2/``) through ``transformers``, imported
only then: where it is not installed, the entry point raises and names it
(``main(..., tokenizers=...)`` takes them from the caller instead). With
only ``--precomputation_dir`` no encoder is built.

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
(``training.specs``); else random weights from ``--seed``. At the
end of the run the trainer exports its weights (``SFTTrainer.export``).
``--video_resolution_buckets`` and ``--report_to`` take JAX's forms
(``49x480x720,49x480x832``; ``dummy,wandb``).

``--training_type control`` (``control_lora``) or ``control_full_finetune``
with ``--model_name wan`` trains the control recipe
(``examples/training/control/wan/image_condition/train.sh``) through
``ControlTrainer``: Wan2.1-T2V-1.3B (``--model_config wan_1_3b_t2v`` by
default, ``tiny`` on the CPU), a stock T2V checkpoint's transformer widened
by ``expand_patch_embedding``, UMT5 and the Wan VAE (no image encoder).

Under ``torchrun`` (``WORLD_SIZE`` > 1) each process starts
``torch.distributed`` from the launcher's environment: NCCL on the card
``cuda:LOCAL_RANK``, or gloo with ``--device cpu``; the world must equal
``data_degree x fsdp_degree x seq_degree``. Every rank builds the same
weights (``fsdp_degree > 1`` shards them, HSDP with ``data_degree > 1``);
every rank takes part in the export, rank 0 writes it.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import typing
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from .models.cogvideox.config import CogVideoXMOTConfig
from .models.cogvideox.transformer_mot import CogVideoXTransformer3DMOTModel
from .models.cogvideox.vae import AutoencoderKLCogVideoX, CogVideoXVAEConfig
from .models.hunyuan_video.config import HunyuanVideoConfig
from .models.hunyuan_video.transformer import HunyuanVideoTransformer3DModel
from .models.hunyuan_video.vae import AutoencoderKLHunyuanVideo, HunyuanVideoVAEConfig
from .models.loading import load_model
from .models.random_init import build_random
from .models.text_encoders.clip_text import CLIPTextConfig, CLIPTextModel
from .models.text_encoders.clip_vision import CLIPVisionConfig, CLIPVisionModel
from .models.text_encoders.llama import LlamaConfig, LlamaModel
from .models.text_encoders.t5 import T5Config, T5EncoderModel
from .models.wan.config import WanMOTConfig
from .models.wan.transformer_mot import WanTransformer3DMOTModel
from .models.wan.vae import AutoencoderKLWan, WanVAEConfig
from .pipelines.cogvideox_i2v_mot import resolve_device
from .training.args import TrainingArgs
from .training.checkpoint import load_safetensors
from .training.specs import (build_mot_state_dict_from_base, build_wan_mot_state_dict_from_base,
                             get_model_spec_cls)
from .training.trainer import SFTTrainer
from .utils.hub import component_config_kwargs, resolve_model_dir
from .utils.logging import get_logger

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
        "wan_1_3b_t2v": WanMOTConfig.wan_1_3b_t2v,
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

# per model_name: its encoders (component name, class, config class, the
# released configuration, the tiny one fitted to a tiny transformer's config)
ENCODERS = {
    "cogvideox": (
        ("vae", AutoencoderKLCogVideoX, CogVideoXVAEConfig, CogVideoXVAEConfig,
         lambda t: CogVideoXVAEConfig.tiny(latent_channels=t.out_channels)),
        ("text_encoder", T5EncoderModel, T5Config, T5Config.t5_xxl,
         lambda t: T5Config.tiny(d_model=t.text_embed_dim)),
    ),
    "wan": (
        ("vae", AutoencoderKLWan, WanVAEConfig, WanVAEConfig,
         lambda t: WanVAEConfig.tiny(z_dim=t.out_channels,
                                     latents_mean=(0.0,) * t.out_channels,
                                     latents_std=(1.0,) * t.out_channels)),
        ("text_encoder", T5EncoderModel, T5Config, T5Config.umt5_xxl,
         lambda t: T5Config.tiny(d_model=t.text_dim, per_layer_relative_bias=True)),
        ("image_encoder", CLIPVisionModel, CLIPVisionConfig, CLIPVisionConfig,
         lambda t: CLIPVisionConfig.tiny(hidden_size=t.image_dim)),
    ),
    "hunyuan_video": (
        ("vae", AutoencoderKLHunyuanVideo, HunyuanVideoVAEConfig,
         HunyuanVideoVAEConfig.hunyuan_video,
         lambda t: HunyuanVideoVAEConfig.tiny(latent_channels=t.out_channels)),
        ("text_encoder", LlamaModel, LlamaConfig, LlamaConfig.llava_llama_8b,
         lambda t: LlamaConfig.tiny(hidden_size=t.text_embed_dim)),
        ("text_encoder_2", CLIPTextModel, CLIPTextConfig, CLIPTextConfig.clip_vit_l,
         lambda t: CLIPTextConfig.tiny(hidden_size=t.pooled_projection_dim)),
    ),
}
# the tokenizers each family's spec takes, by the checkpoint's directory name
# the control trainer's base (JAX's _build_wan under control*): the T2V
# model, no MoT block, no image context, before its input layer is widened
CONTROL_CONFIGS = {
    "wan_1_3b_t2v": WanMOTConfig.wan_1_3b_t2v,
    # two blocks, the 16 latent channels of Wan's VAE
    "tiny": lambda **kw: WanMOTConfig.tiny(**{
        "in_channels": 16, "out_channels": 16, "block_idx_with_mot_ref": (), "image_dim": None,
        "added_kv_proj_dim": None, **kw}),
}
TOKENIZERS = {"cogvideox": {"tokenizer": "tokenizer"}, "wan": {"tokenizer": "tokenizer"},
              "hunyuan_video": {"tokenizer": "tokenizer", "clip_tokenizer": "tokenizer_2"}}


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
        get_logger(__name__).info("loading the MoT transformer from %s", mot_path)
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
    checkpoint ``transformer_weights`` picks, else random from ``--seed``.
    For CogVideoX, as JAX's ``_build_cogvideox`` (train.py:143-154):
    ``--ablation_single_branch`` leaves no MoT block,
    ``--ablation_single_encoder`` and ``--ablation_residual_addition`` set
    the structure's fields, and
    ``--reference_train_mode`` sets the config's unless the structure JSON
    sets it."""
    if args.is_control:
        return build_control_transformer(args, config_name, device)
    model_cls, cfg_cls, configs = MODELS[args.model_name]
    config_name = config_name or next(iter(configs))
    if config_name not in configs:
        raise ValueError(f"unknown model_config {config_name!r} for {args.model_name}; "
                         f"valid: {sorted(configs)}")
    base_dir = transformer_dir(args.pretrained_model_name_or_path)
    fields = {**component_config_kwargs(cfg_cls, base_dir),
              **structure_overrides(cfg_cls, args.model_structure())}
    if args.model_name == "cogvideox":
        if args.ablation_single_branch:  # the plain trunk: no MoT block
            fields["block_idx_with_mot_ref"] = ()
        if args.ablation_single_encoder:
            fields["ablation_single_encoder"] = True
        if args.ablation_residual_addition:
            fields["ablation_residual_addition"] = True
        if fields.get("reference_train_mode") is None:  # the flag, unless the structure says
            fields["reference_train_mode"] = args.reference_train_mode
    cfg = configs[config_name](**fields)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    state = transformer_weights(args, cfg, base_dir)
    if state is None:
        gen = torch.Generator(device=device).manual_seed(args.seed)
        return build_random(model_cls, cfg, device, dtype, gen)
    return load_model(model_cls, cfg, state, device, dtype)


def build_control_transformer(args: TrainingArgs, config_name: Optional[str],
                              device: torch.device) -> WanTransformer3DMOTModel:
    """The control trainer's transformer (JAX's ``_build_wan`` under
    ``control*``, train.py:211-235): Wan2.1-T2V-1.3B (``wan_1_3b_t2v``, or
    ``tiny``) with the checkpoint's ``config.json`` and structure fields
    (``block_idx_with_mot_ref`` dropped), its weights from the stock T2V
    checkpoint's ``transformer/`` or random from ``--seed``, then the input
    layer widened to ``control_in_channels`` (``expand_patch_embedding``)."""
    from .models.wan.transformer_mot import expand_patch_embedding
    from .training.control_trainer import control_in_channels

    config_name = config_name or "wan_1_3b_t2v"
    if config_name not in CONTROL_CONFIGS:
        raise ValueError(f"unknown model_config {config_name!r} for control training; "
                         f"valid: {sorted(CONTROL_CONFIGS)}")
    base_dir = transformer_dir(args.pretrained_model_name_or_path)
    fields = {**component_config_kwargs(WanMOTConfig, base_dir),
              **structure_overrides(WanMOTConfig, args.model_structure())}
    fields.pop("block_idx_with_mot_ref", None)
    cfg = CONTROL_CONFIGS[config_name](**fields)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    state = None
    if base_dir is not None:
        try:
            state = load_safetensors(base_dir)
        except FileNotFoundError:
            state = None
    if state is None:
        model = build_random(WanTransformer3DMOTModel, cfg, device, dtype,
                             torch.Generator(device=device).manual_seed(args.seed))
    else:
        model = load_model(WanTransformer3DMOTModel, cfg, state, device, dtype)
    new_in = control_in_channels(cfg.in_channels, args.frame_conditioning_concatenate_mask)
    return expand_patch_embedding(model, new_in - cfg.in_channels)


def load_tokenizers(args: TrainingArgs) -> Dict[str, Any]:
    """The spec's tokenizer(s) from the checkpoint's ``tokenizer/`` (and
    ``tokenizer_2/``) directories through ``transformers``, which is
    imported only here; raises, naming what is missing, where it is not
    installed or the checkpoint has no such directory."""
    base = args.pretrained_model_name_or_path
    dirs = {key: os.path.join(resolve_model_dir(base), name) if base else None
            for key, name in TOKENIZERS[args.model_name].items()}
    missing = [d or f"{TOKENIZERS[args.model_name][k]}/ (no --pretrained_model_name_or_path)"
               for k, d in dirs.items() if not (d and os.path.isdir(d))]
    if missing:
        raise FileNotFoundError(f"training from data needs the tokenizer(s): no {missing}")
    try:
        from transformers import AutoTokenizer
    except ImportError:
        raise RuntimeError("training from data reads its tokenizer(s) with the transformers "
                           "package, which is not installed; pass tokenizers to main() or "
                           "build the spec yourself") from None
    return {key: AutoTokenizer.from_pretrained(d) for key, d in dirs.items()}


def build_spec(args: TrainingArgs, model: nn.Module, config_name: Optional[str],
               tokenizers: Dict[str, Any]):
    """The family's spec around ``model``: its encoders (JAX's family
    builders) from ``--pretrained_model_name_or_path/<component>``, in the
    model's dtype on its device. A component the checkpoint lacks raises;
    random weights from ``--seed`` (each logged) only under ``tiny`` or
    with no checkpoint at all, and never for Wan's VAE at the released
    structure (JAX's ``_build_wan`` refuses it too)."""
    p = next(model.parameters())
    device, dtype = p.device, p.dtype
    base = args.pretrained_model_name_or_path
    root = resolve_model_dir(base) if base else None
    tiny = config_name == "tiny"
    encoders = {}
    for i, (name, cls, cfg_cls, release, small) in enumerate(ENCODERS[args.model_name]):
        if args.is_control and name == "image_encoder":
            continue  # the T2V control base reads no image states (train.py:269-272)
        comp = os.path.join(root, name) if root else None
        comp = comp if comp and os.path.isdir(comp) else None
        cfg = small(model.config) if tiny else release(**component_config_kwargs(cfg_cls, comp))
        try:
            state = load_safetensors(comp) if comp else None
        except FileNotFoundError:
            state = None
        if state is None:
            if not tiny and (base or (args.model_name, name) == ("wan", "vae")):
                raise FileNotFoundError(
                    f"{args.model_name} training from data needs the {name} weights: no "
                    f"safetensors under {comp or os.path.join(root or '<no checkpoint>', name)}")
            get_logger(__name__).warning(
                "random-initialized %s from --seed %d (no checkpoint)", name, args.seed)
            gen = torch.Generator(device=device).manual_seed(args.seed + 1 + i)
            encoders[name] = build_random(cls, cfg, device, dtype, gen)
        else:
            encoders[name] = load_model(cls, cfg, state, device, dtype)
    return get_model_spec_cls(args.model_name, args.training_type)(
        model, dtype=dtype, device=device, **tokenizers, **encoders)


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("vap_tpu_torch.train")
    hints = typing.get_type_hints(TrainingArgs)
    for f in dataclasses.fields(TrainingArgs):
        hint = hints[f.name]
        if hint is bool:
            parser.add_argument(f"--{f.name}", action=argparse.BooleanOptionalAction,
                                default=f.default)
        elif f.name in _LIST_FLAGS:
            parser.add_argument(f"--{f.name}", type=_LIST_FLAGS[f.name], default=f.default)
        else:
            kind = next((t for t in typing.get_args(hint) if t is not type(None)), hint)
            parser.add_argument(f"--{f.name}", type=kind, default=f.default)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    parser.add_argument("--model_config", default=None,
                        help="the model's configuration: its released structure by default "
                             "(cogvideox_5b_i2v_vap, wan_14b_i2v_vap, hunyuan_video_t2v) or tiny")
    return parser


def _buckets(text: str):
    """JAX's bucket flag: ``49x480x720,49x480x832``."""
    return tuple(tuple(int(x) for x in b.split("x")) for b in text.split(","))


_LIST_FLAGS = {"video_resolution_buckets": _buckets, "image_resolution_buckets": _buckets,
               "report_to": lambda text: tuple(text.split(","))}


def init_distributed(args: TrainingArgs, device: torch.device):
    """Start ``torch.distributed`` when the launcher (``torchrun``) runs
    more than one process: NCCL on ``cuda:LOCAL_RANK``, gloo on the CPU;
    a group the caller started already is kept. Returns (the device of
    this process, whether this call started the group). Raises when the
    world is not ``data_degree x fsdp_degree x seq_degree``."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != args.world_size:
        raise ValueError(f"the launcher runs {world} processes, but data_degree x fsdp_degree x "
                         f"seq_degree = {args.world_size}")
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


def main(argv: Optional[List[str]] = None,
         tokenizers: Optional[Dict[str, Any]] = None) -> SFTTrainer:
    """Parse ``argv``, build the transformer (and, to train from data, the
    spec with its encoders and ``tokenizers``, else those of the
    checkpoint), train, export."""
    ns = vars(_parser().parse_args(argv))
    device = resolve_device(ns.pop("device"))
    config_name = ns.pop("model_config")
    args = TrainingArgs(**ns)
    device, started = init_distributed(args, device)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    model = build_transformer(args, config_name, device)
    spec = None
    if args.data_root or args.dataset_config:
        spec = build_spec(args, model, config_name,
                          tokenizers if tokenizers is not None else load_tokenizers(args))
    if args.is_control:
        from .training.control_trainer import ControlTrainer

        trainer = ControlTrainer(args, model, spec)
    else:
        trainer = SFTTrainer(args, model, spec)
    try:
        trainer.run()
        trainer.export()  # every rank gathers its shards; rank 0 writes
    finally:
        if started:
            import torch.distributed as dist

            dist.destroy_process_group()
    return trainer


if __name__ == "__main__":
    main()
