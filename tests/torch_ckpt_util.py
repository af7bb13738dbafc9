"""Tiny diffusers-layout checkpoint directories for the port's checkpoint
tests, made from the JAX package's initializers and a numpy seed.

``write_component`` lays one component out as a diffusers / transformers
writer does: ``config.json`` (every field of the configuration, plus a
``_class_name`` the readers ignore) and the weights, in shards with an
index when ``shards`` is above 1. The CogVideoX and Wan directories hold
every component their ``build_pipeline`` and JAX's ``train.py`` builders
read.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import torch

from vap_tpu_torch import convert
from vap_tpu_torch.utils.safetensors import save_sharded


def jitter(tree, seed, scale=0.05):
    """Every leaf as numpy float32 plus ``scale`` times a seeded normal."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.asarray(x, np.float32)
                        + scale * rng.standard_normal(np.shape(x)).astype(np.float32), tree)


def init(fn, jcfg, seed):
    """The JAX initializer's tree, jittered (no plain 0 or 1 left)."""
    return jitter(jax.jit(fn, static_argnums=1)(jax.random.PRNGKey(seed), jcfg), seed)


def config_json(cfg, class_name: str) -> dict:
    out = {"_class_name": class_name, "_diffusers_version": "0.0.0"}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        out[f.name] = json.loads(json.dumps(v))  # tuples -> lists
    return out


def write_component(root, name, sd, cfg, class_name, shards=1, file="diffusion_pytorch_model",
                    dtype=torch.float32):
    """``root/name/`` with ``config.json`` and ``sd`` ({key: tensor or array})."""
    d = os.path.join(str(root), name)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(config_json(cfg, class_name), f)
    tensors = {k: torch.as_tensor(np.asarray(v)).to(dtype) for k, v in sd.items()}
    total = sum(t.numel() * t.element_size() for t in tensors.values())
    save_sharded(tensors, d, name=file, max_shard_bytes=total // shards + 1 if shards > 1
                 else total + 1)
    return d


def cogvideox_dir(root, t_cfg, jt_cfg, vae_cfg, jvae_cfg, txt_cfg, jtxt_cfg, seed=0, stock=False,
                  dtype=torch.float32):
    """A CogVideoX checkpoint directory: transformer (MoT, or with
    ``stock`` the trunk alone, every ``_mot_ref`` key dropped), vae and
    text_encoder. Returns {component: diffusers state dict (numpy)}."""
    from vap_tpu.models.cogvideox import init_cogvideox_mot
    from vap_tpu.models.cogvideox.vae import init_cogvideox_vae
    from vap_tpu.models.text_encoders.t5 import init_t5_encoder

    sds = {
        "transformer": convert.from_jax_transformer(init(init_cogvideox_mot, jt_cfg, seed), t_cfg),
        "vae": convert.from_jax_vae(init(init_cogvideox_vae, jvae_cfg, seed + 1), vae_cfg),
        "text_encoder": convert.from_jax_t5(init(init_t5_encoder, jtxt_cfg, seed + 2), txt_cfg),
    }
    if stock:
        sds["transformer"] = {k: v for k, v in sds["transformer"].items() if "_mot_ref" not in k}
    write_component(root, "transformer", sds["transformer"], t_cfg,
                    "CogVideoXTransformer3DMOTModel", shards=3, dtype=dtype)
    write_component(root, "vae", sds["vae"], vae_cfg, "AutoencoderKLCogVideoX", dtype=dtype)
    write_component(root, "text_encoder", sds["text_encoder"], txt_cfg, "T5EncoderModel",
                    shards=2, file="model", dtype=dtype)
    return {k: {n: t.numpy() for n, t in v.items()} for k, v in sds.items()}


def wan_dir(root, t_cfg, jt_cfg, vae_cfg, jvae_cfg, txt_cfg, jtxt_cfg, clip_cfg, jclip_cfg, seed=0,
            stock=False, dtype=torch.float32):
    """A Wan checkpoint directory: transformer (MoT, or the trunk alone with
    ``stock``), vae, text_encoder (UMT5) and image_encoder (CLIP)."""
    from vap_tpu.models.text_encoders.clip_vision import init_clip_vision
    from vap_tpu.models.text_encoders.t5 import init_t5_encoder
    from vap_tpu.models.wan import init_wan_mot
    from vap_tpu.models.wan.vae import init_wan_vae

    sds = {
        "transformer": convert.from_jax_wan_transformer(init(init_wan_mot, jt_cfg, seed), t_cfg),
        "vae": convert.from_jax_wan_vae(init(init_wan_vae, jvae_cfg, seed + 1), vae_cfg),
        "text_encoder": convert.from_jax_t5(init(init_t5_encoder, jtxt_cfg, seed + 2), txt_cfg),
        "image_encoder": convert.from_jax_clip_vision(init(init_clip_vision, jclip_cfg, seed + 3),
                                                      clip_cfg),
    }
    if stock:
        sds["transformer"] = {k: v for k, v in sds["transformer"].items() if "_mot_ref" not in k}
    write_component(root, "transformer", sds["transformer"], t_cfg, "WanTransformer3DMOTModel",
                    shards=2, dtype=dtype)
    write_component(root, "vae", sds["vae"], vae_cfg, "AutoencoderKLWan", dtype=dtype)
    write_component(root, "text_encoder", sds["text_encoder"], txt_cfg, "UMT5EncoderModel",
                    file="model", dtype=dtype)
    write_component(root, "image_encoder", sds["image_encoder"], clip_cfg,
                    "CLIPVisionModelWithProjection", file="model", dtype=dtype)
    return {k: {n: t.numpy() for n, t in v.items()} for k, v in sds.items()}
