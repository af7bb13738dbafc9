"""Shared pieces of the data-path tests of the port: tiny clips on disk, a
VAP data directory, a fake tokenizer, and tiny CogVideoX / Wan / Hunyuan
specs with the same weights on both sides (the JAX package's initialisers,
carried into the port by ``vap_tpu_torch.convert``)."""

import json
import os

import numpy as np


def _share_the_cores():
    """Under pytest-xdist each worker process gives torch's intra-op pool
    the machine's cores / workers threads (at least 2), where torch's
    default, every core in every worker, oversubscribes the cores: six
    workers on eight cores ran the port's files 4x slower. Every worker
    imports this module while it collects the suite; a run without xdist
    keeps torch's default."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers:
        import torch

        torch.set_num_threads(max(2, (os.cpu_count() or 2) // int(workers)))


_share_the_cores()


def rank_threads(ranks):
    """Torch threads for each of ``ranks`` processes a test spawns: the
    machine's cores shared among the pytest-xdist workers and the ranks
    (at least 1)."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, (os.cpu_count() or 1) // (workers * ranks))

CLIP_SHAPE = (9, 32, 32, 3)


class FakeTokenizer:
    """Deterministic character ids, padded to max_length with 0 (masked)."""

    def __init__(self, vocab=127):
        self.vocab = vocab

    def __call__(self, texts, padding=None, max_length=16, truncation=True,
                 add_special_tokens=True, return_tensors="np"):
        ids = np.zeros((len(texts), max_length), np.int32)
        for i, t in enumerate(texts):
            for j, ch in enumerate(str(t)[:max_length]):
                ids[i, j] = (ord(ch) * 5 + j) % (self.vocab - 1) + 1
        return {"input_ids": ids, "attention_mask": (ids > 0).astype(np.int32)}


def write_clip(path, seed, shape=CLIP_SHAPE, fps=16):
    """A random clip written with cv2 (mp4v), as the JAX tests write theirs."""
    import cv2

    frames = (np.random.default_rng(seed).uniform(0, 1, shape) * 255).astype(np.uint8)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (shape[2], shape[1]))
    for f in frames:
        writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    writer.release()
    return str(path)


def write_csv(path, rows):
    import csv

    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return str(path)


def vap_data_dir(root, n=4, shape=CLIP_SHAPE, fps=(16,), kinds=("fx",)):
    """n clips and a vap_data.csv over them (each row's reference is the
    next clip), a benchmark.csv of one row and a validation.json over it."""
    os.makedirs(root, exist_ok=True)
    vids = []
    for i in range(n):
        write_clip(os.path.join(root, f"v{i}.mp4"), i, shape, fps[i % len(fps)])
        vids.append(f"v{i}.mp4")
    rows = [{"video_paths": v, "tar_video_caption": f"This video shows clip {i}",
             "ref_video_paths": json.dumps([vids[(i + 1) % n]]), "kind": kinds[i % len(kinds)],
             "split": "train", "reference_alignment_score": 9.0} for i, v in enumerate(vids)]
    write_csv(os.path.join(root, "vap_data.csv"), rows)
    write_csv(os.path.join(root, "benchmark.csv"), [
        {"video_paths": vids[0], "tar_video_caption": "a cat",
         "ref_video_paths": json.dumps([vids[1]]), "ref_video_caption": "explode it",
         "kind": kinds[0]}])
    return str(root)


def write_validation_json(path, csv="benchmark.csv", **gen):
    with open(path, "w") as f:
        json.dump({"csv": csv, **gen}, f)
    return str(path)


# ---------------------------------------------------------------------------
# tiny specs, the same weights on both sides
# ---------------------------------------------------------------------------

def _jitter(tree, seed):
    """Every leaf moved off its initial value, so no bias is zero."""
    import jax

    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.asarray(x, np.float32)
                        + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32), tree)


def _load(module, convert_fn, params, cfg):
    module.load_state_dict(convert_fn(params, cfg))
    return module.eval()


# the trainer's tiny CogVideoX (vap_tpu_torch.train MODELS "tiny")
COG_CFG = dict(in_channels=8, out_channels=4, num_layers=3, block_idx_with_mot_ref=(0, 1))


def cogvideox_specs(tokenizer=None):
    """(port spec, JAX spec): tiny CogVideoX MoT, T5 and VAE."""
    import jax
    import jax.numpy as jnp
    import torch

    from vap_tpu.models.cogvideox import CogVideoXMOTConfig as JaxMOTConfig
    from vap_tpu.models.cogvideox import init_cogvideox_mot
    from vap_tpu.models.cogvideox.vae import CogVideoXVAEConfig as JaxVAEConfig
    from vap_tpu.models.cogvideox.vae import init_cogvideox_vae
    from vap_tpu.models.text_encoders import T5Config as JaxT5Config
    from vap_tpu.models.text_encoders import init_t5_encoder
    from vap_tpu.training import specs as jspecs
    from vap_tpu_torch import convert
    from vap_tpu_torch.models.cogvideox.config import CogVideoXMOTConfig
    from vap_tpu_torch.models.cogvideox.transformer_mot import CogVideoXTransformer3DMOTModel
    from vap_tpu_torch.models.cogvideox.vae import AutoencoderKLCogVideoX, CogVideoXVAEConfig
    from vap_tpu_torch.models.text_encoders.t5 import T5Config, T5EncoderModel
    from vap_tpu_torch.training import specs

    tokenizer = tokenizer or FakeTokenizer()
    key = jax.random.PRNGKey(0)
    t_cfg, jt_cfg = CogVideoXMOTConfig.tiny(**COG_CFG), JaxMOTConfig.tiny(**COG_CFG)
    txt_cfg = T5Config.tiny(d_model=t_cfg.text_embed_dim)
    jtxt_cfg = JaxT5Config.tiny(d_model=t_cfg.text_embed_dim)
    vae_cfg, jvae_cfg = CogVideoXVAEConfig.tiny(), JaxVAEConfig.tiny()
    params = {"transformer": _jitter(init_cogvideox_mot(key, jt_cfg), 0),
              "text_encoder": _jitter(init_t5_encoder(key, jtxt_cfg), 1),
              "vae": _jitter(jax.jit(init_cogvideox_vae, static_argnums=1)(key, jvae_cfg), 2)}
    port = specs.CogVideoXSpec(
        _load(CogVideoXTransformer3DMOTModel(t_cfg), convert.from_jax_transformer,
              params["transformer"], t_cfg),
        tokenizer, dtype=torch.float32, device="cpu",
        vae=_load(AutoencoderKLCogVideoX(vae_cfg), convert.from_jax_vae, params["vae"], vae_cfg),
        text_encoder=_load(T5EncoderModel(txt_cfg), convert.from_jax_t5, params["text_encoder"],
                           txt_cfg))
    ref = jspecs.CogVideoXSpec(jt_cfg, jvae_cfg, jtxt_cfg, jax.tree.map(jnp.asarray, params),
                               tokenizer, dtype=jnp.float32)
    return port, ref


WAN_CFG = dict(in_channels=12, out_channels=4, text_dim=32, image_dim=24)


def wan_specs():
    """(port spec, JAX spec): tiny Wan MoT (12-channel conditioning), UMT5,
    CLIP vision and the Wan VAE."""
    import jax
    import jax.numpy as jnp
    import torch

    from vap_tpu.models.text_encoders import clip_vision as jclip
    from vap_tpu.models.text_encoders import t5 as jt5
    from vap_tpu.models.wan import vae as jvae
    from vap_tpu.models.wan.config import WanMOTConfig as JaxWanConfig
    from vap_tpu.training import specs as jspecs
    from vap_tpu_torch import convert
    from vap_tpu_torch.models.random_init import build_random
    from vap_tpu_torch.models.text_encoders.clip_vision import CLIPVisionConfig, CLIPVisionModel
    from vap_tpu_torch.models.text_encoders.t5 import T5Config, T5EncoderModel
    from vap_tpu_torch.models.wan.config import WanMOTConfig
    from vap_tpu_torch.models.wan.transformer_mot import WanTransformer3DMOTModel
    from vap_tpu_torch.models.wan.vae import AutoencoderKLWan, WanVAEConfig
    from vap_tpu_torch.training import specs

    key = jax.random.PRNGKey(0)
    t_cfg, jt_cfg = WanMOTConfig.tiny(**WAN_CFG), JaxWanConfig.tiny(**WAN_CFG)
    txt_cfg = T5Config.tiny(per_layer_relative_bias=True)
    jtxt_cfg = jt5.T5Config.tiny(per_layer_relative_bias=True)
    clip_cfg, jclip_cfg = CLIPVisionConfig.tiny(), jclip.CLIPVisionConfig.tiny()
    vae_cfg, jvae_cfg = WanVAEConfig.tiny(), jvae.WanVAEConfig.tiny()
    # the encoders alone: prepare_* never reads the transformer, random on both sides
    params = {"text_encoder": _jitter(jt5.init_t5_encoder(key, jtxt_cfg), 1),
              "image_encoder": _jitter(jclip.init_clip_vision(key, jclip_cfg), 2),
              "vae": _jitter(jax.jit(jvae.init_wan_vae, static_argnums=1)(key, jvae_cfg), 3)}
    port = specs.WanSpec(
        build_random(WanTransformer3DMOTModel, t_cfg, "cpu", torch.float32,
                     torch.Generator().manual_seed(0)),
        FakeTokenizer(), dtype=torch.float32, device="cpu",
        vae=_load(AutoencoderKLWan(vae_cfg), convert.from_jax_wan_vae, params["vae"], vae_cfg),
        text_encoder=_load(T5EncoderModel(txt_cfg), convert.from_jax_t5, params["text_encoder"],
                           txt_cfg),
        image_encoder=_load(CLIPVisionModel(clip_cfg), convert.from_jax_clip_vision,
                            params["image_encoder"], clip_cfg))
    ref = jspecs.WanSpec(jt_cfg, jvae_cfg, jtxt_cfg, jax.tree.map(jnp.asarray, params),
                         FakeTokenizer(), clip_cfg=jclip_cfg, dtype=jnp.float32)
    return port, ref


def hunyuan_specs():
    """(port spec, JAX spec): tiny HunyuanVideo, LLaMA, CLIP text and VAE."""
    import jax
    import jax.numpy as jnp
    import torch

    from vap_tpu.models.hunyuan_video import HunyuanVideoConfig as JaxConfig
    from vap_tpu.models.hunyuan_video.vae import HunyuanVideoVAEConfig as JaxVAEConfig
    from vap_tpu.models.hunyuan_video.vae import init_hunyuan_vae
    from vap_tpu.models.text_encoders.clip_text import CLIPTextConfig as JaxCLIPConfig
    from vap_tpu.models.text_encoders.clip_text import init_clip_text
    from vap_tpu.models.text_encoders.llama import LlamaConfig as JaxLlamaConfig
    from vap_tpu.models.text_encoders.llama import init_llama
    from vap_tpu.training import specs as jspecs
    from vap_tpu_torch import convert
    from vap_tpu_torch.models.hunyuan_video.config import HunyuanVideoConfig
    from vap_tpu_torch.models.hunyuan_video.transformer import HunyuanVideoTransformer3DModel
    from vap_tpu_torch.models.hunyuan_video.vae import (AutoencoderKLHunyuanVideo,
                                                        HunyuanVideoVAEConfig)
    from vap_tpu_torch.models.random_init import build_random
    from vap_tpu_torch.models.text_encoders.clip_text import CLIPTextConfig, CLIPTextModel
    from vap_tpu_torch.models.text_encoders.llama import LlamaConfig, LlamaModel
    from vap_tpu_torch.training import specs

    vae_cfg = JaxVAEConfig.tiny()
    t_cfg = JaxConfig.tiny(in_channels=vae_cfg.latent_channels,
                           out_channels=vae_cfg.latent_channels)
    llama_cfg = JaxLlamaConfig.tiny(hidden_size=t_cfg.text_embed_dim, num_attention_heads=2,
                                    num_key_value_heads=2, vocab_size=64)
    clip_cfg = JaxCLIPConfig.tiny(hidden_size=t_cfg.pooled_projection_dim, num_attention_heads=4)
    key = jax.random.PRNGKey(0)
    # the encoders alone: prepare_* never reads the transformer, random on both sides
    params = {"vae": init_hunyuan_vae(jax.random.fold_in(key, 1), vae_cfg, jnp.float32),
              "text_encoder": init_llama(jax.random.fold_in(key, 2), llama_cfg, jnp.float32),
              "text_encoder_2": init_clip_text(jax.random.fold_in(key, 3), clip_cfg, jnp.float32)}
    host = jax.tree.map(np.asarray, params)
    parts = {}
    for name, cls, cfg, conv in (
            ("vae", AutoencoderKLHunyuanVideo, HunyuanVideoVAEConfig(**vars(vae_cfg)),
             convert.from_jax_hunyuan_vae),
            ("text_encoder", LlamaModel, LlamaConfig(**vars(llama_cfg)), convert.from_jax_llama),
            ("text_encoder_2", CLIPTextModel, CLIPTextConfig(**vars(clip_cfg)),
             convert.from_jax_clip_text)):
        parts[name] = _load(cls(cfg), conv, host[name], cfg)
    tok = FakeTokenizer(50)
    transformer = build_random(HunyuanVideoTransformer3DModel, HunyuanVideoConfig(**vars(t_cfg)),
                               "cpu", torch.float32, torch.Generator().manual_seed(0))
    port = specs.HunyuanVideoSpec(transformer, tok, tok, dtype=torch.float32, device="cpu",
                                  **parts)
    ref = jspecs.HunyuanVideoSpec(t_cfg, vae_cfg, llama_cfg, params, tok, clip_text_cfg=clip_cfg,
                                  dtype=jnp.float32, clip_tokenizer=tok)
    return port, ref


def assert_close_to_scale(got, want, rel=1e-4):
    """|got - want| within rel of max|want|, every key of ``want``."""
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k, w in want.items():
        g, w = np.asarray(got[k]), np.asarray(w)
        assert g.shape == w.shape, (k, g.shape, w.shape)
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(g, w, atol=rel * scale, rtol=0, err_msg=k)
