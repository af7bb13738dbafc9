"""Pipelines built from a checkpoint directory: the port's ``build_pipeline``
(``vap_tpu_torch/infer/cog_vap.py``, ``infer/wan_vap.py``) against the JAX
package's (``infer/cog_vap.py``, ``infer/wan_vap.py``) on the same tiny
directories: every component with its ``config.json`` (every field, as a
diffusers writer leaves it) and its weights in shards with an index. The
outputs agree within the tolerance of the pipelines' parity tests
(``test_torch_pipeline.py``, ``test_torch_wan_pipeline.py``); a PEFT LoRA
fused at load and the per-component ``*_id`` overrides agree as well.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infer import cog_vap as jax_cog
from infer import wan_vap as jax_wan
from torch_ckpt_util import cogvideox_dir, wan_dir, write_component
from vap_tpu.models.cogvideox import CogVideoXMOTConfig as JaxMOTConfig
from vap_tpu.models.cogvideox.vae import CogVideoXVAEConfig as JaxVAEConfig
from vap_tpu.models.text_encoders import T5Config as JaxT5Config
from vap_tpu.models.text_encoders.clip_vision import CLIPVisionConfig as JaxCLIPConfig
from vap_tpu.models.wan.config import WanMOTConfig as JaxWanConfig
from vap_tpu.models.wan.vae import WanVAEConfig as JaxWanVAEConfig
from vap_tpu.training import checkpoint as jckpt
from vap_tpu_torch.infer import cog_vap, wan_vap
from vap_tpu_torch.models.cogvideox.config import CogVideoXMOTConfig
from vap_tpu_torch.models.cogvideox.vae import CogVideoXVAEConfig
from vap_tpu_torch.models.text_encoders.clip_vision import CLIPVisionConfig
from vap_tpu_torch.models.text_encoders.t5 import T5Config
from vap_tpu_torch.models.wan.config import WanMOTConfig
from vap_tpu_torch.models.wan.vae import WanVAEConfig
from vap_tpu_torch.training import checkpoint as tckpt

COG = dict(in_channels=8, out_channels=4, num_layers=3, block_idx_with_mot_ref=(0, 1),
           use_learned_positional_embeddings=True)
WAN = dict(in_channels=12, out_channels=4, text_dim=32, image_dim=24)
H = W = 64
WAN_HW = 32
F = 9


class FakeTokenizer:
    """Deterministic character ids, padded to max_length with 0."""

    def __call__(self, texts, padding=None, max_length=16, truncation=True,
                 add_special_tokens=True, return_tensors="np"):
        ids = np.zeros((len(texts), max_length), np.int32)
        for i, t in enumerate(texts):
            for j, ch in enumerate(t[:max_length]):
                ids[i, j] = (ord(ch) * 7 + j) % 127 + 1
        return {"input_ids": ids, "attention_mask": (ids > 0).astype(np.int32)}


def _cog_configs():
    t = CogVideoXMOTConfig.tiny(**COG)
    return (t, JaxMOTConfig.tiny(**COG), CogVideoXVAEConfig.tiny(), JaxVAEConfig.tiny(),
            T5Config.tiny(d_model=t.text_embed_dim), JaxT5Config.tiny(d_model=t.text_embed_dim))


def _wan_configs():
    t = WanMOTConfig.tiny(**WAN)
    return (t, JaxWanConfig.tiny(**WAN), WanVAEConfig.tiny(), JaxWanVAEConfig.tiny(),
            T5Config.tiny(per_layer_relative_bias=True),
            JaxT5Config.tiny(per_layer_relative_bias=True), CLIPVisionConfig.tiny(),
            JaxCLIPConfig.tiny())


@pytest.fixture(scope="module")
def cog_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("cogvideox_vap")
    return str(root), cogvideox_dir(root, *_cog_configs(), seed=0)


@pytest.fixture(scope="module")
def wan_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("wan_vap")
    return str(root), wan_dir(root, *_wan_configs(), seed=0)


def _cog_args():
    rng = np.random.default_rng(0)
    return dict(
        image=rng.uniform(-1, 1, (H, W, 3)).astype(np.float32),
        prompt="a cat", ref_videos=[rng.uniform(-1, 1, (F, H, W, 3)).astype(np.float32)],
        prompt_mot_ref=["explode it"], height=H, width=W, num_frames=F,
        num_inference_steps=3, guidance_scale=6.0, use_dynamic_cfg=True,
        max_sequence_length=6,
    ), rng.standard_normal((1, 3, 4, H // 8, W // 8)).astype(np.float32)


def _wan_args():
    rng = np.random.default_rng(0)
    return dict(
        image=rng.uniform(-1, 1, (WAN_HW, WAN_HW, 3)).astype(np.float32),
        prompt="a cat", ref_videos=[rng.uniform(-1, 1, (F, WAN_HW, WAN_HW, 3)).astype(np.float32)],
        prompt_mot_ref=["explode it"], height=WAN_HW, width=WAN_HW, num_frames=F,
        num_inference_steps=3, guidance_scale=5.0, max_sequence_length=8,
    ), rng.standard_normal((1, 3, WAN_HW // 8, WAN_HW // 8, 4)).astype(np.float32)


def _run_pair(port, ref, args, latents, output_type, atol):
    ref.tokenizer = FakeTokenizer()  # JAX's smoke checkpoints carry no tokenizer either
    want = np.asarray(ref(**args, latents=jnp.asarray(latents), output_type=output_type))
    got = port(**args, latents=torch.from_numpy(latents), output_type=output_type)
    got = got.numpy() if output_type == "latent" else got
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=atol, rtol=1e-5)
    return got


def _assert_state(module, sd):
    for k, v in module.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(sd[k]), err_msg=k)


@pytest.mark.parametrize("output_type", ["latent", "np"])
def test_cogvideox_pipeline_from_directory_matches_jax(cog_root, output_type):
    root, sds = cog_root
    port = cog_vap.build_pipeline(root, "float32", tokenizer=FakeTokenizer(), device="cpu")
    ref = jax_cog.build_pipeline(root, "float32")
    assert port.transformer.config == CogVideoXMOTConfig.tiny(**COG)
    for name in ("transformer", "vae", "text_encoder"):
        _assert_state(getattr(port, name), sds[name])
    _run_pair(port, ref, *_cog_args(), output_type, 2e-5)


def test_cogvideox_lora_overrides_and_dtypes(cog_root, tmp_path):
    """A PEFT LoRA fused at load, the VAE from another directory
    (``vae_id``), the transformer kept in bf16 (``transformer_dtype``) and
    model offload: as in JAX, to the pipeline's output."""
    root, sds = cog_root
    rng = np.random.default_rng(3)
    lora = {f"transformer_blocks.{i}.attn1_mot_ref.{p}": {
        "A": torch.from_numpy(rng.standard_normal((32, 4)).astype(np.float32) * 0.3),
        "B": torch.from_numpy(rng.standard_normal((4, 32)).astype(np.float32) * 0.3)}
        for i in (0, 1) for p in ("to_q", "to_v")}
    lora_path = str(tmp_path / "pytorch_lora_weights.safetensors")
    tckpt.export_lora_safetensors(lora, lora_path, rank=4, alpha=2.0)
    other_vae = {k: v * 0.9 for k, v in sds["vae"].items()}
    vae_dir = write_component(tmp_path / "other", "vae", other_vae, CogVideoXVAEConfig.tiny(),
                              "AutoencoderKLCogVideoX")
    kw = dict(vae_id=vae_dir, lora_path=lora_path, lora_scale=0.75)
    port = cog_vap.build_pipeline(root, "float32", tokenizer=FakeTokenizer(), device="cpu",
                                  enable_model_offload=True, **kw)
    ref = jax_cog.build_pipeline(root, "float32", enable_model_offload=True, **kw)
    _assert_state(port.vae, other_vae)
    fused = jckpt.merge_lora_into_state_dict(sds["transformer"], lora_path, 0.75)
    _assert_state(port.transformer, fused)
    assert not np.array_equal(fused["transformer_blocks.1.attn1_mot_ref.to_v.weight"],
                              sds["transformer"]["transformer_blocks.1.attn1_mot_ref.to_v.weight"])
    assert port.enable_model_offload
    _run_pair(port, ref, *_cog_args(), "latent", 2e-5)
    bf16 = cog_vap.build_pipeline(root, "float32", transformer_dtype="bfloat16",
                                  text_encoder_id=os.path.join(root, "text_encoder"),
                                  tokenizer=FakeTokenizer(), device="cpu")
    assert {p.dtype for p in bf16.transformer.parameters()} == {torch.bfloat16}
    assert {p.dtype for p in bf16.vae.parameters()} == {torch.float32}


@pytest.mark.parametrize("output_type", ["latent", "np"])
def test_wan_pipeline_from_directory_matches_jax(wan_root, output_type):
    root, sds = wan_root
    port = wan_vap.build_pipeline(root, "float32", tokenizer=FakeTokenizer(), device="cpu")
    ref = jax_wan.build_pipeline(root, "float32")
    for name in ("transformer", "vae", "text_encoder", "image_encoder"):
        _assert_state(getattr(port, name), sds[name])
    _run_pair(port, ref, *_wan_args(), output_type, 5e-5)


def test_wan_lora_and_transformer_override(wan_root, tmp_path):
    root, sds = wan_root
    rng = np.random.default_rng(4)
    lora = {f"blocks.{i}.attn1.to_q": {
        "A": torch.from_numpy(rng.standard_normal((24, 2)).astype(np.float32) * 0.3),
        "B": torch.from_numpy(rng.standard_normal((2, 24)).astype(np.float32) * 0.3)}
        for i in (0, 1)}
    lora_path = str(tmp_path / "lora.safetensors")
    tckpt.export_lora_safetensors(lora, lora_path, rank=2, alpha=2.0)
    moved = write_component(tmp_path / "elsewhere", "transformer", sds["transformer"],
                            WanMOTConfig.tiny(**WAN), "WanTransformer3DMOTModel", shards=3)
    kw = dict(transformer_id=moved, lora_path=lora_path, flow_shift=5.0)
    port = wan_vap.build_pipeline(root, "float32", tokenizer=FakeTokenizer(), device="cpu", **kw)
    ref = jax_wan.build_pipeline(root, "float32", **kw)
    assert port.scheduler.shift == 5.0
    _assert_state(port.transformer, jckpt.merge_lora_into_state_dict(sds["transformer"],
                                                                     lora_path))
    _run_pair(port, ref, *_wan_args(), "latent", 5e-5)


def test_uncached_hub_id_raises(tmp_path):
    for build, kw in ((cog_vap.build_pipeline, dict(device="cpu")),
                      (wan_vap.build_pipeline, dict(device="cpu")),
                      (jax_cog.build_pipeline, {})):
        with pytest.raises(FileNotFoundError, match="not a local directory"):
            build("org/not-cached", cache_dir=str(tmp_path), **kw)


def test_build_pipeline_raises_without_a_card_unless_asked(cog_root):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cog_vap.build_pipeline(cog_root[0], "float32")
    with pytest.raises(ValueError, match="unknown dtype"):
        cog_vap.build_pipeline(cog_root[0], "float8", device="cpu")
