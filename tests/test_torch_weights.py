"""The port's checkpoint loader (``vap_tpu_torch/models/loading.py``) against
the JAX package's converters, component by component: the CogVideoX MoT
transformer, the CogVideoX VAE, T5 and UMT5, the Wan transformer (MoT and
plain), the Wan VAE, CLIP vision, and HunyuanVideo's transformer, VAE,
LLaMA and CLIP text encoder.

For each: the JAX initializer's weights (jittered from a numpy seed, so no
leaf is a plain 0 or 1) in diffusers / HF layout are a checkpoint that the
JAX converter reads whole and turns back into the same tree, to the bit.
Written to disk as safetensors shards, the same checkpoint goes through the
port's loader and through the JAX converter, and the two forwards agree
within the tolerance of that module's parity test. A missing key raises in
both, a wrong shape raises in both (the port at load, JAX at its forward),
and a key the JAX converter does not read is ignored by both.

Then the released structures, on the meta device at zero memory: the key
sets and shapes of the port's CogVideoX-5B VAP, Wan2.1-I2V-14B VAP, both
VAEs, T5-XXL, UMT5-XXL and CLIP ViT-H/14 equal what the JAX converters read
and build for ``jax.eval_shape`` of the JAX initializers, and, for the two
transformers, what JAX's export flatteners write. The zero-strided arrays
are those of ``tests/test_real_ckpt_inventory.py``, copied here.
"""

import dataclasses
import types
from typing import Any, Callable

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vap_tpu.models import hunyuan_video as jhy
from vap_tpu.models.cogvideox import CogVideoXMOTConfig as JaxCogConfig
from vap_tpu.models.cogvideox import cogvideox_mot_forward, init_cogvideox_mot
from vap_tpu.models.cogvideox import vae as jcvae
from vap_tpu.models.cogvideox import vae_weights as jcvae_w
from vap_tpu.models.cogvideox import weights as jcog_w
from vap_tpu.models.hunyuan_video import vae as jhvae
from vap_tpu.models.text_encoders import clip_text as jclipt
from vap_tpu.models.text_encoders import clip_vision as jclipv
from vap_tpu.models.text_encoders import llama as jllama
from vap_tpu.models.text_encoders import t5 as jt5
from vap_tpu.models.wan import transformer_mot as jwan
from vap_tpu.models.wan import vae as jwvae
from vap_tpu.models.wan import vae_weights as jwvae_w
from vap_tpu.models.wan import weights as jwan_w
from vap_tpu.models.wan.config import WanMOTConfig as JaxWanConfig
from vap_tpu.ops.attention import attention_provider as jax_provider
from vap_tpu.ops.rope import prepare_cogvideox_rotary_embeddings as jax_rope
from vap_tpu.training.checkpoint import _flatten_to_reference_names
from vap_tpu.training.export_flatten import flatten_wan_mot_state_dict
from vap_tpu_torch import convert
from vap_tpu_torch.models import loading
from vap_tpu_torch.models.cogvideox import vae as tcvae
from vap_tpu_torch.models.cogvideox.config import CogVideoXMOTConfig
from vap_tpu_torch.models.cogvideox.transformer_mot import CogVideoXTransformer3DMOTModel
from vap_tpu_torch.models.hunyuan_video import vae as thvae
from vap_tpu_torch.models.hunyuan_video.config import HunyuanVideoConfig
from vap_tpu_torch.models.hunyuan_video.transformer import HunyuanVideoTransformer3DModel
from vap_tpu_torch.models.text_encoders import clip_text as tclipt
from vap_tpu_torch.models.text_encoders import clip_vision as tclipv
from vap_tpu_torch.models.text_encoders import llama as tllama
from vap_tpu_torch.models.text_encoders import t5 as tt5
from vap_tpu_torch.models.wan import vae as twvae
from vap_tpu_torch.models.wan.config import WanMOTConfig
from vap_tpu_torch.models.wan.transformer_mot import WanTransformer3DMOTModel
from vap_tpu_torch.ops.attention import attention_provider
from vap_tpu_torch.ops.rope import prepare_cogvideox_rotary_embeddings
from vap_tpu_torch.training.checkpoint import load_safetensors
from vap_tpu_torch.utils.safetensors import save_sharded

COG = dict(in_channels=8, out_channels=4, num_layers=3, block_idx_with_mot_ref=(0, 1),
           use_learned_positional_embeddings=True)


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _scaled_close(got, want, atol):
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, atol=atol * scale, rtol=0)


# --- forwards: the inputs and tolerances of each module's parity test ---------

def _fwd_cog(params, jcfg, model):
    """tests/test_torch_transformer.py: one reference, 3 latent frames."""
    cfg, rng = model.config, np.random.default_rng(1)
    b, c, hw, t, f = 2, cfg.in_channels, 8, cfg.max_text_seq_length, 3
    x = dict(hidden_states=rng.standard_normal((b, f, c, hw, hw), np.float32),
             encoder_hidden_states=rng.standard_normal((b, t, cfg.text_embed_dim), np.float32),
             timestep=np.array([999.0, 321.0], np.float32),
             hidden_states_mot_ref=rng.standard_normal((b, f, c, hw, hw), np.float32),
             encoder_hidden_states_mot_ref=rng.standard_normal((b, t, cfg.text_embed_dim),
                                                               np.float32))
    ropes = [dict(height=64, width=64, num_latent_frames=f,
                  attention_head_dim=cfg.attention_head_dim, patch_size=cfg.patch_size,
                  sample_width=cfg.sample_width, sample_height=cfg.sample_height, mot_num=m)
             for m in (0, 1)]
    want = cogvideox_mot_forward(params, jcfg, **_jnp(x),
                                 image_rotary_emb=jax_rope(patch_size_t=None, **ropes[0]),
                                 image_rotary_emb_mot_ref=jax_rope(patch_size_t=None, **ropes[1]),
                                 num_mot_ref=1)[0]
    got = model(**{k: _t(v) for k, v in x.items()},
                image_rotary_emb=prepare_cogvideox_rotary_embeddings(**ropes[0]),
                image_rotary_emb_mot_ref=prepare_cogvideox_rotary_embeddings(**ropes[1]),
                num_mot_ref=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def _fwd_cog_vae(params, jcfg, model):
    video = np.random.default_rng(2).uniform(-1, 1, (1, 5, 16, 24, 3)).astype(np.float32)
    want = jcvae.posterior_mode(jcvae.vae_encode(params, jcfg, jnp.asarray(video)))
    got = tcvae.posterior_mode(tcvae.vae_encode(model, _t(video)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=1e-5)


def _fwd_t5(params, jcfg, model):
    rng = np.random.default_rng(3)
    ids = rng.integers(1, jcfg.vocab_size, (2, 9))
    mask = np.ones((2, 9), np.int64)
    mask[1, 6:] = 0
    want = jt5.t5_encode(params, jcfg, jnp.asarray(ids), jnp.asarray(mask))
    got = model(_t(ids), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=1e-5)


def _wan_inputs(cfg, rng, refs):
    b, f, h, w = 2, 2, 8, 8
    x = dict(hidden_states=rng.standard_normal((b, f, h, w, cfg.in_channels)).astype(np.float32),
             timestep=np.array([500.0, 700.0], np.float32),
             encoder_hidden_states=rng.standard_normal((b, 7, cfg.text_dim)).astype(np.float32),
             encoder_hidden_states_image=rng.standard_normal((b, 5, cfg.image_dim))
             .astype(np.float32))
    if refs:
        x.update(hidden_states_mot_ref=rng.standard_normal((b, f, h, w, cfg.in_channels))
                 .astype(np.float32),
                 timestep_mot_ref=np.ones((b, 1), np.float32),
                 encoder_hidden_states_mot_ref=rng.standard_normal((b, 7, cfg.text_dim))
                 .astype(np.float32),
                 encoder_hidden_states_image_mot_ref=rng.standard_normal((b, 5, cfg.image_dim))
                 .astype(np.float32))
    return x


def _fwd_wan(params, jcfg, model):
    """tests/test_torch_wan.py: one reference."""
    x = _wan_inputs(model.config, np.random.default_rng(4), True)
    want, _ = jwan.wan_mot_forward(params, jcfg, num_mot_ref=1, **_jnp(x))
    got = model(**{k: _t(v) for k, v in x.items()}, num_mot_ref=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


def _fwd_wan_plain(params, jcfg, model):
    """tests/test_torch_wan_train.py: the plain trunk, I2V."""
    x = _wan_inputs(model.config, np.random.default_rng(5), False)
    want = jwan.wan_forward(params, jcfg, **_jnp(x))
    got = model(**{k: _t(v) for k, v in x.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


def _fwd_wan_vae(params, jcfg, model):
    x = np.random.default_rng(6).uniform(-1, 1, (1, 5, 32, 32, 3)).astype(np.float32)
    want = jwvae.wan_vae_encode(params, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(twvae.wan_vae_encode(model, _t(x)).numpy(), np.asarray(want),
                               atol=2e-5, rtol=0)


def _fwd_clip_vision(params, jcfg, model):
    px = np.random.default_rng(7).standard_normal((2, 28, 28, 3)).astype(np.float32)
    want = jclipv.clip_vision_encode(params, jcfg, jnp.asarray(px))
    np.testing.assert_allclose(model(_t(px)).numpy(), np.asarray(want), atol=2e-5, rtol=0)


def _fwd_hunyuan(params, jcfg, model):
    """tests/test_torch_hunyuan.py: a ragged text mask, both under "xla"."""
    rng = np.random.default_rng(8)
    mask = np.ones((2, 8), np.float32)
    mask[1, 3:] = 0.0
    x = dict(hidden_states=rng.standard_normal((2, jcfg.in_channels, 2, 4, 4)).astype(np.float32),
             encoder_hidden_states=rng.standard_normal((2, 8, jcfg.text_embed_dim))
             .astype(np.float32),
             pooled_projections=rng.standard_normal((2, jcfg.pooled_projection_dim))
             .astype(np.float32),
             timestep=np.array([250.0, 900.0], np.float32),
             guidance=np.array([6000.0, 6000.0], np.float32), encoder_attention_mask=mask)
    with jax_provider("xla"):
        want = np.asarray(jhy.hunyuan_video_forward(params, jcfg, remat=False, **_jnp(x)))
    with attention_provider("xla"):
        got = model(**{k: _t(v) for k, v in x.items()}).numpy()
    _scaled_close(got, want, 1e-4)


def _fwd_hunyuan_vae(params, jcfg, model):
    z = np.random.default_rng(9).standard_normal((1, 3, 6, 5, 4)).astype(np.float32)
    want = np.asarray(jhvae.hunyuan_vae_decode(params, jcfg, jnp.asarray(z)))
    _scaled_close(thvae.hunyuan_vae_decode(model, _t(z)).numpy(), want, 2e-5)


def _fwd_llama(params, jcfg, model):
    rng = np.random.default_rng(10)
    ids = rng.integers(1, jcfg.vocab_size, (2, 12)).astype(np.int32)
    mask = np.ones((2, 12), np.int32)
    mask[1, 7:] = 0
    want = np.asarray(jllama.llama_encode(params, jcfg, jnp.asarray(ids), jnp.asarray(mask),
                                          hidden_layer=-1))
    _scaled_close(model(_t(ids).long(), _t(mask), hidden_layer=-1).numpy(), want, 2e-5)


def _fwd_clip_text(params, jcfg, model):
    ids = np.random.default_rng(11).integers(1, 60, (2, 16)).astype(np.int32)
    ids[0, 9], ids[1, 15] = jcfg.eos_token_id, jcfg.eos_token_id
    want = jclipt.clip_text_encode(params, jcfg, jnp.asarray(ids))
    for g, w in zip(model(_t(ids).long()), want):
        _scaled_close(g.numpy(), np.asarray(w), 2e-5)


@dataclasses.dataclass
class Component:
    jinit: Callable
    jconvert: Callable
    jcfg: Any
    cls: Any
    cfg: Any
    from_jax: Callable
    forward: Callable
    required: str  # a key both sides must find


CASES = {
    "cogvideox_mot": Component(init_cogvideox_mot, jcog_w.convert_cogvideox_mot_state_dict,
                               JaxCogConfig.tiny(**COG), CogVideoXTransformer3DMOTModel,
                               CogVideoXMOTConfig.tiny(**COG), convert.from_jax_transformer,
                               _fwd_cog, "transformer_blocks.1.attn1_mot_ref.to_k.weight"),
    "cogvideox_vae": Component(jcvae.init_cogvideox_vae, jcvae_w.convert_cogvideox_vae_state_dict,
                               jcvae.CogVideoXVAEConfig.tiny(), tcvae.AutoencoderKLCogVideoX,
                               tcvae.CogVideoXVAEConfig.tiny(), convert.from_jax_vae,
                               _fwd_cog_vae, "decoder.up_blocks.0.resnets.1.conv2.conv.weight"),
    "t5": Component(jt5.init_t5_encoder, jt5.convert_t5_state_dict, jt5.T5Config.tiny(),
                    tt5.T5EncoderModel, tt5.T5Config.tiny(), convert.from_jax_t5, _fwd_t5,
                    "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"),
    "umt5": Component(jt5.init_t5_encoder, jt5.convert_t5_state_dict,
                      jt5.T5Config.tiny(per_layer_relative_bias=True), tt5.T5EncoderModel,
                      tt5.T5Config.tiny(per_layer_relative_bias=True), convert.from_jax_t5,
                      _fwd_t5, "encoder.block.1.layer.0.SelfAttention.relative_attention_bias.weight"),
    "wan_mot": Component(jwan.init_wan_mot, jwan_w.convert_wan_mot_state_dict, JaxWanConfig.tiny(),
                         WanTransformer3DMOTModel, WanMOTConfig.tiny(),
                         convert.from_jax_wan_transformer, _fwd_wan,
                         "blocks.1.ffn_mot_ref.net.0.proj.weight"),
    "wan_plain": Component(jwan.init_wan, jwan_w.convert_wan_state_dict,
                           JaxWanConfig.tiny(block_idx_with_mot_ref=()), WanTransformer3DMOTModel,
                           WanMOTConfig.tiny(block_idx_with_mot_ref=()),
                           convert.from_jax_wan_transformer, _fwd_wan_plain,
                           "blocks.0.ffn.net.2.weight"),
    "wan_vae": Component(jwvae.init_wan_vae, jwvae_w.convert_wan_vae_state_dict,
                         jwvae.WanVAEConfig.tiny(), twvae.AutoencoderKLWan, twvae.WanVAEConfig.tiny(),
                         convert.from_jax_wan_vae, _fwd_wan_vae, "decoder.mid_block.attentions.0.proj.weight"),
    "clip_vision": Component(jclipv.init_clip_vision, jclipv.convert_clip_vision_state_dict,
                             jclipv.CLIPVisionConfig.tiny(), tclipv.CLIPVisionModel,
                             tclipv.CLIPVisionConfig.tiny(), convert.from_jax_clip_vision,
                             _fwd_clip_vision, "vision_model.embeddings.class_embedding"),
    "hunyuan": Component(jhy.init_hunyuan_video, jhy.convert_hunyuan_video_state_dict,
                         jhy.HunyuanVideoConfig.tiny(), HunyuanVideoTransformer3DModel,
                         HunyuanVideoConfig.tiny(), convert.from_jax_hunyuan_transformer,
                         _fwd_hunyuan, "single_transformer_blocks.1.proj_mlp.weight"),
    "hunyuan_vae": Component(jhvae.init_hunyuan_vae, jhvae.convert_hunyuan_vae_state_dict,
                             jhvae.HunyuanVideoVAEConfig.tiny(), thvae.AutoencoderKLHunyuanVideo,
                             thvae.HunyuanVideoVAEConfig.tiny(), convert.from_jax_hunyuan_vae,
                             _fwd_hunyuan_vae, "decoder.conv_out.conv.weight"),
    "llama": Component(jllama.init_llama, jllama.convert_llama_state_dict,
                       jllama.LlamaConfig.tiny(), tllama.LlamaModel, tllama.LlamaConfig.tiny(),
                       convert.from_jax_llama, _fwd_llama, "layers.1.mlp.gate_proj.weight"),
    "clip_text": Component(jclipt.init_clip_text, jclipt.convert_clip_text_state_dict,
                           jclipt.CLIPTextConfig.tiny(), tclipt.CLIPTextModel,
                           tclipt.CLIPTextConfig.tiny(), convert.from_jax_clip_text,
                           _fwd_clip_text, "text_model.final_layer_norm.bias"),
}


class Recording(dict):
    """A checkpoint dict that records the keys a converter reads."""

    def __init__(self, *args):
        super().__init__(*args)
        self.read = set()

    def __getitem__(self, k):
        self.read.add(k)
        return super().__getitem__(k)


def _tree_equal(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Per component, lazily: the jittered JAX tree, its diffusers-layout
    checkpoint dict (numpy) and a directory holding it as safetensors shards."""
    made = {}

    def get(name):
        if name not in made:
            c = CASES[name]
            rng = np.random.default_rng(sum(map(ord, name)))
            params = jax.tree.map(
                lambda x: np.asarray(x, np.float32)
                + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32),
                jax.jit(c.jinit, static_argnums=1)(jax.random.PRNGKey(0), c.jcfg))
            sd = {k: v.numpy() for k, v in c.from_jax(params, c.cfg).items()}
            d = tmp_path_factory.mktemp(name)
            save_sharded({k: torch.from_numpy(v) for k, v in sd.items()}, str(d),
                         max_shard_bytes=sum(v.nbytes for v in sd.values()) // 2)
            made[name] = params, sd, str(d)
        return made[name]

    return get


@pytest.mark.parametrize("name", list(CASES))
def test_loader_matches_the_jax_converter(checkpoints, name):
    c = CASES[name]
    params, sd, d = checkpoints(name)
    # the checkpoint is one the JAX converter reads whole, back to the same tree
    rec = Recording(sd)
    _tree_equal(c.jconvert(rec, c.jcfg), params)
    assert rec.read == set(sd)
    # the port reads the same files: the state equals the checkpoint, to the bit
    state = load_safetensors(d)
    assert len(state.files) > 1  # through the index's shards
    model = loading.load_model(c.cls, c.cfg, state, "cpu", torch.float32)
    got = model.state_dict()
    assert set(got) == set(sd) == set(loading.checkpoint_keys(model, state).values())
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    assert not model.training
    # both forwards on the same checkpoint, the JAX side from its converter
    jparams = _jnp(c.jconvert(dict(load_safetensors(d)), c.jcfg))
    with torch.no_grad():
        c.forward(jparams, c.jcfg, model)


@pytest.mark.parametrize("name", list(CASES))
def test_missing_key_raises_in_both(checkpoints, name):
    c = CASES[name]
    _, sd, _ = checkpoints(name)
    sd = {k: v for k, v in sd.items() if k != c.required}
    with pytest.raises(KeyError):
        c.jconvert(sd, c.jcfg)
    with pytest.raises(KeyError, match="has no"):
        loading.load_model(c.cls, c.cfg, {k: _t(v) for k, v in sd.items()}, "cpu", torch.float32)


@pytest.mark.parametrize("name", list(CASES))
def test_unread_keys_are_ignored_by_both(checkpoints, name):
    """Keys the JAX converter does not read (a diffusers non-persistent
    table, an unknown module) change neither side."""
    c = CASES[name]
    params, sd, _ = checkpoints(name)
    extra = dict(sd, **{"pos_embedding.freqs_cos": np.ones((3, 4), np.float32),
                        "unknown_module.weight": np.zeros((2,), np.float32)})
    rec = Recording(extra)
    _tree_equal(c.jconvert(rec, c.jcfg), params)
    assert "unknown_module.weight" not in rec.read
    model = loading.load_model(c.cls, c.cfg, {k: _t(v) for k, v in extra.items()}, "cpu",
                               torch.float32)
    assert set(model.state_dict()) == set(sd)


@pytest.mark.parametrize("name,key", [("t5", "encoder.block.0.layer.1.DenseReluDense.wo.weight"),
                                      ("clip_vision", "vision_model.encoder.layers.0.mlp.fc1.weight"),
                                      ("cogvideox_mot", "transformer_blocks.0.ff.net.0.proj.weight")])
def test_wrong_shape_raises_in_both(checkpoints, name, key):
    c = CASES[name]
    _, sd, _ = checkpoints(name)
    bad = dict(sd, **{key: np.ascontiguousarray(sd[key].T)})
    with pytest.raises(ValueError, match="has shape"):
        loading.load_model(c.cls, c.cfg, {k: _t(v) for k, v in bad.items()}, "cpu", torch.float32)
    with pytest.raises((TypeError, ValueError)):  # JAX converts it, and its forward refuses it
        c.forward(_jnp(c.jconvert(bad, c.jcfg)), c.jcfg,
                  loading.load_model(c.cls, c.cfg, {k: _t(v) for k, v in sd.items()}, "cpu",
                                     torch.float32))


@pytest.mark.parametrize("keys", [("encoder.embed_tokens.weight",),
                                  ("shared.weight", "encoder.embed_tokens.weight")],
                         ids=["embed_tokens_only", "shared_and_tied"])
def test_t5_embedding_alias_as_jax_reads_it(checkpoints, keys):
    """HF T5 checkpoints carry ``shared.weight`` and its tied copy
    ``encoder.embed_tokens.weight``; JAX reads ``shared`` when present, else
    ``embed_tokens``, and so does the port."""
    c = CASES["t5"]
    params, sd, _ = checkpoints("t5")
    embed = sd["shared.weight"]
    ckpt = {k: v for k, v in sd.items() if k != "shared.weight"}
    ckpt.update({k: embed if k == keys[0] else embed * 0 for k in keys})
    _tree_equal(c.jconvert(ckpt, c.jcfg), params)
    model = loading.load_model(c.cls, c.cfg, {k: _t(v) for k, v in ckpt.items()}, "cpu",
                               torch.float32)
    np.testing.assert_array_equal(model.shared.weight.detach().numpy(), embed)


def test_bf16_checkpoint_into_f32_and_back(checkpoints, tmp_path):
    """A bf16 checkpoint loads cast to the component's dtype (f32 here: each
    value exactly its bf16), and into bf16 unchanged."""
    c = CASES["clip_vision"]
    _, sd, _ = checkpoints("clip_vision")
    bf16 = {k: _t(v).to(torch.bfloat16) for k, v in sd.items()}
    save_sharded(bf16, str(tmp_path))
    for dtype in (torch.float32, torch.bfloat16):
        model = loading.load_model(c.cls, c.cfg, load_safetensors(str(tmp_path)), "cpu", dtype)
        for k, v in model.state_dict().items():
            assert v.dtype == dtype
            assert torch.equal(v, bf16[k].to(dtype)), k


def test_a_module_with_an_unsaved_buffer_refuses_to_load():
    """``to_empty`` leaves a non-persistent buffer uninitialised, so the
    loader refuses such a module rather than leave garbage in it."""

    class WithTable(torch.nn.Module):
        def __init__(self, cfg):
            super().__init__()
            self.lin = torch.nn.Linear(2, 2)
            self.register_buffer("table", torch.ones(3), persistent=False)

    sd = {"lin.weight": torch.ones(2, 2), "lin.bias": torch.zeros(2)}
    with pytest.raises(RuntimeError, match="uninitialised"):
        loading.load_model(WithTable, None, sd, "cpu", torch.float32)


@pytest.mark.parametrize("name", list(CASES))
def test_no_port_module_has_an_unsaved_tensor(name):
    c = CASES[name]
    model = loading.build_on_meta(c.cls, c.cfg, torch.float32)
    saved = set(model.state_dict())
    assert {n for n, _ in model.named_parameters()} | {n for n, _ in model.named_buffers()} <= saved


# ---------------------------------------------------------------------------
# the released structures, on the meta device
# ---------------------------------------------------------------------------

def _fake(shape, dtype=np.float32):
    return np.broadcast_to(np.zeros((), dtype), tuple(int(s) for s in shape))


def _shim_jnp():
    """Shape-faithful stand-in for the converters' jnp usage."""
    def asarray(x, dtype=None):
        return _fake(np.shape(x))

    def stack(xs, axis=0):
        xs = list(xs)
        return _fake((len(xs),) + np.shape(xs[0]))

    return types.SimpleNamespace(asarray=asarray, stack=stack,
                                 float32=np.float32, bfloat16=np.float32)


class _RecordingShapes:
    """Dict-like over {key: shape} that returns zero-strided arrays and
    records which keys the converter consumed."""

    def __init__(self, shapes):
        self.shapes = dict(shapes)
        self.consumed = set()

    def __contains__(self, k):
        return k in self.shapes

    def __getitem__(self, k):
        self.consumed.add(k)
        return _fake(self.shapes[k])

    def get(self, k, default=None):
        return self[k] if k in self.shapes else default

    def __iter__(self):
        return iter(self.shapes)

    def keys(self):
        return self.shapes.keys()


def _shapes_of_tree(tree):
    return {jax.tree_util.keystr(p): tuple(np.shape(leaf))
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


RELEASED = {
    "cogvideox_5b_i2v_vap": (init_cogvideox_mot, jcog_w, "convert_cogvideox_mot_state_dict",
                             JaxCogConfig.cogvideox_5b_i2v_vap(), CogVideoXTransformer3DMOTModel,
                             CogVideoXMOTConfig.cogvideox_5b_i2v_vap()),
    "wan_14b_i2v_vap": (jwan.init_wan_mot, jwan_w, "convert_wan_mot_state_dict",
                        JaxWanConfig.wan_14b_i2v_vap(), WanTransformer3DMOTModel,
                        WanMOTConfig.wan_14b_i2v_vap()),
    "cogvideox_vae": (jcvae.init_cogvideox_vae, jcvae_w, "convert_cogvideox_vae_state_dict",
                      jcvae.CogVideoXVAEConfig(), tcvae.AutoencoderKLCogVideoX,
                      tcvae.CogVideoXVAEConfig()),
    "wan_vae": (jwvae.init_wan_vae, jwvae_w, "convert_wan_vae_state_dict", jwvae.WanVAEConfig(),
                twvae.AutoencoderKLWan, twvae.WanVAEConfig()),
    "t5_xxl": (jt5.init_t5_encoder, jt5, "convert_t5_state_dict", jt5.T5Config.t5_xxl(),
               tt5.T5EncoderModel, tt5.T5Config.t5_xxl()),
    "umt5_xxl": (jt5.init_t5_encoder, jt5, "convert_t5_state_dict", jt5.T5Config.umt5_xxl(),
                 tt5.T5EncoderModel, tt5.T5Config.umt5_xxl()),
    "clip_vit_h": (jclipv.init_clip_vision, jclipv, "convert_clip_vision_state_dict",
                   jclipv.CLIPVisionConfig(), tclipv.CLIPVisionModel, tclipv.CLIPVisionConfig()),
}
FLATTENERS = {"cogvideox_5b_i2v_vap": _flatten_to_reference_names,
              "wan_14b_i2v_vap": flatten_wan_mot_state_dict}


@pytest.mark.parametrize("name", list(RELEASED))
def test_released_structure_inventory(monkeypatch, name):
    jinit, jmodule, conv_name, jcfg, cls, cfg = RELEASED[name]
    port = {k: tuple(v.shape) for k, v in
            loading.build_on_meta(cls, cfg, torch.bfloat16).state_dict().items()}
    abstract = jax.eval_shape(lambda k: jinit(k, jcfg), jax.random.PRNGKey(0))
    monkeypatch.setattr(jmodule, "jnp", _shim_jnp())
    rec = _RecordingShapes(port)
    built = getattr(jmodule, conv_name)(rec, jcfg)
    assert rec.consumed == set(port), sorted(set(port) - rec.consumed)[:8]
    assert _shapes_of_tree(built) == _shapes_of_tree(abstract)
    if name in FLATTENERS:
        flat = FLATTENERS[name](jax.tree.map(lambda s: _fake(s.shape), abstract), jcfg)
        assert {k: tuple(np.shape(v)) for k, v in flat.items()} == port
