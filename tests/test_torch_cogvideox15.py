"""CogVideoX 1.5 in the port against the JAX package: the ``slice`` RoPE grid
(``vap_tpu/ops/rope.py:70-140,187-213``), the transformer with temporal
patching (``patch_size_t=2``) and the ofs embedding, the pipeline's padded
latents (``cogvideox_i2v_mot.py:517-560``) and the loader of the 1.5
layout, with and without ``ofs_embedding.*`` (``weights.py:37-44,112``).

Tiny configs as in ``tests/test_pipeline_cogvideox.py:97`` and
``tests/test_pipeline_golden_parity.py:851``: in_channels 8, out_channels
4, pt 2, the VAE with ``invert_scale_latents`` and scaling 0.7; weights from
JAX's initializers (jittered from a numpy seed), carried over by
``convert``. float32 end to end; the tolerances of the transformer and
pipeline parity tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pipeline import FakeTokenizer
from test_torch_weights import Recording, _tree_equal
from torch_ckpt_util import jitter
from vap_tpu.models.cogvideox import CogVideoXMOTConfig as JaxConfig
from vap_tpu.models.cogvideox import cogvideox_mot_forward, init_cogvideox_mot
from vap_tpu.models.cogvideox import weights as jweights
from vap_tpu.models.cogvideox.vae import CogVideoXVAEConfig as JaxVAEConfig
from vap_tpu.models.cogvideox.vae import init_cogvideox_vae
from vap_tpu.models.text_encoders import T5Config as JaxT5Config
from vap_tpu.models.text_encoders import init_t5_encoder
from vap_tpu.ops import rope as jrope
from vap_tpu.pipelines import cogvideox_i2v_mot as jpipe
from vap_tpu_torch import convert
from vap_tpu_torch.models import loading
from vap_tpu_torch.models.cogvideox.config import CogVideoXMOTConfig
from vap_tpu_torch.models.cogvideox.transformer_mot import CogVideoXTransformer3DMOTModel
from vap_tpu_torch.models.cogvideox.vae import AutoencoderKLCogVideoX, CogVideoXVAEConfig
from vap_tpu_torch.models.text_encoders.t5 import T5Config, T5EncoderModel
from vap_tpu_torch.ops import rope as trope
from vap_tpu_torch.pipelines import cogvideox_i2v_mot as tpipe

CFG = dict(in_channels=8, out_channels=4, patch_size_t=2)
OFS = dict(CFG, ofs_embed_dim=16)  # the tiny time_embed_dim: emb + ofs_emb
# float32 on both sides, as tests/test_torch_transformer.py and
# tests/test_torch_pipeline.py hold them
FWD_ATOL, FWD_RTOL = 1e-4, 1e-4
PIPE_ATOL, PIPE_RTOL = 2e-5, 1e-5


def _rope_kw(cfg, mot_num=0, ref_type="continous_negative"):
    return dict(attention_head_dim=cfg.attention_head_dim, patch_size=cfg.patch_size,
                sample_width=cfg.sample_width, sample_height=cfg.sample_height, mot_num=mot_num,
                ref_type=ref_type)


@pytest.mark.parametrize("frames", [3, 4])
@pytest.mark.parametrize("mot_num,ref_type", [(0, "continous_negative"),
                                              (1, "continous_negative"),
                                              (2, "continous_negative"),
                                              (1, "discrete_long_reference"),
                                              (2, "discrete_long_reference")])
def test_slice_rope_tables_match_jax(frames, mot_num, ref_type):
    """The ``slice`` grid, target and references (both ref types take
    ``arange(-mot_num * T, 0)`` there), at a frame count that rounds up
    over pt and one that divides; 480x720 at sample 60x90 and 768x1360 at
    the 1.5 sample 300x300, where the crop would differ."""
    for h, w, sample in ((480, 720, (60, 90)), (768, 1360, (300, 300))):
        cfg = CogVideoXMOTConfig.tiny(attention_head_dim=64, sample_height=sample[0],
                                      sample_width=sample[1], **CFG)
        kw = _rope_kw(cfg, mot_num, ref_type)
        got = trope.prepare_cogvideox_rotary_embeddings(h, w, frames, patch_size_t=2, **kw)
        want = jrope.prepare_cogvideox_rotary_embeddings(h, w, frames, patch_size_t=2, **kw)
        rows = (frames + 1) // 2 * max(mot_num, 1) * (h // 16) * (w // 16)
        for g, x in zip(got, want):
            assert g.shape == (rows, 64)
            np.testing.assert_array_equal(g.numpy(), np.asarray(x))


def test_slice_grid_raises_like_jax():
    with pytest.raises(ValueError, match="grid_type"):
        trope.get_3d_rotary_pos_embed_np(16, None, (2, 2), 2, grid_type="bogus")


@pytest.fixture(scope="module")
def models15():
    """(JAX params, the port's model) of the 1.5 config with ofs, on
    jittered JAX init weights."""
    cfg = CogVideoXMOTConfig.tiny(**OFS)
    params = jitter(init_cogvideox_mot(jax.random.PRNGKey(0), JaxConfig.tiny(**OFS)), 0)
    model = CogVideoXTransformer3DMOTModel(cfg).eval()
    model.load_state_dict(convert.from_jax_transformer(params, cfg))
    return jax.tree.map(jnp.asarray, params), model


def _inputs(cfg, num_ref, frames, seed):
    rng = np.random.default_rng(seed)
    b, c, hw, t = 2, cfg.in_channels, 8, cfg.max_text_seq_length
    return dict(
        hidden_states=rng.standard_normal((b, frames, c, hw, hw), np.float32),
        encoder_hidden_states=rng.standard_normal((b, t, cfg.text_embed_dim), np.float32),
        timestep=np.array([999.0, 321.0], np.float32),
        hidden_states_mot_ref=rng.standard_normal((b, num_ref * frames, c, hw, hw), np.float32),
        encoder_hidden_states_mot_ref=rng.standard_normal((b, num_ref * t, cfg.text_embed_dim),
                                                          np.float32))


def _forward_pair(params, jcfg, model, x, num_ref, frames, **extra):
    """The JAX forward and the port's on the same inputs and RoPE tables;
    without reference inputs in ``x`` the trunk alone."""
    cfg = model.config
    single = "hidden_states_mot_ref" not in x
    ropes = [dict(height=64, width=64, num_latent_frames=frames, patch_size_t=2,
                  **_rope_kw(cfg, m)) for m in (0, num_ref)]
    jx = {k: jnp.asarray(v) for k, v in dict(x, **extra).items()}
    if single:
        jx.update(hidden_states_mot_ref=None, encoder_hidden_states_mot_ref=None,
                  single_branch=True)
    want = cogvideox_mot_forward(
        params, jcfg, **jx, image_rotary_emb=jrope.prepare_cogvideox_rotary_embeddings(**ropes[0]),
        image_rotary_emb_mot_ref=(None if single else
                                  jrope.prepare_cogvideox_rotary_embeddings(**ropes[1])),
        num_mot_ref=num_ref)[0]
    with torch.no_grad():
        got = model(**{k: torch.from_numpy(v) for k, v in dict(x, **extra).items()},
                    image_rotary_emb=trope.prepare_cogvideox_rotary_embeddings(**ropes[0]),
                    image_rotary_emb_mot_ref=(None if single else
                                              trope.prepare_cogvideox_rotary_embeddings(
                                                  **ropes[1])),
                    num_mot_ref=num_ref)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("ofs", [None, [2.0, 2.0]])
@pytest.mark.parametrize("num_ref", [1, 2])
def test_transformer_15_matches_jax(models15, ofs, num_ref):
    """The MoT forward with temporal patching over 4 latent frames (2 token
    frames), with and without ofs, at 1 and 2 references."""
    params, model = models15
    jcfg = JaxConfig.tiny(**OFS)
    x = _inputs(model.config, num_ref, 4, seed=num_ref)
    extra = {} if ofs is None else {"ofs": np.asarray(ofs, np.float32)}
    got, want = _forward_pair(params, jcfg, model, x, num_ref, 4, **extra)
    assert got.shape == (2, 4, 4, 8, 8)
    np.testing.assert_allclose(got, want, atol=FWD_ATOL, rtol=FWD_RTOL)
    if ofs is not None:  # the ofs embedding moves the result
        assert np.abs(got - _forward_pair(params, jcfg, model, x, num_ref, 4)[0]).max() > 1e-3


def test_transformer_15_single_branch_matches_jax(models15):
    """The trunk alone with temporal patching (the plain and single-branch
    modes); JAX adds no ofs there, nor does the port."""
    params, model = models15
    x = {k: v for k, v in _inputs(model.config, 1, 4, seed=7).items() if "mot_ref" not in k}
    got, want = _forward_pair(params, JaxConfig.tiny(**OFS), model, x, 1, 4,
                              ofs=np.asarray([2.0, 2.0], np.float32))
    np.testing.assert_allclose(got, want, atol=FWD_ATOL, rtol=FWD_RTOL)


def test_patchify_is_the_voxel_linear(models15):
    """The 1.5 patch projection: a linear over (C, pt, p, p)-ordered voxels
    whose checkpoint key is ``patch_embed.proj`` ([D, C*pt*p*p]), against
    JAX's ``_patchify``; and the output head's unpatchify inverts the token
    layout for pt frames a token."""
    from vap_tpu.models.cogvideox import transformer_mot as jtm

    params, model = models15
    cfg = model.config
    proj = model.patch_embed.proj
    assert isinstance(proj, torch.nn.Linear)
    assert proj.weight.shape == (cfg.inner_dim, cfg.in_channels * 2 * 2 * 2)
    rng = np.random.default_rng(3)
    text = rng.standard_normal((2, 6, cfg.text_embed_dim), np.float32)
    video = rng.standard_normal((2, 4, cfg.in_channels, 8, 8), np.float32)
    want = jtm._patchify(params["patch_embed"], JaxConfig.tiny(**OFS), jnp.asarray(text),
                         jnp.asarray(video))
    with torch.no_grad():
        got = model.patch_embed(torch.from_numpy(text), torch.from_numpy(video))
    assert got.shape == (2, 6 + 2 * 4 * 4, cfg.inner_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    tokens = rng.standard_normal((2, 2 * 4 * 4, 2 * 2 * 2 * 4), np.float32)
    np.testing.assert_array_equal(
        model._unpatchify(torch.from_numpy(tokens), 4, 8, 8).numpy(),
        np.asarray(jtm._unpatchify(JaxConfig.tiny(**OFS), jnp.asarray(tokens), 4, 8, 8)))


@pytest.mark.parametrize("with_ofs", [True, False])
def test_loader_reads_the_15_layout_as_jax(tmp_path, with_ofs):
    """A 1.5-layout checkpoint: JAX's converter reads every key of it (and
    ``ofs_embedding.*`` only when present), the port's loader the same keys
    into the same values; without the ofs keys the port builds no
    ofs_embedding and an ofs refuses; the forwards agree."""
    drop = () if with_ofs else ("ofs_embedding.",)
    jcfg, cfg = JaxConfig.tiny(**OFS), CogVideoXMOTConfig.tiny(**OFS)
    params = jitter(init_cogvideox_mot(jax.random.PRNGKey(5), jcfg), 5)
    sd = {k: v.numpy() for k, v in convert.from_jax_transformer(params, cfg).items()
          if not k.startswith(drop)}
    rec = Recording(sd)
    jparams = jweights.convert_cogvideox_mot_state_dict(rec, jcfg)
    assert rec.read == set(sd) and ("ofs_embedding" in jparams) == with_ofs
    if with_ofs:
        _tree_equal(jparams, params)
    model = loading.load_model(CogVideoXTransformer3DMOTModel, cfg,
                               {k: torch.from_numpy(v) for k, v in sd.items()}, "cpu",
                               torch.float32)
    assert set(model.state_dict()) == set(sd) and hasattr(model, "ofs_embedding") == with_ofs
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    x = _inputs(cfg, 1, 4, seed=11)
    got, want = _forward_pair(jparams, jcfg, model, x, 1, 4)
    np.testing.assert_allclose(got, want, atol=FWD_ATOL, rtol=FWD_RTOL)
    if not with_ofs:
        with pytest.raises(ValueError, match="ofs_embedding"), torch.no_grad():
            model(**{k: torch.from_numpy(v) for k, v in x.items()}, image_rotary_emb=None,
                  ofs=torch.ones(2))


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

H = W = 32


@pytest.fixture(scope="module")
def pipelines15():
    """The port's and JAX's pipelines on one tiny 1.5 model (pt 2), T5 and
    VAE (invert_scale_latents, scaling 0.7)."""
    key = jax.random.PRNGKey(7)
    jt_cfg, t_cfg = JaxConfig.tiny(**CFG), CogVideoXMOTConfig.tiny(**CFG)
    jtxt_cfg = JaxT5Config.tiny(d_model=t_cfg.text_embed_dim)
    txt_cfg = T5Config.tiny(d_model=t_cfg.text_embed_dim)
    vae_kw = dict(invert_scale_latents=True, scaling_factor=0.7)
    jvae_cfg, vae_cfg = JaxVAEConfig.tiny(**vae_kw), CogVideoXVAEConfig.tiny(**vae_kw)
    jparams = {"transformer": jitter(init_cogvideox_mot(key, jt_cfg), 0),
               "text_encoder": jitter(init_t5_encoder(key, jtxt_cfg), 1),
               "vae": jitter(jax.jit(init_cogvideox_vae, static_argnums=1)(key, jvae_cfg), 2)}
    modules = []
    for cls, cfg, conv, name in ((CogVideoXTransformer3DMOTModel, t_cfg, convert.from_jax_transformer,
                                  "transformer"),
                                 (AutoencoderKLCogVideoX, vae_cfg, convert.from_jax_vae, "vae"),
                                 (T5EncoderModel, txt_cfg, convert.from_jax_t5, "text_encoder")):
        m = cls(cfg).eval()
        m.load_state_dict(conv(jparams[name], cfg))
        modules.append(m)
    port = tpipe.CogVideoXVAPPipeline(*modules, FakeTokenizer(), dtype=torch.float32, device="cpu")
    ref = jpipe.CogVideoXVAPPipeline(
        transformer_cfg=jt_cfg, vae_cfg=jvae_cfg, text_cfg=jtxt_cfg,
        params=jax.tree.map(jnp.asarray, jparams), tokenizer=FakeTokenizer(), dtype=jnp.float32)
    return port, ref


@pytest.mark.parametrize("frames,latent_frames,output_type", [(9, 4, "latent"), (9, 4, "np"),
                                                              (13, 4, "latent")])
def test_pipeline_15_matches_jax(pipelines15, frames, latent_frames, output_type):
    """9 frames give 3 latent frames, padded to 4 (one leading pad frame
    dropped before the decode; the reference's latents repeat their last
    frame); 13 give 4, no pad anywhere (JAX's 0 where the reference would
    add pt)."""
    port, ref = pipelines15
    rng = np.random.default_rng(frames)
    args = dict(image=rng.uniform(-1, 1, (H, W, 3)).astype(np.float32), prompt="a cat",
                ref_videos=[rng.uniform(-1, 1, (frames, H, W, 3)).astype(np.float32)],
                prompt_mot_ref=["explode it"], height=H, width=W, num_frames=frames,
                num_inference_steps=2, guidance_scale=6.0, use_dynamic_cfg=True,
                max_sequence_length=6, output_type=output_type)
    latents = rng.standard_normal((1, latent_frames, 4, H // 8, W // 8)).astype(np.float32)
    want = np.asarray(ref(**args, latents=jnp.asarray(latents)))
    got = port(**args, latents=torch.from_numpy(latents))
    got = got.numpy() if output_type == "latent" else got
    assert got.shape == want.shape == ((1, latent_frames, 4, H // 8, W // 8)
                                       if output_type == "latent" else (1, frames, H, W, 3))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=PIPE_ATOL, rtol=PIPE_RTOL)
