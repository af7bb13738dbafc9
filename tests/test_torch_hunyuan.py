"""The port's HunyuanVideo modules against the JAX package: the transformer
(with and without a ragged text mask, token_replace, without guidance
embeddings), the VAE decode (its chunked frame-causal mid attention against
JAX's dense one), LLaMA with a padded mask and CLIP text.

Tiny configs, weights from the JAX initialisers carried over with
``convert.from_jax_*``, inputs from numpy seeds, float32 on both sides. The
JAX transformer runs under "xla" (masked dense joint attention) and under
"flash_varlen" (its K7 Pallas kernel in interpret mode); the port's under
"xla" (``dense_attention_masked``) and under "flash" (K7's plain version on
CPU tensors).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vap_tpu.models.hunyuan_video import HunyuanVideoConfig as JaxConfig
from vap_tpu.models.hunyuan_video import hunyuan_video_forward, init_hunyuan_video
from vap_tpu.models.hunyuan_video import vae as jvae
from vap_tpu.models.text_encoders import clip_text as jclip
from vap_tpu.models.text_encoders import llama as jllama
from vap_tpu.ops.attention import attention_provider as jax_provider
from vap_tpu_torch import convert
from vap_tpu_torch.models.hunyuan_video import vae as tvae
from vap_tpu_torch.models.hunyuan_video.config import HunyuanVideoConfig
from vap_tpu_torch.models.hunyuan_video.transformer import HunyuanVideoTransformer3DModel
from vap_tpu_torch.models.text_encoders.clip_text import CLIPTextConfig, CLIPTextModel
from vap_tpu_torch.models.text_encoders.llama import LlamaConfig, LlamaModel
from vap_tpu_torch.ops import flash_attention as tfa
from vap_tpu_torch.ops.attention import attention_provider

# float32 on both sides; the same math in another summation order through
# a few blocks: 2e-5 of the output's scale for the encoders and the VAE,
# 1e-4 through the transformer's 2 + 2 blocks and refiner (its modulations
# reach |x| ~ 10, where f32 rounds at 1e-6)
ATOL = 2e-5
TRANSFORMER_ATOL = 1e-4


def _tree(fn, *args):
    return jax.tree.map(np.asarray, jax.jit(fn, static_argnums=1)(jax.random.PRNGKey(0), *args))


def _close(got, want, atol):
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, want, atol=atol * scale, rtol=0)


# ---------------------------------------------------------------------------
# text encoders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hidden_layer", [-1, -3])
def test_llama_matches_jax(hidden_layer):
    """GQA (4 query heads over 2), a right-padded mask, 3 blocks: the final
    norm output and the un-normed block N - 2 that HunyuanVideo takes."""
    cfg, jcfg = LlamaConfig.tiny(num_hidden_layers=3), jllama.LlamaConfig.tiny(num_hidden_layers=3)
    params = _tree(jllama.init_llama, jcfg)
    model = LlamaModel(cfg).eval()
    model.load_state_dict(convert.from_jax_llama(params, cfg))
    rng = np.random.default_rng(1)
    ids = rng.integers(1, cfg.vocab_size, (2, 12)).astype(np.int32)
    mask = np.ones((2, 12), np.int32)
    mask[1, 7:] = 0
    want = np.asarray(jllama.llama_encode(jax.tree.map(jnp.asarray, params), jcfg,
                                          jnp.asarray(ids), jnp.asarray(mask),
                                          hidden_layer=hidden_layer))
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                    hidden_layer=hidden_layer).numpy()
    _close(got, want, ATOL)


def test_clip_text_matches_jax():
    cfg, jcfg = CLIPTextConfig.tiny(), jclip.CLIPTextConfig.tiny()
    params = _tree(jclip.init_clip_text, jcfg)
    model = CLIPTextModel(cfg).eval()
    model.load_state_dict(convert.from_jax_clip_text(params, cfg))
    ids = np.random.default_rng(2).integers(1, 60, (2, 16)).astype(np.int32)
    ids[0, 9], ids[1, 15] = cfg.eos_token_id, cfg.eos_token_id
    want = jclip.clip_text_encode(jax.tree.map(jnp.asarray, params), jcfg, jnp.asarray(ids))
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long())
    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w), ATOL)


# ---------------------------------------------------------------------------
# VAE decode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vae():
    cfg, jcfg = tvae.HunyuanVideoVAEConfig.tiny(), jvae.HunyuanVideoVAEConfig.tiny()
    params = _tree(jvae.init_hunyuan_vae, jcfg)
    # non-trivial norms and biases, so a swapped scale and bias shows
    rng = np.random.default_rng(3)
    params = jax.tree.map(lambda x: x + 0.1 * rng.standard_normal(x.shape).astype(x.dtype)
                          if x.ndim == 1 else x, params)
    model = tvae.AutoencoderKLHunyuanVideo(cfg).eval()
    model.load_state_dict(convert.from_jax_hunyuan_vae(params, cfg))
    return model, jax.tree.map(jnp.asarray, params), jcfg


def test_vae_decode_matches_jax(vae):
    """3 latent frames (so the mid attention's frame-causal mask and the
    first-frame-special upsampling both act) -> 5 frames at 2x space."""
    model, params, jcfg = vae
    z = np.random.default_rng(4).standard_normal((1, 3, 6, 5, 4)).astype(np.float32)
    want = np.asarray(jvae.hunyuan_vae_decode(params, jcfg, jnp.asarray(z)))
    got = tvae.hunyuan_vae_decode(model, torch.from_numpy(z)).numpy()
    assert got.shape == want.shape == (1, 5, 12, 10, 3)
    _close(got, want, ATOL)


def test_vae_chunks_change_nothing(vae, monkeypatch):
    """Convs over chunks of one output frame and group norms over one group
    at a time: the same values as one chunk (the chunks split no sum)."""
    model, _, _ = vae
    z = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 3, 6, 5, 4)).astype(np.float32))
    whole = tvae.hunyuan_vae_decode(model, z)
    monkeypatch.setattr(tvae, "CHUNK_ELEMS", 1)
    monkeypatch.setattr(tvae, "GN_CHUNK_ELEMS", 1)
    torch.testing.assert_close(tvae.hunyuan_vae_decode(model, z), whole, atol=1e-6, rtol=0)


def test_vae_mid_attention_matches_jax_dense(vae):
    """The query-chunked frame-causal attention against JAX's dense f32
    score matrix with its -inf mask, over 4 latent frames."""
    model, params, jcfg = vae
    attn = model.decoder.mid_block.attentions[0]
    c = attn.to_q.in_features
    x = np.random.default_rng(6).standard_normal((1, 4, 3, 5, c)).astype(np.float32)
    want = np.asarray(jvae._mid_attention(params["decoder"]["mid_block"]["attention"],
                                          jnp.asarray(x), jcfg.norm_num_groups))
    with torch.no_grad():
        got = attn(torch.from_numpy(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1).numpy()
    _close(got, want, ATOL)


# ---------------------------------------------------------------------------
# transformer
# ---------------------------------------------------------------------------

def _transformer(**overrides):
    cfg, jcfg = HunyuanVideoConfig.tiny(**overrides), JaxConfig.tiny(**overrides)
    params = _tree(init_hunyuan_video, jcfg)
    rng = np.random.default_rng(7)
    # random norm scales, so a query/key norm swapped with another shows
    params = jax.tree.map(lambda x: x + 0.1 * rng.standard_normal(x.shape).astype(x.dtype)
                          if x.ndim <= 2 and x.shape[-1] == jcfg.attention_head_dim else x, params)
    model = HunyuanVideoTransformer3DModel(cfg).eval()
    model.load_state_dict(convert.from_jax_hunyuan_transformer(params, cfg))
    return model, jax.tree.map(jnp.asarray, params), jcfg


def _inputs(cfg, masked):
    rng = np.random.default_rng(8)
    b, s_txt = 2, 8
    mask = np.ones((b, s_txt), np.float32)
    if masked:
        mask[1, 3:] = 0.0  # a ragged, right-padded text mask
    return dict(hidden_states=rng.standard_normal((b, cfg.in_channels, 2, 4, 4)).astype(np.float32),
                encoder_hidden_states=rng.standard_normal((b, s_txt, cfg.text_embed_dim))
                .astype(np.float32),
                pooled_projections=rng.standard_normal((b, cfg.pooled_projection_dim))
                .astype(np.float32),
                timestep=np.array([250.0, 900.0], np.float32),
                guidance=np.array([6000.0, 6000.0], np.float32),
                encoder_attention_mask=mask if masked else None)


def _jax_forward(params, jcfg, inputs, provider):
    args = {k: None if v is None else jnp.asarray(v) for k, v in inputs.items()}
    with jax_provider(provider):
        if provider == "xla":
            return np.asarray(hunyuan_video_forward(params, jcfg, remat=False, **args))
        with pltpu.force_tpu_interpret_mode():
            return np.asarray(hunyuan_video_forward(params, jcfg, remat=False, **args))


def _torch_forward(model, inputs, provider):
    args = {k: None if v is None else torch.from_numpy(v) for k, v in inputs.items()}
    with torch.no_grad(), attention_provider(provider):
        return model(**args).numpy()


@pytest.mark.parametrize("masked", [True, False], ids=["ragged_mask", "no_mask"])
def test_transformer_matches_jax(masked):
    """The port under "xla" and "flash" against JAX under "xla"; with the
    ragged mask, "flash" runs K7's plain version (one launch counted on no
    kernel: CPU tensors take the plain version)."""
    model, params, jcfg = _transformer()
    inputs = _inputs(jcfg, masked)
    want = _jax_forward(params, jcfg, inputs, "xla")
    launches = tfa.flash_attention_forward.launches_varlen
    for provider in ("xla", "flash"):
        got = _torch_forward(model, inputs, provider)
        assert got.shape == want.shape == inputs["hidden_states"].shape
        _close(got, want, TRANSFORMER_ATOL)
    assert tfa.flash_attention_forward.launches_varlen == launches


def test_transformer_flash_matches_jax_flash_varlen():
    """JAX's K7 Pallas kernel (interpret mode) against the port's plain K7,
    both behind their models' ragged-mask joint attention."""
    model, params, jcfg = _transformer()
    inputs = _inputs(jcfg, True)
    want = _jax_forward(params, jcfg, inputs, "flash_varlen")
    _close(_torch_forward(model, inputs, "flash"), want, TRANSFORMER_ATOL)


@pytest.mark.parametrize("overrides", [dict(image_condition_type="token_replace"),
                                       dict(guidance_embeds=False)],
                         ids=["token_replace", "no_guidance_embeds"])
def test_transformer_variants_match_jax(overrides):
    model, params, jcfg = _transformer(**overrides)
    inputs = _inputs(jcfg, True)
    want = _jax_forward(params, jcfg, inputs, "xla")
    _close(_torch_forward(model, inputs, "flash"), want, TRANSFORMER_ATOL)


def test_text_padding_does_not_reach_the_output():
    """Text states past the mask rewritten to 1e3: the output does not
    move. The pooled text multiplies them by 0, the refiner's padded keys
    are biased away, and K7 never loads the padded joint keys; the padded
    text rows only carry their own values."""
    model, _, jcfg = _transformer()
    inputs = _inputs(jcfg, True)
    base = _torch_forward(model, inputs, "flash")
    dirty = dict(inputs)
    dirty["encoder_hidden_states"] = inputs["encoder_hidden_states"].copy()
    dirty["encoder_hidden_states"][1, 3:] = 1e3
    np.testing.assert_allclose(_torch_forward(model, dirty, "flash"), base, atol=1e-6, rtol=0)
