"""The port's CogVideoX MoT transformer against ``cogvideox_mot_forward``.

Tiny config with three blocks, MoT in blocks 0 and 1 and a plain tail block
(the released structure's heterogeneous tail), and the learned position
embedding on. JAX weights come from the native initializer and reach the
port through ``convert.from_jax_transformer``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vap_tpu.models.cogvideox import CogVideoXMOTConfig as JaxConfig
from vap_tpu.models.cogvideox import cogvideox_mot_forward, init_cogvideox_mot
from vap_tpu.ops.rope import prepare_cogvideox_rotary_embeddings as jax_rope
from vap_tpu_torch import convert
from vap_tpu_torch.models.cogvideox.config import CogVideoXMOTConfig
from vap_tpu_torch.models.cogvideox.transformer_mot import CogVideoXTransformer3DMOTModel
from vap_tpu_torch.ops.rope import prepare_cogvideox_rotary_embeddings

CFG = dict(in_channels=8, out_channels=4, num_layers=3, block_idx_with_mot_ref=(0, 1),
           use_learned_positional_embeddings=True)
# float32 on both sides, three blocks deep
ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jcfg = JaxConfig.tiny(**CFG)
    params = init_cogvideox_mot(jax.random.PRNGKey(0), jcfg)
    cfg = CogVideoXMOTConfig.tiny(**CFG)
    model = CogVideoXTransformer3DMOTModel(cfg).eval()
    model.load_state_dict(convert.from_jax_transformer(jax.tree.map(np.asarray, params), cfg))
    return jcfg, params, model


def _rope_args(cfg, frames, mot_num):
    return dict(height=64, width=64, num_latent_frames=frames,
                attention_head_dim=cfg.attention_head_dim, patch_size=cfg.patch_size,
                sample_width=cfg.sample_width, sample_height=cfg.sample_height, mot_num=mot_num)


# (references, latent frames): 3 frames use the learned buffer as it is,
# 2 frames take the fresh sincos table the reference swaps in
@pytest.mark.parametrize("num_ref,frames", [(1, 3), (2, 2)])
def test_forward_matches_jax(models, num_ref, frames):
    jcfg, params, model = models
    cfg = model.config
    rng = np.random.default_rng(num_ref)
    b, c, hw, t = 2, cfg.in_channels, 8, cfg.max_text_seq_length
    inputs = dict(
        hidden_states=rng.standard_normal((b, frames, c, hw, hw), np.float32),
        encoder_hidden_states=rng.standard_normal((b, t, cfg.text_embed_dim), np.float32),
        timestep=np.array([999.0, 321.0], np.float32),
        hidden_states_mot_ref=rng.standard_normal((b, num_ref * frames, c, hw, hw), np.float32),
        encoder_hidden_states_mot_ref=rng.standard_normal((b, num_ref * t, cfg.text_embed_dim),
                                                          np.float32),
    )
    rope_args = [_rope_args(cfg, frames, 0), _rope_args(cfg, frames, num_ref)]

    def jax_fwd(x, ropes):
        return cogvideox_mot_forward(params, jcfg, **x, image_rotary_emb=ropes[0],
                                     image_rotary_emb_mot_ref=ropes[1], num_mot_ref=num_ref)[0]

    ref = jax.jit(jax_fwd)({k: jnp.asarray(v) for k, v in inputs.items()},
                           [jax_rope(patch_size_t=None, **a) for a in rope_args])
    with torch.no_grad():
        got = model(**{k: torch.from_numpy(v) for k, v in inputs.items()},
                    image_rotary_emb=prepare_cogvideox_rotary_embeddings(**rope_args[0]),
                    image_rotary_emb_mot_ref=prepare_cogvideox_rotary_embeddings(**rope_args[1]),
                    num_mot_ref=num_ref)
    assert got.shape == (b, frames, cfg.out_channels, hw, hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=1e-4)


def test_block_structure_follows_config(models):
    model = models[2]
    assert [blk.with_mot for blk in model.transformer_blocks] == [True, True, False]
    assert not hasattr(model.transformer_blocks[2], "attn1_mot_ref")
    assert model.patch_embed.pos_embedding.shape == (1, 6 + 3 * 4 * 4, model.config.inner_dim)
