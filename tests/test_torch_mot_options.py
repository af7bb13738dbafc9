"""The MoT options of both transformers in the port against the JAX package:
CogVideoX's ``reference_train_mode="reference_independent"`` (both
outputs), the block ablations ``ablation_single_encoder`` and
``ablation_residual_addition``, the reference-slot and effect embeddings
(with ``effect_ids``), against ``cogvideox_mot_forward``; Wan's
``reference_independent`` head (JAX's documented departure from the
reference: ``proj_out_mot_ref`` projects the reference stream) against
``wan_mot_forward``; the loaders reading the new keys as JAX's converters
do, and no others. Training takes ``reference_independent`` and temporal
patching, and still refuses the remat modes not ported.

Tiny configs of ``tests/test_torch_transformer.py`` (three blocks, MoT in
0-1, the learned position table) and ``tests/test_torch_weights.py``; the
weights from JAX's initializers, jittered from a numpy seed. float32 on
both sides, at the tolerances of those files. The ablations run at one
reference, as they ship (``_block_forward_ablation``: the reference
encoder applies the target's RoPE table, whose length fixes R at 1).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_weights import Recording, _tree_equal
from torch_ckpt_util import jitter
from vap_tpu.models.cogvideox import CogVideoXMOTConfig as JaxCogConfig
from vap_tpu.models.cogvideox import cogvideox_mot_forward, init_cogvideox_mot
from vap_tpu.models.cogvideox import weights as jcog_w
from vap_tpu.models.wan import transformer_mot as jwan
from vap_tpu.models.wan import weights as jwan_w
from vap_tpu.models.wan.config import WanMOTConfig as JaxWanConfig
from vap_tpu.ops.rope import prepare_cogvideox_rotary_embeddings as jax_rope
from vap_tpu_torch import convert
from vap_tpu_torch.models import loading
from vap_tpu_torch.models.cogvideox.config import CogVideoXMOTConfig
from vap_tpu_torch.models.cogvideox.transformer_mot import CogVideoXTransformer3DMOTModel
from vap_tpu_torch.models.wan.config import WanMOTConfig
from vap_tpu_torch.models.wan.transformer_mot import WanTransformer3DMOTModel
from vap_tpu_torch.ops.rope import prepare_cogvideox_rotary_embeddings
from vap_tpu_torch.training import train_step

COG = dict(in_channels=8, out_channels=4, num_layers=3, block_idx_with_mot_ref=(0, 1),
           use_learned_positional_embeddings=True)
EFFECTS = ("explode", "melt", "squish")
OPTIONS = {
    "reference_independent": dict(reference_train_mode="reference_independent"),
    "embeddings": dict(num_ref_embeddings=2, supported_effect_types=EFFECTS),
    "all": dict(reference_train_mode="reference_independent", num_ref_embeddings=2,
                supported_effect_types=EFFECTS),
    "ablation_single_encoder": dict(ablation_single_encoder=True),
    "ablation_residual_addition": dict(ablation_residual_addition=True),
}
# float32 on both sides, three blocks deep (tests/test_torch_transformer.py)
COG_ATOL, COG_RTOL = 1e-4, 1e-4
# tests/test_torch_wan.py
WAN_ATOL = 2e-5


def _cog_pair(option, seed=0):
    """(JAX cfg, JAX params, the port's model) with ``option`` on."""
    kw = dict(COG, **OPTIONS[option])
    jcfg, cfg = JaxCogConfig.tiny(**kw), CogVideoXMOTConfig.tiny(**kw)
    params = jitter(init_cogvideox_mot(jax.random.PRNGKey(seed), jcfg), seed)
    model = CogVideoXTransformer3DMOTModel(cfg).eval()
    model.load_state_dict(convert.from_jax_transformer(params, cfg))
    return jcfg, jax.tree.map(jnp.asarray, params), model


def _cog_forward(jcfg, params, model, num_ref, effect_ids=None):
    """Both forwards on one input: (port outputs, JAX outputs), each the
    pair (prediction, the reference head's or None)."""
    cfg = model.config
    rng = np.random.default_rng(num_ref)
    b, c, hw, t, f = 2, cfg.in_channels, 8, cfg.max_text_seq_length, 3
    x = dict(hidden_states=rng.standard_normal((b, f, c, hw, hw), np.float32),
             encoder_hidden_states=rng.standard_normal((b, t, cfg.text_embed_dim), np.float32),
             timestep=np.array([999.0, 321.0], np.float32),
             hidden_states_mot_ref=rng.standard_normal((b, num_ref * f, c, hw, hw), np.float32),
             encoder_hidden_states_mot_ref=rng.standard_normal((b, num_ref * t,
                                                                cfg.text_embed_dim), np.float32),
             timestep_mot_ref=np.array([[50.0] * num_ref, [700.0] * num_ref], np.float32))
    if effect_ids is not None:
        x["effect_ids"] = np.asarray(effect_ids, np.int32)
    ropes = [dict(height=64, width=64, num_latent_frames=f,
                  attention_head_dim=cfg.attention_head_dim, patch_size=cfg.patch_size,
                  sample_width=cfg.sample_width, sample_height=cfg.sample_height, mot_num=m)
             for m in (0, num_ref)]
    want = jax.jit(lambda x: cogvideox_mot_forward(
        params, jcfg, **x, image_rotary_emb=jax_rope(patch_size_t=None, **ropes[0]),
        image_rotary_emb_mot_ref=jax_rope(patch_size_t=None, **ropes[1]),
        num_mot_ref=num_ref))({k: jnp.asarray(v) for k, v in x.items()})
    with torch.no_grad():
        carry, aux = model.prologue(
            **{k: torch.from_numpy(v) for k, v in x.items()},
            image_rotary_emb=prepare_cogvideox_rotary_embeddings(**ropes[0]),
            image_rotary_emb_mot_ref=prepare_cogvideox_rotary_embeddings(**ropes[1]),
            num_mot_ref=num_ref)
        blocks = model.run_blocks(carry, aux)
        got = model.epilogue(blocks, aux)
        target, skipped = model.epilogue(blocks, aux, reference_head=False)
    assert torch.equal(target, got[0]) and skipped is None  # forward's epilogue
    return got, want


@pytest.mark.parametrize("num_ref", [1, 2])
@pytest.mark.parametrize("option", ["reference_independent", "embeddings", "all"])
def test_cogvideox_options_match_jax(option, num_ref):
    """reference_independent gives the reference stream's own prediction
    [B, R*F, C, H, W] beside the target's; the slot embeddings go on the
    references back to front and the effect embeddings by ``effect_ids``."""
    jcfg, params, model = _cog_pair(option)
    effect_ids = [2, 0][:num_ref] if "supported_effect_types" in OPTIONS[option] else None
    (out, out_ref), (want, want_ref) = _cog_forward(jcfg, params, model, num_ref, effect_ids)
    assert out.shape == (2, 3, 4, 8, 8)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=COG_ATOL, rtol=COG_RTOL)
    if jcfg.reference_train_mode == "reference_independent":
        assert out_ref.shape == (2, 3 * num_ref, 4, 8, 8)
        np.testing.assert_allclose(out_ref.numpy(), np.asarray(want_ref), atol=COG_ATOL,
                                   rtol=COG_RTOL)
    else:
        assert out_ref is None and want_ref is None


def test_effect_ids_move_the_prediction():
    """With effect embeddings and no ``effect_ids`` none is added, as in
    JAX; with them the prediction changes, per id."""
    jcfg, params, model = _cog_pair("embeddings")
    with torch.no_grad():
        model.effect_embeddings["melt"].mul_(20.0)
    params["effect_embeddings"] = params["effect_embeddings"].at[1].multiply(20.0)
    (none, _), (want_none, _) = _cog_forward(jcfg, params, model, 1)
    (melt, _), (want_melt, _) = _cog_forward(jcfg, params, model, 1, [1])
    np.testing.assert_allclose(none.numpy(), np.asarray(want_none), atol=COG_ATOL, rtol=COG_RTOL)
    np.testing.assert_allclose(melt.numpy(), np.asarray(want_melt), atol=COG_ATOL, rtol=COG_RTOL)
    assert (melt - none).abs().max() > 1e-2


@pytest.mark.parametrize("option", ["ablation_single_encoder", "ablation_residual_addition"])
def test_cogvideox_ablations_match_jax(option):
    """The ablation blocks (MoT in 0-1, a plain tail block), one reference."""
    jcfg, params, model = _cog_pair(option)
    (out, _), (want, _) = _cog_forward(jcfg, params, model, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=COG_ATOL, rtol=COG_RTOL)
    plain_cfg = JaxCogConfig.tiny(**COG)
    (_, _), (joint, _) = _cog_forward(plain_cfg, params, model, 1)
    assert np.abs(out.numpy() - np.asarray(joint)).max() > 1e-3  # not the joint block


def _wan_inputs(cfg, num_ref, seed):
    rng = np.random.default_rng(seed)
    b, f, h, w = 2, 2, 8, 8

    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return dict(hidden_states=n(b, f, h, w, cfg.in_channels),
                timestep=np.array([500.0, 700.0], np.float32),
                encoder_hidden_states=n(b, 7, cfg.text_dim),
                encoder_hidden_states_image=n(b, 5, cfg.image_dim),
                hidden_states_mot_ref=n(b, num_ref * f, h, w, cfg.in_channels),
                timestep_mot_ref=np.array([[1.0] * num_ref, [300.0] * num_ref], np.float32),
                encoder_hidden_states_mot_ref=n(b, num_ref * 7, cfg.text_dim),
                encoder_hidden_states_image_mot_ref=n(b, num_ref * 5, cfg.image_dim))


@pytest.mark.parametrize("num_ref", [1, 2])
def test_wan_reference_independent_matches_jax(num_ref):
    """Wan's reference head: ``scale_shift_table_mot_ref`` modulated by each
    reference's time embedding, ``proj_out_mot_ref`` over the reference
    stream (JAX's departure from the reference, which projects the
    target's); the target prediction unchanged by the option."""
    kw = dict(reference_train_mode="reference_independent")
    jcfg, cfg = JaxWanConfig.tiny(**kw), WanMOTConfig.tiny(**kw)
    params = jitter(jwan.init_wan_mot(jax.random.PRNGKey(3), jcfg), 3)
    model = WanTransformer3DMOTModel(cfg).eval()
    model.load_state_dict(convert.from_jax_wan_transformer(params, cfg))
    x = _wan_inputs(cfg, num_ref, num_ref)
    want, want_ref = jwan.wan_mot_forward(jax.tree.map(jnp.asarray, params), jcfg,
                                          num_mot_ref=num_ref,
                                          **{k: jnp.asarray(v) for k, v in x.items()})
    with torch.no_grad():
        carry, aux = model.prologue(**{k: torch.from_numpy(v) for k, v in x.items()},
                                    num_mot_ref=num_ref)
        blocks = model.run_blocks(carry, aux)
        out, out_ref = model.epilogue(blocks, aux)
        target, skipped = model.epilogue(blocks, aux, reference_head=False)
        plain = model(**{k: torch.from_numpy(v) for k, v in x.items()}, num_mot_ref=num_ref)
    assert torch.equal(out, plain) and torch.equal(target, out) and skipped is None
    assert out_ref.shape == (2, 2 * num_ref, 8, 8, cfg.out_channels)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=WAN_ATOL, rtol=0)
    np.testing.assert_allclose(out_ref.numpy(), np.asarray(want_ref), atol=WAN_ATOL, rtol=0)


def _off(cfg):
    """``cfg`` with every option of this file off."""
    off = dict(reference_train_mode=None, supported_effect_types=(), num_ref_embeddings=None)
    return dataclasses.replace(cfg, **{k: v for k, v in off.items() if hasattr(cfg, k)})


LOADERS = {
    "cogvideox_options": (init_cogvideox_mot, jcog_w.convert_cogvideox_mot_state_dict,
                          CogVideoXTransformer3DMOTModel, convert.from_jax_transformer,
                          lambda: (JaxCogConfig.tiny(**COG, **OPTIONS["all"]),
                                   CogVideoXMOTConfig.tiny(**COG, **OPTIONS["all"])),
                          ("effect_embeddings.melt", "ref_embeddings.ref_1",
                           "norm_out_mot_ref.linear.weight", "proj_out_mot_ref.weight")),
    "wan_reference_independent": (
        jwan.init_wan_mot, jwan_w.convert_wan_mot_state_dict, WanTransformer3DMOTModel,
        convert.from_jax_wan_transformer,
        lambda: (JaxWanConfig.tiny(reference_train_mode="reference_independent"),
                 WanMOTConfig.tiny(reference_train_mode="reference_independent")),
        ("proj_out_mot_ref.weight", "scale_shift_table_mot_ref")),
}


@pytest.mark.parametrize("name", list(LOADERS))
def test_loaders_read_the_new_keys_as_jax(name):
    """The checkpoint holds the new keys (effect embeddings by type name,
    slot embeddings ``ref_<i>``, each [1, 1, D] as JAX's export writes them;
    the reference heads): JAX's converter reads every key back to the same
    tree, the port's loader the same keys to the bit; a missing new key
    raises in both; a key of an option that is off is read by neither."""
    jinit, jconvert, cls, from_jax, cfgs, new_keys = LOADERS[name]
    jcfg, cfg = cfgs()
    params = jitter(jinit(jax.random.PRNGKey(1), jcfg), 1)
    sd = {k: v.numpy() for k, v in from_jax(params, cfg).items()}
    rec = Recording(sd)
    _tree_equal(jconvert(rec, jcfg), params)
    assert rec.read == set(sd) and set(new_keys) <= set(sd)
    model = loading.load_model(cls, cfg, {k: torch.from_numpy(v) for k, v in sd.items()}, "cpu",
                               torch.float32)
    assert set(model.state_dict()) == set(sd)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    if name == "cogvideox_options":
        assert sd["effect_embeddings.melt"].shape == (1, 1, cfg.inner_dim)
    for key in new_keys:
        missing = {k: v for k, v in sd.items() if k != key}
        with pytest.raises(KeyError):
            jconvert(missing, jcfg)
        with pytest.raises(KeyError, match="has no"):
            loading.load_model(cls, cfg, {k: torch.from_numpy(v) for k, v in missing.items()},
                               "cpu", torch.float32)
    # with the options off both loaders ignore their keys
    plain_j, plain = _off(jcfg), _off(cfg)
    rec = Recording(sd)
    jconvert(rec, plain_j)
    unread = set(sd) - rec.read
    assert set(new_keys) <= unread
    model = loading.load_model(cls, plain, {k: torch.from_numpy(v) for k, v in sd.items()},
                               "cpu", torch.float32)
    assert set(model.state_dict()) == set(sd) - unread


@pytest.mark.parametrize("what", ["reference_independent", "patch_size_t"])
def test_training_still_refuses(what):
    """The training step takes both options (``tests/test_torch_train_objectives.py``
    holds their losses against JAX's); with either, it still refuses the
    remat modes not ported (ROADMAP Queue 1 #5)."""
    kw = (dict(reference_train_mode="reference_independent") if what == "reference_independent"
          else dict(patch_size_t=2, use_learned_positional_embeddings=False))
    cfg = CogVideoXMOTConfig.tiny(**{**COG, **kw})
    rope, rope_ref = train_step._rope_tables(cfg, 8, 8, 4, 1, "continous_negative")
    assert rope[0].shape[0] == (2 if what == "patch_size_t" else 4) * 16 and rope_ref is not None
    step_kw = dict(reference_train_mode="reference_independent") \
        if what == "reference_independent" else {}
    rng = np.random.default_rng(0)
    lat = (1, 4, cfg.out_channels, 8, 8)
    batch = {k: torch.from_numpy(rng.standard_normal(shape, np.float32)) for k, shape in (
        ("latents", lat), ("image_latents", lat), ("latents_mot_ref", lat),
        ("image_latents_mot_ref", lat),
        ("encoder_hidden_states", (1, cfg.max_text_seq_length, cfg.text_embed_dim)),
        ("encoder_hidden_states_mot_ref", (1, cfg.max_text_seq_length, cfg.text_embed_dim)))}
    model = CogVideoXTransformer3DMOTModel(cfg)
    draws = train_step.draw_step_noise(train_step.TrainStepConfig(model=cfg, **step_kw), lat,
                                       torch.Generator().manual_seed(0), ref_shape=lat)
    loss, _ = train_step.cogvideox_vap_loss(
        model, train_step.TrainStepConfig(model=cfg, remat=False, **step_kw), batch,
        **draws)
    assert torch.isfinite(loss)
    ops, _ = train_step.cogvideox_vap_loss(
        model, train_step.TrainStepConfig(model=cfg, remat="ops", **step_kw), batch, **draws)
    assert torch.equal(ops, loss)
