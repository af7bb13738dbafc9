"""The W8A8 CogVideoX transformer in the port against the JAX package.

A small MoT transformer whose projections reach K3's shape rule (2 heads x
64, so K and N are 128 or 512): three blocks, MoT in 0-1. The JAX tree goes
through ``quantize_transformer_linears``; the port quantises its modules in
place and loads the same int8 weights through ``convert``. Both forms run:
the row form against ``VAP_INT8_PALLAS=0`` (XLA's ``_int8_linear``), the
chunk form against ``VAP_INT8_PALLAS=1`` in interpret mode (as
``tests/test_int8_matmul.py:73-88`` runs it). Then the port's own W8A8
gate over a 4-step VAP trajectory, as ``tests/test_int8_gate.py`` holds
the JAX one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vap_tpu.models.cogvideox import CogVideoXMOTConfig as JaxConfig
from vap_tpu.models.cogvideox import cogvideox_mot_forward, init_cogvideox_mot
from vap_tpu.models.common import quantize_transformer_linears as jax_quantize
from vap_tpu.ops.rope import prepare_cogvideox_rotary_embeddings as jax_rope
from vap_tpu_torch import convert
from vap_tpu_torch.models import common as tcommon
from vap_tpu_torch.models.cogvideox.config import CogVideoXMOTConfig
from vap_tpu_torch.models.cogvideox.transformer_mot import CogVideoXTransformer3DMOTModel
from vap_tpu_torch.models.cogvideox.vae import AutoencoderKLCogVideoX, CogVideoXVAEConfig
from vap_tpu_torch.models.random_init import build_random
from vap_tpu_torch.models.text_encoders.t5 import T5Config, T5EncoderModel
from vap_tpu_torch.ops import int8_matmul as tint8
from vap_tpu_torch.ops.rope import prepare_cogvideox_rotary_embeddings
from vap_tpu_torch.pipelines.cogvideox_i2v_mot import CogVideoXVAPPipeline

CFG = dict(num_attention_heads=2, attention_head_dim=64, in_channels=8, out_channels=4,
           num_layers=3, block_idx_with_mot_ref=(0, 1), use_learned_positional_embeddings=True)
JAX_NAMES = {"to_q": "to_q", "to_k": "to_k", "to_v": "to_v", "to_out": "to_out.0",
             "net_0": "net.0.proj", "net_2": "net.2"}


@pytest.fixture(scope="module")
def models():
    jcfg = JaxConfig.tiny(**CFG)
    params = jax_quantize(init_cogvideox_mot(jax.random.PRNGKey(0), jcfg))
    cfg = CogVideoXMOTConfig.tiny(**CFG)
    model = CogVideoXTransformer3DMOTModel(cfg).eval()
    names = tcommon.quantize_transformer_linears(model)
    model.load_state_dict(convert.from_jax_transformer(jax.tree.map(np.asarray, params), cfg))
    return jcfg, params, model, names


def _jax_int8_paths(params, cfg):
    """The port names of the JAX tree's W8A8 leaves, block stacks unstacked."""
    out = set()
    for (start, length, _), seg in zip(cfg.mot_segments, params["blocks"]):
        for branch, sub in seg.items():
            for leaf, p in sub.items():
                if isinstance(p, dict) and "w_i8" in p:
                    out |= {f"transformer_blocks.{start + i}.{branch}.{JAX_NAMES[leaf]}"
                            for i in range(length)}
    rest = {k for k, v in params.items() if k != "blocks" and "w_i8" in str(jax.tree.structure(v))}
    assert not rest, rest
    return out


def test_quantizes_the_modules_jax_does(models):
    jcfg, params, model, names = models
    want = _jax_int8_paths(params, jcfg)
    assert set(names) == want
    assert len(names) == 6 * (2 * len(CFG["block_idx_with_mot_ref"])
                              + CFG["num_layers"] - len(CFG["block_idx_with_mot_ref"]))
    assert all(isinstance(model.get_submodule(n), tcommon.Int8Linear) for n in names)
    assert not any(isinstance(m, torch.nn.Linear) and tcommon.is_int8_projection(n)
                   for n, m in model.named_modules())


def test_released_structure_has_498_projections():
    """41 MoT blocks x 12 + 1 plain block x 6, on the meta device."""
    with torch.device("meta"):
        model = CogVideoXTransformer3DMOTModel(CogVideoXMOTConfig.cogvideox_5b_i2v_vap())
    assert len(tcommon.quantize_transformer_linears(model)) == 498


def _inputs(cfg):
    rng = np.random.default_rng(7)
    b, c, hw, t, frames = 2, cfg.in_channels, 8, cfg.max_text_seq_length, 3
    return dict(
        hidden_states=rng.standard_normal((b, frames, c, hw, hw), np.float32),
        encoder_hidden_states=rng.standard_normal((b, t, cfg.text_embed_dim), np.float32),
        timestep=np.array([999.0, 321.0], np.float32),
        hidden_states_mot_ref=rng.standard_normal((b, frames, c, hw, hw), np.float32),
        encoder_hidden_states_mot_ref=rng.standard_normal((b, t, cfg.text_embed_dim),
                                                          np.float32),
    ), [dict(height=64, width=64, num_latent_frames=frames,
             attention_head_dim=cfg.attention_head_dim, patch_size=cfg.patch_size,
             sample_width=cfg.sample_width, sample_height=cfg.sample_height, mot_num=mot)
        for mot in (0, 1)]


# float32 on both sides, on the same int8 weights. Unquantised, the two
# forwards agree to 1e-4 (test_torch_transformer.py); here an activation that
# sits at a rounding boundary of its int8 code may also land one code apart
# on the two sides, which moves that projection's outputs by s_x * s_w *
# |w_i8| and the blocks after it carry it on (2.5e-4 on outputs of ~1.9 in
# both forms). The limit is 1e-3; one scale out of place reads far above it.
FWD_ATOL = 1e-3


@pytest.mark.parametrize("form", ["row", "chunk"])
def test_forward_matches_jax(models, monkeypatch, form):
    jcfg, params, model, _ = models
    inputs, rope_args = _inputs(model.config)
    monkeypatch.setenv("VAP_INT8_PALLAS", "1" if form == "chunk" else "0")

    def jax_fwd(x, ropes):
        return cogvideox_mot_forward(params, jcfg, **x, image_rotary_emb=ropes[0],
                                     image_rotary_emb_mot_ref=ropes[1], num_mot_ref=1)[0]

    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax.jit(jax_fwd)({k: jnp.asarray(v) for k, v in inputs.items()},
                                          [jax_rope(patch_size_t=None, **a) for a in rope_args]))
    assert tcommon.set_int8_act_scale(model, form) == 30
    launches = tint8.int8_linear_chunk.launches
    calls = tcommon.int8_linear_row.calls
    with torch.no_grad():
        got = model(**{k: torch.from_numpy(v) for k, v in inputs.items()},
                    image_rotary_emb=prepare_cogvideox_rotary_embeddings(**rope_args[0]),
                    image_rotary_emb_mot_ref=prepare_cogvideox_rotary_embeddings(**rope_args[1]),
                    num_mot_ref=1).numpy()
    # on the CPU the chunk form runs K3's plain version: no launch; the row
    # form counts one call per projection
    assert tint8.int8_linear_chunk.launches == launches
    assert tcommon.int8_linear_row.calls - calls == (30 if form == "row" else 0)
    assert np.isfinite(got).all()
    err = np.abs(got - ref).max()
    assert err <= FWD_ATOL, (err, np.abs(ref).max())


def _port_forward(model, inputs, rope_args):
    with torch.no_grad():
        return model(**{k: torch.from_numpy(v) for k, v in inputs.items()},
                     image_rotary_emb=prepare_cogvideox_rotary_embeddings(**rope_args[0]),
                     image_rotary_emb_mot_ref=prepare_cogvideox_rotary_embeddings(**rope_args[1]),
                     num_mot_ref=1)


@pytest.mark.parametrize("form", ["row", "chunk"])
def test_forward_limit_catches_a_scale_out_of_place(models, form):
    """A planted fault: the int8 rows of one feed-forward output projection
    rolled by one channel (a kernel that mixed up its N tiles would do so).
    Against the true weights it must break the limit above."""
    _, _, model, _ = models
    inputs, rope_args = _inputs(model.config)
    tcommon.set_int8_act_scale(model, form)
    ref = _port_forward(model, inputs, rope_args)
    layer = model.transformer_blocks[2].ff.net[2]
    true = layer.w_i8.clone()
    try:
        layer.w_i8.copy_(true.roll(1, dims=0))
        faulty = _port_forward(model, inputs, rope_args)
    finally:
        layer.w_i8.copy_(true)
    assert (faulty - ref).abs().max() > 10 * FWD_ATOL


class _Tokenizer:
    def __call__(self, texts, padding=None, max_length=16, truncation=True,
                 add_special_tokens=True, return_tensors="np"):
        ids = np.zeros((len(texts), max_length), np.int64)
        for i, t in enumerate(texts):
            for j, ch in enumerate(t[:max_length]):
                ids[i, j] = (ord(ch) * 7 + j) % 127 + 1
        return {"input_ids": ids}


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def _psnr(a, b, data_range=2.0):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return 10.0 * np.log10(data_range ** 2 / max(mse, 1e-12))


@pytest.mark.parametrize("form", ["row", "chunk"])
def test_w8a8_gate_on_a_vap_trajectory(form):
    """The port's W8A8 gate (``tests/test_int8_gate.py``'s criterion): over
    a 4-step VAP trajectory with shared inputs, the quantised pipeline's
    final latents have cosine >= 0.999 against the float pipeline's, and its
    decoded video a PSNR >= 30 dB. Four MoT blocks, 2 x 64 heads, random
    weights from a seed, float32 on the CPU."""
    cfg = CogVideoXMOTConfig.tiny(num_attention_heads=2, attention_head_dim=64, in_channels=8,
                                  out_channels=4, num_layers=4, block_idx_with_mot_ref=(0, 1, 2, 3))
    gen = torch.Generator().manual_seed(0)
    cpu, f32 = torch.device("cpu"), torch.float32
    txt_cfg = T5Config.tiny(d_model=cfg.text_embed_dim)
    pipe = CogVideoXVAPPipeline(build_random(CogVideoXTransformer3DMOTModel, cfg, cpu, f32, gen),
                                build_random(AutoencoderKLCogVideoX, CogVideoXVAEConfig.tiny(), cpu,
                                             f32, gen),
                                build_random(T5EncoderModel, txt_cfg, cpu, f32, gen), _Tokenizer(),
                                dtype=f32, device=cpu)
    rng = np.random.default_rng(0)
    h = w = 32
    args = dict(image=rng.uniform(-1, 1, (h, w, 3)).astype(np.float32), prompt="a cat",
                ref_videos=[rng.uniform(-1, 1, (9, h, w, 3)).astype(np.float32)],
                prompt_mot_ref=["explode it"], height=h, width=w, num_frames=9,
                num_inference_steps=4, guidance_scale=6.0, use_dynamic_cfg=True,
                max_sequence_length=cfg.max_text_seq_length,
                latents=torch.from_numpy(rng.standard_normal((1, 3, 4, h // 8, w // 8))
                                         .astype(np.float32)))
    lat_fp = pipe(**args, output_type="latent").numpy()
    vid_fp = pipe(**args)
    assert len(tcommon.quantize_transformer_linears(pipe.transformer, act_scale=form)) == 48
    lat_q = pipe(**args, output_type="latent").numpy()
    vid_q = pipe(**args)
    cos, psnr = _cos(lat_q, lat_fp), _psnr(vid_q, vid_fp)
    assert not np.array_equal(lat_q, lat_fp)
    assert cos >= 0.999, cos
    assert psnr >= 30.0, psnr
