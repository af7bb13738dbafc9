"""The CogVideoX pipeline's other sampling modes in the port against the JAX
pipeline on the same weights and inputs: the single-branch ablations,
plain image-to-video (no reference), text-to-video on a T2V-shaped model,
the ``discrete_long_reference`` RoPE, the tiled and sliced decode, model
offload, and the step cache and DPM in the plain mode.

The tiny models, prompts and inputs are those of
``tests/test_torch_pipeline.py`` (three blocks, MoT in 0-1, the learned
position table, a 64x64 image, a 9-frame reference, DDIM with dynamic CFG
at guidance 6), imported from there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pipeline import FakeTokenizer, H, W, _call_args, build_pipelines
from test_torch_step_cache import inject_jax_noise, make_pipelines, run_pair
from vap_tpu.models.cogvideox import CogVideoXMOTConfig as JaxMOTConfig
from vap_tpu.models.cogvideox import init_cogvideox_mot
from vap_tpu.models.cogvideox import vae as jvae
from vap_tpu.ops import rope as jrope
from vap_tpu.pipelines import cogvideox_i2v_mot as jpipe
from vap_tpu_torch import convert
from vap_tpu_torch.models.cogvideox import vae as tvae
from vap_tpu_torch.models.cogvideox.config import CogVideoXMOTConfig
from vap_tpu_torch.models.cogvideox.transformer_mot import CogVideoXTransformer3DMOTModel
from vap_tpu_torch.ops import rope as trope
from vap_tpu_torch.pipelines import cogvideox_i2v_mot as tpipe

# float32 end to end, as tests/test_torch_pipeline.py holds the MoT call:
# the frameworks sum in other orders
ATOL, RTOL = 2e-5, 1e-5


@pytest.fixture(scope="module")
def pipelines():
    return build_pipelines()


def _run(port, ref, output_type="latent", **extra):
    args, latents = _call_args()
    args.update(extra)
    want = np.asarray(ref(**args, latents=jnp.asarray(latents), output_type=output_type))
    got = port(**args, latents=torch.from_numpy(latents), output_type=output_type)
    got = got.numpy() if output_type == "latent" else got
    assert got.shape == want.shape and np.isfinite(got).all()
    return got, want


@pytest.mark.parametrize("mode", ["ablation_single_branch", "baseline_single_condition"])
def test_single_branch_modes_match_jax(pipelines, mode):
    """ablation_single_branch runs the trunk over target ‖ reference (six
    latent frames, where the learned position table holds three: the patch
    embedding takes a fresh sincos table at six, as JAX does) with the two
    RoPE tables concatenated, and keeps the target's frames;
    baseline_single_condition runs the trunk over the target alone."""
    port, ref = pipelines
    got, want = _run(port, ref, **{mode: True})
    assert got.shape == (1, 3, 4, H // 8, W // 8)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert port.stage_seconds["computed_steps"] == [0, 1, 2]


def test_plain_i2v_matches_jax(pipelines):
    port, ref = pipelines
    got, want = _run(port, ref, ref_videos=None, prompt_mot_ref=None)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_plain_equals_baseline_single_condition(pipelines):
    """JAX's own claim (tests/test_pipeline_cogvideox.py:153-173): with no
    reference the pipeline samples the trunk, which is what
    baseline_single_condition runs; the references it encodes are unused.
    In the port the two runs are the same operations: equal to the bit."""
    port, _ = pipelines
    args, latents = _call_args()
    baseline = port(**args, latents=torch.from_numpy(latents), output_type="latent",
                    baseline_single_condition=True)
    plain = port(**{**args, "ref_videos": None, "prompt_mot_ref": None},
                 latents=torch.from_numpy(latents), output_type="latent")
    assert torch.equal(plain, baseline)


@pytest.fixture(scope="module")
def t2v_pipelines(pipelines):
    """A T2V-shaped model (in_channels = the VAE's 4 latent channels, no
    MoT block) with the main fixture's VAE and T5."""
    port, ref = pipelines
    kw = dict(in_channels=4, out_channels=4, num_layers=2, block_idx_with_mot_ref=())
    t_cfg, jt_cfg = CogVideoXMOTConfig.tiny(**kw), JaxMOTConfig.tiny(**kw)
    jparams = init_cogvideox_mot(jax.random.PRNGKey(3), jt_cfg)
    transformer = CogVideoXTransformer3DMOTModel(t_cfg).eval()
    transformer.load_state_dict(convert.from_jax_transformer(jax.tree.map(np.asarray, jparams),
                                                             t_cfg))
    t2v_port = tpipe.CogVideoXVAPPipeline(transformer, port.vae, port.text_encoder,
                                          FakeTokenizer(), dtype=torch.float32, device="cpu")
    t2v_ref = jpipe.CogVideoXVAPPipeline(
        transformer_cfg=jt_cfg, vae_cfg=ref.vae_cfg, text_cfg=ref.text_cfg,
        params=dict(ref.params, transformer=jparams), tokenizer=FakeTokenizer(),
        dtype=jnp.float32)
    return t2v_port, t2v_ref


@pytest.mark.parametrize("output_type", ["latent", "np"])
def test_t2v_matches_jax(t2v_pipelines, output_type):
    """image=None on a T2V model: 4-channel latents, no image latents
    concatenated, decoded."""
    port, ref = t2v_pipelines
    got, want = _run(port, ref, output_type=output_type, image=None, ref_videos=None,
                     prompt_mot_ref=None)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert "vae_encode" in port.stage_seconds


@pytest.mark.parametrize("mot_num", [1, 2, 3])
@pytest.mark.parametrize("ref_type", ["continous_negative", "discrete_long_reference"])
def test_reference_rope_tables_match_jax(mot_num, ref_type):
    kw = dict(attention_head_dim=64, patch_size=2, sample_width=90, sample_height=60,
              mot_num=mot_num, ref_type=ref_type)
    got = trope.prepare_cogvideox_rotary_embeddings(480, 720, 13, **kw)
    want = jrope.prepare_cogvideox_rotary_embeddings(480, 720, 13, patch_size_t=None, **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_discrete_long_reference_positions():
    """Reference r sits at frames 50 + 30 r + arange(T): with T = 13 and
    two references, 50..62 then 80..92 (``vap_tpu/ops/rope.py:109-113``)."""
    kw = dict(crops_coords=((0, 0), (2, 2)), grid_size=(2, 2), temporal_size=13, mot_num=2)
    cos, sin = trope.get_3d_rotary_pos_embed_np(16, **kw, ref_type="discrete_long_reference")
    t_cos, t_sin = trope.get_1d_rotary_pos_embed(
        4, np.concatenate([50 + np.arange(13), 80 + np.arange(13)]).astype(np.float32))
    np.testing.assert_array_equal(cos.reshape(26, 4, 16)[:, 0, :4], t_cos)
    np.testing.assert_array_equal(sin.reshape(26, 4, 16)[:, 0, :4], t_sin)
    with pytest.raises(ValueError, match="Invalid ref_type"):
        trope.get_3d_rotary_pos_embed_np(16, **kw, ref_type="bogus")


def test_discrete_long_reference_pipeline_matches_jax(pipelines):
    port, ref = pipelines
    got, want = _run(port, ref, ref_type="discrete_long_reference")
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    base, _ = _run(port, ref)
    assert np.abs(got - base).max() > 1e-4  # the reference positions moved the result


def test_tiled_decode_matches_jax(pipelines):
    """Latents of 32 x 40 make a 2 x 2 grid of 30 x 45 tiles every 25 x 36,
    each blended over 40 rows and 72 columns into its neighbours."""
    port, ref = pipelines
    z = np.random.default_rng(5).standard_normal((1, 2, 32, 40, 4)).astype(np.float32)
    with torch.no_grad():
        got = tvae.vae_decode_tiled(port.vae, torch.from_numpy(z)).numpy()
    want = np.asarray(jvae.vae_decode_tiled(ref.params["vae"], ref.vae_cfg, jnp.asarray(z)))
    assert got.shape == want.shape and got.shape[2:] == (256, 320, 3)
    # float32 convolutions on both sides, four tiles each
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-5)
    with torch.no_grad():
        whole = tvae.vae_decode_streamed(port.vae, torch.from_numpy(z)).numpy()
    assert np.abs(got - whole).max() > 1e-3  # the tiles are not the whole-frame decode


def test_tiled_and_sliced_pipeline_matches_jax(pipelines):
    port, ref = pipelines
    tiled = tpipe.CogVideoXVAPPipeline(port.transformer, port.vae, port.text_encoder,
                                       FakeTokenizer(), dtype=torch.float32, device="cpu",
                                       enable_vae_tiling=True, enable_vae_slicing=True)
    ref_tiled = jpipe.CogVideoXVAPPipeline(
        transformer_cfg=ref.transformer_cfg, vae_cfg=ref.vae_cfg, text_cfg=ref.text_cfg,
        params=ref.params, tokenizer=FakeTokenizer(), dtype=jnp.float32,
        enable_vae_tiling=True, enable_vae_slicing=True)
    got, want = _run(tiled, ref_tiled, output_type="np")
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_sliced_decode_equals_the_batch(pipelines):
    port, _ = pipelines
    sliced = tpipe.CogVideoXVAPPipeline(port.transformer, port.vae, port.text_encoder,
                                        FakeTokenizer(), dtype=torch.float32, device="cpu",
                                        enable_vae_slicing=True)
    z = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 2, 8, 8, 4)).astype(np.float32))
    with torch.no_grad():
        whole = port._decode(z)
        parts = sliced._decode(z)
    # the batch of two and the two slices run other conv algorithms in f32
    torch.testing.assert_close(parts, whole, atol=ATOL, rtol=RTOL)


def test_offload_equals_resident(pipelines):
    """With enable_model_offload one component at a time is staged (here
    on the CPU, where the weights live too): the result is the same to the
    bit, in the MoT call and in the plain one."""
    port, _ = pipelines
    offloaded = tpipe.CogVideoXVAPPipeline(port.transformer, port.vae, port.text_encoder,
                                           FakeTokenizer(), dtype=torch.float32, device="cpu",
                                           enable_model_offload=True)
    args, latents = _call_args()
    for extra in ({}, dict(ref_videos=None, prompt_mot_ref=None)):
        call = dict(args, **extra, latents=torch.from_numpy(latents), num_inference_steps=2)
        np.testing.assert_array_equal(offloaded(**call), port(**call))
        assert set(offloaded.stage_seconds["staging"]) == {"text_encoder", "vae", "transformer"}
        assert len(offloaded._staged) == 1  # at most one component staged at a time


@pytest.fixture(scope="module")
def dpm_pipelines():
    return make_pipelines()["dpm"]


def test_plain_mode_under_dpm_and_step_cache_matches_jax(dpm_pipelines):
    """DPM with the uniform cache in the plain mode: the reuse step draws
    its noise and carries old_x0 as in the MoT call."""
    port, ref = dpm_pipelines
    noise = inject_jax_noise(port, 4)
    got, want = run_pair(port, ref, 4, step_cache="uniform:2:1:1", ref_videos=None,
                         prompt_mot_ref=None)
    assert not noise and port.stage_seconds["computed_steps"] == [0, 1, 3]
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
