"""The denoise step cache in the port against the JAX package: the copied
schedule parsers, and the small CogVideoX VAP pipeline against the JAX
pipeline on the same weights and inputs with the uniform and the adaptive
cache, under DDIM with dynamic CFG and under DPM (the per-step noise of the
JAX pipeline fed to both). Reuse steps run no transformer forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vap_tpu.models.cogvideox import CogVideoXMOTConfig as JaxMOTConfig
from vap_tpu.models.cogvideox import init_cogvideox_mot
from vap_tpu.models.cogvideox.vae import CogVideoXVAEConfig as JaxVAEConfig
from vap_tpu.models.cogvideox.vae import init_cogvideox_vae
from vap_tpu.models.text_encoders import T5Config as JaxT5Config
from vap_tpu.models.text_encoders import init_t5_encoder
from vap_tpu.ops.schedulers import CogVideoXDDIMScheduler as JaxDDIM
from vap_tpu.ops.schedulers import CogVideoXDPMScheduler as JaxDPM
from vap_tpu.pipelines import cogvideox_i2v_mot as jpipe
from vap_tpu.pipelines import step_cache as jsc
from vap_tpu_torch import convert
from vap_tpu_torch.models.cogvideox.config import CogVideoXMOTConfig
from vap_tpu_torch.models.cogvideox.transformer_mot import CogVideoXTransformer3DMOTModel
from vap_tpu_torch.models.cogvideox.vae import AutoencoderKLCogVideoX, CogVideoXVAEConfig
from vap_tpu_torch.models.text_encoders.t5 import T5Config, T5EncoderModel
from vap_tpu_torch.ops.schedulers import CogVideoXDDIMScheduler, CogVideoXDPMScheduler
from vap_tpu_torch.pipelines import cogvideox_i2v_mot as tpipe
from vap_tpu_torch.pipelines import step_cache as tsc

T_CFG = dict(in_channels=8, out_channels=4, num_layers=3, block_idx_with_mot_ref=(0, 1),
             use_learned_positional_embeddings=True)
H = W = 64
F = 9
SEED = 42
# float32 end to end, as tests/test_torch_pipeline.py holds the uncached
# pipeline: the frameworks sum in other orders
ATOL, RTOL = 2e-5, 1e-5


class FakeTokenizer:
    """Deterministic character ids, padded to max_length."""

    def __call__(self, texts, padding=None, max_length=16, truncation=True,
                 add_special_tokens=True, return_tensors="np"):
        ids = np.zeros((len(texts), max_length), np.int32)
        for i, t in enumerate(texts):
            for j, ch in enumerate(t[:max_length]):
                ids[i, j] = (ord(ch) * 7 + j) % 127 + 1
        return {"input_ids": ids, "attention_mask": (ids > 0).astype(np.int32)}


def make_pipelines():
    """{"ddim": (port, jax), "dpm": (port, jax)} on one set of tiny weights,
    made by the JAX package's initializers and carried over by ``convert``."""
    key = jax.random.PRNGKey(0)
    t_cfg, jt_cfg = CogVideoXMOTConfig.tiny(**T_CFG), JaxMOTConfig.tiny(**T_CFG)
    txt_cfg = T5Config.tiny(d_model=t_cfg.text_embed_dim)
    jtxt_cfg = JaxT5Config.tiny(d_model=t_cfg.text_embed_dim)
    vae_cfg, jvae_cfg = CogVideoXVAEConfig.tiny(), JaxVAEConfig.tiny()
    jparams = {"transformer": init_cogvideox_mot(key, jt_cfg),
               "text_encoder": init_t5_encoder(key, jtxt_cfg),
               "vae": jax.jit(init_cogvideox_vae, static_argnums=1)(key, jvae_cfg)}
    np_params = jax.tree.map(np.asarray, jparams)
    transformer = CogVideoXTransformer3DMOTModel(t_cfg).eval()
    transformer.load_state_dict(convert.from_jax_transformer(np_params["transformer"], t_cfg))
    text_encoder = T5EncoderModel(txt_cfg).eval()
    text_encoder.load_state_dict(convert.from_jax_t5(np_params["text_encoder"], txt_cfg))
    vae = AutoencoderKLCogVideoX(vae_cfg).eval()
    vae.load_state_dict(convert.from_jax_vae(np_params["vae"], vae_cfg))
    out = {}
    for name, port_sched, jax_sched in (("ddim", CogVideoXDDIMScheduler(), JaxDDIM()),
                                        ("dpm", CogVideoXDPMScheduler(), JaxDPM())):
        port = tpipe.CogVideoXVAPPipeline(transformer, vae, text_encoder, FakeTokenizer(),
                                          scheduler=port_sched, dtype=torch.float32, device="cpu")
        ref = jpipe.CogVideoXVAPPipeline(transformer_cfg=jt_cfg, vae_cfg=jvae_cfg,
                                         text_cfg=jtxt_cfg, params=jparams,
                                         tokenizer=FakeTokenizer(), scheduler=jax_sched,
                                         dtype=jnp.float32)
        out[name] = (port, ref)
    return out


def call_args(steps):
    rng = np.random.default_rng(0)
    return dict(
        image=rng.uniform(-1, 1, (H, W, 3)).astype(np.float32),
        prompt="a cat", ref_videos=[rng.uniform(-1, 1, (F, H, W, 3)).astype(np.float32)],
        prompt_mot_ref=["explode it"], height=H, width=W, num_frames=F,
        num_inference_steps=steps, guidance_scale=6.0, use_dynamic_cfg=True,
        max_sequence_length=6, seed=SEED, output_type="latent",
    ), rng.standard_normal((1, 3, 4, H // 8, W // 8)).astype(np.float32)


def jax_dpm_noise(seed, shape, steps):
    """The JAX pipeline's DPM noise, step by step: PRNGKey(seed), one split
    for the initial latents (``cogvideox_i2v_mot.py:573``), one for the
    denoise key (:604), then one split per step (:277)."""
    key = jax.random.PRNGKey(seed)
    key, _ = jax.random.split(key)
    _, dkey = jax.random.split(key)
    out = []
    for _ in range(steps):
        dkey, nkey = jax.random.split(dkey)
        out.append(np.array(jax.random.normal(nkey, shape, jnp.float32)))
    return out


def inject_jax_noise(port, steps, shape=(1, 3, 4, H // 8, W // 8)):
    """Replace the port pipeline's per-step noise by the JAX pipeline's."""
    noise = [torch.from_numpy(n) for n in jax_dpm_noise(SEED, shape, steps)]
    port.step_noise = lambda gen, shape: noise.pop(0)
    return noise


def run_pair(port, ref, steps, **extra):
    args, latents = call_args(steps)
    args.update(extra)
    want = np.asarray(ref(**args, latents=jnp.asarray(latents)))
    got = port(**args, latents=torch.from_numpy(latents)).numpy()
    return got, want


@pytest.fixture(scope="module")
def pipelines():
    return make_pipelines()


SPECS = [None, "none", "uniform:2", "uniform:2:1:1", "uniform:3:1:0", "uniform:1", "uniform:4:2:3",
         "adaptive:0.1", "adaptive:0.12:2:1", "adaptive:0", "adaptive:1e9:1:0",
         "uniform:0", "uniform:2:0", "uniform:2:1:-1", "uniform", "uniform:1:2:3:4",
         "adaptive:-0.1", "adaptive", "adaptive:0.1:0", "adaptive:1:2:3:4", "bogus:2", "uniform:x"]


def _outcome(fn, spec, steps):
    try:
        got = fn(spec, steps)
    except ValueError as e:
        return ("ValueError", str(e))
    if isinstance(got, jsc.StepCacheSpec) or isinstance(got, tsc.StepCacheSpec):
        return (got.kind, got.mask.tolist(), got.thresh)
    return None if got is None else got.tolist()


@pytest.mark.parametrize("steps", [4, 10])
@pytest.mark.parametrize("spec", SPECS)
def test_parsers_match_jax(spec, steps):
    for port_fn, jax_fn in ((tsc.parse_step_cache, jsc.parse_step_cache),
                            (tsc.parse_step_cache_schedule, jsc.parse_step_cache_schedule)):
        assert _outcome(port_fn, spec, steps) == _outcome(jax_fn, spec, steps)


def test_uniform_cache_matches_jax(pipelines):
    """uniform:2:1:1 over 4 DDIM steps computes 0, 1 and 3 and reuses step
    1's raw prediction at step 2, recombined with step 2's own guidance."""
    port, ref = pipelines["ddim"]
    got, want = run_pair(port, ref, 4, step_cache="uniform:2:1:1")
    assert port.stage_seconds["computed_steps"] == [0, 1, 3]
    assert len(port.stage_seconds["denoise_steps"]) == 4
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    uncached, _ = run_pair(port, ref, 4)
    assert np.abs(got - uncached).max() > 1e-3  # the reuse step changed the trajectory


# steps 1 and 2 decide at run time (warmup 1, cooldown 1 over 4 steps); the
# relative L1 change of the inputs is 0.056 at step 1 and 0.111 at step 2
# here, so 0.1 skips step 1 (0.056) and computes step 2 (0.167), each
# decision at least 0.04 away from the threshold
ADAPTIVE = "adaptive:0.1:1:1"


def test_adaptive_cache_matches_jax(pipelines):
    port, ref = pipelines["ddim"]
    got, want = run_pair(port, ref, 4, step_cache=ADAPTIVE)
    assert port.stage_seconds["computed_steps"] == [0, 2, 3]
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_uniform_cache_under_dpm_matches_jax(pipelines):
    """DPM carries old_x0 through the reuse step and draws noise on every
    step; both pipelines get the JAX pipeline's noise."""
    port, ref = pipelines["dpm"]
    noise = inject_jax_noise(port, 4)
    got, want = run_pair(port, ref, 4, step_cache="uniform:2:1:1")
    assert not noise  # drawn on all four steps, the reuse step too
    assert port.stage_seconds["computed_steps"] == [0, 1, 3]
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("spec", ["uniform:1:1:0", "adaptive:0:1:0"])
def test_all_compute_schedule_equals_no_cache(pipelines, spec):
    port, _ = pipelines["ddim"]
    args, latents = call_args(3)
    base = port(**args, latents=torch.from_numpy(latents))
    cached = port(**args, latents=torch.from_numpy(latents), step_cache=spec)
    assert port.stage_seconds["computed_steps"] == [0, 1, 2]
    assert torch.equal(base, cached)


def test_reuse_steps_run_no_forward(pipelines, monkeypatch):
    """uniform:3:1:0 over 5 steps (compute mask T, T, F, F, T): the
    transformer runs exactly 3 times, as ``tests/test_step_cache.py:288``
    counts the JAX forwards."""
    port, _ = pipelines["ddim"]
    calls = []
    forward = port.transformer.forward

    def counting(*a, **kw):
        calls.append(1)
        return forward(*a, **kw)

    monkeypatch.setattr(port.transformer, "forward", counting)
    args, latents = call_args(5)
    out = port(**args, latents=torch.from_numpy(latents), step_cache="uniform:3:1:0")
    assert len(calls) == 3 and port.stage_seconds["computed_steps"] == [0, 1, 4]
    assert torch.isfinite(out).all()
