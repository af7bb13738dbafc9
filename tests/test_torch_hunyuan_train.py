"""The port's HunyuanVideo LoRA training path against the JAX package: the
transformer under grad (K7's forward and backward in their plain form), the
flow-matching loss with LoRA gradients, the adapter set, the trainer and
the CLI, and the causal VAE's encoder with ``prepare_latents``.

Tiny configs, weights from the JAX initialisers (jittered by a seeded
normal, so that no bias is zero and no norm scale is one) carried over with
``convert``; inputs from numpy seeds; float32 on both sides. The JAX
transformer runs under "flash_varlen" (its K7 Pallas kernels, forward and
backward, in interpret mode) where the port's runs under "flash"; the loss
on the JAX side under "xla" (its masked dense attention, jitted), as the
Wan loss tests do. Sigmas and noise are JAX's draws from
``jax.random.split(key)``, passed to the port's loss; the adapters are
JAX's ``init_lora``, carried over by ``convert.from_jax_lora``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vap_tpu.models.hunyuan_video import HunyuanVideoConfig as JaxConfig
from vap_tpu.models.hunyuan_video import hunyuan_video_forward, init_hunyuan_video
from vap_tpu.models.hunyuan_video import vae as jvae
from vap_tpu.ops.attention import attention_provider as jax_provider
from vap_tpu.training import lora as jlora
from vap_tpu.training import optimizer as jopt
from vap_tpu.training import train_step as jts
from vap_tpu.training.specs import HunyuanVideoSpec
from vap_tpu_torch import convert
from vap_tpu_torch import train as train_cli
from vap_tpu_torch.data.precomputation import write_precomputed
from vap_tpu_torch.models.hunyuan_video import vae as tvae
from vap_tpu_torch.models.hunyuan_video.config import HunyuanVideoConfig
from vap_tpu_torch.models.hunyuan_video.transformer import HunyuanVideoTransformer3DModel
from vap_tpu_torch.models.random_init import build_random
from vap_tpu_torch.ops import flash_attention as tfa
from vap_tpu_torch.ops.attention import attention_provider
from vap_tpu_torch.training import lora as tlora
from vap_tpu_torch.training import optimizer as topt
from vap_tpu_torch.training import train_step as tts
from vap_tpu_torch.training.args import TrainingArgs
from vap_tpu_torch.training.trainer import SFTTrainer

# the recipe (examples/training/sft/hunyuan_video/modal_labs_dissolve/train.sh)
RECIPE_TARGETS = "to_q to_k to_v to_out"
SCHEME = "logit_normal"
RANK, ALPHA = 4, 8.0  # alpha / rank = 2: the scale is not 1
# float32 through the refiner and 2 + 2 blocks, whose modulations reach
# |x| ~ 10 where f32 rounds at 1e-6: 1e-4 of the output's scale, as
# test_torch_hunyuan.py holds the forward; each gradient tensor within 1e-4
# of its own largest entry (the backward sums the same terms in another order)
TRANSFORMER_ATOL = 1e-4
GRAD_RTOL = 1e-4
LOSS_RTOL = 1e-5
# the VAE encoder: float32 convs in another summation order, 2e-5 of scale
# (test_torch_hunyuan.py's VAE limit)
VAE_ATOL = 2e-5
B, S_TXT, VALID = 2, 8, (8, 3)  # sample 1's text mask is a prefix of 3 ones


def _jitter(tree, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.asarray(x, np.float32)
                        + scale * rng.standard_normal(np.shape(x)).astype(np.float32), tree)


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg, cfg = JaxConfig.tiny(), HunyuanVideoConfig.tiny()
    params = _jitter(jax.jit(init_hunyuan_video, static_argnums=1)(jax.random.PRNGKey(0), jcfg), 1)
    return jcfg, cfg, params


def _model(cfg, params):
    model = HunyuanVideoTransformer3DModel(cfg)
    model.load_state_dict(convert.from_jax_hunyuan_transformer(params, cfg))
    return model


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    mask = (np.arange(S_TXT)[None, :] < np.array(VALID)[:, None]).astype(np.float32)
    return {"latents": rng.standard_normal((B, cfg.in_channels, 2, 4, 4), np.float32),
            "encoder_hidden_states": rng.standard_normal((B, S_TXT, cfg.text_embed_dim),
                                                         np.float32),
            "pooled_projections": rng.standard_normal((B, cfg.pooled_projection_dim), np.float32),
            "prompt_attention_mask": mask}


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_draws(key, shape):
    """The sigmas and noise ``hunyuan_loss`` draws from ``key``."""
    k_s, k_n = jax.random.split(key)
    sigmas = jts.sample_flow_sigmas(k_s, shape[0], scheme=SCHEME)
    noise = jax.random.normal(k_n, shape, jnp.float32)
    return {"sigmas": torch.from_numpy(np.array(sigmas)),
            "noise": torch.from_numpy(np.array(noise))}


def _assert_grads(got, want, what):
    """Each gradient within GRAD_RTOL of its own largest entry, and at least
    of 1e-3 of the largest entry of all: a gradient that is 0 in exact
    arithmetic (a key bias, which shifts every score of a row alike) is
    rounding noise on both sides."""
    floor = 1e-3 * max(np.abs(ref.numpy()).max() for ref in want.values())
    for name, ref in want.items():
        ref = ref.numpy()
        g = got[name]
        g = np.zeros_like(ref) if g is None else g.numpy()
        scale = max(np.abs(ref).max(), floor)
        assert np.abs(g - ref).max() <= GRAD_RTOL * scale, (what, name, np.abs(g - ref).max(),
                                                            scale)


# ---------------------------------------------------------------------------
# the transformer under grad
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_transformer_grads():
    """JAX's side of ``test_transformer_grads_match_jax``, shared by its
    cases: the batch, the output weights, timesteps and guidance, and
    ``jax.grad`` of the weighted output (params, latents, text states) with
    the output itself."""
    jcfg, cfg, params = _setup()
    batch = _batch(cfg, 2)
    w = np.random.default_rng(3).standard_normal(batch["latents"].shape).astype(np.float32)
    # guidance 1.0 x 1000, what hunyuan_loss passes in training
    t, g = np.array([250.0, 900.0], np.float32), np.array([1000.0, 1000.0], np.float32)

    def jax_loss(p, x, enc):
        out = hunyuan_video_forward(p, jcfg, hidden_states=x, encoder_hidden_states=enc,
                                    pooled_projections=jnp.asarray(batch["pooled_projections"]),
                                    timestep=jnp.asarray(t), guidance=jnp.asarray(g),
                                    encoder_attention_mask=jnp.asarray(
                                        batch["prompt_attention_mask"]), remat=False)
        return jnp.sum(out * w), out

    with jax_provider("flash_varlen"), pltpu.force_tpu_interpret_mode():
        want, want_out = jax.grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
            _jnp(params), jnp.asarray(batch["latents"]), jnp.asarray(batch["encoder_hidden_states"]))
    want_params = convert.from_jax_hunyuan_transformer(jax.tree.map(np.asarray, want[0]), cfg)
    return batch, w, t, g, want_params, np.asarray(want_out), np.array(want[1]), np.array(want[2])


@pytest.mark.parametrize("remat", [False, "full"])
def test_transformer_grads_match_jax(remat):
    """The port's forward and its gradients (latents, text states and every
    weight) under "flash" (K7's plain forward and backward through
    ``FlashAttentionFunction``), with and without block remat, against
    ``jax.grad`` of ``hunyuan_video_forward`` under "flash_varlen" in
    interpret mode, with a ragged text mask and a loss that weights every
    output element differently."""
    _, cfg, params = _setup()
    batch, w, t, g, want_params, want_out, want_x, want_enc = _jax_transformer_grads()
    model = _model(cfg, params)
    x = torch.from_numpy(batch["latents"]).requires_grad_()
    enc = torch.from_numpy(batch["encoder_hidden_states"]).requires_grad_()
    before = tfa.flash_attention_backward.launches_varlen
    with attention_provider("flash"):
        out = model(hidden_states=x, encoder_hidden_states=enc,
                    pooled_projections=torch.from_numpy(batch["pooled_projections"]),
                    timestep=torch.from_numpy(t), guidance=torch.from_numpy(g),
                    encoder_attention_mask=torch.from_numpy(batch["prompt_attention_mask"]),
                    remat=remat)
        (out * torch.from_numpy(w)).sum().backward()
    assert tfa.flash_attention_backward.launches_varlen == before  # CPU: plain versions only
    scale = max(np.abs(want_out).max(), 1.0)
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=TRANSFORMER_ATOL * scale,
                               rtol=0)
    _assert_grads({"latents": x.grad}, {"latents": torch.from_numpy(want_x)}, "inputs")
    _assert_grads({"text": enc.grad}, {"text": torch.from_numpy(want_enc)}, "inputs")
    # the text states past sample 1's mask reach no output
    assert not enc.grad[1, VALID[1]:].any()
    _assert_grads({n: p.grad for n, p in model.named_parameters()}, want_params, "weights")


# ---------------------------------------------------------------------------
# LoRA: the adapter set, the loss and its gradients
# ---------------------------------------------------------------------------

def _jax_init_lora(params, seed, b_scale=0.0):
    targets = jts.parse_target_modules(RECIPE_TARGETS)
    lora = jax.tree.map(np.asarray, jlora.init_lora(jax.random.PRNGKey(seed), _jnp(params),
                                                    rank=RANK, targets=targets, mot_only=False))
    if b_scale:  # B away from 0, so that A has a gradient
        rng = np.random.default_rng(seed)
        lora = jax.tree.map(lambda x: x + b_scale * rng.standard_normal(x.shape).astype(
            np.float32) if x.shape[-2] == RANK else x, lora)
    return lora


def test_adapter_names_match_jax():
    """``target_names`` on the recipe's targets selects, name for name, the
    linears JAX's ``_is_target`` adapts (``from_jax_lora`` maps the stacked
    dual, single and refiner blocks onto the port's module lists): q, k, v
    and out of the dual blocks and the refiner, q, k, v of the single
    blocks (pre-only), none of the added or feed-forward projections; 208
    at the released structure."""
    jcfg, cfg, params = _setup()
    targets = jts.parse_target_modules(RECIPE_TARGETS)
    want = convert.from_jax_lora(_jax_init_lora(params, 1), cfg)
    model = _model(cfg, params)
    got = tlora.init_lora(model, RANK, targets, mot_only=False,
                          generator=torch.Generator().manual_seed(1))
    assert sorted(tlora.target_names(model, targets)) == sorted(want) == sorted(got)
    assert {n: {k: v.shape for k, v in ab.items()} for n, ab in got.items()} == \
        {n: {k: v.shape for k, v in ab.items()} for n, ab in want.items()}
    per = 4 * cfg.num_layers + 3 * cfg.num_single_layers + 4 * cfg.num_refiner_layers
    assert len(got) == per and not any("add_" in n or ".ff" in n for n in got)
    with torch.device("meta"):
        released = HunyuanVideoTransformer3DModel(HunyuanVideoConfig.hunyuan_video_t2v())
    assert len(tlora.target_names(released, targets)) == 20 * 4 + 40 * 3 + 2 * 4 == 208


@functools.lru_cache(maxsize=None)
def _jax_lora_fns(lr):
    jcfg, _, _ = _setup()
    tx = jopt.get_optimizer("adamw", jopt.get_lr_schedule("constant", lr), weight_decay=1e-4,
                            max_grad_norm=1.0)
    _, grad_fn, _, step_fn = jts.make_lora_sft_step(
        jts.hunyuan_loss, jts.HunyuanTrainStepConfig(model=jcfg, flow_weighting_scheme=SCHEME,
                                                     remat=False), tx, rank=RANK, alpha=ALPHA,
        targets=jts.parse_target_modules(RECIPE_TARGETS))
    return jax.jit(grad_fn), jax.jit(step_fn)


def test_hunyuan_loss_and_lora_grads_match_jax():
    """``hunyuan_loss`` through the adapted model on JAX's draws and
    adapters: the loss, and each adapter's gradient; no frozen weight gets
    a gradient."""
    jcfg, cfg, params = _setup()
    batch = _batch(cfg, 10)
    key = jax.random.PRNGKey(11)
    jl = _jax_init_lora(params, 3, b_scale=0.1)
    with jax_provider("xla"):  # read while tracing
        ref_grads, metrics = _jax_lora_fns(1e-3)[0](_jnp(jl), _jnp(params), _jnp(batch), key)
    ref = convert.from_jax_lora(jax.tree.map(np.asarray, ref_grads), cfg)

    model = _model(cfg, params).requires_grad_(False)
    lora = tlora.apply_lora(model, convert.from_jax_lora(jl, cfg), alpha=ALPHA, rank=RANK)
    step_cfg = tts.HunyuanTrainStepConfig(model=cfg, flow_weighting_scheme=SCHEME, remat="full")
    loss, got_metrics = tts.hunyuan_loss(model, step_cfg, _torch(batch),
                                         **_jax_draws(key, batch["latents"].shape))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(metrics["loss"]), rtol=LOSS_RTOL)
    assert got_metrics["loss"].item() == loss.item()
    assert lora.keys() == ref.keys()
    _assert_grads({f"{n}.{k}": v.grad for n, ab in lora.items() for k, v in ab.items()},
                  {f"{n}.{k}": v for n, ab in ref.items() for k, v in ab.items()}, "adapters")
    assert all(p.grad is None for n, p in model.named_parameters() if "lora_" not in n)


def test_hunyuan_step_matches_jax():
    """One ``make_lora_sft_step(hunyuan_loss, ...)`` update on both sides
    from JAX's adapters (B jittered), AdamW at a constant lr with clipping:
    the grad norm and the adapters after the update."""
    jcfg, cfg, params = _setup()
    lr, batch, key = 1e-3, _batch(cfg, 20), jax.random.PRNGKey(21)
    jl = _jax_init_lora(params, 5, b_scale=0.1)
    tx = jopt.get_optimizer("adamw", jopt.get_lr_schedule("constant", lr), weight_decay=1e-4,
                            max_grad_norm=1.0)
    with jax_provider("xla"):
        jlora_p, _, jmetrics = _jax_lora_fns(lr)[1](_jnp(jl), _jnp(params), tx.init(_jnp(jl)),
                                                    _jnp(batch), key)
    model = _model(cfg, params)
    lora, opt, step_fn = tts.make_lora_sft_step(
        tts.hunyuan_loss, tts.HunyuanTrainStepConfig(model=cfg, flow_weighting_scheme=SCHEME),
        model, lambda p: topt.get_optimizer("adamw", p, topt.get_lr_schedule("constant", lr),
                                            weight_decay=1e-4, max_grad_norm=1.0),
        rank=RANK, alpha=ALPHA, targets=tts.parse_target_modules(RECIPE_TARGETS))
    with torch.no_grad():  # JAX's adapters in place of the port's draw
        for n, ab in convert.from_jax_lora(jl, cfg).items():
            lora[n]["A"].copy_(ab["A"])
            lora[n]["B"].copy_(ab["B"])
    metrics = step_fn(model, _torch(batch), **_jax_draws(key, batch["latents"].shape))
    np.testing.assert_allclose(metrics["grad_norm"].item(), float(jmetrics["grad_norm"]),
                               rtol=GRAD_RTOL)
    ref = convert.from_jax_lora(jax.tree.map(np.asarray, jlora_p), cfg)
    for n, ab in lora.items():
        for part in "AB":
            np.testing.assert_allclose(ab[part].detach().numpy(), ref[n][part].numpy(),
                                       atol=1e-6, rtol=0, err_msg=f"{n}.{part}")


def test_full_finetune_step_matches_jax():
    """``make_hunyuan_train_step`` (every weight trains) against JAX's on
    the same draws: the loss and the global grad norm of one step."""
    jcfg, cfg, params = _setup()
    batch, key = _batch(cfg, 30), jax.random.PRNGKey(31)
    tx = jopt.get_optimizer("adamw", jopt.get_lr_schedule("constant", 1e-4), max_grad_norm=1.0)
    init_fn, step_fn = jts.make_hunyuan_train_step(
        jts.HunyuanTrainStepConfig(model=jcfg, flow_weighting_scheme=SCHEME, remat=False), tx)
    train, frozen, state = init_fn(_jnp(params))
    with jax_provider("xla"):
        _, _, jmetrics = jax.jit(step_fn)(train, frozen, state, _jnp(batch), key)

    model = _model(cfg, params)
    opt = topt.get_optimizer("adamw", model.parameters(), topt.get_lr_schedule("constant", 1e-4),
                             max_grad_norm=1.0)
    step = tts.make_hunyuan_train_step(
        tts.HunyuanTrainStepConfig(model=cfg, flow_weighting_scheme=SCHEME), opt)
    metrics = step(model, _torch(batch), **_jax_draws(key, batch["latents"].shape))
    np.testing.assert_allclose(metrics["loss"].item(), float(jmetrics["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(metrics["grad_norm"].item(), float(jmetrics["grad_norm"]),
                               rtol=GRAD_RTOL)
    assert opt.count == 1


# ---------------------------------------------------------------------------
# the trainer and the CLI
# ---------------------------------------------------------------------------

TINY_LAT = (1, 4, 2, 4, 4)  # [1, C, F, H, W], channel-first as HunyuanVideoSpec writes it


def _item(i, valid=5):
    rng = np.random.default_rng(i)
    cfg = HunyuanVideoConfig.tiny()
    mask = (np.arange(S_TXT) < valid).astype(np.float32)[None]
    return ({"caption": f"clip {i}",
             "encoder_hidden_states": rng.standard_normal((1, S_TXT, cfg.text_embed_dim),
                                                          np.float32),
             "prompt_attention_mask": mask,
             "pooled_projections": rng.standard_normal((1, cfg.pooled_projection_dim),
                                                       np.float32)},
            {"latents": rng.standard_normal(TINY_LAT, np.float32)})


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("hunyuan_precomputed"))
    write_precomputed(root, [_item(i, valid=5 + i) for i in range(2)])
    return root


def _args(cache, out, **kw):
    base = dict(model_name="hunyuan_video", training_type="lora", precomputation_dir=cache,
                output_dir=str(out), rank=RANK, lora_alpha=int(ALPHA), target_modules=RECIPE_TARGETS,
                flow_weighting_scheme=SCHEME, lr=1e-2, lr_scheduler="constant", seed=3,
                checkpointing_steps=100, logging_steps=1)
    base.update(kw)
    return TrainingArgs(**base)


def _tiny_model(seed=0):
    return build_random(HunyuanVideoTransformer3DModel, HunyuanVideoConfig.tiny(), "cpu",
                        torch.float32, torch.Generator().manual_seed(seed))


def _fixed_loss(trainer, item):
    """The loss on one item at fixed draws (sigma 0.5, seeded noise)."""
    cond, lat = item
    batch = _torch({k: v for k, v in {**cond, **lat}.items() if k != "caption"})
    noise = torch.from_numpy(np.random.default_rng(99).standard_normal(TINY_LAT, np.float32))
    with torch.no_grad():
        return tts.hunyuan_loss(trainer.model, trainer.step_cfg, batch,
                                sigmas=torch.tensor([0.5]), noise=noise)[0].item()


def test_trainer_lora_trains_three_steps(cache, tmp_path):
    """``SFTTrainer`` with ``model_name="hunyuan_video"``, ``lora``: 3
    optimizer steps from the tiny cache; finite losses and grad norms, the
    loss at fixed draws lower after the steps than before, only the
    adapters train and the frozen trunk does not move."""
    model = _tiny_model()
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer = SFTTrainer(_args(cache, tmp_path, train_steps=3), model)
    assert isinstance(trainer.step_cfg, tts.HunyuanTrainStepConfig)
    assert trainer.step_cfg.remat == "full" and trainer.step_cfg.flow_weighting_scheme == SCHEME
    assert len(trainer.lora) == 4 * 2 + 3 * 2 + 4 * 1
    before = _fixed_loss(trainer, _item(0, valid=5))
    trainer.run()
    after = _fixed_loss(trainer, _item(0, valid=5))
    assert trainer.optimizer.count == 3 and len(trainer.history) == 3
    assert all(np.isfinite(r["loss"]) and r["grad_norm"] > 0 for r in trainer.history)
    assert after < before, (before, after)
    assert all(n.endswith((".lora_A", ".lora_B")) for n in trainer.trainable_names)
    for name, p in model.named_parameters():
        if name in start:
            assert torch.equal(p, start[name]), name


def test_trainer_resume_equals_an_uninterrupted_run(cache, tmp_path):
    """2 steps with a checkpoint, then a resumed run to 4, against an
    uninterrupted 4-step run: the adapters, the optimizer count and the data
    position agree to the bit."""
    part = SFTTrainer(_args(cache, tmp_path / "part", train_steps=2, checkpointing_steps=2),
                      _tiny_model())
    part.run()
    whole = SFTTrainer(_args(cache, tmp_path / "whole", train_steps=4), _tiny_model())
    whole.run()
    resumed = SFTTrainer(_args(cache, tmp_path / "part", train_steps=4, checkpointing_steps=2,
                               resume_from_checkpoint="latest"), _tiny_model())
    resumed.run()
    assert resumed.optimizer.count == whole.optimizer.count == 4
    assert resumed.data_position == whole.data_position == 4
    for (name, p), q in zip(whole.model.named_parameters(), resumed.model.parameters()):
        assert torch.equal(p, q), name
    assert [r["loss"] for r in resumed.history] == [r["loss"] for r in whole.history[2:]]


def test_cli_trains_hunyuan_lora(cache, tmp_path):
    """``python -m vap_tpu_torch.train --model_name hunyuan_video
    --training_type lora --device cpu --model_config tiny`` with the
    recipe's flags parses and runs 2 steps."""
    trainer = train_cli.main([
        "--model_name", "hunyuan_video", "--training_type", "lora", "--device", "cpu",
        "--model_config", "tiny", "--precomputation_dir", cache, "--output_dir", str(tmp_path),
        "--rank", "4", "--lora_alpha", "4", "--target_modules", RECIPE_TARGETS,
        "--flow_weighting_scheme", SCHEME, "--lr", "3e-5", "--lr_scheduler", "constant",
        "--beta1", "0.9", "--beta2", "0.99", "--weight_decay", "1e-4",
        "--train_steps", "2", "--checkpointing_steps", "100", "--logging_steps", "1"])
    assert isinstance(trainer.model, HunyuanVideoTransformer3DModel)
    assert trainer.optimizer.count == 2 and trainer.lora_mode
    assert all(np.isfinite(r["loss"]) for r in trainer.history)


# ---------------------------------------------------------------------------
# the VAE encoder
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vae():
    cfg, jcfg = tvae.HunyuanVideoVAEConfig.tiny(), jvae.HunyuanVideoVAEConfig.tiny()
    params = _jitter(jax.jit(jvae.init_hunyuan_vae, static_argnums=1)(jax.random.PRNGKey(0), jcfg),
                     4, scale=0.05)
    model = tvae.AutoencoderKLHunyuanVideo(cfg).eval()
    model.load_state_dict(convert.from_jax_hunyuan_vae(params, cfg))
    return model, params, jcfg


def _close(got, want, atol):
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, want, atol=atol * scale, rtol=0)


def _video(seed, frames=9, h=12, w=10):
    return np.random.default_rng(seed).uniform(-1, 1, (frames, h, w, 3)).astype(np.float32)


def test_vae_encode_matches_jax(vae):
    """9 frames of 12x10 through the tiny encoder (its one downsample
    strides (2, 2, 2); the mid attention is frame-causal) and quant_conv:
    the moments [1, 5, 6, 5, 8]."""
    model, params, jcfg = vae
    x = _video(1)[None]
    want = np.asarray(jvae.hunyuan_vae_encode(_jnp(params), jcfg, jnp.asarray(x)))
    got = tvae.hunyuan_vae_encode(model, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 5, 6, 5, 8)
    _close(got, want, VAE_ATOL)


def test_prepare_latents_matches_spec(vae):
    """``prepare_latents`` against ``HunyuanVideoSpec.prepare_latents`` in
    float32: the scaled mean, channel-first [1, C, f, h, w]; given latents
    pass through."""
    model, params, jcfg = vae
    spec = HunyuanVideoSpec(None, jcfg, None, {"vae": _jnp(params)}, dtype=jnp.float32)
    sample = {"video": _video(2)}
    want = spec.prepare_latents(sample)["latents"]
    got = tvae.prepare_latents(model, sample, dtype=torch.float32)["latents"]
    assert got.shape == want.shape == (1, 4, 5, 6, 5) and got.dtype == np.float32
    _close(got, want, VAE_ATOL)
    assert np.array_equal(tvae.prepare_latents(model, {"latents": want})["latents"], want)


def test_vae_encode_strided_chunks_change_nothing(vae, monkeypatch):
    """Convs over chunks of one output frame (the strided downsample's
    chunks start at stride x their first output frame) and group norms over
    one group at a time: the same moments as one chunk, at a frame count
    the stride does not divide."""
    model, _, _ = vae
    x = torch.from_numpy(_video(3, frames=8)[None])
    whole = tvae.hunyuan_vae_encode(model, x)
    monkeypatch.setattr(tvae, "CHUNK_ELEMS", 1)
    monkeypatch.setattr(tvae, "GN_CHUNK_ELEMS", 1)
    torch.testing.assert_close(tvae.hunyuan_vae_encode(model, x), whole, atol=1e-6, rtol=0)


@pytest.mark.parametrize("stride", [(2, 2, 2), (1, 2, 2), (2, 1, 1)])
def test_strided_causal_conv_matches_padded_conv(stride, monkeypatch):
    """The chunked strided causal conv against one ``F.conv3d`` over the
    whole replicate-padded input, with chunks of 1 and 2 output frames."""
    conv = torch.nn.Conv3d(3, 5, 3)
    x = torch.randn((1, 3, 7, 9, 8), generator=torch.Generator().manual_seed(0))
    pad = torch.cat([x[:, :, :1].expand(-1, -1, 2, -1, -1), x], dim=2)
    pad = torch.nn.functional.pad(pad.flatten(1, 2), (1, 1, 1, 1), mode="replicate")
    want = torch.nn.functional.conv3d(pad.unflatten(1, (3, -1)), conv.weight, conv.bias,
                                      stride=stride)
    for chunk in (10 ** 9, 3 * 11 * 10 * 3, 3 * 11 * 10 * 5):
        monkeypatch.setattr(tvae, "CHUNK_ELEMS", chunk)
        with torch.no_grad():
            got = tvae.causal_conv3d(conv, x, stride)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
