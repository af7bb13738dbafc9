"""Every branch of the port's CogVideoX loss against the JAX package's
``cogvideox_vap_loss``, and the trainer in each training mode from clips.

The branches: the plain loss (I2V with first-frame image latents, trained
by LoRA adapters as the crush_smol recipe trains them, and T2V, trained
whole), ``reference_independent`` with and without ``random_refer_noise``
(the MoT expert trains), the single-branch ablation over [target ‖ two
references] and with ``baseline_single_condition`` over the target alone
(the plain trunk, trained whole, as JAX's ``_build_cogvideox`` builds it
for the ablation), and CogVideoX 1.5 (``patch_size_t = 2``, the slice RoPE
grid). Tiny transformers with weights from ``init_cogvideox_mot`` jittered
by a numpy seed, carried over by ``convert``; float32 on both sides; the
draws are JAX's, from ``jax.random.split(key, 4)``: timesteps, noise,
reference timesteps, reference noise. JAX runs under the ``xla``
attention provider, the port under ``flash`` (the plain versions of K1 and
K5 on CPU tensors).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_ckpt_util import jitter
from torch_data_util import WAN_CFG, FakeTokenizer, vap_data_dir, write_clip, write_csv
from vap_tpu.models.cogvideox import CogVideoXMOTConfig as JaxConfig
from vap_tpu.models.cogvideox import init_cogvideox_mot
from vap_tpu.ops.attention import attention_provider
from vap_tpu.training import lora as jlora
from vap_tpu.training import train_step as jts
from vap_tpu_torch import convert
from vap_tpu_torch import train as train_cli
from vap_tpu_torch.models.cogvideox.config import CogVideoXMOTConfig
from vap_tpu_torch.models.cogvideox.transformer_mot import CogVideoXTransformer3DMOTModel
from vap_tpu_torch.training import lora as tlora
from vap_tpu_torch.training import optimizer as topt
from vap_tpu_torch.training import train_step as tts
from vap_tpu_torch.training.args import TrainingArgs
from vap_tpu_torch.training.trainer import SFTTrainer

# f32 on both sides through the blocks; the loss weight 1/(1 - a_t) reaches
# ~1e3 at small t, so losses and gradients are held relative to their size
LOSS_RTOL = 2e-5  # |loss_port - loss_jax| / |loss_jax|
GRAD_RTOL = 1e-4  # max|g_port - g_jax| / max|g_jax| per tensor
RANK, ALPHA = 4, 8.0
PLAIN = dict(in_channels=8, out_channels=4, num_layers=1, block_idx_with_mot_ref=())
MOT = dict(in_channels=8, out_channels=4, num_layers=1, block_idx_with_mot_ref=(0,))
# name: (transformer config, TrainStepConfig fields, latent frames, refs
# (None: no reference in the batch), image latents, what trains)
CASES = {
    "plain_i2v": (PLAIN, {}, 3, None, True, "lora"),
    "plain_t2v": (dict(PLAIN, in_channels=4), {}, 3, None, False, "all"),
    "reference_independent": (
        dict(MOT, reference_train_mode="reference_independent"),
        dict(reference_train_mode="reference_independent", num_ref_diffusion_time_sigmas=10,
             sample_ref_videos_num=2), 3, 2, True, "mot"),
    "random_refer_noise": (
        dict(MOT, reference_train_mode="reference_independent"),
        dict(reference_train_mode="reference_independent", random_refer_noise=True,
             num_ref_diffusion_time_sigmas=400), 3, 2, True, "mot"),
    "ablation_single_branch": (PLAIN, dict(ablation_single_branch=True), 3, 2, True, "all"),
    "baseline_single_condition": (
        PLAIN, dict(ablation_single_branch=True, baseline_single_condition=True), 3, 1, True,
        "all"),
    "cogvideox15": (dict(MOT, patch_size_t=2), {}, 4, 1, True, "mot"),
}


def _batch(cfg, frames, refs, image, seed, b=2):
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.standard_normal(shape, np.float32)

    lat = (b, frames, cfg.out_channels, 8, 8)
    text = (b, cfg.max_text_seq_length, cfg.text_embed_dim)
    batch = {"latents": n(*lat), "encoder_hidden_states": n(*text)}
    if image:
        batch["image_latents"] = n(*lat)
    if refs:
        ref = (b, refs * frames) + lat[2:]
        batch.update(latents_mot_ref=n(*ref), image_latents_mot_ref=n(*ref),
                     encoder_hidden_states_mot_ref=n(b, refs * text[1], text[2]))
    return batch


def _jax_draws(key, batch, step_kw):
    """JAX's draws of ``cogvideox_vap_loss`` from ``key``."""
    k_t, k_n, k_rt, k_rn = jax.random.split(key, 4)
    lat = batch["latents"].shape
    draws = {"timesteps": jax.random.randint(k_t, lat[:1], 0, 1000),
             "noise": jax.random.normal(k_n, lat, jnp.float32)}
    if step_kw.get("reference_train_mode"):
        ref = batch["latents_mot_ref"].shape
        draws["ref_timesteps"] = jax.random.randint(
            k_rt, (lat[0], ref[1] // lat[1]), 0, step_kw["num_ref_diffusion_time_sigmas"])
        draws["ref_noise"] = jax.random.normal(k_rn, ref, jnp.float32)
    return {k: torch.from_numpy(np.array(v)).to(torch.int64 if "timesteps" in k else
                                                 torch.float32) for k, v in draws.items()}


def _jax_loss_and_grads(jcfg, step_kw, params, lora, batch, key, train):
    """JAX's loss and the gradients of what trains (the MoT partition, the
    whole tree, or the adapters), as numpy trees."""
    step_cfg = jts.TrainStepConfig(model=jcfg, remat=False, **step_kw)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    if train == "mot":
        train_p, frozen = jts.partition_params(params, jts.trainable_mask(params))

        def f(t):
            return jts.cogvideox_vap_loss(jts.merge_params(t, frozen), step_cfg, jbatch, key)

        arg = train_p
    elif train == "lora":
        def f(lp):
            merged = jlora.apply_lora(params, lp, alpha=ALPHA, rank=RANK)
            return jts.cogvideox_vap_loss(merged, step_cfg, jbatch, key)

        arg = lora
    else:
        def f(p):
            return jts.cogvideox_vap_loss(p, step_cfg, jbatch, key)

        arg = params
    with attention_provider("xla"):  # read while tracing
        (loss, metrics), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(arg)
    return ({k: float(v) for k, v in metrics.items()},
            jax.tree.map(lambda x: None if x is None else np.asarray(x), grads))


def _as_state_dict(cfg, params, tree):
    full = jax.tree.map(lambda p, g: np.zeros_like(p) if g is None else np.asarray(g),
                        params, tree, is_leaf=lambda x: x is None)
    return convert.from_jax_transformer(full, cfg)


def _close(got, want, name):
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= GRAD_RTOL * scale, (name, err, scale)


@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_grads_match_jax(name):
    """The loss (and its parts) and the gradients of every trained tensor,
    at 2e-5 and 1e-4 of their size."""
    kw, step_kw, frames, refs, image, train = CASES[name]
    jcfg, cfg = JaxConfig.tiny(**kw), CogVideoXMOTConfig.tiny(**kw)
    params = jitter(init_cogvideox_mot(jax.random.PRNGKey(0), jcfg), 0)
    batch = _batch(cfg, frames, refs, image, seed=len(name))
    key = jax.random.PRNGKey(len(name))
    lora = None
    if train == "lora":  # JAX's adapters of the recipe's targets, B non-zero
        lora = jlora.init_lora(jax.random.PRNGKey(1), params, rank=RANK,
                               targets=jts.parse_target_modules("to_q to_k to_v to_out"),
                               mot_only=False)
        rng = np.random.default_rng(2)
        lora = jax.tree.map(lambda x: np.asarray(x) + (0.1 * rng.standard_normal(
            x.shape).astype(np.float32) if x.shape[-2] == RANK else 0), lora)
    want, jgrads = _jax_loss_and_grads(jcfg, step_kw, params, lora, batch, key, train)

    model = CogVideoXTransformer3DMOTModel(cfg)
    model.load_state_dict(convert.from_jax_transformer(params, cfg))
    if train == "mot":
        tts.trainable_mask(model)
    elif train == "lora":
        model.requires_grad_(False)
        tree = tlora.apply_lora(model, convert.from_jax_lora(lora, cfg), alpha=ALPHA, rank=RANK)
    step_cfg = tts.TrainStepConfig(model=cfg, remat=False, **step_kw)
    loss, metrics = tts.cogvideox_vap_loss(model, step_cfg,
                                           {k: torch.from_numpy(v) for k, v in batch.items()},
                                           **_jax_draws(key, batch, step_kw))
    loss.backward()
    assert set(metrics) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(metrics[k].item(), v, rtol=LOSS_RTOL, err_msg=k)
    if train == "lora":
        ref = convert.from_jax_lora(jgrads, cfg)
        assert tree.keys() == ref.keys()
        for n, ab in tree.items():
            for k in ("A", "B"):
                _close(ab[k].grad.numpy(), ref[n][k].numpy(), f"{n}.{k}")
        return
    ref = _as_state_dict(cfg, params, jgrads)
    trained = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    assert trained and (train != "all" or len(trained) == len(ref))
    live = 0
    for n, p in trained:
        got = np.zeros_like(ref[n].numpy()) if p.grad is None else p.grad.numpy()
        _close(got, ref[n].numpy(), n)
        live += bool(np.abs(ref[n].numpy()).max() > 0)
    assert live


def test_reference_noise_reaches_the_reference_time_embedding_only_under_random_refer_noise():
    """Under reference_independent the reference stream is noised either
    way; only random_refer_noise hands its timesteps to the reference
    branch's time embedding, whose gradient is zero without it."""
    kw, step_kw, frames, refs, image, _ = CASES["reference_independent"]
    cfg = CogVideoXMOTConfig.tiny(**kw)
    params = jitter(init_cogvideox_mot(jax.random.PRNGKey(0), JaxConfig.tiny(**kw)), 0)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, frames, refs, image, 3).items()}
    draws = _jax_draws(jax.random.PRNGKey(3), _batch(cfg, frames, refs, image, 3), step_kw)
    losses = []
    for random in (False, True):
        model = CogVideoXTransformer3DMOTModel(cfg)
        model.load_state_dict(convert.from_jax_transformer(params, cfg))
        loss, metrics = tts.cogvideox_vap_loss(
            model, tts.TrainStepConfig(model=cfg, remat=False, random_refer_noise=random,
                                       **step_kw), batch, **draws)
        losses.append((metrics["loss_main"].item(), metrics["loss_ref"].item()))
    assert losses[0] != losses[1]
    with pytest.raises(ValueError, match="reference head"):
        plain_cfg = CogVideoXMOTConfig.tiny(**MOT)
        tts.cogvideox_vap_loss(CogVideoXTransformer3DMOTModel(plain_cfg),
                               tts.TrainStepConfig(model=plain_cfg, remat=False, **step_kw),
                               batch, **draws)


def test_draw_step_noise_follows_the_loss():
    """The trainer's draws are the loss's own from the same generator,
    reference timesteps and noise included."""
    kw, step_kw, frames, refs, image, _ = CASES["reference_independent"]
    cfg = CogVideoXMOTConfig.tiny(**kw)
    model = CogVideoXTransformer3DMOTModel(cfg)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, frames, refs, image, 4).items()}
    step_cfg = tts.TrainStepConfig(model=cfg, remat=False, **step_kw)
    own, _ = tts.cogvideox_vap_loss(model, step_cfg, batch, torch.Generator().manual_seed(7))
    draws = tts.draw_step_noise(step_cfg, batch["latents"].shape,
                                torch.Generator().manual_seed(7),
                                ref_shape=batch["latents_mot_ref"].shape)
    assert set(draws) == {"timesteps", "noise", "ref_timesteps", "ref_noise"}
    assert int(draws["ref_timesteps"].max()) < 10
    given, _ = tts.cogvideox_vap_loss(model, step_cfg, batch, **draws)
    assert torch.equal(own, given)


def test_a_loss_nothing_trains_reaches_raises_unless_allowed():
    """The plain loss never reaches the MoT partition: a step that trains
    only that partition raises, unless ``unreached_ok`` (``training_type
    sft``), where the gradients stay unset and the update is weight decay
    alone, as in JAX."""
    cfg = CogVideoXMOTConfig.tiny(**MOT)
    model = CogVideoXTransformer3DMOTModel(cfg)
    names = tts.trainable_mask(model)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 3, None, True, 5).items()}
    step_cfg = tts.TrainStepConfig(model=cfg, remat=False)
    params = [p for p in model.parameters() if p.requires_grad]
    opt = topt.get_optimizer("adamw", params, topt.get_lr_schedule("constant", 1e-3))
    grad_fn, _ = tts.make_grad_and_apply(tts.cogvideox_vap_loss, step_cfg, opt)
    with pytest.raises(ValueError, match="nothing that trains reaches the loss"):
        grad_fn(model, batch, torch.Generator().manual_seed(0))
    grad_fn, _ = tts.make_grad_and_apply(tts.cogvideox_vap_loss, step_cfg, opt,
                                         unreached_ok=True)
    metrics = grad_fn(model, batch, torch.Generator().manual_seed(0))
    assert names and np.isfinite(metrics["loss"].item())
    assert all(p.grad is None for p in params)


# ---------------------------------------------------------------------------
# the trainer in each mode, from clips (tiny CogVideoX and Wan on the CPU)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """A VAP directory (scores 9 and, for DPO, a second kind with scores
    100 / 95 / 5) and a plain directory of clips with captions."""
    root = vap_data_dir(str(tmp_path_factory.mktemp("vap")), n=4)
    rows = [{"video_paths": f"v{i}.mp4", "tar_video_caption": f"clip {i}",
             "ref_video_paths": json.dumps([f"v{(i + 1) % 3}.mp4"]), "kind": "fx",
             "split": "train", "reference_alignment_score": s}
            for i, s in enumerate((100, 95, 5))]
    write_csv(os.path.join(root, "dpo.csv"), rows)
    plain = tmp_path_factory.mktemp("plain")
    for i in range(2):
        write_clip(plain / f"c{i}.mp4", 20 + i)
        (plain / f"c{i}.txt").write_text(f"a vase dissolving, take {i}")
    return root, str(plain)


MODES = {
    "wan_dpo": dict(model_name="wan", training_type="video_as_prompt_mot", dpo=True,
                    meta_df_name="dpo.csv", rank=RANK, lora_alpha=8),
    "cogvideox_sft": dict(training_type="sft", data="plain"),
    "cogvideox_plain_lora": dict(training_type="lora", data="plain", rank=RANK, lora_alpha=8,
                                 target_modules="to_q to_k to_v to_out", structure=PLAIN),
    "ablation_full": dict(ablation_single_branch=True, target_modules="none"),
    "ablation_lora": dict(ablation_single_branch=True, rank=RANK, lora_alpha=8,
                          target_modules="(transformer_blocks).*(to_q|to_k|to_v|to_out.0)"),
    "baseline_single_condition": dict(ablation_single_branch=True, target_modules="none",
                                      baseline_single_condition="fx"),
    "reference_independent": dict(reference_train_mode="reference_independent",
                                  random_refer_noise=True),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_trainer_runs_each_mode_from_clips(clips, tmp_path, mode):
    """Two steps of each mode from clips on disk: finite losses, what
    trains is what JAX's ``_build_step`` trains, and only that moves."""
    kw = dict(MODES[mode])
    data = clips[1] if kw.pop("data", None) == "plain" else clips[0]
    structure = kw.pop("structure", None)
    if structure:
        path = tmp_path / "structure.json"
        path.write_text(json.dumps({"transformer": {"block_idx_with_mot_ref": []}}))
        kw["model_structure_config"] = str(path)
    args = TrainingArgs(data_root=data, output_dir=str(tmp_path / "out"),
                        video_resolution_buckets=((9, 32, 32),), lr=1e-3, lr_scheduler="constant",
                        lr_warmup_steps=0, gradient_checkpointing=False, checkpointing_steps=1000,
                        seed=5,
                        train_steps=2, mask_caption_ratio=0.0, **kw)
    if args.model_name == "wan":  # 4 latent + 8 conditioning channels: the spec's I2V
        from vap_tpu_torch.models.random_init import build_random
        from vap_tpu_torch.models.wan.config import WanMOTConfig
        from vap_tpu_torch.models.wan.transformer_mot import WanTransformer3DMOTModel

        model = build_random(WanTransformer3DMOTModel, WanMOTConfig.tiny(**WAN_CFG), "cpu",
                             torch.float32, torch.Generator().manual_seed(0))
    else:
        model = train_cli.build_transformer(args, "tiny", torch.device("cpu"))
    spec = train_cli.build_spec(args, model, "tiny", {"tokenizer": FakeTokenizer()})
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer = SFTTrainer(args, model, spec)
    trainer.run()
    assert trainer.optimizer.count == 2 and all(np.isfinite(r["loss"]) for r in trainer.history)
    names = trainer.trainable_names
    lora = args.is_dpo or args.training_type == "lora" or (
        args.ablation_single_branch and args.target_modules != "none")
    assert trainer.lora_mode == lora and names
    if lora:
        assert all("lora_" in n for n in names)
        assert all("_mot_ref" in n for n in names) == args.is_dpo
    elif args.ablation_single_branch:
        assert not model.config.block_idx_with_mot_ref
        assert len(names) == len(start)  # the whole model trains
    else:
        assert all(any(m in n for m in tts.TRAINABLE_MARKERS) for n in names)
    params = dict(model.named_parameters())
    for n, p in start.items():
        if n not in names:
            assert torch.equal(params[n], p), n
    if args.training_type != "sft":  # sft trains the MoT partition, which plain data never reaches
        assert any(not torch.equal(params[n], start[n]) for n in names if n in start) or lora
