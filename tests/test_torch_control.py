"""The port's control trainer (Wan) and CogVideoX's control loss against the
JAX package's (``vap_tpu/training/control.py``, ``control_trainer.py``,
``control_specs.py``, ``data/generic.py`` ``ControlDatasetWrapper``).

A tiny Wan T2V base (16 latent channels, as Wan's VAE makes them: JAX's
control sampling draws 16-channel noise) widened to 33 input channels by
``expand_patch_embedding`` and jittered by a seeded normal (so the control
rows are not zero), carried into the port by ``convert``; float32 on both
sides. The frame draws, sigmas and noise are JAX's, passed in; so are the
LoRA adapters (``convert.from_jax_lora``).
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_data_util import FakeTokenizer, write_clip
from vap_tpu.data import generic as jgeneric
from vap_tpu.models.wan import transformer_mot as jwan
from vap_tpu.models.wan.config import WanMOTConfig as JaxWanConfig
from vap_tpu.training import control as jcontrol
from vap_tpu.training import control_trainer as jct
from vap_tpu.training import lora as jlora
from vap_tpu.training import optimizer as jopt
from vap_tpu.training import train_step as jts
from vap_tpu_torch import convert
from vap_tpu_torch import train as train_cli
from vap_tpu_torch.data import generic as tgeneric
from vap_tpu_torch.models.wan.config import WanMOTConfig
from vap_tpu_torch.models.wan.transformer_mot import (WanTransformer3DMOTModel,
                                                      expand_patch_embedding)
from vap_tpu_torch.training import control as tcontrol
from vap_tpu_torch.training import control_trainer as tct
from vap_tpu_torch.training.args import TrainingArgs

T2V = dict(in_channels=16, out_channels=16, text_dim=32, block_idx_with_mot_ref=(),
           image_dim=None, added_kv_proj_dim=None)
WIDE = 33  # 16 noisy + 16 control + the mask channel
RANK, ALPHA = 4, 8.0
LR = 1e-3
SCHEME = "logit_normal"
# float32 on both sides; only the summation order differs
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
VIDEO_ATOL = 1e-4
LAT = (1, 3, 4, 4, 16)  # a 9x32x32 clip's latents


def jitter(tree, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.asarray(x, np.float32)
                        + scale * rng.standard_normal(np.shape(x)).astype(np.float32), tree)


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg0 = JaxWanConfig.tiny(**T2V)
    params = jwan.expand_patch_embedding(jwan.init_wan(jax.random.PRNGKey(0), jcfg0), jcfg0,
                                         WIDE - 16)
    return (dataclasses.replace(jcfg0, in_channels=WIDE),
            WanMOTConfig.tiny(**{**T2V, "in_channels": WIDE}), jitter(params, 1))


def _model():
    _, cfg, params = _setup()
    model = WanTransformer3DMOTModel(cfg)
    model.load_state_dict(convert.from_jax_wan_transformer(params, cfg))
    return model


def _jax_draws(key, shape, fc_type="index", fc_index=0):
    """The sigmas, noise and kept frames ``wan_control_loss`` draws from ``key``."""
    k_t, k_n, k_fc = jax.random.split(key, 3)
    sigmas = jts.sample_flow_sigmas(k_t, shape[0], scheme=SCHEME)
    noise = jax.random.normal(k_n, shape, jnp.float32)
    mask = jct.apply_frame_conditioning_on_latents(
        jnp.ones(shape), k_fc, fc_type, fc_index, concatenate_mask=True)[..., -1]
    return {"sigmas": torch.from_numpy(np.array(sigmas)),
            "noise": torch.from_numpy(np.array(noise)),
            "keep": torch.from_numpy(np.array(mask[:, :, 0, 0]) > 0)}


def _close(got, want, rtol, what):
    scale = max(float(np.max(np.abs(want))), 1e-12)
    err = float(np.max(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))))
    assert err <= rtol * scale, f"{what}: {err} > {rtol} * {scale}"


def test_expand_patch_embedding_matches_jax():
    jcfg0 = JaxWanConfig.tiny(**T2V)
    base = jitter(jwan.init_wan(jax.random.PRNGKey(0), jcfg0), 2)
    model = WanTransformer3DMOTModel(WanMOTConfig.tiny(**T2V))
    model.load_state_dict(convert.from_jax_wan_transformer(base, WanMOTConfig.tiny(**T2V)))
    expand_patch_embedding(model, WIDE - 16)
    wide = WanMOTConfig.tiny(**{**T2V, "in_channels": WIDE})
    want = convert.from_jax_wan_transformer(jwan.expand_patch_embedding(base, jcfg0, WIDE - 16),
                                            wide)
    assert model.config == wide and tct.control_in_channels(16, True) == WIDE
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


@pytest.mark.parametrize("mode", jct.FRAME_CONDITIONING_TYPES)
def test_frame_conditioning_matches_jax(mode):
    rng = np.random.default_rng(3)
    lat = rng.standard_normal((3, 5, 2, 2, 4)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    for mask in (False, True):
        want = np.asarray(jct.apply_frame_conditioning_on_latents(
            jnp.asarray(lat), key, mode, 2, concatenate_mask=mask))
        keep = None
        if mode in ("prefix", "random"):  # JAX's draws: the mask channel it appends
            jm = jct.apply_frame_conditioning_on_latents(jnp.asarray(lat), key, mode, 2, True)
            keep = torch.from_numpy(np.array(jm[..., -1][:, :, 0, 0]) > 0)
        got = tct.apply_frame_conditioning_on_latents(torch.from_numpy(lat), mode, 2, mask,
                                                      keep=keep)
        np.testing.assert_array_equal(got.numpy(), want)
    # the port's own draws: n in [1, F] frames, a prefix for "prefix"
    keep = tct.frame_keep_mask(64, 5, mode, 2, torch.Generator().manual_seed(0))
    counts = keep.sum(dim=1)
    assert int(counts.min()) >= 1
    if mode == "prefix":
        assert torch.equal(keep, torch.arange(5)[None] < counts[:, None])
    if mode in ("prefix", "random"):
        assert len(set(counts.tolist())) > 1


@functools.lru_cache(maxsize=None)
def _batch(seed=4):
    rng = np.random.default_rng(seed)
    shape = (2,) + LAT[1:]
    return {"latents": rng.standard_normal(shape, np.float32),
            "control_latents": rng.standard_normal(shape, np.float32),
            "encoder_hidden_states": rng.standard_normal((2, 7, 32), np.float32)}


def _step_cfgs():
    jcfg, cfg, _ = _setup()
    kw = dict(frame_conditioning_type="index", frame_conditioning_index=1,
              frame_conditioning_concatenate_mask=True, flow_weighting_scheme=SCHEME,
              remat=False)
    return jct.WanControlTrainStepConfig(model=jcfg, **kw), tct.WanControlTrainStepConfig(
        model=cfg, **kw)


def test_wan_control_loss_and_grads_match_jax():
    jcfg, cfg, params = _setup()
    jstep, tstep = _step_cfgs()
    batch = _batch()
    key = jax.random.PRNGKey(5)
    grad_fn = jax.jit(jax.value_and_grad(jct.wan_control_loss, has_aux=True), static_argnums=1)
    (jloss, _), jgrads = grad_fn(jax.tree.map(jnp.asarray, params), jstep,
                                 jax.tree.map(jnp.asarray, batch), key)
    model = _model()
    loss, _ = tct.wan_control_loss(model, tstep, {k: torch.from_numpy(v) for k, v in
                                                  batch.items()},
                                   **_jax_draws(key, batch["latents"].shape, "index", 1))
    _close(loss.item(), float(jloss), LOSS_RTOL, "loss")
    loss.backward()
    want = convert.from_jax_wan_transformer(jax.tree.map(np.asarray, jgrads), cfg)
    for name, p in model.named_parameters():
        _close(p.grad.numpy(), want[name].numpy(), GRAD_RTOL, name)


@pytest.mark.parametrize("train_qk_norm", [False, True])
def test_direct_mask_matches_jax(train_qk_norm):
    """The injection weight trains directly, its bias does not; the QK
    norms only under the flag; what trains is the adapters and those."""
    _, cfg, params = _setup()
    mask = jct._control_direct_mask(params, jct.CONTROL_INJECTION_PATH["wan"], train_qk_norm)
    marks = convert.from_jax_wan_transformer(
        jax.tree.map(lambda m, p: np.full(np.shape(p), float(m), np.float32), mask, params), cfg)
    want = {k for k, v in marks.items() if bool(v.all())}
    model = _model()
    got = tct.control_direct_names(model, "wan", train_qk_norm)
    assert set(got) == want and "patch_embedding.weight" in want
    assert "patch_embedding.bias" not in want
    assert any("norm_q" in n for n in want) == train_qk_norm
    lora, opt, _, _ = tct.make_control_step(
        tct.wan_control_loss, _step_cfgs()[1], model,
        lambda ps: torch.optim.SGD(ps, lr=0.0), family="wan", lora_rank=RANK,
        lora_alpha=ALPHA, train_qk_norm=train_qk_norm)
    trains = {n for n, p in model.named_parameters() if p.requires_grad}
    assert trains == want | {f"{m}.lora_{x}" for m in lora for x in "AB"}
    assert len(lora) == 10 * cfg.num_layers  # attn1 and attn2: q, k, v, out; ffn: 2


def test_cogview4_and_other_families_refuse():
    with pytest.raises(NotImplementedError, match="cogview4"):
        TrainingArgs(model_name="cogview4", training_type="control")
    with pytest.raises(NotImplementedError, match="CogView4"):
        tct.make_control_step(None, None, _model(), None, family="cogview4")
    with pytest.raises(ValueError, match="control training supports"):
        TrainingArgs(model_name="cogvideox", training_type="control_lora")
    args = TrainingArgs(model_name="wan", training_type="control")
    assert args.training_type == "control_lora" and args.is_control


def test_cogvideox_control_loss_matches_jax():
    from vap_tpu.models.cogvideox import CogVideoXMOTConfig as JaxCogConfig
    from vap_tpu.models.cogvideox import init_cogvideox_mot
    from vap_tpu_torch.models.cogvideox.config import CogVideoXMOTConfig
    from vap_tpu_torch.models.cogvideox.transformer_mot import CogVideoXTransformer3DMOTModel

    kw = dict(in_channels=4, out_channels=4, num_layers=2, block_idx_with_mot_ref=())
    jcfg0, cfg0 = JaxCogConfig.tiny(**kw), CogVideoXMOTConfig.tiny(**kw)
    base = jitter(init_cogvideox_mot(jax.random.PRNGKey(0), jcfg0), 6)
    wide = jcontrol.expand_patch_embed_for_control(base, 4 * 4)
    kernel = np.array(wide["patch_embed"]["proj"]["kernel"])
    kernel[16:] = 0.05 * np.random.default_rng(7).standard_normal((16, kernel.shape[1]))
    wide["patch_embed"]["proj"]["kernel"] = kernel  # the control rows not zero
    jcfg = dataclasses.replace(jcfg0, in_channels=8)
    model = CogVideoXTransformer3DMOTModel(cfg0)
    model.load_state_dict(convert.from_jax_transformer(base, cfg0))
    tcontrol.expand_patch_embed_for_control(model, 4 * 4)
    proj = model.patch_embed.proj
    assert model.config.in_channels == 8 and proj.weight.shape == (32, 8, 2, 2)
    assert not proj.weight[:, 4:].any()
    with torch.no_grad():  # JAX's widened kernel, rows (C, ph, pw)
        proj.weight.copy_(torch.from_numpy(kernel.T.reshape(32, 8, 2, 2)))
    rng = np.random.default_rng(8)
    batch = {"latents": rng.standard_normal((2, 2, 4, 8, 8), np.float32),
             "control_latents": rng.standard_normal((2, 2, 4, 8, 8), np.float32),
             "encoder_hidden_states": rng.standard_normal(
                 (2, cfg0.max_text_seq_length, cfg0.text_embed_dim), np.float32)}
    key = jax.random.PRNGKey(9)
    jloss, _ = jcontrol.control_loss(jax.tree.map(jnp.asarray, wide),
                                     jcontrol.ControlTrainStepConfig(model=jcfg, remat=False),
                                     jax.tree.map(jnp.asarray, batch), key)
    k_t, k_n = jax.random.split(key)
    draws = {"timesteps": torch.from_numpy(np.array(jax.random.randint(k_t, (2,), 0, 1000))),
             "noise": torch.from_numpy(np.array(jax.random.normal(k_n, (2, 2, 4, 8, 8))))}
    loss, _ = tcontrol.control_loss(model, tcontrol.ControlTrainStepConfig(
        model=model.config, remat=False), {k: torch.from_numpy(v) for k, v in batch.items()},
        **draws)
    _close(loss.item(), float(jloss), LOSS_RTOL, "loss")
    # one step of make_control_train_step: the widened input layer alone trains
    jstep = jcontrol.ControlTrainStepConfig(model=jcfg, remat=False)
    init_fn, step_fn = jcontrol.make_control_train_step(
        jstep, jopt.get_optimizer("adamw", jopt.get_lr_schedule("constant", LR, warmup_steps=0)))
    train, frozen, opt_state = init_fn(jax.tree.map(jnp.asarray, wide))
    train, _, metrics = step_fn(train, frozen, opt_state, jax.tree.map(jnp.asarray, batch), key)
    from vap_tpu_torch.training import optimizer as topt

    _, step = tcontrol.make_control_train_step(
        tcontrol.ControlTrainStepConfig(model=model.config, remat=False), model,
        lambda ps: topt.get_optimizer("adamw", ps, topt.get_lr_schedule("constant", LR)))
    assert {n for n, p in model.named_parameters() if p.requires_grad} == {
        "patch_embed.proj.weight", "patch_embed.proj.bias"}
    got = step(model, {k: torch.from_numpy(v) for k, v in batch.items()}, **draws)
    _close(got["loss"].item(), float(metrics["loss"]), LOSS_RTOL, "step loss")
    want = np.asarray(train["patch_embed"]["proj"]["kernel"]).T.reshape(32, 8, 2, 2)
    _close(model.patch_embed.proj.weight.detach().numpy(), want, 1e-6, "widened kernel")
    with pytest.raises(ValueError, match="whole channels"):
        tcontrol.expand_patch_embed_for_control(model, 3)


# ---------------------------------------------------------------------------
# the dataset wrapper, the trainer from clips and validation
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    root = tmp_path_factory.mktemp("control_clips")
    for i in range(2):
        write_clip(root / f"c{i}.mp4", 30 + i)
        (root / f"c{i}.txt").write_text(f"a ship at sea, take {i}")
    return str(root)


@pytest.mark.parametrize("control_type", ["none", "canny", "custom"])
def test_control_dataset_wrapper_matches_jax(clips, monkeypatch, control_type):
    from vap_tpu import native as jnative

    monkeypatch.setattr(jnative, "available", lambda: False)  # both sides decode with cv2
    jds = jgeneric.ControlDatasetWrapper(jgeneric.initialize_dataset(clips, "video"),
                                         control_type)
    tds = tgeneric.ControlDatasetWrapper(tgeneric.initialize_dataset(clips, "video"),
                                         control_type)
    if control_type == "custom":
        for ds in (jds, tds):
            with pytest.raises(ValueError, match="custom requires"):
                next(iter(ds))
        return
    want, got = next(iter(jds)), next(iter(tds))
    np.testing.assert_array_equal(got["control_video"], want["control_video"])
    assert got["caption"] == want["caption"]
    tds.load_state_dict(jds.state_dict())
    assert tds.state_dict() == jds.state_dict()


def _args(out, clips, training_type, **kw):
    return TrainingArgs(
        model_name="wan", training_type=training_type, data_root=clips, output_dir=str(out),
        video_resolution_buckets=((9, 32, 32),), control_type="none",
        frame_conditioning_type="index", frame_conditioning_index=0,
        frame_conditioning_concatenate_mask=True, rank=RANK, lora_alpha=int(ALPHA),
        train_qk_norm=True, lr=LR, lr_scheduler="constant", lr_warmup_steps=0,
        gradient_checkpointing=False, checkpointing_steps=1, seed=5,
        flow_weighting_scheme=SCHEME, mask_caption_ratio=0.0, **kw)


KEYS = [jax.random.PRNGKey(100 + k) for k in range(2)]


def _trainer(args, record):
    """The port's control trainer on the tiny model, JAX's adapters and
    draws; ``record`` gets each micro-batch."""
    model = _model()
    spec = train_cli.build_spec(args, model, "tiny", {"tokenizer": FakeTokenizer()})
    trainer = tct.ControlTrainer(args, model, spec)
    if trainer.lora is not None:
        _, _, params = _setup()
        want = convert.from_jax_lora(jlora.init_lora(
            jax.random.PRNGKey(args.seed), params, rank=RANK, targets=tct.CONTROL_LORA_TARGETS,
            mot_only=False), model.config)
        assert want.keys() == trainer.lora.keys()
        with torch.no_grad():
            for name, ab in trainer.lora.items():
                ab["A"].copy_(want[name]["A"])
                ab["B"].copy_(want[name]["B"])
    trainer._draws = lambda batch, step: _jax_draws(KEYS[step - 1], batch["latents"].shape)
    grad = trainer._grad

    def recording(model, batch, *a, **kw):
        record.append({k: v.detach().numpy().copy() for k, v in batch.items()})
        return grad(model, batch, *a, **kw)
    trainer._grad = recording
    return trainer


@pytest.mark.parametrize("training_type,optimizer", [
    ("control_lora", "adamw"), ("control_full_finetune", "adamw"),
    ("control_full_finetune", "adafactor"), ("control_full_finetune", "adamw-8bit")])
def test_control_trainer_matches_jax_and_resumes(clips, tmp_path, training_type, optimizer):
    """Two steps from clips: the losses are JAX's ``make_control_step`` on
    the same batches with the same draws (under Adafactor and the 8-bit
    AdamW the update reads JAX's stacked blocks as one leaf each:
    ``jax_layout``); a run resumed
    at step 1 takes step 2 as the uninterrupted run does; the export writes
    its files."""
    record = []
    trainer = _trainer(_args(tmp_path / "a", clips, training_type, train_steps=2,
                             optimizer=optimizer), record)
    trainer.run()
    losses = [r["loss"] for r in trainer.history]
    # JAX: the same start, batches, adapters and draws
    jcfg, _, params = _setup()
    jstep = jct.WanControlTrainStepConfig(
        model=jcfg, frame_conditioning_type="index", frame_conditioning_index=0,
        frame_conditioning_concatenate_mask=True, flow_weighting_scheme=SCHEME, remat=False)
    tx = jopt.get_optimizer(optimizer, jopt.get_lr_schedule("constant", LR, warmup_steps=0))
    init_fn, _, _, step_fn = jct.make_control_step(
        jct.wan_control_loss, jstep, tx, family="wan",
        full_finetune=training_type == "control_full_finetune", lora_rank=RANK,
        lora_alpha=ALPHA, train_qk_norm=True)
    train, frozen, opt_state = init_fn(jax.tree.map(jnp.asarray, params), jax.random.PRNGKey(5))
    step_fn = jax.jit(step_fn)
    for k, batch in enumerate(record):
        train, opt_state, metrics = step_fn(train, frozen, opt_state,
                                            jax.tree.map(jnp.asarray, batch), KEYS[k])
        _close(losses[k], float(metrics["loss"]), LOSS_RTOL, f"step {k + 1} loss")
    assert losses[0] != losses[1]
    # resume at step 1 (each step is checkpointed) to step 2
    resumed = _trainer(_args(tmp_path / "a", clips, training_type, train_steps=2,
                             optimizer=optimizer, resume_from_checkpoint="1"), [])
    resumed.run()
    assert [r["loss"] for r in resumed.history] == losses[1:]
    path = trainer.export()
    files = set(os.listdir(os.path.dirname(path)))
    if training_type == "control_lora":
        assert files == {"pytorch_lora_weights.safetensors", "control_injection_layers.safetensors"}
    else:
        assert files == {"model.safetensors"}


def test_control_validation_matches_jax(clips, monkeypatch):
    """The control sample against JAX's ``WanControlSpec.validation`` with
    JAX's starting noise: two steps, CFG 5.0, index 0 with the mask."""
    from vap_tpu import native as jnative
    from vap_tpu.models.text_encoders import t5 as jt5
    from vap_tpu.models.wan import vae as jvae
    from vap_tpu.training import control_specs as jspecs

    monkeypatch.setattr(jnative, "available", lambda: False)
    jcfg, cfg, params = _setup()
    args = _args("unused", clips, "control_lora", train_steps=1)
    model = _model()
    spec = train_cli.build_spec(args, model, "tiny", {"tokenizer": FakeTokenizer()})
    # JAX's tiny encoders, carried into the port's spec
    vae_cfg = jvae.WanVAEConfig.tiny(z_dim=16, latents_mean=(0.0,) * 16,
                                     latents_std=(1.0,) * 16)
    txt_cfg = jt5.T5Config.tiny(d_model=32, per_layer_relative_bias=True)
    key = jax.random.PRNGKey(0)
    jparams = {"transformer": jax.tree.map(jnp.asarray, params),
               "vae": jax.tree.map(jnp.asarray, jitter(
                   jax.jit(jvae.init_wan_vae, static_argnums=1)(key, vae_cfg), 7)),
               "text_encoder": jax.tree.map(jnp.asarray, jitter(
                   jt5.init_t5_encoder(key, txt_cfg), 8))}
    spec.vae.load_state_dict(convert.from_jax_wan_vae(jparams["vae"], spec.vae.config))
    spec.text_encoder.load_state_dict(convert.from_jax_t5(jparams["text_encoder"],
                                                          spec.text_encoder.config))
    jspec = jspecs.WanControlSpec(jcfg, vae_cfg, txt_cfg, jparams, FakeTokenizer(),
                                  dtype=jnp.float32)
    control = tgeneric._load_video_norm(os.path.join(clips, "c0.mp4"))[:5, :16, :16]
    sample = {"caption": "a ship", "control_video": control}
    kw = dict(num_inference_steps=2, seed=3, frame_conditioning_type="index",
              concatenate_mask=True)
    want = jspec.validation(jparams["transformer"], sample, **kw)
    noise = jax.random.normal(jax.random.PRNGKey(3), (1, 2, 2, 2, 16), jnp.float32)
    got = spec.validation(sample, noise=torch.from_numpy(np.array(noise)), **kw)
    assert got.shape == want.shape == control.shape
    np.testing.assert_allclose(got, want, atol=VIDEO_ATOL)



def test_cli_widens_a_stock_t2v_checkpoint(clips, tmp_path):
    """``python -m vap_tpu_torch.train --training_type control`` on a stock
    tiny T2V checkpoint: the transformer widened to 33 channels, its first
    16 the checkpoint's and the rest zero (the warmup's first update is at
    lr 0), trained one step from clips and exported."""
    from torch_ckpt_util import write_component
    from vap_tpu_torch.models.random_init import build_random

    base = build_random(WanTransformer3DMOTModel, train_cli.CONTROL_CONFIGS["tiny"](), "cpu",
                        torch.float32, torch.Generator().manual_seed(3))
    write_component(tmp_path / "ckpt", "transformer", base.state_dict(), base.config,
                    "WanTransformer3DModel")
    trainer = train_cli.main([
        "--model_name", "wan", "--training_type", "control", "--device", "cpu",
        "--model_config", "tiny", "--pretrained_model_name_or_path", str(tmp_path / "ckpt"),
        "--data_root", clips, "--video_resolution_buckets", "9x32x32", "--control_type", "none",
        "--frame_conditioning_type", "index", "--frame_conditioning_concatenate_mask",
        "--rank", "4", "--lora_alpha", "4", "--train_steps", "1",
        "--output_dir", str(tmp_path / "out")], tokenizers={"tokenizer": FakeTokenizer()})
    assert isinstance(trainer, tct.ControlTrainer) and trainer.lora_mode
    weight = trainer.model.patch_embedding.weight
    assert trainer.model.config.in_channels == WIDE and weight.shape[1] == WIDE
    assert torch.equal(weight[:, :16], base.patch_embedding.weight) and not weight[:, 16:].any()
    out = tmp_path / "out" / "model_weights" / "000001"
    assert sorted(os.listdir(out)) == ["control_injection_layers.safetensors",
                                       "pytorch_lora_weights.safetensors"]
