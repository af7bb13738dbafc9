"""Float8 storage of the frozen base (``--layerwise_upcasting_modules
transformer``) against the JAX package's ``cast_layerwise_storage`` and its
``apply_lora`` path.

The tiny Wan models of ``tests/test_torch_wan_train.py`` (the plain I2V
trunk of the LoRA recipe, and MoT in both blocks), float32 on both sides:
the cast set is JAX's, read through the weight converter; a LoRA step from
float8 storage gives JAX's loss, adapter gradients and grad norm; the
trainer under ``--training_type lora --layerwise_upcasting_modules
transformer`` casts before it installs the adapters and takes JAX's step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_wan_train import (ALPHA, GRAD_RTOL, LOSS_RTOL, MAX_GRAD_NORM, PARAM_ATOL, RANK,
                                  RECIPE_TARGETS, SCHEME, WEIGHT_DECAY, _batch, _jax_draws,
                                  _jax_lora, _jax_lora_fns, _jnp, _model, _setup, _step_cfgs,
                                  _torch_batch, _tx)
from vap_tpu.ops.attention import attention_provider
from vap_tpu.training import layerwise as jlayer
from vap_tpu_torch import convert
from vap_tpu_torch.data.precomputation import write_precomputed
from vap_tpu_torch.training import layerwise as tlayer
from vap_tpu_torch.training import lora as tlora
from vap_tpu_torch.training import train_step as tts
from vap_tpu_torch.training.args import TrainingArgs
from vap_tpu_torch.training.trainer import SFTTrainer

PATTERNS = {
    "default": tlayer.DEFAULT_SKIP_PATTERNS,
    "dotted": ("ffn.net", "attn2", "norm", "^proj_out$"),
    "embedders": ("condition_embedder", "norm", "scale_shift"),
}


def _bytes(model):
    return sum(p.numel() * p.element_size() for p in model.parameters())


def _jax_cast_names(params, cfg, patterns, storage="float8_e4m3fn"):
    """The port names of the parameters JAX's ``cast_layerwise_storage``
    casts: each leaf marked 1 where JAX casts it, read through the converter."""
    cast = jlayer.cast_layerwise_storage(jax.tree.map(jnp.asarray, params), storage, patterns)
    marks = jax.tree.map(lambda x: np.full(x.shape, float(x.dtype == jnp.dtype(storage)),
                                           np.float32), cast)
    return {k for k, v in convert.from_jax_wan_transformer(marks, cfg).items() if v.all()}


@pytest.mark.parametrize("which", list(PATTERNS))
@pytest.mark.parametrize("name", ["plain_i2v", "mot"])
def test_cast_set_is_jaxs(name, which):
    _, cfg, params = _setup(name)
    patterns = PATTERNS[which]
    model = _model(cfg, params).requires_grad_(False)
    want = _jax_cast_names(params, cfg, patterns)
    assert set(tlayer.layerwise_cast_names(model, patterns)) == want and want
    before = _bytes(model)
    cast = tlayer.cast_layerwise_storage(model, "float8_e5m2", patterns)
    assert set(cast) == want
    params_now = dict(model.named_parameters())
    for n, p in params_now.items():
        assert (p.dtype == torch.float8_e5m2) == (n in want), n
    saved = sum(params_now[n].numel() * 3 for n in want)  # 4 bytes -> 1
    assert before - _bytes(model) == saved
    # every linear holding float8 upcasts at use
    for mod_name, mod in model.named_modules():
        if isinstance(mod, torch.nn.Linear):
            assert isinstance(mod, tlora.Float8Linear) == (f"{mod_name}.weight" in want)


def test_cast_refusals_are_jaxs():
    _, cfg, params = _setup("plain_i2v")
    for patterns in (("nothing_matches",), ()):
        with pytest.raises(ValueError, match="matched no module"):
            jlayer.cast_layerwise_storage(jax.tree.map(jnp.asarray, params), "float8_e4m3fn",
                                          patterns)
        with pytest.raises(ValueError, match="matched no module"):
            tlayer.cast_layerwise_storage(_model(cfg, params).requires_grad_(False),
                                          "float8_e4m3fn", patterns)
    for kw in (dict(layerwise_upcasting_modules="vae"),
               dict(layerwise_upcasting_storage_dtype="float16"),
               dict(layerwise_upcasting_skip_modules_pattern="norm,(")):
        with pytest.raises(ValueError):
            TrainingArgs(**kw)


@pytest.mark.parametrize("name", ["plain_i2v", "mot"])
def test_float8_lora_step_matches_jax(name):
    """One LoRA SFT gradient from float8 storage (JAX casts the tree, then
    ``apply_lora`` upcasts it inside the step): the loss, the adapters'
    gradients and the grad norm; the adapters' B drawn non-zero so that A
    and the upcast weights both reach the loss."""
    jcfg, cfg, params = _setup(name)
    jl = _jax_lora(name, 4, b_scale=0.1)
    cast = jlayer.cast_layerwise_storage(_jnp(params), "float8_e4m3fn")
    batch = _batch(cfg, 6)
    key = jax.random.PRNGKey(6)
    with attention_provider("xla"):
        ref_grads, metrics = _jax_lora_fns(name, 1e-3)[1](_jnp(jl), cast, _jnp(batch), key)
    ref = convert.from_jax_lora(jax.tree.map(np.asarray, ref_grads), cfg)

    model = _model(cfg, params).requires_grad_(False)
    tlayer.cast_layerwise_storage(model, "float8_e4m3fn")
    lora = tlora.apply_lora(model, convert.from_jax_lora(jl, cfg), alpha=ALPHA, rank=RANK)
    assert all(m.weight.dtype == torch.float8_e4m3fn for m in model.modules()
               if isinstance(m, tlora.LoRALinear))
    loss, _ = tts.wan_vap_loss(model, _step_cfgs(jcfg, cfg)[1], _torch_batch(batch),
                               **_jax_draws(key, batch["latents"].shape))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(metrics["loss"]), rtol=LOSS_RTOL)
    sq = 0.0
    for n, ab in lora.items():
        for part in "AB":
            want = ref[n][part].numpy()
            got = np.zeros_like(want) if ab[part].grad is None else ab[part].grad.numpy()
            sq += float((got.astype(np.float64) ** 2).sum())
            assert np.abs(got - want).max() <= GRAD_RTOL * max(np.abs(want).max(), 1e-12), n
    jnorm = float(np.sqrt(sum(float((np.asarray(g, np.float64) ** 2).sum())
                              for g in jax.tree.leaves(ref_grads))))
    np.testing.assert_allclose(np.sqrt(sq), jnorm, rtol=GRAD_RTOL)
    # the float8 storage did not move, and a bypassed pass reads the base alone
    assert all(p.grad is None for n, p in model.named_parameters() if "lora_" not in n)
    merged = tlora.merge_lora_into_params(model.state_dict(), lora, alpha=ALPHA, rank=RANK)
    assert all(v.dtype != torch.float8_e4m3fn for v in merged.values())


def test_trainer_stores_the_base_in_float8(tmp_path):
    """``SFTTrainer`` under ``--training_type lora --layerwise_upcasting_modules
    transformer`` (trainer.py:218-228): the frozen base cast first (JAX's
    cast set), the adapters installed over it, and one step from a
    precomputed item equal to JAX's LoRA step over the cast tree, JAX's
    adapters and draws passed in: the loss, the grad norm and the adapters
    after the AdamW update."""
    jcfg, cfg, params = _setup("plain_i2v")
    lr = 1e-3
    batch = _batch(cfg, 22, b=1)
    lat_keys = ("latents", "condition")
    write_precomputed(str(tmp_path / "cache"), [(
        {"caption": "clip", **{k: v for k, v in batch.items() if k not in lat_keys}},
        {k: batch[k] for k in lat_keys})])
    args = TrainingArgs(model_name="wan", training_type="lora",
                        layerwise_upcasting_modules="transformer",
                        precomputation_dir=str(tmp_path / "cache"),
                        output_dir=str(tmp_path / "out"), rank=RANK, lora_alpha=ALPHA,
                        target_modules=RECIPE_TARGETS, flow_weighting_scheme=SCHEME, lr=lr,
                        lr_scheduler="constant", lr_warmup_steps=0, weight_decay=WEIGHT_DECAY,
                        max_grad_norm=MAX_GRAD_NORM, train_steps=1, checkpointing_steps=100)
    trainer = SFTTrainer(args, _model(cfg, params))
    model = trainer.model
    assert set(trainer.layerwise_cast) == _jax_cast_names(params, cfg, tlayer.DEFAULT_SKIP_PATTERNS)
    assert all(m.weight.dtype == torch.float8_e4m3fn for m in model.modules()
               if isinstance(m, tlora.LoRALinear)) and trainer.lora
    assert trainer.trainable_names and all(n.endswith((".lora_A", ".lora_B"))
                                           for n in trainer.trainable_names)
    jl = _jax_lora("plain_i2v", 7, lr=lr)
    with torch.no_grad():  # JAX's draw of the adapters in place of the port's
        for n, ab in convert.from_jax_lora(jl, cfg).items():
            trainer.lora[n]["A"].copy_(ab["A"])
            trainer.lora[n]["B"].copy_(ab["B"])
    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if not p.requires_grad}
    key = jax.random.PRNGKey(32)
    trainer._draws = lambda b, step: _jax_draws(key, b["latents"].shape)
    trainer.run()

    cast = jlayer.cast_layerwise_storage(_jnp(params), "float8_e4m3fn")
    with attention_provider("xla"):
        jlora, _, metrics = _jax_lora_fns("plain_i2v", lr)[2](_jnp(jl), cast, _tx(lr).init(
            _jnp(jl)), _jnp(batch), key)
    (record,) = trainer.history
    np.testing.assert_allclose(record["loss"], float(metrics["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(record["grad_norm"], float(metrics["grad_norm"]), rtol=GRAD_RTOL)
    ref = convert.from_jax_lora(jax.tree.map(np.asarray, jlora), cfg)
    for n, ab in trainer.lora.items():
        for part in "AB":
            np.testing.assert_allclose(ab[part].detach().numpy(), ref[n][part].numpy(),
                                       atol=PARAM_ATOL, rtol=0, err_msg=f"{n}.{part}")
    assert all(torch.equal(p, frozen[n]) for n, p in model.named_parameters() if n in frozen)


def test_bypass_reads_the_upcast_base():
    """``lora_bypassed`` over float8 storage equals the model whose weights
    are the float8 values upcast, without adapters."""
    _, cfg, params = _setup("plain_i2v")
    model = _model(cfg, params).requires_grad_(False)
    tlayer.cast_layerwise_storage(model, "float8_e4m3fn")
    plain = _model(cfg, params)
    with torch.no_grad():
        for (n, p), q in zip(model.named_parameters(), plain.parameters()):
            q.copy_(p.float())
    tlora.apply_lora(model, tlora.init_lora(model, RANK, tts.parse_target_modules(
        RECIPE_TARGETS), mot_only=False, generator=torch.Generator().manual_seed(0)),
        alpha=ALPHA, rank=RANK)
    for ab in (m for m in model.modules() if isinstance(m, tlora.LoRALinear)):
        torch.nn.init.normal_(ab.lora_B, std=0.1)
    batch = _torch_batch(_batch(cfg, 9))
    args = dict(hidden_states=torch.cat([batch["latents"], batch["condition"]], -1),
                timestep=torch.tensor([300.0, 800.0]),
                encoder_hidden_states=batch["encoder_hidden_states"],
                encoder_hidden_states_image=batch["encoder_hidden_states_image"])
    with torch.no_grad():
        with tlora.lora_bypassed(model):
            got = model(**args)
        adapted = model(**args)
        want = plain(**args)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert not torch.equal(adapted, want)
