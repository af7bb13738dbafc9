"""The port's Wan training path against the JAX package: the plain trunk,
the flow-matching loss and LoRA SFT.

Tiny Wan transformers (two blocks, the plain structure of the LoRA recipe's
``config_plain.json``, or MoT in both blocks for the VAP branch) with weights
from the JAX package's initializers, jittered by a seeded normal so that no
bias is zero and no norm weight is one, carried into the port by
``convert``; float32 on both sides. The JAX side runs with the ``xla``
attention provider; the port with its default ``flash`` provider, whose
wrappers run their plain versions through ``FlashAttentionFunction`` on CPU
tensors (at head_dim 128: K4's and K6's). Sigmas and noise are JAX's draws
from ``jax.random.split(key)``, passed to the port's loss; the adapters are
JAX's, carried over by ``convert.from_jax_lora``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vap_tpu.models.wan import transformer_mot as jwan
from vap_tpu.models.wan.config import WanMOTConfig as JaxWanConfig
from vap_tpu.ops.attention import attention_provider
from vap_tpu.training import lora as jlora
from vap_tpu.training import optimizer as jopt
from vap_tpu.training import train_step as jts
from vap_tpu_torch import convert
from vap_tpu_torch.models.wan import transformer_mot as twan
from vap_tpu_torch.models.wan.config import WanMOTConfig
from vap_tpu_torch.ops import flash_attention as tfa
from vap_tpu_torch.training import lora as tlora
from vap_tpu_torch.training import optimizer as topt
from vap_tpu_torch.training import train_step as tts

# the Wan LoRA recipe (examples/training/sft/wan/crush_smol_lora/train.sh)
RECIPE_TARGETS = "to_q to_k to_v to_out"
SCHEME = "logit_normal"
RANK, ALPHA = 4, 8.0  # alpha / rank = 2: the scale is not 1
# float32 on both sides through two blocks; only the summation order differs
FWD_ATOL = 2e-5
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4  # max|g_port - g_jax| / max|g_jax| per adapter tensor
# an AdamW update moves a weight by about lr (1e-3); both sides take it in
# float32, where an adapter entry near 1 rounds at 1.2e-7
PARAM_ATOL = 1e-6
MAX_GRAD_NORM = 1e-2
WEIGHT_DECAY = 1e-4  # the optimizers' default, the recipe's
FRAMES, HW, TEXT, IMAGE = 2, 8, 7, 5

CONFIGS = {
    # the LoRA recipe's plain I2V trunk: 4 latent + 4 conditioning channels
    "plain_i2v": dict(in_channels=8, out_channels=4, block_idx_with_mot_ref=()),
    # T2V: no image context, no conditioning channels
    "plain_t2v": dict(in_channels=4, out_channels=4, block_idx_with_mot_ref=(), image_dim=None,
                      added_kv_proj_dim=None),
    # head_dim 128: the port's attention backward is K6's plain version
    "plain_d128": dict(in_channels=8, out_channels=4, block_idx_with_mot_ref=(),
                       num_attention_heads=1, attention_head_dim=128, added_kv_proj_dim=128),
    # the VAP branch: MoT in both blocks
    "mot": dict(in_channels=8, out_channels=4, block_idx_with_mot_ref=(0, 1)),
}


def jitter(tree, seed, scale=0.05):
    """Every leaf plus ``scale`` * a seeded normal, as numpy float32."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.asarray(x, np.float32)
                        + scale * rng.standard_normal(np.shape(x)).astype(np.float32), tree)


@functools.lru_cache(maxsize=None)
def _setup(name):
    kw = CONFIGS[name]
    jcfg, cfg = JaxWanConfig.tiny(**kw), WanMOTConfig.tiny(**kw)
    init = jwan.init_wan_mot if kw["block_idx_with_mot_ref"] else jwan.init_wan
    return jcfg, cfg, jitter(init(jax.random.PRNGKey(0), jcfg), 1)


def _model(cfg, params):
    model = twan.WanTransformer3DMOTModel(cfg)
    model.load_state_dict(convert.from_jax_wan_transformer(params, cfg))
    return model


def _batch(cfg, seed, b=2, refs=1):
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.standard_normal(shape, np.float32)

    lat, cond = (b, FRAMES, HW, HW, cfg.out_channels), cfg.in_channels - cfg.out_channels
    batch = {"latents": n(*lat), "encoder_hidden_states": n(b, TEXT, cfg.text_dim)}
    if cond:
        batch["condition"] = n(*lat[:-1], cond)
    if cfg.image_dim:
        batch["encoder_hidden_states_image"] = n(b, IMAGE, cfg.image_dim)
    if cfg.block_idx_with_mot_ref:
        batch.update(latents_mot_ref=n(b, refs * FRAMES, HW, HW, cfg.out_channels),
                     condition_mot_ref=n(b, refs * FRAMES, HW, HW, cond),
                     encoder_hidden_states_mot_ref=n(b, refs * TEXT, cfg.text_dim),
                     encoder_hidden_states_image_mot_ref=n(b, refs * IMAGE, cfg.image_dim))
    return batch


def _jax_draws(key, shape):
    """The sigmas and noise ``wan_vap_loss`` draws from ``key``."""
    k_t, k_n = jax.random.split(key)
    sigmas = jts.sample_flow_sigmas(k_t, shape[0], scheme=SCHEME)
    noise = jax.random.normal(k_n, shape, jnp.float32)
    return {"sigmas": torch.from_numpy(np.array(sigmas)),
            "noise": torch.from_numpy(np.array(noise))}


def _step_cfgs(jcfg, cfg):
    return (jts.WanTrainStepConfig(model=jcfg, flow_weighting_scheme=SCHEME, remat=False),
            tts.WanTrainStepConfig(model=cfg, flow_weighting_scheme=SCHEME, remat=False))


def _tx(lr):
    return jopt.get_optimizer("adamw", jopt.get_lr_schedule("constant", lr),
                              weight_decay=WEIGHT_DECAY, max_grad_norm=MAX_GRAD_NORM)


@functools.lru_cache(maxsize=None)
def _jax_lora_fns(name, lr):
    """JAX's make_lora_sft_step on the recipe's targets; grad and step jitted."""
    jcfg, _, _ = _setup(name)
    init_fn, grad_fn, _, step_fn = jts.make_lora_sft_step(
        jts.wan_vap_loss, _step_cfgs(jcfg, None)[0], _tx(lr), rank=RANK, alpha=ALPHA,
        targets=jts.parse_target_modules(RECIPE_TARGETS))
    return init_fn, jax.jit(grad_fn), jax.jit(step_fn)


def _jax_lora(name, seed, lr=1e-3, b_scale=0.0):
    """JAX's adapters of config ``name`` (B jittered by ``b_scale``)."""
    _, _, params = _setup(name)
    lora, _, _ = _jax_lora_fns(name, lr)[0](jax.tree.map(jnp.asarray, params),
                                             jax.random.PRNGKey(seed))
    lora = jax.tree.map(np.asarray, lora)
    if b_scale:
        rng = np.random.default_rng(seed)
        lora = jax.tree.map(lambda x: x + b_scale * rng.standard_normal(x.shape).astype(
            np.float32) if x.shape[-2] == RANK else x, lora)
    return lora


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("name", ["plain_i2v", "plain_t2v"])
def test_plain_forward_matches_jax(name):
    """The plain trunk (``wan_forward``), I2V with the image context and the
    conditioning channels, and T2V without either."""
    jcfg, cfg, params = _setup(name)
    model = _model(cfg, params).eval()
    assert not any("_mot_ref" in n for n in model.state_dict())  # init_wan builds none
    batch = _batch(cfg, 3)
    hidden = np.concatenate([batch["latents"], batch["condition"]], -1) if "condition" in batch \
        else batch["latents"]
    args = dict(hidden_states=hidden, timestep=np.array([300.0, 800.0], np.float32),
                encoder_hidden_states=batch["encoder_hidden_states"],
                encoder_hidden_states_image=batch.get("encoder_hidden_states_image"))
    want = jwan.wan_forward(_jnp(params), jcfg, **{k: None if v is None else jnp.asarray(v)
                                                   for k, v in args.items()})
    with torch.no_grad():
        got = model(**{k: None if v is None else torch.from_numpy(v) for k, v in args.items()})
    assert got.shape == (2, FRAMES, HW, HW, cfg.out_channels)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_ATOL, rtol=0)


def test_mot_model_without_references_runs_the_trunk():
    """A MoT model given no reference runs its trunk alone, as ``wan_forward``
    runs every segment of a MoT tree trunk-only."""
    jcfg, cfg, params = _setup("mot")
    batch = _batch(cfg, 4)
    hidden = np.concatenate([batch["latents"], batch["condition"]], -1)
    args = dict(hidden_states=hidden, timestep=np.array([100.0, 900.0], np.float32),
                encoder_hidden_states=batch["encoder_hidden_states"],
                encoder_hidden_states_image=batch["encoder_hidden_states_image"])
    want = jwan.wan_forward(_jnp(params), jcfg, **{k: jnp.asarray(v) for k, v in args.items()})
    with torch.no_grad():
        got = _model(cfg, params)(**{k: torch.from_numpy(v) for k, v in args.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_ATOL, rtol=0)


def test_plain_model_refuses_reference_inputs():
    _, cfg, params = _setup("plain_i2v")
    batch = _torch_batch(_batch(_setup("mot")[1], 5))
    with pytest.raises(ValueError, match="without MoT"):
        _model(cfg, params)(hidden_states=torch.cat([batch["latents"], batch["condition"]], -1),
                            timestep=torch.ones(2), encoder_hidden_states=batch[
                                "encoder_hidden_states"],
                            hidden_states_mot_ref=torch.cat([batch["latents_mot_ref"],
                                                             batch["condition_mot_ref"]], -1),
                            timestep_mot_ref=torch.ones(2, 1),
                            encoder_hidden_states_mot_ref=batch["encoder_hidden_states_mot_ref"])


@pytest.mark.parametrize("scheme", jts.FLOW_WEIGHTING_SCHEMES)
@pytest.mark.parametrize("shift", [1.0, 3.0])
def test_sample_flow_sigmas_matches_jax(scheme, shift):
    """The same draw (normal for logit_normal, else uniform) gives the same
    grid index and sigma."""
    key = jax.random.PRNGKey(7)
    kw = dict(scheme=scheme, logit_mean=0.3, logit_std=1.2, shift=shift)
    want = np.asarray(jts.sample_flow_sigmas(key, 256, **kw))
    sample = jax.random.normal if scheme == "logit_normal" else jax.random.uniform
    draw = torch.from_numpy(np.array(sample(key, (256,))))
    got = tts.sample_flow_sigmas(256, draw=draw, **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(tts.flow_loss_weights(torch.from_numpy(got), scheme).numpy(),
                               np.asarray(jts.flow_loss_weights(jnp.asarray(want), scheme)),
                               rtol=1e-6)
    with pytest.raises(ValueError, match="flow_weighting_scheme"):
        tts.sample_flow_sigmas(2, scheme="bogus")


@pytest.mark.parametrize("spec", [RECIPE_TARGETS, "default", "none", "",
                                  "(transformer_blocks|single_transformer_blocks).*"
                                  "(to_q|to_k|to_v|to_out.0)",
                                  "ff.net.0.proj ff.net.2 to_out"])
def test_parse_target_modules_matches_jax(spec):
    assert tts.parse_target_modules(spec) == jts.parse_target_modules(spec)


def test_parse_target_modules_rejects_unknown_names():
    for parse in (tts.parse_target_modules, jts.parse_target_modules):
        with pytest.raises(ValueError, match="no recognized projection"):
            parse("proj_in")


@pytest.mark.parametrize("name", ["plain_i2v", "mot"])
def test_lora_targets_and_merge_match_jax(name):
    """The port's ``init_lora`` adapts the linears JAX's does (8 per block
    and branch on the recipe's targets), with the same shapes and parameter
    count; ``merge_lora_into_params`` bakes JAX's adapters in as JAX's does."""
    jcfg, cfg, params = _setup(name)
    targets = jts.parse_target_modules(RECIPE_TARGETS)
    jl = jax.tree.map(np.asarray, jlora.init_lora(jax.random.PRNGKey(2), _jnp(params), rank=RANK,
                                                  targets=targets, mot_only=False))
    want = convert.from_jax_lora(jl, cfg)
    model = _model(cfg, params)
    got = tlora.init_lora(model, RANK, targets, mot_only=False,
                          generator=torch.Generator().manual_seed(2))
    assert got.keys() == want.keys()
    assert {n: {k: v.shape for k, v in ab.items()} for n, ab in got.items()} == \
        {n: {k: v.shape for k, v in ab.items()} for n, ab in want.items()}
    branches = 2 if name == "mot" else 1
    assert len(got) == 8 * cfg.num_layers * branches
    assert tlora.lora_param_count(got) == jlora.lora_param_count(jl)
    assert all(torch.equal(ab["B"], torch.zeros_like(ab["B"])) for ab in got.values())

    jl = _jax_lora(name, 2, b_scale=0.1)
    merged = jlora.merge_lora_into_params(_jnp(params), _jnp(jl), alpha=ALPHA, rank=RANK)
    ref = convert.from_jax_wan_transformer(jax.tree.map(np.asarray, merged), cfg)
    out = tlora.merge_lora_into_params(model.state_dict(), convert.from_jax_lora(jl, cfg),
                                       alpha=ALPHA, rank=RANK)
    assert out.keys() == ref.keys()
    for key in ref:
        torch.testing.assert_close(out[key], ref[key], atol=1e-6, rtol=0, msg=key)


@pytest.mark.parametrize("name", ["plain_i2v", "plain_t2v", "plain_d128", "mot"])
def test_wan_loss_and_lora_grads_match_jax(name):
    """``wan_vap_loss`` through the adapted model, both branches, on JAX's
    draws and adapters (B jittered away from 0, so that A has a gradient):
    the loss and each adapter's gradient."""
    jcfg, cfg, params = _setup(name)
    batch = _batch(cfg, 10)
    key = jax.random.PRNGKey(11)
    jl = _jax_lora(name, 3, b_scale=0.1)
    with attention_provider("xla"):  # read while tracing
        ref_grads, metrics = _jax_lora_fns(name, 1e-3)[1](_jnp(jl), _jnp(params), _jnp(batch), key)
    ref = convert.from_jax_lora(jax.tree.map(np.asarray, ref_grads), cfg)

    model = _model(cfg, params).requires_grad_(False)
    lora = tlora.apply_lora(model, convert.from_jax_lora(jl, cfg), alpha=ALPHA, rank=RANK)
    before = (tfa.flash_attention_backward.launches, tfa.flash_attention_backward.launches_d128)
    loss, got_metrics = tts.wan_vap_loss(model, _step_cfgs(jcfg, cfg)[1], _torch_batch(batch),
                                         **_jax_draws(key, batch["latents"].shape))
    loss.backward()
    assert (tfa.flash_attention_backward.launches,
            tfa.flash_attention_backward.launches_d128) == before  # CPU: plain versions only
    np.testing.assert_allclose(loss.item(), float(metrics["loss"]), rtol=LOSS_RTOL)
    assert got_metrics["loss"].item() == loss.item()
    assert lora.keys() == ref.keys()
    for n, ab in lora.items():
        for part in "AB":
            want = ref[n][part].numpy()
            # the last MoT block's reference-only projections reach no loss
            got = np.zeros_like(want) if ab[part].grad is None else ab[part].grad.numpy()
            scale = max(np.abs(want).max(), 1e-12)
            assert np.abs(got - want).max() <= GRAD_RTOL * scale, (n, part)
    assert all(p.grad is None for n, p in model.named_parameters() if "lora_" not in n)


def test_remat_gives_the_same_adapter_grads():
    jcfg, cfg, params = _setup("mot")
    batch = _torch_batch(_batch(cfg, 12))
    draws = _jax_draws(jax.random.PRNGKey(12), batch["latents"].shape)
    jl = convert.from_jax_lora(_jax_lora("mot", 4, b_scale=0.1), cfg)
    grads = []
    for remat in (False, "full"):
        model = _model(cfg, params).requires_grad_(False)
        lora = tlora.apply_lora(model, {n: {k: v.clone() for k, v in ab.items()}
                                        for n, ab in jl.items()}, alpha=ALPHA, rank=RANK)
        step_cfg = tts.WanTrainStepConfig(model=cfg, flow_weighting_scheme=SCHEME, remat=remat)
        tts.wan_vap_loss(model, step_cfg, batch, **draws)[0].backward()
        grads.append({f"{n}.{k}": v.grad for n, ab in lora.items() for k, v in ab.items()})
    for name in grads[0]:
        torch.testing.assert_close(grads[1][name], grads[0][name], atol=0, rtol=0, msg=name)


@pytest.mark.parametrize("name", ["plain_i2v", "mot"])
def test_lora_adamw_updates_match_jax(name):
    """Two steps of ``make_lora_sft_step`` on both sides from JAX's initial
    adapters (B = 0), AdamW at a constant lr with global-norm clipping: the
    first step moves every B and A by weight decay alone (A's gradient is 0
    while B is 0), the second moves both; the adapters after each step, and the grad norms."""
    jcfg, cfg, params = _setup(name)
    lr = 1e-3
    jl = _jax_lora(name, 5, lr=lr)
    _, _, jstep = _jax_lora_fns(name, lr)
    tx = _tx(lr)
    jstate, jlora_p = tx.init(_jnp(jl)), _jnp(jl)

    model = _model(cfg, params)
    lora, opt, step_fn = tts.make_lora_sft_step(
        tts.wan_vap_loss, _step_cfgs(jcfg, cfg)[1], model,
        lambda p: topt.get_optimizer("adamw", p, topt.get_lr_schedule("constant", lr),
                                     weight_decay=WEIGHT_DECAY, max_grad_norm=MAX_GRAD_NORM),
        generator=torch.Generator().manual_seed(0), rank=RANK, alpha=ALPHA,
        targets=tts.parse_target_modules(RECIPE_TARGETS))
    with torch.no_grad():  # JAX's draw of the adapters in place of the port's
        for n, ab in convert.from_jax_lora(jl, cfg).items():
            lora[n]["A"].copy_(ab["A"])
            lora[n]["B"].copy_(ab["B"])
    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if not p.requires_grad}
    assert all("lora_" not in n for n in frozen) and opt.params
    start = {n: {k: v.detach().clone() for k, v in ab.items()} for n, ab in lora.items()}
    # the adapters a loss reaches (all but the last MoT block's reference-only
    # projections): those whose B gets a gradient
    with attention_provider("xla"):
        g0, _ = _jax_lora_fns(name, lr)[1](_jnp(jl), _jnp(params), _jnp(_batch(cfg, 20)),
                                           jax.random.PRNGKey(30))
    live = {n for n, ab in convert.from_jax_lora(jax.tree.map(np.asarray, g0), cfg).items()
            if ab["B"].any()}
    assert live and (name == "mot") == (live < lora.keys())
    for step in range(2):
        batch = _batch(cfg, 20 + step)
        key = jax.random.PRNGKey(30 + step)
        with attention_provider("xla"):
            jlora_p, jstate, jmetrics = jstep(jlora_p, _jnp(params), jstate, _jnp(batch), key)
        metrics = step_fn(model, _torch_batch(batch), **_jax_draws(key, batch["latents"].shape))
        np.testing.assert_allclose(metrics["grad_norm"].item(), float(jmetrics["grad_norm"]),
                                   rtol=GRAD_RTOL)
        ref = convert.from_jax_lora(jax.tree.map(np.asarray, jlora_p), cfg)
        for n, ab in lora.items():
            for part in "AB":
                np.testing.assert_allclose(ab[part].detach().numpy(), ref[n][part].numpy(),
                                           atol=PARAM_ATOL, rtol=0, err_msg=f"{n}.{part}")
                if n not in live:
                    continue
                # while B is 0, A's gradient is 0: weight decay alone moves it
                moved = (ab[part] - start[n][part]).abs().max() / start[n][part].abs().max()
                decay = 2 * lr * WEIGHT_DECAY
                assert (moved > decay) == (part == "B" or step == 1), (n, part, step, moved)
    assert opt.count == 2 and float(jmetrics["grad_norm"]) > MAX_GRAD_NORM  # the clip acted
    assert all(not lora[n]["B"].any() for n in lora.keys() - live)
    assert all(torch.equal(p, frozen[n]) for n, p in model.named_parameters() if n in frozen)


def test_lora_step_without_targets_raises():
    with pytest.raises(ValueError, match="no target modules"):
        tts.make_lora_sft_step(tts.wan_vap_loss, None, None, None, targets=())


def test_float8_base_is_not_ported():
    """A float8 frozen weight, once refused, is now upcast at use: the
    adapted linear gives what it gives over the upcast weight
    (tests/test_torch_layerwise.py holds the float8 step against JAX)."""
    _, cfg, params = _setup("plain_i2v")
    model = _model(cfg, params).requires_grad_(False)
    lora = tlora.init_lora(model, RANK, ("to_q",), mot_only=False)
    linear = model.blocks[0].attn1.to_q
    linear.weight.data = linear.weight.data.to(torch.float8_e4m3fn)
    upcast = linear.weight.float()
    tlora.apply_lora(model, lora, alpha=ALPHA, rank=RANK)
    x = torch.randn(2, 3, linear.in_features)
    adapted = model.blocks[0].attn1.to_q
    assert adapted.weight.dtype == torch.float8_e4m3fn
    with tlora.lora_bypassed(model):
        torch.testing.assert_close(adapted(x), torch.nn.functional.linear(x, upcast, adapted.bias),
                                   atol=0, rtol=0)
