"""The port's CogVideoX VAP SFT step against the JAX package's.

Tiny transformer (three blocks, MoT in blocks 0 and 1, the learned position
buffer on) with weights from ``init_cogvideox_mot``, converted with
``convert.from_jax_transformer``; float32 on both sides. The JAX step runs
with the ``xla`` attention provider, the port with its default ``flash``
provider, whose wrappers run the K1 and K5 plain versions through
``FlashAttentionFunction`` on CPU tensors. Timesteps and noise are JAX's
draws from ``jax.random.split(key, 4)``, passed to the port's loss.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vap_tpu.models.cogvideox import CogVideoXMOTConfig as JaxConfig
from vap_tpu.models.cogvideox import init_cogvideox_mot
from vap_tpu.ops.attention import attention_provider
from vap_tpu.training import optimizer as jopt
from vap_tpu.training import train_step as jts
from vap_tpu_torch import convert
from vap_tpu_torch.models.cogvideox.config import CogVideoXMOTConfig
from vap_tpu_torch.models.cogvideox.transformer_mot import CogVideoXTransformer3DMOTModel
from vap_tpu_torch.ops import flash_attention as tfa
from vap_tpu_torch.ops.schedulers import common as tsched
from vap_tpu_torch.training import optimizer as topt
from vap_tpu_torch.training import train_step as tts

CFG = dict(in_channels=8, out_channels=4, num_layers=3, block_idx_with_mot_ref=(0, 1),
           use_learned_positional_embeddings=True)
FRAMES = 3
# float32 on both sides through three blocks; the loss weight 1/(1 - a_t)
# reaches ~1e3 at small t, so losses and grads are held relative to their size
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4  # max|g_port - g_jax| / max|g_jax| per tensor
# an AdamW update moves a weight by about lr (1e-3); both sides take it in
# float32, where a weight near 1 rounds at 1.2e-7
PARAM_ATOL = 1e-6
# below the tiny model's gradient norm (~7e-3), so the clip acts
MAX_GRAD_NORM = 1e-3
# trained by JAX and not by the port: none (the ref patch embedding's
# learned position table is a parameter on both sides and trains)
JAX_ONLY_TRAINABLE = set()


@pytest.fixture(scope="module")
def setup():
    jcfg = JaxConfig.tiny(**CFG)
    params = jax.tree.map(np.asarray, init_cogvideox_mot(jax.random.PRNGKey(0), jcfg))
    cfg = CogVideoXMOTConfig.tiny(**CFG)
    return jcfg, params, cfg


def _model(cfg, params):
    model = CogVideoXTransformer3DMOTModel(cfg)
    model.load_state_dict(convert.from_jax_transformer(params, cfg))
    return model


def _batch(seed, b=1, refs=1):
    rng = np.random.default_rng(seed)
    lat = (b, FRAMES, 4, 8, 8)
    ref = (b, refs * FRAMES, 4, 8, 8)
    return {"latents": rng.standard_normal(lat, np.float32),
            "image_latents": rng.standard_normal(lat, np.float32),
            "latents_mot_ref": rng.standard_normal(ref, np.float32),
            "image_latents_mot_ref": rng.standard_normal(ref, np.float32),
            "encoder_hidden_states": rng.standard_normal((b, 6, 8), np.float32),
            "encoder_hidden_states_mot_ref": rng.standard_normal((b, refs * 6, 8), np.float32)}


def _jax_draws(key, latents_shape):
    """The timesteps and noise ``cogvideox_vap_loss`` draws from ``key``."""
    k_t, k_n, _, _ = jax.random.split(key, 4)
    t = jax.random.randint(k_t, (latents_shape[0],), 0, 1000)
    noise = jax.random.normal(k_n, latents_shape, jnp.float32)
    return {"timesteps": torch.from_numpy(np.asarray(t).astype(np.int64)),
            "noise": torch.from_numpy(np.array(noise))}


@functools.lru_cache(maxsize=None)
def _jax_grad_fn(jcfg):
    """Jitted (loss, trainable grads) of JAX's loss, traced once per shape."""
    step_cfg = jts.TrainStepConfig(model=jcfg, remat=False)

    def f(train, frozen, batch, key):
        return jts.cogvideox_vap_loss(jts.merge_params(train, frozen), step_cfg, batch, key)[0]

    return jax.jit(jax.value_and_grad(f))


def _jax_value_and_grad(jcfg, params, batch, key):
    mask = jts.trainable_mask(params)
    train, frozen = jts.partition_params(params, mask)
    with attention_provider("xla"):  # read while tracing
        loss, grads = _jax_grad_fn(jcfg)(train, frozen,
                                         {k: jnp.asarray(v) for k, v in batch.items()}, key)
    return float(loss), grads, mask


def _as_state_dict(cfg, params, tree):
    """A JAX tree shaped like ``params`` (None where not trainable) ->
    {port name: tensor}, through the converter of the weights."""
    full = jax.tree.map(lambda p, g: np.zeros_like(p) if g is None else np.asarray(g),
                        params, tree, is_leaf=lambda x: x is None)
    return convert.from_jax_transformer(full, cfg)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_trainable_names_match_jax_mask(setup):
    jcfg, params, cfg = setup
    model = _model(cfg, params)
    names = set(tts.trainable_mask(model))
    mask = jts.trainable_mask(params)
    marked = jax.tree.map(lambda p, m: np.full(np.shape(p), m), params, mask)
    jax_names = {k for k, v in convert.from_jax_transformer(marked, cfg).items() if v.all()}
    assert names == jax_names and not JAX_ONLY_TRAINABLE
    assert "patch_embed_mot_ref.pos_embedding" in names
    assert "patch_embed.pos_embedding" in dict(model.named_parameters())
    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    assert frozen and all("_mot_ref" not in n for n in frozen)


@pytest.mark.parametrize("seed", [0, 1])
def test_loss_and_grads_match_jax(setup, seed):
    jcfg, params, cfg = setup
    batch = _batch(seed)
    key = jax.random.PRNGKey(seed)
    ref_loss, ref_grads, _ = _jax_value_and_grad(jcfg, params, batch, key)
    ref = _as_state_dict(cfg, params, ref_grads)

    model = _model(cfg, params)
    tts.trainable_mask(model)
    step_cfg = tts.TrainStepConfig(model=cfg, remat=False)
    before = tfa.flash_attention_backward.launches
    loss, metrics = tts.cogvideox_vap_loss(model, step_cfg, _torch_batch(batch),
                                           **_jax_draws(key, batch["latents"].shape))
    loss.backward()
    assert tfa.flash_attention_backward.launches == before  # CPU: plain versions only
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=LOSS_RTOL)
    assert metrics["loss"].item() == loss.item()
    for name, p in model.named_parameters():
        if not p.requires_grad:
            assert p.grad is None, name
            continue
        want = ref[name].numpy()
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        scale = max(np.abs(want).max(), 1e-12)
        assert np.abs(got - want).max() <= GRAD_RTOL * scale, (name, np.abs(got - want).max(),
                                                               scale)


def test_remat_gives_the_same_grads(setup):
    _, params, cfg = setup
    batch = _torch_batch(_batch(3))
    draws = _jax_draws(jax.random.PRNGKey(3), batch["latents"].shape)
    grads = []
    for remat in (False, True):
        model = _model(cfg, params)
        tts.trainable_mask(model)
        loss, _ = tts.cogvideox_vap_loss(model, tts.TrainStepConfig(model=cfg, remat=remat),
                                         batch, **draws)
        loss.backward()
        grads.append({n: p.grad for n, p in model.named_parameters() if p.grad is not None})
    assert grads[0].keys() == grads[1].keys() and grads[0]
    for name in grads[0]:
        torch.testing.assert_close(grads[1][name], grads[0][name], atol=0, rtol=0, msg=name)


@pytest.mark.parametrize("remat", ["ops", "block_skip:2"])
def test_unported_remat_modes_raise(setup, remat):
    """"ops" and "block_skip:2", once refused, now give the loss and the
    gradients of "full" to the bit (tests/test_torch_remat.py holds them
    against JAX); an unknown mode still raises."""
    _, params, cfg = setup
    batch = _torch_batch(_batch(4))
    draws = _jax_draws(jax.random.PRNGKey(4), batch["latents"].shape)
    out = []
    for mode in ("full", remat):
        model = _model(cfg, params)
        tts.trainable_mask(model)
        loss, _ = tts.cogvideox_vap_loss(model, tts.TrainStepConfig(model=cfg, remat=mode),
                                         batch, **draws)
        loss.backward()
        out.append((loss.detach(), {n: p.grad for n, p in model.named_parameters()
                                    if p.grad is not None}))
    assert torch.equal(out[0][0], out[1][0])
    for name, g in out[0][1].items():
        torch.testing.assert_close(out[1][1][name], g, atol=0, rtol=0, msg=name)
    with pytest.raises(ValueError, match="remat"):
        tts.cogvideox_vap_loss(_model(cfg, params), tts.TrainStepConfig(model=cfg, remat="some"),
                               batch)


@functools.lru_cache(maxsize=None)
def _jax_apply_fn(lr):
    """optax AdamW with clipping under constant_with_warmup (1 step), and
    ``make_grad_and_apply``'s apply_fn, jitted once."""
    schedule = jopt.get_lr_schedule("constant_with_warmup", lr, warmup_steps=1)
    tx = jopt.get_optimizer("adamw", schedule, max_grad_norm=MAX_GRAD_NORM)
    return tx, jax.jit(jts.make_grad_and_apply(None, None, tx, partitioned=True)[1])


def _jax_updates(params, mask, grads, accum, *, lr):
    """apply_fn on the mean of each run of ``accum`` micro-batch gradients."""
    tx, apply_fn = _jax_apply_fn(lr)
    train, _ = jts.partition_params(params, mask)
    opt_state = tx.init(train)
    for u in range(0, len(grads), accum):
        mean = jax.tree.map(lambda *g: sum(g) / accum, *grads[u:u + accum])
        train, opt_state, norm = apply_fn(train, opt_state, mean)
    return train, float(norm)


@pytest.mark.parametrize("accum", [1, 2])
def test_adamw_updates_match_optax(setup, accum):
    """2 * accum micro-batches, one update per ``accum`` of them on the mean
    of their summed gradients (the trainer's accumulation; ``make_train_step``
    at accum 1), with global-norm clipping, against optax on JAX's gradients. The first update is at lr 0
    (constant_with_warmup counts updates, not micro-batches): it moves the
    moments and no weight."""
    jcfg, params, cfg = setup
    lr = 1e-3
    batches = [_batch(10 + i) for i in range(2 * accum)]
    keys = [jax.random.PRNGKey(20 + i) for i in range(2 * accum)]
    jgrads, mask = [], None
    for batch, key in zip(batches, keys):
        _, g, mask = _jax_value_and_grad(jcfg, params, batch, key)
        jgrads.append(g)
    new_train, ref_norm = _jax_updates(params, mask, jgrads, accum, lr=lr)
    ref = _as_state_dict(cfg, params, new_train)

    model = _model(cfg, params)
    names = tts.trainable_mask(model)
    opt = topt.get_optimizer("adamw", [p for p in model.parameters() if p.requires_grad],
                             topt.get_lr_schedule("constant_with_warmup", lr, warmup_steps=1),
                             max_grad_norm=MAX_GRAD_NORM)
    step_cfg = tts.TrainStepConfig(model=cfg, remat=False)
    grad_fn, apply_fn = tts.make_grad_and_apply(tts.cogvideox_vap_loss, step_cfg, opt)
    step_fn = tts.make_train_step(step_cfg, opt)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    for i, (batch, key) in enumerate(zip(batches, keys)):
        draws = _jax_draws(key, batch["latents"].shape)
        if accum == 1:  # the one-call step
            norm = step_fn(model, _torch_batch(batch), **draws)["grad_norm"]
        else:
            grad_fn(model, _torch_batch(batch), **draws)
            if (i + 1) % accum:
                continue
            norm = apply_fn(1.0 / accum)
        if opt.count == 1:
            assert all(torch.equal(p, start[n]) for n, p in model.named_parameters())
    assert opt.count == 2 and ref_norm > MAX_GRAD_NORM  # the clip acted
    np.testing.assert_allclose(norm.item(), ref_norm, rtol=GRAD_RTOL)
    # the last MoT block's reference outputs reach no loss: their weights get
    # zero gradients and move by weight decay alone, below float32 rounding
    live = {n for n, g in _as_state_dict(cfg, params, jgrads[0]).items() if g.any()}
    assert live and live < set(names)
    for name, p in model.named_parameters():
        if name in names:
            np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), atol=PARAM_ATOL,
                                       rtol=0, err_msg=name)
            assert name not in live or not torch.equal(p, start[name]), name
        else:
            assert torch.equal(p, start[name]), name


@pytest.mark.parametrize("name", ["constant", "constant_with_warmup", "linear", "cosine",
                                  "cosine_with_restarts", "polynomial"])
def test_lr_schedules_match_optax(name):
    kw = dict(warmup_steps=3, train_steps=20, num_cycles=2, power=2.0)
    ref = jopt.get_lr_schedule(name, 1e-3, **kw)
    got = topt.get_lr_schedule(name, 1e-3, **kw)
    for count in (0, 1, 2, 3, 4, 10, 12, 19, 20, 25):
        # optax evaluates in float32 (cos to ~1e-6 relative), the port in float64
        np.testing.assert_allclose(got(count), float(ref(count)), rtol=1e-5, atol=1e-12,
                                   err_msg=f"{name} at update {count}")
    milestones = [(2, 0.5), (5, 0.1)]
    ref = jopt.get_lr_schedule("piecewise_constant", 1.0, milestones=milestones)
    got = topt.get_lr_schedule("piecewise_constant", 1.0, milestones=milestones)
    assert [got(c) for c in range(7)] == pytest.approx([float(ref(c)) for c in range(7)])


def test_clip_matches_optax_formula():
    """optax's clip_by_global_norm: g / norm * max_norm once norm >= max_norm
    (no epsilon), the norm reported before clipping."""
    rng = np.random.default_rng(0)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((4, 3), (5,))]
    tx = optax.clip_by_global_norm(1.0)
    ref, _ = tx.update([jnp.asarray(g) for g in grads], tx.init(None))
    params = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    opt = topt.Optimizer("adam", params, lambda count: 0.0, max_grad_norm=1.0)
    norm = opt.step()
    np.testing.assert_allclose(norm.item(), float(optax.global_norm(grads)), rtol=1e-6)
    for p, r in zip(params, ref):
        np.testing.assert_allclose(opt.inner.state[p]["exp_avg"].numpy() / 0.1, np.asarray(r),
                                   rtol=1e-6)


@pytest.mark.parametrize("name", ["adafactor", "adamw-8bit"])
def test_unported_optimizers_raise(name):
    """Both optimizers, once refused, are built now (tests/test_torch_optimizers.py
    holds them against optax and JAX's optim8bit); an unknown name raises."""
    from vap_tpu_torch.training.optim8bit import Adam8bit

    opt = topt.get_optimizer(name, [torch.nn.Parameter(torch.zeros(2))], lambda c: 0.0)
    assert isinstance(opt.inner, topt.Adafactor if name == "adafactor" else Adam8bit)
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.get_optimizer(name + "-x", [torch.nn.Parameter(torch.zeros(2))], lambda c: 0.0)


def test_add_noise_and_get_velocity_match_jax():
    from vap_tpu.ops.schedulers import common as jsched

    ac = tsched.make_alphas_cumprod(rescale_betas_zero_snr=True)
    rng = np.random.default_rng(0)
    x, n = rng.standard_normal((2, 2, 3, 4, 4), np.float32), rng.standard_normal((2, 2, 3, 4, 4),
                                                                                  np.float32)
    t = np.array([0, 999])
    for jfn, tfn in ((jsched.add_noise, tsched.add_noise),
                     (jsched.get_velocity, tsched.get_velocity)):
        ref = np.asarray(jfn(jnp.asarray(ac), jnp.asarray(x), jnp.asarray(n), jnp.asarray(t)))
        got = tfn(torch.from_numpy(ac), torch.from_numpy(x), torch.from_numpy(n),
                  torch.from_numpy(t)).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    assert ac[999] == 0.0  # zero terminal SNR: the loss weight there is 1
