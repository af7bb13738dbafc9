"""Block remat "ops" and "block_skip:N" (``scan_blocks_with_remat``,
``vap_tpu/models/common.py:263-305``) in the port's transformers.

A tiny plain Wan trunk of three blocks, float32: for each mode the loss of
``wan_vap_loss`` is JAX's under the same mode, and the gradients of every
parameter equal those of "full" to the bit (the same forward runs again).
Under "ops" the outputs of the matrix products are kept and not recomputed,
while the attention forward runs again (the card's attention kernels launch
outside aten, as a Pallas call is no dot to JAX's ``dots_saveable``); "block_skip:N" checkpoints the first block of
each group of N, JAX's grouping.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from vap_tpu.models.wan import transformer_mot as jwan
from vap_tpu.models.wan.config import WanMOTConfig as JaxWanConfig
from vap_tpu.ops.attention import attention_provider
from vap_tpu.training import train_step as jts
from vap_tpu_torch import convert
from vap_tpu_torch.models import common
from vap_tpu_torch.models.wan.config import WanMOTConfig
from vap_tpu_torch.models.wan.transformer_mot import WanTransformer3DMOTModel
from vap_tpu_torch.ops import flash_attention as tfa
from vap_tpu_torch.training import train_step as tts
from vap_tpu_torch.training.args import TrainingArgs

CFG = dict(in_channels=4, out_channels=4, num_layers=3, block_idx_with_mot_ref=(),
           image_dim=None, added_kv_proj_dim=None)
MODES = ["full", "ops", "block_skip:1", "block_skip:2", "block_skip:3"]
LOSS_RTOL = 1e-5


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg = JaxWanConfig.tiny(**CFG)
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda x: np.asarray(x, np.float32) + 0.05 * rng.standard_normal(
        np.shape(x)).astype(np.float32), jwan.init_wan(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(2)
    batch = {"latents": rng.standard_normal((2, 2, 8, 8, 4), np.float32),
             "encoder_hidden_states": rng.standard_normal((2, 7, 8), np.float32)}
    key = jax.random.PRNGKey(3)
    k_t, k_n = jax.random.split(key)
    draws = {"sigmas": torch.from_numpy(np.array(jts.sample_flow_sigmas(k_t, 2))),
             "noise": torch.from_numpy(np.array(jax.random.normal(k_n, (2, 2, 8, 8, 4))))}
    return jcfg, WanMOTConfig.tiny(**CFG), params, batch, key, draws


@functools.lru_cache(maxsize=None)
def _port(mode):
    """(loss, grads by name) of the port's step under ``mode``."""
    _, cfg, params, batch, _, draws = _setup()
    model = WanTransformer3DMOTModel(cfg)
    model.load_state_dict(convert.from_jax_wan_transformer(params, cfg))
    loss, _ = tts.wan_vap_loss(model, tts.WanTrainStepConfig(model=cfg, remat=mode),
                               {k: torch.from_numpy(v) for k, v in batch.items()}, **draws)
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("mode", MODES)
def test_mode_matches_jax_and_full(mode):
    jcfg, _, params, batch, key, _ = _setup()
    with attention_provider("xla"):
        jloss, _ = jax.jit(functools.partial(
            jts.wan_vap_loss, cfg=jts.WanTrainStepConfig(model=jcfg, remat=mode)))(
            jax.tree.map(jnp.asarray, params), batch=jax.tree.map(jnp.asarray, batch), key=key)
    loss, grads = _port(mode)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    full_loss, full = _port("full")
    assert torch.equal(loss, full_loss)
    for name, g in full.items():
        torch.testing.assert_close(grads[name], g, atol=0, rtol=0, msg=name)


@pytest.mark.parametrize("length,n,want", [
    (3, 1, "FFF"), (3, 2, "F.."), (3, 3, "F.."), (5, 2, "F.F.."), (2, 3, "FF"),
    (6, 3, "F..F.."), (7, 3, "F..F...")])
def test_block_skip_groups_are_jaxs(length, n, want):
    """The first L - L mod N blocks in groups of N, the first of each
    checkpointed; the tail plain; every block when N <= 1 or L < N."""
    plan = common.remat_plan(f"block_skip:{n}", length)
    assert "".join("F" if m == "full" else "." for m in plan) == want
    assert common.remat_plan("block_skip", 4) == common.remat_plan("block_skip:2", 4)
    assert common.remat_plan("ops", 2) == ["ops", "ops"]
    assert common.remat_plan(False, 2) == [None, None]
    assert common.segments_plan("block_skip:2", [3, 2]) == ["full", None, None, "full", None]
    with pytest.raises(ValueError, match="unknown remat mode"):
        common.remat_plan("some", 2)


class _Count(TorchDispatchMode):
    """Matrix products run."""

    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func in common._SAVED_OPS
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("mode", ["full", "ops"])
def test_ops_keeps_products_and_recomputes_attention(mode, monkeypatch):
    """The backward's matrix products and attention forwards: under "full"
    each block's forward runs again whole; under "ops" no product runs
    again, and the attention forward does."""
    _, cfg, params, batch, _, draws = _setup()
    forwards = []
    real = tfa.flash_attention_forward
    monkeypatch.setattr(tfa, "flash_attention_forward",
                        lambda *a, **k: forwards.append(1) or real(*a, **k))
    counts = {}
    for remat in (False, mode):
        model = WanTransformer3DMOTModel(cfg)
        model.load_state_dict(convert.from_jax_wan_transformer(params, cfg))
        loss, _ = tts.wan_vap_loss(model, tts.WanTrainStepConfig(model=cfg, remat=remat),
                                   {k: torch.from_numpy(v) for k, v in batch.items()}, **draws)
        forwards.clear()
        with _Count() as c:
            loss.backward()
        counts[remat] = (c.mm, len(forwards))
    assert counts[False][1] == 0
    assert counts[mode][1] == 2 * cfg.num_layers  # self- and cross-attention, recomputed
    if mode == "full":
        assert counts[mode][0] > counts[False][0]
    else:
        assert counts[mode][0] == counts[False][0]


def test_args_map_onto_the_modes():
    assert TrainingArgs().remat_mode() == "full"
    assert TrainingArgs(checkpointing_type="ops").remat_mode() == "ops"
    assert TrainingArgs(checkpointing_type="block_skip",
                        checkpointing_n_layer=3).remat_mode() == "block_skip:3"
    assert TrainingArgs(gradient_checkpointing=False, checkpointing_type="ops").remat_mode() \
        is False
    for kw in (dict(checkpointing_type="selective"), dict(checkpointing_n_layer=0)):
        with pytest.raises(ValueError):
            TrainingArgs(**kw)
    assert dataclasses.fields(TrainingArgs)
