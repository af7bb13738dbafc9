"""The Wan and HunyuanVideo trainers of the port under ``--seq_degree 2`` on
two CPU processes (``torch.distributed`` over gloo), against the JAX
package on one device.

The workers are spawned as in ``test_torch_seq_trainer.py``. Each builds the
family's LoRA trainer (``SFTTrainer``, ``seq_degree=2``, the recipe's
targets) over the tiny weights of ``test_torch_wan_train.py`` (the VAP
model, MoT in both blocks) and ``test_torch_hunyuan_train.py``, installs
JAX's adapters (B drawn away from 0), and takes the gradient of one
micro-batch of the whole batch under the trainer's attention context: the
``ring`` provider over the ``seq`` group, Wan's cross-attentions local
(``ring cross:flash``), HunyuanVideo's text mask reaching the ring as
``kv_lens``. Its loss and adapter gradients are held against
``jax.grad`` of JAX's loss under ``xla`` on one device, for each rotate
method, and must be bit-equal on the two ranks.
"""

import datetime
import os
import socket
import time

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import test_torch_hunyuan_train as hy
import test_torch_wan_train as wn
from torch_data_util import rank_threads
from vap_tpu.ops.attention import attention_provider as jax_provider
from vap_tpu_torch import convert
from vap_tpu_torch.training.args import TrainingArgs
from vap_tpu_torch.training.trainer import SEQ_PROVIDERS, SFTTrainer

METHODS = ("allgather", "ppermute", "ulysses")
FAMILIES = ("wan", "hunyuan_video")
WORLD = 2
TIMEOUT_S = 300
# the ring merges per-block partial results in f32 where JAX computes one
# dense softmax: the tolerances of the one-process parity tests hold
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4


def _case(family):
    """(the port's state dict, the batch, the draws, the adapters, JAX's
    loss and adapter gradients) of one family."""
    if family == "wan":
        jcfg, cfg, params = wn._setup("mot")
        batch, key = wn._batch(cfg, 10), jax.random.PRNGKey(11)
        jl = wn._jax_lora("mot", 3, b_scale=0.1)
        with jax_provider("xla"):
            grads, metrics = wn._jax_lora_fns("mot", 1e-3)[1](wn._jnp(jl), wn._jnp(params),
                                                             wn._jnp(batch), key)
        state = convert.from_jax_wan_transformer(params, cfg)
        draws = wn._jax_draws(key, batch["latents"].shape)
    else:
        jcfg, cfg, params = hy._setup()
        batch, key = hy._batch(cfg, 10), jax.random.PRNGKey(11)
        jl = hy._jax_init_lora(params, 3, b_scale=0.1)
        with jax_provider("xla"):
            grads, metrics = hy._jax_lora_fns(1e-3)[0](hy._jnp(jl), hy._jnp(params),
                                                       hy._jnp(batch), key)
        state = convert.from_jax_hunyuan_transformer(params, cfg)
        draws = hy._jax_draws(key, batch["latents"].shape)
    return {"state": state, "batch": batch, "draws": draws,
            "lora": convert.from_jax_lora(jl, cfg), "loss": float(metrics["loss"]),
            "grads": convert.from_jax_lora(jax.tree.map(np.asarray, grads), cfg)}


def _model(family, state):
    if family == "wan":
        model = wn.twan.WanTransformer3DMOTModel(wn._setup("mot")[1])
    else:
        model = hy.HunyuanVideoTransformer3DModel(hy._setup()[1])
    model.load_state_dict(state)
    return model


def _worker(rank, world, port, work):
    torch.set_num_threads(rank_threads(world))
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE=str(world),
                      RANK=str(rank), LOCAL_RANK=str(rank))
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        cases = torch.load(work / "cases.pt", weights_only=False)
        got = {}
        for family in FAMILIES:
            case = cases[family]
            for method in METHODS:
                model = _model(family, case["state"])
                args = TrainingArgs(model_name=family, training_type="lora",
                                    precomputation_dir=str(work / "unused"),
                                    output_dir=str(work / f"{family}_{method}"),
                                    rank=wn.RANK, lora_alpha=int(wn.ALPHA),
                                    target_modules=wn.RECIPE_TARGETS,
                                    flow_weighting_scheme=wn.SCHEME, seq_degree=world,
                                    cp_rotate_method=method, gradient_checkpointing=False)
                trainer = SFTTrainer(args, model)
                with torch.no_grad():
                    for name, ab in case["lora"].items():
                        trainer.lora[name]["A"].copy_(ab["A"])
                        trainer.lora[name]["B"].copy_(ab["B"])
                batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
                with trainer._attn_ctx():
                    metrics = trainer._grad(model, batch, None, None, **case["draws"])
                got[family, method] = (metrics["loss"].item(), {
                    f"{n}.{k}": None if p.grad is None else p.grad.numpy().copy()
                    for n, ab in trainer.lora.items() for k, p in ab.items()})
        torch.save(got, work / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    work = tmp_path_factory.mktemp("seq_families")
    cases = {family: _case(family) for family in FAMILIES}
    torch.save(cases, work / "cases.pt")
    ctx = mp.start_processes(_worker, args=(WORLD, _free_port(), work), nprocs=WORLD,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{WORLD} gloo ranks did not finish in {TIMEOUT_S} s")
    return cases, [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("method", METHODS)
def test_seq_lora_grads_match_jax(results, family, method):
    """The loss and every adapter's gradient under seq = 2 against
    ``jax.grad`` on one device; bit-equal on the two ranks."""
    cases, ranks = results
    case = cases[family]
    loss, grads = ranks[0][family, method]
    np.testing.assert_allclose(loss, case["loss"], rtol=LOSS_RTOL)
    want = {f"{n}.{k}": v.numpy() for n, ab in case["grads"].items() for k, v in ab.items()}
    assert grads.keys() == want.keys()
    floor = 1e-3 * max(np.abs(w).max() for w in want.values())
    for name, w in want.items():
        g = np.zeros_like(w) if grads[name] is None else grads[name]
        scale = max(np.abs(w).max(), floor)
        assert np.abs(g - w).max() <= GRAD_RTOL * scale, (name, np.abs(g - w).max(), scale)
    other_loss, other = ranks[1][family, method]
    assert other_loss == loss
    assert all((g is None and other[n] is None) or np.array_equal(g, other[n])
               for n, g in grads.items())


def test_seq_families_are_accepted_and_wan_keeps_cross_local():
    """``--seq_degree`` > 1 is taken for the three families; under it
    ``auto`` is ``ring``, and for Wan ``ring cross:flash``."""
    for family in FAMILIES:
        assert TrainingArgs(model_name=family, seq_degree=2).world_size == 2
    assert SEQ_PROVIDERS == {"wan": "ring cross:flash"}
