"""Parameter-sharded training of the port (FSDP2 / HSDP under
``--fsdp_degree``) on several CPU processes (``torch.distributed`` over
gloo), against the JAX package and against the port's one-process trainer.

The workers are spawned as in ``test_torch_seq_trainer.py`` (the
environment ``torchrun`` gives, a free localhost port); each runs every case
of its world in one process group. Worlds (data x fsdp x seq): FSDP 1 x 2,
HSDP 2 x 2 and the mixed 1 x 2 x 2 (FSDP inside each seq rank, the ring
across them). A global batch of 4 throughout, each (data, fsdp) rank taking
its share:
  * the gradients of the CogVideoX VAP loss (the tiny transformer of
    ``test_torch_train_step.py`` under full remat), gathered from their
    shards, against ``jax.grad`` of JAX's ``cogvideox_vap_loss`` under
    ``xla`` on one device;
  * two steps of ``python -m vap_tpu_torch.train`` (``main``) against the
    one-process run at the same global batch, under ``adamw``,
    ``adamw-8bit`` and ``adafactor``; the parameters gathered on every rank
    bit-equal (the data replicas stay identical);
  * under FSDP 1 x 2 also LoRA, LoRA over float8 storage of the base,
    DPO from clips, a resume at step 1 equal to the uninterrupted run, and
    the export equal to the one-process export.
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

from test_torch_dpo import _dpo_trainer, dpo_data  # noqa: F401  (a fixture)
from test_torch_train_step import (CFG, GRAD_RTOL, LOSS_RTOL, PARAM_ATOL, _as_state_dict,
                                   _batch, _jax_draws, _jax_value_and_grad)
from test_torch_trainer import _item
from torch_data_util import rank_threads
from vap_tpu.models.cogvideox import CogVideoXMOTConfig as JaxConfig
from vap_tpu.models.cogvideox import init_cogvideox_mot
from vap_tpu_torch import convert
from vap_tpu_torch import train as train_cli
from vap_tpu_torch.data.precomputation import write_precomputed
from vap_tpu_torch.models.cogvideox.config import CogVideoXMOTConfig
from vap_tpu_torch.models.cogvideox.transformer_mot import CogVideoXTransformer3DMOTModel
from vap_tpu_torch.parallel.sharding import full_tensor, is_sharded, local, rank_numel
from vap_tpu_torch.training.args import TrainingArgs
from vap_tpu_torch.training.trainer import SFTTrainer
from vap_tpu_torch.utils.safetensors import SafetensorsDict

GLOBAL_BATCH = 4
TRAIN_STEPS = 2
# (data, fsdp, seq) of each world and whether it runs the FSDP-only cases
WORLDS = {"fsdp2": ((1, 2, 1), True), "hsdp": ((2, 2, 1), False),
          "fsdp2_seq2": ((1, 2, 2), False)}
OPTIMIZERS = ("adamw", "adamw-8bit", "adafactor")
# LoRA over the tiny model's default targets, float8 storage of its base
LORA = dict(training_type="lora", rank=4, lora_alpha=8)
FLOAT8 = dict(LORA, layerwise_upcasting_modules="transformer")
TIMEOUT_S = 400
# the CLI runs differ from the one-process run in the order of f32 sums
# (the reduce-scatter, the norm's all-reduce): a gradient a few ulps away
# can round one int8 moment code of the 8-bit Adam to its neighbour, which
# moves that element's update by up to ~2/127 of lr (1e-3); given the same
# gradient the sharded 8-bit step is the one-process step to the bit
# (test_sharded_optimizers_step_as_one_process_to_the_bit)
EIGHT_BIT_ATOL = 2e-5
# the DPO loss is -logsigmoid(-0.5 beta (model_diff - ref_diff)) with beta
# 500: after an update it reads the per-sample losses' difference (order 1,
# agreeing to ~1e-6 between the runs) times 250
DPO_LOSS_ATOL = 250 * 1e-6


def _cli_argv(cache, out, **kw):
    argv = ["--precomputation_dir", cache, "--output_dir", out, "--device", "cpu",
            "--model_config", "tiny", "--train_steps", str(TRAIN_STEPS), "--lr", "1e-3",
            "--lr_scheduler", "constant", "--lr_warmup_steps", "0", "--logging_steps", "1",
            "--checkpointing_steps", str(TRAIN_STEPS), "--seed", "3"]
    for k, v in kw.items():
        argv += [f"--{k}", str(v)]
    return argv


def _runs(world):
    """The CLI runs of a world: name -> flags (besides the degrees)."""
    (_, _, seq), fsdp_only = WORLDS[world]
    runs = {opt: {"optimizer": opt} for opt in (OPTIMIZERS if seq == 1 else ("adamw",))}
    if fsdp_only:
        runs.update(lora=LORA, float8=FLOAT8)
    return runs


class _Toy(torch.nn.Module):
    """Leaves whose shards cut through the optimizers' structure: two
    blocks JAX stacks into one leaf, each weight [5, 300] (1500 elements:
    the 8-bit Adam's 2048-element blocks run across the two layers, and
    fsdp 2 cuts each weight 3 | 2 rows, inside a block), and a [257, 130]
    kernel Adafactor factors over both dims, cut 129 | 128."""

    def __init__(self):
        super().__init__()
        self.blocks = torch.nn.ModuleList([torch.nn.Linear(300, 5) for _ in range(2)])
        self.proj = torch.nn.Linear(130, 257)


def _optimizer_steps(name, mesh=None):
    """Two steps of ``name`` on ``_Toy`` from seeded weights and gradients
    (no clipping), sharded over ``mesh`` when given: the whole weights and
    the whole optimizer state after them."""
    from vap_tpu_torch.parallel.sharding import full_state, shard_like, shard_model
    from vap_tpu_torch.training.optimizer import get_lr_schedule, get_optimizer, jax_layout

    torch.manual_seed(5)
    model = _Toy()
    whole = {n: p.detach().clone() for n, p in model.named_parameters()}
    if mesh is not None:
        shard_model(model, mesh)
    params = list(model.parameters())
    opt = get_optimizer(name, params, get_lr_schedule("constant", 1e-2), max_grad_norm=None,
                        layout=jax_layout(model, params))
    gen = torch.Generator().manual_seed(6)
    for _ in range(2):
        for n, p in model.named_parameters():
            p.grad = shard_like(torch.randn(whole[n].shape, generator=gen), p)
        opt.step()
    named = {n: p.detach() for n, p in model.named_parameters()}
    return full_state(named), full_state(opt.state_dict())


def _worker(rank, world, port, work):
    (data, fsdp, seq), fsdp_only = WORLDS[world]
    size = data * fsdp * seq
    torch.set_num_threads(rank_threads(size))
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE=str(size),
                      RANK=str(rank), LOCAL_RANK=str(rank))
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=size, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        degrees = dict(batch_size=GLOBAL_BATCH // (data * fsdp), data_degree=data,
                       fsdp_degree=fsdp, seq_degree=seq)
        state, batch, draws = torch.load(work / "case.pt", weights_only=False)
        got = {}
        model = CogVideoXTransformer3DMOTModel(CogVideoXMOTConfig.tiny(**CFG))
        model.load_state_dict(state)
        trainer = SFTTrainer(TrainingArgs(precomputation_dir=str(work / "cache"),
                                          output_dir=str(work / "grads"), **degrees), model)
        local_batch = {k: trainer._local(torch.from_numpy(v)) for k, v in batch.items()}
        with trainer._attn_ctx():
            metrics = trainer._grad(model, local_batch, None, None,
                                    **{k: trainer._local(v) for k, v in draws.items()})
        loss = metrics["loss"].clone()
        trainer._data_mean([loss])
        assert all(is_sharded(p) for p in trainer.optimizer.params)
        # what a rank stores of each parameter: FSDP2's padded shard, as
        # scripts/memory_check.py counts it
        got["storage"] = {n: (local(p).untyped_storage().nbytes(),
                              rank_numel(p.shape, fsdp) * p.element_size())
                          for n, p in model.named_parameters()}
        got["grads"] = (loss.item(), {n: full_tensor(p.grad).numpy().copy() for n, p in
                                      zip(trainer.trainable_names, trainer.optimizer.params)})
        for name, flags in _runs(world).items():
            run = train_cli.main(_cli_argv(str(work / "cache"), str(work / f"run_{name}"),
                                           **flags, **degrees))
            got[name] = ([r["loss"] for r in run.history], [
                r["grad_norm"] for r in run.history],
                {n: p.numpy().copy() for n, p in run.trainable_state_dict().items()})
        if fsdp_only:
            for name in OPTIMIZERS:  # the one-process steps in this process: its threads
                got["toy", name] = _optimizer_steps(name, trainer.mesh)
                got["toy_one", name] = _optimizer_steps(name)
            # two steps, a checkpoint at each; then step 2 again from step 1's
            out = str(work / "run_resume")
            run = train_cli.main(_cli_argv(str(work / "cache"), out, checkpointing_steps=1,
                                           **degrees))
            got["uninterrupted"] = {n: p.numpy().copy()
                                    for n, p in run.trainable_state_dict().items()}
            run = train_cli.main(_cli_argv(str(work / "cache"), out, checkpointing_steps=1,
                                           resume_from_checkpoint=1, **degrees))
            got["resumed"] = (run.train_state.step, {
                n: p.numpy().copy() for n, p in run.trainable_state_dict().items()})
            dpo = _dpo_trainer(str(work / "dpo_data"), work / "dpo", fsdp_degree=fsdp,
                               batch_size=GLOBAL_BATCH // 2 // fsdp)
            dpo.run()
            got["dpo"] = ([r["loss"] for r in dpo.history],
                          {n: p.numpy().copy() for n, p in dpo.trainable_state_dict().items()})
            got["local_shard"] = {n: local(p).detach().numpy().copy()
                                  for n, p in dpo.model.named_parameters()}
        torch.save(got, work / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(world, work):
    (data, fsdp, seq), _ = WORLDS[world]
    size = data * fsdp * seq
    ctx = mp.start_processes(_worker, args=(world, _free_port(), work), nprocs=size,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{size} gloo ranks did not finish in {TIMEOUT_S} s")
    return [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(size)]


@pytest.fixture(scope="module")
def case(tmp_path_factory, dpo_data):  # noqa: F811
    """JAX's weights, batch and draws, its loss and gradients on one
    device, a precomputed cache, and the one-process runs on the global
    batch."""
    work = tmp_path_factory.mktemp("fsdp_trainer")
    jcfg = JaxConfig.tiny(**CFG)
    params = jax.tree.map(np.asarray, init_cogvideox_mot(jax.random.PRNGKey(0), jcfg))
    cfg = CogVideoXMOTConfig.tiny(**CFG)
    batch = _batch(7, b=GLOBAL_BATCH)
    key = jax.random.PRNGKey(7)
    loss, grads, _ = _jax_value_and_grad(jcfg, params, batch, key)
    torch.save((convert.from_jax_transformer(params, cfg), batch,
                _jax_draws(key, batch["latents"].shape)), work / "case.pt")
    write_precomputed(str(work / "cache"), [_item(i) for i in range(GLOBAL_BATCH)])
    os.symlink(dpo_data, work / "dpo_data")
    one = {}
    for name, flags in _runs("fsdp2").items():
        run = train_cli.main(_cli_argv(str(work / "cache"), str(work / f"one_{name}"),
                                       batch_size=GLOBAL_BATCH, **flags))
        one[name] = ([r["loss"] for r in run.history], [r["grad_norm"] for r in run.history],
                     {n: p.numpy().copy() for n, p in run.trainable_state_dict().items()})
    dpo = _dpo_trainer(dpo_data, work / "one_dpo", batch_size=GLOBAL_BATCH // 2)
    dpo.run()
    one["dpo"] = ([r["loss"] for r in dpo.history],
                  {n: p.numpy().copy() for n, p in dpo.trainable_state_dict().items()})
    return {"work": work, "loss": loss, "grads": _as_state_dict(cfg, params, grads), "one": one}


@pytest.fixture(scope="module")
def ranks(case):
    """World name -> each rank's results; worlds run on first use."""
    runs = {}

    def get(world):
        if world not in runs:
            work = case["work"] / world
            work.mkdir()
            for name in ("case.pt", "cache", "dpo_data"):
                os.symlink(case["work"] / name, work / name)
            runs[world] = _spawn(world, work)
        return runs[world]

    return get


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def _assert_params_close(got, want, atol=PARAM_ATOL):
    assert got.keys() == want.keys()
    for name, p in got.items():
        np.testing.assert_allclose(p, want[name], atol=atol, rtol=0, err_msg=name)


def _assert_bit_equal(results, key):
    for rank, r in enumerate(results[1:], 1):
        assert all(np.array_equal(p, results[0][key][-1][n])
                   for n, p in r[key][-1].items()), (key, rank)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_grads_match_jax(ranks, case, world):
    """The loss (the mean over the (data, fsdp) ranks) and the expert's
    gradients, reduce-scattered by FSDP2 and gathered whole, against
    ``jax.grad`` of JAX's loss on the global batch on one device; equal on
    every rank."""
    got = [r["grads"] for r in ranks(world)]
    np.testing.assert_allclose(got[0][0], case["loss"], rtol=LOSS_RTOL)
    for name, g in got[0][1].items():
        want = case["grads"][name].numpy()
        scale = max(np.abs(want).max(), 1e-12)
        assert np.abs(g - want).max() <= GRAD_RTOL * scale, (name, np.abs(g - want).max(), scale)
    for rank, (loss, grads) in enumerate(got[1:], 1):
        assert loss == got[0][0], rank
        assert all(np.array_equal(g, got[0][1][n]) for n, g in grads.items()), rank


@pytest.mark.parametrize("world", WORLDS)
def test_rank_storage_is_fsdp2s_padded_shard(ranks, world):
    """Every parameter's storage on every rank is ``rank_numel`` elements:
    dim 0 padded to a multiple of fsdp, then cut."""
    for r in ranks(world):
        assert all(got == want for got, want in r["storage"].values()), r["storage"]


CLI_CASES = [(world, name) for world in WORLDS for name in _runs(world)]


@pytest.mark.parametrize("world,name", CLI_CASES)
def test_sharded_cli_matches_one_process_run(ranks, case, world, name):
    """Two CLI steps on the sharded world against the one-process run on
    the same global batch: the losses and grad norms (the norm of the whole
    gradient, all-reduced over the shards) within LOSS_RTOL, the trained
    parameters within PARAM_ATOL, gathered bit-equal on every rank."""
    results = ranks(world)
    losses, norms, params = results[0][name]
    want_losses, want_norms, want_params = case["one"][name]
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(norms, want_norms, rtol=LOSS_RTOL)
    _assert_params_close(params, want_params,
                         EIGHT_BIT_ATOL if name == "adamw-8bit" else PARAM_ATOL)
    _assert_bit_equal(results, name)


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_sharded_optimizers_step_as_one_process_to_the_bit(ranks, name):
    """Given the same gradients, two steps of each optimizer over
    parameters sharded on fsdp 2 give the one-process weights and state to
    the bit: AdamW elementwise on each shard, the 8-bit Adam's codes and
    scales over JAX's stacked leaf across the shard boundaries, Adafactor's
    factored statistics and RMS over the whole leaf."""
    for rank, r in enumerate(ranks("fsdp2")):
        assert _equal(r["toy", name], r["toy_one", name]), (name, rank)


def test_fsdp_resume_at_step_1_equals_the_uninterrupted_run(ranks):
    """Step 2 taken again from rank 0's checkpoint of step 1 (the whole
    expert and AdamW's moments, cut back into each rank's shards) gives the
    parameters of the uninterrupted run to the bit."""
    for r in ranks("fsdp2"):
        step, params = r["resumed"]
        assert step == TRAIN_STEPS
        assert all(np.array_equal(p, r["uninterrupted"][n]) for n, p in params.items())


def test_fsdp_export_equals_one_process_export(ranks, case):
    """Rank 0's export of the sharded run: every tensor of the one-process
    export, the trained ones within PARAM_ATOL, the frozen ones to the bit;
    under LoRA the PEFT file too."""
    ranks("fsdp2")
    for name in ("adamw", "lora"):
        step = f"{TRAIN_STEPS:06d}"
        for fname in ("model.safetensors",) + (("pytorch_lora_weights.safetensors",)
                                               if name == "lora" else ()):
            got = SafetensorsDict([str(case["work"] / "fsdp2" / f"run_{name}" / "model_weights"
                                       / step / fname)])
            want = SafetensorsDict([str(case["work"] / f"one_{name}" / "model_weights" / step
                                        / fname)])
            assert sorted(got) == sorted(want)
            for key in want:
                np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                           atol=PARAM_ATOL, rtol=0, err_msg=key)


def test_fsdp_dpo_matches_one_process_run(ranks, case):
    """DPO from clips under fsdp 2 (one pair per rank, assembled on the
    rank) against the one-process trainer on both pairs: the losses and the
    adapters after two steps; each rank stores half the model."""
    results = ranks("fsdp2")
    losses, adapters = results[0]["dpo"]
    want_losses, want_adapters = case["one"]["dpo"]
    np.testing.assert_allclose(losses[0], want_losses[0], rtol=LOSS_RTOL)
    np.testing.assert_allclose(losses[1:], want_losses[1:], atol=DPO_LOSS_ATOL, rtol=0)
    _assert_params_close(adapters, want_adapters)
    _assert_bit_equal(results, "dpo")
    shards = [r["local_shard"] for r in results]
    for name, full in want_adapters.items():
        assert sum(s[name].shape[0] for s in shards) == full.shape[0], name


def test_fsdp_degrees_of_the_released_recipes_are_accepted():
    """The two HSDP recipes' degrees (CogVideoX 3-ref 4 x 2, Wan VAP 2 x 4)
    make worlds of 8; the control trainer and tensor parallelism still
    raise."""
    assert TrainingArgs(data_degree=4, fsdp_degree=2).world_size == 8
    assert TrainingArgs(model_name="wan", data_degree=2, fsdp_degree=4).world_size == 8
    with pytest.raises(NotImplementedError, match="control trainer"):
        TrainingArgs(model_name="wan", training_type="control", fsdp_degree=2)
    with pytest.raises(NotImplementedError, match="later slice"):
        TrainingArgs(tensor_degree=2)
