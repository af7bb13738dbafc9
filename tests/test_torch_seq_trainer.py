"""Sequence- and data-parallel training of the port on several CPU processes
(``torch.distributed`` over gloo) against the JAX package and against the
port's one-process trainer.

Workers are started with ``torch.multiprocessing`` (spawn) on a free
localhost port, with the environment ``torchrun`` would give them; each runs
every case of its world in one process group:
  * the gradients of the CogVideoX VAP loss (the tiny transformer of
    ``test_torch_train_step.py``, weights from ``init_cogvideox_mot`` through
    ``convert.py``, JAX's draws) on a global batch of 2, each data rank on
    its rows under ``SFTTrainer``'s attention context and the data-group
    mean, held against ``jax.grad`` of JAX's ``cogvideox_vap_loss`` under
    ``xla`` on one device (as ``test_train_step_grads_parity_dp_fsdp_seq``
    holds JAX's mesh against one device);
  * two steps of ``python -m vap_tpu_torch.train`` (``main``) at the same
    global batch, held against the one-process trainer, parameters
    bit-equal across the ranks.
Worlds: data = 2 x seq = 2 (allgather), and seq = 2 under each rotate method.
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

from test_torch_train_step import (CFG, GRAD_RTOL, LOSS_RTOL, _as_state_dict, _batch,
                                   _jax_draws, _jax_value_and_grad)
from test_torch_trainer import _item
from vap_tpu.models.cogvideox import CogVideoXMOTConfig as JaxConfig
from vap_tpu.models.cogvideox import init_cogvideox_mot
from vap_tpu_torch import convert
from vap_tpu_torch import train as train_cli
from vap_tpu_torch.data.precomputation import write_precomputed
from vap_tpu_torch.models.cogvideox.config import CogVideoXMOTConfig
from vap_tpu_torch.models.cogvideox.transformer_mot import CogVideoXTransformer3DMOTModel
from vap_tpu_torch.training.args import TrainingArgs
from vap_tpu_torch.training.trainer import SFTTrainer

METHODS = ("allgather", "ppermute", "ulysses")
# (data, seq) of each world and the rotate methods it runs
WORLDS = {4: ((2, 2), ("allgather",)), 2: ((1, 2), METHODS)}
GLOBAL_BATCH = 2
TRAIN_STEPS = 2
# two AdamW steps (lr 1e-3) from gradients that differ from the one-process
# run's in their f32 summation order (the data mean, the ring's merge): a
# parameter moves by about lr a step, and the two runs agree to ~1e-7 of it
PARAM_ATOL = 1e-6
TIMEOUT_S = 300


def _cli_argv(cache, out, **kw):
    argv = ["--precomputation_dir", cache, "--output_dir", out, "--device", "cpu",
            "--model_config", "tiny", "--train_steps", str(TRAIN_STEPS), "--lr", "1e-3",
            "--lr_scheduler", "constant", "--logging_steps", "1", "--checkpointing_steps",
            str(TRAIN_STEPS), "--seed", "3"]
    for k, v in kw.items():
        argv += [f"--{k}", str(v)]
    return argv


def _worker(rank, world, port, work):
    """One rank: for each rotate method of its world, the loss and the
    data-mean gradients of one micro-batch, then a two-step CLI run; saved
    as ``rank{rank}.pt``."""
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE=str(world),
                      RANK=str(rank), LOCAL_RANK=str(rank))
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        (data, seq), methods = WORLDS[world]
        state, batch, draws = torch.load(work / "case.pt", weights_only=False)
        cfg = CogVideoXMOTConfig.tiny(**CFG)
        got = {}
        for method in methods:
            model = CogVideoXTransformer3DMOTModel(cfg)
            model.load_state_dict(state)
            args = TrainingArgs(precomputation_dir=str(work / "cache"),
                                output_dir=str(work / f"grads_{method}"),
                                batch_size=GLOBAL_BATCH // data, data_degree=data,
                                seq_degree=seq, cp_rotate_method=method,
                                gradient_checkpointing=False)
            trainer = SFTTrainer(args, model)
            local = {k: trainer._local(torch.from_numpy(v)) for k, v in batch.items()}
            with trainer._attn_ctx():
                metrics = trainer._grad(model, local, None, None,
                                        **{k: trainer._local(v) for k, v in draws.items()})
            loss = metrics["loss"].clone()
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in trainer.optimizer.params]
            trainer._data_mean([loss] + grads)
            got["grads", method] = (loss.item(), {n: g.numpy() for n, g in
                                                  zip(trainer.trainable_names, grads)})
            out = str(work / f"run_{method}")
            run = train_cli.main(_cli_argv(str(work / "cache"), out,
                                           batch_size=GLOBAL_BATCH // data, data_degree=data,
                                           seq_degree=seq, cp_rotate_method=method))
            got["params", method] = {n: p.numpy().copy()
                                     for n, p in run.trainable_state_dict().items()}
            got["loss", method] = [r["loss"] for r in run.history]
            if data > 1:  # every rank resumes from rank 0's checkpoint and takes a third step
                run = train_cli.main(_cli_argv(str(work / "cache"), out,
                                               batch_size=GLOBAL_BATCH // data,
                                               data_degree=data, seq_degree=seq,
                                               cp_rotate_method=method,
                                               train_steps=TRAIN_STEPS + 1,
                                               resume_from_checkpoint="latest"))
                got["resumed", method] = (run.train_state.step, {
                    n: p.numpy().copy() for n, p in run.trainable_state_dict().items()})
        torch.save(got, work / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(world, work):
    ctx = mp.start_processes(_worker, args=(world, _free_port(), work), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{world} gloo ranks did not finish in {TIMEOUT_S} s")
    return [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(world)]


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """JAX's weights, batch and draws, its loss and gradients under "xla"
    on one device, a precomputed cache, and the one-process CLI run on the
    global batch."""
    work = tmp_path_factory.mktemp("seq_trainer")
    jcfg = JaxConfig.tiny(**CFG)
    params = jax.tree.map(np.asarray, init_cogvideox_mot(jax.random.PRNGKey(0), jcfg))
    cfg = CogVideoXMOTConfig.tiny(**CFG)
    batch = _batch(7, b=GLOBAL_BATCH)
    key = jax.random.PRNGKey(7)
    loss, grads, _ = _jax_value_and_grad(jcfg, params, batch, key)
    torch.save((convert.from_jax_transformer(params, cfg), batch,
                _jax_draws(key, batch["latents"].shape)), work / "case.pt")
    write_precomputed(str(work / "cache"), [_item(i) for i in range(3)])
    one = train_cli.main(_cli_argv(str(work / "cache"), str(work / "one_process"),
                                   batch_size=GLOBAL_BATCH))
    return {"work": work, "loss": loss, "grads": _as_state_dict(cfg, params, grads),
            "params": {n: p.numpy().copy() for n, p in one.trainable_state_dict().items()},
            "history": [r["loss"] for r in one.history]}


@pytest.fixture(scope="module")
def ranks(case):
    """World size -> each rank's results; worlds run on first use."""
    runs = {}

    def get(world):
        if world not in runs:
            work = case["work"] / f"world{world}"
            work.mkdir()
            for name in ("case.pt", "cache"):
                os.symlink(case["work"] / name, work / name)
            runs[world] = _spawn(world, work)
        return runs[world]

    return get


CASES = [(world, method) for world, (_, methods) in WORLDS.items() for method in methods]


@pytest.mark.parametrize("world,method", CASES)
def test_parallel_loss_and_grads_match_jax(ranks, case, world, method):
    """Every rank's loss (the data-group mean) and expert gradients (the
    data-group mean, after the ring's backward) against ``jax.grad`` of
    JAX's loss on the whole batch on one device; bit-equal across the
    ranks."""
    got = [r["grads", method] for r in ranks(world)]
    np.testing.assert_allclose(got[0][0], case["loss"], rtol=LOSS_RTOL)
    for name, g in got[0][1].items():
        want = case["grads"][name].numpy()
        scale = max(np.abs(want).max(), 1e-12)
        assert np.abs(g - want).max() <= GRAD_RTOL * scale, (name, np.abs(g - want).max(), scale)
    for rank, (loss, grads) in enumerate(got[1:], 1):
        assert loss == got[0][0], rank
        assert all(np.array_equal(g, got[0][1][n]) for n, g in grads.items()), rank


@pytest.mark.parametrize("world,method", CASES)
def test_parallel_cli_matches_one_process_run(ranks, case, world, method):
    """Two steps of the CLI on the parallel world against the one-process
    run on the same global batch: the logged losses and the trained
    parameters within PARAM_ATOL, the parameters bit-equal on every rank;
    rank 0 alone wrote the checkpoint."""
    got = [r for r in ranks(world)]
    np.testing.assert_allclose(got[0]["loss", method], case["history"], rtol=LOSS_RTOL)
    for name, p in got[0]["params", method].items():
        np.testing.assert_allclose(p, case["params"][name], atol=PARAM_ATOL, rtol=0,
                                   err_msg=name)
    for rank, r in enumerate(got[1:], 1):
        assert all(np.array_equal(p, got[0]["params", method][n])
                   for n, p in r["params", method].items()), rank
    ckpt = case["work"] / f"world{world}" / f"run_{method}" / "checkpoints"
    assert os.listdir(ckpt) == [f"step_{TRAIN_STEPS}.pt"]


def test_every_rank_resumes_from_rank_0s_checkpoint(ranks):
    """data = 2 x seq = 2: a third step resumed from the checkpoint rank 0
    wrote leaves the parameters equal on every rank."""
    got = [r["resumed", "allgather"] for r in ranks(4)]
    assert all(step == TRAIN_STEPS + 1 for step, _ in got)
    for rank, (_, params) in enumerate(got[1:], 1):
        assert all(np.array_equal(p, got[0][1][n]) for n, p in params.items()), rank


@pytest.mark.parametrize("flag", ["fsdp_degree", "tensor_degree"])
def test_unported_degrees_raise(flag):
    with pytest.raises(NotImplementedError, match="later slice"):
        TrainingArgs(**{flag: 2})


def test_parallel_flags_validated():
    """JAX's names and defaults; an unknown rotate method, a degree below 1
    or Wan under --seq_degree raise, and so does a world the launcher does
    not run."""
    args = TrainingArgs()
    assert (args.data_degree, args.fsdp_degree, args.seq_degree, args.tensor_degree,
            args.cp_rotate_method, args.attn_provider_training) == (1, 1, 1, 1, "allgather",
                                                                     "auto")
    with pytest.raises(ValueError, match="cp_rotate_method"):
        TrainingArgs(cp_rotate_method="alltoall")
    with pytest.raises(ValueError, match="seq_degree must be >= 1"):
        TrainingArgs(seq_degree=0)
    with pytest.raises(NotImplementedError, match="later slice"):
        TrainingArgs(model_name="wan", seq_degree=2)
    with pytest.raises(ValueError, match="unknown attention provider"):
        TrainingArgs(attn_provider_training="bogus")
    with pytest.raises(ValueError, match="launcher runs 1 processes"):
        train_cli.main(["--precomputation_dir", "x", "--device", "cpu", "--seq_degree", "2"])
