"""Validation sampling in a sequence-parallel run of the port's trainer, on
two CPU processes (``torch.distributed`` over gloo, seq_degree 2).

Every rank samples each validation under the ``ring`` provider, whose
collectives need both ranks of the seq group; only rank 0 writes the
videos. The run trains tiny CogVideoX VAP from clips on disk with a
validation at every step, and is held against the one-process trainer on
the same data: the losses, and each validation video (the same on both
ranks, bit for bit).
"""

import datetime
import os
import socket
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from torch_data_util import FakeTokenizer, vap_data_dir, write_validation_json
from vap_tpu_torch import train as train_cli
from vap_tpu_torch.training.args import TrainingArgs
from vap_tpu_torch.training.trainer import SFTTrainer

TRAIN_STEPS = 2
TIMEOUT_S = 300
# the ring splits the queries over the ranks and all-gathers the outputs: the
# same function as one process, summed in another order
LOSS_RTOL = 1e-5
VIDEO_ATOL = 1e-4


def _trainer(data, out, **kw):
    args = TrainingArgs(data_root=data, output_dir=str(out),
                        video_resolution_buckets=((9, 32, 32),), lr=1e-3,
                        lr_scheduler="constant", gradient_checkpointing=False,
                        checkpointing_steps=1000, seed=3, train_steps=TRAIN_STEPS,
                        validation_steps=1,
                        validation_dataset_file=os.path.join(data, "validation.json"), **kw)
    model = train_cli.build_transformer(args, "tiny", torch.device("cpu"))
    spec = train_cli.build_spec(args, model, "tiny", {"tokenizer": FakeTokenizer()})
    return SFTTrainer(args, model, spec)


def _run(trainer):
    """Run ``trainer``; (losses, each validation's video, the artifacts)."""
    videos = []
    validation = trainer.spec.validation

    def kept(sample, **kw):
        videos.append(np.asarray(validation(sample, **kw)))
        return videos[-1]

    trainer.spec.validation = kept
    trainer.run()
    return [r["loss"] for r in trainer.history], videos, trainer.validation_artifacts


def _worker(rank, world, port, data, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        result = _run(_trainer(data, out, seq_degree=world))
        torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(world, data, out):
    ctx = mp.start_processes(_worker, args=(world, _free_port(), data, out), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{world} gloo ranks did not finish in {TIMEOUT_S} s")
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = vap_data_dir(str(tmp_path_factory.mktemp("vap")), n=4)
    write_validation_json(os.path.join(root, "validation.json"), num_frames=9, height=32,
                          width=32, num_inference_steps=2, guidance_scale=6.0)
    one = _run(_trainer(root, tmp_path_factory.mktemp("one_process")))
    out = tmp_path_factory.mktemp("seq2")
    return one, _spawn(2, root, str(out)), str(out)


def test_seq_parallel_validation_matches_one_process(runs):
    (losses, videos, _), ranks, _ = runs
    np.testing.assert_allclose([r[0] for r in ranks], [losses] * 2, rtol=LOSS_RTOL)
    for rank, (_, got, _) in enumerate(ranks):
        assert len(got) == len(videos) == TRAIN_STEPS, rank
        for g, want in zip(got, videos):
            assert g.shape == want.shape == (9, 32, 32, 3)
            np.testing.assert_allclose(g, want, atol=VIDEO_ATOL)
    assert all(np.array_equal(a, b) for a, b in zip(ranks[0][1], ranks[1][1]))


def test_seq_parallel_validation_written_by_rank_0_only(runs):
    _, ranks, out = runs
    for step in range(1, TRAIN_STEPS + 1):
        assert os.path.exists(os.path.join(out, "validation", f"{step:06d}", "sample_0.mp4"))
    assert ranks[0][2] == {"validation/sample_0": os.path.join(
        out, "validation", f"{TRAIN_STEPS:06d}", "sample_0.mp4")}
    assert ranks[1][2] == {}
