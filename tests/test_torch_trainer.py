"""The port's SFT trainer and its entry point on the CPU.

The cache is written by the JAX package's ``PrecomputedPreprocessor`` (the
format the JAX trainer's precompute pass leaves on disk) and read by the
port's trainer, which trains a tiny random CogVideoX MoT transformer.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vap_tpu.data.precomputation import PrecomputedPreprocessor
from vap_tpu_torch import train as train_cli
from vap_tpu_torch.data.precomputation import PrecomputedReader, write_precomputed
from vap_tpu_torch.models.cogvideox.transformer_mot import CogVideoXTransformer3DMOTModel
from vap_tpu_torch.models.random_init import build_random
from vap_tpu_torch.training.args import TrainingArgs
from vap_tpu_torch.training.trainer import SFTTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = train_cli.MODELS["cogvideox"][2]["tiny"]()
ITEMS = 3


def _item(i):
    rng = np.random.default_rng(100 + i)
    lat = (1, 3, 4, 8, 8)

    def n(shape):
        return rng.standard_normal(shape).astype(np.float32)

    cond = {"encoder_hidden_states": n((1, 6, 8)), "encoder_hidden_states_mot_ref": n((1, 6, 8)),
            "caption": f"clip {i}"}  # a non-array entry rides in __meta__
    return cond, {"latents": n(lat), "image_latents": n(lat), "latents_mot_ref": n(lat),
                  "image_latents_mot_ref": n(lat)}


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """A cache of ITEMS items written by the JAX package's precompute pass."""
    root = str(tmp_path_factory.mktemp("precomputed"))
    items = [_item(i) for i in range(ITEMS)]
    pre = PrecomputedPreprocessor(root)
    assert pre.precompute(iter(range(ITEMS)), lambda i: items[i][0], lambda i: items[i][1]) == ITEMS
    return root, items


def _model(seed=0):
    return build_random(CogVideoXTransformer3DMOTModel, CFG, "cpu", torch.float32,
                        torch.Generator().manual_seed(seed))


def _args(cache_dir, out, **kw):
    base = dict(precomputation_dir=cache_dir, output_dir=str(out), lr=1e-3,
                lr_scheduler="constant", gradient_checkpointing=False, logging_steps=1,
                checkpointing_steps=1000, seed=3)
    base.update(kw)
    return TrainingArgs(**base)


def test_reader_replays_the_jax_cache(cache):
    root, items = cache
    reader = PrecomputedReader(root)
    assert len(reader) == ITEMS
    stream = reader.stream(start=2)
    for i in (2, 0, 1):  # from item 2 of the endless replay
        cond, lat = next(stream)
        assert cond["caption"] == items[i][0]["caption"]
        for k, v in {**items[i][0], **items[i][1]}.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal({**cond, **lat}[k], v)


def test_write_precomputed_reads_back(tmp_path):
    items = [_item(i) for i in range(2)]
    assert write_precomputed(str(tmp_path), items) == 2
    cond, lat = PrecomputedReader(str(tmp_path)).item(1)
    assert cond["caption"] == "clip 1"
    np.testing.assert_array_equal(lat["latents"], items[1][1]["latents"])
    with pytest.raises(FileNotFoundError):
        PrecomputedReader(str(tmp_path / "missing"))


@pytest.mark.parametrize("accum", [1, 2])
def test_trainer_runs_three_steps(cache, tmp_path, accum):
    root, _ = cache
    model = _model()
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer = SFTTrainer(_args(root, tmp_path, train_steps=3 * accum,
                               gradient_accumulation_steps=accum,
                               gradient_checkpointing=accum == 2), model)
    state = trainer.run()
    assert state.step == 3 * accum and state.observed_data_samples == 3 * accum
    assert trainer.optimizer.count == 3  # one update per accumulation boundary
    assert trainer.data_position == 3 * accum
    updates = [r for r in trainer.history if "grad_norm" in r]
    assert len(trainer.history) == 3 * accum and len(updates) == 3
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in updates)
    assert all(r["forward_s"] >= 0 and r["backward_s"] >= 0 for r in trainer.history)
    for name, p in model.named_parameters():
        if name in trainer.trainable_names:
            assert p.grad is None  # cleared after each update
        else:
            assert torch.equal(p, start[name]), name
    assert any(not torch.equal(p, start[n]) for n, p in model.named_parameters())


def test_resume_matches_uninterrupted_run(cache, tmp_path):
    """4 steps in one go against 2 steps, a checkpoint, and 2 more steps in a
    fresh trainer resumed from it: the same draws (a generator per (seed,
    step)), the same data position, the same parameters to the bit."""
    root, _ = cache
    whole = _model()
    SFTTrainer(_args(root, tmp_path / "whole", train_steps=4), whole).run()

    part = _model()
    first = SFTTrainer(_args(root, tmp_path / "part", train_steps=2, checkpointing_steps=2), part)
    first.run()
    assert first.checkpointer.all_steps() == [2]
    resumed_model = _model()
    resumed = SFTTrainer(_args(root, tmp_path / "part", train_steps=4, checkpointing_steps=2,
                               checkpointing_limit=1, resume_from_checkpoint="latest"),
                         resumed_model)
    state = resumed.run()
    assert state.step == 4 and resumed.optimizer.count == 4 and resumed.data_position == 4
    assert resumed.checkpointer.all_steps() == [4]  # the keep-limit dropped step 2
    for (name, p), q in zip(whole.named_parameters(), resumed_model.parameters()):
        assert torch.equal(p, q), name
    restored = resumed.checkpointer.restore(4)
    assert restored["train_state"].step == 4 and restored["data_position"] == 4
    assert set(restored["params"]) == set(resumed.trainable_names)


def test_cli_trains_on_cpu(cache, tmp_path):
    root, _ = cache
    trainer = train_cli.main(["--precomputation_dir", root, "--output_dir", str(tmp_path),
                              "--device", "cpu", "--model_config", "tiny", "--train_steps", "2",
                              "--lr_scheduler", "constant", "--checkpointing_steps", "2",
                              "--no-gradient_checkpointing"])
    assert trainer.train_state.step == 2 and trainer.optimizer.count == 2
    assert trainer.step_cfg.remat is False
    assert trainer.checkpointer.all_steps() == [2]


def test_cli_without_device_raises_where_there_is_no_card(cache, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry point would train on it")
    root, _ = cache
    proc = subprocess.run([sys.executable, "-m", "vap_tpu_torch.train", "--precomputation_dir",
                           root, "--output_dir", str(tmp_path)], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
