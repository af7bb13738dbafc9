"""Validation sampling in the port's trainer, on the CPU.

A run that validates every step trains exactly as one that never does
(losses bit-equal; the module's mode put back, its gradients freed);
``_resolve_val_limit`` as JAX's (the CogVideoX spec's validation video
against JAX's is in ``test_torch_trainer_data.py``, beside its weights); Wan VAP and HunyuanVideo LoRA trained from
clips on disk with a validation pass each (a benchmark CSV, and the prompt
list of a plain finetune's ``validation.json``).
"""

import json
import os

import numpy as np
import pytest
import torch

from test_torch_data import _layout
from torch_data_util import WAN_CFG, FakeTokenizer, vap_data_dir, write_validation_json
from vap_tpu.training.trainer import SFTTrainer as JaxTrainer
from vap_tpu_torch import train as train_cli
from vap_tpu_torch.data.video import load_video
from vap_tpu_torch.models.hunyuan_video.config import HunyuanVideoConfig
from vap_tpu_torch.models.hunyuan_video.transformer import HunyuanVideoTransformer3DModel
from vap_tpu_torch.models.random_init import build_random
from vap_tpu_torch.models.wan.config import WanMOTConfig
from vap_tpu_torch.models.wan.transformer_mot import WanTransformer3DMOTModel
from vap_tpu_torch.training.args import TrainingArgs
from vap_tpu_torch.training.trainer import SFTTrainer


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = vap_data_dir(str(tmp_path_factory.mktemp("vap")), n=4)
    write_validation_json(os.path.join(root, "validation.json"), num_frames=9, height=32, width=32,
                          num_inference_steps=2, guidance_scale=6.0, use_dynamic_cfg=True)
    return root


def _cog_trainer(data, out, **kw):
    base = dict(data_root=data, output_dir=str(out), video_resolution_buckets=((9, 32, 32),),
                lr=1e-3, lr_scheduler="constant", gradient_checkpointing=False,
                checkpointing_steps=1000, seed=3, train_steps=3, mask_caption_ratio=0.5)
    base.update(kw)
    args = TrainingArgs(**base)
    model = train_cli.build_transformer(args, "tiny", torch.device("cpu"))
    spec = train_cli.build_spec(args, model, "tiny", {"tokenizer": FakeTokenizer()})
    return SFTTrainer(args, model, spec)


def test_validation_does_not_touch_training(data, tmp_path):
    plain = _cog_trainer(data, tmp_path / "plain")
    plain.run()
    val = _cog_trainer(data, tmp_path / "val", validation_steps=1,
                       validation_dataset_file=os.path.join(data, "validation.json"))
    val.run()
    assert [r["loss"] for r in val.history] == [r["loss"] for r in plain.history]
    for step in (1, 2, 3):
        assert os.path.exists(os.path.join(tmp_path, "val", "validation", f"{step:06d}",
                                           "sample_0.mp4"))
    # the module's mode put back, its gradients freed
    assert val.model.training == plain.model.training
    assert all(p.grad is None for p in val.model.parameters())
    assert "timing/validation" in val.tracker.history[-1]
    assert [a["step"] for a in val.tracker.artifacts] == [1, 2, 3]
    frames, _ = load_video(val.validation_artifacts["validation/sample_0"])
    assert frames.shape == (9, 32, 32, 3)


@pytest.mark.parametrize("num_samples,total", [("all", 3), (-1, 3), (None, 3), (None, 1), (2, 3)])
def test_resolve_val_limit_matches_jax(num_samples, total):
    assert (SFTTrainer._resolve_val_limit(None, num_samples, total)
            == JaxTrainer._resolve_val_limit(None, num_samples, total))


def test_wan_vap_trains_and_validates_from_clips(data, tmp_path):
    args = TrainingArgs(model_name="wan", data_root=data, output_dir=str(tmp_path),
                        video_resolution_buckets=((9, 32, 32),), lr_scheduler="constant",
                        gradient_checkpointing=False, checkpointing_steps=1000, seed=3,
                        train_steps=1, validation_steps=1,
                        validation_dataset_file=os.path.join(data, "validation.json"))
    model = build_random(WanTransformer3DMOTModel, WanMOTConfig.tiny(**WAN_CFG), "cpu",
                         torch.float32, torch.Generator().manual_seed(0))
    trainer = SFTTrainer(args, model, train_cli.build_spec(args, model, "tiny",
                                                           {"tokenizer": FakeTokenizer()}))
    trainer.run()
    assert np.isfinite(trainer.history[0]["loss"]) and trainer.optimizer.count == 1
    assert os.path.exists(os.path.join(tmp_path, "validation", "000001", "sample_0.mp4"))


def test_hunyuan_lora_trains_and_validates_from_clips(tmp_path):
    root = _layout(str(tmp_path / "pairs"), "pairs")
    val = os.path.join(tmp_path, "validation.json")
    with open(val, "w") as f:
        json.dump({"num_samples": 1, "data": [{"caption": "MODAL_DISSOLVE a vase", "height": 16,
                                                "width": 16, "num_frames": 5,
                                                "num_inference_steps": 2}]}, f)
    args = TrainingArgs(model_name="hunyuan_video", training_type="lora", rank=4, lora_alpha=4,
                        target_modules="to_q to_k to_v to_out", data_root=root,
                        id_token="MODAL_DISSOLVE", output_dir=str(tmp_path / "out"),
                        video_resolution_buckets=((9, 16, 16),), lr_scheduler="constant",
                        flow_weighting_scheme="logit_normal", gradient_checkpointing=False,
                        checkpointing_steps=1000, seed=3, train_steps=1, validation_steps=1,
                        validation_dataset_file=val)
    model = build_random(HunyuanVideoTransformer3DModel, HunyuanVideoConfig.tiny(), "cpu",
                         torch.float32, torch.Generator().manual_seed(0))
    tok = FakeTokenizer(50)
    trainer = SFTTrainer(args, model, train_cli.build_spec(args, model, "tiny",
                                                           {"tokenizer": tok,
                                                            "clip_tokenizer": tok}))
    trainer.run()
    assert np.isfinite(trainer.history[0]["loss"]) and trainer.optimizer.count == 1
    assert os.path.exists(os.path.join(tmp_path, "out", "validation", "000001", "sample_0.mp4"))
