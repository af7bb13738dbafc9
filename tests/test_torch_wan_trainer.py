"""The port's trainer and CLI on the Wan LoRA recipe, on the CPU at a tiny size.

``python -m vap_tpu_torch.train --model_name wan --training_type lora`` with
the recipe's flags (``examples/training/sft/wan/crush_smol_lora/train.sh``:
its ``config_plain.json``, ``to_q to_k to_v to_out``, logit-normal sigmas)
on a precomputed cache of plain I2V items in ``WanSpec``'s layout; a
resumed run against an uninterrupted one; the Wan VAP expert SFT on a VAP
item; the argument checks. The numerics against JAX are in
``test_torch_wan_train.py``.
"""

import json
import os

import numpy as np
import pytest
import torch

from vap_tpu_torch import train as train_cli
from vap_tpu_torch.data.precomputation import write_precomputed
from vap_tpu_torch.models.random_init import build_random
from vap_tpu_torch.models.wan.config import WanMOTConfig
from vap_tpu_torch.models.wan.transformer_mot import WanTransformer3DMOTModel
from vap_tpu_torch.training.args import TrainingArgs
from vap_tpu_torch.training.lora import merge_lora_into_params
from vap_tpu_torch.training.trainer import SFTTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "examples", "training", "sft", "wan", "crush_smol_lora")
# the CLI's tiny Wan: 4 latent + 4 conditioning channels, text 8 wide, CLIP 6
TINY = dict(in_channels=8, out_channels=4)
LAT = (1, 2, 8, 8, 4)  # [1, F, H, W, C] channel-last, as WanSpec writes it


def _item(i, vap=False):
    rng = np.random.default_rng(i)

    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    cond = {"caption": f"clip {i}", "encoder_hidden_states": n(1, 7, 8),
            "encoder_hidden_states_image": n(1, 5, 6)}
    lat = {"latents": n(*LAT), "condition": n(*LAT)}
    if vap:
        cond.update(encoder_hidden_states_mot_ref=n(1, 7, 8),
                    encoder_hidden_states_image_mot_ref=n(1, 5, 6))
        lat.update(latents_mot_ref=n(*LAT), condition_mot_ref=n(*LAT))
    return cond, lat


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    root = tmp_path_factory.mktemp("wan_precomputed")
    plain, vap = str(root / "plain"), str(root / "vap")
    write_precomputed(plain, [_item(i) for i in range(3)])
    write_precomputed(vap, [_item(i, vap=True) for i in range(2)])
    return plain, vap


def _cli(cache, out, *extra):
    return train_cli.main([
        "--model_name", "wan", "--training_type", "lora", "--device", "cpu",
        "--model_config", "tiny", "--model_structure_config",
        os.path.join(RECIPE, "config_plain.json"), "--precomputation_dir", cache,
        "--output_dir", str(out), "--rank", "4", "--lora_alpha", "4",
        "--target_modules", "to_q to_k to_v to_out", "--flow_weighting_scheme", "logit_normal",
        "--lr", "1e-3", "--lr_scheduler", "constant", "--logging_steps", "1", *extra])


def test_wan_lora_cli_trains_two_steps_and_resumes(caches, tmp_path):
    """2 steps with a checkpoint, then a resumed run to 4 steps, against an
    uninterrupted 4-step run: the adapters, the optimizer count and the data
    position agree to the bit; only the adapters train and are saved."""
    plain, _ = caches
    first = _cli(plain, tmp_path / "part", "--train_steps", "2", "--checkpointing_steps", "2")
    model = first.model
    assert first.train_state.step == 2 and first.optimizer.count == 2
    assert first.step_cfg.remat == "full" and first.step_cfg.flow_weighting_scheme == "logit_normal"
    assert not any("_mot_ref" in n for n in model.state_dict())  # the plain structure
    assert first.lora_mode and len(first.lora) == 8 * model.config.num_layers
    assert first.trainable_names and all(n.endswith((".lora_A", ".lora_B"))
                                         for n in first.trainable_names)
    base = build_random(WanTransformer3DMOTModel, WanMOTConfig.tiny(
        **TINY, block_idx_with_mot_ref=()), "cpu", torch.float32, torch.Generator().manual_seed(42))
    for name, p in base.named_parameters():  # the frozen trunk did not move
        assert torch.equal(dict(model.named_parameters())[name], p), name
    assert all(r["grad_norm"] > 0 and np.isfinite(r["loss"]) for r in first.history)
    assert first.checkpointer.all_steps() == [2]
    saved = first.checkpointer.restore(2)
    assert set(saved["params"]) == set(first.trainable_names)

    whole = _cli(plain, tmp_path / "whole", "--train_steps", "4", "--checkpointing_steps", "100")
    resumed = _cli(plain, tmp_path / "part", "--train_steps", "4", "--checkpointing_steps", "2",
                   "--resume_from_checkpoint", "latest")
    assert resumed.train_state.step == 4 and resumed.optimizer.count == 4
    assert resumed.data_position == whole.data_position == 4
    for (name, p), q in zip(whole.model.named_parameters(), resumed.model.parameters()):
        assert torch.equal(p, q), name
    assert [r["loss"] for r in resumed.history] == [r["loss"] for r in whole.history[2:]]


def test_merged_params_bake_the_adapters_in(caches, tmp_path):
    plain, _ = caches
    trainer = _cli(plain, tmp_path, "--train_steps", "1", "--checkpointing_steps", "100")
    merged = trainer.merged_params()
    assert not any(k.endswith((".lora_A", ".lora_B")) for k in merged)
    name = next(iter(trainer.lora))
    module = trainer.model.get_submodule(name)
    torch.testing.assert_close(merged[f"{name}.weight"], module.merged_weight().detach())
    state = {k: v for k, v in trainer.model.state_dict().items()}
    assert merged.keys() == merge_lora_into_params(state, trainer.lora, 4.0, 4).keys()


def test_wan_expert_sft_trains_only_the_mot_branch(caches, tmp_path):
    """``--training_type video_as_prompt_mot`` on a tiny Wan VAP model and a
    VAP item: the MoT branch trains through ``wan_vap_loss``'s MoT branch,
    the trunk does not move."""
    _, vap = caches
    cfg = WanMOTConfig.tiny(**TINY)
    model = build_random(WanTransformer3DMOTModel, cfg, "cpu", torch.float32,
                         torch.Generator().manual_seed(0))
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer = SFTTrainer(TrainingArgs(
        model_name="wan", precomputation_dir=vap, output_dir=str(tmp_path), train_steps=2,
        lr=1e-3, lr_scheduler="constant", gradient_checkpointing=False, checkpointing_steps=100,
        flow_weighting_scheme="logit_normal"), model)
    trainer.run()
    assert trainer.optimizer.count == 2 and not trainer.lora_mode
    assert trainer.trainable_names and all("_mot_ref" in n for n in trainer.trainable_names)
    for name, p in model.named_parameters():
        if name not in trainer.trainable_names:
            assert torch.equal(p, start[name]), name
    assert any(not torch.equal(p, start[n]) for n, p in model.named_parameters())


@pytest.mark.parametrize("field,value,error", [
    ("model_name", "ltx_video", NotImplementedError), ("model_name", "sd3", ValueError),
    # control trains wan alone (and cogview4, not ported): not the default cogvideox
    ("training_type", "control", ValueError), ("training_type", "full", ValueError),
    ("flow_weighting_scheme", "bogus", ValueError)])
def test_args_reject_what_is_not_ported(field, value, error):
    with pytest.raises(error):
        TrainingArgs(**{field: value})


def test_structure_overrides_flat_and_nested(tmp_path):
    from vap_tpu_torch.train import structure_overrides

    with open(os.path.join(RECIPE, "config_plain.json")) as fh:
        nested = json.load(fh)
    assert structure_overrides(WanMOTConfig, nested) == {"block_idx_with_mot_ref": ()}
    flat = {"block_idx_with_mot_ref": [0, 10], "_class_name": "x", "num_layers": 12}
    assert structure_overrides(WanMOTConfig, flat) == {"block_idx_with_mot_ref": (0, 10),
                                                       "num_layers": 12}
    with pytest.raises(ValueError, match="model_config"):
        train_cli.main(["--model_name", "wan", "--device", "cpu", "--model_config",
                        "cogvideox_5b_i2v_vap", "--precomputation_dir", str(tmp_path)])
