"""The port's trainer from data on the CPU, against the JAX package.

The families' ``prepare_conditions`` / ``prepare_latents`` against JAX's
specs on the same tiny weights (float32, within 1e-4 of max|ref|), and the
CogVideoX spec's validation video against JAX's; the
precomputed cache written by one side and read by the other, and
``is_cached`` on a complete, a partial and a re-signed cache; then the
trainer (tiny CogVideoX VAP from 9x32x32 clips on disk): online against
precomputed (on disk and in memory), losses bit-equal; a resume from a
checkpoint against an uninterrupted run; the step-0 sample dump; the CLI.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_data_util import (FakeTokenizer, assert_close_to_scale, cogvideox_specs,
                             hunyuan_specs, vap_data_dir, wan_specs)
from vap_tpu.data import dataset as jdataset
from vap_tpu.data import precomputation as jpre
from vap_tpu.training import specs as jspecs
from vap_tpu_torch import train as train_cli
from vap_tpu_torch.data import dataset as tdataset
from vap_tpu_torch.data import precomputation as tpre
from vap_tpu_torch.models.hunyuan_video.vae import prepare_latents as hunyuan_prepare_latents
from vap_tpu_torch.training.args import TrainingArgs
from vap_tpu_torch.training.trainer import SFTTrainer


def _sample(seed, hw=(32, 32), refs=1, frames=9):
    rng = np.random.default_rng(seed)

    def clip():
        return rng.uniform(-1, 1, (frames,) + hw + (3,)).astype(np.float32)

    return {"video": clip(), "caption": "a cat jumps", "ref_videos": [clip() for _ in range(refs)],
            "caption_mot_ref": [f"explode it {i}" for i in range(refs)],
            "effect_types": ["fx"] * refs}


@pytest.fixture(scope="module")
def cog_specs():
    return cogvideox_specs()


@pytest.mark.parametrize("refs", [1, 2])
def test_cogvideox_prepare_matches_jax(cog_specs, refs):
    port, ref = cog_specs
    sample = _sample(refs, refs=refs)
    assert_close_to_scale(port.prepare_conditions(sample), ref.prepare_conditions(sample))
    assert_close_to_scale(port.prepare_latents(sample), ref.prepare_latents(sample))


@pytest.fixture(scope="module")
def wan_pair():
    return wan_specs()


@pytest.mark.parametrize("mode", ["i2v", "vap"])
def test_wan_prepare_matches_jax(wan_pair, mode):
    port, ref = wan_pair
    sample = _sample(5, refs=1 if mode == "vap" else 0)
    if mode == "i2v":
        sample = {"video": sample["video"], "caption": sample["caption"]}
    got_c, want_c = port.prepare_conditions(sample), ref.prepare_conditions(sample)
    assert ("encoder_hidden_states_image_mot_ref" in want_c) == (mode == "vap")
    assert_close_to_scale(got_c, want_c)
    got_l, want_l = port.prepare_latents(sample), ref.prepare_latents(sample)
    assert ("condition_mot_ref" in want_l) == (mode == "vap")
    assert_close_to_scale(got_l, want_l)


def test_hunyuan_prepare_matches_jax():
    """The conditions against JAX's; the latents are the VAE module's
    ``prepare_latents``, which ``test_torch_hunyuan_train.py`` holds against
    ``HunyuanVideoSpec.prepare_latents``."""
    port, ref = hunyuan_specs()
    sample = {"video": _sample(7, hw=(16, 16))["video"], "caption": "MODAL_DISSOLVE a vase"}
    assert_close_to_scale(port.prepare_conditions(sample), ref.prepare_conditions(sample))
    want = hunyuan_prepare_latents(port.vae, sample, torch.float32)
    got = port.prepare_latents(sample)
    assert set(got) == {"latents"} and np.array_equal(got["latents"], want["latents"])


def test_validation_video_matches_jax(cog_specs, data):
    """The spec's validation video against JAX's ``_cogvideox_validation``
    on the same weights, benchmark row and starting latents."""
    port, ref = cog_specs
    sample = next(iter(tdataset.VideoAsPromptValidationDataset(os.path.join(data,
                                                                            "benchmark.csv"))))
    latents = np.random.default_rng(0).standard_normal((1, 3, 4, 4, 4)).astype(np.float32)
    kw = dict(height=32, width=32, num_frames=9, num_inference_steps=2, seed=42)
    got = port.validation(sample, latents=torch.from_numpy(latents), **kw)
    want = np.asarray(jspecs._cogvideox_validation(ref, ref.params["transformer"], sample,
                                                   latents=jnp.asarray(latents), **kw))
    assert got.shape == want.shape == (9, 32, 32, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)
    # the same sample both datasets make from the benchmark CSV
    jsample = next(iter(jdataset.VideoAsPromptValidationDataset(os.path.join(data,
                                                                             "benchmark.csv"))))
    np.testing.assert_array_equal(jsample["image"], sample["image"])


# ---------------------------------------------------------------------------
# the cache, both ways
# ---------------------------------------------------------------------------

def _pairs(n=3):
    rng = np.random.default_rng(0)
    return [({"encoder_hidden_states": rng.standard_normal((1, 6, 8)).astype(np.float32),
              "effect_ids": np.asarray([i]), "caption": f"clip {i}"},
             {"latents": rng.standard_normal((1, 3, 4, 4, 4)).astype(np.float32)})
            for i in range(n)]


def _equal_pairs(got, want):
    assert len(got) == len(want)
    for (gc, gl), (wc, wl) in zip(got, want):
        for g, w in ((gc, wc), (gl, wl)):
            assert set(g) == set(w)
            for k in w:
                if isinstance(w[k], np.ndarray):
                    np.testing.assert_array_equal(g[k], w[k])
                else:
                    assert g[k] == w[k]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cache_is_shared_with_jax(tmp_path, writer):
    items = _pairs()
    sig = {"data_root": "d", "precomputation_items": 3}
    make = {"port": tpre.PrecomputedPreprocessor, "jax": jpre.PrecomputedPreprocessor}
    w = make[writer](str(tmp_path), signature=sig)
    assert w.precompute(iter(range(3)), lambda i: items[i][0], lambda i: items[i][1]) == 3
    reader = make["jax" if writer == "port" else "port"](str(tmp_path), signature=sig)
    assert reader.is_cached()
    if writer == "port":  # JAX's replay of the port's files
        assert len(reader) == 3
        _equal_pairs(list(reader), items)
    replay = tpre.PrecomputedReader(str(tmp_path))
    assert len(replay) == 3
    _equal_pairs([replay.item(i) for i in range(3)], items)


@pytest.mark.parametrize("state", ["complete", "partial", "resigned", "world"])
def test_is_cached_agrees_with_jax(tmp_path, state):
    items = _pairs()
    sig = {"data_root": "d"}
    tpre.PrecomputedPreprocessor(str(tmp_path), signature=sig).precompute(
        iter(range(3)), lambda i: items[i][0], lambda i: items[i][1])
    kw = {"signature": sig}
    if state == "partial":
        os.remove(os.path.join(tmp_path, "rank_0", "lat_000001.npz"))
    elif state == "resigned":
        kw["signature"] = {"data_root": "other"}
    elif state == "world":
        kw["world_size"] = 2
    got = tpre.PrecomputedPreprocessor(str(tmp_path), **kw).is_cached()
    assert got == jpre.PrecomputedPreprocessor(str(tmp_path), **kw).is_cached()
    assert got == (state == "complete")


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return vap_data_dir(str(tmp_path_factory.mktemp("vap")), n=4)


def _trainer(data, out, spec_seed=0, **kw):
    base = dict(data_root=data, output_dir=str(out), video_resolution_buckets=((9, 32, 32),),
                lr=1e-3, lr_scheduler="constant", gradient_checkpointing=False, logging_steps=1,
                checkpointing_steps=1000, seed=3, train_steps=3, mask_caption_ratio=0.5)
    base.update(kw)
    args = TrainingArgs(**base)
    model = train_cli.build_transformer(args, "tiny", torch.device("cpu"))
    spec = train_cli.build_spec(args, model, "tiny", {"tokenizer": FakeTokenizer()})
    return SFTTrainer(args, model, spec)


def _losses(trainer):
    return [r["loss"] for r in trainer.history]


@pytest.fixture(scope="module")
def online(data, tmp_path_factory):
    trainer = _trainer(data, tmp_path_factory.mktemp("online"), train_steps=4)
    trainer.run()
    return trainer


def test_online_run_trains_and_logs(online):
    assert online.train_state.step == 4 and online.optimizer.count == 4
    assert all(np.isfinite(_losses(online)))
    spans = {k for entry in online.tracker.history for k in entry if k.startswith("timing/")}
    assert spans == {"timing/prepare_conditions", "timing/prepare_latents", "timing/train_step"}
    assert [e["step"] for e in online.tracker.history] == [1, 2, 3, 4]
    # the step-0 sample dump (dump_training_sample, trainer.py:795)
    dump = os.path.join(online.args.output_dir, "training_samples")
    assert sorted(os.listdir(dump)) == ["0-caption.txt", "0-ref_0.mp4", "0-training_sample.mp4"]
    with open(os.path.join(dump, "0-caption.txt")) as f:
        assert len(f.read().splitlines()) == 2  # the caption and the reference's


@pytest.mark.parametrize("where", ["disk", "memory"])
def test_precomputed_run_equals_online(data, online, tmp_path, where):
    kw = dict(enable_precomputation=True, precomputation_items=2, train_steps=4)
    if where == "disk":
        kw.update(precomputation_dir=str(tmp_path / "cache"), precomputation_once=True)
    trainer = _trainer(data, tmp_path / "out", **kw)
    trainer.run()
    assert _losses(trainer) == _losses(online)  # bit-equal
    assert not trainer.spec.encoders() or all(
        p.device.type == "cpu" for m in trainer.spec.encoders().values() for p in m.parameters())
    if where == "disk":  # one epoch of the 4 rows, cached under this run's signature
        pre = tpre.PrecomputedPreprocessor(str(tmp_path / "cache"), signature=trainer._signature())
        assert pre.is_cached() and len(tpre.PrecomputedReader(str(tmp_path / "cache"))) == 4
        assert jpre.PrecomputedPreprocessor(str(tmp_path / "cache"),
                                            signature=trainer._signature()).is_cached()
        again = _trainer(data, tmp_path / "again", **kw)  # replays the cache, encodes nothing
        again.spec.prepare_latents = None
        again.run()
        assert _losses(again) == _losses(online)


def test_resume_matches_uninterrupted_run(data, online, tmp_path):
    """2 steps, a checkpoint, then 2 more in a fresh trainer: the same
    sample stream (the datasets' state, JSON, in the checkpoint) and the
    same losses as the uninterrupted run."""
    first = _trainer(data, tmp_path, train_steps=2, checkpointing_steps=2)
    first.run()
    restored = first.checkpointer.restore(2)
    state = json.loads(restored["dataloader_state"])
    assert state["sample_index"] == 2 and len(state["rng_state"][1]) == 625
    resumed = _trainer(data, tmp_path, train_steps=4, checkpointing_steps=2,
                       resume_from_checkpoint="latest")
    resumed.run()
    assert _losses(first) + _losses(resumed) == _losses(online)
    assert resumed.train_state.step == 4 and resumed.optimizer.count == 4


def test_dump_training_sample_matches_jax(tmp_path):
    """The step-0 dump writes what JAX's ``dump_training_sample`` writes:
    the same files, the same captions, the same decoded frames."""
    from types import SimpleNamespace

    from vap_tpu.training.trainer import SFTTrainer as JaxTrainer
    from vap_tpu_torch.data.video import load_video

    sample = _sample(11, refs=2)
    for side, cls in (("port", SFTTrainer), ("jax", JaxTrainer)):
        cls.dump_training_sample(SimpleNamespace(args=SimpleNamespace(
            output_dir=str(tmp_path / side))), sample)
    port, ref = tmp_path / "port" / "training_samples", tmp_path / "jax" / "training_samples"
    names = sorted(os.listdir(ref))
    assert sorted(os.listdir(port)) == names == [
        "0-caption.txt", "0-ref_0.mp4", "0-ref_1.mp4", "0-training_sample.mp4"]
    assert (port / "0-caption.txt").read_text() == (ref / "0-caption.txt").read_text()
    for name in names[1:]:
        np.testing.assert_array_equal(load_video(str(port / name))[0],
                                      load_video(str(ref / name))[0])


def test_trainer_without_spec_needs_a_cache(tmp_path):
    args = TrainingArgs(output_dir=str(tmp_path))
    model = train_cli.build_transformer(args, "tiny", torch.device("cpu"))
    with pytest.raises(ValueError, match="precomputed cache: set precomputation_dir"):
        SFTTrainer(args, model)


def test_cli_trains_from_data(data, tmp_path):
    trainer = train_cli.main(
        ["--data_root", data, "--output_dir", str(tmp_path), "--device", "cpu", "--model_config",
         "tiny", "--train_steps", "2", "--lr_scheduler", "constant", "--checkpointing_steps", "2",
         "--video_resolution_buckets", "9x32x32", "--no-gradient_checkpointing"],
        tokenizers={"tokenizer": FakeTokenizer()})
    assert trainer.train_state.step == 2 and trainer.spec.family == "cogvideox"
    assert os.path.exists(os.path.join(tmp_path, "model_weights", "000002", "model.safetensors"))


def test_cli_names_a_missing_tokenizer(data, tmp_path):
    with pytest.raises(FileNotFoundError, match="tokenizer"):
        train_cli.main(["--data_root", data, "--output_dir", str(tmp_path), "--device", "cpu",
                        "--model_config", "tiny", "--train_steps", "1"])


@pytest.mark.parametrize("family,checkpoint", [("cogvideox", True), ("wan", True), ("wan", False)])
def test_build_spec_refuses_random_encoders_for_a_real_run(tmp_path, family, checkpoint):
    """At the released structure a component the checkpoint lacks raises,
    and Wan's VAE is never random (JAX's ``_build_wan``); under ``tiny``
    each random encoder is logged."""
    base = tmp_path / "ckpt"
    (base / "vae").mkdir(parents=True)  # a component directory without safetensors
    args = TrainingArgs(model_name=family, output_dir=str(tmp_path),
                        pretrained_model_name_or_path=str(base) if checkpoint else None)
    model = train_cli.build_transformer(TrainingArgs(model_name=family), "tiny",
                                        torch.device("cpu"))
    with pytest.raises(FileNotFoundError, match="needs the vae weights"):
        train_cli.build_spec(args, model, None, {})


def test_build_spec_logs_each_random_encoder(caplog):
    args = TrainingArgs()
    model = train_cli.build_transformer(args, "tiny", torch.device("cpu"))
    with caplog.at_level("WARNING", logger="vap_tpu_torch.train"):
        train_cli.build_spec(args, model, "tiny", {"tokenizer": FakeTokenizer()})
    assert [r.getMessage().split()[1] for r in caplog.records] == ["vae", "text_encoder"]
