"""The port's DPO against the JAX package: the CogVideoX and Wan DPO steps,
the DPO dataset, the win / lose batch and the trainer from clips.

The steps run on one-block tiny transformers with MoT (CogVideoX as in
``test_torch_train_step.py``, Wan as in ``test_torch_wan_train.py``, weights
jittered by a numpy seed), float32, with one adapter tree on both sides: JAX's
``init_lora`` over the MoT expert's six projections (what JAX's DPO
``init_fn`` draws), its B drawn non-zero (a zero B would let a reference
pass that wrongly kept the adapters agree with JAX), carried over by
``convert.from_jax_lora``. The timesteps (sigmas) and noise of the pairs are
JAX's draws from ``jax.random.split(key)``, passed to the port. JAX runs
under the ``xla`` attention provider, the port under ``flash``, whose
wrappers run K1's and K5's (K4's and K6's) plain versions on CPU tensors.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_step import _batch as cog_batch
from test_torch_wan_train import _batch as wan_batch
from test_torch_wan_train import jitter
from torch_data_util import FakeTokenizer, write_clip, write_csv
from vap_tpu import native as jnative
from vap_tpu.data import dataset as jdataset
from vap_tpu.models.cogvideox import CogVideoXMOTConfig as JaxConfig
from vap_tpu.models.cogvideox import init_cogvideox_mot
from vap_tpu.models.wan import transformer_mot as jwan
from vap_tpu.models.wan.config import WanMOTConfig as JaxWanConfig
from vap_tpu.ops.attention import attention_provider
from vap_tpu.training import lora as jlora
from vap_tpu.training import optimizer as jopt
from vap_tpu.training import train_step as jts
from vap_tpu.training.trainer import _assemble_dpo_batch
from vap_tpu_torch import convert
from vap_tpu_torch import train as train_cli
from vap_tpu_torch.data import dataset as tdataset
from vap_tpu_torch.models.cogvideox.config import CogVideoXMOTConfig
from vap_tpu_torch.models.cogvideox.transformer_mot import CogVideoXTransformer3DMOTModel
from vap_tpu_torch.models.wan.config import WanMOTConfig
from vap_tpu_torch.models.wan.transformer_mot import WanTransformer3DMOTModel
from vap_tpu_torch.training import lora as tlora
from vap_tpu_torch.training import optimizer as topt
from vap_tpu_torch.training import train_step as tts
from vap_tpu_torch.training.args import TrainingArgs
from vap_tpu_torch.training.trainer import SFTTrainer, assemble_dpo_batch

RANK, ALPHA = 4, 8.0  # alpha / rank = 2
B_SCALE = 1.0  # the adapters' B: a seeded normal of this size
BETA = 500.0
# f32 on both sides; a per-sample loss (weight up to ~1e3) within 2e-5 of the
# largest; the DPO loss, model_diff and ref_diff come from 0.5 beta times
# differences of those losses, so their scale is 0.5 beta max|per-sample|
LOSS_RTOL = 2e-5
GRAD_RTOL = 1e-4  # grad_norm, relative
# one AdamW step (lr 1e-3) in f32 on both sides: an adapter entry near 1
# rounds at 1.2e-7
PARAM_ATOL = 1e-6
LR, WEIGHT_DECAY, MAX_GRAD_NORM = 1e-3, 1e-4, 1.0
# one block, MoT in it: JAX's compile of the step dominates the test's time
ONE_BLOCK = dict(in_channels=8, out_channels=4, num_layers=1, block_idx_with_mot_ref=(0,))


@pytest.fixture(autouse=True)
def cv2_on_both_sides(monkeypatch):
    """Both sides decode with cv2, so frames compare to the bit."""
    monkeypatch.setattr(jnative, "available", lambda: False)


def _jitter_b(lora, seed):
    """The adapter tree with every B a seeded normal of size B_SCALE."""
    rng = np.random.default_rng(seed)

    def leaf(ab):
        if ab is None:
            return None
        return {"A": np.asarray(ab["A"]),
                "B": B_SCALE * rng.standard_normal(np.shape(ab["B"])).astype(np.float32)}

    return jax.tree.map(leaf, lora, is_leaf=lambda x: x is None or (
        isinstance(x, dict) and set(x) == {"A", "B"}))


def _tx():
    return jopt.get_optimizer("adamw", jopt.get_lr_schedule("constant", LR),
                              weight_decay=WEIGHT_DECAY, max_grad_norm=MAX_GRAD_NORM)


# ---------------------------------------------------------------------------
# the two families' pieces: config, weights, batch, JAX's pair draws
# ---------------------------------------------------------------------------

def _pairs(batch_fn, seed, pairs):
    """A win / lose batch of ``pairs`` pairs: the conditioning shared, the
    lose latents their own; ``dpo_weight`` [pairs] not 1."""
    win = batch_fn(seed, pairs)
    rng = np.random.default_rng(seed + 100)
    win["latents_lose"] = rng.standard_normal(win["latents"].shape).astype(np.float32)
    win["dpo_weight"] = np.linspace(0.7, 1.3, pairs).astype(np.float32)
    return win


@functools.lru_cache(maxsize=None)
def _family(name):
    """(JAX step config, port step config, JAX params, port model class,
    batch fn of (seed, pairs), pair draws of (key, half shape))."""
    if name == "cogvideox":
        jcfg, cfg = JaxConfig.tiny(**ONE_BLOCK), CogVideoXMOTConfig.tiny(**ONE_BLOCK)
        params = jitter(init_cogvideox_mot(jax.random.PRNGKey(0), jcfg), 0)

        def draws(key, shape):
            k_t, k_n = jax.random.split(key)
            return {"timesteps": np.array(jax.random.randint(k_t, shape[:1], 0, 1000)),
                    "noise": np.array(jax.random.normal(k_n, shape, jnp.float32))}

        return (jts.TrainStepConfig(model=jcfg, remat=False),
                tts.TrainStepConfig(model=cfg, remat=False), params,
                CogVideoXTransformer3DMOTModel, lambda seed, b: cog_batch(seed, b), draws,
                convert.from_jax_transformer, cfg)
    jcfg, cfg = JaxWanConfig.tiny(**ONE_BLOCK), WanMOTConfig.tiny(**ONE_BLOCK)
    params = jitter(jwan.init_wan_mot(jax.random.PRNGKey(0), jcfg), 1)
    scheme = "logit_normal"

    def draws(key, shape):
        k_t, k_n = jax.random.split(key)
        return {"sigmas": np.array(jts.sample_flow_sigmas(k_t, shape[0], scheme=scheme)),
                "noise": np.array(jax.random.normal(k_n, shape, jnp.float32))}

    return (jts.WanTrainStepConfig(model=jcfg, flow_weighting_scheme=scheme, remat=False),
            tts.WanTrainStepConfig(model=cfg, flow_weighting_scheme=scheme, remat=False), params,
            WanTransformer3DMOTModel, lambda seed, b: wan_batch(cfg, seed, b), draws,
            convert.from_jax_wan_transformer, cfg)


PAIRS = {"cogvideox": 2, "wan": 1}


@functools.lru_cache(maxsize=None)
def _jax_reference(name):
    """JAX's DPO step on one win / lose batch (one jit): the step's metrics,
    the adapters after it, and the per-sample losses of the policy and of
    the base; with the batch, the key and the adapters it started from."""
    jstep_cfg, _, params, _, batch_fn, _, _, _ = _family(name)
    per_sample = jts._per_sample_weighted_mse if name == "cogvideox" else jts._wan_per_sample_mse
    factory = jts.make_dpo_step if name == "cogvideox" else jts.make_wan_dpo_step
    tx = _tx()
    _, step_fn = factory(jstep_cfg, tx, beta=BETA, lora_rank=RANK, lora_alpha=ALPHA)
    lora = _jitter_b(jlora.init_lora(jax.random.PRNGKey(5), params, rank=RANK, mot_only=True), 6)
    batch = _assemble_dpo_batch(_pairs(batch_fn, 11, PAIRS[name]))
    key = jax.random.PRNGKey(12)

    def run(lora, params, batch):
        policy = jlora.apply_lora(params, lora, alpha=ALPHA, rank=RANK)
        losses = (per_sample(jstep_cfg, policy, batch, key),
                  per_sample(jstep_cfg, params, batch, key))
        new, _, metrics = step_fn(lora, params, tx.init(lora), batch, key)
        return new, metrics, losses

    with attention_provider("xla"):  # read while tracing
        new, metrics, losses = jax.jit(run)(lora, params, {k: jnp.asarray(v)
                                                           for k, v in batch.items()})
    return {"new": jax.tree.map(np.asarray, new),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "losses": [np.asarray(x) for x in losses], "lora": lora, "batch": batch, "key": key}


def _port_model(name, lora):
    """The port's model with JAX's weights and the adapters installed;
    returns (model, adapter tree, optimizer)."""
    _, _, params, cls, _, _, conv, cfg = _family(name)
    model = cls(cfg)
    model.load_state_dict(conv(params, cfg))
    model.requires_grad_(False)
    tree = tlora.apply_lora(model, convert.from_jax_lora(lora, cfg), alpha=ALPHA, rank=RANK)
    opt = topt.get_optimizer("adamw", list(tlora.lora_parameters(tree)),
                             topt.get_lr_schedule("constant", LR), weight_decay=WEIGHT_DECAY,
                             max_grad_norm=MAX_GRAD_NORM)
    return model, tree, opt


@pytest.mark.parametrize("name", ["cogvideox", "wan"])
def test_dpo_step_matches_jax(name):
    """One DPO step on both sides: the per-sample losses of the policy and of
    the reference (the adapters bypassed), the loss, model_diff, ref_diff,
    grad_norm, and every adapter after the AdamW update."""
    ref = _jax_reference(name)
    _, step_cfg, _, _, _, draws_fn, _, cfg = _family(name)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in ref["batch"].items()}
    half = batch["latents"].shape[0] // 2
    draws = {k: torch.from_numpy(v) for k, v in
             draws_fn(ref["key"], (half,) + tuple(batch["latents"].shape[1:])).items()}
    model, tree, opt = _port_model(name, ref["lora"])
    step = tts.make_dpo_step(step_cfg, opt, name)
    metrics = step(model, batch, **draws)

    policy, base = ref["losses"]
    scale = float(np.abs(np.concatenate([policy, base])).max())
    np.testing.assert_allclose(metrics["policy_losses"].numpy(), policy, atol=LOSS_RTOL * scale,
                               rtol=0)
    np.testing.assert_allclose(metrics["ref_losses"].numpy(), base, atol=LOSS_RTOL * scale,
                               rtol=0)
    assert np.abs(policy - base).max() > 100 * LOSS_RTOL * scale  # the adapters count
    for k in ("model_diff", "ref_diff"):
        np.testing.assert_allclose(metrics[k].item(), ref["metrics"][k], atol=LOSS_RTOL * scale,
                                   rtol=0, err_msg=k)
    np.testing.assert_allclose(metrics["loss"].item(), ref["metrics"]["loss"],
                               atol=LOSS_RTOL * 0.5 * BETA * scale, rtol=0)
    np.testing.assert_allclose(metrics["grad_norm"].item(), ref["metrics"]["grad_norm"],
                               rtol=GRAD_RTOL)
    want = convert.from_jax_lora(ref["new"], cfg)
    assert tree.keys() == want.keys() and opt.count == 1
    for n, ab in tree.items():
        for k in ("A", "B"):
            np.testing.assert_allclose(ab[k].detach().numpy(), want[n][k].numpy(),
                                       atol=PARAM_ATOL, rtol=0, err_msg=f"{n}.{k}")


@pytest.mark.parametrize("name", ["cogvideox", "wan"])
def test_dpo_adapters_are_jaxs(name):
    """``install_dpo_lora`` adapts the linears JAX's DPO init adapts: the
    MoT expert's six projections, whatever --target_modules says."""
    _, _, params, cls, _, _, conv, cfg = _family(name)
    model = cls(cfg)
    tree = tts.install_dpo_lora(model, rank=RANK, alpha=ALPHA)
    want = convert.from_jax_lora(jlora.init_lora(jax.random.PRNGKey(0), params, rank=RANK,
                                                 mot_only=True), cfg)
    assert tree.keys() == want.keys() and all("_mot_ref" in n for n in tree)
    assert all(not ab["B"].any() for ab in tree.values())
    assert [n for n, p in model.named_parameters() if p.requires_grad] == [
        f"{n}.lora_{k}" for n in tree for k in "AB"]


def test_reference_pass_bypasses_the_adapters():
    """With the adapters bypassed the model is its base to the bit; with B
    = 0 the policy's per-sample losses equal the reference's to the bit (the
    first DPO step), and the loss is ln 2 mean(dpo_weight)."""
    _, step_cfg, params, cls, batch_fn, _, conv, cfg = _family("cogvideox")
    batch = {k: torch.from_numpy(np.asarray(v))
             for k, v in _assemble_dpo_batch(_pairs(batch_fn, 13, 2)).items()}
    base = cls(cfg)
    base.load_state_dict(conv(params, cfg))
    gen = torch.Generator().manual_seed(0)
    want = tts.cogvideox_per_sample_loss(base, step_cfg, batch, gen)
    model, tree, _ = _port_model("cogvideox", _jitter_b(
        jlora.init_lora(jax.random.PRNGKey(5), params, rank=RANK, mot_only=True), 6))
    with tlora.lora_bypassed(model):
        got = tts.cogvideox_per_sample_loss(model, step_cfg, batch,
                                            torch.Generator().manual_seed(0))
    assert torch.equal(got, want)
    assert not torch.equal(tts.cogvideox_per_sample_loss(
        model, step_cfg, batch, torch.Generator().manual_seed(0)), want)
    with torch.no_grad():
        for ab in tree.values():
            ab["B"].zero_()
    loss, metrics = tts.make_dpo_loss(tts.cogvideox_per_sample_loss)(
        model, step_cfg, batch, torch.Generator().manual_seed(0))
    assert torch.equal(metrics["policy_losses"], metrics["ref_losses"])
    assert torch.equal(metrics["ref_losses"], want)
    np.testing.assert_allclose(loss.item(), np.log(2) * batch["dpo_weight"].mean().item(),
                               rtol=1e-6)


def test_assemble_dpo_batch_matches_jax():
    """Win rows then lose rows; the shared conditioning repeated;
    dpo_weight one per pair."""
    _, _, _, _, batch_fn, _, _, _ = _family("cogvideox")
    pairs = _pairs(batch_fn, 14, 2)
    want = _assemble_dpo_batch(pairs)
    got = assemble_dpo_batch({k: torch.from_numpy(v) for k, v in pairs.items()})
    assert got.keys() == want.keys() and "latents_lose" not in got
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert got["latents"].shape[0] == 4 and got["dpo_weight"].shape == (2,)


# ---------------------------------------------------------------------------
# the DPO dataset
# ---------------------------------------------------------------------------

SCORES = [100, 100, 95, 92, 85, 40, 25, 10, 5, 3]


@pytest.fixture(scope="module")
def dpo_data(tmp_path_factory):
    """Ten clips of two kinds over the scores' bins, a test-split row (in
    the pools, not in the train rows) and a win / lose pair file."""
    root = tmp_path_factory.mktemp("dpo")
    rows = []
    for i, score in enumerate(SCORES):
        write_clip(root / f"v{i}.mp4", 40 + i)
        rows.append({"video_paths": f"v{i}.mp4", "tar_video_caption": f"clip {i} explodes",
                     "ref_video_paths": json.dumps([f"v{(i + 1) % len(SCORES)}.mp4"]),
                     "kind": "ab"[i % 2], "split": "test" if i == 9 else "train",
                     "reference_alignment_score": score})
    write_csv(root / "vap_data.csv", rows)
    write_csv(root / "pairs.csv", [
        dict(rows[i], win_video_paths=f"v{i}.mp4", lose_video_paths=f"v{i + 5}.mp4",
             dpo_weight=0.5 + i) for i in range(3)])
    return str(root)


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return set(a) == set(b) and all(_same(a[k], b[k]) for k in a)
    return type(a) is type(b) and a == b


DPO_KW = dict(mask_caption_ratio=0.3, seed=4, infinite=True, alignment_score_threshold=50.0)


def test_dpo_dataset_matches_jax(dpo_data):
    """Sample for sample over three epochs of the nine train rows (the first
    two at stage (90, 10), the third at (80, 30)), the pools over every
    split, the weights, the threshold forced to 0; then a resume from the
    state mid-stream."""
    got_ds = tdataset.VideoAsPromptDPODataset(dpo_data, **DPO_KW)
    want_ds = jdataset.VideoAsPromptDPODataset(dpo_data, **DPO_KW)
    assert len(got_ds) == len(want_ds) == 9  # the threshold is 0, the test row out
    assert got_ds.ref_pool_eq100 == want_ds.ref_pool_eq100
    assert got_ds.prob_by_path == want_ds.prob_by_path
    got_it, want_it = iter(got_ds), iter(want_ds)
    stages, samples = [], []
    for i in range(27):
        got, want = next(got_it), next(want_it)
        assert _same(got, want), i
        samples.append(got)
        stages.append(got_ds._current_stage()["pos_min"])
        if i == 13:
            state = json.loads(json.dumps(got_ds.state_dict()))
            rest = [next(got_it) for _ in range(3)]
            assert _same(rest, [next(want_it) for _ in range(3)])
    assert set(stages) == {90, 80}
    assert {s["caption"] == "" for s in samples} == {True, False}
    assert len({s["dpo_weight"] for s in samples}) > 1
    resumed = tdataset.VideoAsPromptDPODataset(dpo_data, **DPO_KW)
    resumed.load_state_dict(state)
    it = iter(resumed)
    assert _same([next(it) for _ in range(3)], rest)


def test_dpo_dataset_stages_weights_and_reference_pool(dpo_data):
    """The stage by epoch, the pair weight and the pools of JAX's, and the
    reference never the win or the lose."""
    got_ds = tdataset.VideoAsPromptDPODataset(dpo_data, **DPO_KW)
    want_ds = jdataset.VideoAsPromptDPODataset(dpo_data, **DPO_KW)
    for index in (0, 9, 17, 18, 40, 10 ** 6):
        got_ds._sample_index = want_ds._sample_index = index
        assert got_ds._current_stage() == want_ds._current_stage()
    for win, lose in (("v0.mp4", "v8.mp4"), ("v2.mp4", "v5.mp4"), ("v3.mp4", "v9.mp4")):
        assert got_ds._pair_weight(win, lose) == want_ds._pair_weight(win, lose)
    assert got_ds.pos_pools == want_ds.pos_pools and got_ds.neg_pools == want_ds.neg_pools
    assert "v9.mp4" in got_ds.neg_pools["b"][10]  # the test split's video is in a pool
    for row in got_ds.rows:
        pair = got_ds._construct_pair(row)
        if pair is not None:
            assert pair[2] not in pair[:2]


def test_dpo_dataset_cuts_to_48_before_the_shard(tmp_path):
    """50 train rows (16 or more): the global rows cut to 48, then each of
    two shards takes every other row, as in JAX."""
    rows = [{"video_paths": f"x{i}.mp4", "tar_video_caption": "c", "ref_video_paths": "[]",
             "kind": "a", "split": "train", "reference_alignment_score": i * 2}
            for i in range(50)]
    write_csv(tmp_path / "vap_data.csv", rows)
    for shard in (0, 1):
        kw = dict(shard_index=shard, num_shards=2)
        got = tdataset.VideoAsPromptDPODataset(str(tmp_path), **kw)
        want = jdataset.VideoAsPromptDPODataset(str(tmp_path), **kw)
        assert len(got) == len(want) == 24 and _same(got.rows, want.rows)


def test_dpo_dataset_explicit_pairs_match_jax(dpo_data):
    kw = dict(DPO_KW, meta_df_name="pairs.csv")
    got = tdataset.VideoAsPromptDPODataset(dpo_data, **kw)
    want = jdataset.VideoAsPromptDPODataset(dpo_data, **kw)
    assert got._explicit_pairs and len(got) == 3
    g, w = iter(got), iter(want)
    samples = [next(g) for _ in range(4)]
    assert _same(samples, [next(w) for _ in range(4)])
    assert sorted(s["dpo_weight"] for s in samples[:3]) == [0.5, 1.5, 2.5]
    assert samples[3]["dpo_weight"] == samples[0]["dpo_weight"]  # the second pass


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def _dpo_trainer(data, out, **kw):
    base = dict(data_root=data, output_dir=str(out), video_resolution_buckets=((9, 32, 32),),
                lr=1e-3, lr_scheduler="constant", lr_warmup_steps=0,
                gradient_checkpointing=False, logging_steps=1,
                checkpointing_steps=1000, seed=3, train_steps=2, dpo=True, rank=RANK,
                lora_alpha=int(ALPHA), mask_caption_ratio=0.0)
    base.update(kw)
    args = TrainingArgs(**base)
    model = train_cli.build_transformer(args, "tiny", torch.device("cpu"))
    spec = train_cli.build_spec(args, model, "tiny", {"tokenizer": FakeTokenizer()})
    return SFTTrainer(args, model, spec)


@pytest.fixture(scope="module")
def dpo_run(dpo_data, tmp_path_factory):
    """Three DPO steps from the clips; ``step_metrics`` keeps each step's
    loss metrics."""
    trainer = _dpo_trainer(dpo_data, tmp_path_factory.mktemp("dpo_run"), train_steps=3)
    grad, trainer.step_metrics = trainer._grad, []

    def kept(*args, **kw):
        trainer.step_metrics.append(grad(*args, **kw))
        return trainer.step_metrics[-1]

    trainer._grad = kept
    trainer.run()
    return trainer


def test_dpo_trainer_runs_from_clips(dpo_run):
    """Three steps from the clips: the adapters alone train, step 1 (B = 0)
    gives the reference's per-sample losses and loss ln 2 * dpo_weight,
    the record carries the reference pass's seconds."""
    assert dpo_run.train_state.step == 3 and dpo_run.optimizer.count == 3
    assert dpo_run.lora_mode and all("lora_" in n for n in dpo_run.trainable_names)
    assert dpo_run.trainable_names and all("_mot_ref" in n for n in dpo_run.trainable_names)
    first = dpo_run.history[0]
    assert {"reference_s", "forward_s", "backward_s", "update_s", "model_diff",
            "ref_diff"} <= first.keys()
    assert first["model_diff"] == first["ref_diff"]
    assert all(np.isfinite(r["loss"]) for r in dpo_run.history)
    assert dpo_run.history[-1]["model_diff"] != dpo_run.history[-1]["ref_diff"]
    assert dpo_run.last_metrics["policy_losses"].shape == (2,)


def test_dpo_trainer_first_step_is_ln2(dpo_data, dpo_run):
    """Step 1 (B = 0): the policy's per-sample losses are the reference's to
    the bit, and the loss is ln 2 times the pair's weight (the dataset's
    first sample's)."""
    trainer = dpo_run
    m = trainer.step_metrics[0]
    assert torch.equal(m["policy_losses"], m["ref_losses"])
    args = trainer.args
    weight = next(iter(tdataset.VideoAsPromptDPODataset(
        dpo_data, infinite=True, mask_caption_ratio=args.mask_caption_ratio,
        seed=args.seed)))["dpo_weight"]
    assert weight != 1.0
    np.testing.assert_allclose(trainer.history[0]["loss"], np.log(2) * weight, rtol=1e-6)


def test_dpo_resume_matches_uninterrupted_run(dpo_data, dpo_run, tmp_path):
    """Two steps and a checkpoint (adapters, AdamW, the dataset's state),
    then one more in a fresh trainer: the losses of the uninterrupted run."""
    first = _dpo_trainer(dpo_data, tmp_path, train_steps=2, checkpointing_steps=2)
    first.run()
    restored = first.checkpointer.restore(2)
    assert set(restored["params"]) == set(first.trainable_names)
    assert json.loads(restored["dataloader_state"])["sample_index"] >= 2
    resumed = _dpo_trainer(dpo_data, tmp_path, train_steps=3, checkpointing_steps=2,
                           resume_from_checkpoint="latest")
    resumed.run()
    losses = [r["loss"] for r in first.history + resumed.history]
    assert losses == [r["loss"] for r in dpo_run.history]
    assert resumed.optimizer.count == 3


def test_dpo_export_writes_both_files(dpo_run):
    """The merged weights and the PEFT adapters, as JAX's export writes
    them under DPO."""
    from vap_tpu_torch.training.checkpoint import load_lora_metadata, load_safetensors

    path = dpo_run.export()
    merged = load_safetensors(path)
    peft_path = os.path.join(os.path.dirname(path), "pytorch_lora_weights.safetensors")
    peft = load_safetensors(peft_path)
    assert load_lora_metadata(peft_path)["r"] == RANK
    assert not any("lora_" in k for k in merged)
    assert peft and all("lora_A" in k or "lora_B" in k for k in peft)
    name = next(iter(dpo_run.lora))
    live = dict(dpo_run.model.named_parameters())
    w = dpo_run.model.get_submodule(name).merged_weight().detach()
    torch.testing.assert_close(merged[f"{name}.weight"], w, atol=0, rtol=0)
    assert not torch.equal(merged[f"{name}.weight"], live[f"{name}.weight"].detach())


@pytest.mark.parametrize("kw,match", [
    (dict(gradient_accumulation_steps=2), "gradient accumulation is not supported with DPO"),
    (dict(enable_precomputation=True), "enable_precomputation is not supported with DPO"),
    (dict(model_name="hunyuan_video", training_type="lora"),
     "DPO is only defined for cogvideox/wan"),
])
def test_dpo_refusals_are_jaxs(dpo_data, tmp_path, kw, match):
    from types import SimpleNamespace

    args = TrainingArgs(data_root=dpo_data, output_dir=str(tmp_path), dpo=True, **kw)
    model = train_cli.build_transformer(args, "tiny", torch.device("cpu"))
    with pytest.raises(ValueError, match=match):
        SFTTrainer(args, model, SimpleNamespace(transformer=model, family=args.model_name))
    with pytest.raises(ValueError, match="DPO trains from data"):
        SFTTrainer(TrainingArgs(output_dir=str(tmp_path), precomputation_dir=str(tmp_path),
                                dpo=True), model)


def test_dpo_flags_and_training_types():
    """``--dpo`` and training_type dpo and sft are accepted; control* are
    accepted for wan (control is control_lora) and refused for cogvideox."""
    assert TrainingArgs(dpo=True).is_dpo and TrainingArgs(training_type="dpo").is_dpo
    assert not TrainingArgs(training_type="sft").is_dpo
    for tt in ("control", "control_lora", "control_full_finetune"):
        with pytest.raises(ValueError, match="control training supports"):
            TrainingArgs(training_type=tt)
        args = TrainingArgs(model_name="wan", training_type=tt)
        assert args.is_control and not args.is_dpo
        assert args.training_type == ("control_lora" if tt == "control" else tt)
    with pytest.raises(ValueError, match="unknown reference_train_mode"):
        TrainingArgs(reference_train_mode="bogus")
