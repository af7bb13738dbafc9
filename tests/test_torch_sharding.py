"""The CLI flags the released recipes pass, the memory account of the sharded
recipes, the profiling window and rank-aware logging of the port's trainer,
against the JAX package.

  * every script under ``examples/training/`` parses in the port's parser
    (``vap_tpu_torch.train._parser``), each field the port shares with JAX's
    ``TrainingArgs`` equal to JAX's ``parse_args``, field by field; the
    ported families' argument sets build ``TrainingArgs`` (the two HSDP
    recipes' 4 x 2 and 2 x 4 included); ``--tensor_degree 2`` raises;
  * the bytes a rank keeps at Wan-14B VAP HSDP 2 x 4 (the JAX report's
    structure, MoT in all 40 blocks): the port's FSDP2 layout against JAX's
    ``NamedSharding.shard_shape`` (``scripts/memory_check.py``), for the
    parameters, the trained parameters (gradients) and AdamW's two moments:
    equal once JAX's replicated leaves and FSDP2's padding of dim 0 are
    counted;
  * the profiling window traces the steps JAX's rule picks (the
    process-local steps ``profile_start_step`` to ``profile_start_step +
    profile_num_steps - 1``, stopping at the run's end) and refuses what
    JAX refuses;
  * rank 1 is silent below ERROR unless ``VAP_VERBOSE_LOGS`` is set.
"""

import dataclasses
import json
import logging
import os
import sys

import numpy as np
import pytest
import torch

from test_recipes import SCRIPTS, _extract_train_flags
from test_torch_trainer import _item
from vap_tpu.training.args import TrainingArgs as JaxTrainingArgs
from vap_tpu.training.args import parse_args as jax_parse_args
from vap_tpu_torch import train as train_cli
from vap_tpu_torch.data.precomputation import write_precomputed
from vap_tpu_torch.parallel.sharding import rank_numel
from vap_tpu_torch.scripts import memory_check
from vap_tpu_torch.training.args import MODEL_NAMES, TrainingArgs
from vap_tpu_torch.utils.logging import get_logger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ids = [os.path.relpath(p, REPO) for p in SCRIPTS]


def _port_args(argv):
    ns = vars(train_cli._parser().parse_args(argv))
    ns.pop("device"), ns.pop("model_config")
    return ns


@pytest.mark.parametrize("path", SCRIPTS, ids=ids)
def test_every_recipe_parses_as_jax_parses_it(path):
    argv = _extract_train_flags(path)
    got = _port_args(argv)
    want = jax_parse_args(argv)
    shared = {f.name for f in dataclasses.fields(JaxTrainingArgs)} & set(got)
    assert {"ref_videos_num", "ablation_single_encoder", "ablation_residual_addition",
            "transformer_dtype", "training_dataset_kind", "fsdp_degree", "profile_dir",
            "profile_start_step", "profile_num_steps"} <= shared
    for name in sorted(shared):
        assert got[name] == getattr(want, name), (name, got[name], getattr(want, name))
    if got["model_name"] in MODEL_NAMES:
        args = TrainingArgs(**got)
        assert args.world_size == got["data_degree"] * got["fsdp_degree"] * got["seq_degree"]
    else:  # a family the port does not train yet
        with pytest.raises(NotImplementedError, match="not ported"):
            TrainingArgs(**got)


def test_the_hsdp_recipes_and_the_ablations_build():
    """The 3-ref recipe (4 x 2, --ref_videos_num 10) and the Wan VAP expert
    SFT (2 x 4) make worlds of 8; the two ablation flags reach the
    CogVideoX structure; --tensor_degree 2 still raises."""
    by_name = {os.path.relpath(p, REPO): p for p in SCRIPTS}
    cog = TrainingArgs(**_port_args(_extract_train_flags(
        by_name["examples/training/sft/cogvideox/vap_mot/train_single_node_3ref.sh"])))
    assert (cog.data_degree, cog.fsdp_degree, cog.ref_videos_num, cog.world_size) == (4, 2, 10, 8)
    wan = TrainingArgs(**_port_args(_extract_train_flags(
        by_name["examples/training/sft/wan/vap_mot/train_single_node.sh"])))
    assert (wan.data_degree, wan.fsdp_degree, wan.world_size) == (2, 4, 8)
    for flag in ("ablation_single_encoder", "ablation_residual_addition"):
        args = TrainingArgs(**{flag: True})
        model = train_cli.build_transformer(args, "tiny", torch.device("cpu"))
        assert getattr(model.config, flag) is True
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        TrainingArgs(**_port_args(["--tensor_degree", "2"]))


# ---------------------------------------------------------------------------
# the memory account against JAX's shard shapes
# ---------------------------------------------------------------------------

FSDP = 4


@pytest.fixture(scope="module")
def jax_report():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from memory_check import wan14b_report

    return wan14b_report(data=2, fsdp=FSDP)


def _jax_elements(trees, specs, mesh):
    """(elements a rank holds, elements of the leaves kept whole on every
    rank, all elements) of JAX parameter trees shaped like ``specs`` (None
    where a leaf is not in the tree), as ``scripts/memory_check.py`` walks
    them."""
    import jax
    from jax.sharding import NamedSharding

    counts = {"rank": 0, "whole": 0, "total": 0}

    def add(leaf, spec):
        if leaf is None:
            return
        n = int(np.prod(leaf.shape))
        counts["rank"] += int(np.prod(NamedSharding(mesh, spec).shard_shape(leaf.shape)))
        counts["total"] += n
        if "fsdp" not in [a for part in spec if part for a in
                          (part if isinstance(part, tuple) else (part,))]:
            counts["whole"] += n

    for tree in trees:
        jax.tree.map(add, tree, specs, is_leaf=lambda x: x is None)
    return counts["rank"], counts["whole"], counts["total"]


def test_rank_bytes_match_jax_shard_shapes(jax_report):
    """Parameters, gradients and AdamW moments a rank keeps, the port's
    FSDP2 layout against JAX's shard shapes at (data 2, fsdp 4): the same
    elements in all; JAX cuts every leaf it shards exactly in 4 and keeps
    its replicated leaves (1-D biases and norms, the modulation tables)
    whole, where the port cuts every parameter's dim 0, padded to a
    multiple of 4; once both are counted, the bytes are equal."""
    _, mesh, _, _, _, (_, _, train_abs, frozen_abs, _, specs) = jax_report
    model = memory_check.model_on_meta("wan")
    port = memory_check.sharded_bytes(model, FSDP)
    everything = list(model.parameters())
    trained = [p for p in everything if p.requires_grad]
    for trees, params, key in (((train_abs, frozen_abs), everything, "params"),
                               ((train_abs,), trained, "grads")):
        rank, whole, total = _jax_elements(trees, specs, mesh)
        numel = sum(p.numel() for p in params)
        padded = sum(FSDP * rank_numel(p.shape, FSDP) - p.numel() for p in params)
        assert numel == total, key
        assert FSDP * (rank - whole) + whole == total, key  # JAX cuts its sharded leaves in 4
        assert FSDP * port[key] == 2 * (total + padded), key  # bf16: 2 bytes an element
        # the difference: JAX's whole leaves (3/4 of them more) and FSDP2's padding
        assert FSDP * (2 * rank - port[key]) == 2 * (3 * whole - padded), key
    assert memory_check.optimizer_bytes(model, "adamw", FSDP) == 2 * port["grads"]


def test_memory_account_of_the_recipes():
    """Both recipe meshes under every optimizer: the rows and totals are
    positive and the AdamW totals fit the H100's 80 GB."""
    for name in memory_check.RECIPES:
        rep = memory_check.account(name)
        assert all(v > 0 for v in rep["rows"].values()), rep["rows"]
        assert rep["total"]["adamw"] < rep["budget"], (name, rep["total"])
        assert rep["optimizer_state"]["adafactor"] < rep["optimizer_state"]["adamw"]


def test_optimizer_gathers_are_the_other_ranks_gradient_pieces():
    """The bytes a rank receives a step at Wan 2 x 4: the 8-bit Adam the
    other three ranks' pieces of every trained gradient (3x its own
    gradient shards), Adafactor those and one float32 a row of each
    trained parameter, AdamW none; FSDP2's all-gathers twice the other
    ranks' pieces of every parameter; at fsdp 1 nothing."""
    model = memory_check.model_on_meta("wan")
    port = memory_check.sharded_bytes(model, FSDP)
    rows = sum((FSDP - 1) * -(-p.shape[0] // FSDP) * 4
               for p in model.parameters() if p.requires_grad)
    want = {"adamw": 0, "adamw-8bit": (FSDP - 1) * port["grads"],
            "adafactor": (FSDP - 1) * port["grads"] + rows}
    for name, moved in want.items():
        got = memory_check.gather_bytes(model, name, FSDP)
        assert got == {"fsdp_all_gathers": 2 * (FSDP - 1) * port["params"],
                       "optimizer_gathers": moved}, name
        assert memory_check.gather_bytes(model, name, 1) == {"fsdp_all_gathers": 0,
                                                             "optimizer_gathers": 0}, name


# ---------------------------------------------------------------------------
# the profiling window
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("profile_cache"))
    write_precomputed(root, [_item(i) for i in range(2)])
    return root


def _traced_steps(trace_dir):
    path = os.path.join(trace_dir, "trace_rank0.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted({int(e["name"].split()[-1]) for e in events
                   if e.get("name", "").startswith("train_step ")})


def _run(cache, out, **kw):
    args = ["--precomputation_dir", cache, "--output_dir", str(out), "--device", "cpu",
            "--model_config", "tiny", "--lr_scheduler", "constant", "--lr_warmup_steps", "0",
            "--checkpointing_steps", "100", "--profile_dir", str(out / "trace")]
    for k, v in kw.items():
        args += [f"--{k}", str(v)]
    return train_cli.main(args)


@pytest.mark.parametrize("steps,start,num,want", [
    (4, 2, 2, [2, 3]),      # JAX's window: steps start .. start + num - 1
    (3, 2, 3, [2, 3]),      # the run ends inside it: stopped and written at the end
    (2, 1, 1, [1]),
])
def test_profile_window_traces_jaxs_steps(cache, tmp_path, steps, start, num, want):
    trainer = _run(cache, tmp_path, train_steps=steps, profile_start_step=start,
                   profile_num_steps=num)
    assert _traced_steps(tmp_path / "trace") == want
    assert trainer.profile is not None and trainer._profiler is None


def test_profile_window_is_keyed_on_the_process_local_step(cache, tmp_path):
    """A run resumed at step 2 traces its own second step (global step 4),
    as JAX's window does."""
    _run(cache, tmp_path, train_steps=2, checkpointing_steps=2, profile_start_step=5)
    _run(cache, tmp_path, train_steps=4, resume_from_checkpoint="latest",
         profile_start_step=2, profile_num_steps=1)
    assert _traced_steps(tmp_path / "trace") == [4]


def test_profile_window_that_never_opens_warns(cache, tmp_path, caplog):
    with caplog.at_level(logging.WARNING, logger="vap_tpu_torch.trainer"):
        trainer = _run(cache, tmp_path, train_steps=1, profile_start_step=2)
    assert trainer.profile is None and _traced_steps(tmp_path / "trace") is None
    assert any("no trace written" in r.getMessage() for r in caplog.records)


@pytest.mark.parametrize("kw", [dict(profile_num_steps=0), dict(profile_start_step=0)])
def test_profile_refusals_are_jaxs(kw, tmp_path):
    for cls in (TrainingArgs, JaxTrainingArgs):
        with pytest.raises(ValueError, match="profile_num_steps and profile_start_step"):
            args = cls(profile_dir=str(tmp_path), **kw)
            if cls is JaxTrainingArgs:
                args.validate()
    TrainingArgs(**kw)  # without --profile_dir nothing is checked, as in JAX


# ---------------------------------------------------------------------------
# rank-aware logging
# ---------------------------------------------------------------------------

class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.mark.parametrize("rank,verbose,want", [
    ("0", None, ["info", "error"]),
    ("1", None, ["error"]),
    ("1", "1", ["info", "error"]),
])
def test_rank_1_is_silent_unless_verbose(monkeypatch, rank, verbose, want):
    monkeypatch.setenv("RANK", rank)
    if verbose:
        monkeypatch.setenv("VAP_VERBOSE_LOGS", verbose)
    else:
        monkeypatch.delenv("VAP_VERBOSE_LOGS", raising=False)
    logger = get_logger("vap_tpu_torch.test_rank_logging")
    records = _Records()
    logger.addHandler(records)
    try:
        logger.info("info")
        logger.error("error")
    finally:
        logger.removeHandler(records)
    assert records.messages == want
