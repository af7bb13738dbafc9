"""The port's exports, LoRA merge and MoT-from-base builders against the JAX
package's (``vap_tpu/training/checkpoint.py``, ``training/specs.py``), and
the trainer CLI started from a stock checkpoint against JAX's ``train.py``
builders.

* Full export: for the same weights (jittered JAX initializers, from a
  seed), the port's ``export_safetensors`` of the module's state dict and
  JAX's of its tree hold the same keys and the same bits, in f32 and bf16,
  for the CogVideoX MoT, Wan plain and MoT, and HunyuanVideo transformers.
* LoRA: the PEFT files of the two agree key for key and bit for bit, with
  the same ``lora_config`` (Wan's block prefix aside: the port writes the
  diffusers name ``blocks.<i>``, JAX ``transformer_blocks.<i>``, which no
  Wan checkpoint holds, so JAX's own merge refuses JAX's Wan file); each
  side's merge of either file gives the same state dict, to the bit.
* The MoT expert cloned from a stock checkpoint, fresh draws included.
* ``vap_tpu_torch.train`` with ``--pretrained_model_name_or_path`` on a
  tiny stock directory starts from JAX's ``_build_cogvideox`` /
  ``_build_wan`` transformer, and its ``export()`` writes what JAX's
  ``export_safetensors`` writes of the trained weights.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.torch import load_file

import train as jax_train
from torch_ckpt_util import init, jitter, wan_dir, write_component
from vap_tpu.models import hunyuan_video as jhy
from vap_tpu.models.cogvideox import CogVideoXMOTConfig as JaxCogConfig
from vap_tpu.models.cogvideox import init_cogvideox_mot
from vap_tpu.models.cogvideox import weights as jcog_w
from vap_tpu.models.cogvideox.vae import CogVideoXVAEConfig as JaxCogVAEConfig
from vap_tpu.models.common import quantize_transformer_linears as jax_quantize
from vap_tpu.models.text_encoders.clip_vision import CLIPVisionConfig as JaxCLIPConfig
from vap_tpu.models.text_encoders.t5 import T5Config as JaxT5Config
from vap_tpu.models.wan import transformer_mot as jwan
from vap_tpu.models.wan import weights as jwan_w
from vap_tpu.models.wan.config import WanMOTConfig as JaxWanConfig
from vap_tpu.models.wan.vae import WanVAEConfig as JaxWanVAEConfig
from vap_tpu.training import checkpoint as jckpt
from vap_tpu.training import specs as jspecs
from vap_tpu.training.args import TrainingArgs as JaxArgs
from vap_tpu.training.lora import init_lora as jax_init_lora
from vap_tpu_torch import convert
from vap_tpu_torch import train as train_cli
from vap_tpu_torch.data.precomputation import write_precomputed
from vap_tpu_torch.models.cogvideox.config import CogVideoXMOTConfig
from vap_tpu_torch.models.cogvideox.transformer_mot import CogVideoXTransformer3DMOTModel
from vap_tpu_torch.models.cogvideox.vae import CogVideoXVAEConfig
from vap_tpu_torch.models.common import quantize_transformer_linears
from vap_tpu_torch.models.hunyuan_video.config import HunyuanVideoConfig
from vap_tpu_torch.models.hunyuan_video.transformer import HunyuanVideoTransformer3DModel
from vap_tpu_torch.models.loading import load_model
from vap_tpu_torch.models.text_encoders.clip_vision import CLIPVisionConfig
from vap_tpu_torch.models.text_encoders.t5 import T5Config
from vap_tpu_torch.models.wan.config import WanMOTConfig
from vap_tpu_torch.models.wan.transformer_mot import WanTransformer3DMOTModel
from vap_tpu_torch.models.wan.vae import WanVAEConfig
from vap_tpu_torch.training import checkpoint as tckpt
from vap_tpu_torch.training import specs as tspecs
from vap_tpu_torch.training.args import TrainingArgs
from vap_tpu_torch.utils.safetensors import read_metadata

COG = dict(in_channels=8, out_channels=4, num_layers=3, block_idx_with_mot_ref=(0, 1),
           use_learned_positional_embeddings=True)
RANK, ALPHA = 4, 8.0

FAMILIES = {
    "cogvideox_mot": (init_cogvideox_mot, JaxCogConfig.tiny(**COG), CogVideoXTransformer3DMOTModel,
                      CogVideoXMOTConfig.tiny(**COG), convert.from_jax_transformer, True),
    "wan_plain": (jwan.init_wan, JaxWanConfig.tiny(block_idx_with_mot_ref=()),
                  WanTransformer3DMOTModel, WanMOTConfig.tiny(block_idx_with_mot_ref=()),
                  convert.from_jax_wan_transformer, False),
    "wan_mot": (jwan.init_wan_mot, JaxWanConfig.tiny(), WanTransformer3DMOTModel,
                WanMOTConfig.tiny(), convert.from_jax_wan_transformer, True),
    "hunyuan": (jhy.init_hunyuan_video, jhy.HunyuanVideoConfig.tiny(),
                HunyuanVideoTransformer3DModel, HunyuanVideoConfig.tiny(),
                convert.from_jax_hunyuan_transformer, False),
}


def _bits(t):
    return t.contiguous().reshape(-1).view(torch.uint8)


def _assert_files_equal(a, b, rename=lambda k: k):
    got, want = load_file(a), {rename(k): v for k, v in load_file(b).items()}
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(_bits(got[k]), _bits(want[k])), k


def _assert_dicts_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        w = want[k]
        w = torch.from_numpy(w.view(np.int16)).view(torch.bfloat16) if w.dtype == \
            ml_dtypes.bfloat16 else torch.from_numpy(np.asarray(w))
        g = got[k].detach()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert torch.equal(_bits(g), _bits(w)), k


def _np_dtype(tree, bf16):
    return jax.tree.map(lambda x: np.asarray(x).astype(ml_dtypes.bfloat16) if bf16 else x, tree)


@pytest.fixture(scope="module")
def trees():
    made = {}

    def get(name):
        if name not in made:
            jinit, jcfg = FAMILIES[name][:2]
            made[name] = init(jinit, jcfg, 3)
        return made[name]

    return get


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_full_export_matches_jax(trees, tmp_path, name, bf16):
    _, jcfg, cls, cfg, from_jax, _ = FAMILIES[name]
    params = trees(name)
    dtype = torch.bfloat16 if bf16 else torch.float32
    model = load_model(cls, cfg, from_jax(params, cfg), "cpu", dtype)
    ours, theirs = str(tmp_path / "port.safetensors"), str(tmp_path / "jax.safetensors")
    n = tckpt.export_safetensors(model.state_dict(), ours)
    jckpt.export_safetensors(_np_dtype(params, bf16), jcfg, theirs)
    assert n == os.path.getsize(ours)
    _assert_files_equal(ours, theirs)
    assert read_metadata(ours) == {"format": "pt"}


def test_w8a8_export_raises_in_both(trees, tmp_path):
    _, jcfg, cls, cfg, from_jax, _ = FAMILIES["cogvideox_mot"]
    params = trees("cogvideox_mot")
    model = load_model(cls, cfg, from_jax(params, cfg), "cpu", torch.bfloat16)
    quantize_transformer_linears(model)
    with pytest.raises(ValueError, match="W8A8"):
        tckpt.export_safetensors(model.state_dict(), str(tmp_path / "q.safetensors"))
    with pytest.raises(KeyError):  # JAX's flattener finds no float kernel
        jckpt.export_safetensors(jax_quantize(jax.tree.map(jnp.asarray, params)), jcfg,
                                 str(tmp_path / "j.safetensors"))


def _lora(name, trees):
    """JAX's adapter tree for the family (the expert's projections for the
    MoT models, every block projection otherwise), B jittered off zero."""
    mot = FAMILIES[name][5]
    lora = jax_init_lora(jax.random.PRNGKey(5), jax.tree.map(jnp.asarray, trees(name)),
                         rank=RANK, targets=("to_q", "to_k", "to_v", "to_out", "net_0"),
                         mot_only=mot)
    return jitter(lora, 11, scale=0.1)


def _wan_names(key):
    return key.replace("transformer.transformer_blocks.", "transformer.blocks.")


@pytest.fixture(scope="module")
def lora_files(trees, tmp_path_factory):
    made = {}

    def get(name):
        if name not in made:
            _, jcfg, _, cfg, _, _ = FAMILIES[name]
            d = tmp_path_factory.mktemp(f"lora_{name}")
            lora = _lora(name, trees)
            ours, theirs = str(d / "port.safetensors"), str(d / "jax.safetensors")
            tckpt.export_lora_safetensors(convert.from_jax_lora(lora, cfg), ours, rank=RANK,
                                          alpha=ALPHA)
            jckpt.export_lora_safetensors(lora, jcfg, theirs, rank=RANK, alpha=ALPHA)
            made[name] = ours, theirs
        return made[name]

    return get


@pytest.mark.parametrize("name", list(FAMILIES))
def test_lora_export_matches_jax(lora_files, name):
    ours, theirs = lora_files(name)
    _assert_files_equal(ours, theirs, _wan_names if name.startswith("wan") else lambda k: k)
    assert tckpt.load_lora_metadata(ours) == jckpt.load_lora_metadata(theirs)
    meta = tckpt.load_lora_metadata(ours)
    assert meta["r"] == RANK and meta["lora_alpha"] == ALPHA
    assert set(meta["target_modules"]) <= {"to_q", "to_k", "to_v", "to_out.0", "net.0.proj"}
    assert read_metadata(ours)["lora_config"] == read_metadata(theirs)["lora_config"]


@pytest.mark.parametrize("scale", [None, 0.7], ids=["alpha_over_r", "given"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_lora_merge_agrees_both_ways(trees, lora_files, name, bf16, scale):
    _, _, _, cfg, from_jax, _ = FAMILIES[name]
    base = {k: v.numpy() for k, v in from_jax(trees(name), cfg).items()}
    base_np = _np_dtype(base, bf16)
    base_t = {k: torch.from_numpy(v).to(torch.bfloat16 if bf16 else torch.float32)
              for k, v in base.items()}
    ours, theirs = lora_files(name)
    want = jckpt.merge_lora_into_state_dict(base_np, ours, scale)
    got = tckpt.merge_lora_into_state_dict(base_t, ours, scale)
    _assert_dicts_equal(got, want)
    changed = [k for k in base if not np.array_equal(np.asarray(want[k]), np.asarray(base_np[k]))]
    assert changed and all("lora" not in k for k in changed)
    if name.startswith("wan"):  # JAX's Wan names are in no Wan checkpoint
        for merge, sd in ((jckpt.merge_lora_into_state_dict, base_np),
                          (tckpt.merge_lora_into_state_dict, base_t)):
            with pytest.raises(KeyError, match="missing base weight"):
                merge(sd, theirs, scale)
        return
    _assert_dicts_equal(tckpt.merge_lora_into_state_dict(base_t, theirs, scale), want)
    _assert_dicts_equal(got, jckpt.merge_lora_into_state_dict(base_np, theirs, scale))


def test_lora_merge_errors_match_jax(trees, lora_files, tmp_path):
    _, _, _, cfg, from_jax, _ = FAMILIES["cogvideox_mot"]
    base = {k: v.numpy() for k, v in from_jax(trees("cogvideox_mot"), cfg).items()}
    ours, _ = lora_files("cogvideox_mot")
    short = {k: v for k, v in base.items() if "attn1_mot_ref.to_q" not in k}
    for merge, sd in ((jckpt.merge_lora_into_state_dict, short),
                      (tckpt.merge_lora_into_state_dict,
                       {k: torch.from_numpy(v) for k, v in short.items()})):
        with pytest.raises(KeyError, match="missing base weight"):
            merge(sd, ours)
    empty = str(tmp_path / "none.safetensors")
    tckpt.export_lora_safetensors({}, empty, rank=RANK, alpha=ALPHA)
    for merge in (jckpt.merge_lora_into_state_dict, tckpt.merge_lora_into_state_dict):
        with pytest.raises(ValueError, match="no '\\*.lora_A.weight' adapters"):
            merge({}, empty)


# ---------------------------------------------------------------------------
# the MoT expert from a stock checkpoint
# ---------------------------------------------------------------------------

STOCK_CASES = {
    "clone": dict(),
    "shape_mismatch": dict(num_attention_heads=3),  # every expert weight fresh
    "effects_and_refs": dict(supported_effect_types=("fx", "style"), num_ref_embeddings=2),
    "patch_mismatch": dict(in_channels=12),
}


@pytest.mark.parametrize("case", list(STOCK_CASES))
def test_cogvideox_mot_from_base_matches_jax(trees, case):
    base = {k: v.numpy() for k, v in
            convert.from_jax_transformer(trees("cogvideox_mot"), CogVideoXMOTConfig.tiny(**COG))
            .items() if "_mot_ref" not in k}
    if case == "clone":  # a finetuned expert key is kept as it is
        base["transformer_blocks.0.ff_mot_ref.net.2.bias"] = np.full(32, 7.0, np.float32)
    kw = dict(COG, **STOCK_CASES[case])
    jcfg, cfg = JaxCogConfig.tiny(**kw), CogVideoXMOTConfig.tiny(**kw)
    assert tspecs.expected_mot_ref_shapes(cfg) == jspecs.expected_mot_ref_shapes(jcfg)
    want = jspecs.build_mot_state_dict_from_base(base, jcfg, seed=7)
    got = tspecs.build_mot_state_dict_from_base({k: torch.from_numpy(v) for k, v in base.items()},
                                                cfg, seed=7)
    _assert_dicts_equal(got, want)
    assert len(want) > len(base)
    if case == "clone":
        assert got["transformer_blocks.0.ff_mot_ref.net.2.bias"][0] == 7.0
        # a clone is the base tensor itself, not a copy
        assert got["transformer_blocks.1.attn1_mot_ref.to_q.weight"] is \
            got["transformer_blocks.1.attn1.to_q.weight"]


def test_wan_mot_from_base_matches_jax(trees):
    jcfg, cfg = FAMILIES["wan_mot"][1], FAMILIES["wan_mot"][3]
    full = convert.from_jax_wan_transformer(trees("wan_mot"), cfg)
    base = {k: v.numpy() for k, v in full.items() if "_mot_ref" not in k}
    base["blocks.1.ffn_mot_ref.net.2.bias"] = np.full(32, 3.0, np.float32)  # kept
    want = jspecs.build_wan_mot_state_dict_from_base(base, jcfg)
    got = tspecs.build_wan_mot_state_dict_from_base(
        {k: torch.from_numpy(v) for k, v in base.items()}, cfg)
    _assert_dicts_equal(got, want)
    assert set(got) - {"patch_embedding_mot_ref.weight", "patch_embedding_mot_ref.bias"} \
        <= set(full) | {"blocks.1.ffn_mot_ref.net.2.bias"}


# ---------------------------------------------------------------------------
# the trainer CLI from a stock checkpoint
# ---------------------------------------------------------------------------

def _cog_stock(root):
    """A stock CogVideoX directory (no expert) whose transformer config.json
    names the tiny VAP structure, with tiny VAE and T5 components."""
    from vap_tpu.models.cogvideox.vae import init_cogvideox_vae
    from vap_tpu.models.text_encoders.t5 import init_t5_encoder

    t_cfg = CogVideoXMOTConfig.tiny(**COG)
    full = convert.from_jax_transformer(init(init_cogvideox_mot, JaxCogConfig.tiny(**COG), 1),
                                        t_cfg)
    write_component(root, "transformer", {k: v for k, v in full.items() if "_mot_ref" not in k},
                    t_cfg, "CogVideoXTransformer3DModel", shards=2)
    jvae = JaxCogVAEConfig.tiny()
    write_component(root, "vae", convert.from_jax_vae(init(init_cogvideox_vae, jvae, 2),
                                                      CogVideoXVAEConfig.tiny()),
                    CogVideoXVAEConfig.tiny(), "AutoencoderKLCogVideoX")
    jtxt = JaxT5Config.tiny(d_model=t_cfg.text_embed_dim)
    txt = T5Config.tiny(d_model=t_cfg.text_embed_dim)
    write_component(root, "text_encoder", convert.from_jax_t5(init(init_t5_encoder, jtxt, 3), txt),
                    txt, "T5EncoderModel", file="model")


WAN_TINY = dict(in_channels=8, out_channels=4)


def _wan_stock(root):
    t = WanMOTConfig.tiny(**WAN_TINY)
    wan_dir(root, t, JaxWanConfig.tiny(**WAN_TINY), WanVAEConfig.tiny(), JaxWanVAEConfig.tiny(),
            T5Config.tiny(d_model=t.text_dim, per_layer_relative_bias=True),
            JaxT5Config.tiny(d_model=t.text_dim, per_layer_relative_bias=True),
            CLIPVisionConfig.tiny(hidden_size=t.image_dim),
            JaxCLIPConfig.tiny(hidden_size=t.image_dim), seed=4, stock=True)


def _jax_transformer(family, root, structure, training_type):
    """The transformer tree of JAX's ``train.py`` builder for ``root``."""
    args = JaxArgs(model_name=family, training_type=training_type,
                   pretrained_model_name_or_path=str(root))
    build = {"cogvideox": jax_train._build_cogvideox, "wan": jax_train._build_wan}[family]
    spec = build(args, jax_train._sections(structure), jnp.float32)
    return jax.tree.map(np.asarray, spec.params["transformer"]), spec.transformer_cfg


def _cog_items():
    rng = np.random.default_rng(0)
    lat = (1, 3, 4, 8, 8)

    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return [({"encoder_hidden_states": n(1, 6, 8), "encoder_hidden_states_mot_ref": n(1, 6, 8)},
             {"latents": n(*lat), "image_latents": n(*lat), "latents_mot_ref": n(*lat),
              "image_latents_mot_ref": n(*lat)}) for _ in range(2)]


def _wan_items():
    rng = np.random.default_rng(1)
    lat = (1, 2, 8, 8, 4)

    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return [({"encoder_hidden_states": n(1, 7, 8), "encoder_hidden_states_image": n(1, 5, 6)},
             {"latents": n(*lat), "condition": n(*lat)}) for _ in range(2)]


CLI = {
    # family: stock writer, structure json, training type, JAX converter, cache items, flags
    "cogvideox": (_cog_stock, {"block_idx_with_mot_ref": [0, 1]}, "video_as_prompt_mot",
                  jcog_w.convert_cogvideox_mot_state_dict, _cog_items, ()),
    "wan": (_wan_stock, {"block_idx_with_mot_ref": []}, "lora",
            jwan_w.convert_wan_mot_state_dict, _wan_items,
            ("--rank", "4", "--lora_alpha", "8", "--target_modules", "to_q to_k to_v to_out",
             "--flow_weighting_scheme", "logit_normal")),
}


@pytest.mark.parametrize("family", list(CLI))
def test_cli_from_stock_checkpoint_matches_jax_and_exports(tmp_path, family):
    stock, structure, training_type, jconvert, items, flags = CLI[family]
    root = tmp_path / "stock"
    stock(root)
    structure_path = tmp_path / "structure.json"
    structure_path.write_text(json.dumps(structure))
    # the initial transformer: the port's build against JAX's train.py builder
    args = TrainingArgs(model_name=family, training_type=training_type,
                        pretrained_model_name_or_path=str(root),
                        model_structure_config=str(structure_path))
    model = train_cli.build_transformer(args, "tiny", torch.device("cpu"))
    jtree, jcfg = _jax_transformer(family, root, structure, training_type)
    cfg = model.config
    assert {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)} == \
        {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(cfg)}
    want = convert.from_jax_wan_transformer(jtree, cfg) if family == "wan" else \
        convert.from_jax_transformer(jtree, cfg)
    state = model.state_dict()
    if family == "cogvideox":
        assert set(state) == set(want) and any("_mot_ref" in k for k in state)
    for k, v in state.items():  # JAX's tree also carries the unused expert entries of a plain Wan
        assert torch.equal(v, want[k]), k

    # two steps through the CLI from the same directory, then its export
    cache = str(tmp_path / "cache")
    write_precomputed(cache, items())
    out = tmp_path / "out"
    trainer = train_cli.main([
        "--model_name", family, "--training_type", training_type, "--device", "cpu",
        "--model_config", "tiny", "--model_structure_config", str(structure_path),
        "--pretrained_model_name_or_path", str(root), "--precomputation_dir", cache,
        "--output_dir", str(out), "--train_steps", "2", "--lr", "1e-3", "--lr_scheduler",
        "constant", "--checkpointing_steps", "1000", "--no-gradient_checkpointing", *flags])
    path = out / "model_weights" / "000002" / "model.safetensors"
    merged = {k: v.numpy() for k, v in trainer.merged_params().items()}
    assert any(not np.array_equal(merged[k], want[k].numpy()) for k in merged)  # it trained
    if family == "wan":  # JAX's tree of a plain Wan carries the cloned expert embedders
        merged = jspecs.build_wan_mot_state_dict_from_base(merged, jcfg)
    theirs = str(tmp_path / "jax_export.safetensors")
    jckpt.export_safetensors(jconvert(merged, jcfg), jcfg, theirs)
    got = load_file(str(path))
    jax_flat = load_file(theirs)
    for k, v in got.items():
        assert torch.equal(v, jax_flat[k]), k
    # what only JAX writes: the plain model's unread copies of its embedders
    for k in set(jax_flat) - set(got):
        assert k.startswith(("patch_embedding_mot_ref.", "condition_embedder_mot_ref.")), k
        assert torch.equal(jax_flat[k], got[k.replace("_mot_ref", "", 1)]), k
    if training_type == "lora":
        peft = path.parent / "pytorch_lora_weights.safetensors"
        base = {k: v.numpy() for k, v in load_model(
            type(model), cfg, tckpt.load_safetensors(str(root / "transformer")), "cpu",
            torch.float32).state_dict().items()}
        fused = jckpt.merge_lora_into_state_dict(base, str(peft))
        assert tckpt.load_lora_metadata(str(peft))["r"] == 4
        for k, v in got.items():  # f32: the two products round apart by an ulp at most
            np.testing.assert_allclose(fused[k], v.numpy(), rtol=1e-6, atol=1e-7, err_msg=k)
