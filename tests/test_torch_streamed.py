"""Streamed block offload in the port (``pipelines/streamed.py``) against the
resident pipelines and against JAX's streamed pipelines: the cases of
``tests/test_streamed_offload.py``.

The Wan transformer here has three blocks with MoT in 0 and 2, so its
segments (MoT, plain, MoT) split every chunk size into three chunks; the
other tiny models, the inputs and the JAX side are those of
``tests/test_torch_wan_pipeline.py`` and ``tests/test_torch_step_cache.py``
(JAX's initializers, carried over by ``convert``). On the CPU the chunks
are packed, staged into two slots and swapped in as on a card, with
synchronous copies, so a streamed run equals the resident one to the bit;
against JAX, float32 end to end, the tolerances of those files.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_step_cache import ATOL as COG_ATOL
from test_torch_step_cache import RTOL as COG_RTOL
from test_torch_step_cache import call_args as cog_args
from test_torch_step_cache import inject_jax_noise, make_pipelines
from test_torch_wan_pipeline import T_CFG, FakeTokenizer, _call_args, _jitter
from vap_tpu.models.text_encoders import clip_vision as jclip
from vap_tpu.models.text_encoders import t5 as jt5
from vap_tpu.models.wan import transformer_mot as jwan
from vap_tpu.models.wan import vae as jvae
from vap_tpu.models.wan.config import WanMOTConfig as JaxWanConfig
from vap_tpu.ops.schedulers import FlowMatchEulerScheduler as JaxFlowMatch
from vap_tpu.ops.schedulers import UniPCScheduler as JaxUniPC
from vap_tpu.pipelines import wan_i2v_mot as jpipe
from vap_tpu_torch import convert
from vap_tpu_torch.models.loading import build_on_meta
from vap_tpu_torch.models.text_encoders.clip_vision import CLIPVisionConfig, CLIPVisionModel
from vap_tpu_torch.models.text_encoders.t5 import T5Config, T5EncoderModel
from vap_tpu_torch.models.wan.config import WanMOTConfig
from vap_tpu_torch.models.wan.transformer_mot import WanTransformer3DMOTModel
from vap_tpu_torch.models.wan.vae import AutoencoderKLWan, WanVAEConfig
from vap_tpu_torch.ops.schedulers import FlowMatchEulerScheduler, UniPCScheduler
from vap_tpu_torch.pipelines import wan_i2v_mot as tpipe
from vap_tpu_torch.pipelines.streamed import PinnedBlocks, StreamedTransformer, block_chunks

# float32 end to end, as tests/test_torch_wan_pipeline.py holds the MoT call
WAN_ATOL, WAN_RTOL = 5e-5, 1e-5
WAN_LAYERS = dict(num_layers=3, block_idx_with_mot_ref=(0, 2))


def _wan_models(cfg_kw, init=jwan.init_wan_mot, seed=0):
    """The port's four Wan modules and the JAX params, from JAX's
    initializers (jittered, as the Wan pipeline fixture makes them)."""
    key = jax.random.PRNGKey(seed)
    t_cfg, jt_cfg = WanMOTConfig.tiny(**cfg_kw), JaxWanConfig.tiny(**cfg_kw)
    txt_cfg = T5Config.tiny(per_layer_relative_bias=True)
    jtxt_cfg = jt5.T5Config.tiny(per_layer_relative_bias=True)
    clip_cfg, jclip_cfg = CLIPVisionConfig.tiny(), jclip.CLIPVisionConfig.tiny()
    vae_cfg, jvae_cfg = WanVAEConfig.tiny(), jvae.WanVAEConfig.tiny()
    params = {
        "transformer": _jitter(init(key, jt_cfg), 0),
        "text_encoder": _jitter(jt5.init_t5_encoder(key, jtxt_cfg), 1),
        "image_encoder": _jitter(jclip.init_clip_vision(key, jclip_cfg), 2),
        "vae": _jitter(jax.jit(jvae.init_wan_vae, static_argnums=1)(key, jvae_cfg), 3),
    }
    modules = {}
    for name, cls, conv, cfg in (
            ("transformer", WanTransformer3DMOTModel, convert.from_jax_wan_transformer, t_cfg),
            ("text_encoder", T5EncoderModel, convert.from_jax_t5, txt_cfg),
            ("image_encoder", CLIPVisionModel, convert.from_jax_clip_vision, clip_cfg),
            ("vae", AutoencoderKLWan, convert.from_jax_wan_vae, vae_cfg)):
        modules[name] = cls(cfg)
        modules[name].load_state_dict(conv(params[name], cfg))
        modules[name].eval()
    jcfgs = dict(transformer_cfg=jt_cfg, vae_cfg=jvae_cfg, text_cfg=jtxt_cfg, clip_cfg=jclip_cfg)
    return modules, jax.tree.map(jnp.asarray, params), jcfgs


@pytest.fixture(scope="module")
def wan():
    """(port factory, JAX factory): each call builds a pipeline on its own
    copy of the transformer, so that packing one model's blocks leaves the
    others as they were."""
    modules, params, jcfgs = _wan_models(dict(T_CFG, **WAN_LAYERS))

    def port(scheduler=None, **kw):
        parts = dict(modules, transformer=copy.deepcopy(modules["transformer"]))
        return tpipe.WanVAPPipeline(**parts, tokenizer=FakeTokenizer(), dtype=torch.float32,
                                    device="cpu",
                                    scheduler=scheduler or FlowMatchEulerScheduler(shift=3.0),
                                    **kw)

    def ref(scheduler=None, **kw):
        return jpipe.WanVAPPipeline(**jcfgs, params=params, tokenizer=FakeTokenizer(),
                                    dtype=jnp.float32,
                                    scheduler=scheduler or JaxFlowMatch(shift=3.0), **kw)

    return port, ref


def _wan_run(pipe, steps=2, plain=False, jax_side=False, **extra):
    args, latents = _call_args()
    args.update(extra, num_inference_steps=steps, output_type="latent")
    if plain:
        args.update(ref_videos=None, prompt_mot_ref=None)
    if jax_side:
        return np.asarray(pipe(**args, latents=jnp.asarray(latents)))
    return pipe(**args, latents=torch.from_numpy(latents)).numpy()


def _runner(pipe):
    return pipe._streamed


def _streamed_copy(pipe, chunk):
    """``pipe`` on its own copy of the transformer, streamed ``chunk``
    blocks at a time."""
    return dataclasses.replace(pipe, transformer=copy.deepcopy(pipe.transformer),
                               offload_blocks_chunk=chunk, _staged=[], _pinned=None,
                               _streamed=None)


@pytest.mark.parametrize("chunk", [1, 2, 3])
def test_wan_streamed_equals_resident(wan, chunk):
    """The MoT denoise (FlowMatch, CFG 2) with the blocks streamed a chunk
    at a time equals the resident pipeline's to the bit, at chunk sizes 1,
    2 and the whole depth; never more than two chunks staged, one forward
    a step, every chunk's bytes copied each forward, and the non-block
    weights back in host memory after the call."""
    port, _ = wan
    resident = _wan_run(port())
    pipe = port(offload_blocks_chunk=chunk)
    streamed = _wan_run(pipe)
    np.testing.assert_array_equal(streamed, resident)
    runner = _runner(pipe)
    assert len(runner.chunks) == 3  # the segments (MoT, plain, MoT) split every chunk size
    assert runner.max_staged == 2 and runner.num_forwards == 2
    assert runner.bytes_copied == 2 * pipe._pinned.nbytes
    assert runner._resident is None and runner._slots is None  # released


def test_wan_streamed_matches_jax_streamed(wan):
    """The port's streamed MoT run against JAX's streamed pipeline
    (``offload_blocks_chunk=2``, its ``_denoise_streamed`` loop)."""
    port, ref = wan
    got = _wan_run(port(offload_blocks_chunk=2))
    want = _wan_run(ref(offload_blocks_chunk=2), jax_side=True)
    np.testing.assert_allclose(got, want, atol=WAN_ATOL, rtol=WAN_RTOL)


@pytest.fixture(scope="module")
def wan_plain():
    """A plain tiny Wan model (no MoT block, three blocks) for plain I2V."""
    modules, params, jcfgs = _wan_models(dict(T_CFG, num_layers=3, block_idx_with_mot_ref=()),
                                         jwan.init_wan)
    port = tpipe.WanVAPPipeline(**modules, tokenizer=FakeTokenizer(), dtype=torch.float32,
                                device="cpu", scheduler=UniPCScheduler(shift=3.0))
    ref = jpipe.WanVAPPipeline(**jcfgs, params=params, tokenizer=FakeTokenizer(),
                               dtype=jnp.float32, scheduler=JaxUniPC(shift=3.0),
                               offload_blocks_chunk=2)
    return port, ref


def test_wan_plain_unipc_streamed(wan_plain):
    """Plain (trunk-only) sampling under UniPC through the streamed path:
    bit-equal to the resident run, and against JAX's streamed pipeline."""
    port, ref = wan_plain
    resident = _wan_run(port, steps=3, plain=True)
    streamed_pipe = _streamed_copy(port, 2)
    streamed = _wan_run(streamed_pipe, steps=3, plain=True)
    np.testing.assert_array_equal(streamed, resident)
    assert _runner(streamed_pipe).num_forwards == 3
    want = _wan_run(ref, steps=3, plain=True, jax_side=True)
    np.testing.assert_allclose(streamed, want, atol=WAN_ATOL, rtol=WAN_RTOL)
    streamed_pipe.close_streamed()


def test_wan_streamed_step_cache(wan):
    """The step cache composes with streaming: a reuse step runs no
    forward, so streams nothing (``num_forwards``, ``bytes_copied``);
    adaptive:0 computes every step and equals the uncached streamed run."""
    port, _ = wan
    pipe = port(offload_blocks_chunk=1)
    base = _wan_run(pipe, steps=3)
    runner = _runner(pipe)
    assert runner.num_forwards == 3
    sparse = _wan_run(pipe, steps=3, step_cache="uniform:9:1:0")
    assert runner.num_forwards == 5 and pipe.stage_seconds["computed_steps"] == [0, 1]
    assert runner.bytes_copied == 5 * pipe._pinned.nbytes
    np.testing.assert_array_equal(sparse, _wan_run(port(), steps=3, step_cache="uniform:9:1:0"))
    ada = _wan_run(pipe, steps=3, step_cache="adaptive:0:1:0")
    assert runner.num_forwards == 8
    np.testing.assert_array_equal(ada, base)


def test_chunk_validation(wan):
    """chunk_blocks < 1 raises, directly and through a pipeline (a negative
    chunk is truthy, as in JAX; 0 and None run resident)."""
    cfg = WanMOTConfig.tiny(**WAN_LAYERS)
    with pytest.raises(ValueError, match="chunk_blocks"):
        block_chunks(cfg, 0)
    assert block_chunks(cfg, 2) == [[0], [1], [2]]
    assert block_chunks(WanMOTConfig.tiny(num_layers=5, block_idx_with_mot_ref=()), 2) == [
        [0, 1], [2, 3], [4]]
    port, _ = wan
    with pytest.raises(ValueError, match="chunk_blocks"):
        _wan_run(port(offload_blocks_chunk=-1))


def test_streamed_blocks_must_be_in_host_memory():
    """Blocks that are not in host memory (here on the meta device) are
    refused, not copied."""
    model = build_on_meta(WanTransformer3DMOTModel, WanMOTConfig.tiny(), torch.float32)
    with pytest.raises(ValueError, match="host memory"):
        PinnedBlocks(model.blocks, block_chunks(model.config, 1), pin=False)


def test_close_streamed_lets_go_of_the_blocks(wan):
    """Streaming leaves every block tensor where it was, its values
    unchanged; after ``close_streamed`` the store holds nothing and the
    runner refuses it; a block tensor replaced or written in place makes
    the pipeline build a new store; a resident call closes it first."""
    port, _ = wan
    pipe = port(offload_blocks_chunk=2)
    before = {k: (v.data_ptr(), v.clone()) for k, v in pipe.transformer.state_dict().items()}
    first = _wan_run(pipe)
    runner, store = _runner(pipe), pipe._pinned
    assert store.current() and not store.spans  # no page is locked on the CPU
    for k, v in pipe.transformer.state_dict().items():
        assert v.data_ptr() == before[k][0] and torch.equal(v, before[k][1]), k
    pipe.close_streamed()
    assert pipe._streamed is None and pipe._pinned is None and not store.current()
    with pytest.raises(RuntimeError, match="not the ones pinned"):
        runner(hidden_states_mot_ref=torch.zeros(1))
    np.testing.assert_array_equal(_wan_run(pipe), first)
    weight = pipe.transformer.blocks[1].ffn.net[2].weight
    with torch.no_grad():
        weight.data = weight.data.clone()  # as an in-place quantisation replaces tensors
    assert not pipe._pinned.current()
    np.testing.assert_array_equal(_wan_run(pipe), first)
    with torch.no_grad():
        weight.mul_(1.0)  # written in place (load_state_dict copies so)
    assert not pipe._pinned.current()
    np.testing.assert_array_equal(_wan_run(pipe), first)
    pipe.offload_blocks_chunk = None
    np.testing.assert_array_equal(_wan_run(pipe), first)  # a resident call closes the store
    assert pipe._pinned is None


@pytest.mark.parametrize("offset", [0, 100])
def test_pieces_fill_the_slot(offset):
    """A chunk's pieces (the whole pages inside each storage, the edges
    around them from the store's copy, whole tensors without a page of
    their own) fill a slot with every tensor's bytes, whatever the
    tensors' alignment; the edges are under two pages a tensor."""
    from vap_tpu_torch.pipelines import streamed

    flat = torch.randn(3 * 1024 * 1024 + offset)  # a storage two tensors share
    lin = torch.nn.Linear(8, 8)
    blocks = torch.nn.ModuleList([torch.nn.Module(), lin])
    blocks[0].a = torch.nn.Parameter(flat[offset:offset + 2 * 1024 * 1024].view(2048, 1024))
    blocks[0].b = torch.nn.Parameter(flat[-100:])
    store = streamed.PinnedBlocks(blocks, [[0, 1]], pin=False)
    slot = torch.full((store.slot_bytes,), 255, dtype=torch.uint8)
    store.copy_chunk(0, slot)
    views = store.views(0, slot)
    for t, view in views:
        assert torch.equal(view, t.data)
    assert store.edge_bytes <= 2 * 4096 + (100 + 8 * 8 + 8) * 4 + 5 * streamed._ALIGN
    assert store.nbytes == sum(t.numel() * t.element_size() for t, _ in views)
    assert blocks[0].a.data_ptr() == flat.data_ptr() + 4 * offset  # nothing moved
    store.close()
    assert store.layouts is None and not store.current()


def test_streamed_runner_serves_both_branch_modes(wan):
    """One runner per store serves the MoT call and the trunk-only call of
    the same model (the chunks are the store's, the slots the runner's):
    each equals its resident run to the bit, and the runner is kept until
    the store is built again (here, a block tensor replaced)."""
    port, _ = wan
    pipe = port(offload_blocks_chunk=3)
    runner = pipe.streamed_runner()
    assert isinstance(runner, StreamedTransformer)
    np.testing.assert_array_equal(_wan_run(pipe), _wan_run(port()))
    np.testing.assert_array_equal(_wan_run(pipe, plain=True), _wan_run(port(), plain=True))
    assert _runner(pipe) is runner and runner.num_forwards == 4
    weight = pipe.transformer.blocks[1].ffn.net[2].weight
    weight.data = weight.data.clone()
    assert pipe.streamed_runner() is not runner and not runner.store.current()
    pipe.close_streamed()


def _meta_bytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def test_streamed_14b_memory_budget():
    """The claim behind the feature (the reference's ~8 GB sequential
    offload), counted on the meta device as ``test_streamed_14b_memory_budget``
    counts it with jax.eval_shape: Wan-14B VAP in bf16, the resident part
    and the largest chunk equal to JAX's counts to the byte; two chunks of
    one block plus 4 GB of activations stay under 9 GB, two of two under
    13.6 GB, and two of four (the smoke's chunk) under half an 80 GB card."""
    cfg = WanMOTConfig.wan_14b_i2v_vap()
    model = build_on_meta(WanTransformer3DMOTModel, cfg, torch.bfloat16)
    blocks = list(model.blocks.parameters()) + list(model.blocks.buffers())
    block_ids = {id(t) for t in blocks}
    resident = _meta_bytes(t for t in list(model.parameters()) + list(model.buffers())
                           if id(t) not in block_ids)

    def chunk_bytes(chunk):
        return max(_meta_bytes(t for i in idx for t in model.blocks[i].parameters())
                   for idx in block_chunks(cfg, chunk))

    jcfg = JaxWanConfig.wan_14b_i2v_vap()
    shapes = jax.eval_shape(lambda k: jwan.init_wan_mot(k, jcfg, jnp.bfloat16),
                            jax.random.PRNGKey(0))

    def nbytes(tree):
        return sum(int(np.prod(x.shape)) * x.dtype.itemsize for x in jax.tree.leaves(tree))

    def jax_chunk_bytes(chunk):
        return max(sum(int(np.prod(x.shape[1:])) * min(chunk, x.shape[0]) * x.dtype.itemsize
                       for x in jax.tree.leaves(seg)) for seg in shapes["blocks"])

    assert resident == nbytes({k: v for k, v in shapes.items() if k != "blocks"})
    assert _meta_bytes(blocks) == nbytes(shapes["blocks"]) > 20e9
    assert resident < 1.5e9
    activations = 4e9
    for chunk, limit in ((1, 9e9), (2, 16e9 * 0.85), (4, 40e9)):
        assert chunk_bytes(chunk) == jax_chunk_bytes(chunk)
        peak = resident + 2 * chunk_bytes(chunk) + activations
        assert peak < limit, f"chunk {chunk}: peak {peak / 1e9:.1f} GB"


# ---------------------------------------------------------------------------
# CogVideoX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cog():
    """{"ddim": (port, jax), "dpm": (port, jax)} of the step cache tests."""
    return make_pipelines()


def _cog_run(pipe, steps=2, jax_side=False, **extra):
    args, latents = cog_args(steps)
    args.update(extra)
    if jax_side:
        return np.asarray(pipe(**args, latents=jnp.asarray(latents)))
    return pipe(**args, latents=torch.from_numpy(latents)).numpy()


@pytest.mark.parametrize("chunk", [1, 2, 3])
@pytest.mark.parametrize("single_branch", [False, True])
def test_cog_streamed_equals_resident(cog, chunk, single_branch):
    """The CogVideoX MoT denoise (DDIM, dynamic CFG) and the single-branch
    ablation (the trunk-only call) streamed equal the resident
    runs to the bit; the three blocks (MoT, MoT, plain) make two segments."""
    port, _ = cog["ddim"]
    pipe = _streamed_copy(port, chunk)
    got = _cog_run(pipe, ablation_single_branch=single_branch)
    np.testing.assert_array_equal(got, _cog_run(port, ablation_single_branch=single_branch))
    runner = _runner(pipe)
    assert [len(c) for c in runner.chunks] == {1: [1, 1, 1], 2: [2, 1], 3: [2, 1]}[chunk]
    assert runner.max_staged == min(2, len(runner.chunks)) and runner.num_forwards == 2


def test_cog_streamed_matches_jax_streamed(cog):
    """Against JAX's streamed CogVideoX pipeline, MoT and single-branch."""
    port, ref = cog["ddim"]
    pipe = _streamed_copy(port, 1)
    jax_pipe = dataclasses.replace(ref, offload_blocks_chunk=1)
    for single_branch in (False, True):
        got = _cog_run(pipe, ablation_single_branch=single_branch)
        want = _cog_run(jax_pipe, jax_side=True, ablation_single_branch=single_branch)
        np.testing.assert_allclose(got, want, atol=COG_ATOL, rtol=COG_RTOL)
    assert _runner(pipe).num_forwards == 4  # one runner for both branch modes


def test_cog_streamed_dpm_and_step_cache(cog):
    """DPM (its per-step noise is JAX's, fed to both sides) streamed at
    chunk 2 against the resident run (to the bit) and against JAX's
    streamed pipeline; the uniform cache under streaming runs 2 forwards
    over 3 steps."""
    port, ref = cog["dpm"]
    pipe = _streamed_copy(port, 2)
    inject_jax_noise(pipe, 3)
    got = _cog_run(pipe, steps=3)
    inject_jax_noise(port, 3)
    np.testing.assert_array_equal(got, _cog_run(port, steps=3))
    want = _cog_run(dataclasses.replace(ref, offload_blocks_chunk=2), steps=3, jax_side=True)
    np.testing.assert_allclose(got, want, atol=COG_ATOL, rtol=COG_RTOL)
    inject_jax_noise(pipe, 3)
    cached = _cog_run(pipe, steps=3, step_cache="uniform:9:1:0")
    assert _runner(pipe).num_forwards == 3 + 2 and np.isfinite(cached).all()
    assert pipe.stage_seconds["computed_steps"] == [0, 1]


def _write_pipeline(root, pipe, components):
    """``pipe``'s components as a diffusers-layout directory."""
    from torch_ckpt_util import write_component

    for name, class_name, file in components:
        module = getattr(pipe, name)
        write_component(root, name, module.state_dict(), module.config, class_name, file=file)


def test_build_pipeline_offload_blocks_chunk_implies_model_offload(tmp_path, wan, cog):
    """``build_pipeline(offload_blocks_chunk=k)`` puts every component in
    host memory (model offload) as JAX's does, and streams the denoise: one
    step's latents equal to the resident build's."""
    from test_torch_load_pipeline import _cog_args, _wan_args
    from vap_tpu_torch.infer import cog_vap, wan_vap

    model = "diffusion_pytorch_model"
    _write_pipeline(tmp_path / "cog", cog["ddim"][0],
                    (("transformer", "CogVideoXTransformer3DMOTModel", model),
                     ("vae", "AutoencoderKLCogVideoX", model), ("text_encoder", "T5EncoderModel", "model")))
    _write_pipeline(tmp_path / "wan", wan[0](),
                    (("transformer", "WanTransformer3DMOTModel", model),
                     ("vae", "AutoencoderKLWan", model), ("text_encoder", "UMT5EncoderModel", "model"),
                     ("image_encoder", "CLIPVisionModelWithProjection", "model")))
    for build, root, make_args in ((cog_vap.build_pipeline, "cog", _cog_args),
                                   (wan_vap.build_pipeline, "wan", _wan_args)):
        resident = build(str(tmp_path / root), "float32", tokenizer=FakeTokenizer(), device="cpu")
        pipe = build(str(tmp_path / root), "float32", tokenizer=FakeTokenizer(), device="cpu",
                     offload_blocks_chunk=1)
        assert pipe.enable_model_offload and pipe.offload_blocks_chunk == 1
        assert not resident.enable_model_offload and resident.offload_blocks_chunk is None
        args, latents = make_args()
        args.update(num_inference_steps=1, output_type="latent")
        got = pipe(**args, latents=torch.from_numpy(latents))
        assert torch.equal(got, resident(**args, latents=torch.from_numpy(latents)))
        assert _runner(pipe).num_forwards == 1
