"""The Wan pipeline's other sampling modes in the port against the JAX
pipeline on the same weights and inputs: plain image-to-video (the trunk
alone, no reference) and text-to-video on a T2V-shaped model, UniPC with
and without CFG, the uniform and the adaptive step cache under FlowMatch
and under UniPC, the tiled and sliced decode; then the W8A8 Wan
transformer against JAX's ``quantize_transformer_linears`` tree.

The tiny models and inputs are those of ``tests/test_torch_wan_pipeline.py``
(two MoT blocks, 12-channel conditioning for the 4-channel tiny VAE, a
32x32 image, a 9-frame reference, guidance 5), its fixture imported from
there.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_wan_pipeline import FakeTokenizer, T_CFG, _call_args, _jitter, pipelines  # noqa: F401
from vap_tpu.models.common import quantize_transformer_linears as jax_quantize
from vap_tpu.models.wan import transformer_mot as jwan
from vap_tpu.models.wan import vae as jvae
from vap_tpu.models.wan.config import WanMOTConfig as JaxWanConfig
from vap_tpu.ops.schedulers import FlowMatchEulerScheduler as JaxFlowMatch
from vap_tpu.ops.schedulers import UniPCScheduler as JaxUniPC
from vap_tpu.pipelines import wan_i2v_mot as jpipe
from vap_tpu_torch import convert
from vap_tpu_torch.models import common as tcommon
from vap_tpu_torch.models.wan import vae as tvae
from vap_tpu_torch.models.wan.config import WanMOTConfig
from vap_tpu_torch.models.wan.transformer_mot import WanTransformer3DMOTModel
from vap_tpu_torch.ops.schedulers import FlowMatchEulerScheduler, UniPCScheduler
from vap_tpu_torch.pipelines import wan_i2v_mot as tpipe

# float32 end to end, as tests/test_torch_wan_pipeline.py holds the MoT call
ATOL, RTOL = 5e-5, 1e-5
SCHEDULERS = {"flow_match": (lambda: FlowMatchEulerScheduler(shift=3.0),
                             lambda: JaxFlowMatch(shift=3.0)),
              "unipc": (lambda: UniPCScheduler(shift=3.0), lambda: JaxUniPC(shift=3.0))}


def _run(port, ref, steps=3, output_type="latent", **extra):
    args, latents = _call_args()
    args.update(extra, num_inference_steps=steps)
    want = np.asarray(ref(**args, latents=jnp.asarray(latents), output_type=output_type))
    got = port(**args, latents=torch.from_numpy(latents), output_type=output_type)
    got = got.numpy() if output_type == "latent" else got
    assert got.shape == want.shape and np.isfinite(got).all()
    return got, want


def _port_latents(port, steps, **extra):
    args, latents = _call_args()
    args.update(extra, num_inference_steps=steps)
    return port(**args, latents=torch.from_numpy(latents), output_type="latent").numpy()


def _pair(pipelines, scheduler="flow_match", **kw):
    port, ref = pipelines
    make_port, make_ref = SCHEDULERS[scheduler]
    return port(scheduler=make_port(), **kw), dataclasses.replace(ref, scheduler=make_ref(), **kw)


def test_plain_i2v_matches_jax(pipelines):
    """No reference: the MoT model's trunk alone (its blocks' trunk halves),
    with the conditioning channels and the CLIP context of the image."""
    port, ref = _pair(pipelines)
    got, want = _run(port, ref, ref_videos=None, prompt_mot_ref=None)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert "image_encode" in port.stage_seconds


@pytest.fixture(scope="module")
def t2v_pipelines(pipelines):
    """A T2V-shaped plain model (in_channels = z_dim = 4, no image_dim, no
    MoT block) with the fixture's UMT5 and VAE."""
    port, ref = pipelines
    kw = dict(in_channels=4, out_channels=4, text_dim=T_CFG["text_dim"], image_dim=None,
              added_kv_proj_dim=None, block_idx_with_mot_ref=())
    t_cfg, jt_cfg = WanMOTConfig.tiny(**kw), JaxWanConfig.tiny(**kw)
    jparams = _jitter(jwan.init_wan(jax.random.PRNGKey(5), jt_cfg), 7)
    transformer = WanTransformer3DMOTModel(t_cfg).eval()
    transformer.load_state_dict(convert.from_jax_wan_transformer(jparams, t_cfg))
    p = port()
    t2v_port = tpipe.WanVAPPipeline(transformer, p.vae, p.text_encoder, p.image_encoder,
                                    FakeTokenizer(), dtype=torch.float32, device="cpu")
    t2v_ref = jpipe.WanVAPPipeline(
        transformer_cfg=jt_cfg, vae_cfg=ref.vae_cfg, text_cfg=ref.text_cfg, clip_cfg=None,
        params=dict(ref.params, transformer=jax.tree.map(jnp.asarray, jparams)),
        tokenizer=FakeTokenizer(), dtype=jnp.float32)
    return t2v_port, t2v_ref


@pytest.mark.parametrize("output_type", ["latent", "np"])
def test_t2v_matches_jax(t2v_pipelines, output_type):
    """image=None on a T2V model: no conditioning channels, no CLIP, no VAE
    encode; decoded."""
    port, ref = t2v_pipelines
    got, want = _run(port, ref, output_type=output_type, image=None, ref_videos=None,
                     prompt_mot_ref=None)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert "vae_encode" not in port.stage_seconds and "image_encode" not in port.stage_seconds


@pytest.mark.parametrize("guidance", [5.0, 1.0])
def test_unipc_matches_jax(pipelines, guidance):
    """UniPC over 4 steps (the corrector's first and second orders, the
    predictor's first order at both ends), with CFG and without (batch 1)."""
    port, ref = _pair(pipelines, "unipc")
    got, want = _run(port, ref, steps=4, guidance_scale=guidance)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    flow = _port_latents(_pair(pipelines)[0], steps=4, guidance_scale=guidance)
    assert np.abs(got - flow).max() > 1e-3  # not the Euler trajectory


def _relative_l1(port, steps):
    """The relative L1 change of the denoise inputs at steps 1 and 2 of an
    uncached run, recorded from the scheduler's calls."""
    inputs = []
    sched = port.scheduler

    class Recording(type(sched)):
        def step(self, model_output, sample, *rest):
            inputs.append(sample.clone())
            return super().step(model_output, sample, *rest)

    args, latents = _call_args()
    port.scheduler = Recording(shift=sched.shift)
    try:
        port(**dict(args, num_inference_steps=steps), latents=torch.from_numpy(latents),
             output_type="latent")
    finally:
        port.scheduler = sched
    return [((inputs[i] - inputs[i - 1]).abs().mean()
             / (inputs[i - 1].abs().mean() + 1e-8)).item() for i in (1, 2)]


@pytest.mark.parametrize("scheduler", ["flow_match", "unipc"])
@pytest.mark.parametrize("kind", ["uniform", "adaptive"])
def test_step_cache_matches_jax(pipelines, monkeypatch, scheduler, kind):
    """Over 4 steps with warmup 1 and cooldown 1: "uniform:2:1:1" computes
    steps 0, 1 and 3 and reuses step 1's raw CFG-batch prediction at step
    2; the adaptive cache, its threshold halfway between the uncached run's
    first relative change and the sum of its first two, computes 0, 2 and 3.
    The reuse step runs no transformer forward; UniPC's carry goes through
    it."""
    port, ref = _pair(pipelines, scheduler)
    if kind == "uniform":
        spec = "uniform:2:1:1"
    else:
        d1, d2 = _relative_l1(port, 4)
        spec = f"adaptive:{d1 + d2 / 2:.6g}:1:1"
    calls = []
    forward = port.transformer.forward

    def counting(*a, **kw):
        calls.append(1)
        return forward(*a, **kw)

    monkeypatch.setattr(port.transformer, "forward", counting)
    got, want = _run(port, ref, steps=4, step_cache=spec)
    want_steps = [0, 1, 3] if kind == "uniform" else [0, 2, 3]
    assert port.stage_seconds["computed_steps"] == want_steps and len(calls) == 3
    assert len(port.stage_seconds["denoise_steps"]) == 4
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    monkeypatch.undo()
    uncached = _port_latents(port, steps=4)
    assert np.abs(got - uncached).max() > 1e-4  # the reuse step changed the trajectory


def test_tiled_decode_matches_jax(pipelines):
    """Latents of 36 x 36 make a 2 x 2 grid of 32 x 32 tiles every 24,
    blended over 64 pixels and cropped to 192."""
    port, ref = pipelines
    vae = port().vae
    z = np.random.default_rng(8).standard_normal((1, 1, 36, 36, 4)).astype(np.float32)
    with torch.no_grad():
        got = tvae.wan_vae_decode_tiled(vae, torch.from_numpy(z)).numpy()
    want = np.asarray(jvae.wan_vae_decode_tiled(ref.params["vae"], ref.vae_cfg, jnp.asarray(z)))
    assert got.shape == want.shape == (1, 1, 288, 288, 3)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    with torch.no_grad():
        whole = tvae.wan_vae_decode_streamed(vae, torch.from_numpy(z)).numpy()
    assert np.abs(got - whole).max() > 1e-3  # the tiles are not the whole-frame decode


def test_tiled_and_sliced_pipeline_matches_jax(pipelines):
    port, ref = _pair(pipelines, enable_vae_tiling=True, enable_vae_slicing=True)
    got, want = _run(port, ref, steps=2, output_type="np")
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_sliced_decode_equals_the_batch(pipelines):
    port, _ = pipelines
    z = torch.from_numpy(np.random.default_rng(9).standard_normal((2, 2, 4, 4, 4)).astype(np.float32))
    with torch.no_grad():
        whole = port()._decode(z)
        parts = port(enable_vae_slicing=True)._decode(z)
    # the batch of two and the two slices run other conv algorithms in f32
    torch.testing.assert_close(parts, whole, atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------------------
# W8A8 on the Wan transformer
# ---------------------------------------------------------------------------

# widths that tile to K3's 128 (2 heads x 64, ffn 256, CLIP width 128), so
# the chunk form takes every projection, the image embedder's too
W8A8_CFG = dict(num_attention_heads=2, attention_head_dim=64, in_channels=12, out_channels=4,
                text_dim=32, image_dim=128, added_kv_proj_dim=128, ffn_dim=256, num_layers=1,
                block_idx_with_mot_ref=(0,))
JAX_LEAVES = {"to_q": "to_q", "to_k": "to_k", "to_v": "to_v", "to_out": "to_out.0",
              "net_0": "net.0.proj", "net_2": "net.2"}
# Each projection agrees with JAX's to 1 ulp on the same input (held below
# at 4 ulps of its largest output). Through the model an activation at a
# rounding boundary of its int8 code may land one code apart on the two
# sides, which moves that projection's outputs by s_x * s_w * |w_i8|, and
# the layers after it carry it on: 4.0e-3 here (max|ref| above 1), in
# both forms (the unquantised forwards agree to 1e-6). The limit is 1e-2;
# one scale out of place reads far above it.
PROJ_ULPS = 4
FWD_ATOL = 1e-2


@pytest.fixture(scope="module")
def w8a8_models():
    jcfg = JaxWanConfig.tiny(**W8A8_CFG)
    params = jax_quantize(jax.tree.map(jnp.asarray,
                                       _jitter(jwan.init_wan_mot(jax.random.PRNGKey(2), jcfg), 4)))
    cfg = WanMOTConfig.tiny(**W8A8_CFG)
    model = WanTransformer3DMOTModel(cfg).eval()
    names = tcommon.quantize_transformer_linears(model)
    model.load_state_dict(convert.from_jax_wan_transformer(jax.tree.map(np.asarray, params), cfg))
    return jcfg, params, model, names


def _int8_paths(node, path=()):
    """The paths of the W8A8 leaves of a JAX tree."""
    if isinstance(node, dict):
        if "w_i8" in node:
            yield path
            return
        for k, v in node.items():
            yield from _int8_paths(v, path + (k,))


def _jax_int8_names(params, cfg):
    """The port's module names of the JAX tree's W8A8 leaves, the block
    stacks unstacked."""
    out = set()
    for (start, length, _), seg in zip(cfg.mot_segments, params["blocks"]):
        for *mods, leaf in _int8_paths(seg):
            out |= {".".join([f"blocks.{start + i}", *mods, JAX_LEAVES[leaf]])
                    for i in range(length)}
    for key, sub in params.items():
        if key != "blocks":
            out |= {".".join([key, *mods, JAX_LEAVES[leaf]])
                    for *mods, leaf in _int8_paths(sub)}
    return out


def test_quantizes_the_projections_jax_does(w8a8_models):
    """Every branch's attn1, attn2 (to_q, to_k, to_v, to_out.0) and ffn
    (net.0.proj, net.2), and both image embedders' ff, as JAX's tree; not
    attn2's add_k_proj / add_v_proj."""
    jcfg, params, model, names = w8a8_models
    assert set(names) == _jax_int8_names(params, jcfg)
    assert len(names) == 2 * 10 + 2 * 2  # two branches of 4 + 4 + 2; two image embedders
    assert not any("add_k_proj" in n or "add_v_proj" in n for n in names)
    assert all(isinstance(model.get_submodule(n), tcommon.Int8Linear) for n in names)


def test_released_structure_projection_count():
    """WanMOTConfig.wan_14b_i2v_vap() on the meta device: 40 MoT blocks of
    two branches with 10 projections each, plus the two image embedders'
    two: 804 projections, 28.1 B of the model's 32.8 B weights."""
    with torch.device("meta"):
        model = WanTransformer3DMOTModel(WanMOTConfig.wan_14b_i2v_vap())
    shapes = {n: tuple(m.weight.shape) for n, m in model.named_modules()
              if isinstance(m, torch.nn.Linear) and tcommon.is_int8_projection(n)}
    names = tcommon.quantize_transformer_linears(model)
    assert set(names) == set(shapes)
    assert len(names) == 804 and sum(n.startswith("blocks.") for n in names) == 800
    assert sum(int(np.prod(s)) for s in shapes.values()) == 28_118_220_800


def _w8a8_inputs(cfg):
    rng = np.random.default_rng(11)
    b, f, hw = 2, 2, 8
    return dict(
        hidden_states=rng.standard_normal((b, f, hw, hw, cfg.in_channels), np.float32),
        timestep=np.array([999.0, 321.0], np.float32),
        encoder_hidden_states=rng.standard_normal((b, cfg.text_len, cfg.text_dim), np.float32),
        encoder_hidden_states_image=rng.standard_normal((b, 257, cfg.image_dim), np.float32),
        hidden_states_mot_ref=rng.standard_normal((b, f, hw, hw, cfg.in_channels), np.float32),
        timestep_mot_ref=np.ones((b, 1), np.float32),
        encoder_hidden_states_mot_ref=rng.standard_normal((b, cfg.text_len, cfg.text_dim),
                                                          np.float32),
        encoder_hidden_states_image_mot_ref=rng.standard_normal((b, 257, cfg.image_dim),
                                                                np.float32))


def _jax_linear(form):
    from vap_tpu.models.common import _int8_linear
    from vap_tpu.ops.int8_matmul import int8_linear_pallas

    return jax.jit(_int8_linear if form == "row" else int8_linear_pallas)


@pytest.mark.parametrize("form", ["row", "chunk"])
def test_w8a8_projections_match_jax(w8a8_models, form):
    """Every quantised projection of a forward, fed the port's own input,
    against JAX's linear on the same input (``_int8_linear``; in the chunk
    form ``int8_linear_pallas`` in interpret mode): within 4 ulps of the
    largest output, so the forward's difference below is the int8 codes'
    rounding boundaries, not a projection that computes otherwise."""
    _, _, model, names = w8a8_models
    tcommon.set_int8_act_scale(model, form)
    fn, worst, hooks = _jax_linear(form), [], []

    def check(mod, args, out):
        p = {"w_i8": jnp.asarray(mod.w_i8.numpy().T), "s_w": jnp.asarray(mod.s_w.numpy())}
        if mod.bias is not None:
            p["bias"] = jnp.asarray(mod.bias.numpy())
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(fn(p, jnp.asarray(args[0].numpy())))
        worst.append(np.abs(out.numpy() - want).max() / (np.abs(want).max() * 2.0 ** -23))

    for n in names:
        hooks.append(model.get_submodule(n).register_forward_hook(check))
    try:
        with torch.no_grad():
            model(**{k: torch.from_numpy(v) for k, v in _w8a8_inputs(model.config).items()},
                  num_mot_ref=1)
    finally:
        for h in hooks:
            h.remove()
    assert len(worst) == len(names) and max(worst) <= PROJ_ULPS, max(worst)


@pytest.mark.parametrize("form", ["row", "chunk"])
def test_w8a8_forward_matches_jax(w8a8_models, monkeypatch, form):
    """The row form against VAP_INT8_PALLAS=0 (XLA's _int8_linear), the
    chunk form (K3's plain version here) against VAP_INT8_PALLAS=1 in
    interpret mode; in the chunk form no projection falls to the row form.
    A planted fault, one feed-forward's scales rolled by a row, must break
    the limit."""
    from vap_tpu_torch.ops import int8_matmul as tint8

    jcfg, params, model, names = w8a8_models
    inputs = _w8a8_inputs(model.config)
    monkeypatch.setenv("VAP_INT8_PALLAS", "1" if form == "chunk" else "0")
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.jit(lambda x: jwan.wan_mot_forward(params, jcfg, **x, num_mot_ref=1)[0])(
            {k: jnp.asarray(v) for k, v in inputs.items()}))
    assert tcommon.set_int8_act_scale(model, form) == len(names)
    calls, launches = tcommon.int8_linear_row.calls, tint8.int8_linear_chunk.launches

    def forward():
        with torch.no_grad():
            return model(**{k: torch.from_numpy(v) for k, v in inputs.items()},
                         num_mot_ref=1).numpy()

    got = forward()
    assert tint8.int8_linear_chunk.launches == launches  # the plain version on the CPU
    assert tcommon.int8_linear_row.calls - calls == (len(names) if form == "row" else 0)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= FWD_ATOL, (err, np.abs(want).max())
    s_w = model.blocks[0].ffn.net[2].s_w
    saved = s_w.clone()
    s_w.copy_(saved.roll(1))
    try:
        fault = np.abs(forward() - want).max()
    finally:
        s_w.copy_(saved)
    assert fault > FWD_ATOL, fault
