#!/usr/bin/env python3
"""Smoke run of the PyTorch port (vap_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. device: a CUDA device is required (no CPU fallback);
  2. build: one nvcc per vap_tpu_torch/csrc/*.cu, all started together, for
     sm_90a; ptxas's registers and spills per kernel;
  3. kernel parity: K1 (flash, D=64), K4 (flash, D=128) and K2 (sage, D=64
     and D=128) against their plain PyTorch versions in bf16, at unaligned
     shapes and at the main-path shapes (CogVideoX joint [1,48,35552,64];
     Wan joint [1,40,40560,128] and Wan cross [1,40,20280,128] x 512 and
     x 257 keys), each with a planted fault that must break the limit; the
     kernel's time, the plain version's, torch's SDPA flash backend's (a
     yardstick only, never called by the port) and the card's bound;
  4. CogVideoX, "flash": a small pipeline held against plain dense attention
     (with where its largest error sits and why), then CogVideoX-5B VAP at
     full width (42 blocks, MoT in 0-40, T5-XXL, the full VAE) at 49 frames
     of 480x720, random bf16 weights from a seed, through
     CogVideoXVAPPipeline.__call__, cut to 2 DDIM steps of the path's 50;
  5. CogVideoX, "sage": the same call with 1 step;
  6. Wan: a small pipeline on the card held against plain dense attention
     under flash and sage, then Wan2.1-I2V-14B VAP at full width (40 blocks,
     MoT in all 40, 40x128 heads, UMT5-XXL, CLIP ViT-H/14, the Wan VAE) at
     49 frames of 480x832, one reference, FlowMatch shift 3, guidance 5,
     random bf16 weights from a seed, through WanVAPPipeline.__call__ with
     model offload (one component on the card at a time), cut to 2 steps
     under flash and 1 under sage.

The last three lines are a JSON object with each kernel's launches in its
main-path run, its largest error against the plain version, and its times
and bound at its main-path shape; the card's name and power limit as
nvidia-smi gives them; and {"ok": true, "device": {...}}.
"""

import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
NUM_FRAMES = 49
STEPS = 2
HEIGHT, WIDTH = 480, 720
WAN_HEIGHT, WAN_WIDTH = 480, 832
WAN_STEPS = 2
PARITY_SHAPES = [(300, 200), (128, 257), (64, 77)]
MAIN_SHAPE = (1, 48, 35552, 64)  # B, H, S, D of one CogVideoX joint attention at 49f@480x720
# Wan at 49f@480x832: 13 latent frames of 30x52 tokens = 20,280 per branch
WAN_JOINT = (1, 40, 40560, 128)
WAN_CROSS = [(1, 40, 20280, 512, 128), (1, 40, 20280, 257, 128)]  # B, H, Sq, Skv, D
# kernel vs plain version, bf16 output, held as max|out - ref| / max|ref|:
# both round P to bf16, against different running maxima, which moves an
# output by about one bf16 ulp, at most 2^-7 of max|ref|. A planted fault
# (V rows rolled by one inside each 64-key tile) must read above the limit.
OUT_REL_TOL = 2e-2
LSE_ATOL = 1e-2
KV_TILE = 64  # keys per tile of the kernels
# small-pipeline check: final latents (max ~2) under the kernels vs the plain
# dense attention. bf16 activations through a few blocks and 2 steps, with
# the CFG difference amplified up to 7x; sage adds its int8 score error. A
# wrong layout or mask gives errors of order 1.
E2E_ATOL = {"flash": 0.1, "sage": 0.2}
# the small Wan pipeline: FlowMatch's first of 2 steps moves the latents by
# ~0.99 v with v = u + 5 (c - u), so one bf16 ulp of c (2^-6 at |c| in
# [2, 4)) moves a latent by ~0.08; the limit allows about three such flips
WAN_E2E_ATOL = {"flash": 0.25, "sage": 0.35}
# H100 SXM dense peaks (NVIDIA data sheet): the bound of each kernel
PEAK_BF16, PEAK_INT8, HBM_BYTES_PER_S = 989e12, 1979e12, 3.35e12


def log(msg):
    print(msg, flush=True)


def power_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def mem_total_gib():
    with open("/proc/meminfo") as fh:
        for line in fh:
            if line.startswith("MemTotal:"):
                return int(line.split()[1]) / 2**20
    return float("nan")


# ---------------------------------------------------------------------------
# random weights from a seed (the JAX package's initializers, in distribution)
# ---------------------------------------------------------------------------

def init_random_(model, gen):
    """The transformers' linears (and their patch convs, linears there) and
    CLIP's linears uniform +-1/sqrt(fan_in); T5's linears and the VAEs'
    convs normal * fan_in^-0.5; zero biases, unit norms, a normal embedding,
    a 0.02-normal T5 bias table and CLIP embeddings, normal/sqrt(dim)
    scale-shift tables."""
    import torch
    from torch import nn

    from vap_tpu_torch.models.cogvideox.transformer_mot import (CogVideoXTransformer3DMOTModel,
                                                                sincos_pos_embedding)
    from vap_tpu_torch.models.text_encoders.clip_vision import CLIPVisionModel
    from vap_tpu_torch.models.text_encoders.t5 import T5LayerNorm
    from vap_tpu_torch.models.wan.transformer_mot import RMSNorm, WanTransformer3DMOTModel
    from vap_tpu_torch.models.wan.vae import RMSNormVideo

    uniform = isinstance(model, (CogVideoXTransformer3DMOTModel, WanTransformer3DMOTModel,
                                 CLIPVisionModel))
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d, nn.Conv3d)):
                fan_in = mod.weight[0].numel()
                if uniform:
                    mod.weight.uniform_(-fan_in ** -0.5, fan_in ** -0.5, generator=gen)
                else:
                    mod.weight.normal_(generator=gen).mul_(fan_in ** -0.5)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
                if mod.weight is not None:
                    mod.weight.fill_(1.0)
                    mod.bias.zero_()
            elif isinstance(mod, (T5LayerNorm, RMSNorm)):
                mod.weight.fill_(1.0)
            elif isinstance(mod, RMSNormVideo):
                mod.gamma.fill_(1.0)
            elif isinstance(mod, nn.Embedding):
                mod.weight.normal_(generator=gen)
                if mod.weight.shape[0] < 1000:  # T5 bias tables, CLIP positions
                    mod.weight.mul_(0.02)
        for name, p in model.named_parameters():
            if "scale_shift_table" in name:
                p.normal_(generator=gen).div_(p.shape[-1] ** 0.5)
            elif name.endswith(("class_embedding", "embeddings.patch_embedding.weight")):
                p.normal_(generator=gen).mul_(0.02)
            elif name.endswith("pos_embed"):
                p.zero_()
        if isinstance(model, CogVideoXTransformer3DMOTModel):
            cfg = model.config
            frames = (cfg.sample_frames - 1) // cfg.temporal_compression_ratio + 1
            pos = torch.from_numpy(sincos_pos_embedding(cfg, cfg.sample_height,
                                                        cfg.sample_width, frames))
            for pe in (model.patch_embed, model.patch_embed_mot_ref):
                pe.pos_embedding.copy_(pos[None])
    return model


def build_random(cls, cfg, device, dtype, gen, host=False):
    """Construct on the meta device, allocate on ``device``, fill from
    ``gen``; with ``host``, move the weights to host memory afterwards."""
    import torch

    prev = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        with torch.device("meta"):
            model = cls(cfg)
    finally:
        torch.set_default_dtype(prev)
    model = init_random_(model.to_empty(device=device), gen).eval()
    return model.to("cpu") if host else model


class FakeTokenizer:
    """Deterministic character ids in the vocabulary, padded to max_length."""

    def __init__(self, vocab_size):
        self.vocab_size = vocab_size

    def __call__(self, texts, padding=None, max_length=226, truncation=True,
                 add_special_tokens=True, return_tensors="np"):
        import numpy as np

        ids = np.zeros((len(texts), max_length), np.int64)
        for i, t in enumerate(texts):
            for j, ch in enumerate(t[:max_length]):
                ids[i, j] = (ord(ch) * 7 + j) % (self.vocab_size - 1) + 1
        return {"input_ids": ids, "attention_mask": (ids > 0).astype(np.int64)}


def decoded_frames(latent_frames, frame_batch=2):
    """Frames the CogVideoX decoder gives for a latent count: an odd chunk
    keeps its first frame and upsamples the rest 4x; an even one 4x."""
    n = max(latent_frames // frame_batch, 1)
    rem = latent_frames % frame_batch
    sizes = [frame_batch + rem] + [frame_batch] * (n - 1)
    return sum(1 + 4 * (c - 1) if c % 2 else 4 * c for c in sizes)


def n_params(module):
    return sum(p.numel() for p in module.parameters())


# ---------------------------------------------------------------------------
# phase 3: kernel parity and times
# ---------------------------------------------------------------------------

def time_ms(fn, iters, warmup=1):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(kind, b, h, sq, skv, d):
    """(ms, "operations" or "bytes"): the least time an H100 could take for
    the kernel's function on these shapes. Operations: 4*B*H*Sq*Skv*D
    (QK^T and PV), all at the bf16 peak for flash, the QK^T half at the int8
    peak for sage. Bytes: q, k, v and out in bf16 and lse in f32, each moved
    once."""
    flops = 4 * b * h * sq * skv * d
    t_ops = flops / PEAK_BF16 if kind == "flash" else flops / 2 / PEAK_INT8 + flops / 2 / PEAK_BF16
    t_bytes = (2 * b * h * (2 * sq + 2 * skv) * d + 4 * b * h * sq) / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def kernel_specs():
    """The kernels of the main paths, each with its wrapper, plain version,
    launch counter, parity shapes and the main-path shape it is timed at."""
    from vap_tpu_torch.ops import flash_attention as fa

    flash = (fa.flash_attention_forward, fa.flash_attention_forward_plain)
    sage = (fa.flash_attention_int8_forward, fa.flash_attention_int8_forward_plain)
    d64 = [(1, 48, sq, skv, 64) for sq, skv in PARITY_SHAPES] + [MAIN_SHAPE[:3] + MAIN_SHAPE[2:]]
    d128 = ([(1, 40, sq, skv, 128) for sq, skv in PARITY_SHAPES] + [WAN_JOINT[:3] + WAN_JOINT[2:]]
            + WAN_CROSS)
    src = "vap_tpu_torch/csrc/"
    ref = "vap_tpu/ops/flash_attention.py:"
    return {
        "flash_fwd": dict(fns=flash, kind="flash", counter="launches", shapes=d64,
                          timed=MAIN_SHAPE, source=src + "flash_fwd.cu", replaces=ref + "479"),
        "flash_fwd_d128": dict(fns=flash, kind="flash", counter="launches_d128", shapes=d128,
                               timed=WAN_JOINT, source=src + "flash_fwd.cu", replaces=ref + "225"),
        "sage_fwd": dict(fns=sage, kind="sage", counter="launches", shapes=d64,
                         timed=MAIN_SHAPE, source=src + "sage_fwd.cu", replaces=ref + "816"),
        "sage_fwd_d128": dict(fns=sage, kind="sage", counter="launches", shapes=d128,
                              timed=WAN_JOINT, source=src + "sage_fwd.cu", replaces=ref + "816"),
    }


def kernel_parity(dev):
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def qkv(b, h, sq, skv, d):
        return [torch.randn((b, h, s, d), generator=gen, device=dev).to(torch.bfloat16)
                for s in (sq, skv, skv)]

    def rolled_in_tiles(v):
        """v with its rows rolled by one inside every full kv tile."""
        n = v.shape[2] // KV_TILE * KV_TILE
        tiles = v[:, :, :n].unflatten(2, (-1, KV_TILE)).roll(1, dims=3).flatten(2, 3)
        return torch.cat([tiles, v[:, :, n:]], dim=2)

    def compare(name, kernel, plain, q, k, v):
        out, lse = kernel(q, k, v)
        torch.cuda.synchronize()
        ref_out, ref_lse = plain(q, k, v)
        ref_max = ref_out.float().abs().max().item()
        err = (out.float() - ref_out.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        finite = bool(torch.isfinite(out).all() and torch.isfinite(lse).all())
        fault = (kernel(q, k, rolled_in_tiles(v))[0].float() - ref_out.float()).abs().max().item()
        log(f"  {name} {tuple(q.shape)} x {k.shape[2]}: out max|err| {err:.3e}, "
            f"/ max|ref| {ref_max:.3e} = {err / ref_max:.3e} (tol {OUT_REL_TOL}; planted fault "
            f"{fault / ref_max:.3e}), lse max|err| {lse_err:.3e} (tol {LSE_ATOL}), finite {finite}")
        if not (finite and err <= OUT_REL_TOL * ref_max and lse_err <= LSE_ATOL):
            raise AssertionError(f"{name} disagrees with its plain version")
        if fault <= OUT_REL_TOL * ref_max:
            raise AssertionError(f"{name}: the out limit does not catch V rows out of place")
        return err

    results = {}
    for name, spec in kernel_specs().items():
        kernel, plain = spec["fns"]
        errs = []
        for b, h, sq, skv, d in spec["shapes"]:
            errs.append(compare(name, kernel, plain, *qkv(b, h, sq, skv, d)))
            torch.cuda.empty_cache()
        b, h, s, d = spec["timed"]
        q, k, v = qkv(b, h, s, s, d)
        ms = time_ms(lambda: kernel(q, k, v), iters=5, warmup=2)
        plain_ms = time_ms(lambda: plain(q, k, v), iters=1, warmup=1)
        library_ms = None
        if spec["kind"] == "flash":  # one PyTorch call with the same function: a yardstick
            with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                library_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters=5,
                                     warmup=2)
        bound_ms, bound_by = bound(spec["kind"], b, h, s, s, d)
        tflops = 4 * b * h * s * s * d / (ms * 1e-3) / 1e12
        log(f"  {name} at {spec['timed']}: kernel {ms:.3f} ms ({tflops:.1f} TFLOP/s), "
            f"plain {plain_ms:.3f} ms, SDPA flash {library_ms if library_ms is None else round(library_ms, 3)} ms, "
            f"bound {bound_ms:.3f} ms ({bound_by})")
        results[name] = {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
                         "shape": list(spec["timed"])}
        del q, k, v
        torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phases 4-5: CogVideoX
# ---------------------------------------------------------------------------

def small_pipeline_check(dev):
    """A small CogVideoX pipeline on the card: kernels vs the plain dense
    attention, with where the largest difference sits."""
    import numpy as np
    import torch

    from vap_tpu_torch.models.cogvideox.config import CogVideoXMOTConfig
    from vap_tpu_torch.models.cogvideox.transformer_mot import CogVideoXTransformer3DMOTModel
    from vap_tpu_torch.models.cogvideox.vae import AutoencoderKLCogVideoX, CogVideoXVAEConfig
    from vap_tpu_torch.models.text_encoders.t5 import T5Config, T5EncoderModel
    from vap_tpu_torch.ops import flash_attention as fa
    from vap_tpu_torch.ops.attention import attention_provider
    from vap_tpu_torch.pipelines.cogvideox_i2v_mot import (CogVideoXVAPPipeline,
                                                           dynamic_cfg_schedule)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf16 = torch.bfloat16
    t_cfg = CogVideoXMOTConfig.tiny(num_attention_heads=2, attention_head_dim=64, in_channels=8,
                                    out_channels=4, num_layers=3, block_idx_with_mot_ref=(0, 1),
                                    use_learned_positional_embeddings=True)
    txt_cfg = T5Config.tiny(d_model=t_cfg.text_embed_dim)
    pipe = CogVideoXVAPPipeline(
        build_random(CogVideoXTransformer3DMOTModel, t_cfg, dev, bf16, gen),
        build_random(AutoencoderKLCogVideoX, CogVideoXVAEConfig.tiny(), dev, bf16, gen),
        build_random(T5EncoderModel, txt_cfg, dev, bf16, gen),
        FakeTokenizer(txt_cfg.vocab_size), dtype=bf16, device=dev)
    rng = np.random.default_rng(SEED)
    args = dict(image=rng.uniform(-1, 1, (64, 64, 3)).astype(np.float32), prompt="a cat",
                ref_videos=[rng.uniform(-1, 1, (9, 64, 64, 3)).astype(np.float32)],
                prompt_mot_ref=["explode it"], height=64, width=64, num_frames=9,
                num_inference_steps=STEPS, max_sequence_length=t_cfg.max_text_seq_length,
                output_type="latent",
                latents=torch.from_numpy(rng.standard_normal((1, 3, 4, 8, 8)).astype(np.float32)))
    # The latents are quantised: the last DDIM step (v-prediction, a_t = 0)
    # gives x0 = sqrt(ab) x - sqrt(1 - ab) v with v = u + g (c - u), so one
    # bf16 ulp (2^-7 at |v| in [1, 2)) of the conditional prediction moves a
    # latent by 2^-7 * g * sqrt(1 - ab): the error quantum below.
    ts = pipe.scheduler.timesteps(STEPS).astype(np.float32)
    g_last = dynamic_cfg_schedule(ts, 6.0, STEPS)[-1]
    ab_last = pipe.scheduler.step_coefficients(STEPS)[2][-1]
    quantum = 2.0 ** -7 * float(g_last) * float(np.sqrt(1.0 - ab_last))
    with attention_provider("xla"):
        ref = pipe(**args)
    got = {}
    for provider, kernel in (("flash", fa.flash_attention_forward),
                             ("sage", fa.flash_attention_int8_forward)):
        before = kernel.launches
        with attention_provider(provider):
            got[provider] = pipe(**args)
        launched = kernel.launches - before
        diff = (got[provider] - ref).abs()
        err = diff.max().item()
        at = tuple(int(i) for i in np.unravel_index(int(diff.argmax()), diff.shape))
        log(f"  small pipeline, {provider} vs plain dense attention: final latents "
            f"max|err| {err:.6e} (tol {E2E_ATOL[provider]}) at [b, f, c, h, w] = {at}, "
            f"ref {ref[at].item():.6f}, got {got[provider][at].item():.6f}; "
            f"{err / quantum:.4f} quanta of {quantum:.6e}; {int((diff > 0).sum())} of "
            f"{diff.numel()} latents differ; max|ref| {ref.abs().max().item():.3f}, "
            f"{launched} launches")
        if launched != STEPS * t_cfg.num_layers:
            raise AssertionError(f"small pipeline under {provider}: {launched} kernel launches, "
                                 f"expected {STEPS * t_cfg.num_layers}")
        if not (torch.isfinite(got[provider]).all() and err <= E2E_ATOL[provider]):
            raise AssertionError(f"small pipeline under {provider} disagrees with plain attention")
    diff = (got["flash"] - got["sage"]).abs()
    log(f"  small pipeline, flash vs sage: max|diff| {diff.max().item():.6e} "
        f"({diff.max().item() / quantum:.4f} quanta), {int((diff == 0).sum())} of "
        f"{diff.numel()} latents equal to the bit")


def build_main_pipeline(dev):
    """CogVideoX-5B VAP at full width (42 blocks, MoT in 0-40, T5-XXL, the
    default VAE) with random bf16 weights from SEED, on the card."""
    import torch

    from vap_tpu_torch.models.cogvideox.config import CogVideoXMOTConfig
    from vap_tpu_torch.models.cogvideox.transformer_mot import CogVideoXTransformer3DMOTModel
    from vap_tpu_torch.models.cogvideox.vae import AutoencoderKLCogVideoX, CogVideoXVAEConfig
    from vap_tpu_torch.models.text_encoders.t5 import T5Config, T5EncoderModel
    from vap_tpu_torch.pipelines.cogvideox_i2v_mot import CogVideoXVAPPipeline

    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    t_cfg = CogVideoXMOTConfig.cogvideox_5b_i2v_vap()
    txt_cfg = T5Config.t5_xxl()
    pipe = CogVideoXVAPPipeline(
        build_random(CogVideoXTransformer3DMOTModel, t_cfg, dev, torch.bfloat16, gen),
        build_random(AutoencoderKLCogVideoX, CogVideoXVAEConfig(), dev, torch.bfloat16, gen),
        build_random(T5EncoderModel, txt_cfg, dev, torch.bfloat16, gen),
        FakeTokenizer(txt_cfg.vocab_size), dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    counts = {name: n_params(m) for name, m in (("transformer", pipe.transformer),
                                                ("text_encoder", pipe.text_encoder),
                                                ("vae", pipe.vae))}
    log(f"main path weights: {counts} bf16, {time.perf_counter() - t0:.2f} s to build; "
        f"{t_cfg.num_layers} blocks, MoT in {min(t_cfg.block_idx_with_mot_ref)}-"
        f"{max(t_cfg.block_idx_with_mot_ref)}, {t_cfg.num_attention_heads}x"
        f"{t_cfg.attention_head_dim} heads")
    return pipe


def main_path_args(steps):
    """The main path's call: a synthetic 480x720 image, a 49-frame reference
    video, two prompts, DDIM with dynamic CFG at guidance 6."""
    import numpy as np

    yy, xx = np.meshgrid(np.linspace(-1, 1, HEIGHT), np.linspace(-1, 1, WIDTH), indexing="ij")
    image = np.stack([xx, yy, xx * yy], -1).astype(np.float32)
    t = np.linspace(0, 1, NUM_FRAMES)[:, None, None, None]
    ref_video = np.clip(np.sin(3 * image[None] + 4 * t), -1, 1).astype(np.float32)
    return dict(image=image, prompt="a red fox runs through fresh snow", ref_videos=[ref_video],
                prompt_mot_ref=["the camera orbits the subject"], height=HEIGHT, width=WIDTH,
                num_frames=NUM_FRAMES, num_inference_steps=steps, guidance_scale=6.0,
                use_dynamic_cfg=True, seed=SEED)


def reset_counts():
    from vap_tpu_torch.ops import flash_attention as fa

    fa.flash_attention_forward.launches = 0
    fa.flash_attention_forward.launches_d128 = 0
    fa.flash_attention_int8_forward.launches = 0


def read_counts():
    from vap_tpu_torch.ops import flash_attention as fa

    return {"flash_fwd": fa.flash_attention_forward.launches,
            "flash_fwd_d128": fa.flash_attention_forward.launches_d128,
            "sage_fwd": fa.flash_attention_int8_forward.launches}


def check_launches(launches, want):
    """Exactly ``want`` launches of the named counters and none of the rest."""
    expected = {name: want.get(name, 0) for name in launches}
    if launches != expected:
        raise AssertionError(f"kernel launches {launches}, expected {expected}")


def main_path(pipe, provider, steps, dev):
    import numpy as np
    import torch

    from vap_tpu_torch.ops.attention import attention_provider

    args = main_path_args(steps)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    with attention_provider(provider):
        video = pipe(**args)
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)

    cfg = pipe.transformer.config
    expected = (1, decoded_frames((NUM_FRAMES - 1) // 4 + 1), HEIGHT, WIDTH, 3)
    st = pipe.stage_seconds
    log(f"  output {video.shape}, finite {bool(np.isfinite(video).all())}, "
        f"range [{video.min():.3f}, {video.max():.3f}]")
    log(f"  stage seconds: text_encode {st['text_encode']:.3f}, vae_encode {st['vae_encode']:.3f}, "
        f"denoise steps {[round(s, 3) for s in st['denoise_steps']]}, "
        f"vae_decode {st['vae_decode']:.3f}; call {wall:.3f}")
    log(f"  peak device memory {peak / 2**30:.2f} GiB; launches {launches}")
    if video.shape != expected or not np.isfinite(video).all():
        raise AssertionError(f"main path output {video.shape} (expected {expected}) or not finite")
    kernel = "flash_fwd" if provider == "flash" else "sage_fwd"
    # one joint (MoT) or self attention per block per step
    check_launches(launches, {kernel: steps * cfg.num_layers})
    return launches[kernel]


# ---------------------------------------------------------------------------
# phase 6: Wan
# ---------------------------------------------------------------------------

def wan_small_check(dev):
    """A small Wan pipeline on the card at head_dim 128 (so K4 and K2 at
    D=128 run): kernels vs the plain dense attention, and launch counts."""
    import numpy as np
    import torch

    from vap_tpu_torch.models.text_encoders.clip_vision import CLIPVisionConfig, CLIPVisionModel
    from vap_tpu_torch.models.text_encoders.t5 import T5Config, T5EncoderModel
    from vap_tpu_torch.models.wan.config import WanMOTConfig
    from vap_tpu_torch.models.wan.transformer_mot import WanTransformer3DMOTModel
    from vap_tpu_torch.models.wan.vae import AutoencoderKLWan, WanVAEConfig
    from vap_tpu_torch.ops.attention import attention_provider
    from vap_tpu_torch.pipelines.wan_i2v_mot import WanVAPPipeline

    gen = torch.Generator(device=dev).manual_seed(SEED)
    bf16 = torch.bfloat16
    t_cfg = WanMOTConfig.tiny(attention_head_dim=128, in_channels=12, out_channels=4,
                              text_dim=32, image_dim=24, added_kv_proj_dim=256, ffn_dim=512)
    pipe = WanVAPPipeline(
        build_random(WanTransformer3DMOTModel, t_cfg, dev, bf16, gen),
        build_random(AutoencoderKLWan, WanVAEConfig.tiny(), dev, bf16, gen),
        build_random(T5EncoderModel, T5Config.tiny(per_layer_relative_bias=True), dev, bf16, gen),
        build_random(CLIPVisionModel, CLIPVisionConfig.tiny(), dev, bf16, gen),
        FakeTokenizer(128), dtype=bf16, device=dev)
    rng = np.random.default_rng(SEED)
    args = dict(image=rng.uniform(-1, 1, (32, 32, 3)).astype(np.float32), prompt="a cat",
                ref_videos=[rng.uniform(-1, 1, (9, 32, 32, 3)).astype(np.float32)],
                prompt_mot_ref=["explode it"], height=32, width=32, num_frames=9,
                num_inference_steps=STEPS, guidance_scale=5.0, max_sequence_length=16,
                output_type="latent",
                latents=torch.from_numpy(rng.standard_normal((1, 3, 4, 4, 4)).astype(np.float32)))
    with attention_provider("xla"):
        ref = pipe(**args)
    # per MoT block and step: the joint attention and four cross-attentions
    want = STEPS * t_cfg.num_layers * 5
    for provider, kernel in (("flash", "flash_fwd_d128"), ("sage", "sage_fwd")):
        reset_counts()
        with attention_provider(provider):
            got = pipe(**args)
        launches = read_counts()
        err = (got - ref).abs().max().item()
        log(f"  small Wan pipeline, {provider} vs plain dense attention: final latents "
            f"max|err| {err:.4e} (tol {WAN_E2E_ATOL[provider]}), max|ref| "
            f"{ref.abs().max().item():.3f}, launches {launches}")
        check_launches(launches, {kernel: want})
        if not (torch.isfinite(got).all() and err <= WAN_E2E_ATOL[provider]):
            raise AssertionError(f"small Wan pipeline under {provider} disagrees with plain attention")


def build_wan_pipeline(dev):
    """Wan2.1-I2V-14B VAP at full width with random bf16 weights from SEED,
    each component built on the card and kept in host memory (model offload)."""
    import torch

    from vap_tpu_torch.models.text_encoders.clip_vision import CLIPVisionConfig, CLIPVisionModel
    from vap_tpu_torch.models.text_encoders.t5 import T5Config, T5EncoderModel
    from vap_tpu_torch.models.wan.config import WanMOTConfig
    from vap_tpu_torch.models.wan.transformer_mot import WanTransformer3DMOTModel
    from vap_tpu_torch.models.wan.vae import AutoencoderKLWan, WanVAEConfig
    from vap_tpu_torch.pipelines.wan_i2v_mot import WanVAPPipeline

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    t_cfg = WanMOTConfig.wan_14b_i2v_vap()
    txt_cfg = T5Config.umt5_xxl()
    parts = {}
    for name, cls, cfg in (("transformer", WanTransformer3DMOTModel, t_cfg),
                           ("vae", AutoencoderKLWan, WanVAEConfig()),
                           ("text_encoder", T5EncoderModel, txt_cfg),
                           ("image_encoder", CLIPVisionModel, CLIPVisionConfig())):
        parts[name] = build_random(cls, cfg, dev, bf16, gen, host=True)
        torch.cuda.empty_cache()
    pipe = WanVAPPipeline(**parts, tokenizer=FakeTokenizer(txt_cfg.vocab_size), dtype=bf16,
                          device=dev, enable_model_offload=True)
    counts = {name: n_params(m) for name, m in parts.items()}
    log(f"Wan weights: {counts} bf16 in host memory ({sum(counts.values()) * 2 / 2**30:.2f} GiB; "
        f"host MemTotal {mem_total_gib():.2f} GiB), {time.perf_counter() - t0:.2f} s to build; "
        f"{t_cfg.num_layers} blocks, MoT in {len(t_cfg.block_idx_with_mot_ref)}, "
        f"{t_cfg.num_attention_heads}x{t_cfg.attention_head_dim} heads, ffn {t_cfg.ffn_dim}")
    return pipe


def wan_args(steps):
    """The Wan main path's call (infer/wan_vap.py): a synthetic 480x832
    image, a 49-frame reference video, two prompts, guidance 5."""
    import numpy as np

    yy, xx = np.meshgrid(np.linspace(-1, 1, WAN_HEIGHT), np.linspace(-1, 1, WAN_WIDTH),
                         indexing="ij")
    image = np.stack([xx, yy, xx * yy], -1).astype(np.float32)
    t = np.linspace(0, 1, NUM_FRAMES)[:, None, None, None]
    ref_video = np.clip(np.sin(3 * image[None] + 4 * t), -1, 1).astype(np.float32)
    return dict(image=image, prompt="a red fox runs through fresh snow", ref_videos=[ref_video],
                prompt_mot_ref=["the camera orbits the subject"], height=WAN_HEIGHT,
                width=WAN_WIDTH, num_frames=NUM_FRAMES, num_inference_steps=steps,
                guidance_scale=5.0, seed=SEED)


def wan_main_path(pipe, provider, steps, dev):
    import numpy as np
    import torch

    from vap_tpu_torch.ops.attention import attention_provider

    args = wan_args(steps)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    with attention_provider(provider):
        video = pipe(**args)
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    st = pipe.stage_seconds
    expected = (1, NUM_FRAMES, WAN_HEIGHT, WAN_WIDTH, 3)
    log(f"  output {video.shape}, finite {bool(np.isfinite(video).all())}, "
        f"range [{video.min():.3f}, {video.max():.3f}]")
    log(f"  stage seconds: text_encode {st['text_encode']:.3f}, image_encode "
        f"{st['image_encode']:.3f}, vae_encode {st['vae_encode']:.3f}, denoise steps "
        f"{[round(s, 3) for s in st['denoise_steps']]}, vae_decode {st['vae_decode']:.3f}, "
        f"host->card staging { {k: round(v, 3) for k, v in st['staging'].items()} }; call {wall:.3f}")
    log(f"  peak device memory {peak / 2**30:.2f} GiB; launches {launches}")
    if video.shape != expected or not np.isfinite(video).all():
        raise AssertionError(f"Wan output {video.shape} (expected {expected}) or not finite")
    kernel = "flash_fwd_d128" if provider == "flash" else "sage_fwd"
    # per MoT block and step: the joint attention and four cross-attentions
    want = steps * pipe.transformer.config.num_layers * 5
    check_launches(launches, {kernel: want})
    return launches[kernel]


def main():
    import torch

    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this smoke runs only on the GPU")
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = power_line()
    log(f"device: {kind} (count {torch.cuda.device_count()}); nvidia-smi: {smi}")
    sys.path.insert(0, HERE)
    import vap_tpu_torch
    from vap_tpu_torch.ops import _build

    if not os.path.abspath(vap_tpu_torch.__file__).startswith(HERE + os.sep):
        raise SystemExit(f"chip_smoke: vap_tpu_torch comes from {vap_tpu_torch.__file__}, "
                         f"not from this checkout")
    t_start = time.perf_counter()

    # 2. build
    t0 = time.perf_counter()
    libs = _build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s -> "
        f"{[os.path.relpath(p, HERE) for p in libs.values()]}")
    for lib in libs.values():
        kernel_name = "?"
        for line in lib.with_suffix(".log").read_text().splitlines():
            found = re.search(r"\d+([a-z_]+_kernel)ILi(\d+)E", line)  # mangled template name
            if "Compiling entry function" in line and found:
                kernel_name = f"{found[1]}<{found[2]}>"
            elif "registers" in line or "spill stores" in line:
                log(f"  ptxas {kernel_name}: {line.replace('ptxas info    :', '').strip()}")

    # 3. kernel parity
    log("kernel parity (bf16, vs plain PyTorch):")
    results = kernel_parity(dev)

    # 4-5. CogVideoX
    log("small pipeline check:")
    small_pipeline_check(dev)
    pipe = build_main_pipeline(dev)
    log(f"main path, flash ({NUM_FRAMES} frames, {STEPS} steps):")
    launches = {"flash_fwd": main_path(pipe, "flash", STEPS, dev)}
    log(f"main path, sage ({NUM_FRAMES} frames, 1 step):")
    launches["sage_fwd"] = main_path(pipe, "sage", 1, dev)
    del pipe
    torch.cuda.empty_cache()

    # 6. Wan
    log("small Wan pipeline check:")
    wan_small_check(dev)
    torch.cuda.empty_cache()
    pipe = build_wan_pipeline(dev)
    log(f"Wan main path, flash ({NUM_FRAMES} frames of {WAN_HEIGHT}x{WAN_WIDTH}, {WAN_STEPS} steps):")
    launches["flash_fwd_d128"] = wan_main_path(pipe, "flash", WAN_STEPS, dev)
    log(f"Wan main path, sage ({NUM_FRAMES} frames, 1 step):")
    launches["sage_fwd_d128"] = wan_main_path(pipe, "sage", 1, dev)
    log(f"smoke: {time.perf_counter() - t_start:.1f} s after start-up")

    specs = kernel_specs()
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": spec["source"], "replaces": spec["replaces"],
         "launches": launches[name], **results[name]} for name, spec in specs.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
