#!/usr/bin/env python3
"""Smoke run of the PyTorch port (vap_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. device: a CUDA device is required (no CPU fallback);
  2. build: nvcc compiles vap_tpu_torch/csrc/*.cu for sm_90a;
  3. kernel parity: K1 (flash) and K2 (sage) against their plain PyTorch
     versions in bf16 at unaligned shapes and at the main-path attention
     shape (B=1, H=48, D=64, S=35,552: 49 frames at 480x720), with times;
  4. main path, "flash": a small pipeline is first held against the plain
     dense attention; then CogVideoX-5B VAP at full width (42 blocks, MoT in
     0-40, T5-XXL, the full VAE) at the path's own 49 frames of 480x720, with
     random bf16 weights from a seed, through CogVideoXVAPPipeline.__call__;
     cut to 2 DDIM steps of the path's 50;
  5. main path, "sage": the same call with 1 step under the sage provider.

The last three lines are a JSON object with each kernel's launches in the
main-path run, its largest error against the plain version and both times at
the main-path shape; the card's name and power limit as nvidia-smi gives
them; and {"ok": true, "device": {...}}.
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
PARITY_SHAPES = [(300, 200), (128, 257), (64, 77)]
MAIN_SHAPE = (1, 48, 35552, 64)  # B, H, S, D of one joint attention at 49f@480x720
# kernel vs plain version, bf16 output, held as max|out - ref| / max|ref|:
# both round P to bf16, against different running maxima, which moves an
# output by about one bf16 ulp, at most 2^-7 of max|ref|. A planted fault
# (V rows rolled by one inside each 64-key tile) must read above the limit.
OUT_REL_TOL = 2e-2
LSE_ATOL = 1e-2
KV_TILE = 64  # keys per tile of both kernels
# small-pipeline check: final latents (max ~2) under the kernels vs the plain
# dense attention. bf16 activations through 3 blocks and 2 steps, with the
# CFG difference amplified up to 7x; sage adds its int8 score error. A
# wrong layout or mask gives errors of order 1.
E2E_ATOL = {"flash": 0.1, "sage": 0.2}


def log(msg):
    print(msg, flush=True)


def power_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# random weights from a seed (init_linear's uniform +-1/sqrt(in), zero biases)
# ---------------------------------------------------------------------------

def init_random_(model, gen):
    """The JAX package's initializers, in distribution: the transformer's
    linears (and its patch conv, a linear there) uniform +-1/sqrt(fan_in);
    T5's linears and the VAE's convs normal * fan_in^-0.5; zero biases,
    unit norms, a normal embedding and a 0.02-normal T5 bias table."""
    import torch
    from torch import nn

    from vap_tpu_torch.models.cogvideox.transformer_mot import (CogVideoXTransformer3DMOTModel,
                                                                sincos_pos_embedding)
    from vap_tpu_torch.models.text_encoders.t5 import T5LayerNorm

    uniform = isinstance(model, CogVideoXTransformer3DMOTModel)
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
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, T5LayerNorm):
                mod.weight.fill_(1.0)
            elif isinstance(mod, nn.Embedding):
                mod.weight.normal_(generator=gen)
                if mod.weight.shape[0] < 1000:  # T5 relative bias table
                    mod.weight.mul_(0.02)
        if hasattr(model, "patch_embed"):
            cfg = model.config
            frames = (cfg.sample_frames - 1) // cfg.temporal_compression_ratio + 1
            pos = torch.from_numpy(sincos_pos_embedding(cfg, cfg.sample_height,
                                                        cfg.sample_width, frames))
            for pe in (model.patch_embed, model.patch_embed_mot_ref):
                pe.pos_embedding.copy_(pos[None])
    return model


def build_random(cls, cfg, device, dtype, gen):
    """Construct on the meta device, allocate on the card, fill from `gen`."""
    import torch

    prev = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        with torch.device("meta"):
            model = cls(cfg)
    finally:
        torch.set_default_dtype(prev)
    return init_random_(model.to_empty(device=device), gen).eval()


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


# ---------------------------------------------------------------------------
# phases
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


def kernel_parity(dev):
    import torch

    from vap_tpu_torch.ops import flash_attention as fa

    kernels = {
        "flash_fwd": (fa.flash_attention_forward, fa.flash_attention_forward_plain),
        "sage_fwd": (fa.flash_attention_int8_forward, fa.flash_attention_int8_forward_plain),
    }
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
    for name, (kernel, plain) in kernels.items():
        errs = [compare(name, kernel, plain, *qkv(1, 48, sq, skv, 64))
                for sq, skv in PARITY_SHAPES]
        b, h, s, d = MAIN_SHAPE
        q, k, v = qkv(b, h, s, s, d)
        err = max(errs + [compare(name, kernel, plain, q, k, v)])
        ms = time_ms(lambda: kernel(q, k, v), iters=5, warmup=2)
        plain_ms = time_ms(lambda: plain(q, k, v), iters=1, warmup=1)
        tflops = 4 * b * h * s * s * d / (ms * 1e-3) / 1e12
        log(f"  {name} at {MAIN_SHAPE}: kernel {ms:.3f} ms ({tflops:.1f} TFLOP/s), "
            f"plain {plain_ms:.3f} ms")
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        del q, k, v
        torch.cuda.empty_cache()
    return results


def small_pipeline_check(dev):
    """A small pipeline on the card: kernels vs the plain dense attention."""
    import numpy as np
    import torch

    from vap_tpu_torch.models.cogvideox.config import CogVideoXMOTConfig
    from vap_tpu_torch.models.cogvideox.transformer_mot import CogVideoXTransformer3DMOTModel
    from vap_tpu_torch.models.cogvideox.vae import AutoencoderKLCogVideoX, CogVideoXVAEConfig
    from vap_tpu_torch.models.text_encoders.t5 import T5Config, T5EncoderModel
    from vap_tpu_torch.ops import flash_attention as fa
    from vap_tpu_torch.ops.attention import attention_provider
    from vap_tpu_torch.pipelines.cogvideox_i2v_mot import CogVideoXVAPPipeline

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
    with attention_provider("xla"):
        ref = pipe(**args)
    for provider, kernel in (("flash", fa.flash_attention_forward),
                             ("sage", fa.flash_attention_int8_forward)):
        before = kernel.launches
        with attention_provider(provider):
            got = pipe(**args)
        launched = kernel.launches - before
        err = (got - ref).abs().max().item()
        log(f"  small pipeline, {provider} vs plain dense attention: final latents "
            f"max|err| {err:.3e} (tol {E2E_ATOL[provider]}), max|ref| {ref.abs().max().item():.3f}, "
            f"{launched} launches")
        if launched != STEPS * t_cfg.num_layers:
            raise AssertionError(f"small pipeline under {provider}: {launched} kernel launches, "
                                 f"expected {STEPS * t_cfg.num_layers}")
        if not (torch.isfinite(got).all() and err <= E2E_ATOL[provider]):
            raise AssertionError(f"small pipeline under {provider} disagrees with plain attention")


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
    n_params = {name: sum(p.numel() for p in m.parameters())
                for name, m in (("transformer", pipe.transformer), ("text_encoder", pipe.text_encoder),
                                ("vae", pipe.vae))}
    log(f"main path weights: {n_params} bf16, {time.perf_counter() - t0:.2f} s to build; "
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


def main_path(pipe, provider, steps, dev):
    import numpy as np
    import torch

    from vap_tpu_torch.ops import flash_attention as fa
    from vap_tpu_torch.ops.attention import attention_provider

    args = main_path_args(steps)
    torch.cuda.reset_peak_memory_stats(dev)
    fa.flash_attention_forward.launches = 0
    fa.flash_attention_int8_forward.launches = 0
    t0 = time.perf_counter()
    with attention_provider(provider):
        video = pipe(**args)
    wall = time.perf_counter() - t0
    launches = {"flash_fwd": fa.flash_attention_forward.launches,
                "sage_fwd": fa.flash_attention_int8_forward.launches}
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
    want = steps * cfg.num_layers
    if launches[kernel] != want:
        raise AssertionError(f"{kernel} launched {launches[kernel]} times, expected {want}")
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

    # 2. build
    t0 = time.perf_counter()
    lib = _build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s -> {os.path.relpath(lib, HERE)}")
    kernel_name = "?"
    for line in lib.with_suffix(".log").read_text().splitlines():
        found = re.search(r"\d+([a-z_]+_kernel)ILi(\d+)E", line)  # mangled template name
        if "Compiling entry function" in line and found:
            kernel_name = f"{found[1]}<{found[2]}>"
        elif "registers" in line or "spill stores" in line:
            log(f"  ptxas {kernel_name}: {line.replace('ptxas info    :', '').strip()}")

    # 3. kernel parity
    log("kernel parity (bf16, vs plain PyTorch):")
    parity = kernel_parity(dev)

    # 4. main path, flash
    log("small pipeline check:")
    small_pipeline_check(dev)

    pipe = build_main_pipeline(dev)
    log(f"main path, flash ({NUM_FRAMES} frames, {STEPS} steps):")
    launches = {"flash_fwd": main_path(pipe, "flash", STEPS, dev)}

    # 5. main path, sage
    log(f"main path, sage ({NUM_FRAMES} frames, 1 step):")
    launches["sage_fwd"] = main_path(pipe, "sage", 1, dev)

    sources = {"flash_fwd": ("vap_tpu_torch/csrc/flash_fwd.cu", "vap_tpu/ops/flash_attention.py:479"),
               "sage_fwd": ("vap_tpu_torch/csrc/sage_fwd.cu", "vap_tpu/ops/flash_attention.py:816")}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0], "replaces": sources[name][1],
         "launches": launches[name], **parity[name]} for name in ("flash_fwd", "sage_fwd")]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
