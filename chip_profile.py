#!/usr/bin/env python3
"""Where the device time of one main-path call goes, on one NVIDIA GPU.

    python3 chip_profile.py [cogvideox] [wan] [wan_w8a8] [train] [w8a8] [wan_train] [hunyuan_train]

Builds the kernels and the same full-width paths as chip_smoke.py (random
bf16 weights from a seed, one reference): one denoise step of CogVideoX-5B
VAP at 49 frames of 480x720 under the flash and sage providers; one of
Wan2.1-I2V-14B VAP at 49 frames of 480x832 with model offload under flash
(with wan_w8a8 also under sage, then its bench configuration: the 804
projections quantised on the card to W8A8, the chunk form, under sage and
UniPC: K3 beside K2; before that it times one FFN weight's quantisation in
host memory and on the card, the choice that quantize_transformer_linears'
device= makes);
one CogVideoX-5B VAP training step at 49 frames of 480x720, batch 1, remat
"full", AdamW; one computed step of the bench configuration (CogVideoX-5B
VAP under sage with its projections in W8A8, the chunk form: K3 beside
K2); one Wan2.1-I2V-14B LoRA training step at 49 frames of 480x832, batch
1, the recipe's plain structure and adapters, remat "full" (K4 beside K6);
one HunyuanVideo LoRA training step at 49 frames of 480x768, batch 1, the
modal_labs_dissolve recipe's adapters, remat "full", on random latents
(K7 in K4 beside K7 in K6).
Each runs once to warm up and once under torch.profiler. It
prints the host wall time and stage seconds, the device's busy time and
idle share (1 - busy / wall), the device time by category and the costliest
kernels. With no argument it profiles the two generation paths. It checks
nothing that chip_smoke.py does not; it only measures.
"""

import collections
import sys
import time

import os

from chip_smoke import (HERE, HUNYUAN_TRAIN_FRAMES, HUNYUAN_TRAIN_HEIGHT, HUNYUAN_TRAIN_WIDTH, SEED,
                        build_hunyuan_trainer, build_main_pipeline, build_trainer,
                        build_wan_pipeline, build_wan_trainer, log, main_path_args, power_line,
                        wan_args)

STEPS = 1
TOP = 25

# first match wins; names are the device kernels' names as the profiler gives them
CATEGORIES = [
    ("W8A8 kernel (K3: quantise + GEMM)", ("w8a8_gemm_sm90_kernel", "w8a8_quantize_kernel")),
    ("attention kernel", ("flash_fwd_kernel", "flash_fwd_sm90_kernel", "flash_fwd_sm90_d64_kernel",
                          "sage_fwd_kernel", "sage_fwd_sm90_kernel", "sage_fwd_sm90_d64_kernel")),
    ("K2's pre-pass (sage_quant: statistics, scales, quantise)",
     ("sage_stats_kernel", "sage_scales_kernel", "sage_quant_kernel")),
    ("attention backward kernel (K5)", ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
                                        "flash_bwd_sm90_d64_dq_kernel",
                                        "flash_bwd_sm90_d64_dkv_kernel")),
    ("attention backward kernel (K6; K7's at D=128)", ("flash_bwd_sm90_dq_kernel",
                                                        "flash_bwd_sm90_dkv_kernel",
                                                        "scale_q_kernel")),
    ("optimizer (fused AdamW)", ("fused_adam", "FusedAdam", "multi_tensor")),
    ("host->device copies (offload staging)", ("Memcpy HtoD",)),
    ("conv layout (cuDNN)", ("nchwToNhwc", "nhwcToNchw")),
    ("GEMM and implicit-GEMM conv", ("nvjet", "gemm", "cutlass", "xmma", "conv")),
    ("norms (layer norm, group-norm moments)", ("layer_norm", "RowwiseMoments", "group_norm")),
    ("copies and concatenations", ("copy", "Memcpy", "CatArray", "cat_")),
]


def category(name):
    for label, keys in CATEGORIES:
        if any(key in name for key in keys):
            return label
    return "other elementwise"


def _rounded(v):
    if isinstance(v, list):
        return [round(x, 3) for x in v]
    if isinstance(v, dict):
        return {k: round(x, 3) for k, x in v.items()}
    return round(v, 3)


def profiled(fn):
    """Run ``fn`` once under torch.profiler; returns (wall seconds, seconds
    and launches by device kernel name)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_kernel = collections.defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            entry = per_kernel[evt.name]
            entry[0] += evt.time_range.elapsed_us() / 1e6
            entry[1] += 1
    return wall, per_kernel


def report(label, wall, per_kernel, stages):
    busy = sum(sec for sec, _ in per_kernel.values())
    by_cat = collections.Counter()
    for name, (sec, _) in per_kernel.items():
        by_cat[category(name)] += sec
    log(f"== {label}: wall {wall:.3f} s; {stages}")
    log(f"device busy {busy:.3f} s of wall {wall:.3f} s -> idle share {1 - busy / wall:.3f}")
    for name, sec in by_cat.most_common():
        log(f"  {name:40s} {sec:8.3f} s  {100 * sec / busy:5.1f}%")
    for name, (sec, count) in sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:TOP]:
        log(f"  {1e3 * sec:10.1f} ms  x {count:5d}  {name[:110]}")


def profile_call(pipe, args, label):
    pipe(**args)  # warm-up: cuDNN and cuBLAS pick their algorithms here
    wall, per_kernel = profiled(lambda: pipe(**args))
    stages = ", ".join(f"{k} {_rounded(v)}" for k, v in pipe.stage_seconds.items())
    report(f"{label}, {STEPS} step(s)", wall, per_kernel, stages)


def profile_training(trainer, label):
    """Step 1 warms up (allocator, cuBLAS, the AdamW state); step 2 is traced."""
    trainer.args.train_steps = 1
    trainer.run()
    trainer.args.train_steps = 2
    wall, per_kernel = profiled(trainer.run)
    r = trainer.history[-1]
    stages = ", ".join(f"{k} {_rounded(r[k])}" for k in ("forward_s", "backward_s", "update_s"))
    report(f"{label} training, 1 step", wall, per_kernel, f"loss {r['loss']:.6f}, {stages}")


def main():
    import torch

    from vap_tpu_torch.ops import _build
    from vap_tpu_torch.ops.attention import attention_provider

    if not torch.cuda.is_available():
        raise SystemExit("chip_profile: no CUDA device; this profile runs only on the GPU")
    models = sys.argv[1:] or ["cogvideox", "wan"]
    dev = torch.device("cuda", 0)
    log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {power_line()}")
    _build.build()
    if "cogvideox" in models:
        pipe = build_main_pipeline(dev)
        for provider in ("flash", "sage"):
            with attention_provider(provider):
                profile_call(pipe, main_path_args(STEPS), f"CogVideoX, {provider}")
        del pipe
        torch.cuda.empty_cache()
    if "wan" in models or "wan_w8a8" in models:
        pipe = build_wan_pipeline(dev)
        with attention_provider("flash"):
            profile_call(pipe, wan_args(STEPS), "Wan, flash, model offload")
        if "wan_w8a8" in models:
            from vap_tpu_torch.models.common import (quantize_linear_int8,
                                                     quantize_transformer_linears)
            from vap_tpu_torch.ops.schedulers import UniPCScheduler

            with attention_provider("sage"):
                profile_call(pipe, wan_args(STEPS), "Wan, sage, model offload")
                weight = pipe.transformer.blocks[0].ffn.net[2].weight  # in host memory
                t0 = time.perf_counter()
                quantize_linear_int8(weight)
                host_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                w_i8, s_w = quantize_linear_int8(weight.to(dev))
                w_i8.cpu(), s_w.cpu()
                card_s = time.perf_counter() - t0
                log(f"one {list(weight.shape)} weight quantised in host memory {host_s:.3f} s, "
                    f"on the card (copies included) {card_s:.3f} s")
                t0 = time.perf_counter()
                quantize_transformer_linears(pipe.transformer, act_scale="chunk", device=dev)
                log(f"{time.perf_counter() - t0:.2f} s to quantise the projections on the card")
                pipe.scheduler = UniPCScheduler(shift=3.0)
                profile_call(pipe, wan_args(STEPS),
                             "Wan bench configuration, sage + W8A8 + UniPC, model offload")
        del pipe
        torch.cuda.empty_cache()
    if "train" in models:
        profile_training(build_trainer(dev, os.path.join(HERE, "build", "chip_profile_train"), 1),
                         "CogVideoX")
        torch.cuda.empty_cache()
    if "w8a8" in models:
        from vap_tpu_torch.models.common import quantize_transformer_linears

        pipe = build_main_pipeline(dev)
        quantize_transformer_linears(pipe.transformer, act_scale="chunk")
        with attention_provider("sage"):
            profile_call(pipe, main_path_args(STEPS), "CogVideoX bench configuration, sage + W8A8")
        del pipe
        torch.cuda.empty_cache()
    if "wan_train" in models:
        profile_training(build_wan_trainer(dev, os.path.join(HERE, "build", "chip_profile_wan")),
                         "Wan2.1-I2V-14B LoRA")
        torch.cuda.empty_cache()
    if "hunyuan_train" in models:
        import numpy as np

        from vap_tpu_torch.models.hunyuan_video.config import HunyuanVideoConfig
        from vap_tpu_torch.models.hunyuan_video.transformer import HunyuanVideoTransformer3DModel
        from vap_tpu_torch.models.random_init import build_random

        model = build_random(HunyuanVideoTransformer3DModel, HunyuanVideoConfig.hunyuan_video_t2v(),
                             dev, torch.bfloat16, torch.Generator(device=dev).manual_seed(SEED))
        # random latents of the bucket's shape: the step is traced, not the encode
        shape = (1, 16, (HUNYUAN_TRAIN_FRAMES - 1) // 4 + 1, HUNYUAN_TRAIN_HEIGHT // 8,
                 HUNYUAN_TRAIN_WIDTH // 8)
        latents = np.random.default_rng(SEED).standard_normal(shape).astype(np.float32)
        profile_training(build_hunyuan_trainer(model, os.path.join(HERE, "build",
                                                                   "chip_profile_hunyuan"),
                                               latents), "HunyuanVideo LoRA")


if __name__ == "__main__":
    main()
