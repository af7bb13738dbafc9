#!/usr/bin/env python3
"""Where the device time of one main-path call goes, on one NVIDIA GPU.

    python3 chip_profile.py [cogvideox] [wan]

Builds the kernels and the same full-width pipelines as chip_smoke.py
(random bf16 weights from a seed, one reference, one denoise step):
CogVideoX-5B VAP at 49 frames of 480x720 under the flash and sage providers,
and Wan2.1-I2V-14B VAP at 49 frames of 480x832 with model offload under
flash. Each call runs once to warm up and once under torch.profiler. It
prints the call's host wall time and stage seconds, the device's busy time
and idle share (1 - busy / wall), the device time by category and the
costliest kernels. With no argument it profiles both models. It checks
nothing that chip_smoke.py does not; it only measures.
"""

import collections
import sys
import time

from chip_smoke import (build_main_pipeline, build_wan_pipeline, log, main_path_args, power_line,
                        wan_args)

STEPS = 1
TOP = 25

# first match wins; names are the device kernels' names as the profiler gives them
CATEGORIES = [
    ("attention kernel", ("flash_fwd_kernel", "sage_fwd_kernel")),
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


def profile_call(pipe, args, label):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pipe(**args)  # warm-up: cuDNN and cuBLAS pick their algorithms here
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe(**args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_kernel = collections.defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            entry = per_kernel[evt.name]
            entry[0] += evt.time_range.elapsed_us() / 1e6
            entry[1] += 1
    busy = sum(sec for sec, _ in per_kernel.values())
    by_cat = collections.Counter()
    for name, (sec, _) in per_kernel.items():
        by_cat[category(name)] += sec

    stages = ", ".join(f"{k} {_rounded(v)}" for k, v in pipe.stage_seconds.items())
    log(f"== {label}, {STEPS} step(s): wall {wall:.3f} s; {stages}")
    log(f"device busy {busy:.3f} s of wall {wall:.3f} s -> idle share {1 - busy / wall:.3f}")
    for name, sec in by_cat.most_common():
        log(f"  {name:40s} {sec:8.3f} s  {100 * sec / busy:5.1f}%")
    for name, (sec, count) in sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:TOP]:
        log(f"  {1e3 * sec:10.1f} ms  x {count:5d}  {name[:110]}")


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
    if "wan" in models:
        pipe = build_wan_pipeline(dev)
        with attention_provider("flash"):
            profile_call(pipe, wan_args(STEPS), "Wan, flash, model offload")


if __name__ == "__main__":
    main()
