#!/usr/bin/env python3
"""Where the device time of one main-path call goes, on one NVIDIA GPU.

    python3 chip_profile.py

Builds the kernels and the same full-width CogVideoX-5B VAP pipeline as
chip_smoke.py (random bf16 weights from a seed, 49 frames of 480x720, one
reference, dynamic CFG, one DDIM step), then for each attention provider
(flash, sage) runs the call once to warm up and once under torch.profiler.
It prints the call's host wall time and stage seconds, the device's busy
time and idle share (1 - busy / wall), the device time by category and the
costliest kernels. It checks nothing that chip_smoke.py does not; it only
measures.
"""

import collections
import time

from chip_smoke import build_main_pipeline, log, main_path_args, power_line

STEPS = 1
TOP = 25

# first match wins; names are the device kernels' names as the profiler gives them
CATEGORIES = [
    ("attention kernel", ("flash_fwd_kernel", "sage_fwd_kernel")),
    ("conv layout (cuDNN)", ("nchwToNhwc", "nhwcToNchw")),
    ("GEMM and implicit-GEMM conv", ("nvjet", "gemm", "cutlass", "xmma")),
    ("norms (layer norm, group-norm moments)", ("layer_norm", "RowwiseMoments", "group_norm")),
    ("copies and concatenations", ("copy", "Memcpy", "CatArray", "cat_")),
]


def category(name):
    for label, keys in CATEGORIES:
        if any(key in name for key in keys):
            return label
    return "other elementwise"


def profile_call(pipe, provider, steps):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vap_tpu_torch.ops.attention import attention_provider

    args = main_path_args(steps)
    with attention_provider(provider):
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

    st = pipe.stage_seconds
    log(f"== {provider}, {steps} step(s): wall {wall:.3f} s; text_encode {st['text_encode']:.3f}, "
        f"vae_encode {st['vae_encode']:.3f}, denoise steps {[round(s, 3) for s in st['denoise_steps']]}, "
        f"vae_decode {st['vae_decode']:.3f}")
    log(f"device busy {busy:.3f} s of wall {wall:.3f} s -> idle share {1 - busy / wall:.3f}")
    for label, sec in by_cat.most_common():
        log(f"  {label:40s} {sec:8.3f} s  {100 * sec / busy:5.1f}%")
    for name, (sec, count) in sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:TOP]:
        log(f"  {1e3 * sec:10.1f} ms  x {count:5d}  {name[:110]}")


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_profile: no CUDA device; this profile runs only on the GPU")
    dev = torch.device("cuda", 0)
    log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {power_line()}")
    from vap_tpu_torch.ops import _build

    _build.build()
    pipe = build_main_pipeline(dev)
    for provider in ("flash", "sage"):
        profile_call(pipe, provider, STEPS)


if __name__ == "__main__":
    main()
