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
     Wan joint [1,40,40560,128], Wan cross [1,40,20280,128] x 512 and
     x 257 keys, and for K4 also Wan training's self-attention
     [1,40,20280,128] x 20280), each with a planted fault that must break
     the limit; the
     kernel's time, the plain version's, torch's SDPA flash backend's (a
     yardstick only, never called by the port) and the card's bound;
     then K3 (the W8A8 linear) against its plain version at unaligned
     shapes and at the three projection shapes of a CogVideoX step
     ([35552, 3072] x [3072, 3072 | 12288], [35552, 12288] x [12288, 3072]),
     and K9 and K10 (the GEMM rate probe) in int8 (bit for bit) and bf16,
     each with its times, bound and yardsticks; then the rate probe's entry
     point (linear_bench --impl diag) with its launch counts;
  4. CogVideoX, "flash": a small pipeline held against plain dense attention
     (with where its largest error sits and why), and a small W8A8 pipeline
     under DPM and the adaptive step cache, K3 against its plain version;
     then CogVideoX-5B VAP at full width (42 blocks, MoT in 0-40, T5-XXL,
     the full VAE) at 49 frames of 480x720, random bf16 weights from a
     seed, through CogVideoXVAPPipeline.__call__, cut to 2 DDIM steps of
     the path's 50;
  5. CogVideoX, "sage": the same call with 1 step; then the bench
     configuration on the same pipeline: its 498 projections quantised in
     place to W8A8 (chunk form, K3), sage, the step cache "uniform:2:1:1"
     over 4 DDIM steps (K3 and K2 launch on steps 0, 1 and 3 only, the
     reuse step costs under 5% of a computed one), then 1 step in the row
     form;
  6. Wan: a small pipeline on the card held against plain dense attention
     under flash and sage, then Wan2.1-I2V-14B VAP at full width (40 blocks,
     MoT in all 40, 40x128 heads, UMT5-XXL, CLIP ViT-H/14, the Wan VAE) at
     49 frames of 480x832, one reference, FlowMatch shift 3, guidance 5,
     random bf16 weights from a seed, through WanVAPPipeline.__call__ with
     model offload (one component on the card at a time), cut to 2 steps
     under flash and 1 under sage;
  7. K5 (the flash backward, D=64) against its plain PyTorch version in
     bf16 at the unaligned shapes and at the main-path shape [1,48,35552,64],
     dq, dk and dv each within a limit of max|ref|, with a planted fault
     (dout rows out of place inside each 64-query tile) that must break it;
     its time, the plain version's, the backward of torch's SDPA flash
     backend (a yardstick only) and the card's bound;
  8. CogVideoX-5B VAP training at full width (42 blocks, MoT in 0-40,
     random bf16 weights from a seed) on a random precomputed batch at 49
     frames of 480x720, batch 1, through SFTTrainer.run: AdamW (beta 0.9 /
     0.99, weight decay 1e-4, clip 1.0, a constant lr of 1e-5), remat
     "full", 3 optimizer steps (the first a warm-up); per step the loss,
     grad_norm, seconds and the forward / backward / update split, the peak
     device memory, K1 and K5 launches (84 and 42 a step), the frozen trunk
     bit-identical and the MoT expert moved;
  9. K6 (the flash backward, D=128) as K5 in phase 7, at the unaligned
     shapes and at the main-path shapes of Wan training, [1,40,20280,128]
     x 20280 (self-attention), x 512 (UMT5) and x 257 (CLIP) keys; its
     times at the self-attention shape;
 10. Wan2.1-I2V-14B LoRA SFT at full width and depth (40 blocks, no MoT:
     the plain structure of the recipe's config_plain.json, 40x128 heads,
     ffn 13,824, 36 input channels, random bf16 weights from a seed) on a
     random precomputed item at 49 frames of 480x832, batch 1, through
     SFTTrainer.run: rank 16, alpha 16 on to_q, to_k, to_v and to_out,
     logit-normal sigmas, AdamW (beta 0.9 / 0.99, weight decay 1e-4, clip
     1.0, a constant lr of 1e-4), remat "full", 3 optimizer steps (the first
     a warm-up); per step the loss, grad_norm and the forward / backward /
     update seconds, the peak device memory, K4 and K6 launches (240 and 120
     a step), the frozen trunk bit-identical, every adapter's B moved at
     step 1 and its A at step 2; the share of adapted weight elements the
     bf16 merge changes.

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
# K5 vs plain version: dq, dk and dv each held as max|err| / max|ref|. Both
# round ds and p to bf16 at the same points from the same out and lse; exp2
# and the summation order differ, which flips a rounding by one bf16 ulp
# (2^-8 relative) now and then, and each output is itself rounded to bf16.
# A planted fault (dout rows rolled by one inside each 64-query tile) must
# read above the limit in all three.
GRAD_REL_TOL = 2e-2
Q_TILE = 64  # queries per tile of the dk/dv kernel
TRAIN_STEPS = 3  # optimizer steps of phases 8 and 10: 1 warm-up, 2 timed
TRAIN_LR = 1e-5  # the recipe's lr, constant: the first update is not at lr 0
# the Wan LoRA recipe (examples/training/sft/wan/crush_smol_lora/train.sh):
# rank 16, alpha 16 on to_q, to_k, to_v and to_out of every attention, lr
# 1e-4 (constant here, not over its 100 warmup steps: the first update is
# not at lr 0), logit-normal sigmas, the plain structure of config_plain.json
WAN_LORA = dict(rank=16, lora_alpha=16, target_modules="to_q to_k to_v to_out", lr=1e-4,
                flow_weighting_scheme="logit_normal")
WAN_STRUCTURE = "examples/training/sft/wan/crush_smol_lora/config_plain.json"
# K6's main-path shapes (B, H, Sq, Skv, D): one Wan branch at 49f@480x832
# attends its own 20,280 tokens, then 512 UMT5 and 257 CLIP keys
WAN_TRAIN_ATTN = [(1, 40, 20280, 20280, 128), (1, 40, 20280, 512, 128),
                  (1, 40, 20280, 257, 128)]
NEVER = 2**31 - 1  # checkpointing_steps: no checkpoint (a full-width one holds ~32 GB)
# H100 SXM dense peaks (NVIDIA data sheet): the bound of each kernel
PEAK_BF16, PEAK_INT8, HBM_BYTES_PER_S = 989e12, 1979e12, 3.35e12
PEAK_F32 = 67e12  # float32 outside the tensor cores: K3's quantise and fold
# K3 (W8A8): a CFG-2 CogVideoX step at 49f@480x720 runs every projection on
# M = 2 * (226 text + 13 * 30 * 45 video tokens) rows of its branch
W8A8_M = 2 * (226 + 13 * 30 * 45)
# (K, N) of the projections and their launches per CFG step: q, k, v and out
# (4 x 83 branch-blocks), the feed-forward's in and out (83 each)
W8A8_SHAPES = {(3072, 3072): 332, (3072, 12288): 83, (12288, 3072): 83}
W8A8_PARITY = [(300, k, n) for k in (256, 3072) for n in (128, 384)]  # M, K, N
# K3 vs plain version, the bf16 output held as max|err| / max|ref|: per chunk
# the int32 product is exact on both sides and the f32 steps are the same in
# the same order, so an output can at most round to the neighbouring bf16
# value, one ulp: at most 2^-7 of the element (8 significant bits). A
# planted fault (the weight's rows rolled by one inside each 128-row tile)
# must read above the limit.
W8A8_REL_TOL = 2.0 ** -7
W8A8_TILE = 128
# K9 and K10 at the rate-probe script's shape (M, K, N); int8 is held bit
# for bit against an exact int64 product; bf16 sums in f32 in another order
# than the plain version, so an output may round to the neighbouring bf16
# value, one ulp, at most 2^-7 of it. K10 takes M in multiples of 16: its
# parity shapes trim M to one
PROBE_SHAPE = (71168, 3072, 3072)
PROBE_PARITY = [(300, 256, 128), (144, 3072, 384)]
GEMM_BF16_REL_TOL = 2.0 ** -7
# the bench configuration (bench.py's default: sage, W8A8, 42 blocks): DDIM
# with dynamic CFG over 4 steps under the step cache, which computes 0, 1, 3
BENCH_STEPS = 4
BENCH_CACHE = "uniform:2:1:1"
BENCH_COMPUTED = [0, 1, 3]
REUSE_STEP_SHARE = 0.05  # a reuse step costs under 5% of a computed one
# the small chunk-form pipeline under DPM and the adaptive cache, K3 against
# its plain version: both give the same bf16 projections up to an output
# rounding, which a step moves by at most a few bf16 ulps of the latents
W8A8_E2E_ATOL = 0.05


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


def bwd_bound(b, h, sq, skv, d):
    """(ms, "operations" or "bytes") for K5 and K6: 10*B*H*Sq*Skv*D operations (q k^T,
    dout v^T, ds k, p^T dout, ds^T q) at the bf16 peak; bytes: q, k, v, out,
    dout, dq, dk, dv in bf16 and lse in f32, each moved once."""
    t_ops = 10 * b * h * sq * skv * d / PEAK_BF16
    t_bytes = (2 * b * h * d * (4 * sq + 4 * skv) + 4 * b * h * sq) / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


BWD_SPECS = {
    "flash_bwd": dict(source="vap_tpu_torch/csrc/flash_bwd.cu",
                      replaces="vap_tpu/ops/flash_attention.py:1131"),
    "flash_bwd_d128": dict(source="vap_tpu_torch/csrc/flash_bwd_d128.cu",
                           replaces="vap_tpu/ops/flash_attention.py:1271"),
}
W8A8_SPECS = {
    "w8a8": dict(source="vap_tpu_torch/csrc/w8a8.cu", replaces="vap_tpu/ops/int8_matmul.py:73"),
    "gemm_probe": dict(source="vap_tpu_torch/csrc/gemm_probe.cu",
                       replaces="scripts/linear_bench.py:99"),
    "gemm_probe_t": dict(source="vap_tpu_torch/csrc/gemm_probe.cu",
                         replaces="scripts/linear_bench.py:142"),
}


def kernel_specs():
    """The kernels of the main paths, each with its wrapper, plain version,
    launch counter, parity shapes and the main-path shape it is timed at."""
    from vap_tpu_torch.ops import flash_attention as fa

    flash = (fa.flash_attention_forward, fa.flash_attention_forward_plain)
    sage = (fa.flash_attention_int8_forward, fa.flash_attention_int8_forward_plain)
    d64 = [(1, 48, sq, skv, 64) for sq, skv in PARITY_SHAPES] + [MAIN_SHAPE[:3] + MAIN_SHAPE[2:]]
    d128 = ([(1, 40, sq, skv, 128) for sq, skv in PARITY_SHAPES] + [WAN_JOINT[:3] + WAN_JOINT[2:]]
            + WAN_CROSS)
    # K4 also runs Wan training's self-attention (one branch, 20,280 tokens)
    flash_d128 = d128 + WAN_TRAIN_ATTN[:1]
    src = "vap_tpu_torch/csrc/"
    ref = "vap_tpu/ops/flash_attention.py:"
    return {
        "flash_fwd": dict(fns=flash, kind="flash", counter="launches", shapes=d64,
                          timed=MAIN_SHAPE, source=src + "flash_fwd.cu", replaces=ref + "479"),
        "flash_fwd_d128": dict(fns=flash, kind="flash", counter="launches_d128", shapes=flash_d128,
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
# phase 3b: K3 (W8A8), K9 and K10 (the GEMM rate probe)
# ---------------------------------------------------------------------------

def gemm_bound(m, k, n, in_bytes, out_bytes, peak, extra_ops_f32=0, extra_bytes=0):
    """(ms, "operations" or "bytes") of an [m, k] x [k, n] product: 2mnk
    tensor-core operations at ``peak`` (plus any float32 elementwise work at
    the float32 peak); bytes: both inputs read once, the output written
    once, plus ``extra_bytes``."""
    t_ops = 2 * m * n * k / peak + extra_ops_f32 / PEAK_F32
    t_bytes = ((m * k + n * k) * in_bytes + m * n * out_bytes + extra_bytes) / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def w8a8_bound(m, k, n):
    """K3: the int8 GEMM, plus per x element an abs, a max, a multiply and a
    rounding and per output element a fold per chunk and the epilogue's
    multiply-add in float32; bytes: x in bf16, w in int8, s_w and the bias
    in f32, the output in bf16."""
    from vap_tpu_torch.ops.int8_matmul import BLOCK_K, _pick

    chunks = k // _pick(k, BLOCK_K)
    # in_bytes 1 for w; x, in bf16, adds its second byte through extra_bytes
    return gemm_bound(m, k, n, 1, 2, PEAK_INT8, extra_ops_f32=4 * m * k + 2 * m * n * (chunks + 1),
                      extra_bytes=m * k + 8 * n)


def w8a8_inputs(gen, dev, m, k, n, bias=True):
    import torch

    from vap_tpu_torch.models.common import quantize_linear_int8

    x = (2 * torch.randn((m, k), generator=gen, device=dev)).to(torch.bfloat16)
    w = (0.02 * torch.randn((n, k), generator=gen, device=dev)).to(torch.bfloat16)
    w_i8, s_w = quantize_linear_int8(w)
    b = torch.randn((n,), generator=gen, device=dev) if bias else None
    return x, w, w_i8, s_w, b


def w8a8_parity(dev):
    """K3 against its plain version at unaligned shapes and at the three
    main-path shapes, a planted fault each time; times at the main-path
    shapes beside the plain version, the bound and two yardsticks the port
    never calls: torch._int_mm on the operands quantised beforehand, and the
    bf16 F.linear that W8A8 replaces."""
    import torch
    import torch.nn.functional as F

    from vap_tpu_torch.ops import int8_matmul as ti8

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    worst, by_shape = 0.0, {}
    shapes = W8A8_PARITY + [(W8A8_M, k, n) for k, n in W8A8_SHAPES]
    for i, (m, k, n) in enumerate(shapes):
        x, w, w_i8, s_w, b = w8a8_inputs(gen, dev, m, k, n, bias=i % 2 == 0)
        out = ti8.int8_linear_chunk(x, w_i8, s_w, b)
        torch.cuda.synchronize()
        ref = ti8.int8_linear_chunk_plain(x, w_i8, s_w, b)
        err = (out.float() - ref.float()).abs().max().item()
        ref_max = ref.float().abs().max().item()
        equal = (out == ref).float().mean().item()
        rolled = w_i8.unflatten(0, (-1, W8A8_TILE)).roll(1, dims=1).flatten(0, 1).contiguous()
        fault = (ti8.int8_linear_chunk(x, rolled, s_w, b).float() - ref.float()).abs().max().item()
        finite = bool(torch.isfinite(out).all())
        log(f"  w8a8 [{m},{k}]x[{k},{n}] bias {b is not None}: max|err| {err:.3e} / max|ref| "
            f"{ref_max:.3e} = {err / ref_max:.3e} (tol {W8A8_REL_TOL:.3e}; planted fault "
            f"{fault / ref_max:.3e}), {equal:.6f} of outputs equal to the bit, finite {finite}")
        if not (finite and err <= W8A8_REL_TOL * ref_max):
            raise AssertionError("w8a8 disagrees with its plain version")
        if fault <= W8A8_REL_TOL * ref_max:
            raise AssertionError("w8a8: the limit does not catch weight rows out of place")
        worst = max(worst, err)
        if m == W8A8_M:
            x_i8, _ = ti8.quantize_chunks(x, ti8._pick(k, ti8.BLOCK_K))
            ms = time_ms(lambda: ti8.int8_linear_chunk(x, w_i8, s_w, b), iters=10, warmup=2)
            plain_ms = time_ms(lambda: ti8.int8_linear_chunk_plain(x, w_i8, s_w, b), iters=2,
                               warmup=1)
            int_mm_ms = time_ms(lambda: torch._int_mm(x_i8, w_i8.T), iters=10, warmup=2)
            b16 = None if b is None else b.to(torch.bfloat16)  # the model's bias dtype
            bf16_ms = time_ms(lambda: F.linear(x, w, b16), iters=10, warmup=2)
            bound_ms, bound_by = w8a8_bound(m, k, n)
            tops = 2 * m * n * k / (ms * 1e-3) / 1e12
            log(f"  w8a8 at [{m},{k}]x[{k},{n}]: kernel {ms:.3f} ms ({tops:.1f} TOP/s), plain "
                f"{plain_ms:.3f} ms, torch._int_mm on quantised operands {int_mm_ms:.3f} ms, bf16 "
                f"F.linear {bf16_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by})")
            by_shape[f"{m}x{k}x{n}"] = {"ms": ms, "plain_ms": plain_ms, "int_mm_ms": int_mm_ms,
                                        "bf16_linear_ms": bf16_ms, "bound_ms": bound_ms,
                                        "bound_by": bound_by, "per_step": W8A8_SHAPES[k, n]}
        del x, w, w_i8, s_w, b, out, ref, rolled
        torch.cuda.empty_cache()
    step_ms = sum(r["ms"] * r["per_step"] for r in by_shape.values())
    step_bound = sum(r["bound_ms"] * r["per_step"] for r in by_shape.values())
    step_bf16 = sum(r["bf16_linear_ms"] * r["per_step"] for r in by_shape.values())
    log(f"  w8a8 per CFG step (498 launches): kernel {step_ms:.3f} ms, bound {step_bound:.3f} ms, "
        f"the same products as bf16 F.linear {step_bf16:.3f} ms")
    first = by_shape[f"{W8A8_M}x3072x3072"]
    return {"max_abs_err": worst, **{key: first[key] for key in
                                     ("ms", "plain_ms", "bound_ms", "bound_by")},
            "library_ms": None, "shape": [W8A8_M, 3072, 3072],
            "yardsticks": {"int_mm_ms": first["int_mm_ms"], "bf16_linear_ms": first["bf16_linear_ms"]},
            "by_shape": by_shape}


def probe_parity(dev):
    """K9 (x [M, K]) and K10 (x given as xt [K, M]) against their plain
    versions in int8 (bit for bit) and bf16, at small shapes and at the
    probe's shape, where they are timed beside one PyTorch call with the
    same function (torch._int_mm, torch.matmul) and the bound."""
    import torch

    from vap_tpu_torch.ops import gemm_probe as gp

    gen = torch.Generator(device=dev).manual_seed(SEED + 9)

    def operands(dtype, m, k, n):
        if dtype == torch.int8:
            return [torch.randint(-128, 128, s, generator=gen, device=dev, dtype=dtype)
                    for s in ((m, k), (n, k))]
        return [torch.randn(s, generator=gen, device=dev).to(dtype) for s in ((m, k), (n, k))]

    def timed(name, kernel, trans, dtype, x, a, w):
        m, k, n = PROBE_SHAPE
        if dtype == torch.int8:
            # torch._int_mm takes a row-major A: K10's xt.T is copied first
            lib, how = ((lambda: torch._int_mm(a.T.contiguous(), w.T)),
                        "torch._int_mm on xt.T copied to row-major") if trans else (
                        (lambda: torch._int_mm(x, w.T)), "torch._int_mm")
            bound_ms, bound_by = gemm_bound(m, k, n, 1, 4, PEAK_INT8)
        else:
            lib, how = ((lambda: torch.matmul(a.T, w.T)), "torch.matmul on xt.T (a view)") if trans \
                else ((lambda: torch.matmul(x, w.T)), "torch.matmul")
            bound_ms, bound_by = gemm_bound(m, k, n, 2, 2, PEAK_BF16)
        ms = time_ms(lambda: kernel(a, w), iters=10, warmup=2)
        plain_ms = time_ms(lambda: gp.gemm_probe_plain(x, w), iters=2, warmup=1)
        library_ms = time_ms(lib, iters=10, warmup=2)
        log(f"  {name} {str(dtype)[6:]} at {PROBE_SHAPE}: kernel {ms:.3f} ms "
            f"({2 * m * n * k / (ms * 1e-3) / 1e12:.1f} TOP/s), plain {plain_ms:.3f} ms, {how} "
            f"{library_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by})")
        return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                "bound_by": bound_by}

    results = {}
    for name, kernel, trans in (("gemm_probe", gp.gemm_probe, False),
                                ("gemm_probe_t", gp.gemm_probe_t, True)):
        per_type = {}
        for dtype in (torch.int8, torch.bfloat16):
            worst = 0.0
            for m, k, n in PROBE_PARITY + [PROBE_SHAPE]:
                if trans:
                    m -= m % 16
                x, w = operands(dtype, m, k, n)
                a = x.T.contiguous() if trans else x
                out = kernel(a, w)
                torch.cuda.synchronize()
                ref = gp.gemm_probe_plain(x, w)
                err = (out.float() - ref.float()).abs().max().item()
                ref_max = ref.float().abs().max().item()
                exact = dtype == torch.int8
                log(f"  {name} {str(dtype)[6:]} [{m},{k}]x[{k},{n}]: max|err| {err:.3e} / max|ref| "
                    f"{ref_max:.3e} ({'bit for bit' if exact else f'tol {GEMM_BF16_REL_TOL:.3e}'}), "
                    f"{(out == ref).float().mean().item():.6f} equal to the bit")
                if not (torch.equal(out, ref) if exact else err <= GEMM_BF16_REL_TOL * ref_max):
                    raise AssertionError(f"{name} ({dtype}) disagrees with its plain version")
                worst = max(worst, err)
                if (m, k, n) == PROBE_SHAPE:
                    per_type[dtype] = {"max_abs_err": worst,
                                       **timed(name, kernel, trans, dtype, x, a, w)}
                del x, w, a, out, ref
                torch.cuda.empty_cache()
        results[name] = {**per_type[torch.int8], "shape": list(PROBE_SHAPE),
                         "bf16": per_type[torch.bfloat16]}
    return results


def rate_probe_path():
    """The rate probe's own entry point, ``python -m
    vap_tpu_torch.scripts.linear_bench --impl diag``, driven once: K9 and K10
    in int8 and bf16 at its default shape, each a warm-up and 5 timed calls."""
    from vap_tpu_torch.scripts import linear_bench

    reset_counts()
    lines = linear_bench.main(["--impl", "diag"])
    launches = read_counts()
    per = (1 + linear_bench.REPS) * 2
    check_launches(launches, {"gemm_probe": per, "gemm_probe_t": per})
    if len(lines) != 4:
        raise AssertionError(f"linear_bench --impl diag printed {lines}")
    return launches


# ---------------------------------------------------------------------------
# phases 4-5: CogVideoX
# ---------------------------------------------------------------------------

def small_pipeline_check(dev):
    """A small CogVideoX pipeline on the card: kernels vs the plain dense
    attention, with where the largest difference sits."""
    import numpy as np
    import torch

    from vap_tpu_torch.models.random_init import build_random
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

    from vap_tpu_torch.models.random_init import build_random
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
    from vap_tpu_torch.models import common
    from vap_tpu_torch.ops import flash_attention as fa
    from vap_tpu_torch.ops import gemm_probe as gp
    from vap_tpu_torch.ops import int8_matmul as ti8

    fa.flash_attention_forward.launches = 0
    fa.flash_attention_forward.launches_d128 = 0
    fa.flash_attention_int8_forward.launches = 0
    fa.flash_attention_backward.launches = 0
    fa.flash_attention_backward.launches_d128 = 0
    ti8.int8_linear_chunk.launches = 0
    common.int8_linear_row.calls = 0
    gp.gemm_probe.launches = 0
    gp.gemm_probe_t.launches = 0


def read_counts():
    """Each kernel's launches, and the calls of the W8A8 row form (no kernel
    of its own: XLA's product in the JAX package, torch._int_mm here)."""
    from vap_tpu_torch.models import common
    from vap_tpu_torch.ops import flash_attention as fa
    from vap_tpu_torch.ops import gemm_probe as gp
    from vap_tpu_torch.ops import int8_matmul as ti8

    return {"flash_fwd": fa.flash_attention_forward.launches,
            "flash_fwd_d128": fa.flash_attention_forward.launches_d128,
            "sage_fwd": fa.flash_attention_int8_forward.launches,
            "flash_bwd": fa.flash_attention_backward.launches,
            "flash_bwd_d128": fa.flash_attention_backward.launches_d128,
            "w8a8": ti8.int8_linear_chunk.launches,
            "w8a8_row_calls": common.int8_linear_row.calls,
            "gemm_probe": gp.gemm_probe.launches,
            "gemm_probe_t": gp.gemm_probe_t.launches}


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


def bench_config_path(pipe, dev):
    """The bench configuration on the full-width pipeline: the projections
    quantised in place to W8A8 in the chunk form, then
    CogVideoXVAPPipeline.__call__ under sage, DDIM with dynamic CFG, the
    step cache "uniform:2:1:1" over 4 steps; then the row form, 1 step.
    Returns K3's launches in the cached run."""
    import numpy as np
    import torch

    from vap_tpu_torch.models.common import quantize_transformer_linears, set_int8_act_scale
    from vap_tpu_torch.ops.attention import attention_provider

    cfg = pipe.transformer.config
    t0 = time.perf_counter()
    names = quantize_transformer_linears(pipe.transformer, act_scale="chunk")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"  {len(names)} projections quantised in place in {time.perf_counter() - t0:.2f} s; "
        f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB allocated after")
    per_step = sum(W8A8_SHAPES.values())
    if len(names) != per_step:
        raise AssertionError(f"{len(names)} projections quantised, expected {per_step}")

    # the launch counts at each scheduler step (after that step's forward, if any)
    at_step = []

    class Counting(type(pipe.scheduler)):
        def step(self, *args, **kwargs):
            at_step.append(read_counts())
            return super().step(*args, **kwargs)

    scheduler, pipe.scheduler = pipe.scheduler, Counting()
    args = dict(main_path_args(BENCH_STEPS), step_cache=BENCH_CACHE)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    try:
        with attention_provider("sage"):
            video = pipe(**args)
    finally:
        pipe.scheduler = scheduler
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    st = pipe.stage_seconds
    steps = st["denoise_steps"]
    deltas = [{k: v - (at_step[i - 1][k] if i else 0) for k, v in c.items()}
              for i, c in enumerate(at_step)]
    per_step_launches = [{k: v for k, v in d.items() if v} for d in deltas]
    expected = (1, decoded_frames((NUM_FRAMES - 1) // 4 + 1), HEIGHT, WIDTH, 3)
    log(f"  output {video.shape}, finite {bool(np.isfinite(video).all())}, "
        f"range [{video.min():.3f}, {video.max():.3f}]")
    log(f"  stage seconds: text_encode {st['text_encode']:.3f}, vae_encode {st['vae_encode']:.3f}, "
        f"denoise steps {[round(x, 3) for x in steps]} (computed {st['computed_steps']}), "
        f"vae_decode {st['vae_decode']:.3f}; call {wall:.3f}")
    log(f"  peak device memory {peak / 2**30:.2f} GiB; launches {launches}; per step "
        f"{per_step_launches}")
    if video.shape != expected or not np.isfinite(video).all():
        raise AssertionError(f"bench configuration output {video.shape} (expected {expected}) "
                             f"or not finite")
    if st["computed_steps"] != BENCH_COMPUTED:
        raise AssertionError(f"computed steps {st['computed_steps']}, expected {BENCH_COMPUTED}")
    n = len(BENCH_COMPUTED)
    check_launches(launches, {"sage_fwd": n * cfg.num_layers, "w8a8": n * per_step})
    reuse = [i for i in range(BENCH_STEPS) if i not in BENCH_COMPUTED]
    if any(per_step_launches[i] for i in reuse):
        raise AssertionError(f"a reuse step launched kernels: {per_step_launches}")
    computed_min = min(steps[i] for i in BENCH_COMPUTED)
    if any(steps[i] >= REUSE_STEP_SHARE * computed_min for i in reuse):
        raise AssertionError(f"a reuse step took {[steps[i] for i in reuse]} s, not under "
                             f"{REUSE_STEP_SHARE} of a computed step ({computed_min:.3f} s)")
    log(f"  reuse step {reuse}: {[round(steps[i], 4) for i in reuse]} s, "
        f"{max(steps[i] for i in reuse) / computed_min:.5f} of the fastest computed step")

    # the row form on the same int8 weights: no K3 launch, 498 row-form calls
    set_int8_act_scale(pipe.transformer, "row")
    reset_counts()
    with attention_provider("sage"):
        latents = pipe(**dict(main_path_args(1), output_type="latent"))
    row = read_counts()
    log(f"  row form, 1 step: {pipe.stage_seconds['denoise_steps'][0]:.3f} s; launches {row}")
    check_launches(row, {"sage_fwd": cfg.num_layers, "w8a8_row_calls": per_step})
    if not torch.isfinite(latents).all():
        raise AssertionError("row form: latents not finite")
    return launches["w8a8"]


def small_w8a8_check(dev):
    """A small CogVideoX pipeline on the card in the W8A8 chunk form, under
    DPM and the adaptive step cache: K3 against its plain version through
    the pipeline (the plain version swapped in for the reference run only),
    with the same computed steps."""
    import numpy as np
    import torch

    from vap_tpu_torch.models import common
    from vap_tpu_torch.models.random_init import build_random
    from vap_tpu_torch.models.cogvideox.config import CogVideoXMOTConfig
    from vap_tpu_torch.models.cogvideox.transformer_mot import CogVideoXTransformer3DMOTModel
    from vap_tpu_torch.models.cogvideox.vae import AutoencoderKLCogVideoX, CogVideoXVAEConfig
    from vap_tpu_torch.models.text_encoders.t5 import T5Config, T5EncoderModel
    from vap_tpu_torch.ops import int8_matmul as ti8
    from vap_tpu_torch.ops.attention import attention_provider
    from vap_tpu_torch.ops.schedulers import CogVideoXDPMScheduler
    from vap_tpu_torch.pipelines.cogvideox_i2v_mot import CogVideoXVAPPipeline

    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    bf16 = torch.bfloat16
    t_cfg = CogVideoXMOTConfig.tiny(num_attention_heads=2, attention_head_dim=64, in_channels=8,
                                    out_channels=4, num_layers=3, block_idx_with_mot_ref=(0, 1),
                                    use_learned_positional_embeddings=True)
    txt_cfg = T5Config.tiny(d_model=t_cfg.text_embed_dim)
    transformer = build_random(CogVideoXTransformer3DMOTModel, t_cfg, dev, bf16, gen)
    n_proj = len(common.quantize_transformer_linears(transformer, act_scale="chunk"))
    inputs = []

    class Recording(CogVideoXDPMScheduler):
        def step(self, model_output, sample, *rest):
            inputs.append(sample.clone())
            return super().step(model_output, sample, *rest)

    pipe = CogVideoXVAPPipeline(
        transformer, build_random(AutoencoderKLCogVideoX, CogVideoXVAEConfig.tiny(), dev, bf16, gen),
        build_random(T5EncoderModel, txt_cfg, dev, bf16, gen), FakeTokenizer(txt_cfg.vocab_size),
        scheduler=Recording(), dtype=bf16, device=dev)
    rng = np.random.default_rng(SEED)
    args = dict(image=rng.uniform(-1, 1, (64, 64, 3)).astype(np.float32), prompt="a cat",
                ref_videos=[rng.uniform(-1, 1, (9, 64, 64, 3)).astype(np.float32)],
                prompt_mot_ref=["explode it"], height=64, width=64, num_frames=9,
                num_inference_steps=BENCH_STEPS, max_sequence_length=t_cfg.max_text_seq_length,
                output_type="latent", seed=SEED)

    def relative_l1(i):
        return ((inputs[i] - inputs[i - 1]).abs().mean() / (inputs[i - 1].abs().mean() + 1e-8)).item()

    # an uncached run gives the relative change of the inputs at steps 1 and
    # 2; a threshold between d1 and d1 + d2 skips step 1 and computes step 2
    with attention_provider("flash"):
        pipe(**args)
    d1, d2 = relative_l1(1), relative_l1(2)
    spec = f"adaptive:{d1 + d2 / 2:.6g}:1:1"
    got = {}
    for version, fn in (("plain", ti8.int8_linear_chunk_plain), ("kernel", ti8.int8_linear_chunk)):
        common.int8_linear_chunk = fn  # the reference run swaps in the plain version
        reset_counts()
        try:
            with attention_provider("flash"):
                got[version] = (pipe(**args, step_cache=spec),
                                list(pipe.stage_seconds["computed_steps"]), read_counts())
        finally:
            common.int8_linear_chunk = ti8.int8_linear_chunk
    (ref, ref_steps, _), (out, steps, launches) = got["plain"], got["kernel"]
    err = (out - ref).abs().max().item()
    log(f"  small W8A8 pipeline, DPM, {spec} (d1 {d1:.4f}, d2 {d2:.4f}): computed steps {steps} "
        f"(plain {ref_steps}); K3 vs its plain version: final latents max|err| {err:.6e} (tol "
        f"{W8A8_E2E_ATOL}), {int((out != ref).sum())} of {out.numel()} differ, max|ref| "
        f"{ref.abs().max().item():.3f}; launches {launches}")
    if steps != ref_steps or steps != [0, 2, BENCH_STEPS - 1]:
        raise AssertionError(f"adaptive cache computed {steps} (plain {ref_steps}), expected "
                             f"[0, 2, {BENCH_STEPS - 1}]")
    check_launches(launches, {"flash_fwd": len(steps) * t_cfg.num_layers,
                              "w8a8": len(steps) * n_proj})
    if not (torch.isfinite(out).all() and err <= W8A8_E2E_ATOL):
        raise AssertionError("small W8A8 pipeline: K3 disagrees with its plain version")


# ---------------------------------------------------------------------------
# phase 6: Wan
# ---------------------------------------------------------------------------

def wan_small_check(dev):
    """A small Wan pipeline on the card at head_dim 128 (so K4 and K2 at
    D=128 run): kernels vs the plain dense attention, and launch counts."""
    import numpy as np
    import torch

    from vap_tpu_torch.models.random_init import build_random
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

    from vap_tpu_torch.models.random_init import build_random
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


# ---------------------------------------------------------------------------
# phase 7: K5, the flash backward
# ---------------------------------------------------------------------------

def backward_parity(dev, d128=False):
    """K5 (head_dim 64) or K6 (``d128``: head_dim 128) against its plain
    version at the unaligned shapes and the main-path shapes, with the
    planted fault; then its times at the first main-path shape."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from vap_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(SEED + (9 if d128 else 7))
    name = "flash_bwd_d128" if d128 else "flash_bwd"
    plain = fa.flash_attention_backward_rows_plain if d128 else fa.flash_attention_backward_plain

    def inputs(b, h, sq, skv, d):
        q, k, v, dout = [torch.randn((b, h, s, d), generator=gen, device=dev).to(torch.bfloat16)
                         for s in (sq, skv, skv, sq)]
        out, lse = fa.flash_attention_forward(q, k, v)
        return q, k, v, out, lse, dout

    def rolled_in_q_tiles(x):
        n = x.shape[2] // Q_TILE * Q_TILE
        tiles = x[:, :, :n].unflatten(2, (-1, Q_TILE)).roll(1, dims=3).flatten(2, 3)
        return torch.cat([tiles, x[:, :, n:]], dim=2).contiguous()

    def errors(got, ref):
        return [((g.float() - r.float()).abs().max().item(), r.float().abs().max().item())
                for g, r in zip(got, ref)]

    if d128:  # Wan's self-attention, then its text and CLIP cross-attentions
        shapes = [(1, 40, sq, skv, 128) for sq, skv in PARITY_SHAPES] + WAN_TRAIN_ATTN
    else:
        shapes = ([(1, 48, sq, skv, 64) for sq, skv in PARITY_SHAPES]
                  + [MAIN_SHAPE[:3] + MAIN_SHAPE[2:]])
    worst = 0.0
    for b, h, sq, skv, d in shapes:
        q, k, v, out, lse, dout = inputs(b, h, sq, skv, d)
        got = fa.flash_attention_backward(q, k, v, out, lse, dout)
        torch.cuda.synchronize()
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        ref = plain(q, k, v, out, lse, dout)
        errs = errors(got, ref)
        del got
        fault = errors(fa.flash_attention_backward(q, k, v, out, lse, rolled_in_q_tiles(dout)), ref)
        log(f"  {name} {(b, h, sq, d)} x {skv}: " + ", ".join(
            f"d{n} max|err| {e:.3e} / max|ref| {m:.3e} = {e / m:.3e} (planted fault {fe / m:.3e})"
            for n, (e, m), (fe, _) in zip("qkv", errs, fault)) + f" (tol {GRAD_REL_TOL}), "
            f"finite {finite}")
        if not (finite and all(e <= GRAD_REL_TOL * m for e, m in errs)):
            raise AssertionError(f"{name} disagrees with its plain version")
        if not all(fe > GRAD_REL_TOL * m for (fe, m) in fault):
            raise AssertionError(f"{name}: the limit does not catch dout rows out of place")
        worst = max([worst] + [e for e, _ in errs])
        del q, k, v, out, lse, dout, ref
        torch.cuda.empty_cache()

    b, h, sq, skv, d = shapes[len(PARITY_SHAPES)]
    q, k, v, out, lse, dout = inputs(b, h, sq, skv, d)
    ms = time_ms(lambda: fa.flash_attention_backward(q, k, v, out, lse, dout), iters=3, warmup=1)
    plain_ms = time_ms(lambda: plain(q, k, v, out, lse, dout), iters=1, warmup=1)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):  # one PyTorch call: a yardstick
        o = F.scaled_dot_product_attention(*leaves)
    library_ms = time_ms(lambda: torch.autograd.grad(o, leaves, dout, retain_graph=True), iters=3,
                         warmup=1)
    bound_ms, bound_by = bwd_bound(b, h, sq, skv, d)
    tflops = 10 * b * h * sq * skv * d / (ms * 1e-3) / 1e12
    log(f"  {name} at {(b, h, sq, d)} x {skv}: kernel {ms:.3f} ms ({tflops:.1f} TFLOP/s), plain "
        f"{plain_ms:.3f} ms, SDPA flash backward {library_ms:.3f} ms, bound {bound_ms:.3f} ms "
        f"({bound_by})")
    del q, k, v, out, lse, dout, leaves, o
    torch.cuda.empty_cache()
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms, "shape": [b, h, sq, skv, d]}


# ---------------------------------------------------------------------------
# phase 8: the full-width CogVideoX VAP training step
# ---------------------------------------------------------------------------

def training_batch(cfg):
    """One random precomputed item at 49f@480x720, batch 1, in the JAX
    trainer's cache layout: latents [1,13,16,60,90] (target, its first-frame
    image latents, the reference and its image latents) and T5 states
    [1,226,4096] for each prompt."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    frames = (NUM_FRAMES - 1) // 4 + 1
    lat = (1, frames, cfg.out_channels, HEIGHT // 8, WIDTH // 8)
    txt = (1, cfg.max_text_seq_length, cfg.text_embed_dim)

    def normal(shape):
        return rng.standard_normal(shape, dtype=np.float32)

    def first_frame(shape):  # one encoded frame, then zero padding (CogVideoXSpec)
        x = np.zeros(shape, np.float32)
        x[:, :1] = normal((1, 1) + shape[2:])
        return x

    cond = {"encoder_hidden_states": normal(txt), "encoder_hidden_states_mot_ref": normal(txt)}
    latents = {"latents": normal(lat), "image_latents": first_frame(lat),
               "latents_mot_ref": normal(lat), "image_latents_mot_ref": first_frame(lat)}
    return cond, latents


def build_trainer(dev, work, steps):
    """CogVideoX-5B VAP at full width with random bf16 weights from SEED on
    the card, and an SFTTrainer for ``steps`` optimizer steps of the
    recipe's AdamW at a constant lr, remat "full", on one random item
    written as a precomputed cache under ``work``."""
    import shutil

    import torch

    from vap_tpu_torch.data.precomputation import write_precomputed
    from vap_tpu_torch.models.cogvideox.config import CogVideoXMOTConfig
    from vap_tpu_torch.models.cogvideox.transformer_mot import CogVideoXTransformer3DMOTModel
    from vap_tpu_torch.models.random_init import build_random
    from vap_tpu_torch.training.args import TrainingArgs
    from vap_tpu_torch.training.trainer import SFTTrainer

    shutil.rmtree(work, ignore_errors=True)
    cfg = CogVideoXMOTConfig.cogvideox_5b_i2v_vap()
    write_precomputed(os.path.join(work, "cache"), [training_batch(cfg)])
    model = build_random(CogVideoXTransformer3DMOTModel, cfg, dev, torch.bfloat16,
                         torch.Generator(device=dev).manual_seed(SEED + 8))
    args = TrainingArgs(precomputation_dir=os.path.join(work, "cache"),
                        output_dir=os.path.join(work, "out"), seed=SEED, train_steps=steps,
                        optimizer="adamw", lr=TRAIN_LR, lr_scheduler="constant",
                        lr_warmup_steps=0, beta1=0.9, beta2=0.99, weight_decay=1e-4,
                        max_grad_norm=1.0, gradient_checkpointing=True,
                        checkpointing_steps=NEVER, logging_steps=1)
    return SFTTrainer(args, model)


def training_path(dev):
    import shutil

    import numpy as np
    import torch

    work = os.path.join(HERE, "build", "chip_smoke_train")
    t0 = time.perf_counter()
    trainer = build_trainer(dev, work, TRAIN_STEPS)
    model, cfg = trainer.model, trainer.model.config
    params = dict(model.named_parameters())
    before = {n: p.detach().to("cpu", copy=True) for n, p in params.items()}
    n_train = sum(params[n].numel() for n in trainer.trainable_names)
    log(f"  {cfg.num_layers} blocks, MoT in {min(cfg.block_idx_with_mot_ref)}-"
        f"{max(cfg.block_idx_with_mot_ref)}: {n_params(model)} bf16 parameters, {n_train} "
        f"trainable in {len(trainer.trainable_names)} tensors, remat "
        f"{trainer.step_cfg.remat!r}, AdamW fused {trainer.optimizer.inner.defaults['fused']}; "
        f"{time.perf_counter() - t0:.2f} s to build")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t0 = time.perf_counter()
    trainer.run()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    for r in trainer.history:
        total = r["forward_s"] + r["backward_s"] + r["update_s"]
        log(f"  step {r['step']}: loss {r['loss']:.6f}, grad_norm {r['grad_norm']:.6f}, lr "
            f"{r['lr']:.1e}, {total:.3f} s = forward {r['forward_s']:.3f} + backward "
            f"{r['backward_s']:.3f} + update {r['update_s']:.3f}")
    log(f"  {TRAIN_STEPS} steps in {wall:.3f} s; peak device memory {peak / 2**30:.2f} GiB; "
        f"launches {launches}, per step K1 {launches['flash_fwd'] / TRAIN_STEPS:g} (expected "
        f"{2 * cfg.num_layers}: forward and recompute) and K5 "
        f"{launches['flash_bwd'] / TRAIN_STEPS:g} (expected {cfg.num_layers})")
    check_launches(launches, {"flash_fwd": 2 * cfg.num_layers * TRAIN_STEPS,
                              "flash_bwd": cfg.num_layers * TRAIN_STEPS})
    if not (len(trainer.history) == TRAIN_STEPS == trainer.optimizer.count
            and all(np.isfinite([r["loss"], r["grad_norm"]]).all() for r in trainer.history)):
        raise AssertionError(f"training: {trainer.optimizer.count} updates, history "
                             f"{trainer.history}")
    trainable = set(trainer.trainable_names)
    frozen_changed = [n for n, p in params.items()
                      if n not in trainable and not torch.equal(p.detach().cpu(), before[n])]
    moved = {n: int((params[n].detach().cpu() != before[n]).sum()) for n in trainable}
    # What must move: a bf16 weight moves only where an lr-sized step passes
    # half its ulp, so the LayerNorm scales (all 1.0, ulp 2^-7) cannot at lr
    # 1e-5; and the last MoT block's reference queries, output projection
    # and feed-forward feed only the reference stream, which no loss reads:
    # their gradients are zero and they must stay as they were.
    last = max(cfg.block_idx_with_mot_ref)
    dead = tuple(f"transformer_blocks.{last}.{m}" for m in (
        "attn1_mot_ref.to_q", "attn1_mot_ref.norm_q", "attn1_mot_ref.to_out", "norm2_mot_ref",
        "ff_mot_ref"))
    scales = ("norm.weight", "norm_q.weight", "norm_k.weight")
    must = [n for n in trainable if not n.startswith(dead) and not n.endswith(scales)]
    log(f"  frozen tensors changed: {len(frozen_changed)} of {len(params) - len(trainable)}; "
        f"trainable tensors moved: {sum(c > 0 for c in moved.values())} of {len(trainable)} "
        f"({len(must)} must move), {sum(moved.values())} of {n_train} elements "
        f"({sum(moved.values()) / n_train:.4f}); the last MoT block's reference-only tensors "
        f"moved: {sum(moved[n] > 0 for n in trainable if n.startswith(dead))}")
    stuck = [n for n in must if moved[n] == 0]
    woke = [n for n in trainable if n.startswith(dead) and moved[n]]
    if frozen_changed or stuck or woke:
        raise AssertionError(f"training: frozen tensors changed {frozen_changed[:5]}, trainable "
                             f"tensors that did not move {stuck[:5]}, reference-only tensors "
                             f"that moved {woke[:5]}")
    del trainer, model, params, before
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches["flash_bwd"]


# ---------------------------------------------------------------------------
# phase 10: Wan2.1-I2V-14B LoRA SFT at full width
# ---------------------------------------------------------------------------

def wan_training_batch(cfg):
    """One random precomputed item at 49f@480x832, batch 1, in WanSpec's
    layout: latents [1,13,60,104,16]; condition [1,13,60,104,20] (the
    first-frame mask, then the latent of the first frame and zeros); UMT5
    states [1,512,4096], zero past a 40-token prompt; CLIP states
    [1,257,1280]."""
    import numpy as np

    rng = np.random.default_rng(SEED + 10)
    frames = (NUM_FRAMES - 1) // 4 + 1
    lat = (1, frames, WAN_HEIGHT // 8, WAN_WIDTH // 8, cfg.out_channels)
    cond = np.zeros(lat[:-1] + (cfg.in_channels - cfg.out_channels,), np.float32)
    cond[:, 0, ..., :4] = 1.0  # the mask: the first frame is given
    cond[:, 0, ..., 4:] = rng.standard_normal(cond[:, 0, ..., 4:].shape, dtype=np.float32)
    text = np.zeros((1, cfg.text_len, cfg.text_dim), np.float32)
    text[:, :40] = rng.standard_normal((1, 40, cfg.text_dim), dtype=np.float32)
    return ({"encoder_hidden_states": text, "encoder_hidden_states_image":
             rng.standard_normal((1, 257, cfg.image_dim), dtype=np.float32)},
            {"latents": rng.standard_normal(lat, dtype=np.float32), "condition": cond})


def build_wan_trainer(dev, work):
    """Wan2.1-I2V-14B in the recipe's plain structure, random bf16 weights
    from SEED on the card, and an SFTTrainer of the LoRA recipe with remat
    "full", on one random item written as a precomputed cache under ``work``."""
    import shutil

    import torch

    from vap_tpu_torch.data.precomputation import write_precomputed
    from vap_tpu_torch.models.random_init import build_random
    from vap_tpu_torch.models.wan.config import WanMOTConfig
    from vap_tpu_torch.models.wan.transformer_mot import WanTransformer3DMOTModel
    from vap_tpu_torch.train import structure_overrides
    from vap_tpu_torch.training.args import TrainingArgs
    from vap_tpu_torch.training.trainer import SFTTrainer

    shutil.rmtree(work, ignore_errors=True)
    args = TrainingArgs(model_name="wan", training_type="lora",
                        model_structure_config=os.path.join(HERE, WAN_STRUCTURE),
                        precomputation_dir=os.path.join(work, "cache"),
                        output_dir=os.path.join(work, "out"), seed=SEED, train_steps=1,
                        optimizer="adamw", lr_scheduler="constant", lr_warmup_steps=0,
                        beta1=0.9, beta2=0.99, weight_decay=1e-4, max_grad_norm=1.0,
                        gradient_checkpointing=True, checkpointing_steps=NEVER,
                        logging_steps=1, **WAN_LORA)
    cfg = WanMOTConfig.wan_14b_i2v_vap(**structure_overrides(WanMOTConfig,
                                                             args.model_structure()))
    write_precomputed(args.precomputation_dir, [wan_training_batch(cfg)])
    model = build_random(WanTransformer3DMOTModel, cfg, dev, torch.bfloat16,
                         torch.Generator(device=dev).manual_seed(SEED + 10))
    return SFTTrainer(args, model)


def wan_training_path(dev):
    import shutil

    import numpy as np
    import torch

    work = os.path.join(HERE, "build", "chip_smoke_wan_train")
    t0 = time.perf_counter()
    trainer = build_wan_trainer(dev, work)
    model, cfg = trainer.model, trainer.model.config
    params = dict(model.named_parameters())
    trainable = set(trainer.trainable_names)
    before = {n: p.detach().to("cpu", copy=True) for n, p in params.items() if n not in trainable}
    n_lora = sum(params[n].numel() for n in trainable)
    log(f"  {cfg.num_layers} blocks, MoT in {list(cfg.block_idx_with_mot_ref)}, "
        f"{cfg.num_attention_heads}x{cfg.attention_head_dim} heads, ffn {cfg.ffn_dim}, "
        f"{cfg.in_channels} input channels: {n_params(model) - n_lora} bf16 parameters frozen, "
        f"{len(trainer.lora)} adapters (rank {trainer.args.rank}) with {n_lora} f32 parameters, "
        f"remat {trainer.step_cfg.remat!r}, AdamW fused "
        f"{trainer.optimizer.inner.defaults['fused']}; {time.perf_counter() - t0:.2f} s to build")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    start = {n: ab["A"].detach().clone() for n, ab in trainer.lora.items()}
    snapshots = []
    t0 = time.perf_counter()
    for step in range(1, TRAIN_STEPS + 1):  # one run() per step, to see what each moved
        trainer.args.train_steps = step
        trainer.run()
        snapshots.append({n: {k: v.detach().clone() for k, v in ab.items()}
                          for n, ab in trainer.lora.items()})
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    for r in trainer.history:
        total = r["forward_s"] + r["backward_s"] + r["update_s"]
        log(f"  step {r['step']}: loss {r['loss']:.6f}, grad_norm {r['grad_norm']:.6f}, lr "
            f"{r['lr']:.1e}, {total:.3f} s = forward {r['forward_s']:.3f} + backward "
            f"{r['backward_s']:.3f} + update {r['update_s']:.3f}")
    per_step = 3 * cfg.num_layers  # self, text and image attention per block
    log(f"  {TRAIN_STEPS} steps in {wall:.3f} s; peak device memory {peak / 2**30:.2f} GiB; "
        f"launches {launches}, per step K4 {launches['flash_fwd_d128'] / TRAIN_STEPS:g} (expected "
        f"{2 * per_step}: forward and recompute) and K6 "
        f"{launches['flash_bwd_d128'] / TRAIN_STEPS:g} (expected {per_step})")
    check_launches(launches, {"flash_fwd_d128": 2 * per_step * TRAIN_STEPS,
                              "flash_bwd_d128": per_step * TRAIN_STEPS})
    if not (len(trainer.history) == TRAIN_STEPS == trainer.optimizer.count
            and all(np.isfinite([r["loss"], r["grad_norm"]]).all() for r in trainer.history)):
        raise AssertionError(f"Wan training: {trainer.optimizer.count} updates, history "
                             f"{trainer.history}")
    frozen_changed = [n for n, p in params.items()
                      if n not in trainable and not torch.equal(p.detach().cpu(), before[n])]
    # B starts at 0, so A's gradient is 0 at step 1: every B moves at step 1
    # and no A (weight decay at lr 1e-4 moves A by 1e-8, below half an f32
    # ulp); at step 2 every A moves
    b_still = [n for n in start if not snapshots[0][n]["B"].any()]
    a_early = [n for n in start if not torch.equal(snapshots[0][n]["A"], start[n])]
    a_still = [n for n in start if torch.equal(snapshots[1][n]["A"], start[n])]
    log(f"  frozen tensors changed: {len(frozen_changed)} of {len(before)}; adapters whose B "
        f"moved at step 1: {len(start) - len(b_still)} of {len(start)}, whose A moved at step 1: "
        f"{len(a_early)}, at step 2: {len(start) - len(a_still)}")
    if frozen_changed or b_still or a_early or a_still:
        raise AssertionError(f"Wan training: frozen tensors changed {frozen_changed[:5]}, B that "
                             f"did not move {b_still[:5]}, A that moved early {a_early[:5]} or "
                             f"not at step 2 {a_still[:5]}")
    # the merge rounds W + delta to bf16: a delta below half an ulp of W is lost
    with torch.no_grad():
        kept = sum(int((model.get_submodule(n).merged_weight() != params[f"{n}.weight"]).sum())
                   for n in trainer.lora)
    total = sum(params[f"{n}.weight"].numel() for n in trainer.lora)
    log(f"  after step {TRAIN_STEPS}: {kept} of {total} adapted weight elements "
        f"({kept / total:.4f}) differ from the frozen base once merged in bf16")
    del trainer, model, params, before, snapshots, start
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches["flash_bwd_d128"]


def build_kernels():
    """One nvcc per source, all started together; ptxas's registers and
    spills per kernel, from the compilers' logs."""
    from vap_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s -> "
        f"{[os.path.relpath(p, HERE) for p in libs.values()]}")
    for lib in libs.values():
        kernel_name = "?"
        for line in lib.with_suffix(".log").read_text().splitlines():
            # the mangled name, and its template arguments if any
            found = re.search(r"\d+([a-z0-9_]+_kernel)(?:I(\w*?)EEv)?", line)
            if "Compiling entry function" in line and found:
                kernel_name = found[1] + (f"<{found[2]}>" if found[2] else "")
            elif "registers" in line or "spill stores" in line:
                log(f"  ptxas {kernel_name}: {line.replace('ptxas info    :', '').strip()}")


def main():
    import gc

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

    if not os.path.abspath(vap_tpu_torch.__file__).startswith(HERE + os.sep):
        raise SystemExit(f"chip_smoke: vap_tpu_torch comes from {vap_tpu_torch.__file__}, "
                         f"not from this checkout")
    t_start = time.perf_counter()

    # 2. build
    build_kernels()

    # 3. kernel parity
    log("kernel parity (bf16, vs plain PyTorch):")
    results = kernel_parity(dev)
    log("W8A8 (K3) parity (vs plain PyTorch):")
    results["w8a8"] = w8a8_parity(dev)
    log("GEMM rate probe (K9, K10) parity (vs plain PyTorch):")
    results.update(probe_parity(dev))
    log("the rate probe's entry point (linear_bench --impl diag):")
    launches = rate_probe_path()

    # 4-5. CogVideoX
    log("small pipeline check:")
    small_pipeline_check(dev)
    log("small W8A8 pipeline check (DPM, adaptive step cache):")
    small_w8a8_check(dev)
    pipe = build_main_pipeline(dev)
    log(f"main path, flash ({NUM_FRAMES} frames, {STEPS} steps):")
    launches["flash_fwd"] = main_path(pipe, "flash", STEPS, dev)
    log(f"main path, sage ({NUM_FRAMES} frames, 1 step):")
    launches["sage_fwd"] = main_path(pipe, "sage", 1, dev)
    log(f"bench configuration, sage + W8A8 ({NUM_FRAMES} frames, {BENCH_STEPS} steps, "
        f"step cache {BENCH_CACHE}):")
    launches["w8a8"] = bench_config_path(pipe, dev)
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
    del pipe
    gc.collect()
    torch.cuda.empty_cache()

    # 7. K5
    log("flash backward parity (bf16, vs plain PyTorch):")
    results["flash_bwd"] = backward_parity(dev)

    # 8. training
    log(f"training, CogVideoX-5B VAP ({NUM_FRAMES} frames of {HEIGHT}x{WIDTH}, batch 1, "
        f"{TRAIN_STEPS} optimizer steps):")
    launches["flash_bwd"] = training_path(dev)

    # 9. K6
    log("flash backward at head_dim 128 (K6) parity (bf16, vs plain PyTorch):")
    results["flash_bwd_d128"] = backward_parity(dev, d128=True)

    # 10. Wan LoRA training
    log(f"training, Wan2.1-I2V-14B LoRA ({NUM_FRAMES} frames of {WAN_HEIGHT}x{WAN_WIDTH}, "
        f"batch 1, {TRAIN_STEPS} optimizer steps):")
    launches["flash_bwd_d128"] = wan_training_path(dev)
    log(f"smoke: {time.perf_counter() - t_start:.1f} s after start-up")

    specs = {**kernel_specs(), **BWD_SPECS, **W8A8_SPECS}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": spec["source"], "replaces": spec["replaces"],
         "launches": launches[name], **results[name]} for name, spec in specs.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
