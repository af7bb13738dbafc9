"""Time the attention and GEMM kernels at their main-path shapes for several trees on one card.

    python -m vap_tpu_torch.scripts.attention_ab PARENT . . PARENT
    python -m vap_tpu_torch.scripts.attention_ab --d64 A B A B ...
    python -m vap_tpu_torch.scripts.attention_ab --sage A B B A ...
    python -m vap_tpu_torch.scripts.attention_ab --gemm A B B A ...
    python -m vap_tpu_torch.scripts.attention_ab --seg A B B A ...

Each root given is a checkout (or an unpacked archive) holding
``vap_tpu_torch/``; each is timed in its own process, in the order given,
so that two trees are compared in one call on one card (parent, change,
change, parent). A line per root: K4 (``flash_attention_forward``) and K2
(``flash_attention_int8_forward``) at Wan's joint shape [1, 40, 40560, 128];
K4 and K6 (``flash_attention_backward``) at Wan's cross shapes (20,280
queries x 512 and x 257 keys); K7 in K4 (given kv_lens) at HunyuanVideo
generation's [1, 24, 32656, 128] with 32,443 valid keys; K1 and K5 at
CogVideoX's [1, 48, 35552, 64]; K6 at Wan's training self-attention
[1, 40, 20280, 128]; K7's backward in K6 at HunyuanVideo training's
[1, 24, 18976, 128] with 18,763 valid keys (K8: ``--seg``). bf16, ms per
call over 5 calls after 2 of warm-up (20 at the cross shapes), with CUDA
events (the backward's delta pre-pass included). Then
the registers and spills ptxas gave the root's attention kernels (K1, K2,
K4, K5, K6, K8; K1 and K5 at head_dim 64 from their wgmma sources where
the root has them). With ``--d64`` only K1 and K5 at CogVideoX's shape are
timed, and only the head_dim-64 wgmma kernels' registers printed: a root
listed ten times in turns with another gives ten alternating pairs. With
``--sage`` only K2 (``flash_attention_int8_forward``, its pre-pass
included) is timed: at CogVideoX's [1, 48, 35552, 64], at Wan's joint
shape, at Wan's two cross shapes and, given kv_lens, at HunyuanVideo
generation's shape (K7 in K2); beside each, the pre-pass alone (the root's
``sage_prepass``, or the plain ``sage_quantize`` a root without it runs);
then K2's kernels' registers and spills and their conversion instructions
in the SASS (I2F and I2FP, by cuobjdump). With ``--gemm`` only the GEMM
kernels are timed: K3 (``int8_linear_chunk``) at the three projection
shapes of a CogVideoX CFG step ([35552, 3072] x [3072, 3072 | 12288],
[35552, 12288] x [12288, 3072]), bias included, its quantise pass and GEMM
apart (device time by kernel name under torch.profiler, the median of 5),
and K9 (``gemm_probe``) and K10 (``gemm_probe_t``) in int8 and bf16 at the
rate probe's (71168, 3072, 3072), 10 calls after 2; then the registers and
spills ptxas gave the root's GEMM kernels. With ``--seg`` only K8 is
timed, forward (``flash_attention_segmented_forward``) and backward
(``flash_attention_backward(segment_ids=)``, its delta pre-pass included),
at three packed streams: (a) CogVideoX's [1, 48, 35552, 64] as two segments
of 17,776 and 17,712 tokens and 64 of padding, (b) Wan's [1, 40, 40560,
128] as two halves, (c) HunyuanVideo training's [1, 24, 18976, 128] as one
segment of 18,763 tokens and 213 of padding; 5 calls after 2 (forward) and
3 after 1 (backward), each with its share of the bound over the
same-segment pairs (4 and 10 x H x D x pairs at 989 TFLOP/s; SDPA's masked
form, the yardstick, is timed by ``chip_smoke.py``, outside the port); then
the registers of the root's K8 kernels. The kernels are
built from each root's sources. It runs on the card and raises without one.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

SHAPE = (1, 40, 40560, 128)  # B, H, S, D of Wan2.1-14B's joint attention at 49f@480x832
K5_SHAPE = (1, 48, 35552, 64)  # CogVideoX-5B's joint attention at 49f@480x720
K6_SHAPE = (1, 40, 20280, 128)  # one Wan branch's self-attention in training
K7_SHAPE, K7_LEN = (1, 24, 18976, 128), 18763  # the Hunyuan LoRA stream and its valid keys
K7_FWD_SHAPE, K7_FWD_LEN = (1, 24, 32656, 128), 32443  # Hunyuan generation at 33f@720x1280
CROSS_KEYS = (512, 257)  # Wan's UMT5 and CLIP keys over one branch's 20,280 queries
W8A8_M = 2 * (226 + 13 * 30 * 45)  # the rows of a CogVideoX CFG step's projections
W8A8_SHAPES = ((3072, 3072), (3072, 12288), (12288, 3072))  # (K, N)
PROBE_SHAPE = (71168, 3072, 3072)  # M, K, N of the rate probe
# K8's packed streams: shape and segment lengths from token 0 (padding after)
SEG_CASES = {"a": (K5_SHAPE, (K5_SHAPE[2] // 2, K5_SHAPE[2] // 2 - 64)),
             "b": (SHAPE, (SHAPE[2] // 2, SHAPE[2] // 2)),
             "c": (K7_SHAPE, (K7_LEN,))}
PEAK_BF16 = 989e12  # H100 SXM dense bf16, FLOP/s


def time_root(root: str, d64: bool = False, sage: bool = False, gemm: bool = False,
              seg: bool = False) -> None:
    """Import the port under ``root`` and print its attention kernels' times
    (with ``d64``, K1's and K5's only; with ``sage``, K2's only; with
    ``gemm``, K3's, K9's and K10's instead; with ``seg``, K8's only)."""
    sys.path.insert(0, root)
    import torch

    import vap_tpu_torch

    if not os.path.abspath(vap_tpu_torch.__file__).startswith(root + os.sep):
        raise SystemExit(f"attention_ab: imported {vap_tpu_torch.__file__}, not the one under {root}")
    if not torch.cuda.is_available():
        raise SystemExit("attention_ab: no CUDA device; it times the card")
    from vap_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(shape, n=3):
        return [torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16) for _ in range(n)]

    def ms(fn, iters=5, warmup=2):
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

    if gemm:
        time_gemms(root, dev, gen, ms)
        return
    if seg:
        time_segmented(root, dev, inputs, ms)
        return
    if sage:
        prepass = getattr(fa, "sage_prepass", fa.sage_quantize)
        times = []
        for shape, lens in ((K5_SHAPE, None), (SHAPE, None),
                            *((K6_SHAPE[:2] + (n, K6_SHAPE[3]), None) for n in CROSS_KEYS),
                            (K7_FWD_SHAPE, K7_FWD_LEN)):
            q = inputs(K6_SHAPE if shape[2] in CROSS_KEYS else shape, 1)[0]
            k, v = inputs(shape, 2)
            n = None if lens is None else torch.tensor([lens], device=dev, dtype=torch.int32)
            iters = 20 if shape[2] in CROSS_KEYS else 5
            times.append((ms(lambda: fa.flash_attention_int8_forward(q, k, v, kv_lens=n), iters),
                          ms(lambda: prepass(q, k, q.shape[-1] ** -0.5, n), iters)))
            del q, k, v
        (d64_ms, d64_pre), (joint, joint_pre), *cross, (k7, k7_pre) = times
        cross_txt = ", ".join(f"x {n} keys {t:.3f} ms (pre-pass {p:.3f})"
                              for n, (t, p) in zip(CROSS_KEYS, cross))
        print(f"{root}: K2 {d64_ms:.3f} ms (pre-pass {d64_pre:.3f}) at {list(K5_SHAPE)}; "
              f"{joint:.3f} ms (pre-pass {joint_pre:.3f}) at {list(SHAPE)}; at {K6_SHAPE[2]} "
              f"queries {cross_txt}; K7 in K2 {k7:.3f} ms (pre-pass {k7_pre:.3f}) at "
              f"{list(K7_FWD_SHAPE)}, {K7_FWD_LEN} keys", flush=True)
        regs = {name: got for name, got in kernel_registers().items() if "sage" in name}
        print(f"{root}: K2 (ptxas) {regs}; SASS {sage_conversions()}", flush=True)
        return
    if d64:
        q, k, v, dout = inputs(K5_SHAPE, 4)
        k1 = ms(lambda: fa.flash_attention_forward(q, k, v))
        out, lse = fa.flash_attention_forward(q, k, v)
        k5 = ms(lambda: fa.flash_attention_backward(q, k, v, out, lse, dout))
        regs = {name: got for name, got in kernel_registers().items() if "_d64_" in name}
        print(f"{root}: K1 {k1:.3f} ms, K5 {k5:.3f} ms at {list(K5_SHAPE)}; ptxas {regs}",
              flush=True)
        return
    q, k, v = inputs(SHAPE)
    k4 = ms(lambda: fa.flash_attention_forward(q, k, v))
    k2 = ms(lambda: fa.flash_attention_int8_forward(q, k, v))
    del q, k, v
    cross_fwd, cross_bwd = [], []
    for skv in CROSS_KEYS:
        q, dout = inputs(K6_SHAPE, 2)
        k, v = inputs(K6_SHAPE[:2] + (skv, K6_SHAPE[3]), 2)
        cross_fwd.append(ms(lambda: fa.flash_attention_forward(q, k, v), iters=20))
        out, lse = fa.flash_attention_forward(q, k, v)
        cross_bwd.append(ms(lambda: fa.flash_attention_backward(q, k, v, out, lse, dout), iters=20))
        del q, k, v, dout, out, lse
    q, k, v = inputs(K7_FWD_SHAPE)
    lens = torch.tensor([K7_FWD_LEN], device=dev, dtype=torch.int32)
    k7_fwd = ms(lambda: fa.flash_attention_forward(q, k, v, kv_lens=lens))
    del q, k, v
    q, k, v = inputs(K5_SHAPE)
    k1 = ms(lambda: fa.flash_attention_forward(q, k, v))
    del q, k, v
    backward = []
    for shape in (K5_SHAPE, K6_SHAPE):
        q, k, v, dout = inputs(shape, 4)
        out, lse = fa.flash_attention_forward(q, k, v)
        backward.append(ms(lambda: fa.flash_attention_backward(q, k, v, out, lse, dout)))
        del q, k, v, dout, out, lse
    q, k, v, dout = inputs(K7_SHAPE, 4)
    lens = torch.tensor([K7_LEN], device=dev, dtype=torch.int32)
    out, lse = fa.flash_attention_forward(q, k, v, kv_lens=lens)
    k7 = ms(lambda: fa.flash_attention_backward(q, k, v, out, lse, dout, kv_lens=lens))
    del q, k, v, dout, out, lse
    cross = ", ".join(f"x {n} keys {f:.3f} / {b:.3f} ms"
                      for n, f, b in zip(CROSS_KEYS, cross_fwd, cross_bwd))
    print(f"{root}: K4 {k4:.3f} ms, K2 {k2:.3f} ms at {list(SHAPE)}; K1 {k1:.3f} ms, K5 "
          f"{backward[0]:.3f} ms at {list(K5_SHAPE)}; K6 {backward[1]:.3f} ms at "
          f"{list(K6_SHAPE)}; K4 / K6 at {K6_SHAPE[2]} queries {cross}; K7 in K4 {k7_fwd:.3f} ms "
          f"at {list(K7_FWD_SHAPE)}, {K7_FWD_LEN} keys; K7 backward in K6 {k7:.3f} ms at "
          f"{list(K7_SHAPE)}, {K7_LEN} keys", flush=True)
    print(f"{root}: attention kernels (ptxas): {kernel_registers()}", flush=True)


def time_segmented(root, dev, inputs, ms) -> None:
    """K8's forward and backward at SEG_CASES, each beside its bound over the
    same-segment pairs, then the registers of the root's K8 kernels."""
    import torch

    from vap_tpu_torch.ops import flash_attention as fa

    parts = []
    for case, (shape, lengths) in SEG_CASES.items():
        _, h, s, d = shape
        ids = torch.full((1, s), -1, dtype=torch.int32, device=dev)
        pos = 0
        for g, n in enumerate(lengths):
            ids[0, pos:pos + n] = g
            pos += n
        n = len(lengths)
        q, k, v, dout = inputs(shape, 4)
        dout = dout.masked_fill((ids < 0)[:, None, :, None], 0)
        out, lse = fa.flash_attention_segmented_forward(q, k, v, ids, ids, n)
        fwd = ms(lambda: fa.flash_attention_segmented_forward(q, k, v, ids, ids, n))
        bwd = ms(lambda: fa.flash_attention_backward(q, k, v, out, lse, dout,
                                                     segment_ids=(ids, ids, n)), 3, 1)
        pairs = sum(int((ids == g).sum()) ** 2 for g in range(n))
        f_bound, b_bound = (1e3 * c * h * d * pairs / PEAK_BF16 for c in (4, 10))
        parts.append(f"({case}) forward {fwd:.3f} ms ({100 * f_bound / fwd:.1f}% of "
                     f"{f_bound:.3f}), backward {bwd:.3f} ms ({100 * b_bound / bwd:.1f}% of "
                     f"{b_bound:.3f})")
        del q, k, v, dout, out, lse
        torch.cuda.empty_cache()
    print(f"{root}: K8 " + "; ".join(parts), flush=True)
    regs = {name: got for name, got in kernel_registers().items() if "seg" in name}
    print(f"{root}: K8 kernels (ptxas): {regs}", flush=True)


def device_ms(fn, iters, keys):
    """{key: device ms a call} of the kernel whose name holds each key (one
    launch a call), the median over ``iters`` calls of ``fn`` under
    torch.profiler after one warm-up: a mean let one slow launch in five
    read above the CUDA-event time of the whole call."""
    import statistics

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = {key: [] for key in keys}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            for key in keys:
                if key in evt.name:
                    times[key].append(evt.time_range.elapsed_us() / 1e3)
    return {key: statistics.median(got) if got else 0.0 for key, got in times.items()}


def time_gemms(root, dev, gen, ms) -> None:
    """K3 at the three projection shapes (its quantise pass and GEMM apart),
    K9 and K10 in int8 and bf16 at the probe's shape, and the registers of
    the root's GEMM kernels."""
    import torch

    from vap_tpu_torch.models.common import quantize_linear_int8
    from vap_tpu_torch.ops import gemm_probe as gp
    from vap_tpu_torch.ops import int8_matmul as ti8

    k3 = []
    for k, n in W8A8_SHAPES:
        x = (2 * torch.randn((W8A8_M, k), generator=gen, device=dev)).to(torch.bfloat16)
        w = (0.02 * torch.randn((n, k), generator=gen, device=dev)).to(torch.bfloat16)
        w_i8, s_w = quantize_linear_int8(w)
        b = torch.randn((n,), generator=gen, device=dev)
        total = ms(lambda: ti8.int8_linear_chunk(x, w_i8, s_w, b), iters=10)
        parts = device_ms(lambda: ti8.int8_linear_chunk(x, w_i8, s_w, b), 5,
                          ("w8a8_quantize", "w8a8_gemm"))
        k3.append(f"[{W8A8_M},{k}]x[{k},{n}] {total:.3f} ms (quantise {parts['w8a8_quantize']:.3f}"
                  f", GEMM {parts['w8a8_gemm']:.3f})")
        del x, w, w_i8, s_w, b
    m, k, n = PROBE_SHAPE
    probe = []
    for dtype in (torch.int8, torch.bfloat16):
        if dtype == torch.int8:
            x, w = (torch.randint(-128, 128, shape, generator=gen, device=dev, dtype=dtype)
                    for shape in ((m, k), (n, k)))
        else:
            x, w = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                    for shape in ((m, k), (n, k)))
        xt = x.T.contiguous()
        probe.append(f"K9 {str(dtype)[6:]} {ms(lambda: gp.gemm_probe(x, w), iters=10):.3f} ms, "
                     f"K10 {str(dtype)[6:]} {ms(lambda: gp.gemm_probe_t(xt, w), iters=10):.3f} ms")
        del x, w, xt
    print(f"{root}: K3 {'; '.join(k3)}; at {list(PROBE_SHAPE)} {'; '.join(probe)}", flush=True)
    print(f"{root}: GEMM kernels (ptxas): {kernel_registers(('w8a8', 'gemm_probe'))}", flush=True)


def kernel_registers(gemm_sources=()):
    """{kernel: {"registers": N, "spill": M}} of the root's attention
    kernels, as ptxas printed them: every instance of the backward sources
    and of the wgmma sources (K1 and K5 at head_dim 64, K4, K6; where the
    root has them), and the D=64 and D=128 instances (and the untemplated
    ones) of the others (K1's and K5's mma.sync forms, K2, K8). Given
    ``gemm_sources``, every kernel of those sources instead."""
    import re

    from vap_tpu_torch.ops import _build

    found = {}
    every = gemm_sources or ("flash_bwd_d128", "flash_fwd_sm90", "flash_bwd_sm90",
                             "flash_fwd_sm90_d64", "flash_bwd_sm90_d64", "sage_fwd_sm90",
                             "sage_fwd_sm90_d64")
    for source in (() if gemm_sources else ("flash_fwd", "sage_fwd", "flash_bwd")) + every:
        if source not in _build.SOURCES:  # a root from before this source
            continue
        name = None
        for line in _build.library_path(source).with_suffix(".log").read_text().splitlines():
            entry = re.search(r"\d+([a-z0-9_]+_kernel)(?:I(\w*?)EEv)?", line)
            if "Compiling entry function" in line and entry:
                name = entry[1] + (f"<{entry[2]}>" if entry[2] else "")
            elif name and (source in every or "<" not in name or "<Li64E" in name
                           or "<Li128E" in name):
                for key, pat in (("registers", r"Used (\d+) registers"),
                                 ("spill", r"(\d+) bytes spill stores")):
                    hit = re.search(pat, line)
                    if hit:
                        found.setdefault(name, {})[key] = int(hit[1])
    return found


def sage_conversions():
    """{kernel: {op: count}} of the int32 -> f32 conversions (I2F, and I2FP,
    which ptxas may emit for it) and the ex2 (MUFU.EX2) in the SASS of the
    root's K2 kernels, by cuobjdump."""
    import re
    import shutil

    from vap_tpu_torch.ops import _build

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    found = {}
    for source in ("sage_fwd", "sage_fwd_sm90", "sage_fwd_sm90_d64"):
        if source not in _build.SOURCES:
            continue
        sass = subprocess.run([cuobjdump, "-sass", str(_build.library_path(source))],
                              capture_output=True, text=True, check=True).stdout
        for body in re.split(r"\n\s*Function : ", sass)[1:]:
            name = re.search(r"([a-z0-9_]+_kernel)(?:I(\w*?)EEv)?", body.split("\n", 1)[0])
            found[name[1] + (f"<{name[2]}>" if name[2] else "")] = {
                op: len(re.findall(rf"\b{op}[.\s]", body)) for op in ("I2F", "I2FP", "MUFU.EX2")}
    return found


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("roots", nargs="+", help="checkouts holding vap_tpu_torch/, in order")
    parser.add_argument("--one", action="store_true", help="time the single root in this process")
    parser.add_argument("--d64", action="store_true",
                        help="time only K1 and K5 at head_dim 64 (their wgmma kernels' registers)")
    parser.add_argument("--sage", action="store_true",
                        help="time only K2, with its pre-pass apart (its kernels' registers and "
                             "conversions)")
    parser.add_argument("--gemm", action="store_true",
                        help="time only K3 (its quantise pass apart), K9 and K10 (their kernels' "
                             "registers)")
    parser.add_argument("--seg", action="store_true",
                        help="time only K8, forward and backward, at three packed streams")
    args = parser.parse_args(argv)
    if args.one:
        time_root(os.path.abspath(args.roots[0]), args.d64, args.sage, args.gemm, args.seg)
        return
    for root in args.roots:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", os.path.abspath(root)]
                       + ["--d64"] * args.d64 + ["--sage"] * args.sage + ["--gemm"] * args.gemm
                       + ["--seg"] * args.seg, check=True)


if __name__ == "__main__":
    main()
