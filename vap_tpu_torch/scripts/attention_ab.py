"""Time the attention kernels at their main-path shapes for several trees on one card.

    python -m vap_tpu_torch.scripts.attention_ab PARENT . . PARENT

Each root given is a checkout (or an unpacked archive) holding
``vap_tpu_torch/``; each is timed in its own process, in the order given,
so that two trees are compared in one call on one card (parent, change,
change, parent). A line per root: K4 (``flash_attention_forward``) and K2
(``flash_attention_int8_forward``) at Wan's joint shape [1, 40, 40560, 128],
K1 (``flash_attention_forward``) and K5 (``flash_attention_backward``) at
CogVideoX's [1, 48, 35552, 64] and K6 at Wan's training self-attention
[1, 40, 20280, 128], bf16, ms per call over 5 calls after 2 of warm-up,
with CUDA events (the backward's delta pre-pass included). The kernels are
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


def time_root(root: str) -> None:
    """Import the port under ``root`` and print K4's, K2's, K1's, K5's and K6's times."""
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

    q, k, v = inputs(SHAPE)

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

    k4 = ms(lambda: fa.flash_attention_forward(q, k, v))
    k2 = ms(lambda: fa.flash_attention_int8_forward(q, k, v))
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
    k8 = []
    if hasattr(fa.flash_attention_backward, "launches_seg"):  # the root has K8's backward
        for shape, lengths in ((K5_SHAPE, (K5_SHAPE[2] // 2, K5_SHAPE[2] // 2 - 64)),
                               (SHAPE, (SHAPE[2] // 2, SHAPE[2] // 2))):
            ids = torch.full((1, shape[2]), -1, dtype=torch.int32, device=dev)
            ids[0, :lengths[0]] = 0
            ids[0, lengths[0]:sum(lengths)] = 1
            q, k, v, dout = inputs(shape, 4)
            out, lse = fa.flash_attention_segmented_forward(q, k, v, ids, ids, 2)
            calls = (3, 1) if shape == SHAPE else (5, 2)
            k8.append(ms(lambda: fa.flash_attention_backward(q, k, v, out, lse, dout,
                                                             segment_ids=(ids, ids, 2)), *calls))
            del q, k, v, dout, out, lse
    seg = (f"; K8 backward {k8[0]:.3f} ms at {list(K5_SHAPE)}, {k8[1]:.3f} ms at {list(SHAPE)}"
           if k8 else "; K8 backward: not in this root")
    print(f"{root}: K4 {k4:.3f} ms, K2 {k2:.3f} ms at {list(SHAPE)}; K1 {k1:.3f} ms, K5 "
          f"{backward[0]:.3f} ms at {list(K5_SHAPE)}; K6 {backward[1]:.3f} ms at "
          f"{list(K6_SHAPE)}; K7 backward in K6 {k7:.3f} ms at {list(K7_SHAPE)}, {K7_LEN} keys"
          + seg, flush=True)
    print(f"{root}: backward instances (ptxas): {backward_registers()}", flush=True)


def backward_registers():
    """{kernel: 'N registers, M bytes spill stores'} of every instance in the
    backward sources' compiler logs (K5 at D=64, K6), as ptxas printed them."""
    import re

    from vap_tpu_torch.ops import _build

    found = {}
    for source in ("flash_bwd", "flash_bwd_d128"):
        name = None
        for line in _build.library_path(source).with_suffix(".log").read_text().splitlines():
            entry = re.search(r"\d+([a-z0-9_]+_kernel)(?:I(\w*?)EEv)?", line)
            if "Compiling entry function" in line and entry:
                name = entry[1] + (f"<{entry[2]}>" if entry[2] else "")
            elif name and (source == "flash_bwd_d128" or "<Li64E" in name):
                for key, pat in (("registers", r"Used (\d+) registers"),
                                 ("spill", r"(\d+) bytes spill stores")):
                    hit = re.search(pat, line)
                    if hit:
                        found.setdefault(name, {})[key] = int(hit[1])
    return found


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("roots", nargs="+", help="checkouts holding vap_tpu_torch/, in order")
    parser.add_argument("--one", action="store_true", help="time the single root in this process")
    args = parser.parse_args(argv)
    if args.one:
        time_root(os.path.abspath(args.roots[0]))
        return
    for root in args.roots:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", os.path.abspath(root)],
                       check=True)


if __name__ == "__main__":
    main()
