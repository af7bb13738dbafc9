"""The port's attention kernels and their plain PyTorch versions.

K1 and K4 ``flash_attention_forward``: non-causal softmax(Q K^T * scale) V
with the natural-log lse, bf16. Head_dim < 128 launches K1, the forward of
``vap_tpu/ops/flash_attention.py`` ``flash_attention`` at D < 128
(``_flash_attention_forward_t``); head_dim 128 launches K4, its row-layout
forward at D >= 128 (``_flash_attention_forward``). K1 at head_dim 64 (the
main path's) and K4 are warp-specialised ``wgmma`` kernels fed by TMA,
``csrc/flash_fwd_sm90_d64.cu`` and ``csrc/flash_fwd_sm90.cu``; K1 at the
other head dims an ``mma.sync`` kernel templated on head_dim,
``csrc/flash_fwd.cu``; one entry point each (``kernel_entry``).

K2 ``flash_attention_int8_forward``: the SageAttention-style forward of
``flash_attention_int8`` (``_flash_attention_forward_t_i8``): K smoothing,
symmetric int8 Q and K with one scale per (b, h), int8 Q K^T with int32
accumulation, scores in the log2 domain, bf16 P V. On the card the
quantisation pre-pass is a kernel of its own (``sage_prepass``,
``csrc/sage_quant.cu``; plain: ``sage_quantize``), then the forward: at
head_dim 64 and 128 (the main paths') warp-specialised kernels with an int8
``wgmma`` Q K^T fed by TMA, ``csrc/sage_fwd_sm90_d64.cu`` and
``csrc/sage_fwd_sm90.cu``; at 32 and 96 an ``mma.sync`` kernel,
``csrc/sage_fwd.cu`` (``sage_entry``).

K5 and K6 ``flash_attention_backward``: the gradient of the forward's
function from its out and lse: P recomputed from the lse, delta =
rowsum(out * dout), then dq, and dk and dv, each summed inside one block.
Head_dim < 128 launches K5 (``_flash_attention_backward_t``: at head_dim
64 two warp-specialised ``wgmma`` kernels fed by TMA, dk/dv then dq, no
atomics, ``csrc/flash_bwd_sm90_d64.cu``; at the other head dims
``mma.sync`` kernels, ``csrc/flash_bwd.cu``); head_dim 128 launches K6, the
row-layout backward
(``_flash_attention_backward``, ``csrc/flash_bwd_sm90.cu``: a q * scale
pre-pass and two warp-specialised ``wgmma`` kernels fed by TMA, dk/dv then
dq, no atomics), which rounds q * scale to bf16 before q k^T and works in
the natural base. Head_dim above 128 raises. ``FlashAttentionFunction``
pairs the forward and the backward as an autograd function (the JAX
``custom_vjp`` pair ``_fa_fwd`` / ``_fa_bwd``); ``flash_attention`` goes
through it whenever a gradient is wanted.

Layout: q [B, H, Sq, D], k and v [B, H, Skv, D]; out [B, H, Sq, D] in the
input dtype, lse [B, H, Sq] float32.

K7, the varlen attention (``flash_attention_varlen`` and
``flash_attention_int8(kv_lens=)``): the kernels above given ``kv_lens``,
a [B] integer tensor; sample b attends only keys [0, kv_lens[b]) (suffix
padding, what a right-padded text mask leaves; queries are never masked).
The forwards stop their key loop there and never load the keys past it; the
running max starts at a floor of -1e4 nats, so a sample with no valid key
gets exact zero rows and the lse -1e4 (``flash_attention.py:154-158``).
Its backward (``_fav_bwd``, :1499) is K5 and K6 given ``kv_lens``: dq of
every query row from its sample's valid keys only (0 for a sample with
none), and exact zeros in the dk and dv rows past each length.

K8, the packed-segment attention (``flash_attention_segmented``, :1539):
K1's and K4's kernel given ``q_segment_ids`` [B, Sq] and ``kv_segment_ids``
[B, Skv] integer ids and ``num_segments``; query i attends key j iff their
ids are equal. At head_dim 64 and 128 the instances of the ``wgmma``
kernels of K1 and K4 (K5 and K6 for the backward) with whole-tile skipping:
a block walks only the run of tiles whose id ranges meet its own
(``segment_tiles_kept``, ``segment_tile_span``), and compares ids per score
only in a tile pair that holds more than one id; at the other head dims the
``mma.sync`` kernels, which score every tile. Ids outside [0,
num_segments) are padding (mapped to -1): padding keys are masked from
every in-range query, padding queries' outputs are unspecified but finite.
The running max starts at K7's floor, so a query whose segment has no key
gets exact zero rows and the lse -1e4. A
cross-segment key adds exactly 0, so one segment's outputs do not move,
to the bit, when another segment's q, k or v change (to finite values).
Its backward (``_fas_bwd``, :1581) is K5 and K6 given the same ids: every
cross-segment pair gets p = 0 by a select, so one segment's gradients do
not move, to the bit, when another segment changes, and a query whose
segment has no key gets dq = 0. ``FlashAttentionSegmentedFunction`` pairs
the two.

Each wrapper runs its kernel for CUDA tensors and its plain version for CPU
tensors; on any other device, or on inputs the kernel does not take, it
raises. Each kernel counts its launches on its wrapper:
``flash_attention_forward.launches_d64`` (K1 at head_dim 64),
``flash_attention_forward.launches`` (K1 at the other head dims below 128),
``flash_attention_forward.launches_d128`` (K4),
``flash_attention_forward.launches_d64_varlen`` (K7 in K1 at head_dim 64),
``flash_attention_forward.launches_varlen`` (K7 in K1 at the other head
dims below 128),
``flash_attention_forward.launches_d128_varlen`` (K7 in K4),
``flash_attention_segmented_forward.launches_d64`` (K8 in K1 at head_dim
64), ``flash_attention_segmented_forward.launches`` (K8 in K1 at the other
head dims below 128), ``flash_attention_segmented_forward.launches_d128``
(K8 in K4),
``flash_attention_int8_forward.launches`` (K2 at head_dim 64 and 128),
``flash_attention_int8_forward.launches_mma`` (K2 at 32 and 96),
``flash_attention_int8_forward.launches_varlen`` (K7 in K2 at 64 and 128),
``flash_attention_int8_forward.launches_mma_varlen`` (K7 in K2 at 32 and
96), ``sage_prepass.launches`` (K2's pre-pass),
``flash_attention_backward.launches_d64`` (K5 at head_dim 64),
``flash_attention_backward.launches`` (K5 at the other head dims below
128),
``flash_attention_backward.launches_d128`` (K6),
``flash_attention_backward.launches_d64_varlen`` (K7's backward in K5 at
head_dim 64),
``flash_attention_backward.launches_varlen`` (K7's backward in K5 at the
other head dims below 128),
``flash_attention_backward.launches_d128_varlen`` (K7's backward in K6),
``flash_attention_backward.launches_d64_seg`` (K8's backward in K5 at
head_dim 64), ``flash_attention_backward.launches_seg`` (K8's backward in
K5 at the other head dims below 128) and
``flash_attention_backward.launches_d128_seg`` (K8's backward in K6).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch

from . import _build

LOG2_E = 1.4426950408889634
LN_2 = 0.6931471805599453
# masked-score value of the TPU kernels (finite, so no inf - inf arises)
NEG_INF = -1e30
# K7's floor of the running max, -1e4 nats (flash_attention.py:154-158): the
# lse of a sample with no valid key (K8: of a query whose segment has no key),
# and the same in the log2 domain the kernels work in
VARLEN_FLOOR_LSE = -1e4
VARLEN_FLOOR_LOG2 = VARLEN_FLOOR_LSE * LOG2_E
# keys per tile of the plain versions: bounds their score buffer to
# [B, H, Sq, PLAIN_BLOCK_K], so they also run at the main-path length
PLAIN_BLOCK_K = 512
# grid.y of the CUDA launch indexes B*H
_MAX_BH = 65535


def _shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"q, k, v must be [B, H, S, D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, _, d = q.shape
    if k.shape[:2] != (b, h) or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")


def _kv_lens(kv_lens: Optional[torch.Tensor], batch: int) -> Optional[torch.Tensor]:
    """Check K7's ``kv_lens``: None, or a [B] integer tensor."""
    if kv_lens is None:
        return None
    if not isinstance(kv_lens, torch.Tensor) or kv_lens.shape != (batch,) \
            or kv_lens.dtype.is_floating_point or kv_lens.dtype == torch.bool:
        raise ValueError(f"kv_lens must be a [B] = [{batch}] integer tensor, got "
                         f"{getattr(kv_lens, 'dtype', type(kv_lens))} "
                         f"{tuple(getattr(kv_lens, 'shape', ()))}")
    return kv_lens


def _valid_key_counts(kv_lens: torch.Tensor, skv: int):
    """Each sample's valid key count, min(kv_lens[b], Skv) clamped at 0, as
    Python ints (``_varlen_valid``, :42; a host read)."""
    return [max(0, min(int(n), skv)) for n in kv_lens.tolist()]


def _kernel_inputs(name: str, tensors: dict, dtypes: dict, bh: int, sq: int) -> None:
    """Raise unless every tensor is a contiguous, 16-byte-aligned CUDA tensor
    of the expected dtype on one device, with a grid the kernel can launch."""
    device = next(iter(tensors.values())).device
    for arg, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {device}")
        if t.dtype != dtypes[arg]:
            raise ValueError(f"{name}: {arg} must be {dtypes[arg]}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")
    if sq < 1 or bh < 1 or bh > _MAX_BH:
        raise ValueError(f"{name}: needs Sq >= 1 and 1 <= B*H <= {_MAX_BH}, "
                         f"got Sq={sq}, B*H={bh}")


def _device_kind(name: str, q: torch.Tensor) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: tensors on {q.device} are not supported")
    return q.device.type


# ---------------------------------------------------------------------------
# plain versions: the same tile recurrence as the kernels, in PyTorch
# ---------------------------------------------------------------------------

def softmax_tile_update(m, l, acc, s, v_tile):
    """One kv tile of the running-max online softmax, as the kernels run it.

    m, l: [..., Sq, 1] f32 running max (log2 domain) and denominator;
    acc: [..., Sq, D] f32 numerator; s: [..., Sq, n] f32 log2-domain scores
    (masked keys at NEG_INF); v_tile: [..., n, D]. P is rounded to v's dtype
    before both the P V product and the row sum, as in the kernels.
    """
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    alpha = torch.exp2(m - m_new)
    p = torch.exp2(s - m_new).to(v_tile.dtype).float()
    l = l * alpha + p.sum(dim=-1, keepdim=True)
    acc = acc * alpha + p @ v_tile.float()
    return m_new, l, acc


def softmax_finalize(m, l, acc, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalise with the TPU kernels' ``l == 0 -> 1`` guard; natural-log lse."""
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (acc / l_safe).to(dtype)
    lse = (LN_2 * (m + torch.log2(l_safe))).squeeze(-1)
    return out, lse


def _online_softmax_plain(scores, v: torch.Tensor, sq: int, m_init: float = NEG_INF):
    """Tile loop over the keys of ``v``; ``scores(n0, n1)`` gives log2-domain
    f32 scores; the running max starts at ``m_init``."""
    lead, d, skv = v.shape[:-2], v.shape[-1], v.shape[-2]
    m = torch.full((*lead, sq, 1), m_init, dtype=torch.float32, device=v.device)
    l = torch.zeros((*lead, sq, 1), dtype=torch.float32, device=v.device)
    acc = torch.zeros((*lead, sq, d), dtype=torch.float32, device=v.device)
    for n0 in range(0, skv, PLAIN_BLOCK_K):
        n1 = min(n0 + PLAIN_BLOCK_K, skv)
        m, l, acc = softmax_tile_update(m, l, acc, scores(n0, n1), v[..., n0:n1, :])
    return softmax_finalize(m, l, acc, v.dtype)


def _varlen_plain(run, kv_lens: torch.Tensor, skv: int):
    """K7's plain form: ``run(b, n)`` gives sample b's (out, lse) over its
    first n valid keys only, with the running max floored; concatenated."""
    outs = [run(b, n) for b, n in enumerate(_valid_key_counts(kv_lens, skv))]
    return torch.cat([o for o, _ in outs]), torch.cat([l for _, l in outs])


def flash_attention_forward_plain(q, k, v, scale: Optional[float] = None,
                                  kv_lens: Optional[torch.Tensor] = None):
    """Plain PyTorch version of K1 and K4, and with ``kv_lens`` of K7:
    returns (out, lse). With ``kv_lens`` each sample runs over its valid
    keys only (a suffix of NaN changes nothing), from the floored max."""
    _shapes(q, k, v)
    kv_lens = _kv_lens(kv_lens, q.shape[0])
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qf = q.float()
    scale_log2 = scale * LOG2_E

    def run(b: slice, n: int, m_init: float):
        def scores(n0, n1):
            return (qf[b] @ k[b, :, n0:n1].float().transpose(-1, -2)) * scale_log2

        return _online_softmax_plain(scores, v[b, :, :n], q.shape[2], m_init)

    if kv_lens is None:
        return run(slice(None), k.shape[2], NEG_INF)
    return _varlen_plain(lambda b, n: run(slice(b, b + 1), n, VARLEN_FLOOR_LOG2), kv_lens,
                         k.shape[2])


def check_segment_args(q, k, q_segment_ids, kv_segment_ids, num_segments) -> None:
    """K8's argument checks (``_check_segment_args``, :1524-1536)."""
    if not isinstance(num_segments, int) or isinstance(num_segments, bool) or num_segments < 1:
        raise ValueError(f"num_segments must be a static positive int, got {num_segments!r}")
    for name, ids, x, s in (("q_segment_ids", q_segment_ids, q, "Sq"),
                            ("kv_segment_ids", kv_segment_ids, k, "Skv")):
        want = (x.shape[0], x.shape[2])
        if not isinstance(ids, torch.Tensor) or tuple(ids.shape) != want:
            raise ValueError(f"{name} must be [B, {s}] = {want}, got "
                             f"{tuple(getattr(ids, 'shape', ())) or type(ids).__name__}")
    for ids in (q_segment_ids, kv_segment_ids):
        if ids.dtype.is_floating_point or ids.dtype.is_complex or ids.dtype == torch.bool:
            raise ValueError(f"segment ids must be integer tensors, got {ids.dtype}")


def segment_ids_int32(ids: torch.Tensor, num_segments: int, device) -> torch.Tensor:
    """K8's ids as the kernel takes them: int32 on ``device``, contiguous,
    every id outside [0, num_segments) mapped to -1 (padding)."""
    in_range = (ids >= 0) & (ids < num_segments)
    return torch.where(in_range, ids, -1).to(device, torch.int32).contiguous()


# rows per entry of the wgmma kernels' segment-range tables (sm90.cuh,
# kSegChunk): each tile's least and largest id over its rows below S, with
# padding (-1) counted as SEGMENT_PAD, after every segment id, so that a
# packed stream's padded tail does not widen its last tile's range to -1
SEGMENT_CHUNK = 64
SEGMENT_PAD = 2 ** 31 - 2
# (rows of a block, rows of each tile it walks) of K8's wgmma kernels, by
# head_dim and kernel: the forward's and the dq kernel's query block and key
# tiles, the dk/dv kernel's key block and query tiles
SEGMENT_TILES = {(64, "fwd"): (192, 128), (128, "fwd"): (128, 128),
                 (64, "dq"): (128, 128), (128, "dq"): (128, 64),
                 (64, "dkv"): (128, 64), (128, "dkv"): (128, 64)}


def segment_tile_ranges(ids: torch.Tensor, rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi), each [B, ceil(S / rows)]: the least and the largest id of
    each tile of ``rows`` rows of the [B, S] ids (as the kernel takes them,
    padding -1 counted as SEGMENT_PAD), over its rows below S; a tile with
    no row has lo > hi."""
    b, s = ids.shape
    n = -(-s // rows)
    x = torch.where(ids < 0, SEGMENT_PAD, ids.to(torch.int64))
    big = 2 ** 40
    pad = n * rows - s
    lo = torch.nn.functional.pad(x, (0, pad), value=big).reshape(b, n, rows).amin(-1)
    hi = torch.nn.functional.pad(x, (0, pad), value=-big).reshape(b, n, rows).amax(-1)
    return lo, hi


def segment_tiles_kept(block_ids: torch.Tensor, tile_ids: torch.Tensor, block_rows: int,
                       tile_rows: int) -> torch.Tensor:
    """K8's tile rule: [B, ceil(Sb / block_rows), ceil(St / tile_rows)] bool,
    whether the id ranges of a block of ``block_ids`` and a tile of
    ``tile_ids`` meet. Only such a pair can hold two equal ids; every other
    pair is neither loaded nor scored."""
    blo, bhi = segment_tile_ranges(block_ids, block_rows)
    tlo, thi = segment_tile_ranges(tile_ids, tile_rows)
    return (blo[:, :, None] <= thi[:, None, :]) & (tlo[:, None, :] <= bhi[:, :, None])


def segment_tile_span(block_ids: torch.Tensor, tile_ids: torch.Tensor, block_rows: int,
                      tile_rows: int) -> torch.Tensor:
    """The tiles a block of K8's wgmma kernels walks (the same shape as
    ``segment_tiles_kept``): the run from its first kept tile to its last,
    none if none is kept. For sorted ids that is exactly the kept tiles; for
    unsorted ids a tile inside the run that meets no id is walked too, its
    scores all selected out."""
    kept = segment_tiles_kept(block_ids, tile_ids, block_rows, tile_rows)
    idx = torch.arange(kept.shape[-1], device=kept.device)
    first = torch.where(kept, idx, kept.shape[-1]).amin(-1, keepdim=True)
    last = torch.where(kept, idx, -1).amax(-1, keepdim=True)
    return (idx >= first) & (idx <= last)


def segment_walk_rounds(block_ids: torch.Tensor, tile_ids: torch.Tensor, block_rows: int,
                        tile_rows: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """``segment_tile_span`` by rows, for a check that poisons what a K8
    kernel must not read: a list of rounds (blocks [B, Sb], skipped [B, St]),
    bool. In a round each sample's ``blocks`` rows are those of blocks that
    walk one and the same run of tiles, and its ``skipped`` rows those of
    the tiles that run leaves out. A block that walks every tile is in no
    round; a sample has rows in as many rounds as it has such runs."""
    span = segment_tile_span(block_ids, tile_ids, block_rows, tile_rows)
    groups = []
    for walks in span:  # per sample: (blocks, tiles skipped) of each run that skips a tile
        runs, which = torch.unique(walks, dim=0, return_inverse=True)
        groups.append([(which == g, ~run) for g, run in enumerate(runs) if not run.all()])
    rounds = []
    for r in range(max(map(len, groups), default=0)):
        blocks = torch.zeros(block_ids.shape, dtype=torch.bool, device=block_ids.device)
        skipped = torch.zeros(tile_ids.shape, dtype=torch.bool, device=tile_ids.device)
        for i, sample in enumerate(groups):
            if r < len(sample):
                blocks[i] = sample[r][0].repeat_interleave(block_rows)[:block_ids.shape[1]]
                skipped[i] = sample[r][1].repeat_interleave(tile_rows)[:tile_ids.shape[1]]
        rounds.append((blocks, skipped))
    return rounds


# K8's wgmma entries whose tile sizes SEGMENT_TILES repeats, by head_dim:
# (forward source, its entry), (backward source, its entry)
_SEGMENT_TILE_ENTRIES = {
    64: (("flash_fwd_sm90_d64", "vap_flash_fwd_d64_seg_tiles"),
         ("flash_bwd_sm90_d64", "vap_flash_bwd_d64_seg_tiles")),
    128: (("flash_fwd_sm90", "vap_flash_fwd_d128_seg_tiles"),
          ("flash_bwd_sm90", "vap_flash_bwd_d128_seg_tiles")),
}


def segment_tiles_built() -> Dict[Tuple[int, str], Tuple[int, int]]:
    """SEGMENT_TILES as the built K8 kernels give it (their ``*_seg_tiles``
    entries): the card's own block and tile sizes. Builds the kernels."""
    tiles = {}
    for d, ((fwd_src, fwd), (bwd_src, bwd)) in _SEGMENT_TILE_ENTRIES.items():
        rows = (ctypes.c_int * 4)()
        _build.check(getattr(_build.library(fwd_src), fwd)(rows), fwd)
        tiles[(d, "fwd")] = (rows[0], rows[1])
        _build.check(getattr(_build.library(bwd_src), bwd)(rows), bwd)
        tiles[(d, "dq")], tiles[(d, "dkv")] = (rows[0], rows[1]), (rows[2], rows[3])
    return tiles


def _segment_scratch(b: int, sq: int, skv: int, device) -> torch.Tensor:
    """The range tables' scratch of a wgmma K8 entry: B * (ceil(Sq / 64) +
    ceil(Skv / 64)) int2, as int32."""
    chunks = -(-sq // SEGMENT_CHUNK) + -(-skv // SEGMENT_CHUNK)
    return torch.empty(2 * b * max(chunks, 1), dtype=torch.int32, device=device)


def flash_attention_segmented_forward_plain(q, k, v, q_segment_ids, kv_segment_ids,
                                            num_segments: int, scale: Optional[float] = None):
    """Plain PyTorch version of K8: (out, lse). The tile loop of K1 and K4
    with every score whose query and key ids differ selected to NEG_INF, and
    the running max starting at K7's floor."""
    _shapes(q, k, v)
    check_segment_args(q, k, q_segment_ids, kv_segment_ids, num_segments)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    q_ids = segment_ids_int32(q_segment_ids, num_segments, q.device)
    kv_ids = segment_ids_int32(kv_segment_ids, num_segments, q.device)
    qf = q.float()
    scale_log2 = scale * LOG2_E

    def scores(n0, n1):
        s = (qf @ k[:, :, n0:n1].float().transpose(-1, -2)) * scale_log2
        same = q_ids[:, None, :, None] == kv_ids[:, None, None, n0:n1]  # [B, 1, Sq, n]
        return torch.where(same, s, NEG_INF)

    return _online_softmax_plain(scores, v, q.shape[2], VARLEN_FLOOR_LOG2)


def attention_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """rowsum(out * dout) [B, H, Sq] in float32, from the saved ``out``
    (the pre-pass of ``_flash_attention_backward_t``, :1153)."""
    return torch.linalg.vecdot(out.float(), dout.float())


def _varlen_backward_plain(run, q, k, v, out, lse, dout, scale, kv_lens):
    """K7's backward in plain form: ``run`` (a fixed-length plain backward)
    on each sample over its first n valid keys only, so a NaN past them
    reaches nothing; dk and dv rows past n are exact zeros."""
    dq, dk, dv = torch.empty_like(q), torch.zeros_like(k), torch.zeros_like(v)
    for b, n in enumerate(_valid_key_counts(kv_lens, k.shape[2])):
        s = slice(b, b + 1)
        g = run(q[s], k[s, :, :n], v[s, :, :n], out[s], lse[s], dout[s], scale)
        dq[b], dk[b, :, :n], dv[b, :, :n] = g[0][0], g[1][0], g[2][0]
    return dq, dk, dv


def _backward_plain_t(q, k, v, out, lse, dout, scale, keep=None):
    """K5's log2-form tile loop (see ``flash_attention_backward_plain``);
    ``keep(n0, n1)`` gives a [B, 1, Sq, n] bool of the query-key pairs that
    count (K8), every other p selected to 0."""
    scale_log2 = scale * LOG2_E
    qf, dof = q.float(), dout.float()
    lse2 = (lse.float() * LOG2_E)[..., None]
    delta = attention_delta(out, dout)[..., None]
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for n0 in range(0, k.shape[2], PLAIN_BLOCK_K):
        n1 = min(n0 + PLAIN_BLOCK_K, k.shape[2])
        kt, vt = k[..., n0:n1, :].float(), v[..., n0:n1, :].float()
        p = torch.exp2(qf @ kt.transpose(-1, -2) * scale_log2 - lse2)
        if keep is not None:
            p = torch.where(keep(n0, n1), p, 0.0)
        ds = (p * (dof @ vt.transpose(-1, -2) - delta)).to(k.dtype).float()
        dq += ds @ kt
        dvs.append(p.to(dout.dtype).float().transpose(-1, -2) @ dof)
        dks.append(ds.transpose(-1, -2) @ qf * scale)
    if not dks:  # no key: dk and dv are empty
        return (dq * scale).to(q.dtype), torch.zeros_like(k), torch.zeros_like(v)
    return ((dq * scale).to(q.dtype), torch.cat(dks, dim=2).to(k.dtype),
            torch.cat(dvs, dim=2).to(v.dtype))


def _backward_plain_rows(q, k, v, out, lse, dout, scale, keep=None):
    """K6's row-form tile loop (see ``flash_attention_backward_rows_plain``),
    with ``keep`` as in ``_backward_plain_t``."""
    qs = (q.float() * scale).to(k.dtype).float()
    qf, dof = q.float(), dout.float()
    lse_ = lse.float()[..., None]
    delta = attention_delta(out, dout)[..., None]
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for n0 in range(0, k.shape[2], PLAIN_BLOCK_K):
        n1 = min(n0 + PLAIN_BLOCK_K, k.shape[2])
        kt, vt = k[..., n0:n1, :].float(), v[..., n0:n1, :].float()
        p = torch.exp(qs @ kt.transpose(-1, -2) - lse_)
        if keep is not None:
            p = torch.where(keep(n0, n1), p, 0.0)
        ds = (p * (dof @ vt.transpose(-1, -2) - delta)).to(k.dtype).float()
        dq += ds @ kt
        dvs.append(p.to(dout.dtype).float().transpose(-1, -2) @ dof)
        dks.append(ds.transpose(-1, -2) @ qf)
    if not dks:  # no key: dk and dv are empty
        return (dq * scale).to(q.dtype), torch.zeros_like(k), torch.zeros_like(v)
    return ((dq * scale).to(q.dtype), (torch.cat(dks, dim=2) * scale).to(k.dtype),
            torch.cat(dvs, dim=2).to(v.dtype))


def flash_attention_backward_plain(q, k, v, out, lse, dout, scale: Optional[float] = None,
                                   kv_lens: Optional[torch.Tensor] = None):
    """Plain PyTorch version of K5, and with ``kv_lens`` of K7's backward at
    head_dim < 128: (dq, dk, dv) in the input dtypes.

    A loop over tiles of PLAIN_BLOCK_K keys that recomputes P from the
    natural-log lse, as ``_flash_attention_backward_t`` (:1131-1268) does in
    the log2 domain, with its rounding points: ds = p (dp - delta) rounded to
    the operand dtype before ds k and ds^T q, p rounded to dout's dtype
    before p^T dout. Scores of keys past Skv never arise (no padding here)."""
    _shapes(q, k, v)
    if kv_lens is not None:
        return _varlen_backward_plain(flash_attention_backward_plain, q, k, v, out, lse, dout,
                                      scale, _kv_lens(kv_lens, q.shape[0]))
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _backward_plain_t(q, k, v, out, lse, dout, scale)


def flash_attention_backward_rows_plain(q, k, v, out, lse, dout, scale: Optional[float] = None,
                                        kv_lens: Optional[torch.Tensor] = None):
    """Plain PyTorch version of K6, the row-layout backward at head_dim >= 128,
    and with ``kv_lens`` of K7's backward there: (dq, dk, dv) in the input
    dtypes.

    A loop over tiles of PLAIN_BLOCK_K keys with the rounding points of
    ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel`` (:985-1061): q * scale rounded to
    k's dtype before the scores, p = exp(s - lse) in the natural base,
    ds = p (dp - delta) rounded before ds k and ds^T q (the unscaled q), p
    rounded to dout's dtype before p^T dout; dq and dk scaled after their
    sums."""
    _shapes(q, k, v)
    if kv_lens is not None:
        return _varlen_backward_plain(flash_attention_backward_rows_plain, q, k, v, out, lse,
                                      dout, scale, _kv_lens(kv_lens, q.shape[0]))
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _backward_plain_rows(q, k, v, out, lse, dout, scale)


def flash_attention_segmented_backward_plain(q, k, v, out, lse, dout, q_segment_ids,
                                             kv_segment_ids, num_segments: int,
                                             scale: Optional[float] = None):
    """Plain PyTorch version of K8's backward: (dq, dk, dv) in the input
    dtypes, from K8's out and lse. Below head_dim 128 K5's log2 form
    (``_fas_bwd``, :1581, through ``_flash_attention_backward_t`` with the
    segment one-hots, :1168-1176), at head_dim 128 K6's row form with its
    rounding points (JAX runs the transposed form at every head_dim,
    :1278-1283; the two differ by a rounding of q * scale). Every pair whose
    query and key ids differ gets p = 0 by a select, not a multiply: one
    segment's dq, dk and dv do not move, to the bit, when another segment's
    q, k, v or dout change (to finite values), and a query whose segment has
    no key gets dq = 0. Ids as the forward takes them (padding -1 meets only
    padding)."""
    _shapes(q, k, v)
    check_segment_args(q, k, q_segment_ids, kv_segment_ids, num_segments)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    q_ids = segment_ids_int32(q_segment_ids, num_segments, q.device)
    kv_ids = segment_ids_int32(kv_segment_ids, num_segments, q.device)

    def keep(n0, n1):
        return q_ids[:, None, :, None] == kv_ids[:, None, None, n0:n1]  # [B, 1, Sq, n]

    run = _backward_plain_rows if q.shape[-1] == 128 else _backward_plain_t
    return run(q, k, v, out, lse, dout, scale, keep)


def sage_quantize(q, k, scale: float, kv_lens: Optional[torch.Tensor] = None):
    """The int8 pre-pass of ``_flash_attention_forward_t_i8`` (:835-852).

    K smoothing (minus the token mean of K per (b, h, d)), then symmetric
    int8 with one scale per (b, h) for Q and for the smoothed K, rounded half
    to even. Returns q_i8, k_i8 (int8, input shapes) and
    sqk = s_q * s_k * scale * log2(e) [B, H] f32. With ``kv_lens`` (K7) the
    key rows at or past kv_lens[b] are zeroed before the smoothing, whose
    mean still runs over all Skv rows, as in JAX; they are filled with 0, so
    a NaN there reaches neither the mean nor the scale.

    One float32 copy of each input is worked in place, and the abs-max is
    taken as max(max, -min), so the pass holds one f32 copy at a time (at
    Wan's joint shape a copy is 1.7 GB).
    """
    def absmax(x):
        return torch.maximum(x.amax(dim=(2, 3), keepdim=True), -x.amin(dim=(2, 3), keepdim=True))

    def over127(x):
        # a true division on every device, as JAX's and the kernel's: torch
        # divides a CUDA tensor by a Python number as a multiply by its
        # reciprocal, which can move the scale by an ulp
        return x / torch.full((), 127.0, device=x.device)

    s_q = over127(absmax(q).float()).clamp_min(1e-8)
    q_i8 = q.to(torch.float32, copy=True).div_(s_q).round_().to(torch.int8)
    ks = k.to(torch.float32, copy=True)
    if kv_lens is not None:
        keys = torch.arange(k.shape[2], device=k.device)
        invalid = keys[None, :] >= kv_lens.to(k.device)[:, None]  # [B, Skv]
        ks.masked_fill_(invalid[:, None, :, None], 0.0)
    ks.sub_(ks.mean(dim=2, keepdim=True))
    s_k = over127(absmax(ks)).clamp_min(1e-8)
    k_i8 = ks.div_(s_k).round_().to(torch.int8)
    sqk = (s_q * s_k * scale * LOG2_E).reshape(q.shape[:2])
    return q_i8, k_i8, sqk


def _sage_plain(q_i8, k_i8, sqk, v, kv_lens=None):
    qf = q_i8.float()
    s = sqk[..., None, None]

    def run(b: slice, n: int, m_init: float):
        def scores(n0, n1):
            # int8 products summed in f32 are exact: |sum| <= D * 127^2 < 2^24
            return (qf[b] @ k_i8[b, :, n0:n1].float().transpose(-1, -2)) * s[b]

        return _online_softmax_plain(scores, v[b, :, :n], q_i8.shape[2], m_init)

    if kv_lens is None:
        return run(slice(None), k_i8.shape[2], NEG_INF)
    return _varlen_plain(lambda b, n: run(slice(b, b + 1), n, VARLEN_FLOOR_LOG2), kv_lens,
                         k_i8.shape[2])


def _sage_checks(q, k, v):
    _shapes(q, k, v)
    if q.shape[-1] % 32:
        raise ValueError(f"int8 path needs head_dim % 32 == 0, got {q.shape[-1]}")
    if k.shape[2] < 1:
        raise ValueError("int8 path needs at least one key (K smoothing takes its mean)")


def flash_attention_int8_forward_plain(q, k, v, scale: Optional[float] = None,
                                       kv_lens: Optional[torch.Tensor] = None):
    """Plain PyTorch version of K2, and with ``kv_lens`` of K7's int8 form:
    returns (out, lse)."""
    _sage_checks(q, k, v)
    kv_lens = _kv_lens(kv_lens, q.shape[0])
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _sage_plain(*sage_quantize(q, k, scale, kv_lens), v, kv_lens)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def kernel_entry(backward: bool, head_dim: int, varlen: bool = False,
                 segmented: bool = False) -> Tuple[str, str, str]:
    """(source, entry, counter) of a CUDA call: the library of
    ``csrc/<source>.cu``, its C entry point (a signature in
    ``_build.SOURCES``) and the launch counter on the wrapper
    (``flash_attention_backward`` for ``backward``, else
    ``flash_attention_segmented_forward`` given ``segmented``, else
    ``flash_attention_forward``). Head_dim 64 takes the ``wgmma`` kernels of
    K1 and K5, 128 those of K4 and K6, with or without ``varlen`` (K7's
    ``kv_lens``) and with or without ``segmented`` (K8's ids: their
    instances with tile skipping, entries of their own); the other head dims
    take the ``mma.sync`` kernels."""
    d64, d128 = head_dim == 64, head_dim == 128
    if segmented:
        if backward:
            return (("flash_bwd_sm90", "vap_flash_bwd_d128_seg", "launches_d128_seg") if d128
                    else ("flash_bwd_sm90_d64", "vap_flash_bwd_d64_seg", "launches_d64_seg")
                    if d64 else ("flash_bwd", "vap_flash_bwd_seg", "launches_seg"))
        return (("flash_fwd_sm90", "vap_flash_fwd_d128_seg", "launches_d128") if d128
                else ("flash_fwd_sm90_d64", "vap_flash_fwd_d64_seg", "launches_d64") if d64
                else ("flash_fwd", "vap_flash_fwd_seg", "launches"))
    suffix = "_varlen" if varlen else ""
    if backward:
        source, entry, counter = (
            ("flash_bwd_sm90", "vap_flash_bwd_d128", "launches_d128") if d128
            else ("flash_bwd_sm90_d64", "vap_flash_bwd_d64", "launches_d64") if d64
            else ("flash_bwd", "vap_flash_bwd", "launches"))
    else:
        source, entry, counter = (
            ("flash_fwd_sm90", "vap_flash_fwd_d128", "launches_d128") if d128
            else ("flash_fwd_sm90_d64", "vap_flash_fwd_d64", "launches_d64") if d64
            else ("flash_fwd", "vap_flash_fwd", "launches"))
    return source, entry, counter + suffix


def flash_attention_forward(q, k, v, scale: Optional[float] = None,
                            kv_lens: Optional[torch.Tensor] = None):
    """K1 and K4, and with ``kv_lens`` K7: (out, lse). CUDA tensors launch
    the entry ``kernel_entry`` names: ``vap_flash_fwd_d64`` (K1 at head_dim
    64), ``vap_flash_fwd`` (K1 at the other multiples of 16 below 128) or
    ``vap_flash_fwd_d128`` (K4, head_dim 128): bf16, contiguous; ``kv_lens``
    goes to the kernel as int32 on the same card. CPU tensors take
    ``flash_attention_forward_plain``."""
    _shapes(q, k, v)
    kv_lens = _kv_lens(kv_lens, q.shape[0])
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _device_kind("flash_attention_forward", q) == "cpu":
        return flash_attention_forward_plain(q, k, v, scale, kv_lens)
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if d % 16 or d > 128:
        raise ValueError(f"flash kernel takes head_dim in 16..128 step 16, got {d}")
    bf16 = torch.bfloat16
    _kernel_inputs("flash_attention_forward", {"q": q, "k": k, "v": v},
                   {"q": bf16, "k": bf16, "v": bf16}, b * h, sq)
    lens = None if kv_lens is None else kv_lens.to(q.device, torch.int32).contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            None if lens is None else lens.data_ptr())
    source, entry, counter = kernel_entry(False, d, varlen=lens is not None)
    dims = (b * h, h, sq, skv) + ((d,) if source == "flash_fwd" else ())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(_build.library(source), entry)(*ptrs, *dims, scale * LOG2_E, stream)
    _build.check(err, entry)
    setattr(flash_attention_forward, counter, getattr(flash_attention_forward, counter) + 1)
    return out, lse


flash_attention_forward.launches = 0
flash_attention_forward.launches_d64 = 0
flash_attention_forward.launches_d128 = 0
flash_attention_forward.launches_varlen = 0
flash_attention_forward.launches_d64_varlen = 0
flash_attention_forward.launches_d128_varlen = 0


def flash_attention_segmented_forward(q, k, v, q_segment_ids, kv_segment_ids,
                                      num_segments: int, scale: Optional[float] = None):
    """K8: (out, lse) of packed-segment attention. CUDA tensors launch the
    entry ``kernel_entry`` names: ``vap_flash_fwd_d64_seg`` (K1's wgmma
    kernel, head_dim 64), ``vap_flash_fwd_d128_seg`` (K4's, head_dim 128),
    each with a scratch for its id range tables, or ``vap_flash_fwd_seg``
    (K1's mma.sync form, the other multiples of 16 below 128): bf16,
    contiguous; the ids go to the kernel as int32 on the same card, padding
    mapped to -1. CPU tensors take ``flash_attention_segmented_forward_plain``."""
    _shapes(q, k, v)
    check_segment_args(q, k, q_segment_ids, kv_segment_ids, num_segments)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _device_kind("flash_attention_segmented_forward", q) == "cpu":
        return flash_attention_segmented_forward_plain(q, k, v, q_segment_ids, kv_segment_ids,
                                                       num_segments, scale)
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if d % 16 or d > 128:
        raise ValueError(f"flash kernel takes head_dim in 16..128 step 16, got {d}")
    q_ids = segment_ids_int32(q_segment_ids, num_segments, q.device)
    kv_ids = segment_ids_int32(kv_segment_ids, num_segments, q.device)
    bf16, i32 = torch.bfloat16, torch.int32
    _kernel_inputs("flash_attention_segmented_forward",
                   {"q": q, "k": k, "v": v, "q_segment_ids": q_ids, "kv_segment_ids": kv_ids},
                   {"q": bf16, "k": bf16, "v": bf16, "q_segment_ids": i32, "kv_segment_ids": i32},
                   b * h, sq)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    source, entry, counter = kernel_entry(False, d, segmented=True)
    mma = source == "flash_fwd"
    ranges = () if mma else (_segment_scratch(b, sq, skv, q.device).data_ptr(),)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), q_ids.data_ptr(), kv_ids.data_ptr(),
            *ranges, out.data_ptr(), lse.data_ptr())
    dims = (b * h, h, sq, skv) + ((d,) if mma else ())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(_build.library(source), entry)(*ptrs, *dims, scale * LOG2_E, stream)
    _build.check(err, entry)
    setattr(flash_attention_segmented_forward, counter,
            getattr(flash_attention_segmented_forward, counter) + 1)
    return out, lse


flash_attention_segmented_forward.launches = 0
flash_attention_segmented_forward.launches_d64 = 0
flash_attention_segmented_forward.launches_d128 = 0


def flash_attention_backward(q, k, v, out, lse, dout, scale: Optional[float] = None,
                             kv_lens: Optional[torch.Tensor] = None,
                             segment_ids: Optional[tuple] = None):
    """K5 and K6, with ``kv_lens`` K7's backward and with ``segment_ids``
    ((q_seg [B, Sq], kv_seg [B, Skv], num_segments)) K8's: (dq, dk, dv) of
    out = softmax(q k^T scale) v, from the forward's ``out`` and natural-log
    ``lse``. After the delta pre-pass in PyTorch, CUDA tensors (bf16,
    contiguous) launch the entry ``kernel_entry`` names:
    ``vap_flash_bwd_d64`` (K5 at head_dim 64), ``vap_flash_bwd`` (K5 at the
    other multiples of 16 below 128) or ``vap_flash_bwd_d128`` (K6, head_dim
    128), ``kv_lens`` as int32 on the same card, or given segment ids
    ``vap_flash_bwd_d64_seg`` / ``vap_flash_bwd_d128_seg`` (with a scratch
    for their id range tables) or ``vap_flash_bwd_seg`` at the other head
    dims, with the ids as the forward maps them; CPU
    tensors take ``flash_attention_backward_plain``, at head_dim 128
    ``flash_attention_backward_rows_plain``, or
    ``flash_attention_segmented_backward_plain``."""
    _shapes(q, k, v)
    kv_lens = _kv_lens(kv_lens, q.shape[0])
    if kv_lens is not None and segment_ids is not None:
        raise ValueError("segment_ids and kv_lens are mutually exclusive")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if d > 128:
        raise ValueError(f"flash backward takes head_dim up to 128, got {d}")
    if segment_ids is not None:
        check_segment_args(q, k, *segment_ids)
    if _device_kind("flash_attention_backward", q) == "cpu":
        if segment_ids is not None:
            return flash_attention_segmented_backward_plain(q, k, v, out, lse, dout,
                                                            *segment_ids, scale)
        plain = flash_attention_backward_rows_plain if d == 128 else flash_attention_backward_plain
        return plain(q, k, v, out, lse, dout, scale, kv_lens)
    if d % 16:
        raise ValueError(f"flash backward kernels take head_dim in 16..128 step 16, got {d}")
    if out.shape != q.shape or dout.shape != q.shape or lse.shape != (b, h, sq):
        raise ValueError(f"out {tuple(out.shape)}, dout {tuple(dout.shape)} and lse "
                         f"{tuple(lse.shape)} must match q {tuple(q.shape)}")
    delta = attention_delta(out, dout)
    bf16, f32, i32 = torch.bfloat16, torch.float32, torch.int32
    tensors = {"q": q, "k": k, "v": v, "dout": dout, "lse": lse, "delta": delta}
    dtypes = {"q": bf16, "k": bf16, "v": bf16, "dout": bf16, "lse": f32, "delta": f32}
    if segment_ids is not None:
        q_seg, kv_seg, num_segments = segment_ids
        tensors["q_segment_ids"] = segment_ids_int32(q_seg, num_segments, q.device)
        tensors["kv_segment_ids"] = segment_ids_int32(kv_seg, num_segments, q.device)
        dtypes.update(q_segment_ids=i32, kv_segment_ids=i32)
    _kernel_inputs("flash_attention_backward", tensors, dtypes, b * h, sq)
    lens = None if kv_lens is None else kv_lens.to(q.device, torch.int32).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    source, entry, counter = kernel_entry(True, d, varlen=lens is not None,
                                          segmented=segment_ids is not None)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    if segment_ids is not None:
        ptrs += (tensors["q_segment_ids"].data_ptr(), tensors["kv_segment_ids"].data_ptr())
        if source != "flash_bwd":  # the wgmma entries' range tables
            ptrs += (_segment_scratch(b, sq, skv, q.device).data_ptr(),)
    else:
        ptrs += (None if lens is None else lens.data_ptr(),)
    # K6's row form takes the scale; K5's log2 form scale * log2(e) and the scale
    dims = (b * h, h, sq, skv) + ((d,) if source == "flash_bwd" else ())
    scales = (scale,) if d == 128 else (scale * LOG2_E, scale)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(_build.library(source), entry)(*ptrs, *dims, *scales, stream)
    _build.check(err, entry)
    setattr(flash_attention_backward, counter, getattr(flash_attention_backward, counter) + 1)
    return dq, dk, dv


flash_attention_backward.launches = 0
flash_attention_backward.launches_d64 = 0
flash_attention_backward.launches_d128 = 0
flash_attention_backward.launches_varlen = 0
flash_attention_backward.launches_d64_varlen = 0
flash_attention_backward.launches_d128_varlen = 0
flash_attention_backward.launches_seg = 0
flash_attention_backward.launches_d64_seg = 0
flash_attention_backward.launches_d128_seg = 0


def wants_grad(*tensors: torch.Tensor) -> bool:
    """True when autograd would record an op on these tensors."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class FlashAttentionFunction(torch.autograd.Function):
    """K1 forward and K5 backward, or at head_dim 128 K4 and K6 (the JAX
    ``custom_vjp`` of ``flash_attention``, ``_fa_fwd`` / ``_fa_bwd`` at
    :1428-1457); given ``kv_lens``, K7's forward and backward
    (``flash_attention_varlen``'s ``_fav_fwd`` / ``_fav_bwd``, :1492-1506).
    Returns (out, lse), the lse not differentiable. Saves q, k, v, out, lse
    and kv_lens. Under ``torch.utils.checkpoint`` the forward runs again in
    the backward with the same inputs, ``kv_lens`` among them; it keeps no
    state between calls, so the recompute gives the out and lse the backward
    reads."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, kv_lens: Optional[torch.Tensor] = None):
        out, lse = flash_attention_forward(q, k, v, scale, kv_lens)
        ctx.save_for_backward(q, k, v, out, lse, kv_lens)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse, kv_lens = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, dout.contiguous(), ctx.scale,
                                              kv_lens)
        return dq, dk, dv, None, None


class FlashAttentionSegmentedFunction(torch.autograd.Function):
    """K8's forward and backward (the JAX ``custom_vjp`` of
    ``flash_attention_segmented``, ``_fas_fwd`` / ``_fas_bwd`` at
    :1572-1597): K1 and K5 below head_dim 128, K4 and K6 at 128, each in its
    segmented form (the wgmma kernels at 64 and 128). Takes the ids as int32
    with padding mapped to -1 (``segment_ids_int32``); returns (out, lse),
    the lse not differentiable.
    Saves q, k, v, out, lse and both ids, so a ``torch.utils.checkpoint``
    recompute gives what the backward reads. As in the forward, a padding
    query (id -1) meets only padding keys here but every key in JAX: its
    rows, and their gradients, are unspecified, so a loss that reads them
    differs from JAX's (the tests give dout zero there)."""

    @staticmethod
    def forward(ctx, q, k, v, q_ids, kv_ids, num_segments: int, scale: float):
        out, lse = flash_attention_segmented_forward(q, k, v, q_ids, kv_ids, num_segments, scale)
        ctx.save_for_backward(q, k, v, out, lse, q_ids, kv_ids)
        ctx.scale, ctx.num_segments = scale, num_segments
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse, q_ids, kv_ids = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, dout.contiguous(), ctx.scale,
                                              segment_ids=(q_ids, kv_ids, ctx.num_segments))
        return dq, dk, dv, None, None, None, None


def attention_with_lse(q, k, v, scale: Optional[float] = None,
                       kv_lens: Optional[torch.Tensor] = None,
                       segment_ids: Optional[tuple] = None):
    """(out, lse) of the flash kernels: K8 given ``segment_ids``, K7 given
    ``kv_lens``, K1 or K4 otherwise. When a gradient is wanted, through
    ``FlashAttentionSegmentedFunction`` or ``FlashAttentionFunction`` (out
    differentiable, lse not); a gradient at head_dim above 128 raises."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    grad = wants_grad(q, k, v)
    if grad and q.shape[-1] > 128:
        raise NotImplementedError(
            f"flash attention has no backward at head_dim {q.shape[-1]} (K6 takes 128)")
    if segment_ids is not None:
        if not grad:
            return flash_attention_segmented_forward(q, k, v, *segment_ids, scale)
        _shapes(q, k, v)
        q_seg, kv_seg, num_segments = segment_ids
        check_segment_args(q, k, q_seg, kv_seg, num_segments)
        return FlashAttentionSegmentedFunction.apply(
            q, k, v, segment_ids_int32(q_seg, num_segments, q.device),
            segment_ids_int32(kv_seg, num_segments, q.device), num_segments, scale)
    if not grad:
        return flash_attention_forward(q, k, v, scale, kv_lens)
    return FlashAttentionFunction.apply(q, k, v, scale, _kv_lens(kv_lens, q.shape[0]))


def flash_attention(q, k, v, scale: Optional[float] = None,
                    kv_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused full attention (K1 or K4 by head_dim; K7 with ``kv_lens``),
    output only; through ``FlashAttentionFunction`` (K1 + K5, or K4 + K6 at
    head_dim 128, each given ``kv_lens`` for K7) when a gradient is wanted.
    A gradient at head_dim above 128 raises."""
    return attention_with_lse(q, k, v, scale, kv_lens)[0]


# rows of q (and of k) per block of the pre-pass kernel: at the main-path
# shapes some 1,600 blocks of 256 threads, each thread moving 16 bytes a row
SAGE_PREPASS_ROWS = 1024


def sage_prepass(q, k, scale: float, kv_lens: Optional[torch.Tensor] = None):
    """K2's int8 pre-pass: (q_i8, k_i8, sqk) as ``sage_quantize`` gives them.
    CUDA tensors (bf16, contiguous, head_dim a multiple of 8 up to 128)
    launch ``vap_sage_quant`` (``csrc/sage_quant.cu``: statistics, scales,
    quantise; q_i8 and sqk's s_q bit-equal to the plain version, k_i8 within
    one step), ``kv_lens`` as int32 on the same card; CPU tensors take
    ``sage_quantize``."""
    _sage_checks(q, k, k)
    kv_lens = _kv_lens(kv_lens, q.shape[0])
    if _device_kind("sage_prepass", q) == "cpu":
        return sage_quantize(q, k, scale, kv_lens)
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if d > 128:
        raise ValueError(f"sage pre-pass takes head_dim up to 128, got {d}")
    bf16 = torch.bfloat16
    _kernel_inputs("sage_prepass", {"q": q, "k": k}, {"q": bf16, "k": bf16}, b * h, sq)
    lens = None if kv_lens is None else kv_lens.to(q.device, torch.int32).contiguous()
    chunks = -(-max(sq, skv) // SAGE_PREPASS_ROWS)
    q_i8 = torch.empty(q.shape, dtype=torch.int8, device=q.device)
    k_i8 = torch.empty(k.shape, dtype=torch.int8, device=q.device)
    sqk = torch.empty((b, h), dtype=torch.float32, device=q.device)
    scratch = torch.empty(b * h * (chunks * (1 + 3 * d) + 2 + d), dtype=torch.float32,
                          device=q.device)
    with torch.cuda.device(q.device):
        err = _build.library("sage_quant").vap_sage_quant(
            q.data_ptr(), k.data_ptr(), None if lens is None else lens.data_ptr(),
            q_i8.data_ptr(), k_i8.data_ptr(), sqk.data_ptr(), scratch.data_ptr(), b * h, h, sq,
            skv, d, chunks, scale, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "vap_sage_quant")
    sage_prepass.launches += 1
    return q_i8, k_i8, sqk


sage_prepass.launches = 0


def sage_entry(head_dim: int, varlen: bool = False) -> Tuple[str, str, str]:
    """(source, entry, counter) of K2's CUDA call, as ``kernel_entry`` gives
    the flash kernels': head_dim 64 and 128 take the ``wgmma`` kernels
    (``vap_sage_fwd_d64``, ``vap_sage_fwd_d128``; counter ``launches``),
    32 and 96 the ``mma.sync`` kernel (``vap_sage_fwd``, ``launches_mma``);
    ``varlen`` (K7's ``kv_lens``) adds ``_varlen`` to the counter."""
    source, entry, counter = (
        ("sage_fwd_sm90", "vap_sage_fwd_d128", "launches") if head_dim == 128
        else ("sage_fwd_sm90_d64", "vap_sage_fwd_d64", "launches") if head_dim == 64
        else ("sage_fwd", "vap_sage_fwd", "launches_mma"))
    return source, entry, counter + ("_varlen" if varlen else "")


def flash_attention_int8_forward(q, k, v, scale: Optional[float] = None,
                                 kv_lens: Optional[torch.Tensor] = None):
    """K2, and with ``kv_lens`` K7's int8 form: (out, lse). CUDA tensors
    (bf16, contiguous, head_dim 32, 64, 96 or 128) run the pre-pass kernel
    (``sage_prepass``), then launch the entry ``sage_entry`` names; CPU
    tensors take the plain version."""
    _sage_checks(q, k, v)
    kv_lens = _kv_lens(kv_lens, q.shape[0])
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _device_kind("flash_attention_int8_forward", q) == "cpu":
        return _sage_plain(*sage_quantize(q, k, scale, kv_lens), v, kv_lens)
    b, h, sq, d = q.shape
    skv = k.shape[2]
    if d > 128:
        raise ValueError(f"sage kernel takes head_dim 32, 64, 96 or 128, got {d}")
    bf16 = torch.bfloat16
    _kernel_inputs("flash_attention_int8_forward", {"q": q, "k": k, "v": v},
                   {"q": bf16, "k": bf16, "v": bf16}, b * h, sq)
    q_i8, k_i8, sqk = sage_prepass(q, k, scale, kv_lens)
    lens = None if kv_lens is None else kv_lens.to(q.device, torch.int32).contiguous()
    out = torch.empty((b, h, sq, d), dtype=v.dtype, device=v.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    source, entry, counter = sage_entry(d, varlen=lens is not None)
    dims = (b * h, h, sq, skv) + ((d,) if source == "sage_fwd" else ())
    with torch.cuda.device(q.device):
        err = getattr(_build.library(source), entry)(
            q_i8.data_ptr(), k_i8.data_ptr(), sqk.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), None if lens is None else lens.data_ptr(), *dims,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, entry)
    setattr(flash_attention_int8_forward, counter,
            getattr(flash_attention_int8_forward, counter) + 1)
    return out, lse


flash_attention_int8_forward.launches = 0
flash_attention_int8_forward.launches_varlen = 0
flash_attention_int8_forward.launches_mma = 0
flash_attention_int8_forward.launches_mma_varlen = 0


def flash_attention_int8(q, k, v, scale: Optional[float] = None,
                         kv_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SageAttention-style int8-QK attention (K2; K7 with ``kv_lens``),
    output only. Inference only, as ``flash_attention_int8`` is in JAX: it
    raises when a gradient is wanted, since one through the int8 forward
    would be wrong."""
    if wants_grad(q, k, v):
        raise NotImplementedError("the sage provider (K2) is inference-only and has no "
                                  "gradient; train with 'flash' or 'xla'")
    return flash_attention_int8_forward(q, k, v, scale, kv_lens)[0]


def flash_attention_segmented(q, k, v, q_segment_ids, kv_segment_ids, num_segments: int,
                              scale: Optional[float] = None) -> torch.Tensor:
    """Fused attention over packed sequences (K8), output only: query i
    attends key j iff their segment ids are equal (see
    ``flash_attention_segmented_forward``); through
    ``FlashAttentionSegmentedFunction`` (K8's forward and backward) when a
    gradient is wanted. It never falls back to dense attention."""
    return attention_with_lse(q, k, v, scale,
                              segment_ids=(q_segment_ids, kv_segment_ids, num_segments))[0]
