"""The port's CUDA kernels (K1 and K4 flash, K2 sage) against their plain
PyTorch versions on the card.

Every test here needs a CUDA device and skips without one. The file imports
no jax, so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from vap_tpu_torch.ops import flash_attention as tfa

KERNELS = {
    "flash": (tfa.flash_attention_forward, tfa.flash_attention_forward_plain),
    "sage": (tfa.flash_attention_int8_forward, tfa.flash_attention_int8_forward_plain),
}
# the launch counter of each kernel: K1 below head_dim 128, K4 at 128
COUNTERS = {("flash", False): "launches", ("flash", True): "launches_d128",
            ("sage", False): "launches", ("sage", True): "launches"}
# bf16 output, held as max|out - ref| / max|ref|: kernel and plain version
# round P to bf16 against different running maxima, which moves an output by
# about one bf16 ulp, at most 2^-7 of max|ref|
OUT_REL_TOL = 2e-2
LSE_ATOL = 1e-2
KV_TILE = 64  # keys per tile of both kernels

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _qkv(device, sq, skv, d=64, b=1, h=2, seed=1):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal((b, h, s, d), np.float32))
                 .to(device, torch.bfloat16) for s in (sq, skv, skv))


def _check(name, q, k, v):
    kernel, plain = KERNELS[name]
    counter = COUNTERS[name, q.shape[-1] == 128]
    before = getattr(kernel, counter)
    out, lse = kernel(q, k, v)
    torch.cuda.synchronize()
    assert getattr(kernel, counter) == before + 1
    ref_out, ref_lse = plain(q, k, v)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=0,
                               atol=OUT_REL_TOL * ref_out.float().abs().max().item())
    torch.testing.assert_close(lse, ref_lse, atol=LSE_ATOL, rtol=0)


@pytest.mark.parametrize("name", ["flash", "sage"])
@pytest.mark.parametrize("sq,skv", [(300, 200), (128, 257), (64, 77), (1, 1), (65, 64)])
def test_kernel_matches_plain(cuda, name, sq, skv):
    _check(name, *_qkv(cuda, sq, skv))


@pytest.mark.parametrize("name", ["flash", "sage"])
@pytest.mark.parametrize("skv", [512, 257])
def test_kernel_matches_plain_wan_cross_keys(cuda, name, skv):
    """Wan's cross-attention key counts (512 text tokens, 257 CLIP tokens)
    at head_dim 128; the full Sq of 20,280 runs in chip_smoke.py."""
    _check(name, *_qkv(cuda, 300, skv, d=128))


@pytest.mark.parametrize("name,d", [("flash", d) for d in (16, 32, 48, 80, 96, 112, 128)]
                         + [("sage", 32), ("sage", 96), ("sage", 128)])
def test_kernel_head_dims(cuda, name, d):
    _check(name, *_qkv(cuda, 130, 70, d=d))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("name", ["flash", "sage"])
def test_limit_catches_v_rows_out_of_place(cuda, name, d):
    """A planted fault: V rows rolled by one inside every kv tile, as a
    kernel that mixed up the rows of a tile would read them. Held against
    the plain version on the true V, it must break the out limit."""
    kernel, plain = KERNELS[name]
    q, k, v = _qkv(cuda, 300, 200, d=d)
    n = v.shape[2] // KV_TILE * KV_TILE
    tiles = v[:, :, :n].unflatten(2, (-1, KV_TILE)).roll(1, dims=3).flatten(2, 3)
    out = kernel(q, k, torch.cat([tiles, v[:, :, n:]], dim=2))[0].float()
    ref = plain(q, k, v)[0].float()
    assert (out - ref).abs().max() > OUT_REL_TOL * ref.abs().max()


def test_flash_without_keys_is_finite(cuda):
    """No key at all: the l == 0 guard gives zeros and a finite lse."""
    q, k, v = _qkv(cuda, 3, 0)
    out, lse = tfa.flash_attention_forward(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(out, torch.zeros_like(q)) and torch.isfinite(lse).all()


def test_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((1, 2, 8, 64), device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        tfa.flash_attention_forward(q, q, q)
    qb = torch.zeros((1, 8, 2, 64), device=cuda, dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention_forward(qb, qb, qb)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention_int8_forward(*_qkv(cuda, 8, 8, d=160))


def test_flash_raises_at_head_dim_256(cuda):
    """Head_dim above 128 has no kernel yet: the wrapper raises, launches
    nothing and does not fall back."""
    counts = (tfa.flash_attention_forward.launches, tfa.flash_attention_forward.launches_d128)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention_forward(*_qkv(cuda, 8, 8, d=256))
    assert (tfa.flash_attention_forward.launches,
            tfa.flash_attention_forward.launches_d128) == counts
