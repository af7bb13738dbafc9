"""Sequence-parallel attention, forward and backward, and generation on
several CPU processes (``torch.distributed`` over gloo) against the JAX
package.

Workers are started with ``torch.multiprocessing`` (spawn) on a free
localhost port; each runs every case of its world in one process group and
saves what it got, and the test process holds each rank's result against
JAX's ``sequence_parallel_attention`` on a seq = n mesh of virtual CPU
devices (``tests/conftest.py`` gives JAX eight), its gradients against
``jax.grad`` of the same, and the CogVideoX pipeline of
``test_torch_pipeline.py`` under "ring" on 2 ranks against the JAX pipeline
under "xla" on one device.
"""

import datetime
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
import torch.utils.checkpoint
from jax.sharding import NamedSharding, PartitionSpec as P

from vap_tpu.ops.attention import attention_provider as jax_attention_provider
from vap_tpu.parallel import MeshConfig as JaxMeshConfig
from vap_tpu.parallel import make_mesh as jax_make_mesh
from vap_tpu.parallel.ring_attention import sequence_parallel_attention as jax_spa
from vap_tpu_torch.ops import flash_attention as tfa
from vap_tpu_torch.ops.attention import attention_provider, full_attention
from vap_tpu_torch.parallel import (MeshConfig, attention_mesh, make_mesh,
                                    sequence_parallel_attention)

# float32 on both sides; the ring merges its blocks by lse where JAX carries
# one online softmax, and every method sums in another order (the K7/K8 tests)
F32_ATOL = 2e-5
# gradients, f32, held as max|err| / max(max|ref|, 1) (``BWD_ATOL`` of
# test_torch_varlen.py): P recomputed from the merged lse, sums over blocks
BWD_ATOL = 1e-4
METHODS = ("allgather", "ppermute", "ulysses")
MASKS = ("none", "kv_lens", "segments")
WORLDS = (2, 4)
B, H, S, D = 2, 4, 64, 16
# a length inside a shard, and a sample with no valid key
LENS = [37, 0]
# sample 0: segment 1 spans the shard boundaries; sample 1: a padded tail
SEGMENTS = ([20, 30, 14], [10, 22, 12])
NUM_SEGMENTS = 3
TIMEOUT_S = 300


def _packed_ids(s, bounds):
    ids = np.full((s,), -1, np.int32)
    pos = 0
    for g, n in enumerate(bounds):
        ids[pos:pos + n] = g
        pos += n
    return ids


def _attention_inputs():
    rng = np.random.default_rng(21)
    q, k, v = (rng.standard_normal((B, H, S, D), np.float32) for _ in range(3))
    ids = np.stack([_packed_ids(S, b) for b in SEGMENTS])
    return q, k, v, np.array(LENS, np.int32), ids


def _loss_weights(mask, ids):
    """A weight per output element of the gradient's loss sum(out * w),
    zero on the padding query rows of the segment case (their rows are
    unspecified)."""
    w = np.random.default_rng(22).standard_normal((B, H, S, D)).astype(np.float32)
    return w * (ids >= 0)[:, None, :, None] if mask == "segments" else w


def _mask_kwargs(mask, lens, ids):
    if mask == "kv_lens":
        return {"kv_lens": lens}
    if mask == "segments":
        return {"segment_ids": (ids, ids, NUM_SEGMENTS)}
    return {}


def _message(fn):
    """The ValueError ``fn`` raises, or None."""
    try:
        fn()
    except ValueError as exc:
        return str(exc)
    return None


def _worker(rank, world, port, out_dir, pipe_path):
    """One rank: every attention case of this world, the argument errors,
    the one-rank-axis shortcut and, given ``pipe_path``, the pipeline under
    "ring" with each rotate method; saved as ``rank{rank}.pt``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        mesh = make_mesh(MeshConfig(seq=world), device_type="cpu")
        q, k, v, lens, ids = map(torch.from_numpy, _attention_inputs())
        got = {}
        for method in METHODS:
            for mask in MASKS:
                got[method, mask] = sequence_parallel_attention(
                    q, k, v, mesh, "seq", rotate_method=method,
                    **_mask_kwargs(mask, lens, ids)).numpy()
        got["ulysses_heads"] = _message(lambda: sequence_parallel_attention(
            q[:, :3], k[:, :3], v[:, :3], mesh, rotate_method="ulysses"))
        got["odd_length"] = _message(lambda: sequence_parallel_attention(
            q[:, :, :S - 1], k, v, mesh))
        got["odd_keys"] = _message(lambda: sequence_parallel_attention(
            q, k[:, :, :9], v[:, :, :9], mesh))
        got["small_world"] = _message(lambda: make_mesh(MeshConfig(seq=2 * world), "cpu"))
        for method in METHODS:  # the gradients of sum(out * w)
            for mask in MASKS:
                leaves = [x.clone().requires_grad_() for x in (q, k, v)]
                out = sequence_parallel_attention(*leaves, mesh, "seq", rotate_method=method,
                                                  **_mask_kwargs(mask, lens, ids))
                w = torch.from_numpy(_loss_weights(mask, ids.numpy()))
                got["grad", method, mask] = [g.numpy() for g in torch.autograd.grad(
                    (out * w).sum(), leaves)]
        for method in METHODS:  # what the autograd function saves, through the hooks
            shapes = []

            def pack(t):
                shapes.append(tuple(t.shape))
                return t

            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                sequence_parallel_attention(*leaves, mesh, "seq", rotate_method=method,
                                            **_mask_kwargs("segments", lens, ids))
            got["saved", method] = shapes
        for method in METHODS:  # under a non-reentrant checkpoint
            for mask in MASKS:
                calls = []

                def attend(*qkv):
                    calls.append(1)
                    return sequence_parallel_attention(*qkv, mesh, "seq", rotate_method=method,
                                                       **_mask_kwargs(mask, lens, ids))

                leaves = [x.clone().requires_grad_() for x in (q, k, v)]
                out = torch.utils.checkpoint.checkpoint(attend, *leaves, use_reentrant=False)
                w = torch.from_numpy(_loss_weights(mask, ids.numpy()))
                grads = torch.autograd.grad((out * w).sum(), leaves)
                got["checkpoint", method, mask] = len(calls), [g.numpy() for g in grads]
        # a mesh whose seq axis holds one rank: the local kernel, no collective
        flat = make_mesh(MeshConfig(data=world), device_type="cpu")
        got["one_rank_axis"] = sequence_parallel_attention(
            q, k, v, flat, rotate_method="ppermute", kv_lens=lens).numpy()
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = sequence_parallel_attention(*leaves, flat, rotate_method="ppermute", kv_lens=lens)
        got["one_rank_axis_grad"] = [g.numpy() for g in torch.autograd.grad(
            (out * torch.from_numpy(_loss_weights("kv_lens", None))).sum(), leaves)]
        if pipe_path is not None:
            pipe, args, latents = torch.load(pipe_path, weights_only=False)
            for method in METHODS:
                with attention_provider("ring"), attention_mesh(mesh, "seq", method):
                    got["pipeline", method] = pipe(**args, latents=torch.from_numpy(latents),
                                                   output_type="latent").numpy()
        torch.save(got, out_dir / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(world, out_dir, pipe_path=None):
    """Run ``_worker`` on ``world`` ranks; each rank's saved results."""
    ctx = mp.start_processes(_worker, args=(world, _free_port(), out_dir, pipe_path),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{world} gloo ranks did not finish in {TIMEOUT_S} s")
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(world)]


@pytest.fixture(scope="module")
def pipeline_case(tmp_path_factory):
    """The port's pipeline saved for the workers, its call, and the JAX
    pipeline's latents under "xla" on one device."""
    from test_torch_pipeline import _call_args, build_pipelines

    port, ref = build_pipelines()
    args, latents = _call_args()
    with jax_attention_provider("xla"):
        want = np.asarray(ref(**args, latents=jnp.asarray(latents), output_type="latent"))
    path = tmp_path_factory.mktemp("pipeline") / "pipeline.pt"
    torch.save((port, args, latents), path)
    return path, want


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, pipeline_case):
    """World size -> each rank's results; worlds run on first use. The
    2-rank world also runs the pipeline."""
    runs = {}

    def get(world):
        if world not in runs:
            pipe_path = pipeline_case[0] if world == 2 else None
            runs[world] = _spawn(world, tmp_path_factory.mktemp(f"world{world}"), pipe_path)
        return runs[world]

    return get


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("world", WORLDS)
def test_sequence_parallel_attention_matches_jax(ranks, world, method, mask):
    """Every rank's full output against JAX's on a seq = n mesh (in-range
    query rows for segments: padding rows are unspecified)."""
    q, k, v, lens, ids = _attention_inputs()
    mesh = jax_make_mesh(JaxMeshConfig(seq=world), jax.devices("cpu")[:world])
    spec = NamedSharding(mesh, P(None, None, "seq", None))
    qs, ks, vs = (jax.device_put(jnp.asarray(x), spec) for x in (q, k, v))
    kwargs = _mask_kwargs(mask, jnp.asarray(lens), jnp.asarray(ids))
    want = np.asarray(jax_spa(qs, ks, vs, mesh, "seq", rotate_method=method, **kwargs))
    rows = np.broadcast_to((ids >= 0)[:, None, :, None] if mask == "segments" else True,
                           want.shape)
    for rank, got in enumerate(ranks(world)):
        out = got[method, mask]
        assert out.shape == want.shape and np.isfinite(out).all()
        np.testing.assert_allclose(out[rows], want[rows], atol=F32_ATOL, rtol=0,
                                   err_msg=f"rank {rank}")
        if mask == "kv_lens":  # no valid key in any block: exact zeros
            assert not out[1].any()


@pytest.mark.parametrize("world", WORLDS)
def test_argument_errors_raise_on_every_rank(ranks, world):
    """H % n under ulysses and a sharded length that n does not divide
    raise, as JAX's checks and its shard_map do; so does a mesh larger
    than the world, as JAX's make_mesh does."""
    for got in ranks(world):
        assert "head count divisible" in got["ulysses_heads"]
        assert f"query length {S - 1}" in got["odd_length"]
        assert "key length 9" in got["odd_keys"] and "ring cross:flash" in got["odd_keys"]
        assert got["small_world"] == f"need {2 * world} devices, have {world}"


def test_one_rank_seq_axis_is_the_local_kernel(ranks):
    """A mesh whose seq axis has one rank (data = 2) runs the local kernel
    (K7 here) directly, as JAX does at n = 1."""
    q, k, v, lens, _ = map(torch.from_numpy, _attention_inputs())
    want = tfa.flash_attention_forward(q, k, v, kv_lens=lens)[0].numpy()
    for got in ranks(2):
        assert np.array_equal(got["one_rank_axis"], want)


@pytest.mark.parametrize("method", METHODS)
def test_pipeline_under_ring_matches_jax(ranks, pipeline_case, method):
    """The CogVideoX pipeline of test_torch_pipeline.py (three blocks, 3 DDIM
    steps at CFG 2) under "ring" on 2 ranks, the same seed and inputs on
    both: every rank's latents against the JAX pipeline under "xla", at that
    file's tolerance."""
    want = pipeline_case[1]
    for rank, got in enumerate(ranks(2)):
        out = got["pipeline", method]
        assert out.shape == want.shape and np.isfinite(out).all()
        np.testing.assert_allclose(out, want, atol=2e-5, rtol=1e-5, err_msg=f"rank {rank}")


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("world", WORLDS)
def test_sequence_parallel_gradients_match_jax(ranks, world, method, mask):
    """Every rank's dq, dk and dv of sum(out * w) against ``jax.grad`` of
    JAX's ``sequence_parallel_attention`` on a seq = n mesh (dout zero on
    the padding rows of the segment case), and bit-identical across the
    ranks, so a replicated model's gradients stay in step."""
    q, k, v, lens, ids = _attention_inputs()
    mesh = jax_make_mesh(JaxMeshConfig(seq=world), jax.devices("cpu")[:world])
    spec = NamedSharding(mesh, P(None, None, "seq", None))
    kwargs = _mask_kwargs(mask, jnp.asarray(lens), jnp.asarray(ids))
    w = jnp.asarray(_loss_weights(mask, ids))

    def loss(q, k, v):
        return jnp.sum(jax_spa(q, k, v, mesh, "seq", rotate_method=method, **kwargs) * w)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*(jax.device_put(jnp.asarray(x), spec)
                                                        for x in (q, k, v)))
    got = [r["grad", method, mask] for r in ranks(world)]
    for name, g, r in zip("qkv", got[0], want):
        r = np.asarray(r)
        assert g.shape == r.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, r, atol=BWD_ATOL * max(np.abs(r).max(), 1.0), rtol=0,
                                   err_msg=f"d{name}")
    for rank, other in enumerate(got[1:], 1):
        assert all(np.array_equal(a, b) for a, b in zip(other, got[0])), f"rank {rank}"


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("world", WORLDS)
def test_sequence_parallel_attention_saves_through_the_hooks(ranks, world, method):
    """Every tensor the backward reads goes through the saved-tensor hooks
    (``save_for_backward``), so a non-reentrant checkpoint can free it: this
    rank's ids, then the method's q, k, v, out and lse (and the gathered
    ids), at their sharded shapes."""
    n = world
    shard, full, heads = (B, H, S // n, D), (B, H, S, D), (B, H // n, S, D)
    ids = [(B, S // n)] * 2
    want = {"allgather": ids + [shard, full, full, shard, shard[:3], (B, S)],
            "ppermute": ids + [shard] * 4 + [shard[:3]],
            "ulysses": ids + [heads] * 4 + [heads[:3], (B, S), (B, S)]}[method]
    for rank, got in enumerate(ranks(world)):
        assert got["saved", method] == want, f"rank {rank}"


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("world", WORLDS)
def test_checkpointed_sequence_parallel_attention(ranks, world, method, mask):
    """Under ``torch.utils.checkpoint(use_reentrant=False)`` the backward
    recomputes the forward (two calls: the saved tensors were freed), its
    collectives in step on every rank, and the gradients equal those of
    the call without a checkpoint, to the bit, on every rank."""
    for rank, got in enumerate(ranks(world)):
        calls, grads = got["checkpoint", method, mask]
        assert calls == 2, f"rank {rank}: {calls} forward calls"
        for name, g, r in zip("qkv", grads, got["grad", method, mask]):
            assert np.array_equal(g, r), f"rank {rank}: d{name}"


def test_ring_provider_under_autograd_raises():
    """The ring provider differentiates, with or without a mesh: with none
    it is the local kernel's autograd function (the same gradients as
    ``flash``, to the bit). Only a head_dim with no backward kernel raises,
    before any collective."""
    q, k, v = (torch.randn(1, 2, 8, 16, requires_grad=True) for _ in range(3))
    w = torch.randn(1, 2, 8, 16)
    grads = {}
    for provider in ("flash", "ring"):
        with attention_provider(provider):
            grads[provider] = torch.autograd.grad((full_attention(q, k, v) * w).sum(), (q, k, v))
    assert all(torch.equal(a, b) for a, b in zip(grads["ring"], grads["flash"]))
    wide = [torch.randn(1, 2, 8, 192, requires_grad=True) for _ in range(3)]
    with attention_provider("ring"), pytest.raises(NotImplementedError, match="K6 takes 128"):
        full_attention(*wide)
    with pytest.raises(NotImplementedError, match="K6 takes 128"):
        sequence_parallel_attention(*wide, mesh=_FakeMesh(2))


class _FakeMesh:
    """A mesh whose ``seq`` axis has n ranks, for the checks made before
    any collective."""

    mesh_dim_names = ("seq",)

    def __init__(self, n):
        self.n = n

    def size(self, dim):
        return self.n


def test_one_rank_seq_axis_carries_gradients(ranks):
    """At n = 1 under autograd the shortcut goes through the local kernel's
    autograd function: the gradients are K7's (``flash_attention``'s), to
    the bit, and not zero."""
    q, k, v, lens, _ = map(torch.from_numpy, _attention_inputs())
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = tfa.flash_attention(*leaves, kv_lens=lens)
    want = torch.autograd.grad((out * torch.from_numpy(_loss_weights("kv_lens", None))).sum(),
                               leaves)
    for got in ranks(2):
        for g, r in zip(got["one_rank_axis_grad"], want):
            assert np.array_equal(g, r.numpy()) and np.abs(g).max() > 0


def test_ring_provider_without_mesh_is_the_local_kernel():
    q, k, v = (torch.randn(2, 2, 24, 16) for _ in range(3))
    lens = torch.tensor([24, 5])
    with attention_provider("ring"):
        assert torch.equal(full_attention(q, k, v, kv_lens=lens),
                           tfa.flash_attention_forward(q, k, v, kv_lens=lens)[0])


def test_make_mesh_needs_torch_distributed_and_a_large_enough_world():
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(MeshConfig(seq=2), device_type="cpu")
    assert MeshConfig.for_devices(8) == MeshConfig(data=2, fsdp=2, seq=2)
    assert MeshConfig(seq=4, tensor=2).world_size == 8
