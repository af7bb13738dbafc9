"""The port's Adafactor and 8-bit Adam / AdamW against the JAX package's
optimizers (``vap_tpu/training/optimizer.py`` ``get_optimizer``: optax's
``adafactor`` and ``optim8bit``), inside the same ``clip_by_global_norm``
chain, over three updates of seeded float32 parameters and gradients.

The port holds Linear and Conv weights as [out, in, *k]; the JAX package
holds the same tensors as [in * k, out] kernels. Each case gives both sides
the same numbers in their own layouts: a rectangular kernel, a square one
(optax factors a tie with the lower dim first), Wan's patch-embedding Conv3d
([D, C, 1, 2, 2] here, a [4C, D] kernel there), an unfactored kernel, a
bias, a modulation table, two blocks that JAX stacks into one leaf, and
two biases of 3072 (the Wan expert's width) that JAX stacks into one leaf
whose 8-bit blocks run across the two layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vap_tpu.training import optim8bit as joptim8
from vap_tpu.training import optimizer as jopt
from vap_tpu_torch.training import optim8bit as toptim8
from vap_tpu_torch.training import optimizer as topt

LR = 1e-2
MAX_GRAD_NORM = 5.0  # the first update is clipped, the later ones are not
STEPS = 3
TOL = 1e-6  # of max(1, max|JAX's tensor|)
# a code at a rounding boundary may round one step apart (x ** 0.25, sqrt)
CODE_SHARE = 1e-3

# name -> (port shape, JAX shape, kernel, JAX leaf)
PARAMS = {
    "rect": ((256, 160), (160, 256), True, "rect"),
    "square": ((192, 192), (192, 192), True, "square"),
    "patch_conv": ((160, 36, 1, 2, 2), (144, 160), True, "patch_conv"),
    "small": ((64, 32), (32, 64), True, "small"),
    "bias": ((300,), (300,), False, "bias"),
    "table": ((1, 6, 256), (1, 6, 256), False, "table"),
    "block0": ((160, 128), (128, 160), True, "stack"),
    "block1": ((160, 128), (128, 160), True, "stack"),
    "wide_bias0": ((3072,), (3072,), False, "stack_bias"),
    "wide_bias1": ((3072,), (3072,), False, "stack_bias"),
}
STACKED = ("stack", "stack_bias")  # leaves JAX stacks, their members in order



def _to_jax(name, x: np.ndarray) -> np.ndarray:
    shape, _, kernel, _ = PARAMS[name]
    return x.reshape(shape[0], -1).T.copy() if kernel else x


def _jax_tree(values):
    """{leaf: array}, the members of a stacked leaf stacked into one [2, ...]."""
    tree = {PARAMS[n][3]: jnp.asarray(_to_jax(n, v)) for n, v in values.items()
            if PARAMS[n][3] not in STACKED}
    for leaf in STACKED:
        tree[leaf] = jnp.stack([jnp.asarray(_to_jax(n, values[n])) for n in PARAMS
                                if PARAMS[n][3] == leaf])
    return tree


def _from_jax(tree):
    out = {}
    for n, (shape, _, kernel, leaf) in PARAMS.items():
        x = np.asarray(tree[leaf])
        if leaf in STACKED:
            x = x[int(n[-1])]
        out[n] = x.T.reshape(shape) if kernel else x.reshape(shape)
    return out


def _draws(seed):
    rng = np.random.default_rng(seed)
    params = {n: rng.standard_normal(s[0]).astype(np.float32) * 0.5 for n, s in PARAMS.items()}
    grads = [{n: (rng.standard_normal(s[0]) * (3.0 if k == 0 else 0.05)).astype(np.float32)
              for n, s in PARAMS.items()} for k in range(STEPS)]
    return params, grads


def _close(a, b, what):
    scale = max(1.0, float(np.max(np.abs(b))))
    err = float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))
    assert err <= TOL * scale, f"{what}: {err} > {TOL} * {scale}"


def _port(name, params):
    tensors = [torch.nn.Parameter(torch.from_numpy(params[n].copy())) for n in PARAMS]
    layout = ([PARAMS[n][2] for n in PARAMS], [PARAMS[n][3] for n in PARAMS])
    sched = topt.get_lr_schedule("constant", LR, warmup_steps=0)
    return tensors, topt.get_optimizer(name, tensors, sched, max_grad_norm=MAX_GRAD_NORM,
                                       layout=layout)


def _port_step(opt, tensors, grads):
    for t, n in zip(tensors, PARAMS):
        t.grad = torch.from_numpy(grads[n].copy())
    norm = opt.step()
    opt.zero_grad()
    return float(norm)


def _run_jax(name, params, grads):
    sched = jopt.get_lr_schedule("constant", LR, warmup_steps=0)
    tx = jopt.get_optimizer(name, sched, max_grad_norm=MAX_GRAD_NORM)
    tree = _jax_tree(params)
    state = tx.init(tree)
    trees, states = [], []

    @jax.jit
    def update(g, state, tree):
        updates, state = tx.update(g, state, tree)
        return optax.apply_updates(tree, updates), state

    for g in grads:
        tree, state = update(_jax_tree(g), state, tree)
        trees.append(_from_jax(tree))
        states.append(state)
    return trees, states


def test_factored_dims_follow_optax():
    from optax._src import factorized

    for _, shape, _, _ in PARAMS.values():
        assert topt._factored_dims(shape) == factorized._factored_dims(shape, True, 128)
    for shape in [(2, 136, 160), (128, 128, 4), (5, 300, 300), (129,)]:
        assert topt._factored_dims(shape) == factorized._factored_dims(shape, True, 128)


def test_adafactor_matches_optax():
    params, grads = _draws(0)
    want, states = _run_jax("adafactor", params, grads)
    tensors, opt = _port("adafactor", params)
    for k in range(STEPS):
        _port_step(opt, tensors, grads[k])
        for t, n in zip(tensors, PARAMS):
            _close(t.detach().numpy(), want[k][n], f"step {k + 1} {n}")
    # the second-moment state, in JAX's layout
    factored = jax.tree_util.tree_leaves(
        states[-1], is_leaf=lambda x: isinstance(x, optax.FactoredState))
    fs = next(x for x in factored if isinstance(x, optax.FactoredState))
    for t, n in zip(tensors, PARAMS):
        st, leaf = opt.inner.state[t], PARAMS[n][3]
        index = (int(n[-1]),) if leaf in STACKED else ()
        if st["dims"] is None:
            _close(st["v"].numpy(), np.asarray(fs.v[leaf])[index], f"v {n}")
        else:
            _close(st["v_row"].numpy(), np.asarray(fs.v_row[leaf])[index], f"v_row {n}")
            _close(st["v_col"].numpy(), np.asarray(fs.v_col[leaf])[index], f"v_col {n}")
    assert opt.inner.state[tensors[list(PARAMS).index("square")]]["dims"] == (0, 1)


def _jax_8bit_state(state):
    leaves = jax.tree_util.tree_leaves(
        state, is_leaf=lambda x: isinstance(x, joptim8.ScaleByAdam8bitState))
    return next(x for x in leaves if isinstance(x, joptim8.ScaleByAdam8bitState))


def _port_8bit_state(js):
    """JAX's 8-bit state as the port keeps it: one entry per JAX leaf, in
    the order of the leaves' first members."""
    leaves = list(dict.fromkeys(leaf for _, _, _, leaf in PARAMS.values()))
    return {"count": int(js.count),
            "state": [{f"{m}_{k}": torch.from_numpy(np.array(getattr(tree[leaf], k)))
                       for m, tree in (("m", js.mu), ("v", js.nu)) for k in ("code", "scale")}
                      for leaf in leaves]}


@pytest.mark.parametrize("name", ["adam-8bit", "adamw-8bit", "adamw-bnb-8bit"])
def test_adam_8bit_matches_jax(name):
    """Each of three updates from JAX's state and parameters before it: the
    parameters within 1e-6 of scale, the scales too, the codes at most one
    step apart on at most 0.1% of elements. (A code one step apart moves the
    next update by ~1e-2 of lr, so each update starts from JAX's state.)"""
    params, grads = _draws(1)
    want, states = _run_jax(name, params, grads)
    for k in range(STEPS):
        tensors, opt = _port(name, params if k == 0 else want[k - 1])
        if k:
            opt.count = k
            opt.inner.load_state_dict(_port_8bit_state(_jax_8bit_state(states[k - 1])))
        _port_step(opt, tensors, grads[k])
        for t, n in zip(tensors, PARAMS):
            _close(t.detach().numpy(), want[k][n], f"step {k + 1} {n}")
        ref = _port_8bit_state(_jax_8bit_state(states[k]))
        assert opt.inner.count == ref["count"] == k + 1
        leaves = list(dict.fromkeys(leaf for _, _, _, leaf in PARAMS.values()))
        for n, ours, st in zip(leaves, opt.inner.leaf_states(), ref["state"]):
            for m in ("m", "v"):
                diff = (ours[f"{m}_code"].int() - st[f"{m}_code"].int()).abs()
                assert int(diff.max()) <= 1, f"{m} codes of {n} more than one step apart"
                share = float((diff > 0).float().mean())
                assert share <= CODE_SHARE, f"{m} codes of {n}: {share}"
                _close(ours[f"{m}_scale"].numpy(), st[f"{m}_scale"].numpy(), f"{m} scale {n}")


@pytest.mark.parametrize("name", ["adafactor", "adamw-8bit"])
def test_resume_equals_uninterrupted(name, tmp_path):
    """A run checkpointed after its first update (``Checkpointer``, the
    trainer's file) and resumed takes the next two as an uninterrupted run."""
    from vap_tpu_torch.training.checkpoint import Checkpointer, TrainState

    params, grads = _draws(2)
    tensors, opt = _port(name, params)
    for g in grads:
        _port_step(opt, tensors, g)
    tensors2, opt2 = _port(name, params)
    _port_step(opt2, tensors2, grads[0])
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(1, params={n: t.detach() for n, t in zip(PARAMS, tensors2)},
              opt_state=opt2.state_dict(), train_state=TrainState(step=1), data_position=1)
    restored = ckpt.restore()
    tensors3, opt3 = _port(name, {n: v.numpy() for n, v in restored["params"].items()})
    opt3.load_state_dict(restored["opt_state"])
    for g in grads[1:]:
        _port_step(opt3, tensors3, g)
    for a, b in zip(tensors, tensors3):
        assert torch.equal(a, b)
    assert opt3.count == opt.count == STEPS


@pytest.mark.parametrize("members", [1, 2])
def test_8bit_state_bytes_and_chunks(members, monkeypatch):
    """About 2.004 bytes of state per parameter; chunking a leaf changes
    nothing, also where a chunk runs across two stacked members (blocks of
    256, chunks of 2 blocks: the members' 19200 elements end mid-chunk)."""
    rng = np.random.default_rng(3)
    ws = [rng.standard_normal((96, 200)).astype(np.float32) for _ in range(members)]
    gs = [rng.standard_normal((96, 200)).astype(np.float32) for _ in range(members)]
    monkeypatch.setattr(toptim8, "BLOCK_SIZE", 256)
    outs = []
    for chunk in (1 << 13, 2):
        monkeypatch.setattr(toptim8, "CHUNK_BLOCKS", chunk)
        ps = [torch.nn.Parameter(torch.from_numpy(w.copy())) for w in ws]
        opt = toptim8.Adam8bit(ps, lr=1e-2, weight_decay=1e-4, kernels=[True] * members,
                               groups=["blocks"] * members)
        for p, g in zip(ps, gs):
            p.grad = torch.from_numpy(g.copy())
        opt.step()
        outs.append([p.detach().clone() for p in ps])
        nb = 75 * members
        assert opt.state_bytes() == 2 * nb * 256 + 2 * nb * 4
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.get_optimizer("lion", [torch.nn.Parameter(torch.zeros(2))], lambda c: 1e-3)
