"""The port's optimizers and gradient accumulator against sdtpu's optax
chains, on the CPU, on numpy inputs made from a seed.

- Adafactor (make_optimizer(kind="adafactor")) against sdtpu's at
  weight_decay 0 over 5 steps on a factored 4-D leaf, a factored matrix,
  a 4-D leaf whose second-largest dim is under 128 (unfactored), a vector
  and a small matrix; with the clip active on some steps and a warmup.
- Its weight decay: each step equals sdtpu's weight_decay=0 update from the
  same weights minus lr_t·wd·w. sdtpu's own decay ignores the learning
  rate (a step at lr 0 moves the weights); the port's does not.
- Its factored dims and state shapes against optax's.
- The bf16 gradient accumulator against sdtpu's multi_steps(...,
  accum_dtype=bfloat16) on the same k gradient trees: the running sum and
  the parameters after the k-th call; and through the UNet's micro-batches
  against the f32 sum.
- AdamW(lr) alone against optax.adam(lr) (textual inversion's optimizer).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from optax._src import factorized

from sdtpu import training as jtrain
from sdtpu_torch import training as ttrain

torch.set_num_threads(1)

SHAPES = {"conv": (3, 3, 160, 256), "mat": (256, 320), "small_conv": (3, 3, 32, 256),
          "vec": (320,), "tiny": (4, 8)}
# f32 on both sides, the same formulas with another summation order in the
# means and rms; measured max |diff| 1.5e-8 on weights up to 0.24
ADAFACTOR_TOL = dict(rtol=1e-6, atol=1e-7)


def _tree(seed, scale=0.05):
    r = np.random.default_rng(seed)
    return {k: (scale * r.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}


def _grads(r, step):
    """Gradients whose global norm is above the clip (1.0) on even steps and
    below it on odd ones."""
    scale = 3.0 if step % 2 == 0 else 0.01
    return {k: (scale * r.standard_normal(s) / np.sqrt(np.prod(s) * len(SHAPES)))
            .astype(np.float32) for k, s in SHAPES.items()}


def _port(tree):
    return {k: torch.tensor(v, requires_grad=True) for k, v in tree.items()}


def _assert_close(got, want, tol):
    worst = 0.0
    for k in want:
        a, b = got[k].detach().numpy(), np.asarray(want[k])
        np.testing.assert_allclose(a, b, err_msg=k, **tol)
        worst = max(worst, float(np.abs(a - b).max()))
    return worst


@pytest.mark.parametrize("warmup", [0, 2])
def test_adafactor_matches_sdtpu_without_decay(warmup):
    jopt = jtrain.make_optimizer(lr=1e-2, warmup_steps=warmup, total_steps=5,
                                 weight_decay=0.0, kind="adafactor")
    topt = ttrain.make_optimizer(lr=1e-2, warmup_steps=warmup, total_steps=5,
                                 weight_decay=0.0, kind="adafactor")
    assert isinstance(topt, ttrain.Adafactor)
    tree = _tree(0)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jopt.init(jp)
    tp = _port(tree)
    tstate = topt.init(tp)
    r = np.random.default_rng(1)
    for i in range(5):
        g = _grads(r, i)
        upd, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        topt.update(tp, [torch.from_numpy(g[k]) for k in tp], tstate)
        _assert_close(tp, jp, ADAFACTOR_TOL)
    assert tstate.count == 5
    moved = [k for k in tp if not np.array_equal(tp[k].detach().numpy(), tree[k])]
    assert moved == list(SHAPES)


def test_adafactor_decay_is_scaled_by_the_learning_rate():
    """From the same weights each step, the port's update with weight decay
    is sdtpu's weight_decay=0 update minus lr_t·wd·w (the second moments
    depend on the gradients only, so both states stay in step)."""
    wd = 1e-2
    jopt = jtrain.make_optimizer(lr=1e-2, warmup_steps=2, total_steps=5, weight_decay=0.0,
                                 kind="adafactor")
    topt = ttrain.make_optimizer(lr=1e-2, warmup_steps=2, total_steps=5, weight_decay=wd,
                                 kind="adafactor")
    tp = _port(_tree(2))
    tstate = topt.init(tp)
    jstate = jopt.init(jax.tree_util.tree_map(jnp.asarray, _tree(2)))
    r = np.random.default_rng(3)
    for i in range(5):
        g = _grads(r, i)
        w = {k: v.detach().numpy().copy() for k, v in tp.items()}
        jw = jax.tree_util.tree_map(jnp.asarray, w)
        upd, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jw)
        lr = topt.schedule(i)
        want = {k: np.asarray(v) - np.float32(lr * wd) * w[k]
                for k, v in optax.apply_updates(jw, upd).items()}
        topt.update(tp, [torch.from_numpy(g[k]) for k in tp], tstate)
        _assert_close(tp, want, ADAFACTOR_TOL)


@pytest.mark.parametrize("warmup", [0, 10])
def test_sdtpu_decays_at_lr_zero_and_the_port_does_not(warmup):
    """run_finetune's defaults (lr 1e-5, weight decay 1e-2) on a weight of
    ones with gradient 1e-3: sdtpu's first update is about -0.01 whatever
    the warmup (optax adds weight_decay_rate · w after the learning rate);
    the port's is -lr_0 · (1 + wd): 0 at the warmup's lr 0."""
    w = np.ones((4, 8), np.float32)
    g = np.full((4, 8), 1e-3, np.float32)
    jopt = jtrain.make_optimizer(lr=1e-5, warmup_steps=warmup, total_steps=100,
                                 weight_decay=1e-2, kind="adafactor")
    upd, _ = jopt.update(jnp.asarray(g), jopt.init(jnp.asarray(w)), jnp.asarray(w))
    np.testing.assert_allclose(np.asarray(upd), -0.01 - (1e-5 if warmup == 0 else 0.0),
                               rtol=1e-4)
    topt = ttrain.make_optimizer(lr=1e-5, warmup_steps=warmup, total_steps=100,
                                 weight_decay=1e-2, kind="adafactor")
    p = torch.tensor(w, requires_grad=True)
    topt.update(p, [torch.from_numpy(g)], topt.init(p))
    moved = p.detach().numpy() - w
    if warmup:
        assert not moved.any()
    else:  # within the f32 rounding of a weight of 1 (2^-23)
        np.testing.assert_allclose(moved, -1e-5 * (1.0 + 1e-2), rtol=0, atol=2.0 ** -23)


@pytest.mark.parametrize("shape", [(3, 3, 160, 256), (256, 320), (3, 3, 32, 256), (320,),
                                   (128, 128), (320, 320, 1), (1280, 128, 3, 3), (127, 4096)])
def test_factored_dims_and_state_as_optax(shape):
    assert ttrain.Adafactor.factored_dims(shape) == factorized._factored_dims(shape, True, 128)
    jstate = optax.adafactor(1e-3).init(jnp.zeros(shape))[0]
    tstate = ttrain.Adafactor(1e-3).init(torch.zeros(shape))
    for field in ("v_row", "v_col", "v"):
        got = getattr(tstate, field)[0]
        want = np.asarray(getattr(jstate, field))
        # optax keeps a [1] placeholder where the port keeps None
        assert (tuple(got.shape) if got is not None else (1,)) == want.shape, field


@pytest.mark.parametrize("k", [2, 3])
def test_bf16_accumulator_matches_multi_steps(k):
    """k gradient trees through sdtpu's multi_steps(adamw, k, bf16) and
    through accumulate_grads/mean_grads + the port's AdamW: the running bf16
    sums after k - 1 calls within 1 bf16 ulp of sdtpu's (measured: equal),
    then the parameters after the k-th call within the AdamW tolerance."""
    tree = _tree(4)
    inner = jtrain.make_optimizer(lr=1e-2, warmup_steps=0, total_steps=3)
    jopt = jtrain.multi_steps(inner, k, accum_dtype=jnp.bfloat16)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jopt.init(jp)
    topt = ttrain.make_optimizer(lr=1e-2, warmup_steps=0, total_steps=3)
    tp = _port(tree)
    tstate = topt.init(tp)
    r = np.random.default_rng(5)
    g_sum = None
    for i in range(k):
        g = {key: v * np.float32(1 + i) for key, v in _grads(r, 1).items()}
        upd, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        g_sum = ttrain.accumulate_grads(g_sum, [torch.from_numpy(g[key]) for key in tp],
                                        torch.bfloat16)
        if i < k - 1:
            assert int(jstate.mini_step) == i + 1
            for key, got in zip(tp, g_sum):
                want = torch.from_numpy(np.asarray(jstate.acc_grads[key], np.float32))
                assert got.dtype == torch.bfloat16
                ulp = torch.finfo(torch.bfloat16).eps * want.abs().clamp_min(1e-30)
                assert bool(((got.float() - want).abs() <= ulp).all()), key
    topt.update(tp, ttrain.mean_grads(g_sum, k, torch.bfloat16), tstate)
    assert int(jstate.gradient_step) == 1
    _assert_close(tp, jp, dict(rtol=1e-6, atol=1e-7))


def test_bf16_accumulation_through_the_unet():
    """loss_and_grads with two micro-batches, the gradients' running sum in
    bf16, against the f32 sum: the same loss, the gradients within bf16's
    rounding: two casts and a sum, each under 2^-9 of the micro-batches'
    gradients, held to 2^-7 of each leaf's largest mean gradient (measured
    worst 0.76 of that)."""
    from test_torch_training import _batch, _configs, _port_unet

    _, tc = _configs(16)
    params = _port_unet(tc)
    latents, context, noise, valid = (torch.from_numpy(a) for a in _batch(4, 16, 32, 4))
    t = torch.tensor([1, 200, 500, 999])
    l32, g32 = ttrain.loss_and_grads(params, tc, latents, context, t, noise, valid, accum=2)
    l16, g16 = ttrain.loss_and_grads(params, tc, latents, context, t, noise, valid, accum=2,
                                     accum_dtype=torch.bfloat16)
    assert float(l16) == float(l32)
    for a, b in zip(g32, g16):
        assert b.dtype == torch.float32
        torch.testing.assert_close(b, a, rtol=0, atol=float(a.abs().max()) * 2.0 ** -7)
    assert any(not torch.equal(a, b) for a, b in zip(g32, g16))  # the sum did round


def test_adam_matches_optax_adam():
    """AdamW(lr) with no decay, clip or schedule is optax.adam(lr), the
    optimizer of textual inversion, over 5 steps."""
    tree = {"rows": np.random.default_rng(6).standard_normal((2, 32)).astype(np.float32)}
    jopt = optax.adam(5e-3)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jopt.init(jp)
    topt = ttrain.AdamW(5e-3)
    tp = _port(tree)
    tstate = topt.init(tp)
    r = np.random.default_rng(7)
    for i in range(5):
        g = {"rows": (10.0 * r.standard_normal((2, 32))).astype(np.float32)}  # norm > 1: no clip
        upd, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        topt.update(tp, [torch.from_numpy(g["rows"])], tstate)
        _assert_close(tp, jp, dict(rtol=1e-6, atol=1e-7))
    assert topt.schedule(0) == topt.schedule(1000) == 5e-3
