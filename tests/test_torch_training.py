"""The port's training (sdtpu_torch.training) against sdtpu's, on the CPU.

- The loss and every UNet gradient against jax.value_and_grad of
  sdtpu.training.diffusion_loss, at SD_TINY's UNet widened to 32 channels
  (d_head 8, which the differentiable flash branch takes) on 64x64
  latents, so the level-0 transformers run it (S = 4096), with and without
  a context-validity mask;
- remat "full"/"dots"/"heavy" against remat=False, and which forward the
  backward recomputes;
- AdamW with clipping and its schedule against optax over 5 steps (and
  Adafactor in tests/test_torch_optim.py);
- ema_update, accumulation, and three train steps with sdtpu's t/noise
  draws injected against sdtpu's step_core.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import sdtpu.config as jcfg
from sdtpu import training as jtrain
from sdtpu.io.native import flatten_tree as jflatten
from sdtpu_torch import config as tcfg
from sdtpu_torch import training as ttrain
from sdtpu_torch.io.native import flatten_tree
from sdtpu_torch.ops import attention as tattn
from sdtpu_torch.ops import flash_attention as tfa
from sdtpu_torch.weights import from_numpy_tree

torch.set_num_threads(1)


def _configs(model_channels):
    """sdtpu's and the port's SD_TINY with the UNet at model_channels."""
    j = dataclasses.replace(jcfg.SD_TINY, unet=dataclasses.replace(
        jcfg.SD_TINY.unet, model_channels=model_channels))
    t = dataclasses.replace(tcfg.SD_TINY, unet=dataclasses.replace(
        tcfg.SD_TINY.unet, model_channels=model_channels))
    return j, t


def _port_unet(tc, seed=0):
    """The port's random UNet (sdtpu's tree and scales), f32 masters."""
    from sdtpu_torch.models.unet import init_unet
    from sdtpu_torch.weights import Init

    return ttrain.master_params(init_unet(Init(torch.Generator().manual_seed(seed), "cpu"),
                                          tc.unet))


def _unet(tc, seed=0):
    """One random UNet for both sides: sdtpu's tree as numpy arrays, and the
    port's f32 master copy of the same numbers."""
    params = _port_unet(tc, seed)
    return ttrain.tree_map(lambda p: p.detach().numpy().copy(), params), params


def _batch(b, hw, ctx_dim, seed, n_ctx=7):
    r = np.random.default_rng(seed)
    latents = r.standard_normal((b, hw, hw, 4)).astype(np.float32)
    context = r.standard_normal((b, n_ctx, ctx_dim)).astype(np.float32)
    noise = r.standard_normal((b, hw, hw, 4)).astype(np.float32)
    valid = np.arange(n_ctx)[None, :] < r.integers(2, n_ctx, size=(b, 1))
    return latents, context, noise, valid


def _compare_trees(got, want, rtol, atol):
    """Every leaf of the port's tree (torch; or its flat {path: leaf})
    against sdtpu's (numpy/jax), by key path; returns the largest absolute
    difference."""
    g = got if all(isinstance(k, str) and torch.is_tensor(v) for k, v in got.items()) \
        else flatten_tree(got)
    w = jflatten(want)
    assert set(g) == set(w)
    worst = 0.0
    for k in sorted(w):
        a = g[k].detach().float().numpy()
        np.testing.assert_allclose(a, np.asarray(w[k], np.float32), rtol=rtol, atol=atol,
                                   err_msg=k)
        worst = max(worst, float(np.abs(a - np.asarray(w[k], np.float32)).max()))
    return worst


# f32 on both sides, the same math in another summation order through a
# 20-conv UNet and its backward; measured max |diff|: loss < 1e-6 relative,
# gradients 2.1e-7 (rtol covers the small ones)
UNET_GRAD_TOL = dict(rtol=1e-4, atol=2e-6)


@functools.cache
def _jax_loss_and_grads(jc):
    """sdtpu's diffusion_loss under jax.value_and_grad, jitted once per
    configuration (the masked and unmasked cases share the trace)."""
    return jax.jit(jax.value_and_grad(
        lambda p, latents, context, t, noise, valid: jtrain.diffusion_loss(
            p, jc, latents, context, t, noise, ctx_valid=valid)))


@pytest.mark.parametrize("masked", [False, True])
def test_unet_loss_and_grads_match_sdtpu(masked, monkeypatch):
    """The whole UNet's loss and gradients, with the level-0 transformers on
    the differentiable flash branch (plain K1 forward, plain K9 backward on
    the CPU) against sdtpu's diffusion_loss under jax.value_and_grad. The
    port's unmasked case (ctx_valid=None) is held to sdtpu's loss with every
    key valid, which is its unmasked loss exactly (a where() on an all-true
    mask), so both cases share one JAX compile."""
    jc, tc = _configs(32)
    tree, params = _unet(tc)
    latents, context, noise, valid = _batch(1, 64, jc.unet.context_dim, 1)
    t = np.array([700], np.int32)
    kv = valid if masked else None

    flash = []
    monkeypatch.setattr(tattn, "flash_qkv_attention_diff",
                        lambda *a: flash.append(a[0].shape) or tfa.flash_qkv_attention_diff(*a))
    loss = ttrain.diffusion_loss(params, tc, torch.from_numpy(latents),
                                 torch.from_numpy(context), torch.from_numpy(t).long(),
                                 torch.from_numpy(noise),
                                 None if kv is None else torch.from_numpy(kv))
    grads = torch.autograd.grad(loss, ttrain.tree_leaves(params))
    assert flash == [(1, 4096, 32)] * 5  # the five level-0 transformers

    jl, jg = _jax_loss_and_grads(jc)(tree, latents, context, t, noise,
                                     valid if masked else np.ones_like(valid))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6, atol=1e-7)
    _compare_trees(dict(zip(flatten_tree(params), grads)), jg, **UNET_GRAD_TOL)


@pytest.mark.parametrize("remat", [True, "full", "dots", "heavy"])
def test_remat_policies_match_no_remat(remat, monkeypatch):
    """remat changes what is kept for the backward pass, never the math;
    "full" runs the level-0 flash forward again in the backward, "dots" and
    "heavy" save its output (sdtpu's attn_out) and do not."""
    _, tc = _configs(32)
    params = _port_unet(tc)
    monkeypatch.setattr(tattn, "FLASH_MIN_SEQ", 256)  # 16x16 latents take the flash branch
    latents, context, noise, valid = (torch.from_numpy(a) for a in _batch(2, 16, 32, 2))
    t = torch.tensor([3, 7])
    forwards = []
    real_attend = tfa._attend
    monkeypatch.setattr(tfa, "_attend", lambda *a, **k: forwards.append(1) or real_attend(*a, **k))

    def lg(r):
        forwards.clear()
        return ttrain.loss_and_grads(params, tc, latents, context, t, noise, valid, remat=r), \
            len(forwards)

    (l_ref, g_ref), n_ref = lg(False)
    (l, g), n = lg(remat)
    assert n_ref == 5
    assert n == (10 if remat in (True, "full") else 5), n
    assert abs(float(l) - float(l_ref)) < 1e-6
    for a, b in zip(g_ref, g):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


def test_remat_invalid_policy_raises():
    from sdtpu_torch.models.unet import _remat_policy

    with pytest.raises(ValueError, match="remat must be"):
        _remat_policy("everything")


@pytest.mark.parametrize("warmup", [0, 2])
def test_adamw_matches_optax(warmup):
    """make_optimizer against sdtpu's optax chain over 5 steps, the
    gradients' global norm above the clip (1.0) on steps 0, 2, 4 and below
    it on 1, 3; weight decay on every leaf."""
    r = np.random.default_rng(3)
    tree = {"a": {"w": r.standard_normal((4, 3)).astype(np.float32)},
            "b": r.standard_normal((5,)).astype(np.float32)}
    jopt = jtrain.make_optimizer(lr=1e-2, warmup_steps=warmup, total_steps=5,
                                 weight_decay=1e-2, grad_clip=1.0)
    topt = ttrain.make_optimizer(lr=1e-2, warmup_steps=warmup, total_steps=5,
                                 weight_decay=1e-2, grad_clip=1.0)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jopt.init(jp)
    tp = ttrain.master_params(from_numpy_tree(tree, device="cpu"))
    tstate = topt.init(tp)
    for i in range(5):
        scale = 3.0 if i % 2 == 0 else 0.05
        g = {"a": {"w": scale * r.standard_normal((4, 3)).astype(np.float32)},
             "b": scale * r.standard_normal((5,)).astype(np.float32)}
        norm = np.sqrt(sum(float((x ** 2).sum()) for x in jax.tree_util.tree_leaves(g)))
        assert (norm > 1.0) == (i % 2 == 0)
        upd, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        topt.update(tp, [torch.from_numpy(x) for x in (g["a"]["w"], g["b"])], tstate)
        # f32 on both sides; optax's scalars are f32, the port's f64 rounded
        _compare_trees(tp, jp, rtol=1e-6, atol=1e-7)
    assert topt.schedule(0) == (0.0 if warmup else 1e-2)


def test_make_optimizer_refuses_adafactor():
    """Adafactor is ported (tests/test_torch_optim.py holds it against
    sdtpu's); an unknown kind is refused with sdtpu's ValueError."""
    assert isinstance(ttrain.make_optimizer(kind="adafactor"), ttrain.Adafactor)
    with pytest.raises(ValueError, match="kind must be adamw|adafactor"):
        ttrain.make_optimizer(kind="sgd")


def test_v_prediction_loss_target():
    """The v objective (SD v2.1-768's): the loss is the MSE against
    v = sqrt(a_t)·eps - sqrt(1 - a_t)·x0, computed here from the same
    q-sampled input (sdtpu's test_v_prediction_loss_target)."""
    from sdtpu_torch.models.unet import unet_apply
    from sdtpu_torch.ops import dispatch

    tc = dataclasses.replace(tcfg.SD_TINY, prediction_type="v")
    params = _port_unet(tc)
    latents, context, noise, _ = (torch.from_numpy(a) for a in _batch(2, 16, 32, 7))
    t = torch.tensor([3, 700])
    with torch.no_grad():
        got = float(ttrain.diffusion_loss(params, tc, latents, context, t, noise))
        alphas = torch.from_numpy(ttrain.cfg_alphas(tc).copy())
        with dispatch.training():
            pred = unet_apply(params, ttrain.q_sample(latents, noise, alphas, t), t, context,
                              tc.unet)
    a_t = alphas[t].reshape(-1, 1, 1, 1)
    v = torch.sqrt(a_t) * noise - torch.sqrt(1.0 - a_t) * latents
    np.testing.assert_allclose(got, float(torch.mean((pred - v) ** 2)), rtol=1e-6)
    np.testing.assert_array_equal(ttrain.cfg_alphas(tc), jtrain.cfg_alphas(jcfg.SD_TINY))


def test_ema_update():
    e = {"w": torch.ones(3)}
    p = {"w": torch.tensor([1.0, 2.0, 3.0])}
    out = ttrain.ema_update(e, p, 0.75)
    assert out is e
    torch.testing.assert_close(e["w"], torch.tensor([1.0, 1.25, 1.5]))


def test_accum_matches_one_batch():
    """accum=2: two micro-batches, their gradients averaged in f32 = the
    whole batch's gradient up to summation order (sdtpu's
    test_grad_accum_equivalence); an indivisible batch raises."""
    _, tc = _configs(16)
    params = _port_unet(tc)
    latents, context, noise, valid = (torch.from_numpy(a) for a in _batch(4, 16, 32, 4))
    t = torch.tensor([1, 200, 500, 999])
    l1, g1 = ttrain.loss_and_grads(params, tc, latents, context, t, noise, valid)
    l2, g2 = ttrain.loss_and_grads(params, tc, latents, context, t, noise, valid, accum=2)
    assert abs(float(l1) - float(l2)) < 1e-6
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-6)
    with pytest.raises(ValueError, match="not divisible"):
        ttrain.loss_and_grads(params, tc, latents, context, t, noise, valid, accum=3)


# three AdamW steps (lr 1e-3, the first at lr 0: warmup) after sdtpu's:
# the gradients agree to about 1e-6 relative, and Adam's normalised step
# lr·m/(sqrt(v) + eps) carries a gradient's relative difference into the
# update; measured max |param diff| 9.7e-7 over all leaves, 1e-3 of a step
STEP_TOL = dict(rtol=1e-6, atol=5e-6)


def test_train_steps_match_sdtpu_step_core():
    """Three make_train_step steps at SD_TINY, AdamW with warmup and
    clipping, with sdtpu's t/noise draws injected, against sdtpu's jitted
    step: the losses and the parameters after each step."""
    jc, tc = jcfg.SD_TINY, tcfg.SD_TINY
    tree, params = _unet(tc, seed=1)
    latents, context, _, valid = _batch(2, jc.latent_size, jc.unet.context_dim, 5)
    jopt = jtrain.make_optimizer(lr=1e-3, warmup_steps=1, total_steps=3)
    topt = ttrain.make_optimizer(lr=1e-3, warmup_steps=1, total_steps=3)
    jstep = jax.jit(jtrain.make_train_step(jc, jopt))
    tstep = ttrain.make_train_step(tc, topt)
    jp, jstate = tree, jopt.init(tree)
    tstate = topt.init(params)
    jbatch = (jnp.asarray(latents), jnp.asarray(context), jnp.asarray(valid))
    tbatch = (torch.from_numpy(latents), torch.from_numpy(context), torch.from_numpy(valid))
    for i in range(3):
        key = jax.random.PRNGKey(20 + i)
        kt, kn = jax.random.split(key)  # step_core's own draws
        t = np.asarray(jax.random.randint(kt, (2,), 0, jc.n_train_steps))
        noise = np.asarray(jax.random.normal(kn, latents.shape, jnp.float32))
        jp, jstate, jl = jstep(jp, jstate, jbatch, key)
        params, tstate, tl = tstep(params, tstate, tbatch, t=torch.from_numpy(t).long(),
                                   noise=torch.from_numpy(noise))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-7)
        _compare_trees(params, jp, **STEP_TOL)
    assert tstate.count == 3


def test_train_step_draws_from_the_generator():
    """Without injected draws the step takes t, then the noise, from the
    generator: the same seed gives the same loss, another seed another."""
    tc = tcfg.SD_TINY
    latents, context, _, _ = _batch(2, tc.latent_size, tc.unet.context_dim, 6)
    batch = (torch.from_numpy(latents), torch.from_numpy(context))
    losses = []
    for seed in (0, 0, 1):
        params = _port_unet(tc)
        opt = ttrain.make_optimizer(lr=1e-3, warmup_steps=0, total_steps=1)
        step = ttrain.make_train_step(tc, opt, ema_decay=0.5)
        ema = ttrain.tree_map(lambda p: p.detach().clone(), params)
        params, _, ema, loss = step(params, opt.init(params), ema, batch,
                                    torch.Generator().manual_seed(seed))
        losses.append(float(loss))
        e, p = flatten_tree(ema), flatten_tree(params)
        k = "conv_out/w"
        assert not torch.equal(e[k], p[k])  # the shadow trails the weights
    assert losses[0] == losses[1] != losses[2]
