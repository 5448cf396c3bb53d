"""LoRA training: the port's init_lora, lora_param_count and
make_lora_train_step against sdtpu/lora.py, on the CPU at SD_TINY.

- init_lora adapts exactly sdtpu's targets (the 2-D query/key/value/out
  linears of sdtpu's unfused UNet tree) with sdtpu's shapes: a ~ N(0, 1) /
  sqrt(rank), b = 0.
- Two train steps (AdamW, f32) from sdtpu's adapter init carried across as
  numpy, with sdtpu's t and noise injected, against sdtpu's jitted step:
  the losses and the adapter after each step; the base is bit-unchanged.
- Under bf16 compute the UNet reads the merged weights in bf16 (sdtpu's
  eff_dtype) and every other leaf of the base by reference; accumulation
  over two micro-batches equals one batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdtpu.config as jcfg
from sdtpu import lora as jlora
from sdtpu import training as jtrain
from sdtpu.io.native import flatten_tree as jflatten
from sdtpu_torch import config as tcfg
from sdtpu_torch import lora as tlora
from sdtpu_torch import training as ttrain
from sdtpu_torch.io.native import flatten_tree
from test_torch_training import _batch, _compare_trees, _unet

torch.set_num_threads(1)

# f32 on both sides; Adam's normalised step lr·m/(sqrt(v) + eps) carries a
# gradient's relative difference into the update; measured max |diff|
# 6.1e-7 over the adapter after two steps at lr 1e-3
LORA_STEP_TOL = dict(rtol=1e-6, atol=5e-6)


@pytest.fixture(scope="module")
def base():
    """One random SD_TINY UNet: sdtpu's tree as numpy, the port's frozen
    copy of the same numbers."""
    tree, params = _unet(tcfg.SD_TINY, seed=2)
    return tree, ttrain.tree_map(lambda p: p.detach(), params)


def _port_tree(tree):
    return ttrain.tree_map(lambda a: torch.tensor(np.asarray(a)), tree)


@pytest.mark.parametrize("rank", [1, 4])
def test_init_lora_targets_as_sdtpu(base, rank):
    tree, params = base
    want = jflatten(jlora.init_lora(jax.random.PRNGKey(0), tree, rank=rank))
    lora = tlora.init_lora(torch.Generator().manual_seed(1), params, rank=rank)
    got = flatten_tree(lora)
    assert set(got) == set(want)
    for k, v in got.items():
        assert tuple(v.shape) == np.asarray(want[k]).shape and v.dtype == torch.float32, k
        if k.endswith("/b"):
            assert not v.any(), k
    a = torch.cat([v.flatten() for k, v in got.items() if k.endswith("/a")])
    assert abs(float(a.std()) * rank ** 0.5 - 1.0) < 0.05  # N(0, 1) / sqrt(rank)
    assert tlora.lora_param_count(lora) == jlora.lora_param_count(
        jlora.init_lora(jax.random.PRNGKey(0), tree, rank=rank))
    with pytest.raises(ValueError, match="no"):
        tlora.init_lora(torch.Generator(), {"conv": {"w": torch.zeros(3, 3, 4, 4)}})


def test_lora_train_steps_match_sdtpu(base):
    tree, params = base
    jc, tc = jcfg.SD_TINY, tcfg.SD_TINY
    scale = 8.0 / 4
    jl = jlora.init_lora(jax.random.PRNGKey(3), tree, rank=4)
    tl = ttrain.master_params(_port_tree(jl))
    latents, context, _, valid = _batch(2, jc.latent_size, jc.unet.context_dim, 8)
    jopt = jtrain.make_optimizer(lr=1e-3, warmup_steps=0, total_steps=2)
    topt = ttrain.make_optimizer(lr=1e-3, warmup_steps=0, total_steps=2)
    jstep = jax.jit(jlora.make_lora_train_step(jc, jopt, scale))
    tstep = tlora.make_lora_train_step(tc, topt, scale)
    jstate, tstate = jopt.init(jl), topt.init(tl)
    before = {k: v.clone() for k, v in flatten_tree(params).items()}
    jbatch = (jnp.asarray(latents), jnp.asarray(context), jnp.asarray(valid))
    tbatch = (torch.from_numpy(latents), torch.from_numpy(context), torch.from_numpy(valid))
    for i in range(2):
        key = jax.random.PRNGKey(30 + i)
        kt, kn = jax.random.split(key)  # the step's own draws
        t = np.array(jax.random.randint(kt, (2,), 0, jc.n_train_steps))
        noise = np.array(jax.random.normal(kn, latents.shape, jnp.float32))
        jl, jstate, jloss = jstep(jl, jstate, tree, jbatch, key)
        tl, tstate, tloss = tstep(tl, tstate, params, tbatch, t=torch.from_numpy(t).long(),
                                  noise=torch.from_numpy(noise))
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5, atol=1e-7)
        _compare_trees(tl, jl, **LORA_STEP_TOL)
    b = [v for k, v in flatten_tree(tl).items() if k.endswith("/b")]
    assert all(bool(v.any()) for v in b)  # every b has moved off 0
    after = flatten_tree(params)
    assert all(torch.equal(after[k], v) for k, v in before.items())
    assert all(not v.requires_grad for v in after.values())


def test_lora_bf16_merge_and_accumulation(base, monkeypatch):
    _, params = base
    tc = tcfg.SD_TINY
    lora = ttrain.master_params(tlora.init_lora(torch.Generator().manual_seed(4), params, 2))
    latents, context, noise, valid = (torch.from_numpy(a) for a in
                                      _batch(4, tc.latent_size, tc.unet.context_dim, 9))
    t = torch.tensor([3, 300, 600, 900])
    seen = []
    real = tlora.diffusion_loss
    monkeypatch.setattr(tlora, "diffusion_loss",
                        lambda p, *a, **k: seen.append(p) or real(p, *a, **k))
    opt = ttrain.make_optimizer(lr=0.0, warmup_steps=0, total_steps=1)
    tlora.make_lora_train_step(tc, opt, 1.0, compute_dtype=torch.bfloat16)(
        lora, opt.init(lora), params, (latents, context, valid), t=t, noise=noise)
    eff, flat_base = flatten_tree(seen[0]), flatten_tree(params)
    targets = {k[:-2] + "/w" for k in flatten_tree(lora) if k.endswith("/a")}
    for k, v in eff.items():
        if k in targets:
            assert v.dtype == torch.bfloat16 and v.requires_grad, k
        else:
            assert v is flat_base[k], k

    # two micro-batches against one batch, through micro_batch_grads
    def grads(accum, accum_dtype=None):
        def loss_of(sl):
            return real(tlora.apply_lora(params, lora, 1.0), tc, latents[sl], context[sl], t[sl],
                        noise[sl], valid[sl])
        return ttrain.micro_batch_grads(loss_of, ttrain.tree_leaves(lora), 4, accum, accum_dtype)

    (l1, g1), (l2, g2) = grads(1), grads(2)
    assert abs(float(l1) - float(l2)) < 1e-6
    for a, b in zip(g1, g2):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-6)
    with pytest.raises(ValueError, match="not divisible"):
        grads(3)
