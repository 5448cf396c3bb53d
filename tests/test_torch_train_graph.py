"""The fine-tuning step as one captured program (training.run_step,
graphs.Program(step=True)), tested at sd-tiny.

On the CPU:
- (a) the split step (the draws and the optimizer's host scalars first,
  then a body of device work) equals the step as it was (the draws inside,
  the clip's norm read back to the host, the optimizer's scalars passed as
  Python numbers: kept here as _old_*), bit for bit over 3 steps, for the
  full UNet, LoRA and textual inversion, AdamW and Adafactor on a warmup
  schedule, accum 1 and 2 (f32 and bf16 sums), the EMA on and off, and the
  clip triggered and not;
- (b) from the second step on (when a capture would run it) the body reads
  nothing back to the host and makes no tensor from host data;
- (c) the step's key holds every tensor of its trees, the optimizer's kind
  and flags, the EMA decay, accum and its dtype, remat, the compute dtype,
  the batch's shapes and mask, the gates with training open;
- (d) refusals: graphs on a mesh, on the CPU, a train step's own warm-up or
  an ensure() of it;
- (e) the launch record follows a capture's stream to another thread (the
  backward's, on autograd's device thread), and another stream's launches
  stay counted;
- (f) through a pipeline whose graph cache is a spy: the latent cache runs
  the encoder's and CLIP's programs, textual inversion's data the
  encoder's, the last chunk at its own size (a key of its own), and
  run_finetune (full with the EMA and accum 2, LoRA with the EMA) and
  run_textual_inversion run one step program a step, each bit-equal to its
  eager run, the step programs dropped at the end.

On the card (marked cuda, skipped here): replayed steps against eager ones
bit for bit over 4 steps (the trees, the optimizer state, the EMA, the
losses) for each step kind, a run resumed from a saved state, two step
graphs in turns, the latent cache replayed against eager, and the launch
record of a replayed step (K1 and K9) against an eager step's counts, and
the prefetch thread's batches read on another stream.
"""

import copy
import dataclasses
import functools
import threading

import numpy as np
import pytest
import torch

from sdtpu_torch import finetune as tfinetune
from sdtpu_torch import graphs, kernels
from sdtpu_torch import lora as tlora
from sdtpu_torch import textual_inversion as tti
from sdtpu_torch import training as ttrain
from sdtpu_torch.config import SD_TINY
from sdtpu_torch.models.clip import clip_apply
from sdtpu_torch.models.unet import unfuse_qkv
from sdtpu_torch.ops import attention, dispatch
from sdtpu_torch.pipeline import StableDiffusion
from sdtpu_torch.weights import init_params

torch.set_num_threads(1)

CFG = SD_TINY
HW = 8  # latents 8x8: SD_TINY's two levels
STEPS = 3


# ------------------------------------------------------------ the step as it was

def _old_clip(opt, g):
    if opt.grad_clip is None:
        return
    norm = float(torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g))))
    if not norm < opt.grad_clip:
        torch._foreach_div_(g, norm)
        torch._foreach_mul_(g, opt.grad_clip)


@torch.no_grad()
def _old_update(opt, params, grads, state):
    """AdamW.update and Adafactor.update as they were (no layout)."""
    g = list(grads)
    _old_clip(opt, g)
    leaves = ttrain.tree_leaves(params)
    lr = opt.schedule(state.count)
    if isinstance(opt, ttrain.AdamW):
        b1, b2 = opt.b1, opt.b2
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, g, alpha=1.0 - b1)
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_addcmul_(state.nu, g, g, value=1.0 - b2)
        state.count += 1
        n = np.float32(state.count)
        u = torch._foreach_div(state.mu, float(1 - np.float32(b1) ** n))
        den = torch._foreach_div(state.nu, float(1 - np.float32(b2) ** n))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, opt.eps)
        torch._foreach_div_(u, den)
        if opt.weight_decay:
            torch._foreach_add_(u, leaves, alpha=opt.weight_decay)
        torch._foreach_add_(leaves, u, alpha=-lr)
        return
    decay = np.float32(1) - np.float32(state.count + 1) ** np.float32(-opt.decay_exponent)
    keep, mix = float(decay), float(np.float32(1) - decay)
    state.count += 1
    for i, (p, gi) in enumerate(zip(leaves, g)):
        g2 = gi * gi + opt.eps
        if state.v[i] is None:
            d1, d0 = state.dims[i]
            v_row = state.v_row[i].mul_(keep).add_(g2.mean(d0), alpha=mix)
            v_col = state.v_col[i].mul_(keep).add_(g2.mean(d1), alpha=mix)
            row = (v_row / v_row.mean(d1 - 1 if d1 > d0 else d1, keepdim=True)).rsqrt_()
            u = gi * row.unsqueeze(d0) * v_col.rsqrt().unsqueeze(d1)
        else:
            u = gi * state.v[i].mul_(keep).add_(g2, alpha=mix).rsqrt()
        u.div_(torch.clamp_min(u.square().mean().sqrt() / opt.clip_threshold, 1.0))
        u.mul_(lr).mul_(p.square().mean().sqrt().clamp_min_(opt.min_scale))
        if opt.weight_decay:
            u.add_(p, alpha=lr * opt.weight_decay)
        p.sub_(u)


def _old_alphas_loss(params, latents, context, t, noise, ctx_valid, compute_dtype, remat):
    """diffusion_loss as it was: the alphas copied from the host each call."""
    alphas = torch.from_numpy(ttrain.cfg_alphas(CFG).copy()).to(latents.device)
    x_t = ttrain.q_sample(latents, noise, alphas, t)
    with dispatch.training():
        pred = ttrain.unet_apply(params, x_t.to(compute_dtype), t, context.to(compute_dtype),
                                 CFG.unet, ctx_valid=ctx_valid, remat=remat)
    return torch.mean((pred.float() - noise) ** 2)


def _old_step(kind, opt, accum=1, accum_dtype=None, ema_decay=None, scale=1.0):
    """One step as make_*_train_step ran it: (trees, batch, gen) -> loss."""
    def step(tree, state, ema, frozen, batch, gen):
        latents = batch[0]
        t, noise = ttrain.draw_t_noise(CFG, latents, gen)
        if kind == "ti":
            with dispatch.training():
                ctx = clip_apply(tti.extend_clip(frozen["clip"], tree), batch[1], CFG.clip)
            loss = _old_alphas_loss(frozen["unet"], latents, ctx, t, noise, batch[2],
                                    torch.float32, False)
            (grad,) = torch.autograd.grad(loss, [tree])
            _old_update(opt, tree, [grad.float()], state)
            return loss.detach()
        context, valid = batch[1], batch[2]

        def loss_of(sl):
            p = tlora.apply_lora(frozen, tree, scale) if kind == "lora" else tree
            return _old_alphas_loss(p, latents[sl], context[sl], t[sl], noise[sl], valid[sl],
                                    torch.float32, False)

        loss, grads = ttrain.micro_batch_grads(loss_of, ttrain.tree_leaves(tree),
                                               latents.shape[0], accum, accum_dtype)
        _old_update(opt, tree, grads, state)
        if ema is not None:
            ttrain.ema_update(ema, tree, ema_decay)
        return loss

    return step


# ------------------------------------------------------------ fixtures

class Spy:
    """A graph cache that runs each program eagerly (as its first step, or
    a replay, would compute) and keeps it; `forbid` from the n-th step
    program on: the body then runs under _no_host_reads."""

    def __init__(self, forbid_from=None, run=True):
        self.programs = []
        self.forbid_from = forbid_from
        self.do_run = run
        self.dropped = []

    def run(self, program):
        self.programs.append(program)
        if not self.do_run:
            return torch.zeros(())
        n = sum(p.step for p in self.programs)
        grad = torch.enable_grad() if program.step else torch.no_grad()
        if program.step and self.forbid_from is not None and n >= self.forbid_from:
            with grad, _no_host_reads():
                return program.fn(program.inputs)
        with grad:
            return program.fn(program.inputs)

    def kinds(self):
        return [p.kind for p in self.programs]

    def stats(self):
        return {"captures": {}, "replays": {}, "kinds": self.kinds()}

    def drop(self, kinds):
        self.dropped.append(tuple(kinds))
        return 0


class _Forbidden(AssertionError):
    pass


class _no_host_reads:
    """Inside: a tensor read back to the host, or made from host data,
    raises (what a capture cannot hold)."""
    NAMES = ("item", "tolist", "numpy", "__float__", "__int__", "__bool__", "__index__")

    def __enter__(self):
        self.saved = {n: getattr(torch.Tensor, n) for n in self.NAMES}
        self.saved_fns = {"from_numpy": torch.from_numpy, "tensor": torch.tensor}

        def forbid(name):
            def f(*a, **k):
                raise _Forbidden(f"{name} inside a step's body")
            return f

        for n in self.NAMES:
            setattr(torch.Tensor, n, forbid(f"Tensor.{n}"))
        torch.from_numpy, torch.tensor = forbid("torch.from_numpy"), forbid("torch.tensor")

    def __exit__(self, *exc):
        for n, f in self.saved.items():
            setattr(torch.Tensor, n, f)
        torch.from_numpy, torch.tensor = self.saved_fns["from_numpy"], self.saved_fns["tensor"]


@functools.cache
def _params():
    return init_params(CFG, torch.Generator().manual_seed(0), device="cpu")


def _unet_tree():
    return unfuse_qkv(_params()["unet"])


def _batch(kind, b=2, seed=0, masked=True):
    r = np.random.default_rng(seed)
    latents = torch.from_numpy(r.standard_normal((b, HW, HW, 4)).astype(np.float32))
    n_ctx = CFG.clip.n_ctx
    valid = torch.from_numpy(np.arange(n_ctx)[None, :] < r.integers(3, 12, size=(b, 1)))
    if kind == "ti":
        tokens = torch.from_numpy(r.integers(0, CFG.clip.n_vocab + 2, (b, n_ctx))).long()
        return latents, tokens, valid
    context = torch.from_numpy(r.standard_normal((b, n_ctx, CFG.unet.context_dim))
                               .astype(np.float32))
    return (latents, context, valid) if masked else (latents, context)


def _setup(kind, opt_kind, clip, ema=False):
    """(trained tree, optimizer, state, EMA or None, frozen tree) for kind."""
    opt = ttrain.make_optimizer(lr=1e-3, warmup_steps=2, total_steps=5, weight_decay=1e-2,
                                grad_clip=clip, kind=opt_kind)
    frozen = None
    if kind == "train":
        tree = ttrain.master_params(_unet_tree())
    elif kind == "lora":
        frozen = ttrain.tree_map(lambda p: p.float() if torch.is_tensor(p) else p,
                                 _unet_tree())
        lora = tlora.init_lora(torch.Generator().manual_seed(1), frozen, rank=2)
        # b = 0 gives a first step of zero gradient for a: start it off zero
        lora = ttrain.tree_map(lambda x: x + 0.01, lora)
        tree = ttrain.master_params(lora)
    else:
        frozen = _params()
        tree = ttrain.master_params(tti.init_ti_embeddings(
            torch.Generator().manual_seed(2), frozen["clip"], 2))
    state = opt.init(tree)
    e = ttrain.tree_map(lambda p: p.detach().clone(), tree) if ema else None
    return tree, opt, state, e, frozen


def _new_step(kind, opt, graphs_=None, cfg=CFG, **kw):
    """The port's step for kind as (tree, state, ema, frozen, batch, gen)
    -> loss."""
    if kind == "ti":
        step = tti.make_ti_train_step(cfg, opt, graphs=graphs_, **kw)
        return lambda tree, state, ema, frozen, batch, gen: step(tree, state, frozen, batch,
                                                                 gen)[-1]
    if kind == "lora":
        step = tlora.make_lora_train_step(cfg, opt, kw.pop("scale", 1.0), graphs=graphs_, **kw)
    else:
        step = ttrain.make_train_step(cfg, opt, graphs=graphs_, **kw)

    def run(tree, state, ema, frozen, batch, gen):
        args = (tree, state) + (() if ema is None else (ema,))
        args += (frozen,) if kind == "lora" else ()
        return step(*args, batch, gen)[-1]

    return run


def _state_tensors(state):
    return [t for f in ("mu", "nu", "v_row", "v_col", "v") for t in getattr(state, f, [])
            if t is not None]


def _assert_equal(a, b):
    la, lb = ttrain.tree_leaves(a), ttrain.tree_leaves(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert torch.equal(x, y), float((x - y).abs().max())


# ------------------------------------------------------------ (a) split == as it was

SPLIT_CASES = {
    "adamw-clipped": ("adamw", 1, None, False, 1e-6),
    "adamw-accum2-ema": ("adamw", 2, None, True, 1e6),
    "adamw-accum2bf16-ema-clipped": ("adamw", 2, torch.bfloat16, True, 1e-6),
    "adafactor-ema": ("adafactor", 1, None, True, 1e6),
    "adafactor-accum2bf16-clipped": ("adafactor", 2, torch.bfloat16, False, 1e-6),
    "adafactor-accum2": ("adafactor", 2, None, False, None),
}
TI_CASES = {"adamw-clipped": ("adamw", 1e-6), "adamw": ("adamw", None),
            "adafactor-clipped": ("adafactor", 1e-6), "adafactor": ("adafactor", None)}


def _run_both(kind, opt_kind, clip, ema, new_kw, old_kw):
    """STEPS steps of the port's split step (through a spy cache) and of the
    step as it was, from the same trees and generator seed."""
    out = []
    for make in ("new", "old"):
        tree, opt, state, e, frozen = _setup(kind, opt_kind, clip, ema)
        if make == "new":
            spy = Spy()
            step = _new_step(kind, opt, spy, **new_kw)
        else:
            step = _old_step(kind, opt, **old_kw)
        gen = torch.Generator().manual_seed(5)
        losses = [step(tree, state, e, frozen, _batch(kind, seed=i), gen) for i in range(STEPS)]
        out.append((tree, state, e, losses))
        if make == "new":
            assert [p.kind for p in spy.programs] == [kind] * STEPS
            assert len({p.key for p in spy.programs}) == 1
    return out


@pytest.mark.parametrize("kind", ["train", "lora"])
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_step_equals_the_step_as_it_was(kind, case):
    opt_kind, accum, accum_dtype, ema, clip = SPLIT_CASES[case]
    ema_decay = 0.9 if ema else None
    new_kw = dict(accum=accum, accum_dtype=accum_dtype, ema_decay=ema_decay)
    if kind == "lora":
        new_kw["scale"] = 0.5
    old_kw = dict(accum=accum, accum_dtype=accum_dtype, ema_decay=ema_decay,
                  scale=new_kw.get("scale", 1.0))
    (tn, sn, en, ln), (to, so, eo, lo) = _run_both(kind, opt_kind, clip, ema, new_kw, old_kw)
    assert all(torch.equal(a, b) for a, b in zip(ln, lo)), (ln, lo)
    _assert_equal(tn, to)
    assert sn.count == so.count == STEPS
    _assert_equal(_state_tensors(sn), _state_tensors(so))
    if ema:
        _assert_equal(en, eo)
    # the clip triggered where it is tiny: the step moved less than the lr
    assert all(torch.isfinite(x).all() for x in ln)


@pytest.mark.parametrize("case", sorted(TI_CASES))
def test_split_ti_step_equals_the_step_as_it_was(case):
    opt_kind, clip = TI_CASES[case]
    (tn, sn, _, ln), (to, so, _, lo) = _run_both("ti", opt_kind, clip, False, {}, {})
    assert all(torch.equal(a, b) for a, b in zip(ln, lo)), (ln, lo)
    assert torch.equal(tn, to)
    _assert_equal(_state_tensors(sn), _state_tensors(so))


def test_clip_on_the_device_as_optax():
    """where(norm < max, g, g / norm * max): triggered, the clipped norm is
    max; below it, g bit-unchanged; and global_norm stays a 0-d tensor."""
    g = [torch.full((3,), 2.0), torch.full((4,), -1.0)]
    norm = ttrain.global_norm(g)
    assert torch.is_tensor(norm) and norm.ndim == 0 and float(norm) == pytest.approx(4.0)
    for clip, want in ((1.0, 0.25), (8.0, 1.0)):
        h = [x.clone() for x in g]
        ttrain.AdamW(1e-3, grad_clip=clip).clip(h)
        assert torch.equal(h[0], g[0] * want) and torch.equal(h[1], g[1] * want)


# ------------------------------------------------------------ (b) no host reads

@pytest.mark.parametrize("kind", ["train", "lora", "ti"])
@pytest.mark.parametrize("opt_kind", ["adamw", "adafactor"])
def test_body_reads_nothing_back_after_the_first_step(kind, opt_kind):
    tree, opt, state, e, frozen = _setup(kind, opt_kind, 1e-6, ema=kind != "ti")
    spy = Spy(forbid_from=2)
    kw = {} if kind == "ti" else dict(accum=2, accum_dtype=torch.bfloat16, ema_decay=0.9)
    step = _new_step(kind, opt, spy, **kw)
    gen = torch.Generator().manual_seed(0)
    for i in range(STEPS):
        step(tree, state, e, frozen, _batch(kind, seed=i), gen)
    assert sum(p.step for p in spy.programs) == STEPS


def test_the_guard_catches_the_step_as_it_was():
    """The guard of the test above fails the old step (its clip's norm read
    back, its alphas copied from the host)."""
    tree, opt, state, e, frozen = _setup("train", "adamw", 1e-6)
    step = _old_step("train", opt)
    gen = torch.Generator().manual_seed(0)
    step(tree, state, e, frozen, _batch("train"), gen)
    with pytest.raises(_Forbidden), _no_host_reads():
        step(tree, state, e, frozen, _batch("train"), gen)


# ------------------------------------------------------------ (c) the key

def _key(kind="train", mutate=None, opt_kind="adamw", clip=1.0, batch_kw=None, tree=None,
         opt=None, **kw):
    """The key of kind's step program, built by one step through a spy
    that runs nothing; mutate(tree, state, ema, frozen) may swap a tree;
    opt: another optimizer on the same state."""
    t, own_opt, state, e, frozen = tree or _setup(kind, opt_kind, clip, ema=kind != "ti")
    opt = opt or own_opt
    if kind != "ti":
        kw.setdefault("ema_decay", 0.9)
    if mutate is not None:
        t, state, e, frozen = mutate(t, state, e, frozen)
    spy = Spy(run=False)
    _new_step(kind, opt, spy, **kw)(t, state, e, frozen, _batch(kind, **(batch_kw or {})),
                                    torch.Generator().manual_seed(0))
    (program,) = spy.programs
    assert program.step and program.kind == kind
    return program.key


def _swap_leaf(tree):
    """A new tree of the same leaves but the last, a copy of it."""
    last = ttrain.tree_leaves(tree)[-1]

    def rec(node):
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [rec(v) for v in node]
        return node.detach().clone().requires_grad_(node.requires_grad) if node is last else node

    return rec(tree)


def _swap_state(state):
    s = copy.copy(state)
    s.mu = [*s.mu[:-1], s.mu[-1].clone()]
    return s


def _other_opt(**kw):
    """The same trees and state under another AdamW."""
    def with_opt(t, s, e, f):
        return t, s, e, f
    return dict(opt=ttrain.make_optimizer(lr=1e-3, warmup_steps=2, total_steps=5,
                                          weight_decay=1e-2, **kw), mutate=with_opt)


KEY_VARIANTS = {
    "a leaf of the trained tree": dict(mutate=lambda t, s, e, f: (_swap_leaf(t), s, e, f)),
    "a tensor of the state": dict(mutate=lambda t, s, e, f: (t, _swap_state(s), e, f)),
    "a leaf of the EMA": dict(mutate=lambda t, s, e, f: (t, s, _swap_leaf(e), f)),
    "the clip": _other_opt(grad_clip=2.0),
    "no clip": _other_opt(grad_clip=None),
    "the EMA decay": dict(ema_decay=0.99),
    "accum": dict(accum=2),
    "accum's dtype": dict(accum=2, accum_dtype=torch.bfloat16),
    "remat": dict(remat="dots"),
    "the compute dtype": dict(compute_dtype=torch.bfloat16),
    "the batch": dict(batch_kw={"b": 4}),
    "no context mask": dict(batch_kw={"masked": False}),
}


def test_key_is_stable_across_steps():
    setup = _setup("train", "adamw", 1.0, ema=True)
    assert _key(tree=setup) == _key(tree=setup)


@pytest.mark.parametrize("variant", sorted(KEY_VARIANTS))
def test_key_holds_each_field(variant):
    setup = _setup("train", "adamw", 1.0, ema=True)
    assert _key(tree=setup) != _key(tree=setup, **KEY_VARIANTS[variant])


def test_key_holds_the_optimizer_kind():
    """Adafactor has its own state, so the trees differ too: the field
    itself differs."""
    a, b = _key(), _key(opt_kind="adafactor")
    assert graphs.key_fields(a)["optimizer"][0] == "AdamW"
    assert graphs.key_fields(b)["optimizer"][0] == "Adafactor"


def test_key_holds_the_weight_decay():
    def with_wd(wd):
        opt = ttrain.make_optimizer(lr=1e-3, weight_decay=wd)
        tree = ttrain.master_params(_unet_tree())
        return _key(tree=(tree, opt, opt.init(tree), None, None), ema_decay=None)

    assert with_wd(1e-2) != with_wd(0.0)


def test_key_holds_the_frozen_trees_and_lora_scale():
    setup = _setup("lora", "adamw", 1.0, ema=True)
    base = _key("lora", tree=setup, scale=0.5)
    assert base == _key("lora", tree=setup, scale=0.5)
    assert base != _key("lora", tree=setup, scale=0.25)
    assert base != _key("lora", tree=setup, scale=0.5,
                        mutate=lambda t, s, e, f: (t, s, e, _swap_leaf(f)))
    ti = _setup("ti", "adamw", None)
    other = dict(ti[4], unet=_swap_leaf(ti[4]["unet"]))
    assert _key("ti", tree=ti) != _key("ti", tree=ti, mutate=lambda t, s, e, f: (t, s, e, other))


@pytest.mark.parametrize("gate", ["FLASH_MIN_SEQ", "matmul.allow_tf32"])
def test_key_holds_the_gates_with_training_open(gate, monkeypatch):
    setup = _setup("train", "adamw", 1.0, ema=True)
    before = _key(tree=setup)
    assert graphs.key_fields(before)["gates"]["training"] is True
    if gate == "FLASH_MIN_SEQ":
        monkeypatch.setattr(attention, "FLASH_MIN_SEQ", attention.FLASH_MIN_SEQ * 2)
    else:
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                            not torch.backends.cuda.matmul.allow_tf32)
    assert _key(tree=setup) != before


# ------------------------------------------------------------ (d) refusals

def test_graphs_on_a_mesh_or_the_cpu_raise():
    opt = ttrain.AdamW(1e-3)
    with pytest.raises(ValueError, match="mesh"):
        ttrain.make_train_step(CFG, opt, mesh=object(), graphs=Spy())
    with pytest.raises(ValueError, match="mesh"):
        tlora.make_lora_train_step(CFG, opt, 1.0, mesh=object(), graphs=Spy())
    with pytest.raises(ValueError, match="CUDA"):
        graphs.GraphCache("cpu")


def test_a_train_step_has_no_other_warm_up():
    fn = lambda inp: inp["x"]  # noqa: E731
    with pytest.raises(ValueError, match="first step"):
        graphs.Program("train", {}, {"x": torch.zeros(1)}, fn, (), graphs.COMMON_GATES,
                       warm=lambda inp: None, step=True)
    program = graphs.Program("train", {}, {"x": torch.zeros(1)}, fn, (), graphs.COMMON_GATES,
                             step=True)
    cache = object.__new__(graphs.GraphCache)  # ensure() refuses before it touches a device
    with pytest.raises(ValueError, match="first run"):
        graphs.GraphCache.ensure(cache, program)


# ------------------------------------------------------------ (e) the launch record

def _fake_wrapper():
    def wrapper():
        pass
    wrapper.launches, wrapper.shapes = 0, {}
    return wrapper


def test_record_follows_the_capture_stream_to_another_thread(monkeypatch):
    """A launch made on another thread whose current stream is the
    capture's (autograd's device thread in a backward) joins the record; a
    launch on another stream is counted."""
    monkeypatch.setattr(kernels, "LAUNCHED", {})
    streams = threading.local()
    streams.handle = 0xC0  # the capturing thread runs on the capture stream
    monkeypatch.setattr(kernels, "current_stream_handle",
                        lambda: getattr(streams, "handle", None))
    w = _fake_wrapper()

    def on(handle, n):
        def run():
            streams.handle = handle
            for _ in range(n):
                kernels.count(w, d=8)
        t = threading.Thread(target=run)
        t.start()
        t.join(10)

    with kernels.recording(0xC0) as record:
        kernels.count(w, d=40)  # the capturing thread
        on(0xC0, 3)             # the backward's thread, on the capture stream
        on(0xD0, 5)             # a handler's thread, on its own stream
    assert record == {w: {("d=40", None): 1, ("d=8", None): 3}}
    assert w.launches == 5 and w.shapes == {"d=8": 5}
    on(0xC0, 2)  # the capture over: counted
    assert w.launches == 7 and kernels._BY_STREAM == {}


def test_one_record_a_stream():
    with kernels.recording(0xC1):
        with pytest.raises(RuntimeError, match="already records"):
            with kernels.recording(0xC1):
                pass
    assert kernels._BY_STREAM == {}


# ------------------------------------------------------------ (f) the runs

def _spied(sd):
    """sd with its graphs on and a spy for its cache (CPU tensors: every
    program runs eagerly, through the path the card's replays take)."""
    spy_sd = copy.copy(sd)
    spy_sd.graphs, spy_sd.graph_cache = True, Spy()
    return spy_sd


@pytest.fixture(scope="module")
def tiny_sd():
    return StableDiffusion(_params(), CFG)


def _write_images(folder, n=3, caption="a photo of <sks> number {i}"):
    from sdtpu_torch.utils.image import save_png

    folder.mkdir()
    r = np.random.default_rng(0)
    for i in range(n):
        save_png(r.integers(0, 256, (CFG.image_size, CFG.image_size, 3), np.uint8),
                 str(folder / f"img{i}.png"))
        (folder / f"img{i}.txt").write_text(caption.format(i=i))
    return str(folder)


def test_latent_cache_and_ti_data_run_the_programs(tiny_sd, tmp_path):
    from sdtpu_torch.dataset import build_latent_cache, load_latent_cache
    from sdtpu_torch.tokenizer import SimpleTokenizer

    data = _write_images(tmp_path / "data")
    tok = SimpleTokenizer()
    spy_sd = _spied(tiny_sd)
    got = load_latent_cache(build_latent_cache(spy_sd, tok, data, str(tmp_path / "g.npz"),
                                               batch=2))
    want = load_latent_cache(build_latent_cache(tiny_sd, tok, data, str(tmp_path / "e.npz"),
                                                batch=2))
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    encodes = [p for p in spy_sd.graph_cache.programs if p.kind == "encode"]
    # two chunks, the last at its own size: a key of its own
    assert [p.inputs["image"].shape[0] for p in encodes] == [2, 1]
    assert spy_sd.graph_cache.kinds().count("clip") == 3
    spy_sd = _spied(tiny_sd)
    got = tti.prepare_ti_data(spy_sd, tok, data, n_vectors=2, batch=2)
    want = tti.prepare_ti_data(tiny_sd, tok, data, n_vectors=2, batch=2)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert spy_sd.graph_cache.kinds() == ["encode", "encode"]


FINETUNE_RUNS = {
    "full-ema-accum2": dict(ema_decay=0.9, accum=2, batch_size=2, opt_kind="adafactor"),
    "lora-ema": dict(ema_decay=0.9, lora_rank=2, batch_size=2),
}


@pytest.mark.parametrize("run", sorted(FINETUNE_RUNS))
def test_run_finetune_through_the_step_program(run, tiny_sd, tmp_path):
    from sdtpu_torch.io.native import flatten_tree, load_native
    from sdtpu_torch.tokenizer import SimpleTokenizer

    data = _write_images(tmp_path / "data")
    spy_sd = _spied(tiny_sd)
    kw = dict(steps=3, lr=1e-3, log_every=1, log=lambda s: None, **FINETUNE_RUNS[run])
    got = tfinetune.run_finetune(spy_sd, SimpleTokenizer(), data, str(tmp_path / "g"), **kw)
    want = tfinetune.run_finetune(tiny_sd, SimpleTokenizer(), data, str(tmp_path / "e"), **kw)
    assert got["losses"] == want["losses"] and want["graphs"] is None
    kind = "lora" if "lora_rank" in kw else "train"
    spy = spy_sd.graph_cache
    assert [p.kind for p in spy.programs if p.step] == [kind] * 3
    assert got["graphs"]["kinds"] == spy.kinds() and spy.dropped == [tfinetune.STEP_KINDS]
    a = flatten_tree(load_native(got["out_path"], device="cpu")[0])
    b = flatten_tree(load_native(want["out_path"], device="cpu")[0])
    assert set(a) == set(b)
    assert all(torch.equal(a[k], b[k]) if torch.is_tensor(a[k]) else a[k] == b[k] for k in a)
    if got["lora_path"]:
        la, lb = (flatten_tree(tlora.load_lora(r["lora_path"])[0]) for r in (got, want))
        assert all(torch.equal(la[k], lb[k]) for k in la)


def test_run_textual_inversion_through_the_step_program(tiny_sd, tmp_path):
    from sdtpu_torch.tokenizer import SimpleTokenizer

    data = _write_images(tmp_path / "data")
    spy_sd = _spied(tiny_sd)
    kw = dict(n_vectors=2, steps=3, batch_size=2, log_every=1, log=lambda s: None)
    got = tfinetune.run_textual_inversion(spy_sd, SimpleTokenizer(), data,
                                          str(tmp_path / "g"), **kw)
    want = tfinetune.run_textual_inversion(tiny_sd, SimpleTokenizer(), data,
                                           str(tmp_path / "e"), **kw)
    assert got["losses"] == want["losses"]
    assert [p.kind for p in spy_sd.graph_cache.programs if p.step] == ["ti"] * 3
    assert torch.equal(tti.load_ti(got["out_path"])[0], tti.load_ti(want["out_path"])[0])


# ------------------------------------------------------------ on the card

# sd-tiny widened to 40 channels and one head (d = 40: K1's Hopper core and
# K9's Hopper kernel) on 64x64 latents, so the level-0 transformers take the
# differentiable flash branch (S = 4096)
CARD_CFG = dataclasses.replace(SD_TINY, image_size=512, unet=dataclasses.replace(
    SD_TINY.unet, model_channels=40, n_head=1))
CARD_STEPS = 4


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs have no CPU mode)")
    params = init_params(CARD_CFG, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    return params, graphs.GraphCache("cuda")


def _card_batch(kind, seed, b=2):
    g = torch.Generator(device="cuda").manual_seed(100 + seed)
    hw, n_ctx = CARD_CFG.latent_size, CARD_CFG.clip.n_ctx
    latents = torch.randn((b, hw, hw, 4), generator=g, device="cuda")
    valid = torch.arange(n_ctx, device="cuda")[None, :] < torch.tensor([[5], [11]][:b],
                                                                      device="cuda")
    if kind == "ti":
        tokens = torch.randint(0, CARD_CFG.clip.n_vocab + 2, (b, n_ctx), generator=g,
                               device="cuda")
        return latents, tokens, valid
    ctx = torch.randn((b, n_ctx, CARD_CFG.unet.context_dim), generator=g, device="cuda")
    return latents, ctx, valid


def _card_setup(params, kind, opt_kind="adamw", ema=True):
    opt = ttrain.make_optimizer(lr=1e-4, warmup_steps=2, total_steps=10, kind=opt_kind)
    frozen, e = None, None
    unet = unfuse_qkv(params["unet"])
    if kind == "train":
        tree = ttrain.master_params(unet)
    elif kind == "lora":
        frozen = ttrain.tree_map(lambda p: p.float(), unet)
        tree = ttrain.master_params(ttrain.tree_map(
            lambda x: x + 0.01, tlora.init_lora(torch.Generator(device="cuda").manual_seed(1),
                                                frozen, rank=4)))
    else:
        frozen = params
        tree = ttrain.master_params(tti.init_ti_embeddings(
            torch.Generator(device="cuda").manual_seed(2), params["clip"], 2))
    if ema and kind != "ti":
        e = ttrain.tree_map(lambda p: p.detach().clone(), tree)
    return tree, opt, opt.init(tree), e, frozen


def _card_step(kind, opt, cache, **kw):
    if kind != "ti":
        kw.setdefault("ema_decay", 0.99)
    return _new_step(kind, opt, cache, cfg=CARD_CFG, compute_dtype=torch.bfloat16, **kw)


def _card_run(params, cache, kind, steps=CARD_STEPS, setup=None, first=0, **kw):
    opt_kind = kw.pop("opt_kind", "adamw")
    tree, opt, state, e, frozen = setup or _card_setup(params, kind, opt_kind)
    step = _card_step(kind, opt, cache, **kw)
    gen = torch.Generator(device="cuda").manual_seed(7)
    losses = [step(tree, state, e, frozen, _card_batch(kind, i), gen)
              for i in range(first, first + steps)]
    torch.cuda.synchronize()
    return tree, state, e, [float(x) for x in losses]


def _card_equal(a, b):
    (ta, sa, ea, la), (tb, sb, eb, lb) = a, b
    assert la == lb
    _assert_equal(ta, tb)
    _assert_equal(_state_tensors(sa), _state_tensors(sb))
    if ea is not None:
        _assert_equal(ea, eb)


CARD_RUNS = {"train-adamw-ema": ("train", {}),
             "train-adafactor-accum2bf16": ("train", dict(opt_kind="adafactor", accum=2,
                                                          accum_dtype=torch.bfloat16)),
             "train-remat-dots": ("train", dict(remat="dots")),
             "lora-ema": ("lora", dict(scale=0.5)),
             "ti": ("ti", {})}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CARD_RUNS))
def test_replayed_steps_equal_eager_on_card(name, card):
    params, cache = card
    kind, kw = CARD_RUNS[name]
    before = dict(cache.replays)
    replayed = _card_run(params, cache, kind, **dict(kw))
    eager = _card_run(params, None, kind, **dict(kw))
    _card_equal(replayed, eager)
    assert cache.replays[kind] - before.get(kind, 0) == CARD_STEPS - 1
    assert cache.drop(tfinetune.STEP_KINDS) >= 1


@pytest.mark.cuda
def test_resumed_run_replayed_equals_eager_on_card(card, tmp_path):
    from sdtpu_torch.io import checkpoint

    params, cache = card
    setup = _card_setup(params, "train")
    _card_run(params, None, "train", steps=2, setup=setup)
    checkpoint.save_train_state(str(tmp_path), setup[0], setup[2], 2, ema=setup[3])
    runs = []
    for c in (cache, None):
        fresh = _card_setup(params, "train")
        step = checkpoint.restore_train_state(str(tmp_path), fresh[0], fresh[2], ema=fresh[3])
        assert step == 2 and fresh[2].count == 2
        runs.append(_card_run(params, c, "train", setup=fresh, first=2))
    _card_equal(*runs)
    cache.drop(tfinetune.STEP_KINDS)


@pytest.mark.cuda
def test_two_step_graphs_in_turns_on_card(card):
    params, cache = card
    runs = {}
    for c in ("graphs", "eager"):
        a, b = _card_setup(params, "train"), _card_setup(params, "lora")
        sa = _card_step("train", a[1], cache if c == "graphs" else None)
        sb = _card_step("lora", b[1], cache if c == "graphs" else None, scale=0.5)
        gen = torch.Generator(device="cuda").manual_seed(3)
        losses = []
        for i in range(CARD_STEPS):
            losses.append(float(sa(a[0], a[2], a[3], a[4], _card_batch("train", i), gen)))
            losses.append(float(sb(b[0], b[2], b[3], b[4], _card_batch("lora", i), gen)))
        runs[c] = (a, b, losses)
    assert runs["graphs"][2] == runs["eager"][2]
    for i in (0, 1):
        g, e = runs["graphs"][i], runs["eager"][i]
        _card_equal((g[0], g[2], g[3], []), (e[0], e[2], e[3], []))
    cache.drop(tfinetune.STEP_KINDS)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3, 5], ids=["chunks 2+1", "chunks 2+2+1"])
def test_latent_cache_replayed_equals_eager_on_card(card, tmp_path, n):
    """Chunks of 2: a full chunk replayed on new images, the last one at
    its own size (its own key)."""
    from sdtpu_torch.dataset import build_latent_cache, load_latent_cache
    from sdtpu_torch.tokenizer import SimpleTokenizer

    params, _ = card
    sd = StableDiffusion(params, CARD_CFG, graphs=True)
    data = _write_images(tmp_path / "data", n=n)
    tok = SimpleTokenizer()
    got = load_latent_cache(build_latent_cache(sd, tok, data, str(tmp_path / "g.npz"), batch=2))
    want = load_latent_cache(build_latent_cache(sd.with_graphs(False), tok, data,
                                                str(tmp_path / "e.npz"), batch=2))
    for name, a, b in zip(("latents", "contexts", "n_valid"), got, want):
        assert np.array_equal(a, b), (name, float(np.abs(a - b).max()))
    assert sd.graph_cache.replays["encode"] >= 1 and sd.graph_cache.replays["clip"] >= 1


# the switches of the zero-row replay test: PyTorch's defaults (cuDNN on,
# its TF32 on), cuDNN's TF32 off, cuDNN off
CUDNN_CASES = {"default": {}, "cudnn tf32 off": {"allow_tf32": False},
               "cudnn off": {"enabled": False}}


@pytest.mark.cuda
@pytest.mark.parametrize("switch", list(CUDNN_CASES))
def test_encoder_graph_on_zero_rows_through_img2img_on_card(card, switch, monkeypatch):
    """The encoder's graph captured on one batch of two images, then
    img2img twice on a batch whose second image is zeros (the rows a
    zero-padded latent-cache chunk held), the second time after the first
    captured CLIP's, the sampler's and the decode's graphs into the shared
    pool: each latent it encodes, replayed, equals the eager pipeline's bit
    for bit, and its image is within one gray level (as the decode's
    replay is held in tests/test_torch_graphs.py)."""
    from sdtpu_torch.tokenizer import SimpleTokenizer

    params, _ = card
    for name, value in CUDNN_CASES[switch].items():
        monkeypatch.setattr(torch.backends.cudnn, name, value)
    sd_g = StableDiffusion(params, CARD_CFG, graphs=True)
    sd_e = sd_g.with_graphs(False)
    r = np.random.default_rng(11)
    size = CARD_CFG.image_size
    sd_g.encode_image(r.uniform(-1, 1, (2, size, size, 3)).astype(np.float32))  # captured
    replays = sd_g.graph_cache.replays["encode"]
    padded = np.concatenate([r.uniform(-1, 1, (1, size, size, 3)),
                             np.zeros((1, size, size, 3))]).astype(np.float32)
    latents = {sd_g: [], sd_e: []}
    for sd in (sd_g, sd_e):
        encode = sd.encode_image
        sd.encode_image = (lambda x, encode=encode, out=latents[sd]:
                           out.append(encode(x)) or out[-1])
    tok = SimpleTokenizer()
    for i in range(2):
        got, want = (sd.img2img(tok, "a red house", padded, strength=0.5, n_steps=4,
                                generator=torch.Generator(device="cuda").manual_seed(7))
                     for sd in (sd_g, sd_e))
        assert sd_g.graph_cache.replays["encode"] == replays + i + 1
        a, b = latents[sd_g][i], latents[sd_e][i]
        rows = [float((a[j].float() - b[j].float()).abs().max()) for j in (0, 1)]
        assert torch.equal(a, b), f"round {i}: max |replayed - eager| by row {rows}"
        assert np.abs(got.astype(np.int32) - want).max() <= 1


@pytest.mark.cuda
def test_replayed_step_records_k1_and_k9_on_card(card):
    """The capture's record holds K1's and K9's launches (K9's from
    autograd's thread); each replay adds it once, equal to an eager step's
    counts; the capture itself counts nothing."""
    from sdtpu_torch.ops.flash_attention import flash_attention_bwd_heads, flash_attention_heads

    params, cache = card
    fns = (flash_attention_heads, flash_attention_bwd_heads)

    def counts():
        torch.cuda.synchronize()
        return [(f.launches, dict(f.shapes)) for f in fns]

    def zero():
        for f in fns:
            f.launches, f.shapes = 0, {}

    tree, opt, state, e, frozen = _card_setup(params, "train")
    step = _card_step("train", opt, None)
    gen = torch.Generator(device="cuda").manual_seed(0)
    zero()
    step(tree, state, e, frozen, _card_batch("train", 0), gen)
    eager = counts()
    assert eager[0][0] > 0 and eager[1][0] > 0
    step = _card_step("train", opt, cache)
    zero()
    step(tree, state, e, frozen, _card_batch("train", 1), gen)  # the eager first step, captured
    assert counts() == eager
    (g,) = [g for g in cache.graphs.values() if g.kind == "train"]
    assert {w.__name__: sum(s.values()) for w, s in g.record.items()} == {
        f.__name__: n for f, (n, _) in zip(fns, eager)}
    zero()
    for i in range(3):
        step(tree, state, e, frozen, _card_batch("train", 2 + i), gen)
    assert counts() == [(3 * n, {k: 3 * v for k, v in s.items()}) for n, s in eager]
    cache.drop(tfinetune.STEP_KINDS)


@pytest.mark.cuda
def test_latent_batches_reach_another_stream_on_card():
    """The prefetch thread's copies (pinned memory, its own stream) are
    complete before a consumer on another stream reads the batch."""
    from sdtpu_torch.dataset import LatentBatches

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = np.random.default_rng(0)
    lat = r.standard_normal((16, 64, 64, 4)).astype(np.float32)
    ctx = r.standard_normal((16, 77, 32)).astype(np.float32)
    nv = r.integers(1, 77, 16).astype(np.int32)
    staged = LatentBatches(lat, ctx, nv, batch_size=4, seed=1, device="cuda")
    plain = LatentBatches(lat, ctx, nv, batch_size=4, seed=1, device=False)
    stream = torch.cuda.Stream()
    try:
        for _ in range(8):
            with torch.cuda.stream(stream):
                got = [x.clone() for x in next(staged)]
            want = next(plain)
            torch.cuda.synchronize()
            assert np.array_equal(got[0].cpu().numpy(), want[0])
            assert np.array_equal(got[1].cpu().numpy(), want[1])
            assert np.array_equal(got[2].cpu().numpy(),
                                  np.arange(77)[None, :] < want[2][:, None])
    finally:
        staged.close()
        plain.close()
