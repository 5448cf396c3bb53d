"""Diffusion training (port of sdtpu/training.py): the epsilon / v
objective, AdamW and Adafactor with global-norm clipping under a
warmup-cosine schedule, the EMA of the weights, and the training step with
gradient accumulation (the running sum in f32, or in bf16: sdtpu's
multi_steps(..., accum_dtype=bfloat16)).

The loss runs the UNet inside dispatch.training(), so the forward-only
kernels stay out of the graph and the one differentiable kernel pair runs
(K1 forward, K9 backward: ops/flash_attention.py). jax.value_and_grad is
torch.autograd.grad over the leaves of the trained tree. The optimizers are
written to optax's definitions, the counterparts of sdtpu's
optax.chain(clip_by_global_norm, adamw | adafactor(warmup_cosine_decay_schedule));
they update the parameters and their own state in place where sdtpu
returns new trees, which saves a copy of each (3.4 GB per f32 copy of SD
v1's UNet). One departure: Adafactor's weight decay is scaled by the
learning rate (see Adafactor).

On a parallel.Mesh (make_train_step(..., mesh=)) the trained tree, the
optimizer state and the EMA are held as sdtpu holds them: each leaf as tp
shards by parallel/sharding.py's rule (param_specs, equal to sdtpu's
param_shardings), replicated over dp. A rank keeps the f32 masters' tp
parts (master_params(tree, mesh)) and the state opt.init builds on them
from their Layout (tp_layout). The loss runs on the local parts and gives
the local gradients (a leaf a sublayer gathers whole, where a head would
straddle two ranks, gets its part back through gather_from_tp's
backward), which are averaged over dp by an all-reduce; then each tp rank
updates its part. The global-norm clip all-reduces the squared sums of the
sharded leaves over tp and counts a replicated leaf once; Adafactor
factors a leaf by its whole shape, as optax does under GSPMD, and
all-reduces over tp its row and column means over a sharded dim and
rms(update) and rms(w) of a sharded leaf; the EMA is elementwise. Saving
gathers whole leaves (whole_tree; io/checkpoint.py), so the files are
those of one process. The batch a rank is given is its dp slice; t and
noise are drawn for the whole batch, alike on every rank, and sliced.

A step is split as sdtpu jits it (step_jit, sdtpu/finetune.py): the host
makes the draws and the optimizer's scalars (step_inputs, _Recipe.stage),
then a body does the device work alone (the loss, the gradients, the clip
on the device, the update, the EMA) and reads only device tensors: the
batch, t, noise, the scalars and the trees (the alphas table is a device
tensor made once). run_step runs the body eagerly, or, given a graph cache
on the card (graphs.py), as one CUDA graph per key, captured after the
key's first step and replayed from its next. A mesh step runs eagerly.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from sdtpu_torch.config import StableDiffusionConfig
from sdtpu_torch.models.unet import unet_apply
from sdtpu_torch.ops import dispatch
from sdtpu_torch.parallel import tp as tpc
from sdtpu_torch.parallel.sharding import (Split, gather_part, shard_batch, shard_params,
                                           splits)


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of a tree of dicts and lists, in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def master_params(tree, mesh=None):
    """f32 master copies of a parameter tree's floating leaves, each a new
    tensor that requires grad (sdtpu's `jnp.asarray(p, jnp.float32)` of the
    trained tree): the weights train in f32 whatever the compute dtype. On
    a mesh, of this rank's tp parts of the whole `tree` (shard_params)."""
    def master(p):
        if torch.is_tensor(p) and p.is_floating_point():
            return p.detach().to(torch.float32, copy=True).requires_grad_(True)
        return p

    return tree_map(master, shard_params(tree, mesh))


@dataclass(frozen=True)
class Layout:
    """How a trained tree's leaves lie over a tp group (sdtpu's
    param_shardings of it): per leaf, in tree_leaves order, its Split
    (parallel/sharding.py), or None where every rank holds it whole."""
    tp: tpc.TP
    splits: tuple

    def whole_shape(self, i: int, shape) -> tuple:
        s = self.splits[i]
        return tuple(shape) if s is None else s.whole_shape(shape, self.tp.size)

    def group(self, i: int) -> Optional[tpc.TP]:
        """The tp group over which leaf i is split, or None."""
        return None if self.splits[i] is None else self.tp


def tp_layout(tree, mesh) -> Optional[Layout]:
    """The Layout of the whole `tree`'s parts on a mesh (None without one,
    or at tp = 1)."""
    tp = tpc.of_mesh(mesh)
    if tp is None:
        return None
    return Layout(tp, tuple(tree_leaves(splits(tree, tp.size))))


def whole_tree(tree, layout: Optional[Layout], keep: bool = True):
    """The whole tree from every tp rank's parts: leaf by leaf all-gathers
    over the tp group, which every rank of it calls; None on a rank that
    does not keep it (each leaf dropped once gathered). The tree itself
    without a layout."""
    if layout is None:
        return tree if keep else None
    parts = iter(layout.splits)
    if not keep:
        for p, s in zip(tree_leaves(tree), parts):
            gather_part(p.detach(), s, layout.tp)
        return None
    return tree_map(lambda p: gather_part(p.detach(), next(parts), layout.tp), tree)


def _all_sum(x, tp: Optional[tpc.TP]):
    """x (a tensor of partial sums) summed over the tp group, in place; x
    where tp is None."""
    if tp is not None:
        dist.all_reduce(x, group=tp.group)
    return x


def _mean(x, dim: int, tp: Optional[tpc.TP], keepdim: bool = False):
    """x's mean over `dim`, where tp is the group `dim` is split over: the
    whole dim's (sum all-reduced, over the whole size); x.mean(dim) where
    tp is None."""
    if tp is None:
        return x.mean(dim, keepdim=keepdim)
    return _all_sum(x.sum(dim, keepdim=keepdim), tp).div_(x.shape[dim] * tp.size)


def _rms(x, tp: Optional[tpc.TP]):
    """The root mean square of the whole leaf of which x is this rank's
    part over tp (x's own where tp is None)."""
    if tp is None:
        return x.square().mean().sqrt()
    return (_all_sum(x.square().sum(), tp) / (x.numel() * tp.size)).sqrt()


def global_norm(g: List[torch.Tensor], layout: Optional[Layout] = None) -> torch.Tensor:
    """The global norm of the gradients g (tree_leaves order) of the whole
    tree, a 0-d f32 tensor on their device (the host does not wait for it).
    On a Layout the squared sums of the sharded leaves are all-reduced over
    tp, and a replicated leaf, which every rank holds whole, is counted
    once."""
    norms = torch.stack(torch._foreach_norm(g))
    if layout is None:
        return torch.linalg.vector_norm(norms)
    sharded = torch.tensor([s is not None for s in layout.splits], device=norms.device)
    sq = norms.square()
    return (_all_sum(sq[sharded].sum(), layout.tp) + sq[~sharded].sum()).sqrt()


def q_sample(x0, noise, alphas_cumprod, t):
    """Forward diffusion: x_t = sqrt(a_t) x0 + sqrt(1 - a_t) eps."""
    a_t = alphas_cumprod[t].reshape(-1, 1, 1, 1)
    return torch.sqrt(a_t) * x0 + torch.sqrt(1.0 - a_t) * noise


@functools.lru_cache(maxsize=8)
def _alphas_on(n_train_steps: int, device: torch.device) -> torch.Tensor:
    """cfg_alphas as a device tensor, made once per (schedule, device): a
    train step reads it and copies nothing from the host."""
    return torch.from_numpy(_alphas_for(n_train_steps).copy()).to(device)


@functools.lru_cache(maxsize=8)
def _alphas_for(n_train_steps: int) -> np.ndarray:
    betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, n_train_steps, dtype=np.float64) ** 2
    a = np.cumprod(1.0 - betas).astype(np.float32)
    a.flags.writeable = False
    return a


def cfg_alphas(cfg: StableDiffusionConfig) -> np.ndarray:
    """The training schedule's alphas_cumprod (sdtpu/training.py:61-73): a
    float64 linspace of sqrt(beta), squared, then the f32 cast of the
    cumulative product. The cached array is read-only."""
    return _alphas_for(cfg.n_train_steps)


def diffusion_loss(unet_params, cfg: StableDiffusionConfig, latents, context, t, noise,
                   ctx_valid=None, compute_dtype=torch.float32, remat=False):
    """MSE between the UNet prediction and the target (epsilon, or v for
    v-prediction models), f32. latents: [B, h, w, 4] f32; t: [B] int;
    noise: latents' shape. x_t and the context are cast to compute_dtype;
    the UNet runs inside dispatch.training(). remat: see
    models/unet.py:_remat_policy."""
    alphas = _alphas_on(cfg.n_train_steps, latents.device)
    x_t = q_sample(latents, noise, alphas, t)
    with dispatch.training():
        pred = unet_apply(unet_params, x_t.to(compute_dtype), t, context.to(compute_dtype),
                          cfg.unet, ctx_valid=ctx_valid, remat=remat)
    pred = pred.float()
    if cfg.prediction_type == "v":
        a_t = alphas[t].reshape(-1, 1, 1, 1)
        target = torch.sqrt(a_t) * noise - torch.sqrt(1.0 - a_t) * latents
    else:
        target = noise
    return torch.mean((pred - target) ** 2)


class _Recipe:
    """What both optimizers share: sdtpu's schedule, optax's
    warmup_cosine_decay_schedule(0, lr, warmup_steps, max(total_steps,
    warmup_steps + 1)), or a constant lr when total_steps is None
    (optax.adam(lr)'s); and optax's clip_by_global_norm(grad_clip), or no
    clip when grad_clip is None.

    An update is split as a captured train step needs it: stage(state), on
    the host, computes the step's scalars from state.count (the learning
    rate, the bias corrections or the decay: numbers a capture would
    freeze), writes them into state.scalars, a small device tensor, with
    one copy on the current stream, and advances the count; apply(params,
    grads, state), device work only, reads them from that tensor.
    update() is the two."""

    def __init__(self, lr: float, warmup_steps: int = 0, total_steps: Optional[int] = None,
                 weight_decay: float = 0.0, grad_clip: Optional[float] = None):
        self.lr = lr
        self.warmup_steps = warmup_steps
        self.decay_steps = None if total_steps is None else max(total_steps, warmup_steps + 1)
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip

    def schedule(self, count: int) -> float:
        """The learning rate of update `count` (from 0): a linear warmup
        from 0, then a cosine decay to 0 (optax's join of linear_schedule
        and cosine_decay_schedule at warmup_steps)."""
        if self.decay_steps is None:
            return self.lr
        w = self.warmup_steps
        if count < w:
            return self.lr * min(max(count, 0), w) / w
        decay = self.decay_steps - w
        c = min(count - w, decay)
        return self.lr * 0.5 * (1.0 + math.cos(math.pi * c / decay))

    def flags(self) -> tuple:
        """What the optimizer's device work is built from (a train step's
        graph key): its kind, the clip and the weight decay."""
        return type(self).__name__, self.grad_clip, self.weight_decay

    def clip(self, g: List[torch.Tensor], layout: Optional[Layout] = None) -> None:
        """g · max / ||g|| in place where the global norm ||g|| >= max (no
        epsilon, unlike torch.nn.utils.clip_grad_norm_); ||g|| is the whole
        tree's (global_norm) on a layout. On the device, as optax's
        where(||g|| < max, g, g / ||g|| · max): g / 1 · 1 below the max."""
        if self.grad_clip is None:
            return
        norm = global_norm(g, layout)
        below = norm < self.grad_clip
        torch._foreach_div_(g, torch.where(below, 1.0, norm))
        torch._foreach_mul_(g, torch.where(below, 1.0, float(self.grad_clip)))

    def scalars(self, count: int) -> list:
        """The host's numbers of update `count` (from 0), in the order
        apply() reads them from state.scalars."""
        raise NotImplementedError

    def stage(self, state) -> None:
        """The host's part of an update: scalars(state.count) written into
        state.scalars (init() makes it on the state's device) with one copy
        on the current stream, from pinned memory on the card, and the
        count advanced."""
        values = torch.tensor(self.scalars(state.count), dtype=torch.float32)
        if state.scalars.is_cuda:
            values = values.pin_memory()
        state.scalars.copy_(values, non_blocking=True)
        state.count += 1

    def update(self, params, grads, state) -> None:
        """One step on params (a tree) from grads (f32, tree_leaves order),
        which it clips in place: stage(state), then apply(...)."""
        self.stage(state)
        self.apply(params, grads, state)


@dataclass
class AdamWState:
    """count: completed updates (the host's); mu, nu: the f32 moments, one
    per leaf of the parameter tree (tree_leaves order), each a part of the
    whole moment as its leaf is on a layout; scalars: the device's copy of
    the current update's numbers (_Recipe.stage), derived from count and
    not saved."""
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    layout: Optional[Layout] = None
    scalars: Optional[torch.Tensor] = None

    def tensors(self) -> list:
        """Every tensor of the state (a train step's graph reads each by
        address)."""
        return [*self.mu, *self.nu, self.scalars]

    def splits(self) -> dict:
        """{field: [Split or None per entry]} of the state's tensors."""
        if self.layout is None:
            return {}
        return {"mu": list(self.layout.splits), "nu": list(self.layout.splits)}


class AdamW(_Recipe):
    """optax.chain(clip_by_global_norm(grad_clip), adamw(schedule,
    weight_decay)), as sdtpu's make_optimizer builds it (see _Recipe for the
    schedule and the clip):

    - Adam: mu = b1 mu + (1 - b1) g, nu = b2 nu + (1 - b2) g², u =
      mu / (1 - b1^n) / (sqrt(nu / (1 - b2^n)) + eps), n counted from 1;
    - decoupled weight decay on every leaf (no mask): u + wd · p;
    - p -= schedule(n - 1) · u, the schedule counted from 0.

    AdamW(lr) alone is optax.adam(lr): a constant lr, no decay, no clip.
    update() works in place on the parameters and the state. The step's
    scalars (stage): -schedule(n - 1), 1 - b1^n and 1 - b2^n, f32."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def init(self, params, layout: Optional[Layout] = None) -> AdamWState:
        """The zero state of params (a tree; on a mesh this rank's parts,
        laid out as `layout` says)."""
        leaves = tree_leaves(params)
        dev = leaves[0].device
        return AdamWState(0, [torch.zeros_like(p, dtype=torch.float32) for p in leaves],
                          [torch.zeros_like(p, dtype=torch.float32) for p in leaves], layout,
                          torch.zeros(3, dtype=torch.float32, device=dev))

    def scalars(self, count: int) -> list:
        n = np.float32(count + 1)
        return [-self.schedule(count), float(1 - np.float32(self.b1) ** n),
                float(1 - np.float32(self.b2) ** n)]

    @torch.no_grad()
    def apply(self, params, grads, state: AdamWState) -> None:
        """The device's part of update() (the class docstring), from the
        scalars stage() wrote."""
        leaves = tree_leaves(params)
        g = list(grads)
        self.clip(g, state.layout)
        b1, b2 = self.b1, self.b2
        neg_lr, c1, c2 = state.scalars.unbind()
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, g, alpha=1.0 - b1)
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_addcmul_(state.nu, g, g, value=1.0 - b2)
        u = torch._foreach_div(state.mu, c1)
        den = torch._foreach_div(state.nu, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(u, den)
        del den
        if self.weight_decay:
            torch._foreach_add_(u, leaves, alpha=self.weight_decay)
        # p + (-lr) · u, rounded as add_(u, alpha=-lr) rounds it
        torch._foreach_addcmul_(leaves, u, [neg_lr] * len(leaves))


def _without(split: Optional[Split], dim: int) -> Optional[Split]:
    """The Split of a mean over `dim` of a leaf split as `split`: none where
    the mean is over the split dim, else the split dim's index without dim."""
    if split is None or split.dim == dim:
        return None
    return Split(split.dim - (split.dim > dim), split.blocks)


@dataclass
class AdafactorState:
    """count: completed updates; per leaf of the parameter tree
    (tree_leaves order) either the factored second moments v_row and v_col
    (v None) or the whole one v (v_row and v_col None), f32, each a part as
    its leaf is on a layout; dims: per leaf the (d1, d0) it is factored on
    (from its whole shape), or None; scalars: as AdamWState's."""
    count: int
    v_row: List[Optional[torch.Tensor]]
    v_col: List[Optional[torch.Tensor]]
    v: List[Optional[torch.Tensor]]
    layout: Optional[Layout] = None
    dims: tuple = ()
    scalars: Optional[torch.Tensor] = None  # as AdamWState's

    def tensors(self) -> list:
        """Every tensor of the state (a train step's graph reads each by
        address)."""
        return [t for t in (*self.v_row, *self.v_col, *self.v, self.scalars) if t is not None]

    def splits(self) -> dict:
        """{field: [Split or None per entry]} of the state's tensors: v as
        its leaf; v_row (the mean over d0) and v_col (over d1) split where
        the leaf is, but on the dim they average."""
        if self.layout is None:
            return {}
        out = {"v_row": [], "v_col": [], "v": []}
        for s, dims in zip(self.layout.splits, self.dims):
            out["v"].append(s if dims is None else None)
            out["v_row"].append(None if dims is None else _without(s, dims[1]))
            out["v_col"].append(None if dims is None else _without(s, dims[0]))
        return out


class Adafactor(_Recipe):
    """optax.chain(clip_by_global_norm(grad_clip), adafactor(schedule)) with
    optax 0.2.6's defaults, as sdtpu's make_optimizer(kind="adafactor")
    builds it (see _Recipe for the schedule and the clip). Per leaf, update
    n (from 0):

    - decay = 1 - (n + 1)^-0.8; g2 = g² + 1e-30;
    - a leaf whose second-largest dim (d1) has >= 128 elements keeps the
      means of g2 over its largest dim (d0), v_row, and over d1, v_col,
      each decayed as v = decay · v + (1 - decay) · mean; û = g ·
      (v_row / mean(v_row over d1))^-½ · v_col^-½; any other leaf keeps v =
      decay · v + (1 - decay) · g2 whole and û = g · v^-½;
    - û / max(1, rms(û)) (the block-RMS clip at 1);
    - p -= lr_n · (û · max(rms(p), 1e-3) + wd · p).

    sdtpu passes weight_decay to optax as weight_decay_rate, which optax
    adds after the learning rate: each step subtracts wd · p whatever the
    schedule (1 % of every weight a step at run_finetune's wd 1e-2, at lr
    0 too). Here the decay is scaled by the schedule, as AdamW's is and as
    Hugging Face's Adafactor does; with wd = 0 the update is sdtpu's.
    update() works in place on the parameters and the state. The step's
    scalars (stage): decay, 1 - decay, lr_n and lr_n · wd, f32 (optax's
    decay_rate_t and 1 - decay_rate_t are f32)."""

    decay_exponent, eps, clip_threshold = 0.8, 1e-30, 1.0
    min_dim_size_to_factor, min_scale = 128, 1e-3

    @classmethod
    def factored_dims(cls, shape) -> Optional[tuple]:
        """(d1, d0): the second-largest and the largest dim, or None where
        the second-largest is under min_dim_size_to_factor (optax's
        _factored_dims)."""
        if len(shape) < 2:
            return None
        order = np.argsort(shape)
        if shape[order[-2]] < cls.min_dim_size_to_factor:
            return None
        return int(order[-2]), int(order[-1])

    def init(self, params, layout: Optional[Layout] = None) -> AdafactorState:
        """The zero state of params (a tree; on a mesh this rank's parts,
        laid out as `layout` says), each leaf factored by its whole shape."""
        leaves = tree_leaves(params)
        state = AdafactorState(0, [], [], [], layout,
                               scalars=torch.zeros(4, dtype=torch.float32,
                                                   device=leaves[0].device))
        for k, p in enumerate(leaves):
            shape = tuple(p.shape) if layout is None else layout.whole_shape(k, p.shape)
            dims = self.factored_dims(shape)
            state.dims += (dims,)
            zeros = functools.partial(torch.zeros, dtype=torch.float32, device=p.device)
            if dims is None:
                state.v_row.append(None), state.v_col.append(None)
                state.v.append(zeros(p.shape))
            else:
                d1, d0 = dims
                state.v_row.append(zeros([n for i, n in enumerate(p.shape) if i != d0]))
                state.v_col.append(zeros([n for i, n in enumerate(p.shape) if i != d1]))
                state.v.append(None)
        return state

    def scalars(self, count: int) -> list:
        decay = np.float32(1) - np.float32(count + 1) ** np.float32(-self.decay_exponent)
        lr = self.schedule(count)
        return [float(decay), float(np.float32(1) - decay), lr, lr * self.weight_decay]

    @torch.no_grad()
    def apply(self, params, grads, state: AdafactorState) -> None:
        """The device's part of update() (the class docstring), from the
        scalars stage() wrote."""
        g = list(grads)
        layout = state.layout
        self.clip(g, layout)
        keep, mix, lr, lr_wd = state.scalars.unbind()
        for i, (p, gi) in enumerate(zip(tree_leaves(params), g)):
            tp = None if layout is None else layout.group(i)
            g2 = gi * gi + self.eps
            if state.v[i] is None:
                d1, d0 = state.dims[i]
                # the tp group of a mean over d0 or d1 where that dim is split
                tp0, tp1 = (tp if tp is not None and layout.splits[i].dim == d else None
                            for d in (d0, d1))
                v_row = state.v_row[i].mul_(keep).addcmul_(_mean(g2, d0, tp0), mix)
                v_col = state.v_col[i].mul_(keep).addcmul_(_mean(g2, d1, tp1), mix)
                row = (v_row / _mean(v_row, d1 - 1 if d1 > d0 else d1, tp1,
                                     keepdim=True)).rsqrt_()
                u = gi * row.unsqueeze(d0) * v_col.rsqrt().unsqueeze(d1)
            else:
                u = gi * state.v[i].mul_(keep).addcmul_(g2, mix).rsqrt()
            del g2
            u.div_(torch.clamp_min(_rms(u, tp) / self.clip_threshold, 1.0))
            u.mul_(lr).mul_(_rms(p, tp).clamp_min_(self.min_scale))
            if self.weight_decay:
                u.addcmul_(p, lr_wd)
            p.sub_(u)


OPTIMIZERS = {"adamw": AdamW, "adafactor": Adafactor}


def make_optimizer(lr: float = 1e-4, warmup_steps: int = 1000, total_steps: int = 1_000_000,
                   weight_decay: float = 1e-2, grad_clip: float = 1.0,
                   kind: str = "adamw") -> _Recipe:
    """sdtpu's diffusion-training recipe: global-norm clip + AdamW (or
    Adafactor, kind="adafactor": factored second moments, a few MB of state
    where AdamW keeps two f32 copies of the weights) with a linear warmup
    into a cosine decay (sdtpu/training.py:76-103)."""
    if kind not in OPTIMIZERS:
        raise ValueError(f"kind must be adamw|adafactor, got {kind!r}")
    return OPTIMIZERS[kind](lr, warmup_steps, total_steps, weight_decay, grad_clip)


@torch.no_grad()
def ema_update(ema_params, params, decay: float = 0.9999):
    """Exponential moving average of params (the weights SD ships):
    e · decay + p · (1 - decay), in place on ema_params, which it returns."""
    e = tree_leaves(ema_params)
    torch._foreach_mul_(e, decay)
    torch._foreach_add_(e, [p.to(x.dtype) for p, x in zip(tree_leaves(params), e)],
                        alpha=1.0 - decay)
    return ema_params


def accumulate_grads(g_sum: Optional[List[torch.Tensor]], g: List[torch.Tensor],
                     accum_dtype=None) -> List[torch.Tensor]:
    """The running sum of micro-batch gradients, g_sum + g (g_sum None: the
    first micro-batch's), in place. accum_dtype: the sum's dtype (None: g's,
    f32); bf16 is sdtpu's multi_steps(..., accum_dtype=bfloat16): each
    gradient is cast to bf16 and added in bf16, acc + bf16(g)."""
    if accum_dtype is not None:
        g = [x.to(accum_dtype) for x in g]
    if g_sum is None:
        return g
    torch._foreach_add_(g_sum, g)
    return g_sum


def mean_grads(g_sum: List[torch.Tensor], accum: int, accum_dtype=None) -> List[torch.Tensor]:
    """The f32 mean of `accum` summed gradients, which the f32 master
    update takes: the f32 sum times 1/accum (sdtpu's make_train_step scan),
    or the bf16 sum cast to f32, then divided by accum (sdtpu's
    multi_steps)."""
    if accum_dtype is None:
        torch._foreach_mul_(g_sum, 1.0 / accum)
        return g_sum
    return [a.float().div_(accum) for a in g_sum]


def micro_batch_grads(loss_of: Callable, leaves: List[torch.Tensor], batch: int, accum: int = 1,
                      accum_dtype=None):
    """(loss, f32 gradients of `leaves`) of loss_of(slice) over `accum`
    equal micro-batches of `batch` rows, run one after the other, whose
    losses and gradients are averaged (activation memory of one
    micro-batch, the gradient of the whole batch). The loss is the micro
    losses' f32 mean; the gradients' running sum is kept in accum_dtype
    (accumulate_grads). A leaf the loss does not reach gets zeros."""
    if batch % accum:
        raise ValueError(f"batch {batch} not divisible by accum {accum}")
    mb = batch // accum
    loss_sum, g_sum = None, None
    for i in range(accum):
        loss = loss_of(slice(i * mb, (i + 1) * mb))
        g = torch.autograd.grad(loss, leaves, allow_unused=True)
        g = [torch.zeros_like(p, dtype=torch.float32) if x is None else x.float()
             for p, x in zip(leaves, g)]
        loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
        g_sum = accumulate_grads(g_sum, g, accum_dtype)
        del g
    if accum > 1:
        return loss_sum / accum, mean_grads(g_sum, accum, accum_dtype)
    return loss_sum, g_sum


def loss_and_grads(params, cfg: StableDiffusionConfig, latents, context, t, noise,
                   ctx_valid=None, compute_dtype=torch.float32, remat=False, accum: int = 1,
                   accum_dtype=None, mesh=None):
    """(loss, f32 gradients in tree_leaves order) of diffusion_loss, over
    `accum` micro-batches (micro_batch_grads). On a mesh params are this
    rank's tp parts (master_params(tree, mesh)), whose gradients come back,
    and the loss and the gradients are averaged over dp (dp_mean)."""
    tp = tpc.of_mesh(mesh)

    def loss_of(sl):
        with tpc.use(tp):
            return diffusion_loss(params, cfg, latents[sl], context[sl],
                                  t[sl], noise[sl], None if ctx_valid is None else ctx_valid[sl],
                                  compute_dtype=compute_dtype, remat=remat)

    return dp_mean(*micro_batch_grads(loss_of, tree_leaves(params), latents.shape[0], accum,
                                      accum_dtype), mesh)


def dp_mean(loss, grads: List[torch.Tensor], mesh=None):
    """The loss and the gradients averaged over the mesh's dp ranks, in
    place (an all-reduce each over the dp group); as they are without a
    mesh or at dp = 1."""
    if mesh is None or mesh.dp == 1:
        return loss, grads
    for g in [loss, *grads]:
        dist.all_reduce(g, group=mesh.dp_group)
        g.div_(mesh.dp)
    return loss, grads


def draw_t_noise(cfg: StableDiffusionConfig, latents, generator=None, t=None, noise=None,
                 mesh=None):
    """A step's timesteps ([B] int) and noise (latents' shape, f32) on the
    latents' device: drawn from `generator` (the default generator of the
    latents' device when None), t first, unless given (the tests inject
    sdtpu's draws). On a mesh the latents are this dp rank's slice: t and
    noise are drawn (or given) for the whole batch, dp times the rows, and
    this rank's rows returned."""
    gdev = latents.device if generator is None else generator.device
    rows = latents.shape[0] * (1 if mesh is None else mesh.dp)
    if t is None:
        t = torch.randint(0, cfg.n_train_steps, (rows,), generator=generator, device=gdev)
    if noise is None:
        noise = torch.randn((rows,) + tuple(latents.shape[1:]), generator=generator,
                            device=gdev)
    return (shard_batch(t.to(latents.device), mesh),
            shard_batch(noise.to(latents.device, torch.float32), mesh))


def step_inputs(cfg: StableDiffusionConfig, batch, names, generator=None, t=None, noise=None,
                mesh=None) -> dict:
    """A train step's inputs, {name: device tensor}: the batch's tensors
    under `names` (a missing last one, the context mask, left out), then
    the draws, made here before the step's body from `generator`, t first
    and then noise (draw_t_noise), unless given."""
    inputs = {name: x for name, x in zip(names, batch)}
    inputs["t"], inputs["noise"] = draw_t_noise(cfg, batch[0], generator, t, noise, mesh)
    return inputs


def run_step(graphs, kind: str, statics: dict, inputs: dict, body: Callable, trees) -> torch.Tensor:
    """A train step's body on its inputs -> its loss. body(inputs) reads
    only the inputs and the trees (each a tree of tensors, or a list of
    them: the trained tree, every tensor of the optimizer state, the EMA,
    the frozen model) and does only device work. graphs None: run eagerly.
    graphs a graphs.GraphCache: as one CUDA graph per key (graphs.Program,
    step=True: the statics, the inputs' shapes and dtypes, the identity of
    every tensor of the trees, the gates with dispatch.training() open),
    captured after the key's first step, which runs eagerly, and replayed
    from its next."""
    if graphs is None:
        return body(inputs)
    from sdtpu_torch import graphs as graphs_mod

    leaves = tuple(x for tree in trees for x in tree_leaves(tree) if torch.is_tensor(x))
    with dispatch.training():  # the gates as the body sees them
        program = graphs_mod.Program(kind, statics, inputs, body, leaves,
                                     graphs_mod.COMMON_GATES, step=True)
    return graphs.run(program)


def refuse_graphs_on_mesh(graphs, mesh) -> None:
    if graphs is not None and mesh is not None:
        raise ValueError("graphs on a mesh: the mesh paths run eagerly (gloo's collectives "
                         "run on the host and cannot be captured)")


def make_train_step(cfg: StableDiffusionConfig, optimizer: _Recipe,
                    compute_dtype=torch.float32, remat: bool | str = False, accum: int = 1,
                    ema_decay: Optional[float] = None, accum_dtype=None, mesh=None,
                    graphs=None):
    """Returns train_step(params, opt_state, batch, generator=None, *,
    t=None, noise=None) -> (params, opt_state, loss), sdtpu's step_core.
    batch = (latents, context) or (latents, context, ctx_valid). params: a
    tree of f32 leaves that require grad (master_params; on a mesh this
    rank's tp parts, the optimizer state built on their tp_layout), updated
    in place.
    t and noise: draw_t_noise. loss is a 0-dim f32 tensor, left on the
    device.

    accum > 1: equal micro-batches, gradients averaged, one update
    (micro_batch_grads; accum_dtype=torch.bfloat16 keeps their running sum
    in bf16); the draws are made for the whole batch first, so with the
    f32 sum the result equals accum=1's up to f32 summation order.

    ema_decay set: train_step(params, opt_state, ema_params, batch, ...) ->
    (params, opt_state, ema_params, loss), the EMA updated in place after
    the optimizer step, as the step's last op.

    mesh: a parallel.Mesh; params, the state and the EMA are this rank's
    tp parts, the batch is this dp rank's slice, t and noise (given or
    drawn) the whole batch's (see the module docstring).

    A step is split as sdtpu's jitted step_fn: the draws and the
    optimizer's host scalars (step_inputs, _Recipe.stage), then a body of
    device work (the loss, the gradients, the update, the EMA) on those
    and the trees, run by run_step: eagerly, or with graphs (a
    graphs.GraphCache on the card) as one CUDA graph replayed each step,
    sdtpu's step_jit. graphs with a mesh raises."""
    refuse_graphs_on_mesh(graphs, mesh)
    statics = {"config": cfg, "optimizer": optimizer.flags(), "accum": accum,
               "accum_dtype": accum_dtype, "remat": remat, "compute_dtype": compute_dtype,
               "ema_decay": ema_decay}

    def body(params, opt_state, ema_params, inp):
        loss, grads = loss_and_grads(params, cfg, inp["latents"], inp["context"], inp["t"],
                                     inp["noise"], inp.get("ctx_valid"), compute_dtype, remat,
                                     accum, accum_dtype, mesh)
        optimizer.apply(params, grads, opt_state)
        del grads
        if ema_params is not None:
            ema_update(ema_params, params, ema_decay)
        return loss

    def step(params, opt_state, ema_params, batch, generator, t, noise):
        inputs = step_inputs(cfg, batch, ("latents", "context", "ctx_valid"), generator, t,
                             noise, mesh)
        optimizer.stage(opt_state)
        trees = (params, opt_state.tensors()) + (() if ema_params is None else (ema_params,))
        return run_step(graphs, "train", statics, inputs,
                        functools.partial(body, params, opt_state, ema_params), trees)

    def step_core(params, opt_state, batch, generator=None, *, t=None, noise=None):
        return params, opt_state, step(params, opt_state, None, batch, generator, t, noise)

    if ema_decay is None:
        return step_core

    def train_step_ema(params, opt_state, ema_params, batch, generator=None, *, t=None,
                       noise=None):
        loss = step(params, opt_state, ema_params, batch, generator, t, noise)
        return params, opt_state, ema_params, loss

    return train_step_ema
