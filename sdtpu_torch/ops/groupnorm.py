"""Normalisation ops with the reference's exact formulas (port of
sdtpu/ops/groupnorm.py).

GroupNorm subtracts the per-group mean and divides by
sqrt(mean(u^2) + eps): eps sits inside the sqrt. LayerNorm uses the biased
variance, eps inside the sqrt. Statistics are f32; the affine runs in the
activation dtype, as in sdtpu, so a bf16 path stays bf16.
"""

import torch

from sdtpu_torch.ops import dispatch


def group_norm(x, gamma, beta, n_group: int, eps: float = 1e-5):
    """GroupNorm over a channels-last tensor x: [B, ..., C]; gamma/beta: [C]."""
    shape = x.shape
    b, c = shape[0], shape[-1]
    if c % n_group:
        raise ValueError(f"{c} channels do not split into {n_group} groups")
    xf = x.reshape(b, -1, n_group, c // n_group).float()
    mean = xf.mean(dim=(1, 3), keepdim=True)
    u = xf - mean
    var = (u * u).mean(dim=(1, 3), keepdim=True)
    normed = (u * torch.rsqrt(var + eps)).reshape(shape).to(x.dtype)
    return normed * gamma.to(x.dtype) + beta.to(x.dtype)


# sdtpu's gate for the fused GroupNorm+SiLU (K8): maps of at least this many
# rows per image, or any map whose statistics an upstream kernel emitted
FUSED_GN_MIN_ROWS = 1 << 14


def use_fused_gn_silu(rows: int, c: int, has_stats: bool) -> bool:
    """sdtpu's gate for K8 (sdtpu/ops/groupnorm.py:41-71): maps of
    FUSED_GN_MIN_ROWS rows or more, or whose statistics an upstream kernel
    emitted, with C % 128 == 0; closed inside dispatch.training(), K8 being
    forward-only. The bound is sdtpu's TPU measurement."""
    return (not dispatch.in_training() and (rows >= FUSED_GN_MIN_ROWS or has_stats)
            and c % 128 == 0 and rows % 8 == 0)


def group_norm_silu_op(x, gamma, beta, n_group: int, eps: float = 1e-5,
                       in_stats=None):
    """GroupNorm followed by SiLU (sdtpu/ops/groupnorm.py:41-71).

    Large maps and maps that come with in_stats, the [B, 2, C] per-channel
    (sum, sum^2) an upstream fused kernel emitted, go to the fused
    GroupNorm+SiLU (K8) by use_fused_gn_silu; the rest to the two-pass
    composition."""
    rows = x.numel() // (x.shape[0] * x.shape[-1])
    if use_fused_gn_silu(rows, x.shape[-1], in_stats is not None):
        from sdtpu_torch.ops.fused_groupnorm import group_norm_silu

        return group_norm_silu(x, gamma, beta, n_group, eps, sums=in_stats)
    y = group_norm(x, gamma, beta, n_group, eps)
    return y * torch.sigmoid(y)


def layer_norm(x, gamma, beta, eps: float = 1e-5):
    """LayerNorm over the last dim: biased variance, eps inside sqrt."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    u = xf - mean
    var = (u * u).mean(dim=-1, keepdim=True)
    normed = (u * torch.rsqrt(var + eps)).to(x.dtype)
    return normed * gamma.to(x.dtype) + beta.to(x.dtype)
