"""Fused GroupNorm pieces (port of sdtpu/ops/fused_groupnorm.py).

K3 channel_partials: per-channel statistics, kernel csrc/channel_stats.cu.
It replaces the Pallas `_stats_kernel` (sdtpu/ops/fused_groupnorm.py:28,
called at :68). One read of the map, no real arithmetic: bandwidth- and
latency-bound on the H100. The rows are split over enough blocks to fill
the SMs; each writes partial sums, which the wrapper adds, as the TPU
wrapper adds its per-block partials.

K8 group_norm_silu: silu(GroupNorm(x)) from those statistics (or from the
ones a fused conv emitted), kernel csrc/groupnorm.cu. It replaces the
Pallas `_norm_kernel` (sdtpu/ops/fused_groupnorm.py:38, called at :123):
one read and one write of the map, the GroupNorm folded to a per-(batch,
channel) f32 affine — bandwidth-bound.
"""

from __future__ import annotations

import torch

from sdtpu_torch import kernels

# blocks the partial-sums grid aims for: two waves over the H100's 132 SMs
_TARGET_BLOCKS = 264


def channel_partials_plain(x):
    """x: [B, ..., C] -> [B, 2, C] f32 (sum, sum of squares)."""
    b, c = x.shape[0], x.shape[-1]
    xf = x.reshape(b, -1, c).float()
    return torch.stack([xf.sum(dim=1), (xf * xf).sum(dim=1)], dim=1)


def channel_partials(x):
    """Per-channel f32 (sum, sum of squares) of x: [B, ..., C] -> [B, 2, C].
    CPU tensors take the plain version; CUDA tensors the kernel."""
    if kernels.on_cpu(x):
        return channel_partials_plain(x)
    kernels.refuse_autograd("channel_partials (K3)", x)
    x = x.contiguous()
    b, c = x.shape[0], x.shape[-1]
    rows = x.numel() // (b * c)
    col_blocks = (c + 31) // 32
    nsplit = max(1, min(rows, -(-_TARGET_BLOCKS // (b * col_blocks))))
    part = torch.empty((b, nsplit, 2, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = kernels.lib().sdk_channel_partials(
            kernels.dtype_code(x), x.data_ptr(), part.data_ptr(), b, rows, c,
            nsplit, kernels.stream(x))
    kernels.check(rc, "sdk_channel_partials")
    kernels.count(channel_partials, b=b, rows=rows, c=c)
    return part.sum(dim=1)


channel_partials.launches = 0
channel_partials.shapes = {}


def group_norm_silu_plain(x, gamma, beta, n_group: int = 32, eps: float = 1e-5,
                          silu: bool = True, sums=None):
    """The plain version of group_norm_silu: the same one-pass statistics
    and folded affine in PyTorch ops."""
    from sdtpu_torch.ops.fused_conv import stats_scale_bias

    b, c = x.shape[0], x.shape[-1]
    rows = x.numel() // (b * c)
    if sums is None:
        sums = channel_partials_plain(x)
    scale, bias = stats_scale_bias(sums, rows, gamma, beta, n_group, eps)
    y = x.reshape(b, rows, c).float() * scale[:, None, :] + bias[:, None, :]
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype).reshape(x.shape)


def group_norm_silu(x, gamma, beta, n_group: int = 32, eps: float = 1e-5,
                    silu: bool = True, sums=None):
    """silu(group_norm(x)) (or the GroupNorm alone) with the one-pass
    variance E[x^2] - E[x]^2, eps inside the rsqrt. x: [B, ..., C].
    sums: optional [B, 2, C] per-channel (sum, sum^2) of x, e.g. emitted by
    a fused conv; else K3 takes them. CPU tensors take the plain version;
    CUDA tensors the kernels."""
    if kernels.on_cpu(x, gamma, beta, sums):
        return group_norm_silu_plain(x, gamma, beta, n_group, eps, silu, sums)
    kernels.refuse_autograd("group_norm_silu (K8)", x, gamma, beta, sums)
    from sdtpu_torch.ops.fused_conv import stats_scale_bias

    x = x.contiguous()
    b, c = x.shape[0], x.shape[-1]
    rows = x.numel() // (b * c)
    if sums is None:
        sums = channel_partials(x)
    scale, bias = (t.contiguous() for t in
                   stats_scale_bias(sums, rows, gamma, beta, n_group, eps))
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = kernels.lib().sdk_group_norm_silu(
            kernels.dtype_code(x), x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), b, rows, c, int(silu), kernels.stream(x))
    kernels.check(rc, "sdk_group_norm_silu")
    kernels.count(group_norm_silu, b=b, rows=rows, c=c, silu=bool(silu))
    return out


group_norm_silu.launches = 0
group_norm_silu.shapes = {}
