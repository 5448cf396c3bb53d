"""Fused GroupNorm pieces (port of sdtpu/ops/fused_groupnorm.py).

K3 channel_partials: per-channel statistics. It replaces the Pallas
`_stats_kernel` (sdtpu/ops/fused_groupnorm.py:28, called at :68). One read
of the map, no real arithmetic: bandwidth- and latency-bound on the H100.
Two routes, chosen by stats_plan: C a multiple of 8 (every main-path C)
takes csrc/channel_stats_sm90.cu, one launch in which the CTAs of a
thread-block cluster split the rows of a channel block, read 16-byte
vectors and add their partials through distributed shared memory; other C
take the partials kernel, csrc/channel_stats.cu, whose blocks write
partial sums that the wrapper adds (a second launch).

K8 group_norm_silu: silu(GroupNorm(x)) from those statistics (or from the
ones a fused conv emitted), kernel csrc/groupnorm.cu. It replaces the
Pallas `_norm_kernel` (sdtpu/ops/fused_groupnorm.py:38, called at :123):
one read and one write of the map, the GroupNorm folded to a per-(batch,
channel) f32 affine — bandwidth-bound.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sdtpu_torch import kernels

# blocks the partials kernel's grid aims for: two waves over the
# H100's 132 SMs
_TARGET_BLOCKS = 2 * kernels.SM_COUNT
# csrc/channel_stats_sm90.cu: channels a CTA (a channel block), the most
# CTAs a cluster takes (above 8, the non-portable sizes, which the launch
# allows), and the bytes a CTA reads in one batch of loads (256 threads x
# 16 loads x 16 bytes)
STATS_CBS = (64, 32)
STATS_MAX_CLUSTER = 16
STATS_CTA_BYTES = 256 * 16 * 16


class StatsPlan(NamedTuple):
    """One launch of csrc/channel_stats_sm90.cu: the channels a CTA (a
    channel block) and the CTAs of a cluster, which split its rows."""
    cb: int
    cluster: int


def stats_plan(b: int, rows: int, c: int, itemsize: int = 2) -> StatsPlan | None:
    """The cluster kernel's plan for x [b, rows, c] of itemsize-byte
    elements, or None (c not a multiple of 8: the partials kernel). Channel
    blocks of 64 (128-byte row pieces) where clusters of 16 of them cover
    the SMs, else 32 (16, whose 32-byte pieces the kernel also takes,
    measured slower even with twice the CTAs); then clusters just large
    enough that each CTA reads one batch of loads (STATS_CTA_BYTES), at
    most 16 CTAs and no more than rows. Measured on the H100 (PERF.md): more CTAs than that only add to the cluster barrier, fewer leave
    loads waiting on loads."""
    if c % 8:
        return None
    for cb in STATS_CBS:
        if b * -(-c // cb) * STATS_MAX_CLUSTER >= kernels.SM_COUNT:
            break
    cluster = 1
    while (cluster < min(STATS_MAX_CLUSTER, rows)
           and rows * cb * itemsize > cluster * STATS_CTA_BYTES):
        cluster *= 2
    return StatsPlan(cb, min(cluster, rows))


def channel_partials_plain(x):
    """x: [B, ..., C] -> [B, 2, C] f32 (sum, sum of squares)."""
    b, c = x.shape[0], x.shape[-1]
    xf = x.reshape(b, -1, c).float()
    return torch.stack([xf.sum(dim=1), (xf * xf).sum(dim=1)], dim=1)


def channel_partials(x):
    """Per-channel f32 (sum, sum of squares) of x: [B, ..., C] -> [B, 2, C].
    CPU tensors take the plain version; CUDA tensors the kernel (see
    stats_plan)."""
    return _channel_partials(x, "auto")


def _channel_partials(x, route):
    """channel_partials on the given route: "auto" chooses by stats_plan,
    "partials" takes the partials kernel (csrc/channel_stats.cu) and its
    sum whatever C is, for timing the two against each other."""
    if kernels.on_cpu(x):
        return channel_partials_plain(x)
    kernels.refuse_autograd("channel_partials (K3)", x)
    x = x.contiguous()
    b, c = x.shape[0], x.shape[-1]
    rows = x.numel() // (b * c)
    plan = stats_plan(b, rows, c, x.element_size()) if route == "auto" else None
    with torch.cuda.device(x.device):
        if plan is not None:
            out = torch.empty((b, 2, c), dtype=torch.float32, device=x.device)
            rc = kernels.lib().sdk_channel_stats_sm90(
                kernels.dtype_code(x), x.data_ptr(), out.data_ptr(), b, rows, c, *plan,
                kernels.stream(x))
        else:
            col_blocks = (c + 31) // 32
            nsplit = max(1, min(rows, -(-_TARGET_BLOCKS // (b * col_blocks))))
            part = torch.empty((b, nsplit, 2, c), dtype=torch.float32, device=x.device)
            rc = kernels.lib().sdk_channel_partials(
                kernels.dtype_code(x), x.data_ptr(), part.data_ptr(), b, rows, c,
                nsplit, kernels.stream(x))
    kernels.check(rc, "sdk_channel_partials" if plan is None else "sdk_channel_stats_sm90")
    kernels.count(channel_partials, b=b, rows=rows, c=c,
                  route="partials" if plan is None else "sm90")
    return out if plan is not None else part.sum(dim=1)


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
