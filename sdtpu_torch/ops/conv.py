"""Dense / conv / embedding primitives (port of sdtpu/ops/conv.py).

Layouts are sdtpu's: NHWC activations, HWIO conv weights, linear weights
[in, out]. Convolutions and the linears outside any kernel go to
F.conv2d / torch.matmul, as sdtpu leaves them to XLA. Weights are cast
to the activation dtype and biases are added in the activation dtype
after the product, as in sdtpu.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F

from sdtpu_torch.ops import dispatch

PadT = Union[int, Tuple[Tuple[int, int], Tuple[int, int]]]


def linear(params, x):
    """x @ w (+ b); w: [in, out]."""
    y = torch.matmul(x, params["w"].to(x.dtype))
    b = params.get("b")
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def embedding(params, ids):
    return params["w"][ids]


def conv2d(params, x, stride: int = 1, padding: PadT = 0):
    """2-D cross-correlation, NHWC activations, HWIO weights.

    padding: int p -> symmetric, or explicit ((top, bottom), (left, right)).
    """
    xc = x.permute(0, 3, 1, 2)
    w = params["w"].to(x.dtype).permute(3, 2, 0, 1)  # HWIO -> OIHW
    if isinstance(padding, int):
        y = F.conv2d(xc, w, stride=stride, padding=padding)
    else:
        (top, bottom), (left, right) = padding
        y = F.conv2d(F.pad(xc, (left, right, top, bottom)), w, stride=stride)
    y = y.permute(0, 2, 3, 1)
    b = params.get("b")
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def nearest_upsample_2x(x):
    """Nearest-neighbour 2x upsample of an NHWC tensor."""
    b, h, w, c = x.shape
    x = x.reshape(b, h, 1, w, 1, c).expand(b, h, 2, w, 2, c)
    return x.reshape(b, 2 * h, 2 * w, c)


# sdtpu's gate for the fused upsample conv (K7): input maps of at least this
# many rows per image
FUSED_UP_MIN_ROWS = 1 << 14


def use_fused_upsample(h: int, w: int, cin: int, cout: int) -> bool:
    """sdtpu's dispatch for K7 (sdtpu/ops/conv.py:90-101), closed inside
    dispatch.training() (K7 is forward-only); its bound is a TPU
    measurement, not yet measured again on the H100."""
    return (not dispatch.in_training() and cin % 128 == 0 and cout % 128 == 0 and h % 8 == 0
            and h * w >= FUSED_UP_MIN_ROWS)


# zero padding ((top, bottom), (left, right)) of each output phase (py, px)
# of the 2x2-tap form of conv3x3(nearest2x(x))
UPSAMPLE_PHASE_PADS = {(0, 0): ((1, 0), (1, 0)), (0, 1): ((1, 0), (0, 1)),
                       (1, 0): ((0, 1), (1, 0)), (1, 1): ((0, 1), (0, 1))}


def upsample_phase_weights(w):
    """[3, 3, C, Co] -> [4, 2, 2, C, Co] f32, phase p = 2·py + px: the 3x3
    taps that fall on the same input pixel after the nearest-2x upsample,
    summed (sdtpu/ops/conv.py:132-145)."""
    w = w.float()
    rows = (torch.stack([w[0], w[1] + w[2]]), torch.stack([w[0] + w[1], w[2]]))

    def colmix(k, px):
        if px == 0:
            return torch.stack([k[:, 0], k[:, 1] + k[:, 2]], dim=1)
        return torch.stack([k[:, 0] + k[:, 1], k[:, 2]], dim=1)

    return torch.stack([colmix(rows[py], px) for py in (0, 1) for px in (0, 1)])


def upsample2x_conv(params, x, fused: bool | None = None):
    """conv3x3(nearest_upsample_2x(x)) without the 4x tensor, as four
    phase-specific 2x2 convolutions and an interleave (sdtpu's
    upsample2x_conv); large aligned maps go to the fused kernel (K7).
    fused: take K7 or not; None decides by the shapes (use_fused_upsample).

    Each output phase (py, px) reads a 2x2 neighbourhood of x with
    weights that are partial sums of the 3x3 kernel.
    """
    w = params["w"]  # [3, 3, I, O]
    b, h, wd, cin = x.shape
    cout = w.shape[-1]
    if fused is None:
        fused = use_fused_upsample(h, wd, cin, cout)
    if fused:
        from sdtpu_torch.ops.fused_conv import upsample2x_conv_fused

        bias = params.get("b")
        if bias is None:
            bias = torch.zeros(cout, dtype=x.dtype, device=x.device)
        return upsample2x_conv_fused(x, w, bias)
    wph = upsample_phase_weights(w)
    phases = {(py, px): conv2d({"w": wph[2 * py + px]}, x, padding=pad)
              for (py, px), pad in UPSAMPLE_PHASE_PADS.items()}

    row0 = torch.stack([phases[(0, 0)], phases[(0, 1)]], dim=3)  # [B,H,W,2,O]
    row1 = torch.stack([phases[(1, 0)], phases[(1, 1)]], dim=3)
    y = torch.stack([row0, row1], dim=2).reshape(b, 2 * h, 2 * wd, cout)
    bias = params.get("b")
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y
