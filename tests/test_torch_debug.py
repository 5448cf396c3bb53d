"""The port's debug invariants (sdtpu_torch/utils/debug.py) and the offset
cosine schedule against sdtpu's, on the CPU."""

import numpy as np
import pytest
import torch

from sdtpu_torch.utils import debug as tdebug


def _trees(bad):
    """The same nested tree for sdtpu (numpy) and the port (tensors), with
    a NaN in one leaf when bad."""
    a = np.ones((2, 3), np.float32)
    b = np.arange(4, dtype=np.float32)
    if bad:
        b[2] = np.nan
    ints = np.arange(3)
    jtree = {"x": a, "blocks": [{"w": b}, {"w": a}], "n": ints}
    ttree = {"x": torch.from_numpy(a), "blocks": [{"w": torch.from_numpy(b)},
                                                  {"w": torch.from_numpy(a)}],
             "n": torch.from_numpy(ints)}
    return jtree, ttree


@pytest.mark.parametrize("n", [1, 10, 1000])
def test_offset_cosine_schedule_equals_sdtpus(n):
    from sdtpu.diffusion import offset_cosine_schedule_cumprod as jsched
    from sdtpu_torch.diffusion import offset_cosine_schedule_cumprod as tsched

    got, want = tsched(n), np.asarray(jsched(n))
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bad", [False, True])
def test_assert_finite_as_sdtpu(bad):
    from sdtpu.utils import debug as jdebug

    jtree, ttree = _trees(bad)
    if not bad:
        jdebug.assert_finite(jtree)
        tdebug.assert_finite(ttree)
        return
    with pytest.raises(FloatingPointError) as want:
        jdebug.assert_finite(jtree, "params")
    with pytest.raises(FloatingPointError) as got:
        tdebug.assert_finite(ttree, "params")
    assert str(got.value) == str(want.value)


def test_checked_under_sdtpu_debug_nans(monkeypatch):
    def f(x):
        return {"y": x * 2}

    monkeypatch.setenv("SDTPU_DEBUG_NANS", "0")
    assert tdebug.checked(f) is f and not tdebug.debug_enabled()
    monkeypatch.setenv("SDTPU_DEBUG_NANS", "1")
    g = tdebug.checked(f)
    assert g is not f and tdebug.debug_enabled()
    assert torch.equal(g(torch.ones(2))["y"], torch.full((2,), 2.0))
    with pytest.raises(FloatingPointError, match="NaN detected"):
        g(torch.tensor([1.0, float("nan")]))


@pytest.mark.parametrize("expect", [(2, None, 3), (2, 4, 3), (2, 4)])
def test_shape_check_as_sdtpu(expect):
    from sdtpu.utils import debug as jdebug

    x = np.zeros((2, 4, 3), np.float32)
    try:
        jdebug.shape_check(x, expect, "x")
        want = None
    except AssertionError as e:
        want = str(e)
    try:
        tdebug.shape_check(torch.from_numpy(x), expect, "x")
        got = None
    except AssertionError as e:
        got = str(e)
    assert got == want
