"""profile_pipeline.device_profile's reading of the profiler's kernel rows
(profile_rows): the sentinel kernel launched after the profiled call must
be in a trace that holds kernels, or the trace is reported incomplete."""

import pytest

from sdtpu_torch.profile_pipeline import SENTINEL, profile_rows

SPIN = f"void at::cuda::(anonymous namespace)::{SENTINEL}(long)"


def test_profile_rows_drops_the_sentinel_and_sorts():
    rows = [("sdk::gemm_tf32_kernel<2, true, true>", 1.5, 3), (SPIN, 0.001, 1),
            ("sdk::attention_tf32_kernel<40, 32>", 2.5, 1)]
    total, top = profile_rows(rows, None)
    assert total == pytest.approx(4.0)
    assert [r[0] for r in top] == ["sdk::attention_tf32_kernel<40, 32>",
                                   "sdk::gemm_tf32_kernel<2, true, true>"]
    assert profile_rows(rows, 1)[1] == top[:1]


def test_profile_rows_without_the_sentinel_is_incomplete():
    with pytest.raises(RuntimeError, match="trace incomplete"):
        profile_rows([("sdk::conv_sm90_kernel<64>", 1.0, 227)], None)


@pytest.mark.parametrize("rows", [[], [(SPIN, 0.001, 1)]])
def test_profile_rows_with_no_kernel(rows):
    """No device tracing (no rows), or a call that launched nothing: 0 ms."""
    assert profile_rows(rows, 4) == (0, [])
