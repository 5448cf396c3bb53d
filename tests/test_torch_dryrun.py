"""dryrun_multichip (sdtpu_torch/parallel/dryrun.py, the counterpart of
sdtpu's __graft_entry__.py:dryrun_multichip) on 2 and on 4 gloo ranks of
the CPU: dp = 2, tp = 1, then dp = 2, tp = 2. Each runs the sharded-state
AdamW step (two micro-batches, remat "heavy", the bf16 accumulator), a
LoRA step, dp sampling held to one process at sdtpu's tolerance, and a
batch through the mesh Batcher; rank 0 returns sdtpu's summary line."""

import re

import pytest

from test_torch_parallel import SPAWN_TIMEOUT


def _rank(n):
    import torch

    from sdtpu_torch.parallel.dryrun import dryrun_multichip

    torch.set_num_threads(1)
    return dryrun_multichip(n, "cpu")


@pytest.mark.parametrize("n, tp", [(2, 1), (4, 2)])
def test_dryrun_multichip(n, tp):
    from sdtpu_torch.parallel import spawn

    lines = spawn(n, _rank, n, backend="gloo", timeout=SPAWN_TIMEOUT)
    assert lines[1:] == [None] * (n - 1)
    line = lines[0]
    assert line.startswith(f"dryrun_multichip OK: mesh dp=2 tp={tp}, train loss "), line
    assert "dp-vs-single EQUAL (rtol 1e-05" in line
    assert "['ddim', 'euler']" in line
    assert line.endswith("serve micro-batcher produced (2, 32, 32, 3) uint8 on the mesh")
    losses = [float(x) for x in re.findall(r"loss (\d+\.\d+)", line)]
    assert len(losses) == 2 and all(0.0 < x < 10.0 for x in losses)
