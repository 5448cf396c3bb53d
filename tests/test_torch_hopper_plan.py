"""The tile plans of the port's Hopper kernels, checked on the CPU.

The bf16 routes of K5 (csrc/gemm_sm90.cu) and K9
(csrc/flash_attention_bwd_sm90.cu) take their tile shape, ring stages and
shared-memory bytes from Python (fused_mlp.sm90_plan,
flash_attention.bwd_sm90_plan); the kernels check them and run only on the
card. Here, at every main-path shape: the bytes fit the H100's 227 KB a
block, wgmma's constraints hold (64-row groups, N a multiple of 8, K steps
of 16), the GEGLU tiles pair each val column with its gate column 4C to
the right and cover every output column once, and the padded head width is
a multiple of 16 with zeros beyond d.
"""

import pytest

from sdtpu_torch.ops import flash_attention as tfa
from sdtpu_torch.ops import fused_mlp as tfm

SMEM_LIMIT = 232448  # bytes of dynamic shared memory a block can take (H100)
WGMMA_M, WGMMA_K = 64, 16

# (B, S, C) of K5's launches on the main paths (chip_smoke.py's phase-2
# cases): the 512px UNet at batch 2 and the serve phase's batch 8, the
# 1024px UNet's 32² level
K5_SHAPES = [(2, 1024, 640), (2, 256, 1280), (2, 1024, 1280), (8, 1024, 640), (8, 256, 1280)]
# head widths and sequence lengths K9 runs at in training (512px: S = 4096;
# 1024px: S = 16384) and the 16² level's 160
K9_SHAPES = [(d, s) for d in (40, 80, 160) for s in (4096, 16384)]


@pytest.mark.parametrize("product", ["geglu", "residual"])
@pytest.mark.parametrize("b,s,c", K5_SHAPES)
def test_k5_plan(b, s, c, product):
    m = b * s
    geglu = product == "geglu"
    n, k = (4 * c, c) if geglu else (c, 4 * c)
    plan = tfm.sm90_plan(m, n, k, geglu)
    assert plan.smem <= SMEM_LIMIT
    assert plan.stages >= 2
    # two consumer warpgroups of 64 rows; n64 wgmma boxes; K steps of 16
    assert tfm.SM90_BM % WGMMA_M == 0 and tfm.SM90_BM // WGMMA_M == 2
    assert plan.bn % tfm.SM90_BOX == 0 and tfm.SM90_BOX % 8 == 0 and tfm.SM90_BOX <= 256
    assert tfm.SM90_BK % WGMMA_K == 0 and k % 8 == 0
    assert plan.w_boxes == plan.bn // tfm.SM90_BOX * (2 if geglu else 1)
    stage = tfm.SM90_BM * tfm.SM90_BK * 2 + plan.w_boxes * tfm.SM90_BK * tfm.SM90_BOX * 2
    assert plan.smem == 1024 + plan.stages * (stage + 16)
    assert plan.grid[1] * tfm.SM90_BM >= m > (plan.grid[1] - 1) * tfm.SM90_BM
    # the output columns each tile stores, and for GEGLU the W columns it
    # loads: val boxes at n0.., gate boxes 4C to their right
    covered = []
    for i in range(plan.grid[0]):
        n0 = i * plan.bn
        vals = [n0 + bx * tfm.SM90_BOX + j for bx in range(plan.bn // tfm.SM90_BOX)
                for j in range(tfm.SM90_BOX)]
        stored = [v for v in vals if v < n]
        covered += stored
        if geglu:
            gates = [n0 + 4 * c + bx * tfm.SM90_BOX + j for bx in range(plan.bn // tfm.SM90_BOX)
                     for j in range(tfm.SM90_BOX)]
            assert all(gt - v == 4 * c for v, gt in zip(vals, gates))
            assert all(4 * c <= gt < 8 * c for v, gt in zip(vals, gates) if v < n)
    assert sorted(covered) == list(range(n))


def test_k5_plan_raises_on_shapes_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        tfm.sm90_plan(100, 60, 64, False)  # N not a multiple of 8
    with pytest.raises(ValueError):
        tfm.sm90_plan(100, 64, 20, False)  # K not a multiple of 8
    with pytest.raises(ValueError):
        tfm.sm90_plan(100, 4 * 2056, 2056, True)  # γ and β past shared memory's room


def test_k5_ragged_rows_take_one_more_tile():
    plan = tfm.sm90_plan(2 * 1000 + 8, 4 * 640, 640, True)
    assert plan.grid[1] == -(-2008 // tfm.SM90_BM)


@pytest.mark.parametrize("d,s", K9_SHAPES)
def test_k9_plan(d, s):
    plan = tfa.bwd_sm90_plan(d)
    assert plan is not None
    assert plan.dpad % WGMMA_K == 0 and d <= plan.dpad < d + 16
    assert plan.dpad % 8 == 0 and plan.dpad <= 256  # N of dV, dK, dQ += P·X
    assert tfa.SM90_BWD_ROWS % WGMMA_M == 0 and tfa.SM90_BWD_ROWS // WGMMA_M == 2
    # the walked tile is N of S = Q·K^T and K (in steps of 16) of P^T·dO
    assert plan.tile % WGMMA_K == 0 and plan.tile in (32, 64)
    assert 2 <= plan.stages <= tfa.SM90_BWD_STAGES
    resident = 2 * tfa.SM90_BWD_ROWS * plan.dpad * 2
    assert plan.smem_dkdv == resident + plan.stages * (2 * plan.tile * plan.dpad * 2
                                                       + 2 * plan.tile * 4)
    assert plan.smem_dq == resident + plan.stages * 2 * plan.tile * plan.dpad * 2
    assert max(plan.smem_dkdv, plan.smem_dq) <= SMEM_LIMIT
    # every CTA walks the whole other sequence: tiles of `tile` rows
    assert -(-s // plan.tile) * plan.tile >= s


@pytest.mark.parametrize("d,want", [(8, None), (40, 48), (64, 64), (96, None), (160, 160)])
def test_k9_plan_picks_an_instance_or_the_wmma_kernel(d, want):
    plan = tfa.bwd_sm90_plan(d)
    assert (plan is None) if want is None else plan.dpad == want


@pytest.mark.parametrize("d", [0, 12, 168])
def test_k9_plan_raises_on_widths_no_kernel_takes(d):
    with pytest.raises(ValueError):
        tfa.bwd_sm90_plan(d)
