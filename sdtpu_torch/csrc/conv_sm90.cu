// K6, K4 and K7 in bf16, on Hopper's TMA and warpgroup tensor-core
// instructions:
// - K6, the fused 3x3 convolution, sdtpu/ops/fused_conv.py:conv3x3_fused
//   (its Pallas body `_kernel` / `_conv_part` :96/:44, called at :232):
//
//     y = conv3x3(act(x·scale + shift)) + b [+ residual], act = SiLU or
//     none, with the zero padding applied after the prologue, over the
//     implicit channel concat [x, x2], and per-channel (Σy, Σy²) of the
//     f32 y;
//
// - K4, the fused 1x1 convolution, sdtpu/ops/fused_conv.py:conv1x1_fused
//   (its Pallas body `_mm_kernel` :406, called at :473): the same kernel at
//   one tap (TAPS = 1), y = act(x·scale + shift)·W + b [+ residual], act =
//   SiLU or none (the UNet's proj_in takes the GroupNorm affine alone),
//   over x viewed as [B][rows][C]: its A box is a TMA box of a 3-D tensor
//   map (64 channels, 128 rows, 1 image) at the tile's own rows, zeros past
//   the last row, whose rows are neither stored nor counted; no border
//   mask. What bounds K4 on the H100 is bytes (2·C operations per output
//   value against 2–3 bf16 values of it at C = 320–640, below the card's
//   295 operations a byte): one read of x and one write of y, the prologue
//   applied once an A element where one tile spans Co (320 channels);
// - K7, the fused 2x upsample convolution, sdtpu/ops/fused_conv.py:
//   upsample2x_conv_fused (its Pallas body `_up_kernel` :276, called at
//   :372): y = conv3x3(nearest2x(x)) + b as four output phases (py, px),
//   each a 2x2-tap convolution at x's resolution with the folded weights of
//   ops/conv.py:upsample_phase_weights (2.25x fewer operations than the 3x3
//   over the upsampled map), with per-channel (Σy, Σy²). It is this kernel
//   at four taps (TAPS = 4) with the phase in the grid: a CTA computes one
//   phase of one 128-pixel tile of x, its tap (dy, dx) box read at (c0, j0 +
//   px + dx − 1, i0 + py + dy − 1, b) (the offsets of UPSAMPLE_PHASE_PADS:
//   top padding 1 − py, left 1 − px), its weight rows phase p's [4·C, Co]
//   of the [4][4·C][Co] stack, and its stores at output pixels (2i + py,
//   2j + px). K7 has no prologue, so TMA's zeros are its zero padding and
//   no border mask is compiled in. Compute-bound: 2·16·C·Co operations an
//   input pixel against (C + 4·Co) bf16 values (0.139 ms at the bf16 peak
//   against 0.027 ms of bytes at 128² x 512 -> 256² x 512).
//
// What bounds it on the H100: 2·9·(C1 + C2)·Co operations per pixel against
// (C1 + C2 + Co) bf16 values of it: compute-bound at every main-path shape
// (0.078 ms at the bf16 peak against 0.040 ms of bytes for the VAE
// decoder's 512² x 128 convs, 0.183 against 0.039 for the UNet's 128²
// 640 + 320 -> 320). The design is an implicit GEMM that keeps the tensor
// cores fed and never builds the shifted or normalised map:
//
// - A CTA computes 128 consecutive pixels of one image (a box of bw =
//   min(W, 128) pixels by bh = 128 / bw rows) times bn output channels (128,
//   256, or 320 for the UNet's 320-channel convs): two
//   consumer warpgroups of 64 pixels each and a producer warpgroup that hands
//   its registers to them (setmaxnreg 40 / 232) and of which one thread keeps
//   a ring of `stages` shared-memory stages full with TMA loads.
// - The K dimension is the HWIO weight read as the [9·(C1 + C2), Co] matrix
//   it is: K block kb (64 deep) is tap kb / ((C1 + C2) / 64) and 64 channels
//   of x or of x2 (C1 and C2 are multiples of 64, so a block never straddles
//   a tap or the x/x2 boundary). Its A operand is one TMA box of a 4-D
//   tensor map over the NHWC map of x (or of x2, through its own map): the
//   box (64 channels, bw, bh, 1) at (c0, j0 + dx − 1, i0 + dy − 1, b). TMA
//   fills every element outside the map with zeros, the negative
//   coordinates of the top and left border included, and writes the box
//   with the 128-byte swizzle; no thread computes an address.
// - The weight's boxes (64 K rows x 64 columns, N-major) are read by wgmma
//   through the descriptor's transpose bit, as in csrc/gemm_sm90.cu.
// - The prologue runs in registers: each consumer loads its A fragments with
//   ldmatrix from the swizzled stage, applies x·scale + shift per (batch,
//   channel) (staged in shared memory as f32 pairs) and SiLU (one MUFU
//   tanh an element: silu(v) = h + h·tanh(h), h = v / 2), rounds to bf16
//   and then zeroes every element whose source pixel lies outside the map:
//   TMA's zeros came before the prologue and would otherwise carry
//   silu(shift) into the border. Without a prologue TMA's zeros suffice.
//   The packed fragments are wgmma's register A operand. Two fragment sets:
//   block kb + 1 is loaded and normalised while block kb's products run.
// - The products are wgmma.mma_async m64n128k16 or m64n256k16 (plus an
//   m64n64k16 for the last 64 of 320 channels), one instruction spanning the
//   tile's weight boxes, bf16 in, f32 accumulators in registers. No branch
//   sits between a product's issue and its wait: ptxas otherwise waits for
//   every K block's products before the next block's prologue.
// - The epilogue runs on the accumulators: conv bias and residual in f32,
//   one bf16 store, and each tile's per-channel (Σ, Σ²) of the f32 result
//   summed over its rows with warp shuffles, then over the eight warps in
//   shared memory, into [B][row tiles][2][Co]: no atomics, every run the
//   same bits.
//
// Reading each tap's box from L2 costs less than it seems: one halo box a
// tile, read by all nine taps through shifted ldmatrix rows, was slower
// on the H100 (PERF.md, PR 6). The tile plan (bn, the box, the stages, the
// shared-memory bytes) comes from Python (sdtpu_torch/ops/fused_conv.py:
// sm90_plan, conv1x1_sm90_plan for K4, upsample_sm90_plan for K7) and is
// checked here. Other shapes, K6 with an affine prologue without SiLU, and
// f32 take the WMMA kernels (csrc/gemm.cu).
#include "sm90.cuh"

namespace sdk {
namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int V_BM = 128, V_BK = 64, V_BOX = 64;
// two consumer warpgroups and a producer warpgroup, of which one thread
// issues the loads
constexpr int V_CONSUMERS = 256, V_NT = V_CONSUMERS + 128;
constexpr uint32_t V_A_BYTES = V_BM * V_BK * 2, V_W_BYTES = V_BK * V_BOX * 2;
constexpr int V_MAX_SMEM = 232448;
// prologues: none, the GroupNorm affine, the affine then SiLU
constexpr int PRO_NONE = 0, PRO_AFFINE = 1, PRO_SILU = 2;

struct ConvSm90 {
  const bf16* bias;     // [Co], or null
  const float* scale;   // prologue [B][ld_s] of x (C1 used), or null
  const float* shift;
  const float* scale2;  // and [B][ld_s2] of x2 (C2 used)
  const float* shift2;
  long long ld_s, ld_s2;
  const bf16* res;      // [B][H][W][Co], or null
  bf16* out;            // [B][H][W][Co]
  float* stats;         // [B][row tiles][2][Co], or null
  int H, W, C1, C2, Co, bw, stages;
};

// BN output channels a tile, in BN / 64 weight boxes
template <int BN>
__host__ __device__ constexpr uint32_t stage_bytes() {
  return V_A_BYTES + BN / V_BOX * V_W_BYTES;
}
// shared memory: 1024 bytes of slack to align the ring to the swizzle
// pattern's 1024-byte repeat, the stages, a full and an empty barrier each,
// and with a prologue one (scale, shift) f32 pair per input channel
template <int BN>
__host__ __device__ constexpr int smem_needed(int stages, int ct, bool prologue) {
  return 1024 + stages * ((int)stage_bytes<BN>() + 16) + (prologue ? 8 * ct : 0);
}

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// acc [BN / 2] += A (registers) · the stage's BN / 64 weight boxes, K step
// ks: one instruction over the boxes (n128, n256), and n64 for a fifth
template <int BN>
__device__ __forceinline__ void conv_mma(float* acc, const uint32_t* af, uint32_t w_base, int ks) {
  const uint32_t b = w_base + ks * 2048;
  if constexpr (BN == 128) {
    wgmma_rs_n128(acc, af, desc_n_major_sw128_atoms(b, V_W_BYTES));
  } else {
    wgmma_rs_n256(acc, af, desc_n_major_sw128_atoms(b, V_W_BYTES));
    if constexpr (BN == 320) wgmma_rs_n64(acc + 128, af, desc_n_major_sw128(b + 4 * V_W_BYTES));
  }
}

// PRO: the prologue (PRO_NONE, PRO_AFFINE, PRO_SILU); TAPS: 9 (K6, map_x
// 4-D), 4 (K7: one output phase's 2x2 taps, map_x 4-D, the phase in
// blockIdx.z = 4·b + 2·py + px) or 1 (K4, map_x 3-D over [B][rows][C], read
// with H = rows, W = 1)
template <int BN, int PRO, int TAPS>
__global__ void __launch_bounds__(V_NT, 1)
    conv_sm90_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_x2,
                     const __grid_constant__ CUtensorMap map_w, const ConvSm90 p) {
  static_assert(TAPS == 9 || TAPS == 4 || TAPS == 1, "3x3, K7's 2x2 phases, or 1x1");
  static_assert(TAPS != 4 || PRO == PRO_NONE, "K7 has no prologue: TMA's zeros pad it");
  constexpr uint32_t STAGE = stage_bytes<BN>();
  constexpr int NB = BN / V_BOX;
  constexpr int KW = TAPS == 9 ? 3 : TAPS == 4 ? 2 : 1;  // taps a row
  constexpr int PH = TAPS == 4 ? 4 : 1;                  // output phases in the grid
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int stages = p.stages;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * STAGE);
  uint64_t* empty = full + stages;
  float2* s_aff = reinterpret_cast<float2*>(empty + stages);  // (scale, shift) per channel

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ct = p.C1 + p.C2, kpt = ct / V_BK;  // K blocks a tap
  const int nk = TAPS * kpt;
  const int bw = p.bw, bh = V_BM / bw, tiles_w = p.W / bw;
  const int b = blockIdx.z / PH, tile = blockIdx.y;
  const int i0 = tile / tiles_w * bh, j0 = tile % tiles_w * bw;
  const int n0 = blockIdx.x * NB * V_BOX;
  // K7's phase (py, px); the source pixel of tap (0, 0) is (i + oy, j + ox):
  // the 3x3's padding of 1, or the phase's top and left padding 1 − py, 1 − px
  const int phase = blockIdx.z % PH, py = phase >> 1, px = phase & 1;
  const int oy = TAPS == 4 ? py - 1 : -1, ox = TAPS == 4 ? px - 1 : -1;
  const int w_row0 = phase * TAPS * ct;  // K7: phase p's [4·C, Co] rows of the stack

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], V_CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= V_CONSUMERS / 32) {
    // ---- the producer warpgroup gives its registers to the consumers; one
    // thread issues every TMA load
    setmaxnreg_dec<40>();
    if (warp == V_CONSUMERS / 32 && lane == 0) {
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % stages;
        if (kb >= stages) mbar_wait(&empty[s], ((kb / stages) - 1) & 1);
        mbar_expect_tx(&full[s], STAGE);
        unsigned char* st = smem + s * STAGE;
        const int tap = kb / kpt, c0 = (kb - tap * kpt) * V_BK;
        const int sy = i0 + tap / KW + oy, sx = j0 + tap % KW + ox;
        if constexpr (TAPS == 1)
          tma_load_3d(st, &map_x, &full[s], c0, i0, b);
        else if (c0 < p.C1)
          tma_load_4d(st, &map_x, &full[s], c0, sx, sy, b);
        else
          tma_load_4d(st, &map_x2, &full[s], c0 - p.C1, sx, sy, b);
#pragma unroll
        for (int bb = 0; bb < NB; ++bb)
          tma_load_2d(st + V_A_BYTES + bb * V_W_BYTES, &map_w, &full[s], n0 + bb * V_BOX,
                      w_row0 + kb * V_BK);
      }
    }
    return;
  }

  // ---- the consumers: warpgroup wg takes pixels wg*64 .. +63 of the tile,
  // warp wl of it pixels wl*16 .. +15 (wgmma's A fragment layout)
  setmaxnreg_inc<232>();
  const int wg = warp / 4, wl = warp % 4;
  const int g = lane / 4, t = lane % 4;
  const int row_w = wg * 64 + wl * 16;  // this warp's first pixel in the tile
  if constexpr (PRO != PRO_NONE) {
    for (int c = tid; c < ct; c += V_CONSUMERS)
      s_aff[c] = c < p.C1 ? make_float2(p.scale[b * p.ld_s + c], p.shift[b * p.ld_s + c])
                          : make_float2(p.scale2[b * p.ld_s2 + c - p.C1],
                                        p.shift2[b * p.ld_s2 + c - p.C1]);
    // the consumers only (the producer warpgroup never reaches it)
    asm volatile("bar.sync 1, %0;\n" ::"n"(V_CONSUMERS) : "memory");
  }
  // the pixels (i, j) of this thread's rows g and g + 8
  int pi[2], pj[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row_w + g + 8 * h;
    pi[h] = i0 + r / bw;
    pj[h] = j0 + r % bw;
  }
  // ldmatrix: lane l gives the address of row (l & 7) + 8·((l >> 3) & 1) of
  // this warp's 16, 16-byte chunk (l >> 4) of the K step, swizzled as TMA
  // wrote it (chunk ^ row % 8 within each 128-byte row)
  const int lrow = row_w + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lchunk = lane >> 4;

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  // K block kb: wait for its stage, load this warp's A fragments with
  // ldmatrix, apply the prologue and then (3x3) the border mask in registers
  auto prepare = [&](uint32_t(&af)[4][4], int kb) {
    const int s = kb % stages;
    mbar_wait(&full[s], (kb / stages) & 1);
    const uint32_t a_base = smem_u32(smem + s * STAGE) + lrow * 128;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      ldmatrix_x4(af[ks], a_base + (((ks * 2 + lchunk) ^ (lrow & 7)) << 4));
    if constexpr (PRO == PRO_NONE) return;
    const int tap = kb / kpt, c0 = (kb - tap * kpt) * V_BK;
    const int dy = tap / KW + oy, dx = tap % KW + ox;
    bool inside[2] = {true, true};  // one tap: no border
    if constexpr (TAPS != 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        inside[h] =
            (unsigned)(pi[h] + dy) < (unsigned)p.H && (unsigned)(pj[h] + dx) < (unsigned)p.W;
    }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      // register j holds (row g + 8·(j & 1), channels c, c + 1) with
      // c = c0 + 16·ks + 2t + 8·(j >> 1)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float4 a = *reinterpret_cast<const float4*>(s_aff + c0 + ks * 16 + 2 * t + 8 * half);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = half * 2 + h;
          const float2 x = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&af[ks][j]));
          float v0 = fmaf(x.x, a.x, a.y), v1 = fmaf(x.y, a.z, a.w);
          if constexpr (PRO == PRO_SILU) {
            const float h0 = 0.5f * v0, h1 = 0.5f * v1;
            v0 = fmaf(h0, tanh_approx(h0), h0);
            v1 = fmaf(h1, tanh_approx(h1), h1);
          }
          af[ks][j] = inside[h] ? pack_bf16(v0, v1) : 0u;
        }
      }
    }
  };
  // issue K block kb's products (one commit group)
  auto issue = [&](uint32_t(&af)[4][4], int kb) {
    const uint32_t w_base = smem_u32(smem + (kb % stages) * STAGE + V_A_BYTES);
    fence_regs<BN / 2>(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) conv_mma<BN>(acc, af[ks], w_base, ks);
    wgmma_commit();
    fence_regs<BN / 2>(acc);
  };
  // K block kb's products have completed: its fragments stay allocated
  // until here (wgmma reads them asynchronously), and its stage is released
  auto retire = [&](uint32_t(&af)[4][4], int kb) {
    fence_regs<16>(&af[0][0]);
    mbar_arrive(&empty[kb % stages]);
  };

  // two fragment sets: block kb + 1 is loaded, normalised and issued while
  // block kb's products are on the tensor cores, then block kb is waited
  // for (wait_group 1). The steady state takes two blocks a trip with no
  // branch between an issue and its wait, so that the compiler keeps the
  // products in flight across the next block's prologue.
  uint32_t fa[4][4], fb[4][4];
  fence_regs<BN / 2>(acc);
  prepare(fa, 0);
  issue(fa, 0);
  int kb = 1;
  for (; kb + 1 < nk; kb += 2) {
    prepare(fb, kb);
    issue(fb, kb);
    wgmma_wait<1>();
    retire(fa, kb - 1);
    prepare(fa, kb + 1);
    issue(fa, kb + 1);
    wgmma_wait<1>();
    retire(fb, kb);
  }
  if (kb < nk) {
    prepare(fb, kb);
    issue(fb, kb);
    wgmma_wait<1>();
    retire(fa, kb - 1);
    wgmma_wait<0>();
    retire(fb, kb);
  } else {
    wgmma_wait<0>();
    retire(fa, kb - 1);
  }
  fence_regs<BN / 2>(acc);

  // ---- epilogue on the accumulators: thread holds, for j < BN / 8,
  // columns 8j + 2t, +1 of rows g (registers 4j, 4j+1) and g + 8 (4j+2,
  // 4j+3). Rows past the map's last row (a box taller than what is left of
  // it) are neither stored nor counted. The output pixel of (i, j) is (i, j)
  // itself, or K7's (2i + py, 2j + px) of the [B][2H][2W] map.
  const long long hw = (long long)p.H * p.W;
  bool row_ok[2];
  long long pix[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row_ok[h] = pi[h] < p.H;
    pix[h] = TAPS == 4 ? ((long long)b * 2 * p.H + 2 * pi[h] + py) * 2 * p.W + 2 * pj[h] + px
                       : (long long)b * hw + (long long)pi[h] * p.W + pj[h];
  }
  // the ring is free once every consumer is past its last product; the
  // statistics' per-warp partials [8 warps][BN][2] reuse it
  float2* part = reinterpret_cast<float2*>(smem);
  if (p.stats) asm volatile("bar.sync 1, %0;\n" ::"n"(V_CONSUMERS) : "memory");
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * t, n = n0 + col;
    const bool n_ok = n < p.Co;
    float2 bv = make_float2(0.f, 0.f);
    if (n_ok && p.bias)
      bv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.bias + n));
    float s1x = 0.f, s1y = 0.f, s2x = 0.f, s2y = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!n_ok || !row_ok[h]) continue;
      float v0 = acc[4 * j + 2 * h] + bv.x, v1 = acc[4 * j + 2 * h + 1] + bv.y;
      if (p.res) {
        const float2 r = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(p.res + pix[h] * p.Co + n));
        v0 += r.x;
        v1 += r.y;
      }
      *reinterpret_cast<uint32_t*>(p.out + pix[h] * p.Co + n) = pack_bf16(v0, v1);
      s1x += v0;
      s1y += v1;
      s2x += v0 * v0;
      s2y += v1 * v1;
    }
    if (p.stats) {
      // sum over the warp's 16 rows: the lanes of one t differ in g
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        s1x += __shfl_xor_sync(0xffffffffu, s1x, o);
        s1y += __shfl_xor_sync(0xffffffffu, s1y, o);
        s2x += __shfl_xor_sync(0xffffffffu, s2x, o);
        s2y += __shfl_xor_sync(0xffffffffu, s2y, o);
      }
      if (g == 0) {
        part[warp * BN + col] = make_float2(s1x, s2x);
        part[warp * BN + col + 1] = make_float2(s1y, s2y);
      }
    }
  }
  if (p.stats) {
    asm volatile("bar.sync 1, %0;\n" ::"n"(V_CONSUMERS) : "memory");
    // [B][PH·row tiles][2][Co]: K7's phase p at row tiles p·gridDim.y ..
    float* st = p.stats + ((long long)blockIdx.z * gridDim.y + tile) * 2 * p.Co;
    for (int col = tid; col < BN; col += V_CONSUMERS) {
      const int n = n0 + col;
      if (n >= p.Co) continue;
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int w = 0; w < V_CONSUMERS / 32; ++w) {
        const float2 v = part[w * BN + col];
        s1 += v.x;
        s2 += v.y;
      }
      st[n] = s1;
      st[p.Co + n] = s2;
    }
  }
}

// ---- host side

// the NHWC map [B][H][W][C] as a 4-D tensor map read in boxes of 64
// channels x bw pixels x bh rows x 1 image
cudaError_t make_map_nhwc(CUtensorMap* map, const void* ptr, int B, int H, int W, int C, int bw) {
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {(cuuint32_t)V_BK, (cuuint32_t)bw, (cuuint32_t)(V_BM / bw), 1};
  return make_map(map, ptr, 4, dims, strides, box);
}

template <int BN, int PRO, int TAPS>
cudaError_t launch_conv_sm90(const CUtensorMap& mx, const CUtensorMap& mx2, const CUtensorMap& mw,
                             const ConvSm90& p, int B, int tiles, int smem, cudaStream_t stream) {
  if (smem != smem_needed<BN>(p.stages, p.C1 + p.C2, PRO != PRO_NONE) || smem > V_MAX_SMEM)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(conv_sm90_kernel<BN, PRO, TAPS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Co + BN - 1) / BN, tiles, B);
  conv_sm90_kernel<BN, PRO, TAPS><<<grid, V_NT, smem, stream>>>(mx, mx2, mw, p);
  return cudaGetLastError();
}

// the instance for a tile width known at run time
template <int PRO, int TAPS>
cudaError_t launch_conv_sm90(int bn, const CUtensorMap& mx, const CUtensorMap& mx2,
                             const CUtensorMap& mw, const ConvSm90& p, int B, int tiles, int smem,
                             cudaStream_t s) {
  if (bn == 128) return launch_conv_sm90<128, PRO, TAPS>(mx, mx2, mw, p, B, tiles, smem, s);
  if (bn == 256) return launch_conv_sm90<256, PRO, TAPS>(mx, mx2, mw, p, B, tiles, smem, s);
  if (bn == 320) return launch_conv_sm90<320, PRO, TAPS>(mx, mx2, mw, p, B, tiles, smem, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace sdk

// y [B][H][W][Co] = conv3x3(silu(prologue([x, x2]))) + bias [+ res], bf16,
// zero padding 1 after the prologue. x [B][H][W][C1]; x2 [B][H][W][C2] or
// null (C2 = 0); w [3][3][C1 + C2][Co] (HWIO); bias [Co] bf16 or null;
// scale/shift [B][ld_s] (C1 used) and scale2/shift2 [B][ld_s2] (C2 used)
// f32, or all null (no prologue, and no SiLU); silu must be 1 with a
// prologue (the affine alone takes the WMMA kernel); res like y, or null;
// stats [B][row tiles][2][Co] f32 or null, row tiles = ceil(H / bh)·(W /
// bw). The plan from Python: bn output channels a tile (128, 256 or 320),
// bw pixels of a row a box (min(W, 128), bh = 128 / bw rows), `stages`,
// smem_bytes.
extern "C" int sdk_conv3x3_sm90(const void* x, const void* x2, const void* w, const void* bias,
                                const float* scale, const float* shift, long long ld_s,
                                const float* scale2, const float* shift2, long long ld_s2,
                                int silu, const void* res, void* out,
                                float* stats, int B, int H, int W, int C1, int C2, int Co, int bn,
                                int bw, int stages, int smem_bytes, void* stream) {
  using namespace sdk;
  const void* ptrs[] = {x, x2, w, res, out};
  for (const void* q : ptrs)
    if (q && !sm90::aligned16(q)) return (int)cudaErrorInvalidValue;
  const bool pro = scale != nullptr;
  if (B <= 0 || H <= 0 || W <= 0 || C1 <= 0 || C1 % V_BK || C2 < 0 || C2 % V_BK || Co <= 0 ||
      Co % 8 || reinterpret_cast<uintptr_t>(bias) % 4 || stages < 2 ||
      bw != (W < V_BM ? W : V_BM) || V_BM % bw || W % bw || (x2 != nullptr) != (C2 > 0) ||
      (shift != nullptr) != pro || (pro && (ld_s < C1 || !silu)) ||
      (C2 > 0 && ((scale2 != nullptr) != pro || (shift2 != nullptr) != pro || (pro && ld_s2 < C2))))
    return (int)cudaErrorInvalidValue;
  CUtensorMap mx, mx2, mw;
  cudaError_t err = make_map_nhwc(&mx, x, B, H, W, C1, bw);
  if (err == cudaSuccess && x2) err = make_map_nhwc(&mx2, x2, B, H, W, C2, bw);
  if (err == cudaSuccess) err = sm90::make_map_2d(&mw, w, Co, 9LL * (C1 + C2), Co, V_BOX, V_BK);
  if (err != cudaSuccess) return (int)err;
  if (!x2) mx2 = mx;  // never read
  ConvSm90 p{static_cast<const bf16*>(bias), scale, shift, scale2, shift2, ld_s, ld_s2,
             static_cast<const bf16*>(res), static_cast<bf16*>(out), stats,
             H, W, C1, C2, Co, bw, stages};
  const int tiles = (H + V_BM / bw - 1) / (V_BM / bw) * (W / bw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(pro ? launch_conv_sm90<PRO_SILU, 9>(bn, mx, mx2, mw, p, B, tiles, smem_bytes, s)
                   : launch_conv_sm90<PRO_NONE, 9>(bn, mx, mx2, mw, p, B, tiles, smem_bytes, s));
}

// K4: y [B][rows][Co] = act(x·scale + shift)·w + bias [+ res], bf16. x
// [B][rows][C]; w [C][Co]; bias [Co] bf16 or null; scale/shift [B][ld_s]
// f32 (C used), or both null (no prologue); act = SiLU when silu, else
// none; res like y, or null; stats [B][row tiles][2][Co] f32 or null, row
// tiles = ceil(rows / 128). C a multiple of 64, Co of 8. The plan from
// Python: bn output channels a tile (128, 256 or 320), `stages`,
// smem_bytes.
extern "C" int sdk_conv1x1_sm90(const void* x, const void* w, const void* bias,
                                const float* scale, const float* shift, long long ld_s, int silu,
                                const void* res, void* out, float* stats, int B, int rows, int C,
                                int Co, int bn, int stages, int smem_bytes, void* stream) {
  using namespace sdk;
  const void* ptrs[] = {x, w, res, out};
  for (const void* q : ptrs)
    if (q && !sm90::aligned16(q)) return (int)cudaErrorInvalidValue;
  const bool pro = scale != nullptr;
  if (B <= 0 || rows <= 0 || C <= 0 || C % V_BK || Co <= 0 || Co % 8 ||
      reinterpret_cast<uintptr_t>(bias) % 4 || stages < 2 || (shift != nullptr) != pro ||
      (pro && ld_s < C))
    return (int)cudaErrorInvalidValue;
  // x as [B][rows][C], in boxes of 64 channels x 128 rows x 1 image
  CUtensorMap mx, mw;
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)rows * C * 2};
  const cuuint32_t box[3] = {(cuuint32_t)V_BK, (cuuint32_t)V_BM, 1};
  cudaError_t err = sm90::make_map(&mx, x, 3, dims, strides, box);
  if (err == cudaSuccess) err = sm90::make_map_2d(&mw, w, Co, C, Co, V_BOX, V_BK);
  if (err != cudaSuccess) return (int)err;
  // the map's rows as a 1-pixel-wide image: tile t is rows 128t .. 128t + 127
  ConvSm90 p{static_cast<const bf16*>(bias), scale, shift, nullptr, nullptr, ld_s, 0,
             static_cast<const bf16*>(res), static_cast<bf16*>(out), stats,
             rows, 1, C, 0, Co, 1, stages};
  const int tiles = (rows + V_BM - 1) / V_BM;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!pro) return (int)launch_conv_sm90<PRO_NONE, 1>(bn, mx, mx, mw, p, B, tiles, smem_bytes, s);
  if (silu) return (int)launch_conv_sm90<PRO_SILU, 1>(bn, mx, mx, mw, p, B, tiles, smem_bytes, s);
  return (int)launch_conv_sm90<PRO_AFFINE, 1>(bn, mx, mx, mw, p, B, tiles, smem_bytes, s);
}

// K7: y [B][2H][2W][Co] = conv3x3(nearest2x(x)) + bias, bf16, as four output
// phases p = 2·py + px of 2x2 taps at x's resolution. x [B][H][W][C]; w
// [4][4·C][Co], phase p's taps (dy, dx) in rows (2·dy + dx)·C .. + C
// (sdtpu_torch/ops/conv.py:upsample_phase_weights, reshaped); bias [Co] bf16
// or null; stats [B][4·row tiles][2][Co] f32 or null, phase p's partials at
// row tiles p·(row tiles) .., row tiles = ceil(H / bh)·(W / bw). C a multiple
// of 64, Co of 8. The plan from Python (fused_conv.upsample_sm90_plan): bn
// output channels a tile (128, 256 or 320), bw pixels of a row a box
// (min(W, 128), bh = 128 / bw rows), `stages`, smem_bytes.
extern "C" int sdk_upsample_conv_sm90(const void* x, const void* w, const void* bias, void* out,
                                      float* stats, int B, int H, int W, int C, int Co, int bn,
                                      int bw, int stages, int smem_bytes, void* stream) {
  using namespace sdk;
  const void* ptrs[] = {x, w, out};
  for (const void* q : ptrs)
    if (!sm90::aligned16(q)) return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % V_BK || Co <= 0 || Co % 8 ||
      reinterpret_cast<uintptr_t>(bias) % 4 || stages < 2 || bw != (W < V_BM ? W : V_BM) ||
      V_BM % bw || W % bw)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mx, mw;
  cudaError_t err = make_map_nhwc(&mx, x, B, H, W, C, bw);
  if (err == cudaSuccess) err = sm90::make_map_2d(&mw, w, Co, 16LL * C, Co, V_BOX, V_BK);
  if (err != cudaSuccess) return (int)err;
  ConvSm90 p{static_cast<const bf16*>(bias), nullptr, nullptr, nullptr, nullptr, 0, 0,
             nullptr, static_cast<bf16*>(out), stats, H, W, C, 0, Co, bw, stages};
  const int tiles = (H + V_BM / bw - 1) / (V_BM / bw) * (W / bw);
  return (int)launch_conv_sm90<PRO_NONE, 4>(bn, mx, mx, mw, p, 4 * B, tiles, smem_bytes,
                                            static_cast<cudaStream_t>(stream));
}
