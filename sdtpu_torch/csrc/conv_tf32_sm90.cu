// K6, K7 and K4 in float32 on Hopper's TMA and warpgroup tensor-core
// instructions, TF32 in and f32 accumulators: the float32 routes (float32 is
// the default dtype of `sample`, `serve` and `finetune`) of
// - K6, the fused 3x3 convolution, sdtpu/ops/fused_conv.py:conv3x3_fused
//   (its Pallas body `_kernel` / `_conv_part` :96/:44, called at :232):
//
//     y = conv3x3(act(x·scale + shift)) + b [+ residual], act = SiLU, with
//     the zero padding applied after the prologue, over the implicit channel
//     concat [x, x2], and per-channel (Σy, Σy²) of the f32 y;
//
// - K7, the fused 2x upsample convolution, sdtpu/ops/fused_conv.py:
//   upsample2x_conv_fused (its Pallas body `_up_kernel` :276, called at
//   :372): y = conv3x3(nearest2x(x)) + b as four output phases (py, px),
//   each a 2x2-tap convolution at x's resolution with the folded weights of
//   ops/conv.py:upsample_phase_weights, with the same statistics.
//
// What bounds it on the H100: 2·9·(C1 + C2)·Co operations per pixel (K7:
// 2·16·C·Co per input pixel) against (C1 + C2 + Co) f32 values of it:
// compute-bound at every main-path shape at TF32's dense peak (495 TFLOP/s,
// half of bf16's): 0.156 ms against 0.080 ms of bytes for the VAE decoder's
// 512² x 128 convs, 0.366 against 0.078 for the UNet's 128² 640 + 320 ->
// 320.
//
// The structure is csrc/conv_sm90.cu's (read its header), with the TF32
// idiom of csrc/gemm_tf32_sm90.cu:
//
// - A CTA computes 128 pixels of one image (a box of bw = gcd(W, 128)
//   pixels by bh = 128 / bw rows) times bn output channels (128, 256, or 320
//   for the UNet's 320-channel convs): two consumer warpgroups of 64 pixels
//   each and a producer warpgroup that hands its registers to them
//   (setmaxnreg 40 / 232), of which one thread keeps a ring of `stages`
//   shared-memory stages full with TMA loads. At the 320-channel tile
//   ptxas serialises the products (its C7512: 160 accumulators and two
//   fragment sets a thread, against the 168 registers it allocates;
//   csrc/conv_sm90.cu's 320-channel instances alike). A producer warp in
//   place of the warpgroup (288 threads) left ptxas at 168 registers, now
//   with spills, and took 5x as long there (PERF.md).
// - The 128-byte swizzle spans 32 floats, so a K block is one tap and 32
//   channels of x or of x2 (C1 and C2 are multiples of 32, so a block never
//   straddles a tap or the x/x2 boundary): K block kb is tap kb / ((C1 +
//   C2) / 32). Its A operand is one TMA box of a 4-D tensor map over the
//   f32 NHWC map of x (or of x2, through its own map), (32 channels, bw,
//   bh, 1) at (c0, j0 + dx − 1, i0 + dy − 1, b), K-major as it stands;
//   TMA fills every element outside the map with zeros.
// - The operand layout: TF32 wgmma reads B (and an A read from shared
//   memory) only K-major. The weight is the HWIO tensor read as [9·(C1 +
//   C2), Co], N-major, so B is its K-major TF32 copy Wᵀ [Co][9·(C1 + C2)]
//   in the same tap-major, x-then-x2 K order (made once per weight tensor in
//   Python, sdtpu_torch/ops/fused_mlp.py:kmajor, rounded to TF32 there),
//   read by TMA in boxes of 64 output channels x 32 K. K7's is its phase
//   stack's copy, [4][Co][4·C]: phase p's rows p·Co + n.
// - The prologue runs in registers: each consumer loads its A fragments with
//   ldmatrix on 32-bit elements from the swizzled stage (as
//   csrc/gemm_tf32_sm90.cu), applies x·scale + shift per (batch, channel)
//   (staged in shared memory as f32 pairs) and SiLU (one MUFU tanh an
//   element: silu(v) = h + h·tanh(h), h = v / 2), then zeroes every element
//   whose source pixel lies outside the map (TMA's zeros came before the
//   prologue and would otherwise carry silu(shift) into the border), then
//   rounds to TF32 to nearest (cvt.rna). Without a prologue the fragments
//   are only rounded, and TMA's zeros are the padding. Two fragment sets:
//   block kb + 1 is loaded and normalised while block kb's products run.
// - Without a prologue (K7), A could be read straight from the stage by a
//   descriptor, as it is K-major (SS), with no ldmatrix and no rounding
//   (the tensor cores truncate its low 13 bits instead). Measured on the
//   H100 against the register form at K7's main-path shapes, SS was 0.1-3.5 %
//   faster (PERF.md); not taken: every TF32 operand here is rounded
//   to nearest, as in csrc/gemm_tf32_sm90.cu.
// - The products are wgmma.mma_async m64n128k8 or m64n256k8 (plus an
//   m64n64k8 for the last 64 of 320 channels), one instruction spanning the
//   stage's weight boxes (64 rows of 128 bytes each, one after the other),
//   TF32 in, f32 accumulators in registers. No branch sits between a
//   product's issue and its wait (ptxas's C7517 otherwise waits for every K
//   block's products before the next block's prologue).
// - The epilogue runs on the accumulators: conv bias and residual in f32,
//   one f32 store, and each tile's per-channel (Σ, Σ²) of the f32 result
//   summed over its rows with warp shuffles, then over the eight warps in
//   shared memory, into [B][row tiles][2][Co]: no atomics, every run the
//   same bits.
//
// - K4, the fused 1x1 convolution, sdtpu/ops/fused_conv.py:conv1x1_fused
//   (its Pallas body `_mm_kernel` :406, called at :473), is the same kernel
//   at one tap (TAPS = 1), y = act(x·scale + shift)·W + b [+ residual], act
//   = SiLU or none (proj_in: the GroupNorm affine alone; proj_out: no
//   prologue and the residual), over x viewed as [B][rows][C]: its A box is
//   a TMA box of a 3-D tensor map (32 channels, 128 rows, 1 image) at the
//   tile's own rows, zeros past the last row, whose rows are neither stored
//   nor counted; no border mask; B the K-major TF32 copy Wᵀ [Co][C]. At SD's
//   shapes it is bound by its bytes (4096 rows x 320 -> 320 at batch 2: 6.3
//   µs of HBM, 9.4 with the residual, against 3.4 µs of TF32 products), so
//   the ring, the residual's read and the store are what its time is made
//   of.
//
// The tile plan (bn, the box, the stages, the shared-memory bytes) comes
// from Python (sdtpu_torch/ops/fused_conv.py:tf32_conv_plan, and
// upsample_tf32_plan for K7, conv1x1_tf32_plan for K4) and is checked here.
// Other shapes, and K6 with an affine prologue without SiLU (no main path
// runs it), take the WMMA kernel (csrc/gemm.cu).
#include "tf32_sm90.cuh"

namespace sdk {
namespace {

using namespace sm90;

constexpr int F_BM = 128, F_BK = 32, F_BOX = 64;
// two consumer warpgroups and a producer warpgroup, of which one thread
// issues the loads
constexpr int F_CONSUMERS = 256, F_NT = F_CONSUMERS + 128;
constexpr uint32_t F_A_BYTES = F_BM * F_BK * 4;   // 16384: the A box
constexpr uint32_t F_W_BYTES = F_BOX * F_BK * 4;  // 8192: 64 rows of Wᵀ
constexpr int F_MAX_SMEM = 232448;
// prologues: none, the GroupNorm affine (K4's proj_in), the affine then SiLU
constexpr int FPRO_NONE = 0, FPRO_AFFINE = 1, FPRO_SILU = 2;

struct ConvTf32 {
  const float* bias;    // [Co], or null
  const float* scale;   // prologue [B][ld_s] of x (C1 used), or null
  const float* shift;
  const float* scale2;  // and [B][ld_s2] of x2 (C2 used)
  const float* shift2;
  long long ld_s, ld_s2;
  const float* res;     // [B][H][W][Co], or null
  float* out;           // [B][H][W][Co] (K7: [B][2H][2W][Co]; K4: H = rows, W = 1)
  float* stats;         // [B][row tiles][2][Co], or null
  int H, W, C1, C2, Co, bw, stages;
};

// BN output channels a tile, in BN / 64 weight boxes
template <int BN>
__host__ __device__ constexpr uint32_t stage_bytes() {
  return F_A_BYTES + BN / F_BOX * F_W_BYTES;
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
// ks (8 columns, 32 bytes into each 128-byte row): one instruction over the
// boxes (n128, n256), and n64 for a fifth
template <int BN>
__device__ __forceinline__ void conv_mma(float* acc, const uint32_t* af, uint32_t w_base, int ks) {
  const uint64_t db = desc_k_major_sw128(w_base + ks * 32);
  if constexpr (BN == 128) {
    wgmma_tf32_rs_n128(acc, af, db);
  } else {
    wgmma_tf32_rs_n256(acc, af, db);
    if constexpr (BN == 320)
      wgmma_tf32_rs_n64(acc + 128, af, desc_k_major_sw128(w_base + 4 * F_W_BYTES + ks * 32));
  }
}

// PRO: the prologue (FPRO_NONE, FPRO_AFFINE, FPRO_SILU); TAPS: 9 (K6), 4
// (K7: one output phase's 2x2 taps, the phase in blockIdx.z = 4·b + 2·py +
// px) or 1 (K4: map_x 3-D over [B][rows][C], read with H = rows, W = 1)
template <int BN, int PRO, int TAPS>
__global__ void __launch_bounds__(F_NT, 1)
    conv_tf32_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_x2,
                     const __grid_constant__ CUtensorMap map_w, const ConvTf32 p) {
  static_assert(TAPS == 9 || TAPS == 4 || TAPS == 1, "3x3, K7's 2x2 phases, or 1x1");
  static_assert(TAPS != 4 || PRO == FPRO_NONE, "K7 has no prologue: TMA's zeros pad it");
  constexpr uint32_t STAGE = stage_bytes<BN>();
  constexpr int NB = BN / F_BOX;
  constexpr int KW = TAPS == 9 ? 3 : TAPS == 4 ? 2 : 1;  // taps a row
  constexpr int PH = TAPS == 4 ? 4 : 1;  // output phases in the grid
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int stages = p.stages;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * STAGE);
  uint64_t* empty = full + stages;
  float2* s_aff = reinterpret_cast<float2*>(empty + stages);  // (scale, shift) per channel

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ct = p.C1 + p.C2, kpt = ct / F_BK;  // K blocks a tap
  const int nk = TAPS * kpt;
  const int bw = p.bw, bh = F_BM / bw, tiles_w = p.W / bw;
  const int b = blockIdx.z / PH, tile = blockIdx.y;
  const int i0 = tile / tiles_w * bh, j0 = tile % tiles_w * bw;
  const int n0 = blockIdx.x * NB * F_BOX;
  // K7's phase (py, px); the source pixel of tap (0, 0) is (i + oy, j + ox):
  // the 3x3's padding of 1, or the phase's top and left padding 1 − py, 1 − px
  const int phase = blockIdx.z % PH, py = phase >> 1, px = phase & 1;
  const int oy = TAPS == 4 ? py - 1 : -1, ox = TAPS == 4 ? px - 1 : -1;
  const int w_row0 = phase * p.Co;  // K7: phase p's rows of the [4·Co][4·C] copy

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], F_CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= F_CONSUMERS / 32) {
    // ---- the producer warpgroup gives its registers to the consumers; one
    // thread issues every TMA load
    setmaxnreg_dec<40>();
    if (warp == F_CONSUMERS / 32 && lane == 0) {
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % stages;
        if (kb >= stages) mbar_wait(&empty[s], ((kb / stages) - 1) & 1);
        mbar_expect_tx(&full[s], STAGE);
        unsigned char* st = smem + s * STAGE;
        const int tap = kb / kpt, c0 = (kb - tap * kpt) * F_BK;
        const int sy = i0 + tap / KW + oy, sx = j0 + tap % KW + ox;
        if constexpr (TAPS == 1)
          tma_load_3d(st, &map_x, &full[s], c0, i0, b);
        else if (c0 < p.C1)
          tma_load_4d(st, &map_x, &full[s], c0, sx, sy, b);
        else
          tma_load_4d(st, &map_x2, &full[s], c0 - p.C1, sx, sy, b);
#pragma unroll
        for (int bb = 0; bb < NB; ++bb)
          tma_load_2d(st + F_A_BYTES + bb * F_W_BYTES, &map_w, &full[s], kb * F_BK,
                      w_row0 + n0 + bb * F_BOX);
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
  if constexpr (PRO != FPRO_NONE) {
    for (int c = tid; c < ct; c += F_CONSUMERS)
      s_aff[c] = c < p.C1 ? make_float2(p.scale[b * p.ld_s + c], p.shift[b * p.ld_s + c])
                          : make_float2(p.scale2[b * p.ld_s2 + c - p.C1],
                                        p.shift2[b * p.ld_s2 + c - p.C1]);
    // the consumers only (the producer warpgroup never reaches it)
    asm volatile("bar.sync 1, %0;\n" ::"n"(F_CONSUMERS) : "memory");
  }
  // the pixels (i, j) of this thread's rows g and g + 8
  int pi[2], pj[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row_w + g + 8 * h;
    pi[h] = i0 + r / bw;
    pj[h] = j0 + r % bw;
  }
  // ldmatrix on 32-bit elements (csrc/gemm_tf32_sm90.cu): lane l gives the
  // address of row (l & 7) + 8·((l >> 3) & 1) of this warp's 16, 16-byte
  // chunk 2·ks + (l >> 4) (swizzled as TMA wrote it: chunk ^ row % 8 within
  // each 128-byte row); the four registers are the TF32 A fragment's (g,
  // t), (g + 8, t), (g, t + 4), (g + 8, t + 4) of K step ks
  const int lrow = row_w + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lchunk = lane >> 4;

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  // K block kb: wait for its stage, load this warp's A fragments with
  // ldmatrix, apply the prologue and then (3x3) the border mask, and round
  // to TF32, in registers
  auto prepare = [&](uint32_t(&af)[4][4], int kb) {
    const int s = kb % stages;
    mbar_wait(&full[s], (kb / stages) & 1);
    const uint32_t a_base = smem_u32(smem + s * STAGE) + lrow * 128;
    const int tap = kb / kpt, c0 = (kb - tap * kpt) * F_BK;
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
      ldmatrix_x4(af[ks], a_base + (((2 * ks + lchunk) ^ (lrow & 7)) << 4));
      // register j holds (row g + 8·(j & 1), channel c0 + 8·ks + 4·(j >> 1) + t)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float v = __uint_as_float(af[ks][j]);
        if constexpr (PRO != FPRO_NONE) {
          const float2 a = s_aff[c0 + ks * 8 + 4 * (j >> 1) + t];
          v = fmaf(v, a.x, a.y);
          if constexpr (PRO == FPRO_SILU) {
            const float hv = 0.5f * v;
            v = fmaf(hv, tanh_approx(hv), hv);
          }
          if constexpr (TAPS != 1) v = inside[j & 1] ? v : 0.f;
        }
        af[ks][j] = to_tf32(v);
      }
    }
  };
  // issue K block kb's products (one commit group)
  auto issue = [&](uint32_t(&af)[4][4], int kb) {
    const uint32_t w_base = smem_u32(smem + (kb % stages) * STAGE + F_A_BYTES);
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
  if (p.stats) asm volatile("bar.sync 1, %0;\n" ::"n"(F_CONSUMERS) : "memory");
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * t, n = n0 + col;
    const bool n_ok = n < p.Co;
    float2 bv = make_float2(0.f, 0.f);
    if (n_ok && p.bias) bv = make_float2(p.bias[n], p.bias[n + 1]);
    float s1x = 0.f, s1y = 0.f, s2x = 0.f, s2y = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!n_ok || !row_ok[h]) continue;
      float v0 = acc[4 * j + 2 * h] + bv.x, v1 = acc[4 * j + 2 * h + 1] + bv.y;
      if (p.res) {
        const float2 r = *reinterpret_cast<const float2*>(p.res + pix[h] * p.Co + n);
        v0 += r.x;
        v1 += r.y;
      }
      *reinterpret_cast<float2*>(p.out + pix[h] * p.Co + n) = make_float2(v0, v1);
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
    asm volatile("bar.sync 1, %0;\n" ::"n"(F_CONSUMERS) : "memory");
    // [B][PH·row tiles][2][Co]: K7's phase p at row tiles p·gridDim.y ..
    float* st = p.stats + ((long long)blockIdx.z * gridDim.y + tile) * 2 * p.Co;
    for (int col = tid; col < BN; col += F_CONSUMERS) {
      const int n = n0 + col;
      if (n >= p.Co) continue;
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int w = 0; w < F_CONSUMERS / 32; ++w) {
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

// the f32 NHWC map [B][H][W][C] as a 4-D tensor map read in boxes of 32
// channels x bw pixels x bh rows x 1 image
cudaError_t make_map_nhwc_f32(CUtensorMap* map, const void* ptr, int B, int H, int W, int C,
                              int bw) {
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 4, (cuuint64_t)W * C * 4,
                                 (cuuint64_t)H * W * C * 4};
  const cuuint32_t box[4] = {(cuuint32_t)F_BK, (cuuint32_t)bw, (cuuint32_t)(F_BM / bw), 1};
  return make_map_f32(map, ptr, 4, dims, strides, box);
}

template <int BN, int PRO, int TAPS>
cudaError_t launch_conv_tf32(const CUtensorMap& mx, const CUtensorMap& mx2, const CUtensorMap& mw,
                             const ConvTf32& p, int Bz, int tiles, int smem, cudaStream_t stream) {
  if (smem != smem_needed<BN>(p.stages, p.C1 + p.C2, PRO != FPRO_NONE) || smem > F_MAX_SMEM)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(conv_tf32_kernel<BN, PRO, TAPS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.Co + BN - 1) / BN, tiles, Bz);
  conv_tf32_kernel<BN, PRO, TAPS><<<grid, F_NT, smem, stream>>>(mx, mx2, mw, p);
  return cudaGetLastError();
}

// the instance for a tile width known at run time
template <int PRO, int TAPS>
cudaError_t launch_conv_tf32(int bn, const CUtensorMap& mx, const CUtensorMap& mx2,
                             const CUtensorMap& mw, const ConvTf32& p, int Bz, int tiles,
                             int smem, cudaStream_t s) {
  if (bn == 128) return launch_conv_tf32<128, PRO, TAPS>(mx, mx2, mw, p, Bz, tiles, smem, s);
  if (bn == 256) return launch_conv_tf32<256, PRO, TAPS>(mx, mx2, mw, p, Bz, tiles, smem, s);
  if (bn == 320) return launch_conv_tf32<320, PRO, TAPS>(mx, mx2, mw, p, Bz, tiles, smem, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace sdk

// y [B][H][W][Co] = conv3x3(silu(prologue([x, x2]))) + bias [+ res], f32 with
// TF32 products, zero padding 1 after the prologue. x [B][H][W][C1]; x2
// [B][H][W][C2] or null (C2 = 0); wt the K-major copy [Co][9·(C1 + C2)] of
// the HWIO weight [3][3][C1 + C2][Co] (row n holds output channel n's taps,
// tap-major, x's channels then x2's), rounded to TF32; bias [Co] f32 or
// null; scale/shift [B][ld_s] (C1 used) and scale2/shift2 [B][ld_s2] (C2
// used) f32, or all null (no prologue, and no SiLU); silu must be 1 with a
// prologue (the affine alone takes the WMMA kernel); res like y, or null;
// stats [B][row tiles][2][Co] f32 or null, row tiles = ceil(H / bh)·(W /
// bw). C1 and C2 multiples of 32, Co of 8. The plan from Python
// (fused_conv.tf32_conv_plan): bn output channels a tile (128, 256 or 320),
// bw pixels of a row a box (gcd(W, 128), bh = 128 / bw rows), `stages`,
// smem_bytes.
extern "C" int sdk_conv3x3_tf32(const void* x, const void* x2, const void* wt, const void* bias,
                                const float* scale, const float* shift, long long ld_s,
                                const float* scale2, const float* shift2, long long ld_s2,
                                int silu, const void* res, void* out,
                                float* stats, int B, int H, int W, int C1, int C2, int Co, int bn,
                                int bw, int stages, int smem_bytes, void* stream) {
  using namespace sdk;
  const void* ptrs[] = {x, x2, wt, res, out};
  for (const void* q : ptrs)
    if (q && !sm90::aligned16(q)) return (int)cudaErrorInvalidValue;
  const bool pro = scale != nullptr;
  if (B <= 0 || H <= 0 || W <= 0 || C1 <= 0 || C1 % F_BK || C2 < 0 || C2 % F_BK || Co <= 0 ||
      Co % 8 || reinterpret_cast<uintptr_t>(bias) % 4 || stages < 2 ||
      bw <= 0 || F_BM % bw || W % bw || (x2 != nullptr) != (C2 > 0) ||
      (shift != nullptr) != pro || (pro && (ld_s < C1 || !silu)) ||
      (C2 > 0 && ((scale2 != nullptr) != pro || (shift2 != nullptr) != pro || (pro && ld_s2 < C2))))
    return (int)cudaErrorInvalidValue;
  CUtensorMap mx, mx2, mw;
  const long long kt = 9LL * (C1 + C2);
  cudaError_t err = make_map_nhwc_f32(&mx, x, B, H, W, C1, bw);
  if (err == cudaSuccess && x2) err = make_map_nhwc_f32(&mx2, x2, B, H, W, C2, bw);
  if (err == cudaSuccess) err = sm90::make_map_f32_2d(&mw, wt, kt, Co, kt, F_BOX);
  if (err != cudaSuccess) return (int)err;
  if (!x2) mx2 = mx;  // never read
  ConvTf32 p{static_cast<const float*>(bias), scale, shift, scale2, shift2, ld_s, ld_s2,
             static_cast<const float*>(res), static_cast<float*>(out), stats,
             H, W, C1, C2, Co, bw, stages};
  const int tiles = (H + F_BM / bw - 1) / (F_BM / bw) * (W / bw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(pro ? launch_conv_tf32<FPRO_SILU, 9>(bn, mx, mx2, mw, p, B, tiles, smem_bytes, s)
                   : launch_conv_tf32<FPRO_NONE, 9>(bn, mx, mx2, mw, p, B, tiles, smem_bytes, s));
}

// K4: y [B][rows][Co] = act(x·scale + shift)·w + bias [+ res], f32 with
// TF32 products. x [B][rows][C]; wt the K-major copy [Co][C] of the weight
// [C][Co], rounded to TF32; bias [Co] f32 or null; scale/shift [B][ld_s]
// f32 (C used), or both null (no prologue); act = SiLU when silu, else
// none; res like y, or null; stats [B][row tiles][2][Co] f32 or null, row
// tiles = ceil(rows / 128). C a multiple of 32, Co of 8. The plan from
// Python (fused_conv.conv1x1_tf32_plan): bn output channels a tile (128,
// 256 or 320), `stages`, smem_bytes.
extern "C" int sdk_conv1x1_tf32(const void* x, const void* wt, const void* bias,
                                const float* scale, const float* shift, long long ld_s, int silu,
                                const void* res, void* out, float* stats, int B, int rows, int C,
                                int Co, int bn, int stages, int smem_bytes, void* stream) {
  using namespace sdk;
  const void* ptrs[] = {x, wt, res, out};
  for (const void* q : ptrs)
    if (q && !sm90::aligned16(q)) return (int)cudaErrorInvalidValue;
  const bool pro = scale != nullptr;
  if (B <= 0 || rows <= 0 || C <= 0 || C % F_BK || Co <= 0 || Co % 8 ||
      reinterpret_cast<uintptr_t>(bias) % 4 || stages < 2 || (shift != nullptr) != pro ||
      (pro && ld_s < C))
    return (int)cudaErrorInvalidValue;
  // x as [B][rows][C], in boxes of 32 channels x 128 rows x 1 image
  CUtensorMap mx, mw;
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)C * 4, (cuuint64_t)rows * C * 4};
  const cuuint32_t box[3] = {(cuuint32_t)F_BK, (cuuint32_t)F_BM, 1};
  cudaError_t err = sm90::make_map_f32(&mx, x, 3, dims, strides, box);
  if (err == cudaSuccess) err = sm90::make_map_f32_2d(&mw, wt, C, Co, C, F_BOX);
  if (err != cudaSuccess) return (int)err;
  // the map's rows as a 1-pixel-wide image: tile t is rows 128t .. 128t + 127
  ConvTf32 p{static_cast<const float*>(bias), scale, shift, nullptr, nullptr, ld_s, 0,
             static_cast<const float*>(res), static_cast<float*>(out), stats,
             rows, 1, C, 0, Co, 1, stages};
  const int tiles = (rows + F_BM - 1) / F_BM;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!pro) return (int)launch_conv_tf32<FPRO_NONE, 1>(bn, mx, mx, mw, p, B, tiles, smem_bytes, s);
  if (silu) return (int)launch_conv_tf32<FPRO_SILU, 1>(bn, mx, mx, mw, p, B, tiles, smem_bytes, s);
  return (int)launch_conv_tf32<FPRO_AFFINE, 1>(bn, mx, mx, mw, p, B, tiles, smem_bytes, s);
}

// K7: y [B][2H][2W][Co] = conv3x3(nearest2x(x)) + bias, f32 with TF32
// products, as four output phases p = 2·py + px of 2x2 taps at x's
// resolution. x [B][H][W][C]; wt the K-major copy [4][Co][4·C] of the
// phase stack [4][4·C][Co] (fused_conv.phase_weight_stack: phase p's taps
// (dy, dx) in K columns (2·dy + dx)·C .. + C), rounded to TF32; bias [Co]
// f32 or null; stats [B][4·row tiles][2][Co] f32 or null, phase p's
// partials at row tiles p·(row tiles) .., row tiles = ceil(H / bh)·(W /
// bw). C a multiple of 32, Co of 8. The plan from Python
// (fused_conv.upsample_tf32_plan): bn output channels a tile (128, 256 or
// 320), bw pixels of a row a box (gcd(W, 128), bh = 128 / bw rows),
// `stages`, smem_bytes.
extern "C" int sdk_upsample_conv_tf32(const void* x, const void* wt, const void* bias, void* out,
                                      float* stats, int B, int H, int W, int C, int Co, int bn,
                                      int bw, int stages, int smem_bytes, void* stream) {
  using namespace sdk;
  const void* ptrs[] = {x, wt, out};
  for (const void* q : ptrs)
    if (!sm90::aligned16(q)) return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % F_BK || Co <= 0 || Co % 8 ||
      reinterpret_cast<uintptr_t>(bias) % 4 || stages < 2 || bw <= 0 ||
      F_BM % bw || W % bw)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mx, mw;
  cudaError_t err = make_map_nhwc_f32(&mx, x, B, H, W, C, bw);
  if (err == cudaSuccess) err = sm90::make_map_f32_2d(&mw, wt, 4LL * C, 4LL * Co, 4LL * C, F_BOX);
  if (err != cudaSuccess) return (int)err;
  ConvTf32 p{static_cast<const float*>(bias), nullptr, nullptr, nullptr, nullptr, 0, 0,
             nullptr, static_cast<float*>(out), stats, H, W, C, 0, Co, bw, stages};
  const int tiles = (H + F_BM / bw - 1) / (F_BM / bw) * (W / bw);
  return (int)launch_conv_tf32<FPRO_NONE, 4>(bn, mx, mx, mw, p, 4 * B, tiles, smem_bytes,
                                             static_cast<cudaStream_t>(stream));
}
