// K5 in bf16: the two products of the fused GEGLU MLP, sdtpu/ops/fused_mlp.py:
// fused_geglu_mlp (its Pallas body `_kernel` :43, called at :87), on Hopper's
// warpgroup tensor-core instructions:
//
//   1. h = val · gelu_erf(gate), [val | gate] = LN(x) · W_proj + b_proj, the
//      gate columns 4C to the right of the val columns of W_proj [C, 8C];
//   2. out = h · W_lin + b_lin + x.
//
// What bounds it on the H100: 2·M·C·(8C + 4C) operations against a few M·C
// bytes, about 1.1 µs of operations per µs of bytes at C = 640 and more at
// 1280: compute-bound (20.1 GFLOP, 0.020 ms at the bf16 peak, at S = 1024,
// C = 640, B = 2). The design feeds the tensor cores without stalls and
// keeps every elementwise step in registers:
//
// - A CTA computes a 128-row tile: two consumer warpgroups of 64 rows each
//   and a producer warpgroup that hands its registers to them (setmaxnreg,
//   40 against 232) and of which one thread keeps a ring of `stages`
//   shared-memory stages full with TMA loads (cp.async.bulk.tensor, 128-byte
//   swizzle): per 64-deep K step one 128 x 64 box of A and one 64 x 64 box of
//   W per 64 columns of the tile. Full and empty mbarriers hand the stages
//   over; the producer waits only for a stage the consumers have released,
//   so the loads of the next stages are in flight while the current one is
//   multiplied. TMA fills rows past M (and columns past K or N) with zeros,
//   so a ragged M needs no masking on the load side; the stores are masked.
// - Each consumer keeps two sets of A fragments: K step kb + 1 is loaded,
//   normalised and issued while step kb's products run, and step kb is then
//   waited for (wgmma.wait_group 1) and its stage released.
// - The products are wgmma.mma_async m64n64k16, bf16 in, f32 accumulators in
//   registers, A from registers and W from shared memory. W is [K, N]
//   row-major, N-major for wgmma's B operand: the descriptor's transpose bit
//   takes it as it is, no copy of the weights.
// - The LayerNorm prologue runs in registers: each consumer loads its A
//   fragment with ldmatrix from the swizzled stage, applies (x − μ)·rstd,
//   rounds to bf16 as sdtpu's `_kernel` does, then ·γ + β in f32, and packs
//   the bf16 fragment that wgmma reads. μ and rstd of each row come from a
//   pre-pass (row_stats_kernel: one warp a row, 16-byte loads, two passes
//   over the row, M·C·2 bytes read once, about 1 µs at the main shapes), so
//   no column block recomputes them.
// - The epilogue runs on the accumulators: a GEGLU tile takes its W boxes at
//   n0.. (val) and n0 + 4C.. (gate), so in wgmma's accumulator layout one
//   thread holds a val element and its gate element; bias, GEGLU and the
//   residual are applied in f32 and each output is stored once. γ, β and the
//   biases are read in the weights' dtype and widened on load.
// - No split-K, no atomics: every run gives the same bits.
//
// The tile shape, the stage count and the shared-memory bytes are planned in
// Python (sdtpu_torch/ops/fused_mlp.py:sm90_plan) and checked here against
// the kernel's own layout. f32 inputs take the WMMA GEMM (csrc/gemm.cu): TF32
// wgmma needs a K-major B, which [K, N] weights are not.
#include <type_traits>

#include "sm90.cuh"

namespace sdk {
namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int G_BM = 128, G_BK = 64, G_BOX = 64;
// two consumer warpgroups and a producer warpgroup, of which one thread
// issues the loads
constexpr int G_CONSUMERS = 256, G_NT = G_CONSUMERS + 128;
constexpr uint32_t G_A_BYTES = G_BM * G_BK * 2, G_W_BYTES = G_BK * G_BOX * 2;
constexpr int G_MAX_SMEM = 232448;
// the LayerNorm's γ and β are staged in shared memory (bf16, K of each)
constexpr int G_LN_MAX_K = 2048;

struct Sm90Gemm {
  const bf16* bias;    // [geglu_off + N] (GEGLU) or [N], or null
  const bf16* gamma;   // LayerNorm γ, β [K], or null (no prologue)
  const bf16* beta;
  const float2* stats; // [M] (μ, rstd) from row_stats_kernel, with gamma
  const bf16* res;     // [M][ldr] residual, or null
  long long ldr;
  bf16* out;           // [M][ldo]
  long long ldo;
  int M, N, K, geglu_off, stages;
};

template <int WB>
__host__ __device__ constexpr uint32_t stage_bytes() {
  return G_A_BYTES + WB * G_W_BYTES;
}
// shared memory: 1024 bytes of slack to align the ring to the swizzle
// pattern's 1024-byte repeat, the stages, a full and an empty barrier each
template <int WB>
__host__ __device__ constexpr int smem_needed(int stages) {
  return 1024 + stages * ((int)stage_bytes<WB>() + 16);
}

__device__ __forceinline__ float gelu_erf(float g) {
  return 0.5f * g * (1.f + erff(g * 0.70710678118654752f));
}

__device__ __forceinline__ float2 bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// (μ, rstd) of each row of x [M][ldx], two passes as layer_norm: one warp a
// row, 16-byte loads (K % 8 == 0)
__global__ void __launch_bounds__(256) row_stats_kernel(const bf16* x, long long ldx,
                                                        float2* stats, int M, int K,
                                                        float eps) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= M) return;
  const uint4* r = reinterpret_cast<const uint4*>(x + (long long)row * ldx);
  const int nv = K / 8;
  float s = 0.f;
  for (int i = lane; i < nv; i += 32) {
    uint4 v = r[i];
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) s += __bfloat162float(e[j]);
  }
  const float mean = warp_sum(s) / K;
  float q = 0.f;
  for (int i = lane; i < nv; i += 32) {
    uint4 v = r[i];
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float d = __bfloat162float(e[j]) - mean;
      q += d * d;
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / K + eps);
  if (lane == 0) stats[row] = make_float2(mean, rstd);
}

// NB: 64-column boxes of output per tile; GEGLU: as many gate boxes again;
// LN: the LayerNorm prologue
template <int NB, bool GEGLU, bool LN>
__global__ void __launch_bounds__(G_NT, 1)
    gemm_sm90_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_w, const Sm90Gemm p) {
  constexpr int WB = NB * (GEGLU ? 2 : 1);
  constexpr uint32_t STAGE = stage_bytes<WB>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int stages = p.stages;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * STAGE);
  uint64_t* empty = full + stages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.y * G_BM, n0 = blockIdx.x * NB * G_BOX;
  const int nk = (p.K + G_BK - 1) / G_BK;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], G_CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= G_CONSUMERS / 32) {
    // ---- the producer warpgroup gives its registers to the consumers; one
    // thread issues every TMA load
    setmaxnreg_dec<40>();
    if (warp == G_CONSUMERS / 32 && lane == 0) {
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % stages;
        if (kb >= stages) mbar_wait(&empty[s], ((kb / stages) - 1) & 1);
        mbar_expect_tx(&full[s], STAGE);
        unsigned char* st = smem + s * STAGE;
        tma_load_2d(st, &map_a, &full[s], kb * G_BK, m0);
#pragma unroll
        for (int b = 0; b < NB; ++b)
          tma_load_2d(st + G_A_BYTES + b * G_W_BYTES, &map_w, &full[s], n0 + b * G_BOX,
                      kb * G_BK);
        if constexpr (GEGLU) {
#pragma unroll
          for (int b = 0; b < NB; ++b)
            tma_load_2d(st + G_A_BYTES + (NB + b) * G_W_BYTES, &map_w, &full[s],
                        n0 + p.geglu_off + b * G_BOX, kb * G_BK);
        }
      }
    }
    return;
  }

  // ---- the consumers: warpgroup wg takes rows wg*64 .. +63 of the tile,
  // warp wl of it rows wl*16 .. +15 (wgmma's A fragment layout)
  setmaxnreg_inc<232>();
  const int wg = warp / 4, wl = warp % 4;
  const int g = lane / 4, t = lane % 4;
  const int row_w = wg * 64 + wl * 16;  // this warp's first row in the tile
  // x̂ = x·rs − mu·rs for rows g and g + 8
  float rs[2] = {1.f, 1.f}, nmr[2] = {0.f, 0.f};
  // (γ_k, γ_k+1) and (β_k, β_k+1) for even k
  __shared__ __nv_bfloat162 s_g[G_LN_MAX_K / 2], s_b[G_LN_MAX_K / 2];
  if constexpr (LN) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + row_w + g + 8 * h;
      if (m < p.M) {
        const float2 st = p.stats[m];
        rs[h] = st.y;
        nmr[h] = -st.x * st.y;
      }
    }
    for (int i = tid; i < (p.K + G_BK - 1) / G_BK * G_BK / 2; i += G_CONSUMERS) {
      const bool ok = 2 * i < p.K;  // K is even: a pair is in or out
      const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
      s_g[i] = ok ? reinterpret_cast<const __nv_bfloat162*>(p.gamma)[i] : zero;
      s_b[i] = ok ? reinterpret_cast<const __nv_bfloat162*>(p.beta)[i] : zero;
    }
    // the consumers only (the producer warpgroup never reaches it)
    asm volatile("bar.sync 1, %0;\n" ::"n"(G_CONSUMERS) : "memory");
  }
  // ldmatrix: lane l gives the address of row (l & 7) + 8·((l >> 3) & 1) of
  // this warp's 16, 16-byte chunk (l >> 4) of the K step, swizzled as TMA
  // wrote it (chunk ^ row % 8 within each 128-byte row)
  const int lrow = row_w + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lchunk = lane >> 4;

  float acc[WB][32];
#pragma unroll
  for (int b = 0; b < WB; ++b)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[b][i] = 0.f;

  // K block kb: wait for its stage, load this warp's A fragments with
  // ldmatrix and apply the LayerNorm in registers
  auto prepare = [&](uint32_t(&af)[4][4], int kb) {
    const int s = kb % stages;
    mbar_wait(&full[s], (kb / stages) & 1);
    const uint32_t a_base = smem_u32(smem + s * STAGE) + lrow * 128;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int chunk = ks * 2 + lchunk;
      ldmatrix_x4(af[ks], a_base + ((chunk ^ (lrow & 7)) << 4));
      if constexpr (LN) {
        // register j holds (row g + 8·(j & 1), columns c, c + 1) with
        // c = 16·ks + 2t + 8·(j >> 1)
        const int kp = (kb * G_BK + ks * 16 + 2 * t) / 2;
        const __nv_bfloat162 gm[2] = {s_g[kp], s_g[kp + 4]}, bt[2] = {s_b[kp], s_b[kp + 4]};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 x = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&af[ks][j]));
          const int h = j & 1;
          // x̂ rounded to bf16 before γ and β, as sdtpu's _kernel rounds it;
          // then x̂·γ + β with one rounding (bf16x2 fma)
          const __nv_bfloat162 xh =
              __floats2bfloat162_rn(fmaf(x.x, rs[h], nmr[h]), fmaf(x.y, rs[h], nmr[h]));
          const __nv_bfloat162 y = __hfma2(xh, gm[j >> 1], bt[j >> 1]);
          af[ks][j] = *reinterpret_cast<const uint32_t*>(&y);
        }
      }
    }
  };
  // issue K block kb's products (one commit group)
  auto issue = [&](uint32_t(&af)[4][4], int kb) {
    const unsigned char* st = smem + (kb % stages) * STAGE;
    fence_regs<WB * 32>(&acc[0][0]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int b = 0; b < WB; ++b)
        wgmma_rs_n64(acc[b], af[ks],
                     desc_n_major_sw128(smem_u32(st + G_A_BYTES + b * G_W_BYTES) + ks * 2048));
    wgmma_commit();
    fence_regs<WB * 32>(&acc[0][0]);
  };
  // K block kb's products have completed: its fragments stay allocated
  // until here (wgmma reads them asynchronously), and its stage is released
  auto retire = [&](uint32_t(&af)[4][4], int kb) {
    fence_regs<16>(&af[0][0]);
    mbar_arrive(&empty[kb % stages]);
  };

  // two fragment sets: block kb + 1 is loaded, normalised and issued while
  // block kb's products are on the tensor cores, then block kb is waited for
  // (wait_group 1). The steady state takes two blocks a trip with no branch
  // between an issue and its wait, so that ptxas keeps the products in
  // flight across the next block's prologue.
  uint32_t fa[4][4], fb[4][4];
  fence_regs<WB * 32>(&acc[0][0]);
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
  fence_regs<WB * 32>(&acc[0][0]);

  // ---- epilogue on the accumulators: thread holds, for each 64-column box
  // b and j < 8, columns 8j + 2t, +1 of rows g (registers 4j, 4j+1) and g + 8
  // (4j+2, 4j+3)
#pragma unroll
  for (int b = 0; b < NB; ++b) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + b * G_BOX + 8 * j + 2 * t;
      if (n >= p.N) continue;
      float2 bv = make_float2(0.f, 0.f), bg = make_float2(0.f, 0.f);
      if (p.bias) {
        bv = bf2(p.bias + n);
        if (GEGLU) bg = bf2(p.bias + n + p.geglu_off);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + row_w + g + 8 * h;
        if (m >= p.M) continue;
        float v0 = acc[b][4 * j + 2 * h] + bv.x, v1 = acc[b][4 * j + 2 * h + 1] + bv.y;
        if constexpr (GEGLU) {
          v0 *= gelu_erf(acc[NB + b][4 * j + 2 * h] + bg.x);
          v1 *= gelu_erf(acc[NB + b][4 * j + 2 * h + 1] + bg.y);
        }
        if (p.res) {
          const float2 r = bf2(p.res + (long long)m * p.ldr + n);
          v0 += r.x;
          v1 += r.y;
        }
        *reinterpret_cast<uint32_t*>(p.out + (long long)m * p.ldo + n) = pack_bf16(v0, v1);
      }
    }
  }
}

// ---- host side

template <int NB, bool GEGLU, bool LN>
cudaError_t launch_sm90(const CUtensorMap& ma, const CUtensorMap& mw, const Sm90Gemm& p,
                        int smem, cudaStream_t stream) {
  if (smem != smem_needed<NB * (GEGLU ? 2 : 1)>(p.stages) || smem > G_MAX_SMEM)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(gemm_sm90_kernel<NB, GEGLU, LN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.N + NB * G_BOX - 1) / (NB * G_BOX), (p.M + G_BM - 1) / G_BM);
  gemm_sm90_kernel<NB, GEGLU, LN><<<grid, G_NT, smem, stream>>>(ma, mw, p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace sdk

// (μ, rstd) of each of the M rows of x [M][ldx] bf16 over its first K
// columns, into stats [M][2] f32
extern "C" int sdk_row_stats(const void* x, long long ldx, float* stats, int M, int K,
                             float eps, void* stream) {
  if (K <= 0 || K % 8 || ldx % 8 || !sdk::sm90::aligned16(x)) return (int)cudaErrorInvalidValue;
  sdk::row_stats_kernel<<<(M + 7) / 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), ldx, reinterpret_cast<float2*>(stats), M, K, eps);
  return (int)cudaGetLastError();
}

// out [M][ldo] = epilogue(prologue(a [M][lda]) · w [K][ldw]), bf16, with
// the tile plan from Python: bn output columns a tile (64 or 128; 128 with
// GEGLU), `stages` ring stages, smem_bytes of dynamic shared memory.
// gamma/beta/stats: the LayerNorm prologue (stats from sdk_row_stats), or
// null. geglu_off > 0: output column n is (acc_n + bias_n)·gelu(acc_{n+off}
// + bias_{n+off}) over w's columns n and n + geglu_off. res: a residual
// [M][ldr] added last, or null. bias, gamma, beta, res in bf16.
extern "C" int sdk_gemm_sm90(const void* a, long long lda, const void* w, long long ldw,
                             const void* bias, const void* gamma, const void* beta,
                             const float* stats, const void* res, long long ldr, void* out,
                             long long ldo, int M, int N, int K, int geglu_off, int bn,
                             int stages, int smem_bytes, void* stream) {
  using namespace sdk;
  const long long lds[] = {lda, ldw, ldo, ldr, (long long)N, (long long)K, geglu_off};
  for (long long v : lds)
    if (v % 8) return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {a, w, out, res};
  for (const void* q : ptrs)
    if (q && !sm90::aligned16(q)) return (int)cudaErrorInvalidValue;
  const void* pairs[] = {bias, gamma, beta};  // read as bf16 pairs
  for (const void* q : pairs)
    if (reinterpret_cast<uintptr_t>(q) % 4) return (int)cudaErrorInvalidValue;
  if (M <= 0 || N <= 0 || K <= 0 || stages < 2 || (gamma != nullptr) != (stats != nullptr) ||
      (gamma != nullptr) != (beta != nullptr) || (geglu_off > 0 && res != nullptr) ||
      (gamma != nullptr && K > G_LN_MAX_K))
    return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mw;
  cudaError_t err = sm90::make_map_2d(&ma, a, K, M, lda, G_BK, G_BM);
  if (err == cudaSuccess) err = sm90::make_map_2d(&mw, w, ldw, K, ldw, G_BOX, G_BK);
  if (err != cudaSuccess) return (int)err;
  Sm90Gemm p{static_cast<const bf16*>(bias), static_cast<const bf16*>(gamma),
             static_cast<const bf16*>(beta), reinterpret_cast<const float2*>(stats),
             static_cast<const bf16*>(res), ldr, static_cast<bf16*>(out), ldo,
             M, N, K, geglu_off, stages};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto with_ln) {
    constexpr bool LN = decltype(with_ln)::value;
    if (geglu_off > 0 && bn == 128) return launch_sm90<2, true, LN>(ma, mw, p, smem_bytes, s);
    if (geglu_off == 0 && bn == 128) return launch_sm90<2, false, LN>(ma, mw, p, smem_bytes, s);
    if (geglu_off == 0 && bn == 64) return launch_sm90<1, false, LN>(ma, mw, p, smem_bytes, s);
    return cudaErrorInvalidValue;
  };
  return (int)(gamma ? launch(std::true_type{}) : launch(std::false_type{}));
}
