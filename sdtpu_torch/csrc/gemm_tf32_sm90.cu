// K5's and K2's products in float32 on Hopper's warpgroup tensor-core
// instructions, TF32 in and f32 accumulators: the float32 routes of
// - K5, sdtpu/ops/fused_mlp.py:fused_geglu_mlp (its Pallas body `_kernel`
//   :43, called at :87): h = val · gelu_erf(gate), [val | gate] = LN(x) ·
//   W_proj + b_proj, then out = h · W_lin + b_lin + x;
// - K2, sdtpu/ops/fused_transformer.py:fused_self_attention (`_kernel` :42,
//   called at :145): its two projections, LN(x) · [Wq | Wk | Wv] and o · Wo +
//   bo + x, around the core of csrc/attention_tf32_sm90.cu.
// float32 is the default dtype of `sample`, `serve` and `finetune`.
//
// What bounds it on the H100: 2·M·K·N operations against a few M·K bytes,
// compute-bound at the UNet's widths (K, N = 320..5120) at TF32's dense peak
// (495 TFLOP/s, half of bf16's; the f32 bytes twice bf16's): 20.1 GFLOP,
// 0.041 ms, for K5 at S = 1024, C = 640, B = 2.
//
// The structure is csrc/gemm_sm90.cu's: a CTA of two consumer warpgroups and
// a producer warpgroup that hands its registers to them (setmaxnreg, 40
// against 232), of which one thread keeps a ring of `stages` shared-memory
// stages full with TMA loads (128-byte swizzle, boxes 32 floats = 128 bytes
// wide, one 32-deep K step a stage); full and empty mbarriers hand the stages
// over; each consumer loads and issues K step kb + 1 while kb's products run
// (two fragment sets, wgmma.wait_group 1, no branch between an issue and its
// wait); the LayerNorm prologue and the bias, GEGLU and residual epilogues
// run in registers, each output is stored once; no split-K, no atomics.
//
// The operand layout is the design problem: TF32 wgmma reads B (and an A
// read from shared memory) only K-major, and the weights W are [K, N],
// N-major. So B = Wᵀ, a K-major copy of each weight made once per weight
// tensor in Python (sdtpu_torch/ops/fused_mlp.py:kmajor, rounded to TF32
// there), read by TMA as [N][K] boxes; A = the activations [M][K], K-major as
// they stand, loaded from the swizzled stage into registers (ldmatrix on
// 32-bit elements: one instruction a K step, as csrc/gemm_sm90.cu loads
// bf16), normalised (LayerNorm) and rounded to TF32 there. Tiles 128 rows x
// 64·NB columns; a K step is one m64nNk8 product over the tile's val (and
// gate) columns, N = 64, 128 or 256. (The other answer, the swapped product
// Cᵀ = Wᵀ·Xᵀ with W read as it is into register A, was built and timed
// against this one on the H100 and took 1.06-2.10x as long; PERF.md.)
//
// It rounds each output that feeds another TF32 product (K5's h, K2's
// q, k and v) to TF32 as it stores it (round_out), so no operand of the
// next product is truncated by the tensor cores. K2's QKV product writes V
// through its epilogue transposed, per head, as vt [B][H][d][S] with the
// keys of each group of 8 in the order 0, 2, 4, 6, 1, 3, 5, 7 (the order in
// which csrc/attention_tf32_sm90.cu's P fragments hold them), so that the
// core's P·V reads a K-major V with no extra pass.
//
// The plans (tile, stages, shared memory) come from Python
// (sdtpu_torch/ops/fused_mlp.py:tf32_plan) and are checked here.
#include <type_traits>

#include "tf32_sm90.cuh"

namespace sdk {
namespace {

using namespace sm90;

constexpr int T_BK = 32;                    // K columns a stage
constexpr int T_BM = 128;                   // activation rows a CTA
constexpr int T_CONSUMERS = 256, T_NT = T_CONSUMERS + 128;
constexpr uint32_t T_X_BYTES = T_BM * T_BK * 4;   // 16384: the activation box
constexpr uint32_t T_WT_BYTES = 64 * T_BK * 4;    // 8192: 64 rows of Wᵀ
constexpr int T_MAX_SMEM = 232448;
constexpr int T_LN_MAX_K = 2048;  // the LayerNorm's γ and β staged in shared memory

struct Tf32Gemm {
  const float* bias;    // [geglu_off + N] (GEGLU) or [N], or null
  const float* gamma;   // LayerNorm γ, β [K], or null (no prologue)
  const float* beta;
  const float2* stats;  // [M] (μ, rstd) from row_stats_f32_kernel, with gamma
  const float* res;     // [M][ldr] residual, or null
  long long ldr;
  float* out;           // [M][ldo]: columns [0, N), or [0, vt_col) with vt
  long long ldo;
  int M, N, K, geglu_off, stages, round_out;
  // columns n >= vt_col go to vt [M / vt_s][vt_h][vt_d][vt_s] instead
  float* vt;
  int vt_col, vt_s, vt_d, vt_h;
};

template <bool LN>
struct LnSmem {
  float g[T_LN_MAX_K], b[T_LN_MAX_K];
};
template <>
struct LnSmem<false> {
  float g[1], b[1];
};

__device__ __forceinline__ float gelu_erf(float g) {
  return 0.5f * g * (1.f + erff(g * 0.70710678118654752f));
}

// (μ, rstd) of each row of x [M][ldx] f32, two passes as layer_norm: one
// warp a row, 16-byte loads (K % 4 == 0)
__global__ void __launch_bounds__(256) row_stats_f32_kernel(const float* x, long long ldx,
                                                            float2* stats, int M, int K,
                                                            float eps) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= M) return;
  const float4* r = reinterpret_cast<const float4*>(x + (long long)row * ldx);
  const int nv = K / 4;
  float s = 0.f;
  for (int i = lane; i < nv; i += 32) {
    const float4 v = r[i];
    s += (v.x + v.y) + (v.z + v.w);
  }
  const float mean = warp_sum(s) / K;
  float q = 0.f;
  for (int i = lane; i < nv; i += 32) {
    const float4 v = r[i];
    const float a = v.x - mean, b = v.y - mean, c = v.z - mean, d = v.w - mean;
    q += (a * a + b * b) + (c * c + d * d);
  }
  const float rstd = rsqrtf(warp_sum(q) / K + eps);
  if (lane == 0) stats[row] = make_float2(mean, rstd);
}

// one output element (m, n), bias, GEGLU and residual applied: rounded to
// TF32 with round_out; to vt (transposed, keys permuted) where n >= vt_col
__device__ __forceinline__ void store_out(const Tf32Gemm& p, int m, int n, float v) {
  if (p.round_out) v = round_tf32(v);
  if (p.vt != nullptr && n >= p.vt_col) {
    const int nn = n - p.vt_col, h = nn / p.vt_d, c = nn - h * p.vt_d;
    const int bb = m / p.vt_s, s = m - bb * p.vt_s;
    const int pos = (s & ~7) | ((s & 1) << 2) | ((s >> 1) & 3);
    p.vt[(((long long)bb * p.vt_h + h) * p.vt_d + c) * p.vt_s + pos] = v;
  } else {
    p.out[(long long)m * p.ldo + n] = v;
  }
}

// the two consumer warpgroups' γ and β (zero past K) in shared memory, and
// the consumers' barrier after
template <bool LN>
__device__ __forceinline__ void stage_ln(LnSmem<LN>& ln, const Tf32Gemm& p, int nk, int tid) {
  if constexpr (LN) {
    for (int i = tid; i < nk * T_BK; i += T_CONSUMERS) {
      const bool ok = i < p.K;
      ln.g[i] = ok ? p.gamma[i] : 0.f;
      ln.b[i] = ok ? p.beta[i] : 0.f;
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(T_CONSUMERS) : "memory");
  }
}

// ---------------------------------------------------------------- the GEMM
// NB: 64-column groups of output a tile; GEGLU: as many gate groups again;
// LN: the LayerNorm prologue. map_a: x [M][K] in (32, 128) boxes; map_w: Wᵀ
// [N (+ geglu_off + N)][K] in (32, 64) boxes.
template <int NB, bool GEGLU, bool LN>
__global__ void __launch_bounds__(T_NT, 1)
    gemm_tf32_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_w, const Tf32Gemm p) {
  constexpr int WB = NB * (GEGLU ? 2 : 1);
  constexpr uint32_t STAGE = T_X_BYTES + WB * T_WT_BYTES;
  extern __shared__ unsigned char smem_raw[];
  __shared__ LnSmem<LN> ln;
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int stages = p.stages;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * STAGE);
  uint64_t* empty = full + stages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.y * T_BM, n0 = blockIdx.x * NB * 64;
  const int nk = (p.K + T_BK - 1) / T_BK;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], T_CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= T_CONSUMERS / 32) {
    setmaxnreg_dec<40>();
    if (warp == T_CONSUMERS / 32 && lane == 0) {
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % stages;
        if (kb >= stages) mbar_wait(&empty[s], ((kb / stages) - 1) & 1);
        mbar_expect_tx(&full[s], STAGE);
        unsigned char* st = smem + s * STAGE;
        tma_load_2d(st, &map_a, &full[s], kb * T_BK, m0);
#pragma unroll
        for (int b = 0; b < NB; ++b)
          tma_load_2d(st + T_X_BYTES + b * T_WT_BYTES, &map_w, &full[s], kb * T_BK,
                      n0 + b * 64);
        if constexpr (GEGLU) {
#pragma unroll
          for (int b = 0; b < NB; ++b)
            tma_load_2d(st + T_X_BYTES + (NB + b) * T_WT_BYTES, &map_w, &full[s], kb * T_BK,
                        n0 + p.geglu_off + b * 64);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int wg = warp / 4, wl = warp % 4;
  const int g = lane / 4, t = lane % 4;
  const int row_w = wg * 64 + wl * 16;  // this warp's first row in the tile
  float rs[2] = {1.f, 1.f}, nmr[2] = {0.f, 0.f};  // x̂ = x·rs + nmr, rows g, g + 8
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
  }
  stage_ln<LN>(ln, p, nk, tid);

  float acc[WB][32];
#pragma unroll
  for (int b = 0; b < WB; ++b)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[b][i] = 0.f;

  // ldmatrix on 32-bit elements: a b16 8 x 8 matrix is 8 rows of 4 floats,
  // and thread (g, t) receives row g's float t of each of the four. Lane l
  // gives the address of row (l & 7) + 8·((l >> 3) & 1) of this warp's 16,
  // 16-byte chunk 2·ks + (l >> 4) (swizzled as TMA wrote it: chunk ^ row % 8
  // within each 128-byte row), so the four registers are the TF32 A
  // fragment's (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) of K step ks
  const int lrow = row_w + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int lchunk = lane >> 4;

  // K block kb: wait for its stage, load this warp's A fragments, apply the
  // LayerNorm, round to TF32
  auto prepare = [&](uint32_t(&af)[4][4], int kb) {
    const int s = kb % stages;
    mbar_wait(&full[s], (kb / stages) & 1);
    const uint32_t a_base = smem_u32(smem + s * STAGE) + lrow * 128;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int chunk = 2 * ks + lchunk;
      ldmatrix_x4(af[ks], a_base + ((chunk ^ (lrow & 7)) << 4));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = __uint_as_float(af[ks][j]);
        if constexpr (LN) {
          const int k = kb * T_BK + ks * 8 + 4 * (j >> 1) + t;
          x = fmaf(fmaf(x, rs[j & 1], nmr[j & 1]), ln.g[k], ln.b[k]);
        }
        af[ks][j] = to_tf32(x);
      }
    }
  };
  // issue K block kb's products: the stage's WB boxes of Wᵀ lie one after
  // the other (8192 bytes, 64 rows, each), so one descriptor reads them as
  // one [64·WB][32] operand and a K step is one m64n(64·WB)k8 instruction,
  // its accumulators acc[0..WB) in a row
  auto issue = [&](uint32_t(&af)[4][4], int kb) {
    const uint32_t st = smem_u32(smem + (kb % stages) * STAGE + T_X_BYTES);
    fence_regs<WB * 32>(&acc[0][0]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint64_t db = desc_k_major_sw128(st + ks * 32);
      if constexpr (WB == 1) wgmma_tf32_rs_n64(&acc[0][0], af[ks], db);
      else if constexpr (WB == 2) wgmma_tf32_rs_n128(&acc[0][0], af[ks], db);
      else wgmma_tf32_rs_n256(&acc[0][0], af[ks], db);
    }
    wgmma_commit();
    fence_regs<WB * 32>(&acc[0][0]);
  };
  auto retire = [&](uint32_t(&af)[4][4], int kb) {
    fence_regs<16>(&af[0][0]);
    mbar_arrive(&empty[kb % stages]);
  };

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

  // epilogue: for each 64-column group b and j < 8 the thread holds columns
  // 8j + 2t, +1 of rows g (registers 4j, 4j+1) and g + 8 (4j+2, 4j+3)
#pragma unroll
  for (int b = 0; b < NB; ++b) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + b * 64 + 8 * j + 2 * t;
      if (n >= p.N) continue;
      float2 bv = make_float2(0.f, 0.f), bg = make_float2(0.f, 0.f);
      if (p.bias) {
        bv = make_float2(p.bias[n], p.bias[n + 1]);
        if (GEGLU) bg = make_float2(p.bias[n + p.geglu_off], p.bias[n + p.geglu_off + 1]);
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
          const float2 r = *reinterpret_cast<const float2*>(p.res + (long long)m * p.ldr + n);
          v0 += r.x;
          v1 += r.y;
        }
        if (p.vt == nullptr || n < p.vt_col) {
          if (p.round_out) {
            v0 = round_tf32(v0);
            v1 = round_tf32(v1);
          }
          *reinterpret_cast<float2*>(p.out + (long long)m * p.ldo + n) = make_float2(v0, v1);
        } else {
          store_out(p, m, n, v0);
          store_out(p, m, n + 1, v1);
        }
      }
    }
  }
}

// ---- host side

template <bool LN>
constexpr int ln_static_bytes() {
  return (int)sizeof(LnSmem<LN>);
}

template <int NB, bool GEGLU, bool LN>
cudaError_t launch_kmajor(const CUtensorMap& ma, const CUtensorMap& mw, const Tf32Gemm& p,
                          int smem, cudaStream_t stream) {
  constexpr int WB = NB * (GEGLU ? 2 : 1);
  if (smem != 1024 + p.stages * ((int)(T_X_BYTES + WB * T_WT_BYTES) + 16) ||
      smem + ln_static_bytes<LN>() > T_MAX_SMEM)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(gemm_tf32_kernel<NB, GEGLU, LN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.N + NB * 64 - 1) / (NB * 64), (p.M + T_BM - 1) / T_BM);
  gemm_tf32_kernel<NB, GEGLU, LN><<<grid, T_NT, smem, stream>>>(ma, mw, p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace sdk

// (μ, rstd) of each of the M rows of x [M][ldx] f32 over its first K
// columns, into stats [M][2] f32
extern "C" int sdk_row_stats_f32(const void* x, long long ldx, float* stats, int M, int K,
                                 float eps, void* stream) {
  if (K <= 0 || K % 4 || ldx % 4 || !sdk::sm90::aligned16(x)) return (int)cudaErrorInvalidValue;
  sdk::row_stats_f32_kernel<<<(M + 7) / 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), ldx, reinterpret_cast<float2*>(stats), M, K, eps);
  return (int)cudaGetLastError();
}

// out [M][ldo] = epilogue(prologue(a [M][lda]) · W), f32 with TF32 products,
// the plan from Python: w is Wᵀ [rows][ldw] (K-major: row n holds W's column
// n; with GEGLU its rows n + geglu_off the gate's), bn = 64 or 128 output
// columns a tile. gamma/beta/stats: the LayerNorm prologue (stats from
// sdk_row_stats_f32), or null.
// geglu_off > 0: output column n is (acc_n + bias_n)·gelu(acc_{n+off} +
// bias_{n+off}). res: a residual [M][ldr] added last, or null. round_out:
// outputs rounded to TF32. vt: null, or columns n >= vt_col go to vt
// [M / vt_s][vt_h][vt_d][vt_s], element (b, h, c, pos(s)) for row m = b·vt_s
// + s and column vt_col + h·vt_d + c, pos(s) the key order of
// csrc/attention_tf32_sm90.cu (vt_s and vt_d multiples of 8).
extern "C" int sdk_gemm_tf32(const void* a, long long lda, const void* w, long long ldw,
                             const float* bias, const float* gamma, const float* beta,
                             const float* stats, const void* res, long long ldr, void* out,
                             long long ldo, int M, int N, int K, int geglu_off, int round_out,
                             void* vt, int vt_col, int vt_s, int vt_d, int vt_h, int bn,
                             int stages, int smem_bytes, void* stream) {
  using namespace sdk;
  const long long lds[] = {lda, ldw, ldo, ldr, (long long)N, (long long)K, geglu_off};
  for (long long v : lds)
    if (v % 4) return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {a, w, out, res, vt};
  for (const void* q : ptrs)
    if (q && !sm90::aligned16(q)) return (int)cudaErrorInvalidValue;
  const void* f1[] = {bias, gamma, beta};  // read a float at a time
  for (const void* q : f1)
    if (reinterpret_cast<uintptr_t>(q) % 4) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(stats) % 8) return (int)cudaErrorInvalidValue;
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 || stages < 2 ||
      (gamma != nullptr) != (stats != nullptr) || (gamma != nullptr) != (beta != nullptr) ||
      (geglu_off > 0 && (res != nullptr || vt != nullptr)) ||
      (gamma != nullptr && K > T_LN_MAX_K))
    return (int)cudaErrorInvalidValue;
  if (vt != nullptr && (vt_s <= 0 || vt_s % 8 || M % vt_s || vt_d <= 0 || vt_d % 8 ||
                        vt_h <= 0 || vt_col < 0 || vt_col % 8 || N - vt_col != vt_h * vt_d))
    return (int)cudaErrorInvalidValue;
  Tf32Gemm p{bias, gamma, beta, reinterpret_cast<const float2*>(stats),
             static_cast<const float*>(res), ldr, static_cast<float*>(out), ldo,
             M, N, K, geglu_off, stages, round_out, static_cast<float*>(vt), vt_col, vt_s,
             vt_d, vt_h};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap ma, mw;
  cudaError_t err = sm90::make_map_f32_2d(&ma, a, K, M, lda, T_BM);
  if (err != cudaSuccess) return (int)err;
  const bool geglu = geglu_off > 0;
  const long long wrows = geglu ? (long long)geglu_off + N : N;
  err = sm90::make_map_f32_2d(&mw, w, K, wrows, ldw, 64);
  if (err != cudaSuccess) return (int)err;
  auto launch = [&](auto with_ln) {
    constexpr bool LN = decltype(with_ln)::value;
    if (geglu && bn == 128) return launch_kmajor<2, true, LN>(ma, mw, p, smem_bytes, s);
    if (!geglu && bn == 128) return launch_kmajor<2, false, LN>(ma, mw, p, smem_bytes, s);
    if (!geglu && bn == 64) return launch_kmajor<1, false, LN>(ma, mw, p, smem_bytes, s);
    return cudaErrorInvalidValue;
  };
  return (int)(gamma ? launch(std::true_type{}) : launch(std::false_type{}));
}
