// One tiled GEMM with a row prologue and an elementwise epilogue, on WMMA
// (mma.sync). It is the float32 route of four sdtpu Pallas kernels, K4, K6,
// K7 and K10's projections, whose bf16 routes run on Hopper's own
// instructions (K4, K6 and K7 on csrc/conv_sm90.cu, K10 on csrc/gemm_sm90.cu);
// K2's projections and K5 take it only as route "wmma", which the timings
// hold their float32 routes (csrc/gemm_tf32_sm90.cu and
// csrc/attention_tf32_sm90.cu) against, and at widths those have no plan for:
//
//   K2 sdtpu/ops/fused_transformer.py:fused_self_attention — LN(x)·[Wq|Wk|Wv]
//      (LayerNorm prologue) and o·Wo + bo + x (bias + residual epilogue);
//   K4 sdtpu/ops/fused_conv.py:conv1x1_fused — x·W + b with the GroupNorm
//      affine (+SiLU) prologue, optional residual, optional column stats;
//   K5 sdtpu/ops/fused_mlp.py:fused_geglu_mlp — LN(x)·W_proj with the GEGLU
//      epilogue val·gelu_erf(gate), then a·W_lin + b + x;
//   K6 sdtpu/ops/fused_conv.py:conv3x3_fused and
//   K7 sdtpu/ops/fused_conv.py:upsample2x_conv_fused — as an implicit GEMM
//      (the CONV instantiation, below).
//
// What bounds it on the H100: at the UNet's widths (K = 320..5120,
// N = 320..5120, M = 512..8192 rows) the products are compute-bound in bf16
// (about 2·K ops per byte of A). The design keeps what the TPU kernels kept
// out of HBM out of HBM: the normalised rows exist only in shared memory
// (the prologue runs while the A tile is staged), and the GEGLU pair, bias and
// residual are applied to the f32 accumulator before the single store.
// Simple first: 128x128 tiles, 64 (bf16) or 32 (f32) deep in K, eight warps
// of 32x64 WMMA tiles, 16-byte global loads staged through registers so the
// next K tile is in flight while the current one is multiplied (two
// shared-memory buffers, one barrier per K step); wgmma/TMA are later work. For GEGLU a tile's 128
// columns are 64 val columns and the 64 gate columns 4C to their right, so
// the epilogue pairs them inside one tile.
//
// Implicit-GEMM convolution (K6, K7). A is an NHWC map [batch][H][W][C] and
// never exists as a matrix: row m of the product is pixel (i, j) = (m / W,
// m % W), column k = tap * C + c reads channel c of the tap's shifted pixel,
// zero outside the map. The zero padding is applied AFTER the GroupNorm+SiLU
// prologue (an out-of-map element skips it), so silu(bias) never leaks into
// the border, as in the TPU kernel. The weight is the HWIO tensor read as a
// [taps * C, Co] matrix. A second input x2 (K6's implicit channel concat, the
// UNet up path's skip) is a second source pointer: of the C = C1 + C2
// channels of each tap, c < C1 reads x and c >= C1 reads channel c - C1 of
// x2, so the concat never exists and the HWIO weight of the concat is used
// as it is (no split). The prologue's scale/bias are per channel of the
// concat, and the border rule holds for both parts. K6 is 3x3 taps at offset -1. K7 (conv3x3 of the
// nearest-2x upsample) is four output phases (py, px) of 2x2 taps at offset
// (py - 1, px - 1) with phase weights folded from the 3x3 kernel; grid z runs
// over batch x phase and each phase writes its pixels (2i + py, 2j + px) of
// the output, so neither the 4x upsampled map nor a phase stack reaches HBM.
// The TPU kernels staged a row block plus a gathered halo in VMEM; here each
// 16-byte A vector computes its own source pixel, so no halo tensor exists.
//
// Shapes: K, N, the leading dimensions and the GEGLU offset must be
// multiples of 8 and every pointer 16-byte aligned (the wrapper checks);
// M and the ragged ends of N and K are masked.
#include "common.cuh"

namespace sdk {
namespace {

constexpr int BM = 128, BN = 128, NT = 256;
// K tile: 64 for bf16, so that each barrier and each wait for the next
// tile's loads covers twice the products; 32 for f32, whose twice-as-wide
// staging registers would spill at 64
template <typename T> constexpr int kBK = sizeof(T) == 2 ? 64 : 32;
template <typename T> constexpr int kLDA = kBK<T> + 8;  // shared-memory row pitches (elements)
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;

enum Prologue { kNone = 0, kLayerNorm = 1, kAffine = 2, kAffineSilu = 3 };

struct GemmParams {
  const void* a; long long lda, a_bs;     // A [batch][M][K], row pitch lda
  const void* w; long long ldw;           // W [K][ldw]; columns [0, N)
  const float* bias;                      // [ldw] f32 or null
  void* out; long long ldo, o_bs;         // out [batch][M][N]
  const void* res; long long ldr, r_bs;   // residual like out, or null
  const float* pa; const float* pb;       // LN gamma/beta [K]; affine scale/bias [batch][K]
  float* stats;                           // [batch][gridDim.y][2][N] or null
  int M, N, K, prologue, geglu_off;       // geglu_off > 0: gate columns at +geglu_off
  float eps;
  // CONV only: input map H x W with C = lda channels, taps kw x kw,
  // nphase output phases (1, or 4 for the 2x upsample), output scale up;
  // channels [c1, C) come from a2 ([batch][H][W][C - c1], batch stride
  // a2_bs), channels [0, c1) from a (c1 = C without a second input)
  int H, W, kw, nphase, up;
  const void* a2; long long a2_bs; int c1;
};

template <typename T>
size_t smem_bytes() {
  const size_t ab = sizeof(T) * 2 * (BM * kLDA<T> + kBK<T> * LDB);
  const size_t c = sizeof(float) * BM * LDC;
  return ab > c ? ab : c;
}

template <typename T, bool CONV>
__global__ void __launch_bounds__(NT) gemm_kernel(GemmParams p) {
  using MT = Mma<T>;
  constexpr int BK = kBK<T>, LDA = kLDA<T>;
  constexpr int VEC = 16 / sizeof(T);            // elements per 16-byte load
  constexpr int AV = BM * BK / VEC / NT;         // A vectors per thread per tile
  constexpr int BV = BK * BN / VEC / NT;         // B vectors per thread per tile
  extern __shared__ __align__(128) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);            // [2][BM][LDA]
  T* Bs = As + 2 * BM * LDA;                     // [2][BK][LDB]
  float* Cs = reinterpret_cast<float*>(smem);    // [BM][LDC], after the main loop
  __shared__ float row_mean[BM], row_rstd[BM];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;        // warp tile: rows wm*32, cols wn*64
  const int m0 = blockIdx.y * BM;
  const int M = p.M, N = p.N, K = p.K;
  const bool geglu = p.geglu_off > 0;
  const int out_cols = geglu ? BN / 2 : BN;      // output columns per tile
  const int n0 = blockIdx.x * out_cols;
  // CONV: grid z is batch x phase, phase (py, px); C channels per tap
  const int b = CONV ? blockIdx.z / p.nphase : blockIdx.z;
  const int ph = CONV ? blockIdx.z % p.nphase : 0;
  const int py = ph / 2, px = ph % 2;
  const int C = CONV ? (int)p.lda : K;           // what the prologue's scale/bias index

  const T* A = static_cast<const T*>(p.a) + b * p.a_bs;
  const T* A2 = CONV && p.a2 ? static_cast<const T*>(p.a2) + b * p.a2_bs : A;
  const T* W = static_cast<const T*>(p.w) + (long long)ph * K * p.ldw;
  const float* pa = p.pa;
  const float* pb = p.pb;
  if (p.prologue >= kAffine) {
    pa += (long long)b * C;
    pb += (long long)b * C;
  }

  if (p.prologue == kLayerNorm) {
    // two-pass row statistics (mean, then mean((x - mean)^2)), as layer_norm
    for (int r = warp; r < BM; r += NT / 32) {
      const int m = m0 + r;
      float mean = 0.f, rstd = 0.f;
      if (m < M) {
        const T* row = A + (long long)m * p.lda;
        float s = 0.f;
        for (int k = lane; k < K; k += 32) s += to_f32(row[k]);
        mean = warp_sum(s) / K;
        float v = 0.f;
        for (int k = lane; k < K; k += 32) {
          const float d = to_f32(row[k]) - mean;
          v += d * d;
        }
        rstd = rsqrtf(warp_sum(v) / K + p.eps);
      }
      if (lane == 0) {
        row_mean[r] = mean;
        row_rstd[r] = rstd;
      }
    }
    __syncthreads();
  }

  // ---- global -> registers -> shared memory, one K tile at a time
  uint4 a_reg[AV], b_reg[BV];
  int a_ch[AV];  // prologue channel of each A vector, -1 where it stays zero
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  // CONV: each A vector keeps its row's pixel (y0, x0: the top-left tap's
  // source) and its column's tap (ty, tx) and channel c, advanced by BK per
  // K tile, so the loads divide by nothing
  int cv_y0[CONV ? AV : 1], cv_x0[CONV ? AV : 1];
  int cv_ty[CONV ? AV : 1], cv_tx[CONV ? AV : 1], cv_c[CONV ? AV : 1];
  if constexpr (CONV) {
#pragma unroll
    for (int v = 0; v < AV; ++v) {
      const int idx = tid + v * NT, m = m0 + idx / (BK / VEC);
      const int k = idx % (BK / VEC) * VEC, tap = k / C;
      const int i = m / p.W;
      cv_y0[v] = i + py - 1;
      cv_x0[v] = m - i * p.W + px - 1;
      cv_ty[v] = tap / p.kw;
      cv_tx[v] = tap % p.kw;
      cv_c[v] = k - tap * C;
    }
  }

  auto load_tile = [&](int k0) {
#pragma unroll
    for (int v = 0; v < AV; ++v) {
      const int idx = tid + v * NT, r = idx / (BK / VEC), k = k0 + idx % (BK / VEC) * VEC;
      const int m = m0 + r;
      const T* src = nullptr;
      a_ch[v] = -1;
      if constexpr (CONV) {
        const int yy = cv_y0[v] + cv_ty[v], xx = cv_x0[v] + cv_tx[v];
        if (m < M && k < K && yy >= 0 && yy < p.H && xx >= 0 && xx < p.W) {
          const long long pix = (long long)yy * p.W + xx;
          const int c = cv_c[v];  // a vector never straddles c1 (c1 % 8 == 0)
          src = c < p.c1 ? A + pix * p.c1 + c : A2 + pix * (C - p.c1) + (c - p.c1);
          a_ch[v] = c;
        }
        for (cv_c[v] += BK; cv_c[v] >= C; cv_c[v] -= C) {  // the next tile's column
          if (++cv_tx[v] == p.kw) {
            cv_tx[v] = 0;
            ++cv_ty[v];
          }
        }
      } else if (m < M && k < K) {
        src = A + (long long)m * p.lda + k;
        a_ch[v] = k;
      }
      a_reg[v] = src ? *reinterpret_cast<const uint4*>(src) : zero4;
    }
#pragma unroll
    for (int v = 0; v < BV; ++v) {
      const int idx = tid + v * NT, r = idx / (BN / VEC), c = idx % (BN / VEC) * VEC;
      const int k = k0 + r;
      int n, col;
      if (geglu) {
        n = n0 + (c < BN / 2 ? c : c - BN / 2);
        col = c < BN / 2 ? n : n + p.geglu_off;
      } else {
        n = n0 + c;
        col = n;
      }
      b_reg[v] = (k < K && n < N)
                     ? *reinterpret_cast<const uint4*>(W + (long long)k * p.ldw + col)
                     : zero4;
    }
  };

  auto store_tile = [&](int buf) {
    T* as = As + buf * BM * LDA;
    T* bs = Bs + buf * BK * LDB;
#pragma unroll
    for (int v = 0; v < AV; ++v) {
      const int idx = tid + v * NT, r = idx / (BK / VEC), c = idx % (BK / VEC) * VEC;
      const int ch = a_ch[v];
      uint4 raw = a_reg[v];
      if (p.prologue != kNone && ch >= 0) {
        T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          float x = to_f32(e[j]);
          if (p.prologue == kLayerNorm) {
            x = (x - row_mean[r]) * row_rstd[r] * pa[ch + j] + pb[ch + j];
          } else {
            x = x * pa[ch + j] + pb[ch + j];
            if (p.prologue == kAffineSilu) x = __fdividef(x, 1.f + __expf(-x));
          }
          e[j] = from_f32<T>(x);
        }
      }
      *reinterpret_cast<uint4*>(as + r * LDA + c) = raw;
    }
#pragma unroll
    for (int v = 0; v < BV; ++v) {
      const int idx = tid + v * NT, r = idx / (BN / VEC), c = idx % (BN / VEC) * VEC;
      *reinterpret_cast<uint4*>(bs + r * LDB + c) = b_reg[v];
    }
  };

  typename MT::Acc acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = (K + BK - 1) / BK;
  load_tile(0);
  store_tile(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) load_tile((kt + 1) * BK);  // in flight during the products
    const T* as = As + cur * BM * LDA;
    const T* bs = Bs + cur * BK * LDB;
#pragma unroll
    for (int kk = 0; kk < BK; kk += MT::K) {
      typename MT::ARow af[2];
      typename MT::BRow bf[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(af[i], as + (wm * 32 + i * 16) * LDA + kk, LDA);
        MT::prep(af[i]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::load_matrix_sync(bf[j], bs + kk * LDB + wn * 64 + j * 16, LDB);
        MT::prep(bf[j]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
    if (kt + 1 < nk) store_tile(cur ^ 1);
    __syncthreads();
  }

  // ---- epilogue on the f32 accumulator (Cs reuses the tile buffers)
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 64 + j * 16, acc[i][j],
                              LDC, wmma::mem_row_major);
  __syncthreads();

  T* O = static_cast<T*>(p.out) + b * p.o_bs;
  const T* R = p.res ? static_cast<const T*>(p.res) + b * p.r_bs : nullptr;
  const int cvecs = out_cols / VEC;
  for (int idx = tid; idx < BM * cvecs; idx += NT) {
    const int r = idx / cvecs, c = idx % cvecs * VEC;
    const int m = m0 + r, n = n0 + c;
    const bool ok = m < M && n < N;
    long long orow = m;  // output (and residual) row of product row m
    if constexpr (CONV) {
      if (p.up > 1) {
        const int i = m / p.W, j = m - i * p.W;
        orow = (long long)(i * p.up + py) * (p.W * p.up) + j * p.up + px;
      }
    }
    float v[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      v[j] = Cs[r * LDC + c + j];
      if (ok && p.bias) v[j] += p.bias[n + j];
      if (geglu) {
        float g = Cs[r * LDC + BN / 2 + c + j];
        if (ok && p.bias) g += p.bias[n + j + p.geglu_off];
        v[j] *= 0.5f * g * (1.f + erff(g * 0.70710678118654752f));
      }
    }
    if (ok) {
      if (R) {
        uint4 raw = *reinterpret_cast<const uint4*>(R + orow * p.ldr + n);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < VEC; ++j) v[j] += to_f32(e[j]);
      }
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) e[j] = from_f32<T>(v[j]);
      *reinterpret_cast<uint4*>(O + orow * p.ldo + n) = raw;
    }
    if (p.stats) {  // the f32 result, masked elements as 0 (stats never with GEGLU)
#pragma unroll
      for (int j = 0; j < VEC; ++j) Cs[r * LDC + c + j] = ok ? v[j] : 0.f;
    }
  }

  if (p.stats) {
    // per-column (sum, sum^2) of the f32 result over this block's rows;
    // stats is [batch][nphase * row tiles][2][N]
    __syncthreads();
    for (int c = tid; c < out_cols; c += NT) {
      const int n = n0 + c;
      if (n >= N) continue;
      float s1 = 0.f, s2 = 0.f;
      for (int r = 0; r < BM; ++r) {
        const float v = Cs[r * LDC + c];
        s1 += v;
        s2 += v * v;
      }
      float* st = p.stats + ((long long)blockIdx.z * gridDim.y + blockIdx.y) * 2 * N;
      st[n] = s1;
      st[N + n] = s2;
    }
  }
}

template <typename T, bool CONV>
cudaError_t launch(const GemmParams& p, int batch, cudaStream_t stream) {
  const size_t bytes = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<T, CONV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int out_cols = p.geglu_off > 0 ? BN / 2 : BN;
  dim3 grid((p.N + out_cols - 1) / out_cols, (p.M + BM - 1) / BM,
            CONV ? batch * p.nphase : batch);
  gemm_kernel<T, CONV><<<grid, NT, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace sdk

// Row tiles of the stats output: stats is [batch][sdk_gemm_row_tiles(M)][2][N].
extern "C" int sdk_gemm_row_tiles(int M) { return (M + sdk::BM - 1) / sdk::BM; }

extern "C" int sdk_gemm(int dtype, const void* a, long long lda, long long a_bs,
                        const void* w, long long ldw, const float* bias,
                        void* out, long long ldo, long long o_bs,
                        const void* res, long long ldr, long long r_bs,
                        const float* pa, const float* pb, float* stats,
                        int M, int N, int K, int batch, int prologue,
                        int geglu_off, float eps, void* stream) {
  sdk::GemmParams p{a, lda, a_bs, w, ldw, bias, out, ldo, o_bs, res, ldr, r_bs,
                    pa, pb, stats, M, N, K, prologue, geglu_off, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == sdk::kBF16) return (int)sdk::launch<__nv_bfloat16, false>(p, batch, s);
  if (dtype == sdk::kF32) return (int)sdk::launch<float, false>(p, batch, s);
  return (int)cudaErrorInvalidValue;
}

// Convolution of an NHWC map x [batch][H][W][C] with kw x kw taps per output
// phase (kw = 3, nphase = 1, up = 1: conv3x3 with zero padding 1; kw = 2,
// nphase = 4, up = 2: conv3x3 of the nearest-2x upsample, phase weights
// [4][4C][N]). x2 (conv3x3 only; null when C2 = 0) is a second input
// [batch][H][W][C2]: the conv then runs over the implicit channel concat
// [x, x2] with a [3][3][C + C2][N] weight. out and res are
// [batch][H*up][W*up][N]; pa/pb are the prologue's [batch][C + C2] scale and
// bias; stats is [batch][nphase * sdk_gemm_row_tiles(H*W)][2][N].
extern "C" int sdk_conv(int dtype, const void* x, int C, long long x_bs,
                        const void* x2, int C2, const void* w, const float* bias,
                        void* out, long long o_bs, const void* res, const float* pa,
                        const float* pb, float* stats, int H, int W, int N, int batch,
                        int kw, int nphase, int up, int prologue, void* stream) {
  const int Ct = C + C2;
  sdk::GemmParams p{x, Ct, x_bs, w, N, bias, out, N, o_bs, res, N, o_bs,
                    pa, pb, stats, H * W, N, kw * kw * Ct, prologue, 0, 0.f,
                    H, W, kw, nphase, up, x2, (long long)H * W * C2, C};
  const bool conv3x3 = kw == 3 && nphase == 1 && up == 1;
  const bool up2x = kw == 2 && nphase == 4 && up == 2;
  if (!(conv3x3 || up2x) || prologue == sdk::kLayerNorm || C % 8 || C2 % 8 || N % 8 ||
      (C2 > 0) != (x2 != nullptr) || (C2 > 0 && !conv3x3))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == sdk::kBF16) return (int)sdk::launch<__nv_bfloat16, true>(p, batch, s);
  if (dtype == sdk::kF32) return (int)sdk::launch<float, true>(p, batch, s);
  return (int)cudaErrorInvalidValue;
}
