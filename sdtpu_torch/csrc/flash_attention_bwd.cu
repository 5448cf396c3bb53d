// K9: flash attention backward, sdtpu/ops/flash_attention.py:flash_attention_bwd_heads
// (its Pallas body _fullk_bwd_kernel).
//
// Given q, k, v, the forward's output o, its row statistics lse2 (K1 writes
// them: lse2 = log2 of the row's sum of exp2(s · d^-1/2 · log2(e))) and the
// output gradient dO, per (batch, head):
//   P  = exp2(q k^T · d^-1/2 · log2(e) - lse2) = softmax(q k^T · d^-1/2)
//   dV = P^T dO
//   dP = dO v^T
//   dS = P ∘ (dP - Δ) · d^-1/2,   Δ = rowsum(dO ∘ o) = rowsum(dP ∘ P)
//   dK = dS^T q,  dQ = dS k
// in f32 accumulation, the results in the input type. P and dS are rounded to
// the input type before their products, as the Pallas kernel rounds them.
//
// What bounds it on the H100: 5 products of 2·Sq·Sk·d flops against a few
// [S, d] tensors — compute-bound (at BH=32, S=4096, d=40 that is 0.22 ms at
// the bf16 peak against 0.04 ms of bytes). The [Sq, Sk] probabilities must
// stay out of HBM. The TPU kernel held one query block against all of K/V
// and summed dK/dV in VMEM over the query blocks in order; blocks run in no
// order here, so the work splits in two kernels with nothing carried between
// blocks, and no atomics (the result is the same on every run):
//   - delta: one warp per row, Δ from o and dO (a pre-pass; Δ from the
//     rounded o differs from the TPU's rowsum(dP ∘ P) by that rounding);
//   - dkdv: one block per (key tile, batch·head) walks the query tiles,
//     recomputing S and dP, and keeps its dK and dV tiles in registers;
//   - dq: one block per (query tile, batch·head) walks the key tiles,
//     recomputing S and dP, and keeps its dQ tile in registers.
// That is 7 products where the bound counts 5 (S and dP twice). Simple
// first: products through WMMA (mma.sync) with every operand read from
// shared memory, tiles loaded by cp.async and waited for before use, no
// overlap of loads and products. Head dims are zero-padded to a multiple of
// 16 in shared memory (d = 40 → 48), never in HBM; the tiles shrink from
// 64 x 64 until they fit 227 KB (d = 160 in f32 takes 32 query rows).
// q, o, dO and dQ share one (batch, head, row) stride triple, k, v, dK and dV
// another, so the heads of [B, S, C] rows come in without a transpose.
#include "common.cuh"

namespace sdk {
namespace {

constexpr int BW_NT = 256, BW_NW = 8;
constexpr int BW_MAX_D = 160;
// accumulator tiles per warp: a 64 x 160 output of 16 x 16 tiles over 8 warps
constexpr int BW_MAXT = 5;
constexpr size_t BW_MAX_SMEM = 227 * 1024;

struct BwdArgs {
  const void* q; const void* k; const void* v; const void* o; const void* dout;
  const float* lse;  // [BH][sq], log2 domain
  float* delta;      // [BH][sq], written by the pre-pass
  void* dq; void* dk; void* dv;
  long long r_sb, r_sh, r_ss;  // element strides of batch, head, row: q, o, dout, dq
  long long c_sb, c_sh, c_ss;  // the same for k, v, dk, dv
  int n_head, sq, sk, d;
  float scale, scale_log2;
};

struct BwdLayout {
  int bq, bk, dpad, ld, lds, ldp;
  size_t q, dout, k, v, s, dps, p, ds, rows, stage, total;
};

template <typename T>
BwdLayout bwd_layout(int d, int bq, int bk) {
  BwdLayout L;
  L.bq = bq;
  L.bk = bk;
  L.dpad = (d + 15) / 16 * 16;
  L.ld = L.dpad + 8;
  L.lds = bk + 4;
  L.ldp = bk + 8;
  size_t o = 0;
  L.q = o;     o = align128(o + sizeof(T) * bq * L.ld);
  L.dout = o;  o = align128(o + sizeof(T) * bq * L.ld);
  L.k = o;     o = align128(o + sizeof(T) * bk * L.ld);
  L.v = o;     o = align128(o + sizeof(T) * bk * L.ld);
  L.s = o;     o = align128(o + sizeof(float) * bq * L.lds);
  L.dps = o;   o = align128(o + sizeof(float) * bq * L.lds);
  L.p = o;     o = align128(o + sizeof(T) * bq * L.ldp);
  L.ds = o;    o = align128(o + sizeof(T) * bq * L.ldp);
  L.rows = o;  o = align128(o + sizeof(float) * 2 * bq);
  L.stage = o; o = align128(o + sizeof(float) * BW_NW * 256);
  L.total = o;
  return L;
}

struct Smem {
  unsigned char* base;
  template <typename P> __device__ P* at(size_t off) const {
    return reinterpret_cast<P*>(base + off);
  }
};

// Rows [r0, r0 + n) of a [rows, d] slice (row stride ss) into dst (pitch
// ld) by cp.async, rows at or past `limit` zero-filled; commits no group.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src, long long ss, int r0,
                                          int n, int limit, int d) {
  constexpr int VEC = 16 / sizeof(T);
  const int vpr = d / VEC;
  for (int i = threadIdx.x; i < n * vpr; i += BW_NT) {
    const int r = i / vpr, c = i % vpr * VEC, row = r0 + r;
    const bool ok = row < limit;
    cp_async16(dst + r * ld + c, ok ? src + (long long)row * ss + c : src, ok);
  }
}

// out [m][n] (f32, pitch lds) = X [m][dpad] · Y [n][dpad]^T, 16 x 16 tiles
// spread over the warps
template <typename T>
__device__ __forceinline__ void scores(float* out, int lds, const T* X, const T* Y, int ld,
                                       int m, int n, int dpad) {
  using MT = Mma<T>;
  const int warp = threadIdx.x / 32;
  const int mt = m / 16, nt = mt * (n / 16);
  for (int t = warp; t < nt; t += BW_NW) {
    const int ti = t % mt, tj = t / mt;
    typename MT::Acc acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < dpad; kk += MT::K) {
      typename MT::ARow af;
      typename MT::BCol bf;
      wmma::load_matrix_sync(af, X + ti * 16 * ld + kk, ld);
      wmma::load_matrix_sync(bf, Y + tj * 16 * ld + kk, ld);
      MT::prep(af);
      MT::prep(bf);
      wmma::mma_sync(acc, af, bf, acc);
    }
    wmma::store_matrix_sync(out + ti * 16 * lds + tj * 16, acc, lds, wmma::mem_row_major);
  }
}

// P and dS of the bq x bk tile from S and dP; entries past sq or sk are 0
template <typename T, bool WRITE_P>
__device__ __forceinline__ void softmax_grad(const BwdArgs& a, const BwdLayout& L,
                                             const float* S, const float* dP, T* P, T* dS,
                                             const float* lse_r, const float* dl_r, int q0,
                                             int k0) {
  for (int i = threadIdx.x; i < L.bq * L.bk; i += BW_NT) {
    const int r = i / L.bk, c = i % L.bk;
    float p = 0.f;
    if (q0 + r < a.sq && k0 + c < a.sk) p = exp2f(S[r * L.lds + c] * a.scale_log2 - lse_r[r]);
    const float ds = p * (dP[r * L.lds + c] - dl_r[r]) * a.scale;
    if (WRITE_P) P[r * L.ldp + c] = from_f32<T>(p);
    dS[r * L.ldp + c] = from_f32<T>(ds);
  }
}

// acc (this warp's tiles of an [m][n] output) += A^T B with A [kdim][m]
// (pitch lda) and B [kdim][n] (pitch ldb), both row-major in shared memory
template <typename T>
__device__ __forceinline__ void acc_tn(typename Mma<T>::Acc* acc, const T* A, int lda,
                                       const T* B, int ldb, int m, int n, int kdim) {
  using MT = Mma<T>;
  const int warp = threadIdx.x / 32;
  const int mt = m / 16, nt = mt * (n / 16);
#pragma unroll
  for (int i = 0; i < BW_MAXT; ++i) {
    const int t = warp + i * BW_NW;
    if (t < nt) {
      const int ti = t % mt, tj = t / mt;
      for (int kk = 0; kk < kdim; kk += MT::K) {
        typename MT::ACol af;
        typename MT::BRow bf;
        wmma::load_matrix_sync(af, A + kk * lda + ti * 16, lda);
        wmma::load_matrix_sync(bf, B + kk * ldb + tj * 16, ldb);
        MT::prep(af);
        MT::prep(bf);
        wmma::mma_sync(acc[i], af, bf, acc[i]);
      }
    }
  }
}

// acc (this warp's tiles of an [m][n] output) += A B with A [m][kdim] (pitch
// lda) and B [kdim][n] (pitch ldb)
template <typename T>
__device__ __forceinline__ void acc_nn(typename Mma<T>::Acc* acc, const T* A, int lda,
                                       const T* B, int ldb, int m, int n, int kdim) {
  using MT = Mma<T>;
  const int warp = threadIdx.x / 32;
  const int mt = m / 16, nt = mt * (n / 16);
#pragma unroll
  for (int i = 0; i < BW_MAXT; ++i) {
    const int t = warp + i * BW_NW;
    if (t < nt) {
      const int ti = t % mt, tj = t / mt;
      for (int kk = 0; kk < kdim; kk += MT::K) {
        typename MT::ARow af;
        typename MT::BRow bf;
        wmma::load_matrix_sync(af, A + ti * 16 * lda + kk, lda);
        wmma::load_matrix_sync(bf, B + kk * ldb + tj * 16, ldb);
        MT::prep(af);
        MT::prep(bf);
        wmma::mma_sync(acc[i], af, bf, acc[i]);
      }
    }
  }
}

// this warp's accumulator tiles of an [m][n] output -> rows r0.. of out (row
// stride ss), through a 16 x 16 f32 staging tile per warp; rows at or past
// `limit` and columns at or past d are dropped
template <typename T>
__device__ __forceinline__ void store_acc(typename Mma<T>::Acc* acc, float* stage, T* out,
                                          long long ss, int r0, int limit, int m, int n,
                                          int d) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* st = stage + warp * 256;
  const int mt = m / 16, nt = mt * (n / 16);
#pragma unroll
  for (int i = 0; i < BW_MAXT; ++i) {
    const int t = warp + i * BW_NW;
    if (t < nt) {
      const int ti = t % mt, tj = t / mt;
      wmma::store_matrix_sync(st, acc[i], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = ti * 16 + e / 16, c = tj * 16 + e % 16, row = r0 + r;
        if (row < limit && c < d) out[(long long)row * ss + c] = from_f32<T>(st[e]);
      }
      __syncwarp();
    }
  }
}

__device__ __forceinline__ void zero_smem(unsigned char* smem, size_t total) {
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  for (size_t i = threadIdx.x; i < total / 16; i += BW_NT)
    reinterpret_cast<uint4*>(smem)[i] = zero4;
}

// Δ = rowsum(dO ∘ o) in f32, one warp per row
template <typename T>
__global__ void __launch_bounds__(BW_NT) bwd_delta_kernel(BwdArgs a) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * BW_NW + warp, bh = blockIdx.y;
  if (row >= a.sq) return;
  const int bb = bh / a.n_head, hh = bh % a.n_head;
  const long long off = bb * a.r_sb + hh * a.r_sh + (long long)row * a.r_ss;
  const T* O = static_cast<const T*>(a.o) + off;
  const T* dO = static_cast<const T*>(a.dout) + off;
  float s = 0.f;
  for (int c = lane; c < a.d; c += 32) s += to_f32(O[c]) * to_f32(dO[c]);
  s = warp_sum(s);
  if (lane == 0) a.delta[(long long)bh * a.sq + row] = s;
}

// dK and dV of one key tile: walks the query tiles
template <typename T>
__global__ void __launch_bounds__(BW_NT) bwd_dkdv_kernel(BwdArgs a, BwdLayout L) {
  using Acc = typename Mma<T>::Acc;
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem sm{smem};
  T* Qs = sm.at<T>(L.q);
  T* dOs = sm.at<T>(L.dout);
  T* Ks = sm.at<T>(L.k);
  T* Vs = sm.at<T>(L.v);
  float* Ss = sm.at<float>(L.s);
  float* dPs = sm.at<float>(L.dps);
  T* Ps = sm.at<T>(L.p);
  T* dSs = sm.at<T>(L.ds);
  float* lse_r = sm.at<float>(L.rows);
  float* dl_r = lse_r + L.bq;
  float* stage = sm.at<float>(L.stage);

  const int tid = threadIdx.x;
  const int bh = blockIdx.y, bb = bh / a.n_head, hh = bh % a.n_head;
  const int k0 = blockIdx.x * L.bk;
  const long long roff = bb * a.r_sb + hh * a.r_sh, coff = bb * a.c_sb + hh * a.c_sh;
  const T* Q = static_cast<const T*>(a.q) + roff;
  const T* dO = static_cast<const T*>(a.dout) + roff;
  const T* K = static_cast<const T*>(a.k) + coff;
  const T* V = static_cast<const T*>(a.v) + coff;
  const float* lse = a.lse + (long long)bh * a.sq;
  const float* delta = a.delta + (long long)bh * a.sq;

  // zero once: the padded columns d..dpad stay zero, the loads write only
  // columns < d
  zero_smem(smem, L.total);
  __syncthreads();
  load_rows(Ks, L.ld, K, a.c_ss, k0, L.bk, a.sk, a.d);
  load_rows(Vs, L.ld, V, a.c_ss, k0, L.bk, a.sk, a.d);
  cp_async_commit();

  Acc dk[BW_MAXT], dv[BW_MAXT];
#pragma unroll
  for (int i = 0; i < BW_MAXT; ++i) {
    wmma::fill_fragment(dk[i], 0.f);
    wmma::fill_fragment(dv[i], 0.f);
  }
  for (int q0 = 0; q0 < a.sq; q0 += L.bq) {
    load_rows(Qs, L.ld, Q, a.r_ss, q0, L.bq, a.sq, a.d);
    load_rows(dOs, L.ld, dO, a.r_ss, q0, L.bq, a.sq, a.d);
    cp_async_commit();
    for (int r = tid; r < L.bq; r += BW_NT) {
      const bool ok = q0 + r < a.sq;
      lse_r[r] = ok ? lse[q0 + r] : 0.f;
      dl_r[r] = ok ? delta[q0 + r] : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();
    scores<T>(Ss, L.lds, Qs, Ks, L.ld, L.bq, L.bk, L.dpad);
    scores<T>(dPs, L.lds, dOs, Vs, L.ld, L.bq, L.bk, L.dpad);
    __syncthreads();
    softmax_grad<T, true>(a, L, Ss, dPs, Ps, dSs, lse_r, dl_r, q0, k0);
    __syncthreads();
    acc_tn<T>(dv, Ps, L.ldp, dOs, L.ld, L.bk, L.dpad, L.bq);
    acc_tn<T>(dk, dSs, L.ldp, Qs, L.ld, L.bk, L.dpad, L.bq);
    __syncthreads();  // Q, dO, P and dS are free for the next tile
  }
  store_acc<T>(dk, stage, static_cast<T*>(a.dk) + coff, a.c_ss, k0, a.sk, L.bk, L.dpad, a.d);
  store_acc<T>(dv, stage, static_cast<T*>(a.dv) + coff, a.c_ss, k0, a.sk, L.bk, L.dpad, a.d);
}

// dQ of one query tile: walks the key tiles
template <typename T>
__global__ void __launch_bounds__(BW_NT) bwd_dq_kernel(BwdArgs a, BwdLayout L) {
  using Acc = typename Mma<T>::Acc;
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem sm{smem};
  T* Qs = sm.at<T>(L.q);
  T* dOs = sm.at<T>(L.dout);
  T* Ks = sm.at<T>(L.k);
  T* Vs = sm.at<T>(L.v);
  float* Ss = sm.at<float>(L.s);
  float* dPs = sm.at<float>(L.dps);
  T* dSs = sm.at<T>(L.ds);
  float* lse_r = sm.at<float>(L.rows);
  float* dl_r = lse_r + L.bq;
  float* stage = sm.at<float>(L.stage);

  const int tid = threadIdx.x;
  const int bh = blockIdx.y, bb = bh / a.n_head, hh = bh % a.n_head;
  const int q0 = blockIdx.x * L.bq;
  const long long roff = bb * a.r_sb + hh * a.r_sh, coff = bb * a.c_sb + hh * a.c_sh;
  const T* Q = static_cast<const T*>(a.q) + roff;
  const T* dO = static_cast<const T*>(a.dout) + roff;
  const T* K = static_cast<const T*>(a.k) + coff;
  const T* V = static_cast<const T*>(a.v) + coff;

  zero_smem(smem, L.total);
  __syncthreads();
  load_rows(Qs, L.ld, Q, a.r_ss, q0, L.bq, a.sq, a.d);
  load_rows(dOs, L.ld, dO, a.r_ss, q0, L.bq, a.sq, a.d);
  cp_async_commit();
  for (int r = tid; r < L.bq; r += BW_NT) {
    const bool ok = q0 + r < a.sq;
    lse_r[r] = ok ? a.lse[(long long)bh * a.sq + q0 + r] : 0.f;
    dl_r[r] = ok ? a.delta[(long long)bh * a.sq + q0 + r] : 0.f;
  }

  Acc dq[BW_MAXT];
#pragma unroll
  for (int i = 0; i < BW_MAXT; ++i) wmma::fill_fragment(dq[i], 0.f);
  for (int k0 = 0; k0 < a.sk; k0 += L.bk) {
    load_rows(Ks, L.ld, K, a.c_ss, k0, L.bk, a.sk, a.d);
    load_rows(Vs, L.ld, V, a.c_ss, k0, L.bk, a.sk, a.d);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    scores<T>(Ss, L.lds, Qs, Ks, L.ld, L.bq, L.bk, L.dpad);
    scores<T>(dPs, L.lds, dOs, Vs, L.ld, L.bq, L.bk, L.dpad);
    __syncthreads();
    softmax_grad<T, false>(a, L, Ss, dPs, nullptr, dSs, lse_r, dl_r, q0, k0);
    __syncthreads();
    acc_nn<T>(dq, dSs, L.ldp, Ks, L.ld, L.bq, L.dpad, L.bk);
    __syncthreads();  // K, V and dS are free for the next tile
  }
  store_acc<T>(dq, stage, static_cast<T*>(a.dq) + roff, a.r_ss, q0, a.sq, L.bq, L.dpad, a.d);
}

template <typename T>
cudaError_t launch_bwd(const BwdArgs& a, int BH, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const long long strides[] = {a.r_sb, a.r_sh, a.r_ss, a.c_sb, a.c_sh, a.c_ss};
  for (long long s : strides)
    if (s % VEC) return cudaErrorInvalidValue;
  if (a.d <= 0 || a.d % VEC || a.d > BW_MAX_D || a.sq <= 0 || a.sk <= 0 || a.n_head <= 0 ||
      BH <= 0 || BH % a.n_head)
    return cudaErrorInvalidValue;
  // (query rows, key rows) per tile, largest first; every choice keeps an
  // output of at most 64 x 160 at BW_MAXT tiles a warp
  const int tiles[][2] = {{64, 64}, {32, 64}, {32, 32}};
  BwdLayout L{};
  bool fits = false;
  for (const auto& t : tiles) {
    L = bwd_layout<T>(a.d, t[0], t[1]);
    if (L.total <= BW_MAX_SMEM) {
      fits = true;
      break;
    }
  }
  if (!fits) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkdv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L.total);
  if (err != cudaSuccess) return err;
  bwd_delta_kernel<T><<<dim3((a.sq + BW_NW - 1) / BW_NW, BH), BW_NT, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dkdv_kernel<T><<<dim3((a.sk + L.bk - 1) / L.bk, BH), BW_NT, L.total, stream>>>(a, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dq_kernel<T><<<dim3((a.sq + L.bq - 1) / L.bq, BH), BW_NT, L.total, stream>>>(a, L);
  return cudaGetLastError();
}

}  // namespace
}  // namespace sdk

// q, o, dout, dq: element (b, h, row, col) at ptr + b*r_sb + h*r_sh + row*r_ss
// + col for batch element b = bh / n_head, head h = bh % n_head, bh < BH, row
// < sq; k, v, dk, dv the same with the c_* strides and row < sk; col < d. lse:
// [BH][sq] f32 from the forward (K1's lse output); delta: [BH][sq] f32
// scratch. scale = d^-1/2.
extern "C" int sdk_flash_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                       const void* o, const void* dout, const float* lse,
                                       float* delta, void* dq, void* dk, void* dv,
                                       long long r_sb, long long r_sh, long long r_ss,
                                       long long c_sb, long long c_sh, long long c_ss, int BH,
                                       int n_head, int sq, int sk, int d, float scale,
                                       void* stream) {
  sdk::BwdArgs a{q, k, v, o, dout, lse, delta, dq, dk, dv, r_sb, r_sh, r_ss, c_sb, c_sh, c_ss,
                 n_head, sq, sk, d, scale, scale * 1.4426950408889634f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == sdk::kBF16) return (int)sdk::launch_bwd<__nv_bfloat16>(a, BH, s);
  if (dtype == sdk::kF32) return (int)sdk::launch_bwd<float>(a, BH, s);
  return (int)cudaErrorInvalidValue;
}
