// K9 in bf16: flash attention backward on Hopper's warpgroup tensor-core
// instructions, sdtpu/ops/flash_attention.py:flash_attention_bwd_heads (its
// Pallas body `_fullk_bwd_kernel` :531, called at :613).
//
// The function is flash_attention_bwd.cu's (which keeps f32 and the head
// widths this file has no instance for): per (batch, head), from q, k, v,
// the forward's output o, its log2-domain row statistics lse2 and dO,
//   P  = exp2(q k^T · d^-1/2 · log2(e) − lse2),   dV = P^T dO,
//   dP = dO v^T,   dS = P ∘ (dP − Δ) · d^-1/2,   Δ = rowsum(dO ∘ o),
//   dK = dS^T q,   dQ = dS k,
// f32 accumulation, P and dS rounded to bf16 before their products, as the
// Pallas body rounds them.
//
// What bounds it on the H100: 5 products of 2·Sq·Sk·d operations against a
// few [S, d] tensors, compute-bound (0.217 ms at the bf16 peak at BH = 32,
// S = 4096, d = 40, against 0.04 ms of bytes). At d = 40 every product is
// tiny, so what held the WMMA kernel back was the traffic around them
// (scores through f32 shared memory, four block barriers a tile, loads not
// overlapped). Here, with no atomics and the same two-kernel split (every
// run gives the same bits):
//
// - dkdv: a CTA holds 128 keys (K and V resident in shared memory), one
//   consumer warpgroup per 64 keys, and walks the query tiles. It computes
//   S^T = K·Q^T and dP^T = V·dO^T with wgmma (both operands from shared
//   memory) into registers, so the key is the accumulator's row; P^T and
//   dS^T are formed in those registers (lse2 and Δ of the tile's queries
//   from the ring) and packed to bf16 in place as the A operand of the
//   register-sourced wgmma dV += P^T·dO and dK += dS^T·Q, whose B (dO, Q) is
//   read N-major from the same tiles: P and dS never touch shared memory.
// - dq: a CTA holds 128 queries (Q and dO resident) and walks the key tiles:
//   S = Q·K^T and dP = dO·V^T into registers, dS formed there (the rows'
//   lse2 and Δ held in registers for the whole walk) and fed as the A
//   operand of dQ += dS·K.
// - The walked tiles (Q, dO, lse2, Δ; or K, V) stream through a ring of
//   `stages` shared-memory stages filled by cp.async: tile j + stages − 1 is
//   in flight while tile j is multiplied, and one block barrier a tile
//   hands the stages over (cp.async rather than TMA: the zero padding of
//   each head's d..dpad columns comes with the copy, src-size 0, and never
//   reads the next head's columns).
// - Tiles are stored as unswizzled 8 x 16-byte core matrices, rows padded
//   to dpad = 16·ceil(d/16) with zeros (d = 40 -> 48). Rows past Sq or Sk
//   load as zeros, and lse2 and Δ as zeros: their terms vanish in every
//   product that reaches a stored result.
//
// The (dpad, tile, stages, shared memory) plan comes from Python
// (sdtpu_torch/ops/flash_attention.py:bwd_sm90_plan) and is checked here.
// q, o, dO and dQ share one (batch, head, row) stride triple, k, v, dK and
// dV another, so the heads of [B, S, C] rows need no transpose.
#include "sm90.cuh"

namespace sdk {
namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int F_ROWS = 128, F_NT = 256, F_MAX_SMEM = 232448;

struct Sm90BwdArgs {
  const bf16* q; const bf16* k; const bf16* v; const bf16* o; const bf16* dout;
  const float* lse;  // [BH][sq], log2 domain
  float* delta;      // [BH][sq], written by the pre-pass
  bf16* dq; bf16* dk; bf16* dv;
  long long r_sb, r_sh, r_ss;  // q, o, dout, dq
  long long c_sb, c_sh, c_ss;  // k, v, dk, dv
  int n_head, sq, sk, d, stages;
  float scale, scale_log2;
};

template <int DP>
__host__ __device__ constexpr int tile_bytes(int rows) {
  return rows * DP * 2;
}
template <int DP, int BT>
__host__ __device__ constexpr int dkdv_stage() {
  return 2 * tile_bytes<DP>(BT) + 2 * BT * 4;
}
template <int DP, int BT>
__host__ __device__ constexpr int dkdv_smem(int stages) {
  return 2 * tile_bytes<DP>(F_ROWS) + stages * dkdv_stage<DP, BT>();
}
template <int DP, int BT>
__host__ __device__ constexpr int dq_smem(int stages) {
  return 2 * tile_bytes<DP>(F_ROWS) + stages * 2 * tile_bytes<DP>(BT);
}

__device__ __forceinline__ void cp_async4_s(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0));
}

// n floats from src[r0..] (zeros at or past limit)
__device__ __forceinline__ void load_rows_f32(uint32_t dst, const float* src, int r0, int n,
                                              int limit) {
  for (int i = threadIdx.x; i < n; i += F_NT) {
    const bool ok = r0 + i < limit;
    cp_async4_s(dst + i * 4, ok ? src + r0 + i : src, ok);
  }
}

// acc [BT / 2] += A·B^T over a DP-deep K, A rows of a resident tile
// (K-major), B a walked tile (K-major), m64nBT
template <int DP, int BT>
__device__ __forceinline__ void scores(float* acc, uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint64_t da = desc_k_major(a + kk * 256, DP * 16);
    const uint64_t db = desc_k_major(b + kk * 256, DP * 16);
    if constexpr (BT == 64) wgmma_ss_n64(acc, da, db);
    else wgmma_ss_n32(acc, da, db);
  }
}

// acc [DP / 2] += A (registers, BT / 16 K steps of 4) · B, B a [BT][DP]
// tile read N-major
template <int DP, int BT>
__device__ __forceinline__ void acc_rs(float* acc, uint32_t (*af)[4], uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    const uint64_t db = desc_n_major(b + kk * 2 * DP * 16, DP * 16);
    if constexpr (DP == 48) wgmma_rs_n48(acc, af[kk], db);
    else if constexpr (DP == 64) wgmma_rs_n64(acc, af[kk], db);
    else if constexpr (DP == 80) wgmma_rs_n80(acc, af[kk], db);
    else wgmma_rs_n160(acc, af[kk], db);
  }
}

// the accumulator [64 rows][DP] of this warpgroup -> rows r0.. of out (row
// stride ss), rows at or past limit and columns at or past d dropped
template <int DP>
__device__ __forceinline__ void store_acc(const float* acc, bf16* out, long long ss, int r0,
                                          int limit, int d) {
  const int lane = threadIdx.x % 32, wl = (threadIdx.x / 32) % 4;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int c = 8 * j + 2 * t;
    if (c >= d) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + wl * 16 + g + 8 * h;
      if (row < limit)
        *reinterpret_cast<uint32_t*>(out + (long long)row * ss + c) =
            pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// Δ = rowsum(dO ∘ o) in f32, one warp a row, 16-byte loads
__global__ void __launch_bounds__(F_NT) sm90_delta_kernel(Sm90BwdArgs a) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * (F_NT / 32) + warp, bh = blockIdx.y;
  if (row >= a.sq) return;
  const int bb = bh / a.n_head, hh = bh % a.n_head;
  const long long off = bb * a.r_sb + hh * a.r_sh + (long long)row * a.r_ss;
  const uint4* O = reinterpret_cast<const uint4*>(a.o + off);
  const uint4* dO = reinterpret_cast<const uint4*>(a.dout + off);
  float s = 0.f;
  for (int c = lane; c < a.d / 8; c += 32) {
    uint4 x = O[c], y = dO[c];
    const bf16* xe = reinterpret_cast<const bf16*>(&x);
    const bf16* ye = reinterpret_cast<const bf16*>(&y);
#pragma unroll
    for (int j = 0; j < 8; ++j) s += __bfloat162float(xe[j]) * __bfloat162float(ye[j]);
  }
  s = warp_sum(s);
  if (lane == 0) a.delta[(long long)bh * a.sq + row] = s;
}

// dK and dV of 128 keys: walks the query tiles of BT rows
template <int DP, int BT>
__global__ void __launch_bounds__(F_NT, 1) sm90_dkdv_kernel(Sm90BwdArgs a) {
  constexpr int STAGE = dkdv_stage<DP, BT>();
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_k = smem_u32(smem), s_v = s_k + tile_bytes<DP>(F_ROWS);
  const uint32_t s_ring = s_v + tile_bytes<DP>(F_ROWS);
  const unsigned char* ring = smem + 2 * tile_bytes<DP>(F_ROWS);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4, t = lane % 4;
  const int bh = blockIdx.y, bb = bh / a.n_head, hh = bh % a.n_head;
  const int k0 = blockIdx.x * F_ROWS;
  const long long roff = bb * a.r_sb + hh * a.r_sh, coff = bb * a.c_sb + hh * a.c_sh;
  const bf16* Q = a.q + roff;
  const bf16* dO = a.dout + roff;
  const float* lse = a.lse + (long long)bh * a.sq;
  const float* delta = a.delta + (long long)bh * a.sq;
  const int nq = (a.sq + BT - 1) / BT, stages = a.stages;

  auto load_stage = [&](int j) {
    const uint32_t st = s_ring + (j % stages) * STAGE;
    const int q0 = j * BT;
    load_tile<DP, F_NT>(st, Q, a.r_ss, q0, BT, a.sq, a.d);
    load_tile<DP, F_NT>(st + tile_bytes<DP>(BT), dO, a.r_ss, q0, BT, a.sq, a.d);
    load_rows_f32(st + 2 * tile_bytes<DP>(BT), lse, q0, BT, a.sq);
    load_rows_f32(st + 2 * tile_bytes<DP>(BT) + BT * 4, delta, q0, BT, a.sq);
  };

  load_tile<DP, F_NT>(s_k, a.k + coff, a.c_ss, k0, F_ROWS, a.sk, a.d);
  load_tile<DP, F_NT>(s_v, a.v + coff, a.c_ss, k0, F_ROWS, a.sk, a.d);
  for (int j = 0; j < stages - 1; ++j) {
    if (j < nq) load_stage(j);
    cp_async_commit();  // one group a stage, empty past the last tile
  }

  float dk[DP / 2], dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
  // this warpgroup's 64 keys: its A rows of K and V
  const uint32_t a_k = s_k + wg * 8 * DP * 16, a_v = s_v + wg * 8 * DP * 16;

  for (int j = 0; j < nq; ++j) {
    cp_async_wait_dyn(stages - 2);
    fence_proxy_async();
    __syncthreads();  // tile j has landed everywhere; tile j - 1 is free
    if (j + stages - 1 < nq) load_stage(j + stages - 1);
    cp_async_commit();

    const uint32_t st = s_ring + (j % stages) * STAGE;
    const uint32_t s_q = st, s_do = st + tile_bytes<DP>(BT);
    const float* lse_t =
        reinterpret_cast<const float*>(ring + (j % stages) * STAGE + 2 * tile_bytes<DP>(BT));
    const float* dl_t = lse_t + BT;

    float s[BT / 2], dp[BT / 2];
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) s[i] = dp[i] = 0.f;
    fence_regs<BT / 2>(s);
    fence_regs<BT / 2>(dp);
    wgmma_fence();
    scores<DP, BT>(s, a_k, s_q);      // S^T: keys x queries
    scores<DP, BT>(dp, a_v, s_do);    // dP^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<BT / 2>(s);
    fence_regs<BT / 2>(dp);

    // P^T and dS^T in registers: register 4i + e holds (key row g or g + 8,
    // query column 8i + 2t + e % 2); K step kk of the next products takes
    // registers 8kk .. 8kk + 7 as its four bf16 pairs
    uint32_t pf[BT / 16][4], df[BT / 16][4];
#pragma unroll
    for (int i = 0; i < BT / 8; ++i) {
      const int c = 8 * i + 2 * t;
      const float l0 = lse_t[c], l1 = lse_t[c + 1], d0 = dl_t[c], d1 = dl_t[c + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p0 = exp2f(s[4 * i + 2 * h] * a.scale_log2 - l0);
        const float p1 = exp2f(s[4 * i + 2 * h + 1] * a.scale_log2 - l1);
        const float g0 = p0 * (dp[4 * i + 2 * h] - d0) * a.scale;
        const float g1 = p1 * (dp[4 * i + 2 * h + 1] - d1) * a.scale;
        pf[i / 2][(i % 2) * 2 + h] = pack_bf16(p0, p1);
        df[i / 2][(i % 2) * 2 + h] = pack_bf16(g0, g1);
      }
    }
    fence_regs<DP / 2>(dv);
    fence_regs<DP / 2>(dk);
    wgmma_fence();
    acc_rs<DP, BT>(dv, pf, s_do);  // dV += P^T dO
    acc_rs<DP, BT>(dk, df, s_q);   // dK += dS^T Q
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<DP / 2>(dv);
    fence_regs<DP / 2>(dk);
    // the fragments stay allocated until the products that read them
    // asynchronously are done
    fence_regs<BT / 4>(&pf[0][0]);
    fence_regs<BT / 4>(&df[0][0]);
  }
  cp_async_wait<0>();
  store_acc<DP>(dk, a.dk + coff, a.c_ss, k0 + wg * 64, a.sk, a.d);
  store_acc<DP>(dv, a.dv + coff, a.c_ss, k0 + wg * 64, a.sk, a.d);
}

// dQ of 128 queries: walks the key tiles of BT rows
template <int DP, int BT>
__global__ void __launch_bounds__(F_NT, 1) sm90_dq_kernel(Sm90BwdArgs a) {
  constexpr int STAGE = 2 * tile_bytes<DP>(BT);
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_q = smem_u32(smem), s_do = s_q + tile_bytes<DP>(F_ROWS);
  const uint32_t s_ring = s_do + tile_bytes<DP>(F_ROWS);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4, wl = warp % 4, g = lane / 4;
  const int bh = blockIdx.y, bb = bh / a.n_head, hh = bh % a.n_head;
  const int q0 = blockIdx.x * F_ROWS;
  const long long roff = bb * a.r_sb + hh * a.r_sh, coff = bb * a.c_sb + hh * a.c_sh;
  const bf16* K = a.k + coff;
  const bf16* V = a.v + coff;
  const int nk = (a.sk + BT - 1) / BT, stages = a.stages;

  auto load_stage = [&](int j) {
    const uint32_t st = s_ring + (j % stages) * STAGE;
    load_tile<DP, F_NT>(st, K, a.c_ss, j * BT, BT, a.sk, a.d);
    load_tile<DP, F_NT>(st + tile_bytes<DP>(BT), V, a.c_ss, j * BT, BT, a.sk, a.d);
  };

  load_tile<DP, F_NT>(s_q, a.q + roff, a.r_ss, q0, F_ROWS, a.sq, a.d);
  load_tile<DP, F_NT>(s_do, a.dout + roff, a.r_ss, q0, F_ROWS, a.sq, a.d);
  for (int j = 0; j < stages - 1; ++j) {
    if (j < nk) load_stage(j);
    cp_async_commit();
  }
  // the rows' lse2 and Δ (rows g and g + 8 of this warp), for the whole walk
  float lr[2], dr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wg * 64 + wl * 16 + g + 8 * h;
    const bool ok = row < a.sq;
    lr[h] = ok ? a.lse[(long long)bh * a.sq + row] : 0.f;
    dr[h] = ok ? a.delta[(long long)bh * a.sq + row] : 0.f;
  }

  float dq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
  const uint32_t a_q = s_q + wg * 8 * DP * 16, a_do = s_do + wg * 8 * DP * 16;

  for (int j = 0; j < nk; ++j) {
    cp_async_wait_dyn(stages - 2);
    fence_proxy_async();
    __syncthreads();
    if (j + stages - 1 < nk) load_stage(j + stages - 1);
    cp_async_commit();

    const uint32_t st = s_ring + (j % stages) * STAGE;
    const uint32_t s_k = st, s_v = st + tile_bytes<DP>(BT);
    float s[BT / 2], dp[BT / 2];
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) s[i] = dp[i] = 0.f;
    fence_regs<BT / 2>(s);
    fence_regs<BT / 2>(dp);
    wgmma_fence();
    scores<DP, BT>(s, a_q, s_k);    // S: queries x keys
    scores<DP, BT>(dp, a_do, s_v);  // dP
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<BT / 2>(s);
    fence_regs<BT / 2>(dp);

    uint32_t df[BT / 16][4];
#pragma unroll
    for (int i = 0; i < BT / 8; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p0 = exp2f(s[4 * i + 2 * h] * a.scale_log2 - lr[h]);
        const float p1 = exp2f(s[4 * i + 2 * h + 1] * a.scale_log2 - lr[h]);
        df[i / 2][(i % 2) * 2 + h] = pack_bf16(p0 * (dp[4 * i + 2 * h] - dr[h]) * a.scale,
                                               p1 * (dp[4 * i + 2 * h + 1] - dr[h]) * a.scale);
      }
    }
    fence_regs<DP / 2>(dq);
    wgmma_fence();
    acc_rs<DP, BT>(dq, df, s_k);  // dQ += dS K
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<DP / 2>(dq);
    fence_regs<BT / 4>(&df[0][0]);
  }
  cp_async_wait<0>();
  store_acc<DP>(dq, a.dq + roff, a.r_ss, q0 + wg * 64, a.sq, a.d);
}

template <int DP, int BT>
cudaError_t launch_sm90_bwd(const Sm90BwdArgs& a, int BH, int smem_dkdv, int smem_dq,
                            cudaStream_t stream) {
  if (smem_dkdv != dkdv_smem<DP, BT>(a.stages) || smem_dq != dq_smem<DP, BT>(a.stages) ||
      smem_dkdv > F_MAX_SMEM || smem_dq > F_MAX_SMEM)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(sm90_dkdv_kernel<DP, BT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dkdv);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(sm90_dq_kernel<DP, BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_dq);
  if (err != cudaSuccess) return err;
  sm90_delta_kernel<<<dim3((a.sq + F_NT / 32 - 1) / (F_NT / 32), BH), F_NT, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sm90_dkdv_kernel<DP, BT>
      <<<dim3((a.sk + F_ROWS - 1) / F_ROWS, BH), F_NT, smem_dkdv, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sm90_dq_kernel<DP, BT><<<dim3((a.sq + F_ROWS - 1) / F_ROWS, BH), F_NT, smem_dq, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace sdk

// bf16 only. Strides and layout as sdk_flash_attention_bwd; the plan from
// Python: dpad = 16·ceil(d / 16) in {48, 64, 80, 160}, tile = the walked
// tiles' rows (64, or 32 at dpad 160), `stages` of the ring, and the two
// kernels' dynamic shared memory.
extern "C" int sdk_flash_attention_bwd_sm90(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv, long long r_sb, long long r_sh,
    long long r_ss, long long c_sb, long long c_sh, long long c_ss, int BH, int n_head, int sq,
    int sk, int d, float scale, int dpad, int tile, int stages, int smem_dkdv, int smem_dq,
    void* stream) {
  using sdk::bf16;
  const long long strides[] = {r_sb, r_sh, r_ss, c_sb, c_sh, c_ss};
  for (long long s : strides)
    if (s % 8) return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {q, k, v, o, dout, dq, dk, dv};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorInvalidValue;
  if (d <= 0 || d % 8 || dpad != (d + 15) / 16 * 16 || sq <= 0 || sk <= 0 || n_head <= 0 ||
      BH <= 0 || BH % n_head || stages < 2)
    return (int)cudaErrorInvalidValue;
  sdk::Sm90BwdArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                     static_cast<const bf16*>(v), static_cast<const bf16*>(o),
                     static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq),
                     static_cast<bf16*>(dk), static_cast<bf16*>(dv), r_sb, r_sh, r_ss,
                     c_sb, c_sh, c_ss, n_head, sq, sk, d, stages,
                     scale, scale * 1.4426950408889634f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dpad == 48 && tile == 64) return (int)sdk::launch_sm90_bwd<48, 64>(a, BH, smem_dkdv, smem_dq, s);
  if (dpad == 64 && tile == 64) return (int)sdk::launch_sm90_bwd<64, 64>(a, BH, smem_dkdv, smem_dq, s);
  if (dpad == 80 && tile == 64) return (int)sdk::launch_sm90_bwd<80, 64>(a, BH, smem_dkdv, smem_dq, s);
  if (dpad == 160 && tile == 32) return (int)sdk::launch_sm90_bwd<160, 32>(a, BH, smem_dkdv, smem_dq, s);
  return (int)cudaErrorInvalidValue;
}
