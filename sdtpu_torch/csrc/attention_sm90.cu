// The attention core in bf16 on Hopper's warpgroup tensor-core
// instructions: softmax(q kᵀ · d^-1/2 + key_bias) v per (batch, head). Two
// kernels of sdtpu run on it:
// - K2, the core of sdtpu/ops/fused_transformer.py:fused_self_attention
//   (its Pallas body `_kernel` :42, called at :145), whose two projections
//   run on csrc/gemm_sm90.cu;
// - K1, sdtpu/ops/flash_attention.py:flash_attention_heads (:220; Pallas
//   calls :320, :332, :390, :408) at the head widths this file has an
//   instance for, with its optional key bias and the rows' log-sum-exp that
//   the backward (K9) takes. d = 512 takes csrc/attention_wide_sm90.cu, and
//   f32 csrc/attention_tf32_sm90.cu (csrc/attention_wide_tf32_sm90.cu at d =
//   512).
//
// What bounds it on the H100: 4·Sq·Sk·d operations per head against a few
// [S, d] tensors, compute-bound at every UNet level (0.139 ms at the bf16
// peak at B = 2, S = 4096, C = 320). At d = 40..160 each score costs as
// many exp2, max and add instructions as tensor-core work, so the design
// keeps everything but the products in registers and off shared memory:
//
// - A CTA takes 128 query rows of one (batch, head): two consumer
//   warpgroups of 64 rows, Q resident in shared memory. It walks the keys in
//   tiles of `tile` rows through a ring of `stages` shared-memory stages
//   filled by cp.async (tiles j + 1 .. j + stages − 2 in flight while tile j
//   is multiplied, one block barrier a tile).
// - Tiles are unswizzled 8 x 16-byte core matrices with rows padded to
//   dpad = 16·ceil(d / 16) (48, 64, 80, 160): the copy itself writes zeros
//   in columns d..dpad and in rows past Sq or Sk, and never reads the next
//   head's columns (as csrc/flash_attention_bwd_sm90.cu).
// - S = Q·Kᵀ by wgmma (both operands K-major in shared memory) into f32
//   registers. The online softmax runs there: the row maximum over the
//   four threads of a row (two shuffles), the scale folded with log2(e)
//   into one fma before exp2, the row sums kept per thread and reduced
//   once at the end.
// - P is rounded to bf16 and packed in place into the A fragments of
//   O += P·V (register-sourced wgmma), V read N-major from its tile through
//   the descriptor's transpose bit. O stays in registers for the whole walk,
//   is rescaled by exp2(m_old − m_new) a tile and divided by l once.
// - Each warpgroup overlaps a tile's softmax with the tensor cores (FA3's
//   intra-warpgroup schedule): step j issues S_j = Q·K_jᵀ and then
//   O += P_{j−1}·V_{j−1}, waits for S_j alone, runs tile j's softmax into the
//   second set of P fragments while the P·V product runs, then waits for it
//   and rescales O. Only a last tile with keys past Sk is masked.
// - K1's key bias (an additive f32 row [B][Sk], 0 or −1e30, shared by the
//   heads of a batch element) is a 64-float row a key tile, copied by
//   cp.async into the ring beside the tile's K and V, and added in the log2
//   domain before the row maximum: s' = fma(s, scale·log2(e), bias·log2(e)).
//   Instances without it (BIAS false) compile as K2's core did.
// - With an lse pointer each row's log-sum-exp in the log2 domain,
//   m + log2(l), is written once after the final reduction of l, as
//   csrc/flash_attention.cu writes it: K9 rebuilds P = exp2(s·scale·log2(e)
//   − lse) from it.
//
// The core reads q, k and v, and writes o, through their own (batch, head,
// row) strides: K2 hands it the [B, S, 3C] QKV buffer (k and v C and 2C
// columns to the right of q) and takes o as [B, S, C] with the heads merged;
// K1 hands it [B, H, S, d] views of [BH, S, d] tensors or of heads inside
// [B, S, C] rows. The (dpad, tile, stages, shared memory) plan comes from
// Python (sdtpu_torch/ops/flash_attention.py:core_sm90_plan) and is
// checked here.
#include <type_traits>

#include "sm90.cuh"

namespace sdk {
namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

// 128 query rows a CTA (two consumer warpgroups), key tiles of BT rows
constexpr int A_ROWS = 128, A_NT = 256, A_MAX_SMEM = 232448, BT = 64;

constexpr float LOG2E = 1.4426950408889634f;

struct Sm90AttnArgs {
  const bf16* q; const bf16* k; const bf16* v; bf16* o;
  long long q_sb, q_sh, q_ss;  // (batch, head, row) strides of q
  long long k_sb, k_sh, k_ss;  // of k
  long long v_sb, v_sh, v_ss;  // of v
  long long o_sb, o_sh, o_ss;  // of o
  const float* bias;           // [batch][bias_sb] additive key bias (BIAS instances)
  long long bias_sb;
  float* lse;                  // [BH][sq] log2-domain log-sum-exp, or null
  int n_head, sq, sk, d, stages;
  float scale_log2;
};

template <int DP>
__host__ __device__ constexpr int tile_bytes(int rows) {
  return rows * DP * 2;
}
// Q resident; a stage holds a K and a V tile, and with the bias the tile's
// 64 f32 bias values (after the K and V tiles of every stage)
template <int DP>
__host__ __device__ constexpr int attn_smem(int stages, bool bias) {
  return tile_bytes<DP>(A_ROWS) + stages * (2 * tile_bytes<DP>(BT) + (bias ? BT * 4 : 0));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int DP, bool BIAS>
__global__ void __launch_bounds__(A_NT, DP > 64 ? 1 : 2) attention_sm90_kernel(Sm90AttnArgs a) {
  constexpr int STAGE = 2 * tile_bytes<DP>(BT);
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_q = smem_u32(smem), s_ring = s_q + tile_bytes<DP>(A_ROWS);
  const uint32_t s_bias = s_ring + a.stages * STAGE;  // BIAS: a 64-float row a stage

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4, wl = warp % 4, g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y, bb = bh / a.n_head, hh = bh % a.n_head;
  const int q0 = blockIdx.x * A_ROWS;
  const bf16* K = a.k + bb * a.k_sb + hh * a.k_sh;
  const bf16* V = a.v + bb * a.v_sb + hh * a.v_sh;
  const float* KB = BIAS ? a.bias + bb * a.bias_sb : nullptr;
  const int nk = (a.sk + BT - 1) / BT, stages = a.stages;
  // tile j's V is read by the products issued in step j + 1, so the ring
  // runs stages − 2 tiles ahead
  const int ahead = stages - 2;

  auto load_stage = [&](int j) {
    const uint32_t st = s_ring + (j % stages) * STAGE;
    load_tile<DP, A_NT>(st, K, a.k_ss, j * BT, BT, a.sk, a.d);
    load_tile<DP, A_NT>(st + tile_bytes<DP>(BT), V, a.v_ss, j * BT, BT, a.sk, a.d);
    if constexpr (BIAS) {
      const int key = j * BT + threadIdx.x;
      if (threadIdx.x < BT)
        cp_async4_s(s_bias + (j % stages) * BT * 4 + threadIdx.x * 4,
                    key < a.sk ? KB + key : KB, key < a.sk);
    }
  };

  load_tile<DP, A_NT>(s_q, a.q + bb * a.q_sb + hh * a.q_sh, a.q_ss, q0, A_ROWS, a.sq, a.d);
  for (int j = 0; j < ahead; ++j) {
    if (j < nk) load_stage(j);
    cp_async_commit();  // one group a tile (Q in the first), empty past the last
  }
  // tile j has landed everywhere, and the stage tile j + ahead goes to
  // (that of tile j − 2) is free: its products were waited for in step j − 1
  auto sync_tile = [&](int j) {
    cp_async_wait_dyn(ahead - 1);
    fence_proxy_async();
    __syncthreads();
    if (j + ahead < nk) load_stage(j + ahead);
    cp_async_commit();
  };

  // rows g and g + 8 of this warp: running maximum (log2 domain), this
  // thread's share of the row sum, and O (register 4j + 2h + e holds row
  // g + 8h, column 8j + 2t + e)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[DP / 2], s[BT / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  const uint32_t a_q = s_q + wg * 8 * DP * 16;

  // issue S = Q·K_jᵀ (one commit group)
  auto scores = [&](int j) {
    const uint32_t s_k = s_ring + (j % stages) * STAGE;
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) s[i] = 0.f;
    fence_regs<BT / 2>(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const uint64_t da = desc_k_major(a_q + kk * 256, DP * 16);
      const uint64_t db = desc_k_major(s_k + kk * 256, DP * 16);
      wgmma_ss_n64(s, da, db);
    }
    wgmma_commit();
    fence_regs<BT / 2>(s);
  };
  // issue O += P_j·V_j (one commit group)
  auto values = [&](uint32_t(&pf)[BT / 16][4], int j) {
    const uint32_t s_v = s_ring + (j % stages) * STAGE + tile_bytes<DP>(BT);
    fence_regs<DP / 2>(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      const uint64_t db = desc_n_major(s_v + kk * 2 * DP * 16, DP * 16);
      if constexpr (DP == 48) wgmma_rs_n48(o, pf[kk], db);
      else if constexpr (DP == 64) wgmma_rs_n64(o, pf[kk], db);
      else if constexpr (DP == 80) wgmma_rs_n80(o, pf[kk], db);
      else wgmma_rs_n160(o, pf[kk], db);
    }
    wgmma_commit();
    fence_regs<DP / 2>(o);
  };
  // the online softmax of tile j's scores (completed): the new maximum,
  // P = exp2(s·scale·log2(e) − m) packed to bf16 in place as the A operand
  // of P·V (K step kk takes registers 8kk .. 8kk + 7), l rescaled and
  // summed; returns O's factor in alpha. MASK: keys past Sk take no weight
  // (the last tile, when Sk is not a multiple of BT). BIAS: the scores are
  // first taken to the log2 domain with the key bias added, so that the
  // maximum is that of s·scale + bias.
  auto softmax = [&](auto mask, uint32_t(&pf)[BT / 16][4], int j, float(&alpha)[2]) {
    fence_regs<BT / 2>(s);
    if constexpr (decltype(mask)::value) {
#pragma unroll
      for (int i = 0; i < BT / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (j * BT + 8 * i + 2 * t + e >= a.sk) s[4 * i + e] = s[4 * i + 2 + e] = -INFINITY;
    }
    // the factor that takes a score to the log2 domain in the max and exp2
    // below: 1 once BIAS has done so here
    float sl2 = a.scale_log2;
    if constexpr (BIAS) {
      const float* kb = reinterpret_cast<const float*>(smem + (s_bias - s_q)) + (j % stages) * BT;
#pragma unroll
      for (int i = 0; i < BT / 8; ++i) {
        const float2 bv = *reinterpret_cast<const float2*>(kb + 8 * i + 2 * t);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          s[4 * i + 2 * h] = fmaf(s[4 * i + 2 * h], sl2, bv.x * LOG2E);
          s[4 * i + 2 * h + 1] = fmaf(s[4 * i + 2 * h + 1], sl2, bv.y * LOG2E);
        }
      }
      sl2 = 1.f;
    }
    float mx[2] = {-INFINITY, -INFINITY}, mneg[2];
#pragma unroll
    for (int i = 0; i < BT / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        mx[h] = fmaxf(mx[h], fmaxf(s[4 * i + 2 * h], s[4 * i + 2 * h + 1]));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h] * sl2);  // a tile holds a key: finite
      alpha[h] = fast_exp2(m[h] - m_new);
      m[h] = m_new;
      mneg[h] = -m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int i = 0; i < BT / 8; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p0 = fast_exp2(fmaf(s[4 * i + 2 * h], sl2, mneg[h]));
        const float p1 = fast_exp2(fmaf(s[4 * i + 2 * h + 1], sl2, mneg[h]));
        l[h] += p0 + p1;
        pf[i / 2][(i % 2) * 2 + h] = pack_bf16(p0, p1);
      }
    }
  };
  auto rescale = [&](const float(&alpha)[2]) {
#pragma unroll
    for (int i = 0; i < DP / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        o[4 * i + 2 * h] *= alpha[h];
        o[4 * i + 2 * h + 1] *= alpha[h];
      }
  };
  // step j: tile j's scores are computed while P_{j−1}·V_{j−1} runs, its
  // softmax while that product finishes, then O is rescaled
  auto step = [&](auto mask, uint32_t(&prev)[BT / 16][4], uint32_t(&next)[BT / 16][4], int j) {
    float alpha[2];
    sync_tile(j);
    scores(j);
    values(prev, j - 1);
    wgmma_wait<1>();
    softmax(mask, next, j, alpha);
    wgmma_wait<0>();
    fence_regs<DP / 2>(o);
    fence_regs<BT / 4>(&prev[0][0]);  // read by the product that just finished
    rescale(alpha);
  };
  auto finish = [&](uint32_t(&last)[BT / 16][4]) {
    values(last, nk - 1);
    wgmma_wait<0>();
    fence_regs<DP / 2>(o);
    fence_regs<BT / 4>(&last[0][0]);
  };

  using Full = std::integral_constant<bool, false>;
  using Ragged = std::integral_constant<bool, true>;
  const int nfull = a.sk / BT;  // tiles with no key past Sk
  uint32_t pa[BT / 16][4], pb[BT / 16][4];
  {
    float alpha[2];
    sync_tile(0);
    scores(0);
    wgmma_wait<0>();
    if (nfull > 0) softmax(Full{}, pa, 0, alpha);
    else softmax(Ragged{}, pa, 0, alpha);  // O is still 0: no rescale
  }
  int j = 1;
  for (; j + 1 < nfull; j += 2) {
    step(Full{}, pa, pb, j);
    step(Full{}, pb, pa, j + 1);
  }
  // at most one full tile and the ragged one remain; P_{j−1} is in pa
  if (j < nfull) {
    step(Full{}, pa, pb, j);
    if (j + 1 < nk) {
      step(Ragged{}, pb, pa, j + 1);
      finish(pa);
    } else {
      finish(pb);
    }
  } else if (j < nk) {
    step(Ragged{}, pa, pb, j);
    finish(pb);
  } else {
    finish(pa);
  }
  cp_async_wait<0>();

  // O / l, rows past Sq and columns past d dropped; the rows' log2-domain
  // log-sum-exp m + log2(l), once a row
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = 1.f / l[h];
    const int row = q0 + wg * 64 + wl * 16 + g + 8 * h;
    if (a.lse != nullptr && t == 0 && row < a.sq)
      a.lse[(long long)bh * a.sq + row] = m[h] + log2f(l[h]);
  }
  bf16* O = a.o + bb * a.o_sb + hh * a.o_sh;
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
    const int c = 8 * i + 2 * t;
    if (c >= a.d) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + wg * 64 + wl * 16 + g + 8 * h;
      if (row < a.sq)
        *reinterpret_cast<uint32_t*>(O + (long long)row * a.o_ss + c) =
            pack_bf16(o[4 * i + 2 * h] * inv[h], o[4 * i + 2 * h + 1] * inv[h]);
    }
  }
}

template <int DP, bool BIAS>
cudaError_t launch_attention_sm90(const Sm90AttnArgs& a, int BH, int smem, cudaStream_t stream) {
  if (smem != attn_smem<DP>(a.stages, BIAS) || smem > A_MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attention_sm90_kernel<DP, BIAS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  attention_sm90_kernel<DP, BIAS>
      <<<dim3((a.sq + A_ROWS - 1) / A_ROWS, BH), A_NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_attention_sm90(const Sm90AttnArgs& a, int BH, int smem, cudaStream_t stream) {
  return a.bias ? launch_attention_sm90<DP, true>(a, BH, smem, stream)
                : launch_attention_sm90<DP, false>(a, BH, smem, stream);
}

}  // namespace
}  // namespace sdk

// o = softmax(q kᵀ · scale + bias) v for each of the BH (batch, head)
// pairs, bf16, f32 statistics. Element (row r, column c) of head h of batch
// b lies at q + b·q_sb + h·q_sh + r·q_ss + c, and likewise in k, v and o
// through their own strides; every stride a multiple of 8 elements. bias:
// null, or the f32 row bias + b·bias_sb of Sk values added to every head of
// batch b. lse: null, or [BH][sq] f32 that takes each row's log-sum-exp in
// the log2 domain. d <= dpad: the plan from Python, dpad = 16·ceil(d / 16)
// in {48, 64, 80, 160}, tile = the key tiles' rows (64), `stages` of the
// ring, smem_bytes (with the bias, 256 more a stage).
extern "C" int sdk_attention_sm90(const void* q, const void* k, const void* v, void* o,
                                  long long q_sb, long long q_sh, long long q_ss, long long k_sb,
                                  long long k_sh, long long k_ss, long long v_sb, long long v_sh,
                                  long long v_ss, long long o_sb, long long o_sh, long long o_ss,
                                  const float* bias, long long bias_sb, float* lse, int BH,
                                  int n_head, int sq, int sk, int d, float scale, int dpad,
                                  int tile, int stages, int smem_bytes, void* stream) {
  using sdk::bf16;
  const long long strides[] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                               o_sb, o_sh, o_ss};
  for (long long s : strides)
    if (s % 8) return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {q, k, v, o};
  for (const void* p : ptrs)
    if (!sdk::sm90::aligned16(p)) return (int)cudaErrorInvalidValue;
  if (d <= 0 || d % 8 || dpad != (d + 15) / 16 * 16 || sq <= 0 || sk <= 0 || n_head <= 0 ||
      BH <= 0 || BH % n_head || stages < 3)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(lse) % 4 || bias_sb < 0) return (int)cudaErrorInvalidValue;
  sdk::Sm90AttnArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                      static_cast<const bf16*>(v), static_cast<bf16*>(o), q_sb, q_sh, q_ss,
                      k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, bias, bias_sb, lse,
                      n_head, sq, sk, d, stages, scale * sdk::LOG2E};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile != sdk::BT) return (int)cudaErrorInvalidValue;
  if (dpad == 48) return (int)sdk::launch_attention_sm90<48>(a, BH, smem_bytes, s);
  if (dpad == 64) return (int)sdk::launch_attention_sm90<64>(a, BH, smem_bytes, s);
  if (dpad == 80) return (int)sdk::launch_attention_sm90<80>(a, BH, smem_bytes, s);
  if (dpad == 160) return (int)sdk::launch_attention_sm90<160>(a, BH, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}
