// The attention core in float32 on Hopper's warpgroup tensor-core
// instructions, TF32 in and f32 accumulators: softmax(q kᵀ · d^-1/2 +
// key_bias) v per (batch, head). float32 is the default dtype of `sample`,
// `serve` and `finetune`. Three kernels of sdtpu run on it:
// - K2, the core of sdtpu/ops/fused_transformer.py:fused_self_attention
//   (its Pallas body `_kernel` :42, called at :145), whose two projections
//   run on csrc/gemm_tf32_sm90.cu;
// - K1, sdtpu/ops/flash_attention.py:flash_attention_heads (:220; Pallas
//   calls :320, :332, :390, :408) at d = 40, 64, 80 and 160, with its
//   optional key bias and the rows' log-sum-exp that the backward (K9)
//   takes (d = 512 runs on csrc/attention_wide_tf32_sm90.cu);
// - K10, sdtpu/ops/fused_cross_attention.py (:154, :223), its core over the
//   77 text keys with the key-padding bias.
//
// What bounds it on the H100: 4·Sq·Sk·d operations per head against a few
// [S, d] tensors, compute-bound at every UNet level at TF32's dense peak
// (0.278 ms at B = 2, S = 4096, C = 320). The structure is
// csrc/attention_sm90.cu's (FA3's intra-warpgroup overlap): a CTA of two
// consumer warpgroups takes 128 query rows of one (batch, head), Q resident
// in shared memory; it walks the keys in tiles of BT rows through a ring of
// `stages` shared-memory stages filled by cp.async (stages − 2 tiles ahead,
// one block barrier a tile); S = Q·Kᵀ by wgmma into f32 registers, the online
// softmax there (exp2 with the scale folded, the row sums per thread), O in
// registers for the whole walk, rescaled by exp2(m_old − m_new) a tile and
// divided by l once; step j issues S_j and then O += P_{j−1}·V_{j−1}, and runs
// tile j's softmax while that product runs.
//
// What TF32 changes:
// - Q·Kᵀ reads both from shared memory, K-major as the QKV buffer holds
//   them (rows of d floats in unswizzled 8 x 16-byte core matrices).
// - P·V takes P from registers and V from shared memory, which TF32 reads
//   only K-major: V as [d][keys]. The QKV product's epilogue writes V so
//   (csrc/gemm_tf32_sm90.cu, vt [B][H][d][S]), and a tile is copied by
//   cp.async as it stands: no transposition pass here.
// - register A's layout is not the accumulator's: a thread's S accumulators
//   of an 8-key group are keys 2t and 2t + 1 of rows g and g + 8, and a TF32
//   A fragment's are k = t and t + 4. Since P·V sums over the keys in any
//   order, k = t is read as key 2t and k = t + 4 as key 2t + 1, and vt holds
//   each group's keys in that order (0, 2, 4, 6, 1, 3, 5, 7): P stays in the
//   registers it was computed in, no shuffle.
// - P is rounded to TF32 (cvt.rna) and the row sums l add the rounded values,
//   so the normalisation matches the products; q, k and v come rounded from
//   the QKV product's epilogue, o is rounded as it is stored (it feeds Wo).
// - head widths take no padding: d = 40, 64, 80 and 160 are multiples of
//   TF32's K step (8) and of the N step (8). Key tiles of 64 at d = 64 and
//   80; of 32 at 160, where f32 tiles of 64 would not leave three stages
//   beside Q in the 227 KB of shared memory, and at 40, where two CTAs then
//   share an SM (chosen by device time on the H100: PERF.md).
//
// What K1 and K10 add:
// - their q, k and v come unrounded (full-f32 linears in training, K4 or
//   plain 1x1 convolutions in the decode, ctx·Wk and ctx·Wv in K10), and V
//   as [S, d] rows, which TF32 cannot read as B. One pre-pass launch
//   (tf32_prep_kernel, sdk_attention_prep_tf32) writes q and k rounded to
//   TF32 (cvt.rna) into contiguous [BH][S][d] copies and each head's V as a
//   K-major copy [d][Sk rounded up to 8], keys in the fragments' order (0,
//   2, 4, 6, 1, 3, 5, 7 in each group of 8), rounded, zeros past Sk: what
//   K2's QKV epilogue writes. The core then runs as K2's does. K9's float32
//   route rounds q and k the same way (cvt.rna), so the P it rebuilds from
//   this kernel's lse sums to 1 over its own TF32 scores. (Rounding each K
//   tile in shared memory instead, each thread its own cp.async chunks, was
//   built and measured slower on the H100: the rounding sat between a
//   tile's arrival and its barrier; PERF.md.) The wide kernel reads the same
//   copies.
// - the key bias (an f32 row [B][Sk], 0 or −1e30, shared by the heads of a
//   batch element) is read with the tile's scores and added in the log2
//   domain before the row maximum, s' = fma(s, scale·log2(e),
//   bias·log2(e)), as csrc/attention_sm90.cu adds it; keys past Sk in the
//   last tile take no weight (ragged key counts need no padding of k).
// - with an lse pointer each row's log2-domain log-sum-exp, m + log2(l), is
//   written once after the final reduction of l (K9 rebuilds P from it).
//
// The core reads q and k through their (batch, head, row) strides (K2 hands
// it the [B, S, 2C] q | k buffer), v from vt and writes o through its
// strides ([B, S, C], heads merged). The (d, tile, stages, shared memory)
// plan comes from Python (sdtpu_torch/ops/flash_attention.py:
// tf32_core_plan) and is checked here. (The P fragments' arrays are sized
// BT / 8 in the lambdas' parameters: a constexpr local there crashes
// nvcc 12.9's front end.)
#include <type_traits>

#include "tf32_sm90.cuh"

namespace sdk {
namespace {

using namespace sm90;

constexpr int F_ROWS = 128, F_NT = 256, F_MAX_SMEM = 232448;
constexpr float F_LOG2E = 1.4426950408889634f;
// the V pre-pass: a block copies 32 positions of 128 columns of one head
constexpr int VT_PREP_ROWS = 32, VT_PREP_COLS = 128;

struct Tf32AttnArgs {
  const float* q; const float* k; const float* vt; float* o;
  long long q_sb, q_sh, q_ss;    // (batch, head, row) strides of q
  long long k_sb, k_sh, k_ss;    // of k
  long long vt_sb, vt_sh, vt_ss; // vt: (batch, head) strides; element (c, pos) at c·vt_ss + pos
  long long o_sb, o_sh, o_ss;    // of o
  const float* bias;             // [batch][bias_sb] additive key bias (BIAS instances)
  long long bias_sb;
  float* lse;                    // [BH][sq] log2-domain log-sum-exp, or null
  int n_head, sq, sk, stages, round_o;
  float scale_log2;
};

// a tile of `rows` rows of DP floats as unswizzled core matrices: element
// (r, c) at (r / 8)·DP·32 + (c / 4)·128 + (r % 8)·16 + (c % 4)·4 bytes
template <int DP>
__host__ __device__ constexpr int f_tile_bytes(int rows) {
  return rows * DP * 4;
}
template <int DP, int BT>
__host__ __device__ constexpr int f_attn_smem(int stages) {
  return f_tile_bytes<DP>(F_ROWS) + stages * 2 * f_tile_bytes<DP>(BT);
}

__device__ __forceinline__ float f_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// rows [r0, r0 + n) of a [rows][DP] f32 slice (row stride ss) by the NT
// threads of the block; rows at or past `limit` zero-filled
template <int DP, int NT>
__device__ __forceinline__ void load_rows_f32(uint32_t dst, const float* src, long long ss,
                                              int r0, int n, int limit) {
  constexpr int CH = DP / 4;
  for (int i = threadIdx.x; i < n * CH; i += NT) {
    const int r = i / CH, c = i % CH, row = r0 + r;
    const bool ok = row < limit;
    cp_async16_s(dst + (r >> 3) * (DP * 32) + c * 128 + (r & 7) * 16,
                 ok ? src + (long long)row * ss + c * 4 : src, ok);
  }
}

// the [DP][BT] tile of vt at keys j0 .. j0 + BT (row c of vt holds the
// head's keys at c·pitch, in groups of 8 whole, zeros past Sk up to the
// pitch: pitch % 8 == 0); keys at or past the pitch zero
template <int DP, int BT, int NT>
__device__ __forceinline__ void load_vt_tile(uint32_t dst, const float* vt, long long pitch,
                                             int j0) {
  constexpr int CH = BT / 4;
  for (int i = threadIdx.x; i < DP * CH; i += NT) {
    const int c = i / CH, kc = i % CH, key = j0 + kc * 4;
    const bool ok = key < pitch;
    cp_async16_s(dst + (c >> 3) * (BT * 32) + kc * 128 + (c & 7) * 16,
                 ok ? vt + (long long)c * pitch + key : vt, ok);
  }
}

template <int DP, int BT>
__device__ __forceinline__ void scores_mma(float* s, uint64_t da, uint64_t db) {
  if constexpr (BT == 64) wgmma_tf32_ss_n64(s, da, db);
  else wgmma_tf32_ss_n32(s, da, db);
}
template <int DP>
__device__ __forceinline__ void values_mma(float* o, const uint32_t* pf, uint64_t db) {
  if constexpr (DP == 40) wgmma_tf32_rs_n40(o, pf, db);
  else if constexpr (DP == 64) wgmma_tf32_rs_n64(o, pf, db);
  else if constexpr (DP == 80) wgmma_tf32_rs_n80(o, pf, db);
  else wgmma_tf32_rs_n160(o, pf, db);
}

// key tiles of 32 at d <= 64 keep two CTAs on an SM (their registers fit in
// 128 a thread, their shared memory in half the SM's). BIAS: K1's and K10's
// key bias (instances without it compile as K2's core did).
template <int DP, int BT, bool BIAS>
__global__ void __launch_bounds__(F_NT, (BT == 32 && DP <= 64) ? 2 : 1)
    attention_tf32_kernel(Tf32AttnArgs a) {
  constexpr int STAGE = 2 * f_tile_bytes<DP>(BT);
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_q = smem_u32(smem), s_ring = s_q + f_tile_bytes<DP>(F_ROWS);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4, wl = warp % 4, g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y, bb = bh / a.n_head, hh = bh % a.n_head;
  const int q0 = blockIdx.x * F_ROWS;
  const float* K = a.k + bb * a.k_sb + hh * a.k_sh;
  const float* VT = a.vt + bb * a.vt_sb + hh * a.vt_sh;
  const float* KB = BIAS ? a.bias + bb * a.bias_sb : nullptr;
  const int nk = (a.sk + BT - 1) / BT, stages = a.stages;
  const int ahead = stages - 2;

  auto load_stage = [&](int j) {
    const uint32_t st = s_ring + (j % stages) * STAGE;
    load_rows_f32<DP, F_NT>(st, K, a.k_ss, j * BT, BT, a.sk);
    load_vt_tile<DP, BT, F_NT>(st + f_tile_bytes<DP>(BT), VT, a.vt_ss, j * BT);
  };

  load_rows_f32<DP, F_NT>(s_q, a.q + bb * a.q_sb + hh * a.q_sh, a.q_ss, q0, F_ROWS, a.sq);
  for (int j = 0; j < ahead; ++j) {
    if (j < nk) load_stage(j);
    cp_async_commit();
  }
  auto sync_tile = [&](int j) {
    cp_async_wait_dyn(ahead - 1);
    fence_proxy_async();
    __syncthreads();
    if (j + ahead < nk) load_stage(j + ahead);
    cp_async_commit();
  };

  // rows g and g + 8 of this warp: running maximum (log2 domain), this
  // thread's share of the row sum, O (register 4i + 2h + e: row g + 8h,
  // column 8i + 2t + e) and S (likewise, key 8i + 2t + e of the tile)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[DP / 2], s[BT / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  const uint32_t a_q = s_q + wg * 8 * DP * 32;

  auto scores = [&](int j) {
    const uint32_t s_k = s_ring + (j % stages) * STAGE;
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) s[i] = 0.f;
    fence_regs<BT / 2>(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 8; ++kk)
      scores_mma<DP, BT>(s, desc_k_major(a_q + kk * 256, DP * 32),
                         desc_k_major(s_k + kk * 256, DP * 32));
    wgmma_commit();
    fence_regs<BT / 2>(s);
  };
  auto values = [&](uint32_t(&pf)[BT / 8][4], int j) {
    const uint32_t s_v = s_ring + (j % stages) * STAGE + f_tile_bytes<DP>(BT);
    fence_regs<DP / 2>(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BT / 8; ++kk)
      values_mma<DP>(o, pf[kk], desc_k_major(s_v + kk * 256, BT * 32));
    wgmma_commit();
    fence_regs<DP / 2>(o);
  };
  // the online softmax of tile j's scores: P = exp2(s·scale·log2(e) − m)
  // rounded to TF32 in place as P·V's A fragments (K step i: (g, key 2t),
  // (g + 8, 2t), (g, 2t + 1), (g + 8, 2t + 1) of keys 8i..), l the sum of the
  // rounded values; MASK: keys past Sk take no weight. BIAS: the scores are
  // first taken to the log2 domain with the key bias added, so that the
  // maximum is that of s·scale + bias.
  auto softmax = [&](auto mask, uint32_t(&pf)[BT / 8][4], int j, float(&alpha)[2]) {
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
#pragma unroll
      for (int i = 0; i < BT / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = j * BT + 8 * i + 2 * t + e;
          const float bv = (key < a.sk ? __ldg(KB + key) : 0.f) * F_LOG2E;
          s[4 * i + e] = fmaf(s[4 * i + e], sl2, bv);
          s[4 * i + 2 + e] = fmaf(s[4 * i + 2 + e], sl2, bv);
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
      const float m_new = fmaxf(m[h], mx[h] * sl2);
      alpha[h] = f_exp2(m[h] - m_new);
      m[h] = m_new;
      mneg[h] = -m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int i = 0; i < BT / 8; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t p0 = to_tf32(f_exp2(fmaf(s[4 * i + 2 * h], sl2, mneg[h])));
        const uint32_t p1 = to_tf32(f_exp2(fmaf(s[4 * i + 2 * h + 1], sl2, mneg[h])));
        l[h] += __uint_as_float(p0) + __uint_as_float(p1);
        pf[i][h] = p0;      // (row g + 8h, key 2t) as k = t
        pf[i][2 + h] = p1;  // (row g + 8h, key 2t + 1) as k = t + 4
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
  auto step = [&](auto mask, uint32_t(&prev)[BT / 8][4], uint32_t(&next)[BT / 8][4], int j) {
    float alpha[2];
    sync_tile(j);
    scores(j);
    values(prev, j - 1);
    wgmma_wait<1>();
    softmax(mask, next, j, alpha);
    wgmma_wait<0>();
    fence_regs<DP / 2>(o);
    fence_regs<BT / 2>(&prev[0][0]);
    rescale(alpha);
  };
  auto finish = [&](uint32_t(&last)[BT / 8][4]) {
    values(last, nk - 1);
    wgmma_wait<0>();
    fence_regs<DP / 2>(o);
    fence_regs<BT / 2>(&last[0][0]);
  };

  using Full = std::integral_constant<bool, false>;
  using Ragged = std::integral_constant<bool, true>;
  const int nfull = a.sk / BT;
  uint32_t pa[BT / 8][4], pb[BT / 8][4];
  {
    float alpha[2];
    sync_tile(0);
    scores(0);
    wgmma_wait<0>();
    if (nfull > 0) softmax(Full{}, pa, 0, alpha);
    else softmax(Ragged{}, pa, 0, alpha);
  }
  int j = 1;
  for (; j + 1 < nfull; j += 2) {
    step(Full{}, pa, pb, j);
    step(Full{}, pb, pa, j + 1);
  }
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

  // O / l, rounded to TF32 where it feeds Wo's product (K2, K10: round_o);
  // rows past Sq dropped; the rows' log2-domain log-sum-exp m + log2(l),
  // once a row
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
  float* O = a.o + bb * a.o_sb + hh * a.o_sh;
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
    const int c = 8 * i + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + wg * 64 + wl * 16 + g + 8 * h;
      if (row < a.sq) {
        float2 v = make_float2(o[4 * i + 2 * h] * inv[h], o[4 * i + 2 * h + 1] * inv[h]);
        if (a.round_o) v = make_float2(round_tf32(v.x), round_tf32(v.y));
        *reinterpret_cast<float2*>(O + (long long)row * a.o_ss + c) = v;
      }
    }
  }
}

template <int DP, int BT, bool BIAS>
cudaError_t launch_instance(const Tf32AttnArgs& a, int BH, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(attention_tf32_kernel<DP, BT, BIAS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  attention_tf32_kernel<DP, BT, BIAS>
      <<<dim3((a.sq + F_ROWS - 1) / F_ROWS, BH), F_NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int DP, int BT>
cudaError_t launch_attention_tf32(const Tf32AttnArgs& a, int BH, int smem, cudaStream_t stream) {
  if (smem != f_attn_smem<DP, BT>(a.stages) || smem > F_MAX_SMEM) return cudaErrorInvalidValue;
  return a.bias ? launch_instance<DP, BT, true>(a, BH, smem, stream)
                : launch_instance<DP, BT, false>(a, BH, smem, stream);
}

// the plan's instance: d in {40, 64, 80, 160}, tile = the key rows a tile
// (32 at d = 40 and 160, 64 at 64 and 80)
cudaError_t launch_plan(const Tf32AttnArgs& a, int BH, int d, int tile, int smem,
                        cudaStream_t s) {
  if (d == 40 && tile == 32) return launch_attention_tf32<40, 32>(a, BH, smem, s);
  if (d == 64 && tile == 64) return launch_attention_tf32<64, 64>(a, BH, smem, s);
  if (d == 80 && tile == 64) return launch_attention_tf32<80, 64>(a, BH, smem, s);
  if (d == 160 && tile == 32) return launch_attention_tf32<160, 32>(a, BH, smem, s);
  return cudaErrorInvalidValue;
}

// what every launch of the core takes: strides in whole 16-byte chunks,
// aligned pointers, a head count that divides BH, at least 3 stages, and
// vt's pitch a multiple of 8 keys that holds Sk
bool valid_args(const Tf32AttnArgs& a, int BH) {
  const long long strides[] = {a.q_sb, a.q_sh, a.q_ss, a.k_sb, a.k_sh, a.k_ss, a.vt_sb,
                               a.vt_sh, a.vt_ss, a.o_sb, a.o_sh, a.o_ss};
  for (long long s : strides)
    if (s % 4) return false;
  const void* ptrs[] = {a.q, a.k, a.vt, a.o};
  for (const void* p : ptrs)
    if (!aligned16(p)) return false;
  return a.sq > 0 && a.sk > 0 && a.n_head > 0 && BH > 0 && BH % a.n_head == 0 &&
         a.stages >= 3 && a.vt_ss % 8 == 0 && a.vt_ss >= a.sk && a.bias_sb >= 0 &&
         reinterpret_cast<uintptr_t>(a.lse) % 4 == 0;
}

// the pre-pass (K1 and K10; K2's QKV product writes the same in its
// epilogue): block (x, bh, z) takes positions 32x .. 32x + 31 of (batch,
// head) bh. z = 0, 1: rows of q, k rounded to TF32 into the contiguous copy
// [BH][len][d]. z >= 2: columns 128(z − 2) .. of v into the K-major copy
// vt [BH][d][sk8], position p of each group of 8 holding row (p % 4)·2 + p
// / 4 of the group (keys 0, 2, 4, 6, 1, 3, 5, 7), rounded, positions past
// Sk zero. A null source skips its part.
struct PrepArgs {
  const float* src[3];               // q, k, v
  long long sb[3], sh[3], ss[3];     // their (batch, head, row) strides
  float* dst[3];                     // q's and k's copies, vt
  int n_head, sq, sk, sk8, d;
};

__global__ void __launch_bounds__(F_NT) tf32_prep_kernel(PrepArgs a) {
  __shared__ float tile[VT_PREP_ROWS][VT_PREP_COLS + 1];
  const int bh = blockIdx.y, bb = bh / a.n_head, hh = bh % a.n_head;
  const int r0 = blockIdx.x * VT_PREP_ROWS, z = min((int)blockIdx.z, 2);
  if (a.src[z] == nullptr) return;
  const float* src = a.src[z] + bb * a.sb[z] + hh * a.sh[z];
  if (z < 2) {
    const int len = z == 0 ? a.sq : a.sk, ch = a.d / 4;
    float* dst = a.dst[z] + (long long)bh * len * a.d;
    for (int i = threadIdx.x; i < VT_PREP_ROWS * ch; i += F_NT) {
      const int r = i / ch, c = i % ch, row = r0 + r;
      if (row >= len) break;
      const float4 x = *reinterpret_cast<const float4*>(src + (long long)row * a.ss[z] + c * 4);
      *reinterpret_cast<float4*>(dst + (long long)row * a.d + c * 4) =
          make_float4(round_tf32(x.x), round_tf32(x.y), round_tf32(x.z), round_tf32(x.w));
    }
    return;
  }
  if (r0 >= a.sk8) return;
  const int c0 = (blockIdx.z - 2) * VT_PREP_COLS;
  const int nc = min(VT_PREP_COLS, a.d - c0), ch = nc / 4;
  for (int i = threadIdx.x; i < VT_PREP_ROWS * ch; i += F_NT) {
    const int r = i / ch, c = i % ch, row = r0 + r;
    const float4 x = row < a.sk ? *reinterpret_cast<const float4*>(src + (long long)row * a.ss[2]
                                                                   + c0 + c * 4)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
    tile[r][4 * c] = x.x;
    tile[r][4 * c + 1] = x.y;
    tile[r][4 * c + 2] = x.z;
    tile[r][4 * c + 3] = x.w;
  }
  __syncthreads();
  float* dst = a.dst[2] + ((long long)bh * a.d + c0) * a.sk8;
  for (int i = threadIdx.x; i < nc * VT_PREP_ROWS; i += F_NT) {
    const int c = i / VT_PREP_ROWS, p = i % VT_PREP_ROWS, pos = r0 + p;
    if (pos >= a.sk8) continue;
    const int r = (p & ~7) | ((p & 3) * 2 + ((p >> 2) & 1));
    dst[(long long)c * a.sk8 + pos] = round_tf32(tile[r][c]);
  }
}

}  // namespace
}  // namespace sdk

// o = softmax(q kᵀ · scale + bias) v for each of the BH (batch, head)
// pairs, f32 with TF32 products (K2's, K1's and K10's core), from q and k
// rounded to TF32 (K2's QKV product's epilogue, sdk_attention_prep_tf32's
// copies, or K10's q from its product's epilogue). Element (row r, column c)
// of head h of batch b lies at q + b·q_sb + h·q_sh + r·q_ss + c, and
// likewise in k and o through their own strides (multiples of 4 floats); v
// is read from vt + b·vt_sb + h·vt_sh, a [d][vt_ss] K-major matrix whose
// groups of 8 keys are in the order 0, 2, 4, 6, 1, 3, 5, 7
// (csrc/gemm_tf32_sm90.cu's epilogue or sdk_attention_prep_tf32 writes it
// so; vt_ss a multiple of 8, at least sk), any sk.
// bias: null, or the f32 row bias + b·bias_sb of Sk values added to every
// head of batch b. lse: null, or [BH][sq] f32 that takes each row's
// log-sum-exp in the log2 domain. round_o: o rounded to TF32 as it is
// stored (K2's and K10's, which feed Wo's TF32 product), else in full f32
// (K1's). The plan from Python: d in {40, 64, 80, 160}, tile = the key
// rows a tile (32 at d = 40 and 160, 64 at 64 and 80), `stages` of the
// ring, smem_bytes.
extern "C" int sdk_flash_attention_tf32(
    const void* q, const void* k, const void* vt, void* o, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss, long long vt_sb,
    long long vt_sh, long long vt_ss, long long o_sb, long long o_sh, long long o_ss,
    const float* bias, long long bias_sb, float* lse, int BH, int n_head, int sq, int sk, int d,
    float scale, int round_o, int tile, int stages, int smem_bytes, void* stream) {
  sdk::Tf32AttnArgs a{static_cast<const float*>(q), static_cast<const float*>(k),
                      static_cast<const float*>(vt), static_cast<float*>(o), q_sb, q_sh, q_ss,
                      k_sb, k_sh, k_ss, vt_sb, vt_sh, vt_ss, o_sb, o_sh, o_ss, bias, bias_sb,
                      lse, n_head, sq, sk, stages, round_o != 0, scale * sdk::F_LOG2E};
  if (!sdk::valid_args(a, BH)) return (int)cudaErrorInvalidValue;
  return (int)sdk::launch_plan(a, BH, d, tile, smem_bytes, static_cast<cudaStream_t>(stream));
}

// the float32 cores' inputs (sdk_flash_attention_tf32,
// sdk_attention_wide_tf32), in one launch: q and k rounded to TF32 into
// the contiguous copies qr [BH][sq][d] and kr [BH][sk][d], and v into the
// K-major copy vt [BH][d][sk8] (sk8 = sk rounded up to 8), each group of 8
// keys in the order 0, 2, 4, 6, 1, 3, 5, 7, rounded, zeros past sk. Element
// (row r, column c) of head h of batch b of q lies at q + b·q_sb + h·q_sh +
// r·q_ss + c, and likewise in k and v (strides multiples of 4 floats). A
// null q, k or v (with its copy) is skipped. d a multiple of 8.
extern "C" int sdk_attention_prep_tf32(const void* q, long long q_sb, long long q_sh,
                                       long long q_ss, const void* k, long long k_sb,
                                       long long k_sh, long long k_ss, const void* v,
                                       long long v_sb, long long v_sh, long long v_ss, void* qr,
                                       void* kr, void* vt, int BH, int n_head, int sq, int sk,
                                       int d, void* stream) {
  const void* srcs[] = {q, k, v};
  void* dsts[] = {qr, kr, vt};
  const long long strides[] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss};
  for (long long s : strides)
    if (s % 4) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 3; ++i)
    if ((srcs[i] == nullptr) != (dsts[i] == nullptr) || !sdk::sm90::aligned16(srcs[i]) ||
        !sdk::sm90::aligned16(dsts[i]))
      return (int)cudaErrorInvalidValue;
  if (BH <= 0 || n_head <= 0 || BH % n_head || sq <= 0 || sk <= 0 || d <= 0 || d % 8)
    return (int)cudaErrorInvalidValue;
  const int sk8 = (sk + 7) / 8 * 8, rows = sq > sk8 ? sq : sk8;
  sdk::PrepArgs a{{static_cast<const float*>(q), static_cast<const float*>(k),
                   static_cast<const float*>(v)},
                  {q_sb, k_sb, v_sb}, {q_sh, k_sh, v_sh}, {q_ss, k_ss, v_ss},
                  {static_cast<float*>(qr), static_cast<float*>(kr), static_cast<float*>(vt)},
                  n_head, sq, sk, sk8, d};
  sdk::tf32_prep_kernel<<<dim3((rows + sdk::VT_PREP_ROWS - 1) / sdk::VT_PREP_ROWS, BH,
                               2 + (d + sdk::VT_PREP_COLS - 1) / sdk::VT_PREP_COLS),
                          sdk::F_NT, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
