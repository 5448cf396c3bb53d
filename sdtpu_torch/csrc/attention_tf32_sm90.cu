// K2's attention core in float32 on Hopper's warpgroup tensor-core
// instructions, TF32 in and f32 accumulators: softmax(q kᵀ · d^-1/2) v per
// (batch, head), the core of sdtpu/ops/fused_transformer.py:
// fused_self_attention (its Pallas body `_kernel` :42, called at :145),
// whose two projections run on csrc/gemm_tf32_sm90.cu. float32 is the
// default dtype of `sample`, `serve` and `finetune`.
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
// The core reads q and k through their (batch, head, row) strides (K2 hands
// it the [B, S, 2C] q | k buffer), v from vt and writes o through its
// strides ([B, S, C], heads merged). The (d, tile, stages, shared memory)
// plan comes from Python (sdtpu_torch/ops/fused_transformer.py:
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

struct Tf32AttnArgs {
  const float* q; const float* k; const float* vt; float* o;
  long long q_sb, q_sh, q_ss;  // (batch, head, row) strides of q
  long long k_sb, k_sh, k_ss;  // of k
  long long vt_sb, vt_sh;      // vt: (batch, head) strides; element (c, key) at c·sk + pos
  long long o_sb, o_sh, o_ss;  // of o
  int n_head, sq, sk, stages;
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

// the [DP][BT] tile of vt at keys j0 .. j0 + BT (each row c of vt holds the
// head's Sk keys, in groups of 8 whole: Sk % 8 == 0); keys past Sk zero
template <int DP, int BT, int NT>
__device__ __forceinline__ void load_vt_tile(uint32_t dst, const float* vt, int sk, int j0) {
  constexpr int CH = BT / 4;
  for (int i = threadIdx.x; i < DP * CH; i += NT) {
    const int c = i / CH, kc = i % CH, key = j0 + kc * 4;
    const bool ok = key < sk;
    cp_async16_s(dst + (c >> 3) * (BT * 32) + kc * 128 + (c & 7) * 16,
                 ok ? vt + (long long)c * sk + key : vt, ok);
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
// 128 a thread, their shared memory in half the SM's)
template <int DP, int BT>
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
  const int nk = (a.sk + BT - 1) / BT, stages = a.stages;
  const int ahead = stages - 2;

  auto load_stage = [&](int j) {
    const uint32_t st = s_ring + (j % stages) * STAGE;
    load_rows_f32<DP, F_NT>(st, K, a.k_ss, j * BT, BT, a.sk);
    load_vt_tile<DP, BT, F_NT>(st + f_tile_bytes<DP>(BT), VT, a.sk, j * BT);
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
  // rounded values; MASK: keys past Sk take no weight
  auto softmax = [&](auto mask, uint32_t(&pf)[BT / 8][4], int j, float(&alpha)[2]) {
    fence_regs<BT / 2>(s);
    if constexpr (decltype(mask)::value) {
#pragma unroll
      for (int i = 0; i < BT / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (j * BT + 8 * i + 2 * t + e >= a.sk) s[4 * i + e] = s[4 * i + 2 + e] = -INFINITY;
    }
    const float sl2 = a.scale_log2;
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

  // O / l, rounded to TF32 (o feeds Wo's product); rows past Sq dropped
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = 1.f / l[h];
  }
  float* O = a.o + bb * a.o_sb + hh * a.o_sh;
#pragma unroll
  for (int i = 0; i < DP / 8; ++i) {
    const int c = 8 * i + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + wg * 64 + wl * 16 + g + 8 * h;
      if (row < a.sq)
        *reinterpret_cast<float2*>(O + (long long)row * a.o_ss + c) =
            make_float2(round_tf32(o[4 * i + 2 * h] * inv[h]),
                        round_tf32(o[4 * i + 2 * h + 1] * inv[h]));
    }
  }
}

template <int DP, int BT>
cudaError_t launch_attention_tf32(const Tf32AttnArgs& a, int BH, int smem, cudaStream_t stream) {
  if (smem != f_attn_smem<DP, BT>(a.stages) || smem > F_MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(attention_tf32_kernel<DP, BT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  attention_tf32_kernel<DP, BT>
      <<<dim3((a.sq + F_ROWS - 1) / F_ROWS, BH), F_NT, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace sdk

// o = softmax(q kᵀ · scale) v for each of the BH (batch, head) pairs, f32
// with TF32 products. Element (row r, column c) of head h of batch b lies at
// q + b·q_sb + h·q_sh + r·q_ss + c, and likewise in k and o through their own
// strides (multiples of 4 floats); v is read from vt + b·vt_sb + h·vt_sh, a
// [d][sk] matrix whose groups of 8 keys are in the order 0, 2, 4, 6, 1, 3,
// 5, 7 (csrc/gemm_tf32_sm90.cu writes it so). The plan from Python: d in
// {40, 64, 80, 160}, tile = the key rows a tile (32 at d = 40 and 160, 64 at
// 64 and 80), `stages` of the ring, smem_bytes. sk % 8 == 0.
extern "C" int sdk_attention_tf32(const void* q, const void* k, const void* vt, void* o,
                                  long long q_sb, long long q_sh, long long q_ss, long long k_sb,
                                  long long k_sh, long long k_ss, long long vt_sb,
                                  long long vt_sh, long long o_sb, long long o_sh,
                                  long long o_ss, int BH, int n_head, int sq, int sk, int d,
                                  float scale, int tile, int stages, int smem_bytes,
                                  void* stream) {
  const long long strides[] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, vt_sb, vt_sh,
                               o_sb, o_sh, o_ss};
  for (long long s : strides)
    if (s % 4) return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {q, k, vt, o};
  for (const void* p : ptrs)
    if (!sdk::sm90::aligned16(p)) return (int)cudaErrorInvalidValue;
  if (sq <= 0 || sk <= 0 || sk % 8 || n_head <= 0 || BH <= 0 || BH % n_head || stages < 3)
    return (int)cudaErrorInvalidValue;
  sdk::Tf32AttnArgs a{static_cast<const float*>(q), static_cast<const float*>(k),
                      static_cast<const float*>(vt), static_cast<float*>(o), q_sb, q_sh, q_ss,
                      k_sb, k_sh, k_ss, vt_sb, vt_sh, o_sb, o_sh, o_ss, n_head, sq, sk, stages,
                      scale * sdk::F_LOG2E};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 40 && tile == 32) return (int)sdk::launch_attention_tf32<40, 32>(a, BH, smem_bytes, s);
  if (d == 64 && tile == 64) return (int)sdk::launch_attention_tf32<64, 64>(a, BH, smem_bytes, s);
  if (d == 80 && tile == 64) return (int)sdk::launch_attention_tf32<80, 64>(a, BH, smem_bytes, s);
  if (d == 160 && tile == 32)
    return (int)sdk::launch_attention_tf32<160, 32>(a, BH, smem_bytes, s);
  return (int)cudaErrorInvalidValue;
}
