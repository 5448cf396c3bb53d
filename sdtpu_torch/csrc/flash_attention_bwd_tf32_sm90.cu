// K9 in float32 on Hopper's warpgroup tensor-core instructions, TF32 in and
// f32 accumulators: the float32 route (float32 is the default compute dtype
// of `finetune`) of sdtpu/ops/flash_attention.py:flash_attention_bwd_heads
// (its Pallas body `_fullk_bwd_kernel` :531, called at :613).
//
// The function is flash_attention_bwd_sm90.cu's (read its header): per
// (batch, head), from q, k, v, the forward's output o, its log2-domain row
// statistics lse2 and dO,
//   P  = exp2(q k^T · d^-1/2 · log2(e) − lse2),   dV = P^T dO,
//   dP = dO v^T,   dS = P ∘ (dP − Δ) · d^-1/2,   Δ = rowsum(dO ∘ o),
//   dK = dS^T q,   dQ = dS k,
// f32 accumulation; q, k, v and dO rounded to TF32 (to nearest, cvt.rna)
// before their products, and P and dS before theirs, as the bf16 kernel
// rounds them to bf16.
//
// What bounds it on the H100: 5 products of 2·Sq·Sk·d operations against a
// few [S, d] tensors, compute-bound at TF32's dense peak (0.43 ms at BH =
// 32, S = 4096, d = 40, against 0.07 ms of bytes). The structure is the
// bf16 kernel's, with no atomics (every run gives the same bits): a dK/dV
// kernel whose CTA holds a block of keys and walks the query tiles, a dQ
// kernel whose CTA holds 128 queries and walks the key tiles, the scores
// and dP in registers, P and dS formed there as the A operand of the next
// products.
//
// What TF32 changes:
// - TF32 wgmma reads B (and an A from shared memory) only K-major, and the
//   bf16 kernel read three operands N-major from its tiles: dO in dV +=
//   P^T·dO and q in dK += dS^T·q (summed over the queries), k in dQ += dS·k
//   (over the keys). A pre-pass writes K-major copies of them, q^T, dO^T and
//   k^T [BH][d][len8] (len8 = the sequence rounded up to 8, zeros past it),
//   rounded to TF32, and folds Δ into its pass over dO. The kernels copy
//   their tiles by cp.async as they stand, the same way as the row tiles.
//   (The other choice, transposing the row tiles in shared memory inside
//   the kernels, was not built.)
// - register A's layout is not the accumulator's: a thread's accumulators
//   of an 8-column group are columns 2t and 2t + 1, a TF32 A fragment's are
//   k = t and t + 4. k = t is read as column 2t and k = t + 4 as 2t + 1, and
//   the copies hold each group of 8 positions in that order (0, 2, 4, 6, 1,
//   3, 5, 7: K2's V, csrc/attention_tf32_sm90.cu): P^T and dS^T (dQ: dS)
//   stay in the registers they were computed in, no shuffle.
// - the row tiles (q, dO, k, v: the operands of the scores and of dP, read
//   from shared memory by descriptor) are rounded to TF32 in place once they
//   have landed, each thread the chunks its own cp.async wrote.
// - f32 tiles are twice bf16's: the plan (ops/flash_attention.py:
//   bwd_tf32_plan) picks the walked tiles per head width so that the ring
//   holds at least two stages beside the resident rows: dK/dV walks query
//   tiles of 64 at d = 40, 32 at 64 and 80, 16 at 160; dQ key tiles of 64,
//   32 at 160. At d = 160, 128 resident keys of K and V (160 KB) leave no
//   room for a ring, and 64 keys x 160 of dK and of dV (160 accumulators)
//   exceed a warpgroup's registers beside the fragments: the dK/dV CTA
//   holds 64 keys and its two warpgroups split the work, one dV (S^T, P^T)
//   and one dK (S^T, dP^T, dS^T), the scores computed by both; the dQ CTA
//   holds 64 queries with one warpgroup.
//
// Rows past Sq or Sk load as zeros, and lse2 and Δ as zeros: their terms
// vanish in every product that reaches a stored result (the copies' zeros
// past the sequence meet them). q, o, dO and dQ share one (batch, head,
// row) stride triple, k, v, dK and dV another, so the heads of [B, S, C]
// rows need no transpose.
#include "tf32_sm90.cuh"

namespace sdk {
namespace {

using namespace sm90;

constexpr int T_NT = 256, T_MAX_SMEM = 232448;
constexpr int T_PREP_ROWS = 32;  // rows of one (batch, head) a pre-pass block copies
constexpr int T_MAX_D = 160;

struct Tf32BwdArgs {
  const float* q; const float* k; const float* v; const float* o; const float* dout;
  const float* lse;  // [BH][sq], log2 domain
  float* delta;      // [BH][sq], the pre-pass's
  float* dq; float* dk; float* dv;
  float* qt; float* dot; float* kt;  // the pre-pass's copies [BH][d][sq8] (kt: [BH][d][sk8])
  long long r_sb, r_sh, r_ss;  // q, o, dout, dq
  long long c_sb, c_sh, c_ss;  // k, v, dk, dv
  int n_head, sq, sk, sq8, sk8, d, stages_kv, stages_q;
  float scale, scale_log2;
};

// a tile of `rows` rows of DP floats as unswizzled core matrices: element
// (r, c) at (r / 8)·DP·32 + (c / 4)·128 + (r % 8)·16 + (c % 4)·4 bytes
template <int DP>
__host__ __device__ constexpr int t_tile_bytes(int rows) {
  return rows * DP * 4;
}
// dK/dV: ROWS resident keys of K and V; a stage: the q and dO row tiles, their
// K-major tiles, and the tile's lse2 and Δ
template <int DP, int BT>
__host__ __device__ constexpr int kv_stage() {
  return 4 * t_tile_bytes<DP>(BT) + 2 * BT * 4;
}
template <int DP, int BT, int ROWS>
__host__ __device__ constexpr int kv_smem(int stages) {
  return 2 * t_tile_bytes<DP>(ROWS) + stages * kv_stage<DP, BT>();
}
// dQ: ROWS resident queries of q and dO; a stage: the k and v row tiles and
// k's K-major tile
template <int DP, int BT, int ROWS>
__host__ __device__ constexpr int q_smem(int stages) {
  return 2 * t_tile_bytes<DP>(ROWS) + stages * 3 * t_tile_bytes<DP>(BT);
}

// rows [r0, r0 + n) of a [rows][DP] f32 slice (row stride ss) into a tile,
// by the NT threads of the block; rows at or past `limit` zero-filled
template <int DP, int NT>
__device__ __forceinline__ void load_rows(uint32_t dst, const float* src, long long ss, int r0,
                                          int n, int limit) {
  constexpr int CH = DP / 4;
  for (int i = threadIdx.x; i < n * CH; i += NT) {
    const int r = i / CH, c = i % CH, row = r0 + r;
    const bool ok = row < limit;
    cp_async16_s(dst + (r >> 3) * (DP * 32) + c * 128 + (r & 7) * 16,
                 ok ? src + (long long)row * ss + c * 4 : src, ok);
  }
}

// the chunks load_rows<DP, NT>(.., n, ..) wrote into the tile at dst,
// rounded to TF32 in place: each thread its own (a thread's cp.async writes
// are visible to it after its wait_group)
template <int DP, int NT>
__device__ __forceinline__ void round_rows(unsigned char* dst, int n) {
  constexpr int CH = DP / 4;
  for (int i = threadIdx.x; i < n * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    float4* p = reinterpret_cast<float4*>(dst + (r >> 3) * (DP * 32) + c * 128 + (r & 7) * 16);
    const float4 x = *p;
    *p = make_float4(round_tf32(x.x), round_tf32(x.y), round_tf32(x.z), round_tf32(x.w));
  }
}

// the [DP][BT] K-major tile of a copy at positions j0 .. j0 + BT (row c of
// src holds the head's len8 positions; len8 % 8 == 0): element (c, pos) at
// (c / 8)·BT·32 + (pos / 4)·128 + (c % 8)·16 + (pos % 4)·4 bytes; positions
// at or past len8 zero
template <int DP, int BT, int NT>
__device__ __forceinline__ void load_t_tile(uint32_t dst, const float* src, int len8, int j0) {
  constexpr int CH = BT / 4;
  for (int i = threadIdx.x; i < DP * CH; i += NT) {
    const int c = i / CH, kc = i % CH, pos = j0 + kc * 4;
    const bool ok = pos < len8;
    cp_async16_s(dst + (c >> 3) * (BT * 32) + kc * 128 + (c & 7) * 16,
                 ok ? src + (long long)c * len8 + pos : src, ok);
  }
}

// n floats from src[r0..] (zeros at or past limit)
template <int NT>
__device__ __forceinline__ void load_floats(uint32_t dst, const float* src, int r0, int n,
                                            int limit) {
  for (int i = threadIdx.x; i < n; i += NT) {
    const bool ok = r0 + i < limit;
    cp_async4_s(dst + i * 4, ok ? src + r0 + i : src, ok);
  }
}

template <int N>
__device__ __forceinline__ void ss_mma(float* acc, uint64_t a, uint64_t b) {
  if constexpr (N == 64) wgmma_tf32_ss_n64(acc, a, b);
  else if constexpr (N == 32) wgmma_tf32_ss_n32(acc, a, b);
  else wgmma_tf32_ss_n16(acc, a, b);
}
template <int DP>
__device__ __forceinline__ void rs_mma(float* acc, const uint32_t* af, uint64_t b) {
  if constexpr (DP == 40) wgmma_tf32_rs_n40(acc, af, b);
  else if constexpr (DP == 64) wgmma_tf32_rs_n64(acc, af, b);
  else if constexpr (DP == 80) wgmma_tf32_rs_n80(acc, af, b);
  else wgmma_tf32_rs_n160(acc, af, b);
}

// acc [BT / 2] += A·B^T over DP: A 64 rows of a row tile at a, B a [BT][DP]
// row tile at b
template <int DP, int BT>
__device__ __forceinline__ void scores(float* acc, uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk)
    ss_mma<BT>(acc, desc_k_major(a + kk * 256, DP * 32), desc_k_major(b + kk * 256, DP * 32));
}

// acc [DP / 2] += A (registers, BT / 8 K steps of 4) · B, B the [DP][BT]
// K-major tile at b
template <int DP, int BT>
__device__ __forceinline__ void values(float* acc, uint32_t (*af)[4], uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < BT / 8; ++kk) rs_mma<DP>(acc, af[kk], desc_k_major(b + kk * 256, BT * 32));
}

// the accumulator [64 rows][DP] of this warpgroup -> rows r0.. of out (row
// stride ss), rows at or past limit dropped
template <int DP>
__device__ __forceinline__ void store_acc(const float* acc, float* out, long long ss, int r0,
                                          int limit) {
  const int lane = threadIdx.x % 32, wl = (threadIdx.x / 32) % 4;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int c = 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + wl * 16 + g + 8 * h;
      if (row < limit)
        *reinterpret_cast<float2*>(out + (long long)row * ss + c) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// the pre-pass: block (x, bh, z) takes rows 32x .. 32x + 31 of (batch, head)
// bh of q (z = 0), dO (1) or k (2) and writes them into the K-major copy
// [BH][d][len8], position p of each group of 8 holding row (p % 4)·2 + p / 4
// of the group, rounded to TF32, positions past the sequence zero; with dO
// also Δ = rowsum(dO ∘ o) of those rows, in f32 from the unrounded values
__global__ void __launch_bounds__(T_NT) tf32_bwd_prep_kernel(Tf32BwdArgs a) {
  __shared__ float tile[T_PREP_ROWS][T_MAX_D + 1];
  const int z = blockIdx.z, bh = blockIdx.y, bb = bh / a.n_head, hh = bh % a.n_head;
  const int len = z == 2 ? a.sk : a.sq, len8 = z == 2 ? a.sk8 : a.sq8;
  const int r0 = blockIdx.x * T_PREP_ROWS;
  if (r0 >= len8) return;
  const long long off = z == 2 ? bb * a.c_sb + hh * a.c_sh : bb * a.r_sb + hh * a.r_sh;
  const long long ss = z == 2 ? a.c_ss : a.r_ss;
  const float* src = (z == 0 ? a.q : z == 1 ? a.dout : a.k) + off;
  float* dst = (z == 0 ? a.qt : z == 1 ? a.dot : a.kt) + (long long)bh * a.d * len8;
  const int ch = a.d / 4;
  for (int i = threadIdx.x; i < T_PREP_ROWS * ch; i += T_NT) {
    const int r = i / ch, c = i % ch, row = r0 + r;
    const float4 x = row < len ? *reinterpret_cast<const float4*>(src + (long long)row * ss + c * 4)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
    tile[r][4 * c] = x.x;
    tile[r][4 * c + 1] = x.y;
    tile[r][4 * c + 2] = x.z;
    tile[r][4 * c + 3] = x.w;
  }
  if (z == 1) {
    // Δ: one warp a row
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int r = warp; r < T_PREP_ROWS && r0 + r < a.sq; r += T_NT / 32) {
      const long long ro = off + (long long)(r0 + r) * ss;
      const float4* O = reinterpret_cast<const float4*>(a.o + ro);
      const float4* D = reinterpret_cast<const float4*>(a.dout + ro);
      float s = 0.f;
      for (int c = lane; c < ch; c += 32) {
        const float4 x = O[c], y = D[c];
        s += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
      }
      s = warp_sum(s);
      if (lane == 0) a.delta[(long long)bh * a.sq + r0 + r] = s;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < a.d * T_PREP_ROWS; i += T_NT) {
    const int c = i / T_PREP_ROWS, p = i % T_PREP_ROWS, pos = r0 + p;
    if (pos >= len8) continue;
    const int r = (p & ~7) | ((p & 3) * 2 + ((p >> 2) & 1));
    dst[(long long)c * len8 + pos] = round_tf32(tile[r][c]);
  }
}

// one query tile of the dK/dV walk for this warpgroup's 64 keys: S^T = K·q^T
// and (DK) dP^T = V·dO^T into registers; P^T (DV) and dS^T (DK) there as
// TF32 A fragments, register 4i + 2h + e of the scores being (key g + 8h,
// query 8i + 2t + e) and fragment i's (k t, k t + 4) queries 2t and 2t + 1;
// then dV += P^T·dO and dK += dS^T·q against the tile's K-major copies
template <int DP, int BT, bool DV, bool DK>
__device__ __forceinline__ void kv_tile(float* dv, float* dk, uint32_t a_k, uint32_t a_v,
                                        uint32_t st, const float* lse_t, const float* dl_t,
                                        float sl2, float scale) {
  constexpr int TB = t_tile_bytes<DP>(BT);
  const int t = threadIdx.x % 4;
  float s[BT / 2], dp[BT / 2];
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) s[i] = dp[i] = 0.f;
  fence_regs<BT / 2>(s);
  if constexpr (DK) fence_regs<BT / 2>(dp);
  wgmma_fence();
  scores<DP, BT>(s, a_k, st);  // S^T: keys x queries
  if constexpr (DK) scores<DP, BT>(dp, a_v, st + TB);  // dP^T
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<BT / 2>(s);
  if constexpr (DK) fence_regs<BT / 2>(dp);

  uint32_t pf[BT / 8][4], df[BT / 8][4];
#pragma unroll
  for (int i = 0; i < BT / 8; ++i) {
    const int c = 8 * i + 2 * t;
    const float l0 = lse_t[c], l1 = lse_t[c + 1];
    float d0 = 0.f, d1 = 0.f;
    if constexpr (DK) {
      d0 = dl_t[c];
      d1 = dl_t[c + 1];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float p0 = exp2f(s[4 * i + 2 * h] * sl2 - l0);
      const float p1 = exp2f(s[4 * i + 2 * h + 1] * sl2 - l1);
      if constexpr (DV) {
        pf[i][h] = to_tf32(p0);      // (key g + 8h, query 2t) as k = t
        pf[i][2 + h] = to_tf32(p1);  // (key g + 8h, query 2t + 1) as k = t + 4
      }
      if constexpr (DK) {
        df[i][h] = to_tf32(p0 * (dp[4 * i + 2 * h] - d0) * scale);
        df[i][2 + h] = to_tf32(p1 * (dp[4 * i + 2 * h + 1] - d1) * scale);
      }
    }
  }
  if constexpr (DV) fence_regs<DP / 2>(dv);
  if constexpr (DK) fence_regs<DP / 2>(dk);
  wgmma_fence();
  if constexpr (DV) values<DP, BT>(dv, pf, st + 3 * TB);  // dV += P^T dO
  if constexpr (DK) values<DP, BT>(dk, df, st + 2 * TB);  // dK += dS^T q
  wgmma_commit();
  wgmma_wait<0>();
  // the fragments stay allocated until the products that read them
  // asynchronously are done
  if constexpr (DV) {
    fence_regs<DP / 2>(dv);
    fence_regs<BT / 2>(&pf[0][0]);
  }
  if constexpr (DK) {
    fence_regs<DP / 2>(dk);
    fence_regs<BT / 2>(&df[0][0]);
  }
}

// dK and dV of ROWS keys (128, or 64 with SPLIT): walks the query tiles of
// BT rows. Without SPLIT each warpgroup takes 64 keys, both gradients; with
// it warpgroup 0 takes dV and warpgroup 1 dK of the same 64 keys
template <int DP, int BT, bool SPLIT>
__global__ void __launch_bounds__(T_NT, 1) tf32_dkdv_kernel(Tf32BwdArgs a) {
  constexpr int ROWS = SPLIT ? 64 : 128;
  constexpr int TB = t_tile_bytes<DP>(BT), STAGE = kv_stage<DP, BT>();
  constexpr int O_V = t_tile_bytes<DP>(ROWS), O_RING = 2 * O_V;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_u32(smem);

  const int wg = threadIdx.x / 128;
  const int bh = blockIdx.y, bb = bh / a.n_head, hh = bh % a.n_head;
  const int k0 = blockIdx.x * ROWS;
  const long long roff = bb * a.r_sb + hh * a.r_sh, coff = bb * a.c_sb + hh * a.c_sh;
  const float* Q = a.q + roff;
  const float* dO = a.dout + roff;
  const float* QT = a.qt + (long long)bh * a.d * a.sq8;
  const float* DOT = a.dot + (long long)bh * a.d * a.sq8;
  const float* lse = a.lse + (long long)bh * a.sq;
  const float* delta = a.delta + (long long)bh * a.sq;
  const int nq = (a.sq + BT - 1) / BT, stages = a.stages_kv;

  auto load_stage = [&](int j) {
    const uint32_t st = base + O_RING + (j % stages) * STAGE;
    const int q0 = j * BT;
    load_rows<DP, T_NT>(st, Q, a.r_ss, q0, BT, a.sq);
    load_rows<DP, T_NT>(st + TB, dO, a.r_ss, q0, BT, a.sq);
    load_t_tile<DP, BT, T_NT>(st + 2 * TB, QT, a.sq8, q0);
    load_t_tile<DP, BT, T_NT>(st + 3 * TB, DOT, a.sq8, q0);
    load_floats<T_NT>(st + 4 * TB, lse, q0, BT, a.sq);
    load_floats<T_NT>(st + 4 * TB + BT * 4, delta, q0, BT, a.sq);
  };

  load_rows<DP, T_NT>(base, a.k + coff, a.c_ss, k0, ROWS, a.sk);
  load_rows<DP, T_NT>(base + O_V, a.v + coff, a.c_ss, k0, ROWS, a.sk);
  for (int j = 0; j < stages - 1; ++j) {
    if (j < nq) load_stage(j);
    cp_async_commit();  // one group a stage, empty past the last tile
  }

  float acc[DP / 2], acc2[SPLIT ? 1 : DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (SPLIT ? 1 : DP / 2); ++i) acc2[i] = 0.f;
  // this warpgroup's 64 keys: its A rows of K and V
  const uint32_t kw = SPLIT ? 0 : wg * 8 * DP * 32;
  const uint32_t a_k = base + kw, a_v = base + O_V + kw;

  for (int j = 0; j < nq; ++j) {
    cp_async_wait_dyn(stages - 2);
    const int st = O_RING + (j % stages) * STAGE;
    if (j == 0) {
      round_rows<DP, T_NT>(smem, ROWS);
      round_rows<DP, T_NT>(smem + O_V, ROWS);
    }
    round_rows<DP, T_NT>(smem + st, BT);
    round_rows<DP, T_NT>(smem + st + TB, BT);
    fence_proxy_async();
    __syncthreads();  // tile j has landed, rounded, everywhere; tile j - 1 is free
    if (j + stages - 1 < nq) load_stage(j + stages - 1);
    cp_async_commit();

    const float* lse_t = reinterpret_cast<const float*>(smem + st + 4 * TB);
    const float* dl_t = lse_t + BT;
    if constexpr (!SPLIT) {
      kv_tile<DP, BT, true, true>(acc, acc2, a_k, a_v, base + st, lse_t, dl_t, a.scale_log2,
                                  a.scale);
    } else if (wg == 0) {
      kv_tile<DP, BT, true, false>(acc, nullptr, a_k, a_v, base + st, lse_t, dl_t,
                                   a.scale_log2, a.scale);
    } else {
      kv_tile<DP, BT, false, true>(nullptr, acc, a_k, a_v, base + st, lse_t, dl_t,
                                   a.scale_log2, a.scale);
    }
  }
  cp_async_wait<0>();
  if constexpr (!SPLIT) {
    store_acc<DP>(acc2, a.dk + coff, a.c_ss, k0 + wg * 64, a.sk);
    store_acc<DP>(acc, a.dv + coff, a.c_ss, k0 + wg * 64, a.sk);
  } else {
    store_acc<DP>(acc, (wg == 0 ? a.dv : a.dk) + coff, a.c_ss, k0, a.sk);
  }
}

// dQ of ROWS queries (a warpgroup each 64): walks the key tiles of BT rows:
// S = q·K^T and dP = dO·V^T into registers, dS formed there as TF32 A
// fragments (the rows' lse2 and Δ held in registers for the whole walk),
// dQ += dS·K against the tile's K-major copy of k
template <int DP, int BT, int ROWS>
__global__ void __launch_bounds__(ROWS * 2, 1) tf32_dq_kernel(Tf32BwdArgs a) {
  constexpr int NT = ROWS * 2;
  constexpr int TB = t_tile_bytes<DP>(BT), STAGE = 3 * TB;
  constexpr int O_DO = t_tile_bytes<DP>(ROWS), O_RING = 2 * O_DO;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_u32(smem);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4, wl = warp % 4, g = lane / 4;
  const int bh = blockIdx.y, bb = bh / a.n_head, hh = bh % a.n_head;
  const int q0 = blockIdx.x * ROWS;
  const long long roff = bb * a.r_sb + hh * a.r_sh, coff = bb * a.c_sb + hh * a.c_sh;
  const float* K = a.k + coff;
  const float* V = a.v + coff;
  const float* KT = a.kt + (long long)bh * a.d * a.sk8;
  const int nk = (a.sk + BT - 1) / BT, stages = a.stages_q;

  auto load_stage = [&](int j) {
    const uint32_t st = base + O_RING + (j % stages) * STAGE;
    load_rows<DP, NT>(st, K, a.c_ss, j * BT, BT, a.sk);
    load_rows<DP, NT>(st + TB, V, a.c_ss, j * BT, BT, a.sk);
    load_t_tile<DP, BT, NT>(st + 2 * TB, KT, a.sk8, j * BT);
  };

  load_rows<DP, NT>(base, a.q + roff, a.r_ss, q0, ROWS, a.sq);
  load_rows<DP, NT>(base + O_DO, a.dout + roff, a.r_ss, q0, ROWS, a.sq);
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
  const uint32_t a_q = base + wg * 8 * DP * 32, a_do = base + O_DO + wg * 8 * DP * 32;
  const float sl2 = a.scale_log2, scale = a.scale;

  for (int j = 0; j < nk; ++j) {
    cp_async_wait_dyn(stages - 2);
    const int st = O_RING + (j % stages) * STAGE;
    if (j == 0) {
      round_rows<DP, NT>(smem, ROWS);
      round_rows<DP, NT>(smem + O_DO, ROWS);
    }
    round_rows<DP, NT>(smem + st, BT);
    round_rows<DP, NT>(smem + st + TB, BT);
    fence_proxy_async();
    __syncthreads();
    if (j + stages - 1 < nk) load_stage(j + stages - 1);
    cp_async_commit();

    float s[BT / 2], dp[BT / 2];
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) s[i] = dp[i] = 0.f;
    fence_regs<BT / 2>(s);
    fence_regs<BT / 2>(dp);
    wgmma_fence();
    scores<DP, BT>(s, a_q, base + st);         // S: queries x keys
    scores<DP, BT>(dp, a_do, base + st + TB);  // dP
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<BT / 2>(s);
    fence_regs<BT / 2>(dp);

    // dS as TF32 A fragments: fragment i's (k t, k t + 4) are keys 2t and
    // 2t + 1 of the group
    uint32_t df[BT / 8][4];
#pragma unroll
    for (int i = 0; i < BT / 8; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p0 = exp2f(s[4 * i + 2 * h] * sl2 - lr[h]);
        const float p1 = exp2f(s[4 * i + 2 * h + 1] * sl2 - lr[h]);
        df[i][h] = to_tf32(p0 * (dp[4 * i + 2 * h] - dr[h]) * scale);
        df[i][2 + h] = to_tf32(p1 * (dp[4 * i + 2 * h + 1] - dr[h]) * scale);
      }
    }
    fence_regs<DP / 2>(dq);
    wgmma_fence();
    values<DP, BT>(dq, df, base + st + 2 * TB);  // dQ += dS K
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<DP / 2>(dq);
    fence_regs<BT / 2>(&df[0][0]);
  }
  cp_async_wait<0>();
  store_acc<DP>(dq, a.dq + roff, a.r_ss, q0 + wg * 64, a.sq);
}

// the pre-pass, then dK/dV (query tiles of BTKV, 64 keys a CTA with SPLIT,
// else 128), then dQ (key tiles of BTQ, ROWSQ queries a CTA)
template <int DP, int BTKV, bool SPLIT, int BTQ, int ROWSQ>
cudaError_t launch_tf32_bwd(const Tf32BwdArgs& a, int BH, int smem_kv, int smem_q,
                            cudaStream_t stream) {
  constexpr int ROWSKV = SPLIT ? 64 : 128;
  if (smem_kv != kv_smem<DP, BTKV, ROWSKV>(a.stages_kv) ||
      smem_q != q_smem<DP, BTQ, ROWSQ>(a.stages_q) || smem_kv > T_MAX_SMEM ||
      smem_q > T_MAX_SMEM)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(tf32_dkdv_kernel<DP, BTKV, SPLIT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(tf32_dq_kernel<DP, BTQ, ROWSQ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err != cudaSuccess) return err;
  const int len8 = a.sq8 > a.sk8 ? a.sq8 : a.sk8;
  tf32_bwd_prep_kernel<<<dim3((len8 + T_PREP_ROWS - 1) / T_PREP_ROWS, BH, 3), T_NT, 0,
                         stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tf32_dkdv_kernel<DP, BTKV, SPLIT>
      <<<dim3((a.sk + ROWSKV - 1) / ROWSKV, BH), T_NT, smem_kv, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  tf32_dq_kernel<DP, BTQ, ROWSQ>
      <<<dim3((a.sq + ROWSQ - 1) / ROWSQ, BH), ROWSQ * 2, smem_q, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace sdk

// f32 only. Strides and layout as sdk_flash_attention_bwd (multiples of 4
// floats, 16-byte aligned pointers); qt, dot [BH][d][sq8] and kt [BH][d][sk8]
// f32 scratch for the pre-pass's copies (sq8, sk8: sq, sk rounded up to 8).
// The plan from Python (ops/flash_attention.py:bwd_tf32_plan): d in {40, 64,
// 80, 160}; the dK/dV kernel's query tile (64 at d = 40, 32 at 64 and 80, 16
// at 160), stages and dynamic shared memory; the dQ kernel's key tile (64,
// 32 at 160), stages and dynamic shared memory.
extern "C" int sdk_flash_attention_bwd_tf32(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv, float* qt, float* dot,
    float* kt, long long r_sb, long long r_sh, long long r_ss, long long c_sb, long long c_sh,
    long long c_ss, int BH, int n_head, int sq, int sk, int d, float scale, int tile_kv,
    int stages_kv, int smem_kv, int tile_q, int stages_q, int smem_q, void* stream) {
  const long long strides[] = {r_sb, r_sh, r_ss, c_sb, c_sh, c_ss};
  for (long long s : strides)
    if (s % 4) return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {q, k, v, o, dout, dq, dk, dv, qt, dot, kt};
  for (const void* p : ptrs)
    if (!sdk::sm90::aligned16(p)) return (int)cudaErrorInvalidValue;
  if (sq <= 0 || sk <= 0 || n_head <= 0 || BH <= 0 || BH % n_head || stages_kv < 2 ||
      stages_q < 2)
    return (int)cudaErrorInvalidValue;
  sdk::Tf32BwdArgs a{static_cast<const float*>(q), static_cast<const float*>(k),
                     static_cast<const float*>(v), static_cast<const float*>(o),
                     static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq),
                     static_cast<float*>(dk), static_cast<float*>(dv), qt, dot, kt,
                     r_sb, r_sh, r_ss, c_sb, c_sh, c_ss, n_head, sq, sk, (sq + 7) / 8 * 8,
                     (sk + 7) / 8 * 8, d, stages_kv, stages_q, scale,
                     scale * 1.4426950408889634f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 40 && tile_kv == 64 && tile_q == 64)
    return (int)sdk::launch_tf32_bwd<40, 64, false, 64, 128>(a, BH, smem_kv, smem_q, s);
  if (d == 64 && tile_kv == 32 && tile_q == 64)
    return (int)sdk::launch_tf32_bwd<64, 32, false, 64, 128>(a, BH, smem_kv, smem_q, s);
  if (d == 80 && tile_kv == 32 && tile_q == 64)
    return (int)sdk::launch_tf32_bwd<80, 32, false, 64, 128>(a, BH, smem_kv, smem_q, s);
  if (d == 160 && tile_kv == 16 && tile_q == 32)
    return (int)sdk::launch_tf32_bwd<160, 16, true, 32, 64>(a, BH, smem_kv, smem_q, s);
  return (int)cudaErrorInvalidValue;
}
