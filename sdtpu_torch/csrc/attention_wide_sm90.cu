// K1 at wide heads (d = 512, the VAE decoder's mid-block attention) in bf16
// on Hopper's warpgroup tensor-core instructions and TMA:
// sdtpu/ops/flash_attention.py:flash_attention_heads (:220;
// Pallas calls :320, :332, :390, :408). o = softmax(q kᵀ · d^-1/2 +
// key_bias) v per (batch, head), f32 statistics, the output in bf16, with
// K1's optional key bias and the rows' log2-domain log-sum-exp. Narrower
// heads (d <= 160) take csrc/attention_sm90.cu; f32 at d = 512
// csrc/attention_wide_tf32_sm90.cu.
//
// What bounds it on the H100: 4·Sq·Sk·d operations (5.5e11 at the 1024px
// decode: one head, S = 16384), 0.556 ms at the bf16 peak. A 64-row query
// tile is all one CTA's registers can hold of O at d = 512 (64 x 512 f32 is
// 128 KB), so every CTA streams all of K and V through the SM for 64 rows:
// 128 KB of K and V a 64-key tile for 8.4 MFLOP, about 64 operations a
// byte. That is below what one SM's share of L2 bandwidth feeds at the
// tensor cores' rate, so the copies can set the pace (the kernel's `probe`
// times the products alone and the copies alone). Copied by cp.async, they
// did; by TMA, in 128-byte-swizzled boxes, they take less time than the
// products, which then set it. (Sharing each tile between two or four CTAs
// by TMA multicast, which halves or quarters what L2 serves, measured
// slower: each CTA's copies then wait for its peers to free their buffers;
// PERF.md.)
//
// - A CTA takes 64 query rows of one (batch, head): two consumer
//   warpgroups, 256 threads. O is split by columns: warpgroup w holds
//   O[:, 256w .. 256w + 256] as one m64n256 accumulator (128 registers a
//   thread). Two warpgroups, not four of 128 columns: the scores' product
//   reads Q from shared memory once per instruction, and each warpgroup's
//   key slice is then 32 keys wide, not 16, which halves Q's share of that
//   traffic against the product's work.
// - Q (resident), one K and one V tile are each eight TMA boxes of 64
//   columns x 64 rows (128-byte swizzle, 64 KB a tile), issued by thread 0
//   and counted in bytes on the tile's mbarrier. Shared memory also holds P
//   (64 x 64 bf16, unswizzled core matrices), the tile's key bias and the
//   row statistics exchanged between the warpgroups.
// - With one K and one V buffer the copies run one tile ahead: V_j is
//   copied while S_j = Q·K_jᵀ and its softmax run, K_{j+1} while P_j·V_j
//   runs; the block barriers a step takes anyway free the buffers.
// - S without redundant work: warpgroup w computes S[:, 32w .. 32w + 32] =
//   Q·K_slice over the full depth (wgmma m64n32, both operands K-major in
//   the swizzled boxes, a K step moving 32 bytes along the 128-byte row).
//   The two partial row maxima go through shared memory; both warpgroups
//   then take the same tile maximum (max of slice 0's and slice 1's), so
//   both track identical running maxima m and factors exp2(m_old − m_new).
//   Each writes its P slice, rounded to bf16, into P's columns 32w ..
//   32w + 32, and after one block barrier runs O_w += P (64 x 64, shared
//   memory, K-major) · V[:, 256w .. 256w + 256] (wgmma m64n256, V N-major
//   over four swizzled boxes through the descriptor's transpose bit). Each
//   warpgroup sums the row sums of its own keys; the two are added once at
//   the end, in slice order, and O is divided by them once.
// - The key bias (an additive f32 row [B][Sk], 0 or −1e30, shared by the
//   heads of a batch element) is copied by cp.async with each K tile into a
//   64-float row and added in the log2 domain before the maximum, s' =
//   fma(s, scale·log2(e), bias·log2(e)), as the narrow core does. Keys past
//   Sk (the last tile) take no weight (TMA's zeros, then −inf); rows past Sq
//   are read as zeros and not stored.
// - With an lse pointer each row's log-sum-exp in the log2 domain, m +
//   log2(l), is written once (K9 rebuilds P from it).
//
// The grid: 256 CTAs for the 1024px decode's 16384 rows, 1.94 waves at one
// CTA an SM on 132 SMs. q, k, v are read through 4-D tensor maps of their
// (batch, head, row) strides and o written through its strides. The plan
// (head width 512, key tiles of 64, the shared memory) comes from Python
// (sdtpu_torch/ops/flash_attention.py:wide_sm90_plan) and is checked here.
#include "sm90.cuh"

namespace sdk {
namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

// head width (padded), query rows a CTA, keys a tile, consumer warpgroups
constexpr int W_D = 512, W_ROWS = 64, W_BT = 64, W_WG = 2, W_NT = 128 * W_WG;
constexpr int W_COLS = W_D / W_WG;   // O's columns a warpgroup
constexpr int W_KEYS = W_BT / W_WG;  // S's keys a warpgroup
// a tile is W_BOXES boxes of 64 columns (128 bytes, the swizzle's row) x 64 rows
constexpr int W_BOX = 64, W_BOXES = W_D / W_BOX, W_BOX_BYTES = W_BT * W_BOX * 2;
constexpr int W_TILE = W_BOXES * W_BOX_BYTES;
// offsets from the 1024-byte-aligned base of the dynamic shared memory
constexpr int OFF_Q = 0, OFF_K = W_TILE, OFF_V = 2 * W_TILE, OFF_P = 3 * W_TILE;
constexpr int OFF_BIAS = OFF_P + W_ROWS * W_BT * 2;  // the tile's 64 f32 bias values
constexpr int OFF_STAT = OFF_BIAS + W_BT * 4;        // [W_WG][64] f32 row maxima, then sums
constexpr int OFF_BAR = OFF_STAT + W_WG * W_ROWS * 4;
constexpr int W_BARS = 3;  // Q, K, V landed
// 1024 bytes of slack to align the base to the swizzle pattern's repeat
constexpr int W_SMEM = 1024 + OFF_BAR + W_BARS * 8;
static_assert(W_SMEM == 206616, "the plan in ops/flash_attention.py:wide_sm90_plan");
static_assert(W_ROWS == W_BT, "Q's boxes and K's and V's share one tensor-map box");

constexpr float LOG2E = 1.4426950408889634f;

struct WideArgs {
  bf16* o;
  long long o_sb, o_sh, o_ss;  // (batch, head, row) strides of o
  const float* bias;           // [batch][bias_sb] additive key bias (BIAS instances)
  long long bias_sb;
  float* lse;                  // [BH][sq] log2-domain log-sum-exp, or null
  int n_head, sq, sk, d;
  float scale_log2;
};

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// PROBE (timing only, sdk_attention_wide_sm90's probe): 1 copies K and V
// for the first tile alone (the products and the softmax without the
// copies), 2 issues no wgmma (the copies and the softmax without the
// products). Their outputs mean nothing.
template <bool BIAS, int PROBE>
__global__ void __launch_bounds__(W_NT, 1)
    attention_wide_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v, const WideArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t s0 = smem_u32(smem);
  const uint32_t s_q = s0 + OFF_Q, s_k = s0 + OFF_K, s_v = s0 + OFF_V, s_p = s0 + OFF_P;
  const float* sbias = reinterpret_cast<const float*>(smem + OFF_BIAS);
  float* stat = reinterpret_cast<float*>(smem + OFF_STAT);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  uint64_t *full_q = bars, *full_k = bars + 1, *full_v = bars + 2;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4, wl = warp % 4, g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y, bb = bh / a.n_head, hh = bh % a.n_head;
  const int q0 = blockIdx.x * W_ROWS;
  const int nk = (a.sk + W_BT - 1) / W_BT;
  const float* KB = BIAS ? a.bias + bb * a.bias_sb : nullptr;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    mbar_init(full_k, 1);
    mbar_init(full_v, 1);
    fence_barrier_init();
  }
  __syncthreads();

  // the eight boxes of tile j (rows j·64 ..) of q, k or v at offset off
  auto issue = [&](const CUtensorMap* map, uint64_t* full, int off, int j) {
    mbar_expect_tx(full, W_TILE);
    for (int x = 0; x < W_BOXES; ++x)
      tma_load_4d(smem + off + x * W_BOX_BYTES, map, full, x * W_BOX, j * W_BT, hh, bb);
  };
  // the tile's 64 key-bias values (this CTA's own copy)
  auto load_bias = [&](int j) {
    if constexpr (BIAS) {
      const int key = j * W_BT + threadIdx.x;
      if (threadIdx.x < W_BT)
        cp_async4_s(s0 + OFF_BIAS + threadIdx.x * 4, key < a.sk ? KB + key : KB, key < a.sk);
      cp_async_commit();
    }
  };

  if (threadIdx.x == 0) {
    issue(&map_q, full_q, OFF_Q, blockIdx.x);
    issue(&map_k, full_k, OFF_K, 0);
    issue(&map_v, full_v, OFF_V, 0);
  }
  __syncwarp();
  load_bias(0);
  if constexpr (BIAS) cp_async_wait<0>();
  __syncthreads();  // the first tile's bias is in

  // this thread's rows of the tile: r_h = 16·wl + g + 8h (h = 0, 1); both
  // warpgroups hold the same rows, so both keep the same running maximum m
  // (log2 domain) and factors; l is the sum over this warpgroup's keys
  // (this thread's share until the end). O: register 4i + 2h + e holds row
  // r_h, column 256·wg + 8i + 2t + e.
  const int row0 = wl * 16 + g;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[W_COLS / 2];
#pragma unroll
  for (int i = 0; i < W_COLS / 2; ++i) o[i] = 0.f;
  // this warpgroup's key slice of K's boxes and column slice of V's
  const uint32_t b_k = s_k + W_KEYS * wg * 128;
  const uint32_t b_v = s_v + (W_COLS * wg / W_BOX) * W_BOX_BYTES;
  mbar_wait(full_q, 0);

  for (int j = 0; j < nk; ++j) {
    if (j > 0) {
      // every warpgroup is done with P_{j−1}·V_{j−1}: V's buffer and P are
      // free
      __syncthreads();
      if (threadIdx.x == 0 && PROBE != 1) issue(&map_v, full_v, OFF_V, j);
      __syncwarp();
    }
    if (PROBE != 1 || j == 0) mbar_wait(full_k, j & 1);

    // S = Q · K_slice over the full depth
    float s[W_KEYS / 2];
#pragma unroll
    for (int i = 0; i < W_KEYS / 2; ++i) s[i] = 0.f;
    if constexpr (PROBE != 2) {
      fence_regs<W_KEYS / 2>(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < W_D / 16; ++kk) {
        const uint32_t col = (kk / 4) * W_BOX_BYTES + (kk % 4) * 32;
        wgmma_ss_n32(s, desc_k_major_sw128(s_q + col), desc_k_major_sw128(b_k + col));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<W_KEYS / 2>(s);
    }
    // register 4i + 2h + e: row r_h, key j·64 + 32·wg + 8i + 2t + e. Keys
    // past Sk take no weight; with the bias the scores go to the log2 domain
    // here, with it added, and sl2 becomes 1
    if ((j + 1) * W_BT > a.sk) {
#pragma unroll
      for (int i = 0; i < W_KEYS / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (j * W_BT + W_KEYS * wg + 8 * i + 2 * t + e >= a.sk)
            s[4 * i + e] = s[4 * i + 2 + e] = -INFINITY;
    }
    float sl2 = a.scale_log2;
    if constexpr (BIAS) {
      const float* kb = sbias + W_KEYS * wg;
#pragma unroll
      for (int i = 0; i < W_KEYS / 8; ++i) {
        const float2 bv = *reinterpret_cast<const float2*>(kb + 8 * i + 2 * t);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          s[4 * i + 2 * h] = fmaf(s[4 * i + 2 * h], sl2, bv.x * LOG2E);
          s[4 * i + 2 * h + 1] = fmaf(s[4 * i + 2 * h + 1], sl2, bv.y * LOG2E);
        }
      }
      sl2 = 1.f;
    }
    // this slice's row maxima, exchanged through shared memory
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < W_KEYS / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        mx[h] = fmaxf(mx[h], fmaxf(s[4 * i + 2 * h], s[4 * i + 2 * h + 1]));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      if (t == 0) stat[wg * W_ROWS + row0 + 8 * h] = mx[h];
    }
    // both slices' maxima are in; every warpgroup's S product is done, so
    // K's buffer and the bias row are free
    __syncthreads();
    if (threadIdx.x == 0 && PROBE != 1 && j + 1 < nk) issue(&map_k, full_k, OFF_K, j + 1);
    __syncwarp();
    if (j + 1 < nk) load_bias(j + 1);

    float alpha[2], mneg[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float tile = fmaxf(stat[row0 + 8 * h], stat[W_ROWS + row0 + 8 * h]);
      const float m_new = fmaxf(m[h], tile * sl2);  // a tile holds a key: finite
      alpha[h] = fast_exp2(m[h] - m_new);
      m[h] = m_new;
      mneg[h] = -m_new;
      l[h] *= alpha[h];
    }
    // P = exp2(s·sl2 − m) in bf16 into P's columns 32·wg .., element (row,
    // key) at (row / 8)·1024 + (key / 8)·128 + (row % 8)·16 + (key % 8)·2
#pragma unroll
    for (int i = 0; i < W_KEYS / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p0 = fast_exp2(fmaf(s[4 * i + 2 * h], sl2, mneg[h]));
        const float p1 = fast_exp2(fmaf(s[4 * i + 2 * h + 1], sl2, mneg[h]));
        l[h] += p0 + p1;
        *reinterpret_cast<uint32_t*>(smem + OFF_P + (2 * wl + h) * (W_BT * 16) +
                                     (W_KEYS * wg / 8 + i) * 128 + g * 16 + 4 * t) =
            pack_bf16(p0, p1);
      }
#pragma unroll
    for (int i = 0; i < W_COLS / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        o[4 * i + 2 * h] *= alpha[h];
        o[4 * i + 2 * h + 1] *= alpha[h];
      }
    // the next tile's bias has landed; V_j has landed; P is whole
    if constexpr (BIAS) cp_async_wait<0>();
    if (PROBE != 1 || j == 0) mbar_wait(full_v, j & 1);
    fence_proxy_async();
    __syncthreads();
    if constexpr (PROBE != 2) {
      fence_regs<W_COLS / 2>(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < W_BT / 16; ++kk)
        wgmma_ss_n256_nb(o, desc_k_major(s_p + kk * 256, W_BT * 16),
                         desc_n_major_sw128_atoms(b_v + kk * 2048, W_BOX_BYTES));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<W_COLS / 2>(o);
    }
  }

  // the row sums of both key slices, added in slice order (the maxima's
  // last reads were before the loop's last barrier)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    if (t == 0) stat[wg * W_ROWS + row0 + 8 * h] = l[h];
  }
  __syncthreads();
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lt = stat[row0 + 8 * h] + stat[W_ROWS + row0 + 8 * h];
    inv[h] = 1.f / lt;
    const int row = q0 + row0 + 8 * h;
    if (a.lse != nullptr && wg == 0 && t == 0 && row < a.sq)
      a.lse[(long long)bh * a.sq + row] = m[h] + log2f(lt);
  }
  bf16* O = a.o + bb * a.o_sb + hh * a.o_sh;
#pragma unroll
  for (int i = 0; i < W_COLS / 8; ++i) {
    const int c = W_COLS * wg + 8 * i + 2 * t;
    if (c >= a.d) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + row0 + 8 * h;
      if (row < a.sq)
        *reinterpret_cast<uint32_t*>(O + (long long)row * a.o_ss + c) =
            pack_bf16(o[4 * i + 2 * h] * inv[h], o[4 * i + 2 * h + 1] * inv[h]);
    }
  }
}

// a [B][H][rows][d] bf16 view (element strides sb, sh, ss) as a 4-D tensor
// map read in boxes of 64 columns x 64 rows; a dimension of size 1 takes the
// stride of the ones inside it, whatever its own
cudaError_t make_map_heads(CUtensorMap* map, const void* ptr, int d, int rows, int H, int B,
                           long long ss, long long sh, long long sb) {
  const cuuint64_t s1 = ss * 2, s2 = H > 1 ? sh * 2 : s1 * rows, s3 = B > 1 ? sb * 2 : s2 * H;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {s1, s2, s3};
  const cuuint32_t box[4] = {W_BOX, W_BT, 1, 1};
  return make_map(map, ptr, 4, dims, strides, box);
}

template <bool BIAS, int PROBE>
cudaError_t launch_wide(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
                        const WideArgs& a, int BH, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(attention_wide_kernel<BIAS, PROBE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, W_SMEM);
  if (err != cudaSuccess) return err;
  attention_wide_kernel<BIAS, PROBE>
      <<<dim3((a.sq + W_ROWS - 1) / W_ROWS, BH), W_NT, W_SMEM, stream>>>(mq, mk, mv, a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace sdk

// o = softmax(q kᵀ · scale + bias) v for each of the BH (batch, head) pairs
// at head widths d <= 512 padded to 512 (dpad), bf16, f32 statistics; the
// strides, bias and lse as sdk_attention_sm90's (every stride a multiple of
// 8 elements, the tensors 16-byte aligned). tile = 64 keys and smem_bytes
// (206,616) from the plan. probe: 0 for attention; 1 and 2 time the
// products alone and the copies alone (no bias), whose outputs mean
// nothing.
extern "C" int sdk_attention_wide_sm90(const void* q, const void* k, const void* v, void* o,
                                       long long q_sb, long long q_sh, long long q_ss,
                                       long long k_sb, long long k_sh, long long k_ss,
                                       long long v_sb, long long v_sh, long long v_ss,
                                       long long o_sb, long long o_sh, long long o_ss,
                                       const float* bias, long long bias_sb, float* lse, int BH,
                                       int n_head, int sq, int sk, int d, float scale, int dpad,
                                       int tile, int smem_bytes, int probe, void* stream) {
  using namespace sdk;
  const long long strides[] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                               o_sb, o_sh, o_ss};
  for (long long s : strides)
    if (s % 8 || s < 0) return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {q, k, v, o};
  for (const void* p : ptrs)
    if (!sm90::aligned16(p)) return (int)cudaErrorInvalidValue;
  if (d <= 0 || d % 8 || d > W_D || dpad != W_D || tile != W_BT || smem_bytes != W_SMEM ||
      sq <= 0 || sk <= 0 || n_head <= 0 || BH <= 0 || BH % n_head || probe < 0 || probe > 2 ||
      (probe && bias != nullptr))
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(lse) % 4 || reinterpret_cast<uintptr_t>(bias) % 4 ||
      bias_sb < 0)
    return (int)cudaErrorInvalidValue;
  const int B = BH / n_head;
  CUtensorMap mq, mk, mv;
  cudaError_t err = make_map_heads(&mq, q, d, sq, n_head, B, q_ss, q_sh, q_sb);
  if (err == cudaSuccess) err = make_map_heads(&mk, k, d, sk, n_head, B, k_ss, k_sh, k_sb);
  if (err == cudaSuccess) err = make_map_heads(&mv, v, d, sk, n_head, B, v_ss, v_sh, v_sb);
  if (err != cudaSuccess) return (int)err;
  WideArgs a{static_cast<bf16*>(o), o_sb, o_sh, o_ss, bias, bias_sb, lse,
             n_head, sq, sk, d, scale * LOG2E};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bias != nullptr) return (int)launch_wide<true, 0>(mq, mk, mv, a, BH, s);
  if (probe == 1) return (int)launch_wide<false, 1>(mq, mk, mv, a, BH, s);
  if (probe == 2) return (int)launch_wide<false, 2>(mq, mk, mv, a, BH, s);
  return (int)launch_wide<false, 0>(mq, mk, mv, a, BH, s);
}
