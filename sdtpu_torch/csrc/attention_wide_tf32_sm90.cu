// K1 at wide heads (d = 512: the VAE decoder's mid-block attention) in
// float32 on Hopper's warpgroup tensor-core instructions, TF32 in and f32
// accumulators: sdtpu/ops/flash_attention.py:flash_attention_heads (:220;
// Pallas calls :320, :332, :390, :408). o = softmax(q kᵀ · d^-1/2 +
// key_bias) v per (batch, head), with K1's optional key bias and the rows'
// log2-domain log-sum-exp. float32 is the default dtype of `sample`: this
// runs in every float32 decode at 1024px (one head, S = 16384) and at SD
// v2.1's 768px (S = 9216). bf16 takes csrc/attention_wide_sm90.cu, d <= 160
// csrc/attention_tf32_sm90.cu.
//
// What bounds it on the H100: 4·Sq·Sk·d operations (5.5e11 at the 1024px
// decode), 1.11 ms at TF32's dense peak. bf16's layout does not carry over:
// in f32, Q of 64 rows is 128 KB, and one K tile and one Vᵀ tile of 32 keys
// are 64 KB each, 256 KB against the 227 KB a block can hold; and O's 64 x
// 512 accumulator is 128 registers a thread over two warpgroups.
//
// The design (one CTA, no cluster): a CTA takes 64 query rows of one
// (batch, head) with two consumer warpgroups, and the warpgroups split d:
// warpgroup w owns columns 256w .. 256w + 256 of Q, K and O.
// - Q (128 KB) stays resident; the keys go in tiles of 8 through two stages
//   (a K tile and a Vᵀ tile, 16 KB each, a stage), which leaves 4 KB to
//   exchange scores: 196 KB.
// - S = Q·Kᵀ is the sum of the two warpgroups' partial products over their
//   halves of d (wgmma m64n8k8, 32 K steps each, both operands K-major in
//   shared memory). Each warpgroup writes its 64 x 8 partial into shared
//   memory, thread for thread, reads the other's and adds it: S_0 + S_1,
//   the same bits in both (IEEE addition commutes). Both then run the same
//   online softmax (the same maxima, P and row sums), P in registers as the
//   A fragment of their own O += P·Vᵀ_w (wgmma m64n256k8, V read K-major
//   from the pre-pass's copy, keys in the fragments' order: no P in shared
//   memory and no exchange of row maxima).
// - Tile j + 1's K and V are copied by cp.async into the other stage while
//   tile j's products and softmax run: a whole tile's time to land. Two
//   block barriers a tile: tile j landed (and tile j − 1 done with), the
//   partials written.
// - q, k and v come rounded to TF32 from the pre-pass's copies
//   (sdk_attention_prep_tf32 in csrc/attention_tf32_sm90.cu: q and k as
//   rows, v K-major [d][Sk rounded up to 8]).
// - A warpgroup's 32 K steps of the scores go into four accumulators of 8
//   steps each, summed at the end in a fixed order: one chain of 32
//   dependent m64n8k8 products waits on each one's latency.
// - What limits it: every 8 keys each warpgroup's score products read its
//   half of Q (64 KB) from shared memory again, 128 KB a tile against the
//   SM's 128 bytes a clock, and the two phases of a tile (the products,
//   then the exchange and the softmax) do not overlap. Other designs were
//   built and measured slower at the 1024px decode's shape (PERF.md): one
//   K and one Vᵀ buffer of 16 keys, the scores in one chain, eight
//   chains, and a cluster of two CTAs splitting d (one warpgroup each, the
//   partial scores exchanged through distributed shared memory, 16 or 32
//   keys a tile), which was faster only at SD v2.1's one-head S = 9216,
//   where this grid's 144 CTAs leave a second wave of 12.
// - The key bias is read with the tile's scores and added in the log2
//   domain before the maximum; keys past Sk in the last tile take no weight;
//   rows past Sq are read as zeros and not stored; columns past d (widths
//   that pad to 512) are read as zeros and not stored.
//
// The grid: 256 CTAs for the 1024px decode's 16384 rows, 1.94 waves at one
// CTA an SM. The plan (head width 512, key tiles of 8, the shared memory)
// comes from Python (sdtpu_torch/ops/flash_attention.py:wide_tf32_plan) and
// is checked here.
#include "tf32_sm90.cuh"

namespace sdk {
namespace {

using namespace sm90;

// head width (padded), query rows a CTA, keys a tile, threads
constexpr int X_D = 512, X_HALF = X_D / 2, X_ROWS = 64, X_BT = 8, X_NT = 256;
constexpr int X_Q = X_ROWS * X_D * 4;  // Q, resident
constexpr int X_K = X_BT * X_D * 4;    // one K tile
constexpr int X_V = X_D * X_BT * 4;    // one Vᵀ tile
constexpr int X_STAGE = X_K + X_V, X_STAGES = 2;
constexpr int X_CHAINS = 4;  // independent accumulators of a warpgroup's scores
constexpr int X_XCH = 2 * 128 * (X_BT / 2) * 4;  // each warpgroup's partial scores
constexpr int OFF_Q = 0, OFF_RING = X_Q, OFF_X = OFF_RING + X_STAGES * X_STAGE;
constexpr int X_SMEM = OFF_X + X_XCH;
static_assert(X_SMEM == 200704, "the plan in ops/flash_attention.py:wide_tf32_plan");
constexpr float X_LOG2E = 1.4426950408889634f;

struct WideTf32Args {
  const float* q; const float* k; const float* vt; float* o;
  long long q_sb, q_sh, q_ss;     // (batch, head, row) strides of q
  long long k_sb, k_sh, k_ss;     // of k
  long long vt_sb, vt_sh, vt_ss;  // vt: (batch, head) strides; element (c, pos) at c·vt_ss + pos
  long long o_sb, o_sh, o_ss;     // of o
  const float* bias;              // [batch][bias_sb] additive key bias (BIAS instance)
  long long bias_sb;
  float* lse;                     // [BH][sq] log2-domain log-sum-exp, or null
  int n_head, sq, sk, d;
  float scale_log2;
};

__device__ __forceinline__ float x_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// rows [r0, r0 + n) of a [rows][X_D] f32 slice (row stride ss) as
// unswizzled core matrices (element (r, c) at (r / 8)·X_D·32 + (c / 4)·128
// + (r % 8)·16 + (c % 4)·4 bytes); rows at or past `limit` and columns at or
// past d zero-filled
__device__ __forceinline__ void x_load_rows(uint32_t dst, const float* src, long long ss, int r0,
                                            int n, int limit, int d) {
  constexpr int CH = X_D / 4;
  for (int i = threadIdx.x; i < n * CH; i += X_NT) {
    const int r = i / CH, c = i % CH, row = r0 + r;
    const bool ok = row < limit && c * 4 < d;
    cp_async16_s(dst + (r >> 3) * (X_D * 32) + c * 128 + (r & 7) * 16,
                 ok ? src + (long long)row * ss + c * 4 : src, ok);
  }
}

// the [X_D][X_BT] tile of vt at keys j0 .. j0 + X_BT: element (c, key) at
// (c / 8)·X_BT·32 + (key / 4)·128 + (c % 8)·16 + (key % 4)·4 bytes; keys at
// or past the pitch and rows at or past d zero
__device__ __forceinline__ void x_load_vt(uint32_t dst, const float* vt, long long pitch, int j0,
                                          int d) {
  constexpr int CH = X_BT / 4;
  for (int i = threadIdx.x; i < X_D * CH; i += X_NT) {
    const int c = i / CH, kc = i % CH, key = j0 + kc * 4;
    const bool ok = key < pitch && c < d;
    cp_async16_s(dst + (c >> 3) * (X_BT * 32) + kc * 128 + (c & 7) * 16,
                 ok ? vt + (long long)c * pitch + key : vt, ok);
  }
}

template <bool BIAS>
__global__ void __launch_bounds__(X_NT, 1) attention_wide_tf32_kernel(const WideTf32Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s0 = smem_u32(smem);
  const uint32_t s_q = s0 + OFF_Q, s_ring = s0 + OFF_RING;
  float* xch = reinterpret_cast<float*>(smem + OFF_X);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4, wl = warp % 4, g = lane / 4, t = lane % 4, tw = threadIdx.x % 128;
  const int bh = blockIdx.y, bb = bh / a.n_head, hh = bh % a.n_head;
  const int q0 = blockIdx.x * X_ROWS;
  const float* K = a.k + bb * a.k_sb + hh * a.k_sh;
  const float* VT = a.vt + bb * a.vt_sb + hh * a.vt_sh;
  const float* KB = BIAS ? a.bias + bb * a.bias_sb : nullptr;
  const int nk = (a.sk + X_BT - 1) / X_BT;

  // tile j's K and Vᵀ into stage j % 2, as one commit group
  auto load_stage = [&](int j) {
    const uint32_t st = s_ring + (j % X_STAGES) * X_STAGE;
    x_load_rows(st, K, a.k_ss, j * X_BT, X_BT, a.sk, a.d);
    x_load_vt(st + X_K, VT, a.vt_ss, j * X_BT, a.d);
  };
  x_load_rows(s_q, a.q + bb * a.q_sb + hh * a.q_sh, a.q_ss, q0, X_ROWS, a.sq, a.d);
  load_stage(0);
  cp_async_commit();

  // rows g and g + 8 of this warp (the same rows in both warpgroups):
  // running maximum (log2 domain), this thread's share of the row sum, O of
  // this warpgroup's 256 columns (register 4i + 2h + e: row g + 8h, column
  // 256·wg + 8i + 2t + e) and S (register 2h + e: key 2t + e of the tile)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[X_HALF / 2], s[X_BT / 2], sc[X_CHAINS * X_BT / 2];
  uint32_t pf[4];
#pragma unroll
  for (int i = 0; i < X_HALF / 2; ++i) o[i] = 0.f;
  // this warpgroup's half of d in Q's and K's tiles (64 chunks of 128
  // bytes), and its 256 rows of the Vᵀ tile
  const uint32_t a_q = s_q + wg * (X_HALF / 4) * 128;
  const uint32_t k_off = wg * (X_HALF / 4) * 128, v_off = X_K + wg * (X_HALF / 8) * (X_BT * 32);
  float4* mine = reinterpret_cast<float4*>(xch + (wg * 128 + tw) * (X_BT / 2));
  const float4* other = reinterpret_cast<const float4*>(xch + ((1 - wg) * 128 + tw) * (X_BT / 2));

  for (int j = 0; j < nk; ++j) {
    const uint32_t st = s_ring + (j % X_STAGES) * X_STAGE;
    // tile j (with Q at the first) has landed; after the barrier both
    // warpgroups are done with tile j − 1, whose stage takes tile j + 1
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (j + 1 < nk) load_stage(j + 1);
    cp_async_commit();

    // this warpgroup's partial scores over its half of d, K step kk into
    // chain kk % 4
#pragma unroll
    for (int i = 0; i < X_CHAINS * X_BT / 2; ++i) sc[i] = 0.f;
    fence_regs<X_CHAINS * X_BT / 2>(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < X_HALF / 8; ++kk)
      wgmma_tf32_ss_n8(sc + (kk % X_CHAINS) * (X_BT / 2),
                       desc_k_major(a_q + kk * 256, X_D * 32),
                       desc_k_major(st + k_off + kk * 256, X_D * 32));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<X_CHAINS * X_BT / 2>(sc);
    // the chains summed pairwise in a fixed order
#pragma unroll
    for (int w = X_CHAINS / 2; w >= 1; w /= 2)
#pragma unroll
      for (int c = 0; c < w; ++c)
#pragma unroll
        for (int i = 0; i < X_BT / 2; ++i)
          sc[c * (X_BT / 2) + i] += sc[(c + w) * (X_BT / 2) + i];
#pragma unroll
    for (int i = 0; i < X_BT / 2; ++i) s[i] = sc[i];
    mine[0] = make_float4(s[0], s[1], s[2], s[3]);
    __syncthreads();  // both partials written
    {
      const float4 x0 = other[0];
      s[0] += x0.x; s[1] += x0.y; s[2] += x0.z; s[3] += x0.w;
    }

    // the online softmax of the tile, the same in both warpgroups: keys
    // past Sk take no weight, the bias added in the log2 domain before the
    // maximum, P rounded to TF32 in place as P·V's A fragment ((g, key 2t),
    // (g + 8, 2t), (g, 2t + 1), (g + 8, 2t + 1)), l the sum of the rounded
    // values
    if ((j + 1) * X_BT > a.sk) {
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (j * X_BT + 2 * t + e >= a.sk) s[e] = s[2 + e] = -INFINITY;
    }
    float sl2 = a.scale_log2;
    if constexpr (BIAS) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = j * X_BT + 2 * t + e;
        const float bv = (key < a.sk ? __ldg(KB + key) : 0.f) * X_LOG2E;
        s[e] = fmaf(s[e], sl2, bv);
        s[2 + e] = fmaf(s[2 + e], sl2, bv);
      }
      sl2 = 1.f;
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = fmaxf(s[2 * h], s[2 * h + 1]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx * sl2);
      alpha[h] = x_exp2(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha[h];
      const uint32_t p0 = to_tf32(x_exp2(fmaf(s[2 * h], sl2, -m_new)));
      const uint32_t p1 = to_tf32(x_exp2(fmaf(s[2 * h + 1], sl2, -m_new)));
      l[h] += __uint_as_float(p0) + __uint_as_float(p1);
      pf[h] = p0;      // (row g + 8h, key 2t) as k = t
      pf[2 + h] = p1;  // (row g + 8h, key 2t + 1) as k = t + 4
    }
#pragma unroll
    for (int i = 0; i < X_HALF / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        o[4 * i + 2 * h] *= alpha[h];
        o[4 * i + 2 * h + 1] *= alpha[h];
      }

    // O_w += P·Vᵀ_w (tile j's Vᵀ landed with its K)
    fence_regs<X_HALF / 2>(o);
    fence_regs<4>(pf);
    wgmma_fence();
    wgmma_tf32_rs_n256(o, pf, desc_k_major(st + v_off, X_BT * 32));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<X_HALF / 2>(o);
    fence_regs<4>(pf);
  }
  cp_async_wait<0>();

  // O / l (both warpgroups hold the same l), rows past Sq and columns past
  // d dropped; the rows' log2-domain log-sum-exp m + log2(l), once a row
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = 1.f / l[h];
    const int row = q0 + wl * 16 + g + 8 * h;
    if (a.lse != nullptr && wg == 0 && t == 0 && row < a.sq)
      a.lse[(long long)bh * a.sq + row] = m[h] + log2f(l[h]);
  }
  float* O = a.o + bb * a.o_sb + hh * a.o_sh;
#pragma unroll
  for (int i = 0; i < X_HALF / 8; ++i) {
    const int c = wg * X_HALF + 8 * i + 2 * t;
    if (c >= a.d) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + wl * 16 + g + 8 * h;
      if (row < a.sq)
        *reinterpret_cast<float2*>(O + (long long)row * a.o_ss + c) =
            make_float2(o[4 * i + 2 * h] * inv[h], o[4 * i + 2 * h + 1] * inv[h]);
    }
  }
}

template <bool BIAS>
cudaError_t launch_wide_tf32(const WideTf32Args& a, int BH, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(attention_wide_tf32_kernel<BIAS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, X_SMEM);
  if (err != cudaSuccess) return err;
  attention_wide_tf32_kernel<BIAS>
      <<<dim3((a.sq + X_ROWS - 1) / X_ROWS, BH), X_NT, X_SMEM, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace sdk

// o = softmax(q kᵀ · scale + bias) v for each of the BH (batch, head) pairs
// at head widths 504..512 (multiples of 8), f32 with TF32 products. Element
// (row r, column c) of head h of batch b lies at q + b·q_sb + h·q_sh + r·q_ss
// + c, and likewise in k and o through their own strides (multiples of 4
// floats); v is read from vt + b·vt_sb + h·vt_sh, the [d][vt_ss] K-major
// copy sdk_attention_prep_tf32 writes (vt_ss a multiple of 8, at least sk), q
// and k rounded to TF32 (its copies).
// bias: null, or the f32 row bias + b·bias_sb of Sk values added to every
// head of batch b. lse: null, or [BH][sq] f32 that takes each row's
// log-sum-exp in the log2 domain. The plan from Python: dpad = 512, tile =
// 8, smem_bytes.
extern "C" int sdk_attention_wide_tf32(
    const void* q, const void* k, const void* vt, void* o, long long q_sb, long long q_sh,
    long long q_ss, long long k_sb, long long k_sh, long long k_ss, long long vt_sb,
    long long vt_sh, long long vt_ss, long long o_sb, long long o_sh, long long o_ss,
    const float* bias, long long bias_sb, float* lse, int BH, int n_head, int sq, int sk, int d,
    float scale, int dpad, int tile, int smem_bytes, void* stream) {
  const long long strides[] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, vt_sb, vt_sh, vt_ss,
                               o_sb, o_sh, o_ss};
  for (long long s : strides)
    if (s % 4) return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {q, k, vt, o};
  for (const void* p : ptrs)
    if (!sdk::sm90::aligned16(p)) return (int)cudaErrorInvalidValue;
  if (dpad != sdk::X_D || tile != sdk::X_BT || smem_bytes != sdk::X_SMEM || d % 8 ||
      d > sdk::X_D || d <= sdk::X_D - 16 || sq <= 0 || sk <= 0 || n_head <= 0 || BH <= 0 ||
      BH % n_head || vt_ss % 8 || vt_ss < sk || bias_sb < 0 ||
      reinterpret_cast<uintptr_t>(lse) % 4)
    return (int)cudaErrorInvalidValue;
  sdk::WideTf32Args a{static_cast<const float*>(q), static_cast<const float*>(k),
                      static_cast<const float*>(vt), static_cast<float*>(o), q_sb, q_sh, q_ss,
                      k_sb, k_sh, k_ss, vt_sb, vt_sh, vt_ss, o_sb, o_sh, o_ss, bias, bias_sb,
                      lse, n_head, sq, sk, d, scale * sdk::X_LOG2E};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bias ? sdk::launch_wide_tf32<true>(a, BH, s)
                    : sdk::launch_wide_tf32<false>(a, BH, s));
}

