// K1: flash attention forward, sdtpu/ops/flash_attention.py:flash_attention_heads
// (its four Pallas bodies: _fullk_kernel, _fullk_bias_kernel, _flash_kernel
// and _flash_ot_kernel; the full-K and transposed-output forms are TPU layout
// choices, so one online-softmax kernel covers them all). Its route at the
// head widths the Hopper kernels have no instance for (bf16:
// csrc/attention_sm90.cu and csrc/attention_wide_sm90.cu; f32:
// csrc/attention_tf32_sm90.cu at d = 40, 64, 80, 160 and
// csrc/attention_wide_tf32_sm90.cu at d = 512), and the route they are
// timed against (route "wmma").
//
// o = softmax(q k^T · d^-1/2 + key_bias) v per (batch, head), f32 statistics,
// output in the input type. key_bias is an optional additive f32 row
// [batch][Sk] (0 / -1e30, a key-padding mask) shared by the heads of a batch
// element. q, k, v and o are addressed through (batch, head, row) strides, so
// [BH, S, d] tensors and heads inside a [B, S, C] row both come in without a
// split or merge transpose.
//
// What bounds it on the H100: 4·Sq·Sk·d flops against (2·Sq + 2·Sk)·d
// elements; at the VAE's 1024px mid block (one head, S = 16384, d = 512) that
// is 5.5e11 flops for 64 MB — compute-bound by far. The [Sq, Sk] score matrix
// is what must stay out of HBM: one block owns a tile of query rows and walks
// the keys in tiles with an online softmax (f32 running max and sum per row).
//
// d = 512 is the hard case: a 64-row Q tile, K and V tiles and an f32 output
// accumulator do not fit in 227 KB of shared memory together. So the output
// accumulator lives in registers, split across the warps by head-dim columns:
// eight warps as WR row tiles x WC column groups, each warp holding its
// 16-row by (d / WC)-column slice of O as WMMA accumulator fragments. The
// per-row rescale of the online softmax needs each fragment element's row;
// WMMA's layout is opaque, so the kernel reads it once at the start by
// loading a matrix of element indices into an accumulator fragment. Shared
// memory then holds only Q, one K and one V tile, the score tile and the
// probability tile. Wide heads (d > 160, up to 512) take 64 query rows and 2
// column groups (227,072 bytes of shared memory at d = 512 in bf16 with
// 64-key tiles; 16-key tiles in f32); narrow heads (d <= 160, training's
// 40/80/160) take 128 query rows and one column group. The K and V tiles
// move with cp.async, all of a tile's 16-byte copies in flight at once (a
// load through registers waits one L2 round trip per pass): V's copy
// overlaps QK^T and the softmax, the next tile's K overlaps P·V, in the same
// buffers. Products go through WMMA (mma.sync), not wgmma. Head dims are
// zero-padded to a multiple of 16 in shared memory; tiles move as 16-byte
// vectors (d % 8 == 0).
//
// For training it also writes, when asked, each row's log-sum-exp of the
// scaled scores in the log2 domain, lse2 = m + log2(l) with m the row max of
// s · d^-1/2 · log2(e): the backward (K9, csrc/flash_attention_bwd.cu)
// rebuilds P = exp2(s · d^-1/2 · log2(e) - lse2) from it without a second
// pass over the keys.
#include "common.cuh"

namespace sdk {
namespace {

constexpr int FA_NT = 256, FA_NW = 8;
constexpr int FA_MAX_D = 512;
constexpr size_t FA_MAX_SMEM = 227 * 1024;
constexpr float LOG2E = 1.4426950408889634f;

struct FlashArgs {
  const void* q; const void* k; const void* v; void* o;
  long long q_sb, q_sh, q_ss;  // element strides of batch, head, row
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  const float* bias;           // [batch][sk] additive, or null
  float* lse;                  // [BH][sq] log2-domain row log-sum-exp out, or null
  int n_head, sq, sk, d;
  float scale_log2;            // d^-1/2 · log2(e)
};

struct FlashLayout {
  int wr, wc, bq, bk, dp, ldq, lds, ldp;
  size_t q, k, v, s, p, st, total;
};

template <typename T>
FlashLayout flash_layout(int d, int wr, int bk) {
  FlashLayout L;
  L.wr = wr;
  L.wc = FA_NW / wr;
  L.bq = 16 * wr;
  L.bk = bk;
  L.dp = (d + 15) / 16 * 16;
  L.ldq = L.dp + 8;
  L.lds = bk + 4;
  L.ldp = bk + 8;
  L.q = 0;
  L.k = align128(L.q + sizeof(T) * L.bq * L.ldq);
  L.v = align128(L.k + sizeof(T) * bk * L.ldq);
  L.s = align128(L.v + sizeof(T) * bk * L.ldq);
  L.p = align128(L.s + sizeof(float) * L.bq * L.lds);
  L.st = align128(L.p + sizeof(T) * L.bq * L.ldp);
  L.total = align128(L.st + sizeof(float) * 3 * L.bq);
  return L;
}

template <typename T, int MAXT>
__global__ void __launch_bounds__(FA_NT) flash_kernel(FlashArgs a, FlashLayout L) {
  using MT = Mma<T>;
  using Acc = typename MT::Acc;
  constexpr int VEC = 16 / sizeof(T);
  constexpr int NE = Acc::num_elements;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L.q);
  T* Ks = reinterpret_cast<T*>(smem + L.k);
  T* Vs = reinterpret_cast<T*>(smem + L.v);
  float* Ss = reinterpret_cast<float*>(smem + L.s);
  T* Ps = reinterpret_cast<T*>(smem + L.p);
  float* m_s = reinterpret_cast<float*>(smem + L.st);  // running max (log2 domain)
  float* l_s = m_s + L.bq;                             // running sum
  float* al_s = l_s + L.bq;                            // this tile's rescale

  const int tid = threadIdx.x, warp = tid / 32;
  const int wr = warp % L.wr, wc = warp / L.wr;  // this warp's O slice
  const int bh = blockIdx.y, bb = bh / a.n_head, hh = bh % a.n_head;
  const int q0 = blockIdx.x * L.bq;
  const int dp = L.dp, ldq = L.ldq, lds = L.lds, ldp = L.ldp, bk = L.bk;
  const int vpr = a.d / VEC, ncol = dp / 16;
  const T* Q = static_cast<const T*>(a.q) + bb * a.q_sb + hh * a.q_sh;
  const T* K = static_cast<const T*>(a.k) + bb * a.k_sb + hh * a.k_sh;
  const T* V = static_cast<const T*>(a.v) + bb * a.v_sb + hh * a.v_sh;
  T* O = static_cast<T*>(a.o) + bb * a.o_sb + hh * a.o_sh;
  const float* bias = a.bias ? a.bias + (long long)bb * a.sk : nullptr;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);

  // zero everything once: the padded columns d..dp stay zero, since the
  // loads below write only columns < d
  for (size_t i = tid; i < L.total / 16; i += FA_NT) reinterpret_cast<uint4*>(smem)[i] = zero4;
  __syncthreads();
  Ss[tid] = (float)tid;  // a 16x16 matrix of element indices, pitch 16
  for (int r = tid; r < L.bq; r += FA_NT) m_s[r] = -INFINITY;
  for (int i = tid; i < L.bq * vpr; i += FA_NT) {
    const int r = i / vpr, c = i % vpr * VEC, q = q0 + r;
    if (q < a.sq)
      *reinterpret_cast<uint4*>(Qs + r * ldq + c) =
          *reinterpret_cast<const uint4*>(Q + (long long)q * a.q_ss + c);
  }
  __syncthreads();

  // the row and column of each accumulator element, read from the layout
  int rmap[NE], cmap[NE];
  {
    Acc f;
    wmma::load_matrix_sync(f, Ss, 16, wmma::mem_row_major);
#pragma unroll
    for (int i = 0; i < NE; ++i) {
      const int e = (int)f.x[i];
      rmap[i] = e / 16;
      cmap[i] = e % 16;
    }
  }
  Acc acc[MAXT];
#pragma unroll
  for (int t = 0; t < MAXT; ++t) wmma::fill_fragment(acc[t], 0.f);
  __syncthreads();  // the index matrix is read before the scores overwrite it

  const int nsr = L.bq / 16, nst = nsr * (bk / 16);
  const int tpr = FA_NT / L.bq, per = bk / tpr;  // softmax: threads per row
  const int sr = tid / tpr, part = tid % tpr;

  // one group of copies: the bk rows from kv0 of src into dst, rows past
  // Sk zero-filled
  auto load_tile = [&](T* dst, const T* src, long long ss, int kv0) {
    for (int i = tid; i < bk * vpr; i += FA_NT) {
      const int r = i / vpr, c = i % vpr * VEC, kv = kv0 + r;
      const bool ok = kv < a.sk;
      cp_async16(dst + r * ldq + c, ok ? src + (long long)kv * ss + c : src, ok);
    }
    cp_async_commit();
  };

  load_tile(Ks, K, a.k_ss, 0);
  for (int kv0 = 0; kv0 < a.sk; kv0 += bk) {
    load_tile(Vs, V, a.v_ss, kv0);  // in flight during QK^T and the softmax
    cp_async_wait<1>();             // this tile's K has arrived
    __syncthreads();

    // S = Q K^T for the bq x bk tile, 16x16 sub-tiles spread over the warps
    for (int t = warp; t < nst; t += FA_NW) {
      const int ti = t % nsr, tj = t / nsr;
      Acc s;
      wmma::fill_fragment(s, 0.f);
      for (int kk = 0; kk < dp; kk += MT::K) {
        typename MT::ARow af;
        typename MT::BCol bf;
        wmma::load_matrix_sync(af, Qs + ti * 16 * ldq + kk, ldq);
        wmma::load_matrix_sync(bf, Ks + tj * 16 * ldq + kk, ldq);
        MT::prep(af);
        MT::prep(bf);
        wmma::mma_sync(s, af, bf, s);
      }
      wmma::store_matrix_sync(Ss + ti * 16 * lds + tj * 16, s, lds, wmma::mem_row_major);
    }
    __syncthreads();

    // online softmax: tpr neighbouring lanes share a row, `per` keys each
    {
      const float* srow = Ss + sr * lds + part * per;
      T* prow = Ps + sr * ldp + part * per;
      const int kb = kv0 + part * per;
      float mx = -INFINITY;
      for (int c = 0; c < per; ++c) {
        if (kb + c < a.sk) {
          const float x = srow[c] * a.scale_log2 + (bias ? bias[kb + c] * LOG2E : 0.f);
          mx = fmaxf(mx, x);
        }
      }
      const float m_old = m_s[sr];
      for (int o = 1; o < tpr; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = 0; c < per; ++c) {
        float pv = 0.f;
        if (kb + c < a.sk) {
          const float x = srow[c] * a.scale_log2 + (bias ? bias[kb + c] * LOG2E : 0.f);
          pv = exp2f(x - m_new);
        }
        sum += pv;
        prow[c] = from_f32<T>(pv);
      }
      for (int o = 1; o < tpr; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();  // every lane of the row has read m_old
      if (part == 0) {
        const float alpha = exp2f(m_old - m_new);
        m_s[sr] = m_new;
        l_s[sr] = l_s[sr] * alpha + sum;
        al_s[sr] = alpha;
      }
    }
    cp_async_wait<0>();  // this tile's V has arrived
    __syncthreads();
    if (kv0 + bk < a.sk) load_tile(Ks, K, a.k_ss, kv0 + bk);  // in flight during P·V

    // O = O · alpha + P V on this warp's slice
#pragma unroll
    for (int t = 0; t < MAXT; ++t) {
      if (wc + t * L.wc < ncol) {
#pragma unroll
        for (int i = 0; i < NE; ++i) acc[t].x[i] *= al_s[wr * 16 + rmap[i]];
      }
    }
    for (int kk = 0; kk < bk; kk += MT::K) {
      typename MT::ARow af;
      wmma::load_matrix_sync(af, Ps + wr * 16 * ldp + kk, ldp);
      MT::prep(af);
#pragma unroll
      for (int t = 0; t < MAXT; ++t) {
        const int ct = wc + t * L.wc;
        if (ct < ncol) {
          typename MT::BRow bf;
          wmma::load_matrix_sync(bf, Vs + kk * ldq + ct * 16, ldq);
          MT::prep(bf);
          wmma::mma_sync(acc[t], af, bf, acc[t]);
        }
      }
    }
    __syncthreads();  // V, S and P are free for the next tile
  }

#pragma unroll
  for (int t = 0; t < MAXT; ++t) {
    const int ct = wc + t * L.wc;
    if (ct < ncol) {
#pragma unroll
      for (int i = 0; i < NE; ++i) {
        const int r = wr * 16 + rmap[i], c = ct * 16 + cmap[i], q = q0 + r;
        if (q < a.sq && c < a.d)
          O[(long long)q * a.o_ss + c] = from_f32<T>(acc[t].x[i] / l_s[r]);
      }
    }
  }
  if (a.lse) {
    for (int r = tid; r < L.bq; r += FA_NT)
      if (q0 + r < a.sq) a.lse[(long long)bh * a.sq + q0 + r] = m_s[r] + log2f(l_s[r]);
  }
}

template <typename T, int MAXT>
cudaError_t launch(const FlashArgs& a, int BH, int wr, cudaStream_t stream) {
  FlashLayout L = flash_layout<T>(a.d, wr, 64);
  for (int bk = 32; bk >= 16 && L.total > FA_MAX_SMEM; bk /= 2) L = flash_layout<T>(a.d, wr, bk);
  if (L.total > FA_MAX_SMEM || (L.dp / 16 + L.wc - 1) / L.wc > MAXT)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, MAXT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return err;
  dim3 grid((a.sq + L.bq - 1) / L.bq, BH);
  flash_kernel<T, MAXT><<<grid, FA_NT, L.total, stream>>>(a, L);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_for_d(const FlashArgs& a, int BH, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const long long strides[] = {a.q_sb, a.q_sh, a.q_ss, a.k_sb, a.k_sh, a.k_ss,
                               a.v_sb, a.v_sh, a.v_ss, a.o_sb, a.o_sh, a.o_ss};
  for (long long s : strides)
    if (s % VEC) return cudaErrorInvalidValue;
  if (a.d <= 0 || a.d % VEC || a.d > FA_MAX_D || a.sq <= 0 || a.sk <= 0 || a.n_head <= 0 ||
      BH % a.n_head)
    return cudaErrorInvalidValue;
  // narrow heads: 128 query rows, all columns per warp (up to 10 tiles = 160);
  // wide heads: 64 query rows, 2 column groups of up to 16 tiles (512)
  if ((a.d + 15) / 16 <= 10) return launch<T, 10>(a, BH, 8, stream);
  return launch<T, 16>(a, BH, 4, stream);
}

}  // namespace
}  // namespace sdk

// q, k, v, o: element (b, h, row, col) at ptr + b*sb + h*sh + row*ss + col for
// batch element b = bh / n_head and head h = bh % n_head, bh < BH; rows of q
// and o < sq, of k and v < sk; col < d. bias: [BH / n_head][sk] f32 or null.
// lse: [BH][sq] f32 written with each row's log2-domain log-sum-exp, or null.
extern "C" int sdk_flash_attention(int dtype, const void* q, const void* k, const void* v,
                                   void* o, long long q_sb, long long q_sh, long long q_ss,
                                   long long k_sb, long long k_sh, long long k_ss,
                                   long long v_sb, long long v_sh, long long v_ss,
                                   long long o_sb, long long o_sh, long long o_ss,
                                   const float* bias, float* lse, int BH, int n_head, int sq,
                                   int sk, int d, float scale, void* stream) {
  sdk::FlashArgs a{q, k, v, o, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                   o_sb, o_sh, o_ss, bias, lse, n_head, sq, sk, d, scale * sdk::LOG2E};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == sdk::kBF16) return (int)sdk::launch_for_d<__nv_bfloat16>(a, BH, s);
  if (dtype == sdk::kF32) return (int)sdk::launch_for_d<float>(a, BH, s);
  return (int)cudaErrorInvalidValue;
}
