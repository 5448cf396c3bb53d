// Attention core of K2, sdtpu/ops/fused_transformer.py:fused_self_attention
// (its per-head softmax(q k^T · d^-1/2) v).
//
// Input is the [B, S, 3C] output of the fused LN+QKV product (q | k | v,
// heads contiguous inside each), output is [B, S, C] with heads merged, so
// the split/merge transposes of the unfused path never exist in HBM.
//
// What bounds it on the H100: 4·S²·C flops per image against 8·S·C bytes,
// i.e. compute-bound at every UNet level (S = 256..4096). The [S, S] score
// matrix is the traffic the TPU kernel kept in VMEM; here it never leaves
// the SM either: one block per (q tile of 64 rows, head, batch) walks the
// keys in tiles of 64 with an online softmax (f32 max/sum per row), so
// shared memory holds one score tile per warp. The TPU kernel held all of K
// and V in VMEM (full-K softmax); 227 KB of shared memory cannot, hence the
// online form. Head dims 40/80/160 are not multiples of the tensor-core
// depth: tiles are padded with zeros to a multiple of 16 in shared memory.
// Simple first: each warp owns 16 query rows (8, 4 or 2 warps for a q tile
// of 128, 64 or 32 rows, by shared memory and grid size); the output
// accumulator lives in shared memory (f32) so each row can be rescaled by
// plain threads. Tiles move as 16-byte vectors (d_head % 8 == 0, which the
// UNet's gate already requires); the zero padding is written once.
#include "common.cuh"

namespace sdk {
namespace {

constexpr int BKV = 64, MAX_NT = 256;
constexpr int LDS = BKV + 4;  // f32 score tile pitch
constexpr int LDP = BKV + 8;  // probability tile pitch (T)
constexpr int MAX_DH = 160;
constexpr size_t MAX_SMEM = 227 * 1024;

struct Layout {
  int bq, dp, ldq, ldo;
  size_t q, k, v, s, pr, o, total;
};

template <typename T>
Layout layout(int dh, int bq) {
  const int nw = bq / 16;
  Layout L;
  L.bq = bq;
  L.dp = (dh + 15) / 16 * 16;
  L.ldq = L.dp + 8;
  L.ldo = L.dp + 4;
  L.q = 0;
  L.k = L.q + sizeof(T) * bq * L.ldq;
  L.v = L.k + sizeof(T) * BKV * L.ldq;
  L.s = L.v + sizeof(T) * BKV * L.ldq;
  L.pr = L.s + sizeof(float) * nw * 16 * LDS;
  L.o = L.pr + sizeof(T) * nw * 16 * LDP;
  L.total = L.o + sizeof(float) * nw * 16 * L.ldo;
  return L;
}

template <typename T>
__global__ void __launch_bounds__(MAX_NT)
attention_kernel(const T* __restrict__ qkv, T* __restrict__ out, int S, int C,
                 int dh, float scale_log2, Layout L) {
  using MT = Mma<T>;
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L.q);
  T* Ks = reinterpret_cast<T*>(smem + L.k);
  T* Vs = reinterpret_cast<T*>(smem + L.v);

  const int nt = blockDim.x, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* Sw = reinterpret_cast<float*>(smem + L.s) + warp * 16 * LDS;
  T* Pw = reinterpret_cast<T*>(smem + L.pr) + warp * 16 * LDP;
  float* Ow = reinterpret_cast<float*>(smem + L.o) + warp * 16 * L.ldo;

  const int q0 = blockIdx.x * L.bq, h = blockIdx.y, b = blockIdx.z;
  const int dp = L.dp, ldq = L.ldq, ldo = L.ldo, vpr = dh / VEC;
  const long long ld = 3LL * C;
  const T* Q = qkv + (long long)b * S * ld + (long long)h * dh;
  const T* Kg = Q + C;
  const T* Vg = Q + 2 * C;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);

  // zero everything once: the padded columns dh..dp stay zero, since the
  // tile loads below write only columns < dh
  for (size_t i = tid; i < L.total / 16; i += nt) reinterpret_cast<uint4*>(smem)[i] = zero4;
  __syncthreads();
  for (int i = tid; i < L.bq * vpr; i += nt) {
    const int r = i / vpr, c = i % vpr * VEC, q = q0 + r;
    if (q < S)
      *reinterpret_cast<uint4*>(Qs + r * ldq + c) =
          *reinterpret_cast<const uint4*>(Q + (long long)q * ld + c);
  }

  // softmax state: lane pair (2r, 2r+1) owns row r of the warp's 16 rows;
  // scores are kept in the log2 domain (scale folded with log2(e))
  const int lr = lane / 2, half = lane % 2;
  float m_i = -INFINITY, l_i = 0.f;

  for (int kv0 = 0; kv0 < S; kv0 += BKV) {
    __syncthreads();  // previous K/V tile fully consumed (and Q staged)
    for (int i = tid; i < BKV * vpr; i += nt) {
      const int r = i / vpr, c = i % vpr * VEC, kv = kv0 + r;
      uint4 kr = zero4, vr = zero4;
      if (kv < S) {
        const long long off = (long long)kv * ld + c;
        kr = *reinterpret_cast<const uint4*>(Kg + off);
        vr = *reinterpret_cast<const uint4*>(Vg + off);
      }
      *reinterpret_cast<uint4*>(Ks + r * ldq + c) = kr;
      *reinterpret_cast<uint4*>(Vs + r * ldq + c) = vr;
    }
    __syncthreads();

    // scores for this warp's 16 rows x 64 keys
#pragma unroll
    for (int j = 0; j < BKV / 16; ++j) {
      typename MT::Acc acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < dp; kk += MT::K) {
        typename MT::ARow af;
        typename MT::BCol bf;
        wmma::load_matrix_sync(af, Qs + warp * 16 * ldq + kk, ldq);
        wmma::load_matrix_sync(bf, Ks + j * 16 * ldq + kk, ldq);
        MT::prep(af);
        MT::prep(bf);
        wmma::mma_sync(acc, af, bf, acc);
      }
      wmma::store_matrix_sync(Sw + j * 16, acc, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this row's 64 scores (32 per lane of the pair)
    const float* srow = Sw + lr * LDS + half * 32;
    T* prow = Pw + lr * LDP + half * 32;
    const int nvalid = min(32, max(0, S - (kv0 + half * 32)));
    float mx = -INFINITY;
    for (int c = 0; c < nvalid; ++c) mx = fmaxf(mx, srow[c] * scale_log2);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);
    const float alpha = exp2f(m_i - m_new);
    float sum = 0.f;
    for (int c = 0; c < 32; ++c) {
      const float pv = c < nvalid ? exp2f(srow[c] * scale_log2 - m_new) : 0.f;
      sum += pv;
      prow[c] = from_f32<T>(pv);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_i = l_i * alpha + sum;
    m_i = m_new;
    float* orow = Ow + lr * ldo;
    for (int d = half; d < dp; d += 2) orow[d] *= alpha;
    __syncwarp();

    // O += P V
    for (int dj = 0; dj < dp; dj += 16) {
      typename MT::Acc acc;
      wmma::load_matrix_sync(acc, Ow + dj, ldo, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BKV; kk += MT::K) {
        typename MT::ARow af;
        typename MT::BRow bf;
        wmma::load_matrix_sync(af, Pw + kk, LDP);
        wmma::load_matrix_sync(bf, Vs + kk * ldq + dj, ldq);
        MT::prep(af);
        MT::prep(bf);
        wmma::mma_sync(acc, af, bf, acc);
      }
      wmma::store_matrix_sync(Ow + dj, acc, ldo, wmma::mem_row_major);
    }
    __syncwarp();
  }

  const int q = q0 + warp * 16 + lr;
  if (q < S) {
    const float inv = 1.f / l_i;
    const float* orow = Ow + lr * ldo;
    T* o = out + ((long long)b * S + q) * C + (long long)h * dh;
    for (int c = half * VEC; c < dh; c += 2 * VEC) {
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) e[j] = from_f32<T>(orow[c + j] * inv);
      *reinterpret_cast<uint4*>(o + c) = raw;
    }
  }
}

template <typename T>
cudaError_t launch(const void* qkv, void* out, int B, int S, int C, int n_head,
                   float scale, cudaStream_t stream) {
  const int dh = C / n_head;
  if (dh * n_head != C || dh > MAX_DH || dh % (16 / sizeof(T)) || C % 8)
    return cudaErrorInvalidValue;
  // the largest q tile (128, 64 or 32 rows: 8, 4 or 2 warps) that fits in
  // shared memory and still gives at least one block per SM
  static int sms = 0;  // the card's SM count, asked once
  if (sms == 0) {
    int dev = 0, n = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    sms = n;
  }
  Layout L = layout<T>(dh, 128);
  while (L.bq > 32 &&
         (L.total > MAX_SMEM || (long long)((S + L.bq - 1) / L.bq) * n_head * B < sms))
    L = layout<T>(dh, L.bq / 2);
  if (L.total > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return err;
  dim3 grid((S + L.bq - 1) / L.bq, n_head, B);
  attention_kernel<T><<<grid, L.bq / 16 * 32, L.total, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), S, C, dh,
      scale * 1.4426950408889634f, L);
  return cudaGetLastError();
}

}  // namespace
}  // namespace sdk

extern "C" int sdk_attention(int dtype, const void* qkv, void* out, int B, int S,
                             int C, int n_head, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == sdk::kBF16)
    return (int)sdk::launch<__nv_bfloat16>(qkv, out, B, S, C, n_head, scale, s);
  if (dtype == sdk::kF32)
    return (int)sdk::launch<float>(qkv, out, B, S, C, n_head, scale, s);
  return (int)cudaErrorInvalidValue;
}
