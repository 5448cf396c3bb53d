// Attention core of K10, sdtpu/ops/fused_cross_attention.py
// (fused_cross_attention_kv and fused_cross_attention): per head,
// softmax(q k^T · d^-1/2 + key bias) v over a short key set, the text
// context (77 tokens). The route of the shapes neither Hopper route (bf16:
// csrc/attention_sm90.cu, f32: csrc/attention_tf32_sm90.cu) has a plan for,
// and the route they are timed against (route "wmma").
//
// Inputs: q [B, S, C] (the LN(x)·Wq product of the shared GEMM), kt and vt
// [B, C, Sk] (sdtpu's transposed layout) read through their strides, so a
// transposed view of a [B, Sk, C] projection needs no copy; an optional
// key mask [B, Sk] of bytes (torch.bool), read as sdtpu's key bias: 0 for a
// real key, -1e30 for a padded one. Output
// [B, S, C] with the heads merged, the operand of the out-projection GEMM.
//
// What bounds it on the H100: 4·S·Sk·C flops against 4·S·C bytes of q and
// out (bf16), about Sk = 77 flops a byte: below the tensor cores' ridge
// (about 295), so it is bound by the bytes of q and out. The design keeps
// everything else on chip: with at most 128 keys one (batch, head)'s K^T and
// V^T fit in shared memory once (dh x Sk, 49 KB in bf16 at d = 160), each
// block stages them once and serves a tile of up to 128 query rows, and the
// scores and probabilities never leave the SM. The softmax is the TPU
// body's own: one max, exp and sum over all keys per row (one key tile, no
// online rescale). Products are WMMA (bf16 m16n16k16, f32 as TF32); the head
// dims 40/80/160 and the 77 keys are padded with zeros to multiples of 16 in
// shared memory, the padded keys excluded from the softmax. Simple first:
// each warp owns 16 query rows; a lane pair owns one row's softmax.
#include "common.cuh"

namespace sdk {
namespace {

constexpr int MAX_NT = 256, MAX_DH = 160, MAX_SK = 128;
constexpr size_t MAX_SMEM = 227 * 1024;
constexpr float LOG2E = 1.4426950408889634f;

struct XLayout {
  int bq, dp, skp, ldq, ldk, ldw, ldp;
  size_t q, kt, vt, w, p, total;
};

template <typename T>
XLayout xlayout(int dh, int sk, int bq) {
  const int nw = bq / 16;
  XLayout L;
  L.bq = bq;
  L.dp = (dh + 15) / 16 * 16;
  L.skp = (sk + 15) / 16 * 16;
  L.ldq = L.dp + 8;                                      // Q tile [bq][dp] (T)
  L.ldk = L.skp + 8;                                     // K^T, V^T [dp][skp] (T)
  L.ldw = (L.skp > L.dp ? L.skp : L.dp) + 4;             // per warp: scores, then P·V (f32)
  L.ldp = L.skp + 8;                                     // per warp: probabilities (T)
  L.q = 0;
  L.kt = align128(L.q + sizeof(T) * bq * L.ldq);
  L.vt = align128(L.kt + sizeof(T) * L.dp * L.ldk);
  L.w = align128(L.vt + sizeof(T) * L.dp * L.ldk);
  L.p = align128(L.w + sizeof(float) * nw * 16 * L.ldw);
  L.total = align128(L.p + sizeof(T) * nw * 16 * L.ldp);
  return L;
}

template <typename T>
__device__ __forceinline__ void stage_t(T* dst, int ld, const T* src, long long sc, long long sj,
                                        int dh, int sk, int tid, int nt) {
  // dst[d][j] = src[d * sc + j * sj]; consecutive threads walk the dimension
  // whose stride is 1, so the loads coalesce for either layout
  const int n = dh * sk;
  const bool d_fast = sc == 1;
  for (int i = tid; i < n; i += nt) {
    const int d = d_fast ? i % dh : i / sk, j = d_fast ? i / dh : i % sk;
    dst[d * ld + j] = src[d * sc + j * sj];
  }
}

template <typename T>
__global__ void __launch_bounds__(MAX_NT)
cross_attention_kernel(const T* __restrict__ q, const T* __restrict__ kt,
                       const T* __restrict__ vt, long long ksb, long long ksc, long long ksj,
                       long long vsb, long long vsc, long long vsj,
                       const unsigned char* __restrict__ valid, T* __restrict__ out, int S,
                       int C,
                       int Sk, int dh, float scale_log2, XLayout L) {
  using MT = Mma<T>;
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L.q);
  T* Ks = reinterpret_cast<T*>(smem + L.kt);
  T* Vs = reinterpret_cast<T*>(smem + L.vt);

  const int nt = blockDim.x, tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int dp = L.dp, skp = L.skp, ldq = L.ldq, ldk = L.ldk, ldw = L.ldw, ldp = L.ldp;
  float* Ww = reinterpret_cast<float*>(smem + L.w) + warp * 16 * ldw;
  T* Pw = reinterpret_cast<T*>(smem + L.p) + warp * 16 * ldp;
  const int q0 = blockIdx.x * L.bq, h = blockIdx.y, b = blockIdx.z;
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);

  // zero everything once: the padded rows and columns stay zero
  for (size_t i = tid; i < L.total / 16; i += nt) reinterpret_cast<uint4*>(smem)[i] = zero4;
  __syncthreads();

  const int vpr = dh / VEC;
  const T* Q = q + (long long)b * S * C + (long long)h * dh;
  for (int i = tid; i < L.bq * vpr; i += nt) {
    const int r = i / vpr, c = i % vpr * VEC, row = q0 + r;
    if (row < S)
      *reinterpret_cast<uint4*>(Qs + r * ldq + c) =
          *reinterpret_cast<const uint4*>(Q + (long long)row * C + c);
  }
  stage_t(Ks, ldk, kt + b * ksb + (long long)h * dh * ksc, ksc, ksj, dh, Sk, tid, nt);
  stage_t(Vs, ldk, vt + b * vsb + (long long)h * dh * vsc, vsc, vsj, dh, Sk, tid, nt);
  __syncthreads();

  // scores for this warp's 16 rows x all keys: Q [16, dp] · K^T [dp, skp]
  for (int j = 0; j < skp; j += 16) {
    typename MT::Acc acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < dp; kk += MT::K) {
      typename MT::ARow af;
      typename MT::BRow bf;
      wmma::load_matrix_sync(af, Qs + warp * 16 * ldq + kk, ldq);
      wmma::load_matrix_sync(bf, Ks + kk * ldk + j, ldk);
      MT::prep(af);
      MT::prep(bf);
      wmma::mma_sync(acc, af, bf, acc);
    }
    wmma::store_matrix_sync(Ww + j, acc, ldw, wmma::mem_row_major);
  }
  __syncwarp();

  // one softmax pass over all keys (log2 domain, scale and bias folded in);
  // lane pair (2r, 2r+1) owns row r, the keys interleaved between the two
  const int lr = lane / 2, half = lane % 2;
  const unsigned char* vrow = valid == nullptr ? nullptr : valid + (long long)b * Sk;
  float* srow = Ww + lr * ldw;
  float mx = -INFINITY;
  for (int j = half; j < Sk; j += 2) {
    const float s = srow[j] * scale_log2 + (vrow == nullptr || vrow[j] ? 0.f : -1e30f * LOG2E);
    srow[j] = s;
    mx = fmaxf(mx, s);
  }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  float sum = 0.f;
  T* prow = Pw + lr * ldp;
  for (int j = half; j < skp; j += 2) {
    const float p = j < Sk ? exp2f(srow[j] - mx) : 0.f;
    sum += p;
    prow[j] = from_f32<T>(p);
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  __syncwarp();

  // P [16, skp] · V [skp, dp], V read as V^T in column-major form; the f32
  // result replaces the consumed scores
  for (int dj = 0; dj < dp; dj += 16) {
    typename MT::Acc acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < skp; kk += MT::K) {
      typename MT::ARow af;
      typename MT::BCol bf;
      wmma::load_matrix_sync(af, Pw + kk, ldp);
      wmma::load_matrix_sync(bf, Vs + dj * ldk + kk, ldk);
      MT::prep(af);
      MT::prep(bf);
      wmma::mma_sync(acc, af, bf, acc);
    }
    wmma::store_matrix_sync(Ww + dj, acc, ldw, wmma::mem_row_major);
  }
  __syncwarp();

  const int row = q0 + warp * 16 + lr;
  if (row < S) {
    const float inv = 1.f / sum;
    const float* orow = Ww + lr * ldw;
    T* o = out + ((long long)b * S + row) * C + (long long)h * dh;
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
cudaError_t launch(const void* q, const void* kt, const void* vt, long long ksb, long long ksc,
                   long long ksj, long long vsb, long long vsc, long long vsj,
                   const unsigned char* valid, void* out, int B, int S, int C, int Sk,
                   int n_head,
                   float scale, cudaStream_t stream) {
  const int dh = C / n_head;
  if (dh * n_head != C || dh > MAX_DH || dh % 8 || C % 8 || Sk < 1 || Sk > MAX_SK)
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
  XLayout L = xlayout<T>(dh, Sk, 128);
  while (L.bq > 32 &&
         (L.total > MAX_SMEM || (long long)((S + L.bq - 1) / L.bq) * n_head * B < sms))
    L = xlayout<T>(dh, Sk, L.bq / 2);
  if (L.total > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      cross_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return err;
  dim3 grid((S + L.bq - 1) / L.bq, n_head, B);
  cross_attention_kernel<T><<<grid, L.bq / 16 * 32, L.total, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kt), static_cast<const T*>(vt), ksb,
      ksc, ksj, vsb, vsc, vsj, valid, static_cast<T*>(out), S, C, Sk, dh, scale * LOG2E, L);
  return cudaGetLastError();
}

}  // namespace
}  // namespace sdk

extern "C" int sdk_cross_attention(int dtype, const void* q, const void* kt, const void* vt,
                                   long long ksb, long long ksc, long long ksj, long long vsb,
                                   long long vsc, long long vsj, const void* valid, void* out,
                                   int B, int S, int C, int Sk, int n_head, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* v = static_cast<const unsigned char*>(valid);
  if (dtype == sdk::kBF16)
    return (int)sdk::launch<__nv_bfloat16>(q, kt, vt, ksb, ksc, ksj, vsb, vsc, vsj, v, out, B,
                                           S, C, Sk, n_head, scale, s);
  if (dtype == sdk::kF32)
    return (int)sdk::launch<float>(q, kt, vt, ksb, ksc, ksj, vsb, vsc, vsj, v, out, B, S, C,
                                   Sk, n_head, scale, s);
  return (int)cudaErrorInvalidValue;
}
