// K8, sdtpu/ops/fused_groupnorm.py:group_norm_silu — the normalise pass
// y = silu(x * scale[b, c] + bias[b, c]) of a channels-last map [B, rows, C],
// with the GroupNorm folded into a per-(batch, channel) f32 affine from
// per-channel statistics (K3's, or those a K6/K7 epilogue emitted).
//
// What bounds it on the H100: one read and one write of the map (67 MB in
// bf16 at the VAE decoder's 512x512x128 output, where it runs) and a few
// flops per element: bandwidth-bound. The TPU kernel walked row blocks in
// order; here each thread moves 16-byte vectors of neighbouring channels
// over a grid-stride loop, with the f32 scale and bias read through the
// cache (B x C floats).
#include "common.cuh"

namespace sdk {
namespace {

template <typename T>
__global__ void __launch_bounds__(256)
group_norm_silu_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                       const float* __restrict__ bias, T* __restrict__ out,
                       long long rows, int C, int silu, long long nvec) {
  constexpr int VEC = 16 / sizeof(T);
  const int cv = C / VEC;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < nvec;
       i += (long long)gridDim.x * blockDim.x) {
    const long long pix = i / cv;
    const int c = (int)(i - pix * cv) * VEC;
    const long long bc = pix / rows * C + c;
    uint4 raw = reinterpret_cast<const uint4*>(x)[i];
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float y = to_f32(e[j]) * __ldg(scale + bc + j) + __ldg(bias + bc + j);
      if (silu) y = y / (1.f + expf(-y));
      e[j] = from_f32<T>(y);
    }
    reinterpret_cast<uint4*>(out)[i] = raw;
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* scale, const float* bias, void* out,
                   int B, long long rows, int C, int silu, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (C % VEC) return cudaErrorInvalidValue;
  const long long nvec = (long long)B * rows * C / VEC;
  const long long want = (nvec + 255) / 256;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);  // at most 16 per SM
  group_norm_silu_kernel<T><<<blocks > 0 ? blocks : 1, 256, 0, stream>>>(
      static_cast<const T*>(x), scale, bias, static_cast<T*>(out), rows, C, silu, nvec);
  return cudaGetLastError();
}

}  // namespace
}  // namespace sdk

// x, out: [B][rows][C]; scale, bias: [B][C] f32.
extern "C" int sdk_group_norm_silu(int dtype, const void* x, const float* scale,
                                   const float* bias, void* out, int B, long long rows,
                                   int C, int silu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == sdk::kBF16)
    return (int)sdk::launch<__nv_bfloat16>(x, scale, bias, out, B, rows, C, silu, s);
  if (dtype == sdk::kF32)
    return (int)sdk::launch<float>(x, scale, bias, out, B, rows, C, silu, s);
  return (int)cudaErrorInvalidValue;
}
