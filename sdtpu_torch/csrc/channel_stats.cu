// K3, sdtpu/ops/fused_groupnorm.py:channel_partials — per-channel f32
// (sum x, sum x^2) of a channels-last map [B, rows, C].
//
// What bounds it on the H100: one read of the map (5.2 MB in bf16 at the
// UNet's 64x64x320 level, batch 2) and no arithmetic to speak of, so it is
// bandwidth- and latency-bound. The TPU kernel walked the rows sequentially
// per batch element; here the rows are split over `nsplit` blocks so that
// enough blocks fill the 132 SMs, each block writes its partial sums, and the
// caller adds the nsplit partials (as the TPU wrapper adds its per-block
// partials). A block is 32 channels x 8 row lanes: a warp reads 32
// neighbouring channels of one row.
#include "common.cuh"

namespace sdk {
namespace {

template <typename T>
__global__ void __launch_bounds__(256)
channel_partials_kernel(const T* __restrict__ x, float* __restrict__ part,
                        int rows, int C, int chunk) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * 32 + tx, split = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.y;
  const int r0 = split * chunk;
  const int r1 = min(rows, r0 + chunk);
  float s1 = 0.f, s2 = 0.f;
  if (c < C) {
    const T* xb = x + (long long)b * rows * C + c;
    for (int r = r0 + ty; r < r1; r += 8) {
      const float v = to_f32(xb[(long long)r * C]);
      s1 += v;
      s2 += v * v;
    }
  }
  __shared__ float sh[2][8][33];
  sh[0][ty][tx] = s1;
  sh[1][ty][tx] = s2;
  __syncthreads();
  if (ty == 0 && c < C) {
    float t1 = 0.f, t2 = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      t1 += sh[0][i][tx];
      t2 += sh[1][i][tx];
    }
    float* p = part + ((long long)b * nsplit + split) * 2 * C;
    p[c] = t1;
    p[C + c] = t2;
  }
}

template <typename T>
cudaError_t launch(const void* x, float* part, int B, int rows, int C, int nsplit,
                   cudaStream_t stream) {
  const int chunk = (rows + nsplit - 1) / nsplit;
  dim3 grid((C + 31) / 32, nsplit, B), block(32, 8);
  channel_partials_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), part, rows, C, chunk);
  return cudaGetLastError();
}

}  // namespace
}  // namespace sdk

// part: [B][nsplit][2][C] f32.
extern "C" int sdk_channel_partials(int dtype, const void* x, float* part, int B,
                                    int rows, int C, int nsplit, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == sdk::kBF16)
    return (int)sdk::launch<__nv_bfloat16>(x, part, B, rows, C, nsplit, s);
  if (dtype == sdk::kF32) return (int)sdk::launch<float>(x, part, B, rows, C, nsplit, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* sdk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
