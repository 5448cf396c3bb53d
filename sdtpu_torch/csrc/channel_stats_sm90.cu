// K3 on Hopper, sdtpu/ops/fused_groupnorm.py:channel_partials (its Pallas
// body `_stats_kernel` :28, called at :68): per-channel f32 (sum x, sum x^2)
// of a channels-last map [B, rows, C], C a multiple of 8, written as
// [B][2][C] in one launch. The partials kernel (csrc/channel_stats.cu, two launches) stays
// for other C.
//
// What bounds it on the H100: one read of the map and no arithmetic to speak
// of, so bytes, and at the UNet's sizes latency first: 64²×320 at B = 2 is
// 5.24 MB, 1.57 µs at 3.35 TB/s, about two and a half latency windows of
// HBM. The design keeps the whole map in flight at those sizes and does the
// sum across CTAs on the chip:
//
// - A CTA of 256 threads takes `cb` channels (64, or 32 where 64 would
//   leave SMs idle: the plan's choice; 16 is taken too) of one batch element: cb / 8
//   threads a row, each reading 8 neighbouring channels as 16-byte vectors
//   (one uint4 in bf16, two in f32), and 256·8 / cb row lanes. A warp reads
//   whole 32-byte sectors of 32·8 / cb rows at a time.
// - Each thread keeps CS_LOADS 16-byte loads in flight: its rows go in
//   batches whose loads (one predicated instruction each, zeros past the
//   last row) all issue before the batch's first add. (The partials kernel
//   has one scalar load a thread.) __launch_bounds__(CS_NT, 1) leaves ptxas the
//   registers to hold a whole batch; under the default bound it kept 40
//   registers and interleaved loads and adds.
// - The plan sizes the cluster so that a CTA reads about one batch a
//   thread, CS_NT·CS_LOADS·16 = 64 KB: the load time then is one round trip,
//   and what remains is the launch and one cluster barrier.
// - The CTAs of one thread-block cluster (`cluster` of them, up to 8, or 16
//   with the non-portable cluster size) split the rows of one (batch,
//   channel block). Each sums its threads' partials (shuffles across the row
//   lanes of a warp, then shared memory across warps) into a [2][cb] row,
//   which it stores into rank 0's shared memory through distributed shared
//   memory; after one cluster barrier rank 0 adds the ranks' rows in rank
//   order and writes the output. No second launch, no scratch, no atomics:
//   the sums come out in the same order on every call.
//
// The plan (cb, cluster) comes from Python
// (sdtpu_torch/ops/fused_groupnorm.py:stats_plan) and is checked here.
#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace sdk {
namespace {

constexpr int CS_NT = 256, CS_WARPS = CS_NT / 32, CS_MAX_CB = 64, CS_MAX_CLUSTER = 16;
// 16-byte loads a thread keeps in flight
constexpr int CS_LOADS = 16;

// 16 bytes from global memory through the non-coherent path when pred,
// else zeros: one predicated instruction, so that a batch of them issues
// back to back whatever the bounds
__device__ __forceinline__ uint4 ldg16(const uint4* p, bool pred) {
  uint4 v;
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %5, 0;\n"
      "mov.b32 %0, 0;\nmov.b32 %1, 0;\nmov.b32 %2, 0;\nmov.b32 %3, 0;\n"
      "@p ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n}\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "r"((int)pred));
  return v;
}

__device__ __forceinline__ void unpack8(const uint4 (&q)[1], float (&f)[8]) {
  const uint32_t w[4] = {q[0].x, q[0].y, q[0].z, q[0].w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}
__device__ __forceinline__ void unpack8(const uint4 (&q)[2], float (&f)[8]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    f[4 * h] = __uint_as_float(q[h].x);
    f[4 * h + 1] = __uint_as_float(q[h].y);
    f[4 * h + 2] = __uint_as_float(q[h].z);
    f[4 * h + 3] = __uint_as_float(q[h].w);
  }
}

// grid (C / cb channel blocks, cluster, B), clusters of (1, cluster, 1):
// rank q of a cluster sums rows [q·chunk, (q + 1)·chunk) of its block
template <typename T>
__global__ void __launch_bounds__(CS_NT, 1)
channel_stats_cluster_kernel(const T* __restrict__ x, float* __restrict__ out, int rows, int C,
                             int cb, int chunk) {
  constexpr int NQ = sizeof(T) / 2;          // uint4s a vector of 8 channels
  constexpr int UNROLL = CS_LOADS / NQ;      // rows a batch
  __shared__ float red[CS_WARPS][2][CS_MAX_CB];
  __shared__ float gather[CS_MAX_CLUSTER][2][CS_MAX_CB];  // rank 0's: every rank's row
  cg::cluster_group cluster = cg::this_cluster();
  const int nv = cb / 8, lanes = CS_NT / nv;
  const int v = threadIdx.x % nv, lane_r = threadIdx.x / nv;
  const int c0 = blockIdx.x * cb, c = c0 + 8 * v, b = blockIdx.z;
  const int rank = (int)cluster.block_rank();
  const int r0 = rank * chunk, r1 = min(rows, r0 + chunk);

  float s1[8], s2[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s1[i] = s2[i] = 0.f;
  if (c < C && r0 + lane_r < r1) {
    // this thread's rows: r0 + lane_r, then every `lanes`-th, in batches of
    // UNROLL whose loads all issue before the batch's first add
    const long long pitch = (long long)C * sizeof(T) / 16;  // uint4s from row to row
    const uint4* p =
        reinterpret_cast<const uint4*>(x + ((long long)b * rows + r0 + lane_r) * C + c);
    const long long step = lanes * pitch;
    const int n = (r1 - r0 - lane_r + lanes - 1) / lanes;
    for (int i = 0; i < n; i += UNROLL, p += UNROLL * step) {
      uint4 buf[UNROLL][NQ];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int q = 0; q < NQ; ++q) buf[u][q] = ldg16(p + u * step + q, i + u < n);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        float f[8];
        unpack8(buf[u], f);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          s1[k] += f[k];
          s2[k] = fmaf(f[k], f[k], s2[k]);
        }
      }
    }
  }
  // the row lanes of a warp that share this thread's channels are the
  // lanes v, v + nv, v + 2nv, ...
  for (int off = nv; off < 32; off <<= 1)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s1[i] += __shfl_xor_sync(0xffffffffu, s1[i], off);
      s2[i] += __shfl_xor_sync(0xffffffffu, s2[i], off);
    }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane < nv) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      red[warp][0][8 * lane + i] = s1[i];
      red[warp][1][8 * lane + i] = s2[i];
    }
  }
  __syncthreads();
  // this CTA's [2][cb] row, stored into rank 0's shared memory
  const int st = threadIdx.x / cb, cc = threadIdx.x % cb;
  if (threadIdx.x < 2 * cb) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < CS_WARPS; ++w) sum += red[w][st][cc];
    *cluster.map_shared_rank(&gather[rank][st][cc], 0) = sum;
  }
  cluster.sync();  // every rank's row is in rank 0's shared memory
  if (rank == 0 && threadIdx.x < 2 * cb && c0 + cc < C) {
    float sum = 0.f;
    const int n = (int)cluster.num_blocks();
    for (int q = 0; q < n; ++q) sum += gather[q][st][cc];
    out[((long long)b * 2 + st) * C + c0 + cc] = sum;
  }
}

template <typename T>
cudaError_t launch(const void* x, float* out, int B, int rows, int C, int cb, int cluster,
                   cudaStream_t stream) {
  auto kernel = channel_stats_cluster_kernel<T>;
  if (cluster > 8) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((C + cb - 1) / cb, cluster, B);
  cfg.blockDim = dim3(CS_NT);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int chunk = (rows + cluster - 1) / cluster;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), out, rows, C, cb,
                                       chunk);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
}  // namespace sdk

// out: [B][2][C] f32 (sum, sum of squares over the rows of x [B][rows][C]).
// C a multiple of 8, x 16-byte aligned; cb (channels a CTA) 16, 32 or 64;
// cluster (CTAs splitting the rows) 1 to 16, at most rows.
extern "C" int sdk_channel_stats_sm90(int dtype, const void* x, float* out, int B, int rows,
                                      int C, int cb, int cluster, void* stream) {
  if (B <= 0 || rows <= 0 || C <= 0 || C % 8 || (cb != 16 && cb != 32 && cb != 64) ||
      cluster < 1 || cluster > 16 || cluster > rows ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(out) % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == sdk::kBF16)
    return (int)sdk::launch<__nv_bfloat16>(x, out, B, rows, C, cb, cluster, s);
  if (dtype == sdk::kF32) return (int)sdk::launch<float>(x, out, B, rows, C, cb, cluster, s);
  return (int)cudaErrorInvalidValue;
}
