// Shared helpers for the sdtpu_torch Hopper kernels.
//
// Every kernel takes f32 or bf16 tensors and accumulates in f32. Tensor-core
// products go through WMMA (compiled to mma.sync): bf16 operands as
// m16n16k16, f32 operands as TF32 m16n16k8 (10-bit mantissa, f32
// accumulation).
#pragma once

#include <math.h>
#include <stddef.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace sdk {

namespace wmma = nvcuda::wmma;

// dtype codes shared with sdtpu_torch/kernels.py
enum DType { kF32 = 0, kBF16 = 1 };

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// WMMA fragment types per operand type. `prep` rounds f32 fragments to TF32
// as the tensor cores require; bf16 fragments need nothing.
template <typename T> struct Mma;

template <> struct Mma<__nv_bfloat16> {
  static constexpr int K = 16;
  using ARow = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
  using ACol = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
  using BRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
  using BCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  template <typename F> static __device__ __forceinline__ void prep(F&) {}
};

template <> struct Mma<float> {
  static constexpr int K = 8;
  using ARow = wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32, wmma::row_major>;
  using ACol = wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32, wmma::col_major>;
  using BRow = wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32, wmma::row_major>;
  using BCol = wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32, wmma::col_major>;
  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 8, float>;
  template <typename F> static __device__ __forceinline__ void prep(F& f) {
#pragma unroll
    for (int i = 0; i < f.num_elements; ++i) f.x[i] = wmma::__float_to_tf32(f.x[i]);
  }
};

inline size_t align128(size_t x) { return (x + 127) / 128 * 128; }

// 16-byte asynchronous copy global -> shared; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace sdk
