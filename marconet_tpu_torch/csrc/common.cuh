// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel here does its arithmetic in f32 and rounds once on store, so
// its plain PyTorch twin (which computes in f32 and casts once) gives the
// same bits. Element types are selected by a dtype code from the wrapper.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace marconet {

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// kVec consecutive channels, moved as one access (16 bytes when kVec > 1)
template <typename T, int kVec>
struct alignas(sizeof(T) * kVec) Pack {
  T e[kVec];
};

}  // namespace marconet
