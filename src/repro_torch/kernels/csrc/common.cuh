// Shared helpers of the port's CUDA kernels (sm_90a). Each kernel file
// is its own shared library with a plain C interface, loaded with
// ctypes; every entry point returns cudaGetLastError() after its launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The expert FFNs' activations (act 0 = silu, 1 = tanh-gelu, as
// jax.nn.gelu's default) and their derivatives. act(0) = 0 for both, so
// zero rows (padded slots, dead blocks) give zero hidden rows.
__device__ __forceinline__ float act_fn(float x, int act) {
  if (act == 0) return x / (1.f + expf(-x));  // silu
  const float k0 = 0.7978845608028654f;       // sqrt(2/pi), tanh-gelu
  return 0.5f * x * (1.f + tanhf(k0 * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ float act_grad(float x, int act) {
  if (act == 0) {
    const float s = 1.f / (1.f + expf(-x));
    return s * (1.f + x * (1.f - s));
  }
  const float k0 = 0.7978845608028654f, c = 0.044715f;
  const float t = tanhf(k0 * (x + c * x * x * x));
  return 0.5f * (1.f + t) +
         0.5f * x * (1.f - t * t) * k0 * (1.f + 3.f * c * x * x);
}

// Raise the dynamic shared-memory cap when a launch needs more than the
// default 48 KB; a refused size surfaces through cudaGetLastError().
template <typename K>
static inline void allow_smem(K kernel, size_t bytes) {
  if (bytes > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
  }
}

// PyTorch hands its current stream over as a plain handle; 0 is its
// default stream, the context's legacy stream. Name that one explicitly
// so the launch orders with PyTorch's work however this library's
// runtime treats the null handle.
static inline cudaStream_t torch_stream(void* stream) {
  return stream ? (cudaStream_t)stream : cudaStreamLegacy;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Online-softmax statistics of one query row over one kv block, the
// (m, l) half of the flash-attention recurrence: `s` holds the row's
// scores (masked entries are ignored through `valid`), overwritten by
// the probabilities p = exp(s - m_new). Called by one whole warp.
// Returns alpha = exp(m_old - m_new), the factor the row's accumulator
// is rescaled by; m and l are updated in place by lane 0. A row with no
// valid key so far keeps m = -inf, l = 0 and gets alpha = 0.
template <typename Valid>
__device__ __forceinline__ float softmax_update(float* s, int n, Valid valid,
                                                float* m, float* l) {
  const int lane = threadIdx.x & 31;
  float mx = -INFINITY;
  for (int t = lane; t < n; t += 32) {
    if (valid(t)) mx = fmaxf(mx, s[t]);
  }
  for (int o = 16; o > 0; o >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }
  const float m_old = *m;
  const float m_new = fmaxf(m_old, mx);
  const float m_safe = isfinite(m_new) ? m_new : 0.f;
  float sum = 0.f;
  for (int t = lane; t < n; t += 32) {
    const float p = valid(t) ? expf(s[t] - m_safe) : 0.f;
    s[t] = p;
    sum += p;
  }
  for (int o = 16; o > 0; o >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
  }
  const float alpha = isfinite(m_old) ? expf(m_old - m_safe) : 0.f;
  __syncwarp();
  if (lane == 0) {
    *m = m_new;
    *l = *l * alpha + sum;
  }
  return alpha;
}
