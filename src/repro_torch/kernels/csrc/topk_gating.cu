// Top-k MoE router gating, for sm_90a: softmax over the E experts of each
// token, k first-maximum sweeps, and the dense (T, E) combine matrix
// renormalised over the chosen experts.
//
// Replaces the Pallas TPU kernel `_gate_kernel` of
// src/repro/kernels/topk_gating.py (`topk_gating`) and follows it step by
// step: probs = exp(x - max) / sum in fp32; each of the k sweeps takes the
// row maximum `top` of what remains, adds it to `total`, and selects the
// first entry (lowest expert index) equal to `top` among those still > 0,
// which it zeroes in what remains; so fewer than k experts are chosen where
// probabilities underflow to 0.  The output is probs / max(total, 1e-9) at
// the chosen experts and 0 elsewhere.
//
// What bounds it on an H100: bytes.  The work per element is a few
// operations; the least time is reading the (T, E) logits once and writing
// the (T, E) fp32 result once at the memory rate.  At the granite-moe router
// shape (T 8192, E 40, fp32) that is 2.6 MB, under a microsecond, so the
// kernel is launch-bound.
//
// Design.  One warp owns one token row: lane l holds experts l + 32 i in
// registers (VPL values per lane, E <= 32 * VPL <= 1024), reads and writes
// them coalesced, and every reduction (the softmax max and sum, each
// sweep's maximum with the lowest index on ties) is a warp butterfly of
// shuffles.  Nothing goes through shared memory, and no block-wide barrier
// is needed.
//
// Plain C interface for ctypes; each entry returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kWarps = 8;  // token rows per block
constexpr int kLanes = 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int VPL>
__global__ void __launch_bounds__(kWarps * kLanes)
topk_gating_kernel(const T* __restrict__ logits, float* __restrict__ out, int64_t t, int e,
                   int k) {
  const int lane = threadIdx.x % kLanes;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / kLanes;
  if (row >= t) return;  // whole warps leave together: row is uniform per warp
  const T* x = logits + row * e;

  float p[VPL];
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int idx = lane + kLanes * i;
    p[i] = idx < e ? to_f32(x[idx]) : -INFINITY;
    mx = fmaxf(mx, p[i]);
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    p[i] = lane + kLanes * i < e ? expf(p[i] - mx) : 0.0f;
    sum += p[i];
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);

  float rem[VPL];
  unsigned int picked = 0;  // bit i: expert lane + 32 i was chosen
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    p[i] = p[i] / sum;
    rem[i] = p[i];
  }
  float total = 0.0f;
  for (int s = 0; s < k; ++s) {
    // this lane's maximum, at its lowest index (indices rise with i)
    float bv = -INFINITY;
    int bi = 0x7fffffff;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      if (lane + kLanes * i < e && rem[i] > bv) {
        bv = rem[i];
        bi = lane + kLanes * i;
      }
    }
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    total += bv;
    if (bv > 0.0f && bi % kLanes == lane) {
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        if (lane + kLanes * i == bi) {
          rem[i] = 0.0f;
          picked |= 1u << i;
        }
      }
    }
  }
  const float denom = fmaxf(total, 1e-9f);
  float* orow = out + row * e;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int idx = lane + kLanes * i;
    if (idx < e) orow[idx] = (picked >> i) & 1u ? p[i] / denom : 0.0f;
  }
}

template <typename T, int VPL>
int launch_v(const void* logits, void* out, int64_t t, int e, int k, cudaStream_t stream) {
  const unsigned int blocks = static_cast<unsigned int>((t + kWarps - 1) / kWarps);
  topk_gating_kernel<T, VPL><<<blocks, kWarps * kLanes, 0, stream>>>(
      static_cast<const T*>(logits), static_cast<float*>(out), t, e, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* logits, void* out, int64_t t, int64_t e, int64_t k, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int ei = static_cast<int>(e), ki = static_cast<int>(k);
  if (e <= 32) return launch_v<T, 1>(logits, out, t, ei, ki, s);
  if (e <= 64) return launch_v<T, 2>(logits, out, t, ei, ki, s);
  if (e <= 128) return launch_v<T, 4>(logits, out, t, ei, ki, s);
  if (e <= 256) return launch_v<T, 8>(logits, out, t, ei, ki, s);
  if (e <= 512) return launch_v<T, 16>(logits, out, t, ei, ki, s);
  if (e <= 1024) return launch_v<T, 32>(logits, out, t, ei, ki, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

int repro_topk_gating_f32(const void* logits, void* out, int64_t t, int64_t e, int64_t k,
                          void* stream) {
  return launch<float>(logits, out, t, e, k, stream);
}

int repro_topk_gating_bf16(const void* logits, void* out, int64_t t, int64_t e, int64_t k,
                           void* stream) {
  return launch<__nv_bfloat16>(logits, out, t, e, k, stream);
}

}  // extern "C"
