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
// shape (T 8192, E 40, fp32) that is 2.6 MB, under a microsecond.
//
// Design.  The row is held in registers and every reduction stays inside a
// warp: nothing goes through shared memory, and no block-wide barrier is
// needed.  What the card spends at router sizes is instruction slots for the
// reductions (a row takes k + 2 of them; a 5-step shuffle butterfly for a
// maximum with its lowest index costs 10 shuffles), so the kernel takes two
// layouts, chosen by E:
//  * E <= 56 (topk_gating_group_kernel): 32 / kGroup = 4 rows per warp,
//    each on a group of kGroup lanes; lane l holds experts l + kGroup m (V
//    values, E <= kGroup V, so at the granite-moe router's E 40 every slot
//    is used).  Each sweep's maximum, with its lowest index on ties, is a
//    3-step shuffle butterfly that serves the warp's four rows at once.
//    (REDUX cannot serve them: its one result is the warp's, and with a
//    per-group mask the compiler runs the groups one after another.)
//  * E > 56 (topk_gating_kernel): one row per warp, lane l holding experts
//    l + 32 i (VPL values, E <= 32 * VPL <= 1024).  Each sweep is two REDUX
//    instructions (__reduce_max_sync, then __reduce_min_sync) in place of a
//    10-shuffle butterfly, and the softmax maximum one more.
// Shared by both:
//  * What remains is kept as float bits, which order the values >= +0 as
//    the values do, so a maximum is an unsigned maximum of the bits.  A
//    chosen expert is one whose probability is > 0 and whose remainder is
//    0, so no chosen-set is kept beside the remainders.
//  * The softmax sum is taken in the order of PyTorch's warp softmax
//    (softmax_warp_forward: lane L of W = min(next_pow2(E), 32) lanes holds
//    experts L + W it, adds them in it order, then an xor butterfly over the
//    W lanes), so that probabilities, and with them ties, come out bit for
//    bit as torch.softmax's on the card.  REDUX adds integers only.
//  * The sweeps stop once no row of the warp has anything > 0 left: no later
//    sweep chooses anything, and adding 0 to `total` changes nothing.  (On
//    lane groups the vote is on each lane's own maximum, so it does not
//    wait for the butterfly.)
//
// Plain C interface for ctypes; each entry returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kWarps = 8;  // warps per block
constexpr int kLanes = 32;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// A float's bits mapped to an unsigned key in the values' order, any sign.
__device__ __forceinline__ unsigned ordered(float v) {
  const unsigned b = __float_as_uint(v);
  return b & 0x80000000u ? ~b : b | 0x80000000u;
}

__device__ __forceinline__ float from_ordered(unsigned key) {
  return __uint_as_float(key & 0x80000000u ? key & 0x7fffffffu : ~key);
}

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
  mx = from_ordered(__reduce_max_sync(kAll, ordered(mx)));
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    p[i] = expf(p[i] - mx);  // a slot past E holds -inf: exp gives +0, as in torch
    sum += p[i];
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(kAll, sum, off);

  unsigned rem[VPL];  // what remains, as bits: 0 where chosen (or past E)
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    p[i] = p[i] / sum;
    rem[i] = __float_as_uint(p[i]);
  }
  float total = 0.0f;
  for (int s = 0; s < k; ++s) {
    // this lane's maximum, at its lowest index (indices rise with i)
    unsigned best = 0;
    int slot = 0;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      if (rem[i] > best) {
        best = rem[i];
        slot = i;
      }
    }
    const unsigned top = __reduce_max_sync(kAll, best);
    if (top == 0) break;  // uniform across the warp
    const unsigned first = __reduce_min_sync(kAll, best == top ? slot * kLanes + lane : ~0u);
    total += __uint_as_float(top);
#pragma unroll
    for (int i = 0; i < VPL; ++i)
      if (static_cast<unsigned>(i * kLanes + lane) == first) rem[i] = 0;
  }
  const float denom = fmaxf(total, 1e-9f);
  float* orow = out + row * e;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int idx = lane + kLanes * i;
    if (idx < e) orow[idx] = rem[i] == 0 && p[i] > 0.0f ? p[i] / denom : 0.0f;
  }
}

constexpr int kGroup = 8;  // lanes per row for E <= kGroupMaxE
constexpr int kGroupMaxE = 56;  // above it, one row per warp with REDUX is faster

constexpr int next_pow2(int x) { return x <= 1 ? 1 : 2 * next_pow2((x + 1) / 2); }

// PyTorch's warp-softmax layout for E in (kGroup (V - 1), kGroup V]:
// P = next_pow2(E), W = min(P, 32) lanes, P / W values per lane.  On a group
// of kGroup lanes, lane l holds torch's lanes l + kGroup q (q < W / kGroup):
// its slot m = q + (W / kGroup) it is torch's value `it` of lane
// l + kGroup q, and the butterfly's steps at offsets >= kGroup are adds
// inside the lane.  (Where torch's W is below kGroup, the group's extra
// butterfly steps add lanes that hold +0.)
template <int V>
struct TorchOrder {
  static constexpr int kP = next_pow2(kGroup * (V - 1) + 1);
  static constexpr int kW = kP < kLanes ? kP : kLanes;
  static constexpr int kIter = kP / kW;
  static constexpr int kQ = kW > kGroup ? kW / kGroup : 1;
};

template <typename T, int V>
__global__ void __launch_bounds__(kWarps * kLanes)
topk_gating_group_kernel(const T* __restrict__ logits, float* __restrict__ out, int64_t t, int e,
                         int k) {
  using O = TorchOrder<V>;
  const int l = threadIdx.x % kGroup;
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * kWarps * kLanes + threadIdx.x) / kGroup;
  if (row - (threadIdx.x % kLanes) / kGroup >= t) return;  // the warp's first row: whole warps leave
  const bool live = row < t;  // a row past T still takes part in the warp's shuffles
  const T* x = logits + (live ? row : 0) * e;

  float p[V];
  float mx = -INFINITY;
#pragma unroll
  for (int m = 0; m < V; ++m) {
    const int idx = l + kGroup * m;
    p[m] = live && idx < e ? to_f32(x[idx]) : -INFINITY;
    mx = fmaxf(mx, p[m]);
  }
#pragma unroll
  for (int off = kGroup / 2; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kAll, mx, off));
#pragma unroll
  for (int m = 0; m < V; ++m) p[m] = expf(p[m] - mx);  // -inf past E gives +0, as in torch
  float part[O::kQ];  // torch's lanes l + kGroup q, each summed in `it` order
#pragma unroll
  for (int q = 0; q < O::kQ; ++q) {
    part[q] = 0.0f;
#pragma unroll
    for (int it = 0; it < O::kIter; ++it)
      if (q + O::kQ * it < V) part[q] += p[q + O::kQ * it];
  }
#pragma unroll
  for (int off = O::kW / 2; off >= kGroup; off >>= 1)
#pragma unroll
    for (int q = 0; q < off / kGroup; ++q) part[q] += part[q + off / kGroup];
  float sum = part[0];
#pragma unroll
  for (int off = kGroup / 2; off > 0; off >>= 1) sum += __shfl_xor_sync(kAll, sum, off);

  unsigned rem[V];  // what remains, as bits: 0 where chosen (or past E, or past T)
#pragma unroll
  for (int m = 0; m < V; ++m) {
    p[m] = p[m] / sum;
    rem[m] = live ? __float_as_uint(p[m]) : 0u;
  }
  float total = 0.0f;
  for (int s = 0; s < k; ++s) {
    // the group's maximum, at its lowest index (indices rise with m, then lane)
    unsigned best = 0;
    int first = kGroup * V;  // past every index
#pragma unroll
    for (int m = 0; m < V; ++m) {
      if (rem[m] > best) {
        best = rem[m];
        first = l + kGroup * m;
      }
    }
    if (__all_sync(kAll, best == 0)) break;  // no lane of the warp has anything left
#pragma unroll
    for (int off = kGroup / 2; off > 0; off >>= 1) {
      const unsigned ob = __shfl_xor_sync(kAll, best, off);
      const int of = __shfl_xor_sync(kAll, first, off);
      if (ob > best || (ob == best && of < first)) {
        best = ob;
        first = of;
      }
    }
    total += __uint_as_float(best);  // a row with nothing left adds 0
#pragma unroll
    for (int m = 0; m < V; ++m)
      if (l + kGroup * m == first) rem[m] = 0;
  }
  if (!live) return;
  const float denom = fmaxf(total, 1e-9f);
  float* orow = out + row * e;
#pragma unroll
  for (int m = 0; m < V; ++m) {
    const int idx = l + kGroup * m;
    if (idx < e) orow[idx] = rem[m] == 0 && p[m] > 0.0f ? p[m] / denom : 0.0f;
  }
}

template <typename T, int VPL>
int launch_v(const void* logits, void* out, int64_t t, int e, int k, cudaStream_t stream) {
  const unsigned int blocks = static_cast<unsigned int>((t + kWarps - 1) / kWarps);
  topk_gating_kernel<T, VPL><<<blocks, kWarps * kLanes, 0, stream>>>(
      static_cast<const T*>(logits), static_cast<float*>(out), t, e, k);
  return static_cast<int>(cudaGetLastError());
}

// E <= kGroupMaxE: kGroup lanes per row, V = ceil(E / kGroup) values per lane.
template <typename T, int V>
int launch_group(const void* logits, void* out, int64_t t, int e, int k, cudaStream_t stream) {
  if constexpr (kGroup * V < kGroupMaxE) {
    if (e > kGroup * V) return launch_group<T, V + 1>(logits, out, t, e, k, stream);
  }
  constexpr int64_t rows_per_block = kWarps * kLanes / kGroup;
  const unsigned int blocks = static_cast<unsigned int>((t + rows_per_block - 1) / rows_per_block);
  topk_gating_group_kernel<T, V><<<blocks, kWarps * kLanes, 0, stream>>>(
      static_cast<const T*>(logits), static_cast<float*>(out), t, e, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* logits, void* out, int64_t t, int64_t e, int64_t k, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int ei = static_cast<int>(e), ki = static_cast<int>(k);
  if (e <= kGroupMaxE) return launch_group<T, 1>(logits, out, t, ei, ki, s);
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
