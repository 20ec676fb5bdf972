// Weighted FedAvg reductions of the hierarchical-FL engine, for sm_90a.
//
// Both kernels reduce an (N, D) update matrix over its rows with weights the
// caller has already normalized (O(N) scalars, computed beside the launch).
// Each thread owns one output element: one column of one segment.  It walks
// that segment's rows, accumulates wn[i] * x[i, col] in an fp32 register and
// writes its element once, in the input dtype.  An element has one owner, so
// there are no races and no atomics, the sum is taken in row order on every
// run, and every row of x is read exactly once (by the threads of its own
// segment) whatever the number of segments.
//
// The accumulator lives in a register, not in the output: a read-modify-write
// of device memory per row would make each row wait for the previous row's
// store, while independent loads of x can all be in flight at once.
//
// Consecutive threads own consecutive columns, so every row is read with
// coalesced loads; the row index and weight are the same address for the
// whole warp (one broadcast load).  At the engine's sizes (N <= 21,
// D = 25,141) both kernels move under 3 MB, which the card's memory reads in
// about a microsecond: launch latency, not bandwidth, bounds them there.
//
// Plain C interface for ctypes: pointers and the stream come in as void*,
// each entry returns cudaGetLastError() after its launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int64_t kMaxGridY = 65535;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

// out[s, col] = sum over j in [offs[s], offs[s+1]) of wn[rows[j]] * x[rows[j], col].
// `rows` lists the row indices grouped by segment (a stable sort of the
// segment ids, so each segment's rows keep their order) and `offs` (E + 1)
// bounds each segment's run.  An empty segment writes exactly 0 and a single
// member with wn = 1 writes exactly its row (0 + 1 * x = x).  Rows of other
// segments are never read, so an inf or NaN row cannot leak into another
// segment.  Segments beyond gridDim.y are taken by a stride loop.
template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_aggregate_kernel(const T* __restrict__ x, const int32_t* __restrict__ rows,
                         const int32_t* __restrict__ offs, const float* __restrict__ wn,
                         T* __restrict__ out, int64_t d, int64_t e) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= d) return;
  for (int64_t s = blockIdx.y; s < e; s += gridDim.y) {
    float acc = 0.0f;
    const int32_t end = offs[s + 1];
#pragma unroll 4
    for (int32_t j = offs[s]; j < end; ++j) {
      const int64_t i = rows[j];
      acc += wn[i] * to_f32(x[i * d + col]);
    }
    out[s * d + col] = from_f32<T>(acc);
  }
}

// out[col] = sum_i wn[i] * x[i, col], accumulated in a register.
template <typename T>
__global__ void __launch_bounds__(kThreads)
aggregate_kernel(const T* __restrict__ x, const float* __restrict__ wn,
                 T* __restrict__ out, int64_t n, int64_t d) {
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (col >= d) return;
  float acc = 0.0f;
#pragma unroll 4
  for (int64_t i = 0; i < n; ++i) acc += wn[i] * to_f32(x[i * d + col]);
  out[col] = from_f32<T>(acc);
}

unsigned int blocks_for(int64_t d) {
  return static_cast<unsigned int>((d + kThreads - 1) / kThreads);
}

template <typename T>
int launch_segment(const void* x, const void* rows, const void* offs, const void* wn, void* out,
                   int64_t d, int64_t e, void* stream) {
  const dim3 grid(blocks_for(d), static_cast<unsigned int>(std::min(e, kMaxGridY)));
  segment_aggregate_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(rows),
      static_cast<const int32_t*>(offs), static_cast<const float*>(wn), static_cast<T*>(out),
      d, e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_aggregate(const void* x, const void* wn, void* out, int64_t n, int64_t d,
                     void* stream) {
  aggregate_kernel<T><<<blocks_for(d), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(wn), static_cast<T*>(out), n, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int repro_segment_aggregate_f32(const void* x, const void* rows, const void* offs,
                                const void* wn, void* out, int64_t d, int64_t e, void* stream) {
  return launch_segment<float>(x, rows, offs, wn, out, d, e, stream);
}

int repro_segment_aggregate_bf16(const void* x, const void* rows, const void* offs,
                                 const void* wn, void* out, int64_t d, int64_t e, void* stream) {
  return launch_segment<__nv_bfloat16>(x, rows, offs, wn, out, d, e, stream);
}

int repro_aggregate_f32(const void* x, const void* wn, void* out, int64_t n, int64_t d,
                        void* stream) {
  return launch_aggregate<float>(x, wn, out, n, d, stream);
}

int repro_aggregate_bf16(const void* x, const void* wn, void* out, int64_t n, int64_t d,
                         void* stream) {
  return launch_aggregate<__nv_bfloat16>(x, wn, out, n, d, stream);
}

}  // extern "C"
