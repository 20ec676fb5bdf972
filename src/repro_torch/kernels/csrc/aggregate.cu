// Weighted FedAvg reductions of the hierarchical-FL engine, for sm_90a.
//
// segment_aggregate_kernel replaces the Pallas TPU kernel `_seg_kernel` of
// src/repro/kernels/segment_aggregate.py (`hier_segment_aggregate`), and
// aggregate_kernel the one of src/repro/kernels/hier_aggregate.py
// (`hier_aggregate`).  Both reduce an (N, D) update matrix over its rows in
// fp32 and write each output element once, in the input dtype.  An output
// element has one owner, so there are no races and no atomics, the sum is
// taken in row order on every run, and a row of x is added only into its
// own segment.  Both take the raw weights and normalize them themselves,
// with the same arithmetic (`add_weight`, `normalized`, `add_product`): the
// weights added in row order, the sum clamped at 1e-30, each weight divided
// by it, each product rounded and then added in row order.
//
// What bounds them on an H100: bytes.  At the engine's sizes (N <= 21,
// D = 25,141) both move under 3 MB, which the card's memory reads in about
// a microsecond, so launch latency, not bandwidth, bounds them there.
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

// The arithmetic both kernels share, rounded as the plain versions round
// it: the denominator W adds the weights one at a time in row order, each
// member's weight is w / max(W, 1e-30) (an IEEE division), and each product
// is rounded once and then added.
__device__ __forceinline__ float add_weight(float den, float w) { return __fadd_rn(den, w); }
__device__ __forceinline__ float normalized(float w, float den) { return w / fmaxf(den, 1e-30f); }
__device__ __forceinline__ float add_product(float acc, float wn, float v) {
  return __fadd_rn(acc, __fmul_rn(wn, v));
}

// ---------------------------------------------------------------------------
// Segmented FedAvg in one launch, from the raw ids and weights:
//
//   out[s, col] = sum over rows i with ids[i] == s, in row order, of
//                 (w[i] / max(W[s], 1e-30)) * x[i, col],
//   W[s]        = sum over the same rows, in row order, of w[i].
//
// Ownership.  A block owns one segment (blockIdx.y, a stride loop past the
// grid's 65535) and a tile of columns (blockIdx.x); each thread owns kCols
// output elements of it, kThreads columns apart (so every warp load is
// coalesced), and keeps their sums in registers.  Any E works, with no
// sort: a block reads only its segment's rows of x, so every row of x is
// read once, and an inf or NaN row never reaches another segment.
//
// Members.  Every warp finds the segment's member rows itself, 32 ids at a
// time, with no shared memory and no block barrier: each lane reads one id
// and weight, and a ballot gives the members' lanes.  Ids outside [0, E)
// match no segment: as in the TPU kernel, whose one-hot matches none of
// them, they add nothing anywhere.
//
// Latency.  At the engine's sizes the kernel is a chain of two dependent
// loads: the ids, then the member rows of x.  Nothing else waits on a load:
// the loads of x for the first kBatch members go out as soon as the ballot
// is known, and the denominator (the same bits in every block) and each
// member's normalized weight are worked out while they are in flight.  The
// lanes then walk the members in row order and add each product into the
// sums.  A segment with more than kBatch members among 32 rows, or N > 32,
// takes further batches.
//
// What stays exact: an empty or zero-weight segment writes 0 (+0 when its
// rows are finite); a single member with weight w writes 0 + (w / w) * x = x
// exactly.
constexpr int kTile = 32;  // rows per ballot, one per lane
constexpr int kBatch = 4;  // member rows whose loads are in flight together
constexpr int kCols = 4;   // columns per thread

// The next kBatch members of the lane mask m, in row order, taken out of m.
// A place past the last member repeats the last (a harmless load), and is
// marked not in.
__device__ __forceinline__ void take(unsigned& m, int (&src)[kBatch], bool (&in)[kBatch]) {
#pragma unroll
  for (int b = 0; b < kBatch; ++b) {
    in[b] = m != 0;
    src[b] = in[b] ? __ffs(m) - 1 : (b > 0 ? src[b - 1] : 0);
    m &= m - 1;
  }
}

template <typename T, typename Id>
__global__ void __launch_bounds__(kThreads)
segment_aggregate_kernel(const T* __restrict__ x, const Id* __restrict__ ids,
                         const float* __restrict__ w, T* __restrict__ out, int64_t n, int64_t d,
                         int64_t e) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  int64_t col[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j)
    col[j] = static_cast<int64_t>(blockIdx.x) * kThreads * kCols + threadIdx.x + kThreads * j;

  for (int64_t seg = blockIdx.y; seg < e; seg += gridDim.y) {
    bool member;  // this lane's row of the current 32 is in the segment
    float wl;     // and its weight
    auto fetch = [&](int64_t r0) {  // the two loads wait on nothing
      const int64_t r = r0 + lane;
      const float wr = r < n ? w[r] : 0.0f;
      member = r < n && static_cast<int64_t>(ids[r]) == seg;
      wl = member ? wr : 0.0f;
    };
    int src[kBatch];
    bool in[kBatch];
    float v[kBatch][kCols];
    auto load = [&](int64_t r0) {  // a column past D reads column D - 1
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
#pragma unroll
        for (int j = 0; j < kCols; ++j) v[b][j] = to_f32(x[(r0 + src[b]) * d + min(col[j], d - 1)]);
    };

    // rows 0..31: the first members' loads go out before anything else
    fetch(0);
    const unsigned m0 = __ballot_sync(kAll, member);
    unsigned rest = m0;
    take(rest, src, in);
    load(0);

    // the denominator, the members' weights added in row order
    float den = 0.0f;
    for (unsigned m = m0; m; m &= m - 1) den = add_weight(den, __shfl_sync(kAll, wl, __ffs(m) - 1));
    for (int64_t r0 = kTile; r0 < n; r0 += kTile) {
      fetch(r0);
      for (unsigned m = __ballot_sync(kAll, member); m; m &= m - 1)
        den = add_weight(den, __shfl_sync(kAll, wl, __ffs(m) - 1));
    }

    float acc[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[j] = 0.0f;
    for (int64_t r0 = 0; r0 < n; r0 += kTile) {
      if (r0 > 0) {
        fetch(r0);
        rest = __ballot_sync(kAll, member);
        take(rest, src, in);
        load(r0);
      } else if (n > kTile) {
        fetch(0);  // the denominator's pass moved past rows 0..31
      }
      const float wn = member ? normalized(wl, den) : 0.0f;
      for (;;) {
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const float wb = __shfl_sync(kAll, wn, src[b]);
#pragma unroll
          for (int j = 0; j < kCols; ++j)
            if (in[b]) acc[j] = add_product(acc[j], wb, v[b][j]);
        }
        if (!rest) break;
        take(rest, src, in);
        load(r0);
      }
    }

#pragma unroll
    for (int j = 0; j < kCols; ++j)
      if (col[j] < d) out[seg * d + col[j]] = from_f32<T>(acc[j]);
  }
}

// ---------------------------------------------------------------------------
// One weighted average, from the raw weights:
//
//   out[col] = sum over rows i, in row order, of (w[i] / max(W, 1e-30)) * x[i, col],
//   W        = sum over all rows, in row order, of w[i].
//
// Every row is a member, so nothing waits on a load before the loads of x.
// Each thread owns one column (two or four per thread were no faster at
// the cloud reduce's size) and sends out at once the
// loads of the weight of row `lane` and of a chunk of kRows rows of its
// column: all N rows in one loop-free chunk of 8 when N <= 8 (every
// configuration's cloud reduce: N is the number of edges), else chunks of
// 32 in a loop, a round trip and a division each.  The row pointer steps row by row
// (no multiply per row), and the loads are unconditional, so they all leave
// before anything waits: a row past N re-reads row N - 1 and keeps 0, and
// its weight is 0, so it adds an exact +0 to both sums (a sum that starts at
// +0 never becomes -0), with no select on their chains.  The denominator
// adds the rows' weights, handed round the warp by shuffles, in row order;
// then each lane divides its own row's weight, one IEEE division per lane
// (one division per row in every thread runs the divisions' range checks
// and slow-path branches one after another), and a shuffle hands each row's
// normalized weight to the warp as its products are added in row order.  So
// for N <= 8 the kernel is one round trip of loads, then a chain of adds,
// a division and more adds: that chain, not the loads, is what the kernel
// adds to one that is given normalized weights.
//
// What stays exact: zero total weight writes 0 (+0 for finite rows); one
// row writes 0 + (w / w) * x = x exactly.
constexpr int kAggThreads = 128;
constexpr int kAggFewRows = 8;  // N up to this takes the loop-free build

// Rows whose loads are in flight together for N rows: the build launched.
inline int aggregate_rows(int64_t n) { return n <= kAggFewRows ? kAggFewRows : kTile; }

inline unsigned int aggregate_blocks(int64_t d) {
  return static_cast<unsigned int>((d + kAggThreads - 1) / kAggThreads);
}

// kRows: rows whose loads are in flight together, kAggFewRows (N <= kRows,
// one chunk) or kTile (any N, chunk by chunk).
template <typename T, int kRows>
__global__ void __launch_bounds__(kAggThreads)
aggregate_kernel(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ out,
                 int64_t n, int64_t d) {
  constexpr unsigned kAll = 0xffffffffu;
  const int64_t chunks_end = kRows < kTile ? 1 : n;
  const int lane = threadIdx.x & 31;
  const int64_t col = static_cast<int64_t>(blockIdx.x) * kAggThreads + threadIdx.x;
  const T* xc = x + min(col, d - 1);  // a column past D reads column D - 1
  float v[kRows];
  auto load = [&](int64_t r0) {  // rows r0 ..; one past N re-reads row N - 1 and keeps 0
    const int last = static_cast<int>(min(n - 1 - r0, static_cast<int64_t>(kRows)));
    const T* row = xc + r0 * d;
#pragma unroll
    for (int b = 0; b < kRows; ++b) {
      const float vb = to_f32(*row);
      v[b] = b <= last ? vb : 0.0f;
      if (b < last) row += d;
    }
  };
  auto weight = [&](int64_t t0) {  // row t0 + lane's weight, 0 past N (lane < kRows)
    const float wr = w[min(t0 + lane, n - 1)];
    return t0 + lane < n ? wr : 0.0f;
  };
  float wl = weight(0);
  load(0);

  float den = 0.0f;
  for (int64_t t0 = 0; t0 < chunks_end; t0 += kRows) {
    const float wt = t0 > 0 ? weight(t0) : wl;
#pragma unroll
    for (int b = 0; b < kRows; ++b) den = add_weight(den, __shfl_sync(kAll, wt, b));
  }

  float acc = 0.0f;
  for (int64_t t0 = 0; t0 < chunks_end; t0 += kRows) {
    if (t0 > 0) {
      wl = weight(t0);
      load(t0);
    }
    const float wn = normalized(wl, den);
#pragma unroll
    for (int b = 0; b < kRows; ++b) acc = add_product(acc, __shfl_sync(kAll, wn, b), v[b]);
  }
  if (col < d) out[col] = from_f32<T>(acc);
}

template <typename T, typename Id>
void launch_segment_ids(const void* x, const void* ids, const void* w, void* out, int64_t n,
                        int64_t d, int64_t e, cudaStream_t stream) {
  const int64_t per_block = static_cast<int64_t>(kThreads) * kCols;
  const dim3 grid(static_cast<unsigned int>((d + per_block - 1) / per_block),
                  static_cast<unsigned int>(std::min(e, kMaxGridY)));
  segment_aggregate_kernel<T, Id><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const Id*>(ids), static_cast<const float*>(w),
      static_cast<T*>(out), n, d, e);
}

// ids_64: the ids are int64 (else int32).
template <typename T>
int launch_segment(const void* x, const void* ids, int ids_64, const void* w, void* out,
                   int64_t n, int64_t d, int64_t e, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (ids_64) launch_segment_ids<T, int64_t>(x, ids, w, out, n, d, e, s);
  else launch_segment_ids<T, int32_t>(x, ids, w, out, n, d, e, s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_aggregate(const void* x, const void* w, void* out, int64_t n, int64_t d,
                     void* stream) {
  const unsigned int blocks = aggregate_blocks(d);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto xt = static_cast<const T*>(x);
  const auto wt = static_cast<const float*>(w);
  const auto o = static_cast<T*>(out);
  if (aggregate_rows(n) == kAggFewRows)
    aggregate_kernel<T, kAggFewRows><<<blocks, kAggThreads, 0, s>>>(xt, wt, o, n, d);
  else
    aggregate_kernel<T, kTile><<<blocks, kAggThreads, 0, s>>>(xt, wt, o, n, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x (N, D) contiguous; ids (N,) int32 or int64 (ids_64); w (N,) fp32;
// out (E, D) in x's dtype.  Requires N, D, E > 0.
int repro_segment_aggregate_f32(const void* x, const void* ids, int ids_64, const void* w,
                                void* out, int64_t n, int64_t d, int64_t e, void* stream) {
  return launch_segment<float>(x, ids, ids_64, w, out, n, d, e, stream);
}

int repro_segment_aggregate_bf16(const void* x, const void* ids, int ids_64, const void* w,
                                 void* out, int64_t n, int64_t d, int64_t e, void* stream) {
  return launch_segment<__nv_bfloat16>(x, ids, ids_64, w, out, n, d, e, stream);
}

// x (N, D) contiguous; w (N,) fp32, raw (the kernel normalizes them);
// out (D,) in x's dtype.  Requires N, D > 0.
int repro_aggregate_f32(const void* x, const void* w, void* out, int64_t n, int64_t d,
                        void* stream) {
  return launch_aggregate<float>(x, w, out, n, d, stream);
}

int repro_aggregate_bf16(const void* x, const void* w, void* out, int64_t n, int64_t d,
                         void* stream) {
  return launch_aggregate<__nv_bfloat16>(x, w, out, n, d, stream);
}

// The layout repro_aggregate_* launches for (N, D), for the build report:
// threads per block (which = 0), blocks (1) and the rows whose loads are in
// flight together (2).
int repro_aggregate_layout(int which, int64_t n, int64_t d) {
  return which == 0 ? kAggThreads
       : which == 1 ? static_cast<int>(aggregate_blocks(d))
                    : aggregate_rows(n);
}

}  // extern "C"
