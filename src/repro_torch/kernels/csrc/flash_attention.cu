// Causal (+ sliding window) grouped-query attention with an online softmax,
// fp32, for sm_90a.
//
// Replaces the Pallas TPU kernel `_flash_kernel` of
// src/repro/kernels/flash_attention.py (`flash_attention`) for fp32 inputs.
// It computes what that kernel computes: logits = (q . k) * scale in fp32;
// masked entries set to the finite -1e30 (never -inf: exp(-inf - (-inf)) is
// NaN); the running max m, sum l and accumulator acc in fp32, rescaled at
// every key tile; the output acc / max(l, 1e-30).  Positions count from 0 on
// both axes, so the wrapper requires the query and key lengths to be equal.
// Query head h reads kv head h / (Hq / Hkv): no copy of k or v is made.  The
// exponent is taken in base 2 with scale * log2(e) folded into the logits.
//
// bf16 inputs take flash_attention_sm90.cu.  wgmma takes fp32 only as TF32,
// which would miss the 2e-5 fp32 tolerance, so this kernel stays on the
// SIMT cores in full fp32: every product is an FFMA.  What bounds it on an
// H100: operations, at the fp32 rate (67 TFLOP/s): B 2, S 1024, Hq 16,
// Hkv 4, d 128 causal is 8.6 GFLOP, 0.13 ms, against 0.013 ms for its bytes
// at 3.35 TB/s.  So the design keeps the FFMA pipes busy:
//
// - Register blocking.  A block of kThreads = 256 threads owns one (batch,
//   query head) pair and kBQ = 128 query rows, and loops over kBK = 64-row
//   key tiles.  The threads form 16 row groups of 16 lanes: thread (tr, tc)
//   holds the scores of rows tr * 8 + i (i < 8) against keys tc + 16 j
//   (j < 4), 32 registers, and the output accumulator of the same 8 rows
//   at columns tc + 16 j (j < D / 16), 64 registers at d 128.  A row's 16
//   lanes are one half-warp, so row maxima are half-warp shuffles, and the
//   probabilities go to the p . v product through shared memory that the
//   same half-warp writes and reads (a __syncwarp, no block barrier).
// - Vector loads from shared memory.  Q and K stay row-major in shared
//   memory in 16-byte chunks, chunk c of row r stored at c ^ (r & 7) (an
//   XOR swizzle).  Q . K^T steps through d four at a time: 4 LDS.128 of K
//   (the 8 lanes of a quarter-warp read 8 rows with distinct swizzles: no
//   bank conflict) and 8 LDS.128 of Q (one address per half-warp: a
//   broadcast) feed 128 FFMA.  p . v reads p as 2 LDS.128 (stored
//   transposed, [key][row], rows padded by 4 floats so that a quarter-warp's
//   stores hit distinct banks) and v as D / 16 scalar LDS (adjacent lanes,
//   adjacent words) for 8 * D / 16 FFMA.
// - Asynchronous, double-buffered copies.  K and V tiles arrive by cp.async
//   (16 bytes a copy, bypassing the registers and L1) into two buffers: the
//   copy of tile t + 1 is issued before the math of tile t and waited for
//   after it (commit_group / wait_group), so copy and math overlap.  A row
//   past the sequence end is zero-filled by the copy itself (src-size 0).
//   Inputs off the 16-byte grid (a base or stride that is not a multiple of
//   4 floats) take 4-byte cp.async copies instead.
// - Epilogue: the row sums l are kept per lane and reduced once at the end;
//   one reciprocal per row, then a multiply per element.
//
// Shared memory at d 128: Q 64 KB, K and V 2 x 32 KB each, p 33 KB: 225 KB,
// one block per SM.  grid.y walks the query tiles from the last one down,
// so the longest causal rows start first.
//
// Masking.  Key tiles wholly outside the causal band or the window are not
// visited.  A tile that holds the diagonal, the window's edge or the ragged
// tail past the sequence end is masked element by element (so no length
// constraint applies); interior tiles take no mask.
// Where a row's first visited tile holds none of its keys, m stays -1e30,
// every masked entry gets p = 2^0 = 1, and the first tile with a real key
// wipes that mass with alpha = 2^(-1e30 - m) = 0, as the TPU kernel, which
// visits every tile, does.  The logits are scaled with __fmul_rn (never
// contracted into an FMA), so a masked -1e30 minus -1e30 is exactly 0.  No
// atomics and no split over keys: two launches give bitwise-equal outputs.
//
// Plain C interface for ctypes: pointers and the stream come in as void*,
// shapes and strides (in elements) as host int64 arrays; the entry returns
// cudaGetLastError() after its launch.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 128;      // query rows per block
constexpr int kBK = 64;       // key rows per tile
constexpr int kThreads = 256;
constexpr int kLanes = 16;    // lanes sharing a row group (one half-warp)
constexpr int kRows = 8;      // query rows per thread
constexpr int kKeys = kBK / kLanes;  // score columns per thread
constexpr int kPStride = kBQ + 4;    // floats per key row of the p tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the SFU (MUFU.EX2, 2 ulp; results below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
static_assert(kThreads == (kBQ / kRows) * kLanes, "thread layout covers the query tile");

struct Geometry {
  int64_t s, hq, hkv;
  // element strides of the batch, sequence and head axes (the last axis is contiguous)
  int64_t q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h;
  float scale_log2;  // scale * log2(e)
  int causal;
  int aligned;       // q, k, v bases and strides on the 16-byte grid
  int64_t window;    // 0: no window
};

template <int D>
constexpr size_t smem_bytes() {
  // q [kBQ][D], k [2][kBK][D], v [2][kBK][D], p [kBK][kPStride]
  return sizeof(float) * (kBQ * D + 4 * kBK * D + kBK * kPStride);
}

// XOR swizzle of a row's 16-byte chunks (rows of D / 4 chunks)
template <int D>
__device__ __forceinline__ int swizzle(int row, int chunk) {
  constexpr int kMask = D / 4 >= 8 ? 7 : D / 4 - 1;
  return chunk ^ (row & kMask);
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Queue the copy of rows [row0, row0 + kTileRows) of one head (`src` at row
// 0, rows `stride` elements apart) into `dst`, [kTileRows][D], chunks
// swizzled when kSwizzle.  Rows at or past `s` are zero-filled.
template <int D, int kTileRows, bool kSwizzle>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int64_t row0,
                                          int64_t stride, int64_t s, bool aligned) {
  constexpr int kChunks = D / 4;
  for (int e = threadIdx.x; e < kTileRows * kChunks; e += kThreads) {
    const int r = e / kChunks, c = e % kChunks;
    float* d = dst + r * D + (kSwizzle ? swizzle<D>(r, c) : c) * 4;
    const bool in = row0 + r < s;
    const float* g = src + (in ? row0 + r : 0) * stride + c * 4;
    if (aligned) {
      cp_async16(d, g, in ? 16 : 0);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) cp_async4(d + k, g + k, in ? 4 : 0);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o, Geometry g) {
  static_assert(D % kLanes == 0, "head dim must be a multiple of 16");
  constexpr int kCols = D / kLanes;  // accumulator columns per thread
  constexpr int kChunks = D / 4;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [kBQ][D], swizzled
  float* ks = qs + kBQ * D;         // [2][kBK][D], swizzled
  float* vs = ks + 2 * kBK * D;     // [2][kBK][D]
  float* ps = vs + 2 * kBK * D;     // [kBK][kPStride]: p transposed

  const int64_t bh = blockIdx.x;
  const int64_t b = bh / g.hq;
  const int64_t h = bh % g.hq;
  const int64_t hk = h / (g.hq / g.hkv);
  const int64_t q0 = static_cast<int64_t>(gridDim.y - 1 - blockIdx.y) * kBQ;
  const float* qb = q + b * g.q_b + h * g.q_h;
  const float* kb = k + b * g.k_b + hk * g.k_h;
  const float* vb = v + b * g.v_b + hk * g.v_h;
  const bool aligned = g.aligned != 0;

  // key tiles that hold a key some row of this tile may see
  const int64_t q_last = (q0 + kBQ < g.s ? q0 + kBQ : g.s) - 1;
  const int64_t k_end = g.causal ? q_last + 1 : g.s;
  int64_t k_begin = 0;
  if (g.window > 0 && q0 - g.window + 1 > 0) k_begin = q0 - g.window + 1;
  const int64_t t_begin = k_begin / kBK;
  const int64_t t_end = (k_end + kBK - 1) / kBK;

  load_tile<D, kBQ, true>(qs, qb, q0, g.q_s, g.s, aligned);
  load_tile<D, kBK, true>(ks, kb, t_begin * kBK, g.k_s, g.s, aligned);
  load_tile<D, kBK, false>(vs, vb, t_begin * kBK, g.v_s, g.s, aligned);
  cp_async_commit();

  const int tr = threadIdx.x / kLanes;  // row group: rows tr * kRows + i
  const int tc = threadIdx.x % kLanes;  // lane: keys and columns tc + kLanes * j
  float acc[kRows][kCols];
  float m[kRows], l[kRows];  // l: this lane's share of the row sum
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.0f;
  }

  for (int64_t t = t_begin; t < t_end; ++t) {
    const int buf = static_cast<int>((t - t_begin) & 1);
    if (t + 1 < t_end) {  // the next tile's copy overlaps this tile's math
      load_tile<D, kBK, true>(ks + (buf ^ 1) * kBK * D, kb, (t + 1) * kBK, g.k_s, g.s, aligned);
      load_tile<D, kBK, false>(vs + (buf ^ 1) * kBK * D, vb, (t + 1) * kBK, g.v_s, g.s, aligned);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and q) visible to every thread
    const float* kt = ks + buf * kBK * D;
    const float* vt = vs + buf * kBK * D;
    const int64_t k0 = t * kBK;
    // a tile that holds the diagonal, the window's edge or the sequence end
    // is masked element by element; every key of an interior tile is visible
    const bool edge = k0 + kBK > g.s || (g.causal && k0 + kBK - 1 > q0) ||
                      (g.window > 0 && k0 <= q_last - g.window);

    // S = Q K^T, 8 x 4 per thread, d in steps of one 16-byte chunk
    float sc[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) sc[i][j] = 0.0f;
#pragma unroll 2
    for (int c = 0; c < kChunks; ++c) {
      float4 kv[kKeys];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int r = tc + kLanes * j;
        kv[j] = *reinterpret_cast<const float4*>(kt + r * D + swizzle<D>(r, c) * 4);
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = tr * kRows + i;
        const float4 qv = *reinterpret_cast<const float4*>(qs + r * D + swizzle<D>(r, c) * 4);
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          sc[i][j] = fmaf(qv.x, kv[j].x, sc[i][j]);
          sc[i][j] = fmaf(qv.y, kv[j].y, sc[i][j]);
          sc[i][j] = fmaf(qv.z, kv[j].z, sc[i][j]);
          sc[i][j] = fmaf(qv.w, kv[j].w, sc[i][j]);
        }
      }
    }

    // online softmax, base 2; p overwrites the scores
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int64_t qi = q0 + tr * kRows + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int64_t kj = k0 + tc + kLanes * j;
        bool ok = true;
        if (edge) {
          ok = kj < g.s;
          if (g.causal) ok = ok && kj <= qi;
          if (g.window > 0) ok = ok && kj > qi - g.window;
        }
        sc[i][j] = ok ? __fmul_rn(sc[i][j], g.scale_log2) : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = ex2(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        sc[i][j] = ex2(sc[i][j] - m_new);
        rs += sc[i][j];
      }
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      float* prow = ps + (tc + kLanes * j) * kPStride + tr * kRows;
      *reinterpret_cast<float4*>(prow) = make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
      *reinterpret_cast<float4*>(prow + 4) = make_float4(sc[4][j], sc[5][j], sc[6][j], sc[7][j]);
    }
    __syncwarp();  // a row group's p is written and read by its own half-warp

    // O += P V, 8 x D/16 per thread
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 pa = *reinterpret_cast<const float4*>(ps + kk * kPStride + tr * kRows);
      const float4 pb = *reinterpret_cast<const float4*>(ps + kk * kPStride + tr * kRows + 4);
      const float p[kRows] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
      float vv[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) vv[j] = vt[kk * D + tc + kLanes * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
    __syncthreads();  // every thread is done with this tile's buffers and p
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    float rs = l[i];
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
    const int64_t qi = q0 + tr * kRows + i;
    if (qi >= g.s) continue;
    const float inv = __fdividef(1.0f, fmaxf(rs, 1e-30f));  // one reciprocal per row
    float* orow = o + b * g.o_b + qi * g.o_s + h * g.o_h;
#pragma unroll
    for (int j = 0; j < kCols; ++j) orow[tc + kLanes * j] = acc[i][j] * inv;
  }
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int64_t batch,
             const Geometry& g, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<D>;
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>(batch * g.hq),
                  static_cast<unsigned int>((g.s + kBQ - 1) / kBQ));
  kernel<<<grid, kThreads, bytes, stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                            static_cast<const float*>(v), static_cast<float*>(o), g);
  return static_cast<int>(cudaGetLastError());
}

bool on_grid(const void* p, const int64_t* strides) {
  if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  for (int i = 0; i < 3; ++i)
    if (strides[i] % 4) return false;
  return true;
}

// dims: batch, seq, q heads, kv heads, head dim.
// strides: (batch, seq, head) element strides of q, k, v, o in that order.
int launch(const void* q, const void* k, const void* v, void* o, const int64_t* dims,
           const int64_t* strides, float scale, int causal, int64_t window, void* stream) {
  Geometry g;
  g.s = dims[1];
  g.hq = dims[2];
  g.hkv = dims[3];
  g.q_b = strides[0]; g.q_s = strides[1]; g.q_h = strides[2];
  g.k_b = strides[3]; g.k_s = strides[4]; g.k_h = strides[5];
  g.v_b = strides[6]; g.v_s = strides[7]; g.v_h = strides[8];
  g.o_b = strides[9]; g.o_s = strides[10]; g.o_h = strides[11];
  g.scale_log2 = scale * kLog2e;
  g.causal = causal;
  g.aligned = on_grid(q, strides) && on_grid(k, strides + 3) && on_grid(v, strides + 6);
  g.window = window;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dims[4]) {
    case 16: return launch_d<16>(q, k, v, o, dims[0], g, s);
    case 32: return launch_d<32>(q, k, v, o, dims[0], g, s);
    case 64: return launch_d<64>(q, k, v, o, dims[0], g, s);
    case 96: return launch_d<96>(q, k, v, o, dims[0], g, s);
    case 128: return launch_d<128>(q, k, v, o, dims[0], g, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int repro_flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                              const int64_t* dims, const int64_t* strides, float scale,
                              int causal, int64_t window, void* stream) {
  return launch(q, k, v, o, dims, strides, scale, causal, window, stream);
}

// The kernel's tile: query rows per block (which = 0) and key rows per tile
// (which = 1), for the wrapper's and the tests' check against SIMT_TILE.
int repro_flash_attention_f32_tile(int which) { return which == 0 ? kBQ : kBK; }

}  // extern "C"
