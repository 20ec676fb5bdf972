// Causal (+ sliding window) grouped-query attention with an online softmax,
// fp32, for sm_90a.
//
// Replaces the Pallas TPU kernel `_flash_kernel` of
// src/repro/kernels/flash_attention.py (`flash_attention`).  It computes
// what that kernel computes: logits = (q . k) * scale in fp32; masked
// entries set to the finite -1e30 (never -inf: exp(-inf - (-inf)) is NaN);
// the running max m, sum l and accumulator acc in fp32, rescaled by
// exp(m_old - m_new) at every key tile; the output acc / max(l, 1e-30) in
// fp32.  Positions count from 0 on both axes, so the wrapper requires
// the query and key lengths to be equal.  Query head h reads kv head
// h / (Hq / Hkv): no repeated copy of k or v is made.
//
// This is the fp32 kernel.  bf16 inputs take flash_attention_sm90.cu, which
// runs both products on the tensor cores; wgmma takes fp32 only as TF32,
// which would miss the 2e-5 fp32 tolerance, so fp32 stays on the SIMT
// cores here.  What bounds it on an H100: operations, at the SIMT fp32
// rate (67 TFLOP/s): B 2, S 1024, Hq 16, Hkv 4, d 128 causal is 8.6 GFLOP,
// 0.13 ms, against 0.013 ms for its bytes at 3.35 TB/s.
//
// Design.  One block of 128 threads owns one (batch, query head) pair and
// one tile of kBQ = 64 query rows; grid.y walks the query tiles from the
// last one down, so the longest causal rows start first.  The block stages
// its query tile in shared memory once, then loops over kBK = 32-row key
// tiles: it loads the k and v tiles into shared memory, computes its
// 64 x 32 scores, updates m, l and acc, and goes on.  Thread
// t owns rows 4 * (t / 8) .. + 3 and columns t % 8 + 8 j of the score tile
// and of the accumulator, so the 8 threads that share a row are 8 adjacent
// lanes of one warp: row maxima and sums are warp shuffles, and the
// probabilities pass to the P.V product through shared memory read by that
// warp alone.  Key tiles wholly outside the causal band or the window are
// skipped; a tile that is only partly inside is masked element by element,
// which also masks the ragged tail past the sequence end, so no length
// constraint applies.  Where a row's first visited tile holds none of its
// keys, m stays -1e30, every masked entry gets p = exp(0) = 1, and the next
// tile with a real key wipes that mass with alpha = exp(-1e30 - m) = 0,
// exactly as the TPU kernel, which visits every tile, does.
//
// Plain C interface for ctypes: pointers and the stream come in as void*,
// shapes and strides (in elements) as host int64 arrays; the entry returns
// cudaGetLastError() after its launch.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 32;       // key rows per tile
constexpr int kThreads = 128;
constexpr int kRows = 4;      // query rows per thread
constexpr int kGroup = 8;     // threads sharing a row (adjacent lanes)
constexpr float kNegInf = -1e30f;

struct Geometry {
  int64_t s, hq, hkv;
  // element strides of the batch, sequence and head axes (the last axis is contiguous)
  int64_t q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h;
  float scale;
  int causal;
  int64_t window;  // 0: no window
};

template <int D>
constexpr size_t smem_bytes() {
  // q tile [kBQ][D + 1], k tile [kBK][D + 1], v tile [kBK][D], p tile [kBQ][kBK + 1]
  return sizeof(float) * (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o, Geometry g) {
  static_assert(D % kGroup == 0, "head dim must be a multiple of 8");
  constexpr int kCols = D / kGroup;    // accumulator columns per thread
  constexpr int kKeys = kBK / kGroup;  // score columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                  // [kBQ][D + 1]
  float* ks = qs + kBQ * (D + 1);    // [kBK][D + 1]
  float* vs = ks + kBK * (D + 1);    // [kBK][D]
  float* ps = vs + kBK * D;          // [kBQ][kBK + 1]

  const int64_t bh = blockIdx.x;
  const int64_t b = bh / g.hq;
  const int64_t h = bh % g.hq;
  const int64_t hk = h / (g.hq / g.hkv);
  const int64_t q0 = static_cast<int64_t>(gridDim.y - 1 - blockIdx.y) * kBQ;
  const float* qb = q + b * g.q_b + h * g.q_h;
  const float* kb = k + b * g.k_b + hk * g.k_h;
  const float* vb = v + b * g.v_b + hk * g.v_h;

  for (int e = threadIdx.x; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int64_t qi = q0 + r;
    qs[r * (D + 1) + c] = qi < g.s ? qb[qi * g.q_s + c] : 0.0f;
  }

  const int tr = threadIdx.x / kGroup;  // row group: rows tr * kRows + i
  const int tc = threadIdx.x % kGroup;  // column lane: columns tc + kGroup * j
  float acc[kRows][kCols];
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.0f;
  }

  // key tiles that hold a key some row of this tile may see
  const int64_t q_last = (q0 + kBQ < g.s ? q0 + kBQ : g.s) - 1;
  const int64_t k_end = g.causal ? q_last + 1 : g.s;
  int64_t k_begin = 0;
  if (g.window > 0 && q0 - g.window + 1 > 0) k_begin = q0 - g.window + 1;
  const int64_t t_begin = k_begin / kBK;
  const int64_t t_end = (k_end + kBK - 1) / kBK;

  for (int64_t t = t_begin; t < t_end; ++t) {
    const int64_t k0 = t * kBK;
    __syncthreads();  // the previous tile's k, v and p are no longer read
    for (int e = threadIdx.x; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const int64_t kj = k0 + r;
      const bool in = kj < g.s;
      ks[r * (D + 1) + c] = in ? kb[kj * g.k_s + c] : 0.0f;
      vs[r * D + c] = in ? vb[kj * g.v_s + c] : 0.0f;
    }
    __syncthreads();

    float sc[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) sc[i][j] = 0.0f;
#pragma unroll 4
    for (int dd = 0; dd < D; ++dd) {
      float qv[kRows], kv[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qs[(tr * kRows + i) * (D + 1) + dd];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) kv[j] = ks[(tc + kGroup * j) * (D + 1) + dd];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int64_t qi = q0 + tr * kRows + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int64_t kj = k0 + tc + kGroup * j;
        bool ok = kj < g.s;
        if (g.causal) ok = ok && kj <= qi;
        if (g.window > 0) ok = ok && kj > qi - g.window;
        sc[i][j] = ok ? sc[i][j] * g.scale : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = kGroup / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float p = expf(sc[i][j] - m_new);
        rs += p;
        ps[(tr * kRows + i) * (kBK + 1) + tc + kGroup * j] = p;
      }
#pragma unroll
      for (int off = kGroup / 2; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
    }
    __syncwarp();  // a row's p values are written and read by one warp

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float vv[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) vv[j] = vs[kk * D + tc + kGroup * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = ps[(tr * kRows + i) * (kBK + 1) + kk];
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int64_t qi = q0 + tr * kRows + i;
    if (qi >= g.s) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* orow = o + b * g.o_b + qi * g.o_s + h * g.o_h;
#pragma unroll
    for (int j = 0; j < kCols; ++j) orow[tc + kGroup * j] = acc[i][j] / denom;
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
  g.scale = scale;
  g.causal = causal;
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

}  // extern "C"
