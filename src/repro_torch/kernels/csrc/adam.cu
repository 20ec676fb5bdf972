// Adam's in-place update of one parameter leaf, for sm_90a.
//
// Replaces no TPU kernel: the reference writes Adam out in jnp
// (src/repro/training/optimizers.py) and leaves its fusion to XLA.  It was
// added because the eager port's Adam, a chain of some 18 PyTorch
// elementwise passes over 16M-element slices of each leaf, each writing an
// fp32 intermediate to device memory and reading it back, was half of the
// phi3-mini edge replicas' training step.
//
// What it computes, per element, in the order and the roundings of
// training/optimizers.py's `adam` (`new_m`, `new_v`, `new_p`):
//
//   m'  = rn_M(b1 * m + (1 - b1) * g)
//   v'  = rn_M(b2 * v + (1 - b2) * (g * g))
//   upd = (m' * mh) / (sqrt(v' * vh) + eps)   [+ wd * p]
//   p'  = rn_P(p - lr * upd)
//
// in fp32, every product, sum, root and quotient rounded to nearest by
// its own intrinsic (`__fmul_rn` and friends are never contracted into an
// FMA), rn_M and rn_P rounding to the moments' and the parameters' dtypes
// (bf16: round to nearest even, as torch's `.to(bfloat16)`).  The scalars
// come in as the float32 that PyTorch makes of the same Python floats, so
// the kernel writes the plain version's bits.
//
// What bounds it on an H100: bytes.  It reads p, g, m and v once and
// writes p, m and v once: 22 bytes an element for bf16 p and g with fp32
// moments, about 0.1 flop a byte, far below the ridge.  Design: one launch
// a leaf, a grid-stride loop over enough 256-thread blocks to fill every
// SM; each thread takes 8 elements an iteration, as one 16-byte load of
// each bf16 operand (two of each fp32 one), with streaming cache hints
// (nothing is read twice).  The 8-element body runs when all four pointers
// are 16-byte aligned; the ragged tail, and a leaf with any pointer that
// is not, take a scalar path with the same arithmetic.
//
// Plain C interface for ctypes: pointers and the stream come in as void*,
// the entry returns cudaGetLastError() after its launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kVec = 8;  // elements a thread takes an iteration

struct Coef {
  float b1, c1, b2, c2, eps, lr, mh, vh, wd;
  int has_wd;
};

template <typename T>
struct Elt;

template <>
struct Elt<float> {
  __device__ static float load(const float* p) { return *p; }
  __device__ static void store(float* p, float x) { *p = x; }
  __device__ static float round(float x) { return x; }
  __device__ static void load8(const float* p, float (&x)[kVec]) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
    const float4 b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  }
  __device__ static void store8(float* p, const float (&x)[kVec]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
    __stcs(reinterpret_cast<float4*>(p) + 1, make_float4(x[4], x[5], x[6], x[7]));
  }
};

template <>
struct Elt<__nv_bfloat16> {
  __device__ static unsigned int bits(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));  // round to nearest even
  }
  __device__ static float widen(unsigned int b) { return __uint_as_float(b << 16); }  // exact
  __device__ static float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
  __device__ static void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
  __device__ static float round(float x) { return widen(bits(x)); }
  __device__ static void load8(const __nv_bfloat16* p, float (&x)[kVec]) {
    const uint4 u = __ldcs(reinterpret_cast<const uint4*>(p));
    const unsigned int w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = widen(w[i] & 0xffffu);
      x[2 * i + 1] = widen(w[i] >> 16);
    }
  }
  __device__ static void store8(__nv_bfloat16* p, const float (&x)[kVec]) {
    unsigned int w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = bits(x[2 * i]) | (bits(x[2 * i + 1]) << 16);
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
  }
};

// One element, as the plain version computes it; M rounds the new moments
// before the parameter's update reads them.  p comes back unrounded: the
// store rounds it to P.
template <typename M>
__device__ __forceinline__ void adam_element(float& p, float g, float& m, float& v, const Coef& k) {
  m = Elt<M>::round(__fadd_rn(__fmul_rn(k.b1, m), __fmul_rn(k.c1, g)));
  v = Elt<M>::round(__fadd_rn(__fmul_rn(k.b2, v), __fmul_rn(k.c2, __fmul_rn(g, g))));
  float upd = __fdiv_rn(__fmul_rn(m, k.mh), __fadd_rn(__fsqrt_rn(__fmul_rn(v, k.vh)), k.eps));
  if (k.has_wd) upd = __fadd_rn(upd, __fmul_rn(k.wd, p));
  p = __fsub_rn(p, __fmul_rn(k.lr, upd));
}

template <typename P, typename G, typename M>
__device__ __forceinline__ void adam_scalar(P* p, const G* g, M* m, M* v, int64_t i, const Coef& k) {
  float pf = Elt<P>::load(p + i), mf = Elt<M>::load(m + i), vf = Elt<M>::load(v + i);
  adam_element<M>(pf, Elt<G>::load(g + i), mf, vf, k);
  Elt<M>::store(m + i, mf);
  Elt<M>::store(v + i, vf);
  Elt<P>::store(p + i, pf);
}

// aligned: every pointer 16-byte aligned, so elements [0, n / 8 * 8) go 8 at
// a time and the rest one at a time; otherwise all go one at a time.
template <typename P, typename G, typename M>
__global__ void __launch_bounds__(kThreads) adam_update_kernel(P* __restrict__ p, const G* __restrict__ g,
                                                               M* __restrict__ m, M* __restrict__ v,
                                                               int64_t n, bool aligned, Coef k) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int64_t head = 0;
  if (aligned) {
    const int64_t groups = n / kVec;
    for (int64_t j = tid; j < groups; j += stride) {
      const int64_t i = j * kVec;
      float pf[kVec], gf[kVec], mf[kVec], vf[kVec];
      Elt<P>::load8(p + i, pf);
      Elt<G>::load8(g + i, gf);
      Elt<M>::load8(m + i, mf);
      Elt<M>::load8(v + i, vf);
#pragma unroll
      for (int e = 0; e < kVec; ++e) adam_element<M>(pf[e], gf[e], mf[e], vf[e], k);
      Elt<M>::store8(m + i, mf);
      Elt<M>::store8(v + i, vf);
      Elt<P>::store8(p + i, pf);
    }
    head = groups * kVec;
  }
  for (int64_t i = head + tid; i < n; i += stride) adam_scalar<P, G, M>(p, g, m, v, i, k);
}

bool aligned16(const void* a) { return reinterpret_cast<uintptr_t>(a) % 16 == 0; }

template <typename P, typename G, typename M>
int launch(void* p, const void* g, void* m, void* v, int64_t n, const Coef& k, void* stream) {
  const bool aligned = aligned16(p) && aligned16(g) && aligned16(m) && aligned16(v);
  const int64_t work = aligned ? n / kVec : n;  // the tail needs fewer than kVec threads
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = std::clamp<int64_t>((work + kThreads - 1) / kThreads, 1, int64_t{sms} * kBlocksPerSm);
  adam_update_kernel<P, G, M><<<static_cast<unsigned int>(blocks), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<P*>(p), static_cast<const G*>(g), static_cast<M*>(m), static_cast<M*>(v), n, aligned, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename P, typename G>
int launch_m(int m_bf16, void* p, const void* g, void* m, void* v, int64_t n, const Coef& k, void* stream) {
  return m_bf16 ? launch<P, G, __nv_bfloat16>(p, g, m, v, n, k, stream)
                : launch<P, G, float>(p, g, m, v, n, k, stream);
}

template <typename P>
int launch_gm(int g_bf16, int m_bf16, void* p, const void* g, void* m, void* v, int64_t n, const Coef& k,
              void* stream) {
  return g_bf16 ? launch_m<P, __nv_bfloat16>(m_bf16, p, g, m, v, n, k, stream)
                : launch_m<P, float>(m_bf16, p, g, m, v, n, k, stream);
}

}  // namespace

extern "C" {

// p, g, m, v: n contiguous elements each, p and g fp32 or bf16 (p_bf16,
// g_bf16), m and v both fp32 or both bf16 (m_bf16); p, m and v updated in
// place.  c1 = 1 - b1 and c2 = 1 - b2 as the caller rounds them; wd is
// added only when has_wd.  Requires n > 0.
int repro_adam_update(void* p, const void* g, void* m, void* v, int64_t n, int p_bf16, int g_bf16,
                      int m_bf16, float b1, float c1, float b2, float c2, float eps, float lr, float mh,
                      float vh, float wd, int has_wd, void* stream) {
  if (n <= 0) return -1;
  const Coef k{b1, c1, b2, c2, eps, lr, mh, vh, wd, has_wd};
  return p_bf16 ? launch_gm<__nv_bfloat16>(g_bf16, m_bf16, p, g, m, v, n, k, stream)
                : launch_gm<float>(g_bf16, m_bf16, p, g, m, v, n, k, stream);
}

}  // extern "C"
