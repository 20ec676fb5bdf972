// Causal (+ sliding window) grouped-query attention for sm_90a on the
// tensor cores: bf16 inputs, wgmma for both products, TMA tile loads into a
// ring of shared-memory stages, fp32 softmax state in registers.
//
// Replaces the Pallas TPU kernel `_flash_kernel` of
// src/repro/kernels/flash_attention.py (`flash_attention`) for bf16 inputs;
// fp32 inputs keep the SIMT kernel of flash_attention.cu, because wgmma
// takes fp32 only as TF32.  It computes what the TPU kernel computes:
// logits = (q . k) / sqrt(d) in fp32; masked entries at the finite -1e30
// (never -inf); the running max m, sum l and accumulator in fp32, rescaled
// at every key tile; the output acc / max(l, 1e-30) in bf16 (acc times one
// fast reciprocal per row); causal masking with an optional window; query
// head h reads kv head
// h / (Hq / Hkv) with no repeated copy of k or v; sq == sk (the wrapper
// checks it).
//
// The one numerical difference: p is rounded to bf16 for the p . v
// product, because wgmma takes bf16 operands (the TPU kernel multiplies an
// fp32 p by v cast to fp32).  The reference's own non-flash path rounds p
// the same way (`probs.to(v.dtype)` in `sdpa`), and the kernel is held to
// the reference's bf16 tolerance, 2e-2.  q . k is exact in fp32 products
// of bf16 values; only its summation order differs.  The row sum l adds
// the fp32 p before rounding.  The exponent is taken in base 2 with
// scale * log2(e) folded into the logits (exp(x) = 2^(x log2 e)).
//
// What bounds it on an H100: operations.  At the qwen3-14b serve prefill
// (B 4, S 2048, Hq 40, Hkv 8, d 128) causal attention is
// 4 * B * Hq * d * S(S+1)/2 = 172 GFLOP per layer, 0.17 ms at 989 TFLOP/s
// in bf16, while its bytes take 0.06 ms at 3.35 TB/s.  So the design keeps
// the tensor cores fed: tiles move by TMA without costing the math warps
// an instruction, and both products run on wgmma.
//
// Design.  One CTA owns one (batch, query head) pair and kBM = 128 query
// rows; blockIdx.y walks the query tiles from the last one down, so the
// longest causal rows start first.  It has three warpgroups:
//   - warpgroups 0 and 1 consume, 64 query rows each (setmaxnreg 232);
//   - warpgroup 2 produces (setmaxnreg 40): one thread issues TMA loads of
//     the Q tile once, then of each kBN = 128-row K and V tile into a ring
//     of kStages stages, each stage with a "full" mbarrier for K, one for V,
//     and an "empty" mbarrier the consumers arrive on when done with it.
// For each key tile a consumer computes S = Q K^T with wgmma m64n128k16
// (Q and K in shared memory, K-major), the online softmax in registers (a
// row spreads over a quad of 4 threads: the row max takes 2 shuffles, the
// row sum is reduced once at the end), converts S in place to the bf16 A
// fragment of the next product (the m64nNk16 accumulator layout is the A
// fragment layout), and computes O += P V with wgmma m64nDk16, P from
// registers and V from shared memory, MN-major (transpose bit set).  While
// it does, the producer loads the next tiles into the other stages.
//
// Shared memory: every tile is stored as column atoms of kAtom columns,
// each a [rows][kAtom] block in the swizzle TMA writes and wgmma reads:
// 128-byte swizzle for d 64 and 128 (atoms of 64 columns), 64-byte swizzle
// for d 96 (atoms of 32 columns).  d 128 holds Q (32 KB) and 3 stages of K
// and V (64 KB each): 224 KB, one CTA per SM.
//
// Tensor maps: one 4-D map (D, H, S, B) each for q, k, v and o, built on
// the host at each call from the tensors' own strides, so q, k and v may
// be views of a fused projection.  S is a dimension of its own: a tile
// that runs past the sequence end is zero-filled by the hardware, and the
// TMA store of o clips rows >= S.  The zero-filled keys are masked.
//
// Masking.  Key tiles wholly outside the causal band or the window are not
// visited.  Only a tile that holds the diagonal, the window's edge or the
// ragged tail is masked element by element; interior tiles take no mask.
// Where a row's first visited tile holds none of its keys, m stays -1e30,
// every masked entry gets p = 2^0 = 1, and the first tile with a real key
// wipes that mass with alpha = 2^(-1e30 - m) = 0, as the TPU kernel, which
// visits every tile, does.  No atomics and no split over keys: two
// launches on the same inputs give bitwise-equal outputs.
//
// Plain C interface for ctypes: pointers and the stream come in as void*,
// shapes and strides (in elements) as host int64 arrays; the entry returns
// cudaGetLastError() after its launch, or a negative code when the tensor
// maps cannot be built.  cuTensorMapEncodeTiled is reached through the
// runtime's driver entry point, so the library needs no -lcuda.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 128;  // query rows per CTA
constexpr int kBN = 128;  // key rows per tile
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr float kNegInf = -1e30f;
// setmaxnreg moves registers inside the 168 x 384 the CTA launches with
// (__launch_bounds__(384, 1)): the split must add up to no more, or the
// consumers' increase waits forever.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert(kConsumers * 128 * kConsumerRegs + 128 * kProducerRegs <= 168 * kThreads,
              "the register split exceeds what the CTA launches with");
constexpr int kSmemLimit = 232448;  // bytes a block may use on sm_90

template <int D>
struct Cfg {
  static constexpr int kAtom = D % 64 == 0 ? 64 : 32;  // columns per swizzle atom
  static constexpr int kAtoms = D / kAtom;
  static constexpr int kRowBytes = kAtom * 2;           // 128 (B128) or 64 (B64)
  static constexpr uint64_t kLayout = kAtom == 64 ? 1 : 2;  // wgmma descriptor layout type
  static constexpr uint32_t kSwzMask = kAtom == 64 ? 7 : 3;
  static constexpr int kQBytes = kBM * D * 2;
  static constexpr int kTileBytes = kBN * D * 2;
  static constexpr int kBarrierBytes = 256;
  static constexpr int kStagesFit = (kSmemLimit - 1024 - kBarrierBytes - kQBytes) / (2 * kTileBytes);
  static constexpr int kStages = kStagesFit < 4 ? kStagesFit : 4;
  static constexpr int kSmem = 1024 + kQBytes + 2 * kStages * kTileBytes + kBarrierBytes;
  static_assert(D % kAtom == 0 && D % 16 == 0, "head dim must split into swizzle atoms");
  static_assert(kStages >= 2, "the ring needs at least 2 stages");
  static_assert(kSmem <= kSmemLimit, "shared memory over the sm_90 limit");
};

struct Params {
  int s, hq, group;  // sequence length, query heads, query heads per kv head
  int causal;
  int window;        // 0: no window
  float scale_log2;  // 1/sqrt(d) * log2(e)
};

// ---- shared memory, barriers, TMA -------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Waits for the phase of the given parity to complete.  (A poll counter
// that traps after too many polls costs the d 128 consumer a spill.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- wgmma --------------------------------------------------------------------

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (all in 16-byte units), swizzle layout type in bits 62-63.
template <uint64_t Layout>
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (Layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The products, one warpgroup-wide instruction each: S (64 x 128 keys) from
// two shared-memory descriptors, and O (64 x d) += P (registers) . V.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 64) {
    wgmma_rs_n64(d, a, db);
  } else if constexpr (D == 96) {
    wgmma_rs_n96(d, a, db);
  } else {
    wgmma_rs_n128(d, a, db);
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---- the kernel ---------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_o, const Params p) {
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles need 1024-byte aligned bases
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;  // [atom][kBM][kAtom]
  const uint32_t sk = sq + C::kQBytes;                          // [stage][atom][kBN][kAtom]
  const uint32_t sv = sk + C::kStages * C::kTileBytes;          // [stage][atom][kBN][kAtom]
  const uint32_t bars = sv + C::kStages * C::kTileBytes;
  const uint32_t bar_q = bars;
  const uint32_t bar_k = bars + 8;                      // + 8 * stage
  const uint32_t bar_v = bar_k + 8 * C::kStages;        // + 8 * stage
  const uint32_t bar_empty = bar_v + 8 * C::kStages;    // + 8 * stage

  const int b = blockIdx.x / p.hq;
  const int h = blockIdx.x % p.hq;
  const int hk = h / p.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;
  // the key tiles holding a key some row of this CTA may see
  const int q_last = min(q0 + kBM, p.s) - 1;
  const int k_end = p.causal ? q_last + 1 : p.s;
  const int k_begin = (p.window > 0 && q0 - p.window + 1 > 0) ? q0 - p.window + 1 : 0;
  const int t_begin = k_begin / kBN;
  const int n_tiles = (k_end + kBN - 1) / kBN - t_begin;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer: one thread keeps the ring of K and V stages filled ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers * 128) {
      prefetch_map(&tm_q);
      prefetch_map(&tm_k);
      prefetch_map(&tm_v);
      prefetch_map(&tm_o);
      mbar_expect_tx(bar_q, C::kQBytes);
#pragma unroll
      for (int a = 0; a < C::kAtoms; ++a)
        tma_load_4d(sq + a * kBM * C::kRowBytes, &tm_q, bar_q, a * C::kAtom, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % C::kStages;
        // the stage's previous tile is released (passes at once on the first lap)
        mbar_wait(bar_empty + 8 * s, ((it / C::kStages) & 1) ^ 1);
        const int k0 = (t_begin + it) * kBN;
        const uint32_t kt = sk + s * C::kTileBytes, vt = sv + s * C::kTileBytes;
        mbar_expect_tx(bar_k + 8 * s, C::kTileBytes);
#pragma unroll
        for (int a = 0; a < C::kAtoms; ++a)
          tma_load_4d(kt + a * kBN * C::kRowBytes, &tm_k, bar_k + 8 * s, a * C::kAtom, hk, k0, b);
        mbar_expect_tx(bar_v + 8 * s, C::kTileBytes);
#pragma unroll
        for (int a = 0; a < C::kAtoms; ++a)
          tma_load_4d(vt + a * kBN * C::kRowBytes, &tm_v, bar_v + 8 * s, a * C::kAtom, hk, k0, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    // this thread's accumulator rows (row_a and row_a + 8) and first column
    const int r_wg = q0 + wg * 64;
    const int row_a = r_wg + warp * 16 + lane / 4;
    const int col = 2 * (lane % 4);
    const uint32_t q_wg = sq + wg * 64 * C::kRowBytes;
    constexpr uint32_t kSbo = 8 * C::kRowBytes;            // next 8 rows
    constexpr uint32_t kVLbo = kBN * C::kRowBytes;         // next column atom of a V tile

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    float m_a = kNegInf, m_b = kNegInf, l_a = 0.0f, l_b = 0.0f;  // l: this thread's share
    float sc[64];

    mbar_wait(bar_q, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % C::kStages;
      const uint32_t phase = (it / C::kStages) & 1;
      const int k0 = (t_begin + it) * kBN;

      // S = Q K^T, both K-major in shared memory
      mbar_wait(bar_k + 8 * s, phase);
      const uint32_t kt = sk + s * C::kTileBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t atom = kk * 16 / C::kAtom, off = (kk * 16 % C::kAtom) * 2;
        const uint64_t da = gmma_desc<C::kLayout>(q_wg + atom * kBM * C::kRowBytes + off, 16, kSbo);
        const uint64_t db = gmma_desc<C::kLayout>(kt + atom * kBN * C::kRowBytes + off, 16, kSbo);
        wgmma_ss_n128(sc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // logits in the base-2 domain; mask only the tiles that need it
      const bool need_mask = (p.causal && k0 + kBN - 1 > r_wg) ||
                             (p.window > 0 && k0 <= r_wg + 63 - p.window) || k0 + kBN > p.s;
      if (need_mask) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * j + col + (e & 1);
            const int row = row_a + 8 * (e >> 1);
            bool ok = key < p.s;
            if (p.causal) ok = ok && key <= row;
            if (p.window > 0) ok = ok && key > row - p.window;
            sc[4 * j + e] = ok ? __fmul_rn(sc[4 * j + e], p.scale_log2) : kNegInf;
          }
      } else {
#pragma unroll
        for (int i = 0; i < 64; ++i) sc[i] = __fmul_rn(sc[i], p.scale_log2);
      }

      // online softmax: rows spread over a quad of 4 lanes
      float mx_a = m_a, mx_b = m_b;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      mx_a = quad_max(mx_a);
      mx_b = quad_max(mx_b);
      const float alpha_a = ex2(m_a - mx_a), alpha_b = ex2(m_b - mx_b);
      m_a = mx_a;
      m_b = mx_b;
      float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        sc[4 * j] = ex2(sc[4 * j] - m_a);
        sc[4 * j + 1] = ex2(sc[4 * j + 1] - m_a);
        sc[4 * j + 2] = ex2(sc[4 * j + 2] - m_b);
        sc[4 * j + 3] = ex2(sc[4 * j + 3] - m_b);
        sum_a += sc[4 * j] + sc[4 * j + 1];
        sum_b += sc[4 * j + 2] + sc[4 * j + 3];
      }
      l_a = l_a * alpha_a + sum_a;
      l_b = l_b * alpha_b + sum_b;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= alpha_a;
        o[4 * j + 1] *= alpha_a;
        o[4 * j + 2] *= alpha_b;
        o[4 * j + 3] *= alpha_b;
      }

      // P as bf16 A fragments: 16 keys each, in the accumulator's own layout
      uint32_t pa[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }

      // O += P V: P from registers, V in shared memory, MN-major
      mbar_wait(bar_v + 8 * s, phase);
      const uint32_t vt = sv + s * C::kTileBytes;
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_rs<D>(o, pa[kk], gmma_desc<C::kLayout>(vt + kk * 16 * C::kRowBytes, kVLbo, kSbo));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);
    }

    // epilogue: o / max(l, 1e-30) in bf16, through this warpgroup's rows of
    // the Q tile (no longer read) and one TMA store per column atom
    // one reciprocal per row (MUFU.RCP, 2 ulp): an IEEE division per element
    // calls a slow-path subroutine that spills while all of o is live
    const float inv_a = __fdividef(1.0f, fmaxf(quad_sum(l_a), 1e-30f));
    const float inv_b = __fdividef(1.0f, fmaxf(quad_sum(l_b), 1e-30f));
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + col;
      const uint32_t atom_base = q_wg + (c / C::kAtom) * kBM * C::kRowBytes;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = warp * 16 + lane / 4 + 8 * half;
        uint32_t off = r * C::kRowBytes + (c % C::kAtom) * 2;
        off ^= (off >> 3) & (C::kSwzMask << 4);  // the TMA swizzle: 16-byte chunk ^= row bits
        const float inv = half ? inv_b : inv_a;
        const uint32_t val = pack_bf16(o[4 * j + 2 * half] * inv, o[4 * j + 2 * half + 1] * inv);
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(atom_base + off), "r"(val) : "memory");
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_barrier(1 + wg, 128);
    if (t == 0) {
#pragma unroll
      for (int a = 0; a < C::kAtoms; ++a)
        tma_store_4d(&tm_o, q_wg + a * kBM * C::kRowBytes, a * C::kAtom, h, r_wg, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

// ---- host side ------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* entry = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &entry, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &entry, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(entry);
  }
  return fn;
}

// A (D, H, S, B) map of a bf16 tensor with element strides (b, s, h) and a
// contiguous last axis; boxes of one column atom, one head, `rows` rows.
template <int D>
bool make_map(CUtensorMap* map, EncodeTiled encode, const void* ptr, int64_t heads, int64_t s,
              int64_t batch, const int64_t* stride_bsh, uint32_t rows) {
  using C = Cfg<D>;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(s), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(stride_bsh[2]) * 2,
                                 static_cast<cuuint64_t>(stride_bsh[1]) * 2,
                                 static_cast<cuuint64_t>(stride_bsh[0]) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(C::kAtom), 1, rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      C::kAtom == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kNoEncoder = -1;   // the driver has no cuTensorMapEncodeTiled
constexpr int kBadMap = -2;      // a tensor map was refused (alignment, strides)

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* o, const int64_t* dims,
             const int64_t* strides, const Params& p, cudaStream_t stream) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kNoEncoder;
  const int64_t batch = dims[0], s = dims[1], hq = dims[2], hkv = dims[3];
  CUtensorMap mq, mk, mv, mo;
  if (!make_map<D>(&mq, encode, q, hq, s, batch, strides, kBM) ||
      !make_map<D>(&mk, encode, k, hkv, s, batch, strides + 3, kBN) ||
      !make_map<D>(&mv, encode, v, hkv, s, batch, strides + 6, kBN) ||
      !make_map<D>(&mo, encode, o, hq, s, batch, strides + 9, 64))
    return kBadMap;
  auto kernel = flash_attention_wgmma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Cfg<D>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>(batch * hq), static_cast<unsigned int>((s + kBM - 1) / kBM));
  kernel<<<grid, kThreads, Cfg<D>::kSmem, stream>>>(mq, mk, mv, mo, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dims: batch, seq, q heads, kv heads, head dim.
// strides: (batch, seq, head) element strides of q, k, v, o in that order.
int repro_flash_attention_wgmma_bf16(const void* q, const void* k, const void* v, void* o,
                                     const int64_t* dims, const int64_t* strides, float scale,
                                     int causal, int64_t window, void* stream) {
  Params p;
  p.s = static_cast<int>(dims[1]);
  p.hq = static_cast<int>(dims[2]);
  p.group = static_cast<int>(dims[2] / dims[3]);
  p.causal = causal;
  p.window = (window > 0 && window < dims[1]) ? static_cast<int>(window) : 0;  // >= S never bites
  p.scale_log2 = scale * 1.4426950408889634f;
  auto st = static_cast<cudaStream_t>(stream);
  switch (dims[4]) {
    case 64: return launch_d<64>(q, k, v, o, dims, strides, p, st);
    case 96: return launch_d<96>(q, k, v, o, dims, strides, p, st);
    case 128: return launch_d<128>(q, k, v, o, dims, strides, p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
