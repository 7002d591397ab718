// Flash prefill attention in bf16 on Hopper's tensor cores (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// flash_attention_pallas (body _fa_kernel) for bf16 operands, with the
// contract of flash_attention.cu (which keeps the fp32 route):
//   q (B, Sq, Hq, hd), k/v (B, Skv, K, hd), K | Hq, hd a multiple of 8 up to
//   256, any Sq and Skv (ragged tails masked), causal and/or a sliding
//   window, query positions offset by q_pos_offset. Query head h reads KV
//   head h / (Hq / K) in place, through the tensor map's head coordinate:
//   GQA is never expanded. Scores, softmax and accumulation are fp32; the
//   output is bf16.
//
// What bounds it on an H100: the operations. Per (query, key) pair it does
// 4*hd flops and it reads each q/k/v element once per tile pair, so at
// prompts of a few hundred tokens and up the products, not the bytes, set
// the least time: 989 TFLOP/s in bf16 on the tensor cores.
//
// How it reaches the tensor cores: both products run on wgmma (m64nNk16,
// bf16 in, fp32 accumulators in registers).
//   - One producer warp issues TMA loads: the block's Q tile once, then K
//     and V tiles of 64 keys into two 2-stage rings in shared memory, each
//     stage guarded by a full and an empty mbarrier. Each operand is cut
//     into head-dim slabs of 64 columns (128 bytes), loaded with the
//     128-byte swizzle that wgmma's shared-memory descriptors read without
//     bank conflicts. TMA's out-of-bounds zero fill pads hd < 64 to one slab
//     and a ragged sequence to a whole tile; keys at or past Skv are still
//     masked (a zero row scores 0).
//   - One or two consumer warpgroups each own 64 query rows: S = Q K^T
//     (m64n64) with both operands from shared memory (K-major), the mask and
//     the online softmax in the accumulator's own registers (a row lives in
//     the 4 lanes of a quad), then O += P V (m64n{hd}) with P from registers
//     as wgmma's A operand and V from shared memory through the transpose
//     bit (V is keys x hd).
//   - Inside a warpgroup the tensor cores and the softmax overlap: the
//     products of tile j are issued, then those of P V for tile j - 1, and
//     the softmax of tile j runs while the latter are in flight. K and V
//     have rings of their own, so K j + 1 lands while V j - 1 is still read.
//   - P is split into bf16(P) and bf16(P - bf16(P)), two P V products, so
//     the weights keep ~16 bits as the fp32 reference's do; bf16(P) alone
//     puts rows with few keys past the card test's elementwise limit.
//   - KV tiles wholly above the causal diagonal or wholly left of the window
//     are never loaded; the q tiles with the most keys are scheduled first.
//   - Registers: with two consumer warpgroups a thread has at most 168, so
//     S is 64 keys wide (128 spills); one warpgroup at hd 256 has 255.
// The tensor maps are built on the host with cuTensorMapEncodeTiled, reached
// through the runtime's cudaGetDriverEntryPoint(ByVersion), so the library
// links nothing beyond the CUDA runtime (no -lcuda).
#include <cuda.h>

#include "common.cuh"

namespace {

constexpr int kStages = 2;       // K/V ring depth
constexpr int kSlab = 64;        // head-dim columns per slab (128 bytes)
constexpr int kRowBytes = 128;   // one slab row in shared memory
constexpr int kBK = 64;          // keys per tile
constexpr int kKS = kBK / 16;    // k-steps of P V per tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// Wait until the phase of parity `parity` has completed. A load that never
// lands traps after ~4e9 cycles (~2 s), so the launch fails with an error
// instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > 4000000000ll) __trap();
  }
}

// --- TMA -------------------------------------------------------------------

// One box of a 4-D tensor map (hd, heads, S, B) into shared memory; the
// barrier's transaction count drops by the box's bytes when it lands.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// --- wgmma -----------------------------------------------------------------

// Shared-memory matrix descriptor of a 128-byte-swizzled tile (the layout
// TMA writes with CU_TENSOR_MAP_SWIZZLE_128B into a 1024-byte-aligned slab):
// 8-row groups of 128-byte rows, 1024 bytes apart. K-major (Q, K): sbo is
// that group stride along M or N and lbo is unused (1, as CUTLASS sets it).
// MN-major (V, transposed): sbo is the group stride along K (keys) and lbo
// the stride from one 64-column slab to the next along N.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3ffff) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3fff) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3fff) << 32) | ((uint64_t)1 << 62);
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
// Keep the compiler from moving reads or writes of an accumulator across the
// asynchronous product (the asm statements stay in order).
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Operands of an m64nNk16 product's N / 2 fp32 accumulators.
#define RT_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define RT_F16(d, i) \
  RT_F4(d, i), RT_F4(d, i + 4), RT_F4(d, i + 8), RT_F4(d, i + 12)
#define RT_F32(d, i) RT_F16(d, i), RT_F16(d, i + 16)
#define RT_F64(d, i) RT_F32(d, i), RT_F32(d, i + 32)
#define RT_F128(d, i) RT_F64(d, i), RT_F64(d, i + 64)
#define RT_LIST32 \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, " \
  "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31" \
  "}"
#define RT_LIST64 \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, " \
  "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, " \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, " \
  "%60, %61, %62, %63" \
  "}"
#define RT_LIST128 \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, " \
  "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, " \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, " \
  "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, " \
  "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, " \
  "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, " \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, " \
  "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, " \
  "%120, %121, %122, %123, %124, %125, %126, %127" \
  "}"

// m64nNk16, bf16 in, fp32 accumulators d (N / 2 a thread):
//   ss (N = 64): d (+)= A B^T, A (64 x 16) and B (N x 16) K-major in shared
//       memory; scale_d = 0 overwrites d;
//   rs: d += A B, A (64 x 16) as bf16 pairs in registers, B (16 x N) read
//       MN-major (transposed) from shared memory.
template <int N>
struct Mma;
template <>
struct Mma<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " RT_LIST32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : RT_F32(d, 0)
        : "l"(da), "l"(db), "r"(scale_d));
  }
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " RT_LIST32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : RT_F32(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};
template <>
struct Mma<128> {
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " RT_LIST64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : RT_F64(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};
template <>
struct Mma<256> {
  static __device__ __forceinline__ void rs(float (&d)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " RT_LIST128
        ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : RT_F128(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// --- the kernel ------------------------------------------------------------

// HDP: head dim padded to slabs; BQ: query rows per block (64 per consumer
// warpgroup).
template <int HDP, int BQ>
struct Tile {
  static constexpr int kSlabs = HDP / kSlab;
  static constexpr int kGroups = BQ / 64;           // consumer warpgroups
  static constexpr int kThreads = 128 * kGroups + 32;  // + producer warp
  static constexpr int kQBytes = kSlabs * BQ * kRowBytes;
  static constexpr int kKVBytes = kSlabs * kBK * kRowBytes;  // K or V tile
  static constexpr int kSmem =
      1024 + kQBytes + 2 * kStages * kKVBytes + 8 * (1 + 4 * kStages);
};

// The mask and online-softmax update of one score tile in registers: s
// becomes exp2(s - m_new), alpha the factor by which the old sums shrink.
__device__ __forceinline__ void softmax_tile(float (&s)[kBK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], bool edge,
                                             int k0, int cq,
                                             const int (&qpos)[2], int Skv,
                                             int causal, int window,
                                             float sl2) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float x = s[4 * j + 2 * i + c] * sl2;
        if (edge) {
          const int key = k0 + 8 * j + cq + c;
          const bool ok = key < Skv && (!causal || key <= qpos[i]) &&
                          (window <= 0 || key > qpos[i] - window);
          x = ok ? x : rt::kNegInf;
        }
        s[4 * j + 2 * i + c] = x;
        mx[i] = fmaxf(mx[i], x);
      }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    alpha[i] = exp2f(m[i] - mx[i]);
    m[i] = mx[i];
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float p = exp2f(s[4 * j + 2 * i + c] - m[i]);
        s[4 * j + 2 * i + c] = p;
        l[i] += p;
      }
}

__device__ __forceinline__ void split_p(const float (&s)[kBK / 2],
                                        uint32_t (&p_hi)[kKS][4],
                                        uint32_t (&p_lo)[kKS][4]) {
#pragma unroll
  for (int kk = 0; kk < kKS; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int base = 4 * (2 * kk + r / 2) + 2 * (r % 2);
      const float a = s[base], bb = s[base + 1];
      const float ah = __bfloat162float(__float2bfloat16(a));
      const float bh = __bfloat162float(__float2bfloat16(bb));
      p_hi[kk][r] = pack_bf16(ah, bh);
      p_lo[kk][r] = pack_bf16(a - ah, bb - bh);
    }
}

template <int HDP, int BQ>
__global__ void __launch_bounds__(Tile<HDP, BQ>::kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      __nv_bfloat16* __restrict__ out, int Sq, int Skv,
                      int Hq, int K, int hd, int causal, int window,
                      int q_off) {
  using T = Tile<HDP, BQ>;
  constexpr int NS = T::kSlabs;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = smem;
  uint8_t* k_s = q_s + T::kQBytes;
  uint8_t* v_s = k_s + kStages * T::kKVBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + kStages * T::kKVBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + kStages;
  uint64_t* v_full = k_empty + kStages;
  uint64_t* v_empty = v_full + kStages;

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int kh = h / (Hq / K);
  const int q_lo = q_off + q0;
  const int q_hi = q_off + min(q0 + BQ, Sq) - 1;
  const int kv_end = causal ? min(Skv, q_hi + 1) : Skv;
  int kv_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  kv_begin -= kv_begin % kBK;
  const int n_tiles = max(0, (kv_end - kv_begin + kBK - 1) / kBK);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], 128 * T::kGroups);
      mbar_init(&v_empty[s], 128 * T::kGroups);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  if (warp == 4 * T::kGroups) {
    if (threadIdx.x % 32 != 0) return;
    mbar_expect_tx(q_full, T::kQBytes);
    for (int s = 0; s < NS; ++s)
      tma_load(q_s + s * BQ * kRowBytes, &tm_q, q_full, s * kSlab, h, q0, b);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % kStages, free = ((it / kStages) & 1) ^ 1;
      const int k0 = kv_begin + it * kBK;
      mbar_wait(&k_empty[st], free);
      mbar_expect_tx(&k_full[st], T::kKVBytes);
      for (int s = 0; s < NS; ++s)
        tma_load(k_s + st * T::kKVBytes + s * kBK * kRowBytes, &tm_k,
                 &k_full[st], s * kSlab, kh, k0, b);
      mbar_wait(&v_empty[st], free);
      mbar_expect_tx(&v_full[st], T::kKVBytes);
      for (int s = 0; s < NS; ++s)
        tma_load(v_s + st * T::kKVBytes + s * kBK * kRowBytes, &tm_v,
                 &v_full[st], s * kSlab, kh, k0, b);
    }
    return;
  }

  const int g = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int r0 = 64 * g + 16 * (tid / 32) + lane / 4;
  const int cq = 2 * (lane % 4);
  const int qpos[2] = {q_off + q0 + r0, q_off + q0 + r0 + 8};
  const int wq_lo = q_off + q0 + 64 * g, wq_hi = wq_lo + 63;
  const float sl2 = 1.4426950408889634f / sqrtf((float)hd);

  float o[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
  float s[kBK / 2];
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) s[i] = 0.f;
  float m[2] = {rt::kNegInf, rt::kNegInf}, l[2] = {0.f, 0.f}, alpha[2];
  uint32_t p_hi[kKS][4], p_lo[kKS][4];
  const uint32_t q_addr = smem_u32(q_s) + g * 64 * kRowBytes;

  auto issue_s = [&](int st) {
    const uint32_t k_addr = smem_u32(k_s) + st * T::kKVBytes;
    wgmma_fence();
#pragma unroll
    for (int sl = 0; sl < NS; ++sl)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Mma<kBK>::ss(
            s, desc_sw128(q_addr + sl * BQ * kRowBytes + kk * 32, 16, 1024),
            desc_sw128(k_addr + sl * kBK * kRowBytes + kk * 32, 16, 1024),
            (sl | kk) != 0);
    wgmma_commit();
  };
  auto issue_pv = [&](int st) {
    const uint32_t v_addr = smem_u32(v_s) + st * T::kKVBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
      const uint64_t dv =
          desc_sw128(v_addr + kk * 16 * kRowBytes, kBK * kRowBytes, 1024);
      Mma<HDP>::rs(o, p_hi[kk], dv);
      Mma<HDP>::rs(o, p_lo[kk], dv);
    }
    wgmma_commit();
  };
  auto edge_of = [&](int k0) {
    return k0 + kBK > Skv || (causal && k0 + kBK - 1 > wq_lo) ||
           (window > 0 && k0 <= wq_hi - window);
  };

  mbar_wait(q_full, 0);
  if (n_tiles > 0) {   // tile 0: S, softmax, P
    mbar_wait(&k_full[0], 0);
    issue_s(0);
    wgmma_wait_all();
    fence_regs(s);
    mbar_arrive(&k_empty[0]);
    softmax_tile(s, m, l, alpha, edge_of(kv_begin), kv_begin, cq, qpos, Skv,
                 causal, window, sl2);
    split_p(s, p_hi, p_lo);
  }

  // tile it's S and softmax run while tile it-1's P V is on the tensor cores
  for (int it = 1; it < n_tiles; ++it) {
    const int st = it % kStages, pst = (it - 1) % kStages;
    const int k0 = kv_begin + it * kBK;
    mbar_wait(&k_full[st], (it / kStages) & 1);
    issue_s(st);
    mbar_wait(&v_full[pst], ((it - 1) / kStages) & 1);
    issue_pv(pst);
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_regs(s);
    mbar_arrive(&k_empty[st]);
    softmax_tile(s, m, l, alpha, edge_of(k0), k0, cq, qpos, Skv, causal,
                 window, sl2);
    wgmma_wait_all();
    fence_regs(o);
    mbar_arrive(&v_empty[pst]);
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        o[4 * j + 2 * i] *= alpha[i];
        o[4 * j + 2 * i + 1] *= alpha[i];
      }
    split_p(s, p_hi, p_lo);
  }
  if (n_tiles > 0) {
    const int pst = (n_tiles - 1) % kStages;
    mbar_wait(&v_full[pst], ((n_tiles - 1) / kStages) & 1);
    issue_pv(pst);
    wgmma_wait_all();
    fence_regs(o);
    mbar_arrive(&v_empty[pst]);
  }

  // epilogue: the row sum across the quad, then bf16 pairs of the rows < Sq
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = q0 + r0 + 8 * i;
    if (row >= Sq) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow = out + (((long)b * Sq + row) * Hq + h) * hd;
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      const int col = 8 * j + cq;
      if (col < hd)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(o[4 * j + 2 * i] * inv,
                                  o[4 * j + 2 * i + 1] * inv);
    }
  }
}

// --- host side -------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, through the runtime's entry-point
// query (so the library needs no -lcuda); null if libcuda lacks it.
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The 4-D map (hd, heads, S, B) of a contiguous bf16 (B, S, heads, hd)
// tensor, read in boxes of 64 columns x one head x `rows` rows, 128-byte
// swizzled, zero outside the tensor.
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int hd,
              int rows) {
  const EncodeTiled encode = encode_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {2ull * hd, 2ull * hd * H, 2ull * hd * H * S};
  const cuuint32_t box[4] = {(cuuint32_t)kSlab, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HDP, int BQ>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Skv, int Hq, int K, int hd, int causal,
                   int window, int q_off, cudaStream_t stream) {
  using T = Tile<HDP, BQ>;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, Sq, Hq, hd, BQ) ||
      !make_map(&tk, k, B, Skv, K, hd, kBK) ||
      !make_map(&tv, v, B, Skv, K, hd, kBK))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<HDP, BQ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Hq, (Sq + BQ - 1) / BQ, B);
  flash_fwd_sm90_kernel<HDP, BQ><<<grid, T::kThreads, T::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), Sq, Skv, Hq, K, hd, causal,
      window, q_off);
  return cudaGetLastError();
}

}  // namespace

// C interface (bound with ctypes). Pointers are contiguous bf16 device
// tensors, 16-byte aligned; hd a multiple of 8 (TMA needs 16-byte strides)
// up to 256; window <= 0 means no window. Returns a cudaError_t.
extern "C" int flash_attention_fwd_sm90(const void* q, const void* k,
                                        const void* v, void* out, int B,
                                        int Sq, int Skv, int Hq, int K,
                                        int hd, int causal, int window,
                                        int q_off, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || K <= 0 || Hq % K != 0 || hd <= 0 ||
      hd > 256 || hd % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= 64)
    return (int)launch<64, 128>(q, k, v, out, B, Sq, Skv, Hq, K, hd, causal,
                                window, q_off, s);
  if (hd <= 128)
    return (int)launch<128, 128>(q, k, v, out, B, Sq, Skv, Hq, K, hd,
                                 causal, window, q_off, s);
  return (int)launch<256, 64>(q, k, v, out, B, Sq, Skv, Hq, K, hd, causal,
                              window, q_off, s);
}
