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
//   - On request the epilogue writes each row's logsumexp L, which the
//     backward (flash_attention_bwd.cu) reads instead of forming it again:
//     in base 2 that is (m + log2 l) ln 2 of the row's running max and sum.
// The tensor maps are built on the host with cuTensorMapEncodeTiled, reached
// through the runtime's cudaGetDriverEntryPoint(ByVersion), so the library
// links nothing beyond the CUDA runtime (no -lcuda).
#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kStages = 2;       // K/V ring depth
constexpr int kBK = 64;          // keys per tile
constexpr int kKS = kBK / 16;    // k-steps of P V per tile

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
                      __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, int Sq, int Skv, int Hq,
                      int K, int hd, int causal, int window, int q_off) {
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
    // L in natural-log units: m and l are base 2 (scores times log2 e)
    if (lse != nullptr && cq == 0)
      lse[((long)b * Hq + h) * Sq + row] =
          (m[i] + log2f(l[i])) * 0.6931471805599453f;
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

template <int HDP, int BQ>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int Sq, int Skv, int Hq, int K, int hd,
                   int causal, int window, int q_off, cudaStream_t stream) {
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
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), lse, Sq, Skv, Hq, K, hd,
      causal, window, q_off);
  return cudaGetLastError();
}

}  // namespace

// C interface (bound with ctypes). Pointers are contiguous bf16 device
// tensors, 16-byte aligned; hd a multiple of 8 (TMA needs 16-byte strides)
// up to 256; window <= 0 means no window. lse, when not null, is an fp32
// (B, Hq, Sq) buffer that receives each row's logsumexp of its masked,
// scaled scores (natural log), which the backward reads; null leaves the
// kernel's arithmetic and stores as they are. Returns a cudaError_t.
extern "C" int flash_attention_fwd_sm90(const void* q, const void* k,
                                        const void* v, void* out, void* lse,
                                        int B, int Sq, int Skv, int Hq,
                                        int K, int hd, int causal, int window,
                                        int q_off, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || K <= 0 || Hq % K != 0 || hd <= 0 ||
      hd > 256 || hd % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* rows = static_cast<float*>(lse);
  if (hd <= 64)
    return (int)launch<64, 128>(q, k, v, out, rows, B, Sq, Skv, Hq, K, hd,
                                causal, window, q_off, s);
  if (hd <= 128)
    return (int)launch<128, 128>(q, k, v, out, rows, B, Sq, Skv, Hq, K, hd,
                                 causal, window, q_off, s);
  return (int)launch<256, 64>(q, k, v, out, rows, B, Sq, Skv, Hq, K, hd,
                              causal, window, q_off, s);
}
