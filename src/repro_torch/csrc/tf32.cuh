// Split TF32 on mma.sync.m16n8k8, the cp.async copies that feed it, and the
// gate scan of one mLSTM chunk: shared by the chunkwise mLSTM
// (mlstm_chunk.cu) and its backward (mlstm_chunk_bwd.cu); the RG-LRU scan's
// backward (rglru_scan.cu) stages its chunks with the cp.async copies.
#pragma once

#include "sm90.cuh"

namespace tf32 {

using sm90::smem_u32;

// 16 (or 4) bytes from global to shared, or zeros where ok is false (src is
// then not read).
__device__ __forceinline__ void cp_async16(void* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}
using sm90::cp_async_commit;
using sm90::cp_async_wait;

// ---------------------------------------------------------------------------
// split TF32 on mma.sync.m16n8k8
// ---------------------------------------------------------------------------

struct Tf32 {
  uint32_t hi, lo;
};

// cvt.rna.tf32.f32 for finite x: add half of the 13 dropped bits' unit to
// the magnitude, then clear them. (The instruction itself compiles to about
// twice the instructions, checking for inf and NaN, which the operands here
// are not; the splits outnumber the products several times over.)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ Tf32 split(float x) {
  const uint32_t hi = tf32_rna(x);
  return {hi, tf32_rna(x - __uint_as_float(hi))};
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += a b for one 16 x 8 x 8 step: a_lo b_hi + a_hi b_lo + a_hi b_hi.
// Fragments (g = lane / 4, t = lane % 4): a[0..3] hold A's (g, t),
// (g + 8, t), (g, t + 4), (g + 8, t + 4); b[0..1] hold B's (k = t, n = g),
// (t + 4, g); d[0..3] hold (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void mma3(float (&d)[4], const Tf32 (&a)[4],
                                     const Tf32 (&b)[2]) {
  mma_tf32(d, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hi, b[1].hi);
  mma_tf32(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);
  mma_tf32(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
}

// A fragment from a tile stored by rows: A(m, k) = p[m * ld + k].
__device__ __forceinline__ void load_a(Tf32 (&a)[4], const float* p, int ld,
                                       int g, int t) {
  a[0] = split(p[g * ld + t]);
  a[1] = split(p[(g + 8) * ld + t]);
  a[2] = split(p[g * ld + t + 4]);
  a[3] = split(p[(g + 8) * ld + t + 4]);
}

// A fragment from a tile stored by k: A(m, k) = p[k * ld + m].
__device__ __forceinline__ void load_at(Tf32 (&a)[4], const float* p, int ld,
                                        int g, int t) {
  a[0] = split(p[t * ld + g]);
  a[1] = split(p[t * ld + g + 8]);
  a[2] = split(p[(t + 4) * ld + g]);
  a[3] = split(p[(t + 4) * ld + g + 8]);
}

// B fragment from a tile stored by k: B(k, n) = p[k * ld + n].
__device__ __forceinline__ void load_b(Tf32 (&b)[2], const float* p, int ld,
                                       int g, int t) {
  b[0] = split(p[t * ld + g]);
  b[1] = split(p[(t + 4) * ld + g]);
}

// B fragment from a tile stored by n: B(k, n) = p[n * ld + k].
__device__ __forceinline__ void load_bt(Tf32 (&b)[2], const float* p, int ld,
                                        int g, int t) {
  b[0] = split(p[g * ld + t]);
  b[1] = split(p[g * ld + t + 4]);
}

// ---------------------------------------------------------------------------
// gates of one chunk
// ---------------------------------------------------------------------------

// The gates of one chunk of 32 kPer steps, read by one warp from
// li[s * stride], lf[s * stride]: lane l holds steps kPer l .. kPer l + kPer
// - 1. Steps s >= Lc (past S) get log_i = -1e30 and log_f = 0. F[i] is the
// chunk's cumulative log_f up to step kPer l + i, summed in fp64: h divides
// by a sum of weights exp(F_t - F_s + ...) that can cancel, and the
// rounding of fp32 sums of the gates moves h by ~1e-4. Every pass that
// needs F, forward and backward, computes it here.
template <int kPer>
struct Gates {
  double F[kPer];
  float li[kPer];
};

template <int kPer>
__device__ __forceinline__ Gates<kPer> chunk_gates(const float* li,
                                                   const float* lf,
                                                   int stride, int Lc,
                                                   int lane) {
  constexpr unsigned kFull = 0xffffffffu;
  Gates<kPer> r;
  double sum = 0.0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int s = kPer * lane + i;
    r.li[i] = s < Lc ? li[s * stride] : rt::kNegInf;
    sum += s < Lc ? lf[s * stride] : 0.f;
    r.F[i] = sum;
  }
  double incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  double excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 0.0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) r.F[i] += excl;
  return r;
}

}  // namespace tf32
