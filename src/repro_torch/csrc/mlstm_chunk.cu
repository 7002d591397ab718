// Chunkwise stabilised mLSTM for Hopper (sm_90a): three launches, every
// product on the tensor cores in split TF32.
//
// Replaces the TPU kernel src/repro/kernels/mlstm_chunk/kernel.py::
// mlstm_chunk_pallas (body _mlstm_kernel), and computes what the model's
// src/repro/models/xlstm.py::_mlstm_chunk_scan computes: per (batch, head),
// over q, k, v (B, S, nh, hd) and gates log_i, log_f (B, S, nh), all fp32,
// the matrix memory C (hd, hd), normaliser n (hd) and log-max m carried
// across chunks of S; within a chunk
//   F_t = sum_{s<=t} log_f_s,  D[t,s] = F_t - F_s + log_i_s (s <= t),
//   m_row_t = max(max_s D[t,s], m + F_t),
//   w[t,s] = (q_t . k_s) exp(D[t,s] - m_row_t),
//   h_t = (sum_s w[t,s] v_s + exp(m + F_t - m_row_t) q_t C)
//         / max(|sum_s w[t,s] + exp(m + F_t - m_row_t) q_t . n|,
//               exp(-m_row_t)),
// then at the chunk's end C, n, m advance by the chunk's keys and values.
// Unlike the TPU kernel it takes an initial (C, n, m) and writes the final
// one (the engine hands it from prefill to decode), takes any S >= 1 by
// masking the steps past S (log_i = -1e30: they inject nothing; log_f = 0:
// they do not decay the state), and any hd that is a multiple of 32 up to
// 512 (tiles past hd are masked).
//
// The chunk (kL = 64 steps) need not be the model's 256: the function is
// the same for any chunk, and the final m is the log-max over all steps for
// any chunking. Its rounding is not the same: h divides by a denominator
// that can cancel, so an error of 1e-6 in the weights' exponents moves h by
// ~1e-4. The kernel sums the gates in fp64 (chunk_gates) and keeps the
// tensor cores' sums short, and holds 2e-4 against the plain version
// evaluated in fp64; the plain version's own fp32 rounding on the card
// reaches 2.7e-4 at the served shape.
//
// What bounds it on an H100: operations. The chunkwise form at this
// kernel's chunk needs 4 B nh S hd^2 + 2 B nh S kL hd flops (q C and the C
// update, then the causal half of q k^T and w v): 9.13 GFLOP at the served
// model's prefill (B = 1, S = 2048, nh = 4, hd = 512), 0.136 ms at fp32's
// 67 TFLOP/s. Split TF32 does three TF32 products for each, 0.055 ms at 495
// TFLOP/s. Bytes: ~71 MB of operands, 0.021 ms at 3.35 TB/s, and the
// workspace below, written once and read once (~0.08 ms).
//
// The design splits the function into three launches on one stream, so no
// pass waits on the chunk recurrence except the one that must:
//   1. State pass, grid (tiles of C, B nh): each block owns a 64 x 64 tile
//      of C (hd / 64 squared of them: 256 blocks at the served shape) in
//      registers and walks the chunks in order. At chunk c it writes C_c,
//      the state entering the chunk, to the workspace, then advances
//      C <- C exp(m_c + F_L - m_{c+1}) + (k_c w)^T v_c, a 64 x 64 x kL
//      product. The next chunk's k and v tiles and gates are in flight
//      (cp.async) while it runs. The scalar recurrence of m (a warp scan of
//      the gates) is computed by every block with the same arithmetic; the
//      blocks of the first value tile also carry n.
//   2. Weight pass, grid (row tiles, chunks, B nh): W = (q k^T) exp(D -
//      m_row) over 16 rows of one chunk (512 blocks at the served shape),
//      with its row sums, q . n_c, the denominators and e = exp(m_c + F_t
//      - m_row_t). It is the only place q k^T is computed, once per (batch,
//      head, chunk), and only its causal part (row tile r needs keys
//      s < 16 (r + 1)).
//   3. Output pass, grid (chunks, 128-column value slices, B nh):
//      h[:, slice] = (e (q C_c[:, slice]) + W v[:, slice]) / den (512
//      blocks). Chunk 0 reads the given state, later chunks the workspace.
//      Both products stream through one double-buffered pair of tiles:
//      first q and C_c over hd, then W and v over the chunk's keys.
// Products use mma.sync.m16n8k8 with TF32 operands, each operand split as
// hi = tf32(x), lo = tf32(x - hi), and a_hi b_hi + a_hi b_lo + a_lo b_hi
// summed in fp32: one TF32 product cannot hold 1e-5 on the state. Each
// product's sum runs over at most 24 mma steps and is then added in fp32,
// so the tensor cores' own accumulation (which need not round to nearest)
// never carries a long sum. Shared-memory tiles are padded so every
// fragment load hits 32 different banks (there is no ldmatrix for 32-bit
// elements). Tiles move by 16-byte cp.async, so q, k, v and the given C
// are 16-byte aligned (the wrapper copies an operand that is not).
//
// Workspace (one buffer: mlstm_chunk_workspace_floats counts it, the
// wrapper allocates it, mlstm_chunk_fwd refuses one that is too small and
// cuts it into parts; the kernels allocate nothing), nc = ceil(S / 64):
//   C_c, n_c, m_c for chunks 1 .. nc-1   B nh (nc-1) (hd^2 + hd + 1) floats
//   W, e and den for every chunk         B nh nc kL (kL + 2) floats
// 132,440,560 bytes at B = 1, S = 2048, nh = 4, hd = 512.
#include "common.cuh"

namespace {

constexpr int kL = 64;        // steps of S per chunk
constexpr int kPer = kL / 32; // steps of a chunk per lane in the gate scans
constexpr int kT = 64;        // rows and columns of a C tile (state pass)
constexpr int kRows = 16;     // rows of W per weight-pass block
constexpr int kSlice = 128;   // value columns per output-pass block
constexpr int kK = 32;        // depth of a tile step along hd or the keys
constexpr int kMaxHd = 512;
constexpr unsigned kFull = 0xffffffffu;

// Row strides of the shared-memory tiles. A fragment load reads, over a
// warp, elements (8 groups g) x (4 slots t). Where g runs along a tile's
// rows a stride of 4 mod 32 puts them on 32 banks; where t does, 8 mod 32.
// Every stride is a multiple of 4 floats, so rows stay 16-byte aligned.
constexpr int kLdState = kT + 8;   // k and v tiles [step][column]
constexpr int kLdA = kK + 4;       // q, k and W tiles [row][depth]
constexpr int kLdB = kSlice + 8;   // C_c and v tiles [depth][value]

struct Params {
  const float *q, *k, *v, *log_i, *log_f, *C0, *n0, *m0;
  float *h, *C_out, *n_out, *m_out;
  float *wsC, *wsN, *wsM, *wsW, *wsE, *wsD;
  int S, nh, hd, nc;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

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

// The gates of one chunk, read by one warp from li[s * stride], lf[s *
// stride]: lane l holds steps kPer l .. kPer l + kPer - 1. Steps s >= Lc
// (past S) get log_i = -1e30 and log_f = 0. F[i] is the chunk's cumulative
// log_f up to step kPer l + i, summed in fp64: h divides by a sum of
// weights exp(F_t - F_s + ...) that can cancel, and the rounding of fp32
// sums of the gates moves h by ~1e-4. Both passes that need F compute it
// here.
struct Gates {
  double F[kPer];
  float li[kPer];
};

__device__ __forceinline__ Gates chunk_gates(const float* li,
                                             const float* lf, int stride,
                                             int Lc, int lane) {
  Gates r;
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

// ---------------------------------------------------------------------------
// 1. state pass
// ---------------------------------------------------------------------------

// Eight warps tile the 64 x 64 tile of C: 4 along its rows by 2 along its
// columns, each 16 rows by 32 columns (four n8 tiles).
constexpr int kStateThreads = 256;
constexpr int kNT = 4;        // n8 tiles per warp

struct StateSmem {
  float k[2][kL][kLdState];   // k[step][d - d0] of a chunk, double-buffered
  float v[2][kL][kLdState];   // v[step][j - j0]
  float li[2][kL], lf[2][kL];
  float w[kL];                // the chunk-end weights w_s
  float scal[2];              // m', exp(m + F_L - m')
};

__global__ void __launch_bounds__(kStateThreads)
mlstm_state_kernel(const Params p) {
  extern __shared__ float4 smem_raw[];
  StateSmem& sm = *reinterpret_cast<StateSmem*>(smem_raw);
  const int nt = (p.hd + kT - 1) / kT;
  const int d0 = (blockIdx.x / nt) * kT, j0 = (blockIdx.x % nt) * kT;
  const bool carries_n = j0 == 0;
  const int bh = blockIdx.y, b = bh / p.nh, h = bh % p.nh;
  const int S = p.S, hd = p.hd, nc = p.nc;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = 16 * (warp & 3), wc = 32 * (warp >> 2);  // warp's corner
  const long row = (long)p.nh * hd;   // stride of one step in q, k, v
  const long hd2 = (long)hd * hd;
  const long base = (long)b * S * row + (long)h * hd;

  // The C tile in accumulator layout: rows d0 + wr + g (+ 8), columns
  // j0 + wc + 8 n + 2 t4 (+ 1).
  auto row_ok = [&](int r) { return d0 + wr + g + 8 * r < hd; };
  auto col_ok = [&](int n) { return j0 + wc + 8 * n < hd; };
  auto at = [&](int n, int i) {
    return (long)(d0 + wr + g + 8 * (i >> 1)) * hd + j0 + wc + 8 * n +
           2 * t4 + (i & 1);
  };
  float C[kNT][4];
  const float* C0 = p.C0 + bh * hd2;
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      C[n][i] = row_ok(i >> 1) && col_ok(n) ? C0[at(n, i)] : 0.f;
  auto store = [&](float* dst) {
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row_ok(r) && col_ok(n))
          *reinterpret_cast<float2*>(dst + at(n, 2 * r)) =
              make_float2(C[n][2 * r], C[n][2 * r + 1]);
  };
  const bool holds_n = carries_n && tid < kT && d0 + tid < hd;
  float n_d = holds_n ? p.n0[(long)bh * hd + d0 + tid] : 0.f;
  float m = p.m0[bh];

  auto load = [&](int c, int st) {   // chunk c's k and v tiles and gates
    const int t0 = c * kL, Lc = min(kL, S - t0);
    for (int i = tid; i < kL * kT / 4; i += kStateThreads) {
      const int s = i / (kT / 4), x = i % (kT / 4) * 4;
      const long o = base + (t0 + s) * row;
      const bool ok_k = s < Lc && d0 + x < hd, ok_v = s < Lc && j0 + x < hd;
      cp_async16(&sm.k[st][s][x], ok_k ? p.k + o + d0 + x : p.k, ok_k);
      cp_async16(&sm.v[st][s][x], ok_v ? p.v + o + j0 + x : p.v, ok_v);
    }
    if (tid < kL) {
      const bool ok = tid < Lc;
      const long gi = ((long)b * S + t0 + tid) * p.nh + h;
      cp_async4(&sm.li[st][tid], ok ? p.log_i + gi : p.log_i, ok);
      cp_async4(&sm.lf[st][tid], ok ? p.log_f + gi : p.log_f, ok);
    }
    cp_async_commit();
  };

  load(0, 0);
  for (int c = 0; c < nc; ++c) {
    const int st = c & 1, Lc = min(kL, S - c * kL);
    if (c + 1 < nc) {
      load(c + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (c > 0) {   // the state entering chunk c, for passes 2 and 3
      const long slot = (long)bh * (nc - 1) + c - 1;
      store(p.wsC + slot * hd2);
      if (holds_n) p.wsN[slot * hd + d0 + tid] = n_d;
      if (blockIdx.x == 0 && tid == 0) p.wsM[slot] = m;
    }
    if (warp == 0) {   // m' = max(m + F_L, max_s (F_L - F_s + li_s))
      const Gates gt = chunk_gates(sm.li[st], sm.lf[st], 1, Lc, lane);
      const double FL = __shfl_sync(kFull, gt.F[kPer - 1], 31);
      float lw[kPer], best = rt::kNegInf;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        lw[i] = kPer * lane + i < Lc ? (float)(FL - gt.F[i] + gt.li[i])
                                     : rt::kNegInf;
        best = fmaxf(best, lw[i]);
      }
      const float m_next = fmaxf((float)(m + FL), rt::warp_max(best));
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        sm.w[kPer * lane + i] =
            kPer * lane + i < Lc ? expf(lw[i] - m_next) : 0.f;
      if (lane == 0) {
        sm.scal[0] = m_next;
        sm.scal[1] = expf((float)(m + FL - m_next));
      }
    }
    __syncthreads();

    // C <- C exp(m + F_L - m') + (k w)^T v over the tile, in split TF32
    float U[kNT][4] = {};
#pragma unroll
    for (int kk = 0; kk < kL / 8; ++kk) {
      if (kk * 8 >= Lc) break;
      const float w0 = sm.w[8 * kk + t4], w1 = sm.w[8 * kk + t4 + 4];
      const float* kp = &sm.k[st][8 * kk][wr];
      Tf32 a[4];   // A(d, s) = k[s][d] w_s
      a[0] = split(kp[t4 * kLdState + g] * w0);
      a[1] = split(kp[t4 * kLdState + g + 8] * w0);
      a[2] = split(kp[(t4 + 4) * kLdState + g] * w1);
      a[3] = split(kp[(t4 + 4) * kLdState + g + 8] * w1);
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        Tf32 bf[2];
        load_b(bf, &sm.v[st][8 * kk][wc + 8 * n], kLdState, g, t4);
        mma3(U[n], a, bf);
      }
    }
    const float scale = sm.scal[1];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) C[n][i] = fmaf(C[n][i], scale, U[n][i]);
    if (carries_n && tid < kT) {   // n <- n exp(m + F_L - m') + k^T w
      float sum = 0.f;
#pragma unroll 8
      for (int s = 0; s < kL; ++s) sum = fmaf(sm.k[st][s][tid], sm.w[s], sum);
      n_d = fmaf(n_d, scale, sum);
    }
    m = sm.scal[0];
    __syncthreads();   // before the next load overwrites this stage
  }

  store(p.C_out + bh * hd2);
  if (holds_n) p.n_out[(long)bh * hd + d0 + tid] = n_d;
  if (blockIdx.x == 0 && tid == 0) p.m_out[bh] = m;
}

// ---------------------------------------------------------------------------
// 2. weight pass
// ---------------------------------------------------------------------------

constexpr int kWeightThreads = 128;

struct WeightSmem {
  float q[2][kRows][kLdA];    // q[row][d - d0], double-buffered
  float k[2][kL][kLdA];       // k[step][d - d0]
  float n[kMaxHd];            // n_c
  double F[kL];
  float li[kL], m_row[kL];
  float rowsum[4][kRows];     // by warp
  float qn[kRows];
};

__global__ void __launch_bounds__(kWeightThreads)
mlstm_weight_kernel(const Params p) {
  extern __shared__ float4 smem_raw[];
  WeightSmem& sm = *reinterpret_cast<WeightSmem*>(smem_raw);
  const int r = blockIdx.x, c = blockIdx.y, bh = blockIdx.z;
  const int b = bh / p.nh, h = bh % p.nh;
  const int S = p.S, hd = p.hd, nc = p.nc;
  const int t0 = c * kL, Lc = min(kL, S - t0), r0 = r * kRows;
  const int keys = r0 + kRows;   // row tile r needs keys s < 16 (r + 1)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const long row = (long)p.nh * hd;
  const long base = ((long)b * S + t0) * row + (long)h * hd;
  const long slot = (long)bh * (nc - 1) + c - 1;   // chunk c > 0's state
  const float* n_c = c == 0 ? p.n0 + (long)bh * hd : p.wsN + slot * hd;
  const float m_c = c == 0 ? p.m0[bh] : p.wsM[slot];

  for (int i = tid; i < hd; i += kWeightThreads)
    cp_async4(&sm.n[i], n_c + i, true);
  auto load = [&](int step, int st) {
    const int d0 = step * kK;
    for (int i = tid; i < kRows * kK / 4; i += kWeightThreads) {
      const int t = i / (kK / 4), x = i % (kK / 4) * 4;
      const bool ok = r0 + t < Lc;
      cp_async16(&sm.q[st][t][x], ok ? p.q + base + (r0 + t) * row + d0 + x
                                     : p.q, ok);
    }
    for (int i = tid; i < keys * kK / 4; i += kWeightThreads) {
      const int s = i / (kK / 4), x = i % (kK / 4) * 4;
      const bool ok = s < Lc;
      cp_async16(&sm.k[st][s][x], ok ? p.k + base + s * row + d0 + x : p.k,
                 ok);
    }
    cp_async_commit();
  };
  load(0, 0);

  // F, log_i and m_row = max(F_t + max_{s<=t} (li_s - F_s), m_c + F_t)
  if (warp == 0) {
    const long gi = ((long)b * S + t0) * p.nh + h;
    const Gates gt = chunk_gates(p.log_i + gi, p.log_f + gi, p.nh, Lc, lane);
    double pm[kPer], best = rt::kNegInf;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      best = fmax(best, kPer * lane + i < Lc ? gt.li[i] - gt.F[i]
                                             : rt::kNegInf);
      pm[i] = best;
    }
    double incl = best;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl = fmax(incl, y);
    }
    double excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = rt::kNegInf;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int s = kPer * lane + i;
      sm.F[s] = gt.F[i];
      sm.li[s] = gt.li[i];
      sm.m_row[s] = (float)fmax(gt.F[i] + fmax(excl, pm[i]), m_c + gt.F[i]);
    }
  }

  // scores of this block's rows against the keys of n-tiles warp + 4 jj
  constexpr int kTiles = kL / 32;   // n-tiles of 8 keys per warp
  float Sc[kTiles][4] = {};
  float qn = 0.f;
  const int qn_row = tid >> 3, qn_seg = (tid & 7) * (kK / 8);
  const int n_steps = hd / kK;
  for (int step = 0; step < n_steps; ++step) {
    const int st = step & 1;
    if (step + 1 < n_steps) {
      load(step + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float P[kTiles][4] = {};
#pragma unroll
    for (int kk = 0; kk < kK / 8; ++kk) {
      Tf32 a[4];
      load_a(a, &sm.q[st][0][8 * kk], kLdA, g, t4);
#pragma unroll
      for (int jj = 0; jj < kTiles; ++jj) {
        const int s0 = 8 * (warp + 4 * jj);
        if (s0 < keys) {   // B(d, s) = k[s][d]
          Tf32 bf[2];
          load_bt(bf, &sm.k[st][s0][8 * kk], kLdA, g, t4);
          mma3(P[jj], a, bf);
        }
      }
    }
#pragma unroll
    for (int jj = 0; jj < kTiles; ++jj)
#pragma unroll
      for (int i = 0; i < 4; ++i) Sc[jj][i] += P[jj][i];
#pragma unroll
    for (int x = 0; x < kK / 8; ++x)
      qn = fmaf(sm.q[st][qn_row][qn_seg + x], sm.n[step * kK + qn_seg + x],
                qn);
    __syncthreads();   // before the next load overwrites this stage
  }
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) qn += __shfl_xor_sync(kFull, qn, o);
  if ((tid & 7) == 0) sm.qn[qn_row] = qn;

  // W = scores exp(D - m_row) for s <= t < Lc, else 0; all kL columns of
  // the rows are written, so pass 3 never reads an unwritten W
  float* Wc = p.wsW + ((long)bh * nc + c) * kL * kL;
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int jj = 0; jj < kTiles; ++jj)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int t = r0 + g + 8 * hf, s = 8 * (warp + 4 * jj) + 2 * t4;
      float wv[2];   // D[t, s] = F_t - F_s + li_s
#pragma unroll
      for (int e = 0; e < 2; ++e)
        wv[e] = s + e <= t && t < Lc
                    ? Sc[jj][2 * hf + e] *
                          expf((float)(sm.F[t] - sm.F[s + e] + sm.li[s + e]) -
                               sm.m_row[t])
                    : 0.f;
      rs[hf] += wv[0] + wv[1];
      *reinterpret_cast<float2*>(Wc + t * kL + s) = make_float2(wv[0], wv[1]);
    }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    rs[hf] += __shfl_xor_sync(kFull, rs[hf], 1);
    rs[hf] += __shfl_xor_sync(kFull, rs[hf], 2);
    if (t4 == 0) sm.rowsum[warp][g + 8 * hf] = rs[hf];
  }
  __syncthreads();
  if (tid < kRows) {
    const int t = r0 + tid;
    const float sum = sm.rowsum[0][tid] + sm.rowsum[1][tid] +
                      sm.rowsum[2][tid] + sm.rowsum[3][tid];
    const float e = expf((float)(m_c + sm.F[t]) - sm.m_row[t]);
    const long o = ((long)bh * nc + c) * kL + t;
    p.wsE[o] = e;
    p.wsD[o] = fmaxf(fabsf(sum + e * sm.qn[tid]), expf(-sm.m_row[t]));
  }
}

// ---------------------------------------------------------------------------
// 3. output pass
// ---------------------------------------------------------------------------

constexpr int kOutThreads = 256;

struct OutSmem {
  float a[2][kL][kLdA];       // q[t][d - d0], then W[t][s - s0]
  float b[2][kK][kLdB];       // C_c[d - d0][j - j0], then v[s - s0][j - j0]
};

__global__ void __launch_bounds__(kOutThreads, 2)
mlstm_output_kernel(const Params p) {
  extern __shared__ float4 smem_raw[];
  OutSmem& sm = *reinterpret_cast<OutSmem*>(smem_raw);
  const int j0 = blockIdx.y * kSlice, bh = blockIdx.z;
  const int b = bh / p.nh, h = bh % p.nh;
  const int S = p.S, hd = p.hd, nc = p.nc;
  const int c = blockIdx.x, t0 = c * kL, Lc = min(kL, S - t0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int rw = warp & 3, cw = warp >> 2;   // rows 16 rw, columns 64 cw
  const long row = (long)p.nh * hd;
  const long head = (long)b * S * row + (long)h * hd;
  const long hd2 = (long)hd * hd;
  const float* Cc = c == 0 ? p.C0 + bh * hd2
                           : p.wsC + ((long)bh * (nc - 1) + c - 1) * hd2;
  const long wo = (long)bh * nc + c;
  const float* Wc = p.wsW + wo * kL * kL;
  const int n_qc = hd / kK;                  // steps of q C_c over hd
  const int n_steps = n_qc + kL / kK;         // then of W v over the keys

  auto load = [&](int step, int st) {
    const bool qc = step < n_qc;
    const int k0 = (qc ? step : step - n_qc) * kK;
    for (int i = tid; i < kL * kK / 4; i += kOutThreads) {
      const int t = i / (kK / 4), x = i % (kK / 4) * 4;
      const bool ok = t < Lc;
      const float* src = qc ? p.q + head + (t0 + t) * row + k0 + x
                            : Wc + t * kL + k0 + x;
      cp_async16(&sm.a[st][t][x], ok ? src : p.q, ok);
    }
    for (int i = tid; i < kK * kSlice / 4; i += kOutThreads) {
      const int r = i / (kSlice / 4), x = i % (kSlice / 4) * 4;
      const int s = t0 + k0 + r;   // a key's step, for W v
      const bool ok = j0 + x < hd && (qc || s < S);
      const float* src = qc ? Cc + (long)(k0 + r) * hd + j0 + x
                            : p.v + head + s * row + j0 + x;
      cp_async16(&sm.b[st][r][x], ok ? src : p.v, ok);
    }
    cp_async_commit();
  };

  float acc[8][4] = {};
  load(0, 0);
  for (int step = 0; step < n_steps; ++step) {
    const int st = step & 1;
    if (step + 1 < n_steps) {
      load(step + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (step == n_qc) {   // acc = e q C_c; W v adds to it
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float e = p.wsE[wo * kL + 16 * rw + g + 8 * hf];
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          acc[n][2 * hf] *= e;
          acc[n][2 * hf + 1] *= e;
        }
      }
    }
    // in W v, rows 16 rw .. 16 rw + 15 see the keys up to themselves
    const int depth = step < n_qc ? kK : 16 * rw + 16 - (step - n_qc) * kK;
    float P[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < kK / 8; ++kk) {
      if (8 * kk >= depth) break;
      Tf32 a[4];
      load_a(a, &sm.a[st][16 * rw][8 * kk], kLdA, g, t4);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        Tf32 bf[2];
        load_b(bf, &sm.b[st][8 * kk][64 * cw + 8 * n], kLdB, g, t4);
        mma3(P[n], a, bf);
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] += P[n][i];
    __syncthreads();   // before the next load overwrites this stage
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int t = 16 * rw + g + 8 * hf;
    if (t >= Lc) continue;
    const float den = p.wsD[wo * kL + t];
    float* out = p.h + head + (t0 + t) * row;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int j = j0 + 64 * cw + 8 * n + 2 * t4;
      if (j < hd)
        *reinterpret_cast<float2*>(out + j) =
            make_float2(acc[n][2 * hf] / den, acc[n][2 * hf + 1] / den);
    }
  }
}

// Allows the three kernels their dynamic shared memory on the current
// device. The attribute holds for the device's context, so this is done
// once a device.
cudaError_t allow_smem() {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(mlstm_state_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sizeof(StateSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mlstm_weight_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sizeof(WeightSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mlstm_output_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sizeof(OutSmem));
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

// The workspace: nc = ceil(S / kL) chunks, one buffer cut into parts in
// this order, each a multiple of 4 floats (so 16-byte aligned) but the last:
// C_c (B nh (nc-1) hd^2), W (B nh nc kL^2), n_c (B nh (nc-1) hd), e and den
// (B nh nc kL each), m_c (B nh (nc-1)). Fills the part pointers of prm from
// ws and returns the floats needed; ws may be null to only count them.
long long cut_workspace(Params& prm, float* ws, int B) {
  const long long bh = (long long)B * prm.nh, nc = prm.nc, hd = prm.hd;
  const long long sizes[6] = {bh * (nc - 1) * hd * hd, bh * nc * kL * kL,
                              bh * (nc - 1) * hd,      bh * nc * kL,
                              bh * nc * kL,            bh * (nc - 1)};
  float** parts[6] = {&prm.wsC, &prm.wsW, &prm.wsN,
                      &prm.wsE, &prm.wsD, &prm.wsM};
  long long at = 0;
  for (int i = 0; i < 6; ++i) {
    *parts[i] = ws ? ws + at : nullptr;
    at += sizes[i];
  }
  return at;
}

bool valid_shape(int B, int S, int nh, int hd) {
  return B > 0 && S > 0 && nh > 0 && hd > 0 && hd % 32 == 0 && hd <= kMaxHd;
}

}  // namespace

// C interface (bound with ctypes). The floats of workspace that
// mlstm_chunk_fwd needs at this shape, or -1 for a shape it does not take.
extern "C" long long mlstm_chunk_workspace_floats(int B, int S, int nh,
                                                  int hd) {
  if (!valid_shape(B, S, nh, hd)) return -1;
  Params prm{};
  prm.nh = nh;
  prm.hd = hd;
  prm.nc = (S + kL - 1) / kL;
  return cut_workspace(prm, nullptr, B);
}

// q, k, v, h_out (B, S, nh, hd); log_i, log_f (B, S, nh); C0, C_out (B, nh,
// hd, hd); n0, n_out (B, nh, hd); m0, m_out (B, nh): contiguous fp32 device
// memory, the outputs apart from the inputs; q, k, v, C0, h_out and C_out
// 16-byte aligned, the rest 4-byte. ws: ws_floats floats of device memory,
// 16-byte aligned, apart from the rest; at least
// mlstm_chunk_workspace_floats(B, S, nh, hd) of them, else it launches
// nothing and returns cudaErrorInvalidValue. S >= 1; hd a multiple of 32 up
// to 512. Launches the three passes on the stream, in order. Returns a
// cudaError_t.
extern "C" int mlstm_chunk_fwd(const void* q, const void* k, const void* v,
                               const void* log_i, const void* log_f,
                               const void* C0, const void* n0, const void* m0,
                               void* h_out, void* C_out, void* n_out,
                               void* m_out, void* ws, long long ws_floats,
                               int B, int S, int nh, int hd, void* stream) {
  if (!valid_shape(B, S, nh, hd) || ws == nullptr ||
      reinterpret_cast<uintptr_t>(ws) % 16)
    return (int)cudaErrorInvalidValue;
  Params prm{static_cast<const float*>(q),
             static_cast<const float*>(k),
             static_cast<const float*>(v),
             static_cast<const float*>(log_i),
             static_cast<const float*>(log_f),
             static_cast<const float*>(C0),
             static_cast<const float*>(n0),
             static_cast<const float*>(m0),
             static_cast<float*>(h_out),
             static_cast<float*>(C_out),
             static_cast<float*>(n_out),
             static_cast<float*>(m_out),
             nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
             S, nh, hd, (S + kL - 1) / kL};
  if (cut_workspace(prm, static_cast<float*>(ws), B) > ws_floats)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nt = (hd + kT - 1) / kT, bh = B * nh;
  mlstm_state_kernel<<<dim3(nt * nt, bh), kStateThreads, sizeof(StateSmem),
                       s>>>(prm);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  mlstm_weight_kernel<<<dim3(kL / kRows, prm.nc, bh), kWeightThreads,
                        sizeof(WeightSmem), s>>>(prm);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  mlstm_output_kernel<<<dim3(prm.nc, (hd + kSlice - 1) / kSlice, bh),
                        kOutThreads, sizeof(OutSmem), s>>>(prm);
  return (int)cudaGetLastError();
}
