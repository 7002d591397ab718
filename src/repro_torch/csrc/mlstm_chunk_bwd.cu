// The backward of the chunkwise stabilised mLSTM (csrc/mlstm_chunk.cu) for
// Hopper (sm_90a): four launches on the CUDA cores in fp32.
//
// The JAX package has no kernel for this gradient: its model differentiates
// src/repro/models/xlstm.py::_mlstm_chunk_scan (the function the TPU kernel
// src/repro/kernels/mlstm_chunk/kernel.py::mlstm_chunk_pallas computes) with
// jax.grad. The port runs the forward on the card, so its gradient is a
// kernel too. It takes q, k, v (B, S, nh, hd), the gates log_i, log_f (B, S,
// nh), the forward's h and the cotangent dh, the state entering the scan
// and the states entering chunks 1 .. nc-1 that the forward leaves in its
// workspace, and returns dq, dk, dv, dlog_i and dlog_f. The state leaving
// the scan takes no gradient and the state entering it gets none.
//
// Per (batch, head) and 64-step chunk c, with the forward's notation
// (F_t = sum_{s<=t} log_f_s, D[t,s] = F_t - F_s + log_i_s, m_row_t, P[t,s] =
// exp(D[t,s] - m_row_t), W = (q k^T) P, e_t = exp(m_c + F_t - m_row_t),
// a_t = sum_s W[t,s] + e_t q_t . n_c, den_t = max(|a_t|, exp(-m_row_t)),
// h_t = (W v + e_t q_t C_c)_t / den_t; the chunk-end weights w_s =
// exp(F_L - F_s + log_i_s - m_{c+1}) and scale_c = exp(m_c + F_L - m_{c+1})):
//   dnum_t = dh_t / den_t, da_t = -sign(a_t) (dh_t . h_t) / den_t, or 0 in
//   the clamp's branch (|a_t| < exp(-m_row_t));
//   dC'_c, dn'_c: the gradient of the state leaving chunk c (0 for the last),
//   dC'_{c-1} = scale_c dC'_c + sum_t e_t q_t dnum_t^T, dn' likewise with
//   e_t da_t q_t;
//   dW = dnum v^T + da, dS = dW P, dD = dW W;
//   dq_t = e_t (C_c dnum_t + da_t n_c) + sum_s dS[t,s] k_s,
//   dk_s = w_s (dC'_c v_s + dn'_c) + sum_t dS[t,s] q_t,
//   dv_s = w_s dC'_c^T k_s + sum_t W[t,s] dnum_t;
//   dF_t = sum_s dD[t,s] - sum_t' dD[t',t] + e_t de_t - w_t dw_t, plus at
//   t = L-1 the chunk end's sum_s w_s dw_s + scale_c dscale_c, where de_t =
//   q_t . C_c dnum_t + da_t q_t . n_c, dw_s = k_s . (dC'_c v_s + dn'_c),
//   dscale_c = <dC'_c, C_c> + dn'_c . n_c; dlog_i_s = sum_t dD[t,s] +
//   w_s dw_s; dlog_f_s = sum_{t>=s} dF_t within the chunk (F restarts at
//   every chunk, and only the chunk end's term crosses it).
// The stabilisers (m_row, m_{c+1}, the state's m) are constants: h is the
// same for any value of them, so no gradient flows through them.
// kernels/mlstm_chunk/ref.py::mlstm_chunk_bwd_ref writes out the same
// passes; the CPU tests hold it against jax.vjp of _mlstm_chunk_scan.
//
// What bounds it on an H100: operations. The dC' chain, C_c dnum, dC' v and
// dC'^T k take 8 B nh S hd^2 flops; q k^T, dh v^T and the three intra-chunk
// products of dq, dk and dv, each over the causal half of a 64-step chunk,
// 5 B nh S 64 hd: 37.1 GFLOP at the training shape (B = 1, S = 4096, nh =
// 4, hd = 512), 0.55 ms at fp32's 67 TFLOP/s. This first design is plain:
// every product on the CUDA cores in fp32 (h divides by a denominator that
// can cancel, so the gradients amplify rounding as h does), tiles staged
// through shared memory by synchronous loads, the intra-chunk products over
// the full chunk rather than its causal half, and no atomics:
//   1. Weight pass, grid (16-row tiles, chunks, B nh): q k^T and dh v^T for
//      the rows, the gates (summed in fp64, as the forward's chunk_gates),
//      m_row, P, W, a, den, da; writes dS, W / den and dD (kL x kL a chunk),
//      e, 1 / den, da, q . n_c per step, and (row tile 0) the chunk end's
//      w_s and scale_c.
//   2. State pass, grid (64 x 64 tiles of dC, B nh): walks the chunks in
//      reverse, writing dC'_c and dn'_c to the workspace and its tile's part
//      of dscale_c, then dC' <- scale_c dC' + (e q)^T (dh / den).
//   3. Gradient pass, grid (chunks, 3 x 128-column slices, B nh): dq, dk or
//      dv for one slice of one chunk, each a product over hd (C_c, dC'_c)
//      then one over the chunk's steps (dS, W / den); the slices' parts of
//      q_t . C_c dh_t and k_s . (dC'_c v_s + dn'_c) go to the workspace.
//   4. Gate pass, grid (chunks, B nh), one thread a step: dD's row and
//      column sums, the slices' and tiles' parts summed, and the reverse
//      cumsum of dF in fp64.
// Global loads are 4-byte (the operands need only 4-byte alignment); the
// state pass writes the workspace's dC' tiles as float4.
//
// Workspace (one buffer: mlstm_chunk_bwd_workspace_floats counts it, the
// wrapper allocates it, mlstm_chunk_bwd refuses one that is too small),
// nc = ceil(S / 64), nsl = ceil(hd / 128), nt = ceil(hd / 64):
//   dC'_c, dn'_c for chunks 0 .. nc-2       B nh (nc-1) (hd^2 + hd) floats
//   dS, W / den, dD                         3 B nh nc 64^2
//   e, 1 / den, da, q . n, w                5 B nh nc 64
//   the slices' and tiles' parts, scale     B nh nc (2 nsl 64 + nt^2 + 1)
// 278,258,688 bytes at the training shape.
#include "common.cuh"

namespace {

constexpr int kL = 64;        // steps of S per chunk (the forward's)
constexpr int kPer = kL / 32; // steps of a chunk per lane in the gate scans
constexpr int kT = 64;        // rows and columns of a dC tile (state pass)
constexpr int kRows = 16;     // rows per weight-pass block
constexpr int kSlice = 128;   // output columns per gradient-pass block
constexpr int kK = 32;        // depth of a tile step
constexpr int kMaxHd = 512;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float *q, *k, *v, *log_i, *log_f, *h, *dh;
  const float *C0, *n0, *m0;   // the state entering chunk 0
  const float *Cs, *ns, *ms;   // the forward's states entering chunks 1..nc-1
  float *dq, *dk, *dv, *dli, *dlf;
  float *dCs, *dns;            // the gradient of the state leaving chunk c
  float *dS, *Wd, *dD;         // (B nh, nc, kL, kL)
  float *E, *R, *DA, *QN, *wS; // (B nh, nc, kL)
  float *qX, *kG;              // (B nh, nc, nsl, kL): the slices' parts
  float *dscale;               // (B nh, nc, nt^2): the tiles' parts
  float *scale;                // (B nh, nc)
  int S, nh, hd, nc, nsl, nt;
};

// ---------------------------------------------------------------------------
// gates of one chunk (csrc/mlstm_chunk.cu's chunk_gates, the same arithmetic)
// ---------------------------------------------------------------------------

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

__device__ __forceinline__ float sum8(float x) {   // over 8 aligned lanes
  x += __shfl_xor_sync(kFull, x, 1);
  x += __shfl_xor_sync(kFull, x, 2);
  x += __shfl_xor_sync(kFull, x, 4);
  return x;
}

// ---------------------------------------------------------------------------
// 1. weight pass
// ---------------------------------------------------------------------------

constexpr int kWeightThreads = 128;   // 8 a row: keys sx + 8 i

struct WeightSmem {
  float q[kRows][kK + 1], dh[kRows][kK + 1];
  float k[kL][kK + 1], v[kL][kK + 1];
  float n[kMaxHd];
  double F[kL];
  float li[kL], m_row[kL];
};

__global__ void __launch_bounds__(kWeightThreads)
mlstm_bwd_weight_kernel(const Params p) {
  __shared__ WeightSmem sm;
  const int r = blockIdx.x, c = blockIdx.y, bh = blockIdx.z;
  const int b = bh / p.nh, hh = bh % p.nh;
  const int S = p.S, hd = p.hd, nc = p.nc;
  const int t0 = c * kL, Lc = min(kL, S - t0), r0 = r * kRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tr = tid >> 3, sx = tid & 7;   // this thread's row and keys
  const int n_keys = 2 * (r + 1);          // key groups of 8 up to row r0+15
  const long row = (long)p.nh * hd;
  const long base = ((long)b * S + t0) * row + (long)hh * hd;
  const long slot = (long)bh * (nc - 1) + c - 1;   // chunk c > 0's state
  const float* n_c = c == 0 ? p.n0 + (long)bh * hd : p.ns + slot * hd;
  const float m_c = c == 0 ? p.m0[bh] : p.ms[slot];
  const long cs = (long)bh * nc + c;
  for (int i = tid; i < hd; i += kWeightThreads) sm.n[i] = n_c[i];

  // F, log_i and m_row = max(F_t + max_{s<=t} (li_s - F_s), m_c + F_t), as
  // the forward's weight pass
  if (warp == 0) {
    const long gi = ((long)b * S + t0) * p.nh + hh;
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

  // q k^T and dh v^T for row tr against keys sx + 8 i; q . n and dh . h
  float Sc[8] = {}, G[8] = {};
  float qn = 0.f, dhh = 0.f;
  const int t = r0 + tr;
  for (int d0 = 0; d0 < hd; d0 += kK) {
    __syncthreads();   // the last step's reads are done
    for (int i = tid; i < kRows * kK; i += kWeightThreads) {
      const int tt = i / kK, x = i % kK;
      const bool ok = r0 + tt < Lc;
      const long o = base + (r0 + tt) * row + d0 + x;
      sm.q[tt][x] = ok ? p.q[o] : 0.f;
      sm.dh[tt][x] = ok ? p.dh[o] : 0.f;
    }
    for (int i = tid; i < 8 * n_keys * kK; i += kWeightThreads) {
      const int s = i / kK, x = i % kK;
      const bool ok = s < Lc;
      const long o = base + s * row + d0 + x;
      sm.k[s][x] = ok ? p.k[o] : 0.f;
      sm.v[s][x] = ok ? p.v[o] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int x = 0; x < kK / 8; ++x) {
      const int xx = sx * (kK / 8) + x;
      qn = fmaf(sm.q[tr][xx], sm.n[d0 + xx], qn);
      if (t < Lc)
        dhh = fmaf(sm.dh[tr][xx], p.h[base + t * row + d0 + xx], dhh);
    }
#pragma unroll 4
    for (int x = 0; x < kK; ++x) {
      const float qa = sm.q[tr][x], ga = sm.dh[tr][x];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (i < n_keys) {
          Sc[i] = fmaf(qa, sm.k[sx + 8 * i][x], Sc[i]);
          G[i] = fmaf(ga, sm.v[sx + 8 * i][x], G[i]);
        }
    }
  }
  qn = sum8(qn);
  dhh = sum8(dhh);
  __syncthreads();   // the gates

  const float mr = sm.m_row[t];
  float P[8], W[8], rs = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int s = sx + 8 * i;
    P[i] = s <= t && t < Lc
               ? expf((float)(sm.F[t] - sm.F[s] + sm.li[s]) - mr)
               : 0.f;
    W[i] = Sc[i] * P[i];
    rs += W[i];
  }
  rs = sum8(rs);
  const bool live = t < Lc;
  const float e = live ? expf((float)(m_c + sm.F[t]) - mr) : 0.f;
  const float a = rs + e * qn, flo = expf(-mr);
  const float Rt = live ? 1.f / fmaxf(fabsf(a), flo) : 0.f;
  const float dden = -dhh * Rt;   // d den = -(dh . h) / den
  const float da = live && fabsf(a) >= flo
                       ? (a > 0.f ? dden : a < 0.f ? -dden : 0.f)
                       : 0.f;
  const long mo = cs * kL * kL + (long)t * kL;
#pragma unroll
  for (int i = 0; i < 8; ++i) {   // every column of the row is written
    const int s = sx + 8 * i;
    const float dW = fmaf(G[i], Rt, da);
    p.dS[mo + s] = dW * P[i];
    p.dD[mo + s] = dW * W[i];
    p.Wd[mo + s] = W[i] * Rt;
  }
  if (sx == 0) {
    const long o = cs * kL + t;
    p.E[o] = e;
    p.R[o] = Rt;
    p.DA[o] = da;
    p.QN[o] = qn;
  }

  // the chunk end's weights and scale, as the forward's state pass
  if (r == 0 && warp == 0) {
    const double FL = sm.F[kL - 1];
    float lw[kPer], best = rt::kNegInf;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int s = kPer * lane + i;
      lw[i] = s < Lc ? (float)(FL - sm.F[s] + sm.li[s]) : rt::kNegInf;
      best = fmaxf(best, lw[i]);
    }
    const float m_next = fmaxf((float)(m_c + FL), rt::warp_max(best));
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int s = kPer * lane + i;
      p.wS[cs * kL + s] = s < Lc ? expf(lw[i] - m_next) : 0.f;
    }
    if (lane == 0) p.scale[cs] = expf((float)(m_c + FL - m_next));
  }
}

// ---------------------------------------------------------------------------
// 2. state pass
// ---------------------------------------------------------------------------

constexpr int kStateThreads = 256;   // 16 x 16 threads, 4 x 4 entries each
constexpr int kLdS = kT + 4;

struct StateSmem {
  float q[kL][kLdS];   // e_t q_t[d0 + x]
  float g[kL][kLdS];   // dh_t[j0 + x] / den_t
  float da[kL];
  float red[kStateThreads / 32];
};

__global__ void __launch_bounds__(kStateThreads)
mlstm_bwd_state_kernel(const Params p) {
  __shared__ __align__(16) StateSmem sm;
  const int nt = p.nt, ntt = nt * nt;
  const int d0 = (blockIdx.x / nt) * kT, j0 = (blockIdx.x % nt) * kT;
  const int bh = blockIdx.y, b = bh / p.nh, hh = bh % p.nh;
  const int S = p.S, hd = p.hd, nc = p.nc;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid >> 4, tx = tid & 15;
  const int dr = d0 + 4 * ty, jc = j0 + 4 * tx;   // the thread's corner
  const bool col_ok = jc < hd;   // hd is a multiple of 32: all four or none
  const long row = (long)p.nh * hd, hd2 = (long)hd * hd;
  const long head = (long)b * S * row + (long)hh * hd;
  const bool holds_n = j0 == 0 && tid < kT && d0 + tid < hd;
  float dC[4][4] = {};
  float dn = 0.f;

  for (int c = nc - 1; c >= 0; --c) {
    const long cs = (long)bh * nc + c;
    // the gradient leaving chunk c (zero for the last) for the gradient
    // pass, and its product with C_c
    float part = 0.f;
    if (c < nc - 1) {
      const long slot = (long)bh * (nc - 1) + c;
      const float* Cc = c == 0 ? p.C0 + bh * hd2
                               : p.Cs + ((long)bh * (nc - 1) + c - 1) * hd2;
      const float* n_c = c == 0 ? p.n0 + (long)bh * hd
                                : p.ns + ((long)bh * (nc - 1) + c - 1) * hd;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (dr + i < hd && col_ok) {
          const long o = (long)(dr + i) * hd + jc;
          *reinterpret_cast<float4*>(p.dCs + slot * hd2 + o) =
              make_float4(dC[i][0], dC[i][1], dC[i][2], dC[i][3]);
#pragma unroll
          for (int j = 0; j < 4; ++j) part = fmaf(dC[i][j], Cc[o + j], part);
        }
      if (holds_n) {
        p.dns[slot * hd + d0 + tid] = dn;
        part = fmaf(dn, n_c[d0 + tid], part);
      }
    }
    part = rt::warp_sum(part);
    if (lane == 0) sm.red[warp] = part;
    // chunk c's e q and dh / den tiles
    const int t0 = c * kL, Lc = min(kL, S - t0);
    for (int i = tid; i < kL * kT; i += kStateThreads) {
      const int t = i / kT, x = i % kT;
      const long o = head + (long)(t0 + t) * row;
      sm.q[t][x] = t < Lc && d0 + x < hd ? p.q[o + d0 + x] * p.E[cs * kL + t]
                                         : 0.f;
      sm.g[t][x] = t < Lc && j0 + x < hd ? p.dh[o + j0 + x] * p.R[cs * kL + t]
                                         : 0.f;
    }
    if (tid < kL) sm.da[tid] = p.DA[cs * kL + tid];
    __syncthreads();
    if (tid == 0) {
      float sum = 0.f;
      for (int w = 0; w < kStateThreads / 32; ++w) sum += sm.red[w];
      p.dscale[cs * ntt + blockIdx.x] = sum;
    }
    // dC' <- scale_c dC' + sum_t (e q)_t (dh / den)_t^T; dn likewise
    const float sc = p.scale[cs];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dC[i][j] *= sc;
    for (int t = 0; t < Lc; ++t) {
      const float4 a = *reinterpret_cast<const float4*>(&sm.q[t][4 * ty]);
      const float4 g = *reinterpret_cast<const float4*>(&sm.g[t][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w}, gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dC[i][j] = fmaf(av[i], gv[j], dC[i][j]);
    }
    if (holds_n) {
      dn *= sc;
      for (int t = 0; t < Lc; ++t) dn = fmaf(sm.da[t], sm.q[t][tid], dn);
    }
    __syncthreads();   // before the next chunk overwrites the tiles
  }
}

// ---------------------------------------------------------------------------
// 3. gradient pass
// ---------------------------------------------------------------------------

constexpr int kGradThreads = 256;   // 16 x 16: rows ty + 16 i, columns
                                    // tx + 16 j of a 64 x 128 tile

struct GradSmem {
  float a[kK][kL + 1];       // A(row, depth) at a[depth][row]
  float b[kK][kSlice + 1];   // B(depth, column) at b[depth][column]
};

// A(r, x) = src[r * ld + k0 + x]; rows r >= n_rows read as 0
__device__ __forceinline__ void a_by_rows(GradSmem& sm, const float* src,
                                          long ld, int k0, int n_rows) {
  for (int i = threadIdx.x; i < kL * kK; i += kGradThreads) {
    const int r = i / kK, x = i % kK;
    sm.a[x][r] = r < n_rows ? src[r * ld + k0 + x] : 0.f;
  }
}
// A(r, x) = src[(k0 + x) * ld + r]
__device__ __forceinline__ void a_by_depth(GradSmem& sm, const float* src,
                                           long ld, int k0) {
  for (int i = threadIdx.x; i < kL * kK; i += kGradThreads) {
    const int x = i / kL, r = i % kL;
    sm.a[x][r] = src[(k0 + x) * ld + r];
  }
}
// B(x, col) = src[(k0 + x) * ld + col]; depths >= n_depth and columns >=
// n_cols read as 0
__device__ __forceinline__ void b_by_depth(GradSmem& sm, const float* src,
                                           long ld, int k0, int n_depth,
                                           int n_cols) {
  for (int i = threadIdx.x; i < kK * kSlice; i += kGradThreads) {
    const int x = i / kSlice, col = i % kSlice;
    sm.b[x][col] = k0 + x < n_depth && col < n_cols
                       ? src[(k0 + x) * ld + col] : 0.f;
  }
}
// B(x, col) = src[col * ld + k0 + x]; columns >= n_cols read as 0
__device__ __forceinline__ void b_by_cols(GradSmem& sm, const float* src,
                                          long ld, int k0, int n_cols) {
  for (int i = threadIdx.x; i < kK * kSlice; i += kGradThreads) {
    const int col = i / kK, x = i % kK;
    sm.b[x][col] = col < n_cols ? src[col * ld + k0 + x] : 0.f;
  }
}

// acc += A B over depth (a multiple of kK); load(k0) stages one step
template <class Load>
__device__ __forceinline__ void accumulate(float (&acc)[4][8], GradSmem& sm,
                                           int depth, Load load) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  for (int k0 = 0; k0 < depth; k0 += kK) {
    __syncthreads();   // the last step's reads are done
    load(k0);
    __syncthreads();
#pragma unroll 4
    for (int x = 0; x < kK; ++x) {
      float av[4], bv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sm.a[x][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = sm.b[x][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

__global__ void __launch_bounds__(kGradThreads)
mlstm_bwd_grad_kernel(const Params p) {
  __shared__ GradSmem sm;
  const int c = blockIdx.x, bh = blockIdx.z;
  const int kind = blockIdx.y / p.nsl, slice = blockIdx.y % p.nsl;
  const int b = bh / p.nh, hh = bh % p.nh;
  const int S = p.S, hd = p.hd, nc = p.nc;
  const int t0 = c * kL, Lc = min(kL, S - t0);
  const int c0 = slice * kSlice, n_cols = min(kSlice, hd - c0);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const long row = (long)p.nh * hd, hd2 = (long)hd * hd;
  const long base = ((long)b * S + t0) * row + (long)hh * hd;
  const long cs = (long)bh * nc + c;
  const float* dSc = p.dS + cs * kL * kL;
  const bool has_dC = c < nc - 1;   // no gradient leaves the last chunk
  const long out_slot = (long)bh * (nc - 1) + c;
  const float* dCc = p.dCs + out_slot * hd2;
  const float* dnc = p.dns + out_slot * hd;
  float acc[4][8] = {};
  // the slice's part of a row's dot product with its operand x, written to
  // dst (B nh, nc, nsl, kL); every row is written
  auto row_part = [&](const float* x, float* dst) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = ty + 16 * i;
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = tx + 16 * j;
        if (t < Lc && col < n_cols)
          s = fmaf(x[base + t * row + c0 + col], acc[i][j], s);
      }
      s = rt::half_warp_sum(s);
      if (tx == 0) dst[(cs * p.nsl + slice) * kL + t] = s;
    }
  };

  if (kind == 0) {   // dq
    const long prev = (long)bh * (nc - 1) + c - 1;
    const float* Cc = c == 0 ? p.C0 + bh * hd2 : p.Cs + prev * hd2;
    const float* n_c = c == 0 ? p.n0 + (long)bh * hd : p.ns + prev * hd;
    // X_t = C_c dh_t over the slice's rows d of C_c
    accumulate(acc, sm, hd, [&](int k0) {
      a_by_rows(sm, p.dh + base, row, k0, Lc);
      b_by_cols(sm, Cc + (long)c0 * hd, hd, k0, n_cols);
    });
    row_part(p.q, p.qX);   // q_t . X_t, for de_t
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = ty + 16 * i;
      const float e = p.E[cs * kL + t], er = e * p.R[cs * kL + t],
                  eda = e * p.DA[cs * kL + t];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = tx + 16 * j;
        const float nd = col < n_cols ? n_c[c0 + col] : 0.f;
        acc[i][j] = fmaf(acc[i][j], er, eda * nd);
      }
    }
    accumulate(acc, sm, kL, [&](int k0) {   // + dS k
      a_by_rows(sm, dSc, kL, k0, kL);
      b_by_depth(sm, p.k + base + c0, row, k0, Lc, n_cols);
    });
  } else if (kind == 1) {   // dk
    if (has_dC) {   // dC' v_s + dn'
      accumulate(acc, sm, hd, [&](int k0) {
        a_by_rows(sm, p.v + base, row, k0, Lc);
        b_by_cols(sm, dCc + (long)c0 * hd, hd, k0, n_cols);
      });
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = tx + 16 * j;
        const float nd = col < n_cols ? dnc[c0 + col] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += nd;
      }
    }
    row_part(p.k, p.kG);   // k_s . (dC' v_s + dn'), for dw_s
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float w = p.wS[cs * kL + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= w;
    }
    accumulate(acc, sm, kL, [&](int k0) {   // + dS^T q
      a_by_depth(sm, dSc, kL, k0);
      b_by_depth(sm, p.q + base + c0, row, k0, Lc, n_cols);
    });
  } else {   // dv
    if (has_dC) {   // w_s dC'^T k_s
      accumulate(acc, sm, hd, [&](int k0) {
        a_by_rows(sm, p.k + base, row, k0, Lc);
        b_by_depth(sm, dCc + c0, hd, k0, hd, n_cols);
      });
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float w = p.wS[cs * kL + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] *= w;
      }
    }
    accumulate(acc, sm, kL, [&](int k0) {   // + (W / den)^T dh
      a_by_depth(sm, p.Wd + cs * kL * kL, kL, k0);
      b_by_depth(sm, p.dh + base + c0, row, k0, Lc, n_cols);
    });
  }

  float* out = kind == 0 ? p.dq : kind == 1 ? p.dk : p.dv;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = ty + 16 * i;
    if (t >= Lc) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = tx + 16 * j;
      if (col < n_cols) out[base + t * row + c0 + col] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// 4. gate pass
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kL) mlstm_bwd_gate_kernel(const Params p) {
  __shared__ double dF[kL];
  __shared__ float red[kL / 32];
  __shared__ float dscale;
  const int c = blockIdx.x, bh = blockIdx.y;
  const int b = bh / p.nh, hh = bh % p.nh;
  const int s = threadIdx.x, lane = s & 31;
  const int t0 = c * kL, Lc = min(kL, p.S - t0);
  const long cs = (long)bh * p.nc + c;
  const float* dD = p.dD + cs * kL * kL;
  float col = 0.f, rowsum = 0.f;
  for (int t = 0; t < kL; ++t) col += dD[t * kL + s];
  for (int x = 0; x < kL; ++x) rowsum += dD[s * kL + x];
  float qx = 0.f, kg = 0.f;
  for (int sl = 0; sl < p.nsl; ++sl) {
    qx += p.qX[(cs * p.nsl + sl) * kL + s];
    kg += p.kG[(cs * p.nsl + sl) * kL + s];
  }
  const long o = cs * kL + s;
  const float e = p.E[o];
  const float de = fmaf(p.R[o], qx, p.DA[o] * p.QN[o]);
  const float dlw = p.wS[o] * kg;   // d log_w_s = w_s dw_s
  const float sum = rt::warp_sum(dlw);
  if (lane == 0) red[s >> 5] = sum;
  if (s == 0) {
    float d = 0.f;
    for (int i = 0; i < p.nt * p.nt; ++i) d += p.dscale[cs * p.nt * p.nt + i];
    dscale = d;
  }
  __syncthreads();
  double f = (double)rowsum - col + (double)de * e - dlw;
  if (s == kL - 1) {   // F_L: through every log_w_s and scale_c
    double end = (double)dscale * p.scale[cs];
    for (int w = 0; w < kL / 32; ++w) end += red[w];
    f += end;
  }
  dF[s] = f;
  __syncthreads();
  double acc = 0.0;
  for (int t = s; t < kL; ++t) acc += dF[t];
  if (s < Lc) {
    const long g = ((long)b * p.S + t0 + s) * p.nh + hh;
    p.dli[g] = col + dlw;
    p.dlf[g] = (float)acc;
  }
}

// The workspace, cut into parts in this order, each a multiple of 4 floats
// (so 16-byte aligned) up to qX: dC' (B nh (nc-1) hd^2), dS, W / den, dD (B
// nh nc kL^2 each), dn' (B nh (nc-1) hd), e, 1 / den, da, q . n, w (B nh nc
// kL each), qX, kG (B nh nc nsl kL each), dscale (B nh nc nt^2), scale (B nh
// nc). Fills the part pointers of prm from ws and returns the floats
// needed; ws may be null to only count them.
long long cut_workspace(Params& prm, float* ws, int B) {
  const long long bh = (long long)B * prm.nh, nc = prm.nc, hd = prm.hd;
  const long long chunk = bh * nc * kL;
  const long long sizes[14] = {bh * (nc - 1) * hd * hd, chunk * kL,
                               chunk * kL, chunk * kL, bh * (nc - 1) * hd,
                               chunk, chunk, chunk, chunk, chunk,
                               chunk * prm.nsl, chunk * prm.nsl,
                               bh * nc * prm.nt * prm.nt, bh * nc};
  float** parts[14] = {&prm.dCs, &prm.dS, &prm.Wd, &prm.dD, &prm.dns,
                       &prm.E, &prm.R, &prm.DA, &prm.QN, &prm.wS,
                       &prm.qX, &prm.kG, &prm.dscale, &prm.scale};
  long long at = 0;
  for (int i = 0; i < 14; ++i) {
    *parts[i] = ws ? ws + at : nullptr;
    at += sizes[i];
  }
  return at;
}

bool valid_shape(int B, int S, int nh, int hd) {
  return B > 0 && S > 0 && nh > 0 && hd > 0 && hd % 32 == 0 && hd <= kMaxHd;
}

void set_shape(Params& prm, int S, int nh, int hd) {
  prm.S = S;
  prm.nh = nh;
  prm.hd = hd;
  prm.nc = (S + kL - 1) / kL;
  prm.nsl = (hd + kSlice - 1) / kSlice;
  prm.nt = (hd + kT - 1) / kT;
}

}  // namespace

// C interface (bound with ctypes). The floats of workspace that
// mlstm_chunk_bwd needs at this shape, or -1 for a shape it does not take.
extern "C" long long mlstm_chunk_bwd_workspace_floats(int B, int S, int nh,
                                                      int hd) {
  if (!valid_shape(B, S, nh, hd)) return -1;
  Params prm{};
  set_shape(prm, S, nh, hd);
  return cut_workspace(prm, nullptr, B);
}

// q, k, v, h, dh, dq, dk, dv (B, S, nh, hd); log_i, log_f, dlog_i, dlog_f
// (B, S, nh); C0 (B, nh, hd, hd), n0 (B, nh, hd), m0 (B, nh): the state
// entering the scan; Cs (B nh, nc-1, hd, hd), ns (B nh, nc-1, hd), ms (B nh,
// nc-1): the states entering chunks 1 .. nc-1 of 64 steps, as mlstm_chunk_fwd
// leaves them in its workspace (unread when nc = 1). Contiguous fp32 device
// memory, 4-byte aligned, the outputs apart from the inputs. ws: ws_floats
// floats of device memory, 16-byte aligned, apart from the rest; at least
// mlstm_chunk_bwd_workspace_floats(B, S, nh, hd) of them, else it launches
// nothing and returns cudaErrorInvalidValue. S >= 1; hd a multiple of 32 up
// to 512. Launches the four passes on the stream, in order. Returns a
// cudaError_t.
extern "C" int mlstm_chunk_bwd(
    const void* q, const void* k, const void* v, const void* log_i,
    const void* log_f, const void* h, const void* dh, const void* C0,
    const void* n0, const void* m0, const void* Cs, const void* ns,
    const void* ms, void* dq, void* dk, void* dv, void* dlog_i, void* dlog_f,
    void* ws, long long ws_floats, int B, int S, int nh, int hd,
    void* stream) {
  if (!valid_shape(B, S, nh, hd) || ws == nullptr ||
      reinterpret_cast<uintptr_t>(ws) % 16)
    return (int)cudaErrorInvalidValue;
  Params prm{};
  prm.q = static_cast<const float*>(q);
  prm.k = static_cast<const float*>(k);
  prm.v = static_cast<const float*>(v);
  prm.log_i = static_cast<const float*>(log_i);
  prm.log_f = static_cast<const float*>(log_f);
  prm.h = static_cast<const float*>(h);
  prm.dh = static_cast<const float*>(dh);
  prm.C0 = static_cast<const float*>(C0);
  prm.n0 = static_cast<const float*>(n0);
  prm.m0 = static_cast<const float*>(m0);
  prm.Cs = static_cast<const float*>(Cs);
  prm.ns = static_cast<const float*>(ns);
  prm.ms = static_cast<const float*>(ms);
  prm.dq = static_cast<float*>(dq);
  prm.dk = static_cast<float*>(dk);
  prm.dv = static_cast<float*>(dv);
  prm.dli = static_cast<float*>(dlog_i);
  prm.dlf = static_cast<float*>(dlog_f);
  set_shape(prm, S, nh, hd);
  if (cut_workspace(prm, static_cast<float*>(ws), B) > ws_floats)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = B * nh;
  cudaError_t err;
  mlstm_bwd_weight_kernel<<<dim3(kL / kRows, prm.nc, bh), kWeightThreads, 0,
                            s>>>(prm);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  mlstm_bwd_state_kernel<<<dim3(prm.nt * prm.nt, bh), kStateThreads, 0, s>>>(
      prm);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  mlstm_bwd_grad_kernel<<<dim3(prm.nc, 3 * prm.nsl, bh), kGradThreads, 0,
                          s>>>(prm);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  mlstm_bwd_gate_kernel<<<dim3(prm.nc, bh), kL, 0, s>>>(prm);
  return (int)cudaGetLastError();
}
