// The backward of the chunkwise stabilised mLSTM (csrc/mlstm_chunk.cu) for
// Hopper (sm_90a): four launches, every product on the tensor cores in split
// TF32.
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
// passes; the CPU tests hold it against jax.vjp of _mlstm_chunk_scan, and
// tests/test_torch_mlstm_bwd_tf32.py this kernel's arithmetic against it.
//
// What bounds it on an H100: operations. The dC' chain, C_c dnum, dC' v and
// dC'^T k take 8 B nh S hd^2 flops; q k^T, dh v^T and the three intra-chunk
// products of dq, dk and dv, each over the causal half of a 64-step chunk,
// 5 B nh S 64 hd: 37.04 GFLOP at the training shape (B = 1, S = 4096, nh =
// 4, hd = 512), 0.5529 ms at fp32's 67 TFLOP/s. Split TF32 does three TF32
// products for each: 111.1 GFLOP, 0.224 ms at 495 TFLOP/s, the floor of
// this design. The first design (four CUDA-core launches, 2.8164 ms on an
// H100 at 700 W) ran every product as an fmaf loop over tiles staged by
// synchronous scalar loads, and its intra-chunk products over the whole
// chunk. This one:
//   1. Weight pass, grid (16-row tiles, chunks, B nh), 4 warps: q k^T and
//      dh v^T over hd on mma.sync, the q, dh, h, k and v tiles in flight by
//      16-byte cp.async (double-buffered) while the last ones multiply, and
//      only the causal keys (row tile r needs keys s < 16 (r + 1)); then the
//      gates (summed in fp64, tf32.cuh's chunk_gates), m_row, P, W, a, den,
//      da; writes dS, W / den and dD (kL x kL a chunk), e, 1 / den, da,
//      q . n_c per step, and (row tile 0) the chunk end's w_s and scale_c.
//   2. State pass, grid (64 x 64 tiles of dC, B nh), 8 warps: walks the
//      chunks in reverse, writing dC'_c and dn'_c to the workspace and its
//      tile's part of dscale_c, then dC' <- scale_c dC' + (e q)^T (dh / den)
//      as one 64 x 64 x 64 product on mma.sync, e_t / den_t folded into the
//      q operand before its split. The next chunk's q, dh and C_c tiles, e,
//      1 / den, da, n and scale are in flight by cp.async while it runs. The
//      dn' chain and the dscale parts stay on the CUDA cores.
//   3. Gradient pass, grid (chunks, 3 x 128-column slices, B nh), 8 warps
//      of 16 rows x 64 columns: dq, dk or dv for one slice of one chunk, a
//      product over hd (C_c dh, dC' v, k dC'), the slice's part of q . X or
//      k . G for the gate pass, then one over the chunk's steps (dS k,
//      dS^T q, (W / den)^T dh) over its causal half only. Both stream
//      through one double-buffered pair of cp.async tiles, the transposed
//      operands read by load_at / load_bt from tiles stored untransposed.
//   4. Gate pass, grid (chunks, B nh), one thread a step: dD's row and
//      column sums, the slices' and tiles' parts summed, and the reverse
//      cumsum of dF in fp64.
// Numerics, as the forward's: h divides by a denominator that can cancel,
// so the gradients amplify rounding as h does, and one TF32 product would
// not hold. Each operand is split as hi = tf32(x), lo = tf32(x - hi), and
// a_lo b_hi + a_hi b_lo + a_hi b_hi summed in fp32 (tf32.cuh); each
// tensor-core sum runs over at most 24 mma steps (a 32-deep stage, or the
// state pass's 64-step chunk) and is then added in fp32. No atomics: two
// calls give the same bits. Shared-memory tiles are padded so every
// fragment load hits 32 banks. Tiles move by 16-byte cp.async, so q, k, v,
// h, dh, C0 and the chunks' states are 16-byte aligned (the wrapper copies
// an operand that is not).
//
// Workspace (one buffer: mlstm_chunk_bwd_workspace_floats counts it, the
// wrapper allocates it, mlstm_chunk_bwd refuses one that is too small),
// nc = ceil(S / 64), nsl = ceil(hd / 128), nt = ceil(hd / 64):
//   dC'_c, dn'_c for chunks 0 .. nc-2       B nh (nc-1) (hd^2 + hd) floats
//   dS, W / den, dD                         3 B nh nc 64^2
//   e, 1 / den, da, q . n, w                5 B nh nc 64
//   the slices' and tiles' parts, scale     B nh nc (2 nsl 64 + nt^2 + 1)
// 278,258,688 bytes at the training shape.
#include "tf32.cuh"

namespace {

using namespace tf32;   // split TF32, cp.async, chunk_gates

constexpr int kL = 64;        // steps of S per chunk (the forward's)
constexpr int kPer = kL / 32; // steps of a chunk per lane in the gate scans
constexpr int kT = 64;        // rows and columns of a dC tile (state pass)
constexpr int kRows = 16;     // rows per weight-pass block
constexpr int kSlice = 128;   // output columns per gradient-pass block
constexpr int kK = 32;        // depth of a tile stage
constexpr int kMaxHd = 512;
constexpr unsigned kFull = 0xffffffffu;

// Row strides of the shared-memory tiles. A fragment load reads, over a
// warp, elements (8 groups g) x (4 slots t). Where g runs along a tile's
// rows a stride of 4 mod 32 puts them on 32 banks; where t does, 8 mod 32.
// Every stride is a multiple of 4 floats, so rows stay 16-byte aligned.
constexpr int kLdA = kK + 4;       // [row][depth] tiles of 32 depths
constexpr int kLdT = kL + 8;       // [depth][64 columns] tiles
constexpr int kLdB = kSlice + 8;   // [depth][128 columns] tiles

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
// 1. weight pass
// ---------------------------------------------------------------------------

// Four warps; warp w holds the keys of n8 tiles w + 4 jj.
constexpr int kWeightThreads = 128;
constexpr int kKeyTiles = kL / 32;   // n8 key tiles per warp

struct WeightSmem {
  float q[2][kRows][kLdA];    // q[row][d - d0], double-buffered
  float dh[2][kRows][kLdA];   // dh[row][d - d0]
  float h[2][kRows][kLdA];    // h[row][d - d0]
  float k[2][kL][kLdA];       // k[step][d - d0]
  float v[2][kL][kLdA];       // v[step][d - d0]
  float n[kMaxHd];            // n_c
  double F[kL];
  float li[kL], m_row[kL];
  float rowsum[4][kRows];     // by warp
  float qn[kRows], dhh[kRows];
  float R[kRows], da[kRows];
};

__global__ void __launch_bounds__(kWeightThreads)
mlstm_bwd_weight_kernel(const Params p) {
  extern __shared__ float4 smem_raw[];
  WeightSmem& sm = *reinterpret_cast<WeightSmem*>(smem_raw);
  const int r = blockIdx.x, c = blockIdx.y, bh = blockIdx.z;
  const int b = bh / p.nh, hh = bh % p.nh;
  const int S = p.S, hd = p.hd, nc = p.nc;
  const int t0 = c * kL, Lc = min(kL, S - t0), r0 = r * kRows;
  const int keys = r0 + kRows;   // row tile r needs keys s < 16 (r + 1)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const long row = (long)p.nh * hd;
  const long base = ((long)b * S + t0) * row + (long)hh * hd;
  const long slot = (long)bh * (nc - 1) + c - 1;   // chunk c > 0's state
  const float* n_c = c == 0 ? p.n0 + (long)bh * hd : p.ns + slot * hd;
  const float m_c = c == 0 ? p.m0[bh] : p.ms[slot];
  const long cs = (long)bh * nc + c;

  for (int i = tid; i < hd; i += kWeightThreads)
    cp_async4(&sm.n[i], n_c + i, true);
  auto load = [&](int step, int st) {
    const int d0 = step * kK;
    for (int i = tid; i < kRows * kK / 4; i += kWeightThreads) {
      const int t = i / (kK / 4), x = i % (kK / 4) * 4;
      const bool ok = r0 + t < Lc;
      const long o = base + (r0 + t) * row + d0 + x;
      cp_async16(&sm.q[st][t][x], ok ? p.q + o : p.q, ok);
      cp_async16(&sm.dh[st][t][x], ok ? p.dh + o : p.dh, ok);
      cp_async16(&sm.h[st][t][x], ok ? p.h + o : p.h, ok);
    }
    for (int i = tid; i < keys * kK / 4; i += kWeightThreads) {
      const int s = i / (kK / 4), x = i % (kK / 4) * 4;
      const bool ok = s < Lc;
      const long o = base + s * row + d0 + x;
      cp_async16(&sm.k[st][s][x], ok ? p.k + o : p.k, ok);
      cp_async16(&sm.v[st][s][x], ok ? p.v + o : p.v, ok);
    }
    cp_async_commit();
  };
  load(0, 0);

  // F, log_i and m_row = max(F_t + max_{s<=t} (li_s - F_s), m_c + F_t), as
  // the forward's weight pass
  if (warp == 0) {
    const long gi = ((long)b * S + t0) * p.nh + hh;
    const auto gt =
        chunk_gates<kPer>(p.log_i + gi, p.log_f + gi, p.nh, Lc, lane);
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

  // q k^T and dh v^T of this block's rows against the keys of n8 tiles
  // warp + 4 jj, in split TF32; q . n and dh . h on the CUDA cores
  float Sc[kKeyTiles][4] = {}, G[kKeyTiles][4] = {};
  float qn = 0.f, dhh = 0.f;
  const int dot_row = tid >> 3, dot_seg = (tid & 7) * (kK / 8);
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
    if (8 * warp < keys) {
      float PS[kKeyTiles][4] = {}, PG[kKeyTiles][4] = {};
#pragma unroll
      for (int kk = 0; kk < kK / 8; ++kk) {
        Tf32 aq[4], ag[4];
        load_a(aq, &sm.q[st][0][8 * kk], kLdA, g, t4);
        load_a(ag, &sm.dh[st][0][8 * kk], kLdA, g, t4);
#pragma unroll
        for (int jj = 0; jj < kKeyTiles; ++jj) {
          const int s0 = 8 * (warp + 4 * jj);
          if (s0 < keys) {   // B(d, s) = k[s][d], v[s][d]
            Tf32 bf[2];
            load_bt(bf, &sm.k[st][s0][8 * kk], kLdA, g, t4);
            mma3(PS[jj], aq, bf);
            load_bt(bf, &sm.v[st][s0][8 * kk], kLdA, g, t4);
            mma3(PG[jj], ag, bf);
          }
        }
      }
#pragma unroll
      for (int jj = 0; jj < kKeyTiles; ++jj)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          Sc[jj][i] += PS[jj][i];
          G[jj][i] += PG[jj][i];
        }
    }
#pragma unroll
    for (int x = 0; x < kK / 8; ++x) {
      const int xx = dot_seg + x;
      qn = fmaf(sm.q[st][dot_row][xx], sm.n[step * kK + xx], qn);
      dhh = fmaf(sm.dh[st][dot_row][xx], sm.h[st][dot_row][xx], dhh);
    }
    __syncthreads();   // before the next load overwrites this stage
  }
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) {
    qn += __shfl_xor_sync(kFull, qn, o);
    dhh += __shfl_xor_sync(kFull, dhh, o);
  }
  if ((tid & 7) == 0) {
    sm.qn[dot_row] = qn;
    sm.dhh[dot_row] = dhh;
  }

  // P and W at the thread's accumulator entries: rows r0 + g (+ 8), keys
  // 8 (warp + 4 jj) + 2 t4 (+ 1); W's row sums
  float P[kKeyTiles][4], W[kKeyTiles][4], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int jj = 0; jj < kKeyTiles; ++jj)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = r0 + g + 8 * (i >> 1);
      const int s = 8 * (warp + 4 * jj) + 2 * t4 + (i & 1);
      P[jj][i] = s <= t && t < Lc
                     ? expf((float)(sm.F[t] - sm.F[s] + sm.li[s]) -
                            sm.m_row[t])
                     : 0.f;
      W[jj][i] = Sc[jj][i] * P[jj][i];
      rs[i >> 1] += W[jj][i];
    }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    rs[hf] += __shfl_xor_sync(kFull, rs[hf], 1);
    rs[hf] += __shfl_xor_sync(kFull, rs[hf], 2);
    if (t4 == 0) sm.rowsum[warp][g + 8 * hf] = rs[hf];
  }
  __syncthreads();
  if (tid < kRows) {   // a, den, da of row r0 + tid
    const int t = r0 + tid;
    const bool live = t < Lc;
    const float mr = sm.m_row[t];
    const float sum = sm.rowsum[0][tid] + sm.rowsum[1][tid] +
                      sm.rowsum[2][tid] + sm.rowsum[3][tid];
    const float e = live ? expf((float)(m_c + sm.F[t]) - mr) : 0.f;
    const float a = sum + e * sm.qn[tid], flo = expf(-mr);
    const float Rt = live ? 1.f / fmaxf(fabsf(a), flo) : 0.f;
    const float dden = -sm.dhh[tid] * Rt;   // d den = -(dh . h) / den
    const float da = live && fabsf(a) >= flo
                         ? (a > 0.f ? dden : a < 0.f ? -dden : 0.f)
                         : 0.f;
    sm.R[tid] = Rt;
    sm.da[tid] = da;
    const long o = cs * kL + t;
    p.E[o] = e;
    p.R[o] = Rt;
    p.DA[o] = da;
    p.QN[o] = sm.qn[tid];
  }
  __syncthreads();
  // dW = (dh v^T) / den + da; every column of the rows is written
  const long mo = cs * kL * kL;
#pragma unroll
  for (int jj = 0; jj < kKeyTiles; ++jj)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int t = r0 + g + 8 * hf, s = 8 * (warp + 4 * jj) + 2 * t4;
      const float Rt = sm.R[g + 8 * hf], da = sm.da[g + 8 * hf];
      float dS[2], dD[2], Wd[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 2 * hf + e;
        const float dW = fmaf(G[jj][i], Rt, da);
        dS[e] = dW * P[jj][i];
        dD[e] = dW * W[jj][i];
        Wd[e] = W[jj][i] * Rt;
      }
      const long o = mo + (long)t * kL + s;
      *reinterpret_cast<float2*>(p.dS + o) = make_float2(dS[0], dS[1]);
      *reinterpret_cast<float2*>(p.dD + o) = make_float2(dD[0], dD[1]);
      *reinterpret_cast<float2*>(p.Wd + o) = make_float2(Wd[0], Wd[1]);
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

// Eight warps tile the 64 x 64 tile of dC: 4 along its rows by 2 along its
// columns, each 16 rows by 32 columns (four n8 tiles).
constexpr int kStateThreads = 256;
constexpr int kNT = 4;   // n8 tiles per warp

struct StateSmem {
  float q[2][kL][kLdT];    // q_t[d0 + x] of a chunk, double-buffered
  float g[2][kL][kLdT];    // dh_t[j0 + x]
  float C[2][kT][kLdT];    // C_c[d0 + i][j0 + x]
  float E[2][kL], R[2][kL], DA[2][kL];
  float n[2][kT];          // n_c[d0 + i] (blocks with j0 = 0)
  float scale[2][4];       // scale_c in [0]
  float red[kStateThreads / 32];
};

__global__ void __launch_bounds__(kStateThreads, 2)
mlstm_bwd_state_kernel(const Params p) {
  extern __shared__ float4 smem_raw[];
  StateSmem& sm = *reinterpret_cast<StateSmem*>(smem_raw);
  const int nt = p.nt, ntt = nt * nt;
  const int d0 = (blockIdx.x / nt) * kT, j0 = (blockIdx.x % nt) * kT;
  const int bh = blockIdx.y, b = bh / p.nh, hh = bh % p.nh;
  const int S = p.S, hd = p.hd, nc = p.nc;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = 16 * (warp & 3), wc = 32 * (warp >> 2);   // warp's corner
  const long row = (long)p.nh * hd, hd2 = (long)hd * hd;
  const long head = (long)b * S * row + (long)hh * hd;
  const bool holds_n = j0 == 0 && tid < kT && d0 + tid < hd;

  // dC' in accumulator layout: rows d0 + wr + g (+ 8), columns
  // j0 + wc + 8 n + 2 t4 (+ 1)
  auto row_ok = [&](int r) { return d0 + wr + g + 8 * r < hd; };
  auto col_ok = [&](int n) { return j0 + wc + 8 * n < hd; };
  float dC[kNT][4] = {};
  float dn = 0.f;

  auto load = [&](int c, int st) {   // chunk c's tiles, gates and scale
    const int t0 = c * kL, Lc = min(kL, S - t0);
    const long cs = (long)bh * nc + c;
    const long prev = (long)bh * (nc - 1) + c - 1;
    const bool need_C = c < nc - 1;   // no gradient leaves the last chunk
    const float* Cc = c == 0 ? p.C0 + bh * hd2 : p.Cs + prev * hd2;
    for (int i = tid; i < kL * kT / 4; i += kStateThreads) {
      const int t = i / (kT / 4), x = i % (kT / 4) * 4;
      const long o = head + (long)(t0 + t) * row;
      const bool ok_q = t < Lc && d0 + x < hd, ok_g = t < Lc && j0 + x < hd;
      cp_async16(&sm.q[st][t][x], ok_q ? p.q + o + d0 + x : p.q, ok_q);
      cp_async16(&sm.g[st][t][x], ok_g ? p.dh + o + j0 + x : p.dh, ok_g);
      // C_c's rows d0 + t, columns j0 + x
      const bool ok_c = need_C && d0 + t < hd && j0 + x < hd;
      cp_async16(&sm.C[st][t][x],
                 ok_c ? Cc + (long)(d0 + t) * hd + j0 + x : p.C0, ok_c);
    }
    if (tid < kL) {
      const long o = cs * kL + tid;
      cp_async4(&sm.E[st][tid], p.E + o, true);
      cp_async4(&sm.R[st][tid], p.R + o, true);
      cp_async4(&sm.DA[st][tid], p.DA + o, true);
    }
    if (holds_n && need_C) {
      const float* n_c = c == 0 ? p.n0 + (long)bh * hd : p.ns + prev * hd;
      cp_async4(&sm.n[st][tid], n_c + d0 + tid, true);
    }
    if (tid == 0) cp_async4(&sm.scale[st][0], p.scale + cs, true);
    cp_async_commit();
  };

  load(nc - 1, 0);
  for (int c = nc - 1, it = 0; c >= 0; --c, ++it) {
    const int st = it & 1, Lc = min(kL, S - c * kL);
    const long cs = (long)bh * nc + c;
    if (c > 0) {
      load(c - 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // the gradient leaving chunk c (zero for the last) for the gradient
    // pass, and its product with C_c for dscale_c
    float part = 0.f;
    if (c < nc - 1) {
      const long slot = (long)bh * (nc - 1) + c;
      float* dst = p.dCs + slot * hd2;
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (!row_ok(r) || !col_ok(n)) continue;
          const int i = wr + g + 8 * r, j = wc + 8 * n + 2 * t4;
          *reinterpret_cast<float2*>(dst + (long)(d0 + i) * hd + j0 + j) =
              make_float2(dC[n][2 * r], dC[n][2 * r + 1]);
          part = fmaf(dC[n][2 * r], sm.C[st][i][j], part);
          part = fmaf(dC[n][2 * r + 1], sm.C[st][i][j + 1], part);
        }
      if (holds_n) {
        p.dns[slot * hd + d0 + tid] = dn;
        part = fmaf(dn, sm.n[st][tid], part);
      }
    }
    part = rt::warp_sum(part);
    if (lane == 0) sm.red[warp] = part;

    // dC' <- scale_c dC' + sum_t q_t (e_t / den_t) dh_t^T, in split TF32
    float U[kNT][4] = {};
#pragma unroll
    for (int kk = 0; kk < kL / 8; ++kk) {
      if (kk * 8 >= Lc) break;
      const int s0 = 8 * kk + t4, s1 = s0 + 4;
      const float f0 = sm.E[st][s0] * sm.R[st][s0];
      const float f1 = sm.E[st][s1] * sm.R[st][s1];
      const float* qp = &sm.q[st][8 * kk][wr];
      Tf32 a[4];   // A(d, t) = q[t][d] e_t / den_t
      a[0] = split(qp[t4 * kLdT + g] * f0);
      a[1] = split(qp[t4 * kLdT + g + 8] * f0);
      a[2] = split(qp[(t4 + 4) * kLdT + g] * f1);
      a[3] = split(qp[(t4 + 4) * kLdT + g + 8] * f1);
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        Tf32 bf[2];
        load_b(bf, &sm.g[st][8 * kk][wc + 8 * n], kLdT, g, t4);
        mma3(U[n], a, bf);
      }
    }
    const float sc = sm.scale[st][0];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) dC[n][i] = fmaf(dC[n][i], sc, U[n][i]);
    if (holds_n) {   // dn' <- scale_c dn' + sum_t da_t e_t q_t
      float sum = 0.f;
      for (int t = 0; t < Lc; ++t)
        sum = fmaf(sm.DA[st][t] * sm.E[st][t], sm.q[st][t][tid], sum);
      dn = fmaf(dn, sc, sum);
    }
    __syncthreads();   // before the next load overwrites this stage
    if (tid == 0) {
      float sum = 0.f;
      for (int w = 0; w < kStateThreads / 32; ++w) sum += sm.red[w];
      p.dscale[cs * ntt + blockIdx.x] = sum;
    }
  }
}

// ---------------------------------------------------------------------------
// 3. gradient pass
// ---------------------------------------------------------------------------

// Eight warps tile the 64 x 128 output tile: 4 along its rows (16 rw ..) by
// 2 along its columns (64 cw ..), eight n8 tiles each.
constexpr int kGradThreads = 256;
constexpr int kAFloats = kL * kLdA;       // A by rows: [64 rows][32 depths]
constexpr int kBFloats = kSlice * kLdA;   // B by columns: [128][32 depths]
static_assert(kK * kLdT == kAFloats, "A by depth: [32 depths][64 rows]");
static_assert(kK * kLdB <= kBFloats, "B by depth: [32 depths][128]");

struct GradSmem {
  float a[2][kAFloats];   // double-buffered stages
  float b[2][kBFloats];
  float part[2][kL];      // the column warps' parts of a row's dot product
};

// One product's operands, each read from global memory in one of two
// layouts (chosen by the template arguments of load_stage and mma_stage):
// A(m, x) = a[m lda + x] (by rows; rows m >= a_rows read as 0) or
// a[x lda + m] (by depth); B(x, n) = b[x ldb + n] (by depth; depths >=
// b_depth read as 0) or b[n ldb + x] (by columns); columns n >= n_cols read
// as 0. depth is a multiple of kK.
struct Operands {
  const float* a;
  long lda;
  int a_rows;
  const float* b;
  long ldb;
  int b_depth, depth;
};

template <bool kADepth, bool kBCols>
__device__ __forceinline__ void load_stage(float* a, float* b,
                                           const Operands& o, int k0,
                                           int n_cols) {
  const int tid = threadIdx.x;
  if (kADepth) {   // a[x][m]: the 64 entries of a depth are contiguous
    for (int i = tid; i < kK * kL / 4; i += kGradThreads) {
      const int x = i / (kL / 4), m = i % (kL / 4) * 4;
      cp_async16(a + x * kLdT + m, o.a + (k0 + x) * o.lda + m, true);
    }
  } else {         // a[m][x]
    for (int i = tid; i < kL * kK / 4; i += kGradThreads) {
      const int m = i / (kK / 4), x = i % (kK / 4) * 4;
      const bool ok = m < o.a_rows;
      cp_async16(a + m * kLdA + x, ok ? o.a + m * o.lda + k0 + x : o.a, ok);
    }
  }
  if (kBCols) {    // b[n][x]
    for (int i = tid; i < kSlice * kK / 4; i += kGradThreads) {
      const int n = i / (kK / 4), x = i % (kK / 4) * 4;
      const bool ok = n < n_cols;
      cp_async16(b + n * kLdA + x, ok ? o.b + n * o.ldb + k0 + x : o.b, ok);
    }
  } else {         // b[x][n]
    for (int i = tid; i < kK * kSlice / 4; i += kGradThreads) {
      const int x = i / (kSlice / 4), n = i % (kSlice / 4) * 4;
      const bool ok = k0 + x < o.b_depth && n < n_cols;
      cp_async16(b + x * kLdB + n, ok ? o.b + (k0 + x) * o.ldb + n : o.b,
                 ok);
    }
  }
}

// P += A B over the stage's depth steps kk in [lo, hi) for the warp's rows
// 16 rw .. and columns 64 cw ..
template <bool kADepth, bool kBCols>
__device__ __forceinline__ void mma_stage(float (&P)[8][4], const float* a,
                                          const float* b, int lo, int hi,
                                          int rw, int cw, int g, int t4) {
#pragma unroll
  for (int kk = 0; kk < kK / 8; ++kk) {
    if (kk < lo || kk >= hi) continue;
    Tf32 af[4];
    if (kADepth)
      load_at(af, a + 8 * kk * kLdT + 16 * rw, kLdT, g, t4);
    else
      load_a(af, a + 16 * rw * kLdA + 8 * kk, kLdA, g, t4);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = 64 * cw + 8 * n;
      Tf32 bf[2];
      if (kBCols)
        load_bt(bf, b + col * kLdA + 8 * kk, kLdA, g, t4);
      else
        load_b(bf, b + 8 * kk * kLdB + col, kLdB, g, t4);
      mma3(P[n], af, bf);
    }
  }
}

// How a product's rows see its depths: all of them (the products over hd),
// or the causal half of the chunk: with kLower the rows 16 rw .. 16 rw + 15
// (steps t) see the depths (keys s) up to themselves, with kUpper the rows
// (keys s) see the depths (steps t) from themselves on.
enum Causal { kAll, kLower, kUpper };

// acc += A B over o's depth, in stages of kK through the double-buffered
// tiles: each stage's sum on the tensor cores starts from zero and is added
// to acc in fp32.
template <bool kADepth, bool kBCols, Causal kCausal>
__device__ __forceinline__ void product(float (&acc)[8][4], GradSmem& sm,
                                        const Operands& o, int n_cols,
                                        int Lc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3, rw = warp & 3, cw = warp >> 2;
  const int n = o.depth / kK;
  if (n == 0) return;
  auto load = [&](int step, int st) {
    load_stage<kADepth, kBCols>(sm.a[st], sm.b[st], o, step * kK, n_cols);
    cp_async_commit();
  };
  load(0, 0);
  for (int step = 0; step < n; ++step) {
    const int st = step & 1;
    if (step + 1 < n) {
      load(step + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    int lo = 0, hi = kK / 8;   // the stage's depth steps this warp needs
    if (kCausal != kAll) {
      const int k0 = step * kK;
      hi = min(hi, (Lc - k0 + 7) / 8);   // depths past Lc are zero
      if (kCausal == kLower) hi = min(hi, (16 * rw + 16 - k0) / 8);
      if (kCausal == kUpper) lo = max(lo, (16 * rw - k0) / 8);
    }
    float P[8][4] = {};
    mma_stage<kADepth, kBCols>(P, sm.a[st], sm.b[st], lo, hi, rw, cw, g, t4);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] += P[j][i];
    __syncthreads();   // before the next load overwrites this stage
  }
}

__global__ void __launch_bounds__(kGradThreads, 2)
mlstm_bwd_grad_kernel(const Params p) {
  extern __shared__ float4 smem_raw[];
  GradSmem& sm = *reinterpret_cast<GradSmem*>(smem_raw);
  const int c = blockIdx.x, bh = blockIdx.z;
  const int kind = blockIdx.y / p.nsl, slice = blockIdx.y % p.nsl;
  const int b = bh / p.nh, hh = bh % p.nh;
  const int S = p.S, hd = p.hd, nc = p.nc;
  const int t0 = c * kL, Lc = min(kL, S - t0);
  const int c0 = slice * kSlice, n_cols = min(kSlice, hd - c0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3, rw = warp & 3, cw = warp >> 2;
  const long row = (long)p.nh * hd, hd2 = (long)hd * hd;
  const long base = ((long)b * S + t0) * row + (long)hh * hd;
  const long cs = (long)bh * nc + c;
  const float* dSc = p.dS + cs * kL * kL;
  const bool has_dC = c < nc - 1;   // no gradient leaves the last chunk
  const long out_slot = (long)bh * (nc - 1) + c;
  const float* dCc = p.dCs + out_slot * hd2;
  const float* dnc = p.dns + out_slot * hd;
  // the thread's accumulator entries: rows 16 rw + g + 8 hf, columns
  // c0 + 64 cw + 8 j + 2 t4 + e at acc[j][2 hf + e]
  auto col = [&](int j) { return 64 * cw + 8 * j + 2 * t4; };
  float acc[8][4] = {};
  // the slice's part of a row's dot product with its operand x, written to
  // dst (B nh, nc, nsl, kL); every row is written
  auto row_part = [&](const float* x, float* dst) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int t = 16 * rw + g + 8 * hf;
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (t < Lc && col(j) < n_cols) {
          const float2 xv = *reinterpret_cast<const float2*>(
              x + base + t * row + c0 + col(j));
          s = fmaf(xv.x, acc[j][2 * hf], s);
          s = fmaf(xv.y, acc[j][2 * hf + 1], s);
        }
      s += __shfl_xor_sync(kFull, s, 1);
      s += __shfl_xor_sync(kFull, s, 2);
      if (t4 == 0) sm.part[cw][t] = s;
    }
    __syncthreads();
    if (tid < kL)
      dst[(cs * p.nsl + slice) * kL + tid] = sm.part[0][tid] +
                                             sm.part[1][tid];
  };
  // the rows' scale (w_s for dk and dv)
  auto scale_rows = [&](const float* w) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float f = w[cs * kL + 16 * rw + g + 8 * hf];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[j][2 * hf] *= f;
        acc[j][2 * hf + 1] *= f;
      }
    }
  };

  if (kind == 0) {   // dq: X_t = C_c dh_t over the slice's rows of C_c, then
                     // + dS k
    const long prev = (long)bh * (nc - 1) + c - 1;
    const float* Cc = c == 0 ? p.C0 + bh * hd2 : p.Cs + prev * hd2;
    const float* n_c = c == 0 ? p.n0 + (long)bh * hd : p.ns + prev * hd;
    product<false, true, kAll>(
        acc, sm, {p.dh + base, row, Lc, Cc + (long)c0 * hd, hd, hd, hd},
        n_cols, Lc);
    row_part(p.q, p.qX);   // q_t . X_t, for de_t
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const long o = cs * kL + 16 * rw + g + 8 * hf;
      const float e = p.E[o], er = e * p.R[o], eda = e * p.DA[o];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int cc = col(j) + x;
          const float nd = cc < n_cols ? n_c[c0 + cc] : 0.f;
          acc[j][2 * hf + x] = fmaf(acc[j][2 * hf + x], er, eda * nd);
        }
    }
    product<false, false, kLower>(
        acc, sm, {dSc, kL, kL, p.k + base + c0, row, Lc, kL}, n_cols, Lc);
  } else if (kind == 1) {   // dk: w_s (dC' v_s + dn'), then + dS^T q
    if (has_dC) {
      product<false, true, kAll>(
          acc, sm, {p.v + base, row, Lc, dCc + (long)c0 * hd, hd, hd, hd},
          n_cols, Lc);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int cc = col(j) + x;
          const float nd = cc < n_cols ? dnc[c0 + cc] : 0.f;
          acc[j][x] += nd;
          acc[j][2 + x] += nd;
        }
    }
    row_part(p.k, p.kG);   // k_s . (dC' v_s + dn'), for dw_s
    scale_rows(p.wS);
    product<true, false, kUpper>(
        acc, sm, {dSc, kL, kL, p.q + base + c0, row, Lc, kL}, n_cols, Lc);
  } else {   // dv: w_s dC'^T k_s, then + (W / den)^T dh
    if (has_dC) {
      product<false, false, kAll>(
          acc, sm, {p.k + base, row, Lc, dCc + c0, hd, hd, hd}, n_cols, Lc);
      scale_rows(p.wS);
    }
    product<true, false, kUpper>(
        acc, sm, {p.Wd + cs * kL * kL, kL, kL, p.dh + base + c0, row, Lc, kL},
        n_cols, Lc);
  }

  float* out = kind == 0 ? p.dq : kind == 1 ? p.dk : p.dv;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int t = 16 * rw + g + 8 * hf;
    if (t >= Lc) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (col(j) < n_cols)
        *reinterpret_cast<float2*>(out + base + t * row + c0 + col(j)) =
            make_float2(acc[j][2 * hf], acc[j][2 * hf + 1]);
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

// Allows the three kernels with products their dynamic shared memory on the
// current device. The attribute holds for the device's context, so this is
// done once a device.
cudaError_t allow_smem() {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(mlstm_bwd_weight_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sizeof(WeightSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mlstm_bwd_state_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sizeof(StateSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(mlstm_bwd_grad_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sizeof(GradSmem));
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
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
// memory, the outputs apart from the inputs; q, k, v, h, dh, C0, Cs and the
// outputs dq, dk, dv 16-byte aligned, the rest 4-byte. ws: ws_floats floats
// of device memory, 16-byte aligned, apart from the rest; at least
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
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = B * nh;
  mlstm_bwd_weight_kernel<<<dim3(kL / kRows, prm.nc, bh), kWeightThreads,
                            sizeof(WeightSmem), s>>>(prm);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  mlstm_bwd_state_kernel<<<dim3(prm.nt * prm.nt, bh), kStateThreads,
                           sizeof(StateSmem), s>>>(prm);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  mlstm_bwd_grad_kernel<<<dim3(prm.nc, 3 * prm.nsl, bh), kGradThreads,
                          sizeof(GradSmem), s>>>(prm);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  mlstm_bwd_gate_kernel<<<dim3(prm.nc, bh), kL, 0, s>>>(prm);
  return (int)cudaGetLastError();
}
