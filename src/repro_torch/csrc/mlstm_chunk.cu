// Chunkwise stabilised mLSTM for Hopper (sm_90a).
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
//         / max(|sum_s w[t,s] + exp(m + F_t - m_row_t) q_t . n|, exp(-m_row_t)),
// then at the chunk's end C, n, m advance by the chunk's keys and values.
// Unlike the TPU kernel it takes an initial (C, n, m) and writes the final
// one (the engine hands it from prefill to decode), takes any S >= 1 by
// masking the rows past S instead of padding, and runs hd up to 512.
//
// The trap is the size of C: at xLSTM-350M's full width hd = 2 * 1024 / 4
// = 512, and one C is 512 x 512 fp32 = 1 MB, beyond the 227 KB of shared
// memory one block can use (the TPU kernel kept it whole in VMEM). So C is
// split over its value columns: one block owns (b, h, columns j0..j0+kBV)
// and keeps that slice, hd x kBV fp32 (64 KB at hd 512), in shared memory
// for the whole sequence, with its own copy of n and m. Those two depend
// only on the keys and gates, so every column block updates them the same
// way, and the block of columns 0 writes them out. Each block walks the
// chunks in order; its chunk (kL = 64 steps) need not be the model's 256:
// the math is exact for any chunk, and the final m is the log-max over all
// steps for any chunking. Within a chunk it streams q and k through shared
// memory in kTK-wide tiles of hd and forms, in one pass over hd, the kL x kL
// scores q k^T, its slice of q C and q . n; then the weights w, the
// denominators and its slice of h; then, streaming k once more, the update
// C_slice = C_slice exp(m + F_L - m') + (k w_s)^T v_slice. Products stay
// fp32 on the CUDA cores: TF32 cannot meet the 2e-4 of the reference.
//
// Blocks: (hd / kBV) x nh x B, 256 threads each, ~111 KB of shared memory
// at hd 512. A prefill of the served model (B = 1, nh = 4, hd = 512)
// launches 64 blocks on the card's 132 SMs. What bounds it on an H100:
// operations. The chunkwise form at this kernel's chunk needs
// 4 B nh S hd^2 + 2 B nh S kL hd flops (q C and the C update, then the
// causal half of q k^T and w v; 9.1 GFLOP at S = 2048, 0.136 ms at
// 67 TFLOP/s) and moves ~71 MB (0.02 ms). This kernel does more: each of
// the hd / kBV column blocks recomputes the chunk's q k^T over the full hd
// (half its work at hd 512) and the whole kL x kL square, and only 64 of
// the 132 SMs have a block. Splitting q k^T out of the column blocks and
// wgmma/TMA are later work.
#include "common.cuh"

namespace {

constexpr int kL = 64;        // steps of S per chunk
constexpr int kBV = 32;       // value columns of C per block
constexpr int kTK = 32;       // width of the q and k tiles along hd
constexpr int kThreads = 256;
constexpr int kMaxHd = 512;

// Shared memory of one block, in floats.
__host__ __device__ constexpr int smem_floats(int hd) {
  return hd * kBV          // C slice (hd, kBV)
         + hd              // n
         + 2 * kL * (kTK + 1)  // q and k tiles, padded against bank conflicts
         + kL * kBV        // v slice
         + kL * (kL + 1)   // w
         + 6 * kL          // log_i, F, m_row, exp(m_inter - m_row), denom, w_s
         + 2;              // m', exp(m + F_L - m')
}

__global__ void __launch_bounds__(kThreads)
mlstm_chunk_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ log_i,
                   const float* __restrict__ log_f,
                   const float* __restrict__ C0, const float* __restrict__ n0,
                   const float* __restrict__ m0, float* __restrict__ h_out,
                   float* __restrict__ C_out, float* __restrict__ n_out,
                   float* __restrict__ m_out, int S, int nh, int hd) {
  extern __shared__ float smem[];
  float* Cs = smem;                        // [hd][kBV]
  float* ns = Cs + hd * kBV;               // [hd]
  float* qs = ns + hd;                     // [kL][kTK + 1]
  float* ks = qs + kL * (kTK + 1);         // [kL][kTK + 1]
  float* vs = ks + kL * (kTK + 1);         // [kL][kBV]
  float* ws = vs + kL * kBV;               // [kL][kL + 1]
  float* li_s = ws + kL * (kL + 1);        // [kL]
  float* F_s = li_s + kL;
  float* mrow_s = F_s + kL;
  float* einter_s = mrow_s + kL;
  float* den_s = einter_s + kL;
  float* wk_s = den_s + kL;                // the chunk-end weights w_s
  float* scal = wk_s + kL;                 // m', exp(m + F_L - m')

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = blockIdx.x * kBV, h = blockIdx.y, b = blockIdx.z;
  const long bh = (long)b * nh + h;
  const long row = (long)nh * hd;          // stride of one step in q, k, v, h

  for (int i = tid; i < hd * kBV; i += kThreads) {
    const int d = i / kBV, j = i % kBV;
    Cs[i] = C0[(bh * hd + d) * hd + j0 + j];
  }
  for (int d = tid; d < hd; d += kThreads) ns[d] = n0[bh * hd + d];
  float m = m0[bh];
  __syncthreads();

  // the scores tile of this thread: rows ty + 16 a, columns tx + 16 c
  const int ty = tid / 16, tx = tid % 16;

  for (int t0 = 0; t0 < S; t0 += kL) {
    const int Lc = min(kL, S - t0);
    const float* qb = q + ((long)b * S + t0) * row + (long)h * hd;
    const float* kb = k + ((long)b * S + t0) * row + (long)h * hd;
    const float* vb = v + ((long)b * S + t0) * row + (long)h * hd + j0;

    // gates: rows past S inject nothing and do not decay the state
    if (tid < kL) {
      const long g = ((long)b * S + t0 + tid) * nh + h;
      li_s[tid] = tid < Lc ? log_i[g] : rt::kNegInf;
      F_s[tid] = tid < Lc ? log_f[g] : 0.f;
    }
    __syncthreads();
    if (tid == 0) {   // F = cumsum(log_f); m_row = max(m_intra, m + F)
      float F = 0.f, best = rt::kNegInf;
      for (int t = 0; t < kL; ++t) {
        F += F_s[t];
        F_s[t] = F;
        best = fmaxf(best, li_s[t] - F);   // max_{s<=t} (log_i_s - F_s)
        mrow_s[t] = fmaxf(F + best, m + F);
      }
    }

    // one pass over hd: scores q k^T, q C[:, slice], q . n
    float sc[4][4] = {};
    float qc[8] = {};
    float qn = 0.f;
    for (int d0 = 0; d0 < hd; d0 += kTK) {
      __syncthreads();
      for (int i = tid; i < kL * kTK; i += kThreads) {
        const int t = i / kTK, dd = i % kTK;
        const bool ok = t < Lc;
        qs[t * (kTK + 1) + dd] = ok ? qb[(long)t * row + d0 + dd] : 0.f;
        ks[t * (kTK + 1) + dd] = ok ? kb[(long)t * row + d0 + dd] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int dd = 0; dd < kTK; ++dd) {
        float qa[4], kc[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) qa[a] = qs[(ty + 16 * a) * (kTK + 1) + dd];
#pragma unroll
        for (int c = 0; c < 4; ++c) kc[c] = ks[(tx + 16 * c) * (kTK + 1) + dd];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) sc[a][c] = fmaf(qa[a], kc[c], sc[a][c]);
        const float cv = Cs[(d0 + dd) * kBV + lane];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          qc[r] = fmaf(qs[(warp + 8 * r) * (kTK + 1) + dd], cv, qc[r]);
      }
      if (tid < kL) {
        for (int dd = 0; dd < kTK; ++dd)
          qn = fmaf(qs[tid * (kTK + 1) + dd], ns[d0 + dd], qn);
      }
    }

    // w[t, s] = scores exp(D[t, s] - m_row_t) for s <= t < Lc, else 0
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int t = ty + 16 * a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int s = tx + 16 * c;
        float w = 0.f;
        if (s <= t && t < Lc)
          w = sc[a][c] * expf(F_s[t] - F_s[s] + li_s[s] - mrow_s[t]);
        ws[t * (kL + 1) + s] = w;
      }
    }
    for (int i = tid; i < kL * kBV; i += kThreads) {
      const int t = i / kBV, j = i % kBV;
      vs[i] = t < Lc ? vb[(long)t * row + j] : 0.f;
    }
    __syncthreads();
    if (tid < kL) {   // denominators
      float sum = 0.f;
      for (int s = 0; s <= tid; ++s) sum += ws[tid * (kL + 1) + s];
      const float e = expf(m + F_s[tid] - mrow_s[tid]);
      einter_s[tid] = e;
      den_s[tid] = fmaxf(fabsf(sum + e * qn), expf(-mrow_s[tid]));
    }
    if (tid == 0) {   // chunk end: m' = max(m + F_L, max_s (F_L - F_s + li_s))
      const float FL = F_s[Lc - 1];
      float mn = m + FL;
      for (int s = 0; s < Lc; ++s) mn = fmaxf(mn, FL - F_s[s] + li_s[s]);
      scal[0] = mn;
      scal[1] = expf(m + FL - mn);
    }
    __syncthreads();

    // h[t, slice] = (w v[:, slice] + e_t q_t C[:, slice]) / denom_t
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int t = warp + 8 * r;
      if (t < Lc) {
        float acc = 0.f;
        for (int s = 0; s <= t; ++s)
          acc = fmaf(ws[t * (kL + 1) + s], vs[s * kBV + lane], acc);
        acc = fmaf(einter_s[t], qc[r], acc);
        h_out[((long)b * S + t0 + t) * row + (long)h * hd + j0 + lane] =
            acc / den_s[t];
      }
    }
    if (tid < kL) {
      const float FL = F_s[Lc - 1];
      wk_s[tid] = tid < Lc ? expf(FL - F_s[tid] + li_s[tid] - scal[0]) : 0.f;
    }
    const float m_next = scal[0], scale_old = scal[1];

    // C[:, slice] = C scale_old + (k w_s)^T v[:, slice];  n likewise
    for (int d0 = 0; d0 < hd; d0 += kTK) {
      __syncthreads();
      for (int i = tid; i < kL * kTK; i += kThreads) {
        const int t = i / kTK, dd = i % kTK;
        ks[t * (kTK + 1) + dd] =
            t < Lc ? kb[(long)t * row + d0 + dd] * wk_s[t] : 0.f;
      }
      __syncthreads();
      float acc[4] = {};
      for (int s = 0; s < Lc; ++s) {
        const float vv = vs[s * kBV + lane];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          acc[a] = fmaf(ks[s * (kTK + 1) + warp + 8 * a], vv, acc[a]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float* c = &Cs[(d0 + warp + 8 * a) * kBV + lane];
        *c = fmaf(*c, scale_old, acc[a]);
      }
      if (tid < kTK) {
        float sum = 0.f;
        for (int s = 0; s < Lc; ++s) sum += ks[s * (kTK + 1) + tid];
        ns[d0 + tid] = fmaf(ns[d0 + tid], scale_old, sum);
      }
    }
    m = m_next;
    __syncthreads();
  }

  for (int i = tid; i < hd * kBV; i += kThreads) {
    const int d = i / kBV, j = i % kBV;
    C_out[(bh * hd + d) * hd + j0 + j] = Cs[i];
  }
  if (blockIdx.x == 0) {
    for (int d = tid; d < hd; d += kThreads) n_out[bh * hd + d] = ns[d];
    if (tid == 0) m_out[bh] = m;
  }
}

}  // namespace

// C interface (bound with ctypes). q, k, v, h_out (B, S, nh, hd); log_i,
// log_f (B, S, nh); C0, C_out (B, nh, hd, hd); n0, n_out (B, nh, hd); m0,
// m_out (B, nh): contiguous fp32 device memory, the outputs apart from the
// inputs. S >= 1; hd a multiple of 32 up to 512. Returns a cudaError_t.
extern "C" int mlstm_chunk_fwd(const void* q, const void* k, const void* v,
                               const void* log_i, const void* log_f,
                               const void* C0, const void* n0, const void* m0,
                               void* h_out, void* C_out, void* n_out,
                               void* m_out, int B, int S, int nh, int hd,
                               void* stream) {
  if (B <= 0 || S <= 0 || nh <= 0 || hd <= 0 || hd % kBV || hd % kTK ||
      hd > kMaxHd)
    return (int)cudaErrorInvalidValue;
  const int smem = smem_floats(hd) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(hd / kBV, nh, B);
  mlstm_chunk_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(log_i),
      static_cast<const float*>(log_f), static_cast<const float*>(C0),
      static_cast<const float*>(n0), static_cast<const float*>(m0),
      static_cast<float*>(h_out), static_cast<float*>(C_out),
      static_cast<float*>(n_out), static_cast<float*>(m_out), S, nh, hd);
  return (int)cudaGetLastError();
}
