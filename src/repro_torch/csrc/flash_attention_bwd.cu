// Backward of the flash prefill attention, for Hopper (sm_90a).
//
// The gradient of src/repro/kernels/flash_attention/kernel.py::
// flash_attention_pallas, which has no custom_vjp: the JAX model
// differentiates its einsum attention (repro.models.layers.gqa_attention)
// with jax.grad. It takes the forward's whole contract: q (B, Sq, Hq, hd),
// k/v (B, Skv, K, hd), K | Hq (G = Hq / K query heads read one KV head in
// place), any Sq and Skv, causal and/or a sliding window, query positions
// offset by q_off, head_dim up to 256, fp32 or bf16 in and out. Given q, k,
// v, the forward's output o and dO, it returns dq, dk and dv in q's dtype;
// every sum is fp32.
//
// The FlashAttention-2 equations, with S = scale q k^T masked as the
// forward masks it:
//   L_i = logsumexp_j S_ij,  P_ij = exp(S_ij - L_i),  D_i = sum_d dO_id O_id,
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - D),
//   dQ = scale dS K,  dK = scale dS^T Q.
// L is recomputed here (the forward kernels are left as they are and do
// not write it). No atomics: each block owns the rows of the gradient it
// writes, so the result is the same on every run. Tiles that the causal
// diagonal or the window wholly exclude are skipped.
//
// What bounds it on an H100: the work. The gradient's own products are
// 10 hd flops per (query, key) pair and query head (S, dP, dV, dK, dQ);
// recomputing L adds 2 hd and S is formed once more, 16 hd in all. The
// bytes (q, k, v, o, dO read, dq, dk, dv written) are small beside that at
// the training shapes.
//
// Two routes, by dtype (neither falls back to the other):
// - fp32 (head_dim a multiple of 4): the products on the CUDA cores in
//   fp32, three launches of 256 threads as 16 x 16: bwd_lse_kernel (L and
//   D, one block per query tile, query head and batch), bwd_dkdv_kernel
//   (one block per key tile and KV head, dK and dV summed in registers over
//   the admitted query tiles of all G query heads of its KV head) and
//   bwd_dq_kernel (one block per query tile and head). Tiles of 64 query
//   rows and 64 keys (32 and 32 at head_dim 256) sit in shared memory as
//   fp32 with rows padded by one float, P and dS with rows padded to a
//   16-float offset; each thread owns TILE/16 rows x head_dim/16 columns.
// - bf16 (head_dim a multiple of 8): the products on the tensor cores
//   (mma.sync), two launches; see namespace tc below.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads

template <int HDP>
struct Tiling {
  static constexpr int kTile = HDP > 128 ? 32 : 64;  // query rows = keys
  static constexpr int kR = kTile / 16;              // rows a thread owns
  static constexpr int kLd = HDP + 1;                // q/k/v/dO row stride
  static constexpr int kPld = kTile + 16;            // P/dS row stride
  static constexpr int kDj = HDP / 16;               // columns a thread owns
};

// Copy rows [row0, row0 + TILE) of a (rows, stride) matrix into shared
// memory as fp32 with leading dimension ld, zero-filling rows past n_rows
// and columns past hd.
template <int HDP>
__device__ __forceinline__ void load_tile(float* dst, const float* base,
                                          long stride, int row0, int n_rows,
                                          int hd, int tid) {
  constexpr int C4 = HDP / 4, TILE = Tiling<HDP>::kTile,
                LD = Tiling<HDP>::kLd;
  for (int idx = tid; idx < TILE * C4; idx += kThreads) {
    const int r = idx / C4;
    const int c = (idx - r * C4) * 4;
    const int row = row0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < n_rows && c < hd) x = rt::load4(base + row * stride + c);
    float* o = dst + r * LD + c;
    o[0] = x.x;
    o[1] = x.y;
    o[2] = x.z;
    o[3] = x.w;
  }
}

// Whether key c is admitted for the query at absolute position qpos.
__device__ __forceinline__ bool admitted(int c, int qpos, int Skv, int causal,
                                         int window) {
  return c < Skv && (!causal || c <= qpos) &&
         (window <= 0 || c > qpos - window);
}

// The key tiles that some row of the query tile [q0, q0 + TILE) admits:
// [*begin, end), begin a multiple of TILE.
template <int TILE>
__device__ __forceinline__ int key_range(int q0, int Sq, int Skv, int causal,
                                         int window, int q_off, int* begin) {
  const int q_lo = q_off + q0;
  const int q_hi = q_off + min(q0 + TILE, Sq) - 1;
  int b = window > 0 ? max(0, q_lo - window + 1) : 0;
  *begin = b - b % TILE;
  return causal ? min(Skv, q_hi + 1) : Skv;
}

// S (scaled) and dP of the query rows ty + 16 i and keys tx + 16 j of the
// tiles in shared memory; dP only where DP.
template <int HDP, bool DP>
__device__ __forceinline__ void scores(const float* Qs, const float* dOs,
                                       const float* Ks, const float* Vs,
                                       int tx, int ty,
                                       float (&s)[Tiling<HDP>::kR][Tiling<HDP>::kR],
                                       float (&dp)[Tiling<HDP>::kR][Tiling<HDP>::kR]) {
  constexpr int R = Tiling<HDP>::kR, LD = Tiling<HDP>::kLd;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HDP; ++d) {
    float a[R], kk[R];
#pragma unroll
    for (int i = 0; i < R; ++i) a[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < R; ++j) kk[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
    if constexpr (DP) {
      float g[R], vv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) g[i] = dOs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < R; ++j) vv[j] = Vs[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) dp[i][j] = fmaf(g[i], vv[j], dp[i][j]);
    }
  }
}

// Pass 1: L and D of each query row, laid out (B, Hq, Sq).
template <int HDP>
__global__ void __launch_bounds__(kThreads)
bwd_lse_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ o, const float* __restrict__ dout,
               float* __restrict__ lse, float* __restrict__ delta, int Sq,
               int Skv, int Hq, int K, int hd, int causal, int window,
               int q_off) {
  constexpr int TILE = Tiling<HDP>::kTile, R = Tiling<HDP>::kR,
                LD = Tiling<HDP>::kLd;
  extern __shared__ float smem[];
  float* Qs = smem;             // TILE x LD
  float* Ks = Qs + TILE * LD;   // TILE x LD

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (Hq / K);
  const long q_stride = (long)Hq * hd, kv_stride = (long)K * hd;
  const long q_base = ((long)b * Sq * Hq + h) * hd;
  const float* kb = k + ((long)b * Skv * K + kh) * hd;
  const float scale = 1.0f / sqrtf((float)hd);

  load_tile<HDP>(Qs, q + q_base, q_stride, q0, Sq, hd, tid);
  int kv_begin;
  const int kv_end =
      key_range<TILE>(q0, Sq, Skv, causal, window, q_off, &kv_begin);

  float m[R], l[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = rt::kNegInf;
    l[i] = 0.f;
  }
  for (int k0 = kv_begin; k0 < kv_end; k0 += TILE) {
    __syncthreads();  // the previous key tile is consumed
    load_tile<HDP>(Ks, kb, kv_stride, k0, Skv, hd, tid);
    __syncthreads();
    float s[R][R], unused[R][R];
    scores<HDP, false>(Qs, nullptr, Ks, nullptr, tx, ty, s, unused);
    // the online max and sum of each row; the 16 threads that share a row
    // are one half-warp
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qpos = q_off + q0 + ty + 16 * i;
      float mx = rt::kNegInf;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int c = k0 + tx + 16 * j;
        s[i][j] = admitted(c, qpos, Skv, causal, window) ? s[i][j] * scale
                                                         : rt::kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = rt::half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) psum += expf(s[i][j] - m_new);
      psum = rt::half_warp_sum(psum);
      l[i] = l[i] * expf(m[i] - m_new) + psum;
      m[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + 16 * i;
    float dsum = 0.f;
    if (row < Sq) {
      const float* orow = o + q_base + row * q_stride;
      const float* grow = dout + q_base + row * q_stride;
      for (int d = tx; d < hd; d += 16)
        dsum = fmaf(grow[d], orow[d], dsum);
    }
    dsum = rt::half_warp_sum(dsum);
    if (row < Sq && tx == 0) {
      const long at = ((long)b * Hq + h) * Sq + row;
      lse[at] = m[i] + logf(l[i]);
      delta[at] = dsum;
    }
  }
}

// P and dS of the rows ty + 16 i (query rows r0 + ...) and keys tx + 16 j
// (keys k0 + ...) into shared memory (dS only where WRITE_P is false: the
// dQ pass needs no P), from S and dP in registers.
template <int HDP, bool WRITE_P>
__device__ __forceinline__ void probs(float (&s)[Tiling<HDP>::kR][Tiling<HDP>::kR],
                                      float (&dp)[Tiling<HDP>::kR][Tiling<HDP>::kR],
                                      const float* Ls, const float* Ds,
                                      float* Ps, float* dSs, int q0, int k0,
                                      int Sq, int Skv, int causal, int window,
                                      int q_off, float scale, int tx, int ty) {
  constexpr int R = Tiling<HDP>::kR, PLD = Tiling<HDP>::kPld;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty + 16 * i;
    const int row = q0 + r;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int c = tx + 16 * j;
      const bool ok =
          row < Sq && admitted(k0 + c, q_off + row, Skv, causal, window);
      const float p = ok ? expf(s[i][j] * scale - Ls[r]) : 0.f;
      if constexpr (WRITE_P) Ps[r * PLD + c] = p;
      dSs[r * PLD + c] = p * (dp[i][j] - Ds[r]);
    }
  }
}

// L and D of the query rows [q0, q0 + TILE) of head h into shared memory.
template <int TILE>
__device__ __forceinline__ void load_rows(float* Ls, float* Ds,
                                          const float* lse,
                                          const float* delta, long base,
                                          int q0, int Sq, int tid) {
  for (int r = tid; r < TILE; r += kThreads) {
    const int row = q0 + r;
    Ls[r] = row < Sq ? lse[base + row] : 0.f;
    Ds[r] = row < Sq ? delta[base + row] : 0.f;
  }
}

// Pass 2: dK and dV of one key tile of one KV head.
template <int HDP>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk,
                float* __restrict__ dv, int Sq, int Skv, int Hq, int K, int hd,
                int causal, int window, int q_off) {
  constexpr int TILE = Tiling<HDP>::kTile, R = Tiling<HDP>::kR,
                LD = Tiling<HDP>::kLd, PLD = Tiling<HDP>::kPld,
                DJ = Tiling<HDP>::kDj;
  extern __shared__ float smem[];
  float* Ks = smem;              // TILE x LD
  float* Vs = Ks + TILE * LD;    // TILE x LD
  float* Qs = Vs + TILE * LD;    // TILE x LD
  float* dOs = Qs + TILE * LD;   // TILE x LD
  float* Ps = dOs + TILE * LD;   // TILE x PLD
  float* dSs = Ps + TILE * PLD;  // TILE x PLD
  float* Ls = dSs + TILE * PLD;  // TILE
  float* Ds = Ls + TILE;         // TILE

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * TILE, kh = blockIdx.y, b = blockIdx.z;
  const int G = Hq / K;
  const long q_stride = (long)Hq * hd, kv_stride = (long)K * hd;
  const long kv_base = ((long)b * Skv * K + kh) * hd;
  const float scale = 1.0f / sqrtf((float)hd);

  load_tile<HDP>(Ks, k + kv_base, kv_stride, k0, Skv, hd, tid);
  load_tile<HDP>(Vs, v + kv_base, kv_stride, k0, Skv, hd, tid);

  // the query rows that admit some key of this tile: causal rows from the
  // tile's first key on, windowed rows up to its last key + window - 1
  const int k_hi = min(k0 + TILE, Skv) - 1;
  int i_begin = causal ? max(0, k0 - q_off) : 0;
  i_begin -= i_begin % TILE;
  const int i_end = window > 0 ? min(Sq, k_hi + window - q_off) : Sq;

  float acc_k[R][DJ], acc_v[R][DJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int dj = 0; dj < DJ; ++dj) acc_k[i][dj] = acc_v[i][dj] = 0.f;

  for (int hh = 0; hh < G; ++hh) {
    const int h = kh * G + hh;
    const long q_base = ((long)b * Sq * Hq + h) * hd;
    const long row_base = ((long)b * Hq + h) * Sq;
    for (int q0 = i_begin; q0 < i_end; q0 += TILE) {
      __syncthreads();  // the previous query tile is consumed
      load_tile<HDP>(Qs, q + q_base, q_stride, q0, Sq, hd, tid);
      load_tile<HDP>(dOs, dout + q_base, q_stride, q0, Sq, hd, tid);
      load_rows<TILE>(Ls, Ds, lse, delta, row_base, q0, Sq, tid);
      __syncthreads();
      float s[R][R], dp[R][R];
      scores<HDP, true>(Qs, dOs, Ks, Vs, tx, ty, s, dp);
      probs<HDP, true>(s, dp, Ls, Ds, Ps, dSs, q0, k0, Sq, Skv, causal,
                       window, q_off, scale, tx, ty);
      __syncthreads();
      // dV += P^T dO and dK += dS^T Q for keys ty + 16 i, columns tx + 16 dj
      for (int r = 0; r < TILE; ++r) {
        float pc[R], sc[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          pc[i] = Ps[r * PLD + ty + 16 * i];
          sc[i] = dSs[r * PLD + ty + 16 * i];
        }
#pragma unroll
        for (int dj = 0; dj < DJ; ++dj) {
          const float od = dOs[r * LD + tx + 16 * dj];
          const float qd = Qs[r * LD + tx + 16 * dj];
#pragma unroll
          for (int i = 0; i < R; ++i) {
            acc_v[i][dj] = fmaf(pc[i], od, acc_v[i][dj]);
            acc_k[i][dj] = fmaf(sc[i], qd, acc_k[i][dj]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int c = k0 + ty + 16 * i;
    if (c >= Skv) continue;
    float* dkr = dk + kv_base + c * kv_stride;
    float* dvr = dv + kv_base + c * kv_stride;
#pragma unroll
    for (int dj = 0; dj < DJ; ++dj) {
      const int d = tx + 16 * dj;
      if (d < hd) {
        dkr[d] = acc_k[i][dj] * scale;
        dvr[d] = acc_v[i][dj];
      }
    }
  }
}

// Pass 3: dQ of one query tile of one query head.
template <int HDP>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int Sq, int Skv, int Hq, int K, int hd,
              int causal, int window, int q_off) {
  constexpr int TILE = Tiling<HDP>::kTile, R = Tiling<HDP>::kR,
                LD = Tiling<HDP>::kLd, PLD = Tiling<HDP>::kPld,
                DJ = Tiling<HDP>::kDj;
  extern __shared__ float smem[];
  float* Qs = smem;              // TILE x LD
  float* dOs = Qs + TILE * LD;   // TILE x LD
  float* Ks = dOs + TILE * LD;   // TILE x LD
  float* Vs = Ks + TILE * LD;    // TILE x LD
  float* dSs = Vs + TILE * LD;   // TILE x PLD
  float* Ls = dSs + TILE * PLD;  // TILE
  float* Ds = Ls + TILE;         // TILE

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (Hq / K);
  const long q_stride = (long)Hq * hd, kv_stride = (long)K * hd;
  const long q_base = ((long)b * Sq * Hq + h) * hd;
  const long kv_base = ((long)b * Skv * K + kh) * hd;
  const float scale = 1.0f / sqrtf((float)hd);

  load_tile<HDP>(Qs, q + q_base, q_stride, q0, Sq, hd, tid);
  load_tile<HDP>(dOs, dout + q_base, q_stride, q0, Sq, hd, tid);
  load_rows<TILE>(Ls, Ds, lse, delta, ((long)b * Hq + h) * Sq, q0, Sq, tid);
  int kv_begin;
  const int kv_end =
      key_range<TILE>(q0, Sq, Skv, causal, window, q_off, &kv_begin);

  float acc[R][DJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int dj = 0; dj < DJ; ++dj) acc[i][dj] = 0.f;

  for (int k0 = kv_begin; k0 < kv_end; k0 += TILE) {
    __syncthreads();  // the previous key tile and dS are consumed
    load_tile<HDP>(Ks, k + kv_base, kv_stride, k0, Skv, hd, tid);
    load_tile<HDP>(Vs, v + kv_base, kv_stride, k0, Skv, hd, tid);
    __syncthreads();
    float s[R][R], dp[R][R];
    scores<HDP, true>(Qs, dOs, Ks, Vs, tx, ty, s, dp);
    probs<HDP, false>(s, dp, Ls, Ds, nullptr, dSs, q0, k0, Sq, Skv, causal,
                      window, q_off, scale, tx, ty);
    __syncthreads();
    // dQ += dS K for rows ty + 16 i, columns tx + 16 dj; keys at or past
    // kv_end have dS = 0 for every row of the tile
    const int n_c = min(TILE, kv_end - k0);
    for (int c = 0; c < n_c; ++c) {
      float sr[R];
#pragma unroll
      for (int i = 0; i < R; ++i) sr[i] = dSs[(ty + 16 * i) * PLD + c];
#pragma unroll
      for (int dj = 0; dj < DJ; ++dj) {
        const float kd = Ks[c * LD + tx + 16 * dj];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][dj] = fmaf(sr[i], kd, acc[i][dj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    float* dqr = dq + q_base + row * q_stride;
#pragma unroll
    for (int dj = 0; dj < DJ; ++dj) {
      const int d = tx + 16 * dj;
      if (d < hd) dqr[d] = acc[i][dj] * scale;
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int HDP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, void* dq, void* dk,
                   void* dv, float* lse, float* delta, int B, int Sq,
                   int Skv, int Hq, int K, int hd, int causal, int window,
                   int q_off, cudaStream_t stream) {
  constexpr int TILE = Tiling<HDP>::kTile, LD = Tiling<HDP>::kLd,
                PLD = Tiling<HDP>::kPld;
  const int smem_lse = (int)sizeof(float) * 2 * TILE * LD;
  const int smem_dkdv =
      (int)sizeof(float) * (4 * TILE * LD + 2 * TILE * PLD + 2 * TILE);
  const int smem_dq =
      (int)sizeof(float) * (4 * TILE * LD + TILE * PLD + 2 * TILE);
  cudaError_t err = allow_smem(bwd_lse_kernel<HDP>, smem_lse);
  if (err == cudaSuccess)
    err = allow_smem(bwd_dkdv_kernel<HDP>, smem_dkdv);
  if (err == cudaSuccess) err = allow_smem(bwd_dq_kernel<HDP>, smem_dq);
  if (err != cudaSuccess) return err;
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* gt = static_cast<const float*>(dout);
  const dim3 q_grid((Sq + TILE - 1) / TILE, Hq, B);
  bwd_lse_kernel<HDP><<<q_grid, kThreads, smem_lse, stream>>>(
      qt, kt, static_cast<const float*>(o), gt, lse, delta, Sq, Skv, Hq, K,
      hd, causal, window, q_off);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 kv_grid((Skv + TILE - 1) / TILE, K, B);
  bwd_dkdv_kernel<HDP><<<kv_grid, kThreads, smem_dkdv, stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), Sq, Skv, Hq, K, hd, causal, window, q_off);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dq_kernel<HDP><<<q_grid, kThreads, smem_dq, stream>>>(
      qt, kt, vt, gt, lse, delta, static_cast<float*>(dq), Sq, Skv, Hq, K,
      hd, causal, window, q_off);
  return cudaGetLastError();
}

cudaError_t dispatch_hd(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, void* dq, void* dk,
                        void* dv, float* lse, float* delta, int B, int Sq,
                        int Skv, int Hq, int K, int hd, int causal,
                        int window, int q_off, cudaStream_t stream) {
  if (hd <= 32)
    return launch<32>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, Sq, Skv,
                      Hq, K, hd, causal, window, q_off, stream);
  if (hd <= 64)
    return launch<64>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, Sq, Skv,
                      Hq, K, hd, causal, window, q_off, stream);
  if (hd <= 128)
    return launch<128>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, Sq, Skv,
                       Hq, K, hd, causal, window, q_off, stream);
  return launch<256>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, Sq, Skv,
                     Hq, K, hd, causal, window, q_off, stream);
}

// ---------------------------------------------------------------------------
// bf16: the products on the tensor cores (mma.sync.m16n8k16, bf16 in, fp32
// accumulators), two launches of 256 threads (8 warps):
//   1. bwd_dq_mma, one block per (64 query rows, query head, batch): D of
//      its rows, then L by an online max and sum over the admitted key
//      tiles (S = Q K^T), then dQ over the same tiles (S and dP again, dS
//      into shared memory as bf16, dQ += dS K); it writes L and D;
//   2. bwd_dkdv_mma, one block per (64 keys, KV head, batch): for every
//      admitted query tile of the G query heads, S^T = K Q^T and dP^T =
//      V dO^T, P^T and dS^T into shared memory as bf16, then dV += P^T dO
//      and dK += dS^T Q.
// A warp computes 16 rows x 32 columns of each 64 x 64 score tile, and
// accumulates 16 rows x half the head dim of its block's gradient. Tiles
// of 64 rows sit in shared memory as bf16 with their 16-byte chunks
// XOR-swizzled by the row (the eight rows of an ldmatrix hit eight bank
// groups), head dims padded with zeros to 64, 128 or 256 (a multiple of 8
// is the contract). P and dS enter the second products rounded once to
// bf16, as FlashAttention-2 feeds them.
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kT = 64;  // query rows = keys of a tile

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// c += a (16x16, row-major) * b (16x8, col-major), bf16 in, fp32 out
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Element offset of (row, 16-byte chunk) in a tile of rows of W bf16.
template <int W>
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * W + ((chunk ^ (row & 7)) << 3);
}

// Rows [row0, row0 + 64) of a (rows, stride) bf16 matrix into a swizzled
// tile of width HDP, zero-filling rows past n_rows and chunks past hd.
template <int HDP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base,
                                          long stride, int row0, int n_rows,
                                          int hd, int tid) {
  constexpr int CH = HDP / 8;
  for (int idx = tid; idx < kT * CH; idx += kThreads) {
    const int r = idx / CH, c = idx - r * CH;
    const int row = row0 + r;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row < n_rows && c * 8 < hd)
      x = *reinterpret_cast<const uint4*>(base + row * stride + c * 8);
    *reinterpret_cast<uint4*>(dst + swz<HDP>(r, c)) = x;
  }
}

// acc (16 rows from ar0 x 32 columns from bc0) = A B^T over the head dim:
// A and B tiles of width HDP, rows of B the columns of the product.
// acc[n][e]: row ar0 + g + 8 (e >> 1), column bc0 + 8 n + 2 t4 + (e & 1).
template <int HDP>
__device__ __forceinline__ void abt(const bf16* A, const bf16* Bm, int ar0,
                                    int bc0, int lane, float (&acc)[4][4]) {
#pragma unroll
  for (int n = 0; n < 4; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int mi = lane >> 3;
#pragma unroll
  for (int ks = 0; ks < HDP / 16; ++ks) {
    uint32_t a[4];
    ldmatrix_x4(a, A + swz<HDP>(ar0 + (lane & 15), 2 * ks + (lane >> 4)));
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint32_t b[4];
      ldmatrix_x4(b, Bm + swz<HDP>(bc0 + 16 * j + (lane & 7) + 8 * (mi >> 1),
                                   2 * ks + (mi & 1)));
      mma16816(acc[2 * j], a, b[0], b[1]);
      mma16816(acc[2 * j + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 rows from ar0 x HDP/2 columns from hc0) += A B over 64: A a
// 64-wide tile (rows ar0..), B a tile of width HDP read transposed.
// acc[n][e]: row ar0 + g + 8 (e >> 1), column hc0 + 8 n + 2 t4 + (e & 1).
template <int HDP>
__device__ __forceinline__ void ab(const bf16* A, const bf16* Bm, int ar0,
                                   int hc0, int lane,
                                   float (&acc)[HDP / 16][4]) {
  const int mi = lane >> 3;
#pragma unroll
  for (int ks = 0; ks < kT / 16; ++ks) {
    uint32_t a[4];
    ldmatrix_x4(a, A + swz<kT>(ar0 + (lane & 15), 2 * ks + (lane >> 4)));
#pragma unroll
    for (int j = 0; j < HDP / 32; ++j) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, Bm + swz<HDP>(16 * ks + (lane & 7) + 8 * (mi & 1),
                                         hc0 / 8 + 2 * j + (mi >> 1)));
      mma16816(acc[2 * j], a, b[0], b[1]);
      mma16816(acc[2 * j + 1], a, b[2], b[3]);
    }
  }
}

// Two fp32 values as a bf16 pair at (row, col) of a 64-wide tile; col even.
__device__ __forceinline__ void store_pair(bf16* tile, int row, int col,
                                           float lo, float hi) {
  *reinterpret_cast<uint32_t*>(tile + swz<kT>(row, col >> 3) + (col & 7)) =
      pack_bf16(lo, hi);
}

// Rows of a gradient from a warp's accumulators: 16 rows from r0 (global
// row index) x HDP/2 columns from hc0, scaled, for rows < n_rows and
// columns < hd.
template <int HDP>
__device__ __forceinline__ void store_rows(bf16* base, long stride, int r0,
                                           int n_rows, int hc0, int hd,
                                           float scale, int lane,
                                           const float (&acc)[HDP / 16][4]) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < HDP / 16; ++n) {
    const int col = hc0 + 8 * n + 2 * t4;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + g + 8 * hh;
      if (row < n_rows && col < hd)
        *reinterpret_cast<uint32_t*>(base + row * stride + col) =
            pack_bf16(acc[n][2 * hh] * scale, acc[n][2 * hh + 1] * scale);
    }
  }
}

template <int HDP>
constexpr int dq_smem_bytes() {
  return 2 * (4 * kT * HDP + kT * kT) + 4 * (2 * kT + 4 * kT);
}
template <int HDP>
constexpr int dkdv_smem_bytes() {
  return 2 * (4 * kT * HDP + 2 * kT * kT) + 4 * 2 * kT;
}

template <int HDP>
__global__ void __launch_bounds__(kThreads)
bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const bf16* __restrict__ o,
           const bf16* __restrict__ dout, float* __restrict__ lse,
           float* __restrict__ delta, bf16* __restrict__ dq, int Sq, int Skv,
           int Hq, int K, int hd, int causal, int window, int q_off) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // kT x HDP each
  bf16* dOs = Qs + kT * HDP;
  bf16* Ks = dOs + kT * HDP;
  bf16* Vs = Ks + kT * HDP;
  bf16* dSs = Vs + kT * HDP;                      // kT x kT
  float* Ls = reinterpret_cast<float*>(dSs + kT * kT);
  float* Ds = Ls + kT;
  float* ml = Ds + kT;                            // (2, kT, 2): max, sum

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (Hq / K);
  const long q_stride = (long)Hq * hd, kv_stride = (long)K * hd;
  const long q_base = ((long)b * Sq * Hq + h) * hd;
  const long kv_base = ((long)b * Skv * K + kh) * hd;
  const long row_base = ((long)b * Hq + h) * Sq;
  const float scale = 1.0f / sqrtf((float)hd);
  // the warp's rows of the score tiles, its key half, its head-dim half
  const int qr0 = 16 * (warp & 3), kc0 = 32 * (warp >> 2),
            hc0 = (HDP / 2) * (warp >> 2);

  load_tile<HDP>(Qs, q + q_base, q_stride, q0, Sq, hd, tid);
  load_tile<HDP>(dOs, dout + q_base, q_stride, q0, Sq, hd, tid);
  // D of the tile's rows, eight rows a warp
  for (int i = 0; i < kT / kWarps; ++i) {
    const int r = warp * (kT / kWarps) + i, row = q0 + r;
    float sum = 0.f;
    if (row < Sq)
      for (int d = lane; d < hd; d += 32)
        sum = fmaf(__bfloat162float(dout[q_base + row * q_stride + d]),
                   __bfloat162float(o[q_base + row * q_stride + d]), sum);
    sum = rt::warp_sum(sum);
    if (lane == 0) {
      Ds[r] = sum;
      if (row < Sq) delta[row_base + row] = sum;
    }
  }
  int kv_begin;
  const int kv_end =
      key_range<kT>(q0, Sq, Skv, causal, window, q_off, &kv_begin);

  // L: an online max and sum of each of the warp's two rows a lane holds
  // (rows qr0 + g and qr0 + g + 8, over the warp's 32 keys of each tile)
  float m[2] = {rt::kNegInf, rt::kNegInf}, l[2] = {0.f, 0.f};
  for (int k0 = kv_begin; k0 < kv_end; k0 += kT) {
    __syncthreads();  // the previous key tile is consumed
    load_tile<HDP>(Ks, k + kv_base, kv_stride, k0, Skv, hd, tid);
    __syncthreads();
    float s[4][4];
    abt<HDP>(Qs, Ks, qr0, kc0, lane, s);
    float mx[2] = {rt::kNegInf, rt::kNegInf};
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = q_off + q0 + qr0 + g + 8 * (e >> 1);
        const int c = k0 + kc0 + 8 * n + 2 * t4 + (e & 1);
        s[n][e] = admitted(c, qpos, Skv, causal, window) ? s[n][e] * scale
                                                         : rt::kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m[hh], mx[hh]);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 4; ++n)
        sum += expf(s[n][2 * hh] - m_new) + expf(s[n][2 * hh + 1] - m_new);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[hh] = l[hh] * expf(m[hh] - m_new) + sum;
      m[hh] = m_new;
    }
  }
  // the two key halves of each row meet in shared memory
  if (t4 == 0)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float* at = ml + ((warp >> 2) * kT + qr0 + g + 8 * hh) * 2;
      at[0] = m[hh];
      at[1] = l[hh];
    }
  __syncthreads();
  if (tid < kT) {
    const float m0 = ml[tid * 2], l0 = ml[tid * 2 + 1];
    const float m1 = ml[(kT + tid) * 2], l1 = ml[(kT + tid) * 2 + 1];
    const float mm = fmaxf(m0, m1);
    Ls[tid] = mm + logf(l0 * expf(m0 - mm) + l1 * expf(m1 - mm));
    if (q0 + tid < Sq) lse[row_base + q0 + tid] = Ls[tid];
  }

  // dQ over the same key tiles
  float acc[HDP / 16][4];
#pragma unroll
  for (int n = 0; n < HDP / 16; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int k0 = kv_begin; k0 < kv_end; k0 += kT) {
    __syncthreads();  // L is in place; the previous tiles and dS consumed
    load_tile<HDP>(Ks, k + kv_base, kv_stride, k0, Skv, hd, tid);
    load_tile<HDP>(Vs, v + kv_base, kv_stride, k0, Skv, hd, tid);
    __syncthreads();
    float s[4][4], dp[4][4];
    abt<HDP>(Qs, Ks, qr0, kc0, lane, s);
    abt<HDP>(dOs, Vs, qr0, kc0, lane, dp);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = qr0 + g + 8 * hh, col = kc0 + 8 * n + 2 * t4;
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = q0 + r < Sq && admitted(k0 + col + e, q_off + q0 + r,
                                                  Skv, causal, window);
          const float p = ok ? expf(s[n][2 * hh + e] * scale - Ls[r]) : 0.f;
          ds[e] = p * (dp[n][2 * hh + e] - Ds[r]);
        }
        store_pair(dSs, r, col, ds[0], ds[1]);
      }
    __syncthreads();
    ab<HDP>(dSs, Ks, qr0, hc0, lane, acc);
  }
  store_rows<HDP>(dq + q_base, q_stride, q0 + qr0, Sq, hc0, hd, scale, lane,
                  acc);
}

template <int HDP>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Skv,
             int Hq, int K, int hd, int causal, int window, int q_off) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // kT x HDP each
  bf16* Vs = Ks + kT * HDP;
  bf16* Qs = Vs + kT * HDP;
  bf16* dOs = Qs + kT * HDP;
  bf16* Ps = dOs + kT * HDP;                      // P^T, kT x kT
  bf16* dSs = Ps + kT * kT;                       // dS^T, kT x kT
  float* Ls = reinterpret_cast<float*>(dSs + kT * kT);
  float* Ds = Ls + kT;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int k0 = blockIdx.x * kT, kh = blockIdx.y, b = blockIdx.z;
  const int G = Hq / K;
  const long q_stride = (long)Hq * hd, kv_stride = (long)K * hd;
  const long kv_base = ((long)b * Skv * K + kh) * hd;
  const float scale = 1.0f / sqrtf((float)hd);
  // the warp's keys of the score tiles, its query half, its head-dim half
  const int kr0 = 16 * (warp & 3), qc0 = 32 * (warp >> 2),
            hc0 = (HDP / 2) * (warp >> 2);

  load_tile<HDP>(Ks, k + kv_base, kv_stride, k0, Skv, hd, tid);
  load_tile<HDP>(Vs, v + kv_base, kv_stride, k0, Skv, hd, tid);
  // the query rows that admit some key of this tile, as the CUDA-core pass
  const int k_hi = min(k0 + kT, Skv) - 1;
  int i_begin = causal ? max(0, k0 - q_off) : 0;
  i_begin -= i_begin % kT;
  const int i_end = window > 0 ? min(Sq, k_hi + window - q_off) : Sq;

  float acc_k[HDP / 16][4], acc_v[HDP / 16][4];
#pragma unroll
  for (int n = 0; n < HDP / 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  for (int hh = 0; hh < G; ++hh) {
    const int h = kh * G + hh;
    const long q_base = ((long)b * Sq * Hq + h) * hd;
    const long row_base = ((long)b * Hq + h) * Sq;
    for (int q0 = i_begin; q0 < i_end; q0 += kT) {
      __syncthreads();  // the previous query tile, P^T and dS^T consumed
      load_tile<HDP>(Qs, q + q_base, q_stride, q0, Sq, hd, tid);
      load_tile<HDP>(dOs, dout + q_base, q_stride, q0, Sq, hd, tid);
      if (tid < kT) {
        const int row = q0 + tid;
        Ls[tid] = row < Sq ? lse[row_base + row] : 0.f;
        Ds[tid] = row < Sq ? delta[row_base + row] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      abt<HDP>(Ks, Qs, kr0, qc0, lane, s);    // S^T
      abt<HDP>(Vs, dOs, kr0, qc0, lane, dp);  // dP^T
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int kr = kr0 + g + 8 * h2, col = qc0 + 8 * n + 2 * t4;
          float p[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qi = q0 + col + e;
            const bool ok = qi < Sq && admitted(k0 + kr, q_off + qi, Skv,
                                                causal, window);
            p[e] = ok ? expf(s[n][2 * h2 + e] * scale - Ls[col + e]) : 0.f;
            ds[e] = p[e] * (dp[n][2 * h2 + e] - Ds[col + e]);
          }
          store_pair(Ps, kr, col, p[0], p[1]);
          store_pair(dSs, kr, col, ds[0], ds[1]);
        }
      __syncthreads();
      ab<HDP>(Ps, dOs, kr0, hc0, lane, acc_v);   // dV += P^T dO
      ab<HDP>(dSs, Qs, kr0, hc0, lane, acc_k);   // dK += dS^T Q
    }
  }
  store_rows<HDP>(dk + kv_base, kv_stride, k0 + kr0, Skv, hc0, hd, scale,
                  lane, acc_k);
  store_rows<HDP>(dv + kv_base, kv_stride, k0 + kr0, Skv, hc0, hd, 1.0f,
                  lane, acc_v);
}

template <int HDP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, void* dq, void* dk,
                   void* dv, float* lse, float* delta, int B, int Sq,
                   int Skv, int Hq, int K, int hd, int causal, int window,
                   int q_off, cudaStream_t stream) {
  constexpr int smem_dq = dq_smem_bytes<HDP>();
  constexpr int smem_dkdv = dkdv_smem_bytes<HDP>();
  cudaError_t err = allow_smem(bwd_dq_mma<HDP>, smem_dq);
  if (err == cudaSuccess) err = allow_smem(bwd_dkdv_mma<HDP>, smem_dkdv);
  if (err != cudaSuccess) return err;
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* gt = static_cast<const bf16*>(dout);
  bwd_dq_mma<HDP><<<dim3((Sq + kT - 1) / kT, Hq, B), kThreads, smem_dq,
                    stream>>>(qt, kt, vt, static_cast<const bf16*>(o), gt,
                              lse, delta, static_cast<bf16*>(dq), Sq, Skv,
                              Hq, K, hd, causal, window, q_off);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dkdv_mma<HDP><<<dim3((Skv + kT - 1) / kT, K, B), kThreads, smem_dkdv,
                      stream>>>(qt, kt, vt, gt, lse, delta,
                                static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                                Sq, Skv, Hq, K, hd, causal, window, q_off);
  return cudaGetLastError();
}

cudaError_t dispatch_hd(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, void* dq, void* dk,
                        void* dv, float* lse, float* delta, int B, int Sq,
                        int Skv, int Hq, int K, int hd, int causal,
                        int window, int q_off, cudaStream_t stream) {
  if (hd <= 64)
    return launch<64>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, Sq, Skv,
                      Hq, K, hd, causal, window, q_off, stream);
  if (hd <= 128)
    return launch<128>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, Sq, Skv,
                       Hq, K, hd, causal, window, q_off, stream);
  return launch<256>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, Sq, Skv,
                     Hq, K, hd, causal, window, q_off, stream);
}

}  // namespace tc

}  // namespace

// C interface (bound with ctypes). q, o, dout and dq are (B, Sq, Hq, hd),
// k, v, dk and dv (B, Skv, K, hd): contiguous device tensors of one dtype,
// 16-byte aligned; fp32 runs the CUDA-core passes (head_dim a multiple of
// 4), bf16 the tensor-core ones (a multiple of 8). lse and delta are fp32
// workspaces of B * Hq * Sq floats each, which the call overwrites. window
// <= 0 means no window. Every query row must admit a key. Returns a
// cudaError_t.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, void* dq, void* dk,
                                   void* dv, void* lse, void* delta, int B,
                                   int Sq, int Skv, int Hq, int K, int hd,
                                   int causal, int window, int q_off,
                                   int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || K <= 0 || Hq % K != 0 || hd <= 0 ||
      hd > 256 || hd % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* d = static_cast<float*>(delta);
  if (dtype == rt::kFloat32)
    return (int)dispatch_hd(q, k, v, o, dout, dq, dk, dv, l, d, B, Sq, Skv,
                            Hq, K, hd, causal, window, q_off, s);
  if (dtype == rt::kBFloat16 && hd % 8 == 0)
    return (int)tc::dispatch_hd(q, k, v, o, dout, dq, dk, dv, l, d, B, Sq,
                                Skv, Hq, K, hd, causal, window, q_off, s);
  return (int)cudaErrorInvalidValue;
}
