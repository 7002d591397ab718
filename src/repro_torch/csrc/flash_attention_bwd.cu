// Backward of the flash prefill attention, for Hopper (sm_90a).
//
// The gradient of src/repro/kernels/flash_attention/kernel.py::
// flash_attention_pallas, which has no custom_vjp: the JAX model
// differentiates its einsum attention (repro.models.layers.gqa_attention)
// with jax.grad. It takes the forward's whole contract: q (B, Sq, Hq, hd),
// k/v (B, Skv, K, hd), K | Hq (G = Hq / K query heads read one KV head in
// place), any Sq and Skv, causal and/or a sliding window, query positions
// offset by q_off, head_dim up to 256, fp32 or bf16 in and out. Given q, k,
// v, the forward's output o, its row logsumexp L and dO, it returns dq, dk
// and dv in q's dtype; every sum is fp32.
//
// The FlashAttention-2 equations, with S = scale q k^T masked as the
// forward masks it:
//   L_i = logsumexp_j S_ij,  P_ij = exp(S_ij - L_i),  D_i = sum_d dO_id O_id,
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - D),
//   dQ = scale dS K,  dK = scale dS^T Q.
// L is the forward's (both forward kernels write it on request). No
// atomics: each block owns the rows of the gradient it writes, so the
// result is the same on every run. Tiles that the causal diagonal or the
// window wholly exclude are skipped.
//
// What bounds it on an H100: the work. The gradient's own products are
// 10 hd flops per (query, key) pair and query head (S, dP, dV, dK, dQ); as
// dQ and dK/dV are summed in separate launches, S and dP are formed twice,
// 14 hd in all. The bytes (q, k, v, o, dO read, dq, dk, dv written) are
// small beside that at the training shapes.
//
// Two routes, by dtype (neither falls back to the other):
// - fp32 (head_dim a multiple of 4): the products on the CUDA cores in
//   fp32, three launches of 256 threads: bwd_delta_kernel (D, a warp a
//   row), bwd_dkdv_kernel (one block per key tile and KV head, dK and dV
//   summed in registers over the admitted query tiles of all G query heads
//   of its KV head) and bwd_dq_kernel (one block per query tile and head),
//   the last two as 16 x 16 threads. Tiles of 64 query rows and 64 keys (32
//   and 32 at head_dim 256) sit in shared memory as fp32 with rows padded
//   by one float, P and dS with rows padded to a 16-float offset; each
//   thread owns TILE/16 rows x head_dim/16 columns.
// - bf16 (head_dim a multiple of 8): the products on wgmma, fed by TMA; see
//   namespace wg below.
#include "sm90.cuh"

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

// S (unscaled) and dP of the query rows ty + 16 i and keys tx + 16 j of the
// tiles in shared memory.
template <int HDP>
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

// Pass 1: D_i = sum_d dO_id O_id of each query row, laid out (B, Hq, Sq);
// one warp a row. (L comes from the forward.)
__global__ void __launch_bounds__(kThreads)
bwd_delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                 float* __restrict__ delta, int B, int Sq, int Hq, int hd) {
  const int lane = threadIdx.x & 31;
  // the row's index in q's (B, Sq, Hq) order; a warp shares its row
  const long row = (long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (row >= (long)B * Sq * Hq) return;
  float sum = 0.f;
  for (int d = lane; d < hd; d += 32)
    sum = fmaf(dout[row * hd + d], o[row * hd + d], sum);
  sum = rt::warp_sum(sum);
  if (lane == 0) {
    const long bs = row / Hq;
    delta[(bs / Sq * Hq + row % Hq) * Sq + bs % Sq] = sum;
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
      scores<HDP>(Qs, dOs, Ks, Vs, tx, ty, s, dp);
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
    scores<HDP>(Qs, dOs, Ks, Vs, tx, ty, s, dp);
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
                   const void* o, const void* dout, const float* lse,
                   void* dq, void* dk, void* dv, float* delta, int B, int Sq,
                   int Skv, int Hq, int K, int hd, int causal, int window,
                   int q_off, cudaStream_t stream) {
  constexpr int TILE = Tiling<HDP>::kTile, LD = Tiling<HDP>::kLd,
                PLD = Tiling<HDP>::kPld;
  const int smem_dkdv =
      (int)sizeof(float) * (4 * TILE * LD + 2 * TILE * PLD + 2 * TILE);
  const int smem_dq =
      (int)sizeof(float) * (4 * TILE * LD + TILE * PLD + 2 * TILE);
  cudaError_t err = allow_smem(bwd_dkdv_kernel<HDP>, smem_dkdv);
  if (err == cudaSuccess) err = allow_smem(bwd_dq_kernel<HDP>, smem_dq);
  if (err != cudaSuccess) return err;
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* gt = static_cast<const float*>(dout);
  const long rows = (long)B * Sq * Hq;
  bwd_delta_kernel<<<(unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32)),
                     kThreads, 0, stream>>>(static_cast<const float*>(o), gt,
                                            delta, B, Sq, Hq, hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 kv_grid((Skv + TILE - 1) / TILE, K, B);
  const dim3 q_grid((Sq + TILE - 1) / TILE, Hq, B);
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
                        const void* o, const void* dout, const float* lse,
                        void* dq, void* dk, void* dv, float* delta, int B,
                        int Sq, int Skv, int Hq, int K, int hd, int causal,
                        int window, int q_off, cudaStream_t stream) {
  if (hd <= 32)
    return launch<32>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, Sq, Skv,
                      Hq, K, hd, causal, window, q_off, stream);
  if (hd <= 64)
    return launch<64>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, Sq, Skv,
                      Hq, K, hd, causal, window, q_off, stream);
  if (hd <= 128)
    return launch<128>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, Sq, Skv,
                       Hq, K, hd, causal, window, q_off, stream);
  return launch<256>(q, k, v, o, dout, lse, dq, dk, dv, delta, B, Sq, Skv,
                     Hq, K, hd, causal, window, q_off, stream);
}

// ---------------------------------------------------------------------------
// bf16: the products on wgmma (m64nNk16, bf16 in, fp32 accumulators in
// registers), every tile fed by TMA into 128-byte-swizzled 64-column slabs
// (csrc/sm90.cuh, the forward's pieces), no atomics. Two launches, and a
// third where the dK/dV grid is split:
//   1. bwd_dq_sm90, one block per (BQ query rows, query head, batch): BQ /
//      64 consumer warpgroups (128 rows at head_dim <= 128, 64 at 256) and
//      a producer warp. The warpgroups first take D_i = sum dO_i O_i of
//      their rows from device memory (a quad a row pair) and write it for
//      launch 2; L comes from the forward. The producer loads Q and dO once
//      and keeps a 2-stage ring of K and V tiles of 64 keys in flight. For
//      each admitted key tile: S = Q K^T and dP = dO V^T (both operands
//      K-major in shared memory), P = exp2(S log2e / sqrt(hd) - L log2e)
//      and dS = P (dP - D) in the accumulators' registers, then dQ += dS K
//      with dS from registers as bf16 (the accumulator's layout is the A
//      fragment's) and K through the transpose bit.
//   2. bwd_dkdv_sm90, one block per (128 keys, 64 at head_dim 256, KV
//      head, share of the G query heads, batch) on a 1-D grid, key blocks
//      with the most admitted query tiles first, and two consumer
//      warpgroups: up to head_dim 128 each owns 64 of the keys, at 256
//      each owns half of dK's and dV's columns (and forms S^T and dP^T
//      whole). K and V stay in shared memory; Q and dO tiles of 64 rows
//      come through a ring (3 stages, 2 at head_dim 256), with their L and
//      D. For each admitted query tile of each of its heads: S^T = K Q^T
//      and dP^T = V dO^T, P^T and dS^T in registers, dV += P^T dO and dK
//      += dS^T Q with dO and Q through the transpose bit. dK and dV stay in
//      fp32 registers across the whole walk.
//   3. bwd_reduce_sm90, only where (64-key tiles) x K x B is under 2 x 132
//      (kernel.py::plan_bwd decides; RecurrentGemma's one KV head) and the
//      G query heads are split over blocks: the shares of launch 2 wrote
//      fp32 partial dK and dV to a workspace, and this pass sums them in
//      share order and casts to bf16.
// Masking (causal, window, offset, ragged tails) applies to S or S^T in the
// accumulator's layout on tiles that cross an edge: keys at or past Skv and
// query rows at or past Sq get P = 0 (TMA's zero fill gives them S = 0,
// not -inf). P and dS enter the second products rounded once to bf16, as
// FlashAttention-2 feeds them. Work: 14 hd flops per admitted (query, key)
// pair and query head (S and dP twice, dV, dK, dQ), against the 10 hd of
// the gradient's own products; an fp32 atomicAdd into dQ (FlashAttention-3)
// would make it 10 hd, at the price of the bits changing from run to run.
// Registers (ptxas, at head_dim 64 / 128 / 256): dQ 135 / 164 / 233, dK/dV
// 186 / 254 / 232, no spills. The dK/dV kernel has no producer warp: beside
// 256 consumer threads one caps a thread at 168 registers, and dK, dV, S^T
// and dP^T take 192; one consumer warpgroup alone would leave the tensor
// cores idle while it takes its exponentials. setmaxnreg, which would move
// a producer's registers to the consumers, is not used: it hung the card in
// the forward.
// ---------------------------------------------------------------------------

namespace wg {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr int kStages = 2;                 // K/V ring depth of dQ
constexpr int kT = 64;                     // keys of a K/V tile; query rows
                                           // of a Q/dO tile in dK/dV
constexpr int kKS = kT / 16;               // k-steps over a 64-wide tile
constexpr float kLog2e = 1.4426950408889634f;

// A 64 x 64 fp32 accumulator (m64n64 layout) as the bf16 A fragments of the
// four k-steps of a product over its 64 columns.
__device__ __forceinline__ void to_frags(const float (&s)[32],
                                         uint32_t (&a)[kKS][4]) {
#pragma unroll
  for (int kk = 0; kk < kKS; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int base = 4 * (2 * kk + r / 2) + 2 * (r % 2);
      a[kk][r] = pack_bf16(s[base], s[base + 1]);
    }
}

// The sum of the products of eight bf16 pairs (16 bytes each).
__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    sum = fmaf(__uint_as_float(x[i] << 16), __uint_as_float(y[i] << 16), sum);
    sum = fmaf(__uint_as_float(x[i] & 0xffff0000u),
               __uint_as_float(y[i] & 0xffff0000u), sum);
  }
  return sum;
}

// --- launch 1: D and dQ ----------------------------------------------------

template <int HDP, int BQ>
struct DqTile {
  static constexpr int kSlabs = HDP / kSlab;
  static constexpr int kGroups = BQ / 64;              // consumer warpgroups
  static constexpr int kThreads = 128 * kGroups + 32;  // + producer warp
  static constexpr int kQBytes = kSlabs * BQ * kRowBytes;  // Q or dO
  static constexpr int kKVBytes = kSlabs * kT * kRowBytes;  // K or V tile
  static constexpr int kSmem =
      1024 + 2 * kQBytes + 2 * kStages * kKVBytes + 8 * (1 + 2 * kStages);
};

template <int HDP, int BQ>
__global__ void __launch_bounds__(DqTile<HDP, BQ>::kThreads, 1)
bwd_dq_sm90(const __grid_constant__ CUtensorMap tm_q,
            const __grid_constant__ CUtensorMap tm_do,
            const __grid_constant__ CUtensorMap tm_k,
            const __grid_constant__ CUtensorMap tm_v,
            const bf16* __restrict__ o, const bf16* __restrict__ dout,
            const float* __restrict__ lse, float* __restrict__ delta,
            bf16* __restrict__ dq, int Sq, int Skv, int Hq, int K, int hd,
            int causal, int window, int q_off) {
  using T = DqTile<HDP, BQ>;
  constexpr int NS = T::kSlabs;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = smem;
  uint8_t* do_s = q_s + T::kQBytes;
  uint8_t* k_s = do_s + T::kQBytes;
  uint8_t* v_s = k_s + kStages * T::kKVBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s + kStages * T::kKVBytes);
  uint64_t* kv_full = q_full + 1;
  uint64_t* kv_empty = kv_full + kStages;

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // most keys first
  const int kh = h / (Hq / K);
  const int q_lo = q_off + q0;
  const int q_hi = q_off + min(q0 + BQ, Sq) - 1;
  const int kv_end = causal ? min(Skv, q_hi + 1) : Skv;
  int kv_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  kv_begin -= kv_begin % kT;
  const int n_tiles = max(0, (kv_end - kv_begin + kT - 1) / kT);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kv_empty[s], 128 * T::kGroups);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x / 32 == 4 * T::kGroups) {   // the producer warp
    if (threadIdx.x % 32 != 0) return;
    mbar_expect_tx(q_full, 2 * T::kQBytes);
    for (int s = 0; s < NS; ++s) {
      tma_load(q_s + s * BQ * kRowBytes, &tm_q, q_full, s * kSlab, h, q0, b);
      tma_load(do_s + s * BQ * kRowBytes, &tm_do, q_full, s * kSlab, h, q0,
               b);
    }
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % kStages, free = ((it / kStages) & 1) ^ 1;
      const int k0 = kv_begin + it * kT;
      mbar_wait(&kv_empty[st], free);
      mbar_expect_tx(&kv_full[st], 2 * T::kKVBytes);
      for (int s = 0; s < NS; ++s) {
        tma_load(k_s + st * T::kKVBytes + s * kT * kRowBytes, &tm_k,
                 &kv_full[st], s * kSlab, kh, k0, b);
        tma_load(v_s + st * T::kKVBytes + s * kT * kRowBytes, &tm_v,
                 &kv_full[st], s * kSlab, kh, k0, b);
      }
    }
    return;
  }

  const int g = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int r0 = 64 * g + 16 * (tid / 32) + lane / 4;   // rows r0, r0 + 8
  const int cq = 2 * (lane % 4);
  const int qpos[2] = {q_off + q0 + r0, q_off + q0 + r0 + 8};
  const int wq_lo = q_off + q0 + 64 * g, wq_hi = wq_lo + 63;
  const float scale = 1.0f / sqrtf((float)hd);
  const float sl2 = kLog2e / sqrtf((float)hd);

  // D of the thread's two rows (the quad splits each row's columns) and L
  // in base 2; D is written for launch 2
  float L2[2], Dr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    float sum = 0.f;
    if (row < Sq) {
      const long base = (((long)b * Sq + row) * Hq + h) * hd;
      for (int c = 8 * (lane % 4); c < hd; c += 32)
        sum += dot8(*reinterpret_cast<const uint4*>(o + base + c),
                    *reinterpret_cast<const uint4*>(dout + base + c));
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const long at = ((long)b * Hq + h) * Sq + row;
    Dr[i] = sum;
    L2[i] = row < Sq ? lse[at] * kLog2e : 0.f;
    if (row < Sq && cq == 0) delta[at] = sum;
  }

  float acc[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;
  float s[kT / 2], dp[kT / 2];
  uint32_t ds_a[kKS][4];
  const uint32_t q_addr = smem_u32(q_s) + g * 64 * kRowBytes;
  const uint32_t do_addr = smem_u32(do_s) + g * 64 * kRowBytes;

  mbar_wait(q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    const int k0 = kv_begin + it * kT;
    const uint32_t k_addr = smem_u32(k_s) + st * T::kKVBytes;
    const uint32_t v_addr = smem_u32(v_s) + st * T::kKVBytes;
    mbar_wait(&kv_full[st], (it / kStages) & 1);
    wgmma_fence();
#pragma unroll
    for (int sl = 0; sl < NS; ++sl)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Mma<kT>::ss(
            s, desc_sw128(q_addr + sl * BQ * kRowBytes + kk * 32, 16, 1024),
            desc_sw128(k_addr + sl * kT * kRowBytes + kk * 32, 16, 1024),
            (sl | kk) != 0);
#pragma unroll
    for (int sl = 0; sl < NS; ++sl)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Mma<kT>::ss(
            dp, desc_sw128(do_addr + sl * BQ * kRowBytes + kk * 32, 16, 1024),
            desc_sw128(v_addr + sl * kT * kRowBytes + kk * 32, 16, 1024),
            (sl | kk) != 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);
    const bool edge = k0 + kT > Skv || (causal && k0 + kT - 1 > wq_lo) ||
                      (window > 0 && k0 <= wq_hi - window);
#pragma unroll
    for (int j = 0; j < kT / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int idx = 4 * j + 2 * i + c;
          float p = exp2f(s[idx] * sl2 - L2[i]);
          if (edge && !admitted(k0 + 8 * j + cq + c, qpos[i], Skv, causal,
                                window))
            p = 0.f;
          dp[idx] = p * (dp[idx] - Dr[i]);
        }
    to_frags(dp, ds_a);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk)
      Mma<HDP>::rs(acc, ds_a[kk],
                   desc_sw128(k_addr + kk * 16 * kRowBytes, kT * kRowBytes,
                              1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(&kv_empty[st]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    if (row >= Sq) continue;
    bf16* dqrow = dq + (((long)b * Sq + row) * Hq + h) * hd;
#pragma unroll
    for (int j = 0; j < HDP / 8; ++j) {
      const int col = 8 * j + cq;
      if (col < hd)
        *reinterpret_cast<__nv_bfloat162*>(dqrow + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * i] * scale,
                                  acc[4 * j + 2 * i + 1] * scale);
    }
  }
}

// --- launch 2: dK and dV ---------------------------------------------------

// Two consumer warpgroups and no producer warp, so that each thread may
// hold 255 registers (with a 32-thread producer warp beside 256 consumers
// ptxas allows 168, and dK, dV, S^T and dP^T need 192). Up to head_dim 128
// each warpgroup owns 64 of the block's 128 keys (both read every Q and dO
// tile); at 256 the block has 64 keys and each warpgroup owns half of dK's
// and dV's columns, forming S^T and dP^T whole. Warp 0 also loads: at the
// start of walk step it it refills the stage of step it - 1 with step it +
// kStages - 1 (Q and dO by TMA, L and D by cp.async with zero fill past Sq;
// the rows of a head are not 16-byte strided, so not by TMA), once both
// warpgroups are done with it.
template <int HDP>
struct KvTile {
  static constexpr int kSlabs = HDP / kSlab;
  static constexpr bool kKeySplit = HDP <= 128;
  static constexpr int kKeys = kKeySplit ? 128 : 64;   // keys of a block
  static constexpr int kCols = kKeySplit ? HDP : HDP / 2;  // of a warpgroup
  static constexpr int kStages = kKeySplit ? 3 : 2;
  static constexpr int kThreads = 256;
  static constexpr int kTileBytes = kSlabs * kT * kRowBytes;   // Q or dO
  static constexpr int kKVBytes = kSlabs * kKeys * kRowBytes;  // K or V
  // K, V, the ring's Q and dO tiles, then L and D of each stage
  static constexpr int kSmem = 1024 + 2 * kKVBytes +
                               2 * kStages * kTileBytes +
                               kStages * 2 * kT * 4 + 8 * (1 + 2 * kStages);
};

template <int HDP>
__global__ void __launch_bounds__(KvTile<HDP>::kThreads, 1)
bwd_dkdv_sm90(const __grid_constant__ CUtensorMap tm_q,
              const __grid_constant__ CUtensorMap tm_do,
              const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dk, bf16* __restrict__ dv,
              float* __restrict__ part, int B, int Sq, int Skv, int Hq, int K,
              int hd, int causal, int window, int q_off, int shares) {
  using T = KvTile<HDP>;
  constexpr int NS = T::kSlabs, NC = T::kCols, ST = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* k_s = smem;
  uint8_t* v_s = k_s + T::kKVBytes;
  uint8_t* q_s = v_s + T::kKVBytes;                  // ST tiles
  uint8_t* do_s = q_s + ST * T::kTileBytes;          // ST tiles
  float* rows_s = reinterpret_cast<float*>(do_s + ST * T::kTileBytes);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(rows_s + ST * 2 * kT);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + ST;

  // block -> (key block, KV head, share, batch), key blocks slowest: the
  // first keys admit the most query tiles under a causal mask
  const int per_block = K * shares * B;
  const int kb = blockIdx.x / per_block;
  int rest = blockIdx.x - kb * per_block;
  const int kh = rest % K;
  rest /= K;
  const int sh = rest % shares, b = rest / shares;
  const int k0 = kb * T::kKeys;
  const int G = Hq / K;
  const int h_lo = kh * G + sh * G / shares;
  const int h_hi = kh * G + (sh + 1) * G / shares;
  // the query rows that admit some key of this block: causal rows from the
  // block's first key on, windowed rows up to its last key + window - 1
  const int k_hi = min(k0 + T::kKeys, Skv) - 1;
  int i_begin = causal ? max(0, k0 - q_off) : 0;
  i_begin -= i_begin % kT;
  const int i_end = window > 0 ? min(Sq, k_hi + window - q_off) : Sq;
  const int n_qt = i_end > i_begin ? (i_end - i_begin + kT - 1) / kT : 0;
  const int n_iters = (h_hi - h_lo) * n_qt;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 32);   // warp 0's cp.async arrivals, + TMA bytes
      mbar_init(&empty[s], T::kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int g = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const bool loader = threadIdx.x < 32;

  // step j of the walk (query head h_lo + j / n_qt, rows from i_begin +
  // 64 (j % n_qt)) into stage j % ST, once step j - ST has left it
  auto load_step = [&](int j) {
    const int st = j % ST;
    mbar_wait(&empty[st], ((j / ST) & 1) ^ 1);
    const int h = h_lo + j / n_qt, q0 = i_begin + (j % n_qt) * kT;
    const long at = ((long)b * Hq + h) * Sq;
    float* rows = rows_s + st * 2 * kT;
    for (int r = lane; r < kT; r += 32) {
      const bool in = q0 + r < Sq;
      cp_async4(rows + r, lse + at + (in ? q0 + r : 0), in);
      cp_async4(rows + kT + r, delta + at + (in ? q0 + r : 0), in);
    }
    if (lane == 0) {
      mbar_add_tx(&full[st], 2 * T::kTileBytes);
      for (int s = 0; s < NS; ++s) {
        tma_load(q_s + st * T::kTileBytes + s * kT * kRowBytes, &tm_q,
                 &full[st], s * kSlab, h, q0, b);
        tma_load(do_s + st * T::kTileBytes + s * kT * kRowBytes, &tm_do,
                 &full[st], s * kSlab, h, q0, b);
      }
    }
    cp_async_arrive(&full[st]);
  };
  if (loader) {
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * T::kKVBytes);
      for (int s = 0; s < NS; ++s) {
        tma_load(k_s + s * T::kKeys * kRowBytes, &tm_k, kv_full, s * kSlab,
                 kh, k0, b);
        tma_load(v_s + s * T::kKeys * kRowBytes, &tm_v, kv_full, s * kSlab,
                 kh, k0, b);
      }
    }
    for (int j = 0; j < min(ST - 1, n_iters); ++j) load_step(j);
  }

  // this warpgroup's keys (rows r0 and r0 + 8 of its 64) and columns
  const int kw0 = k0 + (T::kKeySplit ? 64 * g : 0);
  const int r0 = 16 * (tid / 32) + lane / 4;
  const int cq = 2 * (lane % 4);
  const int key[2] = {kw0 + r0, kw0 + r0 + 8};
  const int c0 = T::kKeySplit ? 0 : g * NC;
  const float sl2 = kLog2e / sqrtf((float)hd);

  float acc_k[NC / 2], acc_v[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  float s[kT / 2], dp[kT / 2];
  uint32_t p_a[kKS][4], ds_a[kKS][4];
  const uint32_t k_addr = smem_u32(k_s) + (kw0 - k0) * kRowBytes;
  const uint32_t v_addr = smem_u32(v_s) + (kw0 - k0) * kRowBytes;
  // this warpgroup's first slab of dK's and dV's columns (of Q and dO)
  const uint32_t col0 = c0 / kSlab * kT * kRowBytes;

  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_iters; ++it) {
    if (loader && it + ST - 1 < n_iters) load_step(it + ST - 1);
    const int st = it % ST;
    const int q0 = i_begin + (it % n_qt) * kT;
    mbar_wait(&full[st], (it / ST) & 1);
    // a warpgroup whose keys no row of the tile admits skips it
    const bool skip =
        kw0 >= Skv || (causal && kw0 > q_off + min(q0 + kT, Sq) - 1) ||
        (window > 0 && kw0 + kT - 1 <= q_off + q0 - window);
    if (!skip) {
      const uint32_t q_addr = smem_u32(q_s) + st * T::kTileBytes;
      const uint32_t do_addr = smem_u32(do_s) + st * T::kTileBytes;
      wgmma_fence();
#pragma unroll
      for (int sl = 0; sl < NS; ++sl)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Mma<kT>::ss(s,
                      desc_sw128(k_addr + sl * T::kKeys * kRowBytes + kk * 32,
                                 16, 1024),
                      desc_sw128(q_addr + sl * kT * kRowBytes + kk * 32, 16,
                                 1024),
                      (sl | kk) != 0);
#pragma unroll
      for (int sl = 0; sl < NS; ++sl)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          Mma<kT>::ss(dp,
                      desc_sw128(v_addr + sl * T::kKeys * kRowBytes + kk * 32,
                                 16, 1024),
                      desc_sw128(do_addr + sl * kT * kRowBytes + kk * 32, 16,
                                 1024),
                      (sl | kk) != 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);
      // P^T and dS^T: rows are keys, columns query rows q0 + 8 j + cq + c
      const float* rows = rows_s + st * 2 * kT;
      const bool edge = kw0 + kT > Skv || q0 + kT > Sq ||
                        (causal && kw0 + kT - 1 > q_off + q0) ||
                        (window > 0 && kw0 <= q_off + q0 + kT - 1 - window);
#pragma unroll
      for (int j = 0; j < kT / 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(rows + 8 * j + cq);
        const float2 dd =
            *reinterpret_cast<const float2*>(rows + kT + 8 * j + cq);
        const float nl2[2] = {-l.x * kLog2e, -l.y * kLog2e};
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int idx = 4 * j + 2 * i + c;
            const int qi = q0 + 8 * j + cq + c;
            float p = exp2f(fmaf(s[idx], sl2, nl2[c]));
            if (edge && !(qi < Sq && admitted(key[i], q_off + qi, Skv,
                                              causal, window)))
              p = 0.f;
            s[idx] = p;
            dp[idx] = p * (dp[idx] - (c ? dd.y : dd.x));
          }
      }
      to_frags(s, p_a);
      to_frags(dp, ds_a);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk)
        Mma<NC>::rs(acc_v, p_a[kk],
                    desc_sw128(do_addr + col0 + kk * 16 * kRowBytes,
                               kT * kRowBytes, 1024));
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk)
        Mma<NC>::rs(acc_k, ds_a[kk],
                    desc_sw128(q_addr + col0 + kk * 16 * kRowBytes,
                               kT * kRowBytes, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc_v);
      fence_regs(acc_k);
    }
    mbar_arrive(&empty[st]);
  }

  // dK = scale dS^T Q and dV as bf16, or this share's fp32 partial sums
  const float scale = 1.0f / sqrtf((float)hd);
  const long n = (long)B * Skv * K * hd;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= Skv) continue;
    const long at = (((long)b * Skv + key[i]) * K + kh) * hd;
#pragma unroll
    for (int j = 0; j < NC / 8; ++j) {
      const int col = c0 + 8 * j + cq;
      if (col >= hd) continue;
      const int e = 4 * j + 2 * i;
      if (part == nullptr) {
        *reinterpret_cast<__nv_bfloat162*>(dk + at + col) =
            __floats2bfloat162_rn(acc_k[e] * scale, acc_k[e + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + at + col) =
            __floats2bfloat162_rn(acc_v[e], acc_v[e + 1]);
      } else {
        float* pk = part + 2 * sh * n + at + col;
        *reinterpret_cast<float2*>(pk) = make_float2(acc_k[e], acc_k[e + 1]);
        *reinterpret_cast<float2*>(pk + n) =
            make_float2(acc_v[e], acc_v[e + 1]);
      }
    }
  }
}

// --- launch 3: the shares' sum ---------------------------------------------

// dK = scale sum_s dK_s and dV = sum_s dV_s over the shares' fp32 partials
// (laid out [share][dK, dV][B, Skv, K, hd]), in share order, four elements a
// thread.
__global__ void __launch_bounds__(256)
bwd_reduce_sm90(const float* __restrict__ part, bf16* __restrict__ dk,
                bf16* __restrict__ dv, long n, int shares, float scale) {
  const long i = 4 * ((long)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= n) return;
  float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
  for (int s = 0; s < shares; ++s) {
    const float4 a = rt::load4(part + 2 * s * n + i);
    const float4 c = rt::load4(part + (2 * s + 1) * n + i);
    sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
    sv.x += c.x; sv.y += c.y; sv.z += c.z; sv.w += c.w;
  }
  __nv_bfloat162* k2 = reinterpret_cast<__nv_bfloat162*>(dk + i);
  __nv_bfloat162* v2 = reinterpret_cast<__nv_bfloat162*>(dv + i);
  k2[0] = __floats2bfloat162_rn(sk.x * scale, sk.y * scale);
  k2[1] = __floats2bfloat162_rn(sk.z * scale, sk.w * scale);
  v2[0] = __floats2bfloat162_rn(sv.x, sv.y);
  v2[1] = __floats2bfloat162_rn(sv.z, sv.w);
}

template <int HDP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   void* dq, void* dk, void* dv, float* delta, float* part,
                   int B, int Sq, int Skv, int Hq, int K, int hd, int causal,
                   int window, int q_off, int shares, cudaStream_t stream) {
  constexpr int BQ = HDP > 128 ? 64 : 128;
  using DQ = DqTile<HDP, BQ>;
  using KV = KvTile<HDP>;
  CUtensorMap tq, tdo, tk, tv, tq64, tdo64, tkb, tvb;
  if (!make_map(&tq, q, B, Sq, Hq, hd, BQ) ||
      !make_map(&tdo, dout, B, Sq, Hq, hd, BQ) ||
      !make_map(&tq64, q, B, Sq, Hq, hd, kT) ||
      !make_map(&tdo64, dout, B, Sq, Hq, hd, kT) ||
      !make_map(&tk, k, B, Skv, K, hd, kT) ||
      !make_map(&tv, v, B, Skv, K, hd, kT) ||
      !make_map(&tkb, k, B, Skv, K, hd, KV::kKeys) ||
      !make_map(&tvb, v, B, Skv, K, hd, KV::kKeys))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(bwd_dq_sm90<HDP, BQ>, DQ::kSmem);
  if (err == cudaSuccess) err = allow_smem(bwd_dkdv_sm90<HDP>, KV::kSmem);
  if (err != cudaSuccess) return err;
  bwd_dq_sm90<HDP, BQ><<<dim3(Hq, (Sq + BQ - 1) / BQ, B), DQ::kThreads,
                         DQ::kSmem, stream>>>(
      tq, tdo, tk, tv, static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), Sq,
      Skv, Hq, K, hd, causal, window, q_off);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_kb = (Skv + KV::kKeys - 1) / KV::kKeys;
  bwd_dkdv_sm90<HDP><<<n_kb * K * shares * B, KV::kThreads, KV::kSmem,
                       stream>>>(
      tq64, tdo64, tkb, tvb, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), shares > 1 ? part : nullptr, B, Sq, Skv, Hq, K,
      hd, causal, window, q_off, shares);
  err = cudaGetLastError();
  if (err != cudaSuccess || shares == 1) return err;
  const long n = (long)B * Skv * K * hd;
  bwd_reduce_sm90<<<(unsigned)((n / 4 + 255) / 256), 256, 0, stream>>>(
      part, static_cast<bf16*>(dk), static_cast<bf16*>(dv), n, shares,
      1.0f / sqrtf((float)hd));
  return cudaGetLastError();
}

cudaError_t dispatch_hd(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const float* lse,
                        void* dq, void* dk, void* dv, float* delta,
                        float* part, int B, int Sq, int Skv, int Hq, int K,
                        int hd, int causal, int window, int q_off, int shares,
                        cudaStream_t stream) {
  if (hd <= 64)
    return launch<64>(q, k, v, o, dout, lse, dq, dk, dv, delta, part, B, Sq,
                      Skv, Hq, K, hd, causal, window, q_off, shares, stream);
  if (hd <= 128)
    return launch<128>(q, k, v, o, dout, lse, dq, dk, dv, delta, part, B, Sq,
                       Skv, Hq, K, hd, causal, window, q_off, shares, stream);
  return launch<256>(q, k, v, o, dout, lse, dq, dk, dv, delta, part, B, Sq,
                     Skv, Hq, K, hd, causal, window, q_off, shares, stream);
}

}  // namespace wg

}  // namespace

// C interface (bound with ctypes). q, o, dout and dq are (B, Sq, Hq, hd),
// k, v, dk and dv (B, Skv, K, hd): contiguous device tensors of one dtype,
// 16-byte aligned; fp32 runs the CUDA-core passes (head_dim a multiple of
// 4), bf16 the wgmma ones (a multiple of 8). lse is the forward's (B, Hq,
// Sq) fp32 logsumexp of each row (required); delta an fp32 workspace of B *
// Hq * Sq floats, which the call overwrites. bf16 splits each KV head's G
// query heads over `shares` blocks (1 <= shares <= G; kernel.py::plan_bwd
// chooses), and with shares > 1 needs `part`, an fp32 workspace of shares *
// 2 * B * Skv * K * hd floats; fp32 takes shares = 1. window <= 0 means no
// window. Every query row must admit a key. Returns a cudaError_t.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* dq, void* dk, void* dv, void* delta,
                                   void* part, int B, int Sq, int Skv, int Hq,
                                   int K, int hd, int causal, int window,
                                   int q_off, int shares, int dtype,
                                   void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || K <= 0 || Hq % K != 0 || hd <= 0 ||
      hd > 256 || hd % 4 != 0 || lse == nullptr || shares < 1 ||
      shares > Hq / K || (shares > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  if (dtype == rt::kFloat32 && shares == 1)
    return (int)dispatch_hd(q, k, v, o, dout, l, dq, dk, dv, d, B, Sq, Skv,
                            Hq, K, hd, causal, window, q_off, s);
  if (dtype == rt::kBFloat16 && hd % 8 == 0)
    return (int)wg::dispatch_hd(q, k, v, o, dout, l, dq, dk, dv, d,
                                static_cast<float*>(part), B, Sq, Skv, Hq, K,
                                hd, causal, window, q_off, shares, s);
  return (int)cudaErrorInvalidValue;
}
