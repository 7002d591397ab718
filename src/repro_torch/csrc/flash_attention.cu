// Flash prefill attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// flash_attention_pallas (body _fa_kernel) and implements the whole contract
// of repro.models.layers.gqa_attention, which that kernel did not:
//   q (B, Sq, Hq, hd), k/v (B, Skv, K, hd), K | Hq, any Sq and Skv (ragged
//   tails are masked, no tile-multiple requirement), causal and/or a sliding
//   window, query positions offset by q_pos_offset. Query head h reads KV
//   head h / (Hq / K) in place: GQA is never expanded in memory.
// fp32 in and out (bf16 runs flash_attention_sm90.cu); scores, softmax and
// accumulation are fp32. On request it writes each row's logsumexp L for
// the backward.
//
// What bounds it on an H100: at prompt lengths of a few hundred tokens and
// up, the work. Per (query, key) pair it does 4*hd flops and it reads each
// q/k/v element once per tile pair, so the byte count is small next to the
// flops. This first version runs the two products on the CUDA cores in fp32
// (peak 67 TFLOP/s), not on the tensor cores (989 TFLOP/s in bf16), so it
// sits far above the bound the bf16 path could reach; wgmma with TMA-fed
// shared-memory tiles is the later step.
//
// Design: one block of 256 threads per (64-query tile, query head, batch).
// The TPU kernel's sequential KV grid axis becomes a loop inside the block;
// the running row max, row sum and the 64 x hd output accumulator live in
// fp32 registers (each thread owns 4 rows x hd/16 columns), the Q, K, V and
// probability tiles in shared memory (rows padded by one float so the
// column walks of Q K^T are free of bank conflicts). KV tiles wholly above
// the causal diagonal or wholly left of the window are never loaded.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16 threads

// Copy rows [row0, row0 + 64) of a (rows, stride) matrix into shared memory
// as fp32 with leading dimension ld, zero-filling rows past n_rows and
// columns past hd (zeros keep the padded products and the padded V rows
// finite).
template <typename T, int HDP>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* base,
                                          long stride, int row0, int n_rows,
                                          int hd, int tid) {
  constexpr int C4 = HDP / 4;
  for (int idx = tid; idx < 64 * C4; idx += kThreads) {
    const int r = idx / C4;
    const int c = (idx - r * C4) * 4;
    const int row = row0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < n_rows && c < hd) x = rt::load4(base + row * stride + c);
    float* o = dst + r * ld + c;
    o[0] = x.x;
    o[1] = x.y;
    o[2] = x.z;
    o[3] = x.w;
  }
}

template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Skv, int Hq, int K,
                 int hd, int causal, int window, int q_off) {
  constexpr int LDQ = HDP + 1;
  constexpr int DJ = HDP / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;              // kBQ x LDQ
  float* Ks = Qs + kBQ * LDQ;    // kBK x LDQ
  float* Vs = Ks + kBK * LDQ;    // kBK x HDP
  float* Ps = Vs + kBK * HDP;    // kBQ x kBK

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (Hq / K);
  const long q_stride = (long)Hq * hd, kv_stride = (long)K * hd;
  const T* qb = q + ((long)b * Sq * Hq + h) * hd;
  const T* kb = k + ((long)b * Skv * K + kh) * hd;
  const T* vb = v + ((long)b * Skv * K + kh) * hd;
  const float scale = 1.0f / sqrtf((float)hd);

  load_tile<T, HDP>(Qs, LDQ, qb, q_stride, q0, Sq, hd, tid);

  // key range any row of this tile can see: tiles outside it are skipped
  const int q_lo = q_off + q0;
  const int q_hi = q_off + min(q0 + kBQ, Sq) - 1;
  const int kv_end = causal ? min(Skv, q_hi + 1) : Skv;
  int kv_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  kv_begin -= kv_begin % kBK;

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = rt::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int dj = 0; dj < DJ; ++dj) acc[i][dj] = 0.f;
  }

  for (int k0 = kv_begin; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_tile<T, HDP>(Ks, LDQ, kb, kv_stride, k0, Skv, hd, tid);
    load_tile<T, HDP>(Vs, HDP, vb, kv_stride, k0, Skv, hd, tid);
    __syncthreads();

    // S = Q K^T for rows ty + 16 i and keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HDP; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * LDQ + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = Ks[(tx + 16 * j) * LDQ + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

    // mask, then the online softmax update of each row; the 16 threads that
    // share a row are one half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q_lo + r;
      float mx = rt::kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        const bool ok = c < Skv && (!causal || c <= qpos) &&
                        (window <= 0 || c > qpos - window);
        s[i][j] = ok ? s[i][j] * scale : rt::kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = rt::half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[r * kBK + tx + 16 * j] = p;
        psum += p;
      }
      psum = rt::half_warp_sum(psum);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int dj = 0; dj < DJ; ++dj) acc[i][dj] *= alpha;
    }
    __syncthreads();

    // O += P V; keys at or past kv_end are masked for every row of the tile
    const int n_c = min(kBK, kv_end - k0);
    for (int c = 0; c < n_c; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * kBK + c];
#pragma unroll
      for (int dj = 0; dj < DJ; ++dj) {
        const float vv = Vs[c * HDP + tx + 16 * dj];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][dj] = fmaf(p[i], vv, acc[i][dj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    // the row's logsumexp, for the backward (the 16 threads of the row
    // share m and l)
    if (lse != nullptr && tx == 0)
      lse[((long)b * Hq + h) * Sq + row] = m[i] + logf(l[i]);
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
    T* o = out + ((long)b * Sq + row) * q_stride + (long)h * hd;
#pragma unroll
    for (int dj = 0; dj < DJ; ++dj) {
      const int d = tx + 16 * dj;
      if (d < hd) o[d] = rt::from_float<T>(acc[i][dj] * inv);
    }
  }
}

template <typename T, int HDP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int Sq, int Skv, int Hq, int K, int hd,
                   int causal, int window, int q_off, cudaStream_t stream) {
  constexpr int LDQ = HDP + 1;
  const int smem = (int)sizeof(float) *
                   (kBQ * LDQ + kBK * LDQ + kBK * HDP + kBQ * kBK);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_fwd_kernel<T, HDP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, Sq, Skv, Hq, K,
      hd, causal, window, q_off);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* out,
                        float* lse, int B, int Sq, int Skv, int Hq, int K,
                        int hd, int causal, int window, int q_off,
                        cudaStream_t stream) {
  if (hd <= 32)
    return launch<T, 32>(q, k, v, out, lse, B, Sq, Skv, Hq, K, hd,
                         causal, window, q_off, stream);
  if (hd <= 64)
    return launch<T, 64>(q, k, v, out, lse, B, Sq, Skv, Hq, K, hd,
                         causal, window, q_off, stream);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, out, lse, B, Sq, Skv, Hq, K, hd,
                          causal, window, q_off, stream);
  return launch<T, 256>(q, k, v, out, lse, B, Sq, Skv, Hq, K, hd,
                        causal, window, q_off, stream);
}

}  // namespace

// C interface (bound with ctypes). Pointers are contiguous fp32 device
// tensors, 16-byte aligned (bf16 runs flash_attention_sm90.cu); window <= 0
// means no window. lse, when not null, is a (B, Hq, Sq) buffer that
// receives each row's logsumexp of its masked, scaled scores, which the
// backward reads. Returns a cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, void* lse, int B,
                                   int Sq, int Skv, int Hq, int K, int hd,
                                   int causal, int window, int q_off,
                                   int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || K <= 0 || Hq % K != 0 || hd <= 0 ||
      hd > 256 || hd % 4 != 0 || dtype != rt::kFloat32)
    return (int)cudaErrorInvalidValue;
  return (int)dispatch_hd<float>(q, k, v, out, static_cast<float*>(lse), B,
                                 Sq, Skv, Hq, K, hd, causal, window, q_off,
                                 static_cast<cudaStream_t>(stream));
}
