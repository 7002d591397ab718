// Split-KV decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py::
// decode_attention_pallas (body _dec_kernel) and implements the whole
// contract of repro.models.layers.decode_attention, which that kernel did
// not: q (B, 1, Hq, hd), caches (B, Sc, K, hd), a per-slot position vector
// pos (B,) (a scalar position is expanded by the wrapper), and the rotating
// sliding-window cache, whose slot j holds absolute position
// pos - ((pos - j) mod Sc) (floor modulo, as jnp.mod). Both modes take the
// same launch: see the first point below.
// fp32 or bf16 in and out; scores, softmax and accumulation are fp32.
//
// What bounds it on an H100: bytes. One query token per (slot, head) does
// 4 * G * hd flops per cached key against 2 * hd elements read, far below
// the card's ~295 flops per byte, so the time is the cache rows read over
// 3.35 TB/s. The design reads only what the reference's mask admits and
// reads each row once:
//   * a slot attends to rows [0, min(pos + 1, Sc)) in both modes. In the
//     rotating map, for pos >= 0, a row j <= min(pos, Sc - 1) has
//     (pos - j) mod Sc <= pos, so kpos >= 0, and, when pos < Sc, a row
//     j > pos has kpos = j - Sc < 0. So the kernel needs no modulo and no
//     mode flag.
//     Reads are clamped to that range, so an idle slot whose position ran
//     past the cache reads Sc rows and never out of bounds;
//   * the G query heads that share a KV head are the rows of one block, so
//     each K and V row is loaded once for all G heads (the GQA reuse the
//     TPU kernel got from its matmul rows);
//   * the TPU kernel walked the KV blocks in order on one core; here the
//     cache is cut into splits of 128 rows that run as separate blocks
//     (grid: split x KV head x slot) to fill the card at batch 8. Each split
//     writes a partial (max, sum, weighted V) to fp32 scratch, a split wholly
//     past a slot's position writes an empty partial and reads nothing, and
//     a second kernel combines the partials: the second reduction the TPU
//     kernel's docstring says the GPU form needs.
#include "common.cuh"

namespace {

constexpr int kSplit = 128;  // cache rows per split = threads per block
constexpr int kWarps = kSplit / 32;

// part_ml holds (max, sum) and part_acc the unnormalised weighted V of each
// (slot, KV head, split, query head of the group).
template <typename T, int G>
__global__ void __launch_bounds__(kSplit)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                      const T* __restrict__ vc, const int* __restrict__ pos,
                      float* __restrict__ part_acc,
                      float* __restrict__ part_ml, int Sc, int K, int hd,
                      int n_split) {
  extern __shared__ float smem[];
  float* qs = smem;           // G x hd
  float* ps = smem + G * hd;  // G x kSplit scores, then probabilities

  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int p = pos[b];
  const int n_valid = min(p + 1, Sc);
  const int j0 = split * kSplit;
  const long part = ((long)b * K + kh) * n_split + split;
  float* ml = part_ml + part * 2 * G;
  if (j0 >= n_valid) {  // wholly past this slot's position
    if (tid < G) {
      ml[2 * tid] = rt::kNegInf;
      ml[2 * tid + 1] = 0.f;
    }
    return;
  }
  const int nt = min(kSplit, n_valid - j0);

  const T* qh = q + ((long)b * K * G + (long)kh * G) * hd;
  for (int i = tid * 4; i < G * hd; i += kSplit * 4) {
    const float4 x = rt::load4(qh + i);
    qs[i] = x.x;
    qs[i + 1] = x.y;
    qs[i + 2] = x.z;
    qs[i + 3] = x.w;
  }
  __syncthreads();

  // one cache row per thread, scored against all G heads
  const int j = j0 + tid;
  const bool ok = tid < nt;
  float s[G];
#pragma unroll
  for (int g = 0; g < G; ++g) s[g] = 0.f;
  if (ok) {
    const T* krow = kc + (((long)b * Sc + j) * K + kh) * hd;
    for (int d = 0; d < hd; d += 4) {
      const float4 x = rt::load4(krow + d);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float* qg = qs + g * hd + d;
        s[g] = fmaf(qg[0], x.x, s[g]);
        s[g] = fmaf(qg[1], x.y, s[g]);
        s[g] = fmaf(qg[2], x.z, s[g]);
        s[g] = fmaf(qg[3], x.w, s[g]);
      }
    }
  }
  const float scale = 1.0f / sqrtf((float)hd);
#pragma unroll
  for (int g = 0; g < G; ++g) ps[g * kSplit + tid] = ok ? s[g] * scale : rt::kNegInf;
  __syncthreads();

  // split-local max and sum of each head, one warp per head
  const int warp = tid >> 5, lane = tid & 31;
  for (int g = warp; g < G; g += kWarps) {
    float* row = ps + g * kSplit;
    float mx = rt::kNegInf;
    for (int t = lane; t < kSplit; t += 32) mx = fmaxf(mx, row[t]);
    mx = rt::warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < kSplit; t += 32) {
      const float e = expf(row[t] - mx);
      row[t] = e;
      sum += e;
    }
    sum = rt::warp_sum(sum);
    if (lane == 0) {
      ml[2 * g] = mx;
      ml[2 * g + 1] = sum;
    }
  }
  __syncthreads();

  // weighted V: thread d walks the split's rows down column d
  float* acc = part_acc + part * G * hd;
  const long v_stride = (long)K * hd;
  for (int d = tid; d < hd; d += kSplit) {
    float a[G];
#pragma unroll
    for (int g = 0; g < G; ++g) a[g] = 0.f;
    const T* vcol = vc + (((long)b * Sc + j0) * K + kh) * hd + d;
    for (int t = 0; t < nt; ++t) {
      const float vv = rt::to_float(vcol[t * v_stride]);
#pragma unroll
      for (int g = 0; g < G; ++g) a[g] = fmaf(ps[g * kSplit + t], vv, a[g]);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g * hd + d] = a[g];
  }
}

// One block per (query head, slot): rescale each split's partial to the
// global max and normalise by the global sum.
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_acc,
                                      const float* __restrict__ part_ml,
                                      T* __restrict__ out, int K, int G,
                                      int hd, int n_split) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int kh = h / G, g = h - kh * G;
  const long base = ((long)b * K + kh) * n_split;
  float M = rt::kNegInf;
  for (int s = 0; s < n_split; ++s)
    M = fmaxf(M, part_ml[(base + s) * 2 * G + 2 * g]);
  float L = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float l_s = part_ml[(base + s) * 2 * G + 2 * g + 1];
    if (l_s > 0.f) L += expf(part_ml[(base + s) * 2 * G + 2 * g] - M) * l_s;
  }
  // L == 0 only if no row is admissible (pos < 0), which the engine never
  // produces; the output is then 0
  const float inv = L > 0.f ? 1.0f / L : 0.f;
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float o = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float* ml = part_ml + (base + s) * 2 * G + 2 * g;
      if (ml[1] > 0.f)  // empty partials are never read
        o += expf(ml[0] - M) * part_acc[((base + s) * G + g) * hd + d];
    }
    out[((long)b * K * G + h) * hd + d] = rt::from_float<T>(o * inv);
  }
}

template <typename T, int G>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const int* pos, void* out, float* part_acc,
                   float* part_ml, int B, int K, int Sc, int hd,
                   cudaStream_t stream) {
  const int n_split = (Sc + kSplit - 1) / kSplit;
  const int smem = (int)sizeof(float) * (G * hd + G * kSplit);
  decode_partial_kernel<T, G><<<dim3(n_split, K, B), kSplit, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), pos, part_acc, part_ml, Sc, K, hd, n_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T><<<dim3(K * G, B), 128, 0, stream>>>(
      part_acc, part_ml, static_cast<T*>(out), K, G, hd, n_split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_g(const void* q, const void* kc, const void* vc,
                       const int* pos, void* out, float* part_acc,
                       float* part_ml, int B, int G, int K, int Sc, int hd,
                       cudaStream_t s) {
  switch (G) {
    case 1:
      return launch<T, 1>(q, kc, vc, pos, out, part_acc, part_ml, B, K, Sc, hd, s);
    case 2:
      return launch<T, 2>(q, kc, vc, pos, out, part_acc, part_ml, B, K, Sc, hd, s);
    case 4:
      return launch<T, 4>(q, kc, vc, pos, out, part_acc, part_ml, B, K, Sc, hd, s);
    case 8:
      return launch<T, 8>(q, kc, vc, pos, out, part_acc, part_ml, B, K, Sc, hd, s);
    case 10:  // recurrentgemma-2b: 10 query heads over one KV head
      return launch<T, 10>(q, kc, vc, pos, out, part_acc, part_ml, B, K, Sc, hd, s);
    case 16:
      return launch<T, 16>(q, kc, vc, pos, out, part_acc, part_ml, B, K, Sc, hd, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Rows of the cache per split; the wrapper sizes the scratch with it.
extern "C" int decode_attention_split_rows() { return kSplit; }

// C interface (bound with ctypes). q (B,1,Hq,hd), caches (B,Sc,K,hd), out
// like q, pos (B,) int32, all contiguous device memory, 16-byte aligned;
// part_acc holds B*K*n_split*G*hd floats and part_ml B*K*n_split*G*2, with
// n_split = ceil(Sc / decode_attention_split_rows()). Returns a cudaError_t.
extern "C" int decode_attention_fwd(const void* q, const void* kc,
                                    const void* vc, const void* pos,
                                    void* out, void* part_acc, void* part_ml,
                                    int B, int Hq, int K, int Sc, int hd,
                                    int dtype, void* stream) {
  if (B <= 0 || Sc <= 0 || K <= 0 || Hq % K != 0 || hd <= 0 || hd > 256 ||
      hd % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const int G = Hq / K;
  const int* p = static_cast<const int*>(pos);
  float* acc = static_cast<float*>(part_acc);
  float* ml = static_cast<float*>(part_ml);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kFloat32)
    return (int)dispatch_g<float>(q, kc, vc, p, out, acc, ml, B, G, K, Sc, hd,
                                  s);
  if (dtype == rt::kBFloat16)
    return (int)dispatch_g<__nv_bfloat16>(q, kc, vc, p, out, acc, ml, B, G, K,
                                          Sc, hd, s);
  return (int)cudaErrorInvalidValue;
}
