// Split-KV decode attention in bf16 on Hopper's tensor cores (sm_90a), in
// one launch.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py::
// decode_attention_pallas (body _dec_kernel) for bf16 operands, with the
// contract of decode_attention.cu (which keeps the fp32 route):
//   q (B, 1, Hq, hd), caches (B, Sc, K, hd), per-slot positions pos (B,)
//   int32 on the device; 1 <= Hq / K = G <= 16; hd a multiple of 8 up to
//   256. A slot attends to rows [0, min(pos + 1, Sc)), which is the
//   reference's mask for a flat cache and for a rotating window cache alike
//   (see decode_attention.cu). An idle slot whose pos ran past the cache
//   reads Sc rows and never out of bounds; pos < 0 admits no row and gives
//   0. Query head h reads KV head h / G in place. Scores, softmax and
//   accumulation are fp32; the output is bf16. On request the launch also
//   writes each head's log-sum-exp (fp32, natural log of the sum of
//   exp(score / sqrt(hd)) over the admitted rows, -inf with none), which
//   flash-decoding across ranks combines (models/layers.py::
//   dist_decode_attention).
//
// What bounds it on an H100: bytes. One query token per head does 4 * G * hd
// flops per cached row against 4 * hd bytes read, far below the ~295 flops
// a byte at which the tensor cores would set the pace, so the least time is
// the admitted rows over 3.35 TB/s. What the design does about it:
//   - One launch, sized to the card. The grid is split x KV head x slot; the
//     host picks the number of splits from B, K, Sc and the card (its SMs,
//     and the blocks an SM holds) alone
//     (kernels/decode_attention/kernel.py::plan_splits), never from pos,
//     which it does not read. Each block derives its own rows on the device:
//     n_valid = min(pos + 1, Sc) cut evenly over the splits (in whole tiles
//     of the four warps), so a long slot's rows spread over all its splits.
//   - Four warps a block, each its own flash-decoding loop over tiles of 16
//     cache rows (tiles w, w + 4, ... of the block's range). Each warp keeps
//     a 3-stage ring of K and V tiles in shared memory, filled by cp.async
//     16-byte copies (neighbouring lanes on neighbouring 16 bytes of one
//     row; rows and columns out of range are zero-filled, so a padded V
//     column or row never meets a NaN); the next two tiles' copies are in
//     flight while the current one is computed. The ring needs no block
//     barrier.
//   - Products on the tensor cores with mma.sync.m16n8k16 (bf16 in, fp32
//     accumulators): the G query heads of the KV head are the 16 rows of
//     the A tile (padded with zeros); Q's A fragments stay in registers for
//     the whole block. S = Q K^T reads K through ldmatrix, O += P V reads V
//     through ldmatrix.trans. Rows are stored with their 16-byte chunks
//     XOR-swizzled by the row, so the eight row addresses of an ldmatrix
//     hit eight different bank groups.
//   - P is split into bf16(P) and bf16(P - bf16(P)), two P V products, so
//     the weights keep ~16 bits as the fp32 reference's do (bf16(P) alone
//     loses the elementwise limit at rows with few keys, as in
//     flash_attention_sm90.cu).
//   - The combine runs in the same launch. The four warps' (max, sum,
//     weighted V) meet in shared memory, and each block with rows writes
//     one fp32 partial. With more than one split the grid is launched
//     cooperatively and meets at a grid barrier, so every block of it must
//     be resident at once (the wrapper's split count keeps it within the
//     card); then each block combines its 1/n_split slice of its (slot, KV
//     head)'s output over the live splits, so the combine's reads are
//     spread over all the blocks.
#include <cooperative_groups.h>

#include "sm90.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;     // cache rows per warp tile (one k-step of P V)
constexpr int kStages = 3;    // ring depth of each warp
constexpr int kMaxSplit = 64;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

using sm90::cp_async_commit;
using sm90::cp_async_wait;
using sm90::cp_async16_zfill;
using sm90::pack_bf16;
using sm90::smem_u32;

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
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

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}

// Element offset of (row, 16-byte chunk) in a tile of rows of HDP bf16.
template <int HDP>
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * HDP + ((chunk ^ (row & 7)) << 3);
}

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* kc;
  const __nv_bfloat16* vc;
  const int* pos;
  __nv_bfloat16* out;
  float* part_acc;  // (B*K, n_split, G, hd)
  float* part_ml;   // (B*K, n_split, G, 2): max (log2 units) and sum
  float* lse;       // (B, Hq) log-sum-exp in natural units, or null
  int Sc, K, G, hd, n_split;
};

// One split's rows [r0, r1) of (slot b, KV head kh), r0 < r1: the four
// warps' flash-decoding loops, then their (max, sum, weighted V) combined in
// shared memory into one fp32 partial in part_acc / part_ml.
template <int HDP>
__device__ __forceinline__ void split_partial(const Params& p,
                                              unsigned char* smem_raw, int b,
                                              int kh, int split, int r0,
                                              int r1) {
  constexpr int kChunks = HDP / 8;          // 16-byte chunks a row
  constexpr int kKSteps = HDP / 16;         // k-steps of Q K^T
  constexpr int kNB = HDP / 8;              // n-blocks of P V
  constexpr int kTile = kRows * HDP;        // elements of one K (or V) tile
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __shared__ float warp_m[kWarps][16], warp_l[kWarps][16];
  __shared__ float row_m[16], row_l[16];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int G = p.G, hd = p.hd, K = p.K, n_split = p.n_split;
  const int n_tiles = (r1 - r0 + kRows - 1) / kRows;
  const int my_tiles = warp < n_tiles ? (n_tiles - 1 - warp) / kWarps + 1 : 0;

  __nv_bfloat16* kring = ring + warp * kStages * 2 * kTile;
  const long row_stride = (long)K * hd;
  const __nv_bfloat16* kbase = p.kc + ((long)b * p.Sc * K + kh) * hd;
  const __nv_bfloat16* vbase = p.vc + ((long)b * p.Sc * K + kh) * hd;
  auto load_tile = [&](int i) {  // the warp's i-th tile into stage i % kStages
    const int row0 = r0 + (warp + i * kWarps) * kRows;
    __nv_bfloat16* ks = kring + (i % kStages) * 2 * kTile;
    __nv_bfloat16* vs = ks + kTile;
#pragma unroll
    for (int e = lane; e < kRows * kChunks; e += 32) {
      const int r = e / kChunks, c = e % kChunks;
      const bool ok = row0 + r < r1 && c * 8 < hd;
      const long off = ok ? (row0 + r) * row_stride + c * 8 : 0;
      cp_async16_zfill(smem_u32(ks + swz<HDP>(r, c)), kbase + off,
                       ok ? 16 : 0);
      cp_async16_zfill(smem_u32(vs + swz<HDP>(r, c)), vbase + off,
                       ok ? 16 : 0);
    }
  };
  // Q's G rows (zero-padded to 16) into their own tile after the rings,
  // in flight with the first K and V tiles
  __nv_bfloat16* qs = ring + kWarps * kStages * 2 * kTile;
  const __nv_bfloat16* qh = p.q + ((long)b * K * G + (long)kh * G) * hd;
  for (int e = tid; e < kRows * kChunks; e += kThreads) {
    const int r = e / kChunks, c = e % kChunks;
    const bool ok = r < G && c * 8 < hd;
    cp_async16_zfill(smem_u32(qs + swz<HDP>(r, c)),
                     qh + (ok ? r * hd + c * 8 : 0), ok ? 16 : 0);
  }
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < my_tiles) load_tile(i);
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();  // Q's group, the oldest, has landed
  __syncthreads();
  // Q's A fragments for every k-step, kept in registers: lane supplies row
  // (lane & 15) of chunk 2k + (lane >> 4)
  uint32_t qa[kKSteps][4];
#pragma unroll
  for (int k = 0; k < kKSteps; ++k)
    ldmatrix_x4(qa[k],
                smem_u32(qs + swz<HDP>(lane & 15, 2 * k + (lane >> 4))));

  float o[kNB][4];
#pragma unroll
  for (int n = 0; n < kNB; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {rt::kNegInf, rt::kNegInf}, l[2] = {0.f, 0.f};
  const float scale = kLog2e / sqrtf((float)hd);  // softmax in base 2

  for (int i = 0; i < my_tiles; ++i) {
    if (i + kStages - 1 < my_tiles) load_tile(i + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const __nv_bfloat16* ks = kring + (i % kStages) * 2 * kTile;
    const __nv_bfloat16* vs = ks + kTile;
    const int row0 = r0 + (warp + i * kWarps) * kRows;

    // S = Q K^T: two n-blocks of 8 rows; lane supplies row (lane & 7) of
    // matrix lane >> 3: (rows 0-7 | 8-15) x (chunk 2ks | 2ks + 1)
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    {
      const int mi = lane >> 3, r = (lane & 7) + 8 * (mi >> 1);
#pragma unroll
      for (int k = 0; k < kKSteps; ++k) {
        uint32_t kb[4];
        ldmatrix_x4(kb, smem_u32(ks + swz<HDP>(r, 2 * k + (mi & 1))));
        mma16816(s[0], qa[k], kb[0], kb[1]);
        mma16816(s[1], qa[k], kb[2], kb[3]);
      }
    }
    // online softmax; a row lives in the 4 lanes of a quad
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = row0 + n * 8 + 2 * t4 + (e & 1) < r1;
        s[n][e] = ok ? s[n][e] * scale : rt::kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      alpha[h] = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int n = 0; n < kNB; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    uint32_t ph[4], pl[4];  // P's A fragment, bf16 hi and lo halves
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float e0 = exp2f(s[n][2 * h] - m[h]);
        const float e1 = exp2f(s[n][2 * h + 1] - m[h]);
        l[h] += e0 + e1;
        const uint32_t hi = pack_bf16(e0, e1);
        const float2 hv = unpack_bf16(hi);
        ph[2 * n + h] = hi;
        pl[2 * n + h] = pack_bf16(e0 - hv.x, e1 - hv.y);
      }
    }
    // O += P V: lane supplies row (lane & 7) + 8 (mi & 1) of chunk
    // 2 j + (mi >> 1), read transposed, for n-blocks 2 j and 2 j + 1
    {
      const int mi = lane >> 3, r = (lane & 7) + 8 * (mi & 1);
#pragma unroll
      for (int j = 0; j < kNB / 2; ++j) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, smem_u32(vs + swz<HDP>(r, 2 * j + (mi >> 1))));
        mma16816(o[2 * j], ph, vb[0], vb[1]);
        mma16816(o[2 * j], pl, vb[0], vb[1]);
        mma16816(o[2 * j + 1], ph, vb[2], vb[3]);
        mma16816(o[2 * j + 1], pl, vb[2], vb[3]);
      }
    }
    __syncwarp();  // every lane is done with this stage before its refill
  }
  cp_async_wait<0>();

  // the four warps' partials meet in shared memory (the ring is free now)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  __syncthreads();
  float* obuf = reinterpret_cast<float*>(smem_raw);  // (warp, G, hd)
  if (t4 == 0) {
    warp_m[warp][g] = m[0];
    warp_m[warp][g + 8] = m[1];
    warp_l[warp][g] = l[0];
    warp_l[warp][g + 8] = l[1];
  }
#pragma unroll
  for (int n = 0; n < kNB; ++n) {
    const int col = n * 8 + 2 * t4;
    if (col < hd) {
      if (g < G)
        *reinterpret_cast<float2*>(obuf + (warp * G + g) * hd + col) =
            make_float2(o[n][0], o[n][1]);
      if (g + 8 < G)
        *reinterpret_cast<float2*>(obuf + (warp * G + g + 8) * hd + col) =
            make_float2(o[n][2], o[n][3]);
    }
  }
  __syncthreads();
  if (tid < G) {
    float M = rt::kNegInf, L = 0.f;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, warp_m[w][tid]);
    for (int w = 0; w < kWarps; ++w)
      L += exp2f(warp_m[w][tid] - M) * warp_l[w][tid];
    row_m[tid] = M;
    row_l[tid] = L;
  }
  __syncthreads();
  const long bk = (long)b * K + kh;
  const long part = bk * n_split + split;
  float* acc = p.part_acc + part * G * hd;
  for (int e = tid * 4; e < G * hd; e += kThreads * 4) {
    const int row = e / hd;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(warp_m[w][row] - row_m[row]);
      const float4 x = *reinterpret_cast<const float4*>(obuf + w * G * hd + e);
      sum.x += f * x.x;
      sum.y += f * x.y;
      sum.z += f * x.z;
      sum.w += f * x.w;
    }
    *reinterpret_cast<float4*>(acc + e) = sum;
  }
  if (tid < G) {
    p.part_ml[(part * G + tid) * 2] = row_m[tid];
    p.part_ml[(part * G + tid) * 2 + 1] = row_l[tid];
  }
}

// HDP: hd padded to 64, 128 or 256 (the shared-memory row; the swizzle
// needs eight chunks a row).
template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
decode_sm90_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ float wgt[kMaxSplit * 16], row_inv[16];
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int G = p.G, hd = p.hd, n_split = p.n_split;
  const int pos = p.pos[b];
  const int n_valid = pos < 0 ? 0 : min(pos + 1, p.Sc);
  // rows a split: n_valid cut evenly, rounded up to whole tiles of the four
  // warps, so each warp of a full split gets the same number of tiles
  constexpr int kStep = kRows * kWarps;
  const int chunk = ((n_valid + n_split - 1) / n_split + kStep - 1) / kStep *
                    kStep;
  const int r0 = min(split * chunk, n_valid);
  const int r1 = min(r0 + chunk, n_valid);
  // a split with no rows writes nothing: the combine reads only the first
  // n_live splits, those that start below n_valid
  if (r0 < r1) split_partial<HDP>(p, smem_raw, b, kh, split, r0, r1);

  // every partial of the grid is written; then each block combines its
  // slice of its (slot, KV head)'s output over the live splits
  __threadfence();
  if (n_split > 1)
    cooperative_groups::this_grid().sync();
  else
    __syncthreads();
  const long bk = (long)b * p.K + kh;
  const int n_live = chunk > 0 ? (n_valid + chunk - 1) / chunk : 0;
  const int per = G * hd;                     // floats of one partial
  const float* ml = p.part_ml + bk * n_split * G * 2;
  if (tid < G) {
    float M = rt::kNegInf, L = 0.f;
    for (int s = 0; s < n_live; ++s)
      M = fmaxf(M, __ldcg(ml + (s * G + tid) * 2));
    for (int s = 0; s < n_live; ++s) {
      const float w = exp2f(__ldcg(ml + (s * G + tid) * 2) - M);
      wgt[s * G + tid] = w;
      L += w * __ldcg(ml + (s * G + tid) * 2 + 1);
    }
    // L == 0 only if no row is admitted (pos < 0): the output is then 0
    row_inv[tid] = L > 0.f ? 1.f / L : 0.f;
    // the log-sum-exp of the scaled scores, in natural units (M is in log2
    // units), -inf with no row; the first split's block writes it
    if (p.lse != nullptr && split == 0)
      p.lse[bk * G + tid] = L > 0.f ? M * kLn2 + logf(L) : -INFINITY;
  }
  __syncthreads();
  const int n4 = per / 4;                     // float4s of the output
  const int slice = (n4 + n_split - 1) / n_split;
  const float* accs = p.part_acc + bk * n_split * per;
  __nv_bfloat16* out = p.out + (bk * G) * hd;  // heads kh*G.. of slot b
  for (int f = split * slice + tid; f < min((split + 1) * slice, n4);
       f += kThreads) {
    const int row = 4 * f / hd;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int s = 0; s < n_live; ++s) {  // loads of 8 splits in flight
      const float w = wgt[s * G + row];
      const float4 x =
          __ldcg(reinterpret_cast<const float4*>(accs + (long)s * per) + f);
      sum.x += w * x.x;
      sum.y += w * x.y;
      sum.z += w * x.z;
      sum.w += w * x.w;
    }
    const float inv = row_inv[row];
    uint2 packed;
    packed.x = pack_bf16(sum.x * inv, sum.y * inv);
    packed.y = pack_bf16(sum.z * inv, sum.w * inv);
    reinterpret_cast<uint2*>(out)[f] = packed;
  }
}

template <int HDP>
constexpr int smem_bytes() {  // the K/V rings and Q's tile
  return (kWarps * kStages * 2 + 1) * kRows * HDP * 2;
}

// Allows the kernel its dynamic shared memory on the current device. The
// attribute holds for the device's context, so this is done once a device.
template <int HDP>
cudaError_t allow_smem() {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(decode_sm90_kernel<HDP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes<HDP>());
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <int HDP>
cudaError_t blocks_per_sm(int* per_sm) {
  cudaError_t err = allow_smem<HDP>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, decode_sm90_kernel<HDP>, kThreads, smem_bytes<HDP>());
}

template <int HDP>
cudaError_t launch(Params prm, int B, cudaStream_t stream) {
  cudaError_t err = allow_smem<HDP>();
  if (err != cudaSuccess) return err;
  const dim3 grid(prm.n_split, prm.K, B);
  if (prm.n_split == 1)  // no grid barrier: each block combines its own
    decode_sm90_kernel<HDP><<<grid, kThreads, smem_bytes<HDP>(), stream>>>(prm);
  else {  // every block resident at once, or the launch is refused
    void* args[] = {&prm};
    err = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(decode_sm90_kernel<HDP>), grid,
        dim3(kThreads), args, smem_bytes<HDP>(), stream);
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Blocks of the kernel for head_dim hd that an SM holds at once (the
// wrapper keeps a grid of more than one split within the card's total).
// Returns a cudaError_t.
extern "C" int decode_attention_blocks_per_sm_sm90(int hd, int* per_sm) {
  if (hd <= 0 || hd > 256) return (int)cudaErrorInvalidValue;
  if (hd <= 64) return (int)blocks_per_sm<64>(per_sm);
  if (hd <= 128) return (int)blocks_per_sm<128>(per_sm);
  return (int)blocks_per_sm<256>(per_sm);
}

// C interface (bound with ctypes). q (B,1,Hq,hd), caches (B,Sc,K,hd), out
// like q, all bf16; pos (B,) int32; all contiguous device memory, 16-byte
// aligned. part_acc holds B*K*n_split*G*hd floats, part_ml B*K*n_split*G*2;
// lse, if not null, B*Hq floats for each head's log-sum-exp.
// 1 <= n_split <= 64; with more than one split every block of the grid must
// fit on the card at once (decode_attention_blocks_per_sm_sm90), or the
// cooperative launch is refused. Returns a cudaError_t.
extern "C" int decode_attention_fwd_sm90(const void* q, const void* kc,
                                         const void* vc, const void* pos,
                                         void* out, void* part_acc,
                                         void* part_ml, void* lse, int B,
                                         int Hq, int K,
                                         int Sc, int hd, int n_split,
                                         void* stream) {
  if (B <= 0 || Sc <= 0 || K <= 0 || Hq % K != 0 || Hq / K > 16 ||
      hd <= 0 || hd > 256 || hd % 8 != 0 || n_split < 1 ||
      n_split > kMaxSplit)
    return (int)cudaErrorInvalidValue;
  Params prm{static_cast<const __nv_bfloat16*>(q),
             static_cast<const __nv_bfloat16*>(kc),
             static_cast<const __nv_bfloat16*>(vc),
             static_cast<const int*>(pos),
             static_cast<__nv_bfloat16*>(out),
             static_cast<float*>(part_acc),
             static_cast<float*>(part_ml),
             static_cast<float*>(lse),
             Sc, K, Hq / K, hd, n_split};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= 64) return (int)launch<64>(prm, B, s);
  if (hd <= 128) return (int)launch<128>(prm, B, s);
  return (int)launch<256>(prm, B, s);
}
