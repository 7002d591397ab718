// RG-LRU linear-recurrence scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan/kernel.py::
// rglru_scan_pallas (body _rglru_kernel): per (batch, channel)
//   h_t = exp(log_a_t) * h_{t-1} + x_t,  h_{-1} = h0,
// for log_a, x (B, S, W) fp32 and h0 (B, W) fp32, returning every h_t as
// (B, S, W) fp32. Unlike the TPU kernel it takes any S >= 1 and any W >= 1
// (that kernel asserts S % chunk == 0 and W % bw == 0; engine prompts are
// ragged).
//
// What bounds it on an H100: bytes. Each element is read twice (log_a, x)
// and written once, 12 bytes, for an exp and two flops, far below the
// card's ~20 fp32 flops per byte; the least time is 12 B S W / 3.35 TB/s
// (B=1, S=3000, W=2560: 92 MB, 0.028 ms).
//
// The trap is the dependence along S: one thread walking one channel over
// all of S gives only B * W threads (2560 at the serve's batch of one) for
// 132 SMs, each waiting on S dependent steps. The design keeps the TPU
// kernel's structure (chunks of S, a carry across chunks), but spreads the
// chunks over blocks instead of walking them in order on one core:
//   1. chunk_summary: grid (channel tiles, chunks, batch). Each thread scans
//      its channel over one chunk of kChunk steps from a zero state and
//      writes two numbers: the chunk's summed log decay and its end state;
//   2. chunk_carry: one thread per (batch, channel) walks the chunk
//      summaries in order, carry_{c+1} = exp(sum_c) carry_c + end_c, and
//      writes the state entering each chunk. Its loads do not depend on the
//      carry, so an unrolled loop keeps several in flight;
//   3. chunk_scan: the grid of phase 1 rescans each chunk from its carry
//      and writes every state. Rescanning, rather than adding
//      exp(cumulative log decay) * carry to phase 1's stored states, reads
//      8 bytes per element instead of 12 and is the reference's exact
//      sequential recurrence inside each chunk.
// Neighbouring threads take neighbouring channels, so every load and store
// of a warp is 128 contiguous bytes. Phases 1 and 3 read log_a and x twice:
// 20 bytes per element against the 12 of the bound. Fusing the three phases
// into one pass (a decoupled look-back across chunks) is later work.
#include "common.cuh"

namespace {

constexpr int kChunk = 32;     // steps of S per chunk
constexpr int kThreads = 128;  // channels per block

__global__ void __launch_bounds__(kThreads)
chunk_summary_kernel(const float* __restrict__ log_a,
                     const float* __restrict__ x, float* __restrict__ sum_la,
                     float* __restrict__ h_end, int S, int W, int n_chunks) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  const int c = blockIdx.y, b = blockIdx.z;
  if (w >= W) return;
  const int t0 = c * kChunk, t1 = min(S, t0 + kChunk);
  const float* la = log_a + ((long)b * S + t0) * W + w;
  const float* xb = x + ((long)b * S + t0) * W + w;
  float A = 0.f, h = 0.f;
#pragma unroll 8
  for (int t = 0; t < t1 - t0; ++t) {
    const float l = la[(long)t * W];
    h = fmaf(expf(l), h, xb[(long)t * W]);
    A += l;
  }
  const long o = ((long)b * n_chunks + c) * W + w;
  sum_la[o] = A;
  h_end[o] = h;
}

__global__ void __launch_bounds__(kThreads)
chunk_carry_kernel(const float* __restrict__ sum_la,
                   const float* __restrict__ h_end,
                   const float* __restrict__ h0, float* __restrict__ carry,
                   int W, int n_chunks) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (w >= W) return;
  float h = h0[(long)b * W + w];
  const long base = (long)b * n_chunks * W + w;
#pragma unroll 8
  for (int c = 0; c < n_chunks; ++c) {
    const long o = base + (long)c * W;
    carry[o] = h;
    h = fmaf(expf(sum_la[o]), h, h_end[o]);
  }
}

__global__ void __launch_bounds__(kThreads)
chunk_scan_kernel(const float* __restrict__ log_a, const float* __restrict__ x,
                  const float* __restrict__ carry, float* __restrict__ out,
                  int S, int W, int n_chunks) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  const int c = blockIdx.y, b = blockIdx.z;
  if (w >= W) return;
  const int t0 = c * kChunk, t1 = min(S, t0 + kChunk);
  const long off = ((long)b * S + t0) * W + w;
  const float* la = log_a + off;
  const float* xb = x + off;
  float* o = out + off;
  float h = carry[((long)b * n_chunks + c) * W + w];
#pragma unroll 8
  for (int t = 0; t < t1 - t0; ++t) {
    h = fmaf(expf(la[(long)t * W]), h, xb[(long)t * W]);
    o[(long)t * W] = h;
  }
}

}  // namespace

// Steps of S per chunk; the wrapper sizes the scratch with it.
extern "C" int rglru_scan_chunk() { return kChunk; }

// C interface (bound with ctypes). log_a, x, out (B, S, W) and h0 (B, W):
// contiguous fp32 device memory. scratch holds 3 * B * n_chunks * W floats,
// n_chunks = ceil(S / rglru_scan_chunk()). Returns a cudaError_t.
extern "C" int rglru_scan_fwd(const void* log_a, const void* x,
                              const void* h0, void* out, void* scratch, int B,
                              int S, int W, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const int n_chunks = (S + kChunk - 1) / kChunk;
  const long n_part = (long)B * n_chunks * W;
  float* sum_la = static_cast<float*>(scratch);
  float* h_end = sum_la + n_part;
  float* carry = h_end + n_part;
  const float* la = static_cast<const float*>(log_a);
  const float* xs = static_cast<const float*>(x);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (W + kThreads - 1) / kThreads;
  const dim3 grid(n_tiles, n_chunks, B);
  chunk_summary_kernel<<<grid, kThreads, 0, s>>>(la, xs, sum_la, h_end, S, W,
                                                  n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  chunk_carry_kernel<<<dim3(n_tiles, B), kThreads, 0, s>>>(
      sum_la, h_end, static_cast<const float*>(h0), carry, W, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  chunk_scan_kernel<<<grid, kThreads, 0, s>>>(la, xs, carry,
                                               static_cast<float*>(out), S, W,
                                               n_chunks);
  return (int)cudaGetLastError();
}
