// RG-LRU linear-recurrence scan for Hopper (sm_90a): one launch, a
// single-pass chunked scan with decoupled look-back across chunks (Merrill
// and Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back",
// NVIDIA 2016), applied to the affine pair (A, e) of each chunk.
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan/kernel.py::
// rglru_scan_pallas (body _rglru_kernel): per (batch, channel)
//   h_t = exp(log_a_t) * h_{t-1} + x_t,  h_{-1} = h0,
// for log_a, x (B, S, W) fp32 and h0 (B, W) fp32, returning every h_t as
// (B, S, W) fp32. Unlike the TPU kernel it takes any S >= 1 and any W >= 1
// (that kernel asserts S % chunk == 0 and W % bw == 0; engine prompts are
// ragged).
//
// What bounds it on an H100: bytes. log_a and x are read once and every h_t
// written once, 12 bytes an element, for an exp and two flops, far below
// the card's ~20 fp32 flops per byte; the least time is 12 B S W / 3.35
// TB/s (B=1, S=3000, W=2560: 92 MB, 0.0275 ms).
//
// The trap is the dependence along S: one thread walking one channel over
// all of S gives only B * W threads (2560 at the serve's batch of one) for
// 132 SMs. So S is cut into chunks of kChunk steps, and the work into
// tickets, one per (batch row, chunk, tile of kTile channels); a block
// takes one channel a thread, so every load and store of a warp is 128
// contiguous bytes. The grid is the blocks the card holds at once (at
// most one per ticket), and each block walks tickets until they run out:
//   1. it takes a ticket from a counter (atomicAdd), and its chunk from the
//      ticket, not from blockIdx: a block takes its tickets in increasing
//      order and works on them in that order, so the smallest ticket not
//      yet done is always being worked on, and it waits only on smaller
//      ones, all done: the look-back cannot deadlock, whatever the grid's
//      size against the card's resident blocks. The block that takes the
//      counter's last value sets it back to 0 for the next call;
//   2. it loads the chunk of log_a and x once into registers and scans it
//      from a zero state into the chunk's aggregate: A = sum of log_a, e =
//      the end state, so that state_after = exp(A) * state_before + e;
//   3. it publishes the aggregate, takes its next ticket and starts that
//      chunk's loads (into a second set of registers, in flight while it
//      waits), then looks back over the records of the chunks before this
//      one, for the same channels, kWindow records at a time: it composes
//      aggregates, (A1, e1) then (A2, e2) = (A1 + A2, exp(A2) e1 + e2),
//      until it meets an inclusive prefix (the state at that chunk's end),
//      which gives the state entering its own chunk. Chunk 0 starts from
//      h0 and publishes no aggregate;
//   4. it rescans the chunk from that state out of registers, step by step
//      with fmaf(expf(log_a), h, x) as the reference's sequential
//      recurrence, writes every h_t once, and publishes the last one as
//      the chunk's inclusive prefix.
// What this design does about the three-phase kernel it replaces (chunk
// summaries, a carry pass, a rescan): one launch instead of three, so a
// short prompt (S=206: a 0.0019 ms bound) pays one launch; 12 bytes an
// element instead of 20, as each element is read once; no carry pass on
// B * W / 128 blocks (20 at the serve's shape) walking every chunk in
// order; and a workspace of 16 bytes per (chunk, channel) instead of
// three B * n_chunks * W float arrays written and read in full.
//
// Records that cannot be half-read. A record is two 64-bit words, each a
// float in its low half and a 32-bit tag in its high half: word 0 holds A,
// word 1 holds e, later overwritten by the inclusive prefix. The tag is
// epoch << 1 | inclusive, where the epoch is a per-call counter the caller
// passes (1 .. 2^31 - 1), so records left by an earlier call never carry
// this call's tag and need no reset launch. A 64-bit access is
// single-copy atomic, so a word's float always comes with its own tag;
// each word carries what its reader needs, so no fence orders the two: a
// reader takes word 1 if it is inclusive, else both words if both are
// this call's aggregate, else reads the record again. Records are read
// with ld.volatile (from L2, never a stale L1 line). A look-back that reads
// kMaxIdle rounds (seconds) without news traps, a launch error, rather than
// hang the card. Where a look-back stops depends on timing, so two calls on
// the same inputs may differ in the last bits of the states they carry
// across chunks (by rounding, far inside the 1e-4 the tests hold).
//
// Workspace (rglru_scan_workspace_floats counts it): 16 bytes of header,
// the ticket counter in its first 4 (the rest unused), then the records,
// B * n_chunks * W of 16 bytes, indexed ((b * n_chunks + chunk) * W + w).
// It must be zero (or hold only records of earlier calls and a zero
// counter) before its first use; every call that runs to its end leaves
// it so.
//
// Sizing: 128 channels and 32 steps a ticket give 20 x 7 = 140 tickets at
// B=1 S=206 W=2560 (more than the 132 SMs) and 1,880 at S=3000. Two chunks
// in registers take 168 a thread, so three blocks fit on an SM (396 on the
// card); each block works on ~5 tickets at S=3000.
//
// The backward (rglru_scan_bwd) is the same design run from the sequence's
// end, in one launch. It replaces jax.grad of the scan
// (src/repro/models/rglru.py:114): given log_a, y (the forward's h), dy
// (B, S, W) and h0 (B, W), with a_t = exp(log_a_t) and the states'
// gradient g_t = dy_t + a_{t+1} g_{t+1} (g_{S-1} = dy_{S-1}), it writes
//   dx_t = g_t,  d log_a_t = g_t a_t h_{t-1} (h_{-1} = h0),  dh0 = a_0 g_0.
// It scans u_t = a_t g_t, the gradient that step t passes to step t - 1:
//   g_t = dy_t + u_{t+1},  u_t = a_t g_t  (u_S = 0),
// so d log_a_t = u_t h_{t-1} and dh0 = u_0, and a chunk needs the decays of
// its own steps only (the recurrence in g needs one step of the next
// chunk's). Ticket k takes chunk n_chunks - 1 - (k / n_tiles % n_chunks):
// a chunk waits only on chunks of higher index, which hold smaller tickets,
// so the argument above holds. A chunk's aggregate is (A = sum of its
// log_a, e = its u_{t0} from u = 0), u_{t0} = exp(A) u_{t0+n} + e, composed
// as the forward's; the last chunk starts from u = 0 and publishes no
// aggregate, and a chunk's inclusive prefix is its u_{t0}. The rescan
// writes dx and d log_a, and chunk 0 writes dh0.
//
// What bounds the backward: bytes again. log_a, dy and y are read once and
// d log_a and dx written once, 20 bytes an element (B=1, S=4096, W=2560:
// 210 MB, 0.0626 ms at 3.35 TB/s). A chunk of three inputs is 96 floats a
// thread; two in registers would not fit three blocks an SM, so the next
// chunk is staged in shared memory by cp.async (48 KB a block: three
// blocks take 144 KB of an SM's 228) while the current one, in registers,
// goes through its look-back and rescan. Each thread copies and reads only
// its own channel's column, so a wait on its own copies is all the
// synchronisation the staging needs.
#include "common.cuh"
#include "tf32.cuh"

namespace {

constexpr int kChunk = 32;    // steps of S a ticket
constexpr int kTile = 128;    // channels per block, one per thread
constexpr int kWindow = 2;    // predecessor records read at once
constexpr int kMinBlocks = 3; // resident blocks an SM, for the registers
constexpr unsigned kMaxIdle = 1u << 22;  // look-back rounds before a trap
constexpr long long kHeaderFloats = 4;   // the ticket counter, padded
constexpr long long kRecordFloats = 4;   // two tagged 64-bit words

__device__ __forceinline__ unsigned long long pack(float v, unsigned tag) {
  return (static_cast<unsigned long long>(tag) << 32) | __float_as_uint(v);
}
__device__ __forceinline__ unsigned tag_of(unsigned long long w) {
  return static_cast<unsigned>(w >> 32);
}
__device__ __forceinline__ float value_of(unsigned long long w) {
  return __uint_as_float(static_cast<unsigned>(w));
}

__device__ __forceinline__ ulonglong2 load_record(const ulonglong2* p) {
  ulonglong2 r;
  asm volatile("ld.volatile.global.v2.u64 {%0, %1}, [%2];"
               : "=l"(r.x), "=l"(r.y) : "l"(p) : "memory");
  return r;
}
__device__ __forceinline__ void store_aggregate(ulonglong2* p, float A,
                                                float e, unsigned tag) {
  asm volatile("st.volatile.global.v2.u64 [%0], {%1, %2};"
               :: "l"(p), "l"(pack(A, tag)), "l"(pack(e, tag)) : "memory");
}
__device__ __forceinline__ void store_inclusive(ulonglong2* p, float h,
                                                unsigned tag) {
  asm volatile("st.volatile.global.u64 [%0], %1;"
               :: "l"(&p->y), "l"(pack(h, tag)) : "memory");
}

// Where a ticket's chunk lies: batch row b, chunk c, this thread's channel
// w, the chunk's steps n and the offset of its first element.
struct Place {
  int b, c, w, n;
  long long off;
};

// The backward (kReverse) takes the chunks from the sequence's end.
template <bool kReverse>
__device__ __forceinline__ Place place_of(unsigned t, int S, int W,
                                          int n_chunks, int n_tiles) {
  Place p;
  const int tile = static_cast<int>(t % n_tiles);
  p.c = static_cast<int>((t / n_tiles) % n_chunks);
  if (kReverse) p.c = n_chunks - 1 - p.c;
  p.b = static_cast<int>(t / ((unsigned)n_tiles * n_chunks));
  p.w = tile * kTile + threadIdx.x;
  const int t0 = p.c * kChunk;
  p.n = min(kChunk, S - t0);
  p.off = ((long long)p.b * S + t0) * W + p.w;
  return p;
}

// The next ticket, the same for every thread of the block. The block that
// takes the counter's last value for this call (each block takes one
// ticket past the chunks, its way out) sets it back to 0 for the next call.
__device__ __forceinline__ unsigned take_ticket(unsigned* ticket,
                                                unsigned last,
                                                unsigned* shared) {
  __syncthreads();   // every thread has read the previous ticket
  if (threadIdx.x == 0) {
    const unsigned t = atomicAdd(ticket, 1u);
    if (t == last) atomicExch(ticket, 0u);
    *shared = t;
  }
  __syncthreads();
  return *shared;
}

// A chunk of log_a and x into registers; steps past S decay by exp(0) = 1
// and add 0.
__device__ __forceinline__ void load_chunk(const float* __restrict__ log_a,
                                           const float* __restrict__ x,
                                           const Place& p, int W,
                                           float (&a)[kChunk],
                                           float (&xs)[kChunk]) {
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    a[i] = i < p.n ? log_a[p.off + (long long)i * W] : 0.f;
    xs[i] = i < p.n ? x[p.off + (long long)i * W] : 0.f;
  }
}

// The state entering chunk c of this thread's channel (c > 0; in the
// backward, c < n_chunks - 1): the aggregates of the chunks before it in
// the scan's direction composed, nearest first, onto the first inclusive
// prefix met.
template <bool kReverse>
__device__ __forceinline__ float look_back(const ulonglong2* mine, int c,
                                           int n_chunks, int W,
                                           unsigned aggregate,
                                           unsigned inclusive) {
  float As = 0.f, es = 0.f;   // the chunks between j and c composed
  float h = 0.f;
  int j = kReverse ? c + 1 : c - 1;
  bool found = false;
  unsigned idle = 0;   // rounds that found nothing new
  while (!found) {
    ulonglong2 r[kWindow];
#pragma unroll
    for (int k = 0; k < kWindow; ++k) {
      const int jk = kReverse ? j + k : j - k;
      r[k] = (kReverse ? jk < n_chunks : jk >= 0)
                 ? load_record(mine + (long long)(jk - c) * W)
                 : make_ulonglong2(0ull, 0ull);
    }
    bool stop = false;
    int used = 0;
#pragma unroll
    for (int k = 0; k < kWindow; ++k) {
      if (stop || (kReverse ? j + k >= n_chunks : j - k < 0)) {
        stop = true;
      } else if (tag_of(r[k].y) == inclusive) {
        h = fmaf(expf(As), value_of(r[k].y), es);
        found = stop = true;
      } else if (tag_of(r[k].y) == aggregate &&
                 tag_of(r[k].x) == aggregate) {
        es = fmaf(expf(As), value_of(r[k].y), es);
        As += value_of(r[k].x);
        ++used;
      } else {
        stop = true;   // not published yet: read it again
      }
    }
    j += kReverse ? used : -used;
    if (!found && used == 0 && ++idle == kMaxIdle) __trap();
  }
  return h;
}

__global__ void __launch_bounds__(kTile, kMinBlocks)
rglru_scan_kernel(const float* __restrict__ log_a,
                  const float* __restrict__ x, const float* __restrict__ h0,
                  float* __restrict__ out, unsigned* __restrict__ ticket,
                  ulonglong2* __restrict__ records, int S, int W,
                  int n_chunks, int n_tiles, unsigned n_tickets,
                  unsigned epoch) {
  __shared__ unsigned s_ticket;
  const unsigned last = n_tickets + gridDim.x - 1;
  const unsigned aggregate = epoch << 1, inclusive = aggregate | 1u;
  float a[kChunk], xs[kChunk];
  unsigned t = take_ticket(ticket, last, &s_ticket);
  Place p = place_of<false>(t, S, W, n_chunks, n_tiles);
  if (t < n_tickets && p.w < W) load_chunk(log_a, x, p, W, a, xs);
  while (t < n_tickets) {
    const bool live = p.w < W;
    // 2. the chunk from a zero state: its aggregate
    float A = 0.f, e = 0.f;
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      A += a[i];
      a[i] = expf(a[i]);
      e = fmaf(a[i], e, xs[i]);
    }
    ulonglong2* mine = records + ((long long)p.b * n_chunks + p.c) * W + p.w;
    if (live && p.c > 0) store_aggregate(mine, A, e, aggregate);
    // the next chunk's loads stay in flight through the look-back
    const unsigned tn = take_ticket(ticket, last, &s_ticket);
    const Place pn = place_of<false>(tn, S, W, n_chunks, n_tiles);
    float na[kChunk], nx[kChunk];
    if (tn < n_tickets && pn.w < W) load_chunk(log_a, x, pn, W, na, nx);
    if (live) {
      // 3. the state entering the chunk
      float h = p.c == 0 ? h0[(long long)p.b * W + p.w]
                         : look_back<false>(mine, p.c, n_chunks, W,
                                            aggregate, inclusive);
      // 4. rescan from it, write every state, publish the last
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        h = fmaf(a[i], h, xs[i]);
        if (i < p.n) out[p.off + (long long)i * W] = h;
      }
      store_inclusive(mine, h, inclusive);
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      a[i] = na[i];
      xs[i] = nx[i];
    }
    t = tn;
    p = pn;
  }
}

// The backward: a chunk of log_a, dy and y (y one step behind: h_{t-1},
// h0 before step 0) staged in shared memory, rows [0, kChunk) log_a,
// [kChunk, 2 kChunk) dy, [2 kChunk, 3 kChunk) y, each kTile wide.
constexpr int kStageRows = 3 * kChunk;
constexpr int kStageBytes = kStageRows * kTile * 4;   // 48 KB

// This thread's column of a chunk into the stage by cp.async (one group);
// steps past S, and a channel past W, are zeros.
__device__ __forceinline__ void stage_chunk(float* stage,
                                            const float* __restrict__ log_a,
                                            const float* __restrict__ dy,
                                            const float* __restrict__ y,
                                            const float* __restrict__ h0,
                                            const Place& p, int W) {
  float* col = stage + threadIdx.x;
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    const bool in = p.w < W && i < p.n;
    const long long at = p.off + (long long)i * W;
    tf32::cp_async4(col + i * kTile, in ? log_a + at : log_a, in);
    tf32::cp_async4(col + (kChunk + i) * kTile, in ? dy + at : dy, in);
    const float* prev = i > 0 || p.c > 0 ? y + at - W
                                         : h0 + (long long)p.b * W + p.w;
    tf32::cp_async4(col + (2 * kChunk + i) * kTile, in ? prev : y, in);
  }
  tf32::cp_async_commit();
}

__global__ void __launch_bounds__(kTile, kMinBlocks)
rglru_scan_bwd_kernel(const float* __restrict__ log_a,
                      const float* __restrict__ h0,
                      const float* __restrict__ y,
                      const float* __restrict__ dy,
                      float* __restrict__ dlog_a, float* __restrict__ dx,
                      float* __restrict__ dh0, unsigned* __restrict__ ticket,
                      ulonglong2* __restrict__ records, int S, int W,
                      int n_chunks, int n_tiles, unsigned n_tickets,
                      unsigned epoch) {
  extern __shared__ float stage[];   // kStageBytes
  __shared__ unsigned s_ticket;
  const unsigned last = n_tickets + gridDim.x - 1;
  const unsigned aggregate = epoch << 1, inclusive = aggregate | 1u;
  unsigned t = take_ticket(ticket, last, &s_ticket);
  Place p = place_of<true>(t, S, W, n_chunks, n_tiles);
  if (t < n_tickets) stage_chunk(stage, log_a, dy, y, h0, p, W);
  while (t < n_tickets) {
    const bool live = p.w < W;
    tf32::cp_async_wait<0>();
    asm volatile("" ::: "memory");   // the stage is read after the wait
    float a[kChunk], g[kChunk], h[kChunk];   // log_a (then a), dy, h_{t-1}
    const float* col = stage + threadIdx.x;
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      a[i] = col[i * kTile];
      g[i] = col[(kChunk + i) * kTile];
      h[i] = col[(2 * kChunk + i) * kTile];
    }
    // 2. the chunk from u = 0, last step first: its aggregate (steps past
    // S have log_a = 0 and dy = 0: they pass u on unchanged)
    float A = 0.f, e = 0.f;
#pragma unroll
    for (int i = kChunk - 1; i >= 0; --i) {
      A += a[i];
      a[i] = expf(a[i]);
      e = a[i] * (e + g[i]);
    }
    ulonglong2* mine = records + ((long long)p.b * n_chunks + p.c) * W + p.w;
    if (live && p.c < n_chunks - 1) store_aggregate(mine, A, e, aggregate);
    // every thread's stage reads are done (the barriers in take_ticket)
    // before the next chunk's copies overwrite it; they stay in flight
    // through the look-back
    const unsigned tn = take_ticket(ticket, last, &s_ticket);
    const Place pn = place_of<true>(tn, S, W, n_chunks, n_tiles);
    if (tn < n_tickets) stage_chunk(stage, log_a, dy, y, h0, pn, W);
    if (live) {
      // 3. the gradient entering the chunk from the step after it
      float u = p.c == n_chunks - 1
                    ? 0.f
                    : look_back<true>(mine, p.c, n_chunks, W, aggregate,
                                      inclusive);
      // 4. rescan from it, last step first; write dx and d log_a
#pragma unroll
      for (int i = kChunk - 1; i >= 0; --i) {
        const float gi = g[i] + u;
        u = a[i] * gi;
        if (i < p.n) {
          dx[p.off + (long long)i * W] = gi;
          dlog_a[p.off + (long long)i * W] = u * h[i];
        }
      }
      store_inclusive(mine, u, inclusive);
      if (p.c == 0) dh0[(long long)p.b * W + p.w] = u;
    }
    t = tn;
    p = pn;
  }
}

// Blocks of a kernel the current device holds at once, looked up once per
// device into ``cached``.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int smem, int (&cached)[64],
                            int* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && cached[dev] > 0) {
    *blocks = cached[dev];
    return cudaSuccess;
  }
  if (smem > 0)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kTile,
                                                      smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm * sms <= 0) return cudaErrorInvalidConfiguration;
  if (dev < 64) cached[dev] = per_sm * sms;
  *blocks = per_sm * sms;
  return cudaSuccess;
}

long long workspace_floats(int B, int S, int W) {
  const long long n_chunks = (S + kChunk - 1) / kChunk;
  return kHeaderFloats + kRecordFloats * B * n_chunks * W;
}

// The checks both entry points make before they launch.
bool valid_call(const void* ws, long long ws_floats, unsigned epoch, int B,
                int S, int W) {
  if (B <= 0 || S <= 0 || W <= 0) return false;
  if (epoch == 0 || epoch >= (1u << 31)) return false;
  if (ws_floats < workspace_floats(B, S, W) ||
      reinterpret_cast<uintptr_t>(ws) % 16)
    return false;
  const long long n_tickets = (long long)B * ((S + kChunk - 1) / kChunk) *
                              ((W + kTile - 1) / kTile);
  return n_tickets <= 0x7fffffffLL;
}

}  // namespace

// Steps of S per block.
extern "C" int rglru_scan_chunk() { return kChunk; }

// Floats of workspace a call needs (layout in the header above), or -1 for
// a shape the kernel does not take.
extern "C" long long rglru_scan_workspace_floats(int B, int S, int W) {
  if (B <= 0 || S <= 0 || W <= 0) return -1;
  return workspace_floats(B, S, W);
}

// C interface (bound with ctypes). log_a, x, out (B, S, W) and h0 (B, W):
// contiguous fp32 device memory. ws: ws_floats floats of 16-byte-aligned
// device memory, at least rglru_scan_workspace_floats(B, S, W), zero before
// its first use. epoch: 1 .. 2^31 - 1, different from that of every earlier
// call on this workspace since it was last zeroed. Launches nothing and
// returns cudaErrorInvalidValue on anything else; otherwise returns the
// launch's cudaError_t.
extern "C" int rglru_scan_fwd(const void* log_a, const void* x,
                              const void* h0, void* out, void* ws,
                              long long ws_floats, unsigned epoch, int B,
                              int S, int W, void* stream) {
  if (!valid_call(ws, ws_floats, epoch, B, S, W))
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (S + kChunk - 1) / kChunk;
  const int n_tiles = (W + kTile - 1) / kTile;
  const long long n_tickets = (long long)B * n_chunks * n_tiles;
  int resident = 0;
  static int cached[64] = {};
  const cudaError_t err =
      resident_blocks(rglru_scan_kernel, 0, cached, &resident);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid =
      (unsigned)(n_tickets < resident ? n_tickets : resident);
  float* base = static_cast<float*>(ws);
  rglru_scan_kernel<<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(log_a), static_cast<const float*>(x),
      static_cast<const float*>(h0), static_cast<float*>(out),
      reinterpret_cast<unsigned*>(base),
      reinterpret_cast<ulonglong2*>(base + kHeaderFloats), S, W, n_chunks,
      n_tiles, (unsigned)n_tickets, epoch);
  return (int)cudaGetLastError();
}

// C interface of the backward. log_a, y (the forward's output), dy,
// dlog_a, dx (B, S, W) and h0, dh0 (B, W): contiguous fp32 device memory.
// ws and epoch as for rglru_scan_fwd, whose workspace it may share (the
// epochs of the calls on one workspace all differ). Launches nothing and
// returns cudaErrorInvalidValue on anything else; otherwise returns the
// launch's cudaError_t.
extern "C" int rglru_scan_bwd(const void* log_a, const void* h0,
                              const void* y, const void* dy, void* dlog_a,
                              void* dx, void* dh0, void* ws,
                              long long ws_floats, unsigned epoch, int B,
                              int S, int W, void* stream) {
  if (!valid_call(ws, ws_floats, epoch, B, S, W))
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (S + kChunk - 1) / kChunk;
  const int n_tiles = (W + kTile - 1) / kTile;
  const long long n_tickets = (long long)B * n_chunks * n_tiles;
  int resident = 0;
  static int cached[64] = {};
  const cudaError_t err = resident_blocks(rglru_scan_bwd_kernel, kStageBytes,
                                          cached, &resident);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid =
      (unsigned)(n_tickets < resident ? n_tickets : resident);
  float* base = static_cast<float*>(ws);
  rglru_scan_bwd_kernel<<<grid, kTile, kStageBytes,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(log_a), static_cast<const float*>(h0),
      static_cast<const float*>(y), static_cast<const float*>(dy),
      static_cast<float*>(dlog_a), static_cast<float*>(dx),
      static_cast<float*>(dh0), reinterpret_cast<unsigned*>(base),
      reinterpret_cast<ulonglong2*>(base + kHeaderFloats), S, W, n_chunks,
      n_tiles, (unsigned)n_tickets, epoch);
  return (int)cudaGetLastError();
}
