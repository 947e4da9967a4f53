// Ring-buffer kernels of the compiled interconnect, for Hopper (sm_90a).
//
// CompiledEngine keeps every channel as a ring buffer buf[cap, *elem] on
// the card, with the channel's head and size as int32 entries of two
// device vectors (heads[C], sizes[C]).  The kernels of the interconnect:
//
//   ring_pop      toks[i] = buf[(head + i) % cap]; head = (head + n) % cap;
//                 size -= n
//   ring_push     buf[(head + size + i) % cap] = arr[i]; size += n
//   sweep_guards  the sweep's control: phase[t], fire[t] = live[t] & the
//                 guard of t's phase over sparse need tables, run[t, p],
//                 fires += fire, the sweep count and the done flag
//   eval_guards   fire[t] = live[t] & all_c(need_r[t,c] <= sizes[c])
//                                    & all_c(need_w[t,c] <= caps[c] - sizes[c])
//   service_ports every async_mmap port's latency queue, once a sweep, then
//                 the sweep's commit (its count and done flag)
//
// They replace the Pallas kernels _pop_kernel, _push_kernel and
// _guard_kernel of the reference package (src/repro/kernels/ring.py):
// sweep_guards is the guards kernel the sweep loop runs, eval_guards its
// counterpart of the reference's eval_guards API.
//
// Design notes.
// * head and size are read by the kernel from device memory, never passed
//   as host ints: a host value would cost one synchronisation per op.
// * What bounds pop/push is bytes moved (up to 256 KiB read and 256 KiB
//   written a token on the main path), so a burst is spread over a
//   thread-block cluster of up to 8 blocks (the wrapper picks the size
//   from the bytes, 32 KiB a block; one block launches as a plain block,
//   its own implicit cluster).  The race this opens — a late
//   block reading a head an earlier block of the same launch had already
//   advanced — is closed by the cluster barrier: every thread reads
//   head/size into registers and arrives (release); only then, after the
//   wait (acquire), does block 0's thread 0 write the new values.  The
//   arrive comes before the copy and the wait after it, so the barrier
//   overlaps the copy.  One launch per op, head/size stay on the device,
//   and nothing is shared between rings.
// * A burst is at most two contiguous spans of the ring: rows [t, min(t +
//   n, cap)) then [0, rest), t the head (pop) or the tail (push).  Each is
//   a flat copy of raw words (16, 4 or 1 bytes; every dtype, bool
//   included, moves exactly), so a word's place costs one compare, not a
//   division.  Each thread keeps kUnroll independent loads in flight: a
//   256 KiB token is one pass of 8 x 512 threads x 4 x 16 bytes.
// * push writes into buf in place.  The reference copies the whole ring
//   through its kernel only because JAX arrays are immutable.
// * eval_guards gives one warp to each task row: lanes stride over the
//   channels and __all_sync reduces.  Integer compares only, so the result
//   is exact.
//
// * Each launch of ring_pop, ring_push, sweep_guards or service_ports adds
//   one to its entry
//   of ring_launches, on the device (block 0, thread 0, one atomicAdd):
//   a launch is counted where it runs, whether the host launched it or a
//   replayed CUDA graph did.  The host reads the counters
//   (ring_launch_counters) when it asks for the launch counts.
//
// sweep_guards is the guards kernel (_guard_kernel) redesigned as the head
// of the captured sweep (core/synth.py): one launch does all the control
// work of a sweep on the device, so the host replays sweeps without
// reading anything back.  From the firing counters it derives each task's
// phase (the number of cumulative phase bounds passed) and liveness,
// evaluates the guard of the current phase, writes the predicate run[t, p]
// of every (task, phase), commits fires += fire, counts the sweep and sets
// done when the run is over.  Inside the sweep's CUDA graph
// (sweep_graph_create) it also sets the condition of the conditional node
// that holds the body of the phase that fires; a launch of the graph resets
// every condition to false, so no other node needs a launch of its own.
// Bound: its launch and its chain of dependent loads.  The work is a few
// KiB of tables: the dense [T, C] compare of eval_guards becomes sparse
// tables built once on the host, per (task, phase) only the channels it
// touches (a gemm task touches 1-8 of 192), each entry one 16-byte load of
// (channel, need_r, need_w, cap).  One block, one thread a task.  Each
// thread loads its counter, total, phase bounds and the row offsets of all
// its phases at once while the block stages the occupancy vector in shared
// memory, so an entry costs one load from device memory after the phase is
// known: two round trips in all, as eval_guards' compare.
// __syncthreads_or gives any(live), any(fire) and any(left).
//
// service_ports is the reference's per-sweep port service
// (_service_ports, src/repro/core/synth.py:951; XLA ops there, no Pallas
// kernel) as one launch after the sweep's bodies.  Each bounded async_mmap
// port is a latency queue: a read window and a write window of `depth`
// in-flight requests, each stamped due `latency` sweeps after it was
// accepted.  The step, per port, in the reference's order: deliver due reads
// in FIFO order while the response ring has room (a row copy from the
// buffer at the clipped address), deliver due writes the same way (a row
// copy into the buffer, `true` into write_resp), accept queued reads into
// free window slots, accept queued writes (an address and a value token
// each).  Ports touch disjoint rings and buffers, so each port has a cluster
// of its own.  Bound: bytes, the rows it copies (up to 256 KiB each on
// gemm's ports, 8 B on page_rank's).  The decisions are a short chain of
// dependent integer steps; every block's thread 0 makes the same chain from
// the same start-of-launch state into shared memory, so the blocks need not
// exchange them, and then the cluster copies the rows, a phase at a time:
// read deliveries, write deliveries (the last one to each address only:
// the earlier ones are overwritten in the same step), write acceptances
// (which may reuse a window slot a delivery just freed), with a cluster
// barrier between phases.  Block 0 writes the state back after the
// barriers, when every block has read it.  The commit needs every port's
// outcome: the block that finishes last (a ticket, as in CUDA's
// threadFenceReduction sample) samples the occupancy highwater marks over
// every channel, counts the sweep and sets done unless the sweep made
// progress (a body fired, a request moved, or one is due later) and work
// is left (a task has firings left or a window is not empty).  With the
// done flag set at its start, a launch changes nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include <vector>

// The launch arguments that depend only on the ring, prepared once per
// ring by the Python wrapper (kernels/ring.py, class _RingLaunch), and the
// stream, which the wrapper updates when the current stream moves: each
// argument of a call costs the wrapper a ctypes conversion.  Outside the
// anonymous namespace: the extern "C" entries take it, and a type of
// internal linkage would give them internal linkage too.
struct RingLaunch {
  void* buf;
  int32_t* head;
  int32_t* size;
  void* stream;
  long long row_bytes;
  int cap;
  int word;   // widest copy word dividing row_bytes and buf's address
};

// One program's sweep-control launch, prepared once by the Python wrapper
// (kernels/ring.py, class _SweepLaunch) and passed to the kernel by value.
// T tasks of at most P phases; row r = t * P + p of the sparse tables holds
// entries[row_ptr[r] .. row_ptr[r + 1]).
struct SweepLaunch {
  const int32_t* totals;    // [T] firings of each task
  const int32_t* bounds;    // [T, P - 1] cumulative phase bounds, padded
  const int32_t* row_ptr;   // [T * P + 1]
  const int4* entries;      // [nnz] (channel, need_r, need_w, cap)
  const int32_t* sizes;     // [C] channel occupancy
  int32_t* fires;           // [T] firing counters, advanced in place
  int32_t* state;           // [2] done, sweeps
  bool* run;                // [T, P] out: the phase that fires
  bool* fire;               // [T] out
  int32_t* phase;           // [T] out
  // [2] out: any task fired, any has firings left; set for a graph with
  // async ports, whose sweep service_ports commits: then the kernel leaves
  // state alone.  Null for a graph without ports.
  int32_t* flags;
  // [T * P] the conditional handle of each (task, phase) body in the
  // sweep's graph, 0 where the task has no such phase; null outside it
  const unsigned long long* handles;
  void* stream;
  int T;
  int P;
  int C;
};

// One async_mmap port's latency queue, prepared once by the Python wrapper
// (kernels/ring.py, class _PortLaunch) into a device array the kernel
// reads.  Rings by role: 0 read_addr, 1 read_data, 2 write_addr,
// 3 write_data, 4 write_resp.
struct PortLaunch {
  void* data;               // [nrow, row] the port's buffer
  void* wval;               // [depth, row] values of the write window
  int32_t* win;             // [4, depth] read addr, read due, write addr,
                            // write due
  int32_t* st;              // [10] the port's counters (kP* below)
  void* buf[5];             // each ring's buffer
  long long row_bytes;
  int nrow;
  int depth;
  int latency;
  int word;                 // copy word dividing the row and every buffer
  int chan[5];              // each ring's channel (its heads/sizes entry)
  int cap[5];
};

// One program's service launch, prepared once by the Python wrapper (class
// _ServiceLaunch) and passed to the kernel by value.
struct ServiceLaunch {
  const PortLaunch* ports;  // [n], device memory
  int32_t* heads;           // [C]
  int32_t* sizes;           // [C]
  int32_t* maxocc;          // [C]
  int32_t* state;           // [2] done, sweeps
  const int32_t* flags;     // [2] sweep_guards' any fired, any left
  int32_t* scratch;         // [3] ticket, progress, pending; zero between
                            // launches
  void* stream;
  int n;
  int C;
  int blocks;               // the cluster of one port
};

// Launches of ring_pop, ring_push, sweep_guards and service_ports (in that
// order) since the host last zeroed them.  Outside the anonymous
// namespace: an extern "C" entry returns its address.
__device__ unsigned long long ring_launches[4];

namespace {

enum { kPopLaunches, kPushLaunches, kSweepLaunches, kServiceLaunches };

constexpr int kCopyThreads = 512;
constexpr int kUnroll = 4;
constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr int kGuardWarps = 4;   // task rows per block
constexpr int kMaxSweepTasks = 1024;   // one thread a task, one block
constexpr int kMaxPhases = 4;          // a StepTask has at most 3
constexpr int kMaxSweepChannels = 12288;   // sizes staged in 48 KiB

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Copies total words between a ring and a flat array.  The ring side of
// flat word k is ring[first + k] for k < split (the span up to the ring's
// end), ring[k - split] after it (the span from row 0).
template <typename W, bool to_ring>
__device__ __forceinline__ void copy_burst(W* __restrict__ ring,
                                           W* __restrict__ flat,
                                           long long first, long long split,
                                           long long total) {
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long k0 = tid; k0 < total; k0 += nthreads * kUnroll) {
    W v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long k = k0 + u * nthreads;
      if (k < total) {
        const long long r = k < split ? first + k : k - split;
        v[u] = to_ring ? flat[k] : ring[r];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long k = k0 + u * nthreads;
      if (k < total) {
        const long long r = k < split ? first + k : k - split;
        if (to_ring) {
          ring[r] = v[u];
        } else {
          flat[k] = v[u];
        }
      }
    }
  }
}

template <typename W>
__global__ void __launch_bounds__(kCopyThreads)
ring_pop_kernel(const W* buf, W* out, int32_t* head, int32_t* size, int cap,
                int n, long long row_words) {
  const int h = *head;
  const int s = *size;
  cluster_arrive();   // h and s are in registers: block 0 may move them
  const int first_rows = min(n, cap - h);
  copy_burst<W, false>(const_cast<W*>(buf), out, (long long)h * row_words,
                       (long long)first_rows * row_words,
                       (long long)n * row_words);
  cluster_wait();     // every thread of the cluster has read h and s
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *head = (h + n) % cap;
    *size = s - n;
    atomicAdd(&ring_launches[kPopLaunches], 1ull);
  }
}

template <typename W>
__global__ void __launch_bounds__(kCopyThreads)
ring_push_kernel(W* buf, const W* arr, const int32_t* head, int32_t* size,
                 int cap, int n, long long row_words) {
  const int h = *head;
  const int s = *size;
  cluster_arrive();   // s is in registers: block 0 may move it
  const int tail = (h + s) % cap;
  const int first_rows = min(n, cap - tail);
  copy_burst<W, true>(buf, const_cast<W*>(arr), (long long)tail * row_words,
                      (long long)first_rows * row_words,
                      (long long)n * row_words);
  cluster_wait();     // every thread of the cluster has read s
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *size = s + n;
    atomicAdd(&ring_launches[kPushLaunches], 1ull);
  }
}

// One launch of a copy kernel as one cluster of `blocks` blocks.  A single
// block launches without the cluster attribute, which it does not need:
// its implicit cluster is the block itself (the barrier then orders its
// own threads), and a plain launch spares it the cluster scheduling.
template <typename W, typename Ring, typename Flat, typename Head>
int launch_copy(void (*kernel)(Ring*, Flat*, Head*, int32_t*, int, int,
                               long long),
                const RingLaunch* r, void* flat, int n, int blocks) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(kCopyThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(r->stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = blocks > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<Ring*>(r->buf), static_cast<Flat*>(flat),
      static_cast<Head*>(r->head), r->size, r->cap, n,
      r->row_bytes / static_cast<long long>(sizeof(W)));
  const cudaError_t last = cudaGetLastError();   // and clear it
  return static_cast<int>(e != cudaSuccess ? e : last);
}

// The widest word (16, 4 or 1 bytes) that the ring's word allows and that
// divides the other pointer: the wrapper's copy_word over both pointers.
int narrowed(int word, const void* other) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(other);
  while (word > 1 && p % word) word = word == 16 ? 4 : 1;
  return word;
}

__global__ void eval_guards_kernel(const int32_t* __restrict__ sizes,
                                   const int32_t* __restrict__ caps,
                                   const int32_t* __restrict__ need_r,
                                   const int32_t* __restrict__ need_w,
                                   const bool* __restrict__ live,
                                   bool* __restrict__ fire, int T, int C) {
  const int t = blockIdx.x * kGuardWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (t >= T) return;   // uniform across the warp
  bool ok = true;
  const int32_t* nr = need_r + (long long)t * C;
  const int32_t* nw = need_w + (long long)t * C;
  for (int c = lane; c < C; c += 32) {
    const int32_t s = sizes[c];
    ok = ok && nr[c] <= s && nw[c] <= caps[c] - s;
  }
  ok = __all_sync(0xffffffffu, ok);
  if (lane == 0) fire[t] = live[t] && ok;
}

// One sweep's control, as the eager loop did it on the host: a sweep that
// finds no live task ends the run uncounted; a counted sweep that fires
// nothing ends it; one after which no task has firings left ends it too
// (the next would find none live).  Once done is set a launch writes
// all-zero predicates and changes nothing, so replays past the end are
// harmless.  fires is committed here and not after the task bodies: within
// a sweep nothing reads it again (each body learns its phase from run).
// With a.flags set (a graph with async ports) the kernel writes any(fire)
// and any(left) there and leaves the sweep count and the done flag to
// service_ports, which runs after the bodies: a sweep that fires nothing
// may still move a port's requests.
__global__ void __launch_bounds__(kMaxSweepTasks)
sweep_guards_kernel(const SweepLaunch a) {
  extern __shared__ int32_t occ[];   // sizes[C], staged once a launch
  const int t = threadIdx.x;
  const bool task = t < a.T;
  const int done = a.state[0];   // every thread reads it before the barriers
  int f = 0, total = 0, b[kMaxPhases - 1], rp[kMaxPhases + 1];
  if (task) {
    f = a.fires[t];
    total = a.totals[t];
#pragma unroll
    for (int k = 0; k < kMaxPhases - 1; ++k)
      b[k] = k < a.P - 1 ? a.bounds[t * (a.P - 1) + k] : 0x7fffffff;
#pragma unroll
    for (int k = 0; k <= kMaxPhases; ++k)
      rp[k] = k <= a.P ? a.row_ptr[t * a.P + k] : 0;
  }
  for (int c = t; c < a.C; c += blockDim.x) occ[c] = a.sizes[c];
  __syncthreads();
  int ph = 0, lo = 0, hi = 0;
#pragma unroll
  for (int k = 0; k < kMaxPhases - 1; ++k) ph += f >= b[k];
#pragma unroll
  for (int k = 0; k < kMaxPhases; ++k) {
    if (k == ph) {
      lo = rp[k];
      hi = rp[k + 1];
    }
  }
  const bool live = task && !done && f < total;
  bool ok = live;
  if (live) {
#pragma unroll 4
    for (int e = lo; e < hi; ++e) {
      const int4 n = a.entries[e];
      const int s = occ[n.x];
      ok &= n.y <= s && n.z <= n.w - s;
    }
  }
  const bool left = task && f + ok < total;
  if (ok && a.handles) cudaGraphSetConditional(a.handles[t * a.P + ph], 1u);
  const int any_live = __syncthreads_or(live);
  const int any_fire = __syncthreads_or(ok);
  const int any_left = __syncthreads_or(left);
  if (task) {
    if (ok) a.fires[t] = f + 1;
    a.fire[t] = ok;
    a.phase[t] = ph;
    for (int p = 0; p < a.P; ++p) a.run[t * a.P + p] = ok && p == ph;
  }
  if (t == 0) {
    atomicAdd(&ring_launches[kSweepLaunches], 1ull);
    if (a.flags) {
      a.flags[0] = any_fire;
      a.flags[1] = any_left;
    } else if (!done) {
      if (any_live) a.state[1] += 1;
      if (!any_live || !any_fire || !any_left) a.state[0] = 1;
    }
  }
}

// The port counters' layout (st), as the reference's port carry holds them.
enum { kRHead, kRSize, kWHead, kWSize, kAccR, kDelR, kAccW, kDelW, kMaxR,
       kMaxW, kPortWords };
constexpr int kMaxDepth = 64;   // a port's in-flight window

// What a service step decides for one port, made by each block's thread 0.
struct PortStep {
  int st[kPortWords];
  int win[4][kMaxDepth];
  int head[5], size[5];
  int n_rd, rd_src[kMaxDepth], rd_dst[kMaxDepth];   // data row -> rd slot
  int n_wd, wd_src[kMaxDepth], wd_dst[kMaxDepth];   // wval slot -> data row
  int n_wa, wa_src[kMaxDepth], wa_dst[kMaxDepth];   // wd slot -> wval slot
  int wr_first, n_wr;                                // write_resp slots
  int done, moved, waiting, pending;
};

// The reference's _service_ports for one port, step for step, on ints.
__device__ void decide(const PortLaunch& p, const int32_t* heads,
                       const int32_t* sizes, int sweeps, PortStep& s) {
  const int d = p.depth;
  for (int k = 0; k < kPortWords; ++k) s.st[k] = p.st[k];
  for (int r = 0; r < 4; ++r)
    for (int k = 0; k < d; ++k) s.win[r][k] = p.win[r * d + k];
  for (int r = 0; r < 5; ++r) {
    s.head[r] = heads[p.chan[r]];
    s.size[r] = sizes[p.chan[r]];
  }
  int* st = s.st;
  int moved = 0;
  // 1. deliver due reads, FIFO, while read_data has room
  s.n_rd = 0;
  while (st[kRSize] > 0 && s.win[1][st[kRHead]] <= sweeps &&
         s.size[1] < p.cap[1]) {
    const int addr = min(max(s.win[0][st[kRHead]], 0), p.nrow - 1);
    s.rd_src[s.n_rd] = addr;
    s.rd_dst[s.n_rd++] = (s.head[1] + s.size[1]) % p.cap[1];
    s.size[1] += 1;
    st[kRHead] = (st[kRHead] + 1) % d;
    st[kRSize] -= 1;
    st[kDelR] += 1;
    moved = 1;
  }
  // 2. deliver due writes, FIFO, while write_resp has room
  s.n_wd = 0;
  s.wr_first = (s.head[4] + s.size[4]) % p.cap[4];
  while (st[kWSize] > 0 && s.win[3][st[kWHead]] <= sweeps &&
         s.size[4] < p.cap[4]) {
    s.wd_src[s.n_wd] = st[kWHead];
    s.wd_dst[s.n_wd++] = min(max(s.win[2][st[kWHead]], 0), p.nrow - 1);
    s.size[4] += 1;
    st[kWHead] = (st[kWHead] + 1) % d;
    st[kWSize] -= 1;
    st[kDelW] += 1;
    moved = 1;
  }
  s.n_wr = s.n_wd;
  // 3. accept queued reads into the read window
  const int32_t* ra = static_cast<const int32_t*>(p.buf[0]);
  while (s.size[0] > 0 && st[kRSize] < d) {
    const int slot = (st[kRHead] + st[kRSize]) % d;
    s.win[0][slot] = ra[s.head[0]];
    s.win[1][slot] = sweeps + p.latency;
    s.head[0] = (s.head[0] + 1) % p.cap[0];
    s.size[0] -= 1;
    st[kRSize] += 1;
    st[kAccR] += 1;
    moved = 1;
  }
  st[kMaxR] = max(st[kMaxR], st[kRSize]);
  // 4. accept queued writes: an address and a value token each
  const int32_t* wa = static_cast<const int32_t*>(p.buf[2]);
  s.n_wa = 0;
  while (s.size[2] > 0 && s.size[3] > 0 && st[kWSize] < d) {
    const int slot = (st[kWHead] + st[kWSize]) % d;
    s.win[2][slot] = wa[s.head[2]];
    s.win[3][slot] = sweeps + p.latency;
    s.wa_src[s.n_wa] = s.head[3];
    s.wa_dst[s.n_wa++] = slot;
    s.head[2] = (s.head[2] + 1) % p.cap[2];
    s.size[2] -= 1;
    s.head[3] = (s.head[3] + 1) % p.cap[3];
    s.size[3] -= 1;
    st[kWSize] += 1;
    st[kAccW] += 1;
    moved = 1;
  }
  st[kMaxW] = max(st[kMaxW], st[kWSize]);
  // 5. an in-flight request due after this sweep keeps the run going
  int waiting = 0;
  for (int i = 0; i < st[kRSize]; ++i)
    waiting |= s.win[1][(st[kRHead] + i) % d] > sweeps;
  for (int i = 0; i < st[kWSize]; ++i)
    waiting |= s.win[3][(st[kWHead] + i) % d] > sweeps;
  s.moved = moved;
  s.waiting = waiting;
  s.pending = st[kRSize] > 0 || st[kWSize] > 0;
  // a write delivery that a later one to the same address overwrites
  // within this step is not copied
  int kept = 0;
  for (int i = 0; i < s.n_wd; ++i) {
    bool last = true;
    for (int j = i + 1; j < s.n_wd; ++j) last &= s.wd_dst[j] != s.wd_dst[i];
    if (last) {
      s.wd_src[kept] = s.wd_src[i];
      s.wd_dst[kept++] = s.wd_dst[i];
    }
  }
  s.n_wd = kept;
}

// Rows src[i] -> dst[i] of `row_words` words of W, i < n, spread over the
// cluster's threads.
template <typename W>
__device__ void copy_rows(char* dst_base, const int* dst, const char* src_base,
                          const int* src, int n, long long row_bytes,
                          long long tid, long long nthreads) {
  const long long words = row_bytes / static_cast<long long>(sizeof(W));
  for (int i = 0; i < n; ++i) {
    W* out = reinterpret_cast<W*>(dst_base + dst[i] * row_bytes);
    const W* in = reinterpret_cast<const W*>(src_base + src[i] * row_bytes);
    for (long long k0 = tid; k0 < words; k0 += nthreads * kUnroll) {
      W v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long k = k0 + u * nthreads;
        if (k < words) v[u] = in[k];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long k = k0 + u * nthreads;
        if (k < words) out[k] = v[u];
      }
    }
  }
}

__device__ void copy_rows_any(int word, char* dst_base, const int* dst,
                              const char* src_base, const int* src, int n,
                              long long row_bytes, long long tid,
                              long long nthreads) {
  if (word == 16)
    copy_rows<uint4>(dst_base, dst, src_base, src, n, row_bytes, tid,
                     nthreads);
  else if (word == 4)
    copy_rows<uint32_t>(dst_base, dst, src_base, src, n, row_bytes, tid,
                        nthreads);
  else
    copy_rows<uint8_t>(dst_base, dst, src_base, src, n, row_bytes, tid,
                       nthreads);
}

// One service step for every port (cluster p = blockIdx.x / blocks), then
// the sweep's commit by the block that finishes last.
__global__ void __launch_bounds__(kCopyThreads)
service_ports_kernel(const ServiceLaunch a) {
  __shared__ PortStep s;
  __shared__ int last;
  const int rank = blockIdx.x % a.blocks;
  const PortLaunch& p = a.ports[blockIdx.x / a.blocks];
  if (threadIdx.x == 0) {
    if (blockIdx.x == 0) atomicAdd(&ring_launches[kServiceLaunches], 1ull);
    s.done = a.state[0];
    if (!s.done) decide(p, a.heads, a.sizes, a.state[1], s);
  }
  __syncthreads();
  if (s.done) return;   // the whole grid returns: no barrier is left waiting
  const long long nthreads = (long long)a.blocks * blockDim.x;
  const long long tid = (long long)rank * blockDim.x + threadIdx.x;
  char* data = static_cast<char*>(p.data);
  char* wval = static_cast<char*>(p.wval);
  cluster_arrive();     // every block's thread 0 has read the state
  cluster_wait();
  copy_rows_any(p.word, static_cast<char*>(p.buf[1]), s.rd_dst, data,
                s.rd_src, s.n_rd, p.row_bytes, tid, nthreads);
  cluster_arrive();     // the read deliveries have read the buffer
  cluster_wait();
  copy_rows_any(p.word, data, s.wd_dst, wval, s.wd_src, s.n_wd, p.row_bytes,
                tid, nthreads);
  cluster_arrive();     // the write deliveries have read their slots
  cluster_wait();
  copy_rows_any(p.word, wval, s.wa_dst, static_cast<char*>(p.buf[3]),
                s.wa_src, s.n_wa, p.row_bytes, tid, nthreads);
  if (rank != 0) return;
  if (threadIdx.x == 0) {
    for (int k = 0; k < kPortWords; ++k) p.st[k] = s.st[k];
    for (int r = 0; r < 4; ++r)
      for (int k = 0; k < p.depth; ++k) p.win[r * p.depth + k] = s.win[r][k];
    bool* wr = static_cast<bool*>(p.buf[4]);
    for (int i = 0; i < s.n_wr; ++i) wr[(s.wr_first + i) % p.cap[4]] = true;
    for (int r = 0; r < 5; ++r) {
      a.heads[p.chan[r]] = s.head[r];
      a.sizes[p.chan[r]] = s.size[r];
    }
    if (s.moved || s.waiting) atomicOr(&a.scratch[1], 1);
    if (s.pending) atomicOr(&a.scratch[2], 1);
    __threadfence();    // this port's writes before its ticket
    last = atomicAdd(&a.scratch[0], 1) == a.n - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  volatile const int32_t* sizes = a.sizes;   // other blocks wrote them
  for (int c = threadIdx.x; c < a.C; c += blockDim.x)
    a.maxocc[c] = max(a.maxocc[c], sizes[c]);
  if (threadIdx.x == 0) {
    volatile int32_t* scratch = a.scratch;
    const int progress = a.flags[0] || scratch[1];
    const int left = a.flags[1] || scratch[2];
    a.state[1] += 1;
    a.state[0] = !(progress && left);
    scratch[0] = scratch[1] = scratch[2] = 0;
  }
}

}  // namespace

extern "C" {

// Each entry launches on `stream` without synchronising and returns the
// launch's error code (0 on success; cudaErrorInvalidValue for arguments
// outside the contract below, which the Python wrapper checks first).
//
// ring_pop / ring_push: `r` is the ring's prepared RingLaunch (its
// stream the one to launch on); `flat` is the output (pop) or input (push)
// of n contiguous rows; `burst` packs n and the cluster size as
// n * 16 + blocks, 1 <= n <= cap, 1 <= blocks <= 8.

int ring_pop(const RingLaunch* r, void* flat, long long burst) {
  const long long n = burst >> 4;
  const int blocks = static_cast<int>(burst & 15);
  if (n < 1 || n > r->cap || blocks < 1 || blocks > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ni = static_cast<int>(n);
  switch (narrowed(r->word, flat)) {
    case 16:
      return launch_copy<uint4>(ring_pop_kernel<uint4>, r, flat, ni, blocks);
    case 4:
      return launch_copy<uint32_t>(ring_pop_kernel<uint32_t>, r, flat, ni,
                                   blocks);
    default:
      return launch_copy<uint8_t>(ring_pop_kernel<uint8_t>, r, flat, ni,
                                  blocks);
  }
}

int ring_push(const RingLaunch* r, const void* flat, long long burst) {
  const long long n = burst >> 4;
  const int blocks = static_cast<int>(burst & 15);
  if (n < 1 || n > r->cap || blocks < 1 || blocks > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ni = static_cast<int>(n);
  void* f = const_cast<void*>(flat);
  switch (narrowed(r->word, flat)) {
    case 16:
      return launch_copy<uint4>(ring_push_kernel<uint4>, r, f, ni, blocks);
    case 4:
      return launch_copy<uint32_t>(ring_push_kernel<uint32_t>, r, f, ni,
                                   blocks);
    default:
      return launch_copy<uint8_t>(ring_push_kernel<uint8_t>, r, f, ni,
                                  blocks);
  }
}

int eval_guards(const void* sizes, const void* caps, const void* need_r,
                const void* need_w, const void* live, void* fire, int T,
                int C, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (T + kGuardWarps - 1) / kGuardWarps;
  eval_guards_kernel<<<blocks, kGuardWarps * 32, 0, st>>>(
      static_cast<const int32_t*>(sizes), static_cast<const int32_t*>(caps),
      static_cast<const int32_t*>(need_r), static_cast<const int32_t*>(need_w),
      static_cast<const bool*>(live), static_cast<bool*>(fire), T, C);
  return static_cast<int>(cudaGetLastError());
}

// service_ports: `s` is the program's prepared ServiceLaunch (its stream
// the one to launch on); n >= 1 ports, each depth <= 64, in clusters of
// 1 <= blocks <= 8.
int service_ports(const ServiceLaunch* s) {
  if (s->n < 1 || s->blocks < 1 || s->blocks > kMaxCluster || s->C < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(s->n * s->blocks, 1, 1);
  cfg.blockDim = dim3(kCopyThreads, 1, 1);
  cfg.stream = static_cast<cudaStream_t>(s->stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = s->blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = s->blocks > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, service_ports_kernel, *s);
  const cudaError_t last = cudaGetLastError();   // and clear it
  return static_cast<int>(e != cudaSuccess ? e : last);
}

static bool sweep_args_ok(const SweepLaunch* s) {
  return s->T >= 1 && s->T <= kMaxSweepTasks && s->P >= 1 &&
         s->P <= kMaxPhases && s->C >= 0 && s->C <= kMaxSweepChannels;
}

// sweep_guards: `s` is the program's prepared SweepLaunch (its stream the
// one to launch on); 1 <= T <= 1024, 1 <= P <= 4, 0 <= C <= 12288.
int sweep_guards(const SweepLaunch* s) {
  if (!sweep_args_ok(s)) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (s->T + 31) / 32 * 32;
  sweep_guards_kernel<<<1, threads, s->C * sizeof(int32_t),
                        static_cast<cudaStream_t>(s->stream)>>>(*s);
  return static_cast<int>(cudaGetLastError());
}

// sweep_graph_create: one sweep as a CUDA graph, instantiated: the
// sweep_guards kernel (launch `s`, its handles pointed at `handles`, a
// device array of T * P) and then, chained in the order given, one
// conditional IF node for each of the n bodies that holds any node: row
// rows[i] = t * P + p, body the captured graph bodies[i] (a cudaGraph_t
// the caller keeps with its memory), added as a child graph; last, when
// `tail` is not null, the captured graph `tail` as an unconditional child
// graph (a graph with async ports: its service_ports launch).  *out
// receives the SweepGraph.
struct SweepGraph {
  cudaGraph_t graph;
  cudaGraphExec_t exec;
  int nodes;   // the top-level nodes: the guards, the IF nodes, the tail
};

int sweep_graph_create(const SweepLaunch* s, const int* rows,
                       void* const* bodies, int n, void* tail,
                       unsigned long long* handles, void** out) {
  *out = nullptr;
  if (!sweep_args_ok(s) || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  std::vector<unsigned long long> h(static_cast<size_t>(s->T) * s->P, 0);
  cudaGraph_t g = nullptr;
  cudaGraphExec_t exec = nullptr;
  cudaError_t e = cudaGraphCreate(&g, 0);
  for (int i = 0; e == cudaSuccess && i < n; ++i) {
    if (rows[i] < 0 || rows[i] >= s->T * s->P) {
      e = cudaErrorInvalidValue;
      break;
    }
    cudaGraphConditionalHandle c;
    e = cudaGraphConditionalHandleCreate(&c, g, 0,
                                         cudaGraphCondAssignDefault);
    h[rows[i]] = c;
  }
  if (e == cudaSuccess)
    e = cudaMemcpy(handles, h.data(), h.size() * sizeof(h[0]),
                   cudaMemcpyHostToDevice);
  SweepLaunch a = *s;
  a.handles = handles;
  void* args[] = {&a};
  cudaGraphNode_t prev = nullptr;
  int nodes = 0;
  if (e == cudaSuccess) {
    cudaKernelNodeParams kp = {};
    kp.func = reinterpret_cast<void*>(sweep_guards_kernel);
    kp.gridDim = dim3(1, 1, 1);
    kp.blockDim = dim3((s->T + 31) / 32 * 32, 1, 1);
    kp.sharedMemBytes = s->C * sizeof(int32_t);
    kp.kernelParams = args;
    e = cudaGraphAddKernelNode(&prev, g, nullptr, 0, &kp);
    nodes += 1;
  }
  for (int i = 0; e == cudaSuccess && i < n; ++i) {
    size_t body_nodes = 0;
    e = cudaGraphGetNodes(static_cast<cudaGraph_t>(bodies[i]), nullptr,
                          &body_nodes);
    if (e != cudaSuccess || body_nodes == 0) continue;   // nothing to run
    cudaGraphNodeParams cp = {};
    cp.type = cudaGraphNodeTypeConditional;
    cp.conditional.handle = h[rows[i]];
    cp.conditional.type = cudaGraphCondTypeIf;
    cp.conditional.size = 1;
    cudaGraphNode_t node, child;
    e = cudaGraphAddNode(&node, g, &prev, 1, &cp);
    nodes += 1;
    if (e == cudaSuccess)
      e = cudaGraphAddChildGraphNode(&child, cp.conditional.phGraph_out[0],
                                     nullptr, 0,
                                     static_cast<cudaGraph_t>(bodies[i]));
    prev = node;
  }
  if (e == cudaSuccess && tail) {
    cudaGraphNode_t node;
    e = cudaGraphAddChildGraphNode(&node, g, &prev, 1,
                                   static_cast<cudaGraph_t>(tail));
    nodes += 1;
  }
  if (e == cudaSuccess) e = cudaGraphInstantiate(&exec, g, 0);
  if (e != cudaSuccess) {
    if (g) cudaGraphDestroy(g);
    cudaGetLastError();   // clear it
    return static_cast<int>(e);
  }
  *out = new SweepGraph{g, exec, nodes};
  return 0;
}

// sweep_graph_nodes: the sweep graph's top-level nodes (a count, not an
// error code).
int sweep_graph_nodes(void* sg) { return static_cast<SweepGraph*>(sg)->nodes; }

// k launches of the sweep's graph on `stream`, back to back.
int sweep_graph_replay(void* sg, void* stream, int k) {
  const SweepGraph* p = static_cast<SweepGraph*>(sg);
  for (int i = 0; i < k; ++i) {
    const cudaError_t e =
        cudaGraphLaunch(p->exec, static_cast<cudaStream_t>(stream));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

int sweep_graph_destroy(void* sg) {
  SweepGraph* p = static_cast<SweepGraph*>(sg);
  cudaError_t e = cudaGraphExecDestroy(p->exec);
  const cudaError_t e2 = cudaGraphDestroy(p->graph);
  delete p;
  return static_cast<int>(e != cudaSuccess ? e : e2);
}

// ring_launch_counters: *out receives the device address of
// ring_launches[4] (pop, push, sweep_guards, service_ports; unsigned
// 64-bit) on the current device.
int ring_launch_counters(void** out) {
  return static_cast<int>(cudaGetSymbolAddress(out, ring_launches));
}

const char* ring_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
