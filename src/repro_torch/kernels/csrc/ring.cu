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
// * Each launch of ring_pop, ring_push or sweep_guards adds one to its entry
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
  // [T * P] the conditional handle of each (task, phase) body in the
  // sweep's graph, 0 where the task has no such phase; null outside it
  const unsigned long long* handles;
  void* stream;
  int T;
  int P;
  int C;
};

// Launches of ring_pop, ring_push and sweep_guards (in that order) since
// the host last zeroed them.  Outside the anonymous namespace: an extern
// "C" entry returns its address.
__device__ unsigned long long ring_launches[3];

namespace {

enum { kPopLaunches, kPushLaunches, kSweepLaunches };

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
    if (!done) {
      if (any_live) a.state[1] += 1;
      if (!any_live || !any_fire || !any_left) a.state[0] = 1;
    }
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
// the caller keeps with its memory), added as a child graph.  *out
// receives the SweepGraph.
struct SweepGraph {
  cudaGraph_t graph;
  cudaGraphExec_t exec;
};

int sweep_graph_create(const SweepLaunch* s, const int* rows,
                       void* const* bodies, int n, unsigned long long* handles,
                       void** out) {
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
  if (e == cudaSuccess) {
    cudaKernelNodeParams kp = {};
    kp.func = reinterpret_cast<void*>(sweep_guards_kernel);
    kp.gridDim = dim3(1, 1, 1);
    kp.blockDim = dim3((s->T + 31) / 32 * 32, 1, 1);
    kp.sharedMemBytes = s->C * sizeof(int32_t);
    kp.kernelParams = args;
    e = cudaGraphAddKernelNode(&prev, g, nullptr, 0, &kp);
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
    if (e == cudaSuccess)
      e = cudaGraphAddChildGraphNode(&child, cp.conditional.phGraph_out[0],
                                     nullptr, 0,
                                     static_cast<cudaGraph_t>(bodies[i]));
    prev = node;
  }
  if (e == cudaSuccess) e = cudaGraphInstantiate(&exec, g, 0);
  if (e != cudaSuccess) {
    if (g) cudaGraphDestroy(g);
    cudaGetLastError();   // clear it
    return static_cast<int>(e);
  }
  *out = new SweepGraph{g, exec};
  return 0;
}

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
// ring_launches[3] (pop, push, sweep_guards; unsigned 64-bit) on the
// current device.
int ring_launch_counters(void** out) {
  return static_cast<int>(cudaGetSymbolAddress(out, ring_launches));
}

const char* ring_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
