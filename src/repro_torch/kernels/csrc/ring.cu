// Ring-buffer kernels of the compiled interconnect, for Hopper (sm_90a).
//
// CompiledEngine keeps every channel as a ring buffer buf[cap, *elem] on
// the card, with the channel's head and size as int32 entries of two
// device vectors (heads[C], sizes[C]).  These three kernels are the whole
// per-sweep interconnect:
//
//   ring_pop     toks[i] = buf[(head + i) % cap]; head = (head + n) % cap;
//                size -= n
//   ring_push    buf[(head + size + i) % cap] = arr[i]; size += n
//   eval_guards  fire[t] = live[t] & all_c(need_r[t,c] <= sizes[c])
//                                   & all_c(need_w[t,c] <= caps[c] - sizes[c])
//
// They replace the Pallas kernels _pop_kernel, _push_kernel and
// _guard_kernel of the reference package (src/repro/kernels/ring.py).
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

#include <cuda_runtime.h>
#include <stdint.h>

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

namespace {

constexpr int kCopyThreads = 512;
constexpr int kUnroll = 4;
constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr int kGuardWarps = 4;   // task rows per block

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

const char* ring_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
