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
// * pop and push run as ONE block.  Every thread reads head/size, the
//   block synchronises, and only then does thread 0 write the new values.
//   With several blocks, a block that starts late could read a head that
//   another block had already advanced.
// * Rows move as raw words (16, 4 or 1 bytes, chosen by the wrapper from
//   the row size and the pointers' alignment), so every dtype is copied
//   exactly, bool included.  A burst that wraps past the end of the ring
//   is the same loop: the source row index is taken modulo cap.
// * push writes into buf in place.  The reference copies the whole ring
//   through its kernel only because JAX arrays are immutable.
// * What bounds pop/push on this card is bytes moved; at the main path's
//   sizes (at most 256 KiB a token) one block is not the limit, the launch
//   is.  Each thread keeps UNROLL independent loads in flight so one block
//   gets close to what a single SM can move.
// * eval_guards gives one warp to each task row: lanes stride over the
//   channels and __all_sync reduces.  Integer compares only, so the result
//   is exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCopyThreads = 1024;
constexpr int kUnroll = 4;
constexpr int kGuardWarps = 4;   // task rows per block

// Copies n rows between a ring and a contiguous array.  to_ring = false:
// dst[i] = ring[(start + i) % cap] (pop); to_ring = true:
// ring[(start + i) % cap] = src[i] (push).
template <typename W, bool to_ring>
__device__ __forceinline__ void copy_rows(W* ring, W* flat, int start,
                                          int cap, int n,
                                          long long row_words) {
  const long long total = (long long)n * row_words;
  const long long stride = (long long)blockDim.x * kUnroll;
  for (long long k0 = threadIdx.x; k0 < total; k0 += stride) {
    W v[kUnroll];
    long long ring_at[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long k = k0 + (long long)u * blockDim.x;
      if (k < total) {
        const long long i = k / row_words;
        const long long w = k - i * row_words;
        ring_at[u] = ((start + i) % cap) * row_words + w;
        v[u] = to_ring ? flat[k] : ring[ring_at[u]];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long k = k0 + (long long)u * blockDim.x;
      if (k < total) {
        if (to_ring) {
          ring[ring_at[u]] = v[u];
        } else {
          flat[k] = v[u];
        }
      }
    }
  }
}

template <typename W>
__global__ void __launch_bounds__(kCopyThreads)
ring_pop_kernel(const W* __restrict__ buf, W* __restrict__ out,
                int32_t* head, int32_t* size, int cap, int n,
                long long row_words) {
  const int h = *head;
  const int s = *size;
  __syncthreads();   // every thread holds h before anyone moves it
  if (threadIdx.x == 0) {
    *head = (h + n) % cap;
    *size = s - n;
  }
  copy_rows<W, false>(const_cast<W*>(buf), out, h, cap, n, row_words);
}

template <typename W>
__global__ void __launch_bounds__(kCopyThreads)
ring_push_kernel(W* __restrict__ buf, const W* __restrict__ arr,
                 const int32_t* head, int32_t* size, int cap, int n,
                 long long row_words) {
  const int h = *head;
  const int s = *size;
  __syncthreads();   // every thread holds s before thread 0 moves it
  if (threadIdx.x == 0) {
    *size = s + n;
  }
  copy_rows<W, true>(buf, const_cast<W*>(arr), (h + s) % cap, cap, n,
                     row_words);
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

// Each entry launches on `stream` without synchronising and returns
// cudaGetLastError() (0 on success).  `word` is the copy word in bytes
// (16, 4 or 1); row_bytes must be a multiple of it and both pointers
// aligned to it — the Python wrapper checks this.

int ring_pop(const void* buf, void* out, void* head, void* size, int cap,
             int n, long long row_bytes, int word, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rw = row_bytes / word;
  int32_t* h = static_cast<int32_t*>(head);
  int32_t* s = static_cast<int32_t*>(size);
  if (word == 16) {
    ring_pop_kernel<uint4><<<1, kCopyThreads, 0, st>>>(
        static_cast<const uint4*>(buf), static_cast<uint4*>(out), h, s, cap,
        n, rw);
  } else if (word == 4) {
    ring_pop_kernel<uint32_t><<<1, kCopyThreads, 0, st>>>(
        static_cast<const uint32_t*>(buf), static_cast<uint32_t*>(out), h, s,
        cap, n, rw);
  } else {
    ring_pop_kernel<uint8_t><<<1, kCopyThreads, 0, st>>>(
        static_cast<const uint8_t*>(buf), static_cast<uint8_t*>(out), h, s,
        cap, n, rw);
  }
  return static_cast<int>(cudaGetLastError());
}

int ring_push(void* buf, const void* arr, const void* head, void* size,
              int cap, int n, long long row_bytes, int word, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rw = row_bytes / word;
  const int32_t* h = static_cast<const int32_t*>(head);
  int32_t* s = static_cast<int32_t*>(size);
  if (word == 16) {
    ring_push_kernel<uint4><<<1, kCopyThreads, 0, st>>>(
        static_cast<uint4*>(buf), static_cast<const uint4*>(arr), h, s, cap,
        n, rw);
  } else if (word == 4) {
    ring_push_kernel<uint32_t><<<1, kCopyThreads, 0, st>>>(
        static_cast<uint32_t*>(buf), static_cast<const uint32_t*>(arr), h, s,
        cap, n, rw);
  } else {
    ring_push_kernel<uint8_t><<<1, kCopyThreads, 0, st>>>(
        static_cast<uint8_t*>(buf), static_cast<const uint8_t*>(arr), h, s,
        cap, n, rw);
  }
  return static_cast<int>(cudaGetLastError());
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
