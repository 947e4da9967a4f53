// Flash-decode for Hopper (sm_90a): one new token per sequence attends to
// its own prefix of a packed KV cache.
//
//   out[b, h, :] = softmax_j(q[b, h, :] . k[b, j, h / group, :] / sqrt(hd))
//                  @ v[b, j, h / group, :]      over j < kv_len[b]
//   out[b, h, :] = 0                            where kv_len[b] == 0
//
// Replaces the Pallas kernel _decode_kernel of the reference package
// (src/repro/kernels/decode_attention.py:35, entry decode_attention_fwd).
//
// What bounds it on this card: bytes.  Every valid K and V row is read
// once (2 * kv_len * nkv * hd elements per sequence) for ~4 flops per
// element, far below the ~295 flops/byte at which the tensor cores would
// be the limit.  So the design is about reading the cache once, in wide
// coalesced rows, from enough blocks to keep the memory system busy.
//
// Design.
// * The TPU kernel carries (m, l, acc) across a sequential grid over KV
//   blocks.  On Hopper the KV axis is split across blocks instead
//   (FlashDecoding): grid = (S_max / kSplit, nkv, B).  Each block owns
//   kSplit cache positions of one (b, kv_head), handles all `group` query
//   heads that share that KV head (so each K/V row is read once), and
//   writes an unnormalised partial (m, l, acc).  A second kernel combines
//   the partials of the splits that hold data.  8 slots x 8 KV heads is
//   64 (b, kv_head) pairs; with 8 splits of a 2048-row cache that is 512
//   blocks for 132 SMs.
// * kv_len is read from device memory by both kernels (no host sync).  A
//   split at or past kv_len returns before reading anything, so the
//   unfilled tail of the cache costs no traffic; the ragged last split
//   masks its rows.
// * The cache is read in the model's layout [B, S_max, nkv, hd] through
//   its strides: no transposed copy.
// * Inside a block: phase 1 gives each warp runs of keys, each lane hd/32
//   elements of a K row (one 4-16 byte load), and reduces the dot
//   products with shuffles into a score row in shared memory; phase 2
//   takes max and exp per query head; phase 3 gives each thread one
//   output column and streams the V rows once for all query heads.
// * fp32 throughout, as the plain version computes it; the output is
//   rounded to the input type once, at the end.
// * kv_len == 0 (a dead serving slot) gives exact zeros, as
//   decode_attention.py:79-82 does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSplit = 256;     // cache positions per block
constexpr int kThreads = 128;   // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 8;    // query heads per KV head
constexpr int kKeysPerIter = 4; // keys a warp has in flight in phase 1

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}

// Loads N consecutive elements (N * sizeof(T) in {4, 8, 16} bytes, aligned)
// into floats.
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* p, float* out) {
  constexpr int kBytes = N * sizeof(T);
  static_assert(kBytes == 4 || kBytes == 8 || kBytes == 16, "load width");
  union {
    uint4 u4;
    uint2 u2;
    uint32_t u1;
    T t[16 / sizeof(T)];
  } buf;
  if constexpr (kBytes == 16) {
    buf.u4 = *reinterpret_cast<const uint4*>(p);
  } else if constexpr (kBytes == 8) {
    buf.u2 = *reinterpret_cast<const uint2*>(p);
  } else {
    buf.u1 = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_f(buf.t[i]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int valid_len(const int* kv_len, int b,
                                         int s_max) {
  int n = kv_len[b];
  return n < 0 ? 0 : (n > s_max ? s_max : n);
}

// Strides are in elements; the last dimension of q/k/v is contiguous.
struct DecodeArgs {
  const void* q;   // [B, nh, hd]
  const void* k;   // [B, S_max, nkv, hd]
  const void* v;
  const int* kv_len;   // [B]
  void* out;           // [B, nh, hd], contiguous
  float* part_m;       // [B, nkv, n_split, group]
  float* part_l;
  float* part_acc;     // [B, nkv, n_split, group, hd]
  long long q_sb, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int s_max, nkv, group, n_split;
  float scale;
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(DecodeArgs a) {
  constexpr int kPerLane = HD / 32;
  constexpr int kRowsPar = kThreads / HD;   // phase-3 key subsets
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int len = valid_len(a.kv_len, b, a.s_max);
  const int s0 = split * kSplit;
  if (s0 >= len) return;                       // nothing cached here
  const int n = min(kSplit, len - s0);
  const int group = a.group;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  __shared__ float q_s[kMaxGroup][HD];
  __shared__ float p_s[kMaxGroup][kSplit];
  __shared__ float acc_s[kRowsPar > 1 ? kRowsPar - 1 : 1][kMaxGroup][HD];

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb;
  for (int i = tid; i < group * HD; i += kThreads) {
    const int g = i / HD, d = i % HD;
    q_s[g][d] = to_f(q[(long long)(kvh * group + g) * a.q_sh + d]) * a.scale;
  }
  __syncthreads();

  // phase 1: scores s[g][j] = q_g . k_j (scaled), for the n valid keys
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh +
                (long long)s0 * a.k_ss + lane * kPerLane;
  for (int j0 = warp * kKeysPerIter; j0 < n; j0 += kWarps * kKeysPerIter) {
    float kr[kKeysPerIter][kPerLane];
#pragma unroll
    for (int u = 0; u < kKeysPerIter; ++u) {
      if (j0 + u < n) {
        load_row<T, kPerLane>(kb + (long long)(j0 + u) * a.k_ss, kr[u]);
      } else {
#pragma unroll
        for (int e = 0; e < kPerLane; ++e) kr[u][e] = 0.f;
      }
    }
    for (int g = 0; g < group; ++g) {
      float qv[kPerLane];
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) qv[e] = q_s[g][lane * kPerLane + e];
#pragma unroll
      for (int u = 0; u < kKeysPerIter; ++u) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < kPerLane; ++e) dot = fmaf(qv[e], kr[u][e], dot);
        dot = warp_sum(dot);
        if (lane == 0 && j0 + u < n) p_s[g][j0 + u] = dot;
      }
    }
  }
  __syncthreads();

  // phase 2: per query head, max and exp over the split's valid keys
  float* m_out = a.part_m + (((long long)b * a.nkv + kvh) * a.n_split +
                             split) * group;
  float* l_out = a.part_l + (m_out - a.part_m);
  for (int g = warp; g < group; g += kWarps) {
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, p_s[g][j]);
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = expf(p_s[g][j] - m);
      p_s[g][j] = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) {
      m_out[g] = m;
      l_out[g] = l;
    }
  }
  __syncthreads();

  // phase 3: acc[g][d] = sum_j p[g][j] * v[j][d]; thread = (key subset, d)
  const int d = tid % HD, r = tid / HD;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh +
                (long long)s0 * a.v_ss + d;
  float acc[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) acc[g] = 0.f;
#pragma unroll 4
  for (int j = r; j < n; j += kRowsPar) {
    const float vj = to_f(vb[(long long)j * a.v_ss]);
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g)
      if (g < group) acc[g] = fmaf(p_s[g][j], vj, acc[g]);
  }
  if (kRowsPar > 1) {
    if (r > 0)
      for (int g = 0; g < group; ++g) acc_s[r - 1][g][d] = acc[g];
    __syncthreads();
    if (r == 0)
      for (int rr = 1; rr < kRowsPar; ++rr)
        for (int g = 0; g < group; ++g) acc[g] += acc_s[rr - 1][g][d];
  }
  if (r == 0) {
    float* acc_out = a.part_acc + (m_out - a.part_m) * HD;
    for (int g = 0; g < group; ++g) acc_out[g * HD + d] = acc[g];
  }
}

// Combines the partials of the splits that hold data; one block per
// (kv_head, b), one thread per output column.
template <typename T, int HD>
__global__ void __launch_bounds__(HD) decode_combine_kernel(DecodeArgs a) {
  const int kvh = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int len = valid_len(a.kv_len, b, a.s_max);
  const int group = a.group;
  const int used = (len + kSplit - 1) / kSplit;
  T* out = static_cast<T*>(a.out) +
           ((long long)b * a.nkv * group + kvh * group) * HD;
  const long long base = ((long long)b * a.nkv + kvh) * a.n_split;
  for (int g = 0; g < group; ++g) {
    float m = -INFINITY;
    for (int s = 0; s < used; ++s)
      m = fmaxf(m, a.part_m[(base + s) * group + g]);
    float l = 0.f, o = 0.f;
    for (int s = 0; s < used; ++s) {
      const long long i = (base + s) * group + g;
      const float w = expf(a.part_m[i] - m);
      l = fmaf(a.part_l[i], w, l);
      o = fmaf(a.part_acc[i * HD + d], w, o);
    }
    from_f(used == 0 ? 0.f : o / l, out + g * HD + d);
  }
}

template <typename T, int HD>
int launch(const DecodeArgs& a, int batch, cudaStream_t stream) {
  dim3 grid(a.n_split, a.nkv, batch);
  decode_split_kernel<T, HD><<<grid, kThreads, 0, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  decode_combine_kernel<T, HD><<<dim3(a.nkv, batch), HD, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the split and combine kernels on `stream` without
// synchronising; returns cudaGetLastError() (0 on success), or -1 for a
// (dtype, hd, group) this file was not built for.  dtype: 0 = float32,
// 1 = bfloat16.  part_* are scratch of n_split = ceil(s_max / 256) splits.
int decode_attention(const void* q, const void* k, const void* v,
                     const int* kv_len, void* out, float* part_m,
                     float* part_l, float* part_acc, long long q_sb,
                     long long q_sh, long long k_sb, long long k_ss,
                     long long k_sh, long long v_sb, long long v_ss,
                     long long v_sh, int batch, int s_max, int nkv,
                     int group, int hd, int dtype, float scale,
                     void* stream) {
  if (group < 1 || group > kMaxGroup) return -1;
  DecodeArgs a{q, k, v, kv_len, out, part_m, part_l, part_acc,
               q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
               s_max, nkv, group, (s_max + kSplit - 1) / kSplit, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 64) return launch<float, 64>(a, batch, st);
  if (dtype == 0 && hd == 128) return launch<float, 128>(a, batch, st);
  if (dtype == 1 && hd == 64) return launch<__nv_bfloat16, 64>(a, batch, st);
  if (dtype == 1 && hd == 128)
    return launch<__nv_bfloat16, 128>(a, batch, st);
  return -1;
}

int decode_attention_split() { return kSplit; }

const char* decode_attention_error_string(int code) {
  return code == -1 ? "unsupported dtype, head_dim or group"
                    : cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
