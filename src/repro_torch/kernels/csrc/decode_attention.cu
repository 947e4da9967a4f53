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
// be the limit.  So the design is about keeping many bytes in flight:
// many live blocks, each with its whole K and V tiles on the way at once.
//
// Design.
// * The TPU kernel carries (m, l, acc) across a sequential grid over KV
//   blocks.  On Hopper the KV axis is split across blocks instead
//   (FlashDecoding): grid = (S_max / 64, nkv, B).  Each block owns 64
//   cache positions of one (b, kv_head), handles all `group` query heads
//   that share that KV head (so each K/V row is read once), and writes an
//   unnormalised partial (m, l, acc).  At the serving shape (8 slots of a
//   2048-row cache, 8 KV heads, 6,013 live rows) that is ~784 live blocks
//   for 132 SMs, where 256-row splits gave 216.
// * decode_partial_kernel issues its K tile and then its V tile into
//   shared memory by cp.async, 16 bytes a thread, as two groups: the V
//   tile lands while the scores are formed from K.
// * Scores: 8 elements a lane (one 16-byte bf16 load from shared memory),
//   HDP / 8 lanes a row, a 4-shuffle (HDP 128) or 3-shuffle (HDP 64)
//   reduction, every query head of the group from q held in registers.
// * Head widths 64, 96 and 128.  A row of the shared tiles is HDP wide,
//   hd rounded up to a power of two (96 -> 128), so the lane map above
//   holds for every width: the copy reads only the hd columns of the
//   cache (the bytes from HBM are those of hd) and zero-fills columns hd
//   .. HDP - 1 (cp.async with a source size of 0); the lanes of q past hd
//   hold zeros, and only hd columns are stored out.
//   The kernel is instantiated for groups of up to 2, 4, 8 and 16 heads,
//   so a small group (Qwen3's 2) holds no registers for heads it does not
//   have: 7 blocks fit an SM, and the serving shape's live blocks fit in
//   one wave.  A group over 16 (the reference's kernel takes any) is
//   launched by the wrapper once a chunk of at most 16 query heads of
//   each KV head (decode_attention.py, head_chunks).
// * P . V: each thread holds 8 adjacent output columns for every query
//   head and walks its share of the V rows, 16 bytes a row from shared
//   memory; the shares are summed by shuffles and once through shared
//   memory (the K tile's space; for 16 bf16 heads the K and V tiles',
//   after a barrier, since the V tile is still being read).
// * decode_merge_kernel combines the partials of the splits that hold
//   data: a warp a query head turns the splits' maxima into weights, then
//   the splits' partials of each 4 output columns are summed by several
//   threads at once (group * hd / 4 outputs over 256 threads; more
//   outputs than threads, as groups over 8 at hd 128 give, in passes of
//   256, one thread an output).
// * kv_len is read from device memory by both kernels (no host sync).  A
//   split at or past kv_len returns before reading anything, so the
//   unfilled tail of the cache costs no traffic; the ragged last split
//   copies and reads only its valid rows.
// * The cache is read in the model's layout [B, S_max, nkv, hd] through
//   its strides: no transposed copy.
// * fp32 accumulation throughout, as the plain version computes; the
//   output is rounded to the input type once, at the end.
// * kv_len == 0 (a dead serving slot) gives exact zeros, as
//   decode_attention.py:79-82 does.
// * On request (a non-null lse) the merge also writes each row's
//   log-sum-exp m + log(l) from the statistics it already holds, -inf for
//   a row with no valid key, and writes out in float32, unrounded: a
//   cache whose sequence is split over ranks runs the kernel on each
//   rank's rows, and the ranks' (out, lse) pairs are merged in float32
//   and rounded once (kernels/ops.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSplit = 64;      // cache positions per block
constexpr int kThreads = 128;   // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 16;   // query heads per KV head a launch
constexpr int kElem = 8;        // elements a lane owns in a row
constexpr int kMergeThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}

// 8 consecutive elements at p (16-byte aligned) from shared or global
// memory, as floats: one 16-byte load for bf16, two for fp32.
template <typename T>
__device__ __forceinline__ void load8(const T* p, float* out) {
  constexpr int kLoads = kElem * sizeof(T) / 16;
#pragma unroll
  for (int l = 0; l < kLoads; ++l) {
    union {
      uint4 u;
      T t[16 / sizeof(T)];
    } buf;
    buf.u = reinterpret_cast<const uint4*>(p)[l];
#pragma unroll
    for (int i = 0; i < 16 / (int)sizeof(T); ++i)
      out[l * (16 / sizeof(T)) + i] = to_f(buf.t[i]);
  }
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
// 16 zero bytes at dst through the same async path (source size 0: src
// is not read)
__device__ __forceinline__ void cp16_zero(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, 0;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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
  void* out;           // [B, nh, hd], contiguous; float32 when lse is set
  float* part_m;       // [B, nkv, n_split, group]; the merge's weights
  float* part_l;
  float* part_acc;     // [B, nkv, n_split, group, hd]
  float* lse;          // [B, nh] log-sum-exp of each row's scores, or null
  long long q_sb, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int s_max, nkv, group, n_split;
  float scale;
};

// The shared tiles' row width for head width HD: HD rounded up to a power
// of two (64 -> 64, 96 -> 128, 128 -> 128).
template <int HD>
__host__ __device__ constexpr int padded() {
  return HD <= 64 ? 64 : 128;
}

// Copies rows [0, n) of a [rows, HD] tile with row stride `stride` into a
// contiguous shared tile of rows HDP wide, 16 bytes a thread; columns HD ..
// HDP - 1 become zeros.
template <typename T, int HD>
__device__ __forceinline__ void copy_rows(T* dst, const T* src,
                                          long long stride, int n) {
  constexpr int HDP = padded<HD>();
  constexpr int kChunks = HDP * sizeof(T) / 16;
  constexpr int kPer = 16 / sizeof(T);
  for (int i = threadIdx.x; i < n * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * kPer;
    const T* from = src + (long long)r * stride;
    if (HD == HDP || c < HD)
      cp16(dst + r * HDP + c, from + c);
    else
      cp16_zero(dst + r * HDP + c, from);
  }
}

// G: the most query heads a KV head this instantiation takes (2, 4, 8 or
// 16), so that q and the accumulators of a smaller group take no
// registers.
template <typename T, int HD, int G>
size_t partial_smem() {
  return 2 * sizeof(T) * kSplit * padded<HD>() + sizeof(float) * G * kSplit;
}

template <typename T, int HD, int G>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(DecodeArgs a) {
  constexpr int HDP = padded<HD>();               // a shared row's width
  constexpr int kLanes = HDP / kElem;             // lanes a row: 16 or 8
  constexpr int kRowsWarp = 32 / kLanes;          // rows a warp a step
  constexpr int kRowStep = kRowsWarp * kWarps;
  constexpr int kSubsets = kThreads / kLanes;     // P.V row shares
  // the P.V reduction's space: the K tile's, or for 16 bf16 heads the K
  // and V tiles' (after a barrier: the V tile is read up to then)
  constexpr bool kRedPastK =
      kWarps * G * HDP * 4 > kSplit * HDP * (int)sizeof(T);
  static_assert(G <= kMaxGroup &&
                    kWarps * G * HDP * 4 <= 2 * kSplit * HDP * (int)sizeof(T),
                "the P.V reduction reuses the K and V tiles' space");
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int len = valid_len(a.kv_len, b, a.s_max);
  const int s0 = split * kSplit;
  if (s0 >= len) return;                       // nothing cached here
  const int n = min(kSplit, len - s0);
  const int group = a.group;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);                       // [kSplit][HDP]
  T* vs = ks + kSplit * HDP;                                // [kSplit][HDP]
  float* p_s = reinterpret_cast<float*>(vs + kSplit * HDP); // [group][kSplit]
  float* red = reinterpret_cast<float*>(ks);  // [kWarps][G][HDP], later

  copy_rows<T, HD>(ks, static_cast<const T*>(a.k) + b * a.k_sb +
                           kvh * a.k_sh + (long long)s0 * a.k_ss,
                   a.k_ss, n);
  cp_commit();
  copy_rows<T, HD>(vs, static_cast<const T*>(a.v) + b * a.v_sb +
                           kvh * a.v_sh + (long long)s0 * a.v_ss,
                   a.v_ss, n);
  cp_commit();

  // q of every head of the group: this lane's 8 columns, scaled (zeros
  // past hd)
  const int col = (lane % kLanes) * kElem;
  float qr[G][kElem];
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + col;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g < group) {
      if (HD == HDP || col < HD) {
        load8<T>(q + (long long)(kvh * group + g) * a.q_sh, qr[g]);
      } else {
#pragma unroll
        for (int e = 0; e < kElem; ++e) qr[g][e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < kElem; ++e) qr[g][e] *= a.scale;
    }
  }

  // scores s[g][j] = q_g . k_j for the n valid keys
  cp_wait<1>();
  __syncthreads();
  for (int j0 = 0; j0 < n; j0 += kRowStep) {
    const int j = j0 + warp * kRowsWarp + lane / kLanes;
    float kr[kElem];
    if (j < n) {
      load8<T>(ks + j * HDP + col, kr);
    } else {
#pragma unroll
      for (int e = 0; e < kElem; ++e) kr[e] = 0.f;
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g < group) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < kElem; ++e) dot = fmaf(qr[g][e], kr[e], dot);
#pragma unroll
        for (int o = kLanes / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        if (lane % kLanes == 0 && j < n) p_s[g * kSplit + j] = dot;
      }
    }
  }
  cp_wait<0>();
  __syncthreads();

  // per query head, max and exp over the split's valid keys
  float* m_out = a.part_m + (((long long)b * a.nkv + kvh) * a.n_split +
                             split) * group;
  float* l_out = a.part_l + (m_out - a.part_m);
  for (int g = warp; g < group; g += kWarps) {
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, p_s[g * kSplit + j]);
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = expf(p_s[g * kSplit + j] - m);
      p_s[g * kSplit + j] = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) {
      m_out[g] = m;
      l_out[g] = l;
    }
  }
  __syncthreads();

  // acc[g][col .. col + 8] = sum_j p[g][j] v[j][col ..]; thread = (row
  // share, 8 columns)
  const int c8 = (tid % kLanes) * kElem, sub = tid / kLanes;
  float acc[G][kElem];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < kElem; ++e) acc[g][e] = 0.f;
#pragma unroll 2
  for (int j = sub; j < n; j += kSubsets) {
    float vr[kElem];
    load8<T>(vs + j * HDP + c8, vr);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g < group) {
        const float p = p_s[g * kSplit + j];
#pragma unroll
        for (int e = 0; e < kElem; ++e) acc[g][e] = fmaf(p, vr[e], acc[g][e]);
      }
    }
  }
  // the row shares of a warp by shuffles, then the warps through smem
#pragma unroll
  for (int g = 0; g < G; ++g)
    if (g < group)
#pragma unroll
      for (int e = 0; e < kElem; ++e)
#pragma unroll
        for (int o = kLanes; o < 32; o <<= 1)
          acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
  if constexpr (kRedPastK) __syncthreads();   // every V row read
  if (lane < kLanes) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g < group) {
        float4* r = reinterpret_cast<float4*>(
            red + (warp * G + g) * HDP + c8);
        r[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
        r[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
      }
    }
  }
  __syncthreads();
  float4* acc_out = reinterpret_cast<float4*>(a.part_acc +
                                              (m_out - a.part_m) * HD);
  for (int i = tid; i < group * HD / 4; i += kThreads) {
    const int g = i / (HD / 4), d = (i % (HD / 4)) * 4;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float4 r =
          *reinterpret_cast<const float4*>(red + (w * G + g) * HDP + d);
      s.x += r.x;
      s.y += r.y;
      s.z += r.z;
      s.w += r.w;
    }
    acc_out[i] = s;
  }
}

// Combines the partials of the splits that hold data; one block per
// (kv_head, b).  Each split's max becomes its weight exp(m_s - M) / L in
// place (part_m); then each output float4 is summed over the splits by
// kMergeThreads / (group * HD / 4) threads at once, whose shares meet in
// shared memory (more outputs than threads: passes of kMergeThreads
// outputs, a thread each).
template <typename T, int HD>
__global__ void __launch_bounds__(kMergeThreads)
decode_merge_kernel(DecodeArgs a) {
  __shared__ float4 share[kMergeThreads];
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = valid_len(a.kv_len, b, a.s_max);
  const int group = a.group;
  const int used = (len + kSplit - 1) / kSplit;
  const long long row0 = ((long long)b * a.nkv * group + kvh * group) * HD;
  const long long base = ((long long)b * a.nkv + kvh) * a.n_split;
  for (int g = warp; g < group; g += kMergeThreads / 32) {
    float m = -INFINITY;
    for (int s = lane; s < used; s += 32)
      m = fmaxf(m, a.part_m[(base + s) * group + g]);
    m = warp_max(m);
    float l = 0.f;
    for (int s = lane; s < used; s += 32) {
      const long long i = (base + s) * group + g;
      l = fmaf(a.part_l[i], expf(a.part_m[i] - m), l);
    }
    l = warp_sum(l);            // >= 1: the split holding the max has p = 1
    if (a.lse != nullptr && lane == 0)   // used == 0: no key, -inf
      a.lse[((long long)b * a.nkv + kvh) * group + g] =
          used > 0 ? m + logf(l) : -INFINITY;
    for (int s = lane; s < used; s += 32) {
      const long long i = (base + s) * group + g;
      a.part_m[i] = expf(a.part_m[i] - m) / l;
    }
  }
  __syncthreads();
  const int n_out = group * HD / 4;              // float4 outputs
  const int span = min(n_out, kMergeThreads);    // outputs a pass
  const int per = kMergeThreads / span;          // threads an output
  for (int o0 = 0; o0 < n_out; o0 += span) {
    const int o = o0 + tid % span, k = tid / span;
    const int g = o / (HD / 4), d = (o % (HD / 4)) * 4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k < per && o < n_out) {
      for (int s = k; s < used; s += per) {
        const long long i = (base + s) * group + g;
        const float w = a.part_m[i];
        const float4 v = *reinterpret_cast<const float4*>(a.part_acc +
                                                          i * HD + d);
        acc.x = fmaf(v.x, w, acc.x);
        acc.y = fmaf(v.y, w, acc.y);
        acc.z = fmaf(v.z, w, acc.z);
        acc.w = fmaf(v.w, w, acc.w);
      }
    }
    share[tid] = acc;
    __syncthreads();
    if (k == 0 && o < n_out) {
      for (int kk = 1; kk < per; ++kk) {
        const float4 v = share[kk * span + tid % span];
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
      const long long at = row0 + g * HD + d;   // used == 0: exact zeros
      if (a.lse != nullptr) {
        *reinterpret_cast<float4*>(static_cast<float*>(a.out) + at) = acc;
      } else {
        T* po = static_cast<T*>(a.out) + at;
        from_f(acc.x, po);
        from_f(acc.y, po + 1);
        from_f(acc.z, po + 2);
        from_f(acc.w, po + 3);
      }
    }
    if (o0 + span < n_out) __syncthreads();     // share is written again
  }
}

template <typename T, int HD, int G>
int launch_g(const DecodeArgs& a, int batch, cudaStream_t stream) {
  const size_t smem = partial_smem<T, HD, G>();
  cudaError_t e = cudaFuncSetAttribute(
      decode_partial_kernel<T, HD, G>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(a.n_split, a.nkv, batch);
  decode_partial_kernel<T, HD, G><<<grid, kThreads, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  decode_merge_kernel<T, HD><<<dim3(a.nkv, batch), kMergeThreads, 0,
                               stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch(const DecodeArgs& a, int batch, cudaStream_t stream) {
  if (a.group <= 2) return launch_g<T, HD, 2>(a, batch, stream);
  if (a.group <= 4) return launch_g<T, HD, 4>(a, batch, stream);
  if (a.group <= 8) return launch_g<T, HD, 8>(a, batch, stream);
  return launch_g<T, HD, 16>(a, batch, stream);
}

template <typename T, int HD>
long long smem_of(int group) {
  if (group <= 2) return partial_smem<T, HD, 2>();
  if (group <= 4) return partial_smem<T, HD, 4>();
  if (group <= 8) return partial_smem<T, HD, 8>();
  return partial_smem<T, HD, 16>();
}

}  // namespace

extern "C" {

// Launches the partial and merge kernels on `stream` without
// synchronising; returns cudaGetLastError() (0 on success), -1 for a
// (dtype, hd, group) this file was not built for, -2 for a split size
// other than 64 or a split count other than ceil(s_max / 64).  dtype: 0 =
// float32, 1 = bfloat16.  part_* are scratch of n_split splits.  lse, when
// not null, receives each row's log-sum-exp [B, nh] in float32 (-inf for a
// row with no valid key), and out is then float32 whatever the dtype: what
// merges partial results over a cache whose sequence is split across
// ranks, rounding once after the merge.
int decode_attention(const void* q, const void* k, const void* v,
                     const int* kv_len, void* out, float* part_m,
                     float* part_l, float* part_acc, float* lse,
                     long long q_sb,
                     long long q_sh, long long k_sb, long long k_ss,
                     long long k_sh, long long v_sb, long long v_ss,
                     long long v_sh, int batch, int s_max, int nkv,
                     int group, int hd, int dtype, int split, int n_split,
                     float scale, void* stream) {
  if (group < 1 || group > kMaxGroup) return -1;
  if (split != kSplit || n_split != (s_max + kSplit - 1) / kSplit) return -2;
  DecodeArgs a{q, k, v, kv_len, out, part_m, part_l, part_acc, lse,
               q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
               s_max, nkv, group, n_split, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 64) return launch<float, 64>(a, batch, st);
  if (dtype == 0 && hd == 96) return launch<float, 96>(a, batch, st);
  if (dtype == 0 && hd == 128) return launch<float, 128>(a, batch, st);
  if (dtype == 1 && hd == 64) return launch<__nv_bfloat16, 64>(a, batch, st);
  if (dtype == 1 && hd == 96) return launch<__nv_bfloat16, 96>(a, batch, st);
  if (dtype == 1 && hd == 128)
    return launch<__nv_bfloat16, 128>(a, batch, st);
  return -1;
}

// Dynamic shared memory of a decode_partial_kernel block (dtype, hd as
// above, group); 0 for a pair not built.
long long decode_attention_smem_bytes(int dtype, int hd, int group) {
  if (dtype == 0 && hd == 64) return smem_of<float, 64>(group);
  if (dtype == 0 && hd == 96) return smem_of<float, 96>(group);
  if (dtype == 0 && hd == 128) return smem_of<float, 128>(group);
  if (dtype == 1 && hd == 64) return smem_of<__nv_bfloat16, 64>(group);
  if (dtype == 1 && hd == 96) return smem_of<__nv_bfloat16, 96>(group);
  if (dtype == 1 && hd == 128) return smem_of<__nv_bfloat16, 128>(group);
  return 0;
}

const char* decode_attention_error_string(int code) {
  if (code == -1) return "unsupported dtype, head_dim or group";
  if (code == -2)
    return "split size or split count the kernel was not built for";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
