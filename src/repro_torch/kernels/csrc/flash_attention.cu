// Flash attention forward for Hopper (sm_90a), grouped-query, with causal
// and sliding-window masks:
//
//   s[i, j]   = q[b, i, h, :] . k[b, j, h / group, :] / sqrt(hd)
//   out[b, i, h, :] = softmax_j(s[i, j] where mask) @ v[b, j, h / group, :]
//   lse[b, h, i]    = m_i + log(l_i)       (running max, running sum)
//
//   mask(i, j) = (!causal || j <= i) && (!window || j > i - window)
//
// A row with no unmasked key gives out = 0 and lse = -1e30 + log(1), as
// flash_attention.py:105-110 does.
//
// Replaces the Pallas kernel _fwd_kernel of the reference package
// (src/repro/kernels/flash_attention.py:45, entry flash_attention_fwd).
//
// What bounds it on this card: operations.  A (64 x 64) score tile costs
// 2 * 64 * 64 * hd flops for 64 * hd K elements read, and the causal
// prefill of one bucket is 2 * nh * Sq * Sk * hd flops against a few MB of
// q/k/v, so it sits well above the ~295 flops/byte line.  This first
// version does its products with fp32 FMAs on the CUDA cores (67 TFLOP/s
// peak), not the tensor cores; moving the two products onto wgmma is
// later work (the bound in PERF.md is taken against the bf16 tensor-core
// rate, so the gap shows).
//
// Design.
// * One block per (q tile of 64 rows, query head, batch row); a loop over
//   KV tiles of 64 takes the place of the TPU's sequential grid axis, with
//   the running (m, l, acc) in registers.  K/V rows are those of KV head
//   h / group (GQA).
// * Tiles the causal or window mask hides entirely are skipped before any
//   load, as flash_attention.py:62-70 skips them.
// * Any Sq and Sk: rows past Sq and keys past Sk are loaded as zeros,
//   masked, and never stored, so no shape needs padding or a plain path.
// * q/k/v are read in the model's layout [B, S, heads, hd] through their
//   strides, 16 bytes a thread; the output is written in the same layout,
//   so the caller needs no transposes.
// * Tiles live in shared memory as fp32 with one column of padding, so the
//   16 threads that read 16 different K rows at one column hit 16 banks.
//   256 threads: thread (ty, tx) owns rows 4ty..4ty+3 and columns tx + 16j
//   of the score tile and of the output; row max and row sum reduce over
//   the 16 tx lanes with shuffles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}

struct FlashArgs {
  const void* q;   // [B, Sq, nh, hd]
  const void* k;   // [B, Sk, nkv, hd]
  const void* v;
  void* out;       // [B, Sq, nh, hd], contiguous
  float* lse;      // [B, nh, Sq], contiguous
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int sq, sk, nh, group;
  int causal, has_window, window;
  float scale;
};

// Copies rows [row0, row0 + kRows) of one head into a padded fp32 tile;
// rows at or past n_rows are zeros.  16 bytes a load.
template <typename T, int HD, int kRows>
__device__ __forceinline__ void load_tile(float* tile, const T* base,
                                          long long row_stride, int row0,
                                          int n_rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = HD / kVec;
  for (int i = threadIdx.x; i < kRows * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    float* dst = tile + r * (HD + 1) + c;
    if (row0 + r < n_rows) {
      union {
        uint4 u;
        T t[kVec];
      } buf;
      buf.u = *reinterpret_cast<const uint4*>(
          base + (long long)(row0 + r) * row_stride + c);
#pragma unroll
      for (int e = 0; e < kVec; ++e) dst[e] = to_f(buf.t[e]);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) dst[e] = 0.f;
    }
  }
}

__device__ __forceinline__ float row_reduce_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_reduce_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(FlashArgs a) {
  constexpr int kCols = HD / 16;     // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                            // [kBQ][HD + 1]
  float* k_s = q_s + kBQ * (HD + 1);            // [kBK][HD + 1]
  float* v_s = k_s + kBK * (HD + 1);            // [kBK][HD + 1]
  float* p_s = v_s + kBK * (HD + 1);            // [kBQ][kBK + 1]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kBQ;
  const int kvh = h / a.group;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  load_tile<T, HD, kBQ>(q_s, qb, a.q_ss, q0, a.sq);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  const int n_kt = (a.sk + kBK - 1) / kBK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    // whole-tile skip (uniform over the block)
    if (a.causal && k0 > q0 + kBQ - 1) break;
    if (a.has_window && k0 + kBK - 1 <= q0 - a.window) continue;

    __syncthreads();   // the previous tile's K/V/P reads are done
    load_tile<T, HD, kBK>(k_s, kb, a.k_ss, k0, a.sk);
    load_tile<T, HD, kBK>(v_s, vb, a.v_ss, k0, a.sk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qa[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = q_s[(ty * 4 + i) * (HD + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = k_s[(tx + 16 * j) * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < a.sk && (!a.causal || kpos <= qpos) &&
                (!a.has_window || kpos > qpos - a.window);
        s[i][j] = ok[j] ? s[i][j] * a.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_reduce_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        p_s[(ty * 4 + i) * (kBK + 1) + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + row_reduce_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float p[4], vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = p_s[(ty * 4 + i) * (kBK + 1) + c];
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc)
        vv[cc] = v_s[c * (HD + 1) + tx + 16 * cc];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc)
          acc[i][cc] = fmaf(p[i], vv[cc], acc[i][cc]);
    }
  }

  T* ob = static_cast<T*>(a.out) + (long long)b * a.sq * a.nh * HD +
          (long long)h * HD;
  float* lb = a.lse + ((long long)b * a.nh + h) * a.sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= a.sq) continue;
    const float safe = l[i] == 0.f ? 1.f : l[i];
    T* orow = ob + (long long)qpos * a.nh * HD;
#pragma unroll
    for (int c = 0; c < kCols; ++c) from_f(acc[i][c] / safe, orow + tx + 16 * c);
    if (tx == 0) lb[qpos] = m[i] + logf(safe);
  }
}

template <typename T, int HD>
int launch(const FlashArgs& a, int batch, cudaStream_t stream) {
  constexpr size_t kSmem =
      sizeof(float) * ((kBQ + 2 * kBK) * (HD + 1) + kBQ * (kBK + 1));
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((a.sq + kBQ - 1) / kBQ, a.nh, batch);
  flash_fwd_kernel<T, HD><<<grid, kThreads, kSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` without synchronising; returns cudaGetLastError()
// (0 on success), or -1 for a (dtype, hd) this file was not built for.
// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the last
// dimension of q/k/v is contiguous and 16-byte aligned.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, float* lse, long long q_sb,
                        long long q_ss, long long q_sh, long long k_sb,
                        long long k_ss, long long k_sh, long long v_sb,
                        long long v_ss, long long v_sh, int batch, int sq,
                        int sk, int nh, int group, int hd, int dtype,
                        int causal, int has_window, int window, float scale,
                        void* stream) {
  FlashArgs a{q, k, v, out, lse, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
              v_sb, v_ss, v_sh, sq, sk, nh, group, causal, has_window,
              window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && hd == 64) return launch<float, 64>(a, batch, st);
  if (dtype == 0 && hd == 128) return launch<float, 128>(a, batch, st);
  if (dtype == 1 && hd == 64) return launch<__nv_bfloat16, 64>(a, batch, st);
  if (dtype == 1 && hd == 128)
    return launch<__nv_bfloat16, 128>(a, batch, st);
  return -1;
}

const char* flash_attention_error_string(int code) {
  return code == -1 ? "unsupported dtype or head_dim"
                    : cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
