// Mamba-2 SSD chunked scan for Hopper (sm_90a), forward:
//
//   per batch row b, head h (group g = h / (H / G)), chunk c of Q steps:
//   cum[i]    = dA[0] + ... + dA[i]                       (inclusive)
//   y[i, :]   = sum_{j <= i} (C_i . B_j) exp(cum[i] - cum[j]) xdt[j, :]
//             + exp(cum[i]) * (state_in @ C_i)            (state_in: [P, N])
//   state_out = exp(cum[Q-1]) * state_in
//             + sum_j exp(cum[Q-1] - cum[j]) xdt[j, :]^T B_j
//
// y is written in fp32; the state entering chunk 0 is s0 and the state
// leaving the last chunk is the final state.  The D skip and the dt
// weighting of x happen outside (ssd_scan.py), as in the reference.
//
// Replaces the Pallas kernel _ssd_kernel of the reference package
// (src/repro/kernels/ssd_scan.py:43, entry ssd_scan_fwd at :92).
//
// What bounds it on this card: operations.  At Mamba2-130M's training
// shape (Q = 256, P = 64, N = 128) a chunk needs ~21 MFLOP (the causal
// half of C B^T and of its product with xdt, the state read and the
// chunk's state) for ~110 KB of its inputs and outputs, ~190 flops a
// byte, against fp32's 67 TFLOP/s on the CUDA cores.  This first version
// does its products with fp32 FMAs from shared memory; tensor cores
// (TF32 or bf16 wgmma), TMA and sharing C B^T across the heads of a group
// are later work.
//
// Design: the TPU kernel carries the [P, N] state in VMEM across a
// sequential chunk axis; a GPU grid has no order, so the state-passing
// form of the algorithm (arXiv:2405.21060 section 7) runs as three
// launches on one stream:
//   (a) ssd_chunk_state: one block per (chunk, head, batch row) writes the
//       chunk's own state sum_j exp(cum_end - cum_j) xdt_j^T B_j into a
//       [B, nc, H, P, N] scratch and exp(cum_end) into a [B, nc, H] one;
//   (b) ssd_state_pass: one block per (1024 state elements, head, batch
//       row) walks the nc chunks in order, replacing each chunk's own
//       state in the scratch by the state entering it, and writes the
//       final state;
//   (c) ssd_chunk_scan: one block per (64 rows of a chunk, chunk, head,
//       batch row) writes y once: the inter-chunk read of the entering
//       state, then the causal intra-chunk term over the chunk's 64-row
//       key tiles up to its own, skipping the tiles above the diagonal.
// Never more than a 64 x 64 tile of C B^T is formed (the whole [Q, Q]
// tile at Q = 256 would be 256 KB of fp32, more than an SM has).
//
// Numerics.  The decays come from differences of the running sum cum,
// which at the model's own inputs reaches -1e3 within a chunk; in fp32
// the difference of two such sums loses ~1e-4 of its value to rounding.
// Each block therefore forms cum in double (one warp, 8 steps a lane and
// a shuffle scan), and every exponent cum[i] - cum[j] is taken in double
// before the fp32 exp.  The exponent is masked, not the exp: exp is only
// evaluated for j <= i, so no inf or NaN appears.
//
// Layout: xdt [B, S, H, P], dA [B, S, H] and B/C [B, S, G, N] are read in
// the model's layout through their strides (last dimension contiguous,
// 16-byte aligned: float4 loads); y [B, S, H, P] and the states are
// contiguous.  S is a multiple of the chunk (the wrapper pads), Q <= 256.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;        // rows of a query or key tile
constexpr int kMaxChunk = 256;
constexpr int kPerLane = kMaxChunk / 32;

struct SsdArgs {
  const float* xdt;   // [B, S, H, P]
  const float* dA;    // [B, S, H]
  const float* bm;    // [B, S, G, N]
  const float* cm;    // [B, S, G, N]
  const float* s0;    // [B, H, P, N], contiguous
  float* y;           // [B, S, H, P], contiguous
  float* s_out;       // [B, H, P, N], contiguous
  float* states;      // [B, nc, H, P, N] scratch, contiguous
  float* decay;       // [B, nc, H] scratch: exp(cum[Q - 1])
  long long x_sb, x_ss, x_sh;
  long long a_sb, a_ss, a_sh;
  long long b_sb, b_ss, b_sg;
  long long c_sb, c_ss, c_sg;
  int seq, heads, group, chunk, nc;
};

// Inclusive prefix sums of the chunk's dA (stride a_ss) in double, into
// cum[0 .. Q).  Warp 0 does it; ends with a block barrier.
__device__ __forceinline__ void chunk_cumsum(const float* dA, long long a_ss,
                                             int q, double* cum) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    double part[kPerLane];
    double run = 0.0;
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) {
      const int t = lane * kPerLane + e;
      run += t < q ? static_cast<double>(dA[t * a_ss]) : 0.0;
      part[e] = run;
    }
    double incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double n = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += n;
    }
    double excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.0;
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) {
      const int t = lane * kPerLane + e;
      if (t < q) cum[t] = part[e] + excl;
    }
  }
  __syncthreads();
}

// Copies rows [row0, row0 + kRows) (of n_rows) of a [rows, W] fp32 matrix
// with row stride `stride` into a tile padded to W + 1 columns, each row
// scaled by scale[r] when scale is given; rows at or past n_rows are
// zeros.  16 bytes a load.
template <int W>
__device__ __forceinline__ void load_rows(float* tile, const float* base,
                                          long long stride, int row0,
                                          int n_rows,
                                          const float* scale = nullptr) {
  constexpr int kPerRow = W / 4;
  for (int i = threadIdx.x; i < kRows * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * 4;
    float* dst = tile + r * (W + 1) + c;
    if (row0 + r < n_rows) {
      const float4 v = *reinterpret_cast<const float4*>(
          base + (long long)(row0 + r) * stride + c);
      const float s = scale ? scale[r] : 1.f;
      dst[0] = v.x * s;
      dst[1] = v.y * s;
      dst[2] = v.z * s;
      dst[3] = v.w * s;
    } else {
      dst[0] = dst[1] = dst[2] = dst[3] = 0.f;
    }
  }
}

// (a) the chunk's own state, [P, N]: thread (ty, tx) owns rows ty + 16a
// and columns tx + 16k.
template <int P, int N>
__global__ void __launch_bounds__(kThreads) ssd_chunk_state(SsdArgs a) {
  extern __shared__ double smem_d[];
  double* cum = smem_d;                                      // [kMaxChunk]
  float* tail = reinterpret_cast<float*>(cum + kMaxChunk);   // [kRows]
  float* xs = tail + kRows;                                  // [kRows][P+1]
  float* bs = xs + kRows * (P + 1);                          // [kRows][N+1]

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int q = a.chunk, s0 = c * q, g = h / a.group;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* xb = a.xdt + b * a.x_sb + (long long)s0 * a.x_ss + h * a.x_sh;
  const float* bb = a.bm + b * a.b_sb + (long long)s0 * a.b_ss + g * a.b_sg;
  chunk_cumsum(a.dA + b * a.a_sb + (long long)s0 * a.a_ss + h * a.a_sh,
               a.a_ss, q, cum);
  const double cum_end = cum[q - 1];

  float acc[P / 16][N / 16];
#pragma unroll
  for (int i = 0; i < P / 16; ++i)
#pragma unroll
    for (int k = 0; k < N / 16; ++k) acc[i][k] = 0.f;

  for (int j0 = 0; j0 < q; j0 += kRows) {
    __syncthreads();   // the previous tile's reads are done
    if (threadIdx.x < kRows) {
      const int j = j0 + threadIdx.x;
      tail[threadIdx.x] =
          j < q ? expf(static_cast<float>(cum_end - cum[j])) : 0.f;
    }
    __syncthreads();
    load_rows<P>(xs, xb, a.x_ss, j0, q, tail);
    load_rows<N>(bs, bb, a.b_ss, j0, q);
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kRows; ++r) {
      float xv[P / 16], bv[N / 16];
#pragma unroll
      for (int i = 0; i < P / 16; ++i) xv[i] = xs[r * (P + 1) + ty + 16 * i];
#pragma unroll
      for (int k = 0; k < N / 16; ++k) bv[k] = bs[r * (N + 1) + tx + 16 * k];
#pragma unroll
      for (int i = 0; i < P / 16; ++i)
#pragma unroll
        for (int k = 0; k < N / 16; ++k)
          acc[i][k] = fmaf(xv[i], bv[k], acc[i][k]);
    }
  }

  const long long slot = ((long long)b * a.nc + c) * a.heads + h;
  float* out = a.states + slot * (P * N);
#pragma unroll
  for (int i = 0; i < P / 16; ++i)
#pragma unroll
    for (int k = 0; k < N / 16; ++k)
      out[(ty + 16 * i) * N + tx + 16 * k] = acc[i][k];
  if (threadIdx.x == 0) a.decay[slot] = expf(static_cast<float>(cum_end));
}

// (b) the state entering each chunk, in place of the chunk's own state,
// and the final state: 4 consecutive state elements a thread.
template <int P, int N>
__global__ void __launch_bounds__(kThreads) ssd_state_pass(SsdArgs a) {
  const int e = (blockIdx.x * kThreads + threadIdx.x) * 4;
  if (e >= P * N) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * a.heads + h;
  float4 st = *reinterpret_cast<const float4*>(a.s0 + bh * (P * N) + e);
  for (int c = 0; c < a.nc; ++c) {
    const long long slot = ((long long)b * a.nc + c) * a.heads + h;
    float4* p = reinterpret_cast<float4*>(a.states + slot * (P * N) + e);
    const float4 own = *p;
    *p = st;
    const float d = a.decay[slot];
    st.x = fmaf(st.x, d, own.x);
    st.y = fmaf(st.y, d, own.y);
    st.z = fmaf(st.z, d, own.z);
    st.w = fmaf(st.w, d, own.w);
  }
  *reinterpret_cast<float4*>(a.s_out + bh * (P * N) + e) = st;
}

// (c) y for 64 rows of one chunk: thread (ty, tx) owns rows ty + 16i and
// columns tx + 16k of y, and rows ty + 16i, columns tx + 16k of each
// 64 x 64 score tile.
template <int P, int N>
__global__ void __launch_bounds__(kThreads) ssd_chunk_scan(SsdArgs a) {
  extern __shared__ double smem_d[];
  double* cum = smem_d;                                      // [kMaxChunk]
  float* cs = reinterpret_cast<float*>(cum + kMaxChunk);     // [kRows][N+1]
  float* bs = cs + kRows * (N + 1);                          // [kRows][N+1]
  float* xs = bs + kRows * (N + 1);                          // [kRows][P+1]
  float* ps = xs + kRows * (P + 1);                          // [kRows][kRows+1]

  const int n_tiles = (a.chunk + kRows - 1) / kRows;
  const int c = blockIdx.x / n_tiles, it = blockIdx.x % n_tiles;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q = a.chunk, s0 = c * q, g = h / a.group, i0 = it * kRows;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const float* xb = a.xdt + b * a.x_sb + (long long)s0 * a.x_ss + h * a.x_sh;
  const float* bb = a.bm + b * a.b_sb + (long long)s0 * a.b_ss + g * a.b_sg;
  const float* cb = a.cm + b * a.c_sb + (long long)s0 * a.c_ss + g * a.c_sg;
  const long long slot = ((long long)b * a.nc + c) * a.heads + h;

  load_rows<N>(cs, cb, a.c_ss, i0, q);
  // the entering state [P, N] rides in the key tile's buffer (P <= 64)
  load_rows<N>(bs, a.states + slot * (P * N), N, 0, P);
  chunk_cumsum(a.dA + b * a.a_sb + (long long)s0 * a.a_ss + h * a.a_sh,
               a.a_ss, q, cum);

  float acc[4][P / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < P / 16; ++k) acc[i][k] = 0.f;

  // inter-chunk read: exp(cum[i]) * sum_n C[i, n] state[p, n]
#pragma unroll 4
  for (int n = 0; n < N; ++n) {
    float cv[4], sv[P / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) cv[i] = cs[(ty + 16 * i) * (N + 1) + n];
#pragma unroll
    for (int k = 0; k < P / 16; ++k) sv[k] = bs[(tx + 16 * k) * (N + 1) + n];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < P / 16; ++k) acc[i][k] = fmaf(cv[i], sv[k], acc[i][k]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = i0 + ty + 16 * i;
    const float head = row < q ? expf(static_cast<float>(cum[row])) : 0.f;
#pragma unroll
    for (int k = 0; k < P / 16; ++k) acc[i][k] *= head;
  }

  // intra-chunk: key tiles up to and including the diagonal one
  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * kRows;
    __syncthreads();   // the state / previous tile's reads are done
    load_rows<N>(bs, bb, a.b_ss, j0, q);
    load_rows<P>(xs, xb, a.x_ss, j0, q);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) sc[i][k] = 0.f;
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) cv[i] = cs[(ty + 16 * i) * (N + 1) + n];
#pragma unroll
      for (int k = 0; k < 4; ++k) bv[k] = bs[(tx + 16 * k) * (N + 1) + n];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) sc[i][k] = fmaf(cv[i], bv[k], sc[i][k]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = i0 + ty + 16 * i;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int col = j0 + tx + 16 * k;
        float v = 0.f;
        if (col <= row && row < q)   // col < q follows
          v = sc[i][k] * expf(static_cast<float>(cum[row] - cum[col]));
        ps[(ty + 16 * i) * (kRows + 1) + tx + 16 * k] = v;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < kRows; ++r) {
      float pv[4], xv[P / 16];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * (kRows + 1) + r];
#pragma unroll
      for (int k = 0; k < P / 16; ++k) xv[k] = xs[r * (P + 1) + tx + 16 * k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < P / 16; ++k) acc[i][k] = fmaf(pv[i], xv[k], acc[i][k]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = i0 + ty + 16 * i;
    if (row >= q) continue;
    float* yrow = a.y + (((long long)b * a.seq + s0 + row) * a.heads + h) * P;
#pragma unroll
    for (int k = 0; k < P / 16; ++k) yrow[tx + 16 * k] = acc[i][k];
  }
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

template <int P, int N>
int launch(const SsdArgs& a, int batch, cudaStream_t stream) {
  static_assert(P % 16 == 0 && P <= kRows && N % 16 == 0, "tile shapes");
  constexpr size_t kStateSmem = sizeof(double) * kMaxChunk +
      sizeof(float) * (kRows + kRows * (P + 1) + kRows * (N + 1));
  constexpr size_t kScanSmem = sizeof(double) * kMaxChunk +
      sizeof(float) * (2 * kRows * (N + 1) + kRows * (P + 1) +
                       kRows * (kRows + 1));
  int e = set_smem(ssd_chunk_state<P, N>, kStateSmem);
  if (e) return e;
  e = set_smem(ssd_chunk_scan<P, N>, kScanSmem);
  if (e) return e;
  const int n_tiles = (a.chunk + kRows - 1) / kRows;
  ssd_chunk_state<P, N><<<dim3(a.nc, a.heads, batch), kThreads, kStateSmem,
                          stream>>>(a);
  e = static_cast<int>(cudaGetLastError());
  if (e) return e;
  const int pass_blocks = (P * N + 4 * kThreads - 1) / (4 * kThreads);
  ssd_state_pass<P, N><<<dim3(pass_blocks, a.heads, batch), kThreads, 0,
                         stream>>>(a);
  e = static_cast<int>(cudaGetLastError());
  if (e) return e;
  ssd_chunk_scan<P, N><<<dim3(a.nc * n_tiles, a.heads, batch), kThreads,
                         kScanSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the three kernels on `stream` without synchronising; returns
// cudaGetLastError() (0 on success), -1 for a (P, N) this file was not
// built for, -2 for a chunk outside 1..256 or a sequence that is not a
// whole number of chunks.  Strides are in elements; every tensor is fp32.
int ssd_scan_fwd(const float* xdt, const float* dA, const float* bm,
                 const float* cm, const float* s0, float* y, float* s_out,
                 float* states, float* decay, long long x_sb, long long x_ss,
                 long long x_sh, long long a_sb, long long a_ss,
                 long long a_sh, long long b_sb, long long b_ss,
                 long long b_sg, long long c_sb, long long c_ss,
                 long long c_sg, int batch, int seq, int heads, int groups,
                 int p, int n, int chunk, void* stream) {
  if (chunk < 1 || chunk > kMaxChunk || seq % chunk || groups < 1 ||
      heads % groups)
    return -2;
  SsdArgs a{xdt,  dA,   bm,   cm,   s0,   y,    s_out, states, decay,
            x_sb, x_ss, x_sh, a_sb, a_ss, a_sh, b_sb,  b_ss,   b_sg,
            c_sb, c_ss, c_sg, seq,  heads, heads / groups, chunk,
            seq / chunk};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p == 64 && n == 128) return launch<64, 128>(a, batch, st);
  if (p == 64 && n == 64) return launch<64, 64>(a, batch, st);
  if (p == 16 && n == 16) return launch<16, 16>(a, batch, st);
  return -1;
}

const char* ssd_scan_error_string(int code) {
  if (code == -1) return "unsupported (head_dim P, d_state N)";
  if (code == -2) return "chunk outside 1..256 or S not a multiple of it";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
