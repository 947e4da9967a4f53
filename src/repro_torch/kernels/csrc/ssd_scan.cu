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
// What bounds it on this card: operations, at float32 accuracy.  At
// Mamba2-130M's training shape (B 8, S 2048, 24 heads of P 64 sharing one
// group, N 128, Q 256) the scan needs 19.9 GFLOP when C B^T is formed once
// per (batch row, chunk, group): the causal half of C B^T, each head's
// decayed product with xdt, the state read C state^T and the chunk's own
// state (tail xdt)^T B.  Its 232 MB of inputs and outputs take 69 us at
// 3.35 TB/s; the products take 121 us on the tensor cores at float32
// accuracy (below).
//
// Design.
// * Products on the tensor cores in 3xTF32.  Every fp32 operand is split
//   as a = hi + lo, hi = tf32(a) and lo = tf32(a - hi) (round to nearest,
//   by bit masking), and a b ~ hi hi' + hi lo' + lo hi' with fp32
//   accumulation: float32 accuracy at a third of the TF32 rate (a single
//   TF32 product, ~1e-3 relative, does not hold chip_smoke.py's
//   SSD_REL_TOL).  All four products go this way.
// * The state-passing form of the algorithm (arXiv:2405.21060 section 7):
//   the TPU kernel carries the [P, N] state in VMEM across a sequential
//   chunk axis; a GPU grid has no order, so three launches on one stream:
//   (a) ssd_state_mma: each chunk's own state (tail xdt)^T B and
//       exp(cum_end).  One block per (batch row, chunk, 2 heads of a
//       group); warpgroup w forms head w's state by wgmma m64nNk8 tf32
//       from shared memory.  Key tiles of 64 steps land raw by cp.async
//       (the next one during the current one's products) and are split
//       once into hi / lo planes, transposed to K-major and 128-byte
//       swizzled, B shared by the two heads.
//   (b) ssd_state_pass: the state entering each chunk, in place of the
//       chunk's own state (chunk 0's is s0, read from there), and the
//       final state.
//   (c) ssd_scan_mma: y.  One block per (batch row, chunk, 64-row query
//       tile, set of up to 24 heads of one group: the wrapper takes the
//       most that still fill the card once).  It forms the 64 x 64 tiles
//       of C B^T up to the diagonal once for all its heads and keeps them
//       in registers in the mma.sync m16n8k8 accumulator layout, which by
//       permuting the key index inside each group of 8 becomes the A
//       operand of P . xdt: each head's decay is applied in registers.
//       Eight warps: two 32-row halves of the tile (each split B fragment
//       feeds two m-tiles) times four quarters of the keys (of N in the
//       state read); the quarters' partial y meet in shared memory once a
//       head.  Copies run ahead: a head's state lands during the previous
//       head, its xdt tiles during its state read.  Shared-memory row
//       strides are padded so that every fragment read is conflict-free.
// Numerics.  The decays come from differences of the running sum cum,
// which at the model's own inputs reaches -1e3 within a chunk; in fp32
// the difference of two such sums loses ~1e-4 of its value to rounding.
// Each block therefore forms cum in double (a warp a head, 8 steps a lane
// and a shuffle scan, in log2 units), and every exponent cum[i] - cum[j]
// is taken in double, rounded to fp32 once and fed to one ex2.  The
// exponent is masked, not the exp: exp is only evaluated for j <= i, so
// no inf or NaN appears.
//
// Layout: xdt [B, S, H, P], dA [B, S, H] and B/C [B, S, G, N] are read in
// the model's layout through their strides (last dimension contiguous,
// 16-byte aligned rows); y [B, S, H, P] and the states are contiguous.  S
// is a multiple of the chunk (the wrapper pads), 1 <= Q <= 256.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;    // 8 warps
constexpr int kRows = 64;        // rows of a query or key tile
constexpr int kMaxChunk = 256;
constexpr int kPerLane = kMaxChunk / 32;
constexpr int kMaxHeads = 24;    // heads a block of ssd_scan_mma
constexpr int kMaxStateHeads = 2;  // heads a block of ssd_state_mma
constexpr double kLog2e = 1.4426950408889634;

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
  int hb_state, hb_scan;   // heads a block of ssd_state_mma / ssd_scan_mma
};

// ---- 3xTF32 on mma.sync ---------------------------------------------------

// tf32(x), round to nearest (ties away), as bits of an fp32 with the low 13
// mantissa bits clear.
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment (m16 x k8, row) split into hi and lo.
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2,
                                      float a3) {
    split(a0, hi[0], lo[0]);
    split(a1, hi[1], lo[1]);
    split(a2, hi[2], lo[2]);
    split(a3, hi[3], lo[3]);
  }
};

// A B fragment (k8 x n8, col) split into hi and lo.
struct FragB {
  uint32_t h0, h1, l0, l1;
  __device__ __forceinline__ void set(float b0, float b1) {
    split(b0, h0, l0);
    split(b1, h1, l1);
  }
};

// acc[m][t] += a[m] b[t] in 3xTF32 for t < t_live: lo hi, then hi lo,
// then hi hi over every (m, t), so that M x NT independent products
// separate two that accumulate into the same tile.
template <int M, int NT>
__device__ __forceinline__ void mma3(float (&acc)[M][NT][4],
                                     const FragA (&a)[M],
                                     const FragB (&b)[NT], int t_live = NT) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int t = 0; t < NT; ++t)
      if (t < t_live)
        mma_tf32(acc[m][t], a[m].lo, b[t].h0, b[t].h1);
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int t = 0; t < NT; ++t)
      if (t < t_live)
        mma_tf32(acc[m][t], a[m].hi, b[t].l0, b[t].l1);
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int t = 0; t < NT; ++t)
      if (t < t_live)
        mma_tf32(acc[m][t], a[m].hi, b[t].h0, b[t].h1);
}

// ---- cp.async -------------------------------------------------------------

__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copies rows [row0, row0 + n_rows_tile) of a [rows, W] fp32 matrix with
// row stride `stride` into shared memory with row stride LD; rows at or
// past `limit` are zero-filled (no global read).
template <int W, int LD>
__device__ __forceinline__ void load_tile(float* tile, const float* base,
                                          long long stride, int row0,
                                          int n_rows_tile, int limit) {
  constexpr int kPerRow = W / 4;
  for (int i = threadIdx.x; i < n_rows_tile * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * 4;
    const bool ok = row0 + r < limit;
    cp16(tile + r * LD + c,
         base + (ok ? (long long)(row0 + r) * stride + c : 0), ok);
  }
}

// Inclusive prefix sums in double of the chunk's dA (stride a_ss), in log2
// units (times log2 e), by the calling warp (8 steps a lane and a shuffle
// scan): emit(t, cum[t], cum[q - 1]) for every t < 256 this lane owns
// (cum[t] past q repeats cum[q - 1]).
template <typename Emit>
__device__ __forceinline__ void warp_cumsum(const float* dA, long long a_ss,
                                            int q, Emit emit) {
  const int lane = threadIdx.x & 31;
  double part[kPerLane];
  double run = 0.0;
#pragma unroll
  for (int e = 0; e < kPerLane; ++e) {
    const int t = lane * kPerLane + e;
    run += t < q ? static_cast<double>(dA[t * a_ss]) * kLog2e : 0.0;
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
  const double end = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
  for (int e = 0; e < kPerLane; ++e)
    emit(lane * kPerLane + e, part[e] + excl, end);
}

// 2^x for an exponent x formed in double (a difference of running sums in
// log2 units): x rounded to fp32 once, then one ex2 (relative error
// ~2^-22; results below 2^-126 flush to 0).
__device__ __forceinline__ float exp2_d(double x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(static_cast<float>(x)));
  return r;
}

// ---- wgmma (tf32, both operands K-major in shared memory) ----------------
//
// An operand tile of `rows` rows x 64 K (fp32 / tf32) is stored as two
// column blocks of [rows][32], 128 bytes a row, in the 128-byte swizzle:
// the 16-byte chunk c of row r sits at chunk c ^ (r % 8) of its row, rows
// in atoms of 8 x 128 bytes (1024-byte aligned).

// Byte offset of the 16-byte chunk holding K columns k .. k + 3 of row r.
__device__ __forceinline__ uint32_t sw_off(int r, int k, int rows) {
  return (k >> 5) * rows * 128 + (r >> 3) * 1024 + (r & 7) * 128 +
         ((((k & 31) >> 2) ^ (r & 7)) << 4);
}

// A wgmma shared-memory descriptor: start address, leading byte offset 16
// (unused by the swizzled K-major layout), stride byte offset 1024 (one
// 8-row atom to the next), layout 1 = 128-byte swizzle.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Generic-proxy stores to shared memory made visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

#define WG_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                 "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[0 : N / 2] += A[64 x 8] . B[8 x N] in tf32, fp32 accumulation; the
// accumulator layout of mma.sync m16n8 in each warp's 16 rows, 8-column
// block after block.
template <int N>
__device__ __forceinline__ void wg_mma(float (&d)[N / 2], uint64_t a,
                                       uint64_t b) {
  if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, "
        "1;\n}\n"
        : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40),
          WG_D8(48), WG_D8(56)
        : "l"(a), "l"(b), "r"(1));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
        : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
        : "l"(a), "l"(b), "r"(1));
  } else {
    static_assert(N == 16, "wgmma widths built: 16, 64, 128");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
        : WG_D8(0)
        : "l"(a), "l"(b), "r"(1));
  }
}
#undef WG_D8

// ---- (a) each chunk's own state -------------------------------------------
//
// One block per (chunk, set of hb <= 2 heads of one group, batch row);
// warpgroup w computes head w's own[p, n] = sum_j tail[j] xdt[j, p] B[j, n]
// as wgmma m64nNk8 products (P padded to 64 rows).  Key tiles of 64 steps:
// the raw copies land, are split into tf32 hi / lo planes once (B shared
// by the heads, xdt times the tail), transposed to K-major and swizzled;
// then 8 k-steps x 3 wgmma a head.  The next tile's raw copy lands while
// the current one's products run.
template <int P, int N>
struct StateTile {
  static constexpr int kM = 64;                        // wgmma rows
  static constexpr int kBPlane = N * kRows * 4;        // bytes
  static constexpr int kXPlane = kM * kRows * 4;
  static constexpr int kPlanes = 2 * kBPlane + 2 * kMaxStateHeads * kXPlane;
  static constexpr int kRaw = 4 * (kRows * N + kMaxStateHeads * kRows * P);
};

template <int P, int N>
__global__ void __launch_bounds__(kThreads) ssd_state_mma(SsdArgs a) {
  using T = StateTile<P, N>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // planes need 1024-byte alignment (the swizzle's atoms)
  const uint32_t raw_addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* base = smem_raw + ((1024 - (raw_addr & 1023)) & 1023);
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(base));
  const int q = a.chunk, n_tiles = (q + kRows - 1) / kRows;
  const int qt = n_tiles * kRows;
  const int hb = a.hb_state;
  // planes: B hi, B lo, then per head x hi, x lo
  const uint32_t b_hi = sbase, b_lo = sbase + T::kBPlane;
  const uint32_t x_pl = sbase + 2 * T::kBPlane;
  float* raw_b = reinterpret_cast<float*>(base + T::kPlanes);   // [kRows][N]
  float* raw_x = raw_b + kRows * N;                // [hb][kRows][P]
  float* tail = reinterpret_cast<float*>(base + T::kPlanes + T::kRaw);

  const int c = blockIdx.x, hs = blockIdx.y, b = blockIdx.z;
  const int h0 = hs * hb, g = h0 / a.group, s0 = c * q;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  const float* bb = a.bm + b * a.b_sb + (long long)s0 * a.b_ss + g * a.b_sg;
  const float* xb = a.xdt + b * a.x_sb + (long long)s0 * a.x_ss;

  auto load_raw = [&](int jt) {
    load_tile<N, N>(raw_b, bb, a.b_ss, jt * kRows, kRows, q);
    for (int hh = 0; hh < hb; ++hh)
      load_tile<P, P>(raw_x + hh * kRows * P, xb + (h0 + hh) * a.x_sh,
                      a.x_ss, jt * kRows, kRows, q);
    cp_commit();
  };
  load_raw(0);

  // x planes' rows past P stay zero (P < 64 pads wgmma's 64 rows)
  if (P < T::kM) {
    for (int i = threadIdx.x; i < 2 * kMaxStateHeads * T::kXPlane / 16;
         i += kThreads)
      reinterpret_cast<uint4*>(base + 2 * T::kBPlane)[i] =
          make_uint4(0u, 0u, 0u, 0u);
  }

  // tails exp(cum_end - cum[j]) (0 past q) and the chunk's decay, a warp
  // a head
  for (int hh = warp; hh < hb; hh += kThreads / 32) {
    const int h = h0 + hh;
    float* tl = tail + hh * qt;
    warp_cumsum(a.dA + b * a.a_sb + (long long)s0 * a.a_ss + h * a.a_sh,
                a.a_ss, q, [&](int t, double cum, double end) {
                  if (t < qt) tl[t] = t < q ? exp2_d(end - cum) : 0.f;
                  if (t == 0)
                    a.decay[((long long)b * a.nc + c) * a.heads + h] =
                        exp2_d(end);
                });
  }

  float acc[N / 2];
#pragma unroll
  for (int e = 0; e < N / 2; ++e) acc[e] = 0.f;

  for (int jt = 0; jt < n_tiles; ++jt) {
    cp_wait<0>();
    __syncthreads();   // tile jt landed (and the tails); planes are free
    // raw [j][n] -> K-major planes [n][j]: 4 steps j of one n a thread
    for (int i = threadIdx.x; i < N * (kRows / 4); i += kThreads) {
      const int n = i % N, j = (i / N) * 4;
      uint4 h, l;
      split(raw_b[j * N + n], h.x, l.x);
      split(raw_b[(j + 1) * N + n], h.y, l.y);
      split(raw_b[(j + 2) * N + n], h.z, l.z);
      split(raw_b[(j + 3) * N + n], h.w, l.w);
      const uint32_t o = sw_off(n, j, N);
      *reinterpret_cast<uint4*>(base + o) = h;
      *reinterpret_cast<uint4*>(base + T::kBPlane + o) = l;
    }
    for (int i = threadIdx.x; i < hb * P * (kRows / 4); i += kThreads) {
      const int hh = i / (P * (kRows / 4)), rem = i % (P * (kRows / 4));
      const int p = rem % P, j = (rem / P) * 4;
      const float* x = raw_x + hh * kRows * P + p;
      const float* tl = tail + hh * qt + jt * kRows + j;
      uint4 h, l;
      split(x[j * P] * tl[0], h.x, l.x);
      split(x[(j + 1) * P] * tl[1], h.y, l.y);
      split(x[(j + 2) * P] * tl[2], h.z, l.z);
      split(x[(j + 3) * P] * tl[3], h.w, l.w);
      const uint32_t o = 2 * T::kBPlane + hh * 2 * T::kXPlane +
                         sw_off(p, j, T::kM);
      *reinterpret_cast<uint4*>(base + o) = h;
      *reinterpret_cast<uint4*>(base + T::kXPlane + o) = l;
    }
    fence_async_smem();
    __syncthreads();   // planes ready, raw buffers free
    if (jt + 1 < n_tiles) load_raw(jt + 1);
    if (wg < hb) {
      const uint32_t xh = x_pl + wg * 2 * T::kXPlane, xl = xh + T::kXPlane;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kRows / 8; ++kk) {
        const uint32_t ox = (kk >> 2) * T::kM * 128 + (kk & 3) * 32;
        const uint32_t ob = (kk >> 2) * N * 128 + (kk & 3) * 32;
        wg_mma<N>(acc, wg_desc(xl + ox), wg_desc(b_hi + ob));
        wg_mma<N>(acc, wg_desc(xh + ox), wg_desc(b_lo + ob));
        wg_mma<N>(acc, wg_desc(xh + ox), wg_desc(b_hi + ob));
      }
      wg_commit();
      wg_wait_all();
    }
  }

  if (wg < hb) {
    const long long slot = ((long long)b * a.nc + c) * a.heads + h0 + wg;
    float* out = a.states + slot * (P * N);
    const int p = (warp & 3) * 16 + (lane >> 2);
#pragma unroll
    for (int t = 0; t < N / 8; ++t) {
      const int n = t * 8 + (lane & 3) * 2;
      if (p < P)
        *reinterpret_cast<float2*>(out + p * N + n) =
            make_float2(acc[4 * t], acc[4 * t + 1]);
      if (p + 8 < P)
        *reinterpret_cast<float2*>(out + (p + 8) * N + n) =
            make_float2(acc[4 * t + 2], acc[4 * t + 3]);
    }
  }
}

// ---- (b) the state entering each chunk ------------------------------------
//
// In place of the chunk's own state (chunk 0's is s0, which the scan reads
// itself), and the final state: 4 consecutive state elements a thread;
// the own states of 8 chunks are loaded before the chain over them runs.
template <int P, int N>
__global__ void __launch_bounds__(kThreads) ssd_state_pass(SsdArgs a) {
  constexpr int kBatch = 8;
  const int e = (blockIdx.x * kThreads + threadIdx.x) * 4;
  if (e >= P * N) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * a.heads + h;
  float4 st = *reinterpret_cast<const float4*>(a.s0 + bh * (P * N) + e);
  for (int c0 = 0; c0 < a.nc; c0 += kBatch) {
    float4 own[kBatch];
    float d[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (c0 + k < a.nc) {
        const long long slot = ((long long)b * a.nc + c0 + k) * a.heads + h;
        own[k] = *reinterpret_cast<const float4*>(a.states + slot * (P * N)
                                                  + e);
        d[k] = a.decay[slot];
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (c0 + k < a.nc) {
        const long long slot = ((long long)b * a.nc + c0 + k) * a.heads + h;
        if (c0 + k > 0)   // the scan reads chunk 0's entering state at s0
          *reinterpret_cast<float4*>(a.states + slot * (P * N) + e) = st;
        st.x = fmaf(st.x, d[k], own[k].x);
        st.y = fmaf(st.y, d[k], own[k].y);
        st.z = fmaf(st.z, d[k], own[k].z);
        st.w = fmaf(st.w, d[k], own[k].w);
      }
    }
  }
  *reinterpret_cast<float4*>(a.s_out + bh * (P * N) + e) = st;
}

// ---- (c) y ----------------------------------------------------------------
//
// One block per (chunk, set of hb heads of one group, batch row) in
// blockIdx.x and 64-row query tile in blockIdx.y (heaviest, last, tiles
// first).  Warp w: rows 32 (w % 2) .. + 32 of the tile (two m-tiles, so
// each split B fragment feeds two products) and quarter kq = w / 2 of the
// keys of every key tile (16 keys, two n-tiles) and of the k-steps of N
// in the state read; the quarters' partial y are summed through shared
// memory once per head.  The C B^T tiles stay in registers (kMaxTiles x 16
// a thread).  Copies run ahead of the products: each head's state lands
// during the previous head, and all of a head's xdt tiles are issued at
// its start and land during its state read.
template <int P, int N>
struct ScanTile {
  static constexpr int kLdC = N + 4;   // A reads row = gid: stride 4 (mod 32)
  static constexpr int kLdX = P + 4;   // xdt reads rows 2 tig, 2 tig + 1
  static constexpr int kPart = 2 * (P / 8) * 4 * 32;  // a warp's partial y
  // a state slot (later 4 warps' partial y), 2 of them; 4 xdt tiles
  // (phase 1: 2 B tiles)
  static constexpr int kSt = P * kLdC > 4 * kPart ? P * kLdC : 4 * kPart;
  static constexpr int kX = 4 * kRows * kLdX > 2 * kRows * kLdC
                                ? 4 * kRows * kLdX : 2 * kRows * kLdC;
};

template <int P, int N>
__global__ void __launch_bounds__(kThreads) ssd_scan_mma(SsdArgs a) {
  using T = ScanTile<P, N>;
  constexpr int kLdC = T::kLdC, kLdX = T::kLdX;
  constexpr int kNP = P / 8;     // n-tiles of y
  constexpr int kMaxTiles = kMaxChunk / kRows;
  extern __shared__ __align__(16) double smem_d[];
  const int q = a.chunk, n_tiles = (q + kRows - 1) / kRows;
  const int hb = a.hb_scan;
  const int qt = n_tiles * kRows;
  double* cum = smem_d;                                    // [hb][qt]
  float* cs = reinterpret_cast<float*>(cum + hb * qt);     // [kRows][kLdC]
  float* sts = cs + kRows * kLdC;                          // [2][kSt]
  float* xs = sts + 2 * T::kSt;                  // [4][kRows][kLdX]
  float* bs = xs;                                // phase 1: [2][kRows][kLdC]

  const int c = blockIdx.x % a.nc, hs = (blockIdx.x / a.nc) % (a.heads / hb);
  const int b = blockIdx.x / a.nc / (a.heads / hb);
  const int it = n_tiles - 1 - blockIdx.y;
  const int h0 = hs * hb, g = h0 / a.group;
  const int s0 = c * q, i0 = it * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int rh = warp & 1, kq = warp >> 1;
  // this thread's rows: rr[m][0] = rh 32 + 16 m + gid, rr[m][1] = + 8
  const int rb = i0 + rh * 32 + gid;
  // key n-tiles kq 2 + t; on the diagonal tile only those at or below
  // this warp's last row
  const int t_diag = max(0, min(2, 4 * rh + 4 - 2 * kq));
  const float* bb = a.bm + b * a.b_sb + (long long)s0 * a.b_ss + g * a.b_sg;
  const float* xb = a.xdt + b * a.x_sb + (long long)s0 * a.x_ss;
  const long long slot0 = ((long long)b * a.nc + c) * a.heads + h0;

  load_tile<N, kLdC>(cs, a.cm + b * a.c_sb + (long long)s0 * a.c_ss +
                             g * a.c_sg, a.c_ss, i0, kRows, q);
  load_tile<N, kLdC>(bs, bb, a.b_ss, 0, kRows, q);
  cp_commit();
  // the state entering the chunk: s0 for chunk 0, else the state pass's
  auto state_src = [&](int hh) {
    return c == 0 ? a.s0 + ((long long)b * a.heads + h0 + hh) * (P * N)
                  : a.states + (slot0 + hh) * (P * N);
  };
  load_tile<N, kLdC>(sts, state_src(0), N, 0, P, P);
  cp_commit();
  for (int hh = warp; hh < hb; hh += kThreads / 32) {
    double* ch = cum + hh * qt;
    warp_cumsum(a.dA + b * a.a_sb + (long long)s0 * a.a_ss +
                    (h0 + hh) * a.a_sh, a.a_ss, q,
                [&](int t, double v, double) { if (t < q) ch[t] = v; });
  }

  // A fragments (rows of m-tile m) of C at k-step k0
  const float* ca = cs + (rh * 32 + gid) * kLdC;
  auto c_frags = [&](FragA (&fa)[2], int k0) {
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const float* cr = ca + m * 16 * kLdC;
      fa[m].set(cr[k0], cr[8 * kLdC + k0], cr[k0 + 4], cr[8 * kLdC + k0 + 4]);
    }
  };

  // phase 1: C B^T tiles 0 .. it, each warp its 32 rows x 16 keys
  float sc[kMaxTiles][2][2][4];
#pragma unroll
  for (int jt = 0; jt < kMaxTiles; ++jt) {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int t = 0; t < 2; ++t)
        sc[jt][m][t][0] = sc[jt][m][t][1] = sc[jt][m][t][2] =
            sc[jt][m][t][3] = 0.f;
    if (jt <= it) {
      cp_wait<0>();
      __syncthreads();
      if (jt + 1 <= it) {
        load_tile<N, kLdC>(bs + ((jt + 1) & 1) * kRows * kLdC, bb, a.b_ss,
                           (jt + 1) * kRows, kRows, q);
        cp_commit();
      }
      const float* bt = bs + (jt & 1) * kRows * kLdC;
      const int t_live = jt < it ? 2 : t_diag;
      if (t_live > 0) {
#pragma unroll 4
        for (int ks = 0; ks < N / 8; ++ks) {
          const int k0 = ks * 8 + tig;
          FragA fa[2];
          c_frags(fa, k0);
          FragB fb[2];
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            const float* br = bt + ((kq * 2 + t) * 8 + gid) * kLdC + k0;
            if (t < t_live) fb[t].set(br[0], br[4]);
          }
          mma3(sc[jt], fa, fb, t_live);
        }
      }
    }
  }

  // phase 2: per head, the state read and the decayed P . xdt
  for (int hh = 0; hh < hb; ++hh) {
    const int h = h0 + hh;
    const double* ch = cum + hh * qt;
    float* st = sts + (hh & 1) * T::kSt;
    __syncthreads();   // phase 1 / the previous head is done with xs
    for (int jt = 0; jt <= it; ++jt)
      load_tile<P, kLdX>(xs + jt * kRows * kLdX, xb + h * a.x_sh, a.x_ss,
                         jt * kRows, kRows, q);
    cp_commit();
    const bool next = hh + 1 < hb;
    if (next) {
      load_tile<N, kLdC>(sts + ((hh + 1) & 1) * T::kSt, state_src(hh + 1),
                         N, 0, P, P);
      cp_commit();
      cp_wait<2>();    // this head's state (issued a head earlier)
    } else {
      cp_wait<1>();
    }
    __syncthreads();

    float acc[2][kNP][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int t = 0; t < kNP; ++t)
        acc[m][t][0] = acc[m][t][1] = acc[m][t][2] = acc[m][t][3] = 0.f;
    // cum at this thread's rows (0 past q)
    double cr[2][2];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = rb + m * 16 + u * 8;
        cr[m][u] = r < q ? ch[r] : 0.0;
      }
    // the state read: this warp's quarter of N's k-steps
    for (int ks = kq; ks < N / 8; ks += 4) {
      const int k0 = ks * 8 + tig;
      FragA fa[2];
      c_frags(fa, k0);
      FragB fb[kNP];
#pragma unroll
      for (int t = 0; t < kNP; ++t) {
        const float* sr = st + (t * 8 + gid) * kLdC + k0;
        fb[t].set(sr[0], sr[4]);
      }
      mma3(acc, fa, fb);
    }
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const float e0 = rb + m * 16 < q ? exp2_d(cr[m][0]) : 0.f;
      const float e1 = rb + m * 16 + 8 < q ? exp2_d(cr[m][1]) : 0.f;
#pragma unroll
      for (int t = 0; t < kNP; ++t) {
        acc[m][t][0] *= e0;
        acc[m][t][1] *= e0;
        acc[m][t][2] *= e1;
        acc[m][t][3] *= e1;
      }
    }
    if (next) cp_wait<1>(); else cp_wait<0>();   // this head's xdt tiles
    __syncthreads();

#pragma unroll
    for (int jt = 0; jt < kMaxTiles; ++jt) {
      if (jt <= it) {
        const float* x = xs + jt * kRows * kLdX;
        const int t_live = jt < it ? 2 : t_diag;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          if (t < t_live) {
            const int kl = (kq * 2 + t) * 8 + 2 * tig;   // key in the tile
            const int j0 = jt * kRows + kl, j1 = j0 + 1;
            const double cj0 = j0 < q ? ch[j0] : 0.0;
            const double cj1 = j1 < q ? ch[j1] : 0.0;
            // the accumulator (rows gid, gid + 8; keys 2 tig, 2 tig + 1)
            // decayed, as the A operand with the key order permuted:
            // k = tig -> 2 tig, k = tig + 4 -> 2 tig + 1.  The decay is
            // masked in the exponent: j <= r < q.
            FragA fa[2];
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              const int r0 = rb + m * 16, r1 = r0 + 8;
              const float d00 =
                  (j0 <= r0 && r0 < q) ? exp2_d(cr[m][0] - cj0) : 0.f;
              const float d01 =
                  (j1 <= r0 && r0 < q) ? exp2_d(cr[m][0] - cj1) : 0.f;
              const float d10 =
                  (j0 <= r1 && r1 < q) ? exp2_d(cr[m][1] - cj0) : 0.f;
              const float d11 =
                  (j1 <= r1 && r1 < q) ? exp2_d(cr[m][1] - cj1) : 0.f;
              fa[m].set(sc[jt][m][t][0] * d00, sc[jt][m][t][2] * d10,
                        sc[jt][m][t][1] * d01, sc[jt][m][t][3] * d11);
            }
            FragB fb[kNP];
#pragma unroll
            for (int p = 0; p < kNP; ++p) {
              const float* xr = x + kl * kLdX + p * 8 + gid;
              fb[p].set(xr[0], xr[kLdX]);
            }
            mma3(acc, fa, fb);
          }
        }
      }
    }

    // the quarters' partial sums, through this head's state slot (every
    // warp is done with it): quarters 2, 3 write, 0, 1 add theirs; 1
    // writes, 0 adds its and writes y
    float* part = st + lane;
    auto put = [&](int w) {
      float* o = part + w * T::kPart;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int t = 0; t < kNP; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[((m * kNP + t) * 4 + e) * 32] = acc[m][t][e];
    };
    auto add = [&](int w) {
      const float* o = part + w * T::kPart;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int t = 0; t < kNP; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[m][t][e] += o[((m * kNP + t) * 4 + e) * 32];
    };
    // slot of warp (rh, kq) = rh * 2 + (kq - 2) for kq >= 2
    if (kq >= 2) put(rh * 2 + kq - 2);
    __syncthreads();
    if (kq < 2) add(rh * 2 + kq);
    __syncthreads();
    if (kq == 1) put(rh * 2 + 1);
    __syncthreads();
    if (kq == 0) {
      add(rh * 2 + 1);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int r0 = rb + m * 16;
        float* y0 = a.y + (((long long)b * a.seq + s0 + r0) * a.heads + h) * P;
        float* y1 = y0 + 8LL * a.heads * P;
#pragma unroll
        for (int t = 0; t < kNP; ++t) {
          const int p = t * 8 + 2 * tig;
          if (r0 < q)
            *reinterpret_cast<float2*>(y0 + p) =
                make_float2(acc[m][t][0], acc[m][t][1]);
          if (r0 + 8 < q)
            *reinterpret_cast<float2*>(y1 + p) =
                make_float2(acc[m][t][2], acc[m][t][3]);
        }
      }
    }
  }
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

// Dynamic shared memory of each kernel, in bytes.
template <int P, int N>
size_t state_smem(int chunk, int hb) {
  using T = StateTile<P, N>;
  const int qt = (chunk + kRows - 1) / kRows * kRows;
  return 1024 + T::kPlanes + T::kRaw + sizeof(float) * hb * qt;
}
template <int P, int N>
size_t scan_smem(int chunk, int hb) {
  using T = ScanTile<P, N>;
  const int qt = (chunk + kRows - 1) / kRows * kRows;
  return sizeof(double) * hb * qt +
         sizeof(float) * (kRows * T::kLdC + 2 * T::kSt + T::kX);
}

template <int P, int N>
int launch(const SsdArgs& a, int batch, cudaStream_t stream) {
  static_assert(P % 16 == 0 && P <= kRows && N % 16 == 0, "tile shapes");
  const size_t sm_state = state_smem<P, N>(a.chunk, a.hb_state);
  const size_t sm_scan = scan_smem<P, N>(a.chunk, a.hb_scan);
  int e = set_smem(ssd_state_mma<P, N>, sm_state);
  if (e) return e;
  e = set_smem(ssd_scan_mma<P, N>, sm_scan);
  if (e) return e;
  const int n_tiles = (a.chunk + kRows - 1) / kRows;
  ssd_state_mma<P, N><<<dim3(a.nc, a.heads / a.hb_state, batch), kThreads,
                        sm_state, stream>>>(a);
  e = static_cast<int>(cudaGetLastError());
  if (e) return e;
  const int pass_blocks = (P * N + 4 * kThreads - 1) / (4 * kThreads);
  ssd_state_pass<P, N><<<dim3(pass_blocks, a.heads, batch), kThreads, 0,
                         stream>>>(a);
  e = static_cast<int>(cudaGetLastError());
  if (e) return e;
  ssd_scan_mma<P, N><<<dim3(a.nc * (a.heads / a.hb_scan) * batch, n_tiles),
                       kThreads, sm_scan, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool heads_ok(int hb, int group, int most) {
  return hb >= 1 && hb <= most && group % hb == 0;
}

}  // namespace

extern "C" {

// Launches the three kernels on `stream` without synchronising; returns
// cudaGetLastError() (0 on success), -1 for a (P, N) this file was not
// built for, -2 for a chunk outside 1..256 or a sequence that is not a
// whole number of chunks, -3 for heads a block (hb_state <= 2, hb_scan
// <= 8) that do not divide the heads of a group.  Strides are
// in elements; every tensor is fp32.
int ssd_scan_fwd(const float* xdt, const float* dA, const float* bm,
                 const float* cm, const float* s0, float* y, float* s_out,
                 float* states, float* decay, long long x_sb, long long x_ss,
                 long long x_sh, long long a_sb, long long a_ss,
                 long long a_sh, long long b_sb, long long b_ss,
                 long long b_sg, long long c_sb, long long c_ss,
                 long long c_sg, int batch, int seq, int heads, int groups,
                 int p, int n, int chunk, int hb_state, int hb_scan,
                 void* stream) {
  if (chunk < 1 || chunk > kMaxChunk || seq % chunk || groups < 1 ||
      heads % groups)
    return -2;
  const int group = heads / groups;
  if (!heads_ok(hb_state, group, kMaxStateHeads) ||
      !heads_ok(hb_scan, group, kMaxHeads))
    return -3;
  SsdArgs a{xdt,  dA,   bm,   cm,   s0,   y,     s_out, states,
            decay, x_sb, x_ss, x_sh, a_sb, a_ss, a_sh,  b_sb,
            b_ss, b_sg, c_sb, c_ss, c_sg, seq,  heads, group,
            chunk, seq / chunk, hb_state, hb_scan};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p == 64 && n == 128) return launch<64, 128>(a, batch, st);
  if (p == 64 && n == 64) return launch<64, 64>(a, batch, st);
  if (p == 16 && n == 16) return launch<16, 16>(a, batch, st);
  return -1;
}

// Dynamic shared memory of ssd_state_mma (which = 0) or ssd_scan_mma
// (which = 1) at (P, N, chunk, heads a block); 0 for a (P, N) not built.
long long ssd_scan_smem_bytes(int which, int p, int n, int chunk, int hb) {
  if (p == 64 && n == 128)
    return which ? scan_smem<64, 128>(chunk, hb)
                 : state_smem<64, 128>(chunk, hb);
  if (p == 64 && n == 64)
    return which ? scan_smem<64, 64>(chunk, hb) : state_smem<64, 64>(chunk, hb);
  if (p == 16 && n == 16)
    return which ? scan_smem<16, 16>(chunk, hb) : state_smem<16, 16>(chunk, hb);
  return 0;
}

const char* ssd_scan_error_string(int code) {
  if (code == -1) return "unsupported (head_dim P, d_state N)";
  if (code == -2) return "chunk outside 1..256 or S not a multiple of it";
  if (code == -3) return "heads a block not a divisor of the group or too many";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
