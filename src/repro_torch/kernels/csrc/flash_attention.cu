// Flash attention forward for Hopper (sm_90a), grouped-query, with causal
// and sliding-window masks.  Two kernels compute one function:
//
//   s[i, j]   = q[b, i, h, :] . k[b, j, h / group, :] / sqrt(hd)
//   out[b, i, h, :] = softmax_j(s[i, j] where mask) @ v[b, j, h / group, :]
//   lse[b, h, i]    = m_i + log(l_i)       (running max, running sum)
//
//   mask(i, j) = (!causal || j <= i) && (!window || j > i - window)
//
// A row with no visible key gives out = 0 and lse = -1e30, as
// flash_attention.py:105-110 does.  Both replace the Pallas kernel
// _fwd_kernel of the reference package (src/repro/kernels/
// flash_attention.py:45, entry flash_attention_fwd); the wrapper picks one
// by dtype alone, and neither stands in for the other.
//
// What bounds them on this card: operations.  The causal prefill of one
// bucket is 2 * nh * Sq * Sk * hd flops against a few MB of q/k/v, well
// above the ~295 flops/byte line of the bf16 tensor cores (989 TFLOP/s).
//
// flash_wgmma_kernel — bfloat16, the dtype serving and training run in.
// * Tiles: a block takes 128 query rows of one head, one consumer
//   warpgroup per 64 rows, and walks KV tiles of 128 keys (the rows of KV
//   head h / group).  A ninth warp is the producer.
// * Loads: the producer's one thread starts TMA copies (4-d tensor maps
//   over the model's [B, S, heads, hd] layout, so any strides the wrapper
//   passes are read in place) into a 2-stage ring of K/V tiles in shared
//   memory, tracked by mbarriers (full: bytes landed; empty: all 8 consumer
//   warps done).  Rows past Sq or Sk arrive as zeros; the edge is masked
//   here.  Head widths 64, 96 and 128: a 96-wide row (192 B) is two
//   64-column boxes, the second clipped by the map's inner extent of 96,
//   so TMA reads 96 columns from memory and fills 96-127 with zeros; S
//   takes six k16 steps and O is one m64n96k16 product a k16 step.  Tiles are stored as 64-column blocks in the 128-byte swizzle
//   that the wgmma descriptors read.  The tensor maps are encoded on the
//   host per call, through the runtime's entry-point query (no -lcuda).
// * S = Q K^T: wgmma.mma_async m64n128k16, Q and K from shared memory,
//   both K-major (hd, the reduction axis, is contiguous), fp32 in
//   registers.  Exact bf16 products summed in fp32, as the reference's
//   fp32 dot_general (flash_attention.py:72-77).
// * Online softmax in registers in the exp2 domain: a row's 128 scores
//   are held by the 4 lanes of a quad (the accumulator layout), reduced
//   with two shuffles; the masks are applied only on tiles that cross the
//   diagonal, the window's edge or Sk.
// * O += P V: P is rounded to bf16 in registers and fed as wgmma's A
//   operand (the m64nNk16 accumulator layout is the A-fragment layout),
//   V from shared memory MN-major through the transpose bit.  This bf16
//   rounding of P is the one rounding the reference does not make; l sums
//   the fp32 P.
// * Scheduling: tiles the mask hides from every row of the block are not
//   loaded, those it hides from one warpgroup's rows are not computed by
//   it; blocks run heaviest causal q tile first (blockIdx.z reversed).
//   Each warpgroup runs S, its softmax and P V in turn and the two groups
//   interleave on the tensor cores by themselves.  A thread has 168
//   registers (the O and S accumulators take 128); overlapping a group's
//   softmax with its next products needs a second set of them, which
//   ptxas spills, and was slower at every measured shape (PERF.md).
//
// flash_fwd_kernel — float32 (the checks: card vs CPU at 1e-5 and 1e-4,
// which TF32 tensor cores would not hold).  fp32 FMAs on the CUDA cores
// (67 TFLOP/s peak): one block per (q tile of 64 rows, head, batch row),
// a loop over KV tiles of 64 with (m, l, acc) in registers; tiles the
// mask hides entirely are skipped before any load; q/k/v read through
// their strides, 16 bytes a thread, into padded fp32 shared-memory tiles;
// 256 threads, thread (ty, tx) owning rows 4ty..4ty+3 and columns
// tx + 16j, row max and sum over the 16 tx lanes with shuffles.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
// error codes of the entries, besides cudaError_t's
constexpr int kUnsupported = -1;   // a (dtype, hd) the entry does not take
constexpr int kNoEncoder = -2;     // libcuda has no cuTensorMapEncodeTiled
constexpr int kBadMap = -3;        // a tensor map was refused

// ---------------------------------------------------------------------------
// flash_fwd_kernel: float32, fp32 FMAs on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void from_f(float v, float* p) { *p = v; }

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

constexpr int fma_smem_bytes(int hd) {
  return sizeof(float) * ((kBQ + 2 * kBK) * (hd + 1) + kBQ * (kBK + 1));
}

template <typename T, int HD>
int launch(const FlashArgs& a, int batch, cudaStream_t stream) {
  constexpr size_t kSmem = fma_smem_bytes(HD);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((a.sq + kBQ - 1) / kBQ, a.nh, batch);
  flash_fwd_kernel<T, HD><<<grid, kThreads, kSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// flash_wgmma_kernel: bfloat16 on the tensor cores (wgmma, TMA, mbarriers)
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kBQ = 128;           // query rows a block
constexpr int kBK = 128;           // keys a KV tile
constexpr int kStages = 2;         // K/V tiles in flight
constexpr int kConsumerWarps = 8;  // two warpgroups of 64 rows each
constexpr int kThreads = 32 * (kConsumerWarps + 1);   // + the producer warp
constexpr int kAtom = 1024;        // 8 rows x 128 bytes: the swizzle's unit
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;

// Byte offsets into the (1024-aligned) dynamic shared memory.  A tile is
// stored as ceil(hd / 64) column blocks of [rows][64] bf16, 128 bytes a
// row; at hd 96 the second block's columns 96-127 are the tensor map's
// out-of-bounds zeros, which no product reads.
template <int HD>
struct Layout {
  static constexpr int kCB = (HD + 63) / 64;           // column blocks
  static constexpr int kQBlock = 64 * 128;             // [64 rows][64 cols]
  static constexpr int kKVBlock = kBK * 128;           // [kBK rows][64 cols]
  static constexpr int kQ = 0;                         // [2 wg][kCB]
  static constexpr int kK = kQ + 2 * kCB * kQBlock;    // [kStages][kCB]
  static constexpr int kV = kK + kStages * kCB * kKVBlock;
  static constexpr int kBar = kV + kStages * kCB * kKVBlock;
  static constexpr int kTileBytes = 2 * kCB * kKVBlock;   // K and V
  // full[kStages], empty[kStages], q; + slack to align the base to 1024
  static constexpr int kBytes = kBar + 8 * (2 * kStages + 1) + kAtom;
};

struct Args {
  __nv_bfloat16* out;   // [B, Sq, nh, hd], contiguous
  float* lse;           // [B, nh, Sq], contiguous
  int sq, sk, nh, group, n_qt;
  int causal, has_window, window;
  float scale_log2;     // log2(e) / sqrt(hd)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Returns once the phase of parity `parity` has completed.  A wait that
// outlasts 4 s can only be a fault of the pipeline: it traps (a launch
// error the wrapper's caller sees) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t t0 = 0;
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n % 1024 == 0) {
      uint64_t t;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
      if (n == 0)
        t0 = t;
      else if (t - t0 > 4000000000ull)
        __trap();
    }
  }
}

// One box of a 4-d tensor map (hd, heads, rows, batch) into shared memory;
// completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int col, int head, int row,
                                         int batch, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(head), "r"(row),
      "r"(batch), "r"(bar)
      : "memory");
}

// A wgmma shared-memory descriptor for the 128-byte swizzle: start
// address, leading and stride byte offsets (all >> 4), layout 1 = B128.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d[0:64] (+)= A[64x16] . B[16x128], A and B from shared memory
// (both K-major, 128-byte swizzle); scale_d == 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[0:32] += A[64x16] . B[16x64], A from registers (the accumulator
// layout of an m64n16 tile, bf16 pairs), B from shared memory MN-major
// (transposed, 128-byte swizzle).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[0:64] += A[64x16] . B[16x128], A from registers (the accumulator
// layout of an m64n16 tile, bf16 pairs), B from shared memory MN-major
// (transposed, 128-byte swizzle).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[0:48] += A[64x16] . B[16x96], A from registers (the accumulator
// layout of an m64n16 tile, bf16 pairs), B from shared memory MN-major
// (transposed, 128-byte swizzle): 96 columns are one 64-column block and
// the first half of the next, LBO apart.
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int N>
struct Mma;
template <>
struct Mma<64> {
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    wgmma_rs_n64(d, a, b);
  }
};
template <>
struct Mma<96> {
  static __device__ __forceinline__ void rs(float (&d)[48],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    wgmma_rs_n96(d, a, b);
  }
};
template <>
struct Mma<128> {
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    wgmma_rs_n128(d, a, b);
  }
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const Args a) {
  using L = Layout<HD>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + kAtom - 1) & ~(kAtom - 1);
  const uint32_t q_s = base + L::kQ, k_s = base + L::kK, v_s = base + L::kV;
  const uint32_t full = base + L::kBar;          // full[s] at full + 8 s
  const uint32_t empty = full + 8 * kStages;     // empty[s]
  const uint32_t q_bar = empty + 8 * kStages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (a.n_qt - 1 - blockIdx.z) * kBQ;   // heaviest tiles first
  // the KV tiles some row of this block can see
  int kt_lo = 0, kt_hi = (a.sk + kBK - 1) / kBK;
  if (a.causal) kt_hi = min(kt_hi, (q0 + kBQ - 1) / kBK + 1);
  if (a.has_window) kt_lo = max(0, q0 - a.window + 1) / kBK;
  const int n_iter = max(0, kt_hi - kt_lo);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // producer: one thread keeps the K/V ring full
    if (lane == 0) {
      const CUtensorMap* maps[3] = {&map_q, &map_k, &map_v};
      for (const CUtensorMap* map : maps)
        asm volatile("prefetch.tensormap [%0];" ::"l"(
                         reinterpret_cast<uint64_t>(map))
                     : "memory");
      const int live_wg = a.sq - q0 > 64 ? 2 : 1;   // warpgroups with rows
      mbar_expect_tx(q_bar, live_wg * L::kCB * L::kQBlock);
      for (int wg = 0; wg < live_wg; ++wg)
        for (int cb = 0; cb < L::kCB; ++cb)
          tma_load(q_s + (wg * L::kCB + cb) * L::kQBlock, &map_q, cb * 64, h,
                   q0 + wg * 64, b, q_bar);
      const int kvh = h / a.group;
      for (int i = 0; i < n_iter; ++i) {
        const int s = i % kStages;
        mbar_wait(empty + 8 * s, ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, L::kTileBytes);
        const int row = (kt_lo + i) * kBK;
        for (int cb = 0; cb < L::kCB; ++cb) {
          const uint32_t off = (s * L::kCB + cb) * L::kKVBlock;
          tma_load(k_s + off, &map_k, cb * 64, kvh, row, b, full + 8 * s);
          tma_load(v_s + off, &map_v, cb * 64, kvh, row, b, full + 8 * s);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows q0w .. q0w + 63; this thread holds
  // rows r and r + 8 of them, columns 8 n + c and 8 n + c + 1 of each
  // 8-column block n of S and of O (the wgmma accumulator layout)
  const int wg = warp / 4;
  const int r = (warp % 4) * 16 + lane / 4, c = (lane % 4) * 2;
  const int q0w = q0 + wg * 64;
  const bool live = q0w < a.sq;
  const int qpos[2] = {q0w + r, q0w + r + 8};
  const uint32_t q_wg = q_s + wg * L::kCB * L::kQBlock;

  float o[HD / 2];
#pragma unroll
  for (int e = 0; e < HD / 2; ++e) o[e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  if (live) mbar_wait(q_bar, 0);

  for (int i = 0; i < n_iter; ++i) {
    const int s = i % kStages;
    mbar_wait(full + 8 * s, (i / kStages) & 1);
    const int k0 = (kt_lo + i) * kBK;
    const bool hidden = !live || (a.causal && k0 > q0w + 63) ||
                        (a.has_window && k0 + kBK - 1 <= q0w - a.window);
    if (!hidden) {
      // S = Q K^T over hd in steps of 16: 32 bytes along a 128-byte row,
      // then the next column block
      const uint32_t k_st = k_s + s * L::kCB * L::kKVBlock;
      float sc[kBK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss_n128(sc, desc(q_wg + (kk / 4) * L::kQBlock + off, 16, kAtom),
                      desc(k_st + (kk / 4) * L::kKVBlock + off, 16, kAtom),
                      kk);
      }
      wgmma_commit();
      wgmma_wait_all();

      // masks, only on tiles that cross the diagonal, the window or Sk
      if ((a.causal && k0 + kBK - 1 > q0w) ||
          (a.has_window && k0 <= q0w + 63 - a.window) || k0 + kBK > a.sk) {
#pragma unroll
        for (int e = 0; e < kBK / 2; ++e) {
          const int kpos = k0 + (e / 4) * 8 + c + (e & 1);
          const int qp = qpos[(e >> 1) & 1];
          if (kpos >= a.sk || (a.causal && kpos > qp) ||
              (a.has_window && kpos <= qp - a.window))
            sc[e] = -INFINITY;
        }
      }
      // online softmax, exp2 domain; a row's scores live in a lane quad
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int e = 0; e < kBK / 2; ++e)
        mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
      float mu[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
        mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
        const float m_new = fmaxf(m[j], mx[j] * a.scale_log2);
        mu[j] = m_new == -INFINITY ? 0.f : m_new;   // a row hidden so far
        alpha[j] = exp2f(m[j] - mu[j]);
        m[j] = m_new;
      }
#pragma unroll
      for (int e = 0; e < kBK / 2; ++e) {
        const int j = (e >> 1) & 1;
        sc[e] = exp2f(fmaf(sc[e], a.scale_log2, -mu[j]));
        sum[j] += sc[e];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) l[j] = l[j] * alpha[j] + sum[j];
#pragma unroll
      for (int e = 0; e < HD / 2; ++e) o[e] *= alpha[(e >> 1) & 1];

      // O += P V: P in bf16 as the A operand, 16 keys a step
      uint32_t p[kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        p[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
        p[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        p[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        p[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
      const uint32_t v_st = v_s + s * L::kCB * L::kKVBlock;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        Mma<HD>::rs(o, p[kk], desc(v_st + kk * 2 * kAtom, L::kKVBlock, kAtom));
      wgmma_commit();
      wgmma_wait_all();
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);   // this warp is done with s
  }

  if (!live) return;
  __nv_bfloat16* ob = a.out + (long long)b * a.sq * a.nh * HD + h * HD;
  float* lb = a.lse + ((long long)b * a.nh + h) * a.sq;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
    if (qpos[j] >= a.sq) continue;
    const float inv = l[j] == 0.f ? 0.f : 1.f / l[j];
    __nv_bfloat16* row = ob + (long long)qpos[j] * a.nh * HD + c;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * n) = __floats2bfloat162_rn(
          o[4 * n + 2 * j] * inv, o[4 * n + 2 * j + 1] * inv);
    if (c == 0)
      lb[qpos[j]] = l[j] == 0.f ? kNegInf : m[j] * kLn2 + logf(l[j]);
  }
}

// cuTensorMapEncodeTiled, found through the runtime so that the library
// needs no link against libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A map over x[B, S, heads, hd] (strides in elements, hd contiguous) whose
// box is `rows` rows of 64 columns of one head, 128-byte swizzled; rows
// past S read as zeros.
bool encode(CUtensorMap* map, const void* x, int batch, int seq, int heads,
            int hd, long long sb, long long ss, long long sh, int rows) {
  const cuuint64_t dim[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                             (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t stride[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(x), dim, stride, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch(const FlashArgs& f, int batch, cudaStream_t stream) {
  if (encode_tiled() == nullptr) return kNoEncoder;
  CUtensorMap mq, mk, mv;
  const int nkv = f.nh / f.group;
  if (!encode(&mq, f.q, batch, f.sq, f.nh, HD, f.q_sb, f.q_ss, f.q_sh, 64) ||
      !encode(&mk, f.k, batch, f.sk, nkv, HD, f.k_sb, f.k_ss, f.k_sh, kBK) ||
      !encode(&mv, f.v, batch, f.sk, nkv, HD, f.v_sb, f.v_ss, f.v_sh, kBK))
    return kBadMap;
  cudaError_t e = cudaFuncSetAttribute(
      flash_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Layout<HD>::kBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  Args a{static_cast<__nv_bfloat16*>(f.out), f.lse, f.sq, f.sk, f.nh,
         f.group, (f.sq + kBQ - 1) / kBQ, f.causal, f.has_window, f.window,
         f.scale * kLog2e};
  dim3 grid(f.nh, batch, a.n_qt);
  flash_wgmma_kernel<HD>
      <<<grid, kThreads, Layout<HD>::kBytes, stream>>>(mq, mk, mv, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc
}  // namespace

// What a launch takes besides its pointers, as the wrapper packs it
// (struct.pack("<9q10if4x")): strides in elements of q, k, v (batch, seq,
// head; hd is contiguous, every stride and base 16-byte aligned), then
// batch, Sq, Sk, nh, group, hd, dtype (0 = float32, 1 = bfloat16), the
// masks and the softmax scale.
struct FlashLaunch {
  long long strides[9];
  int batch, sq, sk, nh, group, hd, dtype, causal, has_window, window;
  float scale;
};

namespace {

FlashArgs flash_args(const void* q, const void* k, const void* v, void* out,
                     float* lse, const FlashLaunch& l) {
  const long long* s = l.strides;
  return FlashArgs{q, k, v, out, lse, s[0], s[1], s[2], s[3], s[4], s[5],
                   s[6], s[7], s[8], l.sq, l.sk, l.nh, l.group, l.causal,
                   l.has_window, l.window, l.scale};
}

}  // namespace

extern "C" {

// Both entries launch on `stream` without synchronising and return
// cudaGetLastError() (0 on success) or one of the codes above; each takes
// its own dtype only (float32: FMA, bfloat16: wgmma).
int flash_attention_fwd_fma(const void* q, const void* k, const void* v,
                            void* out, float* lse, const FlashLaunch* l,
                            void* stream) {
  if (l->dtype != 0) return kUnsupported;
  const FlashArgs a = flash_args(q, k, v, out, lse, *l);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (l->hd == 64) return launch<float, 64>(a, l->batch, st);
  if (l->hd == 96) return launch<float, 96>(a, l->batch, st);
  if (l->hd == 128) return launch<float, 128>(a, l->batch, st);
  return kUnsupported;
}

int flash_attention_fwd_wgmma(const void* q, const void* k, const void* v,
                              void* out, float* lse, const FlashLaunch* l,
                              void* stream) {
  if (l->dtype != 1) return kUnsupported;
  const FlashArgs a = flash_args(q, k, v, out, lse, *l);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (l->hd == 64) return tc::launch<64>(a, l->batch, st);
  if (l->hd == 96) return tc::launch<96>(a, l->batch, st);
  if (l->hd == 128) return tc::launch<128>(a, l->batch, st);
  return kUnsupported;
}

// The dynamic shared memory one block of the entry for (dtype, hd) takes,
// or kUnsupported.
int flash_attention_smem_bytes(int dtype, int hd) {
  if (dtype == 0 && (hd == 64 || hd == 96 || hd == 128))
    return fma_smem_bytes(hd);
  if (dtype == 1 && hd == 64) return tc::Layout<64>::kBytes;
  if (dtype == 1 && hd == 96) return tc::Layout<96>::kBytes;
  if (dtype == 1 && hd == 128) return tc::Layout<128>::kBytes;
  return kUnsupported;
}

const char* flash_attention_error_string(int code) {
  switch (code) {
    case kUnsupported:
      return "unsupported dtype or head_dim for this entry";
    case kNoEncoder:
      return "libcuda does not provide cuTensorMapEncodeTiled";
    case kBadMap:
      return "cuTensorMapEncodeTiled refused a q/k/v layout";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
