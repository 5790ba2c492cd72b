// Fused dual-softmax argmax for Hopper (sm_90a): 3xTF32 on tensor cores.
//
// Replaces: onepose_tpu/ops/pallas_match.py::dual_softmax_argmax (kernel
// _kernel). For mdesc0 [B,N1,D] and mdesc1 [B,N2,D]:
//   S = mdesc0 . mdesc1^T / scale,
//   conf = softmax over N1 (S) * softmax over N2 (S),
// and it returns the row argmax and max of conf [B,N1] and the column argmax
// and max [B,N2], the lower index winning ties, without ever writing the
// [B,N1,N2] conf. No mask is applied: padded slots take part in the softmax
// statistics, and the caller applies the masks afterwards.
//
// What bounds it. One S at [8,1024]x[8,2000], D=256 is 8.4 GFLOP. The first
// port computed S four times (a row sweep and a column sweep, for the
// statistics and again for the argmax: 33.6 GFLOP) with fp32 FMA on the CUDA
// cores from single-buffered shared memory, 8 shared loads per 16 FMAs:
// 2.28 ms, 14.7 TFLOP/s, 22% of the 67 TFLOP/s fp32 peak, slower than the
// plain cuBLAS product plus softmaxes (1.82 ms). Its grid of (row + column
// blocks) x B was 96 blocks at [2,1000]x[2,1990], under the 132 SMs.
// This design computes S twice as 3xTF32 (50 GFLOP, 51 us a pass at the 495
// TFLOP/s TF32 peak) and takes 0.31 ms: split 24 us, pass 1 132 us, pass 2
// 138 us, merge 5 us (H100 80GB HBM3, 700 W). Removing the MMA does not
// shorten a pass; removing the tile loads or the epilogue each shortened one
// by a fifth. So the passes are bound by the chunk loads from L2, the
// per-chunk barrier and MMA drain, and the epilogue, with one block (8
// warps) per SM and nothing overlapping a block's epilogue.
//
// Design.
//  * Each S entry is computed once per pass, on tensor cores. A 2-D grid of
//    128x128 (N1 x N2) tiles per batch element: 8x16x8 = 1024 blocks at the
//    protocol shape, 8x16x2 = 256 at [2,1000]x[2,1990].
//  * fp32 accuracy as 3xTF32: a prologue kernel (match_split) splits each
//    operand once into hi = rna_tf32(x) and lo = rna_tf32(x - hi), padded
//    with zeros to 128-row tiles and a multiple of 32 in D, so that the tile
//    loads need no masks. S = lo.hi + hi.lo + hi.hi by wgmma.mma_async
//    m64n128k8 tf32, summed per 32-deep k-chunk on the tensor cores and
//    across chunks in fp32 with round-to-nearest (see tile_product). hi is
//    rounded explicitly: the MMA would truncate the low 13 bits, and the
//    split would not be exact. The split costs one pass over the inputs
//    (25 MB read, 50 MB written at the protocol shape) and doubles the L2
//    traffic of the tile loads (hi and lo: 512 MB a pass, against 256 MB for
//    fp32 tiles split inside the block).
//  * Both operands are K-major as they stand ([N,D] rows), which is the
//    layout wgmma takes for tf32 from shared memory. k-chunks of 32 fp32
//    (one 128-byte swizzle row) go through a 3-stage ring of cp.async
//    copies, stored in the 128-byte swizzle that the wgmma descriptors name;
//    a stage is A hi, A lo, B hi, B lo = 64 KB, so one block fills an SM.
//    Two warpgroups each own 64 rows of the tile; chunks c+1 and c+2 land
//    while chunk c is in the MMA.
//  * Pass 1 (match_pass<false>): each tile writes partial (max, sum-exp) of
//    S over its 128 columns for each row to [B, N2 tiles, N1], and over its
//    128 rows for each column to [B, N1 tiles, N2].
//  * Pass 2 (match_pass<true>): a prologue merges the partials of the
//    tile's rows and columns in tile order (the loads of the first chunks
//    are in flight meanwhile); the same product code, with the same k order,
//    gives bitwise the S that pass 1 reduced; conf is formed once per entry
//    and feeds both the row and the column partial (max conf, index).
//  * match_merge takes (max, lower index) over the partials in tile order.
//  No float atomics: every reduction has a fixed order, so results do not
//  depend on block order. Partials are laid out tile-major ([B, tiles, N])
//  so that both the epilogue writes and the merges are coalesced.
//  Ragged N1, N2: rows and columns past the end are neither counted nor
//  written. Any D: the zero padding adds nothing to S.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBM = 128;  // rows of mdesc0 per tile: two 64-row warpgroups
constexpr int kBN = 128;  // rows of mdesc1 per tile: the wgmma N
constexpr int kBK = 32;       // fp32 per k-chunk row: one 128-byte swizzle row
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowBytes = kBK * 4;
constexpr int kPieces = kRowBytes / 16;  // 16-byte pieces per row
constexpr int kTileBytes = kBM * kRowBytes;
constexpr int kStageBytes = 4 * kTileBytes;  // A hi, A lo, B hi, B lo
constexpr int kPipeBytes = kStages * kStageBytes;
constexpr int kRedBytes = 2 * kWarps * kBN * 4 + 4 * 128 * 4;
constexpr int kSmemBytes = kPipeBytes + kRedBytes + 1024;  // + alignment
static_assert(kBM == kBN, "A and B tiles share one size");
static_assert(kRowBytes == 128, "the descriptors assume the 128-byte swizzle");

struct Dims {
  int B, n1, n2, D;
  int n1p, n2p, dp;  // padded
  int t1, t2;        // tiles over N1 and N2
};

Dims make_dims(int B, int n1, int n2, int D) {
  Dims d;
  d.B = B;
  d.n1 = n1;
  d.n2 = n2;
  d.D = D;
  d.t1 = (n1 + kBM - 1) / kBM;
  d.t2 = (n2 + kBN - 1) / kBN;
  d.n1p = d.t1 * kBM;
  d.n2p = d.t2 * kBN;
  d.dp = (D + kBK - 1) / kBK * kBK;
  return d;
}

// Workspace: split operands, then partial statistics and argmax partials.
struct Work {
  float* a;       // [2][B][n1p][dp]: hi, then lo
  float* b;       // [2][B][n2p][dp]
  float* row_m;   // [B][t2][n1] partial max of S over a column tile (*)
  float* row_l;   // [B][t2][n1] partial sum of 2^(S - row_m) (*)
  float* col_m;   // [B][t1][n2]
  float* col_l;   // [B][t1][n2]
  float* row_v;   // [B][t2][n1] partial max conf
  int* row_i;     // [B][t2][n1] its column
  float* col_v;   // [B][t1][n2]
  int* col_i;     // [B][t1][n2]
};
// (*) S in log2 units, S * log2(e) / scale, so that each exponential is
// one ex2.approx; the scaling is one rounding, as the division was.

size_t carve(const Dims& d, uint8_t* base, Work* w) {
  size_t off = 0;
  auto take = [&](size_t bytes) {
    uint8_t* p = base ? base + off : nullptr;
    off += (bytes + 255) / 256 * 256;
    return p;
  };
  const size_t rows = static_cast<size_t>(d.B) * d.t2 * d.n1 * 4;
  const size_t cols = static_cast<size_t>(d.B) * d.t1 * d.n2 * 4;
  Work v;
  v.a = reinterpret_cast<float*>(take(2ull * d.B * d.n1p * d.dp * 4));
  v.b = reinterpret_cast<float*>(take(2ull * d.B * d.n2p * d.dp * 4));
  v.row_m = reinterpret_cast<float*>(take(rows));
  v.row_l = reinterpret_cast<float*>(take(rows));
  v.col_m = reinterpret_cast<float*>(take(cols));
  v.col_l = reinterpret_cast<float*>(take(cols));
  v.row_v = reinterpret_cast<float*>(take(rows));
  v.row_i = reinterpret_cast<int*>(take(rows));
  v.col_v = reinterpret_cast<float*>(take(cols));
  v.col_i = reinterpret_cast<int*>(take(cols));
  if (w) *w = v;
  return off;
}

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---- split: x -> (hi, lo), zero-padded ------------------------------------

struct SplitArgs {
  const float* src[2];
  float* dst[2];
  int n[2], np[2];
  int B, D, dp;
};

__global__ void __launch_bounds__(256) match_split(SplitArgs s) {
  const bool op = blockIdx.y;
  const int n = op ? s.n[1] : s.n[0], np = op ? s.np[1] : s.np[0];
  const int D = s.D, q = s.dp / 4;
  const float* src = op ? s.src[1] : s.src[0];
  float* dst = op ? s.dst[1] : s.dst[0];
  const size_t plane = static_cast<size_t>(s.B) * np * s.dp;
  const size_t total = plane / 4;
  for (size_t g = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       g < total; g += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int k = static_cast<int>(g % q) * 4;
    const size_t br = g / q;  // b * np + row
    const int row = static_cast<int>(br % np);
    const size_t b = br / np;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (row < n) {
      const float* p = src + (b * n + row) * D + k;
      if (D % 4 == 0) {
        if (k < D) {
          const float4 v = *reinterpret_cast<const float4*>(p);
          x[0] = v.x;
          x[1] = v.y;
          x[2] = v.z;
          x[3] = v.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k + e < D) x[e] = p[e];
      }
    }
    float4 hi, lo;
    hi.x = tf32_rna(x[0]);
    hi.y = tf32_rna(x[1]);
    hi.z = tf32_rna(x[2]);
    hi.w = tf32_rna(x[3]);
    lo.x = tf32_rna(x[0] - hi.x);
    lo.y = tf32_rna(x[1] - hi.y);
    lo.z = tf32_rna(x[2] - hi.z);
    lo.w = tf32_rna(x[3] - hi.w);
    reinterpret_cast<float4*>(dst)[g] = hi;
    reinterpret_cast<float4*>(dst + plane)[g] = lo;
  }
}

// ---- the tile product ------------------------------------------------------

// Byte offset of 16-byte piece p of row r in an operand tile in the
// 128-byte swizzle: the piece index is XORed with the row's address bits
// [7, 10), i.e. with r % 8.
__device__ __forceinline__ uint32_t swizzled(int r, int p) {
  return r * kRowBytes + ((p ^ (r & 7)) << 4);
}

// wgmma shared-memory descriptor of a K-major tile in the 128-byte swizzle,
// 8-row groups 1024 bytes apart, starting on a 1024-byte boundary.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  return smem_desc(addr, 16, 1024, kSwizzle128B);  // LBO unused here
}

// d[64] = A[64 x 8] . B[128 x 8]^T (+ d if accumulate), tf32 operands,
// fp32 accumulator.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t a,
                                           uint64_t b, int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

struct Operands {
  const float* a_hi;  // this tile's first row of A hi; lo is lo_off later
  const float* b_hi;
  size_t a_lo_off, b_lo_off;
  int dp;
};

// Copy k-chunk kc of the four operand tiles into the stage at `st`.
__device__ __forceinline__ void load_chunk(uint32_t st, const Operands& o,
                                           int kc) {
  constexpr int kPer = kBM * kPieces / kThreads;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float* base = t < 2 ? o.a_hi + (t == 1 ? o.a_lo_off : 0)
                              : o.b_hi + (t == 3 ? o.b_lo_off : 0);
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int id = q * kThreads + threadIdx.x;
      const int r = id / kPieces;
      const int p = id % kPieces;
      cp_async16(st + t * kTileBytes + swizzled(r, p),
                 base + static_cast<size_t>(r) * o.dp + kc * kBK + p * 4);
    }
  }
}

// acc = the 64 x 128 part of mdesc0 . mdesc1^T that this warpgroup owns
// (rows 64 * warpgroup + ..., see the epilogues), in a fixed k order: each
// chunk's lo.hi + hi.lo + hi.hi is summed on the tensor cores into a fresh
// `part`, then added to acc in fp32 with round-to-nearest. (The tensor
// cores' own accumulation loses low bits as the sum grows: one running
// accumulator over all of D put the max conf 1.5e-5 from an fp64 product on
// peaked inputs, this 4e-6.) `meanwhile` runs while the first chunks load.
template <typename F>
__device__ __forceinline__ void tile_product(float (&acc)[64], uint32_t pipe,
                                             const Operands& o, F meanwhile) {
  const int nk = o.dp / kBK;
  const uint32_t a_row = (threadIdx.x / 128) * 64 * kRowBytes;
  float part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_chunk(pipe + s * kStageBytes, o, s);
    cp_async_commit();
  }
  meanwhile();
  for (int c = 0; c < nk; ++c) {
    // chunk c has landed for every thread, and chunk c - 1 has left the
    // MMA of both warpgroups, so its stage can be refilled
    cp_async_wait<kStages - 2>();
    fence_proxy_async();
    __syncthreads();
    const int next = c + kStages - 1;
    if (next < nk) load_chunk(pipe + (next % kStages) * kStageBytes, o, next);
    cp_async_commit();

    const uint32_t st = pipe + (c % kStages) * kStageBytes;
    const uint64_t a_hi = make_desc(st + a_row);
    const uint64_t a_lo = make_desc(st + kTileBytes + a_row);
    const uint64_t b_hi = make_desc(st + 2 * kTileBytes);
    const uint64_t b_lo = make_desc(st + 3 * kTileBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
      const uint64_t k = 2 * kk;  // 8 tf32 = 32 bytes, in 16-byte units
      wgmma_tf32(part, a_lo + k, b_hi + k, kk > 0);
      wgmma_tf32(part, a_hi + k, b_lo + k);
      wgmma_tf32(part, a_hi + k, b_hi + k);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(part);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
  }
}

// ---- the two passes --------------------------------------------------------

struct PassArgs {
  Dims d;
  float log2e_scale;  // log2(e) / scale
  Work w;
};

// Accumulator layout of wgmma m64nN (per warpgroup): element 4n + 2i + j
// is row 16 * warp + lane / 4 + 8 i, column 8 n + 2 (lane % 4) + j.
template <bool kArgmax>
__global__ void __launch_bounds__(kThreads, 1) match_pass(PassArgs a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t pipe = (raw + 1023) & ~1023u;
  float* red_v = reinterpret_cast<float*>(smem_raw + (pipe - raw) + kPipeBytes);
  int* red_i = reinterpret_cast<int*>(red_v + kWarps * kBN);
  float* stat = reinterpret_cast<float*>(red_i + kWarps * kBN);  // [4][128]

  const Dims& d = a.d;
  const int tn = blockIdx.x, tm = blockIdx.y, b = blockIdx.z;
  const int m0 = tm * kBM, n0 = tn * kBN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  Operands o;
  o.dp = d.dp;
  o.a_lo_off = static_cast<size_t>(d.B) * d.n1p * d.dp;
  o.b_lo_off = static_cast<size_t>(d.B) * d.n2p * d.dp;
  o.a_hi = a.w.a + (static_cast<size_t>(b) * d.n1p + m0) * d.dp;
  o.b_hi = a.w.b + (static_cast<size_t>(b) * d.n2p + n0) * d.dp;

  const size_t row_base = (static_cast<size_t>(b) * d.t2 + tn) * d.n1;
  const size_t col_base = (static_cast<size_t>(b) * d.t1 + tm) * d.n2;

  // Pass 2 merges pass 1's partials for this tile's rows (threads 0-127)
  // and columns (128-255), in tile order; read after the product's
  // barriers.
  auto merge_stats = [&]() {
    if (!kArgmax) return;
    const bool is_row = tid < 128;
    const int x = (is_row ? m0 : n0) + (tid & 127);
    const int n = is_row ? d.n1 : d.n2;
    const int parts = is_row ? d.t2 : d.t1;
    const float* pm = (is_row ? a.w.row_m : a.w.col_m) +
                      static_cast<size_t>(b) * parts * n + x;
    const float* pl = (is_row ? a.w.row_l : a.w.col_l) +
                      static_cast<size_t>(b) * parts * n + x;
    float m = 0.f, inv_l = 1.f;
    if (x < n) {
      m = -CUDART_INF_F;
      for (int t = 0; t < parts; ++t) m = fmaxf(m, pm[static_cast<size_t>(t) * n]);
      float l = 0.f;
      for (int t = 0; t < parts; ++t)
        l += pl[static_cast<size_t>(t) * n] *
             exp2_approx(pm[static_cast<size_t>(t) * n] - m);
      inv_l = 1.f / l;
    }
    stat[(is_row ? 0 : 256) + (tid & 127)] = m;
    stat[(is_row ? 128 : 384) + (tid & 127)] = inv_l;
  };

  float acc[64];
  tile_product(acc, pipe, o, merge_stats);

  const int r0 = warp * 16 + (lane >> 2);  // tile rows r0 and r0 + 8
  const int c0 = 2 * (lane & 3);           // tile columns c0 + 8 n + j
  bool row_ok[2], col_ok[32];
#pragma unroll
  for (int i = 0; i < 2; ++i) row_ok[i] = m0 + r0 + 8 * i < d.n1;
#pragma unroll
  for (int e = 0; e < 32; ++e) col_ok[e] = n0 + c0 + 8 * (e >> 1) + (e & 1) < d.n2;
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] *= a.log2e_scale;
  // element index of (column slot e, row i)
#define ACC(e, i) acc[4 * ((e) >> 1) + 2 * (i) + ((e) & 1)]
#define COL(e) (c0 + 8 * ((e) >> 1) + ((e) & 1))

  if (!kArgmax) {
    // row partials: max and sum-exp over this tile's columns
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float m = -CUDART_INF_F;
#pragma unroll
      for (int e = 0; e < 32; ++e)
        if (col_ok[e]) m = fmaxf(m, ACC(e, i));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      float l = 0.f;
#pragma unroll
      for (int e = 0; e < 32; ++e)
        if (col_ok[e]) l += exp2_approx(ACC(e, i) - m);
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      if ((lane & 3) == 0 && row_ok[i]) {
        a.w.row_m[row_base + m0 + r0 + 8 * i] = m;
        a.w.row_l[row_base + m0 + r0 + 8 * i] = l;
      }
    }
    // column partials: max over the tile's rows, through shared memory
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      float m = fmaxf(row_ok[0] ? ACC(e, 0) : -CUDART_INF_F,
                      row_ok[1] ? ACC(e, 1) : -CUDART_INF_F);
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 8));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
      if (lane < 4) red_v[warp * kBN + COL(e)] = m;
    }
    __syncthreads();
    if (tid < kBN) {
      float m = red_v[tid];
      for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red_v[w * kBN + tid]);
      stat[tid] = m;
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const float m = stat[COL(e)];
      float l = (row_ok[0] ? exp2_approx(ACC(e, 0) - m) : 0.f) +
                (row_ok[1] ? exp2_approx(ACC(e, 1) - m) : 0.f);
      l += __shfl_xor_sync(0xffffffffu, l, 4);
      l += __shfl_xor_sync(0xffffffffu, l, 8);
      l += __shfl_xor_sync(0xffffffffu, l, 16);
      if (lane < 4) red_v[warp * kBN + COL(e)] = l;
    }
    __syncthreads();
    if (tid < kBN && n0 + tid < d.n2) {
      float l = 0.f;
      for (int w = 0; w < kWarps; ++w) l += red_v[w * kBN + tid];
      a.w.col_m[col_base + n0 + tid] = stat[tid];
      a.w.col_l[col_base + n0 + tid] = l;
    }
  } else {
    // conf once per entry; -1 marks entries outside N1 x N2
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float rm = stat[r0 + 8 * i], rinv = stat[128 + r0 + 8 * i];
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const float v = ACC(e, i);
        const float c =
            (exp2_approx(v - rm) * rinv) *
            (exp2_approx(v - stat[256 + COL(e)]) * stat[384 + COL(e)]);
        ACC(e, i) = row_ok[i] && col_ok[e] ? c : -1.f;
      }
    }
    // row partials: (max conf, lowest column) over this tile's columns
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float bv = -1.f;
      int bi = 0x7fffffff;
#pragma unroll
      for (int e = 0; e < 32; ++e)
        if (better(ACC(e, i), n0 + COL(e), bv, bi)) {
          bv = ACC(e, i);
          bi = n0 + COL(e);
        }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float v = __shfl_xor_sync(0xffffffffu, bv, off);
        const int j = __shfl_xor_sync(0xffffffffu, bi, off);
        if (better(v, j, bv, bi)) {
          bv = v;
          bi = j;
        }
      }
      if ((lane & 3) == 0 && row_ok[i]) {
        a.w.row_v[row_base + m0 + r0 + 8 * i] = bv;
        a.w.row_i[row_base + m0 + r0 + 8 * i] = bi;
      }
    }
    // column partials: (max conf, lowest row), warps through shared memory
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      float bv = ACC(e, 0);
      int bi = m0 + r0;
      if (better(ACC(e, 1), m0 + r0 + 8, bv, bi)) {
        bv = ACC(e, 1);
        bi = m0 + r0 + 8;
      }
#pragma unroll
      for (int off = 4; off <= 16; off <<= 1) {
        const float v = __shfl_xor_sync(0xffffffffu, bv, off);
        const int j = __shfl_xor_sync(0xffffffffu, bi, off);
        if (better(v, j, bv, bi)) {
          bv = v;
          bi = j;
        }
      }
      if (lane < 4) {
        red_v[warp * kBN + COL(e)] = bv;
        red_i[warp * kBN + COL(e)] = bi;
      }
    }
    __syncthreads();
    if (tid < kBN && n0 + tid < d.n2) {
      float bv = red_v[tid];
      int bi = red_i[tid];
      for (int w = 1; w < kWarps; ++w)
        if (better(red_v[w * kBN + tid], red_i[w * kBN + tid], bv, bi)) {
          bv = red_v[w * kBN + tid];
          bi = red_i[w * kBN + tid];
        }
      a.w.col_v[col_base + n0 + tid] = bv;
      a.w.col_i[col_base + n0 + tid] = bi;
    }
  }
#undef ACC
#undef COL
}

// ---- final merge -----------------------------------------------------------

__global__ void __launch_bounds__(256)
    match_merge(Dims d, Work w, int* idx0, float* max0, int* idx1,
                float* max1) {
  const size_t g = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
  const size_t rows = static_cast<size_t>(d.B) * d.n1;
  if (g >= rows + static_cast<size_t>(d.B) * d.n2) return;
  const bool is_row = g < rows;
  const size_t h = is_row ? g : g - rows;
  const int n = is_row ? d.n1 : d.n2;
  const int parts = is_row ? d.t2 : d.t1;
  const size_t b = h / n, x = h % n;
  const float* pv = (is_row ? w.row_v : w.col_v) + b * parts * n + x;
  const int* pi = (is_row ? w.row_i : w.col_i) + b * parts * n + x;
  float bv = pv[0];
  int bi = pi[0];
  for (int t = 1; t < parts; ++t) {
    const float v = pv[static_cast<size_t>(t) * n];
    const int i = pi[static_cast<size_t>(t) * n];
    if (better(v, i, bv, bi)) {
      bv = v;
      bi = i;
    }
  }
  (is_row ? idx0 : idx1)[h] = bi;
  (is_row ? max0 : max1)[h] = bv;
}

}  // namespace

// Bytes of device scratch that match_forward needs for these sizes.
extern "C" size_t match_workspace_bytes(int B, int n1, int n2, int D) {
  return carve(make_dims(B, n1, n2, D), nullptr, nullptr);
}

// Four launches on `stream`, none of which synchronises: split, statistics
// pass, argmax pass, merge. `work` holds match_workspace_bytes(B, n1, n2, D)
// bytes, 256-byte aligned; d0 and d1 are 16-byte aligned.
extern "C" int match_forward(const float* d0, const float* d1, int B, int n1,
                             int n2, int D, float scale, void* work, int* idx0,
                             float* max0, int* idx1, float* max1,
                             cudaStream_t stream) {
  const Dims d = make_dims(B, n1, n2, D);
  Work w;
  carve(d, static_cast<uint8_t*>(work), &w);

  SplitArgs s;
  s.src[0] = d0;
  s.src[1] = d1;
  s.dst[0] = w.a;
  s.dst[1] = w.b;
  s.n[0] = n1;
  s.n[1] = n2;
  s.np[0] = d.n1p;
  s.np[1] = d.n2p;
  s.B = B;
  s.D = D;
  s.dp = d.dp;
  const size_t quads = static_cast<size_t>(B) * d.n2p * d.dp / 4;
  const size_t quads_a = static_cast<size_t>(B) * d.n1p * d.dp / 4;
  const size_t most = quads > quads_a ? quads : quads_a;
  const unsigned split_blocks =
      static_cast<unsigned>(most / 256 + 1 < 65535 ? most / 256 + 1 : 65535);
  match_split<<<dim3(split_blocks, 2), 256, 0, stream>>>(s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // set on every call: the attribute belongs to the current device
  err = cudaFuncSetAttribute(match_pass<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(match_pass<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  PassArgs p;
  p.d = d;
  p.log2e_scale = static_cast<float>(1.4426950408889634 / scale);
  p.w = w;
  const dim3 grid(d.t2, d.t1, B);
  match_pass<false><<<grid, kThreads, kSmemBytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  match_pass<true><<<grid, kThreads, kSmemBytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const size_t outs = static_cast<size_t>(B) * (n1 + n2);
  match_merge<<<static_cast<unsigned>((outs + 255) / 256), 256, 0, stream>>>(
      d, w, idx0, max0, idx1, max1);
  return static_cast<int>(cudaGetLastError());
}
