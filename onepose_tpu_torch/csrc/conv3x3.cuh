// The 3x3 convolution as a 3xTF32 implicit GEMM on Hopper's tensor cores:
// the pieces that stem.cu (conv1b) and encoder.cu (the encoder's
// convolutions) share.
//
// A block of kThreads = 256 threads (two warpgroups) computes kRows = 4
// output rows x kTW = 64 columns x kC = 64 output channels; warpgroup g owns
// rows 2 g and 2 g + 1, one wgmma M tile each. Its input is a kAH x kAW
// tile of 64 channels with a 1-px halo in shared memory, stored as
// [cin/4][pixel][4] floats (pixel = row * kAW + col), so that a warp's
// fragment load (8 pixels x one channel quad, 128 bytes) is conflict-free.
// A tap's weights, 64 cin x 64 cout, are a stage of wgmma's no-swizzle
// K-major layout [cin/4][cout][4], hi then lo (8-cout core matrices 128 B
// apart, cin quads 1 KB apart). A product over 64 cin is 8 k-steps of
// wgmma.mma_async m64n64k8 tf32, A from registers, each fragment split
// into hi = rna_tf32(a) and lo = rna_tf32(a - hi) (tf32_round), and each
// k-step lo.hi + hi.lo + hi.hi: three TF32 products, fp32-class.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace conv3x3 {

using namespace hopper;

constexpr int kC = 64;               // channels in and out of one product
constexpr int kTW = 64;              // output columns a block: wgmma's M
constexpr int kRows = 4;             // output rows a block: 2 a warpgroup
constexpr int kAW = kTW + 2;         // input tile (1-px halo)
constexpr int kAH = kRows + 2;
constexpr int kAP = kAW * kAH;       // input tile pixels
constexpr int kThreads = 256;
constexpr int kQuads = kC / 4;       // channel quads
constexpr int kTapFloats = kC * kC;
constexpr int kWPer = kTapFloats / kThreads;  // weights a thread stages a tap
constexpr int kHalfBytes = kTapFloats * 4;    // hi (or lo) of one tap
constexpr int kStageBytes = 2 * kHalfBytes;
constexpr int kTileBytes = kQuads * kAP * 16;

// d[32] (+)= A[64 x 8] . B[64 x 8]^T, A tf32 in registers (wgmma's fragment:
// a0 (row lane/4, col lane%4), a1 row + 8, a2 col + 4, a3 both, rows
// 16 * warp on), B by descriptor, fp32 accumulator.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// This thread's 16 weights of a tap, w[(4 q + e) * cout_stride + co] for
// cin quad q = idx / 64, cout co = idx % 64, idx = tid + 256 * it; a warp
// reads 32 consecutive couts.
__device__ __forceinline__ void load_tap(const float* __restrict__ w,
                                         int cout_stride, float (&reg)[kWPer]) {
#pragma unroll
  for (int it = 0; it < kWPer / 4; ++it) {
    const int idx = it * kThreads + threadIdx.x;
    const int q = idx / kC, co = idx % kC;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      reg[4 * it + e] = __ldg(w + (4 * q + e) * cout_stride + co);
  }
}

// Their hi and lo into one stage, [cin/4][cout][4] each.
__device__ __forceinline__ void store_tap(const float (&w)[kWPer],
                                          float4* stage) {
#pragma unroll
  for (int it = 0; it < kWPer / 4; ++it) {
    const int idx = it * kThreads + threadIdx.x;  // == q * 64 + co
    float4 hi, lo;
    hi.x = tf32_round(w[4 * it + 0]);
    hi.y = tf32_round(w[4 * it + 1]);
    hi.z = tf32_round(w[4 * it + 2]);
    hi.w = tf32_round(w[4 * it + 3]);
    lo.x = tf32_round(w[4 * it + 0] - hi.x);
    lo.y = tf32_round(w[4 * it + 1] - hi.y);
    lo.z = tf32_round(w[4 * it + 2] - hi.z);
    lo.w = tf32_round(w[4 * it + 3] - hi.w);
    stage[idx] = hi;
    stage[kTapFloats / 4 + idx] = lo;
  }
}

// Half a group's A fragments, k-steps 4 h .. 4 h + 3, split into hi and lo.
// Rows: pixels m and m + 8 of the row, m = 16 warp + lane / 4; columns:
// cin 8 kk + lane % 4 (plane 2 kk) and + 4 (plane 2 kk + 1). `a` points at
// pixel m of the row, tap's shift included, plane 0, element lane % 4.
struct Frags {
  uint32_t hi[4][4], lo[4][4];
};

__device__ __forceinline__ void load_frags(const float* a, int h, Frags& f) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int kk = 4 * h + k;
      const float x = a[((2 * kk + (r >> 1)) * kAP + 8 * (r & 1)) * 4];
      const float hi = tf32_round(x);
      f.hi[k][r] = __float_as_uint(hi);
      f.lo[k][r] = __float_as_uint(tf32_round(x - hi));
    }
}

// part (+)= the half's lo.hi + hi.lo + hi.hi against the weights of the
// stage at `st`; with `fresh` the half starts the sum afresh.
__device__ __forceinline__ void issue_half(float (&part)[32], const Frags& f,
                                           uint32_t st, int h, bool fresh) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // cin quads 2 kk and 2 kk + 1, 1 KB apart (LBO); couts 8 by 8, 128 B
    // apart (SBO)
    const uint32_t k_off = (4 * h + k) * 2 * kC * 16;
    const uint64_t b_hi = smem_desc(st + k_off, kC * 16, 128, kNoSwizzle);
    const uint64_t b_lo =
        smem_desc(st + kHalfBytes + k_off, kC * 16, 128, kNoSwizzle);
    wgmma_rs(part, f.lo[k], b_hi, !fresh || k > 0);
    wgmma_rs(part, f.hi[k], b_lo);
    wgmma_rs(part, f.hi[k], b_hi);
  }
}

// 2x2 max-pool of a warpgroup's two accumulators (image rows y and y + 1 of
// the same 64 columns, so the vertical max stays in the thread; pixels m
// and m + 1 are accumulator rows one __shfl_xor_sync(.., 4) apart), then +
// bias and ReLU: relu(max + bias) == max(relu(. + bias)) since rounding is
// monotone. Accumulator element 4 n + 2 i + j: pixel m + 8 i, cout
// 8 n + 2 kq + j. `row` is the pooled output row (cout 0 of pixel 0),
// `stride` the floats between its pixels; stored as float2s that fill whole
// 32-byte sectors, for columns below w2 and only if `row_ok`.
__device__ __forceinline__ void store_pooled(const float (&acc)[2][32],
                                             const float* __restrict__ bias,
                                             float* row, int stride, int x0,
                                             int w2, bool row_ok) {
  const int lane = threadIdx.x & 31, kq = lane & 3;
  const int m = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int ox = (x0 + m + 8 * i) / 2;
    const bool store = ((lane >> 2) & 1) == 0 && row_ok && ox < w2;
    float* o = row + static_cast<size_t>(ox) * stride;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float v[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int e = 4 * n + 2 * i + j;
        v[j] = fmaxf(acc[0][e], acc[1][e]);
        v[j] = fmaxf(v[j], __shfl_xor_sync(0xffffffffu, v[j], 4));
      }
      const int co = 8 * n + 2 * kq;
      if (store)
        *reinterpret_cast<float2*>(o + co) =
            make_float2(fmaxf(v[0] + __ldg(bias + co), 0.f),
                        fmaxf(v[1] + __ldg(bias + co + 1), 0.f));
    }
  }
}

}  // namespace conv3x3
