// Fused SuperPoint stem for Hopper (sm_90a): conv1b as a 3xTF32 implicit
// GEMM on the tensor cores.
//
// Replaces: onepose_tpu/ops/pallas_stem.py::fused_stem_tiled (kernel
// _kernel_tiled) and its whole-width twin fused_stem (kernel _kernel), which
// compute the same function: conv1a 3x3 1->64 + bias + ReLU, conv1b 3x3
// 64->64 + bias + ReLU, then a 2x2 max-pool with stride 2. Both convs use SAME
// zero padding, so conv1a's values outside the image are zero for conv1b.
//
// What bounds it. At [8,512,512,1] conv1b is 8 * 512^2 * 576 * 64 = 7.73e10
// FMA (154.6 GFLOP) and conv1a 1.2e9 FMA (2.4 GFLOP), against 8.4 MB of
// input and 134.2 MB of pooled output, so operations bound it. fp32 FMA on
// the CUDA cores could not go below 154.6 GFLOP / 67 TFLOP/s = 2.31 ms. A
// single TF32 or bf16 product keeps about three decimal digits, too few for
// the stem's max|d| < 1e-4 * max(|ref|, 1) gate; three TF32 products
// (hi.hi + hi.lo + lo.hi) are fp32-class, and their least time is
// 3 * 154.6 GFLOP / 495 TFLOP/s = 0.937 ms. Unfused, the two [B,H,W,64]
// fp32 activations (537 MB each) would go to device memory and back.
//
// Design. A block takes kRows = 4 output rows x kTW = 64 columns of one
// image (256 pixels, the M tile); two warpgroups own two rows each. Steps
// 2, 4 and 5 are conv3x3.cuh's, which encoder.cu shares.
//  1. The input tile with a 2-px halo goes to shared memory, then conv1a +
//     bias + ReLU (fp32 FMA, 1.5% of the work) on the 6 x 66 tile with a
//     1-px halo, stored as [cin/4][pixel][4] floats (pixel = row * 66 +
//     col), zero outside the image.
//  2. conv1b as D[pixel][cout] = sum over 9 taps and 64 cin of
//     A[pixel + shift(tap)][cin] * W[tap][cin][cout]: for each tap and row,
//     one 64 x 64 product over K = 64 cin in 8 k-steps of
//     wgmma.mma_async m64n64k8 tf32, A (64 pixels) from registers, B (the
//     tap's weights) from shared memory. A tap only moves where the
//     fragment loads start (dy * 66 + dx pixels on): no copy per tap. The
//     loads are conflict-free, 8 pixels x one cin quad (128 bytes) a warp.
//     Each fragment is split in registers into hi = rna_tf32(a) and
//     lo = rna_tf32(a - hi), rounded in two integer operations
//     (tf32_round): cvt.rna.tf32.f32 compiles to a longer sequence with a
//     finite check (2.20 ms with it, 1.89 ms with tf32_round). Per k-step
//     lo.hi + hi.lo + hi.hi. A group is issued in two halves of 4 k-steps;
//     while the second half is in the MMA, the first half of the next
//     group's fragments is loaded and split (2.20 -> 1.85 ms with both).
//  3. Each tap's sum is taken on the tensor cores into a fresh register tile
//     and added to the running sum in fp32 round-to-nearest, as match.cu
//     does per chunk. One running accumulator a row was 3% faster but put
//     the [8,512,512] output 9.2e-6 from an fp64 reference, 4.8x cuDNN
//     fp32's 1.9e-6; per tap it is 1.2e-6.
//  4. Weights stream tap by tap through a 2-stage ring, no workspace and no
//     second launch: each thread holds 16 fp32 of tap t + 1 (loaded from L2
//     while tap t is in the MMA) and, after its MMAs, writes their hi and lo
//     into the other stage in wgmma's no-swizzle K-major layout
//     [cin/4][cout][4] (8-cout core matrices 128 B apart, cin quads 1 KB
//     apart). L2 weight traffic: 147 KB a block, 1.2 GB at [8,512,512].
//  5. Pool in registers: a warpgroup's two accumulators are image rows y and
//     y + 1 of the same 64 columns, so the vertical max stays in the thread;
//     pixels m and m + 1 are accumulator rows one __shfl_xor_sync(.., 4)
//     apart. relu(max + bias) == max(relu(. + bias)) since rounding is
//     monotone. Only the pooled [B,H/2,W/2,64] output reaches device memory,
//     as float2s that fill whole 32-byte sectors.
// Shared memory 171,648 bytes a block (one block an SM), 206 registers, no
// spills (ptxas). At [8,512,512,1]: 1.85 ms, 50% of the 0.937 ms bound
// (H100 80GB HBM3, 700 W; times from scripts/time_torch_stem.py). What is left: a block's conv1a and epilogue
// overlap no MMA (one block an SM), each group drains the MMA before its
// fp32 add, and the per-tap barrier brings both warpgroups into step.
// Ragged H and W: conv1a is zero outside the image, and rows and columns
// past the end are not stored.

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv3x3.cuh"

namespace {

using namespace conv3x3;

constexpr int kIW = kTW + 4;         // input tile (2-px halo)
constexpr int kIH = kRows + 4;

constexpr int kOffW = 0;                                // [2][hi, lo][16][64][4]
constexpr int kOffA = kOffW + 2 * kStageBytes;          // [16][kAP][4]
constexpr int kOffIn = kOffA + kTileBytes;              // [kIH][kIW]
constexpr int kOffW1a = kOffIn + kIH * kIW * 4;         // [9][64]
constexpr int kOffB1a = kOffW1a + 9 * kC * 4;           // [64]
constexpr int kSmemBytes = kOffB1a + kC * 4;
static_assert(kSmemBytes == 171648, "the source note states this size");

__global__ void __launch_bounds__(kThreads, 1)
stem_kernel(const float* __restrict__ img, const float* __restrict__ w1a,
            const float* __restrict__ b1a, const float* __restrict__ w1b,
            const float* __restrict__ b1b, float* __restrict__ out,
            int H, int W) {
  extern __shared__ __align__(128) uint8_t smem[];
  float4* s_w = reinterpret_cast<float4*>(smem + kOffW);
  float* s_a = reinterpret_cast<float*>(smem + kOffA);
  float* s_in = reinterpret_cast<float*>(smem + kOffIn);
  float* s_w1a = reinterpret_cast<float*>(smem + kOffW1a);
  float* s_b1a = reinterpret_cast<float*>(smem + kOffB1a);
  const uint32_t w_base = smem_addr(smem + kOffW);

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kRows;
  const int x0 = blockIdx.x * kTW;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = (tid >> 5) & 3, wg = tid >> 7;
  const float* im = img + static_cast<size_t>(b) * H * W;

  float wreg[kWPer];
  load_tap(w1b, kC, wreg);
  for (int i = tid; i < kIH * kIW; i += kThreads) {
    const int r = y0 - 2 + i / kIW;
    const int c = x0 - 2 + i % kIW;
    s_in[i] = (r >= 0 && r < H && c >= 0 && c < W)
                  ? im[static_cast<size_t>(r) * W + c] : 0.f;
  }
  for (int i = tid; i < 9 * kC; i += kThreads) s_w1a[i] = w1a[i];
  if (tid < kC) s_b1a[tid] = b1a[tid];
  store_tap(wreg, s_w);
  __syncthreads();

  // conv1a + ReLU on the halo tile, one pixel x channel quad an item; zero
  // where conv1b's SAME padding reads outside the image.
  for (int i = tid; i < kQuads * kAP; i += kThreads) {
    const int q = i / kAP, p = i % kAP;
    const int ty = p / kAW, tx = p % kAW;
    const int r = y0 - 1 + ty, c = x0 - 1 + tx;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (r >= 0 && r < H && c >= 0 && c < W) {
      float x[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) x[k] = s_in[(ty + k / 3) * kIW + tx + k % 3];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ch = 4 * q + e;
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < 9; ++k) acc = fmaf(x[k], s_w1a[k * kC + ch], acc);
        v[e] = fmaxf(acc + s_b1a[ch], 0.f);
      }
    }
    reinterpret_cast<float4*>(s_a)[q * kAP + p] =
        make_float4(v[0], v[1], v[2], v[3]);
  }

  // conv1b, as 18 groups (tap, row), each the product over K = 64 cin in
  // two halves of 4 k-steps. While the second half is in the MMA, the first
  // half of the next group's fragments is loaded and split.
  const int m = 16 * warp + (lane >> 2);
  const int kq = lane & 3;
  const float* a_wg = s_a + (2 * wg * kAW + m) * 4 + kq;
  auto a_at = [&](int tap, int ry) {
    return a_wg + ((ry + tap / 3) * kAW + tap % 3) * 4;
  };
  float acc[2][32];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[r][i] = 0.f;
  float part[32];
  Frags f0, f1;
  fence_proxy_async();
  __syncthreads();  // the conv1a tile and tap 0's weights are in place
  load_frags(a_at(0, 0), 0, f0);

  for (int tap = 0; tap < 9; ++tap) {
    if (tap + 1 < 9) load_tap(w1b + (tap + 1) * kTapFloats, kC, wreg);
    const uint32_t st = w_base + (tap & 1) * kStageBytes;
#pragma unroll
    for (int ry = 0; ry < 2; ++ry) {
      wgmma_fence();
      issue_half(part, f0, st, 0, true);
      wgmma_commit();
      load_frags(a_at(tap, ry), 1, f1);
      wgmma_fence();
      issue_half(part, f1, st, 1, false);
      wgmma_commit();
      wgmma_wait<1>();  // the first half has left the MMA: f0 is free
      const int next = ry ? tap + 1 : tap;
      if (next < 9) load_frags(a_at(next, ry ^ 1), 0, f0);
      wgmma_wait<0>();
      fence_operands(part);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[ry][i] += part[i];
    }
    if (tap + 1 < 9) {
      // every warpgroup has finished tap - 1, which read the other stage
      store_tap(wreg, s_w + ((tap + 1) & 1) * kStageBytes / 16);
      fence_proxy_async();
      __syncthreads();
    }
  }

  const int H2 = H / 2, W2 = W / 2;
  const int oy = y0 / 2 + wg;
  store_pooled(acc, b1b, out + (static_cast<size_t>(b) * H2 + oy) * W2 * kC,
               kC, x0, W2, oy < H2);
}

}  // namespace

// images [B,H,W] fp32; w1a [3,3,1,64] and w1b [3,3,64,64] HWIO; b1a, b1b [64];
// out [B,H/2,W/2,64]. H and W even. All pointers contiguous, 16-byte aligned.
extern "C" int stem_forward(const float* img, const float* w1a,
                            const float* b1a, const float* w1b,
                            const float* b1b, float* out, int B, int H, int W,
                            cudaStream_t stream) {
  // set on every call: the attribute belongs to the current device
  cudaError_t err = cudaFuncSetAttribute(
      stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + kTW - 1) / kTW, (H + kRows - 1) / kRows, B);
  stem_kernel<<<grid, kThreads, kSmemBytes, stream>>>(img, w1a, b1a, w1b,
                                                      b1b, out, H, W);
  return static_cast<int>(cudaGetLastError());
}
