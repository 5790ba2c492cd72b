// Fused SuperPoint stem for Hopper (sm_90a), fp32.
//
// Replaces: onepose_tpu/ops/pallas_stem.py::fused_stem_tiled (kernel
// _kernel_tiled) and its whole-width twin fused_stem (kernel _kernel), which
// compute the same function: conv1a 3x3 1->64 + bias + ReLU, conv1b 3x3
// 64->64 + bias + ReLU, then a 2x2 max-pool with stride 2. Both convs use SAME
// zero padding, so conv1a's values outside the image are zero for conv1b.
//
// What bounds it: conv1b is 36,864 FMAs per full-resolution pixel, 9.7e9 for
// a [8,512,512] batch, against 8 MB of input and 33.5 MB of output. Unfused,
// the two [B,H,W,64] fp32 activations (537 MB each) would go to device memory
// and back. Fused, the kernel is bound by fp32 FMA issue: TF32 or bf16 tensor
// cores are ruled out by the 1e-4 relative tolerance the port holds.
//
// Design: one block per 16x16 full-resolution tile of one image.
//   1. The input tile with a 2-px halo goes to shared memory.
//   2. conv1a + ReLU for the tile plus a 1-px halo goes to shared memory,
//      channel-major ([64][18*18]); positions outside the image are zeroed.
//   3. conv1b runs from shared memory, one 64x64 weight tap staged in shared
//      memory at a time. Each thread keeps a 2x2-pixel x 16-channel register
//      tile, so the 2x2 pool is taken in registers.
//   4. The pooled [8,8,64] tile is the single store, as float4s.
// Nothing but the pooled output reaches device memory.

#include <cuda_runtime.h>

namespace {

constexpr int kC = 64;              // channels of conv1a and conv1b
constexpr int kT = 16;              // full-resolution tile edge
constexpr int kTA = kT + 2;         // conv1a tile edge (1-px halo)
constexpr int kTI = kT + 4;         // input tile edge (2-px halo)
constexpr int kThreads = 256;
constexpr int kCG = 16;             // output channels per thread
constexpr int kPoolT = kT / 2;      // pooled tile edge

constexpr int kSmemFloats = kC * kTA * kTA   // conv1a tile
                          + kC * kC          // one tap of conv1b weights
                          + kTI * kTI        // input tile
                          + 9 * kC + kC;     // conv1a weights and bias

__global__ void __launch_bounds__(kThreads)
stem_kernel(const float* __restrict__ img, const float* __restrict__ w1a,
            const float* __restrict__ b1a, const float* __restrict__ w1b,
            const float* __restrict__ b1b, float* __restrict__ out,
            int H, int W) {
  extern __shared__ float4 smem4[];
  float* s_a = reinterpret_cast<float*>(smem4);  // [kC][kTA*kTA]
  float* s_w = s_a + kC * kTA * kTA;              // [cin][cout], one tap
  float* s_in = s_w + kC * kC;                    // [kTI*kTI]
  float* s_w1a = s_in + kTI * kTI;                // [9][kC]
  float* s_b1a = s_w1a + 9 * kC;                  // [kC]

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kT;
  const int x0 = blockIdx.x * kT;
  const int tid = threadIdx.x;
  const float* im = img + static_cast<size_t>(b) * H * W;

  for (int i = tid; i < kTI * kTI; i += kThreads) {
    const int r = y0 - 2 + i / kTI;
    const int c = x0 - 2 + i % kTI;
    s_in[i] = (r >= 0 && r < H && c >= 0 && c < W)
                  ? im[static_cast<size_t>(r) * W + c] : 0.f;
  }
  for (int i = tid; i < 9 * kC; i += kThreads) s_w1a[i] = w1a[i];
  if (tid < kC) s_b1a[tid] = b1a[tid];
  __syncthreads();

  // conv1a + ReLU on the 18x18 tile; zero where conv1b's SAME padding reads
  // outside the image.
  for (int i = tid; i < kC * kTA * kTA; i += kThreads) {
    const int ch = i / (kTA * kTA);
    const int p = i % (kTA * kTA);
    const int ty = p / kTA;
    const int tx = p % kTA;
    const int r = y0 - 1 + ty;
    const int c = x0 - 1 + tx;
    float v = 0.f;
    if (r >= 0 && r < H && c >= 0 && c < W) {
      float acc = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
          acc = fmaf(s_in[(ty + dy) * kTI + tx + dx],
                     s_w1a[(dy * 3 + dx) * kC + ch], acc);
      v = fmaxf(acc + s_b1a[ch], 0.f);
    }
    s_a[i] = v;
  }

  // conv1b: thread = (channel group cg, pool window (py, px)).
  const int cg = tid / (kPoolT * kPoolT);
  const int win = tid % (kPoolT * kPoolT);
  const int py = win / kPoolT;
  const int px = win % kPoolT;
  float acc[4][kCG];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int o = 0; o < kCG; ++o) acc[k][o] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    __syncthreads();  // s_a complete (first tap); previous tap consumed
    const float4* src = reinterpret_cast<const float4*>(w1b + tap * kC * kC);
    float4* dst = reinterpret_cast<float4*>(s_w);
    for (int i = tid; i < kC * kC / 4; i += kThreads) dst[i] = src[i];
    __syncthreads();
    const int dy = tap / 3;
    const int dx = tap % 3;
    const float* a0 = s_a + (2 * py + dy) * kTA + 2 * px + dx;
    for (int ci = 0; ci < kC; ++ci) {
      const float* a = a0 + ci * kTA * kTA;
      const float v[4] = {a[0], a[1], a[kTA], a[kTA + 1]};
      const float4* w4 = reinterpret_cast<const float4*>(s_w + ci * kC + cg * kCG);
#pragma unroll
      for (int q = 0; q < kCG / 4; ++q) {
        const float4 w = w4[q];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          acc[k][4 * q + 0] = fmaf(v[k], w.x, acc[k][4 * q + 0]);
          acc[k][4 * q + 1] = fmaf(v[k], w.y, acc[k][4 * q + 1]);
          acc[k][4 * q + 2] = fmaf(v[k], w.z, acc[k][4 * q + 2]);
          acc[k][4 * q + 3] = fmaf(v[k], w.w, acc[k][4 * q + 3]);
        }
      }
    }
  }

  // relu(max_k(acc_k + bias)) == max(max_k(acc_k) + bias, 0): rounding is
  // monotone, so the pool commutes with the bias add and the ReLU.
  const int H2 = H / 2;
  const int W2 = W / 2;
  const int oy = blockIdx.y * kPoolT + py;
  const int ox = blockIdx.x * kPoolT + px;
  if (oy < H2 && ox < W2) {
    float4* o = reinterpret_cast<float4*>(
        out + ((static_cast<size_t>(b) * H2 + oy) * W2 + ox) * kC + cg * kCG);
#pragma unroll
    for (int q = 0; q < kCG / 4; ++q) {
      float r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ch = 4 * q + j;
        const float m = fmaxf(fmaxf(acc[0][ch], acc[1][ch]),
                              fmaxf(acc[2][ch], acc[3][ch]));
        r[j] = fmaxf(m + b1b[cg * kCG + ch], 0.f);
      }
      o[q] = make_float4(r[0], r[1], r[2], r[3]);
    }
  }
}

}  // namespace

// images [B,H,W] fp32; w1a [3,3,1,64] and w1b [3,3,64,64] HWIO; b1a, b1b [64];
// out [B,H/2,W/2,64]. H and W even. All pointers contiguous, 16-byte aligned.
extern "C" int stem_forward(const float* img, const float* w1a,
                            const float* b1a, const float* w1b,
                            const float* b1b, float* out, int B, int H, int W,
                            cudaStream_t stream) {
  const int smem = kSmemFloats * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + kT - 1) / kT, (H + kT - 1) / kT, B);
  stem_kernel<<<grid, kThreads, smem, stream>>>(img, w1a, b1a, w1b, b1b, out,
                                                H, W);
  return static_cast<int>(cudaGetLastError());
}
