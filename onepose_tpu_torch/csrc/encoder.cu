// SuperPoint's encoder convolutions for Hopper (sm_90a): a 3x3 SAME
// convolution + bias + ReLU, and for conv2b and conv3b the 2x2 max-pool, as
// a 3xTF32 implicit GEMM on the tensor cores, NHWC fp32 in and out.
//
// Replaces no TPU kernel: the JAX package runs these convolutions as XLA
// convolutions (onepose_tpu/models/superpoint.py::dense_heads), and the port
// ran them through cuDNN. Added because cuDNN's fp32 convolutions (TF32
// off, as ops/precision.py pins it) run on the CUDA cores, as FFT and SIMT
// implicit-GEMM kernels: about 190 ms of device time a pose batch of 128
// crops of 512^2, some 10% of the bound below.
//
// What bounds it. The seven 3x3 convolutions after the stem (conv2a,
// conv2b, conv3a, conv3b, conv4a, conv4b, and convPa|convDa merged into one
// 128 -> 512 convolution) are 24.2 GFLOP on a 512^2 crop, 3,092 GFLOP a
// batch of 128, against 12.1 GB of activations read once and written once:
// operations bound every one of them. A single TF32 product keeps about
// three decimal digits; three TF32 products (hi.hi + hi.lo + lo.hi) are
// fp32-class, and their least time is 3 * 3,092 GFLOP / 495 TFLOP/s =
// 18.7 ms a batch.
//
// Design: stem.cu's conv1b (conv3x3.cuh), generalised to more channels.
//  1. A block computes 4 output rows x 64 columns x 64 output channels of
//     one image; Cout / 64 blocks (the N tiles) share an input tile, so the
//     128 -> 512 heads conv is 8 N tiles. The grid's z runs over (image,
//     N tile) with the N tile fastest, so that an image's tile stays in L2
//     for all of its N tiles. Tiles never cross images: an image's outputs
//     do not depend on the rows batched with it.
//  2. The input, 6 x 66 pixels with a 1-px halo, zero outside the image,
//     comes into shared memory by cp.async in 64-channel chunks (16-byte
//     copies, zero-filled past the edges), one chunk at a time: Cin = 128
//     reloads the tile once, between its two chunks.
//  3. K runs over groups (chunk, tap): 9 for Cin = 64, 18 for Cin = 128.
//     A group is a 64 x 64 x 64 product a warpgroup row, in two halves of
//     4 k-steps, A fragments split in registers, the next half's loaded and
//     split while the MMA runs. Each half's sum (32 channels) is added to
//     the running sum in fp32. Against fp64, a sum a group (as stem.cu does
//     per tap) put the encoder's output at 1.3-1.9x cuDNN fp32's error; a
//     sum a half puts it at 0.7-1.1x, in the same time (the other
//     warpgroup's products fill the MMA while this one drains and adds).
//     What is left is the split's: hi + lo keeps about 22 of fp32's 24
//     bits, so a sum of few terms (a 1x1 map, where only the centre tap
//     reads the image) errs a few times more than fp32 FMA.
//  4. Weights (HWIO) stream group by group through a 2-stage ring: each
//     thread holds 16 fp32 of group g + 1 (loaded from L2 while group g is
//     in the MMA) and writes their hi and lo into the other stage.
//  5. Epilogue: bias and ReLU in registers; for conv2b and conv3b the 2x2
//     max-pool too (conv3x3::store_pooled), so the unpooled activation never
//     reaches device memory. Stores are float2s that fill 32-byte sectors.
// Ragged H and W: the halo is zero outside the image, and rows and columns
// past the end are not stored. Shared memory 166,912 bytes a block (one
// block an SM). What is left: a block's tile load and epilogue overlap no
// MMA, each half drains the MMA before its fp32 add, and a Cin = 128
// block stalls once to reload its tile.

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv3x3.cuh"

namespace {

using namespace conv3x3;

constexpr int kOffW = 0;                          // [2][hi, lo][16][64][4]
constexpr int kOffA = kOffW + 2 * kStageBytes;    // [16][kAP][4]
constexpr int kSmemBytes = kOffA + kTileBytes;
static_assert(kSmemBytes == 166912, "the source note states this size");

// Chunk c (channels 64 c ..) of the input tile whose top-left output pixel
// is (y0, x0) into shared memory at `tile`, [cin/4][pixel][4]; a thread
// copies channel quads of consecutive pixels' channels (coalesced).
template <int kCin>
__device__ __forceinline__ void load_tile(const float* __restrict__ img,
                                          int c, uint32_t tile, int y0,
                                          int x0, int H, int W) {
  for (int i = threadIdx.x; i < kAP * kQuads; i += kThreads) {
    const int q = i % kQuads, p = i / kQuads;
    const int r = y0 - 1 + p / kAW, col = x0 - 1 + p % kAW;
    const bool in = r >= 0 && r < H && col >= 0 && col < W;
    const float* src =
        in ? img + (static_cast<size_t>(r) * W + col) * kCin + c * kC + 4 * q
           : img;
    cp_async16_zfill(tile + (q * kAP + p) * 16, src, in);
  }
  cp_async_commit();
}

template <int kCin>
__global__ void __launch_bounds__(kThreads, 1)
encoder_conv3x3(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ out,
                int H, int W, int Cout, bool pool) {
  constexpr int kChunks = kCin / kC;
  constexpr int kGroups = 9 * kChunks;   // group g: chunk g / 9, tap g % 9
  extern __shared__ __align__(128) uint8_t smem[];
  float4* s_w = reinterpret_cast<float4*>(smem + kOffW);
  const float* s_a = reinterpret_cast<const float*>(smem + kOffA);
  const uint32_t w_base = smem_addr(smem + kOffW);
  const uint32_t a_base = smem_addr(smem + kOffA);

  const int n_tiles = Cout / kC;
  const int b = blockIdx.z / n_tiles;
  const int co0 = (blockIdx.z % n_tiles) * kC;
  const int y0 = blockIdx.y * kRows;
  const int x0 = blockIdx.x * kTW;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = (tid >> 5) & 3, wg = tid >> 7;
  const float* img = x + static_cast<size_t>(b) * H * W * kCin;
  // group g's weights: [cin 64 (g / 9) ..][cout co0 ..] of tap g % 9
  auto w_at = [&](int g) {
    return w + static_cast<size_t>((g % 9) * kCin + (g / 9) * kC) * Cout +
           co0;
  };

  float wreg[kWPer];
  load_tap(w_at(0), Cout, wreg);
  load_tile<kCin>(img, 0, a_base, y0, x0, H, W);
  store_tap(wreg, s_w);

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
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();  // the tile and group 0's weights are in place
  load_frags(a_at(0, 0), 0, f0);

  for (int g = 0; g < kGroups; ++g) {
    const int tap = g % 9;
    if (g + 1 < kGroups) load_tap(w_at(g + 1), Cout, wreg);
    const uint32_t st = w_base + (g & 1) * kStageBytes;
#pragma unroll
    for (int ry = 0; ry < 2; ++ry) {
      wgmma_fence();
      issue_half(part, f0, st, 0, true);
      wgmma_commit();
      load_frags(a_at(tap, ry), 1, f1);
      wgmma_wait<0>();  // the first half has left the MMA: f0 is free
      fence_operands(part);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[ry][i] += part[i];
      wgmma_fence();
      issue_half(part, f1, st, 1, true);
      wgmma_commit();
      const int next = ry ? tap + 1 : tap;
      if (next < 9) load_frags(a_at(next, ry ^ 1), 0, f0);
      wgmma_wait<0>();
      fence_operands(part);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[ry][i] += part[i];
    }
    if (g + 1 < kGroups) {
      const bool reload = tap == 8;   // the next group starts a chunk
      // every thread has read this chunk's tile (reload), and every
      // warpgroup has finished group g - 1, which read the other stage
      if (reload) {
        __syncthreads();
        load_tile<kCin>(img, (g + 1) / 9, a_base, y0, x0, H, W);
      }
      store_tap(wreg, s_w + ((g + 1) & 1) * kStageBytes / 16);
      if (reload) cp_async_wait<0>();
      fence_proxy_async();
      __syncthreads();
      if (reload) load_frags(a_at(0, 0), 0, f0);
    }
  }

  const float* bias_t = bias + co0;
  if (pool) {
    const int H2 = H / 2, W2 = W / 2;
    const int oy = y0 / 2 + wg;
    store_pooled(acc, bias_t,
                 out + (static_cast<size_t>(b) * H2 + oy) * W2 * Cout + co0,
                 Cout, x0, W2, oy < H2);
  } else {
    // Accumulator element 4 n + 2 i + j: pixel m + 8 i, cout 8 n + 2 kq + j.
#pragma unroll
    for (int ry = 0; ry < 2; ++ry) {
      const int y = y0 + 2 * wg + ry;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int xo = x0 + m + 8 * i;
        if (y >= H || xo >= W) continue;
        float* o =
            out + ((static_cast<size_t>(b) * H + y) * W + xo) * Cout + co0;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int co = 8 * n + 2 * kq;
          const int e = 4 * n + 2 * i;
          *reinterpret_cast<float2*>(o + co) = make_float2(
              fmaxf(acc[ry][e] + __ldg(bias_t + co), 0.f),
              fmaxf(acc[ry][e + 1] + __ldg(bias_t + co + 1), 0.f));
        }
      }
    }
  }
}

template <int kCin>
int launch(const float* x, const float* w, const float* bias, float* out,
           int B, int H, int W, int Cout, bool pool, cudaStream_t stream) {
  auto kernel = encoder_conv3x3<kCin>;
  // set on every call: the attribute belongs to the current device
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + kTW - 1) / kTW, (H + kRows - 1) / kRows,
                  B * (Cout / kC));
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(x, w, bias, out, H, W, Cout,
                                                 pool);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [B,H,W,Cin] fp32, Cin 64 or 128; w [3,3,Cin,Cout] HWIO, Cout a multiple
// of 64; bias [Cout]; out [B,H,W,Cout], or [B,H/2,W/2,Cout] with pool (H and
// W even). All contiguous, x 16-byte aligned.
extern "C" int encoder_conv_forward(const float* x, const float* w,
                                    const float* bias, float* out, int B,
                                    int H, int W, int Cin, int Cout, int pool,
                                    cudaStream_t stream) {
  if (Cout <= 0 || Cout % kC) return static_cast<int>(cudaErrorInvalidValue);
  if (Cin == 64)
    return launch<64>(x, w, bias, out, B, H, W, Cout, pool != 0, stream);
  if (Cin == 128)
    return launch<128>(x, w, bias, out, B, H, W, Cout, pool != 0, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
