// Fused dual-softmax argmax for Hopper (sm_90a), fp32.
//
// Replaces: onepose_tpu/ops/pallas_match.py::dual_softmax_argmax (kernel
// _kernel). For mdesc0 [B,N1,D] and mdesc1 [B,N2,D]:
//   S = mdesc0 . mdesc1^T / scale,
//   conf = softmax over N1 (S) * softmax over N2 (S),
// and it returns the row argmax and max of conf [B,N1] and the column argmax
// and max [B,N2], the first index winning ties, without ever writing the
// [B,N1,N2] conf. No mask is applied: padded slots take part in the softmax
// statistics, and the caller applies the masks afterwards.
//
// What bounds it: one S at [8,1024]x[8,2000], D=256 is 4.2e9 FMAs on 25 MB of
// input. Unfused, S and conf are 65 MB each and are written and read several
// times. Fused, the kernel is bound by fp32 FMA issue; this design computes
// S four times (two sweeps, each from both sides) to keep it out of memory.
//
// Design: the TPU kernel carried the column statistics across a sequential
// grid. Hopper runs blocks in no order, so each block here owns 64 vectors of
// one side ("own": rows of mdesc0 or rows of mdesc1) and sweeps over all of
// the other side in 64-wide tiles, recomputing its S tile from device memory
// through 32-deep shared-memory k-chunks (4x4 register tile per thread).
//   launch 1 (match_stats): each block keeps an online max and sum-exp for
//     its own vectors: row blocks give the softmax over N2, column blocks the
//     softmax over N1.
//   launch 2 (match_argmax): the same sweep forms conf from both statistics
//     and keeps a running (max, index) per own vector. Ties go to the lower
//     index in every reduction, so the order of tiles and lanes is immaterial.
// Each S entry is the same sequential FMA chain over k in both roles
// (fma(a, b, c) == fma(b, a, c)), so row and column blocks see bit-identical
// conf values. Ragged N1/N2 are masked: rows past the end load as zeros and
// are neither counted nor written.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTile = 64;     // own and other vectors per tile
constexpr int kK = 32;        // k chunk
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 S entries each

struct SweepArgs {
  const float* d0;   // [B, n1, D]
  const float* d1;   // [B, n2, D]
  int n1, n2, D;
  float scale;
  int row_blocks;    // blocks per batch element that own rows of d0
  float* row_m;      // [B, n1] max over N2 of S
  float* row_l;      // [B, n1] sum over N2 of exp(S - row_m)
  float* col_m;      // [B, n2]
  float* col_l;      // [B, n2]
  int* idx0;         // [B, n1]
  float* max0;       // [B, n1]
  int* idx1;         // [B, n2]
  float* max1;       // [B, n2]
};

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

template <bool kArgmax>
__global__ void __launch_bounds__(kThreads) sweep_kernel(SweepArgs a) {
  __shared__ float s_own[kTile][kK + 1];
  __shared__ float s_oth[kTile][kK + 1];

  const int b = blockIdx.y;
  const bool rows = blockIdx.x < a.row_blocks;
  const int own0 = (rows ? blockIdx.x : blockIdx.x - a.row_blocks) * kTile;
  const int n_own = rows ? a.n1 : a.n2;
  const int n_oth = rows ? a.n2 : a.n1;
  const int D = a.D;
  const float* own = rows ? a.d0 + static_cast<size_t>(b) * a.n1 * D
                          : a.d1 + static_cast<size_t>(b) * a.n2 * D;
  const float* oth = rows ? a.d1 + static_cast<size_t>(b) * a.n2 * D
                          : a.d0 + static_cast<size_t>(b) * a.n1 * D;
  float* own_m = rows ? a.row_m + static_cast<size_t>(b) * a.n1
                      : a.col_m + static_cast<size_t>(b) * a.n2;
  float* own_l = rows ? a.row_l + static_cast<size_t>(b) * a.n1
                      : a.col_l + static_cast<size_t>(b) * a.n2;
  const float* oth_m = rows ? a.col_m + static_cast<size_t>(b) * a.n2
                            : a.row_m + static_cast<size_t>(b) * a.n1;
  const float* oth_l = rows ? a.col_l + static_cast<size_t>(b) * a.n2
                            : a.row_l + static_cast<size_t>(b) * a.n1;

  const int tx = threadIdx.x % 16;  // other vectors tx + 16 q
  const int ty = threadIdx.x / 16;  // own vectors ty + 16 p

  // stats: (running max, running sum); argmax: (best conf, best index)
  float run_v[4], run_s[4], om[4], ol[4];
  int run_i[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int r = own0 + ty + 16 * p;
    run_v[p] = kArgmax ? -1.f : -CUDART_INF_F;
    run_s[p] = 0.f;
    run_i[p] = 0;
    if (kArgmax) {
      om[p] = r < n_own ? own_m[r] : 0.f;
      ol[p] = r < n_own ? fmaxf(own_l[r], 1e-30f) : 1.f;
    }
  }

  for (int t0 = 0; t0 < n_oth; t0 += kTile) {
    float s[4][4];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) s[p][q] = 0.f;

    for (int k0 = 0; k0 < D; k0 += kK) {
      for (int i = threadIdx.x; i < kTile * kK; i += kThreads) {
        const int r = i / kK;
        const int c = i % kK;
        const int k = k0 + c;
        const int go = own0 + r;
        const int gt = t0 + r;
        s_own[r][c] = (go < n_own && k < D) ? own[static_cast<size_t>(go) * D + k] : 0.f;
        s_oth[r][c] = (gt < n_oth && k < D) ? oth[static_cast<size_t>(gt) * D + k] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < kK; ++c) {
        float x[4], y[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) x[p] = s_own[ty + 16 * p][c];
#pragma unroll
        for (int q = 0; q < 4; ++q) y[q] = s_oth[tx + 16 * q][c];
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) s[p][q] = fmaf(x[p], y[q], s[p][q]);
      }
      __syncthreads();
    }

    bool valid[4];
    float pm[4], pl[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = t0 + tx + 16 * q;
      valid[q] = j < n_oth;
      if (kArgmax) {
        pm[q] = valid[q] ? oth_m[j] : 0.f;
        pl[q] = valid[q] ? fmaxf(oth_l[j], 1e-30f) : 1.f;
      }
    }

#pragma unroll
    for (int p = 0; p < 4; ++p) {
      if (!kArgmax) {
        float tmax = -CUDART_INF_F;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (valid[q]) tmax = fmaxf(tmax, s[p][q] / a.scale);
        for (int off = 8; off > 0; off >>= 1)
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
        const float m_new = fmaxf(run_v[p], tmax);  // finite: t0 < n_oth
        float part = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (valid[q]) part += expf(s[p][q] / a.scale - m_new);
        for (int off = 8; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        const float keep = run_v[p] == -CUDART_INF_F ? 0.f : expf(run_v[p] - m_new);
        run_s[p] = run_s[p] * keep + part;
        run_v[p] = m_new;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (!valid[q]) continue;
          const float v = s[p][q] / a.scale;
          const float conf = (expf(v - om[p]) / ol[p]) * (expf(v - pm[q]) / pl[q]);
          const int j = t0 + tx + 16 * q;
          if (better(conf, j, run_v[p], run_i[p])) {
            run_v[p] = conf;
            run_i[p] = j;
          }
        }
      }
    }
  }

  if (kArgmax) {
#pragma unroll
    for (int p = 0; p < 4; ++p)
      for (int off = 8; off > 0; off >>= 1) {
        const float v = __shfl_xor_sync(0xffffffffu, run_v[p], off);
        const int i = __shfl_xor_sync(0xffffffffu, run_i[p], off);
        if (better(v, i, run_v[p], run_i[p])) {
          run_v[p] = v;
          run_i[p] = i;
        }
      }
  }

  if (tx == 0) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int r = own0 + ty + 16 * p;
      if (r >= n_own) continue;
      if (kArgmax) {
        if (rows) {
          a.idx0[static_cast<size_t>(b) * a.n1 + r] = run_i[p];
          a.max0[static_cast<size_t>(b) * a.n1 + r] = run_v[p];
        } else {
          a.idx1[static_cast<size_t>(b) * a.n2 + r] = run_i[p];
          a.max1[static_cast<size_t>(b) * a.n2 + r] = run_v[p];
        }
      } else {
        own_m[r] = run_v[p];
        own_l[r] = run_s[p];
      }
    }
  }
}

SweepArgs make_args(const float* d0, const float* d1, int n1, int n2, int D,
                    float scale, float* row_m, float* row_l, float* col_m,
                    float* col_l) {
  SweepArgs a{};
  a.d0 = d0;
  a.d1 = d1;
  a.n1 = n1;
  a.n2 = n2;
  a.D = D;
  a.scale = scale;
  a.row_blocks = (n1 + kTile - 1) / kTile;
  a.row_m = row_m;
  a.row_l = row_l;
  a.col_m = col_m;
  a.col_l = col_l;
  return a;
}

dim3 grid_for(const SweepArgs& a, int B) {
  return dim3(a.row_blocks + (a.n2 + kTile - 1) / kTile, B);
}

}  // namespace

// Launch 1: softmax statistics of S over N2 for every row and over N1 for
// every column.
extern "C" int match_stats(const float* d0, const float* d1, int B, int n1,
                           int n2, int D, float scale, float* row_m,
                           float* row_l, float* col_m, float* col_l,
                           cudaStream_t stream) {
  SweepArgs a = make_args(d0, d1, n1, n2, D, scale, row_m, row_l, col_m, col_l);
  sweep_kernel<false><<<grid_for(a, B), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Launch 2: row and column argmax/max of conf from the statistics of launch 1.
extern "C" int match_argmax(const float* d0, const float* d1, int B, int n1,
                            int n2, int D, float scale, float* row_m,
                            float* row_l, float* col_m, float* col_l,
                            int* idx0, float* max0, int* idx1, float* max1,
                            cudaStream_t stream) {
  SweepArgs a = make_args(d0, d1, n1, n2, D, scale, row_m, row_l, col_m, col_l);
  a.idx0 = idx0;
  a.max0 = max0;
  a.idx1 = idx1;
  a.max1 = max1;
  sweep_kernel<true><<<grid_for(a, B), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
