// Log-domain Sinkhorn with a dustbin row and column, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves SuperGlue's Sinkhorn
// (onepose_tpu/models/superglue.py::log_optimal_transport) to XLA. For
// scores S [B,M,N] and the dustbin score alpha, the couplings are
// C = [[S, alpha], [alpha, alpha]] [B,M+1,N+1]. With norm = -log(M+N),
// log_mu = (norm x M, log N + norm), log_nu = (norm x N, log M + norm) and
// u = v = 0, each of `iters` iterations sets
//   u_i = log_mu_i - LSE_j(C_ij + v_j),
//   then v_j = log_nu_j - LSE_i(C_ij + u_i),
// and the result is Z = C + u_i + v_j - norm [B,M+1,N+1]: the plain
// version's arithmetic (ops/sinkhorn.py::sinkhorn_reference) in fp32, each
// LSE max-rescaled as ATen's is, summed in another order.
//
// What bounds it. At SuperGlue's detector shape, [15,1024,1024] and 100
// iterations, the work is two exponentials a coupling an iteration, 3.15e9,
// 0.75 ms at the SFU's 16 a clock on 132 SMs at 1.98 GHz; reading the
// scores once and writing Z once is 126 MB, 0.04 ms at 3.35 TB/s. The
// scores (63 MB) outgrow the 50 MB L2, and an iteration depends on all of
// the previous one, so a design that reads them once an iteration streams
// 6.3 GB: 1.88 ms. The plain version makes 5 reads and 3 writes of the
// [15,1025,1025] couplings a half-iteration (ATen's logsumexp is amax, sub,
// exp, sum, log after the broadcast add): 100.9 GB.
//
// Design.
//  * No couplings tensor: the dustbin row and column are made from alpha,
//    which is read on the device, and log_mu, log_nu and norm from M and N.
//  * One read of the scores an iteration. sinkhorn_rows runs as many blocks
//    as the SMs hold at once; block k owns rows [k*rows, (k+1)*rows) of the
//    B*(M+1) rows, which may span batch elements. It walks them in slabs of
//    up to 8 rows, double-buffered: cp.async brings slab k+1 into shared
//    memory while slab k is reduced. Warp w reduces row w of a slab into
//    u_i, 1024 columns at a time with 32 values a lane in registers (the
//    max over the warp, then the sum of exponentials under it); then each
//    thread takes 4 columns of every 1024 over the slab's rows, in
//    registers, to their (max, sum) under the new u, folded into its
//    running (max, sum) of those columns. At the end of a batch element the
//    block writes those partials, [B, parts, 2, N+1], and sinkhorn_cols
//    folds them, in slot order, into v: 2.3 MB an iteration at the
//    detector shape. The first 1024 columns' v and (max, sum) stay in
//    registers for the whole batch element; those of longer rows are kept
//    in shared memory between slabs.
//  * The scores do not fit in L2, so iterations alternate the direction in
//    which a block walks its rows: an iteration starts on the rows the
//    previous one read last, which L2 still holds.
//  * 2 launches an iteration and 1 for the epilogue Z = C + u + v - norm,
//    on the caller's stream, none of which synchronises. iters = 0 gives
//    C - norm.
//  * Exponentials are ex2.approx of (x - max) * log2(e), exactly 1 at the
//    max; the card tests hold the result against an fp64 Sinkhorn to 2x
//    the plain version's error.
//  * Shapes decide the launch (make_plan): rows a slab (8, or 4 where two
//    slabs of 8 longer rows do not fit), blocks an SM (two, or one where
//    that holds as many rows), rows a block, partial slots. Rows up to
//    5,282 columns (SfM's largest bucket is 4,096); the wrapper refuses
//    longer ones.
//  No atomics: every reduction has a fixed order, so results do not depend
//  on block order.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::cp_async16;
using hopper::cp_async4;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::smem_addr;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = kWarps;    // rows a slab: a warp reduces one,
constexpr int kMinRows = 4;         // or half of them where rows are long
constexpr int kLaneValues = 32;     // of a row chunk: 1024 columns a warp
constexpr int kColValues = 4;       // of a column chunk: 1024 a block
constexpr int kChunk = 32 * kLaneValues;
constexpr float kLog2e = 1.4426950408889634f;
// Dynamic shared memory of a block when two share an SM (each block also
// costs the SM 1 KB of its 228 KB), and when one has it alone.
constexpr size_t kSmemTwo = 113 * 1024;
constexpr size_t kSmemOne = 227 * 1024;

struct Plan {
  int grid;     // blocks of sinkhorn_rows
  int rows;     // rows of the couplings a block owns (the last one fewer)
  int slab;     // rows a slab holds
  int parts;    // partial slots a batch element has room for
  size_t smem;  // sinkhorn_rows' dynamic shared memory
};

struct Args {
  const float* scores;  // [B, M, N]
  const float* alpha;   // the dustbin score, one float
  float* u;             // [B, M+1]
  float* v;             // [B, N+1]
  float* part;          // [B, parts, 2, N+1]: column (max, sum) a block
  int B, M, N;
  int rows, slab, parts;
  int vec;              // rows start on 16 bytes: copy 16 bytes at a time
};

bool make_plan(int B, int M, int N, int sms, Plan* p) {
  const long total = static_cast<long>(B) * (M + 1);
  // v and the block's column (max, sum); two slab buffers of N-float rows
  const size_t fixed = 3 * (static_cast<size_t>(N) + 1) * sizeof(float);
  const size_t per_row = 2 * static_cast<size_t>(N) * sizeof(float);
  int per_sm = 0, slab = 0;
  for (int k = 2; k >= 1; --k) {
    const size_t budget = k == 2 ? kSmemTwo : kSmemOne;
    if (budget <= fixed) continue;
    const long fit = static_cast<long>((budget - fixed) / per_row);
    const int fit_rows =
        fit >= kMaxRows ? kMaxRows : fit >= kMinRows ? kMinRows : 0;
    if (fit_rows > 0 && k * fit_rows >= per_sm * slab) {  // a tie: one block
      per_sm = k;
      slab = fit_rows;
    }
  }
  if (slab == 0) return false;
  const long slots = static_cast<long>(sms) * per_sm;
  long rows = (total + slots - 1) / slots;
  if (rows < slab) rows = slab;
  p->rows = static_cast<int>(rows);
  p->slab = slab;
  p->grid = static_cast<int>((total + rows - 1) / rows);
  p->parts = static_cast<int>(M / rows + 2);
  p->smem = fixed + static_cast<size_t>(slab) * per_row;
  return true;
}

bool device_plan(int B, int M, int N, Plan* p) {
  int dev = 0, sms = 0;
  if (B < 1 || M < 1 || N < 1) return false;
  if (cudaGetDevice(&dev) != cudaSuccess) return false;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return false;
  return make_plan(B, M, N, sms, p);
}

// exp(x - m) as 2^((x - m) log2e): exactly 1 at the max; 0 for x = -inf
__device__ __forceinline__ float exp_from(float x, float m) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"((x - m) * kLog2e));
  return y;
}

// (m, s) of two sets, s = sum of exp(x - m) and m the max of its set, s = 0
// for an empty one; the same bits whichever side is first
__device__ __forceinline__ void merge(float& m, float& s, float m2,
                                      float s2) {
  if (s2 == 0.f) return;
  if (s == 0.f) {
    m = m2;
    s = s2;
  } else if (m2 > m) {
    s = fmaf(s, exp_from(m, m2), s2);
    m = m2;
  } else {
    s = fmaf(s2, exp_from(m2, m), s);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float log_norm(const Args& a) {
  return -logf(static_cast<float>(a.M) + static_cast<float>(a.N));
}

// A slab: rows [i0, i0 + n) of batch element b. Slabs never straddle a
// batch element.
struct Slab {
  int b, i0, n;
};

// The k-th slab of rows [r0, r1), counted from r0; past the last, none
// (b = -1) and *count, if given, the number of slabs.
__device__ Slab slab_at(const Args& a, int r0, int r1, int k, int* count) {
  const int h = a.M + 1;
  int seen = 0;
  for (int g = r0; g < r1;) {
    const int end = min(r1, (g / h + 1) * h);
    const int here = (end - g + a.slab - 1) / a.slab;
    if (k >= seen && k < seen + here) {
      const int start = g + (k - seen) * a.slab;
      const int b = g / h;
      return {b, start - b * h, min(a.slab, end - start)};
    }
    seen += here;
    g = end;
  }
  if (count) *count = seen;
  return {-1, 0, 0};
}

// Warp w brings row w of slab s into buf: the scores, alpha for the
// dustbin row, zeros past the slab's last row.
template <int kRows>
__device__ __forceinline__ void copy_slab(const Args& a, const Slab& s,
                                          float* buf, float alpha) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= kRows) return;
  const int N = a.N;
  float* dst = buf + static_cast<size_t>(warp) * N;
  const int i = s.i0 + warp;
  if (warp >= s.n || i == a.M) {
    const float fill = warp >= s.n ? 0.f : alpha;
    for (int j = lane; j < N; j += 32) dst[j] = fill;
    return;
  }
  const float* src = a.scores + (static_cast<size_t>(s.b) * a.M + i) * N;
  if (a.vec) {
    for (int j = 4 * lane; j < N; j += 128)
      cp_async16(smem_addr(dst + j), src + j);
  } else {
    for (int j = lane; j < N; j += 32) cp_async4(smem_addr(dst + j), src + j);
  }
}

// A warp's (max, sum) of row[j] + v over a chunk of 1024 columns from c0,
// folded into (m, s); v[t] is v at column c0 + lane + 32t. kTail: the
// chunk passes N.
template <bool kTail>
__device__ __forceinline__ void row_chunk(const float* row,
                                          const float (&v)[kLaneValues],
                                          int c0, int N, float& m, float& s) {
  const int lane = threadIdx.x % 32;
  float x[kLaneValues];
  float mx = -CUDART_INF_F;
#pragma unroll
  for (int t = 0; t < kLaneValues; ++t) {
    const int j = c0 + lane + 32 * t;
    x[t] = !kTail || j < N ? row[j] + v[t] : -CUDART_INF_F;
    mx = fmaxf(mx, x[t]);
  }
  mx = warp_max(mx);
  float s4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int t = 0; t < kLaneValues; ++t) s4[t % 4] += exp_from(x[t], mx);
  merge(m, s, mx, warp_sum((s4[0] + s4[1]) + (s4[2] + s4[3])));
}

// The slab's (max, sum) of buf[r][j] + ur[r] over its rows for a thread's
// columns c0 + threadIdx.x + 256c of a 1024-column chunk, folded into
// (cm[c], cs[c]). Rows past the slab's end hold 0 and ur = -inf.
template <int kRows, bool kTail>
__device__ __forceinline__ void fold_chunk(const float* buf,
                                           const float (&ur)[kRows],
                                           int c0, int N,
                                           float (&cm)[kColValues],
                                           float (&cs)[kColValues]) {
#pragma unroll
  for (int c = 0; c < kColValues; ++c) {
    const int j = c0 + threadIdx.x + kThreads * c;
    if (kTail && j >= N) continue;
    float x[kRows];
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      x[r] = buf[static_cast<size_t>(r) * N + j] + ur[r];
      mx = fmaxf(mx, x[r]);
    }
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) (r % 2 ? sb : sa) += exp_from(x[r], mx);
    merge(cm[c], cs[c], mx, sa + sb);
  }
}

// One iteration's u, and each block's column partials under it; v = 0 in
// the call's `first` iteration. The first 1024 columns' v (a lane's, for
// the rows its warp reduces) and (max, sum) (a thread's) live in
// registers; those of longer rows in shared memory.
template <int kRows>
__global__ void __launch_bounds__(kThreads, 2)
    sinkhorn_rows(Args a, int first, int backward) {
  extern __shared__ __align__(16) float smem[];
  const int N = a.N, cols = N + 1;
  const size_t slab_floats = static_cast<size_t>(kRows) * N;
  float* bufs = smem;                    // [2][kRows][N]
  float* v_s = bufs + 2 * slab_floats;   // [cols]
  float* col_m = v_s + cols;             // [cols], past the first chunk
  float* col_s = col_m + cols;           // [cols], past the first chunk
  __shared__ float u_s[kRows];
  const int height = a.M + 1;
  const int r0 = blockIdx.x * a.rows;
  const int r1 = min(r0 + a.rows, a.B * height);
  const float norm = log_norm(a);
  const float lmu_bin = logf(static_cast<float>(N)) + norm;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool tail0 = N < kChunk;         // the first chunk passes N
  int slabs = 0;
  slab_at(a, r0, r1, -1, &slabs);
  auto at = [&](int k) {
    return slab_at(a, r0, r1, backward ? slabs - 1 - k : k, nullptr);
  };
  float vr[kLaneValues];                 // v of the first chunk, a lane's
  float cm[kColValues], cs[kColValues];  // (max, sum) of the first chunk
  float dm = -CUDART_INF_F, ds = 0.f;    // of the dustbin column (warp 7)
  // the block's column partials of batch element b
  auto write_partials = [&](int b) {
    const int slot = blockIdx.x - b * height / a.rows;
    float* out =
        a.part + (static_cast<size_t>(b) * a.parts + slot) * 2 * cols;
#pragma unroll
    for (int c = 0; c < kColValues; ++c) {
      const int j = threadIdx.x + kThreads * c;
      if (j < N) {
        out[j] = cm[c];
        out[cols + j] = cs[c];
      }
    }
    for (int j = kChunk + threadIdx.x; j < N; j += kThreads) {
      out[j] = col_m[j];
      out[cols + j] = col_s[j];
    }
    if (threadIdx.x == kThreads - 32) {
      out[N] = dm;
      out[cols + N] = ds;
    }
  };

  const float alpha = *a.alpha;
  Slab next = at(0);
  copy_slab<kRows>(a, next, bufs, alpha);
  cp_async_commit();
  int b_cur = -1;
  for (int k = 0; k < slabs; ++k) {
    const Slab s = next;
    const float* buf = bufs + (k & 1) * slab_floats;
    if (k + 1 < slabs) {
      next = at(k + 1);
      copy_slab<kRows>(a, next, bufs + ((k + 1) & 1) * slab_floats, alpha);
    }
    cp_async_commit();
    if (s.b != b_cur) {  // a batch element's first slab
      if (b_cur >= 0) write_partials(b_cur);
      for (int j = threadIdx.x; j < cols; j += kThreads) {
        v_s[j] = first ? 0.f : a.v[static_cast<size_t>(s.b) * cols + j];
        col_m[j] = -CUDART_INF_F;
        col_s[j] = 0.f;
      }
#pragma unroll
      for (int c = 0; c < kColValues; ++c) {
        cm[c] = -CUDART_INF_F;
        cs[c] = 0.f;
      }
      dm = -CUDART_INF_F;
      ds = 0.f;
      b_cur = s.b;
      __syncthreads();
#pragma unroll
      for (int t = 0; t < kLaneValues; ++t) {
        const int j = lane + 32 * t;
        vr[t] = j < N ? v_s[j] : 0.f;
      }
    }
    cp_async_wait<1>();  // this slab's copies; the next one's may fly
    __syncwarp();
    if (warp < s.n) {
      const float* row = buf + static_cast<size_t>(warp) * N;
      float m = -CUDART_INF_F, sum = 0.f;
      if (tail0)
        row_chunk<true>(row, vr, 0, N, m, sum);
      else
        row_chunk<false>(row, vr, 0, N, m, sum);
      for (int c0 = kChunk; c0 < N; c0 += kChunk) {
        float vc[kLaneValues];
#pragma unroll
        for (int t = 0; t < kLaneValues; ++t) {
          const int j = c0 + lane + 32 * t;
          vc[t] = j < N ? v_s[j] : 0.f;
        }
        if (c0 + kChunk > N)
          row_chunk<true>(row, vc, c0, N, m, sum);
        else
          row_chunk<false>(row, vc, c0, N, m, sum);
      }
      merge(m, sum, alpha + v_s[N], 1.f);  // the dustbin column
      const int i = s.i0 + warp;
      const float ui = (i < a.M ? norm : lmu_bin) - (logf(sum) + m);
      if (lane == 0) {
        u_s[warp] = ui;
        a.u[s.b * height + i] = ui;
      }
    }
    __syncthreads();
    float ur[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) ur[r] = r < s.n ? u_s[r] : -CUDART_INF_F;
    if (tail0)
      fold_chunk<kRows, true>(buf, ur, 0, N, cm, cs);
    else
      fold_chunk<kRows, false>(buf, ur, 0, N, cm, cs);
    for (int c0 = kChunk; c0 < N; c0 += kChunk) {
      float m2[kColValues], s2[kColValues];
#pragma unroll
      for (int c = 0; c < kColValues; ++c) {
        const int j = c0 + threadIdx.x + kThreads * c;
        m2[c] = j < N ? col_m[j] : 0.f;
        s2[c] = j < N ? col_s[j] : 0.f;
      }
      fold_chunk<kRows, true>(buf, ur, c0, N, m2, s2);
#pragma unroll
      for (int c = 0; c < kColValues; ++c) {
        const int j = c0 + threadIdx.x + kThreads * c;
        if (j < N) {
          col_m[j] = m2[c];
          col_s[j] = s2[c];
        }
      }
    }
    if (warp == kWarps - 1) {  // the dustbin column: alpha in every row
      const float x = lane < s.n ? alpha + u_s[lane] : -CUDART_INF_F;
      const float mx = warp_max(x);
      const float sum = warp_sum(lane < s.n ? exp_from(x, mx) : 0.f);
      merge(dm, ds, mx, sum);
    }
    __syncthreads();
  }
  if (b_cur >= 0) write_partials(b_cur);
}

// v from the blocks' column partials, in slot order.
__global__ void sinkhorn_cols(Args a) {
  const int cols = a.N + 1;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (j >= cols) return;
  const int height = a.M + 1;
  const int n = ((b + 1) * height - 1) / a.rows - b * height / a.rows + 1;
  const float* p = a.part + static_cast<size_t>(b) * a.parts * 2 * cols + j;
  const size_t step = 2 * static_cast<size_t>(cols);
  float m = -CUDART_INF_F;
#pragma unroll 8
  for (int q = 0; q < n; ++q) m = fmaxf(m, p[q * step]);
  float s = 0.f;
#pragma unroll 8
  for (int q = 0; q < n; ++q)
    s = fmaf(p[q * step + cols], exp_from(p[q * step], m), s);
  const float norm = log_norm(a);
  const float lnu = j < a.N ? norm : logf(static_cast<float>(a.M)) + norm;
  a.v[static_cast<size_t>(b) * cols + j] = lnu - (logf(s) + m);
}

// Z = C + u + v - norm, one block a row of Z; u = v = 0 where `zero`.
__global__ void sinkhorn_out(Args a, float* Z, int zero) {
  const int N = a.N, cols = N + 1;
  const int g = blockIdx.x;
  const int height = a.M + 1;
  const int b = g / height, i = g % height;
  const float alpha = *a.alpha;
  const float norm = log_norm(a);
  const float ui = zero ? 0.f : a.u[g];
  const float* src =
      a.scores + (static_cast<size_t>(b) * a.M + (i < a.M ? i : 0)) * N;
  const float* vb = a.v + static_cast<size_t>(b) * cols;
  float* dst = Z + static_cast<size_t>(g) * cols;
  for (int j = threadIdx.x; j < cols; j += blockDim.x) {
    const float c = (i < a.M && j < N) ? src[j] : alpha;
    const float vj = zero ? 0.f : vb[j];
    dst[j] = ((c + ui) + vj) - norm;
  }
}

}  // namespace

// Bytes of device scratch that sinkhorn_forward needs for these sizes on the
// current device; 0 where the kernel does not take them (rows too long for
// a shared-memory slab, or an empty dimension).
extern "C" size_t sinkhorn_workspace_bytes(int B, int M, int N) {
  Plan p;
  if (!device_plan(B, M, N, &p)) return 0;
  return sizeof(float) *
         (static_cast<size_t>(B) * (M + 1) + static_cast<size_t>(B) * (N + 1) +
          static_cast<size_t>(B) * p.parts * 2 * (N + 1));
}

// 2 * iters + 1 launches on `stream`, none of which synchronises. scores
// [B,M,N] and Z [B,M+1,N+1] fp32, contiguous; alpha one fp32 on the device;
// `work` holds sinkhorn_workspace_bytes(B, M, N) bytes.
extern "C" int sinkhorn_forward(const float* scores, const float* alpha,
                                int B, int M, int N, int iters, float* Z,
                                void* work, cudaStream_t stream) {
  Plan p;
  if (!device_plan(B, M, N, &p) || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.scores = scores;
  a.alpha = alpha;
  a.u = static_cast<float*>(work);
  a.v = a.u + static_cast<size_t>(B) * (M + 1);
  a.part = a.v + static_cast<size_t>(B) * (N + 1);
  a.B = B;
  a.M = M;
  a.N = N;
  a.rows = p.rows;
  a.slab = p.slab;
  a.parts = p.parts;
  a.vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(scores) % 16 == 0;
  void (*rows)(Args, int, int) = p.slab == kMaxRows
                                     ? sinkhorn_rows<kMaxRows>
                                     : sinkhorn_rows<kMinRows>;
  cudaError_t err = cudaSuccess;
  if (iters > 0)
    err = cudaFuncSetAttribute(rows,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(p.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 col_grid((N + 1 + 255) / 256, B);
  for (int it = 0; it < iters; ++it) {
    rows<<<p.grid, kThreads, p.smem, stream>>>(a, it == 0, it & 1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    sinkhorn_cols<<<col_grid, 256, 0, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sinkhorn_out<<<static_cast<unsigned>(B * (M + 1)), 256, 0, stream>>>(
      a, Z, iters == 0);
  return static_cast<int>(cudaGetLastError());
}
