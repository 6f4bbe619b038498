// Fused local-reparametrisation dense forward of Bayes-by-backprop
// training, for Hopper.
//
// Replaces the Pallas kernels of qbn_tpu/ops/pallas/bbb_dense.py:
// local_reparam_dense_fused (_kernel_noise with explicit noise,
// _kernel_prng with normals drawn on chip). In float32:
//   out = x @ w + sqrt(1e-8 + (x*x) @ (sp*sp)) * eps
// x (B, K), w and sp (K, N), eps and out (B, N), all row-major and
// contiguous, any B, K, N (the kernel masks the ragged edges). The bias is
// added by the caller. eps is read from `noise`, or, when noise is null,
// drawn here with Philox-4x32-10 and Box-Muller (csrc/philox.cuh) keyed by
// (seed, offset), one counter per output element.
//
// What bounds it on an H100: the operations. At LeNet's fc_0 (B=256,
// K=2450, N=500) the two products are 4*B*K*N = 1.254 GFLOP, 18.7 us at
// 67 TFLOP/s of float32 outside the tensor cores; the bytes (x, w, sp,
// eps read once, out written once) are 13.3 MB, 4.0 us at 3.35 TB/s.
// The tensor cores are not used: TF32 keeps about 3 decimal digits where
// qbn_tpu's float32 products keep 7.
//
// Design. One CTA of 256 threads owns a 64x64 output tile and a range of
// K. Per K-step of 16 it stages the x tile in shared memory once, with its
// square, and the w tile with sp squared, so the x tile feeds both
// products. Each thread keeps 4x4 outputs with two float32 accumulators
// each (mean and variance) and walks the tile with ordinary FMAs. At
// B=256, N=500 there are only 32 such tiles for 132 SMs, so K is split:
// the wrapper picks the number of splits that gives about two CTAs per SM
// (9 at fc_0, 288 CTAs). Every CTA of a tile writes its partial sums to a
// workspace; the last to finish (a counter per tile, after a thread fence)
// adds the partials in split order, so the result does not depend on the
// order in which CTAs finish, and runs the epilogue
// mean + sqrtf(1e-8f + var) * eps. With one split the epilogue reads the
// registers directly.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 16;
constexpr int kThreads = 256;           // 16 x 16
constexpr int kTM = 4, kTN = 4;         // rows ty + 16 i, cols tx + 16 j
constexpr int kPad = 4;                 // spreads the transposed x stores
constexpr int kPart = 2 * kTM * kTN;    // partials per thread
constexpr float kVarEps = 1e-8f;

__device__ __forceinline__ float normal_at(unsigned long long idx,
                                           unsigned long long seed,
                                           unsigned long long offset) {
  const uint4 r = qbn::philox4x32_10(
      make_uint4((uint32_t)idx, (uint32_t)(idx >> 32),
                 (uint32_t)(offset >> 32), (uint32_t)offset),
      make_uint2((uint32_t)seed, (uint32_t)(seed >> 32)));
  float z0, z1;
  qbn::box_muller(r.x, r.y, &z0, &z1);
  return z0;
}

__global__ void __launch_bounds__(kThreads)
bbb_dense_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ sp,
                 const float* __restrict__ noise, unsigned long long seed,
                 unsigned long long offset, float* __restrict__ out, int B,
                 int K, int N, int k_chunk, float* __restrict__ workspace,
                 int* __restrict__ counters) {
  __shared__ float xs[kBK][kBM + kPad];    // x tile, transposed: [k][m]
  __shared__ float x2s[kBK][kBM + kPad];   // its square
  __shared__ float ws[kBK][kBN];           // w tile
  __shared__ float s2s[kBK][kBN];          // sp tile, squared
  __shared__ int is_last;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int split = blockIdx.z, splits = gridDim.z;
  const int k_begin = split * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);

  float acc_m[kTM][kTN], acc_v[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      acc_m[i][j] = 0.0f;
      acc_v[i][j] = 0.0f;
    }
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    // x tile (BM x BK): neighbouring threads read neighbouring k of a row
#pragma unroll
    for (int r = 0; r < kBM * kBK / kThreads; ++r) {
      const int kk = tid % kBK, mm = tid / kBK + r * (kThreads / kBK);
      const int gm = m0 + mm, gk = k0 + kk;
      const float v = (gm < B && gk < k_end) ? x[(size_t)gm * K + gk] : 0.0f;
      xs[kk][mm] = v;
      x2s[kk][mm] = v * v;
    }
    // w and sp tiles (BK x BN): neighbouring threads read neighbouring n
#pragma unroll
    for (int r = 0; r < kBK * kBN / kThreads; ++r) {
      const int nn = tid % kBN, kk = tid / kBN + r * (kThreads / kBN);
      const int gk = k0 + kk, gn = n0 + nn;
      const bool in = gk < k_end && gn < N;
      ws[kk][nn] = in ? w[(size_t)gk * N + gn] : 0.0f;
      const float s = in ? sp[(size_t)gk * N + gn] : 0.0f;
      s2s[kk][nn] = s * s;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM], a2[kTM], b[kTN], b2[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        a[i] = xs[kk][ty + 16 * i];
        a2[i] = x2s[kk][ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        b[j] = ws[kk][tx + 16 * j];
        b2[j] = s2s[kk][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          acc_m[i][j] = fmaf(a[i], b[j], acc_m[i][j]);
          acc_v[i][j] = fmaf(a2[i], b2[j], acc_v[i][j]);
        }
      }
    }
    __syncthreads();
  }

  if (splits > 1) {
    // partials of this split; index [(tile * splits + split)][p][tid]
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    float* mine = workspace + ((size_t)tile * splits + split) * kPart * kThreads;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        mine[(i * kTN + j) * kThreads + tid] = acc_m[i][j];
        mine[(kTM * kTN + i * kTN + j) * kThreads + tid] = acc_v[i][j];
      }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) is_last = atomicAdd(&counters[tile], 1) == splits - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    // the last CTA of the tile adds every split's partials in split order
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        acc_m[i][j] = 0.0f;
        acc_v[i][j] = 0.0f;
      }
    }
    for (int s = 0; s < splits; ++s) {
      const float* part =
          workspace + ((size_t)tile * splits + s) * kPart * kThreads;
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          acc_m[i][j] += __ldcg(part + (i * kTN + j) * kThreads + tid);
          acc_v[i][j] +=
              __ldcg(part + (kTM * kTN + i * kTN + j) * kThreads + tid);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gm = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gm < B && gn < N) {
        const size_t idx = (size_t)gm * N + gn;
        const float eps =
            noise != nullptr ? noise[idx] : normal_at(idx, seed, offset);
        out[idx] = acc_m[i][j] + sqrtf(kVarEps + acc_v[i][j]) * eps;
      }
    }
  }
}

}  // namespace

// Tile sizes, so that the wrapper sizes the grid, the workspace and the
// counters: {BM, BN, BK, partial floats per CTA}.
extern "C" void qbn_bbb_dense_tiles(int* out) {
  out[0] = kBM;
  out[1] = kBN;
  out[2] = kBK;
  out[3] = kPart * kThreads;
}

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// splits CTAs share each 64x64 tile, each over k_chunk (a multiple of 16)
// of K. With splits > 1, workspace holds tiles * splits * (partial floats
// per CTA) floats and counters holds one zeroed int per tile.
extern "C" int qbn_bbb_dense(const void* x, const void* w, const void* sp,
                             const void* noise, unsigned long long seed,
                             unsigned long long offset, void* out, int B,
                             int K, int N, int splits, int k_chunk,
                             void* workspace, void* counters, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const dim3 grid((N + kBN - 1) / kBN, (B + kBM - 1) / kBM, splits);
  bbb_dense_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(sp), static_cast<const float*>(noise), seed,
      offset, static_cast<float*>(out), B, K, N, k_chunk,
      static_cast<float*>(workspace), static_cast<int*>(counters));
  return (int)cudaGetLastError();
}
