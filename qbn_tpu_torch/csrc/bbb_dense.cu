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
// The products: 3xTF32 on the tensor cores (mma.sync m16n8k8 TF32, float32
// accumulators). Each float32 operand a is split into hi = rna_tf32(a) and
// lo = rna_tf32(a - hi) (a - hi is exact), and a*b is taken as
// lo_a*hi_b + hi_a*lo_b + hi_a*hi_b. The dropped lo_a*lo_b and the
// rounding of lo leave about 2^-21 of |a*b| per product; the float32
// dot-product bound that the result is held to, gamma_K = K * 2^-24, is
// 1.5e-4 at K = 2450, so the split keeps float32 accuracy where a single
// TF32 product (11 significant bits) would not. x*x and sp*sp are squared
// in float32 before the split, as the plain version squares them.
//
// What bounds it on an H100: the operations. At LeNet's fc_0 (B=256,
// K=2450, N=500) the two products are 4*B*K*N = 1.254 GFLOP; as 3xTF32 that
// is 3 x 1.254 GFLOP at 494.7 TFLOP/s of dense TF32 = 7.6 us, against
// 13.3 MB of bytes (x, w, sp, eps read once, out written once) = 4.0 us at
// 3.35 TB/s. (On the float32 CUDA cores the same products would be bound
// at 18.8 us, 67 TFLOP/s.) mma.sync, not wgmma, issues them. On the H100
// at fc_0 the 3.76 GFLOP of TF32 take 50 us (75 TFLOP/s; PERF.md), with
// no one part dominant, and one CTA per SM ran as fast as two.
//
// Design. One CTA of 256 threads (8 warps, 2 x 4, each 32 x 16 outputs)
// owns a 64x64 output tile and a range of K. The x tile (64 x 32) and the
// w and sp tiles (32 x 64) of each K step of 32 arrive by cp.async (16
// bytes where the rows are 16-byte aligned, else 8 or 4; ragged edges
// zero-filled by the copy) into a ring of three stages, so the next two
// steps are in flight while the current one is multiplied. Shared rows
// are padded (x: 36 floats, w/sp: 72) so that every fragment load of a
// warp hits 32 distinct banks. A warp loads its fragments once per k8 and
// feeds both products from them: x for the mean, x*x for the variance.
// At B=256, N=500 there are only 32 tiles for 132 SMs, so K is split: the
// wrapper takes as many splits as one CTA per SM allows (4 at fc_0, 128
// CTAs; 8 at fc_1). Every CTA of a tile writes its partial sums to a
// workspace; the last to finish (a counter per tile, after a thread
// fence) adds the partials in split order, so the result does not depend
// on the order in which CTAs finish, and runs the epilogue
// mean + sqrtf(1e-8f + var) * eps.
// With one split the epilogue reads the registers directly.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kThreads = 256;             // 8 warps: 2 (m) x 4 (n)
constexpr int kStages = 3;
constexpr int kLdA = kBK + 4;             // x rows: banks 4g + t
constexpr int kLdB = kBN + 8;             // w/sp rows: banks 8t + g
constexpr int kAFloats = kBM * kLdA;
constexpr int kBFloats = kBK * kLdB;
constexpr int kStageFloats = kAFloats + 2 * kBFloats;
constexpr int kSmemBytes = kStages * kStageFloats * 4;
constexpr int kMT = 2, kNT = 2;           // m16 and n8 tiles per warp
constexpr int kPart = 2 * kMT * kNT * 4;  // partials per thread
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

__device__ __forceinline__ uint32_t tf32(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(a));
  return r;
}

// hi = rna_tf32(a), lo = rna_tf32(a - hi)
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32(a);
  lo = tf32(__fsub_rn(a, __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += a*b in 3xTF32, the small terms first
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t* a_hi,
                                           const uint32_t* a_lo,
                                           const uint32_t* b_hi,
                                           const uint32_t* b_lo) {
  mma_tf32(c, a_lo, b_hi);
  mma_tf32(c, a_hi, b_lo);
  mma_tf32(c, a_hi, b_hi);
}

// cp.async of V floats (4, 8 or 16 bytes); src_bytes 0 zero-fills
template <int V>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool in) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  const int n = in ? 4 * V : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(4 * V), "r"(n));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One K step's tiles into a stage: x rows of VA floats, w / sp rows of VB
// (VA divides K and VB divides N, so no vector crosses an edge).
template <int VA, int VB>
__device__ __forceinline__ void load_stage(
    float* st, const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ sp, int m0, int n0, int k0, int k_end, int B,
    int K, int N, int tid) {
  float* as = st;
  float* ws = st + kAFloats;
  float* ss = ws + kBFloats;
  static_assert(kBM * kBK % (VA * kThreads) == 0, "x tile split");
  static_assert(kBK * kBN % (VB * kThreads) == 0, "w tile split");
#pragma unroll
  for (int r = 0; r < kBM * kBK / (VA * kThreads); ++r) {
    const int i = tid + r * kThreads;
    const int mm = i / (kBK / VA), kk = (i % (kBK / VA)) * VA;
    const int gm = m0 + mm, gk = k0 + kk;
    const bool in = gm < B && gk < k_end;
    cp_async<VA>(as + mm * kLdA + kk, in ? x + (size_t)gm * K + gk : x, in);
  }
#pragma unroll
  for (int r = 0; r < kBK * kBN / (VB * kThreads); ++r) {
    const int i = tid + r * kThreads;
    const int kk = i / (kBN / VB), nn = (i % (kBN / VB)) * VB;
    const int gk = k0 + kk, gn = n0 + nn;
    const bool in = gk < k_end && gn < N;
    const size_t off = in ? (size_t)gk * N + gn : 0;
    cp_async<VB>(ws + kk * kLdB + nn, w + off, in);
    cp_async<VB>(ss + kk * kLdB + nn, sp + off, in);
  }
}

template <int VA, int VB>
__global__ void __launch_bounds__(kThreads)
bbb_dense_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ sp,
                 const float* __restrict__ noise, unsigned long long seed,
                 unsigned long long offset, float* __restrict__ out, int B,
                 int K, int N, int k_chunk, float* __restrict__ workspace,
                 int* __restrict__ counters) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int is_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int split = blockIdx.z, splits = gridDim.z;
  const int k_begin = split * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int steps = (k_end - k_begin + kBK - 1) / kBK;

  float acc_m[kMT][kNT][4], acc_v[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_m[i][j][e] = acc_v[i][j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps)
      load_stage<VA, VB>(smem + s * kStageFloats, x, w, sp, m0, n0,
                         k_begin + s * kBK, k_end, B, K, N, tid);
    cp_commit();
  }

  for (int it = 0; it < steps; ++it) {
    cp_wait<kStages - 2>();
    __syncthreads();   // step it has landed; step it-1's stage is free
    {
      const int nxt = it + kStages - 1;
      if (nxt < steps)
        load_stage<VA, VB>(smem + (nxt % kStages) * kStageFloats, x, w, sp,
                           m0, n0, k_begin + nxt * kBK, k_end, B, K, N, tid);
      cp_commit();
    }
    const float* as = smem + (it % kStages) * kStageFloats;
    const float* ws = as + kAFloats;
    const float* ss = ws + kBFloats;
#pragma unroll
    for (int k8 = 0; k8 < kBK; k8 += 8) {
      uint32_t a_hi[kMT][4], a_lo[kMT][4], q_hi[kMT][4], q_lo[kMT][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const float* r0 = as + (wm + 16 * i + g) * kLdA + k8 + t;
        const float v[4] = {r0[0], r0[8 * kLdA], r0[4], r0[8 * kLdA + 4]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          split_tf32(v[e], a_hi[i][e], a_lo[i][e]);
          split_tf32(__fmul_rn(v[e], v[e]), q_hi[i][e], q_lo[i][e]);
        }
      }
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int c = (k8 + t) * kLdB + wn + 8 * j + g;
        uint32_t b_hi[2], b_lo[2], s_hi[2], s_lo[2];
        split_tf32(ws[c], b_hi[0], b_lo[0]);
        split_tf32(ws[c + 4 * kLdB], b_hi[1], b_lo[1]);
        const float s0 = ss[c], s1 = ss[c + 4 * kLdB];
        split_tf32(__fmul_rn(s0, s0), s_hi[0], s_lo[0]);
        split_tf32(__fmul_rn(s1, s1), s_hi[1], s_lo[1]);
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          mma_3xtf32(acc_m[i][j], a_hi[i], a_lo[i], b_hi, b_lo);
          mma_3xtf32(acc_v[i][j], q_hi[i], q_lo[i], s_hi, s_lo);
        }
      }
    }
  }
  cp_wait<0>();

  if (splits > 1) {
    // partials of this split; index [(tile * splits + split)][p][tid]
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    float* mine =
        workspace + ((size_t)tile * splits + split) * kPart * kThreads;
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = (i * kNT + j) * 4 + e;
          mine[p * kThreads + tid] = acc_m[i][j][e];
          mine[(kPart / 2 + p) * kThreads + tid] = acc_v[i][j][e];
        }
    __threadfence();
    __syncthreads();
    if (tid == 0) is_last = atomicAdd(&counters[tile], 1) == splits - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    // the last CTA of the tile adds every split's partials in split order
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_m[i][j][e] = acc_v[i][j][e] = 0.0f;
    for (int s = 0; s < splits; ++s) {
      const float* part =
          workspace + ((size_t)tile * splits + s) * kPart * kThreads;
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int p = (i * kNT + j) * 4 + e;
            acc_m[i][j][e] += __ldcg(part + p * kThreads + tid);
            acc_v[i][j][e] += __ldcg(part + (kPart / 2 + p) * kThreads + tid);
          }
    }
  }

  // c[e] of an m16n8 tile: row g + 8 (e >> 1), column 2 t + (e & 1)
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gm = m0 + wm + 16 * i + g + 8 * (e >> 1);
        const int gn = n0 + wn + 8 * j + 2 * t + (e & 1);
        if (gm < B && gn < N) {
          const size_t idx = (size_t)gm * N + gn;
          const float eps =
              noise != nullptr ? noise[idx] : normal_at(idx, seed, offset);
          out[idx] = acc_m[i][j][e] + sqrtf(kVarEps + acc_v[i][j][e]) * eps;
        }
      }
}

template <int VA, int VB>
int launch(const dim3& grid, cudaStream_t stream, const float* x,
           const float* w, const float* sp, const float* noise,
           unsigned long long seed, unsigned long long offset, float* out,
           int B, int K, int N, int k_chunk, float* workspace,
           int* counters) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      bbb_dense_kernel<VA, VB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  bbb_dense_kernel<VA, VB><<<grid, kThreads, kSmemBytes, stream>>>(
      x, w, sp, noise, seed, offset, out, B, K, N, k_chunk, workspace,
      counters);
  return (int)cudaGetLastError();
}

// the widest copy (4, 2 or 1 floats) that divides a row of n floats and
// keeps every copy of the rows from p aligned
int vec_of(int n, const void* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (n % 4 == 0 && a % 16 == 0) return 4;
  if (n % 2 == 0 && a % 8 == 0) return 2;
  return 1;
}

template <int VA>
int launch_vb(int vb, const dim3& grid, cudaStream_t stream, const float* x,
              const float* w, const float* sp, const float* noise,
              unsigned long long seed, unsigned long long offset, float* out,
              int B, int K, int N, int k_chunk, float* workspace,
              int* counters) {
  if (vb == 4)
    return launch<VA, 4>(grid, stream, x, w, sp, noise, seed, offset, out, B,
                         K, N, k_chunk, workspace, counters);
  if (vb == 2)
    return launch<VA, 2>(grid, stream, x, w, sp, noise, seed, offset, out, B,
                         K, N, k_chunk, workspace, counters);
  return launch<VA, 1>(grid, stream, x, w, sp, noise, seed, offset, out, B, K,
                       N, k_chunk, workspace, counters);
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
// splits CTAs share each 64x64 tile, each over k_chunk (a multiple of 32)
// of K. With splits > 1, workspace holds tiles * splits * (partial floats
// per CTA) floats and counters holds one zeroed int per tile.
extern "C" int qbn_bbb_dense(const void* x, const void* w, const void* sp,
                             const void* noise, unsigned long long seed,
                             unsigned long long offset, void* out, int B,
                             int K, int N, int splits, int k_chunk,
                             void* workspace, void* counters, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  const dim3 grid((N + kBN - 1) / kBN, (B + kBM - 1) / kBM, splits);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *xf = static_cast<const float*>(x),
              *wf = static_cast<const float*>(w),
              *sf = static_cast<const float*>(sp),
              *nf = static_cast<const float*>(noise);
  float* of = static_cast<float*>(out);
  float* wsf = static_cast<float*>(workspace);
  int* cf = static_cast<int*>(counters);
  const int va = vec_of(K, x);
  const int vb = min(vec_of(N, w), vec_of(N, sp));
  if (va == 4)
    return launch_vb<4>(vb, grid, st, xf, wf, sf, nf, seed, offset, of, B, K,
                        N, k_chunk, wsf, cf);
  if (va == 2)
    return launch_vb<2>(vb, grid, st, xf, wf, sf, nf, seed, offset, of, B, K,
                        N, k_chunk, wsf, cf);
  return launch_vb<1>(vb, grid, st, xf, wf, sf, nf, seed, offset, of, B, K, N,
                      k_chunk, wsf, cf);
}
