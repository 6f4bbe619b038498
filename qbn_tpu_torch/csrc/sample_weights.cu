// Posterior weight draw of converted Bayes-by-backprop layers, for Hopper.
//
// Replaces the Pallas kernels of qbn_tpu/ops/pallas/sample_weights.py:
// sample_weights_int8 (_kernel_prng_pair, _kernel_prng, _kernel_noise) and
// draw_all_layers (_kernel_rows_prng, _kernel_rows_noise). One launch draws
// S int8 samples of every layer of a pack: for each element
//   eps   ~ N(0, 1)                                  (Philox-4x32-10 +
//                                                     Box-Muller, or read
//                                                     from explicit noise)
//   eps_q = clip(round(eps * 127/3), -128, 127)
//   prod  = clip(round(std_f * (eps_q * 3/127) * (1/mul_scale)) + mul_zp)
//   ws    = clip(round((w_f + (prod - mul_zp) * mul_scale) * (1/add_scale))
//                + add_zp), then clip to [w_lo, w_hi]
// with w_f = (w - w_zp) * w_scale and std_f = (std - std_zp) * std_scale,
// in that order of operations (qbn_tpu's _body_parts/_body_from and
// sample_weights_oracle). The chain is written with __fmul_rn/__fadd_rn/
// __fsub_rn so that nvcc cannot contract it into fused multiply-adds, and
// rounds half to even with rintf: given the same noise the codes are
// bitwise those of the plain PyTorch version.
//
// Layout. A pack holds L layers. Layer l has n_l = M*N elements per sample;
// its S samples occupy one contiguous (S, n_l) block of the output, which
// starts at a multiple of 16 elements. Each thread owns 16 consecutive
// outputs of one layer block (which may run across a sample boundary),
// stores them with one 16-byte write, and reads the mean/std codes of
// those elements (the codes are ~1.6 MB for the flagship and stay in L2).
//
// What bounds it on an H100: the output, S * sum(n_l) bytes (157.2 MB for
// the flagship ResNet-18 at S = 100, 47 us at 3.35 TB/s), and the fp32
// work per element: the quantise chain (26 operations) plus the normal
// draw (Philox rounds, log, sqrt and sincos, shared by a pair of outputs).
// The design keeps every intermediate in registers, so the output is
// written once and nothing else goes to device memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kPerThread = 16;   // outputs per thread: one 16-byte store
constexpr int kThreads = 256;
constexpr int kQ = 10;           // qparams per layer, see QIdx
constexpr int kMeta = 4;         // int64 meta per layer, see MetaIdx

// float32(1 / (3/127)) and float32(3/127), exactly as qbn_tpu's f32
// arithmetic sees the Python constants.
constexpr float kInvNoiseScale = 0x1.52aaaap+5f;
constexpr float kNoiseScale = 0x1.83060cp-6f;

enum QIdx { W_SCALE, W_ZP, STD_SCALE, STD_ZP, MUL_SCALE, MUL_ZP, ADD_SCALE,
            ADD_ZP, W_LO, W_HI };
// chunk_start: first thread of the layer; dst: first output element of the
// layer's (S, n) block; src: first code of the layer in w/std; n: elements
// per sample.
enum MetaIdx { CHUNK_START, DST, SRC, N };

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

struct Layer {
  float w_scale, w_zp, std_scale, std_zp, mul_scale, mul_zp, inv_mul,
        add_zp, inv_add, w_lo, w_hi;
};

__device__ __forceinline__ int8_t draw_code(float eps, int8_t w, int8_t sd,
                                            const Layer& q) {
  const float w_f = __fmul_rn(__fsub_rn((float)w, q.w_zp), q.w_scale);
  const float std_f = __fmul_rn(__fsub_rn((float)sd, q.std_zp), q.std_scale);
  const float eps_q = clip(rintf(__fmul_rn(eps, kInvNoiseScale)),
                           -128.0f, 127.0f);
  const float prod = clip(
      __fadd_rn(rintf(__fmul_rn(__fmul_rn(std_f, __fmul_rn(eps_q, kNoiseScale)),
                                q.inv_mul)),
                q.mul_zp),
      -128.0f, 127.0f);
  const float prod_f = __fmul_rn(__fsub_rn(prod, q.mul_zp), q.mul_scale);
  const float ws = clip(
      __fadd_rn(rintf(__fmul_rn(__fadd_rn(w_f, prod_f), q.inv_add)), q.add_zp),
      -128.0f, 127.0f);
  return (int8_t)__float2int_rn(clip(ws, q.w_lo, q.w_hi));
}

__global__ void __launch_bounds__(kThreads)
draw_kernel(const int8_t* __restrict__ w, const int8_t* __restrict__ std_codes,
            const float* __restrict__ qtab, const long long* __restrict__ meta,
            int n_layers, long long total_chunks, int samples,
            const float* __restrict__ noise, unsigned long long seed,
            unsigned long long offset, int8_t* __restrict__ out) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total_chunks) return;

  // the layer owning this thread: last l with chunk_start[l] <= t
  int l = 0;
  for (int i = 1; i < n_layers; ++i) {
    if (meta[i * kMeta + CHUNK_START] <= t) l = i;
  }
  const long long* m = meta + l * kMeta;
  const long long n = m[N];
  const long long block = (long long)samples * n;
  const long long e0 = (t - m[CHUNK_START]) * kPerThread;
  const int count = (int)min((long long)kPerThread, block - e0);
  long long i = e0 % n;                    // element index within a sample

  const float* qp = qtab + l * kQ;
  Layer q;
  q.w_scale = qp[W_SCALE];
  q.w_zp = qp[W_ZP];
  q.std_scale = qp[STD_SCALE];
  q.std_zp = qp[STD_ZP];
  q.mul_scale = qp[MUL_SCALE];
  q.mul_zp = qp[MUL_ZP];
  q.inv_mul = __fdiv_rn(1.0f, qp[MUL_SCALE]);
  q.add_zp = qp[ADD_ZP];
  q.inv_add = __fdiv_rn(1.0f, qp[ADD_SCALE]);
  q.w_lo = qp[W_LO];
  q.w_hi = qp[W_HI];

  float eps[kPerThread];
  const long long dst = m[DST] + e0;
  if (noise != nullptr) {
    if (count == kPerThread) {
      const float4* src = reinterpret_cast<const float4*>(noise + dst);
#pragma unroll
      for (int k = 0; k < kPerThread / 4; ++k) {
        const float4 v = src[k];
        eps[4 * k] = v.x;
        eps[4 * k + 1] = v.y;
        eps[4 * k + 2] = v.z;
        eps[4 * k + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {   // static indices: registers
        if (k < count) eps[k] = noise[dst + k];
      }
    }
  } else {
    const uint2 key = make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));
#pragma unroll
    for (int k = 0; k < kPerThread / 4; ++k) {
      const uint4 r = qbn::philox4x32_10(
          make_uint4((uint32_t)t, (uint32_t)(t >> 32), (uint32_t)k,
                     (uint32_t)offset),
          key);
      qbn::box_muller(r.x, r.y, &eps[4 * k], &eps[4 * k + 1]);
      qbn::box_muller(r.z, r.w, &eps[4 * k + 2], &eps[4 * k + 3]);
    }
  }

  const int8_t* wl = w + m[SRC];
  const int8_t* sl = std_codes + m[SRC];
  uint32_t packed[kPerThread / 4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    if (k < count) {
      const int8_t c = draw_code(eps[k], wl[i], sl[i], q);
      packed[k / 4] |= (uint32_t)(uint8_t)c << (8 * (k % 4));
      if (++i == n) i = 0;
    }
  }
  if (count == kPerThread) {
    *reinterpret_cast<uint4*>(out + dst) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      if (k < count) out[dst + k] = (int8_t)(packed[k / 4] >> (8 * (k % 4)));
    }
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// noise == nullptr draws the normals with Philox keyed by (seed, offset).
extern "C" int qbn_draw_int8(const void* w, const void* std_codes,
                             const void* qtab, const void* meta, int n_layers,
                             long long total_chunks, int samples,
                             const void* noise, unsigned long long seed,
                             unsigned long long offset, void* out,
                             void* stream) {
  if (total_chunks <= 0) return 0;
  const long long blocks = (total_chunks + kThreads - 1) / kThreads;
  draw_kernel<<<(unsigned int)blocks, kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(w), static_cast<const int8_t*>(std_codes),
      static_cast<const float*>(qtab), static_cast<const long long*>(meta),
      n_layers, total_chunks, samples, static_cast<const float*>(noise), seed,
      offset, static_cast<int8_t*>(out));
  return (int)cudaGetLastError();
}
