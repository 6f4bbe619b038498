// One MC-Dropout site of INT8 evaluation, for Hopper.
//
// Replaces no pallas_call: qbn_tpu runs a site's INT branch
// (qbn_tpu/models/layers.py BernoulliDropout) inside XLA fusions. Without
// it the port made about two dozen eager float32 passes over each site's
// activations. One launch computes, for int8 codes x at scale xs and a
// float32 keep mask m, the function of ops/dropout_site.py
// dropout_site_plain (models/layers.py BernoulliDropout in int mode):
//   mask_q   = clamp(rint(m / ms) + mz, 0, 255)
//   mask_deq = (mask_q - mz) * ms
//   prod     = (x * xs) * mask_deq
//   out      = clamp(rint(prod / ms) + mz, a_lo, a_hi) - mz    (int8)
// and the output scale ms * float32(1 / (1 - p)), for the site's multiply
// grid (ms, mz) and activation bounds. Bitwise: the same float32
// operations in the same order, written with __fdiv_rn, __fmul_rn,
// __fadd_rn and __fsub_rn so that nvcc contracts nothing into a fused
// multiply-add; rintf rounds half to even, as torch.round does.
//
// Table, not arithmetic. With the site's scalars fixed, an output code
// depends only on the input code (256 values) and on whether the mask
// keeps it. Each CTA builds the 2 x 256 table of output codes in shared
// memory with the arithmetic above, and each code then costs one lookup
// and no division. The mask is a binary keep mask (1 kept, 0 dropped), as
// every mask source of ops/stochastic.py gives; the plain version keeps
// the general arithmetic.
//
// Layout. x is (B, P, C) codes shared by every sample (the stem's site) or
// (S, B, P, C) per sample; the mask is (S, B, C), per (sample, image,
// channel) and broadcast over the P = H * W pixels (a dense site: P = 1 and
// one mask value per element); out is (S, B, P, C). Codes move in vectors
// of VEC bytes (16, or the largest of 8, 4, 2, 1 that divides C and the
// pointers' alignment). A row (one image of x) has nvr = P * vpp vectors,
// vpp = C / VEC a pixel. A CTA has a multiple of vpp threads, so that a
// thread keeps one channel group (c0 .. c0 + VEC) through every vector it
// touches, and its VEC mask values become table rows once per output row.
// Work items are (row of x, chunk of chunk_len vectors); each thread loads
// up to kItems vectors of the chunk, then writes them once per output row:
// once for a per-sample input, S times for a shared one, whose codes are
// read once. The CTAs walk over the items (grid-stride), each building its
// table once. ops/dropout_site.py site_plan computes the plan and the CPU
// tests emulate this mapping.
//
// What bounds it on an H100: bytes. The ResNet-18's 20 sites at B = 256,
// S = 20 read 1.05 GB of codes (the stem's input once) and 37 MB of masks
// and write 1.18 GB: about 0.68 ms at 3.35 TB/s. The table keeps the
// instructions a code to a few integer operations and a shared-memory
// load.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kItems = 4;      // vectors a thread keeps in flight (_ITEMS)
constexpr int kTable = 512;    // 2 mask values x 256 codes
constexpr int kMaxThreads = 1024;

template <int VEC>
struct Codes {
  static constexpr int kWords = VEC >= 4 ? VEC / 4 : 1;
  static constexpr int kPerWord = VEC >= 4 ? 4 : VEC;
  uint32_t w[kWords];
};

template <int VEC>
__device__ __forceinline__ Codes<VEC> load_codes(const int8_t* p) {
  Codes<VEC> c;
  if constexpr (VEC == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    c.w[0] = v.x;
    c.w[1] = v.y;
    c.w[2] = v.z;
    c.w[3] = v.w;
  } else if constexpr (VEC == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    c.w[0] = v.x;
    c.w[1] = v.y;
  } else if constexpr (VEC == 4) {
    c.w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else if constexpr (VEC == 2) {
    c.w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  } else {
    c.w[0] = __ldg(reinterpret_cast<const unsigned char*>(p));
  }
  return c;
}

template <int VEC>
__device__ __forceinline__ void store_codes(int8_t* p, const Codes<VEC>& c) {
  if constexpr (VEC == 16) {
    *reinterpret_cast<uint4*>(p) = make_uint4(c.w[0], c.w[1], c.w[2], c.w[3]);
  } else if constexpr (VEC == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(c.w[0], c.w[1]);
  } else if constexpr (VEC == 4) {
    *reinterpret_cast<unsigned int*>(p) = c.w[0];
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<unsigned short*>(p) = (unsigned short)c.w[0];
  } else {
    *reinterpret_cast<unsigned char*>(p) = (unsigned char)c.w[0];
  }
}

__device__ __forceinline__ uint32_t table_row(float m) {
  return m != 0.0f ? 256u : 0u;
}

// The table row (0 dropped, 256 kept) of each of the VEC mask values at m.
template <int VEC>
__device__ __forceinline__ void mask_rows(const float* m,
                                          uint32_t (&row)[VEC]) {
  if constexpr (VEC >= 4) {
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(m) + q);
      row[4 * q] = table_row(v.x);
      row[4 * q + 1] = table_row(v.y);
      row[4 * q + 2] = table_row(v.z);
      row[4 * q + 3] = table_row(v.w);
    }
  } else if constexpr (VEC == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(m));
    row[0] = table_row(v.x);
    row[1] = table_row(v.y);
  } else {
    row[0] = table_row(__ldg(m));
  }
}

template <int VEC>
__global__ void __launch_bounds__(kMaxThreads) dropout_site_kernel(
    const int8_t* __restrict__ x, const float* __restrict__ mask,
    const float* __restrict__ x_scale, const float* __restrict__ mul_scale,
    const void* __restrict__ mul_zp, int zp_float, int a_lo, int a_hi,
    float multiplier, int8_t* __restrict__ out, float* __restrict__ out_scale,
    long long batch, int samples, int shared, long long nvr, int vpp,
    int chunk_len, int chunks, int items) {
  __shared__ int8_t table[kTable];
  const float xs = *x_scale;
  const float ms = *mul_scale;
  const float mzf = zp_float ? *static_cast<const float*>(mul_zp)
                             : (float)*static_cast<const int*>(mul_zp);
  const int mzi = zp_float ? (int)mzf : *static_cast<const int*>(mul_zp);
  const float lo = (float)a_lo, hi = (float)a_hi;
  for (int e = threadIdx.x; e < kTable; e += blockDim.x) {
    const float m = e >= 256 ? 1.0f : 0.0f;
    const float code = (float)(int8_t)(e & 255);
    const float mask_q =
        fminf(fmaxf(__fadd_rn(rintf(__fdiv_rn(m, ms)), mzf), 0.0f), 255.0f);
    const float mask_deq = __fmul_rn(__fsub_rn(mask_q, mzf), ms);
    const float prod = __fmul_rn(__fmul_rn(code, xs), mask_deq);
    const float q =
        fminf(fmaxf(__fadd_rn(rintf(__fdiv_rn(prod, ms)), mzf), lo), hi);
    table[e] = (int8_t)((int)q - mzi);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0)
    *out_scale = __fmul_rn(ms, multiplier);
  __syncthreads();

  const int t = threadIdx.x, nt = blockDim.x;
  const long long c = (long long)vpp * VEC;
  const int c0 = (t % vpp) * VEC;     // nt and chunk_len are multiples of vpp
  const int ns = shared ? samples : 1;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int row = item / chunks;    // b when shared, else s * B + b
    const long long start = (long long)(item - row * chunks) * chunk_len;
    const long long left = nvr - start;
    const int len = left < chunk_len ? (int)left : chunk_len;
    Codes<VEC> in[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int w = t + j * nt;
      if (w < len)
        in[j] = load_codes<VEC>(x + ((long long)row * nvr + start + w) * VEC);
    }
    for (int s = 0; s < ns; ++s) {
      const long long r = shared ? (long long)s * batch + row : row;
      uint32_t off[VEC];
      mask_rows<VEC>(mask + r * c + c0, off);
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int w = t + j * nt;
        if (w < len) {
          Codes<VEC> o;
#pragma unroll
          for (int q = 0; q < Codes<VEC>::kWords; ++q) {
            uint32_t word = 0;
#pragma unroll
            for (int k = 0; k < Codes<VEC>::kPerWord; ++k) {
              const uint32_t idx = ((in[j].w[q] >> (8 * k)) & 0xFFu) |
                                   off[Codes<VEC>::kPerWord * q + k];
              word |= (uint32_t)(uint8_t)table[idx] << (8 * k);
            }
            o.w[q] = word;
          }
          store_codes<VEC>(out + (r * nvr + start + w) * VEC, o);
        }
      }
    }
  }
}

template <int VEC>
cudaError_t launch(const void* x, const void* mask, const void* x_scale,
                   const void* mul_scale, const void* mul_zp, int zp_float,
                   int a_lo, int a_hi, float multiplier, void* out,
                   void* out_scale, long long batch, int samples, int shared,
                   long long nvr, int vpp, int threads, int chunk_len,
                   int chunks, int items, int blocks, cudaStream_t stream) {
  dropout_site_kernel<VEC><<<blocks, threads, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const float*>(mask),
      static_cast<const float*>(x_scale), static_cast<const float*>(mul_scale),
      mul_zp, zp_float, a_lo, a_hi, multiplier, static_cast<int8_t*>(out),
      static_cast<float*>(out_scale), batch, samples, shared, nvr, vpp,
      chunk_len, chunks, items);
  return cudaGetLastError();
}

}  // namespace

// One launch; returns a cudaError_t (0: launched). The plan's fields as
// ops/dropout_site.py SitePlan gives them.
extern "C" int qbn_dropout_site(const void* x, const void* mask,
                                const void* x_scale, const void* mul_scale,
                                const void* mul_zp, int zp_float, int a_lo,
                                int a_hi, float multiplier, void* out,
                                void* out_scale, long long batch, int samples,
                                int shared, long long nvr, int vec, int vpp,
                                int threads, int chunk_len, int chunks,
                                int items, int blocks, void* stream) {
  if (threads <= 0 || threads > kMaxThreads || threads % vpp != 0 ||
      chunk_len % vpp != 0 || chunk_len > kItems * threads || blocks <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (vec) {
#define QBN_SITE_CASE(V)                                                     \
  case V:                                                                    \
    return (int)launch<V>(x, mask, x_scale, mul_scale, mul_zp, zp_float,     \
                          a_lo, a_hi, multiplier, out, out_scale, batch,     \
                          samples, shared, nvr, vpp, threads, chunk_len,     \
                          chunks, items, blocks, st);
    QBN_SITE_CASE(16)
    QBN_SITE_CASE(8)
    QBN_SITE_CASE(4)
    QBN_SITE_CASE(2)
    QBN_SITE_CASE(1)
#undef QBN_SITE_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
