// Posterior weight draw of converted Bayes-by-backprop layers, for Hopper.
//
// Replaces the Pallas kernels of qbn_tpu/ops/pallas/sample_weights.py:
// sample_weights_int8 (_kernel_prng_pair, _kernel_prng, _kernel_noise) and
// draw_all_layers (_kernel_rows_prng, _kernel_rows_noise). One launch draws
// S int8 samples of every layer of a pack: for each element
//   eps_q = clip(round(eps * 127/3), -128, 127)
//   prod  = clip(round(std_f * (eps_q * 3/127) * (1/mul_scale)) + mul_zp)
//   ws    = clip(round((w_f + (prod - mul_zp) * mul_scale) * (1/add_scale))
//                + add_zp), then clip to [w_lo, w_hi]
// with w_f = (w - w_zp) * w_scale and std_f = (std - std_zp) * std_scale,
// in that order of operations (qbn_tpu's _body_parts/_body_from and
// sample_weights_oracle). eps is qbn_tpu's default seeded normal, the
// inverse-CDF transform (_fast_ndtri) of the top 23 bits of a Philox-4x32-10
// word, or is read from explicit noise.
//
// Bitwise. The chain is written with __fmul_rn/__fadd_rn/__fsub_rn so that
// nvcc cannot contract it into fused multiply-adds. Round half to even is
// (x + 1.5 * 2^23) - 1.5 * 2^23, equal to rintf for |x| <= 2^22; a larger
// |x| is clipped to the same int8 bound either way. Given the same noise,
// or the same seed and offset, the codes are bitwise those of the plain
// PyTorch version (ops/sample_weights.py).
//
// eps_q without float work. eps_q of the inverse-CDF normal is a step
// function of the 23-bit uniform k, monotone (checked over all 2^23 k when
// the table is built), with at most one step in any 512 consecutive k. A
// table that the wrapper builds on the card from the plain transform
// (ops/sample_weights.py icdf_table), one 32-bit entry per bucket of 512 k
// (64 KB, in shared memory), gives
//   c = (entry & 255) + (k % 512 >= entry >> 8),   eps_q = 127 - c,
// so the kernel runs neither polynomial.
//
// Counters. Element e of layer l's (S, n) output block takes lane e % 4 of
// the Philox call with counter (e / 4, l, offset low, offset high) and key
// (seed low, seed high): any thread layout draws the same bits, and so does
// the plain version.
//
// Layout. Layer l's samples fill one contiguous (S, n) block of the output
// that starts at a multiple of 16 elements; its codes start at a multiple
// of 16 bytes of w / std. The work is cut in tiles of 256 items, each of
// one layer (tile_layer), and the CTAs walk over tiles (grid-stride, a few
// CTAs per SM, so each loads the 64 KB table once). Where n % 16 == 0 an
// item is 16 elements of one layer (two 16-byte loads of the mean and std
// codes, dequantised once) over 4 samples (four 16-byte stores); otherwise
// it is 16 consecutive outputs of the block, which may run across a sample
// boundary (byte loads).
//
// What bounds it on an H100: the instructions. A Philox call gives 4 codes
// in 10 rounds, each two 32 x 32 -> 64-bit products (one IMAD.WIDE.U32
// each, a high and a low result) and two three-input XORs (one LOP3 each);
// the key schedule runs on the uniform datapath. So per code 15 results on
// the 64 int32 lanes of an SM (a product counted as two), and the quantise
// chain from eps_q (about 17 float32 operations) on the 128 float32 lanes;
// the output is 1 byte per code (157.2 MB at the flagship's S = 100, 47 us
// at 3.35 TB/s). chip_smoke.py prints the kernel's Philox instructions
// from its SASS and states the bound it computes from these counts.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kVec = 16;         // outputs per 16-byte store
constexpr int kThreads = 256;    // items per tile (sample_weights.py _TILE)
constexpr int kSampleGroup = 4;  // samples per item (_SAMPLES_PER_ITEM)
constexpr int kMinBlocks = 3;    // CTAs per SM: 3 x 64 KB of tables
constexpr int kQ = 8;            // qparams per layer, see QIdx
constexpr int kMeta = 8;         // int64 meta per layer, see MetaIdx
constexpr int kTableEntries = 1 << 14;   // one per 512 uniforms
constexpr int kTableBytes = 4 * kTableEntries;

// float32(1 / (3/127)) and float32(3/127), exactly as qbn_tpu's f32
// arithmetic sees the Python constants.
constexpr float kInvNoiseScale = 0x1.52aaaap+5f;
constexpr float kNoiseScale = 0x1.83060cp-6f;
constexpr float kRound = 12582912.0f;     // 1.5 * 2^23
constexpr float kByteBias = 8388736.0f;   // 2^23 + 128

enum QIdx { W_SCALE, W_ZP, STD_SCALE, STD_ZP, MUL_SCALE, MUL_ZP, ADD_SCALE,
            ADD_ZP };
// tile0: first tile of the layer; items: its work items; dst: first output
// element of its (S, n) block; src: first code in w/std; n: elements per
// sample; samples; lo / hi: the clip bounds max(w_lo, -128), min(w_hi, 127)
enum MetaIdx { TILE0, ITEMS, DST, SRC, N, SAMPLES, LO, HI };

__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float round_even(float x) {
  return __fsub_rn(__fadd_rn(x, kRound), kRound);
}

struct Layer {
  float w_scale, w_zp, std_scale, std_zp, mul_scale, mul_zp, inv_mul,
        add_zp, inv_add, lo, hi;
};

// The int8 of byte I of `biased` (bytes XORed with 0x80, so w + 128) as a
// float: the byte in the mantissa of 2^23, minus 2^23 + 128 (exact).
template <int I>
__device__ __forceinline__ float byte_float(uint32_t biased) {
  return __fsub_rn(
      __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7650 | I)),
      kByteBias);
}

// w_f / std_f of 4 codes in one word
__device__ __forceinline__ void dequant4(uint32_t word, float zp, float scale,
                                         float* f) {
  const uint32_t b = word ^ 0x80808080u;
  f[0] = __fmul_rn(__fsub_rn(byte_float<0>(b), zp), scale);
  f[1] = __fmul_rn(__fsub_rn(byte_float<1>(b), zp), scale);
  f[2] = __fmul_rn(__fsub_rn(byte_float<2>(b), zp), scale);
  f[3] = __fmul_rn(__fsub_rn(byte_float<3>(b), zp), scale);
}

// eps_q * 3/127 of one Philox word through the table
__device__ __forceinline__ float eps_scaled_bits(uint32_t bits,
                                                 const uint32_t* tab) {
  const uint32_t entry = tab[bits >> 18];
  const uint32_t c =
      (entry & 255u) + ((((bits >> 9) & 511u) >= (entry >> 8)) ? 1u : 0u);
  const float eps_q = __fsub_rn(__uint_as_float(0x4B0000FFu - c), kByteBias);
  return __fmul_rn(eps_q, kNoiseScale);
}

// eps_q * 3/127 of an explicit normal
__device__ __forceinline__ float eps_scaled_noise(float eps) {
  const float eps_q =
      clip(round_even(__fmul_rn(eps, kInvNoiseScale)), -128.0f, 127.0f);
  return __fmul_rn(eps_q, kNoiseScale);
}

// The code from eps_q * 3/127, as a float integer in [lo, hi]
__device__ __forceinline__ float draw_code(float eps_s, float w_f,
                                           float std_f, const Layer& q) {
  const float prod = clip(
      __fadd_rn(round_even(__fmul_rn(__fmul_rn(std_f, eps_s), q.inv_mul)),
                q.mul_zp),
      -128.0f, 127.0f);
  const float prod_f = __fmul_rn(__fsub_rn(prod, q.mul_zp), q.mul_scale);
  return clip(__fadd_rn(round_even(__fmul_rn(__fadd_rn(w_f, prod_f),
                                             q.inv_add)),
                        q.add_zp),
              q.lo, q.hi);
}

// 4 codes (float integers in [-128, 127]) packed into a word: the low byte
// of c + 1.5 * 2^23 is c as int8
__device__ __forceinline__ uint32_t pack4(float a, float b, float c,
                                          float d) {
  const uint32_t ab = __byte_perm(__float_as_uint(__fadd_rn(a, kRound)),
                                  __float_as_uint(__fadd_rn(b, kRound)),
                                  0x0040);
  const uint32_t cd = __byte_perm(__float_as_uint(__fadd_rn(c, kRound)),
                                  __float_as_uint(__fadd_rn(d, kRound)),
                                  0x0040);
  return __byte_perm(ab, cd, 0x5410);
}

// eps_q * 3/127 of the 16 outputs at element e0 (a multiple of 16) of the
// layer's block; count < 16 only at the block's end (explicit noise)
__device__ __forceinline__ void eps16(float* eps, long long e0, int count,
                                      const float* noise, const uint32_t* tab,
                                      uint32_t layer, uint2 key,
                                      uint32_t off_lo, uint32_t off_hi) {
  if (noise != nullptr) {
    if (count == kVec) {
      const float4* src = reinterpret_cast<const float4*>(noise + e0);
#pragma unroll
      for (int k = 0; k < kVec / 4; ++k) {
        const float4 v = __ldg(src + k);
        eps[4 * k] = eps_scaled_noise(v.x);
        eps[4 * k + 1] = eps_scaled_noise(v.y);
        eps[4 * k + 2] = eps_scaled_noise(v.z);
        eps[4 * k + 3] = eps_scaled_noise(v.w);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k)   // static indices: registers
        eps[k] = k < count ? eps_scaled_noise(__ldg(noise + e0 + k)) : 0.0f;
    }
    return;
  }
  const uint32_t call = (uint32_t)(e0 >> 2);
#pragma unroll
  for (int k = 0; k < kVec / 4; ++k) {
    const uint4 r = qbn::philox4x32_10(
        make_uint4(call + k, layer, off_lo, off_hi), key);
    eps[4 * k] = eps_scaled_bits(r.x, tab);
    eps[4 * k + 1] = eps_scaled_bits(r.y, tab);
    eps[4 * k + 2] = eps_scaled_bits(r.z, tab);
    eps[4 * k + 3] = eps_scaled_bits(r.w, tab);
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
draw_kernel(const int8_t* __restrict__ w, const int8_t* __restrict__ std_codes,
            const float* __restrict__ qtab, const long long* __restrict__ meta,
            const int* __restrict__ tile_layer, int tiles,
            const float* __restrict__ noise,
            const uint32_t* __restrict__ table, uint2 key, uint32_t off_lo,
            uint32_t off_hi, int8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t tab[];
  if (noise == nullptr) {
    for (int i = threadIdx.x; i < kTableEntries / 4; i += kThreads)
      reinterpret_cast<uint4*>(tab)[i] =
          __ldg(reinterpret_cast<const uint4*>(table) + i);
    __syncthreads();
  }

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    // the tile's layer, the same for every thread of the CTA
    const int l = __ldg(tile_layer + tile);
    const long long* m = meta + l * kMeta;
    const long long item =
        (long long)(tile - __ldg(m + TILE0)) * kThreads + threadIdx.x;
    if (item >= __ldg(m + ITEMS)) continue;
    const float* qp = qtab + l * kQ;
    Layer q;
    q.w_scale = __ldg(qp + W_SCALE);
    q.w_zp = __ldg(qp + W_ZP);
    q.std_scale = __ldg(qp + STD_SCALE);
    q.std_zp = __ldg(qp + STD_ZP);
    q.mul_scale = __ldg(qp + MUL_SCALE);
    q.mul_zp = __ldg(qp + MUL_ZP);
    q.inv_mul = __fdiv_rn(1.0f, q.mul_scale);
    q.add_zp = __ldg(qp + ADD_ZP);
    q.inv_add = __fdiv_rn(1.0f, __ldg(qp + ADD_SCALE));
    q.lo = (float)__ldg(m + LO);
    q.hi = (float)__ldg(m + HI);
    const long long n = __ldg(m + N);
    const long long block = __ldg(m + SAMPLES) * n;
    const int8_t* wl = w + __ldg(m + SRC);
    const int8_t* sl = std_codes + __ldg(m + SRC);
    int8_t* ol = out + __ldg(m + DST);
    const float* nl = noise != nullptr ? noise + __ldg(m + DST) : nullptr;
    float eps[kVec];

    if (n % kVec == 0) {
      // 16 elements j..j+15 of the samples s0..s0+3: mean and std codes
      // loaded and dequantised once
      const long long groups = n / kVec;
      const long long sg = item / groups;
      const long long j = kVec * (item - sg * groups);
      const uint4 wv = __ldg(reinterpret_cast<const uint4*>(wl + j));
      const uint4 sv = __ldg(reinterpret_cast<const uint4*>(sl + j));
      float w_f[kVec], std_f[kVec];
      dequant4(wv.x, q.w_zp, q.w_scale, w_f);
      dequant4(wv.y, q.w_zp, q.w_scale, w_f + 4);
      dequant4(wv.z, q.w_zp, q.w_scale, w_f + 8);
      dequant4(wv.w, q.w_zp, q.w_scale, w_f + 12);
      dequant4(sv.x, q.std_zp, q.std_scale, std_f);
      dequant4(sv.y, q.std_zp, q.std_scale, std_f + 4);
      dequant4(sv.z, q.std_zp, q.std_scale, std_f + 8);
      dequant4(sv.w, q.std_zp, q.std_scale, std_f + 12);
      const long long s_end =
          min((long long)__ldg(m + SAMPLES), (sg + 1) * kSampleGroup);
      for (long long s = sg * kSampleGroup; s < s_end; ++s) {
        const long long e0 = s * n + j;
        eps16(eps, e0, kVec, nl, tab, (uint32_t)l, key, off_lo, off_hi);
        uint32_t words[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          words[k] = pack4(draw_code(eps[4 * k], w_f[4 * k], std_f[4 * k], q),
                           draw_code(eps[4 * k + 1], w_f[4 * k + 1],
                                     std_f[4 * k + 1], q),
                           draw_code(eps[4 * k + 2], w_f[4 * k + 2],
                                     std_f[4 * k + 2], q),
                           draw_code(eps[4 * k + 3], w_f[4 * k + 3],
                                     std_f[4 * k + 3], q));
        *reinterpret_cast<uint4*>(ol + e0) =
            make_uint4(words[0], words[1], words[2], words[3]);
      }
    } else {
      // 16 consecutive outputs of the block, across sample boundaries
      const long long e0 = kVec * item;
      const int count = (int)min((long long)kVec, block - e0);
      eps16(eps, e0, count, nl, tab, (uint32_t)l, key, off_lo, off_hi);
      long long i = e0 % n;
      uint32_t words[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        if (k < count) {
          const float w_f = __fmul_rn(__fsub_rn((float)wl[i], q.w_zp),
                                      q.w_scale);
          const float std_f = __fmul_rn(__fsub_rn((float)sl[i], q.std_zp),
                                        q.std_scale);
          const uint32_t c = __float_as_uint(
              __fadd_rn(draw_code(eps[k], w_f, std_f, q), kRound)) & 255u;
          words[k / 4] |= c << (8 * (k % 4));
          if (++i == n) i = 0;
        }
      }
      if (count == kVec) {
        *reinterpret_cast<uint4*>(ol + e0) =
            make_uint4(words[0], words[1], words[2], words[3]);
      } else {
#pragma unroll
        for (int k = 0; k < kVec; ++k)
          if (k < count) ol[e0 + k] = (int8_t)(words[k / 4] >> (8 * (k % 4)));
      }
    }
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// noise == nullptr draws the seeded normals (Philox keyed by seed and
// offset, eps_q through `table`, kTableEntries int32 in device memory).
extern "C" int qbn_draw_int8(const void* w, const void* std_codes,
                             const void* qtab, const void* meta,
                             const void* tile_layer, int tiles,
                             const void* noise, const void* table,
                             unsigned long long seed,
                             unsigned long long offset, void* out,
                             void* stream) {
  if (tiles <= 0) return 0;
  if (noise == nullptr && table == nullptr)
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      draw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTableBytes);
  if (attr != cudaSuccess) return (int)attr;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int blocks = tiles < kMinBlocks * sms ? tiles : kMinBlocks * sms;
  const size_t smem = noise == nullptr ? kTableBytes : 0;
  draw_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(w), static_cast<const int8_t*>(std_codes),
      static_cast<const float*>(qtab), static_cast<const long long*>(meta),
      static_cast<const int*>(tile_layer), tiles,
      static_cast<const float*>(noise), static_cast<const uint32_t*>(table),
      make_uint2((uint32_t)seed, (uint32_t)(seed >> 32)), (uint32_t)offset,
      (uint32_t)(offset >> 32), static_cast<int8_t*>(out));
  return (int)cudaGetLastError();
}
