// Int8 implicit-GEMM convolution of INT8 Monte-Carlo evaluation, with
// qbn_tpu's requantisation epilogue, for Hopper.
//
// Replaces the Pallas kernels of qbn_tpu/ops/pallas/conv_gemm.py
// (mc_conv_packed_s2d / mc_group_conv -> _kernel) and
// qbn_tpu/ops/pallas/bconv.py (bconv -> _bconv_kernel), and computes the
// function of qbn_tpu/ops/integer.py int_conv_merged: for every posterior
// sample s, a conv of zero-point-removed int8 activation codes u with the
// sample's int8 weight codes w, then
//   acc    = sum u * w (int32, exact: |acc| <= K * 128 * 128 < 2^31)
//   winsum = sum u over the window (the weight zero point's correction)
//   K <= 520: y = f32(acc - zw * winsum)                   (exact, int32)
//   K >  520: y = f32(acc) - zw * f32(winsum)              (float32)
//   y = y * (x_scale * w_scale) + bias[n]
//   q = rint(y / out_scale) + out_zp, clip to 0..255, max(q, out_zp) if
//       relu, clip to a_lo..a_hi, code = q - out_zp (int8)
// in exactly that order, written with __fmul_rn/__fadd_rn/__fsub_rn/
// __fdiv_rn so that nvcc contracts nothing into a fused multiply-add: the
// codes are bitwise those of the plain PyTorch version (and of qbn_tpu).
// Above K = 1040 |acc| can pass 2^24, where f32(acc) - zw * f32(winsum)
// and the exact integer difference give other bits, so the two branches
// are kept apart as qbn_tpu keeps them. The optional residual epilogue
// (bconv's contract: a stage's convs chain in this layout, and the
// quantised residual add may run inside the conv) requantises
//   out * out_scale + res * res_scale to res_out_scale / res_out_zp.
//
// Layout. Activations are addressed through element strides of
// (batch, row, column, sample) with channels contiguous: the merged layout
// (B, H, W, S*C) of the MC forward and the per-sample layout (S, B, H, W, C)
// of K3's entry are the same kernel with other strides, and a sample
// stride of 0 is the shared-x stem (one image, S weight samples). Weights
// are (S, kh, kw, cin, cout) int8 as the draw kernel writes them. Taps
// outside the image read code 0, the activation zero point, which adds
// nothing to the sum or the window sum. Offsets are 64-bit.
//
// Design. One CTA of 256 threads (8 warps) computes 128 output pixels x
// up to 96 output channels of one sample; consecutive CTAs take
// consecutive samples, so the CTAs in flight read and write whole runs of
// the merged layout's S*C bytes per pixel. Per step of K = 32 it gathers
// the im2col tile of the activations (4-byte loads where cin is a multiple
// of 4) and the weight tile, transposed to [n][k], into shared memory
// (48-byte rows: the fragment loads hit 32 distinct banks), and each warp
// runs mma.sync m16n8k32 s8 x s8 -> s32 on its 16 rows. K is zero-padded
// to a multiple of 32 in shared memory. The window sum is the A tile's row
// sum (__dp4a with 0x01010101), taken in the same pass. The epilogue runs
// in registers, stages the int8 codes in shared memory, and the CTA writes
// them (and reads the residual) in 4-byte words along each pixel's run.
//
// What bounds it on an H100: the bytes. The 20 convs of the flagship
// ResNet-18 at B = 256, S = 100 do 2.01 T int8 multiply-adds (4.02 T
// operations, 2.03 ms at 1,979 TOPS) and move 12.43 GB (activations read
// once, codes written once, weights; 3.71 ms at 3.35 TB/s). This first
// kernel is single-buffered (no cp.async ring, no wgmma, no TMA), so it
// waits on every tile load; those are a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;        // output pixels per CTA
constexpr int kBK = 32;         // contraction step: one m16n8k32
constexpr int kThreads = 256;   // 8 warps x 16 rows
constexpr int kRow = 48;        // shared-memory row stride, bytes
constexpr int kCenteredK = 520;

}  // namespace

// The launch's arguments, every field 64 bits wide so that the ctypes
// Structure of ops/int_conv.py has the same layout.
struct QbnConvArgs {
  const int8_t* x;
  long long x_sb, x_sh, x_sw, x_ss;   // element strides of (b, h, w, s)
  long long B, H, W, cin;
  const int8_t* w;                    // (S, kh, kw, cin, cout)
  long long S, kh, kw, cout, stride, pad, Ho, Wo;
  int8_t* out;
  long long o_sb, o_sh, o_sw, o_ss;   // element strides of (b, ho, wo, s)
  const int8_t* res;                  // residual codes, out's layout, or null
  const float* bias;                  // (cout,) or null
  const float* x_scale;
  const float* w_scale;
  const int* w_zp;
  const float* out_scale;
  const int* out_zp;
  const float* res_scale;
  const float* res_out_scale;
  const int* res_out_zp;
  long long relu, res_relu, a_lo, a_hi;
  int* raw_acc;   // debug: (B, Ho, Wo, S, cout) int32 sums, no epilogue
  int* raw_win;   // debug: (B, Ho, Wo, S) int32 window sums
  long long vec_x, vec_out;           // 4-byte loads / stores allowed
};

namespace {

__device__ __forceinline__ float requant(float y, float out_scale, float zp,
                                         bool relu, float lo, float hi) {
  float q = __fadd_rn(rintf(__fdiv_rn(y, out_scale)), zp);
  q = fminf(fmaxf(q, 0.0f), 255.0f);
  if (relu) q = fmaxf(q, zp);
  q = fminf(fmaxf(q, lo), hi);
  return __fsub_rn(q, zp);
}

__device__ __forceinline__ void mma_s8(int* c, uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <int NT>
__global__ void __launch_bounds__(kThreads)
int_conv_kernel(const QbnConvArgs a) {
  constexpr int BN = 8 * NT;
  __shared__ __align__(16) int8_t As[kBM * kRow];   // [m][k]
  __shared__ __align__(16) int8_t Bs[BN * kRow];    // [n][k]
  __shared__ __align__(16) int8_t Os[kBM * BN];     // output codes [m][n]
  __shared__ int rowsum[kBM];
  __shared__ long long out_off[kBM];                // -1: past M

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = blockIdx.x;
  const long long m0 = (long long)blockIdx.y * kBM;
  const int n0 = blockIdx.z * BN;
  const int H = (int)a.H, W = (int)a.W, cin = (int)a.cin, kw = (int)a.kw;
  const int cout = (int)a.cout, S = (int)a.S;
  const int Ho = (int)a.Ho, Wo = (int)a.Wo, st = (int)a.stride;
  const int pad = (int)a.pad;
  const int K = (int)(a.kh * a.kw * a.cin);
  const long long M = a.B * a.Ho * a.Wo;
  const long long hw_o = (long long)Ho * Wo;

  if (tid < kBM) {
    const long long m = m0 + tid;
    long long off = -1;
    if (m < M) {
      const long long b = m / hw_o;
      const int rem = (int)(m - b * hw_o);
      const int ho = rem / Wo, wo = rem - (rem / Wo) * Wo;
      off = b * a.o_sb + ho * a.o_sh + wo * a.o_sw + s * a.o_ss;
    }
    out_off[tid] = off;
  }

  // The rows this thread gathers: four rows, one 4-byte column quad each,
  // on the vector path; one row, 16 bytes of it, on the byte path.
  const bool vec = a.vec_x != 0;
  const int n_rows = vec ? 4 : 1;
  int row_r[4], row_h[4], row_w[4];
  bool row_ok[4];
  long long row_base[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = vec ? (tid >> 3) + 32 * i : (tid >> 1);
    const long long m = m0 + r;
    row_r[i] = r;
    row_ok[i] = (i < n_rows) && m < M;
    row_h[i] = row_w[i] = 0;
    row_base[i] = 0;
    if (row_ok[i]) {
      const long long b = m / hw_o;
      const int rem = (int)(m - b * hw_o);
      const int ho = rem / Wo, wo = rem - (rem / Wo) * Wo;
      row_h[i] = ho * st - pad;
      row_w[i] = wo * st - pad;
      row_base[i] = b * a.x_sb + s * a.x_ss;
    }
  }

  int acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
  int rsum = 0;

  const int8_t* wsam = a.w + (long long)s * K * cout;
  const int g = lane >> 2, t = lane & 3;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    // A: the im2col tile
    if (vec) {
      const int kq = tid & 7;
      const int k = k0 + kq * 4;
      int ci = 0, dh = 0, dw = 0;
      const bool kin = k < K;
      if (kin) {
        const int tap = k / cin;
        ci = k - tap * cin;
        dh = tap / kw;
        dw = tap - dh * kw;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int v = 0;
        const int hi = row_h[i] + dh, wi = row_w[i] + dw;
        if (kin && row_ok[i] && hi >= 0 && hi < H && wi >= 0 && wi < W)
          v = __ldg(reinterpret_cast<const int*>(
              a.x + row_base[i] + hi * a.x_sh + wi * a.x_sw + ci));
        *reinterpret_cast<int*>(As + row_r[i] * kRow + kq * 4) = v;
      }
    } else {
      const int kk0 = (tid & 1) * 16;
      int k = k0 + kk0;
      int ci = 0, dh = 0, dw = 0;
      if (k < K) {
        const int tap = k / cin;
        ci = k - tap * cin;
        dh = tap / kw;
        dw = tap - dh * kw;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t word = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hi = row_h[0] + dh, wi = row_w[0] + dw;
          if (k < K && row_ok[0] && hi >= 0 && hi < H && wi >= 0 && wi < W)
            word |= (uint32_t)(uint8_t)a.x[row_base[0] + hi * a.x_sh +
                                           wi * a.x_sw + ci] << (8 * e);
          ++k;
          if (++ci == cin) {
            ci = 0;
            if (++dw == kw) {
              dw = 0;
              ++dh;
            }
          }
        }
        *reinterpret_cast<uint32_t*>(As + row_r[0] * kRow + kk0 + 4 * q) =
            word;
      }
    }
    // B: the weight tile, transposed to [n][k]
    for (int idx = tid; idx < BN * (kBK / 4); idx += kThreads) {
      const int n = idx % BN, q = idx / BN;
      const int kb = k0 + 4 * q, nn = n0 + n;
      uint32_t word = 0;
      if (nn < cout) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kb + e < K)
            word |= (uint32_t)(uint8_t)__ldg(
                        wsam + (long long)(kb + e) * cout + nn) << (8 * e);
      }
      *reinterpret_cast<uint32_t*>(Bs + n * kRow + 4 * q) = word;
    }
    __syncthreads();

    {  // the window sum: two threads per row, 16 bytes each
      const int* p = reinterpret_cast<const int*>(As + (tid >> 1) * kRow +
                                                  (tid & 1) * 16);
      rsum = __dp4a(p[0], 0x01010101, rsum);
      rsum = __dp4a(p[1], 0x01010101, rsum);
      rsum = __dp4a(p[2], 0x01010101, rsum);
      rsum = __dp4a(p[3], 0x01010101, rsum);
    }
    const int8_t* ar0 = As + (warp * 16 + g) * kRow + 4 * t;
    const int8_t* ar1 = ar0 + 8 * kRow;
    const uint32_t a0 = *reinterpret_cast<const uint32_t*>(ar0);
    const uint32_t a1 = *reinterpret_cast<const uint32_t*>(ar1);
    const uint32_t a2 = *reinterpret_cast<const uint32_t*>(ar0 + 16);
    const uint32_t a3 = *reinterpret_cast<const uint32_t*>(ar1 + 16);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int8_t* bc = Bs + (j * 8 + g) * kRow + 4 * t;
      mma_s8(acc[j], a0, a1, a2, a3, *reinterpret_cast<const uint32_t*>(bc),
             *reinterpret_cast<const uint32_t*>(bc + 16));
    }
    __syncthreads();
  }

  rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
  if ((tid & 1) == 0) rowsum[tid >> 1] = rsum;
  __syncthreads();

  if (a.raw_acc != nullptr) {   // debug entry: the raw sums
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = warp * 16 + g + 8 * (e >> 1);
        const int n = n0 + j * 8 + 2 * t + (e & 1);
        const long long m = m0 + r;
        if (m < M && n < cout) {
          a.raw_acc[(m * S + s) * cout + n] = acc[j][e];
          if (n == 0) a.raw_win[m * S + s] = rowsum[r];
        }
      }
    }
    return;
  }

  const float scale = __fmul_rn(*a.x_scale, *a.w_scale);
  const int zw = *a.w_zp;
  const float zw_f = (float)zw;
  const float out_scale = *a.out_scale;
  const float zp = (float)*a.out_zp;
  const float lo = (float)a.a_lo, hi = (float)a.a_hi;
  const bool relu = a.relu != 0, centered = K <= kCenteredK;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = warp * 16 + g + 8 * (e >> 1);
      const int nl = j * 8 + 2 * t + (e & 1);
      const int n = n0 + nl;
      const int ws = rowsum[r];
      float y = centered
          ? __int2float_rn(acc[j][e] - zw * ws)
          : __fsub_rn(__int2float_rn(acc[j][e]),
                      __fmul_rn(zw_f, __int2float_rn(ws)));
      y = __fmul_rn(y, scale);
      if (a.bias != nullptr && n < cout) y = __fadd_rn(y, __ldg(a.bias + n));
      Os[r * BN + nl] = (int8_t)(int)requant(y, out_scale, zp, relu, lo, hi);
    }
  }
  __syncthreads();

  const bool has_res = a.res != nullptr;
  float o_scale = 0.f, r_scale = 0.f, ro_scale = 1.f, ro_zp = 0.f;
  if (has_res) {
    o_scale = out_scale;
    r_scale = *a.res_scale;
    ro_scale = *a.res_out_scale;
    ro_zp = (float)*a.res_out_zp;
  }
  const bool res_relu = a.res_relu != 0;
  const int ncols = min(BN, cout - n0);
  if (a.vec_out) {   // ncols % 4 == 0, 4-byte aligned runs
    const int wpr = ncols >> 2;
    for (int idx = tid; idx < kBM * wpr; idx += kThreads) {
      const int r = idx / wpr, q = idx - (idx / wpr) * wpr;
      const long long off = out_off[r];
      if (off < 0) continue;
      uint32_t v = *reinterpret_cast<const uint32_t*>(Os + r * BN + 4 * q);
      const long long o = off + n0 + 4 * q;
      if (has_res) {
        const uint32_t rv = __ldg(reinterpret_cast<const unsigned int*>(
            a.res + o));
        uint32_t nv = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float y = __fadd_rn(
              __fmul_rn((float)(int8_t)(v >> (8 * e)), o_scale),
              __fmul_rn((float)(int8_t)(rv >> (8 * e)), r_scale));
          const int8_t c =
              (int8_t)(int)requant(y, ro_scale, ro_zp, res_relu, lo, hi);
          nv |= (uint32_t)(uint8_t)c << (8 * e);
        }
        v = nv;
      }
      *reinterpret_cast<uint32_t*>(a.out + o) = v;
    }
  } else {
    for (int idx = tid; idx < kBM * ncols; idx += kThreads) {
      const int r = idx / ncols, nl = idx - (idx / ncols) * ncols;
      const long long off = out_off[r];
      if (off < 0) continue;
      const long long o = off + n0 + nl;
      int8_t c = Os[r * BN + nl];
      if (has_res) {
        const float y = __fadd_rn(__fmul_rn((float)c, o_scale),
                                  __fmul_rn((float)a.res[o], r_scale));
        c = (int8_t)(int)requant(y, ro_scale, ro_zp, res_relu, lo, hi);
      }
      a.out[o] = c;
    }
  }
}

template <int NT>
int launch(const QbnConvArgs& a, long long m_tiles, cudaStream_t stream) {
  constexpr int BN = 8 * NT;
  const long long n_tiles = (a.cout + BN - 1) / BN;
  if (m_tiles > 65535 || n_tiles > 65535 || a.S > 2147483647LL)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)a.S, (unsigned)m_tiles, (unsigned)n_tiles);
  int_conv_kernel<NT><<<grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int qbn_int_conv(const QbnConvArgs* a, void* stream) {
  const long long M = a->B * a->Ho * a->Wo;
  if (M <= 0 || a->S <= 0 || a->cout <= 0) return 0;
  const long long m_tiles = (M + kBM - 1) / kBM;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long nt = (a->cout + 7) / 8;
  if (nt <= 1) return launch<1>(*a, m_tiles, st);
  if (nt <= 3) return launch<3>(*a, m_tiles, st);
  if (nt <= 6) return launch<6>(*a, m_tiles, st);
  return launch<12>(*a, m_tiles, st);
}

// Bytes of QbnConvArgs, so that the caller can check its own layout.
extern "C" int qbn_int_conv_args_size() { return (int)sizeof(QbnConvArgs); }
