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
// are (S, kh, kw, cin, cout) int8 as the draw kernel writes them, at a
// sample stride w_ss = K * cout; a weight sample stride of 0 is the mirror
// case, one set of weights for every sample (qbn_tpu's int_conv under its
// vmap rule for per-sample x and shared w: MC-Dropout's masked
// activations, pointwise, an ensemble member), which the samples keep on
// the sample axis instead of folding S * B images into the pixel tiles.
// The pixel body then transposes the one weight slice once per CTA. Taps
// outside the image read code 0, the activation zero point, which adds
// nothing to the sum or the window sum. Offsets are 64-bit.
//
// Four bodies, chosen by shape in ops/int_conv.py (plan_conv), never on
// failure; all compute each code with the same epilogue (epi_code and
// res_code below).
//
// "im2col" (any shape the other three do not take). One CTA of 256 threads
// (8 warps) computes 128 output pixels x up to 96 output channels of one
// sample; consecutive CTAs take consecutive
// samples, so the CTAs in flight read and write whole runs of the merged
// layout's S*C bytes per pixel. Per step of K = 32 it gathers the im2col
// tile of the activations (4-byte loads where cin is a multiple of 4) and
// the weight tile, transposed to [n][k], into shared memory (48-byte rows:
// the fragment loads hit 32 distinct banks), and each warp runs mma.sync
// m16n8k32 s8 x s8 -> s32 on its 16 rows. K is zero-padded to a multiple
// of 32 in shared memory. The window sum is the A tile's row sum (__dp4a
// with 0x01010101), taken in the same pass. This body waits on every
// tile's loads between two barriers.
//
// "halo" (the 3x3 convs with cin % 4 == 0: the 16 block convs of the
// flagship). A CTA owns one sample, bm = 128 or 256 consecutive output
// pixels (output rows of one image, or whole images at the 8x8 and 4x4
// stages) and bn = 8 * NT output channels. It copies the input rows and
// columns those pixels read, with a one-pixel halo, into shared memory
// once, by cp.async (8 bytes where a sample's run starts only 8-byte
// aligned, as at cin = 24; 16 from cin = 48 on; taps outside the image
// zero-filled by the copy's src-size 0: code 0 is the zero point and adds
// nothing). Each input byte is then read from global memory once per CTA,
// not once per tap. The A fragments of m16n8k32 are read straight from
// that tile: the word of pixel r at contraction index k is at
// pixoff[r] + koff[k / 4], two tables from the plan (4 consecutive k never
// cross a tap when cin % 4 == 0), so the K loop does no index arithmetic;
// the pixel pitch is padded so that a warp's fragment loads spread over
// the banks, and the next k step's fragments are loaded while this step's
// products run. The CTA's weight slice [K][bn] arrives by 16-byte
// cp.async (one contiguous run when bn == cout, else a run of bn bytes per
// k row): all of it in one chunk where it is small (up to 24 KB: the
// stage-0 and stage-1 convs), else in chunks of 128 k rows through a
// double-buffered ring, chunk c+1 in flight while chunk c is transposed
// once to [n][k] (8-bit elements have no ldmatrix transpose) and
// multiplied. The 8 warps are 8 x 1 (two m16 tiles and all NT n8 tiles
// each: 256 pixels) at NT = 3 and 6, and 4 x 2 (two m16 tiles, six n8
// tiles: 128 pixels) at NT = 12.
//
// "pixel" (the shared-input stem, K = 27, and the 1x1/2 shortcuts). One
// sample per CTA, as the other bodies run, makes 100 CTAs gather the same
// stem tile and write 24- to 96-byte pieces of each pixel's run of
// S * cout bytes. Here a CTA owns 128 output pixels and up to 96 channels
// and walks over its samples in groups (the sample range is split over
// CTAs only where the pixel tiles alone leave SMs idle). The stem's im2col
// tile, its A fragments and window sums are taken once for all samples; a
// 1x1 conv's input codes of a group (cin bytes per sample, consecutive in
// the merged layout) are copied once by cp.async. The group's weights are
// read in 4-byte words and transposed into shared memory, zero past K;
// each sample's codes go to a staging buffer, and the CTA writes every
// pixel's run of the group in 8- or 16-byte pieces.
//
// "wide" (the 1x1 and 3x3 convs at stride 1 or 2 with cin % 16 == 0 and
// cout % 64 == 0 that the halo and pixel bodies decline: the 52 non-stem
// convs of the ResNet-50, 64 to 2048 channels). A pipelined implicit GEMM
// of one sample's conv on wgmma: a CTA owns 128 output pixels x 128
// channels (64 where cout is 64); K streams through a ring of 3 or 4
// stages of 128 bytes in shared memory by 16-byte cp.async, stage kt + R - 1
// in flight while stage kt is multiplied; the weights reach it as K-major
// rows, transposed once a call by int_conv_kernel_wide_wt (the draw's
// layout is kept). It replaces no TPU kernel beyond conv_gemm.py's
// _kernel (the Pallas kernel ran every conv shape); it exists because the
// halo body's tiles of whole output rows cannot take widths of 56, 28, 14
// or 7, and the pixel body's whole-K weight slices cannot take K past
// about 256. What bounds it: by the shapes, the bytes (the ResNet-50's 52
// convs read and write about 39 ms of them a B = 256, S = 20 batch, against
// 20 ms of int8 products at the card's peak); as measured on the H100, the
// epilogue's instructions (about 50 a code over 52.8 G codes, and the
// residual's over 28.2 G more) set its pace, then the 3x3 convs' gathers
// of each input byte from L2 once per tap. The ring keeps the loads in
// flight while the tensor cores work, the channel tiles of a pixel tile run
// together so its activations come from device memory once, the samples
// run in groups whose weight slices stay in L2, and two CTAs an SM run one's
// loads and products under the other's epilogue.
//
// What bounds it on an H100: the bytes. The 20 convs of the flagship
// ResNet-18 at B = 256, S = 100 do 2.01 T int8 multiply-adds (4.02 T
// operations, 2.03 ms at 1,979 TOPS) and must move 11.60 GB (the input
// rows and columns each conv reads, once; codes written once; weights;
// 3.46 ms at 3.35 TB/s); the 16 3x3 convs 3.39 ms of it. The halo body
// reads each input byte once per CTA; what it re-reads is the halo rows
// and the weight slice per pixel tile, from L2. What holds it back is not
// the loads of its K loop: its mma.sync products (wgmma is a later
// change), the requantisation epilogue's instructions (an IEEE division
// per code, kept for bitwise codes) and, at stage 0, the 24-byte sample
// runs of the merged layout (PERF.md). The stem writes 629 M codes a
// batch: on the pixel body the epilogue's instructions, about 35 a code,
// set its pace, not its 0.19 ms of bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;        // output pixels per CTA (im2col body)
constexpr int kBK = 32;         // contraction step: one m16n8k32
constexpr int kThreads = 256;   // 8 warps
constexpr int kRow = 48;        // shared-memory row stride, bytes
constexpr int kCenteredK = 520;

}  // namespace

// The launch's arguments, every field 64 bits wide so that the ctypes
// Structure of ops/int_conv.py has the same layout.
struct QbnConvArgs {
  const int8_t* x;
  long long x_sb, x_sh, x_sw, x_ss;   // element strides of (b, h, w, s)
  long long B, H, W, cin;
  const int8_t* w;                    // (S, kh, kw, cin, cout) or shared
  long long w_ss;                     // weight sample stride: K*cout, or 0
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
  // the halo body's plan (ops/int_conv.py ConvPlan)
  const int* koff;                    // (ceil(K / 32) * 8,) byte offsets
  const int* pixoff;                  // (bm,) byte offsets
  long long halo, bm, nt, mt, wn, n_img, rows, h_in, w_in, pitch, vx, kc;
  long long ring;
  long long smem;
  // the pixel body: samples per group and per CTA, output store width
  // (also the wide body's)
  long long pixel, sg, s_cta, vo;
  // the wide body: its weights transposed to (S, cout, K), written first
  long long wide;
  int8_t* wt;
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

// cp.async of N bytes (4, 8 or 16) into shared memory; src_bytes 0
// zero-fills (src must still be a valid address)
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool in) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(N), "r"(in ? N : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// out_off[r] for the CTA's rows r < BM (output pixels m0 + r in (b, ho, wo)
// order): the element offset of the pixel's sample run, -1 past M
__device__ __forceinline__ void row_offsets(const QbnConvArgs& a,
                                            long long* out_off, long long m0,
                                            int s, int BM) {
  const long long M = a.B * a.Ho * a.Wo;
  const long long hw_o = a.Ho * a.Wo;
  const int Wo = (int)a.Wo;
  const bool narrow = M < (1LL << 31);   // 32-bit divisions suffice
  for (int r = threadIdx.x; r < BM; r += kThreads) {
    const long long m = m0 + r;
    long long off = -1;
    if (m < M) {
      const long long b = narrow ? (long long)((int)m / (int)hw_o) : m / hw_o;
      const int rem = (int)(m - b * hw_o);
      const int ho = rem / Wo, wo = rem - (rem / Wo) * Wo;
      off = b * a.o_sb + ho * a.o_sh + wo * a.o_sw + s * a.o_ss;
    }
    out_off[r] = off;
  }
}

// The epilogue's scalars, read once per CTA.
struct Epi {
  float scale, zw_f, out_scale, zp, lo, hi;
  int zw;
  bool relu, centered, has_bias;
};

__device__ __forceinline__ Epi load_epi(const QbnConvArgs& a, int K) {
  Epi p;
  p.scale = __fmul_rn(*a.x_scale, *a.w_scale);
  p.zw = *a.w_zp;
  p.zw_f = (float)p.zw;
  p.out_scale = *a.out_scale;
  p.zp = (float)*a.out_zp;
  p.lo = (float)a.a_lo;
  p.hi = (float)a.a_hi;
  p.relu = a.relu != 0;
  p.centered = K <= kCenteredK;
  p.has_bias = a.bias != nullptr;
  return p;
}

// One output code from the int32 sum, the window sum and the channel's
// bias (read only with has_bias).
__device__ __forceinline__ int8_t epi_code(const Epi& p, int acc, int ws,
                                           float bias) {
  float y = p.centered
      ? __int2float_rn(acc - p.zw * ws)
      : __fsub_rn(__int2float_rn(acc), __fmul_rn(p.zw_f, __int2float_rn(ws)));
  y = __fmul_rn(y, p.scale);
  if (p.has_bias) y = __fadd_rn(y, bias);
  return (int8_t)(int)requant(y, p.out_scale, p.zp, p.relu, p.lo, p.hi);
}

// The residual epilogue's scalars and its code: requant(out * out_scale +
// res * res_scale) on the res_out grid.
struct Res {
  float o_scale, r_scale, ro_scale, ro_zp;
  bool relu;
};

__device__ __forceinline__ Res load_res(const QbnConvArgs& a) {
  Res p = {0.f, 0.f, 1.f, 0.f, a.res_relu != 0};
  if (a.res != nullptr) {
    p.o_scale = *a.out_scale;
    p.r_scale = *a.res_scale;
    p.ro_scale = *a.res_out_scale;
    p.ro_zp = (float)*a.res_out_zp;
  }
  return p;
}

__device__ __forceinline__ int8_t res_code(const Res& p, int8_t c, int8_t r,
                                           float lo, float hi) {
  const float y = __fadd_rn(__fmul_rn((float)c, p.o_scale),
                            __fmul_rn((float)r, p.r_scale));
  return (int8_t)(int)requant(y, p.ro_scale, p.ro_zp, p.relu, lo, hi);
}

// the residual epilogue on 4 codes at once
__device__ __forceinline__ uint32_t res_word(const Res& rp, uint32_t v,
                                             uint32_t r, float lo, float hi) {
  uint32_t out = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    out |= (uint32_t)(uint8_t)res_code(rp, (int8_t)(v >> (8 * e)),
                                       (int8_t)(r >> (8 * e)), lo, hi)
           << (8 * e);
  return out;
}

// The epilogue of the halo and im2col bodies. The 8 warps are
// (8 / WN) x WN: warp w's MT m16 tiles are rows
// 16 MT (w / WN) + 16 i + g (+ 8), its NTW n8 tiles
// columns n0 + 8 NTW (w % WN) + 8 j + 2 t (+ 1); rowsum and out_off are
// visible to the CTA. Requantises into Os (BM x 8 NTW WN codes), then the
// CTA writes them (and reads the residual) in 4-byte words along each
// pixel's run. With raw_acc set, writes the raw sums instead.
template <int NTW, int MT, int WN>
__device__ __forceinline__ void conv_epilogue(
    const QbnConvArgs& a, const int (&acc)[MT][NTW][4], const int* rowsum,
    const long long* out_off, int8_t* Os, long long m0, int n0, int BM,
    int s, int K) {
  constexpr int BN = 8 * NTW * WN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp / WN) * 16 * MT + g, c0 = (warp % WN) * 8 * NTW;
  const int cout = (int)a.cout, S = (int)a.S;
  const long long M = a.B * a.Ho * a.Wo;

  if (a.raw_acc != nullptr) {   // debug entry: the raw sums
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + 16 * i + 8 * (e >> 1);
          const int n = n0 + c0 + j * 8 + 2 * t + (e & 1);
          const long long m = m0 + r;
          if (m < M && n < cout) {
            a.raw_acc[(m * S + s) * cout + n] = acc[i][j][e];
            if (n == 0) a.raw_win[m * S + s] = rowsum[r];
          }
        }
      }
    }
    return;
  }

  const Epi p = load_epi(a, K);
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + 16 * i + 8 * (e >> 1);
        const int nl = c0 + j * 8 + 2 * t + (e & 1);
        const int n = n0 + nl;
        const float bias =
            p.has_bias && n < cout ? __ldg(a.bias + n) : 0.0f;
        Os[r * BN + nl] = epi_code(p, acc[i][j][e], rowsum[r], bias);
      }
    }
  }
  __syncthreads();

  const bool has_res = a.res != nullptr;
  const Res rp = load_res(a);
  const int ncols = min(BN, cout - n0);
  if (a.vec_out) {   // ncols % 4 == 0, 4-byte aligned runs
    // words per row: a constant (a cheap division) when all BN columns
    // are the CTA's
    const int wpr = ncols == BN ? BN / 4 : ncols >> 2;
    for (int idx = tid; idx < BM * wpr; idx += kThreads) {
      const int r = ncols == BN ? idx / (BN / 4) : idx / wpr;
      const int q = idx - r * wpr;
      const long long off = out_off[r];
      if (off < 0) continue;
      uint32_t v = *reinterpret_cast<const uint32_t*>(Os + r * BN + 4 * q);
      const long long o = off + n0 + 4 * q;
      if (has_res)
        v = res_word(rp, v,
                     __ldg(reinterpret_cast<const unsigned int*>(a.res + o)),
                     p.lo, p.hi);
      *reinterpret_cast<uint32_t*>(a.out + o) = v;
    }
  } else {
    for (int idx = tid; idx < BM * ncols; idx += kThreads) {
      const int r = idx / ncols, nl = idx - (idx / ncols) * ncols;
      const long long off = out_off[r];
      if (off < 0) continue;
      const long long o = off + n0 + nl;
      int8_t c = Os[r * BN + nl];
      if (has_res) c = res_code(rp, c, a.res[o], p.lo, p.hi);
      a.out[o] = c;
    }
  }
}

// -- the im2col body ------------------------------------------------------

// WS: one set of weights for every sample (weight sample stride 0). A
// template argument rather than the runtime stride, which measured slower
// on the H100 here: the per-sample instantiation keeps its code as it was.
template <int NT, bool WS>
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
  const int cout = (int)a.cout;
  const int Ho = (int)a.Ho, Wo = (int)a.Wo, st = (int)a.stride;
  const int pad = (int)a.pad;
  const int K = (int)(a.kh * a.kw * a.cin);
  const long long M = a.B * a.Ho * a.Wo;
  const long long hw_o = (long long)Ho * Wo;

  row_offsets(a, out_off, m0, s, kBM);
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

  int acc[1][NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
    acc[0][j][0] = acc[0][j][1] = acc[0][j][2] = acc[0][j][3] = 0;
  int rsum = 0;

  const int8_t* wsam = WS ? a.w : a.w + (long long)s * K * cout;
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
      mma_s8(acc[0][j], a0, a1, a2, a3, *reinterpret_cast<const uint32_t*>(bc),
             *reinterpret_cast<const uint32_t*>(bc + 16));
    }
    __syncthreads();
  }

  rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
  if ((tid & 1) == 0) rowsum[tid >> 1] = rsum;
  __syncthreads();
  conv_epilogue<NT, 1, 1>(a, acc, rowsum, out_off, Os, m0, n0, kBM, s, K);
}

// -- the halo body --------------------------------------------------------

// One chunk of kc k rows x BN columns of sample s's weights (K x cout,
// row-major) into a ring slot [kc][BN], rows past K zero-filled.
template <int BN>
__device__ __forceinline__ void load_weight_chunk(const QbnConvArgs& a,
                                                  int8_t* slot, int s,
                                                  int n0, int k0, int kc,
                                                  int K) {
  const int cout = (int)a.cout;
  const int8_t* wsam = a.w + (long long)s * a.w_ss;
  const int rows = min(kc, K - k0);
  if (BN == cout) {   // one contiguous run; K * cout % 16 == 0
    const int8_t* src = wsam + (long long)k0 * cout;
    const int valid = rows * BN;
    for (int p = threadIdx.x; p < kc * BN / 16; p += kThreads) {
      const bool in = 16 * p < valid;
      cp_async<16>(slot + 16 * p, in ? src + 16 * p : wsam, in);
    }
  } else {            // a run of BN bytes per k row; cout, BN % 16 == 0
    constexpr int per_row = BN / 16;
    for (int p = threadIdx.x; p < kc * per_row; p += kThreads) {
      const int r = p / per_row, q = p - r * per_row;
      const bool in = r < rows;
      cp_async<16>(slot + r * BN + 16 * q,
                   in ? wsam + (long long)(k0 + r) * cout + n0 + 16 * q
                      : wsam,
                   in);
    }
  }
}

// The CTA's input tile: n_img images x h_in rows x w_in columns of pitch
// bytes, cin of them copied in pieces of V bytes, zero-filled outside the
// image (and past the last image). Thread tid copies pixels tid, tid + 256,
// ...; their (image, row, column) advance without divisions.
template <int V>
__device__ __forceinline__ void load_halo(const QbnConvArgs& a, int8_t* halo,
                                          int s, long long b0, int h0) {
  const int cin = (int)a.cin, pitch = (int)a.pitch;
  const int w_in = (int)a.w_in, h_in = (int)a.h_in;
  const int H = (int)a.H, W = (int)a.W;
  const int total = (int)a.n_img * h_in * w_in;
  const int d_row = kThreads / w_in, d_col = kThreads - d_row * w_in;
  int img = 0, row = threadIdx.x / w_in;
  int col = threadIdx.x - row * w_in;
  while (row >= h_in) row -= h_in, ++img;
  const int8_t* xs = a.x + s * a.x_ss;
  for (int px = threadIdx.x; px < total; px += kThreads) {
    const long long b = b0 + img;
    const int hi = h0 + row, wi = col - 1;
    const bool in = b < a.B && hi >= 0 && hi < H && wi >= 0 && wi < W;
    const int8_t* src = in ? xs + b * a.x_sb + hi * a.x_sh + wi * a.x_sw
                           : a.x;
    int8_t* dst = halo + px * pitch;
    for (int v = 0; v < cin; v += V)
      cp_async<V>(dst + v, in ? src + v : src, in);
    col += d_col;
    row += d_row;
    if (col >= w_in) col -= w_in, ++row;
    while (row >= h_in) row -= h_in, ++img;
  }
}

// The A fragments of a k step for this thread's MT m16 tiles: rows pa / pb
// (g and g + 8), k-quads at ko0 (k = 4 t) and ko1 (k = 4 t + 16)
template <int MT>
__device__ __forceinline__ void load_a(uint32_t (&af)[MT][4],
                                       const int8_t* halo, const int* pa,
                                       const int* pb, int ko0, int ko1) {
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    af[i][0] = *reinterpret_cast<const uint32_t*>(halo + pa[i] + ko0);
    af[i][1] = *reinterpret_cast<const uint32_t*>(halo + pb[i] + ko0);
    af[i][2] = *reinterpret_cast<const uint32_t*>(halo + pa[i] + ko1);
    af[i][3] = *reinterpret_cast<const uint32_t*>(halo + pb[i] + ko1);
  }
}

// 4x4 byte transpose: c[j] holds byte j of r[0..3], in order
__device__ __forceinline__ void transpose4(const uint32_t* r, uint32_t* c) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

// CTAs per SM the register allocation leaves room for: 4 at NT = 3 (64
// registers) and 3 above (85); on the H100 both ran faster than the
// compiler's own choice, and 4 at NT = 12 spills
template <int NT>
constexpr int halo_min_blocks() {
  return NT == 3 ? 4 : 3;
}

template <int NT, int MT, int WN>
__global__ void __launch_bounds__(kThreads, halo_min_blocks<NT>())
int_conv_halo_kernel(const QbnConvArgs a) {
  constexpr int BN = 8 * NT, NTW = NT / WN;
  constexpr int BM = 8 / WN * 16 * MT;
  extern __shared__ __align__(16) int8_t smem[];
  // [halo tile, later the output codes | weight ring R x [kc][BN] |
  //  transposed chunk [BN][kc + 16] | rowsum | out_off | koff table]
  const int kc = (int)a.kc, R = (int)a.ring, bt_row = kc + 16;
  const int halo_region =
      (int)((max(a.n_img * a.h_in * a.w_in * a.pitch, (long long)BM * BN) +
             15) / 16 * 16);
  int8_t* halo = smem;
  int8_t* ring = smem + halo_region;
  int8_t* Bt = ring + R * kc * BN;
  int* rowsum = reinterpret_cast<int*>(Bt + BN * bt_row);
  long long* out_off = reinterpret_cast<long long*>(rowsum + BM);
  int* kt = reinterpret_cast<int*>(out_off + BM);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int s = blockIdx.x;
  const long long m0 = (long long)blockIdx.y * BM;
  const int n0 = blockIdx.z * BN;
  const int K = (int)(a.kh * a.kw * a.cin);
  const int chunks = (K + kc - 1) / kc;
  for (int i = tid; i < (K + kBK - 1) / kBK * 8; i += kThreads)
    kt[i] = __ldg(a.koff + i);

  // the tile's first output pixel: image b0, output row ho0
  const long long hw_o = a.Ho * a.Wo;
  const long long b0 = m0 / hw_o;
  const int h0 = (int)((m0 - b0 * hw_o) / a.Wo) * (int)a.stride - 1;
  if (a.vx == 16)
    load_halo<16>(a, halo, s, b0, h0);
  else if (a.vx == 8)
    load_halo<8>(a, halo, s, b0, h0);
  else
    load_halo<4>(a, halo, s, b0, h0);
  cp_commit();
  for (int c = 0; c < R; ++c) {   // the ring's first R chunks in flight
    if (c < chunks)
      load_weight_chunk<BN>(a, ring + c * kc * BN, s, n0, c * kc, kc, K);
    cp_commit();
  }
  row_offsets(a, out_off, m0, s, BM);

  // this warp's rows and columns: (8 / WN) x WN warps
  const int r0 = (warp / WN) * 16 * MT + g, c0 = (warp % WN) * 8 * NTW;
  int pa[MT], pb[MT];   // this thread's pixels' window origins in the tile
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    pa[i] = __ldg(a.pixoff + r0 + 16 * i);
    pb[i] = __ldg(a.pixoff + r0 + 16 * i + 8);
  }
  int acc[MT][NTW][4];
  int rs[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    rs[i][0] = rs[i][1] = 0;
#pragma unroll
    for (int j = 0; j < NTW; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;
  }

  for (int c = 0; c < chunks; ++c) {
    // the halo tile and chunk c have landed (chunk c + 1 may not)
    if (R == 1)
      cp_wait<0>();
    else
      cp_wait<1>();
    __syncthreads();   // ... for every thread; Bt is free
    {  // transpose chunk c: [kc][BN] -> [BN][kc + 16], in blocks of
       // 4 k-quads x 8 n-quads per warp (4-way bank conflicts at most)
      const int8_t* slot = ring + (c % R) * kc * BN;
      const int kblocks = kc / 16, nblocks = (BN / 4 + 7) / 8;
      for (int blk = warp; blk < kblocks * nblocks; blk += kThreads / 32) {
        const int nb = blk / kblocks;
        const int kq = 4 * (blk - nb * kblocks) + (lane >> 3);
        const int nq = 8 * nb + (lane & 7);
        if (nq >= BN / 4) continue;
        const int8_t* src = slot + 4 * kq * BN + 4 * nq;
        uint32_t r[4], col[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          r[e] = *reinterpret_cast<const uint32_t*>(src + e * BN);
        transpose4(r, col);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          *reinterpret_cast<uint32_t*>(Bt + (4 * nq + e) * bt_row + 4 * kq) =
              col[e];
      }
    }
    __syncthreads();   // Bt holds chunk c; its ring slot is free
    if (c + R < chunks)
      load_weight_chunk<BN>(a, ring + (c % R) * kc * BN, s, n0,
                            (c + R) * kc, kc, K);
    cp_commit();

    const int k0 = c * kc;
    const int steps = min(kc, K - k0 + kBK - 1) / kBK;
    // the A fragments of step st + 1 are loaded while step st's products
    // run; q = k / 4 for k = 4 t and 4 t + 16 of the step
    uint32_t af[MT][4], nf[MT][4];
    load_a<MT>(af, halo, pa, pb, kt[k0 / 4 + t], kt[k0 / 4 + t + 4]);
    for (int st = 0; st < steps; ++st) {
      const int q0 = (k0 + st * kBK) / 4 + t;
      const int qn = st + 1 < steps ? q0 + 8 : q0;
      load_a<MT>(nf, halo, pa, pb, kt[qn], kt[qn + 4]);
      const int one0 = 4 * q0 < K ? 0x01010101 : 0;
      const int one1 = 4 * (q0 + 4) < K ? 0x01010101 : 0;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        rs[i][0] = __dp4a((int)af[i][0], one0, rs[i][0]);
        rs[i][0] = __dp4a((int)af[i][2], one1, rs[i][0]);
        rs[i][1] = __dp4a((int)af[i][1], one0, rs[i][1]);
        rs[i][1] = __dp4a((int)af[i][3], one1, rs[i][1]);
      }
      const int8_t* bt = Bt + (c0 + g) * bt_row + st * kBK + 4 * t;
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        const int8_t* bc = bt + j * 8 * bt_row;
        const uint32_t b0v = *reinterpret_cast<const uint32_t*>(bc);
        const uint32_t b1v = *reinterpret_cast<const uint32_t*>(bc + 16);
#pragma unroll
        for (int i = 0; i < MT; ++i)
          mma_s8(acc[i][j], af[i][0], af[i][1], af[i][2], af[i][3], b0v,
                 b1v);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) af[i][e] = nf[i][e];
    }
  }
  cp_wait<0>();

  // window sums: the 4 lanes of a row group hold its 4 k-quads
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int v = rs[i][h];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (t == 0 && c0 == 0) rowsum[r0 + 16 * i + 8 * h] = v;
    }
  }
  __syncthreads();   // rowsum, out_off visible; the halo tile is free
  conv_epilogue<NTW, MT, WN>(a, acc, rowsum, out_off, halo, m0, n0, BM, s,
                             K);
}

// -- the pixel body -------------------------------------------------------

// The codes of one group, staged [pixel][sample][BN] at spitch bytes a
// pixel, to the output in pieces of V bytes (V divides BN and every output
// stride; 1 where no wider piece is aligned): a pixel's run of the group
// is contiguous in the merged layout,
// so consecutive threads write consecutive pieces. The residual epilogue,
// where asked, runs on each piece.
template <int V>
__device__ __forceinline__ void copy_out(const QbnConvArgs& a,
                                         const int8_t* St, int spitch,
                                         const long long* out_off, int s0,
                                         int ng, int n0, int BN, int BM,
                                         const Res& rp, float lo, float hi) {
  const int per_s = BN / V, per_row = ng * per_s;
  const bool has_res = a.res != nullptr;
  for (int idx = threadIdx.x; idx < BM * per_row; idx += kThreads) {
    const int r = idx / per_row, rem = idx - r * per_row;
    const int sl = rem / per_s, q = rem - sl * per_s;
    const long long off = out_off[r];
    if (off < 0) continue;
    const long long o = off + (long long)(s0 + sl) * a.o_ss + n0 + q * V;
    const int8_t* src = St + r * spitch + sl * BN + q * V;
    int8_t v[V < 4 ? 4 : V];
    if (V >= 4) {
#pragma unroll
      for (int e = 0; e < V; e += 4)
        *reinterpret_cast<uint32_t*>(v + e) =
            *reinterpret_cast<const uint32_t*>(src + e);
    } else {
      v[0] = src[0];
    }
    if (has_res) {
#pragma unroll
      for (int e = 0; e < V; ++e)
        v[e] = res_code(rp, v[e], a.res[o + e], lo, hi);
    }
    if (V == 16)
      *reinterpret_cast<uint4*>(a.out + o) = *reinterpret_cast<uint4*>(v);
    else if (V == 8)
      *reinterpret_cast<uint2*>(a.out + o) = *reinterpret_cast<uint2*>(v);
    else if (V == 4)
      *reinterpret_cast<uint32_t*>(a.out + o) =
          *reinterpret_cast<uint32_t*>(v);
    else
      a.out[o] = v[0];
  }
}

// A CTA owns kBM consecutive output pixels and BN = 8 NT channels and walks
// over its samples (blockIdx.z * s_cta ...) in groups of sg. SHARED: the
// stem (one image, K <= 32): the im2col tile A[pixel][k] is gathered once
// and its fragments and window sums stay in registers for every sample.
// Else a 1x1 conv with padding 0: per group, each pixel's input codes of
// the group's samples (cin bytes each, consecutive in the merged layout)
// are copied by cp.async into its A row, sample after sample, and the
// window sums come from the A fragments. Per group the samples' weight
// slices [K][BN] are read in 4-byte words and transposed into Bt
// [sample][n][kp + 16], zero past K (the A bytes past a sample's cin then
// multiply zeros). Each warp owns 16 pixels and all BN channels: per sample
// and k step one A fragment feeds NT mma.sync m16n8k32. The codes
// (epi_code, the other bodies' epilogue) are staged per group and written
// by copy_out.
// CTAs per SM: the numbers of ops/int_conv.py PIXEL_CTAS, from which the
// plan's shared-memory budget is derived: 4 at NT = 3 and 6 (64
// registers, no spills), 3 at NT = 12, whose accumulators spill heavily at
// 64 registers (4 bytes still at 80). On the H100 more CTAs with smaller
// sample groups ran faster at every flagship shape than 2 with large ones.
template <int NT>
constexpr int pixel_min_blocks() {
  return NT == 12 ? 3 : 4;
}

template <int NT, bool SHARED>
__global__ void __launch_bounds__(kThreads, pixel_min_blocks<NT>())
int_conv_pixel_kernel(const QbnConvArgs a) {
  constexpr int BN = 8 * NT, BM = kBM;
  extern __shared__ __align__(16) int8_t smem[];
  const int cin = (int)a.cin, cout = (int)a.cout, S = (int)a.S;
  const int K = (int)(a.kh * a.kw * a.cin);
  const int kp = (K + kBK - 1) / kBK * kBK, btp = kp + 16;
  const int sg = (int)a.sg, pitch = (int)a.pitch, spitch = sg * BN + 16;
  // shared weights (sample stride 0): one transposed slice, loaded once,
  // serves every group
  const bool w_shared = a.w_ss == 0;
  // [A tile BM x pitch | Bt (sg, or 1 when shared) x BN x btp | staged
  //  codes BM x spitch | rowsum | out_off | x_off]
  int8_t* As = smem;
  int8_t* Bt = As + BM * pitch;
  int8_t* St = Bt + (w_shared ? 1 : sg) * BN * btp;
  int* rowsum = reinterpret_cast<int*>(St + BM * spitch);
  long long* out_off = reinterpret_cast<long long*>(rowsum + BM);
  long long* x_off = out_off + BM;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int s_begin = blockIdx.z * (int)a.s_cta;
  const int s_end = min(S, s_begin + (int)a.s_cta);
  const long long M = a.B * a.Ho * a.Wo;
  const long long hw_o = a.Ho * a.Wo;
  const int Wo = (int)a.Wo, st = (int)a.stride, pad = (int)a.pad;
  const bool raw = a.raw_acc != nullptr;

  row_offsets(a, out_off, m0, 0, BM);   // each pixel's run at sample 0
  if (!SHARED) {   // each pixel's input run: (b, ho * st, wo * st)
    for (int r = tid; r < BM; r += kThreads) {
      const long long m = m0 + r;
      long long off = -1;
      if (m < M) {
        const long long b = m / hw_o;
        const int rem = (int)(m - b * hw_o);
        const int ho = rem / Wo, wo = rem - (rem / Wo) * Wo;
        off = b * a.x_sb + (long long)(ho * st - pad) * a.x_sh +
              (long long)(wo * st - pad) * a.x_sw;
      }
      x_off[r] = off;
    }
    __syncthreads();   // x_off, out_off visible to every thread
  }

  const Epi p = raw ? Epi{} : load_epi(a, K);   // no qparams in raw mode
  const Res rp = load_res(a);
  const int ra = warp * 16 + g, rb = ra + 8;

  uint32_t af[4] = {0u, 0u, 0u, 0u};
  int ws_a = 0, ws_b = 0;
  if (SHARED) {
    // the im2col tile: two threads a row, 16 k each, zero outside the
    // image and past K
    const int r = tid >> 1, kk0 = (tid & 1) * 16;
    const long long m = m0 + r;
    const int kw = (int)a.kw, H = (int)a.H, W = (int)a.W;
    long long base = 0;
    int h0 = 0, w0 = 0;
    if (m < M) {
      const long long b = m / hw_o;
      const int rem = (int)(m - b * hw_o);
      h0 = rem / Wo * st - pad;
      w0 = (rem - (rem / Wo) * Wo) * st - pad;
      base = b * a.x_sb;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t word = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = kk0 + 4 * q + e;
        if (m < M && k < K) {
          const int tap = k / cin, ci = k - (k / cin) * cin;
          const int hi = h0 + tap / kw, wi = w0 + tap - (tap / kw) * kw;
          if (hi >= 0 && hi < H && wi >= 0 && wi < W)
            word |= (uint32_t)(uint8_t)a.x[base + hi * a.x_sh +
                                           wi * a.x_sw + ci] << (8 * e);
        }
      }
      *reinterpret_cast<uint32_t*>(As + r * pitch + kk0 + 4 * q) = word;
    }
    __syncthreads();
    {
      const int* pr = reinterpret_cast<const int*>(As + r * pitch + kk0);
      int v = __dp4a(pr[0], 0x01010101, 0);
      v = __dp4a(pr[1], 0x01010101, v);
      v = __dp4a(pr[2], 0x01010101, v);
      v = __dp4a(pr[3], 0x01010101, v);
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      if ((tid & 1) == 0) rowsum[r] = v;
    }
    __syncthreads();
    af[0] = *reinterpret_cast<const uint32_t*>(As + ra * pitch + 4 * t);
    af[1] = *reinterpret_cast<const uint32_t*>(As + rb * pitch + 4 * t);
    af[2] = *reinterpret_cast<const uint32_t*>(As + ra * pitch + 16 + 4 * t);
    af[3] = *reinterpret_cast<const uint32_t*>(As + rb * pitch + 16 + 4 * t);
    ws_a = rowsum[ra];
    ws_b = rowsum[rb];
  }

  for (int s0 = s_begin; s0 < s_end; s0 += sg) {
    const int ng = min(sg, s_end - s0);
    if (!SHARED) {   // A: each pixel's cin codes of the group's samples
      const int vx = (int)a.vx, pieces = cin / vx, per_row = ng * pieces;
      for (int idx = tid; idx < BM * per_row; idx += kThreads) {
        const int r = idx / per_row, rem = idx - r * per_row;
        const int sl = rem / pieces, v = rem - sl * pieces;
        const long long xo = x_off[r];
        const bool in = xo >= 0;
        const int8_t* src =
            in ? a.x + xo + (long long)(s0 + sl) * a.x_ss + v * vx : a.x;
        int8_t* dst = As + r * pitch + sl * cin + v * vx;
        if (vx == 16)
          cp_async<16>(dst, src, in);
        else if (vx == 8)
          cp_async<8>(dst, src, in);
        else
          cp_async<4>(dst, src, in);
      }
      cp_commit();
    }
    if (!w_shared || s0 == s_begin) {
      // Bt: the group's weight slices (the one shared slice, once),
      // transposed, zero past K
      const int kq_n = kp / 4, nq_n = BN / 4, n_sl = w_shared ? 1 : ng;
      for (int idx = tid; idx < n_sl * kq_n * nq_n; idx += kThreads) {
        const int nq = idx % nq_n, rest = idx / nq_n;
        const int kq = rest % kq_n, sl = rest / kq_n;
        const int8_t* src =
            a.w + (long long)(s0 + sl) * a.w_ss + n0 + 4 * nq;
        uint32_t rows[4], cols[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = 4 * kq + e;
          rows[e] = k < K ? __ldg(reinterpret_cast<const unsigned int*>(
                                src + (long long)k * cout))
                          : 0u;
        }
        transpose4(rows, cols);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          *reinterpret_cast<uint32_t*>(
              Bt + (sl * BN + 4 * nq + e) * btp + 4 * kq) = cols[e];
      }
    }
    if (!SHARED) cp_wait<0>();
    __syncthreads();

    for (int sl = 0; sl < ng; ++sl) {
      int acc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
      const int8_t* bt = Bt + ((w_shared ? 0 : sl) * BN + g) * btp + 4 * t;
      if (SHARED) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int8_t* bc = bt + j * 8 * btp;
          mma_s8(acc[j], af[0], af[1], af[2], af[3],
                 *reinterpret_cast<const uint32_t*>(bc),
                 *reinterpret_cast<const uint32_t*>(bc + 16));
        }
      } else {
        int rs0 = 0, rs1 = 0;
        const int8_t* ar = As + ra * pitch + sl * cin + 4 * t;
        const int8_t* br = As + rb * pitch + sl * cin + 4 * t;
        for (int k0 = 0; k0 < kp; k0 += kBK) {
          const uint32_t a0 = *reinterpret_cast<const uint32_t*>(ar + k0);
          const uint32_t a1 = *reinterpret_cast<const uint32_t*>(br + k0);
          const uint32_t a2 = *reinterpret_cast<const uint32_t*>(ar + k0 + 16);
          const uint32_t a3 = *reinterpret_cast<const uint32_t*>(br + k0 + 16);
          const int one0 = k0 + 4 * t < K ? 0x01010101 : 0;
          const int one1 = k0 + 16 + 4 * t < K ? 0x01010101 : 0;
          rs0 = __dp4a((int)a0, one0, rs0);
          rs0 = __dp4a((int)a2, one1, rs0);
          rs1 = __dp4a((int)a1, one0, rs1);
          rs1 = __dp4a((int)a3, one1, rs1);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const int8_t* bc = bt + j * 8 * btp + k0;
            mma_s8(acc[j], a0, a1, a2, a3,
                   *reinterpret_cast<const uint32_t*>(bc),
                   *reinterpret_cast<const uint32_t*>(bc + 16));
          }
        }
        // the 4 lanes of a row group hold its 4 k-quads
        rs0 += __shfl_xor_sync(0xffffffffu, rs0, 1);
        rs0 += __shfl_xor_sync(0xffffffffu, rs0, 2);
        rs1 += __shfl_xor_sync(0xffffffffu, rs1, 1);
        rs1 += __shfl_xor_sync(0xffffffffu, rs1, 2);
        ws_a = rs0;
        ws_b = rs1;
      }

      if (raw) {   // debug entry: the raw sums
        const int s = s0 + sl;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const long long m = m0 + (e >> 1 ? rb : ra);
            const int n = n0 + 8 * j + 2 * t + (e & 1);
            if (m < M) {
              a.raw_acc[(m * S + s) * cout + n] = acc[j][e];
              if (n == 0) a.raw_win[m * S + s] = e >> 1 ? ws_b : ws_a;
            }
          }
        }
        continue;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = sl * BN + 8 * j + 2 * t;
        const int n = n0 + 8 * j + 2 * t;
        const float b0 = p.has_bias ? __ldg(a.bias + n) : 0.0f;
        const float b1 = p.has_bias ? __ldg(a.bias + n + 1) : 0.0f;
        const uint32_t c0 = (uint8_t)epi_code(p, acc[j][0], ws_a, b0);
        const uint32_t c1 = (uint8_t)epi_code(p, acc[j][1], ws_a, b1);
        const uint32_t c2 = (uint8_t)epi_code(p, acc[j][2], ws_b, b0);
        const uint32_t c3 = (uint8_t)epi_code(p, acc[j][3], ws_b, b1);
        *reinterpret_cast<uint16_t*>(St + ra * spitch + col) =
            (uint16_t)(c0 | (c1 << 8));
        *reinterpret_cast<uint16_t*>(St + rb * spitch + col) =
            (uint16_t)(c2 | (c3 << 8));
      }
    }
    __syncthreads();   // the group's codes staged; A and Bt free
    if (!raw) {
      if (a.vo >= 16)
        copy_out<16>(a, St, spitch, out_off, s0, ng, n0, BN, BM, rp, p.lo,
                     p.hi);
      else if (a.vo == 8)
        copy_out<8>(a, St, spitch, out_off, s0, ng, n0, BN, BM, rp, p.lo,
                    p.hi);
      else if (a.vo == 4)
        copy_out<4>(a, St, spitch, out_off, s0, ng, n0, BN, BM, rp, p.lo,
                    p.hi);
      else
        copy_out<1>(a, St, spitch, out_off, s0, ng, n0, BN, BM, rp, p.lo,
                    p.hi);
    }
  }
}

// -- the wide body --------------------------------------------------------

constexpr int kWideBK = 128;   // K bytes of a ring stage: 8 pieces of 16

// ring stages: 3 x 32 KB at 128 channels, 4 x 24 KB at 64, so that two
// CTAs fit on an SM
template <int BN>
__host__ __device__ constexpr int wide_ring() {
  return BN == 128 ? 3 : 4;
}

// A wgmma shared-memory descriptor of a K-major operand without swizzle:
// core matrices of 8 rows x 16 bytes, lbo bytes apart along K and sbo
// bytes apart along M (or N)
__device__ __forceinline__ uint64_t wgmma_desc(const int8_t* p, uint32_t lbo,
                                               uint32_t sbo) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// the accumulators stay where wgmma writes them: no copy between the
// products' issue and their wait
template <int N>
__device__ __forceinline__ void pin(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// cp.async's writes become visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a 16-byte cp.async that bypasses L1 (each piece is read once, from
// shared memory; allocating the pieces in L1 measured slower on the H100);
// src_bytes 0 zero-fills
__device__ __forceinline__ void cp_async_cg16(void* dst, const void* src,
                                              bool in) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0));
}

// The weights of the wide body, (S, K, cout) as the draw writes them, to
// (S, cout, K): the K-major rows that s8 wgmma reads. One CTA transposes
// 64 k rows x 64 channels through shared memory (a word column of 4
// channels x 4 k rows a thread, by __byte_perm); K % 16 == 0, cout % 64 ==
// 0. One pass a call: each weight byte read and written once.
__global__ void __launch_bounds__(kThreads)
int_conv_kernel_wide_wt(const int8_t* w, int8_t* wt, int K, int cout) {
  __shared__ uint32_t T[64][17];   // [k][4-channel word], one word of pad
  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * 64, n0 = blockIdx.y * 64;
  const long long so = (long long)blockIdx.z * K * cout;
  {
    const int k = tid >> 2, q = 4 * (tid & 3);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (k0 + k < K)
      v = __ldg(reinterpret_cast<const uint4*>(
          w + so + (long long)(k0 + k) * cout + n0 + 4 * q));
    T[k][q] = v.x;
    T[k][q + 1] = v.y;
    T[k][q + 2] = v.z;
    T[k][q + 3] = v.w;
  }
  __syncthreads();
  const int kq = tid & 15, nw = tid >> 4;   // k rows 4 kq.., channels 4 nw..
  if (k0 + 4 * kq >= K) return;
  uint32_t r[4], c[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) r[e] = T[4 * kq + e][nw];
  transpose4(r, c);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<uint32_t*>(
        wt + so + (long long)(n0 + 4 * nw + j) * K + k0 + 4 * kq) = c[j];
}

// Its kernels are named int_conv_kernel_* as the im2col body is, so that
// what matches the conv kernel by name (portbench's port-kernel list and
// its int_conv roofline) counts them with it.
// A CTA owns one sample s, BM = 128 consecutive output pixels and BN output
// channels. The samples run in groups of sg (blockIdx.y: the group), and
// blockIdx.x runs over the group's channel tiles fastest, then its samples,
// then the pixel tiles: the CTAs of one pixel tile read its A rows once from
// device memory, in runs of sg * cin bytes a pixel, and the group's weight
// slices (the plan keeps them to about 16 MB) stay in L2 while its pixel
// tiles run. K advances in stages of 128 bytes through a ring of R
// stages in shared memory, stage kt + R - 1 in flight while stage kt is
// multiplied:
//   A, 128 pixels x 128 K bytes, [piece][pixel][16]: thread tid gathers
//     pixel tid / 2's 16-byte pieces tid % 2, + 2, + 4, + 6 by cp.async.
//     The piece's tap and channel come from the plan's table (koff: dh,
//     dw, ci, or -1 past K): cin % 16 == 0 keeps a piece inside one tap.
//     Taps outside the image, pixels past M and bytes past K read 0
//     (src-size 0; code 0 is the zero point and adds nothing).
//   B, BN channels x 128 K bytes, [piece][channel][16], from the weights
//     transposed once a call (int_conv_kernel_wide_wt).
// Both are K-major core matrices of 8 rows x 16 bytes, as wgmma reads them
// without swizzle; the stores of a warp's 32 pieces fall in distinct banks.
// The two warpgroups each run m64nBNk32 s8 wgmma on 64 of the pixels, 4 a
// stage (fewer where K ends inside it), while every thread adds its own
// pieces' bytes to its pixel's window sum (__dp4a). The codes (epi_code,
// res_code: the other bodies' epilogue) are staged [pixel][BN + 16] in the
// ring's memory, and the CTA writes each pixel's run of BN codes, and reads
// its residual, in 16-byte pieces where every address allows.
template <int BN, bool WS>
__global__ void __launch_bounds__(kThreads, 2)
int_conv_kernel_wide(const QbnConvArgs a) {
  constexpr int BM = kBM, R = wide_ring<BN>();
  constexpr int A_BYTES = BM * kWideBK, STAGE = A_BYTES + BN * kWideBK;
  constexpr int OP = BN + 16;   // staged codes' row pitch
  extern __shared__ __align__(16) int8_t smem[];
  // [ring R x (A | B), later the staged codes | rowsum | out_off | taps]
  int* rowsum = reinterpret_cast<int*>(smem + R * STAGE);
  long long* out_off = reinterpret_cast<long long*>(rowsum + BM);
  int* taps = reinterpret_cast<int*>(out_off + BM);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_tiles = (int)(a.cout / BN), sg = (int)a.sg;
  const int n0 = (int)(blockIdx.x % n_tiles) * BN;
  const int rest = blockIdx.x / n_tiles;
  const int s = blockIdx.y * sg + rest % sg;
  const long long m0 = (long long)(rest / sg) * BM;
  if (s >= (int)a.S) return;   // past the last group's samples
  const int K = (int)(a.kh * a.kw * a.cin);
  const int KT = (K + kWideBK - 1) / kWideBK;
  const long long M = a.B * a.Ho * a.Wo;
  for (int i = tid; i < KT * 8; i += kThreads) taps[i] = __ldg(a.koff + i);
  row_offsets(a, out_off, m0, s, BM);
  __syncthreads();   // taps visible to every thread

  // this thread's pixel r and its window origin; weight row nrow
  const int r = tid >> 1, half = tid & 1;
  const unsigned H = (unsigned)a.H, W = (unsigned)a.W;
  const bool row_ok = m0 + r < M;
  long long xbase = 0;
  int h0 = 0, w0 = 0;
  if (row_ok) {
    const long long hw_o = a.Ho * a.Wo, m = m0 + r;
    const long long b = m / hw_o;
    const int rem = (int)(m - b * hw_o), Wo = (int)a.Wo;
    h0 = rem / Wo * (int)a.stride - (int)a.pad;
    w0 = (rem - rem / Wo * Wo) * (int)a.stride - (int)a.pad;
    xbase = b * a.x_sb + s * a.x_ss;
  }
  const int nrow = (tid >> 1) % BN, nc0 = (tid >> 1) / BN;
  const int8_t* wrow = a.wt + (WS ? 0 : (long long)s * a.cout * K) +
                       (long long)(n0 + nrow) * K;

  auto load_stage = [&](int kt, int slot) {
    int8_t* As = smem + slot * STAGE;
    int8_t* Bs = As + A_BYTES;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = 2 * i + half;
      const int tap = taps[kt * 8 + c];
      const int hi = h0 + (tap >> 24), wi = w0 + ((tap >> 20) & 15);
      const bool in = row_ok && tap >= 0 && (unsigned)hi < H &&
                      (unsigned)wi < W;
      cp_async_cg16(As + c * (BM * 16) + r * 16,
                    in ? a.x + xbase + hi * a.x_sh + wi * a.x_sw +
                             (tap & 0xFFFFF)
                       : a.x,
                    in);
    }
#pragma unroll
    for (int i = 0; i < BN / 32; ++i) {
      const int c = 2 * (nc0 + i * (128 / BN)) + half;
      const int k = kt * kWideBK + 16 * c;
      cp_async_cg16(Bs + c * (BN * 16) + nrow * 16, k < K ? wrow + k : a.wt,
                    k < K);
    }
  };

  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  int rs = 0;
  const int wg = warp >> 2;   // this warpgroup's pixels: 64 wg ..
#pragma unroll
  for (int st = 0; st < R - 1; ++st) {
    if (st < KT) load_stage(st, st);
    cp_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_wait<R - 2>();
    fence_proxy_async();
    __syncthreads();   // stage kt landed for all; slot (kt - 1) % R is free
    if (kt + R - 1 < KT) load_stage(kt + R - 1, (kt + R - 1) % R);
    cp_commit();
    const int8_t* As = smem + (kt % R) * STAGE;
    const int8_t* Bs = As + A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (kt * kWideBK + 32 * j < K)
        wgmma_s8(acc,
                 wgmma_desc(As + 2 * j * (BM * 16) + wg * (64 * 16), BM * 16,
                            128),
                 wgmma_desc(Bs + 2 * j * (BN * 16), BN * 16, 128));
    wgmma_commit();
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // the window sum, while they run
      const uint4 v = *reinterpret_cast<const uint4*>(
          As + (2 * i + half) * (BM * 16) + r * 16);
      rs = __dp4a((int)v.x, 0x01010101, rs);
      rs = __dp4a((int)v.y, 0x01010101, rs);
      rs = __dp4a((int)v.z, 0x01010101, rs);
      rs = __dp4a((int)v.w, 0x01010101, rs);
    }
    wgmma_wait0();
    pin(acc);
  }
  cp_wait<0>();
  rs += __shfl_xor_sync(0xffffffffu, rs, 1);
  if (half == 0) rowsum[r] = rs;
  __syncthreads();   // rowsum, out_off visible; the ring is free

  // thread (warp w4 of warpgroup wg, lane g, t) holds rows rb and rb + 8,
  // columns 8 j + 2 t (+ 1) of each n8 tile j
  const int g = lane >> 2, t = lane & 3;
  const int rb = wg * 64 + (warp & 3) * 16 + g;
  if (a.raw_acc != nullptr) {   // debug entry: the raw sums
    const int S = (int)a.S, cout = (int)a.cout;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = rb + 8 * (e >> 1);
        const int n = n0 + 8 * j + 2 * t + (e & 1);
        const long long m = m0 + row;
        if (m < M) {
          a.raw_acc[(m * S + s) * cout + n] = acc[4 * j + e];
          if (n == 0) a.raw_win[m * S + s] = rowsum[row];
        }
      }
    }
    return;
  }
  const Epi p = load_epi(a, K);
  int8_t* Os = smem;
  const int ws0 = rowsum[rb], ws1 = rowsum[rb + 8];
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * t;
    const float b0 = p.has_bias ? __ldg(a.bias + n0 + col) : 0.0f;
    const float b1 = p.has_bias ? __ldg(a.bias + n0 + col + 1) : 0.0f;
    const uint32_t c0 = (uint8_t)epi_code(p, acc[4 * j], ws0, b0);
    const uint32_t c1 = (uint8_t)epi_code(p, acc[4 * j + 1], ws0, b1);
    const uint32_t c2 = (uint8_t)epi_code(p, acc[4 * j + 2], ws1, b0);
    const uint32_t c3 = (uint8_t)epi_code(p, acc[4 * j + 3], ws1, b1);
    *reinterpret_cast<uint16_t*>(Os + rb * OP + col) =
        (uint16_t)(c0 | (c1 << 8));
    *reinterpret_cast<uint16_t*>(Os + (rb + 8) * OP + col) =
        (uint16_t)(c2 | (c3 << 8));
  }
  __syncthreads();

  const bool has_res = a.res != nullptr;
  const Res rp = load_res(a);
  if (a.vo >= 16) {   // out, res and every output stride 16-byte aligned
    constexpr int PR = BN / 16;   // pieces a pixel
    for (int idx = tid; idx < BM * PR; idx += kThreads) {
      const int row = idx / PR, q = idx - row * PR;
      const long long off = out_off[row];
      if (off < 0) continue;
      const long long o = off + n0 + 16 * q;
      uint4 v = *reinterpret_cast<const uint4*>(Os + row * OP + 16 * q);
      if (has_res) {
        const uint4 rv = __ldg(reinterpret_cast<const uint4*>(a.res + o));
        v.x = res_word(rp, v.x, rv.x, p.lo, p.hi);
        v.y = res_word(rp, v.y, rv.y, p.lo, p.hi);
        v.z = res_word(rp, v.z, rv.z, p.lo, p.hi);
        v.w = res_word(rp, v.w, rv.w, p.lo, p.hi);
      }
      *reinterpret_cast<uint4*>(a.out + o) = v;
    }
  } else {
    for (int idx = tid; idx < BM * BN; idx += kThreads) {
      const int row = idx / BN, nl = idx - row * BN;
      const long long off = out_off[row];
      if (off < 0) continue;
      const long long o = off + n0 + nl;
      int8_t c = Os[row * OP + nl];
      if (has_res) c = res_code(rp, c, a.res[o], p.lo, p.hi);
      a.out[o] = c;
    }
  }
}

template <int NT>
int launch(const QbnConvArgs& a, long long m_tiles, cudaStream_t stream) {
  constexpr int BN = 8 * NT;
  const long long n_tiles = (a.cout + BN - 1) / BN;
  if (m_tiles > 65535 || n_tiles > 65535 || a.S > 2147483647LL ||
      (a.w_ss != 0 && a.w_ss != a.kh * a.kw * a.cin * a.cout))
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)a.S, (unsigned)m_tiles, (unsigned)n_tiles);
  if (a.w_ss == 0)
    int_conv_kernel<NT, true><<<grid, kThreads, 0, stream>>>(a);
  else
    int_conv_kernel<NT, false><<<grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int NT, int MT, int WN>
int launch_halo(const QbnConvArgs& a, cudaStream_t stream) {
  constexpr int BN = 8 * NT, BM = 8 / WN * 16 * MT;
  static const cudaError_t attr = cudaFuncSetAttribute(
      int_conv_halo_kernel<NT, MT, WN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (attr != cudaSuccess) return (int)attr;
  const long long m_tiles = (a.B * a.Ho * a.Wo + BM - 1) / BM;
  if (a.bm != BM || a.cout % BN != 0 || a.ring < 1 || a.ring > 2 ||
      a.kc % 32 != 0 || m_tiles > 65535 ||
      a.S > 2147483647LL || a.smem > 232448)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)a.S, (unsigned)m_tiles, (unsigned)(a.cout / BN));
  int_conv_halo_kernel<NT, MT, WN>
      <<<grid, kThreads, (size_t)a.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int NT, bool SHARED>
int launch_pixel(const QbnConvArgs& a, cudaStream_t stream) {
  constexpr int BN = 8 * NT;
  static const cudaError_t attr = cudaFuncSetAttribute(
      int_conv_pixel_kernel<NT, SHARED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (attr != cudaSuccess) return (int)attr;
  const long long m_tiles = (a.B * a.Ho * a.Wo + kBM - 1) / kBM;
  const long long s_tiles = a.s_cta > 0 ? (a.S + a.s_cta - 1) / a.s_cta : 0;
  const long long K = a.kh * a.kw * a.cin;
  const bool ok_src = SHARED ? (K <= kBK && a.x_ss == 0)
                             : (a.kh == 1 && a.kw == 1 && a.pad == 0 &&
                                a.cin % a.vx == 0 && a.vx >= 4);
  if (a.bm != kBM || a.cout % BN != 0 || a.sg < 1 || a.s_cta < a.sg ||
      a.s_cta % a.sg != 0 || !ok_src || a.vo < 1 ||
      m_tiles > 2147483647LL || a.cout / BN > 65535 || s_tiles > 65535 ||
      a.smem > 232448)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)m_tiles, (unsigned)(a.cout / BN),
                  (unsigned)s_tiles);
  int_conv_pixel_kernel<NT, SHARED>
      <<<grid, kThreads, (size_t)a.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int BN, bool WS>
int launch_wide(const QbnConvArgs& a, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      int_conv_kernel_wide<BN, WS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (attr != cudaSuccess) return (int)attr;
  const long long K = a.kh * a.kw * a.cin;
  const long long tiles =
      (a.B * a.Ho * a.Wo + kBM - 1) / kBM * (a.cout / BN) * a.sg;
  if (a.bm != kBM || a.cout % BN != 0 || a.cin % 16 != 0 ||
      a.ring != wide_ring<BN>() || a.kc != kWideBK || a.wt == nullptr ||
      a.koff == nullptr || a.sg < 1 || tiles > 2147483647LL ||
      a.S > 65535 || a.smem > 232448)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 tgrid((unsigned)((K + 63) / 64), (unsigned)(a.cout / 64),
                   WS ? 1u : (unsigned)a.S);
  int_conv_kernel_wide_wt<<<tgrid, kThreads, 0, stream>>>(a.w, a.wt, (int)K,
                                                         (int)a.cout);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)tiles, (unsigned)((a.S + a.sg - 1) / a.sg));
  int_conv_kernel_wide<BN, WS><<<grid, kThreads, (size_t)a.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int qbn_int_conv(const QbnConvArgs* a, void* stream) {
  const long long M = a->B * a->Ho * a->Wo;
  if (M <= 0 || a->S <= 0 || a->cout <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->pixel) {   // the BN = 8 NT the plan may choose, shared x or not
    const bool shared = a->x_ss == 0;
    if (a->nt == 3) return shared ? launch_pixel<3, true>(*a, st)
                                  : launch_pixel<3, false>(*a, st);
    if (a->nt == 6) return shared ? launch_pixel<6, true>(*a, st)
                                  : launch_pixel<6, false>(*a, st);
    if (a->nt == 12) return shared ? launch_pixel<12, true>(*a, st)
                                   : launch_pixel<12, false>(*a, st);
    return (int)cudaErrorInvalidConfiguration;
  }
  if (a->wide) {   // 128 or 64 channels a CTA, per-sample or shared w
    const bool ws = a->w_ss == 0;
    if (a->nt == 16) return ws ? launch_wide<128, true>(*a, st)
                               : launch_wide<128, false>(*a, st);
    if (a->nt == 8) return ws ? launch_wide<64, true>(*a, st)
                              : launch_wide<64, false>(*a, st);
    return (int)cudaErrorInvalidConfiguration;
  }
  if (a->halo) {   // the (nt, mt, wn) the plan may choose
    const long long key = a->nt * 100 + a->mt * 10 + a->wn;
    if (key == 321) return launch_halo<3, 2, 1>(*a, st);
    if (key == 621) return launch_halo<6, 2, 1>(*a, st);
    if (key == 1222) return launch_halo<12, 2, 2>(*a, st);
    return (int)cudaErrorInvalidConfiguration;
  }
  const long long m_tiles = (M + kBM - 1) / kBM;
  const long long nt = (a->cout + 7) / 8;
  if (nt <= 1) return launch<1>(*a, m_tiles, st);
  if (nt <= 3) return launch<3>(*a, m_tiles, st);
  if (nt <= 6) return launch<6>(*a, m_tiles, st);
  return launch<12>(*a, m_tiles, st);
}

// Bytes of QbnConvArgs, so that the caller can check its own layout.
extern "C" int qbn_int_conv_args_size() { return (int)sizeof(QbnConvArgs); }
