// Counter-based normal draws shared by the port's kernels: Philox-4x32-10
// (Salmon et al., SC'11) and the Box-Muller transform. A kernel keys the
// generator with a 64-bit seed and makes each counter unique to the value
// it draws, so a launch needs no generator state in device memory.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace qbn {

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
  const uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  const uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(kM0, ctr.x), lo0 = kM0 * ctr.x;
    const uint32_t hi1 = __umulhi(kM1, ctr.z), lo1 = kM1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
    key.x += kW0;
    key.y += kW1;
  }
  return ctr;
}

// Two standard normals from two uint32 (Box-Muller): u1 in (0, 1] keeps
// the log finite, u2 in [0, 1).
__device__ __forceinline__ void box_muller(uint32_t a, uint32_t b,
                                           float* z0, float* z1) {
  const float u1 = (float)((a >> 8) + 1u) * 0x1.0p-24f;
  const float u2 = (float)(b >> 8) * 0x1.0p-24f;
  const float r = sqrtf(-2.0f * logf(u1));
  float s, c;
  sincospif(2.0f * u2, &s, &c);
  *z0 = r * c;
  *z1 = r * s;
}

}  // namespace qbn
