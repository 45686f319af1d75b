// Antithetic PGPE population on Hopper:
//   out[2i]   = mu + sigma * e_i
//   out[2i+1] = mu - sigma * e_i          for i in [0, num_directions)
//
// Replaces the TPU kernel evotorch_tpu/ops/sampling.py:_pallas_kernel (and its
// injected-noise twin _pallas_kernel_with_noise). On the TPU the noise came
// from the on-chip PRNG and never reached HBM; here it comes from
// Philox4x32-10, written into the kernel and keyed by a (seed, offset) pair
// that the wrapper draws from the caller's torch.Generator, so the noise
// never reaches device memory either.
//
// Bound on the H100: memory. At popsize 10,000 x L 12,305 the kernel writes
// 492 MB and reads almost nothing (mu, sigma: 98 KB), so the least time is the
// write at 3.35 TB/s (0.147 ms). What stands in the way is instruction issue:
// Philox (10 rounds of two mul-hi, two mul-lo and xors) and accurate log,
// sqrt, sin and cos, with no fast math.
//
// Design:
// - Four normals per Philox call. The counter (q, i, offset) gives the four
//   words of columns 4q..4q+3 of direction i: two Box-Muller pairs, each with
//   one log and one sqrt for both the cosine and the sine of one angle
//   (sincosf). The angle is the float32 product 2*pi*u2, as in the plain
//   version, so kernel and plain version compute the same functions.
// - Aligned 16-byte stores. Each thread owns the 4 columns of one group q.
//   Row r begins at float offset r*L, so its 16-byte boundaries fall at
//   columns a + 4k with a = -(r*L) mod 4, and the plus and minus rows of one
//   direction may differ in a. Each lane stores the aligned 4 columns that
//   start at its own column 4q + a: its own last 4 - a values and the first
//   a of the next lane, taken with warp shuffles. Lane 31 stores only its
//   own part and lane 0 also the a columns before its window (a warp owns
//   128 whole columns), as scalars; so does the last group of a row, masked
//   at L. A warp whose columns all lie past L exits at once. The stores are
//   plain st.global: st.global.cs (evict first; the 492 MB output is ten
//   times the 50 MB L2) measured 9% slower at this launch shape (H100; see
//   PERF.md), perhaps because the partial 32-byte sectors at the warps'
//   edges, written by two warps, then leave the L2 before they are whole.
// - Many blocks, each walking a few directions. Each block keeps mu and
//   sigma for its columns (its own 4 and the next lane's first 3) in
//   registers and walks every gy-th direction; a is the same for the whole
//   block in each direction, so the switch on it does not diverge. gy makes
//   kWaves = 16 times the blocks that fit on the card at once, so a block
//   walks ~7 of the flagship's 5,000 directions. One wave of blocks walking
//   ~106 each measured 42% slower, and 64 waves 13% slower (PERF.md).
// The scale and the +/- use __fmul_rn/__fadd_rn/__fsub_rn so that nvcc
// cannot contract them into an FMA: the result is then the same float32
// arithmetic as the plain PyTorch version (and the JAX reference).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kGroupsPerBlock = kThreads;  // 4 columns per thread
constexpr int kWaves = 16;                 // blocks launched, in multiples of those resident at once
constexpr int kNoiseThreads = 256;
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// Bits -> float in [1, 2) by the mantissa trick (as the TPU kernel's
// _bits_to_unit_float), then Box-Muller with u1 in (0, 1] so log never sees
// 0: the radius from bits_a, the angle from bits_b, both normals of the pair.
__device__ __forceinline__ void box_muller(uint32_t bits_a, uint32_t bits_b, float& n_cos, float& n_sin) {
  const float u1 = __fsub_rn(2.0f, __uint_as_float((bits_a >> 9) | 0x3F800000u));
  const float u2 = __fsub_rn(__uint_as_float((bits_b >> 9) | 0x3F800000u), 1.0f);
  const float radius = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  float s, c;
  sincosf(__fmul_rn(6.28318530717958647692f, u2), &s, &c);
  n_cos = __fmul_rn(radius, c);
  n_sin = __fmul_rn(radius, s);
}

// Stores one row's values for the columns this lane is responsible for,
// with A = a: v[0..6] are the row's values at columns 4q .. 4q + 6 (v[4..6]
// from the next lane), and the lane stores v[A..A+3] at 4q + A.
template <int A>
__device__ __forceinline__ void store_row(float* row, int64_t col0, int64_t length, int lane,
                                          const float (&v)[7]) {
  const int64_t c = col0 + A;
  if ((A == 0 || lane < 31) && c + 4 <= length) {
    *reinterpret_cast<float4*>(row + c) = make_float4(v[A], v[A + 1], v[A + 2], v[A + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if ((A + k < 4 || lane < 31) && c + k < length) row[c + k] = v[A + k];
    }
  }
  if (A > 0 && lane == 0) {
#pragma unroll
    for (int k = 0; k < A; ++k) {
      if (col0 + k < length) row[col0 + k] = v[k];
    }
  }
}

__device__ __forceinline__ void store_row_phase(float* row, int a, int64_t col0, int64_t length, int lane,
                                                const float (&v)[7]) {
  switch (a) {
    case 0: store_row<0>(row, col0, length, lane, v); break;
    case 1: store_row<1>(row, col0, length, lane, v); break;
    case 2: store_row<2>(row, col0, length, lane, v); break;
    default: store_row<3>(row, col0, length, lane, v); break;
  }
}

__global__ void __launch_bounds__(kThreads) symmetric_gaussian_philox_kernel(
    const float* __restrict__ mu, const float* __restrict__ sigma, const uint32_t* __restrict__ seed,
    float* __restrict__ out, int64_t num_directions, int64_t length) {
  const int lane = threadIdx.x & 31;
  const int64_t q = static_cast<int64_t>(blockIdx.x) * kGroupsPerBlock + threadIdx.x;
  const int64_t col0 = 4 * q;
  if (col0 - 4 * lane >= length) return;  // the whole warp lies past the row's end
  // seed[0..1]: Philox key; seed[2..3]: the offset, the counter's high words
  const uint32_t k0 = seed[0], k1 = seed[1], off_lo = seed[2], off_hi = seed[3];
  // mu and sigma of the own 4 columns and of the next lane's first 3
  float m[7], s[7];
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    const bool in = col0 + k < length;
    m[k] = in ? mu[col0 + k] : 0.0f;
    s[k] = in ? sigma[col0 + k] : 0.0f;
  }
  for (int64_t i = blockIdx.y; i < num_directions; i += gridDim.y) {
    const uint4 bits = philox4x32_10(
        make_uint4(static_cast<uint32_t>(q), static_cast<uint32_t>(i), off_lo, off_hi), k0, k1);
    float e[7];
    box_muller(bits.x, bits.y, e[0], e[1]);
    box_muller(bits.z, bits.w, e[2], e[3]);
#pragma unroll
    for (int k = 0; k < 3; ++k) e[4 + k] = __shfl_down_sync(0xFFFFFFFFu, e[k], 1);
    float plus[7], minus[7];
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      const float scaled = __fmul_rn(e[k], s[k]);
      plus[k] = __fadd_rn(m[k], scaled);
      minus[k] = __fsub_rn(m[k], scaled);
    }
    const int64_t plus_start = (2 * i) * length;
    float* plus_row = out + plus_start;
    const int a_plus = static_cast<int>((-plus_start) & 3);
    const int a_minus = static_cast<int>((-(plus_start + length)) & 3);
    store_row_phase(plus_row, a_plus, col0, length, lane, plus);
    store_row_phase(plus_row + length, a_minus, col0, length, lane, minus);
  }
}

__device__ __forceinline__ void store_pair(float* plus_row, float* minus_row, int64_t j, float mu,
                                           float sigma, float e) {
  const float scaled = __fmul_rn(e, sigma);
  plus_row[j] = __fadd_rn(mu, scaled);
  minus_row[j] = __fsub_rn(mu, scaled);
}

__global__ void symmetric_gaussian_noise_kernel(const float* __restrict__ mu,
                                                const float* __restrict__ sigma,
                                                const float* __restrict__ eps,
                                                float* __restrict__ out, int64_t num_directions,
                                                int64_t length) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kNoiseThreads + threadIdx.x;
  if (j >= length) return;
  const float m = mu[j], s = sigma[j];
  for (int64_t i = blockIdx.y; i < num_directions; i += gridDim.y) {
    float* plus_row = out + (2 * i) * length;
    store_pair(plus_row, plus_row + length, j, m, s, eps[i * length + j]);
  }
}

int64_t clamp_grid_y(int64_t want, int64_t num_directions) {
  int64_t gy = want < num_directions ? want : num_directions;
  if (gy > kMaxGridY) gy = kMaxGridY;
  return gy < 1 ? 1 : gy;
}

}  // namespace

// seed: 4 uint32 on the device (key low, key high, offset low, offset high).
extern "C" int evt_symmetric_gaussian_philox(const void* mu, const void* sigma, const void* seed,
                                             void* out, int64_t num_directions, int64_t length,
                                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, symmetric_gaussian_philox_kernel, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t groups = (length + 3) / 4;
  const int64_t gx = (groups + kGroupsPerBlock - 1) / kGroupsPerBlock;
  // kWaves waves of resident blocks, each walking num_directions / gy
  // directions
  const int64_t resident = static_cast<int64_t>(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  const int64_t want = kWaves * resident / gx > 0 ? kWaves * resident / gx : 1;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(clamp_grid_y(want, num_directions)));
  symmetric_gaussian_philox_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mu), static_cast<const float*>(sigma),
      static_cast<const uint32_t*>(seed), static_cast<float*>(out), num_directions, length);
  return static_cast<int>(cudaGetLastError());
}

// eps: (num_directions, length) float32, the injected standard-normal noise.
extern "C" int evt_symmetric_gaussian_noise(const void* mu, const void* sigma, const void* eps,
                                            void* out, int64_t num_directions, int64_t length,
                                            int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((length + kNoiseThreads - 1) / kNoiseThreads),
                  static_cast<unsigned>(clamp_grid_y(num_directions, num_directions)));
  symmetric_gaussian_noise_kernel<<<grid, kNoiseThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mu), static_cast<const float*>(sigma),
      static_cast<const float*>(eps), static_cast<float*>(out), num_directions, length);
  return static_cast<int>(cudaGetLastError());
}
