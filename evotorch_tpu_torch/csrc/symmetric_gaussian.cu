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
// write at 3.35 TB/s (0.147 ms). One Philox call (10 rounds, ~60 integer ops)
// feeds two Box-Muller normals, i.e. two adjacent columns of one direction,
// which keeps the arithmetic below the write time.
//
// Design: one thread per (direction, column pair). Neighbouring threads own
// neighbouring column pairs, so each warp stores 256 contiguous bytes into
// each of the two interleaved rows it writes: the stores are coalesced and
// the interleave costs nothing (the TPU needed a two-plane output and a
// transpose only because Mosaic cannot lower strided stores). L is odd at the
// flagship width, so the last pair of each row writes one column; the mask is
// in the kernel. The scale and the +/- use __fmul_rn/__fadd_rn/__fsub_rn so
// that nvcc cannot contract them into an FMA: the result is then the same
// float32 arithmetic as the plain PyTorch version (and the JAX reference).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
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
// _bits_to_unit_float), then Box-Muller with u1 in (0, 1] so log never sees 0.
__device__ __forceinline__ float box_muller(uint32_t bits_a, uint32_t bits_b) {
  const float u1 = 2.0f - __uint_as_float((bits_a >> 9) | 0x3F800000u);
  const float u2 = __uint_as_float((bits_b >> 9) | 0x3F800000u) - 1.0f;
  return sqrtf(-2.0f * logf(u1)) * cosf(6.28318530717958647692f * u2);
}

__device__ __forceinline__ void store_pair(float* plus_row, float* minus_row, int64_t j, float mu,
                                           float sigma, float e) {
  const float scaled = __fmul_rn(e, sigma);
  plus_row[j] = __fadd_rn(mu, scaled);
  minus_row[j] = __fsub_rn(mu, scaled);
}

__global__ void symmetric_gaussian_philox_kernel(const float* __restrict__ mu,
                                                 const float* __restrict__ sigma,
                                                 const uint32_t* __restrict__ seed,
                                                 float* __restrict__ out, int64_t num_directions,
                                                 int64_t length) {
  const int64_t pair = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t j0 = 2 * pair;
  if (j0 >= length) return;
  const bool has_second = j0 + 1 < length;
  // seed[0..1]: Philox key; seed[2..3]: the offset, the counter's high words
  const uint32_t k0 = seed[0], k1 = seed[1], off_lo = seed[2], off_hi = seed[3];
  const float mu0 = mu[j0], sigma0 = sigma[j0];
  const float mu1 = has_second ? mu[j0 + 1] : 0.0f;
  const float sigma1 = has_second ? sigma[j0 + 1] : 0.0f;
  for (int64_t i = blockIdx.y; i < num_directions; i += gridDim.y) {
    const uint4 bits = philox4x32_10(
        make_uint4(static_cast<uint32_t>(pair), static_cast<uint32_t>(i), off_lo, off_hi), k0, k1);
    float* plus_row = out + (2 * i) * length;
    float* minus_row = plus_row + length;
    store_pair(plus_row, minus_row, j0, mu0, sigma0, box_muller(bits.x, bits.y));
    if (has_second) store_pair(plus_row, minus_row, j0 + 1, mu1, sigma1, box_muller(bits.z, bits.w));
  }
}

__global__ void symmetric_gaussian_noise_kernel(const float* __restrict__ mu,
                                                const float* __restrict__ sigma,
                                                const float* __restrict__ eps,
                                                float* __restrict__ out, int64_t num_directions,
                                                int64_t length) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= length) return;
  const float m = mu[j], s = sigma[j];
  for (int64_t i = blockIdx.y; i < num_directions; i += gridDim.y) {
    float* plus_row = out + (2 * i) * length;
    store_pair(plus_row, plus_row + length, j, m, s, eps[i * length + j]);
  }
}

dim3 grid_for(int64_t columns, int64_t num_directions) {
  const int64_t gx = (columns + kThreads - 1) / kThreads;
  const int64_t gy = num_directions < kMaxGridY ? num_directions : kMaxGridY;
  return dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
}

}  // namespace

// seed: 4 uint32 on the device (key low, key high, offset low, offset high).
extern "C" int evt_symmetric_gaussian_philox(const void* mu, const void* sigma, const void* seed,
                                             void* out, int64_t num_directions, int64_t length,
                                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t pairs = (length + 1) / 2;
  symmetric_gaussian_philox_kernel<<<grid_for(pairs, num_directions), kThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
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
  symmetric_gaussian_noise_kernel<<<grid_for(length, num_directions), kThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mu), static_cast<const float*>(sigma),
      static_cast<const float*>(eps), static_cast<float*>(out), num_directions, length);
  return static_cast<int>(cudaGetLastError());
}
