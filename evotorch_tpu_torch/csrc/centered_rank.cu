// Centered ranks on Hopper: out = rank / (n - 1) - 0.5 along the last axis.
//
// Replaces the TPU kernel evotorch_tpu/ops/ranking.py:_pallas_kernel. The
// rank of element i is the number of elements j that come before it in the
// total order (isnan, value, index): a smaller value, a non-NaN before a NaN,
// or an equal value (NaN equal to NaN) at a smaller index. Ties therefore
// break stably by index and NaN orders last, as a stable argsort does.
//
// Bound on the H100: operations. The work is the n^2 comparison itself
// (10^8 at n = 10,000); the bytes (n values in, n out) are negligible. The
// function needs two operations per (i, j) pair: once each value is mapped
// (O(n) work) to an order-preserving integer key (NaN above +inf, -0 equal to
// +0), the order is one integer compare (key_j <= key_i for j < i, key_j <
// key_i for j > i) plus the add to the count. So the least time is
// 2 * n^2 / 67 TFLOP/s (the card's non-tensor-core float32 rate), ~3 us. The
// inner loop below spends about 12 operations per pair instead (three float
// compares, seven logic ops, two adds); the key transform would remove most.
//
// Design: one thread per i. Each block stages tiles of j (values and NaN
// flags) in shared memory and walks over all n, so, unlike the TPU kernel and
// its VMEM-sized comparison block, n has no upper limit. gridDim.y covers the
// batch rows. The sign flip for minimisation is applied on load.
// Fill: at n = 10,000 with 256 threads only 40 blocks exist for 132 SMs, so
// two thirds of the card idles; splitting j across blocks (and summing the
// partial counts) is the next step for this kernel.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

template <typename T>
__global__ void centered_rank_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t batch,
                                     int64_t n, int negate) {
  __shared__ T tile_value[kThreads];
  __shared__ int tile_nan[kThreads];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const T sign = negate ? T(-1) : T(1);
  for (int64_t row = blockIdx.y; row < batch; row += gridDim.y) {
    const T* xr = x + row * n;
    const T xi = i < n ? sign * xr[i] : T(0);
    const bool nan_i = xi != xi;
    int64_t count = 0;
    for (int64_t base = 0; base < n; base += kThreads) {
      const int64_t j = base + threadIdx.x;
      if (j < n) {
        const T v = sign * xr[j];
        tile_value[threadIdx.x] = v;
        tile_nan[threadIdx.x] = v != v;
      }
      __syncthreads();
      const int len = n - base < kThreads ? static_cast<int>(n - base) : kThreads;
      for (int t = 0; t < len; ++t) {
        const T xj = tile_value[t];
        const bool nan_j = tile_nan[t];
        const bool value_smaller = (xj < xi) | (!nan_j & nan_i);
        const bool equal = (xj == xi) | (nan_j & nan_i);
        const bool earlier = base + t < i;
        count += value_smaller | (equal & earlier);
      }
      __syncthreads();
    }
    if (i < n) out[row * n + i] = static_cast<T>(count) / static_cast<T>(n - 1) - T(0.5);
  }
}

template <typename T>
int launch(const void* x, void* out, int64_t batch, int64_t n, int negate, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads),
                  static_cast<unsigned>(batch < kMaxGridY ? batch : kMaxGridY));
  centered_rank_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<T*>(out), batch, n, negate);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: (batch, n) contiguous, n >= 2. negate != 0 ranks -x (minimisation).
extern "C" int evt_centered_rank_f32(const void* x, void* out, int64_t batch, int64_t n,
                                     int negate, int device, void* stream) {
  return launch<float>(x, out, batch, n, negate, device, stream);
}

extern "C" int evt_centered_rank_f64(const void* x, void* out, int64_t batch, int64_t n,
                                     int negate, int device, void* stream) {
  return launch<double>(x, out, batch, n, negate, device, stream);
}
