// Centered ranks on Hopper: out = rank / (n - 1) - 0.5 along the last axis.
//
// Replaces the TPU kernel evotorch_tpu/ops/ranking.py:_pallas_kernel. The
// rank of element i is the number of elements j that come before it in the
// total order (isnan, value, index): a smaller value, a non-NaN before a NaN,
// or an equal value (NaN equal to NaN, -0 equal to +0) at a smaller index.
// Ties therefore break stably by index and NaN orders last, as a stable
// argsort does.
//
// Bound on the H100: operations. The work is the n^2 comparison itself
// (10^8 pairs at n = 10,000); the bytes (n values in, n out) are negligible.
// The function needs two operations per (i, j) pair, one compare and one add
// to the count, so the least time is 2 * n^2 / 67 TFLOP/s (the card's
// float32 rate outside the tensor cores), ~3 us. Hopper issues the integer
// compares and adds that this kernel runs at half that rate.
//
// Design:
// - Keys on load. Each value is mapped once to an order-preserving unsigned
//   key (uint32 for float32, uint64 for float64): the sign flip for negate
//   first, -0 to +0, every NaN to the all-ones key (above +inf). "j comes
//   before i" is then one unsigned compare, and the tiles hold keys only.
// - No per-pair index logic. A j wholly before i counts key_j <= key_i, a j
//   wholly after it key_j < key_i; each is counted as the carry out of one
//   add (add_carry): an add and an add of the carry for uint32 keys, which
//   ptxas folds to 1.5 SASS instructions per pair (one add of two carries),
//   one more for uint64. Each thread owns kR consecutive i, so a warp owns
//   32 * kR consecutive i; only the shared-memory tiles that overlap the
//   warp's range (one or two of a row's) bring in the index, as the lowest word
//   of the same carry chain (add_carry_index, one instruction more per pair),
//   and the choice of path is uniform across the warp. A select of the
//   addend per pair there costs ~8 SASS instructions per pair, enough for
//   the warps that hold the diagonal to set the kernel's time.
// - Register blocking. Each thread keeps kR keys of i in registers and reads
//   the j keys from shared memory 16 bytes at a time; every lane reads the
//   same address (a broadcast, no bank conflict), and each load feeds
//   (16 / sizeof(key)) * kR compares.
// - j split across blocks. The grid is (i-tiles, j-splits, batch rows). The
//   splits are equal in length (boundaries on multiples of 16 j), and their
//   number is rounded up, where that costs at most twice as many, so that
//   the blocks are a whole multiple of the SM count: every SM then gets the
//   same work, where splits of whole tiles leave some SMs a block more than
//   the rest. A warp whose i are all past n only helps load the tiles.
//   Each block adds its partial counts into an int32 scratch with atomicAdd
//   (exact, so the result does not depend on the order of the adds); the
//   wrapper zeroes the scratch. A second, small kernel writes
//   count / (n - 1) - 0.5 with a true division.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Tile sizes, chosen by a sweep on the H100 (PERF.md).
constexpr int kThreads = 128;
constexpr int kR = 4;                  // i per thread
constexpr int kITile = kThreads * kR;  // i per block
constexpr int kWarpI = 32 * kR;        // i per warp
constexpr int kTile = 512;             // j keys staged in shared memory at a time
constexpr int kBlocksPerSm = 6;        // blocks the split aims at on each SM
constexpr int kSplitAlign = 16;        // j-split boundaries: whole 16-byte reads, 4 at a time
constexpr int kMaxGridYZ = 65535;
static_assert(kTile % kSplitAlign == 0 && kThreads % 32 == 0, "tiles of whole split groups; blocks of whole warps");
constexpr int kFinishThreads = 256;

__device__ __forceinline__ uint32_t order_key(float v, int negate) {
  if (negate) v = -v;
  if (v != v) return 0xFFFFFFFFu;
  uint32_t b = __float_as_uint(v);
  if ((b << 1) == 0u) b = 0u;  // -0 -> +0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ uint64_t order_key(double v, int negate) {
  if (negate) v = -v;
  if (v != v) return ~0ull;
  uint64_t b = static_cast<uint64_t>(__double_as_longlong(v));
  if ((b << 1) == 0ull) b = 0ull;
  return (b & 0x8000000000000000ull) ? ~b : (b | 0x8000000000000000ull);
}

// carry += the carry out of a + b, i.e. [b > ~a]: one add with carry out
// and one add of the carry in SASS (one more for 64-bit keys). Written in
// PTX because nvcc turns count += (x < y) into a compare, an add and a
// select, three instructions per pair.
__device__ __forceinline__ void add_carry(int& carry, uint32_t a, uint32_t b) {
  asm("{\n\t.reg .u32 t;\n\tadd.cc.u32 t, %1, %2;\n\taddc.u32 %0, %0, 0;\n\t}"
      : "+r"(carry)
      : "r"(a), "r"(b));
}

__device__ __forceinline__ void add_carry(int& carry, uint64_t a, uint64_t b) {
  asm("{\n\t.reg .u32 t;\n\tadd.cc.u32 t, %1, %3;\n\taddc.cc.u32 t, %2, %4;\n\taddc.u32 %0, %0, 0;\n\t}"
      : "+r"(carry)
      : "r"(static_cast<uint32_t>(a)), "r"(static_cast<uint32_t>(a >> 32)), "r"(static_cast<uint32_t>(b)),
        "r"(static_cast<uint32_t>(b >> 32)));
}

// The same with the index as the lowest word of the compare: carry +=
// [key_j + c > key_i] for a = ~key_i, where c = [jj >= e] is the carry of
// (jj + 1) + ~e. With e = i - j0 and jj = j - j0, c = [j >= i], so a j that
// ties with i counts as not before it exactly when it does not lie before it.
// One instruction more per pair than add_carry, and no select.
__device__ __forceinline__ void add_carry_index(int& carry, uint32_t not_e, uint32_t jj1, uint32_t a, uint32_t b) {
  asm("{\n\t.reg .u32 t;\n\tadd.cc.u32 t, %1, %2;\n\taddc.cc.u32 t, %3, %4;\n\taddc.u32 %0, %0, 0;\n\t}"
      : "+r"(carry)
      : "r"(not_e), "r"(jj1), "r"(a), "r"(b));
}

__device__ __forceinline__ void add_carry_index(int& carry, uint32_t not_e, uint32_t jj1, uint64_t a, uint64_t b) {
  asm("{\n\t.reg .u32 t;\n\tadd.cc.u32 t, %1, %2;\n\taddc.cc.u32 t, %3, %5;\n\taddc.cc.u32 t, %4, %6;\n\t"
      "addc.u32 %0, %0, 0;\n\t}"
      : "+r"(carry)
      : "r"(not_e), "r"(jj1), "r"(static_cast<uint32_t>(a)), "r"(static_cast<uint32_t>(a >> 32)),
        "r"(static_cast<uint32_t>(b)), "r"(static_cast<uint32_t>(b >> 32)));
}

// Counts, for each of the thread's kR keys ki[r], the keys of one shared
// tile that do NOT come before it, as carries of a[r] + key_j: with
// a = ~key_i the carry is [key_j > key_i], right for a j before i; with
// a = -key_i it is [key_j >= key_i], right for a j after i (no key is 0:
// key 0 would be a NaN's bits). kWhere: the tile lies wholly before the
// warp's i (kBefore), wholly after it (kAfter), or overlaps them (kOverlap),
// where add_carry_index brings in the index, d = i0 - j0. An i before the
// tile takes e = 0 (every j of the tile lies at or after it); for an i past
// the tile's end e >= len gives c = 0 by itself. len: the tile's keys, a
// multiple of kSplitAlign.
enum Where { kBefore, kAfter, kOverlap };

template <Where kWhere, typename K>
__device__ __forceinline__ void count_tile(const K* tile, int len, int d, const K (&ki)[kR], int (&carry)[kR]) {
  constexpr int kPerLoad = 16 / sizeof(K);
  K a[kR];
  uint32_t not_e[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    a[r] = kWhere == kAfter ? K(0) - ki[r] : ~ki[r];
    not_e[r] = ~static_cast<uint32_t>(d + r > 0 ? d + r : 0);
  }
  const uint4* vec = reinterpret_cast<const uint4*>(tile);
#pragma unroll 4
  for (int t = 0; t < len / kPerLoad; ++t) {
    const uint4 raw = vec[t];
    const K* kj = reinterpret_cast<const K*>(&raw);
#pragma unroll
    for (int u = 0; u < kPerLoad; ++u) {
      const uint32_t jj1 = static_cast<uint32_t>(t * kPerLoad + u + 1);
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (kWhere == kOverlap) {
          add_carry_index(carry[r], not_e[r], jj1, a[r], kj[u]);
        } else {
          add_carry(carry[r], a[r], kj[u]);
        }
      }
    }
  }
}

template <typename T, typename K>
__global__ void __launch_bounds__(kThreads) centered_rank_count_kernel(
    const T* __restrict__ x, int* __restrict__ counts, int64_t batch, int64_t n, int negate, int splits) {
  __shared__ __align__(16) K tile[kTile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t warp_i0 = static_cast<int64_t>(blockIdx.x) * kITile + warp * kWarpI;
  const int64_t i0 = warp_i0 + lane * kR;
  // this block's j: [j_begin, j_end), one of `splits` equal parts of n
  // rounded up to whole groups of kSplitAlign
  const int64_t groups = (n + kSplitAlign - 1) / kSplitAlign;
  const int64_t j_begin = kSplitAlign * (groups * blockIdx.y / splits);
  const int64_t j_end = kSplitAlign * (groups * (blockIdx.y + 1) / splits);
  for (int64_t row = blockIdx.z; row < batch; row += gridDim.z) {
    const T* xr = x + row * n;
    K ki[kR];
    int carry[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      ki[r] = i0 + r < n ? order_key(xr[i0 + r], negate) : ~K(0);
      carry[r] = 0;
    }
    for (int64_t j0 = j_begin; j0 < j_end; j0 += kTile) {
      const int len = static_cast<int>(j_end - j0 < kTile ? j_end - j0 : kTile);
      __syncthreads();
      for (int t = threadIdx.x; t < len; t += kThreads) {
        // past the end: the all-ones key, which no key is above, so a j
        // that lies after every i never counts (padding never lies before
        // an i below n)
        tile[t] = j0 + t < n ? order_key(xr[j0 + t], negate) : ~K(0);
      }
      __syncthreads();
      if (warp_i0 >= n) continue;  // the warp's i are all padding
      if (j0 + len <= warp_i0) {
        count_tile<kBefore>(tile, len, 0, ki, carry);
      } else if (j0 >= warp_i0 + kWarpI) {
        count_tile<kAfter>(tile, len, 0, ki, carry);
      } else {
        count_tile<kOverlap>(tile, len, static_cast<int>(i0 - j0), ki, carry);
      }
    }
    // every j of the split (padding included) that is not counted as a
    // carry comes before i
    const int processed = static_cast<int>(j_end - j_begin);
    int* cr = counts + row * n;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (i0 + r < n) atomicAdd(cr + i0 + r, processed - carry[r]);
    }
  }
}

template <typename T>
__global__ void centered_rank_finish_kernel(const int* __restrict__ counts, T* __restrict__ out,
                                            int64_t total, int64_t n) {
  const T denom = static_cast<T>(n - 1);
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * kFinishThreads + threadIdx.x; k < total;
       k += static_cast<int64_t>(gridDim.x) * kFinishThreads) {
    out[k] = static_cast<T>(counts[k]) / denom - T(0.5);
  }
}

int sm_count(int device) {
  int value = 0;
  cudaDeviceGetAttribute(&value, cudaDevAttrMultiProcessorCount, device);
  return value > 0 ? value : 1;
}

template <typename T, typename K>
int launch(const void* x, void* counts, void* out, int64_t batch, int64_t n, int negate, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t i_tiles = (n + kITile - 1) / kITile;
  const int64_t rows = batch < kMaxGridYZ ? batch : kMaxGridYZ;
  const int64_t sms = sm_count(device);
  // enough j-splits for kBlocksPerSm blocks on every SM, rounded up to a
  // whole multiple of the SM count where that at most doubles them; at least
  // kSplitAlign j per split
  const int64_t column = i_tiles * rows;
  int64_t splits = (kBlocksPerSm * sms + column - 1) / column;
  for (int64_t more = splits; more <= 2 * splits; ++more) {
    if (column * more % sms == 0) {
      splits = more;
      break;
    }
  }
  const int64_t groups = (n + kSplitAlign - 1) / kSplitAlign;
  if (splits > groups) splits = groups;
  if (splits > kMaxGridYZ) splits = kMaxGridYZ;
  const dim3 grid(static_cast<unsigned>(i_tiles), static_cast<unsigned>(splits), static_cast<unsigned>(rows));
  centered_rank_count_kernel<T, K><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<int*>(counts), batch, n, negate, static_cast<int>(splits));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = batch * n;
  int64_t blocks = (total + kFinishThreads - 1) / kFinishThreads;
  if (blocks > 65535) blocks = 65535;
  centered_rank_finish_kernel<T><<<static_cast<unsigned>(blocks), kFinishThreads, 0, s>>>(
      static_cast<const int*>(counts), static_cast<T*>(out), total, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: (batch, n) contiguous, n >= 2; counts: (batch, n) int32, zeroed by
// the caller. negate != 0 ranks -x (minimisation).
extern "C" int evt_centered_rank_f32(const void* x, void* counts, void* out, int64_t batch, int64_t n,
                                     int negate, int device, void* stream) {
  return launch<float, uint32_t>(x, counts, out, batch, n, negate, device, stream);
}

extern "C" int evt_centered_rank_f64(const void* x, void* counts, void* out, int64_t batch, int64_t n,
                                     int negate, int device, void* stream) {
  return launch<double, uint64_t>(x, counts, out, batch, n, negate, device, stream);
}
