// The rank buckets' sums of the latency sketch, for Hopper (sm_90a).
//
// No Pallas kernel stands behind it: the reference builds its sketch with
// jnp (src/repro/distributed/sketch.py:47, _bucketize), whose two float32
// scatter-adds XLA's CPU backend runs one entry after another in index
// order. This kernel gives the card the same sums, bit for bit, so that a
// sketch built on the card equals the one built on the CPU and the
// reference's.
//
// What it computes, for each lane r and bucket k of a [lanes, m] input
// whose rows are sorted by bucket (b non-decreasing along a row, as the
// sketch's CDF midpoints are):
//   wsum[r, k] = sum of w[r, i]  over the i with b[r, i] == k
//   vsum[r, k] = sum of wv[r, i] over the same i
// each a float32 sum from +0.0 in the order of i, one rounding per add.
//
// Design. A bucket's entries are a contiguous run of its row, so a warp
// takes one (lane, bucket): it finds the run's two ends by binary search
// (every thread of the warp alike), then reads the run 32 entries at a
// time, coalesced, kUnroll chunks ahead. Adding a zero term (+0.0 or -0.0)
// to a sum that started at +0.0 leaves it as it is in round-to-nearest, so
// the warp adds only the nonzero terms: a ballot marks them, and every
// thread adds them in index order from shuffles, so that each thread
// holds the same sums. Most of a row is zero-weight (batch records that
// never committed or fell before the warm-up), and those are read and
// skipped at the rate of the loads; the nonzero terms, a few hundred a
// bucket at the simulator's scale, are added one after another.
//
// Bound on this card: bytes. A launch must read w and wv once (8 bytes an
// entry), probe b by binary search and write 8 bytes a bucket: at the
// Fig-6 grid's 16 lanes of 5 x 10 000 batch records that is 6.4 MB, about
// 2 us at 3.35 TB/s. The time is set above that by the fullest bucket's
// warp, which walks its run alone, one dependent step per 128 entries.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kUnroll = 4;        // 32-entry chunks a warp loads at once

// First index in row[0, m) whose bucket is >= key.
__device__ __forceinline__ int lower_bound(const int32_t* row, int m,
                                           int key) {
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (row[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(32)
    bucket_sums_kernel(const int32_t* __restrict__ b,
                       const float* __restrict__ w,
                       const float* __restrict__ wv,
                       float* __restrict__ wsum, float* __restrict__ vsum,
                       int m, int bins) {
  const int bucket = blockIdx.x;
  const size_t row = blockIdx.y;
  const int lane = threadIdx.x;
  const int32_t* brow = b + row * m;
  const float* wrow = w + row * m;
  const float* vrow = wv + row * m;
  const int lo = lower_bound(brow, m, bucket);
  const int hi = lower_bound(brow, m, bucket + 1);
  float acc_w = 0.0f, acc_v = 0.0f;
  for (int base = lo; base < hi; base += 32 * kUnroll) {
    float xw[kUnroll], xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * 32 + lane;
      xw[u] = i < hi ? wrow[i] : 0.0f;
      xv[u] = i < hi ? vrow[i] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      unsigned live = __ballot_sync(kFull, xw[u] != 0.0f || xv[u] != 0.0f);
      while (live) {
        const int src = __ffs(live) - 1;
        live &= live - 1;
        acc_w = __fadd_rn(acc_w, __shfl_sync(kFull, xw[u], src));
        acc_v = __fadd_rn(acc_v, __shfl_sync(kFull, xv[u], src));
      }
    }
  }
  if (lane == 0) {
    wsum[row * bins + bucket] = acc_w;
    vsum[row * bins + bucket] = acc_v;
  }
}

}  // namespace

extern "C" {

// b: [lanes, m] int32, each row non-decreasing in [0, bins); w, wv:
// [lanes, m] float32; wsum, vsum: [lanes, bins] float32, written whole.
// All contiguous on device `device`. Launches one warp per (bucket, lane)
// on `stream` (a cudaStream_t) and returns cudaGetLastError() as an int
// (0 = launched).
int sketch_bucket_sums_launch(const void* b, const void* w, const void* wv,
                              void* wsum, void* vsum, int lanes, int m,
                              int bins, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (lanes < 0 || m < 0 || bins < 1 || bins > 65535 || lanes > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (lanes == 0) return 0;
  const dim3 grid(bins, lanes);
  bucket_sums_kernel<<<grid, 32, 0, (cudaStream_t)stream>>>(
      (const int32_t*)b, (const float*)w, (const float*)wv, (float*)wsum,
      (float*)vsum, m, bins);
  return (int)cudaGetLastError();
}

const char* sketch_bucket_sums_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
