// Fused channel-ring commit of one simulator tick, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/channel_ring/kernel.py::_commit_kernel
//   (wrapper ring_commit_tpu, pallas_call at kernel.py:90).
//
// What it computes, against the packed ring buf [B, D, n, n, K] float32
// (B grid lanes, D ring slots, n senders x n receivers, K fields):
//   1. slot t % D of every lane is reset to the per-field fill vector;
//   2. for each of the tick's E send entries e, with static layout
//      (off, w, flag_off, additive, value offset), the payload
//      vals[b, i, j, voff : voff + w] is max-merged (add-merged when
//      additive) into fields off .. off + w - 1 of slot slots[b, i, j, e],
//      and flags[b, i, j, e] is max-merged into field flag_off there.
//
// Design. The Pallas kernel makes a dense O(D * n^2 * K) pass over the ring
// because scatters serialize on the TPU. Here each thread owns one
// (b, i, j, k) column of the ring across all D slots: it writes fill[k] into
// slot t % D, then walks the entries in order and merges every entry whose
// field span covers k into its target slot. A column has exactly one owner,
// so there are no atomics and the result is bitwise equal to the plain
// PyTorch version (clear, one scatter-max, one scatter-add): max is
// order-free, an additive channel sends at most once per tick, and the
// clear comes first in both. Work is O(n^2 * K * E) per lane per tick,
// independent of D.
//
// Bound on this card: bytes. Each launch reads the packed entries and the
// ring cells they target and writes those cells and the cleared slot, a few
// hundred kilobytes at the main path's shapes (B=16, n=5, K=50, E=8), so
// at 3.35 TB/s the bound is well under a microsecond and a launch costs
// what launching costs.
//
// A target slot outside [0, D) is skipped (the reference's XLA scatter
// drops out-of-range updates the same way); the wrapper only ever passes
// slots (t + clip(delay, 1, D - 1)) % D.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLayoutCols = 5;  // off, w, flag_off, additive, value offset
constexpr int kThreads = 256;

__global__ void commit_kernel(float* __restrict__ buf,
                              const float* __restrict__ fill,
                              const int32_t* __restrict__ slots,
                              const float* __restrict__ vals,
                              const float* __restrict__ flags,
                              const int32_t* __restrict__ layout,
                              int B, int D, int n, int K, int E, int W,
                              int t_slot) {
  extern __shared__ int32_t lay[];
  for (int x = threadIdx.x; x < kLayoutCols * E; x += blockDim.x) {
    lay[x] = layout[x];
  }
  __syncthreads();

  const long long nn = (long long)n * n;
  const long long total = (long long)B * nn * K;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= total) return;
  const int k = (int)(tid % K);
  const long long bij = tid / K;            // (b * n + i) * n + j
  const long long b = bij / nn;
  const long long ij = bij - b * nn;
  const long long slot_stride = nn * K;     // one slot of one lane
  float* lane = buf + b * (long long)D * slot_stride + ij * K + k;

  lane[(long long)t_slot * slot_stride] = fill[k];

  const int32_t* s = slots + bij * E;
  const float* v = vals + bij * W;
  const float* f = flags + bij * E;
  for (int e = 0; e < E; ++e) {
    const int32_t* l = lay + kLayoutCols * e;
    const int off = l[0], w = l[1], flag_off = l[2], additive = l[3];
    float x;
    bool add = false;
    if (k >= off && k < off + w) {
      x = v[l[4] + (k - off)];
      add = additive != 0;
    } else if (k == flag_off) {
      x = f[e];
    } else {
      continue;
    }
    const int slot = s[e];
    if (slot < 0 || slot >= D) continue;
    float* p = lane + (long long)slot * slot_stride;
    const float cur = *p;
    *p = add ? cur + x : (x > cur ? x : cur);
  }
}

}  // namespace

extern "C" {

// Launches the commit on `stream` (a cudaStream_t) of device `device` and
// returns cudaGetLastError() as an int (0 = launched).
int channel_ring_commit(void* buf, const void* fill, const void* slots,
                        const void* vals, const void* flags,
                        const void* layout, int B, int D, int n, int K,
                        int E, int W, int t, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)B * n * n * K;
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  commit_kernel<<<(unsigned)blocks, kThreads, kLayoutCols * E * sizeof(int32_t),
                  (cudaStream_t)stream>>>(
      (float*)buf, (const float*)fill, (const int32_t*)slots,
      (const float*)vals, (const float*)flags, (const int32_t*)layout,
      B, D, n, K, E, W, t % D);
  return (int)cudaGetLastError();
}

const char* channel_ring_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
