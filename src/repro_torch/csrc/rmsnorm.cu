// Fused (residual +) RMSNorm over the rows of [N, D], for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/rmsnorm/kernel.py::_rmsnorm_kernel and
//   ::_rmsnorm_res_kernel (wrapper rmsnorm_2d, pallas_call at kernel.py:46).
//
// What it computes, for each row r of x [N, D] (float32 or bfloat16):
//   v   = x[r] (+ residual[r]), in float32
//   out = v * rsqrt(mean(v * v) + eps) * w, in float32, stored as x's type.
// w [D] arrives as float32 (the wrapper converts it).
//
// Design. The TPU kernel tiles [256, D] rows into VMEM and reduces each row
// in vector registers. Here one warp owns one row: each lane strides over
// the row 32 elements apart (so a warp's loads are coalesced), sums its
// squares in float32, and a butterfly of shuffles gives every lane the
// row's sum. The second pass reads the row again (from L1: a row is at
// most a few tens of kilobytes) and writes the output. Eight warps, eight
// rows, to a block.
//
// Bound on this card: bytes. A launch must read x (and the residual) and w
// once and write the output once: at the prefill's [8192, 576] float32
// that is 37.7 MB, about 11 us at 3.35 TB/s. A decode step's [4, 576] is
// a few kilobytes, and the launch itself is the cost.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, bool kResidual>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ res,
               const float* __restrict__ w, T* __restrict__ out, int n,
               int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;  // the whole warp leaves together
  const T* xr = x + row * d;
  const T* rr = kResidual ? res + row * d : nullptr;
  float ss = 0.f;
  for (int c = lane; c < d; c += 32) {
    float v = to_f32(xr[c]);
    if (kResidual) v += to_f32(rr[c]);
    ss += v * v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float inv = rsqrtf(ss / (float)d + eps);
  T* orow = out + row * d;
  for (int c = lane; c < d; c += 32) {
    float v = to_f32(xr[c]);
    if (kResidual) v += to_f32(rr[c]);
    orow[c] = from_f32<T>(v * inv * w[c]);
  }
}

template <typename T>
void launch(const void* x, const void* res, const void* w, void* out, int n,
            int d, float eps, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n + kWarps - 1) / kWarps);
  if (res != nullptr) {
    rmsnorm_kernel<T, true><<<blocks, kWarps * 32, 0, stream>>>(
        (const T*)x, (const T*)res, (const float*)w, (T*)out, n, d, eps);
  } else {
    rmsnorm_kernel<T, false><<<blocks, kWarps * 32, 0, stream>>>(
        (const T*)x, nullptr, (const float*)w, (T*)out, n, d, eps);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, residual and out alike); res may be
// null. Launches on `stream` (a cudaStream_t) of device `device` and
// returns cudaGetLastError() as an int (0 = launched).
int rmsnorm_launch(const void* x, const void* res, const void* w, void* out,
                   int n, int d, float eps, int dtype, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || d <= 0) return 0;
  if (dtype == 0) {
    launch<float>(x, res, w, out, n, d, eps, (cudaStream_t)stream);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, res, w, out, n, d, eps, (cudaStream_t)stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* rmsnorm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
