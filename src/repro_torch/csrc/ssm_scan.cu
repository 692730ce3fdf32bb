// Mamba selective scan (forward), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssm_scan/kernel.py::_ssm_kernel
//   (wrapper ssm_scan_pallas, pallas_call at kernel.py:59).
//
// What it computes: x and dt [Bt, S, Di], B and C [Bt, S, N] (all float32
// or all bfloat16), A [Di, N] and D [Di] as float32, out [Bt, S, Di] of
// x's type. For every batch b and channel d, from h = 0:
//   h_t[n] = exp(dt_t * A[d, n]) * h_{t-1}[n] + (dt_t * x_t) * B_t[n]
//   y_t    = sum_n h_t[n] * C_t[n] + D[d] * x_t
// all in float32, y_t cast once to the output type (as the Pallas kernel
// adds D * x before its cast; the plain oracle casts first).
//
// Design. The TPU kernel tiles Di over its grid and carries a [bd, N]
// state in VMEM along its sequential S axis. CUDA blocks run in no order,
// so here one thread owns one (batch, channel) and walks all of S itself,
// its N states in registers: nothing of [Bt, S, Di, N] is ever stored.
// A block is 128 neighbouring channels of one batch, so the loads of x and
// dt and the stores of y are coalesced, 512 contiguous bytes of a row per
// step in float32. Every thread of a block needs the same B_t and C_t: a
// tile of 16 time steps of them is staged in shared memory (read as
// broadcasts). The tiles are double-buffered, and each thread loads the
// next tile's x, dt, B and C into registers before it computes the
// current one, so the loads are in flight during the arithmetic; one
// barrier per tile. exp(dt * A) is 2^(dt * A * log2 e) with A * log2 e kept
// in registers, by the ex2.approx.ftz instruction alone: one MUFU.EX2 per
// (step, state), about 2 ulp; it flushes results below 2^-126 to zero
// (decays of e^-87 and smaller). Any S and Di are taken (ragged tiles
// are bound-checked); N is a template parameter in {2, 4, 8, 16}.
//
// Times (chip_smoke.py, H100 SXM at 700 W), at the mixer's shape: 0.492 ms
// in float32, 2.0x the bytes bound below. The first version used exp2f,
// whose non-flushing form wraps the MUFU in range checks, and took
// 0.958 ms. In bfloat16 it takes 0.92 ms for half the bytes; what holds
// the bf16 path back is not measured apart (ROADMAP Queue B 4).

// A design that was tried and dropped: splitting each channel's N states
// over 4 lanes (two shuffles a step) for 4x the threads. In chip_smoke.py
// on an H100 SXM at 700 W it took 1.17 ms at the mixer's shape, and
// 1.26 ms with registers capped so that its 1024 blocks ran in one wave,
// against 0.958 ms for this design with exp2f at the time; only the
// half-size [1, 1000, 16384, 16] got faster (0.30 against 0.44 ms).
// More threads did not help: occupancy is not what holds this kernel
// back.
//
// Bound on this card. At the Jamba mixer's [2, 2048, 16384, 16] float32 the
// bytes, x and dt read and y written once (3 x 268 MB, B and C 0.5 MB), take
// 0.24 ms at 3.35 TB/s; the 7.7e9 float32 operations 0.12 ms at 67 TFLOP/s.
// The 1.07e9 exponentials are a third limit that the peak-rate table does
// not show: the special-function units do 16 per clock per SM, 0.26 ms at
// 1.98 GHz. B * Di = 32 768 threads are two 128-thread blocks per SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;     // channels per block
constexpr int kSteps = 16;        // time steps per staged tile
constexpr float kLog2e = 1.4426950408889634f;

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

// 2^x by the special-function unit alone, results below 2^-126 flushed.
__device__ __forceinline__ float fast_exp2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// x and dt of steps t0 .. t0 + kSteps - 1 of this thread's channel.
template <typename T>
__device__ __forceinline__ void load_xd(const T* __restrict__ xb,
                                        const T* __restrict__ db, int t0,
                                        int S, int Di, bool active,
                                        float (&rx)[kSteps],
                                        float (&rd)[kSteps]) {
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const int t = t0 + j;
    const bool ok = active && t < S;
    rx[j] = ok ? to_f32(xb[(long long)t * Di]) : 0.f;
    rd[j] = ok ? to_f32(db[(long long)t * Di]) : 0.f;
  }
}

// This thread's share of B and C of steps t0 .. t0 + kSteps - 1.
template <typename T, int N, int kPer>
__device__ __forceinline__ void load_bc(const T* __restrict__ bb,
                                        const T* __restrict__ cb, int t0,
                                        int S, float (&rb)[kPer],
                                        float (&rc)[kPer]) {
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int t = t0 + idx / N;
    const bool ok = idx < kSteps * N && t < S;
    const long long off = (long long)t * N + idx % N;
    rb[i] = ok ? to_f32(bb[off]) : 0.f;
    rc[i] = ok ? to_f32(cb[off]) : 0.f;
  }
}

template <int kPer>
__device__ __forceinline__ void store_bc(float* bs, float* cs, int count,
                                         const float (&rb)[kPer],
                                         const float (&rc)[kPer]) {
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    if (idx < count) {
      bs[idx] = rb[i];
      cs[idx] = rc[i];
    }
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const T* __restrict__ bm, const T* __restrict__ cm,
                const float* __restrict__ A, const float* __restrict__ Dv,
                T* __restrict__ out, int S, int Di) {
  constexpr int kBC = kSteps * N;
  constexpr int kPer = (kBC + kThreads - 1) / kThreads;
  __shared__ __align__(16) float bs[2][kBC];
  __shared__ __align__(16) float cs[2][kBC];

  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool active = d < Di;
  const long long xoff = (long long)b * S * Di + (active ? d : 0);
  const T* xb = x + xoff;
  const T* db = dt + xoff;
  T* ob = out + xoff;
  const T* bb = bm + (long long)b * S * N;
  const T* cb = cm + (long long)b * S * N;

  float a2[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a2[n] = active ? A[(long long)d * N + n] * kLog2e : 0.f;
    h[n] = 0.f;
  }
  const float dd = active ? Dv[d] : 0.f;

  float rx[kSteps], rd[kSteps], rb[kPer], rc[kPer];
  load_xd(xb, db, 0, S, Di, active, rx, rd);
  load_bc<T, N, kPer>(bb, cb, 0, S, rb, rc);
  store_bc(bs[0], cs[0], kBC, rb, rc);
  __syncthreads();

  const int tiles = (S + kSteps - 1) / kSteps;
  for (int k = 0; k < tiles; ++k) {
    const int t0 = k * kSteps;
    const int buf = k & 1;
    const bool more = k + 1 < tiles;
    float nx[kSteps], nd[kSteps];
    if (more) {
      load_xd(xb, db, t0 + kSteps, S, Di, active, nx, nd);
      load_bc<T, N, kPer>(bb, cb, t0 + kSteps, S, rb, rc);
    }
    const float* bt = bs[buf];
    const float* ct = cs[buf];
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      if (t0 + j < S) {
        const float dtj = rd[j];
        const float dtx = dtj * rx[j];
        float y = 0.f;
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float a = fast_exp2(dtj * a2[n]);
          h[n] = fmaf(a, h[n], dtx * bt[j * N + n]);
          y = fmaf(h[n], ct[j * N + n], y);
        }
        y = fmaf(dd, rx[j], y);
        if (active) ob[(long long)(t0 + j) * Di] = from_f32<T>(y);
      }
    }
    if (more) {
      // buffer buf ^ 1 was last read before the previous barrier
      store_bc(bs[buf ^ 1], cs[buf ^ 1], kBC, rb, rc);
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        rx[j] = nx[j];
        rd[j] = nd[j];
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* bm, const void* cm,
           const float* A, const float* Dv, void* out, int Bt, int S, int Di,
           int N, cudaStream_t stream) {
  const dim3 grid((unsigned)((Di + kThreads - 1) / kThreads), (unsigned)Bt);
#define SSM_CASE(NS)                                                       \
  case NS:                                                                 \
    ssm_scan_kernel<T, NS><<<grid, kThreads, 0, stream>>>(                 \
        (const T*)x, (const T*)dt, (const T*)bm, (const T*)cm, A, Dv,      \
        (T*)out, S, Di);                                                   \
    break;
  switch (N) {
    SSM_CASE(2)
    SSM_CASE(4)
    SSM_CASE(8)
    SSM_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SSM_CASE
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, dt, B, C and out alike; A and D
// are float32). Launches on `stream` (a cudaStream_t) of device `device`
// and returns cudaGetLastError() as an int (0 = launched).
int ssm_scan_launch(const void* x, const void* dt, const void* bm,
                    const void* cm, const void* A, const void* Dv, void* out,
                    int Bt, int S, int Di, int N, int dtype, int device,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (Bt <= 0 || S <= 0 || Di <= 0) return 0;
  if (Bt > 65535) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    return launch<float>(x, dt, bm, cm, (const float*)A, (const float*)Dv,
                         out, Bt, S, Di, N, (cudaStream_t)stream);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, dt, bm, cm, (const float*)A,
                                 (const float*)Dv, out, Bt, S, Di, N,
                                 (cudaStream_t)stream);
  }
  return (int)cudaErrorInvalidValue;
}

const char* ssm_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
