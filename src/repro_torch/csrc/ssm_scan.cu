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
// Design core. The TPU kernel tiles Di over its grid and carries a [bd, N]
// state in VMEM along its sequential S axis. CUDA blocks run in no order,
// so here one thread owns one (batch, channel) and walks all of S itself,
// its N states in registers: nothing of [Bt, S, Di, N] is ever stored. A
// block is 128 neighbouring channels of one batch. exp(dt * A) is
// 2^(dt * A * log2 e) with A * log2 e kept in registers; ex2.approx.ftz
// flushes results below 2^-126 to zero (decays of e^-87 and smaller). Any
// S and Di are taken; N is a template parameter in {2, 4, 8, 16}.
//
// Bound on this card, at the Jamba mixer's [2, 2048, 16384, 16]. Bytes: x
// and dt read and y written once (3 x 268 MB in float32, B and C 0.5 MB),
// 0.24 ms at 3.35 TB/s in float32 and 0.12 ms in bfloat16. Pipes: per
// (step, channel, state) 4 float32 operations (dt * A, the two of h's
// update, h * C) and one exponential; the special-function units do 16
// exponentials a clock per SM and the FP32 pipe 128 operations, so the
// exponentials alone take 0.26 ms at 1.98 GHz. A polynomial exp2 of c
// FP32 operations moves part of them to the FP32 pipe; with the best
// share the pipes' floor is elements x (4 + c) / (16 (8 + c)) clocks per
// SM, 0.20 ms at c = 10 (Cody-Waite reduction, a degree-6 Horner
// polynomial, the exponent by integer add). float32 is bound by its
// bytes, bfloat16 by the pipes.
//
// The first design loaded each thread's next 16 steps of x and dt into
// registers before computing the current ones. 32 768 threads are two
// 128-thread blocks, 8 warps, per SM, so only their register loads were in
// flight: 0.49 ms in float32, 2.0x its bytes bound, and 0.91 ms in
// bfloat16, whose 2-byte loads put half the bytes in flight for the same
// instructions (its loads and stores alone took 0.373 / 0.701 ms). B_t
// and C_t came from shared memory as 2N scalar loads a step.
//
// This design. Times from chip_smoke.py phase 11 on an H100 SXM at 700 W,
// at the mixer's shape, float32 / bfloat16:
//   - x, dt, B and C tiles of 64 bytes a channel (16 steps in float32, 32
//     in bfloat16) go through a 4-stage ring of shared memory by 16-byte
//     cp.async, so three tiles ahead are in flight whatever the warps do
//     (ragged or unaligned edges are copied element by element). The
//     loads and stores alone (ssm_scan_loads_launch) take 0.308 / 0.209
//     ms;
//   - with the memory path off the critical path the pipes were the
//     limit, and one thread a channel left 2 warps a scheduler to hide
//     their latencies: two threads now share a channel, N / 2 states each,
//     and add their halves of y with one shuffle (4 warps a scheduler);
//   - B_t and C_t are read as 16-byte broadcasts (two loads a half row in
//     float32); in bfloat16 a tile of them is converted to float32 in
//     shared memory once, a tile ahead, instead of by every thread at
//     every step;
//   - the tile's steps are unrolled whole; y is staged in shared memory by
//     tile and stored in 16-byte pieces.
// Net: 0.486 / 0.477 ms against the first design's 0.494 / 0.917 in the
// same call, 2.4x the pipes' floor and 1.9x the exponentials' alone.
// Tried and not kept: the polynomial exp2 above on a quarter of the
// states (0.542 / 0.575 ms: the FP32 pipe and the dispatch slots it takes
// cost more than the special-function time it frees); partial sums for y
// and an unroll of 4 steps (no faster). The arithmetic is the first
// design's but for y's order of summation (each half, then their sum):
// the result moves by float32 rounding, one bf16 ulp at most after the
// cast.
//
// A design that was tried and dropped: splitting each channel's N states
// over 4 lanes (two shuffles a step) for 4x the threads. In chip_smoke.py
// on an H100 SXM at 700 W it took 1.17 ms at the mixer's shape, and
// 1.26 ms with registers capped so that its 1024 blocks ran in one wave,
// against 0.958 ms for the first design with exp2f at the time; only the
// half-size [1, 1000, 16384, 16] got faster (0.30 against 0.44 ms).
// More threads did not help: occupancy is not what holds this kernel
// back.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;     // channels per block
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

}  // namespace

// ---------------------------------------------------------------------------
// The kernel: a cp.async ring of x, dt, B and C tiles.
// ---------------------------------------------------------------------------
namespace staged {

constexpr int kStages = 4;

template <typename T, int N>
struct Cfg {
  static constexpr int kLanes = 2;                        // per channel
  static constexpr int kCh = kThreads / kLanes;           // per block
  static constexpr int kNL = N / kLanes;                  // states a lane
  static constexpr int kSteps = 64 / (int)sizeof(T);     // 16 or 32
  static constexpr int kPerChunk = 16 / (int)sizeof(T);  // elements
  static constexpr int kRowChunks = kCh / kPerChunk;
  static constexpr int kXBytes = kSteps * kCh * (int)sizeof(T);
  static constexpr int kBCBytes = kSteps * N * (int)sizeof(T);
  static constexpr int kBCChunks = (kBCBytes + 15) / 16;
  // a stage: x, dt, B, C (each 16-byte aligned); then the y tile
  static constexpr int kBCPad = kBCChunks * 16;
  static constexpr int kStage = 2 * kXBytes + 2 * kBCPad;
  static constexpr bool kConv = sizeof(T) == 2;   // B, C to float32
  static constexpr int kSmem = kStages * kStage + kXBytes
                               + (kConv ? 2 * 2 * kSteps * N * 4 : 0);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// One 16-byte piece of `valid` leading elements from global to shared:
// by cp.async when whole and aligned, else element by element (zeros
// past `valid`).
template <typename T>
__device__ __forceinline__ void stage_piece(T* dst, const T* src,
                                            int valid) {
  constexpr int kE = 16 / (int)sizeof(T);
  if (valid == kE && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    cp_async16(smem_u32(dst), src);
  } else {
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      dst[e] = e < valid ? src[e] : from_f32<T>(0.f);
    }
  }
}

// Steps t0 .. t0 + kSteps - 1 of x and dt (this block's 128 channels) and
// of B and C into one ring stage.
template <typename T, int N>
__device__ __forceinline__ void stage_tile(uint8_t* st, const T* xb,
                                           const T* db, const T* bb,
                                           const T* cb, int t0, int S,
                                           int Di, int d0) {
  using C = Cfg<T, N>;
  T* xs = reinterpret_cast<T*>(st);
  T* ds = reinterpret_cast<T*>(st + C::kXBytes);
  T* bs = reinterpret_cast<T*>(st + 2 * C::kXBytes);
  T* cs = reinterpret_cast<T*>(st + 2 * C::kXBytes + C::kBCPad);
  constexpr int kPieces = C::kSteps * C::kRowChunks;
#pragma unroll
  for (int i = 0; i < kPieces / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / C::kRowChunks;
    const int c0 = (idx % C::kRowChunks) * C::kPerChunk;
    const int t = t0 + r;
    const int valid = t < S ? max(0, min(C::kPerChunk, Di - d0 - c0)) : 0;
    const long long off = (long long)(valid ? t : 0) * Di + d0 + c0;
    stage_piece(xs + r * C::kCh + c0, xb + off, valid);
    stage_piece(ds + r * C::kCh + c0, db + off, valid);
  }
  const int bc_valid = max(0, min(C::kSteps, S - t0)) * N;
  for (int idx = threadIdx.x; idx < 2 * C::kBCChunks; idx += kThreads) {
    const bool is_c = idx >= C::kBCChunks;
    const int e0 = (is_c ? idx - C::kBCChunks : idx) * C::kPerChunk;
    const int valid = max(0, min(C::kPerChunk, bc_valid - e0));
    const long long off = (long long)t0 * N + (valid ? e0 : 0);
    stage_piece((is_c ? cs : bs) + e0, (is_c ? cb : bb) + off, valid);
  }
}

// A row of N float32 values of B or C, by 16-byte shared loads where they
// divide the row.
template <int N>
__device__ __forceinline__ void load_row(const float* p, float (&r)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 v = reinterpret_cast<const float4*>(p)[i];
      r[4 * i] = v.x;
      r[4 * i + 1] = v.y;
      r[4 * i + 2] = v.z;
      r[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int n = 0; n < N; ++n) r[n] = p[n];
  }
}

// Grid (Di / 64, Bt), 128 threads, two a channel (states n0 .. n0 + N/2
// - 1 each). kLoadsOnly: the same copies, y = x + dt + B_t[0] + C_t[0] in
// place of the recurrence.
template <typename T, int N, bool kLoadsOnly>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const T* __restrict__ bm, const T* __restrict__ cm,
                const float* __restrict__ A, const float* __restrict__ Dv,
                T* __restrict__ out, int S, int Di) {
  using C = Cfg<T, N>;
  constexpr int kSteps = C::kSteps;
  extern __shared__ __align__(16) uint8_t smem[];
  T* ys = reinterpret_cast<T*>(smem + kStages * C::kStage);

  constexpr int kNL = C::kNL;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * C::kCh;
  const int ch = threadIdx.x / C::kLanes;      // channel in the block
  const int n0 = (threadIdx.x % C::kLanes) * kNL;   // first state
  const int d = d0 + ch;
  const bool active = d < Di;
  const long long boff = (long long)b * S * Di;
  const T* xb = x + boff;
  const T* db = dt + boff;
  T* ob = out + boff;
  const T* bb = bm + (long long)b * S * N;
  const T* cb = cm + (long long)b * S * N;

  float a2[kNL], h[kNL];
#pragma unroll
  for (int n = 0; n < kNL; ++n) {
    a2[n] = active ? A[(long long)d * N + n0 + n] * kLog2e : 0.f;
    h[n] = 0.f;
  }
  const float dd = active ? Dv[d] : 0.f;

  const int tiles = (S + kSteps - 1) / kSteps;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles) {
      stage_tile<T, N>(smem + s * C::kStage, xb, db, bb, cb, s * kSteps, S,
                       Di, d0);
    }
    cp_commit();
  }
  float* bcf = reinterpret_cast<float*>(smem + kStages * C::kStage
                                        + C::kXBytes);
  auto convert = [&](int kk) {
    const T* src = reinterpret_cast<const T*>(
        smem + (kk % kStages) * C::kStage + 2 * C::kXBytes);
    float* dst = bcf + (kk & 1) * 2 * kSteps * N;
    for (int i = threadIdx.x; i < 2 * kSteps * N; i += kThreads) {
      dst[i] = to_f32(src[i]);
    }
  };
  if constexpr (C::kConv) {
    cp_wait<kStages - 2>();
    __syncthreads();
    convert(0);
  }
  for (int k = 0; k < tiles; ++k) {
    if constexpr (C::kConv) {
      cp_wait<kStages - 3>();          // tiles k and k + 1 have landed
    } else {
      cp_wait<kStages - 2>();          // tile k has landed (this thread)
    }
    __syncthreads();                   // ... all threads; k - 1 is read
    if constexpr (C::kConv) {
      if (k + 1 < tiles) convert(k + 1);
    }
    const int kn = k + kStages - 1;
    if (kn < tiles) {
      stage_tile<T, N>(smem + (kn % kStages) * C::kStage, xb, db, bb, cb,
                       kn * kSteps, S, Di, d0);
    }
    cp_commit();
    const uint8_t* st = smem + (k % kStages) * C::kStage;
    const T* xs = reinterpret_cast<const T*>(st);
    const T* ds = reinterpret_cast<const T*>(st + C::kXBytes);
    const T* bs = reinterpret_cast<const T*>(st + 2 * C::kXBytes);
    const T* cs = reinterpret_cast<const T*>(st + 2 * C::kXBytes
                                             + C::kBCPad);
    // steps past S hold dt = 0 (and zeros elsewhere): h stays as it is,
    // and their y is never stored
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const float xj = to_f32(xs[j * C::kCh + ch]);
      const float dtj = to_f32(ds[j * C::kCh + ch]);
      float bt[kNL], ct[kNL];
      if constexpr (C::kConv) {
        const float* bf = bcf + (k & 1) * 2 * kSteps * N;
        load_row<kNL>(bf + j * N + n0, bt);
        load_row<kNL>(bf + kSteps * N + j * N + n0, ct);
      } else {
        load_row<kNL>(bs + j * N + n0, bt);
        load_row<kNL>(cs + j * N + n0, ct);
      }
      float y;
      if (kLoadsOnly) {
        y = xj + dtj + bt[0] + ct[0];
      } else {
        const float dtx = dtj * xj;
        y = 0.f;
#pragma unroll
        for (int n = 0; n < kNL; ++n) {
          const float a = fast_exp2(dtj * a2[n]);
          h[n] = fmaf(a, h[n], dtx * bt[n]);
          y = fmaf(h[n], ct[n], y);
        }
#pragma unroll
        for (int l = 1; l < C::kLanes; l *= 2) {
          y += __shfl_xor_sync(0xffffffffu, y, l);
        }
        y = fmaf(dd, xj, y);
      }
      if (n0 == 0) ys[j * C::kCh + ch] = from_f32<T>(y);
    }
    __syncthreads();                   // the y tile is whole
    const int t0 = k * kSteps;
    constexpr int kPieces = kSteps * C::kRowChunks;
#pragma unroll
    for (int i = 0; i < kPieces / kThreads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / C::kRowChunks;
      const int c0 = (idx % C::kRowChunks) * C::kPerChunk;
      const int t = t0 + r;
      const int valid = t < S ? max(0, min(C::kPerChunk, Di - d0 - c0)) : 0;
      T* dst = ob + (long long)t * Di + d0 + c0;
      const T* src = ys + r * C::kCh + c0;
      if (valid == C::kPerChunk
          && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < valid; ++e) dst[e] = src[e];
      }
    }
  }
  cp_wait<0>();
}

template <typename T, int N, bool kLoadsOnly>
int launch(const void* x, const void* dt, const void* bm, const void* cm,
           const float* A, const float* Dv, void* out, int Bt, int S, int Di,
           cudaStream_t stream) {
  using C = Cfg<T, N>;
  auto kernel = ssm_scan_kernel<T, N, kLoadsOnly>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const dim3 grid((unsigned)((Di + C::kCh - 1) / C::kCh), (unsigned)Bt);
  kernel<<<grid, kThreads, C::kSmem, stream>>>(
      (const T*)x, (const T*)dt, (const T*)bm, (const T*)cm, A, Dv, (T*)out,
      S, Di);
  return (int)cudaGetLastError();
}

}  // namespace staged

namespace {

template <typename T, bool kLoadsOnly>
int launch_n(const void* x, const void* dt, const void* bm, const void* cm,
             const float* A, const float* Dv, void* out, int Bt, int S,
             int Di, int N, cudaStream_t stream) {
  switch (N) {
    case 2:
      return staged::launch<T, 2, kLoadsOnly>(x, dt, bm, cm, A, Dv, out, Bt,
                                              S, Di, stream);
    case 4:
      return staged::launch<T, 4, kLoadsOnly>(x, dt, bm, cm, A, Dv, out, Bt,
                                              S, Di, stream);
    case 8:
      return staged::launch<T, 8, kLoadsOnly>(x, dt, bm, cm, A, Dv, out, Bt,
                                              S, Di, stream);
    case 16:
      return staged::launch<T, 16, kLoadsOnly>(x, dt, bm, cm, A, Dv, out,
                                               Bt, S, Di, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <bool kLoadsOnly>
int launch_dtype(const void* x, const void* dt, const void* bm,
                 const void* cm, const void* A, const void* Dv, void* out,
                 int Bt, int S, int Di, int N, int dtype, int device,
                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (Bt <= 0 || S <= 0 || Di <= 0) return 0;
  if (Bt > 65535) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    return launch_n<float, kLoadsOnly>(x, dt, bm, cm, (const float*)A,
                                       (const float*)Dv, out, Bt, S, Di, N,
                                       (cudaStream_t)stream);
  }
  if (dtype == 1) {
    return launch_n<__nv_bfloat16, kLoadsOnly>(
        x, dt, bm, cm, (const float*)A, (const float*)Dv, out, Bt, S, Di, N,
        (cudaStream_t)stream);
  }
  return (int)cudaErrorInvalidValue;
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
  return launch_dtype<false>(x, dt, bm, cm, A, Dv, out, Bt, S, Di, N, dtype,
                             device, stream);
}

// For measuring only: the scan's copies in and out alone, with
// y = x + dt + B_t[0] + C_t[0] in place of the recurrence (the memory
// path's share of the scan's time). Arguments as ssm_scan_launch.
int ssm_scan_loads_launch(const void* x, const void* dt, const void* bm,
                          const void* cm, const void* A, const void* Dv,
                          void* out, int Bt, int S, int Di, int N, int dtype,
                          int device, void* stream) {
  return launch_dtype<true>(x, dt, bm, cm, A, Dv, out, Bt, S, Di, N, dtype,
                            device, stream);
}

const char* ssm_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
