// Flash attention forward (causal or not, GQA), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::_flash_kernel
//   (wrapper flash_attention_bhsd, pallas_call at kernel.py:79).
//
// What it computes, in the model layout: q [B, Sq, H, D], k and v
// [B, Sk, Kh, D], all float32 or all bfloat16, out [B, Sq, H, D] of the
// same type. Query head h reads KV head h / (H / Kh). For every query row i
//   s_j   = (q_i . k_j) * scale           (float32; scale = 1 / sqrt(D))
//   out_i = sum_j softmax(s)_j v_j        over j < Sk, and j <= i if causal
// with an online softmax: a running max m, sum l and float32 accumulator
// per row, rescaled by exp(m_old - m_new) at each key tile; the output is
// acc / max(l, 1e-30), as the Pallas kernel writes it.
//
// Design. On the TPU the grid's last axis walks the KV blocks in order on
// one core and carries acc, m and l in VMEM scratch. Blocks of a CUDA grid
// run in no order, so here one CTA owns one (query tile of 64 rows, head,
// batch) and walks the KV tiles itself in a loop. Each query row belongs
// to four neighbouring threads of one warp; thread s of the four owns the
// head dims c*16 + s*4 .. +3 (c < D/16), keeps q and acc for them in
// registers, and reads its 16-byte piece of each K and V row from shared
// memory with one vector load (the four pieces are contiguous, and the
// eight rows of a warp read the same address, so the loads are free of
// bank conflicts). Two shuffles add the four partial dot products. A
// 32-row tile of K and V is staged in shared memory as float32 by the
// whole CTA. Causal CTAs stop at the diagonal (tiles wholly above it are
// skipped); keys past Sk and queries past Sq are bound-checked, so S need
// not be a multiple of anything and nothing is padded. The head dim is a
// template parameter in {16, 32, 64, 128}.
//
// Bound on this card: operations. At the prefill's B=4, S=2048, H=9, D=64,
// causal, the scores and the weighted sum take 4 * D flops for each of the
// B * H * S(S+1)/2 visible (query, key) pairs, 1.93e10 flops, about 0.29 ms
// at the card's 67 TFLOP/s in float32 without tensor cores (TF32 would
// change the results); the bytes, 50 MB of q, k, v and out, take 0.015 ms.
// This first kernel does the products on the CUDA cores, one FMA per
// loaded float and a shuffle pair per score: wgmma, TMA and a cp.async
// pipeline are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;                  // query rows per CTA
constexpr int kBK = 32;                  // keys per shared-memory tile
constexpr int kTPR = 4;                  // threads per query row
constexpr int kThreads = kBQ * kTPR;     // 256

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int Sq, int Sk,
             int H, int Kh, int causal, float scale) {
  constexpr int kChunks = D / 16;        // float4 pieces per thread
  __shared__ __align__(16) float ks[kBK * D];
  __shared__ __align__(16) float vs[kBK * D];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Kh);
  const int tid = threadIdx.x;
  const int s = tid % kTPR;
  const int qi = qt * kBQ + tid / kTPR;

  const long long q_stride = (long long)H * D;     // one position of q/out
  const long long kv_stride = (long long)Kh * D;   // one position of k/v
  const T* qb = q + (long long)b * Sq * q_stride + (long long)h * D;
  const T* kb = k + (long long)b * Sk * kv_stride + (long long)kvh * D;
  const T* vb = v + (long long)b * Sk * kv_stride + (long long)kvh * D;

  float qr[kChunks][4], acc[kChunks][4];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qr[c][e] = qi < Sq ? to_f32(qb[qi * q_stride + c * 16 + s * 4 + e])
                         : 0.f;
      acc[c][e] = 0.f;
    }
  }
  float m = -INFINITY, l = 0.f;

  const int kend = causal ? min(Sk, (qt + 1) * kBQ) : Sk;
  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();                     // the last tile has been read
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int kj = k0 + idx / D, c = idx % D;
      const bool in = kj < Sk;
      ks[idx] = in ? to_f32(kb[kj * kv_stride + c]) : 0.f;
      vs[idx] = in ? to_f32(vb[kj * kv_stride + c]) : 0.f;
    }
    __syncthreads();

    float sc[kBK];
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(ks + j * D);
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 kk = kr[c * kTPR + s];
        part = fmaf(qr[c][0], kk.x, part);
        part = fmaf(qr[c][1], kk.y, part);
        part = fmaf(qr[c][2], kk.z, part);
        part = fmaf(qr[c][3], kk.w, part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kj = k0 + j;
      const bool ok = kj < Sk && (!causal || kj <= qi);
      sc[j] = ok ? part * scale : -INFINITY;
      tmax = fmaxf(tmax, sc[j]);
    }
    const float m_new = fmaxf(m, tmax);
    // a row with no visible key yet keeps p = 0 and corr = 0
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float corr = expf(m - m_use);
    l *= corr;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][e] *= corr;
    }
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p = expf(sc[j] - m_use);
      l += p;
      const float4* vr = reinterpret_cast<const float4*>(vs + j * D);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 vv = vr[c * kTPR + s];
        acc[c][0] = fmaf(p, vv.x, acc[c][0]);
        acc[c][1] = fmaf(p, vv.y, acc[c][1]);
        acc[c][2] = fmaf(p, vv.z, acc[c][2]);
        acc[c][3] = fmaf(p, vv.w, acc[c][3]);
      }
    }
    m = m_new;
  }

  if (qi >= Sq) return;
  const float denom = fmaxf(l, 1e-30f);
  T* ob = out + (long long)b * Sq * q_stride + qi * q_stride
          + (long long)h * D;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ob[c * 16 + s * 4 + e] = from_f32<T>(acc[c][e] / denom);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int Kh, int D, int causal, float scale,
           cudaStream_t stream) {
  const dim3 grid((unsigned)((Sq + kBQ - 1) / kBQ), (unsigned)H,
                  (unsigned)B);
#define FLASH_CASE(DIM)                                                    \
  case DIM:                                                                \
    flash_kernel<T, DIM><<<grid, kThreads, 0, stream>>>(                   \
        (const T*)q, (const T*)k, (const T*)v, (T*)out, Sq, Sk, H, Kh,     \
        causal, scale);                                                    \
    break;
  switch (D) {
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FLASH_CASE
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike). Launches on
// `stream` (a cudaStream_t) of device `device` and returns
// cudaGetLastError() as an int (0 = launched).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int Sq, int Sk, int H, int Kh,
                           int D, int causal, float scale, int dtype,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  if (Kh <= 0 || H % Kh != 0 || B > 65535 || H > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0) {
    return launch<float>(q, k, v, out, B, Sq, Sk, H, Kh, D, causal, scale,
                         (cudaStream_t)stream);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, Kh, D, causal,
                                 scale, (cudaStream_t)stream);
  }
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
