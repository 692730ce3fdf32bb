// Fused (residual +) RMSNorm over the rows of [N, D], for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/rmsnorm/kernel.py::_rmsnorm_kernel and
//   ::_rmsnorm_res_kernel (wrapper rmsnorm_2d, pallas_call at kernel.py:46).
//
// What it computes, for each row r of x [N, D] (float32 or bfloat16):
//   v   = x[r] (+ residual[r]), in float32
//   out = v * rsqrt(mean(v * v) + eps) * w, in float32, stored as x's type.
// w [D] is float32 or bfloat16 and is read in its own type (a bf16 weight
// widens to float32 exactly, so the math is the plain version's).
//
// Design. The TPU kernel tiles [256, D] rows into VMEM and reduces each row
// in vector registers. Here a row lives in registers: a CTA takes one row,
// and a host-side plan (kernels/rmsnorm/kernel.py::plan) gives it `tpr`
// threads and each thread `nper` vectors of VEC elements, vector s of
// thread l being vector l + s * tpr of the row, so that neighbouring
// threads read neighbouring 16 bytes. With rows enough to fill the card a
// row is one warp; with few rows (a decode step) a row takes up to 256
// threads, one vector each at D = 576 in float32 (144 of 160 threads hold
// one float4). tools/rmsnorm_plans.py times every plan. Values sit in registers as packed 32-bit words (a
// bf16 pair to a word), which keeps a 16-byte bf16 vector in 4 registers.
// A thread
//   1. loads its vectors of w (its own type), x and the residual, all
//      before the reduction, so the w loads overlap the x loads;
//   2. sums the squares in float32, reduces with warp shuffles and, when a
//      row spans several warps, across them through shared memory;
//   3. writes its vectors of the output in one vectorised store pass.
// The row is read from device memory once. VEC is 16 bytes of x's type
// when D * size is a multiple of 16 and every pointer is 16-byte aligned,
// else 1 element (the same kernel with narrower loads). A thread keeps at
// most kMaxVec vectors (every d_model of configs/ fits in both types); a
// longer row takes a loop inside the same kernel that reads it twice.
//
// Bound on this card: bytes. A launch must read x (and the residual) and w
// once and write the output once: at the prefill's [8192, 576] float32
// that is 37.7 MB, about 11 us at 3.35 TB/s. A decode step's [4, 576] is
// a few kilobytes, and the launch itself is the cost.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;  // threads per CTA
constexpr int kMaxVec = 8;        // vectors a thread keeps in registers

// Element e of a vector held as little-endian 32-bit words, widened to
// float32 (a bf16 widens by a shift: exact), and its store from float32.
template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static __device__ __forceinline__ float get(const uint32_t* u, int e) {
    return __uint_as_float(u[e]);
  }
  static __device__ __forceinline__ void set(uint32_t* u, int e, float v) {
    u[e] = __float_as_uint(v);
  }
};
template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float get(const uint32_t* u, int e) {
    const uint32_t w = u[e >> 1];
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
  static __device__ __forceinline__ void set(uint32_t* u, int e, float v) {
    const uint32_t b = __bfloat16_as_ushort(__float2bfloat16(v));
    uint32_t& w = u[e >> 1];
    w = (e & 1) ? ((w & 0xffffu) | (b << 16)) : ((w & 0xffff0000u) | b);
  }
};

// N elements of T in registers as packed 32-bit words, loaded and stored
// in accesses of up to 16 bytes.
template <typename T, int N>
struct Vec {
  static constexpr int kBytes = N * (int)sizeof(T);
  static constexpr int kWords = (kBytes + 3) / 4;
  uint32_t u[kWords];

  __device__ __forceinline__ void load(const T* p) {
    if constexpr (kBytes >= 16) {
#pragma unroll
      for (int a = 0; a < kBytes / 16; ++a) {
        const uint4 v = reinterpret_cast<const uint4*>(p)[a];
        u[4 * a] = v.x, u[4 * a + 1] = v.y, u[4 * a + 2] = v.z,
        u[4 * a + 3] = v.w;
      }
    } else if constexpr (kBytes == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      u[0] = v.x, u[1] = v.y;
    } else if constexpr (kBytes == 4) {
      u[0] = *reinterpret_cast<const uint32_t*>(p);
    } else {
      u[0] = *reinterpret_cast<const unsigned short*>(p);
    }
  }
  __device__ __forceinline__ void store(T* p) const {
    if constexpr (kBytes >= 16) {
#pragma unroll
      for (int a = 0; a < kBytes / 16; ++a) {
        reinterpret_cast<uint4*>(p)[a] =
            make_uint4(u[4 * a], u[4 * a + 1], u[4 * a + 2], u[4 * a + 3]);
      }
    } else if constexpr (kBytes == 8) {
      *reinterpret_cast<uint2*>(p) = make_uint2(u[0], u[1]);
    } else if constexpr (kBytes == 4) {
      *reinterpret_cast<uint32_t*>(p) = u[0];
    } else {
      *reinterpret_cast<unsigned short*>(p) = (unsigned short)u[0];
    }
  }
  __device__ __forceinline__ float get(int e) const {
    return Elem<T>::get(u, e);
  }
  __device__ __forceinline__ void set(int e, float v) { Elem<T>::set(u, e, v); }
};

// The sum of `ss` over the CTA's threads (a multiple of 32: one row).
__device__ __forceinline__ float row_sum(float ss) {
  __shared__ float red[kMaxThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (blockDim.x == 32) return ss;
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = ss;
  __syncthreads();
  ss = 0.f;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) ss += red[i];
  return ss;
}

// NPER: the vectors a thread holds in registers (nper <= NPER of them are
// live); a row of more than kMaxVec vectors a thread is looped over.
template <typename T, typename TW, int VEC, int NPER>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ res,
               const TW* __restrict__ w, T* __restrict__ out, int d,
               float eps, int nper) {
  using XV = Vec<T, VEC>;
  using WV = Vec<TW, VEC>;
  const int tpr = blockDim.x;
  const int lt = threadIdx.x;
  const long long row = blockIdx.x;
  const int nvec = d / VEC;
  const T* xr = x + row * d;
  const T* rr = res ? res + row * d : nullptr;
  T* orow = out + row * d;

  if (nper <= NPER) {
    XV xv[NPER], rv[NPER];
    WV wv[NPER];
#pragma unroll
    for (int s = 0; s < NPER; ++s) {
      const int v = lt + s * tpr;
      if (s < nper && v < nvec) {
        wv[s].load(w + v * VEC);
        xv[s].load(xr + v * VEC);
        if (rr) rv[s].load(rr + v * VEC);
      }
    }
    float ss = 0.f;
#pragma unroll
    for (int s = 0; s < NPER; ++s) {
      if (s < nper && lt + s * tpr < nvec) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          float f = xv[s].get(e);
          if (rr) f += rv[s].get(e);
          ss += f * f;
        }
      }
    }
    const float inv = rsqrtf(row_sum(ss) / (float)d + eps);
#pragma unroll
    for (int s = 0; s < NPER; ++s) {
      const int v = lt + s * tpr;
      if (s < nper && v < nvec) {
        XV o{};
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          float f = xv[s].get(e);
          if (rr) f += rv[s].get(e);
          o.set(e, f * inv * wv[s].get(e));
        }
        o.store(orow + v * VEC);
      }
    }
    return;
  }

  // a row longer than the registers hold: read it twice
  float ss = 0.f;
  for (int v = lt; v < nvec; v += tpr) {
    XV a, r;
    a.load(xr + v * VEC);
    if (rr) r.load(rr + v * VEC);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float f = a.get(e);
      if (rr) f += r.get(e);
      ss += f * f;
    }
  }
  const float inv = rsqrtf(row_sum(ss) / (float)d + eps);
  for (int v = lt; v < nvec; v += tpr) {
    WV b;
    XV a, r, o{};
    b.load(w + v * VEC);
    a.load(xr + v * VEC);
    if (rr) r.load(rr + v * VEC);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float f = a.get(e);
      if (rr) f += r.get(e);
      o.set(e, f * inv * b.get(e));
    }
    o.store(orow + v * VEC);
  }
}

template <typename T, typename TW, int VEC, int NPER>
void launch(const void* x, const void* res, const void* w, void* out, int n,
            int d, float eps, int tpr, int nper, cudaStream_t stream) {
  rmsnorm_kernel<T, TW, VEC, NPER><<<(unsigned)n, tpr, 0, stream>>>(
      (const T*)x, (const T*)res, (const TW*)w, (T*)out, d, eps, nper);
}

// 16-byte vectors take the smallest register array of 1, 2, 4 or kMaxVec
// vectors that holds nper of them; single elements always kMaxVec (a few
// registers).
template <typename T, typename TW>
void launch_vec(const void* x, const void* res, const void* w, void* out,
                int n, int d, float eps, int vec16, int tpr, int nper,
                cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (!vec16) {
    launch<T, TW, 1, kMaxVec>(x, res, w, out, n, d, eps, tpr, nper, stream);
  } else if (nper <= 1) {
    launch<T, TW, V, 1>(x, res, w, out, n, d, eps, tpr, nper, stream);
  } else if (nper <= 2) {
    launch<T, TW, V, 2>(x, res, w, out, n, d, eps, tpr, nper, stream);
  } else if (nper <= 4) {
    launch<T, TW, V, 4>(x, res, w, out, n, d, eps, tpr, nper, stream);
  } else {
    launch<T, TW, V, kMaxVec>(x, res, w, out, n, d, eps, tpr, nper, stream);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, residual and out alike); w_dtype
// likewise for w; res may be null. vec16: 16-byte vectors (D * size a
// multiple of 16, every pointer 16-byte aligned) or single elements. The
// plan: one CTA of tpr threads (a multiple of 32, at most 256) per row,
// nper vectors per thread (tpr * nper vectors cover the row; above 8 the
// row is looped over). Launches on `stream` (a cudaStream_t) of device
// `device` and returns cudaGetLastError() as an int (0 = launched).
int rmsnorm_launch(const void* x, const void* res, const void* w, void* out,
                   int n, int d, float eps, int dtype, int w_dtype,
                   int vec16, int tpr, int nper, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || d <= 0) return 0;
  if (tpr < 32 || tpr % 32 != 0 || tpr > kMaxThreads || nper < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && w_dtype == 0) {
    launch_vec<float, float>(x, res, w, out, n, d, eps, vec16, tpr, nper,
                             s);
  } else if (dtype == 0 && w_dtype == 1) {
    launch_vec<float, __nv_bfloat16>(x, res, w, out, n, d, eps, vec16, tpr,
                                     nper, s);
  } else if (dtype == 1 && w_dtype == 0) {
    launch_vec<__nv_bfloat16, float>(x, res, w, out, n, d, eps, vec16, tpr,
                                     nper, s);
  } else if (dtype == 1 && w_dtype == 1) {
    launch_vec<__nv_bfloat16, __nv_bfloat16>(x, res, w, out, n, d, eps,
                                             vec16, tpr, nper, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* rmsnorm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
