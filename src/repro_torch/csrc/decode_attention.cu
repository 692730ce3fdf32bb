// Flash-decoding: one query token per sequence over a KV cache, GQA,
// positions >= kv_len[b] masked, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/decode_attention/kernel.py::_decode_kernel
//   (wrapper decode_attention_pallas, pallas_call at kernel.py:67).
//
// What it computes: q [B, H, D]; k and v [B, Kh, S, D] read through their
// strides (unit stride on D), so both that layout and the model cache's
// [B, S, Kh, D] seen as a transposed view are taken without a copy; all
// float32 or all bfloat16; kv_len [B] int32; out [B, H, D] of q's type.
// Query head h reads KV head h / (H / Kh). For every (b, h)
//   s_j = (q . k_j) * scale  (float32)   for j < min(kv_len[b], S)
//   out = sum_j softmax(s)_j v_j
// with an online softmax (running max m, sum l, float32 accumulator).
//
// Design. The TPU kernel's grid is (b, h, S / bs) with the S axis in order
// on one core, carrying (m, l, acc) in VMEM, and it reads every KV head
// once per query head. Here the work is split over S (flash-decoding):
// CTA (split, kh, b) takes the keys [split * chunk, (split + 1) * chunk)
// that lie below kv_len[b] and serves all G = H / Kh query heads of KV
// head kh from one read of each K/V tile, so K and V are read once in
// all. A CTA whose keys all lie at or past kv_len[b] reads nothing. The
// wrapper picks the split count so that about four CTAs per SM are
// launched even when B * Kh is small (12 for SmolLM's decode at B=4). Per
// tile of 32 keys, the 128 threads stage K (rows padded to D + 4 floats, so
// that a warp's 16-byte row reads are free of bank conflicts) and V in
// shared memory as float32; warp w computes the scores of heads w, w + 4,
// ..., one key per lane, and keeps (m, l) for them; then each thread adds
// p * V into the accumulator of one head-dim column for its heads. Each
// CTA writes its partial (m, l, acc) and a second kernel, one block per
// (b, h), rescales and adds the splits. S need not be a multiple of
// anything: ragged tiles are bound-checked. D is a template parameter in
// {16, 32, 64, 128}; G is at most 16.
//
// Bound on this card: bytes. K and V have to be read up to kv_len, once:
// at qwen3-14b's B=8, Kh=8, D=128, S=8192, full, in float32 that is 537 MB,
// 0.16 ms at 3.35 TB/s; the 2 * G * D flops per key are 1.25 flop a byte
// at G=5, far below the card's 20 float32 flop a byte. q, out and the
// partials are a few megabytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;          // keys per tile: one per lane in scores
constexpr int kMaxG = 16;          // query heads per KV head
constexpr int kHeadsPerWarp = kMaxG / kWarps;

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Strides {
  long long b, h, s;               // elements between batches, heads, keys
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ kv_len,
                    float* __restrict__ part_acc, float* __restrict__ part_m,
                    float* __restrict__ part_l, int H, int Kh, int S,
                    int chunk, int splits, Strides ks_, Strides vs_,
                    float scale) {
  constexpr int kPad = D + 4;
  constexpr int kGroups = kThreads / D;            // head groups in p * V
  constexpr int kAcc = (kMaxG + kGroups - 1) / kGroups;
  __shared__ __align__(16) float ks[kTile * kPad];
  __shared__ __align__(16) float vs[kTile * D];
  __shared__ __align__(16) float qs[kMaxG * D];
  __shared__ float ps[kMaxG * kTile];
  __shared__ float corr_s[kMaxG];

  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / Kh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = max(0, min(kv_len[b], S));
  const int s0 = split * chunk;
  const int s1 = min(s0 + chunk, len);

  const T* qb = q + ((long long)b * H + (long long)kh * G) * D;
  for (int idx = tid; idx < G * D; idx += kThreads) qs[idx] = to_f32(qb[idx]);
  const T* kb = k + b * ks_.b + kh * ks_.h;
  const T* vb = v + b * vs_.b + kh * vs_.h;

  float m_run[kHeadsPerWarp], l_run[kHeadsPerWarp];
#pragma unroll
  for (int i = 0; i < kHeadsPerWarp; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
  }
  const int col = tid % D, grp = tid / D;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  for (int j0 = s0; j0 < s1; j0 += kTile) {
    __syncthreads();                 // the last tile has been read
    for (int idx = tid; idx < kTile * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      const int j = j0 + r;
      const bool in = j < s1;
      ks[r * kPad + c] = in ? to_f32(kb[j * ks_.s + c]) : 0.f;
      vs[r * D + c] = in ? to_f32(vb[j * vs_.s + c]) : 0.f;
    }
    __syncthreads();

    const bool valid = j0 + lane < s1;
#pragma unroll
    for (int i = 0; i < kHeadsPerWarp; ++i) {
      const int g = warp + i * kWarps;
      if (g < G) {                   // uniform over the warp
        const float4* kr = reinterpret_cast<const float4*>(ks + lane * kPad);
        const float4* qr = reinterpret_cast<const float4*>(qs + g * D);
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < D / 4; ++c) {
          const float4 kk = kr[c], qq = qr[c];
          s = fmaf(qq.x, kk.x, s);
          s = fmaf(qq.y, kk.y, s);
          s = fmaf(qq.z, kk.z, s);
          s = fmaf(qq.w, kk.w, s);
        }
        s = valid ? s * scale : -INFINITY;
        // the tile holds at least one valid key, so m_new is finite
        const float m_new = fmaxf(m_run[i], warp_max(s));
        const float p = expf(s - m_new);
        const float corr = expf(m_run[i] - m_new);  // 0 on the first tile
        l_run[i] = l_run[i] * corr + warp_sum(p);
        m_run[i] = m_new;
        ps[g * kTile + lane] = p;
        if (lane == 0) corr_s[g] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int g = grp + i * kGroups;
      if (g < G) {
        float a = acc[i] * corr_s[g];
#pragma unroll 8
        for (int r = 0; r < kTile; ++r) {
          a = fmaf(ps[g * kTile + r], vs[r * D + col], a);
        }
        acc[i] = a;
      }
    }
  }

  const long long head0 = (long long)b * H + (long long)kh * G;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int g = grp + i * kGroups;
    if (g < G) part_acc[((head0 + g) * splits + split) * D + col] = acc[i];
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kHeadsPerWarp; ++i) {
      const int g = warp + i * kWarps;
      if (g < G) {
        part_m[(head0 + g) * splits + split] = m_run[i];
        part_l[(head0 + g) * splits + split] = l_run[i];
      }
    }
  }
}

// One block of D threads per (b, h): the splits' partial sums, rescaled to
// their common max, added and divided. No valid key at all gives zeros.
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_acc,
                                      const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      T* __restrict__ out, int D,
                                      int splits) {
  const long long bh = blockIdx.x;
  const int c = threadIdx.x;
  const float* pm = part_m + bh * splits;
  const float* pl = part_l + bh * splits;
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, pm[s]);
  float l = 0.f, a = 0.f;
  if (m != -INFINITY) {
    for (int s = 0; s < splits; ++s) {
      const float w = expf(pm[s] - m);           // 0 for an empty split
      l = fmaf(pl[s], w, l);
      a = fmaf(part_acc[(bh * splits + s) * D + c], w, a);
    }
  }
  out[bh * D + c] = from_f32<T>(a / fmaxf(l, 1e-30f));
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* kv_len,
           void* out, float* part_acc, float* part_m, float* part_l, int B,
           int H, int Kh, int S, int D, int splits, int chunk, Strides ks,
           Strides vs, float scale, cudaStream_t stream) {
  const dim3 grid((unsigned)splits, (unsigned)Kh, (unsigned)B);
#define DECODE_CASE(DIM)                                                   \
  case DIM:                                                                \
    decode_split_kernel<T, DIM><<<grid, kThreads, 0, stream>>>(            \
        (const T*)q, (const T*)k, (const T*)v, kv_len, part_acc, part_m,   \
        part_l, H, Kh, S, chunk, splits, ks, vs, scale);                   \
    break;
  switch (D) {
    DECODE_CASE(16)
    DECODE_CASE(32)
    DECODE_CASE(64)
    DECODE_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DECODE_CASE
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<T><<<(unsigned)(B * H), D, 0, stream>>>(
      part_acc, part_m, part_l, (T*)out, D, splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike). part_acc is
// [B, H, splits, D] float32 scratch, part_m and part_l [B, H, splits]. The
// strides are in elements. Launches both kernels on `stream` (a
// cudaStream_t) of device `device` and returns cudaGetLastError() as an
// int (0 = launched).
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* kv_len, void* out, void* part_acc,
                            void* part_m, void* part_l, int B, int H, int Kh,
                            int S, int D, int splits, int chunk,
                            long long k_sb, long long k_sh, long long k_ss,
                            long long v_sb, long long v_sh, long long v_ss,
                            float scale, int dtype, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || H <= 0) return 0;
  if (Kh <= 0 || H % Kh != 0 || H / Kh > kMaxG || splits <= 0 ||
      chunk <= 0 || B > 65535 || Kh > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const Strides ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss};
  if (dtype == 0) {
    return launch<float>(q, k, v, (const int*)kv_len, out, (float*)part_acc,
                         (float*)part_m, (float*)part_l, B, H, Kh, S, D,
                         splits, chunk, ks, vs, scale, (cudaStream_t)stream);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, k, v, (const int*)kv_len, out,
                                 (float*)part_acc, (float*)part_m,
                                 (float*)part_l, B, H, Kh, S, D, splits,
                                 chunk, ks, vs, scale, (cudaStream_t)stream);
  }
  return (int)cudaErrorInvalidValue;
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
