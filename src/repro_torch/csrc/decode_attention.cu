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
//
// That kernel (decode_split_kernel) serves float32. bfloat16 takes
// decode_bf16_kernel (namespace mma below), on the tensor cores, with the
// same grid, strides and combine kernel; its split plan
// (kernel.py::bf16_plan) cuts S into 64-key tiles and fills one wave of
// the CTAs an SM holds (decode_bf16_ctas_per_sm, the occupancy
// calculator's count). The CUDA-core kernel took the same time in bf16 as
// in float32 (0.398 and 0.395 ms at qwen3-14b's full cache) for half the
// bytes: it staged K and V as float32 from 2-byte loads, with one buffer
// and two barriers a tile, and read p and V from shared memory with scalar
// loads. Here:
//   - K and V stay bf16 and are copied with 16-byte cp.async.cg per thread
//     (zero-filled past kv_len) into a ring of 3 stages of 64 keys, one
//     barrier a stage, so two tiles are in flight while one is computed;
//     a row's 16-byte pieces are XOR-swizzled with its low bits, so that
//     ldmatrix reads are free of bank conflicts;
//   - the G <= 16 query heads of a KV head are the 16 rows of a
//     mma.sync.m16n8k16 A operand, held in registers for the whole CTA
//     (rows past G are zero); each warp takes 16 keys of every tile: the
//     scores [16 x 16] from K through ldmatrix, an online softmax in
//     base 2, P rounded to bf16 in registers as the A fragment of P V, V
//     through ldmatrix.trans, O [16 x D] in registers;
//   - the four warps' (m, l, O) are combined in shared memory at the end
//     and written as the split's partials, which the combine kernel adds.
// wgmma is not used: its 64 rows would pad G four times more, and the
// kernel is bound by bytes, not by operations. Times (chip_smoke.py, H100
// SXM at 700 W): 0.098 ms at qwen3-14b's full cache (bound 0.080 ms,
// 2.74 TB/s; SDPA 0.108 ms), 0.0142 ms at SmolLM's decode (launch-bound).
// (kernels/decode_attention/ref.py::decode_attention_kernel_order follows
// this order on the CPU: per warp and split, P rounded to bf16 per tile.)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;          // keys per tile: one per lane in scores
constexpr int kMaxG = 16;          // query heads per KV head
constexpr int kHeadsPerWarp = kMaxG / kWarps;

__device__ __forceinline__ float to_f32(float v) { return v; }

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
// their common max, added and divided. No valid key at all (kv_len[b] = 0)
// gives NaN, a softmax over nothing, as the plain version and the
// reference's oracle do.
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
  if (m == -INFINITY) {
    out[bh * D + c] = from_f32<T>(__int_as_float(0x7fffffff));   // NaN
    return;
  }
  float l = 0.f, a = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float w = expf(pm[s] - m);             // 0 for an empty split
    l = fmaf(pl[s], w, l);
    a = fmaf(part_acc[(bh * splits + s) * D + c], w, a);
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

// ---------------------------------------------------------------------------
// The bfloat16 split kernel on the tensor cores.
// ---------------------------------------------------------------------------
namespace mma {

constexpr int kTile = 64;          // keys per stage: 16 for each warp
constexpr int kStages = 3;         // cp.async ring depth
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Cfg {
  static constexpr int kRowBytes = D * 2;
  static constexpr int kChunks = D / 8;              // 16-byte pieces a row
  // XOR of a row's 16-byte pieces with its low bits, so that the 8 rows
  // an ldmatrix reads lie in 8 different bank groups
  static constexpr int kSwizzle = (kChunks < 8 ? kChunks : 8) - 1;
  static constexpr int kTileBytes = kTile * kRowBytes;       // K or V
  static constexpr int kSmem = kStages * 2 * kTileBytes;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes if !in.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c[16 x 8] += a[16 x 16] b[16 x 8], bf16 in, fp32 accumulated
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Grid (split, Kh, B), 128 threads. The G query heads of KV head kh are
// the rows of a 16-row A operand (rows >= G are zero). Each 64-key tile of
// the ring is cut over the four warps, 16 keys each; a warp keeps its own
// online softmax (m, l) and O [16 x D] in registers, and the four are
// combined at the end. Scores and m are in base-2 units (scale_log2 =
// log2(e) / sqrt(D)); the partial m is written in natural units, as the
// combine kernel reads it.
template <int D>
__global__ void __launch_bounds__(128)
decode_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const int* __restrict__ kv_len,
                   float* __restrict__ part_acc, float* __restrict__ part_m,
                   float* __restrict__ part_l, int H, int Kh, int S,
                   int chunk, int splits, Strides ks_, Strides vs_,
                   float scale_log2) {
  using C = Cfg<D>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / Kh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane / 4, quad = lane % 4;
  const int len = max(0, min(kv_len[b], S));
  const int s0 = split * chunk;
  const int s1 = min(s0 + chunk, len);
  const int n_tiles = s1 > s0 ? (s1 - s0 + kTile - 1) / kTile : 0;

  const __nv_bfloat16* kb = k + b * ks_.b + kh * ks_.h;
  const __nv_bfloat16* vb = v + b * vs_.b + kh * vs_.h;
  const uint32_t ring = smem_u32(smem);

  // the copies of tile t into stage t % kStages: K then V, 16 bytes a
  // thread a step; keys at or past s1 are zero-filled
  auto load = [&](int t) {
    const uint32_t kd = ring + (t % kStages) * 2 * C::kTileBytes;
    const uint32_t vd = kd + C::kTileBytes;
    const int j0 = s0 + t * kTile;
#pragma unroll
    for (int i = 0; i < kTile * C::kChunks / 128; ++i) {
      const int idx = tid + 128 * i;
      const int r = idx / C::kChunks, c = idx % C::kChunks;
      const bool in = j0 + r < s1;
      const long long j = in ? j0 + r : s0;
      const uint32_t off = r * C::kRowBytes
                           + ((c ^ (r & C::kSwizzle)) * 16);
      cp_async16(kd + off, kb + j * ks_.s + c * 8, in);
      cp_async16(vd + off, vb + j * vs_.s + c * 8, in);
    }
  };

  // Q as the A fragments of D / 16 k-steps: rows g and g + 8 are heads
  const __nv_bfloat16* qb = q + ((long long)b * H + (long long)kh * G) * D;
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = g + 8 * (i & 1);
      const int col = kk * 16 + 2 * quad + 8 * (i >> 1);
      qa[kk][i] = row < G ? *reinterpret_cast<const uint32_t*>(
                                qb + row * D + col)
                          : 0u;
    }
  }

  float o[D / 8][4];
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[c][e] = 0.f;
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) load(t);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();      // this thread's copies of tile t
    __syncthreads();                   // everyone's, and tile t-1 is read
    if (t + kStages - 1 < n_tiles) load(t + kStages - 1);
    cp_async_commit();

    const uint32_t kt = ring + (t % kStages) * 2 * C::kTileBytes;
    const uint32_t vt = kt + C::kTileBytes;
    const int key_w = warp * 16;       // this warp's keys in the tile

    // scores [16 heads x 16 keys] as two n8 pieces
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int mi = lane / 8;
      const int r = key_w + (mi / 2) * 8 + (lane % 8);
      const int c = 2 * kk + (mi % 2);
      uint32_t kf[4];
      ldmatrix_x4(kf, kt + r * C::kRowBytes + ((c ^ (r & C::kSwizzle)) * 16));
      mma_bf16(sc[0], qa[kk], kf[0], kf[1]);
      mma_bf16(sc[1], qa[kk], kf[2], kf[3]);
    }

    const int j0 = s0 + t * kTile + key_w;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + n * 8 + 2 * quad + (e & 1);
        const float x = j < s1 ? sc[n][e] * scale_log2 : -INFINITY;
        sc[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float m_use[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      // no valid key yet for this warp: p = 0 and corr = 0
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      corr[r] = ex2(m[r] - m_use[r]);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[n][e] = ex2(sc[n][e] - m_use[e >> 1]);
        l[e >> 1] += sc[n][e];
      }
    }
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[c][e] *= corr[e >> 1];
    }
    // P [16 heads x 16 keys] as the A fragment, rounded to bf16
    const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]),
                            pack_bf16(sc[0][2], sc[0][3]),
                            pack_bf16(sc[1][0], sc[1][1]),
                            pack_bf16(sc[1][2], sc[1][3])};
    // O += P V, V [16 keys x D] through ldmatrix.trans, two n8 pieces a load
#pragma unroll
    for (int dc = 0; dc < D / 16; ++dc) {
      const int mi = lane / 8;
      const int r = key_w + (mi % 2) * 8 + (lane % 8);
      const int c = 2 * dc + (mi / 2);
      uint32_t vf[4];
      ldmatrix_x4_trans(vf,
                        vt + r * C::kRowBytes + ((c ^ (r & C::kSwizzle)) * 16));
      mma_bf16(o[2 * dc], pa, vf[0], vf[1]);
      mma_bf16(o[2 * dc + 1], pa, vf[2], vf[3]);
    }
  }

  // combine the four warps through shared memory (the ring is free)
  cp_async_wait<0>();
  __syncthreads();
  float* sm_o = reinterpret_cast<float*>(smem);        // [4][16][D]
  float* sm_m = sm_o + 4 * 16 * D;                     // [4][16]
  float* sm_l = sm_m + 4 * 16;                         // [4][16]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (quad == 0) {
      sm_m[warp * 16 + g + 8 * r] = m[r];
      sm_l[warp * 16 + g + 8 * r] = l[r];
    }
  }
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float2* dst = reinterpret_cast<float2*>(
          sm_o + (warp * 16 + g + 8 * r) * D + c * 8 + 2 * quad);
      *dst = make_float2(o[c][2 * r], o[c][2 * r + 1]);
    }
  }
  __syncthreads();
  const long long head0 = (long long)b * H + (long long)kh * G;
  for (int idx = tid; idx < G * D; idx += 128) {
    const int row = idx / D, col = idx % D;
    float mw[4], mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      mw[w] = sm_m[w * 16 + row];
      mm = fmaxf(mm, mw[w]);
    }
    float acc = 0.f, lsum = 0.f;
    if (mm != -INFINITY) {
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float wt = ex2(mw[w] - mm);      // 0 for a warp with no key
        acc = fmaf(sm_o[(w * 16 + row) * D + col], wt, acc);
        lsum = fmaf(sm_l[w * 16 + row], wt, lsum);
      }
    }
    part_acc[((head0 + row) * splits + split) * D + col] = acc;
    if (col == 0) {
      part_m[(head0 + row) * splits + split] = mm * kLn2;
      part_l[(head0 + row) * splits + split] = lsum;
    }
  }
}

// Lets decode_bf16_kernel<D> take its ring's dynamic shared memory (once).
template <int D>
int allow_smem() {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Cfg<D>::kSmem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  return 0;
}

// CTAs of decode_bf16_kernel<D> an SM holds at once (registers, shared
// memory and threads counted by the occupancy calculator).
template <int D>
int ctas_per_sm(int* out) {
  int err = allow_smem<D>();
  if (err != 0) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, decode_bf16_kernel<D>, 128, Cfg<D>::kSmem);
}

template <int D>
int launch_split(const void* q, const void* k, const void* v,
                 const int* kv_len, float* part_acc, float* part_m,
                 float* part_l, int B, int H, int Kh, int S, int splits,
                 int chunk, Strides ks, Strides vs, float scale,
                 cudaStream_t stream) {
  using C = Cfg<D>;
  int err = allow_smem<D>();
  if (err != 0) return err;
  const dim3 grid((unsigned)splits, (unsigned)Kh, (unsigned)B);
  decode_bf16_kernel<D><<<grid, 128, C::kSmem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, kv_len, part_acc, part_m, part_l, H, Kh, S,
      chunk, splits, ks, vs, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace mma

namespace {

// The bf16 split kernel for head dim D, then the combine kernel.
int launch_bf16(const void* q, const void* k, const void* v,
                const int* kv_len, void* out, float* part_acc, float* part_m,
                float* part_l, int B, int H, int Kh, int S, int D, int splits,
                int chunk, Strides ks, Strides vs, float scale,
                cudaStream_t stream) {
  int err;
  switch (D) {
    case 16:
      err = mma::launch_split<16>(q, k, v, kv_len, part_acc, part_m, part_l,
                                  B, H, Kh, S, splits, chunk, ks, vs, scale,
                                  stream);
      break;
    case 32:
      err = mma::launch_split<32>(q, k, v, kv_len, part_acc, part_m, part_l,
                                  B, H, Kh, S, splits, chunk, ks, vs, scale,
                                  stream);
      break;
    case 64:
      err = mma::launch_split<64>(q, k, v, kv_len, part_acc, part_m, part_l,
                                  B, H, Kh, S, splits, chunk, ks, vs, scale,
                                  stream);
      break;
    case 128:
      err = mma::launch_split<128>(q, k, v, kv_len, part_acc, part_m,
                                   part_l, B, H, Kh, S, splits, chunk, ks,
                                   vs, scale, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  decode_combine_kernel<__nv_bfloat16><<<(unsigned)(B * H), D, 0, stream>>>(
      part_acc, part_m, part_l, (__nv_bfloat16*)out, D, splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (decode_split_kernel), 1 = bfloat16
// (decode_bf16_kernel; k and v 16-byte aligned, their strides multiples
// of 8 elements), for q, k, v and out alike. part_acc is
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
    return launch_bf16(q, k, v, (const int*)kv_len, out, (float*)part_acc,
                       (float*)part_m, (float*)part_l, B, H, Kh, S, D,
                       splits, chunk, ks, vs, scale, (cudaStream_t)stream);
  }
  return (int)cudaErrorInvalidValue;
}

// The bfloat16 split kernel's CTAs per SM at head dim D on device
// `device`, into *out (the wrapper's split plan fills one wave of them).
// Returns a cudaError_t as an int (0 = done).
int decode_bf16_ctas_per_sm(int D, int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  switch (D) {
    case 16: return mma::ctas_per_sm<16>(out);
    case 32: return mma::ctas_per_sm<32>(out);
    case 64: return mma::ctas_per_sm<64>(out);
    case 128: return mma::ctas_per_sm<128>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
