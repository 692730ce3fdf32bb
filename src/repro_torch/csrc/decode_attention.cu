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
// kv_len[b] = 0 gives NaN, a softmax over nothing, as the plain version
// does.
//
// Grid. The TPU kernel's grid is (b, h, S / bs) with the S axis in order
// on one core, carrying (m, l, acc) in VMEM, and it reads every KV head
// once per query head. Here the work is split over S (flash-decoding):
// CTA (split, kh, b) of 128 threads takes the keys [split * chunk,
// (split + 1) * chunk) that lie below kv_len[b] and serves all G = H / Kh
// <= 16 query heads of KV head kh from one read of each K/V stage, so K
// and V are read once in all; a CTA whose keys all lie at or past
// kv_len[b] reads nothing. Each ring stage of 64 keys is cut over the four
// warps, 16 keys each, and each warp keeps its own online softmax (base 2,
// ex2.approx) and output in registers. At the end the four warps are
// combined through shared memory and the CTA writes its split's partial
// (m, l, acc); a second kernel, one block per (b, h), rescales and adds
// the splits. The split count (kernel.py wave_plan) fills one wave of the
// CTAs an SM holds, as the occupancy calculator counts them
// (decode_ctas_per_sm). Any S; D in {16, 32, 64, 128}.
//
// Bound on this card: bytes. K and V have to be read up to kv_len, once:
// at qwen3-14b's B=8, Kh=8, D=128, S=8192, full, that is 537 MB in float32,
// 0.160 ms at 3.35 TB/s (268 MB, 0.080 ms in bfloat16); the 4 * G * D
// flops a key are 1.25 flop a byte at G=5 in float32, far below the card's
// rates. q, out and the partials are a few megabytes.
//
// float32: decode_tf32_kernel (namespace tf32 below), on the tensor cores
// in 3xTF32. The first float32 kernel did the products on the CUDA cores:
// 32-key tiles copied by scalar loads into one buffer, two barriers a
// tile, nothing in flight during the arithmetic; every score re-read its
// K row once per query head and every p * V term took two shared loads,
// about 70 shared-memory wavefronts a key at qwen3-14b's G = 5, D = 128
// (0.13-0.15 ms of the 0.160 ms bound, not overlapped with the loads). It
// took 0.402 ms there, slower than the plain PyTorch version. Here:
//   - K and V stay float32 and are copied with 16-byte cp.async.cg per
//     thread (zero-filled at and past min(kv_len[b], S) and the split's
//     end) into a ring of 3 stages, one barrier a stage, so two stages are
//     in flight while one is computed; rows padded to D + 4 floats. At
//     D = 128 the ring is 198 KB and one CTA fits an SM (two at D = 64);
//   - S and P V are mma.sync.m16n8k8 in 3xTF32 (tf32x3.cuh): each operand
//     split as hi = tf32(x), lo = tf32(x - hi), and each 8-wide block of
//     the summed axis a_lo b_hi + a_hi b_lo + a_hi b_hi into a zeroed
//     temporary added to S or O in float32 (mma3), since the tensor cores
//     cut each product step toward zero relative to their accumulator;
//   - the products run transposed: S^T [16 keys x 8 heads] = K Q^T and
//     O^T [D x 8 heads] += V^T P^T, so that the G heads fill the n = 8
//     side of the product and nothing is padding when G <= 8 (kNH = 1; two
//     head blocks for G <= 16). The first version of this kernel put the
//     heads on the 16 rows of A (rows >= G zero): twice the mma.sync and
//     Q's halves 128 registers a thread at D = 128, which held it at 255
//     registers with spill and two 8-key slices a warp; this layout does
//     half the products with Q's halves in 64 registers;
//   - K's A fragment is one ldmatrix.x4 of its rows' 16-byte pieces as
//     they lie (thread (g, t) receives K[g][4p + t] of piece p, rows g and
//     g + 8); Q^T's B fragment is split once and kept in registers. V^T's
//     A fragment is read by scalar loads (ldmatrix.trans moves 16-bit
//     elements), V[2t][16mb + g] and its neighbours, with each 8-key
//     block's keys renumbered (slot t is key 2t, slot t + 4 key 2t + 1);
//     the D + 4 padding makes both reads free of bank conflicts: 2 * D * 4
//     / 128 wavefronts a key (8 at D = 128), whatever G is. P^T's B
//     fragment (head g, keys 2t and 2t + 1) comes from the lanes that hold
//     those keys of S^T by four shuffles a head block and 8 keys;
//   - wgmma is not used: its 64 rows would pad a 16-key warp slice four
//     times over, and the kernel is bound by bytes.
// decode_tf32_kernel<D, 1, true> (decode_attention_loads_launch) runs the
// same copies, barriers and combine with no arithmetic, to measure the
// memory path's share. (kernels/decode_attention/ref.py::
// decode_attention_tf32x3_order follows the kernel's arithmetic on the
// CPU.)
//
// bfloat16: decode_bf16_kernel (namespace mma below), on the tensor cores.
//   - K and V stay bf16 and are copied with 16-byte cp.async.cg per thread
//     (zero-filled past kv_len) into a ring of 3 stages of 64 keys, one
//     barrier a stage; a row's 16-byte pieces are XOR-swizzled with its
//     low bits, so that ldmatrix reads are free of bank conflicts;
//   - the G query heads are the rows of a mma.sync.m16n8k16 A operand;
//     each warp takes 16 keys of every stage: the scores [16 x 16] from K
//     through ldmatrix, an online softmax in base 2, P rounded to bf16 in
//     registers as the A fragment of P V, V through ldmatrix.trans.
// (kernels/decode_attention/ref.py::decode_attention_kernel_order follows
// this order on the CPU: per warp and split, P rounded to bf16 per tile.)
//
// Times (chip_smoke.py phase 12, NVIDIA H100 80GB HBM3, 700.00 W), ms a
// launch (split and combine kernels):
//   qwen3-14b full cache, float32: 0.188 (bound 0.160; its copies alone
//     0.180; plain PyTorch 0.363, SDPA 3.79; the CUDA-core kernel 0.401 in
//     tools/kernel_ab.py's call);
//   qwen3-14b ragged kv_len: 0.173 (bound 0.071; copies alone 0.111): the
//     split plan cuts S, not kv_len, so the longest sequences' CTAs carry
//     4096 keys each, and their copies and arithmetic overlap only in
//     part;
//   SmolLM-135M decode: 0.0164 (copies alone 0.0139; launch-bound);
//   bfloat16: 0.095 at qwen3-14b's full cache (bound 0.080; SDPA 0.103),
//     0.0159 at SmolLM's decode.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tf32x3.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;          // query heads per KV head: A's 16 rows
constexpr int kStages = 3;         // cp.async ring depth of both kernels
constexpr int kStage = kWarps * 16;  // keys a ring stage of both: 16 a warp
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct Strides {
  long long b, h, s;               // elements between batches, heads, keys
};

// The four warps' (m, l, O) of a split, staged in shared memory by the
// kernel as sm_o [4][16][D], sm_m [4][16], sm_l [4][16] (`smem`, free once
// the ring is drained: 4 * 16 * (D + 2) floats; m in base-2 units),
// combined and written as the split's partials, m in natural units as the
// combine kernel reads it. Rows >= G are not read.
template <int D>
__device__ __forceinline__ void combine_warps(
    const float* smem, float* __restrict__ part_acc,
    float* __restrict__ part_m, float* __restrict__ part_l, long long head0,
    int G, int split, int splits) {
  const float* sm_o = smem;
  const float* sm_m = sm_o + kWarps * 16 * D;
  const float* sm_l = sm_m + kWarps * 16;
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int row = idx / D, col = idx % D;
    float mw[kWarps], mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      mw[w] = sm_m[w * 16 + row];
      mm = fmaxf(mm, mw[w]);
    }
    float acc = 0.f, lsum = 0.f;
    if (mm != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float wt = tf32::ex2(mw[w] - mm);  // 0 for a warp with no key
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

}  // namespace

// ---------------------------------------------------------------------------
// The bfloat16 split kernel on the tensor cores.
// ---------------------------------------------------------------------------
namespace mma {

using tf32::cp_async16;
using tf32::ex2;
using tf32::smem_u32;

constexpr int kTile = kStage;

template <int D>
struct Cfg {
  static constexpr int kTile = mma::kTile;
  static constexpr int kRowBytes = D * 2;
  static constexpr int kChunks = D / 8;              // 16-byte pieces a row
  // XOR of a row's 16-byte pieces with its low bits, so that the 8 rows
  // an ldmatrix reads lie in 8 different bank groups
  static constexpr int kSwizzle = (kChunks < 8 ? kChunks : 8) - 1;
  static constexpr int kTileBytes = kTile * kRowBytes;       // K or V
  static constexpr int kSmem = kStages * 2 * kTileBytes;
};

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Grid (split, Kh, B), 128 threads. The G query heads of KV head kh are
// the rows of a 16-row A operand (rows >= G are zero). Each 64-key tile of
// the ring is cut over the four warps, 16 keys each; a warp keeps its own
// online softmax (m, l) and O [16 x D] in registers, and the four are
// combined at the end. Scores and m are in base-2 units (scale_log2 =
// log2(e) / sqrt(D)).
template <int D>
__global__ void __launch_bounds__(kThreads)
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
    for (int i = 0; i < kTile * C::kChunks / kThreads; ++i) {
      const int idx = tid + kThreads * i;
      const int r = idx / C::kChunks, c = idx % C::kChunks;
      const bool in = j0 + r < s1;
      const long long j = in ? j0 + r : s0;
      const uint32_t off = r * C::kRowBytes
                           + ((c ^ (r & C::kSwizzle)) * 16);
      cp_async16(kd + off, kb + j * ks_.s + c * 8, in ? 16 : 0);
      cp_async16(vd + off, vb + j * vs_.s + c * 8, in ? 16 : 0);
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
    tf32::cp_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    tf32::cp_wait<kStages - 2>();      // this thread's copies of tile t
    __syncthreads();                   // everyone's, and tile t-1 is read
    if (t + kStages - 1 < n_tiles) load(t + kStages - 1);
    tf32::cp_commit();

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

  // stage the warp's rows g and g + 8 of O (columns 8c + 2 quad, + 1), m
  // and l in shared memory (the ring is free), then combine the warps
  tf32::cp_wait<0>();
  __syncthreads();
  float* sm_o = reinterpret_cast<float*>(smem);        // [4][16][D]
  float* sm_m = sm_o + kWarps * 16 * D;                // [4][16]
  float* sm_l = sm_m + kWarps * 16;                    // [4][16]
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
  combine_warps<D>(sm_o, part_acc, part_m, part_l,
                   (long long)b * H + (long long)kh * G, G, split, splits);
}

}  // namespace mma

// ---------------------------------------------------------------------------
// The float32 split kernel on the tensor cores, in 3xTF32.
// ---------------------------------------------------------------------------
namespace tf32 {

template <int D>
struct Cfg {
  static constexpr int kTile = kStage;
  static constexpr int kStride = D + 4;   // floats a shared row: no conflicts
  static constexpr int kRows = kTile * kStride;              // floats, K or V
  static constexpr int kRing = kStages * 2 * kRows * 4;      // bytes
  static constexpr int kCombine = kWarps * 16 * (D + 2) * 4; // bytes
  static constexpr int kSmem = kRing > kCombine ? kRing : kCombine;
};

// Grid (split, Kh, B), 128 threads; each stage of 64 keys is cut over the
// four warps, 16 keys each. The products run transposed, so that the G
// heads fill the n = 8 side of m16n8k8 and no row of the tensor cores'
// work is padding when G <= 8: S^T [16 keys x 8 heads] = K Q^T with K's
// rows as the A operand (through ldmatrix) and Q^T as B (split once into
// TF32 halves, held in registers); O^T [D x 8 heads] += V^T P^T with V^T
// as A (scalar loads) and P^T as B. kNH blocks of 8 heads: 1 for G <= 8,
// 2 for G <= 16. Thread (g, t) keeps heads 8 nh + 2t and + 1: their (m, l)
// in base-2 units (scale_log2 = log2(e) / sqrt(D)) and their O^T columns.
// kLoadsOnly: the same copies, barriers and partials with no arithmetic
// (each thread adds one float of K and one of V a stage, so that a stage
// is read), for measuring.
template <int D, int kNH, bool kLoadsOnly>
__global__ void __launch_bounds__(kThreads)
decode_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const int* __restrict__ kv_len,
                   float* __restrict__ part_acc, float* __restrict__ part_m,
                   float* __restrict__ part_l, int H, int Kh, int S,
                   int chunk, int splits, Strides ks_, Strides vs_,
                   float scale_log2) {
  using C = Cfg<D>;
  constexpr int kDB = D / 8;             // 8-column blocks of D: S's k-steps
  constexpr int kMB = D / 16;            // 16-row blocks of O^T
  constexpr int kPieces = D / 4;         // 16-byte pieces a row
  constexpr uint32_t kStageBytes = 2 * C::kRows * 4;
  extern __shared__ __align__(16) float smem[];
  const int part = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / Kh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane / 4, t = lane % 4;
  const int len = max(0, min(kv_len[b], S));
  const int s0 = part * chunk;
  const int s1 = min(s0 + chunk, len);
  const int n_tiles = s1 > s0 ? (s1 - s0 + C::kTile - 1) / C::kTile : 0;

  const float* kb = k + b * ks_.b + kh * ks_.h;
  const float* vb = v + b * vs_.b + kh * vs_.h;
  const uint32_t ring = smem_u32(smem);

  // the K and V rows of stage `tile` into ring stage tile % kStages, 16
  // bytes a copy; keys at or past s1 are zero-filled
  auto load = [&](int tile) {
    const uint32_t kd = ring + (tile % kStages) * kStageBytes;
    const uint32_t vd = kd + C::kRows * 4;
    const int j0 = s0 + tile * C::kTile;
#pragma unroll
    for (int i = 0; i < C::kTile * kPieces / kThreads; ++i) {
      const int idx = tid + kThreads * i;
      const int r = idx / kPieces, c = idx % kPieces;
      const bool in = j0 + r < s1;
      const long long j = in ? j0 + r : s0;
      const uint32_t off = (uint32_t)((r * C::kStride + c * 4) * 4);
      cp_async16(kd + off, kb + j * ks_.s + c * 4, in ? 16 : 0);
      cp_async16(vd + off, vb + j * vs_.s + c * 4, in ? 16 : 0);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load(s);
    cp_commit();
  }

  // Q^T's B fragments: head 8 nh + g, columns 8c + t (b0) and + 4 (b1),
  // split once into TF32 halves
  const float* qb = q + ((long long)b * H + (long long)kh * G) * D;
  uint32_t qh[kNH][kDB][2], ql[kNH][kDB][2];
#pragma unroll
  for (int nh = 0; nh < kNH; ++nh) {
#pragma unroll
    for (int c = 0; c < kDB; ++c) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int head = 8 * nh + g;
        split(!kLoadsOnly && head < G ? qb[head * D + c * 8 + t + 4 * e]
                                      : 0.f,
              qh[nh][c][e], ql[nh][c][e]);
      }
    }
  }
  // O^T of column block mb: rows 16 mb + g (e = 0, 1) and + 8 (e = 2, 3),
  // heads 8 nh + 2t + (e & 1)
  float o[kMB][kNH][4];
#pragma unroll
  for (int mb = 0; mb < kMB; ++mb) {
#pragma unroll
    for (int nh = 0; nh < kNH; ++nh) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mb][nh][e] = 0.f;
    }
  }
  float m[kNH][2], l[kNH][2];
#pragma unroll
  for (int nh = 0; nh < kNH; ++nh) {
    m[nh][0] = m[nh][1] = -INFINITY;
    l[nh][0] = l[nh][1] = 0.f;
  }
  // the lanes that hold keys 2t and 2t + 1 of a key block for head g
  // (P^T's B fragment below)
  const int src0 = 8 * t + g / 2, src1 = src0 + 4;

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_wait<kStages - 2>();              // this thread's copies of `tile`
    __syncthreads();                     // everyone's; tile - 1 is read
    if (tile + kStages - 1 < n_tiles) load(tile + kStages - 1);
    cp_commit();
    const uint32_t ks = ring + (tile % kStages) * kStageBytes;
    const float* vs = smem + (tile % kStages) * 2 * C::kRows + C::kRows;
    const int key_w = warp * 16;         // this warp's first key of the stage

    if constexpr (kLoadsOnly) {
      o[0][0][0] += smem[(tile % kStages) * 2 * C::kRows
                         + (key_w + g) * C::kStride + t]
                    + vs[(key_w + g) * C::kStride + t];
      continue;
    }

    // S^T = K Q^T, [16 keys x 8 heads] per head block. K's A fragment of
    // column block c is one ldmatrix.x4 of the 16-byte pieces 2c (matrices
    // 0, 1: key rows 0-7, 8-15) and 2c + 1 (2, 3): thread (g, t) receives
    // K[g][8c + t], K[g + 8][8c + t], K[g][8c + 4 + t], K[g + 8][8c + 4 + t]
    float s[kNH][4];
#pragma unroll
    for (int nh = 0; nh < kNH; ++nh) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nh][e] = 0.f;
    }
    const int row = key_w + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
    for (int c = 0; c < kDB; ++c) {
      uint32_t kf[4], ah[4], al[4];
      mma::ldmatrix_x4(kf, ks + (row * C::kStride + (2 * c + (lane >> 4)) * 4)
                               * 4);
#pragma unroll
      for (int e = 0; e < 4; ++e) split(__uint_as_float(kf[e]), ah[e], al[e]);
#pragma unroll
      for (int nh = 0; nh < kNH; ++nh) {
        mma3(s[nh], ah, al, qh[nh][c][0], qh[nh][c][1], ql[nh][c][0],
             ql[nh][c][1]);
      }
    }

    // scale, mask (only on a stage that crosses s1), online softmax in
    // base 2 per head: thread (g, t) holds keys g (e = 0, 1) and g + 8
    // (e = 2, 3) of heads 8 nh + 2t + (e & 1); a head's max and sum run
    // over the eight lanes of one t
    const int j0 = s0 + tile * C::kTile + key_w;
    const bool edge = s0 + (tile + 1) * C::kTile > s1;
    float corr[kNH][2];
#pragma unroll
    for (int nh = 0; nh < kNH; ++nh) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nh][e] * scale_log2;
        if (edge && j0 + g + 8 * (e >> 1) >= s1) x = -INFINITY;
        s[nh][e] = x;
      }
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        float mx = fmaxf(s[nh][h2], s[nh][h2 + 2]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        const float m_new = fmaxf(m[nh][h2], mx);
        // no valid key yet for this warp: p = 0 and corr = 0
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        corr[nh][h2] = ex2(m[nh][h2] - m_use);
        m[nh][h2] = m_new;
        s[nh][h2] = ex2(s[nh][h2] - m_use);
        s[nh][h2 + 2] = ex2(s[nh][h2 + 2] - m_use);
        l[nh][h2] = l[nh][h2] * corr[nh][h2] + (s[nh][h2] + s[nh][h2 + 2]);
      }
    }
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb) {
#pragma unroll
      for (int nh = 0; nh < kNH; ++nh) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[mb][nh][e] *= corr[nh][e & 1];
      }
    }

    // O^T += V^T P^T per 8-key block kb. The sum runs over keys, so each
    // block's key order is free: slot t is key 2t and slot t + 4 key
    // 2t + 1. V^T's A fragment of row block mb is V[2t][16 mb + g],
    // V[2t][16 mb + g + 8], V[2t + 1][16 mb + g], V[2t + 1][16 mb + g + 8];
    // P^T's B fragment is P[head 8 nh + g][2t] and [2t + 1], which lanes
    // src0 and src1 hold (elements 2 kb + (g & 1)): two shuffles a value
#pragma unroll
    for (int kb = 0; kb < 2; ++kb) {
      uint32_t bh[kNH][2], bl[kNH][2];
#pragma unroll
      for (int nh = 0; nh < kNH; ++nh) {
        const float x0 = __shfl_sync(0xffffffffu, s[nh][2 * kb], src0);
        const float x1 = __shfl_sync(0xffffffffu, s[nh][2 * kb + 1], src0);
        const float y0 = __shfl_sync(0xffffffffu, s[nh][2 * kb], src1);
        const float y1 = __shfl_sync(0xffffffffu, s[nh][2 * kb + 1], src1);
        split(g & 1 ? x1 : x0, bh[nh][0], bl[nh][0]);
        split(g & 1 ? y1 : y0, bh[nh][1], bl[nh][1]);
      }
      const float* vr = vs + (key_w + 8 * kb + 2 * t) * C::kStride + g;
#pragma unroll
      for (int mb = 0; mb < kMB; ++mb) {
        uint32_t ah[4], al[4];
        split(vr[16 * mb], ah[0], al[0]);
        split(vr[16 * mb + 8], ah[1], al[1]);
        split(vr[C::kStride + 16 * mb], ah[2], al[2]);
        split(vr[C::kStride + 16 * mb + 8], ah[3], al[3]);
#pragma unroll
        for (int nh = 0; nh < kNH; ++nh) {
          mma3(o[mb][nh], ah, al, bh[nh][0], bh[nh][1], bl[nh][0],
               bl[nh][1]);
        }
      }
    }
  }

  // stage the warp's O (heads 8 nh + 2t + (e & 1), columns 16 mb + g +
  // 8 (e >> 1)), m and l in shared memory (the ring is free), then combine
  // the warps
  cp_wait<0>();
  __syncthreads();
  float* sm_o = smem;                                  // [4][16][D]
  float* sm_m = sm_o + kWarps * 16 * D;                // [4][16]
  float* sm_l = sm_m + kWarps * 16;                    // [4][16]
#pragma unroll
  for (int nh = 0; nh < kNH; ++nh) {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float lw = kLoadsOnly ? 1.f : l[nh][h2];
      lw += __shfl_xor_sync(0xffffffffu, lw, 4);
      lw += __shfl_xor_sync(0xffffffffu, lw, 8);
      lw += __shfl_xor_sync(0xffffffffu, lw, 16);
      if (g == 0) {
        const int head = warp * 16 + 8 * nh + 2 * t + h2;
        sm_m[head] = kLoadsOnly ? 0.f : m[nh][h2];
        sm_l[head] = lw;
      }
    }
#pragma unroll
    for (int mb = 0; mb < kMB; ++mb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int head = warp * 16 + 8 * nh + 2 * t + (e & 1);
        sm_o[head * D + 16 * mb + g + 8 * (e >> 1)] = o[mb][nh][e];
      }
    }
  }
  __syncthreads();
  combine_warps<D>(sm_o, part_acc, part_m, part_l,
                   (long long)b * H + (long long)kh * G, G, part, splits);
}

}  // namespace tf32

namespace {

// Which kernel of a dtype: the float32 kernel with one or two heads a
// thread (G <= 8 or not), or its copies alone; bfloat16 has one kernel.
enum Variant { kShort = 0, kTall = 1, kLoads = 2 };

// The split kernel of (dtype, D, variant): dtype 0 float32
// (decode_tf32_kernel), 1 bfloat16 (decode_bf16_kernel), with its dynamic
// shared memory and its keys per ring stage.
template <int D>
struct Split {
  static const void* kernel(int dtype, Variant variant) {
    if (dtype != 0) return (const void*)mma::decode_bf16_kernel<D>;
    switch (variant) {
      case kShort: return (const void*)tf32::decode_tf32_kernel<D, 1, false>;
      case kTall: return (const void*)tf32::decode_tf32_kernel<D, 2, false>;
      default: return (const void*)tf32::decode_tf32_kernel<D, 1, true>;
    }
  }
  static int smem(int dtype) {
    return dtype == 0 ? tf32::Cfg<D>::kSmem : mma::Cfg<D>::kSmem;
  }
  // lets the kernel take smem(dtype) bytes (once per kernel and process)
  static int prepare(int dtype, Variant variant) {
    static bool done[2][3] = {{false, false, false}, {false, false, false}};
    if (!done[dtype][variant]) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel(dtype, variant),
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem(dtype));
      if (err != cudaSuccess) return (int)err;
      done[dtype][variant] = true;
    }
    return 0;
  }
  // CTAs of the kernel an SM holds at once
  static int ctas_per_sm(int dtype, Variant variant, int* out) {
    const int err = prepare(dtype, variant);
    if (err != 0) return err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, kernel(dtype, variant), kThreads, (size_t)smem(dtype));
  }
};

// f(std::integral_constant<int, D>) for D in {16, 32, 64, 128}
template <typename F>
int with_head_dim(int D, F&& f) {
  switch (D) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// The arithmetic kernel that serves G query heads a KV head.
Variant arithmetic(int G) { return G > 8 ? kTall : kShort; }

// The split kernel, then the combine kernel, on `stream`.
int launch(const void* q, const void* k, const void* v, const int* kv_len,
           void* out, float* part_acc, float* part_m, float* part_l, int B,
           int H, int Kh, int S, int D, int splits, int chunk,
           Strides ks, Strides vs, float scale, int dtype, bool loads_only,
           cudaStream_t stream) {
  const Variant variant = loads_only ? kLoads : arithmetic(H / Kh);
  return with_head_dim(D, [&](auto dim) {
    using P = Split<decltype(dim)::value>;
    int err = P::prepare(dtype, variant);
    if (err != 0) return err;
    float scale_log2 = scale * kLog2e;
    void* args[] = {&q, &k, &v, &kv_len, &part_acc, &part_m, &part_l, &H,
                    &Kh, &S, &chunk, &splits, &ks, &vs, &scale_log2};
    err = (int)cudaLaunchKernel(
        P::kernel(dtype, variant),
        dim3((unsigned)splits, (unsigned)Kh, (unsigned)B), dim3(kThreads),
        args, (size_t)P::smem(dtype), stream);
    if (err != 0) return err;
    const unsigned heads = (unsigned)(B * H);
    if (dtype == 0) {
      decode_combine_kernel<float><<<heads, D, 0, stream>>>(
          part_acc, part_m, part_l, (float*)out, D, splits);
    } else {
      decode_combine_kernel<__nv_bfloat16><<<heads, D, 0, stream>>>(
          part_acc, part_m, part_l, (__nv_bfloat16*)out, D, splits);
    }
    return (int)cudaGetLastError();
  });
}

int checked_launch(const void* q, const void* k, const void* v,
                   const void* kv_len, void* out, void* part_acc,
                   void* part_m, void* part_l, int B, int H, int Kh, int S,
                   int D, int splits, int chunk, long long k_sb,
                   long long k_sh, long long k_ss, long long v_sb,
                   long long v_sh, long long v_ss, float scale, int dtype,
                   bool loads_only, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || H <= 0) return 0;
  if (Kh <= 0 || H % Kh != 0 || H / Kh > kMaxG || splits <= 0 ||
      chunk <= 0 || B > 65535 || Kh > 65535 || (dtype != 0 && dtype != 1) ||
      (loads_only && dtype != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  return launch(q, k, v, (const int*)kv_len, out, (float*)part_acc,
                (float*)part_m, (float*)part_l, B, H, Kh, S, D, splits, chunk,
                Strides{k_sb, k_sh, k_ss}, Strides{v_sb, v_sh, v_ss},
                scale, dtype, loads_only, (cudaStream_t)stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (decode_tf32_kernel), 1 = bfloat16
// (decode_bf16_kernel), for q, k, v and out alike; k and v 16-byte
// aligned, their strides multiples of 16 bytes. chunk is the keys of a
// split, best a multiple of decode_stage(). part_acc is [B, H, splits, D] float32
// scratch, part_m and part_l [B, H, splits]. The strides are in elements.
// Launches both kernels on `stream` (a cudaStream_t) of device `device`
// and returns cudaGetLastError() as an int (0 = launched).
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* kv_len, void* out, void* part_acc,
                            void* part_m, void* part_l, int B, int H, int Kh,
                            int S, int D, int splits, int chunk,
                            long long k_sb, long long k_sh, long long k_ss,
                            long long v_sb, long long v_sh, long long v_ss,
                            float scale, int dtype, int device,
                            void* stream) {
  return checked_launch(q, k, v, kv_len, out, part_acc, part_m, part_l, B,
                        H, Kh, S, D, splits, chunk, k_sb, k_sh, k_ss,
                        v_sb, v_sh, v_ss, scale, dtype, false, device,
                        stream);
}

// For measuring only: decode_tf32_kernel's copies, barriers and partials
// alone, with no arithmetic (the memory path's share), then the combine
// kernel; float32 only (dtype 0). Arguments as decode_attention_launch.
int decode_attention_loads_launch(const void* q, const void* k,
                                  const void* v, const void* kv_len,
                                  void* out, void* part_acc, void* part_m,
                                  void* part_l, int B, int H, int Kh, int S,
                                  int D, int splits, int chunk,
                                  long long k_sb, long long k_sh,
                                  long long k_ss, long long v_sb,
                                  long long v_sh, long long v_ss, float scale,
                                  int dtype, int device, void* stream) {
  return checked_launch(q, k, v, kv_len, out, part_acc, part_m, part_l, B,
                        H, Kh, S, D, splits, chunk, k_sb, k_sh, k_ss,
                        v_sb, v_sh, v_ss, scale, dtype, true, device,
                        stream);
}

// Dynamic shared memory of the split kernel of (dtype, D) in bytes (its
// ring, which the end's combine of the warps reuses), 0 if none.
int decode_smem_bytes(int dtype, int D) {
  if (dtype != 0 && dtype != 1) return 0;
  const int n = with_head_dim(D, [&](auto dim) {
    return Split<decltype(dim)::value>::smem(dtype);
  });
  return n == (int)cudaErrorInvalidValue ? 0 : n;
}

// Keys a ring stage of both split kernels; the wrapper's split plan
// cuts S into chunks of whole stages.
int decode_stage() { return kStage; }

// CTAs of the split kernel that serves (dtype, D, G query heads a KV head)
// that an SM of device `device` holds at once (registers, shared memory
// and threads, as the occupancy calculator counts them), into *out; the
// wrapper's split plan fills one wave of them. Returns a cudaError_t as an
// int (0 = done).
int decode_ctas_per_sm(int dtype, int D, int G, int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((dtype != 0 && dtype != 1) || G < 1 || G > kMaxG) {
    return (int)cudaErrorInvalidValue;
  }
  return with_head_dim(D, [&](auto dim) {
    return Split<decltype(dim)::value>::ctas_per_sm(dtype, arithmetic(G),
                                                    out);
  });
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
