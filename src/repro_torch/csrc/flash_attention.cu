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
// This CUDA-core kernel serves D in {16, 32} (float32 and bfloat16), which
// only the tests use. It does the products one FMA per loaded float, with
// a shuffle pair per score: at the prefill's B=4, S=2048, H=9, D=64,
// causal, the 1.93e10 flops took 1.71 ms, 6x their 0.29 ms at the card's
// 67 TFLOP/s without tensor cores.
//
// float32 at D in {64, 128}: flash_tf32_kernel (namespace tf32 below), on
// the tensor cores in 3xTF32. One TF32 pass keeps 10 mantissa bits and
// would miss the float32 tolerance (1e-5) by two orders. Each operand x
// becomes hi = tf32(x) (rounded to nearest, ties away, as cvt.rna.tf32.f32
// rounds; low 13 bits cleared) and lo = tf32(x - hi), and each 8-wide
// block of a product is a_lo b_hi + a_hi b_lo + a_hi b_hi (the a_lo b_lo
// term, 2^-22 of the product, is dropped), for S = Q K^T and O += P V
// alike. The tensor cores round each product step toward zero after
// aligning its terms to the largest with 2 bits to spare (read through
// this kernel on an H100, tools/tf32_accuracy.py): fed straight into S and
// O, every step cut them short by up to an ulp, and the kernel was 5x the
// CUDA-core kernel's error (5.2e-6 against the float64 result at the
// prefill's shape). So each block's three products go into a zeroed
// temporary, added to S or O in float32 (mma3, tf32x3.cuh): 5.4e-7, below the
// CUDA-core kernel's 9.5e-7, at 4 more FADDs a block and registers
// (kernels/flash_attention/ref.py::attention_tf32x3_order models all of
// this on the CPU). Bound: operations, 3 x 1.93e10 flops at the card's
// 495 TFLOP/s in TF32, 0.117 ms at the prefill's shape. Design, after
// FlashAttention-2 with mma.sync:
//   - one CTA per (64-row query tile, head, batch), four warps of 16 rows;
//     mma.sync m16n8k8 TF32, so a warp's rows stay its own all along;
//   - K and V tiles of 32 keys in a 3-stage ring of shared memory, filled
//     by 16-byte cp.async (rows past Sk as zeros), so the next tiles'
//     loads overlap this tile's products; rows padded to D + 4 floats,
//     which makes K's fragment reads (K[g][t]) and V's (V[2t][g]) free of
//     bank conflicts. (64-key tiles at D = 64 spill more registers beside
//     the temporaries and were slower);
//   - Q is split once into its TF32 halves, held in registers (D a
//     thread; splitting it afresh for every key tile, or keeping its
//     halves in shared memory, was slower at both head dims);
//   - P needs no shuffle and no round trip through shared memory: the
//     product sums over keys, so inside each 8-key block slot t is key 2t
//     and slot t + 4 key 2t + 1, and S's accumulator is then P's A
//     fragment as it lies (V's B fragment is read from the same rows);
//   - causal CTAs skip the key tiles wholly above the diagonal, and the
//     query tiles are launched heaviest first, as flash_tc_kernel does;
//   - the scale, the mask, the online softmax (base 2, ex2.approx) and
//     acc / max(l, 1e-30) are the CUDA-core kernel's.
//
// bfloat16 at D in {64, 128}: flash_tc_kernel (namespace tc below), on the
// tensor cores. Bound: operations, 1.93e10 flops at the prefill's shape,
// 0.0196 ms at the card's 989 TFLOP/s in bf16 (the CUDA-core kernel took
// 1.72 ms there, bf16 and float32 alike, because it widened K and V to
// float32 one element at a time). Design, after FlashAttention-3:
//   - one CTA per (128-row query tile, head, batch), 288 threads: two
//     consumer warpgroups of 64 query rows each and one producer warp;
//   - the producer's one thread copies the Q tile once and K and V tiles
//     of 128 keys into a ring of 3 (D = 64) or 2 (D = 128) stages with TMA
//     (a 4-D tensor map over [B, S, heads, D], boxes of 64 columns, so a
//     box row is 128 bytes, 128-byte swizzled; rows past S come back as
//     zeros), counted on mbarriers; K and V stay bf16;
//   - S = Q K^T is wgmma m64n128k16 with both operands in shared memory;
//     the scale, the mask (only on tiles that cross Sk or the diagonal)
//     and the online softmax run on the fp32 accumulator in registers,
//     in base 2 (ex2.approx), a row's max taken over the four threads
//     that hold it with two shuffles;
//   - P is cast to bf16 in registers: the m64 accumulator layout of S is
//     the A-fragment layout of each k16 slice of P, so O += P V is wgmma
//     m64nDk16 with A from registers and V from shared memory read
//     MN-major (the transpose bit), no shared-memory round trip for P;
//   - causal CTAs skip the key tiles wholly above the diagonal, and the
//     query tiles are launched heaviest first (the tile index is the grid's
//     slowest axis, reversed), so the last wave is not a tail of long
//     tiles;
//   - the output, O / max(l, 1e-30) in bf16, goes through the warpgroup's
//     rows of the Q tile to 16-byte stores; rows >= Sq are never written.
// The row sum l adds the fp32 probabilities; P V uses them rounded to
// bf16 (kernels/flash_attention/ref.py::attention_kernel_order follows
// that order on the CPU).
// Times (chip_smoke.py, H100 SXM at 700 W): 0.0760 ms at the prefill's
// shape (SDPA 0.0644 ms), 0.103 ms at qwen3-14b's D = 128 (bound 0.0434,
// SDPA 0.096). The softmax of one tile waits for its S wgmma and the next
// S waits for the softmax: two warpgroups overlap each other, but no
// warpgroup overlaps its own exponentials with its products.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

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

// ---------------------------------------------------------------------------
// The bfloat16 kernel on the tensor cores (D in {64, 128}).
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kBQ = 128;                 // query rows per CTA
constexpr int kBK = 128;                 // keys per tile
constexpr int kConsumerThreads = 256;    // two warpgroups of 64 rows each
constexpr int kThreads = kConsumerThreads + 32;   // + the producer warp
constexpr int kRowBytes = 128;           // one 64-column bf16 box row
constexpr int kBoxRows = 128;            // rows of a Q, K or V box
constexpr int kBoxBytes = kBoxRows * kRowBytes;   // 16 KB
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int kHalves = D / 64;             // 64-column boxes
  static constexpr int kStages = D == 64 ? 3 : 2;    // K/V ring depth
  static constexpr int kTileBytes = kHalves * kBoxBytes;   // K or V tile
  static constexpr int kQBytes = kHalves * kBoxBytes;
  static constexpr int kSmem = kQBytes + kStages * 2 * kTileBytes + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// One 64-column box of a [B, S, heads, D] bf16 tensor into shared memory,
// 128-byte swizzled; completion is counted on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col),
        "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 = B128.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
         | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
         | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
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

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128]; A and B from shared memory
// through descriptors, both K-major; scale_d = 0 zeroes D first.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64]; A from registers (the
// m16n8k16 A fragment of each warp's 16 rows), B from shared memory
// MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] * B[16 x 128]; A from registers (the
// m16n8k16 A fragment of each warp's 16 rows), B from shared memory
// MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(o, a, db);
}

// Grid (H, B, query tiles), 288 threads: warps 0-7 are two consumer
// warpgroups of 64 query rows each, warp 8 issues the TMA copies. The
// query tile is nq - 1 - blockIdx.z, so the CTAs with the most key tiles
// (causal) are scheduled first. `scale_log2` is log2(e) / sqrt(D): scores
// are kept in base-2 units and exponentiated by ex2.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                __nv_bfloat16* __restrict__ out, int Sq, int Sk, int H,
                int Kh, int causal, float scale_log2) {
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * C::kStages];
  // the swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* base_ptr = smem_raw + (base - raw);
  const uint32_t q_smem = base;
  const uint32_t kv_smem = base + C::kQBytes;      // stage s: K, then V
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_full = smem_u32(&bars[1]);    // + 8 * stage
  const uint32_t bar_empty = smem_u32(&bars[1 + C::kStages]);

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = (int)gridDim.z - 1 - (int)blockIdx.z;
  const int q0 = qt * kBQ;
  const int kvh = h / (H / Kh);
  const int nk = (Sk + kBK - 1) / kBK;
  const int n_tiles = causal ? min(nk, (q0 + kBQ - 1) / kBK + 1) : nk;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    // producer: Q once, then K and V tile by tile into the ring
    if (threadIdx.x == kConsumerThreads) {
      mbar_expect_tx(bar_q, C::kQBytes);
#pragma unroll
      for (int hf = 0; hf < C::kHalves; ++hf) {
        tma_load(q_smem + hf * kBoxBytes, &tm_q, bar_q, 64 * hf, h, q0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % C::kStages;
        if (j >= C::kStages) {
          mbar_wait(bar_empty + 8 * s, ((j / C::kStages) + 1) & 1);
        }
        const uint32_t ks = kv_smem + s * 2 * C::kTileBytes;
        const uint32_t vs = ks + C::kTileBytes;
        mbar_expect_tx(bar_full + 8 * s, 2 * C::kTileBytes);
#pragma unroll
        for (int hf = 0; hf < C::kHalves; ++hf) {
          tma_load(ks + hf * kBoxBytes, &tm_k, bar_full + 8 * s, 64 * hf,
                   kvh, j * kBK, b);
          tma_load(vs + hf * kBoxBytes, &tm_v, bar_full + 8 * s, 64 * hf,
                   kvh, j * kBK, b);
        }
      }
    }
    return;
  }

  // consumers
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int quad = lane % 4;
  // this thread's two query rows (and the tile's first row of this group)
  const int wg_row0 = q0 + wg * 64;
  const int row0 = wg_row0 + warp * 16 + lane / 4;
  const int row1 = row0 + 8;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  mbar_wait(bar_q, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % C::kStages;
    mbar_wait(bar_full + 8 * s, (j / C::kStages) & 1);
    const uint32_t ks = kv_smem + s * 2 * C::kTileBytes;
    const uint32_t vs = ks + C::kTileBytes;

    // S = Q K^T: [64 rows x 128 keys], K-major operands, D / 16 steps
    float sc[kBK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      wgmma_ss_n128(sc, desc(q_smem + off + wg * 64 * kRowBytes, 16, 1024),
                    desc(ks + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(sc);

    // scale, mask (only where a key may lie past Sk or above a row's
    // diagonal), online softmax in base 2
    const int key0 = j * kBK;
    const bool edge = key0 + kBK > Sk || (causal && key0 + kBK - 1 > wg_row0);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      float x = sc[i] * scale_log2;
      if (edge) {
        const int key = key0 + (i / 4) * 8 + 2 * quad + (i & 1);
        const int row = (i & 2) ? row1 : row0;
        if (key >= Sk || (causal && key > row)) x = -INFINITY;
      }
      sc[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float m_use[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      // a row with no visible key yet keeps p = 0 and corr = 0
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      corr[r] = ex2(m[r] - m_use[r]);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      const int r = (i >> 1) & 1;
      sc[i] = ex2(sc[i] - m_use[r]);
      l[r] += sc[i];
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];

    // P to bf16 A fragments, 16 keys each: the accumulator layout of S is
    // the A-fragment layout of each k16 slice of P
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }

    // O += P V: V [128 keys x D] is MN-major (transposed B); 16 keys a step
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wgmma_pv<D>(o, pa[kk], desc(vs + kk * 16 * kRowBytes, kBoxBytes, 1024));
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(o);
    mbar_arrive(bar_empty + 8 * s);
  }

  // epilogue: O / l as bf16 through this warpgroup's rows of the Q tile
  // (swizzled as Q is), then 16-byte stores of the rows below Sq
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wg * 64 + warp * 16 + lane / 4 + 8 * r;
      const int chunk = (c % 8) ^ (row % 8);
      uint8_t* p = base_ptr + (c / 8) * kBoxBytes + row * kRowBytes
                   + chunk * 16 + quad * 4;
      *reinterpret_cast<uint32_t*>(p) =
          pack_bf16(o[c * 4 + 2 * r] * l[r], o[c * 4 + 2 * r + 1] * l[r]);
    }
  }
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
  constexpr int kChunks = D / 8;                   // 16-byte pieces a row
  const int t = threadIdx.x % 128;
#pragma unroll
  for (int i = 0; i < 64 * kChunks / 128; ++i) {
    const int idx = t + 128 * i;
    const int rr = idx / kChunks, c = idx % kChunks;
    const int row = wg * 64 + rr;
    const int grow = q0 + row;
    const int chunk = (c % 8) ^ (row % 8);
    const uint4 val = *reinterpret_cast<const uint4*>(
        base_ptr + (c / 8) * kBoxBytes + row * kRowBytes + chunk * 16);
    if (grow < Sq) {
      *reinterpret_cast<uint4*>(
          out + (((long long)b * Sq + grow) * H + h) * D + c * 8) = val;
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded, so that
// the library needs no link against libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      return nullptr;
    }
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a contiguous [B, S, heads, D] bf16 tensor, read in
// boxes of 64 columns x 1 head x `rows` rows x 1 batch, 128-byte swizzled;
// rows past S read as zeros.
CUresult make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
                  int D, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

constexpr int kEncodeError = 100000;     // + the CUresult of a failed map

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int Kh, int causal, float scale,
           cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap mq, mk, mv;
  CUresult res = make_map(&mq, q, B, Sq, H, D, kBoxRows);
  if (res == CUDA_SUCCESS) res = make_map(&mk, k, B, Sk, Kh, D, kBoxRows);
  if (res == CUDA_SUCCESS) res = make_map(&mv, v, B, Sk, Kh, D, kBoxRows);
  if (res != CUDA_SUCCESS) return kEncodeError + (int)res;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::kSmem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const dim3 grid((unsigned)H, (unsigned)B, (unsigned)((Sq + kBQ - 1) / kBQ));
  flash_tc_kernel<D><<<grid, kThreads, C::kSmem, stream>>>(
      mq, mk, mv, (__nv_bfloat16*)out, Sq, Sk, H, Kh, causal,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// The float32 kernel on the tensor cores, in 3xTF32 (D in {64, 128}).
// ---------------------------------------------------------------------------
namespace tf32 {

constexpr int kBQ = 64;                  // query rows per CTA: 4 warps x 16
constexpr int kThreads = 128;
constexpr int kStages = 3;               // K/V ring depth
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int kBK = 32;                        // keys per tile
  static constexpr int kStride = D + 4;   // floats a shared row: no conflicts
  static constexpr int kTile = kBK * kStride;           // floats, K or V
  static constexpr int kSmem = kStages * 2 * kTile * 4; // bytes
};

// The K and V rows key0 .. key0 + kBK - 1 into one ring stage, 16 bytes a
// copy; rows past Sk come in as zeros.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t ks, uint32_t vs,
                                          const float* kb, const float* vb,
                                          int key0, int Sk,
                                          long long kv_stride) {
  using C = Cfg<D>;
  constexpr int kPieces = D / 4;                    // 16-byte pieces a row
  constexpr int kPer = C::kBK * kPieces / kThreads;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kPieces, c = idx % kPieces;
    const int key = key0 + r;
    const bool in = key < Sk;
    const long long off = (long long)(in ? key : 0) * kv_stride + c * 4;
    const uint32_t so = (uint32_t)((r * C::kStride + c * 4) * 4);
    cp_async16(ks + so, kb + off, in ? 16 : 0);
    cp_async16(vs + so, vb + off, in ? 16 : 0);
  }
}

// Grid (H, B, query tiles), 128 threads: four warps of 16 query rows. The
// query tile is nq - 1 - blockIdx.z, so the CTAs with the most key tiles
// (causal) are scheduled first. `scale_log2` is log2(e) / sqrt(D): scores
// are kept in base-2 units and exponentiated by ex2.
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  int Sq, int Sk, int H, int Kh, int causal,
                  float scale_log2) {
  using C = Cfg<D>;
  constexpr int kBK = C::kBK;
  constexpr int kNB = kBK / 8;           // 8-key blocks of a tile
  constexpr int kDB = D / 8;             // 8-column blocks of the head dim
  extern __shared__ __align__(16) float ring[];

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = ((int)gridDim.z - 1 - (int)blockIdx.z) * kBQ;
  const int kvh = h / (H / Kh);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wrow0 = q0 + warp * 16;
  const int row0 = wrow0 + g, row1 = row0 + 8;

  const long long q_stride = (long long)H * D;
  const long long kv_stride = (long long)Kh * D;
  const float* qb = q + (long long)b * Sq * q_stride + (long long)h * D;
  const float* kb = k + (long long)b * Sk * kv_stride + (long long)kvh * D;
  const float* vb = v + (long long)b * Sk * kv_stride + (long long)kvh * D;
  const int nk = (Sk + kBK - 1) / kBK;
  const int n_tiles = causal ? min(nk, (q0 + kBQ - 1) / kBK + 1) : nk;

  const uint32_t ring0 = smem_u32(ring);
  constexpr uint32_t kStageBytes = 2 * C::kTile * 4;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) {
      load_tile<D>(ring0 + s * kStageBytes, ring0 + s * kStageBytes
                   + C::kTile * 4, kb, vb, s * kBK, Sk, kv_stride);
    }
    cp_commit();
  }

  // this thread's A fragments of Q (rows g and g + 8, columns t and t + 4
  // of every 8-column block), split once into TF32 halves
  uint32_t qh[kDB][4], ql[kDB][4];
#pragma unroll
  for (int c = 0; c < kDB; ++c) {
    const int col[4] = {c * 8 + t, c * 8 + t, c * 8 + t + 4, c * 8 + t + 4};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = e % 2 ? row1 : row0;
      split(row < Sq ? qb[row * q_stride + col[e]] : 0.f, qh[c][e],
            ql[c][e]);
    }
  }
  float o[kDB][4];
#pragma unroll
  for (int c = 0; c < kDB; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) o[c][e] = 0.f;
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    cp_wait<kStages - 2>();              // tile j has landed (this thread)
    __syncthreads();                     // ... all threads; j - 1 is read
    const int jn = j + kStages - 1;
    if (jn < n_tiles) {
      const uint32_t st = ring0 + (jn % kStages) * kStageBytes;
      load_tile<D>(st, st + C::kTile * 4, kb, vb, jn * kBK, Sk, kv_stride);
    }
    cp_commit();
    const float* ks = ring + (j % kStages) * 2 * C::kTile;
    const float* vs = ks + C::kTile;

    // S = Q K^T: [16 rows x kBK keys] a warp. K's B fragment of key block
    // nb, column block c: K[nb*8 + g][c*8 + t] and [.. + 4]
    float s[kNB][4];
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < kDB; ++c) {
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) {
        const float* kr = ks + (nb * 8 + g) * C::kStride + c * 8 + t;
        uint32_t bh0, bl0, bh1, bl1;
        split(kr[0], bh0, bl0);
        split(kr[4], bh1, bl1);
        mma3(s[nb], qh[c], ql[c], bh0, bh1, bl0, bl1);
      }
    }

    // scale, mask (only where a key may lie past Sk or above a row's
    // diagonal), online softmax in base 2. Thread (g, t) holds keys
    // nb*8 + 2t and + 1 of rows g (e = 0, 1) and g + 8 (e = 2, 3)
    const int key0 = j * kBK;
    const bool edge = key0 + kBK > Sk || (causal && key0 + kBK - 1 > wrow0);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nb][e] * scale_log2;
        if (edge) {
          const int key = key0 + nb * 8 + 2 * t + (e & 1);
          const int row = e < 2 ? row0 : row1;
          if (key >= Sk || (causal && key > row)) x = -INFINITY;
        }
        s[nb][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float m_use[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      // a row with no visible key yet keeps p = 0 and corr = 0
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      corr[r] = ex2(m[r] - m_use[r]);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nb][e] = ex2(s[nb][e] - m_use[e >> 1]);
        l[e >> 1] += s[nb][e];
      }
    }
#pragma unroll
    for (int c = 0; c < kDB; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[c][e] *= corr[e >> 1];
    }

    // O += P V. The sum runs over keys, so each 8-key block's key order is
    // free: slot t of the product is key 2t and slot t + 4 key 2t + 1.
    // Then P's A fragment is S's accumulator as it lies (a0 = P[g][2t],
    // a1 = P[g+8][2t], a2 = P[g][2t+1], a3 = P[g+8][2t+1]), and V's B
    // fragment of column block c is V[2t][c*8 + g] and V[2t + 1][c*8 + g]
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
      uint32_t ph[4], pl[4];
      split(s[nb][0], ph[0], pl[0]);
      split(s[nb][2], ph[1], pl[1]);
      split(s[nb][1], ph[2], pl[2]);
      split(s[nb][3], ph[3], pl[3]);
      const float* vr = vs + (nb * 8 + 2 * t) * C::kStride + g;
#pragma unroll
      for (int c = 0; c < kDB; ++c) {
        uint32_t bh0, bl0, bh1, bl1;
        split(vr[c * 8], bh0, bl0);
        split(vr[C::kStride + c * 8], bh1, bl1);
        mma3(o[c], ph, pl, bh0, bh1, bl0, bl1);
      }
    }
  }
  cp_wait<0>();

  // acc / max(l, 1e-30), rows below Sq; a quad holds a row's 8-column
  // blocks as float2 pairs
  float denom[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    denom[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row1 : row0;
    if (row >= Sq) continue;
    float* ob = out + (((long long)b * Sq + row) * H + h) * D + 2 * t;
#pragma unroll
    for (int c = 0; c < kDB; ++c) {
      *reinterpret_cast<float2*>(ob + c * 8) =
          make_float2(o[c][2 * r] / denom[r], o[c][2 * r + 1] / denom[r]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int Kh, int causal, float scale,
           cudaStream_t stream) {
  using C = Cfg<D>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_tf32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::kSmem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const dim3 grid((unsigned)H, (unsigned)B, (unsigned)((Sq + kBQ - 1) / kBQ));
  flash_tf32_kernel<D><<<grid, kThreads, C::kSmem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, Sq, Sk,
      H, Kh, causal, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace tf32

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

// The bfloat16 tensor-core kernel, D in {64, 128}. q, k, v and out are
// contiguous bf16 [B, S, heads, D], 16-byte aligned. block_q, block_k and
// stages are the wrapper's plan (kernel.py::tc_plan) and must be the ones
// this source is built with. Returns 0 when launched, a cudaError_t, or
// 100000 + the CUresult of a tensor map that could not be made.
int flash_attention_tc_launch(const void* q, const void* k, const void* v,
                              void* out, int B, int Sq, int Sk, int H,
                              int Kh, int D, int causal, float scale,
                              int block_q, int block_k, int stages,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  if (Kh <= 0 || H % Kh != 0 || B > 65535 || H > 65535 || Sk < 0 ||
      block_q != tc::kBQ || block_k != tc::kBK) {
    return (int)cudaErrorInvalidValue;
  }
  if (D == 64 && stages == tc::Cfg<64>::kStages) {
    return tc::launch<64>(q, k, v, out, B, Sq, Sk, H, Kh, causal, scale,
                          (cudaStream_t)stream);
  }
  if (D == 128 && stages == tc::Cfg<128>::kStages) {
    return tc::launch<128>(q, k, v, out, B, Sq, Sk, H, Kh, causal, scale,
                           (cudaStream_t)stream);
  }
  return (int)cudaErrorInvalidValue;
}

// The float32 3xTF32 tensor-core kernel, D in {64, 128}. q, k, v and out
// are contiguous float32 [B, S, heads, D], 16-byte aligned; the tiles are
// this source's (tf32::Cfg).
int flash_attention_tf32_launch(const void* q, const void* k, const void* v,
                                void* out, int B, int Sq, int Sk, int H,
                                int Kh, int D, int causal, float scale,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  if (Kh <= 0 || H % Kh != 0 || B > 65535 || H > 65535 || Sk < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (D == 64) {
    return tf32::launch<64>(q, k, v, out, B, Sq, Sk, H, Kh, causal, scale,
                            (cudaStream_t)stream);
  }
  if (D == 128) {
    return tf32::launch<128>(q, k, v, out, B, Sq, Sk, H, Kh, causal, scale,
                             (cudaStream_t)stream);
  }
  return (int)cudaErrorInvalidValue;
}

// The key tile of the float32 tensor-core kernel at head dim D (0 for a D
// it is not built for): the online softmax's rounding follows it.
int flash_attention_tf32_block_k(int D) {
  if (D == 64) return tf32::Cfg<64>::kBK;
  if (D == 128) return tf32::Cfg<128>::kBK;
  return 0;
}

const char* flash_attention_error_string(int err) {
  if (err >= tc::kEncodeError) return "cuTensorMapEncodeTiled failed";
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
