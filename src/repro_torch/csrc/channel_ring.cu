// Channel-ring commit of one simulator tick fused with its sends, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/channel_ring/kernel.py::_commit_kernel
//   (wrapper ring_commit_tpu, pallas_call at kernel.py:90)
// together with the preparation of its inputs that the plain path runs
// first (core/channel.py::commit_entries and
// kernels/channel_ring/ops.py::pack_entries).
//
// What it computes, against the packed ring buf [B, D, n, n, K] float32
// (B grid lanes, D ring slots, n senders x n receivers, K fields), for a
// tick t and the tick's E <= kMaxEntries sends, each read where it lies:
// payload [B, n, n, w] float32, delay [B, n, n] int32 and mask [B, n, n]
// bool through their element strides (0 on a broadcast dim), with the
// static layout (off, w, flag_off, additive) of its channel; drop [B, n, n]
// bool (or none) is the tick's cut links. The tick t (>= 0) is read from
// device memory, so that a launch captured into a CUDA graph commits the
// tick the graph's counter holds at each replay:
//   1. slot t % D of every lane is reset to the per-field fill vector;
//   2. for each send e, in order, with live = mask & ~drop:
//        slot  = (t + clamp(delay, 1, D - 1)) % D,
//        value = payload where live, else the neutral NEG = -1 (0.0 when
//                additive), merged into fields off .. off + w - 1 of that
//                slot by max (by add when additive),
//        flag  = float(live), merged into field flag_off by max.
// This is what commit_entries + pack_entries + ring_commit_ref compute,
// bit for bit: a masked-out send still merges its neutral value (max(cur,
// -1) raises a cell below -1; cur + 0.0 turns -0.0 into +0.0).
//
// Design. One thread owns one (b, i, j, k) column of the ring across all D
// slots; a column has exactly one owner, so there are no atomics. Walking
// the entries one by one would chain dependent round trips to device
// memory per entry (slot, payload, cell load, cell store: the compiler
// cannot hoist a cell load above an earlier store, since two entries may
// hit one slot). Instead a thread
//   (a) issues every independent load first: drop, fill[k], and for each
//       entry whose span covers field k its delay, mask and payload;
//   (b) computes each entry's slot, value and merge op in registers;
//   (c) loads each distinct target cell once (the first entry of each
//       group of entries with one slot leads it; a target at slot t % D
//       reads fill[k] instead, since the clear comes first);
//   (d) stores fill[k] into slot t % D, then folds each group's entries
//       into its cell in entry order and stores each cell once.
// That leaves two dependent round trips, (a) and (c). Max is order-free,
// an additive channel sends at most once per tick (the wrapper raises
// otherwise) and one field belongs to one channel, so the result equals
// the plain version's clear, scatter-max, scatter-add bitwise. The sends
// arrive in a by-value parameter struct (__grid_constant__), so no launch
// prepares them: at the Fig-6 shape a tick launches 86 kernels fewer.
//
// Bound on this card: bytes. A launch must read the sends' stored
// elements (an expanded payload once), drop and fill, write the cleared
// slot and read and write each cell a send targets: under half a megabyte
// at the main path's shapes (B=16, n=5, K=50, E=8), well under a
// microsecond at 3.35 TB/s; the launch and each thread's chain of
// dependent instructions cost more (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxEntries = 16;
constexpr int kThreads = 256;
constexpr float kNeg = -1.0f;   // core/channel.py NEG

struct Entry {
  const float* pay;             // [B, n, n, w] float32
  const int32_t* delay;         // [B, n, n] int32
  const uint8_t* mask;          // [B, n, n] bool
  int ps[4];                    // element strides of pay (b, i, j, field)
  int ds[3];                    // of delay (b, i, j)
  int ms[3];                    // of mask
  int off, w, flag_off, additive;
};

struct Params {
  Entry e[kMaxEntries];
  const uint8_t* drop;          // [B, n, n] bool, or null
  int drs[3];
  int B, D, n, K, E;
};

// The Python side mirrors this layout (kernels/channel_ring/kernel.py) and
// checks it against channel_ring_params_size() when it binds the library.
static_assert(sizeof(Entry) == 80, "Entry layout");
static_assert(sizeof(Params) == 1320, "Params layout");

// E, the tick's number of sends, is a template parameter: the loops over
// entries and the pairwise slot comparisons unroll to exactly E. Index
// arithmetic is 32-bit (the wrapper checks that every offset fits).
template <int E>
__global__ void __launch_bounds__(kThreads)
commit_kernel(float* __restrict__ buf, const float* __restrict__ fill,
              const __grid_constant__ Params p,
              const int* __restrict__ t_ptr) {
  const int n = p.n, K = p.K, D = p.D;
  const int nn = n * n;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= p.B * nn * K) return;
  const int k = tid % K;
  const int bij = tid / K;                  // (b * n + i) * n + j
  const int b = bij / nn;
  const int ij = bij - b * nn;
  const int i = ij / n, j = ij - (ij / n) * n;
  const int slot_stride = nn * K;           // one slot of one lane
  float* col = buf + ((long long)b * D * nn + ij) * K + k;

  // (a) every independent load first; every thread reads the one t
  const int t_slot = *t_ptr % D;
  const bool dropped =
      p.drop != nullptr &&
      p.drop[b * p.drs[0] + i * p.drs[1] + j * p.drs[2]] != 0;
  const float fill_k = fill[k];
  bool cov[E + 1], pay[E + 1], add[E + 1];
  int dl[E + 1];
  uint8_t live[E + 1];
  float x[E + 1];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const Entry& en = p.e[e];
    const bool in_pay = k >= en.off && k < en.off + en.w;
    cov[e] = in_pay || k == en.flag_off;
    pay[e] = in_pay;
    add[e] = in_pay && en.additive != 0;
    dl[e] = 0;
    live[e] = 0;
    x[e] = 0.f;
    if (cov[e]) {
      dl[e] = en.delay[b * en.ds[0] + i * en.ds[1] + j * en.ds[2]];
      live[e] = en.mask[b * en.ms[0] + i * en.ms[1] + j * en.ms[2]];
      if (in_pay) {
        x[e] = en.pay[b * en.ps[0] + i * en.ps[1] + j * en.ps[2] +
                      (k - en.off) * en.ps[3]];
      }
    }
  }

  // (b) slots and values, as commit_entries computes them: the slot is
  // (t + clamp(delay, 1, D - 1)) % D = t % D + clamp(...), less D if past
  int slot[E + 1];
  float val[E + 1];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const bool on = live[e] != 0 && !dropped;
    int s = t_slot + min(max(dl[e], 1), D - 1);
    slot[e] = s >= D ? s - D : s;
    val[e] = pay[e] ? (on ? x[e] : (add[e] ? 0.f : kNeg)) : (on ? 1.f : 0.f);
  }

  // (c) each distinct target cell loaded once; entry e leads its group if
  // no earlier covering entry targets its slot
  bool lead[E + 1];
  float cell[E + 1];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    bool first = cov[e];
#pragma unroll
    for (int f = 0; f < e; ++f) {
      if (cov[f] && slot[f] == slot[e]) first = false;
    }
    lead[e] = first;
    cell[e] = 0.f;
    if (first) {
      cell[e] = slot[e] == t_slot ? fill_k
                                  : col[(long long)slot[e] * slot_stride];
    }
  }

  // (d) the clear, then each group folded in entry order and stored once
  col[(long long)t_slot * slot_stride] = fill_k;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (lead[e]) {
      float c = cell[e];
#pragma unroll
      for (int f = e; f < E; ++f) {
        if (cov[f] && slot[f] == slot[e]) {
          c = add[f] ? c + val[f] : (val[f] > c ? val[f] : c);
        }
      }
      col[(long long)slot[e] * slot_stride] = c;
    }
  }
}

template <int E>
void launch(float* buf, const float* fill, const Params& p, const int* t,
            unsigned blocks, cudaStream_t stream) {
  commit_kernel<E><<<blocks, kThreads, 0, stream>>>(buf, fill, p, t);
}

}  // namespace

extern "C" {

// Launches the commit of the tick *t (a device int32 >= 0, read by the
// kernel) into buf on `stream` (a cudaStream_t) of device `device` with the
// sends described by *params (copied into the launch's parameters) and
// returns cudaGetLastError() as an int (0 = launched).
int channel_ring_commit(void* buf, const void* fill, const void* params,
                        const int* t, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Params& p = *(const Params*)params;
  if (p.E < 0 || p.E > kMaxEntries || p.D < 1 || t == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const long long total = (long long)p.B * p.n * p.n * p.K;
  if (total == 0) return 0;
  if (total > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  float* b = (float*)buf;
  const float* f = (const float*)fill;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (p.E) {
#define COMMIT_CASE(N) \
  case N:              \
    launch<N>(b, f, p, t, blocks, s); \
    break;
    COMMIT_CASE(0) COMMIT_CASE(1) COMMIT_CASE(2) COMMIT_CASE(3)
    COMMIT_CASE(4) COMMIT_CASE(5) COMMIT_CASE(6) COMMIT_CASE(7)
    COMMIT_CASE(8) COMMIT_CASE(9) COMMIT_CASE(10) COMMIT_CASE(11)
    COMMIT_CASE(12) COMMIT_CASE(13) COMMIT_CASE(14) COMMIT_CASE(15)
    COMMIT_CASE(16)
#undef COMMIT_CASE
  }
  return (int)cudaGetLastError();
}

int channel_ring_params_size() { return (int)sizeof(Params); }

int channel_ring_max_entries() { return kMaxEntries; }

const char* channel_ring_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
