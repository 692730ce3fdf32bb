// The Sporades ordering tick (Algorithms 2 and 3) of every lane in one
// launch, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference's tick
// (src/repro/core/sporades.py::tick) is jnp, which XLA fuses into a few
// loops. The port's plain version (core/sporades.py::_tick_chain) runs it
// as some 350 PyTorch kernels on [B, n, n] operands of a few hundred
// bytes each, so that a captured tick spent its time on graph nodes, not
// on bytes or operations. This kernel does the same work in one launch:
// the deliveries of ring slot t % D, the seven phases, and the tick's
// eight sends, which it writes into scratch buffers that the ring's
// commit (csrc/channel_ring.cu, launched right after) reads where they
// lie. Nothing else is launched between the two.
//
// What it computes, for a tick t (read from device memory, >= 0), is
// _tick_chain's result bit for bit:
//   * every Sporades state leaf, updated in place (the latest-state
//     matrices folded with the slot's arrivals by max, the scalars and the
//     vector clocks of each replica);
//   * per send e (vote, prop, to, pa, va, pa, ac, vote): sender i's payload
//     row pay[b, i, pay_off[e] ..] (the same to every receiver) and its
//     mask[e, b, i, j];
//   * the tick's link delays [B, n, n] int32 and cut links [B, n, n] (the
//     scenario's tables at tick t's window), and per replica cut[b, i],
//     the sends it lost to cut links (the flight recorder's and the
//     monitor's input).
// Integer // and % are floor division and Python's remainder (CUDA's
// truncate; floordiv / pymod below), float-to-int casts truncate, and
// argmax takes the first maximum, as in the plain version. Every float of
// the state is an integer below 2^24, -1 or +inf: no NaN, no -0.0, so a
// max is the same value in any order.
//
// Design. Every phase of the tick is local to one replica's row: receiver
// i reads column i of the slot and row i of the latest-state matrices,
// and as sender i it writes row i of the sends. So one warp owns one
// (lane, replica) and no thread reads what another warp writes in the
// tick; there are no atomics and no block-wide barriers. Inside the warp,
// thread x plays sender j = x where a phase runs over senders (their
// flags and keys; counts by ballot, maxima by warp reductions, a gather
// by a shuffle) and field k = x where it runs over a vector clock (each
// thread keeps its component in a register). The warp first folds the
// slot's arrivals into its five rows (coalesced over (sender, field)),
// keeps them in shared memory, and then runs the phases with every
// scalar computed alike in every thread; thread 0 stores the scalars.
//
// Bound on this card: latency. A launch at the benchmark's shape (B = 64,
// n = 5, K = 50) reads the slot (64 x 1 250 floats), the state (about
// 90 kB) and the scenario's rows, and writes the state and the sends:
// under 1 MB, a third of a microsecond at 3.35 TB/s. Each warp's chain of
// dependent loads, shuffles and reductions sets the time (PERF.md).
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 32;             // a warp's threads: senders, fields
constexpr int kRS = 1 << 14;          // core/sporades.py RS
constexpr int kSends = 8;
constexpr unsigned kAll = 0xffffffffu;

// channels of the packed ring (core/sporades.py ring_spec), in order
enum { kProp = 0, kVote, kTo, kPa, kVa, kAc, kChannels };

struct Params {
  // the Sporades state, [B, n] / [B, n, n] / [B, n, n, P], in place
  int32_t* v_cur;
  int32_t* r_cur;
  uint8_t* is_async;
  int32_t* bh_key;
  int32_t* bh_vc;
  int32_t* commit_key;
  int32_t* cvc;
  int32_t* prop_key;
  int32_t* last_vote_trig;
  float* deadline;
  int32_t* timeout_sent_v;
  int32_t* async_phase;
  int32_t* my_r;
  int32_t* my_avc;
  int32_t* exited_view;
  float* ac_tick;
  int32_t* ac_v_seen;
  float* vote_st;               // [B, n, n, 2 + n]
  float* to_st;                 // [B, n, n, 2 + n]
  float* pa_st;                 // [B, n, n, 1 + n]
  float* va_st;                 // [B, n, n, n]
  float* ac_st;                 // [B, n, n, 2 + n]
  const int64_t* coins;         // [B, V]
  const float* ring;            // [B, D, n, n, K], read at slot t % D
  const int32_t* lcr;           // [B, n, n] Mandator's lastCompletedRounds,
                                // at element strides lcr_s
  const int32_t* t;             // the tick, in device memory
  // the scenario (netsim): static delays and the windowed tables
  const float* delays;          // [B, n, n]
  const int32_t* win_of_tick;   // [B, T]
  const uint8_t* alive_tab;     // [B, W, n]
  const uint8_t* drop_tab;      // [B, W, n, n]
  const float* delay_tab;       // [B, W, n, n]
  // outputs
  float* pay;                   // [B, n, P]: every send's payload row
  int32_t* delay_out;           // [B, n, n]
  uint8_t* mask_out;            // [kSends, B, n, n]
  uint8_t* drop_out;            // [B, n, n]
  int32_t* cut_out;             // [B, n]
  int ch_off[kChannels];        // each channel's first payload field
  int ch_flag[kChannels];       // and its flag field, in the ring's K
  int pay_off[kSends];          // each send's first field in pay's P
  int lcr_s[3];
  int B, n, D, K, T, W, V, P;
  float to_ticks;               // view timeout in ticks, float32
};

// The Python side mirrors this layout (kernels/sporades_tick/kernel.py)
// and checks it against sporades_tick_params_size() when it binds.
static_assert(sizeof(Params) == 416, "Params layout");

__device__ __forceinline__ int floordiv(int a, int b) {   // b > 0
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int pymod(int a, int b) {      // b > 0
  const int r = a % b;
  return r < 0 ? r + b : r;
}

__device__ __forceinline__ int key(int v, int r) { return v * kRS + r; }

__device__ __forceinline__ int warp_max(int v) {
  return __reduce_max_sync(kAll, v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kAll, v, o));
  return v;
}

// Fold the slot's arrivals of one channel into receiver i's row of its
// latest-state matrix (core/channel.py fold_state): row [n, P] of the
// state, where sender j's flag is set, := max(row, arrival). The row is
// stored back and kept in shared memory.
__device__ __forceinline__ void fold(float* row, float* keep,
                                     const float* slot, int n, int i, int K,
                                     int off, int flag, int P) {
  for (int e = threadIdx.x; e < n * P; e += 32) {
    const int j = e / P;
    const float* cell = slot + (j * n + i) * K;
    float v = row[e];
    if (cell[flag] > 0.5f) v = fmaxf(v, cell[off + e - j * P]);
    row[e] = v;
    keep[e] = v;
  }
}

__global__ void __launch_bounds__(32)
sporades_tick_kernel(const __grid_constant__ Params p) {
  extern __shared__ float sm[];
  const int n = p.n, K = p.K;
  const int b = blockIdx.x / n, i = blockIdx.x - (blockIdx.x / n) * n;
  const int x = threadIdx.x;
  const bool on = x < n;                   // thread x is sender / field x
  const int nn = n * n;
  const int q = n - (n - 1) / 2;           // n - f
  const int Pv = 2 + n, Pp = 1 + n;        // vote/to/ac and pa widths
  const int t = *p.t;
  const float tf = (float)t;
  const long long r = (long long)b * n + i;          // [B, n] index
  const long long rx = r * n + x;                    // [B, n, n] at (i, x)

  // ---- the scenario at tick t (netsim.alive, link_delay, link_drop) ------
  const long long w =
      (long long)b * p.W + p.win_of_tick[(long long)b * p.T + t];
  const bool alive = p.alive_tab[w * n + i] != 0;
  bool drop = false;
  if (on) {
    drop = p.drop_tab[w * nn + i * n + x] != 0;
    p.drop_out[rx] = drop;
    p.delay_out[rx] =
        (int)__fadd_rn(p.delays[rx], p.delay_tab[w * nn + i * n + x]);
  }

  // ---- fold slot t % D into receiver i's rows ------------------------------
  const float* slot = p.ring + ((long long)b * p.D + t % p.D) * nn * K;
  float* s_vote = sm;
  float* s_to = s_vote + n * Pv;
  float* s_pa = s_to + n * Pv;
  float* s_va = s_pa + n * Pp;
  float* s_ac = s_va + nn;
  fold(p.vote_st + r * n * Pv, s_vote, slot, n, i, K, p.ch_off[kVote],
       p.ch_flag[kVote], Pv);
  fold(p.to_st + r * n * Pv, s_to, slot, n, i, K, p.ch_off[kTo],
       p.ch_flag[kTo], Pv);
  fold(p.pa_st + r * n * Pp, s_pa, slot, n, i, K, p.ch_off[kPa],
       p.ch_flag[kPa], Pp);
  fold(p.va_st + r * nn, s_va, slot, n, i, K, p.ch_off[kVa], p.ch_flag[kVa],
       n);
  fold(p.ac_st + r * n * Pv, s_ac, slot, n, i, K, p.ch_off[kAc],
       p.ch_flag[kAc], Pv);
  __syncwarp();
  // sender x's cell of the slot for receiver i
  const float* cell = slot + (x * n + i) * K;

  // ---- replica i's state; thread x holds component x of its clocks -------
  int v_cur = p.v_cur[r], r_cur = p.r_cur[r];
  bool is_async = p.is_async[r] != 0;
  int bh_key = p.bh_key[r], commit_key = p.commit_key[r];
  float deadline = p.deadline[r];
  int async_phase = p.async_phase[r], my_r = p.my_r[r];
  float bh_vc = 0.f, cvc = 0.f, lcr = 0.f, my_avc = 0.f;
  if (on) {
    bh_vc = (float)p.bh_vc[rx];
    cvc = (float)p.cvc[rx];
    lcr = (float)p.lcr[b * p.lcr_s[0] + i * p.lcr_s[1] + x * p.lcr_s[2]];
    my_avc = (float)p.my_avc[rx];
  }
  float* pay = p.pay + r * p.P;
  uint8_t* mask = p.mask_out + rx;         // + e * B * n * n for send e
  const long long mask_step = (long long)p.B * nn;
  bool sent = false;                       // any send on link (i, x)
  // send e: (field 0, field 1 or skipped) then the vector in register
  auto put = [&](int e, bool to_x, float f0, float f1, bool two, float vec) {
    float* o = pay + p.pay_off[e];
    if (x == 0) {
      o[0] = f0;
      if (two) o[1] = f1;
    }
    if (on) {
      o[(two ? 2 : 1) + x] = vec;
      mask[e * mask_step] = to_x;
    }
    sent = sent || (on && to_x);
  };

  // ---- 1) deliver <propose> (Alg2 lines 20-26) ----------------------------
  const int po = p.ch_off[kProp];
  const bool pfl = on && cell[p.ch_flag[kProp]] > 0.5f;
  const unsigned pbits = __ballot_sync(kAll, pfl);
  const int pb_key = (int)warp_max(on ? (pfl ? cell[po] : -1.f) : -INFINITY);
  const int pc_key =
      (int)warp_max(on ? (pfl ? cell[po + 1] : -1.f) : -INFINITY);
  float p_vc = -INFINITY, p_cvc = -INFINITY;
  if (on) {
    for (int j = 0; j < n; ++j) {
      const bool fj = (pbits >> j) & 1u;
      const float* cj = slot + (j * n + i) * K + po;
      p_vc = fmaxf(p_vc, fj ? cj[2 + x] : -1.f);
      p_cvc = fmaxf(p_cvc, fj ? cj[2 + n + x] : -1.f);
    }
  }
  const bool accept =
      pbits != 0 && alive && !is_async && pb_key > key(v_cur, r_cur);
  if (accept) {
    cvc = fmaxf(cvc, p_cvc);
    commit_key = max(commit_key, pc_key);
    v_cur = floordiv(pb_key, kRS);
    r_cur = pymod(pb_key, kRS);
    bh_key = pb_key;
    bh_vc = p_vc;
    deadline = __fadd_rn(tf, p.to_ticks);
  }
  // <vote> to L_v (line 25)
  put(0, accept && x == pymod(v_cur, n), (float)bh_key, (float)bh_key, true,
      bh_vc);

  // ---- 2) deliver <vote>; leader trigger (Alg2 lines 9-19) ----------------
  const int voted = on ? (int)s_vote[x * Pv] : INT_MIN;
  const int kmax = warp_max(voted);
  const bool match = on && voted == kmax;
  const unsigned mbits = __ballot_sync(kAll, match);
  const int last_vote_trig0 = p.last_vote_trig[r];
  const bool lead_trig = alive && !is_async && __popc(mbits) >= q &&
                         kmax >= key(v_cur, r_cur) && kmax > last_vote_trig0 &&
                         pymod(floordiv(kmax, kRS), n) == i;
  const int vbh = on ? (int)s_vote[x * Pv + 1] : INT_MIN;
  const int bh_new = warp_max(on ? (match ? vbh : -1) : INT_MIN);
  float bh_vc_new = -INFINITY;
  if (on) {
    for (int j = 0; j < n; ++j) {
      bh_vc_new = fmaxf(bh_vc_new,
                        (mbits >> j) & 1u ? s_vote[j * Pv + 2 + x] : -1.f);
    }
  }
  // commit check (line 11): n-f votes whose block_high rank == voted rank
  const int cnt_bh = __popc(__ballot_sync(kAll, match && vbh == kmax));
  if (lead_trig && cnt_bh >= q) {
    commit_key = max(commit_key, kmax);
    cvc = fmaxf(cvc, bh_vc_new);
  }
  if (lead_trig) {
    v_cur = floordiv(kmax, kRS);
    r_cur = pymod(kmax, kRS);
    bh_key = max(bh_key, bh_new);
    bh_vc = fmaxf(bh_vc, bh_vc_new);
  }
  // form + broadcast the new block (lines 15-18)
  const int new_key = key(v_cur, r_cur + 1);
  {
    float* o = pay + p.pay_off[1];
    if (x == 0) {
      o[0] = (float)new_key;
      o[1] = (float)commit_key;
    }
    if (on) {
      o[2 + x] = fmaxf(lcr, bh_vc);
      o[2 + n + x] = cvc;
      mask[mask_step] = lead_trig;
    }
    sent = sent || (on && lead_trig);
  }
  const int prop_key = lead_trig ? new_key : p.prop_key[r];
  const int last_vote_trig = lead_trig ? kmax : last_vote_trig0;

  // ---- 3) timeout (Alg2 lines 27-28) --------------------------------------
  const int timeout_sent_v0 = p.timeout_sent_v[r];
  const bool fire =
      alive && !is_async && tf >= deadline && timeout_sent_v0 < v_cur;
  put(2, fire, (float)v_cur, (float)bh_key, true, bh_vc);
  const int timeout_sent_v = fire ? v_cur : timeout_sent_v0;

  // ---- 4) deliver <timeout>; async entry (Alg3 lines 1-7) -----------------
  const int to_v = on ? (int)s_to[x * Pv] : INT_MIN;
  const int tvmax = warp_max(to_v);
  const bool tmatch = on && to_v == tvmax;
  const unsigned tbits = __ballot_sync(kAll, tmatch);
  const bool enter =
      alive && !is_async && __popc(tbits) >= q && tvmax >= v_cur;
  const int tbh =
      warp_max(on ? (tmatch ? (int)s_to[x * Pv + 1] : -1) : INT_MIN);
  float tbh_vc = -INFINITY;
  if (on) {
    for (int j = 0; j < n; ++j) {
      tbh_vc = fmaxf(tbh_vc, (tbits >> j) & 1u ? s_to[j * Pv + 2 + x] : -1.f);
    }
  }
  if (enter) {
    bh_key = max(bh_key, tbh);
    bh_vc = fmaxf(bh_vc, tbh_vc);
    v_cur = tvmax;
    r_cur = max(r_cur, pymod(bh_key, kRS));
  }
  is_async = is_async || enter;
  // height-1 async block (lines 5-7)
  const int r1 = r_cur + 1;
  const float avc = fmaxf(lcr, bh_vc);
  put(3, enter, (float)((v_cur * 2 + 1) * kRS + r1), 0.f, false, avc);
  if (enter) {
    async_phase = 1;
    my_r = r1;
    my_avc = avc;
    deadline = INFINITY;
  }

  // ---- 5) deliver <propose-async>; vote (Alg3 lines 8-14) -----------------
  // sender x's latest height-h block of view pa_v, round pa_r
  const bool pa_arr = on && cell[p.ch_flag[kPa]] > 0.5f;
  const int pa_k = on ? (int)s_pa[x * Pp] : -1;
  const int pa_vh = floordiv(pa_k, kRS);
  const int pa_h = pymod(pa_vh, 2) == 1 ? 1 : 2;
  const int pa_v = floordiv(pa_vh - pa_h, 2);
  const int pa_r = pymod(pa_k, kRS);
  const bool va_vote = pa_arr && alive && is_async && pa_v == v_cur &&
                       pa_r > r_cur;
  // broadcast vote: field j = key of j's block being voted (else -1)
  {
    const bool any = __ballot_sync(kAll, va_vote) != 0;
    float* o = pay + p.pay_off[4];
    if (on) {
      o[x] = va_vote ? (float)pa_k : -1.f;
      mask[4 * mask_step] = any;
    }
    sent = sent || (on && any);
  }

  // ---- 6) deliver <vote-async>; heights (Alg3 lines 15-23) ----------------
  // votes receiver i holds for its own blocks (field i of each voter's)
  const int va_own = on ? (int)s_va[x * n + i] : INT_MIN;
  const int h1_key = (v_cur * 2 + 1) * kRS + my_r;
  const int h2_key = (v_cur * 2 + 2) * kRS + my_r;
  const int cnt_h1 = __popc(__ballot_sync(kAll, on && va_own == h1_key));
  const int cnt_h2 = __popc(__ballot_sync(kAll, on && va_own == h2_key));
  const bool to_h2 = alive && is_async && async_phase == 1 && cnt_h1 >= q;
  // Theorem-9 catch-up: proposer x's best-voted key and its votes
  int k_p = INT_MIN, cnt_p = 0;
  if (on) {
    for (int j = 0; j < n; ++j) k_p = max(k_p, (int)s_va[j * n + x]);
    for (int j = 0; j < n; ++j) cnt_p += (int)s_va[j * n + x] == k_p;
  }
  const int kp_vh = floordiv(k_p, kRS);
  const bool adoptable = cnt_p >= q && pymod(kp_vh, 2) == 1 &&
                         floordiv(kp_vh - 1, 2) == v_cur &&
                         pymod(k_p, kRS) >= my_r;
  const int adopt_cand = on ? (adoptable ? k_p : -1) : INT_MIN;
  const int adopt_key = warp_max(adopt_cand);
  const int adopt_p =   // the first maximum
      __ffs(__ballot_sync(kAll, on && adopt_cand == adopt_key)) - 1;
  const bool adopt = alive && is_async && async_phase == 1 && !to_h2 &&
                     adopt_key >= 0;
  // vc for the adopted parent, if we have its propose-async
  const int pa_p_key = __shfl_sync(kAll, pa_k, adopt_p);
  float adopt_vc = my_avc;
  if (on && pa_p_key == adopt_key) adopt_vc = s_pa[adopt_p * Pp + 1 + x];
  const bool go_h2 = to_h2 || adopt;
  const int r2 = adopt ? pymod(adopt_key, kRS) + 1 : my_r + 1;
  const float avc2 = fmaxf(lcr, adopt ? adopt_vc : my_avc);
  put(5, go_h2, (float)((v_cur * 2 + 2) * kRS + r2), 0.f, false, avc2);
  if (go_h2) {
    my_r = r2;
    my_avc = avc2;
    async_phase = 2;
  }
  const bool to_ac = alive && is_async && async_phase == 2 && cnt_h2 >= q;
  put(6, to_ac, (float)v_cur, (float)my_r, true, my_avc);
  if (to_ac) async_phase = 3;

  // ---- 7) deliver <asynchronous-complete>; exit (Alg3 lines 24-36) --------
  const bool ac_arr = on && cell[p.ch_flag[kAc]] > 0.5f;
  const int ac_v = on ? (int)s_ac[x * Pv] : INT_MIN;
  float ac_tick = INFINITY;
  int ac_v_seen = 0;
  if (on) {
    ac_tick = p.ac_tick[rx];
    ac_v_seen = p.ac_v_seen[rx];
    if (ac_arr && ac_v > ac_v_seen) {
      ac_tick = tf;
      ac_v_seen = ac_v;
    }
    p.ac_tick[rx] = ac_tick;
    p.ac_v_seen[rx] = ac_v_seen;
  }
  const bool acm = on && ac_v == v_cur;              // matching this view
  const unsigned acbits = __ballot_sync(kAll, acm);
  const int exited_view0 = p.exited_view[r];
  const bool exit_ = alive && is_async && __popc(acbits) >= q &&
                     exited_view0 < v_cur;
  const int leader = (int)p.coins[(long long)b * p.V +
                                  min(max(v_cur, 0), p.V - 1)];
  // first n-f rule: leader's ac among the q earliest arrival ticks. thr is
  // the (q-1)-th smallest tick_m over the senders (+inf where no match):
  // the sender whose rank, ties broken by index, is q - 1 holds it
  const float tick_m = acm ? ac_tick : INFINITY;
  int rank = 0;
  for (int l = 0; l < n; ++l) {
    const float o = __shfl_sync(kAll, tick_m, l);
    rank += o < tick_m || (o == tick_m && l < x);
  }
  const float thr = __shfl_sync(
      kAll, tick_m, __ffs(__ballot_sync(kAll, on && rank == q - 1)) - 1);
  const float ldr_tick = __shfl_sync(kAll, tick_m, leader);
  const bool ldr_in = ((acbits >> leader) & 1u) && ldr_tick <= thr;
  const int ac_r = on ? (int)s_ac[x * Pv + 1] : 0;
  const int ldr_r = __shfl_sync(kAll, ac_r, leader);
  const float ldr_vc = on ? s_ac[leader * Pv + 2 + x] : 0.f;
  if (exit_ && ldr_in) {
    commit_key = max(commit_key, key(v_cur, ldr_r));
    cvc = fmaxf(cvc, ldr_vc);
    bh_key = key(v_cur, ldr_r);
    bh_vc = ldr_vc;
  }
  // Bfall catch-up (lines 29-31): leader's height-2 seen via propose-async
  const int ldr_pa_v = __shfl_sync(kAll, pa_v, leader);
  const int ldr_pa_h = __shfl_sync(kAll, pa_h, leader);
  const int ldr_pa_r = __shfl_sync(kAll, pa_r, leader);
  if (exit_ && !ldr_in && ldr_pa_v == v_cur && ldr_pa_h == 2) {
    bh_key = key(v_cur, ldr_pa_r);
    if (on) bh_vc = s_pa[leader * Pp + 1 + x];
  }
  const int exited_view = exit_ ? v_cur : exited_view0;
  if (exit_) {
    r_cur = pymod(bh_key, kRS);
    v_cur = v_cur + 1;
    is_async = false;
    async_phase = 0;
    deadline = __fadd_rn(tf, p.to_ticks);
  }
  // vote to the next view's leader (line 35)
  put(7, exit_ && x == pymod(v_cur, n), (float)key(v_cur, r_cur),
      (float)bh_key, true, bh_vc);

  // ---- the state, in place; the tick's cut links -------------------------
  const int cut = __popc(__ballot_sync(kAll, sent && drop));
  if (on) {
    p.bh_vc[rx] = (int)bh_vc;
    p.cvc[rx] = (int)cvc;
    p.my_avc[rx] = (int)my_avc;
  }
  if (x == 0) {
    p.v_cur[r] = v_cur;
    p.r_cur[r] = r_cur;
    p.is_async[r] = is_async;
    p.bh_key[r] = bh_key;
    p.commit_key[r] = commit_key;
    p.prop_key[r] = prop_key;
    p.last_vote_trig[r] = last_vote_trig;
    p.deadline[r] = deadline;
    p.timeout_sent_v[r] = timeout_sent_v;
    p.async_phase[r] = async_phase;
    p.my_r[r] = my_r;
    p.exited_view[r] = exited_view;
    p.cut_out[r] = cut;
  }
}

}  // namespace

extern "C" {

// Launches the tick *params->t (a device int32 >= 0, read by the kernel)
// of every lane on `stream` (a cudaStream_t) of device `device`, with the
// pointers and sizes of *params (copied into the launch's parameters),
// and returns cudaGetLastError() as an int (0 = launched).
int sporades_tick(const void* params, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Params& p = *(const Params*)params;
  if (p.n < 1 || p.n > kMaxN || p.B < 0 || p.D < 1 || p.T < 1 || p.W < 1 ||
      p.V < 1 || p.t == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const long long blocks = (long long)p.B * p.n;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int n = p.n;
  const size_t smem = sizeof(float) * (size_t)n * (3 * (2 + n) + (1 + n) + n);
  sporades_tick_kernel<<<(unsigned)blocks, 32, smem,
                         (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

int sporades_tick_params_size() { return (int)sizeof(Params); }

int sporades_tick_max_n() { return kMaxN; }

const char* sporades_tick_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
