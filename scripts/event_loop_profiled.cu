// The Monte-Carlo sweep's event loops, for sm_90a.
//
// Replaces the JAX package's jitted device programs in
// src/repro/core/engine/jax_stepper.py (not Pallas kernels):
//
//   round_events_*_kernel     `round_events` (:170), one `lax.while_loop` a
//                             round, and `rounds_scan` (:217), the `lax.scan`
//                             of it over the rounds of a plan;
//   pipeline_events_*_kernel  `pipeline_events` (:241), PPT's pipeline loop
//                             with its depth min-scan.
//
// Each simulates one batch of repair cases event by event: a step finds
// every active transfer's contended rate on the case's current bandwidth
// epoch, advances the case's clock to the next completion or epoch flip,
// debits every transfer and retires the completed ones. The plain version
// of each is `round_events_ref` / `pipeline_events_ref` in
// kernels/event_loop.py (the torch ops the device stepper ran before).
//
// What bounds it on the H100: the serial chain of event steps of the
// slowest case, each a few dependent float64 operations. The bytes (the
// epochs each case reaches, its hop tables) and the arithmetic are small
// beside it, so a step costs latency, and the design cuts the latency of a
// step. A case never leaves the kernel from its first step to its last;
// the reference steps the whole batch in lockstep, the plain torch version
// launched ~82 kernels a step from the host. A finished case stops; in the
// lockstep version it takes dt = 0 and stands still, so the per-case
// results are the same. Two routes, picked by shape by the caller
// (kernels/event_loop.py's `pick_route`); a launch function refuses a warp
// launch of a case that does not fit it:
//
//   warp   (`*_warp_kernel`, a case of at most kWarpLanes transfers or
//          edges on at most kWarpLanes nodes: every phase-6 batch): one
//          warp a case, kCaseWarps cases a block and no barrier between
//          them. Lane j owns transfer (edge) j, and its hop, bytes left,
//          ends and standalone rate stay in registers. The case's
//          parameters are read once and its share table slice is copied
//          to shared memory once. An epoch flip moves the epoch's index
//          without a 64-bit division, and each lane reads the next epoch's
//          bandwidth entry ahead by cp.async, so that a flip finds it in
//          shared memory; an entry is read again only when the lane's hop
//          or the case's epoch changed. A fan-in group (the active hops
//          into one receiver) is a lane mask from six ballots of the
//          receivers' bits, its size and each hop's place in it `__popc`s,
//          all found again only after a hop completes; its largest
//          standalone rate comes from a pair of full-warp
//          `__reduce_max_sync` a group of two or more where such groups
//          are few, else by pointer jumping along the groups' lanes with
//          shuffles. The step's dt is two `__reduce_min_sync` on order
//          keys, the end test a vote. The pipeline's min-scan visits only
//          the depths that hold an edge with live deeper child edges, each
//          level one `__syncwarp` and a read of those edges' rates (masks
//          of the tree's child and parent edges found once a case).
//          scripts/warp_primitives_bench.py times the alternatives on the
//          card: `__match_any_sync` costs more as the groups grow, and a
//          `__reduce_max_sync` over each lane's own group mask runs once
//          a distinct mask.
//   block  (`*_events_kernel`, any larger case, the first design): one block
//          a case, a thread a transfer (edge); group statistics go to
//          node-owner threads that loop over the transfers in order, dt is
//          a block reduction, and barriers order the phases of a step.
//
// Numbers: every float is float64, and every product is __dmul_rn and
// every sum __dadd_rn / __dsub_rn, so that nvcc contracts nothing into an
// FMA: the plain version and the numpy engine round each product and each
// sum on its own (`left - rates * dt`, `1 - degrade * (m - 1)`, the epoch
// end `(e + 1) * interval` less the clock), and a completion test
// `left <= 1e-9 * chunk` decided on another last bit would change the
// step count. Division stays IEEE-rounded (the default for double).
// `tmin` / `tmax` propagate NaN as torch.minimum / maximum do. Only
// minima and maxima are taken in another order than the plain version's,
// and those are exact, so nothing depends on thread scheduling and no
// atomics are used.
// >>> profile
//
// The profiled copy of src/repro_torch/kernels/csrc/event_loop.cu, for
// scripts/event_loop_breakdown.py: each kernel also adds the clock64()
// cycles of each part of a step to a per-case record. Without the lines
// between `>>> profile` and `<<< profile` and the PROF* stamps it is that
// file, line for line (`event_loop_breakdown.without_stamps`, held by
// tests/test_torch_event_loop.py).
// <<< profile
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr double kEps = 1e-9;
constexpr int kOverflow = 1;      // OVERFLOW in kernels/event_loop.py
constexpr int kStalled = 2;       // STALLED
constexpr int kMaxThreads = 256;  // a block of the block route
constexpr int kWarps = kMaxThreads / 32;
constexpr int kWarpLanes = 32;    // transfers (edges) and nodes of a warp case
constexpr int kCaseWarps = 4;     // cases a warp block
constexpr int kSmemLimit = 232448;  // a block's, on sm_90
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRouteWarp = 1, kRouteBlock = 2;

// >>> profile
// Per-case cycles of a step's parts: 0 the epoch number, 1 loads, 2
// fan-in groups, 3 rates, 4 the dt reduction, 5 debit and end test, 6
// min-scan, 7 the loads of steps that flipped the epoch, 8 such steps, 9
// steps, 10 the rest (set-up, between rounds), 11 the kernel's whole
// time, 12 the epoch's index into the stack, 13 depth levels scanned, 14
// the group maxima, 15 their pointer-jumping rounds, 16 their reduced
// groups.
constexpr int kProfSlots = 17;
__device__ unsigned long long* g_profile;   // (B, kProfSlots)
#define PROF_BEGIN                                                     \
  const long long prof_start = clock64();                              \
  long long prof_t = prof_start;                                       \
  unsigned long long prof[kProfSlots] = {};                            \
  long long prof_e = -1;                                               \
  bool prof_flip = false
#define PROF(s)                                                        \
  do {                                                                 \
    const long long prof_now = clock64();                              \
    prof[s] += prof_now - prof_t;                                      \
    if ((s) == 1 && prof_flip) prof[7] += prof_now - prof_t;           \
    prof_t = prof_now;                                                 \
  } while (0)
#define PROF_STEP(e)                                                   \
  do {                                                                 \
    prof_flip = (e) != prof_e;                                         \
    prof_e = (e);                                                      \
    prof[8] += prof_flip;                                              \
    ++prof[9];                                                         \
  } while (0)
#define PROF_COUNT(s) ++prof[s]
#define PROF_GROUPS(f)                                                 \
  do {                                                                 \
    if ((f).by_reduce)                                                 \
      prof[16] += __popc((f).leads);                                   \
    else                                                               \
      prof[15] += (f).rounds;                                          \
  } while (0)
#define PROF_END(b, writer)                                            \
  do {                                                                 \
    PROF(10);                                                          \
    prof[11] = clock64() - prof_start;                                 \
    if (writer)                                                        \
      for (int s = 0; s < kProfSlots; ++s)                             \
        g_profile[(size_t)(b) * kProfSlots + s] = prof[s];             \
  } while (0)
// <<< profile

// One batch's per-case context (the device stepper's epoch stack, ingress
// parameters and fan-in share table).
struct Ctx {
  const double* stack;       // (B, E, N, N) epoch matrices
  const double* interval;    // (B,) epoch length; inf = a static network
  const long long* num_ep;   // (B,) valid epochs in the stack
  const uint8_t* cycle;      // (B,) a trace cycles (else clamps) past its end
  const uint8_t* can_ovf;    // (B,) a live case can outrun the stack
  const double* chunk;       // (B,)
  const double* degrade;     // (B,)
  const double* floor_;      // (B,)
  const double* duplex;      // (B,)
  const double* shares;      // (B, N, M1, M) Dirichlet fan-in splits
  int E, N, M1, M;
};

// A case's epochs, as the epoch index reads them.
struct Epochs {
  double interval;
  long long n;               // valid epochs
  bool cycle;
  int E;                     // epochs in the stack
};

__device__ __forceinline__ double tmin(double a, double b) {
  if (isnan(a) || isnan(b)) return __dadd_rn(a, b);
  return b < a ? b : a;
}

__device__ __forceinline__ double tmax(double a, double b) {
  if (isnan(a) || isnan(b)) return __dadd_rn(a, b);
  return b > a ? b : a;
}

// torch's clamp(min=0.0): NaN stays NaN
__device__ __forceinline__ double clamp0(double a) { return a < 0.0 ? 0.0 : a; }

// Epoch e's index into the stack: cycled or clamped past the valid ones.
__device__ __forceinline__ int epoch_index(const Epochs& p, long long e) {
  long long i = p.cycle ? ((e % p.n) + p.n) % p.n : (e < p.n - 1 ? e : p.n - 1);
  return (int)(i < 0 ? 0 : (i > p.E - 1 ? p.E - 1 : i));
}

// The epoch number at clock t and the epoch's end (`_epoch_state` in
// kernels/event_loop.py).
__device__ __forceinline__ long long epoch_at(const Epochs& p, double t,
                                              double* end) {
  const double e_f = floor(t / p.interval);
  *end = __dmul_rn(__dadd_rn(e_f, 1.0), p.interval);
  return (long long)e_f;
}

__device__ __forceinline__ Epochs case_epochs(const Ctx& c, int b) {
  return Epochs{c.interval[b], c.num_ep[b], c.cycle[b] != 0, c.E};
}

// The block route's: the case's epoch at its clock t, its index into the
// stack, its end and its number, the parameters read anew each call.
__device__ __forceinline__ void epoch_state(const Ctx& c, int b, double t,
                                            int* idx, double* end,
                                            long long* e) {
  const Epochs p = case_epochs(c, b);
  *e = epoch_at(p, t, end);
  *idx = epoch_index(p, *e);
}

// The fan-in factor of an m-way group at a receiver.
__device__ __forceinline__ double fanin_factor(double floor_, double degrade,
                                               int m) {
  return tmax(floor_, __dsub_rn(1.0, __dmul_rn(degrade, (double)(m - 1))));
}

// The minimum of the warp's `v`, on every lane.
__device__ __forceinline__ double warp_min(double v) {
  for (int o = 16; o > 0; o >>= 1)
    v = tmin(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// The minimum of every thread's `v`, on every thread. Ends in a barrier;
// `red` is reused only after the caller's next barrier.
__device__ __forceinline__ double block_min(double v, double* red) {
  v = warp_min(v);
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < warps; ++w) v = tmin(v, red[w]);
  return v;
}

// A float64's key in an unsigned order that is the numeric one (-0.0 just
// below +0.0), every NaN above +inf; `from_order_key` inverts it (to a NaN
// for every key above +inf's).
__device__ __forceinline__ unsigned long long order_key(double x) {
  if (isnan(x)) return ~0ull;
  const unsigned long long u = (unsigned long long)__double_as_longlong(x);
  return (u >> 63) ? ~u : (u | (1ull << 63));
}

__device__ __forceinline__ double from_order_key(unsigned long long k) {
  return __longlong_as_double(
      (long long)((k >> 63) ? (k & ~(1ull << 63)) : ~k));
}

// The lanes whose `key` in [0, 32) equals this lane's, or this lane alone
// for a key < 0: what __match_any_sync gives, from one ballot of the keys
// present and five of their bits, whatever the number of groups.
__device__ __forceinline__ unsigned match_lanes(int key, int lane) {
  const bool has = key >= 0;
  unsigned same = __ballot_sync(kFull, has);
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const bool bit = has && (key >> k & 1);
    const unsigned plane = __ballot_sync(kFull, bit);
    same &= bit ? plane : ~plane;
  }
  return has ? same : 1u << lane;
}

// A step's fan-in groups, found again only when they change: this lane's
// group, the lowest lane of each group of two or more (`leads`), and how
// `group_max` takes their maxima: by a pair of full-warp reductions a
// group where the groups are few, else by pointer jumping, whose rounds
// are the bits of the largest group's size
// (scripts/warp_primitives_bench.py: ~70 cycles a group against ~95 a
// round).
struct FanIn {
  unsigned group = 0, leads = 0;
  int rounds = 0;
  bool by_reduce = true;
};

__device__ __forceinline__ FanIn fan_in(int key, int lane) {
  FanIn f;
  f.group = match_lanes(key, lane);
  const int m = __popc(f.group);
  f.leads = __ballot_sync(kFull, m > 1 && !(f.group & ((1u << lane) - 1)));
  const unsigned largest = __reduce_max_sync(kFull, (unsigned)m);
  f.rounds = 32 - __clz((int)largest - 1);
  f.by_reduce = __popc(f.leads) <= f.rounds;
  return f;
}

// The largest `x` over the lanes of this lane's group, as tmax folds it up
// to NaN's payload, on order keys. By reductions: a group's members post
// their high words, then the low words of those that hold the top one.
// By pointer jumping: each lane folds in the key of the member its
// pointer names and takes over that member's pointer, so that after r
// rounds it holds the maximum of the next 2^r members from itself up; the
// group's lowest lane then holds the group's, and every member reads it
// there.
__device__ __forceinline__ double group_max(const FanIn& f, double x,
                                            int lane) {
  unsigned long long k = order_key(x);
  if (f.by_reduce) {
    for (unsigned l = f.leads; l; l &= l - 1) {
      const bool in = f.group >> (__ffs(l) - 1) & 1;
      const unsigned hi = (unsigned)(k >> 32);
      const unsigned top = __reduce_max_sync(kFull, in ? hi : 0u);
      const unsigned lo =
          __reduce_max_sync(kFull, in && hi == top ? (unsigned)k : 0u);
      if (in) k = (unsigned long long)top << 32 | lo;
    }
    return from_order_key(k);
  }
  const unsigned above = f.group & ~((2u << lane) - 1);
  int next = above ? __ffs(above) - 1 : lane;    // this lane when done
  while (__any_sync(kFull, next != lane)) {
    const unsigned long long k_next = __shfl_sync(kFull, k, next);
    const int next_next = __shfl_sync(kFull, next, next);
    k = k_next > k ? k_next : k;
    next = next_next == next ? lane : next_next;
  }
  return from_order_key(__shfl_sync(kFull, k, __ffs(f.group) - 1));
}

// An order key for minima: a NaN below every number, so that the least
// key is a NaN wherever tmin's fold gives one (from_order_key(0) is a NaN).
__device__ __forceinline__ unsigned long long min_key(double x) {
  return isnan(x) ? 0ull : order_key(x);
}

// The minimum of the warp's `v`, on every lane, as tmin folds it: two
// full-warp __reduce_min_sync on min keys.
__device__ __forceinline__ double warp_min_keyed(double v) {
  const unsigned long long k = min_key(v);
  const unsigned hi = (unsigned)(k >> 32);
  const unsigned top = __reduce_min_sync(kFull, hi);
  const unsigned lo = __reduce_min_sync(kFull, hi == top ? (unsigned)k : kFull);
  return from_order_key((unsigned long long)top << 32 | lo);
}

// The warp route's view of a case's epoch, kept from step to step: the
// stack indices of epoch e and e + 1. A flip to the next epoch, the common
// case, costs no 64-bit division.
struct EpochCursor {
  long long e = 0, r = 0;    // the epoch, and e mod n for a cycled trace
  int idx = 0, next = 0;
  bool valid = false;
};

__device__ __forceinline__ int clamp_index(const Epochs& p, long long i) {
  return (int)(i < 0 ? 0 : (i > p.E - 1 ? p.E - 1 : i));
}

// e mod n in [0, n), kept out of line so that a flip to the next epoch
// does not compute it on the side.
__device__ __noinline__ long long residue(long long e, long long n) {
  return ((e % n) + n) % n;
}

// Moves the cursor to epoch e: epoch_index(p, e) and epoch_index(p, e + 1).
// On a flip to the next epoch its index is the one already at hand, so
// the step waits on no index arithmetic.
__device__ __forceinline__ void move_to(EpochCursor& c, const Epochs& p,
                                        long long e) {
  if (c.valid && e == c.e) return;
  const bool flip = c.valid && e == c.e + 1;
  if (p.cycle) {
    c.r = flip ? (c.r + 1 == p.n ? 0 : c.r + 1) : residue(e, p.n);
    c.idx = flip ? c.next : clamp_index(p, c.r);
    c.next = clamp_index(p, c.r + 1 == p.n ? 0 : c.r + 1);
  } else {
    c.idx = flip ? c.next : clamp_index(p, e < p.n - 1 ? e : p.n - 1);
    c.next = clamp_index(p, e + 1 < p.n - 1 ? e + 1 : p.n - 1);
  }
  c.e = e;
  c.valid = true;
}

// A lane's read-ahead of the next epoch's bandwidth entry: an
// asynchronous copy (cp.async) into the lane's own shared slot, which no
// register waits on until `ahead_value` takes it, a step or more later.
// (A plain load into a register put its latency back on the step: the
// step's first use of the current entry waited on the same scoreboard.)
__device__ __forceinline__ void read_ahead(double* slot, const double* src) {
#ifdef __CUDA_ARCH__
  asm volatile(
      "cp.async.wait_all;\n\t"
      "cp.async.ca.shared.global [%0], [%1], 8;\n\t"
      "cp.async.commit_group;" ::"r"((unsigned)__cvta_generic_to_shared(slot)),
      "l"(src)
      : "memory");
#else
  *slot = *src;
#endif
}

__device__ __forceinline__ double ahead_value(const double* slot) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;" ::: "memory");
#endif
  return *slot;
}

// A warp case's slice of the share table: copied once into the warp's own
// shared memory when `in_smem`, else read where it is. Ends in __syncwarp.
__device__ __forceinline__ const double* warp_shares(const Ctx& c, int b,
                                                     double* own,
                                                     bool in_smem, int lane) {
  const size_t n = (size_t)c.N * c.M1 * c.M;
  const double* src = c.shares + (size_t)b * n;
  if (!in_smem) return src;
  for (size_t i = lane; i < n; i += 32) own[i] = src[i];
  __syncwarp();
  return own;
}

// The share of the pos-th active hop of an m-way group at receiver v.
__device__ __forceinline__ double share_of(const Ctx& c, const double* sh,
                                           int v, int m, int pos) {
  return sh[((size_t)v * c.M1 + (m < c.M1 - 1 ? m : c.M1 - 1)) * c.M
            + (pos < c.M - 1 ? pos : c.M - 1)];
}

// Shared memory of a round block: 3 doubles a transfer, 1 a node and the
// reduction's, then 2 ints a transfer and 1 a node.
__host__ __device__ inline size_t round_smem(int T, int N) {
  return sizeof(double) * (3 * (size_t)T + N + kWarps)
         + sizeof(int) * (2 * (size_t)T + N);
}

// Shared memory of a pipeline block: 4 doubles an edge, 2 a node and the
// reduction's, then 4 ints an edge and 2 a node.
__host__ __device__ inline size_t pipeline_smem(int Ed, int N) {
  return sizeof(double) * (4 * (size_t)Ed + 2 * (size_t)N + kWarps)
         + sizeof(int) * (4 * (size_t)Ed + 2 * (size_t)N);
}

// Shared memory of one warp case, in doubles: its share table slice when
// kCaseWarps of them fit a block, then `extra` 8-byte slots.
__host__ __device__ inline size_t warp_case_doubles(int N, int M1, int M,
                                                    int extra,
                                                    bool* in_smem) {
  const size_t share = (size_t)N * M1 * M;
  *in_smem = kCaseWarps * (share + extra) * sizeof(double)
             <= (size_t)kSmemLimit;
  return (*in_smem ? share : 0) + extra;
}

// One block a case. For each of the R rounds, every transfer of the round
// walks its hops (u -> v) until all are done; hop tables (B, R, T, H),
// n_hops (B, R, T). Writes out[0, r, b] the clock at the round's end,
// out[1, r, b] the steps and out[2, r, b] the flags; a case whose round
// overflows its epochs or reaches `guard` steps stops there.
__global__ void __launch_bounds__(kMaxThreads)
round_events_kernel(Ctx c, const int* __restrict__ hop_u,
                    const int* __restrict__ hop_v,
                    const int* __restrict__ n_hops, int B, int R, int T,
                    int H, const double* __restrict__ t0, long long guard,
                    double* __restrict__ out) {
  extern __shared__ double smem[];
  PROF_BEGIN;
  const int N = c.N;
  double* left = smem;                 // (T,) bytes left on the current hop
  double* sval = left + T;             // (T,) standalone rate of the hop
  double* rate = sval + T;             // (T,) contended rate
  double* cap = rate + T;              // (N,) group cap at a receiver
  double* red = cap + N;               // (kWarps,)
  int* hop_i = (int*)(red + kWarps);   // (T,) current hop
  int* recv = hop_i + T;               // (T,) receiver of an active hop, -1
  int* m_recv = recv + T;              // (N,) active hops into the node

  const int b = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  const double chunk = c.chunk[b];
  const double eps_chunk = __dmul_rn(kEps, chunk);
  const double degrade = c.degrade[b], floor_ = c.floor_[b];
  const size_t plane = (size_t)N * N;
  double t = t0[b];
  bool failed = false;
  for (int r = 0; r < R; ++r) {
    const size_t row = ((size_t)b * R + r) * T;
    const int* nh = n_hops + row;
    const int* hu = hop_u + row * H;
    const int* hv = hop_v + row * H;
    long long steps = 0;
    int flag = 0;
    if (!failed) {
      bool mine = true;
      for (int j = tid; j < T; j += nth) {
        hop_i[j] = 0;
        left[j] = chunk;
        mine &= nh[j] <= 0;
      }
      bool done = __syncthreads_and(mine);
      while (!done) {
        PROF(10);
        if (steps >= guard) { flag = kStalled; break; }
        ++steps;
        int idx;
        double epoch_end;
        long long e;
        epoch_state(c, b, t, &idx, &epoch_end, &e);
        if (c.can_ovf[b] && e >= c.num_ep[b]) { flag = kOverflow; break; }
        PROF_STEP(e);
        PROF(0);
        const double* bw = c.stack + ((size_t)b * c.E + idx) * plane;
        // each transfer's current hop and its standalone rate
        for (int j = tid; j < T; j += nth) {
          const int hi = hop_i[j];
          if (hi < nh[j]) {
            const int h = hi < H - 1 ? hi : H - 1;
            const int u = hu[(size_t)j * H + h], v = hv[(size_t)j * H + h];
            recv[j] = v;
            sval[j] = bw[(size_t)u * N + v];
          } else {
            recv[j] = -1;
          }
        }
        __syncthreads();
        PROF(1);
        // fan-in groups: size and largest standalone rate at each receiver
        for (int n = tid; n < N; n += nth) {
          int m = 0;
          double mx = -INFINITY;
          for (int j = 0; j < T; ++j)
            if (recv[j] == n) { ++m; mx = tmax(mx, sval[j]); }
          m_recv[n] = m;
          cap[n] = __dmul_rn(mx, fanin_factor(floor_, degrade, m));
        }
        __syncthreads();
        PROF(2);
        // contended rates and each transfer's time to finish its hop
        double cand = INFINITY;
        for (int j = tid; j < T; j += nth) {
          const int v = recv[j];
          double rt = 0.0;
          if (v >= 0) {
            int pos = 0;                  // active hops before j into v
            for (int i = 0; i < j; ++i) pos += recv[i] == v;
            const double w = share_of(c, c.shares + (size_t)b * N * c.M1 * c.M,
                                      v, m_recv[v], pos);
            rt = clamp0(tmin(sval[j], __dmul_rn(w, cap[v])));
            if (rt > 0.0) cand = tmin(cand, left[j] / rt);
          }
          rate[j] = rt;
        }
        PROF(3);
        cand = block_min(cand, red);
        double dt = tmin(__dsub_rn(epoch_end, t), cand);
        if (!(isfinite(dt) && dt > 0.0)) dt = kEps;
        PROF(4);
        // debit, completions
        mine = true;
        for (int j = tid; j < T; j += nth) {
          double l = __dsub_rn(left[j], __dmul_rn(rate[j], dt));
          int hi = hop_i[j];
          if (recv[j] >= 0 && l <= eps_chunk) { ++hi; l = chunk; }
          left[j] = l;
          hop_i[j] = hi;
          mine &= hi >= nh[j];
        }
        t = __dadd_rn(t, dt);
        done = __syncthreads_and(mine);
        PROF(5);
      }
      failed = flag != 0;
    }
    if (tid == 0) {
      const size_t o = (size_t)r * B + b, plane_rb = (size_t)R * B;
      out[o] = t;
      out[plane_rb + o] = (double)steps;
      out[2 * plane_rb + o] = (double)flag;
    }
  }
  PROF_END(b, tid == 0);
}

// One warp a case (kCaseWarps a block), T <= 32 transfers on N <= 32
// nodes; the same rounds, steps and outputs as round_events_kernel.
__global__ void __launch_bounds__(kCaseWarps * 32)
round_events_warp_kernel(Ctx c, const int* __restrict__ hop_u,
                         const int* __restrict__ hop_v,
                         const int* __restrict__ n_hops, int B, int R, int T,
                         int H, const double* __restrict__ t0,
                         long long guard, double* __restrict__ out) {
  extern __shared__ double smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kCaseWarps + warp;
  if (b >= B) return;                  // the whole warp: no barrier follows
  PROF_BEGIN;
  const int N = c.N;
  bool in_smem;
  const size_t own = warp_case_doubles(N, c.M1, c.M, 32, &in_smem);
  double* ahead = smem + warp * own + (own - 32) + lane;   // the read-ahead
  const double* sh = warp_shares(c, b, smem + warp * own, in_smem, lane);
  const Epochs p = case_epochs(c, b);
  const bool can_ovf = c.can_ovf[b] != 0;
  const double chunk = c.chunk[b];
  const double eps_chunk = __dmul_rn(kEps, chunk);
  const double degrade = c.degrade[b], floor_ = c.floor_[b];
  const size_t plane = (size_t)N * N;
  const double* stack = c.stack + (size_t)b * c.E * plane;
  const unsigned below = (1u << lane) - 1;   // lanes before this one
  const bool mine = lane < T;
  double t = t0[b];
  bool failed = false;
  EpochCursor at;
  for (int r = 0; r < R; ++r) {
    const size_t row = ((size_t)b * R + r) * T + lane;
    const int nh = mine ? n_hops[row] : 0;
    const int* hu = hop_u + row * H;
    const int* hv = hop_v + row * H;
    long long steps = 0;
    int flag = 0;
    if (!failed) {
      int hi = 0;
      double left = chunk;
      // the current hop's ends, and the next hop's read ahead
      int u = 0, v = 0, nu = 0, nv = 0;
      if (hi < nh) {
        u = hu[0]; v = hv[0];
        const int h1 = 1 < H - 1 ? 1 : H - 1;
        if (1 < nh) { nu = hu[h1]; nv = hv[h1]; }
      }
      // the standalone rate on the epoch `sval_idx`, and the epoch whose
      // entry is read ahead
      double sval = 0.0;
      int sval_idx = -1, ahead_idx = -1;
      // the fan-in group (the active hops into this lane's receiver), its
      // share and factor, found again only after a hop completes
      bool regroup = true;
      FanIn fan;
      double w = 0.0, factor = 0.0;
      bool done = __all_sync(kFull, hi >= nh);
      while (!done) {
        PROF(10);
        if (steps >= guard) { flag = kStalled; break; }
        ++steps;
        const bool act = hi < nh;
        if (regroup) {
          fan = fan_in(act ? v : -1, lane);
          const int m = __popc(fan.group);
          w = act ? share_of(c, sh, v, m, __popc(fan.group & below)) : 0.0;
          factor = fanin_factor(floor_, degrade, m);
        }
        PROF(2);
        double epoch_end;
        const long long e = epoch_at(p, t, &epoch_end);
        if (can_ovf && e >= p.n) { flag = kOverflow; break; }
        PROF(0);
        move_to(at, p, e);
        PROF_STEP(e);
        PROF(12);
        if (act && sval_idx != at.idx) {
          sval = ahead_idx == at.idx
                     ? ahead_value(ahead)
                     : stack[at.idx * plane + (size_t)u * N + v];
          sval_idx = at.idx;
          if (at.next != at.idx) {
            read_ahead(ahead, stack + at.next * plane + (size_t)u * N + v);
            ahead_idx = at.next;
          }
        }
        PROF(1);
        const double cap = __dmul_rn(group_max(fan, sval, lane), factor);
        PROF(14);
        PROF_GROUPS(fan);
        double rt = 0.0, cand = INFINITY;
        if (act) {
          rt = clamp0(tmin(sval, __dmul_rn(w, cap)));
          if (rt > 0.0) cand = left / rt;
        }
        PROF(3);
        cand = warp_min_keyed(cand);
        double dt = tmin(__dsub_rn(epoch_end, t), cand);
        if (!(isfinite(dt) && dt > 0.0)) dt = kEps;
        PROF(4);
        double l = __dsub_rn(left, __dmul_rn(rt, dt));
        const bool completes = act && l <= eps_chunk;
        if (completes) {
          ++hi;
          l = chunk;
          u = nu;
          v = nv;
          sval_idx = ahead_idx = -1;
          if (hi + 1 < nh) {
            const int h = hi + 1 < H - 1 ? hi + 1 : H - 1;
            nu = hu[h];
            nv = hv[h];
          }
        }
        left = l;
        t = __dadd_rn(t, dt);
        regroup = __any_sync(kFull, completes);
        done = __all_sync(kFull, hi >= nh);
        PROF(5);
      }
      failed = flag != 0;
    }
    if (lane == 0) {
      const size_t o = (size_t)r * B + b, plane_rb = (size_t)R * B;
      out[o] = t;
      out[plane_rb + o] = (double)steps;
      out[2 * plane_rb + o] = (double)flag;
    }
  }
  PROF_END(b, lane == 0);
}

// One block a case: PPT's pipeline over the case's tree edges (child ->
// parent, `depth` the child's depth, `valid` the edges that exist), all
// streaming at once until every edge has moved its chunk. Writes out[0, 0,
// b] the clock at the end, out[1, 0, b] the steps and out[2, 0, b] the
// flags.
__global__ void __launch_bounds__(kMaxThreads)
pipeline_events_kernel(Ctx c, const int* __restrict__ child,
                       const int* __restrict__ parent,
                       const int* __restrict__ depth,
                       const uint8_t* __restrict__ valid, int B, int Ed,
                       const double* __restrict__ t0, long long guard,
                       double* __restrict__ out) {
  extern __shared__ double smem[];
  PROF_BEGIN;
  const int N = c.N;
  double* left = smem;                 // (Ed,) bytes left on the edge
  double* sval = left + Ed;            // (Ed,) standalone rate
  double* raw = sval + Ed;             // (Ed,) the edge's own rate
  double* eff = raw + Ed;              // (Ed,) after the min-scan
  double* cap = eff + Ed;              // (N,) group cap at a parent
  double* supply = cap + N;            // (N,) the subtree's supply
  double* red = supply + N;            // (kWarps,)
  int* ch = (int*)(red + kWarps);      // (Ed,)
  int* pa = ch + Ed;                   // (Ed,)
  int* dp = pa + Ed;                   // (Ed,)
  int* live = dp + Ed;                 // (Ed,)
  int* m_recv = live + Ed;             // (N,) live edges into the node
  int* has_tx = m_recv + N;            // (N,) a live edge out of the node

  const int b = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  const double chunk = c.chunk[b];
  const double eps_chunk = __dmul_rn(kEps, chunk);
  const double degrade = c.degrade[b], floor_ = c.floor_[b];
  const double duplex = c.duplex[b];
  const size_t plane = (size_t)N * N;
  double t = t0[b];
  int dmax = 0;                        // the case's deepest edge
  for (int j = tid; j < Ed; j += nth) {
    const size_t k = (size_t)b * Ed + j;
    ch[j] = child[k];
    pa[j] = parent[k];
    dp[j] = depth[k];
    left[j] = valid[k] ? chunk : 0.0;
    if (valid[k] && dp[j] > dmax) dmax = dp[j];
  }
  dmax = -(int)block_min(-(double)dmax, red);
  long long steps = 0;
  int flag = 0;
  while (true) {
    PROF(10);
    bool any = false;
    for (int j = tid; j < Ed; j += nth) {
      live[j] = left[j] > eps_chunk;
      any |= live[j];
    }
    if (!__syncthreads_or(any)) break;
    if (steps >= guard) { flag = kStalled; break; }
    ++steps;
    int idx;
    double epoch_end;
    long long e;
    epoch_state(c, b, t, &idx, &epoch_end, &e);
    if (c.can_ovf[b] && e >= c.num_ep[b]) { flag = kOverflow; break; }
    PROF_STEP(e);
    PROF(0);
    const double* bw = c.stack + ((size_t)b * c.E + idx) * plane;
    for (int j = tid; j < Ed; j += nth)
      if (live[j]) sval[j] = bw[(size_t)ch[j] * N + pa[j]];
    __syncthreads();
    PROF(1);
    // receive groups at each parent; which nodes also send
    for (int n = tid; n < N; n += nth) {
      int m = 0, tx = 0;
      double mx = -INFINITY;
      for (int j = 0; j < Ed; ++j) {
        if (!live[j]) continue;
        if (pa[j] == n) { ++m; mx = tmax(mx, sval[j]); }
        tx |= ch[j] == n;
      }
      m_recv[n] = m;
      has_tx[n] = tx;
      cap[n] = __dmul_rn(mx, fanin_factor(floor_, degrade, m));
      supply[n] = INFINITY;
    }
    __syncthreads();
    PROF(2);
    // each live edge's own rate: contended receive, duplex on both ends
    for (int j = tid; j < Ed; j += nth) {
      double r = 0.0;
      if (live[j]) {
        const int p = pa[j];
        int pos = 0;
        for (int i = 0; i < j; ++i) pos += live[i] && pa[i] == p;
        const double w = share_of(c, c.shares + (size_t)b * N * c.M1 * c.M,
                                  p, m_recv[p], pos);
        const double s = sval[j];
        const double rx = tmin(s, __dmul_rn(w, cap[p]));
        const double rx_dup = has_tx[p] ? duplex : 1.0;
        const double tx_dup = m_recv[ch[j]] > 0 ? duplex : 1.0;
        r = tmin(clamp0(__dmul_rn(rx, rx_dup)), clamp0(__dmul_rn(s, tx_dup)));
      }
      raw[j] = r;
      eff[j] = r;
    }
    PROF(3);
    // the min-scan, deepest level first: an edge carries no more than
    // its child's subtree supplies
    for (int d = dmax; d > 0; --d) {
      PROF_COUNT(13);
      __syncthreads();
      for (int j = tid; j < Ed; j += nth)
        if (live[j] && dp[j] == d) eff[j] = tmin(raw[j], supply[ch[j]]);
      __syncthreads();
      for (int n = tid; n < N; n += nth) {
        double s = supply[n];
        for (int j = 0; j < Ed; ++j)
          if (live[j] && dp[j] == d && pa[j] == n) s = tmin(s, eff[j]);
        supply[n] = s;
      }
    }
    PROF(6);
    double cand = INFINITY;
    for (int j = tid; j < Ed; j += nth)
      if (live[j] && eff[j] > 0.0) cand = tmin(cand, left[j] / eff[j]);
    cand = block_min(cand, red);
    double dt = tmin(__dsub_rn(epoch_end, t), cand);
    if (!(isfinite(dt) && dt > 0.0)) dt = kEps;
    PROF(4);
    for (int j = tid; j < Ed; j += nth)
      if (live[j]) left[j] = __dsub_rn(left[j], __dmul_rn(eff[j], dt));
    t = __dadd_rn(t, dt);
    PROF(5);
  }
  if (tid == 0) {
    out[b] = t;
    out[(size_t)B + b] = (double)steps;
    out[2 * (size_t)B + b] = (double)flag;
  }
  PROF_END(b, tid == 0);
}

// One warp a case (kCaseWarps a block), Ed <= 32 edges on N <= 32 nodes;
// the same steps and outputs as pipeline_events_kernel. Lane j's edge at
// depth d >= 1 takes eff = min(raw, eff of every live edge i into its
// child with depth[i] > d): the plain version's node supply, found level
// by level, deepest first, only at the levels that hold such an edge, the
// rates passing as min keys through the warp's row of shared memory (the
// least key is the least rate, or a NaN where tmin gives one; a zero's
// sign may differ, which no debit or time to finish sees).
__global__ void __launch_bounds__(kCaseWarps * 32)
pipeline_events_warp_kernel(Ctx c, const int* __restrict__ child,
                            const int* __restrict__ parent,
                            const int* __restrict__ depth,
                            const uint8_t* __restrict__ valid, int B, int Ed,
                            const double* __restrict__ t0, long long guard,
                            double* __restrict__ out) {
  extern __shared__ double smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kCaseWarps + warp;
  if (b >= B) return;                  // the whole warp: no barrier follows
  PROF_BEGIN;
  const int N = c.N;
  bool in_smem;
  const size_t own = warp_case_doubles(N, c.M1, c.M, 64, &in_smem);
  double* ahead = smem + warp * own + (own - 64) + lane;   // the read-ahead
  unsigned long long* effs =           // (32,) a level's rates, as min keys
      (unsigned long long*)(smem + warp * own + (own - 32));
  const double* sh = warp_shares(c, b, smem + warp * own, in_smem, lane);
  const Epochs p = case_epochs(c, b);
  const bool can_ovf = c.can_ovf[b] != 0;
  const double chunk = c.chunk[b];
  const double eps_chunk = __dmul_rn(kEps, chunk);
  const double degrade = c.degrade[b], floor_ = c.floor_[b];
  const double duplex = c.duplex[b];
  const size_t plane = (size_t)N * N;
  const double* stack = c.stack + (size_t)b * c.E * plane;
  const unsigned below = (1u << lane) - 1;
  const bool mine = lane < Ed;
  const size_t k = (size_t)b * Ed + lane;
  const int ch = mine ? child[k] : 0, pa = mine ? parent[k] : 0;
  const int dp = mine ? depth[k] : 0;
  double left = mine && valid[k] ? chunk : 0.0;
  // the tree, once: the edges into this edge's child (`kids`), those of
  // them deeper than this edge (`deep`), and the edges out of its parent
  // (`ups`)
  unsigned kids = 0, deep = 0, ups = 0;
  for (int i = 0; i < Ed; ++i) {
    const int ch_i = __shfl_sync(kFull, ch, i), pa_i = __shfl_sync(kFull, pa, i);
    const int dp_i = __shfl_sync(kFull, dp, i);
    kids |= (unsigned)(pa_i == ch) << i;
    deep |= (unsigned)(pa_i == ch && dp_i > dp) << i;
    ups |= (unsigned)(ch_i == pa) << i;
  }
  double t = t0[b];
  EpochCursor at;
  double sval = 0.0;                 // as the round's
  int sval_idx = -1, ahead_idx = -1;
  // the receive group at this edge's parent, its share, factor and duplex
  // factors, found again only when an edge has finished
  unsigned lives_seen = 0;
  FanIn fan;
  double w = 0.0, factor = 0.0, rx_dup = 1.0, tx_dup = 1.0;
  long long steps = 0;
  int flag = 0;
  while (true) {
    PROF(10);
    const bool live = mine && left > eps_chunk;
    const unsigned lives = __ballot_sync(kFull, live);
    if (!lives) break;
    if (steps >= guard) { flag = kStalled; break; }
    ++steps;
    if (lives != lives_seen) {
      fan = fan_in(live ? pa : -1, lane);
      const int m = __popc(fan.group);
      w = live ? share_of(c, sh, pa, m, __popc(fan.group & below)) : 0.0;
      factor = fanin_factor(floor_, degrade, m);
      rx_dup = (ups & lives) ? duplex : 1.0;
      tx_dup = (kids & lives) ? duplex : 1.0;
      lives_seen = lives;
    }
    PROF(2);
    double epoch_end;
    const long long e = epoch_at(p, t, &epoch_end);
    if (can_ovf && e >= p.n) { flag = kOverflow; break; }
    PROF(0);
    move_to(at, p, e);
    PROF_STEP(e);
    PROF(12);
    if (live && sval_idx != at.idx) {
      sval = ahead_idx == at.idx
                 ? ahead_value(ahead)
                 : stack[at.idx * plane + (size_t)ch * N + pa];
      sval_idx = at.idx;
      if (at.next != at.idx) {
        read_ahead(ahead, stack + at.next * plane + (size_t)ch * N + pa);
        ahead_idx = at.next;
      }
    }
    PROF(1);
    const double cap = __dmul_rn(group_max(fan, sval, lane), factor);
    PROF(14);
    PROF_GROUPS(fan);
    double raw = 0.0;
    if (live) {
      const double rx = tmin(sval, __dmul_rn(w, cap));
      raw = tmin(clamp0(__dmul_rn(rx, rx_dup)),
                 clamp0(__dmul_rn(sval, tx_dup)));
    }
    PROF(3);
    // the min-scan: a live edge at depth >= 1 with live child edges
    // deeper than itself takes the least of its own rate and theirs,
    // deepest such edges first; any other keeps its own (the plain
    // version's min with an infinite node supply)
    double eff = raw;
    unsigned todo = __ballot_sync(kFull, live && dp > 0 && (deep & lives));
    if (todo) {
      // the least of its own rate and its children's, on min keys
      unsigned long long eff_k = min_key(raw);
      effs[lane] = eff_k;
      __syncwarp();
      do {
        const int d = (int)__reduce_max_sync(
            kFull, (todo >> lane & 1) ? (unsigned)dp : 0u);
        const unsigned level =
            __ballot_sync(kFull, (todo >> lane & 1) && dp == d);
        PROF_COUNT(13);
        if (level >> lane & 1) {
          for (unsigned src = deep & lives; src; src &= src - 1) {
            const unsigned long long k = effs[__ffs(src) - 1];
            eff_k = k < eff_k ? k : eff_k;
          }
          effs[lane] = eff_k;
        }
        __syncwarp();
        todo &= ~level;
      } while (todo);
      eff = from_order_key(eff_k);
    }
    PROF(6);
    const double cand = warp_min_keyed(live && eff > 0.0 ? left / eff
                                                         : INFINITY);
    double dt = tmin(__dsub_rn(epoch_end, t), cand);
    if (!(isfinite(dt) && dt > 0.0)) dt = kEps;
    PROF(4);
    if (live) left = __dsub_rn(left, __dmul_rn(eff, dt));
    t = __dadd_rn(t, dt);
    PROF(5);
  }
  if (lane == 0) {
    out[b] = t;
    out[(size_t)B + b] = (double)steps;
    out[2 * (size_t)B + b] = (double)flag;
  }
  PROF_END(b, lane == 0);
}

int threads_for(int items) {
  const int t = (items + 31) / 32 * 32;
  return t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t);
}

int warp_blocks(int B) { return (B + kCaseWarps - 1) / kCaseWarps; }

bool warp_fits(int lanes, int N) {
  return lanes <= kWarpLanes && N <= kWarpLanes;
}

// Whether a launch takes the warp route; -1 for a route it cannot take.
int warp_route(int route, int lanes, int N) {
  if (route == kRouteWarp) return warp_fits(lanes, N) ? 1 : -1;
  return route == kRouteBlock ? 0 : -1;
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

Ctx make_ctx(const void* stack, const void* interval, const void* num_ep,
             const void* cycle, const void* can_ovf, const void* chunk,
             const void* degrade, const void* floor_, const void* duplex,
             const void* shares, int E, int N, int M1, int M) {
  return Ctx{(const double*)stack,   (const double*)interval,
             (const long long*)num_ep, (const uint8_t*)cycle,
             (const uint8_t*)can_ovf, (const double*)chunk,
             (const double*)degrade, (const double*)floor_,
             (const double*)duplex,  (const double*)shares,
             E, N, M1, M};
}

}  // namespace

extern "C" long long round_events_smem(int T, int N) {
  return (long long)round_smem(T, N);
}

extern "C" long long pipeline_events_smem(int Ed, int N) {
  return (long long)pipeline_smem(Ed, N);
}

// `route`: kRouteWarp (refused for a case that does not fit it) or
// kRouteBlock.
extern "C" int round_events_launch(
    const void* stack, const void* interval, const void* num_ep,
    const void* cycle, const void* can_ovf, const void* chunk,
    const void* degrade, const void* floor_, const void* shares, int B,
    int E, int N, int M1, int M, const void* hop_u, const void* hop_v,
    const void* n_hops, int R, int T, int H, const void* t0, long long guard,
    void* out, int route, void* stream) {
  const int warp = warp_route(route, T, N);
  if (B <= 0 || E <= 0 || N <= 0 || M1 <= 0 || M <= 0 || R < 0 || T < 0
      || H <= 0 || guard < 0 || warp < 0)
    return (int)cudaErrorInvalidValue;
  const Ctx c = make_ctx(stack, interval, num_ep, cycle, can_ovf, chunk,
                         degrade, floor_, nullptr, shares, E, N, M1, M);
  if (warp) {
    bool in_smem;
    const size_t smem =
        kCaseWarps * warp_case_doubles(N, M1, M, 32, &in_smem) * sizeof(double);
    const int err = set_smem(round_events_warp_kernel, smem);
    if (err) return err;
    round_events_warp_kernel<<<warp_blocks(B), kCaseWarps * 32, smem, (cudaStream_t)stream>>>(
        c, (const int*)hop_u, (const int*)hop_v, (const int*)n_hops, B, R, T,
        H, (const double*)t0, guard, (double*)out);
    return (int)cudaGetLastError();
  }
  const size_t smem = round_smem(T, N);
  const int err = set_smem(round_events_kernel, smem);
  if (err) return err;
  round_events_kernel<<<B, threads_for(T), smem, (cudaStream_t)stream>>>(
      c, (const int*)hop_u, (const int*)hop_v, (const int*)n_hops, B, R, T,
      H, (const double*)t0, guard, (double*)out);
  return (int)cudaGetLastError();
}

extern "C" int pipeline_events_launch(
    const void* stack, const void* interval, const void* num_ep,
    const void* cycle, const void* can_ovf, const void* chunk,
    const void* degrade, const void* floor_, const void* duplex,
    const void* shares, int B, int E, int N, int M1, int M,
    const void* child, const void* parent, const void* depth,
    const void* valid, int Ed, const void* t0, long long guard, void* out,
    int route, void* stream) {
  const int warp = warp_route(route, Ed, N);
  if (B <= 0 || E <= 0 || N <= 0 || M1 <= 0 || M <= 0 || Ed < 0
      || guard < 0 || warp < 0)
    return (int)cudaErrorInvalidValue;
  const Ctx c = make_ctx(stack, interval, num_ep, cycle, can_ovf, chunk,
                         degrade, floor_, duplex, shares, E, N, M1, M);
  if (warp) {
    bool in_smem;
    const size_t smem = kCaseWarps * warp_case_doubles(N, M1, M, 64, &in_smem)
                        * sizeof(double);
    const int err = set_smem(pipeline_events_warp_kernel, smem);
    if (err) return err;
    pipeline_events_warp_kernel<<<warp_blocks(B), kCaseWarps * 32, smem, (cudaStream_t)stream>>>(
        c, (const int*)child, (const int*)parent, (const int*)depth,
        (const uint8_t*)valid, B, Ed, (const double*)t0, guard, (double*)out);
    return (int)cudaGetLastError();
  }
  const size_t smem = pipeline_smem(Ed, N);
  const int err = set_smem(pipeline_events_kernel, smem);
  if (err) return err;
  pipeline_events_kernel<<<B, threads_for(Ed), smem, (cudaStream_t)stream>>>(
      c, (const int*)child, (const int*)parent, (const int*)depth,
      (const uint8_t*)valid, B, Ed, (const double*)t0, guard, (double*)out);
  return (int)cudaGetLastError();
}
// >>> profile

// Where the profiled kernels write their (B, kProfSlots) cycles.
extern "C" int event_loop_profile_buffer(void* buf) {
  return (int)cudaMemcpyToSymbol(g_profile, &buf, sizeof(buf));
}
// <<< profile
