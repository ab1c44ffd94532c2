// The Monte-Carlo sweep's event loops, for sm_90a.
//
// Replaces the JAX package's jitted device programs in
// src/repro/core/engine/jax_stepper.py (not Pallas kernels):
//
//   round_events_kernel     `round_events` (:170), one `lax.while_loop` a
//                           round, and `rounds_scan` (:217), the `lax.scan`
//                           of it over the rounds of a plan;
//   pipeline_events_kernel  `pipeline_events` (:241), PPT's pipeline loop
//                           with its depth min-scan.
//
// Each simulates one batch of repair cases event by event: a step finds
// every active transfer's contended rate on the case's current bandwidth
// epoch, advances the case's clock to the next completion or epoch flip,
// debits every transfer and retires the completed ones. The plain version
// of each is `round_events_ref` / `pipeline_events_ref` in
// kernels/event_loop.py (the torch ops the device stepper ran before).
//
// What bounds it on the H100: the serial chain of event steps of the
// slowest case, each a few dependent float64 operations and barriers. The
// bytes (the epochs each case reaches, its hop tables) and the arithmetic
// are small beside it. The reference steps the whole batch in lockstep
// and reads its loop condition on the device; the plain torch version
// launched ~82 kernels a step from the host. Here one block runs one case
// from its first step to its last without leaving the kernel: the grid is
// the batch, the threads are the case's transfers (or edges), and the
// case's state (clock, per-transfer hop index and bytes left, per-node
// group statistics) stays in registers and shared memory for the whole
// loop. A finished case stops; in the lockstep version it takes dt = 0 and
// stands still, so the per-case results are the same.
//
// Numbers: every float is float64, and every product is __dmul_rn and
// every sum __dadd_rn / __dsub_rn, so that nvcc contracts nothing into an
// FMA: the plain version and the numpy engine round each product and each
// sum on its own (`left - rates * dt`, `1 - degrade * (m - 1)`, the epoch
// end `(e + 1) * interval` less the clock), and a completion test
// `left <= 1e-9 * chunk` decided on another last bit would change the
// step count. Division stays IEEE-rounded (the default for double).
// `tmin` / `tmax` propagate NaN as torch.minimum / maximum do. Group
// statistics go to node-owner threads that loop over the transfers in
// order, and the step's dt is a block reduction of a minimum, so nothing
// depends on thread scheduling and no atomics are used.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr double kEps = 1e-9;
constexpr int kOverflow = 1;      // OVERFLOW in kernels/event_loop.py
constexpr int kStalled = 2;       // STALLED
constexpr int kMaxThreads = 256;
constexpr int kWarps = kMaxThreads / 32;

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

// The case's epoch at its clock t: index into the stack, the epoch's end
// and the epoch number (`_epoch_state` in kernels/event_loop.py).
__device__ __forceinline__ void epoch_state(const Ctx& c, int b, double t,
                                            int* idx, double* end,
                                            long long* e) {
  const double interval = c.interval[b];
  const double e_f = floor(t / interval);
  const long long n = c.num_ep[b];
  *e = (long long)e_f;
  long long i = c.cycle[b] ? ((*e % n) + n) % n : (*e < n - 1 ? *e : n - 1);
  i = i < 0 ? 0 : (i > c.E - 1 ? c.E - 1 : i);
  *idx = (int)i;
  *end = __dmul_rn(__dadd_rn(e_f, 1.0), interval);
}

// The fan-in factor of an m-way group at a receiver.
__device__ __forceinline__ double fanin_factor(double floor_, double degrade,
                                               int m) {
  return tmax(floor_, __dsub_rn(1.0, __dmul_rn(degrade, (double)(m - 1))));
}

// The minimum of every thread's `v`, on every thread. Ends in a barrier;
// `red` is reused only after the caller's next barrier.
__device__ __forceinline__ double block_min(double v, double* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = tmin(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < warps; ++w) v = tmin(v, red[w]);
  return v;
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
        if (steps >= guard) { flag = kStalled; break; }
        ++steps;
        int idx;
        double epoch_end;
        long long e;
        epoch_state(c, b, t, &idx, &epoch_end, &e);
        if (c.can_ovf[b] && e >= c.num_ep[b]) { flag = kOverflow; break; }
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
        // contended rates and each transfer's time to finish its hop
        double cand = INFINITY;
        for (int j = tid; j < T; j += nth) {
          const int v = recv[j];
          double rt = 0.0;
          if (v >= 0) {
            int pos = 0;                  // active hops before j into v
            for (int i = 0; i < j; ++i) pos += recv[i] == v;
            const int m = m_recv[v];
            const double w = c.shares[(((size_t)b * N + v) * c.M1
                                       + (m < c.M1 - 1 ? m : c.M1 - 1))
                                      * c.M + (pos < c.M - 1 ? pos : c.M - 1)];
            rt = clamp0(tmin(sval[j], __dmul_rn(w, cap[v])));
            if (rt > 0.0) cand = tmin(cand, left[j] / rt);
          }
          rate[j] = rt;
        }
        cand = block_min(cand, red);
        double dt = tmin(__dsub_rn(epoch_end, t), cand);
        if (!(isfinite(dt) && dt > 0.0)) dt = kEps;
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
    const double* bw = c.stack + ((size_t)b * c.E + idx) * plane;
    for (int j = tid; j < Ed; j += nth)
      if (live[j]) sval[j] = bw[(size_t)ch[j] * N + pa[j]];
    __syncthreads();
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
    // each live edge's own rate: contended receive, duplex on both ends
    for (int j = tid; j < Ed; j += nth) {
      double r = 0.0;
      if (live[j]) {
        const int p = pa[j];
        int pos = 0;
        for (int i = 0; i < j; ++i) pos += live[i] && pa[i] == p;
        const int m = m_recv[p];
        const double w = c.shares[(((size_t)b * N + p) * c.M1
                                   + (m < c.M1 - 1 ? m : c.M1 - 1))
                                  * c.M + (pos < c.M - 1 ? pos : c.M - 1)];
        const double s = sval[j];
        const double rx = tmin(s, __dmul_rn(w, cap[p]));
        const double rx_dup = has_tx[p] ? duplex : 1.0;
        const double tx_dup = m_recv[ch[j]] > 0 ? duplex : 1.0;
        r = tmin(clamp0(__dmul_rn(rx, rx_dup)), clamp0(__dmul_rn(s, tx_dup)));
      }
      raw[j] = r;
      eff[j] = r;
    }
    // the min-scan, deepest level first: an edge carries no more than
    // its child's subtree supplies
    for (int d = dmax; d > 0; --d) {
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
    double cand = INFINITY;
    for (int j = tid; j < Ed; j += nth)
      if (live[j] && eff[j] > 0.0) cand = tmin(cand, left[j] / eff[j]);
    cand = block_min(cand, red);
    double dt = tmin(__dsub_rn(epoch_end, t), cand);
    if (!(isfinite(dt) && dt > 0.0)) dt = kEps;
    for (int j = tid; j < Ed; j += nth)
      if (live[j]) left[j] = __dsub_rn(left[j], __dmul_rn(eff[j], dt));
    t = __dadd_rn(t, dt);
  }
  if (tid == 0) {
    out[b] = t;
    out[(size_t)B + b] = (double)steps;
    out[2 * (size_t)B + b] = (double)flag;
  }
}

int threads_for(int items) {
  const int t = (items + 31) / 32 * 32;
  return t < 32 ? 32 : (t > kMaxThreads ? kMaxThreads : t);
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

extern "C" int round_events_launch(
    const void* stack, const void* interval, const void* num_ep,
    const void* cycle, const void* can_ovf, const void* chunk,
    const void* degrade, const void* floor_, const void* shares, int B,
    int E, int N, int M1, int M, const void* hop_u, const void* hop_v,
    const void* n_hops, int R, int T, int H, const void* t0, long long guard,
    void* out, void* stream) {
  if (B <= 0 || E <= 0 || N <= 0 || M1 <= 0 || M <= 0 || R < 0 || T < 0
      || H <= 0 || guard < 0)
    return (int)cudaErrorInvalidValue;
  const Ctx c = make_ctx(stack, interval, num_ep, cycle, can_ovf, chunk,
                         degrade, floor_, nullptr, shares, E, N, M1, M);
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
    void* stream) {
  if (B <= 0 || E <= 0 || N <= 0 || M1 <= 0 || M <= 0 || Ed < 0
      || guard < 0)
    return (int)cudaErrorInvalidValue;
  const Ctx c = make_ctx(stack, interval, num_ep, cycle, can_ovf, chunk,
                         degrade, floor_, duplex, shares, E, N, M1, M);
  const size_t smem = pipeline_smem(Ed, N);
  const int err = set_smem(pipeline_events_kernel, smem);
  if (err) return err;
  pipeline_events_kernel<<<B, threads_for(Ed), smem, (cudaStream_t)stream>>>(
      c, (const int*)child, (const int*)parent, (const int*)depth,
      (const uint8_t*)valid, B, Ed, (const double*)t0, guard, (double*)out);
  return (int)cudaGetLastError();
}
