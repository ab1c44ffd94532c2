// XOR-reduce k rows into one, for sm_90a.
//
// Replaces the Pallas TPU kernel `xor_reduce_words`
// (src/repro/kernels/xor_reduce.py, body `_kernel`):
//
//   out[p] = XOR_i row_i[p]        k rows of n bytes -> out, n bytes
//
// The rows are read where they lie: a launch takes up to kMaxRows row
// pointers in a struct passed by value, so a caller folds separate tensors
// without stacking them into one first, and the Pallas contract (k, W)
// words -> (W,) is the same kernel given the k row starts of the tensor.
// More rows than kMaxRows fold in chained launches, which the host plans
// (`chain_plan` in kernels/xor_reduce.py): the output of one launch is row
// 0 of the next, read and written in place, each unit by the one thread
// that owns it, all its loads before its store.
//
// What bounds it on the H100: (k + 1) * n bytes of device memory (each row
// read once, the output written once); one XOR per input byte is
// negligible.
//
// Design: every pointer of a launch is in one alignment class, the largest
// g of 16, 4 and 1 such that all rows and the output start at the same
// address mod g. The bytes [head, head + g * units) that are g-aligned in
// every row go as units of g bytes (`uint4`, a word or a byte), one unit a
// thread: the grid is sized from the row length (unit j = block * kThreads
// + thread, neighbouring threads on neighbouring units, coalesced), so no
// thread makes a second pass and only the last block has threads past the
// end. For k <= 4 the row count is a template parameter: a thread issues
// its k loads before the first XOR. Loads and stores take the streaming
// cache policy (`__ldcs` / `__stcs`): every byte is touched once. The at
// most 2 * (g - 1) bytes outside the units, the unaligned head and the
// ragged tail, go one byte a thread in the last block of the same launch,
// never past n.
// Blocks are small (4 KiB of each row at g = 16), so that the block
// scheduler balances the work over the SMs as they drain. On an H100, at
// two 128 MiB rows, the designs that fix each SM's share up front measured
// slower (scripts/bench_xor_designs.py): one contiguous run a block by
// 6-7 %, a TMA ring of shared-memory stages (one persistent block an SM)
// by 4-6 %, the grid-stride loop this kernel replaced by 5-6 %; 2 or 4
// units a thread (all loads before the first XOR) by 0-0.4 %.
//
// The same file holds the grouped fold that replaces the Pallas kernel
// `xor_reduce_groups_words` (src/repro/kernels/xor_reduce.py, body
// `_group_kernel`), with the gather moved inside:
//
//   out[g, w] = XOR_{i : groups[g, i] >= 0} words[groups[g, i], w]
//
// words (T, W), groups (G, Kmax) int64 row indices padded with -1, out
// (G, W). The Pallas contract (G, K, W) -> (G, W) is this kernel on the
// (G*K, W) view with the identity index table; the batched data plane
// passes its whole (B*S, W) buffer and the round's table, so the dense
// (G, Kmax, W) copy the JAX package gathers first is never made. Bound by
// device memory: 4 * W * (rows referenced + G) bytes.
// With a destination table dst (G,), group g's fold goes to row dst[g] of
// out instead of row g, and out may be the words themselves: the data
// plane folds each round into its buffer in place. So `in` and `out` may
// alias (no __restrict__). A destination row may be a member of its own
// group (a thread reads word j of every member before it writes word j),
// but never of another group: the host guarantees that.
// Design: blockIdx.y walks the groups, blockIdx.x and a grid-stride loop
// the words of a row; every thread of a block reads the same index
// (a broadcast from L1) and XORs the rows it names into registers, 16-byte
// `uint4` loads when the rows allow it, else single words, two units of
// the row a pass (all loads before the stores). The x extent is chosen so
// that about 8 blocks per SM are in flight over all groups. On an H100,
// over the round tables of the benchmark's two cells at 128 MiB rows,
// folding in place one unit a pass ran at 80-82 % of the byte bound, the
// same with __restrict__, and the earlier kernel into a fresh output at
// 85-87 %; two units a pass in place at 85-88 %, four 85-87 %, streaming
// loads and stores (__ldcs / __stcs) added nothing.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;
constexpr int kMaxRows = 16;     // rows a launch folds: KMAX in xor_reduce.py
constexpr int kUnits = 2;        // units of a row a thread of the grouped fold
                                 // takes a pass

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

__device__ __forceinline__ uint4 xor_of(const uint4 a, const uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}

__device__ __forceinline__ uint32_t xor_of(const uint32_t a, const uint32_t b) {
  return a ^ b;
}

// V is uint4 (n = W / 4 vectors per row) or uint32_t (n = W words per row);
// dst (G,) the output row of each group, or null for row g. A thread owns
// the units of a row at its index mod the grid's width and takes kUnits
// of them a pass, issuing every load before its first store.
template <typename V>
__global__ void __launch_bounds__(kThreads)
xor_reduce_groups_gather(const V* in, const long long* __restrict__ groups,
                         const long long* __restrict__ dst, V* out, int G,
                         int K, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (int g = blockIdx.y; g < G; g += gridDim.y) {
    const long long* row = groups + (size_t)g * K;
    V* to = out + (size_t)(dst ? __ldg(dst + g) : g) * n;
    for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         j < n; j += kUnits * stride) {
      V acc[kUnits] = {};
      for (int i = 0; i < K; ++i) {
        const long long r = __ldg(row + i);
        if (r < 0) continue;
        const V* src = in + (size_t)r * n;
#pragma unroll
        for (int u = 0; u < kUnits; ++u)
          if (j + u * stride < n)
            acc[u] = xor_of(acc[u], src[j + u * stride]);
      }
#pragma unroll
      for (int u = 0; u < kUnits; ++u)
        if (j + u * stride < n) to[j + u * stride] = acc[u];
    }
  }
}

template <typename V>
void launch_groups(const V* in, const long long* groups, const long long* dst,
                   V* out, int G, int K, long long n, cudaStream_t stream) {
  const int gy = G < kMaxGridY ? G : kMaxGridY;
  const long long want = (n + kThreads - 1) / kThreads;
  long long gx = (long long)sm_count() * 8 / gy;
  if (gx < 1) gx = 1;
  if (gx > want) gx = want;
  xor_reduce_groups_gather<V><<<dim3((unsigned)gx, (unsigned)gy), kThreads, 0,
                                stream>>>(in, groups, dst, out, G, K, n);
}

__device__ __forceinline__ uint8_t xor_of(const uint8_t a, const uint8_t b) {
  return (uint8_t)(a ^ b);
}

struct RowPtrs {
  const uint8_t* p[kMaxRows];
};

// units of T start `head` bytes into every row; unit j of the output is the
// XOR of unit j of the k rows (K = k when K > 0, else k is read at run time)
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
xor_reduce_words_kernel(const __grid_constant__ RowPtrs rows, int k,
                        uint8_t* out, long long n, long long head,
                        long long units) {
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (j < units) {
    T acc;
    if constexpr (K > 0) {
      T v[K];
#pragma unroll
      for (int i = 0; i < K; ++i)
        v[i] = __ldcs(reinterpret_cast<const T*>(rows.p[i] + head) + j);
      acc = v[0];
#pragma unroll
      for (int i = 1; i < K; ++i) acc = xor_of(acc, v[i]);
    } else {
      acc = __ldcs(reinterpret_cast<const T*>(rows.p[0] + head) + j);
#pragma unroll 4
      for (int i = 1; i < k; ++i)
        acc = xor_of(acc, __ldcs(reinterpret_cast<const T*>(rows.p[i] + head) + j));
    }
    __stcs(reinterpret_cast<T*>(out + head) + j, acc);
  }
  // the head [0, head) and the tail [head + units * sizeof(T), n): fewer
  // than 2 * sizeof(T) bytes, one a thread of the last block
  if (blockIdx.x == gridDim.x - 1) {
    const long long tail_lo = head + units * (long long)sizeof(T);
    const long long t = threadIdx.x;
    const long long p = t < head ? t : tail_lo + (t - head);
    if (p < n) {
      uint8_t acc = rows.p[0][p];
      for (int i = 1; i < k; ++i) acc ^= rows.p[i][p];
      out[p] = acc;
    }
  }
}

template <typename T, int K>
int launch_rows_as(const RowPtrs& rows, int k, uint8_t* out, long long n,
                   long long head, long long units, cudaStream_t stream) {
  long long blocks = (units + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;      // the head and tail bytes alone
  xor_reduce_words_kernel<T, K><<<(unsigned)blocks, kThreads, 0, stream>>>(
      rows, k, out, n, head, units);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rows(const RowPtrs& rows, int k, uint8_t* out, long long n,
                long long head, long long units, cudaStream_t stream) {
  switch (k) {
    case 1: return launch_rows_as<T, 1>(rows, k, out, n, head, units, stream);
    case 2: return launch_rows_as<T, 2>(rows, k, out, n, head, units, stream);
    case 3: return launch_rows_as<T, 3>(rows, k, out, n, head, units, stream);
    case 4: return launch_rows_as<T, 4>(rows, k, out, n, head, units, stream);
    default: return launch_rows_as<T, 0>(rows, k, out, n, head, units, stream);
  }
}

}  // namespace

// rows: a host array of k (1 <= k <= kMaxRows) device pointers, each to n
// readable bytes; out: n writable bytes, which may be rows[0] (a chained
// launch) but overlap no other row.
extern "C" int xor_reduce_rows_launch(const void* const* rows, int k,
                                      void* out, long long n, void* stream) {
  if (k <= 0 || k > kMaxRows || n <= 0) return (int)cudaErrorInvalidValue;
  RowPtrs ptrs = {};
  const uintptr_t o = (uintptr_t)out;
  bool same16 = true, same4 = true;
  for (int i = 0; i < k; ++i) {
    const uintptr_t a = (uintptr_t)rows[i];
    ptrs.p[i] = (const uint8_t*)rows[i];
    same16 = same16 && a % 16 == o % 16;
    same4 = same4 && a % 4 == o % 4;
  }
  const long long g = same16 ? 16 : same4 ? 4 : 1;
  long long head = (g - (long long)(o % g)) % g;
  if (head > n) head = n;
  const long long units = (n - head) / g;
  uint8_t* y = (uint8_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (g == 16) return launch_rows<uint4>(ptrs, k, y, n, head, units, s);
  if (g == 4) return launch_rows<uint32_t>(ptrs, k, y, n, head, units, s);
  return launch_rows<uint8_t>(ptrs, k, y, n, head, units, s);
}

// dst: null (group g to row g of out) or G row indices of out; out may be
// words itself (see xor_reduce_groups_gather)
extern "C" int xor_reduce_groups_launch(const void* words, const void* groups,
                                        const void* dst, void* out, int G,
                                        int K, long long W, void* stream) {
  if (G <= 0 || K < 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const bool vec = (W % 4 == 0) && ((uintptr_t)words % 16 == 0) &&
                   ((uintptr_t)out % 16 == 0);
  const long long* g = (const long long*)groups;
  const long long* d = (const long long*)dst;
  if (vec) {
    launch_groups((const uint4*)words, g, d, (uint4*)out, G, K, W / 4,
                  (cudaStream_t)stream);
  } else {
    launch_groups((const uint32_t*)words, g, d, (uint32_t*)out, G, K, W,
                  (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}
