// XOR-reduce k rows of 32-bit words into one, for sm_90a.
//
// Replaces the Pallas TPU kernel `xor_reduce_words`
// (src/repro/kernels/xor_reduce.py, body `_kernel`):
//
//   out[w] = XOR_i words[i, w]        words (k, W) -> out (W,), contiguous
//
// What bounds it on the H100: one XOR per input word, so (k + 1) * 4 bytes
// of device memory per output word bound it; the operations are negligible.
//
// Design: a grid-stride loop over the output, one 16-byte `uint4` (4 words)
// per thread and step when W is a multiple of 4 and both pointers are
// 16-byte aligned (neighbouring threads on neighbouring 16 bytes: the
// widest coalesced load), else one word per thread. Each thread loops over
// the k rows and keeps the running XOR in registers; the grid is sized to a
// few waves of blocks on the card's SMs, not to W.
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
// Design: blockIdx.y walks the groups, blockIdx.x and a grid-stride loop
// the words of a row; every thread of a block reads the same index
// (a broadcast from L1) and XORs the rows it names into registers, 16-byte
// `uint4` loads when the rows allow it, else single words. The x extent is
// chosen so that about 8 blocks per SM are in flight over all groups.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

__global__ void __launch_bounds__(kThreads)
xor_reduce_words_vec4(const uint4* __restrict__ in, uint4* __restrict__ out,
                      int k, long long n4) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n4;
       j += stride) {
    uint4 acc = in[j];
    for (int i = 1; i < k; ++i) {
      const uint4 v = in[(size_t)i * n4 + j];
      acc.x ^= v.x;
      acc.y ^= v.y;
      acc.z ^= v.z;
      acc.w ^= v.w;
    }
    out[j] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
xor_reduce_words_scalar(const uint32_t* __restrict__ in,
                        uint32_t* __restrict__ out, int k, long long W) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < W;
       j += stride) {
    uint32_t acc = in[j];
    for (int i = 1; i < k; ++i) acc ^= in[(size_t)i * W + j];
    out[j] = acc;
  }
}

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

int grid_for(long long n) {
  const long long want = (n + kThreads - 1) / kThreads;
  const long long cap = (long long)sm_count() * 8;   // 8 blocks of 256 per SM
  return (int)(want < cap ? want : cap);
}

__device__ __forceinline__ uint4 xor_of(const uint4 a, const uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}

__device__ __forceinline__ uint32_t xor_of(const uint32_t a, const uint32_t b) {
  return a ^ b;
}

// V is uint4 (n = W / 4 vectors per row) or uint32_t (n = W words per row)
template <typename V>
__global__ void __launch_bounds__(kThreads)
xor_reduce_groups_gather(const V* __restrict__ in,
                         const long long* __restrict__ groups,
                         V* __restrict__ out, int G, int K, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (int g = blockIdx.y; g < G; g += gridDim.y) {
    const long long* row = groups + (size_t)g * K;
    for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         j < n; j += stride) {
      V acc = {};
      for (int i = 0; i < K; ++i) {
        const long long r = __ldg(row + i);
        if (r >= 0) acc = xor_of(acc, in[(size_t)r * n + j]);
      }
      out[(size_t)g * n + j] = acc;
    }
  }
}

template <typename V>
void launch_groups(const V* in, const long long* groups, V* out, int G, int K,
                   long long n, cudaStream_t stream) {
  const int gy = G < kMaxGridY ? G : kMaxGridY;
  const long long want = (n + kThreads - 1) / kThreads;
  long long gx = (long long)sm_count() * 8 / gy;
  if (gx < 1) gx = 1;
  if (gx > want) gx = want;
  xor_reduce_groups_gather<V><<<dim3((unsigned)gx, (unsigned)gy), kThreads, 0,
                                stream>>>(in, groups, out, G, K, n);
}

}  // namespace

extern "C" int xor_reduce_words_launch(const void* words, void* out, int k,
                                       long long W, void* stream) {
  if (k <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const bool vec = (W % 4 == 0) && ((uintptr_t)words % 16 == 0) &&
                   ((uintptr_t)out % 16 == 0);
  if (vec) {
    const long long n4 = W / 4;
    xor_reduce_words_vec4<<<grid_for(n4), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint4*)words, (uint4*)out, k, n4);
  } else {
    xor_reduce_words_scalar<<<grid_for(W), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)words, (uint32_t*)out, k, W);
  }
  return (int)cudaGetLastError();
}

extern "C" int xor_reduce_groups_launch(const void* words, const void* groups,
                                        void* out, int G, int K, long long W,
                                        void* stream) {
  if (G <= 0 || K < 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const bool vec = (W % 4 == 0) && ((uintptr_t)words % 16 == 0) &&
                   ((uintptr_t)out % 16 == 0);
  if (vec) {
    launch_groups((const uint4*)words, (const long long*)groups, (uint4*)out,
                  G, K, W / 4, (cudaStream_t)stream);
  } else {
    launch_groups((const uint32_t*)words, (const long long*)groups,
                  (uint32_t*)out, G, K, W, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}
