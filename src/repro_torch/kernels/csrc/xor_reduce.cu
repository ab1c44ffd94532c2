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
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

int grid_for(long long n) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (n + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * 8;   // 8 blocks of 256 per SM
  return (int)(want < cap ? want : cap);
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
