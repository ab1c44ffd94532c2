// GF(256) matrix multiply over bit-sliced chunks, for sm_90a.
//
// Replaces the Pallas TPU kernel `gf256_matmul_planes`
// (src/repro/kernels/gf256_matmul.py, body `_kernel`):
//
//   out[o, bi, w] = XOR_{i, bj} planes[i, bj, w] & masks[o, i, bi, bj]
//
// masks (m, k, 8, 8), planes (k, 8, W) and out (m, 8, W) are contiguous
// 32-bit words: {0, ~0} AND-masks and bit-planes (repro_torch/ec/bitplane.py).
//
// What bounds it on the H100: each word column w reads 8*k plane words and
// writes 8*m, and does 2*64*m*k AND/XOR operations on them. At (m, k) = (1, 1)
// (the helper premultiply) that is 128 operations per 64 bytes moved, far
// under the card's integer-op/byte balance, so it is bound by device memory.
// At (3, 6) (three parities of six data blocks) it is 2304 operations per
// 288 bytes, which puts it at the 32-bit integer-op limit of the CUDA cores
// (AND/XOR on words: the tensor cores do not apply).
//
// Design: one thread per word column, an (m, ceil(W/256)) grid with the
// output row o on blockIdx.x, so the m blocks that read the same plane tile
// run next to each other and the tile is read from device memory once and
// from L2 for the other rows. Each block stages the 64*k mask words of its
// row o in shared memory (the masks are uniform across the block: each
// thread reads the same 16 bytes, a broadcast). Each thread loops over the k
// inputs at run time, loads the 8 plane words of input i (consecutive
// threads, consecutive addresses: coalesced) and keeps its 8 accumulators
// in registers; each `d & mask` folded into the XOR is one 3-input LOP3. The
// ragged edge w >= W is masked, not padded. Tiles past gridDim.y (W above
// 65535*256 words) are walked by a grid-stride loop.
//
// The same file holds the batched premultiply that replaces the Pallas
// kernel `gf256_scale_planes` (src/repro/kernels/gf256_matmul.py, the same
// body `_kernel` with k = 1):
//
//   out[r, bi, w] = XOR_bj planes[r, bj, w] & masks[r, 0, bi, bj]
//
// masks (M, 1, 8, 8), planes (M, 8, W), out (M, 8, W): every row r has its
// own coefficient, an elementwise scale over rows, not an (m, k) product.
// It reads 32 bytes and writes 32 bytes per word column and row for 64
// AND/XOR pairs, so it is bound by device memory: 2 * M * 32 * W bytes.
// Design: an (M, ceil(W/256)) grid, one thread per word column of row r =
// blockIdx.x; the block stages row r's 64 mask words in shared memory and
// reads them as 16-byte broadcasts; each thread loads its 8 plane words
// (coalesced), folds them through `fold_8x8` (shared with the product
// above) and stores 8 words. No loop over inputs; the ragged edge is
// masked, not padded.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

// acc[bi] ^= XOR_bj d[bj] & mask[bi, bj] for one 8x8 mask block in shared
// memory: row bi as two 16-byte loads, the same address for every thread
// (a broadcast); each `d & m` folded into the XOR is one 3-input LOP3.
__device__ __forceinline__ void fold_8x8(const uint4* __restrict__ mi,
                                         const uint32_t (&d)[8],
                                         uint32_t (&acc)[8]) {
#pragma unroll
  for (int bi = 0; bi < 8; ++bi) {
    const uint4 lo = mi[2 * bi], hi = mi[2 * bi + 1];
    acc[bi] ^= (d[0] & lo.x) ^ (d[1] & lo.y) ^ (d[2] & lo.z) ^
               (d[3] & lo.w) ^ (d[4] & hi.x) ^ (d[5] & hi.y) ^
               (d[6] & hi.z) ^ (d[7] & hi.w);
  }
}

__global__ void __launch_bounds__(kThreads)
gf256_matmul_planes_kernel(const uint32_t* __restrict__ masks,
                           const uint32_t* __restrict__ planes,
                           uint32_t* __restrict__ out,
                           int k, long long W, long long tiles) {
  extern __shared__ __align__(16) uint32_t smask[];   // (k, 8, 8) of row o
  const int o = blockIdx.x;
  const uint32_t* mrow = masks + (size_t)o * k * 64;
  for (int j = threadIdx.x; j < k * 64; j += blockDim.x) smask[j] = mrow[j];
  __syncthreads();

  for (long long tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    const long long w = tile * kThreads + threadIdx.x;
    if (w >= W) continue;
    uint32_t acc[8];
#pragma unroll
    for (int bi = 0; bi < 8; ++bi) acc[bi] = 0u;
    for (int i = 0; i < k; ++i) {
      const uint32_t* p = planes + (size_t)i * 8 * W + w;
      uint32_t d[8];
#pragma unroll
      for (int bj = 0; bj < 8; ++bj) d[bj] = p[(size_t)bj * W];
      fold_8x8(reinterpret_cast<const uint4*>(smask + i * 64), d, acc);
    }
    uint32_t* q = out + (size_t)o * 8 * W + w;
#pragma unroll
    for (int bi = 0; bi < 8; ++bi) q[(size_t)bi * W] = acc[bi];
  }
}

__global__ void __launch_bounds__(kThreads)
gf256_scale_planes_kernel(const uint32_t* __restrict__ masks,
                          const uint32_t* __restrict__ planes,
                          uint32_t* __restrict__ out, long long W,
                          long long tiles) {
  __shared__ __align__(16) uint32_t smask[64];         // (8, 8) of row r
  const int r = blockIdx.x;
  if (threadIdx.x < 64) smask[threadIdx.x] = masks[(size_t)r * 64 + threadIdx.x];
  __syncthreads();

  const uint32_t* p = planes + (size_t)r * 8 * W;
  uint32_t* q = out + (size_t)r * 8 * W;
  for (long long tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    const long long w = tile * kThreads + threadIdx.x;
    if (w >= W) continue;
    uint32_t d[8], acc[8];
#pragma unroll
    for (int bj = 0; bj < 8; ++bj) d[bj] = p[(size_t)bj * W + w];
#pragma unroll
    for (int bi = 0; bi < 8; ++bi) acc[bi] = 0u;
    fold_8x8(reinterpret_cast<const uint4*>(smask), d, acc);
#pragma unroll
    for (int bi = 0; bi < 8; ++bi) q[(size_t)bi * W + w] = acc[bi];
  }
}

}  // namespace

extern "C" int gf256_scale_planes_launch(const void* masks, const void* planes,
                                         void* out, int M, long long W,
                                         void* stream) {
  if (M <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const long long tiles = (W + kThreads - 1) / kThreads;
  dim3 grid((unsigned)M, (unsigned)(tiles < kMaxGridY ? tiles : kMaxGridY));
  gf256_scale_planes_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)masks, (const uint32_t*)planes, (uint32_t*)out, W,
      tiles);
  return (int)cudaGetLastError();
}

extern "C" int gf256_matmul_planes_launch(const void* masks, const void* planes,
                                          void* out, int m, int k, long long W,
                                          void* stream) {
  if (m <= 0 || k <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)k * 64 * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gf256_matmul_planes_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long tiles = (W + kThreads - 1) / kThreads;
  dim3 grid((unsigned)m, (unsigned)(tiles < kMaxGridY ? tiles : kMaxGridY));
  gf256_matmul_planes_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)masks, (const uint32_t*)planes, (uint32_t*)out, k, W,
      tiles);
  return (int)cudaGetLastError();
}
