// Candidate designs for the two-row XOR fold on sm_90a, timed against each
// other by scripts/bench_xor_designs.py. Not part of the port: the kernel
// the port ships is `xor_reduce_words_kernel` in
// src/repro_torch/kernels/csrc/xor_reduce.cu; this file holds the designs
// it was chosen from, each computing out = a ^ b over n bytes (n a multiple
// of 16, every pointer 16-byte aligned).
//
// Register designs `xd_reg<V, U, THREADS, CACHE, PERSIST>`: each thread
// folds U vectors V (16 or 8 bytes) of each row per step, all 2 * U loads
// before the first XOR; the vectors of a step lie THREADS apart. CACHE 0 takes the default cache policy, 1 the streaming one
// (`__ldcs` / `__stcs`), 2 loads through `ld.global.nc.L1::no_allocate`
// with default stores. PERSIST 0 sizes the grid from the row length (one
// step a thread); 1 launches as many blocks as fit on the card at once and
// gives each block one contiguous run of whole steps.
//
// TMA designs `xd_tma<STAGES, CHUNK>`: one (or two) persistent blocks an SM
// walk chunks of CHUNK bytes (chunk c to block c mod grid); one thread keeps
// STAGES chunks of both rows in flight with `cp.async.bulk` into a ring of
// shared-memory stages, each completed on an `mbarrier`; all threads XOR a
// stage from shared memory and store the result with streaming stores.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint4 vxor(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}

__device__ __forceinline__ uint2 vxor(uint2 a, uint2 b) {
  return make_uint2(a.x ^ b.x, a.y ^ b.y);
}

template <typename V>
__device__ __forceinline__ V ld(const V* p, int cache) {
  if (cache == 1) return __ldcs(p);
  if constexpr (sizeof(V) == 16) {
    if (cache == 2) {
      V v;
      asm volatile(
          "ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
          : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
          : "l"(p));
      return v;
    }
  }
  return *p;
}

template <typename V>
__device__ __forceinline__ void st(V* p, V v, int cache) {
  if (cache == 1) {
    __stcs(p, v);
  } else {
    *p = v;
  }
}

template <typename V, int U, int THREADS, int CACHE>
__device__ __forceinline__ void step(const V* __restrict__ a,
                                     const V* __restrict__ b,
                                     V* __restrict__ out, long long base,
                                     long long units) {
  V x[U], y[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long j = base + u * THREADS + threadIdx.x;
    if (j < units) x[u] = ld(a + j, CACHE);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long j = base + u * THREADS + threadIdx.x;
    if (j < units) y[u] = ld(b + j, CACHE);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long j = base + u * THREADS + threadIdx.x;
    if (j < units) st(out + j, vxor(x[u], y[u]), CACHE);
  }
}

// units of V; per_block: the units of one block's run (PERSIST), a
// multiple of U * THREADS
template <typename V, int U, int THREADS, int CACHE, int PERSIST>
__device__ __forceinline__ void xd_reg(const void* a, const void* b,
                                       void* out, long long units,
                                       long long per_block) {
  const V* x = static_cast<const V*>(a);
  const V* y = static_cast<const V*>(b);
  V* z = static_cast<V*>(out);
  if (PERSIST == 0) {
    step<V, U, THREADS, CACHE>(x, y, z, (long long)blockIdx.x * U * THREADS,
                               units);
    return;
  }
  const long long lo = (long long)blockIdx.x * per_block;
  long long hi = lo + per_block;
  if (hi > units) hi = units;
  for (long long base = lo; base < hi; base += U * THREADS)
    step<V, U, THREADS, CACHE>(x, y, z, base, hi);
}

// ---- the TMA ring
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t phase) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
  }
}

template <int CHUNK>
__device__ __forceinline__ void issue(uint8_t* stage, uint32_t bar,
                                      const uint8_t* a, const uint8_t* b,
                                      long long c) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(2 * CHUNK) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(stage)), "l"(a + c * CHUNK), "r"(CHUNK), "r"(bar)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(stage + CHUNK)), "l"(b + c * CHUNK), "r"(CHUNK),
         "r"(bar)
      : "memory");
}

template <int STAGES, int CHUNK>
__device__ __forceinline__ void xd_tma(const uint8_t* a, const uint8_t* b,
                                       uint4* out, long long chunks) {
  extern __shared__ __align__(128) uint8_t ring[];   // STAGES x (a, b) chunks
  __shared__ __align__(8) uint64_t full[STAGES];
  const int mine = (int)((chunks - blockIdx.x + gridDim.x - 1) / gridDim.x);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_addr(&full[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int i = 0; i < STAGES && i < mine; ++i)
      issue<CHUNK>(ring + (size_t)i * 2 * CHUNK, smem_addr(&full[i]), a, b,
                   blockIdx.x + (long long)i * gridDim.x);
  }
  __syncthreads();
  for (int i = 0; i < mine; ++i) {
    const int s = i % STAGES;
    bar_wait(smem_addr(&full[s]), (uint32_t)((i / STAGES) & 1));
    const uint4* x = reinterpret_cast<const uint4*>(ring + (size_t)s * 2 * CHUNK);
    const uint4* y = x + CHUNK / 16;
    uint4* dst = out + (blockIdx.x + (long long)i * gridDim.x) * (CHUNK / 16);
    for (int v = threadIdx.x; v < CHUNK / 16; v += blockDim.x) {
      const uint4 p = x[v], q = y[v];
      __stcs(dst + v, make_uint4(p.x ^ q.x, p.y ^ q.y, p.z ^ q.z, p.w ^ q.w));
    }
    __syncthreads();                 // every thread is done with stage s
    if (threadIdx.x == 0 && i + STAGES < mine)
      issue<CHUNK>(ring + (size_t)s * 2 * CHUNK, smem_addr(&full[s]), a, b,
                   blockIdx.x + (long long)(i + STAGES) * gridDim.x);
  }
}

// Each design is its own kernel, named xd<letter>_ (a profiler label).
#define REG(NAME, V, U, T, C, P)                                             \
  __global__ void __launch_bounds__(T)                                       \
      NAME(const void* a, const void* b, void* out, long long units,          \
           long long per_block) {                                            \
    xd_reg<V, U, T, C, P>(a, b, out, units, per_block);                      \
  }

REG(xdA_, uint4, 4, 256, 1, 0)  // U=4, streaming, grid by length (first try)
REG(xdB_, uint4, 4, 256, 0, 0)  // ... default cache policy
REG(xdC_, uint4, 1, 128, 0, 0)  // one vector a thread and row, 128 threads
REG(xdD_, uint4, 2, 256, 1, 0)  // U=2, streaming
REG(xdE_, uint4, 4, 256, 1, 1)  // U=4, streaming, one contiguous run a block
REG(xdF_, uint4, 4, 256, 0, 1)  // ... default cache policy
REG(xdG_, uint4, 4, 256, 2, 0)  // non-coherent no-allocate loads
REG(xdH_, uint4, 1, 128, 1, 0)  // one vector a thread and row, streaming
REG(xdI_, uint4, 2, 128, 1, 0)  // U=2, 128 threads, streaming
REG(xdJ_, uint4, 1, 256, 1, 0)  // one vector, 256 threads, streaming (shipped)
REG(xdK_, uint4, 1, 64, 1, 0)   // one vector, 64 threads, streaming
REG(xdL_, uint4, 4, 128, 1, 0)  // U=4, 128 threads, streaming
REG(xdM_, uint2, 2, 128, 0, 0)  // 8-byte vectors, U=2, 128 threads, default
REG(xdN_, uint4, 2, 128, 0, 0)  // U=2, 128 threads, default
REG(xdO_, uint2, 4, 128, 0, 0)  // 8-byte vectors, U=4, 128 threads, default
REG(xdP_, uint2, 2, 128, 1, 0)  // 8-byte vectors, U=2, 128 threads, streaming

// The port's earlier design (`xor_reduce_words_vec4`) at k = 2: a
// grid-stride loop, one vector a thread and pass, at most 8 blocks of 256
// an SM
__global__ void __launch_bounds__(256)
xdZ_(const uint4* a, const uint4* b, uint4* out, long long n4) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < n4;
       j += stride)
    out[j] = vxor(a[j], b[j]);
}

__global__ void __launch_bounds__(256)
xdT_(const uint8_t* a, const uint8_t* b, uint4* out, long long chunks) {
  xd_tma<4, 16384>(a, b, out, chunks);
}

__global__ void __launch_bounds__(256)
xdU_(const uint8_t* a, const uint8_t* b, uint4* out, long long chunks) {
  xd_tma<6, 8192>(a, b, out, chunks);
}

__global__ void __launch_bounds__(256)
xdV_(const uint8_t* a, const uint8_t* b, uint4* out, long long chunks) {
  xd_tma<8, 8192>(a, b, out, chunks);
}

__global__ void __launch_bounds__(256)
xdW_(const uint8_t* a, const uint8_t* b, uint4* out, long long chunks) {
  xd_tma<4, 8192>(a, b, out, chunks);    // two blocks an SM
}

struct Reg {
  const char* name;
  void (*fn)(const void*, const void*, void*, long long, long long);
  int vbytes, u, threads, persist;
};

const Reg kRegs[] = {
    {"xdA_", xdA_, 16, 4, 256, 0}, {"xdB_", xdB_, 16, 4, 256, 0},
    {"xdC_", xdC_, 16, 1, 128, 0}, {"xdD_", xdD_, 16, 2, 256, 0},
    {"xdE_", xdE_, 16, 4, 256, 1}, {"xdF_", xdF_, 16, 4, 256, 1},
    {"xdG_", xdG_, 16, 4, 256, 0}, {"xdH_", xdH_, 16, 1, 128, 0},
    {"xdI_", xdI_, 16, 2, 128, 0}, {"xdJ_", xdJ_, 16, 1, 256, 0},
    {"xdK_", xdK_, 16, 1, 64, 0},  {"xdL_", xdL_, 16, 4, 128, 0},
    {"xdM_", xdM_, 8, 2, 128, 0},  {"xdN_", xdN_, 16, 2, 128, 0},
    {"xdO_", xdO_, 8, 4, 128, 0},  {"xdP_", xdP_, 8, 2, 128, 0},
};
constexpr int kNumRegs = sizeof(kRegs) / sizeof(kRegs[0]);

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

struct Tma {
  const char* name;
  void (*fn)(const uint8_t*, const uint8_t*, uint4*, long long);
  int stages, chunk, per_sm;
};

const Tma kTmas[] = {
    {"xdT_", xdT_, 4, 16384, 1}, {"xdU_", xdU_, 6, 8192, 1},
    {"xdV_", xdV_, 8, 8192, 1},  {"xdW_", xdW_, 4, 8192, 2},
};
constexpr int kNumTmas = sizeof(kTmas) / sizeof(kTmas[0]);

int launch_tma(const Tma& t, const void* a, const void* b, void* out,
               long long n, cudaStream_t stream) {
  if (n % t.chunk) return (int)cudaErrorInvalidValue;
  const int smem = t.stages * 2 * t.chunk;
  cudaError_t err = cudaFuncSetAttribute(
      t.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  t.fn<<<sm_count() * t.per_sm, 256, smem, stream>>>(
      (const uint8_t*)a, (const uint8_t*)b, (uint4*)out, n / t.chunk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int xd_count() { return kNumRegs + kNumTmas + 1; }

extern "C" const char* xd_name(int i) {
  if (i == kNumRegs + kNumTmas) return "xdZ_";
  return i < kNumRegs ? kRegs[i].name : kTmas[i - kNumRegs].name;
}

// out = a ^ b over n bytes with design i
extern "C" int xd_launch(int i, const void* a, const void* b, void* out,
                         long long n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (i < 0 || i > kNumRegs + kNumTmas || n % 16)
    return (int)cudaErrorInvalidValue;
  if (i == kNumRegs + kNumTmas) {
    const long long n4 = n / 16, want = (n4 + 255) / 256;
    const long long cap = (long long)sm_count() * 8;
    xdZ_<<<(unsigned)(want < cap ? want : cap), 256, 0, s>>>(
        (const uint4*)a, (const uint4*)b, (uint4*)out, n4);
    return (int)cudaGetLastError();
  }
  if (i >= kNumRegs) return launch_tma(kTmas[i - kNumRegs], a, b, out, n, s);
  const Reg& r = kRegs[i];
  const long long units = n / r.vbytes, per_step = (long long)r.u * r.threads;
  long long blocks = (units + per_step - 1) / per_step, per_block = 0;
  if (r.persist) {
    int per_sm = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, r.fn, r.threads, 0);
    if (err != cudaSuccess) return (int)err;
    const long long fit = (long long)per_sm * sm_count();
    const long long steps = (units + per_step - 1) / per_step;
    per_block = (steps + fit - 1) / fit * per_step;
    blocks = (units + per_block - 1) / per_block;
  }
  r.fn<<<(unsigned)blocks, r.threads, 0, s>>>(a, b, out, units, per_block);
  return (int)cudaGetLastError();
}
