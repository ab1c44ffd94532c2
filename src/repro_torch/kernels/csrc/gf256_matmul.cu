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
//
// Neither plane kernel is on a main path: the byte entry points in
// `kernels/ops.py` launch the two byte-domain kernels below instead.
//
// ---- Byte domain: the same two Pallas kernels, without bit-planes.
//
// `gf256_matmul_bytes` replaces `gf256_matmul_planes` together with the
// bit-slicing around it (src/repro/kernels/gf256_matmul.py, `_kernel`, and
// `bitplane.pack` / `unpack`), taking and returning bytes:
//
//   out[o, p] = XOR_i coeff[o, i] (*) in[i, p]    in (k, n), out (m, n) uint8
//
// and `gf256_scale_bytes` replaces `gf256_scale_planes` with its
// bit-slicing: out[r, p] = coeff[r] (*) in[r, p], in and out (M, n) uint8.
//
// The arithmetic: multiplying by c is GF(2)-linear, and column bj of its
// 8x8 bit-matrix, read as a byte, is col[bj] = c (*) (1 << bj). So
// c (*) x = XOR_{bj : bit bj of x set} col[bj]. On a 32-bit word of four
// bytes: expand bit bj of each byte into a 0x00 / 0xFF byte mask (shift it
// up to bit 7 of its byte, then one `prmt` replicates each byte's sign
// bit), AND it with col[bj] replicated to all four bytes and XOR it into
// the accumulator (one LOP3). The host makes the replicated column words
// (m, k, 8) from the coefficients (`gf256_matmul.coeff_to_columns`); the
// layout is never changed, the TPU's reason for bit-planes (no byte
// shuffle) does not hold on Hopper.
//
// What bounds it on the H100: per 4-byte word of a row, 15 ops to expand
// the 8 masks of each input (7 shifts, 8 `prmt`) and one LOP3 per (output,
// input, bit): 15 k + 8 m k 32-bit integer ops, against 4 (k + m) bytes of
// device memory. At 64 integer ops per clock per SM the (1, 1) premultiply
// and the M-row scale (23 ops per 8 bytes moved) are bound by device
// memory; (3, 3) is at the balance and (3, 6) is bound by integer ops.
// The masks of an input are expanded once and shared by every output of
// the block's tile, so the 8 m k LOP3s (the bit-matrix product itself, the
// count the plane kernel does too) are the larger part.
//
// Design: each thread owns 16 contiguous bytes of a row, one `uint4`
// (neighbouring threads on neighbouring 16 bytes: the widest coalesced
// load); it loops over the k inputs at run time and keeps 4 words of
// accumulators for each of up to kMaxTile outputs in registers. The grid's
// x axis walks tiles of outputs (adjacent blocks read the same input bytes,
// the second from L2), its y axis and a grid-stride loop the row. A block
// stages its tile's column words in shared memory and reads them as 16-byte
// broadcasts. A row whose start is not 16-byte aligned, or whose in and out
// rows are not aligned alike, and the ragged head and tail of a row, take a
// scalar path: 4 bytes a thread, loaded and stored byte by byte, never past
// n. Coefficients 0 and 1 run the same arithmetic (zeros, a copy); nothing
// is skipped, since an output row is written whole. For the scale each
// block serves one row (its 8 column words), and the alignment is decided
// per row. The scale's output rows may be named by a table of row indices
// into an output of any row stride: the batched data plane writes every
// premultiplied row straight into its row of the repair buffer, so no
// (M, n) product is made and copied in.
//
// ---- The checkpoint load: every stripe's reconstruct in one launch.
//
// `gf256_reconstruct_stripes` is the same Pallas kernel's function
// (`gf256_matmul_planes`, src/repro/kernels/gf256_matmul.py:40, which the
// reference's load reaches once a stripe through `ops.rs_reconstruct`)
// over a batch of S independent problems, rows read and written where
// they lie:
//
//   *dst[s, o] [0, n) = XOR_i C[p(s), o, i] (*) *src[s, i] [0, n)
//
// for every stripe s and output o < f(s). One int64 record a stripe,
// `rec` (S, k + fmax + 1): the byte offsets from one base address (the
// lowest of the buffers') of its k source rows and of its fmax
// destination rows (-1 past its f(s) outputs), and its repair pattern
// p(s). At the checkpoint load the sources are surviving data rows of the
// restored blob and parity rows staged beside it, the destinations the
// blob's lost data rows. `cols` (P, fmax, k, 8) holds each pattern's
// column words, zero past its f outputs.
//
// What bounds it on the H100: each of the S (k + f) rows is read or
// written once, and a 4-byte word of a row costs 15 k + 8 f k integer ops
// (as `gf256_matmul_bytes` at (f, k)): at the load's (1, 4) and (2, 4),
// 92 and 124 ops against 20 and 24 bytes, close to the card's balance of
// integer ops and bytes; the bytes bound it by a little.
//
// Design: the per-stripe launches it replaces were latency (64 blocks and
// ~2.6 us a 256 KiB stripe, under half of the 132 SMs). Here one 1-D grid
// walks (stripe, tile of the row), so gridDim.y never binds and every SM
// has blocks: ~110k blocks of 256 threads at the load's 3,451 stripes. A
// block stages its stripe's record and its pattern's f x k x 8 column
// words in shared memory (two barriers a stripe), and decides the
// stripe's alignment: all k + f rows alike mod 16 give 16-byte vectors
// between a scalar head and tail, as in `gf_bytes_rows`; rows aligned
// otherwise take 4-byte groups over the whole row. A tile's threads stride
// over the row's items, so the rule lives in the kernel alone and the
// blocks a stripe (one pass over the row's vectors) only set the
// parallelism. A thread owns kVectors = 2 vectors kThreads apart
// (coalesced) and issues the loads of up to kLoadBatch inputs of both
// before it folds any, so each thread keeps kLoadBatch x 2 x 16 bytes in
// flight. More than kMaxTile outputs are computed in tiles of kMaxTile
// (the inputs read again, from L2). No TMA, `wgmma` or cluster: the work
// is one pass over the bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;
constexpr long long kMaxGridX = 2147483647;

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

// ---- byte domain

constexpr int kMaxTile = 4;        // outputs per block in gf256_matmul_bytes

// 0xFF in each byte of x whose bit bj is set, else 0x00: bit bj is shifted
// to bit 7 of its byte, and `prmt` in its default mode with selector nibbles
// 8, 9, A, B replicates the sign bit of byte n over byte n.
// (The C form below the `prmt` is what the CPU emulation of this file,
// scripts/emulate_stripe_repair.py, compiles: the same bytes.)
__device__ __forceinline__ uint32_t bit_mask(uint32_t x, int bj) {
#ifdef __CUDA_ARCH__
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;"
      : "=r"(d)
      : "r"(x << (7 - bj)), "r"(0u), "r"(0xBA98u));
  return d;
#else
  return (((x << (7 - bj)) >> 7) & 0x01010101u) * 0xFFu;
#endif
}

// acc[t][q] ^= coeff[t] (*) x[q] for the MT outputs of a tile and NW words
// of one input; col + t * col_stride holds output t's 8 column words of
// this input (16-byte aligned, in shared memory).
template <int MT, int NW>
__device__ __forceinline__ void fold_bytes(const uint32_t (&x)[NW],
                                           const uint32_t* col,
                                           int col_stride,
                                           uint32_t (&acc)[MT][NW]) {
  uint32_t c[MT][8];
#pragma unroll
  for (int t = 0; t < MT; ++t) {
    const uint4* ct = reinterpret_cast<const uint4*>(col + t * col_stride);
    const uint4 lo = ct[0], hi = ct[1];
    c[t][0] = lo.x; c[t][1] = lo.y; c[t][2] = lo.z; c[t][3] = lo.w;
    c[t][4] = hi.x; c[t][5] = hi.y; c[t][6] = hi.z; c[t][7] = hi.w;
  }
#pragma unroll
  for (int bj = 0; bj < 8; ++bj) {
#pragma unroll
    for (int q = 0; q < NW; ++q) {
      const uint32_t mask = bit_mask(x[q], bj);
#pragma unroll
      for (int t = 0; t < MT; ++t) acc[t][q] ^= mask & c[t][bj];
    }
  }
}

// The byte rows of one problem: k input rows from `in`, `rows_out` (<= MT)
// output rows from `out`, every row n bytes apart; column words `scol`
// (MT, k, 8). Bytes [head, head + 16 n16) go 16 at a time (every row
// 16-byte aligned there), the rest, [0, head) and [head + 16 n16, n), 4 at
// a time byte by byte. One index space covers both: items [0, n16) are
// vectors, then the scalar groups of the head, then those of the tail.
template <int MT>
__device__ __forceinline__ void gf_bytes_rows(const uint32_t* scol, int k,
                                              const uint8_t* __restrict__ in,
                                              uint8_t* __restrict__ out,
                                              int rows_out, long long n,
                                              long long head, long long n16) {
  const long long tail_lo = head + 16 * n16;
  const long long head_groups = (head + 3) / 4;
  const long long items = n16 + head_groups + (n - tail_lo + 3) / 4;
  const long long stride = (long long)gridDim.y * blockDim.x;
  for (long long u = (long long)blockIdx.y * blockDim.x + threadIdx.x;
       u < items; u += stride) {
    if (u < n16) {
      const long long off = head + 16 * u;
      uint32_t acc[MT][4] = {};
      for (int i = 0; i < k; ++i) {
        const uint4 v =
            *reinterpret_cast<const uint4*>(in + (size_t)i * n + off);
        const uint32_t x[4] = {v.x, v.y, v.z, v.w};
        fold_bytes<MT, 4>(x, scol + i * 8, k * 8, acc);
      }
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        if (t < rows_out) {
          *reinterpret_cast<uint4*>(out + (size_t)t * n + off) =
              make_uint4(acc[t][0], acc[t][1], acc[t][2], acc[t][3]);
        }
      }
    } else {
      const long long g = u - n16;
      const long long p = g < head_groups ? 4 * g : tail_lo + 4 * (g - head_groups);
      const long long end = g < head_groups ? head : n;
      const int cnt = (int)(end - p < 4 ? end - p : 4);
      uint32_t acc[MT][1] = {};
      for (int i = 0; i < k; ++i) {
        const uint8_t* src = in + (size_t)i * n + p;
        uint32_t x[1] = {0u};
        for (int b = 0; b < cnt; ++b) x[0] |= (uint32_t)src[b] << (8 * b);
        fold_bytes<MT, 1>(x, scol + i * 8, k * 8, acc);
      }
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        if (t < rows_out) {
          uint8_t* dst = out + (size_t)t * n + p;
          for (int b = 0; b < cnt; ++b) dst[b] = (uint8_t)(acc[t][0] >> (8 * b));
        }
      }
    }
  }
}

// cols (m, k, 8) column words, in (k, n), out (m, n); blockIdx.x is the
// tile of outputs [MT x, MT x + MT).
template <int MT>
__global__ void __launch_bounds__(kThreads)
gf256_matmul_bytes_kernel(const uint32_t* __restrict__ cols,
                          const uint8_t* __restrict__ in,
                          uint8_t* __restrict__ out, int m, int k,
                          long long n, long long head, long long n16) {
  extern __shared__ __align__(16) uint32_t scol[];   // (MT, k, 8)
  const int o0 = blockIdx.x * MT;
  const int rows_out = m - o0 < MT ? m - o0 : MT;
  const int per_row = k * 8;
  for (int j = threadIdx.x; j < MT * per_row; j += blockDim.x)
    scol[j] = j < rows_out * per_row ? cols[(size_t)o0 * per_row + j] : 0u;
  __syncthreads();
  gf_bytes_rows<MT>(scol, k, in, out + (size_t)o0 * n, rows_out, n, head, n16);
}

// cols (M, 8) column words, in (M, n); blockIdx.x is the row r, whose
// product goes to row dst[r] of out (null dst: row r), rows `ld` bytes
// apart. The row is vectorised when its in and out starts are aligned
// alike.
__global__ void __launch_bounds__(kThreads)
gf256_scale_bytes_kernel(const uint32_t* __restrict__ cols,
                         const uint8_t* __restrict__ in,
                         const long long* __restrict__ dst,
                         uint8_t* __restrict__ out, long long n,
                         long long ld) {
  __shared__ __align__(16) uint32_t scol[8];
  const int r = blockIdx.x;
  if (threadIdx.x < 8) scol[threadIdx.x] = cols[(size_t)r * 8 + threadIdx.x];
  __syncthreads();
  const uint8_t* row_in = in + (size_t)r * n;
  uint8_t* row_out = out + (size_t)(dst ? dst[r] : r) * ld;
  long long head = n, n16 = 0;
  if ((uintptr_t)row_in % 16 == (uintptr_t)row_out % 16) {
    head = (16 - (long long)((uintptr_t)row_in % 16)) % 16;
    if (head > n) head = n;
    n16 = (n - head) / 16;
  }
  gf_bytes_rows<1>(scol, 1, row_in, row_out, 1, n, head, n16);
}

constexpr int kLoadBatch = 4;      // inputs whose loads a thread issues together
constexpr int kVectors = 2;        // 16-byte vectors a thread takes a pass

// A thread's share of one pass over one stripe in
// gf256_reconstruct_stripes: the MT outputs at byte offsets `doff` from
// dst of the k inputs at `soff` from src, column words `scol` (MT, k, 8)
// with stride k * 8 between outputs. The row's `items` are gf_bytes_rows': [0, n16) vectors
// at head + 16 u, then the 4-byte groups of the head and of the tail. The
// thread owns the items u0 + j * kThreads, j < kVectors.
template <int MT>
__device__ __forceinline__ void stripe_rows(
    const uint32_t* scol, int k, const uint8_t* __restrict__ src,
    const long long* soff, uint8_t* __restrict__ dst, const long long* doff,
    long long n, long long head, long long n16, long long items,
    long long u0) {
  constexpr int V = kVectors;
  if (u0 < n16) {
    uint32_t acc[MT][4 * V];
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int q = 0; q < 4 * V; ++q) acc[t][q] = 0u;
    for (int i0 = 0; i0 < k; i0 += kLoadBatch) {
      uint4 v[kLoadBatch][V];
#pragma unroll
      for (int ii = 0; ii < kLoadBatch; ++ii) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const long long u = u0 + (long long)j * kThreads;
          v[ii][j] = make_uint4(0u, 0u, 0u, 0u);
          if (i0 + ii < k && u < n16)
            v[ii][j] = *reinterpret_cast<const uint4*>(
                src + soff[i0 + ii] + head + 16 * u);
        }
      }
#pragma unroll
      for (int ii = 0; ii < kLoadBatch; ++ii) {
        if (i0 + ii < k) {
          uint32_t x[4 * V];
#pragma unroll
          for (int j = 0; j < V; ++j) {
            x[4 * j] = v[ii][j].x;
            x[4 * j + 1] = v[ii][j].y;
            x[4 * j + 2] = v[ii][j].z;
            x[4 * j + 3] = v[ii][j].w;
          }
          fold_bytes<MT, 4 * V>(x, scol + (i0 + ii) * 8, k * 8, acc);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const long long u = u0 + (long long)j * kThreads;
      if (u < n16) {
#pragma unroll
        for (int t = 0; t < MT; ++t) {
          *reinterpret_cast<uint4*>(dst + doff[t] + head + 16 * u) =
              make_uint4(acc[t][4 * j], acc[t][4 * j + 1], acc[t][4 * j + 2],
                         acc[t][4 * j + 3]);
        }
      }
    }
  }
  const long long tail_lo = head + 16 * n16;
  const long long head_groups = (head + 3) / 4;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const long long u = u0 + (long long)j * kThreads;
    if (u < n16 || u >= items) continue;
    const long long g = u - n16;
    const long long p = g < head_groups ? 4 * g : tail_lo + 4 * (g - head_groups);
    const long long end = g < head_groups ? head : n;
    const int cnt = (int)(end - p < 4 ? end - p : 4);
    uint32_t acc[MT][1] = {};
    for (int i = 0; i < k; ++i) {
      const uint8_t* row = src + soff[i] + p;
      uint32_t x[1] = {0u};
      for (int b = 0; b < cnt; ++b) x[0] |= (uint32_t)row[b] << (8 * b);
      fold_bytes<MT, 1>(x, scol + i * 8, k * 8, acc);
    }
#pragma unroll
    for (int t = 0; t < MT; ++t) {
      uint8_t* out = dst + doff[t] + p;
      for (int b = 0; b < cnt; ++b) out[b] = (uint8_t)(acc[t][0] >> (8 * b));
    }
  }
}

// rec (S, k + fmax + 1) int64, cols (P, fmax, k, 8); src and dst are one
// base address, the rows' offsets from it in rec (no byte is both read
// and written, so each access path is the only one to its bytes). Block b
// serves tile b % tiles of stripe b / tiles (a grid-stride loop past
// gridDim.x), and the tile's threads stride over the stripe's items, so
// `tiles` sets the parallelism and nothing else. Two blocks an SM: left
// to itself ptxas gives the kernel more than 128 registers, so one block
// an SM, and it ran markedly slower at the load's layouts on an H100.
__global__ void __launch_bounds__(kThreads, 2)
gf256_reconstruct_stripes_kernel(const uint32_t* __restrict__ cols,
                                 const long long* __restrict__ rec,
                                 const uint8_t* __restrict__ src,
                                 uint8_t* __restrict__ dst, int k, int fmax,
                                 long long n, long long tiles,
                                 long long blocks) {
  extern __shared__ __align__(16) uint32_t stripe_smem[];
  uint32_t* scol = stripe_smem;                       // (f, k, 8)
  long long* srec = reinterpret_cast<long long*>(stripe_smem + fmax * k * 8);
  const int width = k + fmax + 1;
  for (long long b = blockIdx.x; b < blocks; b += gridDim.x) {
    const long long s = b / tiles;
    const long long tile = b - s * tiles;
    for (int j = threadIdx.x; j < width; j += blockDim.x)
      srec[j] = rec[s * width + j];
    __syncthreads();
    int f = 0;
    while (f < fmax && srec[k + f] >= 0) ++f;
    const uint32_t* pc = cols + srec[width - 1] * fmax * k * 8;
    for (int j = threadIdx.x; j < f * k * 8; j += blockDim.x) scol[j] = pc[j];
    // one alignment class for all k + f rows, else 4-byte groups
    const long long a = ((uintptr_t)src + srec[0]) % 16;
    bool alike = true;
    for (int i = 1; i < k + f; ++i)
      alike &= ((uintptr_t)src + srec[i]) % 16 == a;
    long long head = n, n16 = 0;
    if (alike) {
      head = (16 - a) % 16;
      if (head > n) head = n;
      n16 = (n - head) / 16;
    }
    const long long items = n16 + (head + 3) / 4 + (n - head - 16 * n16 + 3) / 4;
    __syncthreads();
    const long long step = tiles * kVectors * kThreads;
    for (long long u0 = tile * kVectors * kThreads + threadIdx.x; u0 < items;
         u0 += step) {
      for (int o0 = 0; o0 < f; o0 += kMaxTile) {
        const uint32_t* c = scol + o0 * k * 8;
        const long long* d = srec + k + o0;
#define STRIPE_ROWS(MT) \
  stripe_rows<MT>(c, k, src, srec, dst, d, n, head, n16, items, u0)
        switch (f - o0 < kMaxTile ? f - o0 : kMaxTile) {
          case 1: STRIPE_ROWS(1); break;
          case 2: STRIPE_ROWS(2); break;
          case 3: STRIPE_ROWS(3); break;
          default: STRIPE_ROWS(4);
        }
#undef STRIPE_ROWS
      }
    }
    __syncthreads();          // the next stripe's record goes where this is
  }
}

template <int MT>
int launch_matmul_bytes(const uint32_t* cols, const uint8_t* in, uint8_t* out,
                        int m, int k, long long n, cudaStream_t stream) {
  const size_t smem = (size_t)MT * k * 8 * sizeof(uint32_t);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gf256_matmul_bytes_kernel<MT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // every input and output row aligned alike: one head, then vectors
  const bool vec = ((uintptr_t)in % 16 == (uintptr_t)out % 16) &&
                   (n % 16 == 0 || (k == 1 && m == 1));
  long long head = n, n16 = 0;
  if (vec) {
    head = (16 - (long long)((uintptr_t)in % 16)) % 16;
    if (head > n) head = n;
    n16 = (n - head) / 16;
  }
  const long long items = n16 + (head + 3) / 4 + (n - head - 16 * n16 + 3) / 4;
  const long long blocks = (items + kThreads - 1) / kThreads;
  const int tiles = (m + MT - 1) / MT;
  dim3 grid((unsigned)tiles, (unsigned)(blocks < kMaxGridY ? blocks : kMaxGridY));
  gf256_matmul_bytes_kernel<MT><<<grid, kThreads, smem, stream>>>(
      cols, in, out, m, k, n, head, n16);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gf256_matmul_bytes_launch(const void* cols, const void* in,
                                         void* out, int m, int k, long long n,
                                         void* stream) {
  if (m <= 0 || k <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  // outputs per block: the fewest tiles of at most kMaxTile, evenly filled
  const int tiles = (m + kMaxTile - 1) / kMaxTile;
  const int mt = (m + tiles - 1) / tiles;
  const uint32_t* c = (const uint32_t*)cols;
  const uint8_t* x = (const uint8_t*)in;
  uint8_t* y = (uint8_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mt) {
    case 1: return launch_matmul_bytes<1>(c, x, y, m, k, n, s);
    case 2: return launch_matmul_bytes<2>(c, x, y, m, k, n, s);
    case 3: return launch_matmul_bytes<3>(c, x, y, m, k, n, s);
    default: return launch_matmul_bytes<4>(c, x, y, m, k, n, s);
  }
}

// dst: null (row r of the product to out + r * ld) or M row indices of
// out; out rows are ld >= n bytes apart and overlap no row of in.
extern "C" int gf256_scale_bytes_launch(const void* cols, const void* in,
                                        const void* dst, void* out, int M,
                                        long long n, long long ld,
                                        void* stream) {
  if (M <= 0 || n <= 0 || ld < n) return (int)cudaErrorInvalidValue;
  // a row's items: n / 16 vectors and at most 8 scalar groups; a row that
  // is not vectorised walks its n / 4 groups with the same grid
  const long long blocks = (n / 16 + 8 + kThreads - 1) / kThreads;
  dim3 grid((unsigned)M, (unsigned)(blocks < kMaxGridY ? blocks : kMaxGridY));
  gf256_scale_bytes_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)cols, (const uint8_t*)in, (const long long*)dst,
      (uint8_t*)out, n, ld);
  return (int)cudaGetLastError();
}

// rec holds byte offsets from `base`: k source rows, fmax destination
// rows (-1 past a stripe's f), then its pattern. A stripe takes enough
// blocks for one pass over a row of 16-byte vectors.
extern "C" int gf256_reconstruct_stripes_launch(const void* cols,
                                                const void* rec, void* base,
                                                long long stripes, int k,
                                                int fmax, long long n,
                                                void* stream) {
  if (stripes <= 0 || k <= 0 || fmax <= 0 || n <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)fmax * k * 8 * sizeof(uint32_t) +
                      (size_t)(k + fmax + 1) * sizeof(long long);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gf256_reconstruct_stripes_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long per_block = (long long)kVectors * kThreads;
  const long long tiles = ((n + 15) / 16 + per_block - 1) / per_block;
  const long long blocks = stripes * tiles;
  const long long grid = blocks < kMaxGridX ? blocks : kMaxGridX;
  cudaStream_t s = (cudaStream_t)stream;
  gf256_reconstruct_stripes_kernel<<<(unsigned)grid, kThreads, smem, s>>>(
      (const uint32_t*)cols, (const long long*)rec, (const uint8_t*)base,
      (uint8_t*)base, k, fmax, n, tiles, blocks);
  return (int)cudaGetLastError();
}

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
