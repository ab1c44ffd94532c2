// The yardstick of an event step, for sm_90a: one warp doing a step's
// least dependent work `steps` times in a chain. chip_smoke.py
// (`step_floor_us`) builds it with nvcc and times it, and a batch's
// `chain_floor_ms` is its chain steps times one such step. It is a
// measurement, not a kernel of the port: the event loops themselves are
// in src/repro_torch/kernels/csrc/event_loop.cu, whose helpers the few
// lines below copy (`tmin`, `warp_min`).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr double kEps = 1e-9;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ double tmin(double a, double b) {
  if (isnan(a) || isnan(b)) return __dadd_rn(a, b);
  return b < a ? b : a;
}

__device__ __forceinline__ double warp_min(double v) {
  for (int o = 16; o > 0; o >>= 1)
    v = tmin(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// A step's least dependent work: the epoch index (a float64 divide and
// floor), one divide for a time to finish, a 5-level shuffle min, one
// debit and compare. Writes the chain's end so that nothing is left out.
__global__ void __launch_bounds__(32)
event_step_floor_kernel(double interval, double rate, double chunk,
                        long long steps, double* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const double eps_chunk = __dmul_rn(kEps, chunk);
  double t = 0.0, left = __dmul_rn(chunk, 1.0 + lane);
  const double r = __dmul_rn(rate, 1.0 + 0.25 * lane);
  for (long long s = 0; s < steps; ++s) {
    const double e_f = floor(t / interval);
    const double end = __dmul_rn(__dadd_rn(e_f, 1.0), interval);
    double dt = tmin(__dsub_rn(end, t), warp_min(left / r));
    if (!(isfinite(dt) && dt > 0.0)) dt = kEps;
    left = __dsub_rn(left, __dmul_rn(r, dt));
    if (left <= eps_chunk) left = chunk;
    t = __dadd_rn(t, dt);
  }
  out[lane] = __dadd_rn(t, left);
}

}  // namespace

// `steps` chained steps on one warp; `out` (32,) doubles.
extern "C" int event_step_floor_launch(double interval, double rate,
                                       double chunk, long long steps,
                                       void* out, void* stream) {
  if (steps < 0) return (int)cudaErrorInvalidValue;
  event_step_floor_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      interval, rate, chunk, steps, (double*)out);
  return (int)cudaGetLastError();
}
