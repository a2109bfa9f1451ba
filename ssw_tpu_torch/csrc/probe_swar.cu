// probe_swar: dependent max chains, one element (or one packed pair of
// 16-bit halves) per thread, to time one step of the max the forward
// kernels chain per column.
//
// Replaces the JAX package's TPU probe tools/probe_swar.py (_native_kernel
// :58 and _swar_kernel :66, pallas_call in run :77), which times a
// 256-step chain of maxes over a (64, 512) int32 array in two forms.  The
// forms here (template parameter Form):
//   native          x = max(x, y)            y += inc   (int32)
//   swar            x = packed_max(x, y)     y += inc   (guard-bit 2 x int16
//                                                      in int32, 8 ops)
//   vmaxs2          x = __vmaxs2(x, y)       y += inc   (the hardware s16x2
//                                                      max of the int16 tier)
//   viaddmax_s16x2  x = __viaddmax_s16x2(x, z, y)  y += inc
//   viaddmax_s32    x = __viaddmax_s32(x, z, y)    y += inc
// inc and z are kernel arguments (1 or 0x00010001, and 0), and y at each
// step comes from the step count in an asm statement (see the loop).  The
// step loop is 8 steps unrolled inside a loop kept rolled, so `cuobjdump
// -sass` shows one body of 8 steps (tools/probe_swar.py counts its max
// instructions; ptxas may pair two steps of a plain max into one 3-way max
// of x and two y, which keeps every y in the chain).
//
// What bounds it: one dependent ALU step per element and step, so a warp
// alone measures the step's latency and the full card its issue rate; the
// chain touches memory once per element.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libprobe_swar.so probe_swar.cu

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kG = 0x80008000u;    // per-half borrow guard
constexpr unsigned kLow = 0x7fff7fffu;
constexpr int kUnroll = 8;              // steps per loop body

enum Form { kNative = 0, kSwar = 1, kVmaxs2 = 2, kAddmax16 = 3,
            kAddmax32 = 4, kForms = 5 };

// Per-16-bit-half max of two packed pairs, halves in [0, 2^15)
// (tools/probe_swar.py packed_max).
__device__ __forceinline__ unsigned packed_max(unsigned a, unsigned b) {
  const unsigned t = (a | kG) - b;
  const unsigned m = t & kG;
  const unsigned mask = m - (m >> 15);
  return (a & mask) | (b & (mask ^ kLow));
}

template <int F>
__device__ __forceinline__ unsigned step(unsigned x, unsigned y,
                                         unsigned z) {
  if constexpr (F == kNative) return unsigned(max(int(x), int(y)));
  else if constexpr (F == kSwar) return packed_max(x, y);
  else if constexpr (F == kVmaxs2) return __vmaxs2(x, y);
  else if constexpr (F == kAddmax16) return __viaddmax_s16x2(x, z, y);
  else return unsigned(__viaddmax_s32(int(x), int(z), int(y)));
}

// depth: a multiple of kUnroll, or 1 (one step: the form's exactness check)
template <int F>
__global__ void chain_kernel(const unsigned* __restrict__ x,
                             const unsigned* __restrict__ y,
                             unsigned* __restrict__ out, int n, int depth,
                             unsigned inc, unsigned z) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  unsigned a = x[i];
  const unsigned b = y[i];
  if (depth == 1) {
    out[i] = step<F>(a, b, z);
    return;
  }
#pragma unroll 1
  for (int s = 0; s < depth; s += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      // y at step k is y0 + k * inc (y += inc per step), computed from k in
      // an asm statement: no dependent chain of adds beside the maxes, and
      // nvcc cannot see the arithmetic sequence (it folded a visible one
      // into one 3-way max of x and the sequence's two ends per 8 steps)
      unsigned yk;
      asm("mad.lo.u32 %0, %1, %2, %3;"
          : "=r"(yk) : "r"(unsigned(s + u)), "r"(inc), "r"(b));
      a = step<F>(a, yk, z);
    }
  }
  out[i] = a;
}

template <int F>
int launch(const void* x, const void* y, void* out, int n, int depth,
           unsigned inc, unsigned z, int threads, cudaStream_t s) {
  const int grid = (n + threads - 1) / threads;
  chain_kernel<F><<<grid, threads, 0, s>>>(
      static_cast<const unsigned*>(x), static_cast<const unsigned*>(y),
      static_cast<unsigned*>(out), n, depth, inc, z);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// One chain launch over n elements with `threads` threads per block.
// Returns the cudaError_t of the launch (0 on success).
int probe_swar_chain(int form, const void* x, const void* y, void* out, int n,
                     int depth, int inc, int z, int threads, void* stream) {
  if (n <= 0) return 0;
  if (depth < 1 || (depth != 1 && depth % kUnroll) || threads < 1 ||
      threads > 1024)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned ui = unsigned(inc), uz = unsigned(z);
  switch (form) {
    case kNative: return launch<kNative>(x, y, out, n, depth, ui, uz, threads, s);
    case kSwar: return launch<kSwar>(x, y, out, n, depth, ui, uz, threads, s);
    case kVmaxs2: return launch<kVmaxs2>(x, y, out, n, depth, ui, uz, threads, s);
    case kAddmax16:
      return launch<kAddmax16>(x, y, out, n, depth, ui, uz, threads, s);
    case kAddmax32:
      return launch<kAddmax32>(x, y, out, n, depth, ui, uz, threads, s);
    default: return int(cudaErrorInvalidValue);
  }
}

const char* sw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
