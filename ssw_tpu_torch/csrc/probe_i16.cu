// probe_i16: one int16 (or s16x2 / s32 DPX) formulation per probe, on the
// card, so that each can be checked exactly and its SASS read.
//
// Replaces the JAX package's TPU probe tools/probe_i16.py (_run :32 over
// the @probe registry :37-143), which asks whether Mosaic compiles nine
// int16 vector formulations on an (8, 128) array.  Here every formulation
// compiles (nvcc has no such gap); the questions are the value and the
// instructions.  Where the forward kernels' int16 tier (sw_forward_i16.cu)
// computes a formula on packed halves, the probe does so too: maxi, subi,
// addi, where_max, select_ge and full_step (rows 2p and 2p+1 in the low
// and high halves, K = 4 lanes per thread, as the tier packs two reads).
// pad_slice and mixed_cast run one warp per 128-lane row with the tier's
// shuffle shift and column reduce; i32_cmp_max is scalar.  The DPX probes
// are the intrinsics the forward kernels use, one instruction each:
// __viaddmax_s16x2[_relu], __vmaxs2, __vsub2 (sw_forward_i16.cu) and
// __viaddmax_s32[_relu] (sw_dp.cuh).  One template instantiation per
// probe, so `cuobjdump -sass` shows each formulation's instructions.
//
// What bounds it: nothing of note; one launch over a few kB, so a launch's
// time is its latency.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libprobe_i16.so probe_i16.cu

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Probe {
  kMaxi, kSubi, kAddi, kWhereMax, kSelectGe, kPadSlice, kFullStep,
  kMixedCast, kI32CmpMax, kAddmax16, kAddmax16Relu, kVmaxs2, kVsub2,
  kAddmax32, kAddmax32Relu, kProbes
};

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowLanes = 128;  // lanes of a row probe (the JAX (8, 128))
constexpr int kK = kRowLanes / 32;
constexpr int kNeg16 = -16384;  // full_step's prefix-max fill

// x in both halves
__device__ __forceinline__ unsigned pk(int x) {
  return (unsigned(x) & 0xffffu) * 0x10001u;
}
__device__ __forceinline__ unsigned pack2(int lo, int hi) {
  return (unsigned(lo) & 0xffffu) | (unsigned(hi) << 16);
}

// Elementwise on packed pairs of adjacent int16 lanes (n words).
template <int P>
__global__ void packed_kernel(const unsigned* __restrict__ a,
                              const unsigned* __restrict__ b,
                              const unsigned* __restrict__ c,
                              unsigned* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned x = a[i];
  unsigned r;
  if constexpr (P == kMaxi) {
    r = __vmaxs2(x, pk(3));
  } else if constexpr (P == kSubi) {
    r = __vsub2(x, pk(1));
  } else if constexpr (P == kAddi) {
    r = __vadd2(x, pk(-1));
  } else if constexpr (P == kWhereMax || P == kVmaxs2) {
    r = __vmaxs2(x, b[i]);
  } else if constexpr (P == kSelectGe) {
    // the tier's half-mask select (its best-column snapshot)
    const unsigned y = b[i], m = __vcmpges2(x, y);
    r = (x & m) | (y & ~m);
  } else if constexpr (P == kAddmax16) {
    r = __viaddmax_s16x2(x, b[i], c[i]);
  } else if constexpr (P == kAddmax16Relu) {
    r = __viaddmax_s16x2_relu(x, b[i], c[i]);
  } else {
    static_assert(P == kVsub2, "packed probe");
    r = __vsub2(x, b[i]);
  }
  out[i] = r;
}

// Elementwise scalar: i32_cmp_max on int16, the s32 DPX forms on int32.
template <int P>
__global__ void scalar_kernel(const void* __restrict__ a,
                              const void* __restrict__ b,
                              const void* __restrict__ c,
                              void* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if constexpr (P == kI32CmpMax) {
    const int x = static_cast<const int16_t*>(a)[i];
    const int y = static_cast<const int16_t*>(b)[i];
    static_cast<int16_t*>(out)[i] = int16_t(x > y ? x : y);
  } else {
    const int x = static_cast<const int32_t*>(a)[i];
    const int y = static_cast<const int32_t*>(b)[i];
    const int z = static_cast<const int32_t*>(c)[i];
    static_cast<int32_t*>(out)[i] =
        P == kAddmax32 ? __viaddmax_s32(x, y, z)
                       : __viaddmax_s32_relu(x, y, z);
  }
}

// One warp per 128-lane row, thread t holding lanes 4t .. 4t+3.
template <int P>
__global__ void row_kernel(const int16_t* __restrict__ a,
                           int16_t* __restrict__ out, int rows) {
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int t = threadIdx.x & 31;
  if (row >= rows) return;
  const int16_t* x = a + size_t(row) * kRowLanes + t * kK;
  int16_t* o = out + size_t(row) * kRowLanes + t * kK;
  int v[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) v[k] = x[k];
  if constexpr (P == kPadSlice) {
    // shift one lane up the row, lane 0 = -3: the tier's carry shuffle
    int prev = __shfl_up_sync(kFull, v[kK - 1], 1);
    if (t == 0) prev = -3;
    o[0] = int16_t(prev);
#pragma unroll
    for (int k = 1; k < kK; ++k) o[k] = int16_t(v[k - 1]);
  } else {
    static_assert(P == kMixedCast, "row probe");
    // int32 row max (the tier's column reduce), added back in int16
    int m = v[0];
#pragma unroll
    for (int k = 1; k < kK; ++k) m = max(m, v[k]);
    m = __reduce_max_sync(kFull, m);
#pragma unroll
    for (int k = 0; k < kK; ++k) o[k] = int16_t(v[k] + int16_t(m));
  }
}

// full_step: one DP column step of rows 2p (low halves) and 2p+1 (high),
// one warp per pair, as sw_forward_i16.cu column_i16 steps a read pair:
//   hd = shift(H, 0); ht = max(hd + sub, E, 0); c = ht - 3;
//   F = shift(prefixmax(c), -16384); H2 = max(ht, F + 1);
//   E2 = max(E - 1, H2 - 3, 0); out = H2 + E2.
__global__ void full_step_kernel(const int16_t* __restrict__ p,
                                 const int16_t* __restrict__ h,
                                 const int16_t* __restrict__ e,
                                 int16_t* __restrict__ out, int rows) {
  const int pair = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int t = threadIdx.x & 31;
  if (2 * pair >= rows) return;
  const size_t lo = size_t(2 * pair) * kRowLanes + t * kK;
  const size_t hi = lo + kRowLanes;
  unsigned sub[kK], H[kK], E[kK], ht[kK], cm[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    sub[k] = pack2(p[lo + k], p[hi + k]);
    H[k] = pack2(h[lo + k], h[hi + k]);
    E[k] = pack2(e[lo + k], e[hi + k]);
  }
  unsigned carry = __shfl_up_sync(kFull, H[kK - 1], 1);
  if (t == 0) carry = 0u;
  unsigned tot = pk(kNeg16);
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    ht[k] = __viaddmax_s16x2_relu(k == 0 ? carry : H[k - 1], sub[k], E[k]);
    tot = __vmaxs2(tot, __vadd2(ht[k], pk(-3)));
    cm[k] = tot;  // in-thread inclusive prefix of c
  }
#pragma unroll
  for (int s = 1; s < 32; s <<= 1)
    tot = __vmaxs2(tot, __shfl_up_sync(kFull, tot, s));
  unsigned run = __shfl_up_sync(kFull, tot, 1);
  if (t == 0) run = pk(kNeg16);
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const unsigned F = k == 0 ? run : __vmaxs2(run, cm[k - 1]);
    const unsigned H2 = __viaddmax_s16x2(F, pk(1), ht[k]);
    const unsigned E2 = __viaddmax_s16x2_relu(H2, pk(-3),
                                              __vsub2(E[k], pk(1)));
    const unsigned r = __vadd2(H2, E2);
    out[lo + k] = int16_t(r & 0xffffu);
    out[hi + k] = int16_t(r >> 16);
  }
}

template <int P>
int launch_packed(const void* a, const void* b, const void* c, void* out,
                  int n, cudaStream_t s) {
  packed_kernel<P><<<(n + 255) / 256, 256, 0, s>>>(
      static_cast<const unsigned*>(a), static_cast<const unsigned*>(b),
      static_cast<const unsigned*>(c), static_cast<unsigned*>(out), n);
  return int(cudaGetLastError());
}

template <int P>
int launch_scalar(const void* a, const void* b, const void* c, void* out,
                  int n, cudaStream_t s) {
  scalar_kernel<P><<<(n + 255) / 256, 256, 0, s>>>(a, b, c, out, n);
  return int(cudaGetLastError());
}

template <int P>
int launch_row(const void* a, void* out, int rows, cudaStream_t s) {
  row_kernel<P><<<(rows + 3) / 4, 128, 0, s>>>(
      static_cast<const int16_t*>(a), static_cast<int16_t*>(out), rows);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// Probe `probe` over (rows, cols) int16 arrays a, b, c -> out (int32 for
// the s32 DPX probes); b, c are read only by probes that take them.  The
// row probes (pad_slice, full_step, mixed_cast) take cols = 128, full_step
// an even rows.  Returns the cudaError_t of the launch (0 on success).
int probe_i16_run(int probe, const void* a, const void* b, const void* c,
                  void* out, int rows, int cols, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  const bool row = probe == kPadSlice || probe == kFullStep ||
                   probe == kMixedCast;
  if ((row && cols != kRowLanes) || (probe == kFullStep && rows % 2) ||
      cols % 2)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = rows * cols, w = n / 2;
  switch (probe) {
    case kMaxi: return launch_packed<kMaxi>(a, b, c, out, w, s);
    case kSubi: return launch_packed<kSubi>(a, b, c, out, w, s);
    case kAddi: return launch_packed<kAddi>(a, b, c, out, w, s);
    case kWhereMax: return launch_packed<kWhereMax>(a, b, c, out, w, s);
    case kSelectGe: return launch_packed<kSelectGe>(a, b, c, out, w, s);
    case kPadSlice: return launch_row<kPadSlice>(a, out, rows, s);
    case kFullStep:
      full_step_kernel<<<(rows / 2 + 3) / 4, 128, 0, s>>>(
          static_cast<const int16_t*>(a), static_cast<const int16_t*>(b),
          static_cast<const int16_t*>(c), static_cast<int16_t*>(out),
          rows);
      return int(cudaGetLastError());
    case kMixedCast: return launch_row<kMixedCast>(a, out, rows, s);
    case kI32CmpMax: return launch_scalar<kI32CmpMax>(a, b, c, out, n, s);
    case kAddmax16: return launch_packed<kAddmax16>(a, b, c, out, w, s);
    case kAddmax16Relu:
      return launch_packed<kAddmax16Relu>(a, b, c, out, w, s);
    case kVmaxs2: return launch_packed<kVmaxs2>(a, b, c, out, w, s);
    case kVsub2: return launch_packed<kVsub2>(a, b, c, out, w, s);
    case kAddmax32: return launch_scalar<kAddmax32>(a, b, c, out, n, s);
    case kAddmax32Relu:
      return launch_scalar<kAddmax32Relu>(a, b, c, out, n, s);
    default: return int(cudaErrorInvalidValue);
  }
}

const char* sw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
