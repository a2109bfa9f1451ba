// sw_lab: the int32 forward kernel's base mode (quirk off) with one part
// removed or changed per variant, to split the time of its column chain.
//
// Replaces the JAX package's TPU variant lab tools/kernel_lab.py
// (make_kernel :73, pallas_call in run :463).  The body is a copy of
// sw_forward.cu forward_body and sw_dp.cuh dp_column (base mode, quirk
// off, register rows); the production kernels are not touched, and
// variant `full` is that body unchanged.  One template instantiation per
// (variant, K), each switch a constexpr:
//   full       the production base-mode body
//   nostore    no per-32-column maxcol store
//   notrack    no column max, reduce, best-hit branch or save_best; the
//              final H and E rows are the output
//   nodp       H += sub in place of the recurrence; trackers kept
//   noprofile  sub = profile row 0 held in registers: no per-column
//              shared-memory profile load (the target codes go unused)
//   skeleton   the column loop, the code shuffle and a store only
//   noclamp    max(h + sub, E) for max(h + sub, E, 0) on h~ (E >= 0)
//   radix4     the 5-step shuffle scan as 3 radix-4 steps (offsets 1 2 3,
//              4 8 12, 16: 7 shuffles, 3 dependent levels)
//   lanetrack  per-lane trackers and no per-column __reduce_max_sync: one
//              running max of (H << 8) + (255 - column in block) per lane,
//              merged into a per-lane (value, first column) once per 256
//              columns, which also gives the block maxima (the blockmax
//              mode's outputs; columns < R all count)
//   gatescan   the production Gate path (sw_dp.cuh gate_depth, scan_depth,
//              gate_flush) with the thresholds given
//   shortscan  the warp scan cut to m of its 5 steps (m = 0..4; inexact:
//              the truncated model scan_sw._truncated_prefix)
//
// What bounds it: as sw_forward.cu (integer ALU work and the latency of the
// column chain); each variant moves a part of that chain.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libsw_lab.so sw_lab.cu

#include "sw_dp.cuh"

namespace {

enum Variant {
  kFull, kNostore, kNotrack, kNodp, kNoprofile, kSkeleton, kNoclamp,
  kRadix4, kLanetrack, kGatescan, kShort0, kShort1, kShort2, kShort3,
  kShort4, kVariants
};

struct LabArgs {
  const int8_t* prof;       // (B, n1, L)
  const int32_t* ref;       // (R,)
  const int32_t* read_len;  // (B,)
  const uint8_t* col_mask;  // (B, L) bool
  int B, n1, L, R, gapO, gapE;
  int32_t* score;           // (B,)
  int32_t* end_ref;         // (B,)
  int32_t* end_read;        // (B,)
  int16_t* maxcol;          // (B, R): variants that store column maxima
  int32_t* blockmax;        // (B, ceil(R/256)): lanetrack
  int32_t* rows;            // (B, 2, L): notrack's final H and E
};

// The 5-step inclusive max-scan as radix-4 steps.  A lane below a shuffle's
// offset reads its own value, and max is idempotent, so no predicate.
__device__ __forceinline__ int scan_radix4(int x) {
#pragma unroll
  for (int s = 1; s < 16; s <<= 2) {
    const int y1 = __shfl_up_sync(sw::kFull, x, s);
    const int y2 = __shfl_up_sync(sw::kFull, x, 2 * s);
    const int y3 = __shfl_up_sync(sw::kFull, x, 3 * s);
    x = __vimax3_s32(x, y1, max(y2, y3));
  }
  return max(x, __shfl_up_sync(sw::kFull, x, 16));
}

// sw::dp_column with the quirk off, per variant; returns the masked column
// max (0 for notrack and lanetrack, which reduce nothing per column).
template <int V, int KT>
__device__ __forceinline__ int lab_column(sw::RegRow<KT>& r, int t, int code,
                                          int gapO, int gapE, int depth,
                                          const int* s0) {
  constexpr bool kReduce = V != kNotrack && V != kLanetrack;
  const int base = t * KT;
  if constexpr (V == kNodp) {
    int cmax = 0;
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      const int H = r.H(k) + r.SUB(code, k);
      r.H(k) = H;
      if (r.CM(k)) cmax = max(cmax, H);
    }
    return __reduce_max_sync(sw::kFull, cmax);
  }
  int carry = __shfl_up_sync(sw::kFull, r.H(KT - 1), 1);
  if (t == 0) carry = 0;
  int tot = sw::kNeg;
#pragma unroll
  for (int k = KT - 1; k >= 0; --k) {
    const int hprev = k == 0 ? carry : r.H(k - 1);
    const int sub = V == kNoprofile ? s0[k] : r.SUB(code, k);
    const int ht = V == kNoclamp ? sw::addmax(hprev, sub, r.E(k))
                                 : sw::addmax0(hprev, sub, r.E(k));
    r.H(k) = ht;
    const int cc = (base + k) * gapE - gapO;  // c = ht + cc
    tot = sw::addmax(ht, cc, tot);
  }
  if constexpr (V == kRadix4)
    tot = scan_radix4(tot);
  else if constexpr (V >= kShort0)
    tot = sw::scan_steps<V - kShort0>(tot, t, sw::MaxI32{});
  else
    tot = sw::scan_depth(tot, t, depth, sw::MaxI32{});
  int run = __shfl_up_sync(sw::kFull, tot, 1);
  if (t == 0) run = sw::kNeg;
  int cmax = 0;
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    const int ht = r.H(k);
    const int d = (base + k) * gapE;
    const int gmd = gapE - d;
    const int H = sw::addmax0(run, gmd, ht);
    run = sw::addmax(ht, d - gapO, run);
    r.E(k) = sw::addmax0(H, -gapO, r.E(k) - gapE);
    r.H(k) = H;
    if (kReduce && r.CM(k)) cmax = max(cmax, H);
  }
  return kReduce ? __reduce_max_sync(sw::kFull, cmax) : 0;
}

template <int V, int KT>
__global__ void sw_lab_kernel(const LabArgs a, const sw::GateArgs g) {
  constexpr bool kGate = V == kGatescan;
  constexpr bool kTrack = V != kNotrack && V != kSkeleton &&
                          V != kLanetrack;
  constexpr bool kStore = kTrack && V != kNostore;
  extern __shared__ __align__(16) unsigned char smem[];
  const int wpb = blockDim.x >> 5, w = threadIdx.x >> 5, t = threadIdx.x & 31;
  const int b = blockIdx.x * wpb + w;
  if (b >= a.B) return;  // whole warps only; no block barriers below
  const int L = a.L;
  const size_t row = size_t(b) * L;
  sw::RegRow<KT> r;
  r.attach(smem + w * sw::warp_smem_bytes(a.n1, L, false), nullptr,
           a.prof + row * a.n1, a.n1, L, t, false);
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    r.H(k) = r.E(k) = r.HB(k) = 0;
    r.set_lane(k, a.col_mask[row + t * KT + k] != 0, false, 0, 0, false);
  }
  int s0[KT];  // noprofile: profile row 0 of this thread's lanes
  int enc[KT], gv[KT], gc[KT];  // lanetrack: block tracker, best, column
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    if constexpr (V == kNoprofile) s0[k] = r.SUB(0, k);
    enc[k] = gv[k] = 0;
    gc[k] = -1;
  }
  int gmax = 0, end_ref = -1, code_v = 0;
  int16_t mc_v = 0;
  int hm = 0;          // gate: the previous column's masked max
  unsigned steps = 0;  // gate: this warp's columns at depth t
  const int lane_thr = kGate ? sw::gate_lane_thr(g, t) : 0;
  const int nblk = (a.R + sw::kBlockCols - 1) / sw::kBlockCols;
  int16_t* mc_row = a.maxcol ? a.maxcol + size_t(b) * a.R : nullptr;
  for (int col = 0; col < a.R; ++col) {
    const int lane = col & 31;
    if (lane == 0) {
      const int cc = col + t;
      code_v = cc < a.R ? a.ref[cc] : 0;
    }
    const int code = __shfl_sync(sw::kFull, code_v, lane);
    if constexpr (V == kSkeleton) {
      if (t == lane) mc_v = int16_t(code);
      if (lane == 31 || col == a.R - 1) {
        const int cc = (col & ~31) + t;
        if (cc <= col) mc_row[cc] = mc_v;
      }
      continue;
    }
    const int depth = kGate ? sw::gate_depth(hm, lane_thr) : sw::kDepths;
    const int colmax = lab_column<V, KT>(r, t, code, a.gapO, a.gapE, depth,
                                         s0);
    if constexpr (kGate) {
      hm = colmax;
      steps += depth == t;
    }
    if constexpr (V == kLanetrack) {
      const int jc = sw::kBlockCols - 1 - (col & (sw::kBlockCols - 1));
#pragma unroll
      for (int k = 0; k < KT; ++k)
        enc[k] = sw::addmax(r.H(k) << 8, jc, enc[k]);
      if (jc == 0 || col == a.R - 1) {
        const int blk = col / sw::kBlockCols;
        int bm = 0;
#pragma unroll
        for (int k = 0; k < KT; ++k) {
          const int v = enc[k] >> 8;
          if (v > gv[k]) {  // strict: an earlier block keeps a tie
            gv[k] = v;
            gc[k] = blk * sw::kBlockCols + (sw::kBlockCols - 1)
                    - (enc[k] & (sw::kBlockCols - 1));
          }
          if (r.CM(k)) bm = max(bm, v);
          enc[k] = 0;
        }
        bm = __reduce_max_sync(sw::kFull, bm);
        if (t == 0) a.blockmax[size_t(b) * nblk + blk] = bm;
      }
    } else if constexpr (kTrack) {
      if (colmax > gmax) {  // warp-uniform
        gmax = colmax;
        end_ref = col;
        sw::save_best<KT>(r, KT);
      }
    }
    if constexpr (kStore) {
      if (t == lane) mc_v = int16_t(min(colmax, 32767));
      if (lane == 31 || col == a.R - 1) {
        const int cc = (col & ~31) + t;
        if (cc <= col) mc_row[cc] = mc_v;
      }
    }
  }
  if constexpr (kGate) sw::gate_flush(g, t, steps);
  if constexpr (V == kNotrack) {
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      a.rows[(size_t(b) * 2) * L + t * KT + k] = r.H(k);
      a.rows[(size_t(b) * 2 + 1) * L + t * KT + k] = r.E(k);
    }
  } else if constexpr (V == kLanetrack) {
    // best over the masked lanes, its first column, and the lowest lane
    // p < read_len holding it at that column (every such lane is masked)
    int best = 0;
#pragma unroll
    for (int k = 0; k < KT; ++k)
      if (r.CM(k)) best = max(best, gv[k]);
    best = __reduce_max_sync(sw::kFull, best);
    int col = INT_MAX;
#pragma unroll
    for (int k = 0; k < KT; ++k)
      if (r.CM(k) && gv[k] == best) col = min(col, gc[k]);
    col = best > 0 ? __reduce_min_sync(sw::kFull, col) : -1;
    const int rl = a.read_len[b];
    int cand = L;
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      const int j = t * KT + k;
      if (best > 0 && j < rl && gv[k] == best && gc[k] == col)
        cand = min(cand, j);
    }
    cand = __reduce_min_sync(sw::kFull, cand);
    if (t == 0) {
      a.score[b] = best;
      a.end_ref[b] = col;
      a.end_read[b] = cand == L ? rl - 1 : cand;
    }
  } else if constexpr (kTrack) {
    const int rl = a.read_len[b];
    const int er = sw::end_read_of<KT>(r, KT, t, L, gmax, rl);
    if (t == 0) {
      a.score[b] = gmax;
      a.end_ref[b] = end_ref;
      a.end_read[b] = er;
    }
  }
}

template <int V, int KT>
int launch(const LabArgs& a, const sw::GateArgs& g, cudaStream_t stream) {
  int wpb;
  size_t smem;
  sw::launch_shape<KT>(a.n1, a.L, false, &wpb, &smem);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sw_lab_kernel<V, KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (e != cudaSuccess) return int(e);
  }
  const int grid = (a.B + wpb - 1) / wpb;
  sw_lab_kernel<V, KT><<<grid, wpb * 32, smem, stream>>>(a, g);
  return int(cudaGetLastError());
}

template <int KT>
int launch_k(int v, const LabArgs& a, const sw::GateArgs& g,
             cudaStream_t s) {
  switch (v) {
    case kFull: return launch<kFull, KT>(a, g, s);
    case kNostore: return launch<kNostore, KT>(a, g, s);
    case kNotrack: return launch<kNotrack, KT>(a, g, s);
    case kNodp: return launch<kNodp, KT>(a, g, s);
    case kNoprofile: return launch<kNoprofile, KT>(a, g, s);
    case kSkeleton: return launch<kSkeleton, KT>(a, g, s);
    case kNoclamp: return launch<kNoclamp, KT>(a, g, s);
    case kRadix4: return launch<kRadix4, KT>(a, g, s);
    case kLanetrack: return launch<kLanetrack, KT>(a, g, s);
    case kGatescan: return launch<kGatescan, KT>(a, g, s);
    case kShort0: return launch<kShort0, KT>(a, g, s);
    case kShort1: return launch<kShort1, KT>(a, g, s);
    case kShort2: return launch<kShort2, KT>(a, g, s);
    case kShort3: return launch<kShort3, KT>(a, g, s);
    case kShort4: return launch<kShort4, KT>(a, g, s);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// One launch of lab variant `variant` (the Variant order above) at K =
// L/32 in {2, 4, 8, 16}.  Outputs by variant: score/end_ref/end_read and
// maxcol (full, nodp, noprofile, noclamp, radix4, gatescan, shortscan),
// score/end_ref/end_read (nostore), score/end_ref/end_read and blockmax
// (lanetrack), rows (notrack), maxcol (skeleton: the target codes).
// gate_thr/gate_hist: gatescan's 5 host thresholds and device uint64[6]
// histogram.  Returns the cudaError_t of the launch (0 on success).
int sw_lab_run(int variant, const void* prof, const void* ref,
               const void* read_len, const void* col_mask, int B, int n1,
               int L, int R, int gapO, int gapE, void* score, void* end_ref,
               void* end_read, void* maxcol, void* blockmax, void* rows,
               const void* gate_thr, void* gate_hist, void* stream) {
  if (B <= 0 || R <= 0) return 0;
  if (variant == kGatescan && (!gate_thr || !gate_hist))
    return int(cudaErrorInvalidValue);
  LabArgs a;
  a.prof = static_cast<const int8_t*>(prof);
  a.ref = static_cast<const int32_t*>(ref);
  a.read_len = static_cast<const int32_t*>(read_len);
  a.col_mask = static_cast<const uint8_t*>(col_mask);
  a.B = B;
  a.n1 = n1;
  a.L = L;
  a.R = R;
  a.gapO = gapO;
  a.gapE = gapE;
  a.score = static_cast<int32_t*>(score);
  a.end_ref = static_cast<int32_t*>(end_ref);
  a.end_read = static_cast<int32_t*>(end_read);
  a.maxcol = static_cast<int16_t*>(maxcol);
  a.blockmax = static_cast<int32_t*>(blockmax);
  a.rows = static_cast<int32_t*>(rows);
  const sw::GateArgs g = sw::gate_args(gate_thr, gate_hist);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (L / 32 * (L % 32 == 0)) {
    case 2: return launch_k<2>(variant, a, g, s);
    case 4: return launch_k<4>(variant, a, g, s);
    case 8: return launch_k<8>(variant, a, g, s);
    case 16: return launch_k<16>(variant, a, g, s);
    default: return int(cudaErrorInvalidValue);
  }
}

const char* sw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
