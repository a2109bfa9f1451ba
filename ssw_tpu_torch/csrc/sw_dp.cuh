// One warp = one read: the column step of the batched striped-SW DP, shared
// by sw_forward.cu (one target for the whole batch) and sw_perread.cu (a
// window of its own for every read).
//
// Semantics are those of ops/scan_sw.py (the plain PyTorch twin) and of the
// JAX package's ops/scan_sw.py: for every target column j
//   h~ = max(shift(H) + prof[ref[j]], E, 0)
//   c  = h~ + lane*gapE - gapO
//   F  = shift(prefixmax(c)) + gapE - lane*gapE           (lazy F, exact)
//   H  = max(h~, F, 0)
//   quirk: F_loc from a prefix max of c + seg_id*SEG_BUMP (segmented by
//          SIMD lane block), reset at block starts; h_fp = max(h~, F_loc)
//   E  = max(E - gapE, h_fp - gapO, 0)              (h_fp = H without quirk)
//   colmax = max over col_mask lanes of H (>= 0)
//
// Layout.  Lane t of the warp holds the K = L/32 consecutive read positions
// t*K .. t*K+K-1.  shift() is one __shfl_up_sync of the neighbour's last
// element; the prefix max is a thread-local sweep, a 5-step warp scan of the
// thread totals and a second sweep that combines; the column max is one
// __reduce_max_sync.  The read's profile (n+1 rows x L int8) lives in shared
// memory, transposed to [code][k][lane] so a warp's 32 loads of one k are
// 32 consecutive bytes.  For K <= 32 (L <= 1024, every bucket the pipeline
// makes for reads up to 1 kbp) H, E and the best-column snapshot h_best live
// in registers (RegRow, templated on K).  Longer reads run GlobRow: the same
// code with the per-lane state in a global scratch row laid out
// [plane][k][lane] (coalesced, L1/L2-resident), and the profile read from
// global memory.
//
// What bounds it on Hopper: integer ALU work and latency, not bytes.  Per
// lane-cell and column the recurrence is 7 int32 operations, 11 with the
// quirk (OPS_PER_CELL in ops/cuda_sw.py counts them); the maxima it writes
// are at most 4 bytes per column per read (4 per 256 columns in the forward
// kernels' blockmax mode).  The dependent chain of one column is the carry
// shuffle, sweep 1's K-step max chain of the lane totals, the 5-step shuffle
// scan (a shuffle and a max each), the `run` shuffle, sweep 2's K-step
// chain of the running prefix and the column reduce: 7 shuffles, one reduce
// and about 2K + 5 dependent ALU operations; the forward kernels' best-hit
// branch waits on the reduce before the next column starts.  Throughput
// comes from many warps in flight: one warp per read, no block-wide
// barriers.  Hopper's DPX instructions fuse the max(a + b, c) and
// zero-clamped three-way maxima of the recurrence.
//
// The bounded-radius gate (ops/gate.py; the TPU kernel's, pallas_sw.py
// :314-359, exactness argument :323-330) drops scan steps: a column run at
// depth m < 5 makes only the first m steps of the shuffle scan.
//   * Lazy F.  Lane p gets from lane p' < p the candidate
//     h~(p') - gapO - (p - p' - 1)*gapE.
//   * What depth m covers.  m steps, the `run` shuffle and the in-thread
//     sweeps reach every source with p - p' <= 2^m*K, so a dropped source
//     offers at most max h~ - gapO - 2^m*K*gapE: inert (<= 0, and H =
//     max(h~, F, 0)) whenever max h~ <= gapO + 2^m*K*gapE.
//   * Bounding h~ from the previous column.  Lane by lane E(j) <= H(j-1),
//     so h~(j, p) <= max(H(j-1, p-1) + max_sub, H(j-1, p)); and colmax(j)
//     <= max h~(j) as F <= max h~ - gapO.  Hence max h~(j) <= colmax(j-g) +
//     g*max_sub over the col_mask lanes, with lag g = 1 here: the column
//     max the warp already reduced.  Depth m is taken when colmax(j-1) <=
//     thr[m] = gapO + 2^m*K*gapE - max_sub (or the JAX plan's stricter
//     threshold), depth = #{m : hm > thr[m]} with thr non-decreasing.
//   * Pad lanes.  col_mask is a prefix of the row (of the slot when
//     packed) and carries move only rightward, so a valid lane's sources
//     are valid lanes; a pad lane's inexact F reaches only pad lanes.
//   * The quirk's segmented scan (totq) is never gated: the TPU gates only
//     the plain prefix max (pallas_sw.py:258 against :268).
// The two reads of an int16 warp share one scan, so their depth comes from
// the larger of their two column maxima.

#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace sw {

constexpr int kNeg = -(1 << 28);     // scan_sw.NEG
constexpr int kSegBump = 1 << 21;    // scan_sw.SEG_BUMP
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxRegK = 32;         // largest K kept in registers
constexpr int kScratchPlanes = 7;    // GlobRow planes per read
constexpr int kBlockCols = 256;      // columns per block maximum (scan_sw.BM)
constexpr int kDepths = 5;           // shuffle steps of the whole warp scan

// max(a + b, c, 0)
__device__ __forceinline__ int addmax0(int a, int b, int c) {
  return __viaddmax_s32_relu(a, b, c);
}
// max(a + b, c)
__device__ __forceinline__ int addmax(int a, int b, int c) {
  return __viaddmax_s32(a, b, c);
}

__host__ __device__ __forceinline__ size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// Shared memory one warp of a RegRow kernel uses: the transposed profile,
// plus the lane-block bias planes on the quirk path.
__host__ __device__ __forceinline__ size_t warp_smem_bytes(int n1, int L,
                                                           bool quirk) {
  return align16(size_t(n1) * L) + (quirk ? size_t(8) * L : 0);
}

// Per-lane state in registers (K known at compile time).
template <int KT>
struct RegRow {
  int h[KT], e[KT], hb[KT];
  unsigned cm, rst;      // bit k: col_mask / seg_reset of position t*K+k
  const int8_t* prof;    // shared [code][k][32], offset by lane
  int* sb;               // shared [k][32] lane-block bias (quirk only)
  int* sbp;              // shared [k][32] bias of the previous position
  int L;

  __device__ __forceinline__ void attach(unsigned char* wsm, int*,
                                         const int8_t* gprof, int n1,
                                         int L_, int t, bool quirk) {
    L = L_;
    cm = rst = 0u;
    int8_t* sp = reinterpret_cast<int8_t*>(wsm);
    for (int i = t; i < n1 * L; i += 32) {
      const int code = i / L, j = i - code * L;
      const int tt = j / KT, k = j - tt * KT;
      sp[code * L + k * 32 + tt] = gprof[i];
    }
    prof = sp + t;
    if (quirk) {
      int* s = reinterpret_cast<int*>(wsm + align16(size_t(n1) * L));
      sb = s + t;
      sbp = s + L + t;
    }
    __syncwarp();
  }
  __device__ __forceinline__ int& H(int k) { return h[k]; }
  __device__ __forceinline__ int& E(int k) { return e[k]; }
  __device__ __forceinline__ int& HB(int k) { return hb[k]; }
  __device__ __forceinline__ bool CM(int k) const { return (cm >> k) & 1u; }
  __device__ __forceinline__ bool RST(int k) const { return (rst >> k) & 1u; }
  __device__ __forceinline__ int SB(int k) const { return sb[k * 32]; }
  __device__ __forceinline__ int SBP(int k) const { return sbp[k * 32]; }
  __device__ __forceinline__ int SUB(int code, int k) const {
    return prof[code * L + k * 32];
  }
  __device__ __forceinline__ void set_lane(int k, bool c, bool r, int b,
                                           int bp, bool quirk) {
    cm |= unsigned(c) << k;
    rst |= unsigned(r) << k;
    if (quirk) {
      sb[k * 32] = b;
      sbp[k * 32] = bp;
    }
  }
};

// Per-lane state in a global scratch row (any K).
struct GlobRow {
  int* s;                // scratch row + lane: planes [7][K][32]
  const int8_t* prof;    // global (n1, L) profile row of the read
  int K, L, t;

  __device__ __forceinline__ void attach(unsigned char*, int* scratch_row,
                                         const int8_t* gprof, int, int L_,
                                         int t_, bool) {
    L = L_;
    K = L_ / 32;
    t = t_;
    s = scratch_row + t_;
    prof = gprof;
  }
  __device__ __forceinline__ int& P(int plane, int k) const {
    return s[(plane * K + k) * 32];
  }
  __device__ __forceinline__ int& H(int k) { return P(0, k); }
  __device__ __forceinline__ int& E(int k) { return P(1, k); }
  __device__ __forceinline__ int& HB(int k) { return P(2, k); }
  __device__ __forceinline__ bool CM(int k) const { return P(3, k) != 0; }
  __device__ __forceinline__ bool RST(int k) const { return P(4, k) != 0; }
  __device__ __forceinline__ int SB(int k) const { return P(5, k); }
  __device__ __forceinline__ int SBP(int k) const { return P(6, k); }
  __device__ __forceinline__ int SUB(int code, int k) const {
    return prof[code * L + t * K + k];
  }
  __device__ __forceinline__ void set_lane(int k, bool c, bool r, int b,
                                           int bp, bool) {
    P(3, k) = c;
    P(4, k) = r;
    P(5, k) = b;
    P(6, k) = bp;
  }
};

// The bounded-radius gate of one launch: non-decreasing thresholds
// (ops/gate.py) and the device histogram of warp-column steps by depth.
struct GateArgs {
  int thr[kDepths];
  unsigned long long* hist;  // [kDepths + 1]
};

// The owned-column mode of the forward kernels (the sequence-parallel
// shards, parallel/dist.py): per target column its global index and
// whether this shard owns it.  A third kernel parameter of the owned
// instantiations only, so that no other kernel's parameters change.
struct ColArgs {
  const int32_t* idx;  // (R,) global column index
  const uint8_t* own;  // (R,) bool: the column may take a new best hit
};

// Thread t < kDepths holds thr[t], the others INT_MAX (read once).
__device__ __forceinline__ int gate_lane_thr(const GateArgs& g, int t) {
  int v = INT_MAX;
#pragma unroll
  for (int m = 0; m < kDepths; ++m)
    if (t == m) v = g.thr[m];
  return v;
}

// Scan depth #{m : hm > thr[m]} of a column whose previous column's masked
// max is hm (warp-uniform): one compare per lane and a ballot.
__device__ __forceinline__ int gate_depth(int hm, int lane_thr) {
  return __popc(__ballot_sync(kFull, hm > lane_thr));
}

struct MaxI32 {
  __device__ __forceinline__ int operator()(int a, int b) const {
    return max(a, b);
  }
};

// N steps (offsets 1, 2, .., 2^(N-1)) of the warp's inclusive max-scan.
template <int N, class T, class Max>
__device__ __forceinline__ T scan_steps(T x, int t, Max mx) {
#pragma unroll
  for (int s = 0; s < N; ++s) {
    const T y = __shfl_up_sync(kFull, x, 1 << s);
    if (t >= (1 << s)) x = mx(x, y);
  }
  return x;
}

// The first `depth` steps (warp-uniform): one switch per column over
// unrolled scans; a compile-time kDepths folds to the whole scan.
template <class T, class Max>
__device__ __forceinline__ T scan_depth(T x, int t, int depth, Max mx) {
  switch (depth) {
    case 0: return x;
    case 1: return scan_steps<1>(x, t, mx);
    case 2: return scan_steps<2>(x, t, mx);
    case 3: return scan_steps<3>(x, t, mx);
    case 4: return scan_steps<4>(x, t, mx);
    default: return scan_steps<kDepths>(x, t, mx);
  }
}

// Host side: a launch's gate from its host thresholds (null: no gate) and
// device histogram.  The kernels take it as a second parameter beside
// their argument struct, whose layout stays that of the ungated kernels.
__host__ inline GateArgs gate_args(const void* thr, void* hist) {
  GateArgs g;
  g.hist = static_cast<unsigned long long*>(hist);
  for (int m = 0; m < kDepths; ++m)
    g.thr[m] = thr ? static_cast<const int*>(thr)[m] : 0;
  return g;
}

// Thread t <= kDepths counts the warp's columns run at depth t (`steps +=
// depth == t` per column) and adds its count once, at the end.
__device__ __forceinline__ void gate_flush(const GateArgs& g, int t,
                                           unsigned steps) {
  if (t <= kDepths && steps) atomicAdd(g.hist + t, (unsigned long long)steps);
}

template <int KT> struct RowSel { using type = RegRow<KT>; };
template <> struct RowSel<0> { using type = GlobRow; };

// Zero state and per-lane geometry of read b (pointers at its row).
template <int KT, class Row>
__device__ __forceinline__ void row_setup(Row& r, int K, int t,
                                          const uint8_t* col_mask,
                                          const int8_t* seg_id,
                                          const uint8_t* seg_start,
                                          bool quirk) {
  const int KK = KT > 0 ? KT : K;  // a compile-time constant when KT > 0
#pragma unroll
  for (int k = 0; k < KK; ++k) {
    const int j = t * KK + k;
    r.H(k) = 0;
    r.E(k) = 0;
    r.HB(k) = 0;
    const int sid = seg_id[j];
    const int sidp = j > 0 ? int(seg_id[j - 1]) : -1;
    r.set_lane(k, col_mask[j] != 0, seg_start[j] != 0 || sidp != sid,
               sid * kSegBump, j > 0 ? sidp * kSegBump : 0, quirk);
  }
}

// One target column (profile row `code`) for one read; returns the masked
// column max, identical on every lane.  depth (warp-uniform): the gate's
// scan steps, kDepths = the whole row.
template <int KT, class Row>
__device__ __forceinline__ int dp_column(Row& r, int K, int t, int code,
                                         int gapO, int gapE, bool quirk,
                                         int depth = kDepths) {
  const int KK = KT > 0 ? KT : K;  // a compile-time constant when KT > 0
  const int base = t * KK;
  int carry = __shfl_up_sync(kFull, r.H(KK - 1), 1);
  if (t == 0) carry = 0;
  // sweep 1 (descending, in place): h~ and this lane's totals of c
  int tot = kNeg, totq = kNeg;
#pragma unroll
  for (int k = KK - 1; k >= 0; --k) {
    const int hprev = k == 0 ? carry : r.H(k - 1);
    const int ht = addmax0(hprev, r.SUB(code, k), r.E(k));
    r.H(k) = ht;
    const int cc = (base + k) * gapE - gapO;  // c = ht + cc
    tot = addmax(ht, cc, tot);
    if (quirk) totq = addmax(ht, cc + r.SB(k), totq);
  }
  // warp inclusive scan of the lane totals (its first `depth` steps), then
  // exclusive per lane; the quirk's segmented scan runs every step
  tot = scan_depth(tot, t, depth, MaxI32{});
  if (quirk) totq = scan_steps<kDepths>(totq, t, MaxI32{});
  int run = __shfl_up_sync(kFull, tot, 1);
  int runq = quirk ? __shfl_up_sync(kFull, totq, 1) : kNeg;
  if (t == 0) run = runq = kNeg;
  // sweep 2 (ascending): F, H, E and the masked column max
  int cmax = 0;
#pragma unroll
  for (int k = 0; k < KK; ++k) {
    const int ht = r.H(k);
    const int d = (base + k) * gapE;
    const int gmd = gapE - d;
    const int H = addmax0(run, gmd, ht);
    int hfp = H;
    if (quirk) {
      // h_fp = max(h~, F_loc) with F_loc = 0 at a block start, else
      // max(runq - SBP + gmd, 0); h~ >= 0 folds the clamp into one op
      hfp = r.RST(k) ? ht : addmax0(runq, gmd - r.SBP(k), ht);
      runq = addmax(ht, d - gapO + r.SB(k), runq);
    }
    run = addmax(ht, d - gapO, run);
    r.E(k) = addmax0(hfp, -gapO, r.E(k) - gapE);
    r.H(k) = H;
    if (r.CM(k)) cmax = max(cmax, H);
  }
  return __reduce_max_sync(kFull, cmax);
}

template <int KT, class Row>
__device__ __forceinline__ void save_best(Row& r, int K) {
  const int KK = KT > 0 ? KT : K;
#pragma unroll
  for (int k = 0; k < KK; ++k) r.HB(k) = r.H(k);
}

// end_read: the lowest position with h_best == gmax inside the read, else
// read_len - 1 (scan_sw._finalize).
template <int KT, class Row>
__device__ __forceinline__ int end_read_of(Row& r, int K, int t, int L,
                                           int gmax, int rl) {
  const int KK = KT > 0 ? KT : K;
  int cand = L;
#pragma unroll
  for (int k = 0; k < KK; ++k) {
    const int j = t * KK + k;
    if (gmax > 0 && j < rl && r.HB(k) == gmax) cand = min(cand, j);
  }
  cand = __reduce_min_sync(kFull, cand);
  return cand == L ? rl - 1 : cand;
}

// Launch geometry: warps per block and dynamic shared memory for K.
template <int KT>
__host__ inline void launch_shape(int n1, int L, bool quirk, int* wpb,
                                  size_t* smem) {
  const size_t per_warp = KT > 0 ? warp_smem_bytes(n1, L, quirk) : 0;
  int w = 4;
  while (w > 1 && w * per_warp > 48 * 1024) w >>= 1;
  *wpb = w;
  *smem = w * per_warp;
}

__host__ inline bool reg_k(int K) {
  switch (K) {
    case 2: case 4: case 6: case 8: case 10: case 12: case 14: case 16:
    case 20: case 24: case 28: case 32:
      return true;
    default:
      return false;
  }
}

}  // namespace sw

// Dispatch a launcher template on K = L/32: a register variant for the
// pipeline's buckets, GlobRow (KT = 0) for everything else.
#define SW_DISPATCH_K(K, FN, ...)                       \
  switch (K) {                                          \
    case 2: return FN<2>(__VA_ARGS__);                  \
    case 4: return FN<4>(__VA_ARGS__);                  \
    case 6: return FN<6>(__VA_ARGS__);                  \
    case 8: return FN<8>(__VA_ARGS__);                  \
    case 10: return FN<10>(__VA_ARGS__);                \
    case 12: return FN<12>(__VA_ARGS__);                \
    case 14: return FN<14>(__VA_ARGS__);                \
    case 16: return FN<16>(__VA_ARGS__);                \
    case 20: return FN<20>(__VA_ARGS__);                \
    case 24: return FN<24>(__VA_ARGS__);                \
    case 28: return FN<28>(__VA_ARGS__);                \
    case 32: return FN<32>(__VA_ARGS__);                \
    default: return FN<0>(__VA_ARGS__);                 \
  }
