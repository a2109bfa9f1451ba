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
// are 2 or 4 bytes per column per read.  The dependent chain of one column (two shuffles, a
// 5-step scan, one reduce) is ~20 shuffle latencies long, so throughput
// comes from many warps in flight: one warp per read, no block-wide
// barriers.  Hopper's DPX instructions fuse the max(a + b, c) and
// zero-clamped three-way maxima of the recurrence.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace sw {

constexpr int kNeg = -(1 << 28);     // scan_sw.NEG
constexpr int kSegBump = 1 << 21;    // scan_sw.SEG_BUMP
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxRegK = 32;         // largest K kept in registers
constexpr int kScratchPlanes = 7;    // GlobRow planes per read

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
// column max, identical on every lane.
template <int KT, class Row>
__device__ __forceinline__ int dp_column(Row& r, int K, int t, int code,
                                         int gapO, int gapE, bool quirk) {
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
  // warp inclusive scan of the lane totals, then exclusive per lane
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, tot, off);
    if (t >= off) tot = max(tot, y);
    if (quirk) {
      const int yq = __shfl_up_sync(kFull, totq, off);
      if (t >= off) totq = max(totq, yq);
    }
  }
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
