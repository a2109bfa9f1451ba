// The in-warp anti-diagonal wavefront: the forward DP step of the int16
// tier (sw_wave_i16.cu) and of the lane-packed kernel (sw_wave_packed.cu),
// redesigned for Hopper.  sw_dp.cuh's column step stays the body of the
// int32 kernel, the per-read kernel and every gated launch.
//
// Semantics are those of ops/scan_sw.py (the plain twins) and of
// sw_dp.cuh; what differs is the order of the work.  For target column c
// and row p of a read:
//   h~(p) = max(H(p-1, c-1) + prof[ref[c]](p), E(p), 0)
//   H(p)  = max(h~(p), F(p))
//   F(p+1) = max(F(p) - gapE, h~(p) - gapO),      F(0) = -inf
//   E(p)  <- max(H(p) - gapO, E(p) - gapE, 0)      (for column c+1)
// The row-sequential F is the twins' lazy-F prefix max
//   F(p) = max_{p'<p} h~(p') - gapO - (p-p'-1)*gapE
// unrolled one row at a time.  The quirk (packed kernel only) adds the
// lane-block segmented F_loc as a second row chain G, restarted at each
// block start: h_fp = h~ at a block start, else max(G, h~), G <- max(G -
// gapE, h~ - gapO) (-inf entering a block start), and E reads h_fp.  That
// equals the twins' biased prefix max (sw_dp.cuh sweep 2, the QBUMP bias)
// wherever the wrapper's span guard holds: a source in an earlier block
// carries a bias at least QBUMP below the slot's values, so it never wins.
//
// Layout.  One warp per read (the packed slot) or per read pair (the int16
// tier, s16x2 halves); lane t owns rows t*K .. t*K+K-1 as in sw_dp.cuh,
// but at step s it computes column c = s - t.  Between steps lane t-1
// hands lane t, by independent __shfl_up_syncs, the F leaving its last row
// of column c (lane t's next column), its last row's H of column c (lane
// t's diagonal a step later), the column's running masked maximum over the
// rows above, and with the quirk G, with dual the word channel's maximum.
// Lane 0 takes carry 0 and F = -inf.  Outside 0 <= c < R a lane reads the
// poison profile row (-128 in every row): a lane that has not started keeps
// H = E = 0 and hands on H = 0, so the boundary is that of the twins; a
// lane past the last column computes values nothing reads.  Lane 31 holds
// column c's complete maxima at step c + 31 and alone stores them (base
// mode: 8 columns buffered into one 16-byte store; blockmax: the block's
// running max once per 256 columns).  The best hit takes route (b) of the
// design: each lane keeps (max, first column, lowest read row) over its own
// rows and the warp merges them once, after the loop (max, then lowest
// column, then lowest row); the lane's row search runs only when its own
// maximum rises.  So the step loop has no warp scan, no reduce and no
// warp-uniform branch per column, and no best-column snapshot.
//
// Target codes reach the lanes through a per-warp 64-entry ring in shared
// memory: every 32 steps lane l writes the code of column s+1+l (bit 16: the
// column may take a new best hit), and each lane prefetches its next
// column's entry one step ahead.  No block barrier anywhere: a warp whose
// read lies past B returns at once.  The profile stays [code][k][lane],
// now 32-bit entries (lanes read different codes, so 8-bit entries would
// conflict in the banks), with the poison row after the n1 codes;
// past K = 32 the state lives in a global scratch row [plane][k][lane] and
// the profile in global memory.
//
// What bounds it on Hopper: the integer issue rate.  The loop-carried chain
// of a step is one shuffle and K dependent DPX instructions (VIADDMNMX:
// max(a + b, c) in one instruction); every other instruction of the step is
// off that chain.  Per lane-row and step: h~, H, h~ - gapO, F, E - gapE, E
// and the masked maximum (7 instructions, the same 7 that
// ops/cuda_sw.OPS_PER_CELL counts; the dual word channel one more; the
// quirk G chain two more plus the block-start selects), plus per step a few
// shuffles, the ring read, the tracker compare and lane 31's maxima.  A
// step costs about 25 + 7.7*K cycles of latency; with more than one warp
// per scheduler the issue rate, not latency, sets the pace.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace wave {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNeg = -(1 << 28);      // scan_sw.NEG: F = -inf, int32
constexpr int kDead = -(1 << 30);     // masked-max offset of a dead row
constexpr int kPoison = -128;         // profile row of a column outside R
constexpr int kRing = 64;             // ring entries per warp
constexpr int kRingBytes = kRing * 4;
constexpr int kUnroll = 8;            // steps per loop trip (16-byte stores)
constexpr int kBlockCols = 256;       // columns per block maximum (scan_sw.BM)
constexpr int kTake = 1 << 16;        // ring entry bit: may take a best hit

// int32 lanes: one read per register
struct I32 {
  using T = int;
  static __device__ __forceinline__ T splat(int x) { return x; }
  static __device__ __forceinline__ T add(T a, T b) { return a + b; }
  static __device__ __forceinline__ T max(T a, T b) { return a > b ? a : b; }
  // max(a + b, c)
  static __device__ __forceinline__ T addmax(T a, T b, T c) {
    return __viaddmax_s32(a, b, c);
  }
  // max(a + b, c, 0)
  static __device__ __forceinline__ T addmax0(T a, T b, T c) {
    return __viaddmax_s32_relu(a, b, c);
  }
};

// s16x2 lanes: read 2p in the low and read 2p+1 in the high half; every
// value stays inside int16 under the wrapper's i16_exact bound, so the
// packed adds (which wrap) never wrap
struct S16x2 {
  using T = unsigned;
  static __device__ __forceinline__ T splat(int x) {
    return (unsigned(x) & 0xffffu) * 0x10001u;
  }
  // a + b as one add-max against -32768 (one VIADDMNMX.S16 where __vadd2
  // is an emulation of three instructions)
  static __device__ __forceinline__ T add(T a, T b) {
    return __viaddmax_s16x2(a, b, 0x80008000u);
  }
  static __device__ __forceinline__ T max(T a, T b) { return __vmaxs2(a, b); }
  static __device__ __forceinline__ T addmax(T a, T b, T c) {
    return __viaddmax_s16x2(a, b, c);
  }
  static __device__ __forceinline__ T addmax0(T a, T b, T c) {
    return __viaddmax_s16x2_relu(a, b, c);
  }
};

// Per-step constants of a launch, splatted once.
template <class Op>
struct Pen {
  typename Op::T nO, nE, neg;  // -gapO, -gapE, the F/G fill (-inf)
};

// One step of one lane: column `code` over its K rows, top to bottom.
// hd: H of the row above its first row at the previous column; F (and G):
// the chains entering its first row, leaving its last; mo (mw): the masked
// maximum of its rows (over the word rows), both start at 0.
template <class Op, int KT, bool Quirk, bool Dual, class Row>
__device__ __forceinline__ void wave_rows(Row& r, int K, int code,
                                          typename Op::T hd,
                                          typename Op::T& F,
                                          typename Op::T& G,
                                          typename Op::T& mo,
                                          typename Op::T& mw,
                                          const Pen<Op>& p) {
  using T = typename Op::T;
  const int KK = KT > 0 ? KT : K;  // a compile-time constant when KT > 0
  T hdk = hd;
#pragma unroll
  for (int k = 0; k < KK; ++k) {
    const T e = r.E(k);
    const T hold = r.H(k);
    const T ht = Op::addmax0(hdk, r.SUB(code, k), e);
    hdk = hold;
    const T H = Op::max(ht, F);
    const T hg = Op::add(ht, p.nO);
    F = Op::addmax(F, p.nE, hg);  // the only loop-carried instruction
    T hfp = H;
    if constexpr (Quirk) {
      const bool rs = r.RST(k);
      hfp = rs ? ht : Op::max(G, ht);
      G = Op::addmax(rs ? p.neg : G, p.nE, hg);
    }
    r.E(k) = Op::addmax0(hfp, p.nO, Op::add(e, p.nE));
    r.H(k) = H;
    mo = Op::addmax(H, r.OFF(k), mo);  // dead rows sit below 0
    if constexpr (Dual) mw = Op::addmax(H, r.WOFF(k), mw);
  }
}

// The warp's merge of the lanes' trackers (value v, first column vc,
// lowest read row jr, L when none): score, end column (-1 when the score
// is 0) and end_read (rl - 1 when no read row holds the score at the end
// column), as scan_sw._finalize reads them.
struct Best {
  int score, col, row;
};

__device__ __forceinline__ Best merge_best(int v, int vc, int jr, int L,
                                           int rl) {
  const int g = __reduce_max_sync(kFull, v);
  const int c = __reduce_min_sync(kFull, v == g ? vc : 0x7fffffff);
  const int j = __reduce_min_sync(kFull, v == g && vc == c ? jr : L);
  Best b;
  b.score = g;
  b.col = g > 0 ? c : -1;
  b.row = g > 0 && j < L ? j : rl - 1;
  return b;
}

__host__ __device__ __forceinline__ size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// Shared memory of one warp: the 32-bit profile of n1 codes plus the
// poison row over L rows (register variants only), then the ring.
__host__ __device__ __forceinline__ size_t warp_bytes(int n1, int L,
                                                      bool reg) {
  return (reg ? align16(size_t(n1 + 1) * L * 4) : 0) + kRingBytes;
}

// Warps per block (4, fewer where the profiles would pass 48 KB) and the
// block's dynamic shared memory.
__host__ inline void launch_shape(size_t per_warp, int* wpb, size_t* smem) {
  int w = 4;
  while (w > 1 && w * per_warp > 48 * 1024) w >>= 1;
  *wpb = w;
  *smem = w * per_warp;
}

}  // namespace wave
