// The int32 wavefront's per-read state and lane step (sw_wave.cuh),
// shared by the forward kernel sw_wave_i32.cu and the per-read kernel
// sw_wave_perread.cu: one warp per read, lane t owns rows t*K ..
// t*K+K-1 and computes column s - t at step s.
//
// Register variants for K = L/32 in sw::reg_k keep H, E, the masked-max
// offsets (0 or kDead) and the quirk's block starts in registers, and the
// read's profile in shared memory as 32-bit entries [code][k][lane] with
// the poison row after the n1 codes; other K (L > 1024 among them) keep
// the state in a global scratch row [plane][k][lane] and read the int8
// profile from global memory.
//
// The quirk's block starts are row 0, seg_start and every row whose
// seg_id differs from the row above; the G chain restarts there.  It
// equals the column scan's prefix max biased by seg_id * SEG_BUMP
// (sw_dp.cuh, SEG_BUMP = 2^21) when (1) the blocks are contiguous: seg_id
// does not decrease along the row and seg_start holds only where seg_id
// changes (common.batch_geometry's geometry, the only one the pipeline
// builds), and (2) L * max_sub <= SEG_BUMP: a source in an earlier block
// then enters the biased scan at most max h~ - gapO - SEG_BUMP <= 0 <= h~,
// so it never wins, and the restarted chain holds exactly the sources of
// the row's own block.  The wrapper (ops/cuda_sw.py, quirk_wave_exact)
// sends a launch outside (2), L > 16,512 at int8 scores, to the
// column-scan body.

#pragma once

#include "sw_dp.cuh"
#include "sw_wave.cuh"

namespace wave32 {

using Op = wave::I32;
constexpr int kPlanes = 5;  // global-row planes per read: H E OFF WOFF RST

// The read's state in registers (K known at compile time).
template <int KT, bool Dual>
struct RegRow {
  int h[KT], e[KT], off[KT], woff[Dual ? KT : 1];
  unsigned rst;     // bit k: row t*K+k starts a quirk lane block
  const int* prof;  // shared [code][k][32], offset by lane

  __device__ __forceinline__ void attach(unsigned char* wsm, int*,
                                         const int8_t* pr, int n1, int L,
                                         int t) {
    int* sp = reinterpret_cast<int*>(wsm);
    for (int i = t; i < n1 * L; i += 32) {
      const int code = i / L, j = i - code * L;
      const int tt = j / KT, k = j - tt * KT;
      sp[(code * KT + k) * 32 + tt] = pr[i];
    }
    for (int i = t; i < L; i += 32) sp[n1 * L + i] = wave::kPoison;
    prof = sp + t;
    rst = 0u;
  }
  __device__ __forceinline__ int& H(int k) { return h[k]; }
  __device__ __forceinline__ int& E(int k) { return e[k]; }
  __device__ __forceinline__ int OFF(int k) const { return off[k]; }
  __device__ __forceinline__ int WOFF(int k) const {
    return woff[Dual ? k : 0];
  }
  __device__ __forceinline__ bool RST(int k) const {
    return (rst >> k) & 1u;
  }
  __device__ __forceinline__ int SUB(int code, int k) const {
    return prof[(code * KT + k) * 32];
  }
  __device__ __forceinline__ void set_lane(int k, int o, int w, bool r) {
    off[k] = o;
    if constexpr (Dual) woff[k] = w;
    rst |= unsigned(r) << k;
  }
};

// The same in the read's global scratch row (any K): planes [5][K][32];
// the profile is read from its global (n1, L) row.
struct GlobRow {
  int* s;              // scratch row + lane
  const int8_t* prof;  // global (n1, L) profile row of the read
  int K, L, t, n1;

  __device__ __forceinline__ void attach(unsigned char*, int* row,
                                         const int8_t* pr, int n1_, int L_,
                                         int t_) {
    L = L_;
    K = L_ / 32;
    t = t_;
    n1 = n1_;
    s = row + t_;
    prof = pr;
  }
  __device__ __forceinline__ int& P(int plane, int k) const {
    return s[(plane * K + k) * 32];
  }
  __device__ __forceinline__ int& H(int k) { return P(0, k); }
  __device__ __forceinline__ int& E(int k) { return P(1, k); }
  __device__ __forceinline__ int OFF(int k) const { return P(2, k); }
  __device__ __forceinline__ int WOFF(int k) const { return P(3, k); }
  __device__ __forceinline__ bool RST(int k) const { return P(4, k) != 0; }
  __device__ __forceinline__ int SUB(int code, int k) const {
    if (code >= n1) return wave::kPoison;
    return prof[code * L + t * K + k];
  }
  __device__ __forceinline__ void set_lane(int k, int o, int w, bool r) {
    P(2, k) = o;
    P(3, k) = w;
    P(4, k) = r;
  }
};

template <int KT, bool Dual> struct RowSel { using type = RegRow<KT, Dual>; };
template <bool Dual> struct RowSel<0, Dual> { using type = GlobRow; };

// Shared memory of one warp and its ring (after the profile).
__device__ __forceinline__ int* ring_of(unsigned char* wsm, int n1, int L,
                                        bool reg) {
  return reinterpret_cast<int*>(
      wsm + (reg ? wave::align16(size_t(n1 + 1) * L * 4) : 0));
}

// Each row's masked-max offsets (col_mask; wmask for the dual word
// channel) and the quirk's block starts, from the read's (L,) rows.
template <int KT, bool Quirk, bool Dual, class Row>
__device__ __forceinline__ void set_geometry(Row& r, int K, int t,
                                             const uint8_t* cm,
                                             const uint8_t* wm,
                                             const int8_t* sid,
                                             const uint8_t* sst) {
  const int KK = KT > 0 ? KT : K;
#pragma unroll
  for (int k = 0; k < KK; ++k) {
    const int j = t * KK + k;
    const bool rs =
        Quirk && (j == 0 || sst[j] != 0 || sid[j - 1] != sid[j]);
    r.set_lane(k, cm[j] ? 0 : wave::kDead,
               Dual && wm[j] ? 0 : wave::kDead, rs);
  }
}

// What a lane carries from one step to the next: the chains and maxima
// it hands lane t + 1, its diagonal H a step ahead, and its tracker
// (value, first column, lowest read row).
struct Lane {
  int Fo, Go, co, wo, hlast, hd_pend;
  int v, vc, jr;

  __device__ __forceinline__ void reset(int L) {
    Fo = Go = wave::kNeg;
    co = wo = hlast = hd_pend = 0;
    v = 0;
    vc = -1;
    jr = L;
  }
};

// One step of lane t at column col = s - t: the hand-off from lane t - 1,
// the K rows (sw_wave.cuh wave_rows), and the tracker, moved only when
// the entry takes a best hit and this lane's maximum rises.  Leaves
// column col's running maxima over rows <= this lane's in c.co (c.wo).
template <int KT, bool Quirk, bool Dual, class Row>
__device__ __forceinline__ void step(Row& r, Lane& c, int ent, int col,
                                     int t, int K, int L, int rl,
                                     const wave::Pen<Op>& pen) {
  const int KK = KT > 0 ? KT : K;
  int Fin = __shfl_up_sync(wave::kFull, c.Fo, 1);
  int cin = __shfl_up_sync(wave::kFull, c.co, 1);
  int hn = __shfl_up_sync(wave::kFull, c.hlast, 1);
  int Gin = Quirk ? __shfl_up_sync(wave::kFull, c.Go, 1) : 0;
  int win = Dual ? __shfl_up_sync(wave::kFull, c.wo, 1) : 0;
  if (t == 0) {
    Fin = Gin = wave::kNeg;
    cin = hn = win = 0;
  }
  const int hd = c.hd_pend;
  c.hd_pend = hn;
  int F = Fin, G = Gin, mo = 0, mw = 0;
  wave::wave_rows<Op, KT, Quirk, Dual>(r, K, ent & 0xffff, hd, F, G, mo, mw,
                                       pen);
  c.Fo = F;
  if constexpr (Quirk) c.Go = G;
  c.hlast = r.H(KK - 1);
  c.co = max(cin, mo);
  if constexpr (Dual) c.wo = max(win, mw);
  if ((ent & wave::kTake) && mo > c.v) {
    c.v = mo;
    c.vc = col;
    int jm = L;
#pragma unroll
    for (int k = KK - 1; k >= 0; --k)
      if (t * KK + k < rl && r.H(k) == mo) jm = t * KK + k;
    c.jr = jm;
  }
}

}  // namespace wave32
