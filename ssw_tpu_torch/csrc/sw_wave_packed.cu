// forward_shared_packed as an anti-diagonal wavefront (sw_wave.cuh): the
// SW forward DP of lane-packed reads against one shared target, int32,
// blockmax and dual modes, the quirk off and on, for every launch without
// the bounded-radius gate.  The gated launches keep the column-scan body
// of sw_forward_packed.cu.
//
// Replaces the packed mode of the JAX package's Pallas kernel
// _forward_kernel (ssw_tpu/ops/pallas_sw.py:109: slot bias and h_diag cut
// :214-248, per-slot block maxima :381-404, dual :398-404, set-up in
// _forward_call :445-481, pallas_call at :557, wrapper
// forward_shared_ref_packed :1139).  Input and outputs are
// sw_forward_packed.cu's, with its argument struct unchanged: the packed
// profile rows, the slot tables so/sl/rl_s, flat_idx = row * S + slot; per
// read score, end_ref, end_read and block maxima (B, nblk), dual (B, 2,
// nblk).
//
// Layout.  One warp per slot, as in sw_forward_packed.cu: the warp copies
// its slot's lanes [so, so + sl) of the packed profile row into shared
// memory (32-bit entries, lanes past sl the virtual letter's zero row, then
// the poison row), lane j of the warp is the slot's lane_off j, Lw = 32*K
// lanes with K the smallest register variant that holds the longest slot
// (a global scratch row past 1024 lanes).  col_mask is j < sl, the word
// channel j < min(sl, round_up(rl, 8)).  Only columns < valid_len run: the
// ring hands later columns the poison row without the best-hit bit, the
// steps stop at valid_len + 31, and the blocks past valid_len are written
// 0.  The quirk's lane blocks are q(j) = min(j*nb/sl, nb - 1) (nb = 16 byte
// tier, 8 word); G restarts at each block's first row and crosses lane
// boundaries by its own shuffle, since blocks need not align with lanes.
// The wrapper enforces the QBUMP span guard, under which the segmented G
// chain equals the twins' biased prefix max.
//
// What bounds it: integer issue (sw_wave.cuh); a read costs what it costs
// unpacked at a lane width of 32*K >= its slot.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libsw_wave_packed.so sw_wave_packed.cu

#include "sw_dp.cuh"
#include "sw_wave.cuh"

namespace {

using Op = wave::I32;
constexpr int kPlanes = 5;  // global-row planes: H E OFF WOFF RST

struct PackArgs {
  const int8_t* prof;       // (n_rows, n1, W) packed profile rows
  const int32_t* ref;       // (R,)
  const int32_t* so;        // (n_rows, S) slot offsets
  const int32_t* sl;        // (n_rows, S) tier-padded slot lengths
  const int32_t* rl_s;      // (n_rows, S) read lengths
  const int32_t* flat_idx;  // (B,) row * S + slot
  int B, n1, W, S, Lw, R, valid_len, gapO, gapE, nb;
  int32_t* score;           // (B,)
  int32_t* end_ref;         // (B,)
  int32_t* end_read;        // (B,)
  int32_t* blockmax;        // (B, nblk), dual (B, 2, nblk)
  int32_t* scratch;         // global row: per read 5*Lw planes + the profile
};

// The slot's state in registers (K known at compile time).
template <int KT, bool Dual>
struct RegRow {
  int h[KT], e[KT], off[KT], woff[Dual ? KT : 1];
  unsigned rst;     // bit k: row t*K+k starts a quirk lane block
  const int* prof;  // shared [code][k][32], offset by lane

  __device__ __forceinline__ void attach(unsigned char* wsm, int*,
                                         const int8_t* prow, int W, int o,
                                         int ln, int n1, int Lw, int t) {
    int* sp = reinterpret_cast<int*>(wsm);
    for (int i = t; i < n1 * Lw; i += 32) {
      const int code = i / Lw, j = i - code * Lw;
      const int tt = j / KT, k = j - tt * KT;
      sp[(code * KT + k) * 32 + tt] =
          j < ln ? prow[size_t(code) * W + o + j] : 0;
    }
    for (int i = t; i < Lw; i += 32) sp[n1 * Lw + i] = wave::kPoison;
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

// The same in the read's global scratch row: planes [5][K][32], then the
// slot profile [code][j] as int8 with the poison row.
struct GlobRow {
  int* s;               // scratch row + lane
  const int8_t* prof;   // (n1 + 1, Lw)
  int K, Lw, t;

  __device__ __forceinline__ void attach(unsigned char*, int* srow,
                                         const int8_t* prow, int W, int o,
                                         int ln, int n1, int Lw_, int t_) {
    int8_t* pb = reinterpret_cast<int8_t*>(srow + kPlanes * Lw_);
    for (int i = t_; i < (n1 + 1) * Lw_; i += 32) {
      const int code = i / Lw_, j = i - code * Lw_;
      pb[i] = code == n1 ? int8_t(wave::kPoison)
              : j < ln   ? prow[size_t(code) * W + o + j]
                         : int8_t(0);
    }
    Lw = Lw_;
    K = Lw_ / 32;
    t = t_;
    s = srow + t_;
    prof = pb;
    __syncwarp();
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
    return prof[code * Lw + t * K + k];
  }
  __device__ __forceinline__ void set_lane(int k, int o, int w, bool r) {
    P(2, k) = o;
    P(3, k) = w;
    P(4, k) = r;
  }
};

template <int KT, bool Dual> struct RowSel { using type = RegRow<KT, Dual>; };
template <bool Dual> struct RowSel<0, Dual> { using type = GlobRow; };

template <int KT, bool Quirk, bool Dual>
__global__ void sw_wave_packed_kernel(const PackArgs a) {
  static_assert(!(Dual && Quirk), "dual needs the quirk off");
  extern __shared__ __align__(16) unsigned char smem[];
  const int wpb = blockDim.x >> 5, w = threadIdx.x >> 5, t = threadIdx.x & 31;
  const int b = blockIdx.x * wpb + w;
  if (b >= a.B) return;  // whole warps only; no block barriers below
  const int Lw = a.Lw, n1 = a.n1;
  const int K = KT > 0 ? KT : Lw / 32;
  const int KK = KT > 0 ? KT : K;
  const int fi = a.flat_idx[b];
  const int row = fi / a.S;
  const int o = a.so[fi], ln = a.sl[fi], rl = a.rl_s[fi];
  const int wend = min(ln, (rl + 7) / 8 * 8);  // word-tier span (wcol)
  unsigned char* wsm = smem + size_t(w) * wave::warp_bytes(n1, Lw, KT > 0);
  int* ring = reinterpret_cast<int*>(
      wsm + (KT > 0 ? wave::align16(size_t(n1 + 1) * Lw * 4) : 0));
  int* srow = a.scratch
                  ? a.scratch + size_t(b) * (kPlanes * Lw +
                                             ((n1 + 1) * Lw + 3) / 4)
                  : nullptr;
  using Row = typename RowSel<KT, Dual>::type;
  Row r;
  r.attach(wsm, srow, a.prof + size_t(row) * n1 * a.W, a.W, o, ln, n1, Lw,
           t);
  const int sl1 = max(ln, 1);
#pragma unroll
  for (int k = 0; k < KK; ++k) {
    const int j = t * KK + k;
    r.H(k) = 0;
    r.E(k) = 0;
    const int q = min(j * a.nb / sl1, a.nb - 1);
    const int qp = j > 0 ? min((j - 1) * a.nb / sl1, a.nb - 1) : -1;
    r.set_lane(k, j < ln ? 0 : wave::kDead, j < wend ? 0 : wave::kDead,
               Quirk && (j == 0 || qp != q));
  }

  const int vl = min(a.valid_len, a.R);
  const int poison = n1;
  ring[32 + t] = poison;
  __syncwarp();
  int ent_next = ring[(-1 - t) & (wave::kRing - 1)];

  wave::Pen<Op> pen;
  pen.nO = Op::splat(-a.gapO);
  pen.nE = Op::splat(-a.gapE);
  pen.neg = Op::splat(wave::kNeg);
  int Fo = wave::kNeg, Go = wave::kNeg, co = 0, wo = 0, hlast = 0;
  int hd_pend = 0;
  int v = 0, vc = -1, jr = Lw;  // this lane's tracker
  int bm = 0, bw = 0;           // lane 31: block running maxima
  const int nblk = (a.R + wave::kBlockCols - 1) / wave::kBlockCols;
  int32_t* bm_row = a.blockmax + size_t(b) * nblk * (Dual ? 2 : 1);

  // steps s = -1 .. vl + 30 (and up to 7 more): lane t at column s - t
  for (int s8 = -1; s8 < vl + 31; s8 += wave::kUnroll) {
#pragma unroll
    for (int u = 0; u < wave::kUnroll; ++u) {
      const int s = s8 + u;
      if (u == 0 && (s8 & 31) == 31) {  // the next 32 columns into the ring
        __syncwarp();
        const int col = s8 + 1 + t;
        ring[col & (wave::kRing - 1)] =
            col < vl ? a.ref[col] | wave::kTake : poison;
        __syncwarp();
      }
      const int ent = ent_next;
      ent_next = ring[(s + 1 - t) & (wave::kRing - 1)];
      // hand-off from lane t - 1 (column s - t, its previous step)
      int Fin = __shfl_up_sync(wave::kFull, Fo, 1);
      int cin = __shfl_up_sync(wave::kFull, co, 1);
      int hn = __shfl_up_sync(wave::kFull, hlast, 1);
      int Gin = Quirk ? __shfl_up_sync(wave::kFull, Go, 1) : 0;
      int win = Dual ? __shfl_up_sync(wave::kFull, wo, 1) : 0;
      if (t == 0) {
        Fin = Gin = wave::kNeg;
        cin = hn = win = 0;
      }
      const int hd = hd_pend;
      hd_pend = hn;
      int F = Fin, G = Gin, mo = 0, mw = 0;
      wave::wave_rows<Op, KT, Quirk, Dual>(r, K, ent & 0xffff, hd, F, G, mo,
                                           mw, pen);
      Fo = F;
      if constexpr (Quirk) Go = G;
      hlast = r.H(KK - 1);
      co = max(cin, mo);
      if constexpr (Dual) wo = max(win, mw);
      // this lane's tracker: only when its maximum rises
      if ((ent & wave::kTake) && mo > v) {
        v = mo;
        vc = s - t;
        int jm = Lw;
#pragma unroll
        for (int k = KK - 1; k >= 0; --k)
          if (t * KK + k < rl && r.H(k) == mo) jm = t * KK + k;
        jr = jm;
      }
      // lane 31: column c31 is complete (before column 0: co = 0)
      const int c31 = s - 31;
      if (c31 < vl) {
        bm = max(bm, co);
        if constexpr (Dual) bw = max(bw, wo);
      }
      // c31 = u mod 8 (s8 = 7 mod 8): a block ends only at u = 7
      if (u == wave::kUnroll - 1 &&
          (c31 & (wave::kBlockCols - 1)) == wave::kBlockCols - 1 &&
          c31 < vl) {
        const int blk = c31 / wave::kBlockCols;
        if (t == 31) {
          bm_row[blk] = bm;
          if constexpr (Dual) bm_row[nblk + blk] = bw;
        }
        bm = bw = 0;
      }
    }
  }
  // the last, partial block; blocks past valid_len get no column
  const int vblk = (vl + wave::kBlockCols - 1) / wave::kBlockCols;
  if ((vl & (wave::kBlockCols - 1)) && t == 31) {
    bm_row[vblk - 1] = bm;
    if constexpr (Dual) bm_row[nblk + vblk - 1] = bw;
  }
  for (int blk = vblk + t; blk < nblk; blk += 32) {
    bm_row[blk] = 0;
    if constexpr (Dual) bm_row[nblk + blk] = 0;
  }
  const wave::Best best = wave::merge_best(v, vc, jr, Lw, rl);
  if (t == 0) {
    a.score[b] = best.score;
    a.end_ref[b] = best.col;
    a.end_read[b] = best.row;
  }
}

template <int KT, bool Quirk, bool Dual>
int launch_mode(const PackArgs& a, cudaStream_t stream) {
  int wpb;
  size_t smem;
  wave::launch_shape(wave::warp_bytes(a.n1, a.Lw, KT > 0), &wpb, &smem);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sw_wave_packed_kernel<KT, Quirk, Dual>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  const int grid = (a.B + wpb - 1) / wpb;
  sw_wave_packed_kernel<KT, Quirk, Dual>
      <<<grid, wpb * 32, smem, stream>>>(a);
  return int(cudaGetLastError());
}

template <int KT>
int launch(const PackArgs& a, bool quirk, bool dual, cudaStream_t stream) {
  if (dual) return launch_mode<KT, false, true>(a, stream);
  return quirk ? launch_mode<KT, true, false>(a, stream)
               : launch_mode<KT, false, false>(a, stream);
}

}  // namespace

extern "C" {

// int32 scratch elements per read the launch needs (0: register variant).
int sw_wave_packed_scratch_per_read(int Lw, int n1) {
  return sw::reg_k(Lw / 32) ? 0 : kPlanes * Lw + ((n1 + 1) * Lw + 3) / 4;
}

// Returns the cudaError_t of the launch (0 on success).
// sw_forward_packed's arguments without the gate: Lw lanes per warp (a
// multiple of 32 >= every slot length); nb quirk lane blocks per slot (16
// byte tier, 8 word); dual needs quirk 0.
int sw_wave_packed(const void* prof, const void* ref, const void* so,
                   const void* sl, const void* rl_s, const void* flat_idx,
                   int B, int n1, int W, int S, int Lw, int R, int valid_len,
                   int gapO, int gapE, int quirk, int nb, int dual,
                   void* score, void* end_ref, void* end_read,
                   void* blockmax, void* scratch, void* stream) {
  if (B <= 0) return 0;
  if (dual && quirk) return int(cudaErrorInvalidValue);
  if (n1 + 1 > 0xffff) return int(cudaErrorInvalidValue);
  PackArgs a;
  a.prof = static_cast<const int8_t*>(prof);
  a.ref = static_cast<const int32_t*>(ref);
  a.so = static_cast<const int32_t*>(so);
  a.sl = static_cast<const int32_t*>(sl);
  a.rl_s = static_cast<const int32_t*>(rl_s);
  a.flat_idx = static_cast<const int32_t*>(flat_idx);
  a.B = B;
  a.n1 = n1;
  a.W = W;
  a.S = S;
  a.Lw = Lw;
  a.R = R;
  a.valid_len = valid_len;
  a.gapO = gapO;
  a.gapE = gapE;
  a.nb = nb;
  a.score = static_cast<int32_t*>(score);
  a.end_ref = static_cast<int32_t*>(end_ref);
  a.end_read = static_cast<int32_t*>(end_read);
  a.blockmax = static_cast<int32_t*>(blockmax);
  a.scratch = static_cast<int32_t*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SW_DISPATCH_K(Lw / 32, launch, a, quirk != 0, dual != 0, s)
}

const char* sw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
