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
// Stretches (ops/pack.py).  A read may run as P warps, a second kernel
// parameter (SplitArgs; PackArgs stays as it is, ROADMAP §C1): warp p owns
// the columns [p*C, min((p+1)*C, valid_len)), C a multiple of kBlockCols,
// and starts from zero state `halo` columns before them (warp 0 at column
// 0).  Halo columns go through the ring with their codes but without
// kTake, and feed no block maximum, so every block maximum is written by
// the one warp that owns its block; the last warp writes the partial block
// and the zero blocks past valid_len.  With P > 1 each warp leaves its best
// hit in SplitArgs::part and sw_wave_packed_merge_kernel merges a read's P
// hits in stretch order (a later stretch only with a higher score), which
// is merge_best's order: score, then column, then row.
//
// What bounds it: integer issue (sw_wave.cuh); a read costs what it costs
// unpacked at a lane width of 32*K >= its slot.  A launch of few reads
// splits the target until its warps fill the card (pack.stretch_rule).
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
  int32_t* scratch;         // global row: per warp 5*Lw planes + the profile
};

// The target split into stretches; P = 1 is the whole target in one warp.
struct SplitArgs {
  int P;          // warps (stretches) per read
  int C;          // columns per stretch, a multiple of kBlockCols
  int halo;       // warm-up columns before a stretch, kBlockCols multiple
  int32_t* part;  // P > 1: (3, B*P) score, end_ref, end_read per stretch
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
__global__ void sw_wave_packed_kernel(const PackArgs a, const SplitArgs sp) {
  static_assert(!(Dual && Quirk), "dual needs the quirk off");
  extern __shared__ __align__(16) unsigned char smem[];
  const int wpb = blockDim.x >> 5, w = threadIdx.x >> 5, t = threadIdx.x & 31;
  const int g = blockIdx.x * wpb + w;  // the warp: read b, stretch p
  if (g >= a.B * sp.P) return;  // whole warps only; no block barriers below
  const int b = g / sp.P, p = g - b * sp.P;
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
                  ? a.scratch + size_t(g) * (kPlanes * Lw +
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
  // this warp's stretch: it scans [c0, own1) and owns [own0, own1); ring
  // slots, steps and c31 below count columns from c0 (a multiple of 8)
  const bool last = p == sp.P - 1;
  const int own0 = p * sp.C;
  const int own1 = last ? vl : own0 + sp.C;
  const int c0 = max(own0 - sp.halo, 0);
  const int ncol = own1 - c0;
  // every warp steps as far as the longest stretch: a trip count from the
  // kernel's parameters alone keeps the loop provably warp-uniform, which
  // the shuffles need to compile without collective fallbacks (a per-warp
  // bound made the step about 35 % slower); columns past ncol are poison
  const int nstep = sp.P == 1 ? vl : min(sp.C + sp.halo, vl);
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

  // steps s = -1 .. nstep + 30 (and up to 7 more): lane t at column
  // c0 + s - t
  for (int s8 = -1; s8 < nstep + 31; s8 += wave::kUnroll) {
#pragma unroll
    for (int u = 0; u < wave::kUnroll; ++u) {
      const int s = s8 + u;
      if (u == 0 && (s8 & 31) == 31) {  // the next 32 columns into the ring
        __syncwarp();
        const int col = s8 + 1 + t;
        ring[col & (wave::kRing - 1)] =
            col < ncol ? a.ref[c0 + col] | (c0 + col >= own0 ? wave::kTake
                                                             : 0)
                       : poison;
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
        vc = c0 + s - t;
        int jm = Lw;
#pragma unroll
        for (int k = KK - 1; k >= 0; --k)
          if (t * KK + k < rl && r.H(k) == mo) jm = t * KK + k;
        jr = jm;
      }
      // lane 31: column c0 + c31 is complete (before column 0: co = 0)
      const int c31 = s - 31;
      const bool in = c31 < ncol;
      bm = in ? max(bm, co) : bm;
      if constexpr (Dual) bw = in ? max(bw, wo) : bw;
      // c31 = u mod 8 (s8 = 7 mod 8): a block ends only at u = 7; the
      // halo's whole blocks are dropped
      if (u == wave::kUnroll - 1 &&
          (c31 & (wave::kBlockCols - 1)) == wave::kBlockCols - 1) {
        const int blk = (c0 + c31) / wave::kBlockCols;
        if (t == 31 && in && c0 + c31 >= own0) {
          bm_row[blk] = bm;
          if constexpr (Dual) bm_row[nblk + blk] = bw;
        }
        bm = in ? 0 : bm;
        if constexpr (Dual) bw = in ? 0 : bw;
      }
    }
  }
  // the last warp: the last, partial block; blocks past valid_len get no
  // column
  const int vblk = (vl + wave::kBlockCols - 1) / wave::kBlockCols;
  if (last && (vl & (wave::kBlockCols - 1)) && t == 31) {
    bm_row[vblk - 1] = bm;
    if constexpr (Dual) bm_row[nblk + vblk - 1] = bw;
  }
  for (int blk = vblk + t; last && blk < nblk; blk += 32) {
    bm_row[blk] = 0;
    if constexpr (Dual) bm_row[nblk + blk] = 0;
  }
  const wave::Best best = wave::merge_best(v, vc, jr, Lw, rl);
  if (t == 0) {
    if (sp.P == 1) {
      a.score[b] = best.score;
      a.end_ref[b] = best.col;
      a.end_read[b] = best.row;
    } else {
      const size_t n = size_t(a.B) * sp.P;
      sp.part[g] = best.score;
      sp.part[n + g] = best.col;
      sp.part[2 * n + g] = best.row;
    }
  }
}

// A read's P stretch hits, in stretch order: the first of the highest
// score (columns rise with p, and each stretch's hit is its first column's
// lowest row), so the outputs are the whole scan's.
__global__ void sw_wave_packed_merge_kernel(const PackArgs a,
                                            const SplitArgs sp) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;
  const size_t n = size_t(a.B) * sp.P, g0 = size_t(b) * sp.P;
  size_t best = g0;
  for (int p = 1; p < sp.P; ++p)
    if (sp.part[g0 + p] > sp.part[best]) best = g0 + p;
  a.score[b] = sp.part[best];
  a.end_ref[b] = sp.part[n + best];
  a.end_read[b] = sp.part[2 * n + best];
}

template <int KT, bool Quirk, bool Dual>
int launch_mode(const PackArgs& a, const SplitArgs& sp, cudaStream_t stream,
                int* shape) {
  int wpb;
  size_t smem;
  wave::launch_shape(wave::warp_bytes(a.n1, a.Lw, KT > 0), &wpb, &smem);
  auto kernel = sw_wave_packed_kernel<KT, Quirk, Dual>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  if (shape) {  // no launch: warps per block, resident warps per SM
    int blocks = 0;
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, wpb * 32, smem);
    shape[0] = wpb;
    shape[1] = blocks * wpb;
    return int(e);
  }
  const long warps = long(a.B) * sp.P;
  const int grid = int((warps + wpb - 1) / wpb);
  kernel<<<grid, wpb * 32, smem, stream>>>(a, sp);
  if (sp.P > 1)
    sw_wave_packed_merge_kernel<<<(a.B + 127) / 128, 128, 0, stream>>>(a,
                                                                       sp);
  return int(cudaGetLastError());
}

template <int KT>
int launch(const PackArgs& a, const SplitArgs& sp, bool quirk, bool dual,
           cudaStream_t stream, int* shape) {
  if (dual) return launch_mode<KT, false, true>(a, sp, stream, shape);
  return quirk ? launch_mode<KT, true, false>(a, sp, stream, shape)
               : launch_mode<KT, false, false>(a, sp, stream, shape);
}

}  // namespace

extern "C" {

// int32 scratch elements per warp the launch needs (0: register variant).
int sw_wave_packed_scratch_per_read(int Lw, int n1) {
  return sw::reg_k(Lw / 32) ? 0 : kPlanes * Lw + ((n1 + 1) * Lw + 3) / 4;
}

// The launch shape of a mode: shape[0] warps per block, shape[1] warps of
// the kernel resident per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor
// times shape[0]).  Returns the cudaError_t.
int sw_wave_packed_shape(int Lw, int n1, int quirk, int dual, void* shape) {
  PackArgs a = {};
  a.Lw = Lw;
  a.n1 = n1;
  SplitArgs sp = {};
  int* out = static_cast<int*>(shape);
  SW_DISPATCH_K(Lw / 32, launch, a, sp, quirk != 0, dual != 0, nullptr, out)
}

// Returns the cudaError_t of the launch (0 on success).
// sw_forward_packed's arguments without the gate: Lw lanes per warp (a
// multiple of 32 >= every slot length); nb quirk lane blocks per slot (16
// byte tier, 8 word); dual needs quirk 0.  Then the stretches: P per read,
// C columns each (a multiple of 256, (P-1)*C < valid_len <= P*C), halo
// warm-up columns (a multiple of 256), part (3, B*P) int32 scratch when
// P > 1; scratch holds B*P rows.
int sw_wave_packed(const void* prof, const void* ref, const void* so,
                   const void* sl, const void* rl_s, const void* flat_idx,
                   int B, int n1, int W, int S, int Lw, int R, int valid_len,
                   int gapO, int gapE, int quirk, int nb, int dual,
                   void* score, void* end_ref, void* end_read,
                   void* blockmax, void* scratch, int P, int C, int halo,
                   void* part, void* stream) {
  if (B <= 0) return 0;
  if (dual && quirk) return int(cudaErrorInvalidValue);
  if (n1 + 1 > 0xffff) return int(cudaErrorInvalidValue);
  // the stretches cover the columns, none of them empty
  const long vcols = max(min(valid_len, R), 1);
  if (P < 1 || C % wave::kBlockCols || halo % wave::kBlockCols ||
      (P > 1 && !part) || long(P - 1) * C >= vcols || long(P) * C < vcols)
    return int(cudaErrorInvalidValue);
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
  SplitArgs sp;
  sp.P = P;
  sp.C = C;
  sp.halo = halo;
  sp.part = static_cast<int32_t*>(part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SW_DISPATCH_K(Lw / 32, launch, a, sp, quirk != 0, dual != 0, s, nullptr)
}

const char* sw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
