// forward_shared_i16 as an anti-diagonal wavefront (sw_wave.cuh): the int16
// tier of forward_shared for every launch without the bounded-radius gate,
// in base, blockmax, dual and owned mode.  The gated launches keep the
// column-scan body of sw_forward_i16.cu, whose gate drops scan steps that
// this design does not have.
//
// Replaces the int16 tier of the JAX package's Pallas kernel _forward_kernel
// (ssw_tpu/ops/pallas_sw.py:109, `use_i16` chosen at :735, pallas_call at
// :557; blockmax/lanetrack (rv, rc) :290-297, dual :142-151, :405-412; owned
// columns via forward_shared_ref_gated :1039), chosen by
// ops/cuda_sw.forward_shared when i16_exact holds: quirk off and
// L*(max_sub+gapE)+gapO < 2^14, so every cell and every intermediate stays
// inside int16 and the outputs equal the int32 kernel's bit for bit.
//
// Layout.  Two reads share a warp, read 2p in the low and read 2p+1 in the
// high half of each 32-bit register, and every instruction of
// sw_wave.cuh's step is a packed s16x2 one (Hopper DPX:
// __viaddmax_s16x2[_relu], __vmaxs2), so both reads ride one chain.  F
// enters lane 0 at -16384 (-16384 - gapE stays inside int16; after one row
// F >= -gapO).  A dead row (outside col_mask, or outside wmask for the
// word channel) adds -16384 before the masked maximum.  Each read of the
// pair keeps its own tracker (value halves, first column, lowest row); a
// tracker moves only when __vcmpgts2 finds that read's lane maximum above
// it.  Register variants for K = L/32 in sw::reg_k, with the pair's
// packed profile [code][k][lane] in shared memory; other K (and L > 1024)
// keep H, E and the row offsets in a global scratch row [plane][k][lane]
// and read the profile from global memory.
//
// What bounds it: integer issue (sw_wave.cuh); a leaf of B reads fills B/2
// warps at half the instructions per cell of the int32 design.
//
// Modes.  Base: lane 31 stores each read's column maxima as int16, eight
// columns in one 16-byte store (per column when R % 8 != 0).  Blockmax: the
// running max of the pair's column maxima over columns < valid_len, one
// int32 per read and 256 columns.  Dual (blockmax with wmask): channel 0
// over col_mask, channel 1 over wmask, each read its own.  Owned (base,
// sw::ColArgs as a third parameter as in sw_forward_i16.cu): a column that
// is not owned takes no new best hit for either read, end_ref is its
// global index.  The argument struct is sw_forward_i16.cu's, unchanged.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libsw_wave_i16.so sw_wave_i16.cu

#include "sw_dp.cuh"
#include "sw_wave.cuh"

namespace {

using Op = wave::S16x2;
constexpr int kNeg16 = -(1 << 14);  // F fill and dead-row offset (NEG16)
constexpr int kPlanes = 4;          // global-row planes per pair: H E OFF WOFF

__device__ __forceinline__ unsigned pack2(int lo, int hi) {
  return (unsigned(lo) & 0xffffu) | (unsigned(hi) << 16);
}
__device__ __forceinline__ int lo16(unsigned v) {
  return int(int16_t(v & 0xffffu));
}
__device__ __forceinline__ int hi16(unsigned v) { return int(v) >> 16; }

struct I16Args {
  const int8_t* prof;       // (B, n1, L)
  const int32_t* ref;       // (R,)
  const int32_t* read_len;  // (B,)
  const uint8_t* col_mask;  // (B, L) bool
  const uint8_t* wmask;     // (B, L) bool, dual mode: word-tier lanes
  int B, n1, L, R, gapO, gapE;
  int32_t* score;           // (B,)
  int32_t* end_ref;         // (B,)
  int32_t* end_read;        // (B,)
  int16_t* maxcol;          // (B, R), base mode
  int32_t* blockmax;        // (B, ceil(R/256)), blockmax mode
  int valid_len;            // blockmax: columns < valid_len feed the maxima
  unsigned* scratch;        // (ceil(B/2), 4, L) for the global row, else null
};

// The pair's state in registers (K known at compile time).
template <int KT, bool Dual>
struct RegRow {
  unsigned h[KT], e[KT], off[KT], woff[Dual ? KT : 1];
  const unsigned* prof;  // shared [code][k][32], offset by lane

  __device__ __forceinline__ void attach(unsigned char* wsm, unsigned*,
                                         const int8_t* pa, const int8_t* pb,
                                         int n1, int L, int t) {
    unsigned* sp = reinterpret_cast<unsigned*>(wsm);
    for (int i = t; i < n1 * L; i += 32) {
      const int code = i / L, j = i - code * L;
      const int tt = j / KT, k = j - tt * KT;
      sp[(code * KT + k) * 32 + tt] = pack2(pa[i], pb ? pb[i] : 0);
    }
    for (int i = t; i < L; i += 32)
      sp[n1 * L + i] = pack2(wave::kPoison, wave::kPoison);
    prof = sp + t;
  }
  __device__ __forceinline__ unsigned& H(int k) { return h[k]; }
  __device__ __forceinline__ unsigned& E(int k) { return e[k]; }
  __device__ __forceinline__ unsigned OFF(int k) const { return off[k]; }
  __device__ __forceinline__ unsigned WOFF(int k) const {
    return woff[Dual ? k : 0];
  }
  __device__ __forceinline__ bool RST(int) const { return false; }
  __device__ __forceinline__ unsigned SUB(int code, int k) const {
    return prof[(code * KT + k) * 32];
  }
  __device__ __forceinline__ void set_off(int k, unsigned o, unsigned w) {
    off[k] = o;
    if constexpr (Dual) woff[k] = w;
  }
};

// The pair's state in a global scratch row (any K): planes [4][K][32].
struct GlobRow {
  unsigned* s;         // scratch row + lane
  const int8_t* pa;    // global (n1, L) profile rows of the two reads
  const int8_t* pb;    // (null: the pair's high half is empty)
  int K, L, t, n1;

  __device__ __forceinline__ void attach(unsigned char*, unsigned* row,
                                         const int8_t* pa_, const int8_t* pb_,
                                         int n1_, int L_, int t_) {
    L = L_;
    K = L_ / 32;
    t = t_;
    n1 = n1_;
    s = row + t_;
    pa = pa_;
    pb = pb_;
  }
  __device__ __forceinline__ unsigned& P(int plane, int k) const {
    return s[(plane * K + k) * 32];
  }
  __device__ __forceinline__ unsigned& H(int k) { return P(0, k); }
  __device__ __forceinline__ unsigned& E(int k) { return P(1, k); }
  __device__ __forceinline__ unsigned OFF(int k) const { return P(2, k); }
  __device__ __forceinline__ unsigned WOFF(int k) const { return P(3, k); }
  __device__ __forceinline__ bool RST(int) const { return false; }
  __device__ __forceinline__ unsigned SUB(int code, int k) const {
    if (code >= n1) return pack2(wave::kPoison, wave::kPoison);
    const int j = code * L + t * K + k;
    return pack2(pa[j], pb ? pb[j] : 0);
  }
  __device__ __forceinline__ void set_off(int k, unsigned o, unsigned w) {
    P(2, k) = o;
    P(3, k) = w;
  }
};

template <int KT, bool Dual> struct RowSel { using type = RegRow<KT, Dual>; };
template <bool Dual> struct RowSel<0, Dual> { using type = GlobRow; };

// Lowest row j < rl of this lane whose half `hi` of H equals m, else L.
template <int KT, class Row>
__device__ __forceinline__ int low_row(Row& r, int KK, int t, int hi, int m,
                                       int rl, int L) {
  int jm = L;
#pragma unroll
  for (int k = KK - 1; k >= 0; --k) {
    const int j = t * KK + k;
    const int h = hi ? hi16(r.H(k)) : lo16(r.H(k));
    if (j < rl && h == m) jm = j;
  }
  return jm;
}

template <int KT, bool BlockMax, bool Dual, bool Owned>
__device__ __forceinline__ void wave_i16_body(const I16Args a,
                                              const sw::ColArgs c) {
  static_assert(!Dual || BlockMax, "dual is a blockmax mode");
  static_assert(!Owned || !BlockMax, "owned: base mode only");
  extern __shared__ __align__(16) unsigned char smem[];
  const int wpb = blockDim.x >> 5, w = threadIdx.x >> 5, t = threadIdx.x & 31;
  const int pair = blockIdx.x * wpb + w;
  const int ba = 2 * pair, bb = ba + 1;
  if (ba >= a.B) return;  // whole warps only; no block barriers below
  const bool has_b = bb < a.B;
  const int L = a.L, R = a.R, n1 = a.n1;
  const int K = KT > 0 ? KT : L / 32;
  const int KK = KT > 0 ? KT : K;
  const size_t plane = size_t(n1) * L;
  const int8_t* pa = a.prof + size_t(ba) * plane;
  unsigned char* wsm = smem + size_t(w) * wave::warp_bytes(n1, L, KT > 0);
  int* ring = reinterpret_cast<int*>(
      wsm + (KT > 0 ? wave::align16(size_t(n1 + 1) * L * 4) : 0));
  using Row = typename RowSel<KT, Dual>::type;
  Row r;
  r.attach(wsm, a.scratch ? a.scratch + size_t(pair) * kPlanes * L : nullptr,
           pa, has_b ? pa + plane : nullptr, n1, L, t);
  const uint8_t* cma = a.col_mask + size_t(ba) * L;
  const uint8_t* wma = Dual ? a.wmask + size_t(ba) * L : nullptr;
#pragma unroll
  for (int k = 0; k < KK; ++k) {
    const int j = t * KK + k;
    r.H(k) = r.E(k) = 0u;
    const unsigned o = pack2(cma[j] ? 0 : kNeg16,
                             has_b && cma[L + j] ? 0 : kNeg16);
    const unsigned wo_ = Dual ? pack2(wma[j] ? 0 : kNeg16,
                                      has_b && wma[L + j] ? 0 : kNeg16)
                              : 0u;
    r.set_off(k, o, wo_);
  }
  const int rla = a.read_len[ba], rlb = has_b ? a.read_len[bb] : 0;

  // the ring: columns -32..-1 poison; the first trip writes columns 0..31
  const int poison = n1;
  ring[32 + t] = poison;
  __syncwarp();
  int ent_next = ring[(-1 - t) & (wave::kRing - 1)];

  wave::Pen<Op> pen;
  pen.nO = Op::splat(-a.gapO);
  pen.nE = Op::splat(-a.gapE);
  pen.neg = Op::splat(kNeg16);
  unsigned Fo = pen.neg, co = 0u, wo = 0u, hlast = 0u, hd_pend = 0u;
  unsigned v = 0u;                    // tracker values, both halves
  int vca = -1, vcb = -1, jra = L, jrb = L;
  unsigned bm = 0u, bw = 0u;          // lane 31: block running maxima
  unsigned bufa[4], bufb[4], prev = 0u;  // lane 31: 8 columns of maxima
  const int vmax = BlockMax ? min(a.valid_len, R) : R;
  const int nblk = (R + wave::kBlockCols - 1) / wave::kBlockCols;
  const int stride = Dual ? 2 * nblk : nblk;  // block maxima per read
  int16_t* mca = BlockMax ? nullptr : a.maxcol + size_t(ba) * R;
  int16_t* mcb = has_b && !BlockMax ? mca + R : nullptr;
  int32_t* bma = BlockMax ? a.blockmax + size_t(ba) * stride : nullptr;
  const bool vec16 = (R & 7) == 0 &&
                     (reinterpret_cast<uintptr_t>(a.maxcol) & 15) == 0;

  // steps s = -1 .. R + 30 (and up to 7 more): lane t at column s - t
  for (int s8 = -1; s8 < R + 31; s8 += wave::kUnroll) {
#pragma unroll
    for (int u = 0; u < wave::kUnroll; ++u) {
      const int s = s8 + u;
      if (u == 0 && (s8 & 31) == 31) {  // the next 32 columns into the ring
        __syncwarp();
        const int col = s8 + 1 + t;
        int e = poison;
        if (col < R) {
          const bool take = Owned ? c.own[col] != 0 : true;
          e = a.ref[col] | (take ? wave::kTake : 0);
        }
        ring[col & (wave::kRing - 1)] = e;
        __syncwarp();
      }
      const int ent = ent_next;
      ent_next = ring[(s + 1 - t) & (wave::kRing - 1)];
      // hand-off from lane t - 1 (column s - t, its previous step)
      unsigned Fin = __shfl_up_sync(wave::kFull, Fo, 1);
      unsigned cin = __shfl_up_sync(wave::kFull, co, 1);
      unsigned hn = __shfl_up_sync(wave::kFull, hlast, 1);
      unsigned win = Dual ? __shfl_up_sync(wave::kFull, wo, 1) : 0u;
      if (t == 0) {
        Fin = pen.neg;
        cin = hn = win = 0u;
      }
      const unsigned hd = hd_pend;
      hd_pend = hn;
      unsigned F = Fin, G = 0u, mo = 0u, mw = 0u;
      wave::wave_rows<Op, KT, false, Dual>(r, K, ent & 0xffff, hd, F, G, mo,
                                           mw, pen);
      Fo = F;
      hlast = r.H(KK - 1);
      co = __vmaxs2(cin, mo);
      if constexpr (Dual) wo = __vmaxs2(win, mw);
      // this lane's trackers: only when a read's lane maximum rises
      if (ent & wave::kTake) {
        const unsigned gt = __vcmpgts2(mo, v);
        if (gt) {
          const int col = s - t;
          if (gt & 0xffffu) {
            v = (v & 0xffff0000u) | (mo & 0xffffu);
            vca = col;
            jra = low_row<KT>(r, KK, t, 0, lo16(mo), rla, L);
          }
          if (gt & 0xffff0000u) {
            v = (v & 0xffffu) | (mo & 0xffff0000u);
            vcb = col;
            jrb = low_row<KT>(r, KK, t, 1, hi16(mo), rlb, L);
          }
        }
      }
      // lane 31: column c31 is complete (before column 0: co = 0)
      const int c31 = s - 31;
      if constexpr (BlockMax) {
        if (c31 < vmax) {
          bm = __vmaxs2(bm, co);
          if constexpr (Dual) bw = __vmaxs2(bw, wo);
        }
        // c31 = u mod 8 (s8 = 7 mod 8): a block ends only at u = 7
        if (u == wave::kUnroll - 1 && (c31 & (wave::kBlockCols - 1)) ==
                                          wave::kBlockCols - 1 &&
            c31 < R) {
          const int blk = c31 / wave::kBlockCols;
          if (t == 31) {
            bma[blk] = lo16(bm);
            if (has_b) bma[stride + blk] = hi16(bm);
            if constexpr (Dual) {
              bma[nblk + blk] = lo16(bw);
              if (has_b) bma[stride + nblk + blk] = hi16(bw);
            }
          }
          bm = bw = 0u;
        }
      } else {
        // colmax < 2^14 inside the i16_exact bound: no clip to 32767
        if (u & 1) {
          bufa[u >> 1] = __byte_perm(prev, co, 0x5410);
          bufb[u >> 1] = __byte_perm(prev, co, 0x7632);
        } else {
          prev = co;
        }
        if (u == wave::kUnroll - 1 && t == 31) {
          const int c0 = c31 - (wave::kUnroll - 1);
          if (c0 >= 0 && c0 + wave::kUnroll <= R && vec16) {
            *reinterpret_cast<uint4*>(mca + c0) =
                make_uint4(bufa[0], bufa[1], bufa[2], bufa[3]);
            if (mcb)
              *reinterpret_cast<uint4*>(mcb + c0) =
                  make_uint4(bufb[0], bufb[1], bufb[2], bufb[3]);
          } else {
#pragma unroll
            for (int i = 0; i < wave::kUnroll; ++i) {
              const int cc = c0 + i;
              if (cc >= 0 && cc < R) {
                mca[cc] = int16_t(bufa[i >> 1] >> (16 * (i & 1)));
                if (mcb) mcb[cc] = int16_t(bufb[i >> 1] >> (16 * (i & 1)));
              }
            }
          }
        }
      }
    }
  }
  if constexpr (BlockMax) {  // the last, partial block
    if ((R & (wave::kBlockCols - 1)) && t == 31) {
      const int blk = nblk - 1;
      bma[blk] = lo16(bm);
      if (has_b) bma[stride + blk] = hi16(bm);
      if constexpr (Dual) {
        bma[nblk + blk] = lo16(bw);
        if (has_b) bma[stride + nblk + blk] = hi16(bw);
      }
    }
  }
  const wave::Best A = wave::merge_best(lo16(v), vca, jra, L, rla);
  const wave::Best Bb = wave::merge_best(hi16(v), vcb, jrb, L, rlb);
  if (t == 0) {
    a.score[ba] = A.score;
    a.end_ref[ba] = Owned && A.col >= 0 ? c.idx[A.col] : A.col;
    a.end_read[ba] = A.row;
    if (has_b) {
      a.score[bb] = Bb.score;
      a.end_ref[bb] = Owned && Bb.col >= 0 ? c.idx[Bb.col] : Bb.col;
      a.end_read[bb] = Bb.row;
    }
  }
}

template <int KT, bool BlockMax, bool Dual>
__global__ void sw_wave_i16_kernel(const I16Args a) {
  wave_i16_body<KT, BlockMax, Dual, false>(a, sw::ColArgs{});
}

template <int KT>
__global__ void sw_wave_i16_owned_kernel(const I16Args a,
                                         const sw::ColArgs c) {
  wave_i16_body<KT, false, false, true>(a, c);
}

template <int KT, class Kern, class... Args>
int launch_kernel(Kern kern, const I16Args& a, cudaStream_t stream,
                  Args... more) {
  int wpb;
  size_t smem;
  wave::launch_shape(wave::warp_bytes(a.n1, a.L, KT > 0), &wpb, &smem);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  const int pairs = (a.B + 1) / 2;
  const int grid = (pairs + wpb - 1) / wpb;
  kern<<<grid, wpb * 32, smem, stream>>>(a, more...);
  return int(cudaGetLastError());
}

template <int KT>
int launch(const I16Args& a, cudaStream_t stream) {
  if (a.blockmax && a.wmask)
    return launch_kernel<KT>(sw_wave_i16_kernel<KT, true, true>, a, stream);
  if (a.blockmax)
    return launch_kernel<KT>(sw_wave_i16_kernel<KT, true, false>, a, stream);
  return launch_kernel<KT>(sw_wave_i16_kernel<KT, false, false>, a, stream);
}

template <int KT>
int launch_owned(const I16Args& a, const sw::ColArgs& c,
                 cudaStream_t stream) {
  return launch_kernel<KT>(sw_wave_i16_owned_kernel<KT>, a, stream, c);
}

__host__ I16Args i16_args(const void* prof, const void* ref,
                          const void* read_len, const void* col_mask, int B,
                          int n1, int L, int R, int gapO, int gapE,
                          void* score, void* end_ref, void* end_read,
                          void* maxcol, void* blockmax, int valid_len,
                          void* wmask, void* scratch) {
  I16Args a;
  a.prof = static_cast<const int8_t*>(prof);
  a.ref = static_cast<const int32_t*>(ref);
  a.read_len = static_cast<const int32_t*>(read_len);
  a.col_mask = static_cast<const uint8_t*>(col_mask);
  a.wmask = static_cast<const uint8_t*>(wmask);
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
  a.valid_len = valid_len;
  a.scratch = static_cast<unsigned*>(scratch);
  return a;
}

}  // namespace

extern "C" {

// uint32 scratch elements per read pair the launch needs (0: registers).
int sw_wave_i16_scratch_per_pair(int L) {
  return sw::reg_k(L / 32) ? 0 : kPlanes * L;
}

// Returns the cudaError_t of the launch (0 on success).  Exactly one of
// maxcol (base mode) and blockmax (blockmax mode, with valid_len) is set;
// wmask (non-null: dual mode) needs blockmax.  sw_forward_shared_i16's
// arguments without the gate.
int sw_wave_shared_i16(const void* prof, const void* ref,
                       const void* read_len, const void* col_mask, int B,
                       int n1, int L, int R, int gapO, int gapE, void* score,
                       void* end_ref, void* end_read, void* maxcol,
                       void* blockmax, int valid_len, void* wmask,
                       void* scratch, void* stream) {
  if (B <= 0) return 0;
  if (wmask && !blockmax) return int(cudaErrorInvalidValue);
  if (n1 + 1 > 0xffff) return int(cudaErrorInvalidValue);
  const I16Args a = i16_args(prof, ref, read_len, col_mask, B, n1, L, R,
                             gapO, gapE, score, end_ref, end_read, maxcol,
                             blockmax, valid_len, wmask, scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SW_DISPATCH_K(L / 32, launch, a, s)
}

// The owned-column mode (base mode): sw_wave_shared_i16's arguments without
// blockmax and dual, plus idx (R,) int32 and own (R,) bool.
int sw_wave_shared_i16_owned(const void* prof, const void* ref,
                             const void* read_len, const void* col_mask,
                             int B, int n1, int L, int R, int gapO, int gapE,
                             void* score, void* end_ref, void* end_read,
                             void* maxcol, const void* idx, const void* own,
                             void* scratch, void* stream) {
  if (B <= 0) return 0;
  if (!maxcol || !idx || !own) return int(cudaErrorInvalidValue);
  if (n1 + 1 > 0xffff) return int(cudaErrorInvalidValue);
  const I16Args a = i16_args(prof, ref, read_len, col_mask, B, n1, L, R,
                             gapO, gapE, score, end_ref, end_read, maxcol,
                             nullptr, 0, nullptr, scratch);
  const sw::ColArgs c{static_cast<const int32_t*>(idx),
                      static_cast<const uint8_t*>(own)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SW_DISPATCH_K(L / 32, launch_owned, a, c, s)
}

const char* sw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
