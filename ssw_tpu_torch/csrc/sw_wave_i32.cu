// forward_shared, int32, as an anti-diagonal wavefront (sw_wave.cuh): the
// int32 kernel of forward_shared for every launch without the
// bounded-radius gate, in base mode (the quirk off or on), blockmax (off or
// on), dual (off) and owned mode (off or on).  The gated launches keep the
// column-scan body of sw_forward.cu, whose gate drops scan steps that this
// design does not have.
//
// Replaces the int32 kernel of the JAX package's Pallas kernel
// _forward_kernel (ssw_tpu/ops/pallas_sw.py:109, pallas_call at :557,
// wrapper forward_shared_ref :702; blockmax/lanetrack :153-213, :278-289,
// :361-416; dual :142-151, :405-412; owned columns via
// forward_shared_ref_gated :1039, own-gating :299-311).  Inputs and
// outputs are sw_forward.cu's: maxcol (B, R) int16 clipped to [0, 32767],
// block maxima (B, ceil(R/256)) or dual (B, 2, ceil(R/256)) int32.
//
// Layout and the quirk (a G chain restarted at each lane block, and the
// conditions under which it equals the column scan's biased prefix max):
// sw_wave_i32.cuh, shared with sw_wave_perread.cu.
//
// What bounds it: integer issue, or with few warps per SM the step's
// loop-carried chain, one shuffle and K VIADDMNMX (sw_wave.cuh).  Per
// lane-row and step 7 instructions (11 with the quirk's G chain and
// selects), the dual word channel one more.
//
// Modes.  Base: lane 31 stores the column maxima clipped to 32767 as
// int16, eight columns in one 16-byte store (per column when R % 8 != 0).
// Blockmax: the running max of the column maxima over columns < valid_len,
// one int32 per 256 columns.  Dual (blockmax, quirk off): channel 0 over
// col_mask, channel 1 over wmask.  Owned (base mode, sw::ColArgs as a
// third parameter): a column that is not owned takes no new best hit,
// end_ref is its global index.  The argument struct is this file's own;
// no other kernel's parameters change.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libsw_wave_i32.so sw_wave_i32.cu

#include "sw_wave_i32.cuh"

namespace {

using wave32::kPlanes;
using wave32::Op;

struct W32Args {
  const int8_t* prof;        // (B, n1, L)
  const int32_t* ref;        // (R,)
  const int32_t* read_len;   // (B,)
  const uint8_t* col_mask;   // (B, L) bool
  const int8_t* seg_id;      // (B, L)
  const uint8_t* seg_start;  // (B, L) bool
  const uint8_t* wmask;      // (B, L) bool, dual mode: word-tier lanes
  int B, n1, L, R, gapO, gapE;
  int32_t* score;            // (B,)
  int32_t* end_ref;          // (B,)
  int32_t* end_read;         // (B,)
  int16_t* maxcol;           // (B, R), base mode
  int32_t* blockmax;         // (B, ceil(R/256)), dual (B, 2, ceil(R/256))
  int valid_len;             // blockmax: columns < valid_len feed the maxima
  int32_t* scratch;          // (B, 5, L) for the global row, else null
};

template <int KT, bool BlockMax, bool Quirk, bool Dual, bool Owned>
__device__ __forceinline__ void wave_i32_body(const W32Args a,
                                              const sw::ColArgs oc) {
  static_assert(!Dual || (BlockMax && !Quirk), "dual: blockmax, quirk off");
  static_assert(!Owned || !BlockMax, "owned: base mode only");
  extern __shared__ __align__(16) unsigned char smem[];
  const int wpb = blockDim.x >> 5, w = threadIdx.x >> 5, t = threadIdx.x & 31;
  const int b = blockIdx.x * wpb + w;
  if (b >= a.B) return;  // whole warps only; no block barriers below
  const int L = a.L, R = a.R, n1 = a.n1;
  const int K = KT > 0 ? KT : L / 32;
  const int KK = KT > 0 ? KT : K;
  const size_t row = size_t(b) * L;
  unsigned char* wsm = smem + size_t(w) * wave::warp_bytes(n1, L, KT > 0);
  int* ring = wave32::ring_of(wsm, n1, L, KT > 0);
  typename wave32::RowSel<KT, Dual>::type r;
  r.attach(wsm, a.scratch ? a.scratch + size_t(b) * kPlanes * L : nullptr,
           a.prof + row * n1, n1, L, t);
#pragma unroll
  for (int k = 0; k < KK; ++k) r.H(k) = r.E(k) = 0;
  wave32::set_geometry<KT, Quirk, Dual>(
      r, K, t, a.col_mask + row, Dual ? a.wmask + row : nullptr,
      a.seg_id + row, a.seg_start + row);
  const int rl = a.read_len[b];

  // the ring: columns -32..-1 poison; the first trip writes columns 0..31
  const int poison = n1;
  ring[32 + t] = poison;
  __syncwarp();
  int ent_next = ring[(-1 - t) & (wave::kRing - 1)];

  wave::Pen<Op> pen;
  pen.nO = -a.gapO;
  pen.nE = -a.gapE;
  pen.neg = wave::kNeg;
  wave32::Lane c;
  c.reset(L);
  int bm = 0, bw = 0;          // lane 31: block running maxima
  unsigned buf[4], prev = 0u;  // lane 31: 8 columns of clipped maxima
  const int vmax = BlockMax ? min(a.valid_len, R) : R;
  const int nblk = (R + wave::kBlockCols - 1) / wave::kBlockCols;
  int16_t* mc = BlockMax ? nullptr : a.maxcol + size_t(b) * R;
  int32_t* bmr =
      BlockMax ? a.blockmax + size_t(b) * nblk * (Dual ? 2 : 1) : nullptr;
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
          const bool take = Owned ? oc.own[col] != 0 : true;
          e = a.ref[col] | (take ? wave::kTake : 0);
        }
        ring[col & (wave::kRing - 1)] = e;
        __syncwarp();
      }
      const int ent = ent_next;
      ent_next = ring[(s + 1 - t) & (wave::kRing - 1)];
      wave32::step<KT, Quirk, Dual>(r, c, ent, s - t, t, K, L, rl, pen);
      // lane 31: column c31 is complete (before column 0: co = 0)
      const int c31 = s - 31;
      if constexpr (BlockMax) {
        if (c31 < vmax) {
          bm = max(bm, c.co);
          if constexpr (Dual) bw = max(bw, c.wo);
        }
        // c31 = u mod 8 (s8 = 7 mod 8): a block ends only at u = 7
        if (u == wave::kUnroll - 1 &&
            (c31 & (wave::kBlockCols - 1)) == wave::kBlockCols - 1 &&
            c31 < R) {
          const int blk = c31 / wave::kBlockCols;
          if (t == 31) {
            bmr[blk] = bm;
            if constexpr (Dual) bmr[nblk + blk] = bw;
          }
          bm = bw = 0;
        }
      } else {
        const unsigned cl = unsigned(min(c.co, 32767));
        if (u & 1) {
          buf[u >> 1] = __byte_perm(prev, cl, 0x5410);
        } else {
          prev = cl;
        }
        if (u == wave::kUnroll - 1 && t == 31) {
          const int c0 = c31 - (wave::kUnroll - 1);
          if (c0 >= 0 && c0 + wave::kUnroll <= R && vec16) {
            *reinterpret_cast<uint4*>(mc + c0) =
                make_uint4(buf[0], buf[1], buf[2], buf[3]);
          } else {
#pragma unroll
            for (int i = 0; i < wave::kUnroll; ++i) {
              const int cc = c0 + i;
              if (cc >= 0 && cc < R)
                mc[cc] = int16_t(buf[i >> 1] >> (16 * (i & 1)));
            }
          }
        }
      }
    }
  }
  if constexpr (BlockMax) {  // the last, partial block
    if ((R & (wave::kBlockCols - 1)) && t == 31) {
      bmr[nblk - 1] = bm;
      if constexpr (Dual) bmr[2 * nblk - 1] = bw;
    }
  }
  const wave::Best best = wave::merge_best(c.v, c.vc, c.jr, L, rl);
  if (t == 0) {
    a.score[b] = best.score;
    a.end_ref[b] = Owned && best.col >= 0 ? oc.idx[best.col] : best.col;
    a.end_read[b] = best.row;
  }
}

template <int KT, bool BlockMax, bool Quirk, bool Dual>
__global__ void sw_wave_i32_kernel(const W32Args a) {
  wave_i32_body<KT, BlockMax, Quirk, Dual, false>(a, sw::ColArgs{});
}

template <int KT, bool Quirk>
__global__ void sw_wave_i32_owned_kernel(const W32Args a,
                                         const sw::ColArgs c) {
  wave_i32_body<KT, false, Quirk, false, true>(a, c);
}

template <int KT, class Kern, class... Args>
int launch_kernel(Kern kern, const W32Args& a, cudaStream_t stream,
                  Args... more) {
  int wpb;
  size_t smem;
  wave::launch_shape(wave::warp_bytes(a.n1, a.L, KT > 0), &wpb, &smem);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  const int grid = (a.B + wpb - 1) / wpb;
  kern<<<grid, wpb * 32, smem, stream>>>(a, more...);
  return int(cudaGetLastError());
}

template <int KT>
int launch(const W32Args& a, bool quirk, cudaStream_t stream) {
  if (a.blockmax && a.wmask)
    return launch_kernel<KT>(sw_wave_i32_kernel<KT, true, false, true>, a,
                             stream);
  if (a.blockmax)
    return quirk ? launch_kernel<KT>(
                       sw_wave_i32_kernel<KT, true, true, false>, a, stream)
                 : launch_kernel<KT>(
                       sw_wave_i32_kernel<KT, true, false, false>, a, stream);
  return quirk ? launch_kernel<KT>(sw_wave_i32_kernel<KT, false, true, false>,
                                   a, stream)
               : launch_kernel<KT>(
                     sw_wave_i32_kernel<KT, false, false, false>, a, stream);
}

template <int KT>
int launch_owned(const W32Args& a, bool quirk, const sw::ColArgs& c,
                 cudaStream_t stream) {
  return quirk ? launch_kernel<KT>(sw_wave_i32_owned_kernel<KT, true>, a,
                                   stream, c)
               : launch_kernel<KT>(sw_wave_i32_owned_kernel<KT, false>, a,
                                   stream, c);
}

__host__ W32Args w32_args(const void* prof, const void* ref,
                          const void* read_len, const void* col_mask,
                          const void* seg_id, const void* seg_start, int B,
                          int n1, int L, int R, int gapO, int gapE,
                          void* score, void* end_ref, void* end_read,
                          void* maxcol, void* blockmax, int valid_len,
                          void* wmask, void* scratch) {
  W32Args a;
  a.prof = static_cast<const int8_t*>(prof);
  a.ref = static_cast<const int32_t*>(ref);
  a.read_len = static_cast<const int32_t*>(read_len);
  a.col_mask = static_cast<const uint8_t*>(col_mask);
  a.seg_id = static_cast<const int8_t*>(seg_id);
  a.seg_start = static_cast<const uint8_t*>(seg_start);
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
  a.scratch = static_cast<int32_t*>(scratch);
  return a;
}

}  // namespace

extern "C" {

// int32 scratch elements per read the launch needs (0: registers).
int sw_wave_i32_scratch_per_read(int L) {
  return sw::reg_k(L / 32) ? 0 : kPlanes * L;
}

// Returns the cudaError_t of the launch (0 on success).  Exactly one of
// maxcol (base mode) and blockmax (blockmax mode, with valid_len) is set;
// wmask (non-null: dual mode) needs blockmax and quirk 0.
// sw_forward_shared's arguments without the gate.
int sw_wave_shared_i32(const void* prof, const void* ref,
                       const void* read_len, const void* col_mask,
                       const void* seg_id, const void* seg_start, int B,
                       int n1, int L, int R, int gapO, int gapE, int quirk,
                       void* score, void* end_ref, void* end_read,
                       void* maxcol, void* blockmax, int valid_len,
                       void* wmask, void* scratch, void* stream) {
  if (B <= 0) return 0;
  if (wmask && (!blockmax || quirk)) return int(cudaErrorInvalidValue);
  if (n1 + 1 > 0xffff) return int(cudaErrorInvalidValue);
  const W32Args a = w32_args(prof, ref, read_len, col_mask, seg_id,
                             seg_start, B, n1, L, R, gapO, gapE, score,
                             end_ref, end_read, maxcol, blockmax, valid_len,
                             wmask, scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SW_DISPATCH_K(L / 32, launch, a, quirk != 0, s)
}

// The owned-column mode (base mode): sw_wave_shared_i32's arguments
// without blockmax and dual, plus idx (R,) int32 and own (R,) bool.
int sw_wave_shared_i32_owned(const void* prof, const void* ref,
                             const void* read_len, const void* col_mask,
                             const void* seg_id, const void* seg_start,
                             int B, int n1, int L, int R, int gapO, int gapE,
                             int quirk, void* score, void* end_ref,
                             void* end_read, void* maxcol, const void* idx,
                             const void* own, void* scratch, void* stream) {
  if (B <= 0) return 0;
  if (!maxcol || !idx || !own) return int(cudaErrorInvalidValue);
  if (n1 + 1 > 0xffff) return int(cudaErrorInvalidValue);
  const W32Args a = w32_args(prof, ref, read_len, col_mask, seg_id,
                             seg_start, B, n1, L, R, gapO, gapE, score,
                             end_ref, end_read, maxcol, nullptr, 0, nullptr,
                             scratch);
  const sw::ColArgs c{static_cast<const int32_t*>(idx),
                      static_cast<const uint8_t*>(own)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SW_DISPATCH_K(L / 32, launch_owned, a, quirk != 0, c, s)
}

const char* sw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
