// forward_perread as an anti-diagonal wavefront (sw_wave.cuh): the SW
// forward DP of every read over a reference window of its own (refw (B,
// W)), with the reference's terminate-at-score1 column-loop break (ref:
// src/ssw.c:339-341, 918-930) and optional per-column maxima, the quirk
// off or on.  It carries the begin-finding reverse pass and the streaming
// suboptimal scan's window re-runs.  sw_perread.cu keeps the column-scan
// body of the same function (scan_body=True in ops/cuda_sw.py).
//
// Replaces the JAX package's Pallas kernel _perread_kernel
// (ssw_tpu/ops/pallas_sw.py:819, terminate :899-906, pallas_call at :963,
// wrapper forward_perread_ref :973).  Inputs and outputs are
// sw_perread.cu's.
//
// Layout: sw_wave_i32.cuh, shared with sw_wave_i32.cu (one warp per read,
// lane t at column s - t at step s, the quirk as the restarted G chain
// under the conditions stated there; the wrapper sends a launch outside
// them to sw_perread.cu).  The 64-entry code ring is filled from the
// read's own window row refw[b] instead of a shared target.
//
// terminate.  The reference rule: a column updates the best only while
// no earlier column's masked max equalled term[b], and only when it beats
// the best so far; without emit_maxcol nothing after that column (c_T) is
// observable.  Column c's maximum is complete only at lane 31, at step
// c + 31, when lanes 0..30 have already run up to 31 columns past it, and
// their trackers may have taken a later, larger value.  So:
//   * lane 31 walks the column maxima in order and keeps the reference's
//     rule itself: c_T, the first column whose maximum equals term[b], and
//     g_T, the running max of the maxima up to and including c_T;
//   * without emit_maxcol the warp stops at the end of the 8-step trip in
//     which lane 31 saw c_T;
//   * after the loop the warp merges the lanes' trackers as the forward
//     kernel does.  When the merged score equals g_T, no tracker rose past
//     g_T after c_T: the lanes that held g_T at the first column reaching
//     it (c* <= c_T) are intact, a later tie has a later column, and the
//     merge gives the column scan's (score, end_ref, end_read) exactly;
//   * otherwise (a column past c_T, inside the lag or, with emit_maxcol,
//     anywhere after it, beat g_T) the warp runs the DP again from column
//     0 with the best-hit bit only on columns <= c_T and stops at step
//     c_T + 31: exact whatever the later columns hold.  The reverse pass
//     never takes it when every maximum of the window is at most score1,
//     and the window re-runs pass no terminate.
//
// What bounds it: integer issue and the step's loop-carried chain
// (sw_wave.cuh), plus a 31-step ramp per window, about 10 % at W = 320.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libsw_wave_perread.so sw_wave_perread.cu

#include <climits>

#include "sw_wave_i32.cuh"

namespace {

using wave32::kPlanes;
using wave32::Op;
constexpr int kNone = INT_MAX;    // no terminate column (yet)

struct WRevArgs {
  const int8_t* prof;        // (B, n1, L)
  const int32_t* refw;       // (B, W)
  const int32_t* term;       // (B,) or null (= -1, never)
  const int32_t* read_len;   // (B,)
  const uint8_t* col_mask;   // (B, L) bool
  const int8_t* seg_id;      // (B, L)
  const uint8_t* seg_start;  // (B, L) bool
  int B, n1, L, W, gapO, gapE;
  int32_t* score;            // (B,)
  int32_t* end_ref;          // (B,)
  int32_t* end_read;         // (B,)
  int32_t* maxcol;           // (B, W) or null
  int32_t* scratch;          // (B, 5, L) for the global row, else null
};

// One pass of the wavefront over the window.  Columns < take_end may take
// a best hit.  First pass: lane 31 finds c_T and g_T (cT, gT), Emit
// stores the column maxima, and without Emit the warp stops in the trip in
// which c_T is found.  The re-run (First = false) stops after step
// take_end + 30, the last at which a column < take_end is computed.
template <int KT, bool Quirk, bool First, bool Emit, class Row>
__device__ __forceinline__ void perread_pass(
    Row& r, const int* rw, int* ring, int32_t* mc, int W, int take_end,
    int term, int K, int L, int n1, int rl, int t, const wave::Pen<Op>& pen,
    wave32::Lane& c, int& cT, int& gT) {
  const int KK = KT > 0 ? KT : K;
#pragma unroll
  for (int k = 0; k < KK; ++k) r.H(k) = r.E(k) = 0;
  c.reset(L);
  const int poison = n1;
  __syncwarp();
  ring[32 + t] = poison;
  __syncwarp();
  int ent_next = ring[(-1 - t) & (wave::kRing - 1)];
  int buf[wave::kUnroll];  // lane 31: 8 columns of maxima
  const bool vec16 = (W & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(mc) & 15) == 0;
  const int steps = First ? W + 31 : take_end + 31;
  for (int s8 = -1; s8 < steps; s8 += wave::kUnroll) {
#pragma unroll
    for (int u = 0; u < wave::kUnroll; ++u) {
      const int s = s8 + u;
      if (u == 0 && (s8 & 31) == 31) {  // the next 32 columns into the ring
        __syncwarp();
        const int col = s8 + 1 + t;
        ring[col & (wave::kRing - 1)] =
            col < W ? rw[col] | (col < take_end ? wave::kTake : 0) : poison;
        __syncwarp();
      }
      const int ent = ent_next;
      ent_next = ring[(s + 1 - t) & (wave::kRing - 1)];
      wave32::step<KT, Quirk, false>(r, c, ent, s - t, t, K, L, rl, pen);
      const int c31 = s - 31;
      if constexpr (First) {
        // lane 31: the reference's rule over the complete column maxima
        if (c31 >= 0 && c31 < W && cT == kNone) {
          gT = max(gT, c.co);
          if (c.co == term) cT = c31;
        }
        if constexpr (Emit) {
          buf[u] = c.co;
          if (u == wave::kUnroll - 1 && t == 31) {
            const int c0 = c31 - (wave::kUnroll - 1);
            if (c0 >= 0 && c0 + wave::kUnroll <= W && vec16) {
              *reinterpret_cast<int4*>(mc + c0) =
                  make_int4(buf[0], buf[1], buf[2], buf[3]);
              *reinterpret_cast<int4*>(mc + c0 + 4) =
                  make_int4(buf[4], buf[5], buf[6], buf[7]);
            } else {
#pragma unroll
              for (int i = 0; i < wave::kUnroll; ++i) {
                const int cc = c0 + i;
                if (cc >= 0 && cc < W) mc[cc] = buf[i];
              }
            }
          }
        }
      }
    }
    if constexpr (First && !Emit) {
      if (__shfl_sync(wave::kFull, cT, 31) != kNone) break;
    }
  }
}

template <int KT, bool Quirk, bool Emit>
__global__ void sw_wave_perread_kernel(const WRevArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int wpb = blockDim.x >> 5, w = threadIdx.x >> 5, t = threadIdx.x & 31;
  const int b = blockIdx.x * wpb + w;
  if (b >= a.B) return;  // whole warps only; no block barriers below
  const int L = a.L, W = a.W, n1 = a.n1;
  const int K = KT > 0 ? KT : L / 32;
  const size_t row = size_t(b) * L;
  unsigned char* wsm = smem + size_t(w) * wave::warp_bytes(n1, L, KT > 0);
  int* ring = wave32::ring_of(wsm, n1, L, KT > 0);
  typename wave32::RowSel<KT, false>::type r;
  r.attach(wsm, a.scratch ? a.scratch + size_t(b) * kPlanes * L : nullptr,
           a.prof + row * n1, n1, L, t);
  wave32::set_geometry<KT, Quirk, false>(r, K, t, a.col_mask + row, nullptr,
                                         a.seg_id + row, a.seg_start + row);
  const int rl = a.read_len[b];
  const int term = a.term ? a.term[b] : -1;
  const int* rw = a.refw + size_t(b) * W;
  int32_t* mc = Emit ? a.maxcol + size_t(b) * W : nullptr;

  wave::Pen<Op> pen;
  pen.nO = -a.gapO;
  pen.nE = -a.gapE;
  pen.neg = wave::kNeg;
  wave32::Lane c;
  int cT = kNone, gT = 0;
  perread_pass<KT, Quirk, true, Emit>(r, rw, ring, mc, W, W, term, K, L, n1,
                                      rl, t, pen, c, cT, gT);
  wave::Best best = wave::merge_best(c.v, c.vc, c.jr, L, rl);
  cT = __shfl_sync(wave::kFull, cT, 31);
  gT = __shfl_sync(wave::kFull, gT, 31);
  if (best.score != gT) {  // a tracker rose past g_T after c_T
    int unused_c = kNone, unused_g = 0;
    perread_pass<KT, Quirk, false, false>(r, rw, ring, nullptr, W,
                                          min(cT, W - 1) + 1, term, K, L, n1,
                                          rl, t, pen, c, unused_c, unused_g);
    best = wave::merge_best(c.v, c.vc, c.jr, L, rl);
  }
  if (t == 0) {
    a.score[b] = best.score;
    a.end_ref[b] = best.col;
    a.end_read[b] = best.row;
  }
}

template <int KT, bool Quirk, bool Emit>
int launch_mode(const WRevArgs& a, cudaStream_t stream) {
  int wpb;
  size_t smem;
  wave::launch_shape(wave::warp_bytes(a.n1, a.L, KT > 0), &wpb, &smem);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sw_wave_perread_kernel<KT, Quirk, Emit>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  const int grid = (a.B + wpb - 1) / wpb;
  sw_wave_perread_kernel<KT, Quirk, Emit>
      <<<grid, wpb * 32, smem, stream>>>(a);
  return int(cudaGetLastError());
}

template <int KT>
int launch(const WRevArgs& a, bool quirk, cudaStream_t stream) {
  const bool emit = a.maxcol != nullptr;
  if (quirk)
    return emit ? launch_mode<KT, true, true>(a, stream)
                : launch_mode<KT, true, false>(a, stream);
  return emit ? launch_mode<KT, false, true>(a, stream)
              : launch_mode<KT, false, false>(a, stream);
}

}  // namespace

extern "C" {

// int32 scratch elements per read the launch needs (0: registers).
int sw_wave_perread_scratch_per_read(int L) {
  return sw::reg_k(L / 32) ? 0 : kPlanes * L;
}

// Returns the cudaError_t of the launch (0 on success).  sw_forward_perread's
// arguments.
int sw_wave_perread(const void* prof, const void* refw, const void* term,
                    const void* read_len, const void* col_mask,
                    const void* seg_id, const void* seg_start, int B, int n1,
                    int L, int W, int gapO, int gapE, int quirk, void* score,
                    void* end_ref, void* end_read, void* maxcol,
                    void* scratch, void* stream) {
  if (B <= 0) return 0;
  if (n1 + 1 > 0xffff) return int(cudaErrorInvalidValue);
  WRevArgs a;
  a.prof = static_cast<const int8_t*>(prof);
  a.refw = static_cast<const int32_t*>(refw);
  a.term = static_cast<const int32_t*>(term);
  a.read_len = static_cast<const int32_t*>(read_len);
  a.col_mask = static_cast<const uint8_t*>(col_mask);
  a.seg_id = static_cast<const int8_t*>(seg_id);
  a.seg_start = static_cast<const uint8_t*>(seg_start);
  a.B = B;
  a.n1 = n1;
  a.L = L;
  a.W = W;
  a.gapO = gapO;
  a.gapE = gapE;
  a.score = static_cast<int32_t*>(score);
  a.end_ref = static_cast<int32_t*>(end_ref);
  a.end_read = static_cast<int32_t*>(end_read);
  a.maxcol = static_cast<int32_t*>(maxcol);
  a.scratch = static_cast<int32_t*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SW_DISPATCH_K(L / 32, launch, a, quirk != 0, s)
}

const char* sw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
