// forward_shared: the batched SW forward DP of a read batch against one
// shared target, with per-column maxima (base mode) or per-256-column block
// maxima (blockmax mode), and first-strict-max tracking.
//
// Replaces the JAX package's Pallas kernel _forward_kernel in its base mode
// and in its blockmax/lanetrack mode (ssw_tpu/ops/pallas_sw.py, driven by
// _forward_call and wrapped by forward_shared_ref).  The TPU kernel walks a
// sequential grid of 256-column blocks over an (8, 128)-tiled batch in
// VMEM; here each read is one warp that walks every column itself, so
// nothing carries between blocks and no block-wide barrier is ever needed
// (see sw_dp.cuh for the layout and what bounds it).  This is the int32
// kernel; the int16 tier is sw_forward_i16.cu.
//
// The target codes are read 32 at a time by the warp, one coalesced load per
// lane, and broadcast per column with a shuffle; all warps read the same
// target, so it is served from L1/L2.  The
// per-column maxima are buffered across the warp's lanes and written as one
// coalesced 64-byte store per 32 columns, clipped to [0, 32767] (int16).
//
// Blockmax mode (template flag BlockMax) is the streaming suboptimal scan's
// input: no (B, R) buffer, but one int32 per 256 columns, the running max of
// the column maxima over the columns < valid_len (>= 0, not clipped: the
// composition in ops/subopt.py clips).  score/end_ref/end_read are those of
// the base mode on the same inputs.  The TPU's lanetrack trick (per-lane
// (value, column) trackers reduced once per block) exists to drop the
// per-column cross-lane reduce; here that reduce is one __reduce_max_sync
// at the end of the column's chain (sw_dp.cuh), and the mode keeps it: the
// best-column snapshot and end positions stay exactly the base mode's.
//
// Dual mode (template flag Dual, blockmax with the quirk off; the JAX
// kernel's dual-tier emission, pallas_sw.py:142-151, :405-412) emits both
// tiers' block maxima in one pass: channel 0 over col_mask (the byte tier's
// rows), channel 1 over wmask (the word tier's, a subset).  The TPU kernel
// reduces both masks across lanes; here max over lanes and max over columns
// commute, so each thread keeps one running max of its own wmask lanes over
// the block's columns < valid_len and the warp reduces it once per 256
// columns: K max ops per column and one reduce per block, off the column
// chain.  Output (B, 2, ceil(R/256)).
//
// Gate mode (template flag Gate, any of the modes above; ops/gate.py, the
// JAX kernel's bounded-radius gate pallas_sw.py:314-359): each column runs
// the depth of shuffle scan that the previous column's masked max admits
// (sw_dp.cuh has the exactness argument), and thread t <= 5 of the warp
// counts the columns run at depth t into the launch's histogram.  The
// outputs are the ungated kernel's.  The depth rides the column reduce the
// best-hit branch already waits on: a compare per lane, a ballot, and one
// switch per column over unrolled scans (sw_dp.cuh scan_depth), which on
// the config-4 leaf beat a chain of one branch per scan step where most
// columns take depth 0 and lost where most take depth 3 (PERF.md).
//
// Owned mode (template flag Owned, base mode only; the JAX package's
// forward_shared_ref_gated, pallas_sw.py:1039, whose kernel gates its best
// hit in base mode at :299-311) is the sequence-parallel shard's forward
// pass (parallel/dist.py): a shard runs halo warm-up columns before the
// columns it owns, and only owned columns may take a new best hit, whose
// end_ref is the column's global index.  idx/own come as a third kernel
// parameter (sw::ColArgs) of the owned instantiations, so that the other
// kernels' parameters and code stay as they were (their SASS is unchanged).
// They are loaded as the target codes are, one coalesced load per 32
// columns; own becomes a ballot (bit i: column i of the 32), so a column
// pays a shift and a predicate, and idx is shuffled only when the best hit
// moves.  Shuffling own every column instead cost 9 % on the config-4 leaf
// (leaf_timing.py, PERF.md).  Every column still emits its maximum and
// drives the gate.
//
// The quirk is a template flag too.  As a runtime bool it left nvcc to
// choose between a loop split on it and the quirk's shuffles behind
// per-step branches, and small edits flipped the choice.  On the config-4
// leaf (ssw_tpu_torch/leaf_timing.py; NVIDIA H100 80GB HBM3, 700 W) the
// template takes the base mode from 311 to 287 ms with the quirk off and
// from 388 to 309 ms with it on.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libsw_forward.so sw_forward.cu

#include "sw_dp.cuh"

namespace {

struct FwdArgs {
  const int8_t* prof;       // (B, n1, L)
  const int32_t* ref;       // (R,)
  const int32_t* read_len;  // (B,)
  const uint8_t* col_mask;  // (B, L) bool
  const int8_t* seg_id;     // (B, L)
  const uint8_t* seg_start; // (B, L) bool
  const uint8_t* wmask;     // (B, L) bool, dual mode: word-tier lanes
  int B, n1, L, R, gapO, gapE, quirk;
  int32_t* score;           // (B,)
  int32_t* end_ref;         // (B,)
  int32_t* end_read;        // (B,)
  int16_t* maxcol;          // (B, R), base mode
  int32_t* blockmax;        // (B, ceil(R/256)), blockmax mode; (B, 2, ...)
                            // in dual mode
  int valid_len;            // blockmax: columns < valid_len feed the maxima
  int32_t* scratch;         // (B, 7, L) for GlobRow, else null
};

// The kernel body; Owned (base mode only) is the owned-column mode.
template <int KT, bool BlockMax, bool Quirk, bool Dual, bool Gate, bool Owned>
__device__ __forceinline__ void forward_body(const FwdArgs a,
                                             const sw::GateArgs g,
                                             const sw::ColArgs c) {
  static_assert(!Dual || (BlockMax && !Quirk), "dual: blockmax, quirk off");
  static_assert(!Owned || !BlockMax, "owned: base mode only");
  extern __shared__ __align__(16) unsigned char smem[];
  const int wpb = blockDim.x >> 5, w = threadIdx.x >> 5, t = threadIdx.x & 31;
  const int b = blockIdx.x * wpb + w;
  if (b >= a.B) return;  // whole warps only; no block barriers below
  const int L = a.L, K = KT > 0 ? KT : a.L / 32;
  constexpr bool quirk = Quirk;
  const size_t row = size_t(b) * L;
  using Row = typename sw::RowSel<KT>::type;
  Row r;
  r.attach(smem + w * sw::warp_smem_bytes(a.n1, L, quirk),
           a.scratch ? a.scratch + size_t(b) * sw::kScratchPlanes * L
                     : nullptr,
           a.prof + row * a.n1, a.n1, L, t, quirk);
  sw::row_setup<KT>(r, K, t, a.col_mask + row, a.seg_id + row,
                    a.seg_start + row, quirk);

  // dual: this thread's word-tier lanes (bits for the register variant)
  const uint8_t* wrow = Dual ? a.wmask + row : nullptr;
  unsigned wbits = 0u;
  if constexpr (Dual && KT > 0) {
#pragma unroll
    for (int k = 0; k < KT; ++k)
      wbits |= unsigned(wrow[t * KT + k] != 0) << k;
  }
  int gmax = 0, end_ref = -1;
  int code_v = 0;
  int idx_v = 0;         // owned: this lane's column's global index
  unsigned own_bits = 0u;  // owned: bit i, column i of the 32 is owned
  int16_t mc_v = 0;
  int bm_run = 0;  // blockmax: running max of the current 256-column block
  int w_run = 0;   // dual: this thread's running max over its wmask lanes
  int hm = 0;      // gate: the previous column's masked max
  unsigned steps = 0;  // gate: this warp's columns at depth t
  const int lane_thr = Gate ? sw::gate_lane_thr(g, t) : 0;
  const int nblk = (a.R + sw::kBlockCols - 1) / sw::kBlockCols;
  int16_t* mc_row = BlockMax ? nullptr : a.maxcol + size_t(b) * a.R;
  int32_t* bm_row =
      BlockMax ? a.blockmax + size_t(b) * nblk * (Dual ? 2 : 1) : nullptr;
  for (int col = 0; col < a.R; ++col) {
    const int lane = col & 31;
    if (lane == 0) {
      const int cc = col + t;
      code_v = cc < a.R ? a.ref[cc] : 0;
      if constexpr (Owned) {
        idx_v = cc < a.R ? c.idx[cc] : -1;
        own_bits = __ballot_sync(sw::kFull, cc < a.R && c.own[cc]);
      }
    }
    const int code = __shfl_sync(sw::kFull, code_v, lane);
    const int depth = Gate ? sw::gate_depth(hm, lane_thr) : sw::kDepths;
    const int colmax = sw::dp_column<KT>(r, K, t, code, a.gapO, a.gapE,
                                         quirk, depth);
    if constexpr (Gate) {
      hm = colmax;  // every column, owned or not
      steps += depth == t;
    }
    bool own = true;
    if constexpr (Owned) own = (own_bits >> lane) & 1u;
    if (own && colmax > gmax) {  // warp-uniform
      gmax = colmax;
      end_ref = Owned ? __shfl_sync(sw::kFull, idx_v, lane) : col;
      sw::save_best<KT>(r, K);
    }
    if constexpr (BlockMax) {
      if (col < a.valid_len) {
        bm_run = max(bm_run, colmax);
        if constexpr (Dual) {
          const int KK = KT > 0 ? KT : K;
#pragma unroll
          for (int k = 0; k < KK; ++k) {
            const bool word = KT > 0 ? ((wbits >> k) & 1u) != 0
                                     : wrow[t * KK + k] != 0;
            if (word) w_run = max(w_run, r.H(k));
          }
        }
      }
      if ((col & (sw::kBlockCols - 1)) == sw::kBlockCols - 1 ||
          col == a.R - 1) {
        const int blk = col / sw::kBlockCols;
        if constexpr (Dual) {
          const int wmax = __reduce_max_sync(sw::kFull, w_run);
          if (t == 0) bm_row[nblk + blk] = wmax;
          w_run = 0;
        }
        if (t == 0) bm_row[blk] = bm_run;
        bm_run = 0;
      }
    } else {
      if (t == lane) mc_v = int16_t(min(colmax, 32767));
      if (lane == 31 || col == a.R - 1) {
        const int cc = (col & ~31) + t;
        if (cc <= col) mc_row[cc] = mc_v;
      }
    }
  }
  if constexpr (Gate) sw::gate_flush(g, t, steps);
  const int rl = a.read_len[b];
  const int er = sw::end_read_of<KT>(r, K, t, L, gmax, rl);
  if (t == 0) {
    a.score[b] = gmax;
    a.end_ref[b] = end_ref;
    a.end_read[b] = er;
  }
}

template <int KT, bool BlockMax, bool Quirk, bool Dual, bool Gate>
__global__ void sw_forward_kernel(const FwdArgs a, const sw::GateArgs g) {
  forward_body<KT, BlockMax, Quirk, Dual, Gate, false>(a, g, sw::ColArgs{});
}

template <int KT, bool Quirk, bool Gate>
__global__ void sw_forward_owned_kernel(const FwdArgs a, const sw::GateArgs g,
                                        const sw::ColArgs c) {
  forward_body<KT, false, Quirk, false, Gate, true>(a, g, c);
}

template <int KT, bool BlockMax, bool Quirk, bool Dual, bool Gate>
int launch_gated(const FwdArgs& a, const sw::GateArgs& g,
                 cudaStream_t stream) {
  int wpb;
  size_t smem;
  sw::launch_shape<KT>(a.n1, a.L, Quirk, &wpb, &smem);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sw_forward_kernel<KT, BlockMax, Quirk, Dual, Gate>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  const int grid = (a.B + wpb - 1) / wpb;
  sw_forward_kernel<KT, BlockMax, Quirk, Dual, Gate>
      <<<grid, wpb * 32, smem, stream>>>(a, g);
  return int(cudaGetLastError());
}

template <int KT, bool BlockMax, bool Quirk, bool Dual = false>
int launch_mode(const FwdArgs& a, const sw::GateArgs* g,
                cudaStream_t stream) {
  if (g) return launch_gated<KT, BlockMax, Quirk, Dual, true>(a, *g, stream);
  return launch_gated<KT, BlockMax, Quirk, Dual, false>(a, sw::GateArgs{},
                                                        stream);
}

template <int KT>
int launch(const FwdArgs& a, const sw::GateArgs* g, cudaStream_t stream) {
  if (a.blockmax && a.wmask)
    return launch_mode<KT, true, false, true>(a, g, stream);
  if (a.blockmax)
    return a.quirk ? launch_mode<KT, true, true>(a, g, stream)
                   : launch_mode<KT, true, false>(a, g, stream);
  return a.quirk ? launch_mode<KT, false, true>(a, g, stream)
                 : launch_mode<KT, false, false>(a, g, stream);
}

template <int KT, bool Quirk, bool Gate>
int launch_owned_gated(const FwdArgs& a, const sw::GateArgs& g,
                       const sw::ColArgs& c, cudaStream_t stream) {
  int wpb;
  size_t smem;
  sw::launch_shape<KT>(a.n1, a.L, Quirk, &wpb, &smem);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sw_forward_owned_kernel<KT, Quirk, Gate>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  const int grid = (a.B + wpb - 1) / wpb;
  sw_forward_owned_kernel<KT, Quirk, Gate>
      <<<grid, wpb * 32, smem, stream>>>(a, g, c);
  return int(cudaGetLastError());
}

template <int KT>
int launch_owned(const FwdArgs& a, const sw::GateArgs* g,
                 const sw::ColArgs& c, cudaStream_t stream) {
  const sw::GateArgs none{};
  if (a.quirk)
    return g ? launch_owned_gated<KT, true, true>(a, *g, c, stream)
             : launch_owned_gated<KT, true, false>(a, none, c, stream);
  return g ? launch_owned_gated<KT, false, true>(a, *g, c, stream)
           : launch_owned_gated<KT, false, false>(a, none, c, stream);
}

__host__ FwdArgs fwd_args(const void* prof, const void* ref,
                          const void* read_len, const void* col_mask,
                          const void* seg_id, const void* seg_start, int B,
                          int n1, int L, int R, int gapO, int gapE, int quirk,
                          void* score, void* end_ref, void* end_read,
                          void* maxcol, void* blockmax, int valid_len,
                          void* wmask, void* scratch) {
  FwdArgs a;
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
  a.quirk = quirk;
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

// int32 scratch elements per read the launch needs (0: register variant).
int sw_forward_scratch_per_read(int L) {
  return sw::reg_k(L / 32) ? 0 : sw::kScratchPlanes * L;
}

// Returns the cudaError_t of the launch (0 on success).  Exactly one of
// maxcol (base mode) and blockmax (blockmax mode, with valid_len) is set;
// wmask (non-null: dual mode) needs blockmax and quirk 0.  gate_thr
// (non-null: gate mode) is a host array of 5 int thresholds, gate_hist the
// device uint64[6] histogram the launch adds its steps to.
int sw_forward_shared(const void* prof, const void* ref, const void* read_len,
                      const void* col_mask, const void* seg_id,
                      const void* seg_start, int B, int n1, int L, int R,
                      int gapO, int gapE, int quirk, void* score,
                      void* end_ref, void* end_read, void* maxcol,
                      void* blockmax, int valid_len, void* wmask,
                      void* scratch, const void* gate_thr, void* gate_hist,
                      void* stream) {
  if (B <= 0) return 0;
  if (wmask && (!blockmax || quirk)) return int(cudaErrorInvalidValue);
  const FwdArgs a = fwd_args(prof, ref, read_len, col_mask, seg_id,
                             seg_start, B, n1, L, R, gapO, gapE, quirk, score,
                             end_ref, end_read, maxcol, blockmax, valid_len,
                             wmask, scratch);
  if (gate_thr && !gate_hist) return int(cudaErrorInvalidValue);
  const sw::GateArgs g = sw::gate_args(gate_thr, gate_hist);
  const sw::GateArgs* gp = gate_thr ? &g : nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SW_DISPATCH_K(L / 32, launch, a, gp, s)
}

// The owned-column mode (base mode): sw_forward_shared's arguments without
// blockmax and dual, plus idx (R,) int32 and own (R,) bool.
int sw_forward_shared_owned(const void* prof, const void* ref,
                            const void* read_len, const void* col_mask,
                            const void* seg_id, const void* seg_start, int B,
                            int n1, int L, int R, int gapO, int gapE,
                            int quirk, void* score, void* end_ref,
                            void* end_read, void* maxcol, const void* idx,
                            const void* own, void* scratch,
                            const void* gate_thr, void* gate_hist,
                            void* stream) {
  if (B <= 0) return 0;
  if (!maxcol || !idx || !own) return int(cudaErrorInvalidValue);
  const FwdArgs a = fwd_args(prof, ref, read_len, col_mask, seg_id,
                             seg_start, B, n1, L, R, gapO, gapE, quirk, score,
                             end_ref, end_read, maxcol, nullptr, 0, nullptr,
                             scratch);
  if (gate_thr && !gate_hist) return int(cudaErrorInvalidValue);
  const sw::GateArgs g = sw::gate_args(gate_thr, gate_hist);
  const sw::GateArgs* gp = gate_thr ? &g : nullptr;
  const sw::ColArgs c{static_cast<const int32_t*>(idx),
                      static_cast<const uint8_t*>(own)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SW_DISPATCH_K(L / 32, launch_owned, a, gp, c, s)
}

const char* sw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
