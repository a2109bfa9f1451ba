// forward_shared_packed: the SW forward DP of LANE-PACKED reads against one
// shared target, in blockmax mode (per-256-column block maxima), int32.
//
// Replaces the packed mode of the JAX package's Pallas kernel _forward_kernel
// (ssw_tpu/ops/pallas_sw.py: slot bias and h_diag cut :214-248, per-slot
// block maxima :381-404, set-up in _forward_call :445-481, wrapper
// forward_shared_ref_packed :1139), and its packed dual mode.  Its input is
// the packed layout: profile rows (n_rows, n1, W) over the packed read codes
// (common.pack_codes), the slot tables so/sl/rl_s (n_rows, S)
// (common.pack_tables) and each read's flat_idx = row * S + slot.  Its
// outputs are forward_shared_ref_packed's: per read score, end_ref, end_read
// and block maxima (B, nblk), or (B, 2, nblk) in dual mode.
//
// Layout.  On the TPU a packed row fills the 128-lane vector registers with
// several reads, and the slot bias, the h_diag cut and the decay restart
// keep the reads of one row apart inside one segmented prefix-max scan.  On
// the H100 the per-column dependent chain of shuffles, not lanes, sets the
// pace of the forward kernels (a whole 1024-read leaf takes ~280 ns per
// column whether a warp holds one read or two: PERF.md), so one warp per
// packed row (S reads, W/32 lanes per thread) would lengthen that chain S
// times and divide the warps in flight by S.  This kernel splits each row at
// its slot boundaries instead, one warp per slot: the slot cut makes carries
// across a boundary inert by construction, so a slot's lanes compute
// exactly what they compute inside the packed row, and a warp needs no slot
// bias.  Warp b reads its slot's lanes [so, so + sl) of the packed profile
// row into shared memory (lanes past sl read the virtual letter's zero
// row); lane j of the warp is the slot's lane_off j, so the gap decay
// restarts at the slot's first lane, h_diag is cut and F poisoned there
// (the warp's lane 0 gets carry 0 and prefix -inf, as in sw_dp.cuh).  The
// warp spans Lw = 32*K lanes, K the smallest register variant that holds
// the longest slot (GlobRow past 1024 lanes).
//
// Per-slot best hit and block maxima: col_mask is the slot's span (j < sl),
// the word channel wcol is j < min(sl, round_up(rl, 8)); the column max is
// the warp's __reduce_max_sync, the best-column snapshot and the block
// running max are sw_forward.cu's blockmax mode, and the word channel is a
// per-thread running max reduced once per 256 columns (sw_forward.cu's dual
// mode).  Only columns < valid_len feed the trackers and the maxima (the
// TPU kernel's `own` gate); the kernel stops there and writes 0 for the
// blocks past it.  The quirk's lane-block scan (nb = 16 byte / 8 word blocks
// of sl/nb lanes, pallas_sw.py:1101) biases block q by q * QBUMP; the
// wrapper enforces the same span guard as the JAX package, so the results
// are those of its two-level (slot, block) bias.
//
// What bounds it: as sw_forward.cu, integer ALU work and the shuffle chain.
// A read costs what it costs unpacked at a lane width of 32*K >= its slot.
//
// Gate mode (template flag Gate; ops/gate.py, sw_dp.cuh): the slot warp's
// columns run the scan depth its previous masked column max admits, with
// thresholds for its K lanes per thread against the slot bound, and the
// warp counts its columns by depth, as in sw_forward.cu.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libsw_forward_packed.so sw_forward_packed.cu

#include "sw_dp.cuh"

namespace {

constexpr int kQBump = (1 << 17) / 16;  // ops/pack.py QBUMP

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
  int32_t* scratch;         // GlobRow: per read 7*Lw planes + the profile
};

// The warp's slot profile, [code][k][lane] in shared memory (RegRow).
template <int KT>
__device__ __forceinline__ void attach_slot(sw::RegRow<KT>& r,
                                            unsigned char* wsm, int*,
                                            const int8_t* prow, int W, int o,
                                            int ln, int n1, int Lw, int t,
                                            bool quirk) {
  r.L = Lw;
  r.cm = r.rst = 0u;
  int8_t* sp = reinterpret_cast<int8_t*>(wsm);
  for (int i = t; i < n1 * Lw; i += 32) {
    const int code = i / Lw, j = i - code * Lw;
    const int tt = j / KT, k = j - tt * KT;
    sp[code * Lw + k * 32 + tt] = j < ln ? prow[size_t(code) * W + o + j] : 0;
  }
  r.prof = sp + t;
  if (quirk) {
    int* s = reinterpret_cast<int*>(wsm + sw::align16(size_t(n1) * Lw));
    r.sb = s + t;
    r.sbp = s + Lw + t;
  }
  __syncwarp();
}

// The same in the read's global scratch row (GlobRow): planes, then the
// profile [code][j].
__device__ __forceinline__ void attach_slot(sw::GlobRow& r, unsigned char*,
                                            int* srow, const int8_t* prow,
                                            int W, int o, int ln, int n1,
                                            int Lw, int t, bool) {
  int8_t* pb = reinterpret_cast<int8_t*>(srow + sw::kScratchPlanes * Lw);
  for (int i = t; i < n1 * Lw; i += 32) {
    const int code = i / Lw, j = i - code * Lw;
    pb[i] = j < ln ? prow[size_t(code) * W + o + j] : 0;
  }
  r.L = Lw;
  r.K = Lw / 32;
  r.t = t;
  r.s = srow + t;
  r.prof = pb;
  __syncwarp();
}

template <int KT, bool Quirk, bool Dual, bool Gate>
__global__ void sw_forward_packed_kernel(const PackArgs a,
                                         const sw::GateArgs g) {
  static_assert(!(Dual && Quirk), "dual needs the quirk off");
  extern __shared__ __align__(16) unsigned char smem[];
  const int wpb = blockDim.x >> 5, w = threadIdx.x >> 5, t = threadIdx.x & 31;
  const int b = blockIdx.x * wpb + w;
  if (b >= a.B) return;  // whole warps only; no block barriers below
  const int Lw = a.Lw, K = KT > 0 ? KT : Lw / 32;
  const int KK = KT > 0 ? KT : K;
  const int fi = a.flat_idx[b];
  const int row = fi / a.S;
  const int o = a.so[fi], ln = a.sl[fi], rl = a.rl_s[fi];
  const int wend = min(ln, (rl + 7) / 8 * 8);  // word-tier span (wcol)
  using Row = typename sw::RowSel<KT>::type;
  Row r;
  int* srow = a.scratch
                  ? a.scratch + size_t(b) * (sw::kScratchPlanes * Lw +
                                             (a.n1 * Lw + 3) / 4)
                  : nullptr;
  attach_slot(r, smem + w * sw::warp_smem_bytes(a.n1, Lw, Quirk), srow,
              a.prof + size_t(row) * a.n1 * a.W, a.W, o, ln, a.n1, Lw, t,
              Quirk);
  unsigned wbits = 0u;  // dual: this thread's word-tier lanes
  const int sl1 = max(ln, 1);
#pragma unroll
  for (int k = 0; k < KK; ++k) {
    const int j = t * KK + k;
    r.H(k) = 0;
    r.E(k) = 0;
    r.HB(k) = 0;
    const int q = min(j * a.nb / sl1, a.nb - 1);
    const int qp = j > 0 ? min((j - 1) * a.nb / sl1, a.nb - 1) : -1;
    r.set_lane(k, j < ln, j == 0 || qp != q, q * kQBump,
               j > 0 ? qp * kQBump : 0, Quirk);
    if (KT > 0) wbits |= unsigned(j < wend) << k;  // GlobRow: per column
  }

  int gmax = 0, end_ref = -1, code_v = 0;
  int bm_run = 0, w_run = 0;
  int hm = 0;          // gate: the previous column's masked max
  unsigned steps = 0;  // gate: this warp's columns at depth t
  const int lane_thr = Gate ? sw::gate_lane_thr(g, t) : 0;
  const int nblk = (a.R + sw::kBlockCols - 1) / sw::kBlockCols;
  const int vl = min(a.valid_len, a.R);
  int32_t* bm_row = a.blockmax + size_t(b) * nblk * (Dual ? 2 : 1);
  for (int col = 0; col < vl; ++col) {
    const int lane = col & 31;
    if (lane == 0) {
      const int cc = col + t;
      code_v = cc < vl ? a.ref[cc] : 0;
    }
    const int code = __shfl_sync(sw::kFull, code_v, lane);
    const int depth = Gate ? sw::gate_depth(hm, lane_thr) : sw::kDepths;
    const int colmax = sw::dp_column<KT>(r, K, t, code, a.gapO, a.gapE,
                                         Quirk, depth);
    if constexpr (Gate) {
      hm = colmax;
      steps += depth == t;
    }
    if (colmax > gmax) {  // warp-uniform
      gmax = colmax;
      end_ref = col;
      sw::save_best<KT>(r, K);
    }
    bm_run = max(bm_run, colmax);
    if constexpr (Dual) {
#pragma unroll
      for (int k = 0; k < KK; ++k) {
        const bool word = KT > 0 ? ((wbits >> k) & 1u) != 0
                                 : t * KK + k < wend;
        if (word) w_run = max(w_run, r.H(k));
      }
    }
    if ((col & (sw::kBlockCols - 1)) == sw::kBlockCols - 1 || col == vl - 1) {
      const int blk = col / sw::kBlockCols;
      if constexpr (Dual) {
        const int wmax = __reduce_max_sync(sw::kFull, w_run);
        if (t == 0) bm_row[nblk + blk] = wmax;
        w_run = 0;
      }
      if (t == 0) bm_row[blk] = bm_run;
      bm_run = 0;
    }
  }
  if constexpr (Gate) sw::gate_flush(g, t, steps);
  // blocks past valid_len get no column
  for (int blk = (vl + sw::kBlockCols - 1) / sw::kBlockCols + t; blk < nblk;
       blk += 32) {
    bm_row[blk] = 0;
    if (Dual) bm_row[nblk + blk] = 0;
  }
  const int er = sw::end_read_of<KT>(r, K, t, Lw, gmax, rl);
  if (t == 0) {
    a.score[b] = gmax;
    a.end_ref[b] = end_ref;
    a.end_read[b] = er;
  }
}

template <int KT, bool Quirk, bool Dual, bool Gate>
int launch_gated(const PackArgs& a, const sw::GateArgs& g,
                 cudaStream_t stream) {
  int wpb;
  size_t smem;
  sw::launch_shape<KT>(a.n1, a.Lw, Quirk, &wpb, &smem);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sw_forward_packed_kernel<KT, Quirk, Dual, Gate>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  const int grid = (a.B + wpb - 1) / wpb;
  sw_forward_packed_kernel<KT, Quirk, Dual, Gate>
      <<<grid, wpb * 32, smem, stream>>>(a, g);
  return int(cudaGetLastError());
}

template <int KT, bool Quirk, bool Dual>
int launch_mode(const PackArgs& a, const sw::GateArgs* g,
                cudaStream_t stream) {
  if (g) return launch_gated<KT, Quirk, Dual, true>(a, *g, stream);
  return launch_gated<KT, Quirk, Dual, false>(a, sw::GateArgs{}, stream);
}

template <int KT>
int launch(const PackArgs& a, const sw::GateArgs* g, bool quirk, bool dual,
           cudaStream_t stream) {
  if (dual) return launch_mode<KT, false, true>(a, g, stream);
  return quirk ? launch_mode<KT, true, false>(a, g, stream)
               : launch_mode<KT, false, false>(a, g, stream);
}

}  // namespace

extern "C" {

// int32 scratch elements per read the launch needs (0: register variant).
int sw_forward_packed_scratch_per_read(int Lw, int n1) {
  return sw::reg_k(Lw / 32) ? 0
                            : sw::kScratchPlanes * Lw + (n1 * Lw + 3) / 4;
}

// Returns the cudaError_t of the launch (0 on success).  Lw: lanes per warp
// (a multiple of 32 >= every slot length); nb: quirk lane blocks per slot
// (16 byte tier, 8 word); dual needs quirk 0.  gate_thr/gate_hist: as
// sw_forward.cu's sw_forward_shared.
int sw_forward_packed(const void* prof, const void* ref, const void* so,
                      const void* sl, const void* rl_s, const void* flat_idx,
                      int B, int n1, int W, int S, int Lw, int R,
                      int valid_len, int gapO, int gapE, int quirk, int nb,
                      int dual, void* score, void* end_ref, void* end_read,
                      void* blockmax, void* scratch, const void* gate_thr,
                      void* gate_hist, void* stream) {
  if (B <= 0) return 0;
  if (dual && quirk) return int(cudaErrorInvalidValue);
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
  if (gate_thr && !gate_hist) return int(cudaErrorInvalidValue);
  const sw::GateArgs g = sw::gate_args(gate_thr, gate_hist);
  const sw::GateArgs* gp = gate_thr ? &g : nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SW_DISPATCH_K(Lw / 32, launch, a, gp, quirk != 0, dual != 0, s)
}

const char* sw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
