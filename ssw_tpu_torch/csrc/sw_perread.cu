// forward_perread: the same SW forward DP over a reference window of its own
// for every read (refw (B, W)), with the reference's terminate-at-score1
// column-loop break (ref: src/ssw.c:339-341, 918-930) and optional
// per-column maxima.  It carries the begin-finding reverse pass.
//
// Replaces the JAX package's Pallas kernel _perread_kernel (driven by
// _perread_call, wrapped by forward_perread_ref in
// ssw_tpu/ops/pallas_sw.py).  The TPU version gathers the substitution rows
// (B, W*L) int8 outside the kernel and streams them in; here the warp reads
// its window's codes 32 at a time (one coalesced load per lane, a shuffle
// per column) and looks each row up in the read's profile in shared memory,
// so no (B, W, L) tensor is ever materialised.
//
// terminate: after the column whose masked max equals terminate[b], no new
// best is recorded (that column's own update happens first).  Without
// emit_maxcol nothing after that column is observable, so the warp stops
// there, as the reference's loop does.  emit_maxcol writes the (B, W) int32
// per-column maxima (>= 0, unclamped) and runs every column.
//
// What bounds it: as sw_forward.cu (integer ALU work and shuffle latency;
// see sw_dp.cuh).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libsw_perread.so sw_perread.cu

#include "sw_dp.cuh"

namespace {

struct RevArgs {
  const int8_t* prof;       // (B, n1, L)
  const int32_t* refw;      // (B, W)
  const int32_t* term;      // (B,) or null (= -1, never)
  const int32_t* read_len;  // (B,)
  const uint8_t* col_mask;  // (B, L) bool
  const int8_t* seg_id;     // (B, L)
  const uint8_t* seg_start; // (B, L) bool
  int B, n1, L, W, gapO, gapE, quirk;
  int32_t* score;           // (B,)
  int32_t* end_ref;         // (B,)
  int32_t* end_read;        // (B,)
  int32_t* maxcol;          // (B, W) or null
  int32_t* scratch;         // (B, 7, L) for GlobRow, else null
};

template <int KT>
__global__ void sw_perread_kernel(const RevArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int wpb = blockDim.x >> 5, w = threadIdx.x >> 5, t = threadIdx.x & 31;
  const int b = blockIdx.x * wpb + w;
  if (b >= a.B) return;  // whole warps only; no block barriers below
  const int L = a.L, K = KT > 0 ? KT : a.L / 32;
  const bool quirk = a.quirk != 0;
  const size_t row = size_t(b) * L;
  using Row = typename sw::RowSel<KT>::type;
  Row r;
  r.attach(smem + w * sw::warp_smem_bytes(a.n1, L, quirk),
           a.scratch ? a.scratch + size_t(b) * sw::kScratchPlanes * L
                     : nullptr,
           a.prof + row * a.n1, a.n1, L, t, quirk);
  sw::row_setup<KT>(r, K, t, a.col_mask + row, a.seg_id + row,
                    a.seg_start + row, quirk);

  const int32_t* rw = a.refw + size_t(b) * a.W;
  int32_t* mc_row = a.maxcol ? a.maxcol + size_t(b) * a.W : nullptr;
  const int term = a.term ? a.term[b] : -1;
  int gmax = 0, end_ref = -1, code_v = 0, mc_v = 0;
  bool done = false;
  for (int col = 0; col < a.W; ++col) {
    const int lane = col & 31;
    if (lane == 0) {
      const int cc = col + t;
      code_v = cc < a.W ? rw[cc] : 0;
    }
    const int code = __shfl_sync(sw::kFull, code_v, lane);
    const int colmax = sw::dp_column<KT>(r, K, t, code, a.gapO, a.gapE,
                                         quirk);
    if (!done && colmax > gmax) {  // warp-uniform
      gmax = colmax;
      end_ref = col;
      sw::save_best<KT>(r, K);
    }
    done = done || colmax == term;
    if (mc_row) {
      if (t == lane) mc_v = colmax;
      if (lane == 31 || col == a.W - 1) {
        const int cc = (col & ~31) + t;
        if (cc <= col) mc_row[cc] = mc_v;
      }
    } else if (done) {
      break;
    }
  }
  const int rl = a.read_len[b];
  const int er = sw::end_read_of<KT>(r, K, t, L, gmax, rl);
  if (t == 0) {
    a.score[b] = gmax;
    a.end_ref[b] = end_ref;
    a.end_read[b] = er;
  }
}

template <int KT>
int launch(const RevArgs& a, cudaStream_t stream) {
  int wpb;
  size_t smem;
  sw::launch_shape<KT>(a.n1, a.L, a.quirk != 0, &wpb, &smem);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sw_perread_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (e != cudaSuccess) return int(e);
  }
  const int grid = (a.B + wpb - 1) / wpb;
  sw_perread_kernel<KT><<<grid, wpb * 32, smem, stream>>>(a);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// int32 scratch elements per read the launch needs (0: register variant).
int sw_perread_scratch_per_read(int L) {
  return sw::reg_k(L / 32) ? 0 : sw::kScratchPlanes * L;
}

// Returns the cudaError_t of the launch (0 on success).
int sw_forward_perread(const void* prof, const void* refw, const void* term,
                       const void* read_len, const void* col_mask,
                       const void* seg_id, const void* seg_start, int B,
                       int n1, int L, int W, int gapO, int gapE, int quirk,
                       void* score, void* end_ref, void* end_read,
                       void* maxcol, void* scratch, void* stream) {
  if (B <= 0) return 0;
  RevArgs a;
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
  a.quirk = quirk;
  a.score = static_cast<int32_t*>(score);
  a.end_ref = static_cast<int32_t*>(end_ref);
  a.end_read = static_cast<int32_t*>(end_read);
  a.maxcol = static_cast<int32_t*>(maxcol);
  a.scratch = static_cast<int32_t*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SW_DISPATCH_K(L / 32, launch, a, s)
}

const char* sw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
