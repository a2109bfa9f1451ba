// forward_shared: the batched SW forward DP of a read batch against one
// shared target, with per-column maxima and first-strict-max tracking.
//
// Replaces the JAX package's Pallas kernel _forward_kernel in its base mode
// (ssw_tpu/ops/pallas_sw.py, driven by _forward_call and wrapped by
// forward_shared_ref / forward_shared_ref_gated).  The TPU kernel walks a
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
  int B, n1, L, R, gapO, gapE, quirk;
  int32_t* score;           // (B,)
  int32_t* end_ref;         // (B,)
  int32_t* end_read;        // (B,)
  int16_t* maxcol;          // (B, R)
  int32_t* scratch;         // (B, 7, L) for GlobRow, else null
};

template <int KT>
__global__ void sw_forward_kernel(const FwdArgs a) {
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

  int gmax = 0, end_ref = -1;
  int code_v = 0;
  int16_t mc_v = 0;
  int16_t* mc_row = a.maxcol + size_t(b) * a.R;
  for (int col = 0; col < a.R; ++col) {
    const int lane = col & 31;
    if (lane == 0) {
      const int cc = col + t;
      code_v = cc < a.R ? a.ref[cc] : 0;
    }
    const int code = __shfl_sync(sw::kFull, code_v, lane);
    const int colmax = sw::dp_column<KT>(r, K, t, code, a.gapO, a.gapE,
                                         quirk);
    if (colmax > gmax) {  // warp-uniform
      gmax = colmax;
      end_ref = col;
      sw::save_best<KT>(r, K);
    }
    if (t == lane) mc_v = int16_t(min(colmax, 32767));
    if (lane == 31 || col == a.R - 1) {
      const int cc = (col & ~31) + t;
      if (cc <= col) mc_row[cc] = mc_v;
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
int launch(const FwdArgs& a, cudaStream_t stream) {
  int wpb;
  size_t smem;
  sw::launch_shape<KT>(a.n1, a.L, a.quirk != 0, &wpb, &smem);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sw_forward_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(smem));
    if (e != cudaSuccess) return int(e);
  }
  const int grid = (a.B + wpb - 1) / wpb;
  sw_forward_kernel<KT><<<grid, wpb * 32, smem, stream>>>(a);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// int32 scratch elements per read the launch needs (0: register variant).
int sw_forward_scratch_per_read(int L) {
  return sw::reg_k(L / 32) ? 0 : sw::kScratchPlanes * L;
}

// Returns the cudaError_t of the launch (0 on success).
int sw_forward_shared(const void* prof, const void* ref, const void* read_len,
                      const void* col_mask, const void* seg_id,
                      const void* seg_start, int B, int n1, int L, int R,
                      int gapO, int gapE, int quirk, void* score,
                      void* end_ref, void* end_read, void* maxcol,
                      void* scratch, void* stream) {
  if (B <= 0) return 0;
  FwdArgs a;
  a.prof = static_cast<const int8_t*>(prof);
  a.ref = static_cast<const int32_t*>(ref);
  a.read_len = static_cast<const int32_t*>(read_len);
  a.col_mask = static_cast<const uint8_t*>(col_mask);
  a.seg_id = static_cast<const int8_t*>(seg_id);
  a.seg_start = static_cast<const uint8_t*>(seg_start);
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
  a.scratch = static_cast<int32_t*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SW_DISPATCH_K(L / 32, launch, a, s)
}

const char* sw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
