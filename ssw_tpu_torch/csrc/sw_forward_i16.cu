// forward_shared_i16: the int16 tier of forward_shared.  The same batched SW
// forward DP against one shared target (quirk off), with every cell held in
// 16 bits: two reads share one warp, read 2p in the low and read 2p+1 in the
// high half of each 32-bit register, and every step of the recurrence is one
// packed s16x2 instruction (Hopper DPX: __viaddmax_s16x2[_relu]) that
// advances both reads at once.
//
// Replaces the int16 tier of the JAX package's Pallas kernel _forward_kernel
// (ssw_tpu/ops/pallas_sw.py, `use_i16`, chosen by forward_shared_ref when
// i16_exact holds: quirk off and L*(max_sub+gapE)+gapO < 2^14).  That bound
// keeps every cell, every c = h~ + lane*gapE - gapO and every F fill inside
// int16, so the packed arithmetic never wraps and the results equal the
// int32 kernel's bit for bit.  The TPU tier halved the bytes of its (8, 128)
// vector tiles; here it halves the instructions per cell.  ops/cuda_sw.py
// gates the tier on a parity check against the int32 kernel at first use on
// a card (the counterpart of the JAX package's _i16_supported probe).
//
// Layout as sw_dp.cuh: lane t holds positions t*K .. t*K+K-1 of both reads;
// shift, the prefix-max scan and the column max are shuffles of the packed
// words, so both reads ride one chain.  The best-column snapshot is per read:
// a half-word mask selects which half of H is saved.  For K <= 32 the state
// is in registers and the packed profile of the pair ([code][k][lane] uint32)
// in shared memory; longer reads keep the state in a global scratch row and
// read the profile from global memory.
//
// What bounds it: as sw_forward.cu, integer ALU work and shuffle latency; a
// leaf of B reads fills B/2 warps, so it runs half the warps of the int32
// kernel on the same chain length per column.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libsw_forward_i16.so sw_forward_i16.cu

#include "sw_dp.cuh"

namespace {

constexpr int kNeg16 = -(1 << 14);  // lane-0 prefix-max fill (pallas NEG16)
constexpr int kPlanes = 4;          // global-row planes per pair: H E HB CM

// x in both halves (x within int16)
__device__ __forceinline__ unsigned pk(int x) {
  return (unsigned(x) & 0xffffu) * 0x10001u;
}
__device__ __forceinline__ unsigned pack2(int lo, int hi) {
  return (unsigned(lo) & 0xffffu) | (unsigned(hi) << 16);
}
__device__ __forceinline__ int lo16(unsigned v) {
  return int(int16_t(v & 0xffffu));
}
__device__ __forceinline__ int hi16(unsigned v) { return int(v) >> 16; }
// all-ones in the half of each read whose flag is set
__device__ __forceinline__ unsigned halves(bool lo, bool hi) {
  return (lo ? 0xffffu : 0u) | (hi ? 0xffff0000u : 0u);
}

struct I16Args {
  const int8_t* prof;       // (B, n1, L)
  const int32_t* ref;       // (R,)
  const int32_t* read_len;  // (B,)
  const uint8_t* col_mask;  // (B, L) bool
  int B, n1, L, R, gapO, gapE;
  int32_t* score;           // (B,)
  int32_t* end_ref;         // (B,)
  int32_t* end_read;        // (B,)
  int16_t* maxcol;          // (B, R)
  unsigned* scratch;        // (ceil(B/2), 4, L) for PGlobRow, else null
};

// Packed state of a read pair in registers (K known at compile time).
template <int KT>
struct PRegRow {
  unsigned h[KT], e[KT], hb[KT];
  unsigned cma, cmb;       // bit k: col_mask of position t*K+k, per read
  const unsigned* prof;    // shared [code][k][32] packed pair, offset by lane

  __device__ __forceinline__ void attach(unsigned char* wsm, unsigned*,
                                         const int8_t* pa, const int8_t* pb,
                                         int n1, int L, int t) {
    cma = cmb = 0u;
    unsigned* sp = reinterpret_cast<unsigned*>(wsm);
    for (int i = t; i < n1 * L; i += 32) {
      const int code = i / L, j = i - code * L;
      const int tt = j / KT, k = j - tt * KT;
      sp[(code * KT + k) * 32 + tt] = pack2(pa[i], pb ? pb[i] : 0);
    }
    prof = sp + t;
    __syncwarp();
  }
  __device__ __forceinline__ unsigned& H(int k) { return h[k]; }
  __device__ __forceinline__ unsigned& E(int k) { return e[k]; }
  __device__ __forceinline__ unsigned& HB(int k) { return hb[k]; }
  __device__ __forceinline__ unsigned CM(int k) const {
    return halves((cma >> k) & 1u, (cmb >> k) & 1u);
  }
  __device__ __forceinline__ unsigned SUB(int code, int k) const {
    return prof[(code * KT + k) * 32];
  }
  __device__ __forceinline__ void set_mask(int k, bool a, bool b) {
    cma |= unsigned(a) << k;
    cmb |= unsigned(b) << k;
  }
};

// Packed state of a read pair in a global scratch row (any K).
struct PGlobRow {
  unsigned* s;             // scratch row + lane: planes [4][K][32]
  const int8_t* pa;        // global (n1, L) profile rows of the two reads
  const int8_t* pb;        // (null: the pair's high half is empty)
  int K, L, t;

  __device__ __forceinline__ void attach(unsigned char*, unsigned* row,
                                         const int8_t* pa_, const int8_t* pb_,
                                         int, int L_, int t_) {
    L = L_;
    K = L_ / 32;
    t = t_;
    s = row + t_;
    pa = pa_;
    pb = pb_;
  }
  __device__ __forceinline__ unsigned& P(int plane, int k) const {
    return s[(plane * K + k) * 32];
  }
  __device__ __forceinline__ unsigned& H(int k) { return P(0, k); }
  __device__ __forceinline__ unsigned& E(int k) { return P(1, k); }
  __device__ __forceinline__ unsigned& HB(int k) { return P(2, k); }
  __device__ __forceinline__ unsigned CM(int k) const { return P(3, k); }
  __device__ __forceinline__ unsigned SUB(int code, int k) const {
    const int j = code * L + t * K + k;
    return pack2(pa[j], pb ? pb[j] : 0);
  }
  __device__ __forceinline__ void set_mask(int k, bool a, bool b) {
    P(3, k) = halves(a, b);
  }
};

template <int KT> struct PRowSel { using type = PRegRow<KT>; };
template <> struct PRowSel<0> { using type = PGlobRow; };

// One target column for both reads of the pair; returns the packed masked
// column maxima (low: read 2p, high: read 2p+1), identical on every lane.
// The steps are those of sw::dp_column with the quirk off.
template <int KT, class Row>
__device__ __forceinline__ unsigned column_i16(Row& r, int K, int t,
                                               int code, int gapO, int gapE) {
  const int KK = KT > 0 ? KT : K;
  const int base = t * KK;
  unsigned carry = __shfl_up_sync(sw::kFull, r.H(KK - 1), 1);
  if (t == 0) carry = 0u;
  unsigned tot = pk(kNeg16);
#pragma unroll
  for (int k = KK - 1; k >= 0; --k) {
    const unsigned hprev = k == 0 ? carry : r.H(k - 1);
    const unsigned ht = __viaddmax_s16x2_relu(hprev, r.SUB(code, k), r.E(k));
    r.H(k) = ht;
    tot = __viaddmax_s16x2(ht, pk((base + k) * gapE - gapO), tot);
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned y = __shfl_up_sync(sw::kFull, tot, off);
    if (t >= off) tot = __vmaxs2(tot, y);
  }
  unsigned run = __shfl_up_sync(sw::kFull, tot, 1);
  if (t == 0) run = pk(kNeg16);
  unsigned cmax = 0u;
#pragma unroll
  for (int k = 0; k < KK; ++k) {
    const unsigned ht = r.H(k);
    const int d = (base + k) * gapE;
    const unsigned H = __viaddmax_s16x2_relu(run, pk(gapE - d), ht);
    run = __viaddmax_s16x2(ht, pk(d - gapO), run);
    r.E(k) = __viaddmax_s16x2_relu(H, pk(-gapO), __vsub2(r.E(k), pk(gapE)));
    r.H(k) = H;
    cmax = __vmaxs2(cmax, H & r.CM(k));  // H >= 0: masked lanes read 0
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    cmax = __vmaxs2(cmax, __shfl_xor_sync(sw::kFull, cmax, off));
  return cmax;
}

// end_read of one read of the pair from the snapshot halves (sel 0: low).
template <int KT, class Row>
__device__ __forceinline__ int end_read_i16(Row& r, int K, int t, int L,
                                            int sel, int gmax, int rl) {
  const int KK = KT > 0 ? KT : K;
  int cand = L;
#pragma unroll
  for (int k = 0; k < KK; ++k) {
    const int j = t * KK + k;
    const int hb = sel ? hi16(r.HB(k)) : lo16(r.HB(k));
    if (gmax > 0 && j < rl && hb == gmax) cand = min(cand, j);
  }
  cand = __reduce_min_sync(sw::kFull, cand);
  return cand == L ? rl - 1 : cand;
}

template <int KT>
__global__ void sw_forward_i16_kernel(const I16Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int wpb = blockDim.x >> 5, w = threadIdx.x >> 5, t = threadIdx.x & 31;
  const int pair = blockIdx.x * wpb + w;
  const int ba = 2 * pair, bb = ba + 1;
  if (ba >= a.B) return;  // whole warps only; no block barriers below
  const bool has_b = bb < a.B;
  const int L = a.L, K = KT > 0 ? KT : a.L / 32;
  const int KK = KT > 0 ? KT : K;
  const size_t plane = size_t(a.n1) * L;
  const int8_t* pa = a.prof + size_t(ba) * plane;
  using Row = typename PRowSel<KT>::type;
  Row r;
  r.attach(smem + size_t(w) * plane * 4,
           a.scratch ? a.scratch + size_t(pair) * kPlanes * L : nullptr, pa,
           has_b ? pa + plane : nullptr, a.n1, L, t);
  const uint8_t* cma = a.col_mask + size_t(ba) * L;
#pragma unroll
  for (int k = 0; k < KK; ++k) {
    const int j = t * KK + k;
    r.H(k) = r.E(k) = r.HB(k) = 0u;
    r.set_mask(k, cma[j] != 0, has_b && cma[L + j] != 0);
  }

  int gmax_a = 0, gmax_b = 0, er_a = -1, er_b = -1, code_v = 0;
  unsigned mc_v = 0u;
  int16_t* mca = a.maxcol + size_t(ba) * a.R;
  int16_t* mcb = has_b ? mca + a.R : nullptr;
  for (int col = 0; col < a.R; ++col) {
    const int lane = col & 31;
    if (lane == 0) {
      const int cc = col + t;
      code_v = cc < a.R ? a.ref[cc] : 0;
    }
    const int code = __shfl_sync(sw::kFull, code_v, lane);
    const unsigned cm = column_i16<KT>(r, K, t, code, a.gapO, a.gapE);
    const int ca = lo16(cm), cb = hi16(cm);
    const bool ua = ca > gmax_a, ub = cb > gmax_b;
    if (ua || ub) {  // warp-uniform
      if (ua) { gmax_a = ca; er_a = col; }
      if (ub) { gmax_b = cb; er_b = col; }
      const unsigned m = halves(ua, ub);
#pragma unroll
      for (int k = 0; k < KK; ++k) r.HB(k) = (r.H(k) & m) | (r.HB(k) & ~m);
    }
    // colmax < 2^14 inside the i16_exact bound: no clip to 32767 needed
    if (t == lane) mc_v = cm;
    if (lane == 31 || col == a.R - 1) {
      const int cc = (col & ~31) + t;
      if (cc <= col) {
        mca[cc] = int16_t(lo16(mc_v));
        if (mcb) mcb[cc] = int16_t(hi16(mc_v));
      }
    }
  }
  const int ea = end_read_i16<KT>(r, K, t, L, 0, gmax_a, a.read_len[ba]);
  const int eb = has_b ? end_read_i16<KT>(r, K, t, L, 1, gmax_b,
                                          a.read_len[bb])
                       : 0;
  if (t == 0) {
    a.score[ba] = gmax_a;
    a.end_ref[ba] = er_a;
    a.end_read[ba] = ea;
    if (has_b) {
      a.score[bb] = gmax_b;
      a.end_ref[bb] = er_b;
      a.end_read[bb] = eb;
    }
  }
}

template <int KT>
int launch(const I16Args& a, cudaStream_t stream) {
  const size_t per_warp = KT > 0 ? size_t(a.n1) * a.L * 4 : 0;
  int wpb = 4;
  while (wpb > 1 && wpb * per_warp > 48 * 1024) wpb >>= 1;
  const size_t smem = wpb * per_warp;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sw_forward_i16_kernel<KT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return int(e);
  }
  const int pairs = (a.B + 1) / 2;
  const int grid = (pairs + wpb - 1) / wpb;
  sw_forward_i16_kernel<KT><<<grid, wpb * 32, smem, stream>>>(a);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// uint32 scratch elements per read pair the launch needs (0: registers).
int sw_forward_i16_scratch_per_pair(int L) {
  return sw::reg_k(L / 32) ? 0 : kPlanes * L;
}

// Returns the cudaError_t of the launch (0 on success).
int sw_forward_shared_i16(const void* prof, const void* ref,
                          const void* read_len, const void* col_mask, int B,
                          int n1, int L, int R, int gapO, int gapE,
                          void* score, void* end_ref, void* end_read,
                          void* maxcol, void* scratch, void* stream) {
  if (B <= 0) return 0;
  I16Args a;
  a.prof = static_cast<const int8_t*>(prof);
  a.ref = static_cast<const int32_t*>(ref);
  a.read_len = static_cast<const int32_t*>(read_len);
  a.col_mask = static_cast<const uint8_t*>(col_mask);
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
  a.scratch = static_cast<unsigned*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SW_DISPATCH_K(L / 32, launch, a, s)
}

const char* sw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
