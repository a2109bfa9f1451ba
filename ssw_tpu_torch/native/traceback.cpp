// Host-side banded traceback engine for ssw_tpu_torch.
//
// The device kernels produce scores and end/begin coordinates; the final CIGAR
// is a tiny banded affine-gap DP over the [begin,end] sub-rectangle, which
// is inherently sequential pointer-chasing and therefore belongs on the
// host CPU.  Semantics mirror the reference's banded_sw + verification
// retry (ref: src/ssw.c:590-811, 940-957) — band geometry,
// band-doubling, cross-iteration best-cell bookkeeping, direction-plane
// tie-breaks and the trailing-1M fixup — re-implemented from the semantic
// spec in ssw_tpu_torch/core/oracle.py (this file is new code, not a copy).
//
// Build: g++ -O3 -shared -fPIC -o libsswtpu.so traceback.cpp fastio.cpp -lz

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int64_t kNegInf = -(int64_t(1) << 30);

struct Cell {
    int64_t best = 0;
    int i = 0;
    int j = 0;
};

// band slot of matrix coordinate (i, j) in the reference's layout:
// slot = j - max(i - bw, 0) + 1 (ref: src/ssw.c:92)
static inline int slot_of(int bw, int i, int j) {
    int x = i - bw;
    if (x < 0) x = 0;
    return j - x + 1;
}

struct BandedDP {
    int read_len, ref_len, band_width, width, width_d;
    std::vector<int64_t> h_prev, e_prev, h_cur;
    // direction planes per (row, band position): 0=e, 1=f, 2=h
    std::vector<int8_t> dir;
    Cell best;

    void run(const int8_t* ref, const int8_t* read, const int8_t* mat, int n,
             int gap_open, int gap_ext) {
        width = band_width * 2 + 3;
        width_d = band_width * 2 + 1;
        h_prev.assign(width, 0);
        e_prev.assign(width, 0);
        h_cur.assign(width, 0);
        dir.assign(size_t(read_len) * width_d * 3, 0);
        for (int i = 0; i < read_len; ++i) {
            int beg = i - band_width;
            if (beg < 0) beg = 0;
            int end = i + band_width;
            if (end > ref_len - 1) end = ref_len - 1;
            if (beg > end) continue;
            int edge = (end + 1 < width - 1) ? end + 1 : width - 1;
            h_prev[0] = 0;
            h_prev[edge] = 0;
            h_cur[0] = 0;
            e_prev[0] = kNegInf;
            e_prev[edge] = kNegInf;
            int8_t* dline = dir.data() + size_t(i) * width_d * 3;
            int64_t f = kNegInf;
            int u = 0;
            const int8_t* mrow_base = mat;
            for (int j = beg; j <= end; ++j) {
                u = slot_of(band_width, i, j);
                int eu = slot_of(band_width, i - 1, j);
                int bu = slot_of(band_width, i, j - 1);
                int du = slot_of(band_width, i - 1, j - 1);
                int off = (j - (i - band_width > 0 ? i - band_width : 0)) * 3;
                int64_t open_e, ext_e;
                if (i == 0) {
                    open_e = -gap_open;
                    ext_e = kNegInf;
                } else {
                    open_e = h_prev[eu] - gap_open;
                    ext_e = e_prev[eu] - gap_ext;
                }
                int64_t e_val = open_e > ext_e ? open_e : ext_e;
                e_prev[u] = e_val;  // e plane reuses the buffer row-by-row
                dline[off] = open_e > ext_e ? 3 : 2;
                int64_t open_f = h_cur[bu] - gap_open;
                int64_t ext_f = f - gap_ext;
                f = open_f > ext_f ? open_f : ext_f;
                dline[off + 1] = open_f > ext_f ? 5 : 4;
                int64_t e1 = e_val > 0 ? e_val : 0;
                int64_t f1 = f > 0 ? f : 0;
                int64_t gap_best = e1 > f1 ? e1 : f1;
                int64_t diag =
                    h_prev[du] + mrow_base[ref[j] * n + read[i]];
                int64_t h = gap_best > diag ? gap_best : diag;
                h_cur[u] = h;
                if (h > best.best) {
                    best.best = h;
                    best.i = i;
                    best.j = j;
                }
                if (gap_best <= diag) {
                    dline[off + 2] = 1;
                } else {
                    dline[off + 2] = e1 > f1 ? dline[off] : dline[off + 1];
                }
            }
            for (int k = 1; k <= u; ++k) h_prev[k] = h_cur[k];
        }
    }
};

// traceback from the best cell; returns op-run list or empty on failure
static bool traceback(const BandedDP& dp, std::vector<uint32_t>& out) {
    int i = dp.best.i;
    int j = dp.best.j;
    int plane = 2;
    char op = 'M', prev = 'M';
    int count = 0;
    std::vector<uint32_t> runs;  // packed (len<<4 | opcode) built backwards
    auto op_code = [](char c) -> uint32_t {
        switch (c) {
            case 'M': return 0;
            case 'I': return 1;
            case 'D': return 2;
        }
        return 0;
    };
    while (i >= 0 && j > 0) {
        int base_off = i - dp.band_width > 0 ? i - dp.band_width : 0;
        int s = j - base_off;
        if (s < 0 || s >= dp.width_d) return false;
        int8_t d = dp.dir[size_t(i) * dp.width_d * 3 + s * 3 + plane];
        switch (d) {
            case 1: --i; --j; plane = 2; op = 'M'; break;
            case 2: --i; plane = 0; op = 'I'; break;
            case 3: --i; plane = 2; op = 'I'; break;
            case 4: --j; plane = 1; op = 'D'; break;
            case 5: --j; plane = 2; op = 'D'; break;
            default: return false;
        }
        if (op == prev) {
            ++count;
        } else {
            runs.push_back((uint32_t(count) << 4) | op_code(prev));
            prev = op;
            count = 1;
        }
    }
    if (op == 'M') {
        runs.push_back((uint32_t(count + 1) << 4) | op_code('M'));
    } else {
        runs.push_back((uint32_t(count) << 4) | op_code(op));
        runs.push_back((uint32_t(1) << 4) | op_code('M'));
    }
    out.assign(runs.rbegin(), runs.rend());
    return true;
}

static int64_t rescore(const std::vector<uint32_t>& cigar, const int8_t* ref,
                       int ref_len, const int8_t* read, int read_len,
                       const int8_t* mat, int n, int gap_open, int gap_ext) {
    int64_t score = 0;
    int i = 0, j = 0;
    for (uint32_t c : cigar) {
        uint32_t len = c >> 4;
        uint32_t op = c & 0xF;
        if (op == 0) {  // M
            // the tail fix-up 1M (ref: src/ssw.c:745-762) can step outside
            // the sub-rectangle; the reference reads garbage there and
            // fails verification -- fail it deterministically instead
            if (i + int(len) > ref_len || j + int(len) > read_len)
                return INT64_MIN;
            for (uint32_t k = 0; k < len; ++k) {
                score += mat[ref[i] * n + read[j]];
                ++i;
                ++j;
            }
        } else {
            score -= gap_open + int64_t(len > 1 ? len - 1 : 0) * gap_ext;
            if (op == 1) j += len;  // I consumes read
            else i += len;          // D consumes ref
        }
    }
    return score;
}

// one banded_sw invocation incl. its internal doubling (ref: src/ssw.c:616-679)
static bool banded_once(const int8_t* ref, int ref_len, const int8_t* read,
                        int read_len, int score, int gap_open, int gap_ext,
                        int band_width, const int8_t* mat, int n,
                        std::vector<uint32_t>& out) {
    int len_max = ref_len > read_len ? ref_len : read_len;
    BandedDP dp;
    dp.read_len = read_len;
    dp.ref_len = ref_len;
    while (true) {
        dp.band_width = band_width;
        dp.run(ref, read, mat, n, gap_open, gap_ext);
        band_width *= 2;
        if (!(dp.best.best < score && band_width <= len_max)) break;
    }
    dp.band_width = band_width / 2;
    return traceback(dp, out);
}

}  // namespace

extern "C" {

// Full cigar generation with verification retry (ref: src/ssw.c:940-957).
// Returns the cigar length written to out_cigar (BAM-encoded, length<<4|op),
// or 0 when the banded traceback failed (caller sets flag=1), or -1 when
// out_cap is too small (caller retries with a bigger buffer).
int32_t sswtpu_banded_cigar(const int8_t* ref, int32_t ref_len,
                            const int8_t* read, int32_t read_len,
                            int32_t score, int32_t gap_open, int32_t gap_ext,
                            const int8_t* mat, int32_t n,
                            uint32_t* out_cigar, int32_t out_cap) {
    int band_width = ref_len > read_len ? ref_len - read_len
                                        : read_len - ref_len;
    band_width += 1;
    int full_band = ref_len > read_len ? ref_len : read_len;
    std::vector<uint32_t> cigar;
    while (true) {
        cigar.clear();
        bool ok = banded_once(ref, ref_len, read, read_len, score, gap_open,
                              gap_ext, band_width, mat, n, cigar);
        if (!ok) return 0;
        if (rescore(cigar, ref, ref_len, read, read_len, mat, n,
                    gap_open, gap_ext) == score)
            break;
        if (band_width >= full_band) return 0;
        band_width = full_band;
    }
    if (int32_t(cigar.size()) > out_cap) return -1;
    std::memcpy(out_cigar, cigar.data(), cigar.size() * sizeof(uint32_t));
    return int32_t(cigar.size());
}

// Batch driver: cigars for many (ref window, read window) pairs in one call.
// Layout: concatenated windows with per-pair offsets/lengths.  Every pair
// writes into its own pre-sized slice of out_cigars (offset = the same
// 2*(ref+read)+8 bound the per-pair wrapper uses, accumulated by the
// caller), so pairs are independent and run on a thread pool — the
// reference's traceback is strictly serial per pair (ref: src/ssw.c:940-957)
// but pairs never share state.  out_meta[2p] = offset, out_meta[2p+1] =
// cigar length (0: banded failure -> flag=1 parity; -1: capacity overflow).
void sswtpu_banded_cigar_batch(const int8_t* refs, const int64_t* ref_off,
                               const int32_t* ref_len, const int8_t* reads,
                               const int64_t* read_off,
                               const int32_t* read_len,
                               const int32_t* scores, int32_t n_pairs,
                               int32_t gap_open, int32_t gap_ext,
                               const int8_t* mat, int32_t n,
                               uint32_t* out_cigars, int64_t out_cap,
                               int64_t* out_meta) {
    // per-pair output offsets from the deterministic capacity bound
    int64_t pos = 0;
    for (int32_t p = 0; p < n_pairs; ++p) {
        out_meta[2 * p] = pos;
        pos += 2 * (int64_t(ref_len[p]) + read_len[p]) + 8;
    }
    auto work = [&](int32_t p) {
        int64_t off = out_meta[2 * p];
        int64_t cap64 = 2 * (int64_t(ref_len[p]) + read_len[p]) + 8;
        if (off + cap64 > out_cap) { out_meta[2 * p + 1] = -1; return; }
        int32_t written = sswtpu_banded_cigar(
            refs + ref_off[p], ref_len[p], reads + read_off[p],
            read_len[p], scores[p], gap_open, gap_ext, mat, n,
            out_cigars + off, int32_t(cap64));
        out_meta[2 * p + 1] = written < 0 ? -1 : written;
    };
    unsigned hw = std::thread::hardware_concurrency();
    int32_t n_threads = int32_t(hw ? hw : 1);
    if (n_threads > n_pairs) n_threads = n_pairs;
    if (n_threads <= 1 || n_pairs < 4) {
        for (int32_t p = 0; p < n_pairs; ++p) work(p);
        return;
    }
    std::atomic<int32_t> next(0);
    std::vector<std::thread> pool;
    pool.reserve(n_threads);
    for (int32_t t = 0; t < n_threads; ++t) {
        pool.emplace_back([&]() {
            for (;;) {
                int32_t p = next.fetch_add(1);
                if (p >= n_pairs) return;
                work(p);
            }
        });
    }
    for (auto& th : pool) th.join();
}

}  // extern "C"
