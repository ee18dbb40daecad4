// Host-side native kernels of mmlspark_tpu_torch (a copy of the CSV parser
// and the binning and tree-walk kernels of mmlspark_tpu/native/kernels.cpp).
//
// Reference analogue: the reference's dataset-build and per-row predict are
// C++ (lib_lightgbm via generateDenseDataset, LightGBMUtils.scala:326-394,
// and LGBM_BoosterPredictForMat, LightGBMBooster.scala:38-113). The device
// compute path is torch plus the CUDA kernels in csrc/; these kernels cover
// the HOST hot paths around it — CSV ingest, feature binning during dataset
// build and small-batch tree-walk scoring (the serving latency path) — loaded via ctypes by
// mmlspark_tpu_torch/native/__init__.py with a numpy path when no toolchain
// is available (the NativeLoader role, NativeLoader.java:47-105).
//
// The binning and tree-walk kernels are written to be BIT-IDENTICAL to
// their numpy/XLA counterparts: same searchsorted semantics for binning,
// same float32 accumulation order for prediction as the device traversal.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <locale.h>
#include <thread>
#include <vector>

namespace {

// C-locale strtod: the process may have called setlocale(LC_NUMERIC, ...)
// (e.g. a de_DE locale rejects "1.5"); parse results must not depend on it.
locale_t c_locale() {
    static locale_t loc = newlocale(LC_ALL_MASK, "C", nullptr);
    return loc;
}

// match Python float(): no hex literals (strtod accepts "0x1A"), so the
// same file yields the same schema on the native and pure-Python paths
bool looks_hex(const char* cs, const char* ce) {
    const char* p = cs;
    if (p < ce && (*p == '+' || *p == '-')) ++p;
    return (ce - p) >= 2 && p[0] == '0' && (p[1] == 'x' || p[1] == 'X');
}

// Shared thread-over-row-ranges scaffolding (disjoint writes per range):
// one place for the concurrency cap, the min-work gate, and the
// chunk/join discipline used by binning and prediction.
template <typename Fn>
void parallel_rows(int64_t n, int64_t min_rows_per_thread, const Fn& fn) {
    int64_t nt = static_cast<int64_t>(std::thread::hardware_concurrency());
    if (nt > 16) nt = 16;
    if (nt <= 1 || n < 2 * min_rows_per_thread) {
        fn(static_cast<int64_t>(0), n);
        return;
    }
    if (nt > n / min_rows_per_thread) nt = n / min_rows_per_thread;
    std::vector<std::thread> workers;
    const int64_t chunk = (n + nt - 1) / nt;
    for (int64_t t = 0; t < nt; ++t) {
        const int64_t r0 = t * chunk;
        const int64_t r1 = r0 + chunk < n ? r0 + chunk : n;
        if (r0 >= r1) break;
        workers.emplace_back(fn, r0, r1);
    }
    for (auto& w : workers) w.join();
}

}  // namespace

extern "C" {

// Multithreaded CSV cell parse (the tabular-ingest hot path; the reference
// delegates this to Spark's JVM csv reader — here it is framework-native).
// Rows are pre-indexed by the caller (offsets[i] = byte start of row i;
// offsets[n_rows] = end). Each cell is parsed as float64:
//   ok=1: full cell consumed by strtod (after trimming), or empty -> NaN
//   ok=0: non-numeric text (value set to NaN; Python keeps it as a string
//         column when any cell in the column has ok=0)
// No quote handling: the Python wrapper routes quoted files to the slow
// path — correctness first, speed for the machine-written common case.
void mmlspark_csv_parse(
    const char* data,
    const int64_t* offsets,     // (n_rows + 1,)
    int64_t n_rows, int64_t n_cols,
    char delim,
    double* out,                // (n_rows, n_cols) pre-allocated
    uint8_t* ok,                // (n_rows, n_cols) pre-allocated
    int32_t n_threads)
{
    const double kNaN = std::nan("");
    auto parse_rows = [&](int64_t r0, int64_t r1) {
        for (int64_t i = r0; i < r1; ++i) {
            const char* p = data + offsets[i];
            const char* end = data + offsets[i + 1];
            while (end > p && (end[-1] == '\n' || end[-1] == '\r')) --end;
            int64_t c = 0;
            const char* cs = p;
            for (const char* q = p; q <= end && c < n_cols; ++q) {
                if (q == end || *q == delim) {
                    const char* ce = q;
                    while (cs < ce && (*cs == ' ' || *cs == '\t')) ++cs;
                    while (ce > cs && (ce[-1] == ' ' || ce[-1] == '\t')) --ce;
                    const int64_t idx = i * n_cols + c;
                    if (cs == ce) {
                        out[idx] = kNaN;
                        ok[idx] = 1;          // empty = missing numeric
                    } else {
                        // in-place strtod: the buffer always ends with '\n'
                        // (Python appends one), so parsing stops at the
                        // delimiter/newline and never runs off the end
                        char* stop = nullptr;
                        const double v = looks_hex(cs, ce)
                            ? (stop = const_cast<char*>(cs), 0.0)
                            : strtod_l(cs, &stop, c_locale());
                        if (stop == ce) {
                            out[idx] = v;
                            ok[idx] = 1;
                        } else {
                            out[idx] = kNaN;
                            ok[idx] = 0;      // text cell
                        }
                    }
                    ++c;
                    cs = q + 1;
                }
            }
            for (; c < n_cols; ++c) {         // short row: missing tail
                out[i * n_cols + c] = kNaN;
                ok[i * n_cols + c] = 1;
            }
        }
    };
    int64_t nt = n_threads > 0 ? n_threads : 1;
    if (nt > n_rows) nt = n_rows > 0 ? n_rows : 1;
    if (nt <= 1) {
        parse_rows(0, n_rows);
        return;
    }
    std::vector<std::thread> workers;
    const int64_t chunk = (n_rows + nt - 1) / nt;
    for (int64_t t = 0; t < nt; ++t) {
        const int64_t r0 = t * chunk;
        const int64_t r1 = r0 + chunk < n_rows ? r0 + chunk : n_rows;
        if (r0 >= r1) break;
        workers.emplace_back(parse_rows, r0, r1);
    }
    for (auto& w : workers) w.join();
}

// Numeric-feature binning: replicates
//   np.searchsorted(upper_bounds[j,1:nb], col, side='left') + 1,
//   clipped to [1, nb-1]; NaN -> bin 0. ±inf bins by comparison
//   (-inf -> bin 1, +inf -> top bin), matching LightGBM routing.
// Categorical features (is_cat[j] != 0) and single-bin features are left
// untouched for the Python side to fill.
void mmlspark_bin_numeric(
    const double* x,            // (n, f) row-major
    int64_t n, int64_t f,
    const double* upper_bounds, // (f, ub_stride) row-major; bounds at [1..nb-1]
    int64_t ub_stride,
    const int32_t* num_bins,    // (f,)
    const uint8_t* is_cat,      // (f,)
    int32_t* out)               // (n, f) row-major, pre-zeroed
{
    auto bin_rows = [&](int64_t r0, int64_t r1) {
        // row-outer loop: x and out are row-major, so cells stream
        // sequentially through cache; the small per-feature boundary
        // tables stay hot in L1/L2
        for (int64_t i = r0; i < r1; ++i) {
            const double* row = x + i * f;
            int32_t* orow = out + i * f;
            for (int64_t j = 0; j < f; ++j) {
                const int32_t nb = num_bins[j];
                if (is_cat[j] || nb <= 1) continue;
                const double v = row[j];
                if (std::isnan(v)) {
                    orow[j] = 0;  // MISSING_BIN
                    continue;
                }
                const double* ub = upper_bounds + j * ub_stride + 1;  // skip bin 0
                const int64_t m = nb - 1;  // number of real boundaries
                // lower_bound == searchsorted(side='left')
                int64_t lo = 0, hi = m;
                while (lo < hi) {
                    const int64_t mid = (lo + hi) >> 1;
                    if (ub[mid] < v) lo = mid + 1; else hi = mid;
                }
                int64_t b = lo + 1;
                if (b < 1) b = 1;
                if (b > nb - 1) b = nb - 1;
                orow[j] = static_cast<int32_t>(b);
            }
        }
    };
    // thread over row ranges (disjoint writes) once the work is large
    // enough to amortize thread spawn
    parallel_rows(n, 16384, bin_rows);
}

// Array-of-trees SoA traversal over binned rows: replicates the jitted
// device traversal (and the numpy host walk) exactly — fixed max_steps
// gather-walk per tree, float32 accumulation in tree order.
void mmlspark_predict_trees(
    const int32_t* bins,        // (n, f) row-major
    int64_t n, int64_t f,
    int64_t num_trees, int64_t nodes_per_tree,
    const int32_t* feature,     // (T, M)
    const int32_t* threshold,   // (T, M)
    const uint8_t* is_cat,      // (T, M)
    const int32_t* left,        // (T, M)
    const int32_t* right,       // (T, M)
    const float* value,         // (T, M)
    const int32_t* tree_class,  // (T,)
    int32_t k,                  // 1 = scalar output, >1 = (n, k) multiclass
    int32_t max_steps,
    float init_score,
    const uint8_t* cat_bitset,  // (T, M, Bc) — bins routed left at cat nodes
    int64_t bc,                 // Bc (bitset width; >= 1)
    float* out)                 // (n,) or (n, k), pre-zeroed
{
    // ROW-outer, tree-inner: the whole forest's SoA arrays (typically a
    // few hundred KB) stay resident in L2 while each row's bins stay in
    // L1 across all trees — tree-outer order would stream the full (n, f)
    // bin matrix from DRAM once PER TREE (measured 100x the traffic at
    // 1M x 28 x 100 trees). Per-row float accumulation remains in tree
    // order, so results are bit-identical to the old loop order and to
    // the jitted device traversal.
    // (A 4-row software-pipelined variant was measured SLOWER here: the
    // out-of-order window already overlaps the independent per-tree walk
    // chains in this row-outer order, and the parked-leaf bookkeeping
    // cost more than the extra ILP bought.)
    auto walk_rows = [&](int64_t r0, int64_t r1) {
        // one walk of tree t for one row: final node index
        auto walk_one = [&](const int32_t* row, int64_t off) -> int32_t {
            int32_t node = 0;
            for (int32_t s = 0; s < max_steps; ++s) {
                const int32_t feat = feature[off + node];
                if (feat < 0) break;  // leaf
                const int32_t col = row[feat];
                // categorical: many-vs-many subset lookup (bins past the
                // bitset width only occur on numeric columns)
                const int64_t bcol = col < bc ? col : bc - 1;
                const bool go_left = is_cat[off + node]
                    ? (cat_bitset[(off + node) * bc + bcol] != 0)
                    : (col <= threshold[off + node]);
                node = go_left ? left[off + node] : right[off + node];
            }
            return node;
        };
        for (int64_t i = r0; i < r1; ++i) {
            const int32_t* row = bins + i * f;
            if (k <= 1) {
                float acc = init_score;
                for (int64_t t = 0; t < num_trees; ++t) {
                    const int64_t off = t * nodes_per_tree;
                    acc += value[off + walk_one(row, off)];
                }
                out[i] = acc;
            } else {
                for (int64_t t = 0; t < num_trees; ++t) {
                    const int64_t off = t * nodes_per_tree;
                    out[i * k + tree_class[t]] += value[off + walk_one(row, off)];
                }
            }
        }
    };
    // thread over row ranges (disjoint out writes); per-row tree order is
    // unaffected by the partitioning
    parallel_rows(n, 8192, walk_rows);
}

}  // extern "C"
