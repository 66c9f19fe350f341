// fastpack: native host-side kernels for the svs_tpu_torch packing
// pipeline and its host search route (a copy of svs_tpu's fastpack.cpp:
// the same entry points, the same bits).
//
// The card owns the query hot path; these C++ kernels own the *host* hot
// paths around it, where single-threaded NumPy/Python would otherwise
// bottleneck cold starts on large corpora:
//
//   - f32 -> bf16 conversion (round-to-nearest-even), multithreaded.
//   - per-row symmetric int8 quantization, multithreaded.
//   - exact top-k selection over a score vector (nth_element + sort).
//   - row L2-normalization, multithreaded.
//   - the fused permute + pad + cast pack, the int8 prescore of the host
//     two-pass search, and the SQLite embedding scan (below).
//
// Exposed with plain C linkage and driven from Python via ctypes
// (svs_tpu_torch/native/__init__.py); every entry point has a NumPy
// fallback so the package works without a compiler present.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <thread>
#include <vector>

namespace {

// Round-to-nearest-even f32 -> bf16, matching XLA/ml_dtypes semantics.
inline uint16_t f32_to_bf16_rne(float value) {
    uint32_t bits;
    std::memcpy(&bits, &value, sizeof(bits));
    if ((bits & 0x7fffffffu) > 0x7f800000u) {  // NaN: quiet, keep payload bit
        return static_cast<uint16_t>((bits >> 16) | 0x0040u);
    }
    const uint32_t lsb = (bits >> 16) & 1u;
    const uint32_t rounding_bias = 0x7fffu + lsb;
    return static_cast<uint16_t>((bits + rounding_bias) >> 16);
}


template <typename Fn>
void run_parallel(size_t n_items, int n_threads, Fn&& fn) {
    if (n_threads <= 1 || n_items < (1u << 16)) {
        fn(0, n_items);
        return;
    }
    const size_t chunk = (n_items + n_threads - 1) / n_threads;
    std::vector<std::thread> workers;
    workers.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) {
        const size_t begin = static_cast<size_t>(t) * chunk;
        if (begin >= n_items) break;
        const size_t end = std::min(n_items, begin + chunk);
        workers.emplace_back([&fn, begin, end] { fn(begin, end); });
    }
    for (auto& w : workers) w.join();
}

}  // namespace

extern "C" {

// dst[i] = bf16(src[i]) for i in [0, n)
void fastpack_f32_to_bf16(const float* src, uint16_t* dst, size_t n,
                          int n_threads) {
    run_parallel(n, n_threads, [&](size_t begin, size_t end) {
        for (size_t i = begin; i < end; ++i) dst[i] = f32_to_bf16_rne(src[i]);
    });
}

// Per-row symmetric int8 quantization: q = round(x * 127 / max|row|).
void fastpack_quantize_int8(const float* src, int8_t* dst, float* scales,
                            size_t rows, size_t cols, int n_threads) {
    run_parallel(rows, n_threads, [&](size_t begin, size_t end) {
        for (size_t r = begin; r < end; ++r) {
            const float* row = src + r * cols;
            float absmax = 0.0f;
            for (size_t c = 0; c < cols; ++c)
                absmax = std::max(absmax, std::fabs(row[c]));
            const float scale = std::max(absmax, 1e-30f) / 127.0f;
            scales[r] = scale;
            int8_t* out = dst + r * cols;
            for (size_t c = 0; c < cols; ++c) {
                // divide (not multiply-by-reciprocal) to match the device
                // and NumPy quantizers bit-for-bit
                float q = std::nearbyint(row[c] / scale);
                q = std::min(127.0f, std::max(-127.0f, q));
                out[c] = static_cast<int8_t>(q);
            }
        }
    });
}

// L2-normalize each row in place (rows with ~zero norm are left unchanged).
void fastpack_normalize_rows(float* data, size_t rows, size_t cols,
                             int n_threads) {
    run_parallel(rows, n_threads, [&](size_t begin, size_t end) {
        for (size_t r = begin; r < end; ++r) {
            float* row = data + r * cols;
            double sq = 0.0;
            for (size_t c = 0; c < cols; ++c)
                sq += static_cast<double>(row[c]) * row[c];
            if (sq <= 1e-30) continue;
            const float inv = static_cast<float>(1.0 / std::sqrt(sq));
            for (size_t c = 0; c < cols; ++c) row[c] *= inv;
        }
    });
}

// Exact top-k: writes k (value, index) pairs sorted by value descending,
// ties broken by larger index first EVERYWHERE, including the k-th
// boundary (stricter than the Python oracle, whose boundary-tie set is
// argpartition-arbitrary like the reference's; score multisets agree).
void fastpack_topk_f32(const float* scores, size_t n, int k, float* out_vals,
                       int32_t* out_idx) {
    const int kk = static_cast<int>(std::min<size_t>(k, n));
    std::vector<int32_t> order(n);
    std::iota(order.begin(), order.end(), 0);
    auto better = [scores](int32_t a, int32_t b) {
        if (scores[a] != scores[b]) return scores[a] > scores[b];
        return a > b;  // tie: larger index first
    };
    std::nth_element(order.begin(), order.begin() + kk, order.end(), better);
    std::sort(order.begin(), order.begin() + kk, better);
    for (int i = 0; i < kk; ++i) {
        out_vals[i] = scores[order[i]];
        out_idx[i] = order[i];
    }
}

// Fused permute + pad + cast: dst[r] = cast(src[perm[r]]) for r < n, in one
// multithreaded pass.  Replaces three full-matrix passes (fancy-index
// gather, zero-pad copy, cast) that measured 84 s at 1M x 1536 on slow-
// memory hosts; the padding region of dst must be pre-zeroed by the caller
// (np.zeros is kernel-lazy, touched here only where written).
void fastpack_permute_cast_bf16(const float* src, const int64_t* perm,
                                uint16_t* dst, size_t n, size_t d,
                                size_t d_pad, int n_threads) {
    run_parallel(n, n_threads, [&](size_t begin, size_t end) {
        for (size_t r = begin; r < end; ++r) {
            const float* in = src + static_cast<size_t>(perm[r]) * d;
            uint16_t* out = dst + r * d_pad;
            for (size_t c = 0; c < d; ++c) out[c] = f32_to_bf16_rne(in[c]);
            for (size_t c = d; c < d_pad; ++c) out[c] = 0;
        }
    });
}

void fastpack_permute_cast_f32(const float* src, const int64_t* perm,
                               float* dst, size_t n, size_t d, size_t d_pad,
                               int n_threads) {
    run_parallel(n, n_threads, [&](size_t begin, size_t end) {
        for (size_t r = begin; r < end; ++r) {
            const float* in = src + static_cast<size_t>(perm[r]) * d;
            float* out = dst + r * d_pad;
            std::memcpy(out, in, d * sizeof(float));
            for (size_t c = d; c < d_pad; ++c) out[c] = 0.0f;
        }
    });
}

// int8 variant: per-row absmax + symmetric quantization fused into the
// same pass (bit-identical to fastpack_quantize_int8 on the padded row:
// the zero padding never changes absmax and quantizes to 0).
void fastpack_permute_cast_int8(const float* src, const int64_t* perm,
                                int8_t* dst, float* scales, size_t n,
                                size_t d, size_t d_pad, int n_threads) {
    run_parallel(n, n_threads, [&](size_t begin, size_t end) {
        for (size_t r = begin; r < end; ++r) {
            const float* in = src + static_cast<size_t>(perm[r]) * d;
            float absmax = 0.0f;
            for (size_t c = 0; c < d; ++c)
                absmax = std::max(absmax, std::fabs(in[c]));
            const float scale = std::max(absmax, 1e-30f) / 127.0f;
            scales[r] = scale;
            int8_t* out = dst + r * d_pad;
            for (size_t c = 0; c < d; ++c) {
                float q = std::nearbyint(in[c] / scale);
                q = std::min(127.0f, std::max(-127.0f, q));
                out[c] = static_cast<int8_t>(q);
            }
            for (size_t c = d; c < d_pad; ++c) out[c] = 0;
        }
    });
}

}  // extern "C"

// --- int8 dot kernels (host two-pass prescore) ------------------------------

#if defined(__x86_64__) || defined(_M_X64)
#include <immintrin.h>
#endif

namespace {

// dot(q, d) over int8 with three tiers (built with -march=native):
//
// - AVX-512 VNNI: ``dpbusd`` wants u8 x s8, so the query is biased by
//   +128 into u8 once per call; the per-row correction is
//   ``128 * sum(d)``, with row sums precomputed once per corpus.
// - AVX2: ``maddubs`` via the abs/sign trick (|q| as u8, d signed by
//   q's sign); pair products cap at 2*127*127 < int16 max, no overflow.
// - scalar fallback (also handles the non-multiple tail).
inline int32_t dot_i8_scalar(const int8_t* a, const int8_t* b, size_t lo,
                             size_t hi) {
    int32_t acc = 0;
    for (size_t j = lo; j < hi; ++j)
        acc += static_cast<int32_t>(a[j]) * static_cast<int32_t>(b[j]);
    return acc;
}

#if defined(__AVX512VNNI__) && defined(__AVX512BW__) && defined(__AVX512F__)
#define FASTPACK_HAVE_VNNI 1
inline int32_t dot_i8_vnni(const uint8_t* q_biased, const int8_t* d,
                           size_t cols, int32_t row_sum) {
    __m512i acc = _mm512_setzero_si512();
    size_t j = 0;
    for (; j + 64 <= cols; j += 64) {
        const __m512i vq = _mm512_loadu_si512(
            reinterpret_cast<const void*>(q_biased + j));
        const __m512i vd = _mm512_loadu_si512(
            reinterpret_cast<const void*>(d + j));
        acc = _mm512_dpbusd_epi32(acc, vq, vd);
    }
    int32_t biased = _mm512_reduce_add_epi32(acc);
    // tail stays in the BIASED domain so the single full-row correction
    // (128 * sum over ALL cols) is exact for any cols, not just
    // multiples of 64
    for (; j < cols; ++j)
        biased += static_cast<int32_t>(q_biased[j]) *
                  static_cast<int32_t>(d[j]);
    return biased - 128 * row_sum;
}
#elif defined(__AVX2__)
#define FASTPACK_HAVE_AVX2_I8 1
inline int32_t dot_i8_avx2(const int8_t* q, const int8_t* d, size_t cols) {
    __m256i acc = _mm256_setzero_si256();
    const __m256i ones = _mm256_set1_epi16(1);
    size_t j = 0;
    for (; j + 32 <= cols; j += 32) {
        const __m256i vq = _mm256_loadu_si256(
            reinterpret_cast<const __m256i*>(q + j));
        const __m256i vd = _mm256_loadu_si256(
            reinterpret_cast<const __m256i*>(d + j));
        const __m256i abs_q = _mm256_abs_epi8(vq);
        const __m256i d_signed = _mm256_sign_epi8(vd, vq);
        const __m256i prod16 = _mm256_maddubs_epi16(abs_q, d_signed);
        acc = _mm256_add_epi32(acc, _mm256_madd_epi16(prod16, ones));
    }
    __m128i lo = _mm256_castsi256_si128(acc);
    __m128i hi = _mm256_extracti128_si256(acc, 1);
    __m128i s = _mm_add_epi32(lo, hi);
    s = _mm_add_epi32(s, _mm_srli_si128(s, 8));
    s = _mm_add_epi32(s, _mm_srli_si128(s, 4));
    int32_t dot = _mm_cvtsi128_si32(s);
    if (j < cols) dot += dot_i8_scalar(q, d, j, cols);
    return dot;
}
#endif

}  // namespace

extern "C" {

// Host two-pass prescore (the host analog of the device's int8
// prescore + exact f32 rescore design): reconstruction scores
// ``(q_i8 . d_i8) * s_q * s_d[r]`` for every row, then exact top-c
// selection per query (same tie convention as fastpack_topk_f32 — the
// caller's f32 rescore + margin proof applies the reference tie rule
// and verifies coverage, exactly like the device candidates).  The
// int8 matrix is 1/4 the bytes of the f32 scan the reference does
// (``svs/kb.py:1185``) and the dot runs on VNNI/AVX2 integer units —
// this is what makes the host path WIN (not tie) the reference's own
// 10k warm-query shape on identical hardware.
//
// ``row_sums``: int32 per-row sums of ``docs`` (precomputed once per
// corpus) — required by the VNNI bias trick; ignored by other tiers
// (pass nullptr only if the binary reports no VNNI).
void fastpack_int8_topc(const int8_t* docs, const float* row_scales,
                        const int32_t* row_sums,
                        size_t rows, size_t cols,
                        const int8_t* queries, const float* q_scales,
                        size_t b, int c,
                        float* out_vals, int32_t* out_idx, int n_threads) {
    std::vector<float> scores(rows);
    const int cc = static_cast<int>(std::min<size_t>(c, rows));
#if defined(FASTPACK_HAVE_VNNI)
    std::vector<uint8_t> q_biased(cols);
#endif
    for (size_t qi = 0; qi < b; ++qi) {
        const int8_t* q = queries + qi * cols;
        const float sq = q_scales[qi];
#if defined(FASTPACK_HAVE_VNNI)
        for (size_t j = 0; j < cols; ++j)
            q_biased[j] = static_cast<uint8_t>(
                static_cast<int32_t>(q[j]) + 128);
#endif
        run_parallel(rows, n_threads, [&](size_t begin, size_t end) {
            for (size_t r = begin; r < end; ++r) {
                const int8_t* d = docs + r * cols;
#if defined(FASTPACK_HAVE_VNNI)
                const int32_t acc = row_sums
                    ? dot_i8_vnni(q_biased.data(), d, cols, row_sums[r])
                    : dot_i8_scalar(q, d, 0, cols);  // no sums: exact, slow
#elif defined(FASTPACK_HAVE_AVX2_I8)
                const int32_t acc = dot_i8_avx2(q, d, cols);
#else
                const int32_t acc = dot_i8_scalar(q, d, 0, cols);
#endif
                scores[r] = static_cast<float>(acc) * sq * row_scales[r];
            }
        });
        fastpack_topk_f32(scores.data(), rows, cc,
                          out_vals + qi * c, out_idx + qi * c);
    }
}

// 1 when the VNNI tier is compiled in (callers must then pass row_sums).
int fastpack_int8_needs_row_sums() {
#if defined(FASTPACK_HAVE_VNNI)
    return 1;
#else
    return 0;
#endif
}

int fastpack_abi_version() { return 4; }

}  // extern "C"

// --- SQLite embedding scan --------------------------------------------------
//
// The cold-start bottleneck is not the disk: it is Python — sqlite3-module
// row tuples, one bytes object per 6 KB blob, and interpreter-loop copies
// (measured ~40 s per 200k x 1536 rows; the streaming Python rewrite got
// it to ~7 s).  This scanner walks the statement with the SQLite C API and
// memcpys blobs straight into the caller's preallocated buffer: no Python
// objects at all.  libsqlite3 is resolved at runtime via dlopen (no
// sqlite3.h needed at build time; the C ABI below is stable); if the
// library is missing the entry point reports failure and Python falls
// back to its streaming scan.
//
// Snapshot safety is the CALLER's job: the Python side holds a shared read
// lock (non-WAL journal) for the duration and verifies row count + max id
// against its own transaction snapshot, falling back on any mismatch.

#include <dlfcn.h>

namespace sqscan {

struct sqlite3;
struct sqlite3_stmt;

struct Api {
    int (*open_v2)(const char*, sqlite3**, int, const char*) = nullptr;
    int (*prepare_v2)(sqlite3*, const char*, int, sqlite3_stmt**,
                      const char**) = nullptr;
    int (*bind_int64)(sqlite3_stmt*, int, long long) = nullptr;
    int (*step)(sqlite3_stmt*) = nullptr;
    long long (*column_int64)(sqlite3_stmt*, int) = nullptr;
    const void* (*column_blob)(sqlite3_stmt*, int) = nullptr;
    int (*column_bytes)(sqlite3_stmt*, int) = nullptr;
    int (*finalize)(sqlite3_stmt*) = nullptr;
    int (*close_fn)(sqlite3*) = nullptr;
    bool ok = false;
};

const Api& api() {
    static Api a = [] {
        Api r;
        void* h = dlopen("libsqlite3.so.0", RTLD_NOW | RTLD_GLOBAL);
        if (!h) h = dlopen("libsqlite3.so", RTLD_NOW | RTLD_GLOBAL);
        if (!h) return r;
        auto sym = [h](const char* name) { return dlsym(h, name); };
        r.open_v2 = reinterpret_cast<decltype(r.open_v2)>(sym("sqlite3_open_v2"));
        r.prepare_v2 =
            reinterpret_cast<decltype(r.prepare_v2)>(sym("sqlite3_prepare_v2"));
        r.bind_int64 =
            reinterpret_cast<decltype(r.bind_int64)>(sym("sqlite3_bind_int64"));
        r.step = reinterpret_cast<decltype(r.step)>(sym("sqlite3_step"));
        r.column_int64 = reinterpret_cast<decltype(r.column_int64)>(
            sym("sqlite3_column_int64"));
        r.column_blob = reinterpret_cast<decltype(r.column_blob)>(
            sym("sqlite3_column_blob"));
        r.column_bytes = reinterpret_cast<decltype(r.column_bytes)>(
            sym("sqlite3_column_bytes"));
        r.finalize = reinterpret_cast<decltype(r.finalize)>(sym("sqlite3_finalize"));
        r.close_fn = reinterpret_cast<decltype(r.close_fn)>(sym("sqlite3_close"));
        r.ok = r.open_v2 && r.prepare_v2 && r.bind_int64 && r.step &&
               r.column_int64 && r.column_blob && r.column_bytes &&
               r.finalize && r.close_fn;
        return r;
    }();
    return a;
}

constexpr int kOpenReadonly = 0x1;
constexpr int kRow = 100;
constexpr int kDone = 101;

}  // namespace sqscan

extern "C" {

// Scan embeddings with after_id < id <= upto_id (id order) into ids_out /
// buf_out (caller-allocated for expect_n rows of row_bytes each).  Returns
// the number of rows read, or a negative error: -1 libsqlite3 unavailable,
// -2 open failed, -3 prepare failed, -4 blob size mismatch, -5 more rows
// than expect_n, -6 step error.  Disjoint id ranges scanned from separate
// threads (each gets its own connection here) parallelize the btree walk —
// the single-connection scan measured ~75 s at 1M x 6 KB blobs, dominated
// by overflow-page chain traversal, which is CPU-parallel over ranges.
long long fastpack_scan_embeddings_range(const char* path, long long after_id,
                                         long long upto_id, long long expect_n,
                                         long long row_bytes,
                                         long long* ids_out,
                                         unsigned char* buf_out) {
    const sqscan::Api& api = sqscan::api();
    if (!api.ok) return -1;
    sqscan::sqlite3* db = nullptr;
    if (api.open_v2(path, &db, sqscan::kOpenReadonly, nullptr) != 0 || !db) {
        if (db) api.close_fn(db);
        return -2;
    }
    sqscan::sqlite3_stmt* stmt = nullptr;
    const char* sql =
        "SELECT id, embedding FROM embeddings "
        "WHERE id > ?1 AND id <= ?2 ORDER BY id";
    if (api.prepare_v2(db, sql, -1, &stmt, nullptr) != 0 || !stmt) {
        api.close_fn(db);
        return -3;
    }
    api.bind_int64(stmt, 1, after_id);
    api.bind_int64(stmt, 2, upto_id);
    long long n = 0;
    long long rc_out = 0;
    unsigned char* dst = buf_out;
    for (;;) {
        const int rc = api.step(stmt);
        if (rc == sqscan::kDone) break;
        if (rc != sqscan::kRow) {
            rc_out = -6;
            break;
        }
        if (n >= expect_n) {
            rc_out = -5;
            break;
        }
        const void* blob = api.column_blob(stmt, 1);
        if (api.column_bytes(stmt, 1) != row_bytes || blob == nullptr) {
            rc_out = -4;
            break;
        }
        ids_out[n] = api.column_int64(stmt, 0);
        std::memcpy(dst, blob, static_cast<size_t>(row_bytes));
        dst += row_bytes;
        ++n;
    }
    api.finalize(stmt);
    api.close_fn(db);
    return rc_out < 0 ? rc_out : n;
}

long long fastpack_scan_embeddings(const char* path, long long after_id,
                                   long long expect_n, long long row_bytes,
                                   long long* ids_out, unsigned char* buf_out) {
    return fastpack_scan_embeddings_range(
        path, after_id, (1LL << 62), expect_n, row_bytes, ids_out, buf_out);
}

}  // extern "C"
