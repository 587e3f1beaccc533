// SNP .snpdat codec — native host-side component of adelie_tpu.
//
// Re-implementation of the reference's packed-SNP file formats
// (adelie/src/include/adelie_core/io/io_snp_unphased.{hpp,ipp} and
// io_snp_phased_ancestry.{hpp,ipp}): per-SNP, per-category sparse CHUNKED
// encoding — 256-element chunks, u32 chunk index + u8 (nnz-1) + u8 inner
// indices (chunk_size = 256, io_snp_unphased.hpp:157-160).
//
// In addition to the reference's decode-to-dense, this codec decodes
// straight into the TPU-friendly **2-bit packed** layout (4 entries per
// byte, column-major) that the device matrix classes unpack on the fly
// inside their matmuls (adelie_tpu/matrix/snp.py).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

using outer_t = uint64_t;
using inner_t = uint32_t;
using chunk_inner_t = uint8_t;

static constexpr size_t CHUNK = 256;
static constexpr size_t N_CTG = 3;  // categories: NA(0), 1, 2

namespace {

struct Buf {
    std::vector<char> data;
    size_t idx = 0;
    void put(const void* src, size_t bytes) {
        if (idx + bytes > data.size()) data.resize((idx + bytes) * 2);
        std::memcpy(data.data() + idx, src, bytes);
        idx += bytes;
    }
    template <class T>
    void put_v(T v) { put(&v, sizeof(T)); }
};

template <class T>
T read_as(const char* p) {
    T out;
    std::memcpy(&out, p, sizeof(T));
    return out;
}

// encode one index list as chunked sparse (reference io_snp_unphased.ipp
// inner_routine): [u32 n_chunks] + per nonempty chunk
// [u32 chunk_idx][u8 nnz-1][u8 inner...]
void encode_chunks(Buf& buf, const std::vector<inner_t>& idxs) {
    size_t nchunk_pos = buf.idx;
    buf.put_v<inner_t>(0);  // placeholder
    inner_t n_chunks = 0;
    size_t i = 0;
    while (i < idxs.size()) {
        inner_t ck = idxs[i] / CHUNK;
        size_t j = i;
        while (j < idxs.size() && idxs[j] / CHUNK == ck) ++j;
        buf.put_v<inner_t>(ck);
        buf.put_v<chunk_inner_t>(static_cast<chunk_inner_t>(j - i - 1));
        for (size_t k = i; k < j; ++k) {
            buf.put_v<chunk_inner_t>(static_cast<chunk_inner_t>(idxs[k] % CHUNK));
        }
        ++n_chunks;
        i = j;
    }
    std::memcpy(buf.data.data() + nchunk_pos, &n_chunks, sizeof(inner_t));
}

// decode one chunk list, calling f(dense_index) per entry
template <class F>
const char* decode_chunks(const char* p, F f) {
    inner_t n_chunks = read_as<inner_t>(p);
    p += sizeof(inner_t);
    for (inner_t c = 0; c < n_chunks; ++c) {
        inner_t ck = read_as<inner_t>(p);
        p += sizeof(inner_t);
        inner_t nnz = static_cast<inner_t>(*reinterpret_cast<const chunk_inner_t*>(p)) + 1;
        p += sizeof(chunk_inner_t);
        for (inner_t k = 0; k < nnz; ++k) {
            inner_t inner = *reinterpret_cast<const chunk_inner_t*>(p + k);
            f(static_cast<size_t>(ck) * CHUNK + inner);
        }
        p += nnz * sizeof(chunk_inner_t);
    }
    return p;
}

bool write_file(const char* filename, const Buf& buf, uint64_t* total_bytes) {
    FILE* fp = std::fopen(filename, "wb");
    if (!fp) return false;
    size_t written = std::fwrite(buf.data.data(), 1, buf.idx, fp);
    std::fclose(fp);
    *total_bytes = written;
    return written == buf.idx;
}

std::vector<char> read_file_buffered(const char* filename) {
    FILE* fp = std::fopen(filename, "rb");
    if (!fp) return {};
    std::fseek(fp, 0, SEEK_END);
    long sz = std::ftell(fp);
    std::fseek(fp, 0, SEEK_SET);
    std::vector<char> out(sz);
    size_t got = std::fread(out.data(), 1, sz, fp);
    std::fclose(fp);
    if (got != static_cast<size_t>(sz)) out.clear();
    return out;
}

// read mode: 0 = buffered file IO, 1 = mmap (reference
// io_snp_base.hpp:25-87 read_mode_type {_file, _mmap})
std::atomic<int> g_read_mode{0};

// A read-only view of a file: either an owned buffer (file mode) or an
// mmap'ed region unmapped on destruction (mmap mode).
struct FileView {
    const char* ptr = nullptr;
    size_t len = 0;
    std::vector<char> owned;
    void* map = nullptr;
    size_t map_size = 0;

    FileView() = default;
    FileView(const FileView&) = delete;
    FileView& operator=(const FileView&) = delete;
    FileView(FileView&& o) noexcept { *this = std::move(o); }
    FileView& operator=(FileView&& o) noexcept {
        owned = std::move(o.owned);
        ptr = o.ptr; len = o.len; map = o.map; map_size = o.map_size;
        o.map = nullptr; o.ptr = nullptr;
        return *this;
    }
    ~FileView() {
        if (map) munmap(map, map_size);
    }
    bool empty() const { return ptr == nullptr || len == 0; }
    size_t size() const { return len; }
    const char* data() const { return ptr; }
};

FileView read_file(const char* filename) {
    FileView v;
    if (g_read_mode.load(std::memory_order_relaxed) == 1) {
        int fd = open(filename, O_RDONLY);
        if (fd < 0) return v;
        struct stat st;
        if (fstat(fd, &st) != 0 || st.st_size <= 0) { close(fd); return v; }
        void* m = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
        close(fd);
        if (m == MAP_FAILED) return v;
        v.map = m;
        v.map_size = static_cast<size_t>(st.st_size);
        v.ptr = static_cast<const char*>(m);
        v.len = v.map_size;
        return v;
    }
    v.owned = read_file_buffered(filename);
    v.ptr = v.owned.data();
    v.len = v.owned.size();
    return v;
}

}  // namespace

extern "C" {

// 0 = buffered file IO, 1 = mmap (reference read_mode, io_snp_base.hpp)
void snpio_set_read_mode(int mode) {
    g_read_mode.store(mode ? 1 : 0, std::memory_order_relaxed);
}

// ---------------------------------------------------------------------- //
// unphased                                                                //
// ---------------------------------------------------------------------- //

// calldata: (n, p) int8 COLUMN-major; values {0,1,2} or negative = NA.
// impute_method: 0 = mean (values in [0,2], over non-missing),
//                1 = zero.
// impute_out: (p,) f64 output.  Returns total bytes written, or 0 on error.
uint64_t snpio_unphased_write(
    const char* filename,
    const int8_t* calldata,
    uint64_t n,
    uint64_t p,
    int impute_method,
    double* impute_out
) {
    // header pieces
    std::vector<outer_t> nnz(p), nnm(p);
    std::vector<double> impute(p);
    std::vector<std::vector<inner_t>> cat_idx(N_CTG);

    // column payloads
    std::vector<std::vector<char>> colbufs(p);
    for (uint64_t j = 0; j < p; ++j) {
        const int8_t* col = calldata + j * n;
        double sum = 0;
        outer_t n_nm = 0, n_nz = 0;
        for (auto& v : cat_idx) v.clear();
        for (uint64_t i = 0; i < n; ++i) {
            int8_t v = col[i];
            if (v >= static_cast<int8_t>(N_CTG)) return 0;  // invalid
            if (v < 0) {
                cat_idx[0].push_back(static_cast<inner_t>(i));
                ++n_nz;
            } else {
                ++n_nm;
                sum += v;
                if (v > 0) {
                    cat_idx[v].push_back(static_cast<inner_t>(i));
                    ++n_nz;
                }
            }
        }
        nnm[j] = n_nm;
        nnz[j] = n_nz;
        impute[j] = (impute_method == 0 && n_nm > 0) ? (sum / n_nm) : 0.0;
        impute_out[j] = impute[j];

        Buf cb;
        // 3 category offsets relative to column start
        // (reference io_snp_unphased.ipp:239-246)
        size_t off_pos = cb.idx;
        for (size_t c = 0; c < N_CTG; ++c) cb.put_v<outer_t>(0);
        for (size_t c = 0; c < N_CTG; ++c) {
            outer_t off = cb.idx;
            std::memcpy(cb.data.data() + off_pos + c * sizeof(outer_t), &off,
                        sizeof(outer_t));
            encode_chunks(cb, cat_idx[c]);
        }
        colbufs[j].assign(cb.data.begin(), cb.data.begin() + cb.idx);
    }

    // assemble file
    Buf out;
    out.put_v<outer_t>(n);
    out.put_v<outer_t>(p);
    out.put(nnz.data(), sizeof(outer_t) * p);
    out.put(nnm.data(), sizeof(outer_t) * p);
    out.put(impute.data(), sizeof(double) * p);
    std::vector<outer_t> outer(p + 1);
    outer[0] = out.idx + sizeof(outer_t) * (p + 1);
    for (uint64_t j = 0; j < p; ++j) outer[j + 1] = outer[j] + colbufs[j].size();
    out.put(outer.data(), sizeof(outer_t) * (p + 1));
    for (uint64_t j = 0; j < p; ++j) out.put(colbufs[j].data(), colbufs[j].size());

    uint64_t total = 0;
    if (!write_file(filename, out, &total)) return 0;
    return total;
}

// Parse header only: returns 1 on success.
int snpio_unphased_header(
    const char* filename,
    uint64_t* n_out,
    uint64_t* p_out
) {
    auto buf = read_file(filename);
    if (buf.size() < 2 * sizeof(outer_t)) return 0;
    *n_out = read_as<outer_t>(buf.data());
    *p_out = read_as<outer_t>(buf.data() + sizeof(outer_t));
    return 1;
}

// Decode into 2-bit packed column-major (ceil(n/4), p) uint8; value 3 = NA.
// Also fills nnz/nnm (u64 x p) and impute (f64 x p).  Returns 1 on success.
int snpio_unphased_read_packed(
    const char* filename,
    uint8_t* packed,     // (ceil(n/4) * p) bytes, caller-zeroed
    uint64_t* nnz_out,
    uint64_t* nnm_out,
    double* impute_out
) {
    auto buf = read_file(filename);
    if (buf.empty()) return 0;
    const char* ptr = buf.data();
    outer_t n = read_as<outer_t>(ptr);
    outer_t p = read_as<outer_t>(ptr + sizeof(outer_t));
    size_t idx = 2 * sizeof(outer_t);
    std::memcpy(nnz_out, ptr + idx, sizeof(outer_t) * p);
    idx += sizeof(outer_t) * p;
    std::memcpy(nnm_out, ptr + idx, sizeof(outer_t) * p);
    idx += sizeof(outer_t) * p;
    std::memcpy(impute_out, ptr + idx, sizeof(double) * p);
    idx += sizeof(double) * p;
    std::vector<outer_t> outer(p + 1);
    std::memcpy(outer.data(), ptr + idx, sizeof(outer_t) * (p + 1));

    const size_t nb = (n + 3) / 4;
    for (outer_t j = 0; j < p; ++j) {
        const char* col = ptr + outer[j];
        uint8_t* pk = packed + j * nb;
        for (size_t c = 0; c < N_CTG; ++c) {
            outer_t off = read_as<outer_t>(col + c * sizeof(outer_t));
            uint8_t val = (c == 0) ? 3 : static_cast<uint8_t>(c);
            decode_chunks(col + off, [&](size_t i) {
                pk[i / 4] |= val << (2 * (i % 4));
            });
        }
    }
    return 1;
}

// Decode to dense int8 (n, p) column-major with NA = -9.
int snpio_unphased_read_dense(
    const char* filename,
    int8_t* dense
) {
    auto buf = read_file(filename);
    if (buf.empty()) return 0;
    const char* ptr = buf.data();
    outer_t n = read_as<outer_t>(ptr);
    outer_t p = read_as<outer_t>(ptr + sizeof(outer_t));
    size_t idx = 2 * sizeof(outer_t) + (2 * p) * sizeof(outer_t) +
                 p * sizeof(double);
    std::vector<outer_t> outer(p + 1);
    std::memcpy(outer.data(), ptr + idx, sizeof(outer_t) * (p + 1));
    for (outer_t j = 0; j < p; ++j) {
        const char* col = ptr + outer[j];
        int8_t* dj = dense + j * n;
        for (size_t c = 0; c < N_CTG; ++c) {
            outer_t off = read_as<outer_t>(col + c * sizeof(outer_t));
            int8_t val = (c == 0) ? -9 : static_cast<int8_t>(c);
            decode_chunks(col + off, [&](size_t i) { dj[i] = val; });
        }
    }
    return 1;
}

// ---------------------------------------------------------------------- //
// phased ancestry                                                         //
// ---------------------------------------------------------------------- //

// calldata/ancestries: (n, 2*s) int8 COLUMN-major.
// Matrix semantics (reference matrix.py snp_phased_ancestry / io.py:7-43):
// output column j = snp*A + anc has value
//   sum_hap calldata[i, 2*snp+hap] * 1{ancestries[i, 2*snp+hap] == anc}.
// File layout mirrors io_snp_phased_ancestry.{hpp,ipp}: header
// [n][s][A][nnz0 x sA][nnz1 x sA][outer x (s+1)], then per-snp block:
// A u64 ancestry offsets (relative to block), each: 2 u64 hap offsets
// (relative to ancestry block), each: chunked index list.
uint64_t snpio_phased_write(
    const char* filename,
    const int8_t* calldata,
    const int8_t* ancestries,
    uint64_t n,
    uint64_t s2,   // = 2*s
    uint64_t A
) {
    if (s2 % 2) return 0;
    const uint64_t s = s2 / 2;
    std::vector<outer_t> nnz0(s * A, 0), nnz1(s * A, 0);
    std::vector<std::vector<char>> snpbufs(s);

    for (uint64_t snp = 0; snp < s; ++snp) {
        Buf sb;
        size_t anc_off_pos = sb.idx;
        for (uint64_t a = 0; a < A; ++a) sb.put_v<outer_t>(0);
        for (uint64_t a = 0; a < A; ++a) {
            outer_t aoff = sb.idx;
            std::memcpy(sb.data.data() + anc_off_pos + a * sizeof(outer_t),
                        &aoff, sizeof(outer_t));
            size_t hap_off_pos = sb.idx;
            sb.put_v<outer_t>(0);
            sb.put_v<outer_t>(0);
            for (int hap = 0; hap < 2; ++hap) {
                outer_t hoff = sb.idx - aoff;
                std::memcpy(sb.data.data() + hap_off_pos + hap * sizeof(outer_t),
                            &hoff, sizeof(outer_t));
                const int8_t* call = calldata + (2 * snp + hap) * n;
                const int8_t* anc = ancestries + (2 * snp + hap) * n;
                std::vector<inner_t> idxs;
                for (uint64_t i = 0; i < n; ++i) {
                    if (call[i] && anc[i] == static_cast<int8_t>(a)) {
                        idxs.push_back(static_cast<inner_t>(i));
                    }
                }
                if (hap == 0) nnz0[snp * A + a] = idxs.size();
                else nnz1[snp * A + a] = idxs.size();
                encode_chunks(sb, idxs);
            }
        }
        snpbufs[snp].assign(sb.data.begin(), sb.data.begin() + sb.idx);
    }

    Buf out;
    out.put_v<outer_t>(n);
    out.put_v<outer_t>(s);
    out.put_v<outer_t>(A);
    out.put(nnz0.data(), sizeof(outer_t) * s * A);
    out.put(nnz1.data(), sizeof(outer_t) * s * A);
    std::vector<outer_t> outer(s + 1);
    outer[0] = out.idx + sizeof(outer_t) * (s + 1);
    for (uint64_t j = 0; j < s; ++j) outer[j + 1] = outer[j] + snpbufs[j].size();
    out.put(outer.data(), sizeof(outer_t) * (s + 1));
    for (uint64_t j = 0; j < s; ++j) out.put(snpbufs[j].data(), snpbufs[j].size());

    uint64_t total = 0;
    if (!write_file(filename, out, &total)) return 0;
    return total;
}

int snpio_phased_header(
    const char* filename,
    uint64_t* n_out,
    uint64_t* s_out,
    uint64_t* A_out
) {
    auto buf = read_file(filename);
    if (buf.size() < 3 * sizeof(outer_t)) return 0;
    *n_out = read_as<outer_t>(buf.data());
    *s_out = read_as<outer_t>(buf.data() + sizeof(outer_t));
    *A_out = read_as<outer_t>(buf.data() + 2 * sizeof(outer_t));
    return 1;
}

// Decode into 2-bit packed column-major (ceil(n/4), s*A) uint8 with values
// {0,1,2} (hap sums; never NA).
int snpio_phased_read_packed(
    const char* filename,
    uint8_t* packed,  // caller-zeroed
    uint64_t* nnz0_out,
    uint64_t* nnz1_out
) {
    auto buf = read_file(filename);
    if (buf.empty()) return 0;
    const char* ptr = buf.data();
    outer_t n = read_as<outer_t>(ptr);
    outer_t s = read_as<outer_t>(ptr + sizeof(outer_t));
    outer_t A = read_as<outer_t>(ptr + 2 * sizeof(outer_t));
    size_t idx = 3 * sizeof(outer_t);
    std::memcpy(nnz0_out, ptr + idx, sizeof(outer_t) * s * A);
    idx += sizeof(outer_t) * s * A;
    std::memcpy(nnz1_out, ptr + idx, sizeof(outer_t) * s * A);
    idx += sizeof(outer_t) * s * A;
    std::vector<outer_t> outer(s + 1);
    std::memcpy(outer.data(), ptr + idx, sizeof(outer_t) * (s + 1));

    const size_t nb = (n + 3) / 4;
    for (outer_t snp = 0; snp < s; ++snp) {
        const char* sbl = ptr + outer[snp];
        for (outer_t a = 0; a < A; ++a) {
            outer_t aoff = read_as<outer_t>(sbl + a * sizeof(outer_t));
            const char* abl = sbl + aoff;
            uint8_t* pk = packed + (snp * A + a) * nb;
            for (int hap = 0; hap < 2; ++hap) {
                outer_t hoff = read_as<outer_t>(abl + hap * sizeof(outer_t));
                decode_chunks(abl + hoff, [&](size_t i) {
                    // add 1 to the 2-bit slot (values stay <= 2)
                    uint8_t cur = (pk[i / 4] >> (2 * (i % 4))) & 3;
                    pk[i / 4] =
                        (pk[i / 4] & ~(3 << (2 * (i % 4)))) |
                        ((cur + 1) << (2 * (i % 4)));
                });
            }
        }
    }
    return 1;
}

}  // extern "C"
