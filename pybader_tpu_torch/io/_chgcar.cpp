// One pass from a CHGCAR density block's bytes to its x-major grid.
//
// A VASP density block is the grid's nx*ny*nz values as whitespace
// separated text, x fastest, then y, then z.  The reader wants them as
// out[x, y, z] (z fastest), each divided by the cell volume.  This file
// does it in one native pass over the mapped file, on every core:
//
//   1. count: the block is cut at whitespace into chunks, and each
//      thread counts the tokens of the chunks it takes; a prefix sum
//      gives the index of every chunk's first value, so nothing assumes
//      that the lines have one width;
//   2. parse: each thread takes slabs of SLAB z-planes, finds the slab's
//      first value from the chunk counts, parses the slab into its own
//      tile, and writes the tile transposed into out, SLAB values of z
//      (one cache line) at each (x, y), each value v / volume.
//
// Values are parsed exactly.  VASP's token, 12 digits with 11 after the
// point and a two-digit exponent, is one correctly rounded multiply or
// divide of two exact doubles where its power of ten is within 10^±22
// (Clinger's fast path); every other token goes to std::from_chars.  Both
// round to nearest, as Python's float() does, so the grid is bit-equal to
// a parse of the text followed by the axis swap and the division.
//
// Exposed C ABI (used from Python via ctypes, see _fastparse.py):
//   long chg_read_block(const char* path, long offset, long nx, long ny,
//                       long nz, double volume, double* out,
//                       int n_threads, long* info);
// reads the block that starts at byte ``offset``; with ``out`` NULL it
// only finds the block's end.  Returns the byte offset past the line of
// the block's last value, or a negative code: -1 the file cannot be
// opened or mapped, -2 it ends before nx*ny*nz values (info[0]: the
// values found), -3 a token is no number (info[1]: its byte offset).

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <charconv>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

namespace {

constexpr long SLAB = 8;               // z-planes a tile: 64 bytes of out
constexpr long MIN_CHUNK = 4 << 10;
constexpr long MAX_CHUNK = 1 << 20;

// every byte at or below ' ' separates tokens, on both passes
inline bool sep(char c) { return static_cast<unsigned char>(c) <= ' '; }

inline bool digit(char c) {
    return static_cast<unsigned char>(c - '0') < 10;
}

// The 8 bytes at p as a number where all are digits (SWAR: three
// multiplies in place of a chain of eight; the host is little-endian).
inline bool eight_digits(const char* p, uint64_t* v) {
    uint64_t x;
    std::memcpy(&x, p, 8);
    if ((((x & 0xF0F0F0F0F0F0F0F0) |
          (((x + 0x0606060606060606) & 0xF0F0F0F0F0F0F0F0) >> 4)) !=
         0x3333333333333333))
        return false;
    x -= 0x3030303030303030;
    x = (x * 10) + (x >> 8);
    x = (((x & 0x000000FF000000FF) * (100 + (1000000ULL << 32))) +
         (((x >> 16) & 0x000000FF000000FF) * (1 + (10000ULL << 32)))) >> 32;
    *v = static_cast<uint32_t>(x);
    return true;
}

constexpr double POW10[23] = {
    1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,  1e8,  1e9,  1e10, 1e11,
    1e12, 1e13, 1e14, 1e15, 1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22};

// VASP's token, [-]d.dddddddddddE+dd or [-].dddddddddddE+dd (11 digits
// after the point, either case of E), at p into *v; nullptr for any
// other token or where the value needs more than Clinger's fast path:
// the mantissa (12 digits) is exact, and so is a power of ten up to
// 10^22, so one multiply or divide of the two rounds correctly.
inline const char* parse_vasp(const char* p, const char* end, double* v) {
    bool neg = p < end && *p == '-';
    const char* q = p + neg;
    if (end - q < 18) return nullptr;
    int lead = digit(q[0]);  // the digit before the point, if any
    const char* f = q + lead;
    uint64_t hi;
    if (f[0] != '.' || !eight_digits(f + 1, &hi) || !digit(f[9]) ||
        !digit(f[10]) || !digit(f[11]) || (f[12] != 'E' && f[12] != 'e') ||
        (f[13] != '-' && f[13] != '+') || !digit(f[14]) || !digit(f[15]) ||
        !sep(f[16]))
        return nullptr;
    uint64_t m = ((lead ? q[0] - '0' : 0) * 100000000ULL + hi) * 1000 +
                 (f[9] - '0') * 100 + (f[10] - '0') * 10 + (f[11] - '0');
    int e = (f[14] - '0') * 10 + (f[15] - '0');
    int k = (f[13] == '-' ? -e : e) - 11;
    double d = static_cast<double>(m);
    if (m != 0) {
        if (k < -22 || k > 22) return nullptr;
        d = k < 0 ? d / POW10[-k] : d * POW10[k];
    }
    *v = neg ? -d : d;
    return f + 16;
}

// The token at p (not a separator) into *v; the end of the token, or
// nullptr where it is no number or does not end at a separator.
inline const char* parse_token(const char* p, const char* end, double* v) {
    const char* q = parse_vasp(p, end, v);
    if (q != nullptr) return q;
    auto res = std::from_chars(p, end, *v);
    if (res.ec != std::errc() || (res.ptr < end && !sep(*res.ptr)))
        return nullptr;
    return res.ptr;
}

long count_tokens(const char* p, const char* end) {
    // a token starts at a byte that is no separator after one that is;
    // a chunk starts at a separator, or at the block's start
    if (p >= end) return 0;
    long n = !sep(*p);
    for (const char* q = p + 1; q < end; ++q) n += sep(q[-1]) & !sep(*q);
    return n;
}

// past the n-th token from p (n >= 0); p is at a separator or a token
inline const char* skip_tokens(const char* p, const char* end, long n) {
    for (; n > 0; --n) {
        while (p < end && sep(*p)) ++p;
        while (p < end && !sep(*p)) ++p;
    }
    return p;
}

template <class F>
void run(int n_threads, F&& work) {
    if (n_threads <= 1) {
        work();
        return;
    }
    std::vector<std::thread> pool;
    pool.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) pool.emplace_back(work);
    for (auto& th : pool) th.join();
}

struct Mapped {
    const char* data = nullptr;
    long size = 0;
    ~Mapped() {
        if (data != nullptr) munmap(const_cast<char*>(data), size);
    }
};

long read_block(const char* base, long len, long nx, long ny, long nz,
                double volume, double* out, int n_threads, long* info) {
    const long n = nx * ny * nz;
    const char* end = base + len;
    // the block's length as its first line promises: where counting stops
    // unless the lines after it are narrower
    const char* eol = std::find(base, end, '\n');
    long first = count_tokens(base, eol);
    long guess = first > 0 ? (n / first + 2) * (eol - base + 1) : len;
    long chunk = std::clamp(guess / (32L * n_threads), MIN_CHUNK, MAX_CHUNK);

    // 1. chunk starts (at separators) and their token counts, until the
    // block's n values are inside
    std::vector<long> starts{0}, counts;
    long total = 0;
    for (long hi = std::min(len, guess); total < n;) {
        long lo = starts.back();
        for (long b = lo + chunk; b < hi; b += chunk) {
            while (b < len && !sep(base[b])) ++b;
            if (b >= hi) break;
            starts.push_back(b);
        }
        while (hi < len && !sep(base[hi])) ++hi;
        starts.push_back(hi);
        size_t first_new = counts.size();
        counts.resize(starts.size() - 1);
        std::atomic<size_t> next{first_new};
        run(std::min<long>(n_threads, counts.size() - first_new), [&] {
            for (size_t c; (c = next++) < counts.size();)
                counts[c] = count_tokens(base + starts[c],
                                         base + starts[c + 1]);
        });
        for (size_t c = first_new; c < counts.size(); ++c) total += counts[c];
        if (hi >= len) break;
        // the lines run narrower than the first: count on, by as much again
        // as the rest needs at the width seen so far
        long more = total > 0 ? (n - total) * (hi / total + 1) : hi;
        hi = std::min(len, hi + std::max(more, chunk));
    }
    if (total < n) {
        info[0] = total;
        return -2;
    }
    // prefix[c]: the values before chunk c
    std::vector<long> prefix(counts.size() + 1, 0);
    for (size_t c = 0; c < counts.size(); ++c)
        prefix[c + 1] = prefix[c] + counts[c];
    auto locate = [&](long i) {  // the byte of value i's chunk, and skip i
        size_t c = std::upper_bound(prefix.begin(), prefix.end(), i) -
                   prefix.begin() - 1;
        return skip_tokens(base + starts[c], end, i - prefix[c]);
    };
    // the block ends with the line of its last value
    const char* last = locate(n - 1);
    while (last < end && sep(*last)) ++last;
    while (last < end && *last != '\n') ++last;
    long block_end = (last < end ? last + 1 : end) - base;
    if (out == nullptr) return block_end;

    // 2. slabs of SLAB planes: parse into a tile, write it transposed
    const long plane = nx * ny, slabs = (nz + SLAB - 1) / SLAB;
    std::atomic<long> next_slab{0};
    std::atomic<long> bad{-1};
    run(std::min<long>(n_threads, slabs), [&] {
        std::unique_ptr<double[]> tile(new double[SLAB * plane]);
        for (long s; (s = next_slab++) < slabs && bad.load() < 0;) {
            long z0 = s * SLAB, planes = std::min(SLAB, nz - z0);
            long count = planes * plane;
            const char* p = locate(z0 * plane);
            for (long i = 0; i < count; ++i) {
                while (sep(*p)) ++p;  // a value lies ahead: no bound needed
                const char* q = parse_token(p, end, &tile[i]);
                if (q == nullptr) {
                    long seen = -1;
                    bad.compare_exchange_strong(seen, p - base);
                    return;
                }
                p = q;
            }
            for (long y = 0; y < ny; ++y) {
                for (long x = 0; x < nx; ++x) {
                    double* dst = out + (x * ny + y) * nz + z0;
                    const double* src = tile.get() + y * nx + x;
                    for (long k = 0; k < planes; ++k)
                        dst[k] = src[k * plane] / volume;
                }
            }
        }
    });
    if (bad.load() >= 0) {
        info[1] = bad.load();
        return -3;
    }
    return block_end;
}

}  // namespace

extern "C" {

long chg_read_block(const char* path, long offset, long nx, long ny,
                    long nz, double volume, double* out, int n_threads,
                    long* info) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return -1;
    struct stat st {};
    bool sized = fstat(fd, &st) == 0;
    if (sized && st.st_size <= offset) {
        close(fd);
        info[0] = 0;
        return -2;
    }
    // the file from the block's page on, its pages mapped at once: one
    // call in place of a fault a page
    long page = sysconf(_SC_PAGESIZE);
    long start = offset / page * page;
    Mapped map;
    if (sized) {
        void* p = mmap(nullptr, st.st_size - start, PROT_READ,
                       MAP_PRIVATE | MAP_POPULATE, fd, start);
        if (p != MAP_FAILED) {
            map.data = static_cast<const char*>(p);
            map.size = st.st_size - start;
        }
    }
    close(fd);
    if (map.data == nullptr) return -1;
    if (n_threads < 1) n_threads = 1;
    long skip = offset - start;
    long got = read_block(map.data + skip, map.size - skip, nx, ny, nz,
                          volume, out, n_threads, info);
    return got < 0 ? got : got + offset;
}

}  // extern "C"
