// Multithreaded BGZF block compressor.
//
// Counterpart of the reference's contrib bamtools/htslib BGZF writers
// (used by io/output/output_bam.h): the BAM byte stream is chopped into
// <=64KiB blocks, each deflated independently, so compression parallelizes
// perfectly across a thread pool. Exposed to Python via ctypes; the Python
// layer does the framing-compatible single-threaded fallback when this
// library is unavailable.
//
// Build: g++ -O3 -fPIC -shared bgzf.cpp -lz

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#include <zlib.h>

namespace {

constexpr size_t MAX_PAYLOAD = 65280;
constexpr size_t HEADER_SIZE = 18;   // gzip header + BC extra subfield
constexpr size_t FOOTER_SIZE = 8;    // crc32 + isize
// worst-case deflate expansion for an incompressible 64K block
constexpr size_t MAX_BLOCK = HEADER_SIZE + MAX_PAYLOAD + 1024 + FOOTER_SIZE;

// deflate one payload into a complete BGZF block; returns block size or 0
size_t compress_block(const uint8_t* src, size_t n, int level, uint8_t* dst) {
    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8,
                     Z_DEFAULT_STRATEGY) != Z_OK)
        return 0;
    zs.next_in = const_cast<uint8_t*>(src);
    zs.avail_in = static_cast<uInt>(n);
    zs.next_out = dst + HEADER_SIZE;
    zs.avail_out = static_cast<uInt>(MAX_BLOCK - HEADER_SIZE - FOOTER_SIZE);
    if (deflate(&zs, Z_FINISH) != Z_STREAM_END) {
        deflateEnd(&zs);
        return 0;
    }
    size_t cdata = zs.total_out;
    deflateEnd(&zs);

    size_t bsize = HEADER_SIZE + cdata + FOOTER_SIZE;
    if (bsize - 1 > 0xFFFF) return 0;
    static const uint8_t hdr_fixed[16] = {
        0x1F, 0x8B, 0x08, 0x04, 0, 0, 0, 0, 0, 0xFF,
        6, 0, 0x42, 0x43, 2, 0};
    std::memcpy(dst, hdr_fixed, 16);
    uint16_t bs16 = static_cast<uint16_t>(bsize - 1);
    std::memcpy(dst + 16, &bs16, 2);
    uint32_t crc = crc32(0, src, static_cast<uInt>(n));
    uint32_t isize = static_cast<uint32_t>(n);
    std::memcpy(dst + HEADER_SIZE + cdata, &crc, 4);
    std::memcpy(dst + HEADER_SIZE + cdata + 4, &isize, 4);
    return bsize;
}

}  // namespace

extern "C" {

// Compress `n` bytes into BGZF blocks using `n_threads` workers.
// dst must hold at least ceil(n / MAX_PAYLOAD) * MAX_BLOCK bytes (plus one
// block if n == 0). Returns total compressed size, or -1 on error.
// block_sizes (optional, may be null) receives per-block compressed sizes.
int64_t nvbio_tpu_bgzf_compress(const uint8_t* src, int64_t n, int level,
                                int n_threads, uint8_t* dst,
                                int64_t* block_sizes) {
    size_t n_blocks = (static_cast<size_t>(n) + MAX_PAYLOAD - 1) / MAX_PAYLOAD;
    if (n_blocks == 0) n_blocks = 1;
    std::vector<size_t> sizes(n_blocks, 0);
    std::vector<uint8_t> scratch(n_blocks * MAX_BLOCK);

    int workers = n_threads > 0 ? n_threads : 1;
    if (static_cast<size_t>(workers) > n_blocks)
        workers = static_cast<int>(n_blocks);
    std::vector<std::thread> pool;
    std::atomic<size_t> next{0};
    std::atomic<bool> failed{false};
    auto work = [&]() {
        for (;;) {
            size_t b = next.fetch_add(1);
            if (b >= n_blocks || failed.load()) break;
            size_t off = b * MAX_PAYLOAD;
            size_t len = std::min(MAX_PAYLOAD, static_cast<size_t>(n) - off);
            if (n == 0) len = 0;
            size_t sz = compress_block(src + off, len, level,
                                       scratch.data() + b * MAX_BLOCK);
            if (sz == 0) { failed.store(true); break; }
            sizes[b] = sz;
        }
    };
    for (int t = 0; t < workers; ++t) pool.emplace_back(work);
    for (auto& th : pool) th.join();
    if (failed.load()) return -1;

    int64_t total = 0;
    for (size_t b = 0; b < n_blocks; ++b) {
        std::memcpy(dst + total, scratch.data() + b * MAX_BLOCK, sizes[b]);
        if (block_sizes) block_sizes[b] = static_cast<int64_t>(sizes[b]);
        total += static_cast<int64_t>(sizes[b]);
    }
    return total;
}

int64_t nvbio_tpu_bgzf_max_output(int64_t n) {
    size_t n_blocks = (static_cast<size_t>(n) + MAX_PAYLOAD - 1) / MAX_PAYLOAD;
    if (n_blocks == 0) n_blocks = 1;
    return static_cast<int64_t>(n_blocks * MAX_BLOCK);
}

}  // extern "C"
