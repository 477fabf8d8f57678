// Native BWTE engine: incremental multi-string BWT construction for
// uniform-length read sets (the host-side counterpart of the reference's
// GPU BWTE, nvbio/sufsort/bwte.h:57-229 and the nvSetBWT
// app). Two entry points:
//
//   nvbio_tpu_bcr_block  — BCR column construction (Bauer-Cox-Rosone) of a
//       block's own multi-string BWT. Per round the occ() values are read
//       off a single forward sweep in suffix-position order (queries arrive
//       pos-sorted by construction), so every round is two sequential
//       passes over the partial BWT: O(m * L^2 / 2) total byte traffic,
//       no checkpoint structures, no suffix array.
//
//   nvbio_tpu_bwte_merge — merges a block (reads + its block BWT) into the
//       accumulated BWT with TWO static LF rank walks per read (one against
//       the accumulated BWT M, one against the block BWT B, both over
//       fused 64-byte rank lines) and a single interleave pass:
//       merged row of block suffix s = rank_M(s) + rank_B(s). Both walks
//       share the recurrence rank(c.T) = C[c] + occ(c, rank(T)) with the
//       sentinel base case rank_M($_i) = S_prev, rank_B($_i) = i.
//
// Alphabet: 0 = '$' (per-string sentinel, ordered by global string rank),
// 1..4 = bases. Input reads hold 0..3. Sentinel symbols are never occ()
// queried — they enter only through the C[] offsets — so no tag plane is
// needed (the numpy engine in index/setbwt.py carries tags only for the
// Holt-McMillan merge path).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <vector>

#include <sys/mman.h>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

inline double now_s() {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return ts.tv_sec + 1e-9 * ts.tv_nsec;
}

// NVBIO_TPU_BWTE_TRACE=1: per-phase stderr timings (diagnostics only)
inline bool trace_on() {
    static int v = -1;
    if (v < 0) {
        const char* e = getenv("NVBIO_TPU_BWTE_TRACE");
        v = (e && *e && *e != '0') ? 1 : 0;
    }
    return v == 1;
}

// 2MB-extent anonymous mappings with MADV_HUGEPAGE: the rank walks do one
// random 64-byte access per LF step over multi-GB tables — with 4K pages
// every step pays a TLB page walk on top of the cache miss; 2M pages keep
// the whole table TLB-resident (measured ~2x on the walk at n ~ 1G).
constexpr size_t HUGE_EXT = 2ull << 20;

inline size_t huge_round(size_t bytes) {
    return (bytes + HUGE_EXT - 1) & ~(HUGE_EXT - 1);
}

void* big_alloc(size_t bytes) {
    size_t sz = huge_round(bytes ? bytes : 1);
    void* p = mmap(nullptr, sz, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
    if (p == MAP_FAILED) return nullptr;
    madvise(p, sz, MADV_HUGEPAGE);
    return p;
}

void big_free(void* p, size_t bytes) {
    if (p) munmap(p, huge_round(bytes ? bytes : 1));
}

template <typename T>
struct BigBuf {
    T* p = nullptr;
    size_t n = 0;
    explicit BigBuf(size_t count) : n(count) {
        p = (T*)big_alloc(count * sizeof(T));
    }
    ~BigBuf() { big_free(p, n * sizeof(T)); }
    BigBuf(const BigBuf&) = delete;
    BigBuf& operator=(const BigBuf&) = delete;
    T& operator[](size_t i) { return p[i]; }
    const T& operator[](size_t i) const { return p[i]; }
};

// Fused rank dictionary: each 64-byte cache line holds the four symbol
// counts before the line (4 x uint32 deltas), a 128-bit dollar-validity
// plane, and 128 symbols 2-BIT PACKED — one cache line per occ() query at
// 128 symbols/line (2.7x the density of a byte layout), the same
// bit-plane idea as the reference's rank_dictionary
// (nvbio/strings/rank_dictionary.h). Line counts are DELTAS within a
// superblock of SB symbols; absolute uint64 counts per superblock live in
// a small side array, which lifts the addressable BWT past 2^32 rows (the
// reference's BWTE reach claim is ~100 G symbols, sufsort.h:47-49).
constexpr uint64_t LSYM = 128;           // symbols per fused line
constexpr uint64_t SB = LSYM << 20;      // superblock: ~134M symbols

struct alignas(64) RankLine {
    uint32_t cnt[4];     // per-symbol counts before this line (superblock-
                         // relative)
    uint64_t valid[2];   // bit l set = row l is a base (not '$')
    uint32_t packed[8];  // 2-bit (symbol-1), 16 rows per word, LSB-first
};

// match bitmap (1 bit/row) of symbol c over a 64-row half (4 packed words
// starting at w0)
inline uint64_t packed_match64(const RankLine& ln, uint8_t c, int w0) {
    const uint32_t pat = (uint32_t)(c - 1) * 0x55555555u;
    uint64_t match = 0;
    for (int w = 0; w < 4; ++w) {
        uint32_t x = ln.packed[w0 + w] ^ pat;
        uint32_t nz = (x | (x >> 1)) & 0x55555555u;
        uint32_t eq2 = ~nz & 0x55555555u;       // 2-bit lanes, even bits
#if defined(__BMI2__)
        uint64_t eq16 = _pext_u32(eq2, 0x55555555u);
#else
        uint32_t v = eq2;
        v = (v | (v >> 1)) & 0x33333333u;
        v = (v | (v >> 2)) & 0x0F0F0F0Fu;
        v = (v | (v >> 4)) & 0x00FF00FFu;
        v = (v | (v >> 8)) & 0x0000FFFFu;
        uint64_t eq16 = v;
#endif
        match |= eq16 << (16 * w);
    }
    return match;
}

// count of symbol c (1..4) among the first `rem` rows (rem < 128)
inline uint64_t packed_count(const RankLine& ln, uint8_t c, uint64_t rem) {
    uint64_t lo_rem = rem < 64 ? rem : 64;
    uint64_t lomask = lo_rem >= 64 ? ~0ull : ((1ull << lo_rem) - 1);
    uint64_t r = (uint64_t)__builtin_popcountll(
        packed_match64(ln, c, 0) & ln.valid[0] & lomask);
    if (rem > 64) {
        uint64_t himask = (1ull << (rem - 64)) - 1;
        r += (uint64_t)__builtin_popcountll(
            packed_match64(ln, c, 4) & ln.valid[1] & himask);
    }
    return r;
}

struct OccIndex {
    RankLine* lines = nullptr;
    uint64_t nl = 0;
    std::vector<uint64_t> super;  // (nsb) x 4 absolute counts
    uint64_t cnt[5];

    ~OccIndex() { big_free(lines, nl * sizeof(RankLine)); }

    void build(const uint8_t* b, uint64_t n) {
        nl = n / LSYM + 1;
        lines = (RankLine*)big_alloc(nl * sizeof(RankLine));
        if (!lines) return;
        super.assign((n / SB + 1) * 4, 0);
        uint64_t run[4] = {0, 0, 0, 0};
        for (int c = 0; c < 5; ++c) cnt[c] = 0;
        for (uint64_t l = 0; l < nl; ++l) {
            RankLine& ln = lines[l];
            uint64_t base = l * LSYM;
            if (base % SB == 0) {
                uint64_t* srow = &super[(base / SB) * 4];
                for (int c = 0; c < 4; ++c) srow[c] = run[c];
            }
            const uint64_t* srow = &super[(base / SB) * 4];
            for (int c = 0; c < 4; ++c)
                ln.cnt[c] = (uint32_t)(run[c] - srow[c]);
            uint64_t take = base < n ? (n - base < LSYM ? n - base : LSYM)
                                     : 0;
            ln.valid[0] = ln.valid[1] = 0;
            for (int w = 0; w < 8; ++w) ln.packed[w] = 0;
#if defined(__AVX2__)
            if (take == LSYM) {
                uint64_t bases = 0;
                for (int h = 0; h < 4; ++h) {  // 32 symbols per iteration
                    __m256i d = _mm256_loadu_si256(
                        (const __m256i*)(b + base + 32 * h));
                    // validity: byte != 0
                    uint32_t vm = (uint32_t)_mm256_movemask_epi8(
                        _mm256_cmpgt_epi8(d, _mm256_setzero_si256()));
                    ln.valid[h >> 1] |= (uint64_t)vm << (32 * (h & 1));
                    // 2-bit pack of (byte-1)&3, LSB-first
                    __m256i x = _mm256_and_si256(
                        _mm256_sub_epi8(d, _mm256_set1_epi8(1)),
                        _mm256_set1_epi8(3));
                    // pairs -> 4-bit in 16-bit lanes: lo + 4*hi
                    __m256i pair = _mm256_maddubs_epi16(
                        x, _mm256_set1_epi16(0x0401));
                    // quads -> 8-bit in 32-bit lanes: lo + 16*hi
                    __m256i quad = _mm256_madd_epi16(
                        pair, _mm256_set1_epi32(0x00100001));
                    // gather the low byte of each 32-bit lane
                    __m256i sh = _mm256_shuffle_epi8(
                        quad, _mm256_setr_epi8(
                            0, 4, 8, 12, -1, -1, -1, -1, -1, -1, -1, -1,
                            -1, -1, -1, -1,
                            0, 4, 8, 12, -1, -1, -1, -1, -1, -1, -1, -1,
                            -1, -1, -1, -1));
                    uint32_t lo = (uint32_t)_mm256_extract_epi32(sh, 0);
                    uint32_t hi = (uint32_t)_mm256_extract_epi32(sh, 4);
                    ln.packed[2 * h] = lo;
                    ln.packed[2 * h + 1] = hi;
                    // symbol counts via byte compares
                    for (int c = 1; c <= 4; ++c) {
                        uint32_t eq = (uint32_t)_mm256_movemask_epi8(
                            _mm256_cmpeq_epi8(d, _mm256_set1_epi8((char)c)));
                        uint64_t k = (uint64_t)__builtin_popcount(eq);
                        run[c - 1] += k;
                        cnt[c] += k;
                        bases += k;
                    }
                }
                cnt[0] += LSYM - bases;
                continue;
            }
#endif
            for (uint64_t i = 0; i < take; ++i) {
                uint8_t s = b[base + i];
                ++cnt[s];
                if (s) {
                    ++run[s - 1];
                    ln.valid[i >> 6] |= 1ull << (i & 63);
                    ln.packed[i >> 4] |=
                        (uint32_t)((s - 1) & 3) << (2 * (i & 15));
                }
            }
        }
    }

    inline const RankLine& line(uint64_t p) const { return lines[p / LSYM]; }

    static inline uint64_t occ_line(const RankLine& ln, uint8_t c,
                                    uint64_t p) {
        uint64_t rem = p % LSYM;
        return ln.cnt[c - 1] + packed_count(ln, c, rem);
    }

    inline uint64_t occ(uint8_t c, uint64_t p) const {
        return super[(p / SB) * 4 + (c - 1)] + occ_line(line(p), c, p);
    }
};

}  // namespace

extern "C" {

// Multi-string BWT of m uniform-length-L reads (values 0..3), BCR rounds.
// out must hold m*(L+1) bytes. Returns 0 on success.
int nvbio_tpu_bcr_block(const uint8_t* reads, int64_t m, int64_t L,
                        uint8_t* out) {
    if (m <= 0 || L <= 0) return m == 0 ? 0 : -1;
    const uint64_t um = (uint64_t)m;
    const uint64_t total = um * (uint64_t)(L + 1);
    BigBuf<uint8_t> bufa(total), bufb(total);
    if (!bufa.p || !bufb.p) return -3;
    uint8_t* cur = bufa.p;
    uint8_t* nxt = bufb.p;
    // round 0: sentinel-suffix rows in string order; row i holds the last
    // base of read i (the symbol cyclically preceding $_i)
    for (uint64_t i = 0; i < um; ++i)
        cur[i] = (uint8_t)(reads[i * L + (L - 1)] + 1);
    uint64_t size = um;
    std::vector<uint64_t> pos(um);       // row of read i's newest suffix
    std::vector<uint32_t> order(um);     // string ids sorted by pos
    for (uint64_t i = 0; i < um; ++i) { pos[i] = i; order[i] = (uint32_t)i; }
    uint64_t cnt[5] = {um, 0, 0, 0, 0};  // first-symbol counts

    // per-round scratch: 4 insertion buckets in (r, string) FIFO order
    std::vector<uint64_t> br[4];
    std::vector<uint32_t> bi[4];
    std::vector<uint64_t> ins_pos(um);
    std::vector<uint32_t> ins_str(um);

    for (int64_t round = 1; round <= L; ++round) {
        const int64_t cidx = L - round;  // first symbol of the new suffix
        // C must cover the round's OWN inserts too: for c' < c every new
        // suffix c'.T' sorts before c.T, and occ() below already counts the
        // new same-symbol peers (their T' rows are in the partial BWT) — so
        // r = C[c] + occ(c, pos(T)) is the exact final position, no
        // within-round tie offset.
        uint64_t newcnt[5] = {0, 0, 0, 0, 0};
        for (uint64_t i = 0; i < um; ++i)
            ++newcnt[reads[i * L + cidx] + 1];
        uint64_t C[5];
        C[1] = um;
        C[2] = C[1] + cnt[1] + newcnt[1];
        C[3] = C[2] + cnt[2] + newcnt[2];
        C[4] = C[3] + cnt[3] + newcnt[3];
        for (int c = 0; c < 4; ++c) {
            br[c].clear(); bi[c].clear();
            br[c].reserve(um + 1); bi[c].reserve(um);
        }
        // forward occ sweep: queries arrive in increasing pos order
        uint64_t counts[5] = {0, 0, 0, 0, 0};
        uint64_t ptr = 0;
        for (uint64_t j = 0; j < um; ++j) {
            uint32_t i = order[j];
            uint64_t p = pos[i];
#if defined(__AVX2__)
            while (ptr + 32 <= p) {
                __m256i d = _mm256_loadu_si256((const __m256i*)(cur + ptr));
                for (int c = 1; c <= 4; ++c)
                    counts[c] += (uint64_t)__builtin_popcount(
                        (uint32_t)_mm256_movemask_epi8(_mm256_cmpeq_epi8(
                            d, _mm256_set1_epi8((char)c))));
                ptr += 32;
            }
#endif
            while (ptr < p) ++counts[cur[ptr++]];
            uint8_t c = (uint8_t)(reads[(uint64_t)i * L + cidx] + 1);
            br[c - 1].push_back(C[c] + counts[c]);
            bi[c - 1].push_back(i);
        }
        // 4-way merge by r (all r distinct: they are final rows);
        // branchless min pick over sentinel-terminated sorted lists
        for (int c = 0; c < 4; ++c) br[c].push_back(~0ull);
        uint64_t hp[4] = {0, 0, 0, 0};
        const uint64_t* bp[4] = {br[0].data(), br[1].data(), br[2].data(),
                                 br[3].data()};
        for (uint64_t k = 0; k < um; ++k) {
            uint64_t r0 = bp[0][hp[0]], r1 = bp[1][hp[1]];
            uint64_t r2 = bp[2][hp[2]], r3 = bp[3][hp[3]];
            int b01 = r1 < r0, b23 = r3 < r2;
            uint64_t m01 = b01 ? r1 : r0, m23 = b23 ? r3 : r2;
            int best = m23 < m01 ? 2 + b23 : b01;
            uint64_t bestr = m23 < m01 ? m23 : m01;
            uint32_t i = bi[best][hp[best]++];
            ins_pos[k] = bestr;
            ins_str[k] = i;
            pos[i] = bestr;
            order[k] = i;
            ++cnt[best + 1];
        }
        // rewrite pass: interleave cur with the round's inserts
        uint64_t mp = 0, op = 0;
        for (uint64_t k = 0; k < um; ++k) {
            uint64_t np = ins_pos[k];
            uint64_t run = np - op;
            std::memcpy(nxt + op, cur + mp, run);
            op = np; mp += run;
            uint32_t i = ins_str[k];
            nxt[op++] = cidx > 0
                            ? (uint8_t)(reads[(uint64_t)i * L + cidx - 1] + 1)
                            : (uint8_t)0;
        }
        std::memcpy(nxt + op, cur + mp, size - mp);
        std::swap(cur, nxt);
        size += um;
    }
    std::memcpy(out, cur, total);
    return 0;
}

// Merge a block (reads + its block BWT B of bn = m*(L+1) rows) into the
// accumulated BWT M (n rows over S_prev strings). out holds n + bn rows.
// 64-bit indexed throughout (two-level rank superblocks): the engine's
// reach is bounded by host memory, not by 32-bit counters — the
// reference's BWTE targets ~100 G symbols (sufsort.h:47-49).
// Returns 0 on success.
int nvbio_tpu_bwte_merge(const uint8_t* M, int64_t n, int64_t S_prev,
                         const uint8_t* reads, int64_t m, int64_t L,
                         const uint8_t* B, uint8_t* out) {
    const uint64_t bn = (uint64_t)m * (uint64_t)(L + 1);
    if (m <= 0) { std::memcpy(out, M, (size_t)n); return m == 0 ? 0 : -1; }
    if (n == 0) { std::memcpy(out, B, bn); return 0; }

    double t0 = now_s();
    OccIndex oM, oB;
    oM.build(M, (uint64_t)n);
    oB.build(B, bn);
    if (!oM.lines || !oB.lines) return -3;
    double t1 = now_s();
    uint64_t CM[5], CB[5];
    CM[1] = (uint64_t)S_prev;
    CB[1] = (uint64_t)m;
    for (int c = 2; c <= 4; ++c) {
        CM[c] = CM[c - 1] + oM.cnt[c - 1];
        CB[c] = CB[c - 1] + oB.cnt[c - 1];
    }

    // per block row (indexed by rank_B): rank_M and the BWT symbol.
    // The per-read LF chains are serial, but chains are INDEPENDENT across
    // reads — walk them in stripes of G reads, issuing a software prefetch
    // for each read's next rank line right after its current step, so the
    // ~2 cache misses per step overlap across the stripe.
    BigBuf<uint64_t> rm_of((size_t)bn);
    BigBuf<uint8_t> sym_of((size_t)bn);
    if (!rm_of.p || !sym_of.p) return -3;
    constexpr int64_t G = 32;
    std::vector<uint64_t> rMs(G), rBs(G);
    for (int64_t g = 0; g < m; g += G) {
        const int64_t ge = g + G < m ? g + G : m;
        const int64_t gw = ge - g;
        for (int64_t t = 0; t < gw; ++t) {
            int64_t i = g + t;
            rMs[t] = (uint64_t)S_prev;
            rBs[t] = (uint64_t)i;
            // sentinel suffix $_i: its row holds the read's last base
            rm_of[i] = (uint64_t)S_prev;
            sym_of[i] = (uint8_t)(reads[(uint64_t)i * L + (L - 1)] + 1);
            __builtin_prefetch(&oB.line(rBs[t]));
        }
        for (int64_t k = 1; k <= L; ++k) {
            for (int64_t t = 0; t < gw; ++t) {
                const uint64_t ri = (uint64_t)(g + t) * L;
                uint8_t c = (uint8_t)(reads[ri + (L - k)] + 1);
                uint64_t rM = CM[c] + oM.occ(c, rMs[t]);
                uint64_t rB = CB[c] + oB.occ(c, rBs[t]);
                rMs[t] = rM;
                rBs[t] = rB;
                __builtin_prefetch(&oM.line(rM));
                __builtin_prefetch(&oB.line(rB));
                rm_of[rB] = rM;
                sym_of[rB] = k < L ? (uint8_t)(reads[ri + (L - k - 1)] + 1)
                                   : (uint8_t)0;
            }
        }
    }

    double t2 = now_s();
    // interleave: merged position of block row j is rm_of[j] + j, strictly
    // increasing in j (rank_M is non-decreasing in block suffix order)
    uint64_t mp = 0, op = 0;
    for (uint64_t j = 0; j < bn; ++j) {
        uint64_t np = (uint64_t)rm_of[j] + j;
        uint64_t run = np - op;
        std::memcpy(out + op, M + mp, run);
        op = np; mp += run;
        out[op++] = sym_of[j];
    }
    std::memcpy(out + op, M + mp, (uint64_t)n - mp);
    if (trace_on())
        fprintf(stderr,
                "[bwte_merge n=%lldM] occ %.2fs walk %.2fs interleave %.2fs\n",
                (long long)(n / 1000000), t1 - t0, t2 - t1, now_s() - t2);
    return 0;
}

}  // extern "C"
