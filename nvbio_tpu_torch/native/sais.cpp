// SA-IS suffix array construction (Nong–Zhang–Chan induced sorting).
//
// Native counterpart of the reference's host suffix sorters
// (contrib/libdivsufsort-lite, contrib/sais.h — reimplemented from the
// published algorithm, not copied) used by nvbio_tpu.index.sa for
// large-genome index construction. O(n) time, ~9n bytes working memory for
// the byte-alphabet level.
//
// Conventions: the caller passes the text WITHOUT a sentinel; we append an
// implicit unique smallest sentinel. Output SA has n+1 entries over the rows
// of T$, sa[0] == n. The index type is a template parameter: int32 for
// texts < 2^31 (the per-shard FM-index limit) and int64 for the multi-GB
// single-string path (the reference's whole-human BWT capability,
// sufsort/sufsort.h:45-47).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

template <typename T, typename I>
void get_buckets(const T* s, I n, I K, I* bkt, bool end) {
  std::memset(bkt, 0, sizeof(I) * (K + 1));
  for (I i = 0; i < n; ++i) bkt[s[i]]++;
  I sum = 0;
  for (I c = 0; c <= K; ++c) {
    sum += bkt[c];
    bkt[c] = end ? sum : sum - bkt[c];
  }
}

template <typename T, typename I>
void induce_l(const T* s, I* SA, I n, I K, I* bkt, const std::vector<bool>& st) {
  get_buckets(s, n, K, bkt, false);
  for (I i = 0; i < n; ++i) {
    I j = SA[i] - 1;
    if (SA[i] > 0 && !st[j]) SA[bkt[s[j]]++] = j;
  }
}

template <typename T, typename I>
void induce_s(const T* s, I* SA, I n, I K, I* bkt, const std::vector<bool>& st) {
  get_buckets(s, n, K, bkt, true);
  for (I i = n - 1; i >= 0; --i) {
    I j = SA[i] - 1;
    if (SA[i] > 0 && st[j]) SA[--bkt[s[j]]] = j;
  }
}

// Core recursion: s has length n with s[n-1] the unique smallest symbol.
template <typename T, typename I>
void sa_is(const T* s, I* SA, I n, I K) {
  if (n == 1) { SA[0] = 0; return; }
  if (n == 2) { SA[0] = 1; SA[1] = 0; return; }  // sentinel-last guarantee

  std::vector<bool> st(n);  // true = S-type
  st[n - 1] = true;
  for (I i = n - 2; i >= 0; --i)
    st[i] = (s[i] < s[i + 1]) || (s[i] == s[i + 1] && st[i + 1]);

  auto is_lms = [&](I i) { return i > 0 && st[i] && !st[i - 1]; };

  std::vector<I> bkt(K + 1);

  // step 1: place LMS suffixes at bucket ends, induce-sort
  std::fill(SA, SA + n, I(-1));
  get_buckets(s, n, K, bkt.data(), true);
  for (I i = 1; i < n; ++i)
    if (is_lms(i)) SA[--bkt[s[i]]] = i;
  induce_l(s, SA, n, K, bkt.data(), st);
  induce_s(s, SA, n, K, bkt.data(), st);

  // compact sorted LMS positions into SA[0..n1)
  I n1 = 0;
  for (I i = 0; i < n; ++i)
    if (is_lms(SA[i])) SA[n1++] = SA[i];

  // name LMS substrings
  std::fill(SA + n1, SA + n, I(-1));
  I name = 0, prev = -1;
  for (I i = 0; i < n1; ++i) {
    I pos = SA[i];
    bool diff = false;
    if (prev < 0) {
      diff = true;
    } else {
      for (I d = 0;; ++d) {
        if (s[pos + d] != s[prev + d] || st[pos + d] != st[prev + d]) {
          diff = true;
          break;
        }
        if (d > 0 && (is_lms(pos + d) || is_lms(prev + d))) {
          // both LMS-ends reached simultaneously with equal content
          break;
        }
      }
    }
    if (diff) { ++name; prev = pos; }
    SA[n1 + pos / 2] = name - 1;
  }
  // compact names into s1 at the tail of SA
  for (I i = n - 1, j = n - 1; i >= n1; --i)
    if (SA[i] >= 0) SA[j--] = SA[i];

  I* s1 = SA + n - n1;
  I* SA1 = SA;
  if (name < n1) {
    sa_is<I, I>(s1, SA1, n1, name - 1);
  } else {
    for (I i = 0; i < n1; ++i) SA1[s1[i]] = i;
  }

  // map SA1 back to LMS positions
  std::vector<I> lms(n1);
  for (I i = 1, j = 0; i < n; ++i)
    if (is_lms(i)) lms[j++] = i;
  for (I i = 0; i < n1; ++i) SA1[i] = lms[SA1[i]];

  // step 3: induce the full SA from sorted LMS
  std::fill(SA + n1, SA + n, I(-1));
  get_buckets(s, n, K, bkt.data(), true);
  for (I i = n1 - 1; i >= 0; --i) {
    I j = SA1[i];
    SA1[i] = -1;
    SA[--bkt[s[j]]] = j;
  }
  induce_l(s, SA, n, K, bkt.data(), st);
  induce_s(s, SA, n, K, bkt.data(), st);
}

}  // namespace

extern "C" {

// Suffix array of text+sentinel: codes in [0, K); SA gets n+1 entries.
// Returns 0 on success.
int nvbio_tpu_sais_u8(const uint8_t* codes, int32_t n, int32_t K,
                      int32_t* sa_out) {
  if (n < 0) return -1;
  if (n == 0) { sa_out[0] = 0; return 0; }
  // build s = codes+1 with terminating 0 sentinel
  std::vector<uint8_t> s(static_cast<size_t>(n) + 1);
  for (int32_t i = 0; i < n; ++i) s[i] = codes[i] + 1;
  s[n] = 0;
  sa_is<uint8_t, int32_t>(s.data(), sa_out, n + 1, K + 1);
  return 0;
}

// Integer-alphabet variant: codes in [0, K) with K up to ~2^31 (used for
// multi-string BCR texts whose DISTINCT per-string sentinels 0..S-1 exceed
// the byte alphabet; bases live at S..S+3). Appends the implicit global
// terminator like the byte variant.
int nvbio_tpu_sais_i32(const int32_t* codes, int32_t n, int32_t K,
                       int32_t* sa_out) {
  if (n < 0 || K < 1 || K >= INT32_MAX - 2) return -1;
  if (n == 0) { sa_out[0] = 0; return 0; }
  std::vector<int32_t> s(static_cast<size_t>(n) + 1);
  for (int32_t i = 0; i < n; ++i) s[i] = codes[i] + 1;
  s[n] = 0;
  sa_is<int32_t, int32_t>(s.data(), sa_out, n + 1, K + 1);
  return 0;
}

// 64-bit index variant for multi-GB texts (n up to 2^63; working set
// ~10 bytes/symbol at the byte level plus the 8(n+1)-byte SA itself).
int nvbio_tpu_sais_u8_64(const uint8_t* codes, int64_t n, int64_t K,
                         int64_t* sa_out) {
  if (n < 0) return -1;
  if (n == 0) { sa_out[0] = 0; return 0; }
  std::vector<uint8_t> s(static_cast<size_t>(n) + 1);
  for (int64_t i = 0; i < n; ++i) s[i] = codes[i] + 1;
  s[n] = 0;
  sa_is<uint8_t, int64_t>(s.data(), sa_out, n + 1, K + 1);
  return 0;
}

}  // extern "C"
