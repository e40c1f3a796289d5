// A Zstandard frame decoder (RFC 8878), host code with a plain C interface.
//
// Orbax writes every array of a checkpoint as zstd frames (zarr chunks with
// compressor zstd, OCDBT nodes and manifests).  The card's Python has no zstd
// module, so the port decodes them here.  The decoder takes raw, RLE and
// compressed blocks; raw, RLE, Huffman (1 or 4 streams) and treeless
// literals; predefined, RLE, FSE-compressed and repeat sequence tables; the
// three repeat offsets; several frames back to back and skippable frames; and
// checks the XXH64 content checksum where a frame carries one.  A frame that
// names a dictionary fails with ZSTD_ERR_DICTIONARY.  Every read is bounds-
// checked: a truncated or corrupt input fails, it never yields bytes.
//
// Built with the host C++ compiler by myriad_tpu_torch/orbax_format/zstd.py:
//   c++ -O3 -std=c++17 -shared -fPIC -o libmyriad_zstd.so zstd_decode.cpp
// The same file also exports CRC-32C (Castagnoli), which OCDBT uses.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

enum : int {
  ZSTD_OK = 0,
  ZSTD_ERR_CORRUPT = 1,
  ZSTD_ERR_TRUNCATED = 2,
  ZSTD_ERR_DICTIONARY = 3,
  ZSTD_ERR_DST_SMALL = 4,
  ZSTD_ERR_CHECKSUM = 5,
};

thread_local char g_message[256];

struct Error {
  int code;
};

[[noreturn]] void fail(int code, const char* what) {
  std::snprintf(g_message, sizeof(g_message), "%s", what);
  throw Error{code};
}

inline uint64_t load64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;  // little-endian host (x86-64, aarch64)
}

inline int highbit32(uint32_t v) { return 31 - __builtin_clz(v); }

// ---------------------------------------------------------------------------
// XXH64
// ---------------------------------------------------------------------------
constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xxh_round(uint64_t acc, uint64_t lane) {
  return rotl(acc + lane * P2, 31) * P1;
}
inline uint64_t xxh_merge(uint64_t h, uint64_t v) {
  h ^= xxh_round(0, v);
  return h * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t n, uint64_t seed) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xxh_round(v1, load64(p));
      v2 = xxh_round(v2, load64(p + 8));
      v3 = xxh_round(v3, load64(p + 16));
      v4 = xxh_round(v4, load64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xxh_merge(h, v1);
    h = xxh_merge(h, v2);
    h = xxh_merge(h, v3);
    h = xxh_merge(h, v4);
  } else {
    h = seed + P5;
  }
  h += static_cast<uint64_t>(n);
  while (p + 8 <= end) {
    h ^= xxh_round(0, load64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    uint32_t w;
    std::memcpy(&w, p, 4);
    h ^= static_cast<uint64_t>(w) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p) * P5;
    h = rotl(h, 11) * P1;
    ++p;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------------------
// CRC-32C (reflected polynomial 0x82F63B78), slicing by 8
// ---------------------------------------------------------------------------
struct Crc32cTable {
  uint32_t t[8][256];
  Crc32cTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ ((c & 1) ? 0x82F63B78u : 0u);
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s) t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

uint32_t crc32c(const uint8_t* p, size_t n) {
  static const Crc32cTable tab;
  uint32_t c = 0xFFFFFFFFu;
  while (n >= 8) {
    uint64_t w = load64(p) ^ c;
    c = tab.t[7][w & 0xFF] ^ tab.t[6][(w >> 8) & 0xFF] ^ tab.t[5][(w >> 16) & 0xFF] ^
        tab.t[4][(w >> 24) & 0xFF] ^ tab.t[3][(w >> 32) & 0xFF] ^
        tab.t[2][(w >> 40) & 0xFF] ^ tab.t[1][(w >> 48) & 0xFF] ^ tab.t[0][w >> 56];
    p += 8;
    n -= 8;
  }
  while (n--) c = tab.t[0][(c ^ *p++) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// ---------------------------------------------------------------------------
// Bit readers
// ---------------------------------------------------------------------------

// A backward bit stream (Huffman and FSE payloads): read from the end toward
// the start; the last byte's highest set bit marks where the data begins.
// ``pos`` counts the bits still unread; a read below bit 0 yields zeros and
// makes ``pos`` negative (zstd's "overflow"), which callers check.
struct BackwardBits {
  const uint8_t* base;
  int64_t nbytes;
  int64_t pos;

  BackwardBits(const uint8_t* p, size_t n) : base(p), nbytes(static_cast<int64_t>(n)) {
    if (n == 0) fail(ZSTD_ERR_CORRUPT, "empty bit stream");
    uint8_t last = p[n - 1];
    if (last == 0) fail(ZSTD_ERR_CORRUPT, "bit stream without its end mark");
    pos = static_cast<int64_t>(n - 1) * 8 + highbit32(last);
  }

  // the n bits just below ``pos`` (n <= 56), the highest first read
  inline uint64_t peek(int n) const {
    if (n == 0) return 0;
    int64_t lo = pos - n;
    uint64_t mask = (n == 64) ? ~0ull : ((1ull << n) - 1);
    if (lo >= 0 && (lo >> 3) + 8 <= nbytes) {
      return (load64(base + (lo >> 3)) >> (lo & 7)) & mask;
    }
    uint64_t v = 0;
    for (int i = 0; i < n; ++i) {
      int64_t b = lo + i;
      if (b >= 0) v |= static_cast<uint64_t>((base[b >> 3] >> (b & 7)) & 1) << i;
    }
    return v;
  }
  inline uint64_t read(int n) {
    uint64_t v = peek(n);
    pos -= n;
    return v;
  }
};

// A forward bit stream (FSE table descriptions), least significant bit first.
struct ForwardBits {
  const uint8_t* base;
  size_t nbytes;
  size_t pos = 0;  // bits consumed

  ForwardBits(const uint8_t* p, size_t n) : base(p), nbytes(n) {}
  uint32_t read(int n) {
    if (pos + n > nbytes * 8) fail(ZSTD_ERR_TRUNCATED, "FSE table description runs past its block");
    uint32_t v = 0;
    for (int i = 0; i < n; ++i, ++pos)
      v |= static_cast<uint32_t>((base[pos >> 3] >> (pos & 7)) & 1) << i;
    return v;
  }
  uint32_t peek(int n) {
    size_t saved = pos;
    uint32_t v = 0;
    for (int i = 0; i < n; ++i) {
      size_t b = saved + i;
      if (b < nbytes * 8) v |= static_cast<uint32_t>((base[b >> 3] >> (b & 7)) & 1) << i;
    }
    return v;
  }
  size_t bytes_used() const { return (pos + 7) / 8; }
};

// ---------------------------------------------------------------------------
// FSE
// ---------------------------------------------------------------------------
struct FseEntry {
  uint16_t symbol;
  uint8_t nbits;
  uint16_t base;  // the next state before its bits are added
};

struct FseTable {
  int log = -1;  // -1: no table yet
  std::vector<FseEntry> e;
};

void fse_build(FseTable& t, const int16_t* prob, int nsym, int log) {
  int size = 1 << log;
  t.log = log;
  t.e.assign(size, FseEntry{0, 0, 0});
  std::vector<uint32_t> next(nsym);
  int high = size - 1;
  for (int s = 0; s < nsym; ++s) {
    if (prob[s] == -1) {
      t.e[high--].symbol = static_cast<uint16_t>(s);
      next[s] = 1;
    } else {
      next[s] = static_cast<uint32_t>(prob[s]);
    }
  }
  int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, p = 0;
  for (int s = 0; s < nsym; ++s) {
    for (int i = 0; i < prob[s]; ++i) {
      t.e[p].symbol = static_cast<uint16_t>(s);
      do p = (p + step) & mask;
      while (p > high);
    }
  }
  if (p != 0) fail(ZSTD_ERR_CORRUPT, "FSE distribution does not fill its table");
  for (int u = 0; u < size; ++u) {
    uint32_t x = next[t.e[u].symbol]++;
    int nb = log - highbit32(x);
    t.e[u].nbits = static_cast<uint8_t>(nb);
    t.e[u].base = static_cast<uint16_t>((x << nb) - size);
  }
}

void fse_rle(FseTable& t, int symbol) {
  t.log = 0;
  t.e.assign(1, FseEntry{static_cast<uint16_t>(symbol), 0, 0});
}

// Read an FSE table description (RFC 8878 4.1.1); returns the bytes it took.
size_t fse_read_description(FseTable& t, const uint8_t* p, size_t n, int max_log, int max_sym) {
  ForwardBits br(p, n);
  int log = static_cast<int>(br.read(4)) + 5;
  if (log > max_log) fail(ZSTD_ERR_CORRUPT, "FSE accuracy log above its maximum");
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1;
  int16_t prob[256];
  int sym = 0;
  bool prev0 = false;
  while (remaining > 1 && sym <= max_sym) {
    if (prev0) {
      int n0 = sym;
      for (;;) {
        uint32_t r = br.read(2);
        n0 += static_cast<int>(r);
        if (r != 3) break;
      }
      if (n0 > max_sym) fail(ZSTD_ERR_CORRUPT, "FSE zero run past the last symbol");
      while (sym < n0) prob[sym++] = 0;
    }
    int max = (2 * threshold - 1) - remaining;
    int count;
    uint32_t low = br.peek(nbits - 1) & (threshold - 1);
    if (static_cast<int>(low) < max) {
      count = static_cast<int>(low);
      br.read(nbits - 1);
    } else {
      count = static_cast<int>(br.read(nbits) & (2 * threshold - 1));
      if (count >= threshold) count -= max;
    }
    count -= 1;
    remaining -= count < 0 ? -count : count;
    prob[sym++] = static_cast<int16_t>(count);
    prev0 = (count == 0);
    while (remaining < threshold && nbits > 1) {
      --nbits;
      threshold >>= 1;
    }
  }
  if (remaining != 1) fail(ZSTD_ERR_CORRUPT, "FSE probabilities do not sum to the table size");
  if (sym > max_sym + 1) fail(ZSTD_ERR_CORRUPT, "FSE symbol above its maximum");
  fse_build(t, prob, sym, log);
  return br.bytes_used();
}

struct FseState {
  const FseTable* t;
  uint32_t state;
  void init(const FseTable& table, BackwardBits& br) {
    t = &table;
    state = static_cast<uint32_t>(br.read(table.log));
  }
  inline int symbol() const { return t->e[state].symbol; }
  inline void update(BackwardBits& br) {
    const FseEntry& e = t->e[state];
    state = e.base + static_cast<uint32_t>(br.read(e.nbits));
  }
};

// ---------------------------------------------------------------------------
// Huffman literals
// ---------------------------------------------------------------------------
struct HufEntry {
  uint8_t symbol;
  uint8_t nbits;
};

struct HufTable {
  int max_bits = 0;  // 0: no table yet
  std::vector<HufEntry> e;
};

void huf_build(HufTable& t, const uint8_t* weights, int nweights) {
  // the last symbol's weight is implied: it completes a power of two
  uint32_t total = 0;
  for (int i = 0; i < nweights; ++i) {
    if (weights[i] > 11) fail(ZSTD_ERR_CORRUPT, "Huffman weight above 11");
    if (weights[i]) total += 1u << (weights[i] - 1);
  }
  if (total == 0) fail(ZSTD_ERR_CORRUPT, "Huffman weights all zero");
  int max_bits = highbit32(total) + 1;
  if (max_bits > 11) fail(ZSTD_ERR_CORRUPT, "Huffman code longer than 11 bits");
  uint32_t left = (1u << max_bits) - total;
  if (left & (left - 1)) fail(ZSTD_ERR_CORRUPT, "Huffman weights leave no power of two");
  uint8_t w[256];
  int nsym = nweights + 1;
  if (nsym > 256) fail(ZSTD_ERR_CORRUPT, "more than 256 Huffman symbols");
  std::memcpy(w, weights, nweights);
  w[nweights] = static_cast<uint8_t>(highbit32(left) + 1);
  uint32_t rank_count[13] = {0}, rank_start[13] = {0};
  for (int s = 0; s < nsym; ++s) rank_count[w[s]]++;
  uint32_t next = 0;
  for (int r = 1; r <= max_bits; ++r) {
    rank_start[r] = next;
    next += rank_count[r] << (r - 1);
  }
  if (next != (1u << max_bits)) fail(ZSTD_ERR_CORRUPT, "Huffman table does not fill");
  t.max_bits = max_bits;
  t.e.assign(1u << max_bits, HufEntry{0, 0});
  for (int s = 0; s < nsym; ++s) {
    int r = w[s];
    if (!r) continue;
    uint32_t len = 1u << (r - 1);
    HufEntry entry{static_cast<uint8_t>(s), static_cast<uint8_t>(max_bits + 1 - r)};
    for (uint32_t i = 0; i < len; ++i) t.e[rank_start[r] + i] = entry;
    rank_start[r] += len;
  }
}

// Read a Huffman tree description; returns the bytes it took.
size_t huf_read_description(HufTable& t, const uint8_t* p, size_t n) {
  if (n < 1) fail(ZSTD_ERR_TRUNCATED, "Huffman tree description missing");
  uint8_t head = p[0];
  uint8_t weights[256];
  int nweights;
  size_t used;
  if (head >= 128) {
    nweights = head - 127;
    size_t bytes = (nweights + 1) / 2;
    if (1 + bytes > n) fail(ZSTD_ERR_TRUNCATED, "Huffman weights run past the literals");
    for (int i = 0; i < nweights; ++i) {
      uint8_t b = p[1 + i / 2];
      weights[i] = (i % 2 == 0) ? (b >> 4) : (b & 15);
    }
    used = 1 + bytes;
  } else {
    size_t csize = head;
    if (csize == 0 || 1 + csize > n) fail(ZSTD_ERR_TRUNCATED, "Huffman weights run past the literals");
    FseTable ft;
    size_t dsize = fse_read_description(ft, p + 1, csize, 6, 255);
    if (dsize >= csize) fail(ZSTD_ERR_CORRUPT, "Huffman weight stream is empty");
    BackwardBits br(p + 1 + dsize, csize - dsize);
    FseState s1, s2;
    s1.init(ft, br);
    s2.init(ft, br);
    nweights = 0;
    // the two states alternate until the stream is read past its start
    FseState* s[2] = {&s1, &s2};
    for (int k = 0;; k ^= 1) {
      if (nweights >= 255) fail(ZSTD_ERR_CORRUPT, "too many Huffman weights");
      weights[nweights++] = static_cast<uint8_t>(s[k]->symbol());
      s[k]->update(br);
      if (br.pos < 0) {
        if (nweights >= 255) fail(ZSTD_ERR_CORRUPT, "too many Huffman weights");
        weights[nweights++] = static_cast<uint8_t>(s[k ^ 1]->symbol());
        break;
      }
    }
    used = 1 + csize;
  }
  huf_build(t, weights, nweights);
  return used;
}

// One symbol by the bit-exact slow path (near a stream's ends).
inline uint8_t huf_one(const HufTable& t, BackwardBits& br) {
  const HufEntry& h = t.e[br.peek(t.max_bits)];
  br.pos -= h.nbits;
  if (br.pos < 0) fail(ZSTD_ERR_CORRUPT, "Huffman stream read past its start");
  return h.symbol;
}

// Whether the next four symbols can come from one 64-bit load inside the
// stream (4 x 11 bits + 7 <= 64).
inline bool huf_fast_ok(const BackwardBits& br, int mb) {
  return br.pos - 4 * mb >= 0 && (((br.pos - 4 * mb) & ~int64_t{7}) >> 3) + 8 <= br.nbytes;
}

// Decode dst[i..count) from a stream already started; the stream must end
// exactly at its first bit.
void huf_finish(const HufTable& t, BackwardBits& br, uint8_t* dst, size_t i, size_t count) {
  const int mb = t.max_bits;
  const HufEntry* e = t.e.data();
  const uint32_t mask = (1u << mb) - 1;
  while (i < count) {
    if (i + 4 > count || !huf_fast_ok(br, mb)) {
      dst[i++] = huf_one(t, br);
      continue;
    }
    int64_t start = (br.pos - 4 * mb) & ~int64_t{7};
    uint64_t w = load64(br.base + (start >> 3));
    int r = static_cast<int>(br.pos - start);
    for (int k = 0; k < 4; ++k) {
      const HufEntry& h = e[(w >> (r - mb)) & mask];
      dst[i++] = h.symbol;
      r -= h.nbits;
    }
    br.pos = start + r;
  }
  if (br.pos != 0) fail(ZSTD_ERR_CORRUPT, "Huffman stream not consumed exactly");
}

void huf_decode_stream(const HufTable& t, const uint8_t* src, size_t n, uint8_t* dst,
                       size_t count) {
  BackwardBits br(src, n);
  huf_finish(t, br, dst, 0, count);
}

// The four streams of a literals section, interleaved: four independent
// chains of table lookups keep the core busy where one chain waits on its
// loads.  Stream 4 is the shortest, so the common part ends with it.
void huf_decode_4(const HufTable& t, const uint8_t* const q[4], const size_t sz[4],
                  uint8_t* const out[4], const size_t cnt[4]) {
  BackwardBits br[4] = {BackwardBits(q[0], sz[0]), BackwardBits(q[1], sz[1]),
                        BackwardBits(q[2], sz[2]), BackwardBits(q[3], sz[3])};
  const int mb = t.max_bits;
  const uint32_t mask = (1u << mb) - 1;
  const HufEntry* e = t.e.data();
  size_t i = 0;
  // the top of each stream (its last bytes) by the slow path
  while (i < cnt[3] && !(huf_fast_ok(br[0], mb) && huf_fast_ok(br[1], mb) &&
                         huf_fast_ok(br[2], mb) && huf_fast_ok(br[3], mb))) {
    for (int s = 0; s < 4; ++s) out[s][i] = huf_one(t, br[s]);
    ++i;
  }
  while (i + 4 <= cnt[3]) {
    int64_t start[4];
    uint64_t w[4];
    int r[4];
    if (!(huf_fast_ok(br[0], mb) && huf_fast_ok(br[1], mb) && huf_fast_ok(br[2], mb) &&
          huf_fast_ok(br[3], mb)))
      break;
    for (int s = 0; s < 4; ++s) {
      start[s] = (br[s].pos - 4 * mb) & ~int64_t{7};
      w[s] = load64(br[s].base + (start[s] >> 3));
      r[s] = static_cast<int>(br[s].pos - start[s]);
    }
    for (int k = 0; k < 4; ++k) {
      for (int s = 0; s < 4; ++s) {
        const HufEntry& h = e[(w[s] >> (r[s] - mb)) & mask];
        out[s][i + k] = h.symbol;
        r[s] -= h.nbits;
      }
    }
    for (int s = 0; s < 4; ++s) br[s].pos = start[s] + r[s];
    i += 4;
  }
  for (int s = 0; s < 4; ++s) huf_finish(t, br[s], out[s], i, cnt[s]);
}

// ---------------------------------------------------------------------------
// Sequences
// ---------------------------------------------------------------------------
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,  1,  1,  1,  1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,  1,  1,  1,  1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,   6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,  20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  12,  13,   14,   15,   16,
                              17, 18, 19, 20, 21, 22, 23, 24, 25,  26,  27,   28,   29,   30,
                              31, 32, 33, 34, 35, 37, 39, 41, 43,  47,  51,   59,   67,   83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

constexpr size_t kBlockMax = 128 * 1024;

struct FrameState {
  HufTable huf;
  FseTable ll, of, ml;
  uint32_t rep[3] = {1, 4, 8};
  uint64_t window = 0;
};

// Select one sequence table by its mode; returns the bytes its description took.
size_t seq_table(FseTable& t, int mode, const uint8_t* p, size_t n, const int16_t* def,
                 int def_n, int def_log, int max_log, int max_sym) {
  switch (mode) {
    case 0:
      fse_build(t, def, def_n, def_log);
      return 0;
    case 1:
      if (n < 1) fail(ZSTD_ERR_TRUNCATED, "RLE sequence table byte missing");
      if (p[0] > max_sym) fail(ZSTD_ERR_CORRUPT, "RLE sequence symbol above its maximum");
      fse_rle(t, p[0]);
      return 1;
    case 2:
      return fse_read_description(t, p, n, max_log, max_sym);
    default:
      if (t.log < 0) fail(ZSTD_ERR_CORRUPT, "repeat sequence table with no earlier table");
      return 0;
  }
}

struct Output {
  uint8_t* dst;
  size_t cap;
  size_t pos;        // bytes written in all frames
  size_t frame_start;  // where this frame's content begins
};

inline void need(const Output& out, size_t n) {
  if (n > out.cap - out.pos) fail(ZSTD_ERR_DST_SMALL, "output buffer too small");
}

void decode_compressed_block(FrameState& fs, const uint8_t* p, size_t n, Output& out) {
  // -- literals section
  if (n < 1) fail(ZSTD_ERR_TRUNCATED, "compressed block without literals header");
  int ltype = p[0] & 3, sf = (p[0] >> 2) & 3;
  size_t regen = 0, csize = 0, hsize = 0;
  int nstreams = 1;
  if (ltype <= 1) {
    if (sf == 0 || sf == 2) {
      regen = p[0] >> 3;
      hsize = 1;
    } else if (sf == 1) {
      if (n < 2) fail(ZSTD_ERR_TRUNCATED, "literals header truncated");
      regen = (p[0] >> 4) + (static_cast<size_t>(p[1]) << 4);
      hsize = 2;
    } else {
      if (n < 3) fail(ZSTD_ERR_TRUNCATED, "literals header truncated");
      regen = (p[0] >> 4) + (static_cast<size_t>(p[1]) << 4) + (static_cast<size_t>(p[2]) << 12);
      hsize = 3;
    }
  } else {
    if (sf <= 1) {
      if (n < 3) fail(ZSTD_ERR_TRUNCATED, "literals header truncated");
      uint32_t v = p[0] | (p[1] << 8) | (p[2] << 16);
      regen = (v >> 4) & 0x3FF;
      csize = (v >> 14) & 0x3FF;
      hsize = 3;
      nstreams = sf == 0 ? 1 : 4;
    } else if (sf == 2) {
      if (n < 4) fail(ZSTD_ERR_TRUNCATED, "literals header truncated");
      uint32_t v = p[0] | (p[1] << 8) | (p[2] << 16) | (static_cast<uint32_t>(p[3]) << 24);
      regen = (v >> 4) & 0x3FFF;
      csize = (v >> 18) & 0x3FFF;
      hsize = 4;
      nstreams = 4;
    } else {
      if (n < 5) fail(ZSTD_ERR_TRUNCATED, "literals header truncated");
      uint64_t v = p[0] | (p[1] << 8) | (p[2] << 16) | (static_cast<uint64_t>(p[3]) << 24) |
                   (static_cast<uint64_t>(p[4]) << 32);
      regen = (v >> 4) & 0x3FFFF;
      csize = (v >> 22) & 0x3FFFF;
      hsize = 5;
      nstreams = 4;
    }
  }
  if (regen > kBlockMax) fail(ZSTD_ERR_CORRUPT, "literals above the block maximum");
  std::vector<uint8_t> lits(regen + 8);
  size_t off = hsize;
  if (ltype == 0) {
    if (off + regen > n) fail(ZSTD_ERR_TRUNCATED, "raw literals run past the block");
    std::memcpy(lits.data(), p + off, regen);
    off += regen;
  } else if (ltype == 1) {
    if (off + 1 > n) fail(ZSTD_ERR_TRUNCATED, "RLE literal byte missing");
    std::memset(lits.data(), p[off], regen);
    off += 1;
  } else {
    if (off + csize > n) fail(ZSTD_ERR_TRUNCATED, "compressed literals run past the block");
    const uint8_t* lp = p + off;
    size_t ln = csize;
    if (ltype == 2) {
      size_t used = huf_read_description(fs.huf, lp, ln);
      lp += used;
      ln -= used;
    } else if (fs.huf.max_bits == 0) {
      fail(ZSTD_ERR_CORRUPT, "treeless literals with no earlier Huffman table");
    }
    if (nstreams == 1) {
      huf_decode_stream(fs.huf, lp, ln, lits.data(), regen);
    } else {
      if (ln < 6) fail(ZSTD_ERR_TRUNCATED, "jump table truncated");
      size_t s1 = lp[0] | (lp[1] << 8), s2 = lp[2] | (lp[3] << 8), s3 = lp[4] | (lp[5] << 8);
      if (6 + s1 + s2 + s3 > ln) fail(ZSTD_ERR_CORRUPT, "jump table past the literals");
      size_t s4 = ln - 6 - s1 - s2 - s3;
      size_t seg = (regen + 3) / 4;
      if (3 * seg > regen) fail(ZSTD_ERR_CORRUPT, "four literal streams for too few literals");
      const uint8_t* q = lp + 6;
      const uint8_t* const qs[4] = {q, q + s1, q + s1 + s2, q + s1 + s2 + s3};
      const size_t sizes[4] = {s1, s2, s3, s4};
      uint8_t* const outs[4] = {lits.data(), lits.data() + seg, lits.data() + 2 * seg,
                                lits.data() + 3 * seg};
      const size_t counts[4] = {seg, seg, seg, regen - 3 * seg};
      huf_decode_4(fs.huf, qs, sizes, outs, counts);
    }
    off += csize;
  }

  // -- sequences section
  if (off >= n) fail(ZSTD_ERR_TRUNCATED, "sequences section missing");
  size_t nseq = p[off];
  if (nseq < 128) {
    off += 1;
  } else if (nseq < 255) {
    if (off + 2 > n) fail(ZSTD_ERR_TRUNCATED, "sequence count truncated");
    nseq = ((nseq - 128) << 8) + p[off + 1];
    off += 2;
  } else {
    if (off + 3 > n) fail(ZSTD_ERR_TRUNCATED, "sequence count truncated");
    nseq = p[off + 1] + (static_cast<size_t>(p[off + 2]) << 8) + 0x7F00;
    off += 3;
  }
  size_t block_start = out.pos;
  const uint8_t* lit = lits.data();
  const uint8_t* lit_end = lits.data() + regen;
  if (nseq == 0) {
    if (off != n) fail(ZSTD_ERR_CORRUPT, "bytes after an empty sequences section");
  } else {
    if (off >= n) fail(ZSTD_ERR_TRUNCATED, "sequence modes missing");
    uint8_t modes = p[off++];
    if (modes & 3) fail(ZSTD_ERR_CORRUPT, "reserved bits of the sequence modes set");
    off += seq_table(fs.ll, modes >> 6, p + off, n - off, kLLDefault, 36, 6, 9, 35);
    off += seq_table(fs.of, (modes >> 4) & 3, p + off, n - off, kOFDefault, 29, 5, 8, 31);
    off += seq_table(fs.ml, (modes >> 2) & 3, p + off, n - off, kMLDefault, 53, 6, 9, 52);
    if (off >= n) fail(ZSTD_ERR_TRUNCATED, "sequence bit stream missing");
    BackwardBits br(p + off, n - off);
    FseState sll, sof, sml;
    sll.init(fs.ll, br);
    sof.init(fs.of, br);
    sml.init(fs.ml, br);
    uint32_t* rep = fs.rep;
    for (size_t s = 0; s < nseq; ++s) {
      int ofc = sof.symbol(), mlc = sml.symbol(), llc = sll.symbol();
      if (ofc > 31) fail(ZSTD_ERR_CORRUPT, "offset code above 31");
      uint64_t ofv = (1ull << ofc) + br.read(ofc);
      uint64_t ml = kMLBase[mlc] + br.read(kMLBits[mlc]);
      uint64_t ll = kLLBase[llc] + br.read(kLLBits[llc]);
      uint64_t offset;
      if (ofv > 3) {
        offset = ofv - 3;
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = static_cast<uint32_t>(offset);
      } else {
        uint64_t idx = ofv + (ll == 0 ? 1 : 0);
        if (idx == 1) {
          offset = rep[0];
        } else if (idx == 2) {
          offset = rep[1];
          rep[1] = rep[0];
          rep[0] = static_cast<uint32_t>(offset);
        } else if (idx == 3) {
          offset = rep[2];
          rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = static_cast<uint32_t>(offset);
        } else {
          offset = rep[0] - 1;
          if (offset == 0) fail(ZSTD_ERR_CORRUPT, "repeat offset of zero");
          rep[2] = rep[1];
          rep[1] = rep[0];
          rep[0] = static_cast<uint32_t>(offset);
        }
      }
      if (s + 1 < nseq) {
        sll.update(br);
        sml.update(br);
        sof.update(br);
      }
      if (br.pos < 0) fail(ZSTD_ERR_CORRUPT, "sequence stream read past its start");
      // execute: ll literals, then ml bytes from ``offset`` back
      if (ll > static_cast<uint64_t>(lit_end - lit)) fail(ZSTD_ERR_CORRUPT, "sequence takes more literals than the block has");
      need(out, ll + ml);
      std::memcpy(out.dst + out.pos, lit, ll);
      lit += ll;
      out.pos += ll;
      if (offset > out.pos - out.frame_start || offset > fs.window)
        fail(ZSTD_ERR_CORRUPT, "match offset before the frame or the window");
      uint8_t* d = out.dst + out.pos;
      const uint8_t* src = d - offset;
      if (offset >= ml) {
        std::memcpy(d, src, ml);
      } else {
        for (uint64_t k = 0; k < ml; ++k) d[k] = src[k];
      }
      out.pos += ml;
    }
    if (br.pos != 0) fail(ZSTD_ERR_CORRUPT, "sequence stream not consumed exactly");
  }
  size_t rest = static_cast<size_t>(lit_end - lit);
  need(out, rest);
  std::memcpy(out.dst + out.pos, lit, rest);
  out.pos += rest;
  if (out.pos - block_start > kBlockMax) fail(ZSTD_ERR_CORRUPT, "block content above 128 KiB");
}

// Decode one frame at p[0..n); returns the bytes it took.  ``out`` may be a
// null-sized sink when only measuring (dst == nullptr is never passed here).
size_t decode_frame(const uint8_t* p, size_t n, Output& out) {
  if (n < 4) fail(ZSTD_ERR_TRUNCATED, "frame magic truncated");
  uint32_t magic;
  std::memcpy(&magic, p, 4);
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
    if (n < 8) fail(ZSTD_ERR_TRUNCATED, "skippable frame truncated");
    uint32_t size;
    std::memcpy(&size, p + 4, 4);
    if (static_cast<uint64_t>(size) + 8 > n) fail(ZSTD_ERR_TRUNCATED, "skippable frame truncated");
    return 8 + static_cast<size_t>(size);
  }
  if (magic != 0xFD2FB528u) fail(ZSTD_ERR_CORRUPT, "not a zstd frame (bad magic)");
  size_t off = 4;
  if (off >= n) fail(ZSTD_ERR_TRUNCATED, "frame header truncated");
  uint8_t fhd = p[off++];
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1, did_flag = fhd & 3;
  if (fhd & 0x08) fail(ZSTD_ERR_CORRUPT, "reserved bit of the frame header set");
  uint64_t window = 0;
  if (!single) {
    if (off >= n) fail(ZSTD_ERR_TRUNCATED, "window descriptor missing");
    uint8_t wd = p[off++];
    int wlog = 10 + (wd >> 3);
    if (wlog > 41) fail(ZSTD_ERR_CORRUPT, "window above 2^41");
    uint64_t base = 1ull << wlog;
    window = base + (base / 8) * (wd & 7);
  }
  static const int did_size[4] = {0, 1, 2, 4};
  if (off + did_size[did_flag] > n) fail(ZSTD_ERR_TRUNCATED, "dictionary id truncated");
  uint32_t did = 0;
  for (int i = 0; i < did_size[did_flag]; ++i) did |= static_cast<uint32_t>(p[off + i]) << (8 * i);
  off += did_size[did_flag];
  if (did != 0) {
    std::snprintf(g_message, sizeof(g_message), "frame names dictionary %u", did);
    throw Error{ZSTD_ERR_DICTIONARY};
  }
  static const int fcs_size[4] = {0, 2, 4, 8};
  int fsz = (fcs_flag == 0 && single) ? 1 : fcs_size[fcs_flag];
  bool has_fcs = fsz > 0;
  uint64_t fcs = 0;
  if (off + fsz > n) fail(ZSTD_ERR_TRUNCATED, "frame content size truncated");
  for (int i = 0; i < fsz; ++i) fcs |= static_cast<uint64_t>(p[off + i]) << (8 * i);
  if (fsz == 2) fcs += 256;
  off += fsz;
  if (single) window = fcs;

  FrameState fs;
  fs.window = window;
  out.frame_start = out.pos;
  for (;;) {
    if (off + 3 > n) fail(ZSTD_ERR_TRUNCATED, "block header truncated");
    uint32_t bh = p[off] | (p[off + 1] << 8) | (p[off + 2] << 16);
    off += 3;
    int last = bh & 1, type = (bh >> 1) & 3;
    size_t size = bh >> 3;
    if (type == 3) fail(ZSTD_ERR_CORRUPT, "reserved block type");
    if (type == 1) {
      if (off + 1 > n) fail(ZSTD_ERR_TRUNCATED, "RLE block truncated");
      if (size > kBlockMax) fail(ZSTD_ERR_CORRUPT, "RLE block above 128 KiB");
      need(out, size);
      std::memset(out.dst + out.pos, p[off], size);
      out.pos += size;
      off += 1;
    } else {
      if (size > kBlockMax) fail(ZSTD_ERR_CORRUPT, "block above 128 KiB");
      if (off + size > n) fail(ZSTD_ERR_TRUNCATED, "block runs past the input");
      if (type == 0) {
        need(out, size);
        std::memcpy(out.dst + out.pos, p + off, size);
        out.pos += size;
      } else {
        decode_compressed_block(fs, p + off, size, out);
      }
      off += size;
    }
    if (last) break;
  }
  size_t produced = out.pos - out.frame_start;
  if (has_fcs && produced != fcs) fail(ZSTD_ERR_CORRUPT, "frame content size disagrees with its blocks");
  if (checksum) {
    if (off + 4 > n) fail(ZSTD_ERR_TRUNCATED, "content checksum truncated");
    uint32_t want;
    std::memcpy(&want, p + off, 4);
    uint32_t got = static_cast<uint32_t>(xxh64(out.dst + out.frame_start, produced, 0));
    if (got != want) fail(ZSTD_ERR_CHECKSUM, "content checksum mismatch");
    off += 4;
  }
  return off;
}

// An upper bound of one frame's content (exact when the frame states it).
size_t frame_bound(const uint8_t* p, size_t n, uint64_t* bound) {
  if (n < 4) fail(ZSTD_ERR_TRUNCATED, "frame magic truncated");
  uint32_t magic;
  std::memcpy(&magic, p, 4);
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
    if (n < 8) fail(ZSTD_ERR_TRUNCATED, "skippable frame truncated");
    uint32_t size;
    std::memcpy(&size, p + 4, 4);
    if (static_cast<uint64_t>(size) + 8 > n) fail(ZSTD_ERR_TRUNCATED, "skippable frame truncated");
    return 8 + static_cast<size_t>(size);
  }
  if (magic != 0xFD2FB528u) fail(ZSTD_ERR_CORRUPT, "not a zstd frame (bad magic)");
  if (n < 5) fail(ZSTD_ERR_TRUNCATED, "frame header truncated");
  uint8_t fhd = p[4];
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1;
  static const int did_size[4] = {0, 1, 2, 4};
  static const int fcs_size[4] = {0, 2, 4, 8};
  int fsz = (fcs_flag == 0 && single) ? 1 : fcs_size[fcs_flag];
  size_t off = 5 + (single ? 0 : 1) + did_size[fhd & 3];
  if (off + fsz > n) fail(ZSTD_ERR_TRUNCATED, "frame header truncated");
  uint64_t fcs = 0;
  for (int i = 0; i < fsz; ++i) fcs |= static_cast<uint64_t>(p[off + i]) << (8 * i);
  if (fsz == 2) fcs += 256;
  off += fsz;
  uint64_t sum = 0;
  for (;;) {
    if (off + 3 > n) fail(ZSTD_ERR_TRUNCATED, "block header truncated");
    uint32_t bh = p[off] | (p[off + 1] << 8) | (p[off + 2] << 16);
    off += 3;
    int type = (bh >> 1) & 3;
    size_t size = bh >> 3;
    if (type == 3) fail(ZSTD_ERR_CORRUPT, "reserved block type");
    if (type == 1) {
      sum += size;
      off += 1;
    } else {
      sum += type == 0 ? size : kBlockMax;
      off += size;
    }
    if (off > n) fail(ZSTD_ERR_TRUNCATED, "block runs past the input");
    if (bh & 1) break;
  }
  if (checksum) off += 4;
  if (off > n) fail(ZSTD_ERR_TRUNCATED, "content checksum truncated");
  *bound += fsz > 0 ? fcs : sum;
  return off;
}

}  // namespace

extern "C" {

// Decode every frame of src[0..n) into dst[0..cap); returns the bytes
// written, or -(error code) (see myriad_zstd_error).
long long myriad_zstd_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap) {
  try {
    Output out{dst, cap, 0, 0};
    size_t off = 0;
    if (n == 0) fail(ZSTD_ERR_TRUNCATED, "empty input");
    while (off < n) off += decode_frame(src + off, n - off, out);
    return static_cast<long long>(out.pos);
  } catch (const Error& e) {
    return -static_cast<long long>(e.code);
  } catch (const std::bad_alloc&) {
    std::snprintf(g_message, sizeof(g_message), "out of host memory");
    return -static_cast<long long>(ZSTD_ERR_CORRUPT);
  }
}

// An upper bound of the decoded size of src[0..n) (exact where every frame
// states its content size), or -(error code).
long long myriad_zstd_bound(const uint8_t* src, size_t n) {
  try {
    uint64_t bound = 0;
    size_t off = 0;
    if (n == 0) fail(ZSTD_ERR_TRUNCATED, "empty input");
    while (off < n) off += frame_bound(src + off, n - off, &bound);
    return static_cast<long long>(bound);
  } catch (const Error& e) {
    return -static_cast<long long>(e.code);
  }
}

// The message of the last error on this thread.
const char* myriad_zstd_error(void) { return g_message; }

unsigned long long myriad_xxh64(const uint8_t* src, size_t n, unsigned long long seed) {
  return xxh64(src, n, seed);
}

unsigned int myriad_crc32c(const uint8_t* src, size_t n) { return crc32c(src, n); }

}  // extern "C"
