// A baseline JPEG decoder, host code with a plain C interface.
//
// The MiniGPT-4 datasets are JPEGs, and the card's Python has no PIL, so the
// port decodes them here.  The output equals what Pillow gives for
// Image.open(f).convert("RGB") with its defaults over libjpeg-turbo, byte for
// byte: the same integer arithmetic in each stage of the decode.
//
//   * entropy decoding: sequential Huffman (SOF0, and SOF1 at 8 bits), one or
//     more scans, interleaved or not, restart intervals (DRI / RSTn);
//   * dequantisation and jpeg_idct_islow (jidctint.c: CONST_BITS 13,
//     PASS1_BITS 2, the post-IDCT range-limit table, index masked by 1023);
//   * chroma upsampling as jdsample.c does it with do_fancy_upsampling:
//     h2v1_fancy_upsample and h2v2_fancy_upsample (the triangle filter with
//     its +8/+7 and +1/+2 biases and its edge columns; plain replication
//     when the component is at most 2 samples wide), h1v2_fancy_upsample,
//     the edge rows replicated as jdmainct.c replicates them;
//   * ycc_rgb_convert (jdcolor.c: 16-bit fixed-point tables);
//   * the padded MCUs cropped at any width and height.
//
// One or three components, sampling factors 1 or 2 in each direction.  A
// grayscale image comes out with its channel repeated three times, as
// convert("RGB") gives it.  Progressive, lossless, hierarchical and
// arithmetic-coded files, 12-bit samples, and 4-component (CMYK, YCCK)
// files fail with JPEG_ERR_UNSUPPORTED, naming the mode.  Every read is
// bounds-checked, and the entropy-coded data must end exactly where the last
// MCU ends (at most 7 padding bits, all ones, before the marker): a truncated
// or corrupt stream fails, it never yields a partial image.  Segment lengths
// and Huffman tables are checked as libjpeg checks them, each table before
// anything of it is built; a sample that would wrap the range-limit table
// (corrupt coefficients) fails too, so what decodes equals Pillow's bytes
// whether its libjpeg-turbo takes the C or the SIMD IDCT.
//
// Built with the host C++ compiler by myriad_tpu_torch/datasets/jpeg.py:
//   c++ -O3 -std=c++17 -shared -fPIC -o libmyriad_jpeg.so jpeg_decode.cpp

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

enum : int {
  JPEG_OK = 0,
  JPEG_ERR_CORRUPT = 1,
  JPEG_ERR_TRUNCATED = 2,
  JPEG_ERR_UNSUPPORTED = 3,
  JPEG_ERR_DST_SMALL = 4,
};

thread_local char g_message[256];

struct Error {
  int code;
};

[[noreturn]] void fail(int code, const char* what) {
  std::snprintf(g_message, sizeof(g_message), "%s", what);
  throw Error{code};
}

struct Huffman {
  bool defined = false;
  // canonical decoding: codes of length l are mincode[l]..maxcode[l]
  int32_t maxcode[18];
  int32_t valptr[17];
  int32_t mincode[17];
  uint8_t vals[256];
  // 9-bit lookahead: (length << 8) | value, 0 when the code is longer
  uint16_t look[512];
};

// jpeg_make_d_derived_tbl's checks, made before anything is written: the
// codes of each length must fit in its bits with the all-ones code left out
// (so the lookahead table below is never indexed past its end), and a DC
// table's symbols are magnitudes of at most 15 bits.
void check_huffman(const uint8_t* counts, const uint8_t* vals, int nvals, bool dc) {
  int code = 0;
  for (int l = 1; l <= 16; l++) {
    code += counts[l - 1];
    if (code >= (1 << l)) fail(JPEG_ERR_CORRUPT, "bad Huffman table: too many codes");
    code <<= 1;
  }
  if (dc) {
    for (int i = 0; i < nvals; i++) {
      if (vals[i] > 15) fail(JPEG_ERR_CORRUPT, "bad Huffman table: DC symbol above 15");
    }
  }
}

void build_huffman(Huffman& h, const uint8_t* counts, const uint8_t* vals, int nvals, bool dc) {
  check_huffman(counts, vals, nvals, dc);
  std::memcpy(h.vals, vals, nvals);
  int code = 0, k = 0;
  std::memset(h.look, 0, sizeof(h.look));
  for (int l = 1; l <= 16; l++) {
    h.valptr[l] = k;
    h.mincode[l] = code;
    for (int i = 0; i < counts[l - 1]; i++) {
      if (l <= 9) {
        int shift = 9 - l;
        for (int j = 0; j < (1 << shift); j++) {
          h.look[(code << shift) | j] = static_cast<uint16_t>((l << 8) | vals[k]);
        }
      }
      code++;
      k++;
    }
    h.maxcode[l] = counts[l - 1] ? code - 1 : -1;
    code <<= 1;
  }
  h.maxcode[17] = 0x7fffffff;
  h.defined = true;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;              // blocks in the padded plane
  int dw = 0, dh = 0;              // downsampled_width/height (real samples)
  std::vector<int16_t> coef;       // bw * bh blocks of 64 (natural order)
  std::vector<uint8_t> plane;      // (bh * 8) x (bw * 8) samples after the IDCT
  bool seen = false;
};

constexpr uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

class BitReader {
 public:
  BitReader(const uint8_t* p, size_t n, size_t pos) : p_(p), n_(n), pos_(pos) {}

  // Bits of the entropy-coded segment; a marker (0xFF followed by anything
  // but 0x00) ends it, and asking for bits past it fails.
  inline void fill() {
    while (nbits_ <= 24) {
      if (marker_) {
        return;
      }
      if (pos_ >= n_) fail(JPEG_ERR_TRUNCATED, "truncated entropy-coded data");
      uint8_t b = p_[pos_];
      if (b == 0xFF) {
        if (pos_ + 1 >= n_) fail(JPEG_ERR_TRUNCATED, "truncated entropy-coded data");
        uint8_t c = p_[pos_ + 1];
        if (c == 0x00) {
          pos_ += 2;
        } else {
          marker_ = true;
          return;
        }
      } else {
        pos_ += 1;
      }
      acc_ |= static_cast<uint32_t>(b) << (24 - nbits_);
      nbits_ += 8;
    }
  }

  inline int peek9() {
    fill();
    return static_cast<int>(acc_ >> 23);  // zeros past a marker: checked by need()
  }

  inline void need(int n) {
    if (nbits_ < n) {
      fill();
      if (nbits_ < n) fail(JPEG_ERR_CORRUPT, "entropy-coded data ends inside an MCU");
    }
  }

  inline int bits(int n) {
    if (n == 0) return 0;
    need(n);
    int v = static_cast<int>(acc_ >> (32 - n));
    acc_ <<= n;
    nbits_ -= n;
    return v;
  }

  inline void skip(int n) {
    need(n);
    acc_ <<= n;
    nbits_ -= n;
  }

  int decode(const Huffman& h) {
    int look = h.look[peek9()];
    if (look) {
      int l = look >> 8;
      skip(l);
      return look & 0xFF;
    }
    int code = bits(9);
    int l = 9;
    while (code > h.maxcode[l]) {
      code = (code << 1) | bits(1);
      l++;
      if (l > 16) fail(JPEG_ERR_CORRUPT, "bad Huffman code");
    }
    return h.vals[h.valptr[l] + code - h.mincode[l]];
  }

  // End of a restart interval or of the scan: what is left of the current
  // byte must be padding ones, and the next thing in the stream a marker.
  // Returns the position of that marker.
  size_t finish() {
    // whole bytes still buffered were read past the data: corrupt
    if (nbits_ >= 8) fail(JPEG_ERR_CORRUPT, "entropy-coded data runs past the last MCU");
    if (nbits_ > 0) {
      uint32_t pad = acc_ >> (32 - nbits_);
      if (pad != (1u << nbits_) - 1) fail(JPEG_ERR_CORRUPT, "bad padding bits before a marker");
    }
    if (!marker_) {
      // the next byte must start a marker
      if (pos_ + 1 >= n_) fail(JPEG_ERR_TRUNCATED, "truncated entropy-coded data");
      if (p_[pos_] != 0xFF || p_[pos_ + 1] == 0x00)
        fail(JPEG_ERR_CORRUPT, "entropy-coded data runs past the last MCU");
    }
    acc_ = 0;
    nbits_ = 0;
    marker_ = false;
    return pos_;
  }

  void restart_at(size_t pos) { pos_ = pos; }

 private:
  const uint8_t* p_;
  size_t n_;
  size_t pos_;
  uint32_t acc_ = 0;
  int nbits_ = 0;
  bool marker_ = false;
};

inline int extend(int v, int t) { return v < (1 << (t - 1)) ? v - (1 << t) + 1 : v; }

class Decoder {
 public:
  Decoder(const uint8_t* p, size_t n) : p_(p), n_(n) {}

  void read_headers_to_frame();
  void decode(uint8_t* dst);
  int width = 0, height = 0, ncomp = 0;

 private:
  uint16_t u16(size_t at) {
    if (at + 2 > n_) fail(JPEG_ERR_TRUNCATED, "truncated marker segment");
    return static_cast<uint16_t>((p_[at] << 8) | p_[at + 1]);
  }
  int next_marker();
  size_t segment(size_t* len);
  void read_dqt(size_t at, size_t len);
  void read_dht(size_t at, size_t len);
  void read_sof(int marker, size_t at, size_t len);
  void read_app14(size_t at, size_t len);
  void read_sos(size_t at, size_t len);
  void decode_block(BitReader& br, Component& c, int16_t* blk, int& pred, const Huffman& dc,
                    const Huffman& ac);
  void idct_all();
  void upsample(const Component& c, std::vector<uint8_t>& out);
  void color(uint8_t* dst);

  const uint8_t* p_;
  size_t n_;
  size_t pos_ = 0;
  uint16_t qt_[4][64];
  bool qt_defined_[4] = {false, false, false, false};
  Huffman dc_[4], ac_[4];
  Component comp_[3];
  int hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  int restart_ = 0;
  bool frame_ = false, adobe_ = false, jfif_ = false;
  int adobe_transform_ = -1;
};

int Decoder::next_marker() {
  // skip fill bytes; anything else between segments is corrupt
  if (pos_ >= n_) fail(JPEG_ERR_TRUNCATED, "truncated JPEG: no EOI marker");
  if (p_[pos_] != 0xFF) fail(JPEG_ERR_CORRUPT, "expected a marker");
  while (pos_ < n_ && p_[pos_] == 0xFF) pos_++;
  if (pos_ >= n_) fail(JPEG_ERR_TRUNCATED, "truncated JPEG: no EOI marker");
  return p_[pos_++];
}

size_t Decoder::segment(size_t* len) {
  size_t l = u16(pos_);
  if (l < 2) fail(JPEG_ERR_CORRUPT, "bad marker segment length");
  if (pos_ + l > n_) fail(JPEG_ERR_TRUNCATED, "truncated marker segment");
  size_t at = pos_ + 2;
  pos_ += l;
  *len = l - 2;
  return at;
}

void Decoder::read_dqt(size_t at, size_t len) {
  size_t end = at + len;
  while (at < end) {
    int pq = p_[at] >> 4, tq = p_[at] & 15;
    at++;
    if (tq > 3 || pq > 1) fail(JPEG_ERR_CORRUPT, "bad quantization table");
    size_t need = pq ? 128 : 64;
    if (at + need > end) fail(JPEG_ERR_CORRUPT, "short quantization table");
    for (int k = 0; k < 64; k++) {
      qt_[tq][kZigzag[k]] = pq ? static_cast<uint16_t>((p_[at + 2 * k] << 8) | p_[at + 2 * k + 1])
                               : p_[at + k];
    }
    qt_defined_[tq] = true;
    at += need;
  }
}

void Decoder::read_dht(size_t at, size_t len) {
  size_t end = at + len;
  while (at < end) {
    if (at + 17 > end) fail(JPEG_ERR_CORRUPT, "short Huffman table");
    int tc = p_[at] >> 4, th = p_[at] & 15;
    if (tc > 1 || th > 3) fail(JPEG_ERR_CORRUPT, "bad Huffman table class or id");
    const uint8_t* counts = p_ + at + 1;
    int total = 0;
    for (int i = 0; i < 16; i++) total += counts[i];
    if (total > 256 || at + 17 + total > end) fail(JPEG_ERR_CORRUPT, "short Huffman table");
    build_huffman(tc ? ac_[th] : dc_[th], counts, p_ + at + 17, total, tc == 0);
    at += 17 + total;
  }
}

void Decoder::read_sof(int marker, size_t at, size_t len) {
  if (frame_) fail(JPEG_ERR_CORRUPT, "two frame headers");
  if (len < 6) fail(JPEG_ERR_CORRUPT, "short frame header");
  int precision = p_[at];
  if (precision != 8) {
    std::snprintf(g_message, sizeof(g_message), "%d-bit samples: only 8-bit JPEGs are decoded",
                  precision);
    throw Error{JPEG_ERR_UNSUPPORTED};
  }
  (void)marker;
  height = u16(at + 1);
  width = u16(at + 3);
  ncomp = p_[at + 5];
  if (height == 0) fail(JPEG_ERR_UNSUPPORTED, "height 0 (a DNL marker): not supported");
  if (width == 0) fail(JPEG_ERR_CORRUPT, "width 0");
  // Pillow's decompression-bomb limit (2 * Image.MAX_IMAGE_PIXELS)
  if (static_cast<long>(width) * height > 178956970L)
    fail(JPEG_ERR_UNSUPPORTED, "image above 178956970 pixels");
  if (ncomp == 4) {
    fail(JPEG_ERR_UNSUPPORTED,
         adobe_ && adobe_transform_ == 2 ? "YCCK (4 components): only 1 or 3 are decoded"
                                         : "CMYK (4 components): only 1 or 3 are decoded");
  }
  if (ncomp != 1 && ncomp != 3) {
    std::snprintf(g_message, sizeof(g_message), "%d components: only 1 or 3 are decoded", ncomp);
    throw Error{JPEG_ERR_UNSUPPORTED};
  }
  if (len != 6 + 3 * static_cast<size_t>(ncomp)) fail(JPEG_ERR_CORRUPT, "bad frame header length");
  for (int i = 0; i < ncomp; i++) {
    Component& c = comp_[i];
    c.id = p_[at + 6 + 3 * i];
    c.h = p_[at + 7 + 3 * i] >> 4;
    c.v = p_[at + 7 + 3 * i] & 15;
    c.tq = p_[at + 8 + 3 * i];
    if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
      fail(JPEG_ERR_CORRUPT, "bad component in the frame header");
    if (c.h > 2 || c.v > 2)
      fail(JPEG_ERR_UNSUPPORTED, "sampling factor above 2: only 1 or 2 are decoded");
    if (hmax_ < c.h) hmax_ = c.h;
    if (vmax_ < c.v) vmax_ = c.v;
  }
  if (ncomp == 1) {
    // a single component is one block an MCU whatever its factors
    comp_[0].h = comp_[0].v = 1;
    hmax_ = vmax_ = 1;
  }
  mcux_ = (width + 8 * hmax_ - 1) / (8 * hmax_);
  mcuy_ = (height + 8 * vmax_ - 1) / (8 * vmax_);
  // Every block of every component takes at least two bits (a DC code and an
  // AC code), so a file too short to hold them is truncated: it fails before
  // the coefficient planes are allocated.
  size_t min_bits = 0;
  for (int i = 0; i < ncomp; i++) {
    Component& c = comp_[i];
    c.bw = mcux_ * c.h;
    c.bh = mcuy_ * c.v;
    c.dw = static_cast<int>((static_cast<long>(width) * c.h + hmax_ - 1) / hmax_);
    c.dh = static_cast<int>((static_cast<long>(height) * c.v + vmax_ - 1) / vmax_);
    min_bits += 2 * static_cast<size_t>((c.dw + 7) / 8) * ((c.dh + 7) / 8);
  }
  if (min_bits > 8 * (n_ - pos_)) fail(JPEG_ERR_TRUNCATED, "truncated JPEG: too short for its frame");
  for (int i = 0; i < ncomp; i++) {
    Component& c = comp_[i];
    c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
  }
  frame_ = true;
}

void Decoder::read_app14(size_t at, size_t len) {
  if (len >= 12 && std::memcmp(p_ + at, "Adobe", 5) == 0) {
    adobe_ = true;
    adobe_transform_ = p_[at + 11];
  }
}

void Decoder::decode_block(BitReader& br, Component& c, int16_t* blk, int& pred,
                           const Huffman& dc, const Huffman& ac) {
  (void)c;
  int t = br.decode(dc);
  if (t > 11) fail(JPEG_ERR_CORRUPT, "bad DC magnitude");
  int diff = t ? extend(br.bits(t), t) : 0;
  // jdhuff.c's guard against overflowing the DC predictor
  if ((pred >= 0 && diff > INT32_MAX - pred) || (pred < 0 && diff < INT32_MIN - pred))
    fail(JPEG_ERR_CORRUPT, "DC coefficient out of range");
  pred += diff;
  blk[0] = static_cast<int16_t>(pred);
  for (int k = 1; k < 64;) {
    int rs = br.decode(ac);
    int r = rs >> 4, s = rs & 15;
    if (s == 0) {
      if (r == 15) {
        k += 16;
        continue;
      }
      break;  // EOB
    }
    k += r;
    if (k > 63) fail(JPEG_ERR_CORRUPT, "AC coefficients past the end of a block");
    blk[kZigzag[k]] = static_cast<int16_t>(extend(br.bits(s), s));
    k++;
  }
}

void Decoder::read_sos(size_t at, size_t len) {
  if (!frame_) fail(JPEG_ERR_CORRUPT, "scan before the frame header");
  if (len < 1) fail(JPEG_ERR_CORRUPT, "short scan header");
  int ns = p_[at];
  if (ns < 1 || ns > ncomp || len != 4 + 2 * static_cast<size_t>(ns))
    fail(JPEG_ERR_CORRUPT, "bad scan header");
  Component* sc[3];
  int td[3], ta[3];
  for (int i = 0; i < ns; i++) {
    int cid = p_[at + 1 + 2 * i];
    sc[i] = nullptr;
    for (int j = 0; j < ncomp; j++) {
      if (comp_[j].id == cid) sc[i] = &comp_[j];
    }
    if (sc[i] == nullptr || sc[i]->seen) fail(JPEG_ERR_CORRUPT, "bad component in a scan");
    sc[i]->seen = true;
    td[i] = p_[at + 2 + 2 * i] >> 4;
    ta[i] = p_[at + 2 + 2 * i] & 15;
    if (td[i] > 3 || ta[i] > 3 || !dc_[td[i]].defined || !ac_[ta[i]].defined)
      fail(JPEG_ERR_CORRUPT, "a scan names an undefined Huffman table");
  }
  size_t tail = at + 1 + 2 * ns;
  if (p_[tail] != 0 || p_[tail + 1] != 63 || p_[tail + 2] != 0)
    fail(JPEG_ERR_CORRUPT, "bad spectral selection for a sequential scan");

  BitReader br(p_, n_, pos_);
  int pred[3] = {0, 0, 0};
  // MCUs of the scan: interleaved (several components) or one block each
  int units_x, units_y;
  if (ns == 1) {
    units_x = (sc[0]->dw + 7) / 8;
    units_y = (sc[0]->dh + 7) / 8;
  } else {
    units_x = mcux_;
    units_y = mcuy_;
  }
  long total = static_cast<long>(units_x) * units_y;
  int expected_rst = 0;
  for (long m = 0; m < total; m++) {
    if (restart_ && m > 0 && m % restart_ == 0) {
      size_t mpos = br.finish();
      // mpos points at 0xFF; skip fill bytes
      size_t q = mpos;
      while (q < n_ && p_[q] == 0xFF) q++;
      if (q >= n_) fail(JPEG_ERR_TRUNCATED, "truncated JPEG at a restart marker");
      if (p_[q] != 0xD0 + expected_rst) fail(JPEG_ERR_CORRUPT, "missing or misnumbered RST marker");
      expected_rst = (expected_rst + 1) & 7;
      br.restart_at(q + 1);
      pred[0] = pred[1] = pred[2] = 0;
    }
    int my = static_cast<int>(m / units_x), mx = static_cast<int>(m % units_x);
    if (ns == 1) {
      Component& c = *sc[0];
      int16_t* blk = &c.coef[(static_cast<size_t>(my) * c.bw + mx) * 64];
      decode_block(br, c, blk, pred[0], dc_[td[0]], ac_[ta[0]]);
    } else {
      for (int i = 0; i < ns; i++) {
        Component& c = *sc[i];
        for (int by = 0; by < c.v; by++) {
          for (int bx = 0; bx < c.h; bx++) {
            size_t row = static_cast<size_t>(my) * c.v + by;
            size_t col = static_cast<size_t>(mx) * c.h + bx;
            decode_block(br, c, &c.coef[(row * c.bw + col) * 64], pred[i], dc_[td[i]],
                         ac_[ta[i]]);
          }
        }
      }
    }
  }
  pos_ = br.finish();
}

// jpeg_idct_islow, jidctint.c
constexpr int CONST_BITS = 13, PASS1_BITS = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                  FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

// JLONG arithmetic (64-bit), as the reference computes
inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// the post-IDCT range-limit table (jdmaster.c prepare_range_limit_table),
// indexed by the centred sample & 1023
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; i++) {
      if (i < 128) t[i] = static_cast<uint8_t>(i + 128);
      else if (i < 512) t[i] = 255;
      else if (i < 896) t[i] = 0;
      else t[i] = static_cast<uint8_t>(i - 896);
    }
  }
};
const RangeLimit kRange;

// A sample through the range-limit table.  The table clamps what lies in
// [-512, 511] and wraps what lies beyond; libjpeg-turbo's SIMD IDCT clamps
// there instead, so Pillow's two builds part only where the index wraps.
// Legitimate data never gets there, only corrupt coefficients (or
// quantization tables) do: the decode then fails.
inline uint8_t range_limit(int64_t x, bool& wild) {
  wild |= static_cast<uint64_t>(x + 512) > 1023;
  return kRange.t[x & 1023];
}

// false when an output sample fell outside the range-limit table
bool idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, size_t stride) {
  bool wild = false;
  int32_t ws[64];  // the reference's int workspace
  for (int c = 0; c < 8; c++) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int32_t* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 && ip[48] == 0 &&
        ip[56] == 0) {
      int64_t dc = (static_cast<int64_t>(ip[0]) * qp[0]) * (1 << PASS1_BITS);
      for (int r = 0; r < 8; r++) wp[8 * r] = static_cast<int32_t>(dc);
      continue;
    }
    int64_t z2 = static_cast<int64_t>(ip[16]) * qp[16];
    int64_t z3 = static_cast<int64_t>(ip[48]) * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = static_cast<int64_t>(ip[0]) * qp[0];
    z3 = static_cast<int64_t>(ip[32]) * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = static_cast<int64_t>(ip[56]) * qp[56];
    tmp1 = static_cast<int64_t>(ip[40]) * qp[40];
    tmp2 = static_cast<int64_t>(ip[24]) * qp[24];
    tmp3 = static_cast<int64_t>(ip[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * -FIX_0_899976223;
    z2 = z2 * -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560;
    z4 = z4 * -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int S = CONST_BITS - PASS1_BITS;
    wp[0] = (int32_t)descale(tmp10 + tmp3, S);
    wp[56] = (int32_t)descale(tmp10 - tmp3, S);
    wp[8] = (int32_t)descale(tmp11 + tmp2, S);
    wp[48] = (int32_t)descale(tmp11 - tmp2, S);
    wp[16] = (int32_t)descale(tmp12 + tmp1, S);
    wp[40] = (int32_t)descale(tmp12 - tmp1, S);
    wp[24] = (int32_t)descale(tmp13 + tmp0, S);
    wp[32] = (int32_t)descale(tmp13 - tmp0, S);
  }
  for (int r = 0; r < 8; r++) {
    const int32_t* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 && wp[6] == 0 &&
        wp[7] == 0) {
      uint8_t dcv = range_limit(descale(wp[0], PASS1_BITS + 3), wild);
      for (int c = 0; c < 8; c++) op[c] = dcv;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (static_cast<int64_t>(wp[0]) + wp[4]) * (1 << CONST_BITS);
    int64_t tmp1 = (static_cast<int64_t>(wp[0]) - wp[4]) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * -FIX_0_899976223;
    z2 = z2 * -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560;
    z4 = z4 * -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int S = CONST_BITS + PASS1_BITS + 3;
    op[0] = range_limit(descale(tmp10 + tmp3, S), wild);
    op[7] = range_limit(descale(tmp10 - tmp3, S), wild);
    op[1] = range_limit(descale(tmp11 + tmp2, S), wild);
    op[6] = range_limit(descale(tmp11 - tmp2, S), wild);
    op[2] = range_limit(descale(tmp12 + tmp1, S), wild);
    op[5] = range_limit(descale(tmp12 - tmp1, S), wild);
    op[3] = range_limit(descale(tmp13 + tmp0, S), wild);
    op[4] = range_limit(descale(tmp13 - tmp0, S), wild);
  }
  return !wild;
}

void Decoder::idct_all() {
  for (int i = 0; i < ncomp; i++) {
    Component& c = comp_[i];
    if (!qt_defined_[c.tq]) fail(JPEG_ERR_CORRUPT, "a component names an undefined quantization table");
    size_t stride = static_cast<size_t>(c.bw) * 8;
    c.plane.assign(stride * c.bh * 8, 0);
    for (int by = 0; by < c.bh; by++) {
      for (int bx = 0; bx < c.bw; bx++) {
        if (!idct_islow(&c.coef[(static_cast<size_t>(by) * c.bw + bx) * 64], qt_[c.tq],
                        &c.plane[static_cast<size_t>(by) * 8 * stride + bx * 8], stride))
          fail(JPEG_ERR_CORRUPT, "IDCT output out of range: corrupt coefficients");
      }
    }
    std::vector<int16_t>().swap(c.coef);
  }
}

// One component at full resolution (width x height), as jdsample.c makes it
// with do_fancy_upsampling: the real samples (dw x dh), edge rows
// replicated below the last and above the first.
void Decoder::upsample(const Component& c, std::vector<uint8_t>& out) {
  const size_t stride = static_cast<size_t>(c.bw) * 8;
  const int hx = hmax_ / c.h, vx = vmax_ / c.v;
  const int dw = c.dw, dh = c.dh;
  const int ow = dw * hx;  // >= width
  out.assign(static_cast<size_t>(ow) * dh * vx, 0);
  auto row = [&](int y) -> const uint8_t* {  // edge replication (jdmainct.c)
    if (y < 0) y = 0;
    if (y >= dh) y = dh - 1;
    return &c.plane[static_cast<size_t>(y) * stride];
  };
  if (hx == 1 && vx == 1) {
    for (int y = 0; y < dh; y++) std::memcpy(&out[static_cast<size_t>(y) * ow], row(y), dw);
    return;
  }
  if (hx == 2 && vx == 1) {
    for (int y = 0; y < dh; y++) {
      const uint8_t* in = row(y);
      uint8_t* o = &out[static_cast<size_t>(y) * ow];
      if (dw <= 2) {  // h2v1_upsample
        for (int x = 0; x < dw; x++) o[2 * x] = o[2 * x + 1] = in[x];
        continue;
      }
      // h2v1_fancy_upsample
      int v = in[0];
      o[0] = static_cast<uint8_t>(v);
      o[1] = static_cast<uint8_t>((v * 3 + in[1] + 2) >> 2);
      for (int x = 1; x < dw - 1; x++) {
        v = in[x] * 3;
        o[2 * x] = static_cast<uint8_t>((v + in[x - 1] + 1) >> 2);
        o[2 * x + 1] = static_cast<uint8_t>((v + in[x + 1] + 2) >> 2);
      }
      v = in[dw - 1];
      o[2 * dw - 2] = static_cast<uint8_t>((v * 3 + in[dw - 2] + 1) >> 2);
      o[2 * dw - 1] = static_cast<uint8_t>(v);
    }
    return;
  }
  if (hx == 1 && vx == 2) {  // h1v2_fancy_upsample
    for (int y = 0; y < dh; y++) {
      const uint8_t* in0 = row(y);
      for (int half = 0; half < 2; half++) {
        const uint8_t* in1 = row(half == 0 ? y - 1 : y + 1);
        int bias = half == 0 ? 1 : 2;
        uint8_t* o = &out[static_cast<size_t>(2 * y + half) * ow];
        for (int x = 0; x < dw; x++) o[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
      }
    }
    return;
  }
  // hx == 2 && vx == 2
  for (int y = 0; y < dh; y++) {
    const uint8_t* in0 = row(y);
    for (int half = 0; half < 2; half++) {
      uint8_t* o = &out[static_cast<size_t>(2 * y + half) * ow];
      if (dw <= 2) {  // h2v2_upsample: plain replication, no vertical filter
        for (int x = 0; x < dw; x++) o[2 * x] = o[2 * x + 1] = in0[x];
        continue;
      }
      const uint8_t* in1 = row(half == 0 ? y - 1 : y + 1);
      int this_sum = in0[0] * 3 + in1[0];
      int next_sum = in0[1] * 3 + in1[1];
      o[0] = static_cast<uint8_t>((this_sum * 4 + 8) >> 4);
      o[1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
      int last_sum = this_sum;
      this_sum = next_sum;
      for (int x = 1; x < dw - 1; x++) {
        next_sum = in0[x + 1] * 3 + in1[x + 1];
        o[2 * x] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
        o[2 * x + 1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
        last_sum = this_sum;
        this_sum = next_sum;
      }
      o[2 * dw - 2] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
      o[2 * dw - 1] = static_cast<uint8_t>((this_sum * 4 + 7) >> 4);
    }
  }
}

// ycc_rgb_convert, jdcolor.c
struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    constexpr int SCALEBITS = 16;
    constexpr int32_t ONE_HALF = 1 << (SCALEBITS - 1);
    auto fix = [](double x) { return static_cast<int32_t>(x * (1 << SCALEBITS) + 0.5); };
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = static_cast<int>((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + ONE_HALF;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

void Decoder::color(uint8_t* dst) {
  std::vector<uint8_t> full[3];
  size_t ow[3];
  for (int i = 0; i < ncomp; i++) {
    upsample(comp_[i], full[i]);
    ow[i] = static_cast<size_t>(comp_[i].dw) * (hmax_ / comp_[i].h);
  }
  if (ncomp == 1) {
    for (int y = 0; y < height; y++) {
      const uint8_t* g = &full[0][y * ow[0]];
      uint8_t* o = dst + static_cast<size_t>(y) * width * 3;
      for (int x = 0; x < width; x++) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = g[x];
    }
    return;
  }
  // jpeg_default_colorspace (jdapimin.c): JFIF -> YCbCr; Adobe transform 0
  // -> RGB; else component ids 'R','G','B' -> RGB; else YCbCr
  bool rgb;
  if (jfif_) rgb = false;
  else if (adobe_) rgb = adobe_transform_ == 0;
  else rgb = comp_[0].id == 'R' && comp_[1].id == 'G' && comp_[2].id == 'B';
  if (adobe_ && !jfif_ && adobe_transform_ != 0 && adobe_transform_ != 1)
    fail(JPEG_ERR_UNSUPPORTED, "Adobe colour transform other than 0 or 1");
  for (int y = 0; y < height; y++) {
    const uint8_t* c0 = &full[0][y * ow[0]];
    const uint8_t* c1 = &full[1][y * ow[1]];
    const uint8_t* c2 = &full[2][y * ow[2]];
    uint8_t* o = dst + static_cast<size_t>(y) * width * 3;
    if (rgb) {
      for (int x = 0; x < width; x++) {
        o[3 * x] = c0[x];
        o[3 * x + 1] = c1[x];
        o[3 * x + 2] = c2[x];
      }
      continue;
    }
    for (int x = 0; x < width; x++) {
      int yy = c0[x], cb = c1[x], cr = c2[x];
      o[3 * x] = clamp255(yy + kYcc.cr_r[cr]);
      o[3 * x + 1] = clamp255(yy + static_cast<int>((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
      o[3 * x + 2] = clamp255(yy + kYcc.cb_b[cb]);
    }
  }
}

void Decoder::read_headers_to_frame() {
  if (n_ < 4 || p_[0] != 0xFF || p_[1] != 0xD8) fail(JPEG_ERR_CORRUPT, "not a JPEG (no SOI)");
  pos_ = 2;
  for (;;) {
    int m = next_marker();
    size_t len;
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
    if (m == 0xD9) fail(JPEG_ERR_CORRUPT, "EOI before the frame header");
    size_t at = segment(&len);
    switch (m) {
      case 0xC0:
      case 0xC1:
        read_sof(m, at, len);
        return;
      case 0xC2:
        fail(JPEG_ERR_UNSUPPORTED, "progressive JPEG: only baseline sequential is decoded");
      case 0xC3:
        fail(JPEG_ERR_UNSUPPORTED, "lossless JPEG: only baseline sequential is decoded");
      case 0xC5:
      case 0xC6:
      case 0xC7:
      case 0xCD:
      case 0xCE:
      case 0xCF:
        fail(JPEG_ERR_UNSUPPORTED, "hierarchical JPEG: only baseline sequential is decoded");
      case 0xC9:
      case 0xCA:
      case 0xCB:
        fail(JPEG_ERR_UNSUPPORTED,
             "arithmetic-coded JPEG: only Huffman-coded baseline is decoded");
      case 0xC4:
        read_dht(at, len);
        break;
      case 0xCC:
        fail(JPEG_ERR_UNSUPPORTED,
             "arithmetic-coded JPEG (DAC): only Huffman-coded baseline is decoded");
      case 0xDB:
        read_dqt(at, len);
        break;
      case 0xDD:
        if (len != 2) fail(JPEG_ERR_CORRUPT, "bad DRI length");
        restart_ = u16(at);
        break;
      case 0xE0:
        if (len >= 5 && std::memcmp(p_ + at, "JFIF\0", 5) == 0) jfif_ = true;
        break;
      case 0xEE:
        read_app14(at, len);
        break;
      case 0xDA:
        fail(JPEG_ERR_CORRUPT, "scan before the frame header");
      default:
        break;  // APPn, COM and others: skipped
    }
  }
}

void Decoder::decode(uint8_t* dst) {
  // after the frame header: tables, scans, EOI
  bool any_scan = false;
  for (;;) {
    int m = next_marker();
    if (m == 0xD9) break;
    if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) fail(JPEG_ERR_CORRUPT, "stray RST marker");
    size_t len;
    size_t at = segment(&len);
    switch (m) {
      case 0xC4:
        read_dht(at, len);
        break;
      case 0xDB:
        read_dqt(at, len);
        break;
      case 0xDD:
        if (len != 2) fail(JPEG_ERR_CORRUPT, "bad DRI length");
        restart_ = u16(at);
        break;
      case 0xEE:
        read_app14(at, len);
        break;
      case 0xDC:
        fail(JPEG_ERR_UNSUPPORTED, "DNL marker: not supported");
      case 0xDA:
        read_sos(at, len);
        any_scan = true;
        break;
      default:
        if ((m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC))
          fail(JPEG_ERR_CORRUPT, "a second frame header");
        break;
    }
  }
  if (!any_scan) fail(JPEG_ERR_CORRUPT, "JPEG without a scan");
  for (int i = 0; i < ncomp; i++) {
    if (!comp_[i].seen) fail(JPEG_ERR_TRUNCATED, "a component was in no scan");
  }
  idct_all();
  color(dst);
}

int run(const uint8_t* src, size_t n, int* info, uint8_t* dst, size_t cap) {
  try {
    Decoder d(src, n);
    d.read_headers_to_frame();
    info[0] = d.width;
    info[1] = d.height;
    info[2] = d.ncomp;
    if (dst == nullptr) return JPEG_OK;
    if (cap < static_cast<size_t>(d.width) * d.height * 3)
      fail(JPEG_ERR_DST_SMALL, "output buffer too small");
    d.decode(dst);
    return JPEG_OK;
  } catch (const Error& e) {
    return e.code;
  } catch (const std::bad_alloc&) {
    std::snprintf(g_message, sizeof(g_message), "out of host memory");
    return JPEG_ERR_CORRUPT;
  }
}

}  // namespace

extern "C" {

// The frame's width, height and components into info[0..3); 0 or an error
// code (see myriad_jpeg_error).
int myriad_jpeg_info(const uint8_t* src, size_t n, int* info) {
  return run(src, n, info, nullptr, 0);
}

// Decode src[0..n) into dst (height x width x 3 RGB bytes, at most cap);
// 0 or an error code.
int myriad_jpeg_decode(const uint8_t* src, size_t n, uint8_t* dst, size_t cap) {
  int info[3];
  return run(src, n, info, dst, cap);
}

const char* myriad_jpeg_error() { return g_message; }

}  // extern "C"
