// lzs_tpu native runtime: clean-room C++17 LZS codec (ANSI X3.241-1994).
//
// This is the host-side runtime of the codec: one-shot and
// streaming encode/decode, plus the sequential assembly stage of the
// hybrid device pipeline (greedy walk + extension + bit packing over
// device-computed match tables). Implemented from the wire-format
// specification in lzs_tpu/spec.py; the deterministic encoder policy is
// the one verified byte-identical across the reference implementations
// (see SURVEY.md section 3.5 and lzs_tpu/spec.py):
//   score(d) = min(runlen(i,d), min(remaining, 12)), maximize score,
//   ties to the nearest offset, emit the full run of the chosen offset.
//
// Exported C ABI (see lzs_tpu/utils/native.py for the ctypes binding):
//   lzs_nat_compress / lzs_nat_decompress       one-shot
//   lzs_nat_emit                                hybrid walk+pack stage
//   lzs_nat_enc_*  / lzs_nat_dec_*              streaming sessions

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kWindow = 2047;
constexpr int kMinMatch = 2;
constexpr int kMaxShortLen = 8;
constexpr int kMaxNibble = 15;
constexpr int kSearchCap = 12;
constexpr uint32_t kEndMarker = 0b110000000;  // 9 bits

// Length code (value, width) for initial lengths 2..8.
constexpr uint8_t kLenVal[9] = {0, 0, 0b00, 0b01, 0b10,
                                0b1100, 0b1101, 0b1110, 0b1111};
constexpr uint8_t kLenWidth[9] = {0, 0, 2, 2, 2, 4, 4, 4, 4};

// ---------------------------------------------------------------------
// Bit IO (MSB-first)
// ---------------------------------------------------------------------

class BitWriter {
 public:
  BitWriter(uint8_t* out, size_t cap) : out_(out), cap_(cap) {}

  // Resume mid-byte: phase in [0,8) bits already occupied in `partial`.
  void resume(uint8_t partial, int phase) {
    acc_ = static_cast<uint64_t>(partial >> (8 - phase));
    nbits_ = phase;
  }

  void put(uint32_t value, int width) {
    acc_ = (acc_ << width) | (value & ((1u << width) - 1u));
    nbits_ += width;
    while (nbits_ >= 8) {
      nbits_ -= 8;
      if (pos_ < cap_) out_[pos_] = static_cast<uint8_t>(acc_ >> nbits_);
      ++pos_;
    }
    acc_ &= (1ull << nbits_) - 1u;
  }

  void pad_to_byte() {
    if (nbits_) put(0, 8 - nbits_);
  }

  size_t bytes() const { return pos_; }
  bool overflow() const { return pos_ > cap_; }
  int phase() const { return nbits_; }
  uint8_t partial() const {
    return static_cast<uint8_t>((acc_ << (8 - nbits_)) & 0xFF);
  }

 private:
  uint8_t* out_;
  size_t cap_;
  size_t pos_ = 0;
  uint64_t acc_ = 0;
  int nbits_ = 0;
};

class BitReader {
 public:
  BitReader(const uint8_t* in, size_t nbytes) : in_(in), bits_(nbytes * 8) {}

  size_t remaining() const { return bits_ - pos_; }

  uint32_t take(int width) {
    uint32_t v = 0;
    for (int k = 0; k < width; ++k, ++pos_)
      v = (v << 1) | ((in_[pos_ >> 3] >> (7 - (pos_ & 7))) & 1u);
    return v;
  }

  uint32_t peek(int width) const {
    // caller ensures remaining() >= width is NOT required: pad with zeros
    uint32_t v = 0;
    size_t p = pos_;
    for (int k = 0; k < width; ++k, ++p)
      v = (v << 1) |
          (p < bits_ ? ((in_[p >> 3] >> (7 - (p & 7))) & 1u) : 0u);
    return v;
  }

  void skip_to_byte() { pos_ = (pos_ + 7) & ~size_t{7}; }
  size_t bitpos() const { return pos_; }
  void set_bitpos(size_t p) { pos_ = p; }

 private:
  const uint8_t* in_;
  size_t bits_;
  size_t pos_ = 0;
};

// ---------------------------------------------------------------------
// Match search: 2-byte-key chains, exact reference policy
// ---------------------------------------------------------------------

struct MatchTable {
  std::vector<int32_t> head;  // 65536 entries, last position per 2-gram
  std::vector<int32_t> prev;  // chain links per position

  explicit MatchTable(size_t n) : head(65536, -1), prev(n, -1) {}

  static uint32_t key(const uint8_t* p) {
    return (static_cast<uint32_t>(p[0]) << 8) | p[1];
  }

  void insert(const uint8_t* data, size_t i, size_t n) {
    if (i + 1 >= n) return;  // needs a full 2-gram
    uint32_t k = key(data + i);
    prev[i] = head[k];
    head[k] = static_cast<int32_t>(i);
  }
};

inline int match_len(const uint8_t* a, const uint8_t* b, int cap) {
  int l = 0;
  while (l < cap && a[l] == b[l]) ++l;
  return l;
}

// Best match at position i: returns capped score (0 if none) and offset.
inline int best_match(const uint8_t* data, size_t n, size_t i,
                      const MatchTable& mt, int* off_out) {
  int cap = static_cast<int>(n - i);
  if (cap > kSearchCap) cap = kSearchCap;
  if (cap < kMinMatch) return 0;
  int best = 0, best_off = 0;
  for (int32_t j = mt.head[MatchTable::key(data + i)]; j >= 0;
       j = mt.prev[j]) {
    int d = static_cast<int>(i) - j;
    if (d > kWindow) break;  // chain is recency-ordered
    int l = match_len(data + i, data + j, cap);
    if (l > best) {
      best = l;
      best_off = d;
      if (l >= cap) break;
    }
  }
  *off_out = best_off;
  return best;
}

inline void emit_match(BitWriter& w, int off, size_t full) {
  w.put(1, 1);
  if (off <= 127) {
    w.put((1u << 7) | static_cast<uint32_t>(off), 8);
  } else {
    w.put(static_cast<uint32_t>(off), 12);
  }
  int initial = full < kMaxShortLen ? static_cast<int>(full) : kMaxShortLen;
  w.put(kLenVal[initial], kLenWidth[initial]);
  if (initial == kMaxShortLen) {
    size_t rest = full - kMaxShortLen;
    for (;;) {
      int nib = rest < kMaxNibble ? static_cast<int>(rest) : kMaxNibble;
      w.put(static_cast<uint32_t>(nib), 4);
      rest -= nib;
      if (nib != kMaxNibble) break;
    }
  }
}

}  // namespace

extern "C" {

// One-shot compress. Returns bytes written, or (size_t)-1 on overflow.
size_t lzs_nat_compress(const uint8_t* in, size_t n, uint8_t* out,
                        size_t cap) {
  BitWriter w(out, cap);
  MatchTable mt(n);
  size_t i = 0;
  while (i < n) {
    int off;
    int score = best_match(in, n, i, mt, &off);
    if (score >= kMinMatch) {
      size_t full = score;
      while (i + full < n && in[i + full] == in[i + full - off]) ++full;
      emit_match(w, off, full);
      for (size_t p = i; p < i + full; ++p) mt.insert(in, p, n);
      i += full;
    } else {
      w.put(in[i], 9);
      mt.insert(in, i, n);
      ++i;
    }
  }
  w.put(kEndMarker, 9);
  w.pad_to_byte();
  return w.overflow() ? static_cast<size_t>(-1) : w.bytes();
}

// Hybrid assembly: greedy walk + extension + bit pack over device-computed
// per-position match tables (capped score + chosen offset).
size_t lzs_nat_emit(const uint8_t* in, size_t n, const int32_t* score,
                    const int32_t* off, uint8_t* out, size_t cap) {
  BitWriter w(out, cap);
  size_t i = 0;
  while (i < n) {
    if (score[i] >= kMinMatch) {
      int d = off[i];
      size_t full = score[i];
      while (i + full < n && in[i + full] == in[i + full - d]) ++full;
      emit_match(w, d, full);
      i += full;
    } else {
      w.put(in[i], 9);
      ++i;
    }
  }
  w.put(kEndMarker, 9);
  w.pad_to_byte();
  return w.overflow() ? static_cast<size_t>(-1) : w.bytes();
}

// One-shot decompress. Stops at the first end marker unless multi_stream.
// Returns bytes produced; *consumed gets input bytes consumed (rounded up
// to whole bytes at the stop point).
size_t lzs_nat_decompress(const uint8_t* in, size_t n, uint8_t* out,
                          size_t cap, int multi_stream, size_t* consumed) {
  BitReader r(in, n);
  size_t o = 0;
  for (;;) {
    if (r.remaining() < 2) break;
    if (o >= cap) break;
    if (r.take(1) == 0) {  // literal
      if (r.remaining() < 8) break;
      out[o++] = static_cast<uint8_t>(r.take(8));
      continue;
    }
    int offset;
    if (r.take(1)) {  // short offset
      if (r.remaining() < 7) break;
      offset = static_cast<int>(r.take(7));
      if (offset == 0) {  // end marker
        r.skip_to_byte();
        if (!multi_stream) break;
        continue;
      }
    } else {
      if (r.remaining() < 11) break;
      offset = static_cast<int>(r.take(11));
    }
    uint32_t pfx = r.peek(4);
    int len, width;
    if ((pfx >> 2) < 3) {
      len = static_cast<int>(pfx >> 2) + 2;
      width = 2;
    } else {
      len = static_cast<int>(pfx & 3) + 5;
      width = 4;
    }
    if (r.remaining() < static_cast<size_t>(width)) break;
    r.take(width);
    auto copy = [&](int count) {
      int k = 0;
      for (; k < count && o < cap && o < static_cast<size_t>(offset);
           ++k, ++o)
        out[o] = 0;  // before start of output: zero-fill semantics
      while (k < count && o < cap) {
        size_t run = static_cast<size_t>(count - k);
        if (run > cap - o) run = cap - o;
        if (static_cast<size_t>(offset) >= run) {
          std::memcpy(out + o, out + o - offset, run);
        } else {
          for (size_t t = 0; t < run; ++t) out[o + t] = out[o + t - offset];
        }
        o += run;
        k += static_cast<int>(run);
      }
    };
    copy(len);
    if (len == kMaxShortLen) {
      for (;;) {
        if (r.remaining() < 4) break;
        int nib = static_cast<int>(r.take(4));
        copy(nib);
        if (nib != kMaxNibble) break;
      }
    }
  }
  if (consumed) *consumed = (r.bitpos() + 7) / 8;
  return o;
}

// ---------------------------------------------------------------------
// Streaming encoder session
// ---------------------------------------------------------------------
// Accumulates input in an internal buffer (history + unprocessed bytes),
// emits tokens as soon as they are fully determined: a token decision at
// position p needs min(remaining, 12) lookahead, and an in-progress run
// is held open until it mismatches or finish is signalled. Status bits
// mirror the reference's streaming protocol.

enum {
  LZS_NAT_INPUT_STARVED = 1,
  LZS_NAT_OUTPUT_FULL = 2,
  LZS_NAT_FINISHED = 4,
  LZS_NAT_END_MARKER = 8,
};

struct LzsNatEncoder {
  std::vector<uint8_t> buf;  // history + pending bytes
  size_t pos = 0;            // next unencoded position within buf
  uint8_t partial = 0;       // bit remnant
  int phase = 0;
  bool done = false;

  void compact() {
    size_t keep_from = pos > static_cast<size_t>(kWindow)
                           ? pos - kWindow : 0;
    if (keep_from > 4096) {  // amortize moves
      buf.erase(buf.begin(), buf.begin() + keep_from);
      pos -= keep_from;
    }
  }
};

LzsNatEncoder* lzs_nat_enc_new() { return new LzsNatEncoder(); }
void lzs_nat_enc_free(LzsNatEncoder* e) { delete e; }

// Feed input; write output. Returns status bits. *in_used / *out_used
// report consumption/production. finish=1 flushes and appends the marker.
int lzs_nat_enc_feed(LzsNatEncoder* e, const uint8_t* in, size_t n,
                     uint8_t* out, size_t cap, int finish, size_t* in_used,
                     size_t* out_used) {
  e->buf.insert(e->buf.end(), in, in + n);
  if (in_used) *in_used = n;
  BitWriter w(out, cap);
  w.resume(e->partial, e->phase);
  int status = 0;

  const size_t total = e->buf.size();
  const uint8_t* data = e->buf.data();
  // Rebuild chains over the live region (history window + pending).
  // O(window + pending) per feed; fine for chunked streaming.
  size_t base = e->pos > static_cast<size_t>(kWindow)
                    ? e->pos - kWindow : 0;
  MatchTable mt(total - base);
  for (size_t p = base; p < e->pos; ++p)
    mt.insert(data + base, p - base, total - base);

  size_t i = e->pos;
  while (i < total && !e->done) {
    size_t avail = total - i;
    // a decision needs full 12-byte lookahead unless finishing
    if (!finish && avail < static_cast<size_t>(kSearchCap)) break;
    int off;
    int score = best_match(data + base, total - base, i - base, mt, &off);
    size_t full = 0;
    if (score >= kMinMatch) {
      full = score;
      while (i + full < total && data[i + full] == data[i + full - off])
        ++full;
      // run may continue into future input: hold the token open
      if (!finish && i + full == total) break;
      // worst-case token bytes: header (4) + one nibble per 15 bytes
      if (w.bytes() + 8 + full / 30 > cap) {
        status |= LZS_NAT_OUTPUT_FULL;
        break;
      }
      emit_match(w, off, full);
    } else {
      if (w.bytes() + 8 > cap) {
        status |= LZS_NAT_OUTPUT_FULL;
        break;
      }
      full = 1;
      w.put(data[i], 9);
    }
    for (size_t p = i; p < i + full; ++p)
      mt.insert(data + base, p - base, total - base);
    i += full;
  }
  e->pos = i;
  if (finish && i >= total && !e->done) {
    if (w.bytes() + 8 > cap) {
      status |= LZS_NAT_OUTPUT_FULL;
    } else {
      w.put(kEndMarker, 9);
      w.pad_to_byte();
      e->done = true;
      status |= LZS_NAT_FINISHED | LZS_NAT_END_MARKER;
    }
  }
  if (!e->done && e->pos >= e->buf.size()) status |= LZS_NAT_INPUT_STARVED;
  e->partial = w.partial();
  e->phase = w.phase();
  if (out_used) *out_used = w.bytes();
  e->compact();
  return status;
}

// ---------------------------------------------------------------------
// Streaming decoder session
// ---------------------------------------------------------------------

struct LzsNatDecoder {
  std::vector<uint8_t> inbuf;   // unconsumed input bytes
  size_t inbit = 0;             // bit position within inbuf
  std::vector<uint8_t> hist;    // last kWindow output bytes
  int mode = 0;                 // 0 normal, 1 extended
  int cur_off = 0;
  int pending = 0;              // copy bytes owed from a token already parsed
  int markers = 0;

};

LzsNatDecoder* lzs_nat_dec_new() { return new LzsNatDecoder(); }
void lzs_nat_dec_free(LzsNatDecoder* d) { delete d; }
int lzs_nat_dec_markers(LzsNatDecoder* d) { return d->markers; }

// Feed input; write output. Returns status bits.
int lzs_nat_dec_feed(LzsNatDecoder* d, const uint8_t* in, size_t n,
                     uint8_t* out, size_t cap, size_t* in_used,
                     size_t* out_used) {
  d->inbuf.insert(d->inbuf.end(), in, in + n);
  if (in_used) *in_used = n;
  BitReader r(d->inbuf.data(), d->inbuf.size());
  r.set_bitpos(d->inbit);
  size_t o = 0;
  int status = 0;
  // Snapshot the pre-feed history once; during the feed the window is
  // (h0 tail + out[0..o)), so copies read straight out of the output
  // buffer in bulk instead of a per-byte vector push.
  const std::vector<uint8_t> h0(d->hist);
  const size_t hs = h0.size();
  auto copy = [&](int count) -> int {  // returns bytes copied
    int k = 0;
    const int off = d->cur_off;
    // prefix while the source still reaches into pre-feed history
    for (; k < count && o < cap && o < static_cast<size_t>(off);
         ++k, ++o) {
      size_t back = static_cast<size_t>(off) - o;
      out[o] = back <= hs ? h0[hs - back] : 0;
    }
    while (k < count && o < cap) {
      size_t run = static_cast<size_t>(count - k);
      if (run > cap - o) run = cap - o;
      if (static_cast<size_t>(off) >= run) {
        std::memcpy(out + o, out + o - off, run);
      } else {
        for (size_t t = 0; t < run; ++t) out[o + t] = out[o + t - off];
      }
      o += run;
      k += static_cast<int>(run);
    }
    return k;
  };
  for (;;) {
    // first drain any copy bytes owed by an already-parsed token
    if (d->pending) {
      d->pending -= copy(d->pending);
      if (d->pending) { status |= LZS_NAT_OUTPUT_FULL; break; }
    }
    if (d->mode == 1) {
      if (r.remaining() < 4) { status |= LZS_NAT_INPUT_STARVED; break; }
      int nib = static_cast<int>(r.take(4));
      if (nib != kMaxNibble) d->mode = 0;  // bitstream state advances now
      d->pending = nib - copy(nib);
      if (d->pending) { status |= LZS_NAT_OUTPUT_FULL; break; }
      continue;
    }
    if (r.remaining() < 2) { status |= LZS_NAT_INPUT_STARVED; break; }
    if (r.peek(1) == 0) {  // literal
      if (r.remaining() < 9) { status |= LZS_NAT_INPUT_STARVED; break; }
      if (o >= cap) { status |= LZS_NAT_OUTPUT_FULL; break; }
      r.take(1);
      out[o++] = static_cast<uint8_t>(r.take(8));
      continue;
    }
    // match or end marker
    size_t save = r.bitpos();
    uint32_t two = r.peek(2);
    if ((two & 1u) != 0) {  // short offset
      if (r.remaining() < 9) { status |= LZS_NAT_INPUT_STARVED; break; }
      r.take(2);
      int offset = static_cast<int>(r.take(7));
      if (offset == 0) {
        r.skip_to_byte();
        ++d->markers;
        status |= LZS_NAT_END_MARKER;
        continue;  // incremental semantics: continue into next stream
      }
      d->cur_off = offset;
    } else {
      if (r.remaining() < 13) { status |= LZS_NAT_INPUT_STARVED; break; }
      r.take(2);
      d->cur_off = static_cast<int>(r.take(11));
    }
    uint32_t pfx = r.peek(4);
    int len, width;
    if ((pfx >> 2) < 3) {
      len = static_cast<int>(pfx >> 2) + 2;
      width = 2;
    } else {
      len = static_cast<int>(pfx & 3) + 5;
      width = 4;
    }
    if (r.remaining() < static_cast<size_t>(width)) {
      r.set_bitpos(save);
      status |= LZS_NAT_INPUT_STARVED;
      break;
    }
    r.take(width);
    if (len == kMaxShortLen) d->mode = 1;  // extension follows this copy
    d->pending = len - copy(len);
    if (d->pending) { status |= LZS_NAT_OUTPUT_FULL; break; }
  }
  // rebuild the carried window from (pre-feed history + this output)
  if (o >= static_cast<size_t>(kWindow)) {
    d->hist.assign(out + o - kWindow, out + o);
  } else if (o) {
    d->hist.insert(d->hist.end(), out, out + o);
    if (d->hist.size() > static_cast<size_t>(kWindow))
      d->hist.erase(d->hist.begin(), d->hist.end() - kWindow);
  }
  // drop consumed whole bytes from inbuf
  size_t done_bytes = r.bitpos() >> 3;
  d->inbuf.erase(d->inbuf.begin(), d->inbuf.begin() + done_bytes);
  d->inbit = r.bitpos() & 7;
  if (out_used) *out_used = o;
  return status;
}

}  // extern "C"
