// Layer III bitstream assembler: native fast path.
//
// C++ reimplementation of the Python assembler in
// mp3tpu/numpy_ref/bitstream.py (itself a replica of the reference's
// l3bitstream.c + formatBitstream.c): MSB-first bit writer, side-info
// FIFO realizing the main_data_begin back-pointer, scalefactor and
// Huffman emission (ESC linbits + sign packing), and the trailing
// zero byte the reference's close path emits.  The per-frame
// add_frame entry is byte-exact vs the oracle; the whole-clip
// entry points DELIBERATELY deviate on stuffing placement (all
// stuffing goes to the ancillary drain instead of 1-bit-padding
// granule 0 -- see the comment in the stuffing plan below for why
// the reference's scheme corrupts decoders).
//
// Exposed as a C ABI for ctypes (see mp3tpu/runtime/bitstream.py).
#include <cstdint>
#include <cstring>
#include <deque>
#include <utility>
#include <vector>

#include "huffdata.h"

namespace {

struct BitWriter {
  std::vector<uint8_t> buf;
  uint64_t acc = 0;
  int nbits = 0;

  void put(uint32_t val, int n) {
    if (n == 0) return;
    acc = (acc << n) | (val & ((n >= 32) ? 0xFFFFFFFFu : ((1u << n) - 1)));
    nbits += n;
    while (nbits >= 8) {
      nbits -= 8;
      buf.push_back(static_cast<uint8_t>((acc >> nbits) & 0xFF));
    }
    acc &= (1ull << nbits) - 1;
  }
};

struct Element {
  uint32_t value;
  uint16_t length;
};

struct SideRecord {
  int frame_len;
  std::vector<Element> si;
  int si_bits;
};

struct GranuleSide {
  int p23, big_values, global_gain, compress, wsf, block_type, mixed;
  int ts[3], r0, r1, preflag, scalefac_scale, c1ts, part2, a1, a2, count1;
};

constexpr uint32_t kCrc16Poly = 0x8005;

void update_crc(uint32_t data, int length, uint32_t& crc) {
  // common.c:1311-1324 bitwise CRC-16
  uint32_t masking = 1u << length;
  while ((masking >>= 1)) {
    uint32_t carry = crc & 0x8000;
    crc <<= 1;
    if (!carry != !(data & masking)) crc ^= kCrc16Poly;
  }
  crc &= 0xffff;
}

void insert_crc16(std::vector<Element>& si) {
  // ISO 11172-3 Layer III error protection: CRC-16 (init 0xffff,
  // poly 0x8005, per common.c:1251-1324) over header bits 16..31
  // (si entries 4..12) plus the whole side info (entries 13..),
  // emitted as a 16-bit word right after the header.  The reference
  // accounts these 16 bits (musicin.c:723) but never computes the
  // checksum -- l3bitstream.c:312 emits a static 0.  We emit the
  // real value so '-l 3 -e' streams verify.
  uint32_t crc = 0xffff;
  for (size_t i = 4; i < si.size(); ++i)
    update_crc(si[i].value, si[i].length, crc);
  si.insert(si.begin() + 13, {crc, 16});
}

struct Assembler {
  // config
  int version, layer, bitrate_index, sampling_frequency, mode, mode_ext;
  int emphasis, copyright, original, error_protection, private_bits;
  int nch;
  int sfb_s[14];

  BitWriter bw;
  std::deque<SideRecord> queue;
  long bit_count = 0;
  long this_frame_size = 0;
  long bits_remaining = 0;
  // clip-payload weave state, carried ACROSS calls so a long stream
  // can be assembled window by window (streaming stdin): reservoir
  // level and the next frame's main_data_begin back-pointer
  long resv_size = 0;
  int next_mdb = 0;
  // bytes already handed to the caller via mp3bits_drain
  long drained = 0;

  void write_side_record() {
    SideRecord rec = std::move(queue.front());
    queue.pop_front();
    this_frame_size = rec.frame_len;
    long bits = 0;
    for (const auto& e : rec.si) {
      bw.put(e.value, e.length);
      bits += e.length;
    }
    bit_count = bits;
    bits_remaining = this_frame_size - bit_count;
  }

  void write_main_bits(uint32_t val, int n) {
    if (bit_count == this_frame_size) write_side_record();
    if (n == 0) return;
    if (n > bits_remaining) {
      uint32_t extra = (bits_remaining >= 32) ? val : (val >> (n - bits_remaining));
      int first = static_cast<int>(bits_remaining);
      n -= first;
      bw.put(extra, first);
      write_side_record();
      bw.put(val, n);
    } else {
      bw.put(val, n);
    }
    bit_count += n;
    bits_remaining -= n;
  }
};

void emit_pair(std::vector<Element>& el, int table, int x, int y) {
  if (table == 0) return;
  uint32_t signx = x < 0, signy = y < 0;
  if (x < 0) x = -x;
  if (y < 0) y = -y;
  int linbits = HUFF_LINBITS[table];
  if (table > 15) {
    int linx = 0, liny = 0;
    int xc = x, yc = y;
    if (xc > 14) { linx = xc - 15; xc = 15; }
    if (yc > 14) { liny = yc - 15; yc = 15; }
    int idx = xc * 16 + yc;
    uint32_t code = HUFF_CODES[table][idx];
    int cbits = HUFF_HLEN[table][idx];
    uint32_t ext = 0;
    int xbits = 0;
    if (x > 14) { ext |= linx; xbits += linbits; }
    if (x != 0) { ext = (ext << 1) | signx; xbits += 1; }
    if (y > 14) { ext = (ext << linbits) | liny; xbits += linbits; }
    if (y != 0) { ext = (ext << 1) | signy; xbits += 1; }
    if (cbits) el.push_back({code, static_cast<uint16_t>(cbits)});
    if (xbits) el.push_back({ext, static_cast<uint16_t>(xbits)});
  } else {
    int idx = x * 16 + y;
    uint32_t code = HUFF_CODES[table][idx];
    int cbits = HUFF_HLEN[table][idx];
    if (x != 0) { code = (code << 1) | signx; cbits += 1; }
    if (y != 0) { code = (code << 1) | signy; cbits += 1; }
    if (cbits) el.push_back({code, static_cast<uint16_t>(cbits)});
  }
}

long emit_granule_main(std::vector<Element>& el, const GranuleSide& g,
                       const int* sfl, const int* sfs, const int* ix,
                       const int* sfb_s, int gr, const int* scfsi) {
  long bits = 0;
  // scalefactors (l3bitstream.c:195-254)
  static const int SLEN1[16] = {0, 0, 0, 0, 3, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4};
  static const int SLEN2[16] = {0, 1, 2, 3, 0, 1, 2, 3, 1, 2, 3, 1, 2, 3, 2, 3};
  int s1 = SLEN1[g.compress], s2 = SLEN2[g.compress];
  if (g.wsf && g.block_type == 2) {
    for (int sfb = 0; sfb < 6; sfb++)
      for (int w = 0; w < 3; w++) {
        if (s1) el.push_back({(uint32_t)sfs[sfb * 3 + w], (uint16_t)s1});
        bits += s1;
      }
    for (int sfb = 6; sfb < 12; sfb++)
      for (int w = 0; w < 3; w++) {
        if (s2) el.push_back({(uint32_t)sfs[sfb * 3 + w], (uint16_t)s2});
        bits += s2;
      }
  } else {
    static const int GROUPS[4][2] = {{0, 6}, {6, 11}, {11, 16}, {16, 21}};
    for (int band = 0; band < 4; band++) {
      if (gr == 1 && scfsi[band]) continue;
      int sl = band < 2 ? s1 : s2;
      for (int sfb = GROUPS[band][0]; sfb < GROUPS[band][1]; sfb++) {
        if (sl) el.push_back({(uint32_t)sfl[sfb], (uint16_t)sl});
        bits += sl;
      }
    }
  }

  // big values (l3bitstream.c:516-716)
  size_t start_idx = el.size();
  long data_bits = 0;
  auto count_from = [&](size_t from) {
    long b = 0;
    for (size_t i = from; i < el.size(); i++) b += el[i].length;
    return b;
  };
  int bigvalues = g.big_values * 2;
  if (bigvalues) {
    if (g.wsf && g.block_type == 2 && !g.mixed) {
      for (int sfb = 0; sfb < 13; sfb++) {
        int s = sfb_s[sfb], e = sfb_s[sfb + 1];
        int t = (s < 12) ? g.ts[0] : g.ts[1];
        for (int w = 0; w < 3; w++)
          for (int line = s; line < e; line += 2)
            emit_pair(el, t, ix[3 * line + w], ix[3 * (line + 1) + w]);
      }
    } else {
      int r1s = g.a1, r2s = g.a2;
      for (int i = 0; i < bigvalues; i += 2) {
        int t = (i < r1s) ? g.ts[0] : (i < r2s ? g.ts[1] : g.ts[2]);
        emit_pair(el, t, ix[i], ix[i + 1]);
      }
    }
  }
  // count1 quads
  {
    int table = 32 + g.c1ts;
    int end = bigvalues + g.count1 * 4;
    for (int i = bigvalues; i < end; i += 4) {
      int v[4] = {ix[i], ix[i + 1], ix[i + 2], ix[i + 3]};
      int a[4], sg[4];
      for (int k = 0; k < 4; k++) {
        sg[k] = v[k] < 0;
        a[k] = v[k] < 0 ? -v[k] : v[k];
      }
      // conformant quad index (v<<3)|(w<<2)|(x<<1)|y -- first
      // sample at the MSB, like every live emission path.  dist10
      // reversed this (l3bitstream.c:740) and its quads decode
      // sample-swapped in conforming decoders; see
      // tests/test_conformance.py.
      int p = (a[0] << 3) + (a[1] << 2) + (a[2] << 1) + a[3];
      el.push_back({HUFF_CODES[table][p], HUFF_HLEN[table][p]});
      for (int k = 0; k < 4; k++)
        if (a[k]) el.push_back({(uint32_t)sg[k], 1});
    }
  }
  data_bits = count_from(start_idx);
  // ones-stuffing to part2_3_length
  long stuffing = (long)g.p23 - (long)g.part2 - data_bits;
  while (stuffing >= 32) {
    el.push_back({0xFFFFFFFFu, 32});
    stuffing -= 32;
  }
  if (stuffing > 0) el.push_back({(1u << stuffing) - 1, (uint16_t)stuffing});
  return 0;
}

// One frame of side-info + main-data emission.  Row pointers are
// granule-major (gr*nch + ch); side rows are 19 ints (see
// mp3bits_frame's comment).  Returns nextBackPtr.
int add_frame(Assembler* a, int bits_per_frame, int padding,
              int main_data_begin, const int* scfsi,
              const int* const* side_rows, const int* const* sfl_rows,
              const int* const* sfs_rows, const int* const* ix_rows,
              int resv_drain) {
  int nch = a->nch;
  SideRecord rec;
  rec.frame_len = bits_per_frame;
  auto& si = rec.si;
  // header (l3bitstream.c:322-334)
  si.push_back({0xFFF, 12});
  si.push_back({(uint32_t)a->version, 1});
  si.push_back({(uint32_t)(4 - a->layer), 2});
  si.push_back({(uint32_t)(a->error_protection ? 0 : 1), 1});
  si.push_back({(uint32_t)a->bitrate_index, 4});
  si.push_back({(uint32_t)a->sampling_frequency, 2});
  si.push_back({(uint32_t)padding, 1});
  si.push_back({0, 1});
  si.push_back({(uint32_t)a->mode, 2});
  si.push_back({(uint32_t)a->mode_ext, 2});
  si.push_back({(uint32_t)a->copyright, 1});
  si.push_back({(uint32_t)a->original, 1});
  si.push_back({(uint32_t)a->emphasis, 2});
  // side info (MPEG-1)
  si.push_back({(uint32_t)main_data_begin, 9});
  si.push_back({(uint32_t)a->private_bits, (uint16_t)(nch == 2 ? 3 : 5)});
  for (int ch = 0; ch < nch; ch++)
    for (int b = 0; b < 4; b++) si.push_back({(uint32_t)scfsi[ch * 4 + b], 1});
  for (int g = 0; g < 2 * nch; g++) {
    const int* s = side_rows[g];
    GranuleSide gs{s[0], s[1], s[2], s[3], s[4], s[5], s[6],
                   {s[7], s[8], s[9]}, s[10], s[11], s[12], s[13], s[14],
                   s[15], s[16], s[17], s[18]};
    si.push_back({(uint32_t)gs.p23, 12});
    si.push_back({(uint32_t)gs.big_values, 9});
    si.push_back({(uint32_t)gs.global_gain, 8});
    si.push_back({(uint32_t)gs.compress, 4});
    si.push_back({(uint32_t)gs.wsf, 1});
    if (gs.wsf) {
      si.push_back({(uint32_t)gs.block_type, 2});
      si.push_back({(uint32_t)gs.mixed, 1});
      si.push_back({(uint32_t)gs.ts[0], 5});
      si.push_back({(uint32_t)gs.ts[1], 5});
      si.push_back({0, 3});
      si.push_back({0, 3});
      si.push_back({0, 3});
    } else {
      si.push_back({(uint32_t)gs.ts[0], 5});
      si.push_back({(uint32_t)gs.ts[1], 5});
      si.push_back({(uint32_t)gs.ts[2], 5});
      si.push_back({(uint32_t)gs.r0, 4});
      si.push_back({(uint32_t)gs.r1, 3});
    }
    si.push_back({(uint32_t)gs.preflag, 1});
    si.push_back({(uint32_t)gs.scalefac_scale, 1});
    si.push_back({(uint32_t)gs.c1ts, 1});
  }
  if (a->error_protection) insert_crc16(si);
  long si_bits = 0;
  for (auto& e : si) si_bits += e.length;
  rec.si_bits = static_cast<int>(si_bits);
  a->queue.push_back(std::move(rec));

  // main data elements
  std::vector<Element> main;
  main.reserve(2048);
  for (int g = 0; g < 2 * nch; g++) {
    const int* s = side_rows[g];
    GranuleSide gs{s[0], s[1], s[2], s[3], s[4], s[5], s[6],
                   {s[7], s[8], s[9]}, s[10], s[11], s[12], s[13], s[14],
                   s[15], s[16], s[17], s[18]};
    int gr = g / nch, ch = g % nch;
    emit_granule_main(main, gs, sfl_rows[g], sfs_rows[g], ix_rows[g],
                      a->sfb_s, gr, scfsi + 4 * ch);
  }
  long drain = resv_drain;
  while (drain >= 32) {
    main.push_back({0, 32});
    drain -= 32;
  }
  if (drain > 0) main.push_back({0, (uint16_t)drain});

  for (const auto& e : main) a->write_main_bits(e.value, e.length);

  // nextBackPtr (formatBitstream.c:77-80)
  long fwd_frame = 0, fwd_si = 0;
  for (const auto& r : a->queue) {
    fwd_frame += r.frame_len;
    fwd_si += r.si_bits;
  }
  return static_cast<int>(a->bits_remaining / 8 + fwd_frame / 8 - fwd_si / 8);
}

}  // namespace

extern "C" {

void* mp3bits_create(int version, int layer, int bitrate_index,
                     int sampling_frequency, int mode, int mode_ext,
                     int emphasis, int copyright, int original,
                     int error_protection, int private_bits,
                     const int* sfb_short_table) {
  auto* a = new Assembler();
  a->version = version;
  a->layer = layer;
  a->bitrate_index = bitrate_index;
  a->sampling_frequency = sampling_frequency;
  a->mode = mode;
  a->mode_ext = mode_ext;
  a->emphasis = emphasis;
  a->copyright = copyright;
  a->original = original;
  a->error_protection = error_protection;
  a->private_bits = private_bits;
  a->nch = (mode == 3) ? 1 : 2;
  memcpy(a->sfb_s, sfb_short_table, 14 * sizeof(int));
  return a;
}

// side: ngr*nch records of 19 ints (order gr-major):
//   p23 bv gg compress wsf bt mixed ts0 ts1 ts2 r0 r1 preflag ss c1ts
//   part2 a1 a2 count1
int mp3bits_frame(void* h, int bits_per_frame, int padding, int main_data_begin,
                  const int* scfsi, const int* side, const int* sfl,
                  const int* sfs, const int* ix, int resv_drain) {
  auto* a = static_cast<Assembler*>(h);
  const int* side_rows[4];
  const int* sfl_rows[4];
  const int* sfs_rows[4];
  const int* ix_rows[4];
  for (int g = 0; g < 2 * a->nch; g++) {
    side_rows[g] = side + 19 * g;
    sfl_rows[g] = sfl + 22 * g;
    sfs_rows[g] = sfs + 39 * g;
    ix_rows[g] = ix + 576 * g;
  }
  return add_frame(a, bits_per_frame, padding, main_data_begin, scfsi,
                   side_rows, sfl_rows, sfs_rows, ix_rows, resv_drain);
}

// Whole-clip assembly from DEVICE-PACKED payloads: the device emits each
// granule's main_data (scalefactors + Huffman codewords) as an
// MSB-first u32 word row (ops/jaxbits.py); this weave only writes
// headers + side info and splices the payload bits, plus the exact
// reservoir frame-end accounting (reservoir.c:155-226).  DELIBERATE
// deviation from the reference: ALL stuffing goes to the ancillary
// drain (zero bits after the granule data) instead of inflating
// granule part2_3_lengths.  The reference pads granule 0 with
// 1-bits (l3bitstream.c:695-710), which every decoder then parses
// as extra count1 quads: harmless zeros under quad table A, but
// under table B they decode as +/-1 values scaled by 2^((gg-210)/4)
// -- audible spikes -- and their sign bits overrun part2_3_length
// (mpg123 "dequantization failed").  Ancillary stuffing has the
// exact same reservoir/back-pointer arithmetic and is always safe.
// payload: (nch, G, words_per_row) u32 rows, channel-major like side;
// each granule's bit length is its part2_3_length (side[...][0]).
// row_offsets (nullable): device-compacted FLAT payload -- granule
// (ch, g)'s words start at payload + row_offsets[ch*G + g] (offsets
// derived host-side from the same part2_3_lengths the device used,
// see ops/jaxbits.compact_payload).
static void encode_clip_payload_impl(void* h, long nframes,
                                     int bits_per_frame, long mean_bits,
                                     long resv_max, const int* scfsi,
                                     const int* side,
                                     const uint32_t* payload,
                                     int words_per_row,
                                     const long* row_offsets) {
  auto* a = static_cast<Assembler*>(h);
  int nch = a->nch;
  // MPEG-2 LSF (version 0): one granule per frame, 8-bit back-pointer,
  // 1/2 private bits, no scfsi, 9-bit scalefac_compress, no preflag
  // bit (implied by the compress range; IS 13818-3 2.4.1.7)
  int mode_gr = a->version == 1 ? 2 : 1;
  long G = mode_gr * nframes;
  // carried across calls: a stream can be assembled window by window
  long size = a->resv_size;
  int main_data_begin = a->next_mdb;
  for (long f = 0; f < nframes; ++f) {
    int frame_p23[2][2];
    for (int gr = 0; gr < mode_gr; ++gr)
      for (int ch = 0; ch < nch; ++ch) {
        long g = mode_gr * f + gr;
        int p23 = side[(ch * G + g) * 19];
        frame_p23[gr][ch] = p23;
        size += mean_bits / nch - p23;
      }
    if (nch == 2 && (mean_bits & 1)) size += 1;
    long over = size - resv_max;
    if (over < 0) over = 0;
    size -= over;
    long stuffing = over;
    long align = size % 8;
    if (align) {
      stuffing += align;
      size -= align;
    }

    // side-info record (identical field layout to add_frame)
    SideRecord rec;
    rec.frame_len = bits_per_frame;
    auto& si = rec.si;
    si.push_back({0xFFF, 12});
    si.push_back({(uint32_t)a->version, 1});
    si.push_back({(uint32_t)(4 - a->layer), 2});
    si.push_back({(uint32_t)(a->error_protection ? 0 : 1), 1});
    si.push_back({(uint32_t)a->bitrate_index, 4});
    si.push_back({(uint32_t)a->sampling_frequency, 2});
    si.push_back({0, 1});
    si.push_back({0, 1});
    si.push_back({(uint32_t)a->mode, 2});
    si.push_back({(uint32_t)a->mode_ext, 2});
    si.push_back({(uint32_t)a->copyright, 1});
    si.push_back({(uint32_t)a->original, 1});
    si.push_back({(uint32_t)a->emphasis, 2});
    if (mode_gr == 2) {
      si.push_back({(uint32_t)main_data_begin, 9});
      si.push_back({(uint32_t)a->private_bits, (uint16_t)(nch == 2 ? 3 : 5)});
      // scfsi is per FRAME: (nframes, nch, 4) layout
      for (int ch = 0; ch < nch; ch++)
        for (int b = 0; b < 4; b++)
          si.push_back({(uint32_t)scfsi[(f * nch + ch) * 4 + b], 1});
    } else {
      si.push_back({(uint32_t)main_data_begin, 8});
      si.push_back({(uint32_t)a->private_bits, (uint16_t)(nch == 2 ? 2 : 1)});
    }
    for (int gr = 0; gr < mode_gr; ++gr)
      for (int ch = 0; ch < nch; ++ch) {
        long g = mode_gr * f + gr;
        const int* s = side + (ch * G + g) * 19;
        GranuleSide gs{frame_p23[gr][ch], s[1], s[2], s[3], s[4], s[5],
                       s[6], {s[7], s[8], s[9]}, s[10], s[11], s[12],
                       s[13], s[14], s[15], s[16], s[17], s[18]};
        si.push_back({(uint32_t)gs.p23, 12});
        si.push_back({(uint32_t)gs.big_values, 9});
        si.push_back({(uint32_t)gs.global_gain, 8});
        si.push_back({(uint32_t)gs.compress,
                      (uint16_t)(mode_gr == 2 ? 4 : 9)});
        si.push_back({(uint32_t)gs.wsf, 1});
        if (gs.wsf) {
          si.push_back({(uint32_t)gs.block_type, 2});
          si.push_back({(uint32_t)gs.mixed, 1});
          si.push_back({(uint32_t)gs.ts[0], 5});
          si.push_back({(uint32_t)gs.ts[1], 5});
          si.push_back({0, 3});
          si.push_back({0, 3});
          si.push_back({0, 3});
        } else {
          si.push_back({(uint32_t)gs.ts[0], 5});
          si.push_back({(uint32_t)gs.ts[1], 5});
          si.push_back({(uint32_t)gs.ts[2], 5});
          si.push_back({(uint32_t)gs.r0, 4});
          si.push_back({(uint32_t)gs.r1, 3});
        }
        if (mode_gr == 2) si.push_back({(uint32_t)gs.preflag, 1});
        si.push_back({(uint32_t)gs.scalefac_scale, 1});
        si.push_back({(uint32_t)gs.c1ts, 1});
      }
    if (a->error_protection) insert_crc16(si);
    long si_bits = 0;
    for (auto& e : si) si_bits += e.length;
    rec.si_bits = static_cast<int>(si_bits);
    a->queue.push_back(std::move(rec));

    // main data: splice each granule's pre-packed payload bits
    for (int gr = 0; gr < mode_gr; ++gr)
      for (int ch = 0; ch < nch; ++ch) {
        long g = mode_gr * f + gr;
        const uint32_t* row =
            row_offsets ? payload + row_offsets[ch * G + g]
                        : payload + (ch * G + g) * words_per_row;
        long bits = frame_p23[gr][ch];
        long w = 0;
        while (bits >= 32) {
          a->write_main_bits(row[w++], 32);
          bits -= 32;
        }
        if (bits > 0)
          a->write_main_bits(row[w] >> (32 - bits), static_cast<int>(bits));
      }
    long drain = stuffing;
    while (drain >= 32) {
      a->write_main_bits(0, 32);
      drain -= 32;
    }
    if (drain > 0) a->write_main_bits(0, static_cast<int>(drain));

    long fwd_frame = 0, fwd_si = 0;
    for (const auto& r : a->queue) {
      fwd_frame += r.frame_len;
      fwd_si += r.si_bits;
    }
    main_data_begin =
        static_cast<int>(a->bits_remaining / 8 + fwd_frame / 8 - fwd_si / 8);
  }
  a->resv_size = size;
  a->next_mdb = main_data_begin;
}

void mp3bits_encode_clip_payload(void* h, long nframes, int bits_per_frame,
                                 long mean_bits, long resv_max,
                                 const int* scfsi, const int* side,
                                 const uint32_t* payload,
                                 int words_per_row) {
  encode_clip_payload_impl(h, nframes, bits_per_frame, mean_bits, resv_max,
                           scfsi, side, payload, words_per_row, nullptr);
}

void mp3bits_encode_clip_payload_flat(void* h, long nframes,
                                      int bits_per_frame, long mean_bits,
                                      long resv_max, const int* scfsi,
                                      const int* side,
                                      const uint32_t* payload,
                                      const long* row_offsets) {
  encode_clip_payload_impl(h, nframes, bits_per_frame, mean_bits, resv_max,
                           scfsi, side, payload, 0, row_offsets);
}

// Streaming drain: hand the caller every byte written so far and FREE
// them, so a long stream's memory stays bounded by one window.  Bytes
// in the buffer are final (bits are written MSB-first, never
// rewritten).  `out` must have room for mp3bits_pending(h) bytes.
extern "C" long mp3bits_pending(void* h) {
  return static_cast<long>(static_cast<Assembler*>(h)->bw.buf.size());
}

// ---- checkpoint/resume: serialize the weave state so a long encode
// can resume at a window boundary with the identical output stream
// (SURVEY.md section 5.4 -- the reference has nothing; CBR determinism
// makes this a small tuple: reservoir level, back-pointer, bit-writer
// phase, pending bytes, and the queued side records).
static void put_i64(std::vector<uint8_t>& v, int64_t x) {
  for (int i = 0; i < 8; ++i) v.push_back((x >> (8 * i)) & 0xFF);
}
static int64_t get_i64(const unsigned char*& p) {
  int64_t x = 0;
  for (int i = 0; i < 8; ++i) x |= (int64_t)p[i] << (8 * i);
  p += 8;
  return x;
}

static std::vector<uint8_t> ckpt_bytes(const Assembler* a) {
  std::vector<uint8_t> v;
  put_i64(v, a->resv_size);
  put_i64(v, a->next_mdb);
  put_i64(v, a->bit_count);
  put_i64(v, a->this_frame_size);
  put_i64(v, a->bits_remaining);
  put_i64(v, a->drained);
  put_i64(v, (int64_t)a->bw.acc);
  put_i64(v, a->bw.nbits);
  put_i64(v, (int64_t)a->bw.buf.size());
  v.insert(v.end(), a->bw.buf.begin(), a->bw.buf.end());
  put_i64(v, (int64_t)a->queue.size());
  for (const auto& r : a->queue) {
    put_i64(v, r.frame_len);
    put_i64(v, r.si_bits);
    put_i64(v, (int64_t)r.si.size());
    for (const auto& e : r.si) {
      put_i64(v, e.value);
      put_i64(v, e.length);
    }
  }
  return v;
}

extern "C" long mp3bits_ckpt_size(void* h) {
  return (long)ckpt_bytes(static_cast<Assembler*>(h)).size();
}

extern "C" void mp3bits_ckpt_save(void* h, unsigned char* out) {
  auto v = ckpt_bytes(static_cast<Assembler*>(h));
  memcpy(out, v.data(), v.size());
}

extern "C" void mp3bits_ckpt_load(void* h, const unsigned char* in) {
  auto* a = static_cast<Assembler*>(h);
  const unsigned char* p = in;
  a->resv_size = get_i64(p);
  a->next_mdb = (int)get_i64(p);
  a->bit_count = get_i64(p);
  a->this_frame_size = get_i64(p);
  a->bits_remaining = get_i64(p);
  a->drained = get_i64(p);
  a->bw.acc = (uint64_t)get_i64(p);
  a->bw.nbits = (int)get_i64(p);
  long nbuf = get_i64(p);
  a->bw.buf.assign(p, p + nbuf);
  p += nbuf;
  long nq = get_i64(p);
  a->queue.clear();
  for (long i = 0; i < nq; ++i) {
    SideRecord r;
    r.frame_len = (int)get_i64(p);
    r.si_bits = (int)get_i64(p);
    long ne = get_i64(p);
    for (long j = 0; j < ne; ++j) {
      Element e;
      e.value = (uint32_t)get_i64(p);
      e.length = (uint16_t)get_i64(p);
      r.si.push_back(e);
    }
    a->queue.push_back(std::move(r));
  }
}

extern "C" long mp3bits_drain(void* h, unsigned char* out) {
  auto* a = static_cast<Assembler*>(h);
  long avail = static_cast<long>(a->bw.buf.size());
  if (avail <= 0) return 0;
  if (out) memcpy(out, a->bw.buf.data(), avail);
  a->bw.buf.erase(a->bw.buf.begin(), a->bw.buf.end());
  a->drained += avail;
  return avail;
}

long mp3bits_finish(void* h) {
  auto* a = static_cast<Assembler*>(h);
  long fwd_frame = 0, fwd_si = 0;
  for (const auto& r : a->queue) {
    fwd_frame += r.frame_len;
    fwd_si += r.si_bits;
  }
  // zero-fill the IN-PROGRESS frame's remaining main-data region plus
  // every queued frame, so the stream ends exactly on the CBR grid
  // (nframes * frame_size bytes; III_FlushBitstream semantics,
  // l3bitstream.c:165-173) -- a decoder sees all frames complete.
  long remaining = a->bits_remaining + fwd_frame - fwd_si;
  while (remaining >= 32) {
    a->write_main_bits(0, 32);
    remaining -= 32;
  }
  if (remaining > 0) a->write_main_bits(0, static_cast<int>(remaining));
  // trailing in-progress byte like close_bit_stream_w (common.c:968-972)
  a->bw.buf.push_back(0);
  return static_cast<long>(a->bw.buf.size());
}

void mp3bits_copy(void* h, unsigned char* out) {
  auto* a = static_cast<Assembler*>(h);
  memcpy(out, a->bw.buf.data(), a->bw.buf.size());
}

void mp3bits_free(void* h) { delete static_cast<Assembler*>(h); }

// Generic MSB-first (value, nbits) element-stream packer used by the
// Layer I/II fast path (the whole frame sequence is marshalled as one
// flat element array).  Returns the number of bytes written; `out`
// must have room for (sum(lengths) + 7) / 8 bytes.  Trailing partial
// bits are zero-padded (Layer I/II frames are byte-aligned anyway,
// and the reference appends a zero flush byte which callers add).
long mp3bits_pack(const uint32_t* values, const int32_t* lengths,
                  long n, unsigned char* out) {
  uint64_t acc = 0;
  int nbits = 0;
  long pos = 0;
  for (long i = 0; i < n; ++i) {
    int len = lengths[i];
    if (len == 0) continue;
    acc = (acc << len) |
          (values[i] & ((len >= 32) ? 0xFFFFFFFFu : ((1u << len) - 1)));
    nbits += len;
    while (nbits >= 8) {
      nbits -= 8;
      out[pos++] = static_cast<unsigned char>((acc >> nbits) & 0xFF);
    }
    acc &= (1ull << nbits) - 1;
  }
  if (nbits > 0) {
    out[pos++] = static_cast<unsigned char>((acc << (8 - nbits)) & 0xFF);
  }
  return pos;
}

}  // extern "C"

// Layer III reservoir budget scan (reservoir.c:101-134 policy) over a
// whole clip: per-granule max_bits from pe, with usage prediction (see
// mp3tpu/encoder.py scan_budgets).  Layout: granule-major arrays of
// shape (nframes, 2, nch) flattened.  mode: 0 = first scan (usage =
// min(demand, b)), 1 = relax scan (usage from p23/last_target).
// delta (mode 0 only): predicted usage of a reservoir-CONSTRAINED
// granule is budget - delta instead of budget.  The rate loop's
// realized usage runs a few bits under its grant (bits(stepsize) is
// quantized); without compensation that slack pools in the reservoir
// and recovering it costs a full relax re-encode.  delta folds the
// expected slack into the first scan.  Feasibility: actual usage may
// exceed the prediction by at most delta per granule, so the scan's
// reservoir estimate can run ahead of the real one -- the guard scan
// still validates the realized p23 and the encoder re-clamps on the
// rare overdraw.
extern "C" void mp3resv_scan(const double* pe, const long* demand,
                             const long* p23, const long* last_target,
                             long* budgets, long nframes, int nch,
                             long mean_bits, long resv_max, int mode,
                             int mode_gr, long delta, long* size_io) {
  // size_io: carried reservoir level (streaming windows); the scan is
  // CAUSAL, so windowed scans with the carried level reproduce the
  // whole-clip scan exactly.  NULL = fresh stream.
  long size = size_io ? *size_io : 0;
  long idx = 0;
  for (long f = 0; f < nframes; ++f) {
    for (int gr = 0; gr < mode_gr; ++gr) {
      for (int ch = 0; ch < nch; ++ch, ++idx) {
        // ResvMaxBits (reservoir.c:101-134), matching
        // mp3tpu/numpy_ref/reservoir.py::max_bits exactly
        long mean = mean_bits / nch;
        long max_bits = mean < 4095 ? mean : 4095;
        long b;
        if (resv_max == 0) {
          b = max_bits;
        } else {
          long more_bits = (long)(pe[idx] * 3.1 - (double)mean);
          long add_bits = 0;
          if (more_bits > 100) {
            long frac = (size * 6) / 10;
            add_bits = frac < more_bits ? frac : more_bits;
          }
          long over_bits = size - (resv_max * 8) / 10 - add_bits;
          if (over_bits > 0) add_bits += over_bits;
          b = max_bits + add_bits;
          if (b > 4095) b = 4095;
        }
        budgets[idx] = b;
        long used;
        if (mode == 0) {
          used = demand[idx] < b ? demand[idx] : b - delta;
          if (used < 0) used = 0;
        } else {
          // relax mode: predict usage = the granule's NEW target,
          // except where the target is unchanged (there the realized
          // p23 is known exactly).  Actual usage can never exceed the
          // target, so budgets from this scan are feasible for any
          // re-encode -- the guard can never flag after a relax pass.
          long tgt = demand[idx] < b ? demand[idx] : b;
          if (tgt > 4095) tgt = 4095;
          if (tgt <= last_target[idx]) {
            used = p23[idx] < tgt ? p23[idx] : tgt;
          } else {
            used = tgt;
          }
        }
        size += mean - used;
      }
    }
    if (nch == 2 && (mean_bits & 1)) size += 1;
    if (size > resv_max) size = resv_max;
    size -= size % 8;
  }
  if (size_io) *size_io = size;
}

// validation guard scan: per-granule feasibility limits given actual
// usage (mp3tpu/encoder.py guard loop).  Returns 1 if any violation.
// size_io: carried reservoir level for streaming windows (NULL = 0).
extern "C" int mp3resv_guard(const long* p23, long* limits, long nframes,
                             int nch, long mean_bits, long resv_max,
                             int mode_gr, long* size_io) {
  long size = size_io ? *size_io : 0;
  long idx = 0;
  int bad = 0;
  for (long f = 0; f < nframes; ++f) {
    for (int gr = 0; gr < mode_gr; ++gr) {
      for (int ch = 0; ch < nch; ++ch, ++idx) {
        long mean = mean_bits / nch;
        long limit = mean + size;
        if (limit > 4095) limit = 4095;
        limits[idx] = limit;
        if (p23[idx] > limit) {
          bad = 1;
          size += mean - limit;
        } else {
          size += mean - p23[idx];
        }
      }
    }
    if (nch == 2 && (mean_bits & 1)) size += 1;
    if (size > resv_max) size = resv_max;
    size -= size % 8;
  }
  if (size_io) *size_io = size;
  return bad;
}
