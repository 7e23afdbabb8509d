// Native FLAC codec of dsptoolbox_tpu_torch: a copy of the JAX package's
// `dsptoolbox_tpu/native/flac_decoder.cpp`, kept in the port so that the
// port builds and loads nothing of the JAX package. Host code: built with
// g++ at first use and bound through ctypes (`dsptoolbox_tpu_torch/io/
// flac.py`). The reference reads FLAC through libsndfile (`soundfile`),
// which is not a dependency here.
//
// Scope: full FLAC subset used by encoders in practice — constant,
// verbatim, fixed (order 0-4) and LPC subframes, 4/5-bit Rice partitions
// with escape codes, independent / left-side / right-side / mid-side
// channel assignments, 8/12/16/20/24-bit samples, UTF-8 coded frame
// headers. CRCs are not verified (decode-only path).
//
// API (extern "C"):
//   flac_probe(data, size, &total_samples, &channels, &sample_rate, &bps)
//   flac_decode(data, size, out_int32 /* interleaved, total*channels */)
// Both return 0 on success, negative error codes otherwise.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct BitReader {
    const uint8_t* data;
    size_t size;
    size_t byte_pos = 0;
    int bit_pos = 0;  // 0..7, MSB first
    bool overflow = false;

    explicit BitReader(const uint8_t* d, size_t s) : data(d), size(s) {}

    inline uint32_t read_bit() {
        if (byte_pos >= size) {
            overflow = true;
            return 0;
        }
        uint32_t b = (data[byte_pos] >> (7 - bit_pos)) & 1u;
        if (++bit_pos == 8) {
            bit_pos = 0;
            ++byte_pos;
        }
        return b;
    }

    inline uint64_t read_bits(int n) {
        uint64_t v = 0;
        // fast path: byte-aligned whole bytes
        while (n >= 8 && bit_pos == 0 && byte_pos < size) {
            v = (v << 8) | data[byte_pos++];
            n -= 8;
        }
        for (int i = 0; i < n; ++i) v = (v << 1) | read_bit();
        return v;
    }

    inline int64_t read_signed(int n) {
        uint64_t v = read_bits(n);
        uint64_t sign = 1ull << (n - 1);
        return (v & sign) ? (int64_t)(v | ~((sign << 1) - 1)) : (int64_t)v;
    }

    inline uint32_t read_unary() {
        uint32_t q = 0;
        while (!overflow && read_bit() == 0) ++q;
        return q;
    }

    inline void align() {
        if (bit_pos) {
            bit_pos = 0;
            ++byte_pos;
        }
    }
};

struct StreamInfo {
    uint32_t sample_rate = 0;
    uint32_t channels = 0;
    uint32_t bps = 0;
    uint64_t total_samples = 0;
    size_t audio_offset = 0;  // first frame byte
};

int parse_streaminfo(const uint8_t* data, size_t size, StreamInfo* si) {
    if (size < 4 || std::memcmp(data, "fLaC", 4) != 0) return -1;
    size_t pos = 4;
    bool last = false;
    bool have_si = false;
    while (!last) {
        if (pos + 4 > size) return -2;
        last = (data[pos] & 0x80u) != 0;
        uint32_t type = data[pos] & 0x7Fu;
        uint32_t len = ((uint32_t)data[pos + 1] << 16) |
                       ((uint32_t)data[pos + 2] << 8) | data[pos + 3];
        pos += 4;
        if (pos + len > size) return -2;
        if (type == 0) {  // STREAMINFO
            if (len < 34) return -3;
            const uint8_t* p = data + pos;
            si->sample_rate = ((uint32_t)p[10] << 12) |
                              ((uint32_t)p[11] << 4) | (p[12] >> 4);
            si->channels = ((p[12] >> 1) & 0x7u) + 1;
            si->bps = (((p[12] & 1u) << 4) | (p[13] >> 4)) + 1;
            si->total_samples = ((uint64_t)(p[13] & 0x0Fu) << 32) |
                                ((uint64_t)p[14] << 24) |
                                ((uint64_t)p[15] << 16) |
                                ((uint64_t)p[16] << 8) | p[17];
            have_si = true;
        }
        pos += len;
    }
    if (!have_si) return -3;
    si->audio_offset = pos;
    return 0;
}

// skip the UTF-8-style coded frame/sample number
bool skip_utf8(BitReader& br) {
    uint32_t first = (uint32_t)br.read_bits(8);
    int extra = 0;
    if (first < 0x80) extra = 0;
    else if ((first & 0xE0u) == 0xC0u) extra = 1;
    else if ((first & 0xF0u) == 0xE0u) extra = 2;
    else if ((first & 0xF8u) == 0xF0u) extra = 3;
    else if ((first & 0xFCu) == 0xF8u) extra = 4;
    else if ((first & 0xFEu) == 0xFCu) extra = 5;
    else if (first == 0xFEu) extra = 6;
    else return false;
    for (int i = 0; i < extra; ++i) br.read_bits(8);
    return true;
}

bool decode_residual(BitReader& br, int order, uint32_t block_size,
                     int64_t* out /* block_size entries, first `order`
                                     already filled */) {
    uint32_t method = (uint32_t)br.read_bits(2);
    if (method > 1) return false;
    int param_bits = method == 0 ? 4 : 5;
    uint32_t escape = method == 0 ? 0xF : 0x1F;
    uint32_t part_order = (uint32_t)br.read_bits(4);
    uint32_t n_part = 1u << part_order;
    uint32_t idx = order;
    for (uint32_t p = 0; p < n_part; ++p) {
        uint32_t count = (block_size >> part_order) - (p == 0 ? order : 0);
        uint32_t param = (uint32_t)br.read_bits(param_bits);
        if (param == escape) {
            uint32_t raw_bits = (uint32_t)br.read_bits(5);
            for (uint32_t i = 0; i < count; ++i)
                out[idx++] = raw_bits ? br.read_signed(raw_bits) : 0;
        } else {
            for (uint32_t i = 0; i < count; ++i) {
                uint32_t q = br.read_unary();
                uint64_t r = br.read_bits(param);
                uint64_t v = ((uint64_t)q << param) | r;
                out[idx++] = (v & 1) ? -(int64_t)(v >> 1) - 1
                                     : (int64_t)(v >> 1);
            }
        }
        if (br.overflow) return false;
    }
    return idx == block_size;
}

const int FIXED_COEFFS[5][4] = {
    {},
    {1},
    {2, -1},
    {3, -3, 1},
    {4, -6, 4, -1},
};

bool decode_subframe(BitReader& br, uint32_t block_size, int bps,
                     std::vector<int64_t>& out) {
    out.assign(block_size, 0);
    if (br.read_bit() != 0) return false;  // zero padding bit
    uint32_t type = (uint32_t)br.read_bits(6);
    int wasted = 0;
    if (br.read_bit()) wasted = 1 + (int)br.read_unary();
    bps -= wasted;

    if (type == 0) {  // CONSTANT
        int64_t v = br.read_signed(bps);
        for (uint32_t i = 0; i < block_size; ++i) out[i] = v;
    } else if (type == 1) {  // VERBATIM
        for (uint32_t i = 0; i < block_size; ++i)
            out[i] = br.read_signed(bps);
    } else if (type >= 8 && type <= 12) {  // FIXED, order 0-4
        int order = (int)type - 8;
        for (int i = 0; i < order; ++i) out[i] = br.read_signed(bps);
        if (!decode_residual(br, order, block_size, out.data()))
            return false;
        for (uint32_t i = order; i < block_size; ++i) {
            int64_t pred = 0;
            for (int j = 0; j < order; ++j)
                pred += (int64_t)FIXED_COEFFS[order][j] * out[i - 1 - j];
            out[i] += pred;
        }
    } else if (type >= 32) {  // LPC, order = type - 31
        int order = (int)type - 31;
        for (int i = 0; i < order; ++i) out[i] = br.read_signed(bps);
        int precision = (int)br.read_bits(4) + 1;
        if (precision == 16) return false;  // 0b1111 is invalid
        int shift = (int)br.read_signed(5);
        if (shift < 0) return false;
        int32_t coeffs[32];
        for (int i = 0; i < order; ++i)
            coeffs[i] = (int32_t)br.read_signed(precision);
        if (!decode_residual(br, order, block_size, out.data()))
            return false;
        for (uint32_t i = order; i < block_size; ++i) {
            int64_t pred = 0;
            for (int j = 0; j < order; ++j)
                pred += (int64_t)coeffs[j] * out[i - 1 - j];
            out[i] += pred >> shift;
        }
    } else {
        return false;  // reserved
    }
    if (wasted)
        for (uint32_t i = 0; i < block_size; ++i) out[i] <<= wasted;
    return !br.overflow;
}

}  // namespace

extern "C" {

int flac_probe(const uint8_t* data, size_t size, uint64_t* total_samples,
               uint32_t* channels, uint32_t* sample_rate, uint32_t* bps) {
    StreamInfo si;
    int rc = parse_streaminfo(data, size, &si);
    if (rc != 0) return rc;
    *total_samples = si.total_samples;
    *channels = si.channels;
    *sample_rate = si.sample_rate;
    *bps = si.bps;
    return 0;
}

int flac_decode(const uint8_t* data, size_t size, int32_t* out) {
    StreamInfo si;
    int rc = parse_streaminfo(data, size, &si);
    if (rc != 0) return rc;

    BitReader br(data + si.audio_offset, size - si.audio_offset);
    uint64_t written = 0;
    std::vector<std::vector<int64_t>> chan(si.channels);

    while (written < si.total_samples) {
        br.align();
        if (br.byte_pos >= br.size) break;
        // frame sync: 14 bits 0b11111111111110
        uint32_t sync = (uint32_t)br.read_bits(14);
        if (br.overflow) break;
        if (sync != 0x3FFE) return -10;
        br.read_bit();  // reserved
        br.read_bit();  // blocking strategy
        uint32_t bs_code = (uint32_t)br.read_bits(4);
        uint32_t sr_code = (uint32_t)br.read_bits(4);
        uint32_t ch_code = (uint32_t)br.read_bits(4);
        uint32_t ss_code = (uint32_t)br.read_bits(3);
        br.read_bit();  // reserved
        if (!skip_utf8(br)) return -11;

        uint32_t block_size;
        switch (bs_code) {
            case 1: block_size = 192; break;
            case 2: case 3: case 4: case 5:
                block_size = 576u << (bs_code - 2); break;
            case 6: block_size = (uint32_t)br.read_bits(8) + 1; break;
            case 7: block_size = (uint32_t)br.read_bits(16) + 1; break;
            default:
                if (bs_code >= 8)
                    block_size = 256u << (bs_code - 8);
                else
                    return -12;
        }
        if (sr_code == 12) br.read_bits(8);
        else if (sr_code == 13 || sr_code == 14) br.read_bits(16);

        int bps = (int)si.bps;
        switch (ss_code) {  // per-frame sample size override
            case 0: break;
            case 1: bps = 8; break;
            case 2: bps = 12; break;
            case 4: bps = 16; break;
            case 5: bps = 20; break;
            case 6: bps = 24; break;
            case 7: bps = 32; break;
            default: return -13;
        }
        br.read_bits(8);  // CRC-8

        uint32_t n_ch = si.channels;
        int assignment = -1;  // 0 left/side, 1 right/side, 2 mid/side
        if (ch_code <= 7) {
            if (ch_code + 1 != n_ch) return -14;
        } else if (ch_code <= 10) {
            if (n_ch != 2) return -14;
            assignment = (int)ch_code - 8;
        } else {
            return -14;
        }

        for (uint32_t c = 0; c < n_ch; ++c) {
            int sub_bps = bps;
            // the side channel carries one extra bit
            if (assignment == 0 && c == 1) ++sub_bps;  // left/side
            if (assignment == 1 && c == 0) ++sub_bps;  // right/side
            if (assignment == 2 && c == 1) ++sub_bps;  // mid/side
            if (!decode_subframe(br, block_size, sub_bps, chan[c]))
                return -15;
        }
        br.align();
        br.read_bits(16);  // CRC-16

        // undo inter-channel decorrelation
        if (assignment == 0) {  // left/side: right = left - side
            for (uint32_t i = 0; i < block_size; ++i)
                chan[1][i] = chan[0][i] - chan[1][i];
        } else if (assignment == 1) {  // right/side: left = side + right
            for (uint32_t i = 0; i < block_size; ++i)
                chan[0][i] = chan[0][i] + chan[1][i];
        } else if (assignment == 2) {  // mid/side
            for (uint32_t i = 0; i < block_size; ++i) {
                int64_t side = chan[1][i];
                int64_t mid = (chan[0][i] << 1) | (side & 1);
                chan[0][i] = (mid + side) >> 1;
                chan[1][i] = (mid - side) >> 1;
            }
        }

        uint64_t n_write = block_size;
        if (written + n_write > si.total_samples)
            n_write = si.total_samples - written;
        for (uint64_t i = 0; i < n_write; ++i)
            for (uint32_t c = 0; c < n_ch; ++c)
                out[(written + i) * n_ch + c] = (int32_t)chan[c][i];
        written += n_write;
    }
    return written == si.total_samples ? 0 : -16;
}

}  // extern "C"

// ====================== Encoder (verbatim subframes) ======================
//
// Writes standards-compliant FLAC with verbatim subframes — bit-exact PCM,
// correct CRC-8/CRC-16, independent channels. Counterpart of
// `Signal.save_signal(mode="flac")` (reference `classes/signal.py:1572`,
// which delegates to libsndfile).

namespace {

struct BitWriter {
    std::vector<uint8_t> buf;
    uint64_t acc = 0;
    int nbits = 0;

    inline void write_bits(uint64_t v, int n) {
        acc = (acc << n) | (v & ((n == 64) ? ~0ull : ((1ull << n) - 1)));
        nbits += n;
        while (nbits >= 8) {
            buf.push_back((uint8_t)(acc >> (nbits - 8)));
            nbits -= 8;
        }
    }
    inline void align() {
        if (nbits) write_bits(0, 8 - nbits);
    }
};

uint8_t crc8(const uint8_t* d, size_t n) {
    uint8_t crc = 0;
    for (size_t i = 0; i < n; ++i) {
        crc ^= d[i];
        for (int b = 0; b < 8; ++b)
            crc = (crc & 0x80) ? (uint8_t)((crc << 1) ^ 0x07)
                               : (uint8_t)(crc << 1);
    }
    return crc;
}

uint16_t crc16(const uint8_t* d, size_t n) {
    uint16_t crc = 0;
    for (size_t i = 0; i < n; ++i) {
        crc ^= (uint16_t)d[i] << 8;
        for (int b = 0; b < 8; ++b)
            crc = (crc & 0x8000) ? (uint16_t)((crc << 1) ^ 0x8005)
                                 : (uint16_t)(crc << 1);
    }
    return crc;
}

void write_utf8_number(BitWriter& bw, uint64_t v) {
    if (v < 0x80) {
        bw.write_bits(v, 8);
    } else if (v < 0x800) {
        bw.write_bits(0xC0 | (v >> 6), 8);
        bw.write_bits(0x80 | (v & 0x3F), 8);
    } else if (v < 0x10000) {
        bw.write_bits(0xE0 | (v >> 12), 8);
        bw.write_bits(0x80 | ((v >> 6) & 0x3F), 8);
        bw.write_bits(0x80 | (v & 0x3F), 8);
    } else if (v < 0x200000) {
        bw.write_bits(0xF0 | (v >> 18), 8);
        bw.write_bits(0x80 | ((v >> 12) & 0x3F), 8);
        bw.write_bits(0x80 | ((v >> 6) & 0x3F), 8);
        bw.write_bits(0x80 | (v & 0x3F), 8);
    } else {
        bw.write_bits(0xF8 | (v >> 24), 8);
        bw.write_bits(0x80 | ((v >> 18) & 0x3F), 8);
        bw.write_bits(0x80 | ((v >> 12) & 0x3F), 8);
        bw.write_bits(0x80 | ((v >> 6) & 0x3F), 8);
        bw.write_bits(0x80 | (v & 0x3F), 8);
    }
}

int sample_size_code(uint32_t bps) {
    switch (bps) {
        case 8: return 1;
        case 12: return 2;
        case 16: return 4;
        case 20: return 5;
        case 24: return 6;
        case 32: return 7;
        default: return -1;
    }
}

}  // namespace

extern "C" {

// Returns the number of bytes written to `out` (caller allocates
// generously: 128 + total*channels*4 + frames*16 is always enough), or a
// negative error code.
int64_t flac_encode(const int32_t* samples, uint64_t total_samples,
                    uint32_t channels, uint32_t sample_rate, uint32_t bps,
                    uint8_t* out) {
    if (channels < 1 || channels > 8) return -1;
    if (sample_size_code(bps) < 0) return -2;
    if (sample_rate == 0 || sample_rate >= (1u << 20)) return -3;

    const uint32_t BS = 4096;
    BitWriter bw;
    // magic
    for (char c : {'f', 'L', 'a', 'C'}) bw.write_bits((uint8_t)c, 8);
    // STREAMINFO (last metadata block)
    bw.write_bits(0x80, 8);   // last=1, type=0
    bw.write_bits(34, 24);    // length
    bw.write_bits(BS, 16);    // min blocksize
    bw.write_bits(BS, 16);    // max blocksize
    bw.write_bits(0, 24);     // min framesize unknown
    bw.write_bits(0, 24);     // max framesize unknown
    bw.write_bits(sample_rate, 20);
    bw.write_bits(channels - 1, 3);
    bw.write_bits(bps - 1, 5);
    bw.write_bits(total_samples, 36);
    for (int i = 0; i < 16; ++i) bw.write_bits(0, 8);  // MD5 unset

    uint64_t frame_no = 0;
    for (uint64_t start = 0; start < total_samples; start += BS) {
        uint32_t n = (uint32_t)((total_samples - start < BS)
                                    ? (total_samples - start)
                                    : BS);
        BitWriter fw;
        fw.write_bits(0x3FFE, 14);  // sync
        fw.write_bits(0, 1);        // reserved
        fw.write_bits(0, 1);        // fixed blocksize strategy
        int bs_code = (n == BS && BS == 4096) ? 12 : 7;  // 4096 or 16-bit
        fw.write_bits(bs_code, 4);
        fw.write_bits(0, 4);  // sample rate: from STREAMINFO
        fw.write_bits(channels - 1, 4);  // independent channels
        fw.write_bits(sample_size_code(bps), 3);
        fw.write_bits(0, 1);  // reserved
        write_utf8_number(fw, frame_no);
        if (bs_code == 7) fw.write_bits(n - 1, 16);
        // header CRC-8 (header is byte-aligned here)
        fw.write_bits(crc8(fw.buf.data(), fw.buf.size()), 8);

        for (uint32_t c = 0; c < channels; ++c) {
            fw.write_bits(0, 1);  // padding
            fw.write_bits(1, 6);  // VERBATIM
            fw.write_bits(0, 1);  // no wasted bits
            for (uint32_t i = 0; i < n; ++i) {
                int32_t s = samples[(start + i) * channels + c];
                fw.write_bits((uint32_t)s, bps);
            }
        }
        fw.align();
        uint16_t c16 = crc16(fw.buf.data(), fw.buf.size());
        fw.write_bits(c16, 16);

        for (uint8_t b : fw.buf) bw.write_bits(b, 8);
        ++frame_no;
    }
    bw.align();
    std::memcpy(out, bw.buf.data(), bw.buf.size());
    return (int64_t)bw.buf.size();
}

}  // extern "C"
