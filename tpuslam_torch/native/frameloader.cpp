// tpuslam_torch frame loader: a threaded batch decoder of PNG and JPEG frames to gray uint8.
//
// The port's own copy of the reference's native/frameloader.cpp, with its C
// ABI (fl_open_dir, fl_decode_batch, fl_close), its pool of
// max(2, cores / 2) threads and its lexical file order; the caller owns a
// contiguous (n, H, W) uint8 buffer and the pool fills it, one frame a
// job, with the interpreter lock released (ctypes).  Added:
// fl_decode_indices (any list of frames in one call), fl_threads,
// fl_probe (the status of one file's header), and fl_open_video /
// fl_video_chunks: the frames of a Motion JPEG AVI, demuxed here (see the
// AVI section) and decoded by the JPEG decoder below, on the same pool.
//
// PNG decodes over zlib's inflate with this file's own chunk reader,
// unfilter, Adam7 deinterlace and conversion, since libpng is not on every
// machine the port runs on.  It accepts what the reference's libpng path
// accepts and converts as it does: 16-bit samples keep their high byte
// (png_set_strip_16), low-depth gray expands to 8 bits, a palette to RGB
// (indices past it read black), alpha and tRNS are dropped, colour becomes
// gray as (4899·R + 9617·G + 1868·B + 8192) >> 14.  Interlaced files decode
// to the image; the reference reads their Adam7 pass rows as image rows.
// Critical chunks' CRCs are checked; image data past what the header needs
// is ignored, as libpng ignores it.
//
// JPEG decodes with this file's own decoder to the bytes the reference's
// libjpeg gives for gray output (see the JPEG section), with nothing linked
// but zlib and the C++ runtime, so every machine decodes with the same code.
// It reads baseline, extended sequential and progressive Huffman files of 8-bit
// samples, one component or three (YCbCr), interleaved or not, with restart
// intervals.  What it does not read it refuses with a status of its own, never
// ending the process: arithmetic coding, lossless, samples of other than
// 8 bits, hierarchical, other component counts (CMYK, YCCK), RGB, luma
// sampled below a chroma component, a height given by DNL, and progressive
// scans that leave luma's low AC coefficients unrefined (libjpeg smooths those).
//
// Status codes: 0 ok, 1 cannot open the file, 2 out of memory, 3 corrupt or
// not a frame the loader reads, 4 frame size differs from the first frame,
// 5 frame index out of range, 6-14 a JPEG variant refused (JpegStatus), 15-20
// a video refused (VideoStatus).

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>
#include <zlib.h>

#include <algorithm>
#include <cctype>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <filesystem>
#include <functional>
#include <mutex>
#include <new>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace fs = std::filesystem;

namespace {

enum Status { OK = 0, E_OPEN = 1, E_ALLOC = 2, E_FORMAT = 3, E_SIZE = 4, E_RANGE = 5 };

struct ThreadPool {
    explicit ThreadPool(unsigned n) {
        for (unsigned i = 0; i < n; ++i) {
            workers.emplace_back([this] {
                for (;;) {
                    std::function<void()> job;
                    {
                        std::unique_lock<std::mutex> lk(mu);
                        cv.wait(lk, [this] { return stop || !jobs.empty(); });
                        if (stop && jobs.empty()) return;
                        job = std::move(jobs.front());
                        jobs.pop();
                    }
                    job();
                }
            });
        }
    }
    ~ThreadPool() {
        {
            std::lock_guard<std::mutex> lk(mu);
            stop = true;
        }
        cv.notify_all();
        for (auto& w : workers) w.join();
    }
    void submit(std::function<void()> job) {
        {
            std::lock_guard<std::mutex> lk(mu);
            jobs.push(std::move(job));
        }
        cv.notify_one();
    }

    std::vector<std::thread> workers;
    std::queue<std::function<void()>> jobs;
    std::mutex mu;
    std::condition_variable cv;
    bool stop = false;
};

inline uint8_t rgb_to_gray(uint32_t r, uint32_t g, uint32_t b) {
    return static_cast<uint8_t>((4899 * r + 9617 * g + 1868 * b + 8192) >> 14);
}

inline uint32_t be32(const uint8_t* p) {
    return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

bool read_file(const char* path, std::vector<uint8_t>& buf) {
    FILE* fp = std::fopen(path, "rb");
    if (!fp) return false;
    bool ok = std::fseek(fp, 0, SEEK_END) == 0;
    long size = ok ? std::ftell(fp) : -1;
    ok = size >= 0 && std::fseek(fp, 0, SEEK_SET) == 0;
    if (ok) {
        buf.resize(static_cast<size_t>(size));
        ok = std::fread(buf.data(), 1, buf.size(), fp) == buf.size();
    }
    std::fclose(fp);
    return ok;
}

// ---- PNG -----------------------------------------------------------------------

struct Png {
    uint32_t width = 0, height = 0;
    int depth = 0, colour = 0, interlace = 0, channels = 0;
    uint8_t palette[256][3] = {};  // entries past PLTE stay black
    bool has_palette = false;
    std::vector<uint8_t> idat;
};

// Samples a pixel and whether a bit depth is legal for a colour type (the PNG specification).
int png_channels(int colour, int depth) {
    switch (colour) {
        case 0: return (depth == 1 || depth == 2 || depth == 4 || depth == 8 || depth == 16) ? 1 : 0;
        case 2: return (depth == 8 || depth == 16) ? 3 : 0;
        case 3: return (depth == 1 || depth == 2 || depth == 4 || depth == 8) ? 1 : 0;
        case 4: return (depth == 8 || depth == 16) ? 2 : 0;
        case 6: return (depth == 8 || depth == 16) ? 4 : 0;
        default: return 0;
    }
}

// Read the chunks (only IHDR when header_only); CRCs of critical chunks checked.
int parse_png(const std::vector<uint8_t>& d, Png& png, bool header_only) {
    static const uint8_t kSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
    if (d.size() < 8 || std::memcmp(d.data(), kSig, 8) != 0) return E_FORMAT;
    size_t pos = 8;
    bool have_header = false;
    for (;;) {
        if (d.size() - pos < 12) return E_FORMAT;
        const uint32_t len = be32(&d[pos]);
        if (len > d.size() - pos - 12) return E_FORMAT;
        const uint8_t* type = &d[pos + 4];
        const uint8_t* body = &d[pos + 8];
        const bool ihdr = !std::memcmp(type, "IHDR", 4), plte = !std::memcmp(type, "PLTE", 4);
        const bool idat = !std::memcmp(type, "IDAT", 4), iend = !std::memcmp(type, "IEND", 4);
        if ((ihdr || plte || idat || iend) && crc32(0L, type, len + 4) != be32(body + len)) return E_FORMAT;
        pos += 12 + size_t(len);
        if (ihdr) {
            if (len != 13) return E_FORMAT;
            png.width = be32(body);
            png.height = be32(body + 4);
            png.depth = body[8];
            png.colour = body[9];
            png.interlace = body[12];
            png.channels = png_channels(png.colour, png.depth);
            if (!png.channels || png.width == 0 || png.height == 0 || body[10] || body[11] || png.interlace > 1)
                return E_FORMAT;
            if (png.width > 0x7fffffffu || png.height > 0x7fffffffu) return E_FORMAT;
            have_header = true;
            if (header_only) return OK;
        } else if (plte) {  // a palette image needs one of 3·n bytes; other images ignore it
            for (uint32_t i = 0; i < std::min<uint32_t>(len / 3, 256); ++i)
                std::memcpy(png.palette[i], body + 3 * i, 3);
            png.has_palette = len > 0 && len % 3 == 0;
        } else if (idat) {
            png.idat.insert(png.idat.end(), body, body + len);
        } else if (iend) {
            break;
        }
    }
    if (!have_header || png.idat.empty() || (png.colour == 3 && !png.has_palette)) return E_FORMAT;
    return OK;
}

struct Pass {
    int x0, y0, dx, dy;
    size_t w, h, row_bytes;
};

std::vector<Pass> png_passes(const Png& png) {
    static const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                                     {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};
    static const int kWhole[1][4] = {{0, 0, 1, 1}};
    const size_t bits = size_t(png.depth) * png.channels;
    std::vector<Pass> passes;
    const int n = png.interlace ? 7 : 1;
    for (int i = 0; i < n; ++i) {
        const int* p = png.interlace ? kAdam7[i] : kWhole[0];
        if (png.width <= uint32_t(p[0]) || png.height <= uint32_t(p[1])) continue;  // an empty pass
        const size_t w = (png.width - p[0] + p[2] - 1) / p[2];
        const size_t h = (png.height - p[1] + p[3] - 1) / p[3];
        passes.push_back({p[0], p[1], p[2], p[3], w, h, (w * bits + 7) / 8});
    }
    return passes;
}

// Undo one row's filter in place; prev is the previous row of the pass (zeros for its first).
bool unfilter_row(int ftype, uint8_t* cur, const uint8_t* prev, size_t n, size_t bpp) {
    switch (ftype) {
        case 0:
            return true;
        case 1:
            for (size_t x = bpp; x < n; ++x) cur[x] = uint8_t(cur[x] + cur[x - bpp]);
            return true;
        case 2:
            for (size_t x = 0; x < n; ++x) cur[x] = uint8_t(cur[x] + prev[x]);
            return true;
        case 3:
            for (size_t x = 0; x < std::min(bpp, n); ++x) cur[x] = uint8_t(cur[x] + (prev[x] >> 1));
            for (size_t x = bpp; x < n; ++x) cur[x] = uint8_t(cur[x] + ((cur[x - bpp] + prev[x]) >> 1));
            return true;
        case 4:
            for (size_t x = 0; x < std::min(bpp, n); ++x) cur[x] = uint8_t(cur[x] + prev[x]);
            for (size_t x = bpp; x < n; ++x) {
                const int a = cur[x - bpp], b = prev[x], c = prev[x - bpp];
                const int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - 2 * c);
                cur[x] = uint8_t(cur[x] + ((pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c)));
            }
            return true;
        default:
            return false;
    }
}

// One unfiltered row of w pixels → gray bytes at dst[0], dst[dx], dst[2·dx], …
void row_to_gray(const Png& png, const uint8_t* row, size_t w, uint8_t* dst, int dx) {
    const int depth = png.depth, ch = png.channels;
    if (png.colour == 0 && depth == 8 && dx == 1) {
        std::memcpy(dst, row, w);
        return;
    }
    // sample c of pixel x; 16-bit samples keep their high byte
    auto sample = [&](size_t x, int c) -> uint32_t {
        if (depth == 16) return row[(x * ch + c) * 2];
        if (depth == 8) return row[x * ch + c];
        const size_t bit = x * depth;  // below 8 bits: one sample a pixel, most significant first
        return (row[bit >> 3] >> (8 - depth - (bit & 7))) & ((1u << depth) - 1);
    };
    for (size_t x = 0; x < w; ++x) {
        uint8_t g;
        if (png.colour == 0 || png.colour == 4) {
            g = uint8_t(depth < 8 ? sample(x, 0) * (255u / ((1u << depth) - 1)) : sample(x, 0));
        } else if (png.colour == 3) {
            const uint8_t* rgb = png.palette[sample(x, 0)];
            g = rgb_to_gray(rgb[0], rgb[1], rgb[2]);
        } else {
            g = rgb_to_gray(sample(x, 0), sample(x, 1), sample(x, 2));
        }
        dst[x * dx] = g;
    }
}

int decode_png_gray(const char* path, uint8_t* out, int out_h, int out_w) {
    std::vector<uint8_t> file;
    if (!read_file(path, file)) return E_OPEN;
    Png png;
    if (int rc = parse_png(file, png, false)) return rc;
    file = std::vector<uint8_t>();
    if (png.height != uint32_t(out_h) || png.width != uint32_t(out_w)) return E_SIZE;
    const std::vector<Pass> passes = png_passes(png);
    size_t total = 0, widest = 0;
    for (const Pass& p : passes) {
        total += p.h * (p.row_bytes + 1);
        widest = std::max(widest, p.row_bytes);
    }
    std::vector<uint8_t> raw(total), zeros(widest, 0);
    z_stream zs{};
    if (inflateInit(&zs) != Z_OK) return E_ALLOC;
    zs.next_in = png.idat.data();
    zs.avail_in = static_cast<uInt>(png.idat.size());
    zs.next_out = raw.data();
    zs.avail_out = static_cast<uInt>(total);
    while (zs.avail_out > 0) {
        const int zrc = inflate(&zs, Z_NO_FLUSH);
        if (zrc != Z_OK) break;  // the stream ended, failed or ran dry
    }
    const bool short_data = zs.avail_out != 0;
    inflateEnd(&zs);
    if (short_data) return E_FORMAT;

    const size_t bpp = std::max<size_t>(1, size_t(png.depth) * png.channels / 8);
    uint8_t* rows = raw.data();
    for (const Pass& p : passes) {
        const uint8_t* prev = zeros.data();
        for (size_t y = 0; y < p.h; ++y) {
            uint8_t* cur = rows + 1;
            if (!unfilter_row(rows[0], cur, prev, p.row_bytes, bpp)) return E_FORMAT;
            uint8_t* dst = out + (size_t(p.y0) + y * p.dy) * size_t(out_w) + p.x0;
            row_to_gray(png, cur, p.w, dst, p.dx);
            prev = cur;
            rows += p.row_bytes + 1;
        }
    }
    return OK;
}

int probe_png_size(const char* path, int* h, int* w) {
    std::vector<uint8_t> file;
    if (!read_file(path, file)) return E_OPEN;
    Png png;
    if (int rc = parse_png(file, png, true)) return rc;
    *w = static_cast<int>(png.width);
    *h = static_cast<int>(png.height);
    return OK;
}

// ---- JPEG ----------------------------------------------------------------------
//
// The bytes libjpeg (libjpeg-turbo 2.1, the 6b API) gives for out_color_space =
// JCS_GRAYSCALE with its defaults: the Huffman entropy decoder of jdhuff.c /
// jdphuff.c, then jidctint.c's islow IDCT of component 0 alone through the
// range-limit table of jdmaster.c.  Component 0 is the output of a one-component
// or a YCbCr image; the other components are entropy-decoded (they share the
// bit stream) and dropped.  What libjpeg does with a corrupt stream is kept where
// it decides the pixels: past the end of the entropy data (a marker, or the end of
// the file) the bits read as zeros, and once a bit past the end was needed the
// rest of the restart interval is left zero; a code that matches no symbol reads
// 17 bits and decodes as 0; a missing table slot 0 or 1 at the first scan gets
// the standard table (Annex K), as for Motion-JPEG frames.

constexpr int kRangeMask = 1023;  // libjpeg's RANGE_MASK for 8-bit samples

// Zigzag position → natural position; 16 more entries of 63 absorb a run that
// overflows the block in a corrupt stream, as libjpeg's table does.
constexpr uint8_t kNatural[80] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13,
    6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31,
    39, 46, 53, 60, 61, 54, 47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// The standard Huffman tables of Annex K.3: counts of codes of length 1..16, then the symbols.
constexpr uint8_t kStdDcLuma[] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
constexpr uint8_t kStdDcChroma[] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
constexpr uint8_t kStdAcLuma[] = {
    0,    2,    1,    3,    3,    2,    4,    3,    5,    5,    4,    4,    0,    0,    1,    0x7d, 0x01, 0x02, 0x03,
    0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91,
    0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17,
    0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
    0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3,
    0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4,
    0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3,
    0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
constexpr uint8_t kStdAcChroma[] = {
    0,    2,    1,    2,    4,    4,    3,    4,    7,    5,    4,    4,    0,    1,    2,    0x77, 0x00, 0x01, 0x02,
    0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14,
    0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1,
    0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67,
    0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa,
    0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2,
    0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3,
    0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffTable {
    bool defined = false;
    uint8_t bits[17] = {};  // bits[l]: codes of length l
    uint8_t vals[256] = {};
    int32_t maxcode[18] = {};
    int32_t valoffset[18] = {};
    uint16_t look[256] = {};  // 8-bit lookahead: (length << 8) | symbol, length 9 = longer code
};

void set_table(HuffTable& t, const uint8_t* counts, const uint8_t* vals) {
    t = HuffTable();
    int n = 0;
    for (int l = 1; l <= 16; ++l) n += t.bits[l] = counts[l - 1];
    std::memcpy(t.vals, vals, size_t(n));
    t.defined = true;
}

// Canonical codes (Annex C) → maxcode / valoffset and the lookahead table; false on an over-full table.
bool derive_table(HuffTable& t, bool dc) {
    int code = 0, p = 0;
    int32_t codes[256];
    for (int l = 1; l <= 16; ++l) {
        for (int i = 0; i < t.bits[l]; ++i) codes[p++] = code++;
        if (t.bits[l] && code >= (1 << l)) return false;  // no code is all ones
        code <<= 1;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
        if (t.bits[l]) {
            t.valoffset[l] = p - codes[p];
            p += t.bits[l];
            t.maxcode[l] = codes[p - 1];
        } else {
            t.maxcode[l] = -1;
        }
    }
    t.maxcode[17] = 0xFFFFF;
    for (int i = 0; i < 256; ++i) t.look[i] = 9 << 8;
    p = 0;
    for (int l = 1; l <= 8; ++l) {
        for (int i = 0; i < t.bits[l]; ++i, ++p) {
            const int base = codes[p] << (8 - l);
            for (int j = 0; j < (1 << (8 - l)); ++j) t.look[base + j] = uint16_t((l << 8) | t.vals[p]);
        }
    }
    if (dc) {
        int n = 0;
        for (int l = 1; l <= 16; ++l) n += t.bits[l];
        for (int i = 0; i < n; ++i)
            if (t.vals[i] > 15) return false;
    }
    return true;
}

struct Component {
    int id = 0, h = 1, v = 1, tq = 0;
    int bw = 0, bh = 0;        // blocks that cover the component's samples
    int bw_mcu = 0, bh_mcu = 0;  // blocks that cover the MCUs of an interleaved scan
    int dc_table = 0, ac_table = 0;
    bool latched = false;      // the quantisation table is read at the component's first scan
    int16_t quant[64] = {};    // natural order, as libjpeg's ISLOW multiplier table (16-bit)
    int coef_bits[64];         // progressive: the Al of the last scan of each coefficient, -1 before
    std::vector<int16_t> coef; // bh_mcu × bw_mcu blocks of 64 coefficients, natural order
};

enum JpegStatus {
    J_ARITHMETIC = 6, J_LOSSLESS = 7, J_PRECISION = 8, J_HIERARCHICAL = 9, J_COMPONENTS = 10, J_RGB = 11,
    J_SUBSAMPLED_LUMA = 12, J_DNL = 13, J_SMOOTHING = 14,
};

struct Jpeg {
    const uint8_t* d = nullptr;
    size_t n = 0, pos = 0;
    // frame
    int width = 0, height = 0, hmax = 1, vmax = 1, mcus_x = 0, mcus_y = 0;
    bool progressive = false, saw_sof = false, saw_jfif = false, saw_adobe = false, scanned = false;
    int adobe_transform = 0, restart_interval = 0;
    std::vector<Component> comps;
    uint16_t qt[4][64];
    bool qt_defined[4] = {};
    HuffTable dc[4], ac[4];
    // bit reader of the current scan
    uint64_t buf = 0;
    int bits = 0, marker = 0, next_restart = 0;
    bool short_data = false;  // libjpeg's insufficient_data: a bit past the end was read in this interval

    // Byte i of the stream; past the end of the file libjpeg's stdio source inserts EOI markers.
    uint8_t byte(size_t i) const { return i < n ? d[i] : ((i - n) & 1 ? 0xD9 : 0xFF); }
    int u16(size_t i) const { return (byte(i) << 8) | byte(i + 1); }

    // libjpeg's next_marker: skip bytes that are not a marker, fill bytes 0xFF and stuffed FF 00.
    int next_marker() {
        for (;;) {
            while (byte(pos) != 0xFF) ++pos;
            while (byte(pos) == 0xFF) ++pos;
            const int c = byte(pos++);
            if (c != 0) return c;
        }
    }

    void fill() {
        while (bits <= 56 && marker == 0) {
            int c = byte(pos++);
            if (c == 0xFF) {
                do c = byte(pos++); while (c == 0xFF);
                if (c != 0) {
                    marker = c;
                    break;
                }
                c = 0xFF;
            }
            buf = (buf << 8) | uint64_t(c);
            bits += 8;
        }
    }
    // The next k (<= 25) bits, zeros past the end of the data.
    uint32_t peek(int k) {
        if (bits < k) fill();
        const uint64_t v = bits >= k ? buf >> (bits - k) : buf << (k - bits);
        return uint32_t(v & ((uint64_t(1) << k) - 1));
    }
    void skip(int k) {
        if (k > bits) fill();
        if (k <= bits) {
            bits -= k;
        } else {
            short_data = true;
            bits = 0;
        }
        buf &= bits ? (uint64_t(1) << bits) - 1 : 0;
    }
    int get(int k) {
        if (k == 0) return 0;
        const int v = int(peek(k));
        skip(k);
        return v;
    }
    int decode(const HuffTable& t) {
        const uint32_t p = peek(16);
        const int e = t.look[p >> 8];
        if ((e >> 8) <= 8) {
            skip(e >> 8);
            return e & 0xFF;
        }
        for (int l = 9; l <= 16; ++l) {
            const int code = int(p >> (16 - l));
            if (code <= t.maxcode[l]) {
                skip(l);
                return t.vals[(code + t.valoffset[l]) & 0xFF];
            }
        }
        skip(17);  // no code matches: libjpeg reads a 17th bit and decodes 0
        return 0;
    }
    static int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

    // libjpeg's process_restart: drop the buffered bits, read RSTn (resyncing as
    // jpeg_resync_to_restart does), reset the predictions.
    void restart() {
        bits = 0;
        buf = 0;
        if (marker == 0) marker = next_marker();
        const int want = next_restart;
        for (;;) {
            int action;
            if (marker < 0xC0) {
                action = 2;
            } else if (marker < 0xD0 || marker > 0xD7) {
                action = 3;
            } else if (marker == 0xD0 + ((want + 1) & 7) || marker == 0xD0 + ((want + 2) & 7)) {
                action = 3;
            } else if (marker == 0xD0 + ((want - 1) & 7) || marker == 0xD0 + ((want - 2) & 7)) {
                action = 2;
            } else {
                action = 1;  // the expected marker, or one too far away to tell
            }
            if (action == 1) {
                marker = 0;
                break;
            }
            if (action == 3) break;
            marker = next_marker();
        }
        next_restart = (next_restart + 1) & 7;
        if (marker == 0) short_data = false;
    }

    int parse_sof(int type, int len) {
        if (saw_sof) return E_FORMAT;
        saw_sof = true;
        progressive = type == 0xC2;
        const int precision = byte(pos);
        height = u16(pos + 1);
        width = u16(pos + 3);
        const int nc = byte(pos + 5);
        if (len != 8 + 3 * nc || nc <= 0 || width <= 0) return E_FORMAT;
        if (precision != 8) return J_PRECISION;
        if (height == 0) return J_DNL;
        if (nc != 1 && nc != 3) return J_COMPONENTS;
        comps.resize(size_t(nc));
        for (int i = 0; i < nc; ++i) {
            Component& c = comps[i];
            c.id = byte(pos + 6 + 3 * i);
            c.h = byte(pos + 7 + 3 * i) >> 4;
            c.v = byte(pos + 7 + 3 * i) & 15;
            c.tq = byte(pos + 8 + 3 * i);
            if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) return E_FORMAT;
            hmax = std::max(hmax, c.h);
            vmax = std::max(vmax, c.v);
            std::fill(c.coef_bits, c.coef_bits + 64, -1);
        }
        mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
        mcus_y = (height + 8 * vmax - 1) / (8 * vmax);
        for (Component& c : comps) {
            const int cw = (width * c.h + hmax - 1) / hmax, ch = (height * c.v + vmax - 1) / vmax;
            c.bw = (cw + 7) / 8;
            c.bh = (ch + 7) / 8;
            c.bw_mcu = mcus_x * c.h;
            c.bh_mcu = mcus_y * c.v;
        }
        return OK;
    }

    int parse_dht(size_t end) {
        size_t p = pos;
        while (p + 17 <= end) {
            const int index = byte(p);
            int count = 0;
            for (int l = 1; l <= 16; ++l) count += byte(p + l);
            if (count > 256 || p + 17 + count > end) return E_FORMAT;
            const int slot = index & 0x0F;
            if ((index & 0xEF) != slot || slot > 3) return E_FORMAT;
            HuffTable& t = (index & 0x10) ? ac[slot] : dc[slot];
            uint8_t counts[16], vals[256];
            for (int l = 0; l < 16; ++l) counts[l] = byte(p + 1 + l);
            for (int i = 0; i < count; ++i) vals[i] = byte(p + 17 + i);
            set_table(t, counts, vals);
            p += 17 + size_t(count);
        }
        return p == end ? OK : E_FORMAT;
    }

    int parse_dqt(size_t end) {
        size_t p = pos;
        while (p < end) {
            const int pq = byte(p) >> 4, tq = byte(p) & 15;
            if (tq > 3) return E_FORMAT;
            ++p;
            const size_t size = pq ? 128 : 64;
            if (p + size > end) return E_FORMAT;
            for (int i = 0; i < 64; ++i) qt[tq][kNatural[i]] = uint16_t(pq ? u16(p + 2 * i) : byte(p + i));
            qt_defined[tq] = true;
            p += size;
        }
        return OK;
    }

    // Markers up to the next SOS (true) or EOI (false); *rc holds a status when it is not OK.
    bool read_markers(int* rc) {
        *rc = OK;
        for (;;) {
            const int m = marker ? marker : next_marker();
            marker = 0;
            if (m == 0xD9) return false;  // EOI
            if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;  // TEM, RSTn: no length
            if (m == 0xD8) {
                *rc = E_FORMAT;
                return false;
            }
            const int len = u16(pos);
            if (len < 2) {
                *rc = E_FORMAT;
                return false;
            }
            const size_t body = pos + 2, end = pos + size_t(len);
            pos = body;
            int status = OK;
            switch (m) {
                case 0xC0: case 0xC1: case 0xC2: status = parse_sof(m, len); break;
                case 0xC9: case 0xCA: case 0xCB: status = J_ARITHMETIC; break;
                case 0xC3: status = J_LOSSLESS; break;
                case 0xC5: case 0xC6: case 0xC7: case 0xCD: case 0xCE: case 0xCF: case 0xDE: case 0xDF:
                    status = J_HIERARCHICAL;
                    break;
                case 0xC4: status = parse_dht(end); break;
                case 0xDB: status = parse_dqt(end); break;
                case 0xDD:
                    if (len != 4) status = E_FORMAT;
                    restart_interval = u16(body);
                    break;
                case 0xDA:
                    pos = body - 2;
                    return true;
                case 0xE0:  // JFIF
                    if (len - 2 >= 14 && byte(body) == 'J' && byte(body + 1) == 'F' && byte(body + 2) == 'I' &&
                        byte(body + 3) == 'F' && byte(body + 4) == 0)
                        saw_jfif = true;
                    break;
                case 0xEE:  // Adobe
                    if (len - 2 >= 12 && byte(body) == 'A' && byte(body + 1) == 'd' && byte(body + 2) == 'o' &&
                        byte(body + 3) == 'b' && byte(body + 4) == 'e') {
                        saw_adobe = true;
                        adobe_transform = byte(body + 11);
                    }
                    break;
                case 0xCC: case 0xDC: case 0xFE: break;  // DAC, DNL, COM
                default:
                    if (m < 0xE0 || m > 0xEF) status = E_FORMAT;  // APPn are skipped
            }
            if (status != OK) {
                *rc = status;
                return false;
            }
            pos = end;
        }
    }

    // After the SOF: what libjpeg's gray output of this frame would need that the port does not do.
    int refusal() const {
        if (comps.size() == 3) {
            const bool rgb_ids = comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B';
            if (!saw_jfif && ((saw_adobe && adobe_transform == 0) || (!saw_adobe && rgb_ids))) return J_RGB;
        }
        if (comps[0].h < hmax || comps[0].v < vmax) return J_SUBSAMPLED_LUMA;
        return OK;
    }

    // The header up to the first SOS: the size, or the status that refuses the file.
    int header() {
        if (byte(0) != 0xFF || byte(1) != 0xD8) return E_FORMAT;
        pos = 2;
        int rc;
        const bool sos = read_markers(&rc);
        if (rc != OK) return rc;
        if (!sos || !saw_sof) return E_FORMAT;
        return refusal();
    }

    // One scan, the SOS body at pos.
    int scan() {
        const int len = u16(pos);
        const int ns = byte(pos + 2);
        if (ns < 1 || ns > 4 || len != 6 + 2 * ns) return E_FORMAT;
        Component* sc[4];
        for (int i = 0; i < ns; ++i) {
            const int id = byte(pos + 3 + 2 * i), tables = byte(pos + 4 + 2 * i);
            sc[i] = nullptr;
            for (Component& c : comps)
                if (c.id == id) sc[i] = &c;
            if (!sc[i]) return E_FORMAT;
            for (int j = 0; j < i; ++j)
                if (sc[j] == sc[i]) return E_FORMAT;
            sc[i]->dc_table = tables >> 4;
            sc[i]->ac_table = tables & 15;
        }
        const int ss = byte(pos + 3 + 2 * ns), se = byte(pos + 4 + 2 * ns);
        const int ah = byte(pos + 5 + 2 * ns) >> 4, al = byte(pos + 5 + 2 * ns) & 15;
        pos += size_t(len);
        if (!scanned) {  // libjpeg supplies the standard tables for empty slots before its first scan
            if (!dc[0].defined) set_table(dc[0], kStdDcLuma, kStdDcLuma + 16);
            if (!ac[0].defined) set_table(ac[0], kStdAcLuma, kStdAcLuma + 16);
            if (!dc[1].defined) set_table(dc[1], kStdDcChroma, kStdDcChroma + 16);
            if (!ac[1].defined) set_table(ac[1], kStdAcChroma, kStdAcChroma + 16);
            scanned = true;
        }
        const bool dc_band = ss == 0;
        if (progressive) {
            bool bad = dc_band ? se != 0 : (ss > se || se > 63 || ns != 1);
            if (ah != 0 && al != ah - 1) bad = true;
            if (al > 13 || bad) return E_FORMAT;
        }
        HuffTable* dct[4] = {};
        HuffTable* act[4] = {};
        for (int i = 0; i < ns; ++i) {
            Component& c = *sc[i];
            if (!c.latched) {
                if (c.tq > 3 || !qt_defined[c.tq]) return E_FORMAT;
                for (int k = 0; k < 64; ++k) c.quant[k] = int16_t(qt[c.tq][k]);
                c.latched = true;
                c.coef.assign(size_t(c.bw_mcu) * c.bh_mcu * 64, 0);
            }
            const bool need_dc = !progressive || (dc_band && ah == 0);
            const bool need_ac = !progressive || !dc_band;
            if (need_dc) {
                if (c.dc_table > 3 || !dc[c.dc_table].defined) return E_FORMAT;
                dct[i] = &dc[c.dc_table];
                if (!derive_table(*dct[i], true)) return E_FORMAT;
            }
            if (need_ac) {
                if (c.ac_table > 3 || !ac[c.ac_table].defined) return E_FORMAT;
                act[i] = &ac[c.ac_table];
                if (!derive_table(*act[i], false)) return E_FORMAT;
            }
            if (progressive)
                for (int k = ss; k <= se; ++k) c.coef_bits[k] = al;
        }
        // MCU layout: one block of a lone component, or each component's h × v blocks
        int mx, my;
        if (ns == 1) {
            mx = sc[0]->bw;
            my = sc[0]->bh;
        } else {
            mx = mcus_x;
            my = mcus_y;
            int blocks = 0;
            for (int i = 0; i < ns; ++i) blocks += sc[i]->h * sc[i]->v;
            if (blocks > 10) return E_FORMAT;
        }
        buf = 0;
        bits = 0;
        marker = 0;
        short_data = false;
        next_restart = 0;
        int pred[4] = {0, 0, 0, 0}, eobrun = 0, to_go = restart_interval;
        for (int y = 0; y < my; ++y) {
            for (int x = 0; x < mx; ++x) {
                if (restart_interval) {
                    if (to_go == 0) {
                        restart();
                        std::fill(pred, pred + 4, 0);
                        eobrun = 0;
                        to_go = restart_interval;
                    }
                    --to_go;
                }
                const bool refine_dc = progressive && dc_band && ah != 0;
                if (short_data && !refine_dc) continue;  // the rest of the interval stays as it is
                for (int i = 0; i < ns; ++i) {
                    Component& c = *sc[i];
                    const int bh = ns == 1 ? 1 : c.v, bwid = ns == 1 ? 1 : c.h;
                    for (int by = 0; by < bh; ++by) {
                        for (int bx = 0; bx < bwid; ++bx) {
                            const int row = ns == 1 ? y : y * c.v + by, col = ns == 1 ? x : x * c.h + bx;
                            int16_t* b = &c.coef[(size_t(row) * c.bw_mcu + col) * 64];
                            if (!progressive) {
                                block_sequential(b, *dct[i], *act[i], pred[i]);
                            } else if (dc_band && ah == 0) {
                                int s = decode(*dct[i]);
                                if (s) s = extend(get(s), s);
                                pred[i] += s;
                                b[0] = int16_t(uint32_t(pred[i]) << al);
                            } else if (dc_band) {
                                if (get(1)) b[0] = int16_t(b[0] | (1 << al));
                            } else if (ah == 0) {
                                ac_first(b, *act[i], ss, se, al, eobrun);
                            } else {
                                ac_refine(b, *act[i], ss, se, al, eobrun);
                            }
                        }
                    }
                }
            }
        }
        return OK;
    }

    void block_sequential(int16_t* b, const HuffTable& dct, const HuffTable& act, int& pred) {
        int s = decode(dct);
        if (s) s = extend(get(s), s);
        pred += s;
        b[0] = int16_t(pred);
        for (int k = 1; k < 64; ++k) {
            const int rs = decode(act), r = rs >> 4;
            s = rs & 15;
            if (s) {
                k += r;
                b[kNatural[k]] = int16_t(extend(get(s), s));
            } else {
                if (r != 15) break;
                k += 15;
            }
        }
    }

    void ac_first(int16_t* b, const HuffTable& act, int ss, int se, int al, int& eobrun) {
        if (eobrun > 0) {
            --eobrun;
            return;
        }
        for (int k = ss; k <= se; ++k) {
            const int rs = decode(act), r = rs >> 4, s = rs & 15;
            if (s) {
                k += r;
                b[kNatural[k]] = int16_t(uint32_t(extend(get(s), s)) << al);
            } else if (r == 15) {
                k += 15;
            } else {
                eobrun = (1 << r) + get(r) - 1;
                break;
            }
        }
    }

    // Successive approximation of the AC band (G.1.2.3), in libjpeg's order of correction bits.
    void ac_refine(int16_t* b, const HuffTable& act, int ss, int se, int al, int& eobrun) {
        const int p1 = 1 << al, m1 = -1 * (1 << al);
        auto correct = [&](int16_t& coef) {
            if (get(1) && (coef & p1) == 0) coef = int16_t(coef >= 0 ? coef + p1 : coef + m1);
        };
        int k = ss;
        if (eobrun == 0) {
            for (; k <= se; ++k) {
                const int rs = decode(act);
                int r = rs >> 4, s = rs & 15;
                if (s) {
                    s = get(1) ? p1 : m1;  // a new coefficient is one bit, whatever its size says
                } else if (r != 15) {
                    eobrun = (1 << r) + get(r);
                    break;
                }
                do {
                    int16_t& coef = b[kNatural[k]];
                    if (coef != 0) {
                        correct(coef);
                    } else if (--r < 0) {
                        break;
                    }
                    ++k;
                } while (k <= se);
                if (s) b[kNatural[k]] = int16_t(s);
            }
        }
        if (eobrun > 0) {
            for (; k <= se; ++k) {
                int16_t& coef = b[kNatural[k]];
                if (coef != 0) correct(coef);
            }
            --eobrun;
        }
    }

    // libjpeg smooths the blocks of a progressive image (jdcoefct.c, smoothing_ok) when
    // every component has DC, has its low quantisers nonzero, and one of AC 1..9 is not
    // fully refined; luma's blocks change only where one of its own is not.
    bool smoothed() const {
        if (!progressive) return false;
        static const int kLow[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
        for (const Component& c : comps) {
            if (!c.latched || c.coef_bits[0] < 0) return false;
            for (int k : kLow)
                if (c.quant[k] == 0) return false;
        }
        for (int k = 1; k < 10; ++k)
            if (comps[0].coef_bits[k] != 0) return true;
        return false;
    }
};

// jidctint.c's jpeg_idct_islow with its 64-bit JLONG, then the range-limit table of
// jdmaster.c's prepare_range_limit_table indexed with & RANGE_MASK (it wraps past ±512).
void idct_islow(const int16_t* coef, const int16_t* quant, uint8_t* out, size_t stride, int rows, int cols) {
    constexpr int CB = 13, P1 = 2;
    constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373, F1175 = 9633,
                      F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;
    auto descale = [](int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; };
    int ws[64];
    for (int c = 0; c < 8; ++c) {
        const int16_t* in = coef + c;
        const int16_t* q = quant + c;
        int* w = ws + c;
        if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] && !in[56]) {
            const int dc = int(uint32_t(in[0] * q[0]) << P1);
            for (int r = 0; r < 8; ++r) w[8 * r] = dc;
            continue;
        }
        int64_t z2 = in[16] * q[16], z3 = in[48] * q[48];
        int64_t z1 = (z2 + z3) * F0541;
        int64_t t2 = z1 + z3 * -F1847, t3 = z1 + z2 * F0765;
        z2 = in[0] * q[0];
        z3 = in[32] * q[32];
        int64_t t0 = (z2 + z3) * (1 << CB), t1 = (z2 - z3) * (1 << CB);
        const int64_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
        t0 = in[56] * q[56];
        t1 = in[40] * q[40];
        t2 = in[24] * q[24];
        t3 = in[8] * q[8];
        z1 = t0 + t3;
        z2 = t1 + t2;
        z3 = t0 + t2;
        int64_t z4 = t1 + t3;
        const int64_t z5 = (z3 + z4) * F1175;
        t0 *= F0298;
        t1 *= F2053;
        t2 *= F3072;
        t3 *= F1501;
        z1 *= -F0899;
        z2 *= -F2562;
        z3 = z3 * -F1961 + z5;
        z4 = z4 * -F0390 + z5;
        t0 += z1 + z3;
        t1 += z2 + z4;
        t2 += z2 + z3;
        t3 += z1 + z4;
        w[0] = int(descale(t10 + t3, CB - P1));
        w[56] = int(descale(t10 - t3, CB - P1));
        w[8] = int(descale(t11 + t2, CB - P1));
        w[48] = int(descale(t11 - t2, CB - P1));
        w[16] = int(descale(t12 + t1, CB - P1));
        w[40] = int(descale(t12 - t1, CB - P1));
        w[24] = int(descale(t13 + t0, CB - P1));
        w[32] = int(descale(t13 - t0, CB - P1));
    }
    auto limit = [](int64_t v) -> uint8_t {
        const int i = int(v) & kRangeMask;
        return i < 128 ? uint8_t(i + 128) : i < 512 ? 255 : i < 896 ? 0 : uint8_t(i - 896);
    };
    for (int r = 0; r < rows; ++r) {
        const int* w = ws + 8 * r;
        uint8_t o[8];
        if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
            std::fill(o, o + 8, limit(descale(w[0], P1 + 3)));
        } else {
            int64_t z2 = w[2], z3 = w[6];
            int64_t z1 = (z2 + z3) * F0541;
            int64_t t2 = z1 + z3 * -F1847, t3 = z1 + z2 * F0765;
            int64_t t0 = (int64_t(w[0]) + w[4]) * (1 << CB), t1 = (int64_t(w[0]) - w[4]) * (1 << CB);
            const int64_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
            t0 = w[7];
            t1 = w[5];
            t2 = w[3];
            t3 = w[1];
            z1 = t0 + t3;
            z2 = t1 + t2;
            z3 = t0 + t2;
            int64_t z4 = t1 + t3;
            const int64_t z5 = (z3 + z4) * F1175;
            t0 *= F0298;
            t1 *= F2053;
            t2 *= F3072;
            t3 *= F1501;
            z1 *= -F0899;
            z2 *= -F2562;
            z3 = z3 * -F1961 + z5;
            z4 = z4 * -F0390 + z5;
            t0 += z1 + z3;
            t1 += z2 + z4;
            t2 += z2 + z3;
            t3 += z1 + z4;
            constexpr int S = CB + P1 + 3;
            o[0] = limit(descale(t10 + t3, S));
            o[7] = limit(descale(t10 - t3, S));
            o[1] = limit(descale(t11 + t2, S));
            o[6] = limit(descale(t11 - t2, S));
            o[2] = limit(descale(t12 + t1, S));
            o[5] = limit(descale(t12 - t1, S));
            o[3] = limit(descale(t13 + t0, S));
            o[4] = limit(descale(t13 - t0, S));
        }
        std::memcpy(out + size_t(r) * stride, o, size_t(cols));
    }
}

// Decode (out != nullptr, *h × *w given) or only read the size of the JPEG in data[0, size): a file's
// bytes or a video frame's payload, read as libjpeg reads a file (EOI markers past the end).
int jpeg_gray_mem(const uint8_t* data, size_t size, uint8_t* out, int* h, int* w) {
    Jpeg j;
    j.d = data;
    j.n = size;
    if (int rc = j.header()) return rc;
    if (!out) {
        *h = j.height;
        *w = j.width;
        return OK;
    }
    if (j.height != *h || j.width != *w) return E_SIZE;
    const bool multi_scan = j.progressive || [&] {
        const int ns = j.byte(j.pos + 2);  // the first scan holds every component: one scan decodes it
        return ns < int(j.comps.size());
    }();
    for (;;) {
        if (int rc = j.scan()) return rc;
        if (!multi_scan) break;
        int rc;
        const bool sos = j.read_markers(&rc);
        if (rc != OK) return rc;
        if (!sos) break;
    }
    if (j.smoothed()) return J_SMOOTHING;
    const Component& c = j.comps[0];
    if (!c.latched) {  // luma never scanned: libjpeg's IDCT of zeros
        std::memset(out, 128, size_t(*h) * size_t(*w));
        return OK;
    }
    for (int by = 0; by < c.bh; ++by) {
        for (int bx = 0; bx < c.bw; ++bx) {
            const int rows = std::min(8, j.height - 8 * by), cols = std::min(8, j.width - 8 * bx);
            idct_islow(&c.coef[(size_t(by) * c.bw_mcu + bx) * 64], c.quant,
                       out + size_t(8 * by) * size_t(*w) + size_t(8 * bx), size_t(*w), rows, cols);
        }
    }
    return OK;
}

int jpeg_gray(const char* path, uint8_t* out, int* h, int* w) {
    std::vector<uint8_t> file;
    if (!read_file(path, file)) return E_OPEN;
    return jpeg_gray_mem(file.data(), file.size(), out, h, w);
}

bool is_jpeg(const std::string& p) {
    auto dot = p.rfind('.');
    if (dot == std::string::npos) return false;
    std::string ext = p.substr(dot);
    std::transform(ext.begin(), ext.end(), ext.begin(), ::tolower);
    return ext == ".jpg" || ext == ".jpeg";
}

// ---- AVI (Motion JPEG) ---------------------------------------------------------
//
// A video file is read as a RIFF tree: "RIFF" "AVI " and any "RIFF" "AVIX" after it
// (OpenDML, past 1 GB), each chunk a FOURCC, a little-endian 32-bit size and a
// body padded to an even size; "LIST" bodies begin with a FOURCC form and hold
// chunks.  "hdrl" holds one "strl" list a stream, each with its "strh" (stream
// header: type, handler, dwScale, dwRate) and "strf" (for video a
// BITMAPINFOHEADER: biWidth, biHeight, biCompression) and maybe "vprp" (OpenDML
// video properties: fields a frame).  The frames are the "##dc" / "##db" chunks,
// ## the stream's number in two decimal digits, of the "movi" lists (and the
// "rec " lists inside them), in file order.  The movi lists are walked, not the
// index: "idx1" covers the first RIFF alone, and JUNK, LIST and index chunks are
// skipped where they stand.  Frame i is at i · dwScale / dwRate seconds; each
// payload is one JPEG image, decoded by the decoder above from a pread of its
// bytes, so frames decode in any order on the pool.  Refused with a status of
// their own (VideoStatus): a codec other than MJPEG, a container other than AVI,
// interlaced MJPEG (two fields a frame), a zero-length frame chunk (a dropped
// frame), a chunk that runs past the end of the file, and no video frames.

enum VideoStatus { V_CODEC = 15, V_CONTAINER = 16, V_INTERLACED = 17, V_EMPTY_CHUNK = 18, V_TRUNCATED = 19,
                   V_NO_VIDEO = 20 };

// The lists the walk descends into; the chunks of any other list are skipped.
enum class Form { Riff, Hdrl, Strl, Movi };

inline uint32_t le32(const uint8_t* p) {
    return uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) | (uint32_t(p[3]) << 24);
}

inline bool fourcc(const uint8_t* p, const char* s) { return std::memcmp(p, s, 4) == 0; }

// The FOURCC names MJPEG, in any case.
bool is_mjpg(const uint8_t* p) {
    const char* want = "MJPG";
    for (int i = 0; i < 4; ++i)
        if (std::toupper(p[i]) != want[i]) return false;
    return true;
}

bool pread_all(int fd, uint8_t* dst, size_t n, uint64_t at) {
    while (n) {
        const ssize_t got = ::pread(fd, dst, n, static_cast<off_t>(at));
        if (got <= 0) return false;
        dst += got;
        n -= static_cast<size_t>(got);
        at += static_cast<uint64_t>(got);
    }
    return true;
}

struct Avi {
    int fd = -1;
    uint64_t size = 0;
    int strl = -1, video = -1;  // the stream of the current strl list, the first video stream
    uint32_t scale = 0, rate = 0;
    int bi_height = 0;
    std::vector<uint64_t> offsets;  // each frame's payload: file offset and size
    std::vector<uint32_t> sizes;

    // The chunks of [p, end), in a list of form `form`.
    int walk(uint64_t p, uint64_t end, Form form) {
        while (p + 8 <= end) {
            uint8_t h[12];
            if (!pread_all(fd, h, 8, p)) return V_TRUNCATED;
            const uint32_t n = le32(h + 4);
            const uint64_t body = p + 8, next = body + n;
            if (next > size) return V_TRUNCATED;
            if (next > end) return E_FORMAT;  // a chunk that overruns its list
            if (fourcc(h, "LIST")) {
                if (n < 4 || !pread_all(fd, h + 8, 4, body)) return E_FORMAT;
                const uint8_t* kind = h + 8;
                int rc = OK;
                if (fourcc(kind, "hdrl")) {
                    rc = walk(body + 4, next, Form::Hdrl);
                } else if (fourcc(kind, "strl")) {
                    ++strl;
                    rc = walk(body + 4, next, Form::Strl);
                } else if (fourcc(kind, "movi") || fourcc(kind, "rec ")) {
                    rc = walk(body + 4, next, Form::Movi);
                }
                if (rc) return rc;
            } else if (form == Form::Strl) {
                if (int rc = stream_chunk(h, body, n)) return rc;
            } else if (form == Form::Movi && video >= 0 && h[0] == '0' + video / 10 &&
                       h[1] == '0' + video % 10 && h[2] == 'd' && (h[3] == 'c' || h[3] == 'b')) {
                if (n == 0) return V_EMPTY_CHUNK;
                offsets.push_back(body);
                sizes.push_back(n);
            }
            p = next + (n & 1);
        }
        return OK;
    }

    // strh, strf and vprp of the first video stream; the other streams' are skipped.
    int stream_chunk(const uint8_t* h, uint64_t body, uint32_t n) {
        uint8_t b[36];
        if (fourcc(h, "strh")) {
            if (n < 36 || !pread_all(fd, b, 36, body)) return E_FORMAT;
            if (!fourcc(b, "vids") || video >= 0) return OK;
            if (strl > 99) return E_FORMAT;
            const uint8_t* handler = b + 4;
            if (le32(handler) != 0 && !is_mjpg(handler)) return V_CODEC;
            video = strl;
            scale = le32(b + 20);
            rate = le32(b + 24);
            if (scale == 0 || rate == 0) return E_FORMAT;
        } else if (strl == video && fourcc(h, "strf")) {
            if (n < 20 || !pread_all(fd, b, 20, body)) return E_FORMAT;
            if (!is_mjpg(b + 16)) return V_CODEC;
            bi_height = std::abs(static_cast<int32_t>(le32(b + 8)));
        } else if (strl == video && fourcc(h, "vprp")) {
            if (n >= 36 && pread_all(fd, b, 36, body) && le32(b + 32) == 2) return V_INTERLACED;
        }
        return OK;
    }

    // The RIFF AVI, then each RIFF AVIX after it; bytes after the last are not read.
    int open(const char* path) {
        fd = ::open(path, O_RDONLY | O_CLOEXEC);
        if (fd < 0) return E_OPEN;
        struct stat st;
        if (::fstat(fd, &st) != 0) return E_OPEN;
        size = static_cast<uint64_t>(st.st_size);
        uint8_t h[12] = {};
        if (!pread_all(fd, h, std::min<uint64_t>(size, 12), 0)) return E_OPEN;
        if (fourcc(h + 4, "ftyp") || be32(h) == 0x1A45DFA3u) return V_CONTAINER;  // MP4 / QuickTime, Matroska / WebM
        if (size < 12) return fourcc(h, "RIFF") ? int(V_TRUNCATED) : int(E_FORMAT);
        if (!fourcc(h, "RIFF") || !fourcc(h + 8, "AVI ")) return E_FORMAT;
        uint64_t p = 0;
        for (int riff = 0; p + 12 <= size; ++riff) {
            if (!pread_all(fd, h, 12, p) || !fourcc(h, "RIFF") || (riff && !fourcc(h + 8, "AVIX"))) break;
            const uint32_t n = le32(h + 4);
            if (n < 4) return E_FORMAT;
            const uint64_t next = p + 8 + n;
            if (next > size) return V_TRUNCATED;
            if (int rc = walk(p + 12, next, Form::Riff)) return rc;
            p = next + (n & 1);
        }
        if (video < 0 || offsets.empty()) return V_NO_VIDEO;
        return OK;
    }

    ~Avi() {
        if (fd >= 0) ::close(fd);
    }
};

// A JPEG of this height is one field of a frame of the stream's height (interlaced Motion JPEG).
bool is_field(int height, int stream_height) {
    return stream_height > height && (stream_height == 2 * height || stream_height == 2 * height - 1);
}

// Frame `index` of a video into dst (h × w).
int decode_video_frame(const Avi& v, int index, uint8_t* dst, int h, int w) {
    std::vector<uint8_t> payload(v.sizes[index]);
    if (!pread_all(v.fd, payload.data(), payload.size(), v.offsets[index])) return E_OPEN;
    int rc = jpeg_gray_mem(payload.data(), payload.size(), dst, &h, &w);
    if (rc == E_SIZE) {
        int fh = 0, fw = 0;
        if (jpeg_gray_mem(payload.data(), payload.size(), nullptr, &fh, &fw) == OK && is_field(fh, v.bi_height))
            rc = V_INTERLACED;
    }
    return rc;
}

struct Loader {
    std::vector<std::string> files;
    Avi avi;  // a video: its frames' payloads (files is empty)
    int height = 0;
    int width = 0;
    ThreadPool pool{std::max(2u, std::thread::hardware_concurrency() / 2)};

    int count() const { return static_cast<int>(avi.fd >= 0 ? avi.offsets.size() : files.size()); }
};

int decode_frame(const Loader* L, int index, uint8_t* dst) {
    if (L->avi.fd >= 0) return decode_video_frame(L->avi, index, dst, L->height, L->width);
    const std::string& path = L->files[index];
    if (!is_jpeg(path)) return decode_png_gray(path.c_str(), dst, L->height, L->width);
    int h = L->height, w = L->width;
    return jpeg_gray(path.c_str(), dst, &h, &w);
}

}  // namespace

extern "C" {

// Open a directory of .png/.jpg/.jpeg frames (lexically sorted, like the
// reference's preprocessor); the first frame sets the size.  Returns a
// handle, or nullptr when there is no frame or the first cannot be read.
void* fl_open_dir(const char* dir_path, int* n_frames, int* height, int* width) {
    Loader* L = new (std::nothrow) Loader();
    if (!L) return nullptr;
    std::error_code ec;
    for (const auto& entry : fs::directory_iterator(dir_path, ec)) {
        if (!entry.is_regular_file()) continue;
        std::string p = entry.path().string();
        auto dot = p.rfind('.');
        if (dot == std::string::npos) continue;
        std::string ext = p.substr(dot);
        std::transform(ext.begin(), ext.end(), ext.begin(), ::tolower);
        if (ext == ".png" || ext == ".jpg" || ext == ".jpeg") L->files.push_back(p);
    }
    if (ec || L->files.empty()) {
        delete L;
        return nullptr;
    }
    std::sort(L->files.begin(), L->files.end());
    const char* first = L->files[0].c_str();
    int rc = is_jpeg(L->files[0]) ? jpeg_gray(first, nullptr, &L->height, &L->width)
                                  : probe_png_size(first, &L->height, &L->width);
    if (rc != OK) {
        delete L;
        return nullptr;
    }
    *n_frames = static_cast<int>(L->files.size());
    *height = L->height;
    *width = L->width;
    return L;
}

// Open an MJPEG AVI: its frame chunks listed, the first frame's header read for
// the size.  Returns a handle and *status 0, or nullptr and *status the reason
// (1, 2, 3, a JPEG variant of the first frame 6-14, or a VideoStatus 15-20).
// *scale / *rate are the stream's dwScale / dwRate: frame i is at i · scale / rate s.
void* fl_open_video(const char* path, int* n_frames, int* height, int* width, unsigned* scale, unsigned* rate,
                    int* status) {
    Loader* L = new (std::nothrow) Loader();
    if (!L) {
        *status = E_ALLOC;
        return nullptr;
    }
    int rc = L->avi.open(path);
    if (rc == OK) {
        std::vector<uint8_t> first(L->avi.sizes[0]);
        rc = pread_all(L->avi.fd, first.data(), first.size(), L->avi.offsets[0])
                 ? jpeg_gray_mem(first.data(), first.size(), nullptr, &L->height, &L->width)
                 : E_OPEN;
        if (rc == OK && is_field(L->height, L->avi.bi_height)) rc = V_INTERLACED;
    }
    *status = rc;
    if (rc != OK) {
        delete L;
        return nullptr;
    }
    *n_frames = L->count();
    *height = L->height;
    *width = L->width;
    *scale = L->avi.scale;
    *rate = L->avi.rate;
    return L;
}

// A video's frame chunks: the file offset and the size of each payload (n_frames entries each).
void fl_video_chunks(void* handle, int64_t* offsets, int64_t* sizes) {
    const Avi& v = static_cast<Loader*>(handle)->avi;
    for (size_t i = 0; i < v.offsets.size(); ++i) {
        offsets[i] = static_cast<int64_t>(v.offsets[i]);
        sizes[i] = static_cast<int64_t>(v.sizes[i]);
    }
}

// Decode the frames indices[0..count) into out (count × H × W uint8,
// C-contiguous), one pool job a frame.  Returns 0, or the first nonzero
// status with its position in *failed (when failed is not null).
int fl_decode_indices(void* handle, const int* indices, int count, uint8_t* out, int* failed) {
    auto* L = static_cast<Loader*>(handle);
    const int n = L->count();
    if (failed) *failed = -1;
    for (int i = 0; i < count; ++i) {
        if (indices[i] < 0 || indices[i] >= n) {
            if (failed) *failed = i;
            return E_RANGE;
        }
    }
    const size_t frame = static_cast<size_t>(L->height) * L->width;
    int status = OK, first_bad = -1, remaining = count;
    std::mutex done_mu;
    std::condition_variable done_cv;
    for (int i = 0; i < count; ++i) {
        L->pool.submit([&, i] {
            const int rc = decode_frame(L, indices[i], out + i * frame);
            // counted under the lock, so the caller cannot return (and free these) before the job lets go
            std::lock_guard<std::mutex> lk(done_mu);
            if (rc != OK && status == OK) {
                status = rc;
                first_bad = i;
            }
            if (--remaining == 0) done_cv.notify_all();
        });
    }
    std::unique_lock<std::mutex> lk(done_mu);
    done_cv.wait(lk, [&] { return remaining == 0; });
    if (failed) *failed = first_bad;
    return status;
}

// Decode frames [start, start+count) into out (count × H × W uint8).
int fl_decode_batch(void* handle, int start, int count, uint8_t* out) {
    auto* L = static_cast<Loader*>(handle);
    if (start < 0 || count < 0 || start + count > L->count()) return E_RANGE;
    std::vector<int> indices(count);
    for (int i = 0; i < count; ++i) indices[i] = start + i;
    return fl_decode_indices(handle, indices.data(), count, out, nullptr);
}

int fl_threads(void* handle) { return static_cast<int>(static_cast<Loader*>(handle)->pool.workers.size()); }

// The status of reading the header of one frame (0, or why it cannot be read), and its size.
int fl_probe(const char* path, int* height, int* width) {
    return is_jpeg(path) ? jpeg_gray(path, nullptr, height, width) : probe_png_size(path, height, width);
}

void fl_close(void* handle) { delete static_cast<Loader*>(handle); }

}  // extern "C"
