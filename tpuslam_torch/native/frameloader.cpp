// tpuslam_torch frame loader: a threaded batch decoder of PNG and JPEG frames to gray uint8.
//
// The port's own copy of the reference's native/frameloader.cpp, with its C
// ABI (fl_open_dir, fl_decode_batch, fl_close), its pool of
// max(2, cores / 2) threads and its lexical file order; the caller owns a
// contiguous (n, H, W) uint8 buffer and the pool fills it, one frame a
// job, with the interpreter lock released (ctypes).  Added:
// fl_decode_indices (any list of frames in one call), fl_threads and
// fl_has_jpeg.
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
// JPEG decodes through libjpeg (gray output, libjpeg's own conversion), as
// in the reference, where the build found libjpeg (TPUSLAM_HAVE_JPEG);
// without it a JPEG frame fails with status 6.  A libjpeg error returns a
// status instead of ending the process.
//
// Status codes: 0 ok, 1 cannot open the file, 2 out of memory, 3 corrupt or
// not a frame the loader reads, 4 frame size differs from the first frame,
// 5 frame index out of range, 6 JPEG without libjpeg in this build.

#include <zlib.h>

#include <algorithm>
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

#ifdef TPUSLAM_HAVE_JPEG
#include <csetjmp>
#include <jpeglib.h>
#endif

namespace fs = std::filesystem;

namespace {

enum Status { OK = 0, E_OPEN = 1, E_ALLOC = 2, E_FORMAT = 3, E_SIZE = 4, E_RANGE = 5, E_NO_JPEG = 6 };

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

#ifdef TPUSLAM_HAVE_JPEG
struct JpegError {
    jpeg_error_mgr mgr;
    jmp_buf jump;
};

void jpeg_fail(j_common_ptr cinfo) { longjmp(reinterpret_cast<JpegError*>(cinfo->err)->jump, 1); }

// Decode (out != nullptr) or only read the size of a JPEG file.
int jpeg_gray(const char* path, uint8_t* out, int* h, int* w) {
    FILE* fp = std::fopen(path, "rb");
    if (!fp) return E_OPEN;
    jpeg_decompress_struct cinfo;
    JpegError err;
    cinfo.err = jpeg_std_error(&err.mgr);
    err.mgr.error_exit = jpeg_fail;
    if (setjmp(err.jump)) {
        jpeg_destroy_decompress(&cinfo);
        std::fclose(fp);
        return E_FORMAT;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_stdio_src(&cinfo, fp);
    jpeg_read_header(&cinfo, TRUE);
    int rc = OK;
    if (!out) {
        *w = static_cast<int>(cinfo.image_width);
        *h = static_cast<int>(cinfo.image_height);
    } else {
        cinfo.out_color_space = JCS_GRAYSCALE;  // libjpeg's own conversion, as in the reference
        jpeg_start_decompress(&cinfo);
        if (static_cast<int>(cinfo.output_height) != *h || static_cast<int>(cinfo.output_width) != *w) {
            rc = E_SIZE;
        } else {
            while (cinfo.output_scanline < cinfo.output_height) {
                JSAMPROW row = out + static_cast<size_t>(cinfo.output_scanline) * (*w);
                jpeg_read_scanlines(&cinfo, &row, 1);
            }
            jpeg_finish_decompress(&cinfo);
        }
    }
    jpeg_destroy_decompress(&cinfo);
    std::fclose(fp);
    return rc;
}
#else
int jpeg_gray(const char*, uint8_t*, int*, int*) { return E_NO_JPEG; }
#endif

bool is_jpeg(const std::string& p) {
    auto dot = p.rfind('.');
    if (dot == std::string::npos) return false;
    std::string ext = p.substr(dot);
    std::transform(ext.begin(), ext.end(), ext.begin(), ::tolower);
    return ext == ".jpg" || ext == ".jpeg";
}

struct Loader {
    std::vector<std::string> files;
    int height = 0;
    int width = 0;
    ThreadPool pool{std::max(2u, std::thread::hardware_concurrency() / 2)};
};

int decode_frame(const Loader* L, int index, uint8_t* dst) {
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

// Decode the frames indices[0..count) into out (count × H × W uint8,
// C-contiguous), one pool job a frame.  Returns 0, or the first nonzero
// status with its position in *failed (when failed is not null).
int fl_decode_indices(void* handle, const int* indices, int count, uint8_t* out, int* failed) {
    auto* L = static_cast<Loader*>(handle);
    const int n = static_cast<int>(L->files.size());
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
    if (start < 0 || count < 0 || start + count > static_cast<int>(L->files.size())) return E_RANGE;
    std::vector<int> indices(count);
    for (int i = 0; i < count; ++i) indices[i] = start + i;
    return fl_decode_indices(handle, indices.data(), count, out, nullptr);
}

int fl_threads(void* handle) { return static_cast<int>(static_cast<Loader*>(handle)->pool.workers.size()); }

int fl_has_jpeg(void) {
#ifdef TPUSLAM_HAVE_JPEG
    return 1;
#else
    return 0;
#endif
}

void fl_close(void* handle) { delete static_cast<Loader*>(handle); }

}  // extern "C"
