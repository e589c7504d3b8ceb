// Host data loader of the PyTorch port: multithreaded grayscale PNG decode
// and EuRoC CSV parse (port of uav_airvision_tpu/runtime/loader.cpp, same C
// API).  Host C++, not a kernel: it fills one contiguous (n, h, w) uint8
// buffer that goes to the card in a single host->device copy.
//
// The card's machine has zlib's headers and library but not libpng's, and no
// OpenCV or PIL, so this file decodes PNG itself with zlib's inflate: the
// chunk walk (CRC-checked critical chunks), inflate of the IDAT stream and
// the five row filters of the PNG specification (None, Sub, Up, Average,
// Paeth).  It takes what a EuRoC camera writes: grayscale, not interlaced,
// 8 bits a sample, or 16 (reduced to the high byte, as libpng's
// png_set_strip_16 does).  Any other file is refused with a status code.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread loader.cpp -lz -o lib.so
// (runtime/native.py builds and binds it with ctypes).

#include <zlib.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Status codes (native.py's STATUS names them).
enum Status {
  kOk = 0,
  kOpen = 1,         // file missing or unreadable
  kTruncated = 2,    // file ends inside a chunk
  kSignature = 3,    // not a PNG
  kChunk = 4,        // malformed chunk or a critical chunk's CRC mismatch
  kUnsupported = 5,  // not 8/16-bit grayscale, or interlaced
  kSize = 6,         // height/width differ from the expected ones
  kInflate = 7,      // the IDAT stream does not inflate to the image's bytes
  kFilter = 8,       // a row names an unknown filter type
};

const uint8_t kSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}

bool read_file(const char* path, std::vector<uint8_t>* buf) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  bool ok = std::fseek(fp, 0, SEEK_END) == 0;
  long size = ok ? std::ftell(fp) : -1;
  ok = ok && size >= 0 && std::fseek(fp, 0, SEEK_SET) == 0;
  if (ok) {
    buf->resize(size_t(size));
    ok = std::fread(buf->data(), 1, buf->size(), fp) == buf->size();
  }
  std::fclose(fp);
  return ok;
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

// Undo the row filters in place: raw holds h rows of (1 + rowbytes) bytes,
// a filter-type byte then the row; bpp is the bytes of one pixel.
int unfilter(uint8_t* raw, size_t h, size_t rowbytes, size_t bpp) {
  const size_t stride = rowbytes + 1;
  for (size_t y = 0; y < h; ++y) {
    uint8_t* row = raw + y * stride + 1;
    const uint8_t* up = y ? raw + (y - 1) * stride + 1 : nullptr;
    switch (row[-1]) {
      case 0:
        break;
      case 1:
        for (size_t i = bpp; i < rowbytes; ++i) row[i] = uint8_t(row[i] + row[i - bpp]);
        break;
      case 2:
        if (up)
          for (size_t i = 0; i < rowbytes; ++i) row[i] = uint8_t(row[i] + up[i]);
        break;
      case 3:
        for (size_t i = 0; i < rowbytes; ++i) {
          int a = i >= bpp ? row[i - bpp] : 0;
          int b = up ? up[i] : 0;
          row[i] = uint8_t(row[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (size_t i = 0; i < rowbytes; ++i) {
          int a = i >= bpp ? row[i - bpp] : 0;
          int b = up ? up[i] : 0;
          int c = (up && i >= bpp) ? up[i - bpp] : 0;
          row[i] = uint8_t(row[i] + paeth(a, b, c));
        }
        break;
      default:
        return kFilter;
    }
  }
  return kOk;
}

int decode_png_gray(const char* path, uint8_t* dst, int expect_h, int expect_w) {
  std::vector<uint8_t> file;
  if (!read_file(path, &file)) return kOpen;
  if (file.size() < 8) return kTruncated;
  if (std::memcmp(file.data(), kSig, 8) != 0) return kSignature;

  size_t pos = 8;
  uint32_t w = 0, h = 0;
  int depth = 0;
  bool have_header = false, done = false;
  std::vector<uint8_t> raw;
  z_stream zs;
  std::memset(&zs, 0, sizeof zs);
  bool z_open = false;
  int status = kOk;
  while (!done && status == kOk) {
    if (file.size() - pos < 12) {
      status = kTruncated;
      break;
    }
    const uint32_t len = be32(&file[pos]);
    const uint8_t* type = &file[pos + 4];
    if (len > file.size() - pos - 12) {
      status = kTruncated;
      break;
    }
    const uint8_t* data = type + 4;
    const bool critical = !(type[0] & 0x20);
    if (critical && uint32_t(crc32(0L, type, len + 4)) != be32(data + len)) {
      status = kChunk;
      break;
    }
    if (std::memcmp(type, "IHDR", 4) == 0) {
      if (len != 13 || have_header) {
        status = kChunk;
        break;
      }
      w = be32(data);
      h = be32(data + 4);
      depth = data[8];
      const int color = data[9], compression = data[10], filter = data[11], interlace = data[12];
      if (color != 0 || (depth != 8 && depth != 16) || compression || filter || interlace) {
        status = kUnsupported;
        break;
      }
      if (int64_t(h) != expect_h || int64_t(w) != expect_w) {
        status = kSize;
        break;
      }
      have_header = true;
      raw.resize(size_t(h) * (size_t(w) * (depth / 8) + 1));
      if (inflateInit(&zs) != Z_OK) {
        status = kInflate;
        break;
      }
      z_open = true;
      zs.next_out = raw.data();
      zs.avail_out = uInt(raw.size());
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      if (!have_header) {
        status = kChunk;
        break;
      }
      zs.next_in = const_cast<Bytef*>(data);
      zs.avail_in = len;
      while (zs.avail_in > 0) {
        const int rc = inflate(&zs, Z_NO_FLUSH);
        if (rc == Z_STREAM_END) break;
        if (rc != Z_OK) {
          status = kInflate;
          break;
        }
      }
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      done = true;
    } else if (critical) {
      status = kUnsupported;  // PLTE, or a critical chunk this decoder does not know
    }
    pos += size_t(len) + 12;
  }
  if (status == kOk && !have_header) status = kChunk;
  if (status == kOk && (zs.avail_out != 0 || zs.total_out != raw.size())) status = kInflate;
  if (z_open) inflateEnd(&zs);
  if (status != kOk) return status;

  const size_t bpp = size_t(depth / 8), rowbytes = size_t(w) * bpp;
  status = unfilter(raw.data(), h, rowbytes, bpp);
  if (status != kOk) return status;
  for (size_t y = 0; y < h; ++y) {
    const uint8_t* row = raw.data() + y * (rowbytes + 1) + 1;
    uint8_t* out = dst + y * size_t(w);
    if (bpp == 1) {
      std::memcpy(out, row, w);
    } else {
      for (size_t x = 0; x < w; ++x) out[x] = row[2 * x];  // high byte
    }
  }
  return kOk;
}

}  // namespace

extern "C" {

// Decode n grayscale PNGs (paths as a NUL-joined blob with offsets) into a
// contiguous (n, h, w) uint8 buffer using `threads` worker threads.
// Returns the number of failed decodes; per-image status in `status`.
int uav_decode_pngs(const char* path_blob, const int64_t* offsets, int n,
                    uint8_t* out, int h, int w, int threads, int* status) {
  std::atomic<int> next(0);
  std::atomic<int> failures(0);
  if (threads < 1) threads = 1;
  if (threads > n) threads = n > 0 ? n : 1;

  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      const char* path = path_blob + offsets[i];
      int rc = decode_png_gray(path, out + size_t(i) * h * w, h, w);
      status[i] = rc;
      if (rc) failures.fetch_add(1);
    }
  };

  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return failures.load();
}

// Parse a EuRoC-style CSV (first column int64 ns timestamp, then `cols`
// float64 fields per row, one header line).  Returns the number of rows
// parsed (<= max_rows); timestamps scaled by `scale` into `ts`.
int64_t uav_parse_csv(const char* path, int cols, double scale, double* ts,
                      double* values, int64_t max_rows) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return -1;
  char line[1024];
  // skip header
  if (!std::fgets(line, sizeof line, fp)) {
    std::fclose(fp);
    return -2;
  }
  int64_t row = 0;
  while (row < max_rows && std::fgets(line, sizeof line, fp)) {
    char* p = line;
    char* end;
    double t = strtod(p, &end);
    if (end == p) continue;
    ts[row] = t * scale;
    p = end;
    for (int c = 0; c < cols; ++c) {
      while (*p == ',' || *p == ' ') ++p;
      values[row * cols + c] = strtod(p, &end);
      p = end;
    }
    ++row;
  }
  std::fclose(fp);
  return row;
}

}  // extern "C"
