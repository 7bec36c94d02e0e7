// RecordIO — chunked record file format, C++ core.
//
// TPU-native rebuild of the reference's recordio subsystem
// (paddle/fluid/recordio/{header,chunk,scanner,writer}.{h,cc}): chunked
// stream of length-prefixed records with CRC32 integrity and optional
// zlib compression, plus an index-free sequential scanner. Exposed to
// Python through a C ABI (ctypes — no pybind11 in this image); the
// Python side lives in paddle_tpu/recordio.py.
//
// On-disk layout per chunk:
//   u32 magic (0x50445452 "PDTR") | u32 flags (bit0: zlib)
//   u32 num_records | u32 raw_len | u32 stored_len | u32 crc32(stored)
//   payload[stored_len]   (payload = concat of (u32 len | bytes) records,
//                          zlib-deflated when flags&1)
//
// The writer batches records into ~1MB chunks (same default spirit as
// the reference's chunk.h); the scanner streams chunks and yields
// records without loading the whole file.

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x50445452;  // "PDTR"
constexpr size_t kDefaultChunkBytes = 1 << 20;

struct Writer {
  FILE* f = nullptr;
  bool compress = false;
  size_t chunk_limit = kDefaultChunkBytes;
  std::vector<uint8_t> buf;  // packed (len|bytes) records
  uint32_t num_records = 0;
  bool error = false;
};

struct Scanner {
  FILE* f = nullptr;
  std::vector<uint8_t> payload;  // current chunk, decompressed
  size_t pos = 0;                // cursor into payload
  uint32_t remaining = 0;        // records left in current chunk
  bool error = false;
};

bool write_u32(FILE* f, uint32_t v) { return fwrite(&v, 4, 1, f) == 1; }
bool read_u32(FILE* f, uint32_t* v) { return fread(v, 4, 1, f) == 1; }

bool flush_chunk(Writer* w) {
  if (w->num_records == 0) return true;
  const std::vector<uint8_t>& raw = w->buf;
  std::vector<uint8_t> deflated;
  const std::vector<uint8_t>* stored = &raw;
  uint32_t flags = 0;
  if (w->compress) {
    uLongf bound = compressBound(raw.size());
    deflated.resize(bound);
    if (compress2(deflated.data(), &bound, raw.data(), raw.size(),
                  Z_DEFAULT_COMPRESSION) != Z_OK) {
      return false;
    }
    deflated.resize(bound);
    stored = &deflated;
    flags |= 1;
  }
  uint32_t crc = crc32(0L, stored->data(), stored->size());
  bool ok = write_u32(w->f, kMagic) && write_u32(w->f, flags) &&
            write_u32(w->f, w->num_records) &&
            write_u32(w->f, static_cast<uint32_t>(raw.size())) &&
            write_u32(w->f, static_cast<uint32_t>(stored->size())) &&
            write_u32(w->f, crc) &&
            fwrite(stored->data(), 1, stored->size(), w->f) == stored->size();
  w->buf.clear();
  w->num_records = 0;
  return ok;
}

bool load_chunk(Scanner* s) {
  uint32_t magic, flags, num, raw_len, stored_len, crc;
  if (!read_u32(s->f, &magic)) return false;  // clean EOF
  if (magic != kMagic || !read_u32(s->f, &flags) || !read_u32(s->f, &num) ||
      !read_u32(s->f, &raw_len) || !read_u32(s->f, &stored_len) ||
      !read_u32(s->f, &crc)) {
    s->error = true;
    return false;
  }
  std::vector<uint8_t> stored(stored_len);
  if (fread(stored.data(), 1, stored_len, s->f) != stored_len) {
    s->error = true;
    return false;
  }
  if (crc32(0L, stored.data(), stored.size()) != crc) {
    s->error = true;
    return false;
  }
  if (flags & 1) {
    s->payload.resize(raw_len);
    uLongf out_len = raw_len;
    if (uncompress(s->payload.data(), &out_len, stored.data(), stored.size()) !=
            Z_OK ||
        out_len != raw_len) {
      s->error = true;
      return false;
    }
  } else {
    s->payload = std::move(stored);
  }
  s->pos = 0;
  s->remaining = num;
  return true;
}

}  // namespace

extern "C" {

void* rio_writer_open(const char* path, int compress, int chunk_bytes) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  Writer* w = new Writer();
  w->f = f;
  w->compress = compress != 0;
  if (chunk_bytes > 0) w->chunk_limit = static_cast<size_t>(chunk_bytes);
  return w;
}

int rio_writer_write(void* handle, const uint8_t* data, uint32_t len) {
  Writer* w = static_cast<Writer*>(handle);
  uint8_t hdr[4];
  memcpy(hdr, &len, 4);
  w->buf.insert(w->buf.end(), hdr, hdr + 4);
  w->buf.insert(w->buf.end(), data, data + len);
  w->num_records++;
  if (w->buf.size() >= w->chunk_limit) {
    if (!flush_chunk(w)) {
      w->error = true;
      return -1;
    }
  }
  return 0;
}

int rio_writer_close(void* handle) {
  Writer* w = static_cast<Writer*>(handle);
  int rc = 0;
  if (!flush_chunk(w)) rc = -1;
  if (w->error) rc = -1;
  fclose(w->f);
  delete w;
  return rc;
}

void* rio_scanner_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  Scanner* s = new Scanner();
  s->f = f;
  return s;
}

// Returns record length and sets *out to an internal pointer valid until
// the next call; returns -1 on EOF, -2 on corruption.
int64_t rio_scanner_next(void* handle, const uint8_t** out) {
  Scanner* s = static_cast<Scanner*>(handle);
  if (s->remaining == 0) {
    if (!load_chunk(s)) return s->error ? -2 : -1;
  }
  if (s->pos + 4 > s->payload.size()) {
    s->error = true;
    return -2;
  }
  uint32_t len;
  memcpy(&len, s->payload.data() + s->pos, 4);
  s->pos += 4;
  if (s->pos + len > s->payload.size()) {
    s->error = true;
    return -2;
  }
  *out = s->payload.data() + s->pos;
  s->pos += len;
  s->remaining--;
  return static_cast<int64_t>(len);
}

void rio_scanner_close(void* handle) {
  Scanner* s = static_cast<Scanner*>(handle);
  fclose(s->f);
  delete s;
}

}  // extern "C"
