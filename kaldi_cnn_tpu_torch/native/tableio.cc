// Native Table I/O scanner for ark archives.
//
// C++ re-implementation of the hot host path of the reference's Table
// I/O layer (src/util/kaldi-table-inl.h SequentialTableReader /
// RandomAccessTableReader over binary arks): one pass over the archive
// records every entry's key, payload offset, shape and dtype, so the
// Python layer can serve sequential or random access via zero-copy
// numpy views of a single mmap — no per-entry parsing in Python.
//
// Payload encoding matches io/kaldi_io.py (_write_value_binary):
//   <key> ' ' \0B  FM|DM ' ' \4<rows> \4<cols> <raw>
//                  FV|DV ' ' \4<dim> <raw>
//                  \4<n> (\4<int32>)*n          (int vector)
//
// Exposed as a C ABI for ctypes with a Python fallback.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  bool eof() const { return p >= end; }
  uint8_t take() {
    if (p >= end) { ok = false; return 0; }
    return *p++;
  }
  bool expect(uint8_t c) {
    if (p >= end || *p != c) { ok = false; return false; }
    ++p;
    return true;
  }
  int32_t take_i32() {
    if (!expect(4)) return 0;
    if (end - p < 4) { ok = false; return 0; }
    int32_t v;
    std::memcpy(&v, p, 4);
    p += 4;
    return v;
  }
  bool skip(int64_t n) {
    if (end - p < n) { ok = false; return false; }
    p += n;
    return true;
  }
};

}  // namespace

extern "C" {

// dtype codes shared with the Python binding:
// 0=f32 matrix, 1=f64 matrix, 2=f32 vector, 3=f64 vector, 4=int32 vector
// (int vectors are stored with \4 size bytes per element, so their
// payload stride is 5 bytes per value; the binding decodes them).
int64_t kct_ark_index(const uint8_t* data, int64_t size,
                      int64_t max_entries,
                      int64_t* key_off, int32_t* key_len,
                      int64_t* payload_off, int32_t* rows, int32_t* cols,
                      int32_t* dtype) {
  Cursor c{data, data + size};
  int64_t n = 0;
  while (!c.eof() && n < max_entries) {
    // key token up to ' '
    const uint8_t* key_start = c.p;
    while (!c.eof() && *c.p != ' ') ++c.p;
    if (c.eof()) return -1;
    key_off[n] = key_start - data;
    key_len[n] = static_cast<int32_t>(c.p - key_start);
    ++c.p;  // the space
    if (!c.expect(0) || !c.expect('B')) return -1;
    if (c.eof()) return -1;
    if (*c.p == 4) {
      // int32 vector: n then n size-tagged ints
      int32_t cnt = c.take_i32();
      payload_off[n] = c.p - data;
      rows[n] = cnt;
      cols[n] = 1;
      dtype[n] = 4;
      if (!c.skip(static_cast<int64_t>(cnt) * 5)) return -1;
    } else {
      char t0 = static_cast<char>(c.take());
      char t1 = static_cast<char>(c.take());
      if (!c.expect(' ')) return -1;
      int64_t elem = (t0 == 'D') ? 8 : 4;
      if (t1 == 'M') {
        int32_t r = c.take_i32();
        int32_t cl = c.take_i32();
        payload_off[n] = c.p - data;
        rows[n] = r;
        cols[n] = cl;
        dtype[n] = (t0 == 'D') ? 1 : 0;
        if (!c.skip(static_cast<int64_t>(r) * cl * elem)) return -1;
      } else if (t1 == 'V') {
        int32_t d = c.take_i32();
        payload_off[n] = c.p - data;
        rows[n] = d;
        cols[n] = 1;
        dtype[n] = (t0 == 'D') ? 3 : 2;
        if (!c.skip(static_cast<int64_t>(d) * elem)) return -1;
      } else {
        return -1;
      }
    }
    if (!c.ok) return -1;
    ++n;
  }
  return c.ok ? n : -1;
}

// Decode an int32 vector payload (size-tagged elements) into out[].
int32_t kct_ark_read_ivec(const uint8_t* payload, int32_t count,
                          int32_t* out) {
  const uint8_t* p = payload;
  for (int32_t i = 0; i < count; ++i) {
    if (*p != 4) return -1;
    std::memcpy(&out[i], p + 1, 4);
    p += 5;
  }
  return 0;
}

}  // extern "C"
