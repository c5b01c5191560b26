// GCT data-block parser/formatter -- the port's own copy of
// nmfx/native/gct_io.cpp.
//
// std::from_chars parsing and std::to_chars shortest-exact formatting
// (bit-roundtrip for float64) of the numeric block of a GCT file; names and
// headers stay in Python (nmfx_torch/io.py). The formatter's bytes are those
// of io.py's Python formatter (_to_chars_double), which is kept as its named
// reference and cross-tested in tests/test_torch_native.py.
//
// Built with the host compiler at first use by nmfx_torch/native/__init__.py
// (g++ -O3 -std=c++17 -fPIC -shared, no dependencies) into
// nmfx_torch/_build/.

#include <charconv>
#include <cstdint>
#include <cstring>

extern "C" {

// Parse the numeric part of GCT data rows.
// buf[0..len): the file content after the three header lines; rows are
//   name \t description \t v1 \t ... \t v_{n_cols}, separated by '\n'
//   (blank lines skipped, final newline optional).
// out: n_rows * n_cols doubles (row-major).
// n_seen: receives the number of non-blank rows encountered.
// Returns 0 on success; r > 0 means data row r (1-based) was malformed.
// Stops after n_rows parsed rows (extra rows are counted in n_seen only).
int64_t nmfx_parse_gct_rows(const char* buf, int64_t len, int64_t n_rows,
                            int64_t n_cols, double* out, int64_t* n_seen) {
  const char* p = buf;
  const char* end = buf + len;
  int64_t row = 0;
  *n_seen = 0;
  while (p < end) {
    if (*p == '\n' || *p == '\r') {  // blank line
      ++p;
      continue;
    }
    const char* line_end = static_cast<const char*>(
        memchr(p, '\n', static_cast<size_t>(end - p)));
    if (line_end == nullptr) line_end = end;
    ++*n_seen;
    if (row < n_rows) {
      // skip the two leading text fields (name, description)
      for (int f = 0; f < 2; ++f) {
        const char* tab = static_cast<const char*>(
            memchr(p, '\t', static_cast<size_t>(line_end - p)));
        if (tab == nullptr) return row + 1;
        p = tab + 1;
      }
      double* dst = out + row * n_cols;
      for (int64_t c = 0; c < n_cols; ++c) {
        if (p < line_end && *p == '+') ++p;  // from_chars rejects '+1.5'
        auto res = std::from_chars(p, line_end, dst[c]);
        if (res.ec != std::errc()) return row + 1;
        p = res.ptr;
        if (c + 1 < n_cols) {
          if (p >= line_end || *p != '\t') return row + 1;
          ++p;
        }
      }
      // after the n_cols values: end of line (optionally '\r'), or extra
      // trailing fields, which are ignored as the reference reader does
      // (it takes fields[2 : 2+n_cols])
      if (p < line_end && *p != '\t' && !(*p == '\r' && p + 1 == line_end))
        return row + 1;
      ++row;
    }
    p = (line_end < end) ? line_end + 1 : end;
  }
  return 0;
}

// Format the complete GCT data block: for each row, copy its prefix bytes
// (the caller-prepared "name\tdescription\t"), then the n_cols values
// tab-separated in shortest exact representation (std::to_chars), then
// '\n'. prefixes is the concatenation of all row prefixes;
// prefix_ends[r] is the exclusive end offset of row r's prefix.
// Returns the number of bytes written, or -1 if out_cap could be exceeded.
int64_t nmfx_format_gct_body(const double* vals, int64_t n_rows,
                             int64_t n_cols, const char* prefixes,
                             const int64_t* prefix_ends, char* out,
                             int64_t out_cap) {
  char* p = out;
  char* cap = out + out_cap;
  int64_t pref_start = 0;
  for (int64_t r = 0; r < n_rows; ++r) {
    const int64_t pref_len = prefix_ends[r] - pref_start;
    if (pref_len < 0 || cap - p < pref_len) return -1;
    memcpy(p, prefixes + pref_start, static_cast<size_t>(pref_len));
    p += pref_len;
    pref_start = prefix_ends[r];
    const double* row = vals + r * n_cols;
    for (int64_t c = 0; c < n_cols; ++c) {
      if (cap - p < 32) return -1;
      auto res = std::to_chars(p, cap, row[c]);
      if (res.ec != std::errc()) return -1;
      p = res.ptr;
      *p++ = (c + 1 < n_cols) ? '\t' : '\n';
    }
    if (n_cols == 0) {  // the Python formatter ends an empty row too
      if (cap - p < 1) return -1;
      *p++ = '\n';
    }
  }
  return p - out;
}

}  // extern "C"
