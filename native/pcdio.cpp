// Native PCD decoder for datmo_using_optical_flow.
//
// The reference delegates point-cloud I/O to Open3D's C++ readers
// (Optical_flow/main.py:60, GMFA/GMFA.py:32). This is the equivalent native
// component for this framework: a dependency-free PCD 0.7 decoder (ascii and
// binary encodings) exposed over a C ABI consumed via ctypes
// (datmo_using_optical_flow/io/pcd.py). binary_compressed falls back to
// the Python implementation (returns -1).
//
// API:
//   long long pcdio_read_xyz(const char* path, float* out, long long capacity);
//     capacity == 0 / out == nullptr -> returns point count (for sizing).
//     otherwise writes min(points, capacity) xyz triples into out and returns
//     the number written. Returns -1 on error/unsupported encoding.

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Field {
  std::string name;
  int size = 4;
  char type = 'F';
  int count = 1;
};

struct Header {
  std::vector<Field> fields;
  long long points = -1;
  long long width = -1, height = -1;
  std::string data;
  size_t header_end = 0;  // offset where payload starts
};

bool parse_header(const char* buf, size_t len, Header* h) {
  size_t pos = 0;
  std::vector<int> sizes, counts;
  std::vector<char> types;
  std::vector<std::string> names;
  while (pos < len) {
    const char* line = buf + pos;
    const char* nl = static_cast<const char*>(memchr(line, '\n', len - pos));
    if (!nl) return false;
    size_t llen = static_cast<size_t>(nl - line);
    pos += llen + 1;
    if (llen == 0 || line[0] == '#') continue;
    std::string s(line, llen);
    // tokenize
    std::vector<std::string> tok;
    size_t i = 0;
    while (i < s.size()) {
      while (i < s.size() && isspace(static_cast<unsigned char>(s[i]))) i++;
      size_t j = i;
      while (j < s.size() && !isspace(static_cast<unsigned char>(s[j]))) j++;
      if (j > i) tok.emplace_back(s.substr(i, j - i));
      i = j;
    }
    if (tok.empty()) continue;
    std::string key = tok[0];
    for (auto& c : key) c = static_cast<char>(toupper(static_cast<unsigned char>(c)));
    if (key == "FIELDS") {
      names.assign(tok.begin() + 1, tok.end());
    } else if (key == "SIZE") {
      sizes.clear();
      for (size_t k = 1; k < tok.size(); k++) sizes.push_back(atoi(tok[k].c_str()));
    } else if (key == "TYPE") {
      types.clear();
      for (size_t k = 1; k < tok.size(); k++) types.push_back(tok[k][0]);
    } else if (key == "COUNT") {
      counts.clear();
      for (size_t k = 1; k < tok.size(); k++) counts.push_back(atoi(tok[k].c_str()));
    } else if (key == "WIDTH") {
      h->width = atoll(tok[1].c_str());
    } else if (key == "HEIGHT") {
      h->height = atoll(tok[1].c_str());
    } else if (key == "POINTS") {
      h->points = atoll(tok[1].c_str());
    } else if (key == "DATA") {
      h->data = tok[1];
      h->header_end = pos;
      break;
    }
  }
  if (h->data.empty() || names.empty() || sizes.size() != names.size() ||
      types.size() != names.size())
    return false;
  if (counts.empty()) counts.assign(names.size(), 1);
  if (counts.size() != names.size()) return false;
  for (size_t k = 0; k < names.size(); k++) {
    Field f;
    f.name = names[k];
    f.size = sizes[k];
    f.type = types[k];
    f.count = counts[k];
    h->fields.push_back(f);
  }
  if (h->points < 0) {
    if (h->width >= 0 && h->height >= 0)
      h->points = h->width * h->height;
    else
      return false;
  }
  return true;
}

double read_scalar(const char* p, char type, int size) {
  switch (type) {
    case 'F':
      if (size == 4) { float v; memcpy(&v, p, 4); return v; }
      if (size == 8) { double v; memcpy(&v, p, 8); return v; }
      break;
    case 'I':
      if (size == 1) { int8_t v; memcpy(&v, p, 1); return v; }
      if (size == 2) { int16_t v; memcpy(&v, p, 2); return v; }
      if (size == 4) { int32_t v; memcpy(&v, p, 4); return v; }
      break;
    case 'U':
      if (size == 1) { uint8_t v; memcpy(&v, p, 1); return v; }
      if (size == 2) { uint16_t v; memcpy(&v, p, 2); return v; }
      if (size == 4) { uint32_t v; memcpy(&v, p, 4); return v; }
      break;
  }
  return 0.0;
}

}  // namespace

extern "C" long long pcdio_read_xyz(const char* path, float* out,
                                    long long capacity) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (fsize <= 0) { fclose(f); return -1; }
  std::vector<char> buf(static_cast<size_t>(fsize));
  if (fread(buf.data(), 1, buf.size(), f) != buf.size()) { fclose(f); return -1; }
  fclose(f);

  Header h;
  if (!parse_header(buf.data(), buf.size(), &h)) return -1;
  if (h.data != "ascii" && h.data != "binary") return -1;  // python fallback

  if (out == nullptr || capacity <= 0) return h.points;
  long long n = h.points < capacity ? h.points : capacity;

  // column layout
  int xi = -1, yi = -1, zi = -1;
  int xoff = 0, yoff = 0, zoff = 0;  // byte offsets (binary) / column idx (ascii)
  int stride = 0, ncols = 0;
  {
    int boff = 0, col = 0;
    for (size_t k = 0; k < h.fields.size(); k++) {
      const Field& fl = h.fields[k];
      if (fl.count == 1) {
        if (fl.name == "x") { xi = static_cast<int>(k); xoff = boff; }
        if (fl.name == "y") { yi = static_cast<int>(k); yoff = boff; }
        if (fl.name == "z") { zi = static_cast<int>(k); zoff = boff; }
      }
      if (fl.name == "x" && fl.count == 1) xoff = h.data == "ascii" ? col : boff;
      if (fl.name == "y" && fl.count == 1) yoff = h.data == "ascii" ? col : boff;
      if (fl.name == "z" && fl.count == 1) zoff = h.data == "ascii" ? col : boff;
      boff += fl.size * fl.count;
      col += fl.count;
    }
    stride = boff;
    ncols = col;
  }
  if (xi < 0 || yi < 0 || zi < 0) return -1;

  if (h.data == "binary") {
    const char* p = buf.data() + h.header_end;
    size_t avail = buf.size() - h.header_end;
    if (avail < static_cast<size_t>(stride) * static_cast<size_t>(n)) return -1;
    const Field& fx = h.fields[static_cast<size_t>(xi)];
    const Field& fy = h.fields[static_cast<size_t>(yi)];
    const Field& fz = h.fields[static_cast<size_t>(zi)];
    bool fast = fx.type == 'F' && fx.size == 4 && fy.type == 'F' && fy.size == 4 &&
                fz.type == 'F' && fz.size == 4;
    for (long long i = 0; i < n; i++) {
      const char* rec = p + static_cast<size_t>(i) * stride;
      if (fast) {
        memcpy(&out[i * 3 + 0], rec + xoff, 4);
        memcpy(&out[i * 3 + 1], rec + yoff, 4);
        memcpy(&out[i * 3 + 2], rec + zoff, 4);
      } else {
        out[i * 3 + 0] = static_cast<float>(read_scalar(rec + xoff, fx.type, fx.size));
        out[i * 3 + 1] = static_cast<float>(read_scalar(rec + yoff, fy.type, fy.size));
        out[i * 3 + 2] = static_cast<float>(read_scalar(rec + zoff, fz.type, fz.size));
      }
    }
    return n;
  }

  // ascii
  const char* p = buf.data() + h.header_end;
  const char* end = buf.data() + buf.size();
  for (long long i = 0; i < n; i++) {
    for (int c = 0; c < ncols; c++) {
      char* next = nullptr;
      double v = strtod(p, &next);
      if (next == p) {  // skip junk
        while (p < end && !isspace(static_cast<unsigned char>(*p))) p++;
        while (p < end && isspace(static_cast<unsigned char>(*p))) p++;
        v = 0.0;
      } else {
        p = next;
      }
      if (c == xoff) out[i * 3 + 0] = static_cast<float>(v);
      if (c == yoff) out[i * 3 + 1] = static_cast<float>(v);
      if (c == zoff) out[i * 3 + 2] = static_cast<float>(v);
      if (p >= end) return (c == ncols - 1) ? i + 1 : i;
    }
  }
  return n;
}
