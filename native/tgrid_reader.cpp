// Native TGRID (.msh) parser.
//
// Host-side counterpart of orc_cfd/mesh/tgrid.py for large meshes: the
// pure-Python section parser is fine at 10^4 faces but becomes the
// preprocessing bottleneck at 10^7. Same grammar coverage (see the
// Python module's docstring; reference reader: io.rs:32-284): nodes,
// cell zones, face sections with hexadecimal indices, zone-name
// comments and (39/45) name sections, mixed/polygonal face types.
//
// C ABI consumed by orc_cfd/mesh/native.py via ctypes. Build:
//   g++ -O2 -shared -fPIC -o libtgrid.so tgrid_reader.cpp

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Zone {
  int64_t id;
  int64_t bc_type;
  std::string name;
};

struct MeshData {
  int dim = 0;
  std::vector<double> points;        // [N*3]
  std::vector<int64_t> face_counts;  // [F]
  std::vector<int64_t> face_nodes;   // concatenated, 0-based
  std::vector<int64_t> face_cells;   // [F*2], -1 = none
  std::vector<int64_t> face_zone;    // [F]
  std::vector<Zone> zones;
  std::vector<int64_t> periodic_pairs;  // [P*2] 0-based (face, shadow)
  int64_t n_cells = 0;
};

thread_local std::string g_error;

class Lexer {
 public:
  Lexer(const char* data, size_t len) : p_(data), end_(data + len) {}

  // Advance to the next non-space character on the current line; returns
  // false at end of input.
  bool skip_ws() {
    while (p_ < end_ && (*p_ == ' ' || *p_ == '\t' || *p_ == '\r')) ++p_;
    return p_ < end_;
  }

  bool at_eol() const { return p_ >= end_ || *p_ == '\n'; }

  void next_line() {
    while (p_ < end_ && *p_ != '\n') ++p_;
    if (p_ < end_) ++p_;
  }

  const char* pos() const { return p_; }
  const char* end() const { return end_; }
  void set_pos(const char* p) { p_ = p; }

 private:
  const char* p_;
  const char* end_;
};

// Parse a hexadecimal integer starting at *p; advances *p.
inline bool parse_hex(const char*& p, const char* end, int64_t* out) {
  while (p < end && !isxdigit(static_cast<unsigned char>(*p))) {
    if (*p == '\n' || *p == ')') return false;
    ++p;
  }
  if (p >= end) return false;
  int64_t v = 0;
  bool any = false;
  while (p < end) {
    char c = *p;
    int d;
    if (c >= '0' && c <= '9') d = c - '0';
    else if (c >= 'a' && c <= 'f') d = c - 'a' + 10;
    else if (c >= 'A' && c <= 'F') d = c - 'A' + 10;
    else break;
    v = v * 16 + d;
    any = true;
    ++p;
  }
  *out = v;
  return any;
}

// All hexadecimal integers on the current line (section headers).
std::vector<int64_t> header_ints(const char* p, const char* end) {
  std::vector<int64_t> out;
  while (p < end && *p != '\n') {
    if (isxdigit(static_cast<unsigned char>(*p))) {
      int64_t v;
      const char* q = p;
      if (parse_hex(q, end, &v)) out.push_back(v);
      p = q;
    } else {
      ++p;
    }
  }
  return out;
}

MeshData* parse(const char* data, size_t len) {
  auto* m = new MeshData();
  const char* p = data;
  const char* end = data + len;
  std::string zone_comment;
  std::vector<std::pair<int64_t, std::string>> name_sections;

  auto line_end = [&](const char* q) {
    while (q < end && *q != '\n') ++q;
    return q;
  };

  while (p < end) {
    const char* le = line_end(p);
    // Identify section code.
    const char* q = p;
    while (q < le && *q != '(') ++q;
    if (q >= le) { p = le < end ? le + 1 : end; continue; }
    ++q;  // past '('
    char* num_end = nullptr;
    long code = strtol(q, &num_end, 10);
    if (num_end == q) { p = le < end ? le + 1 : end; continue; }

    if (code == 0) {
      // Comment: trailing word names the next zone.
      std::string line(p, le - p);
      size_t close = line.rfind('"');
      size_t space = line.rfind(' ', close == std::string::npos
                                         ? std::string::npos
                                         : close);
      if (space != std::string::npos) {
        std::string name = line.substr(space + 1);
        while (!name.empty() &&
               (name.back() == ')' || name.back() == '"' ||
                name.back() == '\r'))
          name.pop_back();
        zone_comment = name;
      }
      p = le < end ? le + 1 : end;
      continue;
    }

    if (code == 2) {
      auto h = header_ints(p, le);
      if (h.size() >= 2) m->dim = static_cast<int>(h[1]);
      p = le < end ? le + 1 : end;
      continue;
    }

    if (code == 39 || code == 45) {
      // (39 (id type NAME)()) — decimal id, textual fields.
      std::string line(p, le - p);
      size_t open2 = line.find('(', line.find('(') + 1);
      if (open2 != std::string::npos) {
        const char* s = line.c_str() + open2 + 1;
        char* e2;
        long zid = strtol(s, &e2, 10);
        if (e2 != s) {
          // Skip the type token, take the next as name.
          std::string rest(e2);
          size_t a = rest.find_first_not_of(" \t");
          a = rest.find(' ', a);
          if (a != std::string::npos) {
            size_t b = rest.find_first_not_of(" \t", a);
            size_t c = rest.find_first_of(" )\r", b);
            if (b != std::string::npos)
              name_sections.emplace_back(
                  zid, rest.substr(b, c == std::string::npos ? c : c - b));
          }
        }
      }
      p = le < end ? le + 1 : end;
      continue;
    }

    auto h = header_ints(p, le);

    if (code == 10 && h.size() >= 6) {
      int64_t zone = h[1], first = h[2], last = h[3];
      if (zone == 0) {
        if ((size_t)(last * 3) > m->points.size())
          m->points.resize(last * 3, 0.0);
        p = le < end ? le + 1 : end;
        continue;
      }
      if ((size_t)(last * 3) > m->points.size())
        m->points.resize(last * 3, 0.0);
      p = le < end ? le + 1 : end;
      int64_t idx = first - 1;
      while (p < end) {
        const char* l2 = line_end(p);
        const char* s = p;
        while (s < l2 && (*s == ' ' || *s == '\t')) ++s;
        if (s < l2 && *s == ')') { p = l2 < end ? l2 + 1 : end; break; }
        if (s < l2 && *s == '(') { p = l2 < end ? l2 + 1 : end; continue; }
        // Parse up to dim doubles.
        char* e2 = const_cast<char*>(s);
        double x = strtod(s, &e2);
        if (e2 != s) {
          double y = 0, z = 0;
          const char* s2 = e2;
          y = strtod(s2, &e2);
          if (m->dim == 3 && e2 != s2) {
            s2 = e2;
            z = strtod(s2, &e2);
          }
          if (idx >= 0 && (size_t)(idx * 3 + 2) < m->points.size()) {
            m->points[idx * 3 + 0] = x;
            m->points[idx * 3 + 1] = y;
            m->points[idx * 3 + 2] = z;
          }
        }
        ++idx;
        p = l2 < end ? l2 + 1 : end;
      }
      continue;
    }

    if (code == 12 && h.size() >= 5) {
      int64_t zone = h[1], last = h[3];
      if (zone == 0 && last > m->n_cells) m->n_cells = last;
      p = le < end ? le + 1 : end;
      continue;
    }

    if (code == 18) {
      // Periodic shadow-face pairs: body lines "face shadow" in hex,
      // 1-based (the reference reader skips these, io.rs:176-179).
      p = le < end ? le + 1 : end;
      while (p < end) {
        const char* l2 = line_end(p);
        const char* s = p;
        while (s < l2 && (*s == ' ' || *s == '\t')) ++s;
        if (s < l2 && *s == ')') { p = l2 < end ? l2 + 1 : end; break; }
        if (s < l2 && *s == '(' && s + 1 >= l2) {
          p = l2 < end ? l2 + 1 : end;
          continue;
        }
        int64_t a, b;
        const char* q2 = s;
        if (parse_hex(q2, l2, &a) && parse_hex(q2, l2, &b)) {
          m->periodic_pairs.push_back(a - 1);
          m->periodic_pairs.push_back(b - 1);
        }
        p = l2 < end ? l2 + 1 : end;
      }
      continue;
    }

    if (code == 13 && h.size() >= 6) {
      int64_t zone = h[1], first = h[2], last = h[3];
      int64_t bc_type = h[4], face_type = h[5];
      if (zone == 0) {
        p = le < end ? le + 1 : end;
        continue;
      }
      Zone z;
      z.id = zone;
      z.bc_type = bc_type;
      z.name = zone_comment;
      m->zones.push_back(z);

      int64_t expect = last - first + 1;
      size_t fbase = m->face_counts.size();
      m->face_counts.reserve(fbase + expect);
      m->face_cells.reserve((fbase + expect) * 2);
      m->face_zone.reserve(fbase + expect);

      p = le < end ? le + 1 : end;
      while (p < end) {
        const char* l2 = line_end(p);
        const char* s = p;
        while (s < l2 && (*s == ' ' || *s == '\t')) ++s;
        if (s < l2 && *s == ')') { p = l2 < end ? l2 + 1 : end; break; }
        if (s < l2 && (*s == '(' && s + 1 >= l2)) {
          p = l2 < end ? l2 + 1 : end;
          continue;
        }
        // Collect hexadecimal ints on the line.
        std::vector<int64_t> vals;
        const char* q2 = s;
        int64_t v;
        while (q2 < l2) {
          const char* before = q2;
          if (!parse_hex(q2, l2, &v)) break;
          if (q2 == before) break;
          vals.push_back(v);
        }
        if (vals.size() >= 2) {
          size_t cnt;
          size_t node_start;
          if (face_type == 0 || face_type == 5) {
            cnt = static_cast<size_t>(vals[0]);
            node_start = 1;
            if (vals.size() < 1 + cnt + 2) { p = l2 < end ? l2 + 1 : end; continue; }
          } else {
            cnt = vals.size() - 2;
            node_start = 0;
          }
          m->face_counts.push_back(cnt);
          for (size_t i = 0; i < cnt; ++i)
            m->face_nodes.push_back(vals[node_start + i] - 1);
          int64_t c0 = vals[node_start + cnt];
          int64_t c1 = (node_start + cnt + 1 < vals.size())
                           ? vals[node_start + cnt + 1]
                           : 0;
          m->face_cells.push_back(c0 > 0 ? c0 - 1 : -1);
          m->face_cells.push_back(c1 > 0 ? c1 - 1 : -1);
          m->face_zone.push_back(zone);
        }
        p = l2 < end ? l2 + 1 : end;
      }
      continue;
    }

    p = le < end ? le + 1 : end;
  }

  // Fallback names from (39/45) sections.
  for (auto& z : m->zones) {
    if (z.name.empty()) {
      for (auto& ns : name_sections)
        if (ns.first == z.id) { z.name = ns.second; break; }
    }
  }
  // n_cells from face adjacency when no (12 declaration exists.
  for (size_t i = 0; i < m->face_cells.size(); ++i)
    if (m->face_cells[i] + 1 > m->n_cells) m->n_cells = m->face_cells[i] + 1;
  return m;
}

}  // namespace

extern "C" {

void* tgrid_parse(const char* path) {
  g_error.clear();
  FILE* f = fopen(path, "rb");
  if (!f) {
    g_error = "cannot open file";
    return nullptr;
  }
  fseek(f, 0, SEEK_END);
  long len = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf(len, '\0');
  size_t rd = fread(&buf[0], 1, len, f);
  fclose(f);
  if ((long)rd != len) {
    g_error = "short read";
    return nullptr;
  }
  MeshData* m = parse(buf.data(), buf.size());
  if (m->dim != 2 && m->dim != 3) {
    delete m;
    g_error = "mesh is not 2D or 3D";
    return nullptr;
  }
  if (m->face_counts.empty()) {
    delete m;
    g_error = "no faces parsed";
    return nullptr;
  }
  return m;
}

const char* tgrid_error() { return g_error.c_str(); }

int tgrid_dim(void* h) { return static_cast<MeshData*>(h)->dim; }
int64_t tgrid_n_points(void* h) {
  return static_cast<MeshData*>(h)->points.size() / 3;
}
int64_t tgrid_n_faces(void* h) {
  return static_cast<MeshData*>(h)->face_counts.size();
}
int64_t tgrid_n_cells(void* h) { return static_cast<MeshData*>(h)->n_cells; }
int64_t tgrid_total_face_nodes(void* h) {
  return static_cast<MeshData*>(h)->face_nodes.size();
}
void tgrid_points(void* h, double* out) {
  auto* m = static_cast<MeshData*>(h);
  memcpy(out, m->points.data(), m->points.size() * sizeof(double));
}
void tgrid_face_counts(void* h, int64_t* out) {
  auto* m = static_cast<MeshData*>(h);
  memcpy(out, m->face_counts.data(), m->face_counts.size() * sizeof(int64_t));
}
void tgrid_face_nodes(void* h, int64_t* out) {
  auto* m = static_cast<MeshData*>(h);
  memcpy(out, m->face_nodes.data(), m->face_nodes.size() * sizeof(int64_t));
}
void tgrid_face_cells(void* h, int64_t* out) {
  auto* m = static_cast<MeshData*>(h);
  memcpy(out, m->face_cells.data(), m->face_cells.size() * sizeof(int64_t));
}
void tgrid_face_zone(void* h, int64_t* out) {
  auto* m = static_cast<MeshData*>(h);
  memcpy(out, m->face_zone.data(), m->face_zone.size() * sizeof(int64_t));
}
int64_t tgrid_n_periodic(void* h) {
  return static_cast<MeshData*>(h)->periodic_pairs.size() / 2;
}
void tgrid_periodic_pairs(void* h, int64_t* out) {
  auto* m = static_cast<MeshData*>(h);
  memcpy(out, m->periodic_pairs.data(),
         m->periodic_pairs.size() * sizeof(int64_t));
}
int tgrid_n_zones(void* h) {
  return static_cast<int>(static_cast<MeshData*>(h)->zones.size());
}
void tgrid_zone_info(void* h, int i, int64_t* id, int64_t* bc_type,
                     char* name, int name_cap) {
  auto* m = static_cast<MeshData*>(h);
  const Zone& z = m->zones[i];
  *id = z.id;
  *bc_type = z.bc_type;
  snprintf(name, name_cap, "%s", z.name.c_str());
}
void tgrid_free(void* h) { delete static_cast<MeshData*>(h); }

}  // extern "C"
