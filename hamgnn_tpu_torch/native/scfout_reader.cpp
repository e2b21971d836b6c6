// scfout_reader: OpenMX SCFOUT v3 parser -> JSON, the port's native reader.
//
// The layout is that of native/scfout_reader.cpp (header, periodic-image
// tables, per-atom orbital and neighbour tables, Hks[spin], iHks for
// SpinP_switch 3, OLP, the postprocess extensions D_OLP / OLP_L, DM / iDM,
// solver and trailer).  Unlike that reader, whose HS.json prints blocks with
// ten decimals (the reference reader's format), this one prints every double
// as %.16e, which reads back to the same bits, and adds what
// hamgnn_tpu_torch.interfaces.openmx.ScfoutData holds besides the blocks:
// spinp_switch, cell, num_orbs, dSon / dSoff, chemp and valence_electrons.
// The Python parser (interfaces/openmx.py parse_scfout) and this reader must
// give element-identical ScfoutData.
//
// Usage: scfout_reader <file.scfout> <out.json> [--standard]
//   --standard: plain OpenMX 3.9 layout without the D_OLP/OLP_L sections.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Reader {
  std::vector<char> buf;
  size_t ofs = 0;
  bool swap = false;

  void need(size_t n) const {
    if (ofs + n > buf.size()) {
      std::fprintf(stderr, "scfout_reader: truncated file (need %zu at %zu)\n", n, ofs);
      std::exit(1);
    }
  }
  template <typename T> T one() {
    need(sizeof(T));
    T v;
    std::memcpy(&v, buf.data() + ofs, sizeof(T));
    ofs += sizeof(T);
    if (swap) {
      char* p = reinterpret_cast<char*>(&v);
      for (size_t b = 0; b < sizeof(T) / 2; ++b) std::swap(p[b], p[sizeof(T) - 1 - b]);
    }
    return v;
  }
  std::vector<int32_t> ints(size_t n) {
    std::vector<int32_t> out(n);
    for (size_t i = 0; i < n; ++i) out[i] = one<int32_t>();
    return out;
  }
  std::vector<double> doubles(size_t n) {
    std::vector<double> out(n);
    for (size_t i = 0; i < n; ++i) out[i] = one<double>();
    return out;
  }
};

struct PairBlocks {
  std::vector<std::vector<double>> on;   // h == 0
  std::vector<std::vector<double>> off;  // h >= 1, edge order
};

struct EdgeKey {
  int32_t a, b, sx, sy, sz;
  bool operator==(const EdgeKey& o) const {
    return a == o.a && b == o.b && sx == o.sx && sy == o.sy && sz == o.sz;
  }
};
struct EdgeKeyHash {
  size_t operator()(const EdgeKey& k) const {
    size_t h = std::hash<int64_t>()((int64_t)k.a << 32 | (uint32_t)k.b);
    h ^= std::hash<int64_t>()(((int64_t)(k.sx + 512) << 40) |
                              ((int64_t)(k.sy + 512) << 20) | (k.sz + 512)) +
         0x9e3779b9 + (h << 6);
    return h;
  }
};

// %.16e: 17 significant digits (round-trips a double) and always an exponent,
// so that JSON reads a float and keeps the sign of a zero
void print_doubles(std::FILE* f, const double* v, size_t n) {
  std::fputc('[', f);
  for (size_t i = 0; i < n; ++i) std::fprintf(f, i ? ",%.16e" : "%.16e", v[i]);
  std::fputc(']', f);
}

void print_rows(std::FILE* f, const std::vector<std::vector<double>>& rows) {
  std::fputc('[', f);
  for (size_t n = 0; n < rows.size(); ++n) {
    if (n) std::fputc(',', f);
    print_doubles(f, rows[n].data(), rows[n].size());
  }
  std::fputc(']', f);
}

void print_spins(std::FILE* f, const char* key, const std::vector<PairBlocks>& s, bool on) {
  std::fprintf(f, ",\n\"%s\": [", key);
  for (size_t i = 0; i < s.size(); ++i) {
    if (i) std::fputc(',', f);
    print_rows(f, on ? s[i].on : s[i].off);
  }
  std::fputc(']', f);
}

void print_ints(std::FILE* f, const char* key, const std::vector<int32_t>& v) {
  std::fprintf(f, ",\n\"%s\": [", key);
  for (size_t i = 0; i < v.size(); ++i) std::fprintf(f, i ? ",%d" : "%d", v[i]);
  std::fputc(']', f);
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 3) {
    std::fprintf(stderr, "usage: scfout_reader <file.scfout> <out.json> [--standard]\n");
    return 2;
  }
  const char* path = argv[1];
  std::string out_path;
  bool postprocess_ext = true;
  for (int i = 2; i < argc; ++i) {
    if (std::string(argv[i]) == "--standard") postprocess_ext = false;
    else out_path = argv[i];
  }

  Reader r;
  {
    std::ifstream f(path, std::ios::binary | std::ios::ate);
    if (!f) { std::fprintf(stderr, "cannot open %s\n", path); return 1; }
    size_t size = (size_t)f.tellg();
    f.seekg(0);
    r.buf.resize(size);
    f.read(r.buf.data(), (std::streamsize)size);
  }

  auto head = r.ints(6);
  if (head[1] < 0 || head[1] > 15) {  // byte order: the spin/version word is small
    r.swap = true;
    r.ofs = 0;
    head = r.ints(6);
    if (head[1] < 0 || head[1] > 15) {
      std::fprintf(stderr, "endianness mismatch\n");
      return 1;
    }
  }
  const int atomnum = head[0];
  const int spinp = head[1] % 4;
  const int version = head[1] / 4;
  const int tcpycell = head[5];
  if (version != 3) {
    std::fprintf(stderr, "unsupported scfout version %d (need 3)\n", version);
    return 1;
  }

  r.ints(1);  // order_max
  std::vector<double> atv((size_t)(tcpycell + 1) * 4);
  for (auto& v : atv) v = r.one<double>();
  std::vector<int32_t> atv_ijk((size_t)(tcpycell + 1) * 4);
  for (auto& v : atv_ijk) v = r.one<int32_t>();

  auto num_orbs = r.ints(atomnum);
  auto fnan = r.ints(atomnum);
  std::vector<std::vector<int32_t>> natn(atomnum), ncn(atomnum);
  for (int a = 0; a < atomnum; ++a) natn[a] = r.ints((size_t)fnan[a] + 1);
  for (int a = 0; a < atomnum; ++a) ncn[a] = r.ints((size_t)fnan[a] + 1);
  std::vector<double> cell(9);
  for (int i = 0; i < 3; ++i) {
    auto g = r.doubles(4);
    for (int k = 0; k < 3; ++k) cell[3 * i + k] = g[k + 1];
  }
  r.doubles(12);  // rtv
  std::vector<double> pos((size_t)atomnum * 3);
  for (int a = 0; a < atomnum; ++a) {
    auto g = r.doubles(4);
    for (int k = 0; k < 3; ++k) pos[3 * a + k] = g[k + 1];
  }

  auto read_pair_blocks = [&](int vec) {
    PairBlocks out;
    for (int a = 0; a < atomnum; ++a) {
      int no1 = num_orbs[a];
      for (int h = 0; h <= fnan[a]; ++h) {
        int no2 = num_orbs[natn[a][h] - 1];
        auto blk = r.doubles((size_t)no1 * no2 * vec);
        (h == 0 ? out.on : out.off).push_back(std::move(blk));
      }
    }
    return out;
  };

  std::vector<PairBlocks> hks, ihks;
  for (int s = 0; s <= spinp; ++s) hks.push_back(read_pair_blocks(1));
  if (spinp == 3)
    for (int s = 0; s < 3; ++s) ihks.push_back(read_pair_blocks(1));
  PairBlocks olp = read_pair_blocks(1);
  PairBlocks dolp, olp_l;
  if (postprocess_ext) {
    dolp = read_pair_blocks(3);   // overlap derivatives
    olp_l = read_pair_blocks(3);  // angular-momentum matrices
  }
  for (int s = 0; s <= spinp; ++s) read_pair_blocks(1);  // DM
  for (int s = 0; s < 2; ++s) read_pair_blocks(1);       // iDM
  r.ints(1);                                             // solver
  auto trailer = r.doubles(10);

  std::vector<int32_t> esrc, edst, eshift;
  std::vector<double> enshift;
  for (int a = 0; a < atomnum; ++a)
    for (int h = 1; h <= fnan[a]; ++h) {
      esrc.push_back(a);
      edst.push_back(natn[a][h] - 1);
      int rn = ncn[a][h];
      for (int k = 1; k <= 3; ++k) {
        eshift.push_back(atv_ijk[4 * rn + k]);
        enshift.push_back(atv[4 * rn + k]);
      }
    }
  const size_t E = esrc.size();

  std::unordered_map<EdgeKey, int32_t, EdgeKeyHash> emap;
  emap.reserve(E * 2);
  for (size_t e = 0; e < E; ++e)
    emap[{esrc[e], edst[e], eshift[3 * e], eshift[3 * e + 1], eshift[3 * e + 2]}] = (int32_t)e;
  std::vector<int32_t> inv(E);
  for (size_t e = 0; e < E; ++e) {
    auto it = emap.find({edst[e], esrc[e], -eshift[3 * e], -eshift[3 * e + 1],
                         -eshift[3 * e + 2]});
    if (it == emap.end()) {
      std::fprintf(stderr, "edge %zu has no inverse\n", e);
      return 1;
    }
    inv[e] = it->second;
  }

  std::FILE* f = std::fopen(out_path.c_str(), "w");
  if (!f) { std::fprintf(stderr, "cannot write %s\n", out_path.c_str()); return 1; }
  std::fprintf(f, "{\n\"spinp_switch\": %d", spinp);
  std::fprintf(f, ",\n\"cell\": ");
  print_doubles(f, cell.data(), 9);
  std::fprintf(f, ",\n\"pos\": ");
  print_doubles(f, pos.data(), pos.size());
  print_ints(f, "num_orbs", num_orbs);
  print_ints(f, "edge_src", esrc);
  print_ints(f, "edge_dst", edst);
  print_ints(f, "cell_shift", eshift);
  print_ints(f, "inv_edge_idx", inv);
  std::fprintf(f, ",\n\"nbr_shift\": ");
  print_doubles(f, enshift.data(), enshift.size());
  print_spins(f, "Hon", hks, true);
  print_spins(f, "Hoff", hks, false);
  if (!ihks.empty()) {
    print_spins(f, "iHon", ihks, true);
    print_spins(f, "iHoff", ihks, false);
  }
  std::fprintf(f, ",\n\"Son\": ");
  print_rows(f, olp.on);
  std::fprintf(f, ",\n\"Soff\": ");
  print_rows(f, olp.off);
  if (postprocess_ext) {
    const char* keys[4] = {"dSon", "dSoff", "Lon", "Loff"};
    const std::vector<std::vector<double>>* rows[4] = {&dolp.on, &dolp.off, &olp_l.on,
                                                       &olp_l.off};
    for (int k = 0; k < 4; ++k) {
      std::fprintf(f, ",\n\"%s\": ", keys[k]);
      print_rows(f, *rows[k]);
    }
  }
  std::fprintf(f, ",\n\"chemp\": %.16e,\n\"valence_electrons\": %.16e\n}\n", trailer[0],
               trailer[8]);
  std::fclose(f);
  return 0;
}
