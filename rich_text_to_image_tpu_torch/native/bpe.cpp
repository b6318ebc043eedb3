// Native BPE merge core for the CLIP tokenizer.
//
// The port's own copy of the JAX package's merge loop: the byte-pair merge
// (the only per-character hot path on the host side) in C++, used by
// models/tokenizer.py through ctypes with the Python loop as its fallback,
// and held against that loop in tests/test_torch_port_native_bpe.py.
//
// C API (all strings are UTF-8; symbols are the printable byte-unit chars of
// the CLIP byte encoder):
//   void*  bpe_create();
//   void   bpe_destroy(void*);
//   void   bpe_add_merge(void*, const char* left, const char* right, int rank);
//   int    bpe_encode_word(void*, const char* word, char* out, int out_cap);
//          — word: byte-encoded token WITHOUT </w>; writes the merged
//            symbols space-separated (last one carrying "</w>") into out;
//            returns the number of symbols, or -1 on overflow.

#include <cstring>
#include <limits>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct PairHash {
  size_t operator()(const std::pair<std::string, std::string>& p) const {
    return std::hash<std::string>()(p.first) * 1000003 ^
           std::hash<std::string>()(p.second);
  }
};

struct BPE {
  std::unordered_map<std::pair<std::string, std::string>, int, PairHash> ranks;
};

// Split a UTF-8 string into code points (as byte strings).
std::vector<std::string> utf8_chars(const char* s) {
  std::vector<std::string> out;
  const unsigned char* p = reinterpret_cast<const unsigned char*>(s);
  while (*p) {
    int len = 1;
    if ((*p & 0x80) == 0x00) len = 1;
    else if ((*p & 0xE0) == 0xC0) len = 2;
    else if ((*p & 0xF0) == 0xE0) len = 3;
    else if ((*p & 0xF8) == 0xF0) len = 4;
    out.emplace_back(reinterpret_cast<const char*>(p), len);
    p += len;
  }
  return out;
}

}  // namespace

extern "C" {

void* bpe_create() { return new BPE(); }

void bpe_destroy(void* h) { delete static_cast<BPE*>(h); }

void bpe_add_merge(void* h, const char* left, const char* right, int rank) {
  static_cast<BPE*>(h)->ranks[{left, right}] = rank;
}

int bpe_encode_word(void* h, const char* word, char* out, int out_cap) {
  BPE* bpe = static_cast<BPE*>(h);
  std::vector<std::string> sym = utf8_chars(word);
  if (sym.empty()) return 0;
  sym.back() += "</w>";

  while (sym.size() > 1) {
    // find the lowest-rank adjacent pair
    int best_rank = std::numeric_limits<int>::max();
    size_t best_i = 0;
    for (size_t i = 0; i + 1 < sym.size(); ++i) {
      auto it = bpe->ranks.find({sym[i], sym[i + 1]});
      if (it != bpe->ranks.end() && it->second < best_rank) {
        best_rank = it->second;
        best_i = i;
      }
    }
    if (best_rank == std::numeric_limits<int>::max()) break;
    // merge every occurrence of that pair, left to right (BPE semantics)
    const std::string first = sym[best_i], second = sym[best_i + 1];
    std::vector<std::string> merged;
    merged.reserve(sym.size());
    for (size_t i = 0; i < sym.size();) {
      if (i + 1 < sym.size() && sym[i] == first && sym[i + 1] == second) {
        merged.push_back(first + second);
        i += 2;
      } else {
        merged.push_back(sym[i]);
        i += 1;
      }
    }
    sym.swap(merged);
  }

  size_t pos = 0;
  for (size_t i = 0; i < sym.size(); ++i) {
    size_t need = sym[i].size() + (i + 1 < sym.size() ? 1 : 0);
    if (pos + need + 1 > static_cast<size_t>(out_cap)) return -1;
    std::memcpy(out + pos, sym[i].data(), sym[i].size());
    pos += sym[i].size();
    if (i + 1 < sym.size()) out[pos++] = ' ';
  }
  out[pos] = '\0';
  return static_cast<int>(sym.size());
}

}  // extern "C"
