// Copy of the JAX package's native/src/fst.cc; unchanged below this line.
// Minimal weighted FST runtime (tropical semiring, StdArc layout).
//
// Purpose: load the OpenFST-format artifacts existing deployments already
// have — TLG.fst decoding graphs and WeTextProcessing ITN grammars
// (zh_itn_tagger.fst / zh_itn_verbalizer.fst, the files the reference
// opens at /root/reference/onnxruntime/src/itn-processor.cpp:31-37 and
// include/com-define.h:76-80) — without vendoring OpenFST.
//
// This is NOT an OpenFST port: it is a purpose-built reader for the
// on-disk format (header + vector/const state records; format studied
// from the public OpenFST sources) feeding our own CSR arc storage, plus
// a linear-input composition + shortest-path transducer (the only
// operation the ITN runtime needs: compose(bytes(input), grammar) ->
// shortest path -> output bytes; itn-processor.cpp:53-87).
//
// Weights are tropical floats; "no weight" (non-final) is +inf exactly as
// the format stores it.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <limits>
#include <queue>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr int32_t kFstMagic = 2125659606;
constexpr float kInf = std::numeric_limits<float>::infinity();

struct Arc {
  int32_t ilabel;
  int32_t olabel;
  float weight;
  int32_t next;
};

struct Reader {
  const uint8_t* p;
  size_t n;
  size_t off = 0;
  bool ok = true;

  template <typename T>
  T get() {
    T v{};
    if (off + sizeof(T) > n) {
      ok = false;
      return v;
    }
    std::memcpy(&v, p + off, sizeof(T));
    off += sizeof(T);
    return v;
  }

  std::string str() {
    int32_t len = get<int32_t>();
    if (!ok || len < 0 || off + size_t(len) > n) {
      ok = false;
      return "";
    }
    std::string s(reinterpret_cast<const char*>(p + off), len);
    off += len;
    return s;
  }

  void align16() {
    while (off % 16 != 0 && off < n) ++off;
  }
};

}  // namespace

struct A2pFst {
  int64_t start = -1;
  std::vector<float> final_w;     // +inf when not final
  std::vector<int64_t> arc_off;   // CSR [nstates+1]
  std::vector<Arc> arcs;

  int64_t nstates() const { return (int64_t)final_w.size(); }
};

// OpenFST header flag bits (fst.h FstHeader): symbol tables follow the
// header when set; const-fst data may be 16-byte aligned.
constexpr int32_t kHasISymbols = 0x1;
constexpr int32_t kHasOSymbols = 0x2;
constexpr int32_t kIsAligned = 0x4;
// symbol-table.cc kSymbolTableMagicNumber
constexpr int32_t kSymbolTableMagic = 2125658996;

// Parse-and-skip one serialized SymbolTable (symbol-table.cc layout:
// magic i32, name str, available_key i64, size i64, then per entry
// symbol str + key i64). Returns false on corruption.
static bool skip_symbol_table(Reader& r) {
  if (r.get<int32_t>() != kSymbolTableMagic) return false;
  (void)r.str();                       // name
  (void)r.get<int64_t>();              // available_key
  int64_t size = r.get<int64_t>();
  if (!r.ok || size < 0 || (size_t)size > r.n) return false;
  for (int64_t i = 0; i < size && r.ok; ++i) {
    (void)r.str();                     // symbol
    (void)r.get<int64_t>();            // key
  }
  return r.ok;
}

static A2pFst* load_impl(const uint8_t* data, int64_t size) {
  Reader r{data, (size_t)size};
  if (r.get<int32_t>() != kFstMagic) return nullptr;
  std::string fsttype = r.str();
  std::string arctype = r.str();
  int32_t version = r.get<int32_t>();
  int32_t flags = r.get<int32_t>();
  (void)r.get<uint64_t>();  // properties
  int64_t start = r.get<int64_t>();
  int64_t nstates = r.get<int64_t>();
  int64_t narcs = r.get<int64_t>();
  if (!r.ok || arctype != "standard" || nstates < 0 || narcs < 0)
    return nullptr;
  // hostile-input bounds: every state/arc record needs >= 12 bytes on
  // disk; absurd counts must not reach reserve()
  if (nstates > size || narcs > size) return nullptr;
  // embedded symbol tables (files written with --keep_{i,o}symbols or by
  // pynini with attached tables) sit between the header and the states
  if ((flags & kHasISymbols) && !skip_symbol_table(r)) return nullptr;
  if ((flags & kHasOSymbols) && !skip_symbol_table(r)) return nullptr;

  auto fst = new A2pFst();
  fst->start = start;
  fst->final_w.reserve(nstates > 0 ? nstates : 0);
  fst->arc_off.reserve((nstates > 0 ? nstates : 0) + 1);
  fst->arcs.reserve(narcs > 0 ? narcs : 0);

  if (fsttype == "vector") {
    // per state: final weight (f32), narcs (i64), arcs
    fst->arc_off.push_back(0);
    for (int64_t s = 0; s < nstates && r.ok; ++s) {
      fst->final_w.push_back(r.get<float>());
      int64_t na = r.get<int64_t>();
      for (int64_t a = 0; a < na && r.ok; ++a) {
        Arc arc;
        arc.ilabel = r.get<int32_t>();
        arc.olabel = r.get<int32_t>();
        arc.weight = r.get<float>();
        arc.next = r.get<int32_t>();
        fst->arcs.push_back(arc);
      }
      fst->arc_off.push_back((int64_t)fst->arcs.size());
    }
  } else if (fsttype == "const" || fsttype == "const64") {
    const bool wide = fsttype == "const64";
    // aligned file version 1 pads to 16 bytes before each array
    const bool aligned = (version == 1) || (flags & kIsAligned);
    if (aligned) r.align16();
    // ConstState records are raw struct dumps:
    //   u32 variant: {float weight; u32 pos, narcs, nieps, noeps} = 20 B
    //   u64 variant: 4 B padding after the float (8-byte alignment), then
    //                4 x u64 = 40 B total
    std::vector<int64_t> pos(nstates), cnt(nstates);
    for (int64_t s = 0; s < nstates && r.ok; ++s) {
      fst->final_w.push_back(r.get<float>());
      if (wide) {
        (void)r.get<uint32_t>();  // struct padding
        pos[s] = (int64_t)r.get<uint64_t>();
        cnt[s] = (int64_t)r.get<uint64_t>();
        (void)r.get<uint64_t>();
        (void)r.get<uint64_t>();
      } else {
        pos[s] = r.get<uint32_t>();
        cnt[s] = r.get<uint32_t>();
        (void)r.get<uint32_t>();
        (void)r.get<uint32_t>();
      }
    }
    if (aligned) r.align16();
    std::vector<Arc> raw(narcs > 0 ? narcs : 0);
    for (int64_t a = 0; a < narcs && r.ok; ++a) {
      raw[a].ilabel = r.get<int32_t>();
      raw[a].olabel = r.get<int32_t>();
      raw[a].weight = r.get<float>();
      raw[a].next = r.get<int32_t>();
    }
    fst->arc_off.push_back(0);
    for (int64_t s = 0; s < nstates; ++s) {
      for (int64_t a = 0; a < cnt[s]; ++a) {
        if (pos[s] + a < (int64_t)raw.size())
          fst->arcs.push_back(raw[pos[s] + a]);
      }
      fst->arc_off.push_back((int64_t)fst->arcs.size());
    }
  } else {
    delete fst;
    return nullptr;
  }
  if (!r.ok || (int64_t)fst->final_w.size() != nstates ||
      start >= nstates) {
    delete fst;
    return nullptr;
  }
  // arcs must target real states (corrupt files would crash the search)
  for (const Arc& a : fst->arcs) {
    if (a.next < 0 || (int64_t)a.next >= nstates) {
      delete fst;
      return nullptr;
    }
  }
  return fst;
}

extern "C" A2pFst* a2p_fst_load_bytes(const uint8_t* data, int64_t size) {
  return load_impl(data, size);
}

extern "C" A2pFst* a2p_fst_load(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(size > 0 ? size : 0);
  size_t got = size > 0 ? std::fread(buf.data(), 1, size, f) : 0;
  std::fclose(f);
  if ((long)got != size) return nullptr;
  return load_impl(buf.data(), size);
}

extern "C" void a2p_fst_free(A2pFst* fst) { delete fst; }

extern "C" void a2p_fst_info(const A2pFst* fst, int64_t* out3) {
  out3[0] = fst->start;
  out3[1] = fst->nstates();
  out3[2] = (int64_t)fst->arcs.size();
}

extern "C" int64_t a2p_fst_start(const A2pFst* fst) { return fst->start; }

extern "C" float a2p_fst_final(const A2pFst* fst, int64_t state) {
  return fst->final_w[state];
}

extern "C" int64_t a2p_fst_arc_range(const A2pFst* fst, int64_t state,
                                     int64_t* begin) {
  *begin = fst->arc_off[state];
  return fst->arc_off[state + 1];
}

extern "C" void a2p_fst_arc(const A2pFst* fst, int64_t idx, int32_t* ilabel,
                            int32_t* olabel, float* weight, int32_t* next) {
  const Arc& a = fst->arcs[idx];
  *ilabel = a.ilabel;
  *olabel = a.olabel;
  *weight = a.weight;
  *next = a.next;
}

// ---------------------------------------------------------------------------
// Linear-input composition + tropical shortest path.
//
// compose(linear(input), fst) with exact label matching (+input-epsilon
// arcs), then the single shortest path — the whole ITN tag/verbalize
// operation in one search. Nodes are (pos, state); costs relax through a
// priority queue with re-expansion (handles the occasional negative rule
// weight pynini grammars carry; grammars are free of negative cycles).
// ---------------------------------------------------------------------------

namespace {

struct NodeInfo {
  float cost = kInf;
  int64_t parent = -1;   // node key
  int32_t olabel = 0;    // emitted on the arc into this node
};

}  // namespace

extern "C" int64_t a2p_fst_transduce(const A2pFst* fst, const int32_t* input,
                                     int64_t n, int32_t* out, int64_t cap) {
  if (fst->start < 0) return -1;
  const int64_t ns = fst->nstates();
  std::unordered_map<int64_t, NodeInfo> info;
  using QE = std::pair<float, int64_t>;  // (cost, key)
  std::priority_queue<QE, std::vector<QE>, std::greater<QE>> pq;

  auto key = [&](int64_t pos, int64_t st) { return pos * ns + st; };
  const int64_t start_key = key(0, fst->start);
  info[start_key] = {0.0f, -1, 0};
  pq.push({0.0f, start_key});

  float best_cost = kInf;
  int64_t best_key = -1;

  while (!pq.empty()) {
    auto [cost, k] = pq.top();
    pq.pop();
    auto it = info.find(k);
    if (it == info.end() || cost > it->second.cost) continue;  // stale
    if (cost >= best_cost) continue;  // cannot improve the goal
    const int64_t pos = k / ns;
    const int64_t st = k % ns;
    if (pos == n && fst->final_w[st] < kInf) {
      float total = cost + fst->final_w[st];
      if (total < best_cost) {
        best_cost = total;
        best_key = k;
      }
    }
    for (int64_t a = fst->arc_off[st]; a < fst->arc_off[st + 1]; ++a) {
      const Arc& arc = fst->arcs[a];
      int64_t npos;
      if (arc.ilabel == 0) {
        npos = pos;
      } else if (pos < n && arc.ilabel == input[pos]) {
        npos = pos + 1;
      } else {
        continue;
      }
      float ncost = cost + arc.weight;
      int64_t nk = key(npos, arc.next);
      auto& ni = info[nk];
      if (ncost < ni.cost) {
        ni.cost = ncost;
        ni.parent = k;
        ni.olabel = arc.olabel;
        pq.push({ncost, nk});
      }
    }
  }
  if (best_key < 0) return -1;
  // backtrace olabels
  std::vector<int32_t> rev;
  for (int64_t k = best_key; k != start_key;) {
    const NodeInfo& ni = info[k];
    if (ni.olabel != 0) rev.push_back(ni.olabel);
    k = ni.parent;
  }
  if ((int64_t)rev.size() > cap) return -2;
  for (size_t i = 0; i < rev.size(); ++i) out[i] = rev[rev.size() - 1 - i];
  return (int64_t)rev.size();
}
