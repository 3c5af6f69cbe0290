// Copy of the JAX package's native/src/tlg_decoder.cc; unchanged below this line.
// TLG decoding-graph beam search (token passing over an arbitrary
// OpenFST-format StdArc graph loaded by fst.cc).
//
// Role of the reference's WfstDecoder (onnxruntime/src/wfst-decoder.cpp:
// 27-92): the offline Paraformer feeds one "frame" of per-token log-probs
// per decoded position (AcceptLoglikes + AdvanceDecoding), the decoder
// advances every live graph token through epsilon closure + one emitting
// arc, prunes to a beam, and at FinalizeDecode returns the best word
// sequence. We add the Aho-Corasick hotword-bias hook the reference
// patches into its kaldi lattice decoder (lattice-faster-decoder.cc:
// 803-815) as an optional per-hypothesis bias automaton state, and a
// unique-final-state nbest surface (wfst-decoder.cpp:149-179 role).
//
// Own design: Viterbi tokens in a hash map keyed by (graph state, bias
// state) with an arena backtrace — no kaldi lattices; the nbest list is
// the k best distinct final tokens.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <unordered_map>
#include <vector>

struct A2pFst;  // fst.cc
struct A2pAcBias;  // native.cc

extern "C" void a2p_fst_info(const A2pFst*, int64_t*);
extern "C" int64_t a2p_fst_arc_range(const A2pFst*, int64_t state,
                                     int64_t* begin);
extern "C" void a2p_fst_arc(const A2pFst*, int64_t idx, int32_t* ilabel,
                            int32_t* olabel, float* weight, int32_t* next);
extern "C" float a2p_fst_final(const A2pFst*, int64_t state);
extern "C" int64_t a2p_fst_start(const A2pFst*);
extern "C" float a2p_ac_step(const A2pAcBias*, int32_t* state, int32_t sym);
extern "C" float a2p_ac_final(const A2pAcBias*, int32_t state);
extern "C" int32_t a2p_ac_num_states(const A2pAcBias*);

namespace {

constexpr float kInf = std::numeric_limits<float>::infinity();

struct Hyp {
  int64_t parent;
  int32_t word;
};

struct Tok {
  float cost = kInf;
  int64_t hyp = -1;
};

struct Beam {
  std::unordered_map<int64_t, Tok> toks;
};

}  // namespace

struct A2pTlg {
  const A2pFst* fst = nullptr;
  const A2pAcBias* bias = nullptr;
  int64_t nbias = 1;
  float beam = 16.0f;
  int32_t max_active = 2000;
  float ac_scale = 1.0f;
  float lm_scale = 1.0f;
  std::vector<Hyp> arena;
  Beam cur;

  int64_t key(int64_t state, int64_t bstate) const {
    return state * nbias + bstate;
  }
  int64_t kstate(int64_t k) const { return k / nbias; }
  int64_t kbias(int64_t k) const { return k % nbias; }
};

extern "C" A2pTlg* a2p_tlg_new(const A2pFst* fst, float beam,
                               int32_t max_active, float ac_scale,
                               float lm_scale, const A2pAcBias* bias) {
  auto d = new A2pTlg();
  d->fst = fst;
  d->beam = beam;
  d->max_active = max_active;
  d->ac_scale = ac_scale;
  d->lm_scale = lm_scale;
  d->bias = bias;
  d->nbias = bias ? (int64_t)a2p_ac_num_states(bias) : 1;
  return d;
}

extern "C" void a2p_tlg_free(A2pTlg* d) { delete d; }

static void eps_closure(A2pTlg* d) {
  // relax input-epsilon arcs to fixpoint (graphs are eps-acyclic after
  // determinization; a work-list with cost improvement terminates)
  std::vector<int64_t> work;
  work.reserve(d->cur.toks.size());
  for (auto& kv : d->cur.toks) work.push_back(kv.first);
  while (!work.empty()) {
    int64_t k = work.back();
    work.pop_back();
    auto it = d->cur.toks.find(k);
    if (it == d->cur.toks.end()) continue;
    Tok tok = it->second;
    int64_t st = d->kstate(k);
    int64_t begin;
    int64_t end = a2p_fst_arc_range(d->fst, st, &begin);
    for (int64_t a = begin; a < end; ++a) {
      int32_t il, ol, next;
      float w;
      a2p_fst_arc(d->fst, a, &il, &ol, &w, &next);
      if (il != 0) continue;
      float ncost = tok.cost + d->lm_scale * w;
      int64_t nk = d->key(next, d->kbias(k));
      Tok& nt = d->cur.toks[nk];
      if (ncost < nt.cost) {
        nt.cost = ncost;
        if (ol != 0) {
          d->arena.push_back({tok.hyp, ol});
          nt.hyp = (int64_t)d->arena.size() - 1;
        } else {
          nt.hyp = tok.hyp;
        }
        work.push_back(nk);
      }
    }
  }
}

static void prune(A2pTlg* d) {
  if (d->cur.toks.empty()) return;
  float best = kInf;
  for (auto& kv : d->cur.toks) best = std::min(best, kv.second.cost);
  std::vector<std::pair<float, int64_t>> keep;
  keep.reserve(d->cur.toks.size());
  for (auto& kv : d->cur.toks)
    if (kv.second.cost <= best + d->beam)
      keep.push_back({kv.second.cost, kv.first});
  if ((int32_t)keep.size() > d->max_active) {
    std::nth_element(keep.begin(), keep.begin() + d->max_active, keep.end());
    keep.resize(d->max_active);
  }
  std::unordered_map<int64_t, Tok> next;
  next.reserve(keep.size() * 2);
  for (auto& [c, k] : keep) next.emplace(k, d->cur.toks[k]);
  d->cur.toks.swap(next);
}

extern "C" void a2p_tlg_start(A2pTlg* d) {
  d->arena.clear();
  d->cur.toks.clear();
  int64_t s = a2p_fst_start(d->fst);
  if (s >= 0) d->cur.toks[d->key(s, 0)] = {0.0f, -1};
  eps_closure(d);
  prune(d);
}

// logp: array indexed by ILABEL (caller maps AM token ids -> graph input
// symbols); n = array length. One call per decoded token position.
extern "C" void a2p_tlg_step(A2pTlg* d, const float* logp, int64_t n) {
  std::unordered_map<int64_t, Tok> next;
  next.reserve(d->cur.toks.size() * 2);
  for (auto& kv : d->cur.toks) {
    int64_t st = d->kstate(kv.first);
    int64_t bs = d->kbias(kv.first);
    const Tok& tok = kv.second;
    int64_t begin;
    int64_t end = a2p_fst_arc_range(d->fst, st, &begin);
    for (int64_t a = begin; a < end; ++a) {
      int32_t il, ol, nxt;
      float w;
      a2p_fst_arc(d->fst, a, &il, &ol, &w, &nxt);
      if (il == 0 || il >= n) continue;
      float am = -logp[il];
      float cost = tok.cost + d->ac_scale * am + d->lm_scale * w;
      int32_t nbs = (int32_t)bs;
      if (d->bias) cost -= a2p_ac_step(d->bias, &nbs, il);
      int64_t nk = d->key(nxt, nbs);
      Tok& nt = next[nk];
      if (cost < nt.cost) {
        nt.cost = cost;
        if (ol != 0) {
          d->arena.push_back({tok.hyp, ol});
          nt.hyp = (int64_t)d->arena.size() - 1;
        } else {
          nt.hyp = tok.hyp;
        }
      }
    }
  }
  d->cur.toks.swap(next);
  eps_closure(d);
  prune(d);
}

static int64_t backtrace(const A2pTlg* d, int64_t hyp, int32_t* out,
                         int64_t cap) {
  std::vector<int32_t> rev;
  for (int64_t h = hyp; h >= 0; h = d->arena[h].parent)
    rev.push_back(d->arena[h].word);
  if ((int64_t)rev.size() > cap) return -2;
  for (size_t i = 0; i < rev.size(); ++i) out[i] = rev[rev.size() - 1 - i];
  return (int64_t)rev.size();
}

// Partial best path mid-utterance: the best LIVE token regardless of
// finality (LatticeFasterOnlineDecoder::GetBestPath with
// use_final_probs=false — the reference emits these between chunks,
// wfst-decoder.cpp:27-57). Does not modify decoder state beyond the
// epsilon closure (idempotent).
extern "C" int64_t a2p_tlg_partial(A2pTlg* d, int32_t* out, int64_t cap) {
  eps_closure(d);
  float best = kInf;
  int64_t bk = -1;
  for (auto& kv : d->cur.toks) {
    if (kv.second.cost < best) {
      best = kv.second.cost;
      bk = kv.first;
    }
  }
  if (bk < 0) return 0;
  return backtrace(d, d->cur.toks[bk].hyp, out, cap);
}

// nbest over distinct final tokens; returns count written. out is
// flattened word ids with -1 separators; scores[i] = total cost.
extern "C" int64_t a2p_tlg_nbest(A2pTlg* d, int32_t nbest, int32_t* out,
                                 int64_t cap, float* scores) {
  eps_closure(d);
  std::vector<std::pair<float, int64_t>> finals;
  for (auto& kv : d->cur.toks) {
    float fw = a2p_fst_final(d->fst, d->kstate(kv.first));
    if (fw >= kInf) continue;
    float cost = kv.second.cost + d->lm_scale * fw;
    if (d->bias) cost -= a2p_ac_final(d->bias, (int32_t)d->kbias(kv.first));
    finals.push_back({cost, kv.first});
  }
  if (finals.empty()) {
    // no reachable final state: fall back to the best live token
    for (auto& kv : d->cur.toks)
      finals.push_back({kv.second.cost, kv.first});
    if (finals.empty()) return 0;
  }
  std::sort(finals.begin(), finals.end());
  int64_t written = 0;
  int64_t off = 0;
  for (auto& [cost, k] : finals) {
    if (written >= nbest) break;
    int64_t m = backtrace(d, d->cur.toks[k].hyp, out + off, cap - off - 1);
    if (m < 0) break;
    off += m;
    out[off++] = -1;
    scores[written] = cost;
    ++written;
  }
  return written;
}
