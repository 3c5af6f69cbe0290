// Copy of the JAX package's native/src/lm_decoder.cc; unchanged below this line.
// Native LM beam decoder: on-the-fly L-trie x backoff n-gram token
// passing with optional hotword bias — the hot host-side search of the
// 2pass service's pass-2 rescoring. Behavior matches the Python
// implementation in decode/lm_decoder.py (parity-tested); the reference
// runs the equivalent search in a patched Kaldi
// LatticeFasterOnlineDecoder over a precompiled TLG.fst
// (wfst-decoder.cpp:27-92, lattice-faster-decoder.cc:803-815).
#include "api.h"

#include <algorithm>
#include <cmath>
#include <cstring>
#include <memory>
#include <unordered_map>
#include <vector>

namespace {

constexpr int kMaxOrder = 8;
constexpr double kLn10 = 2.302585092994046;

// ---- n-gram key (word-id sequence, len <= kMaxOrder) ----
struct NgKey {
  int32_t w[kMaxOrder];
  int32_t len;
  bool operator==(const NgKey& o) const {
    return len == o.len && std::memcmp(w, o.w, sizeof(int32_t) * len) == 0;
  }
};
struct NgKeyHash {
  size_t operator()(const NgKey& k) const {
    uint64_t h = 1469598103934665603ull;
    for (int32_t i = 0; i < k.len; ++i) {
      h ^= (uint64_t)(uint32_t)k.w[i];
      h *= 1099511628211ull;
    }
    return (size_t)h;
  }
};

struct LmEntry {
  float logp;
  float bow;
  bool has_logp;
  bool has_bow;
};

// ---- lexicon trie over unit ids ----
struct TrieNode {
  std::unordered_map<int32_t, int32_t> children;
  std::vector<int32_t> words;  // word ids ending here
};

// ---- bias (ContextGraph) trie over unit ids ----
struct BiasNode {
  std::unordered_map<int32_t, int32_t> children;
  float score = 0.0f;  // incremental boost on entering this node
  float total = 0.0f;  // cumulative boost from root
  bool is_end = false;
};

struct LmState {
  int32_t w[kMaxOrder - 1];
  int32_t len = 0;
  bool operator==(const LmState& o) const {
    return len == o.len && std::memcmp(w, o.w, sizeof(int32_t) * len) == 0;
  }
};

struct Arc {
  int32_t parent;  // -1 root
  int32_t unit;
  int32_t word;  // >=0 lexicon word end, -1 mid-word, -2 OOV word end
};

struct Hyp {
  double score;
  int32_t trie;      // lexicon trie node index
  int32_t bias;      // bias node index (-1 root/none)
  LmState lm;
  uint64_t words_hash;
  std::vector<int32_t> pending;
  int32_t arc;       // last arc index (-1 none)
};

struct HypKey {
  uint64_t words_hash;
  uint64_t pending_hash;
  int32_t trie;
  LmState lm;
  bool operator==(const HypKey& o) const {
    return words_hash == o.words_hash && pending_hash == o.pending_hash &&
           trie == o.trie && lm == o.lm;
  }
};
struct HypKeyHash {
  size_t operator()(const HypKey& k) const {
    uint64_t h = k.words_hash * 0x9e3779b97f4a7c15ull ^ k.pending_hash;
    h ^= (uint64_t)(uint32_t)k.trie * 0xff51afd7ed558ccdull;
    for (int32_t i = 0; i < k.lm.len; ++i)
      h = h * 1099511628211ull ^ (uint64_t)(uint32_t)k.lm.w[i];
    return (size_t)h;
  }
};

uint64_t mix_hash(uint64_t h, uint64_t v) {
  h ^= v + 0x9e3779b97f4a7c15ull + (h << 6) + (h >> 2);
  return h;
}

uint64_t seq_hash(const std::vector<int32_t>& xs) {
  uint64_t h = 14695981039346656037ull;
  for (int32_t x : xs) h = mix_hash(h, (uint64_t)(uint32_t)x);
  return h;
}

}  // namespace

// Read-only LM resources shared across decoder clones: the lexicon trie
// and the n-gram table load ONCE per server (the reference loads its
// decode graph once in FunASRWfstDecoderInit and shares it read-only,
// funasrruntime.cpp:836-894); per-connection decoders (a2p_lmdec_clone)
// carry only search params + their own hotword bias trie.
struct LmTables {
  int32_t order;
  std::vector<TrieNode> trie;
  std::unordered_map<NgKey, LmEntry, NgKeyHash> lm;
  std::vector<char> in_vocab;  // by word id (dense)
  int32_t unk, bos;
};

struct A2pLmDec {
  std::shared_ptr<const LmTables> tab;
  float lm_weight, oov_penalty;
  int32_t beam, am_topk;
  std::vector<BiasNode> bias;  // empty = no bias; [0] is root otherwise

  // -- LM scoring (ngram.py score/_score_backed/next_state parity) --
  float score_backed(const LmState& h0, int32_t word) const {
    double total_bow = 0.0;
    LmState h = h0;
    for (;;) {
      NgKey ng;
      ng.len = h.len + 1;
      std::memcpy(ng.w, h.w, sizeof(int32_t) * h.len);
      ng.w[h.len] = word;
      auto it = tab->lm.find(ng);
      if (it != tab->lm.end() && it->second.has_logp)
        return (float)(total_bow + it->second.logp);
      if (h.len == 0) {
        NgKey uni;
        uni.len = 1;
        uni.w[0] = word;
        auto u = tab->lm.find(uni);
        return (float)(total_bow + (u != tab->lm.end() && u->second.has_logp
                                        ? u->second.logp : -7.0));
      }
      NgKey hk;
      hk.len = h.len;
      std::memcpy(hk.w, h.w, sizeof(int32_t) * h.len);
      auto b = tab->lm.find(hk);
      if (b != tab->lm.end() && b->second.has_bow) total_bow += b->second.bow;
      // h = h[1:]
      std::memmove(h.w, h.w + 1, sizeof(int32_t) * (h.len - 1));
      h.len -= 1;
    }
  }

  float lm_score(const LmState& h0, int32_t word) const {
    int32_t w = (word >= 0 && word < (int32_t)tab->in_vocab.size() &&
                 tab->in_vocab[word]) ? word : tab->unk;
    LmState h = h0;
    if (h.len > tab->order - 1) {  // keep the last order-1 words
      std::memmove(h.w, h.w + (h.len - (tab->order - 1)),
                   sizeof(int32_t) * (tab->order - 1));
      h.len = tab->order - 1;
    }
    return score_backed(h, w);
  }

  bool known_context(const LmState& h) const {
    NgKey k;
    k.len = h.len;
    std::memcpy(k.w, h.w, sizeof(int32_t) * h.len);
    auto it = tab->lm.find(k);
    if (it == tab->lm.end()) return false;
    return true;  // present as ngram (logp and/or bow entry)
  }

  LmState next_state(const LmState& h0, int32_t word) const {
    int32_t w = (word >= 0 && word < (int32_t)tab->in_vocab.size() &&
                 tab->in_vocab[word]) ? word : tab->unk;
    LmState h = h0;
    if (h.len == tab->order - 1) {  // shift left, append
      std::memmove(h.w, h.w + 1, sizeof(int32_t) * (h.len - 1));
      h.w[h.len - 1] = w;
    } else {
      h.w[h.len++] = w;
    }
    // truncate to longest known context: while h not in backoff and
    // len > 1 and h not in logp: h = h[1:]
    while (h.len > 1 && !known_context(h)) {
      std::memmove(h.w, h.w + 1, sizeof(int32_t) * (h.len - 1));
      h.len -= 1;
    }
    return h;
  }

  // -- bias trie stepping (context_graph.py get_next_state parity) --
  // returns score delta; state index updated (-1 == root)
  float bias_step(int32_t* state, int32_t unit) const {
    int32_t cur = (*state < 0) ? 0 : *state;
    const BiasNode& node = bias[cur];
    auto it = node.children.find(unit);
    if (it != node.children.end()) {
      const BiasNode& nxt = bias[it->second];
      if (nxt.is_end && nxt.children.empty()) {
        *state = -1;
        return nxt.score;
      }
      *state = it->second;
      return nxt.score;
    }
    float retract = -node.total;
    auto r = bias[0].children.find(unit);
    if (r != bias[0].children.end()) {
      const BiasNode& nxt = bias[r->second];
      if (nxt.is_end && nxt.children.empty()) {
        *state = -1;
        return retract + nxt.score;
      }
      *state = r->second;
      return retract + nxt.score;
    }
    *state = -1;
    return retract;
  }

  float bias_final(int32_t state) const {
    if (bias.empty() || state < 0) return 0.0f;
    return -bias[state].total;
  }
};

extern "C" A2pLmDec* a2p_lmdec_create(
    int32_t order, const int32_t* lex_units, const int32_t* lex_lens,
    const int32_t* lex_word_ids, int32_t n_lex, const int32_t* ng_words,
    const int32_t* ng_lens, const float* ng_logp, const float* ng_bow,
    int64_t n_ng, int32_t unk_id, int32_t bos_id, float lm_weight,
    float oov_penalty, int32_t beam, int32_t am_topk) {
  if (order > kMaxOrder) return nullptr;
  auto tab = std::make_shared<LmTables>();
  tab->order = order;
  tab->unk = unk_id;
  tab->bos = bos_id;
  tab->trie.emplace_back();
  const int32_t* u = lex_units;
  int32_t max_word = std::max(unk_id, bos_id);
  for (int32_t i = 0; i < n_lex; ++i) {
    int32_t node = 0;
    for (int32_t j = 0; j < lex_lens[i]; ++j) {
      auto it = tab->trie[node].children.find(u[j]);
      if (it == tab->trie[node].children.end()) {
        tab->trie.emplace_back();
        int32_t idx = (int32_t)tab->trie.size() - 1;
        tab->trie[node].children.emplace(u[j], idx);
        node = idx;
      } else {
        node = it->second;
      }
    }
    tab->trie[node].words.push_back(lex_word_ids[i]);
    max_word = std::max(max_word, lex_word_ids[i]);
    u += lex_lens[i];
  }
  {
    int64_t off = 0;
    for (int64_t i = 0; i < n_ng; ++i) {
      for (int32_t j = 0; j < ng_lens[i]; ++j)
        max_word = std::max(max_word, ng_words[off + j]);
      off += ng_lens[i];
    }
  }
  tab->in_vocab.assign((size_t)max_word + 2, 0);
  {
    int64_t off = 0;
    for (int64_t i = 0; i < n_ng; ++i) {
      NgKey k;
      k.len = ng_lens[i];
      for (int32_t j = 0; j < k.len; ++j) k.w[j] = ng_words[off + j];
      auto& e = tab->lm[k];
      e.logp = ng_logp[i];
      e.bow = ng_bow[i];
      e.has_logp = !std::isnan(ng_logp[i]);
      e.has_bow = !std::isnan(ng_bow[i]);
      if (k.len == 1 && e.has_logp) tab->in_vocab[(size_t)k.w[0]] = 1;
      off += ng_lens[i];
    }
  }
  auto* d = new A2pLmDec();
  d->tab = std::move(tab);
  d->lm_weight = lm_weight;
  d->oov_penalty = oov_penalty;
  d->beam = beam;
  d->am_topk = am_topk;
  return d;
}

// Per-connection decoder over the SHARED tables of `src`: O(1) clone
// (shared_ptr bump), empty bias — the caller attaches its own hotwords
// via a2p_lmdec_set_bias. Safe to use concurrently with src (decode
// reads tables only; all search state is call-local).
extern "C" A2pLmDec* a2p_lmdec_clone(const A2pLmDec* src) {
  auto* d = new A2pLmDec();
  d->tab = src->tab;
  d->lm_weight = src->lm_weight;
  d->oov_penalty = src->oov_penalty;
  d->beam = src->beam;
  d->am_topk = src->am_topk;
  return d;
}

extern "C" void a2p_lmdec_free(A2pLmDec* d) { delete d; }

extern "C" void a2p_lmdec_set_bias(A2pLmDec* d, const int32_t* units,
                                   const int32_t* lens,
                                   const float* sym_scores,
                                   int32_t n_phrases) {
  d->bias.clear();
  d->bias.emplace_back();  // root
  const int32_t* u = units;
  const float* s = sym_scores;
  for (int32_t i = 0; i < n_phrases; ++i) {
    int32_t node = 0;
    for (int32_t j = 0; j < lens[i]; ++j) {
      auto it = d->bias[node].children.find(u[j]);
      int32_t nxt;
      if (it == d->bias[node].children.end()) {
        d->bias.emplace_back();
        nxt = (int32_t)d->bias.size() - 1;
        d->bias[node].children.emplace(u[j], nxt);
        d->bias[nxt].score = s[j];
        d->bias[nxt].total = d->bias[node].total + s[j];
      } else {
        nxt = it->second;
      }
      node = nxt;
    }
    d->bias[node].is_end = true;
    u += lens[i];
    s += lens[i];
  }
}

extern "C" void a2p_lmdec_clear_bias(A2pLmDec* d) { d->bias.clear(); }

extern "C" int64_t a2p_lmdec_decode(A2pLmDec* d, const float* rows,
                                    int64_t n, int32_t v,
                                    const int32_t* skip_ids, int32_t n_skip,
                                    int32_t* out_units, int32_t* out_words) {
  std::vector<char> skip((size_t)v, 0);
  for (int32_t i = 0; i < n_skip; ++i)
    if (skip_ids[i] >= 0 && skip_ids[i] < v) skip[(size_t)skip_ids[i]] = 1;

  std::vector<Arc> arcs;
  std::vector<Hyp> hyps(1);
  hyps[0].score = 0.0;
  hyps[0].trie = 0;
  hyps[0].bias = -1;
  hyps[0].lm.len = 1;
  hyps[0].lm.w[0] = d->tab->bos;
  hyps[0].words_hash = 14695981039346656037ull;
  hyps[0].arc = -1;

  const bool use_bias = !d->bias.empty();
  std::vector<int32_t> cand;
  cand.reserve((size_t)d->am_topk);
  std::vector<int32_t> idx((size_t)v);

  for (int64_t t = 0; t < n; ++t) {
    const float* row = rows + t * v;
    // top-k candidates (excluding skips)
    int32_t k = std::min<int32_t>(d->am_topk, v);
    for (int32_t i = 0; i < v; ++i) idx[(size_t)i] = i;
    std::partial_sort(idx.begin(), idx.begin() + k, idx.end(),
                      [row](int32_t a, int32_t b) { return row[a] > row[b]; });
    cand.assign(idx.begin(), idx.begin() + k);

    std::unordered_map<HypKey, int32_t, HypKeyHash> dedup;
    std::vector<Hyp> next;
    next.reserve(hyps.size() * cand.size());

    auto push = [&](Hyp&& h) {
      HypKey key{h.words_hash, seq_hash(h.pending), h.trie, h.lm};
      auto it = dedup.find(key);
      if (it == dedup.end()) {
        dedup.emplace(key, (int32_t)next.size());
        next.push_back(std::move(h));
      } else if (next[(size_t)it->second].score < h.score) {
        next[(size_t)it->second] = std::move(h);
      }
    };

    for (const Hyp& hyp : hyps) {
      for (int32_t tok : cand) {
        if (skip[(size_t)tok]) continue;
        double am = row[tok];
        int32_t bias_state = hyp.bias;
        double bias_delta = 0.0;
        if (use_bias) bias_delta = d->bias_step(&bias_state, tok);
        double base = hyp.score + am + bias_delta;

        const auto& children = d->tab->trie[(size_t)hyp.trie].children;
        auto it = children.find(tok);
        if (it != children.end()) {
          const TrieNode& nxt = d->tab->trie[(size_t)it->second];
          for (int32_t word : nxt.words) {
            Hyp h2;
            h2.score = base + d->lm_weight *
                                  (double)d->lm_score(hyp.lm, word) * kLn10;
            h2.trie = 0;
            h2.bias = bias_state;
            h2.lm = d->next_state(hyp.lm, word);
            h2.words_hash = mix_hash(hyp.words_hash,
                                     (uint64_t)(uint32_t)word);
            arcs.push_back({hyp.arc, tok, word});
            h2.arc = (int32_t)arcs.size() - 1;
            push(std::move(h2));
          }
          if (!nxt.children.empty()) {
            Hyp h2;
            h2.score = base;
            h2.trie = it->second;
            h2.bias = bias_state;
            h2.lm = hyp.lm;
            h2.words_hash = hyp.words_hash;
            h2.pending = hyp.pending;
            h2.pending.push_back(tok);
            arcs.push_back({hyp.arc, tok, -1});
            h2.arc = (int32_t)arcs.size() - 1;
            push(std::move(h2));
          }
        } else {
          // OOV: emit pending+tok as a raw word with penalty; the LM
          // transitions through <unk> (decode/lm_decoder.py:149-159 —
          // native deviation: a unit-concat that happens to spell an
          // in-LM word missing from the lexicon still scores as OOV)
          Hyp h2;
          h2.score = base + d->lm_weight * (double)d->oov_penalty;
          h2.trie = 0;
          h2.bias = bias_state;
          h2.lm = d->next_state(hyp.lm, d->tab->unk);
          uint64_t wh = hyp.words_hash;
          for (int32_t p : hyp.pending)
            wh = mix_hash(wh, (uint64_t)(uint32_t)p ^ 0xabcdull);
          wh = mix_hash(wh, (uint64_t)(uint32_t)tok ^ 0xabcdull);
          h2.words_hash = wh;
          arcs.push_back({hyp.arc, tok, -2});
          h2.arc = (int32_t)arcs.size() - 1;
          push(std::move(h2));
        }
      }
    }
    if (next.empty()) return -1;
    std::sort(next.begin(), next.end(),
              [](const Hyp& a, const Hyp& b) { return a.score > b.score; });
    if ((int32_t)next.size() > d->beam) next.resize((size_t)d->beam);
    hyps = std::move(next);
  }

  // finalize: bias retraction, best path backtrace
  const Hyp* best = nullptr;
  double best_score = 0.0;
  for (const Hyp& h : hyps) {
    double s = h.score + (use_bias ? d->bias_final(h.bias) : 0.0);
    if (best == nullptr || s > best_score) {
      best = &h;
      best_score = s;
    }
  }
  if (best == nullptr) return -1;
  std::vector<int32_t> units_rev, words_rev;
  for (int32_t a = best->arc; a >= 0; a = arcs[(size_t)a].parent) {
    units_rev.push_back(arcs[(size_t)a].unit);
    words_rev.push_back(arcs[(size_t)a].word);
  }
  int64_t m = (int64_t)units_rev.size();
  for (int64_t i = 0; i < m; ++i) {
    out_units[i] = units_rev[(size_t)(m - 1 - i)];
    out_words[i] = words_rev[(size_t)(m - 1 - i)];
  }
  return m;
}
