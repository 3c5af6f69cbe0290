// Copy of the JAX package's native/src/ctc_beam.cc; unchanged below this line.
// CTC prefix beam search over pre-pruned per-frame candidates, with the
// hotword context-graph bias — the native serving path for SenseVoice
// pass-2 beam decodes (decode/ctc.py _prefix_beam_over_frames is the
// executable spec; the reference runs the same WeNet-derived algorithm in
// C++ at ctc-prefix-decoder.cpp:157-299).
//
// Semantics mirror the Python spec EXACTLY (parity-tested):
//   * per-prefix (blank, non-blank) log probabilities, log-add merges
//   * the -12.0 low-logp gate on non-blank candidates
//   * per-prefix viterbi times via the cur_token_prob rule
//   * context trie with retract-on-mismatch and root-reentry
//     (decode/context_graph.py get_next_state), extended once per
//     (target prefix, frame), plus the end-of-decode final retract
//   * stable sorts over insertion order (matching dict-ordered
//     sorted() in Python), beam-width second prune per frame.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <unordered_map>
#include <vector>

namespace {

constexpr double kNegInf = -std::numeric_limits<double>::infinity();

inline double log_add(double a, double b) {
  if (a == kNegInf) return b;
  if (b == kNegInf) return a;
  const double m = a > b ? a : b;
  return m + std::log1p(std::exp((a < b ? a : b) - m));
}

// ---- context trie (ContextGraph semantics, keyed by unit id) ----
struct CtxTrie {
  // node 0 = root. children maps (node, unit) -> child.
  std::vector<float> score, total;
  std::vector<uint8_t> is_end;
  std::vector<uint8_t> has_children;
  std::unordered_map<int64_t, int32_t> children;

  bool empty() const { return score.size() <= 1; }

  int32_t child(int32_t node, int32_t unit) const {
    auto it = children.find(((int64_t)node << 32) | (uint32_t)unit);
    return it == children.end() ? -1 : it->second;
  }

  // decode/context_graph.py get_next_state: returns (next_state) and
  // adds the score delta to *delta. state < 0 means the Python None
  // (never extended), which behaves as the root.
  int32_t step(int32_t state, int32_t unit, double* delta) const {
    if (state < 0) state = 0;
    int32_t nxt = child(state, unit);
    if (nxt >= 0) {
      *delta += score[nxt];
      if (is_end[nxt] && !has_children[nxt]) return 0;  // full word
      return nxt;
    }
    *delta += -total[state];                      // retract partial match
    nxt = child(0, unit);
    if (nxt >= 0) {
      *delta += score[nxt];
      if (is_end[nxt] && !has_children[nxt]) return 0;
      return nxt;
    }
    return 0;
  }

  double final_retract(int32_t state) const {
    return -total[state < 0 ? 0 : state];
  }
};

struct PrefixScore {
  double pb = kNegInf;
  double pnb = kNegInf;
  int32_t ctx_state = -1;    // -1 == Python None (never extended)
  double ctx_score = 0.0;
  double cur_token_prob = kNegInf;
  std::vector<int32_t> times_b, times_nb;

  double total() const { return log_add(pb, pnb); }
  double score_with_ctx() const { return total() + ctx_score; }
  const std::vector<int32_t>& times() const {
    return pb > pnb ? times_b : times_nb;
  }
};

}  // namespace

// Decode one utterance. cand_ids/cand_logp: [T, K] row-major. Context
// trie arrays (n_nodes incl. root at index 0) may be null/0 for no bias:
// node_unit[i]/node_parent[i] describe the edge INTO node i (unused for
// the root row). Outputs: up to `beam` hypotheses, ids+times flattened
// [beam, max_len], lengths in out_lens, scores in out_scores. Returns the
// number of hypotheses written, or -1 on bad arguments.
extern "C" int32_t a2p_ctcbeam_decode(
    const int32_t* cand_ids, const float* cand_logp, int32_t T, int32_t K,
    int32_t beam, int32_t blank_id, int32_t n_nodes,
    const int32_t* node_parent, const int32_t* node_unit,
    const float* node_score, const uint8_t* node_is_end, int32_t* out_ids,
    int32_t* out_times, int32_t* out_lens, float* out_scores,
    int32_t max_len) {
  if (T < 0 || K <= 0 || beam <= 0 || max_len <= 0) return -1;

  CtxTrie trie;
  if (n_nodes > 1 && node_parent && node_unit && node_score &&
      node_is_end) {
    trie.score.assign(n_nodes, 0.f);
    trie.total.assign(n_nodes, 0.f);
    trie.is_end.assign(n_nodes, 0);
    trie.has_children.assign(n_nodes, 0);
    for (int32_t i = 1; i < n_nodes; ++i) {
      const int32_t p = node_parent[i];
      if (p < 0 || p >= i) return -1;  // parents must precede children
      trie.score[i] = node_score[i];
      trie.total[i] = trie.total[p] + node_score[i];
      trie.is_end[i] = node_is_end[i];
      trie.has_children[p] = 1;
      trie.children[((int64_t)p << 32) | (uint32_t)node_unit[i]] = i;
    }
  }
  const bool use_ctx = !trie.empty();

  // global prefix trie: prefix id -> (parent prefix, last token)
  std::vector<std::pair<int32_t, int32_t>> pref_nodes;
  pref_nodes.emplace_back(-1, -1);  // id 0 = empty prefix
  std::unordered_map<int64_t, int32_t> pref_children;

  auto extend_prefix = [&](int32_t pid, int32_t tok) {
    const int64_t key = ((int64_t)pid << 32) | (uint32_t)tok;
    auto it = pref_children.find(key);
    if (it != pref_children.end()) return it->second;
    const int32_t nid = (int32_t)pref_nodes.size();
    pref_nodes.emplace_back(pid, tok);
    pref_children.emplace(key, nid);
    return nid;
  };
  auto last_tok = [&](int32_t pid) { return pref_nodes[pid].second; };

  // current beam: insertion-ordered ids + scores
  std::vector<int32_t> cur_ids{0};
  std::vector<PrefixScore> cur_ps(1);
  cur_ps[0].pb = 0.0;

  std::vector<int32_t> nxt_order;
  std::unordered_map<int32_t, int32_t> nxt_index;
  std::vector<PrefixScore> nxt_ps;

  auto get_next = [&](int32_t pid) -> PrefixScore& {
    auto it = nxt_index.find(pid);
    if (it != nxt_index.end()) return nxt_ps[it->second];
    const int32_t idx = (int32_t)nxt_ps.size();
    nxt_index.emplace(pid, idx);
    nxt_order.push_back(pid);
    nxt_ps.emplace_back();
    return nxt_ps[idx];
  };

  auto extend_ctx = [&](PrefixScore& ns, const PrefixScore& ps,
                        int32_t tok) {
    // the Python guard is VALUE-based: `ns.ctx_state is None and
    // ns.ctx_score == 0.0` — a copy-writer that brought (None, 0.0)
    // forward still allows a later extension, while any non-None state
    // blocks it. -1 plays the None role exactly.
    if (!use_ctx) return;
    if (!(ns.ctx_state == -1 && ns.ctx_score == 0.0)) return;
    double delta = 0.0;
    const int32_t st = trie.step(ps.ctx_state, tok, &delta);
    ns.ctx_state = st;
    ns.ctx_score = ps.ctx_score + delta;
  };

  for (int32_t t = 0; t < T; ++t) {
    nxt_order.clear();
    nxt_index.clear();
    nxt_ps.clear();
    const int32_t* row_ids = cand_ids + (int64_t)t * K;
    const float* row_lp = cand_logp + (int64_t)t * K;
    for (size_t bi = 0; bi < cur_ids.size(); ++bi) {
      const int32_t pid = cur_ids[bi];
      const PrefixScore& ps = cur_ps[bi];
      for (int32_t j = 0; j < K; ++j) {
        const int32_t tok = row_ids[j];
        const double p = (double)row_lp[j];
        if (p < -12.0 && tok != blank_id) continue;
        if (tok == blank_id) {
          PrefixScore& ns = get_next(pid);
          ns.pb = log_add(ns.pb, ps.total() + p);
          if (ns.times_b.empty()) ns.times_b = ps.times();
          ns.ctx_state = ps.ctx_state;
          ns.ctx_score = ps.ctx_score;
        } else if (pid != 0 && tok == last_tok(pid)) {
          {
            PrefixScore& ns = get_next(pid);
            ns.pnb = log_add(ns.pnb, ps.pnb + p);
            ns.ctx_state = ps.ctx_state;
            ns.ctx_score = ps.ctx_score;
            if (p > ns.cur_token_prob) {
              ns.cur_token_prob = p;
              ns.times_nb = ps.times_nb;
              if (!ns.times_nb.empty()) ns.times_nb.back() = t;
            }
          }
          const int32_t np = extend_prefix(pid, tok);
          PrefixScore& ns2 = get_next(np);
          ns2.pnb = log_add(ns2.pnb, ps.pb + p);
          extend_ctx(ns2, ps, tok);
          if (p > ns2.cur_token_prob) {
            ns2.cur_token_prob = p;
            ns2.times_nb = ps.times();
            ns2.times_nb.push_back(t);
          }
        } else {
          const int32_t np = extend_prefix(pid, tok);
          PrefixScore& ns = get_next(np);
          ns.pnb = log_add(ns.pnb, ps.total() + p);
          extend_ctx(ns, ps, tok);
          if (p > ns.cur_token_prob) {
            ns.cur_token_prob = p;
            ns.times_nb = ps.times();
            ns.times_nb.push_back(t);
          }
        }
      }
    }
    // second prune: keep `beam` best by score_with_ctx, stable over the
    // first-touch insertion order (Python's dict-ordered sorted())
    std::vector<int32_t> order((size_t)nxt_order.size());
    for (size_t i = 0; i < order.size(); ++i) order[i] = (int32_t)i;
    std::stable_sort(order.begin(), order.end(),
                     [&](int32_t a, int32_t b) {
                       return nxt_ps[a].score_with_ctx() >
                              nxt_ps[b].score_with_ctx();
                     });
    const size_t keep =
        std::min((size_t)beam, order.size());
    cur_ids.clear();
    std::vector<PrefixScore> new_ps;
    new_ps.reserve(keep);
    for (size_t i = 0; i < keep; ++i) {
      cur_ids.push_back(nxt_order[order[i]]);
      new_ps.push_back(std::move(nxt_ps[order[i]]));
    }
    cur_ps = std::move(new_ps);
  }

  // final scoring + stable sort (mirrors the Python tail)
  std::vector<double> fscore(cur_ids.size());
  for (size_t i = 0; i < cur_ids.size(); ++i) {
    fscore[i] = cur_ps[i].score_with_ctx();
    if (use_ctx) fscore[i] += trie.final_retract(cur_ps[i].ctx_state);
  }
  std::vector<int32_t> order(cur_ids.size());
  for (size_t i = 0; i < order.size(); ++i) order[i] = (int32_t)i;
  std::stable_sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    return fscore[a] > fscore[b];
  });

  const int32_t n_out = (int32_t)order.size();
  for (int32_t o = 0; o < n_out; ++o) {
    const int32_t i = order[o];
    // reconstruct ids by walking the prefix trie
    std::vector<int32_t> ids;
    for (int32_t pid = cur_ids[i]; pid != 0;
         pid = pref_nodes[pid].first)
      ids.push_back(pref_nodes[pid].second);
    std::reverse(ids.begin(), ids.end());
    const int32_t len = std::min((int32_t)ids.size(), max_len);
    out_lens[o] = len;
    out_scores[o] = (float)fscore[i];
    std::memcpy(out_ids + (int64_t)o * max_len, ids.data(),
                (size_t)len * sizeof(int32_t));
    const auto& tm = cur_ps[i].times();
    const int32_t tn = std::min((int32_t)tm.size(), max_len);
    for (int32_t k = 0; k < tn; ++k)
      out_times[(int64_t)o * max_len + k] = tm[k];
    // pad times to len with -1 (shorter viterbi lists keep their size
    // on the Python side via out_lens of times = tn)
    for (int32_t k = tn; k < len; ++k)
      out_times[(int64_t)o * max_len + k] = -1;
  }
  return n_out;
}
