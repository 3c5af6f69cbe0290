// Copy of the JAX package's native/src/native.cc; unchanged below this line.
// asr2pass_tpu native host library.
// See api.h for the contract; behavior matches the Python fallbacks in
// frontend/audio.py (linear_resample), decode/context_graph.py, and
// text/timestamps.py (_edit alignment) — parity-tested from Python.
#include "api.h"

#include <cmath>
#include <cstring>
#include <numeric>
#include <queue>
#include <unordered_map>
#include <vector>

namespace {
constexpr double kPi = 3.14159265358979323846;

double hann_sinc(double t, double cutoff, double window_width) {
  if (std::fabs(t) >= window_width) return 0.0;
  double win = 0.5 * (1.0 + std::cos(kPi * t / window_width));
  if (std::fabs(t) < 1e-12) return win * 2.0 * cutoff;
  return win * std::sin(2.0 * kPi * cutoff * t) / (kPi * t);
}
}  // namespace

extern "C" int64_t a2p_resample(const float* in, int64_t n_in, int fs_in,
                                int fs_out, int num_zeros, float* out) {
  if (fs_in == fs_out) {
    std::memcpy(out, in, sizeof(float) * n_in);
    return n_in;
  }
  const int g = std::gcd(fs_in, fs_out);
  const double cutoff = 0.99 * 0.5 * std::min(fs_in, fs_out);
  const double window_width = num_zeros / (2.0 * cutoff);
  const int64_t n_out =
      (int64_t)std::ceil((double)n_in * fs_out / fs_in);
  const int num_phases = fs_out / g;
  const int step_in = fs_in / g;
  const int half_span = (int)std::ceil(window_width * fs_in) + 1;
  const int n_taps = 2 * half_span + 1;

  // per-phase filters + anchors
  std::vector<double> filters((size_t)num_phases * n_taps);
  std::vector<int64_t> anchors(num_phases);
  for (int p = 0; p < num_phases; ++p) {
    const double t_out = (double)p / fs_out;
    const int64_t center = (int64_t)std::floor(t_out * fs_in);
    anchors[p] = center;
    for (int k = 0; k < n_taps; ++k) {
      const double t_tap =
          (double)(center + k - half_span) / fs_in - t_out;
      filters[(size_t)p * n_taps + k] =
          hann_sinc(t_tap, cutoff, window_width) / fs_in;
    }
  }
  for (int64_t k = 0; k < n_out; ++k) {
    const int64_t cycle = k / num_phases;
    const int phase = (int)(k % num_phases);
    const int64_t base = cycle * (int64_t)step_in + anchors[phase];
    const double* f = &filters[(size_t)phase * n_taps];
    double acc = 0.0;
    for (int t = 0; t < n_taps; ++t) {
      const int64_t idx = base + t - half_span;
      if (idx >= 0 && idx < n_in) acc += (double)in[idx] * f[t];
    }
    out[k] = (float)acc;
  }
  return n_out;
}

// ---------------- Aho-Corasick bias automaton ----------------
struct AcNode {
  std::unordered_map<int32_t, int32_t> next;
  int32_t fail = 0;
  float score = 0.f;   // incremental score entering this node
  float total = 0.f;   // cumulative from root
  bool is_end = false;
};

struct A2pAcBias {
  std::vector<AcNode> nodes;
};

extern "C" A2pAcBias* a2p_ac_build(const int32_t* symbols,
                                   const int32_t* word_lens,
                                   const float* per_symbol_scores,
                                   int32_t n_words) {
  auto* ac = new A2pAcBias();
  ac->nodes.emplace_back();  // root = 0
  int64_t off = 0;
  for (int32_t w = 0; w < n_words; ++w) {
    int32_t cur = 0;
    for (int32_t i = 0; i < word_lens[w]; ++i) {
      const int32_t sym = symbols[off + i];
      auto it = ac->nodes[cur].next.find(sym);
      if (it == ac->nodes[cur].next.end()) {
        const int32_t nid = (int32_t)ac->nodes.size();
        ac->nodes.emplace_back();
        ac->nodes[nid].score = per_symbol_scores[w];
        ac->nodes[nid].total = ac->nodes[cur].total + per_symbol_scores[w];
        ac->nodes[cur].next[sym] = nid;
        cur = nid;
      } else {
        cur = it->second;
      }
    }
    ac->nodes[cur].is_end = true;
    off += word_lens[w];
  }
  // BFS failure links
  std::queue<int32_t> q;
  for (auto& kv : ac->nodes[0].next) q.push(kv.second);
  while (!q.empty()) {
    const int32_t u = q.front();
    q.pop();
    for (auto& kv : ac->nodes[u].next) {
      const int32_t sym = kv.first;
      const int32_t v = kv.second;
      int32_t f = ac->nodes[u].fail;
      while (f != 0 && !ac->nodes[f].next.count(sym))
        f = ac->nodes[f].fail;
      auto it = ac->nodes[f].next.find(sym);
      ac->nodes[v].fail = (it != ac->nodes[f].next.end() && it->second != v)
                              ? it->second
                              : 0;
      q.push(v);
    }
  }
  return ac;
}

extern "C" void a2p_ac_free(A2pAcBias* ac) { delete ac; }

extern "C" int32_t a2p_ac_num_states(const A2pAcBias* ac) {
  return (int32_t)ac->nodes.size();
}

extern "C" float a2p_ac_step(const A2pAcBias* ac, int32_t* state,
                             int32_t symbol) {
  const auto& nodes = ac->nodes;
  int32_t cur = *state;
  float delta = 0.f;
  // follow goto, else failure chain (retracting scores along the way)
  while (true) {
    auto it = nodes[cur].next.find(symbol);
    if (it != nodes[cur].next.end()) {
      const int32_t nxt = it->second;
      delta += nodes[nxt].score;
      // full word with no continuation: bank the score, return to fail
      if (nodes[nxt].is_end && nodes[nxt].next.empty()) {
        *state = 0;
      } else {
        *state = nxt;
      }
      return delta;
    }
    if (cur == 0) {
      *state = 0;
      return delta;
    }
    // retract down the failure chain: drop to the longest proper suffix
    const int32_t f = nodes[cur].fail;
    delta += nodes[f].total - nodes[cur].total;
    cur = f;
  }
}

extern "C" float a2p_ac_final(const A2pAcBias* ac, int32_t state) {
  return -ac->nodes[state].total;
}

// ---------------- Levenshtein alignment ----------------
extern "C" int64_t a2p_edit_align(const int32_t* a, int64_t n,
                                  const int32_t* b, int64_t m,
                                  int32_t* ops_out, int32_t* dist) {
  std::vector<int32_t> dp((size_t)(n + 1) * (m + 1));
  auto at = [&](int64_t i, int64_t j) -> int32_t& {
    return dp[(size_t)i * (m + 1) + j];
  };
  for (int64_t i = 0; i <= n; ++i) at(i, 0) = (int32_t)i;
  for (int64_t j = 0; j <= m; ++j) at(0, j) = (int32_t)j;
  for (int64_t i = 1; i <= n; ++i) {
    for (int64_t j = 1; j <= m; ++j) {
      const int32_t sub = at(i - 1, j - 1) + (a[i - 1] != b[j - 1]);
      const int32_t del = at(i - 1, j) + 1;
      const int32_t ins = at(i, j - 1) + 1;
      at(i, j) = std::min(sub, std::min(del, ins));
    }
  }
  *dist = at(n, m);
  // backtrack
  std::vector<int32_t> rev;
  int64_t i = n, j = m;
  while (i > 0 || j > 0) {
    if (i > 0 && j > 0 && at(i, j) == at(i - 1, j - 1) &&
        a[i - 1] == b[j - 1]) {
      rev.push_back(0);
      --i;
      --j;
    } else if (i > 0 && j > 0 && at(i, j) == at(i - 1, j - 1) + 1) {
      rev.push_back(1);
      --i;
      --j;
    } else if (i > 0 && at(i, j) == at(i - 1, j) + 1) {
      rev.push_back(2);
      --i;
    } else {
      rev.push_back(3);
      --j;
    }
  }
  const int64_t cnt = (int64_t)rev.size();
  for (int64_t k = 0; k < cnt; ++k) ops_out[k] = rev[cnt - 1 - k];
  return cnt;
}
