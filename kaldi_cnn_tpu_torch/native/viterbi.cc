// Native host Viterbi core over CSR-packed graphs.
//
// C++ re-implementation of the token-passing loop of
// src/decoder/faster-decoder.cc (ProcessEmitting / ProcessNonemitting
// with beam + max-active pruning) against the same flat arc arrays as
// decode/graph.py CompiledGraph.  Semantics match decode/decoder.py
// _viterbi: per-destination min with first-arc tie-break, epsilon
// relaxation to fixpoint, pruning after the eps pass.
//
// Exposed as a C ABI for ctypes; the Python layer falls back to the
// numpy implementation when this library is unavailable.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr float kInf = std::numeric_limits<float>::infinity();

struct Trace {
  std::vector<int64_t> prev;
  std::vector<int32_t> ilabel;
  std::vector<int32_t> olabel;
  Trace() : prev(1, -1), ilabel(1, 0), olabel(1, 0) {}
  int64_t push(int64_t p, int32_t il, int32_t ol) {
    prev.push_back(p);
    ilabel.push_back(il);
    olabel.push_back(ol);
    return static_cast<int64_t>(prev.size()) - 1;
  }
};

struct Graph {
  int32_t num_states;
  int32_t start;
  int64_t n_emitting, n_eps;
  const int32_t *e_src, *e_dst, *e_ilabel, *e_olabel, *e_pdf;
  const float *e_w;
  const int32_t *n_src, *n_dst, *n_olabel;
  const float *n_w;
  const float *final_w;
  float wip;  // word-insertion penalty, applied on word-emitting arcs
};

// Epsilon relaxation to fixpoint (Gauss-Seidel sweeps; the eps
// subgraph of HCLG is a DAG so this converges fast).
void EpsExpand(const Graph& g, std::vector<float>* cost,
               std::vector<int64_t>* tok, Trace* trace) {
  if (g.n_eps == 0) return;
  for (int iter = 0; iter < 1000; ++iter) {
    bool changed = false;
    for (int64_t a = 0; a < g.n_eps; ++a) {
      float c = (*cost)[g.n_src[a]] + g.n_w[a];
      if (g.wip != 0.0f && g.n_olabel[a] > 0) c += g.wip;
      if (c < (*cost)[g.n_dst[a]] - 1e-6f) {
        (*cost)[g.n_dst[a]] = c;
        (*tok)[g.n_dst[a]] = trace->push((*tok)[g.n_src[a]], 0,
                                         g.n_olabel[a]);
        changed = true;
      }
    }
    if (!changed) return;
  }
}

}  // namespace

extern "C" {

// Returns number of frames traced (== T on success), -1 when no path.
// out_tids must hold T entries; out_words holds up to T entries;
// *out_nwords receives the word count; *out_cost the best total cost.
int64_t kct_viterbi(
    int32_t num_states, int32_t start,
    int64_t n_emitting, const int32_t* e_src, const int32_t* e_dst,
    const int32_t* e_ilabel, const int32_t* e_olabel, const float* e_w,
    const int32_t* e_pdf,
    int64_t n_eps, const int32_t* n_src, const int32_t* n_dst,
    const int32_t* n_olabel, const float* n_w,
    const float* final_w,
    const float* loglikes, int64_t T, int64_t P,
    float acoustic_scale, float beam, int32_t max_active,
    int32_t require_final, float word_ins_penalty,
    int32_t* out_tids, int32_t* out_words, int64_t* out_nwords,
    float* out_cost) {
  Graph g{num_states, start, n_emitting, n_eps,
          e_src, e_dst, e_ilabel, e_olabel, e_pdf, e_w,
          n_src, n_dst, n_olabel, n_w, final_w, word_ins_penalty};
  Trace trace;
  std::vector<float> cost(num_states, kInf);
  std::vector<int64_t> tok(num_states, 0);
  std::vector<float> new_cost(num_states);
  std::vector<int64_t> best_arc(num_states);
  cost[start] = 0.0f;
  EpsExpand(g, &cost, &tok, &trace);

  const bool use_beam = std::isfinite(beam);
  std::vector<float> tmp;
  for (int64_t t = 0; t < T; ++t) {
    const float* am = loglikes + t * P;
    std::fill(new_cost.begin(), new_cost.end(), kInf);
    std::fill(best_arc.begin(), best_arc.end(), -1);
    for (int64_t a = 0; a < n_emitting; ++a) {
      float sc = cost[e_src[a]];
      if (sc == kInf) continue;
      float c = sc + e_w[a] - acoustic_scale * am[e_pdf[a]];
      if (word_ins_penalty != 0.0f && e_olabel[a] > 0)
        c += word_ins_penalty;
      if (c < new_cost[e_dst[a]]) {
        new_cost[e_dst[a]] = c;
        best_arc[e_dst[a]] = a;
      }
    }
    // materialize tokens for reached states; src tokens are the
    // previous frame's, so build into a fresh vector
    std::vector<int64_t> next_tok(num_states, 0);
    for (int32_t s = 0; s < num_states; ++s) {
      if (best_arc[s] >= 0) {
        int64_t a = best_arc[s];
        next_tok[s] = trace.push(tok[e_src[a]], e_ilabel[a],
                                 e_olabel[a]);
      }
    }
    tok.swap(next_tok);
    cost.swap(new_cost);
    EpsExpand(g, &cost, &tok, &trace);
    if (use_beam) {
      float cmin = kInf;
      for (float c : cost) cmin = std::min(cmin, c);
      float cutoff = cmin + beam;
      for (float& c : cost)
        if (c > cutoff) c = kInf;
    }
    if (max_active > 0) {
      tmp.clear();
      for (float c : cost)
        if (c != kInf) tmp.push_back(c);
      if (static_cast<int32_t>(tmp.size()) > max_active) {
        std::nth_element(tmp.begin(), tmp.begin() + max_active,
                         tmp.end());
        float kth = tmp[max_active];
        for (float& c : cost)
          if (c > kth) c = kInf;
      }
    }
  }

  // pick final state
  float best = kInf;
  int32_t best_state = -1;
  for (int32_t s = 0; s < num_states; ++s) {
    float c = cost[s] + final_w[s];
    if (c < best) { best = c; best_state = s; }
  }
  if (best_state < 0 || best == kInf) {
    if (require_final) return -1;
    for (int32_t s = 0; s < num_states; ++s) {
      if (cost[s] < best) { best = cost[s]; best_state = s; }
    }
    if (best_state < 0 || best == kInf) return -1;
  }
  *out_cost = best;
  // unwind
  std::vector<int32_t> tids, words;
  for (int64_t i = tok[best_state]; i > 0; i = trace.prev[i]) {
    if (trace.ilabel[i] > 0) tids.push_back(trace.ilabel[i]);
    if (trace.olabel[i] > 0) words.push_back(trace.olabel[i]);
  }
  std::reverse(tids.begin(), tids.end());
  std::reverse(words.begin(), words.end());
  if (require_final && static_cast<int64_t>(tids.size()) != T) return -1;
  int64_t nt = std::min<int64_t>(tids.size(), T);
  std::memcpy(out_tids, tids.data(), nt * sizeof(int32_t));
  int64_t nw = std::min<int64_t>(words.size(), T);
  std::memcpy(out_words, words.data(), nw * sizeof(int32_t));
  *out_nwords = nw;
  return nt;
}

}  // extern "C"
