// Native host helpers for flye_jax hot loops.
//
// The reference keeps its host runtime in C++ (thread pool, containers,
// parsers — reference: src/common/, src/sequence/sequence_container.cpp);
// flye_jax keeps the device plane in JAX and implements the hot HOST
// loops here: chain backtracking (the only sequential part of overlap
// detection, reference: src/sequence/overlap.cpp:330-385) and
// FASTA/FASTQ byte packing.  Interfaces use the buffer protocol (bytes
// in/out) so no NumPy C API is needed; Python wraps results with
// np.frombuffer.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <thread>
#include <utility>
#include <vector>

// ---------------------------------------------------------------------
// backtrack_chains(score_bytes, parent_bytes, n, k, max_chains)
//   score/parent: int32 arrays as bytes; returns list of
//   (first, last, chain_score, path_bytes[int32])
// Mirrors the reference's score-ordered backtracking with visited
// marking (reference: overlap.cpp:330-385).
// ---------------------------------------------------------------------
static PyObject* backtrack_chains(PyObject*, PyObject* args) {
  Py_buffer score_buf, parent_buf;
  Py_ssize_t n;
  int k, max_chains;
  if (!PyArg_ParseTuple(args, "y*y*nii", &score_buf, &parent_buf, &n, &k,
                        &max_chains)) {
    return nullptr;
  }
  const int32_t* score = static_cast<const int32_t*>(score_buf.buf);
  std::vector<int32_t> parent(n);
  std::memcpy(parent.data(), parent_buf.buf, n * sizeof(int32_t));

  // argsort by -score, stable
  std::vector<int32_t> order(n);
  for (Py_ssize_t i = 0; i < n; ++i) order[i] = (int32_t)i;
  std::stable_sort(order.begin(), order.end(),
                   [&](int32_t a, int32_t b) { return score[a] > score[b]; });

  PyObject* result = PyList_New(0);
  std::vector<int32_t> path;
  for (Py_ssize_t oi = 0; oi < n; ++oi) {
    int32_t start = order[oi];
    if (parent[start] == -1) continue;
    path.clear();
    int32_t pos = start;
    while (pos != -1) {
      path.push_back(pos);
      int32_t nxt = parent[pos];
      parent[pos] = -1;
      pos = nxt;
    }
    int32_t first = path.back();
    int32_t last = path.front();
    int64_t chain_score =
        (int64_t)score[last] - (int64_t)score[first] + k - 1;
    std::reverse(path.begin(), path.end());
    PyObject* path_bytes = PyBytes_FromStringAndSize(
        reinterpret_cast<const char*>(path.data()),
        path.size() * sizeof(int32_t));
    PyObject* tup = Py_BuildValue("iiLN", first, last,
                                  (long long)chain_score, path_bytes);
    PyList_Append(result, tup);
    Py_DECREF(tup);
    if (max_chains > 0 && PyList_Size(result) >= max_chains) break;
  }
  PyBuffer_Release(&score_buf);
  PyBuffer_Release(&parent_buf);
  return result;
}

// ---------------------------------------------------------------------
// pack_sequences(raw_bytes, is_fastq) -> (codes_bytes, offsets_bytes,
//                                         names_list)
//   One pass over a FASTA/FASTQ blob: translate ACGTacgt -> 0..3
//   (others -> 0), concatenate into a code arena with int64 offsets.
// ---------------------------------------------------------------------
static PyObject* pack_sequences(PyObject*, PyObject* args) {
  Py_buffer raw;
  int is_fastq;
  if (!PyArg_ParseTuple(args, "y*i", &raw, &is_fastq)) return nullptr;
  const char* data = static_cast<const char*>(raw.buf);
  const Py_ssize_t len = raw.len;

  static unsigned char table[256];
  static bool init = false;
  if (!init) {
    std::memset(table, 0, sizeof(table));
    table[(unsigned char)'C'] = table[(unsigned char)'c'] = 1;
    table[(unsigned char)'G'] = table[(unsigned char)'g'] = 2;
    table[(unsigned char)'T'] = table[(unsigned char)'t'] = 3;
    init = true;
  }

  std::vector<unsigned char> codes;
  codes.reserve(len / 2);
  std::vector<int64_t> offsets;
  offsets.push_back(0);
  PyObject* names = PyList_New(0);

  Py_ssize_t i = 0;
  auto append_name = [&](const char* s, Py_ssize_t l) {
    Py_ssize_t e = 0;
    while (e < l && s[e] != ' ' && s[e] != '\t' && s[e] != '\r') ++e;
    PyObject* nm = PyUnicode_FromStringAndSize(s, e);
    PyList_Append(names, nm);
    Py_DECREF(nm);
  };

  if (is_fastq) {
    while (i < len) {
      // header line
      while (i < len && (data[i] == '\n' || data[i] == '\r')) ++i;
      if (i >= len) break;
      if (data[i] != '@') {
        PyErr_SetString(PyExc_ValueError, "malformed FASTQ");
        Py_DECREF(names);
        PyBuffer_Release(&raw);
        return nullptr;
      }
      Py_ssize_t hs = ++i;
      while (i < len && data[i] != '\n') ++i;
      append_name(data + hs, i - hs);
      ++i;
      // sequence line
      while (i < len && data[i] != '\n') {
        if (data[i] != '\r') codes.push_back(table[(unsigned char)data[i]]);
        ++i;
      }
      offsets.push_back((int64_t)codes.size());
      ++i;
      // '+' line
      while (i < len && data[i] != '\n') ++i;
      ++i;
      // quality line
      while (i < len && data[i] != '\n') ++i;
      ++i;
    }
  } else {
    while (i < len && data[i] != '>') ++i;
    while (i < len) {
      Py_ssize_t hs = ++i;  // skip '>'
      while (i < len && data[i] != '\n') ++i;
      append_name(data + hs, i - hs);
      ++i;
      while (i < len && data[i] != '>') {
        char c = data[i];
        if (c != '\n' && c != '\r') codes.push_back(table[(unsigned char)c]);
        ++i;
      }
      offsets.push_back((int64_t)codes.size());
    }
  }

  PyObject* codes_b = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(codes.data()), codes.size());
  PyObject* offs_b = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(offsets.data()),
      offsets.size() * sizeof(int64_t));
  PyBuffer_Release(&raw);
  return Py_BuildValue("NNN", codes_b, offs_b, names);
}

// ---------------------------------------------------------------------
// window_coverage(begins, ends, n, n_windows, window) -> counts bytes
//   Shared helper for chimera/multiplicity window counting.
// ---------------------------------------------------------------------
static PyObject* window_coverage(PyObject*, PyObject* args) {
  Py_buffer beg_buf, end_buf;
  Py_ssize_t n;
  int n_windows, window;
  if (!PyArg_ParseTuple(args, "y*y*nii", &beg_buf, &end_buf, &n,
                        &n_windows, &window)) {
    return nullptr;
  }
  const int32_t* beg = static_cast<const int32_t*>(beg_buf.buf);
  const int32_t* end = static_cast<const int32_t*>(end_buf.buf);
  std::vector<int32_t> cov(n_windows, 0);
  for (Py_ssize_t i = 0; i < n; ++i) {
    int lo = beg[i] / window;
    int hi = end[i] / window;
    if (lo < 0) lo = 0;
    if (hi > n_windows) hi = n_windows;
    for (int w = lo; w < hi; ++w) cov[w] += 1;
  }
  PyObject* out = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(cov.data()),
      cov.size() * sizeof(int32_t));
  PyBuffer_Release(&beg_buf);
  PyBuffer_Release(&end_buf);
  return out;
}

// ---------------------------------------------------------------------
// polish_bubbles_host: CPU-fallback bubble polisher.
//
// Same hill-climbing semantics as the device kernel (ops/polish.py —
// itself a port of the reference GeneralPolisher,
// reference: src/polishing/general_polisher.cpp:8-125): per iteration,
// forward/backward DP tensors score every single-base del/ins/sub
// against all branches at once; improving edits apply greedily
// (best-gain first, skipping adjacent positions), with a monotonicity
// guard that falls back to the single best edit.  The device kernel is
// the production path; this exists so CPU-only runs (tests, dev boxes)
// aren't 100x slower than the reference's threaded C++.
// ---------------------------------------------------------------------
struct PolishScratch {
  std::vector<float> F, B;       // (L+1) x (S+1) DP matrices
  std::vector<float> del_sc;     // L+1
  std::vector<float> ins_sc, sub_sc;  // 4 x (L+1)
  std::vector<float> rowx;       // S+1
};

static void polish_one(const unsigned char* cand_in, int clen_in, int Cb,
                       const unsigned char* branches, const int32_t* blen,
                       const unsigned char* bmask, int R, int S,
                       const float* M, int max_iters, float eps,
                       unsigned char* cand_out, int32_t* len_out,
                       float* score_out, int32_t* iters_out,
                       PolishScratch& sc) {
  std::vector<unsigned char> cand(cand_in, cand_in + Cb);
  int L = clen_in;
  const int W = S + 1;
  float total = 0.f;
  int it = 0;
  std::vector<unsigned char> prev;
  for (; it < max_iters; ++it) {
    int Lp1 = L + 1;
    sc.del_sc.assign(Lp1, 0.f);
    sc.ins_sc.assign(4 * (size_t)Lp1, 0.f);
    sc.sub_sc.assign(4 * (size_t)Lp1, 0.f);
    total = 0.f;
    for (int r = 0; r < R; ++r) {
      if (!bmask[r]) continue;
      const unsigned char* w = branches + (size_t)r * S;
      const int Sr = blen[r];
      sc.F.resize((size_t)Lp1 * (Sr + 1));
      sc.B.resize((size_t)Lp1 * (Sr + 1));
      float* F = sc.F.data();
      float* B = sc.B.data();
      // forward: F[i][j] = best score cand[0:i] vs branch[0:j]
      F[0] = 0.f;
      for (int j = 1; j <= Sr; ++j) F[j] = F[j - 1] + M[4 * 5 + w[j - 1]];
      for (int i = 1; i <= L; ++i) {
        const int c = cand[i - 1];
        float* fi = F + (size_t)i * (Sr + 1);
        const float* fp = fi - (Sr + 1);
        const float vg = M[c * 5 + 4];
        fi[0] = fp[0] + vg;
        for (int j = 1; j <= Sr; ++j) {
          float best = fp[j - 1] + M[c * 5 + w[j - 1]];
          float t = fp[j] + vg;
          if (t > best) best = t;
          t = fi[j - 1] + M[4 * 5 + w[j - 1]];
          if (t > best) best = t;
          fi[j] = best;
        }
      }
      // backward: B[i][j] = best score cand[i:L] vs branch[j:Sr]
      float* bl = B + (size_t)L * (Sr + 1);
      bl[Sr] = 0.f;
      for (int j = Sr - 1; j >= 0; --j) bl[j] = bl[j + 1] + M[4 * 5 + w[j]];
      for (int i = L - 1; i >= 0; --i) {
        const int c = cand[i];
        float* bi = B + (size_t)i * (Sr + 1);
        const float* bn = bi + (Sr + 1);
        const float vg = M[c * 5 + 4];
        bi[Sr] = bn[Sr] + vg;
        for (int j = Sr - 1; j >= 0; --j) {
          float best = bn[j + 1] + M[c * 5 + w[j]];
          float t = bn[j] + vg;
          if (t > best) best = t;
          t = bi[j + 1] + M[4 * 5 + w[j]];
          if (t > best) best = t;
          bi[j] = best;
        }
      }
      total += F[(size_t)L * (Sr + 1) + Sr];
      // edit scores
      sc.rowx.resize(Sr + 1);
      float* rowx = sc.rowx.data();
      for (int p = 0; p <= L; ++p) {
        const float* Fp = F + (size_t)p * (Sr + 1);
        const float* Bp = B + (size_t)p * (Sr + 1);
        const float* Bn = (p < L) ? Bp + (Sr + 1) : nullptr;
        if (p < L) {
          // deletion of cand[p]
          float best = -1e30f;
          for (int j = 0; j <= Sr; ++j) {
            float t = Fp[j] + Bn[j];
            if (t > best) best = t;
          }
          sc.del_sc[p] += best;
        }
        for (int x = 0; x < 4; ++x) {
          const float xg = M[x * 5 + 4];
          rowx[0] = Fp[0] + xg;
          for (int j = 1; j <= Sr; ++j) {
            float a = Fp[j - 1] + M[x * 5 + w[j - 1]];
            float b = Fp[j] + xg;
            rowx[j] = a > b ? a : b;
          }
          float besti = -1e30f;
          for (int j = 0; j <= Sr; ++j) {
            float t = rowx[j] + Bp[j];
            if (t > besti) besti = t;
          }
          sc.ins_sc[(size_t)x * Lp1 + p] += besti;
          if (p < L) {
            float bests = -1e30f;
            for (int j = 0; j <= Sr; ++j) {
              float t = rowx[j] + Bn[j];
              if (t > bests) bests = t;
            }
            sc.sub_sc[(size_t)x * Lp1 + p] += bests;
          }
        }
      }
    }
    // gather improving edits: type 0=del, 1=ins, 2=sub
    struct Edit { float gain; int pos; int type; int chr; };
    std::vector<Edit> edits;
    const float thr = total + eps;
    for (int p = 0; p < L; ++p) {
      if (sc.del_sc[p] > thr)
        edits.push_back({sc.del_sc[p] - total, p, 0, 0});
    }
    for (int p = 0; p <= L; ++p) {
      float best = -1e30f; int bx = 0;
      for (int x = 0; x < 4; ++x) {
        float v = sc.ins_sc[(size_t)x * Lp1 + p];
        if (v > best) { best = v; bx = x; }
      }
      if (best > thr) edits.push_back({best - total, p, 1, bx});
    }
    for (int p = 0; p < L; ++p) {
      float best = -1e30f; int bx = 0;
      for (int x = 0; x < 4; ++x) {
        if (x == cand[p]) continue;
        float v = sc.sub_sc[(size_t)x * Lp1 + p];
        if (v > best) { best = v; bx = x; }
      }
      if (best > thr) edits.push_back({best - total, p, 2, bx});
    }
    if (edits.empty()) break;
    std::stable_sort(edits.begin(), edits.end(),
                     [](const Edit& a, const Edit& b) {
                       if (a.gain != b.gain) return a.gain > b.gain;
                       if (a.pos != b.pos) return a.pos < b.pos;
                       return a.type < b.type;
                     });
    // apply greedily, best gain first, skipping adjacent positions
    prev.assign(cand.begin(), cand.end());
    const int prev_L = L;
    std::vector<char> used(L + 2, 0);
    std::vector<Edit> applied;
    int n_ins = 0, n_del = 0;
    for (const Edit& e : edits) {
      bool clash = false;
      for (int d = -1; d <= 1; ++d) {
        int q = e.pos + d;
        if (q >= 0 && q <= L && used[q]) { clash = true; break; }
      }
      if (clash) continue;
      if (e.type == 1 && L + n_ins - n_del + 1 > Cb) continue;
      n_ins += e.type == 1;
      n_del += e.type == 0;
      used[e.pos] = 1;
      applied.push_back(e);
    }
    // apply in descending position order so indices stay valid
    std::stable_sort(applied.begin(), applied.end(),
                     [](const Edit& a, const Edit& b) {
                       return a.pos > b.pos;
                     });
    for (const Edit& e : applied) {
      if (e.type == 0) {
        cand.erase(cand.begin() + e.pos);
        --L;
      } else if (e.type == 1) {
        cand.insert(cand.begin() + e.pos, (unsigned char)e.chr);
        ++L;
      } else {
        cand[e.pos] = (unsigned char)e.chr;
      }
    }
    if ((int)cand.size() < Cb) cand.resize(Cb, 0);
    else if ((int)cand.size() > Cb) { cand.resize(Cb); }
    if (applied.size() > 1) {
      // monotonicity guard: simultaneous edits interacted badly -> keep
      // only the single best edit (recompute next iteration)
      float new_total = 0.f;
      for (int r = 0; r < R; ++r) {
        if (!bmask[r]) continue;
        const unsigned char* w = branches + (size_t)r * S;
        const int Sr = blen[r];
        sc.F.resize((size_t)(L + 1) * (Sr + 1));
        float* F = sc.F.data();
        F[0] = 0.f;
        for (int j = 1; j <= Sr; ++j)
          F[j] = F[j - 1] + M[4 * 5 + w[j - 1]];
        for (int i = 1; i <= L; ++i) {
          const int c = cand[i - 1];
          float* fi = F + (size_t)i * (Sr + 1);
          const float* fp = fi - (Sr + 1);
          const float vg = M[c * 5 + 4];
          fi[0] = fp[0] + vg;
          for (int j = 1; j <= Sr; ++j) {
            float best = fp[j - 1] + M[c * 5 + w[j - 1]];
            float t = fp[j] + vg;
            if (t > best) best = t;
            t = fi[j - 1] + M[4 * 5 + w[j - 1]];
            if (t > best) best = t;
            fi[j] = best;
          }
        }
        new_total += F[(size_t)L * (Sr + 1) + Sr];
      }
      if (new_total < total) {
        cand.assign(prev.begin(), prev.end());
        cand.resize(Cb, 0);
        L = prev_L;
        // reapply just the highest-gain edit
        const Edit* best = &applied.front();
        for (const Edit& a : applied)
          if (a.gain > best->gain) best = &a;
        if (best->type == 0) {
          cand.erase(cand.begin() + best->pos);
          --L;
        } else if (best->type == 1) {
          cand.insert(cand.begin() + best->pos,
                      (unsigned char)best->chr);
          ++L;
        } else {
          cand[best->pos] = (unsigned char)best->chr;
        }
        cand.resize(Cb, 0);
      }
    }
  }
  std::memcpy(cand_out, cand.data(), Cb);
  *len_out = L;
  *score_out = total;
  *iters_out = it;
}

// ---------------------------------------------------------------------
// banded_align(a_bytes, b_bytes, band) -> ops bytes
//   Banded global edit-distance alignment with traceback.  ops[i] in
//   {0: diagonal (consume a+b), 1: deletion (consume a), 2: insertion
//   (consume b)}, ordered from the start of both sequences.  Used by
//   host-plane consumers that need base-level pileups (Trestle's
//   divergent-position calling — the reference gets pairwise strings
//   from its SAM pipeline, flye/utils/sam_parser.py:260).
// ---------------------------------------------------------------------
static PyObject* banded_align(PyObject*, PyObject* args) {
  Py_buffer a_buf, b_buf;
  int band;
  if (!PyArg_ParseTuple(args, "y*y*i", &a_buf, &b_buf, &band)) {
    return nullptr;
  }
  const unsigned char* a = static_cast<const unsigned char*>(a_buf.buf);
  const unsigned char* b = static_cast<const unsigned char*>(b_buf.buf);
  const int n = (int)a_buf.len, m = (int)b_buf.len;
  // band is centered on the (slope-corrected) diagonal
  const int W = 2 * band + 1;
  const int BIG = 1 << 29;
  // D[i][w] = edit distance for a[0:i], b[0:j] with j = diag(i) + w-band
  auto diag = [&](int i) { return n ? (int)((int64_t)i * m / n) : 0; };
  std::vector<int32_t> D((size_t)(n + 1) * W, BIG);
  auto at = [&](int i, int j) -> int32_t& {
    return D[(size_t)i * W + (j - diag(i) + band)];
  };
  auto inband = [&](int i, int j) {
    int w = j - diag(i) + band;
    return j >= 0 && j <= m && w >= 0 && w < W;
  };
  at(0, 0) = 0;
  for (int j = 1; inband(0, j); ++j) at(0, j) = j;
  for (int i = 1; i <= n; ++i) {
    int lo = diag(i) - band, hi = diag(i) + band;
    if (lo < 0) lo = 0;
    if (hi > m) hi = m;
    for (int j = lo; j <= hi; ++j) {
      int best = BIG;
      if (inband(i - 1, j - 1) && j > 0) {
        int v = at(i - 1, j - 1) + (a[i - 1] != b[j - 1]);
        if (v < best) best = v;
      }
      if (inband(i - 1, j)) {
        int v = at(i - 1, j) + 1;
        if (v < best) best = v;
      }
      if (j > 0 && inband(i, j - 1)) {
        int v = at(i, j - 1) + 1;
        if (v < best) best = v;
      }
      at(i, j) = best;
    }
  }
  // traceback from (n, m)
  std::vector<unsigned char> ops;
  ops.reserve(n + m);
  int i = n, j = m;
  while (i > 0 || j > 0) {
    int cur = inband(i, j) ? at(i, j) : BIG;
    if (i > 0 && j > 0 && inband(i - 1, j - 1) &&
        at(i - 1, j - 1) + (a[i - 1] != b[j - 1]) == cur) {
      ops.push_back(0);
      --i;
      --j;
    } else if (i > 0 && inband(i - 1, j) && at(i - 1, j) + 1 == cur) {
      ops.push_back(1);
      --i;
    } else if (j > 0 && inband(i, j - 1) && at(i, j - 1) + 1 == cur) {
      ops.push_back(2);
      --j;
    } else {
      // fell off the band: emit remaining as del+ins
      if (i > 0) { ops.push_back(1); --i; }
      else { ops.push_back(2); --j; }
    }
  }
  std::reverse(ops.begin(), ops.end());
  PyObject* out = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(ops.data()), ops.size());
  PyBuffer_Release(&a_buf);
  PyBuffer_Release(&b_buf);
  return out;
}

static PyObject* polish_bubbles_host(PyObject*, PyObject* args) {
  Py_buffer cand_buf, clen_buf, br_buf, blen_buf, bmask_buf, subs_buf;
  Py_ssize_t Bn;
  int Cb, R, S, max_iters;
  float eps;
  if (!PyArg_ParseTuple(args, "y*y*y*y*y*y*niiiif", &cand_buf, &clen_buf,
                        &br_buf, &blen_buf, &bmask_buf, &subs_buf, &Bn,
                        &Cb, &R, &S, &max_iters, &eps)) {
    return nullptr;
  }
  const unsigned char* cand = static_cast<const unsigned char*>(cand_buf.buf);
  const int32_t* clen = static_cast<const int32_t*>(clen_buf.buf);
  const unsigned char* branches = static_cast<const unsigned char*>(br_buf.buf);
  const int32_t* blen = static_cast<const int32_t*>(blen_buf.buf);
  const unsigned char* bmask = static_cast<const unsigned char*>(bmask_buf.buf);
  const float* subs = static_cast<const float*>(subs_buf.buf);

  std::vector<unsigned char> out_cand((size_t)Bn * Cb);
  std::vector<int32_t> out_len(Bn);
  std::vector<float> out_score(Bn);
  std::vector<int32_t> out_iters(Bn);

  std::atomic<Py_ssize_t> next(0);
  auto worker = [&]() {
    PolishScratch sc;
    for (;;) {
      Py_ssize_t b = next.fetch_add(1);
      if (b >= Bn) break;
      polish_one(cand + (size_t)b * Cb, clen[b], Cb,
                 branches + (size_t)b * R * S, blen + (size_t)b * R,
                 bmask + (size_t)b * R, R, S, subs, max_iters, eps,
                 out_cand.data() + (size_t)b * Cb, &out_len[b],
                 &out_score[b], &out_iters[b], sc);
    }
  };
  unsigned hw = std::thread::hardware_concurrency();
  int nt = hw ? (int)hw : 2;
  if (nt > Bn) nt = (int)Bn;
  if (nt < 1) nt = 1;
  Py_BEGIN_ALLOW_THREADS;
  std::vector<std::thread> threads;
  for (int t = 1; t < nt; ++t) threads.emplace_back(worker);
  worker();
  for (auto& th : threads) th.join();
  Py_END_ALLOW_THREADS;

  PyObject* cand_b = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(out_cand.data()), out_cand.size());
  PyObject* len_b = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(out_len.data()),
      out_len.size() * sizeof(int32_t));
  PyObject* score_b = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(out_score.data()),
      out_score.size() * sizeof(float));
  PyObject* iters_b = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(out_iters.data()),
      out_iters.size() * sizeof(int32_t));
  for (Py_buffer* pb : {&cand_buf, &clen_buf, &br_buf, &blen_buf,
                        &bmask_buf, &subs_buf}) {
    PyBuffer_Release(pb);
  }
  return Py_BuildValue("NNNN", cand_b, len_b, score_b, iters_b);
}

// ---------------------------------------------------------------------
// chain_group_prep: per-query match grouping + survival filters +
// chain-bucket prep for the overlap engine's hot loop
// (behavioral port of the group segmentation in
// reference: src/sequence/overlap.cpp:201-276, restructured as one
// batched call; replaces the per-group Python loops that dominated the
// ava phase's host time).
//
// Inputs (bytes buffers over the whole batch):
//   qpos   int32[M]   query positions of matches
//   extid  int64[M]   strand-encoded target ids
//   extpos int32[M]   target positions
//   qbounds int64[nq+1] per-query match ranges into the above
//   curlens int32[nq]  query lengths
//   tlens  int64[nt]   target lengths by (extid >> 1)
//   min_surv (double), min_overlap, max_overhang (ints),
//   check_overhang (0/1), max_bucket (stride-subsample cap),
//   group_cap (>0: stop emitting groups for a query once this many
//   survive the filters — the maxCurOverlaps economy,
//   reference: overlap.cpp:218-219)
// Returns (qi, eid, elen, stride, goff, gcur, gext) bytes:
//   qi int32[G], eid int64[G], elen int32[G], stride int32[G],
//   goff int64[G+1] offsets into gcur/gext int32[total]
// ---------------------------------------------------------------------
static PyObject* chain_group_prep(PyObject*, PyObject* args) {
  Py_buffer qpos_b, extid_b, extpos_b, qb_b, clen_b, tlen_b;
  double min_surv;
  int min_overlap, max_overhang, check_overhang, max_bucket, group_cap;
  Py_ssize_t nq;
  if (!PyArg_ParseTuple(args, "y*y*y*y*y*y*ndiiiii", &qpos_b, &extid_b,
                        &extpos_b, &qb_b, &clen_b, &tlen_b, &nq, &min_surv,
                        &min_overlap, &max_overhang, &check_overhang,
                        &max_bucket, &group_cap)) {
    return nullptr;
  }
  const int32_t* qpos = static_cast<const int32_t*>(qpos_b.buf);
  const int64_t* extid = static_cast<const int64_t*>(extid_b.buf);
  const int32_t* extpos = static_cast<const int32_t*>(extpos_b.buf);
  const int64_t* qbounds = static_cast<const int64_t*>(qb_b.buf);
  const int32_t* curlens = static_cast<const int32_t*>(clen_b.buf);
  const int64_t* tlens = static_cast<const int64_t*>(tlen_b.buf);

  struct QOut {
    std::vector<int64_t> eid;
    std::vector<int32_t> elen, stride;
    std::vector<int64_t> glen;
    std::vector<int32_t> gcur, gext;
  };
  std::vector<QOut> per_q(nq);

  std::atomic<Py_ssize_t> next(0);
  auto worker = [&]() {
    std::vector<int64_t> order;
    for (;;) {
      Py_ssize_t qi = next.fetch_add(1);
      if (qi >= nq) break;
      const int64_t s0 = qbounds[qi], e0 = qbounds[qi + 1];
      const int64_t m = e0 - s0;
      if (m == 0) continue;
      QOut& out = per_q[qi];
      const int32_t cur_len = curlens[qi];
      order.resize(m);
      for (int64_t i = 0; i < m; ++i) order[i] = s0 + i;
      // lexsort: primary extid, secondary qpos, ties by index (stable)
      std::sort(order.begin(), order.end(),
                [&](int64_t a, int64_t b) {
                  if (extid[a] != extid[b]) return extid[a] < extid[b];
                  if (qpos[a] != qpos[b]) return qpos[a] < qpos[b];
                  return a < b;
                });
      int64_t gs = 0;
      int emitted = 0;
      while (gs < m) {
        if (group_cap > 0 && emitted >= group_cap) break;
        int64_t ge = gs;
        const int64_t eid = extid[order[gs]];
        int64_t uniq = 0;
        int32_t prev_pos = -1;
        int32_t min_ext = INT32_MAX, max_ext = INT32_MIN;
        while (ge < m && extid[order[ge]] == eid) {
          const int32_t qp = qpos[order[ge]];
          if (ge == gs || qp != prev_pos) ++uniq;
          prev_pos = qp;
          const int32_t ep = extpos[order[ge]];
          if (ep < min_ext) min_ext = ep;
          if (ep > max_ext) max_ext = ep;
          ++ge;
        }
        const int32_t min_cur = qpos[order[gs]];
        const int32_t max_cur = qpos[order[ge - 1]];
        const int64_t elen = tlens[eid >> 1];
        bool keep = (double)uniq >= min_surv &&
                    max_cur - min_cur >= min_overlap &&
                    max_ext - min_ext >= min_overlap;
        if (keep && check_overhang) {
          if (std::min(min_cur, min_ext) > max_overhang) keep = false;
          if (std::min((int64_t)cur_len - max_cur, elen - max_ext) >
              max_overhang) {
            keep = false;
          }
        }
        if (keep) {
          ++emitted;
          const int64_t glen = ge - gs;
          out.eid.push_back(eid);
          out.elen.push_back((int32_t)elen);
          // copy (already sorted by qpos)
          std::vector<int32_t> gc(glen), gx(glen);
          for (int64_t i = 0; i < glen; ++i) {
            gc[i] = qpos[order[gs + i]];
            gx[i] = extpos[order[gs + i]];
          }
          if (elen > cur_len) {
            // stable re-sort by ext position (matches the engine's
            // np.argsort(gext, kind='stable') reorder)
            std::vector<int32_t> idx(glen);
            for (int64_t i = 0; i < glen; ++i) idx[i] = (int32_t)i;
            std::stable_sort(idx.begin(), idx.end(),
                             [&](int32_t a, int32_t b) {
                               return gx[a] < gx[b];
                             });
            std::vector<int32_t> gc2(glen), gx2(glen);
            for (int64_t i = 0; i < glen; ++i) {
              gc2[i] = gc[idx[i]];
              gx2[i] = gx[idx[i]];
            }
            gc.swap(gc2);
            gx.swap(gx2);
          }
          int32_t stride = 1;
          int64_t kept = glen;
          if (glen > max_bucket) {
            stride = (int32_t)((glen + max_bucket - 1) / max_bucket);
            kept = (glen + stride - 1) / stride;
          }
          out.stride.push_back(stride);
          out.glen.push_back(kept);
          for (int64_t i = 0; i < glen; i += stride) {
            out.gcur.push_back(gc[i]);
            out.gext.push_back(gx[i]);
          }
        }
        gs = ge;
      }
    }
  };
  unsigned hw = std::thread::hardware_concurrency();
  int nt_threads = hw ? (int)hw : 2;
  if (nt_threads > nq) nt_threads = (int)nq;
  if (nt_threads < 1) nt_threads = 1;
  Py_BEGIN_ALLOW_THREADS;
  std::vector<std::thread> threads;
  for (int t = 1; t < nt_threads; ++t) threads.emplace_back(worker);
  worker();
  for (auto& th : threads) th.join();
  Py_END_ALLOW_THREADS;

  // concatenate in query order (deterministic)
  int64_t G = 0, total = 0;
  for (auto& q : per_q) {
    G += (int64_t)q.eid.size();
    total += (int64_t)q.gcur.size();
  }
  std::vector<int32_t> qi_out;
  qi_out.reserve(G);
  std::vector<int64_t> eid_out;
  eid_out.reserve(G);
  std::vector<int32_t> elen_out, stride_out;
  elen_out.reserve(G);
  stride_out.reserve(G);
  std::vector<int64_t> goff(1, 0);
  goff.reserve(G + 1);
  std::vector<int32_t> gcur_out, gext_out;
  gcur_out.reserve(total);
  gext_out.reserve(total);
  for (Py_ssize_t qi = 0; qi < nq; ++qi) {
    QOut& q = per_q[qi];
    for (size_t j = 0; j < q.eid.size(); ++j) {
      qi_out.push_back((int32_t)qi);
      eid_out.push_back(q.eid[j]);
      elen_out.push_back(q.elen[j]);
      stride_out.push_back(q.stride[j]);
      goff.push_back(goff.back() + q.glen[j]);
    }
    gcur_out.insert(gcur_out.end(), q.gcur.begin(), q.gcur.end());
    gext_out.insert(gext_out.end(), q.gext.begin(), q.gext.end());
  }

  auto as_bytes = [](const void* p, size_t nbytes) {
    return PyBytes_FromStringAndSize(static_cast<const char*>(p),
                                     (Py_ssize_t)nbytes);
  };
  PyObject* r = Py_BuildValue(
      "NNNNNNN",
      as_bytes(qi_out.data(), qi_out.size() * 4),
      as_bytes(eid_out.data(), eid_out.size() * 8),
      as_bytes(elen_out.data(), elen_out.size() * 4),
      as_bytes(stride_out.data(), stride_out.size() * 4),
      as_bytes(goff.data(), goff.size() * 8),
      as_bytes(gcur_out.data(), gcur_out.size() * 4),
      as_bytes(gext_out.data(), gext_out.size() * 4));
  for (Py_buffer* pb :
       {&qpos_b, &extid_b, &extpos_b, &qb_b, &clen_b, &tlen_b}) {
    PyBuffer_Release(pb);
  }
  return r;
}

// ---------------------------------------------------------------------
// count_kmer_freqs: per-position global k-mer frequencies via a flat
// saturating uint8 counter table over the 4^k key space (the
// reference's KmerCounter design, vertex_index.cpp:504-557, which uses
// 4-bit counters + an overflow map; uint8 saturation at 255 is exact
// for every decision the solid-index selection makes — its per-read
// threshold is clamped to <= 4).  Replaces a full argsort of the
// k-mer stream (measured 40 min / 87 Gb peak at 1.46 G k-mers on the
// 50 Mb run) with two linear passes.
//
// kmers int64[M] canonical; k (table = 4^k bytes, caller gates size).
// Returns freq uint8[M].
// ---------------------------------------------------------------------
static PyObject* count_kmer_freqs(PyObject*, PyObject* args) {
  Py_buffer km_b;
  int k;
  if (!PyArg_ParseTuple(args, "y*i", &km_b, &k)) return nullptr;
  const int64_t* kmers = static_cast<const int64_t*>(km_b.buf);
  const Py_ssize_t M = km_b.len / 8;
  const uint64_t space = 1ull << (2 * k);
  std::vector<uint8_t> table;
  try {
    table.assign(space, 0);
  } catch (const std::bad_alloc&) {
    PyBuffer_Release(&km_b);
    PyErr_SetString(PyExc_MemoryError, "k-mer counter table");
    return nullptr;
  }
  std::vector<uint8_t> freq(M);
  Py_BEGIN_ALLOW_THREADS;
  {
    // two threads partition the VALUE space by the top key bit, each
    // scanning the whole stream — no atomics, deterministic
    unsigned hw = std::thread::hardware_concurrency();
    int nt = hw >= 2 ? 2 : 1;
    auto count_worker = [&](int t) {
      const uint64_t bit = space >> 1;
      for (Py_ssize_t i = 0; i < M; ++i) {
        const uint64_t v = (uint64_t)kmers[i];
        if (nt == 2 && ((v & bit) != 0) != (t == 1)) continue;
        uint8_t& c = table[v];
        if (c < 255) ++c;
      }
    };
    std::vector<std::thread> threads;
    for (int t = 1; t < nt; ++t) threads.emplace_back(count_worker, t);
    count_worker(0);
    for (auto& th : threads) th.join();
    // pass 2: gather (split the stream between threads)
    auto gather_worker = [&](Py_ssize_t lo, Py_ssize_t hi) {
      for (Py_ssize_t i = lo; i < hi; ++i) {
        freq[i] = table[(uint64_t)kmers[i]];
      }
    };
    std::thread t2(gather_worker, M / 2, M);
    gather_worker(0, M / 2);
    t2.join();
  }
  Py_END_ALLOW_THREADS;
  PyObject* out = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(freq.data()), freq.size());
  PyBuffer_Release(&km_b);
  return out;
}

// ---------------------------------------------------------------------
// count_kmer_freqs_radix: per-position global k-mer frequencies via a
// threaded LSD radix sort over the USED key bits (2k -> ceil(2k/16)
// 16-bit passes).  Exact counts (no saturation), linear time, ~28
// bytes/key of workspace — beats the full argsort (4 s for 10 M keys
// on this host; superlinear growth took 40 min at 1.46 G keys) at
// every size, and beats the flat 4^k table (count_kmer_freqs) below
// ~500 M keys where the 8 GB table's first touch dominates.  The
// Python caller routes by stream size.
//
// kmers int64[M] canonical; k.  Returns freq int32[M] (counts cap at
// INT32_MAX trivially).
// ---------------------------------------------------------------------
static PyObject* count_kmer_freqs_radix(PyObject*, PyObject* args) {
  Py_buffer km_b;
  int k;
  if (!PyArg_ParseTuple(args, "y*i", &km_b, &k)) return nullptr;
  const int64_t* kmers = static_cast<const int64_t*>(km_b.buf);
  const Py_ssize_t M = km_b.len / 8;
  if (M >= (Py_ssize_t)UINT32_MAX) {
    PyBuffer_Release(&km_b);
    PyErr_SetString(PyExc_ValueError,
                    "radix counter caps at 2^32-1 keys");
    return nullptr;
  }
  const int passes = (2 * k + 15) / 16;
  std::vector<int32_t> freq((size_t)M);
  Py_BEGIN_ALLOW_THREADS;
  {
    std::vector<uint64_t> a((size_t)M), b((size_t)M);
    std::vector<uint32_t> ia((size_t)M), ib((size_t)M);
    unsigned hw = std::thread::hardware_concurrency();
    const int T = hw >= 2 ? 2 : 1;
    const Py_ssize_t chunk = (M + T - 1) / T;
    {
      auto init_worker = [&](int t) {
        const Py_ssize_t lo = t * chunk, hi = std::min(M, lo + chunk);
        for (Py_ssize_t i = lo; i < hi; ++i) {
          a[i] = (uint64_t)kmers[i];
          ia[i] = (uint32_t)i;
        }
      };
      std::vector<std::thread> ths;
      for (int t = 1; t < T; ++t) ths.emplace_back(init_worker, t);
      init_worker(0);
      for (auto& th : ths) th.join();
    }
    std::vector<size_t> hist((size_t)T * 65536);
    for (int p = 0; p < passes; ++p) {
      const int shift = 16 * p;
      std::fill(hist.begin(), hist.end(), 0);
      auto hist_worker = [&](int t) {
        size_t* h = &hist[(size_t)t * 65536];
        const Py_ssize_t lo = t * chunk, hi = std::min(M, lo + chunk);
        for (Py_ssize_t i = lo; i < hi; ++i) {
          ++h[(a[i] >> shift) & 0xffff];
        }
      };
      {
        std::vector<std::thread> ths;
        for (int t = 1; t < T; ++t) ths.emplace_back(hist_worker, t);
        hist_worker(0);
        for (auto& th : ths) th.join();
      }
      // stable bases: digit-major, then thread (chunk) order
      size_t run = 0;
      for (int d = 0; d < 65536; ++d) {
        for (int t = 0; t < T; ++t) {
          size_t& h = hist[(size_t)t * 65536 + d];
          size_t c = h;
          h = run;
          run += c;
        }
      }
      auto scatter_worker = [&](int t) {
        size_t* base = &hist[(size_t)t * 65536];
        const Py_ssize_t lo = t * chunk, hi = std::min(M, lo + chunk);
        for (Py_ssize_t i = lo; i < hi; ++i) {
          const size_t pos = base[(a[i] >> shift) & 0xffff]++;
          b[pos] = a[i];
          ib[pos] = ia[i];
        }
      };
      {
        std::vector<std::thread> ths;
        for (int t = 1; t < T; ++t) ths.emplace_back(scatter_worker, t);
        scatter_worker(0);
        for (auto& th : ths) th.join();
      }
      a.swap(b);
      ia.swap(ib);
    }
    // group counts scattered back to stream order; the two threads
    // split at a group boundary so each group is scanned whole
    Py_ssize_t split = M / 2;
    while (T == 2 && split > 0 && split < M && a[split] == a[split - 1])
      ++split;
    auto group_worker = [&](Py_ssize_t lo, Py_ssize_t hi) {
      Py_ssize_t s = lo;
      while (s < hi) {
        Py_ssize_t e = s + 1;
        while (e < hi && a[e] == a[s]) ++e;
        const int32_t c = (int32_t)std::min<Py_ssize_t>(
            e - s, std::numeric_limits<int32_t>::max());
        for (Py_ssize_t i = s; i < e; ++i) freq[ia[i]] = c;
        s = e;
      }
    };
    if (T == 2 && split < M) {
      std::thread th(group_worker, split, M);
      group_worker(0, split);
      th.join();
    } else {
      group_worker(0, M);
    }
  }
  Py_END_ALLOW_THREADS;
  PyObject* out = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(freq.data()), freq.size() * 4);
  PyBuffer_Release(&km_b);
  return out;
}

// ---------------------------------------------------------------------
// radix_sort_pairs: threaded stable LSD radix sort of (a, b) pairs by
// key (a, b) — the postings sort of the index build (numpy lexsort is
// a comparison sort; at 50 M selected postings it costs ~10x this).
// a int64[n] (abits used bits, e.g. 2k for canonical k-mers);
// b int64[n] (full 64).  Returns (sorted_a bytes, sorted_b bytes).
// ---------------------------------------------------------------------
static PyObject* radix_sort_pairs(PyObject*, PyObject* args) {
  Py_buffer a_b, b_b;
  int abits;
  if (!PyArg_ParseTuple(args, "y*y*i", &a_b, &b_b, &abits)) {
    return nullptr;
  }
  const int64_t* a_in = static_cast<const int64_t*>(a_b.buf);
  const int64_t* b_in = static_cast<const int64_t*>(b_b.buf);
  const Py_ssize_t M = a_b.len / 8;
  const int a_passes = (abits + 15) / 16;
  std::vector<uint64_t> a0((size_t)M), a1((size_t)M), c0((size_t)M),
      c1((size_t)M);
  Py_BEGIN_ALLOW_THREADS;
  {
    unsigned hw = std::thread::hardware_concurrency();
    const int T = hw >= 2 ? 2 : 1;
    const Py_ssize_t chunk = (M + T - 1) / T;
    {
      auto init_worker = [&](int t) {
        const Py_ssize_t lo = t * chunk, hi = std::min(M, lo + chunk);
        for (Py_ssize_t i = lo; i < hi; ++i) {
          a0[i] = (uint64_t)a_in[i];
          c0[i] = (uint64_t)b_in[i];
        }
      };
      std::vector<std::thread> ths;
      for (int t = 1; t < T; ++t) ths.emplace_back(init_worker, t);
      init_worker(0);
      for (auto& th : ths) th.join();
    }
    std::vector<size_t> hist((size_t)T * 65536);
    auto one_pass = [&](bool key_is_a, int shift) {
      const std::vector<uint64_t>& key = key_is_a ? a0 : c0;
      std::fill(hist.begin(), hist.end(), 0);
      auto hist_worker = [&](int t) {
        size_t* h = &hist[(size_t)t * 65536];
        const Py_ssize_t lo = t * chunk, hi = std::min(M, lo + chunk);
        for (Py_ssize_t i = lo; i < hi; ++i) {
          ++h[(key[i] >> shift) & 0xffff];
        }
      };
      {
        std::vector<std::thread> ths;
        for (int t = 1; t < T; ++t) ths.emplace_back(hist_worker, t);
        hist_worker(0);
        for (auto& th : ths) th.join();
      }
      size_t run = 0;
      for (int d = 0; d < 65536; ++d) {
        for (int t = 0; t < T; ++t) {
          size_t& h = hist[(size_t)t * 65536 + d];
          size_t c = h;
          h = run;
          run += c;
        }
      }
      auto scatter_worker = [&](int t) {
        size_t* base = &hist[(size_t)t * 65536];
        const Py_ssize_t lo = t * chunk, hi = std::min(M, lo + chunk);
        for (Py_ssize_t i = lo; i < hi; ++i) {
          const size_t p = base[(key[i] >> shift) & 0xffff]++;
          a1[p] = a0[i];
          c1[p] = c0[i];
        }
      };
      {
        std::vector<std::thread> ths;
        for (int t = 1; t < T; ++t) ths.emplace_back(scatter_worker, t);
        scatter_worker(0);
        for (auto& th : ths) th.join();
      }
      a0.swap(a1);
      c0.swap(c1);
    };
    for (int p = 0; p < 4; ++p) one_pass(false, 16 * p);
    for (int p = 0; p < a_passes; ++p) one_pass(true, 16 * p);
  }
  Py_END_ALLOW_THREADS;
  PyObject* r = PyTuple_New(2);
  PyTuple_SET_ITEM(r, 0, PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(a0.data()), (size_t)M * 8));
  PyTuple_SET_ITEM(r, 1, PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(c0.data()), (size_t)M * 8));
  PyBuffer_Release(&a_b);
  PyBuffer_Release(&b_b);
  return r;
}

// ---------------------------------------------------------------------
// select_solid_kmers: the per-read frequency-threshold selection of the
// solid index build (the Python loop over reads dominated the host
// side of the build at bench scale).  Per read [starts[r], starts[r+1]):
// nearest-rank p90 of the read's global frequencies, threshold
// max(global_min, min(4, int(select_rate * p90))), plus the tandem
// filter dropping k-mers that occur more than tandem_freq times WITHIN
// the read (reference: vertex_index.cpp:316-358 yieldFrequentKmers).
//
// kmers int64[M]; freq int32[M]; starts int64[R+1]; select_rate
// double; tandem_freq int; global_min int.  Returns mask uint8[M].
// ---------------------------------------------------------------------
static PyObject* select_solid_kmers(PyObject*, PyObject* args) {
  Py_buffer km_b, fr_b, st_b;
  double select_rate;
  int tandem_freq, global_min;
  if (!PyArg_ParseTuple(args, "y*y*y*dii", &km_b, &fr_b, &st_b,
                        &select_rate, &tandem_freq, &global_min)) {
    return nullptr;
  }
  const int64_t* kmers = static_cast<const int64_t*>(km_b.buf);
  const int32_t* freq = static_cast<const int32_t*>(fr_b.buf);
  const int64_t* starts = static_cast<const int64_t*>(st_b.buf);
  const Py_ssize_t M = km_b.len / 8;
  const Py_ssize_t R = st_b.len / 8 - 1;
  std::vector<uint8_t> mask((size_t)M, 0);
  Py_BEGIN_ALLOW_THREADS;
  {
    std::atomic<Py_ssize_t> next{0};
    auto worker = [&]() {
      std::vector<int32_t> fbuf;
      std::vector<std::pair<int64_t, int64_t>> kbuf;
      for (;;) {
        const Py_ssize_t r = next.fetch_add(1);
        if (r >= R) return;
        const int64_t s = starts[r], e = starts[r + 1];
        const int64_t n = e - s;
        if (n <= 0) continue;
        fbuf.assign(freq + s, freq + e);
        const int64_t p90i =
            std::min<int64_t>(n - 1, (int64_t)(0.9 * n));
        std::nth_element(fbuf.begin(), fbuf.begin() + p90i, fbuf.end());
        const double p90 = (double)fbuf[p90i];
        const int64_t thr = std::max<int64_t>(
            global_min,
            std::min<int64_t>(4, (int64_t)(select_rate * p90)));
        for (int64_t i = s; i < e; ++i) mask[i] = freq[i] >= thr;
        if (tandem_freq > 0) {
          kbuf.resize(n);
          for (int64_t i = 0; i < n; ++i)
            kbuf[i] = {kmers[s + i], s + i};
          std::sort(kbuf.begin(), kbuf.end());
          int64_t i = 0;
          while (i < n) {
            int64_t j = i + 1;
            while (j < n && kbuf[j].first == kbuf[i].first) ++j;
            if (j - i > tandem_freq) {
              for (int64_t q = i; q < j; ++q) mask[kbuf[q].second] = 0;
            }
            i = j;
          }
        }
      }
    };
    unsigned hw = std::thread::hardware_concurrency();
    const int T = hw >= 2 ? 2 : 1;
    std::vector<std::thread> ths;
    for (int t = 1; t < T; ++t) ths.emplace_back(worker);
    worker();
    for (auto& th : ths) th.join();
  }
  Py_END_ALLOW_THREADS;
  PyObject* out = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(mask.data()), mask.size());
  PyBuffer_Release(&km_b);
  PyBuffer_Release(&fr_b);
  PyBuffer_Release(&st_b);
  return out;
}

// ---------------------------------------------------------------------
// polish_hopo_host: batched homopolymer + dinucleotide re-estimation —
// the threaded native twin of polishing/homopolisher.py
// (polish_homopolymers + fix_dinucleotide_repeats applied in that
// order per bubble; reference: src/polishing/homo_polisher.cpp +
// dinucleotide_fixer.cpp).  The per-bubble Python loops cost ~160 s of
// the 4.6 Mb E2E; this runs the same decisions (double-precision
// likelihood sums in the same association order — bit-identical) in
// C++ threads.
//
// cand u8 flat + cand_off int64[B+1]; branches u8 flat + br_off
// int64[NB+1]; bb_off int64[B+1] (bubble -> branch index range);
// obs_logp f64[4*21*33]; genome_logp f64[4*21]; min_run; min_units.
// Returns (out_flat bytes, out_off int64[B+1] bytes).
// ---------------------------------------------------------------------
static const int kHopoMaxState = 20;
static const int kHopoMaxObs = 32;

static int hopo_branch_run_at(const unsigned char* br, int64_t n,
                              int nucl, int64_t center, int64_t window,
                              bool* found) {
  const int64_t lo = std::max<int64_t>(0, center - window);
  const int64_t hi = std::min<int64_t>(n, center + window);
  *found = hi > lo;
  if (!*found) return 0;
  int best = -1;
  int64_t best_d = 0;
  int64_t i = lo;
  while (i < hi) {
    if (br[i] == nucl) {
      int64_t s = i;
      while (s > 0 && br[s - 1] == nucl) --s;
      int64_t j = i;
      while (j < n && br[j] == nucl) ++j;
      const int64_t d = std::llabs((s + j) / 2 - center);
      if (best < 0 || d < best_d) {
        best = (int)(j - s);
        best_d = d;
      }
      i = j;
    } else {
      ++i;
    }
  }
  return best < 0 ? 0 : best;
}

static void hopo_one(const unsigned char* cand, int64_t clen,
                     const unsigned char* br_flat, const int64_t* br_off,
                     int64_t b0, int64_t b1, const double* obs_logp,
                     const double* genome_logp, int min_run,
                     int min_units, int min_obs, double margin,
                     std::vector<unsigned char>& out) {
  out.clear();
  const int64_t nb = b1 - b0;
  if (nb == 0 || clen == 0) {
    out.assign(cand, cand + clen);
  } else {
    // ---- homopolymer ML re-estimation ----
    std::vector<double> scale(nb);
    for (int64_t j = 0; j < nb; ++j) {
      scale[j] = (double)(br_off[b0 + j + 1] - br_off[b0 + j]) /
                 (double)std::max<int64_t>(1, clen);
    }
    int64_t start = 0;
    std::vector<int> obs;
    for (int64_t i = 1; i <= clen; ++i) {
      if (i != clen && cand[i] == cand[start]) continue;
      const int64_t length = i - start;
      const int nucl = cand[start];
      if (length < min_run || length > kHopoMaxState - 1) {
        out.insert(out.end(), cand + start, cand + i);
      } else {
        const int64_t center = start + length / 2;
        obs.clear();
        for (int64_t j = 0; j < nb; ++j) {
          const int64_t blen = br_off[b0 + j + 1] - br_off[b0 + j];
          bool found;
          const int r = hopo_branch_run_at(
              br_flat + br_off[b0 + j], blen, nucl,
              (int64_t)((double)center * scale[j]), length + 4,
              &found);
          if (found) obs.push_back(std::min(r, kHopoMaxObs));
        }
        int64_t best_len = length;
        if ((int64_t)obs.size() >= min_obs) {
          double best_ll = -std::numeric_limits<double>::infinity();
          double cur_ll = -std::numeric_limits<double>::infinity();
          const int64_t lo_l = std::max<int64_t>(1, length - 1);
          const int64_t hi_l =
              std::min<int64_t>(kHopoMaxState, length + 2);
          for (int64_t L = lo_l; L < hi_l; ++L) {
            // same association order as the Python source (genome +
            // sum(obs)) for bit-identical likelihoods
            double s = 0.0;
            for (int o : obs) {
              s += obs_logp[(nucl * (kHopoMaxState + 1) + L) *
                                (kHopoMaxObs + 1) +
                            o];
            }
            const double ll =
                genome_logp[nucl * (kHopoMaxState + 1) + L] + s;
            if (L == length) cur_ll = ll;
            if (ll > best_ll) {
              best_ll = ll;
              best_len = L;
            }
          }
          // evidence gate (mirrors polish_homopolymers min_obs/margin)
          if (best_len != length && best_ll - cur_ll <= margin) {
            best_len = length;
          }
        }
        out.insert(out.end(), (size_t)best_len, (unsigned char)nucl);
      }
      start = i;
    }
  }

  // ---- dinucleotide repeat vote (on the hopo output) ----
  const int64_t n = (int64_t)out.size();
  if (nb == 0 || n < 2 * min_units) return;
  std::vector<unsigned char> fixed;
  fixed.reserve(out.size() + 16);
  std::vector<double> scale2(nb);
  for (int64_t j = 0; j < nb; ++j) {
    scale2[j] = (double)(br_off[b0 + j + 1] - br_off[b0 + j]) /
                (double)std::max<int64_t>(1, n);
  }
  std::vector<int> votes;
  int64_t i = 0;
  while (i < n - 1) {
    const int a = out[i], b = out[i + 1];
    if (a == b) {
      fixed.push_back(out[i]);
      ++i;
      continue;
    }
    int64_t units = 0, j = i;
    while (j + 1 < n && out[j] == a && out[j + 1] == b) {
      ++units;
      j += 2;
    }
    if (units < min_units) {
      fixed.push_back(out[i]);
      ++i;
      continue;
    }
    votes.clear();
    for (int64_t q = 0; q < nb; ++q) {
      const int64_t blen = br_off[b0 + q + 1] - br_off[b0 + q];
      const unsigned char* br = br_flat + br_off[b0 + q];
      const int64_t c = (int64_t)((double)i * scale2[q]);
      const int64_t lo = std::max<int64_t>(0, c - 2 * units - 6);
      const int64_t hi = std::min<int64_t>(blen, c + 4 * units + 6);
      int best = 0, cur = 0;
      int64_t p = lo;
      while (p + 1 < hi) {
        if (br[p] == a && br[p + 1] == b) {
          ++cur;
          best = std::max(best, cur);
          p += 2;
        } else {
          cur = 0;
          ++p;
        }
      }
      votes.push_back(best);
    }
    if ((int64_t)votes.size() >= 2) {
      // winner = smallest vote value with the max count (np.unique is
      // sorted; argmax takes the first maximum)
      std::vector<int> sorted(votes);
      std::sort(sorted.begin(), sorted.end());
      int winner = sorted[0], wcount = 0, maxc = 0;
      size_t t = 0;
      while (t < sorted.size()) {
        size_t u = t + 1;
        while (u < sorted.size() && sorted[u] == sorted[t]) ++u;
        if ((int)(u - t) > maxc) {
          maxc = (int)(u - t);
          winner = sorted[t];
        }
        t = u;
      }
      wcount = maxc;
      if (winner > 0 && winner != units &&
          wcount > (int64_t)votes.size() / 2) {
        units = winner;
      }
    }
    for (int64_t u = 0; u < units; ++u) {
      fixed.push_back((unsigned char)a);
      fixed.push_back((unsigned char)b);
    }
    i = j;
  }
  if (i < n) fixed.insert(fixed.end(), out.begin() + i, out.end());
  out.swap(fixed);
}

static PyObject* polish_hopo_host(PyObject*, PyObject* args) {
  Py_buffer cand_b, coff_b, br_b, broff_b, bboff_b, obs_b, gen_b;
  int min_run, min_units;
  int min_obs = 2;
  double margin = 0.0;
  if (!PyArg_ParseTuple(args, "y*y*y*y*y*y*y*ii|id", &cand_b, &coff_b,
                        &br_b, &broff_b, &bboff_b, &obs_b, &gen_b,
                        &min_run, &min_units, &min_obs, &margin)) {
    return nullptr;
  }
  const unsigned char* cand = static_cast<const unsigned char*>(cand_b.buf);
  const int64_t* coff = static_cast<const int64_t*>(coff_b.buf);
  const unsigned char* brf = static_cast<const unsigned char*>(br_b.buf);
  const int64_t* broff = static_cast<const int64_t*>(broff_b.buf);
  const int64_t* bboff = static_cast<const int64_t*>(bboff_b.buf);
  const double* obs_logp = static_cast<const double*>(obs_b.buf);
  const double* genome_logp = static_cast<const double*>(gen_b.buf);
  const Py_ssize_t B = coff_b.len / 8 - 1;
  std::vector<std::vector<unsigned char>> outs((size_t)B);
  Py_BEGIN_ALLOW_THREADS;
  {
    std::atomic<Py_ssize_t> next{0};
    auto worker = [&]() {
      for (;;) {
        const Py_ssize_t b = next.fetch_add(1);
        if (b >= B) return;
        hopo_one(cand + coff[b], coff[b + 1] - coff[b], brf, broff,
                 bboff[b], bboff[b + 1], obs_logp, genome_logp,
                 min_run, min_units, min_obs, margin,
                 outs[(size_t)b]);
      }
    };
    unsigned hw = std::thread::hardware_concurrency();
    const int T = hw >= 2 ? 2 : 1;
    std::vector<std::thread> ths;
    for (int t = 1; t < T; ++t) ths.emplace_back(worker);
    worker();
    for (auto& th : ths) th.join();
  }
  Py_END_ALLOW_THREADS;
  std::vector<int64_t> ooff((size_t)B + 1, 0);
  for (Py_ssize_t b = 0; b < B; ++b) {
    ooff[(size_t)b + 1] = ooff[(size_t)b] + (int64_t)outs[(size_t)b].size();
  }
  std::vector<unsigned char> flat((size_t)ooff[(size_t)B]);
  for (Py_ssize_t b = 0; b < B; ++b) {
    std::copy(outs[(size_t)b].begin(), outs[(size_t)b].end(),
              flat.begin() + ooff[(size_t)b]);
  }
  PyObject* r = PyTuple_New(2);
  PyTuple_SET_ITEM(r, 0, PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(flat.data()), flat.size()));
  PyTuple_SET_ITEM(r, 1, PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(ooff.data()), ooff.size() * 8));
  PyBuffer_Release(&cand_b);
  PyBuffer_Release(&coff_b);
  PyBuffer_Release(&br_b);
  PyBuffer_Release(&broff_b);
  PyBuffer_Release(&bboff_b);
  PyBuffer_Release(&obs_b);
  PyBuffer_Release(&gen_b);
  return r;
}

// ---------------------------------------------------------------------
// refine_points: snap extrapolated read coordinates onto the exact
// occurrence of each boundary marker nearest the estimate (batched
// twin of polishing/windows.py _refine; that Python/numpy version at
// ~40 us/call dominated bubble extraction at the fine partition —
// ~1.3M calls per 420 kb contig).
//
// read uint8[N]; markers uint8[P, m]; mlen int32[P] (valid marker
// bytes; < m -> keep the estimate); centers int64[P]; dists int64[P].
// Returns int64[P] refined positions.
// ---------------------------------------------------------------------
static PyObject* refine_points(PyObject*, PyObject* args) {
  Py_buffer read_b, mark_b, mlen_b, cent_b, dist_b;
  Py_ssize_t P;
  int m;
  if (!PyArg_ParseTuple(args, "y*y*y*y*y*ni", &read_b, &mark_b, &mlen_b,
                        &cent_b, &dist_b, &P, &m)) {
    return nullptr;
  }
  const unsigned char* read = static_cast<const unsigned char*>(read_b.buf);
  const int64_t N = read_b.len;
  const unsigned char* markers = static_cast<const unsigned char*>(mark_b.buf);
  const int32_t* mlens = static_cast<const int32_t*>(mlen_b.buf);
  const int64_t* centers = static_cast<const int64_t*>(cent_b.buf);
  const int64_t* dists = static_cast<const int64_t*>(dist_b.buf);
  std::vector<int64_t> out(P);
  for (Py_ssize_t p = 0; p < P; ++p) {
    const int64_t center = centers[p];
    out[p] = center;
    if (dists[p] == 0 || mlens[p] < m) continue;
    const int64_t radius =
        std::min<int64_t>(48, 4 + (dists[p] * 2) / 10);
    const int64_t lo = std::max<int64_t>(0, center - radius);
    const int64_t hi = std::min<int64_t>(N - m, center + radius);
    if (hi < lo) continue;
    const unsigned char* mk = markers + (size_t)p * m;
    int64_t best = -1, best_d = 0;
    for (int64_t q = lo; q <= hi; ++q) {
      if (std::memcmp(read + q, mk, m) != 0) continue;
      const int64_t d = std::abs(q - center);
      if (best < 0 || d < best_d) {
        best = q;
        best_d = d;
      }
    }
    if (best >= 0) out[p] = best;
  }
  PyObject* r = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(out.data()), out.size() * 8);
  for (Py_buffer* pb : {&read_b, &mark_b, &mlen_b, &cent_b, &dist_b}) {
    PyBuffer_Release(pb);
  }
  return r;
}

// ---------------------------------------------------------------------
// extract_kmers: rolling canonical k-mer extraction over a concatenated
// read stream, sampling every `sample`-th position per read (the w=1
// path of the device kernel ops/kmers.py stream_select_packed; the
// reference analog is IterKmers, kmer.h:131-204).  Same rationale as
// probe_stream: on this deployment the device pass is dominated by
// per-call latency and the packed full-stream fetch.
//
// codes uint8[N]; starts int64[nq+1]; k; sample.
// Returns (kmers int64[M], rid int32[M], pos int32[M], flip uint8[M])
// in ascending stream order (flip = canonical form is the rc strand).
// ---------------------------------------------------------------------
static PyObject* extract_kmers(PyObject*, PyObject* args) {
  Py_buffer codes_b, st_b;
  Py_ssize_t nq;
  int k, sample;
  if (!PyArg_ParseTuple(args, "y*y*nii", &codes_b, &st_b, &nq, &k,
                        &sample)) {
    return nullptr;
  }
  const unsigned char* codes = static_cast<const unsigned char*>(codes_b.buf);
  const int64_t* starts = static_cast<const int64_t*>(st_b.buf);

  struct Part {
    std::vector<int64_t> kmers;
    std::vector<int32_t> rid, pos;
    std::vector<unsigned char> flip;
  };
  unsigned hw = std::thread::hardware_concurrency();
  int nt_threads = hw ? (int)hw : 2;
  if (nt_threads > nq) nt_threads = (int)(nq ? nq : 1);
  if (nt_threads < 1) nt_threads = 1;
  std::vector<Part> parts(nt_threads);
  const int64_t n_total = starts[nq];
  std::vector<Py_ssize_t> cut(nt_threads + 1, 0);
  for (int t = 1; t < nt_threads; ++t) {
    const int64_t target = n_total * t / nt_threads;
    cut[t] = std::lower_bound(starts, starts + nq + 1, target) - starts;
  }
  cut[nt_threads] = nq;

  const uint64_t mask = (k >= 32) ? ~0ull : ((1ull << (2 * k)) - 1);
  auto worker = [&](int t) {
    Part& out = parts[t];
    for (Py_ssize_t q = cut[t]; q < cut[t + 1]; ++q) {
      const int64_t s0 = starts[q], s1 = starts[q + 1];
      const int64_t len = s1 - s0;
      if (len < k) continue;
      uint64_t fwd = 0, rc = 0;
      for (int j = 0; j < k - 1; ++j) {
        const uint64_t c = codes[s0 + j];
        fwd = (fwd << 2) | c;
        rc = (rc >> 2) | ((3 - c) << (2 * (k - 1)));
      }
      for (int64_t p = k - 1; p < len; ++p) {
        const uint64_t c = codes[s0 + p];
        fwd = ((fwd << 2) | c) & mask;
        rc = (rc >> 2) | ((3 - c) << (2 * (k - 1)));
        const int64_t kpos = p - (k - 1);
        if (sample > 1 && kpos % sample != 0) continue;
        const bool is_fwd = fwd <= rc;
        out.kmers.push_back((int64_t)(is_fwd ? fwd : rc));
        out.rid.push_back((int32_t)q);
        out.pos.push_back((int32_t)kpos);
        out.flip.push_back(is_fwd ? 0 : 1);
      }
    }
  };
  Py_BEGIN_ALLOW_THREADS;
  std::vector<std::thread> threads;
  for (int t = 1; t < nt_threads; ++t) threads.emplace_back(worker, t);
  worker(0);
  for (auto& th : threads) th.join();
  Py_END_ALLOW_THREADS;

  size_t M = 0;
  for (auto& p : parts) M += p.kmers.size();
  std::vector<int64_t> kmers;
  std::vector<int32_t> rid, pos;
  std::vector<unsigned char> flip;
  kmers.reserve(M);
  rid.reserve(M);
  pos.reserve(M);
  flip.reserve(M);
  for (auto& p : parts) {
    kmers.insert(kmers.end(), p.kmers.begin(), p.kmers.end());
    rid.insert(rid.end(), p.rid.begin(), p.rid.end());
    pos.insert(pos.end(), p.pos.begin(), p.pos.end());
    flip.insert(flip.end(), p.flip.begin(), p.flip.end());
  }
  auto as_bytes = [](const void* p, size_t nbytes) {
    return PyBytes_FromStringAndSize(static_cast<const char*>(p),
                                     (Py_ssize_t)nbytes);
  };
  PyObject* r = Py_BuildValue(
      "NNNN", as_bytes(kmers.data(), kmers.size() * 8),
      as_bytes(rid.data(), rid.size() * 4),
      as_bytes(pos.data(), pos.size() * 4),
      as_bytes(flip.data(), flip.size()));
  PyBuffer_Release(&codes_b);
  PyBuffer_Release(&st_b);
  return r;
}

// ---------------------------------------------------------------------
// probe_stream: rolling canonical k-mer extraction + sorted-table
// lookup over a concatenated read stream (behavioral twin of the
// device kernel ops/kmers.py stream_probe_packed; the reference's
// analog is IterKmers + VertexIndex::iterKmerPos,
// reference: overlap.cpp:176-196, kmer.h:131-204).
//
// On this deployment the device kernel is GATHER-bound (binary search
// over the uniq table costs ~20 serialized gathers per position) and
// its packed output is a 4-bytes-per-base fetch through a ~30 MB/s
// link; the host does the same probe cache-resident with a 16-bit
// prefix LUT and emits only the hits.  The sharded (mesh) index keeps
// the device path — its table lives device-side per shard.
//
// codes uint8[N]; starts int64[nq+1]; uniq int64[nk] sorted;
// repet uint8[nk]; lut int64[nlut+1] (prefix -> uniq range, prefix =
// kmer >> lut_shift); k.
// Returns (g_hit int64[H], row_hit int64[H], fwd_hit uint8[H],
//          g_rep int64[F]) in ascending stream order.
// ---------------------------------------------------------------------
static PyObject* probe_stream(PyObject*, PyObject* args) {
  Py_buffer codes_b, st_b, uniq_b, rep_b, lut_b;
  Py_ssize_t nq;
  int k, lut_shift;
  if (!PyArg_ParseTuple(args, "y*y*ny*y*y*ii", &codes_b, &st_b, &nq,
                        &uniq_b, &rep_b, &lut_b, &k, &lut_shift)) {
    return nullptr;
  }
  const unsigned char* codes = static_cast<const unsigned char*>(codes_b.buf);
  const int64_t* starts = static_cast<const int64_t*>(st_b.buf);
  const int64_t* uniq = static_cast<const int64_t*>(uniq_b.buf);
  const unsigned char* repet = static_cast<const unsigned char*>(rep_b.buf);
  const int64_t* lut = static_cast<const int64_t*>(lut_b.buf);

  struct Part {
    std::vector<int64_t> g_hit, row_hit, g_rep;
    std::vector<unsigned char> fwd_hit;
  };
  unsigned hw = std::thread::hardware_concurrency();
  int nt_threads = hw ? (int)hw : 2;
  if (nt_threads > nq) nt_threads = (int)(nq ? nq : 1);
  if (nt_threads < 1) nt_threads = 1;
  std::vector<Part> parts(nt_threads);
  // balance threads by stream bases, split at read boundaries
  const int64_t n_total = starts[nq];
  std::vector<Py_ssize_t> cut(nt_threads + 1, 0);
  for (int t = 1; t < nt_threads; ++t) {
    const int64_t target = n_total * t / nt_threads;
    cut[t] = std::lower_bound(starts, starts + nq + 1, target) - starts;
  }
  cut[nt_threads] = nq;

  const uint64_t mask = (k >= 32) ? ~0ull : ((1ull << (2 * k)) - 1);
  auto worker = [&](int t) {
    Part& out = parts[t];
    for (Py_ssize_t q = cut[t]; q < cut[t + 1]; ++q) {
      const int64_t s0 = starts[q], s1 = starts[q + 1];
      const int64_t len = s1 - s0;
      if (len < k) continue;
      uint64_t fwd = 0, rc = 0;
      for (int j = 0; j < k - 1; ++j) {
        const uint64_t c = codes[s0 + j];
        fwd = (fwd << 2) | c;
        rc = (rc >> 2) | ((3 - c) << (2 * (k - 1)));
      }
      for (int64_t p = k - 1; p < len; ++p) {
        const uint64_t c = codes[s0 + p];
        fwd = ((fwd << 2) | c) & mask;
        rc = (rc >> 2) | ((3 - c) << (2 * (k - 1)));
        const uint64_t canon = fwd <= rc ? fwd : rc;
        const int64_t b = (int64_t)(canon >> lut_shift);
        const int64_t lo = lut[b], hi = lut[b + 1];
        const int64_t* it = std::lower_bound(
            uniq + lo, uniq + hi, (int64_t)canon);
        if (it == uniq + hi || *it != (int64_t)canon) continue;
        const int64_t row = it - uniq;
        const int64_t g = s0 + p - (k - 1);
        if (repet[row]) {
          out.g_rep.push_back(g);
        } else {
          out.g_hit.push_back(g);
          out.row_hit.push_back(row);
          out.fwd_hit.push_back(fwd <= rc ? 1 : 0);
        }
      }
    }
  };
  Py_BEGIN_ALLOW_THREADS;
  std::vector<std::thread> threads;
  for (int t = 1; t < nt_threads; ++t) threads.emplace_back(worker, t);
  worker(0);
  for (auto& th : threads) th.join();
  Py_END_ALLOW_THREADS;

  size_t H = 0, F = 0;
  for (auto& p : parts) {
    H += p.g_hit.size();
    F += p.g_rep.size();
  }
  std::vector<int64_t> g_hit, row_hit, g_rep;
  std::vector<unsigned char> fwd_hit;
  g_hit.reserve(H);
  row_hit.reserve(H);
  fwd_hit.reserve(H);
  g_rep.reserve(F);
  for (auto& p : parts) {
    g_hit.insert(g_hit.end(), p.g_hit.begin(), p.g_hit.end());
    row_hit.insert(row_hit.end(), p.row_hit.begin(), p.row_hit.end());
    fwd_hit.insert(fwd_hit.end(), p.fwd_hit.begin(), p.fwd_hit.end());
    g_rep.insert(g_rep.end(), p.g_rep.begin(), p.g_rep.end());
  }
  auto as_bytes = [](const void* p, size_t nbytes) {
    return PyBytes_FromStringAndSize(static_cast<const char*>(p),
                                     (Py_ssize_t)nbytes);
  };
  PyObject* r = Py_BuildValue(
      "NNNN", as_bytes(g_hit.data(), g_hit.size() * 8),
      as_bytes(row_hit.data(), row_hit.size() * 8),
      as_bytes(fwd_hit.data(), fwd_hit.size()),
      as_bytes(g_rep.data(), g_rep.size() * 8));
  for (Py_buffer* pb : {&codes_b, &st_b, &uniq_b, &rep_b, &lut_b}) {
    PyBuffer_Release(pb);
  }
  return r;
}

// ---------------------------------------------------------------------
// collect_matches: posting-list expansion for a batch of probed reads
// (behavioral port of the match-collection loop,
// reference: overlap.cpp:176-196, and the numpy gather block in
// overlap/engine.py _collect_matches_batch which it replaces on the
// fast path — the fancy-indexed expansion over millions of postings
// was the gather phase's host cost).
//
// Inputs: g_hit int64[H] ascending stream positions with index hits,
// row_hit int64[H] index rows, fwd_hit uint8[H] (query kmer forward?),
// counts int32[nk], offsets int64[nk+1] posting ranges,
// post_seq int32[P], post_pos int32[P], post_flip uint8[P],
// tlens int64[nt] target lengths, starts int64[nq+1] per-read stream
// offsets, sids int64[nq] strand ids, k, symmetric.
// Returns (qpos int32[M], ext_id int64[M], ext_pos int32[M],
//          qbounds int64[nq+1]) in the exact order the numpy path
// produced (hits in stream order, postings in index order).
// ---------------------------------------------------------------------
static PyObject* collect_matches(PyObject*, PyObject* args) {
  Py_buffer gh_b, rh_b, fh_b, cnt_b, off_b, ps_b, pp_b, pf_b, tl_b,
      st_b, sid_b;
  Py_ssize_t H, nq;
  int k, symmetric;
  if (!PyArg_ParseTuple(args, "y*y*y*y*y*y*y*y*y*y*y*nnii", &gh_b, &rh_b,
                        &fh_b, &cnt_b, &off_b, &ps_b, &pp_b, &pf_b, &tl_b,
                        &st_b, &sid_b, &H, &nq, &k, &symmetric)) {
    return nullptr;
  }
  const int64_t* g_hit = static_cast<const int64_t*>(gh_b.buf);
  const int64_t* row_hit = static_cast<const int64_t*>(rh_b.buf);
  const unsigned char* fwd_hit = static_cast<const unsigned char*>(fh_b.buf);
  const int32_t* counts = static_cast<const int32_t*>(cnt_b.buf);
  const int64_t* offsets = static_cast<const int64_t*>(off_b.buf);
  const int32_t* post_seq = static_cast<const int32_t*>(ps_b.buf);
  const int32_t* post_pos = static_cast<const int32_t*>(pp_b.buf);
  const unsigned char* post_flip = static_cast<const unsigned char*>(pf_b.buf);
  const int64_t* tlens = static_cast<const int64_t*>(tl_b.buf);
  const int64_t* starts = static_cast<const int64_t*>(st_b.buf);
  const int64_t* sids = static_cast<const int64_t*>(sid_b.buf);

  struct Part {
    std::vector<int32_t> qpos, extpos;
    std::vector<int64_t> extid, qi;
  };
  unsigned hw = std::thread::hardware_concurrency();
  int nt_threads = hw ? (int)hw : 2;
  if (nt_threads > H) nt_threads = (int)(H ? H : 1);
  if (nt_threads < 1) nt_threads = 1;
  std::vector<Part> parts(nt_threads);
  std::vector<std::pair<Py_ssize_t, Py_ssize_t>> ranges(nt_threads);
  for (int t = 0; t < nt_threads; ++t) {
    ranges[t] = {H * t / nt_threads, H * (t + 1) / nt_threads};
  }
  auto worker = [&](int t) {
    Part& out = parts[t];
    Py_ssize_t lo = ranges[t].first, hi = ranges[t].second;
    if (lo >= hi) return;
    // qi of the first hit by binary search; advance incrementally
    int64_t qi = (std::upper_bound(starts, starts + nq + 1, g_hit[lo]) -
                  starts) - 1;
    for (Py_ssize_t h = lo; h < hi; ++h) {
      const int64_t g = g_hit[h];
      while (qi + 1 <= nq && starts[qi + 1] <= g) ++qi;
      const int32_t qpos = (int32_t)(g - starts[qi]);
      const int64_t row = row_hit[h];
      const unsigned char qfwd = fwd_hit[h];
      const int64_t p0 = offsets[row];
      const int64_t p1 = p0 + counts[row];
      const int64_t sid = sids[qi];
      for (int64_t p = p0; p < p1; ++p) {
        const unsigned char same = qfwd ^ post_flip[p];
        const int64_t tseq = post_seq[p];
        const int64_t ext_id = 2 * tseq + (same ? 0 : 1);
        const int32_t ext_pos =
            same ? post_pos[p]
                 : (int32_t)(tlens[tseq] - k - post_pos[p]);
        if (symmetric && ext_id == sid && ext_pos == qpos) continue;
        out.qpos.push_back(qpos);
        out.extid.push_back(ext_id);
        out.extpos.push_back(ext_pos);
        out.qi.push_back(qi);
      }
    }
  };
  Py_BEGIN_ALLOW_THREADS;
  std::vector<std::thread> threads;
  for (int t = 1; t < nt_threads; ++t) threads.emplace_back(worker, t);
  worker(0);
  for (auto& th : threads) th.join();
  Py_END_ALLOW_THREADS;

  int64_t M = 0;
  for (auto& p : parts) M += (int64_t)p.qpos.size();
  std::vector<int32_t> qpos_out, extpos_out;
  std::vector<int64_t> extid_out;
  qpos_out.reserve(M);
  extpos_out.reserve(M);
  extid_out.reserve(M);
  std::vector<int64_t> qbounds(nq + 1, 0);
  for (auto& p : parts) {
    qpos_out.insert(qpos_out.end(), p.qpos.begin(), p.qpos.end());
    extid_out.insert(extid_out.end(), p.extid.begin(), p.extid.end());
    extpos_out.insert(extpos_out.end(), p.extpos.begin(), p.extpos.end());
    for (int64_t qi : p.qi) ++qbounds[qi + 1];
  }
  for (Py_ssize_t q = 0; q < nq; ++q) qbounds[q + 1] += qbounds[q];

  auto as_bytes = [](const void* p, size_t nbytes) {
    return PyBytes_FromStringAndSize(static_cast<const char*>(p),
                                     (Py_ssize_t)nbytes);
  };
  PyObject* r = Py_BuildValue(
      "NNNN", as_bytes(qpos_out.data(), qpos_out.size() * 4),
      as_bytes(extid_out.data(), extid_out.size() * 8),
      as_bytes(extpos_out.data(), extpos_out.size() * 4),
      as_bytes(qbounds.data(), qbounds.size() * 8));
  for (Py_buffer* pb : {&gh_b, &rh_b, &fh_b, &cnt_b, &off_b, &ps_b,
                        &pp_b, &pf_b, &tl_b, &st_b, &sid_b}) {
    PyBuffer_Release(pb);
  }
  return r;
}

// ---------------------------------------------------------------------
// chain_dp_host: full-window chaining DP for SMALL match groups.
//
// Semantics are exactly the device scan's (flye_jax/ops/chain.py
// _chain_dp_scan, itself a port of reference overlap.cpp:277-323):
//   transition j -> i iff 0 < dcur < max_jump and 0 < dext < max_jump
//   match = min(dcur, dext, k); gap = jd > 100 ? 2*jd : jd/2
//   score[i] = max(k, best); parent[i] = best > k ? argmax j : -1
//   (LATEST j wins ties, matching the scan's reversed argmax)
// For groups of <= lookback matches the device's bounded window covers
// every predecessor, so full-window host DP is bit-identical.  Small
// groups are the vast majority and cost less on the host than a device
// dispatch and transfer; the device keeps the long groups.
//
// (gcur, gext: int32; gstart/glen: int64[n]) ->
//   (scoff int64[n], score int32[total], parent int32[total])
// ---------------------------------------------------------------------
static PyObject* chain_dp_host(PyObject*, PyObject* args) {
  Py_buffer gcur_b, gext_b, gstart_b, glen_b;
  Py_ssize_t n;
  int k, max_jump;
  if (!PyArg_ParseTuple(args, "y*y*y*y*nii", &gcur_b, &gext_b, &gstart_b,
                        &glen_b, &n, &k, &max_jump)) {
    return nullptr;
  }
  const int32_t* gcur = static_cast<const int32_t*>(gcur_b.buf);
  const int32_t* gext = static_cast<const int32_t*>(gext_b.buf);
  const int64_t* gstarts = static_cast<const int64_t*>(gstart_b.buf);
  const int64_t* glens = static_cast<const int64_t*>(glen_b.buf);

  std::vector<int64_t> scoff(n + 1, 0);
  for (Py_ssize_t r = 0; r < n; ++r) scoff[r + 1] = scoff[r] + glens[r];
  const int64_t total = scoff[n];
  std::vector<int32_t> score(total), parent(total);

  std::atomic<Py_ssize_t> next(0);
  auto worker = [&]() {
    for (;;) {
      Py_ssize_t r = next.fetch_add(1);
      if (r >= n) break;
      const int64_t m = glens[r];
      const int32_t* cur = gcur + gstarts[r];
      const int32_t* ext = gext + gstarts[r];
      int32_t* sc = score.data() + scoff[r];
      int32_t* pa = parent.data() + scoff[r];
      if (m == 0) continue;
      // the group's chaining axis is sorted ascending (by cur, or by
      // ext when the target is longer — the prep decides); walking
      // predecessors backward lets us stop at the first one whose
      // sorted-axis jump reaches max_jump: every earlier one jumps at
      // least as far and is invalid too.  This bounds the quadratic
      // window to the matches within max_jump bases, exactly like the
      // reference's early break (reference: overlap.cpp:292-295).
      bool cur_sorted = true, ext_sorted = true;
      for (int64_t i = 1; i < m && (cur_sorted || ext_sorted); ++i) {
        cur_sorted &= cur[i] >= cur[i - 1];
        ext_sorted &= ext[i] >= ext[i - 1];
      }
      sc[0] = k;
      pa[0] = -1;
      for (int64_t i = 1; i < m; ++i) {
        const int32_t ci = cur[i], ei = ext[i];
        int64_t best = INT64_MIN;
        int64_t bestj = -1;
        // descending j: first-seen candidate wins ties (== the scan's
        // latest-j-wins rule)
        for (int64_t j = i - 1; j >= 0; --j) {
          const int32_t dcur = ci - cur[j];
          const int32_t dext = ei - ext[j];
          if (cur_sorted && dcur >= max_jump) break;
          if (ext_sorted && dext >= max_jump) break;
          if (dcur <= 0 || dcur >= max_jump || dext <= 0 ||
              dext >= max_jump) {
            continue;
          }
          const int32_t match = std::min(std::min(dcur, dext), k);
          const int32_t jd = std::abs(dcur - dext);
          const int32_t gap = jd > 100 ? 2 * jd : jd / 2;
          const int64_t cand = (int64_t)sc[j] + match - gap;
          if (cand > best) {
            best = cand;
            bestj = j;
          }
        }
        sc[i] = (int32_t)std::max<int64_t>(best, k);
        pa[i] = best > k ? (int32_t)bestj : -1;
      }
    }
  };
  unsigned hw = std::thread::hardware_concurrency();
  int nt_threads = hw ? (int)hw : 2;
  if (nt_threads > n) nt_threads = (int)n;
  if (nt_threads < 1) nt_threads = 1;
  Py_BEGIN_ALLOW_THREADS;
  std::vector<std::thread> threads;
  for (int t = 1; t < nt_threads; ++t) threads.emplace_back(worker);
  worker();
  for (auto& th : threads) th.join();
  Py_END_ALLOW_THREADS;

  auto as_bytes = [](const void* p, size_t nbytes) {
    return PyBytes_FromStringAndSize(static_cast<const char*>(p),
                                     (Py_ssize_t)nbytes);
  };
  PyObject* r = Py_BuildValue(
      "NNN", as_bytes(scoff.data(), scoff.size() * 8),
      as_bytes(score.data(), score.size() * 4),
      as_bytes(parent.data(), parent.size() * 4));
  for (Py_buffer* pb : {&gcur_b, &gext_b, &gstart_b, &glen_b}) {
    PyBuffer_Release(pb);
  }
  return r;
}

// ---------------------------------------------------------------------
// finish_overlaps: backtrack + overlap tests + anchor thinning +
// k-mer divergence + primary selection for one chain-DP bucket batch
// (behavioral port of reference: src/sequence/overlap.cpp:330-427 and
// overlapTest overlap.cpp:29-69, batched over bucket rows).
//
// score/parent: flat int32 arrays; row r occupies [scoff[r],
// scoff[r] + min(glen[r], W)) (device buckets pass scoff[r] = r*W,
// the host DP passes its exact per-group offsets); per-row group data
// via gstart/glen into the batch-global gcur/gext; per-row
// eid/elen/stride/qi/cid/clen; per-QUERY sorted filtered positions
// (filt + foff, indexed by qi).
// flags bit0=check_overhang, bit1=force_local, bit2=symmetric,
// bit3=only_max_ext, bit4=thin_anchors.
// Returns (row_of(int32[V]), coords(int32[V*4]), score(int64[V]),
//          div(double[V]), aoff(int64[V+1]), anchors(int32 pairs))
// with overlaps of each row in primary-selection order.
// ---------------------------------------------------------------------
static PyObject* finish_overlaps(PyObject*, PyObject* args) {
  Py_buffer sc_b, pa_b, scoff_b, gcur_b, gext_b, gstart_b, glen_b,
      eid_b, elen_b, stride_b, qi_b, cid_b, clen_b, filt_b, foff_b;
  Py_ssize_t nrows;
  int W, k, min_overlap, max_overhang, flags;
  double sample_rate;
  if (!PyArg_ParseTuple(args, "y*y*y*niy*y*y*y*y*y*y*y*y*y*y*y*iiiid",
                        &sc_b, &pa_b, &scoff_b, &nrows, &W, &gcur_b,
                        &gext_b, &gstart_b, &glen_b, &eid_b, &elen_b,
                        &stride_b, &qi_b, &cid_b, &clen_b, &filt_b,
                        &foff_b, &k, &min_overlap, &max_overhang, &flags,
                        &sample_rate)) {
    return nullptr;
  }
  const int32_t* score_m = static_cast<const int32_t*>(sc_b.buf);
  const int32_t* parent_m = static_cast<const int32_t*>(pa_b.buf);
  const int64_t* scoffs = static_cast<const int64_t*>(scoff_b.buf);
  const int32_t* gcur = static_cast<const int32_t*>(gcur_b.buf);
  const int32_t* gext = static_cast<const int32_t*>(gext_b.buf);
  const int64_t* gstarts = static_cast<const int64_t*>(gstart_b.buf);
  const int64_t* glens = static_cast<const int64_t*>(glen_b.buf);
  const int64_t* eids = static_cast<const int64_t*>(eid_b.buf);
  const int32_t* elens = static_cast<const int32_t*>(elen_b.buf);
  const int32_t* strides = static_cast<const int32_t*>(stride_b.buf);
  const int32_t* qis = static_cast<const int32_t*>(qi_b.buf);
  const int64_t* cids = static_cast<const int64_t*>(cid_b.buf);
  const int32_t* clens = static_cast<const int32_t*>(clen_b.buf);
  const int64_t* filt = static_cast<const int64_t*>(filt_b.buf);
  const int64_t* foff = static_cast<const int64_t*>(foff_b.buf);
  const bool check_overhang = flags & 1;
  const bool force_local = flags & 2;
  const bool symmetric = flags & 4;
  const bool only_max_ext = flags & 8;
  const bool thin_anchors = flags & 16;

  struct Ov {
    int32_t cb, ce, eb, ee;
    int64_t score;
    double div;
    std::vector<int32_t> anchors;  // interleaved (c, e)
  };
  struct RowOut {
    std::vector<Ov> primary;
  };
  std::vector<RowOut> rows(nrows);

  std::atomic<Py_ssize_t> next(0);
  auto worker = [&]() {
    std::vector<int32_t> parent, order, path;
    std::vector<Ov> cand;
    for (;;) {
      Py_ssize_t r = next.fetch_add(1);
      if (r >= nrows) break;
      const int64_t gs = gstarts[r];
      const int64_t n = std::min<int64_t>(glens[r], W);
      if (n == 0) continue;
      const int32_t* score = score_m + scoffs[r];
      parent.assign(parent_m + scoffs[r], parent_m + scoffs[r] + n);
      const int32_t* gc = gcur + gs;
      const int32_t* gx = gext + gs;
      const int64_t cur_id = cids[r];
      const int64_t ext_id = eids[r];
      const int32_t cur_len = clens[r];
      const int32_t ext_len = elens[r];
      const int32_t stride = strides[r];
      const int32_t qi = qis[r];
      const int64_t* fp = filt + foff[qi];
      const int64_t nf_all = foff[qi + 1] - foff[qi];

      order.resize(n);
      for (int64_t i = 0; i < n; ++i) order[i] = (int32_t)i;
      std::stable_sort(order.begin(), order.end(),
                       [&](int32_t a, int32_t b) {
                         return score[a] > score[b];
                       });
      cand.clear();
      for (int64_t oi = 0; oi < n; ++oi) {
        const int32_t start = order[oi];
        if (parent[start] == -1) continue;
        path.clear();
        int32_t pos = start;
        while (pos != -1) {
          path.push_back(pos);
          int32_t nxt = parent[pos];
          parent[pos] = -1;
          pos = nxt;
        }
        const int32_t first = path.back();
        const int32_t last = path.front();
        const int64_t cscore =
            (int64_t)score[last] - (int64_t)score[first] + k - 1;
        std::reverse(path.begin(), path.end());

        const int32_t cb = gc[first], ce = gc[last] + k - 1;
        const int32_t eb = gx[first], ee = gx[last] + k - 1;
        const int32_t cur_range = ce - cb, ext_range = ee - eb;
        // ---- overlap sanity tests (reference: overlap.cpp:29-69) ----
        if (cur_range < min_overlap || ext_range < min_overlap) continue;
        if (std::abs(cur_range - ext_range) >
            0.5 * std::min(cur_range, ext_range)) {
          continue;
        }
        if (symmetric && cur_id == ext_id) {
          const int32_t inter =
              std::min(ce, ee) - std::max(cb, eb);
          if (inter > cur_range / 2) continue;
        }
        if (symmetric && cur_id == (ext_id ^ 1)) {
          const int32_t inter = std::min(ce, ext_len - eb) -
                                std::max(cb, ext_len - ee);
          if (inter > cur_range / 2) continue;
        }
        if (!force_local && check_overhang) {
          const int32_t lr =
              std::max(std::min(cb, eb),
                       std::min(cur_len - ce, ext_len - ee));
          if (lr > max_overhang) continue;
        }
        // ---- anchors ----
        Ov ov;
        ov.cb = cb;
        ov.ce = ce;
        ov.eb = eb;
        ov.ee = ee;
        ov.score = cscore;
        if (thin_anchors) {
          int32_t lc = gc[path[0]], le = gx[path[0]];
          ov.anchors.push_back(lc);
          ov.anchors.push_back(le);
          for (size_t t = 1; t < path.size(); ++t) {
            const int32_t c = gc[path[t]], e = gx[path[t]];
            if (c - lc > k && e > le) {
              ov.anchors.push_back(c);
              ov.anchors.push_back(e);
              lc = c;
              le = e;
            }
          }
        } else {
          int32_t lc = -1, le = -1;
          for (size_t t = 0; t < path.size(); ++t) {
            const int32_t c = gc[path[t]], e = gx[path[t]];
            if (c > lc && e > le) {
              ov.anchors.push_back(c);
              ov.anchors.push_back(e);
              lc = c;
              le = e;
            }
          }
        }
        // ---- k-mer divergence (reference: overlap.cpp:410-423) ----
        const int64_t lo =
            std::lower_bound(fp, fp + nf_all, (int64_t)cb) - fp;
        const int64_t hi =
            std::lower_bound(fp, fp + nf_all, (int64_t)ce) - fp;
        const int64_t n_filtered = hi - lo;
        const int64_t norm_len =
            std::max(cur_range, ext_range) - n_filtered;
        double match_rate = std::min(
            1.0, (double)path.size() * stride * sample_rate /
                     std::max<int64_t>(1, norm_len));
        match_rate = std::max(match_rate, 1e-9);
        ov.div = std::log(1.0 / match_rate) / k;
        cand.push_back(std::move(ov));
      }
      if (cand.empty()) continue;
      // stable sort by descending score (matches list.sort in Python)
      std::stable_sort(cand.begin(), cand.end(),
                       [](const Ov& a, const Ov& b) {
                         return a.score > b.score;
                       });
      RowOut& out = rows[r];
      if (only_max_ext) {
        out.primary.push_back(std::move(cand.front()));
      } else {
        for (Ov& ov : cand) {
          bool drop = false;
          for (const Ov& p : out.primary) {
            if (p.cb <= ov.cb && ov.ce <= p.ce && p.eb <= ov.eb &&
                ov.ee <= p.ee && p.score > ov.score) {
              drop = true;
              break;
            }
          }
          if (!drop) out.primary.push_back(std::move(ov));
        }
      }
    }
  };
  unsigned hw = std::thread::hardware_concurrency();
  int nt_threads = hw ? (int)hw : 2;
  if (nt_threads > nrows) nt_threads = (int)nrows;
  if (nt_threads < 1) nt_threads = 1;
  Py_BEGIN_ALLOW_THREADS;
  std::vector<std::thread> threads;
  for (int t = 1; t < nt_threads; ++t) threads.emplace_back(worker);
  worker();
  for (auto& th : threads) th.join();
  Py_END_ALLOW_THREADS;

  int64_t V = 0, atotal = 0;
  for (auto& rr : rows) {
    V += (int64_t)rr.primary.size();
    for (auto& ov : rr.primary) atotal += (int64_t)ov.anchors.size();
  }
  std::vector<int32_t> row_of;
  row_of.reserve(V);
  std::vector<int32_t> coords;
  coords.reserve(V * 4);
  std::vector<int64_t> vscore;
  vscore.reserve(V);
  std::vector<double> vdiv;
  vdiv.reserve(V);
  std::vector<int64_t> aoff(1, 0);
  aoff.reserve(V + 1);
  std::vector<int32_t> anchors;
  anchors.reserve(atotal);
  for (Py_ssize_t r = 0; r < nrows; ++r) {
    for (Ov& ov : rows[r].primary) {
      row_of.push_back((int32_t)r);
      coords.push_back(ov.cb);
      coords.push_back(ov.ce);
      coords.push_back(ov.eb);
      coords.push_back(ov.ee);
      vscore.push_back(ov.score);
      vdiv.push_back(ov.div);
      aoff.push_back(aoff.back() + (int64_t)ov.anchors.size() / 2);
      anchors.insert(anchors.end(), ov.anchors.begin(), ov.anchors.end());
    }
  }
  auto as_bytes = [](const void* p, size_t nbytes) {
    return PyBytes_FromStringAndSize(static_cast<const char*>(p),
                                     (Py_ssize_t)nbytes);
  };
  PyObject* r = Py_BuildValue(
      "NNNNNN", as_bytes(row_of.data(), row_of.size() * 4),
      as_bytes(coords.data(), coords.size() * 4),
      as_bytes(vscore.data(), vscore.size() * 8),
      as_bytes(vdiv.data(), vdiv.size() * 8),
      as_bytes(aoff.data(), aoff.size() * 8),
      as_bytes(anchors.data(), anchors.size() * 4));
  for (Py_buffer* pb : {&sc_b, &pa_b, &scoff_b, &gcur_b, &gext_b,
                        &gstart_b, &glen_b, &eid_b, &elen_b, &stride_b,
                        &qi_b, &cid_b, &clen_b, &filt_b, &foff_b}) {
    PyBuffer_Release(pb);
  }
  return r;
}

static PyMethodDef methods[] = {
    {"backtrack_chains", backtrack_chains, METH_VARARGS,
     "Score-ordered chain backtracking with visited marking"},
    {"pack_sequences", pack_sequences, METH_VARARGS,
     "Parse FASTA/FASTQ bytes into a 2-bit code arena"},
    {"window_coverage", window_coverage, METH_VARARGS,
     "Interval -> window coverage counting"},
    {"polish_bubbles_host", polish_bubbles_host, METH_VARARGS,
     "Threaded CPU-fallback bubble polisher (hill climbing)"},
    {"banded_align", banded_align, METH_VARARGS,
     "Banded global alignment with traceback (ops bytes)"},
    {"chain_group_prep", chain_group_prep, METH_VARARGS,
     "Batched per-query match grouping + survival filters"},
    {"finish_overlaps", finish_overlaps, METH_VARARGS,
     "Backtrack + overlap tests + anchors + divergence per bucket"},
    {"chain_dp_host", chain_dp_host, METH_VARARGS,
     "Threaded full-window chaining DP for small match groups"},
    {"collect_matches", collect_matches, METH_VARARGS,
     "Posting-list expansion + strand transform for probed reads"},
    {"probe_stream", probe_stream, METH_VARARGS,
     "Rolling canonical k-mer probe of the sorted index table"},
    {"extract_kmers", extract_kmers, METH_VARARGS,
     "Rolling canonical k-mer extraction with per-read sampling"},
    {"count_kmer_freqs", count_kmer_freqs, METH_VARARGS,
     "Flat saturating-counter k-mer frequency pass"},
    {"count_kmer_freqs_radix", count_kmer_freqs_radix, METH_VARARGS,
     "Threaded radix-sort exact k-mer frequency pass"},
    {"radix_sort_pairs", radix_sort_pairs, METH_VARARGS,
     "Threaded stable radix sort of (key, payload) pairs"},
    {"select_solid_kmers", select_solid_kmers, METH_VARARGS,
     "Per-read frequency-threshold + tandem-filter selection"},
    {"polish_hopo_host", polish_hopo_host, METH_VARARGS,
     "Batched homopolymer ML + dinucleotide vote re-estimation"},
    {"refine_points", refine_points, METH_VARARGS,
     "Snap extrapolated read coordinates onto exact boundary markers"},
    {nullptr, nullptr, 0, nullptr}};

static struct PyModuleDef moduledef = {PyModuleDef_HEAD_INIT,
                                       "flye_native", nullptr, -1, methods};

PyMODINIT_FUNC PyInit_flye_native(void) {
  return PyModule_Create(&moduledef);
}
