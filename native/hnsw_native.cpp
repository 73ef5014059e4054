// hnsw_native — C++ host-side graph engine for hnsw_tpu.
//
// Operates IN PLACE on the exact padded numpy arrays the Python side
// owns (core/state.py layout): neighbors [L, cap, W] int32 (-1 padded),
// levels [cap] int32 (-1 = absent), vectors [cap, D] float32, sq_norms
// [cap] float32. This is the native replacement for the pure-Python
// sequential path (core/host_build.py): incremental inserts, deletes
// with in-edge sweep + replenish, and batched CPU search. Semantics
// match the device bulk builder: classic pool-ef beam search, diversity
// -heuristic edge selection with pruned backfill, per-layer degree caps
// (m0 on layer 0). Reference behaviors it reproduces: geometric level
// cap (graph.go:370-385 — levels are sampled Python-side and passed
// in), worst-eviction reverse edges (graph.go:41-81), neighbor repair
// on delete (graph.go:172-235).
//
// The latency tier additionally exposes hnsw_exact_scan: a fused
// scan-select-rerank over a contiguous row store (f32 or fp16) — the
// host-side twin of the device exact tier (reference anchor: the Go
// adaptive hybrid serves one query in ~2.51 ms, hybrid/README.md:650;
// parquet single search 128 us, parquet/README.md:69).
//
// Exposed as a plain C ABI for ctypes. No Python.h dependency.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <thread>
#include <utility>
#include <vector>

#if defined(__AVX512F__)
#include <immintrin.h>
#endif

namespace {

// ---------------------------------------------------------------------------
// SIMD dot kernels.
//
// GCC's autovectorizer turned the old 8-scalar-accumulator loop into a
// SINGLE 256-bit accumulator chain (vfmadd231ps ...,%ymm0 — verified in
// the disassembly), i.e. one 4-cycle FMA dependency chain at half the
// vector width the core supports. Explicit 512-bit intrinsics with four
// independent accumulators run the FMA units at full throughput
// (~4x the dot rate at D=128). Scalar fallbacks keep the engine
// portable; all variants use a fixed summation order (deterministic
// per build of the library).
// ---------------------------------------------------------------------------

inline float half_to_float(uint16_t h) {
  // portable IEEE 754 binary16 -> binary32
  uint32_t sign = (uint32_t)(h >> 15) << 31;
  uint32_t exp = (h >> 10) & 0x1f;
  uint32_t man = h & 0x3ff;
  uint32_t out;
  if (exp == 0) {
    if (man == 0) {
      out = sign;
    } else {  // subnormal
      int shift = 0;
      while (!(man & 0x400)) {
        man <<= 1;
        ++shift;
      }
      man &= 0x3ff;
      out = sign | ((uint32_t)(127 - 15 - shift) << 23) | (man << 13);
    }
  } else if (exp == 0x1f) {
    out = sign | 0x7f800000u | (man << 13);
  } else {
    out = sign | ((exp - 15 + 127) << 23) | (man << 13);
  }
  float f;
  std::memcpy(&f, &out, 4);
  return f;
}

#if defined(__AVX512F__)

inline float reduce512(__m512 a0, __m512 a1, __m512 a2, __m512 a3) {
  return _mm512_reduce_add_ps(
      _mm512_add_ps(_mm512_add_ps(a0, a1), _mm512_add_ps(a2, a3)));
}

inline float dot_f32(const float* a, const float* b, int n) {
  __m512 c0 = _mm512_setzero_ps(), c1 = _mm512_setzero_ps();
  __m512 c2 = _mm512_setzero_ps(), c3 = _mm512_setzero_ps();
  int i = 0;
  for (; i + 64 <= n; i += 64) {
    c0 = _mm512_fmadd_ps(_mm512_loadu_ps(a + i),
                         _mm512_loadu_ps(b + i), c0);
    c1 = _mm512_fmadd_ps(_mm512_loadu_ps(a + i + 16),
                         _mm512_loadu_ps(b + i + 16), c1);
    c2 = _mm512_fmadd_ps(_mm512_loadu_ps(a + i + 32),
                         _mm512_loadu_ps(b + i + 32), c2);
    c3 = _mm512_fmadd_ps(_mm512_loadu_ps(a + i + 48),
                         _mm512_loadu_ps(b + i + 48), c3);
  }
  for (; i + 16 <= n; i += 16)
    c0 = _mm512_fmadd_ps(_mm512_loadu_ps(a + i),
                         _mm512_loadu_ps(b + i), c0);
  float dot = reduce512(c0, c1, c2, c3);
  for (; i < n; ++i) dot += a[i] * b[i];
  return dot;
}

// fp16 rows vs f32 query: cvtph widens 16 halfs per load — half the
// memory traffic of f32 at full FMA throughput (the scan is
// memory-bound once the store exceeds L2).
inline float dot_f16(const uint16_t* a, const float* q, int n) {
  __m512 c0 = _mm512_setzero_ps(), c1 = _mm512_setzero_ps();
  __m512 c2 = _mm512_setzero_ps(), c3 = _mm512_setzero_ps();
  int i = 0;
  for (; i + 64 <= n; i += 64) {
    c0 = _mm512_fmadd_ps(_mm512_cvtph_ps(_mm256_loadu_si256(
             (const __m256i*)(a + i))), _mm512_loadu_ps(q + i), c0);
    c1 = _mm512_fmadd_ps(_mm512_cvtph_ps(_mm256_loadu_si256(
             (const __m256i*)(a + i + 16))), _mm512_loadu_ps(q + i + 16),
         c1);
    c2 = _mm512_fmadd_ps(_mm512_cvtph_ps(_mm256_loadu_si256(
             (const __m256i*)(a + i + 32))), _mm512_loadu_ps(q + i + 32),
         c2);
    c3 = _mm512_fmadd_ps(_mm512_cvtph_ps(_mm256_loadu_si256(
             (const __m256i*)(a + i + 48))), _mm512_loadu_ps(q + i + 48),
         c3);
  }
  for (; i + 16 <= n; i += 16)
    c0 = _mm512_fmadd_ps(_mm512_cvtph_ps(_mm256_loadu_si256(
             (const __m256i*)(a + i))), _mm512_loadu_ps(q + i), c0);
  float dot = reduce512(c0, c1, c2, c3);
  for (; i < n; ++i) dot += half_to_float(a[i]) * q[i];
  return dot;
}

#else  // scalar fallbacks

inline float dot_f32(const float* a, const float* b, int n) {
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int i = 0;
  for (; i + 8 <= n; i += 8)
    for (int j = 0; j < 8; ++j) acc[j] += a[i + j] * b[i + j];
  float tail = 0.f;
  for (; i < n; ++i) tail += a[i] * b[i];
  return ((acc[0] + acc[1]) + (acc[2] + acc[3])) +
         ((acc[4] + acc[5]) + (acc[6] + acc[7])) + tail;
}

inline float dot_f16(const uint16_t* a, const float* q, int n) {
  float acc = 0.f;
  for (int i = 0; i < n; ++i) acc += half_to_float(a[i]) * q[i];
  return acc;
}

#endif

// int8 dot: UNSIGNED query bytes (q+128, see below) x signed row bytes.
// VNNI's VPDPBUSD does 64 byte-MACs per instruction; the +128 bias is
// corrected by the caller with the precomputed row byte-sum.
#if defined(__AVX512VNNI__)
inline int32_t dot_u8s8(const uint8_t* q, const int8_t* r, int n) {
  __m512i acc = _mm512_setzero_si512();
  int i = 0;
  for (; i + 64 <= n; i += 64)
    acc = _mm512_dpbusd_epi32(acc,
                              _mm512_loadu_si512((const void*)(q + i)),
                              _mm512_loadu_si512((const void*)(r + i)));
  int32_t dot = _mm512_reduce_add_epi32(acc);
  for (; i < n; ++i) dot += (int32_t)q[i] * (int32_t)r[i];
  return dot;
}
#else
inline int32_t dot_u8s8(const uint8_t* q, const int8_t* r, int n) {
  int32_t dot = 0;
  for (int i = 0; i < n; ++i) dot += (int32_t)q[i] * (int32_t)r[i];
  return dot;
}
#endif

enum Metric { COSINE = 0, L2 = 1, SQEUCLIDEAN = 2, DOT = 3 };

struct Ctx {
  float* vectors;
  float* sq_norms;
  int32_t* neighbors;  // [L, cap, W]
  int32_t* levels;     // [cap]
  int64_t cap;
  int32_t D, L, W, m, m0, ef_c, metric, diversify;
  // visited stamps (epoch-based, no per-call clears)
  std::vector<uint32_t> stamp;
  uint32_t epoch = 0;

  inline int32_t* row(int layer, int64_t slot) {
    return neighbors + ((int64_t)layer * cap + slot) * W;
  }
  inline const float* vec(int64_t slot) const {
    return vectors + slot * D;
  }
  inline int deg_cap(int layer) const { return layer == 0 ? m0 : m; }

  inline float dist(int64_t a, int64_t b) const {
    return finish(dot_f32(vec(a), vec(b), D), sq_norms[a], sq_norms[b]);
  }
  inline float dist_q(const float* q, float q_sq, int64_t b) const {
    return finish(dot_f32(q, vec(b), D), q_sq, sq_norms[b]);
  }
  inline void prefetch(int64_t slot) const {
    const char* p = reinterpret_cast<const char*>(vec(slot));
    for (int off = 0; off < D * 4; off += 64)
      __builtin_prefetch(p + off, 0, 1);
  }
  inline float finish(float dot, float sqa, float sqb) const {
    switch (metric) {
      case COSINE:
        return 1.f - dot / std::sqrt(sqa * sqb + 1e-30f);
      case L2:
        return std::sqrt(std::max(sqa + sqb - 2.f * dot, 0.f));
      case SQEUCLIDEAN:
        return std::max(sqa + sqb - 2.f * dot, 0.f);
      default:
        return -dot;
    }
  }

  void ensure_stamp() {
    if ((int64_t)stamp.size() < cap) stamp.assign(cap, 0);
    if (++epoch == 0) {  // wrapped: reset
      std::fill(stamp.begin(), stamp.end(), 0);
      epoch = 1;
    }
  }
};

using DS = std::pair<float, int64_t>;  // (dist, slot)

// Classic searchLayer: pool of ef, expand best-first while it beats the
// worst pool entry. Multi-start (pivot-seeded entry passes several
// basins). Returns ascending by distance, up to ef entries.
void search_layer(Ctx& c, int layer, const float* q, float q_sq,
                  const int64_t* starts, int n_starts, int ef,
                  std::vector<DS>& out) {
  c.ensure_stamp();
  const uint32_t ep = c.epoch;
  std::priority_queue<DS, std::vector<DS>, std::greater<DS>> cand;  // min
  std::priority_queue<DS> pool;                                     // max
  for (int s = 0; s < n_starts; ++s) {
    int64_t st = starts[s];
    if (st < 0 || c.stamp[st] == ep) continue;
    c.stamp[st] = ep;
    float d0 = c.dist_q(q, q_sq, st);
    cand.push({d0, st});
    pool.push({d0, st});
  }
  while (!cand.empty()) {
    auto [d_cur, cur] = cand.top();
    cand.pop();
    if (d_cur > pool.top().first && (int)pool.size() >= ef) break;
    const int32_t* r = c.row(layer, cur);
    // two-pass: collect the unvisited live neighbors, prefetch their
    // vector rows, then score — hides the row-gather RAM latency
    // behind the dot products (the scan is memory-latency-bound on
    // random 512 B rows).
    for (int i0 = 0; i0 < c.W; i0 += 256) {   // chunked for W > 256
      int32_t fresh[256];
      int nf = 0;
      const int i1 = std::min(i0 + 256, (int)c.W);
      for (int i = i0; i < i1; ++i) {
        int32_t nb = r[i];
        if (nb < 0) continue;
        if (c.stamp[nb] == ep) continue;
        c.stamp[nb] = ep;
        if (c.levels[nb] < 0) continue;  // tombstone
        c.prefetch(nb);
        fresh[nf++] = nb;
      }
      for (int i = 0; i < nf; ++i) {
        int32_t nb = fresh[i];
        float d = c.dist_q(q, q_sq, nb);
        if ((int)pool.size() < ef || d < pool.top().first) {
          pool.push({d, nb});
          if ((int)pool.size() > ef) pool.pop();
          cand.push({d, nb});
        }
      }
    }
  }
  out.clear();
  out.resize(pool.size());
  for (int i = (int)pool.size() - 1; !pool.empty(); --i) {
    out[i] = pool.top();
    pool.pop();
  }
}

inline void search_layer1(Ctx& c, int layer, const float* q, float q_sq,
                          int64_t start, int ef, std::vector<DS>& out) {
  search_layer(c, layer, q, q_sq, &start, 1, ef, out);
}

// Greedy descent step on upper layers (ef=1).
int64_t greedy_layer(Ctx& c, int layer, const float* q, float q_sq,
                     int64_t start) {
  int64_t cur = start;
  float best = c.dist_q(q, q_sq, cur);
  bool improved = true;
  while (improved) {
    improved = false;
    const int32_t* r = c.row(layer, cur);
    for (int i = 0; i < c.W; ++i) {
      int32_t nb = r[i];
      if (nb < 0 || c.levels[nb] < 0) continue;
      float d = c.dist_q(q, q_sq, nb);
      if (d < best) {
        best = d;
        cur = nb;
        improved = true;
      }
    }
  }
  return cur;
}

// Diversity heuristic (Malkov Alg.4 + pruned backfill) over candidates
// sorted ascending; writes up to deg winners into row (padded -1).
void select_diverse(Ctx& c, int64_t anchor, std::vector<DS>& cands,
                    int deg, int32_t* out_row) {
  std::sort(cands.begin(), cands.end());
  // dedup
  std::vector<DS> uniq;
  uniq.reserve(cands.size());
  for (auto& p : cands) {
    bool dup = false;
    for (auto& u : uniq)
      if (u.second == p.second) { dup = true; break; }
    if (!dup && p.second != anchor) uniq.push_back(p);
  }
  std::vector<int64_t> sel;
  std::vector<int64_t> pruned;
  sel.reserve(deg);
  if (c.diversify) {
    for (auto& [d, s] : uniq) {
      if ((int)sel.size() >= deg) break;
      bool ok = true;
      for (int64_t t : sel) {
        if (c.dist(s, t) < d) { ok = false; break; }
      }
      if (ok)
        sel.push_back(s);
      else
        pruned.push_back(s);
    }
    for (int64_t s : pruned) {
      if ((int)sel.size() >= deg) break;
      sel.push_back(s);
    }
  } else {
    for (auto& [d, s] : uniq) {
      if ((int)sel.size() >= deg) break;
      sel.push_back(s);
    }
  }
  int i = 0;
  for (; i < (int)sel.size() && i < c.W; ++i) out_row[i] = (int32_t)sel[i];
  for (; i < c.W; ++i) out_row[i] = -1;
}

// Reverse edge: add src into tgt's row; on overflow re-select with the
// heuristic over existing + src (graph.go:41-81's eviction, upgraded).
void reverse_insert(Ctx& c, int layer, int64_t tgt, int64_t src) {
  int deg = c.deg_cap(layer);
  int32_t* r = c.row(layer, tgt);
  int n = 0;
  for (int i = 0; i < c.W; ++i) {
    if (r[i] == (int32_t)src) return;
    if (r[i] >= 0) n++;
  }
  if (n < deg) {
    for (int i = 0; i < c.W; ++i)
      if (r[i] < 0) { r[i] = (int32_t)src; return; }
  }
  std::vector<DS> cands;
  cands.reserve(n + 1);
  for (int i = 0; i < c.W; ++i)
    if (r[i] >= 0) cands.push_back({c.dist(tgt, r[i]), r[i]});
  cands.push_back({c.dist(tgt, src), src});
  select_diverse(c, tgt, cands, deg, r);
}

// Refill a row from neighbors-of-neighbors (graph.go:172-219).
void replenish(Ctx& c, int layer, int64_t slot) {
  int deg = c.deg_cap(layer);
  int32_t* r = c.row(layer, slot);
  int n = 0;
  for (int i = 0; i < c.W; ++i)
    if (r[i] >= 0) n++;
  if (n >= deg) return;
  c.ensure_stamp();
  const uint32_t ep = c.epoch;
  c.stamp[slot] = ep;
  for (int i = 0; i < c.W; ++i)
    if (r[i] >= 0) c.stamp[r[i]] = ep;
  std::vector<DS> cands;
  for (int i = 0; i < c.W; ++i) {
    if (r[i] < 0) continue;
    const int32_t* r2 = c.row(layer, r[i]);
    for (int j = 0; j < c.W; ++j) {
      int32_t nb = r2[j];
      if (nb < 0 || c.stamp[nb] == ep || c.levels[nb] < 0) continue;
      c.stamp[nb] = ep;
      cands.push_back({c.dist(slot, nb), nb});
    }
  }
  std::sort(cands.begin(), cands.end());
  for (auto& [d, s] : cands) {
    if (n >= deg) break;
    for (int i = 0; i < c.W; ++i)
      if (r[i] < 0) {
        r[i] = (int32_t)s;
        n++;
        break;
      }
  }
}

Ctx make_ctx(float* vectors, float* sq_norms, int32_t* neighbors,
             int32_t* levels, int64_t cap, int32_t D, int32_t L,
             int32_t W, int32_t m, int32_t m0, int32_t ef_c,
             int32_t metric, int32_t diversify) {
  Ctx c;
  c.vectors = vectors;
  c.sq_norms = sq_norms;
  c.neighbors = neighbors;
  c.levels = levels;
  c.cap = cap;
  c.D = D;
  c.L = L;
  c.W = W;
  c.m = m;
  c.m0 = m0;
  c.ef_c = ef_c;
  c.metric = metric;
  c.diversify = diversify;
  return c;
}

}  // namespace

extern "C" {

// Sequential insert of n_slots new nodes (levels pre-sampled).
// entry_io/top_io: in-out scalars. Returns 0 on success.
int hnsw_insert_batch(float* vectors, float* sq_norms, int32_t* neighbors,
                      int32_t* levels, int64_t cap, int32_t D, int32_t L,
                      int32_t W, int32_t m, int32_t m0, int32_t ef_c,
                      int32_t metric, int32_t diversify,
                      const int64_t* slots, const int32_t* slot_levels,
                      int64_t n_slots, int32_t* entry_io,
                      int32_t* top_io) {
  Ctx c = make_ctx(vectors, sq_norms, neighbors, levels, cap, D, L, W, m,
                   m0, ef_c, metric, diversify);
  // Validate the WHOLE batch before any mutation: a nonzero return
  // guarantees the arrays are untouched, so the caller's pure-Python
  // fallback re-run cannot double-insert edges.
  for (int64_t i = 0; i < n_slots; ++i)
    if (slot_levels[i] >= L || slot_levels[i] < 0 || slots[i] < 0 ||
        slots[i] >= cap)
      return -1;
  int32_t entry = *entry_io, top = *top_io;
  std::vector<DS> found;
  for (int64_t i = 0; i < n_slots; ++i) {
    int64_t slot = slots[i];
    int lvl = slot_levels[i];
    if (entry < 0) {
      levels[slot] = lvl;
      entry = (int32_t)slot;
      top = lvl;
      continue;
    }
    const float* q = c.vec(slot);
    float q_sq = sq_norms[slot];
    int64_t cur = entry;
    for (int layer = top; layer > lvl; --layer)
      cur = greedy_layer(c, layer, q, q_sq, cur);
    for (int layer = std::min(top, lvl); layer >= 0; --layer) {
      search_layer1(c, layer, q, q_sq, cur, ef_c, found);
      if (!found.empty()) cur = found[0].second;
      int deg = c.deg_cap(layer);
      select_diverse(c, slot, found, deg, c.row(layer, slot));
      const int32_t* r = c.row(layer, slot);
      for (int e = 0; e < c.W; ++e)
        if (r[e] >= 0) reverse_insert(c, layer, r[e], slot);
    }
    levels[slot] = lvl;
    if (lvl > top) {
      top = lvl;
      entry = (int32_t)slot;
    }
  }
  *entry_io = entry;
  *top_io = top;
  return 0;
}

// Batch delete with one in-edge sweep per layer + replenish of the
// affected rows. deleted levels must still be set on entry; they are
// cleared here. Returns number of repaired rows.
int64_t hnsw_delete_batch(float* vectors, float* sq_norms,
                          int32_t* neighbors, int32_t* levels, int64_t cap,
                          int32_t D, int32_t L, int32_t W, int32_t m,
                          int32_t m0, int32_t ef_c, int32_t metric,
                          int32_t diversify, const int64_t* slots,
                          int64_t n_slots, int32_t* entry_io,
                          int32_t* top_io) {
  Ctx c = make_ctx(vectors, sq_norms, neighbors, levels, cap, D, L, W, m,
                   m0, ef_c, metric, diversify);
  std::vector<char> dead(cap, 0);
  int max_lvl = 0;
  for (int64_t i = 0; i < n_slots; ++i) {
    dead[slots[i]] = 1;
    max_lvl = std::max(max_lvl, (int)levels[slots[i]]);
  }
  int64_t repaired = 0;
  for (int layer = 0; layer <= std::min(max_lvl, L - 1); ++layer) {
    std::vector<int64_t> affected;
    for (int64_t s = 0; s < cap; ++s) {
      if (levels[s] < layer || dead[s]) continue;
      int32_t* r = c.row(layer, s);
      bool hit = false;
      for (int i = 0; i < W; ++i)
        if (r[i] >= 0 && dead[r[i]]) {
          r[i] = -1;
          hit = true;
        }
      if (hit) affected.push_back(s);
    }
    for (int64_t i = 0; i < n_slots; ++i)
      if (levels[slots[i]] >= layer)
        std::memset(c.row(layer, slots[i]), 0xFF, W * sizeof(int32_t));
    for (int64_t s : affected) {
      replenish(c, layer, s);
      repaired++;
    }
  }
  for (int64_t i = 0; i < n_slots; ++i) levels[slots[i]] = -1;
  // refresh entry/top if needed
  int32_t entry = *entry_io, top = *top_io;
  if (entry >= 0 && levels[entry] < 0) {
    top = -1;
    entry = -1;
    for (int64_t s = 0; s < cap; ++s)
      if (levels[s] > top) {
        top = levels[s];
        entry = (int32_t)s;
      }
  }
  *entry_io = entry;
  *top_io = top;
  return repaired;
}

// Batched CPU search (the host serving path / oracle).
//
// pivots/n_piv/n_seed: pivot-seeded entry (the device coarse-scan trick
// ported down, Graph.entry_mode="pivots"): score the pivot subset with
// SIMD dots, seed the layer-0 beam with the n_seed best basins, and
// skip the upper-layer elevator entirely. n_piv == 0 = classic descent.
int hnsw_search_batch(float* vectors, float* sq_norms, int32_t* neighbors,
                      int32_t* levels, int64_t cap, int32_t D, int32_t L,
                      int32_t W, int32_t m, int32_t m0, int32_t metric,
                      const float* queries, int64_t n_q, int32_t k,
                      int32_t ef, int32_t entry, int32_t top,
                      const int64_t* pivots, int64_t n_piv,
                      int32_t n_seed, int64_t* out_ids,
                      float* out_dists) {
  Ctx c = make_ctx(vectors, sq_norms, neighbors, levels, cap, D, L, W, m,
                   m0, ef, metric, 0);
  if (entry < 0) {
    for (int64_t i = 0; i < n_q * k; ++i) {
      out_ids[i] = -1;
      out_dists[i] = INFINITY;
    }
    return 0;
  }
  if (n_seed <= 0) n_seed = 1;
  // Queries are independent: shard them across threads, each with its
  // OWN Ctx (the visited-stamp table is per-thread state). Results are
  // written to disjoint out rows — no synchronization needed, and the
  // per-query result is identical to the serial run (determinism).
  auto run_range = [&](int64_t q0, int64_t q1, Ctx& cl) {
    std::vector<DS> found;
    std::vector<int64_t> seeds;
    for (int64_t qi = q0; qi < q1; ++qi) {
      const float* q = queries + qi * D;
      float q_sq = dot_f32(q, q, D);
      seeds.clear();
      if (n_piv > 0) {
        // top-n_seed pivots by distance (small max-heap)
        std::priority_queue<DS> best;
        for (int64_t p = 0; p < n_piv; ++p) {
          if (p + 4 < n_piv) cl.prefetch(pivots[p + 4]);
          int64_t s = pivots[p];
          if (s < 0 || cl.levels[s] < 0) continue;
          float d = cl.dist_q(q, q_sq, s);
          if ((int)best.size() < n_seed) {
            best.push({d, s});
          } else if (d < best.top().first) {
            best.pop();
            best.push({d, s});
          }
        }
        while (!best.empty()) {
          seeds.push_back(best.top().second);
          best.pop();
        }
      }
      if (seeds.empty()) {
        int64_t cur = entry;
        for (int layer = top; layer > 0; --layer)
          cur = greedy_layer(cl, layer, q, q_sq, cur);
        seeds.push_back(cur);
      }
      search_layer(cl, 0, q, q_sq, seeds.data(), (int)seeds.size(),
                   std::max(ef, k), found);
      for (int i = 0; i < k; ++i) {
        if (i < (int)found.size()) {
          out_ids[qi * k + i] = found[i].second;
          out_dists[qi * k + i] = found[i].first;
        } else {
          out_ids[qi * k + i] = -1;
          out_dists[qi * k + i] = INFINITY;
        }
      }
    }
  };
  unsigned hw = std::thread::hardware_concurrency();
  int64_t n_threads = std::min<int64_t>(n_q, hw ? hw : 1);
  if (n_threads <= 1 || n_q < 4) {
    run_range(0, n_q, c);
    return 0;
  }
  std::vector<Ctx> ctxs(n_threads, c);   // copies: per-thread stamps
  std::vector<std::thread> threads;
  int64_t per = (n_q + n_threads - 1) / n_threads;
  for (int64_t t = 0; t < n_threads; ++t) {
    int64_t q0 = t * per, q1 = std::min(q0 + per, n_q);
    if (q0 >= q1) break;
    threads.emplace_back(run_range, q0, q1, std::ref(ctxs[t]));
  }
  for (auto& th : threads) th.join();
  return 0;
}

// ---------------------------------------------------------------------------
// Fused exact scan — the host latency tier's hot loop.
//
// Scans a CONTIGUOUS row store (sequential access: the hardware
// prefetcher streams it, unlike the graph's random gathers), keeps a
// bounded kk-heap of the best candidates, then (optionally) reranks
// them against a full-precision f32 store and emits the exact top-k.
//
// dtype: 0 = f32 rows, 1 = fp16 rows (IEEE binary16), 2 = int8 rows
// (per-row scale in `scales`; `row_sums` = per-row byte sums for the
// unsigned-query bias correction — VNNI's VPDPBUSD takes u8 x s8, so
// the query is quantized to q8+128 per call).
// For COSINE the scan rows must be unit-normalized and sq_norms NULL
// (the Python side materializes a normalized sidecar once per sync);
// selection then costs one multiply per row instead of a rsqrt.
// L2 selects on squared distance (monotone) and square-roots only the
// emitted k values. alive NULL = all rows live.
// rr_rows/rr_sq NULL = no rerank (f32 scan is already exact).
// Returns 0 on success, -1 on bad arguments.
// ---------------------------------------------------------------------------
int hnsw_exact_scan(const void* rows, int32_t dtype, const float* sq_norms,
                    const float* scales, const int32_t* row_sums,
                    const uint8_t* alive, int64_t n, int32_t D,
                    int32_t metric, const float* rr_rows,
                    const float* rr_sq, const float* queries, int64_t n_q,
                    int32_t k, int32_t kk, int64_t* out_ids,
                    float* out_dists) {
  if (n < 0 || k <= 0 || kk < k || D <= 0) return -1;
  if (metric == COSINE && sq_norms != nullptr) return -1;
  if (dtype == 2 && (scales == nullptr || row_sums == nullptr)) return -1;
  const float* rows_f32 = (const float*)rows;
  const uint16_t* rows_f16 = (const uint16_t*)rows;
  const int8_t* rows_i8 = (const int8_t*)rows;
  const int64_t row_bytes =
      (int64_t)D * (dtype == 2 ? 1 : dtype == 1 ? 2 : 4);
  // prefetch the FULL row several rows ahead (one line is not enough:
  // a 128-d f32 row spans 8 cache lines, and the virtualized HW
  // prefetcher under-runs the FMA consumption rate)
  const int pf_rows = 8;
  const int64_t pf_lines = (row_bytes + 63) / 64;
  std::vector<uint8_t> q8(dtype == 2 ? D : 0);
  std::vector<DS> heap;   // max-heap on selection key
  heap.reserve(kk + 1);
  std::vector<DS> cand;
  for (int64_t qi = 0; qi < n_q; ++qi) {
    const float* q = queries + qi * D;
    float q_sq = dot_f32(q, q, D);
    float inv_q = 1.f / std::sqrt(q_sq + 1e-30f);
    float q_scale = 1.f;
    float q8_bias = 0.f;   // 128 * sum(r8) correction factor distance
    if (dtype == 2) {
      float amax = 0.f;
      for (int i = 0; i < D; ++i) amax = std::max(amax, std::fabs(q[i]));
      q_scale = amax > 0.f ? amax / 127.f : 1.f;
      for (int i = 0; i < D; ++i) {
        float v = q[i] / q_scale;
        int32_t iv = (int32_t)std::lrintf(v);
        iv = std::min(std::max(iv, -127), 127);
        q8[i] = (uint8_t)(iv + 128);
      }
      q8_bias = 128.f;
    }
    heap.clear();
    const char* base = (const char*)rows;
    // per-row epilogue: metric selection key + bounded kk-heap
    auto consider = [&](int64_t r, float dot) {
      float sel;  // selection key: monotone with the true distance
      switch (metric) {
        case COSINE:
          sel = 1.f - dot * inv_q;       // rows are unit
          break;
        case L2:
        case SQEUCLIDEAN:
          sel = q_sq + (sq_norms ? sq_norms[r] : 1.f) - 2.f * dot;
          break;
        default:
          sel = -dot;
      }
      if ((int)heap.size() < kk) {
        heap.push_back({sel, r});
        std::push_heap(heap.begin(), heap.end());
      } else if (sel < heap.front().first) {
        std::pop_heap(heap.begin(), heap.end());
        heap.back() = {sel, r};
        std::push_heap(heap.begin(), heap.end());
      }
    };
    int64_t r0 = 0;
#if defined(__AVX512VNNI__)
    if (dtype == 2 && (D & 63) == 0) {
      // 4-row interleaved VNNI blocks: one row's D/64 chained
      // VPDPBUSDs serialize on the ~5-cycle accumulate latency;
      // interleaving 4 independent chains fills the pipe (measured
      // 50.1 -> 42.6 us/query on the 10k x 128 scan; 8-row adds
      // nothing — past 4 the scan is L2-bound)
      const int nv = D / 64;
      for (; r0 + 4 <= n; r0 += 4) {
        if (r0 + pf_rows < n) {
          const char* p = base + (r0 + pf_rows) * row_bytes;
          for (int64_t l = 0; l < pf_lines * 4; ++l)
            __builtin_prefetch(p + l * 64, 0, 3);
        }
        const int8_t* p = rows_i8 + r0 * D;
        __m512i a0 = _mm512_setzero_si512(), a1 = a0, a2 = a0, a3 = a0;
        for (int j = 0; j < nv; ++j) {
          const __m512i qj =
              _mm512_loadu_si512((const void*)(q8.data() + j * 64));
          a0 = _mm512_dpbusd_epi32(
              a0, qj, _mm512_loadu_si512((const void*)(p + j * 64)));
          a1 = _mm512_dpbusd_epi32(
              a1, qj,
              _mm512_loadu_si512((const void*)(p + D + j * 64)));
          a2 = _mm512_dpbusd_epi32(
              a2, qj,
              _mm512_loadu_si512((const void*)(p + 2 * D + j * 64)));
          a3 = _mm512_dpbusd_epi32(
              a3, qj,
              _mm512_loadu_si512((const void*)(p + 3 * D + j * 64)));
        }
        int32_t di[4] = {_mm512_reduce_add_epi32(a0),
                         _mm512_reduce_add_epi32(a1),
                         _mm512_reduce_add_epi32(a2),
                         _mm512_reduce_add_epi32(a3)};
        for (int j = 0; j < 4; ++j) {
          int64_t r = r0 + j;
          if (alive && !alive[r]) continue;
          consider(r, ((float)di[j] - q8_bias * (float)row_sums[r]) *
                          q_scale * scales[r]);
        }
      }
    }
#endif
    for (int64_t r = r0; r < n; ++r) {
      if (r + pf_rows < n) {
        const char* p = base + (r + pf_rows) * row_bytes;
        for (int64_t l = 0; l < pf_lines; ++l)
          __builtin_prefetch(p + l * 64, 0, 3);
      }
      if (alive && !alive[r]) continue;
      float dot;
      if (dtype == 2) {
        int32_t di = dot_u8s8(q8.data(), rows_i8 + r * D, D);
        dot = ((float)di - q8_bias * (float)row_sums[r]) * q_scale *
              scales[r];
      } else if (dtype == 1) {
        dot = dot_f16(rows_f16 + r * D, q, D);
      } else {
        dot = dot_f32(rows_f32 + r * D, q, D);
      }
      consider(r, dot);
    }
    cand.assign(heap.begin(), heap.end());
    if (rr_rows) {
      // exact f32 rerank of the candidate pool
      for (auto& c : cand) {
        float dot = dot_f32(rr_rows + c.second * D, q, D);
        float sqb = rr_sq ? rr_sq[c.second] : 1.f;
        switch (metric) {
          case COSINE:
            c.first = 1.f - dot / std::sqrt(q_sq * sqb + 1e-30f);
            break;
          case L2:
            c.first = std::sqrt(std::max(q_sq + sqb - 2.f * dot, 0.f));
            break;
          case SQEUCLIDEAN:
            c.first = std::max(q_sq + sqb - 2.f * dot, 0.f);
            break;
          default:
            c.first = -dot;
        }
      }
    }
    std::sort(cand.begin(), cand.end());
    for (int i = 0; i < k; ++i) {
      if (i < (int)cand.size()) {
        float d = cand[i].first;
        if (!rr_rows && metric == L2)
          d = std::sqrt(std::max(d, 0.f));  // selection was squared
        out_ids[qi * k + i] = cand[i].second;
        out_dists[qi * k + i] = d;
      } else {
        out_ids[qi * k + i] = -1;
        out_dists[qi * k + i] = INFINITY;
      }
    }
  }
  return 0;
}

}  // extern "C"
