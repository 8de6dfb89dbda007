// Native host runtime for muchsalsa_tpu: hot I/O and byte-level paths.
//
// TPU-native counterpart of the reference's C++ data plane —
// BlastFileAccessor/BlastFileReader (libms/src/BlastFileReader.cpp),
// SequenceAccessor (libms/src/SequenceAccessor.cpp) and
// getReverseComplement (libms/src/SequenceUtils.cpp:41-61) — exposed as
// a C ABI consumed through ctypes.  The compute path stays JAX/Pallas;
// this library covers the host-side ingest that feeds device arrays.
//
// Build: see muchsalsa_tpu/native/build.py (g++ -O3 -shared -fPIC).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// reverse complement (upper-case ACGT swapped, everything else verbatim)

void ms_revcomp(const uint8_t *in, uint8_t *out, int64_t n) {
  static uint8_t table[256];
  static bool init = false;
  if (!init) {
    for (int i = 0; i < 256; ++i) table[i] = static_cast<uint8_t>(i);
    table['A'] = 'T'; table['T'] = 'A'; table['G'] = 'C'; table['C'] = 'G';
    init = true;
  }
  for (int64_t i = 0; i < n; ++i) out[i] = table[in[n - 1 - i]];
}

// ---------------------------------------------------------------------------
// PAF parsing with string interning
//
// Returns the number of kept rows, filling caller-allocated arrays of
// capacity `max_rows` (one per kept line).  Skips the final line when
// `skip_last` (reference parity, BlastFileReader.cpp:76).  Filters:
// matches >= min_matches && illumina range length >= min_matches.
// Interned names are returned via ms_paf_names() as '\n'-joined blobs.

struct PafState {
  std::vector<std::string> nano_names;
  std::vector<std::string> illu_names;
  std::string nano_blob;
  std::string illu_blob;
};

static PafState *g_paf_state = nullptr;

static int64_t intern(std::unordered_map<std::string, int64_t> &map,
                      std::vector<std::string> &names, std::string_view key) {
  // owned-string keys: SSO strings move their inline buffers when the
  // names vector grows, so string_view keys into them would dangle
  auto [it, inserted] = map.emplace(std::string(key),
                                    static_cast<int64_t>(names.size()));
  if (inserted) names.emplace_back(key);
  return it->second;
}

int64_t ms_parse_paf(const char *data, int64_t len, int32_t min_matches,
                     int32_t skip_last, int32_t *illu_id, int32_t *nano_id,
                     int32_t *illu_start, int32_t *illu_end,
                     int32_t *nano_start, int32_t *nano_end,
                     int32_t *nano_length, uint8_t *direction, int64_t *score,
                     int64_t *line_idx, int64_t max_rows) {
  delete g_paf_state;
  g_paf_state = new PafState();
  std::unordered_map<std::string, int64_t> nano_map, illu_map;
  g_paf_state->nano_names.reserve(1 << 16);
  g_paf_state->illu_names.reserve(1 << 16);

  // collect line offsets first so the last line can be skipped
  std::vector<std::pair<const char *, const char *>> lines;
  const char *p = data;
  const char *end = data + len;
  while (p < end) {
    const char *nl = static_cast<const char *>(memchr(p, '\n', end - p));
    const char *stop = nl ? nl : end;
    if (stop > p) lines.emplace_back(p, stop);
    p = nl ? nl + 1 : end;
  }
  int64_t limit = static_cast<int64_t>(lines.size()) - (skip_last ? 1 : 0);

  int64_t out = 0;
  for (int64_t ln = 0; ln < limit && out < max_rows; ++ln) {
    const char *s = lines[ln].first;
    const char *e = lines[ln].second;

    const char *cols[10];
    int64_t col_len[10];
    int ncols = 0;
    const char *field = s;
    for (const char *q = s; q <= e && ncols < 10; ++q) {
      if (q == e || *q == '\t') {
        cols[ncols] = field;
        col_len[ncols] = q - field;
        ++ncols;
        field = q + 1;
      }
    }
    if (ncols < 10) return -1;  // invalid PAF

    auto to_int = [](const char *b, int64_t n) -> int64_t {
      int64_t v = 0;
      bool neg = n > 0 && b[0] == '-';
      for (int64_t i = neg ? 1 : 0; i < n; ++i) v = v * 10 + (b[i] - '0');
      return neg ? -v : v;
    };

    int64_t is_ = to_int(cols[2], col_len[2]);
    int64_t ie = to_int(cols[3], col_len[3]) - 1;
    int64_t matches = to_int(cols[9], col_len[9]);
    if (matches < min_matches || ie - is_ + 1 < min_matches) continue;

    illu_id[out] = static_cast<int32_t>(
        intern(illu_map, g_paf_state->illu_names, {cols[0], static_cast<size_t>(col_len[0])}));
    nano_id[out] = static_cast<int32_t>(
        intern(nano_map, g_paf_state->nano_names, {cols[5], static_cast<size_t>(col_len[5])}));
    illu_start[out] = static_cast<int32_t>(is_);
    illu_end[out] = static_cast<int32_t>(ie);
    nano_start[out] = static_cast<int32_t>(to_int(cols[7], col_len[7]));
    nano_end[out] = static_cast<int32_t>(to_int(cols[8], col_len[8]) - 1);
    nano_length[out] = static_cast<int32_t>(to_int(cols[6], col_len[6]));
    direction[out] = (col_len[4] == 1 && cols[4][0] == '+') ? 1 : 0;
    score[out] = matches;
    line_idx[out] = ln;
    ++out;
  }

  // build name blobs
  auto join = [](const std::vector<std::string> &names, std::string &blob) {
    blob.clear();
    for (size_t i = 0; i < names.size(); ++i) {
      if (i) blob.push_back('\n');
      blob += names[i];
    }
  };
  join(g_paf_state->nano_names, g_paf_state->nano_blob);
  join(g_paf_state->illu_names, g_paf_state->illu_blob);

  return out;
}

int64_t ms_paf_count_lines(const char *data, int64_t len) {
  int64_t count = 0;
  const char *p = data;
  const char *end = data + len;
  while (p < end) {
    const char *nl = static_cast<const char *>(memchr(p, '\n', end - p));
    const char *stop = nl ? nl : end;
    if (stop > p) ++count;
    p = nl ? nl + 1 : end;
  }
  return count;
}

const char *ms_paf_nano_names() { return g_paf_state ? g_paf_state->nano_blob.c_str() : ""; }
const char *ms_paf_illu_names() { return g_paf_state ? g_paf_state->illu_blob.c_str() : ""; }

void ms_paf_free() {
  delete g_paf_state;
  g_paf_state = nullptr;
}

// ---------------------------------------------------------------------------
// FASTA/FASTQ parsing: one pass producing a concatenated sequence blob,
// per-record offsets, and '\n'-joined first-token names.

struct FastaState {
  std::string names;
  std::string seq;
  std::vector<int64_t> offsets;  // size = n_records + 1
};

static FastaState *g_fasta_state = nullptr;

int64_t ms_parse_fasta(const char *data, int64_t len, int32_t is_fastq) {
  delete g_fasta_state;
  g_fasta_state = new FastaState();
  auto &st = *g_fasta_state;
  st.seq.reserve(static_cast<size_t>(len));
  st.offsets.push_back(0);

  const char *p = data;
  const char *end = data + len;
  int64_t records = 0;

  if (!is_fastq) {
    while (p < end) {
      const char *nl = static_cast<const char *>(memchr(p, '\n', end - p));
      const char *stop = nl ? nl : end;
      if (p < stop && *p == '>') {
        if (records) st.offsets.push_back(static_cast<int64_t>(st.seq.size()));
        const char *name_end = p + 1;
        while (name_end < stop && !isspace(static_cast<unsigned char>(*name_end))) ++name_end;
        if (records) st.names.push_back('\n');
        st.names.append(p + 1, name_end);
        ++records;
      } else if (records) {
        // bulk-append; trim trailing CR/space (whitespace inside a
        // sequence line is rare — fall back to filtering only then)
        const char *q2 = stop;
        while (q2 > p && isspace(static_cast<unsigned char>(q2[-1]))) --q2;
        bool inner_ws = false;
        for (const char *q = p; q < q2; ++q)
          if (isspace(static_cast<unsigned char>(*q))) { inner_ws = true; break; }
        if (!inner_ws) {
          st.seq.append(p, q2);
        } else {
          for (const char *q = p; q < q2; ++q)
            if (!isspace(static_cast<unsigned char>(*q))) st.seq.push_back(*q);
        }
      }
      p = nl ? nl + 1 : end;
    }
  } else {
    int phase = 0;  // 0 header, 1 seq, 2 plus, 3 qual
    while (p < end) {
      const char *nl = static_cast<const char *>(memchr(p, '\n', end - p));
      const char *stop = nl ? nl : end;
      if (phase == 0) {
        if (p < stop && *p == '@') {
          if (records) st.offsets.push_back(static_cast<int64_t>(st.seq.size()));
          const char *name_end = p + 1;
          while (name_end < stop && !isspace(static_cast<unsigned char>(*name_end))) ++name_end;
          if (records) st.names.push_back('\n');
          st.names.append(p + 1, name_end);
          ++records;
          phase = 1;
        }
      } else if (phase == 1) {
        const char *q2 = stop;
        while (q2 > p && isspace(static_cast<unsigned char>(q2[-1]))) --q2;
        bool inner_ws = false;
        for (const char *q = p; q < q2; ++q)
          if (isspace(static_cast<unsigned char>(*q))) { inner_ws = true; break; }
        if (!inner_ws) {
          st.seq.append(p, q2);
        } else {
          for (const char *q = p; q < q2; ++q)
            if (!isspace(static_cast<unsigned char>(*q))) st.seq.push_back(*q);
        }
        phase = 2;
      } else if (phase == 2) {
        phase = 3;
      } else {
        phase = 0;
      }
      p = nl ? nl + 1 : end;
    }
  }

  if (records) st.offsets.push_back(static_cast<int64_t>(st.seq.size()));
  return records;
}

int64_t ms_fasta_seq_len() { return g_fasta_state ? static_cast<int64_t>(g_fasta_state->seq.size()) : 0; }
int64_t ms_fasta_names_len() { return g_fasta_state ? static_cast<int64_t>(g_fasta_state->names.size()) : 0; }

void ms_fasta_copy(uint8_t *seq_out, int64_t *offsets_out, char *names_out) {
  if (!g_fasta_state) return;
  auto &st = *g_fasta_state;
  memcpy(seq_out, st.seq.data(), st.seq.size());
  memcpy(offsets_out, st.offsets.data(), st.offsets.size() * sizeof(int64_t));
  memcpy(names_out, st.names.data(), st.names.size());
}

void ms_fasta_free() {
  delete g_fasta_state;
  g_fasta_state = nullptr;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// native mapper core: minimizer sketch + index lookup + diagonal-band
// chaining for one read, mirroring pipeline/mapper.py::map_read exactly
// (same fmix32 hashes, leftmost window minima, band segmentation and
// covered-bases scoring), one C call per read.

#include <algorithm>
#include <vector>

static inline uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

extern "C" {

// Computes minimizers of `codes` (values 0..3, >=4 invalid).
// Fills pos/hash/strand arrays; returns count (capacity = len).
int64_t ms_minimizers(const uint8_t *codes, int64_t len, int32_t k, int32_t w,
                      int32_t *pos_out, uint32_t *hash_out, uint8_t *strand_out) {
  if (len < k) return 0;
  int64_t L = len - k + 1;

  std::vector<uint32_t> hash(L);
  std::vector<uint8_t> strand(L);
  std::vector<uint8_t> valid(L);

  uint32_t fwd = 0, rc = 0;
  int bad = 0;
  uint32_t mask = (k * 2 >= 32) ? 0xFFFFFFFFu : ((1u << (2 * k)) - 1);
  for (int64_t i = 0; i < len; ++i) {
    uint8_t c = codes[i];
    fwd = ((fwd << 2) | (c & 3)) & mask;
    rc = (rc >> 2) | (((3u - (c & 3)) & 3u) << (2 * (k - 1)));
    bad += (c >= 4);
    if (i >= k) bad -= (codes[i - k] >= 4);
    if (i >= k - 1) {
      int64_t p = i - k + 1;
      uint32_t canon = fwd < rc ? fwd : rc;
      valid[p] = bad == 0;
      strand[p] = fwd <= rc;
      hash[p] = valid[p] ? fmix32(canon) : 0xFFFFFFFFu;
    }
  }

  int64_t count = 0;
  if (L <= w) {
    int64_t best = 0;
    for (int64_t i = 1; i < L; ++i)
      if (hash[i] < hash[best]) best = i;
    if (valid[best]) {
      pos_out[count] = static_cast<int32_t>(best);
      hash_out[count] = hash[best];
      strand_out[count] = strand[best];
      ++count;
    }
    return count;
  }

  // leftmost minimum per window; dedup consecutive selections
  int64_t last_sel = -1;
  for (int64_t start = 0; start + w <= L; ++start) {
    int64_t best = start;
    for (int64_t j = start + 1; j < start + w; ++j)
      if (hash[j] < hash[best]) best = j;
    if (best != last_sel && valid[best]) {
      // positions are emitted in increasing order because windows slide
      pos_out[count] = static_cast<int32_t>(best);
      hash_out[count] = hash[best];
      strand_out[count] = strand[best];
      ++count;
      last_sel = best;
    } else if (best == last_sel) {
      // already selected
    }
  }
  return count;
}

struct Anchor {
  int64_t key;   // unitig*2 + rel
  int64_t diag;
  int32_t q;
  int32_t t;
};

struct MapHit {
  int32_t unitig;
  uint8_t strand;
  int32_t qs, qe, ts, te, matches, nanchors;
};

// per-thread scratch so batch mapping reuses allocations across reads
struct MapScratch {
  std::vector<int32_t> mpos;
  std::vector<uint32_t> mhash;
  std::vector<uint8_t> mstrand;
  std::vector<Anchor> anchors;
  std::vector<int32_t> seg_t;
};

// core of map_read: sketch + index lookup + diagonal-band chaining,
// appending hits to `out` (same algorithm as pipeline/mapper.py::map_read)
// optional open-addressing membership table over the sorted unique
// index hashes (batch mapping builds one per call): ~1.5 probes per
// lookup instead of log2(H) cache-missing binary-search rounds
struct HashLookup {
  std::vector<uint32_t> key;
  std::vector<int64_t> idx;  // -1 = empty
  uint64_t mask = 0;

  void build(const uint32_t *hashes, int64_t n) {
    size_t bits = 1;
    while ((1ULL << bits) < static_cast<size_t>(2 * n + 2)) ++bits;
    mask = (1ULL << bits) - 1;
    key.assign(mask + 1, 0);
    idx.assign(mask + 1, -1);
    for (int64_t i = 0; i < n; ++i) {
      size_t s = hashes[i] & mask;
      while (idx[s] >= 0) s = (s + 1) & mask;
      key[s] = hashes[i];
      idx[s] = i;
    }
  }
  int64_t find(uint32_t h) const {
    size_t s = h & mask;
    while (idx[s] >= 0) {
      if (key[s] == h) return idx[s];
      s = (s + 1) & mask;
    }
    return -1;
  }
};

static void map_codes_into(const uint8_t *codes, int64_t len, int32_t k,
                           int32_t w, const uint32_t *idx_hashes,
                           int64_t n_hashes, const int64_t *idx_offsets,
                           const int32_t *entry_unitig,
                           const int32_t *entry_pos,
                           const uint8_t *entry_strand, int32_t bandwidth,
                           int32_t min_anchors, int32_t min_chain,
                           MapScratch &sc, std::vector<MapHit> &out,
                           const HashLookup *table = nullptr) {
  if (len < k || n_hashes == 0) return;

  sc.mpos.resize(len);
  sc.mhash.resize(len);
  sc.mstrand.resize(len);
  int64_t n_min = ms_minimizers(codes, len, k, w, sc.mpos.data(),
                                sc.mhash.data(), sc.mstrand.data());

  auto &anchors = sc.anchors;
  anchors.clear();
  anchors.reserve(n_min * 2);
  for (int64_t i = 0; i < n_min; ++i) {
    int64_t b;
    if (table) {
      b = table->find(sc.mhash[i]);
      if (b < 0) continue;
    } else {
      const uint32_t *lo =
          std::lower_bound(idx_hashes, idx_hashes + n_hashes, sc.mhash[i]);
      if (lo == idx_hashes + n_hashes || *lo != sc.mhash[i]) continue;
      b = lo - idx_hashes;
    }
    for (int64_t e = idx_offsets[b]; e < idx_offsets[b + 1]; ++e) {
      bool rel = (entry_strand[e] != 0) == (sc.mstrand[i] != 0);
      Anchor a;
      a.key = static_cast<int64_t>(entry_unitig[e]) * 2 + (rel ? 1 : 0);
      a.q = entry_pos[e];
      a.t = sc.mpos[i];
      a.diag = rel ? (static_cast<int64_t>(a.t) - a.q)
                   : (static_cast<int64_t>(a.t) + a.q);
      anchors.push_back(a);
    }
  }
  if (anchors.empty()) return;

  std::sort(anchors.begin(), anchors.end(), [](const Anchor &x, const Anchor &y) {
    if (x.key != y.key) return x.key < y.key;
    return x.diag < y.diag;
  });

  auto &seg_t = sc.seg_t;
  int64_t n_a = static_cast<int64_t>(anchors.size());
  int64_t s = 0;
  while (s < n_a) {
    int64_t e = s + 1;
    while (e < n_a && anchors[e].key == anchors[s].key &&
           anchors[e].diag - anchors[e - 1].diag <= bandwidth)
      ++e;

    int64_t cnt = e - s;
    if (cnt >= min_anchors) {
      int32_t qmin = anchors[s].q, qmax = anchors[s].q;
      seg_t.clear();
      for (int64_t i = s; i < e; ++i) {
        qmin = std::min(qmin, anchors[i].q);
        qmax = std::max(qmax, anchors[i].q);
        seg_t.push_back(anchors[i].t);
      }
      std::sort(seg_t.begin(), seg_t.end());
      int64_t covered = k;
      for (size_t i = 1; i < seg_t.size(); ++i)
        covered += std::min<int64_t>(seg_t[i] - seg_t[i - 1], k);

      if (covered >= min_chain) {
        MapHit h;
        h.unitig = static_cast<int32_t>(anchors[s].key / 2);
        h.strand = static_cast<uint8_t>(anchors[s].key % 2);
        h.qs = qmin;
        h.qe = qmax + k;
        h.ts = seg_t.front();
        h.te = seg_t.back() + k;
        h.matches = static_cast<int32_t>(covered);
        h.nanchors = static_cast<int32_t>(cnt);
        out.push_back(h);
      }
    }
    s = e;
  }
}

int64_t ms_map_read(const uint8_t *codes, int64_t len, int32_t k, int32_t w,
                    const uint32_t *idx_hashes, int64_t n_hashes,
                    const int64_t *idx_offsets, const int32_t *entry_unitig,
                    const int32_t *entry_pos, const uint8_t *entry_strand,
                    int32_t bandwidth, int32_t min_anchors, int32_t min_chain,
                    int32_t *out_unitig, uint8_t *out_strand, int32_t *out_qs,
                    int32_t *out_qe, int32_t *out_ts, int32_t *out_te,
                    int32_t *out_matches, int32_t *out_nanchors,
                    int64_t max_out) {
  MapScratch sc;
  std::vector<MapHit> hits;
  map_codes_into(codes, len, k, w, idx_hashes, n_hashes, idx_offsets,
                 entry_unitig, entry_pos, entry_strand, bandwidth, min_anchors,
                 min_chain, sc, hits);
  int64_t n_out = std::min<int64_t>(static_cast<int64_t>(hits.size()), max_out);
  for (int64_t i = 0; i < n_out; ++i) {
    out_unitig[i] = hits[i].unitig;
    out_strand[i] = hits[i].strand;
    out_qs[i] = hits[i].qs;
    out_qe[i] = hits[i].qe;
    out_ts[i] = hits[i].ts;
    out_te[i] = hits[i].te;
    out_matches[i] = hits[i].matches;
    out_nanchors[i] = hits[i].nanchors;
  }
  return n_out;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// batched mapper + sketcher: whole read sets in one call, fanned out over
// std::threads (the host analog of the reference's ThreadPool job-per-read
// fan-out, libms/src/threading/ThreadPool.cpp).  Input sequences arrive as
// one ASCII blob + offsets; 2-bit encoding happens here.  Results are
// deterministic regardless of thread count: each read's hits are owned by
// exactly one slot, flattened in read order.

#include <array>
#include <atomic>
#include <thread>

static const uint8_t *encode_table() {
  static uint8_t table[256];
  static bool init = false;
  if (!init) {
    for (int i = 0; i < 256; ++i) table[i] = 4;
    table['A'] = table['a'] = 0;
    table['C'] = table['c'] = 1;
    table['G'] = table['g'] = 2;
    table['T'] = table['t'] = 3;
    init = true;
  }
  return table;
}

struct MapBatchState {
  std::vector<std::vector<MapHit>> per_read;
  int64_t total = 0;
};
static MapBatchState *g_map_batch = nullptr;

struct SketchBatchState {
  std::vector<std::vector<int32_t>> pos;
  std::vector<std::vector<uint32_t>> hash;
  std::vector<std::vector<uint8_t>> strand;
  int64_t total = 0;
};
static SketchBatchState *g_sketch_batch = nullptr;

extern "C" {

int64_t ms_map_batch(const uint8_t *ascii_blob, const int64_t *offsets,
                     int64_t n_reads, int32_t k, int32_t w,
                     const uint32_t *idx_hashes, int64_t n_hashes,
                     const int64_t *idx_offsets, const int32_t *entry_unitig,
                     const int32_t *entry_pos, const uint8_t *entry_strand,
                     int32_t bandwidth, int32_t min_anchors, int32_t min_chain,
                     int32_t n_threads) {
  delete g_map_batch;
  g_map_batch = new MapBatchState();
  g_map_batch->per_read.resize(n_reads);
  const uint8_t *table = encode_table();

  if (n_threads <= 0)
    n_threads = static_cast<int32_t>(std::thread::hardware_concurrency());

  HashLookup lut;
  lut.build(idx_hashes, n_hashes);

  // thread-local scratch keyed by a per-call slot counter
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    MapScratch sc;
    std::vector<uint8_t> codes;
    for (;;) {
      int64_t r = next.fetch_add(1);
      if (r >= n_reads) break;
      int64_t s = offsets[r], e = offsets[r + 1];
      int64_t len = e - s;
      codes.resize(len);
      for (int64_t i = 0; i < len; ++i) codes[i] = table[ascii_blob[s + i]];
      map_codes_into(codes.data(), len, k, w, idx_hashes, n_hashes,
                     idx_offsets, entry_unitig, entry_pos, entry_strand,
                     bandwidth, min_anchors, min_chain, sc,
                     g_map_batch->per_read[r], &lut);
    }
  };
  std::vector<std::thread> threads;
  for (int32_t t = 1; t < n_threads; ++t) threads.emplace_back(worker);
  worker();
  for (auto &th : threads) th.join();

  int64_t total = 0;
  for (auto &v : g_map_batch->per_read) total += static_cast<int64_t>(v.size());
  g_map_batch->total = total;
  return total;
}

void ms_map_batch_copy(int32_t *read_idx, int32_t *unitig, uint8_t *strand,
                       int32_t *qs, int32_t *qe, int32_t *ts, int32_t *te,
                       int32_t *matches, int32_t *nanchors) {
  if (!g_map_batch) return;
  int64_t o = 0;
  for (size_t r = 0; r < g_map_batch->per_read.size(); ++r) {
    for (const MapHit &h : g_map_batch->per_read[r]) {
      read_idx[o] = static_cast<int32_t>(r);
      unitig[o] = h.unitig;
      strand[o] = h.strand;
      qs[o] = h.qs;
      qe[o] = h.qe;
      ts[o] = h.ts;
      te[o] = h.te;
      matches[o] = h.matches;
      nanchors[o] = h.nanchors;
      ++o;
    }
  }
}

void ms_map_batch_free() {
  delete g_map_batch;
  g_map_batch = nullptr;
}

int64_t ms_sketch_batch(const uint8_t *ascii_blob, const int64_t *offsets,
                        int64_t n_reads, int32_t k, int32_t w,
                        int32_t n_threads) {
  delete g_sketch_batch;
  g_sketch_batch = new SketchBatchState();
  auto &st = *g_sketch_batch;
  st.pos.resize(n_reads);
  st.hash.resize(n_reads);
  st.strand.resize(n_reads);
  const uint8_t *table = encode_table();

  if (n_threads <= 0)
    n_threads = static_cast<int32_t>(std::thread::hardware_concurrency());

  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    std::vector<uint8_t> codes;
    std::vector<int32_t> pos;
    std::vector<uint32_t> hash;
    std::vector<uint8_t> strand;
    for (;;) {
      int64_t r = next.fetch_add(1);
      if (r >= n_reads) break;
      int64_t s = offsets[r], e = offsets[r + 1];
      int64_t len = e - s;
      codes.resize(len);
      for (int64_t i = 0; i < len; ++i) codes[i] = table[ascii_blob[s + i]];
      pos.resize(std::max<int64_t>(len, 1));
      hash.resize(std::max<int64_t>(len, 1));
      strand.resize(std::max<int64_t>(len, 1));
      int64_t cnt = ms_minimizers(codes.data(), len, k, w, pos.data(),
                                  hash.data(), strand.data());
      st.pos[r].assign(pos.begin(), pos.begin() + cnt);
      st.hash[r].assign(hash.begin(), hash.begin() + cnt);
      st.strand[r].assign(strand.begin(), strand.begin() + cnt);
    }
  };
  std::vector<std::thread> threads;
  for (int32_t t = 1; t < n_threads; ++t) threads.emplace_back(worker);
  worker();
  for (auto &th : threads) th.join();

  int64_t total = 0;
  for (auto &v : st.pos) total += static_cast<int64_t>(v.size());
  st.total = total;
  return total;
}

void ms_sketch_batch_copy(int64_t *read_offsets, int32_t *pos, uint32_t *hash,
                          uint8_t *strand) {
  if (!g_sketch_batch) return;
  auto &st = *g_sketch_batch;
  int64_t o = 0;
  for (size_t r = 0; r < st.pos.size(); ++r) {
    read_offsets[r] = o;
    size_t n = st.pos[r].size();
    if (n) {
      memcpy(pos + o, st.pos[r].data(), n * sizeof(int32_t));
      memcpy(hash + o, st.hash[r].data(), n * sizeof(uint32_t));
      memcpy(strand + o, st.strand[r].data(), n);
    }
    o += static_cast<int64_t>(n);
  }
  read_offsets[st.pos.size()] = o;
}

void ms_sketch_batch_free() {
  delete g_sketch_batch;
  g_sketch_batch = nullptr;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// k-mer pipeline stage: canonical counting (jellyfish count/dump
// equivalent, pipeline.sh:143-148), read-pair filtering (bbduk
// hdist=0 equivalent, pipeline.sh:151), and de Bruijn unitig
// construction (abyss-pe equivalent, pipeline.sh:157).  All mirror the
// python implementations in pipeline/kmer.py / pipeline/dbg.py exactly
// (tests assert identical outputs); counting and filtering fan out
// over std::threads with per-bucket merges.

namespace {

// canonical k-mer extraction (k <= 31) appending to per-bucket vectors
// (bucket = top 8 bits of the canonical value for a sorted global order)
template <typename Sink>
inline void extract_kmers(const uint8_t *ascii, int64_t len, int32_t k,
                          Sink &&sink) {
  const uint8_t *table = encode_table();
  uint64_t fwd = 0, rc = 0;
  const uint64_t mask = (k < 32) ? ((1ULL << (2 * k)) - 1) : ~0ULL;
  int run = 0;  // consecutive valid bases
  for (int64_t i = 0; i < len; ++i) {
    uint8_t c = table[ascii[i]];
    if (c >= 4) {
      run = 0;
      fwd = rc = 0;
      continue;
    }
    fwd = ((fwd << 2) | c) & mask;
    rc = (rc >> 2) | (static_cast<uint64_t>(3 - c) << (2 * (k - 1)));
    if (++run >= k) sink(fwd < rc ? fwd : rc);
  }
}

inline uint64_t revcomp_val(uint64_t v, int32_t k) {
  // complement then reverse 2-bit fields
  v = ~v;
  v = ((v >> 2) & 0x3333333333333333ULL) | ((v & 0x3333333333333333ULL) << 2);
  v = ((v >> 4) & 0x0F0F0F0F0F0F0F0FULL) | ((v & 0x0F0F0F0F0F0F0F0FULL) << 4);
  v = ((v >> 8) & 0x00FF00FF00FF00FFULL) | ((v & 0x00FF00FF00FF00FFULL) << 8);
  v = ((v >> 16) & 0x0000FFFF0000FFFFULL) | ((v & 0x0000FFFF0000FFFFULL) << 16);
  v = (v >> 32) | (v << 32);
  return v >> (64 - 2 * k);
}

struct KmerCountState {
  std::vector<uint64_t> vals;
  std::vector<int64_t> counts;
};
KmerCountState *g_kmer_state = nullptr;

struct UnitigState {
  std::vector<uint8_t> blob;
  std::vector<int64_t> offsets;  // n+1
};
UnitigState *g_unitig_state = nullptr;

}  // namespace

extern "C" {

int64_t ms_count_kmers(const uint8_t *ascii_blob, const int64_t *offsets,
                       int64_t n_seqs, int32_t k, int32_t n_threads) {
  delete g_kmer_state;
  g_kmer_state = new KmerCountState();
  if (n_threads <= 0)
    n_threads = static_cast<int32_t>(std::thread::hardware_concurrency());
  constexpr int B = 256;

  // pass 1: per-thread, per-bucket extraction over a contiguous range
  std::vector<std::array<std::vector<uint64_t>, B>> tl(n_threads);
  std::atomic<int64_t> next(0);
  auto extract_worker = [&](int t) {
    auto &buckets = tl[t];
    for (;;) {
      int64_t s = next.fetch_add(256);  // 256 reads per grab
      if (s >= n_seqs) break;
      int64_t e = std::min<int64_t>(s + 256, n_seqs);
      for (int64_t r = s; r < e; ++r) {
        extract_kmers(ascii_blob + offsets[r], offsets[r + 1] - offsets[r], k,
                      [&](uint64_t v) { buckets[v >> 56].push_back(v); });
      }
    }
  };
  {
    std::vector<std::thread> threads;
    for (int32_t t = 1; t < n_threads; ++t)
      threads.emplace_back(extract_worker, t);
    extract_worker(0);
    for (auto &th : threads) th.join();
  }

  // pass 2: per-bucket merge + sort + unique-count, buckets in parallel
  std::array<std::vector<uint64_t>, B> merged_vals;
  std::array<std::vector<int64_t>, B> merged_counts;
  std::atomic<int> next_b(0);
  auto bucket_worker = [&]() {
    for (;;) {
      int b = next_b.fetch_add(1);
      if (b >= B) break;
      size_t total = 0;
      for (auto &t : tl) total += t[b].size();
      if (!total) continue;
      std::vector<uint64_t> all;
      all.reserve(total);
      for (auto &t : tl) {
        all.insert(all.end(), t[b].begin(), t[b].end());
        t[b].clear();
        t[b].shrink_to_fit();
      }
      std::sort(all.begin(), all.end());
      auto &mv = merged_vals[b];
      auto &mc = merged_counts[b];
      for (size_t i = 0; i < all.size();) {
        size_t j = i + 1;
        while (j < all.size() && all[j] == all[i]) ++j;
        mv.push_back(all[i]);
        mc.push_back(static_cast<int64_t>(j - i));
        i = j;
      }
    }
  };
  {
    std::vector<std::thread> threads;
    for (int32_t t = 1; t < n_threads; ++t) threads.emplace_back(bucket_worker);
    bucket_worker();
    for (auto &th : threads) th.join();
  }

  for (int b = 0; b < B; ++b) {
    g_kmer_state->vals.insert(g_kmer_state->vals.end(), merged_vals[b].begin(),
                              merged_vals[b].end());
    g_kmer_state->counts.insert(g_kmer_state->counts.end(),
                                merged_counts[b].begin(),
                                merged_counts[b].end());
  }
  return static_cast<int64_t>(g_kmer_state->vals.size());
}

void ms_count_kmers_copy(uint64_t *vals, int64_t *counts) {
  if (!g_kmer_state) return;
  memcpy(vals, g_kmer_state->vals.data(),
         g_kmer_state->vals.size() * sizeof(uint64_t));
  memcpy(counts, g_kmer_state->counts.data(),
         g_kmer_state->counts.size() * sizeof(int64_t));
}

void ms_count_kmers_free() {
  delete g_kmer_state;
  g_kmer_state = nullptr;
}

// keep[i] = 1 iff neither mate of pair i contains a bad k-mer
void ms_filter_pairs(const uint8_t *blob1, const int64_t *off1,
                     const uint8_t *blob2, const int64_t *off2,
                     int64_t n_pairs, int32_t k, const uint64_t *bad,
                     int64_t n_bad, uint8_t *keep, int32_t n_threads) {
  if (n_threads <= 0)
    n_threads = static_cast<int32_t>(std::thread::hardware_concurrency());
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t s = next.fetch_add(256);
      if (s >= n_pairs) break;
      int64_t e = std::min<int64_t>(s + 256, n_pairs);
      for (int64_t i = s; i < e; ++i) {
        bool clean = true;
        auto check = [&](const uint8_t *blob, const int64_t *off) {
          if (!clean) return;
          bool hit = false;
          extract_kmers(blob + off[i], off[i + 1] - off[i], k,
                        [&](uint64_t v) {
                          if (hit) return;
                          hit = std::binary_search(bad, bad + n_bad, v);
                        });
          if (hit) clean = false;
        };
        if (n_bad) {
          check(blob1, off1);
          check(blob2, off2);
        }
        keep[i] = clean ? 1 : 0;
      }
    }
  };
  std::vector<std::thread> threads;
  for (int32_t t = 1; t < n_threads; ++t) threads.emplace_back(worker);
  worker();
  for (auto &th : threads) th.join();
}

// de Bruijn unitigs from a sorted canonical k-mer set (python
// UnitigBuilder.build parity: same walk rules, same ascending start
// order, deterministic output)
int64_t ms_build_unitigs(const uint64_t *kmers, int64_t n, int32_t k,
                         int32_t min_length) {
  delete g_unitig_state;
  g_unitig_state = new UnitigState();
  g_unitig_state->offsets.push_back(0);
  std::vector<uint8_t> visited(n, 0);
  const uint64_t mask = (k < 32) ? ((1ULL << (2 * k)) - 1) : ~0ULL;

  // open-addressing membership table: ~1.5 probes per lookup instead of
  // the log2(n) cache-missing rounds of a binary search (the walk does
  // ~8 lookups per emitted base — dominant at 100M+ k-mer scale)
  size_t tbits = 1;
  while ((1ULL << tbits) < static_cast<size_t>(2 * n + 2)) ++tbits;
  const size_t tmask = (1ULL << tbits) - 1;
  std::vector<uint64_t> tkey(tmask + 1, ~0ULL);
  std::vector<int64_t> tidx(tmask + 1);
  auto hash64 = [](uint64_t x) {
    x ^= x >> 33;
    x *= 0xFF51AFD7ED558CCDULL;
    x ^= x >> 33;
    x *= 0xC4CEB9FE1A85EC53ULL;
    x ^= x >> 33;
    return x;
  };
  for (int64_t i = 0; i < n; ++i) {
    size_t s = hash64(kmers[i]) & tmask;
    while (tkey[s] != ~0ULL) s = (s + 1) & tmask;
    tkey[s] = kmers[i];
    tidx[s] = i;
  }
  auto find = [&](uint64_t canon) -> int64_t {
    size_t s = hash64(canon) & tmask;
    while (tkey[s] != ~0ULL) {
      if (tkey[s] == canon) return tidx[s];
      s = (s + 1) & tmask;
    }
    return -1;
  };
  auto canon_of = [&](uint64_t v) {
    uint64_t r = revcomp_val(v, k);
    return v < r ? v : r;
  };
  // unique extension of v in the given direction; returns count and
  // writes the single extension to *out
  auto extensions = [&](uint64_t v, bool forward, uint64_t *out) {
    int cnt = 0;
    for (uint64_t b = 0; b < 4; ++b) {
      uint64_t nxt = forward ? (((v << 2) | b) & mask)
                             : ((v >> 2) | (b << (2 * (k - 1))));
      if (find(canon_of(nxt)) >= 0) {
        if (cnt == 0) *out = nxt;
        ++cnt;
        if (cnt > 1) break;
      }
    }
    return cnt;
  };

  std::vector<uint64_t> fwd_path, bwd_path;
  static const char DECODE[4] = {'A', 'C', 'G', 'T'};

  for (int64_t s = 0; s < n; ++s) {
    if (visited[s]) continue;
    visited[s] = 1;
    uint64_t start = kmers[s];

    auto walk = [&](uint64_t v, bool forward, std::vector<uint64_t> &path) {
      path.clear();
      uint64_t cur = v;
      for (;;) {
        uint64_t nxt;
        if (extensions(cur, forward, &nxt) != 1) break;
        uint64_t c = canon_of(nxt);
        int64_t ci = find(c);
        if (ci < 0 || visited[ci] || c == canon_of(cur)) break;
        uint64_t back;
        if (extensions(nxt, !forward, &back) != 1) break;
        path.push_back(nxt);
        visited[ci] = 1;
        cur = nxt;
      }
    };

    walk(start, true, fwd_path);
    walk(start, false, bwd_path);

    auto &blob = g_unitig_state->blob;
    size_t begin = blob.size();
    uint64_t first = bwd_path.empty() ? start : bwd_path.back();
    for (int32_t i = 0; i < k; ++i)
      blob.push_back(DECODE[(first >> (2 * (k - 1 - i))) & 3]);
    auto emit_tail = [&](uint64_t v) { blob.push_back(DECODE[v & 3]); };
    for (auto it = bwd_path.rbegin(); it != bwd_path.rend(); ++it)
      if (it != bwd_path.rbegin()) emit_tail(*it);
    if (!bwd_path.empty()) emit_tail(start);
    for (uint64_t v : fwd_path) emit_tail(v);

    if (blob.size() - begin >= static_cast<size_t>(min_length)) {
      g_unitig_state->offsets.push_back(static_cast<int64_t>(blob.size()));
    } else {
      blob.resize(begin);
    }
  }
  return static_cast<int64_t>(g_unitig_state->offsets.size()) - 1;
}

// the same walk driven by a precomputed (n, 8) extension-index table
// (ops/dbg_jax.py::ext_indices_device — the device leg of the DBG
// build): ext[i*8 + j] = set index of the canonical form of extension
// j of canonical k-mer i (j = base forward, 4 + base backward), or -1.
// A raw k-mer in reverse-complement orientation reads the opposite
// block with complemented base.  Output identical to ms_build_unitigs.
int64_t ms_build_unitigs_from_ext(const uint64_t *kmers, int64_t n,
                                  int32_t k, const int32_t *ext,
                                  int32_t min_length) {
  delete g_unitig_state;
  g_unitig_state = new UnitigState();
  g_unitig_state->offsets.push_back(0);
  std::vector<uint8_t> visited(n, 0);
  const uint64_t mask = (k < 32) ? ((1ULL << (2 * k)) - 1) : ~0ULL;

  // (count, base, target) of the raw k-mer's unique extension
  auto exts_of = [&](int64_t i, int orient, bool forward, int *b_out,
                     int64_t *j_out) {
    const bool use_fwd = (orient == 0) == forward;
    const int32_t *row = ext + 8 * i + (use_fwd ? 0 : 4);
    int cnt = 0, bb1 = -1;
    for (int bb = 0; bb < 4; ++bb) {
      if (row[bb] >= 0) {
        if (cnt == 0) bb1 = bb;
        ++cnt;
      }
    }
    if (cnt == 1) {
      *b_out = orient == 0 ? bb1 : 3 - bb1;
      *j_out = row[bb1];
    }
    return cnt;
  };

  std::vector<uint64_t> fwd_path, bwd_path;
  static const char DECODE[4] = {'A', 'C', 'G', 'T'};

  for (int64_t s = 0; s < n; ++s) {
    if (visited[s]) continue;
    visited[s] = 1;
    const uint64_t start = kmers[s];

    auto walk = [&](bool forward, std::vector<uint64_t> &path) {
      path.clear();
      int64_t i = s;
      uint64_t cur = start;
      int orient = 0;
      for (;;) {
        int b;
        int64_t j;
        if (exts_of(i, orient, forward, &b, &j) != 1) break;
        const uint64_t nxt =
            forward ? (((cur << 2) | static_cast<uint64_t>(b)) & mask)
                    : ((cur >> 2) |
                       (static_cast<uint64_t>(b) << (2 * (k - 1))));
        if (visited[j] || j == i) break;
        const int orient2 = nxt == kmers[j] ? 0 : 1;
        int b2;
        int64_t j2;
        if (exts_of(j, orient2, !forward, &b2, &j2) != 1) break;
        path.push_back(nxt);
        visited[j] = 1;
        i = j;
        cur = nxt;
        orient = orient2;
      }
    };

    walk(true, fwd_path);
    walk(false, bwd_path);

    auto &blob = g_unitig_state->blob;
    size_t begin = blob.size();
    uint64_t first = bwd_path.empty() ? start : bwd_path.back();
    for (int32_t i = 0; i < k; ++i)
      blob.push_back(DECODE[(first >> (2 * (k - 1 - i))) & 3]);
    auto emit_tail = [&](uint64_t v) { blob.push_back(DECODE[v & 3]); };
    for (auto it = bwd_path.rbegin(); it != bwd_path.rend(); ++it)
      if (it != bwd_path.rbegin()) emit_tail(*it);
    if (!bwd_path.empty()) emit_tail(start);
    for (uint64_t v : fwd_path) emit_tail(v);

    if (blob.size() - begin >= static_cast<size_t>(min_length)) {
      g_unitig_state->offsets.push_back(static_cast<int64_t>(blob.size()));
    } else {
      blob.resize(begin);
    }
  }
  return static_cast<int64_t>(g_unitig_state->offsets.size()) - 1;
}

int64_t ms_unitigs_blob_len() {
  return g_unitig_state ? static_cast<int64_t>(g_unitig_state->blob.size()) : 0;
}

void ms_unitigs_copy(uint8_t *blob, int64_t *offsets) {
  if (!g_unitig_state) return;
  if (!g_unitig_state->blob.empty())
    memcpy(blob, g_unitig_state->blob.data(), g_unitig_state->blob.size());
  memcpy(offsets, g_unitig_state->offsets.data(),
         g_unitig_state->offsets.size() * sizeof(int64_t));
}

void ms_unitigs_free() {
  delete g_unitig_state;
  g_unitig_state = nullptr;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// minimizer index construction: sketch every sequence, stable-sort the
// (hash, unitig, pos, strand) entries by hash, CSR-group by unique hash
// and drop repeat buckets (> max_occ).  Byte-identical to
// pipeline/mapper.py::MinimizerIndex.build (stable concatenation order,
// same repeat mask); the hash-major order comes from 256 top-byte radix
// buckets filled in global order + per-bucket stable sorts (parallel).

namespace {

struct IndexState {
  std::vector<uint32_t> uniq;
  std::vector<int64_t> offsets;
  std::vector<int32_t> unitig;
  std::vector<int32_t> pos;
  std::vector<uint8_t> strand;
};
IndexState *g_index_state = nullptr;

struct IndexEntry {
  uint32_t hash;
  int32_t unitig;
  int32_t pos;
  uint8_t strand;
};

}  // namespace

extern "C" {

int64_t ms_build_index(const uint8_t *ascii_blob, const int64_t *offsets,
                       int64_t n_seqs, const int32_t *ids, int32_t k,
                       int32_t w, int64_t max_occ, int32_t n_threads) {
  delete g_index_state;
  g_index_state = new IndexState();
  if (n_threads <= 0)
    n_threads = static_cast<int32_t>(std::thread::hardware_concurrency());
  constexpr int B = 256;
  const uint8_t *table = encode_table();

  // contiguous chunk per thread so bucket order == global order
  std::vector<std::array<std::vector<IndexEntry>, B>> tl(n_threads);
  std::vector<std::thread> threads;
  int64_t per = (n_seqs + n_threads - 1) / n_threads;
  auto sketch_worker = [&](int t) {
    auto &buckets = tl[t];
    std::vector<uint8_t> codes;
    std::vector<int32_t> mpos;
    std::vector<uint32_t> mhash;
    std::vector<uint8_t> mstrand;
    int64_t s = t * per, e = std::min<int64_t>(s + per, n_seqs);
    for (int64_t r = s; r < e; ++r) {
      int64_t len = offsets[r + 1] - offsets[r];
      codes.resize(std::max<int64_t>(len, 1));
      for (int64_t i = 0; i < len; ++i)
        codes[i] = table[ascii_blob[offsets[r] + i]];
      mpos.resize(std::max<int64_t>(len, 1));
      mhash.resize(std::max<int64_t>(len, 1));
      mstrand.resize(std::max<int64_t>(len, 1));
      int64_t cnt = ms_minimizers(codes.data(), len, k, w, mpos.data(),
                                  mhash.data(), mstrand.data());
      for (int64_t i = 0; i < cnt; ++i) {
        IndexEntry en{mhash[i], ids[r], mpos[i], mstrand[i]};
        buckets[en.hash >> 24].push_back(en);
      }
    }
  };
  for (int32_t t = 1; t < n_threads; ++t) threads.emplace_back(sketch_worker, t);
  sketch_worker(0);
  for (auto &th : threads) th.join();
  threads.clear();

  // per-bucket: merge thread chunks in order, stable-sort by hash,
  // CSR-group, apply the repeat mask
  std::array<IndexState, B> parts;
  std::atomic<int> next_b(0);
  auto bucket_worker = [&]() {
    std::vector<IndexEntry> all;
    for (;;) {
      int b = next_b.fetch_add(1);
      if (b >= B) break;
      size_t total = 0;
      for (auto &t : tl) total += t[b].size();
      if (!total) continue;
      all.clear();
      all.reserve(total);
      for (auto &t : tl)
        all.insert(all.end(), t[b].begin(), t[b].end());
      std::stable_sort(all.begin(), all.end(),
                       [](const IndexEntry &x, const IndexEntry &y) {
                         return x.hash < y.hash;
                       });
      auto &p = parts[b];
      for (size_t i = 0; i < all.size();) {
        size_t j = i + 1;
        while (j < all.size() && all[j].hash == all[i].hash) ++j;
        if (static_cast<int64_t>(j - i) <= max_occ) {
          p.uniq.push_back(all[i].hash);
          p.offsets.push_back(static_cast<int64_t>(j - i));  // group size
          for (size_t q = i; q < j; ++q) {
            p.unitig.push_back(all[q].unitig);
            p.pos.push_back(all[q].pos);
            p.strand.push_back(all[q].strand);
          }
        }
        i = j;
      }
    }
  };
  for (int32_t t = 1; t < n_threads; ++t) threads.emplace_back(bucket_worker);
  bucket_worker();
  for (auto &th : threads) th.join();

  auto &st = *g_index_state;
  st.offsets.push_back(0);
  for (int b = 0; b < B; ++b) {
    auto &p = parts[b];
    st.uniq.insert(st.uniq.end(), p.uniq.begin(), p.uniq.end());
    for (int64_t c : p.offsets) st.offsets.push_back(st.offsets.back() + c);
    st.unitig.insert(st.unitig.end(), p.unitig.begin(), p.unitig.end());
    st.pos.insert(st.pos.end(), p.pos.begin(), p.pos.end());
    st.strand.insert(st.strand.end(), p.strand.begin(), p.strand.end());
  }
  return static_cast<int64_t>(st.uniq.size());
}

int64_t ms_index_entries() {
  return g_index_state ? static_cast<int64_t>(g_index_state->unitig.size()) : 0;
}

void ms_index_copy(uint32_t *uniq, int64_t *offsets, int32_t *unitig,
                   int32_t *pos, uint8_t *strand) {
  if (!g_index_state) return;
  auto &st = *g_index_state;
  if (!st.uniq.empty())
    memcpy(uniq, st.uniq.data(), st.uniq.size() * sizeof(uint32_t));
  memcpy(offsets, st.offsets.data(), st.offsets.size() * sizeof(int64_t));
  if (!st.unitig.empty()) {
    memcpy(unitig, st.unitig.data(), st.unitig.size() * sizeof(int32_t));
    memcpy(pos, st.pos.data(), st.pos.size() * sizeof(int32_t));
    memcpy(strand, st.strand.data(), st.strand.size());
  }
}

void ms_index_free() {
  delete g_index_state;
  g_index_state = nullptr;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// one-pass 2-bit read packing for the device mapper
// (mirrors ops/mapping_jax.pack_codes(encode_2bit(seq)) byte-for-byte:
//  16 bases per uint32 packed word, 32 non-ACGT/pad mask bits per word;
//  padding beyond each read length decodes to code 4)

extern "C" {

// seqs: concatenated ASCII reads; offs: (n_reads+1) byte offsets.
// L % 32 == 0.  out_packed: (n_reads, L/16) u32; out_nmask:
// (n_reads, L/32) u32; out_lens: (n_reads,) i32.  Buffers need not be
// pre-zeroed.  Replaces ~6 numpy passes over the (R, L) uint8 batch
// with one read of the ASCII and one write of the packed words — the
// host-side batch build dominated the device pass on low-DRAM hosts
// (172 s of a 262 s E. coli mapping pass, measured round 3).
void ms_pack_reads_2bit(const uint8_t *seqs, const int64_t *offs,
                        int64_t n_reads, int64_t L, uint32_t *out_packed,
                        uint32_t *out_nmask, int32_t *out_lens) {
  const uint8_t *table = encode_table();
  const int64_t W = L / 16;   // packed words per read
  const int64_t M = L / 32;   // mask words per read
  for (int64_t r = 0; r < n_reads; ++r) {
    const uint8_t *s = seqs + offs[r];
    int64_t n = offs[r + 1] - offs[r];
    if (n > L) n = L;
    out_lens[r] = static_cast<int32_t>(n);
    uint32_t *pw = out_packed + r * W;
    uint32_t *mw = out_nmask + r * M;
    for (int64_t w = 0; w < W; ++w) {
      uint32_t packed = 0;
      uint32_t nbits = 0;
      const int64_t base0 = w * 16;
      const int64_t lim = (n - base0) < 16 ? (n - base0) : 16;
      for (int64_t j = 0; j < lim; ++j) {
        const uint8_t c = table[s[base0 + j]];
        packed |= static_cast<uint32_t>(c & 3) << (2 * j);
        nbits |= static_cast<uint32_t>(c >> 2) << j;  // c==4 -> bit
      }
      for (int64_t j = lim < 0 ? 0 : lim; j < 16; ++j)
        nbits |= 1u << j;  // pad positions decode to 4
      pw[w] = packed;
      if (w & 1)
        mw[w >> 1] |= nbits << 16;
      else
        mw[w >> 1] = nbits;
    }
  }
}

}  // extern "C"
