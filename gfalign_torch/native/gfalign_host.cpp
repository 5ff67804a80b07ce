// Native host runtime: columnar GAF + FASTQ parsing.
//
// TPU-native equivalent of the reference's gfalibs data-loading layer
// (batched multithreaded GAF load, reference src/alignments.cpp:143-235):
// the file is memory-loaded once, split at line boundaries into one chunk
// per hardware thread, parsed in parallel into columnar buffers, and merged
// in input order (deterministic, unlike the reference's thread-completion
// order append — SURVEY.md section 4 quirk 9a).
//
// Exposed C ABI (ctypes):
//   gaf_open(path)        -> handle (NULL on failure)
//   gaf_count(h)          -> number of records
//   gaf_numeric(h)        -> int64[count*10]: qlen qstart qend strand plen
//                            pstart pend matches blocklen mapq (row-major)
//   gaf_strings(h, which, &len) -> '\n'-joined blob: 0=qname 1=path 2=tagtail
//   gaf_close(h)
//   fq_open(path) / fq_count / fq_names / fq_seq_blob / fq_close
//
// Build: gfalign_torch/io/native.py compiles it with g++ at first use into
// build/gfalign_torch/native/ (or make -C gfalign_torch/native).

#ifdef __linux__
#include <sched.h>
#endif

#include <zlib.h>

#ifdef __AVX2__
#include <immintrin.h>
#endif

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <fstream>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct GafData {
  std::vector<int64_t> numeric;  // 10 per record
  std::string qnames;            // '\n'-joined
  std::string paths;
  std::string tagtails;          // raw text after column 12 ('' if none)
  int64_t count = 0;
  // tokenized paths (columnar): per-step dictionary ids + orientations,
  // with per-record offsets into the flat arrays
  std::vector<int32_t> step_ids;
  std::vector<int8_t> step_orients;  // 0='+' ('>'), 1='-' ('<')
  std::vector<int32_t> path_offsets; // count+1 entries
  std::string dict_names;            // '\n'-joined, index = dictionary id
  int32_t dict_size = 0;
};

// Tokenize every GAF path string ('>'/'<'-prefixed node names) into the
// columnar step arrays.  Single linear pass over the merged paths blob.
static void tokenize_paths(GafData* g) {
  std::unordered_map<std::string, int32_t> dict;
  g->path_offsets.push_back(0);
  const std::string& blob = g->paths;
  size_t pos = 0, n = blob.size();
  std::string name;
  while (pos < n) {
    size_t eol = pos;
    while (eol < n && blob[eol] != '\n') eol++;
    size_t i = pos;
    while (i < eol) {
      char c = blob[i];
      if (c == '>' || c == '<') {
        size_t j = i + 1;
        while (j < eol && blob[j] != '>' && blob[j] != '<') j++;
        name.assign(blob, i + 1, j - i - 1);
        auto it = dict.find(name);
        int32_t id;
        if (it == dict.end()) {
          id = g->dict_size++;
          dict.emplace(name, id);
          g->dict_names += name;
          g->dict_names.push_back('\n');
        } else {
          id = it->second;
        }
        g->step_ids.push_back(id);
        g->step_orients.push_back(c == '>' ? 0 : 1);
        i = j;
      } else {
        i++;  // malformed leading text: skip byte (mirrors reference walker)
      }
    }
    g->path_offsets.push_back(static_cast<int32_t>(g->step_ids.size()));
    pos = eol + 1;
  }
  // records whose path column was empty still need offsets: path_offsets
  // already has one entry per blob line == one per record
}

struct FqData {
  std::string names;
  std::string seqs;
  int64_t count = 0;
};

double host_mono_s() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + ts.tv_nsec * 1e-9;
}

// Transparent gzip support (gfalibs parity: StreamObj streams gz inputs,
// reference src/input-gfalign.cpp:42): gz files are inflated into the
// in-memory buffer via zlib, so the threaded chunk parsers see plain
// text either way and gz inputs keep the columnar fast path.
bool inflate_gz(const std::string& raw, std::string& out) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, 15 + 32) != Z_OK) return false;  // gzip + zlib
  out.clear();
  out.reserve(raw.size() * 4);
  zs.next_in = reinterpret_cast<Bytef*>(const_cast<char*>(raw.data()));
  zs.avail_in = static_cast<uInt>(raw.size());
  std::vector<char> chunk(1 << 20);
  int rc = Z_OK;
  do {
    zs.next_out = reinterpret_cast<Bytef*>(chunk.data());
    zs.avail_out = static_cast<uInt>(chunk.size());
    rc = inflate(&zs, Z_NO_FLUSH);
    if (rc != Z_OK && rc != Z_STREAM_END) {
      inflateEnd(&zs);
      return false;
    }
    out.append(chunk.data(), chunk.size() - zs.avail_out);
    if (rc == Z_STREAM_END && zs.avail_in > 0) {
      // concatenated gzip members (bgzip etc.): restart on the remainder
      if (inflateReset2(&zs, 15 + 32) != Z_OK) break;
      rc = Z_OK;
    }
  } while (rc != Z_STREAM_END && (zs.avail_in > 0 || zs.avail_out == 0));
  inflateEnd(&zs);
  return rc == Z_STREAM_END;
}

bool read_file(const char* path, std::string& out) {
  std::ifstream in(path, std::ios::binary | std::ios::ate);
  if (!in) return false;
  std::streamsize size = in.tellg();
  in.seekg(0);
  out.resize(static_cast<size_t>(size));
  if (size != 0 && !in.read(&out[0], size)) return false;
  if (out.size() >= 2 && static_cast<unsigned char>(out[0]) == 0x1f &&
      static_cast<unsigned char>(out[1]) == 0x8b) {
    std::string plain;
    if (!inflate_gz(out, plain)) return false;
    out.swap(plain);
  }
  return true;
}

// Parse [begin, end) of the buffer (whole lines) into one chunk, then
// tokenize the chunk's paths (runs inside the chunk's own thread; the
// merge step remaps local dictionary ids to global first-mention order).
void parse_gaf_chunk(const char* buf, size_t begin, size_t end, GafData* out) {
  size_t pos = begin;
  while (pos < end) {
    size_t eol = pos;
    while (eol < end && buf[eol] != '\n') eol++;
    size_t len = eol - pos;
    if (len > 0 && buf[pos + len - 1] == '\r') len--;
    if (len > 0) {
      // split first 12 tab-separated columns; keep the rest as the tag tail
      const char* p = buf + pos;
      size_t cols[13];  // start offset of each column (within line)
      int ncols = 1;
      cols[0] = 0;
      for (size_t i = 0; i < len && ncols < 13; i++) {
        if (p[i] == '\t') cols[ncols++] = i + 1;
      }
      if (ncols >= 12) {
        auto col_str = [&](int c) -> std::pair<const char*, size_t> {
          size_t s = cols[c];
          size_t e = (c + 1 < ncols) ? cols[c + 1] - 1 : len;
          return {p + s, e - s};
        };
        auto col_int = [&](int c) -> int64_t {
          auto [s, n] = col_str(c);
          int64_t v = 0;
          bool neg = n > 0 && s[0] == '-';
          for (size_t i = neg ? 1 : 0; i < n; i++) {
            if (s[i] < '0' || s[i] > '9') break;
            v = v * 10 + (s[i] - '0');
          }
          return neg ? -v : v;
        };
        auto [qn, qn_len] = col_str(0);
        auto [pa, pa_len] = col_str(5);
        auto [st, st_len] = col_str(4);
        out->qnames.append(qn, qn_len);
        out->qnames.push_back('\n');
        out->paths.append(pa, pa_len);
        out->paths.push_back('\n');
        if (ncols == 13) {
          size_t s = cols[12];
          out->tagtails.append(p + s, len - s);
        }
        out->tagtails.push_back('\n');
        out->numeric.push_back(col_int(1));                      // qlen
        out->numeric.push_back(col_int(2));                      // qstart
        out->numeric.push_back(col_int(3));                      // qend
        out->numeric.push_back(st_len > 0 && st[0] == '-' ? 1 : 0);  // strand
        out->numeric.push_back(col_int(6));                      // plen
        out->numeric.push_back(col_int(7));                      // pstart
        out->numeric.push_back(col_int(8));                      // pend
        out->numeric.push_back(col_int(9));                      // matches
        out->numeric.push_back(col_int(10));                     // blocklen
        out->numeric.push_back(col_int(11));                     // mapq
        out->count++;
      }
    }
    pos = eol + 1;
  }
  tokenize_paths(out);
}

// user-requested worker cap (reference -j/--threads -> threadPool.init,
// src/main.cpp:658); 0 = use hardware_concurrency
static int g_max_threads = 0;

// ------------------------------------------------------------------- GFA
//
// Columnar GFA fast path (role of gfalibs' threaded readGFA, reference
// src/input-gfalign.cpp:43-45): chunks parse S/L/E lines into columnar
// buffers with LOCAL name dictionaries; the merge walks chunks in file
// order re-assigning global uIds, which reproduces the Python parser's
// first-mention-in-any-record assignment exactly (chunk ranges are
// disjoint and ordered).  Rare records (H/J/G/P/O) pass through as raw
// lines for the Python layer, but their NAME MENTIONS are tokenized here
// so the uId order still matches (O groups are resolved after the full
// parse in both implementations, so their mentions deliberately aren't).

struct GfaChunk {
  std::vector<std::string> mention_order;  // local ids, first-mention order
  std::unordered_map<std::string, int32_t> dict;
  std::vector<int32_t> seg_uids;           // local
  std::vector<int64_t> seg_lens;           // explicit GFA2 length, -1 none
  std::string seg_seqs;                    // '\n'-joined ('*' literal)
  std::string seg_tags;                    // '\n'-joined raw tag tails
  std::vector<int32_t> link_ids;           // 2 per link, local
  std::vector<int8_t> link_orients;        // 2 per link, 0='+'
  std::string link_overlaps;               // '\n'-joined
  std::string link_tags;
  std::string other_lines;                 // raw H/J/G/P/O lines, in order
};

struct GfaData {
  std::vector<int32_t> seg_uids;
  std::vector<int64_t> seg_lens;
  std::string seg_seqs, seg_tags;
  std::vector<int32_t> link_ids;
  std::vector<int8_t> link_orients;
  std::string link_overlaps, link_tags;
  std::string other_lines;
  std::string dict_names;  // '\n'-joined, index = global uId
  int64_t dict_size = 0;
  int64_t seg_count = 0, link_count = 0;
};

static int32_t gfa_uid(GfaChunk* c, const char* s, size_t n) {
  std::string name(s, n);
  auto it = c->dict.find(name);
  if (it != c->dict.end()) return it->second;
  int32_t id = static_cast<int32_t>(c->mention_order.size());
  c->dict.emplace(name, id);
  c->mention_order.push_back(std::move(name));
  return id;
}

void parse_gfa_chunk(const char* buf, size_t begin, size_t end, bool is_gfa2,
                     GfaChunk* out) {
  size_t pos = begin;
  // sequence bytes dominate; reserving the chunk span avoids the
  // doubling-growth copies (first-touch pages cost ~0.65 s / 100 MB on
  // this VM, so every avoidable copy matters)
  out->seg_seqs.reserve(end - begin);
  std::vector<std::pair<size_t, size_t>> cols;  // (start, len) per column
  while (pos < end) {
    size_t eol = pos;
    while (eol < end && buf[eol] != '\n') eol++;
    size_t len = eol - pos;
    if (len > 0 && buf[pos + len - 1] == '\r') len--;
    const char* p = buf + pos;
    if (len == 0 || p[0] == '#') {
      pos = eol + 1;
      continue;
    }
    cols.clear();
    size_t cstart = 0;
    for (size_t i = 0; i <= len; i++) {
      if (i == len || p[i] == '\t') {
        cols.emplace_back(cstart, i - cstart);
        cstart = i + 1;
      }
    }
    auto cs = [&](size_t c) { return p + cols[c].first; };
    auto cl = [&](size_t c) { return cols[c].second; };
    char t = p[0];
    if (t == 'S' && cols.size() >= 3) {
      bool digits2 = cols.size() >= 4 && cl(2) > 0;
      for (size_t i = 0; digits2 && i < cl(2); i++)
        if (cs(2)[i] < '0' || cs(2)[i] > '9') digits2 = false;
      bool gfa2 = is_gfa2 || digits2;
      out->seg_uids.push_back(gfa_uid(out, cs(1), cl(1)));
      size_t seq_col = gfa2 ? 3 : 2;
      size_t tag_col = gfa2 ? 4 : 3;
      out->seg_seqs.append(cs(seq_col), cl(seq_col));
      out->seg_seqs.push_back('\n');
      if (cols.size() > tag_col) {
        size_t s = cols[tag_col].first;
        out->seg_tags.append(p + s, len - s);
      }
      out->seg_tags.push_back('\n');
      int64_t elen = -1;
      if (gfa2) {
        elen = 0;
        for (size_t i = 0; i < cl(2); i++) elen = elen * 10 + (cs(2)[i] - '0');
      }
      out->seg_lens.push_back(elen);
    } else if ((t == 'L' || t == 'E') && cols.size() >= 5) {
      out->link_ids.push_back(gfa_uid(out, cs(1), cl(1)));
      out->link_ids.push_back(gfa_uid(out, cs(3), cl(3)));
      out->link_orients.push_back(cl(2) > 0 && cs(2)[0] == '-' ? 1 : 0);
      out->link_orients.push_back(cl(4) > 0 && cs(4)[0] == '-' ? 1 : 0);
      if (cols.size() > 5) {
        out->link_overlaps.append(cs(5), cl(5));
      } else {
        out->link_overlaps.push_back('*');
      }
      out->link_overlaps.push_back('\n');
      if (cols.size() > 6) {
        size_t s = cols[6].first;
        out->link_tags.append(p + s, len - s);
      }
      out->link_tags.push_back('\n');
    } else {
      // mention tokenization keeps global uId assignment exact
      if (t == 'J' && cols.size() >= 4) {
        gfa_uid(out, cs(1), cl(1));
        gfa_uid(out, cs(3), cl(3));
      } else if (t == 'G' && cols.size() >= 4) {
        if (cl(2) > 1) gfa_uid(out, cs(2), cl(2) - 1);
        if (cl(3) > 1) gfa_uid(out, cs(3), cl(3) - 1);
      } else if (t == 'P' && cols.size() >= 3) {
        const char* q = cs(2);
        size_t qn = cl(2), i = 0;
        while (i < qn) {
          size_t j = i;
          while (j < qn && q[j] != ',' && q[j] != ';') j++;
          if (j > i + 1) gfa_uid(out, q + i, j - i - 1);  // strip +/- suffix
          i = j + 1;
        }
      }
      out->other_lines.append(p, len);
      out->other_lines.push_back('\n');
    }
    pos = eol + 1;
  }
}

}  // namespace

extern "C" {

void gfalign_set_threads(int n) { g_max_threads = n; }

GafData* gaf_open(const char* path) {
  const bool diag = getenv("GFALIGN_NATIVE_DIAG") != nullptr;
  double t0 = diag ? host_mono_s() : 0.0;
  std::string buf;
  if (!read_file(path, buf)) return nullptr;
  if (diag) {
    fprintf(stderr, "gaf_open read_file %.2fs\n", host_mono_s() - t0);
    t0 = host_mono_s();
  }
  size_t n = buf.size();
  unsigned hw = g_max_threads > 0 ? (unsigned)g_max_threads
                                  : std::thread::hardware_concurrency();
  size_t n_chunks = hw ? hw : 4;
  if (n < (1u << 20)) n_chunks = 1;  // small files: skip thread overhead
  std::vector<size_t> bounds;
  bounds.push_back(0);
  for (size_t c = 1; c < n_chunks; c++) {
    size_t b = n * c / n_chunks;
    while (b < n && buf[b] != '\n') b++;
    if (b < n) b++;
    bounds.push_back(b);
  }
  bounds.push_back(n);
  std::vector<GafData> chunks(bounds.size() - 1);
  std::vector<std::thread> threads;
  for (size_t c = 0; c + 1 < bounds.size(); c++) {
    threads.emplace_back(parse_gaf_chunk, buf.data(), bounds[c], bounds[c + 1],
                         &chunks[c]);
  }
  for (auto& t : threads) t.join();
  buf.clear();
  buf.shrink_to_fit();  // drop the 1 GB raw buffer before merging
  if (diag) {
    fprintf(stderr, "gaf_open parse %.2fs\n", host_mono_s() - t0);
    t0 = host_mono_s();
  }
  // merge preserves input order.  Sizes are known, so reserve up front —
  // repeated unreserved string += cost ~10 s at the 1 GB scale — and the
  // per-chunk tokenization (done inside the parse threads) merges via a
  // local-id -> global-id remap that preserves the sequential parser's
  // first-mention dictionary order.
  GafData* out = new GafData();
  size_t t_num = 0, t_q = 0, t_p = 0, t_t = 0, t_steps = 0;
  for (auto& ch : chunks) {
    t_num += ch.numeric.size();
    t_q += ch.qnames.size();
    t_p += ch.paths.size();
    t_t += ch.tagtails.size();
    t_steps += ch.step_ids.size();
  }
  std::unordered_map<std::string, int32_t> gdict;
  std::vector<int32_t> lut;
  out->path_offsets.push_back(0);
  bool first_chunk = true;
  for (auto& ch : chunks) {
    if (first_chunk) {
      // adopt chunk 0 wholesale (its local dictionary IS the global
      // prefix) instead of copying ~1 GB of strings
      out->numeric = std::move(ch.numeric);
      out->qnames = std::move(ch.qnames);
      out->paths = std::move(ch.paths);
      out->tagtails = std::move(ch.tagtails);
      out->count = ch.count;
      out->step_ids = std::move(ch.step_ids);
      out->step_orients = std::move(ch.step_orients);
      out->path_offsets = std::move(ch.path_offsets);
      out->dict_names = std::move(ch.dict_names);
      out->dict_size = ch.dict_size;
      size_t pos = 0;
      int32_t local = 0;
      while (pos < out->dict_names.size()) {
        size_t eol = out->dict_names.find('\n', pos);
        gdict.emplace(out->dict_names.substr(pos, eol - pos), local++);
        pos = eol + 1;
      }
      out->numeric.reserve(t_num);
      out->qnames.reserve(t_q);
      out->paths.reserve(t_p);
      out->tagtails.reserve(t_t);
      out->step_ids.reserve(t_steps);
      out->step_orients.reserve(t_steps);
      first_chunk = false;
      continue;
    }
    out->numeric.insert(out->numeric.end(), ch.numeric.begin(), ch.numeric.end());
    out->qnames += ch.qnames;
    out->paths += ch.paths;
    out->tagtails += ch.tagtails;
    out->count += ch.count;
    // local -> global dictionary ids (first mention in input order)
    lut.assign(static_cast<size_t>(ch.dict_size), 0);
    size_t pos = 0;
    int32_t local = 0;
    while (pos < ch.dict_names.size()) {
      size_t eol = ch.dict_names.find('\n', pos);
      std::string name = ch.dict_names.substr(pos, eol - pos);
      auto it = gdict.find(name);
      int32_t gid;
      if (it == gdict.end()) {
        gid = out->dict_size++;
        gdict.emplace(std::move(name), gid);
        out->dict_names.append(ch.dict_names, pos, eol - pos);
        out->dict_names.push_back('\n');
      } else {
        gid = it->second;
      }
      lut[local++] = gid;
      pos = eol + 1;
    }
    const int32_t base = static_cast<int32_t>(out->step_ids.size());
    for (int32_t id : ch.step_ids) out->step_ids.push_back(lut[id]);
    out->step_orients.insert(out->step_orients.end(), ch.step_orients.begin(),
                             ch.step_orients.end());
    for (size_t k = 1; k < ch.path_offsets.size(); k++)
      out->path_offsets.push_back(base + ch.path_offsets[k]);
  }
  if (diag)
    fprintf(stderr, "gaf_open merge+tokmerge %.2fs\n", host_mono_s() - t0);
  return out;
}

int64_t gaf_count(GafData* h) { return h->count; }
const int64_t* gaf_numeric(GafData* h) { return h->numeric.data(); }

const char* gaf_strings(GafData* h, int which, int64_t* len) {
  const std::string* s =
      which == 0 ? &h->qnames : which == 1 ? &h->paths : &h->tagtails;
  *len = static_cast<int64_t>(s->size());
  return s->data();
}

void gaf_close(GafData* h) { delete h; }

int64_t gaf_step_count(GafData* h) {
  return static_cast<int64_t>(h->step_ids.size());
}
const int32_t* gaf_step_ids(GafData* h) { return h->step_ids.data(); }
const int8_t* gaf_step_orients(GafData* h) { return h->step_orients.data(); }
const int32_t* gaf_path_offsets(GafData* h) { return h->path_offsets.data(); }
const char* gaf_dict_names(GafData* h, int64_t* len) {
  *len = static_cast<int64_t>(h->dict_names.size());
  return h->dict_names.data();
}

// -------------------------------------------------------------------- GFA

GfaData* gfa_open(const char* path) {
  std::string buf;
  if (!read_file(path, buf)) return nullptr;
  size_t n = buf.size();
  // pre-scan H lines for VN:Z:2 (GFA2 forces the 4-column S layout even
  // when the digit heuristic would not fire)
  bool is_gfa2 = false;
  for (size_t pos = 0; pos < n;) {
    size_t eol = pos;
    while (eol < n && buf[eol] != '\n') eol++;
    if (eol > pos && buf[pos] == 'H') {
      size_t i = pos;
      while (i + 5 < eol) {
        if (buf[i] == '\t' && buf[i + 1] == 'V' && buf[i + 2] == 'N' &&
            buf[i + 3] == ':') {
          size_t c = i + 4;
          while (c < eol && buf[c] != ':') c++;
          if (c + 1 < eol && buf[c + 1] == '2') is_gfa2 = true;
        }
        i++;
      }
    }
    pos = eol + 1;
  }
  unsigned hw = g_max_threads > 0 ? (unsigned)g_max_threads
                                  : std::thread::hardware_concurrency();
  size_t n_chunks = hw ? hw : 4;
  if (n < (1u << 20)) n_chunks = 1;
  std::vector<size_t> bounds;
  bounds.push_back(0);
  for (size_t c = 1; c < n_chunks; c++) {
    size_t b = n * c / n_chunks;
    while (b < n && buf[b] != '\n') b++;
    if (b < n) b++;
    bounds.push_back(b);
  }
  bounds.push_back(n);
  std::vector<GfaChunk> chunks(bounds.size() - 1);
  std::vector<std::thread> threads;
  for (size_t c = 0; c + 1 < bounds.size(); c++) {
    threads.emplace_back(parse_gfa_chunk, buf.data(), bounds[c],
                         bounds[c + 1], is_gfa2, &chunks[c]);
  }
  for (auto& t : threads) t.join();
  // merge: walking chunk-local first mentions in chunk order reproduces
  // the sequential parser's global first-mention uId order exactly
  GfaData* out = new GfaData();
  {
    size_t seqs = 0, segs = 0, links = 0, other = 0;
    for (auto& ch : chunks) {
      seqs += ch.seg_seqs.size();
      segs += ch.seg_uids.size();
      links += ch.link_ids.size();
      other += ch.other_lines.size();
    }
    out->seg_seqs.reserve(seqs);
    out->seg_uids.reserve(segs);
    out->seg_lens.reserve(segs);
    out->link_ids.reserve(links);
    out->link_orients.reserve(links);
    out->other_lines.reserve(other);
  }
  std::unordered_map<std::string, int32_t> dict;
  for (auto& ch : chunks) {
    std::vector<int32_t> remap(ch.mention_order.size());
    for (size_t i = 0; i < ch.mention_order.size(); i++) {
      auto& name = ch.mention_order[i];
      auto it = dict.find(name);
      int32_t gid;
      if (it == dict.end()) {
        gid = static_cast<int32_t>(out->dict_size++);
        dict.emplace(name, gid);
        out->dict_names += name;
        out->dict_names.push_back('\n');
      } else {
        gid = it->second;
      }
      remap[i] = gid;
    }
    for (int32_t v : ch.seg_uids) out->seg_uids.push_back(remap[v]);
    for (int32_t v : ch.link_ids) out->link_ids.push_back(remap[v]);
    out->seg_lens.insert(out->seg_lens.end(), ch.seg_lens.begin(),
                         ch.seg_lens.end());
    out->link_orients.insert(out->link_orients.end(),
                             ch.link_orients.begin(), ch.link_orients.end());
    out->seg_seqs += ch.seg_seqs;
    out->seg_tags += ch.seg_tags;
    out->link_overlaps += ch.link_overlaps;
    out->link_tags += ch.link_tags;
    out->other_lines += ch.other_lines;
  }
  out->seg_count = static_cast<int64_t>(out->seg_uids.size());
  out->link_count = static_cast<int64_t>(out->link_ids.size() / 2);
  return out;
}

int64_t gfa_seg_count(GfaData* h) { return h->seg_count; }
int64_t gfa_link_count(GfaData* h) { return h->link_count; }
int64_t gfa_dict_size(GfaData* h) { return h->dict_size; }
const int32_t* gfa_seg_uids(GfaData* h) { return h->seg_uids.data(); }
const int64_t* gfa_seg_lens(GfaData* h) { return h->seg_lens.data(); }
const int32_t* gfa_link_ids(GfaData* h) { return h->link_ids.data(); }
const int8_t* gfa_link_orients(GfaData* h) { return h->link_orients.data(); }
const char* gfa_blob(GfaData* h, int which, int64_t* len) {
  const std::string* s = which == 0   ? &h->seg_seqs
                         : which == 1 ? &h->seg_tags
                         : which == 2 ? &h->link_overlaps
                         : which == 3 ? &h->link_tags
                         : which == 4 ? &h->other_lines
                                      : &h->dict_names;
  *len = static_cast<int64_t>(s->size());
  return s->data();
}
void gfa_close(GfaData* h) { delete h; }

// ---------------------------------------------------------------- FASTQ/A

FqData* fq_open(const char* path) {
  std::string buf;
  if (!read_file(path, buf)) return nullptr;
  FqData* out = new FqData();
  size_t n = buf.size(), pos = 0;
  bool fasta = n > 0 && buf[0] == '>';
  std::string pending;
  bool in_fasta_seq = false;
  while (pos < n) {
    size_t eol = pos;
    while (eol < n && buf[eol] != '\n') eol++;
    size_t len = eol - pos;
    if (len > 0 && buf[pos + len - 1] == '\r') len--;
    if (len > 0) {
      const char* p = buf.data() + pos;
      if (!fasta && p[0] == '@') {
        out->names.append(p + 1, len - 1);
        out->names.push_back('\n');
        // sequence line
        pos = eol + 1;
        eol = pos;
        while (eol < n && buf[eol] != '\n') eol++;
        len = eol - pos;
        if (len > 0 && buf[pos + len - 1] == '\r') len--;
        out->seqs.append(buf.data() + pos, len);
        out->seqs.push_back('\n');
        out->count++;
        // skip '+' line and quality line
        for (int skip = 0; skip < 2; skip++) {
          pos = eol + 1;
          eol = pos;
          while (eol < n && buf[eol] != '\n') eol++;
        }
      } else if (fasta && p[0] == '>') {
        if (in_fasta_seq) {
          out->seqs.push_back('\n');
        }
        out->names.append(p + 1, len - 1);
        out->names.push_back('\n');
        out->count++;
        in_fasta_seq = true;
      } else if (fasta && in_fasta_seq) {
        out->seqs.append(p, len);
      }
    }
    pos = eol + 1;
  }
  if (fasta && in_fasta_seq) out->seqs.push_back('\n');
  return out;
}

int64_t fq_count(FqData* h) { return h->count; }

const char* fq_names(FqData* h, int64_t* len) {
  *len = static_cast<int64_t>(h->names.size());
  return h->names.data();
}

const char* fq_seq_blob(FqData* h, int64_t* len) {
  *len = static_cast<int64_t>(h->seqs.size());
  return h->seqs.data();
}

void fq_close(FqData* h) { delete h; }

// ------------------------------------------------- local-alignment traceback
// Exact port of the Python oracle ops/seqalign.py traceback/_matrix (the
// align-mode host traceback of a device-selected placement; reference
// counterpart is the base-level DP GraphAligner performs for gfalign's
// align mode, src/main.cpp:167-169).  Semantics reproduced bit-for-bit:
//   * matrix substitution: PAD on either side -> `block` (never extend);
//     otherwise match (+1) only when both codes < 4 and equal, else mismatch;
//   * H[i][j] = max(c, H[i][j-1] + gap) with c = max(0, diag + sub, up + gap)
//     (the floor applies before the horizontal chain, exactly like the
//     cummax formulation);
//   * the WALK's move test recomputes sub as match iff read==path && read<4
//     (no PAD special case — the oracle's deliberate asymmetry);
//   * move priority: diagonal, then up (I), then left (D), else stop
//     (mid-row local start).
// Only rows 0..end_i x cols 0..end_j are computed (the walk never leaves
// that rectangle and the recurrence has no right-to-left dependency).
// out5 = {score, qstart, pstart, matches, nm}; ops written forward-order
// ('=', 'X', 'I', 'D'); returns n_ops, or -1 if ops_cap is too small.
int64_t seq_local_traceback(const int8_t* read, int64_t lr, const int8_t* path,
                            int64_t lp, int64_t end_i, int64_t end_j,
                            int32_t match, int32_t mismatch, int32_t gap,
                            int32_t pad_code, int32_t block, int32_t* out5,
                            char* ops, int64_t ops_cap) {
  if (end_i < 0 || end_j < 0 || end_i > lr || end_j > lp) return -1;
  const int64_t W = end_j + 1;
  std::vector<int32_t> H(static_cast<size_t>(end_i + 1) * W, 0);
  for (int64_t i = 1; i <= end_i; i++) {
    const int32_t rc = read[i - 1];
    const int32_t* prev = H.data() + (i - 1) * W;
    int32_t* cur = H.data() + i * W;
    cur[0] = 0;
    for (int64_t j = 1; j <= end_j; j++) {
      const int32_t pc = path[j - 1];
      const int32_t sub = (rc == pad_code || pc == pad_code)
                              ? block
                              : ((rc < 4 && pc < 4 && rc == pc) ? match
                                                                : mismatch);
      int32_t c = prev[j - 1] + sub;
      const int32_t up = prev[j] + gap;
      if (up > c) c = up;
      if (c < 0) c = 0;
      const int32_t left = cur[j - 1] + gap;
      cur[j] = left > c ? left : c;
    }
  }
  int64_t i = end_i, j = end_j;
  out5[0] = H[i * W + j];  // score
  int64_t n_ops = 0;
  int32_t matches = 0, nm = 0;
  // collect moves end->start, reverse at the end
  while (i > 0 && j > 0 && H[i * W + j] > 0) {
    const int32_t rc = read[i - 1];
    const int32_t sub = (rc == path[j - 1] && rc < 4) ? match : mismatch;
    const int32_t h = H[i * W + j];
    char op;
    if (h == H[(i - 1) * W + (j - 1)] + sub) {
      op = sub == match ? '=' : 'X';
      if (sub == match) matches++; else nm++;
      i--; j--;
    } else if (h == H[(i - 1) * W + j] + gap) {
      op = 'I'; nm++; i--;
    } else if (h == H[i * W + (j - 1)] + gap) {
      op = 'D'; nm++; j--;
    } else {
      break;  // local start (c floored at 0 mid-row)
    }
    if (n_ops >= ops_cap) return -1;
    ops[n_ops++] = op;
  }
  for (int64_t a = 0, b = n_ops - 1; a < b; a++, b--) {
    char t = ops[a]; ops[a] = ops[b]; ops[b] = t;
  }
  out5[1] = static_cast<int32_t>(i);  // qstart
  out5[2] = static_cast<int32_t>(j);  // pstart
  out5[3] = matches;
  out5[4] = nm;
  return n_ops;
}

// Path-space Needleman-Wunsch with the reference's traceback-recomputed
// score (src/alignments.cpp:499-554 semantics, as transcribed in
// ops/nw_path.nw_align_oracle): row-0 extent runs over n (not m), vertical
// moves are free in the read's last column, and the returned score is the
// one the WALK recomputes (match adds s; 'U' subtracts 1 only once a read
// step has been consumed; 'L' always subtracts 1).  Emits the move ops
// ('M' diagonal, 'U' a-step/b-gap, 'L' b-step/a-gap) start->end so the
// caller can rebuild the printed alignment row without a Python DP.
// Returns n_ops, or -1 on bad input / cap overflow.
int64_t nw_path_traceback(const int64_t* a_keys, int64_t n,
                          const int64_t* b_keys, int64_t m,
                          int32_t match, int32_t mismatch, int32_t gap,
                          int64_t* out_score, char* ops, int64_t ops_cap) {
  if (n < 0 || m < 0) return -1;
  const int64_t W = (n > m ? n : m) + 1;
  std::vector<int64_t> dp(static_cast<size_t>(n + 1) * W, 0);
  for (int64_t j = 0; j <= n; j++) dp[j] = j * gap;  // row-0 extent quirk
  for (int64_t i = 1; i <= n; i++) {
    const int64_t ak = a_keys[i - 1];
    const int64_t* prev = dp.data() + (i - 1) * W;
    int64_t* cur = dp.data() + i * W;
    for (int64_t j = 1; j <= m; j++) {
      const int64_t s = (ak == b_keys[j - 1]) ? match : mismatch;
      int64_t v = prev[j - 1] + s;
      const int64_t up = prev[j] + (j < m ? gap : 0);
      if (up > v) v = up;
      const int64_t left = cur[j - 1] + gap;
      if (left > v) v = left;
      cur[j] = v;
    }
  }
  // walk-recomputed score, exactly the oracle's: border moves (ii==0 or
  // jj==0) are FREE; interior 'U' costs 1 only once a read step has been
  // consumed (sblen > 0); interior 'L' always costs 1 (the oracle
  // hardcodes -1 regardless of the gap parameter)
  int64_t ii = n, jj = m, score = 0, sblen = 0, n_ops = 0;
  while (ii != 0 || jj != 0) {
    char op;
    if (ii == 0) {
      op = 'L'; jj--;
    } else if (jj == 0) {
      op = 'U'; ii--;
    } else {
      const int64_t s = (a_keys[ii - 1] == b_keys[jj - 1]) ? match : mismatch;
      if (dp[ii * W + jj] == dp[(ii - 1) * W + (jj - 1)] + s) {
        op = 'M'; score += s; sblen++; ii--; jj--;
      } else if (dp[(ii - 1) * W + jj] >= dp[ii * W + (jj - 1)]) {
        op = 'U'; ii--;
        if (sblen > 0) score -= 1;
      } else {
        op = 'L'; score -= 1; sblen++; jj--;
      }
    }
    if (n_ops >= ops_cap) return -1;
    ops[n_ops++] = op;
  }
  for (int64_t a = 0, b = n_ops - 1; a < b; a++, b--) {
    char t = ops[a]; ops[a] = ops[b]; ops[b] = t;
  }
  *out_score = score;
  return n_ops;
}

// Walk-recomputed path-space NW score for one (candidate, read) pair —
// the score half of nw_path_traceback below (identical DP + walk
// decisions, no op emission).  int32 is exact: |score| <= n + m.
static int32_t nw_walk_score(const int32_t* a, int64_t n, const int32_t* b,
                             int64_t m, int32_t match, int32_t mismatch,
                             int32_t gap, std::vector<int32_t>& dp_scratch) {
  const int64_t W = (n > m ? n : m) + 1;
  dp_scratch.assign(static_cast<size_t>(n + 1) * W, 0);
  int32_t* dp = dp_scratch.data();
  for (int64_t j = 0; j <= n; j++)  // row-0 extent runs over n (quirk)
    dp[j] = static_cast<int32_t>(j) * gap;
  for (int64_t i = 1; i <= n; i++) {
    const int32_t ak = a[i - 1];
    const int32_t* prev = dp + (i - 1) * W;
    int32_t* cur = dp + i * W;
    for (int64_t j = 1; j <= m; j++) {
      const int32_t s = (ak == b[j - 1]) ? match : mismatch;
      int32_t v = prev[j - 1] + s;
      const int32_t up = prev[j] + (j < m ? gap : 0);
      if (up > v) v = up;
      const int32_t left = cur[j - 1] + gap;
      if (left > v) v = left;
      cur[j] = v;
    }
  }
  int64_t ii = n, jj = m, sblen = 0;
  int32_t score = 0;
  while (ii != 0 || jj != 0) {
    if (ii == 0) {
      jj--;  // border moves are free
    } else if (jj == 0) {
      ii--;
    } else {
      const int32_t s = (a[ii - 1] == b[jj - 1]) ? match : mismatch;
      if (dp[ii * W + jj] == dp[(ii - 1) * W + (jj - 1)] + s) {
        score += s; sblen++; ii--; jj--;
      } else if (dp[(ii - 1) * W + jj] >= dp[ii * W + (jj - 1)]) {
        ii--;
        if (sblen > 0) score -= 1;
      } else {
        score -= 1; sblen++; jj--;
      }
    }
  }
  return score;
}

#ifdef __AVX2__
// int16 AVX2 variant of nw_walk_score: |dp| <= max(n,m)*max(|match|,
// |mismatch|,|gap|); the prefix stages shift in -16384, which must sit
// strictly below every reachable dp value, so the caller guards
// max(n,m)*score_mag < 16000 AND m_pad <= the key-row stride (the
// vector key loads read up to 15 lanes past m).  The
// row fill vectorizes 16 j-lanes at a time: key equality is computed in
// two int32 compares packed to int16 (step keys exceed int16), the
// free-trailing-column quirk ((j < m ? gap : 0) on the 'up' move) is a
// precomputed per-j int16 vector, and the horizontal cur[j-1]+gap
// dependency is the same in-register max-plus prefix as the banded
// ladder.  Row-0 extent (j*gap only up to j <= n — the reference's
// quirk) and the traceback-recomputed score walk are identical to the
// scalar version.
static int32_t nw_walk_score16(const int32_t* a, int64_t n, const int32_t* b,
                               int64_t m, int32_t match, int32_t mismatch,
                               int32_t gap,
                               std::vector<int16_t>& dp_scratch,
                               std::vector<int16_t>& upgap_scratch) {
  const int64_t W = (n > m ? n : m) + 1;
  const int64_t m_pad = ((m + 15) / 16) * 16;
  // + 16 slack per row start so unaligned block loads stay in range
  dp_scratch.assign(static_cast<size_t>(n + 1) * (W + 16), 0);
  int16_t* dp = dp_scratch.data();
  const int64_t Wz = W + 16;
  for (int64_t j = 0; j <= n; j++)  // row-0 extent runs over n (quirk)
    dp[j] = static_cast<int16_t>(j * gap);
  upgap_scratch.assign(static_cast<size_t>(m_pad), 0);
  for (int64_t j = 1; j <= m; j++)
    upgap_scratch[j - 1] = static_cast<int16_t>(j < m ? gap : 0);
  const __m256i vgap = _mm256_set1_epi16(static_cast<int16_t>(gap));
  const __m256i vramp = _mm256_mullo_epi16(
      _mm256_setr_epi16(1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
                        16),
      vgap);
  const __m256i vmatch16 = _mm256_set1_epi16(static_cast<int16_t>(match));
  const __m256i vmis16 = _mm256_set1_epi16(static_cast<int16_t>(mismatch));
  for (int64_t i = 1; i <= n; i++) {
    const __m256i vak = _mm256_set1_epi32(a[i - 1]);
    const int16_t* prev = dp + (i - 1) * Wz;
    int16_t* cur = dp + i * Wz;
    cur[0] = 0;
    int32_t carry = 0;  // cur[j0 - 1]
    for (int64_t j0 = 1; j0 <= m; j0 += 16) {
      // key equality in int32, packed to a 16-lane int16 mask
      const __m256i k0 = _mm256_loadu_si256(
          reinterpret_cast<const __m256i*>(b + (j0 - 1)));
      const __m256i k1 = _mm256_loadu_si256(
          reinterpret_cast<const __m256i*>(b + (j0 - 1) + 8));
      const __m256i eq = _mm256_permute4x64_epi64(
          _mm256_packs_epi32(_mm256_cmpeq_epi32(k0, vak),
                             _mm256_cmpeq_epi32(k1, vak)),
          0xD8);
      const __m256i s = _mm256_blendv_epi8(vmis16, vmatch16, eq);
      const __m256i pd = _mm256_loadu_si256(
          reinterpret_cast<const __m256i*>(prev + (j0 - 1)));
      const __m256i pu = _mm256_loadu_si256(
          reinterpret_cast<const __m256i*>(prev + j0));
      const __m256i ug = _mm256_loadu_si256(
          reinterpret_cast<const __m256i*>(upgap_scratch.data() + (j0 - 1)));
      __m256i c = _mm256_max_epi16(_mm256_add_epi16(pd, s),
                                   _mm256_add_epi16(pu, ug));
      // in-register max-plus prefix over cur[j-1] + gap; shifted-in
      // zeros can NOT be ignored here (dp may exceed 0), so shift in
      // -32768/2 instead via a saturating trick: shift in the carry
      // lane from the left explicitly at every stage using alignr with
      // a MIN-filled low half.
      const __m256i vmin = _mm256_set1_epi16(-16384);
      __m256i lo = _mm256_permute2x128_si256(c, vmin, 0x03);
      // lo = [vmin_high, c_low]: alignr picks the tail of vmin (=-16384)
      __m256i t = _mm256_alignr_epi8(c, lo, 14);
      c = _mm256_max_epi16(c, _mm256_add_epi16(t, vgap));
      lo = _mm256_permute2x128_si256(c, vmin, 0x03);
      t = _mm256_alignr_epi8(c, lo, 12);
      c = _mm256_max_epi16(
          c, _mm256_add_epi16(t, _mm256_slli_epi16(vgap, 1)));
      lo = _mm256_permute2x128_si256(c, vmin, 0x03);
      t = _mm256_alignr_epi8(c, lo, 8);
      c = _mm256_max_epi16(
          c, _mm256_add_epi16(t, _mm256_slli_epi16(vgap, 2)));
      t = _mm256_permute2x128_si256(c, vmin, 0x03);  // shift by 8 lanes
      c = _mm256_max_epi16(
          c, _mm256_add_epi16(t, _mm256_slli_epi16(vgap, 3)));
      c = _mm256_max_epi16(
          c, _mm256_add_epi16(_mm256_set1_epi16(static_cast<int16_t>(carry)),
                              vramp));
      _mm256_storeu_si256(reinterpret_cast<__m256i*>(cur + j0), c);
      carry = static_cast<int16_t>(_mm256_extract_epi16(c, 15));
    }
    // re-fix the tail beyond m that the last block overwrote (walk only
    // reads j <= m, but keep the buffer tidy for the next row's loads)
    for (int64_t j = m + 1; j < m_pad + 1 && j < Wz; j++) cur[j] = 0;
  }
  // traceback walk — identical to the int32 version
  int64_t ii = n, jj = m, sblen = 0;
  int32_t score = 0;
  while (ii != 0 || jj != 0) {
    if (ii == 0) {
      jj--;
    } else if (jj == 0) {
      ii--;
    } else {
      const int32_t s = (a[ii - 1] == b[jj - 1]) ? match : mismatch;
      if (dp[ii * Wz + jj] == dp[(ii - 1) * Wz + (jj - 1)] + s) {
        score += s; sblen++; ii--; jj--;
      } else if (dp[(ii - 1) * Wz + jj] >= dp[ii * Wz + (jj - 1)]) {
        ii--;
        if (sblen > 0) score -= 1;
      } else {
        score -= 1; sblen++; jj--;
      }
    }
  }
  return score;
}
#endif  // __AVX2__

#ifdef __AVX2__
struct NwScratch16 {
  std::vector<int16_t> dp, upgap;
};
#endif

// dispatch: int16 16-lane fill when values provably fit and the key row
// has headroom for the vector loads; exact int32 scalar otherwise
static inline int32_t nw_walk_dispatch(const int32_t* a, int64_t n,
                                       const int32_t* b, int64_t m,
                                       int64_t m_stride, int32_t match,
                                       int32_t mismatch, int32_t gap,
                                       std::vector<int32_t>& s32
#ifdef __AVX2__
                                       ,
                                       NwScratch16& s16
#endif
) {
#ifdef __AVX2__
  int32_t mag = match < 0 ? -match : match;
  const int32_t m2 = mismatch < 0 ? -mismatch : mismatch;
  const int32_t m3 = gap < 0 ? -gap : gap;
  if (m2 > mag) mag = m2;
  if (m3 > mag) mag = m3;
  if (mag < 1) mag = 1;
  const int64_t nm = n > m ? n : m;
  const int64_t m_pad = ((m + 15) / 16) * 16;
  // m >= 32: at tangle-typical m ~ 5-12 the per-call scratch/zeroing
  // overhead outweighs the 16-lane fill (measured: search eval 1.52 s
  // -> 2.39 s with an unconditional dispatch); long read paths win
  if (m >= 32 && nm * mag < 16000 && m_pad <= m_stride)
    return nw_walk_score16(a, n, b, m, match, mismatch, gap, s16.dp,
                           s16.upgap);
#endif
  return nw_walk_score(a, n, b, m, match, mismatch, gap, s32);
}


static unsigned allowed_cpus() {
#ifdef __linux__
  cpu_set_t set;
  if (sched_getaffinity(0, sizeof(set), &set) == 0) {
    int c = CPU_COUNT(&set);
    if (c > 0) return static_cast<unsigned>(c);
  }
#endif
  unsigned h = std::thread::hardware_concurrency();
  return h ? h : 1;
}

// Batched best-of-{forward, reverse-complement} path-space NW walk scores:
// out[c*R + r] = max over orientations of the walk-recomputed score of
// candidate c vs read r.  Keys use ops/nw_path.py's id*4+orient encoding;
// the reverse complement reverses step order and maps orient code 0 -> 1,
// anything else -> 0 (rc_keys_device semantics; reference
// include/alignments.h:64-70 maps non-'+' to '+').
//
// This is the CPU-backend scoring fast path for the search engine: the
// XLA row scan's warm dispatch costs ~20 ms PER CALL on CPU regardless of
// shape (per-op thunk overhead), which dominated thin-workload search;
// this routine is pure compute at exact (unpadded) shapes.  On TPU the
// Pallas/XLA device kernels remain the production path.
void nw_best_scores_batch(const int32_t* a_keys, const int32_t* a_len,
                          int64_t C, int64_t n_stride,
                          const int32_t* b_keys, const int32_t* b_len,
                          int64_t R, int64_t m_stride,
                          int32_t match, int32_t mismatch, int32_t gap,
                          int32_t with_rc, int32_t* out) {
  std::vector<int32_t> rc(static_cast<size_t>(R) * m_stride, 0);
  int64_t cells_per_cand = 0;
  for (int64_t r = 0; r < R; r++) {
    const int32_t* src = b_keys + r * m_stride;
    int32_t* dst = rc.data() + r * m_stride;
    const int64_t m = b_len[r];
    cells_per_cand += m;
    for (int64_t j = 0; j < m; j++) {
      const int32_t k = src[m - 1 - j];
      dst[j] = (k & ~3) | (((k & 3) == 0) ? 1 : 0);
    }
  }
  auto run = [&](int64_t c0, int64_t c1) {
    std::vector<int32_t> scratch;
#ifdef __AVX2__
    NwScratch16 s16;
#define NW_WALK(a_, n_, b_, m_) \
  nw_walk_dispatch(a_, n_, b_, m_, m_stride, match, mismatch, gap, scratch, \
                   s16)
#else
#define NW_WALK(a_, n_, b_, m_) \
  nw_walk_dispatch(a_, n_, b_, m_, m_stride, match, mismatch, gap, scratch)
#endif
    for (int64_t c = c0; c < c1; c++) {
      const int32_t* a = a_keys + c * n_stride;
      const int64_t n = a_len[c];
      int32_t* orow = out + c * R;
      for (int64_t r = 0; r < R; r++) {
        const int64_t m = b_len[r];
        const int32_t fw = NW_WALK(a, n, b_keys + r * m_stride, m);
        if (!with_rc) {
          orow[r] = fw;
          continue;
        }
        const int32_t rv = NW_WALK(a, n, rc.data() + r * m_stride, m);
        orow[r] = fw > rv ? fw : rv;
      }
    }
#undef NW_WALK
  };
  unsigned hw = g_max_threads > 0 ? static_cast<unsigned>(g_max_threads)
                                  : allowed_cpus();
  int64_t n_threads = static_cast<int64_t>(hw ? hw : 1);
  if (n_threads > C) n_threads = C;
  // mean candidate length * read cells: skip thread spawn for small work
  if (n_threads > 1) {
    int64_t n_sum = 0;
    for (int64_t c = 0; c < C; c++) n_sum += a_len[c];
    const double cells = 2.0 * static_cast<double>(n_sum) *
                         static_cast<double>(cells_per_cand) / (C ? C : 1) *
                         static_cast<double>(C);
    if (cells < 2e6) n_threads = 1;
  }
  if (n_threads <= 1) {
    run(0, C);
    return;
  }
  std::vector<std::thread> threads;
  for (int64_t t = 0; t < n_threads; t++) {
    threads.emplace_back(run, C * t / n_threads, C * (t + 1) / n_threads);
  }
  for (auto& th : threads) th.join();
}

// Fused frontier evaluation: per-candidate (bad, good, unaligned) tallies
// straight from the key arrays — filter + fw/rc NW scoring + tally in one
// native call (reference evaluatePath, src/eval.cpp:63-108).  With
// filter != 0, a read is dropped when any of its valid steps' ids is
// absent from the candidate's id set, contributing its offending-step
// count to `unaligned` (src/eval.cpp:81-91); kept reads score best-of
// fw/rc, < 0 -> bad else good.  The per-dispatch Python mask loop this
// replaces cost ~3 ms/call and dominated thin-workload search.
void nw_evaluate_frontier(const int32_t* a_keys, const int32_t* a_len,
                          int64_t C, int64_t n_stride,
                          const int32_t* b_keys, const int32_t* b_len,
                          int64_t R, int64_t m_stride,
                          int32_t match, int32_t mismatch, int32_t gap,
                          int32_t filter, int64_t* out3 /* C*3 */) {
  // reverse-complemented read keys, built once (shared across candidates)
  std::vector<int32_t> rc(static_cast<size_t>(R) * m_stride, 0);
  for (int64_t r = 0; r < R; r++) {
    const int32_t* src = b_keys + r * m_stride;
    int32_t* dst = rc.data() + r * m_stride;
    const int64_t m = b_len[r];
    for (int64_t j = 0; j < m; j++) {
      const int32_t k = src[m - 1 - j];
      dst[j] = (k & ~3) | (((k & 3) == 0) ? 1 : 0);
    }
  }
  auto run = [&](int64_t c0, int64_t c1) {
    std::vector<int32_t> scratch;
    std::vector<int32_t> ids;
#ifdef __AVX2__
    NwScratch16 s16;
#endif
    for (int64_t c = c0; c < c1; c++) {
      const int32_t* a = a_keys + c * n_stride;
      const int64_t n = a_len[c];
      ids.clear();
      for (int64_t i = 0; i < n; i++) {
        const int32_t id = a[i] >> 2;
        bool seen = false;
        for (int32_t v : ids) {
          if (v == id) { seen = true; break; }
        }
        if (!seen) ids.push_back(id);
      }
      int64_t bad = 0, good = 0, unaligned = 0;
      for (int64_t r = 0; r < R; r++) {
        const int32_t* b = b_keys + r * m_stride;
        const int64_t m = b_len[r];
        if (filter) {
          int64_t off = 0;
          for (int64_t j = 0; j < m; j++) {
            const int32_t id = b[j] >> 2;
            bool member = false;
            for (int32_t v : ids) {
              if (v == id) { member = true; break; }
            }
            if (!member) off++;
          }
          if (off) {
            unaligned += off;
            continue;
          }
        }
#ifdef __AVX2__
        const int32_t fw = nw_walk_dispatch(a, n, b, m, m_stride, match,
                                            mismatch, gap, scratch, s16);
        const int32_t rv =
            nw_walk_dispatch(a, n, rc.data() + r * m_stride, m, m_stride,
                             match, mismatch, gap, scratch, s16);
#else
        const int32_t fw = nw_walk_score(a, n, b, m, match, mismatch, gap,
                                         scratch);
        const int32_t rv = nw_walk_score(a, n, rc.data() + r * m_stride, m,
                                         match, mismatch, gap, scratch);
#endif
        const int32_t best = fw > rv ? fw : rv;
        if (best < 0) bad++; else good++;
      }
      out3[c * 3 + 0] = bad;
      out3[c * 3 + 1] = good;
      out3[c * 3 + 2] = unaligned;
    }
  };
  unsigned hw = g_max_threads > 0 ? static_cast<unsigned>(g_max_threads)
                                  : allowed_cpus();
  int64_t n_threads = static_cast<int64_t>(hw ? hw : 1);
  if (n_threads > C) n_threads = C;
  if (n_threads > 1 && C * R < 4096) n_threads = 1;
  if (n_threads <= 1) {
    run(0, C);
    return;
  }
  std::vector<std::thread> threads;
  for (int64_t t = 0; t < n_threads; t++) {
    threads.emplace_back(run, C * t / n_threads, C * (t + 1) / n_threads);
  }
  for (auto& th : threads) th.join();
}

// ---------------------------------------------------------------------------
// Native tangle-search driver (CPU fast path of engine/search.py).
//
// The reference's dijkstra (src/eval.cpp:110-193) is a sequential C++
// best-first loop; our Python driver adds batched scoring + speculation but
// its per-step bookkeeping (~25 us/step) dominates once scoring went
// native.  This driver runs the IDENTICAL algorithm — same admissibility,
// priority, FIFO tie-break, improvement logic, and output bytes — with the
// fused filter+score evaluation inlined, and (optionally) the frontier
// sharded across same-host processes with the /dev/shm allreduce
// (parallel/dist._ShmExchange wire format).  Output parity is enforced by
// tests/test_search_differential.py and the test.6 golden.
// ---------------------------------------------------------------------------

namespace search_impl {

struct HeapItem {
  int64_t alt;
  int64_t seq;
  int64_t pid;
};
struct HeapCmp {  // min-heap on (alt, seq); seq unique -> FIFO ties
  bool operator()(const HeapItem& a, const HeapItem& b) const {
    if (a.alt != b.alt) return a.alt > b.alt;
    return a.seq > b.seq;
  }
};

struct PathNode {
  int64_t parent;   // -1 for the seed
  int32_t sid;
  int8_t orc;       // 0 '+', 1 '-', 2 '0'
  int8_t fix;       // if >= 0, parent's step orientation is rewritten
};

// diagnostic wait tallies: relaxed atomics — in production each rank is
// its own process, but the ring protocol is also exercised by threads
// (native/sanitize_test.cpp), and a plain global would be a data race
static std::atomic<int64_t> g_shm_wait_ns{0};  // total blocked time
static std::atomic<int64_t> g_shm_waits{0};
// profiling split for the search driver (search_profile): time spent
// SCORING (eval_one) vs ring-WAITING vs everything else (the replicated
// walk/commit loop, derived as total - eval - wait by the caller)
static std::atomic<int64_t> g_eval_ns{0};
static std::atomic<int64_t> g_run_ns{0};

static double mono_s() { return host_mono_s(); }

static void shm_wait_ge(const int64_t* cell, int64_t want) {
  if (__atomic_load_n(cell, __ATOMIC_ACQUIRE) >= want) return;
  const double t0 = mono_s();
  int spins = 0;
  while (__atomic_load_n(cell, __ATOMIC_ACQUIRE) < want) {
    if (++spins > 5000) {
      struct timespec ts = {0, 100000};  // 0.1 ms
      nanosleep(&ts, nullptr);
    }
  }
  g_shm_wait_ns.fetch_add(static_cast<int64_t>((mono_s() - t0) * 1e9),
                          std::memory_order_relaxed);
  g_shm_waits.fetch_add(1, std::memory_order_relaxed);
}

// Pipelined same-host tally exchange over a /dev/shm ring
// (parallel/dist.make_shm_ring layout).  Per dispatch every process
// scores a round-robin share of the SPECULATIVE candidates and publishes
// its share non-blockingly; the popped path's own expansions are scored
// redundantly by everyone, so commits never wait on a peer.  Peer shares
// are drained lazily — in batch order — the first time one of their
// scores is consumed, by which point they have almost always arrived:
// the barrier-per-frontier design lost ~0.2-0.5 ms of scheduler skew per
// dispatch on shared cores, which dominated thin-workload scaling.
//
// Layout: arr[0] = token; arr[1 + p] = proc p's drained counter;
// slots at arr[1 + nproc ...]: per (proc, k % ring): [seq, len,
// data[width]].  Proc p may reuse its slot for batch k only once every
// peer's drained counter has passed k - ring (their guard), so a slot is
// never overwritten while needed.  Progress: draining proceeds from the
// lowest undrained batch, which the slowest peer has always published.
struct RingX {
  int64_t* arr = nullptr;
  int64_t width = 0;
  int64_t ring = 0;
  int pid = 0, nproc = 1;
  int64_t pub = 0;      // batches published by this process
  int64_t drained = 0;  // batches fully drained (in order)

  int64_t* slot(int p, int64_t k) {
    const int64_t s = 2 + width;
    return arr + 1 + nproc + (static_cast<int64_t>(p) * ring + (k % ring)) * s;
  }

  void wait_peers_drained(int64_t want) {
    for (int p = 0; p < nproc; p++) {
      if (p == pid) continue;
      shm_wait_ge(&arr[1 + p], want);
    }
  }

  void publish(const int64_t* vals, int64_t n) {
    const int64_t k = pub;
    if (k >= ring) wait_peers_drained(k - ring + 1);
    int64_t* s = slot(pid, k);
    if (n > width) n = width;  // callers cap batches to width/3 tallies
    if (n > 0) std::memcpy(s + 2, vals, n * sizeof(int64_t));
    s[1] = n;
    __atomic_store_n(&s[0], k + 1, __ATOMIC_RELEASE);
    pub++;
  }

  void mark_drained() {
    drained++;
    __atomic_store_n(&arr[1 + pid], drained, __ATOMIC_RELEASE);
  }
};

struct Driver {
  // graph
  const int32_t* adj_off;
  const int32_t* adj_nid;
  const int8_t* adj_or0;
  const int8_t* adj_or1;
  int32_t n_segments;
  const int32_t* budget;
  // node table records (for the Hamiltonian check)
  const int32_t* rec_uids;
  const int32_t* rec_counts;
  int32_t n_records;
  int32_t node_count;
  int32_t dest_uid;
  // reads
  const int32_t* b_keys;
  const int32_t* b_len;
  int64_t R, m_stride;
  std::vector<int32_t> rc_keys;
  int32_t match, mismatch, gap;
  // params
  int64_t max_steps;
  int32_t min_nodes;
  bool return_all;
  int32_t spec_depth, speculate;
  const char* name_blob;
  const int64_t* name_off;
  // distributed
  RingX* ring = nullptr;
  int pid = 0, nproc = 1;
  bool sum_mode = false;  // read-sharded: every process scores every
  // candidate against its LOCAL read shard; tallies SUM across processes
  // (blocking per batch — eval dominates at the read counts that pick
  // this mode).  false = frontier-sharded (owner-only values, pipelined).

  // path trie
  std::vector<PathNode> nodes;
  std::unordered_map<uint64_t, int64_t> intern;
  uint64_t intern_stride = 1;  // total edge count + 1
  // per-pid cached tallies; sc_pending = batch id whose drain will fill
  // this pid's score (-1 = none)
  std::vector<int64_t> sc_bad, sc_good, sc_unal, sc_pending;
  std::vector<uint8_t> sc_have;
  std::vector<std::vector<int64_t>> pending_batches;  // ring of spec lists
  size_t pending_head = 0;
  // scratch
  std::vector<int32_t> steps_sid, steps_orc;   // materialized path
  std::vector<int32_t> visit_cnt;              // per-sid counters + undo
  std::vector<int32_t> touched;
  std::vector<int32_t> dp_scratch_i32;
#ifdef __AVX2__
  NwScratch16 nw16_scratch;
#endif
  std::vector<int32_t> akeys_scratch;
  std::vector<int32_t> ids_scratch;
  std::vector<uint8_t> member_scratch;  // per-segment candidate membership
  std::string out;

  void ensure_pid(int64_t pid_) {
    if (static_cast<size_t>(pid_) >= sc_have.size()) {
      size_t n = sc_have.size() ? sc_have.size() * 2 : 4096;
      while (n <= static_cast<size_t>(pid_)) n *= 2;
      sc_bad.resize(n);
      sc_good.resize(n);
      sc_unal.resize(n);
      sc_pending.resize(n, -1);
      sc_have.resize(n, 0);
    }
  }

  // drain peer tally shares, in batch order, through batch k
  void drain_upto(int64_t k) {
    while (ring->drained <= k) {
      const int64_t j = ring->drained;
      const std::vector<int64_t>& spec = pending_batches[pending_head];
      for (int p = 0; p < nproc; p++) {
        if (p == pid) continue;
        int64_t* s = ring->slot(p, j);
        shm_wait_ge(&s[0], j + 1);
        int64_t jj = 0;
        for (size_t i = 0; i < spec.size(); i++) {
          if (static_cast<int64_t>(i % nproc) != p) continue;
          const int64_t sp = spec[i];
          const int64_t* v = s + 2 + 3 * jj;
          ensure_pid(sp);
          sc_bad[sp] = v[0];
          sc_good[sp] = v[1];
          sc_unal[sp] = v[2];
          sc_have[sp] = 1;
          sc_pending[sp] = -1;
          jj++;
        }
      }
      pending_head++;
      ring->mark_drained();
    }
  }

  void consume(int64_t p) {
    ensure_pid(p);
    if (!sc_have[p] && ring && sc_pending[p] >= 0) drain_upto(sc_pending[p]);
  }

  // materialize the step sequence of `pid` into steps_sid/steps_orc
  void materialize(int64_t p) {
    steps_sid.clear();
    steps_orc.clear();
    int8_t fix = -1;
    while (p >= 0) {
      const PathNode& nd = nodes[static_cast<size_t>(p)];
      steps_sid.push_back(nd.sid);
      steps_orc.push_back(fix >= 0 ? fix : nd.orc);
      fix = nd.fix;
      p = nd.parent;
    }
    std::reverse(steps_sid.begin(), steps_sid.end());
    std::reverse(steps_orc.begin(), steps_orc.end());
  }

  struct Expansion {
    int64_t cpid;
    int32_t nid;
    int8_t or1;
    int32_t n_uniques;
  };

  // expansions of `p` (materialize() must hold p's steps)
  void expansions_of(int64_t p, std::vector<Expansion>& out_exps) {
    out_exps.clear();
    const int32_t last_sid = steps_sid.back();
    const int8_t last_orc = static_cast<int8_t>(steps_orc.back());
    // visit counts past the seed + distinct-sid count of current path
    for (int32_t t : touched) visit_cnt[t] = 0;
    touched.clear();
    int32_t base_uniques = 0;
    for (size_t i = 0; i < steps_sid.size(); i++) {
      const int32_t sid = steps_sid[i];
      if (visit_cnt[sid] == 0) base_uniques++;
      if (visit_cnt[sid] == 0) touched.push_back(sid);
      if (i > 0) visit_cnt[sid] += 1 << 8;  // entered-count in high bits
      visit_cnt[sid] |= 1;                  // presence in low bit
    }
    for (int32_t e = adj_off[last_sid]; e < adj_off[last_sid + 1]; e++) {
      if (last_orc != 2 && last_orc != adj_or0[e]) continue;
      const int32_t nid = adj_nid[e];
      const int32_t bud = budget[nid];
      if (bud < 0) continue;
      const int32_t entered = visit_cnt[nid] >> 8;
      if (bud - entered <= 0) continue;
      const int8_t fix = (last_orc == 2) ? adj_or0[e] : int8_t(-1);
      // collision-free: parent * stride + edge slot (fix is derived from
      // the parent's last orientation, so (parent, edge) is the identity)
      const uint64_t key =
          static_cast<uint64_t>(p) * intern_stride + static_cast<uint64_t>(e);
      auto it = intern.find(key);
      int64_t cpid;
      if (it == intern.end()) {
        cpid = static_cast<int64_t>(nodes.size());
        nodes.push_back(PathNode{p, nid, adj_or1[e], fix});
        intern.emplace(key, cpid);
      } else {
        cpid = it->second;
      }
      const int32_t n_uniq =
          base_uniques + ((visit_cnt[nid] & 1) ? 0 : 1);
      out_exps.push_back(Expansion{cpid, nid, adj_or1[e], n_uniq});
    }
  }

  // fused filter + fw/rc scoring + tally for ONE candidate (the
  // materialized steps of `p`), nw_evaluate_frontier semantics
  void eval_one(int64_t p, int64_t* bad, int64_t* good, int64_t* unal) {
    const double t0 = mono_s();
    struct Acc {  // tally on every exit path
      double t0;
      ~Acc() {
        g_eval_ns.fetch_add(static_cast<int64_t>((mono_s() - t0) * 1e9),
                            std::memory_order_relaxed);
      }
    } acc{t0};
    materialize(p);
    const int64_t n = static_cast<int64_t>(steps_sid.size());
    akeys_scratch.assign(static_cast<size_t>(n), 0);
    int32_t* akeys = akeys_scratch.data();
    for (int64_t i = 0; i < n; i++)
      akeys[i] = (steps_sid[i] << 2) | steps_orc[i];
    // candidate segment membership bitmap: O(1) per read step instead of
    // an O(#unique-ids) scan (eval_one runs per candidate x every read —
    // the search driver's hottest region)
    if (member_scratch.size() < static_cast<size_t>(n_segments))
      member_scratch.assign(static_cast<size_t>(n_segments), 0);
    ids_scratch.clear();
    for (int64_t i = 0; i < n; i++) {
      const int32_t id = steps_sid[i];
      if (!member_scratch[id]) {
        member_scratch[id] = 1;
        ids_scratch.push_back(id);
      }
    }
    int64_t nb = 0, ng = 0, nu = 0;
    for (int64_t r = 0; r < R; r++) {
      const int32_t* b = b_keys + r * m_stride;
      const int64_t m = b_len[r];
      int64_t off = 0;
      for (int64_t j = 0; j < m; j++) {
        const int32_t id = b[j] >> 2;
        if (id >= n_segments || !member_scratch[id]) off++;
      }
      if (off) {
        nu += off;
        continue;
      }
#ifdef __AVX2__
      const int32_t fw = nw_walk_dispatch(akeys, n, b, m, m_stride, match,
                                          mismatch, gap, dp_scratch_i32,
                                          nw16_scratch);
      const int32_t rv = nw_walk_dispatch(
          akeys, n, rc_keys.data() + r * m_stride, m, m_stride, match,
          mismatch, gap, dp_scratch_i32, nw16_scratch);
#else
      const int32_t fw = nw_walk_score(akeys, n, b, m, match,
                                       mismatch, gap, dp_scratch_i32);
      const int32_t rv = nw_walk_score(akeys, n,
                                       rc_keys.data() + r * m_stride, m,
                                       match, mismatch, gap, dp_scratch_i32);
#endif
      const int32_t best = fw > rv ? fw : rv;
      if (best < 0) nb++; else ng++;
    }
    for (int32_t id : ids_scratch) member_scratch[id] = 0;  // cheap reset
    *bad = nb;
    *good = ng;
    *unal = nu;
  }

  void append_path_row(int64_t path_counter, int64_t bad, int64_t good,
                       int64_t alt, int32_t n_uniques, bool hamiltonian) {
    out += std::to_string(path_counter);
    out += '\t';
    out += std::to_string(bad);
    out += '\t';
    out += std::to_string(good);
    out += '\t';
    out += std::to_string(alt);
    out += '\t';
    out += std::to_string(steps_sid.size());
    out += '\t';
    out += std::to_string(n_uniques);
    out += '\t';
    out += hamiltonian ? 'T' : 'F';
    out += '\t';
    for (size_t i = 0; i < steps_sid.size(); i++) {
      if (i) out += ',';
      const int32_t sid = steps_sid[i];
      out.append(name_blob + name_off[sid],
                 static_cast<size_t>(name_off[sid + 1] - name_off[sid]));
      out += (steps_orc[i] == 0 ? '+' : steps_orc[i] == 1 ? '-' : '0');
    }
    out += '\n';
  }

  void run(int32_t source_uid) {
    visit_cnt.assign(n_segments, 0);
    intern_stride = static_cast<uint64_t>(adj_off[n_segments]) + 1;
    // rc read keys once
    rc_keys.assign(static_cast<size_t>(R) * m_stride, 0);
    for (int64_t r = 0; r < R; r++) {
      const int32_t* src = b_keys + r * m_stride;
      int32_t* dst = rc_keys.data() + r * m_stride;
      const int64_t m = b_len[r];
      for (int64_t j = 0; j < m; j++) {
        const int32_t k = src[m - 1 - j];
        dst[j] = (k & ~3) | (((k & 3) == 0) ? 1 : 0);
      }
    }
    nodes.push_back(PathNode{-1, source_uid, 2, -1});
    std::vector<HeapItem> heap;
    heap.push_back(HeapItem{0, 0, 0});
    int64_t seq = 1;
    int64_t best_alt = (int64_t(1) << 31) - 1;
    int32_t best_uniques = 0;
    int64_t path_counter = 0;
    int64_t steps = 0;
    std::vector<Expansion> exps, child_exps;
    std::vector<int64_t> to_score;
    std::vector<uint8_t> in_batch;  // seen_keys, indexed by pid
    std::vector<int64_t> frontier, next_frontier;
    std::vector<HeapItem> pool;
    std::vector<int64_t> tallies;
    std::vector<int32_t> ham_counts(n_segments, 0);
    while (!heap.empty() && steps < max_steps) {
      std::pop_heap(heap.begin(), heap.end(), HeapCmp());
      const HeapItem top = heap.back();
      heap.pop_back();
      const int64_t upid = top.pid;
      materialize(upid);
      expansions_of(upid, exps);
      if (exps.empty()) {
        steps++;
        continue;
      }
      to_score.clear();
      if (in_batch.size() < nodes.size()) in_batch.resize(nodes.size(), 0);
      auto want_score = [&](int64_t p) {
        if (static_cast<size_t>(p) < sc_have.size() &&
            (sc_have[p] || sc_pending[p] >= 0))
          return;  // cached, or a peer's share already in flight
        if (in_batch[p]) return;
        in_batch[p] = 1;
        to_score.push_back(p);
      };
      for (const Expansion& ex : exps) want_score(ex.cpid);
      // the pop's own expansions head the batch; everyone scores them
      // redundantly so the commit below never waits on a peer (measured:
      // widening the redundant region to the descent children costs more
      // extra scoring than it saves in waits)
      const size_t n_imm = to_score.size();
      if (speculate > 0 && !to_score.empty()) {
        // descent speculation: spec_depth generations below this pop
        frontier.clear();
        for (const Expansion& ex : exps)
          if (ex.nid != dest_uid) frontier.push_back(ex.cpid);
        for (int32_t d = 0; d < spec_depth && to_score.size() <= 4096; d++) {
          next_frontier.clear();
          for (int64_t cp : frontier) {
            materialize(cp);
            expansions_of(cp, child_exps);
            if (in_batch.size() < nodes.size())
              in_batch.resize(nodes.size(), 0);
            for (const Expansion& g : child_exps) {
              want_score(g.cpid);
              if (g.nid != dest_uid) next_frontier.push_back(g.cpid);
            }
          }
          frontier.swap(next_frontier);
          if (to_score.size() > 4096) break;
        }
        // heap-prefix speculation
        const size_t span =
            std::min(heap.size(), static_cast<size_t>(4 * speculate));
        pool.assign(heap.begin(), heap.begin() + span);
        std::sort(pool.begin(), pool.end(),
                  [](const HeapItem& a, const HeapItem& b) {
                    if (a.alt != b.alt) return a.alt < b.alt;
                    return a.seq < b.seq;
                  });
        const size_t take =
            std::min(pool.size(), static_cast<size_t>(speculate));
        for (size_t i = 0; i < take; i++) {
          materialize(pool[i].pid);
          expansions_of(pool[i].pid, child_exps);
          if (in_batch.size() < nodes.size())
            in_batch.resize(nodes.size(), 0);
          for (const Expansion& g : child_exps) want_score(g.cpid);
        }
      }
      if (!to_score.empty() && nproc <= 1) {
        for (size_t i = 0; i < to_score.size(); i++) {
          const int64_t p = to_score[i];
          ensure_pid(p);
          eval_one(p, &sc_bad[p], &sc_good[p], &sc_unal[p]);
          sc_have[p] = 1;
          in_batch[p] = 0;
        }
      } else if (!to_score.empty() && sum_mode) {
        // read-sharded: score everything locally, blocking ring-sum of
        // the whole batch's tallies, chunked to the slot width across as
        // many ring batches as it takes (every process runs the same
        // deterministic chunk loop, so publishes stay paired).  Never
        // truncate: a truncated tail that included the pop's immediate
        // expansions would leave sc_have unset and the commit below would
        // read zero-initialized tallies — silently wrong alt values.
        const size_t max_c = static_cast<size_t>(ring->width / 3);
        const size_t C_total = to_score.size();
        for (size_t c0 = 0; c0 < C_total; c0 += max_c) {
          const size_t C = std::min(max_c, C_total - c0);
          tallies.assign(3 * C, 0);
          for (size_t i = 0; i < C; i++) {
            const int64_t p = to_score[c0 + i];
            eval_one(p, &tallies[3 * i], &tallies[3 * i + 1],
                     &tallies[3 * i + 2]);
          }
          const int64_t k = ring->pub;
          ring->publish(tallies.data(), static_cast<int64_t>(3 * C));
          for (int peer = 0; peer < nproc; peer++) {
            if (peer == pid) continue;
            int64_t* s = ring->slot(peer, k);
            shm_wait_ge(&s[0], k + 1);
            for (size_t i = 0; i < 3 * C; i++) tallies[i] += s[2 + i];
          }
          ring->mark_drained();  // sum batches drain themselves in order
          pending_batches.push_back(std::vector<int64_t>());
          pending_head++;
          for (size_t i = 0; i < C; i++) {
            const int64_t p = to_score[c0 + i];
            ensure_pid(p);
            sc_bad[p] = tallies[3 * i];
            sc_good[p] = tallies[3 * i + 1];
            sc_unal[p] = tallies[3 * i + 2];
            sc_have[p] = 1;
            in_batch[p] = 0;
          }
        }
      } else if (!to_score.empty()) {
        // cap the speculative region so every process's 3-per-candidate
        // share fits one ring slot (dropped tails just score later)
        const int64_t max_spec =
            static_cast<int64_t>(nproc) * (ring->width / 3);
        size_t C = to_score.size();
        if (static_cast<int64_t>(C - n_imm) > max_spec)
          C = n_imm + static_cast<size_t>(max_spec);
        for (size_t i = C; i < to_score.size(); i++)
          in_batch[to_score[i]] = 0;
        for (size_t i = 0; i < n_imm; i++) {  // redundant, sync-free
          const int64_t p = to_score[i];
          ensure_pid(p);
          eval_one(p, &sc_bad[p], &sc_good[p], &sc_unal[p]);
          sc_have[p] = 1;
          in_batch[p] = 0;
        }
        const int64_t k = ring->pub;
        std::vector<int64_t> spec(to_score.begin() + n_imm,
                                  to_score.begin() + C);
        tallies.clear();  // this process's contiguous share
        for (size_t i = 0; i < spec.size(); i++) {
          const int64_t p = spec[i];
          ensure_pid(p);
          if (static_cast<int64_t>(i % nproc) == pid) {
            int64_t b, g, u2;
            eval_one(p, &b, &g, &u2);
            sc_bad[p] = b;
            sc_good[p] = g;
            sc_unal[p] = u2;
            sc_have[p] = 1;
            tallies.push_back(b);
            tallies.push_back(g);
            tallies.push_back(u2);
          } else {
            sc_pending[p] = k;
          }
          in_batch[p] = 0;
        }
        ring->publish(tallies.data(), static_cast<int64_t>(tallies.size()));
        pending_batches.push_back(std::move(spec));
      }
      // commit in heap order
      for (const Expansion& ex : exps) {
        if (nproc > 1) consume(ex.cpid);
        const int64_t alt =
            sc_bad[ex.cpid] - sc_good[ex.cpid] - ex.n_uniques;
        if (ex.nid != dest_uid) {
          heap.push_back(HeapItem{alt, seq++, ex.cpid});
          std::push_heap(heap.begin(), heap.end(), HeapCmp());
        } else {
          path_counter++;
          materialize(ex.cpid);
          // Hamiltonian: path length + 2 == node_count AND every record's
          // uid appears exactly rec_counts times
          bool ham =
              (static_cast<int64_t>(steps_sid.size()) + 2 == node_count);
          if (ham) {
            for (int32_t sid : steps_sid) ham_counts[sid]++;
            for (int32_t k = 0; k < n_records && ham; k++) {
              const int32_t uid = rec_uids[k];
              const int32_t have =
                  (uid >= 0 && uid < n_segments) ? ham_counts[uid] : 0;
              if (have != rec_counts[k]) ham = false;
            }
            for (int32_t sid : steps_sid) ham_counts[sid] = 0;
          }
          bool print_path = false;
          if (ex.n_uniques >= min_nodes &&
              (best_uniques < ex.n_uniques ||
               (best_uniques == ex.n_uniques && best_alt > alt))) {
            best_alt = alt;
            best_uniques = ex.n_uniques;
            print_path = true;
          }
          if (return_all || print_path)
            append_path_row(path_counter, sc_bad[ex.cpid], sc_good[ex.cpid],
                            alt, ex.n_uniques, ham);
        }
      }
      steps++;
    }
    if (steps >= max_steps) {
      out += "Reached maximum number of steps (";
      out += std::to_string(steps);
      out += ")\n";
    }
  }
};

}  // namespace search_impl

// C ABI for the native search driver.  Returns 0 on success; the output
// text (the exact bytes the Python driver would write to `out`) is
// malloc'd into *out_text / *out_len and must be released with
// search_free.  With nproc > 1 the speculative frontier is sharded
// round-robin and tallies flow through the pipelined shm ring
// (parallel/dist.make_shm_ring; the caller zeroes + barriers the ring
// before the call).
int32_t search_native(
    const int32_t* adj_off, const int32_t* adj_nid, const int8_t* adj_or0,
    const int8_t* adj_or1, int32_t n_segments, const int32_t* budget,
    const int32_t* rec_uids, const int32_t* rec_counts, int32_t n_records,
    int32_t node_count, int32_t source_uid, int32_t dest_uid,
    const int32_t* b_keys, const int32_t* b_len, int64_t R, int64_t m_stride,
    int32_t match, int32_t mismatch, int32_t gap, int64_t max_steps,
    int32_t min_nodes, int32_t return_all, int32_t spec_depth,
    int32_t speculate, const char* name_blob, const int64_t* name_off,
    int32_t pid, int32_t nproc, int64_t* ring_base, int64_t ring_width,
    int64_t ring_slots, int32_t ring_sum_mode, char** out_text,
    int64_t* out_len) {
  if (n_segments <= 0 || source_uid < 0 || source_uid >= n_segments ||
      dest_uid < 0 || dest_uid >= n_segments)
    return -1;
  if (nproc > 1 && (ring_base == nullptr || ring_width < 3 || ring_slots < 2))
    return -1;
  search_impl::Driver d;
  d.adj_off = adj_off;
  d.adj_nid = adj_nid;
  d.adj_or0 = adj_or0;
  d.adj_or1 = adj_or1;
  d.n_segments = n_segments;
  d.budget = budget;
  d.rec_uids = rec_uids;
  d.rec_counts = rec_counts;
  d.n_records = n_records;
  d.node_count = node_count;
  d.dest_uid = dest_uid;
  d.b_keys = b_keys;
  d.b_len = b_len;
  d.R = R;
  d.m_stride = m_stride;
  d.match = match;
  d.mismatch = mismatch;
  d.gap = gap;
  d.max_steps = max_steps;
  d.min_nodes = min_nodes;
  d.return_all = return_all != 0;
  d.spec_depth = spec_depth;
  d.speculate = speculate;
  d.name_blob = name_blob;
  d.name_off = name_off;
  search_impl::RingX ring;
  if (nproc > 1) {
    ring.arr = ring_base;
    ring.width = ring_width;
    ring.ring = ring_slots;
    ring.pid = pid;
    ring.nproc = nproc;
    d.ring = &ring;
    d.pid = pid;
    d.nproc = nproc;
    d.sum_mode = ring_sum_mode != 0;
  }
  const double run_t0 = search_impl::mono_s();
  d.run(source_uid);
  search_impl::g_run_ns.fetch_add(
      static_cast<int64_t>((search_impl::mono_s() - run_t0) * 1e9),
      std::memory_order_relaxed);
  char* buf = static_cast<char*>(std::malloc(d.out.size() + 1));
  if (!buf) return -1;
  std::memcpy(buf, d.out.data(), d.out.size());
  buf[d.out.size()] = '\0';
  *out_text = buf;
  *out_len = static_cast<int64_t>(d.out.size());
  return 0;
}

void search_free(char* p) { std::free(p); }

#ifdef __AVX2__
// int16 single-pair banded scorer: 16 lanes per vector instead of 8.
// Safe when lr < 30000 (match = +1 bounds every H cell by lr; the most
// negative intermediate is block + 16*gap ≈ -1050) — the caller guards.
// Semantics identical to the int32 path below (same recurrences, chain
// seeds, first-argmax tie-breaks, band-edge flag).
static void banded_pair_i16(const int8_t* rd, int64_t lr, const int8_t* pa,
                            int64_t lp, int32_t delta, int32_t width,
                            int32_t match, int32_t mismatch, int32_t gap,
                            int32_t pad_code, int32_t block,
                            std::vector<int16_t>& H, int32_t* out_best,
                            int32_t* out_bi, int32_t* out_bj,
                            uint8_t* out_edge) {
  const int32_t W2 = width / 2;
  if (static_cast<int64_t>(H.size()) < width + 16) H.resize(width + 16);
  std::fill(H.begin(), H.begin() + width, static_cast<int16_t>(0));
  H[width] = static_cast<int16_t>(block);
  const __m256i vgap = _mm256_set1_epi16(static_cast<int16_t>(gap));
  const __m256i vramp = _mm256_mullo_epi16(
      _mm256_setr_epi16(1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
                        16),
      vgap);
  const __m256i vpad = _mm256_set1_epi16(static_cast<int16_t>(pad_code));
  const __m256i vmatch = _mm256_set1_epi16(static_cast<int16_t>(match));
  const __m256i vmis = _mm256_set1_epi16(static_cast<int16_t>(mismatch));
  const __m256i vblk = _mm256_set1_epi16(static_cast<int16_t>(block));
  const __m256i vzero = _mm256_setzero_si256();
  int32_t best = 0, bi = 0, bj = 0, bu = 0;
  for (int64_t i = 1; i <= lr; i++) {
    const int32_t r = rd[i - 1];
    const int64_t j0 = i + delta - W2;
    const bool all_in = (j0 >= 1) && (j0 + width - 1 <= lp);
    if (all_in && r < 4 && width >= 16) {
      const int8_t* w0 = pa + (j0 - 1);
      const __m256i vr = _mm256_set1_epi16(static_cast<int16_t>(r));
      int32_t chain_in = block;
      __m256i vrow = _mm256_set1_epi16(-16384);
      for (int32_t b = 0; b < width; b += 16) {
        const __m256i w = _mm256_cvtepi8_epi16(_mm_loadu_si128(
            reinterpret_cast<const __m128i*>(w0 + b)));
        __m256i s = _mm256_blendv_epi8(vmis, vmatch,
                                       _mm256_cmpeq_epi16(w, vr));
        s = _mm256_blendv_epi8(s, vblk, _mm256_cmpeq_epi16(w, vpad));
        const __m256i hd = _mm256_loadu_si256(
            reinterpret_cast<const __m256i*>(H.data() + b));
        const __m256i hu = _mm256_loadu_si256(
            reinterpret_cast<const __m256i*>(H.data() + b + 1));
        __m256i c = _mm256_max_epi16(_mm256_add_epi16(hd, s),
                                     _mm256_add_epi16(hu, vgap));
        c = _mm256_max_epi16(c, vzero);
        // in-block max-plus prefix: shift by 1, 2, 4, 8 int16 lanes
        __m256i lo = _mm256_permute2x128_si256(c, c, 0x08);
        __m256i t = _mm256_alignr_epi8(c, lo, 14);
        c = _mm256_max_epi16(c, _mm256_add_epi16(t, vgap));
        lo = _mm256_permute2x128_si256(c, c, 0x08);
        t = _mm256_alignr_epi8(c, lo, 12);
        c = _mm256_max_epi16(
            c, _mm256_add_epi16(t, _mm256_slli_epi16(vgap, 1)));
        lo = _mm256_permute2x128_si256(c, c, 0x08);
        t = _mm256_alignr_epi8(c, lo, 8);
        c = _mm256_max_epi16(
            c, _mm256_add_epi16(t, _mm256_slli_epi16(vgap, 2)));
        t = _mm256_permute2x128_si256(c, c, 0x08);
        c = _mm256_max_epi16(
            c, _mm256_add_epi16(t, _mm256_slli_epi16(vgap, 3)));
        c = _mm256_max_epi16(
            c, _mm256_add_epi16(
                   _mm256_set1_epi16(static_cast<int16_t>(chain_in)),
                   vramp));
        _mm256_storeu_si256(reinterpret_cast<__m256i*>(H.data() + b), c);
        chain_in = static_cast<int16_t>(_mm256_extract_epi16(c, 15));
        vrow = _mm256_max_epi16(vrow, c);  // deferred row max
      }
      // one reduction per row; first-argmax rescan only on improvement
      __m256i m = _mm256_max_epi16(
          vrow, _mm256_permute2x128_si256(vrow, vrow, 0x01));
      m = _mm256_max_epi16(m, _mm256_shuffle_epi32(m, 0x4E));
      m = _mm256_max_epi16(m, _mm256_shuffle_epi32(m, 0xB1));
      m = _mm256_max_epi16(m, _mm256_shufflelo_epi16(m, 0xB1));
      const int32_t row_best =
          static_cast<int16_t>(_mm256_extract_epi16(m, 0));
      if (row_best > best) {
        int32_t ru = 0;
        while (H[ru] != row_best) ru++;  // first argmax in this row
        best = row_best;
        bi = static_cast<int32_t>(i);
        bj = static_cast<int32_t>(j0 + ru);
        bu = ru;
      }
      continue;
    }
    // boundary / N-read rows: scalar, in place over the int16 buffer
    // (cur[u] needs only prev[u] and prev[u+1], both still unwritten
    // when u ascends).  Out-of-range j is always a PREFIX or SUFFIX of
    // the band (j is monotone in u), so resetting the chain to 0 there
    // equals the int32 path's max(chain+gap, 0) continuation.
    int32_t chain = block;
    int32_t row_best = -1, row_u = 0;
    for (int32_t u = 0; u < width; u++) {
      const int64_t j = j0 + u;
      const int32_t prev_u = H[u];
      const int32_t prev_u1 = (u + 1 < width) ? H[u + 1] : block;
      int32_t c;
      if (j < 1 || j > lp) {
        c = 0;
        chain = 0;
        H[u] = 0;
        if (c > row_best) { row_best = c; row_u = u; }
        continue;
      }
      const int32_t win = pa[j - 1];
      const int32_t s = (r == pad_code || win == pad_code)
                            ? block
                            : ((r < 4 && win < 4 && r == win) ? match
                                                              : mismatch);
      c = prev_u + s;
      const int32_t up = prev_u1 + gap;
      if (up > c) c = up;
      if (c < 0) c = 0;
      const int32_t chained = chain + gap;
      int32_t h = chained > c ? chained : c;
      if (j < 1 || j > lp) h = 0;
      H[u] = static_cast<int16_t>(h);
      chain = h;
      if (h > row_best) { row_best = h; row_u = u; }
    }
    if (row_best > best) {
      best = row_best;
      bi = static_cast<int32_t>(i);
      bj = static_cast<int32_t>(j0 + row_u);
      bu = row_u;
    }
  }
  const bool ok = best > 0;
  *out_best = ok ? best : 0;
  *out_bi = ok ? bi : 0;
  *out_bj = ok ? bj : 0;
  *out_edge = (ok && (bu <= 0 || bu >= width - 1)) ? 1 : 0;
}
#endif  // __AVX2__

// Banded local (read, path) scoring batch — the HOST engine for align
// mode's scoring ladder.  Bit-exact with ops/seqalign._banded_forward
// (XLA) / the Pallas kernel: same strip indexing, 0-floored local cells,
// max-plus horizontal chain, first-argmax tie-break, strictly-improving
// (best, bi, bj) tracking and end-cell band-edge flag.  Exists because a
// remote-compile TPU transport pays 200-500 s per kernel shape with no
// persistent cache; on locally attached devices the Pallas kernel at
// ~10-30 Gcell/s is the production path (GFALIGN_TPU_ALIGN_DEVICE=1).
void seq_banded_pairs(const int8_t* reads, const int64_t* read_off,
                      const int64_t* read_len, const int8_t* paths,
                      const int64_t* path_off, const int64_t* path_len,
                      const int32_t* rid, const int32_t* pid,
                      const int32_t* deltas, int64_t n_pairs, int32_t width,
                      int32_t match, int32_t mismatch, int32_t gap,
                      int32_t pad_code, int32_t block,
                      int32_t* out_best, int32_t* out_bi, int32_t* out_bj,
                      uint8_t* out_edge) {
  const int32_t W2 = width / 2;
  auto run = [&](int64_t p0, int64_t p1) {
    // +8 slack: H[width] is a `block` sentinel so the vector 'up' load at
    // the last block needs no branch; the scalar paths never read past
    // width.
    std::vector<int32_t> H(static_cast<size_t>(width) + 8);
    std::vector<int32_t> C(static_cast<size_t>(width));
#ifdef __AVX2__
    std::vector<int16_t> H16;
    const __m256i vgap = _mm256_set1_epi32(gap);
    const __m256i vramp = _mm256_mullo_epi32(
        _mm256_setr_epi32(1, 2, 3, 4, 5, 6, 7, 8), vgap);
#endif
    for (int64_t n = p0; n < p1; n++) {
      const int8_t* rd = reads + read_off[rid[n]];
      const int64_t lr = read_len[rid[n]];
      const int8_t* pa = paths + path_off[pid[n]];
      const int64_t lp = path_len[pid[n]];
      const int32_t delta = deltas[n];
#ifdef __AVX2__
      // 16-lane int16 variant when every intermediate provably fits and
      // the band is whole 16-lane blocks (widths are multiples of 8 by
      // contract; odd-16 widths take the int32 8-lane path).  Stored cells
      // lie in [0, lr*pos_mag]; a cell plus a substitution score reaches
      // (lr+1)*pos_mag from above and min(match, mismatch, block) from
      // below; the lowest sum is the chain seed plus the 16-lane ramp,
      // block + 16*gap (the sentinel plus gap, and the prefix shifts'
      // 8*gap, lie above it; gap < 0 by contract, as below).
      const int64_t pos_mag = std::max(
          {match > 0 ? match : 0, mismatch > 0 ? mismatch : 0, 1});
      const int64_t neg_min = std::min(
          {static_cast<int64_t>(match), static_cast<int64_t>(mismatch),
           static_cast<int64_t>(block) + 16 * static_cast<int64_t>(gap)});
      if (width % 16 == 0 && (lr + 1) * pos_mag < 30000 &&
          neg_min > -30000) {
        banded_pair_i16(rd, lr, pa, lp, delta, width, match, mismatch,
                        gap, pad_code, block, H16, out_best + n,
                        out_bi + n, out_bj + n, out_edge + n);
        continue;
      }
#endif
      std::fill(H.begin(), H.begin() + width, 0);
      H[width] = block;
      int32_t best = 0, bi = 0, bj = 0, bu = 0;
      for (int64_t i = 1; i <= lr; i++) {
        const int32_t r = rd[i - 1];
        const int64_t j0 = i + delta - W2;  // j at lane 0
        const bool all_in = (j0 >= 1) && (j0 + width - 1 <= lp);
        if (all_in && r < 4) {
          // Interior fast path.  The row's critical path is the
          // horizontal max-plus chain (h[u] = max_{v<=u} c[v] +
          // gap*(u-v)); a memory-based log-step doubling scan was TRIED
          // and measured ~2x SLOWER than the fused serial loop (shifted
          // passes don't auto-vectorize and add 9x the traffic).  The
          // AVX2 version instead fuses everything into one left-to-right
          // block pass: per 8-lane block, substitution + up/diag maxes
          // are elementwise, the in-block prefix runs as 3 in-REGISTER
          // shift-maxes (shifted-in zeros can never win: c >= 0 and
          // gap < 0), and only the 8-lane carry (previous block's last
          // chain value + u*gap) is serial — one scalar per 8 cells
          // instead of one per cell.
          const int8_t* w0 = pa + (j0 - 1);
#ifdef __AVX2__
          const __m256i vr = _mm256_set1_epi32(r);
          const __m256i vpad = _mm256_set1_epi32(pad_code);
          const __m256i vmatch = _mm256_set1_epi32(match);
          const __m256i vmis = _mm256_set1_epi32(mismatch);
          const __m256i vblk = _mm256_set1_epi32(block);
          const __m256i vzero = _mm256_setzero_si256();
          int32_t chain_in = block;
          __m256i vrow = _mm256_set1_epi32(INT32_MIN / 2);
          for (int32_t b = 0; b < width; b += 8) {
            const __m256i w = _mm256_cvtepi8_epi32(
                _mm_loadl_epi64(reinterpret_cast<const __m128i*>(w0 + b)));
            __m256i s = _mm256_blendv_epi8(vmis, vmatch,
                                           _mm256_cmpeq_epi32(w, vr));
            s = _mm256_blendv_epi8(s, vblk, _mm256_cmpeq_epi32(w, vpad));
            const __m256i hd = _mm256_loadu_si256(
                reinterpret_cast<const __m256i*>(H.data() + b));
            const __m256i hu = _mm256_loadu_si256(
                reinterpret_cast<const __m256i*>(H.data() + b + 1));
            __m256i c = _mm256_max_epi32(_mm256_add_epi32(hd, s),
                                         _mm256_add_epi32(hu, vgap));
            c = _mm256_max_epi32(c, vzero);
            // in-block max-plus prefix: shift by 1, 2, 4 int32 lanes
            const __m256i lo = _mm256_permute2x128_si256(c, c, 0x08);
            __m256i t = _mm256_alignr_epi8(c, lo, 12);
            c = _mm256_max_epi32(c, _mm256_add_epi32(t, vgap));
            const __m256i lo2 = _mm256_permute2x128_si256(c, c, 0x08);
            t = _mm256_alignr_epi8(c, lo2, 8);
            c = _mm256_max_epi32(
                c, _mm256_add_epi32(t, _mm256_slli_epi32(vgap, 1)));
            t = _mm256_permute2x128_si256(c, c, 0x08);
            c = _mm256_max_epi32(
                c, _mm256_add_epi32(t, _mm256_slli_epi32(vgap, 2)));
            // carry across blocks: chain_in + (u+1)*gap
            c = _mm256_max_epi32(
                c, _mm256_add_epi32(_mm256_set1_epi32(chain_in), vramp));
            _mm256_storeu_si256(reinterpret_cast<__m256i*>(H.data() + b), c);
            chain_in = _mm256_extract_epi32(c, 7);
            vrow = _mm256_max_epi32(vrow, c);  // deferred row max
          }
          // ONE horizontal reduction per row; the first-argmax scan of
          // the stored row only runs when the row actually improves the
          // running best (rare), replacing 6 shuffles per block
          __m256i m = _mm256_max_epi32(
              vrow, _mm256_permute2x128_si256(vrow, vrow, 0x01));
          m = _mm256_max_epi32(m, _mm256_shuffle_epi32(m, 0x4E));
          m = _mm256_max_epi32(m, _mm256_shuffle_epi32(m, 0xB1));
          const int32_t row_best = _mm256_extract_epi32(m, 0);
          if (row_best > best) {
            int32_t ru = 0;
            while (H[ru] != row_best) ru++;  // first argmax in this row
            best = row_best;
            bi = static_cast<int32_t>(i);
            bj = static_cast<int32_t>(j0 + ru);
            bu = ru;
          }
#else
          for (int32_t u = 0; u < width; u++) {
            const int32_t win = w0[u];
            const int32_t s = (win == pad_code)
                                  ? block
                                  : ((win < 4 && r == win) ? match
                                                           : mismatch);
            const int32_t up =
                ((u + 1 < width) ? H[u + 1] : block) + gap;
            int32_t c = H[u] + s;
            if (up > c) c = up;
            if (c < 0) c = 0;
            C[u] = c;
          }
          int32_t chain = block;
          int32_t row_best = -1, row_u = 0;
          for (int32_t u = 0; u < width; u++) {
            chain = std::max(chain + gap, C[u]);
            H[u] = chain;
            if (chain > row_best) {
              row_best = chain;
              row_u = u;
            }
          }
          if (row_best > best) {
            best = row_best;
            bi = static_cast<int32_t>(i);
            bj = static_cast<int32_t>(j0 + row_u);
            bu = row_u;
          }
#endif
          continue;
        }
        // c[u] = max(0, diag, up), zeroed outside the path
        for (int32_t u = 0; u < width; u++) {
          const int64_t j = j0 + u;
          const int32_t win =
              (j >= 1 && j <= lp) ? pa[j - 1] : pad_code;
          const int32_t s =
              (r == pad_code || win == pad_code)
                  ? block
                  : ((r < 4 && win < 4 && r == win) ? match : mismatch);
          const int32_t up =
              ((u + 1 < width) ? H[u + 1] : block) + gap;
          int32_t c = H[u] + s;
          if (up > c) c = up;
          if (c < 0) c = 0;
          if (j < 1 || j > lp) c = 0;
          C[u] = c;
        }
        // horizontal max-plus chain + row best (first argmax)
        int32_t chain = block;
        int32_t row_best = -1, row_u = 0;
        for (int32_t u = 0; u < width; u++) {
          const int64_t j = j0 + u;
          chain = std::max(chain + gap, C[u]);
          const int32_t h = (j >= 1 && j <= lp) ? chain : 0;
          H[u] = h;
          if (h > row_best) {
            row_best = h;
            row_u = u;
          }
        }
        if (row_best > best) {
          best = row_best;
          bi = static_cast<int32_t>(i);
          bj = static_cast<int32_t>(j0 + row_u);
          bu = row_u;
        }
      }
      const bool ok = best > 0;
      out_best[n] = ok ? best : 0;
      out_bi[n] = ok ? bi : 0;
      out_bj[n] = ok ? bj : 0;
      out_edge[n] = (ok && (bu <= 0 || bu >= width - 1)) ? 1 : 0;
    }
  };
  unsigned hw = g_max_threads > 0 ? static_cast<unsigned>(g_max_threads)
                                  : allowed_cpus();
  int64_t nt = std::max<int64_t>(
      1, std::min<int64_t>(static_cast<int64_t>(hw), n_pairs));
  if (nt <= 1) {
    run(0, n_pairs);
    return;
  }
  std::vector<std::thread> th;
  for (int64_t w = 0; w < nt; w++)
    th.emplace_back(run, n_pairs * w / nt, n_pairs * (w + 1) / nt);
  for (auto& x : th) x.join();
}

// k-mer postings index build: rolling-hash scan over the concatenated
// oriented-segment code blocks, then a STABLE two-pass LSD radix sort by
// k-mer code (stability preserves the per-block ascending-offset posting
// order the Python dict/loop builds produced).  Two-call protocol: with
// kmers == NULL returns the posting count; the second call fills the
// caller-allocated arrays.  k <= 15 (30-bit codes); code >= 4 (N)
// invalidates every window containing it.  The numpy one-pass build cost
// ~375 s / 11.5 GB at 168M postings on this box; this runs in ~20 s.
// sample_thresh > 0 keeps only k-mers whose 32-bit Fibonacci hash falls
// below the threshold (deterministic ~thresh/2^32 subsampling; 0 = all).
int64_t kmer_index_build(const int8_t* codes, int64_t n_codes,
                         const int64_t* starts, const int64_t* lens,
                         int64_t n_blocks, int32_t k, uint32_t sample_thresh,
                         int32_t* kmers, int32_t* blks, int32_t* offs) {
  if (k < 1 || k > 15 || n_codes < 0) return -1;
  const int64_t mask = (int64_t(1) << (2 * k)) - 1;
  const uint32_t mult = 2654435761u;  // Knuth/Fibonacci mix
  auto keep = [&](int64_t kk) {
    return sample_thresh == 0 ||
           static_cast<uint32_t>(static_cast<uint32_t>(kk) * mult) <
               sample_thresh;
  };
  unsigned hw = g_max_threads > 0 ? static_cast<unsigned>(g_max_threads)
                                  : allowed_cpus();
  int64_t nt = std::max<int64_t>(1, std::min<int64_t>(hw, n_blocks));
  auto count_range = [&](int64_t b0, int64_t b1) -> int64_t {
    int64_t total = 0;
    for (int64_t b = b0; b < b1; b++) {
      const int8_t* s = codes + starts[b];
      const int64_t L = lens[b];
      int64_t bad = -1;  // last index with code >= 4
      int64_t kk = 0;
      for (int64_t i = 0; i < L; i++) {
        const int8_t c = s[i];
        if (c >= 4) bad = i;
        kk = ((kk << 2) | (c & 3)) & mask;
        if (i >= k - 1 && bad <= i - k && keep(kk)) total++;
      }
    }
    return total;
  };
  std::vector<int64_t> range_tot(static_cast<size_t>(nt), 0);
  {
    std::vector<std::thread> th;
    for (int64_t w = 0; w < nt; w++) {
      th.emplace_back([&, w] {
        range_tot[w] = count_range(n_blocks * w / nt,
                                   n_blocks * (w + 1) / nt);
      });
    }
    for (auto& x : th) x.join();
  }
  if (kmers == nullptr) {
    int64_t total = 0;
    for (int64_t v : range_tot) total += v;
    return total;
  }
  // fill pass, threaded over the same block ranges
  std::vector<int64_t> range_base(static_cast<size_t>(nt), 0);
  for (int64_t w = 1; w < nt; w++)
    range_base[w] = range_base[w - 1] + range_tot[w - 1];
  {
    std::vector<std::thread> th;
    for (int64_t w = 0; w < nt; w++) {
      th.emplace_back([&, w] {
        int64_t tt = range_base[w];
        for (int64_t b = n_blocks * w / nt; b < n_blocks * (w + 1) / nt;
             b++) {
          const int8_t* s = codes + starts[b];
          const int64_t L = lens[b];
          int64_t bad = -1;
          int64_t kk = 0;
          for (int64_t i = 0; i < L; i++) {
            const int8_t c = s[i];
            if (c >= 4) bad = i;
            kk = ((kk << 2) | (c & 3)) & mask;
            if (i >= k - 1 && bad <= i - k && keep(kk)) {
              kmers[tt] = static_cast<int32_t>(kk);
              blks[tt] = static_cast<int32_t>(b);
              offs[tt] = static_cast<int32_t>(i - k + 1);
              tt++;
            }
          }
        }
      });
    }
    for (auto& x : th) x.join();
  }
  int64_t t = range_base[nt - 1] + range_tot[nt - 1];
  // stable LSD radix by k-mer: pack (code << 34 | posting id) into uint64
  // and sort in two 15-bit passes; then apply the permutation
  const int64_t T = t;
  std::vector<uint64_t> a(static_cast<size_t>(T)), tmp(static_cast<size_t>(T));
  for (int64_t i = 0; i < T; i++)
    a[i] = (static_cast<uint64_t>(static_cast<uint32_t>(kmers[i])) << 34) |
           static_cast<uint64_t>(i);
  const int bits = 2 * k;
  const int half = (bits + 1) / 2;
  const int shifts[2] = {34, 34 + half};
  const int widths[2] = {half, bits - half};
  for (int pass = 0; pass < 2; pass++) {
    if (widths[pass] <= 0) break;
    const int w = widths[pass];
    const int sh = shifts[pass];
    const uint64_t m = (uint64_t(1) << w) - 1;
    std::vector<int64_t> hist(static_cast<size_t>(1) << w, 0);
    for (int64_t i = 0; i < T; i++) hist[(a[i] >> sh) & m]++;
    int64_t run = 0;
    for (size_t h = 0; h < hist.size(); h++) {
      const int64_t c = hist[h];
      hist[h] = run;
      run += c;
    }
    for (int64_t i = 0; i < T; i++) tmp[hist[(a[i] >> sh) & m]++] = a[i];
    a.swap(tmp);
  }
  tmp.clear();
  tmp.shrink_to_fit();
  // apply permutation out-of-place into scratch, then copy back
  // (i-range threaded; the random-index gathers are the memory-bound tail)
  const uint64_t pid_mask = (uint64_t(1) << 34) - 1;
  std::vector<int32_t> sk(static_cast<size_t>(T));
  for (int32_t* arr : {kmers, blks, offs}) {
    std::vector<std::thread> th;
    for (int64_t w = 0; w < nt; w++) {
      th.emplace_back([&, w, arr] {
        for (int64_t i = T * w / nt; i < T * (w + 1) / nt; i++)
          sk[i] = arr[a[i] & pid_mask];
      });
    }
    for (auto& x : th) x.join();
    std::memcpy(arr, sk.data(), static_cast<size_t>(T) * 4);
  }
  return T;
}

void gfalign_free(void* p) { std::free(p); }

// Per-read anchor voting over the CSR k-mer postings — the align-mode
// seeding hot loop (engine/seeding.anchors_with_diag_batch semantics,
// bit-exact: rank order (-votes, (sid, orient)), best-diag tie-breaks
// (max run count, then min |diag|, then min diag), and the vote-tie cap
// extension).  The numpy pipeline (searchsorted + lexsort over tens of
// millions of hits) cost ~8.6 ms/read at 1k-segment scale; this is a
// threaded binary search + per-read sort of a few thousand hits.
// Outputs are malloc'd (caller frees each with gfalign_free); out_roff
// has n_reads + 1 entries.  Returns 0, or -1 on bad input.
int32_t anchor_votes(
    const int32_t* uniq, const int64_t* csr_starts, int64_t n_uniq,
    const int32_t* sids, const int8_t* orients, const int32_t* offs,
    const int8_t* read_codes, const int64_t* read_off, int64_t n_reads,
    int32_t k, int32_t max_anchors,
    int32_t** out_sid, int8_t** out_or, int64_t** out_diag,
    int64_t** out_votes, int64_t** out_roff, int64_t** out_dropped) {
  if (k < 1 || k > 15 || n_reads < 0 || max_anchors < 0) return -1;
  const int64_t mask = (int64_t(1) << (2 * k)) - 1;
  struct Anchor {
    int64_t akey, votes, best_diag, best_cnt;
  };
  std::vector<std::vector<Anchor>> per_read(static_cast<size_t>(n_reads));
  std::vector<int64_t> dropped(static_cast<size_t>(n_reads), 0);
  unsigned hw = g_max_threads > 0 ? static_cast<unsigned>(g_max_threads)
                                  : allowed_cpus();
  int64_t nt = std::max<int64_t>(
      1, std::min<int64_t>(static_cast<int64_t>(hw), n_reads));
  auto worker = [&](int64_t r0, int64_t r1) {
    std::vector<std::pair<int64_t, int64_t>> hits;  // (akey, diag)
    for (int64_t r = r0; r < r1; r++) {
      hits.clear();
      const int8_t* s = read_codes + read_off[r];
      const int64_t L = read_off[r + 1] - read_off[r];
      int64_t kk = 0, bad = -1;
      for (int64_t i = 0; i < L; i++) {
        const int8_t c = s[i];
        if (c >= 4) bad = i;
        kk = ((kk << 2) | (c & 3)) & mask;
        if (i < k - 1 || bad > i - k) continue;
        const int32_t code = static_cast<int32_t>(kk);
        const int32_t* it = std::lower_bound(uniq, uniq + n_uniq, code);
        if (it == uniq + n_uniq || *it != code) continue;
        const int64_t u = it - uniq;
        const int64_t pos = i - (k - 1);
        for (int64_t t = csr_starts[u]; t < csr_starts[u + 1]; t++)
          hits.emplace_back(static_cast<int64_t>(sids[t]) * 2 + orients[t],
                            static_cast<int64_t>(offs[t]) - pos);
      }
      if (hits.empty()) continue;
      std::sort(hits.begin(), hits.end());
      std::vector<Anchor>& anchors = per_read[r];
      size_t i = 0;
      while (i < hits.size()) {
        size_t j = i;
        while (j < hits.size() && hits[j] == hits[i]) j++;
        const int64_t akey = hits[i].first, diag = hits[i].second;
        const int64_t cnt = static_cast<int64_t>(j - i);
        if (anchors.empty() || anchors.back().akey != akey) {
          anchors.push_back(Anchor{akey, cnt, diag, cnt});
        } else {
          Anchor& a = anchors.back();
          a.votes += cnt;
          const int64_t ad = std::llabs(diag), bd = std::llabs(a.best_diag);
          if (cnt > a.best_cnt ||
              (cnt == a.best_cnt &&
               (ad < bd || (ad == bd && diag < a.best_diag)))) {
            a.best_cnt = cnt;
            a.best_diag = diag;
          }
        }
        i = j;
      }
      std::sort(anchors.begin(), anchors.end(),
                [](const Anchor& x, const Anchor& y) {
                  if (x.votes != y.votes) return x.votes > y.votes;
                  return x.akey < y.akey;
                });
      size_t cut = std::min<size_t>(max_anchors, anchors.size());
      while (cut > 0 && cut < anchors.size() &&
             anchors[cut].votes == anchors[cut - 1].votes)
        cut++;
      dropped[r] = static_cast<int64_t>(anchors.size() - cut);
      anchors.resize(cut);
    }
  };
  {
    std::vector<std::thread> th;
    for (int64_t w = 0; w < nt; w++)
      th.emplace_back(worker, n_reads * w / nt, n_reads * (w + 1) / nt);
    for (auto& x : th) x.join();
  }
  int64_t total = 0;
  for (const auto& v : per_read) total += static_cast<int64_t>(v.size());
  int64_t* roff =
      static_cast<int64_t*>(std::malloc((n_reads + 1) * sizeof(int64_t)));
  int32_t* o_sid = static_cast<int32_t*>(std::malloc(
      std::max<int64_t>(1, total) * sizeof(int32_t)));
  int8_t* o_or = static_cast<int8_t*>(std::malloc(
      std::max<int64_t>(1, total) * sizeof(int8_t)));
  int64_t* o_diag = static_cast<int64_t*>(std::malloc(
      std::max<int64_t>(1, total) * sizeof(int64_t)));
  int64_t* o_votes = static_cast<int64_t*>(std::malloc(
      std::max<int64_t>(1, total) * sizeof(int64_t)));
  int64_t* o_drop =
      static_cast<int64_t*>(std::malloc(
          std::max<int64_t>(1, n_reads) * sizeof(int64_t)));
  if (!roff || !o_sid || !o_or || !o_diag || !o_votes || !o_drop) {
    std::free(roff); std::free(o_sid); std::free(o_or);
    std::free(o_diag); std::free(o_votes); std::free(o_drop);
    return -1;
  }
  int64_t p = 0;
  for (int64_t r = 0; r < n_reads; r++) {
    roff[r] = p;
    for (const Anchor& a : per_read[r]) {
      o_sid[p] = static_cast<int32_t>(a.akey / 2);
      o_or[p] = static_cast<int8_t>(a.akey % 2);
      o_diag[p] = a.best_diag;
      o_votes[p] = a.votes;
      p++;
    }
    o_drop[r] = dropped[r];
  }
  roff[n_reads] = p;
  *out_sid = o_sid;
  *out_or = o_or;
  *out_diag = o_diag;
  *out_votes = o_votes;
  *out_roff = roff;
  *out_dropped = o_drop;
  return 0;
}

// diagnostics: (total blocked seconds in shm waits, wait count) since the
// last call; resets on read
void search_wait_stats(double* wait_s, int64_t* waits) {
  *wait_s = 1e-9 * static_cast<double>(
      search_impl::g_shm_wait_ns.exchange(0, std::memory_order_relaxed));
  *waits = search_impl::g_shm_waits.exchange(0, std::memory_order_relaxed);
}

// Per-process profile split of search_native time since the last call:
// total driver time, scoring (eval_one) time, ring-wait time + count.
// commit/walk time = total - eval - wait (the replicated serial part —
// the Amdahl term of thin-workload scaling).  Counters reset on read.
void search_profile(double* total_s, double* eval_s, double* wait_s,
                    int64_t* waits) {
  *total_s = 1e-9 * static_cast<double>(
      search_impl::g_run_ns.exchange(0, std::memory_order_relaxed));
  *eval_s = 1e-9 * static_cast<double>(
      search_impl::g_eval_ns.exchange(0, std::memory_order_relaxed));
  search_wait_stats(wait_s, waits);
}

// Banded variant of seq_local_traceback: recompute only the band
// H[i][j], j = i + delta - width/2 + u (the same band ops/seqalign.py's
// _banded_forward scored on device), then walk back from (end_i, end_j).
// O(end_i * width) instead of O(end_i * end_j).
//
// PARITY GATES (banded H <= full H even in-band, so walk decisions can
// diverge from the full matrix): the walk is only trusted when
//   (a) the banded end-cell value equals `expected` (the device/full score);
//   (b) the walk never touches a band-edge lane (u == 0 or width-1) while
//       its score is positive.
// Any gate failure returns -2 and the caller falls back to the full-matrix
// seq_local_traceback.  Returns n_ops >= 0 on success, -1 on bad input.
int64_t seq_banded_traceback(const int8_t* read, int64_t lr, const int8_t* path,
                             int64_t lp, int64_t end_i, int64_t end_j,
                             int64_t delta, int32_t width, int32_t expected,
                             int32_t match, int32_t mismatch, int32_t gap,
                             int32_t pad_code, int32_t block, int32_t* out5,
                             char* ops, int64_t ops_cap) {
  if (end_i < 0 || end_j < 0 || end_i > lr || end_j > lp || width < 4)
    return -1;
  const int64_t W2 = width / 2;
  const int64_t u_end = end_j - end_i - delta + W2;
  if (u_end <= 0 || u_end >= width - 1) return -2;  // end at/off band edge
  // stride carries a permanent `block` sentinel column at [width] so the
  // vector 'up' load of the last block never reads the NEXT row's lane 0
  // (rows are contiguous); scalar rows use the explicit branch instead.
  const size_t Wz = static_cast<size_t>(width) + 8;
  std::vector<int32_t> H(static_cast<size_t>(end_i + 1) * Wz, 0);
  for (int64_t i = 0; i <= end_i; i++) H[i * Wz + width] = block;
#ifdef __AVX2__
  const __m256i vgap = _mm256_set1_epi32(gap);
  const __m256i vramp = _mm256_mullo_epi32(
      _mm256_setr_epi32(1, 2, 3, 4, 5, 6, 7, 8), vgap);
  const __m256i vpad = _mm256_set1_epi32(pad_code);
  const __m256i vmatch = _mm256_set1_epi32(match);
  const __m256i vmis = _mm256_set1_epi32(mismatch);
  const __m256i vblk = _mm256_set1_epi32(block);
  const __m256i vzero = _mm256_setzero_si256();
#endif
  for (int64_t i = 1; i <= end_i; i++) {
    const int32_t rc = read[i - 1];
    const int32_t* prev = H.data() + (i - 1) * Wz;
    int32_t* cur = H.data() + i * Wz;
    const int64_t j0 = i + delta - W2;
#ifdef __AVX2__
    if (j0 >= 1 && j0 + width - 1 <= lp && rc < 4) {
      // interior row: same fused AVX2 pass as seq_banded_pairs, except
      // the chain seeds at 0 (the leading 0 of this fill's prefix scan).
      // The in-block shifted-in zeros contribute 0 + d*gap with
      // d >= u + 1, which the 0-seed carry (0 + (u+1)*gap) dominates —
      // so the same kernel is exact here too.
      const int8_t* w0 = path + (j0 - 1);
      const __m256i vr = _mm256_set1_epi32(rc);
      int32_t chain_in = 0;
      for (int32_t b = 0; b < width; b += 8) {
        const __m256i w = _mm256_cvtepi8_epi32(
            _mm_loadl_epi64(reinterpret_cast<const __m128i*>(w0 + b)));
        __m256i s = _mm256_blendv_epi8(vmis, vmatch,
                                       _mm256_cmpeq_epi32(w, vr));
        s = _mm256_blendv_epi8(s, vblk, _mm256_cmpeq_epi32(w, vpad));
        const __m256i hd = _mm256_loadu_si256(
            reinterpret_cast<const __m256i*>(prev + b));
        const __m256i hu = _mm256_loadu_si256(
            reinterpret_cast<const __m256i*>(prev + b + 1));
        __m256i c = _mm256_max_epi32(_mm256_add_epi32(hd, s),
                                     _mm256_add_epi32(hu, vgap));
        c = _mm256_max_epi32(c, vzero);
        const __m256i lo = _mm256_permute2x128_si256(c, c, 0x08);
        __m256i t = _mm256_alignr_epi8(c, lo, 12);
        c = _mm256_max_epi32(c, _mm256_add_epi32(t, vgap));
        const __m256i lo2 = _mm256_permute2x128_si256(c, c, 0x08);
        t = _mm256_alignr_epi8(c, lo2, 8);
        c = _mm256_max_epi32(
            c, _mm256_add_epi32(t, _mm256_slli_epi32(vgap, 1)));
        t = _mm256_permute2x128_si256(c, c, 0x08);
        c = _mm256_max_epi32(
            c, _mm256_add_epi32(t, _mm256_slli_epi32(vgap, 2)));
        c = _mm256_max_epi32(
            c, _mm256_add_epi32(_mm256_set1_epi32(chain_in), vramp));
        _mm256_storeu_si256(reinterpret_cast<__m256i*>(cur + b), c);
        chain_in = _mm256_extract_epi32(c, 7);
      }
      continue;
    }
#endif
    int32_t left = 0;  // chain seed: leading 0 of the prefix scan
    for (int64_t u = 0; u < width; u++) {
      const int64_t j = j0 + u;
      if (j < 1 || j > lp) {
        cur[u] = 0;
        left = 0;
        continue;
      }
      const int32_t pc = path[j - 1];
      const int32_t sub = (rc == pad_code || pc == pad_code)
                              ? block
                              : ((rc < 4 && pc < 4 && rc == pc) ? match
                                                                : mismatch);
      int32_t c = prev[u] + sub;                       // diag keeps its lane
      const int32_t up =
          (u + 1 < width ? prev[u + 1] : block) + gap;  // read-gap shifts +1
      if (up > c) c = up;
      if (c < 0) c = 0;
      const int32_t chained = left + gap;
      cur[u] = chained > c ? chained : c;
      left = cur[u];
    }
  }
  int64_t i = end_i, u = u_end;
  const int32_t end_val = H[i * Wz + u];
  if (end_val != expected) return -2;  // banded end != device score
  out5[0] = end_val;
  int64_t n_ops = 0;
  int32_t matches = 0, nm = 0;
  while (i > 0 && H[i * Wz + u] > 0) {
    if (u <= 0 || u >= width - 1) return -2;  // walk touched the band edge
    const int64_t j = i + delta - W2 + u;
    if (j <= 0) break;
    const int32_t rc = read[i - 1];
    const int32_t sub = (rc == path[j - 1] && rc < 4) ? match : mismatch;
    const int32_t h = H[i * Wz + u];
    char op;
    if (h == H[(i - 1) * Wz + u] + sub) {
      op = sub == match ? '=' : 'X';
      if (sub == match) matches++; else nm++;
      i--;                       // diag: same lane
    } else if (h == H[(i - 1) * Wz + (u + 1)] + gap) {
      op = 'I'; nm++; i--; u++;  // read gap
    } else if (h == H[i * Wz + (u - 1)] + gap) {
      op = 'D'; nm++; u--;       // path gap
    } else {
      break;  // local start (c floored at 0 mid-row)
    }
    if (n_ops >= ops_cap) return -1;
    ops[n_ops++] = op;
  }
  if (u <= 0 || u >= width - 1) return -2;  // start cell on the band edge
  for (int64_t a = 0, b = n_ops - 1; a < b; a++, b--) {
    char t = ops[a]; ops[a] = ops[b]; ops[b] = t;
  }
  const int64_t j = i + delta - W2 + u;
  out5[1] = static_cast<int32_t>(i);  // qstart
  out5[2] = static_cast<int32_t>(j < 0 ? 0 : j);  // pstart
  out5[3] = matches;
  out5[4] = nm;
  return n_ops;
}

}  // extern "C"
