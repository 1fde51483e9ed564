// faceformer_tpu_torch host data loader.
//
// The reference preloads every dataset JSON into RAM with Python json.load
// and re-packs samples in DataLoader worker processes (reference
// faceformer/datasets/data.py:48-51, trainer.py:33). Here the whole
// load-parse-resample-pack pipeline runs as one threaded C++ pass over the
// file list, emitting the final static-shape arrays the device consumes:
//   input      (N, L, P, 2) float32   resampled edge polylines
//   input_mask (N, L)       uint8     True (1) = padded row
//   num_input  (N,)         int32
//   label      (N, T) or (N, L, T) int32  packed token grid
//   num_label  (N,)         int32    num_label (single) / num_faces (parallel)
//
// Packing semantics mirror faceformer_tpu_torch/data/packing.py exactly (which in
// turn mirrors reference data.py:71-92 and data_para.py:71-98), including
// the direction-token flavor's [idx+len, DIR0+orient] interleave and the
// parallel packer's by-value `lp != loop` other-loop exclusion.
//
// JSON subset parsed: objects, arrays, numbers, strings, true/false/null —
// everything the sample schema uses. Only "edges" and "faces_indices" are
// materialized; other keys are skipped without building a DOM.
//
// Build: faceformer_tpu_torch/ops/_build.py, at first use (linked with
// geometry_kernel.cc into build/faceformer_tpu_torch/libfaceformer_host.so).

#include <atomic>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

// from geometry_kernel.cc (same .so): the parity-tested resampler
extern "C" void resample_edges(const double* points, const int64_t* offsets,
                               int64_t num_edges, int64_t num_samples,
                               float* out);

namespace {

// ---------------------------------------------------------------------------
// minimal JSON
// ---------------------------------------------------------------------------

struct Value {
  // kind: 0 = number, 1 = array, 2 = other (string/bool/null/object)
  uint8_t kind = 2;
  double num = 0.0;
  std::vector<Value> arr;
  bool is_num() const { return kind == 0; }
  bool is_arr() const { return kind == 1; }
};

// Locale-independent double parse (std::strtod honors LC_NUMERIC: under a
// comma-decimal locale "1.5" parses as 1 and the parser then errors,
// silently dropping the native fast path). Returns the end pointer, or
// `begin` on failure (the strtod convention the call sites test for).
inline const char* parse_number(const char* begin, const char* end,
                                double* out) {
  const auto res = std::from_chars(begin, end, *out);
  return res.ec == std::errc() ? res.ptr : begin;
}

struct Parser {
  const char* p;
  const char* end;
  std::string err;

  void skip_ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
      ++p;
  }

  bool fail(const char* msg) {
    if (err.empty()) err = msg;
    return false;
  }

  bool skip_string() {
    ++p;  // opening quote
    while (p < end) {
      if (*p == '\\') {
        p += 2;
        continue;
      }
      if (*p == '"') {
        ++p;
        return true;
      }
      ++p;
    }
    return fail("unterminated string");
  }

  bool parse_string(std::string* out) {
    ++p;
    out->clear();
    while (p < end) {
      if (*p == '\\') {  // keep escapes verbatim; keys here never use them
        if (p + 1 < end) out->push_back(p[1]);
        p += 2;
        continue;
      }
      if (*p == '"') {
        ++p;
        return true;
      }
      out->push_back(*p++);
    }
    return fail("unterminated string");
  }

  // skip any value without building a DOM
  bool skip_value() {
    skip_ws();
    if (p >= end) return fail("unexpected end");
    char c = *p;
    if (c == '"') return skip_string();
    if (c == '{' || c == '[') {
      char open = c, close = (c == '{') ? '}' : ']';
      int depth = 0;
      while (p < end) {
        if (*p == '"') {
          if (!skip_string()) return false;
          continue;
        }
        if (*p == open) ++depth;
        if (*p == close) {
          --depth;
          if (depth == 0) {
            ++p;
            return true;
          }
        }
        ++p;
      }
      return fail("unbalanced brackets");
    }
    // number / true / false / null
    while (p < end && *p != ',' && *p != ']' && *p != '}' && *p != ' ' &&
           *p != '\n' && *p != '\t' && *p != '\r')
      ++p;
    return true;
  }

  bool parse_value(Value* out) {
    skip_ws();
    if (p >= end) return fail("unexpected end");
    char c = *p;
    if (c == '[') {
      ++p;
      out->kind = 1;
      skip_ws();
      if (p < end && *p == ']') {
        ++p;
        return true;
      }
      while (true) {
        out->arr.emplace_back();
        if (!parse_value(&out->arr.back())) return false;
        skip_ws();
        if (p < end && *p == ',') {
          ++p;
          continue;
        }
        if (p < end && *p == ']') {
          ++p;
          return true;
        }
        return fail("expected , or ] in array");
      }
    }
    if (c == '-' || (c >= '0' && c <= '9')) {
      out->kind = 0;
      const char* q = parse_number(p, end, &out->num);
      if (q == p) return fail("bad number");
      p = q;
      return true;
    }
    out->kind = 2;
    return skip_value();
  }
};

// edges parsed straight into flat buffers (points + offsets), skipping the
// generic DOM — they are ~90% of the bytes and the per-point Value
// allocations dominate parse time otherwise
struct FlatEdges {
  std::vector<double> pts;       // x0,y0,x1,y1,...
  std::vector<int64_t> offsets;  // edge i spans points [offsets[i], offsets[i+1])
};

bool parse_edges_flat(Parser* ps, FlatEdges* out) {
  ps->skip_ws();
  if (ps->p >= ps->end || *ps->p != '[') return ps->fail("edges: expected [");
  ++ps->p;
  out->pts.clear();
  out->offsets.clear();
  out->offsets.push_back(0);
  ps->skip_ws();
  if (ps->p < ps->end && *ps->p == ']') {
    ++ps->p;
    return true;
  }
  while (true) {  // one edge: [ [x,y], ... ]
    ps->skip_ws();
    if (ps->p >= ps->end || *ps->p != '[')
      return ps->fail("edge: expected [");
    ++ps->p;
    ps->skip_ws();
    if (ps->p < ps->end && *ps->p != ']') {
      while (true) {  // one point: [x,y]
        ps->skip_ws();
        if (ps->p >= ps->end || *ps->p != '[')
          return ps->fail("point: expected [");
        ++ps->p;
        ps->skip_ws();
        double x = 0.0, y = 0.0;
        const char* q = parse_number(ps->p, ps->end, &x);
        if (q == ps->p) return ps->fail("point: bad x");
        ps->p = q;
        ps->skip_ws();
        if (ps->p >= ps->end || *ps->p != ',')
          return ps->fail("point: expected ,");
        ++ps->p;
        ps->skip_ws();
        q = parse_number(ps->p, ps->end, &y);
        if (q == ps->p) return ps->fail("point: bad y");
        ps->p = q;
        ps->skip_ws();
        // tolerate >2 coords per point (truncate like numpy [:, :2])
        while (ps->p < ps->end && *ps->p == ',') {
          ++ps->p;
          ps->skip_ws();
          double extra;
          q = parse_number(ps->p, ps->end, &extra);
          if (q == ps->p) return ps->fail("point: bad extra coord");
          ps->p = q;
          ps->skip_ws();
        }
        if (ps->p >= ps->end || *ps->p != ']')
          return ps->fail("point: expected ]");
        ++ps->p;
        out->pts.push_back(x);
        out->pts.push_back(y);
        ps->skip_ws();
        if (ps->p < ps->end && *ps->p == ',') {
          ++ps->p;
          continue;
        }
        break;
      }
      ps->skip_ws();
    }
    if (ps->p >= ps->end || *ps->p != ']')
      return ps->fail("edge: expected ]");
    ++ps->p;
    out->offsets.push_back(static_cast<int64_t>(out->pts.size() / 2));
    ps->skip_ws();
    if (ps->p < ps->end && *ps->p == ',') {
      ++ps->p;
      continue;
    }
    if (ps->p < ps->end && *ps->p == ']') {
      ++ps->p;
      return true;
    }
    return ps->fail("edges: expected , or ]");
  }
}

// parse just {"edges": ..., "faces_indices": ...} from a sample object
bool parse_sample(const char* buf, size_t len, FlatEdges* edges, Value* faces,
                  std::string* err) {
  Parser ps{buf, buf + len, {}};
  ps.skip_ws();
  if (ps.p >= ps.end || *ps.p != '{') {
    *err = "sample is not a JSON object";
    return false;
  }
  ++ps.p;
  ps.skip_ws();
  if (ps.p < ps.end && *ps.p == '}') return true;
  std::string key;
  bool have_edges = false, have_faces = false;
  while (true) {
    ps.skip_ws();
    if (ps.p >= ps.end || *ps.p != '"') {
      *err = "expected object key";
      return false;
    }
    if (!ps.parse_string(&key)) {
      *err = ps.err;
      return false;
    }
    ps.skip_ws();
    if (ps.p >= ps.end || *ps.p != ':') {
      *err = "expected :";
      return false;
    }
    ++ps.p;
    bool ok;
    if (key == "edges") {
      ok = parse_edges_flat(&ps, edges);
      have_edges = ok;
    } else if (key == "faces_indices") {
      ok = ps.parse_value(faces);
      have_faces = ok;
    } else {
      ok = ps.skip_value();
    }
    if (!ok) {
      *err = ps.err.empty() ? "parse error" : ps.err;
      return false;
    }
    ps.skip_ws();
    if (ps.p < ps.end && *ps.p == ',') {
      ++ps.p;
      continue;
    }
    if (ps.p < ps.end && *ps.p == '}') break;
    *err = "expected , or } in object";
    return false;
  }
  if (!have_edges) {
    *err = "missing 'edges'";
    return false;
  }
  if (!have_faces) {
    *err = "missing 'faces_indices'";
    return false;
  }
  return true;
}

// ---------------------------------------------------------------------------
// packing (mirrors faceformer_tpu_torch/data/packing.py)
// ---------------------------------------------------------------------------

struct TokenCfg {
  int32_t len, pad, sos, sep, eos, type_offset, dir0;
};

bool loops_equal(const Value& a, const Value& b) {
  if (a.arr.size() != b.arr.size()) return false;
  for (size_t i = 0; i < a.arr.size(); ++i)
    if (a.arr[i].num != b.arr[i].num) return false;
  return true;
}

// single-sequence label packing (packing.py pack_label_single)
bool pack_single(const Value& faces, const TokenCfg& tok, int32_t T,
                 int32_t* label, int32_t* num_label, std::string* err) {
  for (int32_t i = 0; i < T; ++i) label[i] = tok.pad;
  if (T < 1) {
    *err = "label_seq_length < 1";
    return false;
  }
  label[0] = tok.sos;
  int32_t pos = 0;
  std::vector<int32_t> face_tokens;
  for (const Value& face : faces.arr) {
    if (!face.is_arr()) {
      *err = "face entry is not a list";
      return false;
    }
    face_tokens.clear();
    // direction-token faces: loops of (index, orientation) pairs
    bool is_dir = false;
    if (!face.arr.empty() && face.arr[0].is_arr() &&
        !face.arr[0].arr.empty() && face.arr[0].arr[0].is_arr())
      is_dir = true;
    if (is_dir) {
      for (const Value& loop : face.arr)
        for (const Value& pair : loop.arr) {
          if (!pair.is_arr() || pair.arr.size() < 2 ||
              !pair.arr[0].is_num() || !pair.arr[1].is_num()) {
            *err = "bad (index, orientation) pair";
            return false;
          }
          face_tokens.push_back(static_cast<int32_t>(pair.arr[0].num) +
                                tok.len);
          face_tokens.push_back(tok.dir0 +
                                static_cast<int32_t>(pair.arr[1].num));
        }
    } else if (!face.arr.empty() && face.arr[0].is_arr()) {
      // nested loop lists: flatten
      for (const Value& loop : face.arr) {
        if (!loop.is_arr()) {
          *err = "face mixes loops and scalars";
          return false;
        }
        for (const Value& idx : loop.arr) {
          if (!idx.is_num()) {
            *err = "loop index is not a number";
            return false;
          }
          face_tokens.push_back(static_cast<int32_t>(idx.num) + tok.len);
        }
      }
    } else {
      for (const Value& idx : face.arr) {
        if (!idx.is_num()) {
          *err = "face mixes scalars and lists";
          return false;
        }
        face_tokens.push_back(static_cast<int32_t>(idx.num) + tok.len);
      }
    }
    pos += 1;
    // Python fails here too: the slice write needs pos+len <= T and the
    // SEP write after it needs pos+len < T
    if (pos + static_cast<int32_t>(face_tokens.size()) >= T) {
      *err = "label overflows label_seq_length";
      return false;
    }
    for (size_t k = 0; k < face_tokens.size(); ++k)
      label[pos + static_cast<int32_t>(k)] = face_tokens[k];
    pos += static_cast<int32_t>(face_tokens.size());
    label[pos] = tok.sep;
  }
  label[pos] = tok.eos;  // overwrite the trailing SEP
  *num_label = pos + 1;
  return true;
}

// parallel (per-anchor rotation rows) label packing (pack_label_parallel)
bool pack_parallel(const Value& faces, const TokenCfg& tok, int32_t L,
                   int32_t T, int32_t* label, int32_t* num_faces,
                   std::string* err) {
  for (int32_t i = 0; i < L * T; ++i) label[i] = tok.pad;
  int32_t row = 0;
  std::vector<int32_t> others, seq;
  for (const Value& entry : faces.arr) {
    if (!entry.is_arr() || entry.arr.size() < 2 || !entry.arr[0].is_num() ||
        !entry.arr[1].is_arr()) {
      *err = "face entry is not [type, loops]";
      return false;
    }
    const int32_t ftype = static_cast<int32_t>(entry.arr[0].num);
    const int32_t type_token = (ftype <= 1 ? ftype : 2) + tok.type_offset;
    const Value& loops = entry.arr[1];
    for (const Value& loop : loops.arr) {
      if (!loop.is_arr()) {
        *err = "loop is not a list";
        return false;
      }
      for (const Value& idx : loop.arr)
        if (!idx.is_num()) {
          *err = "loop index is not a number (parallel packing "
                 "needs plain coedge indices)";
          return false;
        }
      // by-value exclusion, matching Python's `lp != loop`
      others.clear();
      for (const Value& lp : loops.arr) {
        if (loops_equal(lp, loop)) continue;
        for (const Value& idx : lp.arr)
          others.push_back(static_cast<int32_t>(idx.num));
      }
      const int32_t n = static_cast<int32_t>(loop.arr.size());
      for (int32_t rot = 0; rot < n; ++rot) {
        // np.roll(loop, rot): result[i] = loop[(i - rot) mod n]
        seq.clear();
        for (int32_t i = 0; i < n; ++i)
          seq.push_back(static_cast<int32_t>(
              loop.arr[static_cast<size_t>(((i - rot) % n + n) % n)].num));
        for (int32_t o : others) seq.push_back(o);
        if (row >= L) {
          *err = "more loop rotations than num_lines -- not coedge data?";
          return false;
        }
        if (static_cast<int32_t>(seq.size()) + 1 > T) {
          *err = "face sequence length exceeds max_face_length";
          return false;
        }
        int32_t* dst = label + row * T;
        for (size_t k = 0; k < seq.size(); ++k) dst[k] = seq[k] + tok.len;
        dst[seq.size()] = type_token;
        ++row;
      }
    }
  }
  // bare Other-type token on unused rows — must match pack_label_parallel's
  // face_type_token(2, tok) (the reference's literal token.len - 1 is only
  // the Other token for its 4-token table; for extended tables len-1 would
  // be a direction token and the Python/native packers would diverge)
  for (int32_t r = row; r < L; ++r) label[r * T] = tok.type_offset + 2;
  *num_faces = static_cast<int32_t>(faces.arr.size());
  return true;
}

struct Job {
  const char* const* paths;
  int64_t n_files;
  int32_t mode;  // 0 single, 1 parallel
  int32_t L, P, T;
  TokenCfg tok;
  float* input_out;
  uint8_t* input_mask_out;
  int32_t* num_input_out;
  int32_t* label_out;
  int32_t* num_label_out;
  uint8_t* ok_out;  // per-file success flags (may be null)
  std::atomic<int64_t> next{0};
  std::atomic<int64_t> failures{0};
  // first error (path: message), guarded by the failure counter being 0->1
  std::string first_err;
  std::atomic<bool> err_set{false};
};

void record_error(Job* job, const char* path, const std::string& msg) {
  job->failures.fetch_add(1);
  bool expected = false;
  if (job->err_set.compare_exchange_strong(expected, true))
    job->first_err = std::string(path) + ": " + msg;
}

void worker(Job* job) {
  std::vector<char> buf;
  while (true) {
    const int64_t i = job->next.fetch_add(1);
    if (i >= job->n_files) return;
    if (job->ok_out) job->ok_out[i] = 0;
    const char* path = job->paths[i];
    FILE* f = std::fopen(path, "rb");
    if (!f) {
      record_error(job, path, "cannot open");
      continue;
    }
    std::fseek(f, 0, SEEK_END);
    const long sz = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    buf.resize(static_cast<size_t>(sz));
    const size_t rd = sz > 0 ? std::fread(buf.data(), 1, buf.size(), f) : 0;
    std::fclose(f);
    if (rd != buf.size()) {
      record_error(job, path, "short read");
      continue;
    }
    FlatEdges edges;
    Value faces;
    std::string err;
    if (!parse_sample(buf.data(), buf.size(), &edges, &faces, &err)) {
      record_error(job, path, err);
      continue;
    }
    if (!faces.is_arr()) {
      record_error(job, path, "faces_indices is not a list");
      continue;
    }
    const int32_t L = job->L, P = job->P, T = job->T;
    const int64_t n_edges =
        static_cast<int64_t>(edges.offsets.size()) - 1;
    if (n_edges > L) {
      record_error(job, path, "edges exceed num_lines");
      continue;
    }
    bool bad = false;
    for (int64_t e = 0; e < n_edges; ++e)
      if (edges.offsets[e + 1] - edges.offsets[e] < 1) bad = true;
    if (bad) {
      record_error(job, path, "empty edge polyline");
      continue;
    }
    float* inp = job->input_out + i * static_cast<int64_t>(L) * P * 2;
    std::memset(inp, 0, sizeof(float) * static_cast<size_t>(L) * P * 2);
    // same resampler the data pipeline's per-sample path uses
    resample_edges(edges.pts.data(), edges.offsets.data(), n_edges, P, inp);
    uint8_t* msk = job->input_mask_out + i * L;
    for (int32_t e = 0; e < L; ++e) msk[e] = (e < n_edges) ? 0 : 1;
    job->num_input_out[i] = static_cast<int32_t>(n_edges);

    bool ok;
    if (job->mode == 0) {
      ok = pack_single(faces, job->tok, T, job->label_out + i * T,
                       job->num_label_out + i, &err);
    } else {
      ok = pack_parallel(faces, job->tok, L, T,
                         job->label_out + i * static_cast<int64_t>(L) * T,
                         job->num_label_out + i, &err);
    }
    if (!ok) {
      record_error(job, path, err);
      continue;
    }
    if (job->ok_out) job->ok_out[i] = 1;
  }
}

}  // namespace

extern "C" {

// ABI handshake: bump together with FACEFORMER_NATIVE_ABI in
// faceformer_tpu_torch/geometry/native.py whenever any extern "C" signature
// changes; the Python side refuses to bind a mismatched library instead
// of calling it with the wrong argument layout.
int64_t faceformer_abi_version() { return 2; }

// Load + parse + resample + pack a list of sample JSON files, threaded.
// mode: 0 = single-sequence (label (N, T)), 1 = parallel (label (N, L, T)).
// Returns the number of failed files (0 = all good); the first failure's
// "path: message" lands in err (err_cap bytes); ok_out (length n_files, may
// be null) gets a per-file success flag so callers can fall back for just
// the failing samples instead of the whole corpus.
int64_t load_pack_files(const char* const* paths, int64_t n_files,
                        int32_t n_threads, int32_t mode, int32_t L, int32_t P,
                        int32_t T, int32_t tok_len, int32_t pad, int32_t sos,
                        int32_t sep, int32_t eos, int32_t type_offset,
                        int32_t dir0, float* input_out,
                        uint8_t* input_mask_out, int32_t* num_input_out,
                        int32_t* label_out, int32_t* num_label_out,
                        uint8_t* ok_out, char* err, int64_t err_cap) {
  Job job;
  job.ok_out = ok_out;
  job.paths = paths;
  job.n_files = n_files;
  job.mode = mode;
  job.L = L;
  job.P = P;
  job.T = T;
  job.tok = TokenCfg{tok_len, pad, sos, sep, eos, type_offset, dir0};
  job.input_out = input_out;
  job.input_mask_out = input_mask_out;
  job.num_input_out = num_input_out;
  job.label_out = label_out;
  job.num_label_out = num_label_out;

  int32_t nt = n_threads;
  if (nt <= 0)
    nt = static_cast<int32_t>(std::thread::hardware_concurrency());
  if (nt < 1) nt = 1;
  if (static_cast<int64_t>(nt) > n_files)
    nt = static_cast<int32_t>(n_files > 0 ? n_files : 1);

  if (nt == 1) {
    worker(&job);
  } else {
    std::vector<std::thread> threads;
    threads.reserve(static_cast<size_t>(nt));
    for (int32_t t = 0; t < nt; ++t) threads.emplace_back(worker, &job);
    for (auto& th : threads) th.join();
  }

  if (job.failures.load() > 0 && err && err_cap > 0) {
    std::snprintf(err, static_cast<size_t>(err_cap), "%s",
                  job.first_err.c_str());
  }
  return job.failures.load();
}

}  // extern "C"
