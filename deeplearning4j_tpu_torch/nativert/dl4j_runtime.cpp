// The port's host runtime: dataset parsers, the async prefetch loader, the
// CSV reader, the stats wire codec, the ingest decoder and the token counter.
//
// The PyTorch port's own copy of the JAX package's native/src/
// dl4j_runtime.cpp (the reference reaches native code through JavaCPP and
// runs its data path through AsyncDataSetIterator, a background prefetch
// thread and a blocking queue). It stages host memory only: IDX
// (MnistDbFile.java's header) and CIFAR-binary parsing, a producer thread
// assembling float32 batches into a bounded queue, a numeric CSV reader
// (DataVec's CSVRecordReader fast path), the binary stats codec (the
// reference's SBE codecs), a batched record decoder and a parallel token
// counter. deeplearning4j_tpu_torch/nativert/__init__.py builds it at first
// use and binds it with ctypes; each entry point has a plain Python version
// there, held bitwise against it by the tests.
//
// One change from the JAX copy: the loader shuffles with its own
// Fisher-Yates over splitmix64 (shuffle_order), where the JAX copy calls
// std::shuffle, whose order depends on the C++ standard library. The
// permutation is then the same for every compiler and for the Python
// version.
//
// C ABI only (consumed via ctypes from Python).

#include <algorithm>
#include <cctype>
#include <fstream>
#include <unordered_map>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// IDX parsing (big-endian header: magic [dtype|ndim], then ndim int32 dims)
// ---------------------------------------------------------------------------

struct IdxFile {
  std::vector<int64_t> dims;
  std::vector<uint8_t> data;  // raw uint8 payload
};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

IdxFile* idx_load(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  uint8_t hdr[4];
  if (std::fread(hdr, 1, 4, f) != 4) { std::fclose(f); return nullptr; }
  uint32_t magic = be32(hdr);
  int dtype = (magic >> 8) & 0xFF;
  int ndim = magic & 0xFF;
  if (dtype != 0x08 || ndim < 1 || ndim > 4) { std::fclose(f); return nullptr; }
  // Sanity-bound the payload by the actual file size so a corrupt header
  // can't trigger an overflowing/teradbyte resize (bad_alloc must not escape
  // the C ABI into the ctypes caller).
  long data_start = std::ftell(f) + 4L * ndim;
  std::fseek(f, 0, SEEK_END);
  long fsize = std::ftell(f);
  std::fseek(f, data_start - 4L * ndim, SEEK_SET);
  int64_t max_total = fsize - data_start;
  auto* out = new IdxFile();
  int64_t total = 1;
  for (int i = 0; i < ndim; i++) {
    uint8_t d[4];
    if (std::fread(d, 1, 4, f) != 4) { std::fclose(f); delete out; return nullptr; }
    int64_t v = int64_t(be32(d));
    out->dims.push_back(v);
    if (v <= 0 || (max_total > 0 && total > max_total / v)) {
      std::fclose(f); delete out; return nullptr;
    }
    total *= v;
  }
  if (total > max_total) { std::fclose(f); delete out; return nullptr; }
  try {
    out->data.resize(size_t(total));
  } catch (const std::bad_alloc&) {
    std::fclose(f); delete out; return nullptr;
  }
  if (std::fread(out->data.data(), 1, size_t(total), f) != size_t(total)) {
    std::fclose(f); delete out; return nullptr;
  }
  std::fclose(f);
  return out;
}

// ---------------------------------------------------------------------------
// Async batch loader: producer thread assembles float32 batches into a
// bounded queue; the consumer blocks in next(). One epoch per run; reset()
// reshuffles and restarts (AsyncDataSetIterator.reset semantics).
// ---------------------------------------------------------------------------

// splitmix64: the generator of the loader's shuffle (a counter-based
// mix, so the Python version draws all of an epoch's numbers at once)
uint64_t splitmix64(uint64_t& state) {
  uint64_t z = (state += 0x9E3779B97F4A7C15ull);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

// Fisher-Yates from the end: position i swaps with draw % (i + 1)
void shuffle_order(std::vector<int64_t>& order, uint64_t seed) {
  uint64_t state = seed;
  for (int64_t i = int64_t(order.size()) - 1; i > 0; i--) {
    int64_t j = int64_t(splitmix64(state) % uint64_t(i + 1));
    std::swap(order[size_t(i)], order[size_t(j)]);
  }
}

struct Batch {
  std::vector<float> x;
  std::vector<float> y;
};

struct Loader {
  // immutable after construction
  std::vector<uint8_t> features;  // [n, feat] uint8
  std::vector<uint8_t> labels;    // [n] uint8 class ids
  int64_t n = 0;
  int64_t feat = 0;
  int num_classes = 10;
  int batch = 0;
  int capacity = 4;
  bool shuffle = true;
  bool normalize = true;
  uint64_t seed = 0;
  uint64_t epoch = 0;

  // queue state
  std::deque<Batch> queue;
  std::mutex mu;
  std::condition_variable cv_put, cv_get;
  bool epoch_done = false;
  std::atomic<bool> stop{false};
  std::thread producer;

  ~Loader() { shutdown(); }

  void shutdown() {
    {
      // Hold the mutex while setting stop so a producer that has evaluated
      // its wait-predicate but not yet re-blocked can't miss the wakeup.
      std::lock_guard<std::mutex> l(mu);
      stop.store(true);
    }
    cv_put.notify_all();
    cv_get.notify_all();
    if (producer.joinable()) producer.join();
  }

  void start_epoch() {
    shutdown();
    stop.store(false);
    {
      std::lock_guard<std::mutex> l(mu);
      queue.clear();
      epoch_done = false;
    }
    producer = std::thread([this] { run_producer(); });
  }

  void run_producer() {
    std::vector<int64_t> order(static_cast<size_t>(n));
    for (int64_t i = 0; i < n; i++) order[size_t(i)] = i;
    if (shuffle) shuffle_order(order, seed + epoch);
    const float scale = normalize ? 1.0f / 255.0f : 1.0f;
    int64_t nb = n / batch;  // drop last partial (reference iterator default)
    for (int64_t b = 0; b < nb && !stop.load(); b++) {
      Batch bt;
      bt.x.resize(size_t(batch) * size_t(feat));
      bt.y.assign(size_t(batch) * size_t(num_classes), 0.0f);
      for (int i = 0; i < batch; i++) {
        int64_t idx = order[size_t(b * batch + i)];
        const uint8_t* src = features.data() + idx * feat;
        float* dst = bt.x.data() + int64_t(i) * feat;
        for (int64_t j = 0; j < feat; j++) dst[j] = float(src[j]) * scale;
        int cls = labels[size_t(idx)];
        if (cls >= 0 && cls < num_classes)
          bt.y[size_t(i) * num_classes + cls] = 1.0f;
      }
      std::unique_lock<std::mutex> l(mu);
      cv_put.wait(l, [this] {
        return stop.load() || int(queue.size()) < capacity;
      });
      if (stop.load()) return;
      queue.push_back(std::move(bt));
      cv_get.notify_one();
    }
    std::lock_guard<std::mutex> l(mu);
    epoch_done = true;
    cv_get.notify_all();
  }

  // 1 = batch written, 0 = epoch exhausted
  int next(float* x_out, float* y_out) {
    std::unique_lock<std::mutex> l(mu);
    cv_get.wait(l, [this] {
      return stop.load() || !queue.empty() || epoch_done;
    });
    if (queue.empty()) return 0;
    Batch bt = std::move(queue.front());
    queue.pop_front();
    cv_put.notify_one();
    l.unlock();
    std::memcpy(x_out, bt.x.data(), bt.x.size() * sizeof(float));
    std::memcpy(y_out, bt.y.data(), bt.y.size() * sizeof(float));
    return 1;
  }
};

// ---------------------------------------------------------------------------
// CSV numeric reader
// ---------------------------------------------------------------------------

struct CsvFile {
  int64_t rows = 0;
  int64_t cols = 0;
  std::vector<float> values;
};

// strict != 0: reject the file (return nullptr) on the first field that is
// empty or not fully numeric, or on a ragged row — the caller then takes its
// general (string-preserving) reader. This makes one native pass both
// validate AND parse, replacing the old Python float()-prevalidation pass
// that read the whole file twice.
CsvFile* csv_load(const char* path, char delim, int skip_lines, int strict) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::string buf(size_t(sz), '\0');
  if (std::fread(buf.data(), 1, size_t(sz), f) != size_t(sz)) {
    std::fclose(f);
    return nullptr;
  }
  std::fclose(f);

  auto* out = new CsvFile();
  size_t pos = 0;
  int line_no = 0;
  while (pos < buf.size()) {
    size_t eol = buf.find('\n', pos);
    if (eol == std::string::npos) eol = buf.size();
    if (line_no++ < skip_lines || eol == pos) { pos = eol + 1; continue; }
    int64_t ncol = 0;
    size_t p = pos;
    while (true) {
      size_t next = buf.find(delim, p);
      size_t fend = (next == std::string::npos || next >= eol) ? eol : next;
      // Null-terminate the field in place so strtof can't scan past it
      // (e.g. steal a number from the next line through the '\n').
      float v = 0.0f;
      bool field_ok = false;
      if (fend > p) {
        char saved = '\0';
        bool restore = fend < buf.size();
        if (restore) { saved = buf[fend]; buf[fend] = '\0'; }
        char* end = nullptr;
        v = std::strtof(buf.data() + p, &end);
        if (end == buf.data() + p) {
          v = 0.0f;  // non-numeric field -> 0 (lenient mode)
        } else {
          // fully consumed modulo trailing whitespace/CR == Python float()
          const char* q = end;
          const char* fe = buf.data() + fend;
          while (q < fe && (*q == ' ' || *q == '\t' || *q == '\r')) q++;
          field_ok = (q == fe);
        }
        if (restore) buf[fend] = saved;
      }
      if (strict && !field_ok) { delete out; return nullptr; }
      out->values.push_back(v);  // empty field (incl. trailing delim) -> 0
      ncol++;
      if (fend == eol) break;
      p = fend + 1;
    }
    if (out->cols == 0) out->cols = ncol;
    if (ncol != out->cols && strict) { delete out; return nullptr; }
    if (ncol < out->cols) {  // ragged short row: pad with zeros
      while (ncol < out->cols) { out->values.push_back(0.0f); ncol++; }
    } else if (ncol > out->cols) {  // ragged long row: truncate
      out->values.resize(out->values.size() - size_t(ncol - out->cols));
    }
    out->rows++;
    pos = eol + 1;
  }
  return out;
}

// ---------------------------------------------------------------------------
// Stats codec — same DLTS wire format as the Python codec in ui/stats.py
// (magic "DLTS", version u16, then length-prefixed strings, packed scalars,
// three sections of named {mean-magnitude, min, max, histogram}).
// ---------------------------------------------------------------------------

struct StatsBuilder {
  std::vector<uint8_t> buf;
  std::vector<std::vector<uint8_t>> sections[3];

  template <typename T>
  static void put(std::vector<uint8_t>& b, T v) {
    const uint8_t* p = reinterpret_cast<const uint8_t*>(&v);
    b.insert(b.end(), p, p + sizeof(T));
  }
  static void put_str(std::vector<uint8_t>& b, const char* s) {
    uint16_t n = uint16_t(std::strlen(s));
    put<uint16_t>(b, n);
    b.insert(b.end(), s, s + n);
  }
};

}  // namespace

extern "C" {

// ----- IDX -----
void* dl4j_idx_open(const char* path) { return idx_load(path); }
int dl4j_idx_ndim(void* h) { return int(static_cast<IdxFile*>(h)->dims.size()); }
void dl4j_idx_dims(void* h, int64_t* out) {
  auto* f = static_cast<IdxFile*>(h);
  for (size_t i = 0; i < f->dims.size(); i++) out[i] = f->dims[i];
}
void dl4j_idx_read(void* h, uint8_t* out) {
  auto* f = static_cast<IdxFile*>(h);
  std::memcpy(out, f->data.data(), f->data.size());
}
void dl4j_idx_close(void* h) { delete static_cast<IdxFile*>(h); }

// ----- async loader -----
void* dl4j_loader_create_from_arrays(const uint8_t* features,
                                     const uint8_t* labels, int64_t n,
                                     int64_t feat, int num_classes, int batch,
                                     int capacity, int shuffle,
                                     uint64_t seed, int normalize) {
  if (n <= 0 || feat <= 0 || batch <= 0 || batch > n) return nullptr;
  auto* l = new Loader();
  l->features.assign(features, features + n * feat);
  l->labels.assign(labels, labels + n);
  l->n = n;
  l->feat = feat;
  l->num_classes = num_classes;
  l->batch = batch;
  l->capacity = std::max(1, capacity);
  l->shuffle = shuffle != 0;
  l->normalize = normalize != 0;
  l->seed = seed;
  l->start_epoch();
  return l;
}

void* dl4j_mnist_loader_create(const char* img_path, const char* lbl_path,
                               int batch, int capacity, int shuffle,
                               uint64_t seed, int normalize) {
  IdxFile* imgs = idx_load(img_path);
  if (!imgs) return nullptr;
  IdxFile* lbls = idx_load(lbl_path);
  if (!lbls) { delete imgs; return nullptr; }
  int64_t n = imgs->dims[0];
  int64_t feat = 1;
  for (size_t i = 1; i < imgs->dims.size(); i++) feat *= imgs->dims[i];
  void* l = nullptr;
  if (lbls->dims.size() == 1 && lbls->dims[0] == n) {
    l = dl4j_loader_create_from_arrays(imgs->data.data(), lbls->data.data(), n,
                                       feat, 10, batch, capacity, shuffle,
                                       seed, normalize);
  }
  delete imgs;
  delete lbls;
  return l;
}

// CIFAR-10 binary format: records of [1 label byte][3072 pixel bytes]
void* dl4j_cifar_loader_create(const char** paths, int npaths, int batch,
                               int capacity, int shuffle, uint64_t seed) {
  std::vector<uint8_t> feats, lbls;
  const int64_t rec = 3073;
  for (int i = 0; i < npaths; i++) {
    FILE* f = std::fopen(paths[i], "rb");
    if (!f) return nullptr;
    std::fseek(f, 0, SEEK_END);
    long sz = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    std::vector<uint8_t> raw(static_cast<size_t>(sz));
    if (std::fread(raw.data(), 1, size_t(sz), f) != size_t(sz)) {
      std::fclose(f);
      return nullptr;
    }
    std::fclose(f);
    int64_t nrec = sz / rec;
    for (int64_t r = 0; r < nrec; r++) {
      lbls.push_back(raw[size_t(r * rec)]);
      feats.insert(feats.end(), raw.begin() + r * rec + 1,
                   raw.begin() + (r + 1) * rec);
    }
  }
  int64_t n = int64_t(lbls.size());
  if (n == 0) return nullptr;
  return dl4j_loader_create_from_arrays(feats.data(), lbls.data(), n, 3072, 10,
                                        batch, capacity, shuffle, seed, 1);
}

int64_t dl4j_loader_num_examples(void* h) { return static_cast<Loader*>(h)->n; }
int64_t dl4j_loader_feature_size(void* h) { return static_cast<Loader*>(h)->feat; }
int dl4j_loader_num_classes(void* h) { return static_cast<Loader*>(h)->num_classes; }
int dl4j_loader_batch_size(void* h) { return static_cast<Loader*>(h)->batch; }

int dl4j_loader_next(void* h, float* x_out, float* y_out) {
  return static_cast<Loader*>(h)->next(x_out, y_out);
}

void dl4j_loader_reset(void* h) {
  auto* l = static_cast<Loader*>(h);
  l->epoch++;
  l->start_epoch();
}

void dl4j_loader_close(void* h) { delete static_cast<Loader*>(h); }

// ----- CSV -----
void* dl4j_csv_open(const char* path, char delim, int skip_lines) {
  return csv_load(path, delim, skip_lines, /*strict=*/0);
}
// v2: strict validate-while-parsing (nullptr on any non-numeric/ragged data)
void* dl4j_csv_open2(const char* path, char delim, int skip_lines,
                     int strict) {
  return csv_load(path, delim, skip_lines, strict);
}
int64_t dl4j_csv_rows(void* h) { return static_cast<CsvFile*>(h)->rows; }
int64_t dl4j_csv_cols(void* h) { return static_cast<CsvFile*>(h)->cols; }
void dl4j_csv_read(void* h, float* out) {
  auto* f = static_cast<CsvFile*>(h);
  std::memcpy(out, f->values.data(), f->values.size() * sizeof(float));
}
void dl4j_csv_close(void* h) { delete static_cast<CsvFile*>(h); }

// ----- stats codec -----
void* dl4j_stats_begin(const char* session_id, const char* worker_id,
                       int64_t timestamp, int32_t iteration, double score,
                       double iter_time_ms, double samples_per_sec,
                       int64_t mem_rss, int64_t device_mem) {
  auto* b = new StatsBuilder();
  auto& o = b->buf;
  o.insert(o.end(), {'D', 'L', 'T', 'S'});
  StatsBuilder::put<uint16_t>(o, 1);  // version
  StatsBuilder::put_str(o, session_id);
  StatsBuilder::put_str(o, worker_id);
  StatsBuilder::put<int64_t>(o, timestamp);
  StatsBuilder::put<int32_t>(o, iteration);
  StatsBuilder::put<double>(o, score);
  StatsBuilder::put<double>(o, iter_time_ms);
  StatsBuilder::put<double>(o, samples_per_sec);
  StatsBuilder::put<int64_t>(o, mem_rss);
  StatsBuilder::put<int64_t>(o, device_mem);
  return b;
}

// section: 0 = params, 1 = gradients, 2 = updates
int dl4j_stats_add(void* h, int section, const char* name, double mean_mag,
                   double lo, double hi, const int32_t* hist, int nhist) {
  if (section < 0 || section > 2) return -1;
  auto* b = static_cast<StatsBuilder*>(h);
  std::vector<uint8_t> e;
  StatsBuilder::put_str(e, name);
  StatsBuilder::put<double>(e, mean_mag);
  StatsBuilder::put<double>(e, lo);
  StatsBuilder::put<double>(e, hi);
  StatsBuilder::put<uint16_t>(e, uint16_t(nhist));
  for (int i = 0; i < nhist; i++) StatsBuilder::put<int32_t>(e, hist[i]);
  b->sections[section].push_back(std::move(e));
  return 0;
}

int64_t dl4j_stats_finish(void* h, uint8_t* out, int64_t cap) {
  auto* b = static_cast<StatsBuilder*>(h);
  std::vector<uint8_t> full = b->buf;
  for (int s = 0; s < 3; s++) {
    StatsBuilder::put<uint16_t>(full, uint16_t(b->sections[s].size()));
    for (auto& e : b->sections[s]) full.insert(full.end(), e.begin(), e.end());
  }
  int64_t n = int64_t(full.size());
  if (out && cap >= n) {
    std::memcpy(out, full.data(), size_t(n));
    delete b;
  }
  return n;  // when out==null or cap too small: required size (builder kept)
}

void dl4j_stats_abort(void* h) { delete static_cast<StatsBuilder*>(h); }

int dl4j_runtime_version(void) { return 4; }

}  // extern "C"

// ------------------------------------------------------------ ingest decode
// Batched record decoder for the zero-copy host data plane: raw broker/wire
// record bytes -> float32, either one synchronous call (ctypes releases the
// GIL for its duration, so Python peers keep running) or a producer-thread
// pipeline mirroring Loader (submit on the consumer thread, decode happens
// on the worker, next() hands back finished records) so decode overlaps the
// training step the way AsyncDataSetIterator overlapped fetch.
namespace {

// codec ids shared with nativert/__init__.py INGEST_CODECS
constexpr int kIngestF32 = 0;   // passthrough
constexpr int kIngestBf16 = 1;  // bf16 -> f32 (bits << 16)
constexpr int kIngestU8 = 2;    // u8 -> f32 / 255

// -1 on bad codec or a length that is not a whole number of elements
int64_t ingest_decode_into(const uint8_t* src, int64_t nbytes, int codec,
                           float* out) {
  switch (codec) {
    case kIngestF32: {
      if (nbytes % 4) return -1;
      std::memcpy(out, src, size_t(nbytes));
      return nbytes / 4;
    }
    case kIngestBf16: {
      if (nbytes % 2) return -1;
      int64_t n = nbytes / 2;
      for (int64_t i = 0; i < n; i++) {
        uint32_t bits = uint32_t(src[2 * i] | (uint32_t(src[2 * i + 1]) << 8))
                        << 16;
        std::memcpy(out + i, &bits, 4);
      }
      return n;
    }
    case kIngestU8: {
      const float scale = 1.0f / 255.0f;
      for (int64_t i = 0; i < nbytes; i++) out[i] = float(src[i]) * scale;
      return nbytes;
    }
    default:
      return -1;
  }
}

struct IngestRec {
  std::vector<uint8_t> raw;
  int codec = 0;
};

struct Ingest {
  int capacity = 8;
  std::deque<IngestRec> inbox;
  std::deque<std::vector<float>> outbox;
  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  std::atomic<bool> stop{false};
  bool bad = false;    // a submitted record failed to decode
  int in_flight = 0;   // popped from inbox, not yet in outbox
  std::thread worker;

  ~Ingest() { shutdown(); }

  void shutdown() {
    {
      std::lock_guard<std::mutex> l(mu);
      stop.store(true);
    }
    cv_work.notify_all();
    cv_done.notify_all();
    if (worker.joinable()) worker.join();
  }

  void run_worker() {
    while (true) {
      IngestRec rec;
      {
        std::unique_lock<std::mutex> l(mu);
        cv_work.wait(l, [this] { return stop.load() || !inbox.empty(); });
        if (stop.load()) return;
        rec = std::move(inbox.front());
        inbox.pop_front();
        in_flight++;
      }
      std::vector<float> dec;
      int64_t n = -1;
      size_t cap = rec.codec == kIngestU8 ? rec.raw.size()
                   : rec.codec == kIngestBf16 ? rec.raw.size() / 2
                                              : rec.raw.size() / 4;
      dec.resize(cap);
      n = ingest_decode_into(rec.raw.data(), int64_t(rec.raw.size()),
                             rec.codec, dec.data());
      std::lock_guard<std::mutex> l(mu);
      in_flight--;
      if (n < 0) {
        bad = true;
      } else {
        dec.resize(size_t(n));
        outbox.push_back(std::move(dec));
      }
      cv_done.notify_all();
    }
  }
};

}  // namespace

extern "C" {

// one-shot decode: floats written, or -1 on bad codec / ragged length /
// insufficient cap. GIL-free for the whole call when invoked via ctypes.
int64_t dl4j_ingest_decode(const uint8_t* src, int64_t nbytes, int codec,
                           float* out, int64_t cap) {
  int64_t need = codec == kIngestU8 ? nbytes
                 : codec == kIngestBf16 ? nbytes / 2
                                        : nbytes / 4;
  if (need > cap) return -1;
  return ingest_decode_into(src, nbytes, codec, out);
}

void* dl4j_ingest_create(int capacity) {
  auto* g = new Ingest();
  g->capacity = std::max(1, capacity);
  g->worker = std::thread([g] { g->run_worker(); });
  return g;
}

// 0 = queued; -1 = pipeline poisoned by an earlier bad record. Blocks only
// when `capacity` records are already in flight (bounded staging).
int dl4j_ingest_submit(void* h, const uint8_t* src, int64_t nbytes,
                       int codec) {
  auto* g = static_cast<Ingest*>(h);
  IngestRec rec;
  rec.raw.assign(src, src + nbytes);
  rec.codec = codec;
  std::unique_lock<std::mutex> l(g->mu);
  g->cv_done.wait(l, [g] {
    return g->stop.load() || g->bad ||
           int(g->inbox.size() + g->outbox.size()) < g->capacity;
  });
  if (g->bad || g->stop.load()) return -1;
  g->inbox.push_back(std::move(rec));
  g->cv_work.notify_one();
  return 0;
}

// floats written for the next finished record; 0 when nothing is in flight
// (caller submitted everything and drained); -1 on poisoned pipeline or cap
// too small for the record.
int64_t dl4j_ingest_next(void* h, float* out, int64_t cap) {
  auto* g = static_cast<Ingest*>(h);
  std::unique_lock<std::mutex> l(g->mu);
  g->cv_done.wait(l, [g] {
    return g->stop.load() || g->bad || !g->outbox.empty() ||
           (g->inbox.empty() && g->in_flight == 0);
  });
  if (g->bad) return -1;
  if (g->outbox.empty()) return 0;  // drained (or stopping)
  std::vector<float> dec = std::move(g->outbox.front());
  g->outbox.pop_front();
  g->cv_done.notify_all();
  l.unlock();
  if (int64_t(dec.size()) > cap) return -1;
  std::memcpy(out, dec.data(), dec.size() * sizeof(float));
  return int64_t(dec.size());
}

void dl4j_ingest_close(void* h) { delete static_cast<Ingest*>(h); }

}  // extern "C"

// ----------------------------------------------------------- vocab counter
// Parallel vocabulary build (the reference's VocabConstructor.java:33 counts
// tokens with worker threads before the Huffman pass). Whitespace tokens;
// mode 1 additionally applies CommonPreprocessor semantics: strip the
// punctuation/digit set [\d.:,"'()\[\]|/?!;] and ASCII-lowercase. ASCII-only
// by contract — any byte >= 0x80 makes the counter return null and the
// caller falls back to the Python pipeline (whose str.lower() has unicode
// semantics this pass does not replicate).
namespace {

struct VocabCount {
  std::vector<std::pair<std::string, int64_t>> entries;  // sorted count desc
  int64_t total = 0;
};

// Python str.split() whitespace for the ASCII range: \t\n\v\f\r, space,
// and the \x1c-\x1f separators (C isspace excludes the latter).
inline bool vc_is_space(unsigned char c) {
  return c == ' ' || (c >= 0x09 && c <= 0x0d) || (c >= 0x1c && c <= 0x1f);
}

inline bool vc_strip_char(unsigned char c) {
  switch (c) {
    case '.': case ':': case ',': case '"': case '\'': case '(': case ')':
    case '[': case ']': case '|': case '/': case '?': case '!': case ';':
      return true;
    default:
      return c >= '0' && c <= '9';
  }
}

bool vc_count_range(const char* data, size_t begin, size_t end, bool common,
                    std::unordered_map<std::string, int64_t>* counts,
                    int64_t* total) {
  std::string tok;
  for (size_t i = begin; i <= end; i++) {
    unsigned char c = (i < end) ? (unsigned char)data[i] : ' ';
    if (c >= 0x80) return false;  // non-ASCII: caller must fall back
    // non-printable control bytes outside the whitespace set (NUL etc.)
    // would be silently truncated by the C-string readout; decline so the
    // Python fallback keeps the token intact
    if (c < 0x20 && !vc_is_space(c)) return false;
    if (vc_is_space(c)) {
      if (!tok.empty()) {
        (*counts)[tok]++;
        (*total)++;
        tok.clear();
      }
      continue;
    }
    if (common) {
      if (vc_strip_char(c)) continue;
      if (c >= 'A' && c <= 'Z') c = (unsigned char)(c - 'A' + 'a');
    }
    tok.push_back((char)c);
  }
  return true;
}

}  // namespace

extern "C" {

// Returns a handle, or null on IO error / non-ASCII content (caller falls
// back to the Python tokenizer pipeline). nthreads <= 0 -> hardware default.
void* dl4j_vocab_count_file(const char* path, int common_preprocess,
                            int nthreads) {
  std::ifstream f(path, std::ios::binary | std::ios::ate);
  if (!f) return nullptr;
  std::streamsize sz = f.tellg();
  f.seekg(0);
  std::string data((size_t)sz, '\0');
  if (sz && !f.read(&data[0], sz)) return nullptr;

  unsigned hw = std::thread::hardware_concurrency();
  int nt = nthreads > 0 ? nthreads : (hw ? (int)hw : 1);
  if ((int64_t)sz < (int64_t)1 << 20) nt = 1;  // small file: skip thread cost
  // chunk boundaries snapped forward to whitespace so no token spans chunks
  std::vector<size_t> bounds{0};
  for (int t = 1; t < nt; t++) {
    size_t b = (size_t)sz * (size_t)t / (size_t)nt;
    while (b < (size_t)sz && !vc_is_space((unsigned char)data[b])) b++;
    bounds.push_back(b);
  }
  bounds.push_back((size_t)sz);

  int real_nt = (int)bounds.size() - 1;
  std::vector<std::unordered_map<std::string, int64_t>> maps(real_nt);
  std::vector<int64_t> totals(real_nt, 0);
  std::vector<char> ok(real_nt, 1);
  std::vector<std::thread> threads;
  for (int t = 0; t < real_nt; t++) {
    threads.emplace_back([&, t]() {
      ok[t] = vc_count_range(data.data(), bounds[t], bounds[t + 1],
                             common_preprocess != 0, &maps[t], &totals[t]);
    });
  }
  for (auto& th : threads) th.join();
  for (int t = 0; t < real_nt; t++)
    if (!ok[t]) return nullptr;

  auto* vc = new VocabCount();
  std::unordered_map<std::string, int64_t> merged;
  for (int t = 0; t < real_nt; t++) {
    for (auto& kv : maps[t]) merged[kv.first] += kv.second;
    vc->total += totals[t];
  }
  vc->entries.assign(merged.begin(), merged.end());
  // deterministic order: count desc, then word asc
  std::sort(vc->entries.begin(), vc->entries.end(),
            [](const auto& a, const auto& b) {
              if (a.second != b.second) return a.second > b.second;
              return a.first < b.first;
            });
  return vc;
}

int64_t dl4j_vocab_num_words(void* h) {
  return (int64_t)static_cast<VocabCount*>(h)->entries.size();
}

int64_t dl4j_vocab_total_tokens(void* h) {
  return static_cast<VocabCount*>(h)->total;
}

// Writes word idx into out (NUL-terminated, truncated to cap) and returns its
// count; -1 for out-of-range idx.
int64_t dl4j_vocab_entry(void* h, int64_t idx, char* out, int64_t cap) {
  auto* vc = static_cast<VocabCount*>(h);
  if (idx < 0 || (size_t)idx >= vc->entries.size()) return -1;
  const auto& e = vc->entries[(size_t)idx];
  if (out && cap > 0) {
    int64_t n = std::min<int64_t>((int64_t)e.first.size(), cap - 1);
    std::memcpy(out, e.first.data(), (size_t)n);
    out[n] = '\0';
  }
  return e.second;
}

void dl4j_vocab_close(void* h) { delete static_cast<VocabCount*>(h); }

}  // extern "C"
