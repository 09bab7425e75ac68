// The record DB reader and the threaded data pipeline of sparknet_tpu_torch.
//
// The port's own copy of the JAX package's native runtime (the caffe
// data plane it replaces: db::DB over LevelDB/LMDB, DataReader's single
// reader thread, DataTransformer's crop/mirror/mean/scale and
// BasePrefetchingDataLayer's prefetch depth of 3), with one addition:
// the pipeline opens at a record sequence number `start` (record
// start mod n), so a resumed run draws what an uninterrupted one drew
// without transforming the records it skips.  Records are written by
// the Python side (sparknet_tpu_torch/runtime/__init__.py); this file
// reads them.  Built with the host C++ compiler at first use
// (runtime/_build.py) and bound through a plain C interface (ctypes).
//
// DB format "SNDB1": 8-byte magic, then records of
//   [u32 key_len][key][u32 val_len][val]  (little-endian lengths)
// Values for the pipeline are Datum-style: a 1-byte label (or a 2-byte
// little-endian one) + C*H*W pixel bytes (planar, NCHW order).

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <fstream>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// Last-error storage is a mutex-guarded global (NOT thread_local): errors
// raised on the pipeline reader thread must be visible to the Python caller
// thread that polls sn_last_error().
std::mutex g_error_mutex;
std::string g_last_error;

void set_error(const std::string& msg) {
  std::lock_guard<std::mutex> lock(g_error_mutex);
  g_last_error = msg;
}

std::string last_error_copy() {
  std::lock_guard<std::mutex> lock(g_error_mutex);
  return g_last_error;
}

constexpr char kMagic[8] = {'S', 'N', 'D', 'B', '1', '\0', '\0', '\0'};

// ---------------------------------------------------------------------------
// RecordDB
// ---------------------------------------------------------------------------

// Read-only: the Python side writes record DBs.
class RecordDB {
 public:
  static RecordDB* Open(const std::string& path) {
    auto db = std::unique_ptr<RecordDB>(new RecordDB(path));
    if (!db->LoadIndex()) return nullptr;
    return db.release();
  }

  size_t NumRecords() const { return offsets_.size(); }
  bool HasMap() const { return map_ != nullptr; }

  // Zero-copy view of record idx's value, valid while the DB is open.
  // Read mode only (requires the mmap LoadIndex sets up); the pipeline's
  // reader thread uses this so record bytes are never copied — workers
  // transform straight out of the page cache.
  bool ValueView(size_t idx, const char** data, size_t* len,
                 std::string* err = nullptr) {
    if (idx >= offsets_.size() || map_ == nullptr) {
      std::string msg = map_ == nullptr ? "db not mapped for view reads"
                                        : "record index out of range";
      if (err) *err = msg;
      set_error(msg);
      return false;
    }
    const char* p = static_cast<const char*>(map_) + size_t(offsets_[idx]);
    uint32_t kl, vl;
    std::memcpy(&kl, p, 4);
    std::memcpy(&vl, p + 4 + kl, 4);
    *data = p + 4 + kl + 4;
    *len = vl;
    return true;
  }

  // Sequential cursor read; wraps are the caller's concern. On failure the
  // specific reason is written to *err (when given) as well as the global
  // last-error — callers on reader threads use *err to avoid racing on the
  // shared global.
  bool ReadAt(size_t idx, std::string* key, std::string* value,
              std::string* err = nullptr) {
    auto fail = [&](const std::string& msg) {
      if (err) *err = msg;
      set_error(msg);
      return false;
    };
    if (idx >= offsets_.size()) {
      return fail("record index out of range");
    }
    std::lock_guard<std::mutex> g(mu_);
    in_.seekg(offsets_[idx]);
    uint32_t kl = 0, vl = 0;
    in_.read(reinterpret_cast<char*>(&kl), 4);
    key->resize(kl);
    if (kl) in_.read(&(*key)[0], kl);
    in_.read(reinterpret_cast<char*>(&vl), 4);
    value->resize(vl);
    if (vl) in_.read(&(*value)[0], vl);
    if (!in_) {
      in_.clear();  // don't poison subsequent reads
      return fail("read failed at record " + std::to_string(idx) + " in " +
                  path_);
    }
    return true;
  }

  ~RecordDB() {
    if (map_ != nullptr) munmap(map_, map_len_);
  }

 private:
  explicit RecordDB(const std::string& path) : path_(path) {}

  bool LoadIndex() {
    in_.open(path_, std::ios::binary);
    if (!in_) {
      set_error("cannot open for read: " + path_);
      return false;
    }
    char magic[8];
    in_.read(magic, 8);
    if (!in_ || std::memcmp(magic, kMagic, 8) != 0) {
      set_error("bad magic in " + path_);
      return false;
    }
    // bound every record against the real file size: seekg past EOF does
    // NOT set failbit, so length checks must be explicit
    in_.seekg(0, std::ios::end);
    const uint64_t fsize = static_cast<uint64_t>(in_.tellg());
    uint64_t pos = sizeof(kMagic);
    while (pos < fsize) {
      if (pos + 4 > fsize) {
        set_error("truncated record in " + path_);
        return false;
      }
      in_.seekg(pos);
      uint32_t kl = 0, vl = 0;
      in_.read(reinterpret_cast<char*>(&kl), 4);
      if (pos + 4 + kl + 4 > fsize) {
        set_error("truncated record in " + path_);
        return false;
      }
      in_.seekg(kl, std::ios::cur);
      in_.read(reinterpret_cast<char*>(&vl), 4);
      if (!in_ || pos + 4 + kl + 4 + vl > fsize) {
        set_error("truncated record in " + path_);
        return false;
      }
      offsets_.push_back(static_cast<std::streampos>(pos));
      pos += 4ull + kl + 4ull + vl;
    }
    in_.clear();
    in_.seekg(sizeof(kMagic));
    // map the validated file for the zero-copy ValueView path; fall back
    // silently to stream reads if mmap is unavailable
    int fd = open(path_.c_str(), O_RDONLY);
    if (fd >= 0) {
      void* m = mmap(nullptr, fsize, PROT_READ, MAP_PRIVATE, fd, 0);
      close(fd);
      if (m != MAP_FAILED) {
        map_ = m;
        map_len_ = fsize;
      }
    }
    return true;
  }

  std::string path_;
  std::ifstream in_;
  std::vector<std::streampos> offsets_;
  std::mutex mu_;
  void* map_ = nullptr;
  size_t map_len_ = 0;
};

// ---------------------------------------------------------------------------
// Pipeline: one reader thread + N transform workers + in-order delivery.
//
// The reference runs a single DB-reading Body thread per source
// (data_reader.cpp:80-99) and a transformer per solver (base_data_layer.cpp:70-101); here one reader
// feeds a worker pool that cooperates batch-by-batch, so the host plane
// scales with cores while record order stays the deterministic
// sequential-cursor order.  Per-record crop/mirror randomness comes from
// a counter-based splitmix64 stream keyed on (seed, global record seq):
// identical output for ANY worker count, reproducible by the Python
// reader, and at any start (the stream of record seq depends on nothing
// drawn before it).
// ---------------------------------------------------------------------------

inline uint64_t splitmix64(uint64_t& s) {
  s += 0x9E3779B97F4A7C15ull;
  uint64_t z = s;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

struct Batch {
  // f32 mode: data holds floats; u8 mode: data_u8 holds cropped bytes and
  // the per-image geometry (offsets + flip) rides along for the device to
  // finish mean/scale/mirror.
  std::vector<float> data;
  std::vector<uint8_t> data_u8;
  std::vector<float> labels;
  std::vector<int32_t> h_offs, w_offs;
  std::vector<uint8_t> flips;
};

struct PipelineConfig {
  int batch = 0, c = 0, h = 0, w = 0;
  int crop = 0;        // 0 = no crop
  bool mirror = false;
  bool train = true;   // random crop/mirror vs deterministic center crop
  float scale = 1.0f;
  std::vector<float> mean;  // empty, per-channel (C), or full image (C*H*W)
  int prefetch = 3;         // PREFETCH_COUNT
  uint64_t seed = 0;
  uint64_t start = 0;       // record sequence number of the first record
  int workers = 0;          // 0 = hardware_concurrency - 1 (min 1)
  bool u8_output = false;   // geometry-only host path (device finishes)
};

struct BatchTask {
  uint64_t id = 0;
  // views into the mmapped DB (zero-copy; valid while the DB is open) or
  // into `owned` when the file could not be mapped
  std::vector<std::pair<const char*, size_t>> records;
  std::vector<std::string> owned;
  Batch out;
  std::atomic<int> next_slot{0};
  std::atomic<int> done_slots{0};
};

class Pipeline {
 public:
  Pipeline(RecordDB* db, const PipelineConfig& cfg) : db_(db), cfg_(cfg) {
    out_h_ = cfg_.crop > 0 ? cfg_.crop : cfg_.h;
    out_w_ = cfg_.crop > 0 ? cfg_.crop : cfg_.w;
    int workers = cfg_.workers;
    if (workers <= 0) {
      unsigned hc = std::thread::hardware_concurrency();
      workers = hc > 1 ? static_cast<int>(hc - 1) : 1;
    }
    reader_ = std::thread([this] { ReadLoop(); });
    for (int i = 0; i < workers; ++i) {
      workers_.emplace_back([this] { WorkLoop(); });
    }
  }

  ~Pipeline() {
    Stop();
    if (reader_.joinable()) reader_.join();
    for (auto& t : workers_) {
      if (t.joinable()) t.join();
    }
    delete db_;
  }

  int out_h() const { return out_h_; }
  int out_w() const { return out_w_; }
  bool u8_output() const { return cfg_.u8_output; }

  bool Next(void* data_out, float* label_out, int32_t* hoff_out,
            int32_t* woff_out, uint8_t* flip_out) {
    Batch b;
    {
      std::unique_lock<std::mutex> lk(done_mu_);
      done_cv_.wait(lk, [&] {
        return stop_.load() || done_.count(next_out_) != 0;
      });
      auto it = done_.find(next_out_);
      if (it == done_.end()) {
        std::string err = GetError();
        set_error(err.empty() ? "pipeline stopped" : err);
        return false;
      }
      b = std::move(it->second);
      done_.erase(it);
      ++next_out_;
    }
    room_cv_.notify_one();
    if (cfg_.u8_output) {
      std::memcpy(data_out, b.data_u8.data(), b.data_u8.size());
      if (hoff_out)
        std::memcpy(hoff_out, b.h_offs.data(),
                    b.h_offs.size() * sizeof(int32_t));
      if (woff_out)
        std::memcpy(woff_out, b.w_offs.data(),
                    b.w_offs.size() * sizeof(int32_t));
      if (flip_out) std::memcpy(flip_out, b.flips.data(), b.flips.size());
    } else {
      std::memcpy(data_out, b.data.data(), b.data.size() * sizeof(float));
    }
    std::memcpy(label_out, b.labels.data(), b.labels.size() * sizeof(float));
    {
      std::lock_guard<std::mutex> lk(pool_mu_);
      pool_.push_back(std::move(b));
    }
    return true;
  }

 private:
  void ReadLoop() {
    const size_t n = db_->NumRecords();
    const size_t record_bytes = 1 + size_t(cfg_.c) * cfg_.h * cfg_.w;
    size_t idx = static_cast<size_t>(cfg_.start % n);
    uint64_t id = 0;
    while (!stop_.load()) {
      {
        // bound in-flight batches to the prefetch depth
        std::unique_lock<std::mutex> lk(done_mu_);
        room_cv_.wait(lk, [&] {
          return stop_.load() ||
                 id < next_out_ + static_cast<uint64_t>(cfg_.prefetch);
        });
        if (stop_.load()) break;
      }
      auto task = std::make_shared<BatchTask>();
      task->id = id++;
      task->records.resize(cfg_.batch);
      const bool views = db_->HasMap();
      if (!views) task->owned.resize(cfg_.batch);
      {
        // recycled buffers: resize-to-same-size below is then a no-op,
        // avoiding a full zero-fill of the batch per round
        std::lock_guard<std::mutex> lk(pool_mu_);
        if (!pool_.empty()) {
          task->out = std::move(pool_.back());
          pool_.pop_back();
        }
      }
      AllocBatch(&task->out);
      bool ok = true;
      for (int i = 0; i < cfg_.batch && !stop_.load(); ++i) {
        std::string read_err;
        if (views) {
          if (!db_->ValueView(idx, &task->records[i].first,
                              &task->records[i].second, &read_err)) {
            SetError(read_err);
            Stop();
            ok = false;
            break;
          }
        } else {
          if (!db_->ReadAt(idx, &scratch_key_, &task->owned[i], &read_err)) {
            SetError(read_err);
            Stop();
            ok = false;
            break;
          }
          task->records[i] = {task->owned[i].data(), task->owned[i].size()};
        }
        idx = (idx + 1) % n;  // epoch wrap, deterministic order like the
                              // reference's sequential cursor
        // Datum records carry a 1-byte label (<=255 classes) or a
        // 2-byte little-endian one (1000-class ImageNet); the width is
        // record length minus the known image size.
        const size_t vs = task->records[i].second;
        if (vs != record_bytes && vs != record_bytes + 1) {
          SetError("record size mismatch: got " + std::to_string(vs) +
                   ", want " + std::to_string(record_bytes) + " or " +
                   std::to_string(record_bytes + 1));
          Stop();
          ok = false;
          break;
        }
      }
      if (!ok || stop_.load()) break;
      {
        std::lock_guard<std::mutex> lk(work_mu_);
        work_.push_back(std::move(task));
      }
      work_cv_.notify_all();
    }
  }

  // Sets the stop flag under every mutex a waiter checks it under, then
  // wakes them all: a waiter that has just found the flag clear is
  // already asleep when the notify comes, so no wake-up is lost.
  void Stop() {
    {
      std::lock_guard<std::mutex> a(work_mu_);
      std::lock_guard<std::mutex> b(done_mu_);
      stop_.store(true);
    }
    work_cv_.notify_all();
    done_cv_.notify_all();
    room_cv_.notify_all();
  }

  void WorkLoop() {
    while (!stop_.load()) {
      std::shared_ptr<BatchTask> task;
      int slot = -1;
      {
        std::unique_lock<std::mutex> lk(work_mu_);
        work_cv_.wait(lk, [&] { return stop_.load() || !work_.empty(); });
        if (stop_.load()) break;
        task = work_.front();
        // claim + pop both happen under work_mu_, so slots run exactly
        // 0..batch-1 and the last claim retires the task
        slot = task->next_slot.fetch_add(1);
        if (slot == cfg_.batch - 1) work_.pop_front();
      }
      TransformSlot(*task, slot);
      if (task->done_slots.fetch_add(1) + 1 == cfg_.batch) {
        {
          std::lock_guard<std::mutex> lk(done_mu_);
          done_.emplace(task->id, std::move(task->out));
        }
        done_cv_.notify_all();
      }
    }
  }

  void AllocBatch(Batch* b) {
    const size_t img = size_t(cfg_.c) * out_h_ * out_w_;
    if (cfg_.u8_output) {
      b->data_u8.resize(size_t(cfg_.batch) * img);
      b->h_offs.resize(cfg_.batch);
      b->w_offs.resize(cfg_.batch);
      b->flips.resize(cfg_.batch);
    } else {
      b->data.resize(size_t(cfg_.batch) * img);
    }
    b->labels.resize(cfg_.batch);
  }

  // DataTransformer semantics: crop (random in train, center in test),
  // mirror (train only), mean subtraction, scale.  Per-record randomness
  // is the counter-based stream documented above.
  void TransformSlot(BatchTask& task, int slot) {
    const char* vdata = task.records[slot].first;
    const size_t vsize = task.records[slot].second;
    Batch& b = task.out;
    const uint8_t* bytes = reinterpret_cast<const uint8_t*>(vdata);
    const size_t label_w =
        vsize - size_t(cfg_.c) * cfg_.h * cfg_.w;  // 1 or 2
    b.labels[slot] = static_cast<float>(
        label_w == 2 ? (unsigned(bytes[0]) | (unsigned(bytes[1]) << 8))
                     : bytes[0]);
    const uint8_t* img = bytes + label_w;

    const uint64_t seq =
        cfg_.start + task.id * uint64_t(cfg_.batch) + uint64_t(slot);
    uint64_t rs = (cfg_.seed * 0x9E3779B97F4A7C15ull) ^
                  (seq * 0xBF58476D1CE4E5B9ull);
    int h_off = 0, w_off = 0;
    if (cfg_.crop > 0) {
      if (cfg_.train) {
        h_off = static_cast<int>(splitmix64(rs) % uint64_t(cfg_.h - cfg_.crop + 1));
        w_off = static_cast<int>(splitmix64(rs) % uint64_t(cfg_.w - cfg_.crop + 1));
      } else {
        h_off = (cfg_.h - cfg_.crop) / 2;
        w_off = (cfg_.w - cfg_.crop) / 2;
      }
    }
    const bool flip = cfg_.mirror && cfg_.train && (splitmix64(rs) & 1);

    const size_t out_img = size_t(cfg_.c) * out_h_ * out_w_;
    if (cfg_.u8_output) {
      // geometry only: contiguous row copies; arithmetic (mean/scale)
      // and the mirror land on the device where they fuse into the step
      uint8_t* dst = &b.data_u8[size_t(slot) * out_img];
      for (int ch = 0; ch < cfg_.c; ++ch) {
        for (int y = 0; y < out_h_; ++y) {
          const uint8_t* src =
              img + (size_t(ch) * cfg_.h + y + h_off) * cfg_.w + w_off;
          std::memcpy(dst + (size_t(ch) * out_h_ + y) * out_w_, src, out_w_);
        }
      }
      b.h_offs[slot] = h_off;
      b.w_offs[slot] = w_off;
      b.flips[slot] = flip ? 1 : 0;
      return;
    }

    const bool full_mean =
        cfg_.mean.size() == size_t(cfg_.c) * cfg_.h * cfg_.w;
    const bool chan_mean = cfg_.mean.size() == size_t(cfg_.c);
    float* out = &b.data[size_t(slot) * out_img];
    for (int ch = 0; ch < cfg_.c; ++ch) {
      for (int y = 0; y < out_h_; ++y) {
        const size_t src_row = (size_t(ch) * cfg_.h + y + h_off) * cfg_.w + w_off;
        const uint8_t* src = img + src_row;
        const float cm = chan_mean ? cfg_.mean[ch] : 0.0f;
        const float* mrow = full_mean ? &cfg_.mean[src_row] : nullptr;
        float* dst = out + (size_t(ch) * out_h_ + y) * out_w_;
        if (!flip) {
          // contiguous: compilers vectorize this u8->f32 + axpy row
          if (mrow) {
            for (int x = 0; x < out_w_; ++x)
              dst[x] = (float(src[x]) - mrow[x]) * cfg_.scale;
          } else {
            for (int x = 0; x < out_w_; ++x)
              dst[x] = (float(src[x]) - cm) * cfg_.scale;
          }
        } else {
          // mean indexed by the source window, output written mirrored
          // (data_transformer.cpp:119-130)
          if (mrow) {
            for (int x = 0; x < out_w_; ++x)
              dst[out_w_ - 1 - x] = (float(src[x]) - mrow[x]) * cfg_.scale;
          } else {
            for (int x = 0; x < out_w_; ++x)
              dst[out_w_ - 1 - x] = (float(src[x]) - cm) * cfg_.scale;
          }
        }
      }
    }
  }

  // Per-pipeline sticky error, set on the reader thread, read by Next().
  void SetError(const std::string& msg) {
    std::lock_guard<std::mutex> lock(err_mutex_);
    if (error_.empty()) error_ = msg;
  }

  std::string GetError() {
    std::lock_guard<std::mutex> lock(err_mutex_);
    return error_;
  }

  RecordDB* db_;
  PipelineConfig cfg_;
  int out_h_, out_w_;
  std::string scratch_key_;

  std::deque<std::shared_ptr<BatchTask>> work_;
  std::mutex work_mu_;
  std::condition_variable work_cv_;

  std::map<uint64_t, Batch> done_;
  uint64_t next_out_ = 0;
  std::mutex done_mu_;
  std::condition_variable done_cv_, room_cv_;

  std::vector<Batch> pool_;
  std::mutex pool_mu_;

  std::atomic<bool> stop_{false};
  std::mutex err_mutex_;
  std::string error_;
  std::thread reader_;
  std::vector<std::thread> workers_;
};

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

const char* sn_last_error() {
  // Copy into a thread_local buffer so the returned pointer stays valid for
  // the calling thread even if another thread sets a new error.
  thread_local std::string buf;
  buf = last_error_copy();
  return buf.c_str();
}

// A pipeline over the record DB at db_path, or null (sn_last_error says
// why).  `start` is the sequence number of the first record delivered.
void* snpipe_create(const char* db_path, int batch, int c, int h, int w,
                    int crop, int mirror, int train, float scale,
                    const float* mean, int mean_len, uint64_t seed,
                    int prefetch, int workers, int u8_output,
                    uint64_t start) {
  RecordDB* db = RecordDB::Open(db_path);
  if (!db) return nullptr;
  if (db->NumRecords() == 0) {
    set_error("empty db");
    delete db;
    return nullptr;
  }
  PipelineConfig cfg;
  cfg.batch = batch;
  cfg.c = c;
  cfg.h = h;
  cfg.w = w;
  cfg.crop = crop;
  cfg.mirror = mirror != 0;
  cfg.train = train != 0;
  cfg.scale = scale;
  if (mean && mean_len > 0) cfg.mean.assign(mean, mean + mean_len);
  cfg.seed = seed;
  cfg.start = start;
  cfg.prefetch = prefetch > 0 ? prefetch : 3;
  cfg.workers = workers;
  cfg.u8_output = u8_output != 0;
  if (crop > 0 && (crop > h || crop > w)) {
    set_error("crop exceeds input");
    delete db;
    return nullptr;
  }
  return new Pipeline(db, cfg);
}

// The next batch, in order.  Float mode: data_out is float (B*C*oh*ow);
// u8 mode: data_out is uint8 and hoff/woff (int32, B) and flip (uint8,
// B) receive the per-image geometry.  Returns 0, or -1 on an error.
int snpipe_next(void* p, void* data_out, float* label_out, int32_t* hoff_out,
                int32_t* woff_out, uint8_t* flip_out) {
  return static_cast<Pipeline*>(p)->Next(data_out, label_out, hoff_out,
                                         woff_out, flip_out)
             ? 0
             : -1;
}

// Stops the reader and every transform thread, then frees the pipeline.
void snpipe_destroy(void* p) { delete static_cast<Pipeline*>(p); }

}  // extern "C"
