// Latent-cache reader: an mmap .npy parser and a worker-thread read-ahead
// ring, bound through ctypes by hyvideo_prfl_torch/data/native_loader.py,
// which builds this file with the host C++ compiler at first use
// (-O3 -shared -fPIC -pthread -std=c++17). A training sample's latent,
// text, condition and CLIP files are submitted together and read in
// parallel; they come back in submission order.
//
// C ABI:
//   void* ll_open(const char** paths, int n, int slots, int threads)
//   void* ll_open_stream(int slots, int threads)   // submit-as-you-go mode
//   void  ll_submit(void*, const char* path)        // enqueue one file
//   int   ll_next(void*, void** data, long long* shape /*8*/, int* ndim,
//                 int* dtype /*0=f32,1=f16,2=i64,3=u8,4=f64*/)
//         -> slot id (>=0) or -1 on stream end / -2 on error
//         (submission order; in stream mode call at most once per submit)
//   void  ll_release(void*, int slot)
//   void  ll_close(void*)
//   const char* ll_error(void*)

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Sample {
  std::vector<char> data;
  long long shape[8];
  int ndim = 0;
  int dtype = 0;
  bool ok = false;
  std::string err;
};

struct Slot {
  Sample sample;
  std::atomic<int> state{0};  // 0 free, 1 filling, 2 ready, 3 consumed
};

int dtype_code(const std::string& descr) {
  if (descr.find("f4") != std::string::npos) return 0;
  if (descr.find("f2") != std::string::npos) return 1;
  if (descr.find("i8") != std::string::npos) return 2;
  if (descr.find("u1") != std::string::npos) return 3;
  if (descr.find("f8") != std::string::npos) return 4;
  return -1;
}

// Parse npy v1/v2 header + copy payload. Returns false + err on failure.
bool read_npy(const std::string& path, Sample* out) {
  int fd = open(path.c_str(), O_RDONLY);
  if (fd < 0) {
    out->err = "open failed: " + path;
    return false;
  }
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 10) {
    close(fd);
    out->err = "stat failed: " + path;
    return false;
  }
  size_t fsize = static_cast<size_t>(st.st_size);
  void* m = mmap(nullptr, fsize, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (m == MAP_FAILED) {
    out->err = "mmap failed: " + path;
    return false;
  }
  const unsigned char* p = static_cast<const unsigned char*>(m);
  bool ok = false;
  do {
    if (memcmp(p, "\x93NUMPY", 6) != 0) {
      out->err = "bad magic: " + path;
      break;
    }
    int major = p[6];
    size_t hlen, hoff;
    if (major == 1) {
      hlen = p[8] | (p[9] << 8);
      hoff = 10;
    } else {
      hlen = p[8] | (p[9] << 8) | (size_t(p[10]) << 16) | (size_t(p[11]) << 24);
      hoff = 12;
    }
    if (hoff + hlen > fsize) {
      out->err = "truncated header: " + path;
      break;
    }
    std::string hdr(reinterpret_cast<const char*>(p) + hoff, hlen);
    // descr
    size_t dp = hdr.find("'descr'");
    if (dp == std::string::npos) {
      out->err = "no descr: " + path;
      break;
    }
    size_t q1 = hdr.find('\'', dp + 7);
    size_t q2 = hdr.find('\'', q1 + 1);
    std::string descr = hdr.substr(q1 + 1, q2 - q1 - 1);
    out->dtype = dtype_code(descr);
    if (out->dtype < 0) {
      out->err = "unsupported dtype " + descr + ": " + path;
      break;
    }
    // fortran_order must be False
    if (hdr.find("'fortran_order': True") != std::string::npos) {
      out->err = "fortran order unsupported: " + path;
      break;
    }
    // shape tuple
    size_t sp = hdr.find("'shape'");
    size_t o1 = hdr.find('(', sp);
    size_t o2 = hdr.find(')', o1);
    std::string shp = hdr.substr(o1 + 1, o2 - o1 - 1);
    out->ndim = 0;
    long long total = 1;
    const char* s = shp.c_str();
    while (*s) {
      while (*s == ' ' || *s == ',') s++;
      if (!*s) break;
      long long v = strtoll(s, const_cast<char**>(&s), 10);
      if (out->ndim >= 8) {
        out->err = "rank > 8: " + path;
        break;
      }
      out->shape[out->ndim++] = v;
      total *= v;
    }
    if (out->ndim == 0) {  // scalar
      out->shape[0] = 1;
      out->ndim = 1;
    }
    size_t isize = out->dtype == 3 ? 1 : out->dtype == 1 ? 2
                  : out->dtype == 2 || out->dtype == 4 ? 8 : 4;
    size_t nbytes = static_cast<size_t>(total) * isize;
    if (hoff + hlen + nbytes > fsize) {
      out->err = "truncated payload: " + path;
      break;
    }
    out->data.resize(nbytes);
    memcpy(out->data.data(), p + hoff + hlen, nbytes);
    ok = true;
  } while (false);
  munmap(m, fsize);
  out->ok = ok;
  return ok;
}

struct Loader {
  std::vector<Slot> slots;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready, cv_free, cv_jobs;
  std::atomic<bool> stop{false};
  std::string last_err;
  // job queue: (ticket, path) in submission order. Bounded mode (ll_open)
  // submits everything up front and ll_next returns -1 past `total`;
  // stream mode (ll_open_stream + ll_submit) has no end marker — the
  // consumer calls ll_next at most once per submit.
  std::deque<std::pair<size_t, std::string>> jobs;
  size_t submitted = 0;
  const bool bounded;
  const size_t total;
  // enforce output ordering: worker i writes sample k into the ring in
  // submission order via a ticketing scheme
  std::mutex order_mu;
  size_t next_emit = 0;
  std::vector<std::pair<size_t, int>> pending;  // (ticket, slot)

  Loader(int n_slots, int n_threads, bool bounded_, size_t total_)
      : slots(n_slots), bounded(bounded_), total(total_) {
    for (int t = 0; t < n_threads; ++t) {
      workers.emplace_back([this] { work(); });
    }
  }

  void submit(const std::string& path) {
    {
      std::lock_guard<std::mutex> lk(mu);
      jobs.emplace_back(submitted++, path);
    }
    cv_jobs.notify_one();
  }

  int acquire_free_slot() {
    std::unique_lock<std::mutex> lk(mu);
    for (;;) {
      for (size_t i = 0; i < slots.size(); ++i) {
        int expect = 0;
        if (slots[i].state.compare_exchange_strong(expect, 1)) {
          return static_cast<int>(i);
        }
      }
      if (stop.load()) return -1;
      cv_free.wait_for(lk, std::chrono::milliseconds(50));
    }
  }

  void work() {
    for (;;) {
      if (stop.load()) return;
      // acquire the slot BEFORE claiming a job: otherwise all slots can be
      // held by later samples while the worker holding the sample the
      // consumer needs next starves (circular wait)
      int slot = acquire_free_slot();
      if (slot < 0) return;
      size_t idx;
      std::string path;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_jobs.wait(lk, [&] {
          return stop.load() || !jobs.empty() ||
                 (bounded && submitted >= total && jobs.empty());
        });
        if (stop.load() || jobs.empty()) {
          slots[slot].state.store(0);
          cv_free.notify_all();
          if (stop.load() || bounded) return;  // bounded: no more work ever
          continue;
        }
        idx = jobs.front().first;
        path = std::move(jobs.front().second);
        jobs.pop_front();
      }
      Sample& s = slots[slot].sample;
      s = Sample();
      read_npy(path, &s);
      slots[slot].state.store(2);
      {
        std::lock_guard<std::mutex> lk(order_mu);
        pending.emplace_back(idx, slot);
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        cv_ready.notify_all();
      }
    }
  }

  // next in submission order
  int next(void** data, long long* shape, int* ndim, int* dtype) {
    std::unique_lock<std::mutex> lk(mu);
    for (;;) {
      {
        std::lock_guard<std::mutex> olk(order_mu);
        for (size_t i = 0; i < pending.size(); ++i) {
          if (pending[i].first == next_emit) {
            int slot = pending[i].second;
            pending.erase(pending.begin() + i);
            next_emit++;
            Sample& s = slots[slot].sample;
            if (!s.ok) {
              last_err = s.err;
              slots[slot].state.store(0);
              cv_free.notify_all();
              return -2;
            }
            *data = s.data.data();
            memcpy(shape, s.shape, sizeof(s.shape));
            *ndim = s.ndim;
            *dtype = s.dtype;
            return slot;
          }
        }
      }
      if (bounded && next_emit >= total) return -1;  // stream end
      cv_ready.wait_for(lk, std::chrono::milliseconds(50));
      if (stop.load()) return -1;
    }
  }

  void release(int slot) {
    if (slot >= 0 && slot < static_cast<int>(slots.size())) {
      slots[slot].state.store(0);
      std::lock_guard<std::mutex> lk(mu);
      cv_free.notify_all();
    }
  }

  ~Loader() {
    stop.store(true);
    {
      std::lock_guard<std::mutex> lk(mu);
      cv_free.notify_all();
      cv_ready.notify_all();
      cv_jobs.notify_all();
    }
    for (auto& w : workers) {
      if (w.joinable()) w.join();
    }
  }
};

}  // namespace

extern "C" {

void* ll_open(const char** paths, int n, int slots, int threads) {
  if (slots < 2) slots = 2;
  if (threads < 1) threads = 1;
  Loader* l = new Loader(slots, threads, /*bounded=*/true,
                         static_cast<size_t>(n));
  for (int i = 0; i < n; ++i) l->submit(paths[i]);
  return l;
}

void* ll_open_stream(int slots, int threads) {
  if (slots < 2) slots = 2;
  if (threads < 1) threads = 1;
  return new Loader(slots, threads, /*bounded=*/false, 0);
}

void ll_submit(void* h, const char* path) {
  static_cast<Loader*>(h)->submit(path);
}

int ll_next(void* h, void** data, long long* shape, int* ndim, int* dtype) {
  return static_cast<Loader*>(h)->next(data, shape, ndim, dtype);
}

void ll_release(void* h, int slot) { static_cast<Loader*>(h)->release(slot); }

const char* ll_error(void* h) {
  return static_cast<Loader*>(h)->last_err.c_str();
}

void ll_close(void* h) { delete static_cast<Loader*>(h); }

}  // extern "C"
