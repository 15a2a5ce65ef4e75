// grab_tpu native ingest library.
//
// Host-side C++ for the two I/O-bound stages the reference implements
// with nftw + chunked mmap (greppin src/grab.cc:137-169,
// 260-279, main.cc:74-83):
//
//   gt_walk      — physical recursive walk (symlinks not followed,
//                  regular files only, per-entry error containment,
//                  sorted traversal for deterministic output order).
//   gt_fill2     — fill a fixed scan buffer from file segments with a
//                  thread pool of pread()s (the GIL-free replacement
//                  for Python's copy loop; keeps N chips fed).
//
// C ABI for ctypes; no Python headers needed.

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <dirent.h>
#include <fcntl.h>
#include <mutex>
#include <string>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <unordered_map>
#include <vector>

extern "C" {

typedef void (*gt_walk_cb)(const char *path, int64_t size, void *ud);
typedef void (*gt_err_cb)(const char *path, const char *msg, void *ud);

// Physical (lstat) recursive walk; regular files only; sorted entries;
// errors reported per entry and the walk continues (parity with
// grab.cc:267-268). Returns 0.
int gt_walk(const char *root, gt_walk_cb cb, gt_err_cb err_cb, void *ud) {
  struct stat st;
  if (lstat(root, &st) < 0) {
    if (err_cb) err_cb(root, strerror(errno), ud);
    return 0;
  }
  if (S_ISREG(st.st_mode)) {
    cb(root, (int64_t)st.st_size, ud);
    return 0;
  }
  if (!S_ISDIR(st.st_mode)) return 0;

  std::vector<std::string> stack{root};
  std::vector<std::string> names;
  while (!stack.empty()) {
    std::string dir = std::move(stack.back());
    stack.pop_back();
    DIR *d = opendir(dir.c_str());
    if (!d) {
      if (err_cb) err_cb(dir.c_str(), strerror(errno), ud);
      continue;
    }
    names.clear();
    struct dirent *ent;
    while ((ent = readdir(d)) != nullptr) {
      if (strcmp(ent->d_name, ".") == 0 || strcmp(ent->d_name, "..") == 0)
        continue;
      names.emplace_back(ent->d_name);
    }
    closedir(d);
    std::sort(names.begin(), names.end());
    std::vector<std::string> subdirs;
    for (const auto &n : names) {
      std::string p = dir + "/" + n;
      if (lstat(p.c_str(), &st) < 0) {
        if (err_cb) err_cb(p.c_str(), strerror(errno), ud);
        continue;
      }
      if (S_ISREG(st.st_mode)) {
        cb(p.c_str(), (int64_t)st.st_size, ud);
      } else if (S_ISDIR(st.st_mode)) {
        subdirs.push_back(std::move(p));
      }
    }
    // LIFO stack: push reversed for depth-first sorted traversal
    for (auto it = subdirs.rbegin(); it != subdirs.rend(); ++it)
      stack.push_back(std::move(*it));
  }
  return 0;
}

// ── parallel walk ────────────────────────────────────────────────────
//
// greppin's headline ingest feature is a lockfree parallel nftw so
// cores work during tree discovery (greppin README.md:44-47,
// 137-139; source not mounted). This is its counterpart: a thread
// pool drains a shared directory queue (readdir + lstat are the
// costly syscalls), storing per-directory entry lists; a serial
// assembly pass then replays the results in EXACTLY the serial
// walker's order (sorted names, files inline, subdirs after), so
// `gt_pwalk(root, N, ...)` and `gt_walk(root, ...)` emit identical
// sequences — determinism the reference only gets modulo `sort`
// (README.md:209-216). Callbacks fire only from the calling thread
// (assembly), which keeps ctypes/GIL interaction trivial.

namespace {

struct PEnt {
  // kind: 0 = regular file, 1 = subdir, 2 = per-entry error
  int kind;
  std::string name;
  int64_t size;
  std::string msg;
};

struct PDir {
  std::vector<PEnt> ents;  // sorted by name
  bool open_error = false;
  std::string open_msg;
};

}  // namespace

static void pwalk_scan_dir(const std::string &dir, PDir &out,
                           std::vector<std::string> &subdirs) {
  DIR *d = opendir(dir.c_str());
  if (!d) {
    out.open_error = true;
    out.open_msg = strerror(errno);
    return;
  }
  std::vector<std::string> names;
  struct dirent *ent;
  while ((ent = readdir(d)) != nullptr) {
    if (strcmp(ent->d_name, ".") == 0 || strcmp(ent->d_name, "..") == 0)
      continue;
    names.emplace_back(ent->d_name);
  }
  closedir(d);
  std::sort(names.begin(), names.end());
  struct stat st;
  for (const auto &n : names) {
    std::string p = dir + "/" + n;
    if (lstat(p.c_str(), &st) < 0) {
      out.ents.push_back({2, n, 0, strerror(errno)});
      continue;
    }
    if (S_ISREG(st.st_mode)) {
      out.ents.push_back({0, n, (int64_t)st.st_size, {}});
    } else if (S_ISDIR(st.st_mode)) {
      out.ents.push_back({1, n, 0, {}});
      subdirs.push_back(std::move(p));
    }
  }
}

// Structure-only variant: classify by readdir d_type (lstat only on
// DT_UNKNOWN filesystems), sizes reported as -1. The multi-host
// phase-1 walk assigns global file indices with this (no per-file
// stat storm on every host); each host then lstats only its stripe
// (parallel/hostrun.host_entries).
static void swalk_scan_dir(const std::string &dir, PDir &out,
                           std::vector<std::string> &subdirs) {
  DIR *d = opendir(dir.c_str());
  if (!d) {
    out.open_error = true;
    out.open_msg = strerror(errno);
    return;
  }
  std::vector<std::pair<std::string, unsigned char>> names;
  struct dirent *ent;
  while ((ent = readdir(d)) != nullptr) {
    if (strcmp(ent->d_name, ".") == 0 || strcmp(ent->d_name, "..") == 0)
      continue;
    names.emplace_back(ent->d_name, ent->d_type);
  }
  closedir(d);
  std::sort(names.begin(), names.end());
  struct stat st;
  for (const auto &nv : names) {
    const std::string &n = nv.first;
    unsigned char t = nv.second;
    std::string p = dir + "/" + n;
    if (t == DT_UNKNOWN) {
      if (lstat(p.c_str(), &st) < 0) {
        out.ents.push_back({2, n, 0, strerror(errno)});
        continue;
      }
      t = S_ISREG(st.st_mode) ? DT_REG : (S_ISDIR(st.st_mode) ? DT_DIR : DT_FIFO);
    }
    if (t == DT_REG) {
      out.ents.push_back({0, n, -1, {}});
    } else if (t == DT_DIR) {
      out.ents.push_back({1, n, 0, {}});
      subdirs.push_back(std::move(p));
    }
  }
}

static int pwalk_drive(const char *root, int32_t nthreads, gt_walk_cb cb,
                       gt_err_cb err_cb, void *ud,
                       void (*scan_fn)(const std::string &, PDir &,
                                       std::vector<std::string> &)) {
  struct stat st;
  if (lstat(root, &st) < 0) {
    if (err_cb) err_cb(root, strerror(errno), ud);
    return 0;
  }
  if (S_ISREG(st.st_mode)) {
    cb(root, (int64_t)st.st_size, ud);
    return 0;
  }
  if (!S_ISDIR(st.st_mode)) return 0;
  if (nthreads < 1) nthreads = 1;
  if (nthreads > 64) nthreads = 64;

  std::unordered_map<std::string, PDir> results;
  std::deque<std::string> queue{root};
  std::mutex mu;
  std::condition_variable cv;
  int32_t active = 0;
  bool finished = false;

  auto worker = [&]() {
    std::unique_lock<std::mutex> lk(mu);
    for (;;) {
      cv.wait(lk, [&] { return finished || !queue.empty(); });
      if (queue.empty()) return;  // finished
      std::string dir = std::move(queue.front());
      queue.pop_front();
      ++active;
      lk.unlock();
      PDir res;
      std::vector<std::string> subdirs;
      scan_fn(dir, res, subdirs);
      lk.lock();
      results.emplace(std::move(dir), std::move(res));
      for (auto &s : subdirs) queue.push_back(std::move(s));
      --active;
      if (!subdirs.empty())
        cv.notify_all();
      else if (queue.empty() && active == 0) {
        finished = true;
        cv.notify_all();
      }
    }
  };

  {
    std::vector<std::thread> threads;
    threads.reserve(nthreads);
    for (int t = 0; t < nthreads; ++t) threads.emplace_back(worker);
    for (auto &th : threads) th.join();
  }

  // serial assembly: replay in the serial walker's exact order
  std::vector<std::string> stack{root};
  while (!stack.empty()) {
    std::string dir = std::move(stack.back());
    stack.pop_back();
    auto it = results.find(dir);
    if (it == results.end()) continue;  // raced away
    PDir &res = it->second;
    if (res.open_error) {
      if (err_cb) err_cb(dir.c_str(), res.open_msg.c_str(), ud);
      continue;
    }
    std::vector<std::string> subdirs;
    for (const auto &e : res.ents) {
      std::string p = dir + "/" + e.name;
      if (e.kind == 0) {
        cb(p.c_str(), e.size, ud);
      } else if (e.kind == 2) {
        if (err_cb) err_cb(p.c_str(), e.msg.c_str(), ud);
      } else {
        subdirs.push_back(std::move(p));
      }
    }
    for (auto sit = subdirs.rbegin(); sit != subdirs.rend(); ++sit)
      stack.push_back(std::move(*sit));
  }
  return 0;
}

int gt_pwalk(const char *root, int32_t nthreads, gt_walk_cb cb,
             gt_err_cb err_cb, void *ud) {
  return pwalk_drive(root, nthreads, cb, err_cb, ud, pwalk_scan_dir);
}

int gt_swalk(const char *root, int32_t nthreads, gt_walk_cb cb,
             gt_err_cb err_cb, void *ud) {
  return pwalk_drive(root, nthreads, cb, err_cb, ud, swalk_scan_dir);
}

typedef struct {
  const char *path;   // file to read
  int64_t file_off;   // offset within the file
  int64_t buf_off;    // offset within the destination buffer
  int64_t length;     // bytes to copy
} gt_seg;

// Fill buf from segments using up to nthreads preading workers.
// O_NOATIME is attempted like the reference (grab.cc:139-143) and
// silently dropped on EPERM. Returns number of failed segments.
// If failed != NULL it has nsegs entries; a failed segment i sets
// failed[i] to the (positive) errno so the caller can report the
// reference's per-file "path: strerror" line (grab.cc:267-268) and
// skip the file.
//
// buf is reused batch after batch, so each segment's extent (its
// length rounded up to a multiple of block) is written whole: the
// bytes read, then zeros for the rest -- the padding up to the next
// block, the tail of a short read (the file shrank since the walk's
// stat) and everything past what a failed open or read delivered.
// The extent then reads as it would in a buffer zeroed before the
// fill, whatever the previous batch left there.
int gt_fill2(uint8_t *buf, const gt_seg *segs, int32_t nsegs,
             int32_t nthreads, int32_t *failed, int64_t block) {
  if (nthreads < 1) nthreads = 1;
  if (nthreads > 64) nthreads = 64;
  if (block < 1) block = 1;
  std::atomic<int32_t> next{0};
  std::atomic<int32_t> failures{0};

  auto worker = [&]() {
    for (;;) {
      int32_t i = next.fetch_add(1);
      if (i >= nsegs) return;
      const gt_seg &s = segs[i];
      uint8_t *dst = buf + s.buf_off;
      const int64_t extent = (s.length + block - 1) / block * block;
      int64_t done = 0;
      int flags = O_RDONLY | O_NOCTTY;
#ifdef O_NOATIME
      int fd = open(s.path, flags | O_NOATIME);
      if (fd < 0 && errno == EPERM) fd = open(s.path, flags);
#else
      int fd = open(s.path, flags);
#endif
      if (fd < 0) {
        failures.fetch_add(1);
        if (failed) failed[i] = errno > 0 ? errno : EIO;
      } else {
        while (done < s.length) {
          ssize_t r = pread(fd, dst + done, s.length - done, s.file_off + done);
          if (r < 0) {
            failures.fetch_add(1);
            if (failed) failed[i] = errno > 0 ? errno : EIO;
            break;
          }
          // r == 0: the file shrank since the walk's stat; the caller
          // sees a short read, not an error
          if (r == 0) break;
          done += r;
        }
        close(fd);
      }
      memset(dst + done, 0, extent - done);
    }
  };

  if (failed)
    for (int32_t i = 0; i < nsegs; ++i) failed[i] = 0;
  if (nthreads == 1 || nsegs <= 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    int nt = std::min<int32_t>(nthreads, nsegs);
    threads.reserve(nt);
    for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
    for (auto &th : threads) th.join();
  }
  return failures.load();
}

// Blocked multithreaded 32-bit matrix transpose:
//   dst[g * n_rows + s] = src[s * row_words + g]
// for s in [0, n_rows), g in [0, row_words).
//
// This writes the TPU walk kernel's stream-major layout (word g of
// every packed stream contiguous) directly on the host, so the scan
// buffer uploads BORN in the layout ops/pallas_stridedfa wants and the
// device-side relayout pass disappears from the production DFA tier
// (the analog of the reference's scan loop reading mmap'd bytes in
// exactly the order pcre_exec consumes them, grab.cc:154-178).
//
// Blocking (microbenchmarked against two alternatives, 2.3x the naive
// slab copy): tasks are 16-word (64-byte, one source cache line) slabs
// of the g axis; within a task, source rows are tiled 256 at a time and
// the copy iterates j (dst row) outer, s inner — so WRITES are
// perfectly sequential 1 KiB runs and each 64-byte source line is read
// once per tile and reused by all 16 j's from cache. Tasks are handed
// out dynamically so threads stay balanced.
int gt_transpose32(int32_t *dst, const int32_t *src, int64_t n_rows,
                   int64_t row_words, int32_t nthreads) {
  const int64_t GB = 16;   // words per slab: one 64-byte source line
  const int64_t SB = 256;  // source rows per tile (write run = 1 KiB)
  if (nthreads < 1) nthreads = 1;
  if (nthreads > 64) nthreads = 64;
  int64_t n_blocks = (row_words + GB - 1) / GB;
  std::atomic<int64_t> next{0};

  auto worker = [&]() {
    for (;;) {
      int64_t b = next.fetch_add(1);
      if (b >= n_blocks) return;
      int64_t g0 = b * GB;
      int64_t gn = std::min(GB, row_words - g0);
      for (int64_t s0 = 0; s0 < n_rows; s0 += SB) {
        int64_t sn = std::min(SB, n_rows - s0);
        for (int64_t j = 0; j < gn; ++j) {
          int32_t *dp = dst + (g0 + j) * n_rows + s0;
          const int32_t *sp = src + s0 * row_words + g0 + j;
          for (int64_t s = 0; s < sn; ++s) dp[s] = sp[s * row_words];
        }
      }
    }
  };

  if (nthreads == 1 || n_blocks <= 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    int nt = (int)std::min<int64_t>(nthreads, n_blocks);
    threads.reserve(nt);
    for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
    for (auto &th : threads) th.join();
  }
  return 0;
}

// Simple self-description for the loader's version handshake.
int gt_abi_version(void) { return 5; }

}  // extern "C"
