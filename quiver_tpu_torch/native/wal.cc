// Native WAL engine — group-commit append log with CRC32C framing.
//
// The runtime around the TPU compute path is native where it is hot
// (SURVEY.md §5.4: the reference's WAL is its durability backbone). This
// writer exists because the host-side journal is on the ingest critical
// path: Python-level per-append fsync caps ingest at the disk's fsync rate,
// and even group-committed Python writes pay interpreter overhead per batch.
//
// Design:
//   * append(buf, len) enqueues one already-serialized record batch into an
//     in-memory ring guarded by a mutex;
//   * a background committer thread drains the ring with one writev + one
//     fdatasync per drain (group commit), so concurrent writers share
//     syncs;
//   * each record is framed [u32 len][u32 crc32c][payload] so torn tails
//     are detected exactly (the JSON-lines format detects them only
//     heuristically);
//   * sync() barriers: returns once everything enqueued before the call is
//     durable.
//
// Exposed as a tiny C ABI consumed via ctypes (no pybind11 in this
// environment): qwal_open / qwal_append / qwal_sync / qwal_close /
// qwal_read_frames.

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <condition_variable>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

namespace {

// CRC32C (Castagnoli), bitwise-sliced table implementation.
uint32_t crc32c_table[256];
struct CrcInit {
  CrcInit() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++)
        c = (c & 1) ? (0x82F63B78u ^ (c >> 1)) : (c >> 1);
      crc32c_table[i] = c;
    }
  }
} crc_init;

uint32_t crc32c(const uint8_t* data, size_t len) {
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < len; i++)
    c = crc32c_table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

struct Wal {
  int fd = -1;
  std::mutex mu;
  std::condition_variable cv_data;   // committer wakeup
  std::condition_variable cv_done;   // sync() barrier / drain-complete
  std::deque<std::string> queue;     // framed records awaiting commit
  uint64_t enqueued = 0;             // records ever enqueued
  uint64_t durable = 0;              // records fdatasync'd
  bool stop = false;
  bool failed = false;     // unrecoverable write/fsync error; log is wedged
  bool committing = false; // a drain's write() is in flight (mutex released)
  std::thread committer;

  void run() {
    std::unique_lock<std::mutex> lk(mu);
    while (true) {
      cv_data.wait(lk, [&] { return stop || !queue.empty(); });
      if (queue.empty() && stop) break;
      // drain everything currently queued: ONE write + ONE fdatasync
      std::string blob;
      uint64_t n = 0;
      while (!queue.empty()) {
        blob += queue.front();
        queue.pop_front();
        n++;
      }
      committing = true;  // truncate must not interleave with this write
      lk.unlock();
      bool ok = true;
      size_t off = 0;
      while (off < blob.size()) {
        ssize_t w = ::write(fd, blob.data() + off, blob.size() - off);
        if (w < 0 && errno == EINTR) continue;  // signal, not a disk error
        if (w <= 0) { ok = false; break; }  // disk error
        off += static_cast<size_t>(w);
      }
      while (ok && ::fdatasync(fd) != 0) {
        if (errno != EINTR) { ok = false; }
      }
      lk.lock();
      committing = false;
      if (ok) {
        durable += n;
      } else {
        // Surface the failure instead of wedging every future sync():
        // mark the log failed so qwal_sync/qwal_append return errors, and
        // wake all waiters so they observe it.
        failed = true;
      }
      cv_done.notify_all();
    }
  }
};

}  // namespace

extern "C" {

Wal* qwal_open(const char* path) {
  int fd = ::open(path, O_WRONLY | O_CREAT | O_APPEND, 0644);
  if (fd < 0) return nullptr;
  Wal* w = new Wal();
  w->fd = fd;
  w->committer = std::thread([w] { w->run(); });
  return w;
}

// Enqueue one framed record; returns its sequence number (>=1), 0 on error
// (null args, or the log has hit an unrecoverable disk error).
uint64_t qwal_append(Wal* w, const uint8_t* data, uint32_t len) {
  if (!w || !data) return 0;
  std::string frame;
  frame.resize(8 + len);
  uint32_t crc = crc32c(data, len);
  std::memcpy(&frame[0], &len, 4);
  std::memcpy(&frame[4], &crc, 4);
  std::memcpy(&frame[8], data, len);
  std::lock_guard<std::mutex> lk(w->mu);
  if (w->failed) return 0;
  w->queue.emplace_back(std::move(frame));
  uint64_t seq = ++w->enqueued;
  w->cv_data.notify_one();
  return seq;
}

// Block until record `seq` (or everything if seq==0) is durable.
// Returns 0 on success, -1 if the log failed (records NOT durable).
int qwal_sync(Wal* w, uint64_t seq) {
  if (!w) return -1;
  std::unique_lock<std::mutex> lk(w->mu);
  uint64_t target = seq ? seq : w->enqueued;
  w->cv_done.wait(lk, [&] { return w->durable >= target || w->failed; });
  return (w->durable >= target) ? 0 : -1;
}

// Truncate the log file in place. Waits for any in-flight drain to finish
// (the committer writes with the mutex released; ftruncate interleaving
// with a partial group-commit write would leave a corrupt frame at offset
// 0) before cutting the file. Records still queued survive and commit
// after truncation. NOTE: the persistence layer now prefers segment
// rotation over in-place truncation (see persistence/manager.py); this
// stays for API completeness.
void qwal_truncate(Wal* w) {
  if (!w) return;
  std::unique_lock<std::mutex> lk(w->mu);
  w->cv_done.wait(lk, [&] { return !w->committing; });
  ::ftruncate(w->fd, 0);
  ::lseek(w->fd, 0, SEEK_SET);
}

void qwal_close(Wal* w) {
  if (!w) return;
  {
    std::lock_guard<std::mutex> lk(w->mu);
    w->stop = true;
    w->cv_data.notify_one();
  }
  w->committer.join();
  ::close(w->fd);
  delete w;
}

// Read all intact frames from a WAL file into a caller buffer of
// newline-separated payloads (for JSON-lines payloads this yields the same
// shape the Python reader consumes). Returns bytes written, or the required
// size if out==nullptr. Torn/corrupt tails are cut at the last valid frame.
uint64_t qwal_read_frames(const char* path, uint8_t* out, uint64_t out_cap) {
  FILE* f = ::fopen(path, "rb");
  if (!f) return 0;
  std::vector<uint8_t> file;
  uint8_t buf[1 << 16];
  size_t r;
  while ((r = ::fread(buf, 1, sizeof(buf), f)) > 0)
    file.insert(file.end(), buf, buf + r);
  ::fclose(f);
  uint64_t written = 0;
  size_t off = 0;
  while (off + 8 <= file.size()) {
    uint32_t len, crc;
    std::memcpy(&len, &file[off], 4);
    std::memcpy(&crc, &file[off + 4], 4);
    if (off + 8 + len > file.size()) break;  // torn tail
    if (crc32c(&file[off + 8], len) != crc) break;  // corrupt: stop here
    if (out) {
      if (written + len + 1 > out_cap) break;
      std::memcpy(out + written, &file[off + 8], len);
      out[written + len] = '\n';
    }
    written += len + 1;
    off += 8 + len;
  }
  return written;
}

}  // extern "C"
