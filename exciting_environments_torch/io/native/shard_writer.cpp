// Asynchronous shard writer: a background thread drains a bounded queue of
// byte buffers to disk so the Python side (and the GPU work it drives)
// never blocks on file IO.  Exposed through a minimal C ABI consumed via
// ctypes — no Python headers required.
//
// Part of the data-generation pipeline of exciting-environments-torch (the
// same source and ABI as the JAX package's writer, so both write the same
// shards): rollout collectors produce multi-GB trajectory batches on the
// device; this sink overlaps host serialization with the next rollout.

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

struct ShardWriter {
  explicit ShardWriter(const char* path, uint64_t max_queue_bytes)
      : file(std::fopen(path, "wb")), max_queue(max_queue_bytes) {}

  ~ShardWriter() {
    if (file != nullptr) std::fclose(file);
  }

  std::FILE* file;
  uint64_t max_queue;

  std::mutex mu;
  std::condition_variable cv_push;  // signalled when queue drains
  std::condition_variable cv_pop;   // signalled when work arrives
  std::deque<std::vector<uint8_t>> queue;
  uint64_t queued_bytes = 0;
  uint64_t written_bytes = 0;
  bool closing = false;
  bool io_error = false;
  std::thread worker;

  void Run() {
    for (;;) {
      std::vector<uint8_t> buf;
      {
        std::unique_lock<std::mutex> lock(mu);
        cv_pop.wait(lock, [&] { return closing || !queue.empty(); });
        if (queue.empty()) {
          if (closing) return;
          continue;
        }
        buf = std::move(queue.front());
        queue.pop_front();
        queued_bytes -= buf.size();
        cv_push.notify_all();
      }
      bool skip;
      {
        std::lock_guard<std::mutex> lock(mu);
        skip = buf.empty() || io_error;
      }
      if (!skip) {
        size_t n = std::fwrite(buf.data(), 1, buf.size(), file);
        std::lock_guard<std::mutex> lock(mu);
        if (n != buf.size()) {
          io_error = true;
          cv_push.notify_all();  // wake producers blocked on backpressure
        } else {
          written_bytes += n;
        }
      }
    }
  }
};

}  // namespace

extern "C" {

// Open a shard for writing.  max_queue_bytes bounds the in-flight buffer
// memory (a producer enqueueing past it blocks until the disk catches up).
// Returns nullptr when the file cannot be opened.
void* shard_writer_open(const char* path, uint64_t max_queue_bytes) {
  auto* w = new ShardWriter(path, max_queue_bytes);
  if (w->file == nullptr) {
    delete w;
    return nullptr;
  }
  w->worker = std::thread(&ShardWriter::Run, w);
  return w;
}

// Enqueue nbytes for background writing (copies the data).  Returns 0 on
// success, nonzero if the writer is closing or a previous IO error occurred.
int shard_writer_write(void* handle, const void* data, uint64_t nbytes) {
  auto* w = static_cast<ShardWriter*>(handle);
  std::vector<uint8_t> buf(nbytes);
  std::memcpy(buf.data(), data, nbytes);
  std::unique_lock<std::mutex> lock(w->mu);
  if (w->closing || w->io_error) return 1;
  w->cv_push.wait(lock, [&] {
    return w->queued_bytes <= w->max_queue || w->io_error || w->closing;
  });
  // An IO error (or close) may have happened while we were blocked on
  // backpressure — report it instead of enqueueing into a dead writer.
  if (w->closing || w->io_error) return 1;
  w->queued_bytes += nbytes;
  w->queue.push_back(std::move(buf));
  w->cv_pop.notify_one();
  return 0;
}

// Flush everything, join the worker, close the file.  Returns the number of
// bytes written, or UINT64_MAX on IO error.
uint64_t shard_writer_close(void* handle) {
  auto* w = static_cast<ShardWriter*>(handle);
  {
    std::lock_guard<std::mutex> lock(w->mu);
    w->closing = true;
    w->cv_pop.notify_all();
    w->cv_push.notify_all();
  }
  w->worker.join();
  // The final stdio flush can itself fail (ENOSPC/EIO on the buffered shard
  // tail); fold its result into the status so close never reports a short
  // shard as success.  Null the handle so the destructor does not re-close.
  bool flush_failed = false;
  if (w->file != nullptr) {
    flush_failed = std::fflush(w->file) != 0 || std::ferror(w->file) != 0;
    if (std::fclose(w->file) != 0) flush_failed = true;
    w->file = nullptr;
  }
  uint64_t written = (w->io_error || flush_failed) ? UINT64_MAX : w->written_bytes;
  delete w;
  return written;
}

// Bytes currently waiting in the queue (for tests/monitoring).
uint64_t shard_writer_pending(void* handle) {
  auto* w = static_cast<ShardWriter*>(handle);
  std::lock_guard<std::mutex> lock(w->mu);
  return w->queued_bytes;
}

}  // extern "C"
