// Async file I/O engine for ZeRO-Infinity-style NVMe offload: the port's
// own copy of csrc/aio.cpp.
//
// Reference analogue: csrc/aio/ — deepspeed_aio_handle_t
// (csrc/aio/py_lib/deepspeed_py_aio_handle.cpp: thread pool, block_size /
// queue_depth / single_submit / overlap_events knobs, sync + async
// pread/pwrite + wait()). The reference uses libaio against O_DIRECT fds;
// this engine is a portable POSIX thread pool issuing blocked pread/pwrite
// — same handle API and concurrency structure (requests split into
// block_size chunks spread over queue_depth workers), O_DIRECT attempted
// and dropped where the filesystem refuses it; aio_open reports which mode
// it opened in, so the caller can say which ran.
//
// C ABI (loaded via ctypes, see deepspeed_tpu_torch/ops/cpu/_build.py):
//   aio_handle_new(block_size, queue_depth, num_threads) -> handle*
//   aio_handle_free(handle*)
//   aio_open(path, for_write, direct, &used_direct) -> fd or -errno
//   aio_pread / aio_pwrite        — async, returns request id immediately
//   aio_sync_pread / aio_sync_pwrite — blocking, returns bytes or -errno
//   aio_wait(handle*)             — wait for ALL in-flight requests;
//                                   returns number completed, <0 on error

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cerrno>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <mutex>
#include <string>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Chunk {
    int fd;
    void* buf;
    int64_t nbytes;
    int64_t offset;
    bool write;
    std::atomic<int64_t>* remaining;   // per-request chunk counter
    std::atomic<int64_t>* errors;
};

struct Handle {
    int64_t block_size;
    int queue_depth;
    std::vector<std::thread> workers;
    std::deque<Chunk> queue;
    std::mutex mu;
    std::condition_variable cv;
    std::condition_variable done_cv;
    int64_t inflight = 0;          // chunks queued or running
    bool stop = false;
    std::atomic<int64_t> total_errors{0};
    // per-request bookkeeping
    std::mutex req_mu;
    std::vector<std::pair<std::atomic<int64_t>*, std::atomic<int64_t>*>> reqs;

    void worker() {
        for (;;) {
            Chunk c;
            {
                std::unique_lock<std::mutex> lk(mu);
                cv.wait(lk, [&] { return stop || !queue.empty(); });
                if (stop && queue.empty()) return;
                c = queue.front();
                queue.pop_front();
            }
            int64_t done = 0;
            while (done < c.nbytes) {
                ssize_t r = c.write
                    ? pwrite(c.fd, (char*)c.buf + done, c.nbytes - done,
                             c.offset + done)
                    : pread(c.fd, (char*)c.buf + done, c.nbytes - done,
                            c.offset + done);
                if (r < 0) { c.errors->fetch_add(1); total_errors++; break; }
                if (r == 0) break;  // EOF on read
                done += r;
            }
            c.remaining->fetch_sub(1);
            {
                std::lock_guard<std::mutex> lk(mu);
                if (--inflight == 0) done_cv.notify_all();
            }
        }
    }
};

int64_t submit(Handle* h, int fd, void* buf, int64_t nbytes, int64_t offset,
               bool write) {
    auto* remaining = new std::atomic<int64_t>(0);
    auto* errors = new std::atomic<int64_t>(0);
    int64_t nchunks = (nbytes + h->block_size - 1) / h->block_size;
    if (nchunks == 0) nchunks = 1;
    remaining->store(nchunks);
    {
        std::lock_guard<std::mutex> lk(h->req_mu);
        h->reqs.emplace_back(remaining, errors);
    }
    {
        std::lock_guard<std::mutex> lk(h->mu);
        for (int64_t i = 0; i < nchunks; ++i) {
            int64_t off = i * h->block_size;
            int64_t len = std::min(h->block_size, nbytes - off);
            if (len <= 0) len = 0;
            h->queue.push_back(Chunk{fd, (char*)buf + off, len,
                                     offset + off, write, remaining, errors});
            h->inflight++;
        }
    }
    h->cv.notify_all();
    return nchunks;
}

}  // namespace

extern "C" {

void* aio_handle_new(int64_t block_size, int queue_depth, int num_threads) {
    auto* h = new Handle();
    h->block_size = block_size > 0 ? block_size : (1 << 20);
    h->queue_depth = queue_depth > 0 ? queue_depth : 8;
    int nt = num_threads > 0 ? num_threads : h->queue_depth;
    for (int i = 0; i < nt; ++i)
        h->workers.emplace_back([h] { h->worker(); });
    return h;
}

void aio_handle_free(void* hp) {
    auto* h = (Handle*)hp;
    {
        std::lock_guard<std::mutex> lk(h->mu);
        h->stop = true;
    }
    h->cv.notify_all();
    for (auto& t : h->workers) t.join();
    for (auto& pr : h->reqs) { delete pr.first; delete pr.second; }
    delete h;
}

int aio_open(const char* path, int for_write, int direct, int* used_direct) {
    int flags = for_write ? (O_WRONLY | O_CREAT) : O_RDONLY;
    *used_direct = 0;
#ifdef O_DIRECT
    if (direct) {
        int fd = open(path, flags | O_DIRECT, 0644);
        if (fd >= 0) {
            *used_direct = 1;
            return fd;
        }
        // a filesystem without O_DIRECT (tmpfs, some overlays) refuses
        // the flag with EINVAL: retry buffered, and say so
        if (errno != EINVAL) return -errno;
    }
#endif
    int fd = open(path, flags, 0644);
    return fd < 0 ? -errno : fd;
}

void aio_close(int fd) { close(fd); }

int64_t aio_pread(void* hp, int fd, void* buf, int64_t nbytes,
                  int64_t offset) {
    return submit((Handle*)hp, fd, buf, nbytes, offset, false);
}

int64_t aio_pwrite(void* hp, int fd, void* buf, int64_t nbytes,
                   int64_t offset) {
    return submit((Handle*)hp, fd, buf, nbytes, offset, true);
}

int64_t aio_wait(void* hp) {
    auto* h = (Handle*)hp;
    std::unique_lock<std::mutex> lk(h->mu);
    h->done_cv.wait(lk, [&] { return h->inflight == 0; });
    int64_t errs = h->total_errors.exchange(0);
    {
        std::lock_guard<std::mutex> rlk(h->req_mu);
        for (auto& pr : h->reqs) { delete pr.first; delete pr.second; }
        h->reqs.clear();
    }
    return errs == 0 ? 0 : -errs;
}

int64_t aio_sync_pread(int fd, void* buf, int64_t nbytes, int64_t offset) {
    int64_t done = 0;
    while (done < nbytes) {
        ssize_t r = pread(fd, (char*)buf + done, nbytes - done, offset + done);
        if (r < 0) return -errno;
        if (r == 0) break;
        done += r;
    }
    return done;
}

int64_t aio_sync_pwrite(int fd, void* buf, int64_t nbytes, int64_t offset) {
    int64_t done = 0;
    while (done < nbytes) {
        ssize_t r = pwrite(fd, (char*)buf + done, nbytes - done,
                           offset + done);
        if (r < 0) return -errno;
        done += r;
    }
    return done;
}

}  // extern "C"
