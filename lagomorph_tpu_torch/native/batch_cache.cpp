// Minibatch cache with background read-ahead for the atlas builders of
// lagomorph_tpu_torch (the builders' ``dataloader_cache``).
//
// Each minibatch is stored as a raw binary file; a read-ahead thread loads
// the *next* batch while the caller computes, so the host's data path keeps
// up with the device's step loop.  A copy of lagomorph_tpu's
// native/batch_cache.cpp; bound with ctypes by native/batch_cache.py.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread -o libbatch_cache.so batch_cache.cpp

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Cache {
    std::string dir;
    std::vector<int64_t> sizes;  // bytes per batch file
    // readahead state
    std::thread worker;
    std::mutex mu;
    std::condition_variable cv;
    std::vector<char> buf;       // readahead buffer
    int64_t buf_idx = -1;        // which batch the buffer holds (-1 none)
    int64_t want_idx = -1;       // which batch the worker should load next
    int64_t failed_idx = -1;     // last batch whose readahead read failed
    bool stop = false;

    std::string path(int64_t i) const {
        return dir + "/batch_" + std::to_string(i) + ".bin";
    }

    bool read_file(int64_t i, char* dst, int64_t n) {
        FILE* f = std::fopen(path(i).c_str(), "rb");
        if (!f) return false;
        size_t got = std::fread(dst, 1, (size_t)n, f);
        std::fclose(f);
        return got == (size_t)n;
    }

    void worker_loop() {
        std::unique_lock<std::mutex> lk(mu);
        while (true) {
            cv.wait(lk, [&] { return stop || (want_idx >= 0 && want_idx != buf_idx); });
            if (stop) return;
            int64_t idx = want_idx;
            int64_t n = sizes[(size_t)idx];
            if ((int64_t)buf.size() < n) buf.resize((size_t)n);
            lk.unlock();
            bool ok = read_file(idx, buf.data(), n);
            lk.lock();
            if (ok) {
                buf_idx = idx;
                if (failed_idx == idx) failed_idx = -1;
            } else {
                // record the failure and drop the request so the worker does
                // not busy-loop on a bad file; bc_get falls back to a direct
                // read (which reports the error to the caller)
                buf_idx = -1;
                failed_idx = idx;
                if (want_idx == idx) want_idx = -1;
            }
            cv.notify_all();
        }
    }
};

}  // namespace

extern "C" {

void* bc_create(const char* dir, int64_t n_batches) {
    Cache* c = new Cache();
    c->dir = dir;
    c->sizes.assign((size_t)n_batches, 0);
    c->worker = std::thread([c] { c->worker_loop(); });
    return c;
}

// Write batch i (called once during the caching pass).
int bc_write(void* h, int64_t i, const void* data, int64_t nbytes) {
    Cache* c = (Cache*)h;
    FILE* f = std::fopen(c->path(i).c_str(), "wb");
    if (!f) return -1;
    size_t put = std::fwrite(data, 1, (size_t)nbytes, f);
    std::fclose(f);
    if (put != (size_t)nbytes) return -1;
    c->sizes[(size_t)i] = nbytes;
    return 0;
}

// Hint: start loading batch i in the background.
void bc_prefetch(void* h, int64_t i) {
    Cache* c = (Cache*)h;
    std::lock_guard<std::mutex> lk(c->mu);
    if (i >= 0 && i < (int64_t)c->sizes.size() && c->sizes[(size_t)i] > 0) {
        c->want_idx = i;
        c->cv.notify_all();
    }
}

// Blocking: copy batch i into dst (nbytes must equal the written size).
// Uses the readahead buffer when it already holds batch i.
int bc_get(void* h, int64_t i, void* dst, int64_t nbytes) {
    Cache* c = (Cache*)h;
    if (i < 0 || i >= (int64_t)c->sizes.size()) return -1;
    if (c->sizes[(size_t)i] != nbytes) return -2;
    {
        std::unique_lock<std::mutex> lk(c->mu);
        if (c->want_idx == i) {
            // wait for in-flight readahead of this batch (or its failure)
            c->cv.wait(lk, [&] {
                return c->buf_idx == i || c->failed_idx == i || c->stop;
            });
        }
        if (c->buf_idx == i) {
            std::memcpy(dst, c->buf.data(), (size_t)nbytes);
            return 0;
        }
    }
    return c->read_file(i, (char*)dst, nbytes) ? 0 : -3;
}

int64_t bc_size(void* h, int64_t i) {
    Cache* c = (Cache*)h;
    if (i < 0 || i >= (int64_t)c->sizes.size()) return -1;
    return c->sizes[(size_t)i];
}

void bc_destroy(void* h) {
    Cache* c = (Cache*)h;
    {
        std::lock_guard<std::mutex> lk(c->mu);
        c->stop = true;
        c->cv.notify_all();
    }
    c->worker.join();
    delete c;
}

}  // extern "C"
