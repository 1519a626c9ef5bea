// itpu_io — native host runtime of the PyTorch + CUDA port.
//
// The port's own copy of the JAX package's native/itpu_io.cpp, built by
// utils/native.py. It differs in one place: the prefetcher keeps the frames
// it pulled out of order in a stash of its own, under its mutex, where the
// original keeps one `static thread_local` stash for every prefetcher of the
// thread (so two prefetchers read in turn on one thread handed each other
// frames). This library is the native equivalent of the reference's
// host-side runtime pieces:
//   - PPM/PGM image IO            (reference: Utils/FileUtils.cpp:251-424)
//   - threaded dataset prefetcher (reference: Engine/ImageSourceEngine.cpp's
//                                  one-frame cache, widened to a real
//                                  multi-threaded loader)
//   - binary STL mesh writer      (reference: Objects/ITMMesh.h:64-113)
//   - raw block store persistence (reference: ORUtils/MemoryBlockPersister.h)
//
// Exposed as a C ABI for ctypes (no pybind11 in this environment).

#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- PGM/PPM

// Parse "P5"/"P6" header. Returns offset of pixel data, or -1.
static long parse_pnm_header(FILE* f, int magic_digit, int* w, int* h, int* maxval) {
  char m0 = fgetc(f), m1 = fgetc(f);
  if (m0 != 'P' || m1 != '0' + magic_digit) return -1;
  int vals[3], got = 0;
  while (got < 3) {
    int c = fgetc(f);
    if (c == EOF) return -1;
    if (c == '#') {  // comment to end of line
      while (c != '\n' && c != EOF) c = fgetc(f);
      continue;
    }
    if (c == ' ' || c == '\t' || c == '\n' || c == '\r') continue;
    int v = 0;
    while (c >= '0' && c <= '9') {
      v = v * 10 + (c - '0');
      c = fgetc(f);
    }
    vals[got++] = v;
  }
  *w = vals[0];
  *h = vals[1];
  *maxval = vals[2];
  return ftell(f);
}

// Read a binary PGM into out (uint16, host-endian). Returns 0 on success.
int itpu_read_pgm(const char* path, uint16_t* out, int* w, int* h) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int maxval;
  if (parse_pnm_header(f, 5, w, h, &maxval) < 0) {
    fclose(f);
    return -2;
  }
  size_t n = (size_t)(*w) * (*h);
  if (maxval > 255) {
    if (fread(out, 2, n, f) != n) {
      fclose(f);
      return -3;
    }
    // PNM 16-bit is big-endian
    for (size_t i = 0; i < n; i++) out[i] = (uint16_t)((out[i] >> 8) | (out[i] << 8));
  } else {
    std::vector<uint8_t> buf(n);
    if (fread(buf.data(), 1, n, f) != n) {
      fclose(f);
      return -3;
    }
    for (size_t i = 0; i < n; i++) out[i] = buf[i];
  }
  fclose(f);
  return 0;
}

// Read a binary PPM into out (uint8 rgb). Returns 0 on success.
int itpu_read_ppm(const char* path, uint8_t* out, int* w, int* h) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int maxval;
  if (parse_pnm_header(f, 6, w, h, &maxval) < 0) {
    fclose(f);
    return -2;
  }
  size_t n = (size_t)(*w) * (*h) * 3;
  if (fread(out, 1, n, f) != n) {
    fclose(f);
    return -3;
  }
  fclose(f);
  return 0;
}

int itpu_write_pgm(const char* path, const uint16_t* data, int w, int h) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  fprintf(f, "P5\n%d %d\n65535\n", w, h);
  size_t n = (size_t)w * h;
  std::vector<uint16_t> be(n);
  for (size_t i = 0; i < n; i++) be[i] = (uint16_t)((data[i] >> 8) | (data[i] << 8));
  fwrite(be.data(), 2, n, f);
  fclose(f);
  return 0;
}

int itpu_write_ppm(const char* path, const uint8_t* data, int w, int h) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  fprintf(f, "P6\n%d %d\n255\n", w, h);
  fwrite(data, 1, (size_t)w * h * 3, f);
  fclose(f);
  return 0;
}

// ---------------------------------------------------------------- STL

// Binary STL (reference ITMMesh::WriteSTL layout): triangles [T][3][3] f32.
int itpu_write_stl(const char* path, const float* tris, int n_tris) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  char header[80] = {0};
  fwrite(header, 1, 80, f);
  uint32_t n = (uint32_t)n_tris;
  fwrite(&n, 4, 1, f);
  for (int t = 0; t < n_tris; t++) {
    const float* p0 = tris + t * 9;
    const float* p1 = p0 + 3;
    const float* p2 = p0 + 6;
    float u[3] = {p1[0] - p0[0], p1[1] - p0[1], p1[2] - p0[2]};
    float v[3] = {p2[0] - p0[0], p2[1] - p0[1], p2[2] - p0[2]};
    float nrm[3] = {u[1] * v[2] - u[2] * v[1], u[2] * v[0] - u[0] * v[2],
                    u[0] * v[1] - u[1] * v[0]};
    float len = nrm[0] * nrm[0] + nrm[1] * nrm[1] + nrm[2] * nrm[2];
    if (len > 0) {
      len = 1.0f / sqrtf(len);
      nrm[0] *= len; nrm[1] *= len; nrm[2] *= len;
    }
    fwrite(nrm, 4, 3, f);
    fwrite(p0, 4, 9, f);
    uint16_t attr = 0;
    fwrite(&attr, 2, 1, f);
  }
  fclose(f);
  return 0;
}

// ------------------------------------------------- threaded frame prefetcher

struct Prefetcher {
  std::vector<std::string> depth_paths, rgb_paths;
  int width = 0, height = 0;
  size_t next_submit = 0;
  struct Frame {
    std::vector<uint16_t> depth;
    std::vector<uint8_t> rgb;
    int ok = 0;
  };
  std::queue<std::pair<size_t, Frame>> ready;
  // frames pulled out of `ready` while waiting for another index
  std::vector<std::pair<size_t, Frame>> stash;
  std::mutex mu;
  std::condition_variable cv;
  std::vector<std::thread> workers;
  std::atomic<size_t> submitted{0};
  std::atomic<bool> stop{false};

  void worker_loop() {
    while (!stop.load()) {
      size_t idx = submitted.fetch_add(1);
      if (idx >= depth_paths.size()) break;
      Frame fr;
      int w, h;
      fr.depth.resize((size_t)width * height);
      fr.ok = itpu_read_pgm(depth_paths[idx].c_str(), fr.depth.data(), &w, &h) == 0;
      if (fr.ok && !rgb_paths.empty() && !rgb_paths[idx].empty()) {
        fr.rgb.resize((size_t)width * height * 3);
        itpu_read_ppm(rgb_paths[idx].c_str(), fr.rgb.data(), &w, &h);
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        ready.emplace(idx, std::move(fr));
      }
      cv.notify_all();
    }
  }
};

// Create a prefetcher over newline-separated path lists. rgb_list may be "".
void* itpu_prefetcher_create(const char* depth_list, const char* rgb_list, int width,
                             int height, int n_threads) {
  auto* p = new Prefetcher();
  p->width = width;
  p->height = height;
  auto split = [](const char* s, std::vector<std::string>& out) {
    if (!s || !*s) return;
    const char* start = s;
    for (const char* c = s;; c++) {
      if (*c == '\n' || *c == '\0') {
        if (c > start) out.emplace_back(start, c - start);
        if (*c == '\0') break;
        start = c + 1;
      }
    }
  };
  split(depth_list, p->depth_paths);
  split(rgb_list, p->rgb_paths);
  if (n_threads < 1) n_threads = 1;
  for (int i = 0; i < n_threads; i++)
    p->workers.emplace_back(&Prefetcher::worker_loop, p);
  return p;
}

// Blocking fetch of frame `index` (frames may complete out of order inside;
// this waits until the requested one arrives, keeping the others in the
// prefetcher's stash). Returns 1 ok / 0 missing.
int itpu_prefetcher_get(void* handle, size_t index, uint16_t* depth_out,
                        uint8_t* rgb_out) {
  auto* p = (Prefetcher*)handle;
  std::unique_lock<std::mutex> lk(p->mu);
  for (;;) {
    for (size_t i = 0; i < p->stash.size(); i++) {
      if (p->stash[i].first == index) {
        auto fr = std::move(p->stash[i].second);
        p->stash.erase(p->stash.begin() + i);
        lk.unlock();
        if (!fr.ok) return 0;
        memcpy(depth_out, fr.depth.data(), fr.depth.size() * 2);
        if (rgb_out && !fr.rgb.empty()) memcpy(rgb_out, fr.rgb.data(), fr.rgb.size());
        return 1;
      }
    }
    if (p->ready.empty()) {
      p->cv.wait_for(lk, std::chrono::milliseconds(50));
      if (p->ready.empty() && p->submitted.load() >= p->depth_paths.size() + p->workers.size())
        return 0;  // drained and not found
      continue;
    }
    p->stash.emplace_back(std::move(p->ready.front()));
    p->ready.pop();
  }
}

void itpu_prefetcher_destroy(void* handle) {
  auto* p = (Prefetcher*)handle;
  p->stop.store(true);
  for (auto& t : p->workers) t.join();
  delete p;
}

// ------------------------------------------------- raw block persistence

// Dump/load a raw buffer (reference: MemoryBlockPersister — size header +
// bytes).
int itpu_save_block(const char* path, const void* data, uint64_t n_bytes) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  fwrite(&n_bytes, 8, 1, f);
  fwrite(data, 1, n_bytes, f);
  fclose(f);
  return 0;
}

int64_t itpu_load_block(const char* path, void* data, uint64_t max_bytes) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint64_t n;
  if (fread(&n, 8, 1, f) != 1 || n > max_bytes) {
    fclose(f);
    return -2;
  }
  size_t got = fread(data, 1, n, f);
  fclose(f);
  return (int64_t)got;
}

}  // extern "C"
