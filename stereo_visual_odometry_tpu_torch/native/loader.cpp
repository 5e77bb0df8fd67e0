// Native data loader: libpng grayscale decode + threaded stereo prefetch.
//
// Port of stereo_visual_odometry_tpu/native/loader.cpp (the same code). It
// replaces the reference's in-loop cv::imread
// (reference/src/System.cpp:80-86), which serializes image decode with
// tracking compute. Here decode runs on background threads into a bounded
// ring of preallocated, edge-padded static-shape buffers, so the host feeds
// the device without stalls. Exposed as a plain C ABI for ctypes.
//
// Built at first use by loader.py: g++ -O3 -shared -fPIC -std=c++17 loader.cpp
// -lpng -lpthread, into the package's _build/.

#include <png.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

// Decode one 8-bit PNG to grayscale, edge-padding into a (H, W) buffer.
// Any bit depth/color type is converted to 8-bit gray. Returns 0 on success.
int decode_gray_padded(const char* path, uint8_t* out, int H, int W,
                       int* img_h, int* img_w) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return -1;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    std::fclose(fp);
    return -2;
  }
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    std::fclose(fp);
    return -2;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return -3;
  }
  png_init_io(png, fp);
  png_read_info(png, info);

  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);

  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  if (color == PNG_COLOR_TYPE_RGB || color == PNG_COLOR_TYPE_RGB_ALPHA ||
      color == PNG_COLOR_TYPE_PALETTE)
    png_set_rgb_to_gray_fixed(png, 1, -1, -1);
  png_read_update_info(png, info);

  if ((int)h > H || (int)w > W) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return -4;  // static buffer too small
  }

  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; ++y) rows[y] = out + (size_t)y * W;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);

  // Edge-pad right columns and bottom rows (replicate).
  for (png_uint_32 y = 0; y < h; ++y) {
    uint8_t edge = out[(size_t)y * W + (w - 1)];
    std::memset(out + (size_t)y * W + w, edge, W - w);
  }
  for (int y = h; y < H; ++y)
    std::memcpy(out + (size_t)y * W, out + (size_t)(h - 1) * W, W);

  if (img_h) *img_h = (int)h;
  if (img_w) *img_w = (int)w;
  return 0;
}

struct StereoSlot {
  std::vector<uint8_t> left, right;
  int index = -1;
  int status = 0;
};

struct Prefetcher {
  std::vector<std::string> paths_l, paths_r;
  int H = 0, W = 0;
  size_t next_submit = 0;

  std::mutex mu;
  std::condition_variable cv_ready;
  std::queue<StereoSlot*> ready;           // decoded, ordered by index
  std::vector<std::thread> workers;
  std::vector<StereoSlot> slots;
  std::atomic<bool> stop{false};
  std::atomic<size_t> next_decode{0};
  size_t next_consume = 0;
  std::mutex order_mu;
  std::condition_variable cv_order;
  std::vector<StereoSlot*> done_by_index;  // indexed completion board

  void worker() {
    for (;;) {
      size_t i = next_decode.fetch_add(1);
      if (stop.load() || i >= paths_l.size()) return;
      StereoSlot* slot = &slots[i % slots.size()];
      // Wait until the consumer has drained the previous occupant of this
      // ring slot (index i - slots.size()).
      {
        std::unique_lock<std::mutex> lk(order_mu);
        cv_order.wait(lk, [&] {
          return stop.load() || next_consume + slots.size() > i;
        });
        if (stop.load()) return;
      }
      slot->index = (int)i;
      int rc1 = decode_gray_padded(paths_l[i].c_str(), slot->left.data(), H, W,
                                   nullptr, nullptr);
      int rc2 = decode_gray_padded(paths_r[i].c_str(), slot->right.data(), H, W,
                                   nullptr, nullptr);
      slot->status = (rc1 == 0 && rc2 == 0) ? 0 : -1;
      {
        std::lock_guard<std::mutex> lk(order_mu);
        done_by_index[i] = slot;
      }
      cv_order.notify_all();
    }
  }
};

}  // namespace

extern "C" {

int svo_decode_png_gray(const char* path, uint8_t* out, int H, int W,
                        int* img_h, int* img_w) {
  return decode_gray_padded(path, out, H, W, img_h, img_w);
}

void* svo_prefetch_create(const char** left, const char** right, int n, int H,
                          int W, int depth, int n_threads) {
  auto* p = new Prefetcher();
  p->paths_l.assign(left, left + n);
  p->paths_r.assign(right, right + n);
  p->H = H;
  p->W = W;
  int slots = depth > 0 ? depth : 4;
  p->slots.resize(slots);
  for (auto& s : p->slots) {
    s.left.resize((size_t)H * W);
    s.right.resize((size_t)H * W);
  }
  p->done_by_index.assign(n, nullptr);
  int nt = n_threads > 0 ? n_threads : 2;
  for (int t = 0; t < nt; ++t)
    p->workers.emplace_back([p] { p->worker(); });
  return p;
}

// Copies the next frame pair (in submission order) into out_l/out_r.
// Returns the frame index, or -1 when exhausted, -2 on decode error.
int svo_prefetch_next(void* handle, uint8_t* out_l, uint8_t* out_r) {
  auto* p = static_cast<Prefetcher*>(handle);
  size_t i = p->next_consume;
  if (i >= p->paths_l.size()) return -1;
  StereoSlot* slot = nullptr;
  {
    std::unique_lock<std::mutex> lk(p->order_mu);
    p->cv_order.wait(lk, [&] { return p->done_by_index[i] != nullptr; });
    slot = p->done_by_index[i];
  }
  int rc = slot->status;
  if (rc == 0) {
    std::memcpy(out_l, slot->left.data(), (size_t)p->H * p->W);
    std::memcpy(out_r, slot->right.data(), (size_t)p->H * p->W);
  }
  {
    std::lock_guard<std::mutex> lk(p->order_mu);
    p->next_consume = i + 1;
  }
  p->cv_order.notify_all();
  return rc == 0 ? (int)i : -2;
}

void svo_prefetch_destroy(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  p->stop.store(true);
  p->cv_order.notify_all();
  for (auto& t : p->workers) t.join();
  delete p;
}

}  // extern "C"
