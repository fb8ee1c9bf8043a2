// Python binding of the DP clip kernels' plain C interface (dp_clip.cu).
// Pointers and the CUDA stream arrive as integers from the wrapper in
// fl4health_tpu_torch/kernels/dp_clip.py; only pybind11 is included, so this
// file compiles in seconds.

#include <pybind11/pybind11.h>

#include <cstdint>
#include <string>

extern "C" {
int dp_chunk_width();
int dp_sq_norms(const void* g, int64_t ld, int64_t W, int B, float* partial, float* out,
                int bf16, void* stream);
int dp_scaled_sum(const void* g, int64_t ld, int64_t W, int B, const float* scale, float* out,
                  int split, int bf16, void* stream);
const char* dp_error_string(int code);
}

namespace {
template <typename T>
T* ptr(std::uintptr_t p) {
  return reinterpret_cast<T*>(p);
}
}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("chunk_width", []() { return dp_chunk_width(); });
  m.def("sq_norms", [](std::uintptr_t g, int64_t ld, int64_t W, int B, std::uintptr_t partial,
                       std::uintptr_t out, bool bf16, std::uintptr_t stream) {
    return dp_sq_norms(ptr<const void>(g), ld, W, B, ptr<float>(partial), ptr<float>(out),
                       bf16 ? 1 : 0, ptr<void>(stream));
  });
  m.def("scaled_sum", [](std::uintptr_t g, int64_t ld, int64_t W, int B, std::uintptr_t scale,
                         std::uintptr_t out, int split, bool bf16, std::uintptr_t stream) {
    return dp_scaled_sum(ptr<const void>(g), ld, W, B, ptr<const float>(scale), ptr<float>(out),
                         split, bf16 ? 1 : 0, ptr<void>(stream));
  });
  m.def("error_string", [](int code) { return std::string(dp_error_string(code)); });
}
