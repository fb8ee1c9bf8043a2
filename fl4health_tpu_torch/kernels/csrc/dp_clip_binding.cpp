// Python binding of the DP clip kernels' plain C interface (dp_clip.cu).
// Pointers and the CUDA stream arrive as integers from the wrapper in
// fl4health_tpu_torch/kernels/dp_clip.py, K1's leaf table as a flat list of
// integers; only pybind11 is included, so this file compiles in seconds.

#include <pybind11/pybind11.h>
#include <pybind11/stl.h>

#include <cstdint>
#include <string>
#include <vector>

extern "C" {
int dp_sq_norms_tree(const int64_t* leaves, int n_leaves, int n_items, int B, int client_rows,
                     float* ws, unsigned* counter, float* out, int accumulate, void* stream);
int dp_scaled_sum(const void* g, int64_t ld, int64_t cs, int64_t W, int B, int N,
                  const float* scale, float* out, int split, int bf16, void* stream);
const char* dp_error_string(int code);
}

namespace {
template <typename T>
T* ptr(std::uintptr_t p) {
  return reinterpret_cast<T*>(p);
}
}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  // leaves: 10 integers a leaf (dp_clip.cu, dp_sq_norms_tree)
  m.def("sq_norms_tree", [](const std::vector<int64_t>& leaves, int n_items, int B,
                            int client_rows, std::uintptr_t ws, std::uintptr_t counter,
                            std::uintptr_t out, bool accumulate, std::uintptr_t stream) {
    if (leaves.empty() || leaves.size() % 10 != 0) return 1;  // cudaErrorInvalidValue
    return dp_sq_norms_tree(leaves.data(), (int)(leaves.size() / 10), n_items, B, client_rows,
                            ptr<float>(ws), ptr<unsigned>(counter), ptr<float>(out),
                            accumulate ? 1 : 0, ptr<void>(stream));
  });
  m.def("scaled_sum", [](std::uintptr_t g, int64_t ld, int64_t cs, int64_t W, int B, int N,
                         std::uintptr_t scale, std::uintptr_t out, int split, bool bf16,
                         std::uintptr_t stream) {
    return dp_scaled_sum(ptr<const void>(g), ld, cs, W, B, N, ptr<const float>(scale),
                         ptr<float>(out), split, bf16 ? 1 : 0, ptr<void>(stream));
  });
  m.def("error_string", [](int code) { return std::string(dp_error_string(code)); });
}
