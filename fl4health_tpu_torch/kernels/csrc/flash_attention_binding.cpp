// Python binding of the flash-attention kernels' plain C interface
// (flash_attention.cu, flash_attention_wgmma.cu). Pointers and the CUDA stream arrive as integers from
// the wrapper in fl4health_tpu_torch/kernels/flash_attention.py; only
// pybind11 is included, so this file compiles in seconds.

#include <pybind11/pybind11.h>

#include <cstdint>
#include <string>

extern "C" {
int flash_fwd(const void* q, const void* k, const void* v, const float* mask, void* o,
              float* lse, int B, int T, int H, int d, float scale, int bf16, void* stream);
int flash_bwd_dq(const void* q, const void* k, const void* v, const float* mask, const void* dout,
                 const float* lse, const float* delta, void* dq, int B, int T, int H, int d,
                 float scale, int bf16, void* stream);
int flash_bwd_dkv(const void* q, const void* k, const void* v, const float* mask,
                  const void* dout, const float* lse, const float* delta, void* dk, void* dv,
                  int B, int T, int H, int d, float scale, int bf16, void* stream);
int flash_fwd_wgmma(const void* q, const void* k, const void* v, const float* mask, void* o,
                    float* lse, int B, int T, int H, int d, float scale, void* stream);
int flash_bwd_dq_wgmma(const void* q, const void* k, const void* v, const float* mask,
                       const void* dout, const float* lse, const float* delta, void* dq, int B,
                       int T, int H, int d, float scale, void* stream);
int flash_bwd_dkv_wgmma(const void* q, const void* k, const void* v, const float* mask,
                        const void* dout, const float* lse, const float* delta, void* dk,
                        void* dv, int B, int T, int H, int d, float scale, void* stream);
const char* flash_wgmma_error_string(int code);
}

namespace {
template <typename T>
T* ptr(std::uintptr_t p) {
  return reinterpret_cast<T*>(p);
}
}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("fwd", [](std::uintptr_t q, std::uintptr_t k, std::uintptr_t v, std::uintptr_t mask,
                  std::uintptr_t o, std::uintptr_t lse, int B, int T, int H, int d, float scale,
                  bool bf16, std::uintptr_t stream) {
    return flash_fwd(ptr<const void>(q), ptr<const void>(k), ptr<const void>(v),
                     ptr<const float>(mask), ptr<void>(o), ptr<float>(lse), B, T, H, d, scale,
                     bf16 ? 1 : 0, ptr<void>(stream));
  });
  m.def("bwd_dq", [](std::uintptr_t q, std::uintptr_t k, std::uintptr_t v, std::uintptr_t mask,
                     std::uintptr_t dout, std::uintptr_t lse, std::uintptr_t delta,
                     std::uintptr_t dq, int B, int T, int H, int d, float scale, bool bf16,
                     std::uintptr_t stream) {
    return flash_bwd_dq(ptr<const void>(q), ptr<const void>(k), ptr<const void>(v),
                        ptr<const float>(mask), ptr<const void>(dout), ptr<const float>(lse),
                        ptr<const float>(delta), ptr<void>(dq), B, T, H, d, scale, bf16 ? 1 : 0,
                        ptr<void>(stream));
  });
  m.def("bwd_dkv", [](std::uintptr_t q, std::uintptr_t k, std::uintptr_t v, std::uintptr_t mask,
                      std::uintptr_t dout, std::uintptr_t lse, std::uintptr_t delta,
                      std::uintptr_t dk, std::uintptr_t dv, int B, int T, int H, int d,
                      float scale, bool bf16, std::uintptr_t stream) {
    return flash_bwd_dkv(ptr<const void>(q), ptr<const void>(k), ptr<const void>(v),
                         ptr<const float>(mask), ptr<const void>(dout), ptr<const float>(lse),
                         ptr<const float>(delta), ptr<void>(dk), ptr<void>(dv), B, T, H, d, scale,
                         bf16 ? 1 : 0, ptr<void>(stream));
  });
  m.def("fwd_wgmma", [](std::uintptr_t q, std::uintptr_t k, std::uintptr_t v,
                        std::uintptr_t mask, std::uintptr_t o, std::uintptr_t lse, int B, int T,
                        int H, int d, float scale, std::uintptr_t stream) {
    return flash_fwd_wgmma(ptr<const void>(q), ptr<const void>(k), ptr<const void>(v),
                           ptr<const float>(mask), ptr<void>(o), ptr<float>(lse), B, T, H, d,
                           scale, ptr<void>(stream));
  });
  m.def("bwd_dq_wgmma", [](std::uintptr_t q, std::uintptr_t k, std::uintptr_t v,
                           std::uintptr_t mask, std::uintptr_t dout, std::uintptr_t lse,
                           std::uintptr_t delta, std::uintptr_t dq, int B, int T, int H, int d,
                           float scale, std::uintptr_t stream) {
    return flash_bwd_dq_wgmma(ptr<const void>(q), ptr<const void>(k), ptr<const void>(v),
                              ptr<const float>(mask), ptr<const void>(dout), ptr<const float>(lse),
                              ptr<const float>(delta), ptr<void>(dq), B, T, H, d, scale,
                              ptr<void>(stream));
  });
  m.def("bwd_dkv_wgmma", [](std::uintptr_t q, std::uintptr_t k, std::uintptr_t v,
                            std::uintptr_t mask, std::uintptr_t dout, std::uintptr_t lse,
                            std::uintptr_t delta, std::uintptr_t dk, std::uintptr_t dv, int B,
                            int T, int H, int d, float scale, std::uintptr_t stream) {
    return flash_bwd_dkv_wgmma(ptr<const void>(q), ptr<const void>(k), ptr<const void>(v),
                               ptr<const float>(mask), ptr<const void>(dout),
                               ptr<const float>(lse), ptr<const float>(delta), ptr<void>(dk),
                               ptr<void>(dv), B, T, H, d, scale, ptr<void>(stream));
  });
  // the CUDA runtime's messages, and the tensor-map encoder's two codes
  m.def("error_string",
        [](int code) { return std::string(flash_wgmma_error_string(code)); });
}
