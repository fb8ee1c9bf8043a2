// Python binding of the flash-attention kernels' plain C interface
// (flash_attention.cu, flash_attention_wgmma.cu). Pointers and the CUDA stream arrive as integers from
// the wrapper in fl4health_tpu_torch/kernels/flash_attention.py; only
// pybind11 is included, so this file compiles in seconds. Each entry takes the
// key mask as a pointer, its rows a block and its block stride (flash_mask.cuh).

#include <pybind11/pybind11.h>

#include <cstdint>
#include <string>

extern "C" {
int flash_fwd(const void* q, const void* k, const void* v, const float* mask, int mask_rows,
              long long mask_stride, void* o, float* lse, int B, int T, int H, int d,
              float scale, int bf16, void* stream);
int flash_bwd_dq(const void* q, const void* k, const void* v, const float* mask, int mask_rows,
                 long long mask_stride, const void* dout, const float* lse, const float* delta,
                 void* dq, int B, int T, int H, int d, float scale, int bf16, void* stream);
int flash_bwd_dkv(const void* q, const void* k, const void* v, const float* mask, int mask_rows,
                  long long mask_stride, const void* dout, const float* lse, const float* delta,
                  void* dk, void* dv, int B, int T, int H, int d, float scale, int bf16,
                  void* stream);
int flash_fwd_wgmma(const void* q, const void* k, const void* v, const float* mask,
                    int mask_rows, long long mask_stride, void* o, float* lse, int B, int T,
                    int H, int d, float scale, void* stream);
int flash_bwd_dq_wgmma(const void* q, const void* k, const void* v, const float* mask,
                       int mask_rows, long long mask_stride, const void* dout, const float* lse,
                       const float* delta, void* dq, int B, int T, int H, int d, float scale,
                       void* stream);
int flash_bwd_dkv_wgmma(const void* q, const void* k, const void* v, const float* mask,
                        int mask_rows, long long mask_stride, const void* dout, const float* lse,
                        const float* delta, void* dk, void* dv, int B, int T, int H, int d,
                        float scale, void* stream);
const char* flash_wgmma_error_string(int code);
}

namespace {
using uptr = std::uintptr_t;

template <typename T>
T* ptr(uptr p) {
  return reinterpret_cast<T*>(p);
}
}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("fwd", [](uptr q, uptr k, uptr v, uptr mask, int mask_rows, long long mask_stride,
                  uptr o, uptr lse, int B, int T, int H, int d, float scale, bool bf16,
                  uptr stream) {
    return flash_fwd(ptr<const void>(q), ptr<const void>(k), ptr<const void>(v),
                     ptr<const float>(mask), mask_rows, mask_stride, ptr<void>(o),
                     ptr<float>(lse), B, T, H, d, scale, bf16 ? 1 : 0, ptr<void>(stream));
  });
  m.def("bwd_dq", [](uptr q, uptr k, uptr v, uptr mask, int mask_rows, long long mask_stride,
                     uptr dout, uptr lse, uptr delta, uptr dq, int B, int T, int H, int d,
                     float scale, bool bf16, uptr stream) {
    return flash_bwd_dq(ptr<const void>(q), ptr<const void>(k), ptr<const void>(v),
                        ptr<const float>(mask), mask_rows, mask_stride, ptr<const void>(dout),
                        ptr<const float>(lse), ptr<const float>(delta), ptr<void>(dq), B, T, H,
                        d, scale, bf16 ? 1 : 0, ptr<void>(stream));
  });
  m.def("bwd_dkv", [](uptr q, uptr k, uptr v, uptr mask, int mask_rows, long long mask_stride,
                      uptr dout, uptr lse, uptr delta, uptr dk, uptr dv, int B, int T, int H,
                      int d, float scale, bool bf16, uptr stream) {
    return flash_bwd_dkv(ptr<const void>(q), ptr<const void>(k), ptr<const void>(v),
                         ptr<const float>(mask), mask_rows, mask_stride, ptr<const void>(dout),
                         ptr<const float>(lse), ptr<const float>(delta), ptr<void>(dk),
                         ptr<void>(dv), B, T, H, d, scale, bf16 ? 1 : 0, ptr<void>(stream));
  });
  m.def("fwd_wgmma", [](uptr q, uptr k, uptr v, uptr mask, int mask_rows, long long mask_stride,
                        uptr o, uptr lse, int B, int T, int H, int d, float scale, uptr stream) {
    return flash_fwd_wgmma(ptr<const void>(q), ptr<const void>(k), ptr<const void>(v),
                           ptr<const float>(mask), mask_rows, mask_stride, ptr<void>(o),
                           ptr<float>(lse), B, T, H, d, scale, ptr<void>(stream));
  });
  m.def("bwd_dq_wgmma", [](uptr q, uptr k, uptr v, uptr mask, int mask_rows,
                           long long mask_stride, uptr dout, uptr lse, uptr delta, uptr dq, int B,
                           int T, int H, int d, float scale, uptr stream) {
    return flash_bwd_dq_wgmma(ptr<const void>(q), ptr<const void>(k), ptr<const void>(v),
                              ptr<const float>(mask), mask_rows, mask_stride,
                              ptr<const void>(dout), ptr<const float>(lse),
                              ptr<const float>(delta), ptr<void>(dq), B, T, H, d, scale,
                              ptr<void>(stream));
  });
  m.def("bwd_dkv_wgmma", [](uptr q, uptr k, uptr v, uptr mask, int mask_rows,
                            long long mask_stride, uptr dout, uptr lse, uptr delta, uptr dk,
                            uptr dv, int B, int T, int H, int d, float scale, uptr stream) {
    return flash_bwd_dkv_wgmma(ptr<const void>(q), ptr<const void>(k), ptr<const void>(v),
                               ptr<const float>(mask), mask_rows, mask_stride,
                               ptr<const void>(dout), ptr<const float>(lse),
                               ptr<const float>(delta), ptr<void>(dk), ptr<void>(dv), B, T, H, d,
                               scale, ptr<void>(stream));
  });
  // the CUDA runtime's messages, and the tensor-map encoder's two codes
  m.def("error_string",
        [](int code) { return std::string(flash_wgmma_error_string(code)); });
}
