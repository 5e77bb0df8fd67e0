// K7's launch path, bound through PyTorch's C++ API: one call from Python
// checks the tensors, allocates the output, takes the current CUDA stream and
// launches csrc/roll.cu's kernel.
//
// Why: through ctypes a K7 call cost more host time than torch.roll's whole
// call (PERF.md: the ctypes call with its launch 4.4-9.3 us, the Python-side
// torch.empty_like 2.6-5.4 us, against torch.roll's 6.2-9.0 us back to back),
// while on the device the two are equal. Here the checks, at::empty_like and
// the stream lookup run in C++ and the launch is a direct call.
//
// Built with the host compiler (not nvcc) against PyTorch's headers, lean
// ones (no torch/extension.h), into _build/ at first use by ops/native.py
// (`extension`), which hands `bind` the address of the kernel library's C
// entry svo_roll: this module does not link against that library. Errors
// raise (ValueError for bad inputs, RuntimeError for a refused launch); there
// is no fallback.

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty_like.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/csrc/utils/pybind.h>

#include <cstdint>
#include <limits>
#include <stdexcept>
#include <string>

namespace {

// csrc/roll.cu: x, rows, cols, amt, axis, out, device, stream -> cudaError_t.
using RollEntry = int (*)(const float*, int, int, const int32_t*, int, float*, int, void*);
RollEntry g_roll = nullptr;

void bind(std::uintptr_t address) { g_roll = reinterpret_cast<RollEntry>(address); }

at::Tensor roll(const at::Tensor& x, const at::Tensor& amt, int64_t axis) {
  if (g_roll == nullptr) throw std::runtime_error("svo_roll is not bound");
  if (!x.is_cuda() || x.scalar_type() != at::kFloat || x.dim() != 2 || x.numel() == 0)
    throw pybind11::value_error(std::string("x must be a non-empty 2-D float32 CUDA tensor, "
                                            "got ") + c10::toString(x.scalar_type()) +
                                " of " + std::to_string(x.dim()) + " dims and " +
                                std::to_string(x.numel()) + " elements on " +
                                x.device().str());
  if (x.size(0) > std::numeric_limits<int>::max() ||
      x.size(1) > std::numeric_limits<int>::max())
    throw pybind11::value_error("x has more than 2^31 - 1 rows or columns");
  if (amt.scalar_type() != at::kInt || amt.dim() != 2 || amt.size(0) != 1 ||
      amt.size(1) != 1)
    throw pybind11::value_error(std::string("amt must be a (1, 1) int32 tensor, got ") +
                                c10::toString(amt.scalar_type()) + " of " +
                                std::to_string(amt.dim()) + " dims and " +
                                std::to_string(amt.numel()) + " elements");
  if (amt.device() != x.device())
    throw pybind11::value_error("x on " + x.device().str() + ", amt on " +
                                amt.device().str());
  if (axis != 0 && axis != 1)
    throw pybind11::value_error("axis must be 0 or 1, got " + std::to_string(axis));
  const at::Tensor src = x.contiguous();
  at::Tensor out = at::empty_like(src);  // contiguous, as src
  const int device = src.get_device();
  const int err =
      g_roll(src.data_ptr<float>(), static_cast<int>(src.size(0)),
             static_cast<int>(src.size(1)), amt.data_ptr<int32_t>(), static_cast<int>(axis),
             out.data_ptr<float>(), device, c10::cuda::getCurrentCUDAStream(device).stream());
  if (err != 0)
    throw std::runtime_error("svo_roll launch failed: cudaError " + std::to_string(err));
  return out;
}

}  // namespace

PYBIND11_MODULE(roll_binding, m) {
  m.def("bind", &bind, "Set the address of the C entry svo_roll.");
  m.def("roll", &roll, "np.roll(x, -amt, axis) of a 2-D float32 CUDA tensor (x, amt, axis).");
}
