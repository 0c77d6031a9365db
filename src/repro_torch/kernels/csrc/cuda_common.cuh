// What every kernel library of the port shares: the CUDA runtime and the
// C entry point that turns a returned cudaError_t into its message
// (kernels/_build.py::check raises with it).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
