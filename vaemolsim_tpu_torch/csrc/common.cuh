// Shared by every kernel library: the error-string export the Python
// wrapper uses to report a failed launch, and the launch-check idiom.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* vms_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Largest dynamic shared memory a block may ask for on sm_90.
constexpr int kMaxDynamicSmem = 232448;
constexpr int kDefaultSmem = 48 * 1024;

// Opt a kernel in to more than 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= static_cast<size_t>(kDefaultSmem)) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
