// Error reporting shared by every kernel entry point of libkcnn_cuda.
#include <cuda_runtime.h>

extern "C" const char* kcnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
