// Error reporting for the ctypes-bound launchers: every launcher returns
// the cudaError_t of its launch, and the Python wrapper turns a non-zero
// code into an exception with this message.
#include <cuda_runtime.h>

extern "C" const char* sph3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
