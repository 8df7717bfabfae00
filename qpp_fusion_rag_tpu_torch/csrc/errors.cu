// Error reporting shared by every kernel entry point of this library: each
// entry returns cudaGetLastError() as an int, and the Python wrapper turns a
// non-zero code into an exception with this message.
#include <cuda_runtime.h>

extern "C" const char* qfr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
