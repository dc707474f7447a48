// FCT_HD marks the kernels' per-lane and per-row functions: __device__ under
// nvcc, `static inline` plain C++ without it, so that the host tests build
// the sources with g++ and run those functions on the CPU.
#pragma once

#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define FCT_HD __device__ __forceinline__
#else
#define FCT_HD static inline
#endif
