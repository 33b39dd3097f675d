// rmsnorm: y = x * rsqrt(mean(x^2) + eps) * (1 + w), math in f32, y in
// x's dtype.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py (rmsnorm /
// _kernel). The LM runs it for every norm of the forward pass: 2 per layer
// plus the final norm (src/repro/models/layers.py, rmsnorm, whose (1 + w)
// scale every config takes).
//
// x is [N, D] (f32 or bf16, row-major), w is [D] (f32 or bf16), y is [N, D]
// in x's dtype. Any N: the reference's N % block_rows rule was a TPU tiling
// artefact, here each row is its own block.
//
// What bounds it on an H100: memory bytes. Per row it reads D elements of
// x and writes D of y against ~4D flops, far below the card's flops per
// byte. At the LM's decode shapes (N = batch rows, D = 2560) it moves a few
// tens of KB, so one call is bound by launch latency.
//
// Design: one block of 256 threads per row (a grid-stride loop over rows).
// Pass 1 sums x^2 in f32 with 16-byte vector loads where D and the pointers
// allow (8 bf16 or 4 f32 per load), reduced over the block by warp
// shuffles; pass 2 reads the row again (from L1/L2) and writes y with the
// same vector width.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < THREADS / 32 ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  const float total = red[0];
  __syncthreads();  // red is reused by the next row
  return total;
}

// VEC elements of T per load: 16 bytes when VEC * sizeof(T) == 16, else 1.
template <typename T, typename W, int VEC>
__global__ void __launch_bounds__(THREADS)
rmsnorm_kernel(const T* __restrict__ x, const W* __restrict__ w,
               T* __restrict__ y, int n, int d, float eps) {
  __shared__ float red[THREADS / 32];
  const int nv = d / VEC;
  for (long long row = blockIdx.x; row < n; row += gridDim.x) {
    const T* xr = x + row * d;
    T* yr = y + row * d;
    float ss = 0.f;
    for (int i = threadIdx.x; i < nv; i += THREADS) {
      alignas(16) T e[VEC];
      if (VEC > 1) {
        *reinterpret_cast<uint4*>(e) =
            reinterpret_cast<const uint4*>(xr)[i];
      } else {
        e[0] = xr[i];
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float f = to_f32(e[j]);
        ss = fmaf(f, f, ss);
      }
    }
    const float r = rsqrtf(block_sum(ss, red) / static_cast<float>(d) + eps);
    for (int i = threadIdx.x; i < nv; i += THREADS) {
      alignas(16) T e[VEC];
      if (VEC > 1) {
        *reinterpret_cast<uint4*>(e) =
            reinterpret_cast<const uint4*>(xr)[i];
      } else {
        e[0] = xr[i];
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float s = 1.f + to_f32(w[i * VEC + j]);
        from_f32(&e[j], to_f32(e[j]) * r * s);
      }
      if (VEC > 1) {
        reinterpret_cast<uint4*>(yr)[i] = *reinterpret_cast<uint4*>(e);
      } else {
        yr[i] = e[0];
      }
    }
  }
}

template <typename T, typename W>
int launch(const void* x, const void* w, void* y, int n, int d, float eps,
           cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int grid = n < 65536 * 16 ? n : 65536 * 16;
  const bool vec = d % VEC == 0
      && reinterpret_cast<uintptr_t>(x) % 16 == 0
      && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (vec) {
    rmsnorm_kernel<T, W, VEC><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const W*>(w),
        static_cast<T*>(y), n, d, eps);
  } else {
    rmsnorm_kernel<T, W, 1><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const W*>(w),
        static_cast<T*>(y), n, d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x_bf16 / w_bf16: 0 for float32, 1 for bfloat16. Returns cudaGetLastError().
extern "C" int rmsnorm(const void* x, const void* w, void* y, int n, int d,
                       float eps, int x_bf16, int w_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return w_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(x, w, y, n, d, eps, s)
                  : launch<__nv_bfloat16, float>(x, w, y, n, d, eps, s);
  }
  return w_bf16 ? launch<float, __nv_bfloat16>(x, w, y, n, d, eps, s)
                : launch<float, float>(x, w, y, n, d, eps, s);
}
