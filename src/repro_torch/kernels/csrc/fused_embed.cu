// fused_embed: out = tanh(((x - mean) * scale) @ w), math in f32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_embed.py
// (fused_embed / _kernel), which the JAX backend runs for every
// linear-mode trunk (src/repro/pipeline/backend.py, JaxBackend._raw_forward).
//
// x is [N, D] (f32 or bf16, row-major), w is [D, K] f32 (row-major), out is
// [N, K] in x's dtype. Any N: the ragged edge is masked here, not padded.
//
// What bounds it on an H100: memory bytes. Per row it reads 4D bytes of x
// and writes 4K bytes of out in f32 (2D and 2K in bf16) against 2DK FMAs,
// far below the card's ~20 flops per byte in f32. At the main path's
// 256-row chunks (D = 16, K <= 40) it moves ~60 KB, so one call is bound
// by launch latency, not by either roofline.
//
// Design (simple and correct first): a block owns ROWS rows and KT output
// columns. D is walked in chunks of at most DC: each chunk of x is
// normalised on load into shared memory, the matching [chunk, KT] slab of w
// is staged beside it, so w of any size (up to the reference's 16k x 512)
// never has to fit whole. Each thread accumulates ROWS*KT/THREADS outputs
// with f32 FMA (no TF32, no tensor cores: K <= 40 on the main path), then
// applies tanhf and stores (rounding with __float2bfloat16 for bf16).
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int ROWS = 32;      // rows per block
constexpr int KT = 64;        // output columns per block
constexpr int DC = 64;        // D chunk staged in shared memory
constexpr int THREADS = 256;
constexpr int RG = THREADS / KT;          // row groups
constexpr int PER = ROWS / RG;            // outputs per thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_embed_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   T* __restrict__ out, int n, int d, int k, float mean,
                   float scale) {
  __shared__ float xs[ROWS][DC + 1];
  __shared__ float ws[DC][KT];
  const int tid = threadIdx.x;
  const long long r0 = static_cast<long long>(blockIdx.x) * ROWS;
  const int k0 = blockIdx.y * KT;
  const int col = tid % KT;
  const int rg = tid / KT;
  float acc[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) acc[j] = 0.f;

  for (int d0 = 0; d0 < d; d0 += DC) {
    const int dc = min(DC, d - d0);
    // x chunk [ROWS, dc]: consecutive threads read consecutive columns
    for (int e = tid; e < ROWS * dc; e += THREADS) {
      const int r = e / dc, c = e % dc;
      const long long row = r0 + r;
      xs[r][c] = row < n
          ? (to_f32(x[row * d + d0 + c]) - mean) * scale : 0.f;
    }
    // w slab [dc, KT]: consecutive threads read consecutive output columns
    for (int e = tid; e < dc * KT; e += THREADS) {
      const int r = e / KT, c = e % KT;
      ws[r][c] = (k0 + c) < k
          ? w[static_cast<long long>(d0 + r) * k + k0 + c] : 0.f;
    }
    __syncthreads();
    for (int c = 0; c < dc; ++c) {
      const float wv = ws[c][col];
#pragma unroll
      for (int j = 0; j < PER; ++j)
        acc[j] = fmaf(xs[rg + j * RG][c], wv, acc[j]);
    }
    __syncthreads();
  }

  if (k0 + col >= k) return;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const long long row = r0 + rg + j * RG;
    if (row < n) store(out + row * k + k0 + col, tanhf(acc[j]));
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, int n, int d, int k,
           float mean, float scale, void* stream) {
  const dim3 grid((n + ROWS - 1) / ROWS, (k + KT - 1) / KT);
  fused_embed_kernel<T><<<grid, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<T*>(out), n, d, k, mean, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fused_embed_f32(const void* x, const void* w, void* out,
                               int n, int d, int k, float mean, float scale,
                               void* stream) {
  return launch<float>(x, w, out, n, d, k, mean, scale, stream);
}

extern "C" int fused_embed_bf16(const void* x, const void* w, void* out,
                                int n, int d, int k, float mean, float scale,
                                void* stream) {
  return launch<__nv_bfloat16>(x, w, out, n, d, k, mean, scale, stream);
}
