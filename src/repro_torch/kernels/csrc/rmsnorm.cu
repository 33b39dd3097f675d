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
// artefact.
//
// What bounds it on an H100: memory bytes. Per row it reads D elements of
// x and writes D of y against ~4D flops, far below the card's flops per
// byte. At the LM's prefill shape (16384 x 2560 bf16) it moves 168 MB; at
// its decode shape (32 rows) a few hundred KB, so that call is bound by
// launch latency.
//
// Design (the register path, rmsnorm_reg_kernel): a row belongs to a group
// of WPR warps, and each lane holds NV vectors of 16 bytes of it in
// registers (WPR and NV compile-time, picked by the wrapper's _norm_plan so
// that NV <= 10), so x is read from HBM once, with streaming loads, and
// never again: the sum of squares is a warp shuffle (and, for WPR > 1, one
// named barrier over the group's warps, not the block), the scale comes
// from the registers, and y leaves with 16-byte streaming stores. The grid
// is persistent (the SMs times the resident blocks, capped by the rows);
// each group walks rows with a stride and issues the next row's loads
// before it reduces the current one, so the reduction hides the next row's
// HBM latency. (1 + w) is staged once a block into shared memory in f32,
// laid out so that a lane reads its vector's scale as conflict-free
// float4s. The first row's loads are issued before that staging, so the
// two latencies overlap; at the decode shape a block is one warp per row.
//
// The general path (rmsnorm_kernel, the first design) takes every other
// call: a D that no register instance covers, a D that is not a multiple of
// the vector width, or an unaligned x or w. One block of 256 threads per
// row, two passes over the row.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_GROUPS = 8;           // row groups a register-path block

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

// The general path. VEC elements of T per load: 16 bytes when
// VEC * sizeof(T) == 16, else 1.
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

// -- the register path ------------------------------------------------------

// 16 bytes, read once: not kept in L1
__device__ __forceinline__ uint4 load_stream(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

// a 16-byte vector as f32 (8 bf16, bits shifted into place, or 4 f32) and
// back (bf16 rounded to nearest even, as __float2bfloat16)
__device__ __forceinline__ void unpack(const uint4& v, float* f,
                                       __nv_bfloat16) {
  const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4& v, float* f, float) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(lo)))
      | static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(hi)))
            << 16;
}
__device__ __forceinline__ uint4 pack(const float* f, __nv_bfloat16) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                    pack2(f[6], f[7]));
}
__device__ __forceinline__ uint4 pack(const float* f, float) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}

// (1 + w) into shared memory: the lane's NV vectors, float4 quarter h of
// vector v at ws4[h * nvec + v]. All loads are issued first, as raw 8-byte
// words (w is 16-byte aligned), and unpacked only at the stores.
template <int NV, int WPR, int VEC, typename W>
__device__ __forceinline__ void stage_scale(const W* __restrict__ w,
                                            float4* ws4, int base) {
  constexpr int NVEC = NV * 32 * WPR;
  constexpr int U = VEC * sizeof(W) / 8;    // 8-byte words of w a vector
  uint2 raw[NV][U];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const uint2* p = reinterpret_cast<const uint2*>(
        w + (base + j * 32 * WPR) * VEC);
#pragma unroll
    for (int u = 0; u < U; ++u) raw[j][u] = __ldg(p + u);
  }
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    float f[VEC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if constexpr (sizeof(W) == 4) {
        f[2 * u] = __uint_as_float(raw[j][u].x);
        f[2 * u + 1] = __uint_as_float(raw[j][u].y);
      } else {
        f[4 * u] = __uint_as_float(raw[j][u].x << 16);
        f[4 * u + 1] = __uint_as_float(raw[j][u].x & 0xffff0000u);
        f[4 * u + 2] = __uint_as_float(raw[j][u].y << 16);
        f[4 * u + 3] = __uint_as_float(raw[j][u].y & 0xffff0000u);
      }
    }
#pragma unroll
    for (int h = 0; h < VEC / 4; ++h)
      ws4[h * NVEC + base + j * 32 * WPR] =
          make_float4(1.f + f[4 * h], 1.f + f[4 * h + 1],
                      1.f + f[4 * h + 2], 1.f + f[4 * h + 3]);
  }
}

// Each group of WPR warps owns a row at a time; lane l of warp q of the
// group holds vectors q * 32 + l + j * 32 * WPR, j < NV, of the row, so a
// warp's load of one j is 512 contiguous bytes. Shared memory: (1 + w) in
// f32 as [VEC / 4][nvec] float4s (scale of vector i, quarter h at
// h * nvec + i), so consecutive lanes read consecutive float4s.
// At most 128 registers a thread (two 256-thread blocks an SM), but for
// NV = 10, whose bf16 instances spill under that cap, and for 512 threads.
template <typename T, int NV, int WPR>
__global__ void __launch_bounds__(WPR * 32 > THREADS ? WPR * 32 : THREADS,
                                  WPR * 32 > THREADS || NV >= 10 ? 1 : 2)
rmsnorm_reg_kernel(const T* __restrict__ x, const void* __restrict__ w,
                   T* __restrict__ y, int n, float eps, int w_bf16) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int H = VEC / 4;            // float4s of scale per vector
  constexpr int NVEC = NV * 32 * WPR;   // vectors a row
  constexpr int D = NVEC * VEC;
  extern __shared__ float4 ws4[];
  __shared__ float red[2][MAX_GROUPS][WPR];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int groups = blockDim.x / (32 * WPR);
  const int g = warp / WPR, q = warp % WPR;
  const int base = q * 32 + lane;
  long long row = static_cast<long long>(blockIdx.x) * groups + g;
  const long long stride = static_cast<long long>(gridDim.x) * groups;

  uint4 cur[NV], nxt[NV];
  if (row < n) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * D);
#pragma unroll
    for (int j = 0; j < NV; ++j)
      cur[j] = load_stream(xr + base + j * 32 * WPR);
  }
  // stage (1 + w) while the first row is in flight: group 0's lanes read w
  // at the vectors they hold of x, all loads issued before any is used
  if (g == 0) {
    if (w_bf16) {
      stage_scale<NV, WPR, VEC>(static_cast<const __nv_bfloat16*>(w), ws4,
                                base);
    } else {
      stage_scale<NV, WPR, VEC>(static_cast<const float*>(w), ws4, base);
    }
  }
  __syncthreads();

  int parity = 0;
  for (; row < n; row += stride) {
    const long long next = row + stride;
    if (next < n) {
      const uint4* xr = reinterpret_cast<const uint4*>(x + next * D);
#pragma unroll
      for (int j = 0; j < NV; ++j)
        nxt[j] = load_stream(xr + base + j * 32 * WPR);
    }
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float f[VEC];
      unpack(cur[j], f, T());
#pragma unroll
      for (int i = 0; i < VEC; ++i) ss = fmaf(f[i], f[i], ss);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (WPR > 1) {
      // one barrier over the group's warps; red alternates between two
      // halves, so a fast warp's next row cannot overwrite a sum still read
      if (lane == 0) red[parity][g][q] = ss;
      asm volatile("bar.sync %0, %1;" :: "r"(g + 1), "r"(WPR * 32) : "memory");
      ss = 0.f;
#pragma unroll
      for (int i = 0; i < WPR; ++i) ss += red[parity][g][i];
      parity ^= 1;
    }
    const float r = rsqrtf(ss / static_cast<float>(D) + eps);
    uint4* yr = reinterpret_cast<uint4*>(y + row * D);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int v = base + j * 32 * WPR;
      float f[VEC];
      unpack(cur[j], f, T());
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const float4 s = ws4[h * NVEC + v];
        f[4 * h] = f[4 * h] * r * s.x;
        f[4 * h + 1] = f[4 * h + 1] * r * s.y;
        f[4 * h + 2] = f[4 * h + 2] * r * s.z;
        f[4 * h + 3] = f[4 * h + 3] * r * s.w;
      }
      __stcs(yr + v, pack(f, T()));
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) cur[j] = nxt[j];
  }
}

template <typename T, int NV, int WPR>
cudaError_t reg_attrs(int* blocks_per_sm) {
  // (1 + w) is up to 64 KB (16384 f32): above the 48 KB default
  constexpr int SMEM = NV * 32 * WPR * (16 / sizeof(T)) * 4;
  auto kernel = rmsnorm_reg_kernel<T, NV, WPR>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess || blocks_per_sm == nullptr) return err;
  const int threads = WPR * 32 > THREADS ? WPR * 32 : THREADS;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel,
                                                       threads, SMEM);
}

template <typename T, int NV, int WPR>
int launch_reg(const void* x, const void* w, void* y, int n, float eps,
               int w_bf16, int groups, int grid, cudaStream_t stream) {
  // the attribute is set once for each instance (thread-safe static init)
  static const cudaError_t attr = reg_attrs<T, NV, WPR>(nullptr);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  constexpr int SMEM = NV * 32 * WPR * (16 / sizeof(T)) * 4;
  rmsnorm_reg_kernel<T, NV, WPR><<<grid, groups * WPR * 32, SMEM, stream>>>(
      static_cast<const T*>(x), w, static_cast<T*>(y), n, eps, w_bf16);
  return static_cast<int>(cudaGetLastError());
}

template <int NV_, int WPR_>
struct Instance {
  static constexpr int NV = NV_, WPR = WPR_;
};

// The register instances: NV in {4, 7, 8, 10} vectors a lane, WPR in
// {1, 2, 4, 8, 16} warps a row (NV 4 only at WPR 1: _norm_plan picks the
// fewest warps that keep NV <= 10; NV 10 not at WPR 16, where bf16
// spills). dispatch(nv, wpr, f) calls f(Instance<NV, WPR>()); false if
// there is no such instance.
template <typename F>
bool dispatch(int nv, int wpr, F&& f) {
#define RMSNORM_CASE(NV_, WPR_) \
  if (nv == NV_ && wpr == WPR_) { f(Instance<NV_, WPR_>()); return true; }
#define RMSNORM_WPR(NV_) \
  RMSNORM_CASE(NV_, 1) RMSNORM_CASE(NV_, 2) RMSNORM_CASE(NV_, 4) \
  RMSNORM_CASE(NV_, 8)
  RMSNORM_CASE(4, 1)
  RMSNORM_WPR(7) RMSNORM_WPR(8) RMSNORM_WPR(10)
  RMSNORM_CASE(7, 16) RMSNORM_CASE(8, 16)
#undef RMSNORM_WPR
#undef RMSNORM_CASE
  return false;
}

template <typename T, typename W>
int launch_general(const void* x, const void* w, void* y, int n, int d,
                   float eps, int grid, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
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

template <typename T>
int launch(const void* x, const void* w, void* y, int n, int d, float eps,
           int w_bf16, int nv, int wpr, int groups, int grid,
           cudaStream_t stream) {
  if (nv == 0) {
    return w_bf16
        ? launch_general<T, __nv_bfloat16>(x, w, y, n, d, eps, grid, stream)
        : launch_general<T, float>(x, w, y, n, d, eps, grid, stream);
  }
  if (nv * 32 * wpr * static_cast<int>(16 / sizeof(T)) != d
      || groups < 1 || groups * wpr > (wpr > MAX_GROUPS ? wpr : MAX_GROUPS)
      || reinterpret_cast<uintptr_t>(x) % 16
      || reinterpret_cast<uintptr_t>(w) % 16
      || reinterpret_cast<uintptr_t>(y) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = static_cast<int>(cudaErrorInvalidValue);
  dispatch(nv, wpr, [&](auto inst) {
    using I = decltype(inst);
    err = launch_reg<T, I::NV, I::WPR>(x, w, y, n, eps, w_bf16, groups, grid,
                                        stream);
  });
  return err;
}

}  // namespace

// x_bf16 / w_bf16: 0 for float32, 1 for bfloat16. nv = 0 takes the general
// path on `grid` blocks; else the register instance (nv, wpr) with `groups`
// rows a block on `grid` blocks (the wrapper's _norm_plan). Returns
// cudaGetLastError().
extern "C" int rmsnorm(const void* x, const void* w, void* y, int n, int d,
                       float eps, int x_bf16, int w_bf16, int nv, int wpr,
                       int groups, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16
      ? launch<__nv_bfloat16>(x, w, y, n, d, eps, w_bf16, nv, wpr, groups,
                              grid, s)
      : launch<float>(x, w, y, n, d, eps, w_bf16, nv, wpr, groups, grid, s);
}

// Blocks of the register instance (nv, wpr) resident on one SM at its block
// size (the larger of 256 threads and one row group), for the persistent
// grid; 0 if there is no such instance or the query failed.
extern "C" int rmsnorm_resident(int x_bf16, int nv, int wpr) {
  int blocks = 0;
  auto query = [&](auto inst, auto t) {
    using I = decltype(inst);
    if (reg_attrs<decltype(t), I::NV, I::WPR>(&blocks) != cudaSuccess)
      blocks = 0;
  };
  if (x_bf16) {
    dispatch(nv, wpr, [&](auto inst) { query(inst, __nv_bfloat16()); });
  } else {
    dispatch(nv, wpr, [&](auto inst) { query(inst, 0.f); });
  }
  return blocks;
}
