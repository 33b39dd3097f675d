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
// and writes 4K bytes of out in f32 (2D and 2K in bf16) against 2DK FMAs:
// at D = 16, K <= 40 about 5 flops a byte, below the card's ~20 in f32.
// At the main path's 256-row chunks it moves ~60 KB, so one call is bound
// by launch latency; at 2^20 rows by HBM (mostly the output's writes).
//
// Design (the staged path, fused_embed_staged, for D in {16, 32, 64}, w of
// at most 64 KB and 16-byte aligned x): a persistent block stages w once,
// transposed, into shared memory; then each of its warps walks its own
// tiles of R rows (R and the warps a block from the wrapper's _plan: R up
// to 32, its R*K outputs and R*D inputs whole 16-byte chunks) with no
// block barrier. A tile of x is one contiguous span: 16-byte cp.async
// copies put it into the warp's two-stage ring, and the next tile's copy
// is in flight while this tile computes. Lane l takes row l % R of the
// tile and its columns l / R, l / R + 32 / R, ...: it holds the row,
// normalised on the read, (x - mean) * scale, in registers, and reads each
// column of w as float4s that the lanes share (a broadcast), so no output
// column is padded. f32 FMA over D in order (TF32 would break the 1e-5
// trunk parity), then tanhf (not the ~2^-11 approximate tanh, which breaks
// the 2e-5 tolerance) into one of the warp's two output tiles in shared
// memory, laid out as out is, which leaves as one bulk (TMA) store that
// drains while the warp computes its next tile.
//
// Why warp-private tiles and bulk stores: at 2^20 rows the kernel's
// compute (~37 instructions an output) takes about as long as its HBM time,
// so the two must overlap. Block barriers a tile would hold every warp for
// the slowest, and stores from the threads would hold a block until its
// tile drained; here neither wait exists.
//
// The general path (fused_embed_kernel, the first design) takes every
// other call: a block owns 32 rows and 64 output columns, D is walked in
// chunks of 64 with the matching [chunk, 64] slab of w staged beside a
// normalised chunk of x, so w of any size (up to the reference's
// 16k x 512) never has to fit whole.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

// -- the staged path ---------------------------------------------------------

constexpr int STAGED_SMEM_MAX = 160 * 1024;   // the attribute's ceiling
constexpr int MAX_WARPS = 8;                  // warps a staged block
constexpr int STAGE_BATCH = 8;                // w loads in flight a thread

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// Bulk (TMA) store of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from shared to global memory; the copy runs while the block
// goes on. Shared-memory writes it reads must be fenced for the async
// proxy first.
__device__ __forceinline__ void bulk_store(void* gmem, const void* smem,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(gmem), "r"(s), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
// at most one bulk store still reading shared memory
__device__ __forceinline__ void bulk_wait_read_one() {
  asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
}
// no bulk store still reading shared memory (their writes complete by the
// kernel's end)
__device__ __forceinline__ void bulk_wait_read_all() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// a 16-byte vector as f32: 8 bf16, bits shifted into place, or 4 f32
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

// Shared memory of a block: w transposed [K][D] f32, then for each warp
// its slice: an x ring [2][R][D] of T and two output tiles [R][K] of T.
// The wrapper's _staged_smem computes the same.
template <typename T>
__host__ __device__ constexpr int slice_bytes(int d, int k, int rows) {
  return 2 * rows * (d + k) * static_cast<int>(sizeof(T));
}
template <typename T>
constexpr int staged_smem(int d, int k, int rows, int warps) {
  return 4 * k * d + warps * slice_bytes<T>(d, k, rows);
}

// A warp copies tile t's rows of x (one contiguous span of x) into a ring
// stage with 16-byte cp.async copies, as one commit group.
template <typename T, int D>
__device__ __forceinline__ void issue_tile(const T* __restrict__ x,
                                           unsigned char* stage, int n,
                                           int rows, int t, int lane) {
  constexpr int CH = D * sizeof(T) / 16;      // 16-byte chunks a row
  const long long row0 = static_cast<long long>(t) * rows;
  const int live = min(rows, n - static_cast<int>(row0));
  const unsigned char* src =
      reinterpret_cast<const unsigned char*>(x + row0 * D);
  for (int c = lane; c < live * CH; c += 32)
    cp_async16(stage + c * 16, src + static_cast<long long>(c) * 16);
  cp_async_commit();
}

template <typename T, int D>
__global__ void __launch_bounds__(MAX_WARPS * 32)
fused_embed_staged(const T* __restrict__ x, const float* __restrict__ w,
                   T* __restrict__ out, int n, int k, float mean,
                   float scale, int rows) {
  constexpr int XS = D * sizeof(T);           // bytes of a row of x
  constexpr int CH = XS / 16;                 // 16-byte chunks a row
  constexpr int VEC = 16 / sizeof(T);         // elements a chunk
  extern __shared__ __align__(16) unsigned char smem[];
  float* wt = reinterpret_cast<float*>(smem);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
  unsigned char* ring = smem + 4 * k * D + warp * slice_bytes<T>(D, k, rows);
  T* const out_tiles = reinterpret_cast<T*>(ring + 2 * rows * XS);
  const int groups = 32 / rows;           // column groups of the warp
  const int r = lane % rows, g = lane / rows;
  const int tiles = (n - 1) / rows + 1;   // n >= 1
  const int stride = gridDim.x * warps;

  int tile = blockIdx.x * warps + warp;
  if (tile < tiles) issue_tile<T, D>(x, ring, n, rows, tile, lane);
  // w, transposed, while the first tiles are in flight, in batches of
  // STAGE_BATCH loads issued before any is stored (a one-warp block would
  // otherwise wait out a load's latency per element); the block's only
  // barrier follows
  for (int e0 = threadIdx.x; e0 < D * k; e0 += STAGE_BATCH * blockDim.x) {
    float v[STAGE_BATCH];
#pragma unroll
    for (int u = 0; u < STAGE_BATCH; ++u) {
      const int e = e0 + u * blockDim.x;
      v[u] = e < D * k ? __ldg(w + e) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < STAGE_BATCH; ++u) {
      const int e = e0 + u * blockDim.x;
      if (e < D * k) wt[(e % k) * D + e / k] = v[u];
    }
  }
  __syncthreads();

  // tile + stride stays an int: the wrapper keeps n + 65536 within int
  for (int s = 0; tile < tiles; tile += stride, s ^= 1) {
    T* ot = out_tiles + s * rows * k;
    cp_async_wait_all();
    if (lane == 0) bulk_wait_read_one();  // the store from ot, 2 tiles ago
    __syncwarp();           // this tile is in; ot is free
    if (tile < tiles - stride)
      issue_tile<T, D>(x, ring + (s ^ 1) * rows * XS, n, rows, tile + stride,
                       lane);
    const long long row0 = static_cast<long long>(tile) * rows;
    const int live = min(rows, n - static_cast<int>(row0));
    if (r < live) {
      float z[D];
      const uint4* xr = reinterpret_cast<const uint4*>(ring + s * rows * XS
                                                       + r * XS);
#pragma unroll
      for (int c = 0; c < CH; ++c) unpack(xr[c], z + c * VEC, T());
#pragma unroll
      for (int j = 0; j < D; ++j) z[j] = (z[j] - mean) * scale;
#pragma unroll 4
      for (int col = g; col < k; col += groups) {
        const float4* wc = reinterpret_cast<const float4*>(wt + col * D);
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < D / 4; ++j) {
          const float4 wv = wc[j];
          acc = fmaf(z[4 * j], wv.x, acc);
          acc = fmaf(z[4 * j + 1], wv.y, acc);
          acc = fmaf(z[4 * j + 2], wv.z, acc);
          acc = fmaf(z[4 * j + 3], wv.w, acc);
        }
        store(ot + r * k + col, tanhf(acc));
      }
    }
    fence_async_shared();
    __syncwarp();
    // the tile's live * K outputs are one contiguous span of out, laid out
    // as ot is: its whole 16-byte chunks leave by one bulk store, which
    // drains while the warp computes its next tile; a ragged end by lanes
    T* dst = out + row0 * k;
    const int total = live * k;
    const int full = total / VEC * VEC;
    if (lane == 0) {
      if (full > 0) bulk_store(dst, ot, full * static_cast<int>(sizeof(T)));
      bulk_commit();        // a group each tile, empty or not
    }
    for (int e = full + lane; e < total; e += 32) dst[e] = ot[e];
  }
  if (lane == 0) bulk_wait_read_all();
}

template <typename T, int D>
cudaError_t staged_attrs() {
  return cudaFuncSetAttribute(fused_embed_staged<T, D>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              STAGED_SMEM_MAX);
}

template <int D_>
struct Width {
  static constexpr int D = D_;
};

// calls f(Width<D>()) for a staged instance's D; false if there is none
template <typename F>
bool dispatch(int d, F&& f) {
  switch (d) {
    case 16: f(Width<16>()); return true;
    case 32: f(Width<32>()); return true;
    case 64: f(Width<64>()); return true;
    default: return false;
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, int n, int d, int k,
           float mean, float scale, int rows, int warps, int grid,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0) {
    const dim3 g((n + ROWS - 1) / ROWS, (k + KT - 1) / KT);
    fused_embed_kernel<T><<<g, THREADS, 0, s>>>(
        static_cast<const T*>(x), static_cast<const float*>(w),
        static_cast<T*>(out), n, d, k, mean, scale);
    return static_cast<int>(cudaGetLastError());
  }
  if (rows < 1 || 32 % rows
      || (static_cast<long long>(rows) * k * sizeof(T)) % 16 || warps < 1
      || warps > MAX_WARPS || grid < 1
      || reinterpret_cast<uintptr_t>(x) % 16
      || reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = static_cast<int>(cudaErrorInvalidValue);
  dispatch(d, [&](auto width) {
    constexpr int D = decltype(width)::D;
    // the attribute is set once for each instance (thread-safe static)
    static const cudaError_t attr = staged_attrs<T, D>();
    const int smem = staged_smem<T>(D, k, rows, warps);
    if (attr != cudaSuccess) {
      err = static_cast<int>(attr);
    } else if (smem <= STAGED_SMEM_MAX) {
      fused_embed_staged<T, D><<<grid, warps * 32, smem, s>>>(
          static_cast<const T*>(x), static_cast<const float*>(w),
          static_cast<T*>(out), n, k, mean, scale, rows);
      err = static_cast<int>(cudaGetLastError());
    }
  });
  return err;
}

template <typename T>
int resident(int d, int warps, int smem) {
  int blocks = 0;
  dispatch(d, [&](auto width) {
    constexpr int D = decltype(width)::D;
    if (staged_attrs<T, D>() != cudaSuccess
        || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &blocks, fused_embed_staged<T, D>, warps * 32, smem)
           != cudaSuccess)
      blocks = 0;
  });
  return blocks;
}

}  // namespace

// rows = 0 takes the general path; else the staged instance for d: warp
// tiles of `rows` rows, `warps` warps a block, `grid` persistent blocks
// (the wrapper's _plan). Returns cudaGetLastError().
extern "C" int fused_embed_f32(const void* x, const void* w, void* out,
                               int n, int d, int k, float mean, float scale,
                               int rows, int warps, int grid, void* stream) {
  return launch<float>(x, w, out, n, d, k, mean, scale, rows, warps, grid,
                       stream);
}

extern "C" int fused_embed_bf16(const void* x, const void* w, void* out,
                                int n, int d, int k, float mean, float scale,
                                int rows, int warps, int grid, void* stream) {
  return launch<__nv_bfloat16>(x, w, out, n, d, k, mean, scale, rows, warps,
                               grid, stream);
}

// Blocks of the staged instance for d, at `warps` warps and `smem` bytes of
// shared memory, resident on one SM, for the persistent grid; 0 if there is
// no instance or the query failed.
extern "C" int fused_embed_resident(int x_bf16, int d, int warps, int smem) {
  return x_bf16 ? resident<__nv_bfloat16>(d, warps, smem)
                : resident<float>(d, warps, smem);
}
