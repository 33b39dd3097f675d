// decode_attention: one query token per row against a KV cache, GQA, keys
// at positions >= length masked, online softmax, math in f32, output in
// q's dtype.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention / _kernel). The LM's decode step runs it once per
// layer (src/repro/models/attention.py, attn_decode_apply, where the
// slot mask of a full or circular cache is exactly positions < length
// with length = min(index + 1, W)).
//
// q is [B, Hq, D] (contiguous), k/v caches are [B, Hkv, S, D] given by
// their (batch, head, position) strides in elements with the last dim
// contiguous, so the model passes its [B, W, Hkv, D] layer cache as a
// strided view and the cache is never copied. o is [B, Hq, D]
// (contiguous). length is one int32 per row on the device, or one scalar
// for all rows.
//
// What bounds it on an H100: memory bytes. It reads 2 * length * Hkv * D
// cache elements per row against 4 * Hq * length * D flops, so a GQA group
// of G query heads does 2G flops per cache element: far below the card's
// flops per byte.
//
// Design (simple and right first): one block of 128 threads per (row, kv
// head), so the G query heads of a group share each K/V tile, and the
// grid is B * Hkv blocks (the TPU grid had B). The block walks the cache in
// 64-position tiles up to length, not up to the cache's size: tiles are
// staged in shared memory as f32 (K rows padded to D + 1 words), scores for
// the G heads go to shared memory, one warp per head does the max / sum,
// and each thread keeps up to 16 of the G * D accumulators in registers.
// Splitting long caches over several blocks with a combine pass is later
// work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <mutex>

namespace {

constexpr int T = 64;          // cache positions per tile
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int EPT = 16;        // accumulators per thread: G * D <= 2048
constexpr float NEG_INF = -1e30f;

// cudaFuncSetAttribute is a driver call, too dear to make at every launch.
// Each kernel instance raises its dynamic shared memory limit on a device
// only when a launch needs more than it set there before. The limit only
// grows, under a lock, so no launch on another thread sees it lowered.
struct SmemLimit {
  static constexpr int kDevices = 64;
  std::mutex mu;
  int bytes[kDevices] = {};
  cudaError_t allow(const void* kernel, int need) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    std::lock_guard<std::mutex> lock(mu);
    if (dev < kDevices && bytes[dev] >= need) return cudaSuccess;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, need);
    if (err == cudaSuccess && dev < kDevices) bytes[dev] = need;
    return err;
  }
};

struct Strides {
  long long kb, kh, ks, vb, vh, vs;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

int smem_bytes(int g, int d) {
  // q [g][d], K tile [T][d + 1], V tile [T][d], p [g][T], m, l, corr [g]
  return static_cast<int>(sizeof(float))
      * (g * d + T * (d + 1) + T * d + g * T + 3 * g);
}

template <typename E>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const E* __restrict__ q, const E* __restrict__ k,
              const E* __restrict__ v, E* __restrict__ o,
              const int* __restrict__ lengths, int length_all, Strides st,
              int hq, int hkv, int s_len, int d, float scale) {
  extern __shared__ float smem[];
  const int g_n = hq / hkv;
  const int ld = d + 1;
  float* qs = smem;                   // [g][d]
  float* ks = qs + g_n * d;           // [T][d + 1]
  float* vs = ks + T * ld;            // [T][d]
  float* ps = vs + T * d;             // [g][T]
  float* m = ps + g_n * T;            // [g]
  float* l = m + g_n;                 // [g]
  float* corr = l + g_n;              // [g]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int h0 = kvh * g_n;
  int len = lengths ? lengths[b] : length_all;
  len = max(0, min(len, s_len));
  const E* qp = q + (static_cast<long long>(b) * hq + h0) * d;
  const E* kp = k + b * st.kb + kvh * st.kh;
  const E* vp = v + b * st.vb + kvh * st.vh;
  const int gd = g_n * d;

  for (int e = tid; e < gd; e += THREADS) qs[e] = to_f32(qp[e]) * scale;
  for (int g = tid; g < g_n; g += THREADS) {
    m[g] = NEG_INF;
    l[g] = 0.f;
  }
  float acc[EPT];
#pragma unroll
  for (int i = 0; i < EPT; ++i) acc[i] = 0.f;

  for (int t0 = 0; t0 < len; t0 += T) {
    __syncthreads();  // previous tile fully used (and qs, m, l written)
    for (int e = tid; e < T * d; e += THREADS) {
      const int r = e / d, c = e % d;
      const bool in = t0 + r < len;
      ks[r * ld + c] = in ? to_f32(kp[(t0 + r) * st.ks + c]) : 0.f;
      vs[r * d + c] = in ? to_f32(vp[(t0 + r) * st.vs + c]) : 0.f;
    }
    __syncthreads();
    for (int e = tid; e < g_n * T; e += THREADS) {
      const int g = e / T, c = e % T;
      float s = 0.f;
      for (int x = 0; x < d; ++x) s = fmaf(qs[g * d + x], ks[c * ld + x], s);
      ps[g * T + c] = t0 + c < len ? s : NEG_INF;
    }
    __syncthreads();
    for (int g = warp; g < g_n; g += WARPS) {
      const float s0 = ps[g * T + lane], s1 = ps[g * T + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[g], mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      ps[g * T + lane] = p0;
      ps[g * T + lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float c = expf(m[g] - m_new);
        corr[g] = c;
        l[g] = l[g] * c + sum;
        m[g] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      const int e = tid + i * THREADS;
      if (e < gd) {
        const int g = e / d, c = e % d;
        float a = acc[i] * corr[g];
        for (int x = 0; x < T; ++x) a = fmaf(ps[g * T + x], vs[x * d + c], a);
        acc[i] = a;
      }
    }
  }
  __syncthreads();

  E* op = o + (static_cast<long long>(b) * hq + h0) * d;
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    const int e = tid + i * THREADS;
    if (e < gd) store(op + e, acc[i] / fmaxf(l[e / d], 1e-30f));
  }
}

template <typename E>
int launch(const void* q, const void* k, const void* v, void* o,
           const int* lengths, int length_all, const Strides& st, int b,
           int hq, int hkv, int s_len, int d, float scale,
           cudaStream_t stream) {
  const int smem = smem_bytes(hq / hkv, d);
  static SmemLimit limit;
  const cudaError_t err =
      limit.allow(reinterpret_cast<const void*>(decode_kernel<E>), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(hkv, b);
  decode_kernel<E><<<grid, THREADS, smem, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<E*>(o), lengths, length_all, st,
      hq, hkv, s_len, d, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 6 element strides, (batch, head, position) for the k cache and
// then the v cache. lengths: B int32 on the device, or null to use
// length_all for every row. Needs (hq / hkv) * d <= 2048. bf16: 0 for
// float32 q / caches / output, 1 for bfloat16. Returns cudaGetLastError().
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                void* o, const int* lengths, int length_all,
                                const long long* strides, int b, int hq,
                                int hkv, int s_len, int d, float scale,
                                int bf16, void* stream) {
  if ((hq / hkv) * d > EPT * THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st{strides[0], strides[1], strides[2], strides[3], strides[4],
             strides[5]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, o, lengths, length_all, st, b, hq,
                                 hkv, s_len, d, scale, s);
  return launch<float>(q, k, v, o, lengths, length_all, st, b, hq, hkv,
                       s_len, d, scale, s);
}
