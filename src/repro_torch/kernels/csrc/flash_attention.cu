// flash_attention: causal and/or sliding-window GQA attention, forward,
// online softmax, math in f32, output in q's dtype.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention / _kernel): o = softmax(q k^T * D^-0.5 + mask) v with
// mask = (kpos <= qpos if causal) & (kpos > qpos - window if window), q
// head h reading kv head h // (Hq / Hkv). The LM's prefill runs it once per
// layer (src/repro/models/attention.py, attn_apply).
//
// q is [B, Hq, Sq, D], k/v are [B, Hkv, Sk, D], o is [B, Hq, Sq, D], each
// given by its (batch, head, position) strides in elements with the last
// dim contiguous, so the model passes its [B, S, H, D] activations as
// strided views and no transpose is copied. Query and key positions both
// start at 0. Any S: the ragged edge is masked, not padded. D <= 128.
//
// What bounds it on an H100: operations. Per (q, k) pair it does 4D flops
// against bytes that are read once per tile; a long prefill is far above
// the card's flops per byte. Tiles wholly outside the causal / window band
// are skipped, as the TPU kernel skips them, so a window of W keeps the
// work at ~S*W pairs instead of S^2/2.
//
// Design (simple and right first): one block of 256 threads owns one
// (batch, q head, 64-row q tile) and walks the kv tiles its rows can reach
// in order, the loop taking the place of the TPU grid's sequential kv axis.
// The q tile (pre-scaled), one K tile, one V tile and the tile's
// probabilities sit in shared memory as f32, rows padded to D + 1 words so
// neighbouring rows fall in other banks. Thread (ty, tx) of a 16 x 16 grid
// owns 4 q rows: it computes their scores against keys tx + 16j (j < 4),
// keeps the running max / denominator of its rows (the 16 threads of a row
// agree through shuffles) and accumulates 4 x ceil(D/16) outputs, columns
// tx + 16j, with f32 FMA. head_dim 80 is tiled as 5 x 16 in shared memory;
// nothing is padded in device memory. No tensor cores yet, which keeps
// float32 inputs in full float32 (TF32 would break the f32 parity); a
// wgmma / TMA version is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <mutex>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
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
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__host__ __device__ constexpr int smem_floats(int d) {
  return BQ * (d + 1) + BK * (d + 1) + BK * d + BQ * (BK + 1);
}

// JD = ceil(D / 16): output column groups per thread.
template <typename T, int JD>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, Strides st,
             int hq, int hkv, int sq, int sk, int d, int causal, int window,
             float scale) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* qs = smem;                  // [BQ][d + 1]
  float* ks = qs + BQ * ld;          // [BK][d + 1]
  float* vs = ks + BK * ld;          // [BK][d]
  float* ps = vs + BK * d;           // [BQ][BK + 1]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const T* qp = q + b * st.qb + h * st.qh;
  const T* kp = k + b * st.kb + kvh * st.kh;
  const T* vp = v + b * st.vb + kvh * st.vh;
  T* op = o + b * st.ob + h * st.oh;

  for (int e = tid; e < BQ * d; e += THREADS) {
    const int r = e / d, c = e % d;
    qs[r * ld + c] = q0 + r < sq ? to_f32(qp[(q0 + r) * st.qs + c]) * scale
                                 : 0.f;
  }

  float m[4], l[4], acc[4][JD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < JD; ++j) acc[i][j] = 0.f;
  }

  const int q_last = min(q0 + BQ, sq) - 1;
  const int k_hi = causal ? min(q_last, sk - 1) : sk - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;

  for (int k0 = (k_lo / BK) * BK; k0 <= k_hi; k0 += BK) {
    __syncthreads();  // previous tile's ps / vs fully read (and qs written)
    for (int e = tid; e < BK * d; e += THREADS) {
      const int r = e / d, c = e % d;
      const bool in = k0 + r < sk;
      ks[r * ld + c] = in ? to_f32(kp[(k0 + r) * st.ks + c]) : 0.f;
      vs[r * d + c] = in ? to_f32(vp[(k0 + r) * st.vs + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * ld + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * ld + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos < sk;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        if (!ok) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty * 4 + i) * (BK + 1) + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      corr[i] = expf(m[i] - m_new);
      l[i] = l[i] * corr[i] + sum;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < JD; ++j) acc[i][j] *= corr[i];
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < JD; ++j) {
        const int col = tx + 16 * j;
        const float vv = col < d ? vs[c * d + col] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < JD; ++j) {
      const int col = tx + 16 * j;
      if (col < d) store(op + qpos * st.os + col, acc[i][j] / den);
    }
  }
}

template <typename T, int JD>
int launch_jd(const void* q, const void* k, const void* v, void* o,
              const Strides& st, int b, int hq, int hkv, int sq, int sk,
              int d, int causal, int window, float scale,
              cudaStream_t stream) {
  const int smem = smem_floats(d) * static_cast<int>(sizeof(float));
  static SmemLimit limit;
  const cudaError_t err =
      limit.allow(reinterpret_cast<const void*>(flash_kernel<T, JD>), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + BQ - 1) / BQ, hq, b);
  flash_kernel<T, JD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), st, hq, hkv, sq, sk, d,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           const Strides& st, int b, int hq, int hkv, int sq, int sk, int d,
           int causal, int window, float scale, cudaStream_t s) {
  switch ((d + 15) / 16) {
    case 1: return launch_jd<T, 1>(q, k, v, o, st, b, hq, hkv, sq, sk, d, causal, window, scale, s);
    case 2: return launch_jd<T, 2>(q, k, v, o, st, b, hq, hkv, sq, sk, d, causal, window, scale, s);
    case 3: return launch_jd<T, 3>(q, k, v, o, st, b, hq, hkv, sq, sk, d, causal, window, scale, s);
    case 4: return launch_jd<T, 4>(q, k, v, o, st, b, hq, hkv, sq, sk, d, causal, window, scale, s);
    case 5: return launch_jd<T, 5>(q, k, v, o, st, b, hq, hkv, sq, sk, d, causal, window, scale, s);
    case 6: return launch_jd<T, 6>(q, k, v, o, st, b, hq, hkv, sq, sk, d, causal, window, scale, s);
    case 7: return launch_jd<T, 7>(q, k, v, o, st, b, hq, hkv, sq, sk, d, causal, window, scale, s);
    case 8: return launch_jd<T, 8>(q, k, v, o, st, b, hq, hkv, sq, sk, d, causal, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// strides: 12 element strides, (batch, head, position) for q, k, v, o in
// that order. window <= 0: no window. scale: the score scale (D^-0.5,
// as the caller computes it). bf16: 0 for float32 inputs and
// output, 1 for bfloat16. Returns cudaGetLastError().
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, const long long* strides, int b,
                               int hq, int hkv, int sq, int sk, int d,
                               int causal, int window, float scale,
                               int bf16, void* stream) {
  Strides st{strides[0], strides[1], strides[2], strides[3],
             strides[4], strides[5], strides[6], strides[7],
             strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, o, st, b, hq, hkv, sq, sk, d,
                                 causal, window, scale, s);
  return launch<float>(q, k, v, o, st, b, hq, hkv, sq, sk, d, causal,
                       window, scale, s);
}
