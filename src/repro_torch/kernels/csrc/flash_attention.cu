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
// start at 0. Any S: the ragged edge is masked, not padded. D <= 256.
//
// What bounds it on an H100: at the serving prefill (B 32, S 512, D 80)
// the bytes (q, k, v read once, o written once: 0.063 ms at 3.35 TB/s)
// just above the operations of the in-band (q, k) pairs on the bf16 tensor
// cores (0.044 ms at 989 TFLOP/s); a long prefill (S 8192, window 4096) is
// bound by the operations. On f32 FMA (67 TFLOP/s, the earlier design) it
// was compute-starved either way. Tiles wholly outside the causal / window
// band are skipped, as the TPU kernel skips them, so a window of W keeps
// the work at ~S*W pairs instead of S^2/2.
//
// bfloat16 (flash_mma_kernel), FlashAttention-2 on mma.sync: one block of
// 4 warps per (batch, q head, 64-row q tile), each warp owning 16 q rows;
// the grid walks q tiles longest first. The q tile is copied once with
// cp.async and, for D <= 128, held in registers as ldmatrix A fragments,
// unscaled. Above that (D 256: recurrentgemma, gemma) the O accumulators
// alone take 128 f32 registers a thread, so the fragments are read again
// from shared memory at each k16 step instead of spilling. K and
// V tiles of 64 positions are staged as bf16 by 16-byte cp.async copies
// into two stages, the next tile in flight while this one is computed;
// rows past the end are zero-filled, not read. Shared rows are D rounded up
// to 16 (the pad zeroed once) plus 8 elements, so the 8 rows an ldmatrix
// reads fall in 8 distinct bank groups. S = Q K^T runs as m16n8k16 bf16
// MMAs with f32 accumulators; the scale D^-0.5 * log2(e) is applied to the
// f32 scores (scaling q in bf16 would round it once more than the plain
// version does), and only tiles that cross the diagonal, the window edge or
// the ragged end are masked. The online softmax stays in registers (exp2,
// row max over the 4 threads of a quad by shuffles, row sums reduced once
// at the end). The score accumulators are already the A-fragment layout
// of P V; P goes in as bf16 hi + lo (P - hi) in two MMAs, since P rounded
// to bf16 alone is off by up to 2^-9 relative, which breaks the one-ulp
// parity where the weighted values nearly cancel. The epilogue divides by
// the row sum and stores 16-byte chunks through the warp's own q rows in
// shared memory. Given an lse buffer (the training forward, for
// flash_attention_backward.cu) it also writes each row's log-sum-exp, m +
// log2(l) in natural-log units; inference passes null and writes nothing.
//
// float32 (flash_fma_kernel) keeps the earlier FMA design: TF32 tensor
// cores would break the 5e-5 f32 parity, and f32 serves only the
// correctness checks. One block of 256 threads per (batch, q head, 64-row
// q tile); q (pre-scaled), K, V and the tile's probabilities in shared
// memory as f32, each thread 4 q rows x ceil(D/16) columns.
//
// Open: wgmma with TMA and warp specialisation (producer warp, consumer
// warpgroups). For D = 80 TMA's 128-byte swizzle needs the row split into
// 64 + 16 boxes or padded to 96 / 128. At S = 512 the kernel is bounded
// by bytes, so mma.sync can pass the band-mask library call, which it
// does; cuDNN's causal path is still about twice as fast (PERF.md).
#include "attention_common.cuh"

namespace {

using attn::NEG_INF;
using bf16 = __nv_bfloat16;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int FMA_THREADS = 256;
constexpr int MMA_THREADS = 128;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Strides {
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

// -- float32: FMA on the CUDA cores -----------------------------------------

__host__ __device__ constexpr int fma_smem_floats(int d) {
  return BQ * (d + 1) + BK * (d + 1) + BK * d + BQ * (BK + 1);
}

// JD = ceil(D / 16): output column groups per thread.
template <int JD>
__global__ void __launch_bounds__(FMA_THREADS)
flash_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 Strides st, int hq, int hkv, int sq, int sk, int d,
                 int causal, int window, float scale) {
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
  const float* qp = q + b * st.qb + h * st.qh;
  const float* kp = k + b * st.kb + kvh * st.kh;
  const float* vp = v + b * st.vb + kvh * st.vh;
  float* op = o + b * st.ob + h * st.oh;

  for (int e = tid; e < BQ * d; e += FMA_THREADS) {
    const int r = e / d, c = e % d;
    qs[r * ld + c] = q0 + r < sq ? qp[(q0 + r) * st.qs + c] * scale : 0.f;
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
    for (int e = tid; e < BK * d; e += FMA_THREADS) {
      const int r = e / d, c = e % d;
      const bool in = k0 + r < sk;
      ks[r * ld + c] = in ? kp[(k0 + r) * st.ks + c] : 0.f;
      vs[r * d + c] = in ? vp[(k0 + r) * st.vs + c] : 0.f;
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
      if (col < d) op[qpos * st.os + col] = acc[i][j] / den;
    }
  }
}

template <int JD>
int launch_fma(const void* q, const void* k, const void* v, void* o,
               const Strides& st, int b, int hq, int hkv, int sq, int sk,
               int d, int causal, int window, float scale,
               cudaStream_t stream) {
  const int smem = fma_smem_floats(d) * static_cast<int>(sizeof(float));
  static attn::SmemLimit limit;
  const cudaError_t err =
      limit.allow(reinterpret_cast<const void*>(flash_fma_kernel<JD>), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + BQ - 1) / BQ, hq, b);
  flash_fma_kernel<JD><<<grid, FMA_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), st, hq, hkv, sq,
      sk, d, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// -- bfloat16: mma.sync on the tensor cores ---------------------------------

__host__ __device__ constexpr int mma_ld(int ks) { return 16 * ks + 8; }

__host__ __device__ constexpr int mma_smem_bytes(int ks) {
  // q tile, then K and V in two stages each, rows of mma_ld(ks) bf16
  return (BQ + 4 * BK) * mma_ld(ks) * 2;
}

// Copy rows [row0, row0 + 64) of a [S, d] operand (row stride `stride`)
// into a shared tile of row stride LD; rows at or past `limit` are
// zero-filled. d is a multiple of 8: d / 8 chunks of 16 bytes a row.
template <int LD>
__device__ __forceinline__ void copy_tile(bf16* dst, const bf16* src,
                                          long long stride, int row0,
                                          int limit, int chunks, int tid) {
  for (int e = tid; e < 64 * chunks; e += MMA_THREADS) {
    const int r = e / chunks, c = e % chunks;
    const bool in = row0 + r < limit;
    attn::cp_async16(dst + r * LD + c * 8,
                     src + (in ? (row0 + r) * stride : 0) + c * 8, in);
  }
}

// KS = ceil(D / 16): k16 steps of Q K^T; 2 * KS n8 column tiles of O.
template <int KS>
__global__ void __launch_bounds__(MMA_THREADS)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, Strides st, int hq, int hkv, int sq,
                 int sk, int d, int ldl, int causal, int window,
                 float scale_log2) {
  constexpr int DP = 16 * KS;
  constexpr int LD = mma_ld(KS);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [BQ][LD]
  bf16* ks = qs + BQ * LD;                        // [2][BK][LD]
  bf16* vs = ks + 2 * BK * LD;                    // [2][BK][LD]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;   // longest tiles first
  const int kvh = h / (hq / hkv);
  const bf16* qp = q + b * st.qb + h * st.qh;
  const bf16* kp = k + b * st.kb + kvh * st.kh;
  const bf16* vp = v + b * st.vb + kvh * st.vh;
  bf16* op = o + b * st.ob + h * st.oh;
  const int chunks = d / 8;

  // columns [d, DP) of every tile: zero, never written by the copies
  const int pad = (DP - d) / 8;
  for (int e = tid; e < (BQ + 4 * BK) * pad; e += MMA_THREADS)
    *reinterpret_cast<uint4*>(qs + (e / pad) * LD + d + (e % pad) * 8) =
        make_uint4(0, 0, 0, 0);

  const int q_last = min(q0 + BQ, sq) - 1;
  const int k_hi = causal ? min(q_last, sk - 1) : sk - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t0 = k_lo / BK;
  const int n_tiles = k_hi >= t0 * BK ? k_hi / BK - t0 + 1 : 0;

  copy_tile<LD>(qs, qp, st.qs, q0, sq, chunks, tid);
  if (n_tiles > 0) {
    copy_tile<LD>(ks, kp, st.ks, t0 * BK, sk, chunks, tid);
    copy_tile<LD>(vs, vp, st.vs, t0 * BK, sk, chunks, tid);
  }
  attn::cp_async_commit();

  // Q's A fragments: in registers up to KS 8, else from shared memory
  constexpr bool QREG = KS <= 8;
  uint32_t qf[QREG ? KS : 1][4];
  float acc[2 * KS][4];
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[n][r] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  // this thread's rows: g and g + 8 of the warp's 16
  const int row_a = q0 + warp * 16 + lane / 4;

  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = (t0 + i) * BK;
    if (i + 1 < n_tiles) {
      const int nxt = (i + 1) & 1;
      copy_tile<LD>(ks + nxt * BK * LD, kp, st.ks, k0 + BK, sk, chunks, tid);
      copy_tile<LD>(vs + nxt * BK * LD, vp, st.vs, k0 + BK, sk, chunks, tid);
    }
    attn::cp_async_commit();
    attn::cp_async_wait<1>();     // tile i (and q) landed
    __syncthreads();
    if constexpr (QREG) {
      if (i == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk)
          attn::ldmatrix_x4(qf[kk], qs + (warp * 16 + lane % 16) * LD
                                        + kk * 16 + (lane / 16) * 8);
      }
    }
    const bf16* kt = ks + (i & 1) * BK * LD;
    const bf16* vt = vs + (i & 1) * BK * LD;

    // S = Q K^T: 16 rows x 64 keys a warp, 8 n8 tiles
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[j][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const uint32_t* qa = qf[QREG ? kk : 0];
      if constexpr (!QREG)
        attn::ldmatrix_x4(qf[0], qs + (warp * 16 + lane % 16) * LD + kk * 16
                                     + (lane / 16) * 8);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t kb[4];
        attn::ldmatrix_x4(kb, kt + (jp * 16 + lane % 8 + (lane / 16) * 8) * LD
                                  + kk * 16 + ((lane / 8) % 2) * 8);
        attn::mma_bf16(s[2 * jp], qa, kb[0], kb[1]);
        attn::mma_bf16(s[2 * jp + 1], qa, kb[2], kb[3]);
      }
    }

    const bool need_mask = k0 + BK > sk || (causal && k0 + BK - 1 > q0)
                           || (window > 0 && k0 <= q_last - window);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float x = s[j][r] * scale_log2;
        if (need_mask) {
          const int qpos = row_a + (r / 2) * 8;
          const int kpos = k0 + j * 8 + 2 * (lane % 4) + (r & 1);
          bool ok = kpos < sk;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
          if (!ok) x = NEG_INF;
        }
        s[j][r] = x;
        mx[r / 2] = fmaxf(mx[r / 2], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      const float m_new = fmaxf(m[hr], mx[hr]);
      corr[hr] = exp2f(m[hr] - m_new);
      m[hr] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p = exp2f(s[j][r] - m[r / 2]);
        s[j][r] = p;
        sum[r / 2] += p;
      }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) l[hr] = l[hr] * corr[hr] + sum[hr];
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // O += P V, P as bf16 hi + lo; keys 16 kk .. 16 kk + 15 per step
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ph[4], pl[4];
      attn::split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      attn::split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      attn::split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      attn::split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < KS; ++dp) {
        uint32_t vb[4];
        attn::ldmatrix_x4_trans(
            vb, vt + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD
                    + dp * 16 + (lane / 16) * 8);
        attn::mma_bf16(acc[2 * dp], ph, vb[0], vb[1]);
        attn::mma_bf16(acc[2 * dp], pl, vb[0], vb[1]);
        attn::mma_bf16(acc[2 * dp + 1], ph, vb[2], vb[3]);
        attn::mma_bf16(acc[2 * dp + 1], pl, vb[2], vb[3]);
      }
    }
    __syncthreads();   // stage i & 1 fully read before tile i + 2 lands
  }
  attn::cp_async_wait<0>();
  __syncthreads();

  // epilogue: o / l as bf16 into the warp's own q rows, then 16-byte stores;
  // with lse, each row's m + log2(l) in natural-log units (every row of the
  // tile, those past sq too: the backward reads whole tiles)
  float inv[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float t = l[hr];
    t += __shfl_xor_sync(0xffffffffu, t, 1);
    t += __shfl_xor_sync(0xffffffffu, t, 2);
    inv[hr] = 1.f / fmaxf(t, 1e-30f);
    if (lse != nullptr && lane % 4 == 0)
      lse[(static_cast<long long>(b) * hq + h) * ldl + row_a + hr * 8] =
          (m[hr] + log2f(t)) * LN2;
  }
  bf16* ow = qs + warp * 16 * LD;
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n) {
    const int col = n * 8 + 2 * (lane % 4);
    if (n * 8 < d) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<uint32_t*>(ow + (lane / 4 + hr * 8) * LD + col) =
            attn::pack_bf16(acc[n][2 * hr] * inv[hr],
                            acc[n][2 * hr + 1] * inv[hr]);
    }
  }
  __syncwarp();
  for (int e = lane; e < 16 * chunks; e += 32) {
    const int r = e / chunks, c = e % chunks;
    const int qpos = q0 + warp * 16 + r;
    if (qpos < sq)
      *reinterpret_cast<uint4*>(op + qpos * st.os + c * 8) =
          *reinterpret_cast<const uint4*>(ow + r * LD + c * 8);
  }
}

template <int KS>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               float* lse, const Strides& st, int b, int hq, int hkv, int sq,
               int sk, int d, int ldl, int causal, int window, float scale,
               cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes(KS);
  static attn::SmemLimit limit;
  const cudaError_t err =
      limit.allow(reinterpret_cast<const void*>(flash_mma_kernel<KS>), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(hq, b, (sq + BQ - 1) / BQ);
  flash_mma_kernel<KS><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, st, hq, hkv,
      sq, sk, d, ldl, causal, window, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

#define FLASH_ARGS \
  q, k, v, o, st, b, hq, hkv, sq, sk, d, causal, window, scale, s
#define MMA_ARGS \
  q, k, v, o, lse, st, b, hq, hkv, sq, sk, d, ldl, causal, window, scale, s

int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const Strides& st, int b, int hq, int hkv, int sq, int sk, int d,
           int ldl, int causal, int window, float scale, int bf16_in,
           cudaStream_t s) {
  const int groups = (d + 15) / 16;
  if (bf16_in) {
    if (d % 8 || (lse != nullptr && ldl < (sq + BQ - 1) / BQ * BQ))
      return static_cast<int>(cudaErrorInvalidValue);
    switch (groups) {
      case 1: return launch_mma<1>(MMA_ARGS);
      case 2: return launch_mma<2>(MMA_ARGS);
      case 3: return launch_mma<3>(MMA_ARGS);
      case 4: return launch_mma<4>(MMA_ARGS);
      case 5: return launch_mma<5>(MMA_ARGS);
      case 6: return launch_mma<6>(MMA_ARGS);
      case 7: return launch_mma<7>(MMA_ARGS);
      case 8: return launch_mma<8>(MMA_ARGS);
      case 9: case 10: case 11: case 12: case 13: case 14: case 15: case 16:
        return launch_mma<16>(MMA_ARGS);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (lse != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  switch (groups) {
    case 1: return launch_fma<1>(FLASH_ARGS);
    case 2: return launch_fma<2>(FLASH_ARGS);
    case 3: return launch_fma<3>(FLASH_ARGS);
    case 4: return launch_fma<4>(FLASH_ARGS);
    case 5: return launch_fma<5>(FLASH_ARGS);
    case 6: return launch_fma<6>(FLASH_ARGS);
    case 7: return launch_fma<7>(FLASH_ARGS);
    case 8: return launch_fma<8>(FLASH_ARGS);
    case 9: case 10: case 11: case 12: case 13: case 14: case 15: case 16:
      return launch_fma<16>(FLASH_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#undef FLASH_ARGS
#undef MMA_ARGS

}  // namespace

// strides: 12 element strides, (batch, head, position) for q, k, v, o in
// that order. window <= 0: no window. scale: the score scale (D^-0.5,
// as the caller computes it). bf16: 0 for float32 inputs and output, 1 for
// bfloat16 (then D % 8 == 0 and every pointer and stride 16-byte aligned,
// which the wrapper checks). lse: null, or (bf16 only) a float32 [b, hq,
// ldl] buffer, ldl >= sq rounded up to 64, that gets each query row's log
// of its softmax sum over the scaled scores (what the backward recomputes
// the probabilities from). Returns cudaGetLastError().
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, void* lse, const long long* strides,
                               int b, int hq, int hkv, int sq, int sk, int d,
                               int ldl, int causal, int window, float scale,
                               int bf16, void* stream) {
  Strides st{strides[0], strides[1], strides[2], strides[3],
             strides[4], strides[5], strides[6], strides[7],
             strides[8], strides[9], strides[10], strides[11]};
  return launch(q, k, v, o, static_cast<float*>(lse), st, b, hq, hkv, sq, sk,
                d, ldl, causal, window, scale, bf16,
                static_cast<cudaStream_t>(stream));
}
