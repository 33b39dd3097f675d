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
// flops per byte. The earlier design (one block per (row, kv head), f32
// staging through 2-byte loads) kept too few bytes in flight to stream the
// cache at HBM rate.
//
// Design (flash-decoding): the cache below the row's length is split over
// blocks, and a combine pass merges the splits. The grid is (split, kv
// head x group of <= 16 query heads, row); each split covers `chunk`
// positions (a multiple of 64, chosen by the wrapper so the grid fills the
// card, with one split where the batch alone does) and stops at the row's
// length. Splits past a
// row's length write an empty partial (m = -inf, l = 0). K and V are
// streamed as raw bf16 / f32 by 16-byte cp.async copies, rows past the end
// zero-filled, and converted to f32 only where they are used.
//
// bfloat16 (decode_mma_kernel): a split's 16-position tiles are dealt to
// 4 warps, each with its own 3-stage cp.async ring (two tiles in flight
// while one is computed, no block-wide barrier in the loop). The group's
// query heads are the 16 rows of one m16n8k16 tile (rows past G zero), so
// every K / V row loaded serves all G heads: S = Q K^T on the tensor cores
// with f32 accumulators, the scale D^-0.5 * log2(e) applied to the f32
// scores, online softmax in registers, and O += P V with P as bf16 hi + lo
// (as in flash_attention.cu). On the CUDA cores (one dot product a lane,
// one head a warp, f32 FMA) the same split design runs about ten times the
// instructions per cache row, so at 2G = 8 flops a cache element its limit
// is instruction throughput, not bytes. D is padded to KS = ceil(D / 16)
// k16 steps in shared memory only; one instance for each KS from 1 to 16.
// At the end the 4 warps' (m, l, acc) are merged through shared memory.
//
// float32 (decode_fma_kernel), for the correctness checks: a block-wide
// ring of three 32-position stages; warp w scores heads w, w + 4, ...
// (one position a lane, q scaled in f32), then every thread accumulates
// up to EPT = 16 pairs of output columns of the G * D group with f32 FMA
// (recurrentgemma's G 16 x D 256 takes all 16, and 213 KB of shared
// memory a block).
//
// G * D <= 4096 in both dtypes. The bf16 instance takes G 16 at D 256 as
// it is: G 16 is the m16 rows it already scores, and KS 16 its widest.
//
// A split writes its partial (acc[D], m, l) in f32, m in log2 units;
// decode_combine_kernel merges a row's partials and writes the output in
// q's dtype. With one split the split kernel writes the output itself.
//
// lse (optional, [B, Hq] f32): whichever pass writes the output also
// writes each head's log of its softmax sum, m + log l in natural units,
// -inf where no position is below length (the output is then 0). A cache
// split over ranks runs the kernel on each rank's slice and merges the
// slices' (o, lse) pairs (decode_attention_partial in the wrapper); there
// the output is f32 whatever the inputs' dtype (o_f32), so the merge
// rounds once.
//
// Open: the decode step around it is host-bound (PERF.md); CUDA graphs
// over the step and fusing RoPE / the cache write into it are the levers.
#include <math_constants.h>

#include "attention_common.cuh"

namespace {

using attn::NEG_INF;
using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// float32: a block-wide ring of STAGES stages of TP positions
constexpr int TP = 32;          // cache positions per stage (one a lane)
constexpr int STAGES = 3;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_GROUP_WIDTH = 4096;   // G * D
constexpr int EPT = MAX_GROUP_WIDTH / (2 * THREADS);  // column pairs a thread

struct Strides {
  long long kb, kh, ks, vb, vh, vs;
};

int fma_smem_bytes(int g, int d) {
  const int ld = d * 4 + 16;
  // K and V rings, then q [g][d], p [g][TP], m, l, corr [g] as f32
  return 2 * STAGES * TP * ld
         + static_cast<int>(sizeof(float)) * (g * d + g * TP + 3 * g);
}

__global__ void __launch_bounds__(THREADS)
decode_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ part, float* __restrict__ lse,
                  const int* __restrict__ lengths,
                  int length_all, Strides st, int hq, int hkv, int s_len,
                  int d, int chunk, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int g_n = hq / hkv;
  const int ld = d * 4 + 16;    // bytes a row
  unsigned char* kring = smem;                            // [STAGES][TP]
  unsigned char* vring = kring + STAGES * TP * ld;        // [STAGES][TP]
  float* qs = reinterpret_cast<float*>(vring + STAGES * TP * ld);  // [g][d]
  float* ps = qs + g_n * d;                               // [g][TP]
  float* ms = ps + g_n * TP;                              // [g]
  float* ls = ms + g_n;                                   // [g]
  float* corr = ls + g_n;                                 // [g]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int h0 = kvh * g_n;
  int len = lengths ? lengths[b] : length_all;
  len = max(0, min(len, s_len));
  const int p0 = split * chunk;
  const int p1 = min(p0 + chunk, len);
  const int n_tiles = p1 > p0 ? (p1 - p0 + TP - 1) / TP : 0;
  const char* kp = reinterpret_cast<const char*>(k + b * st.kb + kvh * st.kh);
  const char* vp = reinterpret_cast<const char*>(v + b * st.vb + kvh * st.vh);
  const long long ks_bytes = st.ks * 4LL;
  const long long vs_bytes = st.vs * 4LL;
  const int chunks = d * 4 / 16;   // a row

  auto prefetch = [&](int t) {
    unsigned char* kd = kring + (t % STAGES) * TP * ld;
    unsigned char* vd = vring + (t % STAGES) * TP * ld;
    const int pos0 = p0 + t * TP;
    for (int e = tid; e < TP * chunks; e += THREADS) {
      const int r = e / chunks, c = e % chunks;
      const bool in = pos0 + r < p1;
      const long long pos = in ? pos0 + r : 0;
      attn::cp_async16(kd + r * ld + c * 16, kp + pos * ks_bytes + c * 16,
                       in);
      attn::cp_async16(vd + r * ld + c * 16, vp + pos * vs_bytes + c * 16,
                       in);
    }
  };
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_tiles) prefetch(t);
    attn::cp_async_commit();
  }

  const float* qp = q + (static_cast<long long>(b) * hq + h0) * d;
  for (int e = tid; e < g_n * d; e += THREADS)
    qs[e] = qp[e] * scale;
  for (int g = tid; g < g_n; g += THREADS) {
    ms[g] = NEG_INF;
    ls[g] = 0.f;
  }
  const int pairs = g_n * d / 2;
  float2 acc[EPT];
#pragma unroll
  for (int i = 0; i < EPT; ++i) acc[i] = make_float2(0.f, 0.f);

  for (int t = 0; t < n_tiles; ++t) {
    attn::cp_async_wait<STAGES - 2>();   // stage t landed
    __syncthreads();                     // ... for every thread; t - 1 used
    if (t + STAGES - 1 < n_tiles) prefetch(t + STAGES - 1);
    attn::cp_async_commit();
    const unsigned char* kt = kring + (t % STAGES) * TP * ld;
    const unsigned char* vt = vring + (t % STAGES) * TP * ld;
    const int pos = p0 + t * TP + lane;

    // scores: warp w takes heads w, w + WARPS, ...; lane = position
    for (int g = warp; g < g_n; g += WARPS) {
      float sc = NEG_INF;
      if (pos < p1) {
        // q as float4 broadcasts, four independent partial sums
        const float4* qg = reinterpret_cast<const float4*>(qs + g * d);
        const float4* row = reinterpret_cast<const float4*>(kt + lane * ld);
        float4 part4 = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int c = 0; c < chunks; ++c) {
          const float4 kv = row[c], qv = qg[c];
          part4.x = fmaf(qv.x, kv.x, part4.x);
          part4.y = fmaf(qv.y, kv.y, part4.y);
          part4.z = fmaf(qv.z, kv.z, part4.z);
          part4.w = fmaf(qv.w, kv.w, part4.w);
        }
        sc = (part4.x + part4.y) + (part4.z + part4.w);
      }
      float mx = sc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, mx);
      const float p = expf(sc - m_new);
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      ps[g * TP + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        corr[g] = c;
        ls[g] = ls[g] * c + sum;
        ms[g] = m_new;
      }
    }
    __syncthreads();

    // acc[g][2c, 2c + 1] = corr * acc + sum_x p[g][x] v[x][2c, 2c + 1]
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      const int e = tid + i * THREADS;
      if (e < pairs) {
        const int g = e / (d / 2), c = e % (d / 2);
        const float cg = corr[g];
        // even and odd positions in separate sums, merged once
        float2 a = make_float2(acc[i].x * cg, acc[i].y * cg);
        float2 b = make_float2(0.f, 0.f);
        const float* pg = ps + g * TP;
        const float2* vcol = reinterpret_cast<const float2*>(vt) + c;
        const int ldv = ld / 8;     // a row, in float2
#pragma unroll
        for (int x = 0; x < TP; x += 2) {
          const float2 p2 = *reinterpret_cast<const float2*>(pg + x);
          const float2 v0 = vcol[x * ldv];
          const float2 v1 = vcol[(x + 1) * ldv];
          a.x = fmaf(p2.x, v0.x, a.x);
          a.y = fmaf(p2.x, v0.y, a.y);
          b.x = fmaf(p2.y, v1.x, b.x);
          b.y = fmaf(p2.y, v1.y, b.y);
        }
        acc[i] = make_float2(a.x + b.x, a.y + b.y);
      }
    }
  }
  attn::cp_async_wait<0>();
  __syncthreads();   // ms / ls final (and set, when n_tiles == 0)

#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    const int e = tid + i * THREADS;
    if (e >= pairs) continue;
    const int g = e / (d / 2), c = e % (d / 2);
    const long long head = static_cast<long long>(b) * hq + h0 + g;
    if (n_split == 1) {
      const float inv = 1.f / fmaxf(ls[g], 1e-30f);
      *reinterpret_cast<float2*>(o + head * d + 2 * c) =
          make_float2(acc[i].x * inv, acc[i].y * inv);
      if (lse != nullptr && c == 0)
        lse[head] = ls[g] > 0.f ? ms[g] + logf(ls[g]) : -CUDART_INF_F;
    } else {
      float* pp = part + (head * n_split + split) * (d + 2);
      *reinterpret_cast<float2*>(pp + 2 * c) = acc[i];
      if (c == 0) {
        pp[d] = ms[g] * LOG2E;
        pp[d + 1] = ls[g];
      }
    }
  }
}

// -- bfloat16: mma.sync on the tensor cores ---------------------------------

constexpr int ROWS = 16;        // query heads a block: the mma's m16
constexpr int WT = 16;          // positions a warp tile: the PV mma's k16
constexpr int MMA_STAGES = 3;   // a warp's ring: two tiles in flight

__host__ __device__ constexpr int mma_ld(int ks) { return 16 * ks + 8; }

constexpr int mma_smem_bytes(int ks) {
  // q tile [16][LD], then each warp's K and V rings [STAGES][16][LD], all
  // bf16; after the loop the rings hold the warps' (m, l, acc) in f32
  return ROWS * mma_ld(ks) * 2 + WARPS * MMA_STAGES * 2 * WT * mma_ld(ks) * 2;
}

// KS = ceil(D / 16): k16 steps of Q K^T; 2 * KS n8 column tiles of O.
template <int KS>
__global__ void __launch_bounds__(THREADS)
decode_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, void* __restrict__ o,
                  float* __restrict__ part, float* __restrict__ lse,
                  const int* __restrict__ lengths,
                  int length_all, Strides st, int hq, int hkv, int s_len,
                  int d, int chunk, float scale_log2, int o_f32) {
  constexpr int DP = 16 * KS;
  constexpr int LD = mma_ld(KS);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [ROWS][LD]
  bf16* rings = qs + ROWS * LD;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int split = blockIdx.x, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int g_n = hq / hkv, groups = (g_n + ROWS - 1) / ROWS;
  const int kvh = blockIdx.y / groups;
  const int g0 = (blockIdx.y % groups) * ROWS;
  const int rows = min(ROWS, g_n - g0);
  const long long head0 = static_cast<long long>(b) * hq + kvh * g_n + g0;
  int len = lengths ? lengths[b] : length_all;
  len = max(0, min(len, s_len));
  const int p0 = split * chunk;
  const int p1 = min(p0 + chunk, len);
  const int n_tiles = p1 > p0 ? (p1 - p0 + WT - 1) / WT : 0;
  // warp w takes the split's tiles w, w + WARPS, ...
  const int my_tiles = n_tiles > warp ? (n_tiles - warp + WARPS - 1) / WARPS
                                      : 0;
  bf16* kr = rings + warp * MMA_STAGES * 2 * WT * LD;   // [STAGES][WT][LD]
  bf16* vr = kr + MMA_STAGES * WT * LD;
  const bf16* kp = k + b * st.kb + kvh * st.kh;
  const bf16* vp = v + b * st.vb + kvh * st.vh;
  const int chunks = d / 8;

  auto prefetch = [&](int j) {   // this warp's j-th tile into stage j % STAGES
    const int pos0 = p0 + (warp + j * WARPS) * WT;
    bf16* kd = kr + (j % MMA_STAGES) * WT * LD;
    bf16* vd = vr + (j % MMA_STAGES) * WT * LD;
    for (int e = lane; e < WT * chunks; e += 32) {
      const int r = e / chunks, c = e % chunks;
      const bool in = pos0 + r < p1;
      const long long pos = in ? pos0 + r : 0;
      attn::cp_async16(kd + r * LD + c * 8, kp + pos * st.ks + c * 8, in);
      attn::cp_async16(vd + r * LD + c * 8, vp + pos * st.vs + c * 8, in);
    }
  };
  // columns [d, DP) of the rings: zero, never written by the copies
  if (d < DP)
    for (int r = tid; r < WARPS * MMA_STAGES * 2 * WT; r += THREADS)
      *reinterpret_cast<uint4*>(rings + r * LD + d) = make_uint4(0, 0, 0, 0);
  for (int j = 0; j < MMA_STAGES - 1; ++j) {
    if (j < my_tiles) prefetch(j);
    attn::cp_async_commit();
  }
  // the group's q rows as raw bf16 (scaled later, on the f32 scores);
  // rows past the group and columns past d are zero
  for (int e = tid; e < ROWS * (DP / 8); e += THREADS) {
    const int r = e / (DP / 8), c = e % (DP / 8);
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < rows && c < chunks)
      val = *reinterpret_cast<const uint4*>(q + (head0 + r) * d + c * 8);
    *reinterpret_cast<uint4*>(qs + r * LD + c * 8) = val;
  }
  __syncthreads();
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    attn::ldmatrix_x4(qf[kk], qs + (lane % 16) * LD + kk * 16
                                  + (lane / 16) * 8);

  float acc[2 * KS][4];
#pragma unroll
  for (int n = 0; n < 2 * KS; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[n][r] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int j = 0; j < my_tiles; ++j) {
    if (j + MMA_STAGES - 1 < my_tiles) prefetch(j + MMA_STAGES - 1);
    attn::cp_async_commit();
    attn::cp_async_wait<MMA_STAGES - 1>();   // tile j landed
    __syncwarp();
    const bf16* kt = kr + (j % MMA_STAGES) * WT * LD;
    const bf16* vt = vr + (j % MMA_STAGES) * WT * LD;
    const int pos0 = p0 + (warp + j * WARPS) * WT;

    // S = Q K^T: 16 heads x 16 positions, two n8 tiles
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t kb[4];
      attn::ldmatrix_x4(kb, kt + (lane % 8 + (lane / 16) * 8) * LD
                                + kk * 16 + ((lane / 8) % 2) * 8);
      attn::mma_bf16(s[0], qf[kk], kb[0], kb[1]);
      attn::mma_bf16(s[1], qf[kk], kb[2], kb[3]);
    }
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int pos = pos0 + n * 8 + 2 * (lane % 4) + (r & 1);
        const float x = pos < p1 ? s[n][r] * scale_log2 : NEG_INF;
        s[n][r] = x;
        mx[r / 2] = fmaxf(mx[r / 2], x);
      }
    float corr[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
      mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
      const float m_new = fmaxf(m[hr], mx[hr]);
      corr[hr] = exp2f(m[hr] - m_new);
      m[hr] = m_new;
      l[hr] *= corr[hr];
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p = exp2f(s[n][r] - m[r / 2]);
        s[n][r] = p;
        l[r / 2] += p;
      }
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
    // O += P V over the tile's 16 positions, P as bf16 hi + lo
    uint32_t ph[4], pl[4];
    attn::split_bf16(s[0][0], s[0][1], ph[0], pl[0]);
    attn::split_bf16(s[0][2], s[0][3], ph[1], pl[1]);
    attn::split_bf16(s[1][0], s[1][1], ph[2], pl[2]);
    attn::split_bf16(s[1][2], s[1][3], ph[3], pl[3]);
#pragma unroll
    for (int dp = 0; dp < KS; ++dp) {
      uint32_t vb[4];
      attn::ldmatrix_x4_trans(vb, vt + (lane % 8 + ((lane / 8) % 2) * 8) * LD
                                      + dp * 16 + (lane / 16) * 8);
      attn::mma_bf16(acc[2 * dp], ph, vb[0], vb[1]);
      attn::mma_bf16(acc[2 * dp], pl, vb[0], vb[1]);
      attn::mma_bf16(acc[2 * dp + 1], ph, vb[2], vb[3]);
      attn::mma_bf16(acc[2 * dp + 1], pl, vb[2], vb[3]);
    }
    __syncwarp();   // stage read by every lane before it is refilled
  }
  attn::cp_async_wait<0>();
  __syncthreads();   // every ring idle: reuse it for the warps' results

  float* cm = reinterpret_cast<float*>(rings);     // [WARPS][ROWS] m
  float* cl = cm + WARPS * ROWS;                   // [WARPS][ROWS] l
  float* ca = cl + WARPS * ROWS;                   // [WARPS][ROWS][DP] acc
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
    const int row = lane / 4 + hr * 8;
    if (lane % 4 == 0) {
      cm[warp * ROWS + row] = m[hr];
      cl[warp * ROWS + row] = l[hr];
    }
#pragma unroll
    for (int n = 0; n < 2 * KS; ++n)
      *reinterpret_cast<float2*>(ca + (warp * ROWS + row) * DP + n * 8
                                 + 2 * (lane % 4)) =
          make_float2(acc[n][2 * hr], acc[n][2 * hr + 1]);
  }
  __syncthreads();
  for (int e = tid; e < rows * d; e += THREADS) {
    const int r = e / d, c = e % d;
    float mm = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mm = fmaxf(mm, cm[w * ROWS + r]);
    float ll = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = exp2f(cm[w * ROWS + r] - mm);
      ll = fmaf(cl[w * ROWS + r], wt, ll);
      a = fmaf(ca[(w * ROWS + r) * DP + c], wt, a);
    }
    const long long head = head0 + r;
    if (n_split == 1) {
      const float out = a / fmaxf(ll, 1e-30f);
      if (o_f32)
        static_cast<float*>(o)[head * d + c] = out;
      else
        static_cast<bf16*>(o)[head * d + c] = __float2bfloat16(out);
      if (lse != nullptr && c == 0)
        lse[head] = ll > 0.f ? (mm + log2f(ll)) * LN2 : -CUDART_INF_F;
    } else {
      float* pp = part + (head * n_split + split) * (d + 2);
      pp[c] = a;
      if (c == 0) {
        pp[d] = mm;
        pp[d + 1] = ll;
      }
    }
  }
}

// -- the combine pass -------------------------------------------------------

// One block per (q head, row): o = sum_s w_s acc_s / sum_s w_s l_s with
// w_s = 2^(m_s - max m), m in log2 units. A split past the row's length
// has l = 0. The weights go through shared memory once, so each output
// column is one pass of independent loads over the splits.
constexpr int MAX_SPLITS = 1024;

template <typename E>
__global__ void __launch_bounds__(THREADS)
decode_combine_kernel(const float* __restrict__ part, E* __restrict__ o,
                      float* __restrict__ lse, int hq, int d, int n_split) {
  __shared__ float w[MAX_SPLITS];
  __shared__ float red[2];
  const long long head = static_cast<long long>(blockIdx.y) * hq
                         + blockIdx.x;
  const float* pp = part + head * n_split * (d + 2);
  for (int s = threadIdx.x; s < n_split; s += THREADS)
    w[s] = pp[s * (d + 2) + d];
  __syncthreads();
  if (threadIdx.x < 32) {
    float m = NEG_INF;
    for (int s = threadIdx.x; s < n_split; s += 32) m = fmaxf(m, w[s]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (threadIdx.x == 0) red[0] = m;
  }
  __syncthreads();
  const float m = red[0];
  __syncthreads();
  for (int s = threadIdx.x; s < n_split; s += THREADS)
    w[s] = exp2f(w[s] - m);
  __syncthreads();
  if (threadIdx.x < 32) {
    float l = 0.f;
    for (int s = threadIdx.x; s < n_split; s += 32)
      l = fmaf(pp[s * (d + 2) + d + 1], w[s], l);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    if (threadIdx.x == 0) {
      red[1] = 1.f / fmaxf(l, 1e-30f);
      if (lse != nullptr)
        lse[head] = l > 0.f ? (m + log2f(l)) * LN2 : -CUDART_INF_F;
    }
  }
  __syncthreads();
  const float inv = red[1];
  for (int c = threadIdx.x; c < d; c += THREADS) {
    float a0 = 0.f, a1 = 0.f;
    int s = 0;
    for (; s + 1 < n_split; s += 2) {
      a0 = fmaf(pp[s * (d + 2) + c], w[s], a0);
      a1 = fmaf(pp[(s + 1) * (d + 2) + c], w[s + 1], a1);
    }
    if (s < n_split) a0 = fmaf(pp[s * (d + 2) + c], w[s], a0);
    attn::store(o + head * d + c, (a0 + a1) * inv);
  }
}

template <int KS>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       float* part, float* lse, const int* lengths,
                       int length_all,
                       const Strides& st, int b, int hq, int hkv, int s_len,
                       int d, int chunk, int n_split, float scale, int o_f32,
                       cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes(KS);
  static attn::SmemLimit limit;
  const cudaError_t err = limit.allow(
      reinterpret_cast<const void*>(decode_mma_kernel<KS>), smem);
  if (err != cudaSuccess) return err;
  const int groups = (hq / hkv + ROWS - 1) / ROWS;
  decode_mma_kernel<KS>
      <<<dim3(n_split, hkv * groups, b), THREADS, smem, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), o, part, lse, lengths, length_all, st,
          hq, hkv, s_len, d, chunk, scale * LOG2E, o_f32);
  return cudaGetLastError();
}

#define DECODE_ARGS q, k, v, o, part, lse, lengths, length_all, st, b, hq, \
                    hkv, s_len, d, chunk, n_split, scale, o_f32, stream

cudaError_t launch_split(const void* q, const void* k, const void* v,
                         void* o, float* part, float* lse,
                         const int* lengths,
                         int length_all, const Strides& st, int b, int hq,
                         int hkv, int s_len, int d, int chunk, int n_split,
                         float scale, int bf16_in, int o_f32,
                         cudaStream_t stream) {
  if (bf16_in) {
    switch ((d + 15) / 16) {
      case 1: return launch_mma<1>(DECODE_ARGS);
      case 2: return launch_mma<2>(DECODE_ARGS);
      case 3: return launch_mma<3>(DECODE_ARGS);
      case 4: return launch_mma<4>(DECODE_ARGS);
      case 5: return launch_mma<5>(DECODE_ARGS);
      case 6: return launch_mma<6>(DECODE_ARGS);
      case 7: return launch_mma<7>(DECODE_ARGS);
      case 8: return launch_mma<8>(DECODE_ARGS);
      case 9: return launch_mma<9>(DECODE_ARGS);
      case 10: return launch_mma<10>(DECODE_ARGS);
      case 11: return launch_mma<11>(DECODE_ARGS);
      case 12: return launch_mma<12>(DECODE_ARGS);
      case 13: return launch_mma<13>(DECODE_ARGS);
      case 14: return launch_mma<14>(DECODE_ARGS);
      case 15: return launch_mma<15>(DECODE_ARGS);
      case 16: return launch_mma<16>(DECODE_ARGS);
      default: return cudaErrorInvalidValue;
    }
  }
  const int smem = fma_smem_bytes(hq / hkv, d);
  static attn::SmemLimit limit;
  const cudaError_t err = limit.allow(
      reinterpret_cast<const void*>(decode_fma_kernel), smem);
  if (err != cudaSuccess) return err;
  decode_fma_kernel<<<dim3(n_split, hkv, b), THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), part, lse,
      lengths, length_all, st, hq, hkv, s_len, d, chunk, scale);
  return cudaGetLastError();
}

#undef DECODE_ARGS

}  // namespace

// strides: 6 element strides, (batch, head, position) for the k cache and
// then the v cache. lengths: B int32 on the device, or null to use
// length_all for every row. The cache is split into n_split chunks of
// `chunk` positions (a multiple of 64), n_split <= 1024; with n_split > 1,
// part is the f32 scratch [B, Hq, n_split, D + 2]. lse: null, or [B, Hq]
// f32 for each head's log softmax sum. o_f32: 1 for an f32 output from
// bf16 inputs. Needs D % 8 == 0,
// (hq / hkv) * d <= 4096, D <= 256, and q and cache pointers and strides
// 16-byte aligned (the wrapper checks). bf16:
// 0 for float32 q / caches / output, 1 for bfloat16. Launches the split
// kernel and, with more than one split, the combine on the same stream;
// returns the first cudaGetLastError() that is not cudaSuccess.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                void* o, float* part, float* lse,
                                const int* lengths,
                                int length_all, const long long* strides,
                                int b, int hq, int hkv, int s_len, int d,
                                int chunk, int n_split, float scale,
                                int bf16, int o_f32, void* stream) {
  if ((hq / hkv) * d > MAX_GROUP_WIDTH || d > 256 || d % 8 || chunk % 64
      || n_split < 1 || n_split > MAX_SPLITS
      || (n_split > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{strides[0], strides[1], strides[2], strides[3],
                   strides[4], strides[5]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_split(q, k, v, o, part, lse, lengths, length_all,
                                 st, b, hq, hkv, s_len, d, chunk, n_split,
                                 scale, bf16, o_f32, s);
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  if (bf16 && !o_f32)
    decode_combine_kernel<__nv_bfloat16><<<dim3(hq, b), THREADS, 0, s>>>(
        part, static_cast<__nv_bfloat16*>(o), lse, hq, d, n_split);
  else
    decode_combine_kernel<float><<<dim3(hq, b), THREADS, 0, s>>>(
        part, static_cast<float*>(o), lse, hq, d, n_split);
  return static_cast<int>(cudaGetLastError());
}
