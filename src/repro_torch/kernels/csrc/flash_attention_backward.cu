// flash_attention_backward: the gradients of flash_attention.cu's bf16
// forward, FlashAttention-2 style, on the tensor cores.
//
// Replaces no TPU kernel: the reference's Pallas flash_attention has no
// backward, and the reference trains over plain jnp. It was added because
// the plain backward (kernels/flash_attention.py, f32 chunks of query rows
// differentiated by autograd: 1 GiB f32 score chunks, f32 SIMT and f32
// GEMMs, softmax-backward passes) took 61% of an h2o-danube-1.8b training
// step on an H100 (PERF.md).
//
// Given q, k, v, the forward's output o and its per-row log-sum-exp lse
// (flash_attention.cu writes it when asked), and dO:
//   delta = rowsum(dO o)                               (flash_bwd_delta_kernel)
//   P = exp(s - lse), s = q k^T D^-0.5 under the mask
//   dV = P^T dO,  dS = P (dO V^T - delta),
//   dK = dS^T q D^-0.5,  dQ = dS k D^-0.5              (flash_bwd_kernel)
//   dQ's f32 sum -> bf16 in q's layout                 (flash_bwd_dq_kernel)
// with the same mask as the forward (causal kpos <= qpos, window kpos >
// qpos - window, positions from 0 for q and kv alike; any Sq, Sk). v, o,
// dO and dV may be narrower than q and k (Dv < D), as the forward takes
// them: latent attention's q.k over 192 columns with values 128 wide has
// an instance whose dP, dV and delta run at Dv.
//
// What bounds it: operations. The five products take 10 D FLOPs a (q, k)
// pair in the band; at an h2o-danube-1.8b training step (96 calls of B 2,
// Hq 32, Hkv 8, S 4096, D 80, causal) that is 4.1e13 FLOPs, 42 ms at
// 989 TFLOP/s of bf16. Bytes: q, k, v, o, dO read and dq, dk, dv written
// once, ~0.2 GB a call, 0.06 ms at 3.35 TB/s; dQ's f32 partial sums add
// 64 D floats of reductions to L2 a (q tile, k tile) pair.
//
// Design: one block per (64-row k tile, kv head, batch), longest tile first
// under a causal mask. K and V stay in shared memory for the block (and,
// for D <= 80, as A fragments in registers); the block walks the G q heads
// of its kv head and the 64-row q tiles that reach its k tile (tiles
// outside the causal / window band skipped, only edge tiles masked, as the
// forward does), with Q, dO, lse and delta double-buffered by 16-byte
// cp.async. Each warp owns 16 keys: it recomputes S^T = K Q^T (m16n8k16
// bf16 MMAs, f32 accumulators, the scale applied to the f32 scores as the
// forward does), P^T = exp2(S^T scale log2e - lse log2e), dP^T = V dO^T and
// dS^T = P^T (dP^T - delta), and accumulates dV += P^T dO and dK += dS^T Q
// in f32 registers, summed over the G heads, so GQA needs no reduction
// across blocks. dS^T goes to shared memory and each warp then takes 16 q
// rows of dQ += dS K, added into an f32 scratch with 8-byte atomic adds
// (reductions in L2), in whatever order the blocks finish: dQ's last bits,
// and so a bf16 training step, are not bit-reproducible from run to run.
// P and dS enter the products as bf16 hi + lo (x - hi) pairs, as the
// forward's P V does: rounded to bf16 alone they are off by up to 2^-9
// relative, against ~2^-17 for the pair, which keeps the
// gradients at the plain path's precision. That makes 8 products a pair
// instead of 5. Past D 80 the f32 accumulators of dK and dV (16 D / 32
// floats a thread each) leave no room: the KS 8 and 16 instances (D 88 to
// 256) split them over two warps a 16-key group (8 warps a block), each
// pair recomputing S and dP and each warp keeping half of D.
//
// Open: wgmma with TMA and warp specialisation (a producer warp, consumer
// warpgroups, dQ reduced by TMA), which mma.sync cannot reach; for D = 80
// TMA's 128-byte swizzle needs the row split into 64 + 16 boxes or padded
// to 96 / 128; P and dS rounded to bf16 alone (5 products a pair) only
// where the precision allows.
#include "attention_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;            // q rows a tile
constexpr int BK = 64;            // keys a block
constexpr int LDS = BQ + 8;       // row stride of the dS^T tiles
constexpr float LOG2E = 1.4426950408889634f;

// (batch, head, position) element strides of each operand
struct Strides {
  long long q[3], k[3], v[3], o[3], g[3], dq[3], dk[3], dv[3];
};

__host__ __device__ constexpr int bwd_ld(int ks) { return 16 * ks + 8; }

__host__ __device__ constexpr int bwd_smem_bytes(int ks, int kv) {
  // K and Q in two stages at rows of bwd_ld(ks); V and dO in two stages at
  // rows of bwd_ld(kv); dS^T hi and lo; lse and delta, 2 stages
  return (BK + 2 * BQ) * (bwd_ld(ks) + bwd_ld(kv)) * 2 + 2 * BK * LDS * 2
         + 4 * BQ * 4;
}

// Copy rows [row0, row0 + 64) of a [S, d] operand (row stride `stride`)
// into a shared tile of row stride LD; rows at or past `limit` are
// zero-filled. d / 8 chunks of 16 bytes a row.
template <int LD, int THREADS>
__device__ __forceinline__ void copy_tile(bf16* dst, const bf16* src,
                                          long long stride, int row0,
                                          int limit, int chunks, int tid) {
  for (int e = tid; e < 64 * chunks; e += THREADS) {
    const int r = e / chunks, c = e % chunks;
    const bool in = row0 + r < limit;
    attn::cp_async16(dst + r * LD + c * 8,
                     src + (in ? (row0 + r) * stride : 0) + c * 8, in);
  }
}

// Columns [width, padded) of `rows` rows (row stride ld) of a shared tile
// set to zero; width and padded multiples of 8.
template <int THREADS>
__device__ __forceinline__ void zero_cols(bf16* t, int rows, int ld,
                                          int width, int padded, int tid) {
  const int pad = (padded - width) / 8;
  for (int e = tid; e < rows * pad; e += THREADS)
    *reinterpret_cast<uint4*>(t + (e / pad) * ld + width + (e % pad) * 8) =
        make_uint4(0, 0, 0, 0);
}

// delta[b, h, s] = sum_d dO[b, h, s, d] o[b, h, s, d] in f32 (d: o's and
// dO's width, Dv), 0 for s in [sq, ldl). 8 lanes a row, 16-byte loads.
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const bf16* __restrict__ o,
                       const bf16* __restrict__ dout,
                       float* __restrict__ delta, Strides st, int hq, int sq,
                       int ldl, int d, long long rows) {
  const long long row = blockIdx.x * 32LL + threadIdx.x / 8;
  const int sub = threadIdx.x % 8;
  const int s = static_cast<int>(row % ldl);
  const long long bh = row / ldl;
  const int h = static_cast<int>(bh % hq), b = static_cast<int>(bh / hq);
  float acc = 0.f;
  if (row < rows && s < sq) {
    const bf16* op = o + b * st.o[0] + h * st.o[1] + s * st.o[2];
    const bf16* gp = dout + b * st.g[0] + h * st.g[1] + s * st.g[2];
    for (int c = sub * 8; c < d; c += 64) {
      const uint4 a = *reinterpret_cast<const uint4*>(op + c);
      const uint4 g = *reinterpret_cast<const uint4*>(gp + c);
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = __bfloat1622float2(a2[e]);
        const float2 y = __bfloat1622float2(g2[e]);
        acc = fmaf(x.x, y.x, acc);
        acc = fmaf(x.y, y.y, acc);
      }
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  if (row < rows && sub == 0) delta[row] = acc;
}

// dq = dq_acc * scale as bf16 in q's layout; dq_acc is [b, hq, sq, d] f32.
// A thread takes 8 columns of a row.
__global__ void __launch_bounds__(256)
flash_bwd_dq_kernel(const float* __restrict__ acc, bf16* __restrict__ dq,
                    Strides st, int hq, int sq, int d, float scale,
                    long long n) {
  const long long i = blockIdx.x * 256LL + threadIdx.x;
  if (i >= n) return;
  const int chunks = d / 8;
  const long long row = i / chunks;
  const int c = static_cast<int>(i % chunks) * 8;
  const int s = static_cast<int>(row % sq);
  const long long bh = row / sq;
  const int h = static_cast<int>(bh % hq), b = static_cast<int>(bh / hq);
  const float4 x = *reinterpret_cast<const float4*>(acc + row * d + c);
  const float4 y = *reinterpret_cast<const float4*>(acc + row * d + c + 4);
  const uint4 out = make_uint4(attn::pack_bf16(x.x * scale, x.y * scale),
                               attn::pack_bf16(x.z * scale, x.w * scale),
                               attn::pack_bf16(y.x * scale, y.y * scale),
                               attn::pack_bf16(y.z * scale, y.w * scale));
  *reinterpret_cast<uint4*>(dq + b * st.dq[0] + h * st.dq[1] + s * st.dq[2]
                            + c) = out;
}

// KS = ceil(D / 16) rounded up to an instance; WN warps share a 16-key
// group, each keeping 2 KS / WN of the 2 KS n8 column tiles of dK and dV.
template <int KS, int WN>
__global__ void __launch_bounds__(128 * WN, WN == 1 ? 2 : 1)
flash_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq_acc,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, Strides st,
                 int hq, int hkv, int sq, int sk, int d, int ldl, int causal,
                 int window, float scale) {
  constexpr int THREADS = 128 * WN;
  constexpr int DP = 16 * KS;
  constexpr int LD = bwd_ld(KS);
  constexpr int NTW = 2 * KS / WN;      // n8 column tiles a warp keeps
  constexpr int KSW = KS / WN;          // their k16 groups
  constexpr bool KVREG = KS <= 5;       // K and V A fragments in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);   // [BK][LD]
  bf16* vs = ks + BK * LD;                        // [BK][LD]
  bf16* qs = vs + BK * LD;                        // [2][BQ][LD]
  bf16* gs = qs + 2 * BQ * LD;                    // [2][BQ][LD] (dO)
  bf16* dsh = gs + 2 * BQ * LD;                   // [BK][LDS] dS^T hi
  bf16* dsl = dsh + BK * LDS;                     // [BK][LDS] dS^T lo
  float* ls = reinterpret_cast<float*>(dsl + BK * LDS);   // [2][BQ] lse
  float* es = ls + 2 * BQ;                                // [2][BQ] delta

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wr = warp % 4, wc = warp / 4;   // 16-key group, column part
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * BK;            // the longest tiles first
  const int G = hq / hkv;
  const bf16* kp = k + b * st.k[0] + kvh * st.k[1];
  const bf16* vp = v + b * st.v[0] + kvh * st.v[1];
  const int chunks = d / 8;

  // columns [d, DP) of every bf16 tile but dS: zero, never written again
  const int pad = (DP - d) / 8;
  for (int e = tid; e < (2 * BK + 4 * BQ) * pad; e += THREADS)
    *reinterpret_cast<uint4*>(ks + (e / pad) * LD + d + (e % pad) * 8) =
        make_uint4(0, 0, 0, 0);

  // q tiles reaching this k tile: q >= k0 if causal, q < k_last + window
  const int k_last = min(k0 + BK, sk) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(sq - 1, k_last + window - 1) : sq - 1;
  const int t0 = q_lo / BQ;
  const int nt = q_lo <= q_hi ? q_hi / BQ - t0 + 1 : 0;
  const int n_it = G * nt;

  auto stage = [&](int it) {
    const int h = kvh * G + it / nt;
    const int q0 = (t0 + it % nt) * BQ;
    const int sb = it & 1;
    copy_tile<LD, THREADS>(qs + sb * BQ * LD, q + b * st.q[0] + h * st.q[1],
                           st.q[2], q0, sq, chunks, tid);
    copy_tile<LD, THREADS>(gs + sb * BQ * LD,
                           dout + b * st.g[0] + h * st.g[1], st.g[2], q0, sq,
                           chunks, tid);
    const long long row = (static_cast<long long>(b) * hq + h) * ldl + q0;
    if (tid < 16)
      attn::cp_async16(ls + sb * BQ + tid * 4, lse + row + tid * 4, true);
    else if (tid < 32)
      attn::cp_async16(es + sb * BQ + (tid - 16) * 4,
                       delta + row + (tid - 16) * 4, true);
  };

  if (n_it > 0) {
    copy_tile<LD, THREADS>(ks, kp, st.k[2], k0, sk, chunks, tid);
    copy_tile<LD, THREADS>(vs, vp, st.v[2], k0, sk, chunks, tid);
    stage(0);
  }
  attn::cp_async_commit();

  uint32_t kf[KVREG ? KS : 1][4], vf[KVREG ? KS : 1][4];
  float dka[NTW][4], dva[NTW][4];
#pragma unroll
  for (int n = 0; n < NTW; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) dka[n][r] = dva[n][r] = 0.f;
  // this thread's keys: rows g and g + 8 of the warp's 16
  const int key_a = k0 + wr * 16 + lane / 4;
  const float scale_log2 = scale * LOG2E;

  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) stage(it + 1);
    attn::cp_async_commit();
    attn::cp_async_wait<1>();   // stage it (and K, V) landed
    __syncthreads();            // ... for every thread; dS^T read by all
    const int sb = it & 1;
    const int h = kvh * G + it / nt;
    const int q0 = (t0 + it % nt) * BQ;
    const bf16* qt = qs + sb * BQ * LD;
    const bf16* gt = gs + sb * BQ * LD;
    const float* lt = ls + sb * BQ;
    const float* et = es + sb * BQ;
    if constexpr (KVREG) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          const int off = (wr * 16 + lane % 16) * LD + kk * 16
                          + (lane / 16) * 8;
          attn::ldmatrix_x4(kf[kk], ks + off);
          attn::ldmatrix_x4(vf[kk], vs + off);
        }
      }
    }

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x 64 q a warp, 8 n8 tiles
    float s[8][4], p[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[j][r] = p[j][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ka[4], va[4];
      if constexpr (KVREG) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          ka[r] = kf[kk][r];
          va[r] = vf[kk][r];
        }
      } else {
        const int off = (wr * 16 + lane % 16) * LD + kk * 16
                        + (lane / 16) * 8;
        attn::ldmatrix_x4(ka, ks + off);
        attn::ldmatrix_x4(va, vs + off);
      }
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        const int off = (jp * 16 + lane % 8 + (lane / 16) * 8) * LD
                        + kk * 16 + ((lane / 8) % 2) * 8;
        uint32_t qb[4], gb[4];
        attn::ldmatrix_x4(qb, qt + off);
        attn::ldmatrix_x4(gb, gt + off);
        attn::mma_bf16(s[2 * jp], ka, qb[0], qb[1]);
        attn::mma_bf16(s[2 * jp + 1], ka, qb[2], qb[3]);
        attn::mma_bf16(p[2 * jp], va, gb[0], gb[1]);
        attn::mma_bf16(p[2 * jp + 1], va, gb[2], gb[3]);
      }
    }

    // P^T into s, dS^T into p; columns are q rows, rows keys
    const bool need_mask = k0 + BK > sk || q0 + BQ > sq
                           || (causal && k0 + BK - 1 > q0)
                           || (window > 0 && k0 <= q0 + BQ - 1 - window);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j * 8 + 2 * (lane % 4);
      const float2 l2 = *reinterpret_cast<const float2*>(lt + col);
      const float2 e2 = *reinterpret_cast<const float2*>(et + col);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float lv = (r & 1) ? l2.y : l2.x;
        const float ev = (r & 1) ? e2.y : e2.x;
        float pr = exp2f(fmaf(s[j][r], scale_log2, -lv * LOG2E));
        if (need_mask) {
          const int kpos = key_a + (r / 2) * 8;
          const int qpos = q0 + col + (r & 1);
          bool ok = kpos < sk && qpos < sq;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
          if (!ok) pr = 0.f;
        }
        s[j][r] = pr;
        p[j][r] = pr * (p[j][r] - ev);
      }
    }

    // dV += P^T dO and dK += dS^T Q, the A operand as bf16 hi + lo; q rows
    // 16 kk .. 16 kk + 15 a step. dS^T's hi and lo go to shared memory.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ph[4], pl[4], dh[4], dl[4];
      attn::split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      attn::split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      attn::split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      attn::split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
      attn::split_bf16(p[2 * kk][0], p[2 * kk][1], dh[0], dl[0]);
      attn::split_bf16(p[2 * kk][2], p[2 * kk][3], dh[1], dl[1]);
      attn::split_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1], dh[2], dl[2]);
      attn::split_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3], dh[3], dl[3]);
      if (wc == 0) {
        const int r0 = (wr * 16 + lane / 4) * LDS + kk * 16 + 2 * (lane % 4);
        const int at[4] = {r0, r0 + 8 * LDS, r0 + 8, r0 + 8 * LDS + 8};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          *reinterpret_cast<uint32_t*>(dsh + at[i]) = dh[i];
          *reinterpret_cast<uint32_t*>(dsl + at[i]) = dl[i];
        }
      }
#pragma unroll
      for (int dp = 0; dp < KSW; ++dp) {
        const int off = (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD
                        + (wc * KSW + dp) * 16 + (lane / 16) * 8;
        uint32_t gb[4], qb[4];
        attn::ldmatrix_x4_trans(gb, gt + off);
        attn::ldmatrix_x4_trans(qb, qt + off);
        attn::mma_bf16(dva[2 * dp], ph, gb[0], gb[1]);
        attn::mma_bf16(dva[2 * dp], pl, gb[0], gb[1]);
        attn::mma_bf16(dva[2 * dp + 1], ph, gb[2], gb[3]);
        attn::mma_bf16(dva[2 * dp + 1], pl, gb[2], gb[3]);
        attn::mma_bf16(dka[2 * dp], dh, qb[0], qb[1]);
        attn::mma_bf16(dka[2 * dp], dl, qb[0], qb[1]);
        attn::mma_bf16(dka[2 * dp + 1], dh, qb[2], qb[3]);
        attn::mma_bf16(dka[2 * dp + 1], dl, qb[2], qb[3]);
      }
    }
    __syncthreads();   // dS^T whole; stage sb no longer read

    // dQ[16 q rows of this warp] += dS K over the block's 64 keys, hi + lo
    float qa[NTW][4];
#pragma unroll
    for (int n = 0; n < NTW; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) qa[n][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int aoff = (kk * 16 + (lane / 16) * 8 + lane % 8) * LDS
                       + wr * 16 + ((lane / 8) % 2) * 8;
      uint32_t ah[4], al[4];
      attn::ldmatrix_x4_trans(ah, dsh + aoff);
      attn::ldmatrix_x4_trans(al, dsl + aoff);
#pragma unroll
      for (int dp = 0; dp < KSW; ++dp) {
        uint32_t kb[4];
        attn::ldmatrix_x4_trans(
            kb, ks + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD
                    + (wc * KSW + dp) * 16 + (lane / 16) * 8);
        attn::mma_bf16(qa[2 * dp], ah, kb[0], kb[1]);
        attn::mma_bf16(qa[2 * dp], al, kb[0], kb[1]);
        attn::mma_bf16(qa[2 * dp + 1], ah, kb[2], kb[3]);
        attn::mma_bf16(qa[2 * dp + 1], al, kb[2], kb[3]);
      }
    }
    float* qrow = dq_acc + ((static_cast<long long>(b) * hq + h) * sq) * d;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int qpos = q0 + wr * 16 + lane / 4 + hr * 8;
      if (qpos < sq) {
#pragma unroll
        for (int n = 0; n < NTW; ++n) {
          const int col = (wc * NTW + n) * 8 + 2 * (lane % 4);
          if (col < d)
            atomicAdd(reinterpret_cast<float2*>(
                          qrow + static_cast<long long>(qpos) * d + col),
                      make_float2(qa[n][2 * hr], qa[n][2 * hr + 1]));
        }
      }
    }
  }
  attn::cp_async_wait<0>();

  // dK (scaled) and dV as bf16 into k's and v's layouts
  bf16* dkp = dk + b * st.dk[0] + kvh * st.dk[1];
  bf16* dvp = dv + b * st.dv[0] + kvh * st.dv[1];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int kpos = key_a + hr * 8;
    if (kpos >= sk) continue;
#pragma unroll
    for (int n = 0; n < NTW; ++n) {
      const int col = (wc * NTW + n) * 8 + 2 * (lane % 4);
      if (col < d) {
        *reinterpret_cast<uint32_t*>(dkp + kpos * st.dk[2] + col) =
            attn::pack_bf16(dka[n][2 * hr] * scale,
                            dka[n][2 * hr + 1] * scale);
        *reinterpret_cast<uint32_t*>(dvp + kpos * st.dv[2] + col) =
            attn::pack_bf16(dva[n][2 * hr], dva[n][2 * hr + 1]);
      }
    }
  }
}

// flash_bwd_kernel with values narrower than q and k (KV = ceil(Dv / 16)
// below KS): dP^T = V dO^T, dV and the V and dO tiles at Dv, S^T, dK and
// dQ at D. A kernel of its own, so that the equal-width instances above
// compile as they did; K and V are read from shared memory at each step
// (KS + KV fragments do not fit in registers beside the accumulators).
template <int KS, int KV, int WN>
__global__ void __launch_bounds__(128 * WN, WN == 1 ? 2 : 1)
flash_bwd_dv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq_acc,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, Strides st,
                 int hq, int hkv, int sq, int sk, int d, int d_v, int ldl,
                 int causal, int window, float scale) {
  constexpr int THREADS = 128 * WN;
  constexpr int DP = 16 * KS, DPV = 16 * KV;
  constexpr int LD = bwd_ld(KS), LDV = bwd_ld(KV);
  constexpr int NTW = 2 * KS / WN;      // n8 column tiles of dK a warp keeps
  constexpr int KSW = KS / WN;          // their k16 groups
  constexpr int NTV = 2 * KV / WN;      // ... of dV
  constexpr int KVW = KV / WN;
  constexpr int KMAX = KS > KV ? KS : KV;
  constexpr int KWMAX = KSW > KVW ? KSW : KVW;
  constexpr int NMAX = NTW > NTV ? NTW : NTV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);   // [BK][LD]
  bf16* vs = ks + BK * LD;                        // [BK][LDV]
  bf16* qs = vs + BK * LDV;                       // [2][BQ][LD]
  bf16* gs = qs + 2 * BQ * LD;                    // [2][BQ][LDV] (dO)
  bf16* dsh = gs + 2 * BQ * LDV;                  // [BK][LDS] dS^T hi
  bf16* dsl = dsh + BK * LDS;                     // [BK][LDS] dS^T lo
  float* ls = reinterpret_cast<float*>(dsl + BK * LDS);   // [2][BQ] lse
  float* es = ls + 2 * BQ;                                // [2][BQ] delta

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wr = warp % 4, wc = warp / 4;   // 16-key group, column part
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * BK;            // the longest tiles first
  const int G = hq / hkv;
  const bf16* kp = k + b * st.k[0] + kvh * st.k[1];
  const bf16* vp = v + b * st.v[0] + kvh * st.v[1];
  const int chunks = d / 8, chunks_v = d_v / 8;

  // columns [d, DP) of the K and Q tiles and [d_v, DPV) of the V and dO
  // tiles: zero, never written again
  zero_cols<THREADS>(ks, BK, LD, d, DP, tid);
  zero_cols<THREADS>(vs, BK, LDV, d_v, DPV, tid);
  zero_cols<THREADS>(qs, 2 * BQ, LD, d, DP, tid);
  zero_cols<THREADS>(gs, 2 * BQ, LDV, d_v, DPV, tid);

  // q tiles reaching this k tile: q >= k0 if causal, q < k_last + window
  const int k_last = min(k0 + BK, sk) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(sq - 1, k_last + window - 1) : sq - 1;
  const int t0 = q_lo / BQ;
  const int nt = q_lo <= q_hi ? q_hi / BQ - t0 + 1 : 0;
  const int n_it = G * nt;

  auto stage = [&](int it) {
    const int h = kvh * G + it / nt;
    const int q0 = (t0 + it % nt) * BQ;
    const int sb = it & 1;
    copy_tile<LD, THREADS>(qs + sb * BQ * LD, q + b * st.q[0] + h * st.q[1],
                           st.q[2], q0, sq, chunks, tid);
    copy_tile<LDV, THREADS>(gs + sb * BQ * LDV,
                            dout + b * st.g[0] + h * st.g[1], st.g[2], q0, sq,
                            chunks_v, tid);
    const long long row = (static_cast<long long>(b) * hq + h) * ldl + q0;
    if (tid < 16)
      attn::cp_async16(ls + sb * BQ + tid * 4, lse + row + tid * 4, true);
    else if (tid < 32)
      attn::cp_async16(es + sb * BQ + (tid - 16) * 4,
                       delta + row + (tid - 16) * 4, true);
  };

  if (n_it > 0) {
    copy_tile<LD, THREADS>(ks, kp, st.k[2], k0, sk, chunks, tid);
    copy_tile<LDV, THREADS>(vs, vp, st.v[2], k0, sk, chunks_v, tid);
    stage(0);
  }
  attn::cp_async_commit();

  float dka[NTW][4], dva[NTV][4];
#pragma unroll
  for (int n = 0; n < NMAX; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (n < NTW) dka[n][r] = 0.f;
      if (n < NTV) dva[n][r] = 0.f;
    }
  // this thread's keys: rows g and g + 8 of the warp's 16
  const int key_a = k0 + wr * 16 + lane / 4;
  const float scale_log2 = scale * LOG2E;

  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) stage(it + 1);
    attn::cp_async_commit();
    attn::cp_async_wait<1>();   // stage it (and K, V) landed
    __syncthreads();            // ... for every thread; dS^T read by all
    const int sb = it & 1;
    const int h = kvh * G + it / nt;
    const int q0 = (t0 + it % nt) * BQ;
    const bf16* qt = qs + sb * BQ * LD;
    const bf16* gt = gs + sb * BQ * LDV;
    const float* lt = ls + sb * BQ;
    const float* et = es + sb * BQ;
    // S^T = K Q^T and dP^T = V dO^T: 16 keys x 64 q a warp, 8 n8 tiles
    float s[8][4], p[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[j][r] = p[j][r] = 0.f;
    // (k16 groups past KS or KV fall away at compile time)
#pragma unroll
    for (int kk = 0; kk < KMAX; ++kk) {
      uint32_t ka[4], va[4];
      const int ko = (wr * 16 + lane % 16) * LD + kk * 16 + (lane / 16) * 8;
      const int vo = (wr * 16 + lane % 16) * LDV + kk * 16 + (lane / 16) * 8;
      if (kk < KS) attn::ldmatrix_x4(ka, ks + ko);
      if (kk < KV) attn::ldmatrix_x4(va, vs + vo);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        const int off = (jp * 16 + lane % 8 + (lane / 16) * 8) * LD
                        + kk * 16 + ((lane / 8) % 2) * 8;
        const int offv = (jp * 16 + lane % 8 + (lane / 16) * 8) * LDV
                         + kk * 16 + ((lane / 8) % 2) * 8;
        uint32_t qb[4], gb[4];
        if (kk < KS) attn::ldmatrix_x4(qb, qt + off);
        if (kk < KV) attn::ldmatrix_x4(gb, gt + offv);
        if (kk < KS) {
          attn::mma_bf16(s[2 * jp], ka, qb[0], qb[1]);
          attn::mma_bf16(s[2 * jp + 1], ka, qb[2], qb[3]);
        }
        if (kk < KV) {
          attn::mma_bf16(p[2 * jp], va, gb[0], gb[1]);
          attn::mma_bf16(p[2 * jp + 1], va, gb[2], gb[3]);
        }
      }
    }

    // P^T into s, dS^T into p; columns are q rows, rows keys
    const bool need_mask = k0 + BK > sk || q0 + BQ > sq
                           || (causal && k0 + BK - 1 > q0)
                           || (window > 0 && k0 <= q0 + BQ - 1 - window);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j * 8 + 2 * (lane % 4);
      const float2 l2 = *reinterpret_cast<const float2*>(lt + col);
      const float2 e2 = *reinterpret_cast<const float2*>(et + col);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float lv = (r & 1) ? l2.y : l2.x;
        const float ev = (r & 1) ? e2.y : e2.x;
        float pr = exp2f(fmaf(s[j][r], scale_log2, -lv * LOG2E));
        if (need_mask) {
          const int kpos = key_a + (r / 2) * 8;
          const int qpos = q0 + col + (r & 1);
          bool ok = kpos < sk && qpos < sq;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
          if (!ok) pr = 0.f;
        }
        s[j][r] = pr;
        p[j][r] = pr * (p[j][r] - ev);
      }
    }

    // dV += P^T dO and dK += dS^T Q, the A operand as bf16 hi + lo; q rows
    // 16 kk .. 16 kk + 15 a step. dS^T's hi and lo go to shared memory.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ph[4], pl[4], dh[4], dl[4];
      attn::split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      attn::split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      attn::split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      attn::split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
      attn::split_bf16(p[2 * kk][0], p[2 * kk][1], dh[0], dl[0]);
      attn::split_bf16(p[2 * kk][2], p[2 * kk][3], dh[1], dl[1]);
      attn::split_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1], dh[2], dl[2]);
      attn::split_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3], dh[3], dl[3]);
      if (wc == 0) {
        const int r0 = (wr * 16 + lane / 4) * LDS + kk * 16 + 2 * (lane % 4);
        const int at[4] = {r0, r0 + 8 * LDS, r0 + 8, r0 + 8 * LDS + 8};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          *reinterpret_cast<uint32_t*>(dsh + at[i]) = dh[i];
          *reinterpret_cast<uint32_t*>(dsl + at[i]) = dl[i];
        }
      }
#pragma unroll
      for (int dp = 0; dp < KWMAX; ++dp) {
        const int offv = (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LDV
                         + (wc * KVW + dp) * 16 + (lane / 16) * 8;
        const int off = (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD
                        + (wc * KSW + dp) * 16 + (lane / 16) * 8;
        uint32_t gb[4], qb[4];
        if (dp < KVW) attn::ldmatrix_x4_trans(gb, gt + offv);
        if (dp < KSW) attn::ldmatrix_x4_trans(qb, qt + off);
        if (dp < KVW) {
          attn::mma_bf16(dva[2 * dp], ph, gb[0], gb[1]);
          attn::mma_bf16(dva[2 * dp], pl, gb[0], gb[1]);
          attn::mma_bf16(dva[2 * dp + 1], ph, gb[2], gb[3]);
          attn::mma_bf16(dva[2 * dp + 1], pl, gb[2], gb[3]);
        }
        if (dp < KSW) {
          attn::mma_bf16(dka[2 * dp], dh, qb[0], qb[1]);
          attn::mma_bf16(dka[2 * dp], dl, qb[0], qb[1]);
          attn::mma_bf16(dka[2 * dp + 1], dh, qb[2], qb[3]);
          attn::mma_bf16(dka[2 * dp + 1], dl, qb[2], qb[3]);
        }
      }
    }
    __syncthreads();   // dS^T whole; stage sb no longer read

    // dQ[16 q rows of this warp] += dS K over the block's 64 keys, hi + lo
    float qa[NTW][4];
#pragma unroll
    for (int n = 0; n < NTW; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) qa[n][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int aoff = (kk * 16 + (lane / 16) * 8 + lane % 8) * LDS
                       + wr * 16 + ((lane / 8) % 2) * 8;
      uint32_t ah[4], al[4];
      attn::ldmatrix_x4_trans(ah, dsh + aoff);
      attn::ldmatrix_x4_trans(al, dsl + aoff);
#pragma unroll
      for (int dp = 0; dp < KSW; ++dp) {
        uint32_t kb[4];
        attn::ldmatrix_x4_trans(
            kb, ks + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * LD
                    + (wc * KSW + dp) * 16 + (lane / 16) * 8);
        attn::mma_bf16(qa[2 * dp], ah, kb[0], kb[1]);
        attn::mma_bf16(qa[2 * dp], al, kb[0], kb[1]);
        attn::mma_bf16(qa[2 * dp + 1], ah, kb[2], kb[3]);
        attn::mma_bf16(qa[2 * dp + 1], al, kb[2], kb[3]);
      }
    }
    float* qrow = dq_acc + ((static_cast<long long>(b) * hq + h) * sq) * d;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int qpos = q0 + wr * 16 + lane / 4 + hr * 8;
      if (qpos < sq) {
#pragma unroll
        for (int n = 0; n < NTW; ++n) {
          const int col = (wc * NTW + n) * 8 + 2 * (lane % 4);
          if (col < d)
            atomicAdd(reinterpret_cast<float2*>(
                          qrow + static_cast<long long>(qpos) * d + col),
                      make_float2(qa[n][2 * hr], qa[n][2 * hr + 1]));
        }
      }
    }
  }
  attn::cp_async_wait<0>();

  // dK (scaled) and dV as bf16 into k's and v's layouts
  bf16* dkp = dk + b * st.dk[0] + kvh * st.dk[1];
  bf16* dvp = dv + b * st.dv[0] + kvh * st.dv[1];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int kpos = key_a + hr * 8;
    if (kpos >= sk) continue;
#pragma unroll
    for (int n = 0; n < NMAX; ++n) {
      const int col = (wc * NTW + n) * 8 + 2 * (lane % 4);
      const int col_v = (wc * NTV + n) * 8 + 2 * (lane % 4);
      if (n < NTW && col < d)
        *reinterpret_cast<uint32_t*>(dkp + kpos * st.dk[2] + col) =
            attn::pack_bf16(dka[n][2 * hr] * scale,
                            dka[n][2 * hr + 1] * scale);
      if (n < NTV && col_v < d_v)
        *reinterpret_cast<uint32_t*>(dvp + kpos * st.dv[2] + col_v) =
            attn::pack_bf16(dva[n][2 * hr], dva[n][2 * hr + 1]);
    }
  }
}

template <int KS, int WN, int KV = KS>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, float* dq_acc, void* dk,
               void* dv, const Strides& st, int b, int hq, int hkv, int sq,
               int sk, int d, int d_v, int ldl, int causal, int window,
               float scale, cudaStream_t stream) {
  constexpr int smem = bwd_smem_bytes(KS, KV);
  const void* kernel;
  if constexpr (KS == KV)
    kernel = reinterpret_cast<const void*>(flash_bwd_kernel<KS, WN>);
  else
    kernel = reinterpret_cast<const void*>(flash_bwd_dv_kernel<KS, KV, WN>);
  static attn::SmemLimit limit;
  const cudaError_t err = limit.allow(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(hkv, b, (sk + BK - 1) / BK);
  if constexpr (KS == KV)
    flash_bwd_kernel<KS, WN><<<grid, 128 * WN, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
        delta, dq_acc, static_cast<bf16*>(dk), static_cast<bf16*>(dv), st,
        hq, hkv, sq, sk, d, ldl, causal, window, scale);
  else
    flash_bwd_dv_kernel<KS, KV, WN><<<grid, 128 * WN, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
        delta, dq_acc, static_cast<bf16*>(dk), static_cast<bf16*>(dv), st,
        hq, hkv, sq, sk, d, d_v, ldl, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

#define BWD_ARGS                                                          \
  q, k, v, dout, lse, delta, dq_acc, dk, dv, st, b, hq, hkv, sq, sk, d, d_v, \
      ldl, causal, window, scale, s

int launch_main(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                float* dq_acc, void* dk, void* dv, const Strides& st, int b,
                int hq, int hkv, int sq, int sk, int d, int d_v, int ldl,
                int causal, int window, float scale, cudaStream_t s) {
  if (d_v != d) {
    // latent attention's q.k 192 (128 + 64 rope), values 128
    if ((d + 15) / 16 == 12 && (d_v + 15) / 16 == 8)
      return launch_bwd<12, 2, 8>(BWD_ARGS);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch ((d + 15) / 16) {
    case 1: case 2: return launch_bwd<2, 1>(BWD_ARGS);
    case 3: case 4: return launch_bwd<4, 1>(BWD_ARGS);
    case 5: return launch_bwd<5, 1>(BWD_ARGS);
    case 6: case 7: case 8: return launch_bwd<8, 2>(BWD_ARGS);
    case 9: case 10: case 11: case 12: case 13: case 14: case 15: case 16:
      return launch_bwd<16, 2>(BWD_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

#undef BWD_ARGS

}  // namespace

// The whole backward on `stream`: zero dq_acc, delta, the main kernel, dq.
// d: q's and k's head dim; d_v: v's, o's and dO's (d, or 128 beside a d of
// 192). q, k, v, o, dO bf16 as the forward took them (D % 8 == 0, D <= 256,
// pointers and strides 16-byte aligned, the last dim contiguous); lse the
// forward's float32 [b, hq, ldl] (ldl >= sq rounded up to 64); delta a
// float32 [b, hq, ldl] scratch; dq_acc a float32 [b, hq, sq, d] scratch;
// dq, dk, dv bf16 outputs (dq 16-byte aligned like q). strides: 24
// element strides, (batch, head, position) for q, k, v, o, dO, dq, dk, dv
// in that order. Returns the first CUDA error.
extern "C" int flash_attention_backward(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq_acc, void* dq,
    void* dk, void* dv, const long long* strides, int b, int hq, int hkv,
    int sq, int sk, int d, int d_v, int ldl, int causal, int window,
    float scale, void* stream) {
  if (d % 8 || d > 256 || d_v % 8 || d_v < 8 || d_v > d
      || ldl < (sq + BQ - 1) / BQ * BQ || ldl % BQ)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st;
  long long* dst[8] = {st.q, st.k, st.v, st.o, st.g, st.dq, st.dk, st.dv};
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 3; ++j) dst[i][j] = strides[3 * i + j];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      dq_acc, 0, sizeof(float) * static_cast<size_t>(b) * hq * sq * d, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(b) * hq * ldl;
  flash_bwd_delta_kernel<<<static_cast<unsigned>((rows + 31) / 32), 256, 0,
                           s>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<float*>(delta), st, hq, sq, ldl, d_v, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int e = launch_main(q, k, v, dout, static_cast<const float*>(lse),
                            static_cast<const float*>(delta),
                            static_cast<float*>(dq_acc), dk, dv, st, b, hq,
                            hkv, sq, sk, d, d_v, ldl, causal, window, scale,
                            s);
  if (e != 0) return e;
  const long long n = static_cast<long long>(b) * hq * sq * (d / 8);
  flash_bwd_dq_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(dq_acc), static_cast<bf16*>(dq), st, hq, sq,
      d, scale, n);
  return static_cast<int>(cudaGetLastError());
}
