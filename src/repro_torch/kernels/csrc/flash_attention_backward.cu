// flash_attention_backward: the gradients of flash_attention.cu's bf16
// forward on Hopper's tensor cores: warpgroup MMAs (wgmma) fed by TMA, a
// producer warpgroup, consumer warpgroups.
//
// Replaces no TPU kernel: the reference's Pallas flash_attention has no
// backward, and the reference trains over plain jnp. It was added because
// the plain backward (kernels/flash_attention.py, f32 chunks of query rows)
// took 61% of an h2o-danube-1.8b training step on an H100 (PERF.md).
//
// Given q, k, v, the forward's output o and its per-row log-sum-exp lse
// (flash_attention.cu writes it when asked), and dO:
//   delta = rowsum(dO o)                               (flash_bwd_delta_kernel)
//   P = exp(s - lse), s = q k^T D^-0.5 under the mask
//   dV = P^T dO,  dS = P (dO V^T - delta),
//   dK = dS^T q D^-0.5,  dQ = dS k D^-0.5              (flash_bwd_kernel)
//   dQ's f32 sum -> bf16 in q's layout             (flash_bwd_dq_tile_kernel)
// with the same mask as the forward (causal kpos <= qpos, window kpos >
// qpos - window, positions from 0 for q and kv alike; any Sq, Sk). v, o,
// dO and dV may be narrower than q and k (Dv < D): latent attention's q.k
// over 192 columns with values 128 wide runs dP, dV and delta at Dv.
//
// What bounds it: operations. The five products take 2 (3 D + 2 Dv) FLOPs
// a (q, k) pair in the band; P and dS enter dV, dK and dQ as bf16 hi + lo
// pairs (x - hi rounded again), as the forward's P V does: rounded to bf16
// alone they are off by up to 2^-9 relative, against ~2^-17 for the pair,
// which keeps the gradients at the plain path's precision. So the kernel
// runs eight products, 2 (5 D + 3 Dv) FLOPs a pair: at moonlight-train-8k's
// call (B 2, H 16, S 8192, (192, 128), causal) 2.9 ms at 989 TFLOP/s of
// bf16. Bytes (q, k, v, o, dO read and dq, dk, dv written once) are ~0.1 ms
// at 3.35 TB/s; dQ's f32 partial sums add 64 D floats of L2 reductions a
// (64-query tile, 128-key tile) pair.
//
// Design (FlashAttention-3's backward): one block per (128-key tile, kv
// head, batch), longest tile first under a causal mask, three warpgroups.
// The producer warpgroup keeps 24 registers a thread and gives the rest to
// the two consumer warpgroups (setmaxnreg: 240 each). Its first warp loads
// K and V once by TMA, then walks the G q heads of the kv head and the
// 64-row q tiles that reach the key tile (tiles outside the causal / window
// band skipped, only edge tiles masked), keeping TMA loads of Q, dO, lse
// and delta in flight in a ring of STAGES buffers guarded by mbarriers;
// TMA's out-of-bounds fill gives zeros past Sq, Sk, D and Dv. Each consumer
// warpgroup owns 64 keys and runs every product on wgmma:
//  - S^T = K Q^T and dP^T = V dO^T once for its keys (operands from shared
//    memory), P^T and dS^T in the f32 accumulators (the scale applied to
//    the f32 scores);
//  - dV += P^T dO and dK += dS^T Q with P^T and dS^T as hi + lo A operands
//    straight from the accumulator registers; dK and dV stay in f32
//    registers over the G heads, so GQA needs no reduction across blocks.
//    Where they leave too few registers for 64 columns of scores ((192,
//    128): 160 floats a thread), a tile's scores go in two passes of 32;
//  - dS^T (hi and lo) to shared memory once; each warpgroup then takes half
//    of dQ's columns, dQ = dS K over the block's 128 keys, and writes it
//    over dS^T's place as an f32 tile in its accumulators' order, which
//    the producer's second warp adds into the scratch's tile with one bulk
//    reduce-add, in whatever order the blocks finish: dQ's last bits, and
//    so a bf16 training step, are not bit-reproducible from run to run.
// The tile is 64 x padded D floats, contiguous in the scratch in the same
// order; flash_bwd_dq_tile_kernel reads it back into q's layout.
//
// Layouts: Q, dO and V arrive in strips of 64 columns under TMA's 128-byte
// swizzle where the padded width is a multiple of 64, else strips of 16
// under the 32-byte swizzle (D 80); the same tiles serve as K-major
// operands (S^T, dP^T) and as N-major ones (dV, dK). K comes in 8-column
// chunks without swizzle, so that each warpgroup's half of dQ's columns
// may start at any multiple of 8. dS^T is written [key][query] under the
// 128-byte swizzle, dQ's A operand read M-major.
//
// Widths: one instance per (padded D, padded Dv): (64, 64), (80, 80),
// (128, 128) and (192, 128). Past 128 equal widths need dK's and dV's
// accumulators (8 D floats a thread each) beside the scores, more than a
// thread's 240 registers: they keep the mma.sync kernel below
// (flash_bwd_mma_kernel<16, 2>: cp.async, 8 warps, each 16-key group in
// two warps that both recompute S and dP, dQ by f32 atomics into a [b, hq,
// sq, d] scratch, flash_bwd_dq_kernel), and
// flash_attention_backward_scratch_width says so.
//
// Two things the compiler needs, found by measuring: an mbarrier wait
// spins inside one PTX block (hopper.cuh), and the warpgroup roles are read
// through a shuffle; else ptxas keeps the consumers at the launch's 168
// registers and spills.
#include <cuda.h>

#include "attention_common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;            // q rows a tile
constexpr int BK = 64;            // keys a block (flash_bwd_mma_kernel)
constexpr int LDS = BQ + 8;       // row stride of its dS^T tiles
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

// dq = dq_acc * scale as bf16 in q's layout from flash_bwd_kernel's
// scratch: [b, hq, ldl / 64] tiles of 64 x dp floats in that kernel's
// accumulator order, 16-float units u = 32 c + g (column group c of 8, g =
// 8 warp + row in 8) whose float 4 t + 2 i + e is row 16 (g / 8) + g % 8 +
// 8 i, column 8 c + 2 t + e of the tile. A thread takes a unit: two rows of
// 8 columns.
__global__ void __launch_bounds__(256)
flash_bwd_dq_tile_kernel(const float* __restrict__ acc,
                         bf16* __restrict__ dq, Strides st, int hq, int sq,
                         int d, int dp, int ntiles, float scale,
                         long long units) {
  const long long u = blockIdx.x * 256LL + threadIdx.x;
  if (u >= units) return;
  const long long tile = u / (4 * dp);
  const int w = static_cast<int>(u % (4 * dp)), col = w / 32 * 8, g = w % 32;
  const int r0 = static_cast<int>(tile % ntiles) * BQ + 16 * (g / 8) + g % 8;
  if (col >= d || r0 >= sq) return;
  const long long bh = tile / ntiles;
  const int h = static_cast<int>(bh % hq), b = static_cast<int>(bh / hq);
  const float4* src = reinterpret_cast<const float4*>(acc + u * 16);
  const float4 v0 = src[0], v1 = src[1], v2 = src[2], v3 = src[3];
  bf16* out = dq + b * st.dq[0] + h * st.dq[1] + col;
  *reinterpret_cast<uint4*>(out + r0 * st.dq[2]) = make_uint4(
      attn::pack_bf16(v0.x * scale, v0.y * scale),
      attn::pack_bf16(v1.x * scale, v1.y * scale),
      attn::pack_bf16(v2.x * scale, v2.y * scale),
      attn::pack_bf16(v3.x * scale, v3.y * scale));
  if (r0 + 8 < sq)
    *reinterpret_cast<uint4*>(out + (r0 + 8) * st.dq[2]) = make_uint4(
        attn::pack_bf16(v0.z * scale, v0.w * scale),
        attn::pack_bf16(v1.z * scale, v1.w * scale),
        attn::pack_bf16(v2.z * scale, v2.w * scale),
        attn::pack_bf16(v3.z * scale, v3.w * scale));
}

// The Hopper kernel's tile of KS k16 groups of q.k columns and KV of value
// columns: sizes, the swizzle of each operand, and the shared-memory map
// (byte offsets from a 1024-aligned base).
template <int KS, int KV>
struct Tile {
  static constexpr int DP = 16 * KS, DPV = 16 * KV;   // padded D, Dv
  static constexpr int NWG = 2;                 // consumer warpgroups
  static constexpr int KEYS = 64 * NWG;         // keys a block
  static constexpr int THREADS = 128 * (NWG + 1);
  // passes over a q tile's 64 rows: two of 32 where dK's and dV's f32
  // accumulators (DP / 2 + DPV / 2 a thread) leave no room for 64 of
  // scores beside them in 240 registers
  static constexpr int PASSES = DP / 2 + DPV / 2 + 64 > 192 ? 2 : 1;
  // strip widths of the Q / dO and V tiles and their descriptor layouts
  static constexpr int WQ = DP % 64 == 0 ? 64 : 16;
  static constexpr int WV = DPV % 64 == 0 ? 64 : 16;
  static constexpr uint32_t LQ = WQ == 64 ? 1 : 3, LV = WV == 64 ? 1 : 3;
  static constexpr int DQN = DP / NWG;          // dQ columns a warpgroup
  static constexpr int KV_BYTES = KEYS * (DP + DPV) * 2;
  static constexpr int Q_BYTES = BQ * DP * 2, G_BYTES = BQ * DPV * 2;
  static constexpr int DS_BYTES = KEYS * BQ * 2;    // dS^T, hi or lo
  static constexpr int DQ_BYTES = BQ * DP * 4;      // a dQ tile, f32
  static constexpr int U_BYTES = 2 * DS_BYTES > DQ_BYTES ? 2 * DS_BYTES
                                                         : DQ_BYTES;
  // the Q, dO, lse, delta ring: three stages where they fit in 200 KB
  static constexpr int STAGES =
      KV_BYTES + 3 * (Q_BYTES + G_BYTES) + U_BYTES <= 200 * 1024 ? 3 : 2;
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = K_OFF + KEYS * DP * 2;
  static constexpr int Q_OFF = K_OFF + KV_BYTES;
  static constexpr int G_OFF = Q_OFF + STAGES * Q_BYTES;
  static constexpr int U_OFF = G_OFF + STAGES * G_BYTES;  // dS^T, then dQ
  static constexpr int L_OFF = U_OFF + U_BYTES;           // lse [STAGES][BQ]
  static constexpr int E_OFF = L_OFF + STAGES * BQ * 4;   // delta
  static constexpr int BAR_OFF = E_OFF + STAGES * BQ * 4;
  // full[STAGES], empty[STAGES], kv, dq_full, dq_empty; 1024 to align
  static constexpr int SMEM = BAR_OFF + 8 * (2 * STAGES + 3) + 1024;
  static_assert(SMEM <= 232448, "shared memory of the tile");
};

// One pass over NQ of a tile's 64 q rows (q0 + NQ hp ..) for warpgroup
// wg's 64 keys: S^T = K Q^T and dP^T = V dO^T on wgmma (K-major operands
// from shared memory), P^T and dS^T in the accumulators, dS^T's hi and lo
// to the shared [key][q] tile (rows of 128 bytes under the 128-byte
// swizzle), then dV += P^T dO and dK += dS^T Q issued with P^T and dS^T as
// A operands from registers. A pass that is not the last waits for its
// products, so that the next one reuses the registers. dq_empty (null on a
// block's first tile) guards the dS^T space.
template <typename T>
__device__ __forceinline__ void score_pass(
    int hp, int q0, int sq, int sk, int causal, int window, float scale_log2,
    int ww, int tq, int tr, int kw0, uint32_t k_a, uint32_t v_a, uint32_t qt,
    uint32_t gt, const float* lt, const float* et, unsigned char* ds_w,
    uint64_t* dq_empty, uint32_t dq_parity, float (&dka)[T::DP / 2],
    float (&dva)[T::DPV / 2]) {
  constexpr int NQ = BQ / T::PASSES;
  constexpr int KS = T::DP / 16, KV = T::DPV / 16;
  const int c0 = NQ * hp;               // first q column of the pass
  float sc[NQ / 2], dp[NQ / 2];
#pragma unroll
  for (int i = 0; i < NQ / 2; ++i) sc[i] = dp[i] = 0.f;
  hop::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    hop::WgmmaSS<NQ>::template run<0, 0>(
        sc, hop::desc(k_a, kk * 2 * T::KEYS * 16, T::KEYS * 16, 128, 0),
        hop::desc(qt, kk * 16 / T::WQ * BQ * T::WQ * 2 + kk * 16 % T::WQ * 2
                          + c0 * T::WQ * 2,
                  16, 16 * T::WQ, T::LQ),
        1);
#pragma unroll
  for (int kk = 0; kk < KV; ++kk)
    hop::WgmmaSS<NQ>::template run<0, 0>(
        dp, hop::desc(v_a, kk * 16 / T::WV * T::KEYS * T::WV * 2
                               + kk * 16 % T::WV * 2,
                      16, 16 * T::WV, T::LV),
        hop::desc(gt, kk * 16 / T::WV * BQ * T::WV * 2 + kk * 16 % T::WV * 2
                          + c0 * T::WV * 2,
                  16, 16 * T::WV, T::LV),
        1);
  hop::wgmma_commit();
  hop::wgmma_wait_all();
  hop::fence_regs(sc);
  hop::fence_regs(dp);

  // P^T into sc, dS^T into dp; columns are q rows, rows keys
  const int key_a = kw0 + 16 * ww + tr;   // this thread's keys: +0, +8
  const bool need_mask = kw0 + 64 > sk || q0 + BQ > sq
                         || (causal && kw0 + 63 > q0 + c0)
                         || (window > 0 && kw0 <= q0 + c0 + NQ - 1 - window);
#pragma unroll
  for (int j = 0; j < NQ / 8; ++j) {
    const int col = c0 + j * 8 + 2 * tq;
    const float2 l2 = *reinterpret_cast<const float2*>(lt + col);
    const float2 e2 = *reinterpret_cast<const float2*>(et + col);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int x = 4 * j + r;
      const float lv = (r & 1) ? l2.y : l2.x;
      const float ev = (r & 1) ? e2.y : e2.x;
      float pr = exp2f(fmaf(sc[x], scale_log2, -lv * LOG2E));
      if (need_mask) {
        const int kpos = key_a + (r / 2) * 8;
        const int qpos = q0 + col + (r & 1);
        bool ok = kpos < sk && qpos < sq;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        if (!ok) pr = 0.f;
      }
      sc[x] = pr;
      dp[x] = pr * (dp[x] - ev);
    }
  }

  // A fragments of P^T and dS^T for the pass's k16 groups of q rows, as
  // bf16 hi + lo; dS^T's also to shared memory, once the previous tile's
  // dQ, which the dS^T space held, has been read out
  if (hp == 0 && dq_empty != nullptr) hop::mbar_wait(dq_empty, dq_parity);
  uint32_t ph[NQ / 16][4], pl[NQ / 16][4], dh[NQ / 16][4], dl[NQ / 16][4];
#pragma unroll
  for (int kq = 0; kq < NQ / 16; ++kq)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      attn::split_bf16(sc[8 * kq + 2 * r], sc[8 * kq + 2 * r + 1], ph[kq][r],
                       pl[kq][r]);
      attn::split_bf16(dp[8 * kq + 2 * r], dp[8 * kq + 2 * r + 1], dh[kq][r],
                       dl[kq][r]);
      const int j = c0 / 8 + 2 * kq + r / 2;
      const int at = (16 * ww + tr + 8 * (r & 1)) * 128 + ((j ^ tr) << 4)
                     + 4 * tq;
      *reinterpret_cast<uint32_t*>(ds_w + at) = dh[kq][r];
      *reinterpret_cast<uint32_t*>(ds_w + T::DS_BYTES + at) = dl[kq][r];
    }

  // dV += P^T dO and dK += dS^T Q: B N-major, q rows 16 (c0 / 16 + kq) ..
  hop::wgmma_fence();
#pragma unroll
  for (int kq = 0; kq < NQ / 16; ++kq) {
    const uint64_t bg = hop::desc(gt, (c0 + 16 * kq) * T::WV * 2,
                                  BQ * T::WV * 2, 16 * T::WV, T::LV);
    hop::WgmmaRS<T::DPV>::template run<1>(dva, ph[kq], bg, 1);
    hop::WgmmaRS<T::DPV>::template run<1>(dva, pl[kq], bg, 1);
  }
#pragma unroll
  for (int kq = 0; kq < NQ / 16; ++kq) {
    const uint64_t bq = hop::desc(qt, (c0 + 16 * kq) * T::WQ * 2,
                                  BQ * T::WQ * 2, 16 * T::WQ, T::LQ);
    hop::WgmmaRS<T::DP>::template run<1>(dka, dh[kq], bq, 1);
    hop::WgmmaRS<T::DP>::template run<1>(dka, dl[kq], bq, 1);
  }
  if (hp + 1 < T::PASSES) {
    hop::wgmma_commit();
    hop::wgmma_wait_all();
    hop::fence_regs(dka);
    hop::fence_regs(dva);
  }
}

template <int KS, int KV>
__global__ void __launch_bounds__(Tile<KS, KV>::THREADS, 1)
flash_bwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_g,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq_acc,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, Strides st,
                 int hq, int hkv, int sq, int sk, int d, int d_v, int ldl,
                 int causal, int window, float scale) {
  using T = Tile<KS, KV>;
  extern __shared__ __align__(1024) unsigned char tile_smem[];
  unsigned char* sm =
      tile_smem + (1024 - hop::smem_u32(tile_smem) % 1024) % 1024;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + T::BAR_OFF);
  uint64_t* empty = full + T::STAGES;
  uint64_t* kv_bar = empty + T::STAGES;
  uint64_t* dq_full = kv_bar + 1;
  uint64_t* dq_empty = kv_bar + 2;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * T::KEYS;       // the longest tiles first
  const int G = hq / hkv;
  // q tiles reaching this k tile: q >= k0 if causal, q < k_last + window
  const int k_last = min(k0 + T::KEYS, sk) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(sq - 1, k_last + window - 1) : sq - 1;
  const int t0 = q_lo / BQ;
  const int nt = q_lo <= q_hi ? q_hi / BQ - t0 + 1 : 0;
  const int n_it = G * nt;

  if (tid == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 128 * T::NWG);
    }
    hop::mbar_init(kv_bar, 1);
    hop::mbar_init(dq_full, 128 * T::NWG);
    hop::mbar_init(dq_empty, 1);
    hop::mbar_fence_init();
  }
  __syncthreads();

  // the role of the thread's warpgroup and warp, read through a shuffle so
  // that the compiler sees them uniform and gives each branch its own
  // register budget (setmaxnreg)
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == 0) {
    // producer warpgroup: 24 registers a thread, so that the consumers
    // may take 240 (24 * 128 + 240 * 256 = 168 * 384, what the block is
    // launched with); warp 0 loads, warp 1 adds dQ's tiles
    hop::reg_dealloc<24>();
    const int pw = __shfl_sync(0xffffffffu, warp, 0);
    if (pw == 0 && lane == 0 && n_it > 0) {
      hop::mbar_expect_tx(kv_bar, T::KEYS * (T::DP + T::DPV) * 2);
      for (int c = 0; c < T::DP / 8; ++c)
        hop::tma_load_4d(sm + T::K_OFF + c * T::KEYS * 16, &tm_k, c * 8, k0,
                         kvh, b, kv_bar);
      for (int c = 0; c < T::DPV / T::WV; ++c)
        hop::tma_load_4d(sm + T::V_OFF + c * T::KEYS * T::WV * 2, &tm_v,
                         c * T::WV, k0, kvh, b, kv_bar);
      for (int it = 0; it < n_it; ++it) {
        const int s = it % T::STAGES;
        if (it >= T::STAGES)
          hop::mbar_wait(&empty[s], (it / T::STAGES - 1) & 1);
        const int h = kvh * G + it / nt, q0 = (t0 + it % nt) * BQ;
        hop::mbar_expect_tx(&full[s], T::Q_BYTES + T::G_BYTES + 2 * BQ * 4);
        for (int c = 0; c < T::DP / T::WQ; ++c)
          hop::tma_load_4d(sm + T::Q_OFF + s * T::Q_BYTES + c * BQ * T::WQ * 2,
                           &tm_q, c * T::WQ, q0, h, b, &full[s]);
        for (int c = 0; c < T::DPV / T::WV; ++c)
          hop::tma_load_4d(sm + T::G_OFF + s * T::G_BYTES + c * BQ * T::WV * 2,
                           &tm_g, c * T::WV, q0, h, b, &full[s]);
        const long long row = (static_cast<long long>(b) * hq + h) * ldl + q0;
        hop::bulk_load(sm + T::L_OFF + s * BQ * 4, lse + row, BQ * 4, &full[s]);
        hop::bulk_load(sm + T::E_OFF + s * BQ * 4, delta + row, BQ * 4,
                       &full[s]);
      }
    } else if (pw == 1) {
      // one bulk reduce-add a tile into the scratch's tile (b, h, q0 / BQ)
      const float* tile = reinterpret_cast<const float*>(sm + T::U_OFF);
      if (lane == 0) {
        float* dst = dq_acc + ((static_cast<long long>(b) * hq + kvh * G)
                               * (ldl / BQ) + t0) * (BQ * T::DP);
        for (int it = 0, qi = t0; it < n_it; ++it) {
          hop::mbar_wait(dq_full, it & 1);
          hop::bulk_reduce_add(dst, tile, T::DQ_BYTES);
          hop::bulk_commit();
          hop::bulk_wait_all<true>();  // the tile read: free for the next
          hop::mbar_arrive(dq_empty);
          dst += BQ * T::DP;           // the next tile: past the last, the
          if (++qi == t0 + nt) {       // next head's first
            qi = t0;
            dst += static_cast<long long>(ldl / BQ - nt) * (BQ * T::DP);
          }
        }
        hop::bulk_wait_all<false>();
      }
    }
  } else {
    // consumer warpgroup wg: keys kw0 .. kw0 + 63
    hop::reg_alloc<240>();
    const int wg = role - 1, ww = warp % 4, tq = lane % 4, tr = lane / 4;
    const int kw0 = k0 + 64 * wg;
    const int key_a = kw0 + 16 * ww + tr;    // this thread's keys: +0, +8
    const uint32_t base = hop::smem_u32(sm);
    // shared addresses of this warpgroup's K and V rows, of its dQ columns
    // of K, and of dS^T
    const uint32_t k_a = base + T::K_OFF + wg * 64 * 16;
    const uint32_t v_a = base + T::V_OFF + wg * 64 * T::WV * 2;
    const uint32_t k_b = base + T::K_OFF + wg * T::DQN / 8 * T::KEYS * 16;
    const uint32_t u_s = base + T::U_OFF;
    const float scale_log2 = scale * LOG2E;

    float dka[T::DP / 2], dva[T::DPV / 2];
#pragma unroll
    for (int i = 0; i < T::DP / 2; ++i) dka[i] = 0.f;
#pragma unroll
    for (int i = 0; i < T::DPV / 2; ++i) dva[i] = 0.f;
    if (n_it > 0) hop::mbar_wait(kv_bar, 0);

    for (int it = 0; it < n_it; ++it) {
      const int s = it % T::STAGES;
      const int q0 = (t0 + it % nt) * BQ;
      const uint32_t qt = base + T::Q_OFF + s * T::Q_BYTES;
      const uint32_t gt = base + T::G_OFF + s * T::G_BYTES;
      hop::mbar_wait(&full[s], (it / T::STAGES) & 1);

#pragma unroll
      for (int hp = 0; hp < T::PASSES; ++hp)
        score_pass<T>(hp, q0, sq, sk, causal, window, scale_log2, ww, tq, tr,
                      kw0, k_a, v_a, qt, gt,
                      reinterpret_cast<const float*>(sm + T::L_OFF) + s * BQ,
                      reinterpret_cast<const float*>(sm + T::E_OFF) + s * BQ,
                      sm + T::U_OFF + 64 * wg * 128,
                      it > 0 ? dq_empty : nullptr, (it - 1) & 1, dka, dva);
      hop::wgmma_commit();
      hop::fence_proxy_async();
      hop::named_sync(1, 128 * T::NWG);    // dS^T of every key written
      hop::wgmma_wait_all();
      hop::fence_regs(dka);
      hop::fence_regs(dva);

      // dQ[64 q, this warpgroup's DQN columns] = dS K over the block's keys:
      // A = dS^T's tile read M-major, B = K's chunks N-major
      float dqa[T::DQN / 2];
#pragma unroll
      for (int i = 0; i < T::DQN / 2; ++i) dqa[i] = 0.f;
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < T::KEYS / 16; ++kk) {
        const uint64_t bk = hop::desc(k_b, kk * 16 * 16, 128, T::KEYS * 16, 0);
        hop::WgmmaSS<T::DQN>::template run<1, 1>(
            dqa, hop::desc(u_s, kk * 16 * 128, T::DS_BYTES, 1024, 1), bk, 1);
        hop::WgmmaSS<T::DQN>::template run<1, 1>(
            dqa,
            hop::desc(u_s, T::DS_BYTES + kk * 16 * 128, T::DS_BYTES, 1024, 1),
            bk, 1);
      }
      hop::wgmma_commit();
      hop::wgmma_wait_all();
      hop::fence_regs(dqa);
      hop::mbar_arrive(&empty[s]);         // Q, dO, lse, delta of s read
      hop::named_sync(1, 128 * T::NWG);    // dS^T read by both warpgroups

      // the dQ tile over dS^T's place, for the producer's second warp, in
      // the accumulators' order (flash_bwd_dq_tile_kernel): 16 floats a
      // (column group of 8, warp, row in 8), 4 from each of the 4 threads
      float2* dqt = reinterpret_cast<float2*>(sm + T::U_OFF);
#pragma unroll
      for (int j = 0; j < T::DQN / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          dqt[((wg * T::DQN / 8 + j) * 32 + ww * 8 + tr) * 8 + tq * 2 + i] =
              make_float2(dqa[4 * j + 2 * i], dqa[4 * j + 2 * i + 1]);
      hop::fence_proxy_async();
      hop::mbar_arrive(dq_full);
    }

    // dK (scaled) and dV as bf16 into k's and v's layouts
    bf16* dkp = dk + b * st.dk[0] + kvh * st.dk[1];
    bf16* dvp = dv + b * st.dv[0] + kvh * st.dv[1];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kpos = key_a + 8 * i;
      if (kpos >= sk) continue;
#pragma unroll
      for (int j = 0; j < T::DP / 8; ++j) {
        const int col = 8 * j + 2 * tq;
        if (col < d)
          *reinterpret_cast<uint32_t*>(dkp + kpos * st.dk[2] + col) =
              attn::pack_bf16(dka[4 * j + 2 * i] * scale,
                              dka[4 * j + 2 * i + 1] * scale);
      }
#pragma unroll
      for (int j = 0; j < T::DPV / 8; ++j) {
        const int col = 8 * j + 2 * tq;
        if (col < d_v)
          *reinterpret_cast<uint32_t*>(dvp + kpos * st.dv[2] + col) =
              attn::pack_bf16(dva[4 * j + 2 * i], dva[4 * j + 2 * i + 1]);
      }
    }
  }
}

// The mma.sync kernel, for the widths flash_bwd_kernel cannot hold: equal
// widths past 128 (the instance <16, 2>, D 136 to 256). KS = ceil(D / 16);
// WN warps share a 16-key group, each keeping 2 KS / WN of dK's and of
// dV's 2 KS n8 column tiles, and each recomputing S and dP. d_v comes last
// and is d (its place among the parameters moves the registers and
// spills); the dK and dV stores share one test.
template <int KS, int WN>
__global__ void __launch_bounds__(128 * WN, WN == 1 ? 2 : 1)
flash_bwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq_acc,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, Strides st,
                 int hq, int hkv, int sq, int sk, int d, int ldl,
                 int causal, int window, float scale, int d_v) {
  constexpr int THREADS = 128 * WN;
  constexpr int KV = KS;                // dP^T, dV and the V, dO tiles: Dv = D
  constexpr int DP = 16 * KS, DPV = 16 * KV;
  constexpr int LD = bwd_ld(KS), LDV = bwd_ld(KV);
  constexpr int NTW = 2 * KS / WN;      // n8 column tiles of dK a warp keeps
  constexpr int KSW = KS / WN;          // their k16 groups
  constexpr int NTV = 2 * KV / WN;      // ... of dV
  constexpr int KVW = KV / WN;
  constexpr int KMAX = KS > KV ? KS : KV;
  constexpr int KWMAX = KSW > KVW ? KSW : KVW;
  constexpr int NMAX = NTW > NTV ? NTW : NTV;
  d_v = d;
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

  // columns [d, DP) of the K, V, Q and dO tiles (one stride): zero, never
  // written again
  zero_cols<THREADS>(ks, 2 * BK + 4 * BQ, LD, d, DP, tid);

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

template <int KS, int WN>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, float* dq_acc, void* dk,
               void* dv, const Strides& st, int b, int hq, int hkv, int sq,
               int sk, int d, int d_v, int ldl, int causal, int window,
               float scale, cudaStream_t stream) {
  constexpr int smem = bwd_smem_bytes(KS, KS);
  static attn::SmemLimit limit;
  const cudaError_t err = limit.allow(
      reinterpret_cast<const void*>(flash_bwd_mma_kernel<KS, WN>), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(hkv, b, (sk + BK - 1) / BK);
  flash_bwd_mma_kernel<KS, WN><<<grid, 128 * WN, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
      dq_acc, static_cast<bf16*>(dk), static_cast<bf16*>(dv), st, hq, hkv, sq,
      sk, d, ldl, causal, window, scale, d_v);
  return static_cast<int>(cudaGetLastError());
}

// cuTensorMapEncodeTiled, found in the driver through the runtime (the
// library links no libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A bf16 operand [batch, heads, rows, cols] with element strides st
// (batch, head, row) as a 4-d tensor map whose box is box_cols x box_rows
// of one head; rows and columns past the operand's read as zero.
cudaError_t tensor_map(CUtensorMap* map, const void* base,
                       const long long* st, int cols, int rows, int heads,
                       int batch, int box_cols, int box_rows,
                       CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dim[4] = {static_cast<cuuint64_t>(cols),
                             static_cast<cuuint64_t>(rows),
                             static_cast<cuuint64_t>(heads),
                             static_cast<cuuint64_t>(batch)};
  // byte strides of rows, heads and batch; a dimension of size 1 is never
  // stepped, but TMA wants its stride a multiple of 16 all the same
  cuuint64_t stride[3];
  cuuint64_t extent = static_cast<cuuint64_t>(cols) * 2;
  for (int i = 0; i < 3; ++i) {
    stride[i] = dim[i + 1] > 1 ? static_cast<cuuint64_t>(st[2 - i]) * 2
                               : (extent + 15) / 16 * 16;
    extent = stride[i] * dim[i + 1];
  }
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dim, stride, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  float* dq_acc;
  void *dk, *dv;
  Strides st;
  int b, hq, hkv, sq, sk, d, d_v, ldl, causal, window;
  float scale;
  cudaStream_t stream;
};

// What each width runs: hopper<KS, KV>() for flash_bwd_kernel, mma() for
// flash_bwd_mma_kernel<16, 2>; -1 for a pair no kernel takes.
template <typename F>
int by_width(int d, int d_v, const F& f) {
  if (d_v != d) {
    // latent attention's q.k 192 (128 + 64 rope), values 128
    if ((d + 15) / 16 == 12 && (d_v + 15) / 16 == 8)
      return f.template hopper<12, 8>();
    return -1;
  }
  switch ((d + 15) / 16) {
    case 1: case 2: case 3: case 4: return f.template hopper<4, 4>();
    case 5: return f.template hopper<5, 5>();
    case 6: case 7: case 8: return f.template hopper<8, 8>();
    case 9: case 10: case 11: case 12: case 13: case 14: case 15: case 16:
      return f.mma();
    default: return -1;
  }
}

struct Launch {
  const Args& a;
  template <int KS, int KV>
  int hopper() const {
    using T = Tile<KS, KV>;
    static attn::SmemLimit limit;
    cudaError_t err = limit.allow(
        reinterpret_cast<const void*>(flash_bwd_kernel<KS, KV>), T::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    const CUtensorMapSwizzle sq_ = T::WQ == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                               : CU_TENSOR_MAP_SWIZZLE_32B;
    const CUtensorMapSwizzle sv_ = T::WV == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                               : CU_TENSOR_MAP_SWIZZLE_32B;
    CUtensorMap tq, tk, tv, tg;
    if ((err = tensor_map(&tq, a.q, a.st.q, a.d, a.sq, a.hq, a.b, T::WQ, BQ,
                          sq_)) != cudaSuccess
        || (err = tensor_map(&tk, a.k, a.st.k, a.d, a.sk, a.hkv, a.b, 8,
                             T::KEYS, CU_TENSOR_MAP_SWIZZLE_NONE))
               != cudaSuccess
        || (err = tensor_map(&tv, a.v, a.st.v, a.d_v, a.sk, a.hkv, a.b,
                             T::WV, T::KEYS, sv_)) != cudaSuccess
        || (err = tensor_map(&tg, a.dout, a.st.g, a.d_v, a.sq, a.hq, a.b,
                             T::WV, BQ, sv_)) != cudaSuccess)
      return static_cast<int>(err);
    const dim3 grid(a.hkv, a.b, (a.sk + T::KEYS - 1) / T::KEYS);
    flash_bwd_kernel<KS, KV><<<grid, T::THREADS, T::SMEM, a.stream>>>(
        tq, tk, tv, tg, a.lse, a.delta, a.dq_acc, static_cast<bf16*>(a.dk),
        static_cast<bf16*>(a.dv), a.st, a.hq, a.hkv, a.sq, a.sk, a.d, a.d_v,
        a.ldl, a.causal, a.window, a.scale);
    return static_cast<int>(cudaGetLastError());
  }
  int mma() const {
    return launch_bwd<16, 2>(a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dq_acc,
                             a.dk, a.dv, a.st, a.b, a.hq, a.hkv, a.sq, a.sk,
                             a.d, a.d_v, a.ldl, a.causal, a.window, a.scale,
                             a.stream);
  }
};

// the scratch's tile width: the padded D for flash_bwd_kernel, 0 for
// flash_bwd_mma_kernel's [b, hq, sq, d] scratch
struct Width {
  template <int KS, int KV>
  int hopper() const { return 16 * KS; }
  int mma() const { return 0; }
};

// registers a thread, static shared bytes, local bytes a thread (stack and
// spills), dynamic shared bytes of the kernel
struct Attributes {
  int* out;
  int read(const void* kernel, int smem) const {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[0] = attr.numRegs;
    out[1] = static_cast<int>(attr.sharedSizeBytes);
    out[2] = static_cast<int>(attr.localSizeBytes);
    out[3] = smem;
    return 0;
  }
  template <int KS, int KV>
  int hopper() const {
    return read(reinterpret_cast<const void*>(flash_bwd_kernel<KS, KV>),
                Tile<KS, KV>::SMEM);
  }
  int mma() const {
    return read(reinterpret_cast<const void*>(flash_bwd_mma_kernel<16, 2>),
                bwd_smem_bytes(16, 16));
  }
};

}  // namespace

// The whole backward on `stream`: zero dq_acc, delta, the main kernel, dq.
// d: q's and k's head dim; d_v: v's, o's and dO's (d, or 128 beside a d of
// 192). q, k, v, o, dO bf16 as the forward took them (D % 8 == 0, D <= 256,
// pointers and strides 16-byte aligned, the last dim contiguous); lse the
// forward's float32 [b, hq, ldl] (ldl >= sq rounded up to 64); delta a
// float32 [b, hq, ldl] scratch; dq_acc a float32 scratch of b hq ldl w
// floats, w = flash_attention_backward_scratch_width(d, d_v), or of b hq sq
// d where that is 0;
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
  const int width = by_width(d, d_v, Width{});
  if (width < 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), static_cast<float*>(dq_acc), dk,
         dv, {}, b, hq, hkv, sq, sk, d, d_v, ldl, causal, window, scale,
         static_cast<cudaStream_t>(stream)};
  long long* dst[8] = {a.st.q, a.st.k, a.st.v, a.st.o,
                       a.st.g, a.st.dq, a.st.dk, a.st.dv};
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 3; ++j) dst[i][j] = strides[3 * i + j];
  cudaError_t err = cudaMemsetAsync(
      dq_acc, 0,
      sizeof(float) * static_cast<size_t>(b) * hq
          * (width > 0 ? static_cast<size_t>(ldl) * width
                       : static_cast<size_t>(sq) * d),
      a.stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(b) * hq * ldl;
  flash_bwd_delta_kernel<<<static_cast<unsigned>((rows + 31) / 32), 256, 0,
                           a.stream>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<float*>(delta), a.st, hq, sq, ldl, d_v, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int e = by_width(d, d_v, Launch{a});
  if (e != 0) return e;
  if (width > 0) {
    const long long units = static_cast<long long>(b) * hq * ldl / 16 * width;
    flash_bwd_dq_tile_kernel<<<static_cast<unsigned>((units + 255) / 256),
                               256, 0, a.stream>>>(
        static_cast<const float*>(dq_acc), static_cast<bf16*>(dq), a.st, hq,
        sq, d, width, ldl / BQ, scale, units);
  } else {
    const long long n = static_cast<long long>(b) * hq * sq * (d / 8);
    flash_bwd_dq_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                          a.stream>>>(
        static_cast<const float*>(dq_acc), static_cast<bf16*>(dq), a.st, hq,
        sq, d, scale, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// The width w of dq_acc's tiles where (d, d_v) runs flash_bwd_kernel (the
// scratch then holds b hq ldl w floats); 0 where it runs
// flash_bwd_mma_kernel (the widths whose accumulators do not fit
// flash_bwd_kernel; b hq sq d floats); -1 where neither takes it.
extern "C" int flash_attention_backward_scratch_width(int d, int d_v) {
  return by_width(d, d_v, Width{});
}

// The main kernel of (d, d_v): out[4] = registers a thread, static shared
// bytes, local bytes a thread, dynamic shared bytes; returns a CUDA error,
// or -1 for a pair no kernel takes.
extern "C" int flash_attention_backward_attributes(int d, int d_v, int* out) {
  return by_width(d, d_v, Attributes{out});
}
