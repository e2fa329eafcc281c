// Hand-written Hopper (sm_90a) attention of the fused LN-attention block
// (#1 and #2, fused_block_attn.cu) on its road with no mask at head dim 64
// and up to 256 keys: the vision tower of every ViT the registry builds
// (ViT-B/16's 197 tokens, L2P's 222), at every batch size the methods run,
// and past 256 keys up to ATTN_WGMMA_LONG_TMAX (ViT-L/14's 257: the long
// kernels below); and of the KV-prefix block (#3 and #4) under a key-mask
// row at head dim 64 and up to 256 keys S = P + T: the prompted passes of
// mvp-clip, DualPrompt and MVP (P = 20, S = 217) and ProtoCLIP's CoPL image
// pass (P = 4, S = 201).
//
// Replaces, on those roads, the attention of the TPU kernels of
// lifelong_clip_tpu/ops/fused_block_attn.py:
//   * _kernel:93-108 (softmax(q k^T * scale) v per head; pallas_call :161)
//   * _bwd_kernel:331 (head_probs) and :380-404 (dv = p16^T dctx; ds = p
//     (dp - rowsum(dp p)) rounded to bf16 once; dq = ds16 k * scale; dk =
//     ds16^T q * scale; pallas_call :478)
//   * _prefix_kernel:573 (s * scale + mask over [prefix; token] keys;
//     pallas_call :631) and _prefix_bwd_kernel:766 (pallas_call :897)
// which the port had run on mma.sync (attn_fwd_kernel, attn_bwd_dq_kernel,
// attn_bwd_dkv_kernel in fused_block_attn.cu; a 2-D mask, a KV prefix with
// no mask, head dims 16 and 32, a prefix past 256 keys and rows with no
// mask past ATTN_WGMMA_LONG_TMAX keep those; the long kernels replace
// attn_fwd_tiled_kernel, attn_bwd_dq_tiled_kernel and attn_bwd_dkv_kernel
// on their rows).
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): bytes. At ViT-B/16's
// vision shape (64 x 197 x 768, 12 heads) the forward reads qkv16 and
// writes ctx16 (77.5 MB, 0.023 ms) for 2 products of 2.4 GFLOP; the
// backward reads qkv16 and dctx16 and writes dqkv16 (136 MB, 0.040 ms) for
// 5 products (19.1 GFLOP, 0.019 ms).
//
// Design:
//   * Every operand tile comes by TMA, through 3-D maps over (batch row,
//     token, column), in 64-row boxes of 64 bf16 (128-byte rows, 128B
//     swizzle) that wgmma reads directly: rows past T read as zeros (and
//     K / V tiles wholly past T are zeroed in place). No thread spends
//     registers or instructions on the copies.
//   * The order of the fp32 sums is the mma.sync kernels', so the values
//     are theirs as far as the tensor cores' own k16 sums agree (the whole
//     run of lora-clip reads 1.77x the library road's distance from fp32
//     when the order of these sums changes, against a limit of 1.5x). Those
//     kernels split a score row between two warps, the first taking the
//     first ceil(n/2) of its n 16-key blocks (h0 blocks), and summed each
//     half in the MMA fragment order, then the halves. Here two products of
//     64 x WIN scores cover the halves, keys [0, WIN) and [16 h0, 16 h0 +
//     WIN) (wa_win: 64 up to 128 keys, 112 up to 224, else 128; the
//     halves' blocks past their own are -inf, p = 0 exactly), and each sum
//     runs over its half in the
//     same fragment order: the row sum and rowsum(dp e) as half 0 + half 1,
//     p @ v and ds @ k as two accumulator chains added at the end. dk and dv
//     run over the queries in order, one chain, as the dk/dv kernel did.
//   * Forward (attn_fwd_wgmma_kernel): one warpgroup a 64-row query tile,
//     grid (query tiles, heads, batch rows): no small batch leaves the card
//     idle (16 rows: 768 blocks, two an SM). q k^T as two wgmma m64nWINk16
//     chains with both operands in shared memory, the exact full-row softmax
//     in registers (no online rescaling: p = exp(s - max) / sum normalised
//     in fp32, then rounded to bf16 once, as _kernel:102-108), p @ v as
//     wgmma with p the register A operand, V's tile read N-major.
//   * Backward (attn_bwd_wgmma_kernel): one block of two warpgroups a
//     (head, batch row), which loads the head's Q, K, V and dctx once (the
//     mma.sync road read them twice, in its dq and its dk/dv kernel).
//     Phase 1, query tile by query tile: the warpgroups take the two halves
//     of the keys (the two warps of a pair before), s = q k^T and dp = dctx
//     v^T by wgmma, the row max, sum and t = sum(dp e) exchanged through
//     shared memory, ds16 = bf16(p (dp - t / l)) and dq = ds16 k by wgmma
//     with ds16 in registers; the halves' dq are added (each warpgroup
//     finishing half of the columns) and written once; each query's (max,
//     1 / sum, delta) stays in shared memory. Phase 2, key tile by key tile (a warpgroup each in turn), the
//     query tiles in order (past the last whole tile of 64 queries, 16 at a
//     time): s^T = k q^T and dp^T = v dctx^T by wgmma, p^T and
//     ds^T rebuilt from the statistics without a division (the dk/dv
//     kernel's arithmetic), dv += p16^T dctx and dk += ds16^T q by wgmma
//     from registers. No atomics: the outputs are the same bit for bit over
//     runs, and a row's values do not depend on the batch.
//   * Weight grads: each 16-row group's fp32 column sums of dq, dk and dv
//     (group_colsum) go to the bias partials as the mma.sync kernels wrote
//     them.
//   * KV prefix (PRE): key j is row j of the K and V buffers, as in the
//     mma.sync kernels (load_kv): rows 0..P-1 the prefix keys of kvp (B*P,
//     2D: K | V), rows P..S-1 the tokens. The halves and their windows come
//     from S (wa_win(S), h0 = ceil(n/2) of n = ceil(S/16) blocks), the key
//     row enters as s * scale + mask[j] (base 2: fmaf(s, sl2, log2(e) *
//     mask[j])), as the ROW instances add it, and the sums keep their order:
//     ctx16, dqkv16, dkvp16 and the partials are the mma.sync kernels' bit
//     for bit. A TMA box must start on the swizzle's 8-row atom, and token
//     0 sits at row P (mid-atom at P = 20 and 4): the threads copy the
//     first R0 = 8 ceil(P/8) rows (the prefix keys and the first R0 - P
//     tokens) with the swizzle's XOR applied, TMA brings the whole token
//     boxes that fit the buffer from token R0 - P onto row R0, and the
//     threads copy the rows after the last box (the last tokens, then
//     zeros); no gap re-groups the 16-key blocks, and the buffers are the
//     road's with no prefix (the forward keeps its three blocks an SM).
//     The backward writes a prefix key's dk / dv to dkvp16 and a
//     token's to dqkv16; the key groups' partials span all S keys
//     (_bias_rows(pp, P + T)).
// ---------------------------------------------------------------------------
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma.cuh"

typedef __nv_bfloat16 bf16;

constexpr int WA_DH = 64;                     // the road's head dim
constexpr int WA_TILE = 64;                   // rows of a box and of a wgmma
constexpr int WA_BOX = WA_TILE * WA_DH * 2;   // one 64-row box: 8 KB
constexpr int WA_FWD_THREADS = 128, WA_BWD_THREADS = 256;

// The keys a half row's window spans (WIN): the first half holds ceil(n/2)
// of a row's n 16-key blocks, so 64 up to 128 keys, 112 up to 224 (ViT-B/16's
// 197, L2P's 222), else 128.
__host__ __device__ constexpr int wa_win(int T) {
  return T <= 128 ? 64 : (T <= 224 ? 112 : 128);
}

// The 64-row tiles of K and V a block holds: the second half's window ends
// at 16 ceil(n/2) + WIN <= 2 WIN keys.
__host__ __device__ constexpr int wa_tiles(int win) { return (2 * win + 63) / 64; }

// s (64 x WIN, fp32) += A (64 x 64) . B^T (B: WIN rows of 64), both
// K-major 128B-swizzled tiles in shared memory (WIN 16, 32 or 48: the last
// key tile's live chunks past 256 keys).
template <int WIN>
__device__ __forceinline__ void wa_scores(float (&s)[WIN / 2],
                                          const unsigned char* A,
                                          const unsigned char* B) {
#pragma unroll
  for (int kk = 0; kk < WA_DH / 16; ++kk) {
    const uint64_t da = wg_desc(A + kk * 32, 16, 1024);
    const uint64_t db = wg_desc(B + kk * 32, 16, 1024);
    if constexpr (WIN == 128) wgmma_m64n128k16<0, 0>(s, da, db);
    else if constexpr (WIN == 112) wgmma_m64n112k16<0, 0>(s, da, db);
    else if constexpr (WIN == 48) wgmma_m64n48k16<0, 0>(s, da, db);
    else if constexpr (WIN == 32) wgmma_m64n32k16<0, 0>(s, da, db);
    else if constexpr (WIN == 16) wgmma_m64n16k16<0, 0>(s, da, db);
    else wgmma_m64n64k16<0, 0>(s, da, db);
  }
}

// acc (64 x 64, fp32) += A (64 x 16 NK, register fragments a[kk] of its
// k16 steps) . B (16 NK rows of 64, N-major), the k16 steps in order.
template <int NK>
__device__ __forceinline__ void wa_rs(float (&acc)[32],
                                      const unsigned (&a)[NK][4],
                                      const unsigned char* B) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
    wgmma_m64n64k16_rs<1>(acc, a[kk], wg_desc(B + kk * 2048, WA_BOX, 1024));
}

__device__ __forceinline__ void wa_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ void wa_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wa_zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

// The 64-row tile's base in the 1024-byte-aligned dynamic shared memory
__device__ __forceinline__ unsigned char* wa_base(unsigned char* smem) {
  return smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
}

// K and V tiles nkt .. NT - 1, past the last key, as zeros (generic
// stores, made visible to wgmma's reads by the fence and the barrier that
// follows): a half's window of keys may reach into them, where p = 0.
__device__ __forceinline__ void wa_zero_tiles(unsigned char* Ks,
                                              unsigned char* Vs, int nkt,
                                              int nt, int tid, int nthreads) {
  for (int i = nkt * WA_BOX / 16 + tid; i < nt * WA_BOX / 16; i += nthreads) {
    reinterpret_cast<uint4*>(Ks)[i] = make_uint4(0u, 0u, 0u, 0u);
    reinterpret_cast<uint4*>(Vs)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// mbar_wait with a bound: a barrier that never completes (a load that was
// refused) stops the kernel with an error instead of holding the card.
__device__ __forceinline__ void wa_wait(uint64_t* bar) {
  unsigned done = 0, tries = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)) : "memory");
    if (!done && ++tries > (1u << 24)) __trap();
  }
}

// The two warpgroups of the backward (named barrier 1)
__device__ __forceinline__ void wa_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// KV prefix (PRE): the rows of the K and V buffers (NR of them) that no
// TMA box writes, [0, R0) and [TB, NR): key r of row r is prefix key r of
// kvp (r < P), token r - P of qkv (r - P < T) or zero, copied by the
// threads into the 128B swizzle TMA writes (chunk c of row r at chunk c ^
// (r % 8)). And the key-mask row, log2(e)-scaled (ml[j] = log2(e) *
// mask[j], the ROW kernels' product), for the S keys. Each thread issues
// WA_PRE_U chunks' loads before it stores any, so their latency is paid
// once (a load, then its store, chunk after chunk, had cost the forward a
// fifth of its time).
constexpr int WA_PRE_U = 4;

__device__ __forceinline__ void wa_prefix_rows(
    unsigned char* Ks, unsigned char* Vs, float* ml, const bf16* qkv,
    const bf16* kvp, const float* mask, int b, int T, int P, int D, int col,
    int R0, int TB, int NR, int tid, int nthreads) {
  const int S = P + T, nc = (R0 + NR - TB) * 8;   // 16-byte chunks to copy
  for (int i0 = 0; i0 < max(nc, S); i0 += WA_PRE_U * nthreads) {
    uint4 k[WA_PRE_U], v[WA_PRE_U];
    float m[WA_PRE_U];
#pragma unroll
    for (int u = 0; u < WA_PRE_U; ++u) {
      const int i = i0 + u * nthreads + tid, c = i & 7;
      const int r = i < R0 * 8 ? i >> 3 : TB + ((i - R0 * 8) >> 3);
      const bf16* src = nullptr;   // K; V is D columns on
      if (i < nc) {
        if (r < P)
          src = kvp + ((size_t)b * P + r) * 2 * D + col + 8 * c;
        else if (r - P < T)
          src = qkv + ((size_t)b * T + r - P) * 3 * D + D + col + 8 * c;
      }
      k[u] = v[u] = make_uint4(0u, 0u, 0u, 0u);
      if (src) {
        k[u] = *reinterpret_cast<const uint4*>(src);
        v[u] = *reinterpret_cast<const uint4*>(src + D);
      }
      m[u] = i < S ? mask[i] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < WA_PRE_U; ++u) {
      const int i = i0 + u * nthreads + tid, c = i & 7;
      const int r = i < R0 * 8 ? i >> 3 : TB + ((i - R0 * 8) >> 3);
      if (i < nc) {
        const int o = r * 128 + ((c ^ (r & 7)) << 4);
        *reinterpret_cast<uint4*>(Ks + o) = k[u];
        *reinterpret_cast<uint4*>(Vs + o) = v[u];
      }
      if (i < S) ml[i] = LOG2E * m[u];
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The rows of the K and V buffers before the first token box (PRE: R0 = 8
// ceil(P/8), else 0), and the token boxes: T tokens from token R0 - P on,
// 64 a box, as many whole boxes as the NR rows of the buffers hold after
// R0.
__device__ __forceinline__ int wa_r0(bool pre, int P) { return pre ? (P + 7) & ~7 : 0; }
__device__ __forceinline__ int wa_boxes(int T, int tok0, int R0, int NR) {
  const int n = T > tok0 ? (T - tok0 + WA_TILE - 1) / WA_TILE : 0;
  return min(n, (NR - R0) / WA_TILE);
}

template <int WIN, bool PRE>
__global__ void __launch_bounds__(WA_FWD_THREADS, 2)
attn_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_qkv,
                      const bf16* __restrict__ qkv, const bf16* __restrict__ kvp,
                      const float* __restrict__ mask, bf16* __restrict__ ctx,
                      int T, int P, int D, float scale) {
  constexpr int NT = wa_tiles(WIN), NJ = WIN / 8, NK = WIN / 16;
  extern __shared__ __align__(1024) unsigned char wa_smem[];
  unsigned char* Qs = wa_base(wa_smem);
  unsigned char* Ks = Qs + WA_BOX;
  unsigned char* Vs = Ks + NT * WA_BOX;
  uint64_t* bar = reinterpret_cast<uint64_t*>(Vs + NT * WA_BOX);  // Q + K, V
  float* ml = reinterpret_cast<float*>(bar + 2);   // PRE: the key-mask row
  const int qt = blockIdx.x, hd = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  if constexpr (!PRE) P = 0;
  const int S = P + T, col = hd * WA_DH;
  const int R0 = wa_r0(PRE, P), tok0 = R0 - P;
  // the token boxes of K (and of V), rows [R0, TB)
  const int nkt = wa_boxes(T, tok0, R0, NT * WA_TILE), TB = R0 + nkt * WA_TILE;
  // the loads in flight first (the query tile and K on bar 0, V on bar 1),
  // then the rows they do not write (generic stores: disjoint from the
  // boxes, fenced for wgmma before the barrier)
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar, (1 + nkt) * WA_BOX);
    tma_load3(Qs, &tm_qkv, bar, col, qt * WA_TILE, b);
    for (int t = 0; t < nkt; ++t)
      tma_load3(Ks + R0 * 128 + t * WA_BOX, &tm_qkv, bar, D + col,
                tok0 + t * WA_TILE, b);
    mbar_expect_tx(bar + 1, nkt * WA_BOX);
    for (int t = 0; t < nkt; ++t)
      tma_load3(Vs + R0 * 128 + t * WA_BOX, &tm_qkv, bar + 1, 2 * D + col,
                tok0 + t * WA_TILE, b);
  }
  if constexpr (PRE)
    wa_prefix_rows(Ks, Vs, ml, qkv, kvp, mask, b, T, P, D, col, R0, TB,
                   NT * WA_TILE, tid, WA_FWD_THREADS);
  else
    wa_zero_tiles(Ks, Vs, nkt, NT, tid, WA_FWD_THREADS);
  __syncthreads();
  // the halves: keys [0, lim0) and [kb1, S)
  const int npair = (S + 15) / 16, kb1 = 16 * ((npair + 1) / 2);
  const int lim0 = min(kb1, S);
  float sa[WIN / 2], sb[WIN / 2];
  wa_zero(sa);
  wa_zero(sb);
  wa_wait(bar);
  wg_reg_fence(sa);
  wg_reg_fence(sb);
  wa_fence();
  wa_scores<WIN>(sa, Qs, Ks);
  wa_scores<WIN>(sb, Qs, Ks + kb1 * 128);
  wa_commit_wait();
  wg_reg_fence(sa);
  wg_reg_fence(sb);

  // scores in base 2 (s scale log2(e), so exp2 gives exp(s - max)), plus
  // the key row's log2(e) mask (PRE); keys past a half's own are -inf; the
  // row max over both halves
  const float sl2 = scale * LOG2E;
  float ma = -INFINITY, mb = -INFINITY;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int k = 8 * j + 2 * t4 + e;
      const bool l0 = k < lim0, l1 = kb1 + k < S;
      const float m0 = PRE ? ml[k] : 0.f, m1 = PRE ? ml[kb1 + k] : 0.f;
      sa[4 * j + e] = l0 ? fmaf(sa[4 * j + e], sl2, m0) : -INFINITY;
      sa[4 * j + 2 + e] = l0 ? fmaf(sa[4 * j + 2 + e], sl2, m0) : -INFINITY;
      sb[4 * j + e] = l1 ? fmaf(sb[4 * j + e], sl2, m1) : -INFINITY;
      sb[4 * j + 2 + e] = l1 ? fmaf(sb[4 * j + 2 + e], sl2, m1) : -INFINITY;
      ma = fmaxf(ma, fmaxf(sa[4 * j + e], sb[4 * j + e]));
      mb = fmaxf(mb, fmaxf(sa[4 * j + 2 + e], sb[4 * j + 2 + e]));
    }
  ma = quad_max(ma);
  mb = quad_max(mb);
  // e = exp(s - max); each half's row sum in fragment order, then the halves
  float la0 = 0.f, lb0 = 0.f, la1 = 0.f, lb1 = 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sa[4 * j + e] = exp2f(sa[4 * j + e] - ma);
      sa[4 * j + 2 + e] = exp2f(sa[4 * j + 2 + e] - mb);
      la0 += sa[4 * j + e];
      lb0 += sa[4 * j + 2 + e];
    }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sb[4 * j + e] = exp2f(sb[4 * j + e] - ma);
      sb[4 * j + 2 + e] = exp2f(sb[4 * j + 2 + e] - mb);
      la1 += sb[4 * j + e];
      lb1 += sb[4 * j + 2 + e];
    }
  const float ila = 1.f / (quad_sum(la0) + quad_sum(la1));
  const float ilb = 1.f / (quad_sum(lb0) + quad_sum(lb1));
  // p = e / sum in fp32, rounded to bf16 as the A fragments of p @ v: k16
  // step kk holds keys 16 kk .. 16 kk + 15 of the half
  unsigned pa[NK][4], pb[NK][4];
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = 8 * kk + 2 * x;
      const float il = (x & 1) ? ilb : ila;
      pa[kk][x] = pack_bf16(sa[i] * il, sa[i + 1] * il);
      pb[kk][x] = pack_bf16(sb[i] * il, sb[i + 1] * il);
    }
  float o0[32], o1[32];
  wa_zero(o0);
  wa_zero(o1);
  wa_wait(bar + 1);
  wg_reg_fence(o0);
  wg_reg_fence(o1);
  wg_reg_fence_a(pa);
  wg_reg_fence_a(pb);
  wa_fence();
  wa_rs<NK>(o0, pa, Vs);
  wa_rs<NK>(o1, pb, Vs + kb1 * 128);
  wa_commit_wait();
  wg_reg_fence(o0);
  wg_reg_fence(o1);
  float v0[32], v1[32];
  wg_read(v0, o0);
  wg_read(v1, o1);
  // the halves' p @ v added, in that order, before the one rounding of ctx
  const int ia = qt * WA_TILE + 16 * warp + g, ib = ia + 8;
#pragma unroll
  for (int j = 0; j < WA_DH / 8; ++j) {
    const int c = hd * WA_DH + 8 * j + 2 * t4;
    if (ia < T)
      *reinterpret_cast<unsigned*>(ctx + ((size_t)b * T + ia) * D + c) =
          pack_bf16(v0[4 * j] + v1[4 * j], v0[4 * j + 1] + v1[4 * j + 1]);
    if (ib < T)
      *reinterpret_cast<unsigned*>(ctx + ((size_t)b * T + ib) * D + c) =
          pack_bf16(v0[4 * j + 2] + v1[4 * j + 2], v0[4 * j + 3] + v1[4 * j + 3]);
  }
}

// The warp's 16 rows of a 64-row tile in 128B swizzle (16-byte chunk c of
// row r at chunk c ^ (r % 8), as TMA writes it) as the A fragments of the
// 4 k16 steps over its 64 columns (ldmatrix).
__device__ __forceinline__ void wa_frags(unsigned (&a)[4][4],
                                         const unsigned char* tile, int warp,
                                         int lane) {
  const int r = 16 * warp + (lane & 15);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int chunk = 2 * kk + (lane >> 4);
    ldsm_x4(a[kk], reinterpret_cast<const bf16*>(tile + r * 128 +
                                                 ((chunk ^ (r & 7)) << 4)));
  }
}

// One step of the backward's phase 2 over NQ queries (64: a whole tile; 16:
// a block past the last whole tile) for the warpgroup's 64 keys (ka, va:
// their K and V rows as register fragments, so only Q and dctx stream from
// shared memory): s^T = K Q^T and dp^T = V dctx^T by wgmma; p^T = exp2(s^T scale log2(e) - max) *
// (1 / sum) and ds^T = p^T (dp^T - delta) for keys (ja, jb) x queries 8 j +
// 2 t4 + e of the step (stc: their statistics; p = 0 past the S keys;
// mka, mkb: the keys' log2(e) mask), without a division; then dv += p16^T
// dctx and dk += ds16^T q by wgmma from registers, the step's k16 blocks
// of queries in order.
template <int NQ>
__device__ __forceinline__ void wa_kv_step(float (&dk)[32], float (&dv)[32],
                                           const unsigned (&ka)[4][4],
                                           const unsigned (&va)[4][4],
                                           const unsigned char* Qc,
                                           const unsigned char* Gc,
                                           const float4* stc, int ja, int jb,
                                           int S, float mka, float mkb,
                                           float sl2, int t4) {
  constexpr int NR = NQ / 2, NKQ = NQ / 16;
  float sT[NR], dT[NR];
  wa_zero(sT);
  wa_zero(dT);
  wg_reg_fence(sT);
  wg_reg_fence(dT);
  wa_fence();
#pragma unroll
  for (int kk = 0; kk < WA_DH / 16; ++kk) {
    const uint64_t dq_ = wg_desc(Qc + kk * 32, 16, 1024);
    const uint64_t dg_ = wg_desc(Gc + kk * 32, 16, 1024);
    if constexpr (NQ == 64) {
      wgmma_m64n64k16_rs<0>(sT, ka[kk], dq_);
      wgmma_m64n64k16_rs<0>(dT, va[kk], dg_);
    } else {
      wgmma_m64n16k16_rs<0>(sT, ka[kk], dq_);
      wgmma_m64n16k16_rs<0>(dT, va[kk], dg_);
    }
  }
  wa_commit_wait();
  wg_reg_fence(sT);
  wg_reg_fence(dT);
  unsigned pT[NKQ][4], dsT[NKQ][4];
#pragma unroll
  for (int j = 0; j < NQ / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float4 q = stc[8 * j + 2 * t4 + e];
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const int i = 4 * j + 2 * w + e;
        const float pv = (w ? jb : ja) < S
            ? exp2f(fmaf(sT[i], sl2, w ? mkb : mka) - q.x) * q.y : 0.f;
        sT[i] = pv;
        dT[i] = pv * (dT[i] - q.z);
      }
    }
#pragma unroll
  for (int kq = 0; kq < NKQ; ++kq)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = 8 * kq + 2 * x;
      pT[kq][x] = pack_bf16(sT[i], sT[i + 1]);
      dsT[kq][x] = pack_bf16(dT[i], dT[i + 1]);
    }
  wg_reg_fence(dk);
  wg_reg_fence(dv);
  wg_reg_fence_a(pT);
  wg_reg_fence_a(dsT);
  wa_fence();
  wa_rs<NKQ>(dv, pT, Gc);
  wa_rs<NKQ>(dk, dsT, Qc);
  wa_commit_wait();
  wg_reg_fence(dk);
  wg_reg_fence(dv);
}

template <int WIN, bool PRE>
__global__ void __launch_bounds__(WA_BWD_THREADS, 1)
attn_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_qkv,
                      const __grid_constant__ CUtensorMap tm_g,
                      const bf16* __restrict__ qkv, const bf16* __restrict__ kvp,
                      const float* __restrict__ mask,
                      bf16* __restrict__ dqkv16, bf16* __restrict__ dkvp16,
                      float* __restrict__ qpart, float* __restrict__ kvpart,
                      int T, int P, int D, float scale) {
  constexpr int NT = wa_tiles(WIN), NJ = WIN / 8, NK = WIN / 16;
  extern __shared__ __align__(1024) unsigned char wa_smem[];
  unsigned char* Qs = wa_base(wa_smem);
  unsigned char* Ks = Qs + NT * WA_BOX;
  unsigned char* Vs = Ks + NT * WA_BOX;
  unsigned char* Gs = Vs + NT * WA_BOX;          // dctx
  float4* st = reinterpret_cast<float4*>(Gs + NT * WA_BOX);   // per query
  float* red = reinterpret_cast<float*>(st + NT * WA_TILE);   // [3][2][64]
  float* dqx = red + 3 * 2 * WA_TILE;            // the halves' dq partials
  uint64_t* bar = reinterpret_cast<uint64_t*>(dqx + 32 * 128);
  float* ml = reinterpret_cast<float*>(bar + 1 + NT);   // PRE: the key row
  const int hd = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  if constexpr (!PRE) P = 0;
  const int S = P + T, col = hd * WA_DH;
  const int nq = (T + WA_TILE - 1) / WA_TILE;    // query tiles
  const int R0 = wa_r0(PRE, P), tok0 = R0 - P;
  // the token boxes of K (and V), rows [R0, TB)
  const int nkb = wa_boxes(T, tok0, R0, NT * WA_TILE), TB = R0 + nkb * WA_TILE;
  // the loads in flight first (K and V whole on bar 0, then Q and dctx a
  // tile at a time), then the rows they do not write (as the forward's)
  if (tid == 0) {
    for (int i = 0; i <= nq; ++i) mbar_init(bar + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar, 2 * nkb * WA_BOX);
    for (int t = 0; t < nkb; ++t) {
      tma_load3(Ks + R0 * 128 + t * WA_BOX, &tm_qkv, bar, D + col,
                tok0 + t * WA_TILE, b);
      tma_load3(Vs + R0 * 128 + t * WA_BOX, &tm_qkv, bar, 2 * D + col,
                tok0 + t * WA_TILE, b);
    }
    for (int t = 0; t < nq; ++t) {
      mbar_expect_tx(bar + 1 + t, 2 * WA_BOX);
      tma_load3(Qs + t * WA_BOX, &tm_qkv, bar + 1 + t, col, t * WA_TILE, b);
      tma_load3(Gs + t * WA_BOX, &tm_g, bar + 1 + t, col, t * WA_TILE, b);
    }
  }
  if constexpr (PRE)
    wa_prefix_rows(Ks, Vs, ml, qkv, kvp, mask, b, T, P, D, col, R0, TB,
                   NT * WA_TILE, tid, WA_BWD_THREADS);
  else
    wa_zero_tiles(Ks, Vs, nkb, NT, tid, WA_BWD_THREADS);
  __syncthreads();
  // this warpgroup's half of the keys: [kb, lim), its window [kb, kb + WIN)
  const int npair = (S + 15) / 16, kb1 = 16 * ((npair + 1) / 2);
  const int kb = wg ? kb1 : 0, lim = wg ? S : min(kb1, S);
  const int nqg = (T + 15) / 16;                 // 16-query groups
  const float sl2 = scale * LOG2E;
  const size_t rs = 3 * (size_t)D;
  const int ra = 16 * warp + g;   // the thread's rows ra, ra + 8 of a tile
  float* mine = red + wg * WA_TILE;
  const float* other = red + (wg ^ 1) * WA_TILE;
  wa_wait(bar);

  // phase 1: dq and the row statistics, query tile by query tile
  for (int qt = 0; qt < nq; ++qt) {
    wa_wait(bar + 1 + qt);
    float s[WIN / 2], dp[WIN / 2];
    wa_zero(s);
    wa_zero(dp);
    wg_reg_fence(s);
    wg_reg_fence(dp);
    wa_fence();
    wa_scores<WIN>(s, Qs + qt * WA_BOX, Ks + kb * 128);
    wa_scores<WIN>(dp, Gs + qt * WA_BOX, Vs + kb * 128);
    wa_commit_wait();
    wg_reg_fence(s);
    wg_reg_fence(dp);
    // scale in base 2, plus the key row's log2(e) mask (PRE), -inf past
    // the half's keys; this half's row max, then both halves'
    float ma = -INFINITY, mb = -INFINITY;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = kb + 8 * j + 2 * t4 + e;
        const bool on = k < lim;
        const float mk = PRE ? ml[k] : 0.f;
        s[4 * j + e] = on ? fmaf(s[4 * j + e], sl2, mk) : -INFINITY;
        s[4 * j + 2 + e] = on ? fmaf(s[4 * j + 2 + e], sl2, mk) : -INFINITY;
        ma = fmaxf(ma, s[4 * j + e]);
        mb = fmaxf(mb, s[4 * j + 2 + e]);
      }
    ma = quad_max(ma);
    mb = quad_max(mb);
    if (t4 == 0) {
      mine[ra] = ma;
      mine[ra + 8] = mb;
    }
    wa_sync();
    ma = fmaxf(ma, other[ra]);
    mb = fmaxf(mb, other[ra + 8]);
    // e = exp(s - max), this half's row sum l and t = sum(dp e), then both
    // halves': delta = rowsum(dp p) = t / l
    float la = 0.f, lb = 0.f, ta = 0.f, tb = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[4 * j + e] = exp2f(s[4 * j + e] - ma);
        s[4 * j + 2 + e] = exp2f(s[4 * j + 2 + e] - mb);
        la += s[4 * j + e];
        lb += s[4 * j + 2 + e];
        ta = fmaf(dp[4 * j + e], s[4 * j + e], ta);
        tb = fmaf(dp[4 * j + 2 + e], s[4 * j + 2 + e], tb);
      }
    la = quad_sum(la);
    lb = quad_sum(lb);
    ta = quad_sum(ta);
    tb = quad_sum(tb);
    if (t4 == 0) {
      mine[2 * WA_TILE + ra] = la;
      mine[2 * WA_TILE + ra + 8] = lb;
      mine[4 * WA_TILE + ra] = ta;
      mine[4 * WA_TILE + ra + 8] = tb;
    }
    wa_sync();
    la += other[2 * WA_TILE + ra];
    lb += other[2 * WA_TILE + ra + 8];
    ta += other[4 * WA_TILE + ra];
    tb += other[4 * WA_TILE + ra + 8];
    const float ila = 1.f / la, ilb = 1.f / lb;
    const float dla = ta * ila, dlb = tb * ilb;
    // ds16 = bf16(p (dp - delta)), p = e / l in fp32, as the A fragments of
    // this half's dq = ds16 k
    unsigned ds[NK][4];
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int i = 8 * kk + 2 * x;
        const float il = (x & 1) ? ilb : ila, dl = (x & 1) ? dlb : dla;
        const float p0 = s[i] * il, p1 = s[i + 1] * il;
        ds[kk][x] = pack_bf16(p0 * (dp[i] - dl), p1 * (dp[i + 1] - dl));
      }
    float dq[32];
    wa_zero(dq);
    wg_reg_fence(dq);
    wg_reg_fence_a(ds);
    wa_fence();
    wa_rs<NK>(dq, ds, Ks + kb * 128);
    wa_commit_wait();
    wg_reg_fence(dq);
    float v[32];
    wg_read(v, dq);
    // each warpgroup finishes half of dq's columns (8-column tiles 4 wg ..
    // 4 wg + 3, accumulators 16 wg ..): it hands the other its partial of
    // the other's half (compile-time indices, selected by wg)
#pragma unroll
    for (int i = 0; i < 16; ++i) dqx[(16 * wg + i) * 128 + wt] = wg ? v[i] : v[16 + i];
    wa_sync();
    const int ia = qt * WA_TILE + ra, ib = ia + 8, grp = qt * 4 + warp;
    const float* part = dqx + 16 * (wg ^ 1) * 128 + wt;   // the other's partial
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {   // dq of both halves (a + b == b + a), scaled, once
      const int c = hd * WA_DH + 8 * (4 * wg + jj) + 2 * t4;
      float c0 = 0.f, c1 = 0.f;   // the group's column sums (qpart)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = h ? ib : ia, x = 4 * jj + 2 * h;
        if (i >= T) continue;
        const float own0 = wg ? v[16 + x] : v[x], own1 = wg ? v[17 + x] : v[x + 1];
        const float v0 = (own0 + part[x * 128]) * scale;
        const float v1 = (own1 + part[(x + 1) * 128]) * scale;
        *reinterpret_cast<unsigned*>(dqkv16 + ((size_t)b * T + i) * rs + c) =
            pack_bf16(v0, v1);
        c0 += v0;
        c1 += v1;
      }
      if (qpart && grp < nqg)
        group_colsum(qpart + ((size_t)b * nqg + grp) * D + c, c0, c1, lane);
    }
    if (wg == 0 && t4 == 0) {   // a query past T: p = 0 in phase 2
      st[ia] = ia < T ? make_float4(ma, ila, dla, 0.f)
                      : make_float4(INFINITY, 0.f, 0.f, 0.f);
      st[ib] = ib < T ? make_float4(mb, ilb, dlb, 0.f)
                      : make_float4(INFINITY, 0.f, 0.f, 0.f);
    }
  }
  wa_sync();   // every query's statistics

  // phase 2: dk and dv, key tile by key tile, the queries in order: whole
  // 64-query tiles, then the 16-query blocks past the last whole tile (at
  // T = 197 one block, not a tile of 64 mostly past T)
  const int nfull = T / WA_TILE, n16 = (T + 15) / 16;
  const int nkt = (S + WA_TILE - 1) / WA_TILE;   // key tiles
  for (int kt = wg; kt < nkt; kt += 2) {
    float dk[32], dv[32];
    wa_zero(dk);
    wa_zero(dv);
    const int ja = kt * WA_TILE + ra, jb = ja + 8;   // the thread's keys
    const float mka = PRE && ja < S ? ml[ja] : 0.f;
    const float mkb = PRE && jb < S ? ml[jb] : 0.f;
    unsigned ka[4][4], va[4][4];
    wa_frags(ka, Ks + kt * WA_BOX, warp, lane);
    wa_frags(va, Vs + kt * WA_BOX, warp, lane);
    for (int c = 0; c < nfull; ++c)
      wa_kv_step<64>(dk, dv, ka, va, Qs + c * WA_BOX, Gs + c * WA_BOX,
                     st + c * WA_TILE, ja, jb, S, mka, mkb, sl2, t4);
    for (int q = 4 * nfull; q < n16; ++q)
      wa_kv_step<16>(dk, dv, ka, va, Qs + q * 2048, Gs + q * 2048, st + 16 * q,
                     ja, jb, S, mka, mkb, sl2, t4);
    float kv[32], vv[32];
    wg_read(kv, dk);
    wg_read(vv, dv);
    const int grp = kt * 4 + warp;
#pragma unroll
    for (int j = 0; j < WA_DH / 8; ++j) {
      const int c = hd * WA_DH + 8 * j + 2 * t4;
      float ck0 = 0.f, ck1 = 0.f, cv0 = 0.f, cv1 = 0.f;   // column sums
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = h ? jb : ja, x = 4 * j + 2 * h;
        if (key >= S) continue;
        const float k0v = kv[x] * scale, k1v = kv[x + 1] * scale;
        const float w0 = vv[x], w1 = vv[x + 1];
        // a prefix key: (B*P, 2D), dK at 0, dV at D; a token key: (B*T,
        // 3D), dK at D, dV at 2D
        bf16* o16 = PRE && key < P
            ? dkvp16 + ((size_t)b * P + key) * 2 * D + c
            : dqkv16 + ((size_t)b * T + key - P) * rs + D + c;
        *reinterpret_cast<unsigned*>(o16) = pack_bf16(k0v, k1v);
        *reinterpret_cast<unsigned*>(o16 + D) = pack_bf16(w0, w1);
        ck0 += k0v;
        ck1 += k1v;
        cv0 += w0;
        cv1 += w1;
      }
      // the key group's sums of dk and dv, prefix and token keys alike:
      // row b * npair + grp of (B * ceil(S/16), 2D)
      if (kvpart && grp < npair) {
        float* row = kvpart + ((size_t)b * npair + grp) * 2 * D + c;
        group_colsum(row, ck0, ck1, lane);
        group_colsum(row + D, cv0, cv1, lane);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Past 256 keys with no mask at head dim 64 (attn_wgmma_long_road, up to
// ATTN_WGMMA_LONG_TMAX keys: ViT-L/14's 257 tokens, at the train step's 64
// rows and the pipeline stage's 16-row microbatch). The half-row windows
// above stop at 128 keys a half (a 257th key needs 144-key windows: more
// registers than the backward has, and another order of sums), so these
// kernels keep the order of the mma.sync tiled road they replace there
// (attn_fwd_tiled_kernel, attn_bwd_dq_tiled_kernel, attn_bwd_dkv_kernel in
// fused_block_attn.cu, which stream K and V from device memory twice a
// kernel and read Q, K, V and dctx again in the dk/dv kernel). A 64-query
// wgmma tile of 128 threads has that road's geometry, 4 warps x 16 rows,
// and the m64nN accumulator gives each thread the m16n8k16 fragments, so
// the sums run as that road's, tile by tile:
//   * Forward (attn_fwd_wgmma_long_kernel): a block of two warpgroups, a
//     64-query tile each, holds the (batch row, head)'s K and V whole (by
//     TMA, once). Pass 1 over the 64-key tiles in order: the running row
//     max and the row sum brought to each new max (l *= exp2(m - m_new));
//     pass 2 recomputes the scores, p = exp2(s - m) (1 / l) in fp32, rounded
//     once to bf16, and o += p16 v tile by tile (p the register A operand).
//   * Backward (attn_bwd_wgmma_long_kernel): a block of two warpgroups a
//     (head, batch row) holds Q, K, V and dctx whole. Phase 1: the query
//     tiles go to the warpgroups in turn; each runs over every key tile in
//     attn_bwd_dq_tiled_kernel's order (the row max, l and t = sum(dp e)
//     brought to each new max, delta = t / l; then ds16 = bf16(p (dp -
//     delta)) and dq += ds16 k tile by tile) and leaves each query's (max,
//     1 / l, delta) in shared memory, announced on the tile's barrier.
//     Phase 2: the key tiles (the warpgroup with fewer query tiles first),
//     each over the queries in attn_bwd_dkv_kernel's order (wa_kv_step),
//     a query tile's statistics awaited on its barrier, so one warpgroup's
//     phase 2 overlaps the other's last query tile. No atomics.
//   * The last key tile: its live 16-key chunks only (LASTN keys: an
//     m64nLASTN product for the scores, LASTN / 16 k16 steps of p v and ds
//     k), as the tiled road skips the chunks at or past S - k0.
// Bound on an H100 SXM: bytes. At ViT-L/14's shape (64 x 257 x 1024, 16
// heads) the forward reads qkv16 and writes ctx16 (135 MB, 0.0402 ms) for
// 4.3 GFLOP; the backward reads qkv16 and dctx16 and writes dqkv16 (236 MB,
// 0.0704 ms) for 10.8 GFLOP (chip_smoke.attention_cost).
// ---------------------------------------------------------------------------
constexpr int WL_FWD_THREADS = 256;   // two warpgroups, a query tile each

// The live keys of the last 64-key tile, rounded up to 16: the width of its
// products (16, 32, 48 or 64).
__host__ __device__ constexpr int wl_lastn(int T) {
  return (T - (T - 1) / WA_TILE * WA_TILE + 15) / 16 * 16;
}

// s (64 x N) = scale log2(e) q k^T for N keys of the 64-key tile at k0
// (fmaf(s, sl2, 0): the tiled road's with no mask); in the last tile
// (EDGE) -inf past the S keys, which no other tile holds.
template <int N, bool EDGE>
__device__ __forceinline__ void wl_scale(float (&s)[N / 2], int k0, int S,
                                         float sl2, int t4) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = k0 + 8 * j + 2 * t4 + (e & 1);
      s[4 * j + e] = !EDGE || k < S ? fmaf(s[4 * j + e], sl2, 0.f)
                                    : -INFINITY;
    }
}

template <int N, bool EDGE>
__device__ __forceinline__ void wl_scores(float (&s)[N / 2],
                                          const unsigned char* Qt,
                                          const unsigned char* Kt, int k0,
                                          int S, float sl2, int t4) {
  wa_zero(s);
  wg_reg_fence(s);
  wa_fence();
  wa_scores<N>(s, Qt, Kt);
  wa_commit_wait();
  wg_reg_fence(s);
  wl_scale<N, EDGE>(s, k0, S, sl2, t4);
}

// The forward's pass 1 over N keys of a tile: the row max m and the row sum
// l (this thread's columns) brought to the new max, as attn_fwd_tiled's
// (every row has key 0, so the new max is finite and l *= exp2(-inf) = 0
// at the first tile).
template <int N, bool EDGE>
__device__ __forceinline__ void wl_fwd_stats(float (&m)[2], float (&l)[2],
                                             const unsigned char* Qt,
                                             const unsigned char* Kt, int k0,
                                             int S, float sl2, int t4) {
  float s[N / 2];
  wl_scores<N, EDGE>(s, Qt, Kt, k0, S, sl2, t4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float cm = -INFINITY;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      cm = fmaxf(cm, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
    const float mn = fmaxf(m[h], quad_max(cm));
    l[h] *= exp2f(m[h] - mn);
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      l[h] += exp2f(s[4 * j + 2 * h] - mn) + exp2f(s[4 * j + 2 * h + 1] - mn);
    m[h] = mn;
  }
}

// The forward's pass 2 over N keys of a tile: p = exp2(s - m) (1 / l) in
// fp32, rounded to bf16 as the A fragments, o += p16 v.
template <int N, bool EDGE>
__device__ __forceinline__ void wl_fwd_pv(float (&o)[32], const float (&m)[2],
                                          const float (&il)[2],
                                          const unsigned char* Qt,
                                          const unsigned char* Kt,
                                          const unsigned char* Vt, int k0,
                                          int S, float sl2, int t4) {
  float s[N / 2];
  wl_scores<N, EDGE>(s, Qt, Kt, k0, S, sl2, t4);
  unsigned p[N / 16][4];
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = 8 * kk + 2 * x, h = x & 1;
      p[kk][x] = pack_bf16(exp2f(s[i] - m[h]) * il[h],
                           exp2f(s[i + 1] - m[h]) * il[h]);
    }
  wg_reg_fence(o);
  wg_reg_fence_a(p);
  wa_fence();
  wa_rs<N / 16>(o, p, Vt);
  wa_commit_wait();
  wg_reg_fence(o);
}

template <int LASTN>
__global__ void __launch_bounds__(WL_FWD_THREADS, 2)
attn_fwd_wgmma_long_kernel(const __grid_constant__ CUtensorMap tm_qkv,
                           bf16* __restrict__ ctx, int T, int D, float scale) {
  extern __shared__ __align__(1024) unsigned char wa_smem[];
  const int nt = (T + WA_TILE - 1) / WA_TILE;      // key (and query) tiles
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int hd = blockIdx.y, b = blockIdx.z, col = hd * WA_DH;
  const int q0 = 2 * blockIdx.x, nqb = min(2, nt - q0);   // its query tiles
  unsigned char* Qs = wa_base(wa_smem);            // 2 tiles
  unsigned char* Ks = Qs + 2 * WA_BOX;
  unsigned char* Vs = Ks + nt * WA_BOX;
  uint64_t* bar = reinterpret_cast<uint64_t*>(Vs + nt * WA_BOX);   // Q + K, V
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar, (nqb + nt) * WA_BOX);
    for (int i = 0; i < nqb; ++i)
      tma_load3(Qs + i * WA_BOX, &tm_qkv, bar, col, (q0 + i) * WA_TILE, b);
    for (int t = 0; t < nt; ++t)
      tma_load3(Ks + t * WA_BOX, &tm_qkv, bar, D + col, t * WA_TILE, b);
    mbar_expect_tx(bar + 1, nt * WA_BOX);
    for (int t = 0; t < nt; ++t)
      tma_load3(Vs + t * WA_BOX, &tm_qkv, bar + 1, 2 * D + col, t * WA_TILE,
                b);
  }
  __syncthreads();
  if (wg >= nqb) return;   // the last block of an odd count: one tile
  const int qt = q0 + wg;
  const unsigned char* Qt = Qs + wg * WA_BOX;
  const float sl2 = scale * LOG2E;
  const int kl = (nt - 1) * WA_TILE;               // the last key tile
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  wa_wait(bar);
  for (int kt = 0; kt + 1 < nt; ++kt)
    wl_fwd_stats<64, false>(m, l, Qt, Ks + kt * WA_BOX, kt * WA_TILE, T, sl2,
                            t4);
  wl_fwd_stats<LASTN, true>(m, l, Qt, Ks + kl * 128, kl, T, sl2, t4);
  float il[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) il[h] = 1.f / quad_sum(l[h]);
  float o[32];
  wa_zero(o);
  wa_wait(bar + 1);
  for (int kt = 0; kt + 1 < nt; ++kt)
    wl_fwd_pv<64, false>(o, m, il, Qt, Ks + kt * WA_BOX, Vs + kt * WA_BOX,
                         kt * WA_TILE, T, sl2, t4);
  wl_fwd_pv<LASTN, true>(o, m, il, Qt, Ks + kl * 128, Vs + kl * 128, kl, T,
                         sl2, t4);
  float v[32];
  wg_read(v, o);
  const int ia = qt * WA_TILE + 16 * warp + g, ib = ia + 8;
#pragma unroll
  for (int j = 0; j < WA_DH / 8; ++j) {
    const int c = col + 8 * j + 2 * t4;
    if (ia < T)
      *reinterpret_cast<unsigned*>(ctx + ((size_t)b * T + ia) * D + c) =
          pack_bf16(v[4 * j], v[4 * j + 1]);
    if (ib < T)
      *reinterpret_cast<unsigned*>(ctx + ((size_t)b * T + ib) * D + c) =
          pack_bf16(v[4 * j + 2], v[4 * j + 3]);
  }
}

// s = q k^T (scaled as wl_scale) and dp = dctx v^T for N keys of a tile.
template <int N, bool EDGE>
__device__ __forceinline__ void wl_products(float (&s)[N / 2],
                                            float (&dp)[N / 2],
                                            const unsigned char* Qt,
                                            const unsigned char* Gt,
                                            const unsigned char* Kt,
                                            const unsigned char* Vt, int k0,
                                            int S, float sl2, int t4) {
  wa_zero(s);
  wa_zero(dp);
  wg_reg_fence(s);
  wg_reg_fence(dp);
  wa_fence();
  wa_scores<N>(s, Qt, Kt);
  wa_scores<N>(dp, Gt, Vt);
  wa_commit_wait();
  wg_reg_fence(s);
  wg_reg_fence(dp);
  wl_scale<N, EDGE>(s, k0, S, sl2, t4);
}

// The backward's phase 1, pass 1 over N keys of a tile: the row max m, l
// and t = sum(dp e) brought to the new max, as attn_bwd_dq_tiled's.
template <int N, bool EDGE>
__device__ __forceinline__ void wl_bwd_stats(float (&m)[2], float (&l)[2],
                                             float (&t)[2],
                                             const unsigned char* Qt,
                                             const unsigned char* Gt,
                                             const unsigned char* Kt,
                                             const unsigned char* Vt, int k0,
                                             int S, float sl2, int t4) {
  float s[N / 2], dp[N / 2];
  wl_products<N, EDGE>(s, dp, Qt, Gt, Kt, Vt, k0, S, sl2, t4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float cm = -INFINITY;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      cm = fmaxf(cm, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
    const float mn = fmaxf(m[h], quad_max(cm));
    const float f = exp2f(m[h] - mn);   // 0 at the first tile
    l[h] *= f;
    t[h] *= f;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float ev = exp2f(s[4 * j + 2 * h + e] - mn);
        l[h] += ev;
        t[h] = fmaf(dp[4 * j + 2 * h + e], ev, t[h]);
      }
    m[h] = mn;
  }
}

// The backward's phase 1, pass 2 over N keys of a tile: ds16 = bf16(p (dp -
// delta)), p = exp2(s - m) (1 / l) in fp32, as the A fragments of dq +=
// ds16 k.
template <int N, bool EDGE>
__device__ __forceinline__ void wl_bwd_dq(float (&dq)[32], const float (&m)[2],
                                          const float (&il)[2],
                                          const float (&dl)[2],
                                          const unsigned char* Qt,
                                          const unsigned char* Gt,
                                          const unsigned char* Kt,
                                          const unsigned char* Vt, int k0,
                                          int S, float sl2, int t4) {
  float s[N / 2], dp[N / 2];
  wl_products<N, EDGE>(s, dp, Qt, Gt, Kt, Vt, k0, S, sl2, t4);
  unsigned ds[N / 16][4];
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = 8 * kk + 2 * x, h = x & 1;
      const float p0 = exp2f(s[i] - m[h]) * il[h] * (dp[i] - dl[h]);
      const float p1 = exp2f(s[i + 1] - m[h]) * il[h] * (dp[i + 1] - dl[h]);
      ds[kk][x] = pack_bf16(p0, p1);
    }
  wg_reg_fence(dq);
  wg_reg_fence_a(ds);
  wa_fence();
  wa_rs<N / 16>(dq, ds, Kt);
  wa_commit_wait();
  wg_reg_fence(dq);
}

template <int LASTN>
__global__ void __launch_bounds__(WA_BWD_THREADS, 1)
attn_bwd_wgmma_long_kernel(const __grid_constant__ CUtensorMap tm_qkv,
                           const __grid_constant__ CUtensorMap tm_g,
                           bf16* __restrict__ dqkv16,
                           float* __restrict__ qpart,
                           float* __restrict__ kvpart, int T, int D,
                           float scale) {
  extern __shared__ __align__(1024) unsigned char wa_smem[];
  const int nt = (T + WA_TILE - 1) / WA_TILE;      // query (and key) tiles
  unsigned char* Qs = wa_base(wa_smem);
  unsigned char* Ks = Qs + nt * WA_BOX;
  unsigned char* Vs = Ks + nt * WA_BOX;
  unsigned char* Gs = Vs + nt * WA_BOX;            // dctx
  float4* st = reinterpret_cast<float4*>(Gs + nt * WA_BOX);   // per query
  // bar[0]: K and V; bar[1 + i]: query tile i's Q and dctx; bar[1 + nt +
  // i]: its statistics, arrived at by the 128 threads of its warpgroup
  uint64_t* bar = reinterpret_cast<uint64_t*>(st + nt * WA_TILE);
  const int hd = blockIdx.x, b = blockIdx.y, col = hd * WA_DH;
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  if (tid == 0) {
    for (int i = 0; i <= nt; ++i) mbar_init(bar + i, 1);
    for (int i = 0; i < nt; ++i) mbar_init(bar + 1 + nt + i, 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar, 2 * nt * WA_BOX);
    for (int t = 0; t < nt; ++t) {
      tma_load3(Ks + t * WA_BOX, &tm_qkv, bar, D + col, t * WA_TILE, b);
      tma_load3(Vs + t * WA_BOX, &tm_qkv, bar, 2 * D + col, t * WA_TILE, b);
    }
    for (int t = 0; t < nt; ++t) {
      mbar_expect_tx(bar + 1 + t, 2 * WA_BOX);
      tma_load3(Qs + t * WA_BOX, &tm_qkv, bar + 1 + t, col, t * WA_TILE, b);
      tma_load3(Gs + t * WA_BOX, &tm_g, bar + 1 + t, col, t * WA_TILE, b);
    }
  }
  __syncthreads();
  const int nqg = (T + 15) / 16;                   // 16-row groups
  const int kl = (nt - 1) * WA_TILE;               // the last key tile
  const float sl2 = scale * LOG2E;
  const size_t rs = 3 * (size_t)D;
  const int ra = 16 * warp + g;   // the thread's rows ra, ra + 8 of a tile
  wa_wait(bar);

  // phase 1: dq and the row statistics, the query tiles in turn
  for (int qt = wg; qt < nt; qt += 2) {
    wa_wait(bar + 1 + qt);
    const unsigned char* Qt = Qs + qt * WA_BOX;
    const unsigned char* Gt = Gs + qt * WA_BOX;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, t[2] = {0.f, 0.f};
    for (int kt = 0; kt + 1 < nt; ++kt)
      wl_bwd_stats<64, false>(m, l, t, Qt, Gt, Ks + kt * WA_BOX,
                              Vs + kt * WA_BOX, kt * WA_TILE, T, sl2, t4);
    wl_bwd_stats<LASTN, true>(m, l, t, Qt, Gt, Ks + kl * 128, Vs + kl * 128,
                              kl, T, sl2, t4);
    float il[2], dl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      il[h] = 1.f / quad_sum(l[h]);
      dl[h] = quad_sum(t[h]) * il[h];
    }
    float dq[32];
    wa_zero(dq);
    for (int kt = 0; kt + 1 < nt; ++kt)
      wl_bwd_dq<64, false>(dq, m, il, dl, Qt, Gt, Ks + kt * WA_BOX,
                           Vs + kt * WA_BOX, kt * WA_TILE, T, sl2, t4);
    wl_bwd_dq<LASTN, true>(dq, m, il, dl, Qt, Gt, Ks + kl * 128,
                           Vs + kl * 128, kl, T, sl2, t4);
    float v[32];
    wg_read(v, dq);
    const int ia = qt * WA_TILE + ra, ib = ia + 8, grp = qt * 4 + warp;
#pragma unroll
    for (int j = 0; j < WA_DH / 8; ++j) {
      const int c = col + 8 * j + 2 * t4;
      float c0 = 0.f, c1 = 0.f;   // the group's column sums (qpart)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = h ? ib : ia;
        if (i >= T) continue;
        const float v0 = v[4 * j + 2 * h] * scale;
        const float v1 = v[4 * j + 2 * h + 1] * scale;
        *reinterpret_cast<unsigned*>(dqkv16 + ((size_t)b * T + i) * rs + c) =
            pack_bf16(v0, v1);
        c0 += v0;
        c1 += v1;
      }
      if (qpart && grp < nqg)
        group_colsum(qpart + ((size_t)b * nqg + grp) * D + c, c0, c1, lane);
    }
    if (t4 == 0) {   // a query past T: p = 0 in phase 2
      st[ia] = ia < T ? make_float4(m[0], il[0], dl[0], 0.f)
                      : make_float4(INFINITY, 0.f, 0.f, 0.f);
      st[ib] = ib < T ? make_float4(m[1], il[1], dl[1], 0.f)
                      : make_float4(INFINITY, 0.f, 0.f, 0.f);
    }
    mbar_arrive(bar + 1 + nt + qt);
  }

  // phase 2: dk and dv, key tile by key tile, the queries in order: whole
  // 64-query tiles, then the 16-query blocks past the last whole tile;
  // each query tile's Q and dctx (loaded) and statistics (phase 1) awaited
  const int nfull = T / WA_TILE, n16 = (T + 15) / 16;
  for (int kt = wg ^ (nt & 1); kt < nt; kt += 2) {
    float dk[32], dv[32];
    wa_zero(dk);
    wa_zero(dv);
    const int ja = kt * WA_TILE + ra, jb = ja + 8;   // the thread's keys
    unsigned ka[4][4], va[4][4];
    wa_frags(ka, Ks + kt * WA_BOX, warp, lane);
    wa_frags(va, Vs + kt * WA_BOX, warp, lane);
    for (int c = 0; c < nfull; ++c) {
      wa_wait(bar + 1 + c);
      wa_wait(bar + 1 + nt + c);
      wa_kv_step<64>(dk, dv, ka, va, Qs + c * WA_BOX, Gs + c * WA_BOX,
                     st + c * WA_TILE, ja, jb, T, 0.f, 0.f, sl2, t4);
    }
    for (int q = 4 * nfull; q < n16; ++q) {
      wa_wait(bar + 1 + q / 4);
      wa_wait(bar + 1 + nt + q / 4);
      wa_kv_step<16>(dk, dv, ka, va, Qs + q * 2048, Gs + q * 2048, st + 16 * q,
                     ja, jb, T, 0.f, 0.f, sl2, t4);
    }
    float kv[32], vv[32];
    wg_read(kv, dk);
    wg_read(vv, dv);
    const int grp = kt * 4 + warp;
#pragma unroll
    for (int j = 0; j < WA_DH / 8; ++j) {
      const int c = col + 8 * j + 2 * t4;
      float ck0 = 0.f, ck1 = 0.f, cv0 = 0.f, cv1 = 0.f;   // column sums
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = h ? jb : ja, x = 4 * j + 2 * h;
        if (key >= T) continue;
        const float k0v = kv[x] * scale, k1v = kv[x + 1] * scale;
        const float w0 = vv[x], w1 = vv[x + 1];
        bf16* o16 = dqkv16 + ((size_t)b * T + key) * rs + D + c;
        *reinterpret_cast<unsigned*>(o16) = pack_bf16(k0v, k1v);
        *reinterpret_cast<unsigned*>(o16 + D) = pack_bf16(w0, w1);
        ck0 += k0v;
        ck1 += k1v;
        cv0 += w0;
        cv1 += w1;
      }
      // the key group's sums of dk and dv: row b * ceil(T/16) + grp of
      // (B * ceil(T/16), 2D)
      if (kvpart && grp < nqg) {
        float* row = kvpart + ((size_t)b * nqg + grp) * 2 * D + c;
        group_colsum(row, ck0, ck1, lane);
        group_colsum(row + D, cv0, cv1, lane);
      }
    }
  }
}

// Shared memory: the query tile, K and V (forward); Q, K, V, dctx, the
// statistics, the halves' exchange and the second half's dq (backward);
// the barriers; with a prefix (pre) the key row (256 floats; at WIN = 112
// the forward still fits three blocks an SM); 1024 bytes to align the
// tiles to the swizzle's period.
static size_t wa_fwd_smem(int win, bool pre) {
  return (size_t)WA_BOX * (1 + 2 * wa_tiles(win)) + 2 * 8 +
         (pre ? 256 * 4 : 0) + 1024;
}

static size_t wa_bwd_smem(int win, bool pre) {
  const int nt = wa_tiles(win);
  return (size_t)4 * nt * WA_BOX + (size_t)nt * WA_TILE * sizeof(float4) +
         3 * 2 * WA_TILE * sizeof(float) + 32 * 128 * sizeof(float) +
         (1 + nt) * 8 + (pre ? 256 * 4 : 0) + 1024;
}

// The forward over S = P + T keys (P = 0: no prefix, no mask).
template <bool PRE>
static int wa_fwd(const bf16* qkv, const bf16* kvp, const float* mask,
                  bf16* ctx, int B, int T, int P, int D, float scale,
                  cudaStream_t s) {
  if (!attn_wgmma_road(P + T, WA_DH) || T < 1 || B < 1 || D % WA_DH ||
      (PRE && (P < 1 || !kvp || !mask)))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm;
  int e = make_tma(&tm, qkv, 3LL * D, T, 3LL * D, WA_DH, WA_TILE, B,
                   3LL * D * T);
  if (e) return e;
  const int win = wa_win(P + T);
  auto kern = win == 128 ? attn_fwd_wgmma_kernel<128, PRE>
            : win == 112 ? attn_fwd_wgmma_kernel<112, PRE>
                         : attn_fwd_wgmma_kernel<64, PRE>;
  const size_t smem = wa_fwd_smem(win, PRE);
  raise_smem(kern, smem);
  kern<<<dim3((T + WA_TILE - 1) / WA_TILE, D / WA_DH, B), WA_FWD_THREADS, smem,
         s>>>(tm, qkv, kvp, mask, ctx, T, P, D, scale);
  return (int)cudaGetLastError();
}

// The backward: dq and the tokens' dk / dv into dqkv16, the prefix keys'
// into dkvp16 (PRE); bpart: dq's partials (B * ceil(T/16) rows of D), then
// dk | dv's (B * ceil(S/16) rows of 2D), or null.
template <bool PRE>
static int wa_bwd(const bf16* qkv, const bf16* kvp, const bf16* dctx,
                  const float* mask, bf16* dqkv16, bf16* dkvp16, float* bpart,
                  int B, int T, int P, int D, float scale, cudaStream_t s) {
  if (!attn_wgmma_road(P + T, WA_DH) || T < 1 || B < 1 || D % WA_DH ||
      (PRE && (P < 1 || !kvp || !mask || !dkvp16)))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tg;
  int e = make_tma(&tq, qkv, 3LL * D, T, 3LL * D, WA_DH, WA_TILE, B,
                   3LL * D * T);
  if (!e) e = make_tma(&tg, dctx, D, T, D, WA_DH, WA_TILE, B, (long long)D * T);
  if (e) return e;
  const int win = wa_win(P + T);
  auto kern = win == 128 ? attn_bwd_wgmma_kernel<128, PRE>
            : win == 112 ? attn_bwd_wgmma_kernel<112, PRE>
                         : attn_bwd_wgmma_kernel<64, PRE>;
  const size_t smem = wa_bwd_smem(win, PRE);
  raise_smem(kern, smem);
  float* kvpart = bpart ? bpart + (size_t)B * ((T + 15) / 16) * D : nullptr;
  kern<<<dim3(D / WA_DH, B), WA_BWD_THREADS, smem, s>>>(
      tq, tg, qkv, kvp, mask, dqkv16, dkvp16, bpart, kvpart, T, P, D, scale);
  return (int)cudaGetLastError();
}

int attn_wgmma_fwd(const bf16* qkv, bf16* ctx, int B, int T, int D,
                   float scale, cudaStream_t s) {
  return wa_fwd<false>(qkv, nullptr, nullptr, ctx, B, T, 0, D, scale, s);
}

int attn_wgmma_bwd(const bf16* qkv, const bf16* dctx, bf16* dqkv16,
                   float* bpart, int B, int T, int D, float scale,
                   cudaStream_t s) {
  return wa_bwd<false>(qkv, nullptr, dctx, nullptr, dqkv16, nullptr, bpart, B,
                       T, 0, D, scale, s);
}

int attn_wgmma_prefix_fwd(const bf16* qkv, const bf16* kvp, const float* mask,
                          bf16* ctx, int B, int T, int P, int D, float scale,
                          cudaStream_t s) {
  return wa_fwd<true>(qkv, kvp, mask, ctx, B, T, P, D, scale, s);
}

int attn_wgmma_prefix_bwd(const bf16* qkv, const bf16* kvp, const bf16* dctx,
                          const float* mask, bf16* dqkv16, bf16* dkvp16,
                          float* bpart, int B, int T, int P, int D,
                          float scale, cudaStream_t s) {
  return wa_bwd<true>(qkv, kvp, dctx, mask, dqkv16, dkvp16, bpart, B, T, P, D,
                      scale, s);
}

// The long road's shared memory: two query tiles and K and V whole
// (forward: two blocks an SM up to 320 keys, one at 321-384); Q, K, V and
// dctx whole and the statistics (backward); the barriers; 1024 bytes to
// align the tiles to the swizzle's period.
static size_t wl_fwd_smem(int nt) {
  return (size_t)WA_BOX * (2 + 2 * nt) + 2 * 8 + 1024;
}

static size_t wl_bwd_smem(int nt) {
  return (size_t)4 * nt * WA_BOX + (size_t)nt * WA_TILE * sizeof(float4) +
         (1 + 2 * (size_t)nt) * 8 + 1024;
}

int attn_wgmma_long_fwd(const bf16* qkv, bf16* ctx, int B, int T, int D,
                        float scale, cudaStream_t s) {
  if (!attn_wgmma_long_road(T, WA_DH) || B < 1 || D % WA_DH)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tm;
  const int e = make_tma(&tm, qkv, 3LL * D, T, 3LL * D, WA_DH, WA_TILE, B,
                         3LL * D * T);
  if (e) return e;
  const int lastn = wl_lastn(T), nt = (T + WA_TILE - 1) / WA_TILE;
  auto kern = lastn == 16 ? attn_fwd_wgmma_long_kernel<16>
            : lastn == 32 ? attn_fwd_wgmma_long_kernel<32>
            : lastn == 48 ? attn_fwd_wgmma_long_kernel<48>
                          : attn_fwd_wgmma_long_kernel<64>;
  const size_t smem = wl_fwd_smem(nt);
  raise_smem(kern, smem);
  kern<<<dim3((nt + 1) / 2, D / WA_DH, B), WL_FWD_THREADS, smem, s>>>(
      tm, ctx, T, D, scale);
  return (int)cudaGetLastError();
}

int attn_wgmma_long_bwd(const bf16* qkv, const bf16* dctx, bf16* dqkv16,
                        float* bpart, int B, int T, int D, float scale,
                        cudaStream_t s) {
  if (!attn_wgmma_long_road(T, WA_DH) || B < 1 || D % WA_DH)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tg;
  int e = make_tma(&tq, qkv, 3LL * D, T, 3LL * D, WA_DH, WA_TILE, B,
                   3LL * D * T);
  if (!e) e = make_tma(&tg, dctx, D, T, D, WA_DH, WA_TILE, B, (long long)D * T);
  if (e) return e;
  const int lastn = wl_lastn(T), nt = (T + WA_TILE - 1) / WA_TILE;
  auto kern = lastn == 16 ? attn_bwd_wgmma_long_kernel<16>
            : lastn == 32 ? attn_bwd_wgmma_long_kernel<32>
            : lastn == 48 ? attn_bwd_wgmma_long_kernel<48>
                          : attn_bwd_wgmma_long_kernel<64>;
  const size_t smem = wl_bwd_smem(nt);
  raise_smem(kern, smem);
  // bpart: dq's partials (B * ceil(T/16) rows of D), then dk | dv's (as
  // many rows of 2D), or null
  float* kvpart = bpart ? bpart + (size_t)B * ((T + 15) / 16) * D : nullptr;
  kern<<<dim3(D / WA_DH, B), WA_BWD_THREADS, smem, s>>>(tq, tg, dqkv16, bpart,
                                                        kvpart, T, D, scale);
  return (int)cudaGetLastError();
}
