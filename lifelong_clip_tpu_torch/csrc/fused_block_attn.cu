// Hand-written Hopper (sm_90a) kernels for the fused LN-attention half block
// y = x + out_proj(MHA(LN(x))), forward and backward, and its KV-prefix
// variant, whose keys and values also come from prompt tokens pk / pv.
//
// Replaces the Pallas TPU kernels of lifelong_clip_tpu/ops/fused_block_attn.py:
//   * _kernel            (:56, pallas_call at :161) -> the forward chain below
//   * _bwd_kernel        (:258, pallas_call at :478) -> the backward chain below
//   * _prefix_kernel     (:524, pallas_call at :631) -> the same chain with a
//     prefix GEMM and the PRE attention kernels (llc_attn_prefix_fwd)
//   * _prefix_bwd_kernel (:699, pallas_call at :897) -> the same backward with
//     the PRE attention backward (llc_attn_prefix_bwd)
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s), ViT-B/16 vision
// block at bs=64 (M = 64*197 rows, D = 768, 12 heads, LoRA r = 4):
//   forward   ~67.1 GFLOP, ~43 MB moved -> compute-bound, ~68 us
//   backward  ~127 GFLOP (weight_grads=False) -> compute-bound, ~128 us
// The prefix block at the mvp-clip shape (P = 20 prompt slots, S = 217 keys)
// adds the prefix rows' K/V projections and 20 more keys a score row: both
// directions stay compute-bound (chip_smoke.py computes the bound).
//
// Design:
//   * The TPU kernel kept h, qkv, scores and ctx in VMEM for one group of
//     batch rows. Here the op is a chain of kernels (forward: LN, the qkv
//     GEMM, attention, the out GEMM; backward: the dctx GEMM, attention,
//     the dh GEMM, LN, one launch of fixed-order sums) and those
//     intermediates (h16, qkv16, ctx16, dctx16, dqkv16, dh) go through
//     device memory: about (2 + 6 + 2) * M * D bytes extra per forward.
//   * The rank-r LoRA products (r <= 8, D a multiple of 128) are folded
//     into the GEMMs that stream their operands, where the TPU kernel
//     computed them in its body (_kernel:76-84, :117-126; _bwd_kernel:
//     355-374 and after :417): z = h A_in and z2 = ctx A_out, dz2 = s g
//     B_out^T and dz = s dqkv B_in^T are a narrow second wgmma (64 x 8)
//     on each A stage of the qkv, out, dctx and dh products, against F's
//     64 x 8 tile that TMA loads beside it (the LN forward writes A_in^T
//     and A_out^T for the forward's), each rounded to bf16 before the
//     epilogue multiplies it by the other factor, as JAX rounds it. The
//     four row contractions are fixed-order partials, one a 64-row block:
//     dB_out = s z2^T g and dB_in = s z^T dqkv from the dctx / dh tiles'
//     own A stages (each k-step's by one column tile of the row block, zin
//     loaded a tile ahead), dA_out = ctx^T dz2 and dA_in = h^T dz from the
//     tile's xa columns, which the ring loads after the tile's last
//     k-step; partial_sums_kernel adds them with the bias and LN partials.
//     No launch on the rank-r tiles and no split-K sum is left in the
//     chains; each rank-r launch had run at 2-13x its bytes (PERF.md).
//   * The projections, ~60% of the forward chain, are what bounds it by
//     operations, so they run on the tensor cores' full-rate path: a Hopper
//     GEMM (gemm_pingpong_kernel) on a warp-specialized ping-pong schedule:
//     a producer warpgroup keeps a ring of 128B-swizzled tiles in flight by
//     TMA (mbarriers), and two consumer warpgroups each own whole 128-row
//     output tiles (wgmma m64n128k16, both operands in shared memory), their
//     main loops in turn, so one tile's epilogue runs under the other
//     consumer's products; persistent over the output tiles. bf16 wgmma
//     reads K-major and MN-major tiles alike, so NN, NT and TN (the
//     operands' strides) need no transposing copy. The epilogue keeps the
//     TPU kernel's order (alpha * acc + bias + lscale * z16 @ L, then +
//     residual, one rounding), the tile's LoRA factors and bias staged in
//     shared memory. For bf16 output (every forward projection) it is
//     staged too: the residual tile comes in by TMA while the tile's
//     products run, the rounded tile goes out by TMA in whole rows; written
//     from the accumulators, two bf16 at a time, the residual and the
//     stores had cost the out projection more than its products. Split-K
//     (contractions over all B*T rows) writes fp32 partials that a second
//     pass sums in a fixed order: no atomics, results independent of launch
//     order, as the TPU kernel's sequential grid. The mma.sync tiles
//     (m16n8k16, 3-stage cp.async) stay for the unfolded road's rank-r LoRA
//     shapes (N <= 16: 64x16, M <= 16: 16x128); any other shape needs
//     operands TMA can read, which every caller's are. TMA maps and
//     shared-memory limits are set once and reused, so a launch costs the
//     host little beyond the launch itself.
//   * Attention at head dim 64 and up to 256 keys with no mask (every ViT
//     tower's blocks) or, with a KV prefix, under a key-mask row (the
//     prompted passes of mvp-clip, DualPrompt, MVP and ProtoCLIP's image
//     pass): the warpgroup-MMA kernels of attn_wgmma.cu (launch_attn), the
//     values of the mma.sync kernels below bit for bit. The other roads (a
//     2-D mask, a KV prefix with no mask, head dims 16 and 32, past 256
//     keys) run these:
//   * Attention forward (attn_fwd_kernel, S = P + T <= 256 keys): one block
//     per (head, batch row) loads the head's K and V once, in 64-row
//     cp.async chunks whose arrival the first q k^T products follow, and 4
//     warp pairs take the query rows 16 at a time, so a ragged last group
//     costs 16 rows, not a 64-row tile. Each warp of a pair keeps half of 16
//     whole score rows in registers, the row max and sum exchanged through
//     shared memory: the softmax is the exact full-row one (no online
//     rescaling), p = exp(s - max) / sum normalised in fp32 and rounded to
//     bf16 before p @ V, as _kernel:102-108. Above 256 keys a tiled road
//     (attn_fwd_tiled_kernel) streams K and V in 64-key tiles over two
//     passes (row max and sum, then p @ V with the same p), so no key count
//     is refused. Scores are bf16 q.k with fp32 accumulation, times
//     dh**-0.5, plus the additive mask. The prefix variant reads keys
//     0..P-1 from the prefix buffer and keys P..P+T-1 from the token qkv,
//     under a (T, P+T) mask.
//   * Attention backward: a dq kernel (the forward's shape up to 256 keys,
//     p and dp of a query group kept in a warp pair's registers; tiled
//     above) that saves each query's row max, 1 / row sum and
//     rowsum(dp * p), and a dk/dv kernel, one block per (head, batch row),
//     that holds the head's queries, dctx and those statistics in shared
//     memory and rebuilds p^T for 16-key groups without a division; all on
//     mma.sync, single bf16 roundings of p and ds as the TPU kernel. No
//     atomics. The prefix variant writes the prefix keys' dk/dv to a
//     (B*P, 2D) buffer, from which two GEMMs give dpk = dk16 @ W_k^T and
//     dpv = dv16 @ W_v^T (_prefix_bwd_kernel:843-852); the token rows fill
//     dqkv16, so dh is the one dqkv16 @ W_qkv^T GEMM (:854-857 up to
//     summation order).
//   * Under a (T, S) mask the prefix kernels skip what the mask kills. The
//     TPU kernels compute every tile; ProtoCLIP's block-diagonal suffix
//     mask leaves 5.6% of a 512 x 537 score matrix live, so the full sweep
//     was 20x (forward) and 63x (backward) its bound on an H100. Each op
//     call builds the mask's tile map on the card (mask_tile_map_kernel,
//     one byte per 16 x 16 block, no host sync); the tiled roads walk only
//     the 64-key tiles live for some row of a query tile and, inside them,
//     each warp only its live 16-key blocks; the register roads' warps skip
//     their dead 16-key tiles; the dk/dv kernel skips each key group's dead
//     32-query steps. Dead blocks hold p = 0 exactly, so the values are the
//     full sweep's bit for bit; a null map is the full sweep. The block op
//     under a (T, T) mask (the text tower's causal mask: 15 of 25 blocks
//     live at T = 77) takes the same kernels with P = 0 and a map built
//     once a tower pass. Blocks holding only +0.0 and -inf take their
//     entries from the map's words, not the fp32 mask; under a map the
//     register roads' warp pairs take the 16-key blocks in turn (a causal
//     group's live blocks split evenly) and the query groups heaviest
//     first, in a snake over the pairs.
//   * The backward chains read the forward's h16, z16, qkv16, ctx16, z2
//     (prefix: h16, qkv16, kvp16, ctx16), which the forward keeps for them.
//   * The weight grads (Finetuning's whole-tower step at 16 batch rows, 8 a
//     rank): the bias and LN grads are folded into the kernels that make
//     the rows. The dq and dk/dv kernels write the fp32 column sums of each
//     16-row group they store (group_colsum); the LN backward writes each
//     row's mean and rstd, and one column-parallel pass over dh, x and g
//     (ln_partials_kernel) the sums of dh * xhat, dh and g over chunks of
//     rows; one launch (partial_sums_kernel) adds every partial in a fixed
//     order: no fp32 copy of dqkv or dh * xhat, no column-sum passes over
//     (M, D) fp32 buffers, no float atomics. dW_qkv and dW_out split K only where their tiles
//     would leave SMs idle (the caller's cost model: dW_qkv unsplit on 108
//     tiles of 128 x 128, dW_out in 3 splits of 36), as deterministic as
//     before. The LN params and biases are read in their own dtype (bf16
//     or fp32), so no chain casts them first.
//   * Small batches: where B x H blocks leave SMs idle (16 or 8 batch rows:
//     192 or 96 blocks for 264 slots), the register-road attention kernels
//     split each (head, batch row) over blocks (attn_splits: a list
//     schedule of the latency-bound blocks), the forward and dq over their
//     16-row query groups, dk/dv over its key groups, each row's arithmetic
//     the unsplit road's bit for bit; and the dh product takes 128 x 64
//     tiles where 128 x 128 ones would run a second, mostly empty round
//     (150 tiles at 16 rows) and its long K pays for the smaller tiles.
//   * LN: the forward a warp a row; the backward whole rows by bulk async
//     copy into a ring of rows a warp (ln_bwd_bulk_kernel). The prefix
//     rows' keys and values (pk @ W_k + b_k, pv @ W_v + b_v, bias added
//     before the one bf16 rounding as
//     _prefix_kernel:553-562) are one more launch of the GEMM into a (B*P,
//     2D) buffer: N = 2D over W_qkv's adjacent K and V columns where pk
//     and pv are one tensor, else a grouped launch over the two.
//   * The ragged edge (T = 197 or 77, P = 20, not multiples of 16) is masked
//     in the kernels: padded keys get probability 0, padded queries are not
//     stored. A key the mask kills (-inf) gets p = 0 and dk = dv = 0 exactly:
//     the row max is taken after the mask is added, and the mask is only
//     ever added, never multiplied.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <functional>
#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>
#include <vector>

#include "hopper.cuh"
#include "mma.cuh"

typedef __nv_bfloat16 bf16;

// dtype codes shared with the Python wrapper
enum { DT_F32 = 0, DT_BF16 = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype(bfloat16)
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// LayerNorm forward (fp32 statistics, eps) -> h in bf16. One warp per row,
// the row in registers: lane l holds elements l, l + 32, ... (D <= 1024).
// The scale and bias are read in their own dtype G (fp32 or bf16), so the
// chain casts nothing before its first kernel.
// ---------------------------------------------------------------------------
constexpr int LN_THREADS = 256, LN_MAXK = 32;
constexpr int LN_ROWS = LN_THREADS / 32;   // rows a block (a warp each)

template <typename T, typename G>
__global__ void __launch_bounds__(LN_THREADS)
ln_fwd_kernel(const T* __restrict__ x, const G* __restrict__ gamma,
              const G* __restrict__ beta, bf16* __restrict__ h, int M,
              int D, float eps, const bf16* __restrict__ fa,
              const bf16* __restrict__ fb, bf16* __restrict__ ft, int R) {
  // with the LoRA fold (ft not null): the forward's LoRA factors A_in and
  // A_out (D x R) transposed into ft (2 x R x D), the K-contiguous F the
  // qkv and out GEMMs read by TMA, over the grid before its rows
  for (int i = blockIdx.x * LN_THREADS + threadIdx.x; ft && i < 2 * R * D;
       i += gridDim.x * LN_THREADS) {
    const int j = i / (R * D), n = i / D % R, k = i % D;
    ft[i] = (j ? fb : fa)[(size_t)k * R + n];
  }
  const int lane = threadIdx.x & 31;
  const size_t row = (size_t)blockIdx.x * LN_ROWS + (threadIdx.x >> 5);
  if (row >= (size_t)M) return;
  const T* xr = x + row * D;
  float v[LN_MAXK];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < LN_MAXK; ++k) {
    const int i = lane + 32 * k;
    v[k] = i < D ? to_f(xr[i]) : 0.f;
    s += v[k];
  }
  const float mean = warp_sum(s) / D;
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < LN_MAXK; ++k) {
    const float d = lane + 32 * k < D ? v[k] - mean : 0.f;
    q += d * d;
  }
  const float rstd = rsqrtf(warp_sum(q) / D + eps);
#pragma unroll
  for (int k = 0; k < LN_MAXK; ++k) {
    const int i = lane + 32 * k;
    if (i < D)
      h[row * D + i] = __float2bfloat16((v[k] - mean) * rstd * to_f(gamma[i]) +
                                        to_f(beta[i]));
  }
}

// ---------------------------------------------------------------------------
// LayerNorm backward plus the residual: dx = g + LN'(x)^T dh. Recomputes the
// statistics from x. With STATS (the weight grads) it also writes each
// row's (mean, rstd) for ln_partials_kernel.
// Bound by its bytes (x, dh in fp32, g in, dx out: 10 bytes an element in
// bf16; ViT-B/16's 12608 rows ~0.029 ms on an H100). Whole rows move by
// bulk async copy (cp.async.bulk, 1-D TMA): a persistent grid, one block an
// SM (two where they fit), each warp a ring of LNB_SLOTS rows in shared
// memory that its lane 0 keeps loading (x, dh and g of a row on the slot's
// mbarrier), so many rows' bytes are in flight for few registers; gamma is
// staged once a block as fp32; dx goes out whole by a bulk store from a
// row buffer of the warp. A warp takes rows w, w + W, ... (W warps in the
// grid). The arithmetic is the warp-per-row kernel's it replaced, from
// shared memory: lane l takes elements l + 32k, the same per-lane sums and
// warp_sum trees, so dx and the statistics are its values bit for bit
// (that kernel read each element by its own 2- or 4-byte load, re-read
// gamma for every row, and ran at 2x its bytes).
// ---------------------------------------------------------------------------
constexpr int LNB_SLOTS = 2, LNB_WARPS = 8;

// Row ``row`` of x, dh and g into the ring slot ``sl`` (one thread), counted
// by the slot's mbarrier.
template <typename T>
__device__ __forceinline__ void ln_fill(unsigned char* sl, uint64_t* bar,
                                        const T* x, const float* dh, const T* g,
                                        long long row, int D) {
  const unsigned xb = D * sizeof(T), hb = D * 4;
  mbar_expect_tx(bar, 2 * xb + hb);
  bulk_load(sl, x + row * D, xb, bar);
  bulk_load(sl + xb, dh + row * D, hb, bar);
  bulk_load(sl + xb + hb, g + row * D, xb, bar);
}

template <typename T, typename G, bool STATS>
__global__ void __launch_bounds__(32 * LNB_WARPS, 2)
ln_bwd_bulk_kernel(const T* __restrict__ x, const G* __restrict__ gamma,
              const float* __restrict__ dh, const T* __restrict__ g,
              T* __restrict__ dx, float2* __restrict__ stats, int M, int D,
              float eps) {
  extern __shared__ __align__(16) unsigned char lsm[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // the slots' mbarriers, gamma (fp32), then each warp's slots (x, dh, g of
  // a row) and its dx row
  uint64_t* bars = reinterpret_cast<uint64_t*>(lsm);
  float* gs = reinterpret_cast<float*>(lsm + LNB_WARPS * LNB_SLOTS * 8);
  const int xb = D * (int)sizeof(T), hb = D * 4, sb = 2 * xb + hb;
  unsigned char* ws = reinterpret_cast<unsigned char*>(gs + D) +
                      (size_t)warp * (LNB_SLOTS * sb + xb);
  T* dxs = reinterpret_cast<T*>(ws + LNB_SLOTS * sb);
  uint64_t* bar = bars + warp * LNB_SLOTS;
  const long long nw = (long long)gridDim.x * warps;
  const long long w0 = (long long)blockIdx.x * warps + warp;
  // lane 0 starts its warp's first rows, then the block stages gamma
  if (lane == 0) {
    for (int s = 0; s < LNB_SLOTS; ++s) mbar_init(bar + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < LNB_SLOTS; ++s)
      if (w0 + s * nw < M) ln_fill(ws + s * sb, bar + s, x, dh, g, w0 + s * nw, D);
  }
  for (int i = threadIdx.x; i < D; i += blockDim.x) gs[i] = to_f(gamma[i]);
  __syncthreads();
  int n = 0;   // the warp's rows so far
  for (long long row = w0; row < M; row += nw, ++n) {
    const int slot = n % LNB_SLOTS;
    mbar_wait(bar + slot, (n / LNB_SLOTS) & 1);
    const unsigned char* sl = ws + slot * sb;
    const T* xr = reinterpret_cast<const T*>(sl);
    const float* dhr = reinterpret_cast<const float*>(sl + xb);
    const T* gr = reinterpret_cast<const T*>(sl + xb + hb);
    float v[LN_MAXK], dxh[LN_MAXK];
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < LN_MAXK; ++k) {
      const int i = lane + 32 * k;
      v[k] = i < D ? to_f(xr[i]) : 0.f;
      dxh[k] = i < D ? dhr[i] * gs[i] : 0.f;
      s += v[k];
    }
    const float mean = warp_sum(s) / D;
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < LN_MAXK; ++k) {
      const float d = lane + 32 * k < D ? v[k] - mean : 0.f;
      q += d * d;
    }
    const float rstd = rsqrtf(warp_sum(q) / D + eps);
    if (STATS && lane == 0) stats[row] = make_float2(mean, rstd);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < LN_MAXK; ++k) {
      v[k] = (v[k] - mean) * rstd;   // xhat (unused past D)
      s1 += dxh[k];
      s2 += dxh[k] * v[k];
    }
    const float m1 = warp_sum(s1) / D;
    const float m2 = warp_sum(s2) / D;
    // the last row's store has read the dx buffer
    if (lane == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    __syncwarp();
#pragma unroll
    for (int k = 0; k < LN_MAXK; ++k) {
      const int i = lane + 32 * k;
      if (i >= D) continue;
      const float dxln = rstd * (dxh[k] - m1 - v[k] * m2);
      dxs[i] = from_f<T>(to_f(gr[i]) + dxln);
    }
    // every lane is done with the slot and the dx row is written: refill
    // the slot with the warp's row LNB_SLOTS on, and store the row
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) {
      if (row + LNB_SLOTS * nw < M)
        ln_fill(ws + slot * sb, bar + slot, x, dh, g, row + LNB_SLOTS * nw, D);
      bulk_store(dx + row * D, dxs, xb);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The LN grads' and the out-projection bias grad's column sums with the
// weight grads (the TPU kernel's dls, dlb and dbout, _bwd_kernel:436-438 and
// :325), with no (M, D) fp32 buffer: a thread a column of a chunk of
// consecutive rows adds dh * xhat (xhat from x and the row's (mean, rstd)
// the LN backward wrote, as it computes it), dh and g in row order into
// part[(q * gridDim.y + chunk) * D + c], q = 0, 1, 2: one pass over dh, x
// and g, coalesced along the columns, whose partials partial_sums_kernel
// adds in a fixed order. (Folded into the LN backward's warp-a-row layout
// these sums needed a transpose through shared memory and cost the 16-row
// chain more than this pass; PERF.md.)
constexpr int LN_PART_THREADS = 256, LN_PART_SLOTS = 264;

template <typename T>
__global__ void __launch_bounds__(LN_PART_THREADS)
ln_partials_kernel(const T* __restrict__ x, const float* __restrict__ dh,
                   const T* __restrict__ g, const float2* __restrict__ stats,
                   float* __restrict__ part, int M, int D, int rows) {
  const int c = blockIdx.x * LN_PART_THREADS + threadIdx.x;
  if (c >= D) return;
  const int r0 = blockIdx.y * rows, r1 = min(M, r0 + rows);
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
#pragma unroll 4
  for (int r = r0; r < r1; ++r) {
    const size_t o = (size_t)r * D + c;
    const float2 st = stats[r];
    const float d = dh[o];
    a0 += d * ((to_f(x[o]) - st.x) * st.y);
    a1 += d;
    a2 += to_f(g[o]);
  }
  const size_t n = (size_t)gridDim.y * D, o = (size_t)blockIdx.y * D + c;
  part[o] = a0;
  part[n + o] = a1;
  part[2 * n + o] = a2;
}

// ---------------------------------------------------------------------------
// Small helpers: cast to bf16, the weight grads' column sums, split-K
// reduction.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void cast_bf16_kernel(const T* __restrict__ x, bf16* __restrict__ y,
                                 size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    y[i] = __float2bfloat16(to_f(x[i]));
}

// The bias and LN grads of the backward with weight grads, from the
// partials the kernels that make the rows wrote (the attention backward's
// per 16-row group, the LN backward's per block), and the LoRA grads from
// the folded GEMMs' partials (per 64-row block): segment s sums
// part[r * n + c] over its rows r in a fixed order into out[c], times its
// scale (the LoRA scale s for dB, 1 for the rest). A block
// takes 32 columns of one segment; its 8 row lanes take every 8th row in
// order, then lane 0 adds the 8 in order. One launch for every segment.
constexpr int SUM_SEGS = 12;
struct SumSegs {
  const float* part[SUM_SEGS];
  float* out[SUM_SEGS];
  int rows[SUM_SEGS], n[SUM_SEGS];
  float scale[SUM_SEGS];
  int count;
};

__global__ void __launch_bounds__(256)
partial_sums_kernel(SumSegs sg) {
  __shared__ float red[8][33];
  int tile = blockIdx.x, si = 0;
  while (si < sg.count && tile >= (sg.n[si] + 31) / 32) {
    tile -= (sg.n[si] + 31) / 32;
    ++si;
  }
  if (si >= sg.count) return;
  const int cx = threadIdx.x & 31, ry = threadIdx.x >> 5;
  const int c = tile * 32 + cx, n = sg.n[si];
  float acc = 0.f;
  if (c < n)
    for (int r = ry; r < sg.rows[si]; r += 8) acc += sg.part[si][(size_t)r * n + c];
  red[ry][cx] = acc;
  __syncthreads();
  if (ry == 0 && c < n) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) t += red[w][cx];
    sg.out[si][c] = sg.scale[si] * t;
  }
}

__global__ void splitk_reduce_kernel(const float* __restrict__ ws, int splits,
                                     size_t mn, float alpha,
                                     float* __restrict__ out) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += ws[(size_t)z * mn + i];
    out[i] = alpha * s;
  }
}

// A m16 x k16 fragment from a tile stored [m][k] (row) or [k][m] (AT).
template <bool AT>
__device__ __forceinline__ void ldsm_a(unsigned* r, const bf16* s, int ld,
                                       int m0, int k0, int lane) {
  if (!AT)
    ldsm_x4(r, s + (m0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
  else
    ldsm_x4_t(r, s + (k0 + (lane & 7) + ((lane >> 4) << 3)) * ld + m0 +
                     ((lane >> 3) & 1) * 8);
}

// B fragments of two n8 tiles (n0, n0+8) x k16 from a tile stored [k][n] or
// [n][k] (BT): r[0], r[1] for n0; r[2], r[3] for n0 + 8.
template <bool BT>
__device__ __forceinline__ void ldsm_b(unsigned* r, const bf16* s, int ld,
                                       int k0, int n0, int lane) {
  if (!BT)
    ldsm_x4_t(r, s + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 +
                     (lane >> 4) * 8);
  else
    ldsm_x4(r, s + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
                   ((lane >> 3) & 1) * 8);
}

// ---------------------------------------------------------------------------
// bf16 tiled GEMM, fp32 accumulation: out = epilogue(alpha * A @ B).
// A(m, k) = A[m*sam + k*sak], B(k, n) = B[k*sbk + n*sbn], so one kernel serves
// the NN, NT and TN layouts. Epilogue, in the order the TPU kernel adds:
//   v = alpha * acc (+ bias[n]) (+ lscale * sum_r z[m, r] * L[r, n]);
//   out = resid[m, n] + v  (resid given) or v.
// With splits > 1 each split z covers k_per_split of K and writes raw fp32
// partials to out + z*M*N; splitk_reduce_kernel sums them in order.
//
// Tiles are BM x BN x 64 over 4 warps of mma.sync m16n8k16, fed by a 3-stage
// cp.async pipeline (16-byte copies along the operand's contiguous
// dimension; element loads when shapes or strides do not allow them). An
// operand whose contiguous dimension is M (A) or K (B) stays in that
// orientation in shared memory and is read with ldmatrix's transpose, so NT
// and TN load as fast as NN. Tile shapes: 64x16 when N <= 16 (the rank-r
// LoRA factors), 16x128 when M <= 16 (the LoRA-B grads); every other shape
// takes the wgmma GEMM below.
// ---------------------------------------------------------------------------
constexpr int GBK = 64, GSTAGES = 3, GTHREADS = 128;

struct GemmArgs {
  int M, N, K, k_per_split;
  const bf16* A;
  long long sam, sak;
  const bf16* B;
  long long sbk, sbn;
  float alpha;
  const void* bias;   // fp32, or bf16 where bias_bf16
  int bias_bf16;
  const bf16* lz;
  long long szm, szr;
  const bf16* lb;
  long long slr, sln;
  int R;
  float lscale;
  const void* resid;
  long long ldr;
  void* out;
  long long ldo;
  int a_vec, b_vec, o_vec, r_vec;
  int splits;
  // a grouped launch: group g < groups multiplies A rows g*gm + m with B
  // columns g*gn + n into out columns g*gn + n (bias too); M and N are a
  // group's
  int groups;
  long long gm, gn;
  // the rank-r LoRA fold (gemm_pingpong_kernel<..., FOLD = true>), where a
  // launch forms the LoRA products on the operand tiles it already streams:
  //   * Z = bf16(zalpha * A @ F), F (K x R) at fz[k + n * sfn] (K
  //     contiguous: TMA loads its 64 x 8 tile beside each A stage), a
  //     narrow second product on each A stage; the epilogue's LoRA term is
  //     lscale * Z @ L (lb). zout (R x ldz, Z transposed), or null: Z for
  //     the backward, written by each row block's first column tile;
  //   * pb, or null: the B-type partials pb[blk][r][k] = the sum over the
  //     64 rows of block blk of zin[r][m] * A[m][k] (zin R x ldz, as zout
  //     writes it, loaded by TMA a tile ahead), each k-step's by one
  //     column tile of the row block;
  //   * pa, or null: the A-type partials pa[blk][n][r] = the sum over those
  //     rows of xa[m][n] * Z[m][r] (xa M x N, row stride ldx), the tile's
  //     own columns, from an xa tile that the ring loads after the tile's
  //     last k-step.
  // The partials' blocks are fixed, so partial_sums_kernel adds them in a
  // fixed order: no atomics.
  const bf16* fz;
  long long sfn;
  float zalpha;
  bf16* zout;
  const bf16* zin;
  long long ldz;
  float* pb;
  const bf16* xa;
  long long ldx;
  float* pa;
};

template <int BM, int BN, bool AT, bool BT>
struct GemmTile {
  static constexpr int A_LD = AT ? BM + 8 : GBK + 8;   // bf16 elements
  static constexpr int A_ELEMS = AT ? GBK * A_LD : BM * A_LD;
  static constexpr int B_LD = BT ? GBK + 8 : BN + 8;
  static constexpr int B_ELEMS = BT ? BN * B_LD : GBK * B_LD;
  static constexpr int STAGE = A_ELEMS + B_ELEMS;
  static constexpr size_t SMEM = (size_t)GSTAGES * STAGE * sizeof(bf16);
};

template <int BM, int BN, bool AT, bool BT>
__device__ __forceinline__ void gemm_load_stage(const GemmArgs& p, bf16* As,
                                                bf16* Bs, int m0, int n0,
                                                int k0, int kend, int tid) {
  using TL = GemmTile<BM, BN, AT, BT>;
  const bf16 zero = __float2bfloat16(0.f);
  if (p.a_vec) {
    if (!AT) {   // K contiguous
      for (int c = tid; c < BM * (GBK / 8); c += GTHREADS) {
        const int r = c / (GBK / 8), kc = (c % (GBK / 8)) * 8;
        const int gm = m0 + r, gk = k0 + kc;
        const bool ok = gm < p.M && gk < kend;
        cp_async16(As + r * TL::A_LD + kc,
                   ok ? p.A + (size_t)gm * p.sam + gk : p.A, ok);
      }
    } else {     // M contiguous
      for (int c = tid; c < GBK * (BM / 8); c += GTHREADS) {
        const int kk = c / (BM / 8), mc = (c % (BM / 8)) * 8;
        const int gm = m0 + mc, gk = k0 + kk;
        const bool ok = gm < p.M && gk < kend;
        cp_async16(As + kk * TL::A_LD + mc,
                   ok ? p.A + (size_t)gk * p.sak + gm : p.A, ok);
      }
    }
  } else {
    for (int e = tid; e < BM * GBK; e += GTHREADS) {
      const int r = AT ? e % BM : e / GBK;
      const int kk = AT ? e / BM : e % GBK;
      const int gm = m0 + r, gk = k0 + kk;
      const bf16 v = (gm < p.M && gk < kend)
          ? p.A[(size_t)gm * p.sam + (size_t)gk * p.sak] : zero;
      As[AT ? kk * TL::A_LD + r : r * TL::A_LD + kk] = v;
    }
  }
  if (p.b_vec) {
    if (!BT) {   // N contiguous
      for (int c = tid; c < GBK * (BN / 8); c += GTHREADS) {
        const int kk = c / (BN / 8), nc = (c % (BN / 8)) * 8;
        const int gk = k0 + kk, gn = n0 + nc;
        const bool ok = gk < kend && gn < p.N;
        cp_async16(Bs + kk * TL::B_LD + nc,
                   ok ? p.B + (size_t)gk * p.sbk + gn : p.B, ok);
      }
    } else {     // K contiguous
      for (int c = tid; c < BN * (GBK / 8); c += GTHREADS) {
        const int n = c / (GBK / 8), kc = (c % (GBK / 8)) * 8;
        const int gn = n0 + n, gk = k0 + kc;
        const bool ok = gk < kend && gn < p.N;
        cp_async16(Bs + n * TL::B_LD + kc,
                   ok ? p.B + (size_t)gn * p.sbn + gk : p.B, ok);
      }
    }
  } else {
    for (int e = tid; e < GBK * BN; e += GTHREADS) {
      const int n = BT ? e / GBK : e % BN;
      const int kk = BT ? e % GBK : e / BN;
      const int gk = k0 + kk, gn = n0 + n;
      const bf16 v = (gk < kend && gn < p.N)
          ? p.B[(size_t)gk * p.sbk + (size_t)gn * p.sbn] : zero;
      Bs[BT ? n * TL::B_LD + kk : kk * TL::B_LD + n] = v;
    }
  }
}

// Store of the two consecutive columns n, n+1 of row m: raw fp32 partials
// with split-K, else the finished values.
template <typename OutT>
__device__ __forceinline__ void gemm_store2(const GemmArgs& p, float v0,
                                            float v1, int m, int n, int zi,
                                            long long col_off) {
  if (m >= p.M || n >= p.N) return;
  const bool two = n + 1 < p.N;
  if (p.splits > 1) {
    float* ws = reinterpret_cast<float*>(p.out) +
                (size_t)zi * p.M * p.N + (size_t)m * p.N + n;
    ws[0] = v0;
    if (two) ws[1] = v1;
    return;
  }
  OutT* o = reinterpret_cast<OutT*>(p.out) + (size_t)m * p.ldo + col_off + n;
  if (two && p.o_vec) {   // n is even: one 4- or 8-byte store
    if (sizeof(OutT) == 2)
      *reinterpret_cast<unsigned*>(o) = pack_bf16(v0, v1);
    else
      *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
    return;
  }
  o[0] = from_f<OutT>(v0);
  if (two) o[1] = from_f<OutT>(v1);
}

// Epilogue of one warp's 16-row slab of accumulators in the MMA C layout
// (mma.sync and wgmma alike): c[j][0..1] are row m, columns n + 8j and
// n + 8j + 1; c[j][2..3] the same columns of row m + 8; zi is the split of
// K they cover (split-K writes raw partials). In passes: every
// load (bias, LoRA factors, residual) goes into the accumulators first, then
// every store. Interleaved, each load would wait behind the store before it,
// which may alias it.
// With zs (not null) the LoRA factors come from shared memory, staged by the
// caller (the folded GEMMs, rank <= FOLD_RMAX): zs[r] and zs[8 * FOLD_RMAX +
// r] are lscale * z16 of rows m and m + 8, ls[r * ldl + 8j (+1)] L16 of
// columns n + 8j (+1). col_off: the group's column offset into bias and out
// (gn * g).
constexpr int FOLD_RMAX = 8;

// Bias element i in the bias's own dtype (the chain casts nothing first).
__device__ __forceinline__ float bias_at(const GemmArgs& p, long long i) {
  return p.bias_bf16 ? __bfloat162float(static_cast<const bf16*>(p.bias)[i])
                     : static_cast<const float*>(p.bias)[i];
}

// The terms before the residual, in the TPU kernel's order: alpha * acc
// (+ bias) (+ lscale * z16 @ L from the staged factors). bs (not null): the
// bias staged in shared memory as fp32 by the caller, bs[8j (+1)] that of
// columns n + 8j (+1), zero past N.
template <int NI>
__device__ __forceinline__ void gemm_epilogue_terms(const GemmArgs& p,
                                                    float (*c)[4], int n,
                                                    long long col_off,
                                                    const float* zs,
                                                    const float* ls, int ldl,
                                                    const float* bs = nullptr) {
#pragma unroll
  for (int j = 0; j < NI; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] *= p.alpha;
  if (p.bias) {
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int nj = n + 8 * j;
      float b0, b1;
      if (bs) {
        const float2 bv = *reinterpret_cast<const float2*>(bs + 8 * j);
        b0 = bv.x;
        b1 = bv.y;
      } else {
        b0 = nj < p.N ? bias_at(p, col_off + nj) : 0.f;
        b1 = nj + 1 < p.N ? bias_at(p, col_off + nj + 1) : 0.f;
      }
      c[j][0] += b0; c[j][1] += b1;
      c[j][2] += b0; c[j][3] += b1;
    }
  }
  // + lscale * z16 @ L, one rank at a time
  for (int r = 0; zs && r < p.R; ++r) {
    const float za = zs[r], zb = zs[8 * FOLD_RMAX + r];
    const float* lr = ls + r * ldl;
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const float2 lv = *reinterpret_cast<const float2*>(lr + 8 * j);
      c[j][0] += za * lv.x; c[j][1] += za * lv.y;
      c[j][2] += zb * lv.x; c[j][3] += zb * lv.y;
    }
  }
}

template <typename OutT, int NI>
__device__ __forceinline__ void gemm_epilogue(const GemmArgs& p, float (*c)[4],
                                              int m, int n, int zi,
                                              const float* zs = nullptr,
                                              const float* ls = nullptr,
                                              int ldl = 0,
                                              long long col_off = 0,
                                              const float* bs = nullptr) {
  if (p.splits == 1) {
    gemm_epilogue_terms<NI>(p, c, n, col_off, zs, ls, ldl, bs);
    for (int r = 0; !zs && p.lz && r < p.R; ++r) {
      const float za = m < p.M ? p.lscale * __bfloat162float(
          p.lz[(size_t)m * p.szm + (size_t)r * p.szr]) : 0.f;
      const float zb = m + 8 < p.M ? p.lscale * __bfloat162float(
          p.lz[(size_t)(m + 8) * p.szm + (size_t)r * p.szr]) : 0.f;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int nj = n + 8 * j;
        const float l0 = nj < p.N ? __bfloat162float(
            p.lb[(size_t)r * p.slr + (size_t)nj * p.sln]) : 0.f;
        const float l1 = nj + 1 < p.N ? __bfloat162float(
            p.lb[(size_t)r * p.slr + (size_t)(nj + 1) * p.sln]) : 0.f;
        c[j][0] += za * l0; c[j][1] += za * l1;
        c[j][2] += zb * l0; c[j][3] += zb * l1;
      }
    }
    if (p.resid) {
      const OutT* rr = reinterpret_cast<const OutT*>(p.resid);
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {   // rows m and m + 8
          const int mi = m + 8 * h, ni = n + 8 * j;
          if (mi >= p.M || ni >= p.N) continue;
          const OutT* r2 = rr + (size_t)mi * p.ldr + ni;
          if (ni + 1 < p.N && p.r_vec) {   // ni is even: one 4- or 8-byte load
            float2 v;
            if constexpr (sizeof(OutT) == 2)
              v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(r2));
            else
              v = *reinterpret_cast<const float2*>(r2);
            c[j][2 * h] = v.x + c[j][2 * h];
            c[j][2 * h + 1] = v.y + c[j][2 * h + 1];
          } else {
            c[j][2 * h] = to_f(r2[0]) + c[j][2 * h];
            if (ni + 1 < p.N) c[j][2 * h + 1] = to_f(r2[1]) + c[j][2 * h + 1];
          }
        }
    }
  }
#pragma unroll
  for (int j = 0; j < NI; ++j) {
    gemm_store2<OutT>(p, c[j][0], c[j][1], m, n + 8 * j, zi, col_off);
    gemm_store2<OutT>(p, c[j][2], c[j][3], m + 8, n + 8 * j, zi, col_off);
  }
}

// Byte offset of element (row, col) of a CM-row bf16 tile staged as boxes
// of 64 columns (CM 128-byte rows each), in TMA's 128B swizzle: the 16-byte
// chunk of a row is XORed with row % 8, so the 8 rows a warp's accumulator
// layout writes at once fall in 8 different banks' chunks.
template <int CM>
__device__ __forceinline__ int stage_offset(int row, int col) {
  const int cc = col & 63;
  return (col >> 6) * (CM * 128) + row * 128 +
         ((((cc >> 3) ^ row) & 7) << 4) + ((cc & 7) << 1);
}

// The wgmma GEMM's staged epilogue for bf16 output: the terms as
// gemm_epilogue, then + the residual, read from the staging tile where TMA
// loaded it, and one rounding to bf16 into the same place, from which TMA
// stores the tile. mr / nc: row and column of c[0][0] in the tile; n its
// column in the group.
template <int NI, int CM>
__device__ __forceinline__ void gemm_epilogue_staged(
    const GemmArgs& p, float (*c)[4], int mr, int nc, int n, long long col_off,
    const float* zs, const float* ls, int ldl, unsigned char* stage,
    const float* bs) {
  gemm_epilogue_terms<NI>(p, c, n, col_off, zs, ls, ldl, bs);
#pragma unroll
  for (int j = 0; j < NI; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {   // rows mr and mr + 8
      unsigned* slot = reinterpret_cast<unsigned*>(
          stage + stage_offset<CM>(mr + 8 * h, nc + 8 * j));
      float v0 = c[j][2 * h], v1 = c[j][2 * h + 1];
      if (p.resid) {
        const float2 r = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(slot));
        v0 = r.x + v0;
        v1 = r.y + v1;
      }
      *slot = pack_bf16(v0, v1);
    }
}

// A 64x64 warp tile holds 128 fp32 accumulators a thread: two blocks an SM
// leave it 255 registers (three would cap it at 170 and spill).
template <typename OutT, int WM, int WN, int MI, int NI, bool AT, bool BT>
__global__ void __launch_bounds__(GTHREADS, (MI * NI >= 32) ? 2 : 3)
gemm_kernel(GemmArgs p) {
  constexpr int BM = WM * MI * 16, BN = WN * NI * 8;
  using TL = GemmTile<BM, BN, AT, BT>;
  static_assert(WM * WN == GTHREADS / 32, "4 warps");
  static_assert(NI % 2 == 0, "B fragments come in n8 pairs");
  extern __shared__ __align__(128) unsigned char gsmem[];
  bf16* sm = reinterpret_cast<bf16*>(gsmem);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // grid z: the split of K, then the group, whose operands start further on
  const int zi = blockIdx.z % p.splits, gi = blockIdx.z / p.splits;
  if (gi) {
    p.A += gi * p.gm * p.sam;
    p.B += gi * p.gn * p.sbn;
    if (p.bias)
      p.bias = static_cast<const char*>(p.bias) +
               gi * p.gn * (p.bias_bf16 ? sizeof(bf16) : sizeof(float));
    p.out = reinterpret_cast<OutT*>(p.out) + gi * p.gn;
  }
  const int kbeg = zi * p.k_per_split;
  const int kend = min(p.K, kbeg + p.k_per_split);
  const int nk = kend > kbeg ? (kend - kbeg + GBK - 1) / GBK : 0;
  const int wm = (warp / WN) * MI * 16, wn = (warp % WN) * NI * 8;

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < GSTAGES - 1; ++s) {
    if (s < nk)
      gemm_load_stage<BM, BN, AT, BT>(p, sm + s * TL::STAGE,
                                      sm + s * TL::STAGE + TL::A_ELEMS, m0, n0,
                                      kbeg + s * GBK, kend, tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<GSTAGES - 2>();
    __syncthreads();
    const bf16* As = sm + (kt % GSTAGES) * TL::STAGE;
    const bf16* Bs = As + TL::A_ELEMS;
    // refill the stage every thread finished reading before the barrier
    const int nxt = kt + GSTAGES - 1;
    if (nxt < nk)
      gemm_load_stage<BM, BN, AT, BT>(p, sm + (nxt % GSTAGES) * TL::STAGE,
                                      sm + (nxt % GSTAGES) * TL::STAGE + TL::A_ELEMS,
                                      m0, n0, kbeg + nxt * GBK, kend, tid);
    cp_async_commit();
#pragma unroll
    for (int kk = 0; kk < GBK; kk += 16) {
      unsigned af[MI][4], bfr[NI / 2][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldsm_a<AT>(af[i], As, TL::A_LD, wm + i * 16, kk, lane);
#pragma unroll
      for (int j = 0; j < NI / 2; ++j)
        ldsm_b<BT>(bfr[j], Bs, TL::B_LD, kk, wn + j * 16, lane);
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI / 2; ++j) {
          mma16816(acc[i][2 * j], af[i], bfr[j][0], bfr[j][1]);
          mma16816(acc[i][2 * j + 1], af[i], bfr[j][2], bfr[j][3]);
        }
    }
  }
  cp_async_wait<0>();
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < MI; ++i)
    gemm_epilogue<OutT, NI>(p, acc[i], m0 + wm + i * 16 + g, n0 + wn + 2 * t4,
                            zi);
}

// ---------------------------------------------------------------------------
// Hopper GEMM, the same contract (layouts by strides, epilogue, split-K
// partials) for operands TMA can read: a unit stride in one dimension, the
// other a multiple of 16 bytes, a 16-byte aligned base. Output tiles 128 x
// BN (BN 128 or 64 columns), K in steps of 64; one block of 3 warpgroups
// on a warp-specialized "ping-pong" schedule:
//   * warpgroup 0 is the producer: one thread keeps a ring of STAGES tiles
//     in flight, each A and B tile one or a few cp.async.bulk.tensor loads
//     into 128B-swizzled shared memory, completion counted by the stage's
//     "full" mbarrier (expect_tx);
//   * warpgroups 1 and 2 are the consumers, and each owns whole output
//     tiles: the block's tiles go to them in turn, in the order the
//     producer fills the ring. A consumer runs wgmma.mma_async m64n128k16
//     (m64n64k16 for BN 64; two products of 64 rows a k16 step; fp32
//     accumulators in registers, both operands read from shared memory
//     through matrix descriptors; bf16 wgmma reads K-major or MN-major
//     tiles, so NN, NT and TN need no transposing copy), keeps one group of
//     products in flight, and releases a stage to the producer through its
//     "empty" mbarrier when its products have retired;
//   * the consumers' main loops take turns (the "order" mbarriers: each
//     waits until the other has issued its tile's last products), so while
//     one runs its epilogue (bias, LoRA terms, residual, rounding, staging
//     and store) the other's products keep the tensor cores busy. Each
//     consumer has its own staging tile, Z tiles, LoRA factors and bias in
//     shared memory, and its own named barrier;
//   * a launch whose tiles fill at most one round of the SMs (COOP) runs
//     both consumers on each tile, 64 rows each: a block there has one
//     tile, and one consumer alone ran it up to 1.5x slower.
// The cooperative schedule it replaces (both consumers on every tile)
// idled the tensor cores through every epilogue (~1/3 of a tile's time at
// K = 768 by the cost model; on an H100 the qkv product gained 8-11%, as
// one consumer's k-steps run slower than two consumers', PERF.md); 64-row
// ping-pong tiles, which read B twice as often from L2, ran the qkv
// product 1.65x slower; the fold's partials pair 64-row blocks in a
// 128-row tile. Each output element
// still sums its k16 steps in order into one fp32 chain with the same wgmma
// width, and the epilogue adds its terms in the same order, so every value
// is the cooperative kernel's bit for bit.
// Persistent: one block an SM walks the output tiles (n fastest, so the
// tiles in flight share their A rows); the producer's ring runs on across
// tiles. setmaxnreg moves registers from the producer to the consumers. TMA
// fills out-of-bounds rows and columns with zeros, so ragged M, N and K
// need no masking in the main loop.
// ---------------------------------------------------------------------------
constexpr int WG_BM = 128, WG_BK = 64, WG_THREADS = 384;
constexpr int WG_BOX = 8192;   // one 64 x 64 bf16 box (or 64 rows of one), 128B rows

// The fold's narrow products are 8 wide (FOLD_RMAX ranks; the tensor
// work of a 64 x 8 product is a sixteenth of the 64 x 128 one beside it),
// their B tiles 8 rows (ranks, zero past R) of 64 K-contiguous bf16,
// 128B-swizzled: the F tile of a ring stage, and the Z tiles of a
// consumer's 64-row halves for the partials.
constexpr int WG_F_BYTES = FOLD_RMAX * 128;

// The fold's modes (gemm_pingpong_kernel's FOLD): none; Z alone (the
// forward's qkv and out products); Z and both kinds of partials (the
// backward's dctx and dh products).
enum { FOLD_NONE = 0, FOLD_Z = 1, FOLD_GRADS = 2 };

template <int BN, bool STAGE, int FOLD, bool COOP>
struct WgTile {
  static constexpr int CM = WG_BM;
  static constexpr int A_BYTES = CM * WG_BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + BN * WG_BK * 2;
  static constexpr int F = FOLD ? WG_F_BYTES : 0;   // a stage's F tile
  static constexpr int RC = COOP ? 64 : CM;         // a consumer's rows of a tile
  // a consumer's own: the bf16 staging tile, the Z tiles of its 64-row
  // halves, lscale * Z of its rows and the LoRA factor L of its columns
  // (fp32, the fold), the bias of its columns (fp32)
  static constexpr int OUT = STAGE ? RC * BN * 2 : 0;
  static constexpr int ZT = FOLD == FOLD_GRADS ? RC / 64 * WG_F_BYTES : 0;
  static constexpr int LORA = FOLD ? (RC + BN) * FOLD_RMAX * 4 : 0;
  static constexpr int BIAS = BN * 4;
  // the full and empty barriers of each stage, then the consumers' order,
  // residual and zin barriers
  static constexpr int BARS = (2 * 8 + 6) * 8;
  static constexpr int FIXED = 2 * (OUT + ZT + LORA + BIAS) + BARS + 1024;
  // as many stages as the rest of the block's shared memory holds, up to 8
  static constexpr int FIT = (232448 - FIXED) / (STAGE_BYTES + F);
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr size_t SMEM = (size_t)STAGES * (STAGE_BYTES + F) + FIXED;
  static_assert(STAGES >= 3 && SMEM <= 232448, "a block's shared memory");
};

// Byte offset of element (n, k) of a fold tile (WG_F_BYTES: 128-byte rows
// of 64 bf16 in TMA's 128B swizzle, the 16-byte chunk XORed with n % 8), as
// wgmma reads a K-major B tile and TMA writes it.
__device__ __forceinline__ int fold_offset(int n, int k) {
  return n * 128 + ((((k >> 3) ^ n) & 7) << 4) + ((k & 7) << 1);
}

// One k16 step of a 64 x HN slab (HN 128 or 64).
template <int HN, int TA, int TB>
__device__ __forceinline__ void wgmma_k16(float (&d)[HN / 2], uint64_t da,
                                          uint64_t db) {
  if constexpr (HN == 128) wgmma_m64n128k16<TA, TB>(d, da, db);
  else wgmma_m64n64k16<TA, TB>(d, da, db);
}

// The ring stages of tile t (``tiles`` the output tiles of a group and a
// split): its k-steps, and with the fold's partials one more (its xa tile).
__device__ __forceinline__ int wg_ring_steps(const GemmArgs& p, int t, int tiles,
                                             bool xa) {
  const int kbeg = t / (tiles * p.groups) * p.k_per_split;
  const int kend = min(p.K, kbeg + p.k_per_split);
  return (kend > kbeg ? (kend - kbeg + WG_BK - 1) / WG_BK : 0) + (xa ? 1 : 0);
}

// STAGE (bf16 out, 128-column tiles, no split-K): the epilogue goes through
// the consumer's staging tile in shared memory. Its first thread (the
// leader) loads the tile's residual into it by TMA (tma_r, counted by the
// consumer's ``rbar``) before the tile's main loop, so the load overlaps the
// products; the consumer adds the terms and the residual from there and
// writes the bf16 result back in place (conflict-free in the 128B swizzle);
// then the leader stores the tile by TMA (tma_c) in whole 128-byte rows,
// which overlaps the other consumer's products, and waits until TMA has
// read the staging tile only before its next tile's residual load. Without
// STAGE the epilogue writes from the accumulators (gemm_epilogue).
// KR (FOLD_GRADS): K / N of the product (dctx 1, dh 3), so that each
// column tile's share of a row block's k-steps is KR * BN / 64 of them.
// COOP (a launch whose tiles fill at most one round of the SMs, where a
// block has one tile and ping-pong nothing to overlap): both consumers
// take every tile of the block, 64 of its 128 rows each, their main loops
// at once (on an H100 the ping-pong schedule ran such launches up to 1.5x
// slower: a lone consumer, PERF.md).
template <typename OutT, int BN, bool AT, bool BT, bool STAGE,
          int FOLD = FOLD_NONE, int KR = 0, bool COOP = false>
__global__ void __launch_bounds__(WG_THREADS, 1)
gemm_pingpong_kernel(const __grid_constant__ CUtensorMap tma_a,
                  const __grid_constant__ CUtensorMap tma_b,
                  const __grid_constant__ CUtensorMap tma_c,
                  const __grid_constant__ CUtensorMap tma_r,
                  const __grid_constant__ CUtensorMap tma_f,
                  const __grid_constant__ CUtensorMap tma_z,
                  const __grid_constant__ CUtensorMap tma_x, GemmArgs p) {
  using TL = WgTile<BN, STAGE, FOLD, COOP>;
  constexpr int CM = TL::CM, STAGES = TL::STAGES, RC = TL::RC, MI = RC / 64;
  // a consumer's RC x BN share of a tile as MI x NH wgmma products of 64 x
  // HN each
  constexpr int HN = BN < 128 ? BN : 128, NH = BN / HN;
  static_assert(MI * BN <= 256, "at most 128 accumulators a thread");
  static_assert(!FOLD || (!AT && BN <= 128), "the fold reads K-major A tiles");
  extern __shared__ __align__(1024) unsigned char wsm[];
  // the swizzle pattern repeats every 1024 bytes: tiles start on it
  unsigned char* base = wsm + ((1024 - (smem_u32(wsm) & 1023)) & 1023);
  unsigned char* fsm = base + STAGES * TL::STAGE_BYTES;   // the stages' F tiles
  unsigned char* outs = fsm + STAGES * TL::F;             // the staging tiles
  unsigned char* ztm = outs + 2 * TL::OUT;                // the Z tiles
  float* lsm = reinterpret_cast<float*>(ztm + 2 * TL::ZT);
  float* bsm0 = lsm + 2 * (TL::LORA / 4);
  uint64_t* full = reinterpret_cast<uint64_t*>(bsm0 + 2 * BN);
  uint64_t* empty = full + STAGES;
  uint64_t* order = empty + STAGES;   // the consumers' main loops in turn
  uint64_t* rbar = order + 2;         // each consumer's residual tile
  uint64_t* zbar = rbar + 2;          // the fold: each consumer's zin rows
  // persistent: block b takes tiles b, b + gridDim.x, ...; n fastest, then
  // m, then the group, then the split of K, so the tiles in flight share
  // their A rows
  const int tiles_n = (p.N + BN - 1) / BN, tiles_m = (p.M + CM - 1) / CM;
  const int ntiles = tiles_n * tiles_m * p.groups * p.splits;
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, COOP ? 256 : 128);   // every thread of the tile's consumers
    }
    for (int c = 0; c < 2; ++c) {
      mbar_init(order + c, 128);
      mbar_init(rbar + c, 1);
      mbar_init(zbar + c, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {   // producer: the ring runs on across tiles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::);
    if (threadIdx.x == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        const int n0 = (t % tiles_n) * BN, m0 = (t / tiles_n % tiles_m) * CM;
        const int gi = t / (tiles_n * tiles_m) % p.groups;
        const int am = m0 + (int)(gi * p.gm), bn = n0 + (int)(gi * p.gn);
        const int kbeg = t / (tiles_n * tiles_m * p.groups) * p.k_per_split;
        const int kend = min(p.K, kbeg + p.k_per_split);
        for (int k = kbeg; k < kend; k += WG_BK, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(empty + s, (it / STAGES - 1) & 1);
          unsigned char* As = base + s * TL::STAGE_BYTES;
          unsigned char* Bs = As + TL::A_BYTES;
          mbar_expect_tx(full + s, TL::STAGE_BYTES + TL::F);
          if (AT) {   // M contiguous: CM / 64 boxes of 64 (M) x 64 (K)
#pragma unroll
            for (int i = 0; i < CM / 64; ++i)
              tma_load(As + i * WG_BOX, &tma_a, full + s, am + 64 * i, k);
          } else {    // K contiguous: one 64 (K) x CM (M) box
            tma_load(As, &tma_a, full + s, k, am);
          }
          if (BT) {   // K contiguous: one 64 (K) x BN (N) box
            tma_load(Bs, &tma_b, full + s, k, bn);
          } else {    // N contiguous: BN / 64 boxes of 64 (N) x 64 (K)
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)
              tma_load(Bs + j * WG_BOX, &tma_b, full + s, bn + 64 * j, k);
          }
          // the fold: F's 64 (K) x 8 (rank) tile, zeros past R and K
          if (FOLD) tma_load(fsm + s * WG_F_BYTES, &tma_f, full + s, k, 0);
        }
        if (FOLD == FOLD_GRADS) {   // one more step: the tile's xa rows and columns
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(empty + s, (it / STAGES - 1) & 1);
          unsigned char* Xs = base + s * TL::STAGE_BYTES;
          mbar_expect_tx(full + s, CM * BN * 2);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load(Xs + j * CM * 128, &tma_x, full + s, n0 + 64 * j, m0);
          ++it;
        }
      }
    }
  } else {         // consumers: warpgroup 1 + c takes the block's tiles c,
                   // c + 2, ... (COOP: rows 64c .. 64c + 63 of every tile)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::);
    const int c = wg - 1;
    const int r0 = COOP ? 64 * c : 0;   // the consumer's first row of a tile
    const int lane = threadIdx.x & 31, w4 = (threadIdx.x >> 5) & 3;
    const int mm = 16 * w4 + (lane >> 2);   // the thread's first row of a 64-row half
    const int g8 = lane >> 2, t4 = lane & 3;
    const bool leader = (threadIdx.x & 127) == 0;   // the consumer's TMA thread
    unsigned char* stg = outs + c * TL::OUT;
    // the fold: the Z tiles of the consumer's halves (zin's rows for the
    // B-type partials, then the tile's Z for the A-type ones), loaded a
    // tile ahead; lscale * Z of the tile's rows and L of its columns
    unsigned char* zt = ztm + c * TL::ZT;
    float* zs = lsm + c * (TL::LORA / 4);
    float* ls = zs + RC * FOLD_RMAX;
    float* bsm = bsm0 + c * BN;
    const int step = (COOP ? 1 : 2) * gridDim.x;
    const int first = blockIdx.x + (COOP ? 0 : c * gridDim.x);
    const int bar_id = 1 + c;   // the consumer's named barrier
    if (FOLD == FOLD_GRADS && leader && first < ntiles) {
      mbar_expect_tx(zbar + c, MI * WG_F_BYTES);
#pragma unroll
      for (int i = 0; i < MI; ++i)
        tma_load(zt + i * WG_F_BYTES, &tma_z, zbar + c,
                 first / tiles_n % tiles_m * CM + r0 + 64 * i, 0);
    }
    // the ring position: the other consumer's tiles come between this one's
    int it = !COOP && c == 1 ? wg_ring_steps(p, blockIdx.x, tiles_n * tiles_m,
                                             FOLD == FOLD_GRADS) : 0;
    int tn = 0;   // the consumer's own tiles so far
    for (int t = first; t < ntiles; t += step, ++tn) {
      const int n0 = (t % tiles_n) * BN, m0 = t / tiles_n % tiles_m * CM;
      const int gi = t / (tiles_n * tiles_m) % p.groups;
      const long long col_off = gi * p.gn;
      const int zi = t / (tiles_n * tiles_m * p.groups);
      const int kbeg = zi * p.k_per_split;
      const int kend = min(p.K, kbeg + p.k_per_split);
      // the residual tile into the staging tile, once the last tile's TMA
      // store has read it
      if (STAGE && leader) {
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        if (p.resid) {
          mbar_expect_tx(rbar + c, TL::OUT);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load(stg + j * RC * 128, &tma_r, rbar + c,
                     n0 + (int)col_off + 64 * j, m0 + r0);
        }
      }
      // the fold's factor L and the bias of this tile into shared memory as
      // fp32 (the epilogue reads each many times, the bias in its own
      // dtype); columns past N stage as zeros. Z comes from the tile's own
      // product.
      if (FOLD || p.bias) {
        asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");   // the last epilogue is done
        const int tc = threadIdx.x & 127;
        for (int i = tc; FOLD && i < p.R * BN; i += 128) {
          const int r = i / BN, nn = i % BN, n = n0 + nn;
          ls[r * BN + nn] = n < p.N ? __bfloat162float(
              p.lb[(size_t)r * p.slr + (size_t)n * p.sln]) : 0.f;
        }
        for (int i = tc; p.bias && i < BN; i += 128)
          bsm[i] = n0 + i < p.N ? bias_at(p, col_off + n0 + i) : 0.f;
        asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");
      }
      // this tile's main loop comes after the other consumer has issued its
      // last tile's products
      if (!COOP && c == 1) mbar_wait(order + 1, tn & 1);
      else if (!COOP && tn > 0) mbar_wait(order, (tn - 1) & 1);
      float acc[MI][NH][HN / 2];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int h = 0; h < NH; ++h)
#pragma unroll
          for (int e = 0; e < HN / 2; ++e) acc[i][h][e] = 0.f;
      // the fold: Z's accumulators, and the B-type partials of each k-step
      // of this tile's share: CH steps from c0, the row block's k-steps by
      // column tile (each step's own accumulators, read once every product
      // has retired: an accumulator read while any wgmma is in flight, or
      // a wgmma under a branch, makes the compiler serialize them all)
      constexpr int CH = FOLD == FOLD_GRADS ? KR * BN / WG_BK : 1;
      float zacc[MI][4], pacc[CH][MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) zacc[i][e] = 0.f;
      const int c0 = FOLD == FOLD_GRADS ? n0 / BN * CH * WG_BK : kend;
      if constexpr (FOLD == FOLD_GRADS) mbar_wait(zbar + c, tn & 1);   // zin's rows
      const int blk = (m0 + r0) / 64;   // the partials' 64-row block of the first half
      // One k-step at k: the products (and with the fold Z's) on its ring
      // stage; with WP also this step's B-type partials into pn (its 64
      // columns of A against zin over each half's 64 rows, A read M-major;
      // the first product overwrites pn).
      auto kstep = [&](int k, auto wp, float (*pn)[4]) {
        constexpr bool WP = decltype(wp)::value;
        const int s = it % STAGES;
        mbar_wait(full + s, (it / STAGES) & 1);
        const unsigned char* As = base + s * TL::STAGE_BYTES + r0 * 128;
        const unsigned char* Bs = base + s * TL::STAGE_BYTES + TL::A_BYTES;
        const unsigned char* Fs = fsm + s * WG_F_BYTES;
#pragma unroll
        for (int i = 0; i < MI; ++i) {
#pragma unroll
          for (int h = 0; h < NH; ++h) wg_reg_fence(acc[i][h]);
          if constexpr (FOLD != FOLD_NONE) wg_reg_fence(zacc[i]);
          if constexpr (WP) wg_reg_fence(pn[i]);
        }
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < WG_BK / 16; ++kk) {
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            // k16 step: 32 bytes along a K-major row, 16 rows of an MN-major
            // tile; half i's 64 rows one box on
            const uint64_t da = AT ? wg_desc(As + i * WG_BOX + kk * 2048, WG_BOX, 1024)
                                   : wg_desc(As + i * WG_BOX + kk * 32, 16, 1024);
#pragma unroll
            for (int h = 0; h < NH; ++h) {
              const uint64_t db = BT ? wg_desc(Bs + h * 16384 + kk * 32, 16, 1024)
                                     : wg_desc(Bs + h * 16384 + kk * 2048, WG_BOX, 1024);
              wgmma_k16<HN, AT ? 1 : 0, BT ? 0 : 1>(acc[i][h], da, db);
            }
            if constexpr (FOLD != FOLD_NONE)
              wgmma_m64n8k16<0, 0>(zacc[i], da, wg_desc(Fs + kk * 32, 16, 1024));
          }
        }
        if constexpr (WP) {
#pragma unroll
          for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)   // the first overwrites pn
              wgmma_m64n8k16<1, 0>(pn[i],
                                    wg_desc(As + i * WG_BOX + kk * 2048, WG_BOX, 1024),
                                    wg_desc(zt + i * WG_F_BYTES + kk * 32, 16, 1024),
                                    kk > 0);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int i = 0; i < MI; ++i) {
#pragma unroll
          for (int h = 0; h < NH; ++h) wg_reg_fence(acc[i][h]);
          if constexpr (FOLD != FOLD_NONE) wg_reg_fence(zacc[i]);
          if constexpr (WP) wg_reg_fence(pn[i]);
        }
        // the previous k-tile's products have retired: hand its stage back
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (k > kbeg) mbar_arrive(empty + (it - 1) % STAGES);
        ++it;
      };
      const std::false_type plain{};
      const std::true_type with_p{};
      int k = kbeg;
      for (; k < c0; k += WG_BK) kstep(k, plain, zacc);
      if constexpr (FOLD == FOLD_GRADS) {
#pragma unroll
        for (int j = 0; j < CH; ++j) kstep(k + j * WG_BK, with_p, pacc[j]);
        k += CH * WG_BK;
      }
      for (; k < kend; k += WG_BK) kstep(k, plain, zacc);
      // every product of the tile is issued: the other consumer's turn.
      // With the fold's partials the tile's xa stage, which this consumer
      // reads only in its epilogue, has landed first: the other consumer
      // could otherwise reach that stage's next fill while it is pending
      // and pass its wait on the phase before (mbarrier parity aliases
      // two phases apart), reading the xa tile as its own.
      if constexpr (FOLD == FOLD_GRADS)
        if (!COOP) mbar_wait(full + it % STAGES, (it / STAGES) & 1);
      if (!COOP) mbar_arrive(order + (1 - c));
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int h = 0; h < NH; ++h) wg_reg_fence(acc[i][h]);
      if (kend > kbeg) mbar_arrive(empty + (it - 1) % STAGES);   // the last one
      if constexpr (FOLD == FOLD_GRADS) {
        // the B-type partials, P[c0 + 64 j + i][r] into pb[blk + half][r][...]
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          float* pb = p.pb + (size_t)(blk + i) * p.R * p.K;
#pragma unroll
          for (int j = 0; j < CH; ++j) {
            float v[4];
            wg_read(v, pacc[j][i]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = 2 * t4 + (e & 1);
              const int kc = c0 + j * WG_BK + 16 * w4 + g8 + 8 * (e >> 1);
              if (r < p.R && kc < p.K) pb[(size_t)r * p.K + kc] = v[e];
            }
          }
        }
      }
      if constexpr (FOLD != FOLD_NONE) {
        // Z = bf16(zalpha * A @ F) of the warp's rows: the epilogue's LoRA
        // term (lscale * Z, as the staged factors), the backward's copy
        // (zout, transposed) and the A-type partials' B tile
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          float zv[4];
          wg_read(zv, zacc[i]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 2 * t4 + (e & 1);
            const int row = 64 * i + mm + 8 * (e >> 1);
            const bf16 zb = __float2bfloat16(p.zalpha * zv[e]);
            zs[row * FOLD_RMAX + r] = p.lscale * __bfloat162float(zb);
            if (p.zout && n0 == 0 && r < p.R && m0 + r0 + row < p.M)
              p.zout[(size_t)r * p.ldz + m0 + r0 + row] = zb;
            if (FOLD == FOLD_GRADS)
              *reinterpret_cast<bf16*>(zt + i * WG_F_BYTES +
                                       fold_offset(r, mm + 8 * (e >> 1))) = zb;
          }
        }
        __syncwarp();
      }
      if constexpr (FOLD == FOLD_GRADS) {
        // the A-type partials: the tile's own columns of xa against Z over
        // each half's rows, from the xa tile the ring loaded after the last
        // k-step
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");
        const int s = it % STAGES;
        mbar_wait(full + s, (it / STAGES) & 1);
        const unsigned char* Xs = base + s * TL::STAGE_BYTES + r0 * 128;
        float pa[MI][BN / 64][4];
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < BN / 64; ++j) wg_reg_fence(pa[i][j]);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)   // the first overwrites pa[i][j]
              wgmma_m64n8k16<1, 0>(
                  pa[i][j],
                  wg_desc(Xs + j * CM * 128 + i * WG_BOX + kk * 2048, WG_BOX, 1024),
                  wg_desc(zt + i * WG_F_BYTES + kk * 32, 16, 1024), kk > 0);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < BN / 64; ++j) wg_reg_fence(pa[i][j]);
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        float v[MI][BN / 64][4];
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int j = 0; j < BN / 64; ++j) wg_read(v[i][j], pa[i][j]);
        mbar_arrive(empty + s);
        ++it;
        // the Z tiles are free: zin's rows of this consumer's next tile
        if (leader && t + step < ntiles) {
          mbar_expect_tx(zbar + c, MI * WG_F_BYTES);
#pragma unroll
          for (int i = 0; i < MI; ++i)
            tma_load(zt + i * WG_F_BYTES, &tma_z, zbar + c,
                     (t + step) / tiles_n % tiles_m * CM + r0 + 64 * i, 0);
        }
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          float* pab = p.pa + (size_t)(blk + i) * p.N * p.R;
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = 2 * t4 + (e & 1);
              const int n = n0 + 64 * j + 16 * w4 + g8 + 8 * (e >> 1);
              if (r < p.R && n < p.N) pab[(size_t)n * p.R + r] = v[i][j][e];
            }
        }
      }
      if constexpr (STAGE) {
        // every thread of the consumer is past the leader's wait for the
        // last store's reads; the residual has landed
        asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");
        if (p.resid) mbar_wait(rbar + c, tn & 1);
        const int nn = 2 * t4;
#pragma unroll
        for (int i = 0; i < MI; ++i)
          gemm_epilogue_staged<HN / 8, RC>(
              p, reinterpret_cast<float(*)[4]>(acc[i][0]), 64 * i + mm, nn,
              n0 + nn, col_off,
              FOLD ? zs + (64 * i + mm) * FOLD_RMAX : nullptr, ls + nn, BN,
              stg, bsm + nn);
        // the generic-proxy writes become visible to TMA, then one store
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");
        if (leader) {
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_store(&tma_c, stg + j * RC * 128, n0 + (int)col_off + 64 * j,
                      m0 + r0);
          asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        }
      } else {
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int h = 0; h < NH; ++h) {
            const int nn = HN * h + 2 * t4;
            gemm_epilogue<OutT, HN / 8>(
                p, reinterpret_cast<float(*)[4]>(acc[i][h]), m0 + r0 + 64 * i + mm,
                n0 + nn, zi, FOLD ? zs + (64 * i + mm) * FOLD_RMAX : nullptr,
                ls + nn, BN, col_off, bsm + nn);
          }
      }
      // the other consumer's next tile comes before this one's in the ring
      if (!COOP && t + (int)gridDim.x < ntiles)
        it += wg_ring_steps(p, t + gridDim.x, tiles_n * tiles_m, FOLD == FOLD_GRADS);
    }
    // the last tile's store completes before the block exits
    if (STAGE && leader)
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// Rows [0, rows) of a (rows x dh) bf16 tile into shared memory with leading
// dimension ld; rows >= valid are zero. 16-byte cp.async copies (dh % 8 ==
// 0), all in flight together; the caller commits and waits.
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src,
                                          size_t src_stride, int rows,
                                          int valid, int dh, int tid,
                                          int nthreads) {
  const int per_row = dh / 8;
  for (int c = tid; c < rows * per_row; c += nthreads) {
    const int r = c / per_row, cc = (c % per_row) * 8;
    const bool ok = r < valid;
    cp_async16(dst + r * ld + cc, ok ? src + r * src_stride + cc : src, ok);
  }
}

// Key and value rows j0 .. j0 + rows - 1 of one head (columns col ..
// col + dh - 1) of batch row b into shared memory. Without a prefix (PRE
// false, P = 0) key j is token j of qkv (B*T, 3D). With one, keys 0..P-1
// come from the prefix buffer kvp (B*P, 2D: K | V) and key j >= P is token
// j - P. Rows past S = P + T are zero.
template <bool PRE>
__device__ __forceinline__ void load_kv(bf16* Ks, bf16* Vs, int ld,
                                        const bf16* qkv, const bf16* kvp,
                                        int b, int T, int P, int D, int col,
                                        int j0, int rows, int dh, int tid,
                                        int nthreads) {
  const size_t rs = 3 * (size_t)D;
  if (!PRE) {
    const bf16* base = qkv + ((size_t)b * T + j0) * rs + col;
    load_tile(Ks, ld, base + D, rs, rows, T - j0, dh, tid, nthreads);
    load_tile(Vs, ld, base + 2 * D, rs, rows, T - j0, dh, tid, nthreads);
    return;
  }
  const int per_row = dh / 8, S = P + T;
  for (int c = tid; c < rows * per_row; c += nthreads) {
    const int r = c / per_row, cc = (c % per_row) * 8, j = j0 + r;
    const bool ok = j < S;
    const bf16* ks = qkv;
    if (j < P)
      ks = kvp + ((size_t)b * P + j) * 2 * D + col + cc;
    else if (ok)
      ks = qkv + ((size_t)b * T + j - P) * rs + D + col + cc;
    cp_async16(Ks + r * ld + cc, ks, ok);
    cp_async16(Vs + r * ld + cc, ok ? ks + D : qkv, ok);
  }
}

// The additive mask is null, a (T, S) matrix, or (ROW) one key-mask row of
// S values for every query (the KV-prefix slots' validity). A key-mask row
// is staged in shared memory once a block; the matrix is read from device
// memory as the scores need it. ROW is a template flag, so the kernels
// without it keep their registers for the score rows.
template <bool ROW>
__device__ __forceinline__ void stage_mask_row(float* Ms, const float* mask,
                                               int S, int Sp, int tid,
                                               int nthreads) {
  if constexpr (ROW)
    for (int j = tid; j < Sp; j += nthreads) Ms[j] = j < S ? mask[j] : 0.f;
}


template <bool ROW>
__device__ __forceinline__ float mask_at(const float* mask, const float* Ms,
                                         int i, int j, int S, int T) {
  if constexpr (ROW) return Ms[j];
  return mask && i < T ? mask[(size_t)i * S + j] : 0.f;
}

// ---------------------------------------------------------------------------
// Tile-liveness map of a (T, S) mask (the prefix kernels' 2-D mask, e.g.
// ProtoCLIP's block-diagonal suffix mask, 5.6% live at 512 x 537), one
// buffer: a byte per block of 16 query rows x 16 keys (ceil(T/16) row
// blocks of nkb = ceil(S/16)), then, 16-byte aligned, 8 words a block.
//   * byte 0: the block is dead. Only if every entry of it (rows < T, keys
//     < S) is -inf, so any finite entry, NaN or +inf keeps it, and only if
//     each of its rows has a live key somewhere: a row with no live key at
//     all keeps its whole row of blocks, so it gets the NaN the full sweep
//     gives it (p = exp(-inf - -inf)) and hands that NaN on to every key's
//     dk and dv as the full sweep does. Every entry of a dead block has p =
//     0 exactly in a row whose max is finite, so it adds exact zeros to the
//     row sums, ctx, dq, dk and dv.
//   * byte 2: live, and every entry is +0.0 or -inf (a causal or
//     block-diagonal mask): the tiled roads and the dk/dv kernel take its
//     entries from the words, 32 bits a row pair, not from the fp32 mask.
//     Word w holds row w's 16 bits (bit c: key 16k + c is not -inf) in its
//     low half and row w + 8's in its high half; rows past T are all ones
//     (the kernels add 0 there, as mask_at does), keys past S zero.
//   * byte 1: live, any other values: the kernels read the mask.
// fmaf(s, sl2, bit ? 0 : -inf) is fmaf(s, sl2, log2(e) * m) for m = +0 or
// -inf, so the kernels that skip dead blocks and read the bits give the
// full sweep's values bit for bit. A null map is every block live, read
// from the mask: the full sweep. One block of 8 warps a 16-row group reads
// the group's rows twice (a few microseconds at 512 x 537); each op call
// builds its map anew.
// ---------------------------------------------------------------------------
constexpr int TM_THREADS = 256;

// Bytes of a map's byte part, 16-byte aligned: its words start there.
__host__ __device__ inline size_t tile_map_words_at(int T, int S) {
  return ((size_t)((T + 15) / 16) * ((S + 15) / 16) + 15) / 16 * 16;
}

__global__ void __launch_bounds__(TM_THREADS)
mask_tile_map_kernel(const float* __restrict__ mask,
                     unsigned char* __restrict__ tmap, int T, int S) {
  __shared__ unsigned rows_live;   // bit r: row 16 rb + r has a live key
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rb = blockIdx.x, nkb = (S + 15) / 16;
  unsigned* words = reinterpret_cast<unsigned*>(tmap + tile_map_words_at(T, S));
  if (tid == 0) rows_live = 0u;
  __syncthreads();
  for (int r = warp; r < 16; r += TM_THREADS / 32) {
    const int i = rb * 16 + r;
    bool any = i >= T;   // a row past T is no row of the block
    if (i < T)
      for (int j = lane; j < S; j += 32)
        any |= mask[(size_t)i * S + j] != -INFINITY;
    if (__any_sync(0xffffffffu, any) && lane == 0) atomicOr(&rows_live, 1u << r);
  }
  __syncthreads();
  const bool whole = rows_live != 0xffffu;
  for (int kb = warp; kb < nkb; kb += TM_THREADS / 32) {
    // lane: row r = lane / 2 of the block, keys (lane & 1) * 8 .. + 7
    const int r = lane >> 1, i = rb * 16 + r, j0 = kb * 16 + (lane & 1) * 8;
    unsigned bits = 0xffu;   // a row past T: every key adds 0
    bool any = false, plain = true;
    if (i < T) {
      bits = 0u;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (j0 + e >= S) continue;
        const float v = mask[(size_t)i * S + j0 + e];
        const bool lv = v != -INFINITY;
        any |= lv;
        bits |= (unsigned)lv << e;
        plain &= !lv || __float_as_uint(v) == 0u;   // -inf or +0.0
      }
    }
    any = __any_sync(0xffffffffu, any);
    plain = __all_sync(0xffffffffu, plain);
    // the even lane's row: its 8 keys, then the odd lane's
    const unsigned row = bits | (__shfl_xor_sync(0xffffffffu, bits, 1) << 8);
    const unsigned row8 = __shfl_sync(0xffffffffu, row, (lane + 16) & 31);
    if (!(lane & 1) && r < 8)
      words[((size_t)rb * nkb + kb) * 8 + r] = (row & 0xffffu) | (row8 << 16);
    if (lane == 0)
      tmap[(size_t)rb * nkb + kb] = (whole || any) ? (plain ? 2 : 1) : 0;
  }
}

// The register roads: of a warp's 16-key blocks half, half + 2, ... (n <=
// 32 of them) of row block rb, bit k of live where block half + 2k is live
// in the map and bit k of plain where its entries come from the map's
// words (byte 2); without a map every block live, none plain. Warp-wide
// (ballots).
__device__ __forceinline__ void map_blocks(const unsigned char* tmap, int rb,
                                           int nkb, int half, int n, int lane,
                                           unsigned& live, unsigned& plain) {
  if (!tmap) {
    live = 0xffffffffu;
    plain = 0u;
    return;
  }
  const unsigned v = lane < n ? tmap[(size_t)rb * nkb + half + 2 * lane] : 0u;
  live = __ballot_sync(0xffffffffu, v != 0u);
  plain = __ballot_sync(0xffffffffu, v == 2u);
}

// The register roads deal the query groups to their units (the warp pairs
// of every split, unit u of U): the k-th group of unit u (grp: its
// (k-1)-th), -1 past its last. Without a map: groups u, u + U, ... Under a
// map the groups go by
// their live work, heaviest first: unit u takes the groups u, 2U - 1 - u,
// 2U + u, ... from the last (a snake), so a causal mask's heaviest groups
// go one to a unit and its lightest pair up (5 groups on 4 pairs: 4, 3, 2
// and 1 + 0; on 2 pairs: 4 + 1 + 0 and 3 + 2). Under a causal mask, alone
// or behind always-visible prefix keys, a group's live 16-key blocks grow
// with its index; the order is fixed, not read from the map, so the first
// group's queries load before anything else.
__device__ __forceinline__ int unit_group(int k, int grp, int u, int U,
                                          int ngroups, bool by_work) {
  if (!by_work) {
    const int next = k ? grp + U : u;
    return next < ngroups ? next : -1;
  }
  const int r = (k & 1) ? (k + 1) * U - 1 - u : k * U + u;
  return r < ngroups ? ngroups - 1 - r : -1;
}

// The tiled roads: of the four 16-key blocks of the 64-key tile at k0, for
// row block rb, bit kb is set where block kb is live and bit 4 + kb where
// its entries come from the map's words (byte 2); 0xf (all live, read from
// the mask) without MAP or without a map.
template <bool MAP>
__device__ __forceinline__ unsigned tile_blocks(const unsigned char* tmap,
                                                int rb, int nkb, int k0) {
  if constexpr (!MAP) {
    return 0xfu;
  } else {
    if (!tmap) return 0xfu;
    unsigned sub = 0u;
    const int kb0 = k0 / 16;
#pragma unroll
    for (int kb = 0; kb < 4; ++kb) {
      const unsigned v = kb0 + kb < nkb ? tmap[(size_t)rb * nkb + kb0 + kb] : 0u;
      sub |= (v != 0u) << kb | (v == 2u) << (4 + kb);
    }
    return sub;
  }
}

// The tiled roads: the map's words of the 16-key blocks sub marks (bits
// 4-7) for the lane's rows g (low half) and g + 8 (high half) of row block
// rb; 0 for the others.
template <bool MAP>
__device__ __forceinline__ void tile_words(unsigned (&wb)[4],
                                           const unsigned* words, int rb,
                                           int nkb, int k0, unsigned sub,
                                           int g) {
#pragma unroll
  for (int kb = 0; kb < 4; ++kb)
    wb[kb] = MAP && ((sub >> (4 + kb)) & 1u)
                 ? words[((size_t)rb * nkb + k0 / 16 + kb) * 8 + g] : 0u;
}

// log2(e) x the mask entry (i, j) of a tiled-road score: from the map's
// words where sub marks its block (bit (j & 15) of the row's half: +0.0 or
// -inf), else from the mask; e < 2 is row g, else g + 8.
template <bool MAP, bool ROW>
__device__ __forceinline__ float tile_mask(const float* mask, const float* Ms,
                                           const unsigned (&wb)[4],
                                           unsigned sub, int nt, int e, int i,
                                           int j, int S, int T) {
  if constexpr (MAP) {
    if ((sub >> (4 + (nt >> 1))) & 1u)
      return (wb[nt >> 1] >> ((e >> 1) * 16 + (j & 15))) & 1u ? 0.f : -INFINITY;
  }
  return LOG2E * mask_at<ROW>(mask, Ms, i, j, S, T);
}

// The tiled roads: the 64-key tiles live for some row of the 64-query tile
// at row block rb0 (the OR of its up to 4 x 4 map bytes), in order, into
// tl[0 .. n) with n at tl[nk], by warp 0; every thread returns n after a
// barrier. nk (every tile, tl unread) without MAP or without a map.
template <bool MAP>
__device__ __forceinline__ int live_key_tiles(int* tl,
                                              const unsigned char* tmap,
                                              int rb0, int nrb, int nkb,
                                              int nk, int warp, int lane) {
  if constexpr (!MAP) {
    return nk;
  } else {
    if (!tmap) return nk;
    if (warp == 0) {
      int cnt = 0;
      for (int base = 0; base < nk; base += 32) {
        const int k = base + lane;
        bool lv = false;
        if (k < nk)
          for (int r = rb0; r < min(rb0 + 4, nrb); ++r)
            for (int kb = 4 * k; kb < min(4 * k + 4, nkb); ++kb)
              lv |= tmap[(size_t)r * nkb + kb] != 0;
        const unsigned bal = __ballot_sync(0xffffffffu, lv);
        if (lv) tl[cnt + __popc(bal & ((1u << lane) - 1u))] = k;
        cnt += __popc(bal);
      }
      if (lane == 0) tl[nk] = cnt;
    }
    __syncthreads();
    return tl[nk];
  }
}

// ---------------------------------------------------------------------------
// Attention forward: ctx = softmax(q k^T * scale + mask) v per head.
// qkv (B*T, 3D) bf16, ctx (B*T, D) bf16. One block per (head, batch row),
// grid (H, B): K and V are loaded into shared memory once, in 64-row chunks
// of cp.async copies, one commit group a chunk, and the first q k^T
// products start as soon as the chunk they read has landed. The block's 8
// warps work in 4 pairs; pair p takes the query rows 16 at a time (groups
// p, p + 4, ...; under a tile map by their live work, unit_group; each
// group's q through the pair's 16-row slab, loaded while the pair's
// previous group computes), so a ragged last group (T = 197: 5 live rows)
// costs 16 rows, not a 64-row tile. The two warps of a pair split the
// group's 16-key blocks (warp_tile: in turn where a tile map may come, else
// in halves) and keep their score rows in registers, so the softmax is the
// exact full-row one, its row max and row sum exchanged through shared
// memory: fp32 scores of bf16 q.k,
// times scale, plus the mask; p = exp(s - max) / sum (as exp2 of
// log2(e)-scaled scores) normalised in fp32, then rounded to bf16 as the A
// operand of p @ v (mma.sync m16n8k16, fp32 accumulation); the second warp's
// part of p @ v is added to the first's, in that order, before the one
// rounding of ctx. Where B x H blocks would leave SMs idle (the ER family's
// 16 or 8 batch rows: 192 or 96 blocks for 264 slots), the launcher splits
// each (head, batch row) over gridDim.x blocks (grid (splits, H, B): a
// row's splits are dispatched together), split z taking every
// gridDim.x-th round of the pairs' query groups; each group's arithmetic
// is the same, so ctx is the unsplit road's bit for bit, and K and V are
// loaded once a block (from L2 for the later splits). With PRE the keys
// and values are the P prefix rows of kvp
// followed by the T tokens (S = P + T; P may be 0) and the mask is (T, S);
// without, S = T and no mask or map. Under a tile map a warp skips the
// products of its dead 16-key blocks and takes a plain block's mask entries
// from the map's words (attn_half_mask). The row max is taken after the
// mask is added, so a dead key (-inf) gets p = 0 exactly.
// ---------------------------------------------------------------------------
constexpr int KV_CHUNK = 64;   // key rows per commit group
constexpr int AF_PAIRS = 4, AF_THREADS = 64 * AF_PAIRS;

// cp.async.wait_group n for a count only known once a loop is unrolled
__device__ __forceinline__ void cp_async_wait_upto3(int n) {
  if (n <= 0) cp_async_wait<0>();
  else if (n == 1) cp_async_wait<1>();
  else if (n == 2) cp_async_wait<2>();
  else cp_async_wait<3>();
}

// The 64 threads of a warp pair (named barrier 1 + pair).
__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + pair) : "memory");
}

// The 16-key blocks of a group that warp `half` of a pair holds: its
// 8-key tile i is key tile warp_tile(i, t0), t0 its first tile
// (warp_tiles). In the kernels that may take a tile map (IL) the warps take
// the blocks in turn, half, half + 2, ...: under a causal mask each gets
// half of a group's live blocks, and as the split does not look at the
// map, a map only drops terms (exact zeros) and leaves the order of the
// rest. The others (no mask, or a key-mask row) keep the halves, the first
// ceil(blocks / 2) to warp 0, and with them the order of their sums.
template <bool IL>
__device__ __forceinline__ int warp_tile(int i, int t0) {
  if constexpr (IL) return 4 * (i >> 1) + t0 + (i & 1);
  else return t0 + i;
}

// Warp `half`'s first 8-key tile (t0) and count of them (tcnt) of npair
// 16-key blocks.
template <bool IL>
__device__ __forceinline__ void warp_tiles(int npair, int half, int& t0,
                                           int& tcnt) {
  const int h0 = (npair + 1) / 2;
  if constexpr (IL) {
    t0 = 2 * half;
    tcnt = 2 * ((npair + 1 - half) / 2);
  } else {
    t0 = half ? 2 * h0 : 0;
    tcnt = half ? 2 * (npair - h0) : 2 * h0;
  }
}

// s[i] (16 x 8 scores of the query fragments qa) += q k^T for this warp's
// 8-key tiles warp_tile(i, t0), i < tcnt, that lie in [lo, hi) and whose
// 16-key block is live (bit i / 2 of lm).
template <int DH, int HT, bool IL>
__device__ __forceinline__ void attn_half_scores(float (*s)[4],
                                                 unsigned (*qa)[4],
                                                 const bf16* Ks, int t0,
                                                 int tcnt, int lo, int hi,
                                                 unsigned lm, int lane) {
  constexpr int LD = DH + 8;
#pragma unroll
  for (int i = 0; i < HT; i += 2) {
    const int t = warp_tile<IL>(i, t0);
    if (i >= tcnt || t < lo || t >= hi || !((lm >> (i >> 1)) & 1u)) continue;
#pragma unroll
    for (int kc = 0; kc < DH / 16; ++kc) {
      unsigned kb[4];
      ldsm_x4(kb, Ks + (t * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                      kc * 16 + ((lane >> 3) & 1) * 8);
      mma16816(s[i], qa[kc], kb[0], kb[1]);
      mma16816(s[i + 1], qa[kc], kb[2], kb[3]);
    }
  }
}

// The register roads' scores of a group in base 2: s * scale * log2(e) +
// log2(e) * mask on this warp's live 16-key blocks (bit i / 2 of lm), -inf
// on the rest and past S (p = 0 exactly, no mask read). A block marked in
// lp (map byte 2: every entry +0.0 or -inf) takes its entries from the
// map's words, wrow[8 kb] holding the lane's rows ia (low half) and ib
// (high half) of block kb, the others from the mask: fmaf(s, sl2, bit ? 0 :
// -inf) is fmaf(s, sl2, log2(e) * m) for m = +0 or -inf, so the values are
// the mask's bit for bit. Returns the lane's row maxima of its entries.
template <int HT, bool ROW, bool IL>
__device__ __forceinline__ void attn_half_mask(
    float (*s)[4], int t0, int tcnt, unsigned lm, unsigned lp,
    const unsigned* wrow, const float* mask, const float* Ms, int ia, int ib,
    int S, int T, float sl2, int t4, float& ma, float& mb) {
  ma = mb = -INFINITY;
#pragma unroll
  for (int i = 0; i < HT; i += 2) {
    const bool on = i < tcnt && ((lm >> (i >> 1)) & 1u);
    const bool words = on && ((lp >> (i >> 1)) & 1u);   // warp-uniform
    const unsigned w =
        words ? wrow[8 * (warp_tile<IL>(i, t0) >> 1)] : 0u;
#pragma unroll
    for (int ii = i; ii < i + 2; ++ii) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = warp_tile<IL>(ii, t0) * 8 + 2 * t4 + e;
        float va = -INFINITY, vb = -INFINITY;
        if (on && j < S) {
          if (words) {
            va = fmaf(s[ii][e], sl2, (w >> (j & 15)) & 1u ? 0.f : -INFINITY);
            vb = fmaf(s[ii][2 + e], sl2,
                      (w >> (16 + (j & 15))) & 1u ? 0.f : -INFINITY);
          } else {
            va = fmaf(s[ii][e], sl2, LOG2E * mask_at<ROW>(mask, Ms, ia, j, S, T));
            vb = fmaf(s[ii][2 + e], sl2,
                      LOG2E * mask_at<ROW>(mask, Ms, ib, j, S, T));
          }
        }
        s[ii][e] = va;
        s[ii][2 + e] = vb;
        ma = fmaxf(ma, va);
        mb = fmaxf(mb, vb);
      }
    }
  }
}

template <int DH, int MAXNT, bool PRE, bool ROW>   // MAXNT: 8-key tiles a row holds
__global__ void __launch_bounds__(AF_THREADS, 2)
attn_fwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ kvp,
                const float* __restrict__ mask,
                const unsigned char* __restrict__ tmap, bf16* __restrict__ ctx,
                int T, int P, int D, int Sp,
                float scale) {
  constexpr bool MAP = PRE && !ROW;   // a (T, S) mask may bring a tile map
  // a (T, T) mask takes the PRE instances with P = 0 (llc_attn_fwd), so
  // these have none: null at compile time, their mask reads fold away
  if constexpr (!PRE) mask = nullptr;
  constexpr int LD = DH + 8;
  constexpr int NCH = (MAXNT * 8 + KV_CHUNK - 1) / KV_CHUNK;
  constexpr int HT = 2 * ((MAXNT / 2 + 1) / 2);   // 8-key tiles a warp holds
  static_assert(NCH <= 4, "cp_async_wait_upto3");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + Sp * LD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int pair = warp >> 1, half = warp & 1;
  bf16* Qp = Vs + Sp * LD + pair * 16 * LD;                  // the pair's slab
  float* xs = reinterpret_cast<float*>(Vs + Sp * LD + AF_PAIRS * 16 * LD);
  float* red = xs + pair * 64;        // [max | sum][half][16 rows]
  float* op = xs + AF_PAIRS * 64 + pair * 1024;   // the second warp's p @ v
  float* Ms = xs + AF_PAIRS * (64 + 1024);        // a key-mask row
  unsigned char* Mp = reinterpret_cast<unsigned char*>(Ms);   // MAP: the map
  unsigned* Mw = reinterpret_cast<unsigned*>(Mp + 256);       // ... its words
  const int g = lane >> 2, t4 = lane & 3;
  const int hd = blockIdx.y, b = blockIdx.z;
  const int S = P + T, ngroups = (T + 15) / 16;
  // unit u = blockIdx.x * AF_PAIRS + pair of U: split z = blockIdx.x takes
  // its pairs' groups (unit_group); g0 the pair's first
  const int U = AF_PAIRS * gridDim.x, u = blockIdx.x * AF_PAIRS + pair;
  const bool by_work = MAP && tmap;
  const int npair = Sp / 16;
  const int g0 = unit_group(0, 0, u, U, ngroups, by_work);
  // this warp's 16-key blocks (warp_tile)
  int t0, tcnt;
  warp_tiles<MAP>(npair, half, t0, tcnt);
  const size_t rs = 3 * (size_t)D;
  const bf16* qbase = qkv + (size_t)b * T * rs + hd * DH;
  // this warp's live 16-key blocks of group grp's rows (bit i / 2 for its
  // tile i; the tiles a dead block holds get no product and no mask read)
  // and its plain ones (entries from the words); the map (<= 16 x 16 bytes
  // and their words) is staged in shared memory
  unsigned lm = 0xffffffffu, lp = 0u;
  auto live_blocks = [&](int grp) {
    if constexpr (MAP) map_blocks(tmap ? Mp : nullptr, grp, npair, half,
                                  tcnt / 2, lane, lm, lp);
  };
  // commit groups, oldest first: the pair's first query slab, then one per
  // K/V chunk (empty past Sp, so the count is the same for every shape)
  if (g0 >= 0)
    load_tile(Qp, LD, qbase + (size_t)g0 * 16 * rs, rs, 16, T - g0 * 16, DH,
              tid & 63, 64);
  cp_async_commit();
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int j0 = c * KV_CHUNK;
    if (j0 < Sp)
      load_kv<PRE>(Ks + j0 * LD, Vs + j0 * LD, LD, qkv, kvp, b, T, P, D,
                   hd * DH, j0, min(KV_CHUNK, Sp - j0), DH, tid, AF_THREADS);
    cp_async_commit();
  }
  stage_mask_row<ROW>(Ms, mask, S, Sp, tid, AF_THREADS);
  if constexpr (MAP) {   // seen after the first chunk's barrier
    if (tmap) {
      const unsigned* words = reinterpret_cast<const unsigned*>(
          tmap + tile_map_words_at(T, S));
      for (int x = tid; x < ngroups * npair; x += AF_THREADS) Mp[x] = tmap[x];
      for (int x = tid; x < ngroups * npair * 8; x += AF_THREADS) Mw[x] = words[x];
    }
  }

  unsigned qa[DH / 16][4];
  float s[HT][4];
#pragma unroll
  for (int i = 0; i < HT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
  // the first group's scores, chunk by chunk as K lands (every warp takes
  // part in the barriers)
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    cp_async_wait_upto3(NCH - 1 - c);
    __syncthreads();
    if (g0 >= 0) {
      if (c == 0) {
        live_blocks(g0);
#pragma unroll
        for (int kc = 0; kc < DH / 16; ++kc)
          ldsm_x4(qa[kc], Qp + (lane & 15) * LD + kc * 16 + (lane >> 4) * 8);
      }
      attn_half_scores<DH, HT, MAP>(s, qa, Ks, t0, tcnt, 8 * c, 8 * c + 8, lm,
                                    lane);
    }
  }

  const float sl2 = scale * LOG2E;
  for (int k = 0, grp = g0; grp >= 0;
       ++k, grp = unit_group(k, grp, u, U, ngroups, by_work)) {
    if (k > 0) {     // a later group: K and V are all in shared memory
      live_blocks(grp);
#pragma unroll
      for (int kc = 0; kc < DH / 16; ++kc)
        ldsm_x4(qa[kc], Qp + (lane & 15) * LD + kc * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < HT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
      attn_half_scores<DH, HT, MAP>(s, qa, Ks, t0, tcnt, 0, MAXNT, lm, lane);
    }

    // scale and mask in base 2 (s log2(e), so exp2 gives exp(s - max) at
    // one MUFU.EX2), this warp's half of the row max (a row lives in the 4
    // lanes of a quad), then the pair's
    const int ia = grp * 16 + g, ib = ia + 8;
    float ma, mb;
    attn_half_mask<HT, ROW, MAP>(s, t0, tcnt, lm, lp,
                                 Mw + (size_t)grp * npair * 8 + g, mask, Ms,
                                 ia, ib, S, T, sl2, t4, ma, mb);
    ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, 1));
    ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, 2));
    mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 1));
    mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 2));
    if (t4 == 0) {
      red[half * 16 + g] = ma;
      red[half * 16 + g + 8] = mb;
    }
    pair_sync(pair);   // both halves' maxima, and both warps have read the slab
    ma = fmaxf(ma, red[(half ^ 1) * 16 + g]);
    mb = fmaxf(mb, red[(half ^ 1) * 16 + g + 8]);
    // the next group's queries into the slab while this group's products run
    const int next = unit_group(k + 1, grp, u, U, ngroups, by_work);
    if (next >= 0)
      load_tile(Qp, LD, qbase + (size_t)next * 16 * rs, rs, 16,
                T - next * 16, DH, tid & 63, 64);
    cp_async_commit();

    float la = 0.f, lb = 0.f;
#pragma unroll
    for (int i = 0; i < HT; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[i][e] = exp2f(s[i][e] - ma);
        s[i][2 + e] = exp2f(s[i][2 + e] - mb);
        la += s[i][e];
        lb += s[i][2 + e];
      }
    }
    la += __shfl_xor_sync(0xffffffffu, la, 1);
    la += __shfl_xor_sync(0xffffffffu, la, 2);
    lb += __shfl_xor_sync(0xffffffffu, lb, 1);
    lb += __shfl_xor_sync(0xffffffffu, lb, 2);
    if (t4 == 0) {
      red[32 + half * 16 + g] = la;
      red[32 + half * 16 + g + 8] = lb;
    }
    pair_sync(pair);
    // a + b == b + a in fp32: both warps get the same row sums
    la += red[32 + (half ^ 1) * 16 + g];
    lb += red[32 + (half ^ 1) * 16 + g + 8];
    const float ila = 1.f / la, ilb = 1.f / lb;

    // this warp's part of o = p16 @ v, p normalised in fp32 before the bf16
    // rounding
    float o[DH / 8][4];
#pragma unroll
    for (int ct = 0; ct < DH / 8; ++ct)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[ct][e] = 0.f;
#pragma unroll
    for (int i = 0; i < HT; i += 2) {
      if (i >= tcnt || !((lm >> (i >> 1)) & 1u)) continue;   // p = 0 there
      unsigned pa[4];
      pa[0] = pack_bf16(s[i][0] * ila, s[i][1] * ila);
      pa[1] = pack_bf16(s[i][2] * ilb, s[i][3] * ilb);
      pa[2] = pack_bf16(s[i + 1][0] * ila, s[i + 1][1] * ila);
      pa[3] = pack_bf16(s[i + 1][2] * ilb, s[i + 1][3] * ilb);
      const int k0 = warp_tile<MAP>(i, t0) * 8;
#pragma unroll
      for (int cp = 0; cp < DH / 16; ++cp) {
        unsigned vb[4];
        ldsm_x4_t(vb, Vs + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                          cp * 16 + (lane >> 4) * 8);
        mma16816(o[2 * cp], pa, vb[0], vb[1]);
        mma16816(o[2 * cp + 1], pa, vb[2], vb[3]);
      }
    }
    if (half) {
#pragma unroll
      for (int ct = 0; ct < DH / 8; ++ct)
#pragma unroll
        for (int e = 0; e < 4; ++e) op[(ct * 4 + e) * 32 + lane] = o[ct][e];
    }
    cp_async_wait<0>();   // the next slab has landed (this thread's copies)
    pair_sync(pair);      // ... and every copy of the pair, and the partial o
    if (!half) {
#pragma unroll
      for (int ct = 0; ct < DH / 8; ++ct) {
        const int c = hd * DH + ct * 8 + 2 * t4;
#pragma unroll
        for (int e = 0; e < 4; ++e) o[ct][e] += op[(ct * 4 + e) * 32 + lane];
        if (ia < T)
          *reinterpret_cast<unsigned*>(ctx + ((size_t)b * T + ia) * D + c) =
              pack_bf16(o[ct][0], o[ct][1]);
        if (ib < T)
          *reinterpret_cast<unsigned*>(ctx + ((size_t)b * T + ib) * D + c) =
              pack_bf16(o[ct][2], o[ct][3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Shared pieces of the tiled roads (S > 256 keys) and the backward.
// ---------------------------------------------------------------------------
constexpr int TQ = 64;            // query (or key) rows a tile of the tiled roads
constexpr int TT_THREADS = 128;   // tiled roads: 4 warps x 16 rows
// The tiled roads under a tile map (MAP) hold up to this many live 64-key
// tiles in shared memory for both passes, each loaded once, all in flight
// together: ProtoCLIP's block-diagonal mask leaves a 64-query tile (8
// classes) the prefix tile and the two its 64 suffix keys straddle. More
// live tiles stream through two of the buffers as without a map.
constexpr int TILES_HELD = 3;

// cp.async.wait_group n for a count known only at run time: waiting for
// fewer pending groups than asked is also correct
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n < 0 ? 0 : n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<6>(); break;
  }
}


// acc (16 x 64 keys) += a . B^T: a the warp's 16-row fragments over the head
// dim, B the 64 rows of a [key][dim] tile (16-key chunks at or past nlive,
// or whose bit in sub is clear, skipped).
template <int DH>
__device__ __forceinline__ void dot_rows64(float (*acc)[4],
                                           const unsigned (*a)[4],
                                           const bf16* Bs, int nlive,
                                           unsigned sub, int lane) {
  constexpr int LD = DH + 8;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (16 * j >= nlive || !((sub >> j) & 1u)) continue;
#pragma unroll
    for (int kc = 0; kc < DH / 16; ++kc) {
      unsigned kb[4];
      ldsm_x4(kb, Bs + (16 * j + (lane & 7) + ((lane >> 4) << 3)) * LD +
                      kc * 16 + ((lane >> 3) & 1) * 8);
      mma16816(acc[2 * j], a[kc], kb[0], kb[1]);
      mma16816(acc[2 * j + 1], a[kc], kb[2], kb[3]);
    }
  }
}

// acc (16 x DH) += bf16(x) . B: x fp32 (16 x 64 keys, C fragments), rounded
// once to bf16 as the A operand; B the [key][dim] tile x contracts over
// (16-key chunks at or past nlive, or whose bit in sub is clear, skipped).
template <int DH>
__device__ __forceinline__ void mm_rows64(float (*acc)[4], const float (*x)[4],
                                          const bf16* Bs, int nlive,
                                          unsigned sub, int lane) {
  constexpr int LD = DH + 8;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (16 * c >= nlive || !((sub >> c) & 1u)) continue;
    unsigned a[4];
    a[0] = pack_bf16(x[2 * c][0], x[2 * c][1]);
    a[1] = pack_bf16(x[2 * c][2], x[2 * c][3]);
    a[2] = pack_bf16(x[2 * c + 1][0], x[2 * c + 1][1]);
    a[3] = pack_bf16(x[2 * c + 1][2], x[2 * c + 1][3]);
#pragma unroll
    for (int cp = 0; cp < DH / 16; ++cp) {
      unsigned vb[4];
      ldsm_x4_t(vb, Bs + (16 * c + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                        cp * 16 + (lane >> 4) * 8);
      mma16816(acc[2 * cp], a, vb[0], vb[1]);
      mma16816(acc[2 * cp + 1], a, vb[2], vb[3]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero_acc(float (*x)[4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[i][e] = 0.f;
}

// ---------------------------------------------------------------------------
// Attention forward, tiled road (S = P + T > 256, no key limit): grid
// (ceil(T/64), H, B), 4 warps of 16 query rows. K and V stream through
// double-buffered 64-key cp.async tiles in two passes: the first takes the
// row max and the row sum (the sum brought to each new max, so the second
// pass normalises with the row's true max and sum), the second p = exp(s -
// max) / sum normalised in fp32 and rounded once to bf16 before p @ v, as
// _kernel:102-108. No online rescaling of p or of o. With a tile map (PRE,
// a 2-D mask) both passes walk only the 64-key tiles live for some row of
// the query tile: a dead tile gets no load, no q.k and no mask read. Up to
// TILES_HELD live tiles stay in shared memory for both passes, loaded once
// and all in flight together (more stream through two buffers, the next
// live one prefetched). Inside a live tile each warp skips the 16-key
// blocks dead for its 16 rows (their scores -inf, so p = 0): the products,
// the mask reads, and their chunk of p @ v; a block of +0.0 and -inf
// entries only takes them from the map's words, not from the mask.
// ---------------------------------------------------------------------------
template <int DH, bool PRE, bool ROW>
__global__ void __launch_bounds__(TT_THREADS)
attn_fwd_tiled_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ kvp,
                      const float* __restrict__ mask,
                      const unsigned char* __restrict__ tmap,
                      bf16* __restrict__ ctx, int T, int P, int D, int Sp,
                      float scale) {
  constexpr bool MAP = PRE && !ROW;
  if constexpr (!PRE) mask = nullptr;   // as attn_fwd_kernel's
  constexpr int LD = DH + 8, TE = TQ * LD, NBUF = MAP ? TILES_HELD : 2;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + TE;           // NBUF x [key][dim]
  bf16* Vs = Ks + NBUF * TE;    // NBUF x [key][dim]
  float* Ms = reinterpret_cast<float*>(Vs + NBUF * TE);   // a key-mask row
  int* tl = reinterpret_cast<int*>(Vs + NBUF * TE);       // MAP: live key tiles
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int hd = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * TQ;
  const int r0 = warp * 16, S = P + T, nk = (S + TQ - 1) / TQ, nkb = Sp / 16;
  const size_t rs = 3 * (size_t)D;
  load_tile(Qs, LD, qkv + ((size_t)b * T + q0) * rs + hd * DH, rs, TQ, T - q0,
            DH, tid, TT_THREADS);
  const int nl = live_key_tiles<MAP>(tl, tmap, q0 / 16, (T + 15) / 16, nkb,
                                     nk, warp, lane);
  auto key_tile = [&](int n) { return (MAP && tmap ? tl[n] : n) * TQ; };
  const unsigned* words = tmap ? reinterpret_cast<const unsigned*>(
      tmap + tile_map_words_at(T, S)) : nullptr;
  const int total = 2 * nl;
  // held: every live tile in its own buffer for both passes, one commit
  // group each (the first with Q); else the first tile's, the rest
  // prefetched into the other of two buffers an iteration ahead
  const bool held = MAP && tmap && nl <= NBUF;
  for (int n = 0; n < (held ? nl : 1); ++n) {
    load_kv<PRE>(Ks + n * TE, Vs + n * TE, LD, qkv, kvp, b, T, P, D, hd * DH,
                 key_tile(n), TQ, DH, tid, TT_THREADS);
    cp_async_commit();
  }
  stage_mask_row<ROW>(Ms, mask, S, Sp, tid, TT_THREADS);

  const bool live = q0 + r0 < T;   // warp-uniform
  const int ia = q0 + r0 + g, ib = ia + 8, rb = (q0 + r0) / 16;
  const float sl2 = scale * LOG2E;
  unsigned qa[DH / 16][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, il[2] = {0.f, 0.f};
  float o[DH / 8][4], s[8][4];
  zero_acc<DH / 8>(o);
  for (int it = 0; it < total; ++it) {
    const int pass = it >= nl, k0 = key_tile(it % nl);
    const int buf = held ? it % nl : it & 1;
    if (held) {
      if (it < nl) cp_async_wait_dyn(nl - 1 - it);
    } else if (it + 1 < total) {
      const int kn = key_tile((it + 1) % nl), nb = buf ^ 1;
      load_kv<PRE>(Ks + nb * TE, Vs + nb * TE, LD, qkv, kvp, b, T, P, D,
                   hd * DH, kn, TQ, DH, tid, TT_THREADS);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (!held || it < nl) __syncthreads();
    if (live) {
      if (it == 0) {
#pragma unroll
        for (int kc = 0; kc < DH / 16; ++kc)
          ldsm_x4(qa[kc], Qs + (r0 + (lane & 15)) * LD + kc * 16 + (lane >> 4) * 8);
      }
      const unsigned sub = tile_blocks<MAP>(tmap, rb, nkb, k0);
      // a tile dead for all 16 rows leaves m and l as they are (exp2 of -inf
      // is 0) and adds nothing to o
      if (sub & 0xfu) {
        unsigned wb[4];
        tile_words<MAP>(wb, words, rb, nkb, k0, sub, g);
        zero_acc<8>(s);
        dot_rows64<DH>(s, qa, Ks + buf * TE, S - k0, sub, lane);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e < 2 ? ia : ib, j = k0 + nt * 8 + 2 * t4 + (e & 1);
            s[nt][e] = j < S && ((sub >> (nt >> 1)) & 1u)
                           ? fmaf(s[nt][e], sl2,
                                  tile_mask<MAP, ROW>(mask, Ms, wb, sub, nt,
                                                      e, i, j, S, T))
                           : -INFINITY;
          }
        if (pass == 0) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float cm = -INFINITY;
#pragma unroll
            for (int nt = 0; nt < 8; ++nt)
              cm = fmaxf(cm, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
            const float mn = fmaxf(m[h], quad_max(cm));
            if (mn != -INFINITY) {
              l[h] *= exp2f(m[h] - mn);   // 0 while m was -inf
#pragma unroll
              for (int nt = 0; nt < 8; ++nt)
                l[h] += exp2f(s[nt][2 * h] - mn) + exp2f(s[nt][2 * h + 1] - mn);
            }
            m[h] = mn;
          }
        } else {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[nt][e] = exp2f(s[nt][e] - m[e >> 1]) * il[e >> 1];   // p, fp32
          mm_rows64<DH>(o, s, Vs + buf * TE, S - k0, sub, lane);
        }
      }
      if (it == nl - 1) {
#pragma unroll
        for (int h = 0; h < 2; ++h) il[h] = 1.f / quad_sum(l[h]);
      }
    }
    if (!held) __syncthreads();   // the buffer read here is refilled next
  }
  if (!live) return;
#pragma unroll
  for (int ct = 0; ct < DH / 8; ++ct) {
    const int c = hd * DH + ct * 8 + 2 * t4;
    if (ia < T)
      *reinterpret_cast<unsigned*>(ctx + ((size_t)b * T + ia) * D + c) =
          pack_bf16(o[ct][0], o[ct][1]);
    if (ib < T)
      *reinterpret_cast<unsigned*>(ctx + ((size_t)b * T + ib) * D + c) =
          pack_bf16(o[ct][2], o[ct][3]);
  }
}

// ---------------------------------------------------------------------------
// Attention backward in two kernels, no atomics. What they compute is the
// TPU kernel's (_bwd_kernel:316-399): p = exp(s - max) / sum in fp32; dv =
// p16^T dctx; dp = dctx v^T; delta = rowsum(dp * p) in fp32; ds16 = bf16(p *
// (dp - delta)); dq = ds16 k * scale; dk = ds16^T q * scale.
//
//   dq kernel: saves, for each query row i < ceil16(T), the float4 (m2, 1/l,
//     delta, 0), m2 the row max of the log2(e)-scaled scores; rows past T
//     get (+inf, 0, 0), which gives them p = 0 in the dk/dv kernel.
//     * register road (S <= 256), attn_bwd_dq_kernel: the forward's shape.
//       One block per (head, batch row) loads K and V once in 64-row
//       cp.async chunks, the first group's q k^T following each chunk's
//       arrival; 2 warp pairs take the query rows 16 at a time, each warp
//       holding half of the group's score rows, so p and dp stay in
//       registers from the delta sum to ds (dp computed once); the halves'
//       row sums l and t = sum(dp * e) cross at one barrier, delta = t / l.
//       The second warp's part of dq is added to the first's, in that
//       order. At ~240 registers a thread, two 4-warp blocks share an SM,
//       one's loads and barriers covered by the other's products (on an
//       H100 at ViT-B/16's shape, 4 pairs a block took 0.19 ms, 2 take
//       0.155, 1 takes 0.18; PERF.md).
//     * tiled road (S > 256), attn_bwd_dq_tiled_kernel: grid (ceil(T/64), H,
//       B), K and V streamed in double-buffered 64-key tiles over two
//       passes: the row max, sum l and t = sum(dp * e), both brought to each
//       new max (delta = t / l); then ds and dq. Under a tile map
//       (attn_bwd_dq_tiled_map_kernel) the live tiles and blocks only, as
//       the tiled forward.
//   dk/dv kernel (any S), attn_bwd_dkv_kernel: one block per (head, batch
//     row), 4 warps over 16-key groups, two blocks an SM (8 warps, one
//     block an SM, took 0.151 ms where 4 take 0.130, as above); under a
//     tile map (PRE, a 2-D mask) 8 warps where one block fills the SM's
//     shared memory anyway (ProtoCLIP's K4), and, every chunk resident,
//     the warps wait for all of them once (their first key group's K and V
//     rows in flight) and then run free, each taking the next key group
//     from a counter, so the few live steps of most groups spread over the
//     warps while the dense prefix groups run (a causal (77, 77) mask
//     leaves its 5 key groups 3, 3, 2, 2 and 1 live steps). Q,
//     dctx and the row statistics come in 64-query cp.async chunks, held
//     for the whole block where shared memory allows (else streamed again
//     for each round of key groups).
//     With keys as rows, s^T = k q^T and dp^T = v dctx^T come out in the
//     layout the next products take as their A operand: p^T = exp2(s^T *
//     scale * log2(e) + mask * log2(e) - m2) * (1/l), no division, and dv +=
//     p16^T dctx, dk += ds16^T q. A key-mask row is read once a key group; a
//     (T, S) mask is staged 32 x 16 a step in the warp's shared memory, or,
//     under a tile map, a step whose two blocks are dead skipped and one
//     whose blocks hold only +0.0 and -inf taken from the map's words (the
//     words loaded for such a step only, a warp-uniform branch between the
//     two ways of taking the entries).
// Writes dqkv16 (B*T, 3D) bf16; with PRE, dk and dv of the P prefix keys go
// to dkvp16 (B*P, 2D: dK | dV). With the weight grads (qpart / kvpart not
// null) each 16-row group's fp32 column sums of dq, and of dk and dv
// (prefix keys and tokens alike), go to their partials (AttnArgs). The
// register roads split each (head, batch row) over gridDim.x blocks where
// the launcher finds that faster (attn_splits). A dead key (mask -inf) has
// p = 0, so ds = 0 and its dk and dv are exactly 0.
// ---------------------------------------------------------------------------
constexpr int DQ_PAIRS = 2, DQ_THREADS = 64 * DQ_PAIRS;


template <int DH, int MAXNT, bool PRE, bool ROW>   // MAXNT: 8-key tiles a row holds
__global__ void __launch_bounds__(DQ_THREADS)
attn_bwd_dq_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ kvp,
                   const bf16* __restrict__ dctx,
                   const float* __restrict__ mask,
                   const unsigned char* __restrict__ tmap,
                   bf16* __restrict__ dqkv16, float* __restrict__ qpart,
                   float4* __restrict__ stats, int T, int P, int D, int Sp,
                   float scale) {
  constexpr bool MAP = PRE && !ROW;
  if constexpr (!PRE) mask = nullptr;   // as attn_fwd_kernel's
  constexpr int LD = DH + 8;
  constexpr int NCH = (MAXNT * 8 + KV_CHUNK - 1) / KV_CHUNK;
  constexpr int HT = 2 * ((MAXNT / 2 + 1) / 2);   // 8-key tiles a warp holds
  static_assert(NCH <= 4, "cp_async_wait_upto3");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + Sp * LD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int pair = warp >> 1, half = warp & 1;
  bf16* Qp = Vs + Sp * LD + pair * 32 * LD;   // the pair's q slab
  bf16* Gp = Qp + 16 * LD;                    // ... and its dctx slab
  float* xs = reinterpret_cast<float*>(Vs + Sp * LD + DQ_PAIRS * 32 * LD);
  float* red = xs + pair * 96;        // [max | sum | delta][half][16 rows]
  float* op = xs + DQ_PAIRS * 96 + pair * DH * 16;   // the second warp's dq
  float* Ms = xs + DQ_PAIRS * (96 + DH * 16);        // a key-mask row
  unsigned char* Mp = reinterpret_cast<unsigned char*>(Ms);   // MAP: the map
  unsigned* Mw = reinterpret_cast<unsigned*>(Mp + 256);       // ... its words
  const int g = lane >> 2, t4 = lane & 3;
  const int hd = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int S = P + T, ngroups = (T + 15) / 16;
  // as the forward: unit u = blockIdx.x * DQ_PAIRS + pair of U takes its
  // groups from unit_group
  const int U = DQ_PAIRS * gridDim.x, u = blockIdx.x * DQ_PAIRS + pair;
  const bool by_work = MAP && tmap;
  const int npair = Sp / 16;
  const int g0 = unit_group(0, 0, u, U, ngroups, by_work);
  int t0, tcnt;
  warp_tiles<MAP>(npair, half, t0, tcnt);
  const size_t rs = 3 * (size_t)D;
  const bf16* qbase = qkv + (size_t)b * T * rs + hd * DH;
  const bf16* gbase = dctx + (size_t)b * T * D + hd * DH;
  // as the forward: this warp's live and plain 16-key blocks of group grp
  unsigned lm = 0xffffffffu, lp = 0u;
  auto live_blocks = [&](int grp) {
    if constexpr (MAP) map_blocks(tmap ? Mp : nullptr, grp, npair, half,
                                  tcnt / 2, lane, lm, lp);
  };
  auto load_slabs = [&](int grp) {
    load_tile(Qp, LD, qbase + (size_t)grp * 16 * rs, rs, 16, T - grp * 16, DH,
              tid & 63, 64);
    load_tile(Gp, LD, gbase + (size_t)grp * 16 * D, D, 16, T - grp * 16, DH,
              tid & 63, 64);
  };
  // commit groups, oldest first: the pair's first slabs, then one per K/V
  // chunk (empty past Sp, so the count is the same for every shape)
  if (g0 >= 0) load_slabs(g0);
  cp_async_commit();
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int j0 = c * KV_CHUNK;
    if (j0 < Sp)
      load_kv<PRE>(Ks + j0 * LD, Vs + j0 * LD, LD, qkv, kvp, b, T, P, D,
                   hd * DH, j0, min(KV_CHUNK, Sp - j0), DH, tid, DQ_THREADS);
    cp_async_commit();
  }
  stage_mask_row<ROW>(Ms, mask, S, Sp, tid, DQ_THREADS);
  if constexpr (MAP) {   // seen after the first chunk's barrier
    if (tmap) {
      const unsigned* words = reinterpret_cast<const unsigned*>(
          tmap + tile_map_words_at(T, S));
      for (int x = tid; x < ngroups * npair; x += DQ_THREADS) Mp[x] = tmap[x];
      for (int x = tid; x < ngroups * npair * 8; x += DQ_THREADS) Mw[x] = words[x];
    }
  }

  unsigned qa[DH / 16][4], da[DH / 16][4];
  float s[HT][4];
  zero_acc<HT>(s);
  // the first group's scores, chunk by chunk as K lands
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    cp_async_wait_upto3(NCH - 1 - c);
    __syncthreads();
    if (g0 >= 0) {
      if (c == 0) {
        live_blocks(g0);
#pragma unroll
        for (int kc = 0; kc < DH / 16; ++kc) {
          ldsm_x4(qa[kc], Qp + (lane & 15) * LD + kc * 16 + (lane >> 4) * 8);
          ldsm_x4(da[kc], Gp + (lane & 15) * LD + kc * 16 + (lane >> 4) * 8);
        }
      }
      attn_half_scores<DH, HT, MAP>(s, qa, Ks, t0, tcnt, 8 * c, 8 * c + 8, lm,
                                    lane);
    }
  }

  const float sl2 = scale * LOG2E;
  float4* st = stats + ((size_t)b * H + hd) * (size_t)(ngroups * 16);
  for (int k = 0, grp = g0; grp >= 0;
       ++k, grp = unit_group(k, grp, u, U, ngroups, by_work)) {
    if (k > 0) {     // a later group: K and V are all in shared memory
      live_blocks(grp);
#pragma unroll
      for (int kc = 0; kc < DH / 16; ++kc) {
        ldsm_x4(qa[kc], Qp + (lane & 15) * LD + kc * 16 + (lane >> 4) * 8);
        ldsm_x4(da[kc], Gp + (lane & 15) * LD + kc * 16 + (lane >> 4) * 8);
      }
      zero_acc<HT>(s);
      attn_half_scores<DH, HT, MAP>(s, qa, Ks, t0, tcnt, 0, MAXNT, lm, lane);
    }
    // scale and mask in base 2, this warp's half of the row max, the pair's
    // (a dead 16-key block: -inf, p = 0, dp = 0, no mask read)
    const int ia = grp * 16 + g, ib = ia + 8;
    float ma, mb;
    attn_half_mask<HT, ROW, MAP>(s, t0, tcnt, lm, lp,
                                 Mw + (size_t)grp * npair * 8 + g, mask, Ms,
                                 ia, ib, S, T, sl2, t4, ma, mb);
    ma = quad_max(ma);
    mb = quad_max(mb);
    if (t4 == 0) {
      red[half * 16 + g] = ma;
      red[half * 16 + g + 8] = mb;
    }
    // dp = dctx v^T for this warp's keys while the maxima cross
    float dp[HT][4];
    zero_acc<HT>(dp);
    attn_half_scores<DH, HT, MAP>(dp, da, Vs, t0, tcnt, 0, MAXNT, lm, lane);
    pair_sync(pair);   // both halves' maxima, and both warps have read the slabs
    ma = fmaxf(ma, red[(half ^ 1) * 16 + g]);
    mb = fmaxf(mb, red[(half ^ 1) * 16 + g + 8]);
    // the next group's q and dctx into the slabs while this group computes
    const int next = unit_group(k + 1, grp, u, U, ngroups, by_work);
    if (next >= 0) load_slabs(next);
    cp_async_commit();

    // e = exp(s - max), this warp's half of the row sum l and of t =
    // sum(dp * e), exchanged at one barrier: delta = rowsum(dp * p) = t / l
    float la = 0.f, lb = 0.f, ta = 0.f, tb = 0.f;
#pragma unroll
    for (int i = 0; i < HT; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[i][e] = exp2f(s[i][e] - ma);
        s[i][2 + e] = exp2f(s[i][2 + e] - mb);
        la += s[i][e];
        lb += s[i][2 + e];
        ta = fmaf(dp[i][e], s[i][e], ta);
        tb = fmaf(dp[i][2 + e], s[i][2 + e], tb);
      }
    }
    la = quad_sum(la);
    lb = quad_sum(lb);
    ta = quad_sum(ta);
    tb = quad_sum(tb);
    if (t4 == 0) {
      red[32 + half * 16 + g] = la;
      red[32 + half * 16 + g + 8] = lb;
      red[64 + half * 16 + g] = ta;
      red[64 + half * 16 + g + 8] = tb;
    }
    pair_sync(pair);
    // a + b == b + a in fp32: both warps get the same sums
    la += red[32 + (half ^ 1) * 16 + g];
    lb += red[32 + (half ^ 1) * 16 + g + 8];
    ta += red[64 + (half ^ 1) * 16 + g];
    tb += red[64 + (half ^ 1) * 16 + g + 8];
    const float ila = 1.f / la, ilb = 1.f / lb;
    const float dla = ta * ila, dlb = tb * ilb;
#pragma unroll
    for (int i = 0; i < HT; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {   // p, fp32
        s[i][e] *= ila;
        s[i][2 + e] *= ilb;
      }
    }

    // ds16 = bf16(p * (dp - delta)); this warp's part of dq = ds16 k
    float dq[DH / 8][4];
    zero_acc<DH / 8>(dq);
#pragma unroll
    for (int i = 0; i < HT; i += 2) {
      if (i >= tcnt || !((lm >> (i >> 1)) & 1u)) continue;   // ds = 0 there
      unsigned sa[4];
      sa[0] = pack_bf16(s[i][0] * (dp[i][0] - dla), s[i][1] * (dp[i][1] - dla));
      sa[1] = pack_bf16(s[i][2] * (dp[i][2] - dlb), s[i][3] * (dp[i][3] - dlb));
      sa[2] = pack_bf16(s[i + 1][0] * (dp[i + 1][0] - dla),
                        s[i + 1][1] * (dp[i + 1][1] - dla));
      sa[3] = pack_bf16(s[i + 1][2] * (dp[i + 1][2] - dlb),
                        s[i + 1][3] * (dp[i + 1][3] - dlb));
      const int k0 = warp_tile<MAP>(i, t0) * 8;
#pragma unroll
      for (int cp = 0; cp < DH / 16; ++cp) {
        unsigned kb[4];
        ldsm_x4_t(kb, Ks + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                          cp * 16 + (lane >> 4) * 8);
        mma16816(dq[2 * cp], sa, kb[0], kb[1]);
        mma16816(dq[2 * cp + 1], sa, kb[2], kb[3]);
      }
    }
    if (half) {
#pragma unroll
      for (int ct = 0; ct < DH / 8; ++ct)
#pragma unroll
        for (int e = 0; e < 4; ++e) op[(ct * 4 + e) * 32 + lane] = dq[ct][e];
    }
    cp_async_wait<0>();   // the next slabs have landed (this thread's copies)
    pair_sync(pair);      // ... and every copy of the pair, and the partial dq
    if (!half) {
#pragma unroll
      for (int ct = 0; ct < DH / 8; ++ct) {
        const int c = hd * DH + ct * 8 + 2 * t4;
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[ct][e] += op[(ct * 4 + e) * 32 + lane];
        float c0 = 0.f, c1 = 0.f;   // the group's column sums (qpart)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = h ? ib : ia;
          if (i >= T) continue;
          const float v0 = dq[ct][2 * h] * scale, v1 = dq[ct][2 * h + 1] * scale;
          const size_t o = ((size_t)b * T + i) * rs + c;
          *reinterpret_cast<unsigned*>(dqkv16 + o) = pack_bf16(v0, v1);
          c0 += v0;
          c1 += v1;
        }
        if (qpart) group_colsum(qpart + ((size_t)b * ngroups + grp) * D + c, c0, c1, lane);
      }
      if (t4 == 0) {
        st[ia] = ia < T ? make_float4(ma, ila, dla, 0.f)
                        : make_float4(INFINITY, 0.f, 0.f, 0.f);
        st[ib] = ib < T ? make_float4(mb, ilb, dlb, 0.f)
                        : make_float4(INFINITY, 0.f, 0.f, 0.f);
      }
    }
  }
}

template <int DH, bool PRE, bool ROW>
__device__ __forceinline__ void
attn_bwd_dq_tiled(const bf16* __restrict__ qkv, const bf16* __restrict__ kvp,
                  const bf16* __restrict__ dctx, const float* __restrict__ mask,
                  const unsigned char* __restrict__ tmap,
                  bf16* __restrict__ dqkv16, float* __restrict__ qpart,
                  float4* __restrict__ stats, int T, int P, int D, int Sp,
                  float scale) {
  constexpr bool MAP = PRE && !ROW;
  if constexpr (!PRE) mask = nullptr;   // as attn_fwd_kernel's
  constexpr int LD = DH + 8, TE = TQ * LD, NBUF = MAP ? TILES_HELD : 2;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = Qs + TE;
  bf16* Ks = Gs + TE;           // NBUF x [key][dim]
  bf16* Vs = Ks + NBUF * TE;    // NBUF x [key][dim]
  float* Ms = reinterpret_cast<float*>(Vs + NBUF * TE);   // a key-mask row
  int* tl = reinterpret_cast<int*>(Vs + NBUF * TE);       // MAP: live key tiles
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int hd = blockIdx.y, b = blockIdx.z, H = gridDim.y, q0 = blockIdx.x * TQ;
  const int r0 = warp * 16, S = P + T, nk = (S + TQ - 1) / TQ, nkb = Sp / 16;
  const size_t rs = 3 * (size_t)D;
  load_tile(Qs, LD, qkv + ((size_t)b * T + q0) * rs + hd * DH, rs, TQ, T - q0,
            DH, tid, TT_THREADS);
  load_tile(Gs, LD, dctx + ((size_t)b * T + q0) * D + hd * DH, D, TQ, T - q0,
            DH, tid, TT_THREADS);
  // as the tiled forward: the live key tiles only, in both passes
  const int nl = live_key_tiles<MAP>(tl, tmap, q0 / 16, (T + 15) / 16, nkb,
                                     nk, warp, lane);
  auto key_tile = [&](int n) { return (MAP && tmap ? tl[n] : n) * TQ; };
  const unsigned* words = tmap ? reinterpret_cast<const unsigned*>(
      tmap + tile_map_words_at(T, S)) : nullptr;
  const int total = 2 * nl;
  const bool held = MAP && tmap && nl <= NBUF;   // as the tiled forward
  for (int n = 0; n < (held ? nl : 1); ++n) {
    load_kv<PRE>(Ks + n * TE, Vs + n * TE, LD, qkv, kvp, b, T, P, D, hd * DH,
                 key_tile(n), TQ, DH, tid, TT_THREADS);
    cp_async_commit();
  }
  stage_mask_row<ROW>(Ms, mask, S, Sp, tid, TT_THREADS);

  const bool live = q0 + r0 < T;   // warp-uniform
  const int ia = q0 + r0 + g, ib = ia + 8, rb = (q0 + r0) / 16;
  const float sl2 = scale * LOG2E;
  unsigned qa[DH / 16][4], ga[DH / 16][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, t[2] = {0.f, 0.f};
  float il[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
  float dq[DH / 8][4], s[8][4], dp[8][4];
  zero_acc<DH / 8>(dq);
  for (int it = 0; it < total; ++it) {
    const int pass = it >= nl, k0 = key_tile(it % nl);
    const int buf = held ? it % nl : it & 1;
    if (held) {
      if (it < nl) cp_async_wait_dyn(nl - 1 - it);
    } else if (it + 1 < total) {
      const int kn = key_tile((it + 1) % nl), nb = buf ^ 1;
      load_kv<PRE>(Ks + nb * TE, Vs + nb * TE, LD, qkv, kvp, b, T, P, D,
                   hd * DH, kn, TQ, DH, tid, TT_THREADS);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (!held || it < nl) __syncthreads();
    if (live) {
      if (it == 0) {
#pragma unroll
        for (int kc = 0; kc < DH / 16; ++kc) {
          ldsm_x4(qa[kc], Qs + (r0 + (lane & 15)) * LD + kc * 16 + (lane >> 4) * 8);
          ldsm_x4(ga[kc], Gs + (r0 + (lane & 15)) * LD + kc * 16 + (lane >> 4) * 8);
        }
      }
      // a 16-key block dead for the warp's rows: s = -inf, dp = 0, so e = 0
      // leaves l and t as they are and ds adds nothing to dq
      const unsigned sub = tile_blocks<MAP>(tmap, rb, nkb, k0);
      if (sub & 0xfu) {
        unsigned wb[4];
        tile_words<MAP>(wb, words, rb, nkb, k0, sub, g);
        const bf16* Kb = Ks + buf * TE;
        zero_acc<8>(s);
        zero_acc<8>(dp);
        dot_rows64<DH>(s, qa, Kb, S - k0, sub, lane);
        dot_rows64<DH>(dp, ga, Vs + buf * TE, S - k0, sub, lane);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e < 2 ? ia : ib, j = k0 + nt * 8 + 2 * t4 + (e & 1);
            s[nt][e] = j < S && ((sub >> (nt >> 1)) & 1u)
                           ? fmaf(s[nt][e], sl2,
                                  tile_mask<MAP, ROW>(mask, Ms, wb, sub, nt,
                                                      e, i, j, S, T))
                           : -INFINITY;
          }
        if (pass == 0) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float cm = -INFINITY;
#pragma unroll
            for (int nt = 0; nt < 8; ++nt)
              cm = fmaxf(cm, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
            const float mn = fmaxf(m[h], quad_max(cm));
            if (mn != -INFINITY) {
              const float f = exp2f(m[h] - mn);   // 0 while m was -inf
              l[h] *= f;
              t[h] *= f;
#pragma unroll
              for (int nt = 0; nt < 8; ++nt)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const float ev = exp2f(s[nt][2 * h + e] - mn);
                  l[h] += ev;
                  t[h] = fmaf(dp[nt][2 * h + e], ev, t[h]);
                }
            }
            m[h] = mn;
          }
        } else {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int h = e >> 1;
              s[nt][e] = exp2f(s[nt][e] - m[h]) * il[h] * (dp[nt][e] - dl[h]);
            }
          mm_rows64<DH>(dq, s, Kb, S - k0, sub, lane);   // ds16 k
        }
      }
      if (it == nl - 1) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          il[h] = 1.f / quad_sum(l[h]);
          dl[h] = quad_sum(t[h]) * il[h];
        }
      }
    }
    if (!held) __syncthreads();   // the buffer read here is refilled next
  }
  if (!live) return;
  const int t16 = (T + 15) / 16 * 16;
  float4* st = stats + ((size_t)b * H + hd) * (size_t)t16;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = h ? ib : ia;
    if (t4 == 0 && i < t16)
      st[i] = i < T ? make_float4(m[h], il[h], dl[h], 0.f)
                    : make_float4(INFINITY, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int ct = 0; ct < DH / 8; ++ct) {
    float c0 = 0.f, c1 = 0.f;   // the warp's 16-row group's column sums
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = h ? ib : ia;
      if (i >= T) continue;
      const float v0 = dq[ct][2 * h] * scale, v1 = dq[ct][2 * h + 1] * scale;
      const size_t o = ((size_t)b * T + i) * rs + hd * DH + ct * 8 + 2 * t4;
      *reinterpret_cast<unsigned*>(dqkv16 + o) = pack_bf16(v0, v1);
      c0 += v0;
      c1 += v1;
    }
    if (qpart)
      group_colsum(qpart + ((size_t)b * ((T + 15) / 16) + rb) * D + hd * DH +
                       ct * 8 + 2 * t4, c0, c1, lane);
  }
}

#define LLC_DQ_TILED_ARGS                                                     \
  const bf16* __restrict__ qkv, const bf16* __restrict__ kvp,                 \
      const bf16* __restrict__ dctx, const float* __restrict__ mask,          \
      const unsigned char* __restrict__ tmap, bf16* __restrict__ dqkv16,      \
      float* __restrict__ qpart, float4* __restrict__ stats, int T, int P,    \
      int D, int Sp, float scale
template <int DH, bool PRE, bool ROW>
__global__ void __launch_bounds__(TT_THREADS)
attn_bwd_dq_tiled_kernel(LLC_DQ_TILED_ARGS) {
  attn_bwd_dq_tiled<DH, PRE, ROW>(qkv, kvp, dctx, mask, tmap, dqkv16, qpart,
                                  stats, T, P, D, Sp, scale);
}

// The same under a tile map (PRE, a 2-D mask), three blocks an SM: at ~190
// registers a thread only two fit, and the few live tiles leave each block
// waiting on its loads, which a third block covers (faster at ProtoCLIP's
// K4 on an H100). A wrapper of its own keeps the bound off the other roads.
template <int DH>
__global__ void __launch_bounds__(TT_THREADS, 3)
attn_bwd_dq_tiled_map_kernel(LLC_DQ_TILED_ARGS) {
  attn_bwd_dq_tiled<DH, true, false>(qkv, kvp, dctx, mask, tmap, dqkv16,
                                     qpart, stats, T, P, D, Sp, scale);
}
#undef LLC_DQ_TILED_ARGS

constexpr int DKV_WARPS = 4;       // a block's warps (key groups at once)
constexpr int DKV_MAP_WARPS = 8;   // ... under a tile map (the PRE 2-D mask)

// Bytes of one 64-query chunk of the dk/dv kernel: q and dctx [query][dim]
// bf16, and the float4 statistics.
__host__ __device__ constexpr size_t dkv_chunk_bytes(int dh) {
  return (size_t)TQ * (dh + 8) * 2 * sizeof(bf16) + (size_t)TQ * sizeof(float4);
}

template <int DH, bool PRE, bool ROW, int NW>
__global__ void __launch_bounds__(32 * NW, 1)
attn_bwd_dkv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ kvp,
                    const bf16* __restrict__ dctx,
                    const float* __restrict__ mask,
                    const unsigned char* __restrict__ tmap,
                    bf16* __restrict__ dqkv16, bf16* __restrict__ dkvp16,
                    float* __restrict__ kvpart, const float4* __restrict__ stats,
                    int T, int P, int D, int Sp, int NB, float scale) {
  constexpr bool MAP = PRE && !ROW;
  if constexpr (!PRE) mask = nullptr;   // as attn_fwd_kernel's
  constexpr int LD = DH + 8, TE = TQ * LD;
  constexpr size_t CHUNK = dkv_chunk_bytes(DH);
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int hd = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int S = P + T, t16 = (T + 15) / 16 * 16;
  const int nq = (T + TQ - 1) / TQ, ngroups = Sp / 16;
  // split z = blockIdx.x takes the key groups z * NW + warp + r * gstride:
  // each key's sums over the queries keep their order
  const int gstride = NW * gridDim.x, gfirst = blockIdx.x * NW;
  const int rounds = (ngroups - gfirst + gstride - 1) / gstride;
  const bool resident = NB >= nq;   // every chunk held for the whole block
  const int nload = resident ? nq : rounds * nq;
  const size_t rs = 3 * (size_t)D;
  const bool mat = mask && !ROW;    // a (T, S) matrix
  float* Mt = reinterpret_cast<float*>(smem + NB * CHUNK) + warp * 32 * 17;
  // MAP with every chunk resident: the warps wait for all chunks once, then
  // run free, each taking the next key group from a counter after its
  // first, so the cheap groups a tile map leaves (a few live steps) spread
  // over the warps while the dense ones (the prefix keys) run
  const bool queue = MAP && resident;
  int* next_group = reinterpret_cast<int*>(
      smem + NB * CHUNK + (mat ? (size_t)NW * 32 * 17 * sizeof(float) : 0));
  if (queue && tid == 0) *next_group = NW;   // seen after the barrier below
  const unsigned* words = tmap ? reinterpret_cast<const unsigned*>(
      tmap + tile_map_words_at(T, S)) : nullptr;
  const float4* gst = stats + ((size_t)b * H + hd) * (size_t)t16;
  auto qs = [&](int buf) { return reinterpret_cast<bf16*>(smem + buf * CHUNK); };
  auto issue = [&](int li) {   // chunk load li (in consumption order)
    const int c = li % nq, buf = li % NB, q0 = c * TQ;
    bf16* Qb = qs(buf);
    load_tile(Qb, LD, qkv + ((size_t)b * T + q0) * rs + hd * DH, rs, TQ,
              T - q0, DH, tid, 32 * NW);
    load_tile(Qb + TE, LD, dctx + ((size_t)b * T + q0) * D + hd * DH, D, TQ,
              T - q0, DH, tid, 32 * NW);
    float4* Sb = reinterpret_cast<float4*>(Qb + 2 * TE);
    for (int r = tid; r < TQ; r += 32 * NW) {
      const bool ok = q0 + r < t16;
      cp_async16(Sb + r, ok ? gst + q0 + r : gst, ok);
    }
    cp_async_commit();
  };
  int issued = 0;
  for (; issued < min(NB, nload); ++issued) issue(issued);

  const float sl2 = scale * LOG2E;
  for (int r = 0;; ++r) {
    int grp = gfirst + r * gstride + warp;
    if (queue && r > 0) {
      int gq = 0;
      if (lane == 0) gq = atomicAdd(next_group, 1);
      grp = __shfl_sync(0xffffffffu, gq, 0);
      if (grp >= ngroups) break;
    } else if (r >= rounds) {
      break;
    }
    const int j0 = grp * 16;
    const bool live = grp < ngroups;   // warp-uniform
    const int ja = j0 + g, jb = ja + 8;
    const bool oka = ja < S, okb = jb < S;
    unsigned ka[DH / 16][4], va[DH / 16][4];
    float dk[DH / 8][4], dv[DH / 8][4];
    float mka = 0.f, mkb = 0.f;   // a key-mask row, log2(e)-scaled
    if (live) {
      // the group's K and V rows straight into A fragments (rows past S zero)
      const bf16* kr[2];
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const int j = w ? jb : ja;
        kr[w] = nullptr;
        if (j < S)
          kr[w] = PRE && j < P ? kvp + ((size_t)b * P + j) * 2 * D + hd * DH
                               : qkv + ((size_t)b * T + j - P) * rs + D + hd * DH;
      }
#pragma unroll
      for (int kc = 0; kc < DH / 16; ++kc)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const bf16* row = kr[x & 1];
          const int col = kc * 16 + (x >> 1) * 8 + 2 * t4;
          ka[kc][x] = row ? *reinterpret_cast<const unsigned*>(row + col) : 0u;
          va[kc][x] = row ? *reinterpret_cast<const unsigned*>(row + D + col) : 0u;
        }
      if (ROW) {
        mka = oka ? LOG2E * mask[ja] : 0.f;
        mkb = okb ? LOG2E * mask[jb] : 0.f;
      }
      zero_acc<DH / 8>(dk);
      zero_acc<DH / 8>(dv);
    }
    if (queue && r == 0) {   // every chunk, once, the first K and V rows in flight
      cp_async_wait<0>();
      __syncthreads();
    }
    for (int c = 0; c < nq; ++c) {
      const int li = resident ? c : r * nq + c;
      if (!resident || (r == 0 && !queue)) {
        cp_async_wait_dyn(issued - li - 1);
        __syncthreads();
      }
      const bf16* Qb = qs(li % NB);
      const bf16* Gb = Qb + TE;
      const float4* Sb = reinterpret_cast<const float4*>(Qb + 2 * TE);
      if (live) {
        // 32 queries a step: two k16 halves whose products interleave
        for (int lq = 0; lq < TQ && c * TQ + lq < T; lq += 32) {
          const int qb = c * TQ + lq;
          // MAP: the step's two row blocks dead for the group's keys: p = 0,
          // nothing to add; each dead or plain (map byte 0 or 2): the
          // entries come from the map's words, a lane x < 16 holding word
          // x & 7 of row block qb / 16 + x / 8 (rows past T all ones)
          bool from_words = false;
          unsigned wq = 0u;
          if constexpr (MAP) {
            if (tmap) {
              // the words only for a step that is live and plain: a dead
              // step (most of ProtoCLIP's K4) loads nothing more
              const int rb = qb >> 4;
              const unsigned v0 = tmap[(size_t)rb * ngroups + grp];
              const unsigned v1 = 16 * (rb + 1) < T
                                      ? tmap[(size_t)(rb + 1) * ngroups + grp] : 0u;
              if (!v0 && !v1) continue;
              from_words = v0 != 1u && v1 != 1u;
              if (from_words) {
                const int rx = rb + ((lane >> 3) & 1);
                wq = 16 * rx < T ? words[((size_t)rx * ngroups + grp) * 8 + (lane & 7)]
                                 : 0xffffffffu;
              }
            }
          }
          if (mat && !from_words) {   // the (32 queries x 16 keys) mask tile, log2(e)-scaled
            __syncwarp();
            for (int x = lane; x < 512; x += 32) {
              const int i = qb + (x >> 4), j = j0 + (x & 15);
              Mt[(x >> 4) * 17 + (x & 15)] =
                  i < T && j < S ? LOG2E * mask[(size_t)i * S + j] : 0.f;
            }
            __syncwarp();
          }
          // s^T and dp^T, keys (ja, jb) x queries qb + 8n + 2t4 + e: n8
          // tile n of 4; queries past T are zero rows whose statistics
          // give p = 0
          float sT[4][4], dT[4][4];
          zero_acc<4>(sT);
          zero_acc<4>(dT);
#pragma unroll
          for (int kc = 0; kc < DH / 16; ++kc) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int r = lq + 16 * hh + (lane & 7) + ((lane >> 4) << 3);
              unsigned qb4[4], gb4[4];
              ldsm_x4(qb4, Qb + r * LD + kc * 16 + ((lane >> 3) & 1) * 8);
              ldsm_x4(gb4, Gb + r * LD + kc * 16 + ((lane >> 3) & 1) * 8);
              mma16816(sT[2 * hh], ka[kc], qb4[0], qb4[1]);
              mma16816(sT[2 * hh + 1], ka[kc], qb4[2], qb4[3]);
              mma16816(dT[2 * hh], va[kc], gb4[0], gb4[1]);
              mma16816(dT[2 * hh + 1], va[kc], gb4[2], gb4[3]);
            }
          }
          // p^T = exp2(s^T sl2 + mask - m2) / l and ds^T = p^T (dp^T - delta),
          // the mask entries from the map's words (WORDS) or as the mask
          // gives them: a warp-uniform branch around two copies of the
          // loop, so neither tests the other's case at every entry
          auto rebuild = [&](auto words) {
            constexpr bool WORDS = decltype(words)::value;
#pragma unroll
            for (int n = 0; n < 4; ++n) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int rq = 8 * n + 2 * t4 + e;
                const float4 q = Sb[lq + rq];   // (m2, 1/l, delta)
                unsigned wr = 0u;   // row rq's 16 bits
                if constexpr (WORDS)
                  wr = __shfl_sync(0xffffffffu, wq, (rq >> 4) * 8 + (rq & 7)) >>
                       (((rq >> 3) & 1) * 16);
#pragma unroll
                for (int w = 0; w < 2; ++w) {   // w = 0: key ja, 1: key jb
                  float pv = 0.f;
                  if (w ? okb : oka) {
                    float mv;
                    if constexpr (WORDS)
                      mv = (wr >> (g + 8 * w)) & 1u ? 0.f : -INFINITY;
                    else
                      mv = ROW ? (w ? mkb : mka)
                               : (mat ? Mt[rq * 17 + g + 8 * w] : 0.f);
                    pv = exp2f(fmaf(sT[n][2 * w + e], sl2, mv) - q.x) * q.y;
                  }
                  sT[n][2 * w + e] = pv;
                  dT[n][2 * w + e] = pv * (dT[n][2 * w + e] - q.z);
                }
              }
            }
          };
          if (MAP && from_words)
            rebuild(std::integral_constant<bool, MAP>{});
          else
            rebuild(std::false_type{});
          // dv += p16^T dctx, dk += ds16^T q, one k16 half of the queries
          // after the other
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            unsigned pa[4], sa[4];
            pa[0] = pack_bf16(sT[2 * hh][0], sT[2 * hh][1]);
            pa[1] = pack_bf16(sT[2 * hh][2], sT[2 * hh][3]);
            pa[2] = pack_bf16(sT[2 * hh + 1][0], sT[2 * hh + 1][1]);
            pa[3] = pack_bf16(sT[2 * hh + 1][2], sT[2 * hh + 1][3]);
            sa[0] = pack_bf16(dT[2 * hh][0], dT[2 * hh][1]);
            sa[1] = pack_bf16(dT[2 * hh][2], dT[2 * hh][3]);
            sa[2] = pack_bf16(dT[2 * hh + 1][0], dT[2 * hh + 1][1]);
            sa[3] = pack_bf16(dT[2 * hh + 1][2], dT[2 * hh + 1][3]);
            const int r = lq + 16 * hh + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
            for (int cp = 0; cp < DH / 16; ++cp) {
              unsigned ob[4], qt[4];
              ldsm_x4_t(ob, Gb + r * LD + cp * 16 + (lane >> 4) * 8);
              ldsm_x4_t(qt, Qb + r * LD + cp * 16 + (lane >> 4) * 8);
              mma16816(dv[2 * cp], pa, ob[0], ob[1]);
              mma16816(dv[2 * cp + 1], pa, ob[2], ob[3]);
              mma16816(dk[2 * cp], sa, qt[0], qt[1]);
              mma16816(dk[2 * cp + 1], sa, qt[2], qt[3]);
            }
          }
        }
      }
      if (!resident) {   // refill the buffer just read with a later chunk
        __syncthreads();
        if (issued < nload) issue(issued++);
      }
    }
    if (!live) continue;
#pragma unroll
    for (int ct = 0; ct < DH / 8; ++ct) {
      const int c = hd * DH + ct * 8 + 2 * t4;
      float ck0 = 0.f, ck1 = 0.f, cv0 = 0.f, cv1 = 0.f;   // column sums
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int j = h ? jb : ja;
        if (j >= S) continue;
        const float k0v = dk[ct][2 * h] * scale, k1v = dk[ct][2 * h + 1] * scale;
        const float v0 = dv[ct][2 * h], v1 = dv[ct][2 * h + 1];
        bf16* o16;
        size_t o;
        if (PRE && j < P) {   // a prefix key: (B*P, 2D), dK at 0, dV at D
          o = ((size_t)b * P + j) * 2 * D + c;
          o16 = dkvp16;
        } else {              // a token key: (B*T, 3D), dK at D, dV at 2D
          o = ((size_t)b * T + j - P) * rs + D + c;
          o16 = dqkv16;
        }
        *reinterpret_cast<unsigned*>(o16 + o) = pack_bf16(k0v, k1v);
        *reinterpret_cast<unsigned*>(o16 + o + D) = pack_bf16(v0, v1);
        ck0 += k0v; ck1 += k1v;
        cv0 += v0; cv1 += v1;
      }
      // the key group's sums of dk and dv, prefix and token keys alike
      // (b_k and b_v see both): row b * ngroups + grp of (B * Sp/16, 2D)
      if (kvpart) {
        float* row = kvpart + ((size_t)b * ngroups + grp) * 2 * D + c;
        group_colsum(row, ck0, ck1, lane);
        group_colsum(row + D, cv0, cv1, lane);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// C interface for ctypes. Every launcher returns cudaGetLastError() as an int.
// ---------------------------------------------------------------------------
static int grid_for(size_t n) {
  const size_t b = (n + 255) / 256;
  return (int)(b < 4096 ? b : 4096);
}

static int max_smem_optin() {
  static int v = 0;
  if (!v) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return v;
}

// The register roads' copy of a tile map: its bytes (<= 16 x 16 up to 256
// keys) in 256, then its words (8 a block; ceil(T/16) <= Sp/16 row blocks)
static size_t map_smem(int Sp) {
  return 256 + (size_t)(Sp / 16) * (Sp / 16) * 8 * sizeof(unsigned);
}

// K, V, the 4 pairs' query slabs, their row-max and row-sum exchange and
// partial p @ v, plus the key-mask row with ROW or the tile map with map
static size_t attn_fwd_smem(int Sp, int dh, bool row, bool map) {
  return (size_t)(2 * Sp + 16 * AF_PAIRS) * (dh + 8) * sizeof(bf16) +
         (size_t)AF_PAIRS * (64 + 1024) * sizeof(float) +
         (row ? (size_t)Sp * sizeof(float) : 0) + (map ? map_smem(Sp) : 0);
}

// K, V, the 4 pairs' q and dctx slabs, their max / sum / delta exchange and
// partial dq, plus the key-mask row with ROW or the tile map with map
static size_t attn_bwd_dq_smem(int Sp, int dh, bool row, bool map) {
  return (size_t)(2 * Sp + 32 * DQ_PAIRS) * (dh + 8) * sizeof(bf16) +
         (size_t)DQ_PAIRS * (96 + dh * 16) * sizeof(float) +
         (row ? (size_t)Sp * sizeof(float) : 0) + (map ? map_smem(Sp) : 0);
}

// the tiled roads: ``tiles`` 64-row bf16 tiles plus the key-mask row (ROW)
// or the list of live key tiles and its count (MAP: PRE without ROW)
static size_t attn_tiled_smem(int tiles, int Sp, int dh, bool row, bool map) {
  return (size_t)tiles * TQ * (dh + 8) * sizeof(bf16) +
         (row ? (size_t)Sp * sizeof(float) : 0) +
         (map ? (size_t)((Sp + TQ - 1) / TQ + 1) * sizeof(int) : 0);
}

// Shared arguments of the attention launches. Without a prefix P = 0 and
// kvp and dkvp16 are null; tmap (the tile map of a 2-D mask) is read by the
// PRE kernels without ROW only, null there meaning every block (those
// kernels also take a (T, T) mask with no prefix, P = 0). bpart: null,
// or the weight grads' bias partials, those of dq (B * ceil(T/16), D) then
// those of dk | dv (B * ceil(S/16), 2D), one row a 16-row group.
struct AttnArgs {
  const bf16* qkv;
  const bf16* kvp;
  const bf16* dctx;
  const float* mask;
  const unsigned char* tmap;
  bf16* ctx;
  bf16* dqkv16;
  bf16* dkvp16;
  float* bpart;
  float4* stats;
  int B, T, P, D, H;
  float scale;
};

static int sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// The end of a list schedule of ``blocks`` blocks (split z of ``ns`` the
// fastest index, as the grid dispatches them) onto ``slots`` block slots,
// each taking the next free one: block z costs its rounds of groups, 2 a
// round, plus 1 to load K and V (or Q and dctx).
static long long attn_schedule(int ns, long long blocks, long long slots,
                               int groups, int units) {
  std::vector<long long> ends(slots < blocks ? slots : blocks, 0);
  std::make_heap(ends.begin(), ends.end(), std::greater<long long>());
  long long last = 0;
  for (long long i = 0; i < blocks; ++i) {
    const int z = (int)(i % ns);
    const long long rounds = z * units < groups
        ? (groups - z * units - 1) / ((long long)units * ns) + 1 : 0;
    std::pop_heap(ends.begin(), ends.end(), std::greater<long long>());
    ends.back() += 2 * rounds + 1;
    last = ends.back() > last ? ends.back() : last;
    std::push_heap(ends.begin(), ends.end(), std::greater<long long>());
  }
  return last;
}

// How many blocks each (head, batch row) of a register-road attention
// kernel takes (gridDim.x), each taking every split-th round of ``units``
// groups of 16 rows at once (warp pairs or warps) of ``groups``: the count
// whose list schedule (attn_schedule) over the blocks the card holds at
// once (the kernel's occupancy at ``smem``) ends first, the fewest on a
// tie. The blocks are latency-bound (a pair's round takes about as long
// with one block on its SM as with two), so where B x H blocks leave SMs
// idle (the ER family's 16 and 8 batch rows: 192 and 96 for 264 slots) a
// split runs more rounds at once; where they fill the card twice (64 batch
// rows and up) it is 1, the unsplit road. Each (kernel, shared memory, B x
// H, groups) is worked out once: a chain launches the same shapes every
// step, and the host sets the small batches' pace.
template <typename Kernel>
static int attn_splits(Kernel kern, int threads, size_t smem, int bh,
                       int groups, int units) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, size_t, int, int>, int> seen;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(reinterpret_cast<const void*>(kern), smem,
                                   bh, groups);
  auto it = seen.find(key);
  if (it != seen.end()) return it->second;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                    smem) != cudaSuccess ||
      per_sm < 1)
    per_sm = 1;
  const long long slots = (long long)per_sm * sm_count();
  int best = 1;
  if ((long long)bh < 2 * slots) {
    long long best_end = attn_schedule(1, bh, slots, groups, units);
    for (int ns = 2; ns <= (groups + units - 1) / units; ++ns) {
      const long long end = attn_schedule(ns, (long long)bh * ns, slots, groups,
                                          units);
      if (end < best_end) {
        best = ns;
        best_end = end;
      }
    }
  }
  seen[key] = best;
  return best;
}

template <int DH, int MAXNT, bool PRE, bool ROW>
static int launch_attn_fwd_nt(const AttnArgs& a, cudaStream_t s) {
  const int Sp = (a.P + a.T + 15) / 16 * 16;
  const size_t smem = attn_fwd_smem(Sp, DH, ROW, PRE && !ROW && a.tmap);
  auto kern = attn_fwd_kernel<DH, MAXNT, PRE, ROW>;
  raise_smem(kern, smem);
  const int ns = attn_splits(kern, AF_THREADS, smem, a.H * a.B, (a.T + 15) / 16,
                             AF_PAIRS);
  kern<<<dim3(ns, a.H, a.B), AF_THREADS, smem, s>>>(
      a.qkv, a.kvp, a.mask, a.tmap, a.ctx, a.T, a.P, a.D, Sp, a.scale);
  return (int)cudaGetLastError();
}

template <int DH, bool PRE, bool ROW>
static int launch_attn_fwd_tiled(const AttnArgs& a, cudaStream_t s) {
  const int Sp = (a.P + a.T + 15) / 16 * 16;
  // Q and NBUF buffers of K and V (two; TILES_HELD under a tile map)
  const size_t smem = attn_tiled_smem(PRE && !ROW ? 1 + 2 * TILES_HELD : 5, Sp,
                                      DH, ROW, PRE && !ROW);
  if (smem > (size_t)max_smem_optin()) return (int)cudaErrorInvalidValue;
  raise_smem(attn_fwd_tiled_kernel<DH, PRE, ROW>, smem);
  attn_fwd_tiled_kernel<DH, PRE, ROW>
      <<<dim3((a.T + TQ - 1) / TQ, a.H, a.B), TT_THREADS, smem, s>>>(
          a.qkv, a.kvp, a.mask, a.tmap, a.ctx, a.T, a.P, a.D, Sp, a.scale);
  return (int)cudaGetLastError();
}

// Shared memory of the dk/dv kernel beside its query chunks: the warps'
// mask tiles for a (T, S) mask (not a key-mask row) and, in the kernel
// that takes a tile map (map), the group counter.
static size_t dkv_extra(const AttnArgs& a, int nw, bool row, bool map) {
  return (a.mask && !row ? (size_t)nw * 32 * 17 * sizeof(float) : 0) +
         (map ? 16 : 0);
}

// The dk/dv kernel with NW warps and as many 64-query chunks resident as
// shared memory holds.
template <int DH, bool PRE, bool ROW, int NW>
static int launch_attn_dkv(const AttnArgs& a, int Sp, cudaStream_t s) {
  const size_t chunk = dkv_chunk_bytes(DH);
  const size_t extra = dkv_extra(a, NW, ROW, PRE && !ROW);
  const int nq = (a.T + TQ - 1) / TQ;
  const long long fit = ((long long)max_smem_optin() - (long long)extra) / (long long)chunk;
  if (fit < 2) return (int)cudaErrorInvalidValue;
  const int nb = (int)(fit < nq ? fit : nq);
  const size_t smem = nb * chunk + extra;
  auto kern = attn_bwd_dkv_kernel<DH, PRE, ROW, NW>;
  raise_smem(kern, smem);
  // the key groups split over blocks as the forward's query groups; not
  // under a tile map, whose warps take their groups from a counter
  const int ns = PRE && !ROW ? 1 : attn_splits(kern, 32 * NW, smem, a.H * a.B,
                                               Sp / 16, NW);
  float* kvpart = a.bpart ? a.bpart + (size_t)a.B * ((a.T + 15) / 16) * a.D
                          : nullptr;
  kern<<<dim3(ns, a.H, a.B), 32 * NW, smem, s>>>(
      a.qkv, a.kvp, a.dctx, a.mask, a.tmap, a.dqkv16, a.dkvp16, kvpart,
      a.stats, a.T, a.P, a.D, Sp, nb, a.scale);
  return (int)cudaGetLastError();
}

// The dq kernel of the road S takes (MAXNT 0: tiled), then the dk/dv kernel
// with as many 64-query chunks resident as shared memory holds.
template <int DH, int MAXNT, bool PRE, bool ROW>
static int launch_attn_bwd_nt(const AttnArgs& a, cudaStream_t s) {
  const int Sp = (a.P + a.T + 15) / 16 * 16;
  if constexpr (MAXNT == 0) {
    const size_t smem = attn_tiled_smem(PRE && !ROW ? 2 + 2 * TILES_HELD : 6,
                                        Sp, DH, ROW, PRE && !ROW);
    if (smem > (size_t)max_smem_optin()) return (int)cudaErrorInvalidValue;
    auto kern = attn_bwd_dq_tiled_kernel<DH, PRE, ROW>;
    if constexpr (PRE && !ROW) kern = attn_bwd_dq_tiled_map_kernel<DH>;
    raise_smem(kern, smem);
    kern<<<dim3((a.T + TQ - 1) / TQ, a.H, a.B), TT_THREADS, smem, s>>>(
        a.qkv, a.kvp, a.dctx, a.mask, a.tmap, a.dqkv16, a.bpart, a.stats, a.T,
        a.P, a.D, Sp, a.scale);
  } else {
    const size_t smem = attn_bwd_dq_smem(Sp, DH, ROW, PRE && !ROW && a.tmap);
    auto kern = attn_bwd_dq_kernel<DH, MAXNT, PRE, ROW>;
    raise_smem(kern, smem);
    const int ns = attn_splits(kern, DQ_THREADS, smem, a.H * a.B,
                               (a.T + 15) / 16, DQ_PAIRS);
    kern<<<dim3(ns, a.H, a.B), DQ_THREADS, smem, s>>>(
        a.qkv, a.kvp, a.dctx, a.mask, a.tmap, a.dqkv16, a.bpart, a.stats,
        a.T, a.P, a.D, Sp, a.scale);
  }
  int e = (int)cudaGetLastError();
  if (e) return e;
  if constexpr (PRE && !ROW) {
    // 8 warps where one block takes the SM's shared memory anyway (K4's 8
    // resident chunks: ~173 KB), else 4 warps and two blocks an SM
    const int nq = (a.T + TQ - 1) / TQ;
    const size_t big = (size_t)nq * dkv_chunk_bytes(DH) + dkv_extra(a, DKV_WARPS, ROW, true);
    if (2 * big > (size_t)max_smem_optin())
      return launch_attn_dkv<DH, PRE, ROW, DKV_MAP_WARPS>(a, Sp, s);
  }
  return launch_attn_dkv<DH, PRE, ROW, DKV_WARPS>(a, Sp, s);
}

// Dispatch on head dim and on the padded key count Sp a score row holds: up
// to 256 the register roads (the backward's rows of <= 128 or <= 256 keys;
// the forward's also <= 208, ViT-B/16's 197 or 200 tokens, whose half rows
// take 56 registers a thread where 256 keys take 64), above it the tiled
// roads, which have no key limit. ROW: a key-mask row (mask_rs 0). At head
// dim 64 up to 256 keys, with no mask (every ViT tower) or with a prefix
// under a key-mask row (ROW), the warpgroup-MMA kernels of attn_wgmma.cu
// take the rows, and the register roads are not built for them; with no
// mask past 256 keys up to ATTN_WGMMA_LONG_TMAX (ViT-L/14's 257 tokens)
// its long kernels, and the tiled roads only past that.
template <bool BWD, bool PRE, bool ROW>
static int launch_attn(const AttnArgs& a, cudaStream_t s) {
  const int Sp = (a.P + a.T + 15) / 16 * 16;
  if (a.T < 1 || a.H <= 0 || a.D % a.H) return (int)cudaErrorInvalidValue;
  const bool tiled = Sp > 256, wide = Sp > 128;
  if constexpr (!PRE && !ROW) {
    if (attn_wgmma_road(a.T, a.D / a.H))
      return BWD ? attn_wgmma_bwd(a.qkv, a.dctx, a.dqkv16, a.bpart, a.B, a.T,
                                  a.D, a.scale, s)
                 : attn_wgmma_fwd(a.qkv, a.ctx, a.B, a.T, a.D, a.scale, s);
    if (attn_wgmma_long_road(a.T, a.D / a.H))
      return BWD ? attn_wgmma_long_bwd(a.qkv, a.dctx, a.dqkv16, a.bpart, a.B,
                                       a.T, a.D, a.scale, s)
                 : attn_wgmma_long_fwd(a.qkv, a.ctx, a.B, a.T, a.D, a.scale,
                                       s);
  }
  if constexpr (PRE && ROW) {
    if (attn_wgmma_road(a.P + a.T, a.D / a.H))
      return BWD ? attn_wgmma_prefix_bwd(a.qkv, a.kvp, a.dctx, a.mask,
                                         a.dqkv16, a.dkvp16, a.bpart, a.B,
                                         a.T, a.P, a.D, a.scale, s)
                 : attn_wgmma_prefix_fwd(a.qkv, a.kvp, a.mask, a.ctx, a.B,
                                         a.T, a.P, a.D, a.scale, s);
  }
#define LLC_ATTN(DHV)                                                        \
  if constexpr (BWD)                                                         \
    return tiled ? launch_attn_bwd_nt<DHV, 0, PRE, ROW>(a, s)                \
         : wide  ? launch_attn_bwd_nt<DHV, 32, PRE, ROW>(a, s)               \
                 : launch_attn_bwd_nt<DHV, 16, PRE, ROW>(a, s);              \
  if (tiled) return launch_attn_fwd_tiled<DHV, PRE, ROW>(a, s);              \
  if (!wide) return launch_attn_fwd_nt<DHV, 16, PRE, ROW>(a, s);             \
  return Sp <= 208 ? launch_attn_fwd_nt<DHV, 26, PRE, ROW>(a, s)             \
                   : launch_attn_fwd_nt<DHV, 32, PRE, ROW>(a, s);
  switch (a.D / a.H) {
    case 16: { LLC_ATTN(16) }
    case 32: { LLC_ATTN(32) }
    case 64: {
      if constexpr (PRE && !ROW) {
        LLC_ATTN(64)
      } else {   // past ATTN_WGMMA_LONG_TMAX keys with no mask; a prefix
                 // with S = P + T > 256 under a key row: the tiled roads
        if constexpr (BWD) return launch_attn_bwd_nt<64, 0, PRE, ROW>(a, s);
        return launch_attn_fwd_tiled<64, PRE, ROW>(a, s);
      }
    }
    default: return (int)cudaErrorInvalidValue;
  }
#undef LLC_ATTN
}

template <typename OutT, int WM, int WN, int MI, int NI, bool AT, bool BT>
static int launch_gemm_tile(const GemmArgs& p, int splits, cudaStream_t s) {
  constexpr int BM = WM * MI * 16, BN = WN * NI * 8;
  using TL = GemmTile<BM, BN, AT, BT>;
  auto kern = gemm_kernel<OutT, WM, WN, MI, NI, AT, BT>;
  raise_smem(kern, TL::SMEM);
  dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, splits * p.groups);
  kern<<<grid, GTHREADS, TL::SMEM, s>>>(p);
  return (int)cudaGetLastError();
}

template <typename OutT, int WM, int WN, int MI, int NI>
static int launch_gemm_layout(const GemmArgs& p, bool at, bool bt, int splits,
                              cudaStream_t s) {
  if (at)
    return bt ? launch_gemm_tile<OutT, WM, WN, MI, NI, true, true>(p, splits, s)
              : launch_gemm_tile<OutT, WM, WN, MI, NI, true, false>(p, splits, s);
  return bt ? launch_gemm_tile<OutT, WM, WN, MI, NI, false, true>(p, splits, s)
            : launch_gemm_tile<OutT, WM, WN, MI, NI, false, false>(p, splits, s);
}

// A map is a function of (base, dims, row stride, box) alone, and encoding
// one is a call into libcuda, so the launcher keeps them in a direct-mapped
// table: a chain's operands recur every step (the weights, and activations
// the caching allocator hands back at the same address).
constexpr int TMA_SLOTS = 1024;
struct TmaSlot {
  CUtensorMap map;
  const void* ptr;
  long long inner, outer, ld, batches, batch_ld;
  int box_inner, box_outer;
};
static TmaSlot tma_slots[TMA_SLOTS];
static std::mutex tma_mutex;

// A 2-D bf16 TMA map over ``outer`` rows of ``inner`` elements, ``ld``
// elements apart, read in inner x outer boxes into 128B-swizzled tiles;
// out-of-bounds elements read as zero. With ``batch_ld`` > 0 a 3-D map of
// ``batches`` such row blocks, ``batch_ld`` elements apart (the attention
// kernels' rows of one batch row: rows past a block's own read as zero, not
// as the next block's; their boxes take one block).
int make_tma(CUtensorMap* map, const void* ptr, long long inner,
             long long outer, long long ld, int box_inner, int box_outer,
             long long batches, long long batch_ld) {
  const uint64_t key[8] = {(uint64_t)(uintptr_t)ptr, (uint64_t)inner,
                           (uint64_t)outer, (uint64_t)ld,
                           (uint64_t)box_inner, (uint64_t)box_outer,
                           (uint64_t)batches, (uint64_t)batch_ld};
  uint64_t h = 0xcbf29ce484222325ull;   // FNV-1a over the key's words
  for (int i = 0; i < 8; ++i) h = (h ^ key[i]) * 0x100000001b3ull;
  TmaSlot& slot = tma_slots[(h ^ (h >> 29)) % TMA_SLOTS];
  std::lock_guard<std::mutex> lock(tma_mutex);
  if (slot.ptr == ptr && slot.inner == inner && slot.outer == outer &&
      slot.ld == ld && slot.box_inner == box_inner &&
      slot.box_outer == box_outer && slot.batches == batches &&
      slot.batch_ld == batch_ld) {
    *map = slot.map;
    return 0;
  }
  // the encoding is a driver call, which needs a current context: a host
  // thread whose first CUDA call this is (autograd's backward thread, where
  // no launch came first) has none until the runtime binds the device's
  // primary context to it
  CUcontext ctx = nullptr;
  if (cuCtxGetCurrent(&ctx) != CUDA_SUCCESS || !ctx) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || cudaSetDevice(dev) != cudaSuccess ||
        cudaFree(nullptr) != cudaSuccess)
      return (int)cudaErrorInvalidValue;
  }
  const cuuint32_t rank = batch_ld > 0 ? 3 : 2;
  cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)outer, (cuuint64_t)batches};
  cuuint64_t strides[2] = {(cuuint64_t)ld * 2, (cuuint64_t)batch_ld * 2};
  cuuint32_t box[3] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer, 1};
  cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims,
      strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  slot.map = *map;
  slot.ptr = ptr; slot.inner = inner; slot.outer = outer; slot.ld = ld;
  slot.box_inner = box_inner; slot.box_outer = box_outer;
  slot.batches = batches; slot.batch_ld = batch_ld;
  return 0;
}

// The staging tile's output and residual maps (``rows`` x 64 boxes).
static int stage_maps(const GemmArgs& p, long long nc, int rows, CUtensorMap* tc,
                      CUtensorMap* tr) {
  if (make_tma(tc, p.out, nc, p.M, p.ldo, 64, rows)) return (int)cudaErrorInvalidValue;
  if (p.resid && make_tma(tr, p.resid, nc, p.M, p.ldr, 64, rows))
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename OutT, int BN, bool AT, bool BT, bool STAGE, int FOLD, int KR,
          bool COOP>
static int launch_wgmma_tile(const GemmArgs& p, int splits, long long ntiles,
                             cudaStream_t s) {
  using TL = WgTile<BN, STAGE, FOLD, COOP>;
  // the maps span every group: A rows M + (groups - 1) gm, B columns
  // N + (groups - 1) gn
  const long long ma = p.M + (p.groups - 1) * p.gm;
  const long long nb = p.N + (p.groups - 1) * p.gn;
  CUtensorMap ta, tb, tc = {}, tr = {};
  int e = AT ? make_tma(&ta, p.A, ma, p.K, p.sak, 64, 64)
             : make_tma(&ta, p.A, p.K, ma, p.sam, 64, WG_BM);
  if (e) return e;
  e = BT ? make_tma(&tb, p.B, p.K, nb, p.sbn, 64, BN)
         : make_tma(&tb, p.B, nb, p.K, p.sbk, 64, 64);
  if (e) return e;
  // the staging tile's output and residual: a consumer's rows x 64 boxes
  if (STAGE && stage_maps(p, nb, TL::RC, &tc, &tr)) return (int)cudaErrorInvalidValue;
  // the fold reads by TMA F's tiles (64 x 8, zeros past R), zin's (64 rows
  // x 8) and xa's (128 x 64 boxes, as the residual)
  CUtensorMap tf = {}, tz = {}, tx = {};
  if (FOLD) e = make_tma(&tf, p.fz, p.K, p.R, p.sfn, 64, FOLD_RMAX);
  if (FOLD == FOLD_GRADS && !e) {
    e = make_tma(&tz, p.zin, p.M, p.R, p.ldz, 64, FOLD_RMAX);
    if (!e) e = make_tma(&tx, p.xa, p.N, p.M, p.ldx, 64, WG_BM);
  }
  if (e) return e;
  auto kern = gemm_pingpong_kernel<OutT, BN, AT, BT, STAGE, FOLD, KR, COOP>;
  raise_smem(kern, TL::SMEM);
  // persistent: one block an SM, or one a tile where there are fewer
  const int sms = sm_count();
  kern<<<(int)(ntiles < sms ? ntiles : sms), WG_THREADS, TL::SMEM, s>>>(
      ta, tb, tc, tr, tf, tz, tx, p);
  return (int)cudaGetLastError();
}

// The schedule by the launch's tiles: ping-pong, or where they fill at most
// one round of the SMs (each block a lone tile) both consumers on each tile.
template <typename OutT, int BN, bool AT, bool BT, bool STAGE, int FOLD = FOLD_NONE,
          int KR = 0>
static int launch_wgmma_tile(const GemmArgs& p, int splits, cudaStream_t s) {
  const long long ntiles = (long long)((p.N + BN - 1) / BN) *
                           ((p.M + WG_BM - 1) / WG_BM) * p.groups * splits;
  if (ntiles <= sm_count())
    return launch_wgmma_tile<OutT, BN, AT, BT, STAGE, FOLD, KR, true>(p, splits, ntiles, s);
  return launch_wgmma_tile<OutT, BN, AT, BT, STAGE, FOLD, KR, false>(p, splits, ntiles, s);
}

// The staged epilogue (bf16 out, 128-column tiles, no split-K, no unfolded
// LoRA term, a group's columns whole tiles) where TMA can write the output
// and read the residual; else the epilogue from the accumulators.
template <typename OutT, int BN, bool AT, bool BT>
static int launch_wgmma_epi(const GemmArgs& p, int splits, cudaStream_t s) {
  CUtensorMap tc, tr;
  const bool stage =
      sizeof(OutT) == 2 && BN == 128 && splits == 1 && !p.lz &&
      (p.groups == 1 || p.N % BN == 0) &&
      stage_maps(p, p.N + (p.groups - 1) * p.gn, WG_BM, &tc, &tr) == 0;
  if constexpr (sizeof(OutT) == 2 && BN == 128)
    if (stage) return launch_wgmma_tile<OutT, BN, AT, BT, true>(p, splits, s);
  return launch_wgmma_tile<OutT, BN, AT, BT, false>(p, splits, s);
}

template <typename OutT, int BN>
static int launch_wgmma(const GemmArgs& p, bool at, bool bt, int splits,
                        cudaStream_t s) {
  if (at)
    return bt ? launch_wgmma_epi<OutT, BN, true, true>(p, splits, s)
              : launch_wgmma_epi<OutT, BN, true, false>(p, splits, s);
  return bt ? launch_wgmma_epi<OutT, BN, false, true>(p, splits, s)
            : launch_wgmma_epi<OutT, BN, false, false>(p, splits, s);
}

// Whether an fp32-out product takes 128 x 64 tiles (launch_gemm says why).
// An SM's tiles cost their k-steps (a 128 x 64 step ~0.55 of a 128 x 128
// one) plus one fill and one last epilogue (~6 steps): the ping-pong
// schedule runs every other tile's epilogue under the next tile's products.
static bool narrow_tiles(const GemmArgs& p, long long tiles_m, long long sms) {
  const long long t128 = (p.N + 127) / 128 * tiles_m, t64 = (p.N + 63) / 64 * tiles_m;
  const long long ks = (p.k_per_split + WG_BK - 1) / WG_BK;
  return t128 > sms && t128 < 2 * sms &&
         (t64 + sms - 1) / sms * 11 * ks + 120 < (t128 + sms - 1) / sms * 20 * ks + 120;
}

// Tile by problem shape: the mma.sync 64x16 tile for N <= 16 and 16x128 for
// M <= 16 (the rank-r LoRA shapes); else the wgmma tiles, which need
// operands TMA can read (``tma``: other strides are refused, as no caller
// has them): 128 x 128, with the staged epilogue for bf16 output, and for
// fp32 output 128 x 64 where 128 x 128 tiles would take a second, mostly
// empty round (the dh product at 16 batch rows: 150 tiles on 132 SMs; on an
// H100, cooperative schedule: 35.6 -> 32.1 us; PERF.md has the ping-pong
// schedule's). The 128 x 256 tiles of the cooperative schedule (fp32 out, N
// >= 2048: dW_qkv) are gone: a consumer cannot hold 128 x 256 accumulators,
// and 128 x 128 ping-pong tiles carry the same wgmma width (PERF.md).
template <typename OutT>
static int launch_gemm(const GemmArgs& p, bool at, bool bt, bool tma,
                       int splits, cudaStream_t s) {
  if (p.N <= 16) return launch_gemm_layout<OutT, 4, 1, 1, 2>(p, at, bt, splits, s);
  if (p.M <= 16) return launch_gemm_layout<OutT, 1, 4, 1, 4>(p, at, bt, splits, s);
  if (!tma) return (int)cudaErrorInvalidValue;
  if constexpr (sizeof(OutT) == 4) {
    const long long tiles_m = (long long)((p.M + WG_BM - 1) / WG_BM) * p.groups * splits;
    if (!at && narrow_tiles(p, tiles_m, sm_count()))
      return bt ? launch_wgmma_epi<OutT, 64, false, true>(p, splits, s)
                : launch_wgmma_epi<OutT, 64, false, false>(p, splits, s);
  }
  return launch_wgmma<OutT, 128>(p, at, bt, splits, s);
}

// The fold's launches (GemmArgs): the forward's qkv and out products (Z
// alone: NN; bf16 out with the staged epilogue, or fp32 out, the out
// product of an fp32 x) and the backward's dctx (bf16 out, NT, staged) and
// dh (fp32 out, NT; 128 x 64 tiles by the rule above,
// never 128 x 256) with both kinds of partials (K = N or 3N, N a multiple
// of 128). Other layouts, split-K, groups and R > FOLD_RMAX are refused: no
// caller has them (the chains keep the unfolded road for R > FOLD_RMAX and
// D not a multiple of 128).
template <typename OutT>
static int launch_gemm_fold(const GemmArgs& p, bool at, bool bt, bool tma,
                            cudaStream_t s) {
  const bool grads = p.pb || p.pa;
  // the grads' partials: K = N (dctx) or 3N (dh), N a multiple of 128
  if (at || !tma || p.groups != 1 || p.R < 1 || p.R > FOLD_RMAX || !p.fz ||
      (grads && (!p.pb || !p.pa || p.N % WG_BM ||
                 p.K != (sizeof(OutT) == 2 ? 1 : 3) * p.N)))
    return (int)cudaErrorInvalidValue;
  if constexpr (sizeof(OutT) == 2) {
    if (!grads && !bt)   // the forward's qkv and out products
      return launch_wgmma_tile<bf16, 128, false, false, true, FOLD_Z>(p, 1, s);
    if (grads && bt)     // dctx
      return launch_wgmma_tile<bf16, 128, false, true, true, FOLD_GRADS, 1>(p, 1, s);
    return (int)cudaErrorInvalidValue;
  } else {
    if (!grads && !bt)   // the out product of an fp32 x (its residual)
      return launch_wgmma_tile<float, 128, false, false, false, FOLD_Z>(p, 1, s);
    if (!grads || !bt || p.resid) return (int)cudaErrorInvalidValue;
    // dh
    if (narrow_tiles(p, (p.M + WG_BM - 1) / WG_BM, sm_count()))
      return launch_wgmma_tile<float, 64, false, true, false, FOLD_GRADS, 3>(p, 1, s);
    return launch_wgmma_tile<float, 128, false, true, false, FOLD_GRADS, 3>(p, 1, s);
  }
}

// The LN backward's launch (ln_bwd_bulk_kernel): as many warps a block (up to
// LNB_WARPS) as shared memory holds with gamma, their slots and dx rows;
// as many blocks as the SMs hold at once (shared memory carved out in
// full), none idle over M rows.
template <typename T, typename G, bool STATS>
static int launch_ln_bwd(const void* x, const void* gamma, const float* dh,
                         const void* g, void* dx, float2* stats, int M, int D,
                         float eps, cudaStream_t s) {
  const size_t xb = (size_t)D * sizeof(T), per_warp = LNB_SLOTS * (2 * xb + 4 * D) + xb;
  const size_t fixed = LNB_WARPS * LNB_SLOTS * 8 + (size_t)D * 4;
  const long long warps = std::min<long long>(
      std::min<long long>(LNB_WARPS, (232448 - fixed) / per_warp), M);
  const size_t smem = fixed + warps * per_warp;
  auto kern = ln_bwd_bulk_kernel<T, G, STATS>;
  raise_smem(kern, smem);
  static std::mutex mu;
  static std::map<std::pair<const void*, size_t>, int> fits;
  int per_sm;
  {
    std::lock_guard<std::mutex> lock(mu);
    int& n = fits[{reinterpret_cast<const void*>(kern), smem}];
    if (!n) {
      cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared);
      if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, (int)(32 * warps),
                                                        smem) != cudaSuccess || n < 1)
        n = 1;
    }
    per_sm = n;
  }
  const long long blocks = std::min<long long>((long long)per_sm * sm_count(),
                                               (M + warps - 1) / warps);
  kern<<<(int)blocks, (int)(32 * warps), smem, s>>>(
      (const T*)x, (const G*)gamma, dh, (const T*)g, (T*)dx, stats, M, D, eps);
  return (int)cudaGetLastError();
}

extern "C" {

const char* llc_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

static int ln_blocks(int M) { return (M + LN_ROWS - 1) / LN_ROWS; }

// gdt: the dtype of gamma and beta (DT_F32 or DT_BF16). ft: null, or the
// LoRA fold's (2, R, D) buffer for A_in^T and A_out^T (fa, fb: D x R).
int llc_ln_fwd(int dt, int gdt, const void* x, const void* gamma,
               const void* beta, void* h, int M, int D, float eps,
               const void* fa, const void* fb, void* ft, int R,
               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D > 32 * LN_MAXK) return (int)cudaErrorInvalidValue;
#define LLC_LN_FWD(T, G)                                                     \
  ln_fwd_kernel<T, G><<<ln_blocks(M), LN_THREADS, 0, s>>>(                   \
      (const T*)x, (const G*)gamma, (const G*)beta, (bf16*)h, M, D, eps,     \
      (const bf16*)fa, (const bf16*)fb, (bf16*)ft, R)
  if (dt == DT_BF16) {
    if (gdt == DT_BF16) LLC_LN_FWD(bf16, bf16); else LLC_LN_FWD(bf16, float);
  } else {
    if (gdt == DT_BF16) LLC_LN_FWD(float, bf16); else LLC_LN_FWD(float, float);
  }
#undef LLC_LN_FWD
  return (int)cudaGetLastError();
}

// The LN partials' row chunks (ln_partials_kernel): about LN_PART_SLOTS
// blocks over the column blocks, at least 16 rows each.
static int ln_part_chunks(int M, int D) {
  const int cols = (D + LN_PART_THREADS - 1) / LN_PART_THREADS;
  const int by_rows = (M + 15) / 16, by_slots = LN_PART_SLOTS / cols;
  const int n = by_rows < by_slots ? by_rows : by_slots;
  return n < 1 ? 1 : n;
}

// part: null, or the weight grads' LN workspace: 3 * ln_part_chunks(M, D) *
// D floats of column-sum partials of dh * xhat, dh and g, then 2 * M floats
// of row statistics. Whole rows move by bulk copy: D <= 1024, rows of
// 16-byte multiples and 16-byte aligned x, dh, g and dx, else
// cudaErrorInvalidValue (every tower's D, 512, 768 or 1024, is).
int llc_ln_bwd(int dt, int gdt, const void* x, const void* gamma,
               const float* dh, const void* g, void* dx, float* part, int M,
               int D, float eps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t xb = (size_t)D * (dt == DT_BF16 ? 2 : 4);
  if (D < 1 || D > 32 * LN_MAXK || M < 1 || xb % 16 || (D * 4) % 16 ||
      ((uintptr_t)x | (uintptr_t)dh | (uintptr_t)g | (uintptr_t)dx) % 16)
    return (int)cudaErrorInvalidValue;
  const int chunks = ln_part_chunks(M, D);
  float2* stats = part ? reinterpret_cast<float2*>(part + (size_t)3 * chunks * D)
                       : nullptr;
  int e;
#define LLC_LN_BWD(T, G)                                                     \
  e = part ? launch_ln_bwd<T, G, true>(x, gamma, dh, g, dx, stats, M, D, eps, s) \
           : launch_ln_bwd<T, G, false>(x, gamma, dh, g, dx, stats, M, D, eps, s)
  if (dt == DT_BF16) {
    if (gdt == DT_BF16) { LLC_LN_BWD(bf16, bf16); } else { LLC_LN_BWD(bf16, float); }
  } else {
    if (gdt == DT_BF16) { LLC_LN_BWD(float, bf16); } else { LLC_LN_BWD(float, float); }
  }
#undef LLC_LN_BWD
  if (e || !part) return e;
  const dim3 grid((D + LN_PART_THREADS - 1) / LN_PART_THREADS, chunks);
  const int rows = (M + chunks - 1) / chunks;
  if (dt == DT_BF16)
    ln_partials_kernel<bf16><<<grid, LN_PART_THREADS, 0, s>>>(
        (const bf16*)x, dh, (const bf16*)g, stats, part, M, D, rows);
  else
    ln_partials_kernel<float><<<grid, LN_PART_THREADS, 0, s>>>(
        (const float*)x, dh, (const float*)g, stats, part, M, D, rows);
  return (int)cudaGetLastError();
}

int llc_cast_bf16(int dt, const void* x, void* y, long long n, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = grid_for((size_t)n);
  if (dt == DT_BF16)
    cast_bf16_kernel<bf16><<<blocks, 256, 0, s>>>((const bf16*)x, (bf16*)y, (size_t)n);
  else
    cast_bf16_kernel<float><<<blocks, 256, 0, s>>>((const float*)x, (bf16*)y, (size_t)n);
  return (int)cudaGetLastError();
}

// The column sums of ``count`` <= SUM_SEGS segments of partials in one
// launch: desc holds, for each, (part, out, rows, n) as four 64-bit words,
// scale its factor; out[c] = scale * the sum over r < rows of part[r * n +
// c] in a fixed order.
int llc_partial_sums(int count, const long long* desc, const float* scale,
                     void* stream) {
  if (count < 1 || count > SUM_SEGS) return (int)cudaErrorInvalidValue;
  SumSegs sg = {};
  sg.count = count;
  int tiles = 0;
  for (int i = 0; i < count; ++i) {
    sg.part[i] = reinterpret_cast<const float*>(desc[4 * i]);
    sg.out[i] = reinterpret_cast<float*>(desc[4 * i + 1]);
    sg.rows[i] = (int)desc[4 * i + 2];
    sg.n[i] = (int)desc[4 * i + 3];
    sg.scale[i] = scale[i];
    tiles += (sg.n[i] + 31) / 32;
  }
  partial_sums_kernel<<<tiles, 256, 0, (cudaStream_t)stream>>>(sg);
  return (int)cudaGetLastError();
}

// out_dt selects the output type (and the residual's). splits > 1 needs
// out_dt == DT_F32, no bias/LoRA/residual, and ws of splits * M * N floats.
// Unless M or N is at most 16, A and B need a 16-byte aligned base, a unit
// stride along one dimension and the other a multiple of 8 elements (TMA);
// cudaErrorInvalidValue otherwise. groups > 1 (a grouped launch, GemmArgs)
// takes neither split-K, LoRA nor a residual.
int llc_gemm(int out_dt, int M, int N, int K, const void* A, long long sam,
             long long sak, const void* B, long long sbk, long long sbn,
             float alpha, const void* bias, int bias_dt, const void* lz,
             long long szm,
             long long szr, const void* lb, long long slr, long long sln, int R,
             float lscale, const void* resid, long long ldr, void* out,
             long long ldo, int splits, float* ws, int groups, long long gm,
             long long gn, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  GemmArgs p = {};
  p.M = M; p.N = N; p.K = K;
  p.groups = groups < 1 ? 1 : groups; p.gm = gm; p.gn = gn;
  if (p.groups > 1 && (splits > 1 || lz || resid))
    return (int)cudaErrorInvalidValue;
  p.A = (const bf16*)A; p.sam = sam; p.sak = sak;
  p.B = (const bf16*)B; p.sbk = sbk; p.sbn = sbn;
  p.alpha = alpha; p.bias = bias; p.bias_bf16 = bias_dt == DT_BF16;
  p.lz = (const bf16*)lz; p.szm = szm; p.szr = szr;
  p.lb = (const bf16*)lb; p.slr = slr; p.sln = sln; p.R = R; p.lscale = lscale;
  p.resid = resid; p.ldr = ldr; p.out = out; p.ldo = ldo;
  // operand orientation in shared memory follows its contiguous dimension
  const bool at = sam == 1 && sak != 1;
  const bool bt = sbk == 1 && sbn != 1;
  p.a_vec = ((uintptr_t)A % 16) == 0 && (gm * sam) % 8 == 0 &&
      (at ? (sak % 8 == 0 && M % 8 == 0) : (sak == 1 && sam % 8 == 0 && K % 8 == 0));
  p.b_vec = ((uintptr_t)B % 16) == 0 && (gn * sbn) % 8 == 0 &&
      (bt ? (sbn % 8 == 0 && K % 8 == 0) : (sbn == 1 && sbk % 8 == 0 && N % 8 == 0));
  p.o_vec = ((uintptr_t)out % 8) == 0 && ldo % 2 == 0 && gn % 2 == 0;
  p.r_vec = ((uintptr_t)resid % 8) == 0 && ldr % 2 == 0;
  // TMA reads an operand with a unit stride along one dimension, the other
  // stride a multiple of 16 bytes, from a 16-byte aligned base
  const bool tma =
      ((uintptr_t)A % 16) == 0 && ((uintptr_t)B % 16) == 0 &&
      (at ? sak % 8 == 0 : (sak == 1 && sam % 8 == 0)) &&
      (bt ? sbn % 8 == 0 : (sbn == 1 && sbk % 8 == 0));
  if (splits < 1) splits = 1;
  int kps = (K + splits - 1) / splits;
  kps = (kps + GBK - 1) / GBK * GBK;
  splits = (K + kps - 1) / kps;
  p.k_per_split = kps;
  p.splits = splits;
  if (splits > 1) {
    if (out_dt != DT_F32 || bias || lz || resid || !ws) return (int)cudaErrorInvalidValue;
    p.out = ws;
    int e = launch_gemm<float>(p, at, bt, tma, splits, s);
    if (e) return e;
    const size_t mn = (size_t)M * N;
    splitk_reduce_kernel<<<grid_for(mn), 256, 0, s>>>(ws, splits, mn, alpha, (float*)out);
    return (int)cudaGetLastError();
  }
  if (out_dt == DT_BF16) return launch_gemm<bf16>(p, at, bt, tma, 1, s);
  return launch_gemm<float>(p, at, bt, tma, 1, s);
}

// The fold (GemmArgs): out = bias + A @ B + lscale * Z @ L (+ resid), Z =
// bf16(zalpha * A @ F) formed in the same launch (F K-contiguous, rows sfn
// apart; zout: Z transposed, R rows ldz apart, or null), with the B-type
// partials pb (of zin, laid out as zout) and A-type partials pa (of xa)
// where not null; pb / pa hold ceil(M / 128) * 2 blocks of R * K / N * R
// floats. Layouts and alignment as llc_gemm's TMA road; launch_gemm_fold
// says which shapes are taken.
int llc_gemm_lora(int out_dt, int M, int N, int K, const void* A,
                  long long sam, long long sak, const void* B, long long sbk,
                  long long sbn, const void* bias, int bias_dt, const void* fz,
                  long long sfn, int R, float zalpha, float lscale,
                  const void* lb, long long slr, long long sln, void* zout,
                  const void* zin, long long ldz, float* pb, const void* xa,
                  long long ldx, float* pa, const void* resid, long long ldr,
                  void* out, long long ldo, void* stream) {
  GemmArgs p = {};
  p.M = M; p.N = N; p.K = K;
  p.groups = 1;
  p.A = (const bf16*)A; p.sam = sam; p.sak = sak;
  p.B = (const bf16*)B; p.sbk = sbk; p.sbn = sbn;
  p.alpha = 1.f; p.bias = bias; p.bias_bf16 = bias_dt == DT_BF16;
  p.lb = (const bf16*)lb; p.slr = slr; p.sln = sln; p.R = R; p.lscale = lscale;
  p.resid = resid; p.ldr = ldr; p.out = out; p.ldo = ldo;
  p.fz = (const bf16*)fz; p.sfn = sfn; p.zalpha = zalpha;
  p.zout = (bf16*)zout; p.zin = (const bf16*)zin; p.ldz = ldz; p.pb = pb;
  p.xa = (const bf16*)xa; p.ldx = ldx; p.pa = pa;
  p.o_vec = ((uintptr_t)out % 8) == 0 && ldo % 2 == 0;
  p.r_vec = ((uintptr_t)resid % 8) == 0 && ldr % 2 == 0;
  p.k_per_split = (K + GBK - 1) / GBK * GBK;
  p.splits = 1;
  const bool at = sam == 1 && sak != 1;
  const bool bt = sbk == 1 && sbn != 1;
  const bool tma =
      ((uintptr_t)A % 16) == 0 && ((uintptr_t)B % 16) == 0 &&
      (at ? sak % 8 == 0 : (sak == 1 && sam % 8 == 0)) &&
      (bt ? sbn % 8 == 0 : (sbn == 1 && sbk % 8 == 0)) &&
      ((uintptr_t)fz % 16) == 0 && sfn % 8 == 0 &&
      (!zout || ldz >= M) && (!pb || (((uintptr_t)zin % 16) == 0 && ldz % 8 == 0)) &&
      (!pa || (((uintptr_t)xa % 16) == 0 && ldx % 8 == 0));
  cudaStream_t s = (cudaStream_t)stream;
  if (out_dt == DT_BF16) return launch_gemm_fold<bf16>(p, at, bt, tma, s);
  return launch_gemm_fold<float>(p, at, bt, tma, s);
}

// mask: null or a (T, T) fp32 matrix; tmap: null (every block) or that
// mask's tile map (llc_mask_tile_map), whose dead blocks the kernels skip.
// A mask takes the map-reading kernels of the prefix road with P = 0; no
// mask keeps the kernels that read none.
int llc_attn_fwd(const void* qkv, const float* mask, const void* tmap,
                 void* ctx, int B, int T, int D, int H, float scale,
                 void* stream) {
  if (tmap && !mask) return (int)cudaErrorInvalidValue;
  AttnArgs a = {};
  a.qkv = (const bf16*)qkv; a.mask = mask;
  a.tmap = (const unsigned char*)tmap; a.ctx = (bf16*)ctx;
  a.B = B; a.T = T; a.P = 0; a.D = D; a.H = H; a.scale = scale;
  return mask ? launch_attn<false, true, false>(a, (cudaStream_t)stream)
              : launch_attn<false, false, false>(a, (cudaStream_t)stream);
}

// stats: B * H * ceil16(T) float4s of workspace (row max, 1 / row sum,
// delta; 16-byte aligned), null where the road takes the warpgroup-MMA
// kernels (attn_wgmma_road, attn_wgmma_long_road: they keep it in shared
// memory). bpart: null, or
// the bias partials (AttnArgs),
// (B * ceil(T/16) * D + B * ceil(S/16) * 2D) floats. mask and tmap as
// llc_attn_fwd's.
int llc_attn_bwd(const void* qkv, const void* dctx, const float* mask,
                 const void* tmap, void* dqkv16, float* bpart, float* stats,
                 int B, int T, int D, int H, float scale, void* stream) {
  if (tmap && !mask) return (int)cudaErrorInvalidValue;
  AttnArgs a = {};
  a.qkv = (const bf16*)qkv; a.dctx = (const bf16*)dctx; a.mask = mask;
  a.tmap = (const unsigned char*)tmap;
  a.dqkv16 = (bf16*)dqkv16; a.bpart = bpart; a.stats = (float4*)stats;
  a.B = B; a.T = T; a.P = 0; a.D = D; a.H = H; a.scale = scale;
  return mask ? launch_attn<true, true, false>(a, (cudaStream_t)stream)
              : launch_attn<true, false, false>(a, (cudaStream_t)stream);
}

// The tile map of a (T, S) fp32 mask (mask_tile_map_kernel) into tmap,
// ceil(T/16) x ceil(S/16) bytes.
int llc_mask_tile_map(const float* mask, void* tmap, int T, int S,
                      void* stream) {
  if (T < 1 || S < 1) return (int)cudaErrorInvalidValue;
  mask_tile_map_kernel<<<(T + 15) / 16, TM_THREADS, 0, (cudaStream_t)stream>>>(
      mask, (unsigned char*)tmap, T, S);
  return (int)cudaGetLastError();
}

// KV-prefix attention: kvp (B*P, 2D) holds the projected prefix keys and
// values (K | V); mask is null, (T, P + T) fp32 with mask_rs = P + T, or one
// (P + T,) key-mask row for every query with mask_rs = 0. tmap: the (T, P +
// T) mask's tile map (llc_mask_tile_map), whose dead blocks the kernels
// skip, or null (every block); only with a (T, P + T) mask.
int llc_attn_prefix_fwd(const void* qkv, const void* kvp, const float* mask,
                        int mask_rs, const void* tmap, void* ctx, int B, int T,
                        int P, int D, int H, float scale, void* stream) {
  if (P < 1 || (mask_rs && mask_rs != P + T) || (tmap && !(mask && mask_rs)))
    return (int)cudaErrorInvalidValue;
  AttnArgs a = {};
  a.qkv = (const bf16*)qkv; a.kvp = (const bf16*)kvp; a.mask = mask;
  a.tmap = (const unsigned char*)tmap; a.ctx = (bf16*)ctx;
  a.B = B; a.T = T; a.P = P; a.D = D; a.H = H; a.scale = scale;
  return mask && !mask_rs
      ? launch_attn<false, true, true>(a, (cudaStream_t)stream)
      : launch_attn<false, true, false>(a, (cudaStream_t)stream);
}

// dkvp16 (B*P, 2D) receives dK | dV of the prefix keys, dqkv16 those of the
// tokens, and bpart the bias partials, as llc_attn_bwd (S = P + T).
int llc_attn_prefix_bwd(const void* qkv, const void* kvp, const void* dctx,
                        const float* mask, int mask_rs, const void* tmap,
                        void* dqkv16, void* dkvp16, float* bpart,
                        float* stats, int B, int T, int P,
                        int D, int H, float scale, void* stream) {
  if (P < 1 || (mask_rs && mask_rs != P + T) || (tmap && !(mask && mask_rs)))
    return (int)cudaErrorInvalidValue;
  AttnArgs a = {};
  a.qkv = (const bf16*)qkv; a.kvp = (const bf16*)kvp;
  a.dctx = (const bf16*)dctx; a.mask = mask;
  a.tmap = (const unsigned char*)tmap;
  a.dqkv16 = (bf16*)dqkv16; a.dkvp16 = (bf16*)dkvp16;
  a.bpart = bpart; a.stats = (float4*)stats;
  a.B = B; a.T = T; a.P = P; a.D = D; a.H = H; a.scale = scale;
  return mask && !mask_rs
      ? launch_attn<true, true, true>(a, (cudaStream_t)stream)
      : launch_attn<true, true, false>(a, (cudaStream_t)stream);
}

}  // extern "C"
