// Hand-written Hopper (sm_90a) kernels for attention on projected q, k, v:
// o = softmax(q k^T * scale + mask) v per head, forward and backward, with
// p kept in fp32 whatever the input type.
//
// Replaces the Pallas TPU kernels of lifelong_clip_tpu/ops/flash_attention.py:
//   * _attn_kernel     (:32, pallas_call at :96)  -> flash_fwd_tc_kernel (up
//     to 256 keys) and flash_fwd_tc_tiled_kernel (above) for bf16 inputs
//     (tensor cores); flash_fwd_kernel for fp32 inputs (CUDA cores)
//   * _attn_bwd_kernel (:128, pallas_call at :191) -> flash_bwd_dq_tc_kernel
//     and flash_bwd_dkv_tc_kernel for bf16 inputs (tensor cores);
//     flash_bwd_dq_kernel and flash_bwd_dkv_kernel for fp32 inputs (CUDA
//     cores). The launchers dispatch on the dtype.
//
// What the TPU kernels compute, and so what these compute:
//   forward   s = (q . k) * scale + mask (q, k, v upcast to fp32); m = max_j s;
//             e = exp(s - m); o = (e @ v) / sum_j e, rounded once to q's type.
//             p is never rounded: e @ v is an fp32 product.
//   backward  p = e / sum_j e recomputed in fp32; dv = p^T g; dp = g v^T;
//             ds = p * (dp - rowsum(dp * p)); dq = ds k * scale;
//             dk = ds^T q * scale; each cast once to its input's type.
//
// Bound on an H100 SXM at the prompted-LoRA block of ViT-B/16 (B*H = 768,
// T = 197, S = 217, dh = 64, bf16): forward ~8.4 GFLOP and ~81 MB, backward
// ~21 GFLOP and ~143 MB; both bound by memory (~0.024 and ~0.043 ms against
// 3.35 TB/s), not by the tensor cores (989 TFLOP/s bf16). chip_smoke.py
// computes both.
//
// The bf16 forward (tensor cores):
//   * q k^T on mma.sync m16n8k16 over the bf16 inputs (exact products, fp32
//     sums); e @ v takes the fp32 e as bf16 hi + lo in two MMAs into one
//     fp32 accumulator (pack_split, as the backward below); each warp owns
//     16 query rows, and the score accumulators come out in the layout the
//     next MMA takes as its A operand, so e never leaves registers.
//   * Up to 256 keys (the register road) a warp keeps its rows' whole score
//     rows in registers (S = 217: 28 tiles of 8 keys, 112 fp32 a thread):
//     q k^T runs once and K and V are read once, in 64-key cp.async commit
//     groups whose arrival the first products follow. One block per (16 x
//     warps query rows, head, batch row), warps from a sweep (FWD_WARPS).
//   * Above 256 keys (the tiled road) K and V stream through double-buffered
//     64-key tiles in two passes, the row max first, then e and e @ v with
//     that final max, so there is no key limit and no online rescaling.
//
// The bf16 backward (tensor cores):
//   * Every product is an mma.sync m16n8k16 with fp32 accumulation; each of
//     4 warps owns 16 rows of its block's 64 (queries in the dq kernel, keys
//     in the dk/dv kernel). q k^T and g v^T multiply the bf16 inputs, whose
//     products are exact in fp32. The products that contract over the fp32
//     p or ds take it as hi = bf16(x) and lo = bf16(x - hi) in two MMAs into
//     one fp32 accumulator (pack_split): ~2**-16 of each element is dropped,
//     far inside the check's 1e-4 of the output's max, and p is never
//     rounded to bf16 (tests/test_torch_flash_split.py emulates this against
//     the TPU kernel). fp32 CUDA-core FMAs ran these products at ~44% of
//     67 TFLOP/s; the tensor cores leave the kernels to their loads,
//     exponentials and softmax arithmetic.
//   * No shared-memory round trips between products: the dk/dv kernel takes
//     s^T = k q^T and dp^T = v g^T with keys as rows, so p^T and ds^T come
//     out in the accumulator layout that the next MMA takes as its A
//     operand; so does ds in the dq kernel. K and V (dq kernel) and Q, G and
//     the saved statistics (dk/dv kernel) stream through double-buffered
//     cp.async tiles of 64 rows.
//   * The dq kernel takes three passes over the key tiles: the row max; the
//     row sum of e and t = sum(dp * e), so delta = rowsum(dp * p) = t / l in
//     fp32 (not rowsum(g * o), which would read the bf16-rounded o); then ds
//     and dq. It saves m, l and delta; the dk/dv kernel rebuilds p^T from
//     them. No atomics: every output element is written once by one thread,
//     so the backward is bitwise repeatable.
//   * Ragged edges at 16-row granularity: score and product tiles past S
//     keys or T queries are skipped (T = 197 computes 208 query rows, S = 217
//     224 keys).
//
// The fp32 forward and backward (CUDA cores, --no_bf16 only), the first
// port's:
//   * Every product is an fp32 FMA on the fp32 operands, keys tiled 64 at
//     a time through shared memory with a two-pass softmax (the row max
//     first, then e = exp(s - m) with that final max, its row sum and e @ v,
//     one division at the end, as the TPU kernel): no online rescaling, so e
//     is the TPU kernel's e. One block per (64-query tile, head, batch row),
//     256 threads, each owning a 4 x 4 block of every 64 x 64 tile and
//     reading its operands 16 bytes at a time (K, and V where the product
//     contracts over the head dim, transposed in shared memory). The fp32
//     backward's dq kernel takes three passes as above and its dk/dv kernel
//     rebuilds p from the saved statistics.
//
// Both roads: no key limit (keys are tiled); the additive mask is read
// through a pointer and two element strides (a (T, S) matrix, one (S,) key
// row for every query with row stride 0, or anything the wrapper broadcasts
// to (T, S) without copying; null: no mask); a key the mask kills (-inf)
// gets e = 0, so dk = dv = 0 exactly; keys past S get e = 0 and queries past
// T are not stored. Head dim 64 only (every tower the repository has); the
// launcher refuses any other.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

enum { FL_F32 = 0, FL_BF16 = 1 };   // dtype codes shared with the wrapper

constexpr int DH = 64;        // head dim
constexpr int TILE = 64;      // queries or keys per tile
constexpr int LDS = DH + 4;   // shared-memory row pitch, in floats
constexpr int NT = 256;       // threads per block, a 16 x 16 grid
constexpr int TILE_FLOATS = TILE * LDS;

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Reduce over the 16 threads of a half warp that share ty (they differ in tx).
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Four consecutive fp32 elements from or to device memory, 16 bytes
// aligned.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// Rows row0 .. row0 + 63 of one head (columns col .. col + 63) of a (B*L, D)
// fp32 tensor of batch row b into a 64 x LDS tile, row-major
// ([row][dim]) or, with TRANS, transposed ([dim][row]); rows at or past L
// are zero.
template <bool TRANS>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int b,
                                          int L, int D, int col, int row0) {
  const float* base = src + ((size_t)b * L) * D + col;
  for (int i = threadIdx.x; i < TILE * DH / 4; i += NT) {
    const int r = i >> 4, c = (i & 15) * 4, row = row0 + r;
    const float4 v = row < L ? load4(base + (size_t)row * D + c)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (TRANS) {
      dst[c * LDS + r] = v.x;
      dst[(c + 1) * LDS + r] = v.y;
      dst[(c + 2) * LDS + r] = v.z;
      dst[(c + 3) * LDS + r] = v.w;
    } else {
      *reinterpret_cast<float4*>(dst + r * LDS + c) = v;
    }
  }
}

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* g;
  const float* mask;
  long long mrs, mcs;   // the mask's row and column strides, in elements
  void* o;
  void* dq;
  void* dk;
  void* dv;
  float* stats;         // (B, H, T, 3): row max, row sum, delta
  int B, T, S, D, H;
  float scale;
};

__device__ __forceinline__ float mask_at(const FlashArgs& a, int i, int j) {
  return a.mask ? a.mask[(long long)i * a.mrs + (long long)j * a.mcs] : 0.f;
}

// acc[i][j] += sum_k A[4ty + i][k] * B[k][4tx + j] over k < 64, both
// operands in shared memory with pitch LDS.
__device__ __forceinline__ void tile_mm(float acc[4][4], const float* A,
                                        const float* B, int ty, int tx) {
#pragma unroll 4
  for (int k0 = 0; k0 < TILE; k0 += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (4 * ty + i) * LDS + k0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 bv = *reinterpret_cast<const float4*>(B + (k0 + kk) * LDS + 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av = comp(a[i], kk);
        acc[i][0] = fmaf(av, bv.x, acc[i][0]);
        acc[i][1] = fmaf(av, bv.y, acc[i][1]);
        acc[i][2] = fmaf(av, bv.z, acc[i][2]);
        acc[i][3] = fmaf(av, bv.w, acc[i][3]);
      }
    }
  }
}

__device__ __forceinline__ void zero(float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

// Scores of one (query tile, key tile) from Q (row-major) and K^T: s = dot *
// scale + mask, -inf on keys past S (so e = 0 there) and on queries past T.
__device__ __forceinline__ void scores(float s[4][4], const FlashArgs& a,
                                       const float* Qs, const float* Kt,
                                       int q0, int k0, int ty, int tx) {
  zero(s);
  tile_mm(s, Qs, Kt, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kj = k0 + 4 * tx + j;
      s[i][j] = (qi < a.T && kj < a.S) ? s[i][j] * a.scale + mask_at(a, qi, kj)
                                       : -INFINITY;
    }
  }
}

// Four consecutive columns of row r of a tile, row-major.
__device__ __forceinline__ void put_row(float* dst, int r, int c,
                                        const float v[4]) {
  *reinterpret_cast<float4*>(dst + r * LDS + c) = make_float4(v[0], v[1], v[2], v[3]);
}

// Column j of a thread's 4 x 4 block, transposed: dst[4tx + j][4ty .. +3].
__device__ __forceinline__ void put_col_t(float* dst, const float v[4][4],
                                          int j, int ty, int tx) {
  *reinterpret_cast<float4*>(dst + (4 * tx + j) * LDS + 4 * ty) =
      make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
}

// ---------------------------------------------------------------------------
// Forward: grid (ceil(T/64), H, B). Pass 1 takes the row max over every key
// tile; pass 2 computes e = exp(s - m), its row sum and e @ v, and divides.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(FlashArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // [query][dim]
  float* Kt = Qs + TILE_FLOATS;     // [dim][key]
  float* Vs = Kt + TILE_FLOATS;     // [key][dim]
  float* Es = Vs + TILE_FLOATS;     // [query][key]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.z, col = blockIdx.y * DH, q0 = blockIdx.x * TILE;
  const float* k = (const float*)a.k;
  const float* v = (const float*)a.v;
  load_tile<false>(Qs, (const float*)a.q, b, a.T, a.D, col, q0);

  float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  float s[4][4];
  for (int k0 = 0; k0 < a.S; k0 += TILE) {
    __syncthreads();
    load_tile<true>(Kt, k, b, a.S, a.D, col, k0);
    __syncthreads();
    scores(s, a, Qs, Kt, q0, k0, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) m[i] = fmaxf(m[i], s[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = half_max(m[i]);

  float l[4] = {0.f, 0.f, 0.f, 0.f}, acc[4][4];
  zero(acc);
  for (int k0 = 0; k0 < a.S; k0 += TILE) {
    __syncthreads();
    load_tile<true>(Kt, k, b, a.S, a.D, col, k0);
    load_tile<false>(Vs, v, b, a.S, a.D, col, k0);
    __syncthreads();
    scores(s, a, Qs, Kt, q0, k0, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m[i]);
        l[i] += s[i][j];
      }
      put_row(Es, 4 * ty + i, 4 * tx, s[i]);
    }
    __syncthreads();
    tile_mm(acc, Es, Vs, ty, tx);
  }
  float* o = (float*)a.o;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float li = half_sum(l[i]);
    const int qi = q0 + 4 * ty + i;
    if (qi < a.T)
      store4(o + ((size_t)b * a.T + qi) * a.D + col + 4 * tx, acc[i][0] / li,
             acc[i][1] / li, acc[i][2] / li, acc[i][3] / li);
  }
}

// ---------------------------------------------------------------------------
// Backward, dq: grid (ceil(T/64), H, B). Pass 1: row max m. Pass 2: row sum
// l of e = exp(s - m) and t = sum(dp * e), so delta = rowsum(dp * p) = t / l.
// Pass 3: p = e / l, ds = p * (dp - delta), dq = ds k * scale. Saves m, l,
// delta for every query row.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(FlashArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // [query][dim]
  float* Gs = Qs + TILE_FLOATS;     // [query][dim]
  float* Kt = Gs + TILE_FLOATS;     // [dim][key]
  float* Ks = Kt + TILE_FLOATS;     // [key][dim]
  float* Vt = Ks + TILE_FLOATS;     // [dim][key]
  float* Ds = Vt + TILE_FLOATS;     // [query][key]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.z, hd = blockIdx.y, col = hd * DH;
  const int q0 = blockIdx.x * TILE;
  const float* k = (const float*)a.k;
  const float* v = (const float*)a.v;
  load_tile<false>(Qs, (const float*)a.q, b, a.T, a.D, col, q0);
  load_tile<false>(Gs, (const float*)a.g, b, a.T, a.D, col, q0);

  float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  float s[4][4], dp[4][4];
  for (int k0 = 0; k0 < a.S; k0 += TILE) {
    __syncthreads();
    load_tile<true>(Kt, k, b, a.S, a.D, col, k0);
    __syncthreads();
    scores(s, a, Qs, Kt, q0, k0, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) m[i] = fmaxf(m[i], s[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = half_max(m[i]);

  float l[4] = {0.f, 0.f, 0.f, 0.f}, t[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < a.S; k0 += TILE) {
    __syncthreads();
    load_tile<true>(Kt, k, b, a.S, a.D, col, k0);
    load_tile<true>(Vt, v, b, a.S, a.D, col, k0);
    __syncthreads();
    scores(s, a, Qs, Kt, q0, k0, ty, tx);
    zero(dp);
    tile_mm(dp, Gs, Vt, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - m[i]);
        l[i] += e;
        t[i] = fmaf(dp[i][j], e, t[i]);
      }
  }
  float delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l[i] = half_sum(l[i]);
    delta[i] = half_sum(t[i]) / l[i];
  }

  float acc[4][4];
  zero(acc);
  for (int k0 = 0; k0 < a.S; k0 += TILE) {
    __syncthreads();
    load_tile<true>(Kt, k, b, a.S, a.D, col, k0);
    load_tile<false>(Ks, k, b, a.S, a.D, col, k0);
    load_tile<true>(Vt, v, b, a.S, a.D, col, k0);
    __syncthreads();
    scores(s, a, Qs, Kt, q0, k0, ty, tx);
    zero(dp);
    tile_mm(dp, Gs, Vt, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m[i]) / l[i];
        s[i][j] = p * (dp[i][j] - delta[i]);
      }
      put_row(Ds, 4 * ty + i, 4 * tx, s[i]);
    }
    __syncthreads();
    tile_mm(acc, Ds, Ks, ty, tx);
  }
  float* dq = (float*)a.dq;
  float* st = a.stats + ((size_t)b * a.H + hd) * a.T * 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + 4 * ty + i;
    if (qi >= a.T) continue;
    store4(dq + ((size_t)b * a.T + qi) * a.D + col + 4 * tx,
           acc[i][0] * a.scale, acc[i][1] * a.scale, acc[i][2] * a.scale,
           acc[i][3] * a.scale);
    if (tx == 0) {
      st[qi * 3] = m[i];
      st[qi * 3 + 1] = l[i];
      st[qi * 3 + 2] = delta[i];
    }
  }
}

// ---------------------------------------------------------------------------
// Backward, dk and dv: grid (ceil(S/64), H, B). For every query tile:
// p = exp(s - m) / l from the saved statistics, dp = g v^T,
// ds = p * (dp - delta); dv += p^T g, dk += ds^T q; dk is scaled at the end.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(FlashArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;                 // [dim][key]
  float* Vt = Kt + TILE_FLOATS;     // [dim][key]
  float* Qs = Vt + TILE_FLOATS;     // [query][dim]
  float* Gs = Qs + TILE_FLOATS;     // [query][dim]
  float* Pt = Gs + TILE_FLOATS;     // [key][query]
  float* Dt = Pt + TILE_FLOATS;     // [key][query]
  float* St = Dt + TILE_FLOATS;     // 64 x (m, l, delta)
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.z, hd = blockIdx.y, col = hd * DH;
  const int k0 = blockIdx.x * TILE;
  const float* q = (const float*)a.q;
  const float* g = (const float*)a.g;
  const float* gst = a.stats + ((size_t)b * a.H + hd) * a.T * 3;
  load_tile<true>(Kt, (const float*)a.k, b, a.S, a.D, col, k0);
  load_tile<true>(Vt, (const float*)a.v, b, a.S, a.D, col, k0);

  float dk[4][4], dv[4][4], s[4][4], dp[4][4];
  zero(dk);
  zero(dv);
  for (int q0 = 0; q0 < a.T; q0 += TILE) {
    __syncthreads();
    load_tile<false>(Qs, q, b, a.T, a.D, col, q0);
    load_tile<false>(Gs, g, b, a.T, a.D, col, q0);
    for (int i = threadIdx.x; i < TILE * 3; i += NT) {
      const int r = i / 3;
      St[i] = q0 + r < a.T ? gst[(size_t)q0 * 3 + i] : (i % 3 == 1 ? 1.f : 0.f);
    }
    __syncthreads();
    scores(s, a, Qs, Kt, q0, k0, ty, tx);   // rows: queries, columns: keys
    zero(dp);
    tile_mm(dp, Gs, Vt, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      const float mi = St[r * 3], li = St[r * 3 + 1], di = St[r * 3 + 2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // s is -inf past T and S, so p = 0 there
        const float p = expf(s[i][j] - mi) / li;
        s[i][j] = p;
        dp[i][j] = p * (dp[i][j] - di);   // ds
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      put_col_t(Pt, s, j, ty, tx);
      put_col_t(Dt, dp, j, ty, tx);
    }
    __syncthreads();
    tile_mm(dv, Pt, Gs, ty, tx);   // rows: keys, columns: head dims
    tile_mm(dk, Dt, Qs, ty, tx);
  }
  float* dko = (float*)a.dk;
  float* dvo = (float*)a.dv;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + 4 * ty + i;
    if (kj >= a.S) continue;
    const size_t o = ((size_t)b * a.S + kj) * a.D + col + 4 * tx;
    store4(dko + o, dk[i][0] * a.scale, dk[i][1] * a.scale,
           dk[i][2] * a.scale, dk[i][3] * a.scale);
    store4(dvo + o, dv[i][0], dv[i][1], dv[i][2], dv[i][3]);
  }
}

// ---------------------------------------------------------------------------
// Backward of bf16 inputs on tensor cores: the same two kernels, each warp
// owning 16 rows of its block's 64, every product an m16n8k16 bf16 MMA with
// fp32 accumulation. q k^T and g v^T (k q^T and v g^T in the dk/dv kernel)
// multiply the bf16 inputs, whose products are exact in fp32. The products
// that contract over p or ds (dq = ds k, dv = p^T g, dk = ds^T q) take the
// fp32 operand as bf16 hi + lo (pack_split) in two MMAs into one fp32
// accumulator: ~2**-16 of each element is dropped, so p and ds are never
// rounded to bf16. Keys past S and queries past T are skipped 16 at a time.
// ---------------------------------------------------------------------------
constexpr int TC_LD = DH + 8;                 // bf16 pitch: 144-byte rows
constexpr int TC_THREADS = 128;               // 4 warps x 16 rows
constexpr int TC_TILE_ELEMS = TILE * TC_LD;

// Rows row0 .. row0 + rows - 1 of one head of a (B*L, D) bf16 tensor into
// a [row][dim] tile by 16-byte cp.async copies of the block's nthr threads;
// rows at or past L are zero. The caller commits and waits.
__device__ __forceinline__ void tc_load_rows(bf16* dst, const bf16* src, int b,
                                             int L, int D, int col, int row0,
                                             int rows, int nthr) {
  const bf16* base = src + (size_t)b * L * D + col;
  for (int c = threadIdx.x; c < rows * DH / 8; c += nthr) {
    const int r = c >> 3, cc = (c & 7) * 8, row = row0 + r;
    const bool ok = row < L;
    cp_async16(dst + r * TC_LD + cc, ok ? base + (size_t)row * D + cc : src, ok);
  }
}

// A 64-row tile, by the TC_THREADS threads of a 4-warp block.
__device__ __forceinline__ void tc_load_tile(bf16* dst, const bf16* src, int b,
                                             int L, int D, int col, int row0) {
  tc_load_rows(dst, src, b, L, D, col, row0, TILE, TC_THREADS);
}

// The warp's 16 x 64 A fragments (4 k16 steps) from rows r0 .. r0 + 15 of a
// [row][dim] tile.
__device__ __forceinline__ void tc_frag_a(unsigned a[4][4], const bf16* s,
                                          int r0, int lane) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
    ldsm_x4(a[kc], s + (r0 + (lane & 15)) * TC_LD + kc * 16 + (lane >> 4) * 8);
}

// acc (16 x 64) += A . B^T: A the warp's fragments over the head dim, B the
// 64 rows of a [row][dim] tile (n16 chunks at or past nlive skipped).
__device__ __forceinline__ void tc_dot_rows(float acc[8][4],
                                            unsigned a[4][4],
                                            const bf16* Bs, int nlive,
                                            int lane) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (16 * j >= nlive) continue;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      unsigned kb[4];
      ldsm_x4(kb, Bs + (16 * j + (lane & 7) + ((lane >> 4) << 3)) * TC_LD +
                      kc * 16 + ((lane >> 3) & 1) * 8);
      mma16816(acc[2 * j], a[kc], kb[0], kb[1]);
      mma16816(acc[2 * j + 1], a[kc], kb[2], kb[3]);
    }
  }
}

// acc (16 x 64 dims) += x . B: x fp32 (16 x 64, C fragments, split hi + lo),
// B the [row][dim] tile whose 64 rows x contracts over (k16 chunks at or
// past nlive skipped).
__device__ __forceinline__ void tc_split_mm(float acc[8][4],
                                            float x[8][4],
                                            const bf16* Bs, int nlive,
                                            int lane) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (16 * c >= nlive) continue;
    unsigned hi[4], lo[4];
    pack_split(x[2 * c][0], x[2 * c][1], hi[0], lo[0]);
    pack_split(x[2 * c][2], x[2 * c][3], hi[1], lo[1]);
    pack_split(x[2 * c + 1][0], x[2 * c + 1][1], hi[2], lo[2]);
    pack_split(x[2 * c + 1][2], x[2 * c + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int cp = 0; cp < 4; ++cp) {
      unsigned vb[4];
      ldsm_x4_t(vb, Bs + (16 * c + (lane & 7) + ((lane >> 3) & 1) * 8) * TC_LD +
                        cp * 16 + (lane >> 4) * 8);
      mma16816(acc[2 * cp], hi, vb[0], vb[1]);
      mma16816(acc[2 * cp], lo, vb[0], vb[1]);
      mma16816(acc[2 * cp + 1], hi, vb[2], vb[3]);
      mma16816(acc[2 * cp + 1], lo, vb[2], vb[3]);
    }
  }
}

__device__ __forceinline__ void zero8(float x[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[i][e] = 0.f;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// dq: grid (ceil(T/64), H, B). Three passes over 64-key tiles, each tile's
// K (and V after the first pass) double-buffered through cp.async: the row
// max m; the row sum l of e = exp(s - m) and t = sum(dp * e), so delta =
// rowsum(dp * p) = t / l in fp32; then p = e / l, ds = p * (dp - delta) and
// dq += ds k. Saves m, l and delta of every query row.
__global__ void __launch_bounds__(TC_THREADS)
flash_bwd_dq_tc_kernel(FlashArgs a) {
  extern __shared__ __align__(16) unsigned char tsm[];
  bf16* Qs = reinterpret_cast<bf16*>(tsm);   // [query][dim]
  bf16* Gs = Qs + TC_TILE_ELEMS;             // [query][dim]
  bf16* Ks = Gs + TC_TILE_ELEMS;             // 2 x [key][dim]
  bf16* Vs = Ks + 2 * TC_TILE_ELEMS;         // 2 x [key][dim]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, hd = blockIdx.y, col = hd * DH;
  const int q0 = blockIdx.x * TILE, r0 = warp * 16;
  const bf16* k = (const bf16*)a.k;
  const bf16* v = (const bf16*)a.v;
  const int nk = (a.S + TILE - 1) / TILE, total = 3 * nk;
  tc_load_tile(Qs, (const bf16*)a.q, b, a.T, a.D, col, q0);
  tc_load_tile(Gs, (const bf16*)a.g, b, a.T, a.D, col, q0);
  tc_load_tile(Ks, k, b, a.S, a.D, col, 0);
  cp_async_commit();

  const bool live = q0 + r0 < a.T;   // warp-uniform
  const int ia = q0 + r0 + g, ib = ia + 8;
  unsigned qa[4][4], ga[4][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, t[2] = {0.f, 0.f};
  float il[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
  float dq[8][4], s[8][4], dp[8][4];
  zero8(dq);
  for (int it = 0; it < total; ++it) {
    const int pass = it / nk, k0 = (it % nk) * TILE, buf = it & 1;
    if (it + 1 < total) {
      const int kn = ((it + 1) % nk) * TILE, nb = (it + 1) & 1;
      tc_load_tile(Ks + nb * TC_TILE_ELEMS, k, b, a.S, a.D, col, kn);
      if (it + 1 >= nk)
        tc_load_tile(Vs + nb * TC_TILE_ELEMS, v, b, a.S, a.D, col, kn);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (live) {
      if (it == 0) {
        tc_frag_a(qa, Qs, r0, lane);
        tc_frag_a(ga, Gs, r0, lane);
      }
      const bf16* Kb = Ks + buf * TC_TILE_ELEMS;
      const int nlive = a.S - k0;
      zero8(s);
      tc_dot_rows(s, qa, Kb, nlive, lane);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e < 2 ? ia : ib, j = k0 + nt * 8 + 2 * t4 + (e & 1);
          // rows past T (never stored) keep finite scores
          s[nt][e] = j < a.S ? s[nt][e] * a.scale + (i < a.T ? mask_at(a, i, j) : 0.f)
                             : -INFINITY;
        }
      if (pass == 0) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          m[0] = fmaxf(m[0], fmaxf(s[nt][0], s[nt][1]));
          m[1] = fmaxf(m[1], fmaxf(s[nt][2], s[nt][3]));
        }
      } else {
        zero8(dp);
        tc_dot_rows(dp, ga, Vs + buf * TC_TILE_ELEMS, nlive, lane);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            const float ev = expf(s[nt][e] - m[h]);
            if (pass == 1) {
              l[h] += ev;
              t[h] = fmaf(dp[nt][e], ev, t[h]);
            } else {
              s[nt][e] = ev * il[h] * (dp[nt][e] - dl[h]);   // ds
            }
          }
        if (pass == 2) tc_split_mm(dq, s, Kb, nlive, lane);
      }
      if (it == nk - 1) {
        m[0] = quad_max(m[0]);
        m[1] = quad_max(m[1]);
      } else if (it == 2 * nk - 1) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          l[h] = quad_sum(l[h]);
          dl[h] = quad_sum(t[h]) / l[h];
          il[h] = 1.f / l[h];
        }
      }
    }
    __syncthreads();   // the buffer read here is refilled next iteration
  }
  if (!live) return;
  bf16* dqo = (bf16*)a.dq;
  float* st = a.stats + ((size_t)b * a.H + hd) * a.T * 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = h ? ib : ia;
    if (i >= a.T) continue;
    bf16* row = dqo + ((size_t)b * a.T + i) * a.D + col;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<unsigned*>(row + nt * 8 + 2 * t4) =
          pack_bf16(dq[nt][2 * h] * a.scale, dq[nt][2 * h + 1] * a.scale);
    if (t4 == 0) {
      st[i * 3] = m[h];
      st[i * 3 + 1] = l[h];
      st[i * 3 + 2] = dl[h];
    }
  }
}

// dk and dv: grid (ceil(S/64), H, B); warp w owns keys k0 + 16w .. +15. For
// every 64-query tile (Q, G and the saved statistics double-buffered):
// s^T = k q^T and dp^T = v g^T with keys as rows, so p^T = exp(s^T - m) / l
// and ds^T = p^T (dp^T - delta) come out in the accumulator layout that the
// next products take as their A operand: dv += p^T g, dk += ds^T q.
__global__ void __launch_bounds__(TC_THREADS)
flash_bwd_dkv_tc_kernel(FlashArgs a) {
  extern __shared__ __align__(16) unsigned char tsm[];
  bf16* Ks = reinterpret_cast<bf16*>(tsm);   // [key][dim]
  bf16* Vs = Ks + TC_TILE_ELEMS;             // [key][dim]
  bf16* Qs = Vs + TC_TILE_ELEMS;             // 2 x [query][dim]
  bf16* Gs = Qs + 2 * TC_TILE_ELEMS;         // 2 x [query][dim]
  float* St = reinterpret_cast<float*>(Gs + 2 * TC_TILE_ELEMS);   // 2 x 64 x (m, 1/l, delta)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, hd = blockIdx.y, col = hd * DH;
  const int k0 = blockIdx.x * TILE, j0 = warp * 16;
  const bf16* q = (const bf16*)a.q;
  const bf16* gg = (const bf16*)a.g;
  const float* gst = a.stats + ((size_t)b * a.H + hd) * a.T * 3;
  const int nq = (a.T + TILE - 1) / TILE;
  auto load_stats = [&](float* dst, int q0) {
    for (int i = threadIdx.x; i < TILE * 3; i += TC_THREADS) {
      const float x = q0 * 3 + i < a.T * 3 ? gst[(size_t)q0 * 3 + i] : 1.f;
      dst[i] = i % 3 == 1 ? 1.f / x : x;
    }
  };
  tc_load_tile(Ks, (const bf16*)a.k, b, a.S, a.D, col, k0);
  tc_load_tile(Vs, (const bf16*)a.v, b, a.S, a.D, col, k0);
  tc_load_tile(Qs, q, b, a.T, a.D, col, 0);
  tc_load_tile(Gs, gg, b, a.T, a.D, col, 0);
  cp_async_commit();
  load_stats(St, 0);

  const bool live = k0 + j0 < a.S;   // warp-uniform
  const int ja = k0 + j0 + g, jb = ja + 8;
  // a key-mask row (row stride 0) is the same for every query: read it once
  const bool krow = a.mask && a.mrs == 0;
  const float mka = krow && ja < a.S ? mask_at(a, 0, ja) : 0.f;
  const float mkb = krow && jb < a.S ? mask_at(a, 0, jb) : 0.f;
  unsigned ka[4][4], va[4][4];
  float dk[8][4], dv[8][4], sT[8][4], dT[8][4];
  zero8(dk);
  zero8(dv);
  for (int qt = 0; qt < nq; ++qt) {
    const int q0 = qt * TILE, buf = qt & 1;
    if (qt + 1 < nq) {
      const int nb = buf ^ 1;
      tc_load_tile(Qs + nb * TC_TILE_ELEMS, q, b, a.T, a.D, col, q0 + TILE);
      tc_load_tile(Gs + nb * TC_TILE_ELEMS, gg, b, a.T, a.D, col, q0 + TILE);
      cp_async_commit();
      load_stats(St + nb * TILE * 3, q0 + TILE);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (live) {
      if (qt == 0) {
        tc_frag_a(ka, Ks, j0, lane);
        tc_frag_a(va, Vs, j0, lane);
      }
      const bf16* Qb = Qs + buf * TC_TILE_ELEMS;
      const bf16* Gb = Gs + buf * TC_TILE_ELEMS;
      const float* Sb = St + buf * TILE * 3;
      const int nlive = a.T - q0;
      zero8(sT);
      zero8(dT);
      tc_dot_rows(sT, ka, Qb, nlive, lane);
      tc_dot_rows(dT, va, Gb, nlive, lane);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = nt * 8 + 2 * t4 + (e & 1), i = q0 + r;
          const int j = e < 2 ? ja : jb;
          float p = 0.f;
          if (i < a.T && j < a.S) {
            const float mv = krow ? (e < 2 ? mka : mkb) : mask_at(a, i, j);
            p = expf(sT[nt][e] * a.scale + mv - Sb[r * 3]) * Sb[r * 3 + 1];
          }
          sT[nt][e] = p;
          dT[nt][e] = p * (dT[nt][e] - Sb[r * 3 + 2]);   // ds^T
        }
      tc_split_mm(dv, sT, Gb, nlive, lane);
      tc_split_mm(dk, dT, Qb, nlive, lane);
    }
    __syncthreads();   // the buffers read here are refilled next iteration
  }
  if (!live) return;
  bf16* dko = (bf16*)a.dk;
  bf16* dvo = (bf16*)a.dv;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = h ? jb : ja;
    if (j >= a.S) continue;
    const size_t o = ((size_t)b * a.S + j) * a.D + col + 2 * t4;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      *reinterpret_cast<unsigned*>(dko + o + nt * 8) =
          pack_bf16(dk[nt][2 * h] * a.scale, dk[nt][2 * h + 1] * a.scale);
      *reinterpret_cast<unsigned*>(dvo + o + nt * 8) =
          pack_bf16(dv[nt][2 * h], dv[nt][2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Forward of bf16 inputs on tensor cores. q k^T multiplies the bf16 inputs
// (exact products, fp32 sums); e = exp(s - m) stays in fp32, and e @ v
// takes it as bf16 hi + lo (pack_split) in two MMAs into one fp32
// accumulator, so e is never rounded to bf16 (one rounding alone would
// leave the check's 1e-4 by 3x, tests/test_torch_flash_split.py). Each warp
// owns 16 query rows; the score accumulators of two neighbouring 8-key
// tiles are the A fragment of e @ v's next k16 step, so e never goes
// through shared memory. Scores are taken in base 2 (s * scale * log2(e)
// + mask * log2(e)), so exp2 gives exp(s - m) at one MUFU.EX2.
// ---------------------------------------------------------------------------
constexpr float FL_LOG2E = 1.4426950408889634f;
// Warps a block of the register road takes at most: the launcher splits the
// 16-row query groups of a (head, batch row) into the fewest blocks of at
// most FWD_WARPS warps, with equal warp counts (T = 197: 13 groups, 2 blocks
// of 7 warps). From a sweep at the prompted-LoRA shape (PERF.md): 4 warps
// 0.141 ms, 5 0.200, 7 0.138.
constexpr int FWD_WARPS = 7;
constexpr int FWD_MAX_THREADS = 256;

// cp.async.wait_group n for a count only known once a loop is unrolled
__device__ __forceinline__ void cp_async_wait_upto4(int n) {
  if (n <= 0) cp_async_wait<0>();
  else if (n == 1) cp_async_wait<1>();
  else if (n == 2) cp_async_wait<2>();
  else if (n == 3) cp_async_wait<3>();
  else cp_async_wait<4>();
}

// Register road, S <= 8 * MAXNT <= 256 keys: grid (blocks, H, B), one block
// per q_tile = 16 * warps query rows of one (head, batch row). The block
// loads its queries, all S keys (in 64-key commit groups, so the first
// q k^T products start when their chunk lands) and all S values into
// shared memory; each warp keeps its 16 rows' whole score rows in registers
// (MAXNT 8-key tiles), so q k^T runs once, K is read once, and the row max
// m over all S keys is final before any exponential: e = exp(s - m) is
// never rescaled, o = (e @ v) / sum(e) rounded once. A (S,) key-mask row
// (row stride 0) is staged in shared memory; a (T, S) matrix is read as the
// scores need it.
template <int MAXNT>
__global__ void __launch_bounds__(FWD_MAX_THREADS)
flash_fwd_tc_kernel(FlashArgs a, int q_tile) {
  constexpr int NCH = MAXNT / 8;   // 64-key chunks
  extern __shared__ __align__(16) unsigned char tsm[];
  const int sp = (a.S + 15) & ~15;                // keys held, zero past S
  bf16* Ks = reinterpret_cast<bf16*>(tsm);        // [key][dim]
  bf16* Vs = Ks + sp * TC_LD;                     // [key][dim]
  bf16* Qs = Vs + sp * TC_LD;                     // [query][dim]
  float* Ms = reinterpret_cast<float*>(Qs + q_tile * TC_LD);   // key-mask row
  const int nthr = blockDim.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, hd = blockIdx.y, col = hd * DH;
  const int q0 = blockIdx.x * q_tile, r0 = warp * 16;
  // commit groups, oldest first: the queries; one per 64-key chunk of K
  // (empty past S, so the count is fixed); all of V
  tc_load_rows(Qs, (const bf16*)a.q, b, a.T, a.D, col, q0, q_tile, nthr);
  cp_async_commit();
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    if (64 * c < sp)
      tc_load_rows(Ks + 64 * c * TC_LD, (const bf16*)a.k, b, a.S, a.D, col,
                   64 * c, min(64, sp - 64 * c), nthr);
    cp_async_commit();
  }
  tc_load_rows(Vs, (const bf16*)a.v, b, a.S, a.D, col, 0, sp, nthr);
  cp_async_commit();
  const bool krow = a.mask && a.mrs == 0;
  if (krow)
    for (int j = threadIdx.x; j < sp; j += nthr)
      Ms[j] = j < a.S ? a.mask[(long long)j * a.mcs] : 0.f;

  const bool live = q0 + r0 < a.T;   // warp-uniform
  const int ia = q0 + r0 + g, ib = ia + 8;
  unsigned qa[4][4];
  float s[MAXNT][4];
#pragma unroll
  for (int nt = 0; nt < MAXNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    cp_async_wait_upto4(NCH - c);   // the queries and chunks 0..c landed
    __syncthreads();
    if (live) {
      if (c == 0) tc_frag_a(qa, Qs, r0, lane);
      tc_dot_rows(s + 8 * c, qa, Ks + 64 * c * TC_LD, a.S - 64 * c, lane);
    }
  }

  float la = 0.f, lb = 0.f;
  if (live) {
    const float sl2 = a.scale * FL_LOG2E;
    float ma = -INFINITY, mb = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < MAXNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e < 2 ? ia : ib, j = nt * 8 + 2 * t4 + (e & 1);
        float x = -INFINITY;   // keys past S: e = 0
        if (j < a.S) {
          // rows past T (never stored) keep finite scores
          const float mv = krow ? Ms[j] : (i < a.T ? mask_at(a, i, j) : 0.f);
          x = fmaf(s[nt][e], sl2, FL_LOG2E * mv);
        }
        s[nt][e] = x;
        if (e < 2) ma = fmaxf(ma, x);
        else mb = fmaxf(mb, x);
      }
    ma = quad_max(ma);
    mb = quad_max(mb);
#pragma unroll
    for (int nt = 0; nt < MAXNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ev = exp2f(s[nt][e] - (e < 2 ? ma : mb));
        s[nt][e] = ev;
        if (e < 2) la += ev;
        else lb += ev;
      }
    la = quad_sum(la);
    lb = quad_sum(lb);
  }
  cp_async_wait<0>();   // V
  __syncthreads();
  if (!live) return;
  float o[8][4];
  zero8(o);
#pragma unroll
  for (int c = 0; c < NCH; ++c)
    tc_split_mm(o, s + 8 * c, Vs + 64 * c * TC_LD, a.S - 64 * c, lane);
  bf16* out = (bf16*)a.o;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = h ? ib : ia;
    if (i >= a.T) continue;
    const float l = h ? lb : la;
    bf16* row = out + ((size_t)b * a.T + i) * a.D + col;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<unsigned*>(row + nt * 8 + 2 * t4) =
          pack_bf16(o[nt][2 * h] / l, o[nt][2 * h + 1] / l);
  }
}

// Tiled road, S > 256 keys: grid (ceil(T/64), H, B), 4 warps of 16 query
// rows; K (and V in the second pass) stream through double-buffered 64-key
// cp.async tiles in two passes: the row max m over all S keys, then e =
// exp(s - m) with that final m, its row sum and e @ v. No key limit, and e
// is the register road's e.
__global__ void __launch_bounds__(TC_THREADS)
flash_fwd_tc_tiled_kernel(FlashArgs a) {
  extern __shared__ __align__(16) unsigned char tsm[];
  bf16* Qs = reinterpret_cast<bf16*>(tsm);   // [query][dim]
  bf16* Ks = Qs + TC_TILE_ELEMS;             // 2 x [key][dim]
  bf16* Vs = Ks + 2 * TC_TILE_ELEMS;         // 2 x [key][dim]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, hd = blockIdx.y, col = hd * DH;
  const int q0 = blockIdx.x * TILE, r0 = warp * 16;
  const bf16* k = (const bf16*)a.k;
  const bf16* v = (const bf16*)a.v;
  const int nk = (a.S + TILE - 1) / TILE, total = 2 * nk;
  tc_load_tile(Qs, (const bf16*)a.q, b, a.T, a.D, col, q0);
  tc_load_tile(Ks, k, b, a.S, a.D, col, 0);
  cp_async_commit();

  const bool live = q0 + r0 < a.T;   // warp-uniform
  const int ia = q0 + r0 + g, ib = ia + 8;
  const float sl2 = a.scale * FL_LOG2E;
  unsigned qa[4][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[8][4], s[8][4];
  zero8(o);
  for (int it = 0; it < total; ++it) {
    const int pass = it / nk, k0 = (it % nk) * TILE, buf = it & 1;
    if (it + 1 < total) {
      const int kn = ((it + 1) % nk) * TILE, nb = (it + 1) & 1;
      tc_load_tile(Ks + nb * TC_TILE_ELEMS, k, b, a.S, a.D, col, kn);
      if (it + 1 >= nk)
        tc_load_tile(Vs + nb * TC_TILE_ELEMS, v, b, a.S, a.D, col, kn);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (live) {
      if (it == 0) tc_frag_a(qa, Qs, r0, lane);
      const int nlive = a.S - k0;
      zero8(s);
      tc_dot_rows(s, qa, Ks + buf * TC_TILE_ELEMS, nlive, lane);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e < 2 ? ia : ib, j = k0 + nt * 8 + 2 * t4 + (e & 1);
          s[nt][e] = j < a.S ? fmaf(s[nt][e], sl2,
                                    FL_LOG2E * (i < a.T ? mask_at(a, i, j) : 0.f))
                             : -INFINITY;
        }
      if (pass == 0) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          m[0] = fmaxf(m[0], fmaxf(s[nt][0], s[nt][1]));
          m[1] = fmaxf(m[1], fmaxf(s[nt][2], s[nt][3]));
        }
        if (it == nk - 1) {
          m[0] = quad_max(m[0]);
          m[1] = quad_max(m[1]);
        }
      } else {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[nt][e] = exp2f(s[nt][e] - m[e >> 1]);
            l[e >> 1] += s[nt][e];
          }
        tc_split_mm(o, s, Vs + buf * TC_TILE_ELEMS, nlive, lane);
      }
    }
    __syncthreads();   // the buffers read here are refilled next iteration
  }
  if (!live) return;
  bf16* out = (bf16*)a.o;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = h ? ib : ia;
    const float lh = quad_sum(l[h]);
    if (i >= a.T) continue;
    bf16* row = out + ((size_t)b * a.T + i) * a.D + col;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      *reinterpret_cast<unsigned*>(row + nt * 8 + 2 * t4) =
          pack_bf16(o[nt][2 * h] / lh, o[nt][2 * h + 1] / lh);
  }
}

constexpr size_t FWD_SMEM = 4 * TILE_FLOATS * sizeof(float);
constexpr size_t DQ_SMEM = 6 * TILE_FLOATS * sizeof(float);
constexpr size_t DKV_SMEM = (6 * TILE_FLOATS + TILE * 3) * sizeof(float);
constexpr size_t TC_DQ_SMEM = 6 * TC_TILE_ELEMS * sizeof(bf16);
constexpr size_t TC_DKV_SMEM = 6 * TC_TILE_ELEMS * sizeof(bf16) + 2 * TILE * 3 * sizeof(float);
constexpr size_t TC_FWD_TILED_SMEM = 5 * TC_TILE_ELEMS * sizeof(bf16);

bool bad_shape(const FlashArgs& a) {
  return a.B < 1 || a.T < 1 || a.S < 1 || a.H < 1 || a.D != a.H * DH ||
         a.B > 65535 || a.H > 65535;
}

// fp32 inputs: the CUDA-core kernel (exact fp32 semantics would need a
// three-way bf16 split on tensor cores; only --no_bf16 feeds fp32).
int launch_fwd_f32(const FlashArgs& a, cudaStream_t s) {
  raise_smem(flash_fwd_kernel, FWD_SMEM);
  flash_fwd_kernel<<<dim3((a.T + TILE - 1) / TILE, a.H, a.B), NT, FWD_SMEM, s>>>(a);
  return (int)cudaGetLastError();
}

template <int MAXNT>
int launch_fwd_tc(const FlashArgs& a, cudaStream_t s) {
  const int groups = (a.T + 15) / 16;
  const int blocks = (groups + FWD_WARPS - 1) / FWD_WARPS;
  const int warps = (groups + blocks - 1) / blocks;
  const int sp = (a.S + 15) & ~15;
  const size_t smem = (size_t)(2 * sp + 16 * warps) * TC_LD * sizeof(bf16) +
                      (size_t)sp * sizeof(float);
  raise_smem(flash_fwd_tc_kernel<MAXNT>, smem);
  flash_fwd_tc_kernel<MAXNT><<<dim3(blocks, a.H, a.B), 32 * warps, smem, s>>>(
      a, 16 * warps);
  return (int)cudaGetLastError();
}

// bf16 inputs: the tensor-core kernels, the register road up to 256 keys
// (the smallest MAXNT that holds S), the tiled road above.
int launch_fwd_bf16(const FlashArgs& a, cudaStream_t s) {
  if (a.S <= 64) return launch_fwd_tc<8>(a, s);
  if (a.S <= 128) return launch_fwd_tc<16>(a, s);
  if (a.S <= 192) return launch_fwd_tc<24>(a, s);
  if (a.S <= 256) return launch_fwd_tc<32>(a, s);
  raise_smem(flash_fwd_tc_tiled_kernel, TC_FWD_TILED_SMEM);
  flash_fwd_tc_tiled_kernel<<<dim3((a.T + TILE - 1) / TILE, a.H, a.B),
                              TC_THREADS, TC_FWD_TILED_SMEM, s>>>(a);
  return (int)cudaGetLastError();
}

// fp32 inputs: the CUDA-core kernels (exact fp32 semantics would need a
// three-way bf16 split on tensor cores; no path on the card feeds fp32).
int launch_bwd_f32(const FlashArgs& a, cudaStream_t s) {
  raise_smem(flash_bwd_dq_kernel, DQ_SMEM);
  flash_bwd_dq_kernel<<<dim3((a.T + TILE - 1) / TILE, a.H, a.B), NT, DQ_SMEM, s>>>(a);
  int e = (int)cudaGetLastError();
  if (e) return e;
  raise_smem(flash_bwd_dkv_kernel, DKV_SMEM);
  flash_bwd_dkv_kernel<<<dim3((a.S + TILE - 1) / TILE, a.H, a.B), NT, DKV_SMEM, s>>>(a);
  return (int)cudaGetLastError();
}

// bf16 inputs: the tensor-core kernels.
int launch_bwd_bf16(const FlashArgs& a, cudaStream_t s) {
  raise_smem(flash_bwd_dq_tc_kernel, TC_DQ_SMEM);
  flash_bwd_dq_tc_kernel<<<dim3((a.T + TILE - 1) / TILE, a.H, a.B), TC_THREADS,
                           TC_DQ_SMEM, s>>>(a);
  int e = (int)cudaGetLastError();
  if (e) return e;
  raise_smem(flash_bwd_dkv_tc_kernel, TC_DKV_SMEM);
  flash_bwd_dkv_tc_kernel<<<dim3((a.S + TILE - 1) / TILE, a.H, a.B), TC_THREADS,
                            TC_DKV_SMEM, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface for ctypes. q (B*T, D), k and v (B*S, D), o (B*T, D), all of
// dtype dt and contiguous; head h is columns 64h .. 64h + 63. mask: null, or
// fp32 read at mask[i * mrs + j * mcs] for query i, key j. Every launcher
// returns cudaGetLastError() as an int, or cudaErrorInvalidValue for a shape
// it does not take (head dim other than 64).
// ---------------------------------------------------------------------------
extern "C" {

int llc_flash_fwd(int dt, const void* q, const void* k, const void* v,
                  const float* mask, long long mrs, long long mcs, void* o,
                  int B, int T, int S, int D, int H, float scale, void* stream) {
  FlashArgs a = {};
  a.q = q; a.k = k; a.v = v; a.mask = mask; a.mrs = mrs; a.mcs = mcs; a.o = o;
  a.B = B; a.T = T; a.S = S; a.D = D; a.H = H; a.scale = scale;
  if (bad_shape(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return dt == FL_BF16 ? launch_fwd_bf16(a, s) : launch_fwd_f32(a, s);
}

// g: the output grad (B*T, D); dq like q, dk and dv like k; stats: B*H*T*3
// floats of workspace.
int llc_flash_bwd(int dt, const void* q, const void* k, const void* v,
                  const void* g, const float* mask, long long mrs,
                  long long mcs, void* dq, void* dk, void* dv, float* stats,
                  int B, int T, int S, int D, int H, float scale, void* stream) {
  FlashArgs a = {};
  a.q = q; a.k = k; a.v = v; a.g = g; a.mask = mask; a.mrs = mrs; a.mcs = mcs;
  a.dq = dq; a.dk = dk; a.dv = dv; a.stats = stats;
  a.B = B; a.T = T; a.S = S; a.D = D; a.H = H; a.scale = scale;
  if (bad_shape(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return dt == FL_BF16 ? launch_bwd_bf16(a, s) : launch_bwd_f32(a, s);
}

}  // extern "C"
