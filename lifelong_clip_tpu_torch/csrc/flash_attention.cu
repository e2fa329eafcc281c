// Hand-written Hopper (sm_90a) kernels for attention on projected q, k, v:
// o = softmax(q k^T * scale + mask) v per head, forward and backward, all in
// fp32 arithmetic whatever the input type.
//
// Replaces the Pallas TPU kernels of lifelong_clip_tpu/ops/flash_attention.py:
//   * _attn_kernel     (:32, pallas_call at :96)  -> flash_fwd_kernel
//   * _attn_bwd_kernel (:128, pallas_call at :191) -> flash_bwd_dq_kernel and
//     flash_bwd_dkv_kernel
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
// T = 197, S = 217, dh = 64, bf16): forward ~8.4 GFLOP and ~81 MB (memory,
// ~0.024 ms against 3.35 TB/s), backward ~21 GFLOP and ~143 MB (~0.043 ms);
// chip_smoke.py computes both. These kernels run their products on the fp32
// CUDA cores (67 TFLOP/s), whose ceiling for the forward's 8.4 GFLOP is
// ~0.13 ms; the two-pass softmax below adds one more q k^T product.
//
// Design of this first port (simple and right before fast):
//   * Every product is an fp32 FMA on the upcast operands. q k^T of bf16
//     inputs is exact product by product and accumulates in fp32, as the TPU
//     kernel's; e @ v keeps e in fp32 (no bf16 rounding of p anywhere). What
//     differs from the TPU kernel is the order of the fp32 sums only. fp32
//     inputs take the same road.
//   * No key limit. Keys are tiled 64 at a time through shared memory, and
//     the softmax takes two passes over them: the first finds the row max,
//     the second computes e = exp(s - m) with that final max, its row sum
//     and e @ v, and divides once at the end, as the TPU kernel does. No
//     online rescaling, so e is the TPU kernel's e.
//   * One block per (64-query tile, head, batch row), 256 threads; thread
//     (ty, tx) of a 16 x 16 grid owns rows 4ty .. 4ty + 3 and columns
//     4tx .. 4tx + 3 of every 64 x 64 tile. Every tile product reads its
//     operands from shared memory 16 bytes at a time, one load for eight
//     FMAs: the left operand row-major (a half warp shares its rows, so its
//     loads broadcast), the right one with its output columns contiguous.
//     So K, and V where the product contracts over the head dim, sit
//     transposed in shared memory, as do p and ds where the product
//     contracts over queries. Row pitch 68 floats keeps rows 16-byte
//     aligned.
//   * The backward splits as the fused block's attention backward does
//     (fused_block_attn.cu), with no atomics: a dq kernel per
//     query tile takes three passes over the keys (row max; row sum and
//     sum(dp * e); then ds and dq) and saves the row max, row sum and
//     delta = rowsum(dp * p); a dk/dv kernel per key tile walks every query
//     tile and rebuilds p from those statistics. Every output element is
//     written once by one thread, so the backward is bitwise repeatable.
//   * The additive mask is read through a pointer and two element strides:
//     a (T, S) matrix, one (S,) key row for every query (row stride 0), or
//     anything the wrapper broadcasts to (T, S) without copying. Null: no
//     mask. A key the mask kills (-inf) gets e = 0, so dk = dv = 0 exactly.
//   * Ragged edges: keys past S get e = 0, queries past T are not stored.
//   * Head dim 64 only (every tower the repository has); the launcher
//     refuses any other.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// Four consecutive elements from device memory, upcast; 16 (fp32) or 8
// (bf16) bytes aligned.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <typename T>
__device__ __forceinline__ void store4(T* p, float a, float b, float c,
                                       float d) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
  } else {
    __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);   // round to nearest even
    __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
    uint2 u;
    u.x = *reinterpret_cast<unsigned*>(&lo);
    u.y = *reinterpret_cast<unsigned*>(&hi);
    *reinterpret_cast<uint2*>(p) = u;
  }
}

// Rows row0 .. row0 + 63 of one head (columns col .. col + 63) of a (B*L, D)
// tensor of batch row b, upcast to fp32, into a 64 x LDS tile, row-major
// ([row][dim]) or, with TRANS, transposed ([dim][row]); rows at or past L
// are zero.
template <bool TRANS, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int b,
                                          int L, int D, int col, int row0) {
  const T* base = src + ((size_t)b * L) * D + col;
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
template <typename T>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(FlashArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // [query][dim]
  float* Kt = Qs + TILE_FLOATS;     // [dim][key]
  float* Vs = Kt + TILE_FLOATS;     // [key][dim]
  float* Es = Vs + TILE_FLOATS;     // [query][key]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.z, col = blockIdx.y * DH, q0 = blockIdx.x * TILE;
  const T* k = (const T*)a.k;
  const T* v = (const T*)a.v;
  load_tile<false>(Qs, (const T*)a.q, b, a.T, a.D, col, q0);

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
  T* o = (T*)a.o;
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
template <typename T>
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
  const T* k = (const T*)a.k;
  const T* v = (const T*)a.v;
  load_tile<false>(Qs, (const T*)a.q, b, a.T, a.D, col, q0);
  load_tile<false>(Gs, (const T*)a.g, b, a.T, a.D, col, q0);

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
  T* dq = (T*)a.dq;
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
template <typename T>
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
  const T* q = (const T*)a.q;
  const T* g = (const T*)a.g;
  const float* gst = a.stats + ((size_t)b * a.H + hd) * a.T * 3;
  load_tile<true>(Kt, (const T*)a.k, b, a.S, a.D, col, k0);
  load_tile<true>(Vt, (const T*)a.v, b, a.S, a.D, col, k0);

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
  T* dko = (T*)a.dk;
  T* dvo = (T*)a.dv;
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

constexpr size_t FWD_SMEM = 4 * TILE_FLOATS * sizeof(float);
constexpr size_t DQ_SMEM = 6 * TILE_FLOATS * sizeof(float);
constexpr size_t DKV_SMEM = (6 * TILE_FLOATS + TILE * 3) * sizeof(float);

bool bad_shape(const FlashArgs& a) {
  return a.B < 1 || a.T < 1 || a.S < 1 || a.H < 1 || a.D != a.H * DH ||
         a.B > 65535 || a.H > 65535;
}

template <typename T>
int launch_fwd(const FlashArgs& a, cudaStream_t s) {
  cudaFuncSetAttribute(flash_fwd_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)FWD_SMEM);
  flash_fwd_kernel<T><<<dim3((a.T + TILE - 1) / TILE, a.H, a.B), NT, FWD_SMEM, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const FlashArgs& a, cudaStream_t s) {
  cudaFuncSetAttribute(flash_bwd_dq_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DQ_SMEM);
  flash_bwd_dq_kernel<T><<<dim3((a.T + TILE - 1) / TILE, a.H, a.B), NT, DQ_SMEM, s>>>(a);
  int e = (int)cudaGetLastError();
  if (e) return e;
  cudaFuncSetAttribute(flash_bwd_dkv_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DKV_SMEM);
  flash_bwd_dkv_kernel<T><<<dim3((a.S + TILE - 1) / TILE, a.H, a.B), NT, DKV_SMEM, s>>>(a);
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
  return dt == FL_BF16 ? launch_fwd<bf16>(a, s) : launch_fwd<float>(a, s);
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
  return dt == FL_BF16 ? launch_bwd<bf16>(a, s) : launch_bwd<float>(a, s);
}

}  // extern "C"
