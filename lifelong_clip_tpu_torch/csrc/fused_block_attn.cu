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
// Design of this first port (simple and right before fast):
//   * The TPU kernel kept h, qkv, scores and ctx in VMEM for one group of
//     batch rows. Here the op is a chain of kernels and those intermediates
//     (h16, qkv16, ctx16, dctx16, dqkv16, dh) go through device memory: about
//     (2 + 6 + 2) * M * D bytes extra per forward. Fusing them back into
//     one persistent kernel (TMA + wgmma, as the half block's FLOPs warrant)
//     is the first target of a later redesign.
//   * One bf16 tiled GEMM (mma.sync m16n8k16, fp32 accumulation, 3-stage
//     cp.async pipeline) serves every projection, with arbitrary strides (NN, NT and
//     TN layouts) and an epilogue for bias, the rank-r LoRA term
//     s * (z16 @ B) and the residual. The LoRA factor z = h @ A runs through
//     the same GEMM at N = r (a 64x16 tile) and is rounded to bf16, as
//     _kernel:76-84 and :117-126 round it. The prefix rows' keys and values
//     (pk @ W_k + b_k, pv @ W_v + b_v, bias added before the one bf16
//     rounding as _prefix_kernel:553-562) are two more launches of it into a
//     (B*P, 2D) buffer; the token qkv GEMM is unchanged.
//   * Attention forward: one block per (64-query tile, head, batch row) with
//     the head's K and V (S <= 256 rows) in shared memory; each warp keeps 16
//     whole score rows in registers (mma.sync m16n8k16), so the softmax is
//     the exact full-row one. Scores are bf16 q.k with fp32 accumulation,
//     times dh**-0.5, plus the additive mask; softmax in fp32; p rounded to
//     bf16 before p @ V. The prefix variant reads keys 0..P-1 from the prefix
//     buffer and keys P..P+T-1 from the token qkv, under a (T, P+T) mask.
//   * Attention backward: a dq kernel per query tile (recomputes p as the
//     forward, saves row max, row sum and rowsum(dp * p)) and a dk/dv kernel
//     per key tile that rebuilds p^T from those statistics and accumulates
//     over every query in registers. No atomics. The prefix variant writes
//     the prefix keys' dk/dv to a (B*P, 2D) buffer, from which two GEMMs
//     give dpk = dk16 @ W_k^T and dpv = dv16 @ W_v^T (_prefix_bwd_kernel:
//     843-852); the token rows fill dqkv16, so dh is the one dqkv16 @ W_qkv^T
//     GEMM (:854-857 up to summation order).
//   * Contractions over all B*T rows (LoRA grads, and the weight grads when
//     asked for) are TN GEMMs over the rows, split over K into fp32 partials
//     that a second pass sums in a fixed order. No atomics anywhere: results
//     do not depend on launch order, as the TPU kernel's sequential grid did
//     not.
//   * The ragged edge (T = 197 or 77, P = 20, not multiples of 16) is masked
//     in the kernels: padded keys get probability 0, padded queries are not
//     stored. A key the mask kills (-inf) gets p = 0 and dk = dv = 0 exactly:
//     the row max is taken after the mask is added, and the mask is only
//     ever added, never multiplied.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
// ---------------------------------------------------------------------------
constexpr int LN_THREADS = 256, LN_MAXK = 32;

template <typename T>
__global__ void __launch_bounds__(LN_THREADS)
ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, bf16* __restrict__ h, int M,
              int D, float eps) {
  const int lane = threadIdx.x & 31;
  const size_t row = (size_t)blockIdx.x * (LN_THREADS / 32) + (threadIdx.x >> 5);
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
    if (i < D) h[row * D + i] = __float2bfloat16((v[k] - mean) * rstd * gamma[i] + beta[i]);
  }
}

// ---------------------------------------------------------------------------
// LayerNorm backward plus the residual: dx = g + LN'(x)^T dh. Recomputes the
// statistics from x; one warp per row as the forward. With dhx != nullptr
// also writes dh * xhat (fp32) for the LN-scale grad.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(LN_THREADS)
ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ dh, const T* __restrict__ g,
              T* __restrict__ dx, float* __restrict__ dhx, int M, int D,
              float eps) {
  const int lane = threadIdx.x & 31;
  const size_t row = (size_t)blockIdx.x * (LN_THREADS / 32) + (threadIdx.x >> 5);
  if (row >= (size_t)M) return;
  const T* xr = x + row * D;
  const float* dhr = dh + row * D;
  float v[LN_MAXK], dxh[LN_MAXK];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < LN_MAXK; ++k) {
    const int i = lane + 32 * k;
    v[k] = i < D ? to_f(xr[i]) : 0.f;
    dxh[k] = i < D ? dhr[i] * gamma[i] : 0.f;
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
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int k = 0; k < LN_MAXK; ++k) {
    v[k] = (v[k] - mean) * rstd;   // xhat (unused past D)
    s1 += dxh[k];
    s2 += dxh[k] * v[k];
  }
  const float m1 = warp_sum(s1) / D;
  const float m2 = warp_sum(s2) / D;
#pragma unroll
  for (int k = 0; k < LN_MAXK; ++k) {
    const int i = lane + 32 * k;
    if (i >= D) continue;
    const float dxln = rstd * (dxh[k] - m1 - v[k] * m2);
    dx[row * D + i] = from_f<T>(to_f(g[row * D + i]) + dxln);
    if (dhx) dhx[row * D + i] = dhr[i] * v[k];
  }
}

// ---------------------------------------------------------------------------
// Small helpers: cast to bf16, deterministic column sums, split-K reduction.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void cast_bf16_kernel(const T* __restrict__ x, bf16* __restrict__ y,
                                 size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    y[i] = __float2bfloat16(to_f(x[i]));
}

// out[chunk, n] = sum of X[r, n] over the chunk's rows, in row order.
template <typename T>
__global__ void colsum_kernel(const T* __restrict__ X, int M, int N,
                              int rows_per_chunk, float* __restrict__ out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int r0 = blockIdx.y * rows_per_chunk;
  const int r1 = min(M, r0 + rows_per_chunk);
  float s = 0.f;
  for (int r = r0; r < r1; ++r) s += to_f(X[(size_t)r * N + n]);
  out[(size_t)blockIdx.y * N + n] = s;
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

// Tensor-core primitives: ldmatrix from shared memory and the m16n8k16 bf16
// MMA with fp32 accumulation. Fragment layout (g = lane / 4, t = lane % 4):
// A a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..);
// B b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g); C c0,c1 (g, 2t..2t+1),
// c2,c3 (g+8, 2t..2t+1).
__device__ __forceinline__ void ldsm_x4(unsigned* r, const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned* r, const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void mma16816(float* c, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (lower column)
  return *reinterpret_cast<unsigned*>(&v);
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
// With gridDim.z > 1 each z-slice covers k_per_split of K and writes raw fp32
// partials to out + z*M*N; splitk_reduce_kernel sums them in order.
//
// Tiles are BM x BN x 64 over 4 warps of mma.sync m16n8k16, fed by a 3-stage
// cp.async pipeline (16-byte copies along the operand's contiguous
// dimension; element loads when shapes or strides do not allow them). An
// operand whose contiguous dimension is M (A) or K (B) stays in that
// orientation in shared memory and is read with ldmatrix's transpose, so NT
// and TN load as fast as NN. Tile shapes: 128x128 (warp tile 64x64) in
// general, 64x16 when N <= 16 (the rank-r LoRA factors), 16x128 when
// M <= 16 (the LoRA-B grads).
// ---------------------------------------------------------------------------
constexpr int GBK = 64, GSTAGES = 3, GTHREADS = 128;

struct GemmArgs {
  int M, N, K, k_per_split;
  const bf16* A;
  long long sam, sak;
  const bf16* B;
  long long sbk, sbn;
  float alpha;
  const float* bias;
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
  int a_vec, b_vec, o_vec;
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;   // 0: no read, the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

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
                                            float v1, int m, int n) {
  if (m >= p.M || n >= p.N) return;
  const bool two = n + 1 < p.N;
  if (gridDim.z > 1) {
    float* ws = reinterpret_cast<float*>(p.out) +
                (size_t)blockIdx.z * p.M * p.N + (size_t)m * p.N + n;
    ws[0] = v0;
    if (two) ws[1] = v1;
    return;
  }
  OutT* o = reinterpret_cast<OutT*>(p.out) + (size_t)m * p.ldo + n;
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
  const int kbeg = blockIdx.z * p.k_per_split;
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

  // Epilogue in passes: every load (bias, LoRA factors, residual) goes into
  // the accumulators first, then every store. Interleaved, each load would
  // wait behind the store before it, which may alias it.
  const int g = lane >> 2, t4 = lane & 3;
  if (gridDim.z == 1) {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] *= p.alpha;
    if (p.bias) {
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int n = n0 + wn + j * 8 + 2 * t4;
        const float b0 = n < p.N ? p.bias[n] : 0.f;
        const float b1 = n + 1 < p.N ? p.bias[n + 1] : 0.f;
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          acc[i][j][0] += b0; acc[i][j][1] += b1;
          acc[i][j][2] += b0; acc[i][j][3] += b1;
        }
      }
    }
    // + lscale * z16 @ L, one rank at a time
    for (int r = 0; p.lz && r < p.R; ++r) {
      float zr[MI][2], lr[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + wm + i * 16 + g + 8 * h;
          zr[i][h] = m < p.M ? p.lscale * __bfloat162float(
              p.lz[(size_t)m * p.szm + (size_t)r * p.szr]) : 0.f;
        }
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn + j * 8 + 2 * t4 + e;
          lr[j][e] = n < p.N ? __bfloat162float(
              p.lb[(size_t)r * p.slr + (size_t)n * p.sln]) : 0.f;
        }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          acc[i][j][0] += zr[i][0] * lr[j][0];
          acc[i][j][1] += zr[i][0] * lr[j][1];
          acc[i][j][2] += zr[i][1] * lr[j][0];
          acc[i][j][3] += zr[i][1] * lr[j][1];
        }
    }
    if (p.resid) {
      const OutT* rr = reinterpret_cast<const OutT*>(p.resid);
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int m = m0 + wm + i * 16 + g + 8 * (e >> 1);
            const int n = n0 + wn + j * 8 + 2 * t4 + (e & 1);
            if (m < p.M && n < p.N)
              acc[i][j][e] = to_f(rr[(size_t)m * p.ldr + n]) + acc[i][j][e];
          }
    }
  }
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int m = m0 + wm + i * 16 + g, n = n0 + wn + j * 8 + 2 * t4;
      gemm_store2<OutT>(p, acc[i][j][0], acc[i][j][1], m, n);
      gemm_store2<OutT>(p, acc[i][j][2], acc[i][j][3], m + 8, n);
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

constexpr int FQT = 64;        // query rows per forward block
constexpr int FTHREADS = 128;

// The additive mask is null, a (T, S) matrix, or (ROW) one key-mask row of
// S values for every query (the KV-prefix slots' validity). A key-mask row
// is staged in shared memory once a block; the matrix is read from device
// memory as the scores need it. ROW is a template flag, so the kernels
// without it keep their registers for the score rows.
template <bool ROW>
__device__ __forceinline__ void stage_mask_row(float* Ms, const float* mask,
                                               int S, int Sp, int tid) {
  if constexpr (ROW)
    for (int j = tid; j < Sp; j += FTHREADS) Ms[j] = j < S ? mask[j] : 0.f;
}

template <bool ROW>
__device__ __forceinline__ float mask_at(const float* mask, const float* Ms,
                                         int i, int j, int S, int T) {
  if constexpr (ROW) return Ms[j];
  return mask && i < T ? mask[(size_t)i * S + j] : 0.f;
}

// ---------------------------------------------------------------------------
// Attention forward: ctx = softmax(q k^T * scale + mask) v per head.
// qkv (B*T, 3D) bf16, ctx (B*T, D) bf16. Grid (ceil(T/64), H, B), 4 warps;
// warp w owns query rows q0 + 16w .. +15 and keeps their whole score rows
// (S <= 256 keys) in registers, so the softmax is the exact full-row one:
// fp32 scores of bf16 q.k, times scale, plus the mask; p = exp(s - max) /
// sum; p rounded to bf16 as the A operand of p @ v. K, V and the query tile
// sit in shared memory (rows padded by 8 elements against bank conflicts).
// With PRE the keys and values are the P prefix rows of kvp followed by the
// T tokens (S = P + T) and the mask is (T, S); without, S = T. The row max
// is taken after the mask is added, so a dead key (-inf) gets p = 0 exactly.
// ---------------------------------------------------------------------------
template <int DH, int MAXNT, bool PRE, bool ROW>   // MAXNT: 8-key tiles a row holds
__global__ void __launch_bounds__(FTHREADS)
attn_fwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ kvp,
                const float* __restrict__ mask, bf16* __restrict__ ctx,
                int T, int P, int D, int Sp,
                float scale) {
  constexpr int LD = DH + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + Sp * LD;
  bf16* Qs = Vs + Sp * LD;
  float* Ms = reinterpret_cast<float*>(Qs + FQT * LD);   // a key-mask row

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, hd = blockIdx.y, q0 = blockIdx.x * FQT;
  const int S = P + T;
  const size_t rs = 3 * (size_t)D;
  const bf16* base = qkv + (size_t)b * T * rs;
  load_kv<PRE>(Ks, Vs, LD, qkv, kvp, b, T, P, D, hd * DH, 0, Sp, DH, tid,
               FTHREADS);
  load_tile(Qs, LD, base + (size_t)q0 * rs + hd * DH, rs, FQT, T - q0, DH,
            tid, FTHREADS);
  stage_mask_row<ROW>(Ms, mask, S, Sp, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int r0 = warp * 16;
  if (q0 + r0 >= T) return;   // no barrier follows

  unsigned qa[DH / 16][4];
#pragma unroll
  for (int kc = 0; kc < DH / 16; ++kc)
    ldsm_x4(qa[kc], Qs + (r0 + (lane & 15)) * LD + kc * 16 + (lane >> 4) * 8);

  const int nt_used = Sp / 8;
  float s[MAXNT][4];
#pragma unroll
  for (int nt = 0; nt < MAXNT; nt += 2) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = s[nt + 1][e] = 0.f;
    if (nt < nt_used) {
#pragma unroll
      for (int kc = 0; kc < DH / 16; ++kc) {
        unsigned kb[4];
        ldsm_x4(kb, Ks + (nt * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                        kc * 16 + ((lane >> 3) & 1) * 8);
        mma16816(s[nt], qa[kc], kb[0], kb[1]);
        mma16816(s[nt + 1], qa[kc], kb[2], kb[3]);
      }
    }
  }

  // scale, mask, full-row softmax (a row lives in the 4 lanes of a quad)
  const int ia = q0 + r0 + g, ib = ia + 8;
  float ma = -INFINITY, mb = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < MAXNT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = nt * 8 + 2 * t4 + e;
      float va = -INFINITY, vb = -INFINITY;
      if (nt < nt_used && j < S) {
        va = s[nt][e] * scale + mask_at<ROW>(mask, Ms, ia, j, S, T);
        vb = s[nt][2 + e] * scale + mask_at<ROW>(mask, Ms, ib, j, S, T);
      }
      s[nt][e] = va;
      s[nt][2 + e] = vb;
      ma = fmaxf(ma, va);
      mb = fmaxf(mb, vb);
    }
  }
  ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, 1));
  ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, 2));
  mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 1));
  mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 2));
  float la = 0.f, lb = 0.f;
#pragma unroll
  for (int nt = 0; nt < MAXNT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[nt][e] = expf(s[nt][e] - ma);
      s[nt][2 + e] = expf(s[nt][2 + e] - mb);
      la += s[nt][e];
      lb += s[nt][2 + e];
    }
  }
  la += __shfl_xor_sync(0xffffffffu, la, 1);
  la += __shfl_xor_sync(0xffffffffu, la, 2);
  lb += __shfl_xor_sync(0xffffffffu, lb, 1);
  lb += __shfl_xor_sync(0xffffffffu, lb, 2);

  // o = p16 @ v
  float o[DH / 8][4];
#pragma unroll
  for (int ct = 0; ct < DH / 8; ++ct)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[ct][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < MAXNT / 2; ++kc) {
    if (2 * kc < nt_used) {
      unsigned pa[4];
      pa[0] = pack_bf16(s[2 * kc][0] / la, s[2 * kc][1] / la);
      pa[1] = pack_bf16(s[2 * kc][2] / lb, s[2 * kc][3] / lb);
      pa[2] = pack_bf16(s[2 * kc + 1][0] / la, s[2 * kc + 1][1] / la);
      pa[3] = pack_bf16(s[2 * kc + 1][2] / lb, s[2 * kc + 1][3] / lb);
#pragma unroll
      for (int cp = 0; cp < DH / 16; ++cp) {
        unsigned vb[4];
        ldsm_x4_t(vb, Vs + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                          cp * 16 + (lane >> 4) * 8);
        mma16816(o[2 * cp], pa, vb[0], vb[1]);
        mma16816(o[2 * cp + 1], pa, vb[2], vb[3]);
      }
    }
  }
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
// Attention backward in two kernels, no atomics:
//   attn_bwd_dq_kernel   per (64-query tile, head, batch row): recompute the
//     full score rows and p exactly as the forward; dp = dctx v^T;
//     delta = rowsum(dp * p); ds = p * (dp - delta); dq = ds16 k * scale.
//     Saves the row max, row sum and delta of every query.
//   attn_bwd_dkv_kernel  per (64-key tile, head, batch row): recompute p^T
//     and dp^T for its keys against every query from those statistics;
//     dv = p16^T dctx, dk = ds16^T q * scale.
// Writes dqkv16 (B*T, 3D) bf16 and, when dqkv32 != nullptr, the fp32 values.
// With PRE, dk and dv of the P prefix keys go to dkvp16 (B*P, 2D: dK | dV)
// and, when dkvp32 != nullptr, its fp32 twin; a key tile may hold prefix and
// token keys both. A dead key (mask -inf) has p = 0, so ds = 0 and its dk
// and dv are exactly 0.
// ---------------------------------------------------------------------------
template <int DH, int MAXNT, bool PRE, bool ROW>
__global__ void __launch_bounds__(FTHREADS)
attn_bwd_dq_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ kvp,
                   const bf16* __restrict__ dctx,
                   const float* __restrict__ mask,
                   bf16* __restrict__ dqkv16, float* __restrict__ dqkv32,
                   float* __restrict__ stats, int T, int P, int D, int Sp,
                   float scale) {
  constexpr int LD = DH + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + Sp * LD;
  bf16* Qs = Vs + Sp * LD;
  bf16* dOs = Qs + FQT * LD;
  float* Ms = reinterpret_cast<float*>(dOs + FQT * LD);   // a key-mask row

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, hd = blockIdx.y, H = gridDim.y;
  const int q0 = blockIdx.x * FQT;
  const int S = P + T;
  const size_t rs = 3 * (size_t)D;
  const bf16* base = qkv + (size_t)b * T * rs;
  load_kv<PRE>(Ks, Vs, LD, qkv, kvp, b, T, P, D, hd * DH, 0, Sp, DH, tid,
               FTHREADS);
  load_tile(Qs, LD, base + (size_t)q0 * rs + hd * DH, rs, FQT, T - q0, DH,
            tid, FTHREADS);
  load_tile(dOs, LD, dctx + ((size_t)b * T + q0) * D + hd * DH, D, FQT,
            T - q0, DH, tid, FTHREADS);
  stage_mask_row<ROW>(Ms, mask, S, Sp, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int r0 = warp * 16;
  if (q0 + r0 >= T) return;   // no barrier follows

  unsigned qa[DH / 16][4], da[DH / 16][4];
#pragma unroll
  for (int kc = 0; kc < DH / 16; ++kc) {
    ldsm_x4(qa[kc], Qs + (r0 + (lane & 15)) * LD + kc * 16 + (lane >> 4) * 8);
    ldsm_x4(da[kc], dOs + (r0 + (lane & 15)) * LD + kc * 16 + (lane >> 4) * 8);
  }
  const int nt_used = Sp / 8;
  float s[MAXNT][4];
#pragma unroll
  for (int nt = 0; nt < MAXNT; nt += 2) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = s[nt + 1][e] = 0.f;
    if (nt < nt_used) {
#pragma unroll
      for (int kc = 0; kc < DH / 16; ++kc) {
        unsigned kb[4];
        ldsm_x4(kb, Ks + (nt * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                        kc * 16 + ((lane >> 3) & 1) * 8);
        mma16816(s[nt], qa[kc], kb[0], kb[1]);
        mma16816(s[nt + 1], qa[kc], kb[2], kb[3]);
      }
    }
  }
  const int ia = q0 + r0 + g, ib = ia + 8;
  float ma = -INFINITY, mb = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < MAXNT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = nt * 8 + 2 * t4 + e;
      float va = -INFINITY, vb = -INFINITY;
      if (nt < nt_used && j < S) {
        va = s[nt][e] * scale + mask_at<ROW>(mask, Ms, ia, j, S, T);
        vb = s[nt][2 + e] * scale + mask_at<ROW>(mask, Ms, ib, j, S, T);
      }
      s[nt][e] = va;
      s[nt][2 + e] = vb;
      ma = fmaxf(ma, va);
      mb = fmaxf(mb, vb);
    }
  }
  ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, 1));
  ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, 2));
  mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 1));
  mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 2));
  float la = 0.f, lb = 0.f;
#pragma unroll
  for (int nt = 0; nt < MAXNT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[nt][e] = expf(s[nt][e] - ma);
      s[nt][2 + e] = expf(s[nt][2 + e] - mb);
      la += s[nt][e];
      lb += s[nt][2 + e];
    }
  }
  la += __shfl_xor_sync(0xffffffffu, la, 1);
  la += __shfl_xor_sync(0xffffffffu, la, 2);
  lb += __shfl_xor_sync(0xffffffffu, lb, 1);
  lb += __shfl_xor_sync(0xffffffffu, lb, 2);
#pragma unroll
  for (int nt = 0; nt < MAXNT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[nt][e] = s[nt][e] / la;          // p, fp32
      s[nt][2 + e] = s[nt][2 + e] / lb;
    }
  }

  // pass 1: delta = rowsum(dp * p)
  float dla = 0.f, dlb = 0.f;
#pragma unroll
  for (int nt = 0; nt < MAXNT; nt += 2) {
    if (nt < nt_used) {
      float dp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kc = 0; kc < DH / 16; ++kc) {
        unsigned vb[4];
        ldsm_x4(vb, Vs + (nt * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                        kc * 16 + ((lane >> 3) & 1) * 8);
        mma16816(dp[0], da[kc], vb[0], vb[1]);
        mma16816(dp[1], da[kc], vb[2], vb[3]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        dla += dp[h][0] * s[nt + h][0] + dp[h][1] * s[nt + h][1];
        dlb += dp[h][2] * s[nt + h][2] + dp[h][3] * s[nt + h][3];
      }
    }
  }
  dla += __shfl_xor_sync(0xffffffffu, dla, 1);
  dla += __shfl_xor_sync(0xffffffffu, dla, 2);
  dlb += __shfl_xor_sync(0xffffffffu, dlb, 1);
  dlb += __shfl_xor_sync(0xffffffffu, dlb, 2);
  if (t4 == 0) {
    float* st = stats + ((size_t)b * H + hd) * T * 3;
    if (ia < T) { st[ia * 3] = ma; st[ia * 3 + 1] = la; st[ia * 3 + 2] = dla; }
    if (ib < T) { st[ib * 3] = mb; st[ib * 3 + 1] = lb; st[ib * 3 + 2] = dlb; }
  }

  // pass 2: ds = p * (dp - delta) in bf16; dq = ds16 @ k
  float dq[DH / 8][4];
#pragma unroll
  for (int ct = 0; ct < DH / 8; ++ct)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[ct][e] = 0.f;
#pragma unroll
  for (int nt = 0; nt < MAXNT; nt += 2) {
    if (nt < nt_used) {
      float dp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kc = 0; kc < DH / 16; ++kc) {
        unsigned vb[4];
        ldsm_x4(vb, Vs + (nt * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                        kc * 16 + ((lane >> 3) & 1) * 8);
        mma16816(dp[0], da[kc], vb[0], vb[1]);
        mma16816(dp[1], da[kc], vb[2], vb[3]);
      }
      unsigned pa[4];
      pa[0] = pack_bf16(s[nt][0] * (dp[0][0] - dla), s[nt][1] * (dp[0][1] - dla));
      pa[1] = pack_bf16(s[nt][2] * (dp[0][2] - dlb), s[nt][3] * (dp[0][3] - dlb));
      pa[2] = pack_bf16(s[nt + 1][0] * (dp[1][0] - dla), s[nt + 1][1] * (dp[1][1] - dla));
      pa[3] = pack_bf16(s[nt + 1][2] * (dp[1][2] - dlb), s[nt + 1][3] * (dp[1][3] - dlb));
#pragma unroll
      for (int cp = 0; cp < DH / 16; ++cp) {
        unsigned kb[4];
        ldsm_x4_t(kb, Ks + (nt * 8 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                          cp * 16 + (lane >> 4) * 8);
        mma16816(dq[2 * cp], pa, kb[0], kb[1]);
        mma16816(dq[2 * cp + 1], pa, kb[2], kb[3]);
      }
    }
  }
#pragma unroll
  for (int ct = 0; ct < DH / 8; ++ct) {
    const int c = hd * DH + ct * 8 + 2 * t4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = h ? ib : ia;
      if (i >= T) continue;
      const float v0 = dq[ct][2 * h] * scale, v1 = dq[ct][2 * h + 1] * scale;
      const size_t o = ((size_t)b * T + i) * rs + c;
      *reinterpret_cast<unsigned*>(dqkv16 + o) = pack_bf16(v0, v1);
      if (dqkv32) { dqkv32[o] = v0; dqkv32[o + 1] = v1; }
    }
  }
}

constexpr int KVT = 64;   // keys per dk/dv block

template <int DH, bool PRE, bool ROW>
__global__ void __launch_bounds__(FTHREADS)
attn_bwd_dkv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ kvp,
                    const bf16* __restrict__ dctx,
                    const float* __restrict__ mask,
                    bf16* __restrict__ dqkv16,
                    float* __restrict__ dqkv32, bf16* __restrict__ dkvp16,
                    float* __restrict__ dkvp32, const float* __restrict__ stats,
                    int T, int P, int D, int Tp, float scale) {
  constexpr int LD = DH + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);     // this block's keys
  bf16* Vs = Ks + KVT * LD;
  bf16* Qs = Vs + KVT * LD;                      // every query
  bf16* dOs = Qs + Tp * LD;
  float* st = reinterpret_cast<float*>(dOs + Tp * LD);   // Tp x (m, l, delta)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.z, hd = blockIdx.y, H = gridDim.y;
  const int k0 = blockIdx.x * KVT;
  const int S = P + T;
  const size_t rs = 3 * (size_t)D;
  const bf16* base = qkv + (size_t)b * T * rs;
  load_kv<PRE>(Ks, Vs, LD, qkv, kvp, b, T, P, D, hd * DH, k0, KVT, DH, tid,
               FTHREADS);
  load_tile(Qs, LD, base + hd * DH, rs, Tp, T, DH, tid, FTHREADS);
  load_tile(dOs, LD, dctx + (size_t)b * T * D + hd * DH, D, Tp, T, DH, tid,
            FTHREADS);
  const float* gst = stats + ((size_t)b * H + hd) * T * 3;
  for (int i = tid; i < Tp * 3; i += FTHREADS)
    st[i] = i < T * 3 ? gst[i] : (i % 3 == 1 ? 1.f : 0.f);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int j0 = warp * 16;
  if (k0 + j0 >= S) return;   // no barrier follows

  unsigned ka[DH / 16][4], va[DH / 16][4];
#pragma unroll
  for (int kc = 0; kc < DH / 16; ++kc) {
    ldsm_x4(ka[kc], Ks + (j0 + (lane & 15)) * LD + kc * 16 + (lane >> 4) * 8);
    ldsm_x4(va[kc], Vs + (j0 + (lane & 15)) * LD + kc * 16 + (lane >> 4) * 8);
  }
  float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
  for (int ct = 0; ct < DH / 8; ++ct)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[ct][e] = dv[ct][e] = 0.f;

  const int ja = k0 + j0 + g, jb = ja + 8;     // this lane's two keys
  // a key-mask row is the same for every query: read it once
  const float mka = ROW && ja < S ? mask[ja] : 0.f;
  const float mkb = ROW && jb < S ? mask[jb] : 0.f;
  for (int qb = 0; qb < Tp; qb += 16) {        // 16 queries at a time
    float sT[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    float dpT[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kc = 0; kc < DH / 16; ++kc) {
      unsigned qb4[4], db4[4];
      ldsm_x4(qb4, Qs + (qb + (lane & 7) + ((lane >> 4) << 3)) * LD + kc * 16 +
                       ((lane >> 3) & 1) * 8);
      ldsm_x4(db4, dOs + (qb + (lane & 7) + ((lane >> 4) << 3)) * LD + kc * 16 +
                        ((lane >> 3) & 1) * 8);
      mma16816(sT[0], ka[kc], qb4[0], qb4[1]);
      mma16816(sT[1], ka[kc], qb4[2], qb4[3]);
      mma16816(dpT[0], va[kc], db4[0], db4[1]);
      mma16816(dpT[1], va[kc], db4[2], db4[3]);
    }
    // p^T and ds^T for keys (ja, jb) x queries qb + 8h + 2t4 + e
    float p[2][4], ds[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = qb + 8 * h + 2 * t4 + e;
        const float m = st[i * 3], l = st[i * 3 + 1], dl = st[i * 3 + 2];
#pragma unroll
        for (int w = 0; w < 2; ++w) {          // w = 0: key ja, 1: key jb
          const int j = w ? jb : ja;
          float pv = 0.f;
          if (i < T && j < S) {
            const float mv = ROW ? (w ? mkb : mka)
                                 : (mask ? mask[(size_t)i * S + j] : 0.f);
            const float sv = sT[h][2 * w + e] * scale + mv;
            pv = expf(sv - m) / l;
          }
          p[h][2 * w + e] = pv;
          ds[h][2 * w + e] = pv * (dpT[h][2 * w + e] - dl);
        }
      }
    }
    unsigned pa[4], sa[4];
    pa[0] = pack_bf16(p[0][0], p[0][1]);
    pa[1] = pack_bf16(p[0][2], p[0][3]);
    pa[2] = pack_bf16(p[1][0], p[1][1]);
    pa[3] = pack_bf16(p[1][2], p[1][3]);
    sa[0] = pack_bf16(ds[0][0], ds[0][1]);
    sa[1] = pack_bf16(ds[0][2], ds[0][3]);
    sa[2] = pack_bf16(ds[1][0], ds[1][1]);
    sa[3] = pack_bf16(ds[1][2], ds[1][3]);
#pragma unroll
    for (int cp = 0; cp < DH / 16; ++cp) {
      unsigned ob[4], qt[4];
      ldsm_x4_t(ob, dOs + (qb + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                        cp * 16 + (lane >> 4) * 8);
      ldsm_x4_t(qt, Qs + (qb + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                        cp * 16 + (lane >> 4) * 8);
      mma16816(dv[2 * cp], pa, ob[0], ob[1]);
      mma16816(dv[2 * cp + 1], pa, ob[2], ob[3]);
      mma16816(dk[2 * cp], sa, qt[0], qt[1]);
      mma16816(dk[2 * cp + 1], sa, qt[2], qt[3]);
    }
  }
#pragma unroll
  for (int ct = 0; ct < DH / 8; ++ct) {
    const int c = hd * DH + ct * 8 + 2 * t4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = h ? jb : ja;
      if (j >= S) continue;
      const float k0v = dk[ct][2 * h] * scale, k1v = dk[ct][2 * h + 1] * scale;
      const float v0 = dv[ct][2 * h], v1 = dv[ct][2 * h + 1];
      bf16* o16;
      float* o32;
      size_t o;
      if (PRE && j < P) {   // a prefix key: (B*P, 2D), dK at 0, dV at D
        o = ((size_t)b * P + j) * 2 * D + c;
        o16 = dkvp16;
        o32 = dkvp32;
      } else {              // a token key: (B*T, 3D), dK at D, dV at 2D
        o = ((size_t)b * T + j - P) * rs + D + c;
        o16 = dqkv16;
        o32 = dqkv32;
      }
      *reinterpret_cast<unsigned*>(o16 + o) = pack_bf16(k0v, k1v);
      *reinterpret_cast<unsigned*>(o16 + o + D) = pack_bf16(v0, v1);
      if (o32) {
        o32[o] = k0v; o32[o + 1] = k1v;
        o32[o + D] = v0; o32[o + D + 1] = v1;
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

// K, V and the query tile (and dO), plus the key-mask row with ROW
static size_t attn_fwd_smem(int Sp, int dh, bool row) {
  return (size_t)(2 * Sp + FQT) * (dh + 8) * sizeof(bf16) +
         (row ? (size_t)Sp * sizeof(float) : 0);
}

static size_t attn_bwd_dq_smem(int Sp, int dh, bool row) {
  return (size_t)(2 * Sp + 2 * FQT) * (dh + 8) * sizeof(bf16) +
         (row ? (size_t)Sp * sizeof(float) : 0);
}

static size_t attn_bwd_dkv_smem(int Tp, int dh) {
  return (size_t)(2 * KVT + 2 * Tp) * (dh + 8) * sizeof(bf16) +
         (size_t)Tp * 3 * sizeof(float);
}

// Shared arguments of the attention launches. Without a prefix P = 0 and
// kvp, dkvp16 and dkvp32 are null.
struct AttnArgs {
  const bf16* qkv;
  const bf16* kvp;
  const bf16* dctx;
  const float* mask;
  bf16* ctx;
  bf16* dqkv16;
  float* dqkv32;
  bf16* dkvp16;
  float* dkvp32;
  float* stats;
  int B, T, P, D, H;
  float scale;
};

template <int DH, int MAXNT, bool PRE, bool ROW>
static int launch_attn_fwd_nt(const AttnArgs& a, cudaStream_t s) {
  const int Sp = (a.P + a.T + 15) / 16 * 16;
  const size_t smem = attn_fwd_smem(Sp, DH, ROW);
  cudaFuncSetAttribute(attn_fwd_kernel<DH, MAXNT, PRE, ROW>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid((a.T + FQT - 1) / FQT, a.H, a.B);
  attn_fwd_kernel<DH, MAXNT, PRE, ROW><<<grid, FTHREADS, smem, s>>>(
      a.qkv, a.kvp, a.mask, a.ctx, a.T, a.P, a.D, Sp, a.scale);
  return (int)cudaGetLastError();
}

template <int DH, int MAXNT, bool PRE, bool ROW>
static int launch_attn_bwd_nt(const AttnArgs& a, cudaStream_t s) {
  const int Sp = (a.P + a.T + 15) / 16 * 16, Tp = (a.T + 15) / 16 * 16;
  size_t smem = attn_bwd_dq_smem(Sp, DH, ROW);
  cudaFuncSetAttribute(attn_bwd_dq_kernel<DH, MAXNT, PRE, ROW>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  attn_bwd_dq_kernel<DH, MAXNT, PRE, ROW>
      <<<dim3((a.T + FQT - 1) / FQT, a.H, a.B), FTHREADS, smem, s>>>(
          a.qkv, a.kvp, a.dctx, a.mask, a.dqkv16, a.dqkv32, a.stats, a.T,
          a.P, a.D, Sp, a.scale);
  int e = (int)cudaGetLastError();
  if (e) return e;
  smem = attn_bwd_dkv_smem(Tp, DH);
  cudaFuncSetAttribute(attn_bwd_dkv_kernel<DH, PRE, ROW>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  attn_bwd_dkv_kernel<DH, PRE, ROW>
      <<<dim3((a.P + a.T + KVT - 1) / KVT, a.H, a.B), FTHREADS, smem, s>>>(
          a.qkv, a.kvp, a.dctx, a.mask, a.dqkv16, a.dqkv32, a.dkvp16,
          a.dkvp32, a.stats, a.T, a.P, a.D, Tp, a.scale);
  return (int)cudaGetLastError();
}

// Dispatch on head dim and on the padded key count (<= 128 or <= 256 keys a
// score row); S = P + T > 256 is refused. ROW: a key-mask row (mask_rs 0).
template <bool BWD, bool PRE, bool ROW>
static int launch_attn(const AttnArgs& a, cudaStream_t s) {
  const int Sp = (a.P + a.T + 15) / 16 * 16;
  if (Sp > 256 || a.H <= 0 || a.D % a.H) return (int)cudaErrorInvalidValue;
  const bool wide = Sp > 128;
#define LLC_ATTN(DHV)                                                        \
  if constexpr (BWD)                                                         \
    return wide ? launch_attn_bwd_nt<DHV, 32, PRE, ROW>(a, s)                \
                : launch_attn_bwd_nt<DHV, 16, PRE, ROW>(a, s);               \
  return wide ? launch_attn_fwd_nt<DHV, 32, PRE, ROW>(a, s)                  \
              : launch_attn_fwd_nt<DHV, 16, PRE, ROW>(a, s);
  switch (a.D / a.H) {
    case 16: { LLC_ATTN(16) }
    case 32: { LLC_ATTN(32) }
    case 64: { LLC_ATTN(64) }
    default: return (int)cudaErrorInvalidValue;
  }
#undef LLC_ATTN
}

template <typename OutT, int WM, int WN, int MI, int NI, bool AT, bool BT>
static int launch_gemm_tile(const GemmArgs& p, int splits, cudaStream_t s) {
  constexpr int BM = WM * MI * 16, BN = WN * NI * 8;
  using TL = GemmTile<BM, BN, AT, BT>;
  auto kern = gemm_kernel<OutT, WM, WN, MI, NI, AT, BT>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)TL::SMEM);
  dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, splits);
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

// Tile shape by problem shape: 64x16 for N <= 16, 16x128 for M <= 16,
// 128x128 otherwise.
template <typename OutT>
static int launch_gemm(const GemmArgs& p, bool at, bool bt, int splits,
                       cudaStream_t s) {
  if (p.N <= 16) return launch_gemm_layout<OutT, 4, 1, 1, 2>(p, at, bt, splits, s);
  if (p.M <= 16) return launch_gemm_layout<OutT, 1, 4, 1, 4>(p, at, bt, splits, s);
  return launch_gemm_layout<OutT, 2, 2, 4, 8>(p, at, bt, splits, s);
}

extern "C" {

const char* llc_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

static int ln_blocks(int M) { return (M + LN_THREADS / 32 - 1) / (LN_THREADS / 32); }

int llc_ln_fwd(int dt, const void* x, const float* gamma, const float* beta,
               void* h, int M, int D, float eps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D > 32 * LN_MAXK) return (int)cudaErrorInvalidValue;
  if (dt == DT_BF16)
    ln_fwd_kernel<bf16><<<ln_blocks(M), LN_THREADS, 0, s>>>((const bf16*)x, gamma, beta, (bf16*)h, M, D, eps);
  else
    ln_fwd_kernel<float><<<ln_blocks(M), LN_THREADS, 0, s>>>((const float*)x, gamma, beta, (bf16*)h, M, D, eps);
  return (int)cudaGetLastError();
}

int llc_ln_bwd(int dt, const void* x, const float* gamma, const float* dh,
               const void* g, void* dx, float* dhx, int M, int D, float eps,
               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D > 32 * LN_MAXK) return (int)cudaErrorInvalidValue;
  if (dt == DT_BF16)
    ln_bwd_kernel<bf16><<<ln_blocks(M), LN_THREADS, 0, s>>>((const bf16*)x, gamma, dh, (const bf16*)g,
                                                            (bf16*)dx, dhx, M, D, eps);
  else
    ln_bwd_kernel<float><<<ln_blocks(M), LN_THREADS, 0, s>>>((const float*)x, gamma, dh, (const float*)g,
                                                             (float*)dx, dhx, M, D, eps);
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

// out (N,) fp32 = column sums of X (M, N); ws holds ceil(M/128) * N floats.
int llc_colsum(int dt, const void* X, int M, int N, float* ws, float* out,
               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int rpc = 128, chunks = (M + rpc - 1) / rpc;
  dim3 grid((N + 255) / 256, chunks);
  if (dt == DT_BF16)
    colsum_kernel<bf16><<<grid, 256, 0, s>>>((const bf16*)X, M, N, rpc, ws);
  else
    colsum_kernel<float><<<grid, 256, 0, s>>>((const float*)X, M, N, rpc, ws);
  int e = (int)cudaGetLastError();
  if (e) return e;
  colsum_kernel<float><<<dim3((N + 255) / 256, 1), 256, 0, s>>>(ws, chunks, N, chunks, out);
  return (int)cudaGetLastError();
}

// out_dt selects the output type (and the residual's). splits > 1 needs
// out_dt == DT_F32, no bias/LoRA/residual, and ws of splits * M * N floats.
int llc_gemm(int out_dt, int M, int N, int K, const void* A, long long sam,
             long long sak, const void* B, long long sbk, long long sbn,
             float alpha, const float* bias, const void* lz, long long szm,
             long long szr, const void* lb, long long slr, long long sln, int R,
             float lscale, const void* resid, long long ldr, void* out,
             long long ldo, int splits, float* ws, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  GemmArgs p;
  p.M = M; p.N = N; p.K = K;
  p.A = (const bf16*)A; p.sam = sam; p.sak = sak;
  p.B = (const bf16*)B; p.sbk = sbk; p.sbn = sbn;
  p.alpha = alpha; p.bias = bias;
  p.lz = (const bf16*)lz; p.szm = szm; p.szr = szr;
  p.lb = (const bf16*)lb; p.slr = slr; p.sln = sln; p.R = R; p.lscale = lscale;
  p.resid = resid; p.ldr = ldr; p.out = out; p.ldo = ldo;
  // operand orientation in shared memory follows its contiguous dimension
  const bool at = sam == 1 && sak != 1;
  const bool bt = sbk == 1 && sbn != 1;
  p.a_vec = ((uintptr_t)A % 16) == 0 &&
      (at ? (sak % 8 == 0 && M % 8 == 0) : (sak == 1 && sam % 8 == 0 && K % 8 == 0));
  p.b_vec = ((uintptr_t)B % 16) == 0 &&
      (bt ? (sbn % 8 == 0 && K % 8 == 0) : (sbn == 1 && sbk % 8 == 0 && N % 8 == 0));
  p.o_vec = ((uintptr_t)out % 8) == 0 && ldo % 2 == 0;
  if (splits < 1) splits = 1;
  int kps = (K + splits - 1) / splits;
  kps = (kps + GBK - 1) / GBK * GBK;
  splits = (K + kps - 1) / kps;
  p.k_per_split = kps;
  if (splits > 1) {
    if (out_dt != DT_F32 || bias || lz || resid || !ws) return (int)cudaErrorInvalidValue;
    p.out = ws;
    int e = launch_gemm<float>(p, at, bt, splits, s);
    if (e) return e;
    const size_t mn = (size_t)M * N;
    splitk_reduce_kernel<<<grid_for(mn), 256, 0, s>>>(ws, splits, mn, alpha, (float*)out);
    return (int)cudaGetLastError();
  }
  if (out_dt == DT_BF16) return launch_gemm<bf16>(p, at, bt, 1, s);
  return launch_gemm<float>(p, at, bt, 1, s);
}

int llc_attn_fwd(const void* qkv, const float* mask, void* ctx, int B, int T,
                 int D, int H, float scale, void* stream) {
  AttnArgs a = {};
  a.qkv = (const bf16*)qkv; a.mask = mask; a.ctx = (bf16*)ctx;
  a.B = B; a.T = T; a.P = 0; a.D = D; a.H = H; a.scale = scale;
  return launch_attn<false, false, false>(a, (cudaStream_t)stream);
}

// stats: B * H * T * 3 floats of workspace (row max, row sum, delta).
int llc_attn_bwd(const void* qkv, const void* dctx, const float* mask,
                 void* dqkv16, float* dqkv32, float* stats, int B, int T,
                 int D, int H, float scale, void* stream) {
  AttnArgs a = {};
  a.qkv = (const bf16*)qkv; a.dctx = (const bf16*)dctx; a.mask = mask;
  a.dqkv16 = (bf16*)dqkv16; a.dqkv32 = dqkv32; a.stats = stats;
  a.B = B; a.T = T; a.P = 0; a.D = D; a.H = H; a.scale = scale;
  return launch_attn<true, false, false>(a, (cudaStream_t)stream);
}

// KV-prefix attention: kvp (B*P, 2D) holds the projected prefix keys and
// values (K | V); mask is null, (T, P + T) fp32 with mask_rs = P + T, or one
// (P + T,) key-mask row for every query with mask_rs = 0.
int llc_attn_prefix_fwd(const void* qkv, const void* kvp, const float* mask,
                        int mask_rs, void* ctx, int B, int T, int P, int D,
                        int H, float scale, void* stream) {
  if (P < 1 || (mask_rs && mask_rs != P + T)) return (int)cudaErrorInvalidValue;
  AttnArgs a = {};
  a.qkv = (const bf16*)qkv; a.kvp = (const bf16*)kvp; a.mask = mask;
  a.ctx = (bf16*)ctx;
  a.B = B; a.T = T; a.P = P; a.D = D; a.H = H; a.scale = scale;
  return mask && !mask_rs
      ? launch_attn<false, true, true>(a, (cudaStream_t)stream)
      : launch_attn<false, true, false>(a, (cudaStream_t)stream);
}

// dkvp16 (B*P, 2D) receives dK | dV of the prefix keys (dkvp32: the fp32
// values, or null), dqkv16 those of the tokens as llc_attn_bwd.
int llc_attn_prefix_bwd(const void* qkv, const void* kvp, const void* dctx,
                        const float* mask, int mask_rs, void* dqkv16,
                        float* dqkv32, void* dkvp16, float* dkvp32,
                        float* stats, int B, int T, int P, int D, int H,
                        float scale, void* stream) {
  if (P < 1 || (mask_rs && mask_rs != P + T)) return (int)cudaErrorInvalidValue;
  AttnArgs a = {};
  a.qkv = (const bf16*)qkv; a.kvp = (const bf16*)kvp;
  a.dctx = (const bf16*)dctx; a.mask = mask;
  a.dqkv16 = (bf16*)dqkv16; a.dqkv32 = dqkv32;
  a.dkvp16 = (bf16*)dkvp16; a.dkvp32 = dkvp32; a.stats = stats;
  a.B = B; a.T = T; a.P = P; a.D = D; a.H = H; a.scale = scale;
  return mask && !mask_rs
      ? launch_attn<true, true, true>(a, (cudaStream_t)stream)
      : launch_attn<true, true, false>(a, (cudaStream_t)stream);
}

}  // extern "C"
