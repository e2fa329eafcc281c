// Tensor-core and copy primitives shared by fused_block_attn.cu and
// flash_attention.cu: ldmatrix from shared memory, the m16n8k16 bf16 MMA
// with fp32 accumulation, bf16 packing (once, or split into hi + lo parts),
// 16-byte cp.async copies; and, on the host, the launchers' shared-memory
// limit.
//
// Fragment layout of mma.sync m16n8k16 (g = lane / 4, t = lane % 4):
// A a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..);
// B b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g); C c0,c1 (g, 2t..2t+1),
// c2,c3 (g+8, 2t..2t+1). The C fragments of two neighbouring n8 tiles are
// the A fragment of one k16 step, so a product's output feeds the next
// product from registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <mutex>
#include <unordered_map>

// Raise a kernel's dynamic shared-memory limit only when a launch needs more
// than every launch before it: cudaFuncSetAttribute is a runtime call, and a
// chain launches the same kernels every step. The limit set so far is kept
// per kernel, as launchers of different shapes may share one kernel.
template <typename Kernel>
static inline void raise_smem(Kernel kern, size_t bytes) {
  static std::mutex mu;
  static std::unordered_map<const void*, int> set;
  std::lock_guard<std::mutex> lock(mu);
  int& cur = set[reinterpret_cast<const void*>(kern)];
  if ((int)bytes > cur &&
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes) == cudaSuccess)
    cur = (int)bytes;
}

static __device__ __forceinline__ void ldsm_x4(unsigned* r, const __nv_bfloat16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

static __device__ __forceinline__ void ldsm_x4_t(unsigned* r, const __nv_bfloat16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

static __device__ __forceinline__ void mma16816(float* c, const unsigned* a,
                                                unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

static __device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (lower column)
  return *reinterpret_cast<unsigned*>(&v);
}

// x = hi + lo + r with hi = bf16(x), lo = bf16(x - hi) (x - hi is exact in
// fp32) and |r| <= 2**-16 |x| (two roundings to 8 significant bits): an fp32
// operand as two bf16 A fragments whose products, summed in one fp32
// accumulator, keep ~16 bits of it.
static __device__ __forceinline__ void pack_split(float x0, float x1,
                                                  unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

static __device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                                  bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;   // 0: no read, the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
static __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
