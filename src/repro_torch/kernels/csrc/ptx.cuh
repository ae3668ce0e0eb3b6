// Hopper (sm_90a) building blocks shared by the hand-written kernels:
// cp.async copies into shared memory, ldmatrix operand loads, the bf16
// mma.sync m16n8k16 and the TF32 m16n8k8 tensor-core products with the
// 3xTF32 split of an f32 operand, the head-dim bound of an attention
// instance, the dynamic-shared-memory opt-in of a kernel instance, and the
// arrival counter of the split kernels.
//
// Split kernels (matmul.cu's and conv2d.cu's split-K, split_decode.cuh's
// split-KV) finish in the launch that computed the partials: every CTA of
// an output unit writes its f32 partial to a workspace, then `arrive_last`
// counts it in on the unit's int32 counter; the CTA that arrives last reads the
// partials back in split order 0..S-1 (so the same inputs give the same
// bits on every run: no float atomics) and resets the counter to 0, so the
// counter buffer is zeroed once when it is allocated and never again.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace ptx {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `ok == false` writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0));
}
// 4 bytes global -> shared (one f32, for gathers whose rows are not
// 16-byte pieces); `ok == false` writes zeros and reads nothing
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c += a (16 x 16, row) . b (16 x 8, col), bf16 operands, f32 accumulators
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32: x = hi + lo with both halves TF32 (hi = x rounded to 10 explicit
// mantissa bits, lo = the rest rounded the same way), so that
// hi·hi + hi·lo + lo·hi carries an f32 product to about f32 accuracy on
// the tensor cores (lo·lo, ~2^-22 relative, is dropped)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// c += a (16 x 8, row) . b (8 x 8, col), TF32 operands, f32 accumulators
__device__ __forceinline__ void mma1688_tf32(float (&c)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of bf16 (lo in the low half), round to nearest
// even, as Pallas's astype
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The head-dim bound of the attention instance that runs head dim d: 64,
// 128 or 256 (dims past d are zeros in shared memory).
__host__ __device__ constexpr int dmax_of(int d) { return d <= 64 ? 64 : d <= 128 ? 128 : 256; }

// Allow kernel instance K `max_bytes` of dynamic shared memory: its largest
// layout, so the attribute is set on the instance's first launch and again
// only on a launch from another device, not on every launch.
template <auto K>
inline cudaError_t allow_smem(size_t max_bytes) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto set = [max_bytes] {
    return cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)max_bytes);
  };
  static const std::pair<int, cudaError_t> first{dev, set()};
  return dev == first.first ? first.second : set();
}

// Count this CTA in on `counter` once every thread has written its share
// of the CTA's partial; true, in every thread, for the CTA that arrives
// last of `expected`, which then sees every partial (read them with
// __ldcg, past the non-coherent L1).  The last CTA resets the counter:
// every other CTA of the unit has arrived, so none touches it again in
// this launch.  `flag`: one int of shared memory.
__device__ __forceinline__ bool arrive_last(int* counter, int expected, int* flag) {
  __threadfence();                 // this thread's partial is visible
  __syncthreads();                 // ... and every other thread's
  if (threadIdx.x == 0) {
    const bool last = atomicAdd(counter, 1) == expected - 1;
    if (last) *counter = 0;
    *flag = last;
  }
  __syncthreads();
  const bool last = *flag != 0;
  if (last) __threadfence();       // the other CTAs' partials, before reading
  return last;
}

}  // namespace ptx
