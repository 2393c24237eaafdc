// Read-only fixed-point certificate of a banded field for Hopper (sm_90a).
//
// Replaces: mesh_navigation_tpu/ops/pallas_banded.py::_check_kernel (:2310),
// launched by _check_pallas_padded (:2352) from check_converged_banded
// (:2429) -- the converge="check" loop of the warm resolve (:1992-2028).
//
// What it computes. For every element (r, c, b) of d[Rp, Cp, Bp] (f32 or
// bf16, lanes contiguous; a bf16 label is widened to f32 and all is computed
// in f32): best = min over the 8 banded in-edge classes k of
// src_k + w8[r, k, c], with sources in class order (r,c-1), (r,c+1),
// (r-1,c-1), (r-1,c), (r-1,c+1), (r+1,c-1), (r+1,c), (r+1,c+1). Columns
// outside the row read +inf; rows outside the field are clamped to the edge
// row, as the Pallas halo BlockSpecs clamp them (:2386-2392). It sets
// viol = 1 if any element has best*(1+rtol)+atol < cur, and writes nothing
// else. An element whose cur and best are both +inf is not flagged
// (inf < inf is false).
//
// What bounds it on this card. One read of the field plus the 8 weight
// planes: 537 MB + 33.5 MB at the replan shape 1024 x 1024 x 128, about
// 0.17 ms at 3.35 TB/s (half the field's bytes in bf16). About 19 operations per element are far below the
// f32 rate: bound by bytes.
//
// What the design does about it. There is no row order, so the grid is
// parallel over (column x 4-lane group, block of RB rows). A thread owns
// one column and 4 lanes (one float4, neighbouring threads on neighbouring
// lanes) and walks its block's rows keeping the rows above, at and below in
// registers: each row step loads one new row (its own float4 and the two
// neighbouring columns', which other threads of the block read too and L1
// serves), so device memory sees the field about (1 + 2/RB) times. The flag
// is reduced per block with __syncthreads_or and set with one atomicOr on
// an int the wrapper zeroes. The tolerance arithmetic uses
// __fmul_rn/__fadd_rn, so no multiply-add is fused and the flag equals the
// plain PyTorch version's on the same field.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#define RB 16

namespace {

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// 4 bf16 lanes widened to f32 (a bf16 is the top half of its f32: exact)
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ float get(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// columns c-1, c, c+1 of one row at the thread's 4 lanes (+inf off the row)
template <typename T>
__device__ __forceinline__ void load_row(const T* p, int Bp, bool has_l,
                                         bool has_r, float4 (&o)[3]) {
  const float4 inf4 = make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F,
                                  CUDART_INF_F);
  o[0] = has_l ? ld4(p - Bp) : inf4;
  o[1] = ld4(p);
  o[2] = has_r ? ld4(p + Bp) : inf4;
}

template <typename T>
__global__ void __launch_bounds__(256) check_kernel(
    const T* __restrict__ d, const float* __restrict__ w8,
    int* __restrict__ viol, int Rp, int Cp, int Bp, float k_rtol,
    float atol) {
  const int q4 = Bp / 4;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int bad = 0;
  if (e < (long long)Cp * q4) {
    const int c = (int)(e / q4);
    const int q = (int)(e % q4);
    const long long rs = (long long)Cp * Bp;
    const T* base = d + (long long)c * Bp + 4 * q;
    const bool has_l = c > 0, has_r = c + 1 < Cp;
    const int r0 = blockIdx.y * RB;
    const int r1 = min(r0 + RB, Rp);
    float4 up[3], mid[3], dn[3];
    load_row(base + (long long)max(r0 - 1, 0) * rs, Bp, has_l, has_r, up);
    load_row(base + (long long)r0 * rs, Bp, has_l, has_r, mid);
    for (int r = r0; r < r1; ++r) {
      load_row(base + (long long)min(r + 1, Rp - 1) * rs, Bp, has_l, has_r, dn);
      float w[8];
      #pragma unroll
      for (int k = 0; k < 8; ++k) w[k] = w8[((long long)r * 8 + k) * Cp + c];
      #pragma unroll
      for (int i = 0; i < 4; ++i) {
        float best = get(mid[0], i) + w[0];
        best = fminf(best, get(mid[2], i) + w[1]);
        best = fminf(best, get(up[0], i) + w[2]);
        best = fminf(best, get(up[1], i) + w[3]);
        best = fminf(best, get(up[2], i) + w[4]);
        best = fminf(best, get(dn[0], i) + w[5]);
        best = fminf(best, get(dn[1], i) + w[6]);
        best = fminf(best, get(dn[2], i) + w[7]);
        bad |= __fadd_rn(__fmul_rn(best, k_rtol), atol) < get(mid[1], i);
      }
      #pragma unroll
      for (int k = 0; k < 3; ++k) {
        up[k] = mid[k];
        mid[k] = dn[k];
      }
    }
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) atomicOr(viol, 1);
}

}  // namespace

// `d` is f32, or bf16 where `bf16_field` is set.
extern "C" int check_launch(const void* d, int bf16_field, const float* w8, int* viol,
                            int Rp, int Cp, int Bp, float k_rtol, float atol,
                            void* stream) {
  const int n_rb = (Rp + RB - 1) / RB;
  if (Bp % 4 != 0 || Rp < 1 || Cp < 1 || n_rb > 65535)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)Cp * (Bp / 4);
  const int threads = 256;
  const dim3 grid((unsigned)((n + threads - 1) / threads), (unsigned)n_rb);
  if (bf16_field)
    check_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const __nv_bfloat16*>(d), w8, viol, Rp, Cp, Bp, k_rtol, atol);
  else
    check_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float*>(d), w8, viol, Rp, Cp, Bp, k_rtol, atol);
  return (int)cudaGetLastError();
}
