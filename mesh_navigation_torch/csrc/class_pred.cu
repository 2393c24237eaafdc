// int8 class predecessor and fixed-point certificate for Hopper (sm_90a).
//
// Replaces: mesh_navigation_tpu/ops/pallas_banded.py::_pred_kernel (:2177),
// launched by _predecessors_pallas_padded (:2255) with as_class=True and
// check=(atol, rtol) -- the converge="pred" certificate that ends the solve
// loop (:1953-1990) and emits the predecessor table.
//
// What it computes. For every element (r, c, b) of the converged field
// d[Rp, Cp, Bp]: best = min over the 8 banded in-edge classes k of
// src_k + w8[r, k, c], taken with strict < in class order 0..7
// (sources (r,c-1), (r,c+1), (r-1,c-1), (r-1,c), (r-1,c+1), (r+1,c-1),
// (r+1,c), (r+1,c+1); columns outside the row read +inf, rows outside the
// field are clamped to the edge row as the Pallas halo blocks are). It
// writes class k, or 8 (= self) unless best <= cur*(1+tol)+tol & cur > 0 &
// cur finite, into out[V, Bp] (the [:R, :C] trim is done by the store), and
// ORs the violation flag best*(1+rtol)+atol < cur into one int.
//
// What bounds it on this card. One read of the f32 field and one write of
// the int8 table: 4.3 GB + 1.07 GB at the main path's 1M x 1024, about 1.6 ms
// at 3.35 TB/s. About 30 flops per element are far below the f32 rate:
// bound by bytes.
//
// What the design does about it. One thread per (column, 4 lanes): the
// centre row is read as float4 (16 bytes a thread, neighbouring threads on
// neighbouring lanes); the 8 neighbour reads hit the same or an adjacent row
// and are served mostly from L1/L2, so device memory sees the field about
// once. The table is stored as char4. The flag is reduced per block with
// __syncthreads_or and set with one atomicOr. The tolerance arithmetic uses
// __fmul_rn/__fadd_rn so no multiply-add is fused and the table matches the
// plain PyTorch version bit for bit.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float get(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

__global__ void __launch_bounds__(256) class_pred_kernel(
    const float* __restrict__ d, const float* __restrict__ w8,
    int8_t* __restrict__ out, int* __restrict__ viol,
    int R, int C, int Rp, int Cp, int Bp, int V,
    float k_tol, float tol, float k_rtol, float atol) {
  const int q4 = Bp / 4;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  int bad = 0;
  if (e < (long long)Cp * q4) {
    const int c = (int)(e / q4);
    const int q = (int)(e % q4);
    const long long rs = (long long)Cp * Bp;
    const int ru = r > 0 ? r - 1 : 0;
    const int rd = r + 1 < Rp ? r + 1 : Rp - 1;
    const float* row = d + r * rs + 4 * q;
    const float* up = d + ru * rs + 4 * q;
    const float* dn = d + rd * rs + 4 * q;
    const float4 inf4 = make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, CUDART_INF_F);
    const bool has_l = c > 0, has_r = c + 1 < Cp;
    const long long cc = (long long)c * Bp;
    float4 src[8];
    src[0] = has_l ? ld4(row + cc - Bp) : inf4;
    src[1] = has_r ? ld4(row + cc + Bp) : inf4;
    src[2] = has_l ? ld4(up + cc - Bp) : inf4;
    src[3] = ld4(up + cc);
    src[4] = has_r ? ld4(up + cc + Bp) : inf4;
    src[5] = has_l ? ld4(dn + cc - Bp) : inf4;
    src[6] = ld4(dn + cc);
    src[7] = has_r ? ld4(dn + cc + Bp) : inf4;
    const float4 cur4 = ld4(row + cc);
    float w[8];
    #pragma unroll
    for (int k = 0; k < 8; ++k) w[k] = w8[((long long)r * 8 + k) * Cp + c];
    char4 cls;
    int8_t* cp = reinterpret_cast<int8_t*>(&cls);
    #pragma unroll
    for (int i = 0; i < 4; ++i) {
      float best = CUDART_INF_F;
      int rel = 0;
      #pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float cand = get(src[k], i) + w[k];
        if (cand < best) { best = cand; rel = k; }
      }
      const float cur = get(cur4, i);
      const bool has = best <= __fadd_rn(__fmul_rn(cur, k_tol), tol)
                       && cur > 0.f && cur < CUDART_INF_F;
      bad |= __fadd_rn(__fmul_rn(best, k_rtol), atol) < cur;
      cp[i] = (int8_t)(has ? rel : 8);
    }
    const long long v = (long long)r * C + c;
    if (r < R && c < C && v < V)
      *reinterpret_cast<char4*>(out + v * Bp + 4 * q) = cls;
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) atomicOr(viol, 1);
}

}  // namespace

extern "C" int class_pred_launch(
    const float* d, const float* w8, int8_t* out, int* viol,
    int R, int C, int Rp, int Cp, int Bp, int V,
    float k_tol, float tol, float k_rtol, float atol, void* stream) {
  // one grid row per field row: gridDim.y is at most 65535
  if (Bp % 4 != 0 || Rp < 1 || Rp > 65535 || Cp < 1) return (int)cudaErrorInvalidValue;
  const long long n = (long long)Cp * (Bp / 4);
  const int threads = 256;
  const dim3 grid((unsigned)((n + threads - 1) / threads), (unsigned)Rp);
  class_pred_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      d, w8, out, viol, R, C, Rp, Cp, Bp, V, k_tol, tol, k_rtol, atol);
  return (int)cudaGetLastError();
}
