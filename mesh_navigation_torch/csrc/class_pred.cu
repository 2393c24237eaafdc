// Class predecessors, real-id predecessors and the fixed-point certificate
// of a banded field, for Hopper (sm_90a).
//
// Replaces: mesh_navigation_tpu/ops/pallas_banded.py::_pred_kernel (:2177),
// launched by _predecessors_pallas_padded (:2255) in both of its modes:
// as_class=True with check=(atol, rtol) -- the converge="pred" certificate
// that ends the solve loop (:1953-1990) and emits the int8 class table --
// and as_class=False, the int32 real-id table of predecessors_banded_pallas
// (:2463) behind the full banded plan result.
//
// What it computes. For every element (r, c, b) of the field d[Rp, Cp, Bp]
// (f32, or bf16 widened to f32 as it is read from shared memory; everything
// is computed in f32):
// best = min over the 8 banded in-edge classes k of src_k + w8[r, k, c],
// taken with strict < in class order 0..7 (sources (r,c-1), (r,c+1),
// (r-1,c-1), (r-1,c), (r-1,c+1), (r+1,c-1), (r+1,c), (r+1,c+1); columns
// outside the row read +inf, rows outside the field are clamped to the edge
// row as the Pallas halo blocks are). The predecessor exists when
// best <= cur*(1+tol)+tol & cur > 0 & cur finite. AS_CLASS writes class k,
// or 8 (= self), as int8; !AS_CLASS writes the real id r*C + c + off[k]
// (off = -1, +1, -C-1, -C, -C+1, C-1, C, C+1), or r*C + c, as int32. Both
// go to out[V, Bp] (the [:R, :C] trim is done by the store). With a flag
// pointer (CHECK) it also ORs best*(1+rtol)+atol < cur over every element.
//
// What bounds it on this card. One read of the f32 field and one write of
// the table: 4.3 GB + 1.07 GB (int8) or + 4.3 GB (int32) at the main path's
// 1M x 1024, about 1.6 or 2.6 ms at 3.35 TB/s. The issue rate comes close
// behind: the argmin is an add, a compare and two selects per class and
// lane, about 40 instructions an element with the tolerance tests, so
// 1.07 G elements need about 1.3 G warp instructions, ~1.3 ms at the card's
// full issue rate. A design that spends as many instructions again on
// addressing is bound by issue, not by bytes.
//
// What the design does about it. A block of 128 threads owns a 2-D tile: a
// lane group of LT threads (LT = 8 wherever Bp > 32, else 4) of 8 lanes
// each (two float4, VEC) across a strip of 128 / LT columns, and walks a
// run of RUN rows. Each row of the tile, with one halo column on each side,
// and the row's 8 weights of each column are copied by cp.async into a ring
// of shared-memory slots, DEPTH steps ahead; rows r-1, r and r+1, the
// lateral neighbours c-1 and c+1 and the weights are then read from shared
// memory. So device memory sees the field about (1 + 2/RUN) times, and L2
// about (1 + 2/RUN) * (1 + 2/strip) times, where one thread per (column, 4
// lanes) with nothing shared read it about nine times through L2. Blocks of
// one tile's lane groups are neighbours in the grid, so they share the
// tile's weights in L2. The work per element is kept to the argmin and the
// tolerance tests: copy sources are computed once per thread, halo columns
// off the row are written +inf once, LT is a template parameter so shared
// reads take immediate offsets, a step computes two rows, and a thread's
// two float4 share its weights, copies, wait and barrier. The table is
// stored as char4 or int4 (neighbouring threads on neighbouring lanes). The
// flag is reduced per block with __syncthreads_or and set with one
// atomicOr. The tolerance arithmetic uses __fmul_rn/__fadd_rn so no
// multiply-add is fused, and the table and flag match the plain PyTorch
// version bit for bit.
//
// A bf16 field moves as 8-byte pieces of 4 lanes into a ring of half the
// bytes; the layout and the schedule are the f32 ones.
//
// Ring discipline. Row position p of a run (p = 0 is the row above it) goes
// to slot p % SLOTS. Step t computes rows r0 + 2t and r0 + 2t + 1 from
// positions 2t .. 2t+3 and first issues the copies of positions 2t+DEPTH+2
// and 2t+DEPTH+3, into the slots of positions 2t-4 and 2t-3 (SLOTS =
// DEPTH + 6). A thread issuing at step t has passed step t-1's barrier, so
// every thread has finished step t-2, the last step that reads those
// positions: the slots are free. One barrier every two rows. The ring
// (45 KB) is dynamic shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define THREADS 128
#define VEC 2                                  // float4 a thread: 8 lanes
#define DEPTH 2
#define SLOTS (DEPTH + 6)
#define MAX_LT 8
#define SLOT_F4 ((THREADS + 2 * MAX_LT) * VEC)  // (SC + 2) columns x LT x VEC
#define MAX_SC (THREADS / 4)                  // the strip at LT = 4
#define SLOT_W4 (2 * MAX_SC)                   // a slot's weights, float4
// bytes of the ring of a field whose 4 lanes take `u` bytes
#define SMEM_BYTES(u) (SLOTS * (SLOT_F4 * (u) + SLOT_W4 * 16))
#define RUN 64                                 // rows a block walks

namespace {

// cp.async of 16 or 4 bytes to a shared-space address, issued when `on`
__device__ __forceinline__ void cp_async16(unsigned smem, const void* gmem, int on) {
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n"
               " @p cp.async.cg.shared.global [%0], [%1], 16;\n}\n"
               ::"r"(smem), "l"(gmem), "r"(on));
}

__device__ __forceinline__ void cp_async4(unsigned smem, const void* gmem, int on) {
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n"
               " @p cp.async.ca.shared.global [%0], [%1], 4;\n}\n"
               ::"r"(smem), "l"(gmem), "r"(on));
}

__device__ __forceinline__ void cp_async8(unsigned smem, const void* gmem, int on) {
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n"
               " @p cp.async.ca.shared.global [%0], [%1], 8;\n}\n"
               ::"r"(smem), "l"(gmem), "r"(on));
}

// 4 lanes of the field as they lie in shared memory: a float4, or 4 bf16
template <typename T> struct Unit { typedef float4 type; };
template <> struct Unit<__nv_bfloat16> { typedef uint2 type; };

__device__ __forceinline__ float4 widen(const float4& v) { return v; }
__device__ __forceinline__ float4 widen(const uint2& u) {
  // a bf16 is the top half of its f32: widening is exact
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ void inf_unit(float4& v) {
  v = make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, CUDART_INF_F);
}
__device__ __forceinline__ void inf_unit(uint2& u) { u = make_uint2(0x7f807f80u, 0x7f807f80u); }

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_depth() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(DEPTH));
}

__device__ __forceinline__ float get(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// 4 lanes of one row: rows r-1, r, r+1 at columns c-1, c, c+1 (`up`, `mid`,
// `dn` point at column c-1 of the lanes in their slots; `cs` float4 from a
// column to the next) and the row's 8 weights.
template <bool AS_CLASS, bool CHECK, int cs, typename U>
__device__ __forceinline__ void pred_lanes(
    const U* up, const U* mid, const U* dn, const float (&w)[8],
    int self, int C, float k_tol, float tol, float k_rtol, float atol, int& bad,
    int (&res)[4]) {
  const U* src[8] = {mid, mid + 2 * cs, up, up + cs, up + 2 * cs, dn, dn + cs, dn + 2 * cs};
  float best[4] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
  int rel[4] = {0, 0, 0, 0};
  #pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float4 sk = widen(*src[k]);
    #pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float cand = get(sk, i) + w[k];
      const bool t = cand < best[i];
      rel[i] = t ? k : rel[i];
      best[i] = t ? cand : best[i];
      // keep the class a register select: left free, the compiler saves
      // the 32 compare predicates and rebuilds it at the end
      asm volatile("" : "+r"(rel[i]));
    }
  }
  const float4 cur4 = widen(mid[cs]);
  #pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float cur = get(cur4, i);
    const bool has = best[i] <= __fadd_rn(__fmul_rn(cur, k_tol), tol)
                     && cur > 0.f && cur < CUDART_INF_F;
    if (CHECK) bad |= __fadd_rn(__fmul_rn(best[i], k_rtol), atol) < cur;
    const int k = has ? rel[i] : 8;
    // off_real of class k: -1, +1, -C-1, -C, -C+1, C-1, C, C+1; 0 for 8
    res[i] = AS_CLASS ? k
             : self + (k < 2 ? 2 * k - 1 : (k < 5 ? k - 3 - C : (k < 8 ? k - 6 + C : 0)));
  }
}

template <bool AS_CLASS>
__device__ __forceinline__ void store_lanes(void* p, const int (&res)[4]) {
  if (AS_CLASS)
    *reinterpret_cast<char4*>(p) = make_char4((char)res[0], (char)res[1], (char)res[2],
                                              (char)res[3]);
  else
    *reinterpret_cast<int4*>(p) = make_int4(res[0], res[1], res[2], res[3]);
}

template <typename T, bool AS_CLASS, bool CHECK, int LT>
__global__ void __launch_bounds__(THREADS) class_pred_kernel(
    const T* __restrict__ d, const float* __restrict__ w8,
    void* __restrict__ out, int* __restrict__ viol,
    int R, int C, int Rp, int Cp, int Bp, int V,
    int n_lg, int n_strips, float k_tol, float tol, float k_rtol, float atol) {
  typedef typename Unit<T>::type U;
  constexpr int UB = (int)sizeof(U);           // bytes of 4 lanes
  extern __shared__ float4 smem[];
  U* const ring = reinterpret_cast<U*>(smem);  // [SLOTS][SLOT_F4] field rows
  // [SLOTS][SLOT_W4] weights, [column][8]
  float4* const wring = reinterpret_cast<float4*>(reinterpret_cast<char*>(smem) +
                                                  SLOTS * SLOT_F4 * UB);
  constexpr int G = LT * VEC;                  // float4 of a column in a slot
  constexpr int SC = THREADS / LT;             // columns of the strip
  const int q4 = Bp >> 2;
  // blockIdx.x = (run, strip, lane group), the lane group fastest
  unsigned b = blockIdx.x;
  const int lg = (int)(b % (unsigned)n_lg);
  b /= (unsigned)n_lg;
  const int c0 = (int)(b % (unsigned)n_strips) * SC;
  const int r0 = (int)(b / (unsigned)n_strips) * RUN;
  const int r1 = min(r0 + RUN, Rp);
  const int lq = threadIdx.x % LT;
  const int j = threadIdx.x / LT;
  const int c = c0 + j;
  // the thread's float4 v holds lanes 4 * (lg * G + v * LT + lq) ..
  const int q0 = lg * G + lq;
  const bool act0 = q0 < q4 && c < Cp, act1 = q0 + LT < q4 && c < Cp;
  const long long rs = (long long)Cp * Bp;
  const int n_pos = r1 - r0 + 2;               // rows r0-1 .. r1, clamped

  // A slot holds (SC + 2) * G float4, columns c0-1 .. c0+SC of the lane
  // group as [column][VEC][LT], and the row's 8 * SC weights as
  // [column][class]. Thread t copies elements t, t + THREADS, t + 2 THREADS
  // of each; halo columns off the row are +inf in every row, written once
  // here. Columns past Cp and lanes past Bp are never read.
  const int n_elem = (SC + 2) * G;
  U inf_u;
  inf_unit(inf_u);
  const unsigned ring_s = (unsigned)__cvta_generic_to_shared(ring);
  const unsigned wring_s = (unsigned)__cvta_generic_to_shared(wring);
  const char* f_src[3];                        // row 0's source of each copy
  const char* w_src[2];
  int f_on[3], w_on[2];
  #pragma unroll
  for (int h = 0; h < 3; ++h) {
    const int x = threadIdx.x + h * THREADS;
    const int gc = c0 - 1 + x / G;
    const int gq = lg * G + x % G;
    const bool on_row = gc >= 0 && gc < Cp;
    f_on[h] = x < n_elem && on_row && gq < q4;
    f_src[h] = reinterpret_cast<const char*>(d + (f_on[h] ? (long long)gc * Bp + 4 * gq : 0));
    if (x < n_elem && !on_row) {
      #pragma unroll
      for (int sl = 0; sl < SLOTS; ++sl) ring[sl * SLOT_F4 + x] = inf_u;
    }
  }
  #pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int x = threadIdx.x + h * THREADS;
    w_on[h] = x < 8 * SC && c0 + (x >> 3) < Cp;
    w_src[h] = reinterpret_cast<const char*>(
        w8 + (w_on[h] ? (long long)(x & 7) * Cp + c0 + (x >> 3) : 0));
  }
  const long long row_bytes = rs * (long long)sizeof(T), wrow_bytes = 32LL * Cp;
  // the row of the next position to copy, and its slot
  int next_row = r0 - 1, next_slot = 0, issued = 0;
  auto issue = [&]() {
    if (issued < n_pos) {
      const int row = min(max(next_row, 0), Rp - 1);
      const long long fo = row * row_bytes, wo = row * wrow_bytes;
      const unsigned fs = ring_s + next_slot * (SLOT_F4 * UB) + threadIdx.x * UB;
      const unsigned ws = wring_s + next_slot * (SLOT_W4 * 16) + threadIdx.x * 4;
      #pragma unroll
      for (int h = 0; h < 3; ++h) {
        if constexpr (UB == 16)
          cp_async16(fs + h * THREADS * UB, f_src[h] + fo, f_on[h]);
        else
          cp_async8(fs + h * THREADS * UB, f_src[h] + fo, f_on[h]);
      }
      #pragma unroll
      for (int h = 0; h < 2; ++h) cp_async4(ws + h * THREADS * 4, w_src[h] + wo, w_on[h]);
    }
    cp_async_commit();                         // empty groups keep the count
    ++issued;
    ++next_row;
    next_slot = next_slot + 1 == SLOTS ? 0 : next_slot + 1;
  };

  #pragma unroll
  for (int p = 0; p < DEPTH + 2; ++p) issue();

  int bad = 0;
  const int e = j * G + lq;                    // the thread's column c - 1 in a slot
  const long long out_step = (long long)C * Bp;
  const long long v0 = (long long)r0 * C + c;
  char* o8 = (char*)out + (v0 * Bp + 4 * q0) * (AS_CLASS ? 1 : 4);
  const int ostep_lt = 4 * LT * (AS_CLASS ? 1 : 4);   // bytes from float4 0 to 1
  const long long orow = out_step * (AS_CLASS ? 1 : 4);
  int self = (int)v0;
  // rows whose element (r, c) is stored: r < R, c < C and r * C + c < V
  const int r_lim = c < C ? (int)min((long long)R, ((long long)V - c + C - 1) / C) : 0;
  // two rows a step: positions 2t .. 2t+3 (rows r-1 .. r+2) from slot sl on
  int sl = 0;
  for (int r = r0; r < r1; r += 2) {
    issue();
    issue();
    cp_async_wait_depth();                     // position 2t + 3 has landed
    __syncthreads();
    const int s1 = sl + 1 == SLOTS ? 0 : sl + 1;
    const int s2 = s1 + 1 == SLOTS ? 0 : s1 + 1;
    const int s3 = s2 + 1 == SLOTS ? 0 : s2 + 1;
    #pragma unroll
    for (int h = 0; h < 2; ++h) {              // rows r and r + 1
      const int rr = r + h;
      if (rr < r1) {
        const int su = h ? s1 : sl, sm = h ? s2 : s1, sd = h ? s3 : s2;
        const float4 wa = wring[sm * SLOT_W4 + 2 * j], wb = wring[sm * SLOT_W4 + 2 * j + 1];
        const float w[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
        const U* up = ring + su * SLOT_F4 + e;
        const U* mid = ring + sm * SLOT_F4 + e;
        const U* dn = ring + sd * SLOT_F4 + e;
        char* o = o8 + h * orow;
        int res[4];
        if (act0) {
          pred_lanes<AS_CLASS, CHECK, G>(up, mid, dn, w, self + h * C, C, k_tol, tol, k_rtol,
                                         atol, bad, res);
          if (rr < r_lim) store_lanes<AS_CLASS>(o, res);
        }
        if (act1) {
          pred_lanes<AS_CLASS, CHECK, G>(up + LT, mid + LT, dn + LT, w, self + h * C, C, k_tol,
                                         tol, k_rtol, atol, bad, res);
          if (rr < r_lim) store_lanes<AS_CLASS>(o + ostep_lt, res);
        }
      }
    }
    o8 += 2 * orow;
    self += 2 * C;
    sl = s2;
  }
  if (CHECK) {
    if (__syncthreads_or(bad) && threadIdx.x == 0) atomicOr(viol, 1);
  }
}

}  // namespace

// The lane group is 8 threads (64 lanes) wherever Bp > 32, else 4; a run is
// RUN rows. `d` is f32, or bf16 where `bf16_field` is set.
extern "C" int class_pred_launch(
    const void* d, int bf16_field, const float* w8, void* out, int* viol,
    int R, int C, int Rp, int Cp, int Bp, int V, int as_class,
    float k_tol, float tol, float k_rtol, float atol, void* stream) {
  if (Bp % 4 != 0 || Bp < 4 || Rp < 1 || Cp < 1) return (int)cudaErrorInvalidValue;
  const int q4 = Bp / 4;
  const int LT = q4 > 4 * VEC ? 8 : 4;
  const long long n_lg = (q4 + LT * VEC - 1) / (LT * VEC);
  const long long n_strips = (Cp + (THREADS / LT) - 1) / (THREADS / LT);
  const long long n_runs = (Rp + RUN - 1) / RUN;
  const long long blocks = n_lg * n_strips * n_runs;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  cudaStream_t st = (cudaStream_t)stream;
  auto launch = [&](auto kernel, auto field, int unit_bytes) {
    const int smem = SMEM_BYTES(unit_bytes);
    const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr != cudaSuccess) return attr;
    kernel<<<grid, THREADS, smem, st>>>(field, w8, out, viol, R, C, Rp, Cp, Bp, V,
                                        (int)n_lg, (int)n_strips, k_tol, tol, k_rtol, atol);
    return cudaGetLastError();
  };
  const int mode = (as_class ? 4 : 0) + (viol ? 2 : 0) + (LT == 8 ? 1 : 0);
  if (bf16_field) {
    typedef __nv_bfloat16 H;
    const H* f = reinterpret_cast<const H*>(d);
    switch (mode) {
      case 0: return (int)launch(class_pred_kernel<H, false, false, 4>, f, 8);
      case 1: return (int)launch(class_pred_kernel<H, false, false, 8>, f, 8);
      case 2: return (int)launch(class_pred_kernel<H, false, true, 4>, f, 8);
      case 3: return (int)launch(class_pred_kernel<H, false, true, 8>, f, 8);
      case 4: return (int)launch(class_pred_kernel<H, true, false, 4>, f, 8);
      case 5: return (int)launch(class_pred_kernel<H, true, false, 8>, f, 8);
      case 6: return (int)launch(class_pred_kernel<H, true, true, 4>, f, 8);
      default: return (int)launch(class_pred_kernel<H, true, true, 8>, f, 8);
    }
  }
  const float* f = reinterpret_cast<const float*>(d);
  switch (mode) {
    case 0: return (int)launch(class_pred_kernel<float, false, false, 4>, f, 16);
    case 1: return (int)launch(class_pred_kernel<float, false, false, 8>, f, 16);
    case 2: return (int)launch(class_pred_kernel<float, false, true, 4>, f, 16);
    case 3: return (int)launch(class_pred_kernel<float, false, true, 8>, f, 16);
    case 4: return (int)launch(class_pred_kernel<float, true, false, 4>, f, 16);
    case 5: return (int)launch(class_pred_kernel<float, true, false, 8>, f, 16);
    case 6: return (int)launch(class_pred_kernel<float, true, true, 4>, f, 16);
    default: return (int)launch(class_pred_kernel<float, true, true, 8>, f, 16);
  }
}
