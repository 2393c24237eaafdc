// Fused offset-shift relaxation sweep for Hopper (sm_90a).
//
// Replaces: mesh_navigation_tpu/ops/pallas_sweep.py::_sweep_kernel (:40),
// launched by fused_sweep (:58) from batched_field_structured
// (mesh_navigation_tpu/ops/structured.py:207) -- the structured Dijkstra
// tier's sweep.
//
// What it computes. d is the [T + Vp + T, B] label matrix of element type E,
// f32 or bf16 (lanes contiguous), with one +inf tile at each end; planes is
// [K, Vp] of the same type, the weight of the edge arriving at v from
// v + off_k (+inf: no edge). For each
// tile i of T rows, the centre tile c = d[(i+1)T : (i+2)T] is relaxed
// n_inner times, Jacobi-style, against a halo frozen at the sweep's input:
//     c'[r] = min(c[r], min_k (x[r + off_k] + planes[k, iT + r]))
// where x[s] is c[s] for 0 <= s < T (the current iterate) and the input's
// row (i+1)T + s otherwise (the neighbour tiles, as they came in). The
// result of tile i goes to the same rows of `out`, a buffer apart from d:
// no block reads what another block writes, so the result does not depend
// on the order blocks run in. Every value is one add and a min, so the
// kernel equals the plain PyTorch version bit for bit. In bf16 (the
// structured tier's approximate mode, structured.py:156-162) the add is a
// bf16 add, __float2bfloat16_rn(float(x) + float(w)): the exact sum of two
// bf16 values fits in f32 unless their exponents differ by more than 16,
// and then both round to the larger; the min is taken in bf16.
//
// What bounds it on this card. One read and one write of the matrix plus
// one read of the planes: (2 (Vp + 2T) B + K Vp) * 4 bytes, 1.10 GB at the
// 1M-vertex shape (Vp = 1,049,600, T = 1280, B = 128, K = 6), about 0.33 ms
// at 3.35 TB/s. The n_inner * K add + min pairs per element are ~15x below
// the f32 rate: bound by bytes.
//
// What the design does about it: a persistent, streaming sweep.
// - A block owns one group of LG lanes and a contiguous run of tiles, which
//   it walks in order. The grid is (lane groups) x (runs), about as many
//   blocks as can be resident, lane group fastest: the blocks of one run
//   walk the same tiles at the same time, so the planes come from L2 once
//   they are read from device memory.
// - The window of rows [(i+1)T - lo, (i+2)T + hi) (lo, hi the largest
//   negative and positive offset) lives in a ring of shared-memory rows.
//   Walking tile i -> i+1 slides it by T rows, so each input row enters
//   shared memory once per run instead of (lo + T + hi) / T times.
// - Streaming: while tile i relaxes, the T rows that tile i+1 adds to the
//   window are already in flight (the ring holds lo + 2T + hi rows), by
//   cp.async in 16-byte pieces where the lanes allow, and so are its K x T
//   plane weights where two plane buffers fit; with one plane buffer the
//   next planes load after the tile. Without room for the spare T rows,
//   the next rows load after the tile too.
// - The launcher takes the widest lane group that fits (8 lanes of f32, 16
//   of bf16: 32-byte rows, a whole sector), then the most streaming: at the 1M shape that
//   is 8 lanes with one plane buffer, which ran faster on the card than 4
//   lanes with two, than 8 lanes reading the planes through the read-only
//   cache, and than 8 lanes prefetching the next planes into L2 (PERF.md).
// - The relaxations run in shared memory: the first reads the ring (the
//   input), writes the centre iterate to its own buffer, and the last
//   writes its rows straight to `out`, 16 bytes a thread where the lanes
//   allow. A thread holds 4 lanes of one row (1 for groups of 1 or 2
//   lanes), neighbouring threads the neighbouring 16 bytes: shared reads at
//   any offset are free of bank conflicts. K is a template parameter of
//   the 4-lane kernel, so the offset loop unrolls and the K reads of an
//   element are in flight together; the 1- and 2-lane groups share one
//   kernel with K as an argument.
// - Row indices into the matrix are 64-bit: (Vp + 2T) B passes 2^31 at
//   large batches.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#define THREADS 512
#define MAX_K 16
// dynamic shared memory a block may ask for: the card's 232,448 bytes
#define MAX_SMEM 232448
// returned when no lane group's window fits in a block's shared memory
#define FS_NO_FIT (-1)

namespace {

typedef __nv_bfloat16 bf16;

struct Offsets {
  int k[MAX_K];
};

// VEC lanes of element type E, read and written at once
template <typename E, int N> struct Vec;
template <> struct Vec<float, 1> { using T = float; };
template <> struct Vec<float, 4> { using T = float4; };
template <> struct Vec<bf16, 1> { using T = bf16; };
template <> struct Vec<bf16, 4> { using T = uint2; };

__device__ __forceinline__ float vmin_add(float b, float x, float w) { return fminf(b, x + w); }
__device__ __forceinline__ float4 vmin_add(float4 b, float4 x, float w) {
  return make_float4(fminf(b.x, x.x + w), fminf(b.y, x.y + w), fminf(b.z, x.z + w),
                     fminf(b.w, x.w + w));
}
// bf16: the f32 sum of two bf16 values rounded to nearest-even, then the min
__device__ __forceinline__ float wide(unsigned short h) { return __uint_as_float((unsigned)h << 16); }
__device__ __forceinline__ unsigned short minadd16(unsigned short b, unsigned short x, float w) {
  const unsigned short c = __bfloat16_as_ushort(__float2bfloat16_rn(wide(x) + w));
  return wide(c) < wide(b) ? c : b;
}
__device__ __forceinline__ bf16 vmin_add(bf16 b, bf16 x, bf16 w) {
  return __ushort_as_bfloat16(
      minadd16(__bfloat16_as_ushort(b), __bfloat16_as_ushort(x), __bfloat162float(w)));
}
__device__ __forceinline__ uint2 vmin_add(uint2 b, uint2 x, bf16 w) {
  const float wf = __bfloat162float(w);
  auto lo = [](unsigned v) { return (unsigned short)(v & 0xffffu); };
  auto hi = [](unsigned v) { return (unsigned short)(v >> 16); };
  return make_uint2(
      (unsigned)minadd16(lo(b.x), lo(x.x), wf) | ((unsigned)minadd16(hi(b.x), hi(x.x), wf) << 16),
      (unsigned)minadd16(lo(b.y), lo(x.y), wf) | ((unsigned)minadd16(hi(b.y), hi(x.y), wf) << 16));
}

__device__ __forceinline__ void set_inf(float& x) { x = CUDART_INF_F; }
__device__ __forceinline__ void set_inf(bf16& x) { x = __ushort_as_bfloat16(0x7f80); }

// one copy of n elements (1, 2 or 4; both addresses aligned to n elements):
// cp.async where it moves 4 bytes or more, else a plain copy, which the
// block's next barrier makes visible as it does the asynchronous ones
template <typename E>
__device__ __forceinline__ void cp_async(E* dst, const E* src, int n) {
  const int bytes = n * (int)sizeof(E);
  if (bytes == 16)
    __pipeline_memcpy_async(dst, src, 16);
  else if (bytes == 8)
    __pipeline_memcpy_async(dst, src, 8);
  else if (bytes == 4)
    __pipeline_memcpy_async(dst, src, 4);
  else
    *dst = *src;
}

__device__ __forceinline__ int wrap(int s, int n) { return s >= n ? s - n : s; }

struct Shape {
  long long Vp;
  int K, T, B, n_inner, lo, hi;
  int LG;       // lanes a block owns (16, 8 or 4 with 4-lane vectors, else 2 or 1)
  int RR;       // ring rows
  int pr;       // the ring holds T spare rows: the next tile's rows load during this one
  int pl2;      // two plane buffers: the next tile's planes load during this one
  int gv;       // elements per copy / store of the matrix (1, 2 or 4)
  int pv;       // elements per copy of the planes (1 or 4)
  int n_chunks; // runs of tiles (grid = lane groups x runs)
};

template <typename E>
__device__ __forceinline__ void copy_rows(E* ring, const E* d, long long row0, int n,
                                          int slot0, int lane0, const Shape& s) {
  const int per_row = s.LG / s.gv;
  const int sh = __ffs(per_row) - 1;
  for (int q = threadIdx.x; q < (n << sh); q += THREADS) {
    const int i = q >> sh;
    const int c = (q & (per_row - 1)) * s.gv;
    if (lane0 + c >= s.B) continue;   // gv > 1 only where B % gv == 0
    cp_async(ring + wrap(slot0 + i, s.RR) * s.LG + c, d + (row0 + i) * s.B + lane0 + c, s.gv);
  }
}

template <typename E>
__device__ __forceinline__ void copy_planes(E* pw, const E* planes, long long tile,
                                            int nk, const Shape& s) {
  const int n = s.T / s.pv;
  const E* pl = planes + tile * s.T;
  for (int k = 0; k < nk; ++k)
    for (int q = threadIdx.x; q < n; q += THREADS)
      cp_async(pw + k * s.T + q * s.pv, pl + k * s.Vp + q * s.pv, s.pv);
}

// E: the element type; K >= 0: K offsets, unrolled; K < 0: s.K offsets.
// VEC: lanes a thread reads and writes at once (4: lane groups of 4 or
// more; 1: of 2 or 1).
template <typename E, int K, int VEC>
__global__ void __launch_bounds__(THREADS, 1) fused_sweep_kernel(
    const E* __restrict__ d, const E* __restrict__ planes,
    E* __restrict__ out, Offsets offs, Shape s) {
  constexpr int KS = K >= 0 ? K : MAX_K;
  using V = typename Vec<E, VEC>::T;
  extern __shared__ float4 sm4[];
  const int T = s.T, RR = s.RR, lo = s.lo, LG = s.LG;
  const int nk = K >= 0 ? K : s.K;
  const int ncen = s.n_inner < 2 ? 0 : (s.n_inner == 2 ? 1 : 2);
  E* ring = reinterpret_cast<E*>(sm4);                     // [RR][LG]
  E* cen0 = ring + ((RR * LG + 3) & ~3);                   // [T][LG] iterates
  E* cen1 = cen0 + (ncen > 1 ? T * LG : 0);
  E* pw = cen0 + ncen * T * LG;                             // [1 or 2][K][T]
  pw = reinterpret_cast<E*>(((unsigned long long)pw + 15) & ~15ull);
  int off[KS > 0 ? KS : 1];
#pragma unroll
  for (int k = 0; k < KS; ++k) off[k] = k < nk ? offs.k[k] : 0;

  const int n_lg = (s.B + LG - 1) / LG;
  const int lane0 = (blockIdx.x % n_lg) * LG;
  const long long chunk = blockIdx.x / n_lg;
  const long long n_tiles = s.Vp / T;
  const long long t_begin = chunk * n_tiles / s.n_chunks;
  const long long t_end = (chunk + 1) * n_tiles / s.n_chunks;
  if (t_begin >= t_end) return;
  const int qpr = LG / VEC;                 // a row's vectors
  const int qsh = __ffs(qpr) - 1;

  // dead lanes (lane >= B) are never copied and stay +inf
  for (int i = threadIdx.x; i < RR * LG; i += THREADS) set_inf(ring[i]);
  __syncthreads();
  copy_rows(ring, d, (t_begin + 1) * T - lo, lo + T + s.hi, 0, lane0, s);
  copy_planes(pw, planes, t_begin, nk, s);
  __pipeline_commit();

  int wb = 0;   // ring slot of the window's first row, (t + 1) T - lo
  for (long long t = t_begin; t < t_end; ++t) {
    const bool nxt = t + 1 < t_end;
    const long long p0 = (t + 1) * T;   // matrix row of the centre's row 0
    const int buf = s.pl2 ? (int)((t - t_begin) & 1) : 0;
    const E* pwt = pw + buf * nk * T;
    const int new_slot = wrap(wb + lo + T + s.hi, RR);
    if (nxt && s.pr) copy_rows(ring, d, p0 + T + s.hi, T, new_slot, lane0, s);
    if (nxt && s.pl2) copy_planes(pw + (buf ^ 1) * nk * T, planes, t + 1, nk, s);
    __pipeline_commit();
    __pipeline_wait_prior(1);   // this tile's rows and planes
    __syncthreads();

    const int cb = wrap(wb + lo, RR);   // ring slot of the centre's row 0
    int kb[KS > 0 ? KS : 1];
#pragma unroll
    for (int k = 0; k < KS; ++k) kb[k] = wrap(wb + lo + off[k], RR);
    E* o = out + p0 * s.B + lane0;
    const int n_rel = s.n_inner > 0 ? s.n_inner : 1;
    for (int j = 0; j < n_rel; ++j) {
      const E* src = j == 0 ? nullptr : (((j - 1) & 1) ? cen1 : cen0);
      E* dst = (j & 1) ? cen1 : cen0;
      const bool last = j == n_rel - 1;
      for (int u = threadIdx.x; u < (T << qsh); u += THREADS) {
        const int r = u >> qsh;
        const int h = (u & (qpr - 1)) * VEC;
        V best = j == 0 ? *reinterpret_cast<const V*>(ring + wrap(cb + r, RR) * LG + h)
                        : *reinterpret_cast<const V*>(src + r * LG + h);
        if (s.n_inner > 0) {
#pragma unroll
          for (int k = 0; k < KS; ++k) {
            if (K < 0 && k >= nk) break;
            const int sr = r + off[k];
            const E* p = (j > 0 && (unsigned)sr < (unsigned)T)
                             ? src + sr * LG
                             : ring + wrap(kb[k] + r, RR) * LG;
            best = vmin_add(best, *reinterpret_cast<const V*>(p + h), pwt[k * T + r]);
          }
        }
        if (!last) {
          *reinterpret_cast<V*>(dst + r * LG + h) = best;
        } else if (s.gv >= VEC) {   // B % VEC == 0: a vector is all live or all dead
          if (lane0 + h < s.B) *reinterpret_cast<V*>(o + (long long)r * s.B + h) = best;
        } else {
          const E* bv = reinterpret_cast<const E*>(&best);
#pragma unroll
          for (int l = 0; l < VEC; ++l)
            if (lane0 + h + l < s.B) o[(long long)r * s.B + h + l] = bv[l];
        }
      }
      if (!last) __syncthreads();
    }
    __syncthreads();   // this tile's ring slots and planes are free
    if (nxt && !(s.pr && s.pl2)) {
      if (!s.pr) copy_rows(ring, d, p0 + T + s.hi, T, new_slot, lane0, s);
      if (!s.pl2) copy_planes(pw, planes, t + 1, nk, s);
      __pipeline_commit();
    }
    wb = wrap(wb + T, RR);
  }
  __pipeline_wait_prior(0);
}

size_t smem_bytes(int LG, int pr, int pl2, const Shape& s, int esize) {
  const int ncen = s.n_inner < 2 ? 0 : (s.n_inner == 2 ? 1 : 2);
  const long long RR = (long long)s.lo + s.T + s.hi + (pr ? s.T : 0);
  const long long rows = ((RR * LG + 3) & ~3LL) + (long long)ncen * s.T * LG;
  // the planes start on a 16-byte boundary
  const long long plane_at = (rows * esize + 15) / 16 * 16;
  return (size_t)(plane_at + (long long)(pl2 ? 2 : 1) * s.K * s.T * esize);
}

template <typename E, int K, int VEC>
int launch(const E* d, const E* planes, E* out, const Offsets& o, Shape s, size_t smem,
           cudaStream_t stream) {
  auto kern = fused_sweep_kernel<E, K, VEC>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  int per_sm = 0, dev = 0;
  static int n_sm = 0;
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                              &per_sm, kern, THREADS, smem);
  if (err == cudaSuccess && n_sm == 0) {
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return FS_NO_FIT;
  const long long n_lg = (s.B + s.LG - 1) / s.LG;
  const long long n_tiles = s.Vp / s.T;
  long long runs = (long long)per_sm * n_sm / n_lg;
  runs = runs < 1 ? 1 : (runs > n_tiles ? n_tiles : runs);
  s.n_chunks = (int)runs;
  const long long n_blocks = n_lg * runs;
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)n_blocks, THREADS, smem, stream>>>(d, planes, out, o, s);
  return (int)cudaGetLastError();
}

template <typename E>
int launch_typed(const E* d, const E* planes, E* out, const int* offs, int K, long long Vp,
                 int T, int B, int n_inner, cudaStream_t st) {
  Offsets o = {};
  Shape s = {};
  s.Vp = Vp; s.K = K; s.T = T; s.B = B; s.n_inner = n_inner;
  for (int k = 0; k < K; ++k) {
    if (offs[k] > T || offs[k] < -T) return (int)cudaErrorInvalidValue;
    o.k[k] = offs[k];
    s.lo = offs[k] < -s.lo ? -offs[k] : s.lo;
    s.hi = offs[k] > s.hi ? offs[k] : s.hi;
  }
  const int es = (int)sizeof(E);
  // widest copies the lanes and addresses allow
  const unsigned long long addr = (unsigned long long)d | (unsigned long long)out;
  s.gv = 4;
  while (s.gv > 1 && (B % s.gv != 0 || addr % (s.gv * es) != 0)) s.gv /= 2;
  s.pv = (T % 4 == 0 && Vp % 4 == 0 && (unsigned long long)planes % (4 * es) == 0) ? 4 : 1;
  // the widest lane group (32-byte rows; no wider than B unless 1) whose
  // window fits: streaming the next rows and planes, then one plane buffer,
  // then no spare ring rows
  const int modes[3][2] = {{1, 1}, {1, 0}, {0, 0}};
  size_t smem = 0;
  for (int lg = 32 / es; lg >= 1 && s.LG == 0; lg /= 2) {
    if (lg > B && lg > 1) continue;
    for (int m = 0; m < 3; ++m) {
      const size_t b = smem_bytes(lg, modes[m][0], modes[m][1], s, es);
      if (b <= MAX_SMEM) {
        s.LG = lg;
        s.pr = modes[m][0];
        s.pl2 = modes[m][1];
        smem = b;
        break;
      }
    }
  }
  if (s.LG == 0) return FS_NO_FIT;
  s.RR = s.lo + s.T + s.hi + (s.pr ? s.T : 0);
  if (s.gv > s.LG) s.gv = s.LG;
  if (s.LG < 4) return launch<E, -1, 1>(d, planes, out, o, s, smem, st);
#define FS_CASE(k) \
  case k: return launch<E, k, 4>(d, planes, out, o, s, smem, st);
  switch (K) {
    FS_CASE(0) FS_CASE(1) FS_CASE(2) FS_CASE(3) FS_CASE(4) FS_CASE(5)
    FS_CASE(6) FS_CASE(7) FS_CASE(8) FS_CASE(9) FS_CASE(10) FS_CASE(11)
    FS_CASE(12) FS_CASE(13) FS_CASE(14) FS_CASE(15) FS_CASE(16)
  }
#undef FS_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// d, planes and out are f32, or bf16 where `bf16_matrix` is set. offs: K
// offsets in host memory. Returns cudaGetLastError() after the launch,
// FS_NO_FIT when the window does not fit in a block's shared memory, or
// cudaErrorInvalidValue for another shape the kernel does not take.
extern "C" int fused_sweep_launch(const void* d, int bf16_matrix, const void* planes,
                                  void* out, const int* offs, int K,
                                  long long Vp, int T, int B, int n_inner,
                                  void* stream) {
  if (K < 0 || K > MAX_K || T < 1 || B < 1 || n_inner < 0 || Vp < T || Vp % T != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16_matrix)
    return launch_typed(reinterpret_cast<const bf16*>(d), reinterpret_cast<const bf16*>(planes),
                        reinterpret_cast<bf16*>(out), offs, K, Vp, T, B, n_inner, st);
  return launch_typed(reinterpret_cast<const float*>(d), reinterpret_cast<const float*>(planes),
                      reinterpret_cast<float*>(out), offs, K, Vp, T, B, n_inner, st);
}
