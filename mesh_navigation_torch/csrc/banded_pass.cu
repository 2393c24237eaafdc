// Banded Gauss-Seidel directional pass for Hopper (sm_90a).
//
// Replaces: mesh_navigation_tpu/ops/pallas_banded.py::_pass_kernel (:827),
// launched by _directional_pass_pallas (:1061), in every configuration the
// reference's solve runs:
// - the main path: no dirty table, `force` on the first down pass of a solve;
// - DIRTY (use_dirty, :1003-1036): the per-(8-lane block, row) table of rows
//   whose last scan still improved, used by the warm resolve, partial depth,
//   residual plans, four_dir and the deferring pass;
// - CUT (warm_cut, :864-878): the first down pass of a warm resolve applies
//   the raise-invalidation cut and the seed re-insertion;
// - XL, with or without DIRTY: the extended lanes of irregular plans
//   (xlanes, :887-896);
// - the storage type T of the field, f32 or bf16 (dtype, :867-869): loads
//   widen to f32, everything is computed in f32, stores round to
//   nearest-even (__float2bfloat16_rn); the carried rows stay f32;
// - the row mode: SKIP (skip=True, :995-1040), DEFER (scan_dirs="up", the
//   scan-deferring down pass, :969-994) or NOSKIP (skip=False, :1041-1048);
// - the scan depth: the exact block scan (full depth), or `nsteps` doubling
//   steps a direction on the plan's chain-weight levels (partial depth,
//   scan_steps, :979-989).
//
// What it computes. One pass over every row of the field d[Rp, Cp, Bp] (T,
// lanes contiguous), down (r = 0..Rp-1) or up (reverse). For each row:
//   cand = min over s in {-1,0,+1} of prev[c+s] + cross[r, s+1, c]
//   row0 = min(cur, cand)
//   imp  = any over the block's lanes of cand*(1+rtol)+atol < cur
//   need = imp | (force & any(row0 < inf))
//   need: row = lateral min-plus closure of row0 (forward, then backward)
//   else: row = cur (left in place)
// and the row as stored is the carry `prev` of the next row. `changed` is
// the OR of `imp` over all rows and blocks.
// Partial depth: the lateral closure is replaced by nsteps forward steps
// row[c] = min(row[c], row[c - 2^s] + a_fwd[r, s, c]), each on the row the
// step before left, then the same backward with a_bwd on the forward-updated
// row; with DIRTY a row whose scan still improved stays dirty.
// DEFER (needs DIRTY): no scan; need = imp | (force & any finite), the row
// writes need ? row0 : cur and dirty[j, row] = max(dirty[j, row], need).
// NOSKIP (no DIRTY): every row is scanned from row0 and written, `changed`
// is the OR of scanned*(1+rtol)+atol < cur, and the carry is the scanned row
// before it is rounded to T (:1048).
// DIRTY: need |= dirty[j, row]; a needed row scans base = row0 and writes
// the scan, simp = any over the block of scanned*(1+rtol)+atol < base, sets
// dirty[j, row] = simp and changed |= simp; a row that is not needed sets
// dirty[j, row] = 0. Block j owns row j of the table. The reference scans
// base = imp ? row0 : cur and writes simp ? scanned : base
// (pallas_banded.py:1019-1026): a row needed only because it is dirty drops
// its sub-tolerance cross-row gains, and every needed row its sub-tolerance
// lateral gains. Both compound along the chains a warm resolve re-solves,
// leaving labels several tolerances above their distance while every edge
// passes the certificate. Every needed row is scanned to its lateral fixed
// point, so keeping the gains cannot leave a row off it unflagged.
// CUT: each label is cut at load, cur = cur >= cutlb[row, c] + cutth[lane]
// ? inf : cur, then cur = 0 where (seedrc[0, lane], seedrc[1, lane]) ==
// (row, c); a row that is not needed keeps the cut labels.
// XL: lane i = (sel, dc) adds src[c + dc] + xcross[r, i, c] to cand (+inf off
// the row) before row0 and imp, src the carried row (sel 1), the row before
// it as the pass left it (sel 2: a second carried row) or the row's own
// values as loaded (sel 0). With a sel-2 lane and DIRTY the walk goes on for
// two rows after a needed row (see Jumping). The kernels read the lanes'
// edges from per-row lists of the edges that exist (see Extended lanes),
// never the dense [Rp, n, Cp] planes: an absent edge's weight is +inf, and
// X + inf never wins a min, so the lists give the dense loop's cand bit for
// bit (fminf is exact and order-free on these values).
//
// What bounds it on this card. The field is read once and the rows the pass
// changes written once: at the main path's 1024 x 1024 x 1024 f32 field that
// is 4.3 GB to read, about 1.3 ms at 3.35 TB/s, plus the writes (half of it
// in bf16). The
// arithmetic (a few adds and mins per element plus the scan) is far below
// the f32 rate, so the pass is bound by bytes; what holds it back is the
// row-after-row chain inside each block (one block per 8 lanes, 16 blocks
// at the replan's 128 lanes).
//
// What the design does about it.
// - Row order: one block owns one batch block of LANES lanes and walks the
//   rows itself, keeping the carried row in shared memory (Cp*LANES floats,
//   32 KB at Cp = 1024). Nothing crosses blocks except the changed flag.
// - Jumping (DIRTY): a row that is not needed is left in place, so the carry
//   into the row after it is that row as it lies in memory (cut, where CUT
//   applies), and that row's need depends on memory only. A prescan kernel
//   over all SMs computes it for every (block, row) from one read of the
//   field (and applies the cut to memory, which is idempotent), into a bit
//   table. The walker then jumps from a row that was not needed straight to
//   the next row whose bit is set, loading its carry from memory; from a
//   needed row it walks on row by row. Skipped rows were clean (their dirty
//   entry is 0 already), keep what memory holds, and leave `changed` alone:
//   what the plain pass leaves, bit for bit. With a sel-2 lane a row's need
//   also depends on the row two before it, so the walker walks on for the
//   two rows after a needed row, and jumps only where both rows before the
//   target are as memory holds them; the prescan's need then counts both
//   rows and the row's own shifts, as the walker's does.
// - Extended lanes: the second carried row takes a second Cp*LANES floats of
//   shared memory (two rows of the same ring, swapped a row), so plans with
//   a sel-2 lane take rows of at most MAX_COLS_X2 columns. Own-row sources
//   come from the staged row or from device memory, read before the barrier
//   after which the row is written.
//   Before the lists each thread read, for each of its columns and each
//   of the n lanes, one weight of the dense [Rp, n, Cp] planes from device
//   memory in a loop the compiler could not unroll: at the 1M irregular
//   plan (Cp = 1,024, 7 lanes a pass) 7 x 1,024 scalar loads a row of a
//   block (28 KB beside its 32 KB row), outside the stage ring and on the
//   row's critical path, and the prescan the same for every element. About
//   99% of those weights are +inf: the lanes hold the few edges of an
//   irregular mesh that no dense class covers. On the card (one H100 80GB
//   HBM3, 700 W) that pass took 8.87 ms a launch against a 0.70 ms bound,
//   ~31 us a walked row against the main walker's ~7.
//   Now each pass has lists of the edges that exist (ops/banded_gpu.py
//   XLaneList): per row, entries (column, sel, dc, lane; f32 weight) sorted
//   by column, each row's first at a multiple of 4 entries, and a header:
//   the row's first entry, the first entry and count of the rows beside it,
//   and a 16-bit offset for each 4-column group (a thread's columns). Staged,
//   thread 0 brings a row's header and its first `cap` entries (as many as
//   the shared memory left beside the three stages and carried rows holds,
//   at most the plan's fullest row) into an extended-lane slot of the row's
//   stage by bulk copies counted on the stage's barrier, one row ahead as
//   the row itself, where and how many taken from the header of the row
//   before it, which has arrived (so with lanes thread 0 waits for a row's
//   stage before it prefetches the next; without, the prefetch goes first
//   and the two loads overlap); entries past the cap, and every entry
//   where rows are not staged, are read from device memory. A thread walks
//   its own entries only (0.4 a row at the 1M plan), once over its columns
//   in order. On the card (one H100 80GB HBM3, 700 W, 512 lanes;
//   chip_smoke.py) the pass takes 4.35 ms a launch, and a forced pass with
//   the lists walks a row in 7.6 us against the main walker's 5.5.
//   The prescan reads its column's group from device memory.
// - Columns: a thread holds CPT consecutive columns of the row, each
//   column's 8 lanes in registers: 1 column up to 32 (one warp), 4 up to
//   1,024 (8 warps at 1,024 columns), then 8 (at most 512 threads, so
//   Cp <= 4096). On the card 4 columns a thread beat 2 and 8 at 1,024
//   columns (PERF.md). The carried row sits in shared memory laid out by
//   thread, [2 CPT][threads] float4, so a warp's reads are consecutive.
// - The lateral scan is a min-plus scan of (weight, value) pairs: element c
//   carries f_c(x) = min(b_c, x + a_c), a_c the +-1 lateral chain weight
//   (level 0 of the plan's a_fwd / a_bwd stacks). Sequential inside the
//   thread, then a Kogge-Stone scan of the thread totals by warp shuffles,
//   then each warp scans the warp totals the same way (every warp alike, so
//   no second barrier), and the prefixes are folded back: one barrier per
//   direction. The forward scan's barrier also carries the block's imp and
//   fin flags. Within one warp of one column a thread (Cp <= 32) this is the
//   reference's flat Hillis-Steele scan (pallas_banded.py:958-966) exactly;
//   wider rows associate the sums differently, so the port and JAX agree
//   within the stopping tolerance, not bit for bit. The plain PyTorch
//   version (directional_pass_plain) sums in this kernel's order, so the
//   two agree bit for bit: the warm resolve's dirty flags sit at the
//   tolerance edge by construction, and any other order flips some of them.
// - Partial depth exchanges the row through one more row of shared memory
//   (the carried rows' layout), two barriers a step: each step reads the
//   row the step before published, as the reference's shifted slabs do.
//   Its levels of a_fwd / a_bwd are read from device memory (L2).
// - Rows by the Tensor Memory Accelerator: a row of a block touches one
//   32-byte sector in every column (16 bytes in bf16), and moved by the threads those
//   scattered sectors keep the load/store unit busy for most of a row. So
//   thread 0 moves rows through three shared-memory stages by TMA (a 3-D
//   tensor map over the field, boxes of 8 lanes x 256 columns, the 32-byte
//   swizzle in f32; in bf16 a box row is 16 bytes, unswizzled, and a stage's
//   field part half the bytes) and the row's cross and lateral weights by bulk copies, all
//   counted on the stage's barrier: the next row loads while this one is
//   processed, and a written row goes back from its stage by a TMA store
//   at the top of the next row (the third stage lets that store drain
//   while the next row loads). The dirty flag comes one row ahead by a
//   plain load. A wait past ~20 s fails an assertion instead of holding
//   the card. Where three stages do not fit beside the carried row (Cp > 1,024, where 8
//   columns a thread would not match the weights' layout anyway), rows and
//   weights are read from device memory as they are needed and rows
//   written in place.
// - DIRTY needs base = row0 after the scan: it is recomputed from the
//   row and the carried row, which stay in place until the row ends.
// - Offsets into the field are 64-bit (Rp*Cp*Bp exceeds 2^31 at 1M x 1024).
// - The flag arithmetic uses __fmul_rn/__fadd_rn so no multiply-add is fused
//   and `imp` matches the plain PyTorch version on equal inputs.

#undef NDEBUG
#include <assert.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define LANES 8
#define FULL_MASK 0xffffffffu
#define MAX_THREADS 512
#define MAX_WARPS (MAX_THREADS / 32)
#define MAX_COLS 4096
#define MAX_COLS_X2 3584   // with a second row in shared memory (checked below)
#define MAX_COLS_X3 2304   // with a third (checked below)
#define MAX_SMEM 232448
#define PRESCAN_THREADS 256
#define MAX_XLANES 24      // extended lanes a pass (the plan finds at most 21)
#define MAX_XDC 4          // |dc| of an extended lane: the prescan's halo
#define XG 4               // columns of a group of the extended-lane lists
#define XL_HEAD 5          // ints of a list row's header before its group offsets
#define XL_MAX_CAP 1024    // entries of a row an extended-lane slot holds at most

// row modes (ops/banded_gpu.py PASS_MODE_*)
#define MODE_SKIP 0
#define MODE_DEFER 1
#define MODE_NOSKIP 2

namespace {

typedef __nv_bfloat16 bf16;

// the extended-lane edges of a pass that exist, row by row: a row's header
// goff[r * gw ..] holds its first entry, the first entry and count of row
// r + 1, those of row r - 1, then (from int XL_HEAD, 16 bits each) the
// offset from its first entry of each 4-column group's first entry (k <
// ng) and of its end (k = ng); entries sorted by column, a row's first at a
// multiple of 4; meta = column | sel << 12 | (dc + 4) << 14 | lane << 18
struct XList {
  const int* goff;
  const int* meta;
  const float* w;
  int gw;    // ints a row's header (a multiple of 4)
  int ng;    // groups a row, ceil(Cp / XG)
  int cap;   // staged: entries of a row its extended-lane slot holds
};
// offset k of a row's header (shared memory, or device memory by __ldg)
__device__ __forceinline__ int xl_off(const int* head, int k) {
  return reinterpret_cast<const unsigned short*>(head + XL_HEAD)[k];
}
__device__ __forceinline__ int xl_off_ldg(const int* head, int k) {
  return __ldg(reinterpret_cast<const unsigned short*>(head + XL_HEAD) + k);
}
__device__ __forceinline__ int xm_col(int m) { return m & 0xfff; }
__device__ __forceinline__ int xm_sel(int m) { return (m >> 12) & 3; }
__device__ __forceinline__ int xm_dc(int m) { return ((m >> 14) & 15) - 4; }

// --- the field's storage type: 4 lanes widened to f32, or rounded from it ---
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const bf16* p) {
  // a bf16 is the top half of its f32: widening is exact
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ unsigned bf16_bits(float x) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(x));
}
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void st4(bf16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(bf16_bits(v.x) | (bf16_bits(v.y) << 16),
                                            bf16_bits(v.z) | (bf16_bits(v.w) << 16));
}
// x as T stores it, widened back
template <typename T> __device__ __forceinline__ float stored(float x) { return x; }
template <> __device__ __forceinline__ float stored<bf16>(float x) {
  return __uint_as_float(bf16_bits(x) << 16);
}

template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&v)[LANES]) {
  const float4 a = ld4(p), b = ld4(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const float (&v)[LANES]) {
  st4(p, make_float4(v[0], v[1], v[2], v[3]));
  st4(p + 4, make_float4(v[4], v[5], v[6], v[7]));
}

// --- the Tensor Memory Accelerator and its barriers (PTX) ---
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* b) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(b)));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(b)),
               "r"(bytes) : "memory");
}
// waits for the barrier's phase of this parity; a wait past ~20 s fails a
// device-side assertion, so a broken schedule fails the launch (with a
// message that names this wait) instead of holding the card
__device__ __forceinline__ void mbar_wait(uint64_t* b, unsigned parity) {
  const long long t0 = clock64();
  for (;;) {
    unsigned ok;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(ok) : "r"(smem_u32(b)), "r"(parity) : "memory");
    if (ok) return;
    assert(clock64() - t0 <= 40000000000LL && "banded_pass: a stage barrier waited past ~20 s");
  }
}
// box (x lanes, y columns, z row) of the [Rp, Cp, Bp] field to / from shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* m, int x, int y, int z,
                                         uint64_t* b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];"
      ::"r"(smem_u32(dst)), "l"(m), "r"(x), "r"(y), "r"(z), "r"(smem_u32(b)) : "memory");
}
__device__ __forceinline__ void tma_store(const CUtensorMap* m, int x, int y, int z,
                                          const void* src) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%1, %2, %3}], [%4];"
               ::"l"(m), "r"(x), "r"(y), "r"(z), "r"(smem_u32(src)) : "memory");
}
// contiguous bytes (a multiple of 16) to shared memory, counted on a barrier
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(b)) : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;"); }
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}
// the 32-byte swizzle of the f32 tensor map: bit 4 of a byte offset from an
// aligned base XOR its bit 7 (a wider swizzle pads each 32-byte box row to
// its span, which a probe on the card showed)
__device__ __forceinline__ unsigned swz(unsigned off) { return off ^ (((off >> 7) & 1u) << 4); }

// lanes 4h..4h+3 of column c of a staged row: f32 rows of 32 bytes under the
// 32-byte swizzle; bf16 rows of 16 bytes, unswizzled
__device__ __forceinline__ float4 ld_stage(const float*, const char* base, int c, int h) {
  return *reinterpret_cast<const float4*>(base + swz(c * 32 + 16 * h));
}
__device__ __forceinline__ float4 ld_stage(const bf16*, const char* base, int c, int h) {
  return ld4(reinterpret_cast<const bf16*>(base + c * 16 + 8 * h));
}
__device__ __forceinline__ void st_stage(const float*, char* base, int c, int h, float4 v) {
  *reinterpret_cast<float4*>(base + swz(c * 32 + 16 * h)) = v;
}
__device__ __forceinline__ void st_stage(const bf16*, char* base, int c, int h, float4 v) {
  st4(reinterpret_cast<bf16*>(base + c * 16 + 8 * h), v);
}

__device__ __forceinline__ bool below(float x, float cur, float k_rtol, float atol) {
  return __fadd_rn(__fmul_rn(x, k_rtol), atol) < cur;
}

// CUT at load (idempotent: a cut label is +inf or a re-inserted 0)
__device__ __forceinline__ bool cut8(float (&v)[LANES], float lb, const float* th,
                                     const int* sr, const int* sc, int r, int c) {
  bool chg = false;
  #pragma unroll
  for (int l = 0; l < LANES; ++l) {
    float x = v[l] >= lb + th[l] ? CUDART_INF_F : v[l];
    if (sr[l] == r && sc[l] == c) x = 0.f;
    chg |= x != v[l];
    v[l] = x;
  }
  return chg;
}

// ---------------------------------------------------------------------------
// prescan: need of every (block, row) whose carry is the row before it as it
// lies in memory; CUT labels written back
// ---------------------------------------------------------------------------

// One block: PRESCAN_THREADS columns of one lane block and one 32-row word
// of the bit table, walked in pass order with the row before in shared
// memory (float4 halves, columns shifted by the halo), so the field is read
// about once. XL keeps four rows in a ring (the row, the two before it, and
// the next row's slot, so one barrier a row suffices) with MAX_XDC halo
// columns each side; a thread relaxes the extended-lane entries of its
// column, read from its 4-column group of the row's list. A dirty row is
// needed too, except in DEFER, whose need does not read the table.
template <typename T, bool CUT, bool XL>
__global__ void __launch_bounds__(PRESCAN_THREADS) banded_prescan_kernel(
    T* __restrict__ d, const float* __restrict__ cross, const int* __restrict__ dirty,
    unsigned* __restrict__ need_bits, const float* __restrict__ cutlb,
    const float* __restrict__ cutth, const int* __restrict__ seedrc,
    const __grid_constant__ XList xl,
    int Rp, int Cp, int Bp, int reverse, int force, int dirty_need, float k_rtol, float atol) {
  constexpr int TH = PRESCAN_THREADS;
  constexpr int H = XL ? MAX_XDC : 1;   // halo columns each side
  constexpr int NBUF = XL ? 4 : 2;
  constexpr int W = TH + 2 * H;
  __shared__ float4 rowbuf[NBUF][2][W];
  __shared__ float s_th[LANES];
  __shared__ int s_sr[LANES], s_sc[LANES];
  __shared__ unsigned s_word;
  const int nb = Bp / LANES;
  const int nq = (Cp + TH - 1) / TH;
  const int nwords = (Rp + 31) >> 5;
  long long bid = blockIdx.x;
  const int q = (int)(bid % nq);
  bid /= nq;
  const int j = (int)(bid % nb);
  const int w = (int)(bid / nb);
  const int tid = threadIdx.x;
  const int c = q * TH + tid;
  const int k = tid + H;   // this thread's column in a row buffer
  const long long b0 = (long long)j * LANES;
  const long long rs = (long long)Cp * Bp;
  const int step = reverse ? -1 : 1;
  const int lo_row = w * 32, hi_row = min(w * 32 + 32, Rp);
  if (tid < LANES) {
    s_th[tid] = CUT ? cutth[b0 + tid] : 0.f;
    s_sr[tid] = CUT ? seedrc[b0 + tid] : -1;
    s_sc[tid] = CUT ? seedrc[Bp + b0 + tid] : -1;
  }
  if (tid == 0) s_word = 0u;
  __syncthreads();
  // column cc of row rr as memory holds it after the cut; +inf outside
  auto col = [&](int rr, int cc, float (&v)[LANES]) -> bool {
    if (rr < 0 || rr >= Rp || cc < 0 || cc >= Cp) {
      #pragma unroll
      for (int l = 0; l < LANES; ++l) v[l] = CUDART_INF_F;
      return false;
    }
    load8(d + rr * rs + (long long)cc * Bp + b0, v);
    return CUT && cut8(v, cutlb[(long long)rr * Cp + cc], s_th, s_sr, s_sc, rr, cc);
  };
  auto put = [&](int buf, int kk, const float (&v)[LANES]) {
    rowbuf[buf][0][kk] = make_float4(v[0], v[1], v[2], v[3]);
    rowbuf[buf][1][kk] = make_float4(v[4], v[5], v[6], v[7]);
  };
  // the halo columns of row rr: the chunk's neighbours left and right
  auto halo = [&](int buf, int rr) {
    float v[LANES];
    if (tid < H) {
      col(rr, q * TH - H + tid, v);
      put(buf, tid, v);
    } else if (tid >= TH - H) {
      const int e = tid - (TH - H);
      col(rr, q * TH + TH + e, v);
      put(buf, TH + H + e, v);
    }
  };
  // cand from the carried row in buffer b1 (columns k-1, k, k+1)
  auto cand_cross = [&](int b1, int r, float (&cd)[LANES]) {
    const float* cr = cross + (long long)r * 3 * Cp + c;
    const float x0 = cr[0], x1 = cr[Cp], x2 = cr[2 * Cp];
    #pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 L = rowbuf[b1][h][k - 1], S = rowbuf[b1][h][k], R = rowbuf[b1][h][k + 1];
      cd[4 * h + 0] = fminf(fminf(L.x + x0, S.x + x1), R.x + x2);
      cd[4 * h + 1] = fminf(fminf(L.y + x0, S.y + x1), R.y + x2);
      cd[4 * h + 2] = fminf(fminf(L.z + x0, S.z + x1), R.z + x2);
      cd[4 * h + 3] = fminf(fminf(L.w + x0, S.w + x1), R.w + x2);
    }
  };
  auto flag_of = [&](const float (&cd)[LANES], const float (&cur)[LANES]) -> int {
    int flag = 0;
    #pragma unroll
    for (int l = 0; l < LANES; ++l) {
      flag |= below(cd[l], cur[l], k_rtol, atol);
      if (force) flag |= fminf(cur[l], cd[l]) < CUDART_INF_F;
    }
    return flag;
  };
  int r = reverse ? hi_row - 1 : lo_row;
  if constexpr (!XL) {
    {
      float v[LANES];
      col(r - step, c, v);
      put(0, k, v);
      halo(0, r - step);
    }
    __syncthreads();
    int buf = 0;
    for (int n = 0; n < hi_row - lo_row; ++n, r += step) {
      float cur[LANES];
      if (col(r, c, cur)) store8(d + r * rs + (long long)c * Bp + b0, cur);
      int flag = 0;
      if (c < Cp) {
        float cd[LANES];
        cand_cross(buf, r, cd);
        flag = flag_of(cd, cur);
      }
      put(buf ^ 1, k, cur);
      halo(buf ^ 1, r);
      if (__any_sync(FULL_MASK, flag) && (tid & 31) == 0) atomicOr(&s_word, 1u << (r & 31));
      __syncthreads();
      buf ^= 1;
    }
  } else {
    // slot n & 3 holds the row of step n; the two rows before the word's
    // first row go to slots 2 and 3
    {
      float v[LANES];
      col(r - 2 * step, c, v);
      put(2, k, v);
      halo(2, r - 2 * step);
      col(r - step, c, v);
      put(3, k, v);
      halo(3, r - step);
    }
    for (int n = 0; n < hi_row - lo_row; ++n, r += step) {
      const int s0 = n & 3, s1 = (n + 3) & 3, s2 = (n + 2) & 3;
      // this column's extended-lane edges: the entries of its 4-column group
      int e0 = 0, e1 = 0;
      if (c < Cp) {
        const int* head = xl.goff + (long long)r * xl.gw;
        const int first = __ldg(head);
        e0 = first + xl_off_ldg(head, c / XG);
        e1 = first + xl_off_ldg(head, c / XG + 1);
      }
      float cur[LANES];
      if (col(r, c, cur)) store8(d + r * rs + (long long)c * Bp + b0, cur);
      put(s0, k, cur);
      halo(s0, r);
      __syncthreads();
      int flag = 0;
      if (c < Cp) {
        float cd[LANES];
        cand_cross(s1, r, cd);
        for (int e = e0; e < e1; ++e) {
          const int m = __ldg(xl.meta + e);
          if (xm_col(m) > c) break;                  // sorted by column
          const int dc = xm_dc(m), sel = xm_sel(m);
          if (xm_col(m) < c || sel > 2 || dc < -MAX_XDC || dc > MAX_XDC) continue;
          const int sb = sel == 0 ? s0 : (sel == 1 ? s1 : s2);
          const float wx = __ldg(xl.w + e);
          #pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float4 X = rowbuf[sb][h][k + dc];
            cd[4 * h + 0] = fminf(cd[4 * h + 0], X.x + wx);
            cd[4 * h + 1] = fminf(cd[4 * h + 1], X.y + wx);
            cd[4 * h + 2] = fminf(cd[4 * h + 2], X.z + wx);
            cd[4 * h + 3] = fminf(cd[4 * h + 3], X.w + wx);
          }
        }
        flag = flag_of(cd, cur);
      }
      if (__any_sync(FULL_MASK, flag) && (tid & 31) == 0) atomicOr(&s_word, 1u << (r & 31));
    }
    __syncthreads();
  }
  if (tid == 0) {
    unsigned word = s_word;
    if (q == 0 && dirty_need)
      for (int rr = lo_row; rr < hi_row; ++rr)
        if (dirty[(long long)j * Rp + rr] > 0) word |= 1u << (rr & 31);
    if (word) atomicOr(need_bits + (long long)j * nwords + w, word);
  }
}

// the first row at or after `from` in walk order whose bit is set, or -1;
// every thread of the block gets the same answer
__device__ int next_needed(const unsigned* bits, int from, int Rp, bool rev) {
  const int lane = threadIdx.x & 31;
  const int nwords = (Rp + 31) >> 5;
  int w = from >> 5;
  const int f = from & 31;
  unsigned first = rev ? (f == 31 ? FULL_MASK : ((1u << (f + 1)) - 1u)) : (FULL_MASK << f);
  for (;;) {
    const int wi = rev ? w - lane : w + lane;
    unsigned word = (wi >= 0 && wi < nwords) ? bits[wi] : 0u;
    if (lane == 0) word &= first;
    const unsigned ball = __ballot_sync(FULL_MASK, word != 0u);
    if (ball) {
      const int src = __ffs(ball) - 1;
      const unsigned wv = __shfl_sync(FULL_MASK, word, src);
      return rev ? (w - src) * 32 + 31 - __clz(wv) : (w + src) * 32 + __ffs(wv) - 1;
    }
    w = rev ? w - 32 : w + 32;
    first = FULL_MASK;
    if (rev ? w < 0 : w >= nwords) return -1;
  }
}

// ---------------------------------------------------------------------------
// the walker
// ---------------------------------------------------------------------------

struct Args {
  void* d;
  const float* cross;
  const float* af;
  long long af_rs;
  const float* ab;
  long long ab_rs;
  int* chg;
  int* dirty;
  const unsigned* need_bits;
  int* walked;
  int Rp, Cp, Bp, reverse, force, staged;
  int boxc, n_boxes;   // staged: columns of a TMA box, boxes a row
  float k_rtol, atol;
  XList xl;            // XL: the lanes' lists (cap: entries a row's slot stages)
  int x2;              // a sel-2 lane: two carried rows
  int mode;            // MODE_SKIP, MODE_DEFER or MODE_NOSKIP
  int nsteps;          // 0: the exact block scan; else partial depth
};

#define N_SLOTS 3   // row stages: being read, being loaded, being stored

// shared-memory layout (floats) beside the rows
#define TOT_FLOATS (2 * MAX_WARPS * (1 + LANES))

// floats before the stage: `nrows` rows of `cols` (threads x CPT) columns
// (the carried rows and the partial-depth exchange row), the warp totals and
// flags, the slots' barriers; then up to 1,024 bytes to align the stage
__host__ __device__ constexpr long long stage_offset(int cols, int nrows) {
  return ((long long)cols * LANES * nrows + TOT_FLOATS + MAX_WARPS + 4 + 2 * N_SLOTS + 2 + 3) &
         ~3LL;
}
// two rows of MAX_COLS_X2 columns fit (8 columns a thread, so a multiple of
// 256), one more step of 256 does not; the same for three of MAX_COLS_X3
static_assert(stage_offset(MAX_COLS_X2, 2) * 4 <= MAX_SMEM &&
                  stage_offset(MAX_COLS_X2 + 256, 2) * 4 > MAX_SMEM,
              "MAX_COLS_X2 is the widest row of which two fit");
static_assert(stage_offset(MAX_COLS_X3, 3) * 4 <= MAX_SMEM &&
                  stage_offset(MAX_COLS_X3 + 256, 3) * 4 > MAX_SMEM,
              "MAX_COLS_X3 is the widest row of which three fit");

// per slot: the field's row as its TMA boxes land ([n_boxes * boxc][LANES]
// of `esize` bytes, swizzled in f32), then the tables as they lie in memory
// (cross [3][Cp], a_fwd, a_bwd [Cp]): with at most 4 columns a thread,
// thread t's columns are one vector of each; a multiple of 1,024 bytes
__host__ __device__ __forceinline__ long long row_floats(int n_boxes, int boxc, int esize) {
  return (long long)n_boxes * boxc * LANES * esize / 4;
}
__host__ __device__ __forceinline__ long long slot_floats(int Cp, int n_boxes, int boxc,
                                                          int esize) {
  return (row_floats(n_boxes, boxc, esize) + 5LL * Cp + 255) & ~255LL;
}
// XL, staged: after the N_SLOTS stages, an extended-lane slot for each: the
// row's header (gw ints), then its first `cap` entries' meta (ints)
// and weights (floats); a multiple of 16 bytes
__host__ __device__ __forceinline__ long long xl_slot_floats(const XList& xl) {
  return xl.gw + 2LL * xl.cap;
}

template <typename T, bool DIRTY, int CPT, bool XL>
__global__ void __launch_bounds__(MAX_THREADS) banded_pass_kernel(
    const __grid_constant__ Args g, const __grid_constant__ CUtensorMap tmap) {
  constexpr int TV = CPT >= 4 ? 4 : CPT;   // floats a thread reads of a table row
  const T* const tag = nullptr;            // selects the stage layout of T
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  T* const d = reinterpret_cast<T*>(g.d);
  const float* const cross = g.cross;
  const float* const af = g.af;
  const float* const ab = g.ab;
  const long long af_rs = g.af_rs, ab_rs = g.ab_rs;
  const int Rp = g.Rp, Cp = g.Cp, Bp = g.Bp;
  const bool staged = g.staged != 0;
  const float k_rtol = g.k_rtol, atol = g.atol;
  const int mode = g.mode, nsteps = g.nsteps;
  // the exact block scan starts before the block knows `need`; partial
  // depth and DEFER leave row0 in place until then
  const bool exact = nsteps == 0 && mode != MODE_DEFER;
  const int NT = blockDim.x;
  const int nw = NT >> 5;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // carried row, [2 CPT][NT] float4: thread t's column t*CPT + i, lanes
  // 4h..4h+3 at (2i + h) NT + t, so a warp's accesses are consecutive. With a
  // sel-2 lane a second one follows: the two are a ring, prev4 the row
  // before, prev2_4 the one before it; a row is written over prev2_4 and the
  // two swap at the row's end. Partial depth's exchange row follows them.
  const bool two_rows = XL && g.x2 != 0;
  const int ncarry = two_rows ? 2 : 1;
  const int nrows = ncarry + (nsteps > 0 ? 1 : 0);
  float4* prev4 = smem4;
  float4* prev2_4 = smem4 + 2 * CPT * NT;
  float4* const xb4 = smem4 + 2 * CPT * NT * ncarry;
  float* tot = smem + (long long)NT * CPT * LANES * nrows;   // [2][MAX_WARPS][1 + LANES]
  int* wflag = reinterpret_cast<int*>(tot + TOT_FLOATS);   // [MAX_WARPS]
  int* sflag = wflag + MAX_WARPS;                          // [N_SLOTS] staged dirty flags
  uint64_t* mbar = reinterpret_cast<uint64_t*>(
      (reinterpret_cast<uintptr_t>(sflag + 4) + 7) & ~uintptr_t(7));   // [N_SLOTS]
  float* stage = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem + stage_offset(NT * CPT, nrows)) + 1023) &
      ~uintptr_t(1023));
  const int boxc = g.boxc, n_boxes = g.n_boxes;
  const long long slot_f = slot_floats(Cp, n_boxes, boxc, (int)sizeof(T));
  const long long xslot_f = XL ? xl_slot_floats(g.xl) : 0;
  const int xcap = XL && staged ? g.xl.cap : 0;
  float* const xslot = stage + N_SLOTS * slot_f;   // staged XL: the extended-lane slots
  const long long d_floats = row_floats(n_boxes, boxc, (int)sizeof(T));   // the d part of a slot
  const long long box_f = row_floats(1, boxc, (int)sizeof(T));

  const int c0 = tid * CPT;
  const bool thr_ok = c0 < Cp;          // Cp % CPT == 0: all or none of the columns
  const int j = blockIdx.x;
  const long long b0 = (long long)j * LANES;
  const long long rs = (long long)Cp * Bp;
  const bool rev = g.reverse != 0;
  const int step = rev ? -1 : 1;
  int* const drow = DIRTY ? g.dirty + (long long)j * Rp : nullptr;
  const unsigned* bits = DIRTY ? g.need_bits + (long long)j * ((Rp + 31) >> 5) : nullptr;
  const float4 inf4 = make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, CUDART_INF_F);

  // cur value of column c0 + i of row r, lanes 4h..4h+3: staged or in
  // device memory
  auto ld_cur = [&](int r, int slot, int i, int h) -> float4 {
    return staged ? ld_stage(tag, reinterpret_cast<const char*>(stage + slot * slot_f), c0 + i, h)
                  : ld4(d + r * rs + (long long)(c0 + i) * Bp + b0 + 4 * h);
  };
  // table s (0..2 cross, 3 a_fwd, 4 a_bwd) of row r from column c
  auto tab_src = [&](int s, int r, int c) -> const float* {
    return s < 3 ? cross + ((long long)r * 3 + s) * Cp + c
                 : (s == 3 ? af + r * af_rs + c : ab + r * ab_rs + c);
  };
  // this thread's CPT columns of table s of row r
  auto ld_tabs = [&](int s, int r, int slot, float (&x)[CPT]) {
    const float* t = staged ? stage + slot * slot_f + d_floats + (long long)s * Cp + c0
                            : tab_src(s, r, c0);
    #pragma unroll
    for (int ch = 0; ch < CPT / TV; ++ch) {
      if constexpr (TV == 4) {
        const float4 q = staged ? reinterpret_cast<const float4*>(t)[ch]
                                : __ldg(reinterpret_cast<const float4*>(t) + ch);
        x[4 * ch] = q.x; x[4 * ch + 1] = q.y; x[4 * ch + 2] = q.z; x[4 * ch + 3] = q.w;
      } else {
        #pragma unroll
        for (int e = 0; e < TV; ++e) x[ch * TV + e] = staged ? t[ch * TV + e] : __ldg(t + ch * TV + e);
      }
    }
  };
  // row r into stage `slot`, by thread 0: the field's boxes by TMA and the
  // three table rows by bulk copies (XL: and the row's lists into its
  // extended-lane slot: its header and its first entries, at most the cap,
  // their first entry and count read from the header of the row staged in
  // slot `from`, a neighbour of r, or from device memory where from < 0),
  // all counted on the slot's barrier
  auto load_row = [&](int r, int slot, int from) {
    float* base = stage + slot * slot_f;
    int xs = 0, xn = 0;
    if constexpr (XL) {
      if (from >= 0) {
        const int* h = reinterpret_cast<const int*>(xslot + from * xslot_f) + (rev ? 3 : 1);
        xs = h[0];
        xn = h[1];
      } else {
        const int* h = g.xl.goff + (long long)r * g.xl.gw;
        xs = __ldg(h);
        xn = xl_off_ldg(h, g.xl.ng);
      }
      xn = min((xn + 3) & ~3, xcap);
    }
    const unsigned xbytes = XL ? 4u * (unsigned)(g.xl.gw + 2 * xn) : 0u;
    mbar_expect_tx(mbar + slot, (unsigned)((d_floats + 5LL * Cp) * 4) + xbytes);
    for (int k = 0; k < n_boxes; ++k)
      tma_load(base + k * box_f, &tmap, (int)b0, k * boxc, r, mbar + slot);
    bulk_load(base + d_floats, cross + (long long)r * 3 * Cp, 12u * Cp, mbar + slot);
    bulk_load(base + d_floats + 3LL * Cp, af + r * af_rs, 4u * Cp, mbar + slot);
    bulk_load(base + d_floats + 4LL * Cp, ab + r * ab_rs, 4u * Cp, mbar + slot);
    if constexpr (XL) {
      // the row's extended-lane lists: header, then its first xn entries
      int* xb = reinterpret_cast<int*>(xslot + slot * xslot_f);
      bulk_load(xb, g.xl.goff + (long long)r * g.xl.gw, 4u * g.xl.gw, mbar + slot);
      if (xn > 0) {
        bulk_load(xb + g.xl.gw, g.xl.meta + xs, 4u * xn, mbar + slot);
        bulk_load(xb + g.xl.gw + xcap, g.xl.w + xs, 4u * xn, mbar + slot);
      }
    }
  };
  // cand of column i (8 lanes) from the carried row; the neighbours of a
  // thread's first and last column are its neighbour threads' columns
  auto cand_col = [&](int i, float x0, float x1, float x2, float (&cd)[LANES]) {
    const bool has_l = i > 0 || tid > 0;
    const bool has_r = i + 1 < CPT || c0 + CPT < Cp;
    #pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 L = has_l ? prev4[(i > 0 ? (2 * (i - 1) + h) * NT + tid
                                            : (2 * (CPT - 1) + h) * NT + tid - 1)]
                             : inf4;
      const float4 S = prev4[(2 * i + h) * NT + tid];
      const float4 R = has_r ? prev4[(i + 1 < CPT ? (2 * (i + 1) + h) * NT + tid
                                                  : h * NT + tid + 1)]
                             : inf4;
      cd[4 * h + 0] = fminf(fminf(L.x + x0, S.x + x1), R.x + x2);
      cd[4 * h + 1] = fminf(fminf(L.y + x0, S.y + x1), R.y + x2);
      cd[4 * h + 2] = fminf(fminf(L.z + x0, S.z + x1), R.z + x2);
      cd[4 * h + 3] = fminf(fminf(L.w + x0, S.w + x1), R.w + x2);
    }
  };
  // XL: this thread's entries of the row's list, [xe0, xe1), the staged
  // ones [xe0, xes) (the row's first xcap, from entry xbase, in its slot);
  // xcur: the next entry, from xe0 for each pass over the columns in order
  int xe0 = 0, xe1 = 0, xes = 0, xbase = 0, xcur = 0;
  // one extended-lane entry (meta m, weight wx) of column c into cd: the
  // carried rows' columns from shared memory, own-row columns from the
  // staged row or from row r in device memory
  auto relax_xl = [&](int m, float wx, int c, int r, int slot, float (&cd)[LANES]) {
    const int sel = xm_sel(m), cs = c + xm_dc(m);
    if (cs < 0 || cs >= Cp || sel > 2 || (sel == 2 && !two_rows)) return;
    const float4* p4 = sel == 1 ? prev4 : prev2_4;
    const int t = cs / CPT, ii = cs - t * CPT;
    #pragma unroll
    for (int h = 0; h < 2; ++h) {
      float4 X;
      if (sel != 0)
        X = p4[(2 * ii + h) * NT + t];
      else if (staged)
        X = ld_stage(tag, reinterpret_cast<const char*>(stage + slot * slot_f), cs, h);
      else
        X = ld4(d + r * rs + (long long)cs * Bp + b0 + 4 * h);
      cd[4 * h + 0] = fminf(cd[4 * h + 0], X.x + wx);
      cd[4 * h + 1] = fminf(cd[4 * h + 1], X.y + wx);
      cd[4 * h + 2] = fminf(cd[4 * h + 2], X.z + wx);
      cd[4 * h + 3] = fminf(cd[4 * h + 3], X.w + wx);
    }
  };
  // the extended-lane entries of column i into cd, from the cursor: the
  // staged ones (shared memory), then those past the cap (device memory),
  // up to the first entry past the column
  auto cand_xl = [&](int i, int r, int slot, float (&cd)[LANES]) {
    const int c = c0 + i;
    const int* xb = reinterpret_cast<const int*>(xslot + slot * xslot_f);
    for (; xcur < xes; ++xcur) {
      const int m = xb[g.xl.gw + xcur - xbase];
      if (xm_col(m) > c) return;                     // sorted by column
      if (xm_col(m) == c)
        relax_xl(m, reinterpret_cast<const float*>(xb)[g.xl.gw + xcap + xcur - xbase], c, r,
                 slot, cd);
    }
    for (; xcur < xe1; ++xcur) {
      const int m = __ldg(g.xl.meta + xcur);
      if (xm_col(m) > c) return;
      if (xm_col(m) == c) relax_xl(m, __ldg(g.xl.w + xcur), c, r, slot, cd);
    }
  };
  // cand of column i with the extended lanes (XL; the columns in order)
  auto cand_all = [&](int i, int r, int slot, float x0, float x1, float x2w,
                      float (&cd)[LANES]) {
    cand_col(i, x0, x1, x2w, cd);
    if constexpr (XL) cand_xl(i, r, slot, cd);
  };
  // the written row into the carry: over the row before (one carried row)
  // or over the second carried row, which then becomes the row before
  auto put_prev = [&](int i, const float (&v)[LANES]) {
    float4* nx4 = two_rows ? prev2_4 : prev4;
    nx4[(2 * i) * NT + tid] = make_float4(v[0], v[1], v[2], v[3]);
    nx4[(2 * i + 1) * NT + tid] = make_float4(v[4], v[5], v[6], v[7]);
  };
  // column i of row rr as memory holds it into carry p4 (+inf off the field)
  auto load_carry = [&](float4* p4, int rr) {
    if (!thr_ok) return;
    #pragma unroll
    for (int i = 0; i < CPT; ++i) {
      float v[LANES];
      if (rr >= 0 && rr < Rp) {
        load8(d + rr * rs + (long long)(c0 + i) * Bp + b0, v);
      } else {
        #pragma unroll
        for (int l = 0; l < LANES; ++l) v[l] = CUDART_INF_F;
      }
      p4[(2 * i) * NT + tid] = make_float4(v[0], v[1], v[2], v[3]);
      p4[(2 * i + 1) * NT + tid] = make_float4(v[4], v[5], v[6], v[7]);
    }
  };
  // partial depth: `nsteps` doubling steps a direction on the chain-weight
  // levels of row r, each on the row the step before published
  auto doubling_scan = [&](int r, float (&v)[CPT][LANES]) {
    for (int dir = 0; dir < 2; ++dir) {
      const float* a = dir == 0 ? af + r * af_rs : ab + r * ab_rs;
      for (int s = 0; s < nsteps; ++s) {
        if (thr_ok) {
          #pragma unroll
          for (int i = 0; i < CPT; ++i) {
            xb4[(2 * i) * NT + tid] = make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
            xb4[(2 * i + 1) * NT + tid] = make_float4(v[i][4], v[i][5], v[i][6], v[i][7]);
          }
        }
        __syncthreads();
        const int k = dir == 0 ? -(1 << s) : (1 << s);
        if (thr_ok) {
          #pragma unroll
          for (int i = 0; i < CPT; ++i) {
            const int cs = c0 + i + k;
            if (cs < 0 || cs >= Cp) continue;
            const float w = __ldg(a + (long long)s * Cp + c0 + i);
            const int t = cs / CPT, ii = cs - t * CPT;
            #pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float4 X = xb4[(2 * ii + h) * NT + t];
              v[i][4 * h + 0] = fminf(v[i][4 * h + 0], X.x + w);
              v[i][4 * h + 1] = fminf(v[i][4 * h + 1], X.y + w);
              v[i][4 * h + 2] = fminf(v[i][4 * h + 2], X.z + w);
              v[i][4 * h + 3] = fminf(v[i][4 * h + 3], X.w + w);
            }
          }
        }
        __syncthreads();
      }
    }
  };

  // staged: a written row goes back through its stage slot and leaves by
  // TMA at the top of the next row (thread 0 commits one bulk group a row,
  // so "all but the newest group" is the store of two rows ago)
  int store_row = -1, store_slot = 0;
  unsigned parity = 0;   // bit s: the parity of slot s's next phase
  auto wait_slot = [&](int slot) {
    mbar_wait(mbar + slot, (parity >> slot) & 1u);
    parity ^= 1u << slot;
  };
  auto store_pending = [&]() {   // thread 0
    if (store_row >= 0)
      for (int k = 0; k < n_boxes; ++k)
        tma_store(&tmap, (int)b0, k * boxc, store_row, stage + store_slot * slot_f + k * box_f);
    bulk_commit();
  };

  for (int q = 0; q < 2 * CPT * ncarry; ++q) smem4[q * NT + tid] = inf4;
  if (staged && tid == 0) {
    for (int k = 0; k < N_SLOTS; ++k) mbar_init(mbar + k);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  int r = rev ? Rp - 1 : 0;
  int slot = 0, staged_row = -1;
  bool carried = false;   // DIRTY: walk on (a carried row this pass wrote)
  bool last_need = false; // the row before was needed (two_rows: walk on)
  int changed = 0, n_walked = 0;
  int t_changed = 0;      // NOSKIP: this thread's scanned columns improved
  float* tf = tot;                         // forward totals
  float* tb = tot + MAX_WARPS * (1 + LANES);   // backward totals

  // Staged, a row runs: the store of the row before leaves, the next row's
  // load starts into the next stage, this row's stage is waited for.
  while (r >= 0 && r < Rp) {
    if (staged && tid == 0) store_pending();
    store_row = -1;
    if (DIRTY && !carried) {
      // the carry is memory's row before r: need(r) is the prescan's bit
      const int r2 = next_needed(bits, r, Rp, rev);
      if (r2 < 0) break;
      if (r2 != r) {
        // the carried rows: skipped rows or rows walked and not needed,
        // which memory holds
        load_carry(prev4, r2 - step);
        if (two_rows) load_carry(prev2_4, r2 - 2 * step);
        r = r2;
        last_need = false;
        __syncthreads();
      }
    }
    const int rn = r + step;
    const bool pre = staged && rn >= 0 && rn < Rp;   // prefetch the next row
    int next_flag = 0;
    const int nslot = slot + 1 == N_SLOTS ? 0 : slot + 1;
    if (staged) {
      // the stage of row r was loaded during the row before; the first row
      // and a jump load it here (after the load that is no longer wanted)
      if (staged_row != r) {
        if (staged_row >= 0) {
          // every thread has seen the unwanted prefetch's phase complete
          // before thread 0 arms the slot again: a thread that reached its
          // wait after that next phase had completed too would find the
          // barrier back at the parity it waits for and wait for ever
          wait_slot(slot);
          __syncthreads();
        }
        if (tid == 0) {
          bulk_wait_read<0>();
          load_row(r, slot, -1);
          if (DIRTY) sflag[slot] = drow[r];
        }
        __syncthreads();
      }
      // XL takes where the next row's list starts from this row's staged
      // header, so it waits for this row's stage before the prefetch; the
      // other modes wait after it, and the two loads overlap
      if constexpr (XL) wait_slot(slot);
      if (pre && tid == 0) {
        bulk_wait_read<1>();   // the store of two rows ago has left nslot
        load_row(rn, nslot, slot);
        if (DIRTY) next_flag = drow[rn];   // into the stage before the row ends
      }
      if constexpr (!XL) wait_slot(slot);
    }
    ++n_walked;
    if constexpr (XL) {
      if (thr_ok) {   // this thread's entries of the row's list
        const int k0 = c0 / XG, k1 = (c0 + CPT + XG - 1) / XG;
        if (staged) {
          const int* xb = reinterpret_cast<const int*>(xslot + slot * xslot_f);
          xbase = xb[0];
          xe0 = xbase + xl_off(xb, k0);
          xe1 = xbase + xl_off(xb, k1);
        } else {
          const int* head = g.xl.goff + (long long)r * g.xl.gw;
          xbase = __ldg(head);
          xe0 = xbase + xl_off_ldg(head, k0);
          xe1 = xbase + xl_off_ldg(head, k1);
        }
        xes = min(xe1, xbase + xcap);
      }
    }

    // cand, row0 and the flags
    float v[CPT][LANES];
    float x0[CPT], x1[CPT], x2[CPT];
    if (thr_ok) {
      ld_tabs(0, r, slot, x0);
      ld_tabs(1, r, slot, x1);
      ld_tabs(2, r, slot, x2);
    }
    int bitsf = 0;   // bit 0: imp, bit 1: fin
    xcur = xe0;
    #pragma unroll
    for (int i = 0; i < CPT; ++i) {
      #pragma unroll
      for (int l = 0; l < LANES; ++l) v[i][l] = CUDART_INF_F;
      if (thr_ok) {
        const float4 ca = ld_cur(r, slot, i, 0), cb = ld_cur(r, slot, i, 1);
        const float cur[LANES] = {ca.x, ca.y, ca.z, ca.w, cb.x, cb.y, cb.z, cb.w};
        float cd[LANES];
        cand_all(i, r, slot, x0[i], x1[i], x2[i], cd);
        #pragma unroll
        for (int l = 0; l < LANES; ++l) {
          v[i][l] = fminf(cur[l], cd[l]);
          bitsf |= below(cd[l], cur[l], k_rtol, atol);
          bitsf |= (v[i][l] < CUDART_INF_F) << 1;
        }
      }
    }

    // forward scan, in-thread and in-warp (before the block knows `need`)
    float A[CPT];
    #pragma unroll
    for (int i = 0; i < CPT; ++i) A[i] = 0.f;
    float ta = 0.f, tbv[LANES];
    if (exact) {
      if (thr_ok) ld_tabs(3, r, slot, A);
      #pragma unroll
      for (int i = 1; i < CPT; ++i) {
        #pragma unroll
        for (int l = 0; l < LANES; ++l) v[i][l] = fminf(v[i][l], v[i - 1][l] + A[i]);
        A[i] = A[i - 1] + A[i];
      }
      ta = A[CPT - 1];
      #pragma unroll
      for (int l = 0; l < LANES; ++l) tbv[l] = v[CPT - 1][l];
      #pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float ao = __shfl_up_sync(FULL_MASK, ta, off);
        #pragma unroll
        for (int l = 0; l < LANES; ++l) {
          const float bo = __shfl_up_sync(FULL_MASK, tbv[l], off);
          if (lane >= off) tbv[l] = fminf(tbv[l], bo + ta);
        }
        if (lane >= off) ta = ao + ta;
      }
    }
    const int wbits = __reduce_or_sync(FULL_MASK, bitsf);
    if (lane == 31) {
      if (exact) {
        tf[warp * (1 + LANES)] = ta;
        #pragma unroll
        for (int l = 0; l < LANES; ++l) tf[warp * (1 + LANES) + 1 + l] = tbv[l];
      }
      wflag[warp] = wbits;
    }
    __syncthreads();
    int fl = 0;
    for (int w = 0; w < nw; ++w) fl |= wflag[w];
    const int any_imp = fl & 1;
    const int dflag = DIRTY && mode == MODE_SKIP ? (staged ? sflag[slot] : drow[r]) : 0;
    const bool need = mode == MODE_NOSKIP || any_imp || dflag > 0 || (g.force && (fl & 2));
    if (mode != MODE_NOSKIP) changed |= any_imp;

    if (need) {
      if (nsteps > 0) {
        doubling_scan(r, v);
      } else if (exact) {
        // forward: scan of the warp totals (every warp alike) and the fold
        {
          float wa = lane < nw ? tf[lane * (1 + LANES)] : 0.f;
          float wb[LANES];
          #pragma unroll
          for (int l = 0; l < LANES; ++l)
            wb[l] = lane < nw ? tf[lane * (1 + LANES) + 1 + l] : CUDART_INF_F;
          for (int off = 1; off < nw; off <<= 1) {
            const float ao = __shfl_up_sync(FULL_MASK, wa, off);
            #pragma unroll
            for (int l = 0; l < LANES; ++l) {
              const float bo = __shfl_up_sync(FULL_MASK, wb[l], off);
              if (lane >= off) wb[l] = fminf(wb[l], bo + wa);
            }
            if (lane >= off) wa = ao + wa;
          }
          float P[LANES];   // the previous warps' prefix
          #pragma unroll
          for (int l = 0; l < LANES; ++l)
            P[l] = warp > 0 ? __shfl_sync(FULL_MASK, wb[l], warp - 1) : CUDART_INF_F;
          float bh[LANES];  // this thread's inclusive value over the block
          #pragma unroll
          for (int l = 0; l < LANES; ++l) bh[l] = warp > 0 ? fminf(tbv[l], P[l] + ta) : tbv[l];
          #pragma unroll
          for (int l = 0; l < LANES; ++l) {
            const float up = __shfl_up_sync(FULL_MASK, bh[l], 1);
            const float E = lane > 0 ? up : P[l];
            #pragma unroll
            for (int i = 0; i < CPT - 1; ++i) v[i][l] = fminf(v[i][l], E + A[i]);
            v[CPT - 1][l] = bh[l];
          }
        }
        // backward: the same from the right
        {
          #pragma unroll
          for (int i = 0; i < CPT; ++i) A[i] = 0.f;
          if (thr_ok) ld_tabs(4, r, slot, A);
          #pragma unroll
          for (int i = CPT - 2; i >= 0; --i) {
            #pragma unroll
            for (int l = 0; l < LANES; ++l) v[i][l] = fminf(v[i][l], v[i + 1][l] + A[i]);
            A[i] = A[i + 1] + A[i];
          }
          float ba = A[0], bb[LANES];
          #pragma unroll
          for (int l = 0; l < LANES; ++l) bb[l] = v[0][l];
          #pragma unroll
          for (int off = 1; off < 32; off <<= 1) {
            const float ao = __shfl_down_sync(FULL_MASK, ba, off);
            #pragma unroll
            for (int l = 0; l < LANES; ++l) {
              const float bo = __shfl_down_sync(FULL_MASK, bb[l], off);
              if (lane + off < 32) bb[l] = fminf(bb[l], bo + ba);
            }
            if (lane + off < 32) ba = ao + ba;
          }
          if (lane == 0) {
            tb[warp * (1 + LANES)] = ba;
            #pragma unroll
            for (int l = 0; l < LANES; ++l) tb[warp * (1 + LANES) + 1 + l] = bb[l];
          }
          __syncthreads();
          float wa = lane < nw ? tb[lane * (1 + LANES)] : 0.f;
          float wb[LANES];
          #pragma unroll
          for (int l = 0; l < LANES; ++l)
            wb[l] = lane < nw ? tb[lane * (1 + LANES) + 1 + l] : CUDART_INF_F;
          for (int off = 1; off < nw; off <<= 1) {
            const float ao = __shfl_down_sync(FULL_MASK, wa, off);
            #pragma unroll
            for (int l = 0; l < LANES; ++l) {
              const float bo = __shfl_down_sync(FULL_MASK, wb[l], off);
              if (lane + off < 32) wb[l] = fminf(wb[l], bo + wa);
            }
            if (lane + off < 32) wa = ao + wa;
          }
          float P[LANES];   // the following warps' suffix
          #pragma unroll
          for (int l = 0; l < LANES; ++l)
            P[l] = warp < nw - 1 ? __shfl_sync(FULL_MASK, wb[l], warp + 1) : CUDART_INF_F;
          float bh[LANES];
          #pragma unroll
          for (int l = 0; l < LANES; ++l) bh[l] = warp < nw - 1 ? fminf(bb[l], P[l] + ba) : bb[l];
          #pragma unroll
          for (int l = 0; l < LANES; ++l) {
            const float dn = __shfl_down_sync(FULL_MASK, bh[l], 1);
            const float E = lane < 31 ? dn : P[l];
            #pragma unroll
            for (int i = 1; i < CPT; ++i) v[i][l] = fminf(v[i][l], E + A[i]);
            v[0][l] = bh[l];
          }
        }
      }
      if (DIRTY && mode == MODE_DEFER) {
        // dirty = max(dirty_in, need): the up pass scans the row
        if (tid == 0) drow[r] = 1;
      } else if (DIRTY) {
        // base = row0, recomputed from the row and the carry (both still in
        // place); thread-padding columns are left out
        int simp = 0;
        if (thr_ok) {
          xcur = xe0;
          #pragma unroll
          for (int i = 0; i < CPT; ++i) {
            const float4 ca = ld_cur(r, slot, i, 0), cb = ld_cur(r, slot, i, 1);
            const float cur[LANES] = {ca.x, ca.y, ca.z, ca.w, cb.x, cb.y, cb.z, cb.w};
            float cd[LANES];
            cand_all(i, r, slot, x0[i], x1[i], x2[i], cd);
            #pragma unroll
            for (int l = 0; l < LANES; ++l)
              simp |= below(v[i][l], fminf(cur[l], cd[l]), k_rtol, atol);
          }
        }
        simp = __syncthreads_or(simp);   // also: every carry read is done before it is rewritten
        changed |= simp;
        if (tid == 0) drow[r] = simp;
      }
      if (thr_ok) {
        char* sd = reinterpret_cast<char*>(stage + slot * slot_f);
        #pragma unroll
        for (int i = 0; i < CPT; ++i) {
          float vs[LANES];   // the row as T stores it
          #pragma unroll
          for (int l = 0; l < LANES; ++l) vs[l] = stored<T>(v[i][l]);
          if (mode == MODE_NOSKIP) {
            const float4 ca = ld_cur(r, slot, i, 0), cb = ld_cur(r, slot, i, 1);
            const float cur[LANES] = {ca.x, ca.y, ca.z, ca.w, cb.x, cb.y, cb.z, cb.w};
            #pragma unroll
            for (int l = 0; l < LANES; ++l) t_changed |= below(v[i][l], cur[l], k_rtol, atol);
          }
          if (staged) {
            st_stage(tag, sd, c0 + i, 0, make_float4(vs[0], vs[1], vs[2], vs[3]));
            st_stage(tag, sd, c0 + i, 1, make_float4(vs[4], vs[5], vs[6], vs[7]));
          } else {
            store8(d + r * rs + (long long)(c0 + i) * Bp + b0, vs);
          }
          // NOSKIP carries the scanned row before it is rounded (:1048)
          if (mode == MODE_NOSKIP)
            put_prev(i, v[i]);
          else
            put_prev(i, vs);
        }
      }
      if (staged) {   // the TMA store reads what the threads wrote
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        store_row = r;
        store_slot = slot;
      }
    } else {
      if (DIRTY && mode == MODE_SKIP && tid == 0) drow[r] = 0;
      if (thr_ok) {
        float4* nx4 = two_rows ? prev2_4 : prev4;
        #pragma unroll
        for (int i = 0; i < CPT; ++i) {
          nx4[(2 * i) * NT + tid] = ld_cur(r, slot, i, 0);
          nx4[(2 * i + 1) * NT + tid] = ld_cur(r, slot, i, 1);
        }
      }
    }
    if (two_rows) {
      float4* t4 = prev4;
      prev4 = prev2_4;
      prev2_4 = t4;
    }
    if (staged) staged_row = pre ? rn : -1;
    if (DIRTY && pre && tid == 0) sflag[nslot] = next_flag;
    carried = need || (two_rows && last_need);
    last_need = need;
    slot = nslot;
    r += step;
    __syncthreads();
  }
  if (staged) {
    if (staged_row >= 0) wait_slot(slot);   // a prefetch no row took
    if (tid == 0) {
      store_pending();   // after the barrier that ended the last row
      bulk_wait_all();
    }
  }
  if (t_changed) atomicOr(g.chg, 1);
  if (tid == 0) {
    if (changed) atomicOr(g.chg, 1);
    if (g.walked != nullptr) atomicAdd(g.walked, n_walked);
  }
}

// columns a thread holds: the whole row in one warp up to 32 columns (the
// reference's flat scan), then 4 (8 warps at 1,024), then 8
int cols_per_thread(int Cp) { return Cp <= 32 ? 1 : (Cp <= 1024 ? 4 : 8); }

size_t walker_smem(int NT, int CPT, const Args& g, int esize) {
  const int nrows = (g.x2 ? 2 : 1) + (g.nsteps > 0 ? 1 : 0);
  if (!g.staged) return (size_t)stage_offset(NT * CPT, nrows) * sizeof(float);
  // slot_floats (and the extended-lane slots), and 1,024 bytes to align the stage
  const long long slot = slot_floats(g.Cp, g.n_boxes, g.boxc, esize);
  const long long xslot = g.xl.goff != nullptr ? xl_slot_floats(g.xl) : 0;
  return (size_t)(stage_offset(NT * CPT, nrows) + 256 + N_SLOTS * (slot + xslot)) *
         sizeof(float);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the [Rp, Cp, Bp] field as a 3-D tensor map with boxes of 8 lanes x boxc
// columns x 1 row: f32 with the 32-byte swizzle, bf16 (16-byte box rows)
// unswizzled; the encoder is looked up through the runtime
// (cudaGetDriverEntryPoint), so nothing links against libcuda
int field_map(CUtensorMap* m, void* d, int bf16_field, int Rp, int Cp, int Bp, int boxc) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult q;
    void* fn = nullptr;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
    if (err != cudaSuccess) return (int)err;
    if (q != cudaDriverEntryPointSuccess || fn == nullptr) return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t es = bf16_field ? 2 : 4;
  const cuuint64_t dims[3] = {(cuuint64_t)Bp, (cuuint64_t)Cp, (cuuint64_t)Rp};
  const cuuint64_t strides[2] = {(cuuint64_t)Bp * es, (cuuint64_t)Cp * Bp * es};
  const cuuint32_t box[3] = {LANES, (cuuint32_t)boxc, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = encode(
      m, bf16_field ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, d,
      dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      bf16_field ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_32B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename T, bool DIRTY, int CPT, bool XL>
int launch_walker(const Args& g, const CUtensorMap& m, int NT, size_t smem, cudaStream_t s) {
  auto kern = banded_pass_kernel<T, DIRTY, CPT, XL>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<g.Bp / LANES, NT, smem, s>>>(g, m);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_typed(T* d, const float* cross, const float* af, long long af_rs, const float* ab,
                 long long ab_rs, int* chg, int* dirty, unsigned* need_bits, int* walked,
                 const float* cutlb, const float* cutth, const int* seedrc, const XList& xl,
                 int x_maxrow, int x2, int Rp, int Cp, int Bp, int reverse, int force, int mode,
                 int nsteps, float k_rtol, float atol, cudaStream_t s) {
  const int CPT = cols_per_thread(Cp);
  const bool cut = cutlb != nullptr;
  const bool has_x = xl.goff != nullptr;
  if (dirty != nullptr) {
    const long long nq = (Cp + PRESCAN_THREADS - 1) / PRESCAN_THREADS;
    const long long n = (long long)((Rp + 31) / 32) * (Bp / LANES) * nq;
    if (n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const int dirty_need = mode == MODE_SKIP;
#define PRESCAN(CT, XT)                                                                      \
  banded_prescan_kernel<T, CT, XT><<<(unsigned)n, PRESCAN_THREADS, 0, s>>>(                  \
      d, cross, dirty, need_bits, cutlb, cutth, seedrc, xl, Rp, Cp, Bp, reverse, force,      \
      dirty_need, k_rtol, atol)
    if (cut) {
      if (has_x) PRESCAN(true, true); else PRESCAN(true, false);
    } else {
      if (has_x) PRESCAN(false, true); else PRESCAN(false, false);
    }
#undef PRESCAN
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int NT = ((Cp / CPT) + 31) / 32 * 32;
  const int boxc = Cp < 256 ? (Cp + 31) / 32 * 32 : 256;
  // NOSKIP walks every row with no table (the prescan above, if any, was
  // for the cut alone)
  const bool walk_dirty = dirty != nullptr && mode != MODE_NOSKIP;
  Args g = {d, cross, af, af_rs, ab, ab_rs, chg, walk_dirty ? dirty : nullptr,
            walk_dirty ? need_bits : nullptr, walked, Rp, Cp, Bp, reverse, force, 1, boxc,
            (Cp + boxc - 1) / boxc, k_rtol, atol, xl, x2, mode, nsteps};
  // staged: rows by TMA, at most 4 columns a thread (the tables' own layout)
  // and rows of whole 16-byte pieces; else rows read and written in place.
  // XL, staged: each stage's extended-lane slot takes the plan's fullest
  // row, or as many entries as the shared memory left holds
  g.staged = CPT <= 4 && Cp % 4 == 0;
  const int want_cap = (x_maxrow + 3) & ~3;
  g.xl.cap = !has_x ? 0 : (want_cap < XL_MAX_CAP ? want_cap : XL_MAX_CAP);
  size_t smem = walker_smem(NT, CPT, g, (int)sizeof(T));
  if (smem > MAX_SMEM && has_x) {
    g.xl.cap = 0;
    const size_t base = walker_smem(NT, CPT, g, (int)sizeof(T));
    if (base <= MAX_SMEM) g.xl.cap = (int)((MAX_SMEM - base) / (4 * 2 * N_SLOTS)) & ~3;
    smem = walker_smem(NT, CPT, g, (int)sizeof(T));
  }
  if (smem > MAX_SMEM) {
    g.staged = 0;
    g.xl.cap = 0;
    smem = walker_smem(NT, CPT, g, (int)sizeof(T));
    if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  }
  CUtensorMap m = {};
  if (g.staged) {
    const int err = field_map(&m, d, sizeof(T) == 2, Rp, Cp, Bp, boxc);
    if (err != 0) return err;
  }
#define WALK(DT, XT)                                                    \
  switch (CPT) {                                                        \
    case 1: return launch_walker<T, DT, 1, XT>(g, m, NT, smem, s);      \
    case 4: return launch_walker<T, DT, 4, XT>(g, m, NT, smem, s);      \
    case 8: return launch_walker<T, DT, 8, XT>(g, m, NT, smem, s);      \
  }
  if (walk_dirty) {
    if (has_x) {
      WALK(true, true)
    } else {
      WALK(true, false)
    }
  } else {
    if (has_x) {
      WALK(false, true)
    } else {
      WALK(false, false)
    }
  }
#undef WALK
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The kernel's limits, for the wrapper: the widest row, with two and with
// three rows in shared memory.
extern "C" int banded_pass_max_cols() { return MAX_COLS; }
extern "C" int banded_pass_max_cols_x2() { return MAX_COLS_X2; }
extern "C" int banded_pass_max_cols_x3() { return MAX_COLS_X3; }

// `d` is f32, or bf16 where `bf16_field` is set. `dirty` null: no dirty table
// (then `need_bits` null too); with it, `need_bits` is a zeroed
// [Bp / 8][ceil(Rp / 32)] uint32 table the prescan fills. `cutlb`, `cutth`,
// `seedrc` all null: no cut. A cut needs a dirty table: in NOSKIP a zeroed
// one, which only runs the prescan for the cut. `walked` (nullable) gains the
// rows the blocks walked. `n_x` extended lanes: `xl` holds (sel, dc) for each
// (host memory), `xgoff` / `xmeta` / `xw` their lists (XList; `xgoff` [Rp,
// x_gw] with x_gw = XL_HEAD + ceil((ceil(Cp / 4) + 1) / 2) rounded up to 4,
// `x_maxrow` the most entries of a row, at most 65,535). `mode`:
// MODE_SKIP, MODE_DEFER (needs the dirty table, nsteps 0) or MODE_NOSKIP;
// `nsteps` > 0: partial depth, that many levels of af / ab (rows of af_rs,
// levels of Cp).
extern "C" int banded_pass_launch(
    void* d, int bf16_field, const float* cross, const float* af, long long af_rs,
    const float* ab, long long ab_rs, int* chg, int* dirty, unsigned* need_bits, int* walked,
    const float* cutlb, const float* cutth, const int* seedrc,
    const int* xgoff, const int* xmeta, const float* xw, int x_gw, int x_maxrow, int n_x,
    const int* xl, int Rp, int Cp, int Bp, int reverse, int force, int mode, int nsteps,
    float k_rtol, float atol, void* stream) {
  if (Cp < 1 || Cp > MAX_COLS || Bp < LANES || Bp % LANES != 0 || Rp < 1)
    return (int)cudaErrorInvalidValue;
  if (Cp % cols_per_thread(Cp) != 0) return (int)cudaErrorInvalidValue;
  const bool cut = cutlb != nullptr;
  if (cut != (cutth != nullptr) || cut != (seedrc != nullptr) || (cut && dirty == nullptr) ||
      (dirty == nullptr) != (need_bits == nullptr))
    return (int)cudaErrorInvalidValue;
  if (mode < MODE_SKIP || mode > MODE_NOSKIP || nsteps < 0 ||
      (mode == MODE_DEFER && (dirty == nullptr || nsteps > 0)))
    return (int)cudaErrorInvalidValue;
  const unsigned long long al = (unsigned long long)d | (unsigned long long)cross |
                                (unsigned long long)af | (unsigned long long)ab;
  if (al % 16 != 0 || af_rs % 4 != 0 || ab_rs % 4 != 0 || af_rs < (long long)nsteps * Cp ||
      ab_rs < (long long)nsteps * Cp)
    return (int)cudaErrorInvalidValue;
  XList xs = {};
  int x2 = 0;
  if (n_x < 0 || n_x > MAX_XLANES ||
      (n_x > 0 && (xgoff == nullptr || xmeta == nullptr || xw == nullptr || xl == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (n_x > 0) {
    const int ng = (Cp + XG - 1) / XG;
    const unsigned long long xal = (unsigned long long)xgoff | (unsigned long long)xmeta |
                                   (unsigned long long)xw;
    if (x_gw != ((XL_HEAD + (ng + 2) / 2 + 3) & ~3) || x_maxrow < 0 || x_maxrow > 0xffff ||
        xal % 16 != 0)
      return (int)cudaErrorInvalidValue;
    xs.goff = xgoff;
    xs.meta = xmeta;
    xs.w = xw;
    xs.gw = x_gw;
    xs.ng = ng;
  }
  for (int i = 0; i < n_x; ++i) {
    const int sel = xl[2 * i], dc = xl[2 * i + 1];
    if (sel < 0 || sel > 2 || dc < -MAX_XDC || dc > MAX_XDC) return (int)cudaErrorInvalidValue;
    x2 |= sel == 2;
  }
  const int nrows = (x2 ? 2 : 1) + (nsteps > 0 ? 1 : 0);
  if (Cp > (nrows == 1 ? MAX_COLS : (nrows == 2 ? MAX_COLS_X2 : MAX_COLS_X3)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16_field)
    return launch_typed(reinterpret_cast<bf16*>(d), cross, af, af_rs, ab, ab_rs, chg, dirty,
                        need_bits, walked, cutlb, cutth, seedrc, xs, x_maxrow, x2, Rp, Cp, Bp,
                        reverse, force, mode, nsteps, k_rtol, atol, s);
  return launch_typed(reinterpret_cast<float*>(d), cross, af, af_rs, ab, ab_rs, chg, dirty,
                      need_bits, walked, cutlb, cutth, seedrc, xs, x_maxrow, x2, Rp, Cp, Bp,
                      reverse, force, mode, nsteps, k_rtol, atol, s);
}
