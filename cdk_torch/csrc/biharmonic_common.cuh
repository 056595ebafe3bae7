// Arithmetic shared by the biharmonic kernels (K1, K14-K19): one element's
// 16x16 operator applied to the 16 GLL values of one column, exact
// ("highest") or as bf16x3, in the one order their plain versions
// (operator.apply_operator) are held to.
//
// bf16x3 splits the operator and the column into bf16 hi/lo parts and sums
// the three f32 accumulations as (hi.v_hi + hi.v_lo) + lo.v_hi; each
// bf16 x bf16 product is exact in f32.
//
// Two forms of the apply:
//  - op_rows/apply: one thread holds one column and runs FMA chains (16
//    terms per output, in cuBLAS's order, so the exact forms are bit for bit
//    their plain versions).  The operator sits in shared memory as one plane
//    (exact, or the hi part) with the lo plane `lo_off` values further on,
//    read as warp-wide broadcasts; the compiler makes each four entries of a
//    row one 16-byte LDS.128 (two for f64).  K1 (both forms) and the exact
//    forms of K14-K19 use it, the DSS kernels with `exchange`, one assembly
//    pass through shared memory.
//  - tc::: bf16x3 on the tensor cores (mma.sync m16n8k16, bf16 operands,
//    f32 accumulators) for the bf16x3 forms of K14, the rowchain kernels
//    (K15-K18) and K19.  A warp owns one element and 16-column m-tiles of
//    the transposed product out^T (columns x points) = v^T (columns x 16) .
//    A^T.  Lane (g, t) =
//    (lane / 4, lane % 4) holds points 2t, 2t+1, 8+2t, 9+2t of columns g and
//    g+8 of each m-tile: that is the A fragment of the product and also the
//    layout of its accumulators, so a chain of applications stays in
//    registers with no shuffle (each result is split into bf16 hi/lo and fed
//    back, as FlashAttention feeds P into P.V).  The operator's B fragment
//    is two pairs of consecutive entries of one of its rows, 8 registers for
//    its hi and lo planes, loaded once from device memory.  Three products
//    run into three accumulators, summed in the plain version's order; the
//    tensor core sums the 16 products of one output in its own order, so the
//    result is held to the bf16x3 gate, not bit for bit to the plain
//    version.  A column's arithmetic never depends on the other columns of
//    its tile, so kernels built on it agree with each other bit for bit.
//    mma.sync, not wgmma: one element's 16 x 16 operator is far below a
//    warpgroup's 64-row tile.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>

namespace bih {

constexpr int NP = 4;
constexpr int NPTS = NP * NP;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// o = op.v
template <typename T, bool X3>
__device__ __forceinline__ void op_rows(const T* __restrict__ op, int lo_off,
                                        const T v[NPTS], T o[NPTS]) {
  if constexpr (X3) {
    float qh[NPTS], ql[NPTS];
#pragma unroll
    for (int p = 0; p < NPTS; ++p) {
      qh[p] = bf16_round(v[p]);
      ql[p] = bf16_round(v[p] - qh[p]);
    }
#pragma unroll
    for (int r = 0; r < NPTS; ++r) {
      float hh = 0.f, hl = 0.f, lh = 0.f;
#pragma unroll
      for (int p = 0; p < NPTS; ++p) {
        hh = fmaf(op[r * NPTS + p], qh[p], hh);
        hl = fmaf(op[r * NPTS + p], ql[p], hl);
        lh = fmaf(op[lo_off + r * NPTS + p], qh[p], lh);
      }
      o[r] = (hh + hl) + lh;
    }
  } else {
#pragma unroll
    for (int r = 0; r < NPTS; ++r) {
      T acc = T(0);
#pragma unroll
      for (int p = 0; p < NPTS; ++p) acc = fma(op[r * NPTS + p], v[p], acc);
      o[r] = acc;
    }
  }
}

// v <- op.v
template <typename T, bool X3>
__device__ __forceinline__ void apply(const T* op, int lo_off, T v[NPTS]) {
  // keep the operator's shared loads at their use: without this fence the
  // compiler hoists all 256 (or 512) of them out of a step loop and spills
  asm volatile("" ::: "memory");
  T o[NPTS];
  op_rows<T, X3>(op, lo_off, v, o);
#pragma unroll
  for (int p = 0; p < NPTS; ++p) v[p] = o[p];
}

// Stage operator entry l at plane0[i]: as it is, or (X3) its bf16 hi part
// there and its lo part at plane0[lo_off + i].
template <typename T, bool X3>
__device__ __forceinline__ void stage(T* plane0, int lo_off, int i, T l) {
  if constexpr (X3) {
    const T hi = bf16_round(l);
    plane0[i] = hi;
    plane0[lo_off + i] = bf16_round(l - hi);
  } else {
    plane0[i] = l;
  }
}

// One assembly pass over window element y, column x: the points P0 +
// k*STRIDE go to side0 and P3 + k*STRIDE to side3 (k < NP); then the P0
// points gain element lo's side3 values and the P3 points element hi's side0
// values (zeros where that neighbour is outside the window).
template <typename T, int P0, int P3, int STRIDE>
__device__ __forceinline__ void exchange(T v[NPTS], T* side0, T* side3, int x,
                                         int y, int tc, int lo, bool has_lo,
                                         int hi, bool has_hi) {
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    side0[(y * NP + k) * tc + x] = v[P0 + k * STRIDE];
    side3[(y * NP + k) * tc + x] = v[P3 + k * STRIDE];
  }
  __syncthreads();
  T from_lo[NP], from_hi[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    from_lo[k] = has_lo ? side3[(lo * NP + k) * tc + x] : T(0);
    from_hi[k] = has_hi ? side0[(hi * NP + k) * tc + x] : T(0);
  }
  __syncthreads();  // every read done before the next pass writes
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    v[P0 + k * STRIDE] += from_lo[k];
    v[P3 + k * STRIDE] += from_hi[k];
  }
}

namespace tc {

constexpr int MCOLS = 16;  // columns of one m-tile

// The point that lane group t holds at fragment slot q (q < 4): 2t, 2t+1,
// 8+2t, 9+2t.  A lane's state for one m-tile is x[r * 4 + q], point pt(t, q)
// of column g + 8r.
__device__ __forceinline__ int pt(int t, int q) { return 2 * t + (q & 1) + 8 * (q >> 1); }

// (x, y) split into bf16 hi and lo parts, each packed as a bf16x2 register
// (x in the low half, the element of the lower index, as mma reads it)
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The B fragment of A^T for the two n-tiles (output points 0-7, 8-15), hi
// and lo planes: hi[n][0] = A[8n+g][2t..2t+1], hi[n][1] = A[8n+g][2t+8..2t+9].
struct Op {
  uint32_t hi[2][2], lo[2][2];
};

// A: one row-major 16x16 operator in device memory, or null for zeros
__device__ __forceinline__ Op load_op(const float* __restrict__ A) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  Op f;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = (8 * n + g) * NPTS + 2 * t + 8 * h;
      split2(A ? A[i] : 0.f, A ? A[i + 1] : 0.f, f.hi[n][h], f.lo[n][h]);
    }
  }
  return f;
}

// d = a . b (m16n8k16, bf16 in, f32 out)
__device__ __forceinline__ void mma(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// x <- (A.x) for one m-tile of one warp, bf16x3:
// (A_hi.x_hi + A_hi.x_lo) + A_lo.x_hi
__device__ __forceinline__ void apply(const Op& A, float x[8]) {
  // A fragment: rows (columns) g, g+8 x k (points) 2t..2t+1, then 2t+8..2t+9
  uint32_t ah[4], al[4];
  split2(x[0], x[1], ah[0], al[0]);
  split2(x[4], x[5], ah[1], al[1]);
  split2(x[2], x[3], ah[2], al[2]);
  split2(x[6], x[7], ah[3], al[3]);
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    float hh[4], hl[4], lh[4];
    mma(hh, ah, A.hi[n]);
    mma(hl, al, A.hi[n]);
    mma(lh, ah, A.lo[n]);
    // accumulator (row g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1) of n-tile n
    x[2 * n] = (hh[0] + hl[0]) + lh[0];
    x[2 * n + 1] = (hh[1] + hl[1]) + lh[1];
    x[4 + 2 * n] = (hh[2] + hl[2]) + lh[2];
    x[5 + 2 * n] = (hh[3] + hl[3]) + lh[3];
  }
}

// The DSS j exchange in this layout: lanes t = 0, 2 hold j = 0 points (q =
// 0, 2), lanes t = 1, 3 the j = np-1 points (q = 1, 3), at i = t/2 and
// t/2 + 2.  put_jside writes this lane's boundary values of one m-tile to
// side[i * stride + col], col = c16 + 8r (c16: the m-tile's first column in
// the tile, plus g); add_jside adds the neighbour's (its other side) to them.
__device__ __forceinline__ void put_jside(const float x[8], float* side, int stride,
                                          int c16) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      side[((t >> 1) + 2 * h) * stride + c16 + 8 * r] =
          (t & 1) ? x[4 * r + 2 * h + 1] : x[4 * r + 2 * h];
}

__device__ __forceinline__ void add_jside(float x[8], const float* side, int stride,
                                          int c16) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v = side[((t >> 1) + 2 * h) * stride + c16 + 8 * r];
      if (t & 1)
        x[4 * r + 2 * h + 1] += v;
      else
        x[4 * r + 2 * h] += v;
    }
}

// The DSS i pass in this layout: lanes t = 0, 1 hold i = 0
// points (q = 0, 1: points 2t, 2t+1), lanes t = 2, 3 the i = np-1 points (q
// = 2, 3: points 8+2t, 9+2t), j = 2(t&1) + (q&1).  put_iside writes this
// lane's boundary values of one m-tile to side[row * stride + col], row =
// (t&1) + 2(q&1) (a fixed permutation of j that keeps one store's banks
// distinct), col = c16 + 8r; add_iside adds the neighbour's (its other side)
// to them.
__device__ __forceinline__ void put_iside(const float x[8], float* side, int stride,
                                          int c16) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      side[((t & 1) + 2 * h) * stride + c16 + 8 * r] = (t >> 1) ? x[4 * r + 2 + h]
                                                                 : x[4 * r + h];
}

__device__ __forceinline__ void add_iside(float x[8], const float* side, int stride,
                                          int c16) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v = side[((t & 1) + 2 * h) * stride + c16 + 8 * r];
      if (t >> 1)
        x[4 * r + 2 + h] += v;
      else
        x[4 * r + h] += v;
    }
}

}  // namespace tc

// Asynchronous copies of one BYTES-sized (4 or 8) value from device to
// shared memory (cp.async, zero fill where !valid), so a warp loads its
// next tile while it computes this one.  cp_async_wait: every copy this
// thread issued has landed.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
               "n"(BYTES), "r"(valid ? BYTES : 0));
}

// 16 bytes (both addresses 16-byte aligned), past the L1
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace bih
