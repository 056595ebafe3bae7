// K3g: the CKE edge flux of a whole tracer group in one launch, each tile of
// consecutive edges staging its distinct stencil rows in shared memory.
//
// The group form of K3 (csrc/cke_rows.cu, variant pallas_rows); it replaces
// no TPU kernel (the JAX package runs its step once a tracer).  K3 reads the
// edge fields once a tracer and gathers each of the E * A slot rows from L2,
// so a tracer costs its gathered rows at L2's rate however it is tuned.
//
// Bound on this card: every tracer's table, the cell mask, the edge fields
// and the connectivity read once, the (T, E, K) flux written once: 7.77 GB a
// step at the cell mpaso.tracers' 32 tracers x 711,504 edges x 237,168 cells
// x 60 levels in f32, 2.32 ms at 3.35 TB/s.  The bitwise form (a product,
// then a sum, never an FMA) issues ~46 instructions per (tracer, edge,
// level), ~2.4 ms at one instruction a clock on each of the 528 schedulers.
//
// Design (kernels/cke/group.py builds the tile map it reads): a block owns a
// tile of consecutive edges; each thread takes two 16-byte level groups of
// one edge, g and g + lanes (lanes for half an edge's groups, rounded so the
// eight 16-byte reads of a quarter warp fall in one row), which share the
// edge's slot places and coefficients, held in registers with ntf * advMask
// and sign(ntf) * coef3 of both groups.  The tile's distinct cells' rows are
// its stage, up to CARRY vectors a thread: each thread copies its vectors of
// a tracer's table with cp.async (L2 evict_last: the halo rows the
// neighbouring tiles copy again stay in L2) into a ring of RING stages, and
// its vectors' cellMask rows once into a stage of their own.  Once its
// copies of a tracer have landed a thread multiplies them in place by their
// cellMask values (__fmul_rn: tracer * cellMask bit for bit) and arrives on
// the stage's `full` mbarrier; a thread computes a tracer after that
// barrier's phase completes and then arrives on its `empty` mbarrier, which
// a stage's next copies wait for.  No block-wide barrier a tracer: a warp
// runs up to LAG tracers ahead of the slowest, the next RING - LAG tracers'
// copies in flight.  The tracer loop is unrolled by RING, so each stage's
// place is an immediate offset of the slot rows' shared-memory addresses.
// Compute: each group's slot rows read from the stage by their places and
// accumulated in slot order, a product, then a sum, from zero, then
// (ntf * advMask) * (s1 + (sign * coef3) * s3), which is K3's
// (ntf * advMask) * (s1 + (coef3 * s3) * sign) bit for bit since rounding is
// symmetric in sign.  The flux is stored evict-first.  A ragged nvert (not a
// multiple of W) copies and stores its levels one by one, the padded levels
// of a stage zeros that no output uses.  Two blocks an SM, so one block's
// set-up overlaps the other's tracers.  On the H100 at the cell's size it
// reads about 60 % of its bytes' bound; what bounds it is not measured (the
// issue of the bitwise form's products and sums is a guess); the
// variants tried on the way (a block-wide barrier a tracer, one level group
// a thread, other block sizes, rings and lags) are in PERF.md.

#include "cke_common.cuh"

namespace {

constexpr int THREADS = 256;   // a block's threads, two level groups of an edge each
constexpr int BLOCKS = 2;      // blocks an SM holds, so one's set-up overlaps the other's work
constexpr int CARRY = 4;       // stage vectors (16 bytes) a thread copies for each tracer
constexpr int MAX_SLOTS = 10;  // an edge's slots, held in registers
constexpr int RING = 5;        // stages of tracers, in flight or computing
constexpr int LAG = 2;         // a stage is refilled LAG tracers after it was read, so a warp
                               // may run up to LAG tracers ahead of the slowest
constexpr int STAGE = CARRY * THREADS * 16;  // bytes of a stage: the widest a tile may take
constexpr int SMEM = (RING + 1) * STAGE;  // the stages, then the tile's cellMask rows
static_assert(RING >= LAG + 2, "a tracer's copies need a stage of their own to land in");

// threads an edge takes (kernels/cke/group.py's edge_lanes): its level groups
// rounded up to a power of two up to 8, else to a multiple of 8
__host__ __device__ inline int edge_lanes(int groups) {
  if (groups <= 8) {
    int l = 1;
    while (l < groups) l <<= 1;
    return l;
  }
  return (groups + 7) / 8 * 8;
}

// levels k0 .. k0+W-1 of a row at a (the row's level k0) copied to shared
// memory at dst (16-byte aligned) with cp.async, kept in L2; a ragged row's
// levels one by one, zeros past nvert
template <typename T, bool VEC>
__device__ __forceinline__ void cp_row(unsigned dst, const T* a, int k0, int nvert, uint64_t pol) {
  constexpr int W = cke::Pack<T>::W;
  if (VEC) {
    asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(a), "l"(pol)
                 : "memory");
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int n = k0 + w < nvert ? static_cast<int>(sizeof(T)) : 0;
      asm volatile("cp.async.ca.shared.global.L2::cache_hint [%0], [%1], %2, %3, %4;\n" ::"r"(
                       dst + w * static_cast<unsigned>(sizeof(T))),
                   "l"(n ? a + w : a), "n"(sizeof(T)), "r"(n), "l"(pol)
                   : "memory");
    }
  }
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// every copy this thread committed but the last N groups has landed
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// an mbarrier of shared memory at addr: count arrivals complete a phase
__device__ __forceinline__ void bar_init(unsigned addr, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(addr), "r"(count) : "memory");
}

// this thread's arrival (release: its shared-memory writes before it are
// seen by a thread whose wait it completes)
__device__ __forceinline__ void bar_arrive(unsigned addr) {
  asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(addr)
               : "memory");
}

// until the phase of the given parity has completed (acquire)
__device__ __forceinline__ void bar_wait(unsigned addr, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// NADV: the slots an edge has where the launch knows them (MAX_SLOTS, the
// mesh's stencil: no test a slot), else 0 and nadv at run time
template <typename T, bool VEC, int NADV>
__global__ void __launch_bounds__(THREADS, BLOCKS)
cke_group_kernel(const short* __restrict__ local, const int* __restrict__ tcells,
                 const int* __restrict__ tcount, const T* __restrict__ c1,
                 const T* __restrict__ c3, const T* __restrict__ tracers,
                 const T* __restrict__ mask, const T* __restrict__ ntf,
                 const T* __restrict__ advm, T* __restrict__ out, int ntracers,
                 int nedges, int ncells, int nadv, int nvert, int tile, int width,
                 T coef3) {
  constexpr int W = cke::Pack<T>::W;
  extern __shared__ __align__(16) unsigned char smem[];
  // per stage: `full`, every thread's vectors of its tracer copied and
  // masked; `empty`, every thread done reading it
  __shared__ __align__(8) unsigned long long bars[2 * RING];
  const unsigned full = static_cast<unsigned>(__cvta_generic_to_shared(bars));
  const unsigned empty = full + RING * 8;
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2 * RING; ++b) bar_init(full + b * 8, THREADS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int na = NADV ? NADV : nadv;
  const int groups = (nvert + W - 1) / W;
  const int pitch = groups * 16;  // bytes of a staged row, in whole vectors
  const size_t table = static_cast<size_t>(ncells) * nvert;
  const size_t flux = static_cast<size_t>(nedges) * nvert;
  const long long e0 = static_cast<long long>(blockIdx.x) * tile;
  const int ne = static_cast<int>(min(static_cast<long long>(tile), nedges - e0));
  const int nvec = tcount[blockIdx.x] * groups;
  const int* const cells = tcells + static_cast<size_t>(blockIdx.x) * width;
  const uint64_t pol = cke::keep_policy();
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(smem));

  // the stage vectors this thread copies, v = threadIdx.x + j * THREADS:
  // level group v % groups of the tile's cell v / groups; the next tracer's
  // row to copy, and its cellMask values copied once to the same place of
  // the mask stage (with the first tracer's copies); read up to the map's
  // width, padded with cell 0, so that no load waits for the tile's count
  const T* src[CARRY];
  int lev[CARRY];
#pragma unroll
  for (int j = 0; j < CARRY; ++j) {
    const int v = threadIdx.x + j * THREADS;
    if (v < width * groups) {
      const int r = v / groups;
      lev[j] = (v - r * groups) * W;
      const size_t at = static_cast<size_t>(cells[r]) * nvert + lev[j];
      cp_row<T, VEC>(base + RING * STAGE + v * 16, mask + at, lev[j], nvert, pol);
      src[j] = tracers + at;
    }
  }
  // the next tracer not yet asked for into stage `slot`, one commit group a
  // tracer (an empty one past the last, so the groups stay one a tracer)
  int asked = 0;
  auto fetch = [&](int slot) {
    if (asked < ntracers) {
#pragma unroll
      for (int j = 0; j < CARRY; ++j) {
        const int v = threadIdx.x + j * THREADS;
        if (v < nvec) {
          cp_row<T, VEC>(base + slot * STAGE + v * 16, src[j], lev[j], nvert, pol);
          src[j] += table;
        }
      }
    }
    ++asked;
    cp_commit();
  };
  // this thread's vectors of the tracer in stage `slot`, once its copies
  // have landed: each value times its cellMask value, in place
  auto mask_stage = [&](int slot) {
#pragma unroll
    for (int j = 0; j < CARRY; ++j) {
      const int v = threadIdx.x + j * THREADS;
      if (v < nvec) {
        cke::Pack<T>& p = *reinterpret_cast<cke::Pack<T>*>(smem + slot * STAGE + v * 16);
        const cke::Pack<T> m =
            *reinterpret_cast<const cke::Pack<T>*>(smem + RING * STAGE + v * 16);
#pragma unroll
        for (int w = 0; w < W; ++w) p.v[w] = cke::mul(p.v[w], m.v[w]);
      }
    }
    bar_arrive(full + slot * 8);
  };
#pragma unroll
  for (int s = 0; s < RING - LAG; ++s) fetch(s);

  // this thread's two (edge, level group) pairs: level groups g and
  // g + lanes of one edge, which share its slot places and coefficients
  const int lanes = edge_lanes((groups + 1) / 2);
  const int el = threadIdx.x / lanes;
  const int k0 = (threadIdx.x - el * lanes) * W;
  const int k1 = k0 + lanes * W;
  const int half = lanes * 16;  // bytes from the first group to the second in a row
  const bool mine = el < ne && k0 < nvert;
  const bool both = el < ne && k1 < nvert;
  const unsigned char* row[MAX_SLOTS];  // its slot rows in stage 0
  T a1[MAX_SLOTS], a3[MAX_SLOTS];
  cke::Pack<T> wgt[2], csg[2];  // ntf * advMask, sign(ntf) * coef3, each group
  T* dst = out;
  if (mine) {
    const size_t e = static_cast<size_t>(e0 + el);
#pragma unroll
    for (int i = 0; i < MAX_SLOTS; ++i) {
      if (i < na) {
        row[i] = smem + __ldcs(local + e * na + i) * pitch + k0 * static_cast<int>(sizeof(T));
        a1[i] = __ldcs(c1 + e * na + i);
        a3[i] = __ldcs(c3 + e * na + i);
      }
    }
    const size_t o = e * nvert + k0;
    dst = out + o;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = h ? k1 : k0;
      const size_t at = h ? o + lanes * W : o;
      cke::Pack<T> n, m;
      if (VEC && (h == 0 || both)) {
        n = cke::ld_stream(ntf + at);
        m = cke::ld_stream(advm + at);
      } else {
#pragma unroll
        for (int w = 0; w < W; ++w) {
          n.v[w] = k + w < nvert ? __ldcs(ntf + at + w) : T(0);
          m.v[w] = k + w < nvert ? __ldcs(advm + at + w) : T(0);
        }
      }
#pragma unroll
      for (int w = 0; w < W; ++w) {
        wgt[h].v[w] = cke::mul(n.v[w], m.v[w]);
        csg[h].v[w] = n.v[w] >= T(0) ? coef3 : -coef3;
      }
    }
  }
  cp_wait<RING - LAG - 1>();
  mask_stage(0);

  // the tracers RING at a time, so each stage's place is a constant; tracer
  // t = t0 + s lies in stage s, whose barriers are in phase t0 / RING
  for (int t0 = 0; t0 < ntracers; t0 += RING) {
    const unsigned ph = (t0 / RING) & 1;
#pragma unroll
    for (int s = 0; s < RING; ++s) {
      const int t = t0 + s;
      if (t >= ntracers) break;
      // this thread's share of the next tracer, whose copies were asked for
      // RING - LAG - 1 tracers ago
      if (t + 1 < ntracers) {
        cp_wait<RING - LAG - 2>();
        mask_stage((s + 1) % RING);
      }
      // tracer t + RING - LAG into the stage of tracer t - LAG, once every
      // thread has read it
      const int q = (s + RING - LAG) % RING;
      if (t >= LAG && t + RING - LAG < ntracers) bar_wait(empty + q * 8, s >= LAG ? ph : ph ^ 1);
      fetch(q);
      bar_wait(full + s * 8, ph);
      if (mine) {
        // both groups' sums (the second's read past a row's end where this
        // thread has no second group: within shared memory, never stored)
        cke::Pack<T> s1[2], s3[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int w = 0; w < W; ++w) s1[h].v[w] = s3[h].v[w] = T(0);
        }
#pragma unroll
        for (int i = 0; i < MAX_SLOTS; ++i) {
          if (i < na) {
            const unsigned char* const at = row[i] + s * STAGE;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const cke::Pack<T> g = *reinterpret_cast<const cke::Pack<T>*>(at + h * half);
#pragma unroll
              for (int w = 0; w < W; ++w) {
                s1[h].v[w] = cke::add(s1[h].v[w], cke::mul(a1[i], g.v[w]));
                s3[h].v[w] = cke::add(s3[h].v[w], cke::mul(a3[i], g.v[w]));
              }
            }
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (h == 0 || both) {
            cke::Pack<T> r;
#pragma unroll
            for (int w = 0; w < W; ++w)
              r.v[w] = cke::mul(wgt[h].v[w],
                                cke::add(s1[h].v[w], cke::mul(csg[h].v[w], s3[h].v[w])));
            T* const d = h ? dst + lanes * W : dst;
            const int k = h ? k1 : k0;
            if (VEC) {
              cke::st_stream(d, r);
            } else {
#pragma unroll
              for (int w = 0; w < W; ++w) {
                if (k + w < nvert) __stcs(d + w, r.v[w]);
              }
            }
          }
        }
        dst += flux;
      }
      bar_arrive(empty + s * 8);
    }
  }
}

template <typename T, bool VEC>
auto* kernel_for(int nadv) {
  return nadv == MAX_SLOTS ? &cke_group_kernel<T, VEC, MAX_SLOTS> : &cke_group_kernel<T, VEC, 0>;
}

template <typename T>
int launch(const void* local, const void* tcells, const void* tcount, const void* c1,
           const void* c3, const void* tracers, const void* mask, const void* ntf,
           const void* advm, void* out, int ntracers, int nedges, int ncells, int nadv,
           int nvert, int tile, int width, double coef3, void* stream) {
  constexpr int W = cke::Pack<T>::W;
  const int groups = (nvert + W - 1) / W;
  if (ntracers < 1 || nedges < 1 || tile < 1 || width < 1 || nadv < 1 || nadv > MAX_SLOTS ||
      tile * edge_lanes((groups + 1) / 2) > THREADS ||
      static_cast<long long>(width) * groups > CARRY * THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = nvert % W == 0 && cke::aligned16(tracers) && cke::aligned16(mask) &&
                   cke::aligned16(ntf) && cke::aligned16(advm) && cke::aligned16(out);
  auto* kernel = vec ? kernel_for<T, true>(nadv) : kernel_for<T, false>(nadv);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((nedges + tile - 1) / tile);
  kernel<<<blocks, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const short*>(local), static_cast<const int*>(tcells),
      static_cast<const int*>(tcount), static_cast<const T*>(c1), static_cast<const T*>(c3),
      static_cast<const T*>(tracers), static_cast<const T*>(mask), static_cast<const T*>(ntf),
      static_cast<const T*>(advm), static_cast<T*>(out), ntracers, nedges, ncells, nadv,
      nvert, tile, width, static_cast<T>(coef3));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// local (E, A) int16, the slot's place in its tile's list; tcells (ntiles,
// width) and tcount (ntiles,) int32, each tile's distinct cells (in [0, C))
// and how many; c1, c3 (E, A); tracers (T, C, K); mask (C, K); ntf, advm
// (E, K); out (T, E, K); all contiguous on one device; tiles of `tile`
// consecutive edges.  coef3 is a value of the working type.  Returns
// cudaErrorInvalidValue for a map the kernel does not take, else
// cudaGetLastError() after the launch.
int cdk_cke_group_f32(const void* local, const void* tcells, const void* tcount,
                      const void* c1, const void* c3, const void* tracers, const void* mask,
                      const void* ntf, const void* advm, void* out, int ntracers, int nedges,
                      int ncells, int nadv, int nvert, int tile, int width, double coef3,
                      void* stream) {
  return launch<float>(local, tcells, tcount, c1, c3, tracers, mask, ntf, advm, out, ntracers,
                       nedges, ncells, nadv, nvert, tile, width, coef3, stream);
}

int cdk_cke_group_f64(const void* local, const void* tcells, const void* tcount,
                      const void* c1, const void* c3, const void* tracers, const void* mask,
                      const void* ntf, const void* advm, void* out, int ntracers, int nedges,
                      int ncells, int nadv, int nvert, int tile, int width, double coef3,
                      void* stream) {
  return launch<double>(local, tcells, tcount, c1, c3, tracers, mask, ntf, advm, out, ntracers,
                        nedges, ncells, nadv, nvert, tile, width, coef3, stream);
}

}  // extern "C"
