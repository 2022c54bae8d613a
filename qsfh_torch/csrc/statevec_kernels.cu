// Statevector kernels for Hopper (sm_90a): the hot path of the ADAPT-VQE
// train step and operator selection.
//
// Layout: the state is a flat complex64 vector of 2^n amplitudes, one
// float2 (re, im) per amplitude, qubit q on flat-index bit n-1-q.  A Pauli
// term is (x, z) flat masks plus per-term scalars; its action is
//     P psi[b] = ph * s(b) * psi[b ^ x],   s(b) = (-1)^popcount(b & z),
// with ph = (phre, phim) the string phase (-i)^popcount(x & z) for
// rotations, or folded into a complex coefficient c for sums of terms.
//
// The TPU kernels these replace (qsfh_tpu/engine/pallas_kernels.py) kept
// the state resident in VMEM and built psi[b ^ x] from permutation matmuls
// because Mosaic has no gather; here psi[b ^ x] is a plain load and the
// parity is __popc.  An 18-qubit state is 2 MiB and stays in the 50 MB L2
// across launches, so the simple one-launch-per-term designs of the first
// four kernels are bound by launch latency and L2 bandwidth, not by HBM.
// From 19 qubits on (a 24-qubit state is 128 MiB) every launch streams the
// state from HBM, and the last three kernels organise the work against it:
// runs of tile-local rotations chained in shared memory, one state pass
// per run, and inner products grouped by flip mask, one pass per group.
//
// Plain C interface (loaded with ctypes by qsfh_torch/engine/kernels.py):
// every entry point enqueues on the given stream, allocates nothing, and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // threads per block, every kernel
constexpr int kInnerPerThread = 8;   // amplitudes per thread in pauli_inner
constexpr int kApplyTile = 256;      // terms staged per shared-memory tile
constexpr int kMaxGridY = 65535;
constexpr int kRunThreads = 1024;     // threads per block, the local-run kernels
constexpr int kGroupThreads = 256;    // threads per block, pauli_inner_grouped
constexpr int kGroupAmps = 16;        // amplitudes per thread per batch (flat bits 8-11)
constexpr int kGroupSpanBits = 14;    // amplitudes per pauli_inner_grouped block: 2^14
constexpr int kMaxGroupTerms = 256;   // terms of one group per block: streaming.MAX_GROUP_TERMS
constexpr size_t kMaxDynamicSmem = 232448;  // Hopper's opt-in shared memory per block

// kParity4[m] bit k = popcount(k & m) & 1, for the 4-bit masks m
__constant__ uint16_t kParity4[16] = {
    0x0000, 0xaaaa, 0xcccc, 0x6666, 0xf0f0, 0x5a5a, 0x3c3c, 0x9696,
    0xff00, 0x55aa, 0x33cc, 0x9966, 0x0ff0, 0xa55a, 0xc33c, 0x6996};

__device__ __forceinline__ float parity_sign(uint32_t b, uint32_t z) {
  return (__popc(b & z) & 1) ? -1.0f : 1.0f;
}

// i with a zero bit inserted at position p
__device__ __forceinline__ uint32_t insert_zero_bit(uint32_t i, int p) {
  const uint32_t low = i & ((1u << p) - 1u);
  return ((i >> p) << (p + 1)) | low;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// conj(a) * b
__device__ __forceinline__ float2 cdot(float2 a, float2 b) {
  return make_float2(a.x * b.x + a.y * b.y, a.x * b.y - a.y * b.x);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 warp_sum(float2 v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, off);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, off);
  }
  return v;
}

// Sum over the block in a fixed order; the result is valid in thread 0.
// Every thread of the block must call it.
__device__ float2 block_sum(float2 v) {
  __shared__ float2 warp_part[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  const int n_warps = blockDim.x >> 5;
  v = (threadIdx.x < n_warps) ? warp_part[lane] : make_float2(0.0f, 0.0f);
  if (warp == 0) v = warp_sum(v);
  return v;
}

// ---------------------------------------------------------------------------
// pauli_rotation: psi <- exp(-i angle_t P_t) psi for ONE term t, in place.
//
// Replaces the per-term body of pauli_chain_pallas
// (qsfh_tpu/engine/pallas_kernels.py:421-538).  Each thread owns the pair
// (b, b ^ x) where b has the pivot bit (highest set bit of x) clear, reads
// both amplitudes and writes both, so the in-place update has no race.  For
// x = 0 (the RZ terms of the Givens diagonal) the update is diagonal and
// each thread owns the two amplitudes i and i + 2^(n-1).  Per-term scalars
// are read on the device by term index, so the angles never sync to the
// host.  Bound: 2 x 2 MiB of traffic per term at n = 18 (L2-resident), and
// in practice the launch latency; the launch loop runs in C.
// ---------------------------------------------------------------------------
__global__ void pauli_rotation_kernel(float2* __restrict__ psi, uint32_t half,
                                      const int32_t* __restrict__ xs,
                                      const int32_t* __restrict__ zs,
                                      const float* __restrict__ angles,
                                      const float* __restrict__ phre,
                                      const float* __restrict__ phim, int t) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= half) return;
  const uint32_t x = static_cast<uint32_t>(xs[t]);
  const uint32_t z = static_cast<uint32_t>(zs[t]);
  float sn, c;
  sincosf(angles[t], &sn, &c);
  // -i * sin * ph
  const float2 m = make_float2(sn * phim[t], -sn * phre[t]);
  if (x == 0u) {
    const uint32_t b0 = i, b1 = i + half;
    const float2 u = psi[b0], v = psi[b1];
    const float2 mu = cmul(m, u), mv = cmul(m, v);
    const float s0 = parity_sign(b0, z), s1 = parity_sign(b1, z);
    psi[b0] = make_float2(c * u.x + s0 * mu.x, c * u.y + s0 * mu.y);
    psi[b1] = make_float2(c * v.x + s1 * mv.x, c * v.y + s1 * mv.y);
    return;
  }
  const int pivot = 31 - __clz(x);
  const uint32_t b = insert_zero_bit(i, pivot);
  const uint32_t bx = b ^ x;
  const float2 u = psi[b], v = psi[bx];
  const float2 mv = cmul(m, v), mu = cmul(m, u);
  const float sb = parity_sign(b, z), sbx = parity_sign(bx, z);
  psi[b] = make_float2(c * u.x + sb * mv.x, c * u.y + sb * mv.y);
  psi[bx] = make_float2(c * v.x + sbx * mu.x, c * v.y + sbx * mu.y);
}

// ---------------------------------------------------------------------------
// adjoint_rotation: one reversed term of the adjoint sweep, in place.
//
// Replaces the per-term body of adjoint_chain_pallas
// (qsfh_tpu/engine/pallas_kernels.py:763-893).  Each thread owns the pair
// (b, b ^ x) as in pauli_rotation.  It adds its share of <lam | P psi>
// (the post-gate state, read before any write) to a block partial, then
// rotates both carriers by exp(+i angle P).  Block partials land in
// partials[blockIdx.x]; reduce_partials_kernel sums them per term in a
// fixed order (no float atomics, deterministic).  Bound: 4 x 2 MiB of
// L2-resident traffic per term at n = 18, and the launch latency.
// ---------------------------------------------------------------------------
__global__ void adjoint_rotation_kernel(float2* __restrict__ psi,
                                        float2* __restrict__ lam, uint32_t half,
                                        const int32_t* __restrict__ xs,
                                        const int32_t* __restrict__ zs,
                                        const float* __restrict__ angles,
                                        const float* __restrict__ phre,
                                        const float* __restrict__ phim, int t,
                                        float2* __restrict__ partials) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  float2 share = make_float2(0.0f, 0.0f);
  if (i < half) {
    const uint32_t x = static_cast<uint32_t>(xs[t]);
    const uint32_t z = static_cast<uint32_t>(zs[t]);
    float sn, c;
    sincosf(angles[t], &sn, &c);
    const float2 ph = make_float2(phre[t], phim[t]);
    uint32_t b0, b1;
    if (x == 0u) {
      b0 = i;
      b1 = i + half;
    } else {
      b0 = insert_zero_bit(i, 31 - __clz(x));
      b1 = b0 ^ x;
    }
    const float s0 = parity_sign(b0, z), s1 = parity_sign(b1, z);
    const float2 p0 = psi[b0], p1 = psi[b1];
    const float2 l0 = lam[b0], l1 = lam[b1];
    // P psi and P lam at b0 / b1: the partner is b1 / b0 unless x = 0
    const float2 pp0 = cmul(ph, x ? p1 : p0), pp1 = cmul(ph, x ? p0 : p1);
    const float2 pl0 = cmul(ph, x ? l1 : l0), pl1 = cmul(ph, x ? l0 : l1);
    const float2 Pp0 = make_float2(s0 * pp0.x, s0 * pp0.y);
    const float2 Pp1 = make_float2(s1 * pp1.x, s1 * pp1.y);
    const float2 Pl0 = make_float2(s0 * pl0.x, s0 * pl0.y);
    const float2 Pl1 = make_float2(s1 * pl1.x, s1 * pl1.y);
    share = cadd(cdot(l0, Pp0), cdot(l1, Pp1));
    // exp(+i angle P) v = cos * v + i sin * P v
    psi[b0] = make_float2(c * p0.x - sn * Pp0.y, c * p0.y + sn * Pp0.x);
    psi[b1] = make_float2(c * p1.x - sn * Pp1.y, c * p1.y + sn * Pp1.x);
    lam[b0] = make_float2(c * l0.x - sn * Pl0.y, c * l0.y + sn * Pl0.x);
    lam[b1] = make_float2(c * l1.x - sn * Pl1.y, c * l1.y + sn * Pl1.x);
  }
  share = block_sum(share);
  if (threadIdx.x == 0) partials[blockIdx.x] = share;
}

// ---------------------------------------------------------------------------
// pauli_inner: v_t = sum_b conj(a[b]) s_t(b) psi[b ^ x_t] for every term t.
//
// Serves expectation_chain_pallas (a = psi; E = sum_t Re(c_t v_t)) and
// screen_chain_pallas (a = w; grad_t = 2 Im(c_t v_t)),
// qsfh_tpu/engine/pallas_kernels.py:615-685 and :896-970.  The grid covers
// (b-range, term); each block reduces its range to partials[t, block] and
// reduce_partials_kernel sums the row in a fixed order.  Bound: 2 x 8 B of
// loads and ~10 flops per (term, amplitude); over the 2592-term pool at
// n = 18 the loads come from L2.
// ---------------------------------------------------------------------------
__global__ void pauli_inner_kernel(const float2* __restrict__ a,
                                   const float2* __restrict__ psi, uint32_t dim,
                                   const int32_t* __restrict__ xs,
                                   const int32_t* __restrict__ zs,
                                   float2* __restrict__ partials) {
  const int t = blockIdx.y;
  const uint32_t x = static_cast<uint32_t>(xs[t]);
  const uint32_t z = static_cast<uint32_t>(zs[t]);
  const uint32_t base = blockIdx.x * (blockDim.x * kInnerPerThread) + threadIdx.x;
  float2 acc = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int k = 0; k < kInnerPerThread; ++k) {
    const uint32_t b = base + k * blockDim.x;
    if (b < dim) {
      const float2 prod = cdot(a[b], psi[b ^ x]);
      const float s = parity_sign(b, z);
      acc.x += s * prod.x;
      acc.y += s * prod.y;
    }
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[static_cast<size_t>(t) * gridDim.x + blockIdx.x] = acc;
}

// out[dest[t]] = sum_j partials[t, j] (dest = identity when null), one
// warp per term, fixed order.
__global__ void reduce_partials_kernel(const float2* __restrict__ partials,
                                       int n_blocks, int n_terms,
                                       const int32_t* __restrict__ dest,
                                       float2* __restrict__ out) {
  const int warps_per_block = blockDim.x >> 5;
  const int t = blockIdx.x * warps_per_block + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (t >= n_terms) return;  // whole warps leave together
  const float2* row = partials + static_cast<size_t>(t) * n_blocks;
  float2 acc = make_float2(0.0f, 0.0f);
  for (int j = lane; j < n_blocks; j += 32) acc = cadd(acc, row[j]);
  acc = warp_sum(acc);
  if (lane == 0) out[dest ? dest[t] : t] = acc;
}

// ---------------------------------------------------------------------------
// pauli_apply: out[b] = sum_t c_t s_t(b) psi[b ^ x_t].
//
// Replaces apply_chain_pallas (qsfh_tpu/engine/pallas_kernels.py:688-760).
// One thread per output amplitude loops over the terms, staged through
// shared memory a tile at a time, and writes out[b] once: no atomics.
// Bound: ~8 flops and one 8 B load per (term, amplitude); at n = 18 and
// 100 terms the loads hit L1/L2, so the arithmetic bounds it.
// ---------------------------------------------------------------------------
__global__ void pauli_apply_kernel(const float2* __restrict__ psi,
                                   float2* __restrict__ out, uint32_t dim,
                                   const int32_t* __restrict__ xs,
                                   const int32_t* __restrict__ zs,
                                   const float* __restrict__ cre,
                                   const float* __restrict__ cim, int n_terms) {
  __shared__ uint32_t sx[kApplyTile];
  __shared__ uint32_t sz[kApplyTile];
  __shared__ float2 sc[kApplyTile];
  const uint32_t b = blockIdx.x * blockDim.x + threadIdx.x;
  float2 acc = make_float2(0.0f, 0.0f);
  for (int t0 = 0; t0 < n_terms; t0 += kApplyTile) {
    const int tile = min(kApplyTile, n_terms - t0);
    for (int j = threadIdx.x; j < tile; j += blockDim.x) {
      sx[j] = static_cast<uint32_t>(xs[t0 + j]);
      sz[j] = static_cast<uint32_t>(zs[t0 + j]);
      sc[j] = make_float2(cre[t0 + j], cim[t0 + j]);
    }
    __syncthreads();
    if (b < dim) {
      for (int j = 0; j < tile; ++j) {
        const float2 v = cmul(sc[j], psi[b ^ sx[j]]);
        const float s = parity_sign(b, sz[j]);
        acc.x += s * v.x;
        acc.y += s * v.y;
      }
    }
    __syncthreads();
  }
  if (b < dim) out[b] = acc;
}

// ---------------------------------------------------------------------------
// rotation_local_runs: one run of consecutive TILE-LOCAL rotations, in place.
//
// Replaces rotation_stream_pallas / rotation_stream_planes and their local
// kernel _rot_stream_local_kernel (qsfh_tpu/engine/pallas_kernels.py:2214,
// :2268, :2289).  Every flip mask of the run lies below bit L, so the pair
// (b, b ^ x) of every term lies inside one tile of 2^L amplitudes.  Each
// block loads its tile into shared memory once (2^14 complex64 = 128 KiB),
// applies the whole run there term after term (pairs owned as in
// pauli_rotation, then __syncthreads()), and writes the tile back once.
// The z mask may reach above L: the parity takes the global index, which
// is what _block_parity_flip (:356) emulates on the TPU.  Block-crossing
// terms between runs go to pauli_rotation (the function of
// _rot_stream_cross_kernel, :2246).  Bound: one HBM read and one write of
// the state per run instead of per term; inside the run, shared-memory
// bandwidth and the popcount parity.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kRunThreads)
rotation_local_run_kernel(float2* __restrict__ psi, int local_bits,
                          const int32_t* __restrict__ xs,
                          const int32_t* __restrict__ zs,
                          const float* __restrict__ angles,
                          const float* __restrict__ phre,
                          const float* __restrict__ phim, int n_terms) {
  extern __shared__ float2 tile[];
  const uint32_t size = 1u << local_bits, half = size >> 1;
  const uint32_t base = static_cast<uint32_t>(blockIdx.x) << local_bits;
  float2* g = psi + base;
  for (uint32_t i = threadIdx.x; i < size; i += blockDim.x) tile[i] = g[i];
  __syncthreads();
  for (int t = 0; t < n_terms; ++t) {
    const uint32_t x = static_cast<uint32_t>(xs[t]);
    const uint32_t z = static_cast<uint32_t>(zs[t]);
    float sn, c;
    sincosf(angles[t], &sn, &c);
    // -i * sin * ph
    const float2 m = make_float2(sn * phim[t], -sn * phre[t]);
    if (x == 0u) {
      for (uint32_t i = threadIdx.x; i < size; i += blockDim.x) {
        const float2 u = tile[i], mu = cmul(m, u);
        const float sg = parity_sign(base | i, z);
        tile[i] = make_float2(c * u.x + sg * mu.x, c * u.y + sg * mu.y);
      }
    } else {
      const int pivot = 31 - __clz(x);
      for (uint32_t i = threadIdx.x; i < half; i += blockDim.x) {
        const uint32_t b = insert_zero_bit(i, pivot), bx = b ^ x;
        const float2 u = tile[b], v = tile[bx];
        const float2 mv = cmul(m, v), mu = cmul(m, u);
        const float sb = parity_sign(base | b, z), sbx = parity_sign(base | bx, z);
        tile[b] = make_float2(c * u.x + sb * mv.x, c * u.y + sb * mv.y);
        tile[bx] = make_float2(c * v.x + sbx * mu.x, c * v.y + sbx * mu.y);
      }
    }
    __syncthreads();
  }
  for (uint32_t i = threadIdx.x; i < size; i += blockDim.x) g[i] = tile[i];
}

// ---------------------------------------------------------------------------
// adjoint_local_runs: one run of the reverse adjoint sweep over TILE-LOCAL
// terms (given in reversed order), in place on psi and lam.
//
// Replaces adjoint_stream_pallas and its local kernel
// _adjoint_stream_local_kernel (qsfh_tpu/engine/pallas_kernels.py:2032,
// :2142).  The tiles of psi and lam share shared memory (two tiles of 2^13
// complex64 = 128 KiB).  For each term the block reads its share of
// <lam | P psi> at the post-gate state into partials[t, block], then
// rotates both tiles by exp(+i angle P) (pairs owned as in
// adjoint_rotation).  reduce_partials_kernel sums the shares per term in a
// fixed order: no float atomics.  Crossing terms go to adjoint_rotation
// (the function of _adjoint_stream_cross_kernel, :2095).  Bound: one HBM
// read and one write of psi and lam per run instead of per term.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kRunThreads)
adjoint_local_run_kernel(float2* __restrict__ psi, float2* __restrict__ lam,
                         int local_bits, const int32_t* __restrict__ xs,
                         const int32_t* __restrict__ zs,
                         const float* __restrict__ angles,
                         const float* __restrict__ phre,
                         const float* __restrict__ phim, int n_terms,
                         float2* __restrict__ partials) {
  extern __shared__ float2 tiles[];
  const uint32_t size = 1u << local_bits, half = size >> 1;
  float2* pt = tiles;
  float2* lt = tiles + size;
  const uint32_t base = static_cast<uint32_t>(blockIdx.x) << local_bits;
  float2* gp = psi + base;
  float2* gl = lam + base;
  for (uint32_t i = threadIdx.x; i < size; i += blockDim.x) {
    pt[i] = gp[i];
    lt[i] = gl[i];
  }
  __syncthreads();
  for (int t = 0; t < n_terms; ++t) {
    const uint32_t x = static_cast<uint32_t>(xs[t]);
    const uint32_t z = static_cast<uint32_t>(zs[t]);
    float sn, c;
    sincosf(angles[t], &sn, &c);
    const float2 ph = make_float2(phre[t], phim[t]);
    float2 share = make_float2(0.0f, 0.0f);
    if (x == 0u) {
      for (uint32_t b = threadIdx.x; b < size; b += blockDim.x) {
        const float sg = parity_sign(base | b, z);
        const float2 p = pt[b], l = lt[b];
        const float2 pp = cmul(ph, p), pl = cmul(ph, l);
        const float2 Pp = make_float2(sg * pp.x, sg * pp.y);
        const float2 Pl = make_float2(sg * pl.x, sg * pl.y);
        share = cadd(share, cdot(l, Pp));
        pt[b] = make_float2(c * p.x - sn * Pp.y, c * p.y + sn * Pp.x);
        lt[b] = make_float2(c * l.x - sn * Pl.y, c * l.y + sn * Pl.x);
      }
    } else {
      const int pivot = 31 - __clz(x);
      for (uint32_t i = threadIdx.x; i < half; i += blockDim.x) {
        const uint32_t b0 = insert_zero_bit(i, pivot), b1 = b0 ^ x;
        const float s0 = parity_sign(base | b0, z), s1 = parity_sign(base | b1, z);
        const float2 p0 = pt[b0], p1 = pt[b1], l0 = lt[b0], l1 = lt[b1];
        const float2 pp0 = cmul(ph, p1), pp1 = cmul(ph, p0);
        const float2 pl0 = cmul(ph, l1), pl1 = cmul(ph, l0);
        const float2 Pp0 = make_float2(s0 * pp0.x, s0 * pp0.y);
        const float2 Pp1 = make_float2(s1 * pp1.x, s1 * pp1.y);
        const float2 Pl0 = make_float2(s0 * pl0.x, s0 * pl0.y);
        const float2 Pl1 = make_float2(s1 * pl1.x, s1 * pl1.y);
        share = cadd(share, cadd(cdot(l0, Pp0), cdot(l1, Pp1)));
        // exp(+i angle P) v = cos * v + i sin * P v
        pt[b0] = make_float2(c * p0.x - sn * Pp0.y, c * p0.y + sn * Pp0.x);
        pt[b1] = make_float2(c * p1.x - sn * Pp1.y, c * p1.y + sn * Pp1.x);
        lt[b0] = make_float2(c * l0.x - sn * Pl0.y, c * l0.y + sn * Pl0.x);
        lt[b1] = make_float2(c * l1.x - sn * Pl1.y, c * l1.y + sn * Pl1.x);
      }
    }
    share = block_sum(share);
    if (threadIdx.x == 0) partials[static_cast<size_t>(t) * gridDim.x + blockIdx.x] = share;
    __syncthreads();
  }
  for (uint32_t i = threadIdx.x; i < size; i += blockDim.x) {
    gp[i] = pt[i];
    gl[i] = lt[i];
  }
}

// ---------------------------------------------------------------------------
// pauli_inner_grouped: v_t = sum_b conj(a[b]) s_t(b) psi[b ^ x_t], with the
// terms grouped by flip mask.
//
// Replaces expectation_stream_pallas / _planes, expectation_stream_fused
// and expectation_stream_fused_static (a = psi), and screen_stream_pallas /
// screen_stream_planes (a = w) (qsfh_tpu/engine/pallas_kernels.py:1474,
// :1522, :1581, :1596, :1714, :1804).  The grid is (b-range, group).  A
// thread loads a[b] and psi[b ^ x] once per group for 16 amplitudes
// b = base | k << 8 | tid (k = 0..15) and forms conj(a[b]) psi[b ^ x] once;
// then for every z mask of the group (staged in shared memory) it adds the
// sign-weighted products.  The sign splits over the disjoint bit fields:
// parity((base | tid) & z) once per term, and the 16 signs of the k field
// from the kParity4 table, applied as sign-bit flips.  Each warp sums its
// lanes per term into shared memory; the block writes partials[t, block]
// and reduce_partials_kernel writes out[order[t]] in a fixed order, so the
// result is in input order and deterministic.  Bound: HBM, two state reads
// per group (the pool's 684 groups instead of 6336 terms).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kGroupThreads)
pauli_inner_grouped_kernel(const float2* __restrict__ a,
                           const float2* __restrict__ psi, uint32_t dim,
                           const int32_t* __restrict__ gx,
                           const int32_t* __restrict__ gstart,
                           const int32_t* __restrict__ zs, int g0, int t0,
                           float2* __restrict__ partials) {
  __shared__ uint32_t sz[kMaxGroupTerms];
  __shared__ float2 wacc[kGroupThreads / 32][kMaxGroupTerms];
  const int g = g0 + static_cast<int>(blockIdx.y);
  const uint32_t x = static_cast<uint32_t>(gx[g]);
  const int ts = gstart[g];
  const int nt = gstart[g + 1] - ts;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = threadIdx.x; j < nt; j += blockDim.x) {
    sz[j] = static_cast<uint32_t>(zs[ts + j]);
#pragma unroll
    for (int w = 0; w < kGroupThreads / 32; ++w) wacc[w][j] = make_float2(0.0f, 0.0f);
  }
  __syncthreads();
  const uint32_t span = 1u << kGroupSpanBits;
  const uint32_t block_base = blockIdx.x * span;
  for (uint32_t batch = 0; batch < span; batch += kGroupThreads * kGroupAmps) {
    const uint32_t base = block_base + batch;  // flat bits 12 and up
    if (base >= dim) break;                    // the same for the whole block
    float2 prod[kGroupAmps];
#pragma unroll
    for (int k = 0; k < kGroupAmps; ++k) {
      const uint32_t b = base | (static_cast<uint32_t>(k) << 8) | threadIdx.x;
      prod[k] = b < dim ? cdot(a[b], psi[b ^ x]) : make_float2(0.0f, 0.0f);
    }
    const uint32_t own = base | threadIdx.x;
    for (int j = 0; j < nt; ++j) {
      const uint32_t z = sz[j];
      // bit k of `flips`: the parity of (own | k << 8) & z
      const uint32_t odd = __popc(own & z) & 1u;
      const uint32_t flips = kParity4[(z >> 8) & 15u] ^ (odd ? 0xffffu : 0u);
      float2 v = make_float2(0.0f, 0.0f);
#pragma unroll
      for (int k = 0; k < kGroupAmps; ++k) {
        const uint32_t sbit = (flips << (31 - k)) & 0x80000000u;
        v.x += __uint_as_float(__float_as_uint(prod[k].x) ^ sbit);
        v.y += __uint_as_float(__float_as_uint(prod[k].y) ^ sbit);
      }
      v = warp_sum(v);
      if (lane == 0) wacc[warp][j] = cadd(wacc[warp][j], v);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < nt; j += blockDim.x) {
    float2 s = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int w = 0; w < kGroupThreads / 32; ++w) s = cadd(s, wacc[w][j]);
    partials[static_cast<size_t>(ts - t0 + j) * gridDim.x + blockIdx.x] = s;
  }
}

inline unsigned blocks_for(uint64_t work, uint64_t per_block) {
  return static_cast<unsigned>((work + per_block - 1) / per_block);
}

inline unsigned inner_blocks(int n) {
  return blocks_for(1ull << n, static_cast<uint64_t>(kThreads) * kInnerPerThread);
}

inline unsigned pair_blocks(int n) { return blocks_for(1ull << (n - 1), kThreads); }

inline cudaError_t reduce_partials(const float2* partials, int n_blocks, int n_terms,
                                   float2* out, cudaStream_t stream,
                                   const int32_t* dest = nullptr) {
  const int warps = kThreads / 32;
  reduce_partials_kernel<<<blocks_for(n_terms, warps), kThreads, 0, stream>>>(
      partials, n_blocks, n_terms, dest, out);
  return cudaGetLastError();
}

inline unsigned group_blocks(int n) {
  return blocks_for(1ull << n, 1ull << kGroupSpanBits);
}

// Allow `bytes` of dynamic shared memory for `kernel` (above 48 KB Hopper
// needs the opt-in); refuses what no block can have.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > kMaxDynamicSmem) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" {

const char* qsfh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Blocks per term of the pauli_inner grid (the width of its partials).
int qsfh_inner_blocks(int n) { return static_cast<int>(inner_blocks(n)); }

// Blocks per term of adjoint_rotation (the width of its partials).
int qsfh_adjoint_blocks(int n) { return static_cast<int>(pair_blocks(n)); }

// psi <- exp(-i angles[T-1] P_{T-1}) ... exp(-i angles[0] P_0) psi, one
// launch per term, in place.
int qsfh_pauli_rotation(void* psi, int n, const void* xs, const void* zs,
                        const void* angles, const void* phre, const void* phim,
                        int n_terms, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t half = 1u << (n - 1);
  const unsigned grid = pair_blocks(n);
  for (int t = 0; t < n_terms; ++t) {
    pauli_rotation_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<float2*>(psi), half, static_cast<const int32_t*>(xs),
        static_cast<const int32_t*>(zs), static_cast<const float*>(angles),
        static_cast<const float*>(phre), static_cast<const float*>(phim), t);
    if (t == 0) {
      const cudaError_t err = cudaPeekAtLastError();
      if (err != cudaSuccess) return static_cast<int>(cudaGetLastError());
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Reverse adjoint sweep over terms already in REVERSED order, in place on
// psi and lam; out[t] = <lam | P_t psi> at the post-gate state of term t.
// partials: n_terms x qsfh_adjoint_blocks(n) float2 scratch.
int qsfh_adjoint_rotation(void* psi, void* lam, int n, const void* xs,
                          const void* zs, const void* angles, const void* phre,
                          const void* phim, int n_terms, void* partials,
                          void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t half = 1u << (n - 1);
  const unsigned grid = pair_blocks(n);
  float2* part = static_cast<float2*>(partials);
  for (int t = 0; t < n_terms; ++t) {
    adjoint_rotation_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<float2*>(psi), static_cast<float2*>(lam), half,
        static_cast<const int32_t*>(xs), static_cast<const int32_t*>(zs),
        static_cast<const float*>(angles), static_cast<const float*>(phre),
        static_cast<const float*>(phim), t, part + static_cast<size_t>(t) * grid);
    if (t == 0) {
      const cudaError_t err = cudaPeekAtLastError();
      if (err != cudaSuccess) return static_cast<int>(cudaGetLastError());
    }
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      reduce_partials(part, static_cast<int>(grid), n_terms, static_cast<float2*>(out), s));
}

// out[t] = sum_b conj(a[b]) s_t(b) psi[b ^ x_t].
// partials: n_terms x qsfh_inner_blocks(n) float2 scratch.
int qsfh_pauli_inner(const void* a, const void* psi, int n, const void* xs,
                     const void* zs, int n_terms, void* partials, void* out,
                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned nblk = inner_blocks(n);
  float2* part = static_cast<float2*>(partials);
  for (int t0 = 0; t0 < n_terms; t0 += kMaxGridY) {
    const int chunk = min(kMaxGridY, n_terms - t0);
    const dim3 grid(nblk, chunk);
    pauli_inner_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float2*>(a), static_cast<const float2*>(psi),
        static_cast<uint32_t>(1u << n), static_cast<const int32_t*>(xs) + t0,
        static_cast<const int32_t*>(zs) + t0, part + static_cast<size_t>(t0) * nblk);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      reduce_partials(part, static_cast<int>(nblk), n_terms, static_cast<float2*>(out), s));
}

// out[b] = sum_t (cre_t + i cim_t) s_t(b) psi[b ^ x_t].
int qsfh_pauli_apply(const void* psi, void* out, int n, const void* xs,
                     const void* zs, const void* cre, const void* cim,
                     int n_terms, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t dim = 1u << n;
  pauli_apply_kernel<<<blocks_for(dim, kThreads), kThreads, 0, s>>>(
      static_cast<const float2*>(psi), static_cast<float2*>(out), dim,
      static_cast<const int32_t*>(xs), static_cast<const int32_t*>(zs),
      static_cast<const float*>(cre), static_cast<const float*>(cim), n_terms);
  return static_cast<int>(cudaGetLastError());
}

// Blocks per group of pauli_inner_grouped (the width of its partials).
int qsfh_group_blocks(int n) { return static_cast<int>(group_blocks(n)); }

// One local run: psi <- exp(-i angles[T-1] P_{T-1}) ... exp(-i angles[0] P_0)
// psi in place, every flip mask below bit local_bits; one launch.
int qsfh_rotation_local_run(void* psi, int n, int local_bits, const void* xs,
                            const void* zs, const void* angles, const void* phre,
                            const void* phim, int n_terms, void* stream) {
  if (local_bits < 1 || local_bits > n) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float2) << local_bits;
  cudaError_t err = allow_smem(rotation_local_run_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  rotation_local_run_kernel<<<1u << (n - local_bits), kRunThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<float2*>(psi), local_bits, static_cast<const int32_t*>(xs),
      static_cast<const int32_t*>(zs), static_cast<const float*>(angles),
      static_cast<const float*>(phre), static_cast<const float*>(phim), n_terms);
  return static_cast<int>(cudaGetLastError());
}

// One local run of the reverse adjoint sweep (terms in REVERSED order), in
// place on psi and lam; out[t] = <lam | P_t psi> at the post-gate state.
// partials: n_terms x 2^(n - local_bits) float2 scratch.
int qsfh_adjoint_local_run(void* psi, void* lam, int n, int local_bits,
                           const void* xs, const void* zs, const void* angles,
                           const void* phre, const void* phim, int n_terms,
                           void* partials, void* out, void* stream) {
  if (local_bits < 1 || local_bits > n) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = 2 * (sizeof(float2) << local_bits);
  cudaError_t err = allow_smem(adjoint_local_run_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = 1u << (n - local_bits);
  float2* part = static_cast<float2*>(partials);
  adjoint_local_run_kernel<<<grid, kRunThreads, smem, s>>>(
      static_cast<float2*>(psi), static_cast<float2*>(lam), local_bits,
      static_cast<const int32_t*>(xs), static_cast<const int32_t*>(zs),
      static_cast<const float*>(angles), static_cast<const float*>(phre),
      static_cast<const float*>(phim), n_terms, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      reduce_partials(part, static_cast<int>(grid), n_terms, static_cast<float2*>(out), s));
}

// Groups [g0, g0 + n_groups) of a flip-mask grouping: out[order[t]] =
// sum_b conj(a[b]) s_t(b) psi[b ^ x_t] for the grouped terms
// t in [t0, t0 + n_terms) = [gstart[g0], gstart[g0 + n_groups]).
// partials: n_terms x qsfh_group_blocks(n) float2 scratch.
int qsfh_pauli_inner_grouped(const void* a, const void* psi, int n, const void* gx,
                             const void* gstart, const void* zs, const void* order,
                             int g0, int n_groups, int t0, int n_terms,
                             void* partials, void* out, void* stream) {
  if (n_groups < 1 || n_groups > kMaxGridY) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned nblk = group_blocks(n);
  float2* part = static_cast<float2*>(partials);
  pauli_inner_grouped_kernel<<<dim3(nblk, n_groups), kGroupThreads, 0, s>>>(
      static_cast<const float2*>(a), static_cast<const float2*>(psi),
      static_cast<uint32_t>(1u << n), static_cast<const int32_t*>(gx),
      static_cast<const int32_t*>(gstart), static_cast<const int32_t*>(zs), g0, t0,
      part);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(reduce_partials(part, static_cast<int>(nblk), n_terms,
                                          static_cast<float2*>(out), s,
                                          static_cast<const int32_t*>(order) + t0));
}

}  // extern "C"
