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
// across launches, so the simple one-launch-per-term designs below are
// bound by launch latency and L2 bandwidth, not by HBM.
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

// out[t] = sum_j partials[t, j], one warp per term, fixed order.
__global__ void reduce_partials_kernel(const float2* __restrict__ partials,
                                       int n_blocks, int n_terms,
                                       float2* __restrict__ out) {
  const int warps_per_block = blockDim.x >> 5;
  const int t = blockIdx.x * warps_per_block + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (t >= n_terms) return;  // whole warps leave together
  const float2* row = partials + static_cast<size_t>(t) * n_blocks;
  float2 acc = make_float2(0.0f, 0.0f);
  for (int j = lane; j < n_blocks; j += 32) acc = cadd(acc, row[j]);
  acc = warp_sum(acc);
  if (lane == 0) out[t] = acc;
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

inline unsigned blocks_for(uint64_t work, uint64_t per_block) {
  return static_cast<unsigned>((work + per_block - 1) / per_block);
}

inline unsigned inner_blocks(int n) {
  return blocks_for(1ull << n, static_cast<uint64_t>(kThreads) * kInnerPerThread);
}

inline unsigned pair_blocks(int n) { return blocks_for(1ull << (n - 1), kThreads); }

inline cudaError_t reduce_partials(const float2* partials, int n_blocks, int n_terms,
                                   float2* out, cudaStream_t stream) {
  const int warps = kThreads / 32;
  reduce_partials_kernel<<<blocks_for(n_terms, warps), kThreads, 0, stream>>>(
      partials, n_blocks, n_terms, out);
  return cudaGetLastError();
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

}  // extern "C"
