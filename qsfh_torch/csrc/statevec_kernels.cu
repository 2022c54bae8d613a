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
// four kernels are bound by launch latency and L2 bandwidth, not by HBM;
// up to 18 qubits the engine takes the resident kernels instead, which walk
// a whole rotation segment or adjoint sweep in one cooperative launch.
// From 19 qubits on (a 24-qubit state is 128 MiB) every launch streams the
// state from HBM, and the tile-run and grouped kernels organise the work
// against it: runs of rotations chained in shared memory and registers over
// tiles of chosen bits, one state pass per run, and inner products and
// sums of terms applied to the state over tiles of chosen bits, one pass
// per tile for every flip mask inside it.
//
// Plain C interface (loaded with ctypes by qsfh_torch/engine/kernels.py):
// every entry point enqueues on the given stream, allocates nothing, and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;        // threads per block, every kernel
constexpr int kInnerPerThread = 8;   // amplitudes per thread in pauli_inner
constexpr int kApplyTile = 256;      // terms staged per shared-memory tile
constexpr int kMaxGridY = 65535;
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
// The per-term counterpart of apply_chain_pallas (qsfh_tpu/engine/
// pallas_kernels.py:688-760); the engine applies sums over tiles (pauli_apply_tiles_kernel
// below) and keeps this kernel for terms whose mask fits no tile and for
// states of fewer than 9 qubits.  One thread per output amplitude loops over
// the terms, staged through shared memory a tile at a time, and writes
// out[b] once: no atomics.  Bound: ~8 flops and one 8 B load per (term,
// amplitude); every term is a gather through L1/L2.
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
// Tile runs: the 24-qubit rotation segment and adjoint sweep.
//
// The host (qsfh_torch/engine/streaming.py, TileRuns) cuts a term sequence
// into order-preserving runs.  A run's tile is a flat bit set of k bits:
// the low c bits (rows of 2^c contiguous amplitudes) and k - c higher bits
// chosen so that every flip mask of the run lies inside the set.  Block o
// of a launch owns the 2^k amplitudes whose other bits spell o; tile slot
// i (tile coordinates: bit j of i is the j-th bit of the set) lives at
// flat index outer | deposit(i, tile mask).  So the partner of a slot is
// i ^ x_tile, and the parity sign of term t is
//     parity(i & z_tile) ^ parity(outer & z_out),
// the second one sign per block and term.
//
// Inside the tile the run is cut again, into register groups: consecutive
// terms whose flip masks together lie in REG_BITS = 4 tile bits R.  For a
// group, thread tid holds in registers the 16 slots base | off(j), where
// base is tid with zeros inserted at R and off(j) places the 4 bits of j
// at R; a term's partner j ^ x_reg (x_reg = its flip mask compressed to R)
// is then another register of the same thread, so the group's terms run
// with no shared-memory traffic and no barrier.  Shared memory is read and
// written once per group, with a barrier between groups, and the slot
// index is XOR-swizzled (swz) so that a warp's 32 slots spread over the
// banks whichever tile bits R takes.  The sign of slot j is
// parity(j & z_reg) ^ parity(base & z_tile) ^ the block's sign: the first
// from the kParity4 table, the rest one bit per thread and term.
//
// Fused groups (streaming.fused_groups, TileRuns.frec): 3 to 8 consecutive
// terms with one flip mask, one parameter and one parity of x & z commute, so their product is exp(-i M), M psi[b] = u r(b) psi[b ^
// x] with u = 1 (even parity) or i (odd), r(b) = sum_k a_k w_k s_k(b) (a_k
// the term's angle, w_k its string phase over u): ONE rotation of each pair
// by the angle r(b), the closed form of qsfh_tpu/engine/compiled.py:307-420
// (_group_rot_terms, _grot_mix) and of the float64 engine.  With a GF(2)
// basis zb_i of the group's phase masks (rank R <= 4), s_k(b) =
// (-1)^parity(q(b) & coef_k), q(b) bit i = parity(b & zb_i), so r takes 2^R
// values: the block forms the group's table (cos phi_q, dir sin phi_q) while
// it stages the run, from the call's angles (they change on the card between
// graph replays).  A fused group is a register group of its own, run
// straight through shared memory a pair at a time (no register copy of the
// 16 slots, which would leave the adjoint short of registers); for slot j of
// a thread, q = q0 ^ the columns of j's register bits (q0 from the tile's
// outer bits, staged per tile, and the thread's base); r(b ^ x) = r(b) (u =
// 1) or -r(b) (u = i), so a pair reads one entry.  In the adjoint the
// group's terms commute with its rotation, so each <lam | P_t psi> is read at
// the group's end state: the pair's products conj(l[j]) p[j ^ x] go into
// each term's signed sum before the pair is rotated back, and one transposed
// warp sum serves all the terms (16 shuffles for 8 terms, where a warp sum a
// term takes 10 each).
// ---------------------------------------------------------------------------

constexpr int kRegSlots = 16;         // 2^streaming.REG_BITS
constexpr int kMaxRunTerms = 256;     // streaming.MAX_RUN_TERMS
constexpr int kFusedRec = 12;         // streaming.FUSED_RECORD: int32 words of a fused record
constexpr int kFusedTable = 16;       // table entries of a fused group: 2^streaming.FUSED_MAX_RANK
constexpr int kFusedMaxTerms = 8;     // streaming.FUSED_CAP
// A fused group's register word carries kFusedGroup (streaming.FUSED_GROUP);
// its terms' code words their coefficient masks at bit 12, its first term's
// also the group's terms less one at 16 and its record within the run at 20.
constexpr uint32_t kFusedGroup = 1u << 16;
constexpr int kTileMinBits = 9;       // 2^(k - 4) threads: at least one warp
constexpr int kTileMaxBits = 13;      // 512 threads
// adjoint_resident_kernel: 256 threads at most and one block an SM, so that a
// thread may hold up to 255 registers (bound to 512 threads, ptxas gave it
// 128 and spilled its per-term loop, p and lam's 16 slots each, beside the
// fused groups' path); the resident route runs one block an SM anyway
// (streaming.RESIDENT_TILE_BITS = 11: 128 tiles of 128 threads at 18 qubits)
constexpr int kResidentAdjointMaxBits = 12;

// A bijection of tile slots that keeps bit 0 (16-byte pairs stay whole for
// the copies) and XORs bits 1-3 with a fold of the bits above 4.
__device__ __forceinline__ uint32_t swz(uint32_t i) {
  const uint32_t v = i >> 4;
  return i ^ ((v ^ (v >> 4) ^ (v >> 8) ^ (v >> 12)) & 14u);
}

// The low bits of v placed at the set bits of mask, lowest first.
__device__ __forceinline__ uint32_t deposit(uint32_t v, uint32_t mask) {
  uint32_t out = 0u;
  while (mask != 0u && v != 0u) {
    const uint32_t low = mask & (0u - mask);
    if (v & 1u) out |= low;
    v >>= 1;
    mask ^= low;
  }
  return out;
}

__device__ __forceinline__ float flip_sign(float v, uint32_t sbit) {
  return __uint_as_float(__float_as_uint(v) ^ sbit);
}

// bit j of flips in the float sign position
__device__ __forceinline__ uint32_t sign_bit(uint32_t flips, int j) {
  return (flips << (31 - j)) & 0x80000000u;
}

// c a + s m b for one amplitude, s = +-1 from sbit.  The rotations of the
// engine have string phases (-i)^k, so m is real (KIND 0) or imaginary
// (KIND 1) and the product takes one scalar: 4 float ops, not 8.  KIND 2 is
// the general complex m.
template <int KIND>
__device__ __forceinline__ float2 rot_amp(float c, float2 a, float2 b, float2 m, uint32_t sbit) {
  if (KIND == 0) {
    const float mu = flip_sign(m.x, sbit);
    return make_float2(fmaf(mu, b.x, c * a.x), fmaf(mu, b.y, c * a.y));
  }
  if (KIND == 1) {
    const float mu = flip_sign(m.y, sbit);
    return make_float2(fmaf(-mu, b.y, c * a.x), fmaf(mu, b.x, c * a.y));
  }
  const float2 mb = cmul(m, b);
  return make_float2(c * a.x + flip_sign(mb.x, sbit), c * a.y + flip_sign(mb.y, sbit));
}

// v[j] <- c v[j] + s_j m v[j ^ X] on the 16 register slots: exp(-i angle P)
// with m = -i sin ph (forward), or exp(+i angle P) with m = +i sin ph.
template <int X, int KIND>
__device__ __forceinline__ void rotate_slots(float2 (&v)[kRegSlots], uint32_t flips, float c,
                                             float2 m) {
  constexpr int kPivot = X & 8 ? 8 : X & 4 ? 4 : X & 2 ? 2 : 1;
#pragma unroll
  for (int j = 0; j < kRegSlots; ++j) {
    if (X == 0 || (j & kPivot) == 0) {
      const int k = j ^ X;
      const float2 a = v[j], b = v[k];
      v[j] = rot_amp<KIND>(c, a, b, m, sign_bit(flips, j));
      if (X != 0) v[k] = rot_amp<KIND>(c, b, a, m, sign_bit(flips, k));
    }
  }
}

// One reversed adjoint term on the register slots of psi (p) and lam (l):
// adds sum_j s_j conj(l[j]) p[j ^ X] (this thread's share of <lam | P psi>
// at the post-gate state, before the string phase, which the block
// applies once per term) to acc, then rotates both by exp(+i angle P),
// m = +i sin ph.
template <int X, int KIND>
__device__ __forceinline__ void adjoint_slots(float2 (&p)[kRegSlots], float2 (&l)[kRegSlots],
                                              uint32_t flips, float c, float2 m, float2& acc) {
  constexpr int kPivot = X & 8 ? 8 : X & 4 ? 4 : X & 2 ? 2 : 1;
#pragma unroll
  for (int j = 0; j < kRegSlots; ++j) {
    if (X == 0 || (j & kPivot) == 0) {
      const int k = j ^ X;
      const uint32_t sj = sign_bit(flips, j), sk = sign_bit(flips, k);
      const float2 pj = p[j], pk = p[k], lj = l[j], lk = l[k];
      const float fj = __uint_as_float(0x3f800000u | sj);  // s_j as +-1.0f
      const float2 dj = cdot(lj, pk);
      acc = make_float2(fmaf(fj, dj.x, acc.x), fmaf(fj, dj.y, acc.y));
      p[j] = rot_amp<KIND>(c, pj, pk, m, sj);
      l[j] = rot_amp<KIND>(c, lj, lk, m, sj);
      if (X != 0) {
        const float fk = __uint_as_float(0x3f800000u | sk);
        const float2 dk = cdot(lk, pj);
        acc = make_float2(fmaf(fk, dk.x, acc.x), fmaf(fk, dk.y, acc.y));
        p[k] = rot_amp<KIND>(c, pk, pj, m, sk);
        l[k] = rot_amp<KIND>(c, lk, lj, m, sk);
      }
    }
  }
}

// the 48 (flip mask, KIND) cases of the term loop's switch: key X | KIND << 4
#define QSFH_X_CASES(F, K) \
  F(0, K) F(1, K) F(2, K) F(3, K) F(4, K) F(5, K) F(6, K) F(7, K) \
  F(8, K) F(9, K) F(10, K) F(11, K) F(12, K) F(13, K) F(14, K) F(15, K)
#define QSFH_CASES(F) QSFH_X_CASES(F, 0) QSFH_X_CASES(F, 1) QSFH_X_CASES(F, 2)

// What a tile-run block stages in shared memory while its tile arrives: per term
// cos and m = dir * (-i sin ph) (dir = 1 forward, -1 adjoint), a code word
// (x_reg in bits 0-3, z_reg 4-7, the current tile's outer sign 8, KIND 9-10,
// the fused bits above), z_tile and z_out; then the fused groups' area
// (fused_area), whose place follows from these pointers.  `extra` bytes per
// term (8-byte aligned) follow coef for the caller.
struct RunStage {
  float4* coef;
  unsigned char* extra;
  uint32_t* code;
  uint32_t* zt;
  uint32_t* zo;
};

// The fused groups' area after z_out, padded to an even count of terms (so
// 8-byte aligned; pointer arithmetic alone, so the compiler keeps it in
// shared memory): their count (an 8-byte header), then per group kFusedBytes:
// its record (kFusedRec words; word 10 the tile's outer pattern, bit i =
// parity(outer & zb_i)) and its table (kFusedTable entries (cos phi_q, dir
// sin phi_q)).
constexpr int kFusedBytes = kFusedRec * sizeof(int32_t) + kFusedTable * sizeof(float2);

__device__ __forceinline__ unsigned char* fused_area(const RunStage& st) {
  return reinterpret_cast<unsigned char*>(st.zo + (((st.zo - st.zt) + 1) & ~1));
}

__device__ __forceinline__ int32_t* fused_rec(const RunStage& st, int f) {
  return reinterpret_cast<int32_t*>(fused_area(st) + 8 + f * kFusedBytes);
}

__device__ __forceinline__ float2* fused_tab(const RunStage& st, int f) {
  return reinterpret_cast<float2*>(fused_rec(st, f) + kFusedRec);
}

// Shared memory of the staging of a run of n_terms terms, n_fused of its
// groups fused, `extra` bytes a term for the caller.
__host__ __device__ constexpr size_t stage_bytes(int n_terms, int n_fused, size_t extra) {
  return static_cast<size_t>(n_terms) * (sizeof(float4) + extra + 8) +
         static_cast<size_t>((n_terms + 1) & ~1) * 4 + 8 +
         static_cast<size_t>(n_fused) * kFusedBytes;
}

__device__ __forceinline__ uint32_t outer_pattern(const int32_t* rec, uint32_t outer) {
  uint32_t q = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) q |= (__popc(outer & static_cast<uint32_t>(rec[6 + i])) & 1u) << i;
  return q;
}

// The staging of a run for the block's first tile (outer: its outer bits):
// every term as before the fused groups (their members' scalars too: a
// branch on a loaded code word would hold the angle's load back), then each
// fused group's record and table from the layout and the call's angles.
__device__ __forceinline__ RunStage stage_run(unsigned char* smem, int n_terms, int n_fused,
                                              size_t extra, float dir, uint32_t outer,
                                              const int32_t* __restrict__ code,
                                              const int32_t* __restrict__ z_tile,
                                              const int32_t* __restrict__ z_out,
                                              const int32_t* __restrict__ frec,
                                              const float* __restrict__ angles,
                                              const float* __restrict__ phre,
                                              const float* __restrict__ phim) {
  RunStage st;
  st.coef = reinterpret_cast<float4*>(smem);
  st.extra = reinterpret_cast<unsigned char*>(st.coef + n_terms);
  st.code = reinterpret_cast<uint32_t*>(st.extra + extra * n_terms);
  st.zt = st.code + n_terms;
  st.zo = st.zt + n_terms;
  for (int t = threadIdx.x; t < n_terms; t += blockDim.x) {
    float sn, c;
    sincosf(angles[t], &sn, &c);
    const float pr = phre[t], pi = phim[t];
    st.coef[t] = make_float4(c, dir * sn * pi, -dir * sn * pr, 0.0f);
    const uint32_t kind = pr == 0.0f ? 0u : pi == 0.0f ? 1u : 2u;
    const uint32_t zo = static_cast<uint32_t>(z_out[t]);
    st.code[t] = static_cast<uint32_t>(code[t]) | (kind << 9) | ((__popc(outer & zo) & 1u) << 8);
    st.zt[t] = static_cast<uint32_t>(z_tile[t]);
    st.zo[t] = zo;
  }
  if (threadIdx.x == 0) *reinterpret_cast<int*>(fused_area(st)) = n_fused;
  for (int f = threadIdx.x; f < n_fused; f += blockDim.x) {
    int32_t* rec = fused_rec(st, f);
    for (int w = 0; w < kFusedRec; ++w) rec[w] = frec[f * kFusedRec + w];
    rec[10] = static_cast<int32_t>(outer_pattern(frec + f * kFusedRec, outer));
  }
  // the tables: entry q of group f, phi_q = sum_k a_k w_k (1 - 2 parity(q & coef_k)),
  // w_k the term's phase over the unit, in term order (the same bits every call)
  for (int e = threadIdx.x; e < n_fused * kFusedTable; e += blockDim.x) {
    const uint32_t head = static_cast<uint32_t>(frec[(e / kFusedTable) * kFusedRec]);
    const uint32_t q = static_cast<uint32_t>(e % kFusedTable);
    if (q >> ((head >> 12) & 7u)) continue;  // past the group's 2^R entries
    const int t0 = head & 255u, S = ((head >> 8) & 7u) + 1;
    const float* w = (head >> 15) & 1u ? phim : phre;
    float phi = 0.0f;
    for (int m = 0; m < S; ++m) {
      const float a = angles[t0 + m] * w[t0 + m];
      const uint32_t coef = (static_cast<uint32_t>(code[t0 + m]) >> 12) & 15u;
      phi += (__popc(q & coef) & 1u) ? -a : a;
    }
    float sn, c;
    sincosf(phi, &sn, &c);
    fused_tab(st, e / kFusedTable)[q] = make_float2(c, dir * sn);
  }
  return st;
}

// A later tile of the run: the outer sign of every term into code bit 8 and
// each fused group's outer pattern into word 10 of its record (after a block
// barrier since the staging).
__device__ __forceinline__ void set_outer_signs(const RunStage& st, int n_terms, uint32_t outer) {
  for (int t = threadIdx.x; t < n_terms; t += blockDim.x)
    st.code[t] = (st.code[t] & ~0x100u) | ((__popc(outer & st.zo[t]) & 1u) << 8);
  const int n_fused = *reinterpret_cast<const int*>(fused_area(st));
  for (int f = threadIdx.x; f < n_fused; f += blockDim.x) {
    int32_t* rec = fused_rec(st, f);
    rec[10] = static_cast<int32_t>(outer_pattern(rec, outer));
  }
}

__device__ __forceinline__ uint32_t case_key(uint32_t code) {
  return (code & 15u) | ((code >> 5) & 0x30u);
}

// Where this thread's 8 16-byte pieces of a tile live: piece m holds tile
// slots i = 2 (tid + m 2^(k-4)) and i + 1, at flat index
//   outer | deposit(i >> c, hi_mask) | (i & (2^c - 1))
// and at swizzled slot swz(i).  deposit and swz are linear over disjoint
// bits, so the thread's part and the three bits of m are computed once
// (this needs c <= k - 3: the bits of m lie above the row's column bits).
struct TileMap {
  uint32_t g0, gm[3], s0, sm[3];
  __device__ __forceinline__ TileMap(int k, int c, uint32_t outer, uint32_t hi_mask) {
    const uint32_t i0 = threadIdx.x << 1;
    g0 = outer | deposit(i0 >> c, hi_mask) | (i0 & ((1u << c) - 1u));
    s0 = swz(i0);
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      gm[b] = deposit(1u << (k - 3 - c + b), hi_mask);
      sm[b] = swz(1u << (k - 3 + b));
    }
  }
  __device__ __forceinline__ uint32_t global(int m) const {
    return g0 | (m & 1 ? gm[0] : 0u) | (m & 2 ? gm[1] : 0u) | (m & 4 ? gm[2] : 0u);
  }
  __device__ __forceinline__ uint32_t slot(int m) const {
    return s0 ^ (m & 1 ? sm[0] : 0u) ^ (m & 2 ? sm[1] : 0u) ^ (m & 4 ? sm[2] : 0u);
  }
};

// 16-byte async copies of a tile from the flat state
__device__ __forceinline__ void load_tile(float2* tile, const float2* __restrict__ g,
                                          const TileMap& map) {
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(tile + map.slot(m)));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(g + map.global(m)));
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

__device__ __forceinline__ void store_tile(const float2* tile, float2* __restrict__ g,
                                           const TileMap& map) {
#pragma unroll
  for (int m = 0; m < 8; ++m)
    *reinterpret_cast<float4*>(g + map.global(m)) =
        *reinterpret_cast<const float4*>(tile + map.slot(m));
}

// The slots of this thread in a register group: base (zeros at the four
// register bits), for the parity, and the swizzled slots, from the
// linearity of swz over disjoint bits.
struct GroupSlots {
  uint32_t base, sbase, sr[4];
  __device__ __forceinline__ explicit GroupSlots(uint32_t regs) {
    base = threadIdx.x;
#pragma unroll
    for (int b = 0; b < 4; ++b) {  // ascending positions
      const int p = (regs >> (4 * b)) & 15;
      sr[b] = swz(1u << p);
      base = insert_zero_bit(base, p);
    }
    sbase = swz(base);
  }
  __device__ __forceinline__ uint32_t at(int j) const {
    return sbase ^ (j & 1 ? sr[0] : 0u) ^ (j & 2 ? sr[1] : 0u) ^ (j & 4 ? sr[2] : 0u) ^
           (j & 8 ? sr[3] : 0u);
  }
};

__device__ __forceinline__ uint32_t term_flips(uint32_t code, uint32_t zt, uint32_t base) {
  const uint32_t odd = (__popc(base & zt) ^ (code >> 8)) & 1u;
  return kParity4[(code >> 4) & 15u] ^ (odd ? 0xffffu : 0u);
}

// A fused group's pattern of this thread's slot j: q0 ^ the columns of j's
// register bits.
struct FusedPattern {
  uint32_t q0, col[4];
  __device__ __forceinline__ FusedPattern(const int32_t* rec, uint32_t base) {
    q0 = static_cast<uint32_t>(rec[10]);
#pragma unroll
    for (int i = 0; i < 4; ++i) q0 ^= (__popc(base & static_cast<uint32_t>(rec[2 + i])) & 1u) << i;
    const uint32_t cols = static_cast<uint32_t>(rec[1]);
#pragma unroll
    for (int b = 0; b < 4; ++b) col[b] = (cols >> (4 * b)) & 15u;
  }
  __device__ __forceinline__ uint32_t at(int j) const {
    return q0 ^ (j & 1 ? col[0] : 0u) ^ (j & 2 ? col[1] : 0u) ^ (j & 4 ? col[2] : 0u) ^
           (j & 8 ? col[3] : 0u);
  }
};

// (c a - i s b, c b - i s a) for U = 0, (c a + s b, c b - s a) for U = 1: a
// pair of a fused group with its table entry t = (c, s).
template <int U>
__device__ __forceinline__ void fused_pair(float2& a, float2& b, float2 t) {
  const float2 a0 = a, b0 = b;
  if (U == 0) {
    a = make_float2(fmaf(t.y, b0.y, t.x * a0.x), fmaf(-t.y, b0.x, t.x * a0.y));
    b = make_float2(fmaf(t.y, a0.y, t.x * b0.x), fmaf(-t.y, a0.x, t.x * b0.y));
  } else {
    a = make_float2(fmaf(t.y, b0.x, t.x * a0.x), fmaf(t.y, b0.y, t.x * a0.y));
    b = make_float2(fmaf(-t.y, a0.x, t.x * b0.x), fmaf(-t.y, a0.y, t.x * b0.y));
  }
}

// (c - i s) a
__device__ __forceinline__ float2 fused_phase(float2 a, float2 t) {
  return make_float2(fmaf(t.y, a.y, t.x * a.x), fmaf(-t.y, a.x, t.x * a.y));
}

// A fused group forward on the tile, straight through shared memory (the
// group is its register group: no register copy of the 16 slots): exp(-i M)
// on this thread's slots, a pair at a time.
template <int X, int U>
__device__ __forceinline__ void fused_rotation_slots(float2* tile, const GroupSlots& s,
                                                     const float2* tab, const FusedPattern& q) {
  constexpr int kPivot = X & 8 ? 8 : X & 4 ? 4 : X & 2 ? 2 : 1;
#pragma unroll
  for (int j = 0; j < kRegSlots; ++j) {
    if (X == 0) {
      tile[s.at(j)] = fused_phase(tile[s.at(j)], tab[q.at(j)]);
    } else if ((j & kPivot) == 0) {
      float2 a = tile[s.at(j)], b = tile[s.at(j ^ X)];
      fused_pair<U>(a, b, tab[q.at(j)]);
      tile[s.at(j)] = a;
      tile[s.at(j ^ X)] = b;
    }
  }
}

__device__ __forceinline__ void fused_rotation(float2* tile, const RunStage& st, uint32_t code_t,
                                               const GroupSlots& s) {
  const int32_t* rec = fused_rec(st, code_t >> 20);
  const float2* tab = fused_tab(st, code_t >> 20);
  const FusedPattern q(rec, s.base);
  switch ((code_t & 15u) | ((static_cast<uint32_t>(rec[0]) >> 11) & 16u)) {
#define QSFH_FUSED_CASE(X, U)                        \
  case X | (U << 4):                                 \
    fused_rotation_slots<X, U>(tile, s, tab, q);     \
    break;
    QSFH_X_CASES(QSFH_FUSED_CASE, 0) QSFH_X_CASES(QSFH_FUSED_CASE, 1)
#undef QSFH_FUSED_CASE
  }
}

// The sums over the warp of the 16 values of each lane in 16 shuffles (a
// sum a value takes 5): lanes 16, 8, 4 and 2 apart trade halves of what they
// hold, then lanes 1 apart add; lane L ends with value L / 2.  The loops run
// over step counts, so that they unroll and v stays in registers.
__device__ __forceinline__ float transposed_warp_sum(float (&v)[2 * kFusedMaxTerms], int lane) {
#pragma unroll
  for (int step = 0; step < 4; ++step) {
    const int h = kFusedMaxTerms >> step, off = 16 >> step;
    const bool up = lane & off;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float send = up ? v[i] : v[i + h];
      const float keep = up ? v[i + h] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
}

// s_m(j) of a term's flips as +-1.0f
__device__ __forceinline__ float flip_unit(uint32_t flips, int j) {
  return __uint_as_float(0x3f800000u | sign_bit(flips, j));
}

// A fused group of the adjoint (its own register group; the first staged
// term t, its code word code_t) on the psi and lam tiles, a pair at a time:
// the pair's products conj(l[j]) p[j ^ X] (at the group's end state: its
// terms commute with its rotation) go into every term's signed sum acc[2m] +
// i acc[2m + 1] (the flips of terms past the group's 0), then the pair of
// each state is rotated by exp(+i M); the sums go over the warp into
// wsum[warp][t..t + S) by one transposed sum (before the string phase).
template <int X, int U>
__device__ __forceinline__ void fused_adjoint_xu(float2* pt, float2* lt, const RunStage& st, int t,
                                                 uint32_t code_t, const GroupSlots& s,
                                                 float2* wsum, int n_terms, int lane, int warp) {
  constexpr int kPivot = X & 8 ? 8 : X & 4 ? 4 : X & 2 ? 2 : 1;
  const int S = ((code_t >> 16) & 7u) + 1;
  const FusedPattern q(fused_rec(st, code_t >> 20), s.base);
  const float2* tab = fused_tab(st, code_t >> 20);
  uint32_t flips[kFusedMaxTerms];
  float acc[2 * kFusedMaxTerms];
#pragma unroll
  for (int m = 0; m < kFusedMaxTerms; ++m) {
    flips[m] = m < S ? term_flips(st.code[t + m], st.zt[t + m], s.base) : 0u;
    acc[2 * m] = acc[2 * m + 1] = 0.0f;
  }
#pragma unroll
  for (int j = 0; j < kRegSlots; ++j) {
    if (X == 0) {
      const float2 p = pt[s.at(j)], l = lt[s.at(j)], tj = tab[q.at(j)];
      const float2 d = cdot(l, p);
#pragma unroll
      for (int m = 0; m < kFusedMaxTerms; ++m) {
        const float f = flip_unit(flips[m], j);
        acc[2 * m] = fmaf(f, d.x, acc[2 * m]);
        acc[2 * m + 1] = fmaf(f, d.y, acc[2 * m + 1]);
      }
      pt[s.at(j)] = fused_phase(p, tj);
      lt[s.at(j)] = fused_phase(l, tj);
    } else if ((j & kPivot) == 0) {
      const int k = j ^ X;
      float2 pj = pt[s.at(j)], pk = pt[s.at(k)], lj = lt[s.at(j)], lk = lt[s.at(k)];
      const float2 dj = cdot(lj, pk), dk = cdot(lk, pj), tj = tab[q.at(j)];
#pragma unroll
      for (int m = 0; m < kFusedMaxTerms; ++m) {
        const float fj = flip_unit(flips[m], j), fk = flip_unit(flips[m], k);
        acc[2 * m] = fmaf(fk, dk.x, fmaf(fj, dj.x, acc[2 * m]));
        acc[2 * m + 1] = fmaf(fk, dk.y, fmaf(fj, dj.y, acc[2 * m + 1]));
      }
      fused_pair<U>(pj, pk, tj);
      fused_pair<U>(lj, lk, tj);
      pt[s.at(j)] = pj;
      pt[s.at(k)] = pk;
      lt[s.at(j)] = lj;
      lt[s.at(k)] = lk;
    }
  }
  const float sum = transposed_warp_sum(acc, lane);
  const int e = lane >> 1;  // term e / 2, its real (e even) or imaginary part
  if ((lane & 1) == 0 && (e >> 1) < S)
    reinterpret_cast<float*>(wsum)[2 * (warp * n_terms + t + (e >> 1)) + (e & 1)] = sum;
}

__device__ __forceinline__ void fused_adjoint(float2* pt, float2* lt, const RunStage& st, int t,
                                              uint32_t code_t, const GroupSlots& s, float2* wsum,
                                              int n_terms, int lane, int warp) {
  const uint32_t unit = (static_cast<uint32_t>(fused_rec(st, code_t >> 20)[0]) >> 11) & 16u;
  switch ((code_t & 15u) | unit) {
#define QSFH_FUSED_ADJ_CASE(X, U)                                                \
  case X | (U << 4):                                                             \
    fused_adjoint_xu<X, U>(pt, lt, st, t, code_t, s, wsum, n_terms, lane, warp); \
    break;
    QSFH_X_CASES(QSFH_FUSED_ADJ_CASE, 0) QSFH_X_CASES(QSFH_FUSED_ADJ_CASE, 1)
#undef QSFH_FUSED_ADJ_CASE
  }
}

// The register groups [g0, g1) of a rotation run on one tile in shared
// memory; group g covers the staged terms [gstart[g], gstart[g + 1]) -
// t_base.  Ends with the tile written back and the block synchronised.
__device__ __forceinline__ void rotation_groups(float2* tile, const RunStage& st,
                                                const int32_t* __restrict__ gstart,
                                                const int32_t* __restrict__ gregs, int g0,
                                                int g1, int t_base) {
  for (int g = g0; g < g1; ++g) {
    const uint32_t regs = static_cast<uint32_t>(gregs[g]);
    const GroupSlots s(regs);
    if (regs & kFusedGroup) {  // a fused group, its own register group: its terms at once
      fused_rotation(tile, st, st.code[gstart[g] - t_base], s);
      __syncthreads();
      continue;
    }
    float2 v[kRegSlots];
#pragma unroll
    for (int j = 0; j < kRegSlots; ++j) v[j] = tile[s.at(j)];
    const int t1 = gstart[g + 1] - t_base;
    for (int t = gstart[g] - t_base; t < t1; ++t) {
      const float4 cf = st.coef[t];
      const float2 m = make_float2(cf.y, cf.z);
      const uint32_t code_t = st.code[t];
      const uint32_t flips = term_flips(code_t, st.zt[t], s.base);
      switch (case_key(code_t)) {
#define QSFH_ROT_CASE(X, K)                  \
  case X | (K << 4):                         \
    rotate_slots<X, K>(v, flips, cf.x, m);   \
    break;
        QSFH_CASES(QSFH_ROT_CASE)
#undef QSFH_ROT_CASE
      }
    }
#pragma unroll
    for (int j = 0; j < kRegSlots; ++j) tile[s.at(j)] = v[j];
    __syncthreads();
  }
}

// The register groups [g0, g1) of an adjoint run on the tiles of psi (pt)
// and lam (lt): a thread's share of <lam | P_t psi> is summed over its warp
// into wsum[warp][t] (each warp owns its row: no atomics), t a staged term
// of the run's n_terms.  Ends as rotation_groups does.
__device__ __forceinline__ void adjoint_groups(float2* pt, float2* lt, const RunStage& st,
                                               float2* wsum, int n_terms,
                                               const int32_t* __restrict__ gstart,
                                               const int32_t* __restrict__ gregs, int g0,
                                               int g1, int t_base) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int g = g0; g < g1; ++g) {
    const uint32_t regs = static_cast<uint32_t>(gregs[g]);
    const GroupSlots s(regs);
    const int t0 = gstart[g] - t_base;
    if (regs & kFusedGroup) {  // a fused group, its own register group
      fused_adjoint(pt, lt, st, t0, st.code[t0], s, wsum, n_terms, lane, warp);
      __syncthreads();
      continue;
    }
    float2 p[kRegSlots], l[kRegSlots];
#pragma unroll
    for (int j = 0; j < kRegSlots; ++j) {
      p[j] = pt[s.at(j)];
      l[j] = lt[s.at(j)];
    }
    const int t1 = gstart[g + 1] - t_base;
    for (int t = t0; t < t1; ++t) {
      const uint32_t code_t = st.code[t];
      const float4 cf = st.coef[t];
      const float2 m = make_float2(cf.y, cf.z);
      const uint32_t flips = term_flips(code_t, st.zt[t], s.base);
      float2 share = make_float2(0.0f, 0.0f);
      switch (case_key(code_t)) {
#define QSFH_ADJ_CASE(X, K)                               \
  case X | (K << 4):                                      \
    adjoint_slots<X, K>(p, l, flips, cf.x, m, share);     \
    break;
        QSFH_CASES(QSFH_ADJ_CASE)
#undef QSFH_ADJ_CASE
      }
      share = warp_sum(share);
      if (lane == 0) wsum[warp * n_terms + t] = share;
    }
#pragma unroll
    for (int j = 0; j < kRegSlots; ++j) {
      pt[s.at(j)] = p[j];
      lt[s.at(j)] = l[j];
    }
    __syncthreads();
  }
}

// A tile's per-term sums of the warp rows, in warp order, times the string
// phase: partials[(t_base + t) * stride + column] for the run's terms.
__device__ __forceinline__ void write_term_partials(const float2* wsum, int n_terms,
                                                    const float* __restrict__ phre,
                                                    const float* __restrict__ phim,
                                                    float2* __restrict__ partials, int t_base,
                                                    size_t stride, size_t column) {
  const int n_warps = blockDim.x >> 5;
  for (int t = threadIdx.x; t < n_terms; t += blockDim.x) {
    float2 acc = make_float2(0.0f, 0.0f);
    for (int w = 0; w < n_warps; ++w) acc = cadd(acc, wsum[w * n_terms + t]);
    partials[static_cast<size_t>(t_base + t) * stride + column] =
        cmul(make_float2(phre[t], phim[t]), acc);
  }
}

// ---------------------------------------------------------------------------
// rotation_tile_runs: one tile run of a rotation segment, in place.
//
// Replaces rotation_stream_pallas / rotation_stream_planes, local and
// crossing kernels (qsfh_tpu/engine/pallas_kernels.py:2214, :2246, :2268,
// :2289): with tiles over chosen bit sets no term crosses a tile at 24
// qubits.  One block of 2^(k-4) threads per tile: cp.async copies the rows
// in while the run's per-term scalars are staged, the register groups run
// as above, the tile goes back.  The copies overlap the work of the other
// blocks on the SM (two or more fit); a persistent block with two tile
// buffers, measured on the H100, was slower, since it halves the blocks
// per SM and the work inside the tile needs the warps more than the
// overlap.  Bound: one HBM read and write of the state per run (2 x 128 MiB
// at n = 24); inside the run, shared memory once per register group and
// the float32 pipes per term.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(1 << (kTileMaxBits - 4), 2)
rotation_tile_run_kernel(float2* __restrict__ psi, int n, int k, int c, uint32_t tile_mask,
                         int n_terms, const int32_t* __restrict__ code,
                         const int32_t* __restrict__ z_tile, const int32_t* __restrict__ z_out,
                         const int32_t* __restrict__ gstart, const int32_t* __restrict__ gregs,
                         int n_groups, int t_base, const int32_t* __restrict__ frec, int n_fused,
                         const float* __restrict__ angles, const float* __restrict__ phre,
                         const float* __restrict__ phim) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* tile = reinterpret_cast<float2*>(smem);
  const uint32_t outer = deposit(blockIdx.x, ((1u << n) - 1u) & ~tile_mask);
  const uint32_t hi_mask = tile_mask & ~((1u << c) - 1u);
  load_tile(tile, psi, TileMap(k, c, outer, hi_mask));
  cp_async_commit();
  const RunStage st = stage_run(smem + (sizeof(float2) << k), n_terms, n_fused, 0, 1.0f, outer,
                                code, z_tile, z_out, frec, angles, phre, phim);
  cp_async_wait_all();
  __syncthreads();
  rotation_groups(tile, st, gstart, gregs, 0, n_groups, t_base);
  store_tile(tile, psi, TileMap(k, c, outer, hi_mask));
}

// ---------------------------------------------------------------------------
// adjoint_tile_runs: one tile run of the reverse adjoint sweep (terms in
// reversed order), in place on psi and lam.
//
// Replaces adjoint_stream_pallas, local and crossing kernels
// (qsfh_tpu/engine/pallas_kernels.py:2032, :2095, :2142).  The tiles of psi
// and lam (2 x 2^k complex64) share shared memory; one block per tile and
// register groups as in rotation_tile_runs, with 16 slots of each state
// per thread.  A thread's share of <lam | P_t psi> (post-gate, before the
// inverse rotation, without the string phase) is summed over its warp and
// written to wsum[warp][t] (each warp owns its row: no atomics); after the
// run the block adds the rows in warp order, applies the phase, and writes
// partials[t, block]; one reduce_partials_kernel per sweep sums over
// blocks in a fixed order.  Bound: one HBM read and write of psi and lam
// per run; inside, shared memory per group and the float32 pipes.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(1 << (kTileMaxBits - 4))
adjoint_tile_run_kernel(float2* __restrict__ psi, float2* __restrict__ lam, int n, int k, int c,
                        uint32_t tile_mask, int n_terms, const int32_t* __restrict__ code,
                        const int32_t* __restrict__ z_tile, const int32_t* __restrict__ z_out,
                        const int32_t* __restrict__ gstart, const int32_t* __restrict__ gregs,
                        int n_groups, int t_base, const int32_t* __restrict__ frec, int n_fused,
                        const float* __restrict__ angles, const float* __restrict__ phre,
                        const float* __restrict__ phim, float2* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* pt = reinterpret_cast<float2*>(smem);
  float2* lt = pt + (1u << k);
  const uint32_t outer = deposit(blockIdx.x, ((1u << n) - 1u) & ~tile_mask);
  const uint32_t hi_mask = tile_mask & ~((1u << c) - 1u);
  {
    const TileMap map(k, c, outer, hi_mask);
    load_tile(pt, psi, map);
    load_tile(lt, lam, map);
    cp_async_commit();
  }
  const int n_warps = blockDim.x >> 5;
  const RunStage st = stage_run(smem + 2 * (sizeof(float2) << k), n_terms, n_fused,
                                n_warps * sizeof(float2), -1.0f, outer, code, z_tile, z_out, frec,
                                angles, phre, phim);
  float2* wsum = reinterpret_cast<float2*>(st.extra);  // [warp][t]
  cp_async_wait_all();
  __syncthreads();
  adjoint_groups(pt, lt, st, wsum, n_terms, gstart, gregs, 0, n_groups, t_base);
  write_term_partials(wsum, n_terms, phre, phim, partials, 0, gridDim.x, blockIdx.x);
  const TileMap map(k, c, outer, hi_mask);
  store_tile(pt, psi, map);
  store_tile(lt, lam, map);
}

// ---------------------------------------------------------------------------
// Resident tile runs: a whole span of tile runs in ONE cooperative launch.
//
// rotation_resident replaces pauli_chain_pallas (the forward segment, its
// inverse and the Givens network both ways) and adjoint_resident replaces
// adjoint_chain_pallas (the reverse adjoint sweep),
// qsfh_tpu/engine/pallas_kernels.py:421-538 and :763-893.  The TPU kernels
// are one pallas_call per chain on a VMEM-resident state.  Here an
// 18-qubit state is 2 MiB (psi and lam 4 MiB) and stays in the 50 MB L2,
// so the counterpart is one launch that walks every run of the span: the
// state stays in L2 between runs, and a grid-wide barrier takes the place
// of a kernel boundary (the per-term route paid one launch, ~3 us, per
// term).
//
// The grid is persistent: G blocks, all co-resident (a cooperative launch;
// the host takes G from the occupancy of the kernel at its real dynamic
// shared memory, capped at the tiles of a run).  In run r, block b takes
// tiles o = b, b + G, ...: it copies tile o in with cp.async.cg (through
// L2: after a barrier a tile may hold lines another SM wrote, and L1 is not
// coherent across SMs), sets the outer signs of the run's staged terms for
// that tile, runs the register groups with the tile-run device code, and
// stores the tile back.  The adjoint writes one partial per (term, tile),
// partials[t, o], so the order of every sum is fixed by the layout and not
// by G; after a last barrier the blocks sum each term's row in the order
// of reduce_partials_kernel.  No float atomics: two calls on the same
// inputs give the same bits, whatever G.
//
// The run loop is pipelined: only the state's round trip lies between two
// runs.  Everything else a run needs is independent of the state and is
// made ready a run ahead, in the one of two stage buffers in shared memory
// that run r does not use (ResidentRun):
//   - at the start of run r, after its first tile's copy is issued, the
//     block reads run r + 1's bounds and copies its term arrays, fused
//     records and register-group table in with cp.async, while run r's
//     tile arrives and its groups run (the group loops then read no
//     global memory);
//   - after storing its tile of run r, the block arrives at a split-phase
//     grid barrier (SplitBarrier: a release reduction that returns
//     nothing), stages run r + 1 from that buffer with stage_run (the same
//     expressions as the tile-run kernels: the same bits), its outer signs
//     for its first tile of run r + 1 included, and only then waits.
// The critical path between runs is wait -> tile copy -> register groups
// -> store -> arrive.  A span of one run has nothing to prefetch.
//
// Bound at 18 qubits: the float32 pipes per term (~0.01 / 0.04 ms for the
// 467-term segment forward / adjoint), not bytes (one L2 pass of the state
// per run); in practice the in-tile work at ~4 warps per SM (2^n / 16
// threads in all) and one grid barrier per run.
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned int ld_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// A barrier across the blocks of a cooperative launch, in two halves, for
// the resident kernels.  Block 0 adds 2^31 - (G - 1) to the counter and
// every other block 1, so the top bit flips once all G have arrived and the
// low bits return to 0: one zeroed word serves every barrier of every
// launch on a stream.  arrive(): after a block barrier, thread 0 releases
// the block's stores with one reduction that returns nothing (red.release:
// no separate fence, and no returned value to wait for); wait(): thread 0
// polls (acquire) until the top bit flips, then a block barrier.  Work
// between the two overlaps the other blocks' arrivals.  Thread 0 reads the
// top bit once at the launch's start: no barrier of the launch completes
// before this block arrives, so that bit is the phase, and each barrier
// flips it.
struct SplitBarrier {
  unsigned int* count;
  unsigned int phase;  // thread 0's: the top bit until the next barrier completes
  __device__ __forceinline__ explicit SplitBarrier(unsigned int* word) : count(word), phase(0u) {
    if (threadIdx.x == 0) phase = ld_acquire(word) & 0x80000000u;
  }
  __device__ __forceinline__ void arrive() {
    __syncthreads();
    if (threadIdx.x == 0) {
      const unsigned int add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1u) : 1u;
      asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(count), "r"(add) : "memory");
    }
  }
  __device__ __forceinline__ void wait() {
    if (threadIdx.x == 0) {
      while (((ld_acquire(count) ^ phase) & 0x80000000u) == 0u) {
      }
      phase ^= 0x80000000u;
    }
    __syncthreads();
  }
};

// One of a resident block's two stage buffers: stage_run's staging of a
// run for most terms (most / 2 fused groups, `extra` bytes a term), then
// the run's header (t0, terms, fused records, register groups, tile mask)
// and the inputs stage_run and the group loops read, copied from the
// layout and the call's arrays (the terms' code, z_tile, z_out, angle,
// phre, phim; the fused records; group_start for its groups and the next,
// group_regs).  Pointer arithmetic from the buffer's base alone, so the
// compiler keeps them in shared memory.
constexpr int kResidentHeader = 5;  // words

__host__ __device__ constexpr size_t align16(size_t bytes) { return (bytes + 15) & ~size_t(15); }

__host__ __device__ constexpr size_t resident_buffer_bytes(int most, size_t extra) {
  return align16(stage_bytes(most, most / 2, extra)) +
         align16(sizeof(int32_t) * (kResidentHeader + 6 * static_cast<size_t>(most) +
                                    static_cast<size_t>(most / 2) * kFusedRec + 2 * most + 1));
}

struct ResidentRun {
  unsigned char* staged;
  int32_t* hdr;
  __device__ __forceinline__ ResidentRun(unsigned char* base, int most, size_t extra)
      : staged(base),
        hdr(reinterpret_cast<int32_t*>(base + align16(stage_bytes(most, most / 2, extra)))) {}
  __device__ __forceinline__ int t0() const { return hdr[0]; }
  __device__ __forceinline__ int terms() const { return hdr[1]; }
  __device__ __forceinline__ int n_fused() const { return hdr[2]; }
  __device__ __forceinline__ int n_groups() const { return hdr[3]; }
  __device__ __forceinline__ uint32_t mask() const { return static_cast<uint32_t>(hdr[4]); }
  // the inputs: array a (0 code, 1 z_tile, 2 z_out, 3 angles, 4 phre, 5 phim) of most terms
  __device__ __forceinline__ int32_t* term(int a, int most) const {
    return hdr + kResidentHeader + a * most;
  }
  __device__ __forceinline__ const float* termf(int a, int most) const {
    return reinterpret_cast<const float*>(term(a, most));
  }
  __device__ __forceinline__ int32_t* frec(int most) const { return term(6, most); }
  __device__ __forceinline__ int32_t* gstart(int most) const {
    return frec(most) + (most / 2) * kFusedRec;
  }
  __device__ __forceinline__ int32_t* gregs(int most) const { return gstart(most) + most + 1; }
};

// A 4-byte cp.async through L1 (the layout's tables and the call's arrays
// do not change during the launch)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

// all committed groups but the last
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Run r's header (thread 0) and inputs (every thread, by cp.async: the
// caller commits and waits) into buffer b.  Every thread reads the bounds
// (the same words: one transaction a warp).
__device__ __forceinline__ void fetch_run(const ResidentRun& b, int most, int r,
                                          const int32_t* __restrict__ run_start,
                                          const int32_t* __restrict__ run_mask,
                                          const int32_t* __restrict__ run_group,
                                          const int32_t* __restrict__ run_fgroup,
                                          const int32_t* __restrict__ code,
                                          const int32_t* __restrict__ z_tile,
                                          const int32_t* __restrict__ z_out,
                                          const int32_t* __restrict__ gstart,
                                          const int32_t* __restrict__ gregs,
                                          const int32_t* __restrict__ frec,
                                          const float* __restrict__ angles,
                                          const float* __restrict__ phre,
                                          const float* __restrict__ phim) {
  const int t0 = __ldg(run_start + r), T = __ldg(run_start + r + 1) - t0;
  const int f0 = __ldg(run_fgroup + r), nf = __ldg(run_fgroup + r + 1) - f0;
  const int g0 = __ldg(run_group + r), ng = __ldg(run_group + r + 1) - g0;
  if (threadIdx.x == 0) {
    b.hdr[0] = t0;
    b.hdr[1] = T;
    b.hdr[2] = nf;
    b.hdr[3] = ng;
    b.hdr[4] = __ldg(run_mask + r);
  }
  const void* src[6] = {code + t0, z_tile + t0, z_out + t0, angles + t0, phre + t0, phim + t0};
#pragma unroll
  for (int a = 0; a < 6; ++a)
    for (int t = threadIdx.x; t < T; t += blockDim.x)
      cp_async4(b.term(a, most) + t, static_cast<const int32_t*>(src[a]) + t);
  for (int w = threadIdx.x; w < nf * kFusedRec; w += blockDim.x)
    cp_async4(b.frec(most) + w, frec + f0 * kFusedRec + w);
  for (int g = threadIdx.x; g <= ng; g += blockDim.x) {
    cp_async4(b.gstart(most) + g, gstart + g0 + g);
    if (g < ng) cp_async4(b.gregs(most) + g, gregs + g0 + g);
  }
}

// The staging of buffer b's run for the block's first tile of it (outer:
// its outer bits), from the buffer's inputs (after a block barrier since
// they arrived)
__device__ __forceinline__ RunStage stage_buffer(const ResidentRun& b, int most, size_t extra,
                                                 float dir, uint32_t outer) {
  return stage_run(b.staged, b.terms(), b.n_fused(), extra, dir, outer,
                   b.term(0, most), b.term(1, most), b.term(2, most), b.frec(most),
                   b.termf(3, most), b.termf(4, most), b.termf(5, most));
}

__global__ void __launch_bounds__(1 << (kTileMaxBits - 4))
rotation_resident_kernel(float2* __restrict__ psi, int n, int k, int c, int n_runs, int most,
                         const int32_t* __restrict__ run_start,
                         const int32_t* __restrict__ run_mask,
                         const int32_t* __restrict__ run_group,
                         const int32_t* __restrict__ run_fgroup, const int32_t* __restrict__ code,
                         const int32_t* __restrict__ z_tile, const int32_t* __restrict__ z_out,
                         const int32_t* __restrict__ gstart, const int32_t* __restrict__ gregs,
                         const int32_t* __restrict__ frec, const float* __restrict__ angles,
                         const float* __restrict__ phre, const float* __restrict__ phim,
                         unsigned int* barrier) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* tile = reinterpret_cast<float2*>(smem);
  unsigned char* stage = smem + (sizeof(float2) << k);  // the two stage buffers
  const size_t stride = resident_buffer_bytes(most, 0);
  const uint32_t n_tiles = 1u << (n - k), all = (1u << n) - 1u, low = (1u << c) - 1u;
  SplitBarrier bar(barrier);
  const ResidentRun first(stage, most, 0);
  fetch_run(first, most, 0, run_start, run_mask, run_group, run_fgroup, code, z_tile, z_out, gstart,
            gregs, frec, angles, phre, phim);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  // the block's first tile of the next run (here run 0): its outer bits, copy map and staging
  uint32_t outer = deposit(blockIdx.x, all & ~first.mask());
  TileMap map(k, c, outer, first.mask() & ~low);
  RunStage st = stage_buffer(first, most, 0, 1.0f, outer);
  __syncthreads();
  for (int r = 0; r < n_runs; ++r) {
    const ResidentRun cur(stage + (r & 1) * stride, most, 0);
    const ResidentRun nxt(stage + ((r + 1) & 1) * stride, most, 0);
    const int T = cur.terms();
    const uint32_t mask = cur.mask();
    for (uint32_t o = blockIdx.x;;) {
      load_tile(tile, psi, map);
      cp_async_commit();
      if (o != blockIdx.x) {
        set_outer_signs(st, T, outer);
        cp_async_wait_all();
      } else if (r + 1 < n_runs) {  // run r + 1's inputs, in flight while run r computes
        fetch_run(nxt, most, r + 1, run_start, run_mask, run_group, run_fgroup, code, z_tile,
                  z_out, gstart, gregs, frec, angles, phre, phim);
        cp_async_commit();
        cp_async_wait_prior();
      } else {
        cp_async_wait_all();
      }
      __syncthreads();
      rotation_groups(tile, st, cur.gstart(most), cur.gregs(most), 0, cur.n_groups(), cur.t0());
      // each thread stores the slots it loads next: no barrier before the next copy
      store_tile(tile, psi, map);
      o += gridDim.x;
      if (o >= n_tiles) break;
      outer = deposit(o, all & ~mask);
      map = TileMap(k, c, outer, mask & ~low);
    }
    if (r + 1 < n_runs) {
      cp_async_wait_all();  // this thread's copies of run r + 1's inputs, before arrive's barrier
      bar.arrive();
      outer = deposit(blockIdx.x, all & ~nxt.mask());
      map = TileMap(k, c, outer, nxt.mask() & ~low);
      st = stage_buffer(nxt, most, 0, 1.0f, outer);
      bar.wait();
    }
  }
}

__global__ void __launch_bounds__(1 << (kResidentAdjointMaxBits - 4), 1)
adjoint_resident_kernel(float2* __restrict__ psi, float2* __restrict__ lam, int n, int k, int c,
                        int n_runs, int most, const int32_t* __restrict__ run_start,
                        const int32_t* __restrict__ run_mask,
                        const int32_t* __restrict__ run_group,
                        const int32_t* __restrict__ run_fgroup, const int32_t* __restrict__ code,
                        const int32_t* __restrict__ z_tile, const int32_t* __restrict__ z_out,
                        const int32_t* __restrict__ gstart, const int32_t* __restrict__ gregs,
                        const int32_t* __restrict__ frec, const float* __restrict__ angles,
                        const float* __restrict__ phre,
                        const float* __restrict__ phim, float2* __restrict__ partials,
                        float2* __restrict__ out, unsigned int* barrier) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* pt = reinterpret_cast<float2*>(smem);
  float2* lt = pt + (1u << k);
  unsigned char* stage = smem + 2 * (sizeof(float2) << k);  // the two stage buffers
  const uint32_t n_tiles = 1u << (n - k), all = (1u << n) - 1u, low = (1u << c) - 1u;
  const int n_warps = blockDim.x >> 5;
  const size_t extra = n_warps * sizeof(float2), stride = resident_buffer_bytes(most, extra);
  SplitBarrier bar(barrier);
  const ResidentRun first(stage, most, extra);
  fetch_run(first, most, 0, run_start, run_mask, run_group, run_fgroup, code, z_tile, z_out, gstart,
            gregs, frec, angles, phre, phim);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  // the block's first tile of the next run (here run 0): its outer bits, copy map and staging
  uint32_t outer = deposit(blockIdx.x, all & ~first.mask());
  TileMap map(k, c, outer, first.mask() & ~low);
  RunStage st = stage_buffer(first, most, extra, -1.0f, outer);
  __syncthreads();
  for (int r = 0; r < n_runs; ++r) {
    const ResidentRun cur(stage + (r & 1) * stride, most, extra);
    const ResidentRun nxt(stage + ((r + 1) & 1) * stride, most, extra);
    const int T = cur.terms();
    const uint32_t mask = cur.mask();
    float2* wsum = reinterpret_cast<float2*>(st.extra);  // [warp][t]
    for (uint32_t o = blockIdx.x;;) {
      load_tile(pt, psi, map);
      load_tile(lt, lam, map);
      cp_async_commit();
      if (o != blockIdx.x) {
        set_outer_signs(st, T, outer);
        cp_async_wait_all();
      } else if (r + 1 < n_runs) {  // run r + 1's inputs, in flight while run r computes
        fetch_run(nxt, most, r + 1, run_start, run_mask, run_group, run_fgroup, code, z_tile,
                  z_out, gstart, gregs, frec, angles, phre, phim);
        cp_async_commit();
        cp_async_wait_prior();
      } else {
        cp_async_wait_all();
      }
      __syncthreads();  // also: the previous tile's partials have read wsum
      adjoint_groups(pt, lt, st, wsum, T, cur.gstart(most), cur.gregs(most), 0, cur.n_groups(),
                     cur.t0());
      write_term_partials(wsum, T, cur.termf(4, most), cur.termf(5, most), partials, cur.t0(),
                          n_tiles, o);
      store_tile(pt, psi, map);
      store_tile(lt, lam, map);
      o += gridDim.x;
      if (o >= n_tiles) break;
      outer = deposit(o, all & ~mask);
      map = TileMap(k, c, outer, mask & ~low);
    }
    if (r + 1 < n_runs) {
      cp_async_wait_all();  // this thread's copies of run r + 1's inputs, before arrive's barrier
      bar.arrive();
      outer = deposit(blockIdx.x, all & ~nxt.mask());
      map = TileMap(k, c, outer, nxt.mask() & ~low);
      st = stage_buffer(nxt, most, extra, -1.0f, outer);
      bar.wait();
    } else {  // the partials, before the sums below
      bar.arrive();
      bar.wait();
    }
  }
  // out[t] = sum_o partials[t, o]: a warp per term, in reduce_partials_kernel's
  // order; the rows were written by other SMs, so they are read through L2
  const int lane = threadIdx.x & 31;
  const int T_all = run_start[n_runs];
  for (int t = blockIdx.x * n_warps + (threadIdx.x >> 5); t < T_all; t += gridDim.x * n_warps) {
    const float2* row = partials + static_cast<size_t>(t) * n_tiles;
    float2 acc = make_float2(0.0f, 0.0f);
    for (uint32_t j = lane; j < n_tiles; j += 32) acc = cadd(acc, __ldcg(row + j));
    acc = warp_sum(acc);
    if (lane == 0) out[t] = acc;
  }
}

// ---------------------------------------------------------------------------
// xor_gather: out[b] = psi[b ^ x], out of place.
//
// Replaces xor_gather_pallas / _xor_gather_kernel
// (qsfh_tpu/engine/pallas_kernels.py:369-418), whose XOR permutation was a
// matmul because Mosaic has no gather.  The pair (2q, 2q + 1) of out is
// the pair at 2q ^ (x & ~1) of psi, swapped when bit 0 of x is set: 16-byte
// loads and stores, two pairs a thread with both loads in flight before
// either store, and a grid sized to the pairs (no grid-stride loop).  The
// mask is a device scalar (the JAX mask is traced), int32 or int64: its low
// 32-bit word on this little-endian card, or, without one, an argument.
// Bound: one read and one write of the state, 2 x 8 B x 2^n.
// ---------------------------------------------------------------------------
constexpr int kGatherPairs = 2;  // pairs per thread

__global__ void xor_gather_kernel(const float4* __restrict__ psi, float4* __restrict__ out,
                                  uint32_t pairs, const uint32_t* __restrict__ mask_dev,
                                  uint32_t mask_arg) {
  const uint32_t x = mask_dev ? *mask_dev : mask_arg;
  const uint32_t xp = x >> 1;
  const uint32_t q0 = blockIdx.x * (kGatherPairs * blockDim.x) + threadIdx.x;
  float4 v[kGatherPairs];
#pragma unroll
  for (int m = 0; m < kGatherPairs; ++m) {
    const uint32_t q = q0 + m * blockDim.x;
    if (q < pairs) v[m] = psi[q ^ xp];
  }
#pragma unroll
  for (int m = 0; m < kGatherPairs; ++m) {
    const uint32_t q = q0 + m * blockDim.x;
    if (q < pairs) out[q] = (x & 1u) ? make_float4(v[m].z, v[m].w, v[m].x, v[m].y) : v[m];
  }
}

// ---------------------------------------------------------------------------
// pauli_rotation_out: out = exp(-i theta P) psi for ONE term, out of place.
//
// Replaces pauli_rotation_pallas (qsfh_tpu/engine/pallas_kernels.py:571,
// body _pauli_rot_kernel :541), which computes cos(theta) psi - i
// sin(theta) P psi from a permutation matmul.  Here, as in xor_gather, the
// state moves in 16-byte pairs of amplitudes (2q, 2q + 1): the partner of
// pair q is pair q ^ (x >> 1), its two amplitudes swapped when bit 0 of x
// is set.  A thread owns two pairs, q and q ^ (x >> 1) (q with the highest
// bit of x >> 1 clear), so each pair of psi is read once and each pair of
// out written once, both loads in flight before either store; for x >> 1
// = 0 (x = 0, the diagonal Z strings, or x = 1) a pair is its own partner,
// and a thread takes q and q + 2^(n - 2).  The scalars are arguments or
// one-element device tensors read in place (a traced angle needs no host
// sync).  Bound: one read and one write of the state, 2 x 8 B x 2^n (0.08
// ms at 24 qubits on an H100, where the per-term rotation on a copy moved
// twice that).
// ---------------------------------------------------------------------------
__device__ __forceinline__ float4 rotate_pair(float4 u, float4 v, uint32_t b, uint32_t z, float c,
                                              float2 m, bool swap) {
  // out[b + e] = c u[e] + s(b + e) m v[e ^ swap], e = 0, 1
  const float2 v0 = swap ? make_float2(v.z, v.w) : make_float2(v.x, v.y);
  const float2 v1 = swap ? make_float2(v.x, v.y) : make_float2(v.z, v.w);
  const float2 m0 = cmul(m, v0), m1 = cmul(m, v1);
  const uint32_t s0 = (__popc(b & z) & 1u) << 31, s1 = (__popc((b | 1u) & z) & 1u) << 31;
  return make_float4(fmaf(c, u.x, flip_sign(m0.x, s0)), fmaf(c, u.y, flip_sign(m0.y, s0)),
                     fmaf(c, u.z, flip_sign(m1.x, s1)), fmaf(c, u.w, flip_sign(m1.y, s1)));
}

__global__ void rotation_out_kernel(const float4* __restrict__ psi, float4* __restrict__ out, int n,
                                    const uint32_t* __restrict__ x_dev, uint32_t x_arg,
                                    const uint32_t* __restrict__ z_dev, uint32_t z_arg,
                                    const float* __restrict__ theta_dev, float theta_arg,
                                    const float* __restrict__ phre_dev, float phre_arg,
                                    const float* __restrict__ phim_dev, float phim_arg) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (1u << (n - 2))) return;
  const uint32_t x = x_dev ? *x_dev : x_arg;
  const uint32_t z = z_dev ? *z_dev : z_arg;
  const float theta = theta_dev ? *theta_dev : theta_arg;
  const float phre = phre_dev ? *phre_dev : phre_arg;
  const float phim = phim_dev ? *phim_dev : phim_arg;
  float sn, c;
  sincosf(theta, &sn, &c);
  const float2 m = make_float2(sn * phim, -sn * phre);  // -i sin(theta) ph
  const uint32_t xp = (x >> 1) & ((1u << (n - 1)) - 1u);
  const bool swap = x & 1u;
  uint32_t q0, q1;
  if (xp == 0u) {
    q0 = i;
    q1 = i + (1u << (n - 2));
  } else {
    q0 = insert_zero_bit(i, 31 - __clz(xp));
    q1 = q0 ^ xp;
  }
  const float4 u0 = psi[q0], u1 = psi[q1];
  if (xp == 0u) {
    out[q0] = rotate_pair(u0, u0, 2u * q0, z, c, m, swap);
    out[q1] = rotate_pair(u1, u1, 2u * q1, z, c, m, swap);
  } else {
    out[q0] = rotate_pair(u0, u1, 2u * q0, z, c, m, swap);
    out[q1] = rotate_pair(u1, u0, 2u * q1, z, c, m, swap);
  }
}

// ---------------------------------------------------------------------------
// The inner-product tile kernel (pauli_inner_tiles_kernel) and its fold
// (fold_partials_kernel): v_t = sum_b conj(a[b]) s_t(b) psi[b ^ x_t] for
// every term, over tiles of chosen bits, and in the pass that sums the
// blocks' partials the coefficients folded in: E = sum_t Re(c_t v_t)
// (expectation_grouped), 2 Im(c_t v_t) per term (screen_grouped), or v_t
// itself (pauli_inner_grouped).
//
// Replaces expectation_chain_pallas (qsfh_tpu/engine/pallas_kernels.py:645,
// body _expectation_chain_kernel :615) and screen_chain_pallas (:927, body
// :896), the 18-qubit kernels, which pass the state once per term, and
// expectation_stream_pallas / _planes, expectation_stream_fused and
// expectation_stream_fused_static (a = psi), and screen_stream_pallas /
// screen_stream_planes (a = w) (:1474, :1522, :1581, :1596, :1714, :1804),
// which stream it once per flip mask: at 24 qubits the 684 masks of the
// pool are 684 passes of 256 MiB, 54.8 ms of HBM.  Like the TPU kernels,
// these return the folded quantities themselves.  A mask of more than 4
// bits fits no item; the host sends its terms to pauli_inner (none in a
// Hubbard term list: every term is at most 4 ladder operators).
//
// The host (streaming.GroupTiles) cuts the terms into items: terms with
// one flip mask x and 4 bits J containing x on which alone their phase
// masks differ (every term of a Hubbard pool generator, and the hopping
// terms of H and S^2, differ only on x).  It covers the items' bits with
// tiles: flat bit sets of k bits, the low c (rows of 2^c contiguous
// amplitudes) and k - c chosen.  b and b ^ x lie in one tile, so one load
// of the a tile and the psi tile into shared memory serves every item of
// the tile: one pass of the state per tile (30 for the 2x6 pool).
//
// In a tile the slots of an item split by their bits on J into 16
// buckets, and term t of the item is
//     v_t = sum_j (-1)^popc(j & d_t) B[j],
//     B[j] = sum over slots i in bucket j of s(i) conj(a[i]) psi[i ^ x],
// with d_t the term's phase bits on J and s(i) the sign of the phase bits
// the item's terms share (one parity per lane, chunk and tile position).
// So a slot costs one complex product and one signed add, whatever the
// number of terms, and the terms are formed once per block from the 16
// sums.  A lane holds the 16 slots of one (lane bits, chunk bits) value,
// which differ only in J; x's bits come first in J, so psi[i ^ x] is slot
// j ^ (2^|x| - 1) of the same 16 (a static register permutation, one of 5
// cases).  Shared memory is XOR-swizzled (streaming.INNER_SWIZZLE, passed
// in `swizzle`), and the host picks each item's lane bits so that each
// half-warp's 64-bit loads spread over all 32 banks.
//
// The x = 0 terms (Sz, the Z and ZZ terms of H and S^2) form no items in
// the engine's layout (GroupTiles inner_diagonal): with u_p the values
// conj(a) psi on tile position p (|psi|^2, real, for a = psi) and U_p their
// Walsh-Hadamard transform over the tile's bits,
//     v_t = sum_p (-1)^popc(outer_p & z_out) U_p[z_in],
// so one transform per position (k 2^k adds) serves every x = 0 term of
// the list, each of which then reads one entry, where an item took a pass
// over the tile per 16 buckets (inner_diagonal: the tile bits above 8 in
// registers, the 5 lane bits by shuffles, the 3 warp bits through shared
// memory).
//
// Grid (unit, position slice): unit u of the schedule
// (GroupTiles.schedule) is a slice of one tile's items, or the diagonal on
// the last tile; a block walks `positions` consecutive tile positions
// (outer) of its unit.  At each position its 8 warps take the unit's items
// in turn; after an item's chunks the warp folds its lanes' 16 sums into 16
// (a reduce-scatter, 16 shuffles) and adds them to the item's sums in
// shared memory.  At the end the block writes each term's signed sum of
// its item's 16 values to partials[t, slice] (each row written by one
// block), and the fold pass sums each row in a fixed order, multiplies by
// the term's coefficient read by input index and writes the result: per
// term at out[order[t]], or for E one value per block of the fold, summed
// in a fixed order by the block that arrives last (an arrival count on
// the device, left at 0).  No float atomics: two calls give the same bits.
//
// Bound on this card.  At 2-8 MiB (18-20 qubits) the state sits in the
// 50 MB L2, and a call of 10-100 us is bound by the blocks in flight and
// the launch latency: a 12-bit tile has 64 positions at 18 qubits, so the
// tiles alone launched 64 (Sz) to 768 (pool) blocks of 8 warps, and x = 0
// items took a tile pass each.  The schedule cuts a tile's items into
// slices until the launch has 8 blocks per SM (copying a 32-64 KiB tile
// from L2 again costs less than an idle SM), the diagonal takes the x = 0
// terms, and the fold leaves no torch operation after the launch.  At 128
// MiB (24 qubits): the HBM passes, one per tile (a tile's slices and the
// diagonal read it once: the units of one position slice launch together
// and meet in L2), and the shared-memory reads (16 bytes per slot and item
// when a != psi, 8 when a = psi).
// ---------------------------------------------------------------------------

// Arithmetic on a coefficient that is a float (real) or a float2 (complex).
__device__ __forceinline__ float coef_add(float a, float b) { return a + b; }
__device__ __forceinline__ float2 coef_add(float2 a, float2 b) { return cadd(a, b); }
__device__ __forceinline__ float coef_sub(float a, float b) { return a - b; }
__device__ __forceinline__ float2 coef_sub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float coef_shfl(float v, int m) {
  return __shfl_xor_sync(0xffffffffu, v, m);
}
__device__ __forceinline__ float2 coef_shfl(float2 v, int m) {
  return make_float2(__shfl_xor_sync(0xffffffffu, v.x, m), __shfl_xor_sync(0xffffffffu, v.y, m));
}
// acc + c p
__device__ __forceinline__ float2 coef_fma(float c, float2 p, float2 acc) {
  return make_float2(fmaf(c, p.x, acc.x), fmaf(c, p.y, acc.y));
}
__device__ __forceinline__ float2 coef_fma(float2 c, float2 p, float2 acc) {
  return make_float2(fmaf(c.x, p.x, fmaf(-c.y, p.y, acc.x)), fmaf(c.x, p.y, fmaf(c.y, p.x, acc.y)));
}
// one Walsh-Hadamard butterfly seen from one side: the slot with the bit
// clear keeps v + p, the one with the bit set p - v
template <typename T>
__device__ __forceinline__ T butterfly(T v, T p, bool up) {
  return up ? coef_sub(p, v) : coef_add(v, p);
}

constexpr int kInnerTileWarps = 8;
constexpr int kInnerTileThreads = 32 * kInnerTileWarps;
constexpr int kInnerTileMinBits = 9;       // 5 lane bits and the 4 bucket bits
constexpr int kInnerTileMaxBits = 13;
constexpr int kItemCols = 16;              // a row of streaming.GroupTiles.item_cols

// The shared-memory slot of tile slot t: t with the swizzle of its bits
// from 4 up folded into its low 4 bits.
__device__ __forceinline__ uint32_t inner_slot(uint32_t t, uint64_t swizzle) {
  uint32_t v = t;
  for (int b = 4; (t >> b) != 0u; ++b)
    if ((t >> b) & 1u) v ^= static_cast<uint32_t>(swizzle >> (4 * (b - 4))) & 15u;
  return v;
}

// One item at one tile position: this lane's share of the 16 bucket sums,
// B[j] += s conj(a[i_j]) psi[i_j ^ x] over the item's chunks, where i_j is
// the slot with this lane's lane bits, chunk bits ch and bucket bits j
// (shared-memory slot base ^ jo[j]), psi[i_j ^ x] is slot j ^ XJ of the
// same 16, and s = parity(l9 & zlc) ^ sign0 with l9 = lane | ch << 5.
template <bool SAME, int XJ>
__device__ __forceinline__ void inner_item(const float2* at, const float2* pt, uint32_t lane_off,
                                           const uint32_t (&cc)[4], const uint32_t (&jo)[16],
                                           int chunks, uint32_t lane, uint32_t zlc,
                                           uint32_t sign0, float2 (&B)[16]) {
  for (int ch = 0; ch < chunks; ++ch) {
    const uint32_t base = lane_off ^ (ch & 1 ? cc[0] : 0u) ^ (ch & 2 ? cc[1] : 0u) ^
                          (ch & 4 ? cc[2] : 0u) ^ (ch & 8 ? cc[3] : 0u);
    const uint32_t l9 = lane | (static_cast<uint32_t>(ch) << 5);
    const float s = __uint_as_float(0x3f800000u | (((__popc(l9 & zlc) ^ sign0) & 1u) << 31));
    float2 av[16], pv[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      av[j] = at[base ^ jo[j]];
      if (!SAME) pv[j] = pt[base ^ jo[j]];
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 u = av[j];
      const float2 v = SAME ? av[j ^ XJ] : pv[j ^ XJ];
      if (SAME && XJ == 0) {
        B[j].x = fmaf(s, fmaf(u.x, u.x, u.y * u.y), B[j].x);
      } else {
        B[j].x = fmaf(s, fmaf(u.x, v.x, u.y * v.y), B[j].x);
        B[j].y = fmaf(s, fmaf(u.x, v.y, -u.y * v.x), B[j].y);
      }
    }
  }
}

// Halves the warp's bucket sums over one lane bit: a lane keeps the half
// of B[0, 2H) that its lane bit selects, plus the partner's share of it.
template <int H>
__device__ __forceinline__ void fold_buckets(float2 (&B)[16], uint32_t lane) {
  const bool up = (lane & (2u * H)) != 0u;
#pragma unroll
  for (int m = 0; m < H; ++m) {
    const float2 lo = B[m], hi = B[m + H];
    const float2 send = up ? lo : hi;
    const float2 keep = up ? hi : lo;
    B[m] = make_float2(keep.x + __shfl_xor_sync(0xffffffffu, send.x, 2 * H),
                       keep.y + __shfl_xor_sync(0xffffffffu, send.y, 2 * H));
  }
}

// The list's diagonal (its x = 0 terms) over the tile positions [p0, p1)
// of the tile `mask`: per position this thread's R = 2^(k - 8) slots t =
// tid | r << 8 of conj(a) psi (|psi|^2 with T = float, a = psi), their
// Walsh-Hadamard transform over the tile, U[m] = sum_t (-1)^popc(t & m)
// u[t] (the r bits in registers, the 5 lane bits by shuffles, the 3 warp
// bits through shared memory), then term e adds (-1)^popc(outer & zout[e])
// U[zin[e]] to its sum (thread e mod 256 owns term e).  Ends with the sums
// in partials[(row0 + e) * gridDim.y + blockIdx.y].
template <typename T, int R>
__device__ __forceinline__ void inner_diagonal(unsigned char* smem, const float2* __restrict__ a,
                                               const float2* __restrict__ psi, int n, int c,
                                               uint32_t mask, uint32_t p0, uint32_t p1,
                                               const int32_t* __restrict__ zin,
                                               const int32_t* __restrict__ zout, int n_diag,
                                               int row0, float2* __restrict__ partials) {
  constexpr bool kSame = std::is_same<T, float>::value;
  constexpr int kLogR = R == 2 ? 1 : R == 4 ? 2 : R == 8 ? 3 : R == 16 ? 4 : 5;
  T* U = reinterpret_cast<T*>(smem);
  float2* dsum = reinterpret_cast<float2*>(smem + sizeof(T) * (R << 8));
  const uint32_t tid = threadIdx.x;
  for (int e = static_cast<int>(tid); e < n_diag; e += kInnerTileThreads)
    dsum[e] = make_float2(0.0f, 0.0f);
  // slot t at flat index outer | deposit(t >> c, hi) | (t & low), linear in t
  const uint32_t low = (1u << c) - 1u, hi = mask & ~low;
  const uint32_t rest = ((1u << n) - 1u) & ~mask;
  const uint32_t gt = deposit(tid >> c, hi) | (tid & low);
  uint32_t gb[kLogR];
#pragma unroll
  for (int b = 0; b < kLogR; ++b) {
    const uint32_t t = 1u << (8 + b);
    gb[b] = deposit(t >> c, hi) | (t & low);
  }
  for (uint32_t p = p0; p < p1; ++p) {
    const uint32_t outer = deposit(p, rest);
    T v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      uint32_t g = outer | gt;
#pragma unroll
      for (int b = 0; b < kLogR; ++b)
        if ((r >> b) & 1) g |= gb[b];
      const float2 pv = psi[g];
      if constexpr (kSame)
        v[r] = fmaf(pv.x, pv.x, pv.y * pv.y);
      else
        v[r] = cdot(a[g], pv);
    }
#pragma unroll
    for (int b = 0; b < kLogR; ++b) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!((r >> b) & 1)) {
          const T lo = v[r], up = v[r | (1 << b)];
          v[r] = coef_add(lo, up);
          v[r | (1 << b)] = coef_sub(lo, up);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < 5; ++b) {
      const bool up = (tid >> b) & 1u;
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = butterfly(v[r], coef_shfl(v[r], 1 << b), up);
    }
#pragma unroll
    for (int b = 5; b < 8; ++b) {
      __syncthreads();  // every read of U (the last stage, position or terms) is done
#pragma unroll
      for (int r = 0; r < R; ++r) U[tid | (r << 8)] = v[r];
      __syncthreads();
      const bool up = (tid >> b) & 1u;
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = butterfly(v[r], U[(tid ^ (1u << b)) | (r << 8)], up);
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) U[tid | (r << 8)] = v[r];
    __syncthreads();
    for (int e = static_cast<int>(tid); e < n_diag; e += kInnerTileThreads) {
      const T u = U[__ldg(zin + e)];
      const uint32_t sbit = (__popc(outer & static_cast<uint32_t>(__ldg(zout + e))) & 1u) << 31;
      if constexpr (kSame) {
        dsum[e].x += flip_sign(u, sbit);
      } else {
        dsum[e].x += flip_sign(u.x, sbit);
        dsum[e].y += flip_sign(u.y, sbit);
      }
    }
  }
  for (int e = static_cast<int>(tid); e < n_diag; e += kInnerTileThreads)
    partials[static_cast<size_t>(row0 + e) * gridDim.y + blockIdx.y] = dsum[e];
}

// inner_diagonal at a tile of k bits (9 <= k <= 13: 2 to 32 slots a thread)
template <typename T>
__device__ __forceinline__ void inner_diagonal_k(int k, unsigned char* smem,
                                                 const float2* __restrict__ a,
                                                 const float2* __restrict__ psi, int n, int c,
                                                 uint32_t mask, uint32_t p0, uint32_t p1,
                                                 const int32_t* __restrict__ zin,
                                                 const int32_t* __restrict__ zout, int n_diag,
                                                 int row0, float2* __restrict__ partials) {
  switch (k) {
    case 9:
      inner_diagonal<T, 2>(smem, a, psi, n, c, mask, p0, p1, zin, zout, n_diag, row0, partials);
      break;
    case 10:
      inner_diagonal<T, 4>(smem, a, psi, n, c, mask, p0, p1, zin, zout, n_diag, row0, partials);
      break;
    case 11:
      inner_diagonal<T, 8>(smem, a, psi, n, c, mask, p0, p1, zin, zout, n_diag, row0, partials);
      break;
    case 12:
      inner_diagonal<T, 16>(smem, a, psi, n, c, mask, p0, p1, zin, zout, n_diag, row0, partials);
      break;
    default:
      inner_diagonal<T, 32>(smem, a, psi, n, c, mask, p0, p1, zin, zout, n_diag, row0, partials);
      break;
  }
}

template <bool SAME>
__global__ void __launch_bounds__(kInnerTileThreads, 2)
pauli_inner_tiles_kernel(const float2* __restrict__ a, const float2* __restrict__ psi, int n,
                         int k, int c, uint64_t swizzle, const int32_t* __restrict__ tile_mask,
                         const int4* __restrict__ units, const int32_t* __restrict__ item_cols,
                         const int32_t* __restrict__ item_x, const int32_t* __restrict__ item_zlc,
                         const int32_t* __restrict__ item_zout,
                         const int32_t* __restrict__ item_start,
                         const int32_t* __restrict__ term_d, const int32_t* __restrict__ diag_zin,
                         const int32_t* __restrict__ diag_zout, int n_diag, int diag_row,
                         int positions, int t_base, float2* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int4 unit = units[blockIdx.x];  // (tile, first item, items, diagonal)
  const uint32_t mask = static_cast<uint32_t>(tile_mask[unit.x]);
  const uint32_t p0 = blockIdx.y * static_cast<uint32_t>(positions);
  const uint32_t p1 = min(p0 + static_cast<uint32_t>(positions), 1u << (n - k));
  if (unit.w) {
    using T = typename std::conditional<SAME, float, float2>::type;
    inner_diagonal_k<T>(k, smem, a, psi, n, c, mask, p0, p1, diag_zin, diag_zout, n_diag,
                        diag_row - t_base, partials);
    return;
  }
  const int tid = threadIdx.x, warp = tid >> 5;
  const uint32_t lane = static_cast<uint32_t>(tid & 31);
  const int i0 = unit.y, n_items = unit.z;
  float2* pt = reinterpret_cast<float2*>(smem);
  float2* at = SAME ? pt : pt + (1u << k);
  float2* acc = pt + (SAME ? 1u : 2u) * (1u << k);  // [item][bucket]
  for (int e = tid; e < 16 * n_items; e += kInnerTileThreads) acc[e] = make_float2(0.0f, 0.0f);

  // this thread copies the tile slots tid | m << 8: flat index
  // outer | deposit(t >> c, hi) | (t & low) and shared slot inner_slot(t),
  // both linear in t, so the parts of tid and of each bit of m are formed once
  const uint32_t low = (1u << c) - 1u;
  const uint32_t hi = mask & ~low;
  const uint32_t rest = ((1u << n) - 1u) & ~mask;
  const uint32_t t0 = static_cast<uint32_t>(tid);
  const uint32_t g0 = deposit(t0 >> c, hi) | (t0 & low), s0 = inner_slot(t0, swizzle);
  uint32_t gb[5], sb[5];
#pragma unroll
  for (int b = 0; b < 5; ++b) {
    const uint32_t t = 1u << (8 + b);
    gb[b] = deposit(t >> c, hi) | (t & low);
    sb[b] = inner_slot(t, swizzle);
  }
  const int copies = 1 << (k - 8);
  const int chunks = 1 << (k - 9);
  for (uint32_t p = p0; p < p1; ++p) {
    const uint32_t outer = deposit(p, rest);
#pragma unroll
    for (int m = 0; m < (1 << (kInnerTileMaxBits - 8)); ++m) {
      if (m < copies) {
        uint32_t g = outer | g0, sl = s0;
#pragma unroll
        for (int b = 0; b < 5; ++b) {
          if ((m >> b) & 1) {
            g ^= gb[b];
            sl ^= sb[b];
          }
        }
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                         static_cast<uint32_t>(__cvta_generic_to_shared(pt + sl))),
                     "l"(psi + g));
        if (!SAME)
          asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                           static_cast<uint32_t>(__cvta_generic_to_shared(at + sl))),
                       "l"(a + g));
      }
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    for (int it = warp; it < n_items; it += kInnerTileWarps) {
      const int item = i0 + it;
      const int4* row = reinterpret_cast<const int4*>(item_cols + kItemCols * item);
      const int4 q0 = __ldg(row), q1 = __ldg(row + 1), q2 = __ldg(row + 2), q3 = __ldg(row + 3);
      // columns: lane bits 0-4, bucket bits 5-8, chunk bits 9-12
      const uint32_t lc[5] = {static_cast<uint32_t>(q0.x), static_cast<uint32_t>(q0.y),
                              static_cast<uint32_t>(q0.z), static_cast<uint32_t>(q0.w),
                              static_cast<uint32_t>(q1.x)};
      const uint32_t jc[4] = {static_cast<uint32_t>(q1.y), static_cast<uint32_t>(q1.z),
                              static_cast<uint32_t>(q1.w), static_cast<uint32_t>(q2.x)};
      const uint32_t cc[4] = {static_cast<uint32_t>(q2.y), static_cast<uint32_t>(q2.z),
                              static_cast<uint32_t>(q2.w), static_cast<uint32_t>(q3.x)};
      uint32_t lane_off = 0u;
#pragma unroll
      for (int b = 0; b < 5; ++b)
        if ((lane >> b) & 1u) lane_off ^= lc[b];
      uint32_t jo[16];
      jo[0] = 0u;
#pragma unroll
      for (int j = 1; j < 16; ++j) jo[j] = jo[j & (j - 1)] ^ jc[j & 1 ? 0 : j & 2 ? 1 : j & 4 ? 2 : 3];
      const uint32_t zlc = static_cast<uint32_t>(__ldg(item_zlc + item));
      const uint32_t sign0 = __popc(outer & static_cast<uint32_t>(__ldg(item_zout + item))) & 1u;
      float2 B[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) B[j] = make_float2(0.0f, 0.0f);
      switch (__ldg(item_x + item)) {
        case 0:
          inner_item<SAME, 0>(at, pt, lane_off, cc, jo, chunks, lane, zlc, sign0, B);
          break;
        case 1:
          inner_item<SAME, 1>(at, pt, lane_off, cc, jo, chunks, lane, zlc, sign0, B);
          break;
        case 3:
          inner_item<SAME, 3>(at, pt, lane_off, cc, jo, chunks, lane, zlc, sign0, B);
          break;
        case 7:
          inner_item<SAME, 7>(at, pt, lane_off, cc, jo, chunks, lane, zlc, sign0, B);
          break;
        default:
          inner_item<SAME, 15>(at, pt, lane_off, cc, jo, chunks, lane, zlc, sign0, B);
          break;
      }
      // lane l ends with the warp's sum of bucket l >> 1
      fold_buckets<8>(B, lane);
      fold_buckets<4>(B, lane);
      fold_buckets<2>(B, lane);
      fold_buckets<1>(B, lane);
      const float2 v = make_float2(B[0].x + __shfl_xor_sync(0xffffffffu, B[0].x, 1),
                                   B[0].y + __shfl_xor_sync(0xffffffffu, B[0].y, 1));
      if ((lane & 1u) == 0u) {
        float2& s = acc[16 * it + (lane >> 1)];
        s = make_float2(s.x + v.x, s.y + v.y);
      }
    }
    __syncthreads();
  }
  __syncthreads();  // acc complete (and zeroed, for a block with no position)
  for (int it = warp; it < n_items; it += kInnerTileWarps) {
    const float2* sums = acc + 16 * it;
    for (int t = item_start[i0 + it] + static_cast<int>(lane); t < item_start[i0 + it + 1];
         t += 32) {
      const uint32_t d = static_cast<uint32_t>(term_d[t]);
      float2 v = make_float2(0.0f, 0.0f);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const uint32_t sbit = (__popc(static_cast<uint32_t>(j) & d) & 1u) << 31;
        v.x += flip_sign(sums[j].x, sbit);
        v.y += flip_sign(sums[j].y, sbit);
      }
      partials[static_cast<size_t>(t - t_base) * gridDim.y + blockIdx.y] = v;
    }
  }
}

// The fold of the inner-product tile kernel's partials, one warp per row t
// of `order` (dest = order + the chunk's first row): v = sum_j
// partials[t, j] in a fixed order, then by `mode`
//   0: out (float2) [dest[t]] = v;
//   1: out (float) [dest[t]] = 2 Im(c v), c = (cre, cim)[dest[t] * cstride];
//   2: out (float) [0] = sum_t Re(c v) (+ out[0] with accumulate): each
//      block sums its warps' values in warp order into bsum[block], and
//      the block whose arrival on `count` is the last sums bsum in a fixed
//      order and sets count back to 0.
__global__ void fold_partials_kernel(const float2* __restrict__ partials, int n_blocks,
                                     int n_terms, const int32_t* __restrict__ dest, int mode,
                                     const float* __restrict__ cre, const float* __restrict__ cim,
                                     int cstride, void* __restrict__ out, float* __restrict__ bsum,
                                     unsigned int* __restrict__ count, int accumulate) {
  __shared__ float wsum[kThreads / 32];
  __shared__ bool last;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.x * (blockDim.x >> 5) + warp;
  float val = 0.0f;
  if (t < n_terms) {
    const float2* row = partials + static_cast<size_t>(t) * n_blocks;
    float2 acc = make_float2(0.0f, 0.0f);
    for (int j = lane; j < n_blocks; j += 32) acc = cadd(acc, row[j]);
    acc = warp_sum(acc);
    const int d = dest[t];
    if (mode == 0) {
      if (lane == 0) static_cast<float2*>(out)[d] = acc;
    } else {
      const float cr = __ldg(cre + static_cast<size_t>(d) * cstride);
      const float ci = __ldg(cim + static_cast<size_t>(d) * cstride);
      if (mode == 1 && lane == 0) static_cast<float*>(out)[d] = 2.0f * (cr * acc.y + ci * acc.x);
      val = cr * acc.x - ci * acc.y;
    }
  }
  if (mode != 2) return;  // the whole block leaves together
  if (lane == 0) wsum[warp] = val;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) s += wsum[w];
    bsum[blockIdx.x] = s;
    __threadfence();
    last = atomicAdd(count, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last && warp == 0) {
    float s = 0.0f;
    for (int j = lane; j < static_cast<int>(gridDim.x); j += 32) s += __ldcg(bsum + j);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) {
      float* e = static_cast<float*>(out);
      *e = accumulate ? *e + s : s;
      *count = 0u;
    }
  }
}

// ---------------------------------------------------------------------------
// pauli_apply_grouped (pauli_apply_tiles_kernel): out[b] = sum_t c_t s_t(b)
// psi[b ^ x_t] over the items and tiles of streaming.GroupTiles, the layout
// the inner products use.
//
// Replaces apply_chain_pallas (qsfh_tpu/engine/pallas_kernels.py:715, body
// _apply_chain_kernel :688), apply_stream_pallas (:1870, bodies :1106 and
// the static kernel) and apply_stream_fused (:2002, body :1935).  The
// per-term pauli_apply gathers psi[b ^ x_t] once per term and output
// amplitude: at 24 qubits 109 gathers over a 128 MiB state, ~14 GB through
// L2 for 0.27 GB of compulsory bytes.  Here one launch per tile passes the
// state once: the block copies the psi tile of its tile position into
// shared memory in tile order (16-byte cp.async: tile bit 0 is flat bit
// 0), and every item of the tile reads its partners from there.
//
// An item's terms share x and agree off the 4 bits J, so on a tile slot i
//     sum_{t in item} c_t s_t(i) = s(i) C[j(i)],
//     C[j] = sum_{t in item} c_t (-1)^popc(j & d_t),
// a 16-point Walsh transform of the item's coefficients (d_t = term_d),
// with j(i) the slot's bits on J and s(i) the sign of the phase bits the
// terms share (item_zt on the tile, item_zout off it).  The block forms
// each item's table of the 32 values (-1)^s C[j] at j | s << 4 from the
// coefficients it is given, in shared memory, while its tile copy is in
// flight; where every coefficient of the tile is real (H, S^2 and Sz of a
// Hubbard model) it reads a float copy of the tables (one 128-byte row: a
// warp's loads are one wavefront) and multiplies by real numbers: on an
// H100, 12% less device time on H psi at 18 and 24 qubits than a build
// with the complex tables only (chip_smoke.py --profile).  Thread
// tid owns the 16 slots tid | r << (k - 4), r = 0..15, in registers for
// the whole launch (8 slots a thread, twice the warps, measured slower).
// (j(i), s(i)) is linear in i, so a thread's 16 table offsets of an item
// are its base entry XOR the indices of the top 4 tile bits (item_ehi):
// per item and slot one shared load and one add into coef[r]; the items
// of one x in a row then share one load of psi[i ^ x] (slot sa[r] ^
// item_xa: a warp's 32 slots stay one aligned 256-byte row, no bank
// conflict) and one multiply-add into acc[r].
//
// A tile whose x = 0 items the layout took as a diagonal (GroupTiles:
// tile_diag, diag_*; the Coulomb and Z terms of H) takes them as one
// instead: the block writes their spectrum (one entry per phase mask on
// the tile, its terms' coefficients signed by the phase bits off the tile)
// and transforms it (Walsh-Hadamard: the top 4 tile bits in registers, the
// lane bits by shuffles, the warp bits through shared memory), ~30
// instructions a slot for all of them, then d(i) psi[i] into acc[r].
//
// The block writes its tile at the end, through shared memory in 16-byte
// stores: the call's first tile stores out, each later tile adds to it
// (its out tile comes in by cp.async while the items run; one launch per
// tile, in a fixed order, no float atomics: two calls give the same bits).
//
// Bound on this card: at 24 qubits the HBM bytes, one read of psi and one
// write of out (0.27 GB); the float32 work per amplitude (4 flops a mask
// and 1 an item for the real coefficients of H) takes less.  This layout
// moves 1.07 GB for the 2x6 H (per tile one read of psi and one store or
// read-add of out).  8-byte copies and stores, one amplitude a thread,
// reached less than half the HBM rate on these tiles; 16-byte ones, and
// the out tile staged while the items run, are what it does about it.
// ---------------------------------------------------------------------------

// A thread's slots span the top kApplyTopBits tile bits; the layout's
// item_ehi is built for 4 (streaming.GroupTiles), as is TileMap's 8 pairs.
constexpr int kApplyTopBits = 4;
constexpr int kApplySlots = 1 << kApplyTopBits;  // slots a thread owns
constexpr int kApplyTileMaxThreads = 512;        // 2^(k - 4) threads, k <= 13
constexpr int kApplyTable = 32;  // entries of an item's table: (-1)^s C[j] at j | s << 4

// The byte offsets in shared memory of this thread's 16 table entries of
// one item, in a table of entries of `entry` bytes at `table`: entry
// (jb | s << 4) ^ e(r), jb the thread's bucket bits, s its sign, e(r) the
// XOR of the 5-bit indices of the top tile bits set in r (item_ehi).
__device__ __forceinline__ void apply_item_offsets(uint32_t (&E)[kApplySlots], uint32_t table,
                                                   uint32_t entry, uint32_t tid, uint32_t outer,
                                                   uint32_t jt, uint32_t zt, uint32_t ehi,
                                                   uint32_t zo) {
  uint32_t jb = 0u;
#pragma unroll
  for (int m = 0; m < 4; ++m) jb |= ((tid >> ((jt >> (4 * m)) & 15u)) & 1u) << m;
  const uint32_t s = (__popc(tid & zt) ^ __popc(outer & zo)) & 1u;
  uint32_t e[kApplyTopBits];
#pragma unroll
  for (int b = 0; b < kApplyTopBits; ++b) e[b] = ((ehi >> (5 * b)) & 31u) * entry;
  E[0] = table + (jb | s << 4) * entry;
#pragma unroll
  for (int r = 1; r < kApplySlots; ++r)
    E[r] = E[r & (r - 1)] ^ e[r & 1 ? 0 : r & 2 ? 1 : r & 4 ? 2 : 3];  // r's lowest bit
}

__device__ __forceinline__ void load_coef(float& v, const float2& s) { v = s.x; }
__device__ __forceinline__ void load_coef(float2& v, const float2& s) { v = s; }

// The tile's diagonal (its x = 0 terms) on this thread's 16 slots into
// acc: d(t) = sum_z spec[z] (-1)^popc(t & z), the Walsh-Hadamard transform
// of the spectrum the block wrote at `spec` (float2, tile coordinates;
// with T = float its real parts), over the top 4 tile bits in registers,
// the 5 lane bits by shuffles and the warp bits through the same shared
// memory; then acc += d psi.
template <typename T>
__device__ __forceinline__ void apply_diagonal(unsigned char* smem, uint32_t spec_off,
                                               uint32_t tid, int hb,
                                               const uint32_t (&sa)[kApplySlots],
                                               float2 (&acc)[kApplySlots]) {
  const float2* spec2 = reinterpret_cast<const float2*>(smem + spec_off);
  T* spec = reinterpret_cast<T*>(smem + spec_off);
  T v[kApplySlots];
#pragma unroll
  for (int r = 0; r < kApplySlots; ++r)
    load_coef(v[r], spec2[tid + (static_cast<uint32_t>(r) << hb)]);
#pragma unroll
  for (int b = 0; b < kApplyTopBits; ++b) {
#pragma unroll
    for (int r = 0; r < kApplySlots; ++r) {
      if (!((r >> b) & 1)) {
        const T a = v[r], c = v[r | (1 << b)];
        v[r] = coef_add(a, c);
        v[r | (1 << b)] = coef_sub(a, c);
      }
    }
  }
#pragma unroll
  for (int b = 0; b < 5; ++b) {
    const bool up = (tid >> b) & 1u;
#pragma unroll
    for (int r = 0; r < kApplySlots; ++r) v[r] = butterfly(v[r], coef_shfl(v[r], 1 << b), up);
  }
  for (int b = 5; b < hb; ++b) {
    __syncthreads();  // every read of the previous stage (or of the spectrum) is done
#pragma unroll
    for (int r = 0; r < kApplySlots; ++r) spec[tid + (static_cast<uint32_t>(r) << hb)] = v[r];
    __syncthreads();
    const bool up = (tid >> b) & 1u;
#pragma unroll
    for (int r = 0; r < kApplySlots; ++r)
      v[r] = butterfly(v[r], spec[(tid ^ (1u << b)) + (static_cast<uint32_t>(r) << hb)], up);
  }
#pragma unroll
  for (int r = 0; r < kApplySlots; ++r)
    acc[r] = coef_fma(v[r], *reinterpret_cast<const float2*>(smem + sa[r]), acc[r]);
}

// The items [i0, i0 + n_items) of one tile on this thread's 16 slots into
// acc (the x = 0 items skipped where the diagonal took them): per item one
// table entry per slot (float with REAL, the tile's coefficients all real;
// float2 otherwise), summed over a run of items of one x, then one partner
// load psi[slot ^ x] and product per slot.
template <bool REAL>
__device__ __forceinline__ void apply_items(const unsigned char* smem, uint32_t table, int i0,
                                            int n_items, bool skip_diagonal, uint32_t tid,
                                            uint32_t outer, const uint32_t (&sa)[kApplySlots],
                                            float2 (&acc)[kApplySlots],
                                            const int32_t* __restrict__ item_jt,
                                            const int32_t* __restrict__ item_zt,
                                            const int32_t* __restrict__ item_xa,
                                            const int32_t* __restrict__ item_ehi,
                                            const int32_t* __restrict__ item_zout) {
  constexpr uint32_t entry = REAL ? sizeof(float) : sizeof(float2);
  using Coef = typename std::conditional<REAL, float, float2>::type;
  uint32_t E[kApplySlots];
  int it = 0;
  while (it < n_items) {
    const uint32_t xa = static_cast<uint32_t>(__ldg(item_xa + i0 + it));
    if (skip_diagonal && xa == 0u) {
      while (it < n_items && __ldg(item_xa + i0 + it) == 0) ++it;
      continue;
    }
    Coef coef[kApplySlots];
    bool first = true;
    do {
      const int item = i0 + it;
      apply_item_offsets(E, table + static_cast<uint32_t>(it) * kApplyTable * entry, entry, tid,
                         outer, static_cast<uint32_t>(__ldg(item_jt + item)),
                         static_cast<uint32_t>(__ldg(item_zt + item)),
                         static_cast<uint32_t>(__ldg(item_ehi + item)),
                         static_cast<uint32_t>(__ldg(item_zout + item)));
      if (first) {
#pragma unroll
        for (int r = 0; r < kApplySlots; ++r)
          coef[r] = *reinterpret_cast<const Coef*>(smem + E[r]);
      } else {
#pragma unroll
        for (int r = 0; r < kApplySlots; ++r)
          coef[r] = coef_add(coef[r], *reinterpret_cast<const Coef*>(smem + E[r]));
      }
      first = false;
      ++it;
    } while (it < n_items && static_cast<uint32_t>(__ldg(item_xa + i0 + it)) == xa);
    const uint32_t xo = xa * static_cast<uint32_t>(sizeof(float2));
#pragma unroll
    for (int r = 0; r < kApplySlots; ++r)
      acc[r] = coef_fma(coef[r], *reinterpret_cast<const float2*>(smem + (sa[r] ^ xo)), acc[r]);
  }
}

// 16-byte copy, global to shared, through L2 only
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}

__global__ void __launch_bounds__(kApplyTileMaxThreads)
pauli_apply_tiles_kernel(const float2* __restrict__ psi, float2* __restrict__ out, int n, int k,
                         int c, uint32_t mask, int i0, int n_items, int d0, int d1,
                         const int32_t* __restrict__ item_start,
                         const int32_t* __restrict__ term_d, const int32_t* __restrict__ order,
                         const int32_t* __restrict__ item_jt, const int32_t* __restrict__ item_zt,
                         const int32_t* __restrict__ item_xa, const int32_t* __restrict__ item_ehi,
                         const int32_t* __restrict__ item_zout,
                         const int32_t* __restrict__ diag_zin,
                         const int32_t* __restrict__ diag_start,
                         const int32_t* __restrict__ diag_term,
                         const int32_t* __restrict__ diag_zout, const float* __restrict__ cre,
                         const float* __restrict__ cim, int cstride, int accumulate) {
  // shared memory, tiles in tile order: the psi tile (2^k float2); the out
  // tile (2^k float2: first the diagonal's spectrum, then the out tile of
  // a later tile, then this tile's result); the items' float2 tables
  // (kApplyTable each) and the same tables' real parts (float)
  extern __shared__ __align__(16) unsigned char smem[];
  float2* pt = reinterpret_cast<float2*>(smem);
  const uint32_t otab = static_cast<uint32_t>(sizeof(float2)) << k;
  float2* ot = reinterpret_cast<float2*>(smem + otab);
  const uint32_t ctab = 2u * otab;
  const uint32_t rtab = ctab + static_cast<uint32_t>(n_items) * kApplyTable * sizeof(float2);
  float2* ctables = reinterpret_cast<float2*>(smem + ctab);
  float* rtables = reinterpret_cast<float*>(smem + rtab);
  const uint32_t tid = threadIdx.x;
  const int hb = k - kApplyTopBits;  // the register slots' tile bits: hb .. k - 1
  const bool diagonal = d1 > d0;

  // Tile bit 0 is flat bit 0 (c >= 1), so the slots (2q, 2q + 1) are 16
  // contiguous bytes: thread tid copies and stores the 8 pairs of the tile
  // runs' TileMap, q = tid + m 2^hb, in tile order here (no swizzle).
  static_assert(kApplySlots == 16, "TileMap moves 8 pairs a thread");
  const uint32_t rest = ((1u << n) - 1u) & ~mask;
  const uint32_t outer = deposit(blockIdx.x, rest);
  const TileMap map(k, c, outer, mask & ~((1u << c) - 1u));
  const uint32_t tp = 2u * tid;  // the first slot of this thread's first pair
#pragma unroll
  for (int m = 0; m < kApplySlots / 2; ++m)
    cp_async16(pt + tp + (static_cast<uint32_t>(m) << (hb + 1)), psi + map.global(m));
  cp_async_commit();

  // this thread's 16 slots tid | r << hb: their byte offsets in a tile
  uint32_t sa[kApplySlots];
#pragma unroll
  for (int r = 0; r < kApplySlots; ++r)
    sa[r] = (tid | (static_cast<uint32_t>(r) << hb)) * static_cast<uint32_t>(sizeof(float2));

  // while the copy is in flight: the spectrum of the diagonal (zero, then
  // one entry per z on the tile: the sum of its terms' signed coefficients
  // in a fixed order), the items' tables (C[j] at j, -C[j] at j | 16), and
  // whether any coefficient of the tile is complex
  if (diagonal) {
#pragma unroll
    for (int r = 0; r < kApplySlots; ++r)
      *reinterpret_cast<float2*>(smem + otab + sa[r]) = make_float2(0.0f, 0.0f);
    __syncthreads();
  }
  int complex_coeffs = 0;
  for (int e = d0 + static_cast<int>(tid); e < d1; e += blockDim.x) {
    float2 v = make_float2(0.0f, 0.0f);
    for (int t = diag_start[e]; t < diag_start[e + 1]; ++t) {
      const int o = diag_term[t] * cstride;
      const uint32_t sbit =
          (__popc(outer & static_cast<uint32_t>(diag_zout[t])) & 1u) << 31;
      v.x += flip_sign(__ldg(cre + o), sbit);
      v.y += flip_sign(__ldg(cim + o), sbit);
    }
    ot[diag_zin[e]] = v;
    complex_coeffs |= v.y != 0.0f;
  }
  for (int e = static_cast<int>(tid); e < 16 * n_items; e += blockDim.x) {
    const int it = e >> 4, item = i0 + it;
    if (diagonal && __ldg(item_xa + item) == 0) continue;
    const uint32_t j = static_cast<uint32_t>(e & 15);
    float2 v = make_float2(0.0f, 0.0f);
    for (int t = item_start[item]; t < item_start[item + 1]; ++t) {
      const int o = order[t] * cstride;
      const uint32_t sbit = (__popc(j & static_cast<uint32_t>(term_d[t])) & 1u) << 31;
      v.x += flip_sign(__ldg(cre + o), sbit);
      v.y += flip_sign(__ldg(cim + o), sbit);
    }
    ctables[it * kApplyTable + j] = v;
    ctables[it * kApplyTable + j + 16] = make_float2(-v.x, -v.y);
    rtables[it * kApplyTable + j] = v.x;
    rtables[it * kApplyTable + j + 16] = -v.x;
    complex_coeffs |= v.y != 0.0f;
  }
  cp_async_wait_all();
  const bool real = !__syncthreads_or(complex_coeffs);

  float2 acc[kApplySlots];
#pragma unroll
  for (int r = 0; r < kApplySlots; ++r) acc[r] = make_float2(0.0f, 0.0f);
  if (diagonal) {
    if (real)
      apply_diagonal<float>(smem, otab, tid, hb, sa, acc);
    else
      apply_diagonal<float2>(smem, otab, tid, hb, sa, acc);
    __syncthreads();  // the out tile is free again
  }
  // a later tile adds to out: its out tile comes in during the items
  if (accumulate) {
#pragma unroll
    for (int m = 0; m < kApplySlots / 2; ++m)
      cp_async16(ot + tp + (static_cast<uint32_t>(m) << (hb + 1)), out + map.global(m));
    cp_async_commit();
  }
  if (real)
    apply_items<true>(smem, rtab, i0, n_items, diagonal, tid, outer, sa, acc, item_jt, item_zt,
                      item_xa, item_ehi, item_zout);
  else
    apply_items<false>(smem, ctab, i0, n_items, diagonal, tid, outer, sa, acc, item_jt, item_zt,
                       item_xa, item_ehi, item_zout);
  if (accumulate) {
    cp_async_wait_all();
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < kApplySlots; ++r) {
    float2* o = reinterpret_cast<float2*>(smem + otab + sa[r]);
    *o = accumulate ? cadd(*o, acc[r]) : acc[r];
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < kApplySlots / 2; ++m)
    *reinterpret_cast<float4*>(out + map.global(m)) =
        *reinterpret_cast<const float4*>(ot + tp + (static_cast<uint32_t>(m) << (hb + 1)));
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

// Streaming multiprocessors of the current device (132 on an H100 SXM),
// read once per device.
inline int sm_count() {
  static int cached[16] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 16) return 1;
  if (cached[dev] == 0)
    cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
  return max(cached[dev], 1);
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

inline bool tile_shape_ok(int n, int k, int c) {
  return k >= kTileMinBits && k <= kTileMaxBits && k <= n && c >= 1 && c <= k - 3;
}

// Dynamic shared memory of a resident launch: the tile(s), then two stage
// buffers (resident_buffer_bytes) for the longest run (the adjoint's
// staging adds a float2 per warp and term for the warp rows), its fused
// groups at most one per two terms.
inline size_t resident_smem(bool adjoint, int k, int most_terms) {
  const size_t tiles = (adjoint ? 2 : 1) * (sizeof(float2) << k);
  const size_t warp_rows = adjoint ? ((1u << (k - 4)) / 32) * sizeof(float2) : 0;
  return tiles + 2 * resident_buffer_bytes(most_terms, warp_rows);
}

inline const void* resident_kernel(bool adjoint) {
  return adjoint ? reinterpret_cast<const void*>(adjoint_resident_kernel)
                 : reinterpret_cast<const void*>(rotation_resident_kernel);
}

// Blocks of a resident kernel that the device holds at once (the largest
// cooperative grid), or a negative CUDA error code.
inline int resident_capacity(bool adjoint, int k, int most_terms) {
  if (k < kTileMinBits || k > (adjoint ? kResidentAdjointMaxBits : kTileMaxBits) ||
      most_terms < 1 || most_terms > kMaxRunTerms)
    return -static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  const size_t smem = resident_smem(adjoint, k, most_terms);
  if (err == cudaSuccess)
    err = adjoint ? allow_smem(adjoint_resident_kernel, smem)
                  : allow_smem(rotation_resident_kernel, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, resident_kernel(adjoint),
                                                        1 << (k - 4), smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (per_sm < 1) return -static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  return per_sm * sm_count();
}

// Checks, the longest run's terms and the shared memory of a resident
// launch of `grid` blocks; run_start is the HOST copy of the span's run table.
inline cudaError_t resident_setup(bool adjoint, int n, int k, int c, int n_runs,
                                  const int32_t* run_start, int grid, int* most, size_t* smem) {
  if (!tile_shape_ok(n, k, c) || (adjoint && k > kResidentAdjointMaxBits) || n_runs < 1 ||
      grid < 1 || grid > (1 << (n - k)))
    return cudaErrorInvalidValue;
  *most = 0;
  for (int r = 0; r < n_runs; ++r) *most = max(*most, run_start[r + 1] - run_start[r]);
  if (*most < 1 || *most > kMaxRunTerms) return cudaErrorInvalidValue;
  *smem = resident_smem(adjoint, k, *most);
  return adjoint ? allow_smem(adjoint_resident_kernel, *smem)
                 : allow_smem(rotation_resident_kernel, *smem);
}

// ---------------------------------------------------------------------------
// expectation_norm_f64: E = sum_b sum_t c_t s_t(b) conj(psi[b]) psi[b ^ x_t]
// (real part) and N = sum_b |psi[b]|^2 of a complex64 state, in float64.
//
// No TPU Pallas counterpart: the JAX package reads this energy with plain
// jnp in double-float arithmetic (qsfh_tpu/engine/dfloat.py:173-243,
// expectation_norm_df), pairs of float32 carried through error-free
// transforms, because the TPU has no float64.  Hopper has native float64:
// a product of two float32 values is exact in float64, so each
// conj(psi[b]) psi[b ^ x] is formed exactly and the sums carry float64
// rounding.  Terms come sorted by flip mask, one group per mask
// (starts[g] .. starts[g + 1], mask xs[starts[g]]); each group's weight
// w(b) = sum_t c_t s_t(b) is summed from float64 coefficients.  A simple
// grid-stride loop, a thread per amplitude at a time; each block writes
// its (E, N) partial, and one block sums the partials in a fixed order:
// no float atomics, so two calls give the same bits.  Bound: one read of
// the state (8 B an amplitude) against ~10 float64 flops per flip mask and
// amplitude; at 18 qubits the state sits in L2 and the float64 rate binds.
// Each thread gathers psi[b ^ x] once per flip mask, so past L2 every mask
// costs a pass of the state: expectation_f64_tiles (below) is the readout's
// route from 9 qubits on, and this kernel serves smaller states and the
// terms of masks that fit no tile.
// ---------------------------------------------------------------------------
constexpr int kF64Threads = 256;
constexpr int kF64BlocksPerSm = 8;

__device__ double2 warp_sum_f64(double2 v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, off);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, off);
  }
  return v;
}

// Sum over the block in a fixed order; the result is valid in thread 0.
__device__ double2 block_sum_f64(double2 v) {
  __shared__ double2 warp_part[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum_f64(v);
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  const int n_warps = blockDim.x >> 5;
  v = (threadIdx.x < n_warps) ? warp_part[lane] : make_double2(0.0, 0.0);
  if (warp == 0) v = warp_sum_f64(v);
  return v;
}

__global__ void __launch_bounds__(kF64Threads)
expectation_norm_f64_kernel(const float2* __restrict__ psi, uint32_t dim, int n_groups,
                            const int32_t* __restrict__ starts, const int32_t* __restrict__ xs,
                            const int32_t* __restrict__ zs, const double* __restrict__ cre,
                            const double* __restrict__ cim, double2* __restrict__ partials) {
  double e = 0.0, norm = 0.0;
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t b = blockIdx.x * blockDim.x + threadIdx.x; b < dim; b += stride) {
    const float2 a = psi[b];
    const double ar = a.x, ai = a.y;
    norm += ar * ar + ai * ai;
    for (int g = 0; g < n_groups; ++g) {
      const int t0 = starts[g], t1 = starts[g + 1];
      const float2 p = psi[b ^ static_cast<uint32_t>(xs[t0])];
      const double pr = ar * p.x + ai * p.y;  // conj(a) * p
      const double pi = ar * p.y - ai * p.x;
      double wr = 0.0, wi = 0.0;
      for (int t = t0; t < t1; ++t) {
        const bool neg = __popc(b & static_cast<uint32_t>(zs[t])) & 1;
        wr += neg ? -cre[t] : cre[t];
        wi += neg ? -cim[t] : cim[t];
      }
      e += wr * pr - wi * pi;
    }
  }
  const double2 sum = block_sum_f64(make_double2(e, norm));
  if (threadIdx.x == 0) partials[blockIdx.x] = sum;
}

// out = [E, 0, N, 0] from the blocks' partials, summed in a fixed order.
__global__ void __launch_bounds__(kF64Threads)
sum_f64_partials_kernel(const double2* __restrict__ partials, int n_blocks,
                        double* __restrict__ out) {
  double2 acc = make_double2(0.0, 0.0);
  for (int j = threadIdx.x; j < n_blocks; j += blockDim.x) {
    acc.x += partials[j].x;
    acc.y += partials[j].y;
  }
  acc = block_sum_f64(acc);
  if (threadIdx.x == 0) {
    out[0] = acc.x;
    out[1] = 0.0;
    out[2] = acc.y;
    out[3] = 0.0;
  }
}

inline int f64_blocks(int n) {
  const unsigned blocks = blocks_for(1ull << n, kF64Threads);
  const unsigned cap = static_cast<unsigned>(sm_count()) * kF64BlocksPerSm;
  return static_cast<int>(blocks < cap ? blocks : cap);
}

// ---------------------------------------------------------------------------
// The float64 group engine: rot64_groups, happly64 and adjoint64_groups.
//
// No TPU Pallas counterpart: these replace the JAX package's host C++ float64
// engine (qsfh_tpu/native/statevec64.cpp: qsfh_sv64_apply :153,
// qsfh_sv64_happly :171, qsfh_sv64_adjoint :203), which runs the flagship's
// float64 polish (L-BFGS and Newton-CG on the 1719-operator 3x3 ansatz) on
// the host.  A program is a list of groups of rotation terms that share one
// flip mask x, one parameter and one parity of x & z, so they commute:
//     psi <- exp(-i theta_g M_g) psi,   M_g psi[b] = unit_g r_g(b) psi[b ^ x],
//     r_g(b) = sum_k w_k s_k(b),   s_k(b) = (-1)^popcount(b & z_k),
// unit 1 (gflip 0) or i (gflip 1), each term's string phase folded into its
// real weight w_k, at most 8 terms a group.  The state is complex128, one
// double2 per amplitude.  Each block forms the group's 2^S-entry tables of
// r, cos(theta r) and sin(theta r) in shared memory from w and
// theta_ext[gpidx[g]] (the angles are read on the device, so the launch
// sequence carries no host scalar); a thread owns the pair (b, b ^ x), b the
// member whose highest bit of x is clear (one amplitude where x = 0), forms
// b's parity pattern with S __popc, and the partner's pattern is its
// complement where gflip is set (parity(x & z_k) is the group's).  One
// launch per group, the group loop in C.  Bound: at 18 qubits a group pass
// is 4 MiB of L2-resident traffic against 6 float64 flops an amplitude
// forward and 17 in the adjoint (1931 groups: ~0.09 and ~0.25 ms at 34
// TFLOP/s), so the launch rate binds, not the arithmetic; rot64_resident /
// adjoint64_resident (below) chain the groups in shared-memory tiles where
// the layout allows, and these kernels serve the programs it does not.  No
// atomics: the adjoint's contributions are block partials per group, summed
// per parameter in a fixed order by one fold kernel, so two calls give the
// same bits.
// ---------------------------------------------------------------------------
constexpr int kRot64Threads = 256;
constexpr int kRot64MaxTerms = 8;
constexpr int kRot64BlocksPerSm = 8;

// A group's phase masks and its tables: r[p] = sum_k w_k (1 - 2 bit_k(p)),
// c[p] / s[p] = cos / sin(theta r[p]), for the S-bit parity patterns p.
struct Group64Tables {
  uint32_t z[kRot64MaxTerms];
  double r[1 << kRot64MaxTerms];
  double c[1 << kRot64MaxTerms];
  double s[1 << kRot64MaxTerms];
};

// Fill the tables of group g (every thread of the block calls it); returns S.
__device__ int group64_tables(Group64Tables& t, int g, const int32_t* __restrict__ goff,
                              const int32_t* __restrict__ zsub, const double* __restrict__ wsub,
                              const int32_t* __restrict__ gpidx,
                              const double* __restrict__ theta_ext) {
  const int t0 = goff[g];
  const int S = goff[g + 1] - t0;
  const double theta = theta_ext[gpidx[g]];
  if (static_cast<int>(threadIdx.x) < S) t.z[threadIdx.x] = static_cast<uint32_t>(zsub[t0 + threadIdx.x]);
  for (int p = threadIdx.x; p < (1 << S); p += blockDim.x) {
    double r = 0.0;  // summed in term order, as the host engine sums it
    for (int k = 0; k < S; ++k) r += ((p >> k) & 1) ? -wsub[t0 + k] : wsub[t0 + k];
    double sn, cs;
    sincos(theta * r, &sn, &cs);
    t.r[p] = r;
    t.c[p] = cs;
    t.s[p] = sn;
  }
  __syncthreads();
  return S;
}

// bit k of the pattern = parity(b & z_k)
__device__ __forceinline__ uint32_t group64_pattern(uint32_t b, const uint32_t* z, int S) {
  uint32_t pat = 0;
  for (int k = 0; k < S; ++k) pat |= static_cast<uint32_t>(__popc(b & z[k]) & 1) << k;
  return pat;
}

// The pair updates of every float64 group kernel, with the rounding pinned
// (an explicit fma over an explicit product, which the compiler does not
// contract again), so that the per-group and resident kernels give the
// same bits: (c v.x - s w.y, c v.y + s w.x) = c v + i s w, and (c v.x + s
// w.x, c v.y + s w.y) = c v + s w.
__device__ __forceinline__ double2 rot64_mix_unit1(double c, double s, double2 v, double2 w) {
  return make_double2(__fma_rn(c, v.x, -__dmul_rn(s, w.y)), __fma_rn(c, v.y, __dmul_rn(s, w.x)));
}

__device__ __forceinline__ double2 rot64_mix_uniti(double c, double s, double2 v, double2 w) {
  return make_double2(__fma_rn(c, v.x, __dmul_rn(s, w.x)), __fma_rn(c, v.y, __dmul_rn(s, w.y)));
}

// psi <- exp(-i theta_g M_g) psi for group g, in place (qsfh_sv64_apply's
// rot_pass and diag_pass, dir = -1).
__global__ void __launch_bounds__(kRot64Threads)
rot64_group_kernel(double2* __restrict__ psi, int n, int g, const int32_t* __restrict__ gx,
                   const int32_t* __restrict__ goff, const int32_t* __restrict__ gflip,
                   const int32_t* __restrict__ gpidx, const int32_t* __restrict__ zsub,
                   const double* __restrict__ wsub, const double* __restrict__ theta_ext) {
  __shared__ Group64Tables t;
  const int S = group64_tables(t, g, goff, zsub, wsub, gpidx, theta_ext);
  const uint32_t x = static_cast<uint32_t>(gx[g]);
  const uint32_t stride = gridDim.x * blockDim.x;
  const uint32_t first = blockIdx.x * blockDim.x + threadIdx.x;
  if (x == 0) {  // psi[b] *= exp(-i theta r(b))
    for (uint32_t b = first; b < (1u << n); b += stride) {
      const uint32_t pb = group64_pattern(b, t.z, S);
      const double2 a = psi[b];
      psi[b] = rot64_mix_unit1(t.c[pb], -t.s[pb], a, a);
    }
    return;
  }
  const int hbit = 31 - __clz(x);
  const bool unit_i = gflip[g] != 0;
  const uint32_t pxor = unit_i ? (1u << S) - 1u : 0u;
  for (uint32_t i = first; i < (1u << (n - 1)); i += stride) {
    const uint32_t b = insert_zero_bit(i, hbit);
    const uint32_t p = b ^ x;
    const uint32_t pb = group64_pattern(b, t.z, S), pp = pb ^ pxor;
    const double cb = t.c[pb], cp = t.c[pp];
    const double2 vb = psi[b], vp = psi[p];
    if (!unit_i) {  // psi'[a] = cos psi[a] - i sin psi[a ^ x]
      psi[b] = rot64_mix_unit1(cb, -t.s[pb], vb, vp);
      psi[p] = rot64_mix_unit1(cp, -t.s[pp], vp, vb);
    } else {  // psi'[a] = cos psi[a] + sin psi[a ^ x]
      psi[b] = rot64_mix_uniti(cb, t.s[pb], vb, vp);
      psi[p] = rot64_mix_uniti(cp, t.s[pp], vp, vb);
    }
  }
}

// One group of the reverse sweep (qsfh_sv64_adjoint's loop body): the
// block's part of contrib_g = Im <lam| M_g |psi> at the post-gate state into
// partials[blockIdx.x], then psi and lam inverse-rotated in the same pair
// loop.  The unit-1 and unit-i branches keep the host engine's signs.
__global__ void __launch_bounds__(kRot64Threads)
adjoint64_group_kernel(double2* __restrict__ psi, double2* __restrict__ lam, int n, int g,
                       const int32_t* __restrict__ gx, const int32_t* __restrict__ goff,
                       const int32_t* __restrict__ gflip, const int32_t* __restrict__ gpidx,
                       const int32_t* __restrict__ zsub, const double* __restrict__ wsub,
                       const double* __restrict__ theta_ext, double* __restrict__ partials) {
  __shared__ Group64Tables t;
  const int S = group64_tables(t, g, goff, zsub, wsub, gpidx, theta_ext);
  const uint32_t x = static_cast<uint32_t>(gx[g]);
  const uint32_t stride = gridDim.x * blockDim.x;
  const uint32_t first = blockIdx.x * blockDim.x + threadIdx.x;
  double acc = 0.0;
  if (x == 0) {  // M diagonal: contrib = sum r(b) Im(conj(lam) psi); *= exp(+i theta r)
    for (uint32_t b = first; b < (1u << n); b += stride) {
      const uint32_t pb = group64_pattern(b, t.z, S);
      const double r = t.r[pb], c = t.c[pb], s = t.s[pb];
      const double2 a = psi[b], l = lam[b];
      acc += r * (l.x * a.y - l.y * a.x);
      psi[b] = rot64_mix_unit1(c, s, a, a);
      lam[b] = rot64_mix_unit1(c, s, l, l);
    }
  } else {
    const int hbit = 31 - __clz(x);
    const bool unit_i = gflip[g] != 0;
    const uint32_t pxor = unit_i ? (1u << S) - 1u : 0u;
    for (uint32_t i = first; i < (1u << (n - 1)); i += stride) {
      const uint32_t b = insert_zero_bit(i, hbit);
      const uint32_t p = b ^ x;
      const uint32_t pb = group64_pattern(b, t.z, S), pp = pb ^ pxor;
      const double rb = t.r[pb], rp = t.r[pp];
      const double cb = t.c[pb], sb = t.s[pb], cp = t.c[pp], sp = t.s[pp];
      const double2 vb = psi[b], vp = psi[p], lb = lam[b], lp = lam[p];
      if (!unit_i) {
        // Im(conj(L) r psi[a ^ x]); inverse: psi'[a] = cos psi[a] + i sin psi[a ^ x]
        acc += rb * (lb.x * vp.y - lb.y * vp.x);
        acc += rp * (lp.x * vb.y - lp.y * vb.x);
        psi[b] = rot64_mix_unit1(cb, sb, vb, vp);
        psi[p] = rot64_mix_unit1(cp, sp, vp, vb);
        lam[b] = rot64_mix_unit1(cb, sb, lb, lp);
        lam[p] = rot64_mix_unit1(cp, sp, lp, lb);
      } else {
        // Im(conj(L) i r psi[a ^ x]) = r Re(conj(L) psi[a ^ x]); inverse:
        // psi'[a] = cos psi[a] - sin psi[a ^ x]
        acc += rb * (lb.x * vp.x + lb.y * vp.y);
        acc += rp * (lp.x * vb.x + lp.y * vb.y);
        psi[b] = rot64_mix_uniti(cb, -sb, vb, vp);
        psi[p] = rot64_mix_uniti(cp, -sp, vp, vb);
        lam[b] = rot64_mix_uniti(cb, -sb, lb, lp);
        lam[p] = rot64_mix_uniti(cp, -sp, lp, lb);
      }
    }
  }
  const double sum = block_sum_f64(make_double2(acc, 0.0)).x;
  if (threadIdx.x == 0) partials[blockIdx.x] = sum;
}

// grad[j] = sum over parameter j's groups (ascending) of the group's block
// partials, each summed in a fixed order: one block per parameter.
__global__ void __launch_bounds__(kRot64Threads)
adjoint64_fold_kernel(const double* __restrict__ partials, int n_blocks,
                      const int32_t* __restrict__ param_off,
                      const int32_t* __restrict__ param_groups, double* __restrict__ grad) {
  const int j = blockIdx.x;
  double acc = 0.0;  // valid in thread 0
  for (int q = param_off[j]; q < param_off[j + 1]; ++q) {
    const double* row = partials + static_cast<size_t>(param_groups[q]) * n_blocks;
    double v = 0.0;
    for (int i = threadIdx.x; i < n_blocks; i += blockDim.x) v += row[i];
    v = block_sum_f64(make_double2(v, 0.0)).x;
    if (threadIdx.x == 0) acc += v;
    __syncthreads();  // block_sum_f64's shared words are rewritten next round
  }
  if (threadIdx.x == 0) grad[j] = acc;
}

// ---------------------------------------------------------------------------
// rot64_resident / adjoint64_resident: a float64 group program's forward
// pass or reverse sweep in ONE cooperative launch over tile runs.
//
// They take the place of rot64_groups / adjoint64_groups (the host engine's
// qsfh_sv64_apply and qsfh_sv64_adjoint, qsfh_tpu/native/statevec64.cpp:153
// and :203) wherever the host layout allows (native.statevec.Rot64Program
// .route == "resident"; streaming.Group64Runs).  The groups, in order, are
// cut into runs whose flip masks lie inside one tile of k flat bits (the low
// c and the run's flip bits above them): 2^k complex128 amplitudes, 32 KiB at
// k = 11, in shared memory.  The grid is persistent (a cooperative launch;
// G from the occupancy at the real shared memory, capped at the tiles of a
// run): in run r block b takes tiles o = b, b + G, ...; it copies the tile
// in with cp.async.cg (through L2: after a barrier a tile may hold lines
// another SM wrote, and L1 is not coherent across SMs), applies the run's
// groups in order with a block barrier between groups (a thread per pair
// (i, i ^ x) of the tile, as rot64_group_kernel has a thread per pair of the
// state), and stores the tile back.  An 18-qubit state (4 MiB, psi and lam
// 8 MiB) stays in the 50 MB L2 throughout, so a group costs a shared-memory
// pass in place of a launch and an L2 pass.
//
// The run loop is pipelined as the float32 resident kernels' is: only the
// state's round trip lies between two runs.  What a run needs besides the
// state is made ready a run ahead, in the one of two stage buffers in
// shared memory (Res64Run) that the current run does not use: at the start
// of a run, after its first tile's copy is issued, the block reads the
// next run's bounds and copies its group records and table slices in with
// cp.async while this run's tile arrives and its groups run; after storing
// its last tile the block arrives at the split-phase grid barrier
// (SplitBarrier), forms its first tile of the next run (outer bits, copy
// map, each group's outer pattern) from that buffer, and only then waits.
// A block's further tiles of a run form their patterns while their copy is
// in flight.  A span of one run has nothing to prefetch.
//
// Tables.  A group's phase masks z_k span a GF(2) space of rank R <= S (R
// = 4 for the 8-term groups of a double excitation): with a basis zb_j of
// them, parity(b & z_k) = parity(q(b) & coef_k) where bit j of q(b) is
// parity(b & zb_j).  So the group's tables of r, cos(theta r) and sin(theta
// r) need 2^R entries where group64_tables fills 2^S: entry q holds r =
// sum_k w_k (1 - 2 parity(q & coef_k)), summed in term order, which is
// group64_tables' r for the same pattern, bit for bit.  The launch fills one
// table array for the whole program before its first barrier (an entry a
// thread over the grid, the angle read from theta_ext on the device), and a
// block copies a run's slice (contiguous, the groups being in order) and the
// run's group records (flip mask and basis in tile coordinates, partner
// map, table base; built by the host) into a stage buffer a run ahead, so a
// group's pass reads only shared memory.  The outer bits' pattern of each
// group is formed once a tile.  Each entry's sincos is
// computed once a call, where computing the tables in the block would
// repeat them for every block and run; no launch besides.  The partner's
// index is q ^ pxor (bit j of pxor = parity(x & zb_j): all ones where the
// unit is i, the complement of group64_pattern).  q(b) for b = outer |
// deposit(i, mask) is parity(outer & zb_j) (once a group and tile) XOR
// parity(i & zbt_j), zbt_j being zb_j in tile coordinates.
//
// The pair updates are rot64_mix_*, as in the per-group kernels: the two
// routes give the same state bits.  The adjoint sums each group's
// contributions within a tile per warp (shuffles) and over the warps in
// order, one partial per (group, tile); after its last barrier the blocks
// fold each parameter's groups in ascending order, each group's tiles in
// tile order, a warp a parameter.  No float atomics: two calls give the same
// bits whatever G.
//
// Bound at 18 qubits (1931 groups): the float64 arithmetic (0.09 / 0.25 ms
// forward / adjoint at 34 TFLOP/s), not bytes (one L2 pass of the state per
// run).  In practice (PERF.md rows 14 and 16) a run's fixed cost (the grid
// barrier and the tile copies through L2) takes most of a pass over the 3x3
// checkpoint's 521 runs, and the pairs' shared-memory traffic (4 amplitudes
// and 2 table entries a pair, the adjoint twice that) the rest.
// ---------------------------------------------------------------------------
constexpr int kRes64MinBits = 6;          // streaming.RESIDENT64_MIN_BITS: a warp of pairs
constexpr int kRes64MaxBits = 12;         // streaming.RESIDENT64_MAX_BITS
constexpr int kRes64MaxThreads = 1024;    // the forward kernel's bound
constexpr int kRes64AdjMaxThreads = 512;  // the adjoint's (more registers a thread)
constexpr int kRes64MaxRank = kRot64MaxTerms;
constexpr int kRes64MaxRunGroups = 1024;
constexpr int kRes64Rec = 20;  // int32 words of a group record (streaming.Group64Runs.grec)

// The layout (streaming.Group64Runs) and the program's arrays, on the device.
struct Res64Layout {
  const int32_t* run_start;  // n_runs + 1 group offsets
  const int32_t* run_mask;   // a tile bit set per run
  const int32_t* grec;       // per group kRes64Rec words: xt, pxor, its table's
                             // base in the run's tables, rank, then the basis in
                             // tile coordinates (8) and flat (8), 0 past the rank
  const int32_t* toff;       // G + 1 table entry offsets (even)
  const int32_t* tgroup;     // per table entry: its group
  const int32_t* csub;       // per term: its coefficient mask over the basis
  const int32_t* goff;       // G + 1 term offsets
  const int32_t* gpidx;      // per group: its entry of theta_ext
  const double* wsub;        // per term: the real weight
  const double* theta_ext;
};

// Every entry of the program's tables: tc[e] = cos(theta r), ts[e] = sin(theta
// r), tr[e] = r (three arrays of n_entries doubles: a table read is then an
// 8-byte load, and a group's 2^R <= 16 entries of each sit in distinct banks).
__device__ void res64_fill_tables(const Res64Layout& L, int n_entries, double* __restrict__ tab) {
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n_entries; e += gridDim.x * blockDim.x) {
    const int g = L.tgroup[e];
    const uint32_t q = static_cast<uint32_t>(e - L.toff[g]);
    const int t0 = L.goff[g], S = L.goff[g + 1] - t0;
    double r = 0.0;  // in term order, as group64_tables
    for (int k = 0; k < S; ++k)
      r += (__popc(q & static_cast<uint32_t>(L.csub[t0 + k])) & 1) ? -L.wsub[t0 + k]
                                                                    : L.wsub[t0 + k];
    double sn, c;
    sincos(L.theta_ext[L.gpidx[g]] * r, &sn, &c);
    tab[e] = c;
    tab[n_entries + e] = sn;
    tab[2 * n_entries + e] = r;
  }
}

// Where this thread's slots of a tile live: slot i = tid + s T (T =
// blockDim.x, a power of two; s < 8) at flat index outer | deposit(i, mask)
// = base | the step[b] of the bits b of s (deposit is linear over disjoint
// bits), so a copy costs no deposit loop per slot.
struct Tile64Map {
  uint32_t base, step[3];
  int slots;
  __device__ __forceinline__ Tile64Map(int k, uint32_t outer, uint32_t mask) {
    const int tb = 31 - __clz(blockDim.x);
    base = outer | deposit(threadIdx.x, mask);
#pragma unroll
    for (int b = 0; b < 3; ++b) step[b] = tb + b < k ? deposit(1u << (tb + b), mask) : 0u;
    slots = 1 << (k - tb);
  }
  __device__ __forceinline__ uint32_t global(int s) const {
    return base | (s & 1 ? step[0] : 0u) | (s & 2 ? step[1] : 0u) | (s & 4 ? step[2] : 0u);
  }
};

// tile[i] <- g[outer | deposit(i, mask)], asynchronously
__device__ __forceinline__ void res64_load(double2* tile, const double2* __restrict__ g,
                                           const Tile64Map& map) {
  for (int s = 0; s < map.slots; ++s)
    cp_async16(tile + threadIdx.x + s * blockDim.x, g + map.global(s));
}

// each thread stores the slots it loads: no barrier before the next copy
__device__ __forceinline__ void res64_store(const double2* tile, double2* __restrict__ g,
                                            const Tile64Map& map) {
  for (int s = 0; s < map.slots; ++s) g[map.global(s)] = tile[threadIdx.x + s * blockDim.x];
}

// Each group's pattern of the tile's outer bits, q0 bit j = parity(outer &
// zb_j), into sq0 (a thread a group; the caller synchronizes).
__device__ __forceinline__ void res64_outer_patterns(const int32_t* srec, int n_groups,
                                                     uint32_t outer, uint32_t* sq0) {
  for (int m = threadIdx.x; m < n_groups; m += blockDim.x) {
    const int32_t* rec = srec + m * kRes64Rec;
    uint32_t q = 0u;
    for (int j = 0; j < rec[3]; ++j)
      q |= (__popc(outer & static_cast<uint32_t>(rec[12 + j])) & 1u) << j;
    sq0[m] = q;
  }
}

// A group's pattern for tile slot i: q0 XOR parity(i & zbt_j) << j, for the
// first RB basis masks (zeros past the rank).
template <int RB>
struct Res64Pattern {
  uint32_t zt[RB], q0;
  __device__ __forceinline__ Res64Pattern(const int32_t* rec, uint32_t q0_) : q0(q0_) {
#pragma unroll
    for (int j = 0; j < RB; ++j) zt[j] = static_cast<uint32_t>(rec[4 + j]);
  }
  __device__ __forceinline__ uint32_t operator()(uint32_t i) const {
    uint32_t q = q0;
#pragma unroll
    for (int j = 0; j < RB; ++j) q ^= (__popc(i & zt[j]) & 1u) << j;
    return q;
  }
};

// One group forward on the block's tile: psi <- exp(-i theta M) psi
// (a thread a pair; t the group's (cos, sin) table in shared memory).
template <int RB>
__device__ __forceinline__ void rot64_tile_group(double2* tile, int k, const int32_t* rec,
                                                 uint32_t q0, const double* tc,
                                                 const double* ts) {
  const Res64Pattern<RB> pat(rec, q0);
  const uint32_t xt = static_cast<uint32_t>(rec[0]), pxor = static_cast<uint32_t>(rec[1]);
  if (xt == 0u) {  // psi[b] *= exp(-i theta r(b))
    for (uint32_t i = threadIdx.x; i < (1u << k); i += blockDim.x) {
      const uint32_t q = pat(i);
      const double2 a = tile[i];
      tile[i] = rot64_mix_unit1(tc[q], -ts[q], a, a);
    }
    return;
  }
  const int hb = 31 - __clz(xt);
  const bool unit_i = pxor != 0u;  // all ones where the unit is i, else 0
#pragma unroll 4
  for (uint32_t j = threadIdx.x; j < (1u << (k - 1)); j += blockDim.x) {
    const uint32_t i = insert_zero_bit(j, hb), p = i ^ xt;
    const uint32_t qi = pat(i), qp = qi ^ pxor;
    const double2 vi = tile[i], vp = tile[p];
    if (!unit_i) {  // psi'[a] = cos psi[a] - i sin psi[a ^ x]
      tile[i] = rot64_mix_unit1(tc[qi], -ts[qi], vi, vp);
      tile[p] = rot64_mix_unit1(tc[qp], -ts[qp], vp, vi);
    } else {  // psi'[a] = cos psi[a] + sin psi[a ^ x]
      tile[i] = rot64_mix_uniti(tc[qi], ts[qi], vi, vp);
      tile[p] = rot64_mix_uniti(tc[qp], ts[qp], vp, vi);
    }
  }
}

// One group of the reverse sweep on the block's psi and lam tiles: returns
// the thread's share of Im <lam| M |psi>, then both inverse-rotated.
template <int RB>
__device__ __forceinline__ double adjoint64_tile_group(double2* pt, double2* lt, int k,
                                                       const int32_t* rec, uint32_t q0,
                                                       const double* tc, const double* ts,
                                                       const double* tr) {
  const Res64Pattern<RB> pat(rec, q0);
  const uint32_t xt = static_cast<uint32_t>(rec[0]), pxor = static_cast<uint32_t>(rec[1]);
  double acc = 0.0;
  if (xt == 0u) {  // contrib = sum r Im(conj(lam) psi); *= exp(+i theta r)
    for (uint32_t i = threadIdx.x; i < (1u << k); i += blockDim.x) {
      const uint32_t q = pat(i);
      const double c = tc[q], sn = ts[q];
      const double2 a = pt[i], l = lt[i];
      acc += tr[q] * (l.x * a.y - l.y * a.x);
      pt[i] = rot64_mix_unit1(c, sn, a, a);
      lt[i] = rot64_mix_unit1(c, sn, l, l);
    }
    return acc;
  }
  const int hb = 31 - __clz(xt);
  const bool unit_i = pxor != 0u;
#pragma unroll 2
  for (uint32_t j = threadIdx.x; j < (1u << (k - 1)); j += blockDim.x) {
    const uint32_t i = insert_zero_bit(j, hb), p = i ^ xt;
    const uint32_t qi = pat(i), qp = qi ^ pxor;
    const double ri = tr[qi], rp = tr[qp];
    const double2 ti = make_double2(tc[qi], ts[qi]), tp = make_double2(tc[qp], ts[qp]);
    const double2 vi = pt[i], vp = pt[p], li = lt[i], lp = lt[p];
    if (!unit_i) {
      // Im(conj(L) r psi[a ^ x]); inverse: psi'[a] = cos psi[a] + i sin psi[a ^ x]
      acc += ri * (li.x * vp.y - li.y * vp.x);
      acc += rp * (lp.x * vi.y - lp.y * vi.x);
      pt[i] = rot64_mix_unit1(ti.x, ti.y, vi, vp);
      pt[p] = rot64_mix_unit1(tp.x, tp.y, vp, vi);
      lt[i] = rot64_mix_unit1(ti.x, ti.y, li, lp);
      lt[p] = rot64_mix_unit1(tp.x, tp.y, lp, li);
    } else {
      // r Re(conj(L) psi[a ^ x]); inverse: psi'[a] = cos psi[a] - sin psi[a ^ x]
      acc += ri * (li.x * vp.x + li.y * vp.y);
      acc += rp * (lp.x * vi.x + lp.y * vi.y);
      pt[i] = rot64_mix_uniti(ti.x, -ti.y, vi, vp);
      pt[p] = rot64_mix_uniti(tp.x, -tp.y, vp, vi);
      lt[i] = rot64_mix_uniti(ti.x, -ti.y, li, lp);
      lt[p] = rot64_mix_uniti(tp.x, -tp.y, lp, li);
    }
  }
  return acc;
}

// One of a float64 resident block's two stage buffers: the run's header
// (kRes64Header words: its first group, its groups, its tile mask; the
// fourth pads the records to 16 bytes), its group records, then its table
// planes (cos, sin; r for the adjoint) at stride most_entries.  Pointer
// arithmetic from the buffer's base alone, so the compiler keeps them in
// shared memory.
constexpr int kRes64Header = 4;  // int32 words

__host__ __device__ constexpr size_t res64_buffer_bytes(int planes, int most_entries,
                                                        int most_groups) {
  return sizeof(int32_t) * (kRes64Header + static_cast<size_t>(most_groups) * kRes64Rec) +
         sizeof(double) * planes * static_cast<size_t>(most_entries);
}

struct Res64Run {
  int32_t* hdr;
  __device__ __forceinline__ explicit Res64Run(unsigned char* base)
      : hdr(reinterpret_cast<int32_t*>(base)) {}
  __device__ __forceinline__ int g0() const { return hdr[0]; }
  __device__ __forceinline__ int n_groups() const { return hdr[1]; }
  __device__ __forceinline__ uint32_t mask() const { return static_cast<uint32_t>(hdr[2]); }
  __device__ __forceinline__ int32_t* srec() const { return hdr + kRes64Header; }
  __device__ __forceinline__ double* stab(int most_groups) const {
    return reinterpret_cast<double*>(srec() + most_groups * kRes64Rec);
  }
};

// Shared memory of a launch (streaming.resident64_smem): the tile(s), two
// stage buffers for the largest run, the outer patterns of the block's
// tile and the adjoint's per-warp sums.  Every piece a multiple of 16 bytes.
struct Res64Smem {
  size_t stage, stride, sq0, wsum, total;
  __host__ __device__ Res64Smem(bool adjoint, int k, int threads, int most_entries,
                                int most_groups) {
    stage = (adjoint ? 2 : 1) * (sizeof(double2) << k);
    stride = res64_buffer_bytes(adjoint ? 3 : 2, most_entries, most_groups);
    sq0 = stage + 2 * stride;
    wsum = sq0 + ((static_cast<size_t>(most_groups) * sizeof(uint32_t) + 15) & ~size_t(15));
    total = wsum + (adjoint ? static_cast<size_t>(threads / 32) * most_groups * sizeof(double) : 0);
  }
  // the buffer of the i-th run the block walks
  __device__ __forceinline__ Res64Run run(unsigned char* smem, int i) const {
    return Res64Run(smem + stage + (i & 1) * stride);
  }
};

// Run r's header (thread 0), group records and table slices (every thread,
// by cp.async through L2: the caller commits and waits) into buffer b:
// `planes` of the cos, sin and r planes (2 forward, 3 adjoint).  The table
// array is filled before the launch's first barrier and not written after
// it.  Every thread reads the bounds (the same words: one transaction a
// warp).
__device__ __forceinline__ void res64_fetch(const Res64Run& b, const Res64Layout& L, int r,
                                            const double* __restrict__ tab, int n_entries,
                                            int planes, int most_entries, int most_groups) {
  const int g0 = __ldg(L.run_start + r), g1 = __ldg(L.run_start + r + 1);
  if (threadIdx.x == 0) {
    b.hdr[0] = g0;
    b.hdr[1] = g1 - g0;
    b.hdr[2] = __ldg(L.run_mask + r);
  }
  const int words = (g1 - g0) * kRes64Rec;  // a multiple of 4: 16-byte pieces
  for (int m = 4 * threadIdx.x; m < words; m += 4 * blockDim.x)
    cp_async16(b.srec() + m, L.grec + static_cast<size_t>(g0) * kRes64Rec + m);
  const int e0 = __ldg(L.toff + g0), E = __ldg(L.toff + g1) - e0;  // both even: 16-byte pieces
  double* stab = b.stab(most_groups);
  for (int m = 2 * threadIdx.x; m < planes * E; m += 2 * blockDim.x) {
    const int plane = m / E, e = m - plane * E;
    cp_async16(stab + plane * most_entries + e,
               tab + static_cast<size_t>(plane) * n_entries + e0 + e);
  }
}

__global__ void __launch_bounds__(kRes64MaxThreads)
rot64_resident_kernel(double2* __restrict__ psi, int n, int k, int n_runs, int n_entries,
                      int most_entries, int most_groups, Res64Layout L,
                      double* __restrict__ tables, unsigned int* barrier) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Res64Smem lay(false, k, blockDim.x, most_entries, most_groups);
  double2* tile = reinterpret_cast<double2*>(smem);
  uint32_t* sq0 = reinterpret_cast<uint32_t*>(smem + lay.sq0);
  const uint32_t n_tiles = 1u << (n - k), all = (1u << n) - 1u;
  SplitBarrier bar(barrier);
  res64_fill_tables(L, n_entries, tables);
  bar.arrive();
  bar.wait();
  const Res64Run first = lay.run(smem, 0);
  res64_fetch(first, L, 0, tables, n_entries, 2, most_entries, most_groups);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  // the block's first tile of the next run (here run 0): its outer bits, copy map and patterns
  uint32_t outer = deposit(blockIdx.x, all & ~first.mask());
  Tile64Map map(k, outer, first.mask());
  res64_outer_patterns(first.srec(), first.n_groups(), outer, sq0);
  __syncthreads();
  for (int r = 0; r < n_runs; ++r) {
    const Res64Run cur = lay.run(smem, r), nxt = lay.run(smem, r + 1);
    const int ng = cur.n_groups();
    const uint32_t mask = cur.mask();
    const int32_t* srec = cur.srec();
    const double* stab = cur.stab(most_groups);  // cos, sin planes
    for (uint32_t o = blockIdx.x;;) {
      res64_load(tile, psi, map);
      cp_async_commit();
      if (o != blockIdx.x) {
        res64_outer_patterns(srec, ng, outer, sq0);
        cp_async_wait_all();
      } else if (r + 1 < n_runs) {  // run r + 1's inputs, in flight while run r computes
        res64_fetch(nxt, L, r + 1, tables, n_entries, 2, most_entries, most_groups);
        cp_async_commit();
        cp_async_wait_prior();
      } else {
        cp_async_wait_all();
      }
      __syncthreads();
      for (int m = 0; m < ng; ++m) {
        const int32_t* rec = srec + m * kRes64Rec;
        const double *tc = stab + rec[2], *ts = tc + most_entries;
        const int rank = rec[3];
        if (rank <= 2) rot64_tile_group<2>(tile, k, rec, sq0[m], tc, ts);
        else if (rank <= 4) rot64_tile_group<4>(tile, k, rec, sq0[m], tc, ts);
        else rot64_tile_group<kRes64MaxRank>(tile, k, rec, sq0[m], tc, ts);
        __syncthreads();
      }
      res64_store(tile, psi, map);
      o += gridDim.x;
      if (o >= n_tiles) break;
      outer = deposit(o, all & ~mask);
      map = Tile64Map(k, outer, mask);
    }
    if (r + 1 < n_runs) {
      cp_async_wait_all();  // this thread's copies of run r + 1's inputs, before arrive's barrier
      bar.arrive();
      outer = deposit(blockIdx.x, all & ~nxt.mask());
      map = Tile64Map(k, outer, nxt.mask());
      res64_outer_patterns(nxt.srec(), nxt.n_groups(), outer, sq0);
      bar.wait();
    }
  }
}

__device__ __forceinline__ double warp_sum_double(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kRes64AdjMaxThreads)
adjoint64_resident_kernel(double2* __restrict__ psi, double2* __restrict__ lam, int n, int k,
                          int n_runs, int n_entries, int most_entries, int most_groups,
                          Res64Layout L, double* __restrict__ tables,
                          double* __restrict__ partials, int n_params,
                          const int32_t* __restrict__ param_off,
                          const int32_t* __restrict__ param_groups, double* __restrict__ grad,
                          unsigned int* barrier) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Res64Smem lay(true, k, blockDim.x, most_entries, most_groups);
  double2* pt = reinterpret_cast<double2*>(smem);
  double2* lt = pt + (1u << k);
  uint32_t* sq0 = reinterpret_cast<uint32_t*>(smem + lay.sq0);
  double* wsum = reinterpret_cast<double*>(smem + lay.wsum);  // [warp][group of the run]
  const uint32_t n_tiles = 1u << (n - k), all = (1u << n) - 1u;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  SplitBarrier bar(barrier);
  res64_fill_tables(L, n_entries, tables);
  bar.arrive();
  bar.wait();
  // the runs last first: the i-th the block walks is run n_runs - 1 - i
  const Res64Run first = lay.run(smem, 0);
  res64_fetch(first, L, n_runs - 1, tables, n_entries, 3, most_entries, most_groups);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  uint32_t outer = deposit(blockIdx.x, all & ~first.mask());
  Tile64Map map(k, outer, first.mask());
  res64_outer_patterns(first.srec(), first.n_groups(), outer, sq0);
  __syncthreads();
  for (int i = 0; i < n_runs; ++i) {
    const Res64Run cur = lay.run(smem, i), nxt = lay.run(smem, i + 1);
    const int g0 = cur.g0(), ng = cur.n_groups();
    const uint32_t mask = cur.mask();
    const int32_t* srec = cur.srec();
    const double* stab = cur.stab(most_groups);  // cos, sin, r planes
    for (uint32_t o = blockIdx.x;;) {
      res64_load(pt, psi, map);
      res64_load(lt, lam, map);
      cp_async_commit();
      if (o != blockIdx.x) {
        res64_outer_patterns(srec, ng, outer, sq0);
        cp_async_wait_all();
      } else if (i + 1 < n_runs) {  // the next run's inputs, in flight while this one computes
        res64_fetch(nxt, L, n_runs - 2 - i, tables, n_entries, 3, most_entries, most_groups);
        cp_async_commit();
        cp_async_wait_prior();
      } else {
        cp_async_wait_all();
      }
      __syncthreads();  // also: the previous tile's partials have read wsum
      for (int m = ng - 1; m >= 0; --m) {
        const int32_t* rec = srec + m * kRes64Rec;
        const double *tc = stab + rec[2], *ts = tc + most_entries, *tr = ts + most_entries;
        const int rank = rec[3];
        double acc;
        if (rank <= 2) acc = adjoint64_tile_group<2>(pt, lt, k, rec, sq0[m], tc, ts, tr);
        else if (rank <= 4) acc = adjoint64_tile_group<4>(pt, lt, k, rec, sq0[m], tc, ts, tr);
        else acc = adjoint64_tile_group<kRes64MaxRank>(pt, lt, k, rec, sq0[m], tc, ts, tr);
        acc = warp_sum_double(acc);
        if (lane == 0) wsum[warp * most_groups + m] = acc;
        __syncthreads();
      }
      for (int m = threadIdx.x; m < ng; m += blockDim.x) {  // the tile's partials
        double s = 0.0;
        for (int w = 0; w < n_warps; ++w) s += wsum[w * most_groups + m];
        partials[static_cast<size_t>(g0 + m) * n_tiles + o] = s;
      }
      res64_store(pt, psi, map);
      res64_store(lt, lam, map);
      o += gridDim.x;
      if (o >= n_tiles) break;
      outer = deposit(o, all & ~mask);
      map = Tile64Map(k, outer, mask);
    }
    cp_async_wait_all();  // this thread's copies of the next run's inputs, before arrive's barrier
    bar.arrive();         // the next run, or the partials before the fold below
    if (i + 1 < n_runs) {
      outer = deposit(blockIdx.x, all & ~nxt.mask());
      map = Tile64Map(k, outer, nxt.mask());
      res64_outer_patterns(nxt.srec(), nxt.n_groups(), outer, sq0);
    }
    bar.wait();
  }
  // grad[j] = its groups ascending, each group's tiles in order; a warp a
  // parameter; the rows were written by other SMs, so they are read via L2
  for (int j = blockIdx.x * n_warps + warp; j < n_params; j += gridDim.x * n_warps) {
    double acc = 0.0;
    for (int q = param_off[j]; q < param_off[j + 1]; ++q) {
      const double* row = partials + static_cast<size_t>(param_groups[q]) * n_tiles;
      double v = 0.0;
      for (uint32_t o = lane; o < n_tiles; o += 32) v += __ldcg(row + o);
      acc += warp_sum_double(v);
    }
    if (lane == 0) grad[j] = acc;
  }
}

inline const void* res64_kernel(bool adjoint) {
  return adjoint ? reinterpret_cast<const void*>(adjoint64_resident_kernel)
                 : reinterpret_cast<const void*>(rot64_resident_kernel);
}

inline cudaError_t res64_allow(bool adjoint, size_t smem) {
  return adjoint ? allow_smem(adjoint64_resident_kernel, smem)
                 : allow_smem(rot64_resident_kernel, smem);
}

// threads: a power of two from a warp to the kernel's bound, at most the
// tile's pairs and at least an eighth of its slots (Tile64Map)
inline bool res64_shape_ok(bool adjoint, int n, int k, int threads, int most_entries,
                           int most_groups) {
  const int most_threads = adjoint ? kRes64AdjMaxThreads : kRes64MaxThreads;
  return k >= kRes64MinBits && k <= kRes64MaxBits && k <= n && n <= 30 && threads >= 32 &&
         threads <= most_threads && (threads & (threads - 1)) == 0 && threads <= (1 << (k - 1)) &&
         (threads << 3) >= (1 << k) && most_entries >= 2 && most_entries % 2 == 0 &&
         most_groups >= 1 && most_groups <= kRes64MaxRunGroups;
}

// Blocks of a float64 resident kernel the device holds at once, or a
// negative CUDA error code.
inline int res64_capacity(bool adjoint, int k, int threads, int most_entries, int most_groups) {
  if (!res64_shape_ok(adjoint, k, k, threads, most_entries, most_groups))
    return -static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  const size_t smem = Res64Smem(adjoint, k, threads, most_entries, most_groups).total;
  if (err == cudaSuccess) err = res64_allow(adjoint, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, res64_kernel(adjoint), threads,
                                                        smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (per_sm < 1) return -static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  return per_sm * sm_count();
}

constexpr int kRes64Arrays = 10;  // the pointers of Res64Layout

inline Res64Layout res64_layout(const void* const* a) {
  Res64Layout L;
  const int32_t** ints[] = {&L.run_start, &L.run_mask, &L.grec, &L.toff,
                            &L.tgroup,    &L.csub,     &L.goff, &L.gpidx};
  for (int m = 0; m < kRes64Arrays - 2; ++m) *ints[m] = static_cast<const int32_t*>(a[m]);
  L.wsub = static_cast<const double*>(a[kRes64Arrays - 2]);
  L.theta_ext = static_cast<const double*>(a[kRes64Arrays - 1]);
  return L;
}

// out[b] = scale * sum_t c_t s_t(b) psi[b ^ x_t] (qsfh_sv64_happly), one
// thread an amplitude, no atomics; terms with the same flip mask in a row
// share one gather.  Each block's (Re <psi|H psi>, <psi|psi>) partial, taken
// before the scale, goes to partials[blockIdx.x].  The route of states
// under 9 qubits and of the terms of masks that fit no tile; happly64_tiles
// (below) takes H psi from 9 qubits on.
__global__ void __launch_bounds__(kF64Threads)
happly64_kernel(const double2* __restrict__ psi, double2* __restrict__ out, uint32_t dim,
                int n_terms, const int32_t* __restrict__ hx, const int32_t* __restrict__ hz,
                const double* __restrict__ cre, const double* __restrict__ cim, double scale,
                double2* __restrict__ partials) {
  double e = 0.0, norm = 0.0;
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t b = blockIdx.x * blockDim.x + threadIdx.x; b < dim; b += stride) {
    double hr = 0.0, hi = 0.0;
    uint32_t last = 0xffffffffu;  // no mask of a state of at most 30 qubits
    double2 v = make_double2(0.0, 0.0);
    for (int t = 0; t < n_terms; ++t) {
      const uint32_t x = static_cast<uint32_t>(hx[t]);
      if (x != last) {
        v = psi[b ^ x];
        last = x;
      }
      const bool neg = __popc(b & static_cast<uint32_t>(hz[t])) & 1;
      const double wr = neg ? -cre[t] : cre[t], wi = neg ? -cim[t] : cim[t];
      hr += wr * v.x - wi * v.y;
      hi += wr * v.y + wi * v.x;
    }
    const double2 a = psi[b];
    e += a.x * hr + a.y * hi;
    norm += a.x * a.x + a.y * a.y;
    out[b] = make_double2(scale * hr, scale * hi);
  }
  const double2 sum = block_sum_f64(make_double2(e, norm));
  if (threadIdx.x == 0) partials[blockIdx.x] = sum;
}

// ---------------------------------------------------------------------------
// The float64 tile kernels: expectation_f64_tiles (the Rayleigh readout of a
// complex64 state; the redesign of expectation_norm_f64_kernel) and
// happly64_tiles (H psi of a complex128 state with E and N; the redesign of
// happly64_kernel), over the tiles of streaming.GroupTiles, walked as
// pauli_inner_tiles_kernel and pauli_apply_tiles_kernel walk them in
// float32.
//
// No TPU Pallas counterpart (see expectation_norm_f64 and the float64 group
// engine above).  What bounds the per-amplitude kernels they replace: each
// thread walks all of H's terms, so each of its ~36 off-diagonal flip masks
// gathers psi[b ^ x] once more.  At 24 qubits the 128 MiB state is past the
// 50 MB L2 and each gather is close to a full HBM pass (~4.8 GB for 0.13 GB
// of compulsory bytes); at 18 qubits ~150 MB of L2 reads for 8 MiB of state.
// Here a block reads its tile of the state once and serves every item (the
// terms of one flip mask that agree off 4 bits) inside the tile's bits from
// shared memory; the x = 0 terms take one Walsh-Hadamard transform of the
// tile.  What bounds them then: the float64 arithmetic and the
// shared-memory reads of each item's pass over the tile.
//
// Float64 end to end: the coefficients are read as float64 by input term
// index (never through float32 planes); the readout forms every product of
// two float32 amplitudes exactly in float64 (a float32 product fits the
// 53-bit significand); every table, bucket, transform and sum is float64.
// No float atomics: each block writes one (E, N) partial, and the block
// whose arrival on an integer counter is the last sums the partials in
// block order and sets the counter back to 0, inside the launch (no second
// fold kernel; a captured launch replays; two calls give the same bits).
// ---------------------------------------------------------------------------

__device__ __forceinline__ double add64(double a, double b) { return a + b; }
__device__ __forceinline__ double2 add64(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ double sub64(double a, double b) { return a - b; }
__device__ __forceinline__ double2 sub64(double2 a, double2 b) {
  return make_double2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ double shfl64(double v, int m) {
  return __shfl_xor_sync(0xffffffffu, v, m);
}
__device__ __forceinline__ double2 shfl64(double2 v, int m) {
  return make_double2(__shfl_xor_sync(0xffffffffu, v.x, m), __shfl_xor_sync(0xffffffffu, v.y, m));
}
// acc + c p
__device__ __forceinline__ double2 fma64(double c, double2 p, double2 acc) {
  return make_double2(fma(c, p.x, acc.x), fma(c, p.y, acc.y));
}
__device__ __forceinline__ double2 fma64(double2 c, double2 p, double2 acc) {
  return make_double2(fma(c.x, p.x, fma(-c.y, p.y, acc.x)), fma(c.x, p.y, fma(c.y, p.x, acc.y)));
}
// one Walsh-Hadamard butterfly seen from one side (as butterfly above)
template <typename T>
__device__ __forceinline__ T bfly64(T v, T p, bool up) {
  return up ? sub64(p, v) : add64(v, p);
}
// v with its sign flipped where sbit (bit 31) is set
__device__ __forceinline__ double flip_sign64(double v, uint32_t sbit) {
  return __longlong_as_double(__double_as_longlong(v) ^
                              static_cast<long long>(static_cast<unsigned long long>(sbit) << 32));
}

// The end of a float64 tile launch: the block's (E, N) partial (valid in
// thread 0; every thread calls) goes to partials[b]; the block whose
// arrival on `count` is the last sums the n_blocks partials in index order
// (lane-strided, then a fixed shuffle tree) into out[4] = [E, 0, N, 0] and
// sets count back to 0.  The order of the sums does not depend on which
// block arrives last.
__device__ void fold64_last(double2 part, int b, int n_blocks, double2* __restrict__ partials,
                            unsigned int* __restrict__ count, double* __restrict__ out) {
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partials[b] = part;
    __threadfence();
    last = atomicAdd(count, 1u) == static_cast<unsigned int>(n_blocks) - 1u;
  }
  __syncthreads();
  if (!last || threadIdx.x >= 32) return;
  __threadfence();
  double2 acc = make_double2(0.0, 0.0);
  for (int j = static_cast<int>(threadIdx.x); j < n_blocks; j += 32) {
    const double2 v = __ldcg(partials + j);
    acc.x += v.x;
    acc.y += v.y;
  }
  acc = warp_sum_f64(acc);
  if (threadIdx.x == 0) {
    out[0] = acc.x;
    out[1] = 0.0;
    out[2] = acc.y;
    out[3] = 0.0;
    *count = 0u;
  }
}

// The readout's diagonal unit (the list's x = 0 terms, and N) over the tile
// positions [p0, p1) of the tile `mask`: per position the R = 2^(k - 8)
// slots t = tid | r << 8 of |psi|^2 in float64, their Walsh-Hadamard
// transform over the tile U[m] = sum_t (-1)^popc(t & m) |psi[t]|^2 (the r
// bits in registers, the 5 lane bits by shuffles, the 3 warp bits through
// shared memory, as inner_diagonal), then term q adds (-1)^popc(outer &
// zout[q]) U[zin[q]] to its sum (thread q mod 256 owns term q) and thread
// 0 adds U[0], the position's sum of |psi|^2, to nn.  Ends with this
// thread's share of E: its terms' sums times their real coefficients
// (cre[rows[q]]), in term order.
template <int R>
__device__ __forceinline__ void readout64_diagonal(unsigned char* smem,
                                                   const float2* __restrict__ psi, int n, int c,
                                                   uint32_t mask, uint32_t p0, uint32_t p1,
                                                   const int32_t* __restrict__ zin,
                                                   const int32_t* __restrict__ zout, int n_diag,
                                                   const int32_t* __restrict__ rows,
                                                   const double* __restrict__ cre, double& e,
                                                   double& nn) {
  constexpr int kLogR = R == 2 ? 1 : R == 4 ? 2 : R == 8 ? 3 : 4;
  double* U = reinterpret_cast<double*>(smem);
  double* dsum = U + (R << 8);
  const uint32_t tid = threadIdx.x;
  for (int q = static_cast<int>(tid); q < n_diag; q += kInnerTileThreads) dsum[q] = 0.0;
  // slot t at flat index outer | deposit(t >> c, hi) | (t & low), linear in t
  const uint32_t low = (1u << c) - 1u, hi = mask & ~low;
  const uint32_t rest = ((1u << n) - 1u) & ~mask;
  const uint32_t gt = deposit(tid >> c, hi) | (tid & low);
  uint32_t gb[kLogR];
#pragma unroll
  for (int b = 0; b < kLogR; ++b) {
    const uint32_t t = 1u << (8 + b);
    gb[b] = deposit(t >> c, hi) | (t & low);
  }
  for (uint32_t p = p0; p < p1; ++p) {
    const uint32_t outer = deposit(p, rest);
    double v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      uint32_t g = outer | gt;
#pragma unroll
      for (int b = 0; b < kLogR; ++b)
        if ((r >> b) & 1) g |= gb[b];
      const float2 a = psi[g];
      const double ax = a.x, ay = a.y;
      v[r] = fma(ax, ax, ay * ay);
    }
#pragma unroll
    for (int b = 0; b < kLogR; ++b) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!((r >> b) & 1)) {
          const double lo = v[r], up = v[r | (1 << b)];
          v[r] = lo + up;
          v[r | (1 << b)] = lo - up;
        }
      }
    }
#pragma unroll
    for (int b = 0; b < 5; ++b) {
      const bool up = (tid >> b) & 1u;
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = bfly64(v[r], shfl64(v[r], 1 << b), up);
    }
#pragma unroll
    for (int b = 5; b < 8; ++b) {
      __syncthreads();  // every read of U (the last stage, position or terms) is done
#pragma unroll
      for (int r = 0; r < R; ++r) U[tid | (r << 8)] = v[r];
      __syncthreads();
      const bool up = (tid >> b) & 1u;
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = bfly64(v[r], U[(tid ^ (1u << b)) | (r << 8)], up);
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) U[tid | (r << 8)] = v[r];
    __syncthreads();
    for (int q = static_cast<int>(tid); q < n_diag; q += kInnerTileThreads) {
      const uint32_t sbit = (__popc(outer & static_cast<uint32_t>(__ldg(zout + q))) & 1u) << 31;
      dsum[q] += flip_sign64(U[__ldg(zin + q)], sbit);
    }
    if (tid == 0) nn += U[0];
  }
  for (int q = static_cast<int>(tid); q < n_diag; q += kInnerTileThreads)
    e = fma(__ldg(cre + __ldg(rows + q)), dsum[q], e);
}

// The readout's items [i0, i0 + n_items) of one tile over the tile
// positions [p0, p1), the float32 tile in shared memory at the swizzled
// slots of pauli_inner_tiles_kernel.  With a = psi the buckets pair up: slot
// j ^ XJ of the 16 (XJ = item_x, x on the bucket bits) is the partner of
// slot j with the same sign s (the bucket bits carry no common phase bit),
// so B[j ^ XJ] = conj(B[j]) exactly (the products are exact and the
// rounding of the sums symmetric) and a lane keeps only the 8 buckets j
// with bit 0 clear: B[j] += s conj(psi[i_j]) psi[i_j ^ x], two loads and
// two float64 products a pair.  E of an item is then sum_j Re(C[j] B[j])
// with C[j] = sum_t c_t (-1)^popc(j & d_t) its 16-point coefficient table,
// which the block forms in float64 before the first position and keeps
// folded by pair: (Cre[j] + Cre[j ^ XJ], Cim[j ^ XJ] - Cim[j]) against
// (Re B[j], Im B[j]).  Each lane adds its share to e in a fixed order
// (positions, then the warp's items).  The unit's terms are staged into
// shared memory (coefficient, phase bits on J) in one pass of independent
// loads before the tables are formed from them.
__device__ __forceinline__ void readout64_items(
    unsigned char* smem, const float2* __restrict__ psi, int n, int k, int c, uint64_t swizzle,
    uint32_t mask, int i0, int n_items, int most_items, uint32_t p0, uint32_t p1,
    const int32_t* __restrict__ item_cols, const int32_t* __restrict__ item_x,
    const int32_t* __restrict__ item_zlc, const int32_t* __restrict__ item_zout,
    const int32_t* __restrict__ item_start, const int32_t* __restrict__ term_d,
    const int32_t* __restrict__ order, const double* __restrict__ cre,
    const double* __restrict__ cim, double& e) {
  float2* at = reinterpret_cast<float2*>(smem);
  double2* ctab = reinterpret_cast<double2*>(smem + (sizeof(float2) << k));  // [item][8]
  double2* scoef = ctab + 8 * most_items;
  const int tid = threadIdx.x, warp = tid >> 5;
  const uint32_t lane = static_cast<uint32_t>(tid & 31);
  const int tb = __ldg(item_start + i0), n_terms = __ldg(item_start + i0 + n_items) - tb;
  int32_t* sbits = reinterpret_cast<int32_t*>(scoef + n_terms);
  for (int q = tid; q < n_terms; q += kInnerTileThreads) {  // the unit's terms, staged
    const int o = __ldg(order + tb + q);
    sbits[q] = __ldg(term_d + tb + q);
    scoef[q] = make_double2(__ldg(cre + o), __ldg(cim + o));
  }
  __syncthreads();
  for (int q = tid; q < 8 * n_items; q += kInnerTileThreads) {
    const int item = i0 + (q >> 3);
    const uint32_t j = 2u * static_cast<uint32_t>(q & 7);
    const uint32_t jp = j ^ static_cast<uint32_t>(__ldg(item_x + item));
    double cr = 0.0, ci = 0.0, pr = 0.0, pi = 0.0;
    for (int t = __ldg(item_start + item) - tb; t < __ldg(item_start + item + 1) - tb; ++t) {
      const uint32_t d = static_cast<uint32_t>(sbits[t]);
      const double re = scoef[t].x, im = scoef[t].y;
      const uint32_t s = (__popc(j & d) & 1u) << 31, sp = (__popc(jp & d) & 1u) << 31;
      cr += flip_sign64(re, s);
      ci += flip_sign64(im, s);
      pr += flip_sign64(re, sp);
      pi += flip_sign64(im, sp);
    }
    ctab[q] = make_double2(cr + pr, pi - ci);
  }
  // this thread copies the tile slots tid | m << 8 (pauli_inner_tiles_kernel)
  const uint32_t low = (1u << c) - 1u;
  const uint32_t hi = mask & ~low;
  const uint32_t rest = ((1u << n) - 1u) & ~mask;
  const uint32_t t0 = static_cast<uint32_t>(tid);
  const uint32_t g0 = deposit(t0 >> c, hi) | (t0 & low), s0 = inner_slot(t0, swizzle);
  uint32_t gb[5], sb[5];
#pragma unroll
  for (int b = 0; b < 5; ++b) {
    const uint32_t t = 1u << (8 + b);
    gb[b] = deposit(t >> c, hi) | (t & low);
    sb[b] = inner_slot(t, swizzle);
  }
  const int copies = 1 << (k - 8);
  const int chunks = 1 << (k - 9);
  for (uint32_t p = p0; p < p1; ++p) {
    const uint32_t outer = deposit(p, rest);
#pragma unroll
    for (int m = 0; m < (1 << (kInnerTileMaxBits - 8)); ++m) {
      if (m < copies) {
        uint32_t g = outer | g0, sl = s0;
#pragma unroll
        for (int b = 0; b < 5; ++b) {
          if ((m >> b) & 1) {
            g ^= gb[b];
            sl ^= sb[b];
          }
        }
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                         static_cast<uint32_t>(__cvta_generic_to_shared(at + sl))),
                     "l"(psi + g));
      }
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();  // the tile (and, at the first position, the tables) complete
    for (int it = warp; it < n_items; it += kInnerTileWarps) {
      const int item = i0 + it;
      const int4* row = reinterpret_cast<const int4*>(item_cols + kItemCols * item);
      const int4 q0 = __ldg(row), q1 = __ldg(row + 1), q2 = __ldg(row + 2), q3 = __ldg(row + 3);
      // columns: lane bits 0-4, bucket bits 5-8, chunk bits 9-12
      const uint32_t lc[5] = {static_cast<uint32_t>(q0.x), static_cast<uint32_t>(q0.y),
                              static_cast<uint32_t>(q0.z), static_cast<uint32_t>(q0.w),
                              static_cast<uint32_t>(q1.x)};
      const uint32_t jc[4] = {static_cast<uint32_t>(q1.y), static_cast<uint32_t>(q1.z),
                              static_cast<uint32_t>(q1.w), static_cast<uint32_t>(q2.x)};
      const uint32_t cc[4] = {static_cast<uint32_t>(q2.y), static_cast<uint32_t>(q2.z),
                              static_cast<uint32_t>(q2.w), static_cast<uint32_t>(q3.x)};
      uint32_t lane_off = 0u;
#pragma unroll
      for (int b = 0; b < 5; ++b)
        if ((lane >> b) & 1u) lane_off ^= lc[b];
      // the slot offsets of the buckets j = 2m, and of the partner (x on J)
      uint32_t jo[8];
      jo[0] = 0u;
#pragma unroll
      for (int m = 1; m < 8; ++m) jo[m] = jo[m & (m - 1)] ^ jc[m & 1 ? 1 : m & 2 ? 2 : 3];
      const uint32_t xj = static_cast<uint32_t>(__ldg(item_x + item));
      uint32_t xo = 0u;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if ((xj >> b) & 1u) xo ^= jc[b];
      const uint32_t zlc = static_cast<uint32_t>(__ldg(item_zlc + item));
      const uint32_t sign0 = __popc(outer & static_cast<uint32_t>(__ldg(item_zout + item))) & 1u;
      double2 B[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) B[m] = make_double2(0.0, 0.0);
      for (int ch = 0; ch < chunks; ++ch) {
        const uint32_t base = lane_off ^ (ch & 1 ? cc[0] : 0u) ^ (ch & 2 ? cc[1] : 0u) ^
                              (ch & 4 ? cc[2] : 0u) ^ (ch & 8 ? cc[3] : 0u);
        const uint32_t l9 = lane | (static_cast<uint32_t>(ch) << 5);
        const uint32_t sbit = ((__popc(l9 & zlc) ^ sign0) & 1u) << 31;
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const float2 u = at[base ^ jo[m]], w = at[base ^ jo[m] ^ xo];
          const double ux = u.x, uy = u.y, wx = w.x, wy = w.y;
          B[m].x += flip_sign64(fma(ux, wx, uy * wy), sbit);   // Re conj(u) w, exact products
          B[m].y += flip_sign64(fma(ux, wy, -(uy * wx)), sbit);  // Im conj(u) w
        }
      }
      const double2* ct = ctab + 8 * it;
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        e = fma(ct[m].x, B[m].x, e);
        e = fma(ct[m].y, B[m].y, e);
      }
    }
    __syncthreads();  // the tile is read: the next position may overwrite it
  }
}

// tiles the readout takes: 9 <= k <= 12 (its diagonal holds 2^(k - 8)
// doubles a thread; 32 at 13 bits would not fit 128 registers)
constexpr int kReadout64MaxBits = 12;

// [E, 0, N, 0] of a complex64 state over the units of a GroupTiles
// schedule with its diagonal unit always present (grid: units x position
// slices, `positions` tile positions a block): E = sum_t Re(c_t <psi|P_t|psi>)
// over the layout's terms (items and the list's diagonal), N = <psi|psi>
// from the diagonal unit (on the tile diag_mask).  partials: one double2 a
// block; count: zero before and after.
__global__ void __launch_bounds__(kInnerTileThreads, 2)
expectation_f64_tiles_kernel(const float2* __restrict__ psi, int n, int k, int c,
                             uint64_t swizzle, const int32_t* __restrict__ tile_mask,
                             const int4* __restrict__ units, const int32_t* __restrict__ item_cols,
                             const int32_t* __restrict__ item_x,
                             const int32_t* __restrict__ item_zlc,
                             const int32_t* __restrict__ item_zout,
                             const int32_t* __restrict__ item_start,
                             const int32_t* __restrict__ term_d, const int32_t* __restrict__ order,
                             const int32_t* __restrict__ diag_zin,
                             const int32_t* __restrict__ diag_zout, int n_diag, int diag_row,
                             uint32_t diag_mask, int most_items, int positions,
                             const double* __restrict__ cre,
                             const double* __restrict__ cim, double2* __restrict__ partials,
                             double* __restrict__ out, unsigned int* __restrict__ count) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int4 unit = units[blockIdx.x];  // (tile, first item, items, diagonal)
  const uint32_t p0 = blockIdx.y * static_cast<uint32_t>(positions);
  const uint32_t p1 = min(p0 + static_cast<uint32_t>(positions), 1u << (n - k));
  double e = 0.0, nn = 0.0;
  if (unit.w) {
    const int32_t* rows = order + diag_row;
#define QSFH_READOUT_DIAG(R)                                                                   \
  readout64_diagonal<R>(smem, psi, n, c, diag_mask, p0, p1, diag_zin, diag_zout, n_diag, rows, \
                        cre, e, nn)
    switch (k) {
      case 9: QSFH_READOUT_DIAG(2); break;
      case 10: QSFH_READOUT_DIAG(4); break;
      case 11: QSFH_READOUT_DIAG(8); break;
      default: QSFH_READOUT_DIAG(16); break;  // k = 12
    }
#undef QSFH_READOUT_DIAG
  } else {
    readout64_items(smem, psi, n, k, c, swizzle, static_cast<uint32_t>(tile_mask[unit.x]), unit.y,
                    unit.z, most_items, p0, p1, item_cols, item_x, item_zlc, item_zout,
                    item_start, term_d, order, cre, cim, e);
  }
  const double2 part = block_sum_f64(make_double2(e, nn));
  fold64_last(part, static_cast<int>(blockIdx.x * gridDim.y + blockIdx.y),
              static_cast<int>(gridDim.x * gridDim.y), partials, count, out);
}

// happly64_tiles: a thread owns the 8 slots of a tile that differ in its top
// kApply64TopBits bits (pauli_apply_tiles_kernel owns 16 in float32; 8
// complex128 accumulators and coefficients keep a thread within the 128
// registers of a 512-thread block).  item_ehi is built for the float32
// kernel's 4 top bits: its entries 1-3 are these 3 bits.
constexpr int kApply64TopBits = 3;
constexpr int kApply64Slots = 1 << kApply64TopBits;
constexpr int kApply64MinBits = 9;   // kernels.INNER_TILE_MIN_BITS: two warps at least
constexpr int kApply64MaxBits = 12;  // the psi tile and the spectrum, 64 KiB each
constexpr int kApply64MaxThreads = 1 << (kApply64MaxBits - kApply64TopBits);

// The byte offsets of this thread's 8 table entries of one item
// (apply_item_offsets with the top 3 tile bits).
__device__ __forceinline__ void apply64_item_offsets(uint32_t (&E)[kApply64Slots],
                                                     uint32_t table, uint32_t entry, uint32_t tid,
                                                     uint32_t outer, uint32_t jt, uint32_t zt,
                                                     uint32_t ehi, uint32_t zo) {
  uint32_t jb = 0u;
#pragma unroll
  for (int m = 0; m < 4; ++m) jb |= ((tid >> ((jt >> (4 * m)) & 15u)) & 1u) << m;
  const uint32_t s = (__popc(tid & zt) ^ __popc(outer & zo)) & 1u;
  uint32_t eb[kApply64TopBits];
#pragma unroll
  for (int b = 0; b < kApply64TopBits; ++b)
    eb[b] = ((ehi >> (5 * (b + kApplyTopBits - kApply64TopBits))) & 31u) * entry;
  E[0] = table + (jb | s << 4) * entry;
#pragma unroll
  for (int r = 1; r < kApply64Slots; ++r) E[r] = E[r & (r - 1)] ^ eb[r & 1 ? 0 : r & 2 ? 1 : 2];
}

__device__ __forceinline__ void load_coef64(double& v, const double2& s) { v = s.x; }
__device__ __forceinline__ void load_coef64(double2& v, const double2& s) { v = s; }

// The tile's diagonal on this thread's 8 slots into acc (apply_diagonal in
// float64): the Walsh-Hadamard transform of the spectrum at spec_off (its
// real parts with T = double) over the top 3 tile bits in registers, the 5
// lane bits by shuffles and the warp bits through the same shared memory;
// then acc += d psi.
template <typename T>
__device__ __forceinline__ void apply64_diagonal(unsigned char* smem, uint32_t spec_off,
                                                 uint32_t tid, int hb,
                                                 const uint32_t (&sa)[kApply64Slots],
                                                 double2 (&acc)[kApply64Slots]) {
  const double2* spec2 = reinterpret_cast<const double2*>(smem + spec_off);
  T* spec = reinterpret_cast<T*>(smem + spec_off);
  T v[kApply64Slots];
#pragma unroll
  for (int r = 0; r < kApply64Slots; ++r)
    load_coef64(v[r], spec2[tid + (static_cast<uint32_t>(r) << hb)]);
#pragma unroll
  for (int b = 0; b < kApply64TopBits; ++b) {
#pragma unroll
    for (int r = 0; r < kApply64Slots; ++r) {
      if (!((r >> b) & 1)) {
        const T a = v[r], c = v[r | (1 << b)];
        v[r] = add64(a, c);
        v[r | (1 << b)] = sub64(a, c);
      }
    }
  }
#pragma unroll
  for (int b = 0; b < 5; ++b) {
    const bool up = (tid >> b) & 1u;
#pragma unroll
    for (int r = 0; r < kApply64Slots; ++r) v[r] = bfly64(v[r], shfl64(v[r], 1 << b), up);
  }
  for (int b = 5; b < hb; ++b) {
    __syncthreads();  // every read of the previous stage (or of the spectrum) is done
#pragma unroll
    for (int r = 0; r < kApply64Slots; ++r) spec[tid + (static_cast<uint32_t>(r) << hb)] = v[r];
    __syncthreads();
    const bool up = (tid >> b) & 1u;
#pragma unroll
    for (int r = 0; r < kApply64Slots; ++r)
      v[r] = bfly64(v[r], spec[(tid ^ (1u << b)) + (static_cast<uint32_t>(r) << hb)], up);
  }
#pragma unroll
  for (int r = 0; r < kApply64Slots; ++r)
    acc[r] = fma64(v[r], *reinterpret_cast<const double2*>(smem + sa[r]), acc[r]);
}

// The items [i0, i0 + n_items) of one tile on this thread's 8 slots into
// acc (apply_items in float64): per item one table entry a slot (double
// with REAL, the tile's coefficients all real), summed over a run of items
// of one x, then one partner load psi[slot ^ x] and product a slot.
template <bool REAL>
__device__ __forceinline__ void apply64_items(const unsigned char* smem, uint32_t table, int i0,
                                              int n_items, bool skip_diagonal, uint32_t tid,
                                              uint32_t outer, const uint32_t (&sa)[kApply64Slots],
                                              double2 (&acc)[kApply64Slots],
                                              const int32_t* __restrict__ item_jt,
                                              const int32_t* __restrict__ item_zt,
                                              const int32_t* __restrict__ item_xa,
                                              const int32_t* __restrict__ item_ehi,
                                              const int32_t* __restrict__ item_zout) {
  constexpr uint32_t entry = REAL ? sizeof(double) : sizeof(double2);
  using Coef = typename std::conditional<REAL, double, double2>::type;
  uint32_t E[kApply64Slots];
  int it = 0;
  while (it < n_items) {
    const uint32_t xa = static_cast<uint32_t>(__ldg(item_xa + i0 + it));
    if (skip_diagonal && xa == 0u) {
      while (it < n_items && __ldg(item_xa + i0 + it) == 0) ++it;
      continue;
    }
    Coef coef[kApply64Slots];
    bool first = true;
    do {
      const int item = i0 + it;
      apply64_item_offsets(E, table + static_cast<uint32_t>(it) * kApplyTable * entry, entry, tid,
                           outer, static_cast<uint32_t>(__ldg(item_jt + item)),
                           static_cast<uint32_t>(__ldg(item_zt + item)),
                           static_cast<uint32_t>(__ldg(item_ehi + item)),
                           static_cast<uint32_t>(__ldg(item_zout + item)));
#pragma unroll
      for (int r = 0; r < kApply64Slots; ++r) {
        const Coef w = *reinterpret_cast<const Coef*>(smem + E[r]);
        coef[r] = first ? w : add64(coef[r], w);
      }
      first = false;
      ++it;
    } while (it < n_items && static_cast<uint32_t>(__ldg(item_xa + i0 + it)) == xa);
    const uint32_t xo = xa * static_cast<uint32_t>(sizeof(double2));
#pragma unroll
    for (int r = 0; r < kApply64Slots; ++r)
      acc[r] = fma64(coef[r], *reinterpret_cast<const double2*>(smem + (sa[r] ^ xo)), acc[r]);
  }
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Shared memory of a happly64_tiles launch (byte offsets, each a multiple
// of 512 up to the staged terms): the psi tile; with a diagonal its
// spectrum; on a later tile the out tile; the items' double2 tables, their
// real parts; the tile's terms staged (coefficient, phase bits).
struct Apply64Smem {
  uint32_t spec, ot, ctab, rtab, stage, sbits, total;
  __host__ __device__ Apply64Smem(int k, bool diagonal, bool accumulate, int n_items,
                                  int n_staged) {
    const uint32_t tile = static_cast<uint32_t>(sizeof(double2)) << k;
    spec = tile;
    ot = spec + (diagonal ? tile : 0u);
    ctab = ot + (accumulate ? tile : 0u);
    rtab = ctab + static_cast<uint32_t>(n_items) * kApplyTable * sizeof(double2);
    stage = rtab + static_cast<uint32_t>(n_items) * kApplyTable * sizeof(double);
    sbits = stage + static_cast<uint32_t>(n_staged) * sizeof(double2);
    total = sbits + static_cast<uint32_t>(n_staged) * sizeof(int32_t);
  }
};

// The tables of an application layout the H psi kernel reads (device
// pointers).
struct Apply64Tables {
  const int32_t *item_start, *term_d, *order, *item_jt, *item_zt, *item_xa, *item_ehi,
      *item_zout, *diag_zin, *diag_start, *diag_term, *diag_zout;
  const double *cre, *cim;
};

// One tile of H psi over a streaming.GroupTiles application layout, in
// complex128: block b takes tile position b (2^(n - k) blocks of 2^(k - 3)
// threads).  The first tile (`first`) stores its sum in out, a later one
// adds the sum out holds (its out tile prefetched by cp.async while the
// tables and the items run); the last (`last`) scales the finished H psi
// by `scale` as it stores it and, from the same values before the scale
// and its psi tile, takes the block's (Re <psi|H psi>, <psi|psi>) partial,
// folded in the launch into stats[4] = [E, 0, N, 0].  Each slot is owned by
// one thread of one block a launch, and the launches run in tile order.
// The tile's terms (items' rows [t0, t0 + n_terms), diagonal rows [dt0,
// dt0 + n_dterms)) are staged into shared memory in one pass of
// independent loads before the tables are formed from them: a chain of
// dependent loads per term (row, input index, coefficient) would otherwise
// set the launch's length at 18 qubits.  (One cooperative launch over all
// tiles, a grid barrier between them, measured no faster at 18 qubits and
// slower at 24.)
__global__ void __launch_bounds__(kApply64MaxThreads)
happly64_tiles_kernel(const double2* __restrict__ psi, double2* __restrict__ out, int n, int k,
                      int c, uint32_t mask, int i0, int n_items, int d0, int d1, int t0,
                      int n_terms, int dt0, int n_dterms, Apply64Tables T, double scale,
                      int first, int last, double2* __restrict__ partials,
                      double* __restrict__ stats, unsigned int* __restrict__ count) {
  extern __shared__ __align__(16) unsigned char smem[];  // tiles in tile order
  const bool diagonal = d1 > d0;
  const Apply64Smem lay(k, diagonal, !first, n_items, n_terms + n_dterms);
  const uint32_t spec_off = lay.spec, ctab = lay.ctab, rtab = lay.rtab;
  double2* spec = reinterpret_cast<double2*>(smem + spec_off);
  double2* ctables = reinterpret_cast<double2*>(smem + ctab);
  double* rtables = reinterpret_cast<double*>(smem + rtab);
  double2* scoef = reinterpret_cast<double2*>(smem + lay.stage);
  int32_t* sbits = reinterpret_cast<int32_t*>(smem + lay.sbits);
  const uint32_t tid = threadIdx.x;
  const int hb = k - kApply64TopBits;  // the register slots' tile bits: hb .. k - 1

  // slot t = tid | r << hb at flat index outer | deposit(t >> c, hi) | (t & low),
  // linear in t: the parts of tid and of each top bit are formed once
  const uint32_t low = (1u << c) - 1u, hi = mask & ~low;
  const uint32_t outer = deposit(blockIdx.x, ((1u << n) - 1u) & ~mask);
  uint32_t gr[kApply64TopBits];
#pragma unroll
  for (int b = 0; b < kApply64TopBits; ++b) {
    const uint32_t t = 1u << (hb + b);
    gr[b] = deposit(t >> c, hi) | (t & low);
  }
  uint32_t g[kApply64Slots], sa[kApply64Slots];
  g[0] = outer | deposit(tid >> c, hi) | (tid & low);
#pragma unroll
  for (int r = 1; r < kApply64Slots; ++r) g[r] = g[r & (r - 1)] | gr[r & 1 ? 0 : r & 2 ? 1 : 2];
#pragma unroll
  for (int r = 0; r < kApply64Slots; ++r) {
    sa[r] = (tid | (static_cast<uint32_t>(r) << hb)) * static_cast<uint32_t>(sizeof(double2));
    cp_async16(smem + sa[r], psi + g[r]);
  }
  cp_async_commit();
  if (!first) {  // the earlier tiles' sum, needed at the end
#pragma unroll
    for (int r = 0; r < kApply64Slots; ++r) cp_async16(smem + lay.ot + sa[r], out + g[r]);
    cp_async_commit();
  }

  // while the copies are in flight: the tile's terms staged; the diagonal's
  // spectrum (zero, then one entry per z on the tile: its terms'
  // coefficients signed by their phase bits off the tile, in a fixed
  // order), the items' tables (C[j] at j, -C[j] at j | 16), and whether any
  // coefficient of the tile is complex
  for (int q = static_cast<int>(tid); q < n_terms + n_dterms; q += blockDim.x) {
    const bool item_row = q < n_terms;
    const int o = item_row ? T.order[t0 + q] : T.diag_term[dt0 + q - n_terms];
    sbits[q] = item_row ? T.term_d[t0 + q] : T.diag_zout[dt0 + q - n_terms];
    scoef[q] = make_double2(__ldg(T.cre + o), __ldg(T.cim + o));
  }
  if (diagonal) {
#pragma unroll
    for (int r = 0; r < kApply64Slots; ++r)
      spec[tid | (static_cast<uint32_t>(r) << hb)] = make_double2(0.0, 0.0);
  }
  __syncthreads();
  int complex_coeffs = 0;
  for (int q = d0 + static_cast<int>(tid); q < d1; q += blockDim.x) {
    double2 v = make_double2(0.0, 0.0);
    for (int t = T.diag_start[q] - dt0 + n_terms; t < T.diag_start[q + 1] - dt0 + n_terms; ++t) {
      const uint32_t sbit = (__popc(outer & static_cast<uint32_t>(sbits[t])) & 1u) << 31;
      v.x += flip_sign64(scoef[t].x, sbit);
      v.y += flip_sign64(scoef[t].y, sbit);
    }
    spec[T.diag_zin[q]] = v;
    complex_coeffs |= v.y != 0.0;
  }
  for (int q = static_cast<int>(tid); q < 16 * n_items; q += blockDim.x) {
    const int it = q >> 4, item = i0 + it;
    if (diagonal && __ldg(T.item_xa + item) == 0) continue;
    const uint32_t j = static_cast<uint32_t>(q & 15);
    double2 v = make_double2(0.0, 0.0);
    for (int t = T.item_start[item] - t0; t < T.item_start[item + 1] - t0; ++t) {
      const uint32_t sbit = (__popc(j & static_cast<uint32_t>(sbits[t])) & 1u) << 31;
      v.x += flip_sign64(scoef[t].x, sbit);
      v.y += flip_sign64(scoef[t].y, sbit);
    }
    ctables[it * kApplyTable + j] = v;
    ctables[it * kApplyTable + j + 16] = make_double2(-v.x, -v.y);
    rtables[it * kApplyTable + j] = v.x;
    rtables[it * kApplyTable + j + 16] = -v.x;
    complex_coeffs |= v.y != 0.0;
  }
  if (first)
    cp_async_wait_all();
  else
    cp_async_wait_one();  // the psi tile; the out tile may still be in flight
  const bool real = !__syncthreads_or(complex_coeffs);

  double2 acc[kApply64Slots];
#pragma unroll
  for (int r = 0; r < kApply64Slots; ++r) acc[r] = make_double2(0.0, 0.0);
  if (diagonal) {
    if (real)
      apply64_diagonal<double>(smem, spec_off, tid, hb, sa, acc);
    else
      apply64_diagonal<double2>(smem, spec_off, tid, hb, sa, acc);
  }
  if (real)
    apply64_items<true>(smem, rtab, i0, n_items, diagonal, tid, outer, sa, acc, T.item_jt,
                        T.item_zt, T.item_xa, T.item_ehi, T.item_zout);
  else
    apply64_items<false>(smem, ctab, i0, n_items, diagonal, tid, outer, sa, acc, T.item_jt,
                         T.item_zt, T.item_xa, T.item_ehi, T.item_zout);

  if (!first) cp_async_wait_all();  // this thread's slots of the out tile
  double e = 0.0, nn = 0.0;
#pragma unroll
  for (int r = 0; r < kApply64Slots; ++r) {
    double2 h = acc[r];
    if (!first) {  // the earlier tiles' sum, unscaled
      const double2 o = *reinterpret_cast<const double2*>(smem + lay.ot + sa[r]);
      h = make_double2(o.x + h.x, o.y + h.y);
    }
    if (last) {
      const double2 a = *reinterpret_cast<const double2*>(smem + sa[r]);
      e += a.x * h.x + a.y * h.y;
      nn += a.x * a.x + a.y * a.y;
      h = make_double2(scale * h.x, scale * h.y);
    }
    out[g[r]] = h;
  }
  if (!last) return;
  const double2 part = block_sum_f64(make_double2(e, nn));
  fold64_last(part, static_cast<int>(blockIdx.x), static_cast<int>(gridDim.x), partials, count,
              stats);
}

// The arrays of qsfh_happly64_tiles: [0, 5) HOST tile_mask, tile_items,
// tile_diag, item_start, diag_start; [5, 17) the device tables item_start,
// term_d, order, item_jt, item_zt, item_xa, item_ehi, item_zout, diag_zin,
// diag_start, diag_term, diag_zout.
struct Apply64Host {
  const int32_t *tile_mask, *tile_items, *tile_diag, *item_start, *diag_start;
  Apply64Tables dev;
  Apply64Host(const void* const* a, const void* cre, const void* cim) {
    const int32_t** host[] = {&tile_mask, &tile_items, &tile_diag, &item_start, &diag_start};
    for (int m = 0; m < 5; ++m) *host[m] = static_cast<const int32_t*>(a[m]);
    const int32_t** d[] = {&dev.item_start, &dev.term_d,     &dev.order,     &dev.item_jt,
                           &dev.item_zt,    &dev.item_xa,    &dev.item_ehi,  &dev.item_zout,
                           &dev.diag_zin,   &dev.diag_start, &dev.diag_term, &dev.diag_zout};
    for (int m = 0; m < 12; ++m) *d[m] = static_cast<const int32_t*>(a[5 + m]);
    dev.cre = static_cast<const double*>(cre);
    dev.cim = static_cast<const double*>(cim);
  }
  // dynamic shared memory of tile r's pass
  uint32_t smem(int k, int r) const {
    const int i0 = tile_items[r], d0 = tile_diag[r];
    return Apply64Smem(k, tile_diag[r + 1] > d0, r > 0, tile_items[r + 1] - i0,
                       item_start[tile_items[r + 1]] - item_start[i0] +
                           diag_start[tile_diag[r + 1]] - diag_start[d0])
        .total;
  }
  uint32_t most_smem(int k, int n_tiles) const {
    uint32_t most = 0;
    for (int r = 0; r < n_tiles; ++r) most = smem(k, r) > most ? smem(k, r) : most;
    return most;
  }
};

inline bool apply64_shape_ok(int n, int k, int c, int n_tiles) {
  return k >= kApply64MinBits && k <= kApply64MaxBits && k <= n && n <= 30 && c >= 1 &&
         c <= k - kApply64TopBits && n_tiles >= 1;
}

inline int rot64_blocks(int n) {
  const unsigned blocks = blocks_for(1ull << (n - 1), kRot64Threads);
  const unsigned cap = static_cast<unsigned>(sm_count()) * kRot64BlocksPerSm;
  return static_cast<int>(blocks < cap ? blocks : cap);
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

// The largest staging (stage_run) of the runs [0, n_runs) of a table, or 0
// where a run holds more than kMaxRunTerms terms.
inline size_t most_stage_bytes(int n_runs, const int32_t* run_start, const int32_t* run_fgroup,
                               size_t extra) {
  size_t most = 0;
  for (int r = 0; r < n_runs; ++r) {
    const int T = run_start[r + 1] - run_start[r];
    if (T > kMaxRunTerms) return 0;
    most = max(most, stage_bytes(T, run_fgroup[r + 1] - run_fgroup[r], extra));
  }
  return most;
}

// The tile runs [0, n_runs) of a streaming.TileRuns table, in place: one
// launch per run, one block per tile.  run_start (n_runs + 1), run_mask
// (n_runs), run_group and run_fgroup (n_runs + 1 each) are HOST arrays;
// code, z_tile, z_out, angles, phre and phim are device arrays indexed by
// the table's term index (run_start values), gstart and gregs by its group
// index (run_group values), frec by its fused record (run_fgroup values).
int qsfh_rotation_tile_runs(void* psi, int n, int k, int c, int n_runs,
                            const int32_t* run_start, const int32_t* run_mask,
                            const int32_t* run_group, const int32_t* run_fgroup, const void* code,
                            const void* z_tile, const void* z_out, const void* gstart,
                            const void* gregs, const void* frec, const void* angles,
                            const void* phre, const void* phim, void* stream) {
  if (!tile_shape_ok(n, k, c)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t tile = sizeof(float2) << k;
  const size_t most = most_stage_bytes(n_runs, run_start, run_fgroup, 0);
  if (most == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(rotation_tile_run_kernel, tile + most);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int r = 0; r < n_runs; ++r) {
    const int t0 = run_start[r], T = run_start[r + 1] - t0, g0 = run_group[r];
    const int f0 = run_fgroup[r], F = run_fgroup[r + 1] - f0;
    rotation_tile_run_kernel<<<1u << (n - k), 1u << (k - 4), tile + stage_bytes(T, F, 0), s>>>(
        static_cast<float2*>(psi), n, k, c, static_cast<uint32_t>(run_mask[r]), T,
        static_cast<const int32_t*>(code) + t0, static_cast<const int32_t*>(z_tile) + t0,
        static_cast<const int32_t*>(z_out) + t0, static_cast<const int32_t*>(gstart) + g0,
        static_cast<const int32_t*>(gregs) + g0, run_group[r + 1] - g0, t0,
        static_cast<const int32_t*>(frec) + static_cast<size_t>(f0) * kFusedRec, F,
        static_cast<const float*>(angles) + t0, static_cast<const float*>(phre) + t0,
        static_cast<const float*>(phim) + t0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

// The adjoint sweep over the tile runs [0, n_runs) of a streaming.TileRuns
// table (terms in REVERSED order), in place on psi and lam; arrays as in
// qsfh_rotation_tile_runs.  out[t - run_start[0]] = <lam | P_t psi> at the
// post-gate state of term t, summed over blocks by ONE reduce_partials
// launch.  partials: (run_start[n_runs] - run_start[0]) x 2^(n - k) float2.
int qsfh_adjoint_tile_runs(void* psi, void* lam, int n, int k, int c, int n_runs,
                           const int32_t* run_start, const int32_t* run_mask,
                           const int32_t* run_group, const int32_t* run_fgroup, const void* code,
                           const void* z_tile, const void* z_out, const void* gstart,
                           const void* gregs, const void* frec, const void* angles,
                           const void* phre, const void* phim, void* partials, void* out,
                           void* stream) {
  if (!tile_shape_ok(n, k, c)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned threads = 1u << (k - 4), grid = 1u << (n - k);
  const size_t warp_rows = (threads / 32) * sizeof(float2);
  const size_t tiles = 2 * (sizeof(float2) << k);
  const size_t most = most_stage_bytes(n_runs, run_start, run_fgroup, warp_rows);
  if (most == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(adjoint_tile_run_kernel, tiles + most);
  if (err != cudaSuccess) return static_cast<int>(err);
  float2* part = static_cast<float2*>(partials);
  for (int r = 0; r < n_runs; ++r) {
    const int t0 = run_start[r], T = run_start[r + 1] - t0, g0 = run_group[r];
    const int f0 = run_fgroup[r], F = run_fgroup[r + 1] - f0;
    adjoint_tile_run_kernel<<<grid, threads, tiles + stage_bytes(T, F, warp_rows), s>>>(
        static_cast<float2*>(psi), static_cast<float2*>(lam), n, k, c,
        static_cast<uint32_t>(run_mask[r]), T, static_cast<const int32_t*>(code) + t0,
        static_cast<const int32_t*>(z_tile) + t0, static_cast<const int32_t*>(z_out) + t0,
        static_cast<const int32_t*>(gstart) + g0, static_cast<const int32_t*>(gregs) + g0,
        run_group[r + 1] - g0, t0,
        static_cast<const int32_t*>(frec) + static_cast<size_t>(f0) * kFusedRec, F,
        static_cast<const float*>(angles) + t0,
        static_cast<const float*>(phre) + t0, static_cast<const float*>(phim) + t0,
        part + static_cast<size_t>(t0 - run_start[0]) * grid);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(reduce_partials(part, static_cast<int>(grid),
                                          run_start[n_runs] - run_start[0],
                                          static_cast<float2*>(out), s));
}

// The largest cooperative grid of the resident rotation (adjoint = 0) or
// adjoint (adjoint = 1) kernel at tiles of k bits whose longest run has
// most_terms terms, or a negative CUDA error code.
int qsfh_resident_capacity(int adjoint, int k, int most_terms) {
  return resident_capacity(adjoint != 0, k, most_terms);
}

// The tile runs [0, n_runs) of a streaming.TileRuns table, in place, in ONE
// cooperative launch of `grid` blocks (at most the tiles of a run and the
// capacity above).  run_start_host is the host copy of run_start; every
// other array is on the device: run_start (n_runs + 1), run_mask (n_runs)
// run_group and run_fgroup (n_runs + 1 each), then the arrays of
// qsfh_rotation_tile_runs.  barrier: one unsigned word, zero before the
// first launch on the stream and left zero by every launch.
int qsfh_rotation_resident(void* psi, int n, int k, int c, int n_runs, int grid,
                           const int32_t* run_start_host, const void* run_start,
                           const void* run_mask, const void* run_group, const void* run_fgroup,
                           const void* code, const void* z_tile, const void* z_out,
                           const void* gstart, const void* gregs, const void* frec,
                           const void* angles, const void* phre, const void* phim,
                           void* barrier, void* stream) {
  size_t smem = 0;
  int most = 0;
  cudaError_t err = resident_setup(false, n, k, c, n_runs, run_start_host, grid, &most, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  float2* a_psi = static_cast<float2*>(psi);
  const int32_t *a_start = static_cast<const int32_t*>(run_start),
                *a_mask = static_cast<const int32_t*>(run_mask),
                *a_group = static_cast<const int32_t*>(run_group),
                *a_fgroup = static_cast<const int32_t*>(run_fgroup),
                *a_code = static_cast<const int32_t*>(code),
                *a_zt = static_cast<const int32_t*>(z_tile),
                *a_zo = static_cast<const int32_t*>(z_out),
                *a_gs = static_cast<const int32_t*>(gstart),
                *a_gr = static_cast<const int32_t*>(gregs),
                *a_frec = static_cast<const int32_t*>(frec);
  const float *a_ang = static_cast<const float*>(angles), *a_re = static_cast<const float*>(phre),
              *a_im = static_cast<const float*>(phim);
  unsigned int* a_bar = static_cast<unsigned int*>(barrier);
  void* args[] = {&a_psi,  &n,     &k,    &c,    &n_runs, &most,   &a_start, &a_mask,
                  &a_group, &a_fgroup, &a_code, &a_zt, &a_zo, &a_gs, &a_gr,  &a_frec,
                  &a_ang,  &a_re,  &a_im,  &a_bar};
  err = cudaLaunchCooperativeKernel(resident_kernel(false), dim3(grid), dim3(1u << (k - 4)), args,
                                    smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The adjoint sweep over the tile runs [0, n_runs) of a streaming.TileRuns
// table (terms in REVERSED order), in place on psi and lam, in ONE
// cooperative launch; arrays as in qsfh_rotation_resident.  out[t] =
// <lam | P_t psi> at the post-gate state of term t, summed in the launch.
// partials: run_start[n_runs] x 2^(n - k) float2 scratch.
int qsfh_adjoint_resident(void* psi, void* lam, int n, int k, int c, int n_runs, int grid,
                          const int32_t* run_start_host, const void* run_start,
                          const void* run_mask, const void* run_group, const void* run_fgroup,
                          const void* code, const void* z_tile, const void* z_out,
                          const void* gstart, const void* gregs, const void* frec,
                          const void* angles, const void* phre, const void* phim,
                          void* partials, void* out, void* barrier, void* stream) {
  size_t smem = 0;
  int most = 0;
  cudaError_t err = resident_setup(true, n, k, c, n_runs, run_start_host, grid, &most, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  float2 *a_psi = static_cast<float2*>(psi), *a_lam = static_cast<float2*>(lam);
  const int32_t *a_start = static_cast<const int32_t*>(run_start),
                *a_mask = static_cast<const int32_t*>(run_mask),
                *a_group = static_cast<const int32_t*>(run_group),
                *a_fgroup = static_cast<const int32_t*>(run_fgroup),
                *a_code = static_cast<const int32_t*>(code),
                *a_zt = static_cast<const int32_t*>(z_tile),
                *a_zo = static_cast<const int32_t*>(z_out),
                *a_gs = static_cast<const int32_t*>(gstart),
                *a_gr = static_cast<const int32_t*>(gregs),
                *a_frec = static_cast<const int32_t*>(frec);
  const float *a_ang = static_cast<const float*>(angles), *a_re = static_cast<const float*>(phre),
              *a_im = static_cast<const float*>(phim);
  float2 *a_part = static_cast<float2*>(partials), *a_out = static_cast<float2*>(out);
  unsigned int* a_bar = static_cast<unsigned int*>(barrier);
  void* args[] = {&a_psi,   &a_lam,   &n,      &k,    &c,    &n_runs, &most,   &a_start,
                  &a_mask,  &a_group, &a_fgroup, &a_code, &a_zt, &a_zo,  &a_gs,   &a_gr,
                  &a_frec,  &a_ang,   &a_re,   &a_im,   &a_part, &a_out, &a_bar};
  err = cudaLaunchCooperativeKernel(resident_kernel(true), dim3(grid), dim3(1u << (k - 4)), args,
                                    smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// out[b] = psi[b ^ x] with x the low 32-bit word of *mask_dev (an int32 or
// int64 on the device), or mask when mask_dev is null.
int qsfh_xor_gather(const void* psi, void* out, int n, const void* mask_dev, int mask,
                    void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t pairs = 1u << (n - 1);
  xor_gather_kernel<<<blocks_for(pairs, kGatherPairs * kThreads), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(psi), static_cast<float4*>(out), pairs,
      static_cast<const uint32_t*>(mask_dev), static_cast<uint32_t>(mask));
  return static_cast<int>(cudaGetLastError());
}

// The units [0, n_units) (int32 rows of 4 on the device: tile, first
// item, items, diagonal) of a streaming.GroupTiles schedule, whose tiles'
// rows of `order` are [t0, t0 + n_rows): one launch of n_units x
// ceil(2^(n - k) / positions) blocks, `positions` tile positions a block,
// then one fold pass (fold_partials_kernel, `mode` 0, 1 or 2) into out.
// The item, term and diagonal tables are the layout's (device arrays);
// diag_row is the row of the first diagonal term, most_items the most
// items of one unit, swizzle the packed streaming.INNER_SWIZZLE (4 bits per
// tile bit from 4 up); cre and cim are float32 with cstride floats between
// terms, read by input index (modes 1 and 2).  partials: n_rows x the
// position slices float2 scratch; bsum: a float per fold block (mode 2);
// count: one word, 0 before and after (mode 2).  a == psi loads one tile
// per position.
int qsfh_pauli_inner_tiles(const void* a, const void* psi, int n, int k, int c,
                           unsigned long long swizzle, const void* tile_mask, const void* units,
                           int n_units, const void* item_cols, const void* item_x,
                           const void* item_zlc, const void* item_zout, const void* item_start,
                           const void* term_d, const void* order, const void* diag_zin,
                           const void* diag_zout, int n_diag, int diag_row, int t0, int n_rows,
                           int most_items, int positions, void* partials, int mode,
                           const void* cre, const void* cim, int cstride, void* out, void* bsum,
                           void* count, int accumulate, void* stream) {
  if (k < kInnerTileMinBits || k > kInnerTileMaxBits || k > n || c < 1 || c > k ||
      n_units < 1 || n_rows < 1 || positions < 1 || most_items < 0 || n_diag < 0 ||
      mode < 0 || mode > 2 || cstride < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned slices = ((1u << (n - k)) + positions - 1) / positions;
  if (slices > static_cast<unsigned>(kMaxGridY)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool same = a == psi;
  const size_t items_smem = (same ? 1 : 2) * (sizeof(float2) << k) +
                            static_cast<size_t>(most_items) * 16 * sizeof(float2);
  const size_t diag_smem = n_diag ? (same ? sizeof(float) : sizeof(float2)) << k : 0;
  const size_t diag_all = diag_smem + static_cast<size_t>(n_diag) * sizeof(float2);
  const size_t smem = items_smem > diag_all ? items_smem : diag_all;
  const auto kernel = same ? pauli_inner_tiles_kernel<true> : pauli_inner_tiles_kernel<false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(n_units, slices), kInnerTileThreads, smem, s>>>(
      static_cast<const float2*>(a), static_cast<const float2*>(psi), n, k, c,
      static_cast<uint64_t>(swizzle), static_cast<const int32_t*>(tile_mask),
      static_cast<const int4*>(units), static_cast<const int32_t*>(item_cols),
      static_cast<const int32_t*>(item_x), static_cast<const int32_t*>(item_zlc),
      static_cast<const int32_t*>(item_zout), static_cast<const int32_t*>(item_start),
      static_cast<const int32_t*>(term_d), static_cast<const int32_t*>(diag_zin),
      static_cast<const int32_t*>(diag_zout), n_diag, diag_row, positions, t0,
      static_cast<float2*>(partials));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int warps = kThreads / 32;
  fold_partials_kernel<<<blocks_for(n_rows, warps), kThreads, 0, s>>>(
      static_cast<const float2*>(partials), static_cast<int>(slices), n_rows,
      static_cast<const int32_t*>(order) + t0, mode, static_cast<const float*>(cre),
      static_cast<const float*>(cim), cstride, out, static_cast<float*>(bsum),
      static_cast<unsigned int*>(count), accumulate);
  return static_cast<int>(cudaGetLastError());
}

// qsfh_pauli_rotation_out with every scalar an argument (the common
// case: fewer arguments through ctypes).
int qsfh_pauli_rotation_out_values(const void* psi, void* out, int n, int x, int z, float theta,
                                   float phre, float phim, void* stream) {
  if (n < 2) return static_cast<int>(cudaErrorInvalidValue);
  rotation_out_kernel<<<blocks_for(1u << (n - 2), kThreads), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(psi), static_cast<float4*>(out), n, nullptr,
      static_cast<uint32_t>(x), nullptr, static_cast<uint32_t>(z), nullptr, theta, nullptr, phre,
      nullptr, phim);
  return static_cast<int>(cudaGetLastError());
}

// out = exp(-i theta P) psi for one term P psi[b] = (phre + i phim)
// (-1)^popc(b & z) psi[b ^ x], out of place: x, z (int32 or int64: the
// low word) and theta, phre, phim (float32) are read from the device where
// their pointer is given, else taken from the arguments.
int qsfh_pauli_rotation_out(const void* psi, void* out, int n, const void* x_dev, int x,
                            const void* z_dev, int z, const void* theta_dev, float theta,
                            const void* phre_dev, float phre, const void* phim_dev, float phim,
                            void* stream) {
  if (n < 2) return static_cast<int>(cudaErrorInvalidValue);
  const uint32_t quads = 1u << (n - 2);  // thread-owned pairs of 16-byte pairs
  rotation_out_kernel<<<blocks_for(quads, kThreads), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(psi), static_cast<float4*>(out), n,
      static_cast<const uint32_t*>(x_dev), static_cast<uint32_t>(x),
      static_cast<const uint32_t*>(z_dev), static_cast<uint32_t>(z),
      static_cast<const float*>(theta_dev), theta, static_cast<const float*>(phre_dev), phre,
      static_cast<const float*>(phim_dev), phim);
  return static_cast<int>(cudaGetLastError());
}

// out = sum_t c_t P_t psi over the n_tiles tiles of a streaming.GroupTiles
// table, one launch per tile in table order: the first stores out (adds to
// it when accumulate is set), each later one adds.  tile_mask (n_tiles),
// tile_items and tile_diag (n_tiles + 1) are HOST arrays, the item, term
// and diagonal tables device arrays; cre and cim are float32 with cstride
// floats between terms (2 for the real and imaginary views of one
// complex64 tensor), indexed by the input term index (order, diag_term).
int qsfh_pauli_apply_grouped(const void* psi, void* out, int n, int k, int c, int n_tiles,
                             const int32_t* tile_mask,
                             const int32_t* tile_items, const int32_t* tile_diag,
                             const void* item_start, const void* term_d, const void* order,
                             const void* item_jt, const void* item_zt, const void* item_xa,
                             const void* item_ehi, const void* item_zout, const void* diag_zin,
                             const void* diag_start, const void* diag_term, const void* diag_zout,
                             const void* cre, const void* cim, int cstride, int accumulate,
                             void* stream) {
  if (k < kInnerTileMinBits || k > kInnerTileMaxBits || k > n || c < 1 || c > k - 3 ||
      n_tiles < 1 || cstride < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t tiles = 2 * (sizeof(float2) << k);
  const size_t per_item = kApplyTable * (sizeof(float2) + sizeof(float));
  int most = 0;
  for (int r = 0; r < n_tiles; ++r) most = max(most, tile_items[r + 1] - tile_items[r]);
  cudaError_t err = allow_smem(pauli_apply_tiles_kernel, tiles + most * per_item);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int r = 0; r < n_tiles; ++r) {
    const int i0 = tile_items[r], items = tile_items[r + 1] - i0;
    const int d0 = tile_diag[r], d1 = tile_diag[r + 1];
    pauli_apply_tiles_kernel<<<1u << (n - k), 1u << (k - kApplyTopBits),
                               tiles + items * per_item, s>>>(
        static_cast<const float2*>(psi), static_cast<float2*>(out), n, k, c,
        static_cast<uint32_t>(tile_mask[r]), i0, items, d0, d1,
        static_cast<const int32_t*>(item_start), static_cast<const int32_t*>(term_d),
        static_cast<const int32_t*>(order), static_cast<const int32_t*>(item_jt),
        static_cast<const int32_t*>(item_zt), static_cast<const int32_t*>(item_xa),
        static_cast<const int32_t*>(item_ehi), static_cast<const int32_t*>(item_zout),
        static_cast<const int32_t*>(diag_zin), static_cast<const int32_t*>(diag_start),
        static_cast<const int32_t*>(diag_term), static_cast<const int32_t*>(diag_zout),
        static_cast<const float*>(cre), static_cast<const float*>(cim), cstride,
        (r > 0 || accumulate) ? 1 : 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

// Blocks of an expectation_norm_f64 launch at n qubits (the length of its
// double2 partials).
int qsfh_f64_blocks(int n) {
  if (n < 1 || n > 30) return 0;
  return f64_blocks(n);
}

// out[4] = [E, 0, N, 0] in float64 (see expectation_norm_f64_kernel): the
// terms sorted by flip mask, n_groups groups at offsets starts[0..n_groups]
// (device int32), masks xs / zs (int32) and coefficients cre / cim
// (float64) on the device; partials: qsfh_f64_blocks(n) double2 scratch.
int qsfh_expectation_norm_f64(const void* psi, int n, int n_groups, const void* starts,
                              const void* xs, const void* zs, const void* cre, const void* cim,
                              void* partials, void* out, void* stream) {
  if (n < 1 || n > 30 || n_groups < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = f64_blocks(n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  expectation_norm_f64_kernel<<<grid, kF64Threads, 0, s>>>(
      static_cast<const float2*>(psi), static_cast<uint32_t>(1ull << n), n_groups,
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(xs),
      static_cast<const int32_t*>(zs), static_cast<const double*>(cre),
      static_cast<const double*>(cim), static_cast<double2*>(partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_f64_partials_kernel<<<1, kF64Threads, 0, s>>>(static_cast<const double2*>(partials), grid,
                                                   static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Blocks of a rot64 / adjoint64 group launch at n qubits (the adjoint's
// partials hold n_groups rows of this many doubles).
int qsfh_rot64_blocks(int n) {
  if (n < 1 || n > 30) return 0;
  return rot64_blocks(n);
}

// psi <- exp(-i theta_{G-1} M_{G-1}) ... exp(-i theta_0 M_0) psi in place,
// one launch per group (see rot64_group_kernel): complex128 psi, int32 gx /
// goff (n_groups + 1) / gflip / gpidx / zsub, float64 wsub and theta_ext,
// all on the device.
int qsfh_rot64_groups(void* psi, int n, int n_groups, const void* gx, const void* goff,
                      const void* gflip, const void* gpidx, const void* zsub, const void* wsub,
                      const void* theta_ext, void* stream) {
  if (n < 1 || n > 30 || n_groups < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = rot64_blocks(n);
  for (int g = 0; g < n_groups; ++g) {
    rot64_group_kernel<<<grid, kRot64Threads, 0, s>>>(
        static_cast<double2*>(psi), n, g, static_cast<const int32_t*>(gx),
        static_cast<const int32_t*>(goff), static_cast<const int32_t*>(gflip),
        static_cast<const int32_t*>(gpidx), static_cast<const int32_t*>(zsub),
        static_cast<const double*>(wsub), static_cast<const double*>(theta_ext));
    if (g == 0) {
      const cudaError_t err = cudaPeekAtLastError();
      if (err != cudaSuccess) return static_cast<int>(cudaGetLastError());
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// out = scale * H psi (complex128; int32 hx / hz, float64 cre / cim on the
// device) and e_out[4] = [Re <psi|H psi>, 0, <psi|psi>, 0] before the scale;
// partials: qsfh_f64_blocks(n) double2 scratch.
int qsfh_happly64(const void* psi, void* out, int n, int n_terms, const void* hx, const void* hz,
                  const void* cre, const void* cim, double scale, void* partials, void* e_out,
                  void* stream) {
  if (n < 1 || n > 30 || n_terms < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = f64_blocks(n);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  happly64_kernel<<<grid, kF64Threads, 0, s>>>(
      static_cast<const double2*>(psi), static_cast<double2*>(out),
      static_cast<uint32_t>(1ull << n), n_terms, static_cast<const int32_t*>(hx),
      static_cast<const int32_t*>(hz), static_cast<const double*>(cre),
      static_cast<const double*>(cim), scale, static_cast<double2*>(partials));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_f64_partials_kernel<<<1, kF64Threads, 0, s>>>(static_cast<const double2*>(partials), grid,
                                                   static_cast<double*>(e_out));
  return static_cast<int>(cudaGetLastError());
}

// out[4] = [E, 0, N, 0] of a complex64 state in float64 over the n_units
// units (int32 rows of 4 on the device: tile, first item, items, diagonal)
// of a streaming.GroupTiles schedule whose last unit is the diagonal (see
// expectation_f64_tiles_kernel): ONE launch of n_units x
// ceil(2^(n - k) / positions) blocks, the fold inside it.  The item, term
// and diagonal tables are the layout's (device arrays), order + diag_row
// the diagonal's input indices, diag_mask its tile, most_items the most
// items of one unit; cre and cim are float64 on the device, read by input
// term index.  partials: a double2 a block of scratch; count: one word, 0
// before and after.
int qsfh_expectation_f64_tiles(const void* psi, int n, int k, int c, unsigned long long swizzle,
                               const void* tile_mask, const void* units, int n_units,
                               const void* item_cols, const void* item_x, const void* item_zlc,
                               const void* item_zout, const void* item_start, const void* term_d,
                               const void* order, const void* diag_zin, const void* diag_zout,
                               int n_diag, int diag_row, int diag_mask, int most_items,
                               int most_terms, int positions, const void* cre, const void* cim,
                               void* partials, void* out, void* count, void* stream) {
  if (k < kInnerTileMinBits || k > kReadout64MaxBits || k > n || n > 30 || c < 1 || c > 8 ||
      n_units < 1 || positions < 1 || most_items < 0 || most_items > 1024 || most_terms < 0 ||
      n_diag < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned slices = ((1u << (n - k)) + positions - 1) / positions;
  if (slices > static_cast<unsigned>(kMaxGridY)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t items_smem = (sizeof(float2) << k) +
                            static_cast<size_t>(most_items) * 8 * sizeof(double2) +
                            static_cast<size_t>(most_terms) * (sizeof(double2) + sizeof(int32_t));
  const size_t diag_smem = (sizeof(double) << k) + static_cast<size_t>(n_diag) * sizeof(double);
  const size_t smem = items_smem > diag_smem ? items_smem : diag_smem;
  cudaError_t err = allow_smem(expectation_f64_tiles_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  expectation_f64_tiles_kernel<<<dim3(n_units, slices), kInnerTileThreads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(psi), n, k, c, static_cast<uint64_t>(swizzle),
      static_cast<const int32_t*>(tile_mask), static_cast<const int4*>(units),
      static_cast<const int32_t*>(item_cols), static_cast<const int32_t*>(item_x),
      static_cast<const int32_t*>(item_zlc), static_cast<const int32_t*>(item_zout),
      static_cast<const int32_t*>(item_start), static_cast<const int32_t*>(term_d),
      static_cast<const int32_t*>(order), static_cast<const int32_t*>(diag_zin),
      static_cast<const int32_t*>(diag_zout), n_diag, diag_row, static_cast<uint32_t>(diag_mask),
      most_items, positions, static_cast<const double*>(cre), static_cast<const double*>(cim),
      static_cast<double2*>(partials), static_cast<double*>(out),
      static_cast<unsigned int*>(count));
  return static_cast<int>(cudaGetLastError());
}

// out = scale * sum_t c_t P_t psi (complex128) over the n_tiles tiles of a
// streaming.GroupTiles application layout, one launch per tile in table
// order (see happly64_tiles_kernel), and stats[4] = [Re <psi|H psi>, 0,
// <psi|psi>, 0] before the scale, folded in the last launch.  arrays: the
// 17 pointers of Apply64Host (a host array); cre and cim are
// float64 on the device, read by input term index.  partials: 2^(n - k)
// double2 of scratch; count: one word, 0 before and after.
int qsfh_happly64_tiles(const void* psi, void* out, int n, int k, int c, int n_tiles,
                        const void* const* arrays, const void* cre, const void* cim, double scale,
                        void* partials, void* stats, void* count, void* stream) {
  if (!apply64_shape_ok(n, k, c, n_tiles)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Apply64Host H(arrays, cre, cim);
  cudaError_t err = allow_smem(happly64_tiles_kernel, H.most_smem(k, n_tiles));
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int r = 0; r < n_tiles; ++r) {
    const int i0 = H.tile_items[r], i1 = H.tile_items[r + 1];
    const int d0 = H.tile_diag[r], d1 = H.tile_diag[r + 1];
    const int t0 = H.item_start[i0], dt0 = H.diag_start[d0];
    happly64_tiles_kernel<<<1u << (n - k), 1u << (k - kApply64TopBits), H.smem(k, r), s>>>(
        static_cast<const double2*>(psi), static_cast<double2*>(out), n, k, c,
        static_cast<uint32_t>(H.tile_mask[r]), i0, i1 - i0, d0, d1, t0, H.item_start[i1] - t0,
        dt0, H.diag_start[d1] - dt0, H.dev, scale, r == 0 ? 1 : 0, r == n_tiles - 1 ? 1 : 0,
        static_cast<double2*>(partials), static_cast<double*>(stats),
        static_cast<unsigned int*>(count));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

// The reverse sweep over the groups in place on psi and lam (see
// adjoint64_group_kernel), then grad[j] for j < n_params from the partials
// (n_groups x qsfh_rot64_blocks(n) doubles) over the groups
// param_groups[param_off[j] .. param_off[j + 1]] (int32, ascending).
int qsfh_adjoint64_groups(void* psi, void* lam, int n, int n_groups, const void* gx,
                          const void* goff, const void* gflip, const void* gpidx, const void* zsub,
                          const void* wsub, const void* theta_ext, int n_params,
                          const void* param_off, const void* param_groups, void* partials,
                          void* grad, void* stream) {
  if (n < 1 || n > 30 || n_groups < 0 || n_params < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = rot64_blocks(n);
  double* part = static_cast<double*>(partials);
  for (int g = n_groups - 1; g >= 0; --g) {
    adjoint64_group_kernel<<<grid, kRot64Threads, 0, s>>>(
        static_cast<double2*>(psi), static_cast<double2*>(lam), n, g,
        static_cast<const int32_t*>(gx), static_cast<const int32_t*>(goff),
        static_cast<const int32_t*>(gflip), static_cast<const int32_t*>(gpidx),
        static_cast<const int32_t*>(zsub), static_cast<const double*>(wsub),
        static_cast<const double*>(theta_ext), part + static_cast<size_t>(g) * grid);
    if (g == n_groups - 1) {
      const cudaError_t err = cudaPeekAtLastError();
      if (err != cudaSuccess) return static_cast<int>(cudaGetLastError());
    }
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_params == 0) return static_cast<int>(err);
  adjoint64_fold_kernel<<<n_params, kRot64Threads, 0, s>>>(
      part, grid, static_cast<const int32_t*>(param_off),
      static_cast<const int32_t*>(param_groups), static_cast<double*>(grad));
  return static_cast<int>(cudaGetLastError());
}

// The largest cooperative grid of rot64_resident (adjoint = 0) or
// adjoint64_resident (adjoint = 1) of `threads` a block at tiles of k bits
// whose largest run holds most_entries table entries and most_groups
// groups, or a negative CUDA error code.
int qsfh_res64_capacity(int adjoint, int k, int threads, int most_entries, int most_groups) {
  return res64_capacity(adjoint != 0, k, threads, most_entries, most_groups);
}

// The forward pass of a float64 group program over its n_runs tile runs, in
// place on psi (complex128), in ONE cooperative launch of `grid` blocks (at
// most the 2^(n - k) tiles of a run and the capacity above) of `threads`.
// arrays: the 10 device pointers of Res64Layout in its order (a host
// array); tables: 3 n_entries doubles of scratch; barrier: one unsigned
// word, zero before the first launch on the stream and left zero by every
// launch.
int qsfh_rot64_resident(void* psi, int n, int k, int n_runs, int grid, int threads, int n_entries,
                        int most_entries, int most_groups, const void* const* arrays,
                        void* tables, void* barrier, void* stream) {
  if (!res64_shape_ok(false, n, k, threads, most_entries, most_groups) || n_runs < 1 ||
      grid < 1 || grid > (1 << (n - k)) || n_entries < most_entries)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = Res64Smem(false, k, threads, most_entries, most_groups).total;
  cudaError_t err = res64_allow(false, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  double2* a_psi = static_cast<double2*>(psi);
  Res64Layout L = res64_layout(arrays);
  double* a_tab = static_cast<double*>(tables);
  unsigned int* a_bar = static_cast<unsigned int*>(barrier);
  void* args[] = {&a_psi, &n, &k, &n_runs, &n_entries, &most_entries, &most_groups, &L,
                  &a_tab, &a_bar};
  err = cudaLaunchCooperativeKernel(res64_kernel(false), dim3(grid), dim3(threads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The reverse sweep of the same program, in place on psi and lam, in ONE
// cooperative launch: grad[j] for j < n_params over the groups
// param_groups[param_off[j] .. param_off[j + 1]] (int32, ascending), from
// partials (n_groups x 2^(n - k) doubles of scratch); the rest as
// qsfh_rot64_resident.
int qsfh_adjoint64_resident(void* psi, void* lam, int n, int k, int n_runs, int grid, int threads,
                            int n_entries, int most_entries, int most_groups,
                            const void* const* arrays, void* tables, void* partials,
                            int n_params, const void* param_off, const void* param_groups,
                            void* grad, void* barrier, void* stream) {
  if (!res64_shape_ok(true, n, k, threads, most_entries, most_groups) || n_runs < 1 ||
      grid < 1 || grid > (1 << (n - k)) || n_entries < most_entries || n_params < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = Res64Smem(true, k, threads, most_entries, most_groups).total;
  cudaError_t err = res64_allow(true, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  double2 *a_psi = static_cast<double2*>(psi), *a_lam = static_cast<double2*>(lam);
  Res64Layout L = res64_layout(arrays);
  double *a_tab = static_cast<double*>(tables), *a_part = static_cast<double*>(partials),
         *a_grad = static_cast<double*>(grad);
  const int32_t *a_off = static_cast<const int32_t*>(param_off),
                *a_groups = static_cast<const int32_t*>(param_groups);
  unsigned int* a_bar = static_cast<unsigned int*>(barrier);
  void* args[] = {&a_psi,  &a_lam,    &n,        &k,      &n_runs,   &n_entries,
                  &most_entries, &most_groups, &L, &a_tab, &a_part, &n_params,
                  &a_off,  &a_groups, &a_grad,   &a_bar};
  err = cudaLaunchCooperativeKernel(res64_kernel(true), dim3(grid), dim3(threads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
