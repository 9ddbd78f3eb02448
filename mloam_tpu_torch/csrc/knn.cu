// Fused brute-force k-nearest-neighbour search over 3-D points, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel mloam_tpu/ops/pallas_knn.py:_lane_bucket_kernel
// (entry knn_pallas): for every query the k <= 8 nearest unmasked reference
// points, squared distance ascending plus int64 index, with the distance tile
// formed and reduced on chip and never written to device memory. Unlike the
// TPU kernel, which is exact only for k = 1, this one is exact for every k.
// Ties go to the lowest index. Slots that find no unmasked reference keep
// d2 = 1e30 and index 0.
//
// What bounds it on this card: operations. Every (query, valid reference)
// pair costs three subtractions, three multiply-adds and one compare on the
// CUDA cores (8 flop), while the bytes are the two point sets read once and
// k results per query. No tensor cores: 3-wide dot products give wgmma
// nothing, and the ||q||^2 + ||r||^2 - 2 q.r expansion that would feed them
// cancels at LiDAR range (~1e-4 m^2 at 40 m), so the distance is taken
// directly as (qx-rx)^2 + (qy-ry)^2 + (qz-rz)^2.
//
// What held the first design back: one query per thread in blocks of 64
// gave 3 to 96 blocks on 132 SMs, two warps an SM at most, and each thread
// walked every reference in one dependent loop: latency, not arithmetic
// (0.406 ms for 6144 x 10240, ~250x the bound). It also computed and
// compared masked references (78 % of them at the window's plane map), and
// staged each tile with stride-3 scalar loads that nothing overlapped.
//
// This design, one launch per call:
//  * S lanes of a warp share one query, in blocks of 256 threads. S is a
//    power of two from 8 to 32, chosen by the wrapper from Nq so that the
//    grid holds at least four warps an SM (ops/hopper_knn.lanes_per_query).
//    Lane s walks the valid references s, s+S, s+2S, ... of each tile in
//    ascending order and keeps its own sorted k-list in registers
//    (insertion unrolled by the K template parameter: the list never goes to
//    local memory). A newcomer passes only strictly greater distances, so
//    equal distances stay in index order. log2(S) rounds of __shfl_xor_sync
//    then merge pairs of lists with a bitonic merge that orders by
//    (d2, index) lexicographically: that keeps the merge exact and the tie
//    rule intact, where d2 order alone would not. Every S gives the same
//    answer.
//  * Masked references are skipped. When a tile is in shared memory the
//    block compacts its valid references (__ballot_sync / __popc prefix
//    sums) into float4(x, y, z, bit-cast index), in ascending index order;
//    the distance loop runs over those only. The block's 8 warps share that
//    work. All in the one launch: each block reads the Nr mask bytes, which
//    costs less than a second launch would.
//  * Staging is asynchronous and coalesced: the next raw tile (its 12*kTile
//    contiguous bytes of xyz and kTile mask bytes) is copied with 16-byte
//    cp.async into the other of two buffers while the current tile is
//    compacted and walked. The wrapper hands over 16-byte aligned r and mask.
//  * No limit on Nr or Nq beyond int32 indexing; no allocation, no
//    synchronisation with the host.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;      // reference points per shared-memory tile
constexpr int kThreads = 256;   // 8 warps: they share each tile's compaction
constexpr float kBig = 1e30f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start the copies of raw tile [base, base + n) into (xyz, m). The 12*n
// bytes of xyz and the first n & ~15 mask bytes go by 16-byte cp.async, the
// ragged end of the last tile by 4-byte cp.async and plain loads.
__device__ __forceinline__ void stage_tile(float* xyz, unsigned char* m,
                                           const float* __restrict__ r,
                                           const unsigned char* __restrict__ r_mask,
                                           long long base, int n) {
  const float* src = r + 3 * base;
  const int nf = 3 * n;
  const int n16 = nf >> 2;
  for (int c = threadIdx.x; c < n16; c += kThreads) cp_async16(xyz + 4 * c, src + 4 * c);
  for (int f = 4 * n16 + threadIdx.x; f < nf; f += kThreads) cp_async4(xyz + f, src + f);
  const unsigned char* msrc = r_mask + base;
  const int nm16 = n >> 4;
  for (int c = threadIdx.x; c < nm16; c += kThreads) cp_async16(m + 16 * c, msrc + 16 * c);
  for (int j = 16 * nm16 + threadIdx.x; j < n; j += kThreads) m[j] = msrc[j];
  cp_async_commit();
}

// (d, i) < (e, j) in the order the result is defined by
__device__ __forceinline__ bool lex_less(float d, int i, float e, int j) {
  return d < e || (d == e && i < j);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
knn_kernel(const float* __restrict__ q, const float* __restrict__ r,
           const unsigned char* __restrict__ r_mask, float* __restrict__ out_d,
           long long* __restrict__ out_i, int nq, int nr, int lanes) {
  __shared__ __align__(16) float raw_xyz[2][3 * kTile];
  __shared__ __align__(16) unsigned char raw_m[2][kTile];
  __shared__ float4 cmp[kTile];
  __shared__ unsigned valid_bits[kTile / 32];
  __shared__ int warp_base[kTile / 32];
  __shared__ int n_valid;

  const int lane_s = threadIdx.x & (lanes - 1);
  const long long qi = ((long long)blockIdx.x * kThreads + threadIdx.x) / lanes;
  const bool active = qi < nq;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = q[3 * qi + 0];
    qy = q[3 * qi + 1];
    qz = q[3 * qi + 2];
  }
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = kBig;
    bi[s] = 0;
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = kThreads >> 5;
  const int n_tiles = (nr + kTile - 1) / kTile;
  stage_tile(raw_xyz[0], raw_m[0], r, r_mask, 0, min(kTile, nr));

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    const long long base = (long long)t * kTile;
    const int n = (int)min((long long)kTile, nr - base);
    cp_async_wait_all();
    __syncthreads();  // tile t has landed; the walk of tile t-1 is over
    if (t + 1 < n_tiles) {
      const long long nb = base + kTile;
      stage_tile(raw_xyz[buf ^ 1], raw_m[buf ^ 1], r, r_mask, nb,
                 (int)min((long long)kTile, nr - nb));
    }

    // compaction, pass 1: valid bits and count of every 32-reference chunk
    const unsigned char* m = raw_m[buf];
    for (int c = warp; c < kTile / 32; c += n_warps) {
      const int j = 32 * c + lane;
      const unsigned bal = __ballot_sync(0xffffffffu, j < n && m[j] != 0);
      if (lane == 0) {
        valid_bits[c] = bal;
        warp_base[c] = __popc(bal);
      }
    }
    __syncthreads();
    // exclusive prefix over the kTile/32 chunk counts, by warp 0
    if (warp == 0) {
      int carry = 0;
      for (int c0 = 0; c0 < kTile / 32; c0 += 32) {
        const int v = warp_base[c0 + lane];
        int incl = v;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int o = __shfl_up_sync(0xffffffffu, incl, off);
          if (lane >= off) incl += o;
        }
        warp_base[c0 + lane] = carry + incl - v;
        carry += __shfl_sync(0xffffffffu, incl, 31);
      }
      if (lane == 0) n_valid = carry;
    }
    __syncthreads();
    // pass 2: every valid reference to its rank, in ascending index order
    const float* xyz = raw_xyz[buf];
    for (int c = warp; c < kTile / 32; c += n_warps) {
      const int j = 32 * c + lane;
      const unsigned bal = valid_bits[c];
      if ((bal >> lane) & 1u) {
        const int pos = warp_base[c] + __popc(bal & ((1u << lane) - 1u));
        cmp[pos] = make_float4(xyz[3 * j], xyz[3 * j + 1], xyz[3 * j + 2],
                               __int_as_float((int)(base + j)));
      }
    }
    __syncthreads();

    // the walk: lane s of a query takes valid references s, s+S, ...
    if (active) {
      const int nv = n_valid;
#pragma unroll 4
      for (int p = lane_s; p < nv; p += lanes) {
        const float4 c = cmp[p];
        const float dx = qx - c.x, dy = qy - c.y, dz = qz - c.z;
        const float d = dx * dx + dy * dy + dz * dz;
        if (d < bd[K - 1]) {
          bd[K - 1] = d;
          bi[K - 1] = __float_as_int(c.w);
#pragma unroll
          for (int s = K - 1; s > 0; --s) {
            if (bd[s] < bd[s - 1]) {
              const float td = bd[s]; bd[s] = bd[s - 1]; bd[s - 1] = td;
              const int ti = bi[s]; bi[s] = bi[s - 1]; bi[s - 1] = ti;
            }
          }
        }
      }
    }
  }

  // merge the S lists of a query: after the round of offset o, every lane
  // holds the best K of its 2o-lane group, in (d2, index) order. Each round
  // is the first step of a bitonic merge (slot i keeps the lesser of its own
  // i-th and the partner's (P-1-i)-th entry: the P least of both lists, as a
  // bitonic sequence) and a bitonic sort of that, P = K rounded up to a power
  // of two, the slots past K empty.
  constexpr int P = K <= 1 ? 1 : K <= 2 ? 2 : K <= 4 ? 4 : 8;
  for (int off = 1; off < lanes; off <<= 1) {
    float md[P];
    int mi[P];
#pragma unroll
    for (int s = 0; s < P; ++s) {
      md[s] = s < K ? bd[s] : kBig;
      mi[s] = s < K ? bi[s] : 0;
    }
#pragma unroll
    for (int s = 0; s < P; ++s) {
      const int o = P - 1 - s;
      const float od = __shfl_xor_sync(0xffffffffu, o < K ? bd[o] : kBig, off);
      const int oi = __shfl_xor_sync(0xffffffffu, o < K ? bi[o] : 0, off);
      if (lex_less(od, oi, md[s], mi[s])) {
        md[s] = od;
        mi[s] = oi;
      }
    }
#pragma unroll
    for (int j = P / 2; j > 0; j >>= 1) {
#pragma unroll
      for (int s = 0; s < P; ++s) {
        if ((s & j) == 0 && lex_less(md[s + j], mi[s + j], md[s], mi[s])) {
          const float td = md[s]; md[s] = md[s + j]; md[s + j] = td;
          const int ti = mi[s]; mi[s] = mi[s + j]; mi[s + j] = ti;
        }
      }
    }
#pragma unroll
    for (int s = 0; s < K; ++s) {
      bd[s] = md[s];
      bi[s] = mi[s];
    }
  }

  if (active) {
    // every lane of the query holds the merged list; lane s writes slots
    // s, s+S, ...
#pragma unroll
    for (int s = 0; s < K; ++s) {
      if ((s & (lanes - 1)) == lane_s) {
        out_d[qi * K + s] = bd[s];
        out_i[qi * K + s] = (long long)bi[s];
      }
    }
  }
}

template <int K>
void launch(const float* q, const float* r, const unsigned char* m, float* d,
            long long* i, int nq, int nr, int lanes, cudaStream_t stream) {
  const long long blocks = ((long long)nq * lanes + kThreads - 1) / kThreads;
  knn_kernel<K><<<(unsigned)blocks, kThreads, 0, stream>>>(q, r, m, d, i, nq, nr, lanes);
}

}  // namespace

// lanes: lanes per query, a power of two in [8, 32], chosen from Nq by the
// wrapper (ops/hopper_knn.py).
extern "C" int mloam_knn(const float* q, const float* r, const unsigned char* r_mask,
                         float* out_d, long long* out_i, int nq, int nr, int k,
                         int lanes, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (lanes < 8 || lanes > 32 || (lanes & (lanes - 1)) != 0 || nq < 1 || nr < 1 ||
      (reinterpret_cast<uintptr_t>(r) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(r_mask) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  switch (k) {
    case 1: launch<1>(q, r, r_mask, out_d, out_i, nq, nr, lanes, stream); break;
    case 2: launch<2>(q, r, r_mask, out_d, out_i, nq, nr, lanes, stream); break;
    case 3: launch<3>(q, r, r_mask, out_d, out_i, nq, nr, lanes, stream); break;
    case 4: launch<4>(q, r, r_mask, out_d, out_i, nq, nr, lanes, stream); break;
    case 5: launch<5>(q, r, r_mask, out_d, out_i, nq, nr, lanes, stream); break;
    case 6: launch<6>(q, r, r_mask, out_d, out_i, nq, nr, lanes, stream); break;
    case 7: launch<7>(q, r, r_mask, out_d, out_i, nq, nr, lanes, stream); break;
    case 8: launch<8>(q, r, r_mask, out_d, out_i, nq, nr, lanes, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
