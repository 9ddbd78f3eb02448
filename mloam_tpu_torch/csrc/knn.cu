// Fused brute-force k-nearest-neighbour search over 3-D points, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel mloam_tpu/ops/pallas_knn.py:_lane_bucket_kernel
// (entry knn_pallas): for every query the k nearest unmasked reference
// points, squared distance ascending plus index, with the distance tile
// formed and reduced on chip and never written to device memory. Unlike the
// TPU kernel, which is exact only for k = 1, this one is exact for every
// k <= 8.
//
// What bounds it on this card: operations. Every (query, reference) pair
// costs three subtractions, three multiply-adds and one compare on the CUDA
// cores, while the bytes are the two point sets read once and k results per
// query. 3-wide dot products give the tensor cores nothing, and the
// ||q||^2 + ||r||^2 - 2 q.r expansion that would feed them cancels at LiDAR
// ranges, so the distance is taken directly as
// (qx-rx)^2 + (qy-ry)^2 + (qz-rz)^2 — no recentring needed.
//
// Design: one query per thread with its k best in a sorted register list
// (insertion is fully unrolled by the K template parameter, so the list
// never spills to local memory); the reference set streams through shared
// memory in tiles of float4 (x, y, z, valid), staged cooperatively by the
// block, one pass per query block. Ties go to the lowest index: references
// are visited in ascending order and a newcomer only passes strictly
// greater distances. Slots that find no unmasked reference keep d2 = 1e30
// and index 0.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;   // queries per block
constexpr int kTile = 1024;    // reference points per shared-memory tile
constexpr float kBig = 1e30f;

template <int K>
__global__ void __launch_bounds__(kThreads)
knn_kernel(const float* __restrict__ q, const float* __restrict__ r,
           const unsigned char* __restrict__ r_mask, float* __restrict__ out_d,
           long long* __restrict__ out_i, int nq, int nr) {
  __shared__ float4 tile[kTile];
  const int qi = blockIdx.x * kThreads + threadIdx.x;
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

  for (int base = 0; base < nr; base += kTile) {
    const int n = min(kTile, nr - base);
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const int g = base + j;
      tile[j] = make_float4(r[3 * g + 0], r[3 * g + 1], r[3 * g + 2],
                            r_mask[g] ? 1.f : 0.f);
    }
    __syncthreads();
    if (active) {
      for (int j = 0; j < n; ++j) {
        const float4 p = tile[j];
        const float dx = qx - p.x, dy = qy - p.y, dz = qz - p.z;
        const float d = (p.w != 0.f) ? (dx * dx + dy * dy + dz * dz) : kBig;
        if (d < bd[K - 1]) {
          bd[K - 1] = d;
          bi[K - 1] = base + j;
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
    __syncthreads();
  }

  if (active) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      out_d[(size_t)qi * K + s] = bd[s];
      out_i[(size_t)qi * K + s] = (long long)bi[s];
    }
  }
}

template <int K>
void launch(const float* q, const float* r, const unsigned char* m, float* d,
            long long* i, int nq, int nr, cudaStream_t stream) {
  const int blocks = (nq + kThreads - 1) / kThreads;
  knn_kernel<K><<<blocks, kThreads, 0, stream>>>(q, r, m, d, i, nq, nr);
}

}  // namespace

extern "C" int mloam_knn(const float* q, const float* r, const unsigned char* r_mask,
                         float* out_d, long long* out_i, int nq, int nr, int k,
                         void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  switch (k) {
    case 1: launch<1>(q, r, r_mask, out_d, out_i, nq, nr, stream); break;
    case 2: launch<2>(q, r, r_mask, out_d, out_i, nq, nr, stream); break;
    case 3: launch<3>(q, r, r_mask, out_d, out_i, nq, nr, stream); break;
    case 4: launch<4>(q, r, r_mask, out_d, out_i, nq, nr, stream); break;
    case 5: launch<5>(q, r, r_mask, out_d, out_i, nq, nr, stream); break;
    case 6: launch<6>(q, r, r_mask, out_d, out_i, nq, nr, stream); break;
    case 7: launch<7>(q, r, r_mask, out_d, out_i, nq, nr, stream); break;
    case 8: launch<8>(q, r, r_mask, out_d, out_i, nq, nr, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
