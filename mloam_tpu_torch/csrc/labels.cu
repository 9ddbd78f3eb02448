// Connected-component label propagation on a LiDAR range image, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel mloam_tpu/ops/pallas_labels.py:_label_kernel
// (entry propagate_labels_pallas). Same contract: labels int32 [R, C] in
// linear-pixel-index space (non-clusterable = R*C); conn_h[r, c] says column
// c is connected to column c-1, with conn_h[r, 0] carrying the azimuth wrap
// flag (C-1 <-> 0); conn_v[r, c] says row r is connected to row r-1. Each
// round is {row segmented-min, seam stitch, row segmented-min, column
// segmented-min}; column 0 is a run boundary for the row scans, the seam is
// crossed only by the stitch.
//
// What bounds it on this card: the whole image is a few hundred KB, so the
// bytes take well under a microsecond and the cost is launches. The design
// therefore spends one launch on everything that is independent per row
// (scan, stitch, scan: one block per row, the row resident in shared
// memory) and one on what is independent per column (one thread per column
// walking the R rows through L2-resident global memory): 2*rounds launches,
// no padding, no rolls, any R and any C whose row fits in shared memory.
// Both kernels work in place on the output buffer: a block touches only its
// own row, a thread only its own column. From the second round on the row
// kernel reads and writes the same buffer, so its label pointers are not
// declared __restrict__. The entry point counts the launches it issues and
// hands the count back, so the caller's launch counter is a reading.
//
// A segmented min over runs is not done by log-doubling here. The run start
// of every cell is a max-scan of boundary positions (computed once per
// launch, the flags do not change); every cell then folds its label into
// its run's slot with a shared-memory atomicMin and reads the slot back.

#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int kRowThreads = 256;
constexpr int kColThreads = 128;

// One bidirectional segmented min over the runs of a row held in shared
// memory. Each thread owns a contiguous chunk [lo, hi): it folds its cells
// into a local minimum while the run stays the same and issues one atomicMin
// per (thread, run) pair.
__device__ __forceinline__ void row_runs_min(int* lab, const int* start,
                                             int* runmin, int lo, int hi) {
  for (int c = lo; c < hi; ++c) runmin[c] = INT_MAX;
  __syncthreads();
  if (lo < hi) {
    int s = start[lo];
    int m = lab[lo];
    for (int c = lo + 1; c < hi; ++c) {
      int sc = start[c];
      if (sc != s) {
        atomicMin(&runmin[s], m);
        s = sc;
        m = lab[c];
      } else {
        m = min(m, lab[c]);
      }
    }
    atomicMin(&runmin[s], m);
  }
  __syncthreads();
  for (int c = lo; c < hi; ++c) lab[c] = runmin[start[c]];
  __syncthreads();
}

__global__ void __launch_bounds__(kRowThreads)
row_phase_kernel(const int* in, int* out,
                 const unsigned char* __restrict__ conn_h, int C) {
  extern __shared__ int smem[];
  int* lab = smem;            // [C]
  int* start = smem + C;      // [C]
  int* runmin = smem + 2 * C; // [C]
  __shared__ int part[kRowThreads];

  const int r = blockIdx.x;
  const int t = threadIdx.x;
  const int per = (C + kRowThreads - 1) / kRowThreads;
  const int lo = min(t * per, C);
  const int hi = min(lo + per, C);
  const int* in_row = in + (size_t)r * C;
  const unsigned char* ch = conn_h + (size_t)r * C;

  // run starts: inclusive max-scan of boundary positions. Column 0 is always
  // a boundary (its flag is the wrap flag, used by the stitch only).
  int local = -1;
  for (int c = lo; c < hi; ++c) {
    lab[c] = in_row[c];
    if (c == 0 || ch[c] == 0) local = c;
    start[c] = local;  // -1 = no boundary yet inside this chunk
  }
  part[t] = local;
  __syncthreads();
  // Hillis-Steele inclusive max-scan over the per-thread maxima
  for (int off = 1; off < kRowThreads; off <<= 1) {
    int v = part[t];
    if (t >= off) v = max(v, part[t - off]);
    __syncthreads();
    part[t] = v;
    __syncthreads();
  }
  const int carry = (t > 0) ? part[t - 1] : -1;
  for (int c = lo; c < hi; ++c) {
    if (start[c] < 0) start[c] = carry;
  }
  __syncthreads();

  row_runs_min(lab, start, runmin, lo, hi);
  if (t == 0 && ch[0] != 0) {
    // exchange minima across the azimuth seam
    int m = min(lab[0], lab[C - 1]);
    lab[0] = m;
    lab[C - 1] = m;
  }
  __syncthreads();
  row_runs_min(lab, start, runmin, lo, hi);

  int* out_row = out + (size_t)r * C;
  for (int c = lo; c < hi; ++c) out_row[c] = lab[c];
}

__global__ void __launch_bounds__(kColThreads)
col_phase_kernel(int* lab, const unsigned char* __restrict__ conn_v,
                 int R, int C) {
  const int c = blockIdx.x * kColThreads + threadIdx.x;
  if (c >= C) return;
  // forward: running min since the run's first row; at a run's last row this
  // is the min of the whole run
  int m = 0;
  for (int r = 0; r < R; ++r) {
    const size_t i = (size_t)r * C + c;
    const int v = lab[i];
    m = (r == 0 || conn_v[i] == 0) ? v : min(m, v);
    lab[i] = m;
  }
  // backward: pick the run's min up at its last row and carry it down
  for (int r = R - 1; r >= 0; --r) {
    const size_t i = (size_t)r * C + c;
    const bool run_end = (r == R - 1) || (conn_v[i + C] == 0);
    if (run_end) m = lab[i];
    lab[i] = m;
  }
}

}  // namespace

extern "C" int mloam_propagate_labels(const int* labels, const unsigned char* conn_h,
                                      const unsigned char* conn_v, int* out,
                                      int R, int C, int rounds, void* stream_ptr,
                                      int* n_launched) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  *n_launched = 0;
  const size_t smem = (size_t)3 * C * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        row_phase_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int col_blocks = (C + kColThreads - 1) / kColThreads;
  for (int i = 0; i < rounds; ++i) {
    row_phase_kernel<<<R, kRowThreads, smem, stream>>>(i == 0 ? labels : out, out,
                                                       conn_h, C);
    ++*n_launched;
    col_phase_kernel<<<col_blocks, kColThreads, 0, stream>>>(out, conn_v, R, C);
    ++*n_launched;
  }
  return (int)cudaGetLastError();
}
