// Connected-component label propagation on a LiDAR range image, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel mloam_tpu/ops/pallas_labels.py:_label_kernel
// (entry propagate_labels_pallas). Same contract: labels int32 [R, C] in
// linear-pixel-index space (non-clusterable = R*C), or a batch [N, R, C] of
// such images, each in its own index space (the kernel under jax.vmap, as
// the JAX package's batched rig frontend runs it); conn_h[r, c] says column
// c is connected to column c-1, with conn_h[r, 0] carrying the azimuth wrap
// flag (C-1 <-> 0); conn_v[r, c] says row r is connected to row r-1. Each
// round is {row segmented-min, seam stitch, row segmented-min, column
// segmented-min}; column 0 is a run boundary for the row scans, the seam is
// crossed only by the stitch. The result is integer-exact.
//
// What bounds it on this card: the image is a few hundred KB, so its bytes
// take well under a microsecond and the cost is launches and barriers. The
// first design spent two launches a round (a block per row for scan, stitch
// and scan; a thread per column walking the R rows through device memory for
// the column scan): 6 launches for 3 rounds, ~0.058 ms, ~45 us of host time
// each. The TPU kernel is one dispatch.
//
// This design is one launch for all rounds and all images: a thread-block
// cluster of B = min(R, 8) blocks (a portable cluster size) per image, the
// images along the grid's y axis (a grid of B x N blocks), launched with
// cudaLaunchKernelEx. The clusters share nothing: the cluster at
// blockIdx.y labels image blockIdx.y. Block b of a cluster holds rows
// [b*ceil(R/B), (b+1)*ceil(R/B)) of its image in shared memory for the whole
// call (labels int32, conn_h and conn_v bytes, run starts int16), so each
// image is read from device memory once and written once.
//  * Row phases on shared memory, all rows of the block at once: the block's
//    rows are one flat array whose run starts (column 0 or conn_h == 0) are
//    a max-scan computed once per call. A segmented min folds each thread's
//    cells per run and does one atomicMin into the run's first cell; every
//    cell then reads its run's first cell back. Both in place: only a run's
//    own values ever reach its first cell. After that scan every run is
//    uniform, so the seam stitch and the second scan come down to one pass
//    that lowers a wrapped row's first and last runs to the lesser of their
//    two minima.
//  * Column phase in two levels. Within the block a thread per column runs
//    over the block's <= 8 rows. Across blocks each block publishes, per
//    column, the min of its first and of its last vertical run and whether
//    its rows hold a run boundary or link up to the block above; after a
//    cluster barrier every block reads the others' partials through
//    distributed shared memory (cluster.map_shared_rank), folds the carry
//    from above and from below into its first and last runs, and fixes its
//    own rows. A second barrier keeps the partials alive until all are read.
// An image whose block does not fit in shared memory is refused by the
// wrapper before the launch (ops/hopper_labels.py).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxCluster = 8;
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use on sm_90
constexpr int kMaxImages = 65535;  // the grid's y extent
constexpr int kHasBoundary = 1;  // a run boundary inside the block's rows
constexpr int kLinkedUp = 2;     // the block's first row joins the row above

struct Layout {
  int rows;  // rows per block, ceil(R / B)
  size_t lab, partial, carry, scan, seam, start, ch, cv, total;
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

__host__ __device__ inline Layout layout(int R, int C) {
  const int B = R < kMaxCluster ? R : kMaxCluster;
  Layout L;
  L.rows = (R + B - 1) / B;
  const size_t n = (size_t)L.rows * C;
  L.lab = 0;
  L.partial = align16(L.lab + 4 * n);
  L.carry = L.partial + 16 * (size_t)C;
  L.scan = L.carry + 8 * (size_t)C;
  L.seam = L.scan + 4 * (size_t)kThreads;
  L.start = L.seam + 4 * (size_t)L.rows;
  L.ch = align16(L.start + 2 * n);
  L.cv = L.ch + n;
  L.total = align16(L.cv + n);
  return L;
}

// One segmented min over the runs of the block's rows, in place: thread t
// owns cells [lo, hi) of the flat array; the run of flat cell i starts at
// (i / C) * C + start[i] (the row's first cell is tracked, not divided for).
__device__ __forceinline__ void runs_min(int* lab, const short* start, int C,
                                         int lo, int hi) {
  if (lo < hi) {
    int row = (lo / C) * C;
    int s = row + start[lo];
    int m = lab[lo];
    for (int i = lo + 1; i < hi; ++i) {
      if (i == row + C) row += C;
      const int si = row + start[i];
      if (si != s) {
        atomicMin(&lab[s], m);
        s = si;
        m = lab[i];
      } else {
        m = min(m, lab[i]);
      }
    }
    atomicMin(&lab[s], m);
  }
  __syncthreads();
  if (lo < hi) {
    int row = (lo / C) * C;
    for (int i = lo; i < hi; ++i) {
      if (i == row + C) row += C;
      lab[i] = lab[row + start[i]];
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
label_kernel(const int* __restrict__ labels, const unsigned char* __restrict__ conn_h,
             const unsigned char* __restrict__ conn_v, int* __restrict__ out,
             int R, int C, int rounds) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int B = (int)cluster.num_blocks();
  const int b = (int)cluster.block_rank();
  const Layout L = layout(R, C);
  int* lab = reinterpret_cast<int*>(smem + L.lab);
  // per column: (min of the first vertical run, min of the last, flags, -)
  int4* partial = reinterpret_cast<int4*>(smem + L.partial);
  // per column: (carry into the first run from above, into the last from below)
  int2* carry_in = reinterpret_cast<int2*>(smem + L.carry);
  int* part = reinterpret_cast<int*>(smem + L.scan);
  int* seam = reinterpret_cast<int*>(smem + L.seam);
  short* start = reinterpret_cast<short*>(smem + L.start);
  unsigned char* ch = smem + L.ch;
  unsigned char* cv = smem + L.cv;

  const int t = threadIdx.x;
  const int row0 = b * L.rows;
  const int nrows = max(0, min(L.rows, R - row0));  // the last blocks may hold fewer, or none
  const int n = nrows * C;
  // this image's first cell in the batch, then the block's first row in it
  const size_t g0 = (size_t)blockIdx.y * R * C + (size_t)row0 * C;
  for (int i = t; i < n; i += kThreads) {
    lab[i] = labels[g0 + i];
    ch[i] = conn_h[g0 + i];
    cv[i] = conn_v[g0 + i];
  }
  __syncthreads();

  // run starts of the row scans: inclusive max-scan of boundary positions.
  // Column 0 is always a boundary, so a run never crosses into another row.
  const int per = (n + kThreads - 1) / kThreads;
  const int lo = min(t * per, n);
  const int hi = min(lo + per, n);
  int local = -1;
  for (int i = lo; i < hi; ++i) {
    if (i % C == 0 || ch[i] == 0) local = i;
    start[i] = (short)(local < 0 ? -1 : local % C);
  }
  part[t] = local;
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {
    int v = part[t];
    if (t >= off) v = max(v, part[t - off]);
    __syncthreads();
    part[t] = v;
    __syncthreads();
  }
  const int carry = t > 0 ? part[t - 1] : -1;
  for (int i = lo; i < hi; ++i)
    if (start[i] < 0) start[i] = (short)(carry % C);
  __syncthreads();

  for (int round = 0; round < rounds; ++round) {
    // ---- rows: scan, seam stitch, scan. After the first scan every run
    // holds its minimum, so the stitch and the second scan change only a
    // wrapped row's first and last runs: both take the lesser of their two
    // minima, which is what the second scan would spread.
    runs_min(lab, start, C, lo, hi);
    for (int r = t; r < nrows; r += kThreads)
      seam[r] = ch[r * C] != 0 ? min(lab[r * C], lab[r * C + C - 1]) : INT_MAX;
    __syncthreads();
    if (lo < hi) {
      int r = lo / C;
      for (int i = lo; i < hi; ++i) {
        if (i == (r + 1) * C) ++r;
        const int s = start[i];
        if (seam[r] != INT_MAX && (s == 0 || s == start[r * C + C - 1]))
          lab[i] = min(lab[i], seam[r]);
      }
    }
    __syncthreads();

    // ---- columns, level 1: the block's own rows; publish the partials
    for (int c = t; c < C; c += kThreads) {
      int f = 0;
      int m = INT_MAX;
      for (int r = 0; r < nrows; ++r) {  // forward: running min since the run's first row
        const int i = r * C + c;
        const bool head = r == 0 || cv[i] == 0;
        if (r > 0 && head) f |= kHasBoundary;
        m = head ? lab[i] : min(m, lab[i]);
        lab[i] = m;
      }
      const int bot = m;
      for (int r = nrows - 1; r >= 0; --r) {  // backward: the run's min at its last row, carried up
        const int i = r * C + c;
        if (r < nrows - 1 && cv[i + C] == 0) m = lab[i];
        lab[i] = m;
      }
      if (nrows == 0) f = kHasBoundary;
      else if (row0 > 0 && cv[c] != 0) f |= kLinkedUp;
      partial[c] = make_int4(m, bot, f, 0);
    }
    cluster.sync();

    // ---- columns, level 2. Block b owns the columns [b*cs, (b+1)*cs): it
    // loads their partials from every block of the cluster, scans them down
    // and up the blocks in registers (the loops unroll over kMaxCluster) and
    // writes each block the carries into its first and last run.
    const int cs = (C + B - 1) / B;
    for (int c = b * cs + t; c < min(C, (b + 1) * cs); c += kThreads) {
      int4 pj[kMaxCluster];
#pragma unroll
      for (int j = 0; j < kMaxCluster; ++j)
        if (j < B) pj[j] = *cluster.map_shared_rank(partial + c, j);
      int up[kMaxCluster];
      int flow = INT_MAX;  // the min of the run that leaves block j-1 at its last row
#pragma unroll
      for (int j = 0; j < kMaxCluster; ++j) {
        if (j < B) {
          up[j] = (pj[j].z & kLinkedUp) ? flow : INT_MAX;
          flow = (pj[j].z & kHasBoundary) ? pj[j].y : min(pj[j].y, up[j]);
        }
      }
      flow = INT_MAX;  // the min of the run that leaves block j+1 at its first row
#pragma unroll
      for (int j = kMaxCluster - 1; j >= 0; --j) {
        if (j < B) {
          *cluster.map_shared_rank(carry_in + c, j) = make_int2(up[j], flow);
          flow = !(pj[j].z & kLinkedUp) ? INT_MAX
                 : (pj[j].z & kHasBoundary) ? pj[j].x : min(pj[j].x, flow);
        }
      }
    }
    cluster.sync();  // the carries have arrived; the partials may change again

    for (int c = t; c < C && nrows > 0; c += kThreads) {
      const int f = partial[c].z;
      const int2 in = carry_in[c];
      if (!(f & kHasBoundary)) {  // one run through the block's rows
        const int m = min(in.x, in.y);
        for (int r = 0; r < nrows; ++r) lab[r * C + c] = min(lab[r * C + c], m);
      } else {
        for (int r = 0; r < nrows && (r == 0 || cv[r * C + c] != 0); ++r)
          lab[r * C + c] = min(lab[r * C + c], in.x);
        for (int r = nrows - 1; r >= 0; --r) {
          lab[r * C + c] = min(lab[r * C + c], in.y);
          if (cv[r * C + c] == 0) break;
        }
      }
    }
    __syncthreads();
  }

  for (int i = t; i < n; i += kThreads) out[g0 + i] = lab[i];
}

}  // namespace

// The shared memory a block of the R x C image needs, in bytes; the wrapper
// refuses an image above kMaxSmem before it calls the entry below.
extern "C" long long mloam_labels_smem_bytes(int R, int C) {
  return (long long)layout(R, C).total;
}

// n_images images of R x C, one after another, in one launch.
extern "C" int mloam_propagate_labels(const int* labels, const unsigned char* conn_h,
                                      const unsigned char* conn_v, int* out,
                                      int n_images, int R, int C, int rounds,
                                      void* stream_ptr, int* n_launched) {
  // the shared-memory limit is an attribute of the kernel on each device: set
  // it at the first call on each device the entry runs on
  constexpr int kMaxDevices = 64;
  static bool attribute_set[kMaxDevices] = {};
  *n_launched = 0;
  if (n_images < 1 || n_images > kMaxImages || R < 1 || C < 1 || C > SHRT_MAX ||
      rounds < 1)
    return (int)cudaErrorInvalidValue;
  const Layout L = layout(R, C);
  if (L.total > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  int dev = 0;
  const cudaError_t de = cudaGetDevice(&dev);
  if (de != cudaSuccess) return (int)de;
  if (dev >= kMaxDevices || !attribute_set[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        label_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return (int)e;
    if (dev < kMaxDevices) attribute_set[dev] = true;
  }
  const int B = R < kMaxCluster ? R : kMaxCluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B, n_images, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = static_cast<cudaStream_t>(stream_ptr);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = B;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, label_kernel, labels, conn_h, conn_v,
                                           out, R, C, rounds);
  ++*n_launched;
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
