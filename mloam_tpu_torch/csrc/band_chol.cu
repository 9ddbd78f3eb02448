// Cholesky solve of a symmetric positive definite band system, for Hopper
// (sm_90a): the pose graph's damped normal equations in a fill-reducing
// order (parallel/sharded_pgo.pgo_step, through ops/hopper_band_chol.py).
//
// Replaces no TPU kernel. The JAX package factors the dense [6n, 6n] Hessian
// (jnp.linalg.cholesky); on a drive's graph, after a reverse Cuthill-McKee
// order of the poses, every nonzero of it lies within b = 6 h + 5 scalars of
// the diagonal (h the half-bandwidth in poses: 17 on KITTI 00's 4541-pose
// loop graph, b = 107). This kernel factors that band and solves with it:
// in one launch it gathers g into the band's order, factors A = L L^T in
// place with the forward substitution L y = g riding along, runs the
// backward substitution L^T x = y and scatters x back to pose order. It
// returns info: 1 + the first column whose pivot is not positive or not
// finite, else 0.
//
// What bounds it on this card: latency, then the one SM's shared memory.
// The band of KITTI 00 is 27246 x 108 floats (11.8 MB); its factorisation is
// about 3.3e8 flop, a few microseconds of the card's f32 rate or of its
// bandwidth, but the 27246 pivots form one dependent chain (each pivot needs
// the column before it), so one block walks the diagonal, and its trailing
// updates run on that block's SM, bound by its shared memory's 128 bytes a
// cycle. float32 throughout, on the CUDA cores: no tensor cores (TF32 is
// below the precision asked for).
//
// The design, one block of 256 threads:
//  * The diagonal is walked in panels of kPanel = 32 columns, the width of a
//    warp. The rows that a panel touches, [k, k + 32 + b), are held in
//    shared memory as a window of band rows (row r, column d = A[r, r - d],
//    then a panel's width of zeros) in a ring of (groups + 1) groups of 32
//    rows, copied in with cp.async (16 bytes where b + 1 is a multiple of
//    4) a panel ahead, and written back to the band in device memory when
//    final.
//  * A panel's 32 x 32 diagonal block is factored by warp 0, a lane a row,
//    its entries in registers: each column's pivot is a shuffle from the
//    lane that owns it, whose next pivot is updated first and kept apart, so
//    the chain per column is one shuffle, rsqrt with a Newton step, one
//    multiply and one fused multiply-add, with no barrier.
//  * The b rows below the block, and g as one more row (so the forward
//    substitution L y = g rides along), then solve against it, a thread a
//    row, all at once.
//  * Trailing update: the b x b triangle below the panel (and g's b entries)
//    less the panel's rank-32 product, in 4 x 4 register tiles read from
//    the panel's transposed copy as float4, each sum over the 32 columns in
//    a fixed order of fused multiply-adds. Look-ahead: the tiles of the
//    next panel's diagonal block go first; then warp 0 factors that block
//    (into the other of two copies of the panel's columns) while the other
//    seven warps update the rest, write the finished rows out and copy the
//    next group in. Three barriers a panel.
//  * Backward substitution: the factor's panels are read back (cp.async,
//    one panel ahead, with the right-hand sides the next panel adds) from
//    the last to the first; one warp solves the panel's triangle with
//    shuffles, then the block subtracts the panel's contribution from the
//    right-hand sides of the b rows above it (a ring in shared memory).
// Every sum has a fixed order and nothing is atomic, so two calls give the
// same bits. No allocation, no synchronisation with the host; rows past the
// matrix's end are taken as identity rows. Conditional loads and updates in
// the unrolled loops are written as selects, not branches: as branches they
// cost several times their work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPanel = 32;      // columns a panel: a warp (ops/hopper_band_chol.PANEL)
constexpr int kThreads = 256;   // one block (THREADS)
constexpr int kRing = 256;      // backward right-hand sides (RING)
constexpr int kLd = kThreads;   // stride of the panel's transposed columns
constexpr int kMaxSmem = 232448;
constexpr unsigned kFull = 0xffffffffu;

// Shared-memory layout at bandwidth b (ops/hopper_band_chol.smem_bytes): two
// panels' columns transposed [2][kPanel][kLd], their inverse pivots
// [2][kPanel], info, the window's right-hand sides [w], the window's rows
// [w][rsp]. A
// window row holds its band row (d = 0 .. b) and kPanel zeros after it, so
// that a thread reads its panel entries at d = t - c without bounds: d > b
// reads a zero, d < 0 (right of the diagonal, never used) the row before.
struct Layout {
  int b, rsp, groups, w;
  __host__ __device__ explicit Layout(int b_)
      : b(b_), rsp(b_ + 1 + kPanel), groups(1 + (b_ + kPanel - 1) / kPanel),
        w((groups + 1) * kPanel) {}
  __host__ __device__ int floats() const {
    return 2 * kPanel * kLd + 2 * kPanel + 4 + w + w * rsp;
  }
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The window slot of row k + i from k's slot kw (kw + i < 2 w): a ring of w rows.
__device__ __forceinline__ int slot(int i, int w) { return i < w ? i : i - w; }

// 1 / sqrt(v): the hardware's approximation and one Newton step
__device__ __forceinline__ float inv_sqrt(float v) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r * fmaf(-0.5f * v * r, r, 1.5f);
}

// Start copying band rows [r0, r0 + kPanel), kPanel (b + 1) contiguous
// floats, into dst (rows of stride rsp), by the threads from ``first`` on,
// V floats a copy (the rows are 4 V-byte aligned where V divides b + 1);
// rows past the matrix become identity rows.
template <int V>
__device__ void load_rows_v(const float* band, float* dst, const Layout& L, int n_rows,
                            int r0, int first) {
  const int t = threadIdx.x - first;
  if (t < 0) return;
  const int stride = kThreads - first, w = (L.b + 1) / V;  // copies a row
  const int real = max(0, min(kPanel, n_rows - r0)) * w;
  const float* src = band + static_cast<size_t>(r0) * (L.b + 1);
  int i = t / w, d = t - (t / w) * w;  // copy e = i w + d of the chunk
  for (int e = t; e < kPanel * w; e += stride) {
    float* to = dst + i * L.rsp + V * d;
    if (e < real) {
      if (V == 4)
        cp_async16(to, src + V * e);
      else
        cp_async4(to, src + e);
    } else {
      for (int v = 0; v < V; ++v) to[v] = d == 0 && v == 0 ? 1.f : 0.f;
    }
    for (d += stride; d >= w; d -= w) ++i;
  }
}

__device__ void load_rows(const float* band, float* dst, const Layout& L, int n_rows,
                          int r0, int first) {
  if ((L.b + 1) % 4 == 0)
    load_rows_v<4>(band, dst, L, n_rows, r0, first);
  else
    load_rows_v<1>(band, dst, L, n_rows, r0, first);
}

// Write window rows src (stride rsp) to band rows [r0, r0 + n), by the
// threads from ``first`` on, V floats a store (4 V-byte aligned where V
// divides b + 1).
template <int V>
__device__ void store_rows_v(float* band, const float* src, const Layout& L, int n, int r0,
                             int first) {
  const int t = threadIdx.x - first;
  if (t < 0) return;
  const int stride = kThreads - first, w = (L.b + 1) / V;
  float* dst = band + static_cast<size_t>(r0) * (L.b + 1);
  int i = t / w, d = t - (t / w) * w;
  for (int e = t; e < n * w; e += stride) {
    if (V == 4)
      reinterpret_cast<float4*>(dst)[e] = *reinterpret_cast<const float4*>(src + i * L.rsp + 4 * d);
    else
      dst[e] = src[i * L.rsp + d];
    for (d += stride; d >= w; d -= w) ++i;
  }
}

__device__ void store_rows(float* band, const float* src, const Layout& L, int n, int r0,
                           int first) {
  if ((L.b + 1) % 4 == 0)
    store_rows_v<4>(band, src, L, n, r0, first);
  else
    store_rows_v<1>(band, src, L, n, r0, first);
}

// Start copying group r0 / kPanel into its place in the window ring, with
// g gathered into the band's order beside it, by the threads from ``first`` on.
__device__ void load_group(const float* band, const float* g, const long long* perm,
                           float* win, float* gwin, const Layout& L, int n_rows, int r0,
                           int first) {
  const int slot0 = r0 % L.w;
  load_rows(band, win + slot0 * L.rsp, L, n_rows, r0, first);
  const int i = threadIdx.x - first;
  if (i >= 0 && i < kPanel) {
    const int r = r0 + i;
    if (r < n_rows)
      cp_async4(gwin + slot0 + i, g + perm[r / 6] * 6 + r % 6);
    else
      gwin[slot0 + i] = 0.f;
  }
}

// The trailing update of a panel: window rows and columns [kPanel, kPanel +
// b) of row k's slot kw, less the panel's rank-kPanel product, and g's
// entries (row kPanel + b of lpt) likewise, on the lower triangle's 4 x 4
// tiles, a thread a tile at a time: 4 rows and 4 columns of lpt read as
// float4, the sum over the panel's columns in a fixed order of fused
// multiply-adds. ``next`` takes the tiles of rows [kPanel, 2 kPanel), the
// next panel's diagonal block, by threads 0 .. 35; else the rest, by the
// threads from 32 on.
__device__ __forceinline__ void trailing_update(const float* lpt, float* win, float* gwin,
                                               Layout L, int kw, bool next) {
  const int b = L.b;
  const int nt = (b + 1 + 3) / 4;
  const int first = kPanel / 4 * (kPanel / 4 + 1) / 2;  // the next block's tiles
  const int tiles = next ? min(first, nt * (nt + 1) / 2) : nt * (nt + 1) / 2;
  const int stride = next ? kThreads : kThreads - 32;
  for (int q = next ? threadIdx.x : first + threadIdx.x - 32; q < tiles; q += stride) {
    int R = static_cast<int>((sqrtf(8.f * q + 1.f) - 1.f) * 0.5f);
    while ((R + 1) * (R + 2) / 2 <= q) ++R;
    while (R * (R + 1) / 2 > q) --R;
    const int C = q - R * (R + 1) / 2;
    const int r0 = kPanel + 4 * R, c0 = kPanel + 4 * C;
    float acc[4][4] = {};
#pragma unroll 4
    for (int m = 0; m < kPanel; ++m) {
      const float4 u = *reinterpret_cast<const float4*>(lpt + m * kLd + r0);
      const float4 v = *reinterpret_cast<const float4*>(lpt + m * kLd + c0);
      const float uu[4] = {u.x, u.y, u.z, u.w}, vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(uu[i], vv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int tr = r0 + i;
      if (tr < kPanel + b) {
        // (right of the diagonal, tc > tr, the address would lie in the row
        // before, or before the window: no access at all)
        float* row = win + slot(kw + tr, L.w) * L.rsp;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int tc = c0 + j;
          if (tc <= tr) row[tr - tc] -= acc[i][j];
        }
      } else if (tr == kPanel + b) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int tc = c0 + j;
          if (tc < kPanel + b) gwin[slot(kw + tc, L.w)] -= acc[i][j];
        }
      }
    }
  }
}

// The diagonal block of panel k (window slot kw), by warp 0, lane = row,
// its entries in registers: each column into lpt and back into the lane's
// window row, its 1 / sqrt(pivot) into ipiv. Each column reaches the other
// lanes through lpt; nxt, the next column's diagonal entry, is updated ahead
// of the rest and its pivot shuffled from its lane. Entries of a lane right
// of its diagonal take any values: they are neither stored nor read by
// another lane.
__device__ __forceinline__ void factor_diag(float* win, float* lpt, float* ipiv, int* s_info,
                                            Layout L, int k, int kw) {
  const int lane = threadIdx.x & 31;
  float* my_row = win + slot(kw + lane, L.w) * L.rsp + lane;  // d = lane - c at -c
  float a[kPanel];
#pragma unroll
  for (int c = 0; c < kPanel; ++c) a[c] = my_row[-c];
  float nxt = a[0];
  int bad = 0;  // 1 + the first column whose pivot is not positive or not finite
#pragma unroll
  for (int c = 0; c < kPanel; ++c) {
    const float pv = __shfl_sync(kFull, nxt, c);
    const float inv = inv_sqrt(pv);
    if (bad == 0 && !(pv > 0.f && pv <= 3.4028235e38f)) bad = c + 1;
    const float l = a[c] * inv;
    a[c] = l;
    lpt[c * kLd + lane] = l;
    if (lane >= c) my_row[-c] = l;
    if (lane == 0) ipiv[c] = inv;
    if (c + 1 < kPanel) nxt = fmaf(-l, l, a[c + 1]);
    __syncwarp();
    const float4* col = reinterpret_cast<const float4*>(lpt + c * kLd);
#pragma unroll
    for (int j4 = (c + 1) / 4; j4 < kPanel / 4; ++j4) {
      const float4 v = col[j4];
      const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * j4 + e > c) a[4 * j4 + e] = fmaf(-l, vv[e], a[4 * j4 + e]);
    }
  }
  if (lane == 0 && bad && *s_info == 0) *s_info = k + bad;
}

// The rows of panel k below its diagonal block, and g as one more row, a
// thread a row (threads 32 .. 32 + b), solved against the block's columns
// (lpt, ipiv): each column into lpt and back into the window row (past the
// band, d > b, the entries are zeros and stay zeros: the row's padding), or
// g's, the forward solution L y = g, into y.
__device__ __forceinline__ void solve_below(float* win, const float* gwin, float* lpt,
                                            const float* ipiv, float* y, Layout L, int k,
                                            int kw) {
  const int t = threadIdx.x, b = L.b;
  if (t < kPanel || t > kPanel + b) return;
  const bool is_g = t == kPanel + b;
  float* my_row = win + slot(kw + min(t, kPanel + b - 1), L.w) * L.rsp + t;
  float a[kPanel];
#pragma unroll
  for (int c = 0; c < kPanel; ++c) a[c] = is_g ? gwin[kw + c] : my_row[-c];
  float* out = is_g ? y + k : my_row;
  const int step = is_g ? 1 : -1;
#pragma unroll
  for (int c = 0; c < kPanel; ++c) {
    const float l = a[c] * ipiv[c];
    a[c] = l;
    lpt[c * kLd + t] = l;
    out[step * c] = l;
    const float4* col = reinterpret_cast<const float4*>(lpt + c * kLd);
#pragma unroll
    for (int j4 = (c + 1) / 4; j4 < kPanel / 4; ++j4) {
      const float4 v = col[j4];
      const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * j4 + e > c) a[4 * j4 + e] = fmaf(-l, vv[e], a[4 * j4 + e]);
    }
  }
}

// The backward substitution L^T x = y over the factor in band (device
// memory), panels from the last; x overwrites y, in the band's order. lpt's
// and the window's shared memory are free by now.
__device__ __forceinline__ void backward(const float* band, float* y, float* lpt, float* win,
                                      Layout L, int n_rows) {
  const int t = threadIdx.x, lane = t & 31, b = L.b;
  const int n_pan = (n_rows + kPanel - 1) / kPanel;
  float* buf = win;              // [2][kPanel][rsp] factor rows, by panel parity
  float* ring = lpt;             // [kRing] right-hand sides, by row % kRing
  float* xp = lpt + kRing;       // [kPanel] the panel's solution
  {
    const int k = (n_pan - 1) * kPanel;
    load_rows(band, buf + ((n_pan - 1) & 1) * kPanel * L.rsp, L, n_rows, k, 0);
    for (int i = max(0, k - b) + t; i < n_pan * kPanel; i += kThreads) {
      if (i < n_rows)
        cp_async4(ring + i % kRing, y + i);
      else
        ring[i % kRing] = 0.f;
    }
    cp_async_commit();
  }
  for (int q = n_pan - 1; q >= 0; --q) {
    const int k = q * kPanel;
    cp_async_wait_all();
    __syncthreads();  // panel q's rows, the right-hand sides of [k - b, k + kPanel)
    if (q > 0) {
      // panel q - 1's rows and the right-hand sides it adds, [k - kPanel - b, k - b)
      load_rows(band, buf + ((q - 1) & 1) * kPanel * L.rsp, L, n_rows, k - kPanel, 32);
      const int lo = max(0, k - kPanel - b), hi = max(0, k - b);
      for (int i = lo + t - 32; i < hi; i += kThreads - 32)
        if (i >= lo) cp_async4(ring + i % kRing, y + i);
      cp_async_commit();
    }
    const float* rows = buf + (q & 1) * kPanel * L.rsp;
    if (t < 32) {
      // one warp: the panel's triangle, row kPanel - 1 first; lane = row
      float r = ring[(k + lane) % kRing];
      const float dinv = 1.f / rows[lane * L.rsp];
      float lrow[kPanel];  // L[k + i, k + lane] for i > lane
#pragma unroll
      for (int i = 0; i < kPanel; ++i) {
        const int d = i - lane;
        lrow[i] = (d > 0 && d <= b) ? rows[i * L.rsp + d] : 0.f;
      }
#pragma unroll
      for (int i = kPanel - 1; i >= 0; --i) {
        const float xi = __shfl_sync(kFull, r * dinv, i);
        if (lane == i) xp[i] = xi;
        r = fmaf(-lrow[i], xi, r);
      }
    }
    __syncthreads();  // the panel's solution
    // kept in y, whose entries from k - b on are read already
    if (t < kPanel) y[k + t] = xp[t];
    // the panel's columns of the b rows above it: row m = k - b + s takes
    // L[k + jj, m] x[k + jj] for jj <= s
    for (int s = t; s < b; s += kThreads) {
      const int m = k - b + s;
      if (m < 0) continue;
      float acc = 0.f;
#pragma unroll
      for (int jj = 0; jj < kPanel; ++jj)
        acc = fmaf(jj <= s ? rows[jj * L.rsp + (b - s + jj)] : 0.f, xp[jj], acc);
      ring[m % kRing] -= acc;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
band_chol_kernel(float* __restrict__ band, const float* __restrict__ g,
                 const long long* __restrict__ perm, float* __restrict__ y,
                 float* __restrict__ x, int* __restrict__ info_out, int n_rows, int b) {
  extern __shared__ __align__(16) float sm[];
  const Layout L(b);
  float* lpt = sm;                       // [2][kPanel][kLd] two panels' columns, transposed
  float* ipiv = lpt + 2 * kPanel * kLd;  // [2][kPanel] their 1 / sqrt(pivot)s
  int* s_info = reinterpret_cast<int*>(ipiv + 2 * kPanel);
  float* gwin = ipiv + 2 * kPanel + 4;   // [w] the window's right-hand sides
  float* win = gwin + L.w;               // [w][rsp] the window's rows, a ring
  const int t = threadIdx.x;
  const int n_pan = (n_rows + kPanel - 1) / kPanel;

  for (int e = t; e < 2 * kPanel * kLd; e += kThreads) lpt[e] = 0.f;
  for (int e = t; e < L.w * L.rsp; e += kThreads) win[e] = 0.f;
  if (t == 0) *s_info = 0;
  __syncthreads();
  for (int grp = 0; grp < L.groups; ++grp)
    load_group(band, g, perm, win, gwin, L, n_rows, grp * kPanel, 0);
  cp_async_commit();

  // the first panel's diagonal block; then each panel's rows below it, the
  // next panel's diagonal block updated and factored (warp 0) while the other
  // warps update the rest, write the finished rows out and copy the next
  // group in
  cp_async_wait_all();
  __syncthreads();  // rows [0, kPanel + b) in the window
  if (t < 32) factor_diag(win, lpt, ipiv, s_info, L, 0, 0);
  for (int p = 0; p < n_pan; ++p) {
    const int k = p * kPanel;
    const int kw = k % L.w;  // the window slot of row k
    float* lc = lpt + (p & 1) * kPanel * kLd;       // this panel's columns
    float* ln = lpt + (~p & 1) * kPanel * kLd;      // the next panel's
    __syncthreads();  // the diagonal block, rows [k, k + kPanel + b) in the window
    solve_below(win, gwin, lc, ipiv + (p & 1) * kPanel, y, L, k, kw);
    __syncthreads();  // the panel's columns
    trailing_update(lc, win, gwin, L, kw, true);
    __syncthreads();  // the next panel's diagonal block updated
    if (t < 32) {
      if (p + 1 < n_pan)
        factor_diag(win, ln, ipiv + (~p & 1) * kPanel, s_info, L, k + kPanel,
                    slot(kw + kPanel, L.w));
    } else {
      // the group the next panel needs last in, in the slots of group
      // p - 1 (out a panel ago); the rest of the update; rows [k, k +
      // kPanel), final, out
      load_group(band, g, perm, win, gwin, L, n_rows, (p + L.groups) * kPanel, 32);
      cp_async_commit();
      trailing_update(lc, win, gwin, L, kw, false);
      store_rows(band, win + kw * L.rsp, L, min(kPanel, n_rows - k), k, 32);
      cp_async_wait_all();
    }
  }
  cp_async_wait_all();
  __syncthreads();  // the factor and y in device memory

  // ---- backward substitution L^T x = y, panels from the last
  backward(band, y, lpt, win, L, n_rows);
  __syncthreads();  // the solution in y, in the band's order
  for (int r = t; r < n_rows; r += kThreads) x[perm[r / 6] * 6 + r % 6] = y[r];
  if (t == 0) *info_out = *s_info;
}

}  // namespace

extern "C" int mloam_band_chol_smem_bytes(int b) {
  return Layout(b).floats() * static_cast<int>(sizeof(float));
}

// band [n_rows][b + 1] (factored in place), g [n_rows] and x [n_rows] in pose
// order, perm [n_rows / 6] the pose at each position of the band's order, y
// [n_rows rounded up to kPanel] scratch, info [1].
extern "C" int mloam_band_chol(float* band, const float* g, const long long* perm, float* y,
                               float* x, int* info, int n_rows, int b, void* stream_ptr) {
  constexpr int kMaxDevices = 64;
  static bool attribute_set[kMaxDevices] = {};
  if (n_rows < 6 || n_rows % 6 || b < 5 || (b + 1) % 6 || kPanel + b + 1 > kThreads ||
      2 * kPanel + b > kRing)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = static_cast<size_t>(Layout(b).floats()) * sizeof(float);
  if (bytes > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  const cudaError_t de = cudaGetDevice(&dev);
  if (de != cudaSuccess) return static_cast<int>(de);
  if (dev >= kMaxDevices || !attribute_set[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        band_chol_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < kMaxDevices) attribute_set[dev] = true;
  }
  band_chol_kernel<<<1, kThreads, bytes, static_cast<cudaStream_t>(stream_ptr)>>>(
      band, g, perm, y, x, info, n_rows, b);
  return static_cast<int>(cudaGetLastError());
}
