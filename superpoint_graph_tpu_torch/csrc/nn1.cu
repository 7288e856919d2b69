// Exact 1-nearest-neighbour index of every query point in a db cloud.
//
// Replaces superpoint_graph_tpu/ops/nn1_pallas.py::_nn1_kernel (the TPU
// kernel: a (query block x db tile) grid folding |p|^2 - 2 q.p into a running
// (min, argmin) held in VMEM). The result is nn1_plain's (ops/nn1.py) bit for
// bit: for each query, the lowest db index among the equal smallest
// direct-form distances fl(fl(fl(dx*dx) + fl(dy*dy)) + fl(dz*dz)),
// dx = fl(qx - px), on the caller's coordinates.
//
// Bound: instruction issue. A 1M-point room against its 1M annotation
// points is 1e12 (query, db point) pairs and nothing else is large: the db
// is 12 MB and stays in L2. The direct form costs ~10 issue slots a pair (3
// subtracts, a multiply, 2 FMAs, a compare, 2 selects, a shared-memory
// read); this kernel spends ~3.6 on nearly every pair:
//
// 1. Expanded-form filter. The stage kernel stores each db point centred on
//    the db's bounding-box centre c, p' = p - c, with |p'|^2 + K in the
//    float4's w lane (K >= max |q'|^2, the shift below). A thread keeps
//    a = -2 q' for its queries, so
//    s = fma(ax, px, fma(ay, py, fma(az, pz, |p'|^2 + K)))
//      = |q' - p'|^2 - |q'|^2 + K
//    costs 3 FFMA. Centring makes the filter's rounding depend on the
//    cloud's extent, not on where it lies (S3DIS coordinates reach tens of
//    metres).
// 2. Lazy argmin. No index is carried on the fast path: each thread takes
//    the running minimum of s over a chunk of kChunk points, two points to
//    one VIMNMX3 (a three-way integer minimum of the float bits, which
//    orders non-negative floats as floats do; K keeps s >= 0 but for
//    rounding, and a negative s only sends its chunk to the slow path), and
//    compares each query's chunk minimum with its threshold once a chunk.
// 3. Exact re-check. A chunk that may hold a point closer than the query's
//    best is walked again on the slow path, which computes the direct form
//    on the original coordinates in nn1_plain's order (__fsub_rn, __fmul_rn,
//    __fadd_rn: no contraction) and keeps the smallest distance with a
//    strict '<' in ascending db order, so ties go to the lowest index as in
//    nn1_plain. When few lanes of a warp need it (a new best late in the
//    scan), the whole warp re-checks one lane's query at a time, a point a
//    lane, and reduces (distance, index) with shuffles; when many do (early
//    in the scan), each walks its chunk itself. With the per-thread walk
//    alone the kernel took 1.05x, 1.20x and 1.31x the time at the three
//    shapes of chip_smoke.py on an H100 (nn1_ab.py in the package).
// 4. The threshold, thr = fma(best, rel, M - fl(|q'|^2)), with M >= margin
//    + K and rel and margin from ops/nn1.py::nn1_margin, which derives them:
//    with u = 2^-24, P >= max|p'| and Q >= max|q'| (Euclidean norms),
//      |fl(s) - exact s|           <= 3u (2P^2 + 2PQ + 2K)  (w and 3 fma)
//      | |q'-p'|^2 - |q-p|^2 |     <= 2u (P + Q)^2           (centring)
//      |fl(|q'|^2) - |q'|^2|       <= 3u Q^2
//      D = direct form, D >= |q-p|^2 (1 - 5u)               (relative)
//    plus the rounding of thr itself (2u (M + Q^2) beyond what rel covers).
//    So a point with D < best has fl(s) <= thr whenever margin >=
//    u (8P^2 + 10PQ + 7Q^2 + 8K) and rel >= 1 + 7u; nn1_margin doubles the
//    first and takes rel = 1 + 16u. M - fl(|q'|^2) >= 0, so thr >= 0 and a
//    negative s always passes. The filter can send too many chunks to the
//    slow path, never too few; tests/test_torch_nn1.py checks the bound on
//    adversarial clouds and emulates the search.
// 5. Register blocking: a thread owns kQ queries, so one broadcast LDS.128
//    of a db point serves kQ pairs.
// 6. Asynchronous tiles: db tiles of kTile points are double-buffered in
//    shared memory with cp.async; the next tile lands while this one is
//    scanned.
// 7. Filling the card: when the query blocks alone make fewer than kWaves
//    waves on the SMs, or a ragged last wave, the db range is split across
//    blockIdx.y (whole tiles per split); each split keeps its own
//    (best, arg) and nn1_merge keeps, per query, the first split with the
//    smallest distance, which is the lowest index on ties since splits are
//    in ascending db order.
//
// Tensor cores are not used: the product has depth 3, so an mma tile is
// mostly padding, and TF32 would need a three-pass split (about 24
// tensor-core FMAs a pair) to keep the filter's f32 accuracy, against 3 FFMA.
//
// Plain C interface (loaded with ctypes). The launches go on the caller's
// stream, allocate nothing and do not synchronise; spgt_nn1 returns
// cudaGetLastError() so a refused launch is reported.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kQ = 8;          // queries per thread
constexpr int kTile = 1024;    // db points per shared-memory buffer (16 KB)
constexpr int kChunk = 32;     // points between two threshold checks
constexpr int kWarpRecheck = 8;  // up to this many lanes: one query at a time
constexpr int kQueriesPerBlock = kThreads * kQ;
constexpr int kStageThreads = 256;
constexpr int kWaves = 2;      // least blocks per SM slot of a launch
static_assert(kTile % kChunk == 0, "a tile holds whole chunks");
static_assert(kChunk % 2 == 0, "the fast path takes points in pairs");
static_assert(kChunk == 32, "recheck_warp gives a chunk one point a lane");
static_assert(kTile % kThreads == 0, "every thread copies whole float4s");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// db point j -> (p - c, |p - c|^2 + shift); padding rows up to a whole tile
// get an infinite w, so their s is +inf and never passes the filter.
__global__ void __launch_bounds__(kStageThreads)
nn1_stage(const float* __restrict__ db, int m, int m_pad, float cx, float cy,
          float cz, float shift, float4* __restrict__ db4) {
  const int j = blockIdx.x * kStageThreads + threadIdx.x;
  if (j >= m_pad) return;
  if (j < m) {
    const float x = __fsub_rn(db[3 * (int64_t)j], cx);
    const float y = __fsub_rn(db[3 * (int64_t)j + 1], cy);
    const float z = __fsub_rn(db[3 * (int64_t)j + 2], cz);
    db4[j] = make_float4(x, y, z, fmaf(z, z, fmaf(y, y, fmaf(x, x, shift))));
  } else {
    db4[j] = make_float4(0.f, 0.f, 0.f, INFINITY);
  }
}

// nn1_plain's distance, operation for operation
__device__ __forceinline__ float direct_d2(float qx, float qy, float qz,
                                           const float* __restrict__ p) {
  const float dx = __fsub_rn(qx, __ldg(p));
  const float dy = __fsub_rn(qy, __ldg(p + 1));
  const float dz = __fsub_rn(qz, __ldg(p + 2));
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Slow path, one thread: db points [j0, j1) against one query, ascending,
// strict '<'.
__device__ __forceinline__ void recheck(const float* __restrict__ q,
                                        const float* __restrict__ db, int j0,
                                        int j1, float& best, int& arg) {
  const float qx = __ldg(q), qy = __ldg(q + 1), qz = __ldg(q + 2);
#pragma unroll 4
  for (int j = j0; j < j1; ++j) {
    const float d = direct_d2(qx, qy, qz, db + 3 * (int64_t)j);
    if (d < best) {
      best = d;
      arg = j;
    }
  }
}

// Slow path, the whole warp for one lane's query: lane t takes point j0 + t
// of the chunk (kChunk == 32 points, one a lane), then the warp keeps the
// smallest distance and, among equal ones, the lowest index, which is what
// the ascending strict-'<' walk of the chunk would find.
__device__ __forceinline__ void recheck_warp(const float* __restrict__ q,
                                             const float* __restrict__ db,
                                             int j0, int j_end, int lane,
                                             float& d, int& j) {
  const float qx = __ldg(q), qy = __ldg(q + 1), qz = __ldg(q + 2);
  j = j0 + lane;
  d = j < j_end ? direct_d2(qx, qy, qz, db + 3 * (int64_t)j) : INFINITY;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float od = __shfl_xor_sync(0xffffffffu, d, off);
    const int oj = __shfl_xor_sync(0xffffffffu, j, off);
    if (od < d || (od == d && oj < j)) {
      d = od;
      j = oj;
    }
  }
}

// grid (query blocks, splits). Split s scans tiles
// [s * tiles_per_split, min((s + 1) * tiles_per_split, n_tiles)).
__global__ void __launch_bounds__(kThreads)
nn1_scan(const float* __restrict__ queries, const float* __restrict__ db,
         const float4* __restrict__ db4, int n, int m, int tiles_per_split,
         float cx, float cy, float cz, float margin_shift, float rel,
         float* __restrict__ part_d, int* __restrict__ part_i,
         int64_t* __restrict__ out) {
  __shared__ float4 buf[2][kTile];
  const int n_tiles = (m + kTile - 1) / kTile;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  const int j_end = min(m, t_end * kTile);
  const int q0 = blockIdx.x * kQueriesPerBlock + threadIdx.x;
  const int lane = threadIdx.x & 31;

  float ax[kQ], ay[kQ], az[kQ], aq[kQ], thr[kQ], best[kQ];
  int arg[kQ];
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int i = q0 + k * kThreads;
    best[k] = INFINITY;
    arg[k] = t_begin * kTile;
    if (i < n) {
      const float x = __fsub_rn(queries[3 * (int64_t)i], cx);
      const float y = __fsub_rn(queries[3 * (int64_t)i + 1], cy);
      const float z = __fsub_rn(queries[3 * (int64_t)i + 2], cz);
      ax[k] = -2.f * x;
      ay[k] = -2.f * y;
      az[k] = -2.f * z;
      aq[k] = __fsub_rn(margin_shift, fmaf(z, z, fmaf(y, y, __fmul_rn(x, x))));
      thr[k] = INFINITY;  // the first chunk always goes to the slow path
    } else {
      ax[k] = ay[k] = az[k] = aq[k] = 0.f;
      thr[k] = -INFINITY;  // never
    }
  }

  auto load_tile = [&](int tile, float4* dst) {
    const float4* src = db4 + (int64_t)tile * kTile;
#pragma unroll
    for (int t = threadIdx.x; t < kTile; t += kThreads)
      cp_async16(dst + t, src + t);
  };
  if (t_begin < t_end) load_tile(t_begin, buf[0]);
  cp_async_commit();
  for (int tile = t_begin, it = 0; tile < t_end; ++tile, ++it) {
    // the buffer written here was last read in the previous iteration,
    // which every thread left through its closing __syncthreads()
    if (tile + 1 < t_end) load_tile(tile + 1, buf[(it + 1) & 1]);
    cp_async_commit();
    cp_async_wait_one();  // this thread's copies of `tile` have landed
    __syncthreads();      // and everyone else's
    const float4* tp = buf[it & 1];
    const int base = tile * kTile;
#pragma unroll 1
    for (int c = 0; c < kTile; c += kChunk) {
      int mn[kQ];  // float bits
#pragma unroll
      for (int k = 0; k < kQ; ++k) mn[k] = 0x7f800000;  // +inf
#pragma unroll
      for (int t = 0; t < kChunk; t += 2) {
        const float4 p = tp[c + t];
        const float4 r = tp[c + t + 1];
#pragma unroll
        for (int k = 0; k < kQ; ++k) {
          const float s0 =
              fmaf(ax[k], p.x, fmaf(ay[k], p.y, fmaf(az[k], p.z, p.w)));
          const float s1 =
              fmaf(ax[k], r.x, fmaf(ay[k], r.y, fmaf(az[k], r.z, r.w)));
          mn[k] = min(mn[k], min(__float_as_int(s0), __float_as_int(s1)));
        }
      }
      // A chunk that many lanes must re-check (early in the scan) is walked
      // by each of them; one that few lanes must (later: a new best, or a
      // point within the margin) by the whole warp, one query at a time.
#pragma unroll
      for (int k = 0; k < kQ; ++k) {
        const bool hit = __int_as_float(mn[k]) <= thr[k];
        unsigned lanes = __ballot_sync(0xffffffffu, hit);
        if (lanes == 0) continue;
        if (__popc(lanes) > kWarpRecheck) {
          if (hit) {
            recheck(queries + 3 * (int64_t)(q0 + k * kThreads), db, base + c,
                    min(base + c + kChunk, j_end), best[k], arg[k]);
            thr[k] = fmaf(best[k], rel, aq[k]);
          }
          continue;
        }
        do {
          const int src = __ffs(lanes) - 1;
          lanes &= lanes - 1;
          const int i = q0 - lane + src + k * kThreads;
          float d;
          int j;
          recheck_warp(queries + 3 * (int64_t)i, db, base + c, j_end, lane,
                       d, j);
          if (lane == src && d < best[k]) {
            best[k] = d;
            arg[k] = j;
            thr[k] = fmaf(best[k], rel, aq[k]);
          }
        } while (lanes);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int i = q0 + k * kThreads;
    if (i >= n) continue;
    if (gridDim.y == 1) {
      out[i] = arg[k];
    } else {
      part_d[(int64_t)blockIdx.y * n + i] = best[k];
      part_i[(int64_t)blockIdx.y * n + i] = arg[k];
    }
  }
}

// Per query: the first split holding the smallest distance.
__global__ void __launch_bounds__(kStageThreads)
nn1_merge(const float* __restrict__ part_d, const int* __restrict__ part_i,
          int n, int splits, int64_t* __restrict__ out) {
  const int i = blockIdx.x * kStageThreads + threadIdx.x;
  if (i >= n) return;
  float best = part_d[i];
  int arg = part_i[i];
  for (int s = 1; s < splits; ++s) {
    const float d = part_d[(int64_t)s * n + i];
    if (d < best) {
      best = d;
      arg = part_i[(int64_t)s * n + i];
    }
  }
  out[i] = arg;
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace

// The launch's shape for n queries against m db points: the number of db
// splits, the tiles each split scans, and the rows of the staged db.
extern "C" int spgt_nn1_plan(int n, int m, int* splits, int* tiles_per_split,
                             int* m_pad) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, nn1_scan,
                                                        kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  // At least kWaves waves of blocks; from there up to twice as many splits,
  // the count whose last wave is fullest (a wave is one block per slot).
  const int slots = sms * per_sm;
  const int n_tiles = ceil_div(m, kTile);
  const int q_blocks = ceil_div(n, kQueriesPerBlock);
  const int s_min = ceil_div(kWaves * slots, q_blocks);
  double best_fill = -1.0;
  for (int s = s_min; s <= 2 * s_min; ++s) {
    const int tiles = ceil_div(n_tiles, s < n_tiles ? s : n_tiles);
    const int blocks = q_blocks * ceil_div(n_tiles, tiles);  // no empty split
    const double fill =
        static_cast<double>(blocks) / (ceil_div(blocks, slots) * slots);
    if (fill > best_fill + 0.01) {
      best_fill = fill;
      *tiles_per_split = tiles;
      *splits = blocks / q_blocks;
    }
  }
  *m_pad = n_tiles * kTile;
  return 0;
}

// Stage the db, scan, and merge the splits when there are several: 2 or 3
// launches. db4 holds m_pad rows; part_d / part_i hold splits x n entries
// (unused when splits == 1). (cx, cy, cz) is the centre, shift K and
// margin_shift >= margin + K as ops/nn1.py::nn1_frame gives them.
extern "C" int spgt_nn1(const float* queries, const float* db, void* db4,
                        int n, int m, int m_pad, int splits,
                        int tiles_per_split, float cx, float cy, float cz,
                        float shift, float margin_shift, float rel,
                        float* part_d, int* part_i, int64_t* out,
                        void* stream) {
  if (n <= 0 || m <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float4* staged = static_cast<float4*>(db4);
  nn1_stage<<<ceil_div(m_pad, kStageThreads), kStageThreads, 0, st>>>(
      db, m, m_pad, cx, cy, cz, shift, staged);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(ceil_div(n, kQueriesPerBlock), splits);
  nn1_scan<<<grid, kThreads, 0, st>>>(queries, db, staged, n, m,
                                      tiles_per_split, cx, cy, cz,
                                      margin_shift, rel, part_d, part_i, out);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  nn1_merge<<<ceil_div(n, kStageThreads), kStageThreads, 0, st>>>(
      part_d, part_i, n, splits, out);
  return static_cast<int>(cudaGetLastError());
}
