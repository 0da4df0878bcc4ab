// Stage-4 tile raster: z-buffered edge-function visibility raster, CUDA C++
// for Hopper (sm_90a).
//
// Replaces the reference's TPU kernel arkoserenderer_tpu/ops/raster_pallas.py
// (_raster_kernel, one Pallas program per tile) and its XLA twin
// arkoserenderer_tpu/ops/raster.py::rasterize_tiles. It serves both callers
// of the forward frame: the camera's visibility buffer and the depth-only
// sun shadow map.
//
// What it computes, per tile of tile_h x tile_w pixels: walk the tile's
// binned list sorted_tris[starts[t] : starts[t] + counts[t]] in list order
// (ascending setup row), then the global list global_tris[:*global_count];
// for each triangle form the three edge functions, the normalised
// barycentrics l = e / area2 (l >= 0 on all three is inside, either winding)
// and the affine reverse-Z depth d = l0 z0 + l1 z1 + l2 z2; keep the
// fragment where d > depth (strict: the earlier triangle wins ties) and
// d < depth_limit, writing depth and the setup-row id.
//
// What bounds it on this card. The work is FP32 edge tests with no matrix
// product, so the scarce things are issue slots and registers, and the
// floor is the output write (4 or 8 bytes a pixel). A plain walk tests
// every pixel against every list entry: at 8192^2 the global list (the
// floor, and any triangle spanning more than max_tiles_per_tri tiles) is
// walked by all 65,536 tiles although about 95 % of those pairs do not
// touch the tile, and each test is some 40 issued instructions. Once those
// tests are gone, what is left per tile is a short serial chain (list
// header, list ids, corners, test, two barriers, walk, store) that is
// mostly latency, so the time follows how many tiles an SM holds at once,
// and that is set by registers per thread.
//
// What the design does about it (one thread block per tile):
//  * Exact tile-level rejection at staging. The block's threads stage one
//    list entry each (a window of blockDim.x entries, binned list first,
//    then the global list) and test it with ops/raster.py::tile_rejects'
//    corner predicate: for some edge, l < 0 at all four corner pixel centres
//    of the tile. The rounded l is monotone along rows and columns, so such
//    a pair covers no pixel. Survivors are compacted into shared memory in
//    list order (warp ballot + a prefix over the warps' counts), so ties
//    resolve exactly as before.
//  * Factored edge functions. edge = fl(fl(A fl(px - ax)) - fl(B fl(py - ay)))
//    with per-triangle A = by - ay, B = bx - ax. Each thread owns one column
//    and PPT consecutive rows of the tile: it forms its three column terms
//    once per triangle, the block stages the tile_h x 3 row terms with the
//    triangle, and a pixel pays one subtract per edge. The rounding is the
//    plain version's, operation for operation.
//  * Skip what is settled. A warp none of whose pixels (in a group of up to
//    4 rows) passes the three edge tests skips the depth arithmetic
//    (__any_sync); a tile whose list is empty after rejection only writes
//    DEPTH_FAR and VIS_NONE.
//  * Overlap staging with the walk. A window's raw triangle data lands in
//    shared memory by cp.async into one of two buffers; the next window's
//    copy is issued before the current window is walked (lists longer than
//    one window).
//  * Many tiles in flight. Blocks of at most 128 threads (an 8 x 128 tile
//    is 128 threads of 8 rows each), launch bounds that hold the registers
//    to 80 without spills (72 for depth-only rasters, compiled apart so they
//    keep no ids), records formed again after the compaction barrier rather
//    than kept live across it, and the depth limits in shared memory: 6
//    tiles per SM at once, 7 for a depth-only raster.
//
// Lists could be split across blocks exactly: the result per pixel is the
// largest d, the earliest list position winning ties, so a packed 64-bit
// key (d bits, ~position) merged with atomicMax combines split lists. No
// caller has lists long enough to need it yet.
//
// Bit-exactness: every operation is the plain torch version's
// (ops/raster.py::rasterize_tiles_plain), rounded as eager torch rounds it
// (__fmul_rn / __fsub_rn / __fdiv_rn, built with --fmad=false and without
// --use_fast_math), so the kernel equals the plain version bit for bit.
//
// Shapes: tile_w <= 128; the block has tile_w x R threads, R the largest
// divisor of tile_h with tile_w x R <= 128, and PPT = tile_h / R must be
// 1, 2, 4, 8 or 16.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SUB = 32;  // survivors whose row terms are staged at once

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// (by - ay) * (px - ax) - (bx - ax) * (py - ay), rounded op by op.
__device__ __forceinline__ float edge(float ax, float ay, float bx, float by,
                                      float px, float py) {
  return __fsub_rn(__fmul_rn(__fsub_rn(by, ay), __fsub_rn(px, ax)),
                   __fmul_rn(__fsub_rn(bx, ax), __fsub_rn(py, ay)));
}

// l = fl(fl(c - r) * inv) for column term c and row term r.
__device__ __forceinline__ float bary(float c, float r, float inv) {
  return __fmul_rn(__fsub_rn(c, r), inv);
}

// True when the edge with slopes (a, b) and origin (x, y) has l < 0 at all
// four corners: the tile_rejects predicate for one edge.
__device__ __forceinline__ bool edge_rejects(float a, float b, float x, float y,
                                             float inv, float px_l, float px_r,
                                             float py_t, float py_b) {
  const float c_l = __fmul_rn(a, __fsub_rn(px_l, x));
  const float c_r = __fmul_rn(a, __fsub_rn(px_r, x));
  const float r_t = __fmul_rn(b, __fsub_rn(py_t, y));
  const float r_b = __fmul_rn(b, __fsub_rn(py_b, y));
  return bary(c_l, r_t, inv) < 0.0f && bary(c_r, r_t, inv) < 0.0f &&
         bary(c_l, r_b, inv) < 0.0f && bary(c_r, r_b, inv) < 0.0f;
}

template <int N>
__device__ __forceinline__ void load_rows(const float* p, float (&r)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N; k += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + k);
      r[k] = v.x; r[k + 1] = v.y; r[k + 2] = v.z; r[k + 3] = v.w;
    }
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    r[0] = v.x; r[1] = v.y;
  } else {
    r[0] = p[0];
  }
}

// Shared memory, carved from one dynamic buffer (see smem_bytes):
//   rec    5 x T float4, the survivors' records in list order (SoA):
//            q0 (A0, A1, A2, inv)  column-term slopes, 1/area2
//            q1 (X0, X1, X2, id)   column-term origins, setup row (bits)
//            q2 (z0, z1, z2, -)    corner depths
//            q3 (B0, B1, B2, -)    row-term slopes
//            q4 (Y0, Y1, Y2, -)    row-term origins
//   rows   SUB x 3 x tile_h floats, row terms of one sub-batch
//   raw    2 stages x T entries: 3 float2 corners, 3 float z, int id
//          (each thread reads only the slot it staged)
//   wcount 32 ints, survivors per warp
//   lim    PPT x T floats, the depth limits of the thread's pixels (only
//          with depth_limit)
struct Raw {
  float2* xy;  // [3][T]
  float* z;    // [3][T]
  int* id;     // [T]
};

__device__ __forceinline__ Raw raw_stage(char* base, int stage, int T) {
  char* p = base + (size_t)stage * 40 * T;
  return Raw{reinterpret_cast<float2*>(p), reinterpret_cast<float*>(p + 24 * T),
             reinterpret_cast<int*>(p + 36 * T)};
}

struct ListRef {
  const int* binned;  // sorted_tris + start
  int count;          // binned entries
  const int* global;
  int total;          // count + global entries
};

// Setup row of list entry j, or -1 past the end or out of range.
__device__ __forceinline__ int list_entry(const ListRef& L, int j, int n_setup) {
  if (j >= L.total) return -1;
  const int t = j < L.count ? L.binned[j] : L.global[j - L.count];
  return (t >= 0 && t < n_setup) ? t : -1;
}

// This thread's entry of a window: id into shared memory, corners and
// depths by cp.async (one commit group). Only this thread reads the slot.
__device__ __forceinline__ void stage_raw(const Raw& r, int t,
                                          const float* screen_xy,
                                          const float* z_ndc) {
  const int i = threadIdx.x;
  const int T = blockDim.x;
  r.id[i] = t;
  if (t >= 0) {
    const float2* s = reinterpret_cast<const float2*>(screen_xy) + 3 * (int64_t)t;
    const float* z = z_ndc + 3 * (int64_t)t;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      cp_async8(&r.xy[c * T + i], s + c);
      cp_async4(&r.z[c * T + i], z + c);
    }
  }
  cp_async_commit();
}

// A staged entry's record (see rec below): corners, depths, 1/area2 and the
// edge slopes, computed from the stage slot as the plain version computes
// them.
__device__ __forceinline__ void make_record(const Raw& r, int slot, int t, float4& q0,
                                            float4& q1, float4& q2, float4& q3,
                                            float4& q4) {
  const int T = blockDim.x;
  const float2 a = r.xy[slot], b = r.xy[T + slot], c = r.xy[2 * T + slot];
  const float x0 = a.x, y0 = a.y, x1 = b.x, y1 = b.y, x2 = c.x, y2 = c.y;
  const float area2 = edge(x0, y0, x1, y1, x2, y2);
  const float den = area2 == 0.0f ? 1.0f : area2;
  const float inv = fabsf(area2) > 1e-12f ? __fdiv_rn(1.0f, den) : 0.0f;
  // Edge e runs from vertex e+1 to vertex e+2 (the plain version's e0..e2).
  q0 = make_float4(__fsub_rn(y2, y1), __fsub_rn(y0, y2), __fsub_rn(y1, y0), inv);
  q1 = make_float4(x1, x2, x0, __int_as_float(t));
  q2 = make_float4(r.z[slot], r.z[T + slot], r.z[2 * T + slot], 0.0f);
  q3 = make_float4(__fsub_rn(x2, x1), __fsub_rn(x0, x2), __fsub_rn(x1, x0), 0.0f);
  q4 = make_float4(y1, y2, y0, 0.0f);
}

// Blocks of at most MAX_THREADS threads. Registers per thread are what
// limits the tiles an SM holds at once; these bounds are the most blocks
// that ptxas fits without spills for PPT <= 8: 6 blocks (80 registers a
// thread), and 7 (72) for a depth-only raster, which keeps no ids.
constexpr int MAX_THREADS = 128;
constexpr int min_blocks(int ppt, bool depth_only) {
  return ppt <= 8 ? (depth_only ? 7 : 6) : 4;
}

template <int PPT, bool DEPTH_ONLY>
__global__ void __launch_bounds__(MAX_THREADS, min_blocks(PPT, DEPTH_ONLY)) raster_tiles_kernel(
    const float* __restrict__ screen_xy, const float* __restrict__ z_ndc,
    const int* __restrict__ sorted_tris, const int* __restrict__ starts,
    const int* __restrict__ counts, const int* __restrict__ global_tris,
    const int* __restrict__ global_count, const float* __restrict__ depth_limit,
    float* __restrict__ depth_out, int* __restrict__ vis_out, int width,
    int tile_h, int tile_w, int ntx, int y_offset, int n_setup,
    int n_sorted, int n_global) {
  extern __shared__ float4 smem[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = (T + 31) >> 5;
  const int warp_lanes = min(32, T - warp * 32);
  const unsigned wmask = warp_lanes == 32 ? 0xffffffffu : ((1u << warp_lanes) - 1u);

  float4* rec = smem;
  float* rows = reinterpret_cast<float*>(smem + 5 * T);
  char* raw_base = reinterpret_cast<char*>(rows + SUB * 3 * tile_h);
  int* wcount = reinterpret_cast<int*>(raw_base + 80 * T);
  float* lim = reinterpret_cast<float*>(wcount + 32);  // [PPT][T], with depth_limit

  const int tile = blockIdx.x;
  const int ty = tile / ntx;
  const int tx = tile % ntx;
  const int ix = tid % tile_w;
  const int g = tid / tile_w;  // row group: rows g*PPT .. g*PPT + PPT - 1
  const int col = tx * tile_w + ix;
  const float px = (float)col + 0.5f;
  const int row0 = ty * tile_h + g * PPT;

  float depth[PPT];
  int vis[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    if (depth_limit) lim[k * T + tid] = depth_limit[(int64_t)(row0 + k) * width + col];
    depth[k] = 0.0f;  // DEPTH_FAR
    vis[k] = -1;      // VIS_NONE
  }

  // The tile's walk list: binned entries, then the global list.
  const int start = starts[tile];
  int count = counts[tile];
  if (start < 0 || start > n_sorted) count = 0;
  count = max(0, min(count, n_sorted - start));
  const int n_g = max(0, min(*global_count, n_global));
  const ListRef L{sorted_tris + (count > 0 ? start : 0), count, global_tris, count + n_g};
  const int nwin = (L.total + T - 1) / T;

  // Corner pixel centres, formed as the per-pixel centres are.
  const float px_l = (float)(tx * tile_w) + 0.5f;
  const float px_r = (float)(tx * tile_w + tile_w - 1) + 0.5f;
  const float py_t = (float)(ty * tile_h + y_offset) + 0.5f;
  const float py_b = (float)(ty * tile_h + tile_h - 1 + y_offset) + 0.5f;

  if (nwin > 0) stage_raw(raw_stage(raw_base, 0, T), list_entry(L, tid, n_setup),
                          screen_xy, z_ndc);
  for (int w = 0; w < nwin; ++w) {
    const int next = w + 1 < nwin ? list_entry(L, (w + 1) * T + tid, n_setup) : -1;
    cp_async_wait_all();
    const Raw r = raw_stage(raw_base, w & 1, T);

    // Test this thread's entry against the tile.
    const int t = r.id[tid];
    bool keep = false;
    if (t >= 0) {
      float4 q0, q1, q2, q3, q4;
      make_record(r, tid, t, q0, q1, q2, q3, q4);
      keep = !(edge_rejects(q0.x, q3.x, q1.x, q4.x, q0.w, px_l, px_r, py_t, py_b) ||
               edge_rejects(q0.y, q3.y, q1.y, q4.y, q0.w, px_l, px_r, py_t, py_b) ||
               edge_rejects(q0.z, q3.z, q1.z, q4.z, q0.w, px_l, px_r, py_t, py_b));
    }
    // Prefetch the next window into the other stage while this one is walked.
    if (w + 1 < nwin) stage_raw(raw_stage(raw_base, (w + 1) & 1, T), next, screen_xy, z_ndc);

    // Compact the survivors in list order.
    const unsigned ballot = __ballot_sync(wmask, keep);
    if (lane == 0) wcount[warp] = __popc(ballot);
    __syncthreads();
    int pos = __popc(ballot & ((1u << lane) - 1u));
    int m = 0;
#pragma unroll 8
    for (int i = 0; i < nwarps; ++i) {
      const int n = wcount[i];
      pos += i < warp ? n : 0;
      m += n;
    }
    if (keep) {  // formed again from the stage: nothing stays live across the barrier
      float4 q0, q1, q2, q3, q4;
      make_record(r, tid, t, q0, q1, q2, q3, q4);
      rec[pos] = q0;
      rec[T + pos] = q1;
      rec[2 * T + pos] = q2;
      rec[3 * T + pos] = q3;
      rec[4 * T + pos] = q4;
    }
    __syncthreads();

    for (int s0 = 0; s0 < m; s0 += SUB) {
      const int nb = min(SUB, m - s0);
      // Row terms fl(B_e * fl(py - Y_e)) of the sub-batch: rows[(j*3 + e)*tile_h + row].
      for (int i = tid; i < nb * 3 * tile_h; i += T) {
        const int row = i % tile_h;
        const int je = i / tile_h;
        const int e = je % 3;
        const int j = s0 + je / 3;
        const float4 b = rec[3 * T + j], y = rec[4 * T + j];
        const float be = e == 0 ? b.x : (e == 1 ? b.y : b.z);
        const float ye = e == 0 ? y.x : (e == 1 ? y.y : y.z);
        const float py = (float)(ty * tile_h + row + y_offset) + 0.5f;
        rows[i] = __fmul_rn(be, __fsub_rn(py, ye));
      }
      __syncthreads();

      for (int jj = 0; jj < nb; ++jj) {
        const float4 a = rec[s0 + jj], o = rec[T + s0 + jj];
        const float inv = a.w;
        const float c0 = __fmul_rn(a.x, __fsub_rn(px, o.x));
        const float c1 = __fmul_rn(a.y, __fsub_rn(px, o.y));
        const float c2 = __fmul_rn(a.z, __fsub_rn(px, o.z));
        const float* rr = rows + jj * 3 * tile_h + g * PPT;
        // Rows in groups of up to 4, so few values are live at once.
        constexpr int KG = PPT < 4 ? PPT : 4;
#pragma unroll
        for (int k0 = 0; k0 < PPT; k0 += KG) {
          float r0[KG], r1[KG], r2[KG];
          load_rows<KG>(rr + k0, r0);
          load_rows<KG>(rr + tile_h + k0, r1);
          load_rows<KG>(rr + 2 * tile_h + k0, r2);
          float l0[KG], l1[KG], l2[KG];
          bool inside[KG];
          bool any = false;
#pragma unroll
          for (int k = 0; k < KG; ++k) {
            l0[k] = bary(c0, r0[k], inv);
            l1[k] = bary(c1, r1[k], inv);
            l2[k] = bary(c2, r2[k], inv);
            inside[k] = l0[k] >= 0.0f && l1[k] >= 0.0f && l2[k] >= 0.0f;
            any |= inside[k];
          }
          if (__any_sync(wmask, any)) {
            const float4 z = rec[2 * T + s0 + jj];
            [[maybe_unused]] const int id = __float_as_int(o.w);
#pragma unroll
            for (int k = 0; k < KG; ++k) {
              const float d = __fadd_rn(__fadd_rn(__fmul_rn(l0[k], z.x), __fmul_rn(l1[k], z.y)),
                                        __fmul_rn(l2[k], z.z));
              const float limit = depth_limit ? lim[(k0 + k) * T + tid] : 2.0f;
              const bool covered = inside[k] && d > depth[k0 + k] && d < limit;
              depth[k0 + k] = covered ? d : depth[k0 + k];
              if constexpr (!DEPTH_ONLY) vis[k0 + k] = covered ? id : vis[k0 + k];
            }
          }
        }
      }
      // The next sub-batch rewrites rows; a next window writes rec and rows
      // only after its own two barriers, which every walker reaches first.
      if (s0 + SUB < m) __syncthreads();
    }
  }

#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int64_t o = (int64_t)(row0 + k) * width + col;
    depth_out[o] = depth[k];
    if constexpr (!DEPTH_ONLY) vis_out[o] = vis[k];
  }
}

size_t smem_bytes(int threads, int tile_h, int pixels, bool limit) {
  return (size_t)threads * (5 * 16 + 2 * 40) + (size_t)SUB * 3 * tile_h * 4 + 32 * 4 +
         (limit ? (size_t)pixels * 4 : 0);
}

}  // namespace

// Plain C entry point, loaded with ctypes. Launches one block per tile on
// `stream` and returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a shape it does not take. Pointers are device
// pointers (screen_xy 8-byte aligned); depth_limit may be null; vis may be
// null when depth_only.
extern "C" int raster_tiles_launch(
    const float* screen_xy, const float* z_ndc, const int* sorted_tris,
    const int* starts, const int* counts, const int* global_tris,
    const int* global_count, const float* depth_limit, float* depth, int* vis,
    int width, int height, int tile_h, int tile_w, int y_offset, int depth_only,
    int n_setup, int n_sorted, int n_global, void* stream) {
  if (tile_h <= 0 || tile_w <= 0 || tile_w > MAX_THREADS || width % tile_w != 0 ||
      height % tile_h != 0 || (reinterpret_cast<uintptr_t>(screen_xy) & 7) != 0)
    return (int)cudaErrorInvalidValue;
  int groups = 1;  // row groups R
  for (int r = tile_h; r >= 1; --r)
    if (tile_h % r == 0 && tile_w * r <= MAX_THREADS) { groups = r; break; }
  const int threads = tile_w * groups;
  const int ppt = tile_h / groups;
  const int ntx = width / tile_w;
  const int ntiles = (height / tile_h) * ntx;
  if (ntiles == 0) return 0;
  const size_t smem = smem_bytes(threads, tile_h, tile_h * tile_w, depth_limit != nullptr);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ARKOSE_LAUNCH(P, D)                                                     \
  do {                                                                          \
    if (smem > 48 * 1024) {                                                     \
      cudaError_t e = cudaFuncSetAttribute(                                     \
          raster_tiles_kernel<P, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, \
          (int)smem);                                                           \
      if (e != cudaSuccess) return (int)e;                                      \
    }                                                                           \
    raster_tiles_kernel<P, D><<<ntiles, threads, smem, s>>>(                    \
        screen_xy, z_ndc, sorted_tris, starts, counts, global_tris,             \
        global_count, depth_limit, depth, vis, width, tile_h, tile_w, ntx,      \
        y_offset, n_setup, n_sorted, n_global);                                 \
  } while (0)
#define ARKOSE_LAUNCH_PPT(P)                            \
  do {                                                  \
    if (depth_only) ARKOSE_LAUNCH(P, true);             \
    else ARKOSE_LAUNCH(P, false);                       \
  } while (0)
  switch (ppt) {
    case 1: ARKOSE_LAUNCH_PPT(1); break;
    case 2: ARKOSE_LAUNCH_PPT(2); break;
    case 4: ARKOSE_LAUNCH_PPT(4); break;
    case 8: ARKOSE_LAUNCH_PPT(8); break;
    case 16: ARKOSE_LAUNCH_PPT(16); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef ARKOSE_LAUNCH_PPT
#undef ARKOSE_LAUNCH
  return (int)cudaGetLastError();
}
