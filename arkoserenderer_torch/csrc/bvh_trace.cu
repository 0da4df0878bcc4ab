// 8-wide two-level BVH traversal: closest-hit and any-hit rays, CUDA C++ for
// Hopper (sm_90a).
//
// Replaces arkoserenderer_tpu/ops/bvh.py:1001 _trace_wide, the reference's
// traversal. That is an XLA lax.while_loop over every ray at once, not a
// Pallas kernel: each iteration advances all rays one step in lockstep and
// the loop runs until the worst ray is done. Eager torch cannot do the same
// (ops/bvh.py::trace_wide_plain is some two hundred launches a step and a
// host sync per step), so the traversal is a hand kernel.
//
// What it computes, per ray (the reference's step, exactly): pop a child
// descriptor; leaving a BLAS below its entry depth returns the ray to the
// TLAS; an instance leaf switches to the instance's object space (its
// w2o row of inst_rec, row 0 the identity) and processes the instance's
// wide BLAS root in the same step; a quad leaf tests its up to 4 triangles
// (Moller-Trumbore, barycentric slack 1e-6, t > t_eps, t < best t); an
// internal node slab-tests its 8 children against the best t, sorts the
// hit ones far to near by entry distance (Batcher's 19 compare-exchanges;
// any-hit skips the sort) and pushes them, the nearest on top. Pushes land
// at sp_pop + (valid children after this one); writes at index 64 or past
// it are dropped and sp becomes min(sp_pop + pushes, 63). An any-hit ray
// stops at its first accepted hit; every ray stops after max_steps steps.
//
// What bounds it on this card. A step is a chain of dependent loads: the
// stack entry gives the node record (224 bytes) or the quad record (160
// bytes), whose descriptors give the next entries. Its arithmetic (some
// 220 FP32 operations a node step, 53 a triangle) is small beside that
// chain's latency, so the kernel is bound by latency, hidden only by the
// rays in flight, and by how many lanes of a warp do useful work: a warp
// whose lanes each walk a ray runs until its worst ray ends. Random rays
// (a 4,096-instance TLAS: 18.8 steps a ray on average, 176 for the worst)
// leave most lanes idle that way; the frame's coherent rays (1-5 steps)
// are bound instead by each ray's setup and each step's instructions.
//
// What the design does about it (each step measured against the
// one-thread-a-ray kernel it replaces: PERF.md, PR 6):
//  1. Ray spaces cached per instance. The TLAS-space ray (origin,
//     direction and guarded inverse direction, through inst_rec row 0 as
//     every step of the plain walk computes it) is made once a ray; the
//     instance-space ray once an instance entry; a pop below the entry
//     depth switches back to the saved TLAS copy. No other step loads an
//     instance row or divides.
//  2. One lane a ray. Eight lanes a ray (a child a lane, the sort by
//     shuffles, four rays a warp) was built and is bit-exact too, but it
//     cuts the rays in flight eightfold and runs each step's control for
//     one ray on 8 lanes: 2-2.4x slower on the frame's traces.
//  3. Persistent warps with a dynamic ray fetch. About as many blocks as
//     the SMs hold resident; a warp's idle lanes take the next rays,
//     consecutive and in lane order, with one atomicAdd on a counter (the
//     entry point zeroes it), so all warps work near one front of the ray
//     list and neighbouring rays share cached nodes. A lane walks its ray
//     to the end; but once fewer than REFILL_BELOW lanes of the warp walk,
//     and the warp has walked REFILL_AFTER steps since its last refill,
//     the walkers stop where they are, the idle lanes take new rays, and
//     all walk on: a warp no longer waits for its worst ray. (Refilling at
//     every step, or from rays reserved ahead per warp, was slower on the
//     frame's traces: the first desynchronises coherent warps, the second
//     scatters a warp's rays over the list.)
//  4. Registers for occupancy: six blocks an SM (80 registers a thread,
//     24 warps; PR 5's kernel: 87 registers, 20 warps). For that the TLAS
//     and world rays wait in shared memory (a column a thread, 7.5 KB a
//     block) and a node's bounds are loaded child by child.
// Each ray writes only its own outputs, so the results do not depend on
// which lane or warp walked it, nor on when.
//
// Bit-exactness with ops/bvh.py::trace_wide_plain: every operation is the
// plain version's in its order: the transform as ((m0 x + m1 y) + m2 z) +
// (m3 or 0), the three-term dot products as ((a0 b0 + a1 b1) + a2 b2), the
// cross products written out, IEEE division for 1/det and 1/d, the same
// +-1e-12 guard, min/max that propagate NaN as torch's do, and
// --fmad=false with __f*_rn intrinsics, so equal keys pop in the same order
// and ties on t fall the same way; the stack drops and caps as above; the
// instance leaf processes its BLAS root in the same step; a ray stopped
// for a refill resumes with its state untouched, so the step cut falls on
// the same step.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int WIDTH = 8;
constexpr int DEPTH = 64;
constexpr int THREADS = 128;
constexpr int WIDE_LANES = 56;  // 48 bound floats + 8 descriptors
constexpr int QUAD_LANES = 40;  // 36 vertex floats + 4 ids
constexpr int INST_LANES = 14;  // 12 w2o floats + triangle base + wide root
constexpr float DIR_EPS = 1e-12f;
constexpr float BARY_EPS = 1e-6f;
constexpr float ONE_PLUS_EPS = 1.000001f;  // float32(1 + 1e-6)
constexpr float NO_KEY = 1e30f;
constexpr unsigned FULL = 0xffffffffu;
// A warp stops its walks to take new rays once fewer than REFILL_BELOW of
// its lanes still walk and it has walked REFILL_AFTER steps since it last
// took rays.
constexpr int REFILL_BELOW = 16, REFILL_AFTER = 8;
// Rows of a thread's column of shared memory: the ray in the TLAS (origin,
// direction, inverse direction) and the world ray (origin, direction).
constexpr int SM_O = 0, SM_D = 3, SM_ID = 6, SM_WO = 9, SM_WD = 12, SM_ROWS = 15;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// torch.minimum / torch.maximum: a NaN operand wins.
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by,
                                      float bz) {
  return add(add(mul(ax, bx), mul(ay, by)), mul(az, bz));
}

__device__ __forceinline__ float inv_dir(float d) {
  const float g = fabsf(d) < DIR_EPS ? (d < 0.f ? -DIR_EPS : DIR_EPS) : d;
  return __fdiv_rn(1.f, g);
}

// The world ray (wo, wd) through the w2o row `irow`, as the plain walk
// computes it: ((m0 x + m1 y) + m2 z) + (m3 or 0), and 1/d guarded.
__device__ __forceinline__ void to_space(const int* __restrict__ irow, const float* wo,
                                         const float* wd, float* o, float* d, float* id) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float m0 = __int_as_float(__ldg(irow + 4 * a + 0));
    const float m1 = __int_as_float(__ldg(irow + 4 * a + 1));
    const float m2 = __int_as_float(__ldg(irow + 4 * a + 2));
    const float m3 = __int_as_float(__ldg(irow + 4 * a + 3));
    o[a] = add(add(add(mul(m0, wo[0]), mul(m1, wo[1])), mul(m2, wo[2])), m3);
    d[a] = add(add(add(mul(m0, wd[0]), mul(m1, wd[1])), mul(m2, wd[2])), 0.f);
    id[a] = inv_dir(d[a]);
  }
}

// Moller-Trumbore in the plain version's order; returns whether the hit is
// accepted (before the t < best-t test).
__device__ __forceinline__ bool tri_hit(const float* q, const float* o, const float* d,
                                        float t_eps, float& t, float& u, float& v) {
  const float v0x = q[0], v0y = q[1], v0z = q[2];
  const float e1x = q[3], e1y = q[4], e1z = q[5];
  const float e2x = q[6], e2y = q[7], e2z = q[8];
  const float dx = d[0], dy = d[1], dz = d[2];
  const float px = sub(mul(dy, e2z), mul(dz, e2y));
  const float py = sub(mul(dz, e2x), mul(dx, e2z));
  const float pz = sub(mul(dx, e2y), mul(dy, e2x));
  const float det = dot3(e1x, e1y, e1z, px, py, pz);
  const bool good = fabsf(det) > DIR_EPS;
  const float inv_det = good ? __fdiv_rn(1.f, det) : 0.f;
  const float tx = sub(o[0], v0x), ty = sub(o[1], v0y), tz = sub(o[2], v0z);
  u = mul(dot3(tx, ty, tz, px, py, pz), inv_det);
  const float qx = sub(mul(ty, e1z), mul(tz, e1y));
  const float qy = sub(mul(tz, e1x), mul(tx, e1z));
  const float qz = sub(mul(tx, e1y), mul(ty, e1x));
  v = mul(dot3(dx, dy, dz, qx, qy, qz), inv_det);
  t = mul(dot3(e2x, e2y, e2z, qx, qy, qz), inv_det);
  return good && u >= -BARY_EPS && v >= -BARY_EPS && add(u, v) <= ONE_PLUS_EPS && t > t_eps;
}

// A record row in 16-byte loads, all in flight at once.
template <int N>
__device__ __forceinline__ void load_row(const int* __restrict__ row, int* out) {
  const int4* r4 = reinterpret_cast<const int4*>(row);
#pragma unroll
  for (int k = 0; k < N / 4; ++k) {
    const int4 x = __ldg(r4 + k);
    out[4 * k + 0] = x.x;
    out[4 * k + 1] = x.y;
    out[4 * k + 2] = x.z;
    out[4 * k + 3] = x.w;
  }
}

#define ARKOSE_CSWAP(a, b)                                        \
  do {                                                            \
    const bool s_ = keys[a] > keys[b];                            \
    const float ka_ = s_ ? keys[b] : keys[a];                     \
    const float kb_ = s_ ? keys[a] : keys[b];                     \
    const int da_ = s_ ? descs[b] : descs[a];                     \
    const int db_ = s_ ? descs[a] : descs[b];                     \
    keys[a] = ka_; keys[b] = kb_; descs[a] = da_; descs[b] = db_; \
  } while (0)

// The launch's arguments.
struct Params {
  const int* wide_rec;
  const int* quad_rec;
  const int* inst_rec;
  const float* origins;
  const float* dirs;
  const float* t_max_ray;  // null: t_max_all for every ray
  float t_max_all, t_eps;
  int max_steps, n_rays, n_quad;
  int* counter;  // the next ray index to hand out; zeroed before the launch
  float* out_t;
  int* out_tri;
  float* out_u;
  float* out_v;
};

// Six blocks an SM: at most 80 registers a thread, 24 resident warps.
template <bool ANY_HIT>
__global__ void __launch_bounds__(THREADS, 6) bvh_trace_kernel(const Params P) {
  __shared__ float s_rays[SM_ROWS][THREADS];
  float* const saved = &s_rays[0][threadIdx.x];  // this thread's column
  const int lane = threadIdx.x & 31;
  const int tlas_base = __ldg(P.inst_rec + 12);
  bool dry = false;   // the counter has handed out its last ray (warp-uniform)
  bool busy = false;  // this lane walks ray r
  int r = 0;
  // The walk of ray r: the ray in the current space (o, d, id; the TLAS
  // and world rays wait in `saved`), the best hit, the stack.
  float o[3], d[3], id[3];
  float bt = 0.f, bu = 0.f, bv = 0.f;
  int btri = -1, g_base = tlas_base, sp = 0, base_sp = 0, steps = 0;
  int stack[DEPTH];
  for (;;) {
    // Idle lanes take the next rays, consecutive and in lane order: one
    // atomicAdd for the warp.
    if (!dry) {
      const unsigned need = __ballot_sync(FULL, !busy);
      if (need != 0u) {
        const int n_need = __popc(need);
        int base = 0;
        if (lane == 0) base = atomicAdd(P.counter, n_need);
        base = __shfl_sync(FULL, base, 0);
        dry = base + n_need >= P.n_rays;
        const int idx = base + __popc(need & ((1u << lane) - 1u));
        if (!busy && idx < P.n_rays) {
          r = idx;
          busy = true;
          float wo[3], wd[3];
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            wo[a] = __ldg(P.origins + 3 * r + a);
            wd[a] = __ldg(P.dirs + 3 * r + a);
          }
          to_space(P.inst_rec, wo, wd, o, d, id);  // row 0: the TLAS
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            saved[(SM_WO + a) * THREADS] = wo[a];
            saved[(SM_WD + a) * THREADS] = wd[a];
            saved[(SM_O + a) * THREADS] = o[a];
            saved[(SM_D + a) * THREADS] = d[a];
            saved[(SM_ID + a) * THREADS] = id[a];
          }
          bt = P.t_max_ray != nullptr ? __ldg(P.t_max_ray + r) : P.t_max_all;
          btri = -1;
          bu = 0.f;
          bv = 0.f;
          g_base = tlas_base;
          stack[0] = 0;  // the wide TLAS root
          sp = 1;
          base_sp = 0;
          steps = 0;
        }
      }
    }
    if (__all_sync(FULL, !busy)) break;
    if (busy) {
      // Walk until the ray ends, or until the warp's walking lanes are too
      // few (REFILL_BELOW, REFILL_AFTER): the idle ones then take new rays
      // and this walk resumes where it stopped. The lanes that walk here
      // entered this loop together, so they agree on `run` and on the count.
      int run = 0;
      while (sp > 0 && steps < P.max_steps) {
        const int sp_pop = sp - 1;
        const int desc = stack[sp_pop];
        if (sp_pop < base_sp) {  // popped below the BLAS entry: back in the TLAS
          base_sp = 0;
          g_base = tlas_base;
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            o[a] = saved[(SM_O + a) * THREADS];
            d[a] = saved[(SM_D + a) * THREADS];
            id[a] = saved[(SM_ID + a) * THREADS];
          }
        }
        const int e = -desc - 1;
        const int kind = e >> 28;
        const int payload = e & 0x0FFFFFFF;
        const bool is_quad = desc < 0 && kind == 0;
        const bool is_inst = desc < 0 && kind == 1;
        int node = desc;
        if (is_inst) {  // enter the instance: its space, then its BLAS root
          const int* irow = P.inst_rec + (payload + 1) * INST_LANES;
          float wo[3], wd[3];
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            wo[a] = saved[(SM_WO + a) * THREADS];
            wd[a] = saved[(SM_WD + a) * THREADS];
          }
          to_space(irow, wo, wd, o, d, id);
          g_base = __ldg(irow + 12);
          node = __ldg(irow + 13);
          base_sp = sp_pop;
        }

        int pushed = 0;
        if (is_quad) {
          int q[QUAD_LANES];
          load_row<QUAD_LANES>(P.quad_rec + min(max(payload >> 3, 0), P.n_quad - 1) * QUAD_LANES,
                               q);
          const int qcount = payload & 7;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (k < qcount) {
              float qf[9];
#pragma unroll
              for (int j = 0; j < 9; ++j) qf[j] = __int_as_float(q[9 * k + j]);
              float t, u, v;
              if (tri_hit(qf, o, d, P.t_eps, t, u, v) && t < bt) {
                bt = t;
                btri = g_base + q[36 + k];
                bu = u;
                bv = v;
              }
            }
          }
        } else if (desc >= 0 || is_inst) {
          const int* row = P.wide_rec + node * WIDE_LANES;
          float keys[WIDTH];
          int descs[WIDTH];
          const int4 d0 = __ldg(reinterpret_cast<const int4*>(row + 48));
          const int4 d1 = __ldg(reinterpret_cast<const int4*>(row + 52));
          descs[0] = d0.x; descs[1] = d0.y; descs[2] = d0.z; descs[3] = d0.w;
          descs[4] = d1.x; descs[5] = d1.y; descs[6] = d1.z; descs[7] = d1.w;
#pragma unroll
          for (int i = 0; i < WIDTH; ++i) {
            const float2* b = reinterpret_cast<const float2*>(row) + 3 * i;
            const float2 b0 = __ldg(b), b1 = __ldg(b + 1), b2 = __ldg(b + 2);
            const float lo_[3] = {b0.x, b0.y, b1.x}, hi_[3] = {b1.y, b2.x, b2.y};
            float near = 0.f, far = 0.f;
#pragma unroll
            for (int a = 0; a < 3; ++a) {
              const float t0 = mul(sub(lo_[a], o[a]), id[a]);
              const float t1 = mul(sub(hi_[a], o[a]), id[a]);
              const float lo = tmin(t0, t1), hi = tmax(t0, t1);
              near = a == 0 ? lo : tmax(near, lo);
              far = a == 0 ? hi : tmin(far, hi);
            }
            near = tmax(near, 0.f);
            far = tmin(far, bt);
            keys[i] = (near <= far && descs[i] != 0) ? near : NO_KEY;
          }
          if (!ANY_HIT) {
            ARKOSE_CSWAP(0, 1); ARKOSE_CSWAP(2, 3); ARKOSE_CSWAP(4, 5); ARKOSE_CSWAP(6, 7);
            ARKOSE_CSWAP(0, 2); ARKOSE_CSWAP(1, 3); ARKOSE_CSWAP(4, 6); ARKOSE_CSWAP(5, 7);
            ARKOSE_CSWAP(1, 2); ARKOSE_CSWAP(5, 6); ARKOSE_CSWAP(0, 4); ARKOSE_CSWAP(3, 7);
            ARKOSE_CSWAP(1, 5); ARKOSE_CSWAP(2, 6); ARKOSE_CSWAP(1, 4); ARKOSE_CSWAP(3, 6);
            ARKOSE_CSWAP(2, 4); ARKOSE_CSWAP(3, 5); ARKOSE_CSWAP(3, 4);
          }
#pragma unroll
          for (int i = WIDTH - 1; i >= 0; --i) {
            if (keys[i] < NO_KEY) {
              const int pos = sp_pop + pushed;
              if (pos < DEPTH) stack[pos] = descs[i];
              ++pushed;
            }
          }
        }
        sp = min(sp_pop + pushed, DEPTH - 1);
        if (ANY_HIT && btri >= 0) sp = 0;
        ++steps;
        if (sp == 0 || steps >= P.max_steps) break;
        const int walking = __popc(__activemask());
        if (++run >= REFILL_AFTER && walking < REFILL_BELOW) break;
      }
      if (sp == 0 || steps >= P.max_steps) {
        P.out_t[r] = bt;
        P.out_tri[r] = btri;
        P.out_u[r] = bu;
        P.out_v[r] = bv;
        busy = false;
      }
    }
  }
}

#undef ARKOSE_CSWAP

// Blocks of the kernel an SM holds, and the device's SMs (0 on an error).
int blocks_per_sm(bool any_hit, int* sms) {
  int dev = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  const cudaError_t err =
      any_hit ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bvh_trace_kernel<true>,
                                                              THREADS, 0)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bvh_trace_kernel<false>,
                                                              THREADS, 0);
  return err == cudaSuccess ? per_sm : 0;
}

// Resident blocks of each kernel on the device, found once a device.
int resident_blocks(bool any_hit) {
  static int cached[2][64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  int& n = cached[any_hit ? 1 : 0][dev];
  if (n == 0) {
    int sms = 0;
    n = blocks_per_sm(any_hit, &sms) * sms;
  }
  return n;
}

}  // namespace

// Resident warps an SM holds of the any-hit or closest-hit kernel (its
// occupancy), or 0 on an error.
extern "C" int bvh_trace_warps_per_sm(int any_hit) {
  int sms = 0;
  return blocks_per_sm(any_hit != 0, &sms) * (THREADS / 32);
}

// Trace n_rays rays (origins, dirs: (n_rays, 3) f32) through the packed
// records; t_max_ray (n_rays,) or null for t_max_all. Writes t, tri, u, v
// (n_rays each). `counter` is one int32 of scratch, zeroed here on the
// stream before the launch. Launches about as many blocks as the SMs hold
// resident, on `stream`, without synchronising; returns the launch's
// cudaGetLastError() (cudaErrorInvalidValue for a record pointer that is
// not 16-byte aligned).
extern "C" int bvh_trace_launch(const int* wide_rec, const int* quad_rec, const int* inst_rec,
                                const float* origins, const float* dirs,
                                const float* t_max_ray, float t_max_all, float t_eps,
                                int max_steps, int any_hit, int n_rays, int n_quad,
                                float* t, int* tri, float* u, float* v, int* counter,
                                void* stream) {
  if ((reinterpret_cast<uintptr_t>(wide_rec) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(quad_rec) & 15) != 0 || n_quad <= 0 || counter == nullptr)
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int resident = resident_blocks(any_hit != 0);
  if (resident <= 0) {
    const cudaError_t e = cudaGetLastError();
    return (int)(e != cudaSuccess ? e : cudaErrorInvalidConfiguration);
  }
  const int blocks = std::min(resident, (n_rays + THREADS - 1) / THREADS);
  const Params P{wide_rec, quad_rec, inst_rec, origins, dirs, t_max_ray, t_max_all, t_eps,
                 max_steps, n_rays, n_quad, counter, t, tri, u, v};
  const cudaError_t err = cudaMemsetAsync(counter, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  if (any_hit)
    bvh_trace_kernel<true><<<blocks, THREADS, 0, s>>>(P);
  else
    bvh_trace_kernel<false><<<blocks, THREADS, 0, s>>>(P);
  return (int)cudaGetLastError();
}
