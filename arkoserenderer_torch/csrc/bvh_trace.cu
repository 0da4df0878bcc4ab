// 8-wide two-level BVH traversal: closest-hit and any-hit rays, CUDA C++ for
// Hopper (sm_90a).
//
// Replaces arkoserenderer_tpu/ops/bvh.py::_trace_wide, the reference's
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
// at sp_pop + (valid lanes after this one); writes at index 64 or past it
// are dropped and sp becomes min(sp_pop + pushes, 63). An any-hit ray
// stops at its first accepted hit; every ray stops after max_steps steps.
//
// What bounds it on this card. A step is a chain of dependent gathers:
// the popped descriptor gives the instance record, the node record
// (224 bytes) or the quad record (160 bytes), whose descriptors give the
// next pops. The arithmetic (some 200 FP32 operations for a node step,
// 170 for a quad step) is small beside the latency of that chain, so the
// kernel is bound by dependent gathers, not by bytes or operations.
//
// What the design does about it: one thread per ray, each running its own
// loop to its own end (no lockstep, no per-step host sync, no step for a
// finished ray); records read as the int32 rows they are stored in, with
// 16-byte loads for the node and quad rows and floats taken by
// __int_as_float; the child keys and descriptors in registers (the sort
// network is unrolled); the 64-entry stack in local memory (256 bytes a
// thread; it is addressed by sp, so it cannot live in registers; shared
// memory would cost 32 KB per 128-thread block and limit the blocks an SM
// holds). Later work: sort rays by origin and direction so a warp walks
// the same nodes, a persistent pool of rays refilled per warp, and the top
// levels of the tree staged in shared memory.
//
// Bit-exactness: every operation is the plain torch version's
// (ops/bvh.py::trace_wide_plain) in its order: the three-term dot products
// as ((a0 b0 + a1 b1) + a2 b2), the cross products written out, IEEE
// division for 1/det and 1/d, the same +-1e-12 guard, min/max that
// propagate NaN as torch's do, and --fmad=false with __f*_rn intrinsics,
// so equal keys pop in the same order and ties on t and the step cut fall
// the same way.

#include <cuda_runtime.h>
#include <stdint.h>

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

// Moller-Trumbore in the plain version's order; returns whether the hit is
// accepted (before the t < best-t test).
__device__ __forceinline__ bool tri_hit(const float* q, float ox, float oy, float oz,
                                        float dx, float dy, float dz, float t_eps, float& t,
                                        float& u, float& v) {
  const float v0x = q[0], v0y = q[1], v0z = q[2];
  const float e1x = q[3], e1y = q[4], e1z = q[5];
  const float e2x = q[6], e2y = q[7], e2z = q[8];
  const float px = sub(mul(dy, e2z), mul(dz, e2y));
  const float py = sub(mul(dz, e2x), mul(dx, e2z));
  const float pz = sub(mul(dx, e2y), mul(dy, e2x));
  const float det = dot3(e1x, e1y, e1z, px, py, pz);
  const bool good = fabsf(det) > DIR_EPS;
  const float inv_det = good ? __fdiv_rn(1.f, det) : 0.f;
  const float tx = sub(ox, v0x), ty = sub(oy, v0y), tz = sub(oz, v0z);
  u = mul(dot3(tx, ty, tz, px, py, pz), inv_det);
  const float qx = sub(mul(ty, e1z), mul(tz, e1y));
  const float qy = sub(mul(tz, e1x), mul(tx, e1z));
  const float qz = sub(mul(tx, e1y), mul(ty, e1x));
  v = mul(dot3(dx, dy, dz, qx, qy, qz), inv_det);
  t = mul(dot3(e2x, e2y, e2z, qx, qy, qz), inv_det);
  return good && u >= -BARY_EPS && v >= -BARY_EPS && add(u, v) <= ONE_PLUS_EPS && t > t_eps;
}

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

#define ARKOSE_CSWAP(a, b)                                   \
  do {                                                       \
    const bool s_ = keys[a] > keys[b];                       \
    const float ka_ = s_ ? keys[b] : keys[a];                \
    const float kb_ = s_ ? keys[a] : keys[b];                \
    const int da_ = s_ ? descs[b] : descs[a];                \
    const int db_ = s_ ? descs[a] : descs[b];                \
    keys[a] = ka_; keys[b] = kb_; descs[a] = da_; descs[b] = db_; \
  } while (0)

template <bool ANY_HIT>
__global__ void __launch_bounds__(THREADS)
bvh_trace_kernel(const int* __restrict__ wide_rec, const int* __restrict__ quad_rec,
                 const int* __restrict__ inst_rec, const float* __restrict__ origins,
                 const float* __restrict__ dirs, const float* __restrict__ t_max_ray,
                 float t_max_all, float t_eps, int max_steps, int n_rays, int n_quad,
                 float* __restrict__ out_t, int* __restrict__ out_tri,
                 float* __restrict__ out_u, float* __restrict__ out_v) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const float rox = origins[3 * r], roy = origins[3 * r + 1], roz = origins[3 * r + 2];
  const float rdx = dirs[3 * r], rdy = dirs[3 * r + 1], rdz = dirs[3 * r + 2];
  float bt = t_max_ray != nullptr ? t_max_ray[r] : t_max_all;
  int btri = -1;
  float bu = 0.f, bv = 0.f;

  int stack[DEPTH];
  stack[0] = 0;  // the wide TLAS root
  int sp = 1, cur_inst = -1, base_sp = 0;
  for (int step = 0; step < max_steps && sp > 0; ++step) {
    const int top = sp - 1;
    const int desc = stack[top];
    if (top < base_sp) {  // popped below the BLAS entry: back in the TLAS
      cur_inst = -1;
      base_sp = 0;
    }
    const int sp_pop = sp - 1;
    const int e = -desc - 1;
    const int kind = e >> 28;
    const int payload = e & 0x0FFFFFFF;
    const bool is_quad = desc < 0 && kind == 0;
    const bool is_inst = desc < 0 && kind == 1;
    const bool is_node = desc >= 0 || is_inst;
    if (is_inst) {
      cur_inst = payload;
      base_sp = sp_pop;
    }

    // The ray in the current space: ((m0 x + m1 y) + m2 z) + (m3 or 0).
    const int* irow = inst_rec + (cur_inst + 1) * INST_LANES;
    float o[3], d[3], id[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float m0 = __int_as_float(__ldg(irow + 4 * a + 0));
      const float m1 = __int_as_float(__ldg(irow + 4 * a + 1));
      const float m2 = __int_as_float(__ldg(irow + 4 * a + 2));
      const float m3 = __int_as_float(__ldg(irow + 4 * a + 3));
      o[a] = add(add(add(mul(m0, rox), mul(m1, roy)), mul(m2, roz)), m3);
      d[a] = add(add(add(mul(m0, rdx), mul(m1, rdy)), mul(m2, rdz)), 0.f);
      id[a] = inv_dir(d[a]);
    }

    int pushed = 0;
    if (is_quad) {
      const int qrow = min(max(payload >> 3, 0), n_quad - 1);
      const int qcount = payload & 7;
      const int g_base = __ldg(irow + 12);
      int q[QUAD_LANES];
      load_row<QUAD_LANES>(quad_rec + qrow * QUAD_LANES, q);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (k < qcount) {
          float qf[9];
#pragma unroll
          for (int j = 0; j < 9; ++j) qf[j] = __int_as_float(q[9 * k + j]);
          float t, u, v;
          if (tri_hit(qf, o[0], o[1], o[2], d[0], d[1], d[2], t_eps, t, u, v) && t < bt) {
            bt = t;
            btri = g_base + q[36 + k];
            bu = u;
            bv = v;
          }
        }
      }
    }
    if (is_node) {
      const int node = is_inst ? __ldg(irow + 13) : desc;
      int w[WIDE_LANES];
      load_row<WIDE_LANES>(wide_rec + node * WIDE_LANES, w);
      float keys[WIDTH];
      int descs[WIDTH];
#pragma unroll
      for (int i = 0; i < WIDTH; ++i) {
        float near = 0.f, far = 0.f;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float t0 = mul(sub(__int_as_float(w[6 * i + a]), o[a]), id[a]);
          const float t1 = mul(sub(__int_as_float(w[6 * i + 3 + a]), o[a]), id[a]);
          const float lo = tmin(t0, t1), hi = tmax(t0, t1);
          near = a == 0 ? lo : tmax(near, lo);
          far = a == 0 ? hi : tmin(far, hi);
        }
        near = tmax(near, 0.f);
        far = tmin(far, bt);
        descs[i] = w[48 + i];
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
  }
  out_t[r] = bt;
  out_tri[r] = btri;
  out_u[r] = bu;
  out_v[r] = bv;
}

#undef ARKOSE_CSWAP

}  // namespace

// Trace n_rays rays (origins, dirs: (n_rays, 3) f32) through the packed
// records; t_max_ray (n_rays,) or null for t_max_all. Writes t, tri, u, v
// (n_rays each). Launches on `stream` without synchronising; returns the
// launch's cudaGetLastError() (cudaErrorInvalidValue for a record pointer
// that is not 16-byte aligned).
extern "C" int bvh_trace_launch(const int* wide_rec, const int* quad_rec, const int* inst_rec,
                                const float* origins, const float* dirs,
                                const float* t_max_ray, float t_max_all, float t_eps,
                                int max_steps, int any_hit, int n_rays, int n_quad,
                                float* t, int* tri, float* u, float* v, void* stream) {
  if ((reinterpret_cast<uintptr_t>(wide_rec) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(quad_rec) & 15) != 0 || n_quad <= 0)
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (n_rays + THREADS - 1) / THREADS;
  if (any_hit)
    bvh_trace_kernel<true><<<blocks, THREADS, 0, s>>>(wide_rec, quad_rec, inst_rec, origins,
                                                      dirs, t_max_ray, t_max_all, t_eps,
                                                      max_steps, n_rays, n_quad, t, tri, u, v);
  else
    bvh_trace_kernel<false><<<blocks, THREADS, 0, s>>>(wide_rec, quad_rec, inst_rec, origins,
                                                       dirs, t_max_ray, t_max_all, t_eps,
                                                       max_steps, n_rays, n_quad, t, tri, u, v);
  return (int)cudaGetLastError();
}
