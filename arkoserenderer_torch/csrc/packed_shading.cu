// Packed deferred shading: the whole of ops/packed_shading.py::shade_packed
// for every pixel of the visibility buffer in one launch, CUDA C++ for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel. It is the counterpart of the JAX package's
// arkoserenderer_tpu/ops/packed_shading.py shade_packed, which XLA fuses
// into a few loops over the pixels. Eager torch runs the same function as
// one kernel a tensor operation: some 1,400 launches a 1080p frame (the
// 13-way mip selects, twelve lanes of shifts and masks a texel tap, the
// sRGB decode, the VSM tap, the BRDF, the velocity), each reading and
// writing whole 2M-pixel tensors through device memory.
//
// What it computes, per pixel (the plain version's order): the record
// gather; the perspective-correct barycentrics and those of the +1 px x
// and y neighbours (the UV gradients); the attribute interpolation; the
// packed-material sample at the quality given (trilinear, bilinear at the
// nearest mip, anisoN, the stochastic mip, the stochastic texel, or the
// material's factors alone); the sun's visibility (the ray-traced mask, the
// VSM's bilinear or jittered moment tap, or lit); the Filament BRDF for the
// sun with its clearcoat lobe and for each spot (cone, IES profile; the
// ray-traced mask, or PCF of its local map where flagged) and point light;
// emissive, the double-sided flip and the screen-space velocity; and the
// six G-buffer outputs, zeros where the pixel has no triangle.
//
// What bounds it on this card. Its compulsory traffic is 65 bytes a pixel:
// the visibility id read (4) and the G-buffer written once (SceneColor 12,
// SceneNormal 12, SceneVelocity 8, SceneBaseColor 12, SceneMaterial 16,
// SceneCoverage 1): 134.8 MB, 0.040 ms at 3.35 TB/s for 1080p. The rest is
// gathers that stay in L2 or are spatially coherent: the 80-lane record of
// each visible triangle, the texel rows of the packed material chains, the
// moment taps of the sun's map. So it is a bandwidth- and latency-bound
// gather kernel, and its arithmetic (a few thousand FP32 operations a
// pixel, most in the texel decode and the BRDF) is the other limit.
//
// What the design does about it:
//  1. One thread a pixel, in 32x8 blocks: a warp's pixels share their
//     triangles, so a record lane is one broadcast load for the warp, and
//     their texel and moment taps share cache lines.
//  2. The record is read with 16-byte read-only loads (__ldg of float4;
//     a row is rec_size, a multiple of 8, lanes), and only the lanes the
//     branch needs: the layout is a template parameter, so every offset is
//     a constant, the loads of one float4 are one load and unused lanes are
//     never read.
//  3. The mip's offset and size are read by index, not by a select chain,
//     and each texel row is decoded in registers; the sRGB lanes go through
//     a 256-entry table in shared memory that the wrapper makes once a
//     device with the plain decode itself (bit for bit its values).
//  4. Nothing goes through device memory between the steps: every
//     intermediate lives in registers, the G-buffer is written once.
//
// Per-frame values (the camera, the sun, the lights, the frame index of the
// stochastic filters) are read through device pointers: the frame is
// replayed as a CUDA graph, which would freeze a host scalar. The kernel's
// arguments hold only what a pipeline fixes at construction (sizes, layout,
// quality, sun mode, light counts, spot flags, mip bias, PCF disc).
//
// Numerics: built with --fmad=false and no fast math, each operation is the
// plain version's on the card in its order: the three-term sums of torch's
// reductions as (x + z) + y (a two-lane split of a 3-wide row), a division
// by a Python scalar as a product with its float reciprocal and a scalar
// over a tensor as a reciprocal times the scalar (as torch computes them
// on the card), min and max that propagate NaN, powf, log2f, acosf, rsqrtf
// and rintf as torch calls them. Differences can come only from a
// transcendental's rounding or from a floor or round that flips at a
// boundary.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_X = 32, BLOCK_Y = 8;
constexpr int MAX_MIPS = 13;
constexpr int PCF_TAPS = 8;
constexpr double PI = 3.141592653589793;  // Python's math.pi

enum Quality { Q_NONE = 0, Q_TRILINEAR = 1, Q_BILINEAR = 2, Q_ANISO = 3, Q_STOCHASTIC = 4,
               Q_STOCHASTIC1 = 5 };
enum SunMode { SUN_NONE = 0, SUN_MASK = 1, SUN_VSM = 2, SUN_VSM_STOCHASTIC = 3 };

// Material record lanes (ops/packed_shading.py).
constexpr int M_BASEF = 0, M_EMIF = 4, M_METAL = 7, M_ROUGH = 8, M_DSIDED = 9, M_CC = 10,
              M_CCR = 11, M_SSS = 12, M_TEXMETA = 15;

// Mirrored field for field by ops/packed_shading_cuda.py::ShadeArgs
// (packed_shading_args_size() lets the wrapper check the size).
struct Args {
  // per pixel
  const int* vis;
  const float* px;
  const float* py;
  const float* rec;
  const int* tex_rows;
  const float* srgb_lut;
  const float* noise_mask;
  const int* frame_index;  // () int32; null: ``frame_value`` is the host's index
  // the camera
  const float* cam_pos;
  const float* exposure;
  const float* vp_cur;   // unjittered view-projection, (4, 4)
  const float* vp_prev;  // previous view-projection, (4, 4)
  // the sun
  const float* sun_dir;
  const float* sun_color;
  const unsigned char* sun_valid;
  const float* sun_vp;
  const float* shadow_mask;
  const float* moments;
  // the local lights
  const float* spot_pos;
  const float* spot_dir;
  const float* spot_color;
  const float* spot_cone;
  const float* spot_ies;
  const float* spot_vp;
  const float* local_maps;
  const float* rt_spot;
  const float* point_pos;
  const float* point_color;
  const float* rt_point;
  // the G-buffer
  float* color;
  float* normal;
  float* velocity;
  float* base_color;
  float* material;
  unsigned char* coverage;
  // fixed at construction
  int n;
  int grid_w;
  int rows;
  int n_rec;
  int rec_size;
  int has_prev;
  int has_tan;
  int tex_last;
  int quality;
  int aniso_taps;
  int sun_mode;
  int vsm_size;
  int n_spots;
  int n_points;
  int spot_pcf;  // bit i: spot i takes PCF of its local map
  int local_size;
  int frame_value;
  float frame_w;
  float frame_h;
  float mip_bias;
  float pcf_taps[2 * PCF_TAPS];
};

// The record layout of ops/packed_shading.py::record_layout.
template <bool PREV, bool TAN>
struct Layout {
  static constexpr int O_PREV = 3;
  static constexpr int O_NRM = PREV ? 6 : 3;
  static constexpr int O_TAN = O_NRM + 3;
  static constexpr int O_UV = O_NRM + 3 + (TAN ? 4 : 0);
  static constexpr int CS = O_UV + 2;
  static constexpr int MO = 9 + 3 * CS;
  static constexpr int REC = (MO + 32 + 7) / 8 * 8;
};

// Lane J of a record row, from its 16-byte word: the loads of one word are
// one load, and a lane nothing uses is never read.
template <int J>
__device__ __forceinline__ float lane(const float4* row) {
  const float4 q = __ldg(row + J / 4);
  return (J & 3) == 0 ? q.x : (J & 3) == 1 ? q.y : (J & 3) == 2 ? q.z : q.w;
}

struct F3 {
  float x, y, z;
};

__device__ __forceinline__ F3 f3(float x, float y, float z) { return F3{x, y, z}; }
__device__ __forceinline__ F3 ld3(const float* p) { return F3{__ldg(p), __ldg(p + 1), __ldg(p + 2)}; }
__device__ __forceinline__ F3 sub3(F3 a, F3 b) { return F3{a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ F3 add3(F3 a, F3 b) { return F3{a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ F3 mul3(F3 a, F3 b) { return F3{a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ F3 scale3(F3 a, float s) { return F3{a.x * s, a.y * s, a.z * s}; }

// torch.sum over a contiguous last dimension of 3 on the card: two lanes
// take x, z and y, then one shuffle adds them.
__device__ __forceinline__ float dot3(F3 a, F3 b) {
  return (a.x * b.x + a.z * b.z) + a.y * b.y;
}

// mathx.normalize: v / sqrt(sum(v * v) + 1e-20).
__device__ __forceinline__ F3 normalize3(F3 v) {
  const float r = sqrtf(dot3(v, v) + (float)1e-20);
  return F3{v.x / r, v.y / r, v.z / r};
}

// torch.clamp / clamp(min=) / maximum / minimum: NaN propagates.
__device__ __forceinline__ float tclamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float tclamp_min(float v, float lo) { return v != v ? v : fmaxf(v, lo); }
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : b != b ? b : fmaxf(a, b);
}
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : b != b ? b : fminf(a, b);
}
__device__ __forceinline__ float tsign(float a) {
  return (float)((0.0f < a) - (a < 0.0f));
}

// A (4, 4) row-major matrix's row r applied to p: ((p.x m0 + p.y m1) + p.z m2) + m3.
__device__ __forceinline__ float mrow(const float* m, int r, F3 p) {
  const float* q = m + 4 * r;
  return ((p.x * __ldg(q) + p.y * __ldg(q + 1)) + p.z * __ldg(q + 2)) + __ldg(q + 3);
}

// ops/noise.sample_blue_noise at pixel centre (fx, fy).
__device__ __forceinline__ float blue_noise(const Args& a, float fx, float fy, int salt) {
  const int sx = (salt * 61) % 128;
  const int sy = (salt * 101 + (salt >> 3) * 31) % 128;
  const long long x = (static_cast<long long>(fx) + sx) & 127;
  const long long y = (static_cast<long long>(fy) + sy) & 127;
  const float v = __ldg(a.noise_mask + y * 128 + x);
  const int k = salt % 3;
  const float alpha = k == 0 ? (float)0.6180339887498949
                    : k == 1 ? (float)0.7548776662466927 : (float)0.5698402909980532;
  const int frame = a.frame_index != nullptr ? __ldg(a.frame_index) : a.frame_value;
  const float t = static_cast<float>(frame) * alpha;
  float m = fmodf((v + t) - floorf(t), 1.0f);
  if (m != 0.0f && m < 0.0f) m += 1.0f;
  return m;
}

// --------------------------------------------------------------------------
// The packed material sample (ops/mattex.py::sample_packed)

constexpr int LANES = 12;

// One texel row's 12 lanes in [0, 1]: base.rgb and emissive.rgb through
// the sRGB table, the rest byte / 255.
__device__ __forceinline__ void unpack(const Args& a, const float* lut, int idx, float* c) {
  const int* r = a.tex_rows + 3 * static_cast<long long>(idx);
  const unsigned w0 = static_cast<unsigned>(__ldg(r));
  const unsigned w1 = static_cast<unsigned>(__ldg(r + 1));
  const unsigned w2 = static_cast<unsigned>(__ldg(r + 2));
  const float k = (float)(1.0 / 255.0);
  c[0] = lut[w0 & 255u];
  c[1] = lut[(w0 >> 8) & 255u];
  c[2] = lut[(w0 >> 16) & 255u];
  c[3] = static_cast<float>(w0 >> 24) * k;
  c[4] = static_cast<float>(w1 & 255u) * k;
  c[5] = static_cast<float>((w1 >> 8) & 255u) * k;
  c[6] = static_cast<float>((w1 >> 16) & 255u) * k;
  c[7] = static_cast<float>(w1 >> 24) * k;
  c[8] = lut[w2 & 255u];
  c[9] = lut[(w2 >> 8) & 255u];
  c[10] = lut[(w2 >> 16) & 255u];
  c[11] = static_cast<float>(w2 >> 24) * k;
}

__device__ __forceinline__ int wrap_addr(int c, int extent, int wrap) {
  return wrap == 0 ? (c & (extent - 1)) : min(max(c, 0), extent - 1);
}

struct TexMeta {
  const float* offs;  // the record's 13 mip offsets
  int wrap, w0, h0, max_lod_i;
  float max_lod;
};

// The lane at ``level`` (lane 0 outside 1..12), and max(base >> level, 1)
// (``base`` at 0 or out of range): _select13 and _mip_dim by index.
__device__ __forceinline__ bool level_in_range(int level) { return level >= 1 && level < MAX_MIPS; }

// One bilinear fetch at one mip level (_fetch_level): 4 row gathers,
// summed (0,0), (1,0), (0,1), (1,1) as the plain loop adds them.
__device__ __forceinline__ void fetch_level(const Args& a, const float* lut, const TexMeta& t,
                                            int level, float u, float v, float* out) {
  const bool in = level_in_range(level);
  const int off = static_cast<int>(__ldg(t.offs + (in ? level : 0)));
  const int wl = in ? max(t.w0 >> level, 1) : t.w0;
  const int hl = in ? max(t.h0 >> level, 1) : t.h0;
  const float x = u * static_cast<float>(wl) - 0.5f;
  const float y = v * static_cast<float>(hl) - 0.5f;
  const float x0 = floorf(x), y0 = floorf(y);
  const float fx = x - x0, fy = y - y0;
  const float gx = 1.0f - fx, gy = 1.0f - fy;
  const int x0i = static_cast<int>(x0), y0i = static_cast<int>(y0);
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const int xi = wrap_addr(x0i + dx, wl, t.wrap);
      const int yi = wrap_addr(y0i + dy, hl, t.wrap);
      const int idx = min(max(static_cast<int>(static_cast<unsigned>(off) +
                                               static_cast<unsigned>(yi) * static_cast<unsigned>(wl) +
                                               static_cast<unsigned>(xi)), 0), a.tex_last);
      const float wgt = (dx ? fx : gx) * (dy ? fy : gy);
      float c[LANES];
      unpack(a, lut, idx, c);
#pragma unroll
      for (int j = 0; j < LANES; ++j) out[j] = (dx | dy) ? out[j] + c[j] * wgt : c[j] * wgt;
    }
  }
}

__device__ __forceinline__ void trilinear(const Args& a, const float* lut, const TexMeta& t,
                                          float lod, float u, float v, float* out) {
  const int l0 = static_cast<int>(floorf(lod));
  const int l1 = min(l0 + 1, t.max_lod_i);
  const float f = lod - static_cast<float>(l0);
  const float g = 1.0f - f;
  float c0[LANES], c1[LANES];
  fetch_level(a, lut, t, l0, u, v, c0);
  fetch_level(a, lut, t, l1, u, v, c1);
#pragma unroll
  for (int j = 0; j < LANES; ++j) out[j] = c0[j] * g + c1[j] * f;
}

// The 12 lanes of the material's sample at ``quality`` (sample_packed
// before its normal decode). ``meta`` is the record's texture meta.
__device__ __forceinline__ void sample_material(const Args& a, const float* lut, const float* meta,
                                                float u, float v, float dux, float dvx, float duy,
                                                float dvy, float pxf, float pyf, float* c) {
  const float m1 = __ldg(meta + 1), m2 = __ldg(meta + 2), n_mips = __ldg(meta + 3);
  TexMeta t;
  t.offs = meta + 4;
  t.wrap = static_cast<int>(__ldg(meta));
  t.w0 = static_cast<int>(m1);
  t.h0 = static_cast<int>(m2);
  t.max_lod = n_mips - 1.0f;
  t.max_lod_i = static_cast<int>(t.max_lod);
  const float dx0 = dux * m1, dx1 = dvx * m2;
  const float dy0 = duy * m1, dy1 = dvy * m2;
  const float lx2 = dx0 * dx0 + dx1 * dx1;
  const float ly2 = dy0 * dy0 + dy1 * dy1;
  float lod = log2f(tclamp_min(tmax(lx2, ly2), (float)1e-12)) * 0.5f;
  if (a.mip_bias != 0.0f) lod = lod + a.mip_bias;
  lod = tmin(tclamp_min(lod, 0.0f), t.max_lod);

  if (a.quality == Q_TRILINEAR) {
    trilinear(a, lut, t, lod, u, v, c);
  } else if (a.quality == Q_ANISO) {
    const int n_taps = a.aniso_taps;
    const bool major_is_x = lx2 >= ly2;
    const float rho_maj2 = tclamp_min(major_is_x ? lx2 : ly2, (float)1e-12);
    const float rho_min2 = tclamp_min(major_is_x ? ly2 : lx2, (float)1e-12);
    const float rho_eff2 =
        tmax(rho_min2, rho_maj2 * (1.0f / static_cast<float>(n_taps * n_taps)));
    float lod_a = log2f(rho_eff2) * 0.5f;
    if (a.mip_bias != 0.0f) lod_a = lod_a + a.mip_bias;
    lod_a = tmin(tclamp_min(lod_a, 0.0f), t.max_lod);
    const float mu = major_is_x ? dux : duy;
    const float mv = major_is_x ? dvx : dvy;
#pragma unroll 1
    for (int k = 0; k < n_taps; ++k) {
      const float s = static_cast<float>((k + 0.5) / n_taps - 0.5);
      float tap[LANES];
      trilinear(a, lut, t, lod_a, u + mu * s, v + mv * s, tap);
#pragma unroll
      for (int j = 0; j < LANES; ++j) c[j] = k == 0 ? tap[j] : c[j] + tap[j];
    }
    const float inv = 1.0f / static_cast<float>(n_taps);
#pragma unroll
    for (int j = 0; j < LANES; ++j) c[j] = c[j] * inv;
  } else if (a.quality == Q_STOCHASTIC1) {
    const float n0 = blue_noise(a, pxf, pyf, 0);
    const float n1 = blue_noise(a, pxf, pyf, 3);
    const float n2 = blue_noise(a, pxf, pyf, 4);
    const int level =
        static_cast<int>(rintf(tmin(tclamp_min(lod + (n0 - 0.5f), 0.0f), t.max_lod)));
    const bool in = level_in_range(level);
    const int off = static_cast<int>(__ldg(t.offs + (in ? level : 0)));
    const int wl = in ? max(t.w0 >> level, 1) : t.w0;
    const int hl = in ? max(t.h0 >> level, 1) : t.h0;
    const float x = (u * static_cast<float>(wl) - 0.5f) + (n1 - 0.5f);
    const float y = (v * static_cast<float>(hl) - 0.5f) + (n2 - 0.5f);
    const int xi = wrap_addr(static_cast<int>(rintf(x)), wl, t.wrap);
    const int yi = wrap_addr(static_cast<int>(rintf(y)), hl, t.wrap);
    const int idx = min(max(static_cast<int>(static_cast<unsigned>(off) +
                                             static_cast<unsigned>(yi) * static_cast<unsigned>(wl) +
                                             static_cast<unsigned>(xi)), 0), a.tex_last);
    unpack(a, lut, idx, c);
  } else {
    float level_lod = lod;  // bilinear at the nearest mip
    if (a.quality == Q_STOCHASTIC) {
      const float n0 = blue_noise(a, pxf, pyf, 0);
      level_lod = tmin(tclamp_min(lod + (n0 - 0.5f), 0.0f), t.max_lod);
    }
    fetch_level(a, lut, t, static_cast<int>(rintf(level_lod)), u, v, c);
  }
}

// --------------------------------------------------------------------------
// Shadows (ops/shadow.py)

struct ShadowUV {
  float u, v, depth;
};

// project_to_shadow_uv.
__device__ __forceinline__ ShadowUV project(const float* vp, F3 p) {
  const float cx = mrow(vp, 0, p), cy = mrow(vp, 1, p), cz = mrow(vp, 2, p), w = mrow(vp, 3, p);
  const float inv_w = fabsf(w) > (float)1e-12 ? 1.0f / (w == 0.0f ? 1.0f : w) : 0.0f;
  return ShadowUV{(cx * inv_w) * 0.5f + 0.5f, 0.5f - (cy * inv_w) * 0.5f, cz * inv_w};
}

__device__ __forceinline__ float receiver_slope(float ndl) {
  return sqrtf(tclamp_min(1.0f - ndl * ndl, 0.0f)) / tclamp_min(ndl, (float)0.1);
}

__device__ __forceinline__ bool inside01(const ShadowUV& s) {
  return s.u > 0.0f && s.u < 1.0f && s.v > 0.0f && s.v < 1.0f;
}

// sample_vsm: one bilinear (or jittered nearest) moment tap, Chebyshev.
__device__ float sample_vsm(const Args& a, F3 p, float ndl, float pxf, float pyf) {
  const ShadowUV s = project(a.sun_vp, p);
  const float bias = tclamp(receiver_slope(ndl), 0.0f, 3.0f) * (float)2.0e-3 + (float)1.5e-3;
  const float d = s.depth + bias;
  const int size = a.vsm_size;
  const float fs = static_cast<float>(size), top = static_cast<float>(size - 1.0);
  const float x = tclamp(s.u * fs - 0.5f, 0.0f, top);
  const float y = tclamp(s.v * fs - 0.5f, 0.0f, top);
  const float2* flat = reinterpret_cast<const float2*>(a.moments);
  const long long last = static_cast<long long>(size) * size - 1;
  auto tap = [&](long long yi, long long xi) {
    return __ldg(flat + min(max(yi * size + xi, 0LL), last));
  };
  float mean, m2;
  if (a.sun_mode == SUN_VSM_STOCHASTIC) {
    const float n1 = blue_noise(a, pxf, pyf, 1), n2 = blue_noise(a, pxf, pyf, 2);
    const long long xi = static_cast<long long>(tclamp(rintf((x + n1) - 0.5f), 0.0f, top));
    const long long yi = static_cast<long long>(tclamp(rintf((y + n2) - 0.5f), 0.0f, top));
    const float2 m = tap(yi, xi);
    mean = m.x;
    m2 = m.y;
  } else {
    const float x0 = floorf(x), y0 = floorf(y);
    const float fx = x - x0, fy = y - y0;
    const float gx = 1.0f - fx, gy = 1.0f - fy;
    const long long x0i = static_cast<long long>(x0), y0i = static_cast<long long>(y0);
    const long long x1i = min(x0i + 1, static_cast<long long>(size - 1));
    const long long y1i = min(y0i + 1, static_cast<long long>(size - 1));
    const float2 m00 = tap(y0i, x0i), m10 = tap(y0i, x1i);
    const float2 m01 = tap(y1i, x0i), m11 = tap(y1i, x1i);
    mean = (m00.x * gx + m10.x * fx) * gy + (m01.x * gx + m11.x * fx) * fy;
    m2 = (m00.y * gx + m10.y * fx) * gy + (m01.y * gx + m11.y * fx) * fy;
  }
  const float var = tclamp_min(m2 - mean * mean, (float)1e-6);
  const float diff = mean - d;
  float pr = var / (var + diff * diff);
  pr = tclamp((pr - 0.25f) * (1.0f / 0.75f), 0.0f, 1.0f);
  const float lit = d >= mean ? 1.0f : pr;
  return inside01(s) ? lit : 1.0f;
}

// clamped_index: trunc(clamp(v, -2, n + 1)) clipped to [0, n - 1].
__device__ __forceinline__ long long clamped_index(float v, int n) {
  const long long i = static_cast<long long>(tclamp(v, -2.0f, static_cast<float>(n + 1.0)));
  return min(max(i, 0LL), static_cast<long long>(n - 1));
}

// sample_shadow_pcf: the Fibonacci disc of nearest depth taps.
__device__ float sample_pcf(const Args& a, const float* map, const float* vp, F3 p, float ndl) {
  const ShadowUV s = project(vp, p);
  const float biased =
      s.depth + (tclamp(receiver_slope(ndl), 0.0f, 3.0f) * (float)3.5e-3 + (float)1.5e-3);
  const int n = a.local_size;
  const float fs = static_cast<float>(n);
  float lit = 0.0f;
#pragma unroll
  for (int k = 0; k < PCF_TAPS; ++k) {
    const long long iy = clamped_index((s.v + a.pcf_taps[2 * k + 1]) * fs, n);
    const long long ix = clamped_index((s.u + a.pcf_taps[2 * k]) * fs, n);
    lit = lit + (biased >= __ldg(map + iy * n + ix) ? 1.0f : 0.0f);
  }
  return inside01(s) ? lit * (1.0f / static_cast<float>(PCF_TAPS)) : 1.0f;
}

// --------------------------------------------------------------------------
// The Filament BRDF (ops/brdf.py::evaluate), times <n.l>.

__device__ __forceinline__ float d_ggx(float n_dot_h, float alpha) {
  const float a2 = alpha * alpha;
  const float f = (n_dot_h * a2 - n_dot_h) * n_dot_h + 1.0f;
  return a2 / ((f * (float)PI) * f + (float)1e-20);
}

__device__ __forceinline__ F3 brdf(F3 l, F3 v, F3 n, F3 base, float roughness, float metallic,
                                   bool coat, float clearcoat, float clearcoat_roughness) {
  const F3 h = normalize3(add3(l, v));
  const float n_dot_v = fabsf(dot3(n, v)) + (float)1e-5;
  const float n_dot_l = tclamp(dot3(n, l), 0.0f, 1.0f);
  const float n_dot_h = tclamp(dot3(n, h), 0.0f, 1.0f);
  const float l_dot_h = tclamp(dot3(l, h), 0.0f, 1.0f);
  const float rough = tclamp_min(roughness, (float)0.045);
  const float alpha = rough * rough;
  const float om = 1.0f - metallic;
  const F3 f0 = add3(f3(om * (float)0.04, om * (float)0.04, om * (float)0.04),
                     scale3(base, metallic));
  const float p5 = powf(1.0f - l_dot_h, 5.0f);
  const F3 f = add3(f0, scale3(sub3(f3(1.0f, 1.0f, 1.0f), f0), p5));
  const float d = d_ggx(n_dot_h, alpha);
  const float a2 = alpha * alpha;
  const float lv = n_dot_l * sqrtf((n_dot_v - n_dot_v * a2) * n_dot_v + a2);
  const float ll = n_dot_v * sqrtf((n_dot_l - n_dot_l * a2) * n_dot_l + a2);
  const float vis = (1.0f / ((lv + ll) + (float)1e-20)) * 0.5f;
  const float dv = d * vis;
  const float inv_pi = 1.0f / (float)PI;
  F3 fr = add3(scale3(scale3(base, om), inv_pi), scale3(f, dv));
  if (coat) {
    const float ccr = tclamp(clearcoat_roughness, (float)0.1, 1.0f);
    const float dc = d_ggx(n_dot_h, ccr * ccr);
    const float vc = (1.0f / tclamp_min(l_dot_h * l_dot_h, (float)1e-6)) * 0.25f;
    const float fc = (p5 * (float)(1.0 - 0.04) + (float)0.04) * clearcoat;
    const float ofc = 1.0f - fc, cc = (dc * vc) * fc;
    fr = F3{fr.x * ofc + cc, fr.y * ofc + cc, fr.z * ofc + cc};
  }
  return scale3(fr, n_dot_l);
}

// to_screen: the point's pixel position under a view-projection.
__device__ __forceinline__ float2 to_screen(const float* vp, F3 p, float w_px, float h_px) {
  const float sx = mrow(vp, 0, p), sy = mrow(vp, 1, p), w = mrow(vp, 3, p);
  const float inv = fabsf(w) > (float)1e-8 ? 1.0f / (w == 0.0f ? 1.0f : w) : 0.0f;
  return make_float2(((sx * inv) * 0.5f + 0.5f) * w_px, (0.5f - (sy * inv) * 0.5f) * h_px);
}

// --------------------------------------------------------------------------

template <bool PREV, bool TAN>
__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y) packed_shading_kernel(const Args a) {
  using L = Layout<PREV, TAN>;
  __shared__ float lut[256];
  const int tid = threadIdx.y * BLOCK_X + threadIdx.x;
  lut[tid] = __ldg(a.srgb_lut + tid);
  __syncthreads();

  const int xg = blockIdx.x * BLOCK_X + threadIdx.x;
  const int yg = blockIdx.y * BLOCK_Y + threadIdx.y;
  if (xg >= a.grid_w || yg >= a.rows) return;
  const int i = yg * a.grid_w + xg;
  const int id = __ldg(a.vis + i);
  if (id < 0) {  // no triangle: zeros
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      a.color[3 * i + j] = 0.0f;
      a.normal[3 * i + j] = 0.0f;
      a.base_color[3 * i + j] = 0.0f;
    }
    a.velocity[2 * i] = 0.0f;
    a.velocity[2 * i + 1] = 0.0f;
    reinterpret_cast<float4*>(a.material)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    a.coverage[i] = 0;
    return;
  }
  const float4* row = reinterpret_cast<const float4*>(a.rec) +
                      static_cast<long long>(min(id, a.n_rec - 1)) * (L::REC / 4);
  const float* rowf = reinterpret_cast<const float*>(row);
  const float pxf = __ldg(a.px + i), pyf = __ldg(a.py + i);

  // Perspective-correct barycentrics here and at the +1 px neighbours.
  const float ax = lane<0>(row), ay = lane<1>(row), bx = lane<2>(row), by = lane<3>(row);
  const float cx = lane<4>(row), cy = lane<5>(row);
  const float iw0 = lane<6>(row), iw1 = lane<7>(row), iw2 = lane<8>(row);
  const float e0 = (cy - by) * (pxf - bx) - (cx - bx) * (pyf - by);
  const float e1 = (ay - cy) * (pxf - cx) - (ax - cx) * (pyf - cy);
  const float e2 = (by - ay) * (pxf - ax) - (bx - ax) * (pyf - ay);
  const float d0x = cy - by, d0y = -(cx - bx);
  const float d1x = ay - cy, d1y = -(ax - cx);
  const float d2x = by - ay, d2y = -(bx - ax);
  auto bary = [&](float f0, float f1, float f2, float* b) {
    const float p0 = f0 * iw0, p1 = f1 * iw1, p2 = f2 * iw2;
    const float den = (p0 + p1) + p2;
    const float inv = fabsf(den) > (float)1e-20 ? 1.0f / (den == 0.0f ? 1.0f : den) : 0.0f;
    b[0] = p0 * inv;
    b[1] = p1 * inv;
    b[2] = p2 * inv;
  };
  float b[3], bxn[3], byn[3];
  bary(e0, e1, e2, b);
  bary(e0 + d0x, e1 + d1x, e2 + d2x, bxn);
  bary(e0 + d0y, e1 + d1y, e2 + d2y, byn);

#define ARK_LANE(J) \
  ((b[0] * lane<9 + (J)>(row) + b[1] * lane<9 + L::CS + (J)>(row)) + \
   b[2] * lane<9 + 2 * L::CS + (J)>(row))
#define ARK_LANES3(J) f3(ARK_LANE(J), ARK_LANE((J) + 1), ARK_LANE((J) + 2))

  const F3 world_pos = ARK_LANES3(0);
  const F3 world_nrm = normalize3(ARK_LANES3(L::O_NRM));

  // Material record.
  constexpr int MO = L::MO;
  const F3 base_factor = f3(lane<MO + M_BASEF>(row), lane<MO + M_BASEF + 1>(row),
                            lane<MO + M_BASEF + 2>(row));
  const F3 emissive_factor = f3(lane<MO + M_EMIF>(row), lane<MO + M_EMIF + 1>(row),
                                lane<MO + M_EMIF + 2>(row));
  const float metallic_f = lane<MO + M_METAL>(row), roughness_f = lane<MO + M_ROUGH>(row);

  F3 base_color, emissive, shading_nrm = world_nrm;
  float roughness, metallic, occlusion;
  if (a.quality != Q_NONE) {
    constexpr int UV = 9 + L::O_UV;
    const float u0 = lane<UV>(row), u1 = lane<UV + L::CS>(row), u2 = lane<UV + 2 * L::CS>(row);
    const float v0 = lane<UV + 1>(row), v1 = lane<UV + 1 + L::CS>(row);
    const float v2 = lane<UV + 1 + 2 * L::CS>(row);
    const float u = (b[0] * u0 + b[1] * u1) + b[2] * u2;
    const float v = (b[0] * v0 + b[1] * v1) + b[2] * v2;
    const float gx0 = bxn[0] - b[0], gx1 = bxn[1] - b[1], gx2 = bxn[2] - b[2];
    const float gy0 = byn[0] - b[0], gy1 = byn[1] - b[1], gy2 = byn[2] - b[2];
    const float dux = (gx0 * u0 + gx1 * u1) + gx2 * u2, dvx = (gx0 * v0 + gx1 * v1) + gx2 * v2;
    const float duy = (gy0 * u0 + gy1 * u1) + gy2 * u2, dvy = (gy0 * v0 + gy1 * v1) + gy2 * v2;
    float c[LANES];
    sample_material(a, lut, rowf + MO + M_TEXMETA, u, v, dux, dvx, duy, dvy, pxf, pyf, c);
    base_color = mul3(f3(c[0], c[1], c[2]), base_factor);
    roughness = tclamp(c[6] * roughness_f, 0.0f, 1.0f);
    metallic = tclamp(c[7] * metallic_f, 0.0f, 1.0f);
    emissive = mul3(f3(c[8], c[9], c[10]), emissive_factor);
    occlusion = c[11];
    if constexpr (TAN) {
      const float nx = c[4] * 2.0f - 1.0f, ny = c[5] * 2.0f - 1.0f;
      const float nz = sqrtf(tclamp_min(1.0f - (nx * nx + ny * ny), 0.0f));
      const F3 world_tan = normalize3(ARK_LANES3(L::O_TAN));
      const float tanw = ARK_LANE(L::O_TAN + 3);
      const F3 cr = f3(world_nrm.y * world_tan.z - world_nrm.z * world_tan.y,
                       world_nrm.z * world_tan.x - world_nrm.x * world_tan.z,
                       world_nrm.x * world_tan.y - world_nrm.y * world_tan.x);
      const F3 bitan = scale3(cr, tanw);
      shading_nrm = normalize3(add3(add3(scale3(world_tan, nx), scale3(bitan, ny)),
                                    scale3(world_nrm, nz)));
    }
  } else {
    base_color = base_factor;
    roughness = tclamp(roughness_f, 0.0f, 1.0f);
    metallic = tclamp(metallic_f, 0.0f, 1.0f);
    emissive = emissive_factor;
    occlusion = 1.0f;
  }

  const float exposure = __ldg(a.exposure);
  const F3 view = normalize3(sub3(ld3(a.cam_pos), world_pos));
  if (lane<MO + M_DSIDED>(row) > 0.5f) {
    const float flip = tsign(dot3(shading_nrm, view));
    shading_nrm = scale3(shading_nrm, flip == 0.0f ? 1.0f : flip);
  }

  F3 color = scale3(emissive, exposure);
  const F3 sun_dir = ld3(a.sun_dir);
  const F3 sun_l = f3(-sun_dir.x, -sun_dir.y, -sun_dir.z);
  float shadow = 1.0f;
  if (a.sun_mode == SUN_MASK) {
    shadow = __ldg(a.shadow_mask + i);
  } else if (a.sun_mode != SUN_NONE) {
    shadow = sample_vsm(a, world_pos, tclamp(dot3(world_nrm, sun_l), 0.0f, 1.0f), pxf, pyf);
  }
  const F3 sun_fr = brdf(sun_l, view, shading_nrm, base_color, roughness, metallic, true,
                         lane<MO + M_CC>(row), lane<MO + M_CCR>(row));
  const float sun_valid = __ldg(a.sun_valid) ? 1.0f : 0.0f;
  const F3 sun_rad = scale3(ld3(a.sun_color), exposure);
  color = add3(color, scale3(scale3(mul3(sun_fr, sun_rad), shadow), sun_valid));

#pragma unroll 1
  for (int s = 0; s < a.n_spots; ++s) {
    const F3 to_l = sub3(ld3(a.spot_pos + 3 * s), world_pos);
    const float dist2 = tclamp_min(dot3(to_l, to_l), (float)1e-6);
    const F3 l = scale3(to_l, rsqrtf(dist2));
    const float cos_dir = -dot3(l, ld3(a.spot_dir + 3 * s));
    const float c_in = __ldg(a.spot_cone + 2 * s), c_out = __ldg(a.spot_cone + 2 * s + 1);
    const float t = tclamp((cos_dir - c_out) / tclamp_min(c_in - c_out, (float)1e-4), 0.0f, 1.0f);
    const long long angle = static_cast<long long>(
        (acosf(tclamp(cos_dir, -1.0f, 1.0f)) * (1.0f / (float)PI)) * 255.0f);
    const long long ai = min(max(angle, 0LL), 255LL);
    float falloff = ((t * t) * __ldg(a.spot_ies + 256 * s + ai)) / dist2;
    if (a.rt_spot != nullptr) {
      falloff = falloff * __ldg(a.rt_spot + static_cast<long long>(s) * a.n + i);
    } else if ((a.spot_pcf >> s) & 1) {
      const float ndl = tclamp(dot3(world_nrm, l), 0.0f, 1.0f);
      const long long tile = static_cast<long long>(a.local_size) * a.local_size;
      falloff = falloff * sample_pcf(a, a.local_maps + s * tile, a.spot_vp + 16 * s,
                                     world_pos, ndl);
    }
    const F3 fr = brdf(l, view, shading_nrm, base_color, roughness, metallic, false, 0.0f, 0.0f);
    const F3 sc = scale3(ld3(a.spot_color + 3 * s), exposure);
    color = add3(color, scale3(mul3(fr, sc), falloff));
  }
#pragma unroll 1
  for (int q = 0; q < a.n_points; ++q) {
    const F3 to_l = sub3(ld3(a.point_pos + 3 * q), world_pos);
    const float dist2 = tclamp_min(dot3(to_l, to_l), (float)1e-6);
    const F3 l = scale3(to_l, rsqrtf(dist2));
    const F3 fr = brdf(l, view, shading_nrm, base_color, roughness, metallic, false, 0.0f, 0.0f);
    const F3 pc = scale3(ld3(a.point_color + 3 * q), exposure);
    F3 add = mul3(fr, pc);
    add = f3(add.x / dist2, add.y / dist2, add.z / dist2);
    if (a.rt_point != nullptr)
      add = scale3(add, __ldg(a.rt_point + static_cast<long long>(q) * a.n + i));
    color = add3(color, add);
  }

  F3 prev_pos = world_pos;
  if constexpr (PREV) prev_pos = ARK_LANES3(L::O_PREV);
  const float2 cur = to_screen(a.vp_cur, world_pos, a.frame_w, a.frame_h);
  const float2 prev = to_screen(a.vp_prev, prev_pos, a.frame_w, a.frame_h);
#undef ARK_LANES3
#undef ARK_LANE

  float* o = a.color + 3 * i;
  o[0] = color.x;
  o[1] = color.y;
  o[2] = color.z;
  o = a.normal + 3 * i;
  o[0] = shading_nrm.x;
  o[1] = shading_nrm.y;
  o[2] = shading_nrm.z;
  o = a.base_color + 3 * i;
  o[0] = base_color.x;
  o[1] = base_color.y;
  o[2] = base_color.z;
  o = a.velocity + 2 * i;
  o[0] = cur.x - prev.x;
  o[1] = cur.y - prev.y;
  reinterpret_cast<float4*>(a.material)[i] =
      make_float4(roughness, metallic, occlusion, lane<MO + M_SSS>(row));
  a.coverage[i] = 1;
}

template <bool PREV, bool TAN>
bool layout_matches(const Args& a) {
  return a.rec_size == Layout<PREV, TAN>::REC;
}

}  // namespace

extern "C" int packed_shading_args_size() { return static_cast<int>(sizeof(Args)); }

// Shade the n pixels of `args` (an Args: rows rows of grid_w) on `stream`, without
// synchronising; returns the launch's cudaGetLastError()
// (cudaErrorInvalidValue for a size, layout or alignment it does not take).
extern "C" int packed_shading_launch(const void* args, void* stream) {
  const Args& a = *static_cast<const Args*>(args);
  if (a.grid_w <= 0 || a.rows < 0 || static_cast<long long>(a.rows) * a.grid_w != a.n ||
      a.rows > 65535 * BLOCK_Y || a.n_rec <= 0 || a.n_spots > 31 ||
      (reinterpret_cast<uintptr_t>(a.rec) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(a.material) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.n == 0) return 0;
  const dim3 block(BLOCK_X, BLOCK_Y);
  const dim3 grid((a.grid_w + BLOCK_X - 1) / BLOCK_X, (a.rows + BLOCK_Y - 1) / BLOCK_Y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.has_prev && a.has_tan && layout_matches<true, true>(a))
    packed_shading_kernel<true, true><<<grid, block, 0, s>>>(a);
  else if (a.has_prev && !a.has_tan && layout_matches<true, false>(a))
    packed_shading_kernel<true, false><<<grid, block, 0, s>>>(a);
  else if (!a.has_prev && a.has_tan && layout_matches<false, true>(a))
    packed_shading_kernel<false, true><<<grid, block, 0, s>>>(a);
  else if (!a.has_prev && !a.has_tan && layout_matches<false, false>(a))
    packed_shading_kernel<false, false><<<grid, block, 0, s>>>(a);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
