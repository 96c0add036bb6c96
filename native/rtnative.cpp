// Native runtime library for win32_raytracer_tpu.
//
// Three facilities, exposed over a C ABI (loaded via ctypes from
// win32_raytracer_tpu/io/native.py):
//
//   1. rt_encode_bmp    — 24bpp BMP encoder (the framework's native image-IO
//                         tier, standing in for the reference's vendored
//                         stb_image_write path, win32-raytracer/Game.cpp:27-43).
//   2. rt_lcg_stream    — the reference's SSE "fast rand" LCG as a scalar
//                         stream generator (RayTracer.cpp:31-66 semantics).
//   3. rt_oracle_render — a scalar CPU path tracer reproducing the exact
//                         tracing semantics of the reference renderer
//                         (RayTracer.cpp:392-959), quirks included.  It is
//                         the golden-image oracle for the JAX renderer: it
//                         follows the same material rules, constants, and
//                         RNG consumption pattern as the C++ original, so
//                         tests can validate the JAX implementation against
//                         reference behavior without a Windows build.
//
// This file is a fresh implementation written for this framework — scalar,
// iterative where possible, no SIMD — not a copy of the reference sources;
// reference file:line citations mark which behavior each piece reproduces.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>

// ---------------------------------------------------------------------------
// 1. BMP encoder (24bpp, bottom-up, BGR; matches stb_image_write's layout)
// ---------------------------------------------------------------------------

static void put_u16(uint8_t* p, uint16_t v) { p[0] = v & 0xFF; p[1] = v >> 8; }
static void put_u32(uint8_t* p, uint32_t v) {
  p[0] = v & 0xFF; p[1] = (v >> 8) & 0xFF; p[2] = (v >> 16) & 0xFF; p[3] = v >> 24;
}

// rgb: [h*w*3] u8 top-down RGB.  Returns bytes written, or -1 if cap too small.
extern "C" long long rt_encode_bmp(const uint8_t* rgb, int w, int h, uint8_t* out,
                        long long cap) {
  const int row = (w * 3 + 3) & ~3;
  const long long total = 14 + 40 + (long long)row * h;
  if (cap < total || w <= 0 || h <= 0) return -1;

  std::memset(out, 0, 14 + 40);
  out[0] = 'B'; out[1] = 'M';
  put_u32(out + 2, (uint32_t)total);
  put_u32(out + 10, 14 + 40);
  put_u32(out + 14, 40);
  put_u32(out + 18, (uint32_t)w);
  put_u32(out + 22, (uint32_t)h);
  put_u16(out + 26, 1);
  put_u16(out + 28, 24);
  put_u32(out + 34, (uint32_t)(row * h));
  put_u32(out + 38, 2835);
  put_u32(out + 42, 2835);

  uint8_t* dst = out + 54;
  for (int y = 0; y < h; ++y) {
    const uint8_t* src = rgb + (long long)(h - 1 - y) * w * 3;  // bottom-up
    uint8_t* d = dst + (long long)y * row;
    for (int x = 0; x < w; ++x) {
      d[x * 3 + 0] = src[x * 3 + 2];  // B
      d[x * 3 + 1] = src[x * 3 + 1];  // G
      d[x * 3 + 2] = src[x * 3 + 0];  // R
    }
    for (int p = w * 3; p < row; ++p) d[p] = 0;
  }
  return total;
}

// ---------------------------------------------------------------------------
// 2. Reference LCG (RayTracer.cpp:31-66 semantics, scalar-lane form)
// ---------------------------------------------------------------------------

struct Lcg {
  // Lane state; init (seed+1, seed, seed+1, seed) per _mm_set_epi32(seed,
  // seed+1, seed, seed+1) — RayTracer.cpp:63-66.
  uint32_t s[4];

  explicit Lcg(uint32_t seed) {
    s[0] = seed + 1; s[1] = seed; s[2] = seed + 1; s[3] = seed;
  }

  // One rand_sse step: four independent 32-bit LCG lanes (the mul_epu32
  // shuffle dance of RayTracer.cpp:31-48 reduces to exactly this), followed
  // by the [0,1) float conversion of RayTracer.cpp:49-53.
  void rand4(float r[4]) {
    static const uint32_t MUL[4] = {214013u, 17405u, 214013u, 69069u};
    static const uint32_t ADD[4] = {2531011u, 10395331u, 13737667u, 1u};
    for (int i = 0; i < 4; ++i) {
      s[i] = s[i] * MUL[i] + ADD[i];
      // cvtepi32_ps(INT_MAX) rounds to 2^31 in f32.
      r[i] = ((float)(int32_t)s[i] / 2147483648.0f + 1.0f) * 0.5f;
    }
  }
};

extern "C" void rt_lcg_stream(uint32_t seed, int n, float* out) {
  Lcg lcg(seed);
  for (int i = 0; i < n; ++i) lcg.rand4(out + 4 * i);
}

// ---------------------------------------------------------------------------
// 3. Scalar oracle renderer (reference semantics, RayTracer.cpp:392-959)
// ---------------------------------------------------------------------------

struct V3 {
  float x, y, z;
};
static V3 v3(float x, float y, float z) { return {x, y, z}; }
static V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
static V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static V3 operator-(V3 a) { return {-a.x, -a.y, -a.z}; }
static V3 operator*(float s, V3 a) { return {s * a.x, s * a.y, s * a.z}; }
static float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
static V3 norm(V3 a) {
  float l = std::sqrt(dot(a, a));
  return l > 0 ? (1.0f / l) * a : a;
}
static V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

struct RtScene {
  int n;
  const float* c1;      // [n*3]
  const float* c2;      // [n*3]
  const float* t1;      // [n]
  const float* t2;      // [n]
  const float* radius;  // [n]
  const int* mat_id;    // [n] 0=lambertian 1=metal 2=dielectric
  const float* albedo;  // [n*3]
  const float* fuzz;    // [n]
  const float* ior;     // [n]
};

struct RtCamera {
  float look_from[3], look_to[3], up[3];
  float vfov_deg, aspect, aperture, focus_dist;
  float shutter_open, shutter_close;
};

struct RtOpts {
  int width, height, spp, max_depth;
  uint32_t seed;
  int deterministic;       // 1: pixel centers, no lens/time jitter, no reflect draw
  float reflect_thres;     // reference: 0.05 (RayTracer.cpp:661)
  float refract_bias;      // reference: 2.0  (RayTracer.cpp:168)
  int schlick_ni_over_nt;  // reference: 1    (RayTracer.cpp:658)
  int lane_truncate;       // 0 = off; 8 = emulate the AVX size%8 dropout
};

static constexpr float kEps = 1e-5f;     // RayTracer.cpp:13
static constexpr float kMinT = 0.001f;   // RayTracer.cpp:430

// Rejection samplers, exact loop shape of RayTracer.cpp:187-216.
static V3 rand_in_unit_sphere(Lcg& lcg) {
  float r[4];
  V3 p;
  do {
    lcg.rand4(r);
    p = 2.0f * v3(r[0], r[1], r[2]) - v3(1, 1, 1);
  } while (dot(p, p) >= 1.0f);
  return p;
}
static V3 rand_on_unit_disc(Lcg& lcg) {
  float r[4];
  V3 p;
  do {
    lcg.rand4(r);
    p = 2.0f * v3(r[0], r[1], 0.0f) - v3(1, 1, 0);
  } while (dot(p, p) >= 1.0f);
  return p;
}

static V3 reflect(V3 in, V3 n) { return in - (2.0f * dot(in, n)) * n; }  // RayTracer.cpp:146-152

// RayTracer.cpp:155-175 (incl. the 2.0 discriminant via opts.refract_bias).
static bool refract(V3 dir, V3 n, float ni_over_nt, float bias, V3* out) {
  V3 nd = norm(dir);
  float dt = dot(nd, n);
  float disc = bias - ni_over_nt * ni_over_nt * (1.0f - dt * dt);
  if (disc > 0.0f) {
    *out = ni_over_nt * (nd - dt * n) - std::sqrt(disc) * n;
    return true;
  }
  return false;
}

static float schlick(float cosine, float refr_idx) {  // RayTracer.cpp:178-184
  float r0 = (1.0f - refr_idx) / (1.0f + refr_idx);
  r0 = r0 * r0;
  return r0 + (1.0f - r0) * std::pow(1.0f - cosine, 5.0f);
}

struct Hit {
  float t;
  int idx;
  V3 point, normal;
};

// Nearest-hit sweep, semantics of RayTracer.cpp:433-589 (near root only,
// disc >= 0, t in (kMinT, best), earliest index wins ties).  When
// lane_truncate = L > 0, only the first n - (n % L) spheres are tested,
// emulating the reference's remainder dropout (RayTracer.cpp:432-434).
static bool nearest_hit(const RtScene& sc, V3 o, V3 d, float time,
                        int lane_truncate, Hit* out) {
  float best = std::numeric_limits<float>::max();
  int best_i = -1;
  int count = sc.n;
  if (lane_truncate > 0) count -= count % lane_truncate;
  const float a = dot(d, d);
  for (int i = 0; i < count; ++i) {
    float lerp = (time - sc.t1[i]) / (sc.t2[i] - sc.t1[i]);
    V3 c1 = v3(sc.c1[3 * i], sc.c1[3 * i + 1], sc.c1[3 * i + 2]);
    V3 c2 = v3(sc.c2[3 * i], sc.c2[3 * i + 1], sc.c2[3 * i + 2]);
    V3 c = c1 + lerp * (c2 - c1);
    V3 oc = o - c;
    float b = 2.0f * dot(d, oc);
    float cc = dot(oc, oc) - sc.radius[i] * sc.radius[i];
    float disc = b * b - 4.0f * a * cc;
    if (disc < 0.0f) continue;
    float t = (-b - std::sqrt(disc)) / (2.0f * a);
    if (t > kMinT && t < best) {
      best = t;
      best_i = i;
    }
  }
  if (best_i < 0) return false;
  float lerp = (time - sc.t1[best_i]) / (sc.t2[best_i] - sc.t1[best_i]);
  V3 c1 = v3(sc.c1[3 * best_i], sc.c1[3 * best_i + 1], sc.c1[3 * best_i + 2]);
  V3 c2 = v3(sc.c2[3 * best_i], sc.c2[3 * best_i + 1], sc.c2[3 * best_i + 2]);
  V3 c = c1 + lerp * (c2 - c1);
  out->t = best;
  out->idx = best_i;
  out->point = o + best * d;
  out->normal = (1.0f / sc.radius[best_i]) * (out->point - c);
  return true;
}

// Iterative form of the recursive getColor (RayTracer.cpp:392-704).  A path
// accumulates a throughput product; termination matches the reference:
// depth > max_depth -> black, metal absorb -> black, miss -> sky gradient.
static V3 trace_path(const RtScene& sc, const RtOpts& op, Lcg& lcg, V3 o, V3 d,
                     float time) {
  V3 thr = v3(1, 1, 1);
  for (int depth = 0; depth <= op.max_depth; ++depth) {
    Hit h;
    if (!nearest_hit(sc, o, d, time, op.lane_truncate, &h)) {
      // Sky gradient on normalized dir.y (RayTracer.cpp:690-701).
      float t = 0.5f * (norm(d).y + 1.0f);
      V3 sky = (1.0f - t) * v3(1, 1, 1) + t * v3(0.5f, 0.7f, 1.0f);
      return v3(thr.x * sky.x, thr.y * sky.y, thr.z * sky.z);
    }
    int m = sc.mat_id[h.idx];
    V3 alb = v3(sc.albedo[3 * h.idx], sc.albedo[3 * h.idx + 1],
                sc.albedo[3 * h.idx + 2]);
    if (m == 0) {  // Lambertian (RayTracer.cpp:604-617)
      V3 target = h.point + h.normal + rand_in_unit_sphere(lcg);
      V3 adj = h.point + kEps * h.normal;
      o = adj;
      d = target - adj;
      thr = v3(thr.x * alb.x, thr.y * alb.y, thr.z * alb.z);
    } else if (m == 1) {  // Metal (RayTracer.cpp:618-635)
      V3 rd = reflect(d, h.normal) + sc.fuzz[h.idx] * rand_in_unit_sphere(lcg);
      if (dot(rd, h.normal) <= 0.0f) return v3(0, 0, 0);  // absorbed
      o = h.point + kEps * h.normal;
      d = rd;
      thr = v3(thr.x * alb.x, thr.y * alb.y, thr.z * alb.z);
    } else {  // Dielectric (RayTracer.cpp:636-688); attenuation (1,1,1)
      V3 to_light = norm(-d);
      float inv_dot = dot(to_light, h.normal);
      bool entering = inv_dot > 0.0f;
      float ni_over_nt = entering ? 1.0f / sc.ior[h.idx] : sc.ior[h.idx];
      V3 rfn = entering ? h.normal : -h.normal;
      V3 offset = kEps * h.normal;
      V3 refract_off = entering ? -offset : offset;

      float cosine = dot(to_light, rfn);
      float prob =
          schlick(cosine, op.schlick_ni_over_nt ? ni_over_nt : sc.ior[h.idx]);
      float rdraw = 0.5f;
      if (!op.deterministic) {
        float r[4];
        lcg.rand4(r);
        rdraw = r[0];
      }
      if (op.reflect_thres + rdraw < prob) {
        d = reflect(d, h.normal);
        o = h.point - refract_off;
      } else {
        V3 refr;
        if (refract(-d, rfn, ni_over_nt, op.refract_bias, &refr)) {
          o = h.point + refract_off;
          d = refr;
        } else {
          d = reflect(d, rfn);
          o = h.point - refract_off;
        }
      }
    }
  }
  return v3(0, 0, 0);  // depth exhausted (RayTracer.cpp:399-402)
}

// Camera basis per RayTracer.cpp:237-274; ray gen per RayTracer.cpp:276-288.
struct CamBasis {
  V3 origin, llc, horiz, vert, right, up;
  float lens_radius, shut_open, shut_close;
};

static CamBasis make_cam(const RtCamera& c) {
  CamBasis cb;
  cb.lens_radius = c.aperture / 2.0f;
  float theta = c.vfov_deg * 3.14159265358979323846f / 180.0f;
  float half_h = std::tan(theta / 2.0f);
  float half_w = c.aspect * half_h;
  V3 from = v3(c.look_from[0], c.look_from[1], c.look_from[2]);
  V3 to = v3(c.look_to[0], c.look_to[1], c.look_to[2]);
  V3 up = v3(c.up[0], c.up[1], c.up[2]);
  V3 look = norm(to - from);
  cb.right = norm(cross(look, up));
  cb.up = norm(cross(cb.right, look));
  cb.origin = from;
  float f = c.focus_dist;
  cb.llc = cb.origin + f * look - (half_w * f) * cb.right - (half_h * f) * cb.up;
  cb.horiz = (2.0f * half_w * f) * cb.right;
  cb.vert = (2.0f * half_h * f) * cb.up;
  cb.shut_open = c.shutter_open;
  cb.shut_close = c.shutter_close;
  return cb;
}

// Renders to linear (pre-gamma) f32 RGB [h*w*3].  Per-image LCG context,
// seeded like every reference ThreadContext (RayTracer.cpp:27, 903).
extern "C" void rt_oracle_render_f32(const RtScene* sc, const RtCamera* cam,
                          const RtOpts* op, float* out) {
  Lcg lcg(op->seed);
  CamBasis cb = make_cam(*cam);
  const int W = op->width, H = op->height, S = op->spp;
  for (int y = 0; y < H; ++y) {
    for (int x = 0; x < W; ++x) {
      V3 acc = v3(0, 0, 0);
      for (int s = 0; s < S; ++s) {
        float u, v, time;
        V3 offset = v3(0, 0, 0);
        if (op->deterministic) {
          u = ((float)x + 0.5f) / W;
          v = ((float)(H - y) + 0.5f) / H;
          time = cb.shut_open;
        } else {
          float r[4];
          lcg.rand4(r);
          // Jitter (RayTracer.cpp:941-943): note H - y, not H - 1 - y.
          u = ((float)x + r[0]) / W;
          v = ((float)(H - y) + r[1]) / H;
          lcg.rand4(r);
          time = cb.shut_open + (cb.shut_close - cb.shut_open) * r[0];
          V3 lens = cb.lens_radius * rand_on_unit_disc(lcg);
          offset = lens.x * cb.right + lens.y * cb.up;
        }
        V3 o = cb.origin + offset;
        V3 d = (cb.llc + u * cb.horiz + v * cb.vert) - o;
        V3 col = trace_path(*sc, *op, lcg, o, d, time);
        acc = acc + col;
      }
      out[3 * (y * W + x) + 0] = acc.x / S;
      out[3 * (y * W + x) + 1] = acc.y / S;
      out[3 * (y * W + x) + 2] = acc.z / S;
    }
  }
}

// Tonemapped u8 output: sqrt gamma + 255.99 truncation (RayTracer.cpp:946-954).
extern "C" void rt_oracle_render(const RtScene* sc, const RtCamera* cam, const RtOpts* op,
                      uint8_t* out) {
  const int W = op->width, H = op->height;
  float* lin = new float[(size_t)W * H * 3];
  rt_oracle_render_f32(sc, cam, op, lin);
  for (long long i = 0; i < (long long)W * H * 3; ++i) {
    float c = std::sqrt(lin[i] < 0 ? 0.0f : lin[i]);
    float q = 255.99f * c;
    out[i] = (uint8_t)(q < 0 ? 0 : (q > 255 ? 255 : q));
  }
  delete[] lin;
}

