/* Host JPEG decoder with a plain C interface (loaded with ctypes by
 * arkoserenderer_torch/assets/imagecodec.py).
 *
 * Not a GPU kernel: it runs on the host where the reference package calls
 * PIL (Image.open(...).convert("RGBA")), and gives the pixels libjpeg-turbo
 * gives with its default decompression settings, so both packages import a
 * glTF's textures to the same bytes:
 *   - the islow integer IDCT (jidctint.c) with libjpeg's post-IDCT
 *     range-limit table;
 *   - "fancy" triangle-filter upsampling of h2v1, h1v2 and h2v2 chroma
 *     (jdsample.c), with the first and last sample rows replicated as the
 *     main controller's context rows replicate them;
 *   - the fixed-point YCbCr -> RGB tables of jdcolor.c.
 * Block smoothing (jdcoefct.c) runs only on a progressive file whose scans
 * leave one of the first nine AC coefficients inexact; such a file is
 * refused rather than decoded differently.
 *
 * Formats: baseline (SOF0), extended Huffman (SOF1) and progressive (SOF2)
 * 8-bit JPEG with one or three components, sampling factors 1 or 2, and
 * restart intervals. Colour: greyscale, or YCbCr (JFIF, Adobe transform 1,
 * or component ids that do not say RGB). Arithmetic coding, 12-bit samples,
 * lossless and hierarchical frames, CMYK and RGB are refused by name.
 *
 *   int jpeg_header(data, len, &width, &height, err, errlen)
 *   int jpeg_decode_rgba(data, len, out, width, height, err, errlen)
 *
 * out holds height * width * 4 bytes: R, G, B and 255 (greyscale repeated
 * into R, G and B). Both return 0 on success, 1 for a file of a kind not
 * supported, 2 for a corrupt file, with a message in err.
 */

#include <setjmp.h>
#include <stdarg.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#ifdef __cplusplus
#define API extern "C"
#else
#define API
#endif

enum { UNSUPPORTED = 1, CORRUPT = 2 };

/* Zigzag index -> natural (row-major) index, padded for runs past 63. */
static const int NATURAL[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

#define LOOK_BITS 9

typedef struct {
  int defined;
  uint8_t vals[256];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint16_t look[1 << LOOK_BITS]; /* (length << 8) | symbol; length 0: longer code */
} huff_t;

typedef struct {
  int id, h, v, tq;
  int bw, bh;   /* blocks held: the MCU-padded grid */
  int wib, hib; /* blocks of a non-interleaved scan */
  int dw, dh;   /* samples of the downsampled plane */
  int16_t *coef; /* bw * bh blocks of 64, natural order */
  uint16_t qt[64];
  int q_latched;
  int coef_bits[64]; /* progressive: last Al by zigzag index, -1 never sent */
  int dc_pred;
  uint8_t *plane; /* bw * 8 by bh * 8 samples after the IDCT */
} comp_t;

typedef struct {
  const uint8_t *data;
  size_t len, pos;
  uint16_t qt[4][64];
  int qt_defined[4];
  huff_t dc[4], ac[4];
  comp_t comp[3];
  int ncomp, width, height, progressive, sof_seen, hmax, vmax, mcux, mcuy;
  int restart_interval, jfif, adobe, adobe_transform;
  uint64_t acc; /* bit reader: next bits at the top */
  int nbits, marker_hit;
  int eobrun;
  uint8_t *full[3]; /* planes at full resolution, row stride full_w */
  int full_w[3];
  char *err;
  int errlen;
  jmp_buf jb;
} dec_t;

static void fail(dec_t *d, int code, const char *fmt, ...) {
  if (d->err && d->errlen > 0) {
    va_list ap;
    va_start(ap, fmt);
    vsnprintf(d->err, (size_t)d->errlen, fmt, ap);
    va_end(ap);
  }
  longjmp(d->jb, code);
}

static int byte_at(dec_t *d) {
  if (d->pos >= d->len) fail(d, CORRUPT, "corrupt JPEG: unexpected end of file");
  return d->data[d->pos++];
}

static int u16_at(dec_t *d) {
  int hi = byte_at(d);
  return (hi << 8) | byte_at(d);
}

/* -- Huffman tables (jdhuff.c jpeg_make_d_derived_tbl) --------------------- */

static void build_huff(dec_t *d, huff_t *t, const uint8_t counts[17]) {
  int huffsize[257], huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; l++)
    for (int i = 0; i < counts[l]; i++) huffsize[p++] = l;
  huffsize[p] = 0;
  int code = 0, si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (code >= (1 << si)) fail(d, CORRUPT, "corrupt JPEG: bad Huffman table");
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (counts[l]) {
      t->valoffset[l] = p - huffcode[p];
      p += counts[l];
      t->maxcode[l] = huffcode[p - 1];
    } else {
      t->maxcode[l] = -1;
    }
  }
  t->maxcode[17] = 0xFFFFF;
  memset(t->look, 0, sizeof(t->look));
  p = 0;
  for (int l = 1; l <= LOOK_BITS; l++) {
    for (int i = 0; i < counts[l]; i++, p++) {
      int lookbits = huffcode[p] << (LOOK_BITS - l);
      for (int c = 0; c < (1 << (LOOK_BITS - l)); c++)
        t->look[lookbits + c] = (uint16_t)((l << 8) | t->vals[p]);
    }
  }
  t->defined = 1;
}

/* -- Bit reader over the entropy-coded segment ------------------------------ */

static void fill_bits(dec_t *d) {
  while (d->nbits <= 56) {
    int c = 0;
    if (!d->marker_hit && d->pos < d->len) {
      c = d->data[d->pos];
      if (c == 0xFF) {
        size_t q = d->pos + 1;
        while (q < d->len && d->data[q] == 0xFF) q++; /* fill bytes */
        if (q < d->len && d->data[q] == 0x00) {
          d->pos = q + 1; /* stuffed 0xFF */
        } else {
          d->marker_hit = 1; /* a marker: feed zeros from here, as libjpeg */
          d->pos = q - 1;
          c = 0;
        }
      } else {
        d->pos++;
      }
    }
    d->acc |= (uint64_t)c << (56 - d->nbits);
    d->nbits += 8;
  }
}

static int get_bits(dec_t *d, int n) {
  if (n == 0) return 0;
  if (d->nbits < n) fill_bits(d);
  int v = (int)(d->acc >> (64 - n));
  d->acc <<= n;
  d->nbits -= n;
  return v;
}

static int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v + (int)((-1u) << s) + 1 : v;
}

static int decode_huff(dec_t *d, const huff_t *t) {
  if (d->nbits < 16) fill_bits(d);
  int peek = (int)(d->acc >> 48);
  int e = t->look[peek >> (16 - LOOK_BITS)];
  if (e >> 8) {
    int l = e >> 8;
    d->acc <<= l;
    d->nbits -= l;
    return e & 0xFF;
  }
  int l = LOOK_BITS + 1;
  int code = peek >> (16 - l);
  while (l <= 16 && code > t->maxcode[l]) {
    l++;
    code = peek >> (16 - l);
  }
  if (l > 16) fail(d, CORRUPT, "corrupt JPEG: bad Huffman code");
  d->acc <<= l;
  d->nbits -= l;
  return t->vals[(code + t->valoffset[l]) & 0xFF];
}

static void reset_bits(dec_t *d) {
  d->acc = 0;
  d->nbits = 0;
  d->marker_hit = 0;
}

/* At the end of a restart interval: drop the bits left, read RSTn. */
static void process_restart(dec_t *d) {
  reset_bits(d);
  while (d->pos + 1 < d->len) {
    if (d->data[d->pos] == 0xFF && d->data[d->pos + 1] >= 0xD0 && d->data[d->pos + 1] <= 0xD7) {
      d->pos += 2;
      for (int i = 0; i < d->ncomp; i++) d->comp[i].dc_pred = 0;
      d->eobrun = 0;
      return;
    }
    d->pos++;
  }
  fail(d, CORRUPT, "corrupt JPEG: missing restart marker");
}

/* -- Markers ---------------------------------------------------------------- */

static void read_dqt(dec_t *d) {
  int len = u16_at(d) - 2;
  while (len > 0) {
    int pq_tq = byte_at(d);
    int pq = pq_tq >> 4, tq = pq_tq & 15;
    if (tq > 3 || pq > 1) fail(d, CORRUPT, "corrupt JPEG: bad DQT");
    for (int i = 0; i < 64; i++)
      d->qt[tq][NATURAL[i]] = (uint16_t)(pq ? u16_at(d) : byte_at(d));
    d->qt_defined[tq] = 1;
    len -= 1 + 64 * (pq + 1);
  }
  if (len != 0) fail(d, CORRUPT, "corrupt JPEG: bad DQT length");
}

static void read_dht(dec_t *d) {
  int len = u16_at(d) - 2;
  while (len > 0) {
    int tc_th = byte_at(d);
    int tc = tc_th >> 4, th = tc_th & 15;
    if (tc > 1 || th > 3) fail(d, CORRUPT, "corrupt JPEG: bad DHT");
    uint8_t counts[17] = {0};
    int n = 0;
    for (int l = 1; l <= 16; l++) {
      counts[l] = (uint8_t)byte_at(d);
      n += counts[l];
    }
    if (n > 256) fail(d, CORRUPT, "corrupt JPEG: bad DHT");
    huff_t *t = tc ? &d->ac[th] : &d->dc[th];
    for (int i = 0; i < n; i++) t->vals[i] = (uint8_t)byte_at(d);
    build_huff(d, t, counts);
    len -= 17 + n;
  }
  if (len != 0) fail(d, CORRUPT, "corrupt JPEG: bad DHT length");
}

static void read_sof(dec_t *d, int progressive) {
  u16_at(d);
  int precision = byte_at(d);
  if (precision != 8)
    fail(d, UNSUPPORTED, "%d-bit JPEG samples are not supported (8-bit only)", precision);
  d->height = u16_at(d);
  d->width = u16_at(d);
  d->ncomp = byte_at(d);
  if (d->height == 0) fail(d, UNSUPPORTED, "JPEG with a DNL-defined height is not supported");
  if (d->width == 0) fail(d, CORRUPT, "corrupt JPEG: zero width");
  if (d->ncomp == 4) fail(d, UNSUPPORTED, "CMYK / YCCK JPEG (4 components) is not supported");
  if (d->ncomp != 1 && d->ncomp != 3)
    fail(d, UNSUPPORTED, "JPEG with %d components is not supported", d->ncomp);
  d->hmax = d->vmax = 1;
  for (int i = 0; i < d->ncomp; i++) {
    comp_t *c = &d->comp[i];
    c->id = byte_at(d);
    int hv = byte_at(d);
    c->h = hv >> 4;
    c->v = hv & 15;
    c->tq = byte_at(d) & 3;
    if (c->h < 1 || c->h > 2 || c->v < 1 || c->v > 2)
      fail(d, UNSUPPORTED, "JPEG sampling factor %dx%d is not supported (1 or 2 only)", c->h, c->v);
    if (c->h > d->hmax) d->hmax = c->h;
    if (c->v > d->vmax) d->vmax = c->v;
  }
  d->mcux = (d->width + 8 * d->hmax - 1) / (8 * d->hmax);
  d->mcuy = (d->height + 8 * d->vmax - 1) / (8 * d->vmax);
  for (int i = 0; i < d->ncomp; i++) {
    comp_t *c = &d->comp[i];
    c->bw = d->mcux * c->h;
    c->bh = d->mcuy * c->v;
    c->dw = (int)(((long)d->width * c->h + d->hmax - 1) / d->hmax);
    c->dh = (int)(((long)d->height * c->v + d->vmax - 1) / d->vmax);
    c->wib = (c->dw + 7) / 8;
    c->hib = (c->dh + 7) / 8;
    for (int k = 0; k < 64; k++) c->coef_bits[k] = -1;
  }
  d->progressive = progressive;
  d->sof_seen = 1;
}

/* -- Scans ------------------------------------------------------------------ */

static void decode_block_baseline(dec_t *d, comp_t *c, int16_t *blk, int td, int ta) {
  const huff_t *dct = &d->dc[td], *act = &d->ac[ta];
  int s = decode_huff(d, dct);
  int diff = s ? extend(get_bits(d, s), s) : 0;
  c->dc_pred += diff;
  blk[0] = (int16_t)c->dc_pred;
  for (int k = 1; k < 64; k++) {
    int rs = decode_huff(d, act);
    int r = rs >> 4;
    s = rs & 15;
    if (s) {
      k += r;
      int v = extend(get_bits(d, s), s);
      blk[NATURAL[k]] = (int16_t)v;
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
}

static void decode_dc_first(dec_t *d, comp_t *c, int16_t *blk, int td, int al) {
  int s = decode_huff(d, &d->dc[td]);
  int diff = s ? extend(get_bits(d, s), s) : 0;
  c->dc_pred += diff;
  blk[0] = (int16_t)((unsigned)c->dc_pred << al);
}

static void decode_dc_refine(dec_t *d, int16_t *blk, int al) {
  if (get_bits(d, 1)) blk[0] = (int16_t)(blk[0] | (1 << al));
}

static void decode_ac_first(dec_t *d, int16_t *blk, int ta, int ss, int se, int al) {
  if (d->eobrun > 0) {
    d->eobrun--;
    return;
  }
  const huff_t *t = &d->ac[ta];
  for (int k = ss; k <= se; k++) {
    int rs = decode_huff(d, t);
    int r = rs >> 4, s = rs & 15;
    if (s) {
      k += r;
      int v = extend(get_bits(d, s), s);
      blk[NATURAL[k]] = (int16_t)((unsigned)v << al);
    } else if (r == 15) {
      k += 15;
    } else {
      d->eobrun = 1 << r;
      if (r) d->eobrun += get_bits(d, r);
      d->eobrun--;
      break;
    }
  }
}

static void decode_ac_refine(dec_t *d, int16_t *blk, int ta, int ss, int se, int al) {
  int p1 = 1 << al, m1 = (int)((-1u) << al);
  int k = ss;
  if (d->eobrun == 0) {
    const huff_t *t = &d->ac[ta];
    for (; k <= se; k++) {
      int rs = decode_huff(d, t);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        if (s != 1) fail(d, CORRUPT, "corrupt JPEG: bad refinement code");
        s = get_bits(d, 1) ? p1 : m1;
      } else if (r != 15) {
        d->eobrun = 1 << r;
        if (r) d->eobrun += get_bits(d, r);
        break;
      }
      do {
        int16_t *co = blk + NATURAL[k];
        if (*co != 0) {
          if (get_bits(d, 1) && (*co & p1) == 0) *co = (int16_t)(*co + (*co >= 0 ? p1 : m1));
        } else {
          if (--r < 0) break;
        }
        k++;
      } while (k <= se);
      if (s && k < 64) blk[NATURAL[k]] = (int16_t)s;
    }
  }
  if (d->eobrun > 0) {
    for (; k <= se; k++) {
      int16_t *co = blk + NATURAL[k];
      if (*co != 0 && get_bits(d, 1) && (*co & p1) == 0)
        *co = (int16_t)(*co + (*co >= 0 ? p1 : m1));
    }
    d->eobrun--;
  }
}

static void read_scan(dec_t *d) {
  if (!d->sof_seen) fail(d, CORRUPT, "corrupt JPEG: SOS before SOF");
  u16_at(d);
  int ns = byte_at(d);
  if (ns < 1 || ns > d->ncomp) fail(d, CORRUPT, "corrupt JPEG: bad SOS");
  comp_t *sc[3];
  int td[3], ta[3];
  for (int i = 0; i < ns; i++) {
    int id = byte_at(d), t = byte_at(d);
    sc[i] = NULL;
    for (int j = 0; j < d->ncomp; j++)
      if (d->comp[j].id == id) sc[i] = &d->comp[j];
    if (!sc[i]) fail(d, CORRUPT, "corrupt JPEG: SOS names an unknown component");
    td[i] = t >> 4;
    ta[i] = t & 15;
    if (td[i] > 3 || ta[i] > 3) fail(d, CORRUPT, "corrupt JPEG: bad table id");
  }
  int ss = byte_at(d), se = byte_at(d), ahal = byte_at(d);
  int ah = ahal >> 4, al = ahal & 15;
  int dc_scan = ss == 0;
  if (d->progressive) {
    if (ss > se || se > 63 || (dc_scan && se != 0) || (!dc_scan && ns != 1) || al > 13)
      fail(d, CORRUPT, "corrupt JPEG: bad progressive scan parameters");
  } else if (ss != 0 || se != 63 || ah != 0 || al != 0) {
    fail(d, CORRUPT, "corrupt JPEG: bad sequential scan parameters");
  }
  for (int i = 0; i < ns; i++) {
    comp_t *c = sc[i];
    if (!c->q_latched) { /* libjpeg latches a table at the component's first scan */
      if (!d->qt_defined[c->tq]) fail(d, CORRUPT, "corrupt JPEG: undefined quantisation table");
      memcpy(c->qt, d->qt[c->tq], sizeof(c->qt));
      c->q_latched = 1;
    }
    int need_dc = !d->progressive || (dc_scan && !ah);
    int need_ac = !d->progressive || !dc_scan;
    if (need_dc && !d->dc[td[i]].defined) fail(d, CORRUPT, "corrupt JPEG: undefined DC Huffman table");
    if (need_ac && !d->ac[ta[i]].defined) fail(d, CORRUPT, "corrupt JPEG: undefined AC Huffman table");
    if (d->progressive)
      for (int k = ss; k <= se; k++) c->coef_bits[k] = al;
    c->dc_pred = 0;
  }
  d->eobrun = 0;
  reset_bits(d);

  long n_units, units_row;
  if (ns == 1) {
    units_row = sc[0]->wib;
    n_units = (long)sc[0]->wib * sc[0]->hib;
  } else {
    units_row = d->mcux;
    n_units = (long)d->mcux * d->mcuy;
  }
  for (long u = 0; u < n_units; u++) {
    if (d->restart_interval && u > 0 && u % d->restart_interval == 0) process_restart(d);
    int ux = (int)(u % units_row), uy = (int)(u / units_row);
    for (int i = 0; i < ns; i++) {
      comp_t *c = sc[i];
      int nby = ns == 1 ? 1 : c->v, nbx = ns == 1 ? 1 : c->h;
      for (int by = 0; by < nby; by++) {
        for (int bx = 0; bx < nbx; bx++) {
          int gx = ns == 1 ? ux : ux * c->h + bx;
          int gy = ns == 1 ? uy : uy * c->v + by;
          int16_t *blk = c->coef + ((size_t)gy * c->bw + gx) * 64;
          if (!d->progressive) decode_block_baseline(d, c, blk, td[i], ta[i]);
          else if (dc_scan && !ah) decode_dc_first(d, c, blk, td[i], al);
          else if (dc_scan) decode_dc_refine(d, blk, al);
          else if (!ah) decode_ac_first(d, blk, ta[i], ss, se, al);
          else decode_ac_refine(d, blk, ta[i], ss, se, al);
        }
      }
    }
  }
  /* Back to the marker that ends the segment. */
  reset_bits(d);
  while (d->pos + 1 < d->len &&
         !(d->data[d->pos] == 0xFF && d->data[d->pos + 1] != 0x00 && d->data[d->pos + 1] != 0xFF))
    d->pos++;
}

/* -- islow IDCT (jidctint.c) ------------------------------------------------ */

#define CONST_BITS 13
#define PASS1_BITS 2
#define FIX_0_298631336 ((int64_t)2446)
#define FIX_0_390180644 ((int64_t)3196)
#define FIX_0_541196100 ((int64_t)4433)
#define FIX_0_765366865 ((int64_t)6270)
#define FIX_0_899976223 ((int64_t)7373)
#define FIX_1_175875602 ((int64_t)9633)
#define FIX_1_501321110 ((int64_t)12299)
#define FIX_1_847759065 ((int64_t)15137)
#define FIX_1_961570560 ((int64_t)16069)
#define FIX_2_053119869 ((int64_t)16819)
#define FIX_2_562915447 ((int64_t)20995)
#define FIX_3_072711026 ((int64_t)25172)
#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n)-1))) >> (n))

/* libjpeg's post-IDCT range limit: the sample (centred on 0) masked to 10
 * bits and read as signed, clamped after adding 128. */
static inline uint8_t idct_limit(int64_t x) {
  int v = (int)(x & 1023);
  if (v < 128) return (uint8_t)(v + 128);
  if (v < 512) return 255;
  if (v < 896) return 0;
  return (uint8_t)(v - 896);
}

static void idct_islow(const int16_t *in, const uint16_t *q, uint8_t *out, int stride) {
  int64_t ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t *ip = in + c;
    const uint16_t *qp = q + c;
    int64_t *wp = ws + c;
    int64_t z1, z2, z3, z4, z5, tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12, tmp13;
    z2 = (int64_t)ip[16] * qp[16];
    z3 = (int64_t)ip[48] * qp[48];
    z1 = (z2 + z3) * FIX_0_541196100;
    tmp2 = z1 + z3 * (-FIX_1_847759065);
    tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (int64_t)ip[0] * qp[0];
    z3 = (int64_t)ip[32] * qp[32];
    tmp0 = (z2 + z3) * ((int64_t)1 << CONST_BITS);
    tmp1 = (z2 - z3) * ((int64_t)1 << CONST_BITS);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    tmp0 = (int64_t)ip[56] * qp[56];
    tmp1 = (int64_t)ip[40] * qp[40];
    tmp2 = (int64_t)ip[24] * qp[24];
    tmp3 = (int64_t)ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * (-FIX_0_899976223);
    z2 = z2 * (-FIX_2_562915447);
    z3 = z3 * (-FIX_1_961570560);
    z4 = z4 * (-FIX_0_390180644);
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    wp[0] = DESCALE(tmp10 + tmp3, CONST_BITS - PASS1_BITS);
    wp[56] = DESCALE(tmp10 - tmp3, CONST_BITS - PASS1_BITS);
    wp[8] = DESCALE(tmp11 + tmp2, CONST_BITS - PASS1_BITS);
    wp[48] = DESCALE(tmp11 - tmp2, CONST_BITS - PASS1_BITS);
    wp[16] = DESCALE(tmp12 + tmp1, CONST_BITS - PASS1_BITS);
    wp[40] = DESCALE(tmp12 - tmp1, CONST_BITS - PASS1_BITS);
    wp[24] = DESCALE(tmp13 + tmp0, CONST_BITS - PASS1_BITS);
    wp[32] = DESCALE(tmp13 - tmp0, CONST_BITS - PASS1_BITS);
  }
  for (int r = 0; r < 8; r++) {
    const int64_t *wp = ws + 8 * r;
    uint8_t *op = out + (size_t)r * stride;
    int64_t z1, z2, z3, z4, z5, tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12, tmp13;
    z2 = wp[2];
    z3 = wp[6];
    z1 = (z2 + z3) * FIX_0_541196100;
    tmp2 = z1 + z3 * (-FIX_1_847759065);
    tmp3 = z1 + z2 * FIX_0_765366865;
    tmp0 = (wp[0] + wp[4]) * ((int64_t)1 << CONST_BITS);
    tmp1 = (wp[0] - wp[4]) * ((int64_t)1 << CONST_BITS);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * (-FIX_0_899976223);
    z2 = z2 * (-FIX_2_562915447);
    z3 = z3 * (-FIX_1_961570560);
    z4 = z4 * (-FIX_0_390180644);
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = CONST_BITS + PASS1_BITS + 3;
    op[0] = idct_limit(DESCALE(tmp10 + tmp3, n));
    op[7] = idct_limit(DESCALE(tmp10 - tmp3, n));
    op[1] = idct_limit(DESCALE(tmp11 + tmp2, n));
    op[6] = idct_limit(DESCALE(tmp11 - tmp2, n));
    op[2] = idct_limit(DESCALE(tmp12 + tmp1, n));
    op[5] = idct_limit(DESCALE(tmp12 - tmp1, n));
    op[3] = idct_limit(DESCALE(tmp13 + tmp0, n));
    op[4] = idct_limit(DESCALE(tmp13 - tmp0, n));
  }
}

/* -- Upsampling (jdsample.c) ------------------------------------------------ */

/* One output row of h2 fancy upsampling from the column sums of a row. */
static void h2_fancy_row(const int *sum, int dw, uint8_t *out, int v2) {
  if (!v2) { /* h2v1: sums are plain samples, shift 2 */
    out[0] = (uint8_t)sum[0];
    out[1] = (uint8_t)((sum[0] * 3 + sum[1] + 2) >> 2);
    for (int x = 1; x < dw - 1; x++) {
      out[2 * x] = (uint8_t)((sum[x] * 3 + sum[x - 1] + 1) >> 2);
      out[2 * x + 1] = (uint8_t)((sum[x] * 3 + sum[x + 1] + 2) >> 2);
    }
    out[2 * dw - 2] = (uint8_t)((sum[dw - 1] * 3 + sum[dw - 2] + 1) >> 2);
    out[2 * dw - 1] = (uint8_t)sum[dw - 1];
  } else { /* h2v2: sums are 3 * near + far, shift 4 */
    out[0] = (uint8_t)((sum[0] * 4 + 8) >> 4);
    out[1] = (uint8_t)((sum[0] * 3 + sum[1] + 7) >> 4);
    for (int x = 1; x < dw - 1; x++) {
      out[2 * x] = (uint8_t)((sum[x] * 3 + sum[x - 1] + 8) >> 4);
      out[2 * x + 1] = (uint8_t)((sum[x] * 3 + sum[x + 1] + 7) >> 4);
    }
    out[2 * dw - 2] = (uint8_t)((sum[dw - 1] * 3 + sum[dw - 2] + 8) >> 4);
    out[2 * dw - 1] = (uint8_t)((sum[dw - 1] * 4 + 7) >> 4);
  }
}

/* The component's plane at full resolution: ow x oh samples (at least the
 * image's), row stride ow. Rows above the first and below the last take
 * the first and last sample rows, as libjpeg's context rows do. */
static uint8_t *upsample(dec_t *d, comp_t *c, int *ow_out) {
  int rh = d->hmax / c->h, rv = d->vmax / c->v;
  int dw = c->dw, dh = c->dh, stride = c->bw * 8;
  int ow = dw * rh, oh = dh * rv;
  uint8_t *out = (uint8_t *)malloc((size_t)ow * oh);
  int *sum = (int *)malloc(sizeof(int) * (size_t)dw);
  if (!out || !sum) {
    free(out);
    free(sum);
    fail(d, CORRUPT, "out of memory");
  }
  for (int y = 0; y < dh; y++) {
    const uint8_t *row = c->plane + (size_t)y * stride;
    const uint8_t *above = c->plane + (size_t)(y > 0 ? y - 1 : 0) * stride;
    const uint8_t *below = c->plane + (size_t)(y < dh - 1 ? y + 1 : dh - 1) * stride;
    if (rv == 1) {
      uint8_t *o = out + (size_t)y * ow;
      if (rh == 1) {
        memcpy(o, row, (size_t)dw);
      } else if (dw > 2) {
        for (int x = 0; x < dw; x++) sum[x] = row[x];
        h2_fancy_row(sum, dw, o, 0);
      } else {
        for (int x = 0; x < dw; x++) o[2 * x] = o[2 * x + 1] = row[x];
      }
      continue;
    }
    for (int half = 0; half < 2; half++) {
      const uint8_t *far = half ? below : above;
      uint8_t *o = out + (size_t)(2 * y + half) * ow;
      if (rh == 1) { /* h1v2: bias 1 above, 2 below */
        for (int x = 0; x < dw; x++) o[x] = (uint8_t)((row[x] * 3 + far[x] + 1 + half) >> 2);
      } else if (dw > 2) {
        for (int x = 0; x < dw; x++) sum[x] = row[x] * 3 + far[x];
        h2_fancy_row(sum, dw, o, 1);
      } else {
        for (int x = 0; x < dw; x++) o[2 * x] = o[2 * x + 1] = row[x];
      }
    }
  }
  free(sum);
  *ow_out = ow;
  return out;
}

/* -- Entry points ----------------------------------------------------------- */

static void read_app(dec_t *d, int marker) {
  int len = u16_at(d) - 2;
  if (len < 0 || d->pos + (size_t)len > d->len) fail(d, CORRUPT, "corrupt JPEG: bad segment length");
  const uint8_t *p = d->data + d->pos;
  if (marker == 0xE0 && len >= 5 && memcmp(p, "JFIF\0", 5) == 0) d->jfif = 1;
  if (marker == 0xEE && len >= 12 && memcmp(p, "Adobe", 5) == 0) {
    d->adobe = 1;
    d->adobe_transform = p[11];
  }
  d->pos += (size_t)len;
}

static void skip_segment(dec_t *d) {
  int len = u16_at(d) - 2;
  if (len < 0 || d->pos + (size_t)len > d->len) fail(d, CORRUPT, "corrupt JPEG: bad segment length");
  d->pos += (size_t)len;
}

static int next_marker(dec_t *d) {
  int c = byte_at(d);
  while (c != 0xFF) c = byte_at(d); /* garbage before a marker, as libjpeg skips it */
  while (c == 0xFF) c = byte_at(d);
  return c;
}

static const char *sof_name(int m) {
  switch (m) {
    case 0xC3: return "lossless JPEG (SOF3)";
    case 0xC5: return "hierarchical JPEG (SOF5)";
    case 0xC6: return "hierarchical progressive JPEG (SOF6)";
    case 0xC7: return "hierarchical lossless JPEG (SOF7)";
    case 0xC9: return "arithmetic-coded JPEG (SOF9)";
    case 0xCA: return "arithmetic-coded progressive JPEG (SOF10)";
    case 0xCB: return "arithmetic-coded lossless JPEG (SOF11)";
    case 0xCD: return "arithmetic-coded hierarchical JPEG (SOF13)";
    case 0xCE: return "arithmetic-coded hierarchical progressive JPEG (SOF14)";
    case 0xCF: return "arithmetic-coded hierarchical lossless JPEG (SOF15)";
    default: return NULL;
  }
}

/* Parse markers; with header_only stop after the frame header. */
static void parse(dec_t *d, int header_only) {
  if (d->len < 4 || d->data[0] != 0xFF || d->data[1] != 0xD8)
    fail(d, CORRUPT, "not a JPEG file (no SOI marker)");
  d->pos = 2;
  for (;;) {
    int m = next_marker(d);
    if (m == 0xD9) break;
    if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
      if (d->sof_seen) fail(d, CORRUPT, "corrupt JPEG: two frame headers");
      read_sof(d, m == 0xC2);
      if (header_only) return;
      for (int i = 0; i < d->ncomp; i++) {
        comp_t *c = &d->comp[i];
        c->coef = (int16_t *)calloc((size_t)c->bw * c->bh * 64, sizeof(int16_t));
        if (!c->coef) fail(d, CORRUPT, "out of memory");
      }
    } else if (sof_name(m)) {
      fail(d, UNSUPPORTED, "%s is not supported", sof_name(m));
    } else if (m == 0xCC) {
      fail(d, UNSUPPORTED, "arithmetic-coded JPEG (DAC) is not supported");
    } else if (m == 0xC4) {
      read_dht(d);
    } else if (m == 0xDB) {
      read_dqt(d);
    } else if (m == 0xDD) {
      u16_at(d);
      d->restart_interval = u16_at(d);
    } else if (m == 0xDA) {
      if (header_only) fail(d, CORRUPT, "corrupt JPEG: SOS before SOF");
      read_scan(d);
    } else if (m == 0xDC) {
      fail(d, UNSUPPORTED, "JPEG with a DNL marker is not supported");
    } else if (m >= 0xE0 && m <= 0xEF) {
      read_app(d, m);
    } else if (m >= 0xD0 && m <= 0xD7) {
      continue; /* stray RSTn */
    } else if (m == 0xD8 || m == 0x01) {
      continue;
    } else {
      skip_segment(d);
    }
  }
  if (!d->sof_seen) fail(d, CORRUPT, "corrupt JPEG: no frame header");
}

static void check_colour(dec_t *d) {
  if (d->ncomp != 3) return;
  int rgb;
  if (d->jfif) rgb = 0;
  else if (d->adobe) rgb = d->adobe_transform == 0;
  else rgb = d->comp[0].id == 82 && d->comp[1].id == 71 && d->comp[2].id == 66;
  if (rgb)
    fail(d, UNSUPPORTED, d->adobe ? "RGB JPEG (Adobe transform 0) is not supported"
                                  : "RGB JPEG (component ids R, G, B) is not supported");
}

/* jdcoefct.c's smoothing_ok after every scan was read: would libjpeg smooth? */
static int would_smooth(dec_t *d) {
  static const int Q[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24}; /* natural positions of k 0..9 */
  if (!d->progressive) return 0;
  int useful = 0;
  for (int i = 0; i < d->ncomp; i++) {
    comp_t *c = &d->comp[i];
    if (!c->q_latched) return 0;
    for (int k = 0; k < 10; k++)
      if (c->qt[Q[k]] == 0) return 0;
    if (c->coef_bits[0] < 0) return 0;
    for (int k = 1; k < 10; k++)
      if (c->coef_bits[k] != 0) useful = 1;
  }
  return useful;
}

static void release(dec_t *d) {
  for (int i = 0; i < 3; i++) {
    free(d->full[i]);
    d->full[i] = NULL;
    free(d->comp[i].coef);
    free(d->comp[i].plane);
    d->comp[i].coef = NULL;
    d->comp[i].plane = NULL;
  }
}

API int jpeg_header(const uint8_t *data, size_t len, int *width, int *height, char *err,
                    int errlen) {
  dec_t *d = (dec_t *)calloc(1, sizeof(dec_t));
  if (!d) return CORRUPT;
  d->data = data;
  d->len = len;
  d->err = err;
  d->errlen = errlen;
  int code = setjmp(d->jb);
  if (code == 0) {
    parse(d, 1);
    check_colour(d);
    *width = d->width;
    *height = d->height;
  }
  free(d);
  return code;
}

API int jpeg_decode_rgba(const uint8_t *data, size_t len, uint8_t *out, int width, int height,
                         char *err, int errlen) {
  dec_t *d = (dec_t *)calloc(1, sizeof(dec_t));
  if (!d) return CORRUPT;
  d->data = data;
  d->len = len;
  d->err = err;
  d->errlen = errlen;
  int code = setjmp(d->jb);
  if (code == 0) {
    parse(d, 0);
    check_colour(d);
    if (d->width != width || d->height != height)
      fail(d, CORRUPT, "JPEG size %dx%d, caller expected %dx%d", d->width, d->height, width,
           height);
    if (would_smooth(d))
      fail(d, UNSUPPORTED,
           "progressive JPEG whose scans leave low AC coefficients inexact (libjpeg block "
           "smoothing) is not supported");
    for (int i = 0; i < d->ncomp; i++) {
      comp_t *c = &d->comp[i];
      if (!c->q_latched) fail(d, CORRUPT, "corrupt JPEG: a component has no scan");
      int stride = c->bw * 8;
      c->plane = (uint8_t *)malloc((size_t)stride * c->bh * 8);
      if (!c->plane) fail(d, CORRUPT, "out of memory");
      for (int by = 0; by < c->bh; by++)
        for (int bx = 0; bx < c->bw; bx++)
          idct_islow(c->coef + ((size_t)by * c->bw + bx) * 64, c->qt,
                     c->plane + (size_t)by * 8 * stride + bx * 8, stride);
      d->full[i] = upsample(d, c, &d->full_w[i]);
    }
    if (d->ncomp == 1) {
      for (int y = 0; y < height; y++) {
        const uint8_t *g = d->full[0] + (size_t)y * d->full_w[0];
        uint8_t *o = out + (size_t)y * width * 4;
        for (int x = 0; x < width; x++) {
          o[4 * x] = o[4 * x + 1] = o[4 * x + 2] = g[x];
          o[4 * x + 3] = 255;
        }
      }
    } else {
      /* jdcolor.c build_ycc_rgb_table: SCALEBITS 16, ONE_HALF rounding. */
      int cr_r[256], cb_b[256];
      int64_t cr_g[256], cb_g[256];
      const int64_t one_half = (int64_t)1 << 15;
      for (int i = 0; i < 256; i++) {
        int64_t x = i - 128;
        cr_r[i] = (int)((91881 * x + one_half) >> 16);  /* FIX(1.40200) */
        cb_b[i] = (int)((116130 * x + one_half) >> 16); /* FIX(1.77200) */
        cr_g[i] = -46802 * x;                           /* -FIX(0.71414) */
        cb_g[i] = -22554 * x + one_half;                /* -FIX(0.34414) */
      }
      for (int y = 0; y < height; y++) {
        const uint8_t *yy = d->full[0] + (size_t)y * d->full_w[0];
        const uint8_t *cb = d->full[1] + (size_t)y * d->full_w[1];
        const uint8_t *cr = d->full[2] + (size_t)y * d->full_w[2];
        uint8_t *o = out + (size_t)y * width * 4;
        for (int x = 0; x < width; x++) {
          int l = yy[x], b = cb[x], r = cr[x];
          int rv = l + cr_r[r];
          int gv = l + (int)((cb_g[b] + cr_g[r]) >> 16);
          int bv = l + cb_b[b];
          o[4 * x] = (uint8_t)(rv < 0 ? 0 : rv > 255 ? 255 : rv);
          o[4 * x + 1] = (uint8_t)(gv < 0 ? 0 : gv > 255 ? 255 : gv);
          o[4 * x + 2] = (uint8_t)(bv < 0 ? 0 : bv > 255 ? 255 : bv);
          o[4 * x + 3] = 255;
        }
      }
    }
  }
  release(d);
  free(d);
  return code;
}
