/* Writes one JPEG file of a form that the port's decoders must read, through
 * an IJG-family library: libjpeg-turbo (arithmetic coding, progressive
 * scripts, restart intervals, DAC conditioning, any sampling factors) or
 * GDCM's builds of the IJG library with the lossless patch (lossless files,
 * 8 and 12 bits) and its 12-bit build (12-bit DCT files).
 *
 *   jpeg_forms_writer IN OUT [key=value ...]
 *
 * IN: "H W C BITS\n" then H*W*C samples, row-major, interleaved, one byte
 * each (BITS 8) or two little-endian bytes (BITS 12). C is 1 (gray), 3 (RGB)
 * or 4 (CMYK). Keys:
 *   q=75          quality
 *   cs=ycc        coded colour space: gray, ycc, rgb, cmyk, ycck
 *   samp=2x2,1x1,1x1   each component's h x v sampling factors
 *   raw=1         the caller's own downsampling (nearest sample), so any
 *                 factors are written, fractional ones too
 *   arith=1       arithmetic coding (libjpeg-turbo)
 *   dac=L,U,K     DC conditioning L, U and AC conditioning Kx of every table
 *   prog=1        jpeg_simple_progression's script
 *   rst=N         a restart interval of N MCUs; rstrows=N of N MCU rows
 *   lossless=P,T  lossless with predictor P and point transform T (GDCM)
 *   optimize=1    optimised Huffman tables
 *
 * Built by tests/make_jpeg_fixtures.py: with -DTURBO against libjpeg-turbo,
 * or against GDCM's gdcmjpeg8 / gdcmjpeg12.
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "jpeglib.h"

static int streq(const char *a, const char *b) { return strcmp(a, b) == 0; }

int main(int argc, char **argv) {
  if (argc < 3) {
    fprintf(stderr, "usage: %s IN OUT [key=value ...]\n", argv[0]);
    return 2;
  }
  FILE *in = fopen(argv[1], "rb");
  if (!in) return 3;
  int H, W, C, bits;
  if (fscanf(in, "%d %d %d %d", &H, &W, &C, &bits) != 4 || fgetc(in) != '\n') return 4;
  size_t n = (size_t)H * W * C;
  unsigned short *px = malloc(n * sizeof(unsigned short));
  for (size_t i = 0; i < n; i++) {
    int lo = fgetc(in);
    int hi = bits > 8 ? fgetc(in) : 0;
    if (lo < 0 || hi < 0) return 5;
    px[i] = (unsigned short)(lo | (hi << 8));
  }
  fclose(in);

  int quality = 75, arith = 0, prog = 0, rst = 0, rstrows = 0, raw = 0, optimize = 0;
  int pred = 0, pt = 0, dac = 0, dL = 0, dU = 1, dK = 5, nsamp = 0;
  int hs[4] = {1, 1, 1, 1}, vs[4] = {1, 1, 1, 1};
  const char *cs = C == 1 ? "gray" : C == 3 ? "ycc" : "cmyk";
  for (int a = 3; a < argc; a++) {
    char *k = argv[a], *v = strchr(k, '=');
    if (!v) return 6;
    *v++ = 0;
    if (streq(k, "q")) quality = atoi(v);
    else if (streq(k, "cs")) cs = v;
    else if (streq(k, "arith")) arith = atoi(v);
    else if (streq(k, "prog")) prog = atoi(v);
    else if (streq(k, "rst")) rst = atoi(v);
    else if (streq(k, "rstrows")) rstrows = atoi(v);
    else if (streq(k, "raw")) raw = atoi(v);
    else if (streq(k, "optimize")) optimize = atoi(v);
    else if (streq(k, "lossless")) { if (sscanf(v, "%d,%d", &pred, &pt) != 2) return 7; }
    else if (streq(k, "dac")) { dac = 1; if (sscanf(v, "%d,%d,%d", &dL, &dU, &dK) != 3) return 8; }
    else if (streq(k, "samp")) {
      for (char *t = strtok(v, ","); t && nsamp < 4; t = strtok(NULL, ","), nsamp++)
        if (sscanf(t, "%dx%d", &hs[nsamp], &vs[nsamp]) != 2) return 9;
    } else {
      fprintf(stderr, "unknown key %s\n", k);
      return 10;
    }
  }

  struct jpeg_compress_struct cinfo;
  struct jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_compress(&cinfo);
  FILE *out = fopen(argv[2], "wb");
  if (!out) return 11;
  jpeg_stdio_dest(&cinfo, out);
  cinfo.image_width = W;
  cinfo.image_height = H;
  cinfo.input_components = C;
  cinfo.in_color_space = C == 1 ? JCS_GRAYSCALE : C == 3 ? JCS_RGB : JCS_CMYK;
  jpeg_set_defaults(&cinfo);
  J_COLOR_SPACE jcs = streq(cs, "gray") ? JCS_GRAYSCALE : streq(cs, "ycc") ? JCS_YCbCr
                      : streq(cs, "rgb") ? JCS_RGB : streq(cs, "cmyk") ? JCS_CMYK : JCS_YCCK;
  jpeg_set_colorspace(&cinfo, jcs);
  jpeg_set_quality(&cinfo, quality, TRUE);
  for (int c = 0; c < nsamp && c < cinfo.num_components; c++) {
    cinfo.comp_info[c].h_samp_factor = hs[c];
    cinfo.comp_info[c].v_samp_factor = vs[c];
  }
  if (arith) cinfo.arith_code = TRUE;
  if (dac) {
    for (int t = 0; t < NUM_ARITH_TBLS; t++) {
      cinfo.arith_dc_L[t] = (UINT8)dL;
      cinfo.arith_dc_U[t] = (UINT8)dU;
      cinfo.arith_ac_K[t] = (UINT8)dK;
    }
  }
  if (optimize) cinfo.optimize_coding = TRUE;
  if (prog) jpeg_simple_progression(&cinfo);
  if (pred) {
#ifdef TURBO
    fprintf(stderr, "lossless needs the GDCM build\n");
    return 12;
#else
    jpeg_simple_lossless(&cinfo, pred, pt);
#endif
  }
  if (rst) cinfo.restart_interval = rst;
  if (rstrows) cinfo.restart_in_rows = rstrows;
  cinfo.raw_data_in = raw ? TRUE : FALSE;
  jpeg_start_compress(&cinfo, TRUE);

  if (!raw) {
    JSAMPROW row = malloc((size_t)W * C * sizeof(JSAMPLE));
    while (cinfo.next_scanline < cinfo.image_height) {
      const unsigned short *src = px + (size_t)cinfo.next_scanline * W * C;
      for (int i = 0; i < W * C; i++) row[i] = (JSAMPLE)src[i];
      jpeg_write_scanlines(&cinfo, &row, 1);
    }
    free(row);
  } else {
    /* Each component sampled at the nearest sample of its own grid from the
     * input channel of the same index (no colour conversion: the caller
     * gives the coded planes), edges replicated to whole blocks. */
    int hmax = cinfo.max_h_samp_factor, vmax = cinfo.max_v_samp_factor;
    int nc = cinfo.num_components;
    JSAMPARRAY planes[4];
    for (int c = 0; c < nc; c++) {
      jpeg_component_info *cp = &cinfo.comp_info[c];
      int cw = (W * cp->h_samp_factor + hmax - 1) / hmax;
      int rows = cp->v_samp_factor * DCTSIZE, cols = (cw + DCTSIZE - 1) / DCTSIZE * DCTSIZE;
      planes[c] = malloc(rows * sizeof(JSAMPROW));
      for (int r = 0; r < rows; r++) planes[c][r] = malloc(cols * sizeof(JSAMPLE));
    }
    int group = vmax * DCTSIZE;
    for (int y0 = 0; y0 < H; y0 += group) {
      for (int c = 0; c < nc; c++) {
        jpeg_component_info *cp = &cinfo.comp_info[c];
        int cw = (W * cp->h_samp_factor + hmax - 1) / hmax, ch = (H * cp->v_samp_factor + vmax - 1) / vmax;
        int rows = cp->v_samp_factor * DCTSIZE, cols = (cw + DCTSIZE - 1) / DCTSIZE * DCTSIZE;
        for (int r = 0; r < rows; r++) {
          int cy = y0 * cp->v_samp_factor / vmax + r;
          if (cy >= ch) cy = ch - 1;
          int sy = cy * vmax / cp->v_samp_factor;
          for (int x = 0; x < cols; x++) {
            int cx = x < cw ? x : cw - 1;
            int sx = cx * hmax / cp->h_samp_factor;
            if (sy >= H) sy = H - 1;
            if (sx >= W) sx = W - 1;
            planes[c][r][x] = (JSAMPLE)px[((size_t)sy * W + sx) * C + (c < C ? c : 0)];
          }
        }
      }
      jpeg_write_raw_data(&cinfo, planes, group);
    }
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  fclose(out);
  free(px);
  return 0;
}
