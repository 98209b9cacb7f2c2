// JPEG (libjpeg) and PNG (libpng) decode with cv2.imread's semantics, a
// translation unit of the port's host library (see normalize.cc).  Output is
// 8-bit BGR interleaved, cv2.imread's channel order, or for the
// IMREAD_UNCHANGED reads the file's own dtype.  Two-phase API: *_info reads
// the header, *_decode fills a caller-allocated buffer.  Returns 0 on
// success, -4 (or -5, an unexpected row layout) where the file is one that
// cv2 decodes differently and the caller must read with cv2, and another
// negative code on a decode error.

#include <csetjmp>
#include <cstdint>
#include <cstdio>  // jpeglib.h uses FILE
#include <cstring>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jb, 1);
}

}  // namespace

extern "C" {

int dffxio_jpeg_info(const uint8_t* buf, int64_t len, int64_t* h, int64_t* w) {
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_err_exit;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  // libjpeg converts no CMYK or YCCK scan to BGR (error_exit); cv2 inverts
  // and converts such a file itself, so it decodes them.
  if (cinfo.jpeg_color_space == JCS_CMYK || cinfo.jpeg_color_space == JCS_YCCK) {
    jpeg_destroy_decompress(&cinfo);
    return -4;
  }
  *h = cinfo.image_height;
  *w = cinfo.image_width;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// dst: (h, w, 3) uint8 BGR.
int dffxio_jpeg_decode(const uint8_t* buf, int64_t len, uint8_t* dst,
                       int64_t h, int64_t w) {
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_err_exit;
  if (setjmp(err.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
#ifdef JCS_EXTENSIONS
  cinfo.out_color_space = JCS_EXT_BGR;  // libjpeg-turbo: decode straight to BGR
#else
  cinfo.out_color_space = JCS_RGB;
#endif
  jpeg_start_decompress(&cinfo);
  if (cinfo.output_height != static_cast<JDIMENSION>(h) ||
      cinfo.output_width != static_cast<JDIMENSION>(w) ||
      cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }
  std::vector<uint8_t> rowbuf(static_cast<size_t>(w) * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = dst + static_cast<int64_t>(cinfo.output_scanline) * w * 3;
#ifdef JCS_EXTENSIONS
    JSAMPROW rows[1] = {row};
    jpeg_read_scanlines(&cinfo, rows, 1);
#else
    JSAMPROW rows[1] = {rowbuf.data()};
    jpeg_read_scanlines(&cinfo, rows, 1);
    for (int64_t x = 0; x < w; ++x) {  // RGB -> BGR
      row[x * 3 + 0] = rowbuf[x * 3 + 2];
      row[x * 3 + 1] = rowbuf[x * 3 + 1];
      row[x * 3 + 2] = rowbuf[x * 3 + 0];
    }
#endif
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int dffxio_png_info(const uint8_t* buf, int64_t len, int64_t* h, int64_t* w) {
  png_image img;
  std::memset(&img, 0, sizeof img);
  img.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&img, buf, static_cast<size_t>(len)))
    return -1;
  // Alpha (incl. palette+tRNS) and 16-bit PNGs decode differently from
  // cv2.imread (libpng composites/rescales; cv2 drops alpha, scales 16→8
  // its own way) — report them unsupported so the caller's cv2 fallback
  // keeps byte parity, mirroring the JPEG EXIF-orientation guard.
  if (img.format & (PNG_FORMAT_FLAG_ALPHA | PNG_FORMAT_FLAG_LINEAR)) {
    png_image_free(&img);
    return -4;
  }
  *h = img.height;
  *w = img.width;
  png_image_free(&img);
  return 0;
}

// dst: (h, w, 3) uint8 BGR (libpng's simplified API converts directly).
int dffxio_png_decode(const uint8_t* buf, int64_t len, uint8_t* dst,
                      int64_t h, int64_t w) {
  png_image img;
  std::memset(&img, 0, sizeof img);
  img.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&img, buf, static_cast<size_t>(len)))
    return -1;
  if (img.height != static_cast<png_uint_32>(h) ||
      img.width != static_cast<png_uint_32>(w)) {
    png_image_free(&img);
    return -3;
  }
  if (img.format & (PNG_FORMAT_FLAG_ALPHA | PNG_FORMAT_FLAG_LINEAR)) {
    png_image_free(&img);
    return -4;  // see dffxio_png_info — cv2 parity requires the fallback
  }
  img.format = PNG_FORMAT_BGR;
  if (!png_image_finish_read(&img, nullptr, dst, 0, nullptr)) {
    png_image_free(&img);
    return -2;
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// cv2.IMREAD_UNCHANGED-semantics PNG decode (the full libpng API): the
// reference's raw ground-truth reads (Smartphone merged-depth PNGs,
// train_Dataloader.py:341).  The *_info function reports a `kind` code the
// Python side maps to a dtype and shape; anything cv2 would decode
// differently (palette, alpha, interlace, sub-byte gray) reports -4.
//   kind: 1 = uint8 gray (H,W)    2 = uint16 gray (H,W)
//         4 = uint8 BGR (H,W,3)   5 = uint16 BGR (H,W,3)
// ---------------------------------------------------------------------------

namespace {

struct PngMem {
  const uint8_t* buf;
  size_t len;
  size_t pos;
};

void png_mem_read(png_structp p, png_bytep out, png_size_t n) {
  PngMem* m = reinterpret_cast<PngMem*>(png_get_io_ptr(p));
  if (m->pos + n > m->len) png_error(p, "dffxio: png eof");
  std::memcpy(out, m->buf + m->pos, n);
  m->pos += n;
}

// Shared open-and-classify for the unchanged PNG path.  On success the read
// struct is positioned after png_read_info with BGR/endian transforms applied.
int png_open_unchanged(const uint8_t* buf, int64_t len, png_structp* pp,
                       png_infop* ip, PngMem* mem, int64_t* h, int64_t* w,
                       int64_t* kind) {
  if (len < 8 || png_sig_cmp(buf, 0, 8)) return -1;
  png_structp p = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                         nullptr, nullptr);
  if (!p) return -1;
  png_infop info = png_create_info_struct(p);
  if (!info) {
    png_destroy_read_struct(&p, nullptr, nullptr);
    return -1;
  }
  if (setjmp(png_jmpbuf(p))) {
    png_destroy_read_struct(&p, &info, nullptr);
    return -2;
  }
  mem->buf = buf;
  mem->len = static_cast<size_t>(len);
  mem->pos = 0;
  png_set_read_fn(p, mem, png_mem_read);
  png_read_info(p, info);
  const int bits = png_get_bit_depth(p, info);
  const int color = png_get_color_type(p, info);
  *h = png_get_image_height(p, info);
  *w = png_get_image_width(p, info);
  int k;
  if (png_get_interlace_type(p, info) != PNG_INTERLACE_NONE)
    k = -4;  // cv2 handles interlace; rare — take the fallback
  else if (color == PNG_COLOR_TYPE_GRAY && bits == 8)
    k = 1;
  else if (color == PNG_COLOR_TYPE_GRAY && bits == 16)
    k = 2;
  else if (color == PNG_COLOR_TYPE_RGB && bits == 8)
    k = 4;
  else if (color == PNG_COLOR_TYPE_RGB && bits == 16)
    k = 5;
  else
    k = -4;  // palette / alpha / sub-byte gray -> cv2 fallback
  if (k < 0) {
    png_destroy_read_struct(&p, &info, nullptr);
    return k;
  }
  if (k == 4 || k == 5) png_set_bgr(p);  // cv2 channel order
  if (bits == 16) png_set_swap(p);       // PNG is big-endian; cv2 swaps too
  png_read_update_info(p, info);
  *kind = k;
  *pp = p;
  *ip = info;
  return 0;
}

}  // namespace

extern "C" {

int dffxio_png_info_unchanged(const uint8_t* buf, int64_t len, int64_t* h,
                              int64_t* w, int64_t* kind) {
  png_structp p;
  png_infop info;
  PngMem mem;
  int rc = png_open_unchanged(buf, len, &p, &info, &mem, h, w, kind);
  if (rc == 0) png_destroy_read_struct(&p, &info, nullptr);
  return rc;
}

int dffxio_png_decode_unchanged(const uint8_t* buf, int64_t len, void* dst,
                                int64_t h, int64_t w, int64_t kind) {
  png_structp p;
  png_infop info;
  PngMem mem;
  int64_t ih, iw, k;
  int rc = png_open_unchanged(buf, len, &p, &info, &mem, &ih, &iw, &k);
  if (rc != 0) return rc;
  if (ih != h || iw != w || k != kind) {
    png_destroy_read_struct(&p, &info, nullptr);
    return -3;
  }
  if (setjmp(png_jmpbuf(p))) {
    png_destroy_read_struct(&p, &info, nullptr);
    return -2;
  }
  const int64_t row_bytes = w * (k == 1 ? 1 : k == 2 ? 2 : k == 4 ? 3 : 6);
  if (static_cast<int64_t>(png_get_rowbytes(p, info)) != row_bytes) {
    png_destroy_read_struct(&p, &info, nullptr);
    return -5;
  }
  uint8_t* out = static_cast<uint8_t*>(dst);
  for (int64_t y = 0; y < h; ++y)
    png_read_row(p, out + y * row_bytes, nullptr);
  png_destroy_read_struct(&p, &info, nullptr);
  return 0;
}

}  // extern "C"
