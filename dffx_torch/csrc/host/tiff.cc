// TIFF decode (libtiff) with cv2.imread's and cv2.IMREAD_UNCHANGED's
// semantics, a translation unit of the port's host library (see
// normalize.cc): the DefocusNet `All.tif` focal stacks
// (train_Dataloader.py:84,104) and float or 16-bit depth TIFFs.  The *_info
// function reports a `kind` code the Python side maps to a dtype and shape:
//   kind: 1 = uint8 gray (H,W)    2 = uint16 gray (H,W)   3 = float32 gray (H,W)
//         4 = uint8 BGR (H,W,3)   5 = uint16 BGR (H,W,3)
// and -4 for a directory cv2 decodes differently (palette, other sample
// layouts), which the caller reads with cv2.  0 on success, another
// negative code on a decode error.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <utility>
#include <vector>

#include <tiffio.h>

namespace {

// libtiff reads through a caller-owned memory cursor (no tmp files).
struct TiffMem {
  const uint8_t* buf;
  toff_t len;
  toff_t pos;
};

tmsize_t tiff_read(thandle_t h, void* out, tmsize_t n) {
  TiffMem* m = reinterpret_cast<TiffMem*>(h);
  tmsize_t avail = static_cast<tmsize_t>(m->len - m->pos);
  if (n > avail) n = avail;
  std::memcpy(out, m->buf + m->pos, static_cast<size_t>(n));
  m->pos += n;
  return n;
}
tmsize_t tiff_write(thandle_t, void*, tmsize_t) { return 0; }
toff_t tiff_seek(thandle_t h, toff_t off, int whence) {
  TiffMem* m = reinterpret_cast<TiffMem*>(h);
  toff_t base = whence == SEEK_CUR ? m->pos : whence == SEEK_END ? m->len : 0;
  m->pos = base + off;
  return m->pos;
}
int tiff_close(thandle_t) { return 0; }
toff_t tiff_size(thandle_t h) { return reinterpret_cast<TiffMem*>(h)->len; }

TIFF* tiff_open_mem(TiffMem* m) {
  // one-time: silence libtiff's stderr chatter (errors surface as nullptrs /
  // failed reads; the Python caller falls back to cv2)
  static bool quiet = [] {
    TIFFSetErrorHandler(nullptr);
    TIFFSetWarningHandler(nullptr);
    return true;
  }();
  (void)quiet;
  return TIFFClientOpen("mem", "rm", reinterpret_cast<thandle_t>(m), tiff_read,
                        tiff_write, tiff_seek, tiff_close, tiff_size, nullptr,
                        nullptr);
}

// Classify the first directory into a `kind` (see table above); -4 when cv2
// parity can't be guaranteed natively.
int tiff_kind(TIFF* tif, int64_t* h, int64_t* w) {
  uint32_t ih = 0, iw = 0;
  uint16_t bps = 8, spp = 1, fmt = SAMPLEFORMAT_UINT, planar = PLANARCONFIG_CONTIG;
  if (!TIFFGetField(tif, TIFFTAG_IMAGELENGTH, &ih) ||
      !TIFFGetField(tif, TIFFTAG_IMAGEWIDTH, &iw))
    return -2;
  // a compression this libtiff was built without: cv2 carries its own
  uint16_t compression = COMPRESSION_NONE;
  TIFFGetFieldDefaulted(tif, TIFFTAG_COMPRESSION, &compression);
  if (!TIFFIsCODECConfigured(compression)) return -4;
  TIFFGetFieldDefaulted(tif, TIFFTAG_BITSPERSAMPLE, &bps);
  TIFFGetFieldDefaulted(tif, TIFFTAG_SAMPLESPERPIXEL, &spp);
  TIFFGetFieldDefaulted(tif, TIFFTAG_SAMPLEFORMAT, &fmt);
  TIFFGetFieldDefaulted(tif, TIFFTAG_PLANARCONFIG, &planar);
  *h = ih;
  *w = iw;
  uint16_t photo = PHOTOMETRIC_MINISBLACK;
  TIFFGetFieldDefaulted(tif, TIFFTAG_PHOTOMETRIC, &photo);
  if (photo == PHOTOMETRIC_PALETTE) return -4;
  if (spp == 1) {
    if (bps == 8 && fmt == SAMPLEFORMAT_UINT) return 1;
    if (bps == 16 && fmt == SAMPLEFORMAT_UINT) return 2;
    if (bps == 32 && fmt == SAMPLEFORMAT_IEEEFP) return 3;
    return -4;
  }
  if (spp == 3 && bps == 8 && fmt == SAMPLEFORMAT_UINT &&
      planar == PLANARCONFIG_CONTIG)
    return 4;
  if (spp == 3 && bps == 16 && fmt == SAMPLEFORMAT_UINT &&
      planar == PLANARCONFIG_CONTIG)
    return 5;
  return -4;
}

}  // namespace

extern "C" {

int dffxio_tiff_info(const uint8_t* buf, int64_t len, int64_t* h, int64_t* w,
                     int64_t* kind) {
  TiffMem m{buf, static_cast<toff_t>(len), 0};
  TIFF* tif = tiff_open_mem(&m);
  if (!tif) return -1;
  int k = tiff_kind(tif, h, w);
  TIFFClose(tif);
  if (k < 0) return k;
  *kind = k;
  return 0;
}

// cv2.imread (IMREAD_COLOR) semantics: (h, w, 3) uint8 BGR.  Only 8-bit
// gray/RGB directories (kinds 1 and 4) — exactly the cases where OpenCV's own
// TIFF decoder also routes through libtiff's RGBA reader, so values match.
int dffxio_tiff_decode_bgr(const uint8_t* buf, int64_t len, uint8_t* dst,
                           int64_t h, int64_t w) {
  TiffMem m{buf, static_cast<toff_t>(len), 0};
  TIFF* tif = tiff_open_mem(&m);
  if (!tif) return -1;
  int64_t ih, iw;
  int k = tiff_kind(tif, &ih, &iw);
  if ((k != 1 && k != 4) || ih != h || iw != w) {
    TIFFClose(tif);
    return -3;
  }
  std::vector<uint32_t> rgba(static_cast<size_t>(h) * w);
  if (!TIFFReadRGBAImageOriented(tif, static_cast<uint32_t>(w),
                                 static_cast<uint32_t>(h), rgba.data(),
                                 ORIENTATION_TOPLEFT, 0)) {
    TIFFClose(tif);
    return -2;
  }
  TIFFClose(tif);
  for (int64_t i = 0; i < h * w; ++i) {
    uint32_t px = rgba[static_cast<size_t>(i)];
    dst[i * 3 + 0] = static_cast<uint8_t>(TIFFGetB(px));
    dst[i * 3 + 1] = static_cast<uint8_t>(TIFFGetG(px));
    dst[i * 3 + 2] = static_cast<uint8_t>(TIFFGetR(px));
  }
  return 0;
}

// IMREAD_UNCHANGED semantics.  `dst` is a caller-allocated buffer of the
// dtype/shape `kind` implies; `kind` must equal what dffxio_tiff_info
// reported (re-verified here).
int dffxio_tiff_decode_raw(const uint8_t* buf, int64_t len, void* dst,
                           int64_t h, int64_t w, int64_t kind) {
  TiffMem m{buf, static_cast<toff_t>(len), 0};
  TIFF* tif = tiff_open_mem(&m);
  if (!tif) return -1;
  int64_t ih, iw;
  int k = tiff_kind(tif, &ih, &iw);
  if (k != kind || ih != h || iw != w) {
    TIFFClose(tif);
    return -3;
  }
  const int64_t bytes_per_px = kind == 1 ? 1 : kind == 2 ? 2
                               : kind == 3 ? 4 : kind == 4 ? 3 : 6;
  if (TIFFScanlineSize64(tif) != static_cast<uint64_t>(w * bytes_per_px)) {
    TIFFClose(tif);
    return -5;
  }
  uint8_t* out = static_cast<uint8_t*>(dst);
  for (int64_t y = 0; y < h; ++y) {
    if (TIFFReadScanline(tif, out + y * w * bytes_per_px,
                         static_cast<uint32_t>(y)) < 0) {
      TIFFClose(tif);
      return -2;
    }
  }
  TIFFClose(tif);
  if (kind == 4 || kind == 5) {  // RGB -> BGR, matching cv2
    if (kind == 4) {
      for (int64_t i = 0; i < h * w; ++i)
        std::swap(out[i * 3 + 0], out[i * 3 + 2]);
    } else {
      uint16_t* o16 = static_cast<uint16_t*>(dst);
      for (int64_t i = 0; i < h * w; ++i)
        std::swap(o16[i * 3 + 0], o16[i * 3 + 2]);
    }
  }
  return 0;
}

}  // extern "C"
