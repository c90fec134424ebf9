// JPEG decode and encode through libjpeg (the port's copy of the JAX
// package's native/fast_jpeg.cpp, same entry points).
//
// Full decode for the serving path's JPEG requests; *region* decode via
// libjpeg-turbo's jpeg_crop_scanline/jpeg_skip_scanlines for the training
// input pipeline's random crops, so a 200x200 crop of a 512px Food-101
// image only pays for the scanlines and iMCU columns it touches; encode
// for ?format=jpeg responses.
//
// Build: g++ -O3 -shared -fPIC fast_jpeg.cpp -ljpeg -o libfast_jpeg.so
// (native/__init__.py builds it on first use into the package's _build/).
// A host without libjpeg cannot build it: the binding then refuses JPEG by
// name instead of decoding it another way.

#include <cstddef>
#include <cstdio>  // jpeglib.h needs size_t/FILE declared first

#include <jpeglib.h>

#include <csetjmp>
#include <cstdlib>
#include <cstring>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void on_error(j_common_ptr cinfo) {
  ErrMgr* err = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

void on_message(j_common_ptr, int) {}  // silence warnings

bool start_decompress(jpeg_decompress_struct* cinfo, const unsigned char* buf,
                      long len) {
  jpeg_mem_src(cinfo, const_cast<unsigned char*>(buf),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(cinfo, TRUE) != JPEG_HEADER_OK) return false;
  cinfo->out_color_space = JCS_RGB;  // YCbCr/grayscale -> RGB in-library
  return jpeg_start_decompress(cinfo);
}

}  // namespace

extern "C" {

// Header-only probe: width/height without decoding. 0 on success.
int fastjpeg_dims(const unsigned char* buf, long len, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  ErrMgr err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = on_error;
  err.pub.emit_message = on_message;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf),
               static_cast<unsigned long>(len));
  int ok = jpeg_read_header(&cinfo, TRUE) == JPEG_HEADER_OK;
  if (ok) {
    *w = static_cast<int>(cinfo.image_width);
    *h = static_cast<int>(cinfo.image_height);
  }
  jpeg_destroy_decompress(&cinfo);
  return ok ? 0 : -1;
}

// Full decode to tightly-packed RGB8. Returns 0 on success and fills w/h;
// out must hold w*h*3 bytes (probe with fastjpeg_dims first).
int fastjpeg_decode_rgb8(const unsigned char* buf, long len,
                         unsigned char* out, long out_cap, int* w, int* h) {
  jpeg_decompress_struct cinfo;
  ErrMgr err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = on_error;
  err.pub.emit_message = on_message;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  if (!start_decompress(&cinfo, buf, len)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  const int width = static_cast<int>(cinfo.output_width);
  const int height = static_cast<int>(cinfo.output_height);
  if (cinfo.output_components != 3 ||
      static_cast<long>(width) * height * 3 > out_cap) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + static_cast<long>(cinfo.output_scanline) * width * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *w = width;
  *h = height;
  return 0;
}

// Region decode: exactly the pixels [y0, y0+ch) x [x0, x0+cw) of the full
// decode, using jpeg_crop_scanline (columns, iMCU-aligned internally) +
// jpeg_skip_scanlines (rows). Cost scales with the touched scanlines/iMCU
// columns instead of the whole image. Returns 0 on success.
int fastjpeg_decode_crop_rgb8(const unsigned char* buf, long len, int x0,
                              int y0, int cw, int ch, unsigned char* out,
                              long out_cap) {
  if (x0 < 0 || y0 < 0 || cw <= 0 || ch <= 0) return -1;
  if (static_cast<long>(cw) * ch * 3 > out_cap) return -1;

  jpeg_decompress_struct cinfo;
  ErrMgr err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = on_error;
  err.pub.emit_message = on_message;
  // volatile: modified between setjmp and a potential longjmp — without it
  // the error path would read an indeterminate pointer (C setjmp rules)
  unsigned char* volatile scratch = nullptr;
  if (setjmp(err.jump)) {
    delete[] scratch;
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  if (!start_decompress(&cinfo, buf, len)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  if (cinfo.output_components != 3 ||
      x0 + cw > static_cast<int>(cinfo.output_width) ||
      y0 + ch > static_cast<int>(cinfo.output_height)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }

  // Column crop: libjpeg-turbo aligns the region to iMCU boundaries and
  // widens it; we decode [cx0, cx0+ccw) and copy out the requested slice.
  // Ask for an extra 8-px margin on both sides first: fancy chroma
  // upsampling needs neighbor context, so pixels in the outermost columns
  // of the decoded region differ from a full decode unless the region
  // edge coincides with the image edge (measured: last crop column off by
  // up to ~9/255 without the margin).
  const int img_w = static_cast<int>(cinfo.output_width);
  const int mx0 = x0 > 8 ? x0 - 8 : 0;
  const int mx1 = x0 + cw + 8 < img_w ? x0 + cw + 8 : img_w;
  JDIMENSION cx0 = static_cast<JDIMENSION>(mx0);
  JDIMENSION ccw = static_cast<JDIMENSION>(mx1 - mx0);
  jpeg_crop_scanline(&cinfo, &cx0, &ccw);
  const int xoff = x0 - static_cast<int>(cx0);

  if (y0 > 0) jpeg_skip_scanlines(&cinfo, static_cast<JDIMENSION>(y0));

  scratch = new unsigned char[static_cast<long>(ccw) * 3];
  while (static_cast<int>(cinfo.output_scanline) < y0 + ch) {
    JSAMPROW row = scratch;
    const int y = static_cast<int>(cinfo.output_scanline) - y0;
    jpeg_read_scanlines(&cinfo, &row, 1);
    std::memcpy(out + static_cast<long>(y) * cw * 3, scratch + xoff * 3,
                static_cast<long>(cw) * 3);
  }
  // Skip the tail instead of jpeg_finish_decompress (which requires all
  // scanlines consumed); abort is the documented early-exit.
  jpeg_abort_decompress(&cinfo);
  delete[] scratch;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Encode tightly-packed RGB8 to JPEG at the given quality (1..100).
// Returns bytes written, or -1 on error / insufficient out_cap. For SR
// serving responses a quality-90 JPEG is ~10x smaller than a fast-PNG of
// the same photographic output and encodes faster.
long fastjpeg_encode_rgb8(const unsigned char* rgb, int w, int h, int quality,
                          unsigned char* out, long out_cap) {
  if (!rgb || !out || w <= 0 || h <= 0) return -1;
  jpeg_compress_struct cinfo;
  ErrMgr err;
  cinfo.err = jpeg_std_error(&err.pub);
  err.pub.error_exit = on_error;
  err.pub.emit_message = on_message;
  // Caller-provided destination: the library only mallocs (and updates
  // `buf`) if the output outgrows out_cap — treated as failure below.
  unsigned char* buf = out;
  unsigned long sz = static_cast<unsigned long>(out_cap);
  if (setjmp(err.jump)) {
    jpeg_destroy_compress(&cinfo);
    // best effort: if the library had already swapped in its own realloc'd
    // buffer (output outgrew out_cap before the error), release it —
    // jpeg_destroy does not own the mem-dest buffer
    if (buf != out) free(buf);
    return -1;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, &buf, &sz);
  cinfo.image_width = static_cast<JDIMENSION>(w);
  cinfo.image_height = static_cast<JDIMENSION>(h);
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality < 1 ? 1 : (quality > 100 ? 100 : quality),
                   TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<JSAMPROW>(
        rgb + static_cast<long>(cinfo.next_scanline) * w * 3);
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  if (buf != out) {  // outgrew out_cap: library realloc'd its own buffer
    free(buf);
    return -1;
  }
  return static_cast<long>(sz);
}

}  // extern "C"
