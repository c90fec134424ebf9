"""The port's JPEG codec (food101_sr_tpu_torch/native/fast_jpeg.cpp, no
library) on the CPU, against the JAX package's libjpeg binding and PIL:
decodes pixel-equal (0 levels) over sampling, progressive, optimized
Huffman, restart markers, grayscale, EXIF, 16-bit DQT and sizes from 1x1
to 97x131; region decodes equal to JAX's and to full-decode-then-crop;
encodes byte-equal at every tested quality and size; the features the JAX
package decodes too (CMYK, arithmetic coding, lossless) decoded as it
decodes them, those it refuses named; truncated streams decoded as libjpeg
decodes them and refused as PIL refuses them. PIL and libjpeg are the
references here only; the port links neither. tests/test_torch_codecs.py
holds the newer stream kinds at length."""
import ctypes
import io
import itertools
import json
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from food101_sr_tpu import native as jax_native
from food101_sr_tpu_torch import _build, native
from food101_sr_tpu_torch.data import Food101Source, SRDataLoader

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from chip_smoke import jpeg_test_image, sha256  # noqa: E402

JPEG_ASSETS = ROOT / "food101_sr_tpu_torch" / "assets" / "jpeg"

SIZES = [(1, 1), (2, 3), (7, 5), (16, 16), (33, 17), (97, 131)]


def _photo(h, w, seed):
    """Smooth structure plus noise, so that every coefficient band and
    both Huffman table classes are exercised."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 128 + 100 * np.sin(xx[..., None] / 5.0 + np.arange(3)) \
        * np.cos(yy[..., None] / 7.0)
    return np.clip(base + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(
        np.uint8)


def _pil_jpeg(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


@pytest.fixture(scope="module")
def libjpeg():
    """The JAX package's binding, the reference decoder and encoder."""
    if not jax_native.jpeg_available():
        pytest.skip("the JAX package's libjpeg binding does not build here")


def _dqt_precisions(data: bytes) -> set:
    """Pq of every table in the stream's DQT segments."""
    out, i = set(), 2
    while data[i + 1] != 0xDA:
        n = int.from_bytes(data[i + 2:i + 4], "big")
        if data[i + 1] == 0xDB:
            p = i + 4
            while p < i + 2 + n:
                out.add(data[p] >> 4)
                p += 1 + (128 if data[p] >> 4 else 64)
        i += 2 + n
    return out


VARIANTS = ["plain", "grayscale", "exif", "16-bit DQT"]


@pytest.mark.parametrize("sampling,progressive,optimize,restart,variant", [
    (s, p, o, r, v) for s, p, o, r, v in itertools.product(
        (0, 1, 2), (False, True), (False, True), (0, 1), VARIANTS)
    if not (v == "grayscale" and s)])
def test_decode_is_pixel_equal_to_libjpeg_and_pil(libjpeg, sampling,
                                                   progressive, optimize,
                                                   restart, variant):
    kw = dict(quality=85, subsampling=sampling, progressive=progressive,
              optimize=optimize)
    if restart:
        kw["restart_marker_blocks"] = restart
    if variant == "exif":
        exif = Image.Exif()
        exif[0x010E] = "a plate of food"
        kw["exif"] = exif.tobytes()
    if variant == "16-bit DQT":  # PIL writes them as given, unscaled
        kw["qtables"] = [list(range(200, 264)), [300] * 64]
        del kw["quality"]
    for h, w in SIZES:
        img = Image.fromarray(_photo(h, w, seed=h * w + sampling))
        if variant == "grayscale":
            img = img.convert("L")
        data = _pil_jpeg(img, **kw)
        if variant == "16-bit DQT":
            assert _dqt_precisions(data) == {1}
        got = native.decode_image(data)
        assert got.shape == (h, w, 3) and got.dtype == np.uint8
        assert native.jpeg_dims(data) == jax_native.jpeg_dims(data) == (w, h)
        assert np.array_equal(got, jax_native.decode_jpeg_rgb8(data)), (h, w)
        assert np.array_equal(got, _pil_rgb(data)), (h, w)


# Sampling layouts PIL does not write, made with libjpeg itself: h1v2
# (4:4:0), 4:1:1 and its vertical twin, 3:1 (replication), chroma sampled
# above luma, and mixed ratios. Factors are (h, v) of Y, Cb, Cr.
LAYOUTS = [(1, 2, 1, 1, 1, 1), (4, 1, 1, 1, 1, 1), (1, 4, 1, 1, 1, 1),
           (3, 1, 1, 1, 1, 1), (1, 1, 2, 2, 2, 2), (2, 2, 1, 2, 1, 2),
           (2, 2, 2, 1, 2, 1), (4, 2, 1, 1, 1, 1), (2, 2, 1, 1, 2, 2)]

_SAMPLE_ENC = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <jpeglib.h>
long sample_encode(const unsigned char* rgb, int w, int h, const int* hv,
                   int progressive, int restart_rows, unsigned char* out,
                   long cap) {
  struct jpeg_compress_struct c;
  struct jpeg_error_mgr e;
  unsigned char* buf = NULL;
  unsigned long sz = 0;
  c.err = jpeg_std_error(&e);
  jpeg_create_compress(&c);
  jpeg_mem_dest(&c, &buf, &sz);
  c.image_width = w;
  c.image_height = h;
  c.input_components = 3;
  c.in_color_space = JCS_RGB;
  jpeg_set_defaults(&c);
  jpeg_set_quality(&c, 80, TRUE);
  for (int i = 0; i < 3; i++) {
    c.comp_info[i].h_samp_factor = hv[2 * i];
    c.comp_info[i].v_samp_factor = hv[2 * i + 1];
  }
  if (progressive) jpeg_simple_progression(&c);
  c.restart_in_rows = restart_rows;
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW r = (JSAMPROW)(rgb + (long)c.next_scanline * w * 3);
    jpeg_write_scanlines(&c, &r, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  long n = (long)sz <= cap ? (long)sz : -1;
  if (n > 0) memcpy(out, buf, sz);
  free(buf);
  return n;
}
"""


@pytest.fixture(scope="module")
def sample_encode(libjpeg, tmp_path_factory):
    """libjpeg's encoder with chosen sampling factors (a test helper built
    here against the system libjpeg)."""
    d = tmp_path_factory.mktemp("sample_enc")
    (d / "enc.c").write_text(_SAMPLE_ENC)
    proc = subprocess.run(["gcc", "-O2", "-shared", "-fPIC", str(d / "enc.c"),
                           "-ljpeg", "-o", str(d / "libenc.so")],
                          capture_output=True, text=True)
    if proc.returncode:
        pytest.skip(f"libjpeg's headers are not here: {proc.stderr[:200]}")
    lib = ctypes.CDLL(str(d / "libenc.so"))
    lib.sample_encode.restype = ctypes.c_long
    lib.sample_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_long]

    def encode(img, hv, progressive, restart_rows):
        out = ctypes.create_string_buffer(4 * img.nbytes + 65536)
        n = lib.sample_encode(np.ascontiguousarray(img).ctypes.data,
                              img.shape[1], img.shape[0], (ctypes.c_int * 6)(*hv),
                              int(progressive), restart_rows, out, len(out))
        assert n > 0
        return out.raw[:n]
    return encode


@pytest.mark.parametrize("hv", LAYOUTS, ids=lambda hv: "x".join(map(str, hv)))
@pytest.mark.parametrize("progressive", [False, True])
def test_other_sampling_layouts_decode_as_libjpeg(sample_encode, hv,
                                                  progressive):
    for (h, w), restart in zip([(1, 1), (5, 9), (17, 23), (40, 33)],
                               [0, 1, 0, 1]):
        data = sample_encode(_photo(h, w, h + w), hv, progressive, restart)
        got = native.decode_jpeg_rgb8(data)
        assert np.array_equal(got, jax_native.decode_jpeg_rgb8(data)), (h, w)
        x0, y0 = w // 3, h // 2
        assert np.array_equal(
            native.decode_jpeg_crop_rgb8(data, x0, y0, w - x0, h - y0),
            got[y0:, x0:])


CROP_STREAMS = {
    "4:2:0": dict(subsampling=2), "4:2:2": dict(subsampling=1),
    "4:4:4": dict(subsampling=0), "progressive": dict(progressive=True),
    "restart": dict(restart_marker_blocks=2), "grayscale": {},
}
# (x0, y0, cw, ch) on a 77 x 101 image: corners, edges, the interior, a
# single pixel, the whole image
CROPS = [(0, 0, 16, 16), (85, 61, 16, 16), (0, 40, 101, 1), (100, 76, 1, 1),
         (13, 7, 40, 30), (31, 17, 33, 45), (15, 15, 2, 2), (0, 0, 101, 77),
         (50, 0, 51, 77), (8, 16, 17, 9)]


@pytest.mark.parametrize("stream", list(CROP_STREAMS))
def test_crop_equals_full_decode_and_jax(libjpeg, stream):
    img = Image.fromarray(_photo(77, 101, seed=3))
    if stream == "grayscale":
        img = img.convert("L")
    data = _pil_jpeg(img, quality=90, **CROP_STREAMS[stream])
    full = native.decode_jpeg_rgb8(data)
    rng = np.random.default_rng(4)
    crops = CROPS + [(int(x), int(y), 20, 20) for x, y in
                     zip(rng.integers(0, 82, 10), rng.integers(0, 58, 10))]
    for x0, y0, cw, ch in crops:
        got = native.decode_jpeg_crop_rgb8(data, x0, y0, cw, ch)
        assert np.array_equal(got, full[y0:y0 + ch, x0:x0 + cw]), (x0, y0)
        assert np.array_equal(got, jax_native.decode_jpeg_crop_rgb8(
            data, x0, y0, cw, ch)), (x0, y0)
    for outside in [(90, 0, 20, 8), (0, 70, 8, 8), (-1, 0, 4, 4),
                    (0, 0, 0, 4)]:
        assert native.decode_jpeg_crop_rgb8(data, *outside) is None


@pytest.mark.parametrize("quality", [1, 50, 75, 90, 92, 100])
def test_encode_is_byte_equal_to_libjpeg(libjpeg, quality):
    for h, w in [(1, 1), (5, 3), (8, 16), (17, 33), (64, 48), (97, 131)]:
        img = _photo(h, w, seed=quality + h)
        data = native.encode_jpeg_rgb8(img, quality)
        assert data == jax_native.encode_jpeg_rgb8(img, quality), (h, w)
        assert np.array_equal(native.decode_jpeg_rgb8(data), _pil_rgb(data))
    noise = np.random.default_rng(quality).integers(0, 256, (40, 56, 3),
                                                    np.uint8)
    assert native.encode_jpeg_rgb8(noise, quality) == \
        jax_native.encode_jpeg_rgb8(noise, quality)


def test_encode_clamps_quality_and_checks_input():
    img = _photo(9, 9, 0)
    assert native.encode_jpeg_rgb8(img, 0) == native.encode_jpeg_rgb8(img, 1)
    assert native.encode_jpeg_rgb8(img, 150) == \
        native.encode_jpeg_rgb8(img, 100)
    for bad in (img.astype(np.float32), img[..., :2], img[..., 0]):
        with pytest.raises(ValueError):
            native.encode_jpeg_rgb8(bad)


def _sof_offset(data: bytes) -> int:
    i = 2
    while not (0xC0 <= data[i + 1] <= 0xCF
               and data[i + 1] not in (0xC4, 0xC8, 0xCC)):
        i += 2 + int.from_bytes(data[i + 2:i + 4], "big")
    return i


def _refused():
    """Each once-refused feature's stream: CMYK from PIL; arithmetic,
    12-bit, lossless and hierarchical by patching one SOF byte of a valid
    stream."""
    base = _pil_jpeg(Image.fromarray(_photo(24, 32, 1)), quality=80)
    i = _sof_offset(base)

    def patch(off, byte):
        return base[:i + off] + bytes([byte]) + base[i + off + 1:]
    return {
        "CMYK": _pil_jpeg(Image.fromarray(_photo(24, 32, 1)).convert("CMYK")),
        "arithmetic": patch(1, 0xC9),
        "12-bit": patch(4, 12),
        "lossless": patch(1, 0xC3),
        "hierarchical": patch(1, 0xC5),
    }


def _outcome(fn, *args):
    try:
        out = fn(*args)
    except (ValueError, OSError, SyntaxError):
        return "raises"
    return "raises" if out is None else np.asarray(out)


@pytest.mark.parametrize("feature", list(_refused()))
def test_refused_features_are_named(libjpeg, feature):
    """What the JAX package refuses too (12-bit, hierarchical: its libjpeg
    and PIL both) is refused by name by the dataset decoders and as PIL
    refuses it by the request decoder (ValueError: the JAX server answers
    400, not 415); the rest decodes as it decodes: CMYK
    through its PIL fallback, the arithmetic-patched stream (Huffman data
    read by the QM decoder: garbage, but libjpeg's garbage) through its
    libjpeg, the lossless-patched one as PIL takes it."""
    data = _refused()[feature]
    assert native.jpeg_dims(data) == (32, 24)
    if feature in ("12-bit", "hierarchical"):
        assert _outcome(jax_native.decode_jpeg_rgb8, data) == "raises"
        for call in (lambda: native.decode_jpeg_rgb8(data),
                     lambda: native.decode_jpeg_crop_rgb8(data, 0, 0, 8, 8)):
            with pytest.raises(native.UnsupportedImage, match=feature):
                call()
        with pytest.raises(ValueError, match=feature) as e:
            native.decode_image(data)
        assert not isinstance(e.value, native.UnsupportedImage)
        return
    want = _outcome(jax_native.decode_jpeg_rgb8, data)
    got = _outcome(native.decode_jpeg_rgb8, data)
    assert isinstance(want, str) == isinstance(got, str)
    if not isinstance(want, str):
        assert np.array_equal(got, want)
        assert np.array_equal(native.decode_jpeg_crop_rgb8(data, 0, 0, 8, 8),
                              _outcome(jax_native.decode_jpeg_crop_rgb8, data,
                                       0, 0, 8, 8) if feature == "arithmetic"
                              else want[:8, :8])
    served = _outcome(native.decode_image, data)
    pil = _outcome(_pil_rgb, data)
    assert isinstance(served, str) == isinstance(pil, str)
    if not isinstance(pil, str):
        assert np.array_equal(served, pil)


@pytest.mark.parametrize("progressive", [False, True])
def test_truncated_and_garbage_streams_are_value_errors(libjpeg, progressive):
    """The request decoder (PIL's semantics, the JAX server's) refuses a
    truncated or garbage stream with ValueError (400); the dataset decoders
    give what the JAX package's libjpeg binding gives for it: pixels where
    libjpeg decodes what was read, an error where it fails."""
    data = _pil_jpeg(Image.fromarray(_photo(40, 56, 2)), quality=80,
                     progressive=progressive)
    broken = [data[:cut] for cut in range(2, len(data) - 1, 23)]
    broken += [data[:-2], b"\xff\xd8\xff" + bytes(50),
               b"\xff\xd8\xff\xe0" + np.random.default_rng(5).integers(
                   0, 256, 500, np.uint8).tobytes()]
    # one corrupted byte in the entropy-coded data: a bad Huffman code or
    # data running into the marker
    sos = data.index(b"\xff\xda")
    broken.append(data[:sos + 20] + b"\xff\xff\xff\xff" + data[sos + 24:])
    for bad in broken:
        with pytest.raises(ValueError) as e:
            native.decode_image(bad)
        assert not isinstance(e.value, native.UnsupportedImage), e.value
        want = _outcome(jax_native.decode_jpeg_rgb8, bad)
        got = _outcome(native.decode_jpeg_rgb8, bad)
        assert isinstance(got, str) == isinstance(want, str), len(bad)
        if not isinstance(want, str):
            assert np.array_equal(got, want), len(bad)
        if native.jpeg_dims(bad):
            want = _outcome(jax_native.decode_jpeg_crop_rgb8, bad, 0, 0, 8, 8)
            got = _outcome(native.decode_jpeg_crop_rgb8, bad, 0, 0, 8, 8)
            assert isinstance(got, str) == isinstance(want, str), len(bad)
            if not isinstance(want, str):
                assert np.array_equal(got, want), len(bad)


def test_parallel_calls_equal_serial():
    """ctypes drops the GIL for each call: eight threads decoding,
    region-decoding and encoding at once give the serial results."""
    img = _photo(96, 128, 7)
    data = native.encode_jpeg_rgb8(img, 90)
    want = (native.decode_jpeg_rgb8(data),
            native.decode_jpeg_crop_rgb8(data, 17, 9, 64, 64),
            native.encode_jpeg_rgb8(img, 75))
    bad = []

    def work():
        for _ in range(10):
            got = (native.decode_jpeg_rgb8(data),
                   native.decode_jpeg_crop_rgb8(data, 17, 9, 64, 64),
                   native.encode_jpeg_rgb8(img, 75))
            if not (np.array_equal(got[0], want[0])
                    and np.array_equal(got[1], want[1]) and got[2] == want[2]):
                bad.append(1)
    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not bad


def test_codec_builds_into_the_port_build_dir_without_a_library():
    assert native.jpeg_available() and native.build_error("fast_jpeg") is None
    lib = native._libs["fast_jpeg"]
    assert lib._name.startswith(_build.BUILD_DIR) and "fast_jpeg" in lib._name


def test_a_codec_that_does_not_build_is_refused_by_name(monkeypatch):
    """A host where g++ cannot build the codec: every JPEG call raises
    UnsupportedImage naming the build failure; PNG is unaffected."""
    monkeypatch.setitem(native._libs, "fast_jpeg", None)
    monkeypatch.setitem(native._errors, "fast_jpeg", "g++: not found")
    assert not native.jpeg_available()
    data = native.encode_png_rgb8(_photo(8, 8, 1))
    jpeg = b"\xff\xd8\xff\xe0" + bytes(64)
    for call in (lambda: native.decode_image(jpeg),
                 lambda: native.encode_jpeg_rgb8(_photo(8, 8, 1)),
                 lambda: native.jpeg_dims(jpeg),
                 lambda: native.decode_jpeg_crop_rgb8(jpeg, 0, 0, 8, 8)):
        with pytest.raises(native.UnsupportedImage, match="did not build"):
            call()
    assert native.decode_image(data).shape == (8, 8, 3)


def test_committed_fixtures_match_their_goldens():
    """The fixtures and goldens that chip_smoke.py's food101 and http
    phases hold on the card (tools/export_port_assets.py --what jpeg):
    every JPEG stream's decode_jpeg_rgb8 has the JAX package's digest and
    every stream's decode_image PIL's (the JAX server's), WebP included,
    the truncated, 12-bit, hierarchical and past-64-KiB arithmetic ones
    refused as PIL refuses them (the binding refusing the 12-bit and
    hierarchical ones, as the JAX package's does), the
    seeded regions have the JAX package's region digests, both encodes
    hash to JAX's, and the loader's first two batches over the mini
    Food-101 tree (an arithmetic-coded and a CMYK image among them), train
    and eval, hash to JAX's."""
    goldens = json.loads((JPEG_ASSETS / "goldens.json").read_text())
    for name, g in goldens["streams"].items():
        data = (JPEG_ASSETS / g["file"]).read_bytes()
        if g.get("served_refused"):
            with pytest.raises(ValueError) as e:
                native.decode_image(data)
            assert not isinstance(e.value, native.UnsupportedImage), name
        else:
            assert sha256(native.decode_image(data)) == g["served_sha256"]
        if g.get("binding_refused"):
            with pytest.raises(native.UnsupportedImage):
                native.decode_jpeg_rgb8(data)
            continue
        if "sha256" not in g:  # a file of another format PIL refuses
            continue
        px = native.decode_jpeg_rgb8(data) if g["file"].endswith(".jpg") \
            else native.decode_image(data)
        assert list(px.shape) == g["shape"] and sha256(px) == g["sha256"], name
    for c in goldens["crops"]:
        data = (JPEG_ASSETS / goldens["streams"][c["stream"]]["file"]) \
            .read_bytes()
        assert sha256(native.decode_jpeg_crop_rgb8(
            data, c["x0"], c["y0"], c["cw"], c["ch"])) == c["sha256"], c
    for g in goldens["encode"]:
        img = jpeg_test_image(g["h"], g["w"], g["seed"])
        assert sha256(native.encode_jpeg_rgb8(img, g["quality"])) == \
            g["sha256"]
    lg = goldens["loader"]
    src = Food101Source(str(JPEG_ASSETS), lg["split"])
    assert len(src) == 16 and len(Food101Source(str(JPEG_ASSETS), "test")) \
        == 4
    assert sum(min(native.jpeg_dims(src.bytes_at(i))) < lg["crop_size"]
               for i in range(len(src))) == 2
    for mode, train in (("train", True), ("eval", False)):
        loader = SRDataLoader(src, crop_size=lg["crop_size"],
                              batch_size=lg["batch_size"], train=train,
                              seed=lg["seed"], device="cpu", num_workers=4)
        loader.set_epoch(0)
        got = [sha256(b.numpy()) for b in loader][:lg["batches"]]
        assert got == lg[mode], mode
