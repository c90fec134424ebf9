"""The port's image codecs (food101_sr_tpu_torch.native) on the CPU: PNG
encode is lossless under PIL's decoder; PNGs of every color type, depth
and filter type decode exactly as PIL's ``convert("RGB")``, 16-bit and
Adam7-interlaced ones too; the formats the port does not read are refused
by name; JPEG decode, region decode and header probe are byte-equal to the
JAX package's libjpeg binding (the port's own codec links no library;
tests/test_torch_jpeg.py holds it in full). PIL is used here only, as the
reference decoder."""
import io
import struct
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from food101_sr_tpu import native as jax_native
from food101_sr_tpu_torch import _build, native

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from tools.export_port_assets import _png  # noqa: E402


def _rgb(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


def _pil_png(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="PNG", **kw)
    return buf.getvalue()


def _pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def _filter_row(kind, row, prev, bpp):
    """The PNG specification's filters, written out per byte (the test's
    own reference, independent of fast_png.cpp)."""
    out = bytearray(len(row))
    for i, x in enumerate(row):
        a = row[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = a
        elif kind == 2:
            pred = b
        elif kind == 3:
            pred = (a + b) // 2
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (x - pred) % 256
    return bytes(out)


def _hand_png(rows: np.ndarray, w: int, color: int, depth: int,
              filters, plte: bytes = b"", interlace: int = 0) -> bytes:
    """A PNG built byte by byte: ``rows`` (h, stride) of packed samples,
    row y filtered with ``filters[y % len(filters)]``."""
    h, stride = rows.shape
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    bpp = max(1, channels * depth // 8)
    raw, prev = bytearray(), bytes(stride)
    for y in range(h):
        kind = filters[y % len(filters)]
        row = rows[y].tobytes()
        raw += bytes([kind]) + _filter_row(kind, row, prev, bpp)
        prev = row
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace)
    return (native.PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + (_chunk(b"PLTE", plte) if plte else b"")
            + _chunk(b"IDAT", zlib.compress(bytes(raw)))
            + _chunk(b"IEND", b""))


@pytest.mark.parametrize("h,w", [(1, 1), (7, 13), (64, 64), (3, 200)])
@pytest.mark.parametrize("level", [0, 1, 9])
def test_png_encode_is_lossless_under_pil(h, w, level):
    img = _rgb(h, w, seed=h * w + level)
    data = native.encode_png_rgb8(img, level)
    assert data[24:26] == b"\x08\x02"  # 8-bit RGB
    pil = Image.open(io.BytesIO(data))
    assert pil.mode == "RGB" and np.array_equal(np.asarray(pil), img)
    assert np.array_equal(native.decode_png_rgb8(data), img)


def test_png_encode_uses_sub_filter_and_level():
    ramp = np.arange(16, dtype=np.uint8) * 16
    img = np.stack(np.broadcast_arrays(ramp[None, :], ramp[:, None],
                                       ramp[None, :] ^ ramp[:, None]), -1)
    img = np.ascontiguousarray(img)
    fast, small = native.encode_png_rgb8(img, 1), native.encode_png_rgb8(img, 9)
    for data in (fast, small):
        idat = data[33 + 8:-12 - 4]
        raw = zlib.decompress(idat)
        assert set(raw[::16 * 3 + 1]) == {1}  # every row SUB
    stored = native.encode_png_rgb8(img, 0)
    assert len(stored) > len(fast)
    with pytest.raises(ValueError):
        native.encode_png_rgb8(img.astype(np.float32))


def _pil_images():
    base = np.random.default_rng(5).integers(0, 256, (23, 29, 4), np.uint8)
    rgb = Image.fromarray(base[..., :3])
    return {
        "RGB": rgb, "RGBA": Image.fromarray(base, "RGBA"),
        "L": Image.fromarray(base[..., 0]),
        "LA": Image.fromarray(base[..., :2], "LA"),
        "P 8-bit": rgb.convert("P"), "P 4-bit": rgb.quantize(12),
        "P 2-bit": rgb.quantize(4), "P 1-bit": rgb.quantize(2),
        "1 (gray 1-bit)": Image.fromarray(base[..., 0]).convert("1"),
    }


@pytest.mark.parametrize("mode", list(_pil_images()))
@pytest.mark.parametrize("optimize", [False, True])
def test_pil_pngs_decode_as_pil_convert_rgb(mode, optimize):
    data = _pil_png(_pil_images()[mode], optimize=optimize)
    got = native.decode_image(data)
    assert got.dtype == np.uint8 and got.shape == (23, 29, 3)
    assert np.array_equal(got, _pil_rgb(data))


@pytest.mark.parametrize("color,depth", [(0, 8), (0, 4), (0, 2), (2, 8),
                                         (4, 8), (6, 8), (3, 8), (3, 4)])
def test_every_filter_type_decodes_as_pil(color, depth):
    """Rows filtered None, Sub, Up, Average, Paeth in turn (PIL's encoder
    chooses its own filters, so these are built by hand)."""
    h, w = 11, 9
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    rng = np.random.default_rng(color * 16 + depth)
    samples = rng.integers(0, 1 << depth, (h, w * channels), np.uint8)
    if depth < 8:  # pack, most significant bits first
        per = 8 // depth
        pad = (-samples.shape[1]) % per
        s = np.pad(samples, ((0, 0), (0, pad))).reshape(h, -1, per)
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        rows = (s << shifts).sum(axis=2).astype(np.uint8)
    else:
        rows = samples
    plte = rng.integers(0, 256, 3 << depth, np.uint8).tobytes() \
        if color == 3 else b""
    data = _hand_png(rows, w, color, depth, filters=(0, 1, 2, 3, 4),
                     plte=plte)
    assert np.array_equal(native.decode_image(data), _pil_rgb(data))


@pytest.mark.parametrize("what", ["16-bit", "Adam7"])
def test_16bit_and_interlaced_pngs_are_refused_by_name(what):
    """Once refused, now decoded as PIL's convert("RGB") decodes them (the
    JAX server's decode): 16-bit gray is PIL's I;16 clipped at 255, Adam7
    de-interlaced; tests/test_torch_codecs.py covers every depth."""
    if what == "16-bit":
        img = Image.fromarray(
            np.random.default_rng(2).integers(0, 65535, (8, 8), np.uint16))
        data = _pil_png(img)
        assert data[24] == 16
    else:
        # rows written in order but flagged Adam7: too short for the
        # passes, which PIL refuses too
        bad = _hand_png(_rgb(8, 8, 3).reshape(8, 24), 8, 2, 8, (0,),
                        interlace=1)
        with pytest.raises(OSError):
            _pil_rgb(bad)
        with pytest.raises(ValueError, match="truncated"):
            native.decode_image(bad)
        data = _png(_rgb(9, 13, 3), 8, 2, True)
        assert data[28] == 1
    assert np.array_equal(native.decode_image(data), _pil_rgb(data))


@pytest.mark.parametrize("damage", ["crc", "truncated", "filter", "no IEND"])
def test_broken_pngs_raise_value_error_not_unsupported(damage):
    """A bad CRC before the image data, image data cut short and an
    unknown filter are refused as PIL refuses them (ValueError: 400); a
    file that ends after its image data, without IEND, PIL decodes (it
    reads no chunk after the image data), and so does the port."""
    data = bytearray(native.encode_png_rgb8(_rgb(8, 8, 4)))
    if damage == "crc":
        data[20] ^= 0xFF  # inside IHDR
    elif damage == "truncated":
        data = data[:50]
    elif damage == "no IEND":
        data = data[:-12]
    else:  # row 0 names filter type 7, which does not exist
        raw = b"".join(bytes([7 if y == 0 else 0]) + bytes(24)
                       for y in range(8))
        data = (data[:33] + _chunk(b"IDAT", zlib.compress(raw))
                + _chunk(b"IEND", b""))
    if damage == "no IEND":
        assert np.array_equal(native.decode_image(bytes(data)),
                              _pil_rgb(bytes(data)))
        return
    with pytest.raises(ValueError) as e:
        native.decode_image(bytes(data))
    assert not isinstance(e.value, native.UnsupportedImage)


@pytest.mark.parametrize("data,name", [
    (b"BM" + bytes(60), "BMP"), (b"GIF89a" + bytes(20), "GIF"),
    (b"RIFF\x00\x00\x00\x00WEBPVP8 ", "WebP"), (b"II*\x00" + bytes(8), "TIFF"),
    (b"8BPS" + bytes(30), "PSD")])
def test_other_formats_are_refused_by_name(data, name):
    """PSD, which PIL opens and the port does not, is refused naming the
    format (415); BMP, GIF, WebP and TIFF are decoded now, so these broken
    ones are refused as PIL refuses them, with ValueError naming the
    format (400)."""
    if name in ("BMP", "GIF", "WebP", "TIFF"):
        with pytest.raises(ValueError, match=name) as e:
            native.decode_image(data)
        assert not isinstance(e.value, native.UnsupportedImage)
        with pytest.raises(OSError):
            _pil_rgb(data)
        return
    with pytest.raises(native.UnsupportedImage, match=name):
        native.decode_image(data)


def _ftyp(brand: bytes) -> bytes:
    return b"\x00\x00\x00\x1cftyp" + brand + bytes(4) + brand + b"mif1"


# one header each: the port's refused signatures, the ISO-BMFF brands, and
# formats PIL identifies but cannot load here
_SIGNATURES = {
    "PSD": b"8BPS\x00\x01" + bytes(6) + b"\x00\x03",
    "DDS": b"DDS |\x00\x00\x00\x07\x10\x00\x00",
    "JPEG 2000 codestream": b"\xffO\xffQ\x00/\x00\x00",
    "JPEG 2000 JP2": b"\x00\x00\x00\x0cjP  \r\n\x87\n\x00\x00\x00\x14ftypjp2 ",
    "ICNS": b"icns\x00\x00\x10\x00",
    "JBIG2": b"\x97JB2\r\n\x1a\n\x01\x00\x00\x00\x01",
    **{f"ftyp {b}": _ftyp(b.encode())
       for b in ("avif", "avis", "mif1", "msf1", "heic", "heix")},
    "BUFR": b"BUFR\x00\x00\x64\x04",
    "GRIB": b"GRIB\x00\x00\x64\x01",
    "HDF5": b"\x89HDF\r\n\x1a\n",
    "MPEG": b"\x00\x00\x01\xb3\x14\x00\xf0\x13",
    "EPS": b"%!PS-Adobe-3.0 EPSF-3.0\n%%BoundingBox: 0 0 16 16\n"
           b"%%EndComments\nshowpage\n%%EOF\n",
    "WMF": b"\xd7\xcd\xc6\x9a\x00\x00" + struct.pack("<hhhhH", 0, 0, 16,
                                                         16, 72),
}


def _pil_plugin(data: bytes):
    """The first PIL plugin, in ``Image.ID`` order, whose signature check
    takes these first 16 bytes as ``Image.open`` does (a string is a
    refusal with a warning; IM, IMT and IPTC have no check and come after
    every plugin that has one here)."""
    Image.init()
    for fmt in Image.ID:
        accept = Image.OPEN[fmt][1]
        if accept is not None:
            got = accept(data[:16])
            if got and not isinstance(got, str):
                return fmt
    return None


def _pil_loads_with(fmt) -> bool:
    """Whether PIL decodes pixels with plugin ``fmt``: its stubs have no
    loader without a handler, MPEG reads only the size, and EPS needs
    Ghostscript."""
    from PIL import EpsImagePlugin, ImageFile

    if fmt is None or issubclass(Image.OPEN[fmt][0], ImageFile.StubImageFile):
        return False
    if fmt == "EPS":
        return bool(EpsImagePlugin.has_ghostscript())
    return fmt != "MPEG"


@pytest.mark.parametrize("name", list(_SIGNATURES))
def test_refusals_follow_pil_plugins(name):
    """415 (UnsupportedImage) exactly where a PIL plugin that decodes
    accepts the header, the JAX server then serving the image; 400
    (ValueError) where no plugin accepts it or PIL's plugin cannot load
    it, the JAX server's ``Image.open(...).load()`` raising there."""
    data = _SIGNATURES[name] + bytes(64)
    fmt = _pil_plugin(data)
    if _pil_loads_with(fmt):
        with pytest.raises(native.UnsupportedImage) as e:
            native.decode_image(data)
        want = "AVIF/HEIF" if fmt == "AVIF" else name.split(" ")[0]
        assert want in str(e.value)
        return
    with pytest.raises(ValueError) as e:
        native.decode_image(data)
    assert not isinstance(e.value, native.UnsupportedImage)
    with pytest.raises((OSError, ValueError)):
        Image.open(io.BytesIO(data)).load()
    if name in ("JBIG2", "ftyp heic", "ftyp heix"):
        assert fmt is None


def test_refused_signatures_are_all_held_to_pil():
    """Every signature the port refuses by name is among the headers
    above, so the test before holds each one to PIL's plugins."""
    for magic, _ in native._OTHER_FORMATS:
        assert any(v.startswith(magic) for v in _SIGNATURES.values()), magic
    for brand in native._AVIF_BRANDS:
        assert _ftyp(brand) in _SIGNATURES.values(), brand


def test_non_image_bytes_are_a_value_error():
    with pytest.raises(ValueError) as e:
        native.decode_image(b"this is not an image at all")
    assert not isinstance(e.value, native.UnsupportedImage)


def _jpeg(h, w, seed, quality=90, mode="RGB"):
    img = Image.fromarray(_rgb(h, w, seed))
    buf = io.BytesIO()
    img.convert(mode).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


@pytest.fixture()
def libjpeg():
    """The JAX package's binding, the reference (the port needs none)."""
    if not jax_native.jpeg_available():
        pytest.skip("libjpeg is not present on this host")


@pytest.mark.parametrize("mode", ["RGB", "L"])
def test_jpeg_decode_is_byte_equal_to_jax(libjpeg, mode):
    data = _jpeg(48, 72, seed=6, mode=mode)
    got = native.decode_image(data)
    assert native.jpeg_dims(data) == jax_native.jpeg_dims(data) == (72, 48)
    assert np.array_equal(got, jax_native.decode_jpeg_rgb8(data))
    assert got.shape == (48, 72, 3)


@pytest.mark.parametrize("x0,y0,cw,ch", [(0, 0, 16, 16), (13, 7, 40, 30),
                                         (100, 90, 60, 38)])
def test_jpeg_crop_decode_is_byte_equal_to_jax(libjpeg, x0, y0, cw, ch):
    data = _jpeg(128, 160, seed=7)
    got = native.decode_jpeg_crop_rgb8(data, x0, y0, cw, ch)
    assert np.array_equal(got, jax_native.decode_jpeg_crop_rgb8(
        data, x0, y0, cw, ch))
    assert np.array_equal(got, native.decode_jpeg_rgb8(data)
                          [y0:y0 + ch, x0:x0 + cw])
    assert native.decode_jpeg_crop_rgb8(data, 150, 0, 20, 8) is None


def test_jpeg_encode_decodes_under_pil(libjpeg):
    img = _rgb(40, 56, seed=8)
    data = native.encode_jpeg_rgb8(img, 95)
    assert data == jax_native.encode_jpeg_rgb8(img, 95)
    assert Image.open(io.BytesIO(data)).format == "JPEG"
    assert native.decode_image(data).shape == img.shape


def test_codecs_build_into_the_port_build_dir():
    assert native.native_available()
    lib = native._libs["fast_png"]
    assert lib._name.startswith(_build.BUILD_DIR)
    assert "fast_png" in lib._name and lib._name.endswith(".so")
