"""JPEG 2000 uploads in the port's request decoder (food101_sr_tpu_torch/
native/jpeg2000.py, the codestream in native/fast_j2k.cpp), against PIL
with OpenJPEG 2.5.4, which the JAX package's server decodes uploads with:
every committed J2K and JP2 stream pixel-equal to PIL live and to its
golden (9/7 ones included, no tolerance); seeded images through PIL's
writer and the wheel's OpenJPEG encoder in each setting the decoder
branches on (wavelets, colour transforms, resolutions, layers,
progressions, tiles and offsets, precincts, code-block sizes and styles,
SOP/EPH, POC, tile-parts, ROI, subsampling, precisions, signed
components); JP2 boxes (colour spaces, palettes); cuts at every length
and seeded flips; the headers PIL's ``_open`` does not open (400), HTJ2K
and Part 2 (415); and uploads answered alike by both servers."""
import io
import json
import struct
import sys
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401
from PIL import Image

from food101_sr_tpu_torch import native, serve
from food101_sr_tpu_torch.native import jpeg2000, openers
from food101_sr_tpu_torch.serving import SRServer

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import serve as jax_serve  # noqa: E402
from chip_smoke import sha256  # noqa: E402
from tools import format_differential  # noqa: E402
from tools.raster_writers import (jp2_box, jp2_file,  # noqa: E402
                                  jpeg2000_streams, libopenjp2)

JPEG_ASSETS = ROOT / "food101_sr_tpu_torch" / "assets" / "jpeg"
GOLDENS = json.loads((JPEG_ASSETS / "goldens.json").read_text())["streams"]
STREAMS = sorted(n for n, g in GOLDENS.items()
                 if g["file"].endswith((".j2k", ".jp2")))
ASSET = ROOT / "food101_sr_tpu_torch" / "assets" / "winner_srcnn.pth"
CHECKPOINT = ROOT / "weights" / "winner_srcnn_best"
SIGNATURES = {"codestream": b"\xffO\xffQ\x00/\x00\x00",
              "JP2": b"\x00\x00\x00\x0cjP  \r\n\x87\n\x00\x00\x00\x14ftypjp2 "}
SRGB = b"\x01\x00\x00" + struct.pack(">I", 16)


def _same_as_pil(data) -> bool:
    return format_differential.difference(data) is None


def _photo(h, w, seed):
    from tools.make_fake_food101 import make_image
    return make_image(np.random.default_rng(seed), h, w)


def _pil_j2k(img, **kw) -> bytes:
    b = io.BytesIO()
    Image.fromarray(img).save(b, "JPEG2000", **kw)
    return b.getvalue()


@pytest.fixture(scope="module")
def opj():
    return libopenjp2()


def test_committed_streams_are_the_writers_bytes():
    made = jpeg2000_streams()
    assert {GOLDENS[n]["file"].split("/")[1] for n in STREAMS} == set(made)
    for name in STREAMS:
        f = GOLDENS[name]["file"]
        assert (JPEG_ASSETS / f).read_bytes() == made[f.split("/")[1]], f


@pytest.mark.parametrize("name", STREAMS)
def test_committed_stream_matches_pil_and_its_golden(name):
    g = GOLDENS[name]
    data = (JPEG_ASSETS / g["file"]).read_bytes()
    px = native.decode_image(data)
    assert list(px.shape) == g["shape"] and sha256(px) == g["served_sha256"]
    assert np.array_equal(px, format_differential.pil_outcome(data))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("irreversible", [False, True])
def test_seeded_sizes_and_offsets(seed, irreversible):
    """Odd sizes, image and tile offsets at every parity, RCT/ICT on and
    off, lossless and layered: the 9/7 path to PIL's last bit."""
    rng = np.random.default_rng(seed)
    h, w = (int(v) for v in rng.integers(9, 41, 2))
    img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    ox, oy = (int(v) for v in rng.integers(0, 7, 2))
    kw = dict(no_jp2=True, irreversible=irreversible, offset=(ox, oy),
              tile_offset=(ox // 2, oy // 2), tile_size=(int(rng.integers(
                  8, 24)), int(rng.integers(8, 24))),
              num_resolutions=int(rng.integers(1, 4)), mct=seed % 2,
              quality_mode="rates", quality_layers=[[0], [12, 3]][seed % 2])
    data = _pil_j2k(img, **kw)
    assert np.array_equal(native.decode_image(data),
                          format_differential.pil_outcome(data))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "I;16"])
@pytest.mark.parametrize("jp2", [False, True])
def test_modes(mode, jp2):
    img = Image.fromarray(_photo(20, 26, 3))
    img = (Image.fromarray(np.asarray(img)[..., 0].astype(np.uint16) * 200)
           if mode == "I;16" else img.convert(mode))
    b = io.BytesIO()
    img.save(b, "JPEG2000", no_jp2=not jp2, irreversible=mode == "LA")
    assert _same_as_pil(b.getvalue())


@pytest.mark.parametrize("order", ["LRCP", "RLCP", "RPCL", "PCRL", "CPRL"])
def test_progression_orders_with_precincts(order):
    img = _photo(40, 48, 4)
    data = _pil_j2k(img, no_jp2=True, progression=order, num_resolutions=3,
                    precinct_size=(16, 16), quality_mode="rates",
                    quality_layers=[20, 6, 0], codeblock_size=(8, 8))
    assert _same_as_pil(data)


@pytest.mark.parametrize("bits", [1, 2, 4, 8, 16, 32, 5, 63, 11])
@pytest.mark.parametrize("irreversible", [False, True])
def test_code_block_styles(opj, bits, irreversible):
    """BYPASS 1, RESET 2, TERMALL 4, VSC 8, PTERM 16, SEGSYM 32, alone and
    combined, with layers that cut code-blocks between passes."""
    img = _photo(24, 28, 5)
    data = opj.encode([img[..., i].astype(np.int32) for i in range(3)],
                      mode=bits, irreversible=irreversible, layers=(12, 4, 0),
                      cblk=(16, 8))
    assert _same_as_pil(data)


@pytest.mark.parametrize("case", ["sop_eph", "poc", "tileparts_R",
                                  "tileparts_C_tlm", "roi", "roi_97",
                                  "cblk4", "plt"])
def test_codestream_features(opj, case):
    img = _photo(40, 48, 6)
    planes = [img[..., i].astype(np.int32) for i in range(3)]
    kw = {"sop_eph": dict(csty=6, layers=(20, 5, 0)),
          "poc": dict(layers=(20, 0), pocs=[(0, 0, 2, 3, 3, 1),
                                            (3, 0, 2, 6, 3, 4)]),
          "tileparts_R": dict(tiles=(32, 16), tp_flag=b"R", resolutions=4),
          "tileparts_C_tlm": dict(tiles=(32, 32), tp_flag=b"C",
                                  options=["TLM=YES"], layers=(10, 0)),
          "roi": dict(roi=(0, 5)),
          "roi_97": dict(roi=(2, 9), irreversible=True, layers=(8,)),
          "cblk4": dict(cblk=(4, 4), resolutions=3),
          "plt": dict(options=["PLT=YES"], layers=(10, 0))}[case]
    assert _same_as_pil(opj.encode(planes, **kw))


@pytest.mark.parametrize("layout", ["420", "422", "440", "first", "jp2_ycc"])
def test_subsampled_components(opj, layout):
    """Subsampled chroma: PIL's sYCC conversion where the 2nd or 3rd
    component is subsampled (its heuristic for raw codestreams) or the JP2
    says sYCC, its floor strides, sRGB where the first one is."""
    img = _photo(24, 32, 7)
    y, cb, cr = (img[..., i].astype(np.int32) for i in range(3))
    sub = {"420": (2, 2), "422": (2, 1), "440": (1, 2), "first": (1, 1),
           "jp2_ycc": (2, 2)}[layout]
    dx, dy = [1, sub[0], sub[0]], [1, sub[1], sub[1]]
    planes = [y, cb[::sub[1], ::sub[0]], cr[::sub[1], ::sub[0]]]
    if layout == "first":
        dx, dy, planes = [2, 1, 1], [2, 1, 1], [y[::2, ::2], cb, cr]
    data = opj.encode(planes, dx=dx, dy=dy, mct=0, jp2=layout == "jp2_ycc",
                      colour=3 if layout == "jp2_ycc" else 1)
    assert _same_as_pil(data)


@pytest.mark.parametrize("prec,sgnd", [(1, 0), (4, 0), (7, 1), (10, 0),
                                       (12, 1), (16, 0), (16, 1)])
def test_precisions_and_signed(opj, prec, sgnd):
    """PIL's shifts to 8 bits (a rounding offset above 8, a wrap it does
    not clip), the signed offset; I;16 for one component over 8 bits."""
    img = _photo(16, 20, 8)
    top = (1 << prec) - 1
    planes = [(img[..., i].astype(np.int64) * top // 255
               - (sgnd << (prec - 1))).astype(np.int32) for i in range(3)]
    for data in (opj.encode(planes, prec=[prec] * 3, sgnd=[sgnd] * 3),
                 opj.encode(planes[:1], prec=[prec], sgnd=[sgnd])):
        assert _same_as_pil(data)


def _pclr(entries, depths):
    return jp2_box(b"pclr", struct.pack(">HB", len(entries), len(depths))
                   + bytes(depths) + b"".join(bytes(e) for e in entries))


@pytest.mark.parametrize("case", ["cmap", "no cmap", "repeats", "few",
                                  "grey space", "16-bit entries", "rgba",
                                  "pa"])
def test_jp2_palettes(opj, case):
    """``pclr``: PIL reads the palette (``getcolor``: a repeated entry
    keeps one index), OpenJPEG hands it the indices; a palette over 8 bits
    is not read (L); a grey colour space has no P unpacker (400)."""
    rng = np.random.default_rng(9)
    idx = rng.integers(0, 8, (12, 14)).astype(np.int32)
    pal = rng.integers(0, 256, (8, 3)).astype(np.uint8)
    cmap = jp2_box(b"cmap", b"".join(struct.pack(">HBB", 0, 1, k)
                                     for k in range(3)))
    cs, nc, colr = opj.encode([idx], prec=[3]), 1, SRGB
    box = _pclr(pal, (7, 7, 7)) + cmap
    if case == "no cmap":
        box = _pclr(pal, (7, 7, 7))
    elif case == "repeats":
        pal[6] = pal[1]
        box = _pclr(pal, (7, 7, 7)) + cmap
    elif case == "few":
        box = _pclr(pal[:5], (7, 7, 7)) + cmap
    elif case == "grey space":
        colr = b"\x01\x00\x00" + struct.pack(">I", 17)
    elif case == "16-bit entries":
        box = _pclr([b"\x01\x02\x03\x04\x05\x06"] * 8, (15, 15, 15))
    elif case == "rgba":
        box = _pclr(np.concatenate([pal, pal[:, :1]], 1), (7, 7, 7, 7))
    elif case == "pa":
        cs = opj.encode([idx, idx * 30], prec=[3, 8])
        nc = 2
    data = jp2_file(cs, w=14, h=12, nc=nc, bpc=255 if nc == 2 else 2,
                    colr=colr, extra_header=box)
    assert _same_as_pil(data)


@pytest.mark.parametrize("enumcs", [16, 17, 18, 12, 99, None, "icc"])
def test_jp2_colour_spaces(opj, enumcs):
    """sRGB, grey (no unpacker for 3 components: 400), sYCC (PIL's
    conversion), CMYK, an unknown enumeration, no ``colr`` and an ICC
    profile (PIL goes by the number of components)."""
    img = _photo(12, 16, 10)
    cs = opj.encode([img[..., i].astype(np.int32) for i in range(3)],
                    mct=0)
    colr = (None if enumcs is None else b"\x02\x00\x00" + bytes(40)
            if enumcs == "icc" else b"\x01\x00\x00" + struct.pack(">I",
                                                                  enumcs))
    assert _same_as_pil(jp2_file(cs, w=16, h=12, nc=3, colr=colr))


@pytest.mark.parametrize("name", ["j2k_53", "j2k_style_all_97",
                                  "jp2_pclr", "j2k_tileparts_tlm"])
def test_cuts_at_every_length(name):
    """OpenJPEG in strict mode: a cut tile-part fails (400); a stream cut
    just after a whole tile and the next marker's two bytes decodes the
    tiles before it; PIL's header parse falls through or ends the walk
    as it does."""
    data = (JPEG_ASSETS / GOLDENS[name]["file"]).read_bytes()
    for k in range(len(data)):
        assert _same_as_pil(data[:k]), (name, k)


def test_seeded_flips_match_pil():
    for name in STREAMS:
        data = (JPEG_ASSETS / GOLDENS[name]["file"]).read_bytes()
        if len(data) > 4096:
            continue
        rng = np.random.default_rng(sum(map(ord, name)))
        for i in range(6):
            b = bytearray(data)
            pos = int(rng.integers(0, 90 if i % 2 == 0 else len(b)))
            b[pos] ^= 1 << int(rng.integers(0, 8))
            assert format_differential.difference(bytes(b)) in (
                None, "refused"), (name, i, pos)


@pytest.mark.parametrize("name", sorted(SIGNATURES))
@pytest.mark.parametrize("tail", [0, 64])
def test_headers_pil_does_not_open_fall_through(name, tail):
    """A bare SIZ or JP2 signature: PIL's ``_open`` falls through
    (struct.error, SyntaxError) or ends the walk (a short box read), 400
    as on the JAX server, never the 415 the port once answered."""
    data = SIGNATURES[name] + bytes(tail)
    with pytest.raises(ValueError) as e:
        native.decode_image(data)
    assert not isinstance(e.value, native.UnsupportedImage)
    with pytest.raises(Exception):
        Image.open(io.BytesIO(data)).load()


@pytest.mark.parametrize("box", [b"jp2h", b"abcd"])
def test_jp2_boxes_of_64_bit_lengths(box):
    """An XL box length past 2^63: PIL's box reader raises (OSError on a
    short read, OverflowError seeking past it) and the walk ends: a 400,
    never another exception, which the port's server would not answer."""
    data = SIGNATURES["JP2"][:12] + struct.pack(">I4sQ", 1, box,
                                                 2 ** 64 - 1) + bytes(40)
    with pytest.raises(ValueError) as e:
        native.decode_image(data)
    assert not isinstance(e.value, native.UnsupportedImage)
    with pytest.raises((OSError, OverflowError)):
        Image.open(io.BytesIO(data)).load()


def test_htj2k_and_part2_are_refused_by_name(opj):
    """HTJ2K (Rsiz bit 14, or a CAP marker) and Part 2 extensions (Rsiz
    bit 15 with an MCT marker) answer 415 naming them."""
    data = opj.encode([np.zeros((8, 8), np.int32)])
    ht = data[:6] + bytes([data[6] | 0x40]) + data[7:]
    with pytest.raises(native.UnsupportedImage, match="HTJ2K"):
        native.decode_image(ht)
    i = data.index(b"\xff\x52")
    cap = data[:i] + b"\xff\x50\x00\x08\x00\x02\x00\x00\x00\x00" + data[i:]
    with pytest.raises(native.UnsupportedImage, match="HTJ2K"):
        native.decode_image(cap)
    p2 = data[:6] + bytes([data[6] | 0x80]) + data[7:i] + \
        b"\xff\x74\x00\x05\x00\x00\x00" + data[i:]
    with pytest.raises(native.UnsupportedImage, match="Part 2"):
        native.decode_image(p2)


def test_opener_table():
    assert "JPEG2000" not in openers.REFUSED and "JPEG 2000" in \
        openers.DECODED
    assert dict((n, o) for n, _, o in openers.OPENERS)["JPEG2000"] is \
        jpeg2000.open_jpeg2000


@pytest.fixture(scope="module")
def srcnn_servers():
    jsrv = jax_serve.SRServer("auto", str(CHECKPOINT), dtype=jnp.float32)
    psrv = SRServer("auto", checkpoint=str(ASSET), dtype=torch.float32,
                    device="cpu")
    jhttpd = jax_serve.SRHTTPServer(("127.0.0.1", 0),
                                    jax_serve.make_handler(jsrv))
    phttpd = serve.SRHTTPServer(("127.0.0.1", 0), serve.make_handler(psrv))
    for h in (jhttpd, phttpd):
        threading.Thread(target=h.serve_forever, daemon=True).start()
    yield jhttpd.server_address[1], phttpd.server_address[1], psrv
    for h in (jhttpd, phttpd):
        h.shutdown()
        h.server_close()
    psrv.close()


def _post(port, body):
    import urllib.error
    import urllib.request
    req = urllib.request.Request(f"http://127.0.0.1:{port}/sr", data=body,
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.mark.parametrize("name", ["j2k_97", "jp2_pclr", "j2k_sycc420"])
def test_upload_answered_as_the_jax_server(srcnn_servers, name):
    """200 from both; the port's body is the PNG of its engine's upscale
    of PIL's pixels, and the bodies decode within 1 level of each other;
    a cut stream is a 400 from both."""
    jport, pport, psrv = srcnn_servers
    data = (JPEG_ASSETS / GOLDENS[name]["file"]).read_bytes()
    (jcode, jbody), (pcode, pbody) = _post(jport, data), _post(pport, data)
    assert jcode == pcode == 200
    assert pbody == native.encode_png_rgb8(
        psrv.upscale(format_differential.pil_outcome(data)), psrv.png_level)
    jpx = native.decode_image(jbody).astype(np.int16)
    assert np.abs(jpx - native.decode_image(pbody)).max() <= 1
    cut = data[:len(data) // 2]
    assert _post(jport, cut)[0] == _post(pport, cut)[0] == 400


@pytest.mark.parametrize("name", sorted(SIGNATURES))
def test_probe_answered_400_by_both_servers(srcnn_servers, name):
    body = SIGNATURES[name] + bytes(64)
    jport, pport, _ = srcnn_servers
    assert _post(jport, body)[0] == _post(pport, body)[0] == 400
