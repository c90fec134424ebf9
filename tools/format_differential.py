#!/usr/bin/env python3
"""Differential sweeps of the port's opener walk and its legacy raster
decoders against PIL (the JAX server's decoder), on the CPU: where does
``native.decode_image`` answer otherwise than ``Image.open(...).convert(
"RGB")``?

    python3 tools/format_differential.py [--what cuts,flips,walk,iptc,order] \\
        [--seeds 1,2,...] [--per_stream 60] [--kinds psd,j2k,jp2]

* ``cuts``: each stream of ``tools/raster_writers.legacy_streams()`` (the
  committed TGA, DIB, PCX, DCX, SGI, Sun, IM, IMT, IPTC and SPIDER
  streams), ``psd_streams()`` and ``jpeg2000_streams()`` (PSD, J2K and
  JP2) and a seeded PhotoCD, cut at ``--per_stream`` seeded lengths and
  (seed 1) at every length of its first 40 bytes, or of the whole file
  for a PSD or JPEG 2000 stream of at most 8 KB; ``--kinds`` keeps the
  streams of the file kinds named;
* ``flips``: 1-3 seeded bit flips of each of them, ``--per_stream``
  files a seed, half of them in the first 64 bytes;
* ``walk``: headers built to land between openers: TGAs whose first
  bytes are CUR's, ICO's, PCX's, IPTC's or MPEG's signature, or that an
  IM, IMT or SPIDER header parse could take, seeded random 18-byte
  headers before seeded pixel data, and random short byte strings;
* ``iptc``: IPTC images embedding IPTC images (``nest_cases``), whole or
  as one band, around grey and colour JPEGs, a PNG and a TGA;
* ``order``: every committed stream (``assets/jpeg/goldens.json``) and
  the cases above, opened by PIL in a fresh process (``Image.open``'s
  first pass over BMP, DIB, GIF, JPEG, PPM and PNG, then the rest, as the
  JAX server walks them) and after ``Image.init()`` (the full
  ``Image.ID`` order the port follows): the count of files whose answer
  depends on the order.

PIL's side raises for a file where it raises anything (the JAX server
answers 400 to any exception); the port's raises only where it raises
ValueError (its server's 400), and anything else it raises but
``UnsupportedImage`` (415) is a crash, which its server answers with no
response at all. A file differs in outcome where one side decodes and
the other raises (or the port answers 415 where PIL raises), in pixels
where both decode to other pixels; a crash is counted apart; where PIL
decodes and the port answers 415 naming what it lacks, the file counts
as refused by name. Prints one JSON line per sweep: files, outcome and
pixel differences, crashes, and the first few differing cases. PIL is
the yardstick; nothing here is the port's.
"""
from __future__ import annotations

import argparse
import io
import json
import os
import pickle
import struct
import subprocess
import sys
import tempfile

import numpy as np
import warnings

from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from food101_sr_tpu_torch import native  # noqa: E402
from tools.raster_writers import (iptc, jpeg2000_streams,  # noqa: E402
                                  legacy_streams, pcd, pil_save,
                                  psd_streams, tga)

JPEG_ASSETS = os.path.join(ROOT, "food101_sr_tpu_torch", "assets", "jpeg")
warnings.simplefilter("ignore", Image.DecompressionBombWarning)


def pil_outcome(data):
    """PIL's pixels, or "raises" (PIL raises OSError, ValueError,
    SyntaxError, ...: the JAX server answers 400 to each)."""
    try:
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception:
        return "raises"


def port_outcome(data):
    """The port's pixels, "415", "raises" (ValueError, its server's 400)
    or "crash (<exception>)"."""
    try:
        return native.decode_image(data)
    except native.UnsupportedImage:
        return "415"
    except ValueError:
        return "raises"
    except Exception as e:  # its server answers nothing
        return f"crash ({type(e).__name__})"


def difference(data) -> str | None:
    """None where the port answers as PIL does, "refused" where PIL
    decodes and the port names what it lacks (415), "crash" where the
    port raises what its server does not answer, else "outcome" or
    "pixels"."""
    a, b = pil_outcome(data), port_outcome(data)
    if isinstance(b, str) and b.startswith("crash"):
        return "crash"
    if isinstance(b, str) and b == "415" and not isinstance(a, str):
        return "refused"
    if isinstance(a, str) or isinstance(b, str):
        same = (a if isinstance(a, str) else "px") == \
            (b if isinstance(b, str) else "px")
        return None if same else "outcome"
    return None if a.shape == b.shape and np.array_equal(a, b) else "pixels"


def pcd_sample(seed: int = 3, orientation: int = 1) -> bytes:
    rng = np.random.default_rng(seed)
    return pcd(rng.integers(0, 256, (512, 768)), rng.integers(0, 256,
                                                             (256, 384)),
               rng.integers(0, 256, (256, 384)), orientation)


# the kinds cut at every length (seed 1)
WHOLE_CUTS = (".psd", ".j2k", ".jp2")
KINDS = None  # --kinds: the file kinds swept (None: all)


def streams() -> dict:
    out = dict(legacy_streams()) | psd_streams() | jpeg2000_streams()
    out["pcd.pcd"] = pcd_sample()
    if KINDS is not None:
        out = {k: v for k, v in out.items()
               if k.rsplit(".", 1)[1] in KINDS}
    return out


def cut_cases(seed: int, per: int) -> list:
    rng = np.random.default_rng(seed)
    cases = []
    for name, data in streams().items():
        n = len(data)
        whole = name.endswith(WHOLE_CUTS) and n <= 8192
        lengths = set(range(n if whole else min(40, n))) if seed == 1 \
            else set()
        lengths |= {int(x) for x in rng.integers(0, n, per)}
        cases += [(f"{name}[:{k}]", data[:k]) for k in sorted(lengths)]
    return cases


def flip_cases(seed: int, per: int) -> list:
    rng = np.random.default_rng(1000 + seed)
    cases = []
    for name, data in streams().items():
        for i in range(per):
            b = bytearray(data)
            flips = []
            for _ in range(int(rng.integers(1, 4))):
                span = 64 if i % 2 == 0 else len(b)
                pos = int(rng.integers(0, min(span, len(b))))
                bit = int(rng.integers(0, 8))
                b[pos] ^= 1 << bit
                flips.append((pos, bit))
            cases.append((f"{name} flips {flips}", bytes(b)))
    return cases


def walk_cases(seed: int, per: int) -> list:
    """Bytes that land between the openers (module docstring)."""
    rng = np.random.default_rng(2000 + seed)
    px = rng.integers(0, 256, (6, 7, 3)).astype(np.uint8)
    cases = [
        ("TGA with CUR's signature", tga(px, 2, 24)),
        ("TGA with ICO's signature", tga(px[..., 0], 1, 8)),
        ("TGA type 1, ICO's signature, colour-map bytes", tga(
            px[..., 0], 1, 8)[:3] + b"\x00\x02\x00" + tga(px[..., 0], 1,
                                                          8)[6:]),
        ("TGA read by PCX (id length 10, no map)",
         tga(px, 2, 24, ident=b"0123456789")),
        ("TGA read by IPTC (id length 28, a map start over 132)",
         tga(px[..., 0], 1, 8, ident=b"x" * 28, cmap=bytes(3 * 200),
             cmap_start=200, cmap_depth=24)),
        ("TGA read by MPEG", b"\x00\x00\x01\xb3" + tga(px, 2, 24)[4:]),
        ("TGA read by IMT", b" \n" + tga(px, 2, 24)[2:]),
    ]
    for i in range(per):
        hdr = bytearray(rng.integers(0, 256, 18).astype(np.uint8).tobytes())
        hdr[1] = int(rng.integers(0, 2))
        hdr[2] = int(rng.choice([1, 2, 3, 9, 10, 11]))
        hdr[16] = int(rng.choice([1, 8, 16, 24, 32]))
        hdr[0] = int(rng.integers(0, 40))
        hdr[12:16] = struct.pack("<HH", int(rng.integers(1, 20)),
                                 int(rng.integers(1, 20)))
        hdr[5:7] = struct.pack("<H", int(rng.integers(0, 300)))
        body = rng.integers(0, 256, int(rng.integers(0, 4000))).astype(
            np.uint8).tobytes()
        cases.append((f"random TGA header {i}", bytes(hdr) + body))
        short = rng.integers(0, 256, int(rng.integers(0, 40))).astype(
            np.uint8).tobytes()
        cases.append((f"random bytes {i}", short))
    return cases


def nest_cases(seed: int, per: int = 0) -> list:
    """IPTC images embedding IPTC images: band-less wrappers (the
    embedded image whole) up to 4 deep around a grey or colour JPEG, a
    PNG or a TGA, one-band wrappers (``Image.merge``) around them or
    around each other, and wrappers whose size is not their image's."""
    rng = np.random.default_rng(3000 + seed)
    h, w = (int(x) for x in rng.integers(4, 12, 2))
    img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    cores = {"grey JPEG": pil_save(img, "JPEG", "L"),
             "colour JPEG": pil_save(img, "JPEG"),
             "PNG": pil_save(img, "PNG"), "TGA": tga(img, 2, 24)}

    def wrap(d, depth, size=(w, h)):
        for _ in range(depth):
            d = iptc(d, *size, compression=5)
        return d

    cases = []
    for label, core in cores.items():
        for depth in range(1, 5):
            cases.append((f"{label} in {depth} band-less IPTC",
                          wrap(core, depth)))
        for band, layers in ((1, 3), (2, 3), (4, 4)):
            inner = wrap(core, int(rng.integers(0, 3)))
            cases.append((f"{label} as band {band} of {layers}", iptc(
                inner, w, h, compression=5, layers=layers, component=1,
                band=band)))
        cases.append((f"{label} in a band-less IPTC of another size",
                      iptc(wrap(core, 1, (w + 1, h)), w, h, compression=5,
                           layers=3, component=1, band=1)))
    band = iptc(cores["grey JPEG"], w, h, compression=5, layers=3,
                component=1, band=1)
    for b in (1, 2):
        cases.append((f"a one-band IPTC as band {b} of another", iptc(
            band, w, h, compression=5, layers=3, component=1, band=b)))
    cases.append(("a one-band IPTC in 2 band-less IPTC", wrap(band, 2)))
    return cases


_ORDER_SCRIPT = r"""
import hashlib, io, pickle, sys
import numpy as np
from PIL import Image
cases = pickle.load(open(sys.argv[1], "rb"))
if sys.argv[2] == "init":
    Image.init()
out = []
for data in cases:
    try:
        a = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        out.append(hashlib.sha256(a.tobytes() + bytes(str(a.shape), "ascii")
                                  ).hexdigest())
    except Exception as e:
        out.append(type(e).__name__)
pickle.dump((out, list(Image.ID)), open(sys.argv[3], "wb"))
"""


def order_sweep(cases: list) -> dict:
    """Each case opened by PIL in a fresh process, and after
    ``Image.init()`` in another: the cases whose answer differs."""
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "cases.pkl")
        with open(src, "wb") as f:
            pickle.dump([d for _, d in cases], f)
        got = {}
        for kind in ("fresh", "init"):
            dst = os.path.join(tmp, f"{kind}.pkl")
            subprocess.run([sys.executable, "-c", _ORDER_SCRIPT, src, kind,
                            dst], check=True)
            with open(dst, "rb") as f:
                got[kind] = pickle.load(f)
    diff = [name for (name, _), a, b in zip(cases, got["fresh"][0],
                                             got["init"][0]) if a != b]
    return {"sweep": "order", "files": len(cases),
            "answers_differ": len(diff), "first": diff[:8],
            "fresh_order": got["fresh"][1], "init_order": got["init"][1]}


def committed() -> list:
    with open(os.path.join(JPEG_ASSETS, "goldens.json")) as f:
        g = json.load(f)
    files = [e["file"] for e in g["streams"].values()]
    out = []
    for rel in files:
        with open(os.path.join(JPEG_ASSETS, rel), "rb") as f:
            out.append((rel, f.read()))
    return out


def sweep(name: str, cases: list) -> dict:
    diffs = {"outcome": [], "pixels": [], "crash": [], "refused": []}
    for label, data in cases:
        d = difference(data)
        if d:
            diffs[d].append(label)
    return {"sweep": name, "files": len(cases),
            "outcome_differences": len(diffs["outcome"]),
            "pixel_differences": len(diffs["pixels"]),
            "crashes": len(diffs["crash"]),
            "refused_by_name": len(diffs["refused"]),
            "first": (diffs["crash"] + diffs["outcome"] + diffs["pixels"])[
                :8],
            "first_refused": diffs["refused"][:4]}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--what", default="cuts,flips,walk,iptc,order")
    p.add_argument("--seeds", default="1,2,3")
    p.add_argument("--per_stream", type=int, default=60)
    p.add_argument("--kinds", default="",
                   help="file kinds to sweep, e.g. psd,j2k,jp2 (all)")
    a = p.parse_args()
    global KINDS
    KINDS = set(a.kinds.split(",")) if a.kinds else None
    seeds = [int(s) for s in a.seeds.split(",")]
    what = a.what.split(",")
    makers = {"cuts": cut_cases, "flips": flip_cases, "walk": walk_cases,
              "iptc": nest_cases}
    every = []
    for name in ("cuts", "flips", "walk", "iptc"):
        if name not in what and "order" not in what:
            continue
        cases = [c for s in seeds for c in makers[name](s, a.per_stream)]
        every += cases
        if name in what:
            print(json.dumps(sweep(name, cases)), flush=True)
    if "order" in what:
        print(json.dumps(order_sweep(committed() + every)), flush=True)


if __name__ == "__main__":
    main()
