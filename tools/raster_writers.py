"""Writers for the TIFF, Netpbm, ICO, CUR, QOI, TGA, PCX, DCX, SGI, Sun,
IMT, IPTC, PhotoCD and SPIDER streams the port's decoders are held
against: layouts PIL's own writers do not make (tiles,
``PlanarConfiguration`` 2, predictors, BigTIFF, every bit depth and sample
format of TIFF's pixel table, fill order 2, JPEG strips with and without
``JPEGTables``, ICO/CUR with BMP payloads) assembled with ``struct``,
payloads from ``zlib``, ``lzma``, ``zstandard``, PIL's encoders or the
small PackBits, LZW and ThunderScan encoders here. The goldens are always
PIL's decode of the result.

Used by ``tools/export_port_assets.py --what jpeg`` and the port's tests;
needs numpy and PIL (and ``zstandard`` for ZSTD), not JAX.
"""
from __future__ import annotations

import ctypes
import io
import lzma
import struct
import zlib

import numpy as np
from PIL import Image

# TIFF field types: code -> struct code
_CODES = {1: "B", 3: "H", 4: "L", 6: "b", 8: "h", 9: "l", 11: "f", 12: "d",
          13: "L", 16: "Q"}


def tiff_file(tags: dict, chunks: list, order: str = "<", big: bool = False,
              tiled: bool = False, skip_first: bool = False,
              extra_offsets=None) -> bytes:
    """A TIFF whose first directory holds ``tags`` (tag -> (type, values),
    values a tuple of numbers, or bytes for types 1, 2 and 7) and the
    strips (or tiles) ``chunks``, their offsets and byte counts filled in.
    ``skip_first`` writes the first chunk but lists only the others;
    ``extra_offsets`` replaces the offsets (the counts then run to the end
    of the first chunk)."""
    e = order
    magic = (b"II" if e == "<" else b"MM") + struct.pack(e + "H",
                                                         43 if big else 42)
    data = bytearray(magic + (struct.pack(e + "HHQ", 8, 0, 0) if big
                              else struct.pack(e + "L", 0)))
    offsets = []
    for c in chunks:
        offsets.append(len(data))
        data += c
        if len(data) & 1:
            data += b"\0"
    tags = dict(tags)
    wide = 16 if big else 4
    off_tag, cnt_tag = (324, 325) if tiled else (273, 279)
    counts = [len(c) for c in chunks]
    if skip_first:
        offsets, counts = offsets[1:], counts[1:]
    if extra_offsets is not None:
        end = offsets[0] + counts[0]
        offsets = list(extra_offsets)
        counts = [end - o for o in offsets]
    tags[off_tag] = (wide, tuple(offsets))
    tags[cnt_tag] = (wide, tuple(counts))
    ifd_pos = len(data)
    n = len(tags)
    inline, ent = (8, 20) if big else (4, 12)
    extra_pos = ifd_pos + (8 if big else 2) + n * ent + inline
    ifd = bytearray(struct.pack(e + ("Q" if big else "H"), n))
    extra = bytearray()
    for tag, (typ, vals) in sorted(tags.items()):
        if isinstance(vals, (bytes, bytearray)):
            payload, count = bytes(vals), len(vals)
        elif typ == 5:
            payload = b"".join(struct.pack(e + "LL", *v) for v in vals)
            count = len(vals)
        else:
            payload = struct.pack(f"{e}{len(vals)}{_CODES[typ]}", *vals)
            count = len(vals)
        if len(payload) <= inline:
            field = payload.ljust(inline, b"\0")
        else:
            field = struct.pack(e + ("Q" if big else "L"),
                                extra_pos + len(extra))
            extra += payload
            if len(extra) & 1:
                extra += b"\0"
        ifd += struct.pack(e + ("HHQ" if big else "HHL"), tag, typ,
                           count) + field
    ifd += b"\0" * inline  # no next directory
    struct.pack_into(e + ("Q" if big else "L"), data, 8 if big else 4,
                     ifd_pos)
    return bytes(data + ifd + extra)


def packbits(raw: bytes) -> bytes:
    """PackBits: runs of 3 or more as repeats, the rest as literals."""
    out, i, n = bytearray(), 0, len(raw)
    while i < n:
        j = i
        while j + 1 < n and raw[j + 1] == raw[i] and j - i < 127:
            j += 1
        if j - i >= 2:
            out += bytes([257 - (j - i + 1), raw[i]])
            i = j + 1
            continue
        lit = i
        while lit < n and lit - i < 128 and not (
                lit + 2 < n and raw[lit] == raw[lit + 1] == raw[lit + 2]):
            lit += 1
        out += bytes([lit - i - 1]) + raw[i:lit]
        i = lit
    return bytes(out)


def lzw(raw: bytes) -> bytes:
    """TIFF LZW: 9-12 bit codes, most significant bit first, a code's width
    the bit length of the next free entry (libtiff's early change), Clear
    before the table fills, EOI at the end."""
    acc, nacc, out = 0, 0, bytearray()

    def emit(code, width):
        nonlocal acc, nacc
        acc = (acc << width) | code
        nacc += width
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 0xFF)

    def width(nxt):
        return max(9, min(12, nxt.bit_length()))
    table = {bytes([i]): i for i in range(256)}
    nxt = 258
    emit(256, 9)
    w = b""
    for b in raw:
        wc = w + bytes([b])
        if wc in table:
            w = wc
            continue
        emit(table[w], width(nxt))
        table[wc] = nxt
        nxt += 1
        w = bytes([b])
        if nxt == 4093:
            emit(256, width(nxt))
            table = {bytes([i]): i for i in range(256)}
            nxt = 258
    if w:
        emit(table[w], width(nxt))
        nxt += 1
    emit(257, width(nxt))
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


_REV = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _pack_rows(s: np.ndarray, bits: int, order: str, fmt: int) -> np.ndarray:
    """(rows, n) samples -> (rows, bytes) of each row packed MSB first at
    ``bits`` (8, 16 and 32 in the file's byte order; 32 float for fmt 3)."""
    rows = s.shape[0]
    if bits in (8, 16, 32):
        kind = "f" if fmt == 3 else "i" if fmt == 2 else "u"
        dt = np.dtype(f"{order}{kind}{bits // 8}")
        return s.astype(dt).view(np.uint8).reshape(rows, -1)
    v = s.astype(np.uint64)
    n = v.shape[1]
    total = n * bits
    nbytes = (total + 7) // 8
    out = np.zeros((rows, nbytes), np.uint8)
    for k in range(bits):  # bit k of each sample, MSB first
        bit = ((v >> np.uint64(bits - 1 - k)) & np.uint64(1)).astype(np.uint8)
        pos = np.arange(n) * bits + k
        np.bitwise_or.at(out, (slice(None), pos // 8),
                         (bit << (7 - pos % 8).astype(np.uint8)))
    return out


def _predict(rows: np.ndarray, pred: int, bits: int, spp: int, order: str,
             width: int) -> np.ndarray:
    """Differencing as libtiff's encoder applies it (rows of one strip or
    tile, in file order): 2 horizontal per sample, 3 floating point."""
    if pred == 2:
        dt = np.dtype(f"{order}u{bits // 8}")
        a = rows.view(dt).reshape(rows.shape[0], width, spp).astype(np.int64)
        d = np.diff(a, axis=1, prepend=0) % (1 << bits)
        d[:, 0] = a[:, 0]
        return d.astype(dt).view(np.uint8).reshape(rows.shape[0], -1)
    if pred == 3:
        nb = bits // 8
        a = rows.reshape(rows.shape[0], width * spp, nb)
        if order == "<":
            a = a[..., ::-1]  # most significant byte first
        planes = a.transpose(0, 2, 1).reshape(rows.shape[0], -1)
        p = planes.reshape(rows.shape[0], -1, spp).astype(np.int64)
        d = np.diff(p, axis=1, prepend=0) % 256
        d[:, 0] = p[:, 0]
        return d.astype(np.uint8).reshape(rows.shape[0], -1)
    return rows


def zstd(raw: bytes, level: int = 9, **kw) -> bytes:
    """A Zstandard frame from the ``zstandard`` module (libzstd): ``kw``
    takes ZstdCompressor's write_checksum and write_content_size."""
    import zstandard  # only the writers need it
    return zstandard.ZstdCompressor(level=level, **kw).compress(raw)


def thunderscan(samples: np.ndarray) -> bytes:
    """(h, w) 4-bit samples as ThunderScan (32809) codes, every kind used:
    runs of the last pixel, three 2-bit deltas (a "no delta" entry where
    fewer are left), two 3-bit deltas, raw pixels. Each row starts from
    pixel 0, as libtiff's decoder does."""
    out = bytearray()
    for row in samples.astype(int):
        last, i, w = 0, 0, len(row)
        while i < w:
            run = 0
            while i + run < w and row[i + run] == last and run < 63:
                run += 1
            if run >= 2:
                out.append(run)
                i += run
                continue
            two = {0: 0, 1: 1, -1: 3}
            d2, p = [], last
            for v in row[i:i + 3]:
                if (int(v) - p) not in two:
                    break
                d2.append(two[int(v) - p])
                p = int(v)
            if len(d2) >= 2 or (d2 and i + 1 == w):
                codes = d2 + [2] * (3 - len(d2))
                out.append(0x40 | codes[0] << 4 | codes[1] << 2 | codes[2])
                last, i = p, i + len(d2)
                continue
            three = {0: 0, 1: 1, 2: 2, 3: 3, -3: 5, -2: 6, -1: 7}
            d3, p = [], last
            for v in row[i:i + 2]:
                if (int(v) - p) not in three:
                    break
                d3.append(three[int(v) - p])
                p = int(v)
            if d3:
                codes = d3 + [4] * (2 - len(d3))
                out.append(0x80 | codes[0] << 3 | codes[1])
                last, i = p, i + len(d3)
                continue
            out.append(0xC0 | int(row[i]))
            last, i = int(row[i]), i + 1
    return bytes(out)


def raw16(img: Image.Image) -> bytes:
    """A bilevel image as raw-16 (32771) data: each row's Modified Huffman
    codes padded to a 16-bit boundary. PIL's libtiff writer codes each row
    alone (compression 2); its strip is cut to the fewest bytes PIL still
    decodes to the row, as its encoder may flush bytes past the codes."""
    bw = img.convert("1")
    w = bw.size[0]
    out = bytearray()
    for y in range(bw.size[1]):
        one = bw.crop((0, y, w, y + 1))
        t = Image.open(io.BytesIO(pil_tiff(one, compression="tiff_ccitt")))
        off, cnt = t.tag_v2[273][0], t.tag_v2[279][0]
        t.fp.seek(off)
        row = t.fp.read(cnt)
        want = np.asarray(one)
        tags = {256: (4, (w,)), 257: (4, (1,)), 258: (3, (1,)),
                259: (3, (2,)), 262: (3, (t.tag_v2[262],)), 277: (3, (1,)),
                278: (4, (1,))}
        while len(row) > 1:
            try:
                got = np.asarray(Image.open(io.BytesIO(tiff_file(
                    tags, [row[:-1]]))).convert("1"))
            except OSError:
                break
            if not np.array_equal(got, want):
                break
            row = row[:-1]
        out += row + b"\0" * (len(row) & 1)
    return bytes(out)


def compress(raw: bytes, compression: int) -> bytes:
    if compression == 1:
        return raw
    if compression == 50000:
        return zstd(raw)
    if compression == 32773:
        return packbits(raw)
    if compression == 5:
        return lzw(raw)
    if compression in (8, 32946):
        return zlib.compress(raw, 6)
    if compression == 34925:
        return lzma.compress(raw, lzma.FORMAT_XZ)
    raise ValueError(f"no encoder here for compression {compression}")


def tiff_image(samples: np.ndarray, bits, photometric: int, *,
               order: str = "<", compression: int = 1, planar: int = 1,
               rows_per_strip: int | None = None, tile=None,
               predictor: int = 1, fillorder: int = 1, sampleformat: int = 1,
               extra=(), colormap=None, big: bool = False,
               extra_tags: dict | None = None, chunk_codec=None) -> bytes:
    """``samples`` (h, w, spp) as a TIFF: ``bits`` per sample (an int, or
    a tuple written as given), strips of ``rows_per_strip`` rows or
    ``tile`` (tw, th) tiles (zero-padded at the edges), one plane per
    sample for ``planar`` 2, each chunk differenced by ``predictor``,
    compressed, and bit-reversed for ``fillorder`` 2. ``chunk_codec(pixels
    (rows, cols, spp)) -> bytes`` replaces packing and compression (JPEG)."""
    h, w, spp = samples.shape
    bits_t = bits if isinstance(bits, tuple) else (bits,) * spp
    b = bits_t[0]
    tags = {256: (4, (w,)), 257: (4, (h,)), 258: (3, bits_t),
            259: (3, (compression,)), 262: (3, (photometric,)),
            277: (3, (spp,)), 284: (3, (planar,))}
    if fillorder != 1:
        tags[266] = (3, (fillorder,))
    if predictor != 1:
        tags[317] = (3, (predictor,))
    if sampleformat != 1:
        tags[339] = (3, (sampleformat,) * spp)
    if extra:
        tags[338] = (3, tuple(extra))
    if colormap is not None:
        tags[320] = (3, tuple(int(v) for v in colormap))
    if tile:
        tw, th = tile
        tags[322], tags[323] = (4, (tw,)), (4, (th,))
        boxes = [(y, x, th, tw) for y in range(0, h, th)
                 for x in range(0, w, tw)]
    else:
        rps = rows_per_strip or h
        tags[278] = (4, (rps,))
        boxes = [(y, 0, min(rps, h - y), w) for y in range(0, h, rps)]
    tags.update(extra_tags or {})
    planes = [samples[..., i:i + 1] for i in range(spp)] if planar == 2 \
        else [samples]
    chunks = []
    for pl in planes:
        for y, x, ch, cw in boxes:
            block = np.zeros((ch, cw, pl.shape[2]), samples.dtype)
            part = pl[y:y + ch, x:x + cw]
            block[:part.shape[0], :part.shape[1]] = part
            if chunk_codec is not None:
                chunks.append(chunk_codec(block))
                continue
            rows = _pack_rows(block.reshape(ch, -1), b, order, sampleformat)
            rows = _predict(rows, predictor, b, pl.shape[2], order, cw)
            data = compress(rows.tobytes(), compression)
            if fillorder == 2:
                data = _REV[np.frombuffer(data, np.uint8)].tobytes()
            chunks.append(data)
    return tiff_file(tags, chunks, order, big, bool(tile))


def jpeg_strip(subsampling: int = 2, quality: int = 85):
    """A chunk codec: each strip or tile as a whole JPEG stream (JFIF,
    YCbCr at PIL's ``subsampling``: 0 4:4:4, 1 4:2:2, 2 4:2:0), or gray."""
    def codec(block: np.ndarray) -> bytes:
        buf = io.BytesIO()
        img = Image.fromarray(block[..., 0] if block.shape[2] == 1 else block)
        img.save(buf, "JPEG", quality=quality, subsampling=subsampling)
        return buf.getvalue()
    return codec


def jpeg_tables(strips: list) -> tuple:
    """Whole JPEG streams that share their tables -> (JPEGTables: SOI, the
    DQT and DHT segments, EOI; the abbreviated streams: SOI, the frame and
    scan, EOI)."""
    def segments(s):
        pos, out = 2, []
        while pos < len(s):
            m = s[pos + 1]
            if m == 0xDA:
                out.append((m, s[pos:]))
                break
            n = struct.unpack_from(">H", s, pos + 2)[0]
            out.append((m, s[pos:pos + 2 + n]))
            pos += 2 + n
        return out
    first = segments(strips[0])
    tables = b"\xff\xd8" + b"".join(b for m, b in first if m in (0xDB, 0xC4)) \
        + b"\xff\xd9"
    short = [b"\xff\xd8" + b"".join(b for m, b in segments(s)
                                    if m not in (0xDB, 0xC4, 0xE0))
             for s in strips]
    return tables, short


def ojpeg(img: np.ndarray, layout: str = "jif", subsampling: int = 2,
          rows_per_strip: int | None = None, quality: int = 85,
          photometric: int = 6, drop_tags=()) -> bytes:
    """An old-style JPEG (compression 6) TIFF of ``img`` (h, w, 3 uint8,
    or (h, w) for one sample) from PIL's JPEG at ``subsampling``, with a
    restart marker after each strip's MCU rows where there are several
    strips. ``layout``:

    * ``jif``: JPEGInterchangeFormat (513/514) points at the whole JPEG
      stream, and StripOffsets at its scan data;
    * ``jif_header``: JPEGInterchangeFormat holds the stream up to its
      scan header, each strip the data of its restart interval;
    * ``tables``: no stream header at all: the tables at JPEGQTables,
      JPEGDCTables and JPEGACTables (one per sample, shared where the
      offsets repeat), JPEGProc 1, and the strips' data as for
      ``jif_header`` (libtiff rebuilds the frame from the directory);
    * ``stream``: no JPEGInterchangeFormat; the first strip starts with the
      stream's header.

    ``drop_tags`` leaves those tags out (libtiff's defaults stand)."""
    h, w = img.shape[:2]
    gray = img.ndim == 2
    vs = 1 if gray or subsampling == 0 else (1 if subsampling == 1 else 2)
    rps = rows_per_strip or h
    kw = {}
    if rps < h:
        if rps % (8 * vs):
            raise ValueError("strips must hold whole MCU rows")
        kw["restart_marker_rows"] = rps // (8 * vs)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=quality,
                              subsampling=subsampling, **kw)
    jpg = buf.getvalue()
    sos = jpg.index(b"\xff\xda")
    head_end = sos + 2 + struct.unpack_from(">H", jpg, sos + 2)[0]
    scan = jpg[head_end:jpg.rindex(b"\xff\xd9")]
    # the restart intervals' data, without their RSTn markers
    parts, start = [], 0
    for k in range(len(scan) - 1):
        if scan[k] == 0xFF and 0xD0 <= scan[k + 1] <= 0xD7:
            parts.append(scan[start:k])
            start = k + 2
    parts.append(scan[start:])
    spp = 1 if gray else 3
    tags = {256: (4, (w,)), 257: (4, (h,)), 258: (3, (8,) * spp),
            259: (3, (6,)), 262: (3, (1 if gray else photometric,)),
            277: (3, (spp,)), 278: (4, (rps,)), 284: (3, (1,))}
    if not gray:
        tags[530] = (3, (1 if subsampling == 0 else 2,
                         1 if subsampling in (0, 1) else 2))
    for t in drop_tags:
        tags.pop(t, None)
    if layout == "jif":
        data = tiff_file({**tags, 513: (4, (0,)), 514: (4, (len(jpg),))},
                         [jpg])
        at = data.index(jpg)
        return tiff_file({**tags, 513: (4, (at,)), 514: (4, (len(jpg),))},
                         [jpg], extra_offsets=[at + head_end])
    if layout == "jif_header":
        head = jpg[:head_end]
        data = tiff_file({**tags, 513: (4, (0,)), 514: (4, (len(head),))},
                         [head] + parts)
        at = data.index(head)
        return tiff_file({**tags, 513: (4, (at,)), 514: (4, (len(head),))},
                         [head] + parts, skip_first=True)
    if layout == "stream":
        return tiff_file(tags, [jpg[:head_end] + parts[0]] + parts[1:])
    if layout != "tables":
        raise ValueError(layout)
    segs = {}
    pos = 2
    while pos < head_end:
        m = jpg[pos + 1]
        n = struct.unpack_from(">H", jpg, pos + 2)[0]
        body, q = jpg[pos + 4:pos + 2 + n], 0
        while m in (0xDB, 0xC4) and q < len(body):
            size = 65 if m == 0xDB else 17 + sum(body[q + 1:q + 17])
            segs[(m, body[q])] = body[q + 1:q + size]
            q += size
        pos += 2 + n
    qt = [segs[(0xDB, 0)], segs[(0xDB, 1 if not gray else 0)]]
    dc = [segs[(0xC4, 0x00)], segs[(0xC4, 0x01 if not gray else 0x00)]]
    ac = [segs[(0xC4, 0x10)], segs[(0xC4, 0x11 if not gray else 0x10)]]
    blob = b"".join(qt + dc + ac)
    pre = [0, len(qt[0]), len(qt[0]) + len(qt[1])]
    pre += [pre[2] + len(dc[0]), pre[2] + len(dc[0]) + len(dc[1])]
    pre += [pre[4] + len(ac[0])]
    data = tiff_file({**tags, 512: (3, (1,))}, [blob] + parts,
                     skip_first=True)
    at = data.index(blob)
    idx = (0,) if gray else (0, 1, 1)
    return tiff_file({**tags, 512: (3, (1,)),
                      519: (4, tuple(at + pre[i] for i in idx)),
                      520: (4, tuple(at + pre[2 + i] for i in idx)),
                      521: (4, tuple(at + pre[4 + i] for i in idx))},
                     [blob] + parts, skip_first=True)


def pil_tiff(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "TIFF", **kw)
    return buf.getvalue()


# ---------------------------------------------------------------------------
# Netpbm, ICO, CUR, QOI
# ---------------------------------------------------------------------------

def netpbm(magic: bytes, samples: np.ndarray, maxval: int | None = None,
           comment: bool = False) -> bytes:
    """P1-P6 (plain ones with a value per token, rows on lines) of
    ``samples`` (h, w[, c]); ``comment`` puts one in the header."""
    h, w = samples.shape[:2]
    head = magic + (b"\n# a comment\n" if comment else b"\n") + \
        b"%d %d\n" % (w, h)
    if maxval is not None:
        head += b"%d\n" % maxval
    if magic in (b"P1", b"P2", b"P3"):
        rows = samples.reshape(h, -1)
        body = b"\n".join(b" ".join(b"%d" % v for v in r)
                           for r in rows) + b"\n"
        return head + body
    if magic == b"P4":
        return head + np.packbits(samples.astype(np.uint8), axis=1).tobytes()
    dt = ">u2" if maxval is not None and maxval > 255 else np.uint8
    return head + samples.astype(dt).tobytes()


def pfm(values: np.ndarray, little: bool) -> bytes:
    """PIL's Pf: one float32 channel, rows bottom-up, the scale's sign the
    byte order."""
    h, w = values.shape
    head = b"Pf\n%d %d\n%s\n" % (w, h, b"-1.0" if little else b"1.0")
    return head + values[::-1].astype("<f4" if little else ">f4").tobytes()


def dib(img: np.ndarray, bits: int, palette=None, mask=None) -> bytes:
    """A BITMAPINFOHEADER DIB as ICO and CUR hold it: the height doubled,
    the XOR image bottom-up (8-bit palette indices, or 24/32-bit BGR(A)),
    then the 1-bit AND mask."""
    h, w = img.shape[:2]
    colors = 0 if palette is None else len(palette)
    if bits == 8:
        stride = (w + 3) & ~3
        rows = [bytes(r) + bytes(stride - w) for r in img[::-1]]
    else:
        k = bits // 8
        stride = (w * k + 3) & ~3
        px = img[..., [2, 1, 0, 3][:k]] if k == 4 else img[..., ::-1]
        rows = [r.tobytes() + bytes(stride - w * k) for r in px[::-1]]
    pal = b"" if palette is None else b"".join(
        bytes([b_, g, r, 0]) for r, g, b_ in palette)
    m = mask if mask is not None else np.zeros((h, w), np.uint8)
    mrow = ((w + 31) // 32) * 4
    mbits = b"".join(np.packbits(r).tobytes().ljust(mrow, b"\0")
                     for r in m[::-1])
    hdr = struct.pack("<IiiHHIIiiII", 40, w, 2 * h, 1, bits, 0,
                      len(rows) * stride, 0, 0, colors, 0)
    return hdr + pal + b"".join(rows) + mbits


def ico(entries: list, cursor: bool = False) -> bytes:
    """ICO (or CUR) of ``entries``: (width, height, colors, bpp, payload);
    a width or height of 256 is written as 0."""
    out = struct.pack("<HHH", 0, 2 if cursor else 1, len(entries))
    off = 6 + 16 * len(entries)
    body = b""
    for w, h, colors, bpp, payload in entries:
        out += struct.pack("<BBBBHHII", w % 256, h % 256, colors, 0,
                           1, bpp, len(payload), off + len(body))
        body += payload
    return out + body


def qoi(pixels: np.ndarray) -> bytes:
    """QOI through PIL's encoder (RGB or RGBA)."""
    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, "QOI")
    return buf.getvalue()


# ---------------------------------------------------------------------------
# TGA, PCX/DCX, SGI, Sun raster, IMT, IPTC, PhotoCD, SPIDER
# ---------------------------------------------------------------------------

def pil_save(img: np.ndarray, fmt: str, mode: str | None = None,
             **kw) -> bytes:
    """``img`` saved by PIL's own writer for ``fmt`` (in ``mode``)."""
    im = Image.fromarray(img)
    if mode is not None:
        im = im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def _tga_rle(rows: list, unit: int, runs_cross: bool = False) -> bytes:
    """Targa RLE packets over rows of pixels of ``unit`` bytes: runs of
    equal pixels (up to 128) and literals (up to 128), each row on its
    own unless ``runs_cross`` codes the image as one stream."""
    streams = [b"".join(rows)] if runs_cross else rows
    out = bytearray()
    for row in streams:
        px = [row[i:i + unit] for i in range(0, len(row), unit)]
        i = 0
        while i < len(px):
            j = i + 1
            while j < len(px) and j - i < 128 and px[j] == px[i]:
                j += 1
            if j - i > 1:
                out += bytes([0x80 | (j - i - 1)]) + px[i]
                i = j
                continue
            j = i + 1
            while (j < len(px) and j - i < 128
                   and (j + 1 >= len(px) or px[j + 1] != px[j])):
                j += 1
            out += bytes([j - i - 1]) + b"".join(px[i:j])
            i = j
    return bytes(out)


def tga(pixels: np.ndarray, imagetype: int, depth: int, *,
        cmap: bytes = b"", cmap_start: int = 0, cmap_depth: int = 0,
        flags: int = 0x20, ident: bytes = b"", rle: bool = False,
        runs_cross: bool = False) -> bytes:
    """A Targa file of ``pixels``, already in the file's byte layout: (h,
    w) for 1 byte a pixel, (h, w, k) for k bytes (BGR, BGRA, or 16-bit
    little-endian pairs), rows top-down here and written in the order
    ``flags`` gives (bit 5 clear: bottom-up; bit 4: right to left).
    ``imagetype`` 9-11 run-length code the rows with ``rle``; 1-bit images
    pass packed rows. ``cmap`` is the colour map's bytes (entries of
    ``cmap_depth`` bits) after ``cmap_start``."""
    h, w = pixels.shape[:2]
    px = pixels.reshape(h, w, -1)
    if flags & 0x10:
        px = px[:, ::-1]
    if not flags & 0x20:
        px = px[::-1]
    unit = px.shape[2] if depth > 1 else 1
    rows = [r.tobytes() for r in px]
    if depth == 1:
        w = int(pixels.shape[1]) * 8 if pixels.ndim == 2 else w
    n_entries = len(cmap) // max(1, cmap_depth // 8)
    hdr = struct.pack("<BBBHHBHHHHBB", len(ident), 1 if cmap_depth else 0,
                      imagetype, cmap_start, n_entries, cmap_depth, 0, 0,
                      w, h, depth, flags)
    body = _tga_rle(rows, unit, runs_cross) if rle else b"".join(rows)
    return hdr + ident + cmap + body


def _pcx_rle(row: bytes) -> bytes:
    out = bytearray()
    i = 0
    while i < len(row):
        j = i + 1
        while j < len(row) and j - i < 63 and row[j] == row[i]:
            j += 1
        if j - i > 1 or row[i] >= 0xC0:
            out += bytes([0xC0 | (j - i), row[i]])
        else:
            out.append(row[i])
        i = j
    return bytes(out)


def pcx(planes: list, bits: int, *, version: int = 5,
        palette16: bytes = bytes(48), vga: bytes | None = None,
        stride: int | None = None) -> bytes:
    """A PCX of ``planes`` (each (h, w): 0/1 for 1-bit planes, else
    bytes), rows run-length coded a scan line (all planes) at a time;
    ``stride`` the header's bytes a plane row (even, as the format wants,
    unless given); ``vga`` a 256-colour palette appended after 0x0C."""
    h, w = planes[0].shape
    row = (w * bits + 7) // 8
    stride = stride if stride is not None else row + row % 2
    lines = []
    for y in range(h):
        parts = []
        for p in planes:
            r = (np.packbits(p[y].astype(np.uint8)).tobytes() if bits == 1
                 else p[y].astype(np.uint8).tobytes())
            parts.append(r.ljust(stride, b"\0")[:stride])
        lines.append(_pcx_rle(b"".join(parts)))
    hdr = struct.pack("<BBBBHHHHHH", 10, version, 1, bits, 0, 0, w - 1,
                      h - 1, 72, 72) + palette16.ljust(48, b"\0")[:48]
    hdr += struct.pack("<BBHH", 0, len(planes), stride, 1).ljust(64, b"\0")
    out = hdr + b"".join(lines)
    if vga is not None:
        out += b"\x0c" + vga
    return out


def dcx(frames: list) -> bytes:
    """An Intel DCX of PCX ``frames``: the magic, the offset table (ended
    by 0), then the frames."""
    off = 4 + 4 * (len(frames) + 1)
    table, body = b"", b""
    for f in frames:
        table += struct.pack("<I", off + len(body))
        body += f
    return struct.pack("<I", 987654321) + table + b"\0" * 4 + body


def _sgi_rle(values: np.ndarray, bpc: int) -> bytes:
    """SGI RLE of one channel row: copy packets and runs of up to 127."""
    out = bytearray()
    v = [int(x) for x in values]
    pack = (lambda x: bytes([x])) if bpc == 1 else (
        lambda x: struct.pack(">H", x))
    i = 0
    while i < len(v):
        j = i + 1
        while j < len(v) and j - i < 127 and v[j] == v[i]:
            j += 1
        if j - i > 2:
            out += pack(j - i) + pack(v[i])
            i = j
            continue
        j = i + 1
        while j < len(v) and j - i < 127 and not (
                j + 2 < len(v) and v[j] == v[j + 1] == v[j + 2]):
            j += 1
        out += pack(0x80 | (j - i)) + b"".join(pack(x) for x in v[i:j])
        i = j
    return bytes(out + pack(0))


def sgi(img: np.ndarray, bpc: int = 1, rle: bool = False,
        dimension: int | None = None) -> bytes:
    """An SGI image of ``img`` (h, w) or (h, w, z), values of ``bpc``
    bytes, rows bottom-up; ``rle`` writes the offset and length tables
    and a run-length coded row per channel."""
    px = img if img.ndim == 3 else img[..., None]
    h, w, z = px.shape
    dim = dimension or (3 if z > 1 else 2)
    hdr = struct.pack(">HBBHHHH", 474, int(rle), bpc, dim, w, h, z)
    hdr = hdr.ljust(512, b"\0")
    rows = px[::-1]
    if not rle:
        dt = np.uint8 if bpc == 1 else ">u2"
        return hdr + b"".join(rows[..., c].astype(dt).tobytes()
                              for c in range(z))
    coded = [[_sgi_rle(rows[y, :, c], bpc) for y in range(h)]
             for c in range(z)]
    pos = 512 + 8 * h * z
    starts, lengths, body = [], [], b""
    for c in range(z):
        for y in range(h):
            starts.append(pos + len(body))
            lengths.append(len(coded[c][y]))
            body += coded[c][y]
    return (hdr + struct.pack(f">{h * z}I", *starts)
            + struct.pack(f">{h * z}I", *lengths) + body)


def _sun_rle(data: bytes) -> bytes:
    out = bytearray()
    i = 0
    while i < len(data):
        j = i + 1
        while j < len(data) and j - i < 256 and data[j] == data[i]:
            j += 1
        n = j - i
        if n > 2 or data[i] == 0x80:
            out += bytes([0x80, n - 1, data[i]]) if n > 1 or data[i] != 0x80 \
                else b"\x80\x00"
        else:
            out += data[i:j]
        i = j
    return bytes(out)


def sun(rows: np.ndarray, depth: int, w: int, *, ftype: int = 1,
        palette: np.ndarray | None = None) -> bytes:
    """A Sun raster of ``rows`` (h, bytes a row, each padded to 16 bits
    already, or unpadded for type 2), ``palette`` (n, 3) written as its
    red, green and blue planes; type 2 run-length codes the rows."""
    h = rows.shape[0]
    pal = b"" if palette is None else palette.T.astype(np.uint8).tobytes()
    body = rows.astype(np.uint8).tobytes()
    if ftype == 2:
        body = _sun_rle(body)
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(body), ftype,
                       1 if palette is not None else 0, len(pal)) + pal + body


def imt(gray: np.ndarray, comment: bool = True) -> bytes:
    """An IM Tools (NIH Image) file: ``key value`` lines, a form feed,
    then 8-bit rows."""
    h, w = gray.shape
    head = (b"* written for the port's tests\n" if comment else b"") + \
        b"width %d\nheight %d\npixel n8\n" % (w, h)
    return head + b"\x0c" + gray.astype(np.uint8).tobytes()


def _iptc_field(rec: int, tag: int, data: bytes) -> bytes:
    if len(data) < 0x8000:
        return bytes([0x1C, rec, tag]) + struct.pack(">H", len(data)) + data
    return bytes([0x1C, rec, tag, 0x84]) + struct.pack(">I", len(data)) + data


def iptc(payload: bytes, w: int, h: int, *, layers: int = 1,
         component: int = 0, band: int | None = None,
         compression: int = 1, chunk: int = 8000) -> bytes:
    """An IPTC/NAA stream: the record-3 image fields (size, layers,
    compression: 1 raw rows, 5 JPEG) and ``payload`` in (8, 10) fields
    of ``chunk`` bytes."""
    out = _iptc_field(2, 0, b"\x00\x04")
    out += _iptc_field(3, 20, struct.pack(">I", w))
    out += _iptc_field(3, 30, struct.pack(">I", h))
    out += _iptc_field(3, 60, bytes([layers, component]))
    if band is not None:
        out += _iptc_field(3, 65, bytes([band]))
    out += _iptc_field(3, 120, bytes([compression]))
    for i in range(0, len(payload), chunk):
        out += _iptc_field(8, 10, payload[i:i + chunk])
    return out


def pcd(y: np.ndarray, c1: np.ndarray, c2: np.ndarray,
        orientation: int = 0) -> bytes:
    """A Kodak PhotoCD holding only what PIL reads: "PCD_" at 2048, the
    orientation byte, and the 768 x 512 base image at 96 x 2048 as chunks
    of two luma rows (``y`` (512, 768)) and one row each of the
    half-width chroma (``c1``, ``c2`` (256, 384))."""
    head = bytearray(96 * 2048)
    head[2048:2052] = b"PCD_"
    head[2048 + 1538] = orientation
    body = np.concatenate([y.reshape(256, 2 * 768), c1, c2], axis=1)
    return bytes(head) + body.astype(np.uint8).tobytes()


def spider(values: np.ndarray, little: bool = False) -> bytes:
    """A SPIDER 2-D image (iform 1) of float32 ``values``: a header of whole
    records of the row length, at least 1024 bytes, as PIL writes it."""
    h, w = values.shape
    lenbyt = 4 * w
    labrec = -(-1024 // lenbyt)
    hdr = np.zeros(labrec * w, np.float32)
    for k, v in {1: 1, 2: h, 5: 1, 12: w, 13: labrec, 22: labrec * lenbyt,
                 23: lenbyt}.items():
        hdr[k - 1] = v
    e = "<f4" if little else ">f4"
    return hdr.astype(e).tobytes() + values.astype(e).tobytes()


def legacy_streams(seed: int = 41) -> dict:
    """file name -> bytes of the committed streams of the formats PIL's
    opener walk reaches past the common ones (each kind once, about 48 x
    40 and under 8 KB; ``tools/export_port_assets.py --what jpeg`` writes
    them, the port's tests and ``tools/format_differential.py`` read
    them). PhotoCD is not among them (its base image alone is 768 KB):
    ``chip_smoke.pcd_stream`` builds one."""
    from tools.make_fake_food101 import make_image

    rng = np.random.default_rng(seed)
    photo = make_image(rng, 40, 48)
    small = make_image(rng, 24, 32)
    rgba = np.concatenate([photo, photo[..., 1:2] ^ 0x5A], 2)
    gray = photo[..., 1]
    out = {
        # the uncompressed true-colour TGA PIL writes starts 00 00 02 00,
        # CUR's signature: CUR's opener fails and TGA's takes it
        "tga_rgb.tga": pil_save(photo, "TGA"),
        "tga_rgba.tga": pil_save(rgba, "TGA"),
        "tga_rle_rgb.tga": pil_save(photo, "TGA", rle=True),
        "tga_gray.tga": pil_save(photo, "TGA", "L"),
        "tga_palette.tga": pil_save(photo, "TGA", "P"),
        "tga_rle_palette.tga": pil_save(photo, "TGA", "P", rle=True),
        "tga_la.tga": pil_save(small, "TGA", "LA", id_section=b"an id"),
        "dib_rgb.dib": pil_save(photo, "DIB"),
        "dib_palette.dib": pil_save(photo, "DIB", "P"),
        "pcx_rgb.pcx": pil_save(photo, "PCX"),
        "pcx_palette.pcx": pil_save(photo, "PCX", "P"),
        "pcx_gray.pcx": pil_save(photo, "PCX", "L"),
        "pcx_1bit.pcx": pil_save(photo, "PCX", "1"),
        "sgi_rgb.sgi": pil_save(photo, "SGI"),
        "sgi_gray.sgi": pil_save(photo, "SGI", "L"),
        "sgi_rgba16.sgi": pil_save(np.concatenate(
            [small, small[..., :1]], 2), "SGI", bpc=2),
        "im_rgb.im": pil_save(photo, "IM"),
        "im_palette.im": pil_save(photo, "IM", "P"),
        "spider.spider": pil_save(small, "SPIDER", "F"),
    }
    # the layouts PIL does not write
    bgr = photo[..., ::-1]
    rgb555 = ((photo[..., 0].astype(np.uint16) >> 3) << 10
              | (photo[..., 1].astype(np.uint16) >> 3) << 5
              | photo[..., 2] >> 3 | 0x8000)
    out["tga_16.tga"] = tga(rgb555.astype("<u2").view(np.uint8).reshape(
        40, 48, 2), 2, 16, flags=0x00)
    out["tga_rle_crossing.tga"] = tga(small[..., ::-1], 10, 24, rle=True,
                                      runs_cross=False, flags=0x10)
    lit = small[..., ::-1].copy()
    lit[::2, ::3] ^= 1  # no runs: literals of 128 pixels cross the rows
    out["tga_rle_literals.tga"] = tga(lit, 10, 24, rle=True,
                                      runs_cross=True, flags=0x30)
    idx = (gray // 17).astype(np.uint8)
    pal16 = rng.integers(0, 1 << 15, 16).astype("<u2").tobytes()
    out["tga_map16_start.tga"] = tga(idx + 4, 1, 8, cmap=pal16,
                                     cmap_start=4, cmap_depth=16)
    four = (gray // 16).astype(np.uint8)
    ega = rng.integers(0, 256, 48).astype(np.uint8).tobytes()
    out["pcx_4plane.pcx"] = pcx([(four >> k) & 1 for k in range(4)], 1,
                                palette16=ega)
    out["pcx_2plane.pcx"] = pcx([(four >> k) & 1 for k in range(2)], 1,
                                version=2, palette16=ega)
    out["dcx.dcx"] = dcx([pil_save(small, "PCX"), pil_save(small[::-1],
                                                            "PCX")])
    out["sgi_rle_rgb.sgi"] = sgi(photo, 1, rle=True)
    out["sgi_rle_gray16.sgi"] = sgi(gray.astype(np.uint16) * 257 + 3, 2,
                                    rle=True, dimension=2)
    out["sun_rgb.ras"] = sun(bgr.reshape(40, -1), 24, 48)
    out["sun_rgb_type3.ras"] = sun(photo.reshape(40, -1), 24, 48, ftype=3)
    out["sun_rle_palette.ras"] = sun(idx, 8, 48, ftype=2,
                                     palette=rng.integers(0, 256, (16, 3)))
    bits = np.packbits(gray > 120, axis=1)
    out["sun_1bit.ras"] = sun(np.pad(bits, ((0, 0), (0, len(bits[0]) % 2))),
                              1, 48)
    out["sun_32.ras"] = sun(np.concatenate(
        [small[..., ::-1], small[..., :1]], 2).reshape(24, -1), 32, 32)
    out["imt.imt"] = imt(gray)
    out["iptc_raw.iptc"] = iptc(gray.tobytes(), 48, 40)
    out["iptc_jpeg_band.iptc"] = iptc(
        pil_save(small, "JPEG", "L", quality=85), 32, 24, layers=3,
        component=1, band=2, compression=5)
    f = small[..., 0].astype(np.float32) * 1.3 - 40
    f[0, :3] = (np.nan, np.inf, -np.inf)
    out["spider_le.spider"] = spider(f, little=True)
    return out


def psd(planes: list, psd_mode: int, *, bits: int = 8,
        compression: int = 1, color_data: bytes = b"",
        resources: tuple = (), layers: bytes = b"", version: int = 1,
        channels: int | None = None, size: tuple | None = None,
        rows: list | None = None) -> bytes:
    """A Photoshop file (PIL has no PSD writer): the header, the colour
    mode data, the image resources ((id, name, data) each, names and data
    padded to even lengths), the layer and mask section ``layers`` (the
    bytes after its length) and the merged image of ``planes`` (each
    (h, bytes a row) uint8) raw or PackBits: the row byte-count table,
    then each row's stream (``rows`` replaces those streams, one list a
    plane, for layouts Photoshop does not write)."""
    h, row = planes[0].shape
    w = row * 8 if bits == 1 else row
    w, h = size or (w, h)
    out = bytearray(b"8BPS" + struct.pack(">H", version) + bytes(6))
    out += struct.pack(">HIIHH", channels or len(planes), h, w, bits,
                       psd_mode)
    out += struct.pack(">I", len(color_data)) + color_data
    res = bytearray()
    for rid, name, payload in resources:
        pname = bytes([len(name)]) + name
        if len(pname) & 1:
            pname += b"\0"
        res += b"8BIM" + struct.pack(">H", rid) + pname
        res += struct.pack(">I", len(payload)) + payload
        if len(payload) & 1:
            res += b"\0"
    out += struct.pack(">I", len(res)) + res
    out += struct.pack(">I", len(layers)) + layers
    out += struct.pack(">H", compression)
    if compression == 0:
        for p in planes:
            out += p.tobytes()
        return bytes(out)
    streams = rows or [[packbits(bytes(r)) for r in p] for p in planes]
    for s in streams:
        out += b"".join(struct.pack(">H", len(r)) for r in s)
    for s in streams:
        out += b"".join(s)
    return bytes(out)


# ---------------------------------------------------------------------------
# JPEG 2000: the wheel's OpenJPEG encoder, and JP2 boxes by hand
# ---------------------------------------------------------------------------

# byte offsets in OpenJPEG 2.5's opj_cparameters_t (openjpeg.h), checked
# against opj_set_default_encoder_parameters' defaults before each use
_OPJ = {"tile_size_on": 0, "cp_tx0": 4, "cp_ty0": 8, "cp_tdx": 12,
        "cp_tdy": 16, "cp_disto_alloc": 20, "csty": 48, "prog_order": 52,
        "POC": 56, "numpocs": 4792, "tcp_numlayers": 4796,
        "tcp_rates": 4800, "numresolution": 5600, "cblockw_init": 5604,
        "cblockh_init": 5608, "mode": 5612, "irreversible": 5616,
        "roi_compno": 5620, "roi_shift": 5624, "res_spec": 5628,
        "prcw_init": 5632, "prch_init": 5764, "image_offset_x0": 18188,
        "image_offset_y0": 18192, "subsampling_dx": 18196,
        "subsampling_dy": 18200, "decod_format": 18204, "cod_format": 18208,
        "tp_on": 18696, "tp_flag": 18697, "tcp_mct": 18698}
_POC_SIZE = 148  # opj_poc_t


def libopenjp2():
    """The libopenjp2 (2.5.4) that PIL's wheel ships, through ctypes, for
    the streams PIL's own writer cannot make: ``encode(planes, **kw)`` ->
    a J2K codestream (or a JP2 with ``jp2=True``). ``planes``: one (h, w)
    int array a component (a subsampled one smaller, with ``dx``/``dy``);
    keywords: ``prec``, ``sgnd``, ``dx``, ``dy`` (lists a component),
    ``irreversible``, ``mct``, ``layers`` (rates), ``resolutions`` (6, or
    fewer where a side is short),
    ``cblk`` (w, h), ``mode`` (code-block style bits), ``csty`` (1
    precincts, 2 SOP, 4 EPH), ``precincts`` [(w, h)...], ``order`` (0-4),
    ``pocs`` [(resno0, compno0, layno1, resno1, compno1, order)...],
    ``tiles`` (w, h), ``tile_offset``, ``offset`` (image), ``tp_flag``
    (b"R", b"L" or b"C": tile-parts), ``roi`` (component, shift),
    ``options`` (opj_encoder_set_extra_options, e.g. ["TLM=YES"]),
    ``colour`` (OpenJPEG's OPJ_CLRSPC_*). For tools and tests only: the
    port decodes without it."""
    import glob
    import os
    import tempfile
    import types

    import PIL
    libs = os.path.join(os.path.dirname(PIL.__file__), os.pardir,
                        "pillow.libs")
    found = glob.glob(os.path.join(libs, "libopenjp2-*.so*"))
    if not found:
        raise OSError(f"no libopenjp2 under {libs}")
    lib = ctypes.CDLL(found[0])
    vp, u32 = ctypes.c_void_p, ctypes.c_uint32
    lib.opj_image_create.restype = vp
    lib.opj_image_create.argtypes = [u32, vp, ctypes.c_int]
    lib.opj_create_compress.restype = vp
    lib.opj_setup_encoder.argtypes = [vp, vp, vp]
    lib.opj_stream_create_default_file_stream.restype = vp
    lib.opj_stream_create_default_file_stream.argtypes = [ctypes.c_char_p,
                                                         ctypes.c_int]
    lib.opj_start_compress.argtypes = [vp, vp, vp]
    lib.opj_encode.argtypes = [vp, vp]
    lib.opj_end_compress.argtypes = [vp, vp]
    lib.opj_stream_destroy.argtypes = [vp]
    lib.opj_destroy_codec.argtypes = [vp]
    lib.opj_image_destroy.argtypes = [vp]
    lib.opj_encoder_set_extra_options.argtypes = [vp, vp]

    def encode(planes, *, prec=None, sgnd=None, dx=None, dy=None,
               irreversible=False, mct=None, layers=(0,), resolutions=None,
               cblk=(64, 64), mode=0, csty=0, precincts=(), order=0,
               pocs=(), tiles=None, tile_offset=(0, 0), offset=(0, 0),
               tp_flag=None, roi=None, options=(), colour=1, jp2=False):
        nc = len(planes)
        prec = prec or [8] * nc
        sgnd = sgnd or [0] * nc
        dx, dy = dx or [1] * nc, dy or [1] * nc
        h0, w0 = planes[0].shape
        if resolutions is None:  # 6, or as many as the smallest side takes
            resolutions = min(6, min(h0, w0).bit_length())
        parm = (u32 * (9 * nc))()
        for i, p in enumerate(planes):
            ph, pw = p.shape
            parm[9 * i:9 * i + 9] = [dx[i], dy[i], pw, ph, offset[0],
                                     offset[1], prec[i], prec[i], sgnd[i]]
        img = lib.opj_image_create(nc, ctypes.addressof(parm), colour)
        head = (u32 * 6).from_address(img)
        head[0], head[1] = offset
        head[2], head[3] = offset[0] + w0 * dx[0], offset[1] + h0 * dy[0]
        comps = ctypes.c_void_p.from_address(img + 24).value
        keep = []
        for i, p in enumerate(planes):
            arr = np.ascontiguousarray(p, np.int32)
            keep.append(arr)
            dst = ctypes.c_void_p.from_address(comps + 64 * i + 48).value
            ctypes.memmove(dst, arr.ctypes.data, arr.nbytes)
        params = (ctypes.c_uint8 * 20000)()
        lib.opj_set_default_encoder_parameters(params)
        base = ctypes.addressof(params)

        def i32(name, v=None, at=0):
            c = ctypes.c_int32.from_address(base + _OPJ[name] + 4 * at)
            if v is not None:
                c.value = v
            return c.value
        if (i32("numresolution"), i32("cblockw_init"), i32("roi_compno"),
                i32("subsampling_dx"), i32("cod_format")) != (6, 64, -1, 1,
                                                              -1):
            raise OSError("opj_cparameters_t does not have 2.5's layout")
        i32("tcp_numlayers", len(layers))
        for k, r in enumerate(layers):
            ctypes.c_float.from_address(base + _OPJ["tcp_rates"]
                                        + 4 * k).value = r
        i32("cp_disto_alloc", 1)
        i32("numresolution", resolutions)
        i32("cblockw_init", cblk[0])
        i32("cblockh_init", cblk[1])
        i32("mode", mode)
        i32("irreversible", int(irreversible))
        i32("prog_order", order)
        if precincts:
            csty |= 1
            i32("res_spec", len(precincts))
            for k, (pw, ph) in enumerate(precincts):
                i32("prcw_init", pw, k)
                i32("prch_init", ph, k)
        i32("csty", csty)
        if tiles:
            i32("tile_size_on", 1)
            i32("cp_tdx", tiles[0])
            i32("cp_tdy", tiles[1])
            i32("cp_tx0", tile_offset[0])
            i32("cp_ty0", tile_offset[1])
        i32("image_offset_x0", offset[0])
        i32("image_offset_y0", offset[1])
        if roi is not None:
            i32("roi_compno", roi[0])
            i32("roi_shift", roi[1])
        for k, poc in enumerate(pocs):
            at = base + _OPJ["POC"] + _POC_SIZE * k
            vals = (u32 * 37).from_address(at)
            vals[0], vals[1], vals[2], vals[3], vals[4] = poc[:5]
            vals[8] = poc[5]  # prg1
            vals[12] = 1  # tile (from 1)
        i32("numpocs", len(pocs))
        if tp_flag:
            ctypes.c_char.from_address(base + _OPJ["tp_on"]).value = b"\x01"
            ctypes.c_char.from_address(base + _OPJ["tp_flag"]).value = \
                tp_flag
        if mct is None:
            mct = int(nc >= 3 and dx[:3] == [1] * 3 and dy[:3] == [1] * 3)
        ctypes.c_char.from_address(base + _OPJ["tcp_mct"]).value = bytes(
            [mct])
        codec = lib.opj_create_compress(2 if jp2 else 0)
        path = tempfile.mktemp(suffix=".jp2")
        try:
            if not lib.opj_setup_encoder(codec, base, img):
                raise OSError("opj_setup_encoder failed")
            if options:
                opts = (ctypes.c_char_p * (len(options) + 1))(
                    *[o.encode() for o in options], None)
                if not lib.opj_encoder_set_extra_options(codec, opts):
                    raise OSError("opj_encoder_set_extra_options failed")
            stream = lib.opj_stream_create_default_file_stream(
                path.encode(), 0)
            ok = (lib.opj_start_compress(codec, img, stream)
                  and lib.opj_encode(codec, stream)
                  and lib.opj_end_compress(codec, stream))
            lib.opj_stream_destroy(stream)
            if not ok:
                raise OSError("OpenJPEG could not encode these settings")
            with open(path, "rb") as f:
                return f.read()
        finally:
            lib.opj_destroy_codec(codec)
            lib.opj_image_destroy(img)
            if os.path.exists(path):
                os.remove(path)
    return types.SimpleNamespace(encode=encode)


def jp2_box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + kind + payload


def jp2_file(codestream: bytes, *, w: int, h: int, nc: int, bpc: int = 7,
             colr: bytes | None = None, extra_header: bytes = b"") -> bytes:
    """A JP2 around ``codestream``: the signature, ``ftyp``, a ``jp2h`` of
    ``ihdr``, the ``colr`` payload given (none if None) and
    ``extra_header`` boxes (``pclr``, ``cmap``...), then ``jp2c``."""
    ihdr = jp2_box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, bpc, 7, 0, 0))
    head = ihdr + (jp2_box(b"colr", colr) if colr is not None else b"") \
        + extra_header
    return (jp2_box(b"jP  ", b"\r\n\x87\n")
            + jp2_box(b"ftyp", b"jp2 " + bytes(4) + b"jp2 ")
            + jp2_box(b"jp2h", head) + jp2_box(b"jp2c", codestream))


def _psd_layer_section(rng) -> bytes:
    """A layer and mask section PIL skips for frame 0: one RGB layer
    record with its channel data, and a global mask info block."""
    h, w = 4, 6
    rec = struct.pack(">iiiiH", 0, 0, h, w, 3)
    chans = b""
    for cid in (0, 1, 2):
        data = struct.pack(">H", 0) + rng.integers(0, 256, h * w).astype(
            np.uint8).tobytes()
        rec += struct.pack(">hI", cid, len(data))
        chans += data
    name = b"\x05layer\x00\x00"  # Pascal string padded to 4
    extra = struct.pack(">I", 0) + struct.pack(">I", 0) + name
    rec += b"8BIMnorm" + bytes([255, 0, 0, 0]) + struct.pack(
        ">I", len(extra)) + extra
    info = struct.pack(">h", 1) + rec + chans
    if len(info) & 1:
        info += b"\0"
    return struct.pack(">I", len(info)) + info + struct.pack(">I", 0)


def psd_streams(seed: int = 43) -> dict:
    """file name -> bytes of the committed PSD streams (PIL has no PSD
    writer): each colour mode PIL reads, raw and PackBits, resources, a
    layer section, streams whose PackBits runs cross rows, and the 16-bit
    and PSB files PIL refuses; about 32 x 24 each."""
    from tools.make_fake_food101 import make_image

    rng = np.random.default_rng(seed)
    photo = make_image(rng, 24, 32)
    planes = [photo[..., i] for i in range(3)]
    alpha = photo[..., 1] ^ 0x5A
    gray = photo[..., 1]
    out = {
        "psd_rgb.psd": psd(planes, 3),
        "psd_rgb_raw.psd": psd(planes, 3, compression=0),
        "psd_rgba.psd": psd(planes + [alpha], 3),
        "psd_gray.psd": psd([gray], 1),
        "psd_bitmap.psd": psd([np.packbits(gray > 120, axis=1)], 0, bits=1,
                              size=(32, 24)),
        "psd_indexed.psd": psd([gray // 16], 2, color_data=rng.integers(
            0, 256, 768).astype(np.uint8).tobytes()),
        "psd_cmyk.psd": psd([255 - p for p in planes] + [alpha // 4], 4),
        "psd_cmyk_alpha.psd": psd([255 - p for p in planes]
                                  + [alpha // 4, gray], 4, compression=0),
        "psd_lab.psd": psd([gray, planes[0], planes[2]], 9),
        "psd_multichannel.psd": psd(planes, 7),
        "psd_duotone.psd": psd([gray], 8, color_data=bytes(range(40))),
        "psd_resources.psd": psd(planes, 3, resources=(
            (1039, b"", b"an ICC profile's bytes"), (1005, b"res", b"odd"),
            (1033, b"thumb", bytes(7)))),
        "psd_layers.psd": psd(planes, 3, layers=_psd_layer_section(rng)),
        "psd_16bit.psd": psd([(p[:6, :8].astype(">u2") * 257).view(
            np.uint8) for p in planes], 3, bits=16, size=(8, 6)),
        "psd_psb.psd": psd([p[:6, :8] for p in planes], 3, version=2),
    }
    # one PackBits stream a channel, runs crossing rows (PackDecode.c cuts
    # each at its row's end, so each tile reads on into the next channel's
    # and the last one into literal packets after it): row counts odd,
    # the table Photoshop would not write
    whole = [packbits(p.tobytes()) for p in planes]
    out["psd_packbits_cross.psd"] = psd(planes, 3, rows=[
        [s[:len(s) // 24 * 23]] + [s[len(s) // 24 * 23:]] + [b""] * 22
        for s in whole]) + (b"\x1f" + bytes(range(32))) * 72
    return out


def jpeg2000_streams(seed: int = 47) -> dict:
    """file name -> bytes of the committed JPEG 2000 streams, about 48 x
    40 each and most of them lossy to stay small: PIL's writer (5/3 and
    9/7, RCT/ICT on and off, resolutions 1-7, quality layers, all five
    progression orders, tiles, tile and image offsets, precincts,
    code-block sizes, PLT, L, LA, RGBA, I;16, signed, raw codestream and
    JP2; two 800 x 608 photos at 1:120, 9/7 and 5/3), ``libopenjp2()`` (the six code-block styles, SOP/EPH, POC,
    tile-parts with TLM, ROI, subsampled sYCC, 12-bit), and JP2 boxes by
    hand (``colr`` 12 for CMYK, ``pclr`` palettes with and without
    ``cmap``)."""
    from tools.make_fake_food101 import make_image

    rng = np.random.default_rng(seed)
    photo = make_image(rng, 40, 48)
    big = make_image(rng, 72, 72)
    pil = Image.fromarray(photo)

    def save(img, rates=(6,), **kw):
        b = io.BytesIO()
        img.save(b, "JPEG2000", quality_mode="rates",
                 quality_layers=list(rates), **kw)
        return b.getvalue()
    j = {"no_jp2": True}
    out = {
        "j2k_53.j2k": save(pil, **j),
        "j2k_97.j2k": save(pil, irreversible=True, **j),
        "jp2_53.jp2": save(pil),
        "jp2_97.jp2": save(pil, irreversible=True),
        "j2k_53_lossless.j2k": save(pil.crop((0, 0, 24, 20)), (0,), **j),
        "j2k_97_no_ict.j2k": save(pil, irreversible=True, mct=0, **j),
        "j2k_53_no_rct.j2k": save(pil, mct=0, **j),
        "j2k_res1.j2k": save(pil, num_resolutions=1, **j),
        "j2k_res7.j2k": save(Image.fromarray(big), num_resolutions=7,
                             irreversible=True, **j),
        "j2k_layers.j2k": save(pil, (40, 12, 4), **j),
        "j2k_rlcp.j2k": save(pil, (20, 5), progression="RLCP", **j),
        "j2k_rpcl.j2k": save(pil, num_resolutions=3, precinct_size=(16, 16),
                             progression="RPCL", **j),
        "j2k_pcrl.j2k": save(pil, num_resolutions=3, precinct_size=(16, 16),
                             progression="PCRL", irreversible=True, **j),
        "j2k_cprl.j2k": save(pil, num_resolutions=3, precinct_size=(32, 16),
                             progression="CPRL", **j),
        "j2k_tiles.j2k": save(pil, tile_size=(16, 16), **j),
        "j2k_tile_offsets.j2k": save(pil, tile_size=(20, 16),
                                     tile_offset=(3, 5), offset=(7, 9),
                                     irreversible=True, **j),
        "j2k_cblk.j2k": save(pil, codeblock_size=(4, 16), **j),
        "j2k_plt.j2k": save(pil, plt=True, **j),
        "jp2_l.jp2": save(pil.convert("L")),
        "jp2_la.jp2": save(pil.convert("LA"), irreversible=True),
        "jp2_rgba.jp2": save(pil.convert("RGBA")),
        "jp2_i16.jp2": save(Image.fromarray(photo[..., 1].astype(np.uint16)
                                            * 3), (4,)),
        "j2k_signed.j2k": save(pil, signed=True, **j),
    }
    opj = libopenjp2()
    planes = [photo[..., i].astype(np.int32) for i in range(3)]
    for bit, style in ((1, "bypass"), (2, "reset"), (4, "termall"),
                       (8, "vsc"), (16, "pterm"), (32, "segsym")):
        out[f"j2k_style_{style}.j2k"] = opj.encode(planes, mode=bit,
                                                   layers=(16, 5))
    out["j2k_style_all_97.j2k"] = opj.encode(planes, mode=63,
                                             irreversible=True,
                                             layers=(5,))
    out["j2k_sop_eph.j2k"] = opj.encode(planes, csty=6, layers=(20, 6))
    out["j2k_poc.j2k"] = opj.encode(planes, layers=(20, 6), pocs=[
        (0, 0, 2, 3, 3, 1), (3, 0, 2, 6, 3, 4)])
    out["j2k_tileparts_tlm.j2k"] = opj.encode(
        planes, tiles=(32, 32), tp_flag=b"R", options=["TLM=YES"],
        layers=(8,))
    out["j2k_roi.j2k"] = opj.encode(planes, roi=(0, 6), layers=(6,),
                                    irreversible=True)
    y = planes[0]
    out["j2k_sycc420.j2k"] = opj.encode(
        [y, planes[1][::2, ::2], planes[2][::2, ::2]], dx=[1, 2, 2],
        dy=[1, 2, 2], mct=0, layers=(6,))
    out["jp2_sycc422.jp2"] = opj.encode(
        [y, planes[1][:, ::2], planes[2][:, ::2]], dx=[1, 2, 2],
        dy=[1, 1, 1], mct=0, jp2=True, colour=3, irreversible=True,
        layers=(6,))
    out["j2k_12bit.j2k"] = opj.encode([p * 16 + 7 for p in planes],
                                      prec=[12] * 3, layers=(8,))
    srgb = b"\x01\x00\x00" + struct.pack(">I", 16)
    cmyk = opj.encode([255 - p for p in planes] + [planes[1] // 3], mct=0,
                      layers=(8,))
    out["jp2_cmyk.jp2"] = jp2_file(cmyk, w=48, h=40, nc=4, colr=(
        b"\x01\x00\x00" + struct.pack(">I", 12)))
    idx = (photo[..., 1] // 32).astype(np.int32)
    pal = rng.integers(0, 256, (8, 3)).astype(np.uint8)
    pal[5] = pal[2]  # a repeated entry: PIL's palette keeps one of them

    def pclr(entries, depths):
        return jp2_box(b"pclr", struct.pack(">HB", len(entries),
                                            len(depths)) + bytes(depths)
                       + b"".join(bytes(e) for e in entries))
    cmap = jp2_box(b"cmap", b"".join(struct.pack(">HBB", 0, 1, k)
                                     for k in range(3)))
    ics = opj.encode([idx], prec=[3], resolutions=4)
    out["jp2_pclr.jp2"] = jp2_file(ics, w=48, h=40, nc=1, bpc=2, colr=srgb,
                                   extra_header=pclr(pal, (7, 7, 7)) + cmap)
    rgba_pal = np.concatenate([pal, np.full((8, 1), 255, np.uint8)], 1)
    out["jp2_pclr_rgba_nocmap.jp2"] = jp2_file(
        ics, w=48, h=40, nc=1, bpc=2, colr=srgb,
        extra_header=pclr(rgba_pal, (7, 7, 7, 7)))
    # the decode-time uploads: a photo's size, 9/7 and 5/3 at 1:120
    full = Image.fromarray(make_image(rng, 608, 800))
    out["j2k_800x608_97.j2k"] = save(full, (120,), irreversible=True, **j)
    out["j2k_800x608_53.j2k"] = save(full, (120,), **j)
    return out
