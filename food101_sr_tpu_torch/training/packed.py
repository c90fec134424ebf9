"""The packed weights file (``.f101w``): the port's committed winners,
stored losslessly in less room than a ``.pth`` (counterpart of the JAX
package's compressed Orbax store for its own winners).

    pack_state_dict(sd, "winner_x.f101w")                       # float32
    pack_state_dict(sd, "winner_x_gan.f101w", base="winner_x.f101w",
                    dtype="bfloat16")                           # a delta
    sd = unpack_state_dict("winner_x_gan.f101w")

Layout, all integers little-endian:

* ``MAGIC`` (8 bytes), then the index's length (4 bytes) and the index,
  UTF-8 JSON: ``{"format": 1, "tensors": [{"key", "shape", "dtype",
  "stored", "offset", "size"}, ...], "sha256": <hex>, "base": null or
  {"file": <name>, "sha256": <hex>}}``;
* each tensor's stream in the index's order: its stored bytes split into
  byte planes (every element's first byte, then every second byte, ...)
  and compressed by the stdlib's ``lzma`` (xz, CRC64 check, preset 9 |
  ``PRESET_EXTREME``) on its own. ``offset`` (from the first stream) and
  ``size`` place the stream. The plane of a float's exponent byte
  compresses far better than its mantissa's, which interleaving hides;
* the sha256 of every byte before it (32 bytes), so a flipped or missing
  byte anywhere fails the read.

``stored`` is ``float32`` (the bits as they are), ``bfloat16`` (the
float32 rounded to nearest even, widened back exactly on unpack) or, for
integer tensors, their own dtype (a BatchNorm's 0-d
``num_batches_tracked`` stays 0-d). A pack with a ``base`` stores each
float tensor as the XOR of its bfloat16 bits with the bfloat16 bits of the
same key in the base's decoded tensors: a fine-tune of the base differs
from it in few bits. The base is named by file, resolved in the pack's own
directory, and held to the sha256 of its decoded bytes. The index's
``sha256`` is that digest of the pack's own decoded tensors: each one's
unpacked bytes (float32 for floats) in the index's order.

Nothing falls back: an unknown magic, a cut or altered file, a missing
base or a base with another digest raises :class:`PackError` naming the
reason. ``training.checkpoint.load_checkpoint`` reads these files by their
magic.
"""
from __future__ import annotations

import hashlib
import json
import lzma
import os
import struct
from collections.abc import Mapping

import numpy as np
import torch

MAGIC = b"F101W\x00\x01\n"
_PRESET = 9 | lzma.PRESET_EXTREME
_DIGEST = 32
_MAX_BASE_DEPTH = 8


class PackError(ValueError):
    """A packed weights file that cannot be decoded as written."""


def is_packed(path: str) -> bool:
    """Whether the file at ``path`` starts with the pack's magic."""
    with open(path, "rb") as f:
        return f.read(len(MAGIC)) == MAGIC


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """The bfloat16 bits (uint16) of float32 ``x`` rounded to nearest even,
    as ``torch``'s and XLA's conversions round. NaNs stay NaNs."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    r = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)
    nan = np.isnan(np.asarray(x))
    if nan.any():
        r[nan] = (u[nan] >> 16).astype(np.uint16) | 0x40
    return r


def widen_bf16(bits: np.ndarray) -> np.ndarray:
    """float32 values of bfloat16 ``bits``, exactly."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _planes(a: np.ndarray) -> bytes:
    b = np.ascontiguousarray(a).view(np.uint8).reshape(-1, a.dtype.itemsize)
    return b.T.tobytes()


def _unplanes(raw: bytes, dtype: np.dtype, n: int) -> np.ndarray:
    b = np.frombuffer(raw, np.uint8).reshape(dtype.itemsize, n)
    return np.ascontiguousarray(b.T).view(dtype).reshape(n)


def _digest(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _numpy(v) -> np.ndarray:
    a = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
    a = np.asarray(a)
    return a.astype(a.dtype.newbyteorder("<"), copy=False)


def pack_state_dict(sd: Mapping, path: str, *, base: str | None = None,
                    dtype: str = "float32") -> str:
    """Write ``sd`` (name -> tensor or array; floats must be float32) as a
    packed weights file at ``path``; returns the absolute path. ``dtype``
    is the stored precision of float tensors, ``float32`` (lossless) or
    ``bfloat16`` (rounded to nearest even). ``base`` is a pack in the same
    directory as ``path`` against which every float tensor is stored as an
    XOR of bfloat16 bits (``dtype`` must then be ``bfloat16``, and the
    base must hold every float key of ``sd`` at its shape)."""
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"stored dtype {dtype!r}: float32 or bfloat16")
    path = os.path.abspath(path)
    ref, base_entry = None, None
    if base is not None:
        if dtype != "bfloat16":
            raise ValueError("a pack against a base stores bfloat16")
        base = os.path.abspath(base)
        if os.path.dirname(base) != os.path.dirname(path):
            raise ValueError(f"the base {base} must sit in the pack's own "
                             f"directory {os.path.dirname(path)}")
        ref = unpack_state_dict(base)
        base_entry = {"file": os.path.basename(base),
                      "sha256": _digest(_numpy(v) for v in ref.values())}
    entries, streams, decoded = [], [], []
    offset = 0
    for key, v in sd.items():
        a = _numpy(v)
        shape = list(a.shape)
        if a.dtype.kind == "f":
            if a.dtype != np.float32:
                raise ValueError(f"{key}: {a.dtype}; floats are packed "
                                 "from float32")
            if dtype == "float32":
                stored, payload = "float32", a
                decoded.append(a)
            else:
                stored, payload = "bfloat16", bf16_bits(a)
                decoded.append(widen_bf16(payload))
                if ref is not None:
                    if key not in ref or list(ref[key].shape) != shape:
                        raise ValueError(f"{key}: not in the base at shape "
                                         f"{shape}")
                    payload = payload ^ bf16_bits(_numpy(ref[key]))
        elif a.dtype.kind in "iub":
            stored, payload = a.dtype.name, a
            decoded.append(a)
        else:
            raise ValueError(f"{key}: dtype {a.dtype} cannot be packed")
        stream = lzma.compress(_planes(payload.reshape(-1)),
                               format=lzma.FORMAT_XZ,
                               check=lzma.CHECK_CRC64, preset=_PRESET)
        entries.append({"key": key, "shape": shape, "dtype": a.dtype.name,
                        "stored": stored, "offset": offset,
                        "size": len(stream)})
        streams.append(stream)
        offset += len(stream)
    index = json.dumps({"format": 1, "tensors": entries,
                        "sha256": _digest(decoded), "base": base_entry},
                       separators=(",", ":")).encode()
    body = MAGIC + struct.pack("<I", len(index)) + index + b"".join(streams)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(body + hashlib.sha256(body).digest())
    os.replace(tmp, path)
    return path


def read_index(path: str) -> dict:
    """The index of the pack at ``path``, after checking its magic, its
    length and its trailing digest."""
    with open(path, "rb") as f:
        data = f.read()
    return _index(data, path)


def _index(data: bytes, path: str) -> dict:
    if data[:len(MAGIC)] != MAGIC:
        raise PackError(f"{path}: not a packed weights file (unknown magic "
                        f"{data[:len(MAGIC)]!r})")
    at = len(MAGIC) + 4
    if len(data) < at + _DIGEST:
        raise PackError(f"{path}: truncated ({len(data)} bytes)")
    (n,) = struct.unpack_from("<I", data, len(MAGIC))
    try:
        index = json.loads(data[at:at + n].decode())
        at += n
        end = at + sum(e["size"] for e in index["tensors"])
        for e in index["tensors"]:
            e["offset"] += at
    except (UnicodeDecodeError, ValueError, KeyError, TypeError) as e:
        raise PackError(f"{path}: unreadable index ({e})") from None
    if len(data) < end + _DIGEST:
        raise PackError(f"{path}: truncated ({len(data)} of "
                        f"{end + _DIGEST} bytes)")
    if len(data) > end + _DIGEST:
        raise PackError(f"{path}: {len(data) - end - _DIGEST} bytes past "
                        "its end")
    if hashlib.sha256(data[:end]).digest() != data[end:]:
        raise PackError(f"{path}: its bytes do not match their sha256 (the "
                        "file is altered)")
    if index.get("format") != 1:
        raise PackError(f"{path}: format {index.get('format')!r}, not 1")
    return index


def unpack_state_dict(path: str, _depth: int = 0) -> dict[str, torch.Tensor]:
    """The tensors of the pack at ``path``, in its order: floats as
    float32 (bfloat16 widened exactly), integers in their own dtype, each
    at its recorded shape. A base is read from the pack's directory and
    must have the recorded digest. Raises :class:`PackError`."""
    path = os.path.abspath(path)
    with open(path, "rb") as f:
        data = f.read()
    index = _index(data, path)
    ref = None
    if index["base"] is not None:
        if _depth >= _MAX_BASE_DEPTH:
            raise PackError(f"{path}: bases nested past {_MAX_BASE_DEPTH}")
        base = os.path.join(os.path.dirname(path), index["base"]["file"])
        if not os.path.isfile(base):
            raise PackError(f"{path}: its base {base} is missing")
        ref = unpack_state_dict(base, _depth + 1)
        got = _digest(v.numpy() for v in ref.values())
        if got != index["base"]["sha256"]:
            raise PackError(f"{path}: its base {base} decodes to sha256 "
                            f"{got}, not the recorded "
                            f"{index['base']['sha256']}")
    out = {}
    for e in index["tensors"]:
        key, shape, stored = e["key"], tuple(e["shape"]), e["stored"]
        n = int(np.prod(shape, dtype=np.int64))
        sdt = np.dtype("uint16" if stored == "bfloat16" else stored)
        try:
            raw = lzma.decompress(data[e["offset"]:e["offset"] + e["size"]],
                                  format=lzma.FORMAT_XZ)
        except lzma.LZMAError as err:
            raise PackError(f"{path}: {key}: {err}") from None
        if len(raw) != n * sdt.itemsize:
            raise PackError(f"{path}: {key}: {len(raw)} bytes decoded for "
                            f"{n} x {sdt.name}")
        a = _unplanes(raw, sdt, n)
        if stored == "bfloat16":
            if ref is not None:
                if key not in ref or tuple(ref[key].shape) != shape:
                    raise PackError(f"{path}: {key} is not in its base at "
                                    f"shape {list(shape)}")
                a = a ^ bf16_bits(ref[key].numpy()).reshape(-1)
            a = widen_bf16(a)
        elif stored != e["dtype"]:
            raise PackError(f"{path}: {key}: stored {stored} for "
                            f"{e['dtype']}")
        out[key] = torch.from_numpy(a.reshape(shape).copy())
    got = _digest(v.numpy() for v in out.values())
    if got != index["sha256"]:
        raise PackError(f"{path}: decodes to sha256 {got}, not the recorded "
                        f"{index['sha256']}")
    return out
