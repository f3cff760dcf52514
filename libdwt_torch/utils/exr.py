"""Minimal OpenEXR scanline codec (pure Python, no external deps).

The port's own copy of ``libdwt_tpu.utils.exr``.  libdwt's HDR
tone-mapping example wraps the OpenEXR C++ library (its
``examples/hdr/exr.h``); this module implements the subset that pipeline
needs: single-part scanline images, NO_COMPRESSION, FLOAT (f32) or HALF
channels, increasing-y line order, the subset ``writeRgba``/``readRgba``
traffic in.  Host numpy in, host numpy out.

Format reference: the OpenEXR file layout specification (magic 20000630
/ version 2, attribute list, chlist, scanline offset table, per-line
``y, size, channel-planar pixel data`` records, channels ordered
alphabetically).
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

_MAGIC = 20000630
_PT_UINT, _PT_HALF, _PT_FLOAT = 0, 1, 2

__all__ = ["read_exr", "write_exr"]


def _attr(name: str, typ: str, data: bytes) -> bytes:
    return (
        name.encode() + b"\0" + typ.encode() + b"\0"
        + struct.pack("<i", len(data)) + data
    )


def _chlist(names: List[str], pixel_type: int) -> bytes:
    out = b""
    for n in sorted(names):
        out += n.encode() + b"\0"
        out += struct.pack("<iBBBBii", pixel_type, 0, 0, 0, 0, 1, 1)
    return out + b"\0"


def write_exr(path: str, img: np.ndarray, channel_names=None) -> None:
    """Write (H, W) or (H, W, C) float data as an uncompressed
    scanline EXR with FLOAT channels.  Default channel names: 'Y' for
    1 channel, RGB(A) otherwise."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    if channel_names is None:
        channel_names = ["Y"] if c == 1 else list("RGBA"[:c])
    if len(channel_names) != c:
        raise ValueError("channel_names length must match channel count")
    order = sorted(range(c), key=lambda i: channel_names[i])

    header = b""
    header += _attr("channels", "chlist", _chlist(list(channel_names), _PT_FLOAT))
    header += _attr("compression", "compression", struct.pack("<B", 0))
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header += _attr("dataWindow", "box2i", box)
    header += _attr("displayWindow", "box2i", box)
    header += _attr("lineOrder", "lineOrder", struct.pack("<B", 0))
    header += _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
    header += _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\0"

    preamble = struct.pack("<ii", _MAGIC, 2) + header
    table_pos = len(preamble)
    line_bytes = 8 + c * w * 4
    offsets = [table_pos + 8 * h + i * line_bytes for i in range(h)]

    with open(path, "wb") as f:
        f.write(preamble)
        f.write(struct.pack(f"<{h}Q", *offsets))
        for y in range(h):
            f.write(struct.pack("<ii", y, c * w * 4))
            for i in order:
                f.write(np.ascontiguousarray(img[y, :, i]).tobytes())


def _read_null_str(buf: bytes, pos: int) -> Tuple[str, int]:
    end = buf.index(b"\0", pos)
    return buf[pos:end].decode("latin-1"), end + 1


def _parse_chlist(data: bytes) -> List[Tuple[str, int]]:
    chans = []
    pos = 0
    while pos < len(data) and data[pos] != 0:
        name, pos = _read_null_str(data, pos)
        (ptype,) = struct.unpack_from("<i", data, pos)
        pos += 16  # pixel type, pLinear+pad, xSampling, ySampling
        chans.append((name, ptype))
    return chans


def read_exr(path: str) -> Tuple[np.ndarray, List[str]]:
    """Read an uncompressed single-part scanline EXR.  Returns
    ``(img, channel_names)`` with img (H, W, C) float32, channels in
    display order (R, G, B, A first if present, then alphabetical)."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError("not an EXR file")
    # OpenEXR version-field flag bits: 0x200 = single-part tiled,
    # 0x800 = deep data, 0x1000 = multi-part (openexr file layout doc)
    if version & 0x1000:
        raise ValueError("multi-part EXR not supported")
    if version & 0x800:
        raise ValueError("deep-data EXR not supported")
    if version & 0x200:
        raise ValueError("tiled EXR not supported (scanline only)")

    pos = 8
    attrs: Dict[str, Tuple[str, bytes]] = {}
    while buf[pos] != 0:
        name, pos = _read_null_str(buf, pos)
        typ, pos = _read_null_str(buf, pos)
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        attrs[name] = (typ, buf[pos : pos + size])
        pos += size
    pos += 1

    comp = attrs["compression"][1][0]
    if comp != 0:
        raise ValueError(f"unsupported EXR compression {comp} (need 0)")
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    chans = _parse_chlist(attrs["channels"][1])  # alphabetical storage order
    c = len(chans)

    offsets = struct.unpack_from(f"<{h}Q", buf, pos)
    img = np.empty((h, w, c), np.float32)
    for row, off in enumerate(offsets):
        y, size = struct.unpack_from("<ii", buf, off)
        p = off + 8
        for ci, (name, ptype) in enumerate(chans):
            if ptype == _PT_FLOAT:
                line = np.frombuffer(buf, "<f4", w, p)
                p += 4 * w
            elif ptype == _PT_HALF:
                line = np.frombuffer(buf, "<f2", w, p).astype(np.float32)
                p += 2 * w
            else:
                line = np.frombuffer(buf, "<u4", w, p).astype(np.float32)
                p += 4 * w
            img[y - y0, :, ci] = line

    names = [n for n, _ in chans]
    display = [n for n in ("R", "G", "B", "A") if n in names]
    display += [n for n in names if n not in display]
    img = img[:, :, [names.index(n) for n in display]]
    return img, display
