"""Minimal OpenEXR scanline codec in pure Python (numpy and zlib); the
counterpart of mapanything_tpu/data/exr.py.

WAI datasets store depth as EXR. Neither an EXR-enabled cv2 nor the OpenEXR
package is a dependency of the port, so the subset of EXR v2 the data layer
needs is implemented directly:

  read:  single-part scanline images, FLOAT or HALF channels,
         NO_COMPRESSION / ZIPS (1 line) / ZIP (16 lines), the compressions
         WAI depth files use; returns (H, W) or (H, W, C) float32.
  write: single-channel FLOAT, ZIP compression (16-scanline blocks).

Format reference: the public OpenEXR file layout specification.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Union

import numpy as np

_MAGIC = 20000630
_PT_HALF, _PT_FLOAT = 1, 2
_NO_COMP, _ZIPS_COMP, _ZIP_COMP = 0, 2, 3


def _read_nullterm(buf: memoryview, pos: int):
    end = pos
    while buf[end] != 0:
        end += 1
    return bytes(buf[pos:end]).decode("latin-1"), end + 1


def _zip_decode(data: bytes, expected: int) -> bytes:
    raw = bytearray(zlib.decompress(data))
    # undo delta predictor
    arr = np.frombuffer(bytes(raw), np.uint8).astype(np.int16)
    arr[1:] = (np.cumsum(arr.astype(np.int64)) - np.arange(len(arr)) * 128
               )[1:] % 256
    arr = arr.astype(np.uint8)
    # undo interleave: even bytes from the first half, odd from the second
    out = np.empty(len(arr), np.uint8)
    half = (len(arr) + 1) // 2
    out[0::2] = arr[:half]
    out[1::2] = arr[half:]
    assert len(out) == expected, (len(out), expected)
    return out.tobytes()


def _zip_encode(data: bytes) -> bytes:
    arr = np.frombuffer(data, np.uint8)
    half = (len(arr) + 1) // 2
    inter = np.empty(len(arr), np.uint8)
    inter[:half] = arr[0::2]
    inter[half:] = arr[1::2]
    d = inter.astype(np.int16)
    d[1:] = np.diff(inter.astype(np.int16)) + 128
    return zlib.compress((d % 256).astype(np.uint8).tobytes(), 6)


def read_exr(path: Union[str, Path]) -> np.ndarray:
    """Read an EXR scanline image -> (H, W) or (H, W, C) float32."""
    data = memoryview(Path(path).read_bytes())
    magic, version = struct.unpack_from("<ii", data, 0)
    if magic != _MAGIC:
        raise ValueError(f"not an EXR file: {path}")
    # OpenEXR version flags: bit 9 (0x200) tiled, bit 11 (0x800) deep
    # data, bit 12 (0x1000) multi-part — this reader handles single-part
    # scanline files only (all the WAI pipeline writes/reads)
    if version & 0x200:
        raise ValueError("tiled EXR not supported (scanline only)")
    if version & 0x800:
        raise ValueError("deep-data EXR not supported")
    if version & 0x1000:
        raise ValueError("multi-part EXR not supported")
    pos = 8

    channels = []  # (name, pixel_type)
    compression = _NO_COMP
    dw = None
    while True:
        if data[pos] == 0:  # end of header
            pos += 1
            break
        name, pos = _read_nullterm(data, pos)
        atype, pos = _read_nullterm(data, pos)
        (size,) = struct.unpack_from("<i", data, pos)
        pos += 4
        payload = data[pos : pos + size]
        pos += size
        if name == "channels":
            cpos = 0
            while payload[cpos] != 0:
                cname, cpos = _read_nullterm(payload, cpos)
                ptype, = struct.unpack_from("<i", payload, cpos)
                cpos += 16  # pixel_type + pLinear/reserved + samplings
                channels.append((cname, ptype))
        elif name == "compression":
            compression = payload[0]
        elif name == "dataWindow":
            dw = struct.unpack_from("<4i", payload, 0)

    if dw is None or not channels:
        raise ValueError("missing EXR header attributes")
    if compression not in (_NO_COMP, _ZIPS_COMP, _ZIP_COMP):
        raise ValueError(f"unsupported EXR compression {compression}")
    xmin, ymin, xmax, ymax = dw
    w = xmax - xmin + 1
    h = ymax - ymin + 1
    # channels are stored per scanline in alphabetical order
    channels_sorted = sorted(channels, key=lambda c: c[0])
    bpp = {_PT_HALF: 2, _PT_FLOAT: 4}
    line_bytes = sum(bpp[pt] for _, pt in channels_sorted) * w
    lines_per_block = 16 if compression == _ZIP_COMP else 1

    nblocks = (h + lines_per_block - 1) // lines_per_block
    offsets = struct.unpack_from(f"<{nblocks}q", data, pos)
    out = {name: np.empty((h, w), np.float32) for name, _ in channels_sorted}
    for off in offsets:
        y, nbytes = struct.unpack_from("<ii", data, off)
        payload = bytes(data[off + 8 : off + 8 + nbytes])
        rows = min(lines_per_block, ymax - y + 1)
        expected = rows * line_bytes
        if nbytes == expected:  # raw block (also what ZIP stores when
            raw = payload       # compression would not shrink it)
        else:
            raw = _zip_decode(payload, expected)
        for r in range(rows):
            rpos = r * line_bytes
            for cname, ptype in channels_sorted:
                n = w * bpp[ptype]
                seg = raw[rpos : rpos + n]
                rpos += n
                vals = np.frombuffer(
                    seg, np.float16 if ptype == _PT_HALF else np.float32
                ).astype(np.float32)
                out[cname][y - ymin + r] = vals

    names = [c[0] for c in channels_sorted]
    if len(names) == 1:
        return out[names[0]]
    # prefer RGB order if present, else alphabetical stack
    order = [n for n in ("R", "G", "B", "A") if n in out] or names
    return np.stack([out[n] for n in order], axis=-1)


def write_exr(path: Union[str, Path], img: np.ndarray,
              channel: str = "Z") -> None:
    """Write a single-channel float32 EXR (ZIP, 16-line blocks)."""
    img = np.asarray(img, np.float32)
    assert img.ndim == 2, "single-channel writer"
    h, w = img.shape

    def attr(name, atype, payload):
        return (name.encode() + b"\0" + atype.encode() + b"\0"
                + struct.pack("<i", len(payload)) + payload)

    chl = (channel.encode() + b"\0" + struct.pack("<i", _PT_FLOAT)
           + b"\0\0\0\0" + struct.pack("<ii", 1, 1) + b"\0")
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = b"".join([
        attr("channels", "chlist", chl),
        attr("compression", "compression", bytes([_ZIP_COMP])),
        attr("dataWindow", "box2i", box),
        attr("displayWindow", "box2i", box),
        attr("lineOrder", "lineOrder", b"\0"),
        attr("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
        attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0)),
        attr("screenWindowWidth", "float", struct.pack("<f", 1.0)),
        b"\0",
    ])

    nblocks = (h + 15) // 16
    blocks = []
    for b in range(nblocks):
        y0 = b * 16
        rows = min(16, h - y0)
        raw = img[y0 : y0 + rows].tobytes()
        comp = _zip_encode(raw)
        if len(comp) >= len(raw):
            comp = raw  # EXR stores raw when compression does not help
        blocks.append(struct.pack("<ii", y0, len(comp)) + comp)

    base = 8 + len(header) + 8 * nblocks
    offsets = []
    off = base
    for blk in blocks:
        offsets.append(off)
        off += len(blk)

    with open(Path(path), "wb") as f:
        f.write(struct.pack("<ii", _MAGIC, 2))
        f.write(header)
        f.write(struct.pack(f"<{nblocks}q", *offsets))
        for blk in blocks:
            f.write(blk)
