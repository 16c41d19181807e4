"""Image IO (copy of ``raytracer3_tpu/utils/image.py``, numpy and zlib):
PNG write/read through PIL, imported when called, and a minimal scanline
OpenEXR reader and writer for HDR environment maps."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(path: str, img: np.ndarray) -> None:
    """Write [H,W,3] float (0..1) or uint8 image to PNG."""
    from PIL import Image

    a = np.asarray(img)
    if a.dtype != np.uint8:
        a = (np.clip(a, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    Image.fromarray(a).save(path)


def read_png(path: str) -> np.ndarray:
    """Read PNG → float32 [H,W,C] in [0,1]."""
    from PIL import Image

    return np.asarray(Image.open(path), dtype=np.float32) / 255.0


# ---------------------------------------------------------------------------
# Minimal OpenEXR 2.0 scanline reader: supports NONE/ZIP/ZIPS compression,
# HALF/FLOAT channels — covering the files Blender/pbrt-style tools emit.
# ---------------------------------------------------------------------------

_PXR_MAGIC = 20000630


def _read_null_str(buf: memoryview, off: int):
    end = off
    while buf[end] != 0:
        end += 1
    return bytes(buf[off:end]).decode("ascii"), end + 1


def _exr_predictor_undelta(data: bytearray) -> bytearray:
    # EXR ZIP post-decompress: undo delta encoding then de-interleave.
    for i in range(1, len(data)):
        data[i] = (data[i] + data[i - 1] - 128) & 0xFF
    half = (len(data) + 1) // 2
    out = bytearray(len(data))
    out[0::2] = data[:half]
    out[1::2] = data[half:]
    return out


def read_exr(path: str) -> np.ndarray:
    """Read a scanline EXR → float32 [H, W, 3] (RGB). Raises on unsupported
    layouts (tiled, PIZ/PXR24/B44 compression, deep data)."""
    with open(path, "rb") as f:
        raw = f.read()
    buf = memoryview(raw)
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _PXR_MAGIC:
        raise ValueError(f"not an EXR file: {path}")
    if version & 0x200:
        raise ValueError("tiled EXR not supported")
    off = 8

    channels = []
    compression = 0
    data_window = None
    # Header: sequence of attributes terminated by empty name.
    while True:
        name, off = _read_null_str(buf, off)
        if name == "":
            break
        atype, off = _read_null_str(buf, off)
        (asize,) = struct.unpack_from("<i", buf, off)
        off += 4
        adata = bytes(buf[off : off + asize])
        off += asize
        if name == "channels":
            coff = 0
            while adata[coff] != 0:
                cend = adata.index(0, coff)
                cname = adata[coff:cend].decode("ascii")
                ptype, _plinear, xs, ys = struct.unpack_from("<iBxxxii", adata, cend + 1)
                channels.append((cname, ptype, xs, ys))
                coff = cend + 1 + 16
        elif name == "compression":
            compression = adata[0]
        elif name == "dataWindow":
            data_window = struct.unpack("<iiii", adata)

    if data_window is None:
        raise ValueError("EXR missing dataWindow")
    x0, y0, x1, y1 = data_window
    width = x1 - x0 + 1
    height = y1 - y0 + 1

    if compression == 0:
        lines_per_block = 1
        decomp = lambda d: d  # noqa: E731
    elif compression in (2, 3):  # ZIPS (1 line), ZIP (16 lines)
        lines_per_block = 1 if compression == 2 else 16
        decomp = zlib.decompress
    else:
        raise ValueError(f"unsupported EXR compression {compression}")

    # Channels are stored alphabetically per scanline.
    chans = sorted(channels, key=lambda c: c[0])
    dtypes = {0: (np.uint32, 4), 1: (np.float16, 2), 2: (np.float32, 4)}
    bytes_per_px = sum(dtypes[c[1]][1] for c in chans)

    n_blocks = (height + lines_per_block - 1) // lines_per_block
    offsets = struct.unpack_from(f"<{n_blocks}q", buf, off)

    planes = {c[0]: np.zeros((height, width), np.float32) for c in chans}
    for block_off in offsets:
        y, size = struct.unpack_from("<ii", buf, block_off)
        data = bytes(buf[block_off + 8 : block_off + 8 + size])
        ny = min(lines_per_block, y1 - y + 1)
        expect = ny * width * bytes_per_px
        if compression in (2, 3):
            if size < expect:
                data = bytes(_exr_predictor_undelta(bytearray(decomp(data))))
            else:
                pass  # stored raw when compression didn't help
        row = y - y0
        pos = 0
        for line in range(ny):
            for cname, ptype, _, _ in chans:
                dt, nbytes = dtypes[ptype]
                n = width * nbytes
                vals = np.frombuffer(data, dtype=dt, count=width, offset=pos)
                planes[cname][row + line] = vals.astype(np.float32)
                pos += n

    if all(k in planes for k in ("R", "G", "B")):
        return np.stack([planes["R"], planes["G"], planes["B"]], axis=-1)
    if "Y" in planes:
        return np.repeat(planes["Y"][..., None], 3, axis=-1)
    # Fall back to the first three channels.
    keys = list(planes)[:3]
    return np.stack([planes[k] for k in keys], axis=-1)


def write_exr(path: str, img: np.ndarray) -> None:
    """Write float32 [H,W,3] as an uncompressed scanline EXR (FLOAT)."""
    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    header = b""

    def attr(name, atype, data):
        return name.encode() + b"\0" + atype.encode() + b"\0" + struct.pack("<i", len(data)) + data

    chan = b""
    for c in ("B", "G", "R"):
        chan += c.encode() + b"\0" + struct.pack("<iBxxxii", 2, 0, 1, 1)
    chan += b"\0"
    header += attr("channels", "chlist", chan)
    header += attr("compression", "compression", b"\0")
    dw = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header += attr("dataWindow", "box2i", dw)
    header += attr("displayWindow", "box2i", dw)
    header += attr("lineOrder", "lineOrder", b"\0")
    header += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
    header += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\0"

    line_size = 8 + w * 4 * 3
    table_off = 8 + len(header)
    data_off = table_off + 8 * h
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", _PXR_MAGIC, 2))
        f.write(header)
        for y in range(h):
            f.write(struct.pack("<q", data_off + y * line_size))
        for y in range(h):
            f.write(struct.pack("<ii", y, w * 4 * 3))
            # channels alphabetical: B, G, R
            f.write(img[y, :, 2].tobytes())
            f.write(img[y, :, 1].tobytes())
            f.write(img[y, :, 0].tobytes())
