"""PNG decoding for the data path.

The reference decodes frames through PIL (``io/flo_io.py:84-96``).  Here the
hot serving path uses a native C decoder (``native/pngdec.c``: one buffered
read, streaming zlib inflate, scanline unfilter, straight into a numpy
buffer) so background loader threads (``io/loader.py``) decode without any
Python-level per-chunk work.  Without a C toolchain, the same 8-bit
non-interlaced subset (what the Middlebury frames use) is decoded with numpy
and the standard library's ``zlib``; PIL is imported only for the formats
outside that subset (16-bit, interlaced, ...).
"""
from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG color type -> samples/pixel


def _native():
    try:
        from optical_flow_tpu.native.build import load_pngdec

        return load_pngdec()
    except Exception:
        return None


def read_png(path) -> np.ndarray:
    """Decode a PNG into a uint8 array: (H, W) for grayscale, else (H, W, C).

    Matches ``np.array(PIL.Image.open(path))`` exactly for 8-bit
    non-interlaced gray/RGB/palette/alpha files (palette expands to RGB, as
    PIL's default mode conversion does for dataset images); falls back to
    PIL for anything else.
    """
    lib = _native()
    path = str(path)
    if lib is not None:
        w = ctypes.c_int32()
        h = ctypes.c_int32()
        ch = ctypes.c_int32()
        null_u8 = ctypes.POINTER(ctypes.c_uint8)()
        rc = lib.png_decode_file(
            path.encode(), null_u8, 0, ctypes.byref(w), ctypes.byref(h), ctypes.byref(ch)
        )
        if rc == -1:
            raise FileNotFoundError(path)
        if rc == 0:
            out = np.empty((h.value, w.value, ch.value), dtype=np.uint8)
            rc = lib.png_decode_file(
                path.encode(),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                out.size,
                ctypes.byref(w),
                ctypes.byref(h),
                ctypes.byref(ch),
            )
            if rc == 0:
                return out[:, :, 0] if ch.value == 1 else out
        # unsupported subset or unexpected rc: fall through

    out = _read_png_python(path)
    if out is not None:
        return out

    from PIL import Image

    with Image.open(path) as im:
        if im.mode == "P":
            im = im.convert("RGB")
        return np.array(im)


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline PNG filters (None/Sub/Up/Average/Paeth)."""
    stride = w * bpp
    rows = np.frombuffer(raw, np.uint8)[: h * (stride + 1)].reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for r in range(h):
        ftype, line = rows[r, 0], rows[r, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:  # Sub: running sum per channel, mod 256
            cur = np.cumsum(line.reshape(w, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = line + prior
        elif ftype in (3, 4):  # Average / Paeth: sequential along the row
            x = bytearray(line.tobytes())
            b = prior.tobytes()
            for i in range(stride):
                left = x[i - bpp] if i >= bpp else 0
                up = b[i]
                if ftype == 3:
                    pred = (left + up) >> 1
                else:
                    ul = b[i - bpp] if i >= bpp else 0
                    pa, pb, pc = abs(up - ul), abs(left - ul), abs(left + up - 2 * ul)
                    pred = left if pa <= pb and pa <= pc else (up if pb <= pc else ul)
                x[i] = (x[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(x), np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[r] = cur
        prior = cur
    return out


def _read_png_python(path):
    """numpy + zlib decoder for 8-bit non-interlaced PNGs; None otherwise."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        return None
    pos, idat, hdr, palette = 8, [], None, None
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        kind, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        return None
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or interlace != 0 or ctype not in _CHANNELS:
        return None
    if ctype == 3 and palette is None:
        return None
    ch = _CHANNELS[ctype]
    img = _unfilter(zlib.decompress(b"".join(idat)), h, w, ch).reshape(h, w, ch)
    if ctype == 3:
        return palette[img[:, :, 0]]
    return img[:, :, 0] if ch == 1 else img
