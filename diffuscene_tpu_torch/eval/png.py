"""A PNG writer and reader on ``zlib`` and ``struct`` alone.

The port's renders, textures and FID folders are PNG files, and the card's
machine has no Pillow.  This codec covers what they need: 8-bit samples,
grey (L), grey + alpha (LA), RGB, RGBA and palette images, non-interlaced,
and all five row filters on read.  ``write_png`` filters every row with
Sub (type 1).  ``read_image_rgb`` is the counterpart of Pillow's
``Image.open(path).convert("RGB")``: it decodes what the codec covers and
hands anything else (a JPEG, a 16-bit or interlaced PNG) to Pillow where
Pillow is installed.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples a pixel (8-bit depth only)
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_COLOUR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}           # channels -> colour type on write


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """(H, W), (H, W, 1), (H, W, 2), (H, W, 3) or (H, W, 4) uint8 -> PNG bytes."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8 images, not {a.dtype}")
    if a.ndim == 2:
        a = a[:, :, None]
    if a.ndim != 3 or a.shape[2] not in _COLOUR_TYPE:
        raise ValueError(f"encode_png takes (H, W[, 1-4]) images, not {a.shape}")
    h, w, c = a.shape
    rows = a.reshape(h, w * c).astype(np.int16)
    sub = rows.copy()
    sub[:, c:] -= rows[:, :-c]                     # Sub: each byte less the byte a pixel left
    raw = np.empty((h, 1 + w * c), np.uint8)
    raw[:, 0] = 1
    raw[:, 1:] = (sub & 0xFF).astype(np.uint8)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOUR_TYPE[c], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes())) + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def _unfilter(data: bytes, h: int, w: int, c: int) -> np.ndarray:
    stride = w * c
    buf = np.frombuffer(data, np.uint8)
    if buf.size != h * (stride + 1):
        raise ValueError(f"PNG image data holds {buf.size} bytes, not {h * (stride + 1)}")
    buf = buf.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.int64)
    for y in range(h):
        ftype, line = int(buf[y, 0]), buf[y, 1:].astype(np.int64)
        if ftype == 0:
            row = line
        elif ftype == 1:        # Sub: a running sum over each channel
            row = np.cumsum(line.reshape(w, c), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:        # Up
            row = (line + prior) & 0xFF
        elif ftype in (3, 4):   # Average and Paeth depend on the pixel just decoded
            up, cur = prior.tolist(), line.tolist()
            for i in range(stride):
                left = cur[i - c] if i >= c else 0
                if ftype == 3:
                    cur[i] = (cur[i] + ((left + up[i]) >> 1)) & 0xFF
                else:
                    ul = up[i - c] if i >= c else 0
                    p = left + up[i] - ul
                    pa, pb, pc = abs(p - left), abs(p - up[i]), abs(p - ul)
                    pred = left if pa <= pb and pa <= pc else (up[i] if pb <= pc else ul)
                    cur[i] = (cur[i] + pred) & 0xFF
            row = np.asarray(cur, np.int64)
        else:
            raise ValueError(f"PNG row filter {ftype} is not one of 0-4")
        out[y] = row
        prior = row
    return out.reshape(h, w, c)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8, C the file's samples a pixel (1 L, 2 LA,
    3 RGB, 4 RGBA); a palette image comes back as RGB, or RGBA with a tRNS
    chunk.  Raises ValueError for a file outside the codec or a damaged one."""
    try:
        return _decode_png(data)
    except (struct.error, zlib.error) as e:
        raise ValueError(f"damaged PNG file: {e}") from e


def _decode_png(data: bytes) -> np.ndarray:
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, palette, alpha, idat = 8, None, None, None, []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            alpha = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG file without IHDR or IDAT")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(f"PNG of bit depth {depth}, colour type {ctype}, interlace "
                         f"{interlace}: the codec reads 8-bit non-interlaced L/LA/RGB/RGBA/P")
    img = _unfilter(zlib.decompress(b"".join(idat)), h, w, _CHANNELS[ctype])
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        idx = img[:, :, 0]
        rgb = palette[np.minimum(idx, len(palette) - 1)]
        if alpha is None:
            return rgb
        full = np.full(len(palette), 255, np.uint8)
        full[:min(len(alpha), len(full))] = alpha[:len(full)]
        return np.concatenate([rgb, full[np.minimum(idx, len(full) - 1)][:, :, None]], axis=2)
    return img


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def to_rgb(img: np.ndarray) -> np.ndarray:
    """(H, W, C) uint8 -> (H, W, 3): grey is repeated, alpha dropped (as
    Pillow's ``convert("RGB")``)."""
    if img.shape[2] in (1, 2):
        return np.repeat(img[:, :, :1], 3, axis=2)
    return img[:, :, :3]


def read_image_rgb(path: str) -> np.ndarray:
    """Any image file -> (H, W, 3) uint8: the codec for the PNGs it covers,
    Pillow for the rest (ImportError where Pillow is not installed)."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return to_rgb(decode_png(data))
    except ValueError:
        from PIL import Image

        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))
