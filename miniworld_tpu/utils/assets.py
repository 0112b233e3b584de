"""Asset discovery and PNG loading for bundled textures and meshes.

The PNG/OBJ assets are bundled data (see assets/PROVENANCE.md); this
module resolves texture *names* to variant file lists using the same
naming scheme the reference engine uses (``{name}_{1..9}.png``,
reference: miniworld/opengl.py:113-145), so that texture-variant domain
randomization behaves identically. PNGs are decoded and resampled
with numpy and zlib alone (``read_png_rgb``, ``resize_rgb``), matching
PIL's decoder and resampler so the texture tables are unchanged.
"""

from __future__ import annotations

import functools
import math
import os
import struct
import zlib

import numpy as np

_ASSETS_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets")


def assets_dir() -> str:
    return _ASSETS_DIR


@functools.lru_cache(maxsize=None)
def texture_variant_paths(tex_name: str) -> tuple:
    """All variant files for a texture name, in variant order.

    ``tex_name`` may include a subdirectory (e.g. ``chars/ch_0x66``).
    Variant files are ``{name}_1.png .. {name}_9.png``, stopping at the
    first missing index — identical discovery to the reference.
    """
    paths = []
    for i in range(1, 10):
        path = os.path.join(_ASSETS_DIR, "textures", f"{tex_name}_{i}.png")
        if not os.path.exists(path):
            break
        paths.append(path)
    if not paths:
        # A few assets exist without the _N suffix; accept the bare name.
        bare = os.path.join(_ASSETS_DIR, "textures", f"{tex_name}.png")
        if os.path.exists(bare):
            paths.append(bare)
    if not paths:
        raise FileNotFoundError(f"no texture files found for name {tex_name!r}")
    return tuple(paths)


def mesh_path(mesh_name: str) -> str:
    path = os.path.join(_ASSETS_DIR, "meshes", f"{mesh_name}.obj")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no mesh file found for name {mesh_name!r}")
    return path


# --- PNG decoding and resampling (numpy + zlib only) -------------------

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {2: 3, 6: 4, 3: 1}  # colour type -> bytes per pixel


def _png_chunks(data: bytes, path: str):
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return


@functools.lru_cache(maxsize=None)
def png_size(path: str) -> tuple:
    """(width, height) of a PNG, from its header alone."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != _PNG_SIG or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    return struct.unpack(">II", head[16:24])


def _unfilter(raw: np.ndarray, filters: np.ndarray, bpp: int) -> np.ndarray:
    """Undo PNG scanline filters: (H, W*bpp) filtered bytes -> (H, W, bpp).

    Sub/Average/Paeth depend on the pixel to the left and Up/Average/
    Paeth on the row above, so pixels are reconstructed one
    anti-diagonal at a time: every (row, col) with row + col = d depends
    only on diagonals < d. The image is skewed so that diagonal d is
    column d (cell (r, d) holds pixel (r, d - r)), which makes each step
    a few whole-column array operations. Each row keeps its own filter.
    """
    h = raw.shape[0]
    w = raw.shape[1] // bpp
    n = h + w - 1
    rr = np.arange(h)[:, None]
    src = raw.reshape(h, w, bpp).astype(np.int16)
    skew = src[rr, np.clip(np.arange(n)[None, :] - rr, 0, w - 1)]
    # out[r + 1, d + 2] holds skewed cell (r, d); the zero top row and
    # two left columns are the image's out-of-bounds neighbours, and
    # cells left of a row's first pixel stay zero
    out = np.zeros((h + 1, n + 2, bpp), np.int16)
    f = filters.astype(np.int16)[:, None]
    is_sub, is_up, is_avg, is_paeth = (f == k for k in (1, 2, 3, 4))
    for d in range(n):
        lo, hi = max(0, d - w + 1), min(h, d + 1)  # rows on diagonal d
        a = out[lo + 1:hi + 1, d + 1]  # left: pixel (r, x - 1)
        b = out[lo:hi, d + 1]  # up: pixel (r - 1, x)
        c = out[lo:hi, d]  # up-left: pixel (r - 1, x - 1)
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.where(is_sub[lo:hi], a, np.where(is_up[lo:hi], b, np.where(
            is_avg[lo:hi], (a + b) >> 1, np.where(is_paeth[lo:hi], paeth, 0))))
        out[lo + 1:hi + 1, d + 2] = (skew[lo:hi, d] + pred) & 0xFF
    return out[1 + rr, rr + np.arange(w)[None, :] + 2].astype(np.uint8)


def read_png_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 pixels of an 8-bit RGB, RGBA or palette PNG.

    Alpha is dropped and palette entries looked up, as PIL's
    ``convert("RGB")`` does.
    """
    with open(path, "rb") as f:
        data = f.read()
    header, palette, idat = None, None, []
    for kind, body in _png_chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _comp, _filt, interlace = header
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, colour type "
            f"{ctype}, interlace {interlace}); need 8-bit RGB/RGBA/palette, "
            "non-interlaced"
        )
    bpp = _PNG_CHANNELS[ctype]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows[: h * (w * bpp + 1)].reshape(h, w * bpp + 1)
    if (rows[:, 0] > 4).any():
        raise ValueError(f"{path}: bad PNG filter type")
    px = _unfilter(rows[:, 1:], rows[:, 0], bpp)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        return palette[px[..., 0]]
    return px[..., :3]


def _bilinear(x):
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _bicubic(x, a=-0.5):
    x = np.abs(x)
    return np.where(
        x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
        np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a, 0.0),
    )


_FILTERS = {"bilinear": (_bilinear, 1.0), "bicubic": (_bicubic, 2.0)}
_PRECISION_BITS = 22  # PIL's fixed-point coefficient precision (8-bit)


def _resample_weights(in_size: int, out_size: int, kernel: str):
    """Fixed-point taps of one resize axis: (first (out,) source index,
    weights (out, taps) int64).

    The filter is widened by the scale factor when shrinking, so every
    source pixel contributes (an area filter, not point sampling);
    weights are normalised per output pixel and rounded to
    ``_PRECISION_BITS`` fractional bits — PIL's separable resampler.
    """
    fn, support = _FILTERS[kernel]
    scale = in_size / out_size
    fscale = max(scale, 1.0)
    support = support * fscale
    inv = 1.0 / fscale
    taps = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    wts = np.zeros((out_size, taps), np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), in_size)
        k = fn((np.arange(hi - lo) + lo - center + 0.5) * inv)
        total = k.sum()
        first[i] = lo
        wts[i, :hi - lo] = k / total if total != 0.0 else k
    one = 1 << _PRECISION_BITS
    fixed = np.where(wts < 0, -0.5 + wts * one, 0.5 + wts * one)
    return first, np.trunc(fixed).astype(np.int64)


def _resample_axis(img: np.ndarray, first, weights, axis: int):
    n = img.shape[axis]
    src = img.astype(np.int64)
    acc = 1 << (_PRECISION_BITS - 1)
    shape = [1] * img.ndim
    shape[axis] = -1
    for j in range(weights.shape[1]):
        idx = np.minimum(first + j, n - 1)  # zero weight past the edge
        acc = acc + np.take(src, idx, axis=axis) * weights[:, j].reshape(shape)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_rgb(img: np.ndarray, width: int, height: int,
               kernel: str = "bilinear") -> np.ndarray:
    """Resize an (H, W, 3) uint8 image like PIL's ``Image.resize``.

    ``kernel`` is "bilinear" (PIL BILINEAR) or "bicubic" (PIL BICUBIC,
    the default filter of ``Image.resize``). Horizontal pass first, each
    pass rounded to uint8, as PIL does.
    """
    h, w = img.shape[:2]
    if w != width:
        img = _resample_axis(img, *_resample_weights(w, width, kernel), 1)
    if h != height:
        img = _resample_axis(img, *_resample_weights(h, height, kernel), 0)
    return img
