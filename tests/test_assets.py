"""PNG decoding and resampling without PIL (utils/assets.py), held to
PIL itself: the texture tables must not change with the decoder."""

import os
import struct
import zlib

import numpy as np
import pytest

from miniworld_tpu.utils.assets import (
    assets_dir, png_size, read_png_rgb, resize_rgb,
)


def _asset(rel):
    return os.path.join(assets_dir(), rel)


# one bundled asset per PNG colour type the reader supports
COLOUR_TYPES = {
    "rgb": "textures/chars/ch_0x108_11.png",  # colour type 2
    "rgba": "textures/lava_1.png",  # colour type 6
    "palette": "textures/water_2.png",  # colour type 3
}


@pytest.mark.parametrize("kind", sorted(COLOUR_TYPES))
def test_png_reader_matches_pil(kind):
    Image = pytest.importorskip("PIL.Image")
    path = _asset(COLOUR_TYPES[kind])
    with Image.open(path) as im:
        want = np.asarray(im.convert("RGB"))
        assert png_size(path) == im.size
    got = read_png_rgb(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rel", [
    "textures/chars/ch_0x108_11.png",  # 128 -> 256 (upsample)
    "meshes/building.png",  # 1024 -> 256 (area-filtered downsample)
    "textures/logo_mila_1.png",  # 1024x510, RGBA: separate axis scales
])
def test_bilinear_resize_within_one_level_of_pil(rel):
    Image = pytest.importorskip("PIL.Image")
    path = _asset(rel)
    with Image.open(path) as im:
        want = np.asarray(im.convert("RGB").resize((256, 256), Image.BILINEAR))
    got = resize_rgb(read_png_rgb(path), 256, 256)
    assert np.abs(got.astype(int) - want).max() <= 1


def test_bicubic_thumbnail_matches_pil_default_resize():
    """Mesh-texture mean colours come from an 8x8 thumbnail made with
    Image.resize's default filter (BICUBIC)."""
    Image = pytest.importorskip("PIL.Image")
    path = _asset("meshes/duckie.png")
    with Image.open(path) as im:
        want = np.asarray(im.convert("RGB").resize((8, 8)))
    got = resize_rgb(read_png_rgb(path), 8, 8, "bicubic")
    assert np.abs(got.astype(int) - want).max() <= 1


def _png(tmp_path, ihdr_tail):
    """A minimal PNG with a 1x1 image and the given IHDR depth/type."""
    def chunk(kind, body):
        crc = zlib.crc32(kind + body) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)

    ihdr = struct.pack(">II", 1, 1) + ihdr_tail
    data = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(b"\x00" + b"\x00" * 6))
            + chunk(b"IEND", b""))
    path = tmp_path / "x.png"
    path.write_bytes(data)
    return str(path)


def test_unsupported_png_is_refused(tmp_path):
    # 16-bit RGB: outside the reader's 8-bit contract
    path = _png(tmp_path, bytes([16, 2, 0, 0, 0]))
    with pytest.raises(ValueError, match="unsupported PNG"):
        read_png_rgb(path)
    # interlaced 8-bit RGB
    path = _png(tmp_path, bytes([8, 2, 0, 0, 1]))
    with pytest.raises(ValueError, match="unsupported PNG"):
        read_png_rgb(path)
