"""Texture atlas construction for the raycaster.

Replaces GL texture objects (miniworld/opengl.py:102-194) with a single
uint8 atlas array ``(N, RES, RES, 3)`` uploaded once per env class.
Deviation from the reference renderer: sampling is nearest-neighbor at
a fixed resolution instead of trilinear mipmapping (GL), which testing
treats as a statistical — not bit-level — visual parity target.

Texture *names* resolve to variant file lists exactly like the
reference (``{name}_{1..9}.png``) so texture-variant domain
randomization selects among the same images.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass, field

import numpy as np

from miniworld_tpu.utils.assets import (
    png_size, read_png_rgb, resize_rgb, texture_variant_paths,
)

# Texels per meter used to generate wall/floor UVs
# (reference: miniworld/miniworld.py:80).
TEX_DENSITY = 512

# Atlas tile resolution. 256 keeps the atlas small (a scene uses ~6-40
# textures -> a few MB) while staying visually close to the 512px
# sources at 80x60 observation sizes.
ATLAS_RES = 256

# Fourier terms per texture for the gather-free texture model.
# Validated against the bundled assets: at K=32 the reconstruction RMSE
# (0.008-0.045) beats an 8x8 mip (0.012-0.185) on every wall/floor
# texture, i.e. it is sharper than what GL trilinear minification shows
# at 80x60 observation sizes.
# Default Fourier term count: rendered error vs the exact
# nearest-sampling ground truth is identical at K=16 and K=32 on every
# benchmarked env (PSNR within 0.1 dB — the model's own error dominates
# truncation; the fit keeps terms energy-sorted so truncation drops the
# weakest), while the per-pixel texture stage scales linearly with K.
# K=8 visibly softens checkerboards. Glyph
# envs override per spec (Sign uses 64, envs/interact.py).
FOURIER_TERMS = 16


def fit_fourier_texture(img: np.ndarray, k: int = FOURIER_TERMS,
                        gain: float = 1.0) -> np.ndarray:
    """Fit one texture to a K-term 2-D cosine series; returns packed f32.

    Texturing rationale (a design made for another chip, where per-pixel
    gathers dominated the render cost; not yet measured on the GPU,
    ROADMAP A3): instead of per-pixel atlas lookups, each texture is
    approximated as

        texel(u, v) = dc + sum_k  A_k * cos(arg_k) + B_k * sin(arg_k),
        arg_k = 2*pi*(fu_k * u + fv_k * v)

    with INTEGER frequencies, so GL_REPEAT tiling (the reference wraps
    all wall/floor textures; miniworld/opengl.py:180-183) is free:
    cos(2*pi*f*(u+n)) == cos(2*pi*f*u). Evaluation is elementwise math
    on the winning texture's coefficients, selected by a one-hot matrix
    product — zero gathers anywhere in the pixel pipeline.

    Packing: [dc(3) | fu(K) | fv(K) | A(K*3) | B(K*3) | gain(1)]
    = 4 + 8K floats. ``gain`` is a contrast-expansion factor applied
    after reconstruction for near-binary images (char glyphs): K
    cosine terms cannot make sharp strokes (fit error measured flat in
    K for binary glyphs), but expanding the soft reconstruction away
    from the image mean recovers legible edges. gain == 1 for normal
    textures (identity).
    """
    r = img.shape[0]
    f = np.fft.fft2(img, axes=(0, 1))  # (R, R, 3) complex
    mag = np.abs(f).sum(axis=2)
    mag[0, 0] = 0.0  # DC handled separately
    fy = np.fft.fftfreq(r) * r
    fx = np.fft.fftfreq(r) * r
    grid_fy, grid_fx = np.meshgrid(fy, fx, indexing="ij")
    # keep one of each conjugate pair
    half = (grid_fy > 0) | ((grid_fy == 0) & (grid_fx > 0))
    order = np.argsort(np.where(half, mag, 0.0).ravel())[::-1][:k]
    ys, xs = np.unravel_index(order, mag.shape)

    dc = np.real(f[0, 0]) / (r * r)  # (3,)
    coeff = f[ys, xs] / (r * r)  # (K, 3) complex
    # image coords: row i = y, col j = x with basis cos(2pi(fy*i/R + fx*j/R));
    # texture coords: u = j/R (right), v = 1 - i/R (up from bottom, GL) so
    # i/R = 1 - v and integer fy gives cos(2pi(-fy*v + fx*u) + const 2pi*fy)
    fu = grid_fx[ys, xs]
    fv = -grid_fy[ys, xs]
    # 2*Re[c * e^{i theta}] = 2|c|cos(ang+theta) = A cos(theta) + B sin(theta)
    a_term = 2.0 * np.real(coeff)  # (K, 3)
    b_term = -2.0 * np.imag(coeff)
    return np.concatenate(
        [dc, fu, fv, a_term.T.ravel(), b_term.T.ravel(), [gain]]
    ).astype(np.float32)


def fit_sdf_texture(img: np.ndarray, k: int = FOURIER_TERMS,
                    edge_width: float = 3.0,
                    dilate: float = 2.0) -> np.ndarray:
    """Fit a near-binary glyph as a Fourier SIGNED DISTANCE FIELD.

    K cosine terms cannot reproduce sharp strokes directly (the fit
    error is flat in K for binary images — measured), but a glyph's
    signed distance field is SMOOTH, so the same K terms fit it well;
    thresholding the reconstructed distance at render time recovers
    crisp edges at any magnification (the classic SDF font-rendering
    scheme, here with a Fourier basis instead of a bilinear texture so
    the evaluation stays gather-free).

    ``dilate`` shifts the iso-surface outward by that many texels,
    thickening thin handwritten strokes so they survive the K-term
    budget (K complex terms = 2K real DOF; at K=32 a thin-stroke 'R'
    loses its bowl entirely). Measured on the NIST chars: K=32 direct
    fit + contrast gain -> illegible ringing blobs; K=32 SDF -> clean
    but wispy; K=64 SDF + dilate 2 -> clearly legible letters (the
    Sign spec opts into K=64 via EnvSpec.fourier_k).

    Same (4 + 8K) packing as ``fit_fourier_texture`` so both modes
    share one table; fields are reinterpreted:

      dc(3)       -> [sdf_dc | ink_gray | bg_gray]
      A/B channels-> channel 0 carries the sdf amplitudes, 1-2 zero
      gain        -> NEGATIVE: -1/(2*w), w = edge half-width in texels
                     (the render path treats gain < 0 as SDF mode)

    The generic evaluator's channel contraction then yields
    [sdf(u,v) | ink | bg] per pixel for free, and the SDF branch maps
    s = clip(0.5 - sdf*gain) -> ink + (bg-ink)*s. The frequency-space
    AA attenuation shrinks the AC part toward sdf_dc (> 0: background)
    at heavy minification, so distant glyphs fade into their
    background — the correct limit for mostly-background tiles.
    """
    from scipy import ndimage

    r = img.shape[0]
    g = img.mean(axis=2)
    ink = g < 0.5
    ink_gray = float(g[ink].mean()) if ink.any() else 0.0
    bg_gray = float(g[~ink].mean()) if (~ink).any() else 1.0
    d_out = ndimage.distance_transform_edt(~ink)
    d_in = ndimage.distance_transform_edt(ink)
    # clamp the far field: the fit should spend its terms near strokes,
    # not on the exact distance to a far-away letter (r/8 measured best
    # of r/32, r/16, r/8 on the chars set)
    sdf = np.clip(d_out - d_in - dilate, -r / 8.0, r / 8.0)

    f = np.fft.fft2(sdf)
    mag = np.abs(f)
    mag[0, 0] = 0.0
    fr = np.fft.fftfreq(r) * r
    grid_fy, grid_fx = np.meshgrid(fr, fr, indexing="ij")
    half = (grid_fy > 0) | ((grid_fy == 0) & (grid_fx > 0))
    order = np.argsort(np.where(half, mag, 0.0).ravel())[::-1][:k]
    ys, xs = np.unravel_index(order, mag.shape)

    coeff = f[ys, xs] / (r * r)  # (K,) complex
    fu = grid_fx[ys, xs]
    fv = -grid_fy[ys, xs]  # v flip: see fit_fourier_texture
    a_term = np.zeros((k, 3))
    b_term = np.zeros((k, 3))
    a_term[:, 0] = 2.0 * np.real(coeff)
    b_term[:, 0] = -2.0 * np.imag(coeff)
    dc = np.array([np.real(f[0, 0]) / (r * r), ink_gray, bg_gray])
    return np.concatenate(
        [dc, fu, fv, a_term.T.ravel(), b_term.T.ravel(),
         [-1.0 / (2.0 * edge_width)]]
    ).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _load_tile(path: str, res: int) -> bytes:
    return resize_rgb(read_png_rgb(path), res, res).tobytes()


@dataclass
class TextureCatalog:
    """Accumulates texture files and assigns atlas indices.

    Scenes register *named slots* (e.g. a room's wall texture). Each
    slot maps to a contiguous run of atlas indices — one per variant
    file — so the device can pick ``base + randint(count)`` for
    texture-variant domain randomization (reference behavior:
    miniworld/opengl.py:136-140 picks uniformly among variants; without
    randomization variant 0 is used).
    """

    res: int = ATLAS_RES
    paths: list = field(default_factory=list)
    _path_idx: dict = field(default_factory=dict)
    slots: list = field(default_factory=list)  # (slot_name, base, count)
    _slot_idx: dict = field(default_factory=dict)

    def add_path(self, path: str) -> int:
        """Register a single file; returns its atlas index."""
        if path not in self._path_idx:
            self._path_idx[path] = len(self.paths)
            self.paths.append(path)
        return self._path_idx[path]

    def slot_for_name(self, tex_name: str) -> int:
        """Register a named texture slot (all variants); returns slot id."""
        if tex_name in self._slot_idx:
            return self._slot_idx[tex_name]
        variant_paths = texture_variant_paths(tex_name)
        base = self.add_path(variant_paths[0])
        for p in variant_paths[1:]:
            self.add_path(p)
        slot_id = len(self.slots)
        self.slots.append((tex_name, base, len(variant_paths)))
        self._slot_idx[tex_name] = slot_id
        return slot_id

    def slot_for_path(self, path: str) -> int:
        """Register a single-file slot (mesh textures, no variants)."""
        key = f"__path__:{path}"
        if key in self._slot_idx:
            return self._slot_idx[key]
        base = self.add_path(path)
        slot_id = len(self.slots)
        self.slots.append((key, base, 1))
        self._slot_idx[key] = slot_id
        return slot_id

    def uv_multiplier(self, tex_name: str) -> tuple:
        """(TEX_DENSITY/width, TEX_DENSITY/height) of variant 0.

        The reference derives UVs from the loaded variant's pixel size
        (miniworld/miniworld.py:83-120). We bake UVs with variant 0's
        size; variants of differing size would scale slightly
        differently under domain randomization (minor, documented).
        """
        w, h = png_size(texture_variant_paths(tex_name)[0])
        return TEX_DENSITY / w, TEX_DENSITY / h

    def build_atlas(self) -> np.ndarray:
        """(N, res, res, 3) uint8 atlas of all registered files."""
        n = max(len(self.paths), 1)
        atlas = np.zeros((n, self.res, self.res, 3), dtype=np.uint8)
        for i, path in enumerate(self.paths):
            atlas[i] = np.frombuffer(_load_tile(path, self.res), dtype=np.uint8).reshape(
                self.res, self.res, 3
            )
        return atlas

    def build_fourier(self, k_terms: int = FOURIER_TERMS) -> np.ndarray:
        """(N, 4 + 8K) packed Fourier coefficients of all textures.

        See ``fit_fourier_texture`` — the render path evaluates
        textures from this table with zero per-pixel gathers.
        """
        n = max(len(self.paths), 1)
        out = np.zeros((n, 4 + 8 * k_terms), dtype=np.float32)
        out[:, -1] = 1.0
        for i, path in enumerate(self.paths):
            tile = np.frombuffer(_load_tile(path, self.res), dtype=np.uint8)
            img = tile.reshape(self.res, self.res, 3).astype(np.float64) / 255.0
            # SDF fit for character glyphs only (the chars/ set):
            # generic near-binary detection would also catch
            # checkerboard floors, whose correct rendering is the
            # direct fit + AA attenuation, not thresholded strokes
            is_glyph = f"textures{os.sep}chars{os.sep}" in path or "/chars/" in path
            out[i] = (fit_sdf_texture(img, k_terms) if is_glyph
                      else fit_fourier_texture(img, k_terms))
        return out

    def slot_tables(self) -> tuple:
        """(base, count) int32 arrays indexed by slot id."""
        n = max(len(self.slots), 1)
        base = np.zeros(n, dtype=np.int32)
        count = np.ones(n, dtype=np.int32)
        for i, (_, b, c) in enumerate(self.slots):
            base[i] = b
            count[i] = c
        return base, count
