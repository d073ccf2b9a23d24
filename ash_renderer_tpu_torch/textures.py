"""Mipmapped texture atlas: the host (numpy) build of
``ash_renderer_tpu.textures``, without its pytree registration.

Mip levels come from an exact integer box filter, texels are packed one
int32 per texel (r | g<<8 | b<<16 | a<<24), and ``quads`` holds each texel's
wrap-addressed 2x2 bilinear footprint so shading fetches it in one row
gather.  ``state.upload`` moves the arrays to the device.

``load_image`` and ``decode_image`` decode image files with PIL (Pillow),
imported when called: where it is not installed they raise ``ImportError``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

MAX_LEVELS = 13  # up to 4096x4096 base


def _is_pot(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


def build_mip_chain(img: np.ndarray) -> list[np.ndarray]:
    """RGBA8 (H, W, 4) -> levels, halving each step (non-power-of-two images
    get a single level)."""
    img = np.asarray(img, dtype=np.uint8)
    if img.ndim == 2:
        img = np.stack([img] * 3 + [np.full_like(img, 255)], axis=-1)
    if img.shape[-1] == 3:
        img = np.concatenate(
            [img, np.full(img.shape[:2] + (1,), 255, dtype=np.uint8)], axis=-1
        )
    levels = [img]
    h, w = img.shape[:2]
    if not (_is_pot(h) and _is_pot(w)):
        return levels
    while h > 1 or w > 1:
        cur = levels[-1].astype(np.uint16)
        if h > 1 and w > 1:
            nxt = (
                cur[0::2, 0::2] + cur[0::2, 1::2] + cur[1::2, 0::2]
                + cur[1::2, 1::2] + 2
            ) >> 2
            h, w = h // 2, w // 2
        elif w > 1:
            nxt = (cur[:, 0::2] + cur[:, 1::2] + 1) >> 1
            w = w // 2
        else:
            nxt = (cur[0::2, :] + cur[1::2, :] + 1) >> 1
            h = h // 2
        levels.append(nxt.astype(np.uint8))
    return levels


@dataclasses.dataclass
class TextureAtlas:
    """Every mip level of every texture appended row-major (numpy arrays)."""

    texels: np.ndarray  # (N,) int32 packed RGBA
    quads: np.ndarray  # (N, 4) int32 [texel, right, down, downright], wrapped
    level_offset: np.ndarray  # (M, MAX_LEVELS) i32 texel offsets
    level_w: np.ndarray  # (M, MAX_LEVELS) i32
    level_h: np.ndarray  # (M, MAX_LEVELS) i32
    n_levels: np.ndarray  # (M,) i32

    @staticmethod
    def build(images: list[np.ndarray]) -> "TextureAtlas":
        texels = []
        m = len(images)
        off = np.zeros((m, MAX_LEVELS), dtype=np.int32)
        lw = np.ones((m, MAX_LEVELS), dtype=np.int32)
        lh = np.ones((m, MAX_LEVELS), dtype=np.int32)
        nl = np.zeros(m, dtype=np.int32)
        cursor = 0
        for ti, img in enumerate(images):
            chain = build_mip_chain(img)
            nl[ti] = len(chain)
            for li, lvl in enumerate(chain):
                h, w = lvl.shape[:2]
                off[ti, li] = cursor
                lw[ti, li] = w
                lh[ti, li] = h
                texels.append(lvl.reshape(-1, 4))
                cursor += h * w
            # levels beyond the chain clamp to the last level
            for li in range(len(chain), MAX_LEVELS):
                off[ti, li] = off[ti, len(chain) - 1]
                lw[ti, li] = lw[ti, len(chain) - 1]
                lh[ti, li] = lh[ti, len(chain) - 1]
        if not texels:
            texels = [np.zeros((1, 4), dtype=np.uint8)]
        t8 = np.concatenate(texels, axis=0).astype(np.uint32)
        packed = (
            t8[:, 0] | (t8[:, 1] << 8) | (t8[:, 2] << 16) | (t8[:, 3] << 24)
        ).astype(np.uint32).view(np.int32)
        return TextureAtlas(
            texels=packed,
            quads=build_quads(packed, off, lw, lh, nl),
            level_offset=off,
            level_w=lw,
            level_h=lh,
            n_levels=nl,
        )


def build_quads(texels, off, lw, lh, nl) -> np.ndarray:
    """(N, 4) bilinear-footprint table with wrap addressing inside each
    (texture, level) sub-image."""
    texels = np.asarray(texels)
    quads = np.zeros((texels.shape[0], 4), dtype=np.int32)
    for ti in range(off.shape[0]):
        for li in range(int(nl[ti]) if int(nl[ti]) else 1):
            o, w, h = int(off[ti, li]), int(lw[ti, li]), int(lh[ti, li])
            img = texels[o : o + h * w].reshape(h, w)
            r = np.roll(img, -1, axis=1)
            d = np.roll(img, -1, axis=0)
            dr = np.roll(r, -1, axis=0)
            quads[o : o + h * w] = np.stack([img, r, d, dr], axis=-1).reshape(
                h * w, 4
            )
    return quads


def _pil_image(fn: str):
    """PIL's ``Image`` module, or an ImportError naming ``fn``."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{fn} decodes images with PIL (Pillow), which is "
                          "not installed") from e
    return Image


def load_image(path: str) -> np.ndarray:
    """Decode an image file to RGBA8 (H, W, 4) uint8 (PIL; the reference
    uses the Rust ``image`` crate in textures.rs:10-13)."""
    image = _pil_image("textures.load_image")
    with image.open(path) as im:
        return np.asarray(im.convert("RGBA"), dtype=np.uint8)


def decode_image(data: bytes) -> np.ndarray:
    """Decode an image held in memory (a glTF embedded image) to RGBA8."""
    import io

    image = _pil_image("textures.decode_image")
    with image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGBA"), dtype=np.uint8)


def checkerboard(size: int = 256, cells: int = 8) -> np.ndarray:
    """Deterministic procedural test texture."""
    ij = np.arange(size)
    cell = size // cells
    cb = ((ij[:, None] // cell) + (ij[None, :] // cell)) % 2
    img = np.zeros((size, size, 4), dtype=np.uint8)
    img[..., 0] = np.where(cb, 230, 40)
    img[..., 1] = np.where(cb, 60, 180)
    img[..., 2] = np.where(cb, 60, 230)
    img[..., 3] = 255
    return img
