"""LLaVA-NeXT's anyres geometry, as the HuggingFace processor and model
compute it (`select_best_resolution`, `get_anyres_image_grid_shape`,
`unpad_image`, `_get_number_of_features`), written again from them."""

from __future__ import annotations

import math
from typing import Sequence, Tuple


def best_resolution(hw: Tuple[int, int], pinpoints: Sequence[Sequence[int]]) -> Tuple[int, int]:
    """The pinpoint (height, width) that keeps the most of the image, then
    wastes the least."""
    h, w = hw
    best, best_eff, best_waste = None, 0, float("inf")
    for ph, pw in pinpoints:
        s = min(pw / w, ph / h)
        eff = min(int(w * s) * int(h * s), w * h)
        waste = pw * ph - eff
        if eff > best_eff or (eff == best_eff and waste < best_waste):
            best, best_eff, best_waste = (ph, pw), eff, waste
    return best


def num_tiles(hw, pinpoints, tile: int) -> int:
    """The base tile and the pinpoint's grid of tiles."""
    ph, pw = best_resolution(hw, pinpoints)
    return math.ceil(ph / tile) * math.ceil(pw / tile) + 1


def unpadded(hw, grid_h: int, grid_w: int) -> Tuple[int, int, int]:
    """(rows, cols, pad) of a (grid_h, grid_w) token grid with the letterbox
    of an image of size `hw` cut away (`unpad_image`'s rounding)."""
    h, w = hw
    if w / h > grid_w / grid_h:
        new_h = int(round(h * (grid_w / w), 7))
        pad = (grid_h - new_h) // 2
        return grid_h - 2 * pad, grid_w, pad
    new_w = int(round(w * (grid_h / h), 7))
    pad = (grid_w - new_w) // 2
    return grid_h, grid_w - 2 * pad, pad


def num_features(hw, pinpoints, tile: int, patch: int) -> int:
    """Image tokens after packing under the "default" strategy: the base
    tile's patches, then the unpadded grid with a newline a row."""
    ph, pw = best_resolution(hw, pinpoints)
    side = tile // patch
    rows, cols, _ = unpadded(hw, side * (ph // tile), side * (pw // tile))
    return side * side + rows * (cols + 1)
