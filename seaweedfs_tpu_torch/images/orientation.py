"""EXIF orientation fix (reference: weed/images/orientation.go).

Cameras record rotation as EXIF tag 0x0112 instead of rotating pixels;
a resize pipeline that ignores it re-encodes thumbnails sideways (the
EXIF is dropped but the pixels were never turned).  `fix_orientation`
transposes the pixels per the tag and clears it, so every downstream
consumer sees an upright image.
"""
from __future__ import annotations

import io

ORIENTATION_TAG = 0x0112


def fix_orientation(data: bytes) -> bytes:
    """JPEG bytes -> upright JPEG bytes (pass-through for non-JPEG,
    missing/normal orientation, or any decode error)."""
    try:
        from PIL import Image, ImageOps
    except ImportError:  # pragma: no cover - PIL is in the image
        return data
    try:
        img = Image.open(io.BytesIO(data))
        if img.format != "JPEG":
            return data
        if img.getexif().get(ORIENTATION_TAG, 1) == 1:
            return data
        fixed = ImageOps.exif_transpose(img)
        buf = io.BytesIO()
        fixed.save(buf, format="JPEG", quality=95)
        return buf.getvalue()
    except Exception:
        return data  # never fail a read over a bad EXIF block
