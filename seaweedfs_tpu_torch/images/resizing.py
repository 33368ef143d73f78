"""On-read image resizing (reference: weed/images/resizing.go).

Same query semantics as the reference volume server read path:
`?width=&height=&mode=` where

- both dims + ``mode=fit``  -> scale to fit inside the box, keep ratio
- both dims + ``mode=fill`` -> scale to cover the box, center-crop
- both dims, no mode        -> exact resize (ratio may change)
- one dim                   -> scale preserving aspect ratio

Non-image payloads and zero dimensions pass through untouched.
"""
from __future__ import annotations

import io


def resized(
    data: bytes, width: int = 0, height: int = 0, mode: str = ""
) -> bytes:
    if not (width or height):
        return data
    try:
        from PIL import Image
    except ImportError:  # pragma: no cover - PIL is in the image
        return data
    try:
        img = Image.open(io.BytesIO(data))
        fmt = img.format
        if fmt not in ("PNG", "JPEG", "GIF"):
            return data
        if fmt == "JPEG":
            # turn the pixels upright BEFORE resizing: the re-encode drops
            # EXIF, so an ignored orientation tag would serve thumbnails
            # sideways (reference FixJpgOrientation, images/orientation.go)
            from PIL import ImageOps

            img = ImageOps.exif_transpose(img)
        ow, oh = img.size
        if width and height:
            if mode == "fit":
                img.thumbnail((width, height))
            elif mode == "fill":
                scale = max(width / ow, height / oh)
                img = img.resize((round(ow * scale), round(oh * scale)))
                left = (img.width - width) // 2
                top = (img.height - height) // 2
                img = img.crop((left, top, left + width, top + height))
            else:
                img = img.resize((width, height))
        elif width:
            img = img.resize((width, max(1, round(oh * width / ow))))
        else:
            img = img.resize((max(1, round(ow * height / oh)), height))
        buf = io.BytesIO()
        img.save(buf, format=fmt)
        return buf.getvalue()
    except Exception:
        # never fail a read because a thumbnail couldn't be produced
        return data


def cropped(data: bytes, x1: int, y1: int, x2: int, y2: int) -> bytes:
    """On-read crop (reference images/cropping.go, applied BEFORE resize):
    the (x1,y1)-(x2,y2) box clamped to the image; invalid boxes and
    non-image payloads pass through untouched."""
    if not (x1 >= 0 and y1 >= 0 and x2 > x1 and y2 > y1):
        return data
    try:
        from PIL import Image
    except ImportError:  # pragma: no cover - PIL is in the image
        return data
    try:
        img = Image.open(io.BytesIO(data))
        fmt = img.format
        if fmt not in ("PNG", "JPEG", "GIF"):
            return data
        if fmt == "JPEG":
            # upright the pixels BEFORE cropping: the re-encode drops
            # EXIF, and the crop box is expressed in display coordinates
            # (same invariant as resized() above)
            from PIL import ImageOps

            img = ImageOps.exif_transpose(img)
        x2 = min(x2, img.width)
        y2 = min(y2, img.height)
        if x2 <= x1 or y2 <= y1:
            return data
        buf = io.BytesIO()
        img.crop((x1, y1, x2, y2)).save(buf, format=fmt)
        return buf.getvalue()
    except Exception:
        # never fail a read because a crop couldn't be produced
        return data
