"""On-read image crop and resize and the upload-time EXIF orientation fix
(a copy of seaweedfs_tpu/images/; PIL is imported lazily, and without it
the bytes pass through unchanged)."""
from .resizing import cropped, resized

__all__ = ["cropped", "resized"]
