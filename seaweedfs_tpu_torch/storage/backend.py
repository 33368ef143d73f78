"""Tiered storage backends for volume `.dat` files.

Port of seaweedfs_tpu/storage/backend.py (reference:
weed/storage/backend/backend.go): a BackendStorage registry ("type.id"
names, configured once per process from master.toml's [storage.backend]
and the volume server's -tier.dir) whose storages hold whole .dat files
remotely while the .idx stays local; a tiered volume reads needles with
ranged reads (RemoteDat) and refuses writes.

One backend type is here: a directory-rooted object store ("local").  The
"s3" type waits for the port's S3 client (ROADMAP A10): configure()
refuses an s3 section by name instead of skipping it, so a volume server
never starts believing it has a tier it cannot reach.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import threading


class BackendStorage:
    """Interface (backend.go BackendStorage + BackendStorageFile)."""

    backend_type = "abstract"

    def __init__(self, backend_id: str):
        self.id = backend_id

    @property
    def name(self) -> str:
        return f"{self.backend_type}.{self.id}"

    def upload(self, local_path: str, key: str) -> int:  # -> stored size
        raise NotImplementedError

    def download(self, key: str, local_path: str) -> None:
        raise NotImplementedError

    def delete_key(self, key: str) -> None:
        raise NotImplementedError

    def pread(self, key: str, size: int, offset: int) -> bytes:
        raise NotImplementedError

    def size(self, key: str) -> int:
        raise NotImplementedError

    def list_keys(self, prefix: str = "") -> list[tuple[str, int]]:
        """[(key, size)] under a prefix (remote_storage.go ListDirectory)."""
        raise NotImplementedError

    def put_bytes(self, key: str, data: bytes) -> None:
        with tempfile.NamedTemporaryFile(delete=False) as f:
            f.write(data)
            tmp = f.name
        try:
            self.upload(tmp, key)
        finally:
            os.unlink(tmp)

    def get_bytes(self, key: str) -> bytes:
        return self.pread(key, self.size(key), 0)


class LocalBackendStorage(BackendStorage):
    """Directory-rooted object store ("local" type), with the call
    patterns of the reference's s3_backend."""

    backend_type = "local"

    def __init__(self, backend_id: str, root_dir: str):
        super().__init__(backend_id)
        self.root = root_dir
        os.makedirs(root_dir, exist_ok=True)

    def _path(self, key: str) -> str:
        p = os.path.normpath(os.path.join(self.root, key.lstrip("/")))
        if not p.startswith(self.root + os.sep) and p != self.root:
            raise ValueError(f"key escapes the store root: {key!r}")
        return p

    def upload(self, local_path: str, key: str) -> int:
        dst = self._path(key)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        tmp = dst + ".tmp"
        shutil.copyfile(local_path, tmp)
        os.replace(tmp, dst)
        return os.path.getsize(dst)

    def download(self, key: str, local_path: str) -> None:
        tmp = local_path + ".tmp"
        shutil.copyfile(self._path(key), tmp)
        os.replace(tmp, local_path)

    def delete_key(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def pread(self, key: str, size: int, offset: int) -> bytes:
        with open(self._path(key), "rb") as f:
            return os.pread(f.fileno(), size, offset)

    def size(self, key: str) -> int:
        return os.path.getsize(self._path(key))

    def put_bytes(self, key: str, data: bytes) -> None:
        dst = self._path(key)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        tmp = dst + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, dst)

    def list_keys(self, prefix: str = "") -> list[tuple[str, int]]:
        out = []
        prefix = prefix.lstrip("/")
        for dirpath, _, files in os.walk(self.root):
            for name in files:
                if name.endswith(".tmp"):
                    continue
                full = os.path.join(dirpath, name)
                key = os.path.relpath(full, self.root)
                if prefix and not key.startswith(prefix):
                    continue
                out.append((key, os.path.getsize(full)))
        return sorted(out)


_BACKEND_TYPES = {"local": LocalBackendStorage}
_registry: dict[str, BackendStorage] = {}
_lock = threading.Lock()


def register_backend(storage: BackendStorage) -> None:
    with _lock:
        _registry[storage.name] = storage


def get_backend(backend_type: str, backend_id: str = "default") -> BackendStorage:
    with _lock:
        b = _registry.get(f"{backend_type}.{backend_id}")
    if b is None:
        raise KeyError(f"storage backend {backend_type}.{backend_id} not configured")
    return b


def configure(cfg: dict) -> None:
    """[storage.backend] config section (backend.go LoadConfiguration):

      {"local.default": {"type": "local", "dir": "/tier"}}

    An "s3" section raises ValueError: the port has no S3 client yet
    (ROADMAP A10)."""
    for name, section in cfg.items():
        btype, _, bid = name.partition(".")
        kind = section.get("type", btype)
        if kind == "s3":
            raise ValueError(
                f"storage backend {name!r}: the s3 type waits for the "
                "port's S3 client (ROADMAP A10)")
        cls = _BACKEND_TYPES.get(kind)
        if cls is None:
            raise ValueError(f"unknown backend type in {name!r}")
        register_backend(cls(bid or "default", section["dir"]))


def clear_registry() -> None:
    with _lock:
        _registry.clear()


def backend_from_spec(spec: str, load_config: bool = True) -> tuple[BackendStorage, str]:
    """'<type.id>[/keyPrefix]' -> (storage, key_prefix), loading master.toml
    [storage.backend] sections on demand."""
    if load_config:
        from ..utils import config as config_util

        cfg = config_util.storage_backends()
        if cfg:
            configure(cfg)
    name, _, prefix = spec.partition("/")
    btype, _, bid = name.partition(".")
    return get_backend(btype, bid or "default"), prefix.strip("/")


class RemoteDat:
    """File-object stand-in for a tiered volume's .dat: ranged reads from
    a backend, no write surface (backend.go BackendStorageFile)."""

    def __init__(self, storage: BackendStorage, key: str, size: int):
        self.storage = storage
        self.key = key
        self._size = size
        self.closed = False

    def pread(self, size: int, offset: int) -> bytes:
        return self.storage.pread(self.key, size, offset)

    def size(self) -> int:
        return self._size

    def flush(self) -> None:
        pass

    def close(self) -> None:
        self.closed = True
