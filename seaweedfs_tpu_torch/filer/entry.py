"""Filer namespace entry model.

Reference: weed/filer/entry.go:32-46 (Entry{FullPath, Attr, Chunks,
Extended, HardLinkId, Content}), entry_codec.go (proto round-trip).
Chunks are kept as filer_pb2.FileChunk protos throughout — they cross the
wire constantly and converting at every boundary would only add copies.

A copy of seaweedfs_tpu/filer/entry.py; it imports nothing of that
package.
"""
from __future__ import annotations

import os.path
import time
from dataclasses import dataclass, field

from ..pb import filer_pb2

MODE_DIR = 0o20000000000  # os.ModeDir bit as the Go reference encodes it


def new_full_path(directory: str, name: str) -> str:
    if directory.endswith("/"):
        return directory + name if name else directory.rstrip("/") or "/"
    return f"{directory}/{name}" if name else directory


def dir_and_name(full_path: str) -> tuple[str, str]:
    full_path = full_path.rstrip("/") or "/"
    if full_path == "/":
        return "/", ""
    d, n = os.path.split(full_path)
    return d or "/", n


@dataclass
class Attr:
    mtime: int = 0  # unix seconds
    crtime: int = 0
    mode: int = 0o660
    uid: int = 0
    gid: int = 0
    mime: str = ""
    ttl_sec: int = 0
    user_name: str = ""
    group_names: list[str] = field(default_factory=list)
    symlink_target: str = ""
    md5: bytes = b""
    file_size: int = 0
    rdev: int = 0
    inode: int = 0

    @property
    def is_directory(self) -> bool:
        return bool(self.mode & MODE_DIR)


@dataclass
class Entry:
    full_path: str
    attr: Attr = field(default_factory=Attr)
    extended: dict[str, bytes] = field(default_factory=dict)
    chunks: list = field(default_factory=list)  # filer_pb2.FileChunk
    hard_link_id: bytes = b""
    hard_link_counter: int = 0
    content: bytes = b""  # small files inlined in metadata

    @property
    def name(self) -> str:
        return dir_and_name(self.full_path)[1]

    @property
    def directory(self) -> str:
        return dir_and_name(self.full_path)[0]

    @property
    def is_directory(self) -> bool:
        return self.attr.is_directory

    def size(self) -> int:
        from .filechunks import total_size

        return max(total_size(self.chunks), self.attr.file_size, len(self.content))

    # ------------------------------------------------------------ proto codec

    def to_pb(self) -> filer_pb2.Entry:
        a = self.attr
        return filer_pb2.Entry(
            name=self.name,
            is_directory=self.is_directory,
            chunks=self.chunks,
            attributes=filer_pb2.FuseAttributes(
                file_size=self.size(),
                mtime=a.mtime,
                file_mode=a.mode,
                uid=a.uid,
                gid=a.gid,
                crtime=a.crtime,
                mime=a.mime,
                ttl_sec=a.ttl_sec,
                user_name=a.user_name,
                group_names=a.group_names,
                symlink_target=a.symlink_target,
                md5=a.md5,
                rdev=a.rdev,
                inode=a.inode,
            ),
            extended=self.extended,
            hard_link_id=self.hard_link_id,
            hard_link_counter=self.hard_link_counter,
            content=self.content,
        )

    @classmethod
    def from_pb(cls, directory: str, msg: filer_pb2.Entry) -> "Entry":
        a = msg.attributes
        attr = Attr(
            mtime=a.mtime,
            crtime=a.crtime,
            mode=a.file_mode | (MODE_DIR if msg.is_directory else 0),
            uid=a.uid,
            gid=a.gid,
            mime=a.mime,
            ttl_sec=a.ttl_sec,
            user_name=a.user_name,
            group_names=list(a.group_names),
            symlink_target=a.symlink_target,
            md5=bytes(a.md5),
            file_size=a.file_size,
            rdev=a.rdev,
            inode=a.inode,
        )
        return cls(
            full_path=new_full_path(directory, msg.name),
            attr=attr,
            extended=dict(msg.extended),
            chunks=list(msg.chunks),
            hard_link_id=bytes(msg.hard_link_id),
            hard_link_counter=msg.hard_link_counter,
            content=bytes(msg.content),
        )

    def encode(self) -> bytes:
        """Serialized form stored in the FilerStore (entry_codec.go)."""
        return self.to_pb().SerializeToString()

    @classmethod
    def decode(cls, full_path: str, blob: bytes) -> "Entry":
        msg = filer_pb2.Entry.FromString(blob)
        d, n = dir_and_name(full_path)
        msg.name = n
        return cls.from_pb(d, msg)


def new_dir_entry(full_path: str, mode: int = 0o770) -> Entry:
    now = int(time.time())
    return Entry(
        full_path=full_path,
        attr=Attr(mtime=now, crtime=now, mode=mode | MODE_DIR),
    )
