"""FilerStore plugin API + the two embedded stores.

Reference: weed/filer/filerstore.go:21-44 (the interface), the sqlite
adapter (weed/filer/sqlite + abstract_sql), and the in-memory shape of
leveldb2.  The reference ships 27 adapters; the plugin surface here is the
same, so more can be slotted in, but an embedded sqlite store (durable,
transactional, zero-dependency) plus a dict-backed memory store cover the
single-node and test cases.

Stores are synchronous; the Filer/FilerServer call them via
asyncio.to_thread when on the event loop.

A copy of seaweedfs_tpu/filer/filerstore.py; it imports nothing of that
package. Its NativeKvStore runs over the port's storage/kvstore.py
(csrc/host/kvstore.cpp, built with g++ at first use).
"""
from __future__ import annotations

import sqlite3
import threading
from bisect import bisect_left

from .entry import Entry, new_full_path


class NotFoundError(KeyError):
    pass


def _children_add(names: list[str], name: str) -> None:
    """Insert into a sorted child-name list if absent."""
    i = bisect_left(names, name)
    if i >= len(names) or names[i] != name:
        names.insert(i, name)


def _children_discard(names: list[str], name: str) -> None:
    i = bisect_left(names, name)
    if i < len(names) and names[i] == name:
        names.pop(i)


def _children_page(
    names: list[str], start_file_name: str, include_start: bool,
    prefix: str, limit: int,
) -> list[str]:
    """One listing page over a sorted child-name list — the pagination
    rules live ONCE for every store that keeps a sorted children index."""
    i = bisect_left(names, start_file_name) if start_file_name else 0
    out: list[str] = []
    for name in names[i:]:
        if name == start_file_name and not include_start:
            continue
        if prefix and not name.startswith(prefix):
            continue
        out.append(name)
        if len(out) >= limit:
            break
    return out


class FilerStore:
    """Abstract store: path → serialized Entry + a kv sideband."""

    name = "abstract"

    def insert_entry(self, entry: Entry) -> None:
        raise NotImplementedError

    def update_entry(self, entry: Entry) -> None:
        raise NotImplementedError

    def find_entry(self, full_path: str) -> Entry:
        raise NotImplementedError

    def delete_entry(self, full_path: str) -> None:
        raise NotImplementedError

    def delete_folder_children(self, full_path: str) -> None:
        raise NotImplementedError

    def list_directory_entries(
        self,
        dir_path: str,
        start_file_name: str = "",
        include_start: bool = False,
        limit: int = 1 << 30,
        prefix: str = "",
    ) -> list[Entry]:
        raise NotImplementedError

    def kv_put(self, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def kv_get(self, key: bytes) -> bytes:
        raise NotImplementedError

    def kv_delete(self, key: bytes) -> None:
        raise NotImplementedError

    # transactions are no-ops unless the backend supports them
    def begin_transaction(self) -> None:
        pass

    def commit_transaction(self) -> None:
        pass

    def rollback_transaction(self) -> None:
        pass

    def shutdown(self) -> None:
        pass


class MemoryStore(FilerStore):
    """Dict-backed store: dir → sorted child-name list, path → Entry."""

    name = "memory"

    def __init__(self):
        self._entries: dict[str, Entry] = {}
        self._children: dict[str, list[str]] = {}
        self._kv: dict[bytes, bytes] = {}
        self._lock = threading.RLock()

    def insert_entry(self, entry: Entry) -> None:
        with self._lock:
            existed = entry.full_path in self._entries
            self._entries[entry.full_path] = entry
            if not existed:
                _children_add(
                    self._children.setdefault(entry.directory, []),
                    entry.name,
                )

    update_entry = insert_entry

    def find_entry(self, full_path: str) -> Entry:
        with self._lock:
            e = self._entries.get(full_path)
            if e is None:
                raise NotFoundError(full_path)
            return e

    def delete_entry(self, full_path: str) -> None:
        with self._lock:
            e = self._entries.pop(full_path, None)
            if e is not None:
                _children_discard(self._children.get(e.directory, []), e.name)

    def delete_folder_children(self, full_path: str) -> None:
        with self._lock:
            for name in list(self._children.get(full_path, [])):
                self.delete_entry(new_full_path(full_path, name))

    def list_directory_entries(
        self, dir_path, start_file_name="", include_start=False, limit=1 << 30, prefix=""
    ):
        with self._lock:
            names = self._children.get(dir_path.rstrip("/") or "/", [])
            page = _children_page(
                names, start_file_name, include_start, prefix, limit
            )
            return [
                self._entries[new_full_path(dir_path, name)] for name in page
            ]

    def kv_put(self, key, value):
        self._kv[bytes(key)] = bytes(value)

    def kv_get(self, key):
        v = self._kv.get(bytes(key))
        if v is None:
            raise NotFoundError(key)
        return v

    def kv_delete(self, key):
        self._kv.pop(bytes(key), None)


class SqlDialect:
    """One SQL engine's connection + statement text, the thin object the
    generic tier parameterizes over (reference
    weed/filer/abstract_sql/abstract_sql_store.go SqlGenerator + the
    mysql/postgres2/sqlite dialect packages).  A new engine is a subclass
    overriding `connect()` and whichever statements its SQL flavor spells
    differently — the store logic itself is never touched."""

    name = "generic-sql"

    create_tables = (
        "CREATE TABLE IF NOT EXISTS filemeta ("
        " directory TEXT NOT NULL, name TEXT NOT NULL, meta BLOB,"
        " PRIMARY KEY (directory, name))",
        "CREATE TABLE IF NOT EXISTS kv (k BLOB PRIMARY KEY, v BLOB)",
    )
    upsert_entry = (
        "INSERT OR REPLACE INTO filemeta (directory, name, meta)"
        " VALUES (?,?,?)"
    )
    find_entry = "SELECT meta FROM filemeta WHERE directory=? AND name=?"
    delete_entry = "DELETE FROM filemeta WHERE directory=? AND name=?"
    delete_children = "DELETE FROM filemeta WHERE directory=?"
    # {op} becomes > / >= for exclusive/inclusive pagination
    list_entries = (
        "SELECT name, meta FROM filemeta WHERE directory=? AND name {op} ?"
    )
    list_prefix_clause = " AND name GLOB ?"
    list_tail = " ORDER BY name LIMIT ?"
    kv_upsert = "INSERT OR REPLACE INTO kv (k, v) VALUES (?,?)"
    kv_find = "SELECT v FROM kv WHERE k=?"
    kv_delete_sql = "DELETE FROM kv WHERE k=?"
    begin = "BEGIN"

    def connect(self):  # pragma: no cover - interface
        raise NotImplementedError

    def prefix_argument(self, prefix: str) -> str:
        """The bind value for list_prefix_clause."""
        return (
            prefix.replace("[", "[[]").replace("*", "[*]").replace("?", "[?]")
            + "*"
        )


class SqliteDialect(SqlDialect):
    """The embedded engine (reference weed/filer/sqlite)."""

    name = "sqlite"

    def __init__(self, path: str = ":memory:"):
        self.path = path

    def connect(self):
        c = sqlite3.connect(self.path, timeout=30.0, isolation_level=None)
        c.execute("PRAGMA journal_mode=WAL")
        c.execute("PRAGMA synchronous=NORMAL")
        return c


class OnConflictSqliteDialect(SqliteDialect):
    """The ANSI/postgres statement flavor (ON CONFLICT upserts, LIKE with
    ESCAPE instead of GLOB — the text weed/filer/postgres2 generates),
    run on the sqlite engine since that's what this image ships.  Exists
    to prove the abstract tier's claim: a second dialect is a screenful
    of statement text, not a store rewrite."""

    name = "sqlite-onconflict"

    upsert_entry = (
        "INSERT INTO filemeta (directory, name, meta) VALUES (?,?,?)"
        " ON CONFLICT (directory, name) DO UPDATE SET meta=excluded.meta"
    )
    kv_upsert = (
        "INSERT INTO kv (k, v) VALUES (?,?)"
        " ON CONFLICT (k) DO UPDATE SET v=excluded.v"
    )
    list_prefix_clause = r" AND name LIKE ? ESCAPE '\'"

    def connect(self):
        c = super().connect()
        # sqlite's LIKE is ASCII case-insensitive by default; filer/S3
        # prefix listing semantics are case-SENSITIVE
        c.execute("PRAGMA case_sensitive_like=ON")
        return c

    def prefix_argument(self, prefix: str) -> str:
        escaped = (
            prefix.replace("\\", "\\\\")
            .replace("%", r"\%")
            .replace("_", r"\_")
        )
        return escaped + "%"


class AbstractSqlStore(FilerStore):
    """The generic SQL tier: every FilerStore operation in terms of a
    SqlDialect's statements, with per-thread connections (stores are
    called from asyncio.to_thread workers) and engine transactions.
    Reference: weed/filer/abstract_sql/abstract_sql_store.go:1-90."""

    def __init__(self, dialect: SqlDialect):
        self.dialect = dialect
        self.name = dialect.name
        self._local = threading.local()
        self._conns: list = []
        self._conns_lock = threading.Lock()
        c = self._conn()
        for stmt in dialect.create_tables:
            c.execute(stmt)

    def _conn(self):
        c = getattr(self._local, "conn", None)
        if c is None:
            c = self.dialect.connect()
            self._local.conn = c
            with self._conns_lock:
                self._conns.append(c)
        return c

    def insert_entry(self, entry: Entry) -> None:
        self._conn().execute(
            self.dialect.upsert_entry,
            (entry.directory, entry.name, entry.encode()),
        )

    update_entry = insert_entry

    def find_entry(self, full_path: str) -> Entry:
        from .entry import dir_and_name

        d, n = dir_and_name(full_path)
        row = self._conn().execute(self.dialect.find_entry, (d, n)).fetchone()
        if row is None:
            raise NotFoundError(full_path)
        return Entry.decode(full_path, row[0])

    def delete_entry(self, full_path: str) -> None:
        from .entry import dir_and_name

        d, n = dir_and_name(full_path)
        self._conn().execute(self.dialect.delete_entry, (d, n))

    def delete_folder_children(self, full_path: str) -> None:
        self._conn().execute(
            self.dialect.delete_children, (full_path.rstrip("/") or "/",)
        )

    def list_directory_entries(
        self, dir_path, start_file_name="", include_start=False, limit=1 << 30, prefix=""
    ):
        dir_path = dir_path.rstrip("/") or "/"
        sql = self.dialect.list_entries.format(
            op=">=" if include_start else ">"
        )
        args: list = [dir_path, start_file_name]
        if prefix:
            sql += self.dialect.list_prefix_clause
            args.append(self.dialect.prefix_argument(prefix))
        sql += self.dialect.list_tail
        args.append(limit)
        return [
            Entry.decode(new_full_path(dir_path, name), meta)
            for name, meta in self._conn().execute(sql, args)
        ]

    def kv_put(self, key, value):
        self._conn().execute(
            self.dialect.kv_upsert, (bytes(key), bytes(value))
        )

    def kv_get(self, key):
        row = self._conn().execute(
            self.dialect.kv_find, (bytes(key),)
        ).fetchone()
        if row is None:
            raise NotFoundError(key)
        return row[0]

    def kv_delete(self, key):
        self._conn().execute(self.dialect.kv_delete_sql, (bytes(key),))

    def begin_transaction(self):
        self._conn().execute(self.dialect.begin)

    def commit_transaction(self):
        self._conn().execute("COMMIT")

    def rollback_transaction(self):
        self._conn().execute("ROLLBACK")

    def shutdown(self):
        import logging

        with self._conns_lock:
            for c in self._conns:
                try:
                    c.close()
                except Exception as e:  # noqa: BLE001
                    logging.getLogger("filer").debug(
                        "sqlite connection close failed at shutdown: %s", e
                    )
            self._conns.clear()


class SqliteStore(AbstractSqlStore):
    """Durable embedded store on sqlite3 — AbstractSqlStore with the
    sqlite dialect (the reference's weed/filer/sqlite is likewise a thin
    dialect over abstract_sql)."""

    def __init__(self, path: str = ":memory:"):
        super().__init__(SqliteDialect(path))
        self._path = path


class NativeKvStore(FilerStore):
    """Durable embedded store on the native C++ KV (native/kvstore.cpp —
    the role leveldb plays as the reference's default filer store,
    weed/filer/leveldb2).  Records: b'E'+full_path -> Entry bytes,
    b'K'+key -> kv sideband.  The bitcask index is a hash (no ordered
    scans), so directory ordering lives in an in-memory sorted-children
    map seeded by one startup iteration — bounded by namespace size, the
    same RAM class the reference's leveldb block cache spends."""

    name = "native"

    def __init__(self, path: str):
        from ..storage.kvstore import NativeKv

        self._kv_store = NativeKv(path)
        self._children: dict[str, list[str]] = {}
        self._lock = threading.RLock()
        from .entry import dir_and_name

        for k in self._kv_store.keys():  # keys only: no value copies
            if not k.startswith(b"E"):
                continue
            full_path = k[1:].decode()
            d, n = dir_and_name(full_path)
            _children_add(self._children.setdefault(d, []), n)

    def insert_entry(self, entry: Entry) -> None:
        with self._lock:
            self._kv_store.put(
                b"E" + entry.full_path.encode(), entry.encode()
            )
            _children_add(
                self._children.setdefault(entry.directory, []), entry.name
            )

    update_entry = insert_entry

    def find_entry(self, full_path: str) -> Entry:
        with self._lock:
            blob = self._kv_store.get(b"E" + full_path.encode())
        if blob is None:
            raise NotFoundError(full_path)
        return Entry.decode(full_path, blob)

    def delete_entry(self, full_path: str) -> None:
        from .entry import dir_and_name

        with self._lock:
            self._kv_store.delete(b"E" + full_path.encode())
            d, n = dir_and_name(full_path)
            _children_discard(self._children.get(d, []), n)

    def delete_folder_children(self, full_path: str) -> None:
        with self._lock:
            d = full_path.rstrip("/") or "/"
            for name in list(self._children.get(d, [])):
                self.delete_entry(new_full_path(d, name))

    def list_directory_entries(
        self, dir_path, start_file_name="", include_start=False, limit=1 << 30, prefix=""
    ):
        with self._lock:
            d = dir_path.rstrip("/") or "/"
            page = _children_page(
                self._children.get(d, []), start_file_name, include_start,
                prefix, limit,
            )
            out = []
            for name in page:
                blob = self._kv_store.get(
                    b"E" + new_full_path(d, name).encode()
                )
                if blob is not None:
                    out.append(Entry.decode(new_full_path(d, name), blob))
            return out

    def kv_put(self, key, value):
        self._kv_store.put(b"K" + bytes(key), bytes(value))

    def kv_get(self, key):
        v = self._kv_store.get(b"K" + bytes(key))
        if v is None:
            raise NotFoundError(key)
        return v

    def kv_delete(self, key):
        self._kv_store.delete(b"K" + bytes(key))

    def compact(self) -> int:
        """Reclaim superseded log records (exposed for ops tooling)."""
        with self._lock:
            return self._kv_store.compact()

    def shutdown(self):
        self._kv_store.close()
