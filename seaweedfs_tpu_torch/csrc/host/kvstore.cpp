// Embedded log-structured KV store (bitcask design).
//
// The reference's persistent needle maps and default filer store sit on
// leveldb (weed/storage/needle_map_leveldb.go, filer/leveldb) — a native
// LSM the Go binary links.  This is the counterpart (a copy of the JAX
// package's native/kvstore.cpp), purpose-built for the same workloads
// instead of general LSM machinery:
//
//   * append-only data log of (klen, vlen, key, value) records; a delete
//     is a record with vlen == TOMBSTONE
//   * in-memory open-addressing hash index: key-hash -> (file offset),
//     rebuilt by a sequential log replay on open (the log IS the
//     checkpoint; no WAL-vs-SST split to keep consistent)
//   * compaction rewrites live records to <path>.compact and atomically
//     renames — crash-safe at every step
//
// Both workloads have small keys (needle ids are 8 bytes; filer paths a
// few dozen) and point lookups only, so a hash index beats a sorted
// structure: O(1) gets, no comparisons, and the needle-map scan API is a
// plain log walk.  Exposed flat for ctypes (storage/kvstore.py).
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <unistd.h>
#include <vector>

namespace {

constexpr uint32_t TOMBSTONE = 0xFFFFFFFFu;

// 64-bit FNV-1a: tiny keys, no need for anything fancier.
static inline uint64_t hash_key(const uint8_t* k, uint32_t n) {
  uint64_t h = 1469598103934665603ull;
  for (uint32_t i = 0; i < n; i++) {
    h ^= k[i];
    h *= 1099511628211ull;
  }
  return h;
}

struct Slot {
  uint64_t hash;
  uint64_t offset;  // record offset in the log; 0 = empty (offset 0 is
                    // the 8-byte magic header, never a record)
};

struct Store {
  std::string path;
  FILE* log = nullptr;
  uint64_t log_end = 0;
  std::vector<Slot> table;  // open addressing, linear probing
  uint64_t live = 0;        // live (non-tombstone) keys
  uint64_t occupied = 0;    // table slots in use, INCLUDING tombstones —
                            // growth must gate on this or a delete-heavy
                            // workload fills the table and probes spin
  uint64_t dead_bytes = 0;  // reclaimable record bytes

  uint64_t mask() const { return table.size() - 1; }
};

constexpr char MAGIC[8] = {'S', 'W', 'K', 'V', '0', '0', '0', '1'};

static bool read_exact(FILE* f, void* buf, size_t n) {
  return fread(buf, 1, n, f) == n;
}

static bool record_key_at(Store* s, uint64_t off, std::string* key,
                          uint32_t* vlen, uint64_t* voff) {
  if (fseeko(s->log, (off_t)off, SEEK_SET) != 0) return false;
  uint32_t kl, vl;
  if (!read_exact(s->log, &kl, 4) || !read_exact(s->log, &vl, 4)) return false;
  key->resize(kl);
  if (kl && !read_exact(s->log, key->data(), kl)) return false;
  *vlen = vl;
  *voff = off + 8 + kl;
  return true;
}

static void index_insert(Store* s, uint64_t h, uint64_t off);

static void grow_table(Store* s) {
  std::vector<Slot> old;
  old.swap(s->table);
  s->table.assign(old.size() * 2, Slot{0, 0});
  s->occupied = 0;
  for (const Slot& sl : old)
    if (sl.offset) index_insert(s, sl.hash, sl.offset);
}

static void index_insert(Store* s, uint64_t h, uint64_t off) {
  uint64_t i = h & s->mask();
  while (s->table[i].offset) i = (i + 1) & s->mask();
  s->table[i] = Slot{h, off};
  s->occupied++;
}

static void maybe_grow(Store* s) {
  if (s->occupied * 2 >= s->table.size()) grow_table(s);
}

// Find the slot holding `key` (exact compare via the log); SIZE_MAX if
// absent.
static uint64_t index_find(Store* s, const uint8_t* key, uint32_t klen) {
  uint64_t h = hash_key(key, klen);
  uint64_t i = h & s->mask();
  std::string k;
  while (s->table[i].offset) {
    if (s->table[i].hash == h) {
      uint32_t vl;
      uint64_t voff;
      if (record_key_at(s, s->table[i].offset, &k, &vl, &voff) &&
          k.size() == klen && memcmp(k.data(), key, klen) == 0)
        return i;
    }
    i = (i + 1) & s->mask();
  }
  return UINT64_MAX;
}

static bool append_record(Store* s, const uint8_t* key, uint32_t klen,
                          const uint8_t* val, uint32_t vlen,
                          uint64_t* rec_off) {
  if (fseeko(s->log, 0, SEEK_END) != 0) return false;
  *rec_off = s->log_end;
  if (fwrite(&klen, 1, 4, s->log) != 4) return false;
  if (fwrite(&vlen, 1, 4, s->log) != 4) return false;
  if (klen && fwrite(key, 1, klen, s->log) != klen) return false;
  uint32_t data_len = vlen == TOMBSTONE ? 0 : vlen;
  if (data_len && fwrite(val, 1, data_len, s->log) != data_len) return false;
  s->log_end += 8 + klen + data_len;
  return true;
}

static bool replay(Store* s) {
  // Sequential scan; truncate a torn tail (crash mid-append) instead of
  // failing the open.
  if (fseeko(s->log, 0, SEEK_END) != 0) return false;
  const uint64_t fsize = (uint64_t)ftello(s->log);
  uint64_t off = sizeof(MAGIC);
  if (fseeko(s->log, (off_t)off, SEEK_SET) != 0) return false;
  std::string key;
  std::vector<uint8_t> kbuf;
  for (;;) {
    uint32_t kl, vl;
    if (!read_exact(s->log, &kl, 4)) break;
    if (!read_exact(s->log, &vl, 4)) break;
    uint32_t data_len = vl == TOMBSTONE ? 0 : vl;
    // bound the WHOLE record against the real file size first: seeking
    // past EOF "succeeds", so a half-written value would otherwise be
    // indexed and the truncate below would zero-extend it
    uint64_t end = off + 8 + kl + data_len;
    if (end > fsize) break;
    kbuf.resize(kl);
    if (kl && !read_exact(s->log, kbuf.data(), kl)) break;
    if (data_len && fseeko(s->log, (off_t)data_len, SEEK_CUR) != 0) break;

    uint64_t h = hash_key(kbuf.data(), kl);
    uint64_t slot = index_find(s, kbuf.data(), kl);
    if (slot != UINT64_MAX) {
      // supersedes an earlier record of the same key
      std::string old_key;
      uint32_t old_vl = TOMBSTONE;
      uint64_t old_voff;
      record_key_at(s, s->table[slot].offset, &old_key, &old_vl, &old_voff);
      if (old_vl != TOMBSTONE) {
        // a superseded tombstone was already charged when written
        s->dead_bytes += 8 + old_key.size() + old_vl;
        s->live--;
      }
      s->table[slot].offset = off;
      if (vl == TOMBSTONE)
        s->dead_bytes += 8 + kl;  // the tombstone itself is reclaimable
      else
        s->live++;
    } else if (vl != TOMBSTONE) {
      maybe_grow(s);
      index_insert(s, h, off);
      s->live++;
    } else {
      s->dead_bytes += 8 + kl;  // tombstone for an absent key
    }
    off = end;
    if (fseeko(s->log, (off_t)off, SEEK_SET) != 0) break;
  }
  s->log_end = off;
  // drop any torn tail so the next append starts at a record boundary
  fflush(s->log);
  if (truncate(s->path.c_str(), (off_t)off) != 0) return false;
  return fseeko(s->log, 0, SEEK_END) == 0;
}

}  // namespace

extern "C" {

void* kv_open(const char* path) {
  Store* s = new Store();
  s->path = path;
  FILE* f = fopen(path, "r+b");
  bool fresh = false;
  if (!f) {
    f = fopen(path, "w+b");
    fresh = true;
  }
  if (!f) {
    delete s;
    return nullptr;
  }
  s->log = f;
  s->table.assign(1024, Slot{0, 0});
  if (!fresh) {
    // a file shorter than the header means a crash between create and
    // the magic flush — treat as fresh rather than bricking the store
    fseeko(f, 0, SEEK_END);
    if ((uint64_t)ftello(f) < sizeof(MAGIC)) {
      fresh = true;
      fseeko(f, 0, SEEK_SET);
    } else {
      fseeko(f, 0, SEEK_SET);
    }
  }
  if (fresh) {
    fwrite(MAGIC, 1, sizeof(MAGIC), f);
    fflush(f);
    s->log_end = sizeof(MAGIC);
  } else {
    char magic[8];
    if (!read_exact(f, magic, 8) || memcmp(magic, MAGIC, 8) != 0) {
      fclose(f);
      delete s;
      return nullptr;
    }
    if (!replay(s)) {
      fclose(f);
      delete s;
      return nullptr;
    }
  }
  return s;
}

int kv_put(void* h, const uint8_t* key, uint32_t klen, const uint8_t* val,
           uint32_t vlen) {
  Store* s = (Store*)h;
  if (vlen >= TOMBSTONE) return -1;
  uint64_t slot = index_find(s, key, klen);
  uint64_t off;
  if (!append_record(s, key, klen, val, vlen, &off)) return -1;
  if (slot != UINT64_MAX) {
    std::string old_key;
    uint32_t old_vl = TOMBSTONE;
    uint64_t old_voff;
    record_key_at(s, s->table[slot].offset, &old_key, &old_vl, &old_voff);
    if (old_vl != TOMBSTONE)
      s->dead_bytes += 8 + klen + old_vl;  // tombstones were pre-charged
    else
      s->live++;
    s->table[slot].offset = off;
  } else {
    maybe_grow(s);
    index_insert(s, hash_key(key, klen), off);
    s->live++;
  }
  return 0;
}

// -> value length, copied into out (capacity out_cap); -1 absent,
// -2 out too small (call again with a bigger buffer).
int64_t kv_get(void* h, const uint8_t* key, uint32_t klen, uint8_t* out,
               uint64_t out_cap) {
  Store* s = (Store*)h;
  uint64_t slot = index_find(s, key, klen);
  if (slot == UINT64_MAX) return -1;
  std::string k;
  uint32_t vl;
  uint64_t voff;
  if (!record_key_at(s, s->table[slot].offset, &k, &vl, &voff)) return -1;
  if (vl == TOMBSTONE) return -1;
  if (vl > out_cap) return -2;
  if (fseeko(s->log, (off_t)voff, SEEK_SET) != 0) return -1;
  if (vl && !read_exact(s->log, out, vl)) return -1;
  return (int64_t)vl;
}

int kv_delete(void* h, const uint8_t* key, uint32_t klen) {
  Store* s = (Store*)h;
  uint64_t slot = index_find(s, key, klen);
  if (slot == UINT64_MAX) return -1;
  std::string k;
  uint32_t vl;
  uint64_t voff;
  if (!record_key_at(s, s->table[slot].offset, &k, &vl, &voff)) return -1;
  if (vl == TOMBSTONE) return -1;
  uint64_t off;
  if (!append_record(s, key, klen, nullptr, TOMBSTONE, &off)) return -1;
  s->dead_bytes += (8 + klen + vl) + (8 + klen);  // old record + tombstone
  s->table[slot].offset = off;
  s->live--;
  return 0;
}

uint64_t kv_count(void* h) { return ((Store*)h)->live; }

uint64_t kv_dead_bytes(void* h) { return ((Store*)h)->dead_bytes; }

int kv_flush(void* h) {
  Store* s = (Store*)h;
  return fflush(s->log) == 0 ? 0 : -1;
}

// Iterate live records: cb(key, klen, val, vlen, ctx); stops early if cb
// returns nonzero.  Walks the INDEX (not the log) so superseded records
// never surface.
typedef int (*kv_iter_cb)(const uint8_t*, uint32_t, const uint8_t*, uint32_t,
                          void*);
int kv_iterate(void* h, kv_iter_cb cb, void* ctx) {
  Store* s = (Store*)h;
  std::string k;
  std::vector<uint8_t> v;
  for (const Slot& sl : s->table) {
    if (!sl.offset) continue;
    uint32_t vl;
    uint64_t voff;
    if (!record_key_at(s, sl.offset, &k, &vl, &voff)) return -1;
    if (vl == TOMBSTONE) continue;
    v.resize(vl);
    if (fseeko(s->log, (off_t)voff, SEEK_SET) != 0) return -1;
    if (vl && !read_exact(s->log, v.data(), vl)) return -1;
    int rc = cb((const uint8_t*)k.data(), (uint32_t)k.size(), v.data(), vl,
                ctx);
    if (rc) return rc;
  }
  return 0;
}

// Iterate live KEYS only: cb(key, klen, nullptr, 0, ctx) — no value
// copies (startup seeding of namespace indexes).
int kv_iterate_keys(void* h, kv_iter_cb cb, void* ctx) {
  Store* s = (Store*)h;
  std::string k;
  for (const Slot& sl : s->table) {
    if (!sl.offset) continue;
    uint32_t vl;
    uint64_t voff;
    if (!record_key_at(s, sl.offset, &k, &vl, &voff)) return -1;
    if (vl == TOMBSTONE) continue;
    int rc = cb((const uint8_t*)k.data(), (uint32_t)k.size(), nullptr, 0,
                ctx);
    if (rc) return rc;
  }
  return 0;
}

// Rewrite live records to <path>.compact and atomically swap.  Returns
// reclaimed bytes, or -1.
int64_t kv_compact(void* h) {
  Store* s = (Store*)h;
  std::string tmp_path = s->path + ".compact";
  FILE* out = fopen(tmp_path.c_str(), "w+b");
  if (!out) return -1;
  fwrite(MAGIC, 1, sizeof(MAGIC), out);
  uint64_t before = s->log_end;
  std::string k;
  std::vector<uint8_t> v;
  // survivors rebuilt into a FRESH table: dropping tombstone slots in
  // place would break open-addressing probe chains
  std::vector<Slot> survivors;
  uint64_t new_end = sizeof(MAGIC);
  for (const Slot& sl : s->table) {
    if (!sl.offset) continue;
    uint32_t vl;
    uint64_t voff;
    if (!record_key_at(s, sl.offset, &k, &vl, &voff)) goto fail;
    if (vl == TOMBSTONE) continue;
    v.resize(vl);
    if (fseeko(s->log, (off_t)voff, SEEK_SET) != 0) goto fail;
    if (vl && !read_exact(s->log, v.data(), vl)) goto fail;
    {
      uint32_t kl = (uint32_t)k.size();
      if (fwrite(&kl, 1, 4, out) != 4 || fwrite(&vl, 1, 4, out) != 4)
        goto fail;
      if (kl && fwrite(k.data(), 1, kl, out) != kl) goto fail;
      if (vl && fwrite(v.data(), 1, vl, out) != vl) goto fail;
      survivors.push_back(Slot{sl.hash, new_end});
      new_end += 8 + kl + vl;
    }
  }
  if (fflush(out) != 0) goto fail;
  {
    // swap on disk FIRST; the old s->log handle stays valid (its inode
    // lives until close) so any failure leaves the store fully usable
    FILE* nf = fopen(tmp_path.c_str(), "r+b");
    if (!nf) goto fail;
    if (rename(tmp_path.c_str(), s->path.c_str()) != 0) {
      fclose(nf);
      goto fail;
    }
    fclose(out);
    fclose(s->log);
    s->log = nf;
  }
  fseeko(s->log, 0, SEEK_END);
  s->log_end = new_end;
  s->dead_bytes = 0;
  s->table.assign(s->table.size(), Slot{0, 0});
  s->occupied = 0;
  for (const Slot& sl : survivors) index_insert(s, sl.hash, sl.offset);
  return (int64_t)(before - new_end);
fail:
  fclose(out);
  remove(tmp_path.c_str());
  return -1;
}

void kv_close(void* h) {
  Store* s = (Store*)h;
  if (s->log) {
    fflush(s->log);
    fclose(s->log);
  }
  delete s;
}

}  // extern "C"
