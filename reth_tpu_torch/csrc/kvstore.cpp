// reth-tpu native KV storage engine.
//
// Reference analogue: libmdbx (crates/storage/libmdbx-rs/mdbx-sys/libmdbx,
// 37.7k LoC C) — the reference's embedded B+tree store. This engine keeps
// the same contract surface the framework's Database/Tx/Cursor interface
// needs: named tables sorted by key, DUPSORT duplicate lists sorted by
// value, single-writer transactions with MVCC snapshot isolation for
// readers (clone-on-write tables published by one atomic map swap, as
// MDBX does via shadow paging), ordered cursors pinned to their txn view,
// and a write-ahead log + snapshot compaction. Durability scope: commits
// fflush (process-crash-safe; recovery = snapshot + WAL replay of complete
// committed batches); call rtkv_sync for power-loss durability (fsync).
//
// Build: g++ -O2 -std=c++17 -shared -fPIC kvstore.cpp -o libkvstore.so

#include <unistd.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

using Key = std::string;
using Dups = std::vector<std::string>;  // sorted; non-dup tables: size()==1
using Table = std::map<Key, Dups>;

struct Env;

// -- WAL record layout --------------------------------------------------------
// u8 op | u32 table_len | table | u32 key_len | key | u32 val_len | val
// ops: 1=put 2=put_dup 3=del_key 4=del_dup 5=clear_table 6=commit_mark
enum WalOp : uint8_t {
  WAL_PUT = 1,
  WAL_PUT_DUP = 2,
  WAL_DEL_KEY = 3,
  WAL_DEL_DUP = 4,
  WAL_CLEAR = 5,
  WAL_COMMIT = 6,
};

// MVCC: the published table map holds IMMUTABLE tables behind shared_ptr.
// A txn captures the map at begin (its snapshot); a writer clones a table
// on first touch into its private `own` set and publishes all clones with
// one map swap at commit — readers keep their captured pointers for their
// whole lifetime, exactly the reader isolation MDBX gives the reference
// via shadow paging. One writer at a time (writer_mu).
using TableRef = std::shared_ptr<const Table>;

struct Env {
  std::map<std::string, TableRef> tables;
  std::mutex publish_mu;             // guards `tables` capture/swap
  std::mutex writer_mu;              // single writer (+ WAL/snapshot IO)
  std::thread::id writer_owner{};    // nested same-thread writers = error
  std::string dir;       // empty = in-memory only
  FILE* wal = nullptr;
  uint64_t wal_records = 0;

  // open-time only (single-threaded load/replay): mutable access
  Table* open_mutable(const std::string& name) {
    auto it = tables.find(name);
    if (it == tables.end()) {
      auto p = std::make_shared<Table>();
      Table* raw = p.get();
      tables[name] = std::move(p);
      return raw;
    }
    return const_cast<Table*>(it->second.get());
  }

  ~Env() {
    if (wal) fclose(wal);
  }
};

struct Txn {
  Env* env;
  bool write;
  std::map<std::string, TableRef> snap;                 // captured at begin
  std::map<std::string, std::shared_ptr<Table>> own;    // clone-on-write
  // WAL records buffered until commit (atomicity: records + commit mark)
  std::string wal_buf;

  const Table* view(const std::string& t) const {
    auto oi = own.find(t);
    if (oi != own.end()) return oi->second.get();
    auto si = snap.find(t);
    return si != snap.end() ? si->second.get() : nullptr;
  }

  TableRef view_ref(const std::string& t) const {
    auto oi = own.find(t);
    if (oi != own.end()) return oi->second;
    auto si = snap.find(t);
    return si != snap.end() ? si->second : nullptr;
  }

  Table* wview(const std::string& t) {
    auto oi = own.find(t);
    if (oi != own.end()) return oi->second.get();
    auto si = snap.find(t);
    auto p = si != snap.end() ? std::make_shared<Table>(*si->second)
                              : std::make_shared<Table>();
    Table* raw = p.get();
    own[t] = std::move(p);
    return raw;
  }
};

struct Cursor {
  Txn* txn;
  std::string table;
  TableRef pin;          // the table as of cursor creation (kept alive)
  Table::const_iterator it;
  size_t dup = 0;
  // tri-state mirrors the python MemDb cursor: UNPOS (fresh; next()=first),
  // POS (on an entry), EXHAUSTED (failed seek / ran off the end;
  // next()=None but prev()=last — MemDb _ki==len semantics)
  enum State : uint8_t { UNPOS, POS, EXHAUSTED } state = UNPOS;
};

void wal_append(std::string& buf, uint8_t op, const std::string& table,
                const std::string& key, const std::string& val) {
  auto put32 = [&buf](uint32_t v) { buf.append(reinterpret_cast<char*>(&v), 4); };
  buf.push_back(static_cast<char>(op));
  put32(static_cast<uint32_t>(table.size()));
  buf.append(table);
  put32(static_cast<uint32_t>(key.size()));
  buf.append(key);
  put32(static_cast<uint32_t>(val.size()));
  buf.append(val);
}

void table_put(Table& t, const std::string& key, const std::string& val,
               bool dupsort) {
  Dups& d = t[key];
  if (!dupsort) {
    d.assign(1, val);
    return;
  }
  auto pos = std::lower_bound(d.begin(), d.end(), val);
  if (pos == d.end() || *pos != val) d.insert(pos, val);
}

bool table_del(Table& t, const std::string& key, const std::string* val) {
  auto ki = t.find(key);
  if (ki == t.end()) return false;
  if (val == nullptr) {
    t.erase(ki);
    return true;
  }
  Dups& d = ki->second;
  auto pos = std::lower_bound(d.begin(), d.end(), *val);
  if (pos != d.end() && *pos == *val) {
    d.erase(pos);
    if (d.empty()) t.erase(ki);
    return true;
  }
  return false;
}

// -- snapshot format ----------------------------------------------------------
// magic "RTKV1\n" | per table: u32 name_len name u64 nkeys
//   per key: u32 key_len key u32 ndups { u32 len bytes }
// terminated by u32 name_len == 0xFFFFFFFF

bool save_snapshot(Env* env) {
  if (env->dir.empty()) return true;
  std::string tmp = env->dir + "/snapshot.tmp";
  FILE* f = fopen(tmp.c_str(), "wb");
  if (!f) return false;
  bool ok = true;
  auto wr = [f, &ok](const void* p, size_t n) {
    if (n && fwrite(p, 1, n, f) != n) ok = false;
  };
  auto w32 = [&wr](uint32_t v) { wr(&v, 4); };
  auto w64 = [&wr](uint64_t v) { wr(&v, 8); };
  wr("RTKV1\n", 6);
  for (auto& [name, table_ref] : env->tables) {
    const Table& table = *table_ref;
    w32(static_cast<uint32_t>(name.size()));
    wr(name.data(), name.size());
    w64(table.size());
    for (auto& [key, dups] : table) {
      w32(static_cast<uint32_t>(key.size()));
      wr(key.data(), key.size());
      w32(static_cast<uint32_t>(dups.size()));
      for (auto& v : dups) {
        w32(static_cast<uint32_t>(v.size()));
        wr(v.data(), v.size());
      }
    }
  }
  w32(0xFFFFFFFFu);
  if (fflush(f) != 0) ok = false;
  if (ok && fsync(fileno(f)) != 0) ok = false;
  fclose(f);
  if (!ok) {
    remove(tmp.c_str());
    return false;  // keep the old snapshot + WAL intact
  }
  std::string final = env->dir + "/snapshot.rtkv";
  if (rename(tmp.c_str(), final.c_str()) != 0) return false;
  // snapshot now authoritative: truncate the WAL
  if (env->wal) fclose(env->wal);
  std::string walpath = env->dir + "/wal.rtkv";
  env->wal = fopen(walpath.c_str(), "wb");
  env->wal_records = 0;
  return env->wal != nullptr;
}

bool read_exact(FILE* f, void* out, size_t n) { return fread(out, 1, n, f) == n; }

bool load_snapshot(Env* env) {
  std::string path = env->dir + "/snapshot.rtkv";
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return true;  // fresh env
  char magic[6];
  if (!read_exact(f, magic, 6) || memcmp(magic, "RTKV1\n", 6) != 0) {
    fclose(f);
    return false;
  }
  while (true) {
    uint32_t name_len;
    if (!read_exact(f, &name_len, 4)) break;
    if (name_len == 0xFFFFFFFFu) break;
    std::string name(name_len, '\0');
    if (!read_exact(f, name.data(), name_len)) break;
    uint64_t nkeys;
    if (!read_exact(f, &nkeys, 8)) break;
    Table& t = *env->open_mutable(name);
    for (uint64_t i = 0; i < nkeys; i++) {
      uint32_t klen;
      if (!read_exact(f, &klen, 4)) goto done;
      std::string key(klen, '\0');
      if (!read_exact(f, key.data(), klen)) goto done;
      uint32_t ndups;
      if (!read_exact(f, &ndups, 4)) goto done;
      Dups d;
      d.reserve(ndups);
      for (uint32_t j = 0; j < ndups; j++) {
        uint32_t vlen;
        if (!read_exact(f, &vlen, 4)) goto done;
        std::string v(vlen, '\0');
        if (!read_exact(f, v.data(), vlen)) goto done;
        d.push_back(std::move(v));
      }
      t.emplace(std::move(key), std::move(d));
    }
  }
done:
  fclose(f);
  return true;
}

bool replay_wal(Env* env) {
  std::string path = env->dir + "/wal.rtkv";
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return true;
  // collect one committed batch at a time; uncommitted tails are dropped
  struct Rec {
    uint8_t op;
    std::string table, key, val;
  };
  std::vector<Rec> batch;
  while (true) {
    uint8_t op;
    if (!read_exact(f, &op, 1)) break;
    uint32_t tlen, klen, vlen;
    std::string table, key, val;
    if (!read_exact(f, &tlen, 4)) break;
    table.resize(tlen);
    if (tlen && !read_exact(f, table.data(), tlen)) break;
    if (!read_exact(f, &klen, 4)) break;
    key.resize(klen);
    if (klen && !read_exact(f, key.data(), klen)) break;
    if (!read_exact(f, &vlen, 4)) break;
    val.resize(vlen);
    if (vlen && !read_exact(f, val.data(), vlen)) break;
    if (op == WAL_COMMIT) {
      for (auto& r : batch) {
        Table& t = *env->open_mutable(r.table);
        switch (r.op) {
          case WAL_PUT: table_put(t, r.key, r.val, false); break;
          case WAL_PUT_DUP: table_put(t, r.key, r.val, true); break;
          case WAL_DEL_KEY: table_del(t, r.key, nullptr); break;
          case WAL_DEL_DUP: table_del(t, r.key, &r.val); break;
          case WAL_CLEAR: t.clear(); break;
        }
      }
      batch.clear();
    } else {
      batch.push_back({op, std::move(table), std::move(key), std::move(val)});
    }
  }
  fclose(f);
  return true;
}

}  // namespace

extern "C" {

void* rtkv_open(const char* dir) {
  auto env = std::make_unique<Env>();
  if (dir && dir[0]) {
    env->dir = dir;
    if (!load_snapshot(env.get())) return nullptr;
    if (!replay_wal(env.get())) return nullptr;
    std::string walpath = env->dir + "/wal.rtkv";
    env->wal = fopen(walpath.c_str(), "ab");
    if (!env->wal) return nullptr;
  }
  return env.release();
}

void rtkv_close(void* envp) { delete static_cast<Env*>(envp); }

int rtkv_snapshot(void* envp) {
  auto env = static_cast<Env*>(envp);
  // exclude writers for the whole snapshot+WAL-truncate window: a racing
  // commit could otherwise mutate the map mid-iteration or write to the
  // WAL handle being swapped out
  std::lock_guard<std::mutex> w(env->writer_mu);
  return save_snapshot(env) ? 0 : -1;
}

// Power-loss durability point: fsync the WAL.
int rtkv_sync(void* envp) {
  auto env = static_cast<Env*>(envp);
  if (!env->wal) return 0;
  if (fflush(env->wal) != 0) return -1;
  return fsync(fileno(env->wal)) == 0 ? 0 : -1;
}

void* rtkv_txn_begin(void* envp, int write) {
  auto env = static_cast<Env*>(envp);
  if (write) {
    // a nested write txn on one thread would deadlock (or, with a
    // recursive lock, silently clobber the outer txn's clones) — error
    if (env->writer_owner == std::this_thread::get_id()) return nullptr;
    env->writer_mu.lock();
    env->writer_owner = std::this_thread::get_id();
  }
  auto txn = new Txn();
  txn->env = env;
  txn->write = write != 0;
  {
    std::lock_guard<std::mutex> g(env->publish_mu);
    txn->snap = env->tables;  // shared_ptr copies: the MVCC snapshot
  }
  return txn;
}

int rtkv_put(void* txnp, const char* table, const uint8_t* key, uint32_t klen,
             const uint8_t* val, uint32_t vlen, int dupsort) {
  auto txn = static_cast<Txn*>(txnp);
  if (!txn->write) return -1;
  std::string t(table), k(reinterpret_cast<const char*>(key), klen),
      v(reinterpret_cast<const char*>(val), vlen);
  table_put(*txn->wview(t), k, v, dupsort != 0);
  wal_append(txn->wal_buf, dupsort ? WAL_PUT_DUP : WAL_PUT, t, k, v);
  return 0;
}

int rtkv_del(void* txnp, const char* table, const uint8_t* key, uint32_t klen,
             const uint8_t* val, uint32_t vlen, int have_val) {
  auto txn = static_cast<Txn*>(txnp);
  if (!txn->write) return -1;
  std::string t(table), k(reinterpret_cast<const char*>(key), klen);
  bool ok;
  if (have_val) {
    std::string v(reinterpret_cast<const char*>(val), vlen);
    ok = table_del(*txn->wview(t), k, &v);
    if (ok) wal_append(txn->wal_buf, WAL_DEL_DUP, t, k, v);
  } else {
    ok = table_del(*txn->wview(t), k, nullptr);
    if (ok) wal_append(txn->wal_buf, WAL_DEL_KEY, t, k, "");
  }
  return ok ? 1 : 0;
}

int rtkv_clear(void* txnp, const char* table) {
  auto txn = static_cast<Txn*>(txnp);
  if (!txn->write) return -1;
  std::string t(table);
  txn->own[t] = std::make_shared<Table>();
  wal_append(txn->wal_buf, WAL_CLEAR, t, "", "");
  return 0;
}

// get: first duplicate; returns 1 found / 0 missing. Pointer valid for the
// life of the txn's snapshot (caller copies immediately anyway).
int rtkv_get(void* txnp, const char* table, const uint8_t* key, uint32_t klen,
             const uint8_t** out, uint32_t* out_len) {
  auto txn = static_cast<Txn*>(txnp);
  const Table* t = txn->view(table);
  if (!t) return 0;
  auto ki = t->find(std::string(reinterpret_cast<const char*>(key), klen));
  if (ki == t->end() || ki->second.empty()) return 0;
  *out = reinterpret_cast<const uint8_t*>(ki->second[0].data());
  *out_len = static_cast<uint32_t>(ki->second[0].size());
  return 1;
}

uint64_t rtkv_entry_count(void* txnp, const char* table) {
  auto txn = static_cast<Txn*>(txnp);
  const Table* t = txn->view(table);
  if (!t) return 0;
  uint64_t n = 0;
  for (auto& [k, d] : *t) n += d.size();
  return n;
}

int rtkv_commit(void* txnp) {
  auto txn = static_cast<Txn*>(txnp);
  int rc = 0;
  if (txn->write) {
    if (txn->env->wal && !txn->wal_buf.empty()) {
      wal_append(txn->wal_buf, WAL_COMMIT, "", "", "");
      if (fwrite(txn->wal_buf.data(), 1, txn->wal_buf.size(), txn->env->wal) !=
          txn->wal_buf.size())
        rc = -1;
      fflush(txn->env->wal);
      txn->env->wal_records += 1;
    }
    if (!txn->own.empty()) {
      std::lock_guard<std::mutex> g(txn->env->publish_mu);
      for (auto& [name, tbl] : txn->own) txn->env->tables[name] = tbl;
    }
    txn->env->writer_owner = std::thread::id{};
    txn->env->writer_mu.unlock();
  }
  delete txn;
  return rc;
}

void rtkv_abort(void* txnp) {
  auto txn = static_cast<Txn*>(txnp);
  if (txn->write) {  // clones just drop
    txn->env->writer_owner = std::thread::id{};
    txn->env->writer_mu.unlock();
  }
  delete txn;
}

// -- cursors ------------------------------------------------------------------

void* rtkv_cursor(void* txnp, const char* table) {
  auto txn = static_cast<Txn*>(txnp);
  auto cur = new Cursor();
  cur->txn = txn;
  cur->table = table;
  cur->pin = txn->view_ref(table);  // tx view as of cursor creation
  cur->state = Cursor::UNPOS;
  return cur;
}

void rtkv_cursor_close(void* curp) { delete static_cast<Cursor*>(curp); }

namespace {

const Table* cursor_table(Cursor* c) { return c->pin.get(); }

// MemDb cursor semantics: the KEY order is frozen at cursor creation (the
// pin), but VALUES are read through the txn's live view — a write txn's
// own later puts/deletes are visible to pre-existing cursors.
const Dups* live_dups(Cursor* c, const Key& key) {
  const Table* t = c->txn->view(c->table);
  if (!t) return nullptr;
  auto ki = t->find(key);
  return ki == t->end() ? nullptr : &ki->second;
}

int emit(Cursor* c, const uint8_t** k, uint32_t* klen, const uint8_t** v,
         uint32_t* vlen) {
  if (c->state != Cursor::POS) return 0;
  const Key& key = c->it->first;
  const Dups* d = live_dups(c, key);
  if (!d || c->dup >= d->size()) return 0;
  *k = reinterpret_cast<const uint8_t*>(key.data());
  *klen = static_cast<uint32_t>(key.size());
  *v = reinterpret_cast<const uint8_t*>((*d)[c->dup].data());
  *vlen = static_cast<uint32_t>((*d)[c->dup].size());
  return 1;
}

}  // namespace

int rtkv_cursor_first(void* curp, const uint8_t** k, uint32_t* klen,
                      const uint8_t** v, uint32_t* vlen) {
  auto c = static_cast<Cursor*>(curp);
  const Table* t = cursor_table(c);
  if (!t || t->empty()) {
    c->state = Cursor::EXHAUSTED;
    return 0;
  }
  c->it = t->begin();
  c->dup = 0;
  c->state = Cursor::POS;
  return emit(c, k, klen, v, vlen);
}

int rtkv_cursor_last(void* curp, const uint8_t** k, uint32_t* klen,
                     const uint8_t** v, uint32_t* vlen) {
  auto c = static_cast<Cursor*>(curp);
  const Table* t = cursor_table(c);
  if (!t || t->empty()) {
    c->state = Cursor::EXHAUSTED;
    return 0;
  }
  c->it = std::prev(t->end());
  const Dups* d = live_dups(c, c->it->first);
  c->dup = (d && d->size()) ? d->size() - 1 : 0;
  c->state = Cursor::POS;
  return emit(c, k, klen, v, vlen);
}

int rtkv_cursor_seek(void* curp, const uint8_t* key, uint32_t klen, int exact,
                     const uint8_t** k, uint32_t* kl, const uint8_t** v,
                     uint32_t* vl) {
  auto c = static_cast<Cursor*>(curp);
  const Table* t = cursor_table(c);
  c->state = Cursor::EXHAUSTED;
  if (!t) return 0;
  std::string target(reinterpret_cast<const char*>(key), klen);
  auto it = t->lower_bound(target);
  if (it == t->end()) return 0;
  if (exact && it->first != target) return 0;
  c->it = it;
  c->dup = 0;
  c->state = Cursor::POS;
  return emit(c, k, kl, v, vl);
}

int rtkv_cursor_next(void* curp, int skip_dups, const uint8_t** k, uint32_t* kl,
                     const uint8_t** v, uint32_t* vl) {
  auto c = static_cast<Cursor*>(curp);
  const Table* t = cursor_table(c);
  if (!t) {
    c->state = Cursor::EXHAUSTED;
    return 0;
  }
  if (c->state == Cursor::EXHAUSTED) return 0;  // MemDb: past-the-end stays put
  if (c->state == Cursor::UNPOS) return rtkv_cursor_first(curp, k, kl, v, vl);
  const Dups* cd = live_dups(c, c->it->first);
  if (!skip_dups && cd && c->dup + 1 < cd->size()) {
    c->dup += 1;
    return emit(c, k, kl, v, vl);
  }
  ++c->it;
  c->dup = 0;
  if (c->it == t->end()) {
    c->state = Cursor::EXHAUSTED;
    return 0;
  }
  return emit(c, k, kl, v, vl);
}

int rtkv_cursor_prev(void* curp, const uint8_t** k, uint32_t* kl,
                     const uint8_t** v, uint32_t* vl) {
  auto c = static_cast<Cursor*>(curp);
  const Table* t = cursor_table(c);
  if (!t || c->state == Cursor::UNPOS) return 0;
  if (c->state == Cursor::EXHAUSTED)  // MemDb: prev from past-the-end = last
    return rtkv_cursor_last(curp, k, kl, v, vl);
  if (c->dup > 0) {
    c->dup -= 1;
    return emit(c, k, kl, v, vl);
  }
  if (c->it == t->begin()) {
    c->state = Cursor::UNPOS;
    return 0;
  }
  --c->it;
  const Dups* pd = live_dups(c, c->it->first);
  c->dup = (pd && pd->size()) ? pd->size() - 1 : 0;
  return emit(c, k, kl, v, vl);
}

// next duplicate of the CURRENT key only; 0 when exhausted
int rtkv_cursor_next_dup(void* curp, const uint8_t** k, uint32_t* kl,
                         const uint8_t** v, uint32_t* vl) {
  auto c = static_cast<Cursor*>(curp);
  if (c->state != Cursor::POS) return 0;
  const Dups* d = live_dups(c, c->it->first);
  if (!d || c->dup + 1 >= d->size()) return 0;
  c->dup += 1;
  return emit(c, k, kl, v, vl);
}

// first duplicate of `key` with value >= subkey prefix
int rtkv_cursor_seek_dup(void* curp, const uint8_t* key, uint32_t klen,
                         const uint8_t* sub, uint32_t slen, const uint8_t** k,
                         uint32_t* kl, const uint8_t** v, uint32_t* vl) {
  auto c = static_cast<Cursor*>(curp);
  const Table* t = cursor_table(c);
  c->state = Cursor::EXHAUSTED;
  if (!t) return 0;
  auto it = t->find(std::string(reinterpret_cast<const char*>(key), klen));
  if (it == t->end()) return 0;
  std::string target(reinterpret_cast<const char*>(sub), slen);
  c->it = it;
  const Dups* d = live_dups(c, it->first);
  if (!d) return 0;
  auto pos = std::lower_bound(d->begin(), d->end(), target);
  if (pos == d->end()) return 0;
  c->dup = static_cast<size_t>(pos - d->begin());
  c->state = Cursor::POS;
  return emit(c, k, kl, v, vl);
}

}  // extern "C"
