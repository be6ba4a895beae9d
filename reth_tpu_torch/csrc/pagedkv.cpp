// Paged copy-on-write B+tree KV engine with mmap reads — the MDBX analogue.
//
// Reference analogue: crates/storage/libmdbx-rs/mdbx-sys/libmdbx (shadow-paging
// B+tree). This is NOT a translation of libmdbx: it is a from-scratch C++17
// engine with the same architectural properties the reference relies on:
//
//   * single data file of 4 KiB pages, read through one large shared mmap —
//     the OS page cache IS the read cache, nothing is held in process RAM
//     (unlike native/kvstore.cpp whose std::map holds the whole DB);
//   * copy-on-write page updates: a writer never touches a page any reader
//     (or the last durable version) can see — MVCC snapshot isolation falls
//     out of the design, readers are zero-cost and never block;
//   * dual meta pages flipped on commit: pwrite dirty pages -> fdatasync ->
//     write meta slot (txnid & 1) -> fdatasync. A crash at any point leaves
//     the previous meta valid — no WAL, no replay, O(1) recovery;
//   * freed pages are recycled through a persisted free list once no live
//     reader snapshot can reference them (reader table in memory — single
//     process — so crash recovery can reuse everything in the list);
//   * DUPSORT: per-key sorted duplicate sets, inline in the leaf cell while
//     small, spilled to a nested B+tree when large (sub-database, as MDBX);
//   * overflow page chains for values larger than a leaf cell.
//
// Deliberate simplifications vs libmdbx (documented, not hidden): pages are
// not rebalanced on underflow (only emptied pages are unlinked; heavy delete
// workloads reclaim space through the free list, not by merging siblings),
// and the reader table is in-memory because the embedding is single-process.
//
// C ABI mirrors native/kvstore.cpp (rtpg_ prefix) so the ctypes binding and
// every storage contract test run unchanged over both engines.

#include <algorithm>
#include <cassert>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <string_view>
#include <map>
#include <memory>
#include <mutex>
#include <set>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t PAGE = 4096;
constexpr uint32_t MAGIC = 0x52545047;  // "RTPG"
constexpr uint32_t VERSION = 1;
constexpr uint64_t MAPSIZE = 1ULL << 40;  // 1 TiB of reserved address space
// The reservation is anonymous and PROT_NONE; the data file is mapped over
// its front in MAP_CHUNK steps as the file grows (env_map_to), so the pages a
// reader can reach never move and no more than the file (rounded up to a
// chunk) is mapped. Some machines count a file mapping's whole length as
// resident once the file grows, which a 1 TiB file mapping cannot survive.
constexpr uint64_t MAP_CHUNK = 64ULL << 20;
constexpr uint32_t MAXKEY = 1024;
constexpr uint32_t MAXCELL = 1000;   // largest in-leaf cell => >=4 cells/page
constexpr uint32_t DUP_SPILL = 512;  // inline dup payload before subtree spill

enum PType : uint8_t { P_BRANCH = 1, P_LEAF = 2, P_OVERFLOW = 3, P_FREE = 4 };
enum LFlag : uint8_t { L_INLINE = 0, L_OVERFLOW = 1, L_DUPIN = 2, L_DUPTREE = 3 };

#pragma pack(push, 1)
struct Meta {
  uint32_t magic;
  uint32_t version;
  uint64_t txnid;
  uint64_t n_pages;
  uint32_t catalog_root;
  uint32_t freelist_head;
  uint64_t freelist_len;
  uint64_t checksum;
};
struct PageHdr {
  uint8_t type;
  uint8_t pad;
  uint16_t n_cells;
  uint16_t cells_start;  // lowest cell byte offset (== PAGE when empty)
  uint16_t pad2;
};
#pragma pack(pop)

uint64_t fnv(const void* data, size_t n) {
  const uint8_t* p = static_cast<const uint8_t*>(data);
  uint64_t h = 1469598103934665603ULL;
  for (size_t i = 0; i < n; i++) h = (h ^ p[i]) * 1099511628211ULL;
  return h;
}

uint64_t meta_sum(const Meta& m) { return fnv(&m, offsetof(Meta, checksum)); }

// -- little-endian field access ----------------------------------------------

uint16_t g16(const uint8_t* p) { uint16_t v; memcpy(&v, p, 2); return v; }
uint32_t g32(const uint8_t* p) { uint32_t v; memcpy(&v, p, 4); return v; }
uint64_t g64(const uint8_t* p) { uint64_t v; memcpy(&v, p, 8); return v; }
void s16(uint8_t* p, uint16_t v) { memcpy(p, &v, 2); }
void s32(uint8_t* p, uint32_t v) { memcpy(p, &v, 4); }
void s64(uint8_t* p, uint64_t v) { memcpy(p, &v, 8); }

// -- cells --------------------------------------------------------------------
// Leaf cell:   [u8 flags][u8 pad][u16 klen][u32 vlen][key][payload]
//   L_INLINE:  payload = value bytes (payload size == vlen)
//   L_OVERFLOW:payload = u32 first overflow pgno (vlen = total value length)
//   L_DUPIN:   payload = u32 count, then per dup {u16 len, bytes}
//              (vlen = payload size)
//   L_DUPTREE: payload = u32 subtree root, u64 dup count (vlen = 12)
// Branch cell: [u16 klen][u32 child][key]   (cell 0's key is ignored: -inf)

struct LeafView {
  uint8_t flags;
  std::string_view key;
  uint32_t vlen;
  const uint8_t* payload;
  uint32_t payload_sz;
};

LeafView leaf_view(const uint8_t* c) {
  LeafView v;
  v.flags = c[0];
  uint16_t klen = g16(c + 2);
  v.vlen = g32(c + 4);
  v.key = std::string_view(reinterpret_cast<const char*>(c + 8), klen);
  v.payload = c + 8 + klen;
  v.payload_sz = (v.flags == L_INLINE)     ? v.vlen
                 : (v.flags == L_OVERFLOW) ? 4
                 : (v.flags == L_DUPIN)    ? v.vlen
                                           : 12;
  return v;
}

std::string make_leaf_cell(uint8_t flags, std::string_view key, uint32_t vlen,
                           const void* payload, uint32_t psz) {
  std::string c(8 + key.size() + psz, '\0');
  uint8_t* p = reinterpret_cast<uint8_t*>(c.data());
  p[0] = flags;
  s16(p + 2, static_cast<uint16_t>(key.size()));
  s32(p + 4, vlen);
  memcpy(p + 8, key.data(), key.size());
  if (psz) memcpy(p + 8 + key.size(), payload, psz);
  return c;
}

std::string_view branch_key(const uint8_t* c) {
  return std::string_view(reinterpret_cast<const char*>(c + 6), g16(c));
}
uint32_t branch_child(const uint8_t* c) { return g32(c + 2); }

std::string make_branch_cell(std::string_view key, uint32_t child) {
  std::string c(6 + key.size(), '\0');
  uint8_t* p = reinterpret_cast<uint8_t*>(c.data());
  s16(p, static_cast<uint16_t>(key.size()));
  s32(p + 2, child);
  memcpy(p + 6, key.data(), key.size());
  return c;
}

// -- page layout --------------------------------------------------------------

const PageHdr* hdr(const uint8_t* p) { return reinterpret_cast<const PageHdr*>(p); }
PageHdr* hdr(uint8_t* p) { return reinterpret_cast<PageHdr*>(p); }
const uint8_t* cell_at(const uint8_t* p, int i) {
  return p + g16(p + sizeof(PageHdr) + 2 * i);
}

std::vector<std::string> explode(const uint8_t* p) {
  int n = hdr(p)->n_cells;
  std::vector<std::string> cells;
  cells.reserve(n);
  bool leaf = hdr(p)->type == P_LEAF;
  for (int i = 0; i < n; i++) {
    const uint8_t* c = cell_at(p, i);
    size_t sz;
    if (leaf) {
      LeafView v = leaf_view(c);
      sz = 8 + v.key.size() + v.payload_sz;
    } else {
      sz = 6 + g16(c);
    }
    cells.emplace_back(reinterpret_cast<const char*>(c), sz);
  }
  return cells;
}

size_t cells_bytes(const std::vector<std::string>& cells, size_t a, size_t b) {
  size_t total = 0;
  for (size_t i = a; i < b; i++) total += cells[i].size() + 2;
  return total;
}

bool fits(const std::vector<std::string>& cells) {
  return sizeof(PageHdr) + cells_bytes(cells, 0, cells.size()) <= PAGE;
}

void rebuild(uint8_t* p, uint8_t type, const std::vector<std::string>& cells,
             size_t a, size_t b) {
  memset(p, 0, PAGE);
  PageHdr* h = hdr(p);
  h->type = type;
  h->n_cells = static_cast<uint16_t>(b - a);
  uint32_t off = PAGE;
  for (size_t i = a; i < b; i++) {
    off -= static_cast<uint32_t>(cells[i].size());
    memcpy(p + off, cells[i].data(), cells[i].size());
    s16(p + sizeof(PageHdr) + 2 * (i - a), static_cast<uint16_t>(off));
  }
  h->cells_start = static_cast<uint16_t>(off);
}

// -- env / txn ----------------------------------------------------------------

struct TableInfo {
  uint32_t root = 0;
  uint64_t count = 0;
  bool dirty = false;
};

struct Env {
  int fd = -1;
  std::string dir;
  uint8_t* map = nullptr;
  uint64_t mapped = 0;  // bytes of the file mapped at map (env_map_to)
  ~Env() {
    if (map && map != MAP_FAILED) munmap(map, MAPSIZE);
    if (fd >= 0) ::close(fd);
  }
  Meta meta{};
  std::mutex writer_mu;  // serializes write txns
  std::thread::id writer_owner{};
  std::mutex state_mu;  // readers / free lists / meta swap
  std::multiset<uint64_t> readers;
  std::vector<uint32_t> reusable;
  std::vector<std::pair<uint64_t, std::vector<uint32_t>>> pending;
  std::vector<uint32_t> freelist_pages;  // current persisted chain
};

struct Txn {
  Env* env;
  bool write;
  // One txn may be shared by several Python threads (the engine's prewarm
  // workers all read through one provider txn); ctypes releases the GIL, so
  // every entry point serializes on this. Same rule as MDBX: a txn is not
  // concurrently usable — we enforce it with a lock instead of UB.
  // Recursive: cursor_next re-enters via cursor_first (UNPOS semantics).
  std::recursive_mutex op_mu;
  Meta snap;
  std::unordered_map<uint32_t, std::unique_ptr<uint8_t[]>> dirty;
  std::unordered_set<uint32_t> fresh;  // allocated this txn (never durable)
  std::vector<uint32_t> freed;         // prev-version pages freed this txn
  std::vector<uint32_t> recycle;       // fresh pages freed again (reuse now)
  std::vector<uint32_t> took_reusable;  // popped from env->reusable (abort undo)
  uint64_t next_page;
  std::map<std::string, TableInfo> tables;
  std::string valbuf;
};

const uint8_t* tx_page(Txn* t, uint32_t pgno) {
  auto it = t->dirty.find(pgno);
  if (it != t->dirty.end()) return it->second.get();
  return t->env->map + static_cast<uint64_t>(pgno) * PAGE;
}

uint8_t* tx_writable(Txn* t, uint32_t pgno) {
  auto it = t->dirty.find(pgno);
  assert(it != t->dirty.end());
  return it->second.get();
}

void drain_pending(Env* env) {  // caller holds state_mu
  uint64_t min_reader =
      env->readers.empty() ? UINT64_MAX : *env->readers.begin();
  auto& pend = env->pending;
  for (auto it = pend.begin(); it != pend.end();) {
    if (it->first <= env->meta.txnid && it->first <= min_reader) {
      env->reusable.insert(env->reusable.end(), it->second.begin(),
                           it->second.end());
      it = pend.erase(it);
    } else {
      ++it;
    }
  }
}

uint32_t tx_alloc(Txn* t) {
  uint32_t pgno;
  if (!t->recycle.empty()) {
    pgno = t->recycle.back();
    t->recycle.pop_back();
  } else {
    std::lock_guard<std::mutex> g(t->env->state_mu);
    drain_pending(t->env);
    if (!t->env->reusable.empty()) {
      pgno = t->env->reusable.back();
      t->env->reusable.pop_back();
      t->took_reusable.push_back(pgno);
    } else {
      pgno = static_cast<uint32_t>(t->next_page++);
    }
  }
  auto buf = std::make_unique<uint8_t[]>(PAGE);
  memset(buf.get(), 0, PAGE);
  hdr(buf.get())->cells_start = static_cast<uint16_t>(PAGE & 0xFFFF);
  t->dirty[pgno] = std::move(buf);
  t->fresh.insert(pgno);
  return pgno;
}

void tx_free(Txn* t, uint32_t pgno) {
  if (t->fresh.count(pgno)) {
    t->fresh.erase(pgno);
    t->dirty.erase(pgno);
    t->recycle.push_back(pgno);
  } else {
    t->freed.push_back(pgno);
  }
}

// copy-on-write: returns a dirty pgno holding this page's bytes
uint32_t tx_cow(Txn* t, uint32_t pgno) {
  if (t->dirty.count(pgno)) return pgno;
  uint32_t np = tx_alloc(t);
  memcpy(tx_writable(t, np), t->env->map + static_cast<uint64_t>(pgno) * PAGE,
         PAGE);
  tx_free(t, pgno);
  return np;
}

// -- overflow chains ----------------------------------------------------------

constexpr uint32_t OV_DATA = PAGE - 8;  // [u8 type][u8 pad][u16 used][u32 next]

uint32_t ov_write(Txn* t, const uint8_t* data, uint32_t len) {
  uint32_t first = 0, prev = 0;
  uint32_t off = 0;
  while (off < len || first == 0) {
    uint32_t pg = tx_alloc(t);
    uint8_t* p = tx_writable(t, pg);
    p[0] = P_OVERFLOW;
    uint32_t chunk = std::min(OV_DATA, len - off);
    s16(p + 2, static_cast<uint16_t>(chunk));
    s32(p + 4, 0);
    memcpy(p + 8, data + off, chunk);
    off += chunk;
    if (!first)
      first = pg;
    else
      s32(tx_writable(t, prev) + 4, pg);
    prev = pg;
    if (off >= len) break;
  }
  return first;
}

void ov_read(Txn* t, uint32_t pgno, std::string& out) {
  out.clear();
  while (pgno) {
    const uint8_t* p = tx_page(t, pgno);
    out.append(reinterpret_cast<const char*>(p + 8), g16(p + 2));
    pgno = g32(p + 4);
  }
}

void ov_free(Txn* t, uint32_t pgno) {
  while (pgno) {
    uint32_t next = g32(tx_page(t, pgno) + 4);
    tx_free(t, pgno);
    pgno = next;
  }
}

// -- tree search --------------------------------------------------------------

struct PathEnt {
  uint32_t pgno;
  int idx;
};
using Path = std::vector<PathEnt>;

int branch_find(const uint8_t* p, std::string_view key) {
  int n = hdr(p)->n_cells;
  int lo = 1, hi = n;  // cell 0's key is -inf
  while (lo < hi) {
    int mid = (lo + hi) / 2;
    if (branch_key(cell_at(p, mid)) <= key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo - 1;
}

int leaf_lower_bound(const uint8_t* p, std::string_view key, bool* exact) {
  int n = hdr(p)->n_cells;
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) / 2;
    if (leaf_view(cell_at(p, mid)).key < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  *exact = lo < n && leaf_view(cell_at(p, lo)).key == key;
  return lo;
}

// Descends to the leaf containing (or insertion point of) key. When
// for_write, every page on the path is COWed and parent child pointers are
// patched, so the caller can mutate path pages freely.
bool tree_descend(Txn* t, uint32_t* root, std::string_view key, Path& path,
                  bool for_write, bool* exact) {
  path.clear();
  *exact = false;
  if (!*root) return false;
  uint32_t pg = *root;
  if (for_write) {
    pg = tx_cow(t, pg);
    *root = pg;
  }
  while (true) {
    const uint8_t* p = tx_page(t, pg);
    if (hdr(p)->type == P_BRANCH) {
      int idx = branch_find(p, key);
      uint32_t child = branch_child(cell_at(p, idx));
      if (for_write) {
        uint32_t nc = tx_cow(t, child);
        if (nc != child) {
          uint8_t* wp = tx_writable(t, pg);
          s32(wp + g16(wp + sizeof(PageHdr) + 2 * idx) + 2, nc);
          child = nc;
        }
      }
      path.push_back({pg, idx});
      pg = child;
    } else {
      int idx = leaf_lower_bound(p, key, exact);
      path.push_back({pg, idx});
      return *exact;
    }
  }
}

void descend_edge(Txn* t, uint32_t root, bool last, Path& path) {
  path.clear();
  if (!root) return;
  uint32_t pg = root;
  while (true) {
    const uint8_t* p = tx_page(t, pg);
    int n = hdr(p)->n_cells;
    if (hdr(p)->type == P_BRANCH) {
      int idx = last ? n - 1 : 0;
      path.push_back({pg, idx});
      pg = branch_child(cell_at(p, idx));
    } else {
      path.push_back({pg, last ? n - 1 : 0});
      return;
    }
  }
}

// step the path to the next/prev leaf cell; false when off the end
bool path_step(Txn* t, Path& path, int dir) {
  if (path.empty()) return false;
  int leaf_level = static_cast<int>(path.size()) - 1;
  path[leaf_level].idx += dir;
  const uint8_t* leaf = tx_page(t, path[leaf_level].pgno);
  if (path[leaf_level].idx >= 0 &&
      path[leaf_level].idx < hdr(leaf)->n_cells)
    return true;
  // climb
  int lvl = leaf_level - 1;
  while (lvl >= 0) {
    const uint8_t* p = tx_page(t, path[lvl].pgno);
    int ni = path[lvl].idx + dir;
    if (ni >= 0 && ni < hdr(p)->n_cells) {
      path[lvl].idx = ni;
      // descend along the opposite edge
      uint32_t pg = branch_child(cell_at(p, ni));
      path.resize(lvl + 1);
      while (true) {
        const uint8_t* q = tx_page(t, pg);
        int n = hdr(q)->n_cells;
        int idx = dir > 0 ? 0 : n - 1;
        path.push_back({pg, idx});
        if (hdr(q)->type == P_LEAF) return true;
        pg = branch_child(cell_at(q, idx));
      }
    }
    lvl--;
  }
  return false;
}

// -- tree mutation ------------------------------------------------------------

void branch_insert(Txn* t, uint32_t* root, Path& path, int level,
                   std::string sep, uint32_t right);

// Replace (replace=true) or insert the cell at path's leaf position,
// splitting up the tree as needed. Path pages must already be COWed.
void leaf_put_cell(Txn* t, uint32_t* root, Path& path, std::string cell,
                   bool replace) {
  PathEnt& leaf = path.back();
  uint8_t* p = tx_writable(t, leaf.pgno);
  auto cells = explode(p);
  if (replace)
    cells[leaf.idx] = std::move(cell);
  else
    cells.insert(cells.begin() + leaf.idx, std::move(cell));
  if (fits(cells)) {
    rebuild(p, P_LEAF, cells, 0, cells.size());
    return;
  }
  // split at the byte midpoint
  size_t total = cells_bytes(cells, 0, cells.size());
  size_t acc = 0, cut = 1;
  for (size_t i = 0; i < cells.size() - 1; i++) {
    acc += cells[i].size() + 2;
    if (acc >= total / 2) {
      cut = i + 1;
      break;
    }
  }
  uint32_t rpg = tx_alloc(t);
  rebuild(tx_writable(t, rpg), P_LEAF, cells, cut, cells.size());
  rebuild(p, P_LEAF, cells, 0, cut);
  std::string sep(leaf_view(cell_at(tx_page(t, rpg), 0)).key);
  branch_insert(t, root, path, static_cast<int>(path.size()) - 2,
                std::move(sep), rpg);
}

void branch_insert(Txn* t, uint32_t* root, Path& path, int level,
                   std::string sep, uint32_t right) {
  if (level < 0) {  // the root itself split: grow the tree by one level
    uint32_t npg = tx_alloc(t);
    std::vector<std::string> cells;
    cells.push_back(make_branch_cell("", path[0].pgno));
    cells.push_back(make_branch_cell(sep, right));
    rebuild(tx_writable(t, npg), P_BRANCH, cells, 0, cells.size());
    *root = npg;
    return;
  }
  PathEnt& ent = path[level];
  uint8_t* p = tx_writable(t, ent.pgno);
  auto cells = explode(p);
  cells.insert(cells.begin() + ent.idx + 1, make_branch_cell(sep, right));
  if (fits(cells)) {
    rebuild(p, P_BRANCH, cells, 0, cells.size());
    return;
  }
  size_t total = cells_bytes(cells, 0, cells.size());
  size_t acc = 0, cut = 1;
  for (size_t i = 0; i < cells.size() - 1; i++) {
    acc += cells[i].size() + 2;
    if (acc >= total / 2) {
      cut = i + 1;
      break;
    }
  }
  uint32_t rpg = tx_alloc(t);
  rebuild(tx_writable(t, rpg), P_BRANCH, cells, cut, cells.size());
  rebuild(p, P_BRANCH, cells, 0, cut);
  std::string up(branch_key(cell_at(tx_page(t, rpg), 0)));
  branch_insert(t, root, path, level - 1, std::move(up), rpg);
}

void tree_remove_at(Txn* t, uint32_t* root, Path& path) {
  int level = static_cast<int>(path.size()) - 1;
  while (level >= 0) {
    PathEnt& ent = path[level];
    uint8_t* p = tx_writable(t, ent.pgno);
    auto cells = explode(p);
    cells.erase(cells.begin() + ent.idx);
    if (!cells.empty()) {
      rebuild(p, hdr(p)->type, cells, 0, cells.size());
      break;
    }
    tx_free(t, ent.pgno);
    if (level == 0) {
      *root = 0;
      return;
    }
    level--;
  }
  // collapse a single-child root chain
  while (*root) {
    const uint8_t* p = tx_page(t, *root);
    if (hdr(p)->type != P_BRANCH || hdr(p)->n_cells != 1) break;
    uint32_t child = branch_child(cell_at(p, 0));
    tx_free(t, *root);
    *root = child;
  }
}

// -- dup payload helpers ------------------------------------------------------

std::vector<std::string> dup_unpack(const uint8_t* payload, uint32_t psz) {
  std::vector<std::string> out;
  uint32_t count = g32(payload);
  const uint8_t* p = payload + 4;
  const uint8_t* end = payload + psz;
  for (uint32_t i = 0; i < count && p + 2 <= end; i++) {
    uint16_t len = g16(p);
    p += 2;
    out.emplace_back(reinterpret_cast<const char*>(p), len);
    p += len;
  }
  return out;
}

std::string dup_pack(const std::vector<std::string>& dups) {
  std::string out(4, '\0');
  s32(reinterpret_cast<uint8_t*>(out.data()),
      static_cast<uint32_t>(dups.size()));
  for (auto& d : dups) {
    char lb[2];
    s16(reinterpret_cast<uint8_t*>(lb), static_cast<uint16_t>(d.size()));
    out.append(lb, 2);
    out.append(d);
  }
  return out;
}

// -- tables (catalog) ---------------------------------------------------------

constexpr uint32_t TI_SIZE = 12;  // u32 root | u64 count

TableInfo* tx_table(Txn* t, const std::string& name, bool create) {
  auto it = t->tables.find(name);
  if (it != t->tables.end()) return &it->second;
  // look up in the catalog tree of the snapshot
  Path path;
  bool exact;
  uint32_t root = t->snap.catalog_root;
  TableInfo info;
  if (root && tree_descend(t, &root, name, path, false, &exact) && exact) {
    LeafView v = leaf_view(cell_at(tx_page(t, path.back().pgno),
                                   path.back().idx));
    info.root = g32(v.payload);
    info.count = g64(v.payload + 4);
  } else if (!create) {
    return nullptr;
  }
  auto [ins, _] = t->tables.emplace(name, info);
  return &ins->second;
}

// -- high-level get/put/del over one table tree -------------------------------

// Frees any auxiliary storage (overflow chain / dup subtree) of a leaf cell.
void free_aux(Txn* t, const LeafView& v) {
  if (v.flags == L_OVERFLOW) {
    ov_free(t, g32(v.payload));
  } else if (v.flags == L_DUPTREE) {
    // free the whole subtree
    uint32_t sub = g32(v.payload);
    std::vector<uint32_t> stack{sub};
    while (!stack.empty()) {
      uint32_t pg = stack.back();
      stack.pop_back();
      if (!pg) continue;
      const uint8_t* p = tx_page(t, pg);
      if (hdr(p)->type == P_BRANCH)
        for (int i = 0; i < hdr(p)->n_cells; i++)
          stack.push_back(branch_child(cell_at(p, i)));
      tx_free(t, pg);
    }
  }
}

std::string plain_cell(Txn* t, std::string_view key, const uint8_t* val,
                       uint32_t vlen) {
  if (8 + key.size() + vlen <= MAXCELL)
    return make_leaf_cell(L_INLINE, key, vlen, val, vlen);
  uint32_t ov = ov_write(t, val, vlen);
  uint8_t pb[4];
  s32(pb, ov);
  return make_leaf_cell(L_OVERFLOW, key, vlen, pb, 4);
}

// insert into a dup subtree; returns true when a new entry was added
bool subtree_put(Txn* t, uint32_t* sub, std::string_view val) {
  Path path;
  bool exact;
  tree_descend(t, sub, val, path, *sub != 0, &exact);
  if (exact) return false;
  std::string cell = make_leaf_cell(L_INLINE, val, 0, nullptr, 0);
  if (!*sub) {
    *sub = tx_alloc(t);
    uint8_t* p = tx_writable(t, *sub);
    std::vector<std::string> cells{std::move(cell)};
    rebuild(p, P_LEAF, cells, 0, cells.size());
    return true;
  }
  leaf_put_cell(t, sub, path, std::move(cell), false);
  return true;
}

bool subtree_del(Txn* t, uint32_t* sub, std::string_view val) {
  Path path;
  bool exact;
  if (!tree_descend(t, sub, val, path, *sub != 0, &exact) || !exact)
    return false;
  tree_remove_at(t, sub, path);
  return true;
}

bool table_put(Txn* t, TableInfo* ti, std::string_view key,
               std::string_view val, bool dupsort) {
  Path path;
  bool exact;
  tree_descend(t, &ti->root, key, path, ti->root != 0, &exact);
  ti->dirty = true;
  const uint8_t* vp = reinterpret_cast<const uint8_t*>(val.data());
  uint32_t vlen = static_cast<uint32_t>(val.size());

  if (!exact) {
    std::string cell;
    if (dupsort) {
      std::vector<std::string> dups{std::string(val)};
      std::string payload = dup_pack(dups);
      cell = make_leaf_cell(L_DUPIN, key, static_cast<uint32_t>(payload.size()),
                            payload.data(), static_cast<uint32_t>(payload.size()));
    } else {
      cell = plain_cell(t, key, vp, vlen);
    }
    if (!ti->root) {
      ti->root = tx_alloc(t);
      std::vector<std::string> cells{std::move(cell)};
      rebuild(tx_writable(t, ti->root), P_LEAF, cells, 0, cells.size());
    } else {
      leaf_put_cell(t, &ti->root, path, std::move(cell), false);
    }
    ti->count += 1;
    return true;
  }

  LeafView old = leaf_view(cell_at(tx_page(t, path.back().pgno),
                                   path.back().idx));
  if (!dupsort) {
    // plain put replaces everything under the key (matches kvstore.cpp)
    uint64_t old_n = 1;
    if (old.flags == L_DUPIN)
      old_n = g32(old.payload);
    else if (old.flags == L_DUPTREE)
      old_n = g64(old.payload + 4);
    free_aux(t, old);
    leaf_put_cell(t, &ti->root, path, plain_cell(t, key, vp, vlen), true);
    ti->count += 1 - old_n;
    return true;
  }

  // dupsort insert into an existing cell
  if (old.flags == L_DUPTREE) {
    uint32_t sub = g32(old.payload);
    uint64_t cnt = g64(old.payload + 4);
    if (subtree_put(t, &sub, val)) cnt++, ti->count++;
    uint8_t pb[12];
    s32(pb, sub);
    s64(pb + 4, cnt);
    leaf_put_cell(t, &ti->root, path,
                  make_leaf_cell(L_DUPTREE, key, 12, pb, 12), true);
    return true;
  }
  std::vector<std::string> dups;
  if (old.flags == L_DUPIN) {
    dups = dup_unpack(old.payload, old.payload_sz);
  } else {  // plain value becomes the first duplicate
    std::string prior;
    if (old.flags == L_OVERFLOW) {
      ov_read(t, g32(old.payload), prior);
    } else {
      prior.assign(reinterpret_cast<const char*>(old.payload), old.vlen);
    }
    // a duplicate must fit a leaf/subtree cell; refuse the conversion of
    // an oversized plain value instead of corrupting a page
    if (8 + prior.size() > MAXCELL) return false;
    if (old.flags == L_OVERFLOW) free_aux(t, old);
    dups.push_back(std::move(prior));
  }
  auto pos = std::lower_bound(dups.begin(), dups.end(), std::string(val));
  if (pos != dups.end() && *pos == val) {
    return true;  // already present
  }
  dups.insert(pos, std::string(val));
  ti->count += 1;
  std::string payload = dup_pack(dups);
  if (8 + key.size() + payload.size() <= MAXCELL &&
      payload.size() <= DUP_SPILL + 4) {
    leaf_put_cell(t, &ti->root, path,
                  make_leaf_cell(L_DUPIN, key,
                                 static_cast<uint32_t>(payload.size()),
                                 payload.data(),
                                 static_cast<uint32_t>(payload.size())),
                  true);
  } else {  // spill to a subtree
    uint32_t sub = 0;
    for (auto& d : dups) subtree_put(t, &sub, d);
    uint8_t pb[12];
    s32(pb, sub);
    s64(pb + 4, dups.size());
    leaf_put_cell(t, &ti->root, path,
                  make_leaf_cell(L_DUPTREE, key, 12, pb, 12), true);
  }
  return true;
}

// Whether a delete finds what it removes: the key and, for a dup delete,
// that value under it, looked up by read-only descents. A write descent
// copies every page on its path, the table's root and a dup subtree's root
// among them, and frees the originals; a delete that then found nothing
// would return without marking the table dirty, and the catalog would keep
// the freed root. So table_del descends for write only after this.
bool del_finds(Txn* t, uint32_t root, std::string_view key,
               const std::string* val) {
  Path path;
  bool exact;
  if (!tree_descend(t, &root, key, path, false, &exact) || !exact)
    return false;
  if (val == nullptr) return true;
  LeafView v = leaf_view(cell_at(tx_page(t, path.back().pgno),
                                 path.back().idx));
  if (v.flags == L_DUPTREE) {
    uint32_t sub = g32(v.payload);
    return tree_descend(t, &sub, *val, path, false, &exact) && exact;
  }
  if (v.flags == L_DUPIN) {
    std::vector<std::string> dups = dup_unpack(v.payload, v.payload_sz);
    return std::binary_search(dups.begin(), dups.end(), *val);
  }
  std::string prior;
  if (v.flags == L_OVERFLOW)
    ov_read(t, g32(v.payload), prior);
  else
    prior.assign(reinterpret_cast<const char*>(v.payload), v.vlen);
  return prior == *val;
}

bool table_del(Txn* t, TableInfo* ti, std::string_view key,
               const std::string* val) {
  Path path;
  bool exact;
  if (!del_finds(t, ti->root, key, val)) return false;
  tree_descend(t, &ti->root, key, path, true, &exact);
  LeafView v = leaf_view(cell_at(tx_page(t, path.back().pgno),
                                 path.back().idx));
  uint64_t n = (v.flags == L_DUPIN)     ? g32(v.payload)
               : (v.flags == L_DUPTREE) ? g64(v.payload + 4)
                                        : 1;
  if (val == nullptr) {
    free_aux(t, v);
    tree_remove_at(t, &ti->root, path);
    ti->count -= n;
    ti->dirty = true;
    return true;
  }
  if (v.flags == L_DUPTREE) {
    uint32_t sub = g32(v.payload);
    if (!subtree_del(t, &sub, *val)) return false;
    ti->count -= 1;
    ti->dirty = true;
    if (n - 1 == 0 || sub == 0) {
      tree_remove_at(t, &ti->root, path);
    } else {
      uint8_t pb[12];
      s32(pb, sub);
      s64(pb + 4, n - 1);
      leaf_put_cell(t, &ti->root, path,
                    make_leaf_cell(L_DUPTREE, key, 12, pb, 12), true);
    }
    return true;
  }
  std::vector<std::string> dups;
  if (v.flags == L_DUPIN) {
    dups = dup_unpack(v.payload, v.payload_sz);
  } else {
    std::string prior;
    if (v.flags == L_OVERFLOW)
      ov_read(t, g32(v.payload), prior);
    else
      prior.assign(reinterpret_cast<const char*>(v.payload), v.vlen);
    dups.push_back(std::move(prior));
  }
  auto pos = std::lower_bound(dups.begin(), dups.end(), *val);
  if (pos == dups.end() || *pos != *val) return false;
  dups.erase(pos);
  ti->count -= 1;
  ti->dirty = true;
  if (dups.empty()) {
    free_aux(t, v);
    tree_remove_at(t, &ti->root, path);
    return true;
  }
  std::string payload = dup_pack(dups);
  free_aux(t, v);
  leaf_put_cell(t, &ti->root, path,
                make_leaf_cell(L_DUPIN, key,
                               static_cast<uint32_t>(payload.size()),
                               payload.data(),
                               static_cast<uint32_t>(payload.size())),
                true);
  return true;
}

// -- env open/commit ----------------------------------------------------------

bool read_meta(Env* env, int slot, Meta* out) {
  Meta m;
  if (pread(env->fd, &m, sizeof(m), slot * PAGE) != sizeof(m)) return false;
  if (m.magic != MAGIC || m.version != VERSION) return false;
  if (meta_sum(m) != m.checksum) return false;
  *out = m;
  return true;
}

bool write_meta(Env* env, const Meta& m) {
  Meta out = m;
  out.checksum = meta_sum(out);
  int slot = static_cast<int>(m.txnid & 1);
  if (pwrite(env->fd, &out, sizeof(out), slot * PAGE) != sizeof(out))
    return false;
  return fdatasync(env->fd) == 0;
}

// Map the data file over the reservation up to ``bytes`` (rounded up to
// MAP_CHUNK). Called by the writer only (at open and at commit, before the
// new meta is published), so readers never reach past what is mapped.
bool env_map_to(Env* env, uint64_t bytes) {
  if (bytes <= env->mapped) return true;
  uint64_t want = (bytes + MAP_CHUNK - 1) / MAP_CHUNK * MAP_CHUNK;
  if (want > MAPSIZE) return false;
  void* p = mmap(env->map + env->mapped, want - env->mapped, PROT_READ,
                 MAP_SHARED | MAP_FIXED, env->fd, static_cast<off_t>(env->mapped));
  if (p == MAP_FAILED) return false;
  env->mapped = want;
  return true;
}

Env* env_open(const std::string& dir) {
  std::string path = dir + "/data.rtpg";
  int fd = ::open(path.c_str(), O_RDWR | O_CREAT | O_CLOEXEC, 0644);
  if (fd < 0) return nullptr;
  auto env = std::make_unique<Env>();
  env->fd = fd;
  env->dir = dir;
  struct stat st{};
  fstat(fd, &st);
  if (st.st_size < static_cast<off_t>(2 * PAGE)) {
    if (ftruncate(fd, 2 * PAGE) != 0) return nullptr;
    Meta m{};
    m.magic = MAGIC;
    m.version = VERSION;
    m.txnid = 0;
    m.n_pages = 2;
    if (!write_meta(env.get(), m)) return nullptr;
    env->meta = m;
  } else {
    Meta m0, m1;
    bool ok0 = read_meta(env.get(), 0, &m0);
    bool ok1 = read_meta(env.get(), 1, &m1);
    if (!ok0 && !ok1) return nullptr;
    env->meta = (!ok1 || (ok0 && m0.txnid > m1.txnid)) ? m0 : m1;
  }
  env->map = static_cast<uint8_t*>(
      mmap(nullptr, MAPSIZE, PROT_NONE, MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE,
           -1, 0));
  if (env->map == MAP_FAILED) return nullptr;
  fstat(fd, &st);
  if (!env_map_to(env.get(), static_cast<uint64_t>(st.st_size))) return nullptr;
  // load the persisted free list (no readers at open: all reusable)
  uint32_t pg = env->meta.freelist_head;
  while (pg) {
    const uint8_t* p = env->map + static_cast<uint64_t>(pg) * PAGE;
    uint16_t n = g16(p + 2);
    for (uint16_t i = 0; i < n; i++)
      env->reusable.push_back(g32(p + 8 + 4 * i));
    env->freelist_pages.push_back(pg);
    pg = g32(p + 4);
  }
  return env.release();
}

int tx_commit(Txn* t) {
  Env* env = t->env;
  // 1. flush table-info updates into the catalog tree
  for (auto& [name, info] : t->tables) {
    if (!info.dirty) continue;
    Path path;
    bool exact;
    uint32_t root = t->snap.catalog_root;
    tree_descend(t, &root, name, path, root != 0, &exact);
    uint8_t pb[TI_SIZE];
    s32(pb, info.root);
    s64(pb + 4, info.count);
    std::string cell = make_leaf_cell(L_INLINE, name, TI_SIZE, pb, TI_SIZE);
    if (!root) {
      root = tx_alloc(t);
      std::vector<std::string> cells{std::move(cell)};
      rebuild(tx_writable(t, root), P_LEAF, cells, 0, cells.size());
    } else {
      leaf_put_cell(t, &root, path, std::move(cell), exact);
    }
    t->snap.catalog_root = root;
  }
  // 2. free candidates for the NEXT version: data pages freed this txn plus
  //    the chain pages of the free list we are about to replace
  std::vector<uint32_t> newly_freed = t->freed;
  std::vector<uint32_t> persist;
  {
    std::lock_guard<std::mutex> g(env->state_mu);
    newly_freed.insert(newly_freed.end(), env->freelist_pages.begin(),
                       env->freelist_pages.end());
    persist = env->reusable;
    for (auto& [_, pages] : env->pending)
      persist.insert(persist.end(), pages.begin(), pages.end());
  }
  persist.insert(persist.end(), newly_freed.begin(), newly_freed.end());
  persist.insert(persist.end(), t->recycle.begin(), t->recycle.end());
  // 3. serialize the free list into fresh chain pages (allocated at the end
  //    so they never collide with any referenced page)
  constexpr uint32_t PER = (PAGE - 8) / 4;
  std::vector<uint32_t> chain;
  uint64_t nchain = (persist.size() + PER - 1) / PER;
  for (uint64_t i = 0; i < nchain; i++)
    chain.push_back(static_cast<uint32_t>(t->next_page++));
  std::vector<std::unique_ptr<uint8_t[]>> chain_bufs;
  for (uint64_t i = 0; i < nchain; i++) {
    auto buf = std::make_unique<uint8_t[]>(PAGE);
    memset(buf.get(), 0, PAGE);
    buf[0] = P_FREE;
    uint32_t start = static_cast<uint32_t>(i * PER);
    uint32_t n = std::min<uint32_t>(PER,
                                    static_cast<uint32_t>(persist.size()) - start);
    s16(buf.get() + 2, static_cast<uint16_t>(n));
    s32(buf.get() + 4, i + 1 < nchain ? chain[i + 1] : 0);
    for (uint32_t j = 0; j < n; j++)
      s32(buf.get() + 8 + 4 * j, persist[start + j]);
    chain_bufs.push_back(std::move(buf));
  }
  // 4. grow the file, write everything, sync, flip the meta
  if (ftruncate(env->fd, static_cast<off_t>(t->next_page * PAGE)) != 0)
    return -1;
  for (auto& [pgno, buf] : t->dirty) {
    if (pwrite(env->fd, buf.get(), PAGE,
               static_cast<off_t>(pgno) * PAGE) != PAGE)
      return -1;
  }
  for (uint64_t i = 0; i < nchain; i++) {
    if (pwrite(env->fd, chain_bufs[i].get(), PAGE,
               static_cast<off_t>(chain[i]) * PAGE) != PAGE)
      return -1;
  }
  if (fdatasync(env->fd) != 0) return -1;
  if (!env_map_to(env, t->next_page * PAGE)) return -1;
  Meta m = t->snap;
  m.txnid += 1;
  m.n_pages = t->next_page;
  m.freelist_head = chain.empty() ? 0 : chain[0];
  m.freelist_len = persist.size();
  if (!write_meta(env, m)) return -1;
  {
    std::lock_guard<std::mutex> g(env->state_mu);
    env->meta = m;
    if (!newly_freed.empty()) env->pending.emplace_back(m.txnid, newly_freed);
    env->reusable.insert(env->reusable.end(), t->recycle.begin(),
                         t->recycle.end());
    env->freelist_pages = chain;
    drain_pending(env);
  }
  return 0;
}

// -- cursors ------------------------------------------------------------------
// Live-view cursors: every positioning/step operation resolves against the
// txn's current tree (dirty pages included), keyed by the cursor's (key,
// duplicate) position. This matches the MemDb semantics the contract tests
// pin down: a write txn's own mutations are visible to pre-existing cursors.

struct Cur {
  Txn* txn;
  std::string table;
  enum State : uint8_t { UNPOS, POS, EXH } state = UNPOS;
  std::string key;     // current key
  std::string dupval;  // current duplicate value
  std::string kbuf, vbuf;
};

// resolve the dup list of a leaf cell into (count); fills vector for inline
struct DupPos {
  bool is_tree;
  uint32_t sub;
  std::vector<std::string> inl;
  uint64_t count;
};

bool cell_dups(Txn* t, const LeafView& v, DupPos* out) {
  out->is_tree = false;
  out->sub = 0;
  out->inl.clear();
  if (v.flags == L_DUPIN) {
    out->inl = dup_unpack(v.payload, v.payload_sz);
    out->count = out->inl.size();
    return true;
  }
  if (v.flags == L_DUPTREE) {
    out->is_tree = true;
    out->sub = g32(v.payload);
    out->count = g64(v.payload + 4);
    return true;
  }
  // plain value acts as a single-element dup list
  if (v.flags == L_OVERFLOW) {
    std::string s;
    ov_read(t, g32(v.payload), s);
    out->inl.push_back(std::move(s));
  } else {
    out->inl.emplace_back(reinterpret_cast<const char*>(v.payload), v.vlen);
  }
  out->count = 1;
  return true;
}

int cur_emit(Cur* c, const uint8_t** k, uint32_t* kl, const uint8_t** v,
             uint32_t* vl) {
  c->kbuf = c->key;
  c->vbuf = c->dupval;
  *k = reinterpret_cast<const uint8_t*>(c->kbuf.data());
  *kl = static_cast<uint32_t>(c->kbuf.size());
  *v = reinterpret_cast<const uint8_t*>(c->vbuf.data());
  *vl = static_cast<uint32_t>(c->vbuf.size());
  return 1;
}

// subtree navigation: smallest value strictly greater than `after`
// (or >= `from` when ge), largest value strictly less, first, last
bool subtree_seek(Txn* t, uint32_t sub, std::string_view from, bool strict,
                  std::string* out) {
  Path path;
  bool exact;
  if (!sub) return false;
  tree_descend(t, &sub, from, path, false, &exact);
  if (exact && strict) {
    if (!path_step(t, path, +1)) return false;
  } else if (!exact) {
    // lower_bound position may be one past the leaf's cells
    const uint8_t* leaf = tx_page(t, path.back().pgno);
    if (path.back().idx >= hdr(leaf)->n_cells) {
      path.back().idx = hdr(leaf)->n_cells - 1;
      if (!path_step(t, path, +1)) return false;
    }
  }
  LeafView v =
      leaf_view(cell_at(tx_page(t, path.back().pgno), path.back().idx));
  *out = std::string(v.key);
  return true;
}

bool subtree_prev(Txn* t, uint32_t sub, std::string_view before,
                  std::string* out) {
  Path path;
  bool exact;
  if (!sub) return false;
  tree_descend(t, &sub, before, path, false, &exact);
  // position is lower_bound(before); the predecessor is one step back
  if (!path_step(t, path, -1)) return false;
  LeafView v =
      leaf_view(cell_at(tx_page(t, path.back().pgno), path.back().idx));
  *out = std::string(v.key);
  return true;
}

bool subtree_edge(Txn* t, uint32_t sub, bool last, std::string* out) {
  Path path;
  if (!sub) return false;
  descend_edge(t, sub, last, path);
  if (path.empty()) return false;
  LeafView v =
      leaf_view(cell_at(tx_page(t, path.back().pgno), path.back().idx));
  *out = std::string(v.key);
  return true;
}

// position the cursor on (key-at-path, first-or-last dup)
bool cur_land(Cur* c, Path& path, bool last_dup) {
  Txn* t = c->txn;
  LeafView v =
      leaf_view(cell_at(tx_page(t, path.back().pgno), path.back().idx));
  c->key = std::string(v.key);
  DupPos dp;
  cell_dups(t, v, &dp);
  if (dp.is_tree) {
    if (!subtree_edge(t, dp.sub, last_dup, &c->dupval)) return false;
  } else {
    if (dp.inl.empty()) return false;
    c->dupval = last_dup ? dp.inl.back() : dp.inl.front();
  }
  c->state = Cur::POS;
  return true;
}

// find the cursor's key cell in the live tree; nullptr if the key vanished
bool cur_find(Cur* c, Path& path, LeafView* v) {
  Txn* t = c->txn;
  TableInfo* ti = tx_table(t, c->table, false);
  if (!ti || !ti->root) return false;
  uint32_t root = ti->root;
  bool exact;
  tree_descend(t, &root, c->key, path, false, &exact);
  if (!exact) return false;
  *v = leaf_view(cell_at(tx_page(t, path.back().pgno), path.back().idx));
  return true;
}

}  // namespace

extern "C" {

void* rtpg_open(const char* dir) {
  if (!dir || !*dir) return nullptr;  // paged engine is persistent-only
  return env_open(dir);
}

void rtpg_close(void* envp) { delete static_cast<Env*>(envp); }

int rtpg_snapshot(void* envp) {  // durability point; commits already sync
  auto env = static_cast<Env*>(envp);
  return fdatasync(env->fd) == 0 ? 0 : -1;
}

int rtpg_sync(void* envp) {
  auto env = static_cast<Env*>(envp);
  return fdatasync(env->fd) == 0 ? 0 : -1;
}

void* rtpg_txn_begin(void* envp, int write) {
  auto env = static_cast<Env*>(envp);
  auto txn = new Txn();
  txn->env = env;
  txn->write = write != 0;
  if (write) {
    if (env->writer_owner == std::this_thread::get_id()) {
      delete txn;
      return nullptr;  // nested write txn on one thread
    }
    env->writer_mu.lock();
    env->writer_owner = std::this_thread::get_id();
  }
  {
    std::lock_guard<std::mutex> g(env->state_mu);
    txn->snap = env->meta;
    if (!write) env->readers.insert(txn->snap.txnid);
  }
  txn->next_page = txn->snap.n_pages;
  return txn;
}

static void reader_end(Txn* txn) {
  std::lock_guard<std::mutex> g(txn->env->state_mu);
  auto it = txn->env->readers.find(txn->snap.txnid);
  if (it != txn->env->readers.end()) txn->env->readers.erase(it);
}

int rtpg_put(void* txnp, const char* table, const uint8_t* key, uint32_t klen,
             const uint8_t* val, uint32_t vlen, int dupsort) {
  auto txn = static_cast<Txn*>(txnp);
  std::lock_guard<std::recursive_mutex> op_guard(txn->op_mu);
  if (!txn->write || klen > MAXKEY) return -1;
  if (dupsort && 8 + klen + vlen > MAXCELL) return -1;  // dup values stay small
  TableInfo* ti = tx_table(txn, table, true);
  return table_put(txn, ti,
                   std::string_view(reinterpret_cast<const char*>(key), klen),
                   std::string_view(
                       reinterpret_cast<const char*>(val ? val : key),
                       val ? vlen : 0),
                   dupsort != 0)
             ? 0
             : -1;
}

int rtpg_del(void* txnp, const char* table, const uint8_t* key, uint32_t klen,
             const uint8_t* val, uint32_t vlen, int have_val) {
  auto txn = static_cast<Txn*>(txnp);
  std::lock_guard<std::recursive_mutex> op_guard(txn->op_mu);
  if (!txn->write) return 0;
  TableInfo* ti = tx_table(txn, table, false);
  if (!ti) return 0;
  std::string v(reinterpret_cast<const char*>(val ? val : key),
                val ? vlen : 0);
  return table_del(txn, ti,
                   std::string_view(reinterpret_cast<const char*>(key), klen),
                   have_val ? &v : nullptr)
             ? 1
             : 0;
}

int rtpg_clear(void* txnp, const char* table) {
  auto txn = static_cast<Txn*>(txnp);
  std::lock_guard<std::recursive_mutex> op_guard(txn->op_mu);
  if (!txn->write) return -1;
  TableInfo* ti = tx_table(txn, table, false);
  if (!ti || !ti->root) return 0;
  // free every page of the tree (and aux chains/subtrees)
  std::vector<uint32_t> stack{ti->root};
  while (!stack.empty()) {
    uint32_t pg = stack.back();
    stack.pop_back();
    const uint8_t* p = tx_page(txn, pg);
    if (hdr(p)->type == P_BRANCH) {
      for (int i = 0; i < hdr(p)->n_cells; i++)
        stack.push_back(branch_child(cell_at(p, i)));
    } else {
      for (int i = 0; i < hdr(p)->n_cells; i++) {
        LeafView v = leaf_view(cell_at(p, i));
        free_aux(txn, v);
      }
    }
    tx_free(txn, pg);
  }
  ti->root = 0;
  ti->count = 0;
  ti->dirty = true;
  return 0;
}

int rtpg_get(void* txnp, const char* table, const uint8_t* key, uint32_t klen,
             const uint8_t** out, uint32_t* out_len) {
  auto txn = static_cast<Txn*>(txnp);
  std::lock_guard<std::recursive_mutex> op_guard(txn->op_mu);
  TableInfo* ti = tx_table(txn, table, false);
  if (!ti || !ti->root) return 0;
  uint32_t root = ti->root;
  Path path;
  bool exact;
  tree_descend(txn, &root,
               std::string_view(reinterpret_cast<const char*>(key), klen),
               path, false, &exact);
  if (!exact) return 0;
  LeafView v =
      leaf_view(cell_at(tx_page(txn, path.back().pgno), path.back().idx));
  if (v.flags == L_INLINE) {
    txn->valbuf.assign(reinterpret_cast<const char*>(v.payload), v.vlen);
  } else if (v.flags == L_OVERFLOW) {
    ov_read(txn, g32(v.payload), txn->valbuf);
  } else {  // dup cell: return the first duplicate
    DupPos dp;
    cell_dups(txn, v, &dp);
    if (dp.is_tree) {
      if (!subtree_edge(txn, dp.sub, false, &txn->valbuf)) return 0;
    } else {
      if (dp.inl.empty()) return 0;
      txn->valbuf = dp.inl.front();
    }
  }
  *out = reinterpret_cast<const uint8_t*>(txn->valbuf.data());
  *out_len = static_cast<uint32_t>(txn->valbuf.size());
  return 1;
}

uint64_t rtpg_entry_count(void* txnp, const char* table) {
  auto txn = static_cast<Txn*>(txnp);
  std::lock_guard<std::recursive_mutex> op_guard(txn->op_mu);
  TableInfo* ti = tx_table(txn, table, false);
  return ti ? ti->count : 0;
}

int rtpg_commit(void* txnp) {
  auto txn = static_cast<Txn*>(txnp);
  int rc = 0;
  if (txn->write) {
    rc = tx_commit(txn);
    txn->env->writer_owner = std::thread::id{};
    txn->env->writer_mu.unlock();
  } else {
    reader_end(txn);
  }
  delete txn;
  return rc;
}

void rtpg_abort(void* txnp) {
  auto txn = static_cast<Txn*>(txnp);
  if (txn->write) {
    std::lock_guard<std::mutex> g(txn->env->state_mu);
    txn->env->reusable.insert(txn->env->reusable.end(),
                              txn->took_reusable.begin(),
                              txn->took_reusable.end());
    txn->env->writer_owner = std::thread::id{};
    txn->env->writer_mu.unlock();
  } else {
    reader_end(txn);
  }
  delete txn;
}

void* rtpg_cursor(void* txnp, const char* table) {
  auto cur = new Cur();
  cur->txn = static_cast<Txn*>(txnp);
  cur->table = table;
  return cur;
}

void rtpg_cursor_close(void* curp) { delete static_cast<Cur*>(curp); }

int rtpg_cursor_first(void* curp, const uint8_t** k, uint32_t* kl,
                      const uint8_t** v, uint32_t* vl) {
  auto c = static_cast<Cur*>(curp);
  std::lock_guard<std::recursive_mutex> op_guard(c->txn->op_mu);
  TableInfo* ti = tx_table(c->txn, c->table, false);
  if (!ti || !ti->root) {
    c->state = Cur::EXH;
    return 0;
  }
  Path path;
  descend_edge(c->txn, ti->root, false, path);
  if (path.empty() || !cur_land(c, path, false)) {
    c->state = Cur::EXH;
    return 0;
  }
  return cur_emit(c, k, kl, v, vl);
}

int rtpg_cursor_last(void* curp, const uint8_t** k, uint32_t* kl,
                     const uint8_t** v, uint32_t* vl) {
  auto c = static_cast<Cur*>(curp);
  std::lock_guard<std::recursive_mutex> op_guard(c->txn->op_mu);
  TableInfo* ti = tx_table(c->txn, c->table, false);
  if (!ti || !ti->root) {
    c->state = Cur::EXH;
    return 0;
  }
  Path path;
  descend_edge(c->txn, ti->root, true, path);
  if (path.empty() || !cur_land(c, path, true)) {
    c->state = Cur::EXH;
    return 0;
  }
  return cur_emit(c, k, kl, v, vl);
}

int rtpg_cursor_seek(void* curp, const uint8_t* key, uint32_t klen, int exact,
                     const uint8_t** k, uint32_t* kl, const uint8_t** v,
                     uint32_t* vl) {
  auto c = static_cast<Cur*>(curp);
  std::lock_guard<std::recursive_mutex> op_guard(c->txn->op_mu);
  c->state = Cur::EXH;
  TableInfo* ti = tx_table(c->txn, c->table, false);
  if (!ti || !ti->root) return 0;
  uint32_t root = ti->root;
  Path path;
  bool ex;
  tree_descend(c->txn, &root,
               std::string_view(reinterpret_cast<const char*>(key), klen),
               path, false, &ex);
  if (exact && !ex) return 0;
  if (!ex) {
    // lower_bound may point past the leaf's last cell: advance
    const uint8_t* leaf = tx_page(c->txn, path.back().pgno);
    if (path.back().idx >= hdr(leaf)->n_cells) {
      path.back().idx = hdr(leaf)->n_cells - 1;
      if (!path_step(c->txn, path, +1)) return 0;
    }
  }
  if (!cur_land(c, path, false)) return 0;
  return cur_emit(c, k, kl, v, vl);
}

int rtpg_cursor_next(void* curp, int skip_dups, const uint8_t** k,
                     uint32_t* kl, const uint8_t** v, uint32_t* vl) {
  auto c = static_cast<Cur*>(curp);
  std::lock_guard<std::recursive_mutex> op_guard(c->txn->op_mu);
  if (c->state == Cur::EXH) return 0;
  if (c->state == Cur::UNPOS) return rtpg_cursor_first(curp, k, kl, v, vl);
  Txn* t = c->txn;
  Path path;
  LeafView lv;
  bool have = cur_find(c, path, &lv);
  if (have && !skip_dups) {
    DupPos dp;
    cell_dups(t, lv, &dp);
    if (dp.is_tree) {
      std::string nxt;
      if (subtree_seek(t, dp.sub, c->dupval, true, &nxt)) {
        c->dupval = nxt;
        return cur_emit(c, k, kl, v, vl);
      }
    } else {
      auto pos = std::upper_bound(dp.inl.begin(), dp.inl.end(), c->dupval);
      if (pos != dp.inl.end()) {
        c->dupval = *pos;
        return cur_emit(c, k, kl, v, vl);
      }
    }
  }
  // move to the next key
  TableInfo* ti = tx_table(t, c->table, false);
  if (!ti || !ti->root) {
    c->state = Cur::EXH;
    return 0;
  }
  uint32_t root = ti->root;
  bool ex;
  tree_descend(t, &root, c->key, path, false, &ex);
  if (ex) {
    if (!path_step(t, path, +1)) {
      c->state = Cur::EXH;
      return 0;
    }
  } else {
    // current key vanished: lower_bound is already the next entry
    const uint8_t* leaf = tx_page(t, path.back().pgno);
    if (path.back().idx >= hdr(leaf)->n_cells) {
      path.back().idx = hdr(leaf)->n_cells - 1;
      if (!path_step(t, path, +1)) {
        c->state = Cur::EXH;
        return 0;
      }
    }
  }
  if (!cur_land(c, path, false)) {
    c->state = Cur::EXH;
    return 0;
  }
  return cur_emit(c, k, kl, v, vl);
}

int rtpg_cursor_prev(void* curp, const uint8_t** k, uint32_t* kl,
                     const uint8_t** v, uint32_t* vl) {
  auto c = static_cast<Cur*>(curp);
  std::lock_guard<std::recursive_mutex> op_guard(c->txn->op_mu);
  if (c->state == Cur::UNPOS) return 0;
  if (c->state == Cur::EXH) return rtpg_cursor_last(curp, k, kl, v, vl);
  Txn* t = c->txn;
  Path path;
  LeafView lv;
  bool have = cur_find(c, path, &lv);
  if (have) {
    DupPos dp;
    cell_dups(t, lv, &dp);
    if (dp.is_tree) {
      std::string prv;
      if (subtree_prev(t, dp.sub, c->dupval, &prv)) {
        c->dupval = prv;
        return cur_emit(c, k, kl, v, vl);
      }
    } else {
      auto pos = std::lower_bound(dp.inl.begin(), dp.inl.end(), c->dupval);
      if (pos != dp.inl.begin()) {
        c->dupval = *(pos - 1);
        return cur_emit(c, k, kl, v, vl);
      }
    }
  }
  // move to the previous key (lower_bound(cur_key) - 1 in the live tree)
  TableInfo* ti = tx_table(t, c->table, false);
  if (!ti || !ti->root) {
    c->state = Cur::UNPOS;
    return 0;
  }
  uint32_t root = ti->root;
  bool ex;
  tree_descend(t, &root, c->key, path, false, &ex);
  if (!path_step(t, path, -1)) {
    c->state = Cur::UNPOS;
    return 0;
  }
  if (!cur_land(c, path, true)) {
    c->state = Cur::UNPOS;
    return 0;
  }
  return cur_emit(c, k, kl, v, vl);
}

int rtpg_cursor_next_dup(void* curp, const uint8_t** k, uint32_t* kl,
                         const uint8_t** v, uint32_t* vl) {
  auto c = static_cast<Cur*>(curp);
  std::lock_guard<std::recursive_mutex> op_guard(c->txn->op_mu);
  if (c->state != Cur::POS) return 0;
  Path path;
  LeafView lv;
  if (!cur_find(c, path, &lv)) return 0;
  DupPos dp;
  cell_dups(c->txn, lv, &dp);
  if (dp.is_tree) {
    std::string nxt;
    if (!subtree_seek(c->txn, dp.sub, c->dupval, true, &nxt)) return 0;
    c->dupval = nxt;
    return cur_emit(c, k, kl, v, vl);
  }
  auto pos = std::upper_bound(dp.inl.begin(), dp.inl.end(), c->dupval);
  if (pos == dp.inl.end()) return 0;
  c->dupval = *pos;
  return cur_emit(c, k, kl, v, vl);
}

int rtpg_cursor_seek_dup(void* curp, const uint8_t* key, uint32_t klen,
                         const uint8_t* sub, uint32_t slen, const uint8_t** k,
                         uint32_t* kl, const uint8_t** v, uint32_t* vl) {
  auto c = static_cast<Cur*>(curp);
  std::lock_guard<std::recursive_mutex> op_guard(c->txn->op_mu);
  c->state = Cur::EXH;
  c->key.assign(reinterpret_cast<const char*>(key), klen);
  Path path;
  LeafView lv;
  if (!cur_find(c, path, &lv)) return 0;
  DupPos dp;
  cell_dups(c->txn, lv, &dp);
  std::string target(reinterpret_cast<const char*>(sub), slen);
  if (dp.is_tree) {
    std::string got;
    if (!subtree_seek(c->txn, dp.sub, target, false, &got)) return 0;
    c->dupval = got;
  } else {
    auto pos = std::lower_bound(dp.inl.begin(), dp.inl.end(), target);
    if (pos == dp.inl.end()) return 0;
    c->dupval = *pos;
  }
  c->state = Cur::POS;
  return cur_emit(c, k, kl, v, vl);
}

}  // extern "C"
