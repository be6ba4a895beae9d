// Native EVM wave executor: the nogil execution core behind BAL parallel
// block execution (reth_tpu/engine/bal.py).
//
// Reference analogue: revm v41 is the reference's native interpreter
// (reth Cargo.toml:430); this is the TPU-build equivalent for the flat
// transaction shapes that dominate blocks (value transfers and
// storage/compute contract calls without sub-calls). A WAVE of
// conflict-free transactions executes on real OS threads against an
// immutable snapshot table (accounts/slots/codes the Python side
// preloads from the BAL access hint); each thread keeps private write
// sets. Anything outside the snapshot or the supported opcode subset
// aborts that transaction with MISS and Python re-runs it through the
// full interpreter — the native path is an accelerator, never a
// semantics fork. Gas accounting mirrors reth_tpu/evm/interpreter.py's
// latest rule set exactly (EIP-2929 warm/cold, EIP-2200+3529 SSTORE,
// EIP-1153/5656, EIP-7623 floor precomputed by the caller).
//
// Protocol (little-endian):
//   snapshot: u32 n_acct {20B addr, u64 nonce, 32B balance BE, i32 code_id,
//             u8 exists}; u32 n_slot {20B, 32B key, 32B val BE};
//             u32 n_code {u32 len, bytes}
//   env: 20B coinbase, u64 number, u64 timestamp, u64 gas_limit,
//        32B base_fee BE, 32B prevrandao, u64 chain_id, 32B blob_base_fee BE
//   txs: u32 n {u32 index, 20B sender, u8 has_to, 20B to, 32B value BE,
//        u64 gas_limit, 32B eff_gas_price BE, 32B balance_fee_cap BE,
//        u64 intrinsic, u64 floor, u8 tx_type, u32 data_len, data,
//        u32 n_acl {20B, u32 n {32B}}}
//   result per tx: u32 index, u8 status(0 fail,1 ok,2 miss,3 not-run),
//        u8 mode(0 parallel,1 serial), u8 coinbase_sensitive,
//        u64 gas_used, 32B fee_delta BE,
//        u32 out_len, out, u32 n_logs {20B, u8 n_topics {32B}, u32 dlen,
//        data}, u32 n_acct_reads {20B}, u32 n_acct_writes {20B,
//        u8 deleted, u64 nonce, 32B balance BE},
//        u32 n_slot_reads {20B,32B}, u32 n_slot_writes {20B,32B,32B BE}

#include <array>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <map>
#include <mutex>
#include <set>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------- u256
struct U256 {
  uint64_t w[4];  // little-endian limbs
  bool operator==(const U256 &o) const {
    return w[0] == o.w[0] && w[1] == o.w[1] && w[2] == o.w[2] && w[3] == o.w[3];
  }
  bool operator!=(const U256 &o) const { return !(*this == o); }
  bool is_zero() const { return !(w[0] | w[1] | w[2] | w[3]); }
};
static const U256 ZERO = {{0, 0, 0, 0}};

static U256 from_u64(uint64_t v) { return U256{{v, 0, 0, 0}}; }

static U256 from_be(const uint8_t *p, size_t n = 32) {
  U256 r = ZERO;
  for (size_t i = 0; i < n; i++) {
    size_t bit = (n - 1 - i);          // byte significance
    r.w[bit / 8] |= (uint64_t)p[i] << (8 * (bit % 8));
  }
  return r;
}

static void to_be(const U256 &v, uint8_t *p) {
  for (int i = 0; i < 32; i++) {
    int bit = 31 - i;
    p[i] = (uint8_t)(v.w[bit / 8] >> (8 * (bit % 8)));
  }
}

static int cmp(const U256 &a, const U256 &b) {
  for (int i = 3; i >= 0; i--) {
    if (a.w[i] < b.w[i]) return -1;
    if (a.w[i] > b.w[i]) return 1;
  }
  return 0;
}

static U256 add(const U256 &a, const U256 &b) {
  U256 r; unsigned __int128 c = 0;
  for (int i = 0; i < 4; i++) {
    c += (unsigned __int128)a.w[i] + b.w[i];
    r.w[i] = (uint64_t)c; c >>= 64;
  }
  return r;
}

static U256 sub(const U256 &a, const U256 &b) {
  U256 r; __int128 br = 0;
  for (int i = 0; i < 4; i++) {
    __int128 d = (__int128)a.w[i] - b.w[i] - br;
    br = d < 0; if (d < 0) d += ((__int128)1 << 64);
    r.w[i] = (uint64_t)d;
  }
  return r;
}

static U256 mul(const U256 &a, const U256 &b) {
  uint64_t r[8] = {0};
  for (int i = 0; i < 4; i++) {
    unsigned __int128 c = 0;
    for (int j = 0; j + i < 4; j++) {
      c += (unsigned __int128)a.w[i] * b.w[j] + r[i + j];
      r[i + j] = (uint64_t)c; c >>= 64;
    }
  }
  return U256{{r[0], r[1], r[2], r[3]}};
}

static int bitlen(const U256 &a) {
  for (int i = 3; i >= 0; i--)
    if (a.w[i]) return 64 * i + 64 - __builtin_clzll(a.w[i]);
  return 0;
}

static U256 shl_bits(const U256 &a, unsigned s) {
  if (s >= 256) return ZERO;
  U256 r = ZERO; unsigned limb = s / 64, off = s % 64;
  for (int i = 3; i >= 0; i--) {
    uint64_t v = 0;
    if (i >= (int)limb) {
      v = a.w[i - limb] << off;
      if (off && i - (int)limb - 1 >= 0)
        v |= a.w[i - limb - 1] >> (64 - off);
    }
    r.w[i] = v;
  }
  return r;
}

static U256 shr_bits(const U256 &a, unsigned s) {
  if (s >= 256) return ZERO;
  U256 r = ZERO; unsigned limb = s / 64, off = s % 64;
  for (int i = 0; i < 4; i++) {
    uint64_t v = 0;
    if (i + limb < 4) {
      v = a.w[i + limb] >> off;
      if (off && i + limb + 1 < 4) v |= a.w[i + limb + 1] << (64 - off);
    }
    r.w[i] = v;
  }
  return r;
}

// restoring division: returns quotient, sets rem
static U256 divmod(const U256 &a, const U256 &b, U256 &rem) {
  rem = ZERO;
  if (b.is_zero()) { return ZERO; }
  U256 q = ZERO;
  int n = bitlen(a);
  for (int i = n - 1; i >= 0; i--) {
    rem = shl_bits(rem, 1);
    if ((a.w[i / 64] >> (i % 64)) & 1) rem.w[0] |= 1;
    if (cmp(rem, b) >= 0) {
      rem = sub(rem, b);
      q.w[i / 64] |= (uint64_t)1 << (i % 64);
    }
  }
  return q;
}

static bool is_neg(const U256 &a) { return a.w[3] >> 63; }
static U256 neg(const U256 &a) { return sub(ZERO, a); }

// ------------------------------------------------------------- keccak256
static const uint64_t KRC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

static inline uint64_t rotl(uint64_t x, int s) {
  return (x << s) | (x >> (64 - s));
}

static void keccak_f(uint64_t st[25]) {
  for (int round = 0; round < 24; round++) {
    uint64_t bc[5], t;
    for (int i = 0; i < 5; i++)
      bc[i] = st[i] ^ st[i + 5] ^ st[i + 10] ^ st[i + 15] ^ st[i + 20];
    for (int i = 0; i < 5; i++) {
      t = bc[(i + 4) % 5] ^ rotl(bc[(i + 1) % 5], 1);
      for (int j = 0; j < 25; j += 5) st[j + i] ^= t;
    }
    static const int rho[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3, 10, 43,
                                25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14};
    static const int pi[25] = {0,  10, 20, 5,  15, 16, 1,  11, 21, 6, 7, 17, 2,
                               12, 22, 23, 8,  18, 3,  13, 14, 24, 9, 19, 4};
    uint64_t tmp[25];
    for (int i = 0; i < 25; i++) tmp[pi[i]] = rotl(st[i], rho[i]);
    for (int j = 0; j < 25; j += 5) {
      uint64_t row[5];
      for (int i = 0; i < 5; i++) row[i] = tmp[j + i];
      for (int i = 0; i < 5; i++)
        st[j + i] = row[i] ^ ((~row[(i + 1) % 5]) & row[(i + 2) % 5]);
    }
    st[0] ^= KRC[round];
  }
}

static void keccak256(const uint8_t *data, size_t len, uint8_t out[32]) {
  uint64_t st[25] = {0};
  const size_t rate = 136;
  while (len >= rate) {
    for (size_t i = 0; i < rate / 8; i++) {
      uint64_t v; memcpy(&v, data + 8 * i, 8);
      st[i] ^= v;
    }
    keccak_f(st);
    data += rate; len -= rate;
  }
  uint8_t block[136] = {0};
  memcpy(block, data, len);
  block[len] = 0x01;
  block[135] |= 0x80;
  for (size_t i = 0; i < rate / 8; i++) {
    uint64_t v; memcpy(&v, block + 8 * i, 8);
    st[i] ^= v;
  }
  keccak_f(st);
  for (int i = 0; i < 4; i++) memcpy(out + 8 * i, &st[i], 8);
}

// ------------------------------------------------------------- snapshot
struct Addr {
  uint8_t b[20];
  bool operator<(const Addr &o) const { return memcmp(b, o.b, 20) < 0; }
  bool operator==(const Addr &o) const { return memcmp(b, o.b, 20) == 0; }
};
struct SlotKey {
  Addr a; uint8_t k[32];
  bool operator<(const SlotKey &o) const {
    int c = memcmp(a.b, o.a.b, 20);
    if (c) return c < 0;
    return memcmp(k, o.k, 32) < 0;
  }
};

struct AcctRec { uint64_t nonce; U256 balance; int32_t code_id; bool exists; };

struct Snapshot {
  std::map<Addr, AcctRec> accounts;
  std::map<SlotKey, U256> slots;
  std::vector<std::vector<uint8_t>> codes;
  std::vector<std::vector<uint8_t>> jumpdests;  // bitmap per code
};

// snapshot + writes committed by earlier transactions of this block;
// immutable while a wave's threads read it, mutated only between commits
struct BlockView {
  const Snapshot *snap;
  std::map<Addr, AcctRec> acct_overlay;   // exists=false records deletions
  std::map<SlotKey, U256> slot_overlay;

  const AcctRec *account(const Addr &a, bool &known) const {
    known = true;
    auto it = acct_overlay.find(a);
    if (it != acct_overlay.end()) return it->second.exists ? &it->second : nullptr;
    auto sit = snap->accounts.find(a);
    if (sit == snap->accounts.end()) { known = false; return nullptr; }
    return sit->second.exists ? &sit->second : nullptr;
  }
  bool slot(const SlotKey &k, U256 &out) const {
    auto it = slot_overlay.find(k);
    if (it != slot_overlay.end()) { out = it->second; return true; }
    auto sit = snap->slots.find(k);
    if (sit == snap->slots.end()) return false;
    out = sit->second;
    return true;
  }
};

struct Env {
  Addr coinbase; uint64_t number, timestamp, gas_limit;
  U256 base_fee, prevrandao, blob_base_fee; uint64_t chain_id;
};

struct AclEntry { Addr a; std::vector<std::array<uint8_t, 32>> slots; };
struct Tx {
  uint32_t index; Addr sender; bool has_to; Addr to; U256 value;
  uint64_t nonce, gas_limit; U256 eff_price, fee_cap;
  uint64_t intrinsic, floor; uint8_t tx_type;
  std::vector<uint8_t> data;
  std::vector<AclEntry> acl;
};

struct LogRec { Addr a; std::vector<std::array<uint8_t, 32>> topics; std::vector<uint8_t> data; };
struct AcctWrite { bool deleted; uint64_t nonce; U256 balance; };

struct TxResult {
  uint32_t index = 0;
  uint8_t status = 2;  // miss by default
  bool coinbase_sensitive = false;
  uint64_t gas_used = 0;
  U256 fee_delta = ZERO;
  std::vector<uint8_t> output;
  std::vector<LogRec> logs;
  std::set<Addr> acct_reads;
  std::map<Addr, AcctWrite> acct_writes;
  std::set<SlotKey> slot_reads;
  std::map<SlotKey, U256> slot_writes;
};

// ------------------------------------------------------------- execution
struct Miss {};   // thrown: outside snapshot / unsupported op
struct Halt {};   // exceptional halt: frame consumes all gas

class TxMachine {
 public:
  TxMachine(const BlockView &view, const Env &env, const Tx &tx, TxResult &res)
      : snap_(*view.snap), view_(view), env_(env), tx_(tx), res_(res) {}

  // per-tx mutable state layered over the snapshot
  std::map<Addr, AcctRec> acct_cache_;
  std::set<Addr> acct_dirty_, touched_;
  std::map<SlotKey, U256> slot_cache_, tx_original_;
  std::set<SlotKey> slot_dirty_;
  std::set<Addr> warm_accounts_;
  std::set<SlotKey> warm_slots_;
  std::map<SlotKey, U256> transient_;
  int64_t refund_ = 0;
  std::vector<LogRec> logs_;

  const AcctRec *account(const Addr &a, bool record = true) {
    if (record) {
      if (a == env_.coinbase) res_.coinbase_sensitive = true;
      res_.acct_reads.insert(a);
    }
    auto it = acct_cache_.find(a);
    if (it != acct_cache_.end()) return it->second.exists ? &it->second : nullptr;
    bool known;
    const AcctRec *base = view_.account(a, known);
    if (!known) throw Miss{};  // not preloaded
    AcctRec rec = base ? *base
                       : AcctRec{0, ZERO, -1, false};
    acct_cache_[a] = rec;
    auto &slot = acct_cache_[a];
    return slot.exists ? &slot : nullptr;
  }

  AcctRec &account_mut(const Addr &a) {
    account(a);  // populate cache (+ read record)
    acct_dirty_.insert(a);
    auto &rec = acct_cache_[a];
    if (!rec.exists) { rec.exists = true; rec.nonce = 0; rec.balance = ZERO; rec.code_id = -1; }
    return rec;
  }

  U256 balance_of(const Addr &a) {
    const AcctRec *r = account(a);
    return r ? r->balance : ZERO;
  }

  const std::vector<uint8_t> *code_of(const Addr &a) {
    const AcctRec *r = account(a);
    if (!r || r->code_id < 0) return nullptr;
    return &snap_.codes[r->code_id];
  }

  U256 sload(const Addr &a, const uint8_t k[32]) {
    SlotKey key{a, {}}; memcpy(key.k, k, 32);
    res_.slot_reads.insert(key);
    auto it = slot_cache_.find(key);
    if (it != slot_cache_.end()) return it->second;
    U256 v;
    if (!view_.slot(key, v)) throw Miss{};
    slot_cache_[key] = v;
    return v;
  }

  U256 original(const Addr &a, const uint8_t k[32]) {
    SlotKey key{a, {}}; memcpy(key.k, k, 32);
    auto it = tx_original_.find(key);
    if (it != tx_original_.end()) return it->second;
    return sload(a, k);
  }

  void sstore_val(const Addr &a, const uint8_t k[32], const U256 &v) {
    SlotKey key{a, {}}; memcpy(key.k, k, 32);
    U256 prev = sload(a, k);
    tx_original_.emplace(key, prev);
    slot_cache_[key] = v;
    slot_dirty_.insert(key);
  }

  bool warm_account(const Addr &a) {
    if (warm_accounts_.count(a)) return true;
    warm_accounts_.insert(a);
    return false;
  }
  bool warm_slot(const Addr &a, const uint8_t k[32]) {
    SlotKey key{a, {}}; memcpy(key.k, k, 32);
    if (warm_slots_.count(key)) return true;
    warm_slots_.insert(key);
    return false;
  }

  // gas constants mirroring evm/interpreter.py (latest rules)
  static const uint64_t G_WARM = 100, G_COLD_ACCT = 2600, G_COLD_SLOAD = 2100;
  static const uint64_t G_SSTORE_SET = 20000, G_SSTORE_RESET = 2900, R_CLEAR = 4800;

  bool run() {
    const Tx &tx = tx_;
    // validity (mirrors _execute_tx; failures => MISS so Python reproduces
    // the exact error on its serial retry path)
    const AcctRec *snd = account(tx.sender);
    uint64_t snd_nonce = snd ? snd->nonce : 0;
    U256 snd_bal = snd ? snd->balance : ZERO;
    if (snd && snd->code_id >= 0) throw Miss{};  // EIP-3607/7702 — python
    if (snd_nonce != tx.nonce) throw Miss{};  // python reproduces the error
    U256 max_cost = add(mul(from_u64(tx.gas_limit), tx.fee_cap), tx.value);
    if (cmp(snd_bal, max_cost) < 0) throw Miss{};
    if (tx.gas_limit < tx.intrinsic) throw Miss{};

    // buy gas + nonce
    AcctRec &s = account_mut(tx.sender);
    s.balance = sub(s.balance, mul(from_u64(tx.gas_limit), tx.eff_price));
    s.nonce += 1;
    touched_.insert(tx.sender);

    // warm init (EIP-2929 + 3651 + 7702 precompile range 1..17)
    warm_account(tx.sender);
    warm_account(env_.coinbase);
    for (int i = 1; i <= 17; i++) {
      Addr p{}; p.b[19] = (uint8_t)i;
      warm_accounts_.insert(p);
    }
    if (tx.has_to) warm_account(tx.to);
    for (const auto &e : tx.acl) {
      warm_accounts_.insert(e.a);
      for (const auto &sl : e.slots) {
        SlotKey key{e.a, {}}; memcpy(key.k, sl.data(), 32);
        warm_slots_.insert(key);
      }
    }

    if (!tx.has_to) throw Miss{};  // creation tx: python path
    // precompile target: python path
    bool zero19 = true;
    for (int i = 0; i < 19; i++) if (tx.to.b[i]) { zero19 = false; break; }
    if (zero19 && tx.to.b[19] >= 1 && tx.to.b[19] <= 17) throw Miss{};

    const AcctRec *to_rec = account(tx.to);
    const std::vector<uint8_t> *code =
        (to_rec && to_rec->code_id >= 0) ? &snap_.codes[to_rec->code_id]
                                         : nullptr;
    int32_t code_id = to_rec ? to_rec->code_id : -1;
    if (code && code->size() >= 3 && (*code)[0] == 0xEF && (*code)[1] == 0x01)
      throw Miss{};  // 7702 delegation designator — python path

    uint64_t gas = tx.gas_limit - tx.intrinsic;
    bool success = true;
    // value transfer
    if (!tx.value.is_zero()) {
      // balance re-check after gas purchase (matches _call_gen prologue)
      if (cmp(balance_of(tx.sender), tx.value) < 0) {
        success = false; gas = tx.gas_limit;  // top-level halt burns frame gas
        // matches python: _call_gen returns (False, frame.gas, b"") -> the
        // frame keeps its gas; gas_used = intrinsic only
        gas = tx.gas_limit - tx.intrinsic;
      } else {
        AcctRec &a = account_mut(tx.sender);
        a.balance = sub(a.balance, tx.value);
        AcctRec &b = account_mut(tx.to);
        b.balance = add(b.balance, tx.value);
        touched_.insert(tx.to);
      }
    }
    uint64_t gas_left = gas;
    if (success && code) {
      // snapshot for revert/halt: copy caches (txs are small; fine)
      auto save_acct = acct_cache_; auto save_dirty = acct_dirty_;
      auto save_touch = touched_;
      auto save_slots = slot_cache_; auto save_sdirty = slot_dirty_;
      auto save_orig = tx_original_; auto save_ref = refund_;
      auto save_logs = logs_.size();
      try {
        gas_left = interpret(*code, snap_.jumpdests[code_id], tx.to, gas);
      } catch (Halt &) {
        acct_cache_ = save_acct; acct_dirty_ = save_dirty;
        touched_ = save_touch;
        slot_cache_ = save_slots; slot_dirty_ = save_sdirty;
        tx_original_ = save_orig; refund_ = save_ref;
        logs_.resize(save_logs);
        success = false; gas_left = 0;
        res_.output.clear();
      } catch (RevertExc &r) {
        acct_cache_ = save_acct; acct_dirty_ = save_dirty;
        touched_ = save_touch;
        slot_cache_ = save_slots; slot_dirty_ = save_sdirty;
        tx_original_ = save_orig; refund_ = save_ref;
        logs_.resize(save_logs);
        success = false; gas_left = r.gas_left;
        res_.output = std::move(r.output);
      }
    }
    uint64_t gas_used = tx.gas_limit - gas_left;
    if (success) {
      uint64_t cap = gas_used / 5;  // EIP-3529
      uint64_t refund = refund_ > 0 ? (uint64_t)refund_ : 0;
      if (refund > cap) refund = cap;
      gas_used -= refund;
    }
    if (gas_used < tx.floor) gas_used = tx.floor;  // EIP-7623
    // refund unused gas; priority fee as a commutative delta
    AcctRec &fs = account_mut(tx.sender);
    fs.balance = add(fs.balance, mul(from_u64(tx.gas_limit - gas_used), tx.eff_price));
    U256 priority = cmp(tx.eff_price, env_.base_fee) > 0
                        ? sub(tx.eff_price, env_.base_fee) : ZERO;
    res_.fee_delta = mul(from_u64(gas_used), priority);
    // EIP-161 touched-empty deletion
    for (const Addr &a : touched_) {
      auto it = acct_cache_.find(a);
      if (it != acct_cache_.end() && it->second.exists &&
          it->second.nonce == 0 && it->second.balance.is_zero() &&
          it->second.code_id < 0) {
        it->second.exists = false;
        acct_dirty_.insert(a);
      }
    }
    res_.gas_used = gas_used;
    res_.status = success ? 1 : 0;
    res_.logs = std::move(logs_);
    for (const Addr &a : acct_dirty_) {
      const AcctRec &r = acct_cache_[a];
      res_.acct_writes[a] = AcctWrite{!r.exists, r.nonce, r.balance};
    }
    for (const SlotKey &k : slot_dirty_) res_.slot_writes[k] = slot_cache_[k];
    return true;
  }

 private:
  struct RevertExc { uint64_t gas_left; std::vector<uint8_t> output; };

  const Snapshot &snap_;
  const BlockView &view_;
  const Env &env_;
  const Tx &tx_;
  TxResult &res_;

  // one top-level frame (CALL/CREATE -> Miss)
  uint64_t interpret(const std::vector<uint8_t> &code,
                     const std::vector<uint8_t> &jd, const Addr &self,
                     uint64_t gas) {
    std::vector<U256> stack;
    stack.reserve(64);
    std::vector<uint8_t> mem;
    size_t pc = 0;
    const size_t n = code.size();

    auto use = [&](uint64_t amt) {
      if (gas < amt) throw Halt{};
      gas -= amt;
    };
    auto pop = [&]() -> U256 {
      if (stack.empty()) throw Halt{};
      U256 v = stack.back(); stack.pop_back(); return v;
    };
    auto push = [&](const U256 &v) {
      if (stack.size() >= 1024) throw Halt{};
      stack.push_back(v);
    };
    auto mem_expand = [&](uint64_t off, uint64_t size) {
      if (size == 0) return;
      uint64_t end = off + size;
      if (end > mem.size()) {
        uint64_t nw = (end + 31) / 32, ow = (mem.size() + 31) / 32;
        uint64_t cost = (3 * nw + nw * nw / 512) - (3 * ow + ow * ow / 512);
        use(cost);
        mem.resize(nw * 32, 0);
      }
    };
    auto check_off = [&](const U256 &v) -> uint64_t {
      // matches python: offsets/sizes above 2^32 halt when touched
      if (v.w[1] | v.w[2] | v.w[3] || v.w[0] > (1ULL << 32)) throw Halt{};
      return v.w[0];
    };

    while (pc < n) {
      uint8_t op = code[pc];
      pc++;
      if (op >= 0x5F && op <= 0x7F) {  // PUSH0..32
        unsigned len = op - 0x5F;
        use(len == 0 ? 2 : 3);
        if (stack.size() >= 1024) throw Halt{};
        U256 v = ZERO;
        if (len) {
          uint8_t buf[32] = {0};
          size_t avail = pc < n ? (n - pc < len ? n - pc : len) : 0;
          // truncated PUSH zero-pads on the RIGHT (execution-specs
          // buffer_read): the len-byte window starts at buf[32-len]
          memcpy(buf + (32 - len), code.data() + pc, avail);
          v = from_be(buf);
          pc += len;
        }
        push(v);
        continue;
      }
      if (op >= 0x80 && op <= 0x8F) {  // DUP
        use(3);
        unsigned i = op - 0x7F;
        if (stack.size() < i || stack.size() >= 1024) throw Halt{};
        stack.push_back(stack[stack.size() - i]);
        continue;
      }
      if (op >= 0x90 && op <= 0x9F) {  // SWAP
        use(3);
        unsigned i = op - 0x8F;
        if (stack.size() < i + 1) throw Halt{};
        std::swap(stack[stack.size() - 1], stack[stack.size() - 1 - i]);
        continue;
      }
      switch (op) {
        case 0x5B: use(1); break;  // JUMPDEST
        case 0x57: {  // JUMPI
          use(10);
          U256 dest = pop(), cond = pop();
          if (!cond.is_zero()) {
            if (dest.w[1] | dest.w[2] | dest.w[3] || dest.w[0] >= n ||
                !(jd[dest.w[0] / 8] & (1 << (dest.w[0] % 8))))
              throw Halt{};
            pc = dest.w[0];
          }
          break;
        }
        case 0x56: {  // JUMP
          use(8);
          U256 dest = pop();
          if (dest.w[1] | dest.w[2] | dest.w[3] || dest.w[0] >= n ||
              !(jd[dest.w[0] / 8] & (1 << (dest.w[0] % 8))))
            throw Halt{};
          pc = dest.w[0];
          break;
        }
        case 0x01: { use(3); U256 a = pop(), b = pop(); push(add(a, b)); break; }
        case 0x03: { use(3); U256 a = pop(), b = pop(); push(sub(a, b)); break; }
        case 0x02: { use(5); U256 a = pop(), b = pop(); push(mul(a, b)); break; }
        case 0x04: { use(5); U256 a = pop(), b = pop(); U256 r;
          push(b.is_zero() ? ZERO : divmod(a, b, r)); break; }
        case 0x06: { use(5); U256 a = pop(), b = pop(); U256 r;
          if (b.is_zero()) push(ZERO); else { divmod(a, b, r); push(r); } break; }
        case 0x05: {  // SDIV
          use(5); U256 a = pop(), b = pop();
          if (b.is_zero()) { push(ZERO); break; }
          bool na = is_neg(a), nb = is_neg(b);
          U256 ua = na ? neg(a) : a, ub = nb ? neg(b) : b, r;
          U256 q = divmod(ua, ub, r);
          push(na == nb ? q : neg(q));
          break;
        }
        case 0x07: {  // SMOD
          use(5); U256 a = pop(), b = pop();
          if (b.is_zero()) { push(ZERO); break; }
          bool na = is_neg(a);
          U256 ua = na ? neg(a) : a, ub = is_neg(b) ? neg(b) : b, r;
          divmod(ua, ub, r);
          push(na ? neg(r) : r);
          break;
        }
        case 0x08: case 0x09: {  // ADDMOD / MULMOD — python path (512-bit)
          throw Miss{};
        }
        case 0x0A: {  // EXP
          U256 a = pop(), e = pop();
          use(10 + 50 * (uint64_t)((bitlen(e) + 7) / 8));
          U256 r = from_u64(1), base = a, ex = e;
          while (!ex.is_zero()) {
            if (ex.w[0] & 1) r = mul(r, base);
            base = mul(base, base);
            ex = shr_bits(ex, 1);
          }
          push(r);
          break;
        }
        case 0x0B: {  // SIGNEXTEND
          use(5); U256 b = pop(), x = pop();
          if (b.w[1] | b.w[2] | b.w[3] || b.w[0] >= 31) { push(x); break; }
          unsigned bit = 8 * (b.w[0] + 1) - 1;
          bool set = (x.w[bit / 64] >> (bit % 64)) & 1;
          U256 maskv = shl_bits(U256{{~0ULL, ~0ULL, ~0ULL, ~0ULL}}, bit + 1);
          U256 r;
          for (int i = 0; i < 4; i++)
            r.w[i] = set ? (x.w[i] | maskv.w[i]) : (x.w[i] & ~maskv.w[i]);
          push(r);
          break;
        }
        case 0x10: { use(3); U256 a = pop(), b = pop(); push(from_u64(cmp(a, b) < 0)); break; }
        case 0x11: { use(3); U256 a = pop(), b = pop(); push(from_u64(cmp(a, b) > 0)); break; }
        case 0x12: {  // SLT
          use(3); U256 a = pop(), b = pop();
          bool na = is_neg(a), nb = is_neg(b);
          bool r = na != nb ? na : cmp(a, b) < 0;
          push(from_u64(r)); break;
        }
        case 0x13: {  // SGT
          use(3); U256 a = pop(), b = pop();
          bool na = is_neg(a), nb = is_neg(b);
          bool r = na != nb ? nb : cmp(a, b) > 0;
          push(from_u64(r)); break;
        }
        case 0x14: { use(3); U256 a = pop(), b = pop(); push(from_u64(a == b)); break; }
        case 0x15: { use(3); push(from_u64(pop().is_zero())); break; }
        case 0x16: { use(3); U256 a = pop(), b = pop(); U256 r;
          for (int i=0;i<4;i++) r.w[i]=a.w[i]&b.w[i]; push(r); break; }
        case 0x17: { use(3); U256 a = pop(), b = pop(); U256 r;
          for (int i=0;i<4;i++) r.w[i]=a.w[i]|b.w[i]; push(r); break; }
        case 0x18: { use(3); U256 a = pop(), b = pop(); U256 r;
          for (int i=0;i<4;i++) r.w[i]=a.w[i]^b.w[i]; push(r); break; }
        case 0x19: { use(3); U256 a = pop(); U256 r;
          for (int i=0;i<4;i++) r.w[i]=~a.w[i]; push(r); break; }
        case 0x1A: {  // BYTE
          use(3); U256 i = pop(), x = pop();
          if (i.w[1] | i.w[2] | i.w[3] || i.w[0] >= 32) { push(ZERO); break; }
          unsigned bit = 8 * (31 - i.w[0]);
          push(from_u64((x.w[bit / 64] >> (bit % 64)) & 0xFF));
          break;
        }
        case 0x1B: { use(3); U256 s = pop(), x = pop();
          push(s.w[1]|s.w[2]|s.w[3]||s.w[0]>=256 ? ZERO : shl_bits(x, s.w[0])); break; }
        case 0x1C: { use(3); U256 s = pop(), x = pop();
          push(s.w[1]|s.w[2]|s.w[3]||s.w[0]>=256 ? ZERO : shr_bits(x, s.w[0])); break; }
        case 0x1D: {  // SAR
          use(3); U256 s = pop(), x = pop();
          bool nx = is_neg(x);
          if (s.w[1]|s.w[2]|s.w[3]||s.w[0] >= 256) {
            push(nx ? U256{{~0ULL,~0ULL,~0ULL,~0ULL}} : ZERO); break;
          }
          U256 r = shr_bits(x, s.w[0]);
          if (nx && s.w[0]) {
            U256 maskv = shl_bits(U256{{~0ULL,~0ULL,~0ULL,~0ULL}}, 256 - s.w[0]);
            for (int i=0;i<4;i++) r.w[i] |= maskv.w[i];
          }
          push(r);
          break;
        }
        case 0x20: {  // KECCAK256
          U256 off = pop(), size = pop();
          uint64_t sz = check_off(size);
          use(30 + 6 * ((sz + 31) / 32));
          uint64_t o = 0;
          if (sz) { o = check_off(off); mem_expand(o, sz); }
          uint8_t h[32];
          static const uint8_t kdummy = 0;
          keccak256(sz ? mem.data() + o : &kdummy, sz, h);
          push(from_be(h));
          break;
        }
        case 0x30: { use(2); push(addr_word(self)); break; }
        case 0x31: {  // BALANCE
          U256 a = pop(); Addr ad = word_addr(a);
          use(warm_account(ad) ? G_WARM : G_COLD_ACCT);
          push(balance_of(ad));
          break;
        }
        case 0x32: { use(2); push(addr_word(tx_.sender)); break; }  // ORIGIN
        case 0x33: { use(2); push(addr_word(tx_.sender)); break; }  // CALLER (top frame)
        case 0x34: { use(2); push(tx_.value); break; }
        case 0x35: {  // CALLDATALOAD
          use(3); U256 iv = pop();
          if (iv.w[1]|iv.w[2]|iv.w[3] || iv.w[0] >= tx_.data.size()) { push(ZERO); break; }
          uint8_t buf[32] = {0};
          size_t i = iv.w[0];
          size_t avail = tx_.data.size() - i < 32 ? tx_.data.size() - i : 32;
          memcpy(buf, tx_.data.data() + i, avail);
          push(from_be(buf));
          break;
        }
        case 0x36: { use(2); push(from_u64(tx_.data.size())); break; }
        case 0x37: {  // CALLDATACOPY
          U256 d = pop(), s = pop(), size = pop();
          uint64_t sz = check_off(size);
          use(3 + 3 * ((sz + 31) / 32));
          if (sz == 0) break;
          uint64_t dd = check_off(d);
          mem_expand(dd, sz);
          // clamp ss >= data.size() to zero-fill: `ss + i` wraps uint64
          // for src offsets near 2^64 and would read real calldata
          uint64_t ss = s.w[1]|s.w[2]|s.w[3] ? ~0ULL : s.w[0];
          uint64_t avail =
              ss < tx_.data.size() ? tx_.data.size() - ss : 0;
          for (uint64_t i = 0; i < sz; i++)
            mem[dd + i] = i < avail ? tx_.data[ss + i] : 0;
          break;
        }
        case 0x38: { use(2); push(from_u64(n)); break; }
        case 0x39: {  // CODECOPY
          U256 d = pop(), s = pop(), size = pop();
          uint64_t sz = check_off(size);
          use(3 + 3 * ((sz + 31) / 32));
          if (sz == 0) break;
          uint64_t dd = check_off(d);
          mem_expand(dd, sz);
          // same uint64 `ss + i` wrap clamp as CALLDATACOPY above
          uint64_t ss = s.w[1]|s.w[2]|s.w[3] ? ~0ULL : s.w[0];
          uint64_t avail = ss < n ? n - ss : 0;
          for (uint64_t i = 0; i < sz; i++)
            mem[dd + i] = i < avail ? code[ss + i] : 0;
          break;
        }
        case 0x3A: { use(2); push(tx_.eff_price); break; }
        case 0x3B: {  // EXTCODESIZE
          U256 a = pop(); Addr ad = word_addr(a);
          use(warm_account(ad) ? G_WARM : G_COLD_ACCT);
          const std::vector<uint8_t> *c = code_of(ad);
          push(from_u64(c ? c->size() : 0));
          break;
        }
        case 0x3D: { use(2); push(from_u64(retdata_.size())); break; }
        case 0x3E: {  // RETURNDATACOPY
          U256 d = pop(), s = pop(), size = pop();
          uint64_t sz = check_off(size);
          use(3 + 3 * ((sz + 31) / 32));
          uint64_t ss = s.w[1]|s.w[2]|s.w[3] ? ~0ULL : s.w[0];
          if (ss == ~0ULL || ss + sz > retdata_.size()) throw Halt{};
          if (sz == 0) break;
          uint64_t dd = check_off(d);
          mem_expand(dd, sz);
          memcpy(mem.data() + dd, retdata_.data() + ss, sz);
          break;
        }
        case 0x3F: {  // EXTCODEHASH
          U256 a = pop(); Addr ad = word_addr(a);
          use(warm_account(ad) ? G_WARM : G_COLD_ACCT);
          const AcctRec *r = account(ad);
          if (!r || (r->nonce == 0 && r->balance.is_zero() && r->code_id < 0)) {
            push(ZERO);
          } else if (r->code_id < 0) {
            static const uint8_t kempty[32] = {
                0xc5,0xd2,0x46,0x01,0x86,0xf7,0x23,0x3c,0x92,0x7e,0x7d,0xb2,
                0xdc,0xc7,0x03,0xc0,0xe5,0x00,0xb6,0x53,0xca,0x82,0x27,0x3b,
                0x7b,0xfa,0xd8,0x04,0x5d,0x85,0xa4,0x70};
            push(from_be(kempty));
          } else {
            const auto &c = snap_.codes[r->code_id];
            uint8_t h[32]; keccak256(c.data(), c.size(), h);
            push(from_be(h));
          }
          break;
        }
        case 0x41: { use(2); push(addr_word(env_.coinbase)); break; }
        case 0x42: { use(2); push(from_u64(env_.timestamp)); break; }
        case 0x43: { use(2); push(from_u64(env_.number)); break; }
        case 0x44: { use(2); push(env_.prevrandao); break; }
        case 0x45: { use(2); push(from_u64(env_.gas_limit)); break; }
        case 0x46: { use(2); push(from_u64(env_.chain_id)); break; }
        case 0x47: { use(5); push(balance_of(self)); break; }
        case 0x48: { use(2); push(env_.base_fee); break; }
        case 0x49: { use(3); pop(); push(ZERO); break; }  // BLOBHASH (no blobs natively)
        case 0x4A: { use(2); push(env_.blob_base_fee); break; }
        case 0x50: { use(2); pop(); break; }
        case 0x51: {  // MLOAD
          use(3); uint64_t o = check_off(pop());
          mem_expand(o, 32);
          push(from_be(mem.data() + o));
          break;
        }
        case 0x52: {  // MSTORE
          use(3); U256 offv = pop(), v = pop();
          uint64_t o = check_off(offv);
          mem_expand(o, 32);
          to_be(v, mem.data() + o);
          break;
        }
        case 0x53: {  // MSTORE8
          use(3); U256 offv = pop(), v = pop();
          uint64_t o = check_off(offv);
          mem_expand(o, 1);
          mem[o] = (uint8_t)v.w[0];
          break;
        }
        case 0x54: {  // SLOAD
          U256 kv = pop();
          uint8_t k[32]; to_be(kv, k);
          use(warm_slot(self, k) ? G_WARM : G_COLD_SLOAD);
          push(sload(self, k));
          break;
        }
        case 0x55: {  // SSTORE (EIP-2200 + 2929 + 3529)
          if (gas <= 2300) throw Halt{};
          U256 kv = pop(), v = pop();
          uint8_t k[32]; to_be(kv, k);
          uint64_t cold = warm_slot(self, k) ? 0 : G_COLD_SLOAD;
          U256 cur = sload(self, k);
          U256 orig = original(self, k);
          uint64_t cost;
          if (v == cur) cost = cold + G_WARM;
          else if (cur == orig)
            cost = cold + (orig.is_zero() ? G_SSTORE_SET : G_SSTORE_RESET);
          else cost = cold + G_WARM;
          use(cost);
          if (v != cur) {
            if (cur == orig) {
              if (!orig.is_zero() && v.is_zero()) refund_ += R_CLEAR;
            } else {
              if (!orig.is_zero()) {
                if (cur.is_zero()) refund_ -= R_CLEAR;
                else if (v.is_zero()) refund_ += R_CLEAR;
              }
              if (v == orig)
                refund_ += orig.is_zero() ? (int64_t)(G_SSTORE_SET - G_WARM)
                                          : (int64_t)(G_SSTORE_RESET - G_WARM);
            }
            sstore_val(self, k, v);
          }
          break;
        }
        case 0x58: { use(2); push(from_u64(pc - 1)); break; }
        case 0x59: { use(2); push(from_u64(mem.size())); break; }
        case 0x5A: { use(2); push(from_u64(gas)); break; }
        case 0x5C: {  // TLOAD
          use(100); U256 kv = pop();
          SlotKey key{self, {}}; to_be(kv, key.k);
          auto it = transient_.find(key);
          push(it == transient_.end() ? ZERO : it->second);
          break;
        }
        case 0x5D: {  // TSTORE
          use(100); U256 kv = pop(), v = pop();
          SlotKey key{self, {}}; to_be(kv, key.k);
          transient_[key] = v;
          break;
        }
        case 0x5E: {  // MCOPY
          U256 d = pop(), s = pop(), size = pop();
          uint64_t sz = check_off(size);
          use(3 + 3 * ((sz + 31) / 32));
          if (sz == 0) break;
          uint64_t ss = check_off(s), dd = check_off(d);
          mem_expand(ss, sz);
          std::vector<uint8_t> tmp(mem.begin() + ss, mem.begin() + ss + sz);
          mem_expand(dd, sz);
          memcpy(mem.data() + dd, tmp.data(), sz);
          break;
        }
        case 0xA0: case 0xA1: case 0xA2: case 0xA3: case 0xA4: {  // LOG
          unsigned nt = op - 0xA0;
          U256 off = pop(), size = pop();
          LogRec log; log.a = self;
          for (unsigned i = 0; i < nt; i++) {
            std::array<uint8_t, 32> t;
            to_be(pop(), t.data());
            log.topics.push_back(t);
          }
          uint64_t sz = check_off(size);
          use(375 + 375ULL * nt + 8 * sz);
          if (sz) {
            uint64_t o = check_off(off);
            mem_expand(o, sz);
            log.data.assign(mem.begin() + o, mem.begin() + o + sz);
          }
          logs_.push_back(std::move(log));
          break;
        }
        case 0x00: return gas;  // STOP
        case 0xF3: {  // RETURN
          U256 off = pop(), size = pop();
          uint64_t sz = check_off(size);
          if (sz) {  // zero size ignores the offset (python mem_read)
            uint64_t o = check_off(off);
            mem_expand(o, sz);
            res_.output.assign(mem.begin() + o, mem.begin() + o + sz);
          }
          return gas;
        }
        case 0xFD: {  // REVERT
          U256 off = pop(), size = pop();
          uint64_t sz = check_off(size);
          RevertExc r; r.gas_left = gas;
          if (sz) {
            uint64_t o = check_off(off);
            mem_expand(o, sz);
            r.output.assign(mem.begin() + o, mem.begin() + o + sz);
          }
          throw r;
        }
        case 0xFE: throw Halt{};
        // everything with sub-frames or exotic host needs: python path
        default:
          if (op == 0x3C || op == 0x40 ||  // EXTCODECOPY/BLOCKHASH
              op == 0xF0 || op == 0xF1 || op == 0xF2 || op == 0xF4 ||
              op == 0xF5 || op == 0xFA || op == 0xFF)
            throw Miss{};
          throw Halt{};  // unassigned opcode
      }
    }
    return gas;
  }

  static U256 addr_word(const Addr &a) {
    uint8_t buf[32] = {0};
    memcpy(buf + 12, a.b, 20);
    return from_be(buf);
  }
  static Addr word_addr(const U256 &v) {
    uint8_t buf[32]; to_be(v, buf);
    Addr a; memcpy(a.b, buf + 12, 20);
    return a;
  }

  std::vector<uint8_t> retdata_;
};

// ------------------------------------------------------------- (de)marshal
struct Reader {
  const uint8_t *p; size_t left;
  void need(size_t n) { if (left < n) abort(); }
  uint32_t u32() { need(4); uint32_t v; memcpy(&v, p, 4); p += 4; left -= 4; return v; }
  uint64_t u64() { need(8); uint64_t v; memcpy(&v, p, 8); p += 8; left -= 8; return v; }
  uint8_t u8() { need(1); return left--, *p++; }
  void bytes(void *dst, size_t n) { need(n); memcpy(dst, p, n); p += n; left -= n; }
};

struct Writer {
  std::vector<uint8_t> buf;
  void u32(uint32_t v) { append(&v, 4); }
  void u64(uint64_t v) { append(&v, 8); }
  void u8(uint8_t v) { buf.push_back(v); }
  void append(const void *src, size_t n) {
    const uint8_t *s = (const uint8_t *)src;
    buf.insert(buf.end(), s, s + n);
  }
};

}  // namespace

namespace {
bool intersects_accts(const std::set<Addr> &committed, const TxResult &r) {
  for (const Addr &a : r.acct_reads)
    if (committed.count(a)) return true;
  for (const auto &kv : r.acct_writes)
    if (committed.count(kv.first)) return true;
  return false;
}
bool intersects_slots(const std::set<SlotKey> &committed, const TxResult &r) {
  for (const SlotKey &k : r.slot_reads)
    if (committed.count(k)) return true;
  for (const auto &kv : r.slot_writes)
    if (committed.count(kv.first)) return true;
  return false;
}
}  // namespace

extern "C" {

// Execute a SEGMENT of a block: txs partitioned into in-order waves; each
// wave speculates on threads, commits in order with actual-access
// validation (conflicts re-run serially against the merged view), and the
// merged writes feed the next wave — the whole BAL engine loop with the
// GIL nowhere in sight. Stops at the first transaction the native core
// cannot take (status=2); later txs report status=3 (not run) and Python
// resumes from there. Returns malloc'd result buffer (evm_free).
uint8_t *evm_execute_block(const uint8_t *snap_buf, uint64_t snap_len,
                           const uint8_t *env_buf, uint64_t env_len,
                           const uint8_t *txs_buf, uint64_t txs_len,
                           const uint8_t *waves_buf, uint64_t waves_len,
                           uint64_t remaining_gas, int n_threads,
                           uint64_t *out_len) {
  Snapshot snap;
  {
    Reader r{snap_buf, (size_t)snap_len};
    uint32_t na = r.u32();
    for (uint32_t i = 0; i < na; i++) {
      Addr a; r.bytes(a.b, 20);
      AcctRec rec;
      rec.nonce = r.u64();
      uint8_t bal[32]; r.bytes(bal, 32); rec.balance = from_be(bal);
      uint32_t cid = r.u32(); rec.code_id = (int32_t)cid;
      rec.exists = r.u8();
      snap.accounts[a] = rec;
    }
    uint32_t ns = r.u32();
    for (uint32_t i = 0; i < ns; i++) {
      SlotKey k; r.bytes(k.a.b, 20); r.bytes(k.k, 32);
      uint8_t v[32]; r.bytes(v, 32);
      snap.slots[k] = from_be(v);
    }
    uint32_t nc = r.u32();
    for (uint32_t i = 0; i < nc; i++) {
      uint32_t len = r.u32();
      std::vector<uint8_t> code(len);
      r.bytes(code.data(), len);
      // jumpdest analysis up front: per-code, shared read-only by every
      // thread for the whole call (no caches keyed on heap addresses)
      std::vector<uint8_t> bm((code.size() + 7) / 8, 0);
      for (size_t j = 0; j < code.size();) {
        uint8_t op = code[j];
        if (op == 0x5B) bm[j / 8] |= 1 << (j % 8);
        j += (op >= 0x60 && op <= 0x7F) ? (op - 0x5F + 1) : 1;
      }
      snap.codes.push_back(std::move(code));
      snap.jumpdests.push_back(std::move(bm));
    }
  }
  Env env;
  {
    Reader r{env_buf, (size_t)env_len};
    r.bytes(env.coinbase.b, 20);
    env.number = r.u64(); env.timestamp = r.u64(); env.gas_limit = r.u64();
    uint8_t b[32];
    r.bytes(b, 32); env.base_fee = from_be(b);
    r.bytes(b, 32); env.prevrandao = from_be(b);
    env.chain_id = r.u64();
    r.bytes(b, 32); env.blob_base_fee = from_be(b);
  }
  std::vector<Tx> txs;
  {
    Reader r{txs_buf, (size_t)txs_len};
    uint32_t nt = r.u32();
    for (uint32_t i = 0; i < nt; i++) {
      Tx t;
      t.index = r.u32();
      r.bytes(t.sender.b, 20);
      t.has_to = r.u8();
      r.bytes(t.to.b, 20);
      uint8_t b[32];
      r.bytes(b, 32); t.value = from_be(b);
      t.nonce = r.u64();
      t.gas_limit = r.u64();
      r.bytes(b, 32); t.eff_price = from_be(b);
      r.bytes(b, 32); t.fee_cap = from_be(b);
      t.intrinsic = r.u64(); t.floor = r.u64();
      t.tx_type = r.u8();
      uint32_t dl = r.u32();
      t.data.resize(dl); r.bytes(t.data.data(), dl);
      uint32_t nacl = r.u32();
      for (uint32_t j = 0; j < nacl; j++) {
        AclEntry e; r.bytes(e.a.b, 20);
        uint32_t nsl = r.u32();
        for (uint32_t k = 0; k < nsl; k++) {
          std::array<uint8_t, 32> sl; r.bytes(sl.data(), 32);
          e.slots.push_back(sl);
        }
        t.acl.push_back(std::move(e));
      }
      txs.push_back(std::move(t));
    }
  }

  std::vector<uint32_t> wave_sizes;
  {
    Reader r{waves_buf, (size_t)waves_len};
    uint32_t nw = r.u32();
    for (uint32_t i = 0; i < nw; i++) wave_sizes.push_back(r.u32());
  }

  BlockView view; view.snap = &snap;
  std::vector<TxResult> results(txs.size());
  std::vector<uint8_t> exec_mode(txs.size(), 0);  // 0 parallel, 1 serial
  uint64_t cumulative = 0;
  bool stopped = false;

  // hand a tx back to Python keeping the reads it managed before failing:
  // the optimistic scheduler diffs them against its snapshot to decide
  // which keys the async storage layer must prefetch before the retry
  auto demote = [&](size_t i, uint8_t status) {
    TxResult keep;
    keep.index = txs[i].index;
    keep.status = status;
    keep.coinbase_sensitive = results[i].coinbase_sensitive;
    keep.acct_reads = std::move(results[i].acct_reads);
    keep.slot_reads = std::move(results[i].slot_reads);
    results[i] = std::move(keep);
  };

  auto speculate = [&](size_t i, TxResult &res) {
    res = TxResult{};
    res.index = txs[i].index;
    try {
      TxMachine m(view, env, txs[i], res);
      m.run();
    } catch (...) {
      std::set<Addr> reads = std::move(res.acct_reads);
      std::set<SlotKey> sreads = std::move(res.slot_reads);
      res = TxResult{};
      res.index = txs[i].index;
      res.status = 2;
      res.acct_reads = std::move(reads);   // partial reads still conflict-
      res.slot_reads = std::move(sreads);  // relevant for the retry decision
    }
  };

  // persistent worker pool: one spawn for the whole call, waves hand out
  // work through an atomic cursor (thread-per-wave spawning measurably
  // dominated execution for small transactions)
  struct Pool {
    std::mutex m;
    std::condition_variable cv_work, cv_done;
    size_t lo = 0, hi = 0;
    std::atomic<size_t> cursor{0};
    std::atomic<size_t> pending{0};
    uint64_t epoch = 0;
    bool quit = false;
  } pool_state;
  size_t nthreads = n_threads > 1 ? (size_t)n_threads : 0;
  std::vector<std::thread> workers;
  if (nthreads > 1 && txs.size() >= 16) {
    for (size_t t = 0; t < nthreads; t++) {
      workers.emplace_back([&]() {
        uint64_t seen = 0;
        for (;;) {
          {
            std::unique_lock<std::mutex> lk(pool_state.m);
            pool_state.cv_work.wait(lk, [&] {
              return pool_state.quit || pool_state.epoch != seen;
            });
            if (pool_state.quit) return;
            seen = pool_state.epoch;
          }
          for (;;) {
            size_t i = pool_state.cursor.fetch_add(1);
            if (i >= pool_state.hi) break;
            speculate(i, results[i]);
          }
          if (pool_state.pending.fetch_sub(1) == 1) {
            std::lock_guard<std::mutex> lk(pool_state.m);
            pool_state.cv_done.notify_one();
          }
        }
      });
    }
  }
  auto run_parallel = [&](size_t lo, size_t hi) {
    if (workers.empty() || hi - lo <= 1) {
      for (size_t i = lo; i < hi; i++) speculate(i, results[i]);
      return;
    }
    {
      std::lock_guard<std::mutex> lk(pool_state.m);
      pool_state.lo = lo; pool_state.hi = hi;
      pool_state.cursor.store(lo);
      pool_state.pending.store(workers.size());
      pool_state.epoch++;
    }
    pool_state.cv_work.notify_all();
    std::unique_lock<std::mutex> lk(pool_state.m);
    pool_state.cv_done.wait(lk, [&] { return pool_state.pending.load() == 0; });
  };

  size_t pos = 0;
  for (uint32_t wsize : wave_sizes) {
    size_t lo = pos, hi = pos + wsize;
    pos = hi;
    if (stopped) {
      for (size_t i = lo; i < hi; i++) {
        results[i].index = txs[i].index;
        results[i].status = 3;
      }
      continue;
    }
    // parallel speculation against the wave-start view
    run_parallel(lo, hi);
    // in-order validation + commit (the Python commit loop, natively)
    std::set<Addr> committed_accts;
    std::set<SlotKey> committed_slots;
    for (size_t i = lo; i < hi; i++) {
      if (stopped) { demote(i, 3); continue; }
      if (txs[i].gas_limit > remaining_gas - cumulative) {
        // python raises invalid-block here; hand over
        demote(i, 2); stopped = true; continue;
      }
      bool conflicted = results[i].status == 2 ||
                        results[i].coinbase_sensitive ||
                        intersects_accts(committed_accts, results[i]) ||
                        intersects_slots(committed_slots, results[i]);
      if (conflicted) {
        speculate(i, results[i]);  // serial re-run against the merged view
        exec_mode[i] = 1;
        if (results[i].status == 2 || results[i].coinbase_sensitive) {
          demote(i, 2); stopped = true; continue;
        }
      }
      // commit writes into the view
      for (const auto &kv : results[i].acct_writes) {
        view.acct_overlay[kv.first] = AcctRec{
            kv.second.nonce, kv.second.balance,
            [&]() {  // preserve the code id across balance/nonce writes
              bool known; const AcctRec *prev = view.account(kv.first, known);
              return prev ? prev->code_id : -1;
            }(),
            !kv.second.deleted};
        committed_accts.insert(kv.first);
      }
      for (const auto &kv : results[i].slot_writes) {
        view.slot_overlay[kv.first] = kv.second;
        committed_slots.insert(kv.first);
      }
      cumulative += results[i].gas_used;
    }
  }
  if (!workers.empty()) {
    {
      std::lock_guard<std::mutex> lk(pool_state.m);
      pool_state.quit = true;
    }
    pool_state.cv_work.notify_all();
    for (auto &th : workers) th.join();
  }

  Writer w;
  w.u32((uint32_t)results.size());
  uint8_t be[32];
  for (size_t i = 0; i < results.size(); i++) {
    const TxResult &res = results[i];
    w.u32(res.index);
    w.u8(res.status);
    w.u8(exec_mode[i]);
    w.u8(res.coinbase_sensitive ? 1 : 0);
    w.u64(res.gas_used);
    to_be(res.fee_delta, be); w.append(be, 32);
    w.u32((uint32_t)res.output.size());
    w.append(res.output.data(), res.output.size());
    w.u32((uint32_t)res.logs.size());
    for (const LogRec &lg : res.logs) {
      w.append(lg.a.b, 20);
      w.u8((uint8_t)lg.topics.size());
      for (const auto &t : lg.topics) w.append(t.data(), 32);
      w.u32((uint32_t)lg.data.size());
      w.append(lg.data.data(), lg.data.size());
    }
    w.u32((uint32_t)res.acct_reads.size());
    for (const Addr &a : res.acct_reads) w.append(a.b, 20);
    w.u32((uint32_t)res.acct_writes.size());
    for (const auto &kv : res.acct_writes) {
      w.append(kv.first.b, 20);
      w.u8(kv.second.deleted);
      w.u64(kv.second.nonce);
      to_be(kv.second.balance, be); w.append(be, 32);
    }
    w.u32((uint32_t)res.slot_reads.size());
    for (const SlotKey &k : res.slot_reads) {
      w.append(k.a.b, 20); w.append(k.k, 32);
    }
    w.u32((uint32_t)res.slot_writes.size());
    for (const auto &kv : res.slot_writes) {
      w.append(kv.first.a.b, 20); w.append(kv.first.k, 32);
      to_be(kv.second, be); w.append(be, 32);
    }
  }
  uint8_t *out = (uint8_t *)malloc(w.buf.size());
  memcpy(out, w.buf.data(), w.buf.size());
  *out_len = w.buf.size();
  return out;
}

void evm_free(uint8_t *p) { free(p); }

}  // extern "C"
