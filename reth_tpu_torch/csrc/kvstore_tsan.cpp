// Sanitizer stress driver for the MVCC KV engine (kvstore.cpp).
//
// Reference analogue: the reference relies on MDBX's own battle-tested
// concurrency plus Rust's data-race freedom; this repo's C++ engine gets
// the equivalent assurance from running its reader/writer protocol under
// sanitizers + a logic-level race detector (SURVEY §5: race detection /
// sanitizers).
//
// Build + run (tests/test_native_kv.py::test_sanitized_concurrent_stress):
//   g++ -std=c++17 -O1 -g -fsanitize=address,undefined kvstore.cpp \
//       kvstore_tsan.cpp -o build/kvstore_stress && ./build/kvstore_stress
// (-fsanitize=thread is preferred where libtsan supports the running
// kernel; gcc-12's TSAN runtime SEGVs on 6.18+ kernels, so the test
// harness probes TSAN first and falls back to ASan+UBSan.)
//
// Workload: one writer rewrites ALL keys to value=round and commits,
// while N reader threads open snapshots and iterate. Two failure modes
// are detected: (a) memory errors under the sanitizer, (b) a broken
// snapshot — a reader observing a MIX of rounds inside one iteration
// (exit 2), which is precisely the torn read MVCC must rule out.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {
void* rtkv_open(const char* dir);
void rtkv_close(void* env);
void* rtkv_txn_begin(void* env, int write);
int rtkv_put(void* txn, const char* table, const uint8_t* key, uint32_t klen,
             const uint8_t* val, uint32_t vlen, int dupsort);
int rtkv_get(void* txn, const char* table, const uint8_t* key, uint32_t klen,
             const uint8_t** out, uint32_t* out_len);
uint64_t rtkv_entry_count(void* txn, const char* table);
int rtkv_commit(void* txn);
void rtkv_abort(void* txn);
void* rtkv_cursor(void* txn, const char* table);
int rtkv_cursor_first(void* cur, const uint8_t** k, uint32_t* kl,
                      const uint8_t** v, uint32_t* vl);
int rtkv_cursor_next(void* cur, int skip_dups, const uint8_t** k,
                     uint32_t* kl, const uint8_t** v, uint32_t* vl);
void rtkv_cursor_close(void* cur);
}

static std::atomic<bool> stop{false};
static std::atomic<bool> torn{false};
static std::atomic<long> reads{0};

static void reader(void* env) {
  while (!stop.load(std::memory_order_relaxed)) {
    void* txn = rtkv_txn_begin(env, 0);
    // snapshot iteration: the writer rewrites EVERY key to the same
    // round value per commit, so one snapshot must never mix rounds
    void* cur = rtkv_cursor(txn, "T");
    const uint8_t *k, *v;
    uint32_t kl, vl;
    uint64_t n = 0;
    int seen_round = -1;
    int ok = rtkv_cursor_first(cur, &k, &kl, &v, &vl);
    while (ok) {
      n++;
      if (vl > 0) {
        int r = v[0];
        if (seen_round < 0) seen_round = r;
        else if (r != seen_round) torn.store(true);
      }
      ok = rtkv_cursor_next(cur, 0, &k, &kl, &v, &vl);
    }
    rtkv_cursor_close(cur);
    // a point read against the same snapshot must agree too
    uint8_t key[8] = {0};
    const uint8_t* out;
    uint32_t out_len;
    if (rtkv_get(txn, "T", key, sizeof key, &out, &out_len) && out_len > 0
        && seen_round >= 0 && out[0] != seen_round)
      torn.store(true);
    rtkv_abort(txn);
    reads.fetch_add(static_cast<long>(n), std::memory_order_relaxed);
  }
}

int main() {
  void* env = rtkv_open("");  // in-memory: pure concurrency exercise
  std::vector<std::thread> readers;
  for (int i = 0; i < 4; i++) readers.emplace_back(reader, env);

  for (int round = 0; round < 200; round++) {
    void* txn = rtkv_txn_begin(env, 1);
    for (int i = 0; i < 50; i++) {
      uint8_t key[8], val[16];
      std::memset(key, 0, sizeof key);
      key[0] = static_cast<uint8_t>(i);
      std::memset(val, round & 0xFF, sizeof val);
      rtkv_put(txn, "T", key, sizeof key, val, sizeof val, 0);
    }
    if (rtkv_commit(txn) != 0) {
      std::fprintf(stderr, "commit failed at round %d\n", round);
      return 1;
    }
  }
  stop.store(true);
  for (auto& t : readers) t.join();
  rtkv_close(env);
  if (torn.load()) {
    std::fprintf(stderr, "TORN SNAPSHOT: reader mixed rounds\n");
    return 2;
  }
  std::printf("STRESS_OK reads=%ld\n", reads.load());
  return 0;
}
