// Batched secp256k1 public-key recovery — the sender-recovery hot loop.
//
// A copy of the JAX package's native/secp256k1.cpp (reference analogue: the
// C secp256k1 library + rayon batching behind SenderRecoveryStage,
// crates/stages/stages/src/stages/sender_recovery.rs). It recovers
// Q = u1*G + u2*R with 4x64-limb field arithmetic (special-form reduction
// by p = 2^256 - 2^32 - 977) and an interleaved (Shamir) double scalar
// multiplication, threaded across the batch. The CALLER (Python,
// primitives/secp256k1.py ecrecover_batch) computes u1 = -z*r^-1 mod n and
// u2 = s*r^-1 mod n. Parity with the pure-Python ecrecover is held by
// tests/test_torch_secp256k1.py.
//
// Built by ops/_build.py's g++ route into reth_tpu_torch/build/.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

using u64 = uint64_t;
using u128 = unsigned __int128;

// field element: 4 x 64-bit little-endian limbs, value < p
struct Fe {
  u64 v[4];
};

constexpr u64 P0 = 0xFFFFFFFEFFFFFC2FULL;
constexpr u64 P1 = 0xFFFFFFFFFFFFFFFFULL;
constexpr u64 P2 = 0xFFFFFFFFFFFFFFFFULL;
constexpr u64 P3 = 0xFFFFFFFFFFFFFFFFULL;
constexpr u64 FOLD = 0x1000003D1ULL;  // 2^256 mod p

inline bool fe_gte_p(const Fe& a) {
  if (a.v[3] != P3) return a.v[3] > P3;
  if (a.v[2] != P2) return a.v[2] > P2;
  if (a.v[1] != P1) return a.v[1] > P1;
  return a.v[0] >= P0;
}

inline void fe_reduce_once(Fe& a) {
  if (!fe_gte_p(a)) return;
  // a -= p
  u64 borrow = 0;
  u64 limbs_p[4] = {P0, P1, P2, P3};
  for (int i = 0; i < 4; i++) {
    u128 t = (u128)a.v[i] - limbs_p[i] - borrow;
    a.v[i] = (u64)t;
    borrow = (t >> 64) ? 1 : 0;
  }
}

inline void fe_add(Fe& r, const Fe& a, const Fe& b) {
  u64 carry = 0;
  for (int i = 0; i < 4; i++) {
    u128 t = (u128)a.v[i] + b.v[i] + carry;
    r.v[i] = (u64)t;
    carry = (u64)(t >> 64);
  }
  if (carry) {  // fold 2^256 -> FOLD
    u128 t = (u128)r.v[0] + FOLD;
    r.v[0] = (u64)t;
    u64 c = (u64)(t >> 64);
    for (int i = 1; c && i < 4; i++) {
      t = (u128)r.v[i] + c;
      r.v[i] = (u64)t;
      c = (u64)(t >> 64);
    }
  }
  fe_reduce_once(r);
}

inline void fe_neg(Fe& r, const Fe& a) {
  // r = p - a (a < p)
  u64 limbs_p[4] = {P0, P1, P2, P3};
  u64 borrow = 0;
  for (int i = 0; i < 4; i++) {
    u128 t = (u128)limbs_p[i] - a.v[i] - borrow;
    r.v[i] = (u64)t;
    borrow = (t >> 64) ? 1 : 0;
  }
  // a == 0 -> r == p: reduce
  fe_reduce_once(r);
}

inline void fe_sub(Fe& r, const Fe& a, const Fe& b) {
  Fe nb;
  fe_neg(nb, b);
  fe_add(r, a, nb);
}

// full 256x256 -> 512 multiply, then reduce mod p via 2^256 == FOLD
inline void fe_mul(Fe& r, const Fe& a, const Fe& b) {
  u64 lo[4] = {0, 0, 0, 0}, hi[4] = {0, 0, 0, 0};
  for (int i = 0; i < 4; i++) {
    u64 carry = 0;
    for (int j = 0; j < 4; j++) {
      int k = i + j;
      u128 cur = (u128)a.v[i] * b.v[j] + carry;
      u128 acc = (k < 4 ? (u128)lo[k] : (u128)hi[k - 4]) + (u64)cur;
      if (k < 4) lo[k] = (u64)acc;
      else hi[k - 4] = (u64)acc;
      carry = (u64)(cur >> 64) + (u64)(acc >> 64);
    }
    int k = i + 4;
    while (carry) {
      u128 acc = (u128)(k < 4 ? lo[k] : hi[k - 4]) + carry;
      if (k < 4) lo[k] = (u64)acc;
      else hi[k - 4] = (u64)acc;
      carry = (u64)(acc >> 64);
      k++;
    }
  }
  // fold: result = lo + hi * FOLD  (hi * FOLD fits in 4 limbs + small carry)
  u64 carry = 0;
  u64 mid[5] = {0, 0, 0, 0, 0};
  for (int i = 0; i < 4; i++) {
    u128 t = (u128)hi[i] * FOLD + mid[i] + carry;
    mid[i] = (u64)t;
    carry = (u64)(t >> 64);
  }
  mid[4] = carry;
  Fe res;
  carry = 0;
  for (int i = 0; i < 4; i++) {
    u128 t = (u128)lo[i] + mid[i] + carry;
    res.v[i] = (u64)t;
    carry = (u64)(t >> 64);
  }
  u64 over = carry + mid[4];  // multiples of 2^256 still to fold
  while (over) {
    u128 t = (u128)res.v[0] + (u128)over * FOLD;
    res.v[0] = (u64)t;
    u64 c = (u64)(t >> 64);
    for (int i = 1; c && i < 4; i++) {
      t = (u128)res.v[i] + c;
      res.v[i] = (u64)t;
      c = (u64)(t >> 64);
    }
    over = c;
  }
  fe_reduce_once(res);
  r = res;
}

inline void fe_sqr(Fe& r, const Fe& a) { fe_mul(r, a, a); }

inline bool fe_is_zero(const Fe& a) {
  return (a.v[0] | a.v[1] | a.v[2] | a.v[3]) == 0;
}

inline bool fe_eq(const Fe& a, const Fe& b) {
  return a.v[0] == b.v[0] && a.v[1] == b.v[1] && a.v[2] == b.v[2] &&
         a.v[3] == b.v[3];
}

void fe_pow(Fe& r, const Fe& a, const u64 e[4]) {
  Fe base = a;
  Fe acc{{1, 0, 0, 0}};
  for (int limb = 0; limb < 4; limb++) {
    u64 bits = e[limb];
    for (int i = 0; i < 64; i++) {
      if (bits & 1) fe_mul(acc, acc, base);
      fe_sqr(base, base);
      bits >>= 1;
    }
  }
  r = acc;
}

void fe_inv(Fe& r, const Fe& a) {
  // Fermat: a^(p-2)
  const u64 e[4] = {P0 - 2, P1, P2, P3};
  fe_pow(r, a, e);
}

bool fe_sqrt(Fe& r, const Fe& a) {
  // p % 4 == 3: sqrt = a^((p+1)/4)
  const u64 e[4] = {0xFFFFFFFFBFFFFF0CULL, 0xFFFFFFFFFFFFFFFFULL,
                    0xFFFFFFFFFFFFFFFFULL, 0x3FFFFFFFFFFFFFFFULL};
  fe_pow(r, a, e);
  Fe chk;
  fe_sqr(chk, r);
  return fe_eq(chk, a);
}

void fe_from_bytes(Fe& r, const uint8_t* be32) {
  for (int i = 0; i < 4; i++) {
    u64 v = 0;
    for (int j = 0; j < 8; j++) v = (v << 8) | be32[(3 - i) * 8 + j];
    r.v[i] = v;
  }
}

void fe_to_bytes(uint8_t* be32, const Fe& a) {
  for (int i = 0; i < 4; i++) {
    u64 v = a.v[3 - i];
    for (int j = 0; j < 8; j++) be32[i * 8 + j] = (uint8_t)(v >> (56 - 8 * j));
  }
}

// -- Jacobian points ---------------------------------------------------------

struct Jac {
  Fe x, y, z;
  bool inf;
};

const Fe FE_SEVEN{{7, 0, 0, 0}};

void jac_double(Jac& r, const Jac& p) {
  if (p.inf || fe_is_zero(p.y)) {
    r.inf = true;
    return;
  }
  Fe ysq, s, m, t, x3, y3, z3;
  fe_sqr(ysq, p.y);
  fe_mul(s, p.x, ysq);
  fe_add(s, s, s);
  fe_add(s, s, s);              // s = 4 x y^2
  Fe xsq;
  fe_sqr(xsq, p.x);
  fe_add(m, xsq, xsq);
  fe_add(m, m, xsq);            // m = 3 x^2  (a = 0)
  fe_sqr(x3, m);
  fe_sub(x3, x3, s);
  fe_sub(x3, x3, s);            // x3 = m^2 - 2 s
  Fe ysq2;
  fe_sqr(ysq2, ysq);
  fe_add(ysq2, ysq2, ysq2);
  fe_add(ysq2, ysq2, ysq2);
  fe_add(ysq2, ysq2, ysq2);     // 8 y^4
  fe_sub(t, s, x3);
  fe_mul(y3, m, t);
  fe_sub(y3, y3, ysq2);         // y3 = m (s - x3) - 8 y^4
  fe_mul(z3, p.y, p.z);
  fe_add(z3, z3, z3);           // z3 = 2 y z
  r.x = x3;
  r.y = y3;
  r.z = z3;
  r.inf = false;
}

void jac_add(Jac& r, const Jac& p, const Jac& q) {
  if (p.inf) { r = q; return; }
  if (q.inf) { r = p; return; }
  Fe z1sq, z2sq, u1, u2, s1, s2;
  fe_sqr(z1sq, p.z);
  fe_sqr(z2sq, q.z);
  fe_mul(u1, p.x, z2sq);
  fe_mul(u2, q.x, z1sq);
  Fe z2cu, z1cu;
  fe_mul(z2cu, z2sq, q.z);
  fe_mul(z1cu, z1sq, p.z);
  fe_mul(s1, p.y, z2cu);
  fe_mul(s2, q.y, z1cu);
  if (fe_eq(u1, u2)) {
    if (fe_eq(s1, s2)) {
      jac_double(r, p);
      return;
    }
    r.inf = true;
    return;
  }
  Fe h, rr, hsq, hcu, u1hsq;
  fe_sub(h, u2, u1);
  fe_sub(rr, s2, s1);
  fe_sqr(hsq, h);
  fe_mul(hcu, hsq, h);
  fe_mul(u1hsq, u1, hsq);
  Fe x3, y3, z3, t;
  fe_sqr(x3, rr);
  fe_sub(x3, x3, hcu);
  fe_sub(x3, x3, u1hsq);
  fe_sub(x3, x3, u1hsq);        // x3 = r^2 - h^3 - 2 u1 h^2
  fe_sub(t, u1hsq, x3);
  fe_mul(y3, rr, t);
  Fe s1hcu;
  fe_mul(s1hcu, s1, hcu);
  fe_sub(y3, y3, s1hcu);        // y3 = r (u1 h^2 - x3) - s1 h^3
  fe_mul(z3, p.z, q.z);
  fe_mul(z3, z3, h);            // z3 = z1 z2 h
  r.x = x3;
  r.y = y3;
  r.z = z3;
  r.inf = false;
}

// generator
const uint8_t GX_BE[32] = {
    0x79, 0xBE, 0x66, 0x7E, 0xF9, 0xDC, 0xBB, 0xAC, 0x55, 0xA0, 0x62, 0x95,
    0xCE, 0x87, 0x0B, 0x07, 0x02, 0x9B, 0xFC, 0xDB, 0x2D, 0xCE, 0x28, 0xD9,
    0x59, 0xF2, 0x81, 0x5B, 0x16, 0xF8, 0x17, 0x98};
const uint8_t GY_BE[32] = {
    0x48, 0x3A, 0xDA, 0x77, 0x26, 0xA3, 0xC4, 0x65, 0x5D, 0xA4, 0xFB, 0xFC,
    0x0E, 0x11, 0x08, 0xA8, 0xFD, 0x17, 0xB4, 0x48, 0xA6, 0x85, 0x54, 0x19,
    0x9C, 0x47, 0xD0, 0x8F, 0xFB, 0x10, 0xD4, 0xB8};

// Interleaved double-scalar multiplication: k1*A + k2*B (Shamir's trick).
// Scalars as 32-byte big-endian.
void dual_mul(Jac& out, const uint8_t* k1, const Jac& a, const uint8_t* k2,
              const Jac& b) {
  Jac sum_ab;
  jac_add(sum_ab, a, b);
  Jac acc;
  acc.inf = true;
  for (int byte = 0; byte < 32; byte++) {
    for (int bit = 7; bit >= 0; bit--) {
      jac_double(acc, acc);
      bool b1 = (k1[byte] >> bit) & 1;
      bool b2 = (k2[byte] >> bit) & 1;
      if (b1 && b2) jac_add(acc, acc, sum_ab);
      else if (b1) jac_add(acc, acc, a);
      else if (b2) jac_add(acc, acc, b);
    }
  }
  out = acc;
}

// recover one pubkey; returns 0 ok, nonzero error
int recover_one(const uint8_t* r_be, uint8_t parity, const uint8_t* u1,
                const uint8_t* u2, uint8_t* out64) {
  Fe x;
  fe_from_bytes(x, r_be);
  Fe rhs, xsq;
  fe_sqr(xsq, x);
  fe_mul(rhs, xsq, x);
  fe_add(rhs, rhs, FE_SEVEN);
  Fe y;
  if (!fe_sqrt(y, rhs)) return 1;  // x not on curve
  if ((y.v[0] & 1) != (parity & 1)) fe_neg(y, y);
  Jac g;
  fe_from_bytes(g.x, GX_BE);
  fe_from_bytes(g.y, GY_BE);
  g.z = Fe{{1, 0, 0, 0}};
  g.inf = false;
  Jac rp{x, y, Fe{{1, 0, 0, 0}}, false};
  Jac q;
  dual_mul(q, u1, g, u2, rp);
  if (q.inf) return 2;
  // to affine
  Fe zinv, zinv2, zinv3, ax, ay;
  fe_inv(zinv, q.z);
  fe_sqr(zinv2, zinv);
  fe_mul(zinv3, zinv2, zinv);
  fe_mul(ax, q.x, zinv2);
  fe_mul(ay, q.y, zinv3);
  fe_to_bytes(out64, ax);
  fe_to_bytes(out64 + 32, ay);
  return 0;
}

}  // namespace

extern "C" {

// Batch recovery. Arrays of n elements:
//   r:      n x 32 bytes (big-endian signature r; the R point's x)
//   parity: n bytes (recovery bit)
//   u1/u2:  n x 32 bytes big-endian (caller-computed -z*r^-1, s*r^-1 mod n)
//   out:    n x 64 bytes (X||Y)
//   status: n bytes (0 ok, nonzero = unrecoverable)
// n_threads <= 0 picks the hardware concurrency.
void rtsecp_recover_batch(const uint8_t* r, const uint8_t* parity,
                          const uint8_t* u1, const uint8_t* u2, uint64_t n,
                          uint8_t* out, uint8_t* status, int n_threads) {
  if (n == 0) return;
  unsigned workers = n_threads > 0
                         ? (unsigned)n_threads
                         : std::max(1u, std::thread::hardware_concurrency());
  if (workers > n) workers = (unsigned)n;
  auto work = [&](uint64_t lo, uint64_t hi) {
    for (uint64_t i = lo; i < hi; i++) {
      status[i] = (uint8_t)recover_one(r + 32 * i, parity[i], u1 + 32 * i,
                                       u2 + 32 * i, out + 64 * i);
    }
  };
  if (workers == 1) {
    work(0, n);
    return;
  }
  std::vector<std::thread> threads;
  uint64_t chunk = (n + workers - 1) / workers;
  for (unsigned w = 0; w < workers; w++) {
    uint64_t lo = w * chunk;
    uint64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    threads.emplace_back(work, lo, hi);
  }
  for (auto& t : threads) t.join();
}

}  // extern "C"
