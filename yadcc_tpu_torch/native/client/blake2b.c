/* BLAKE2b per RFC 7693.  See blake2b.h for why this exists. */

#include "blake2b.h"

#include <string.h>

static const uint64_t IV[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
    0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
    0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL,
};

static const uint8_t SIGMA[12][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
};

static inline uint64_t rotr64(uint64_t x, unsigned n) {
  return (x >> n) | (x << (64 - n));
}

static inline uint64_t load64(const uint8_t *p) {
  uint64_t v;
  memcpy(&v, p, 8); /* little-endian hosts only (x86-64/aarch64) */
  return v;
}

#define G(a, b, c, d, x, y)        \
  do {                             \
    a = a + b + (x);               \
    d = rotr64(d ^ a, 32);         \
    c = c + d;                     \
    b = rotr64(b ^ c, 24);         \
    a = a + b + (y);               \
    d = rotr64(d ^ a, 16);         \
    c = c + d;                     \
    b = rotr64(b ^ c, 63);         \
  } while (0)

static void compress(ytpu_blake2b_state *s, const uint8_t block[128],
                     int last) {
  uint64_t m[16], v[16];
  int i;
  for (i = 0; i < 16; i++) m[i] = load64(block + 8 * i);
  for (i = 0; i < 8; i++) v[i] = s->h[i];
  for (i = 0; i < 8; i++) v[8 + i] = IV[i];
  v[12] ^= s->t[0];
  v[13] ^= s->t[1];
  if (last) v[14] = ~v[14];
  for (i = 0; i < 12; i++) {
    const uint8_t *g = SIGMA[i];
    G(v[0], v[4], v[8], v[12], m[g[0]], m[g[1]]);
    G(v[1], v[5], v[9], v[13], m[g[2]], m[g[3]]);
    G(v[2], v[6], v[10], v[14], m[g[4]], m[g[5]]);
    G(v[3], v[7], v[11], v[15], m[g[6]], m[g[7]]);
    G(v[0], v[5], v[10], v[15], m[g[8]], m[g[9]]);
    G(v[1], v[6], v[11], v[12], m[g[10]], m[g[11]]);
    G(v[2], v[7], v[8], v[13], m[g[12]], m[g[13]]);
    G(v[3], v[4], v[9], v[14], m[g[14]], m[g[15]]);
  }
  for (i = 0; i < 8; i++) s->h[i] ^= v[i] ^ v[8 + i];
}

void ytpu_blake2b_init(ytpu_blake2b_state *s, size_t outlen) {
  size_t i;
  memset(s, 0, sizeof(*s));
  for (i = 0; i < 8; i++) s->h[i] = IV[i];
  /* Parameter block word 0: depth=1, fanout=1, key_len=0, digest_len. */
  s->h[0] ^= 0x01010000ULL ^ (uint64_t)outlen;
  s->outlen = outlen;
}

void ytpu_blake2b_update(ytpu_blake2b_state *s, const void *data,
                         size_t len) {
  const uint8_t *p = (const uint8_t *)data;
  while (len > 0) {
    if (s->buflen == 128) {
      s->t[0] += 128;
      if (s->t[0] < 128) s->t[1]++;
      compress(s, s->buf, 0);
      s->buflen = 0;
    }
    size_t take = 128 - s->buflen;
    if (take > len) take = len;
    memcpy(s->buf + s->buflen, p, take);
    s->buflen += take;
    p += take;
    len -= take;
  }
}

void ytpu_blake2b_final(ytpu_blake2b_state *s, uint8_t *out) {
  size_t i;
  s->t[0] += s->buflen;
  if (s->t[0] < s->buflen) s->t[1]++;
  memset(s->buf + s->buflen, 0, 128 - s->buflen);
  compress(s, s->buf, 1);
  for (i = 0; i < s->outlen; i++) out[i] = (uint8_t)(s->h[i / 8] >> (8 * (i % 8)));
}

