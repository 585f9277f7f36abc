/* BLAKE2b (RFC 7693), parameterizable digest length.
 *
 * The Python side of this framework digests with hashlib.blake2b
 * (digest_size=32); BLAKE2b encodes the output length in its parameter
 * block, so a 32-byte digest is NOT a truncated 64-byte one — the C++
 * client must implement the real thing to interoperate.  Fresh
 * implementation from the RFC. */
#ifndef YTPU_BLAKE2B_H
#define YTPU_BLAKE2B_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct {
  uint64_t h[8];
  uint64_t t[2];
  uint8_t buf[128];
  size_t buflen;
  size_t outlen;
} ytpu_blake2b_state;

void ytpu_blake2b_init(ytpu_blake2b_state *s, size_t outlen);
void ytpu_blake2b_update(ytpu_blake2b_state *s, const void *data, size_t len);
void ytpu_blake2b_final(ytpu_blake2b_state *s, uint8_t *out);

#ifdef __cplusplus
}
#endif

#endif
