/* LD_PRELOAD shim making preprocessed output machine-independent.
 *
 * Concept parity with the reference's libfakeroot
 * (yadcc/client/cxx/libfakeroot/fakeroot.c): GCC's preprocessor emits
 * linemarkers ("# <line> \"<file>\" <flags>") through fprintf using the
 * format string "# %u \"%s\"%s".  Files living under the compiler's own
 * installation directory (libstdc++ headers etc.) therefore embed the
 * install path, which differs across machines even for bit-identical
 * compilers — gratuitously splitting the distributed cache.  This shim
 * interposes fprintf: when the format matches a linemarker and the path
 * begins with the directory named by $YTPU_INTERNAL_COMPILER_PATH, the
 * prefix is replaced with the fixed token "/ytpu/compiler", making the
 * preprocessed bytes (and hence the cache key) identical everywhere.
 *
 * Everything else passes straight through to the real fprintf.
 *
 * Build: make -C yadcc_tpu_torch/native fakeroot   (produces
 * libytpufakeroot.so in OUT, beside the client binary; the port's copy
 * of the JAX package's native/fakeroot.c)
 */

#define _GNU_SOURCE
#include <dlfcn.h>
#include <stdarg.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define FAKE_PREFIX "/ytpu/compiler"

static int (*real_vfprintf)(FILE *, const char *, va_list) = NULL;
static const char *g_compiler_root = NULL;
static size_t g_compiler_root_len = 0;
static int g_initialized = 0;

static void init_once(void) {
  if (g_initialized) return;
  g_initialized = 1;
  real_vfprintf = (int (*)(FILE *, const char *, va_list))dlsym(
      RTLD_NEXT, "vfprintf");
  g_compiler_root = getenv("YTPU_INTERNAL_COMPILER_PATH");
  if (g_compiler_root != NULL && g_compiler_root[0] != '\0') {
    g_compiler_root_len = strlen(g_compiler_root);
  } else {
    g_compiler_root = NULL;
  }
}

static int emit(FILE *stream, const char *fmt, ...) {
  va_list ap;
  int rc;
  va_start(ap, fmt);
  rc = real_vfprintf != NULL ? real_vfprintf(stream, fmt, ap) : -1;
  va_end(ap);
  return rc;
}

/* GCC's linemarker format string, byte-for-byte (libcpp). */
static int is_linemarker_format(const char *fmt) {
  return strcmp(fmt, "# %u \"%s\"%s") == 0;
}

static int handle_call(FILE *stream, const char *fmt, va_list ap) {
  if (g_compiler_root != NULL && is_linemarker_format(fmt)) {
    unsigned line = va_arg(ap, unsigned);
    const char *path = va_arg(ap, const char *);
    const char *flags = va_arg(ap, const char *);
    if (path != NULL &&
        strncmp(path, g_compiler_root, g_compiler_root_len) == 0) {
      return emit(stream, "# %u \"%s%s\"%s", line, FAKE_PREFIX,
                  path + g_compiler_root_len, flags);
    }
    return emit(stream, "# %u \"%s\"%s", line, path, flags);
  }
  return real_vfprintf != NULL ? real_vfprintf(stream, fmt, ap) : -1;
}

int fprintf(FILE *stream, const char *fmt, ...) {
  va_list ap;
  int rc;
  init_once();
  va_start(ap, fmt);
  rc = handle_call(stream, fmt, ap);
  va_end(ap);
  return rc;
}

/* Fortified builds (_FORTIFY_SOURCE, the default on most distros) route
 * fprintf through __fprintf_chk; interpose it too or the shim silently
 * does nothing for exactly the gcc binaries it matters for. */
int __fprintf_chk(FILE *stream, int flag, const char *fmt, ...) {
  va_list ap;
  int rc;
  (void)flag;
  init_once();
  va_start(ap, fmt);
  rc = handle_call(stream, fmt, ap);
  va_end(ap);
  return rc;
}
