// Test driver exposing ytpu-cxx internals to the pytest suite (the
// port's copy of the JAX package's native/client/ytpu-testtool.cc).
//
// The cross-client contract: the native and
// Python clients must produce byte-identical invocation strings for the
// same argv, because the invocation feeds the task digest and cache key
// — a fleet mixing clients must share cache entries and join duplicate
// tasks.  tests/test_torch_install_client.py drives this binary against
// shlex.quote and the port's Python CompilerArgs pipeline.
//
// Modes (results NUL-terminated on stdout so any byte except NUL
// round-trips):
//   ytpu-testtool quote ARG...            -> shell_quote(ARG)\0 each
//   ytpu-testtool invocation [-d] CC A... -> remote_invocation\0
//      (-d sets directives_only, appending -fpreprocessed
//       -fdirectives-only like the real pipeline)
//   ytpu-testtool blake2b FILE            -> hex digest\0
//   ytpu-testtool lightweight CC ARG...   -> "1" or "0"\0
//      (quota class for a local run; must agree with the Python
//       client's _is_lightweight_task)

#define YTPU_NO_MAIN
#include "ytpu-cxx.cc"

int main(int argc, char **argv) {
  if (argc < 2) return 2;
  std::string mode = argv[1];
  if (mode == "quote") {
    for (int i = 2; i < argc; i++) {
      std::string q = shell_quote(argv[i]);
      fwrite(q.data(), 1, q.size(), stdout);
      fputc('\0', stdout);
    }
    return 0;
  }
  if (mode == "invocation") {
    int i = 2;
    bool directives_only = false;
    if (i < argc && std::string(argv[i]) == "-d") {
      directives_only = true;
      i++;
    }
    if (i >= argc) return 2;
    Args a = Args::parse(argc - i, argv + i);
    std::string inv = remote_invocation(a, directives_only);
    fwrite(inv.data(), 1, inv.size(), stdout);
    fputc('\0', stdout);
    return 0;
  }
  if (mode == "blake2b") {
    if (argc < 3) return 2;
    std::string d = hex_digest_of_file(argv[2]);
    if (d.empty()) return 1;
    fwrite(d.data(), 1, d.size(), stdout);
    fputc('\0', stdout);
    return 0;
  }
  if (mode == "lightweight") {
    if (argc < 3) return 2;
    Args a = Args::parse(argc - 2, argv + 2);
    fputs(is_lightweight_task(a) ? "1" : "0", stdout);
    fputc('\0', stdout);
    return 0;
  }
  return 2;
}
