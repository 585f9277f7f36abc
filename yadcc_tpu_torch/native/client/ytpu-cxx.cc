// ytpu-cxx: the fast-startup native client (the port's copy of the JAX
// package's native/client/ytpu-cxx.cc, built by
// yadcc_tpu_torch/tools/install_client.py into yadcc_tpu_torch/_build/native/).
//
// Capability parity with the reference's yadcc-cxx (yadcc/client/cxx/,
// deliberately framework-free: yadcc/api/daemon.proto:23-34 explains
// that a heavyweight runtime's ~100ms init is unacceptable for a
// process that runs once per translation unit).  This binary speaks the
// same loopback HTTP + JSON + multi-chunk protocol as the Python client
// (yadcc_tpu_torch/client/), so either can front the same daemon:
//
//   symlink g++ -> ytpu-cxx early in PATH, or: ytpu-cxx g++ -O2 -c x.cc
//
// Pipeline (reference yadcc-cxx.cc:37-250): distributable check ->
// quota -> preprocess (-E -fdirectives-only, streamed simultaneously
// into BLAKE2b-256 and the frame compressor) -> submit -> long-poll -> write outputs /
// apply path patches -> exit-code passthrough; retries + local
// fallback on infrastructure failures.
//
// Build: make -C yadcc_tpu_torch/native client   (links only libzstd, or
// with FRAMES=zlib only zlib, + libc).  The source stream and the
// daemon's outputs are zstd frames, or, where the daemon runs without the
// zstandard wheel, the zlib frames of yadcc_tpu_torch/common/_zlib_frames.py
// (-DYTPU_ZLIB_FRAMES): a streaming "YZFS" frame up, "YZF1" frames back.

#include <errno.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <stdarg.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <sys/wait.h>
#include <unistd.h>
#ifdef YTPU_ZLIB_FRAMES
#include <zlib.h>
#else
#include <zstd.h>
#endif

#include <map>
#include <string>
#include <vector>

#include "blake2b.h"

namespace {

// ---------------------------------------------------------------- util --

int env_int(const char *name, int dflt) {
  const char *v = getenv(name);
  return v && *v ? atoi(v) : dflt;
}

int log_level() {  // 10 DEBUG / 20 INFO / 30 WARNING / 40 ERROR
  const char *v = getenv("YTPU_LOG_LEVEL");
  if (!v) return 30;
  if (!strcasecmp(v, "DEBUG")) return 10;
  if (!strcasecmp(v, "INFO")) return 20;
  if (!strcasecmp(v, "ERROR")) return 40;
  return 30;
}

void logf(int level, const char *fmt, ...) {
  if (level < log_level()) return;
  va_list ap;
  va_start(ap, fmt);
  fprintf(stderr, "ytpu-cxx: ");
  vfprintf(stderr, fmt, ap);
  fputc('\n', stderr);
  va_end(ap);
}

std::string hex_encode(const uint8_t *bytes, size_t n) {
  static const char d[] = "0123456789abcdef";
  std::string hex(2 * n, '0');
  for (size_t i = 0; i < n; i++) {
    hex[2 * i] = d[bytes[i] >> 4];
    hex[2 * i + 1] = d[bytes[i] & 15];
  }
  return hex;
}

std::string hex_digest_of_file(const char *path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return "";
  ytpu_blake2b_state s;
  ytpu_blake2b_init(&s, 32);
  char buf[1 << 16];
  ssize_t n;
  while ((n = read(fd, buf, sizeof buf)) > 0) ytpu_blake2b_update(&s, buf, n);
  close(fd);
  uint8_t out[32];
  ytpu_blake2b_final(&s, out);
  return hex_encode(out, 32);
}

// --------------------------------------------------------------- http --

struct HttpResponse {
  int status = -1;
  std::string body;
};

HttpResponse call_daemon(const std::string &method, const std::string &path,
                         const std::string &body) {
  HttpResponse resp;
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return resp;
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
  // A stalled daemon must fail the call, not hang make -jN forever;
  // long-poll endpoints answer within ~2s, so 30s is generous.
  struct timeval tv{30, 0};
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof tv);
  setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof tv);
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(env_int("YTPU_DAEMON_PORT", 8334));
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  if (connect(fd, (sockaddr *)&addr, sizeof addr) != 0) {
    close(fd);
    return resp;
  }
  char header[512];
  int hl = snprintf(header, sizeof header,
                    "%s %s HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                    "Content-Length: %zu\r\nConnection: close\r\n\r\n",
                    method.c_str(), path.c_str(), body.size());
  std::string req(header, hl);
  req += body;
  size_t off = 0;
  while (off < req.size()) {
    ssize_t n = write(fd, req.data() + off, req.size() - off);
    if (n <= 0) {
      close(fd);
      return resp;
    }
    off += n;
  }
  std::string raw;
  char buf[1 << 16];
  ssize_t n;
  while ((n = read(fd, buf, sizeof buf)) > 0) raw.append(buf, n);
  close(fd);
  size_t sp = raw.find(' ');
  if (sp == std::string::npos) return resp;
  resp.status = atoi(raw.c_str() + sp + 1);
  size_t eoh = raw.find("\r\n\r\n");
  if (eoh != std::string::npos) resp.body = raw.substr(eoh + 4);
  return resp;
}

// -------------------------------------------------------- multi-chunk --

std::string make_multi_chunk(const std::vector<std::string> &chunks) {
  std::string header;
  for (size_t i = 0; i < chunks.size(); i++) {
    if (i) header += ',';
    header += std::to_string(chunks[i].size());
  }
  header += "\r\n";
  for (const auto &c : chunks) header += c;
  return header;
}

bool parse_multi_chunk(const std::string &data,
                       std::vector<std::string> *out) {
  size_t eol = data.find("\r\n");
  if (eol == std::string::npos) return false;
  std::vector<size_t> lens;
  size_t pos = 0;
  while (pos < eol) {
    size_t comma = data.find(',', pos);
    if (comma == std::string::npos || comma > eol) comma = eol;
    lens.push_back(strtoul(data.substr(pos, comma - pos).c_str(), nullptr, 10));
    pos = comma + 1;
  }
  size_t off = eol + 2;
  for (size_t len : lens) {
    if (off + len > data.size()) return false;
    out->push_back(data.substr(off, len));
    off += len;
  }
  return off == data.size();
}

// ----------------------------------------------------------- tiny json --

// Emission with escaping.
std::string json_str(const std::string &s) {
  std::string out = "\"";
  for (unsigned char c : s) {
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\n': out += "\\n"; break;
      case '\r': out += "\\r"; break;
      case '\t': out += "\\t"; break;
      default:
        if (c < 0x20) {
          char u[8];
          snprintf(u, sizeof u, "\\u%04x", c);
          out += u;
        } else {
          out += (char)c;
        }
    }
  }
  return out + "\"";
}

// Minimal recursive parser for the daemon's regular responses.
struct Json {
  enum Kind { NUL, BOOL, NUM, STR, ARR, OBJ } kind = NUL;
  bool b = false;
  double num = 0;
  std::string str;
  std::vector<Json> arr;
  std::map<std::string, Json> obj;

  const Json *get(const std::string &k) const {
    auto it = obj.find(k);
    return it == obj.end() ? nullptr : &it->second;
  }
  std::string as_str(const std::string &dflt = "") const {
    return kind == STR ? str : dflt;
  }
  long long as_int(long long dflt = 0) const {
    if (kind == NUM) return (long long)num;
    if (kind == STR) return atoll(str.c_str());  // proto3 int64-as-string
    return dflt;
  }
};

struct JsonParser {
  const char *p, *end;
  bool ok = true;
  void ws() { while (p < end && (*p == ' ' || *p == '\n' || *p == '\r' || *p == '\t')) p++; }
  Json parse() {
    ws();
    if (p >= end) { ok = false; return {}; }
    switch (*p) {
      case '{': return parse_obj();
      case '[': return parse_arr();
      case '"': return parse_str();
      case 't': p += 4; { Json j; j.kind = Json::BOOL; j.b = true; return j; }
      case 'f': p += 5; { Json j; j.kind = Json::BOOL; return j; }
      case 'n': p += 4; return {};
      default: return parse_num();
    }
  }
  Json parse_str() {
    Json j;
    j.kind = Json::STR;
    p++;  // opening quote
    while (p < end && *p != '"') {
      if (*p == '\\' && p + 1 < end) {
        p++;
        switch (*p) {
          case 'n': j.str += '\n'; break;
          case 'r': j.str += '\r'; break;
          case 't': j.str += '\t'; break;
          case 'u': {
            if (p + 4 < end) {
              unsigned cp = strtoul(std::string(p + 1, p + 5).c_str(),
                                    nullptr, 16);
              if (cp < 0x80) j.str += (char)cp;
              else if (cp < 0x800) {
                j.str += (char)(0xC0 | (cp >> 6));
                j.str += (char)(0x80 | (cp & 0x3F));
              } else {
                j.str += (char)(0xE0 | (cp >> 12));
                j.str += (char)(0x80 | ((cp >> 6) & 0x3F));
                j.str += (char)(0x80 | (cp & 0x3F));
              }
              p += 4;
            }
            break;
          }
          default: j.str += *p;
        }
      } else {
        j.str += *p;
      }
      p++;
    }
    if (p < end) p++;  // closing quote
    return j;
  }
  Json parse_num() {
    Json j;
    j.kind = Json::NUM;
    char *np = nullptr;
    j.num = strtod(p, &np);
    if (np == p) ok = false;
    p = np;
    return j;
  }
  Json parse_arr() {
    Json j;
    j.kind = Json::ARR;
    p++;
    ws();
    if (p < end && *p == ']') { p++; return j; }
    while (p < end) {
      j.arr.push_back(parse());
      ws();
      if (p < end && *p == ',') { p++; continue; }
      break;
    }
    if (p < end && *p == ']') p++;
    return j;
  }
  Json parse_obj() {
    Json j;
    j.kind = Json::OBJ;
    p++;
    ws();
    if (p < end && *p == '}') { p++; return j; }
    while (p < end) {
      ws();
      if (p >= end || *p != '"') { ok = false; break; }
      Json key = parse_str();
      ws();
      if (p < end && *p == ':') p++;
      j.obj[key.str] = parse();
      ws();
      if (p < end && *p == ',') { p++; continue; }
      break;
    }
    if (p < end && *p == '}') p++;
    return j;
  }
};

Json parse_json(const std::string &s, bool *ok) {
  JsonParser jp{s.data(), s.data() + s.size()};
  Json j = jp.parse();
  *ok = jp.ok;
  return j;
}

std::string b64_decode(const std::string &in) {
  static int8_t T[256];
  static bool init = false;
  if (!init) {
    memset(T, -1, sizeof T);
    const char *al =
        "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/";
    for (int i = 0; i < 64; i++) T[(unsigned char)al[i]] = i;
    init = true;
  }
  std::string out;
  int val = 0, bits = 0;
  for (unsigned char c : in) {
    if (T[c] < 0) continue;
    val = (val << 6) | T[c];
    bits += 6;
    if (bits >= 8) {
      bits -= 8;
      out += (char)((val >> bits) & 0xFF);
    }
  }
  return out;
}

// --------------------------------------------------------------- quota --

bool acquire_quota(bool lightweight) {
  char body[160];
  snprintf(body, sizeof body,
           "{\"milliseconds_to_wait\": 10000, \"lightweight_task\": %s, "
           "\"requestor_pid\": %d}",
           lightweight ? "true" : "false", (int)getpid());
  // 503 = timed out waiting, retry — but bounded (parity with the
  // Python client's 3600s cap), so a quota leak can't hang forever.
  for (int i = 0; i < 360; i++) {
    HttpResponse r = call_daemon("POST", "/local/acquire_quota", body);
    if (r.status == 200) return true;
    if (r.status == -1) return false;  // no daemon
    if (r.status != 503) return false;
  }
  return false;
}

void release_quota() {
  char body[64];
  snprintf(body, sizeof body, "{\"requestor_pid\": %d}", (int)getpid());
  call_daemon("POST", "/local/release_quota", body);
}

// --------------------------------------------------------------- args --

// Must stay in sync with yadcc_tpu_torch/client/compiler_args.py
// _OPTIONS_WITH_VALUE: the two clients must parse identical argv into
// identical remote invocations, or they diverge on cache keys.
const char *const kValueOpts[] = {
    "-o", "-x", "-include", "-imacros", "-isystem", "-iquote", "-idirafter",
    "-iprefix", "-iwithprefix", "-iwithprefixbefore", "-isysroot", "-I",
    "-L", "-D", "-U", "-MF", "-MT", "-MQ", "-arch", "-Xpreprocessor",
    "-Xassembler", "-Xlinker", "-Xclang", "-T", "-u", "-z", "-G",
    "--param", "-aux-info", "-A", "-l", "-e",
};

bool takes_value(const std::string &a) {
  for (const char *o : kValueOpts)
    if (a == o) return true;
  return false;
}

struct Args {
  std::string compiler;            // as invoked (g++, clang++, ...)
  std::vector<std::string> tail;   // everything after argv[0]
  std::vector<std::string> sources;
  std::string output;
  bool has_c = false;

  static Args parse(int argc, char **argv) {
    Args a;
    a.compiler = argv[0];
    for (int i = 1; i < argc; i++) a.tail.push_back(argv[i]);
    for (size_t i = 0; i < a.tail.size(); i++) {
      const std::string &t = a.tail[i];
      if (takes_value(t) && i + 1 < a.tail.size()) {
        if (t == "-o") a.output = a.tail[i + 1];
        i++;
        continue;
      }
      if (!t.empty() && t[0] == '-') {
        if (t == "-c") a.has_c = true;
        if (t.rfind("-o", 0) == 0 && t.size() > 2) a.output = t.substr(2);
        continue;
      }
      a.sources.push_back(t);
    }
    return a;
  }

  bool has(const std::string &opt) const {
    for (const auto &t : tail)
      if (t == opt) return true;
    return false;
  }

  // Like has(), but skips option VALUES (a token after -o/-MF/... is
  // data, not a flag) — parity with the Python CompilerArgs.has(),
  // which matches against parsed options only.
  bool has_flag(const std::string &opt) const {
    for (size_t i = 0; i < tail.size(); i++) {
      if (takes_value(tail[i]) && i + 1 < tail.size()) {
        i++;
        continue;
      }
      if (tail[i] == opt) return true;
    }
    return false;
  }
};

bool ends_with(const std::string &s, const char *suf) {
  size_t n = strlen(suf);
  return s.size() >= n && s.compare(s.size() - n, n, suf) == 0;
}

bool is_distributable(const Args &a, const char **why) {
  *why = "";
  if (!a.has_c) { *why = "-c missing"; return false; }
  if (a.sources.size() != 1) { *why = "not exactly one input"; return false; }
  const std::string &s = a.sources[0];
  if (s == "-") { *why = "stdin"; return false; }
  if (ends_with(s, ".s") || ends_with(s, ".S")) { *why = "assembly"; return false; }
  static const char *ok[] = {".c", ".cc", ".cp", ".cxx", ".cpp", ".c++",
                             ".C", ".i", ".ii"};
  bool good = false;
  for (const char *suf : ok)
    if (ends_with(s, suf)) good = true;
  if (!good) { *why = "unknown suffix"; return false; }
  if (a.has("-E") || a.has("-S")) { *why = "-E/-S"; return false; }
  if (a.has("-march=native") || a.has("-mtune=native")) {
    *why = "machine-dependent flags";
    return false;
  }
  for (const auto &t : a.tail) {
    if (t.rfind("-fplugin", 0) == 0 || t.rfind("-specs", 0) == 0) {
      *why = "compiler plugins/specs are local-only";
      return false;
    }
  }
  return true;
}

std::string find_real_compiler(const std::string &invoked) {
  std::string base = invoked;
  size_t slash = base.rfind('/');
  if (slash != std::string::npos) base = base.substr(slash + 1);
  char self[4096];
  ssize_t sl = readlink("/proc/self/exe", self, sizeof self - 1);
  std::string me = sl > 0 ? std::string(self, sl) : "";
  const char *path = getenv("PATH");
  if (!path) return "";
  const char *farm = getenv("YTPU_WRAPPER_DIR");  // installer's own dir
  std::string p(path);
  size_t pos = 0;
  while (pos <= p.size()) {
    size_t colon = p.find(':', pos);
    if (colon == std::string::npos) colon = p.size();
    std::string dir = p.substr(pos, colon - pos);
    pos = colon + 1;
    if (farm && dir == farm) continue;
    std::string cand = dir + "/" + base;
    char real[4096];
    if (access(cand.c_str(), X_OK) != 0) continue;
    if (!realpath(cand.c_str(), real)) continue;
    std::string r(real);
    if (r == me) continue;
    bool wrapper = false;
    for (const char *m : {"ccache", "distcc", "icecc", "ytpu", "yadcc"})
      if (r.find(m) != std::string::npos) wrapper = true;
    if (wrapper) continue;
    return cand;
  }
  return "";
}

// ---------------------------------------------------------- preprocess --

// ------------------------------------------------------------- frames --

// The source's streaming compressor: one zstd frame, or a "YZFS" frame
// (the magic, then one zlib stream; common/_zlib_frames.py).
class SourceCompressor {
 public:
  explicit SourceCompressor(std::string *out) : out_(out) {
#ifdef YTPU_ZLIB_FRAMES
    memset(&zs_, 0, sizeof zs_);
    deflateInit(&zs_, 3);
    out_->append("YZFS");
#else
    cctx_ = ZSTD_createCCtx();
    ZSTD_CCtx_setParameter(cctx_, ZSTD_c_compressionLevel, 3);
#endif
  }
  ~SourceCompressor() {
#ifdef YTPU_ZLIB_FRAMES
    deflateEnd(&zs_);
#else
    ZSTD_freeCCtx(cctx_);
#endif
  }
  void update(const char *data, size_t n) {
#ifdef YTPU_ZLIB_FRAMES
    zs_.next_in = (Bytef *)data;
    zs_.avail_in = (uInt)n;
    do {
      zs_.next_out = (Bytef *)buf_;
      zs_.avail_out = sizeof buf_;
      deflate(&zs_, Z_NO_FLUSH);
      out_->append(buf_, sizeof buf_ - zs_.avail_out);
    } while (zs_.avail_out == 0);
#else
    ZSTD_inBuffer zin{data, n, 0};
    while (zin.pos < zin.size) {
      ZSTD_outBuffer zout{buf_, sizeof buf_, 0};
      ZSTD_compressStream2(cctx_, &zout, &zin, ZSTD_e_continue);
      out_->append(buf_, zout.pos);
    }
#endif
  }
  void finish() {
#ifdef YTPU_ZLIB_FRAMES
    zs_.next_in = nullptr;
    zs_.avail_in = 0;
    int ret;
    do {
      zs_.next_out = (Bytef *)buf_;
      zs_.avail_out = sizeof buf_;
      ret = deflate(&zs_, Z_FINISH);
      out_->append(buf_, sizeof buf_ - zs_.avail_out);
    } while (ret != Z_STREAM_END);
#else
    for (;;) {
      ZSTD_inBuffer zin{nullptr, 0, 0};
      ZSTD_outBuffer zout{buf_, sizeof buf_, 0};
      size_t rem = ZSTD_compressStream2(cctx_, &zout, &zin, ZSTD_e_end);
      out_->append(buf_, zout.pos);
      if (rem == 0) break;
    }
#endif
  }

 private:
  std::string *out_;
  char buf_[1 << 16];
#ifdef YTPU_ZLIB_FRAMES
  z_stream zs_;
#else
  ZSTD_CCtx *cctx_;
#endif
};

// One of the daemon's compressed outputs: a zstd frame, or a "YZF1"
// (u64le declared size) / "YZFS" zlib frame.
bool frame_decompress(const std::string &in, std::string *out) {
#ifdef YTPU_ZLIB_FRAMES
  size_t off;
  long long declared = -1;
  if (in.compare(0, 4, "YZF1") == 0 && in.size() >= 12) {
    uint64_t n = 0;
    for (int i = 0; i < 8; i++) n |= (uint64_t)(unsigned char)in[4 + i] << (8 * i);
    declared = (long long)n;
    off = 12;
  } else if (in.compare(0, 4, "YZFS") == 0) {
    off = 4;
  } else {
    return false;
  }
  z_stream zs;
  memset(&zs, 0, sizeof zs);
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_in = (Bytef *)in.data() + off;
  zs.avail_in = (uInt)(in.size() - off);
  char buf[1 << 16];
  int ret;
  do {
    zs.next_out = (Bytef *)buf;
    zs.avail_out = sizeof buf;
    ret = inflate(&zs, Z_NO_FLUSH);
    if (ret != Z_OK && ret != Z_STREAM_END) {
      inflateEnd(&zs);
      return false;
    }
    out->append(buf, sizeof buf - zs.avail_out);
  } while (ret != Z_STREAM_END);
  inflateEnd(&zs);
  return declared < 0 || (size_t)declared == out->size();
#else
  ZSTD_DCtx *dctx = ZSTD_createDCtx();
  ZSTD_inBuffer zin{in.data(), in.size(), 0};
  char buf[1 << 16];
  size_t ret = 1;
  while (zin.pos < zin.size) {
    ZSTD_outBuffer zout{buf, sizeof buf, 0};
    ret = ZSTD_decompressStream(dctx, &zout, &zin);
    if (ZSTD_isError(ret)) {
      ZSTD_freeDCtx(dctx);
      return false;
    }
    out->append(buf, zout.pos);
  }
  ZSTD_freeDCtx(dctx);
  return ret == 0 || zin.pos == zin.size;
#endif
}

struct Preprocessed {
  std::string compressed;  // the source's frame (see SourceCompressor)
  std::string digest;      // hex blake2b-256 of the raw bytes
  size_t raw_size = 0;
  bool directives_only = false;
};

// Run the compiler with `extra` preprocessing flags, streaming stdout
// through blake2b + the frame compressor in one pass (reference
// rewrite_file.cc:75-120).
bool run_preprocess(const std::string &compiler, const Args &a,
                    const std::vector<std::string> &extra, Preprocessed *out) {
  std::vector<std::string> argv_s{compiler};
  argv_s.insert(argv_s.end(), extra.begin(), extra.end());
  for (size_t i = 0; i < a.tail.size(); i++) {
    const std::string &t = a.tail[i];
    if (t == "-c") continue;
    if (t == "-o") { i++; continue; }
    if (t.rfind("-o", 0) == 0 && t.size() > 2) continue;
    argv_s.push_back(t);
  }
  int pipefd[2];
  if (pipe(pipefd) != 0) return false;
  pid_t pid = fork();
  if (pid < 0) return false;
  if (pid == 0) {
    dup2(pipefd[1], 1);
    close(pipefd[0]);
    close(pipefd[1]);
    // Inject the fakeroot preload when present (linemarker rewriting).
    char pre[4096];
    ssize_t sl = readlink("/proc/self/exe", pre, sizeof pre - 1);
    if (sl > 0) {
      std::string dir(pre, sl);
      size_t slash = dir.rfind('/');
      if (slash != std::string::npos) dir = dir.substr(0, slash);
      std::string shim = dir + "/libytpufakeroot.so";
      if (access(shim.c_str(), R_OK) == 0) {
        setenv("LD_PRELOAD", shim.c_str(), 1);
        char realc[4096];
        if (realpath(compiler.c_str(), realc)) {
          std::string root(realc);
          size_t s2 = root.rfind('/');
          if (s2 != std::string::npos) root = root.substr(0, s2);
          s2 = root.rfind('/');
          if (s2 != std::string::npos) root = root.substr(0, s2);
          setenv("YTPU_INTERNAL_COMPILER_PATH", root.c_str(), 1);
        }
      }
    }
    std::vector<char *> argv_c;
    for (auto &s : argv_s) argv_c.push_back(const_cast<char *>(s.c_str()));
    argv_c.push_back(nullptr);
    execvp(argv_c[0], argv_c.data());
    _exit(127);
  }
  close(pipefd[1]);
  ytpu_blake2b_state bs;
  ytpu_blake2b_init(&bs, 32);
  std::string compressed;
  SourceCompressor comp(&compressed);
  char inbuf[1 << 16];
  size_t total = 0;
  ssize_t n;
  while ((n = read(pipefd[0], inbuf, sizeof inbuf)) > 0) {
    ytpu_blake2b_update(&bs, inbuf, n);
    total += n;
    comp.update(inbuf, (size_t)n);
  }
  close(pipefd[0]);
  comp.finish();  // flush the frame
  int status = 0;
  waitpid(pid, &status, 0);
  if (!WIFEXITED(status) || WEXITSTATUS(status) != 0) return false;
  uint8_t raw[32];
  ytpu_blake2b_final(&bs, raw);
  out->digest = hex_encode(raw, 32);
  out->compressed = std::move(compressed);
  out->raw_size = total;
  return true;
}

// ------------------------------------------------------------- remote --

// Byte-identical to Python's shlex.quote: the invocation string feeds
// get_cxx_task_digest/get_cache_key, so a fleet mixing this client with
// the Python one must produce the same cache keys for the same compile.
// shlex.quote leaves strings matching [A-Za-z0-9_@%+=:,./-]+ bare and
// otherwise single-quotes, escaping embedded quotes as '"'"'.
std::string shell_quote(const std::string &s) {
  if (s.empty()) return "''";
  bool safe = true;
  for (unsigned char c : s) {
    if ((c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
        (c >= '0' && c <= '9') || strchr("_@%+=:,./-", c))
      continue;
    safe = false;
    break;
  }
  if (safe) return s;
  std::string out = "'";
  for (char c : s) {
    if (c == '\'') out += "'\"'\"'";
    else out += c;
  }
  return out + "'";
}

std::string remote_invocation(const Args &a, bool directives_only) {
  std::string inv;
  for (size_t i = 0; i < a.tail.size(); i++) {
    const std::string &t = a.tail[i];
    // Same removal set as the Python client (yadcc_cxx.py remote_args
    // rewrite): exact {-c,-imacros} plus prefixes
    // {-o,-M,-I,-iquote,-isystem,-include,-Wp,}.
    bool skip = t == "-c" || t == "-imacros" || t.rfind("-o", 0) == 0 ||
                t.rfind("-M", 0) == 0 || t.rfind("-I", 0) == 0 ||
                t.rfind("-iquote", 0) == 0 || t.rfind("-isystem", 0) == 0 ||
                t.rfind("-include", 0) == 0 || t.rfind("-Wp,", 0) == 0;
    bool is_src = false;
    for (const auto &s : a.sources)
      if (t == s) is_src = true;
    if (is_src) continue;
    if (takes_value(t) && i + 1 < a.tail.size()) {
      if (!skip) {
        if (!inv.empty()) inv += ' ';
        inv += shell_quote(t) + " " + shell_quote(a.tail[i + 1]);
      }
      i++;
      continue;
    }
    if (skip) continue;
    if (!inv.empty()) inv += ' ';
    inv += shell_quote(t);
  }
  if (directives_only) {
    if (!inv.empty()) inv += ' ';
    inv += "-fpreprocessed -fdirectives-only";
  }
  return inv;
}

// Reference IsLightweightTask (yadcc-cxx.cc:68-81), mirrored by the
// Python client's _is_lightweight_task: version probes and
// preprocessing take the 1.5x-cores quota class so a configure stage
// doesn't serialize behind real compiles.  Stdin sources opt in via
// YTPU_TREAT_SOURCE_FROM_STDIN_AS_LIGHTWEIGHT.
bool is_lightweight_task(const Args &a) {
  if (a.has_flag("-dumpversion") || a.has_flag("-dumpmachine") ||
      a.has_flag("-E"))
    return true;
  // A bare "-" in a non-value position is the stdin source; one in a
  // value position (`-o -`, `-MF -`) is just data for that option and
  // must not reclassify a real compile.
  return env_int("YTPU_TREAT_SOURCE_FROM_STDIN_AS_LIGHTWEIGHT", 0) &&
         a.has_flag("-");
}

int compile_locally(const std::string &compiler, const Args &a, char **argv) {
  bool got = acquire_quota(is_lightweight_task(a));
  pid_t pid = fork();
  if (pid == 0) {
    std::vector<char *> args;
    args.push_back(const_cast<char *>(compiler.c_str()));
    for (int i = 1; argv[i]; i++) args.push_back(argv[i]);
    args.push_back(nullptr);
    execvp(args[0], args.data());
    _exit(127);
  }
  int status = 0;
  waitpid(pid, &status, 0);
  if (got) release_quota();
  return WIFEXITED(status) ? WEXITSTATUS(status) : 128;
}

struct FileDescJson {
  std::string json;  // {"path":..., "size":"..", "timestamp":".."}
};

FileDescJson file_desc(const std::string &path) {
  struct stat st{};
  stat(path.c_str(), &st);
  FileDescJson f;
  f.json = "{\"path\": " + json_str(path) + ", \"size\": \"" +
           std::to_string((long long)st.st_size) + "\", \"timestamp\": \"" +
           std::to_string((long long)st.st_mtime) + "\"}";
  return f;
}

}  // namespace

#ifndef YTPU_NO_MAIN
int main(int argc, char **argv) {
  // `ytpu-cxx g++ ...` form: shift so argv[0] is the compiler name.
  std::string self = argv[0];
  size_t slash = self.rfind('/');
  std::string base = slash == std::string::npos ? self : self.substr(slash + 1);
  if (base == "ytpu-cxx" && argc > 1) {
    argv++;
    argc--;
  }
  Args args = Args::parse(argc, argv);
  std::string compiler = find_real_compiler(args.compiler);
  if (compiler.empty()) {
    logf(40, "cannot find real compiler for '%s'", args.compiler.c_str());
    return 127;
  }

  if (env_int("YTPU_DEBUGGING_COMPILE_LOCALLY", 0)) {
    // Same knob as the Python client: isolate whether a bad object
    // came from distribution or from the compiler itself.
    logf(30, "YTPU_DEBUGGING_COMPILE_LOCALLY=1: compiling locally");
    return compile_locally(compiler, args, argv);
  }

  const char *why = "";
  if (!is_distributable(args, &why)) {
    logf(10, "local (%s)", why);
    return compile_locally(compiler, args, argv);
  }

  // Preprocess under lightweight quota.
  bool quota = acquire_quota(true);
  if (!quota) {
    logf(30, "daemon unreachable; compiling locally");
    return compile_locally(compiler, args, argv);
  }
  Preprocessed pre;
  bool ok = run_preprocess(
      compiler, args,
      {"-E", "-fdirectives-only", "-fno-working-directory"}, &pre);
  if (ok) {
    pre.directives_only = true;
  } else {
    ok = run_preprocess(compiler, args, {"-E", "-fno-working-directory"},
                        &pre);
  }
  release_quota();
  if (!ok) return compile_locally(compiler, args, argv);  // show real diagnostics
  if ((long)pre.raw_size <
      env_int("YTPU_COMPILE_ON_CLOUD_SIZE_THRESHOLD", 8192))
    return compile_locally(compiler, args, argv);

  int cache_control = env_int("YTPU_CACHE_CONTROL", 1);
  std::string inv = remote_invocation(args, pre.directives_only);
  char cwd[4096];
  if (!getcwd(cwd, sizeof cwd)) strcpy(cwd, ".");
  std::string abs_src = args.sources[0][0] == '/'
                            ? args.sources[0]
                            : std::string(cwd) + "/" + args.sources[0];

  for (int attempt = 0; attempt < 5; attempt++) {
    // ---- submit (with one compiler-digest report retry) ----
    std::string submit_json =
        "{\"requestor_process_id\": " + std::to_string((int)getpid()) +
        ", \"source_path\": " + json_str(abs_src) +
        ", \"source_digest\": " + json_str(pre.digest) +
        ", \"compiler_invocation_arguments\": " + json_str(inv) +
        ", \"cache_control\": " + std::to_string(cache_control) +
        ", \"ignore_timestamp_macros\": " +
        (env_int("YTPU_IGNORE_TIMESTAMP_MACROS", 0) ? "true" : "false") +
        ", \"compiler\": " + file_desc(compiler).json + "}";
    std::string body = make_multi_chunk({submit_json, pre.compressed});
    HttpResponse r = call_daemon("POST", "/local/submit_cxx_task", body);
    if (r.status == 400) {
      std::string digest = hex_digest_of_file(compiler.c_str());
      std::string rep = "{\"file_desc\": " + file_desc(compiler).json +
                        ", \"digest\": " + json_str(digest) + "}";
      call_daemon("POST", "/local/set_file_digest", rep);
      r = call_daemon("POST", "/local/submit_cxx_task", body);
    }
    if (r.status != 200) {
      logf(30, "submit failed (HTTP %d)", r.status);
      continue;
    }
    bool jok = false;
    Json sj = parse_json(r.body, &jok);
    const Json *tid = jok ? sj.get("task_id") : nullptr;
    if (!tid) continue;
    long long task_id = tid->as_int();

    // ---- long-poll ----
    std::string wait_json = "{\"task_id\": \"" + std::to_string(task_id) +
                            "\", \"milliseconds_to_wait\": 2000}";
    HttpResponse w;
    for (int poll = 0; poll < 600; poll++) {  // up to ~20 min
      w = call_daemon("POST", "/local/wait_for_cxx_task", wait_json);
      if (w.status != 503) break;
    }
    if (w.status != 200) {
      logf(30, "wait failed (HTTP %d)", w.status);
      continue;
    }
    std::vector<std::string> chunks;
    if (!parse_multi_chunk(w.body, &chunks) || chunks.empty()) continue;
    Json meta = parse_json(chunks[0], &jok);
    if (!jok) continue;
    long long ec = meta.get("exit_code") ? meta.get("exit_code")->as_int() : -1;
    std::string serr =
        meta.get("error") ? meta.get("error")->as_str() : "";
    std::string sout =
        meta.get("output") ? meta.get("output")->as_str() : "";
    if (ec < 0 || ec == 127) {
      logf(30, "cloud infrastructure failure (%lld); retrying", ec);
      continue;
    }
    if (ec != 0) {
      fputs(serr.c_str(), stderr);
      fputs(sout.c_str(), stdout);
      return (int)ec;
    }
    // ---- outputs ----
    std::string out_path = args.output.empty()
                               ? [&] {
                                   std::string s = args.sources[0];
                                   size_t sl2 = s.rfind('/');
                                   if (sl2 != std::string::npos)
                                     s = s.substr(sl2 + 1);
                                   size_t dot = s.rfind('.');
                                   if (dot != std::string::npos)
                                     s = s.substr(0, dot);
                                   return s + ".o";
                                 }()
                               : args.output;
    std::string stem = ends_with(out_path, ".o")
                           ? out_path.substr(0, out_path.size() - 2)
                           : out_path;
    std::string client_dir = abs_src.substr(0, abs_src.rfind('/'));
    const Json *exts = meta.get("file_extensions");
    const Json *patches = meta.get("patches");
    size_t nfiles = exts && exts->kind == Json::ARR ? exts->arr.size() : 0;
    for (size_t i = 0; i < nfiles && i + 1 < chunks.size(); i++) {
      std::string ext = exts->arr[i].as_str();
      std::string data;
      if (!frame_decompress(chunks[i + 1], &data)) {
        logf(40, "corrupt output for %s", ext.c_str());
        return compile_locally(compiler, args, argv);
      }
      if (patches && patches->kind == Json::ARR) {
        for (const Json &pl : patches->arr) {
          if (!pl.get("file_key") || pl.get("file_key")->as_str() != ext)
            continue;
          const Json *locs = pl.get("locations");
          if (!locs || locs->kind != Json::ARR) continue;
          for (const Json &loc : locs->arr) {
            size_t pos = loc.get("position") ? loc.get("position")->as_int() : 0;
            size_t total =
                loc.get("total_size") ? loc.get("total_size")->as_int() : 0;
            std::string suffix =
                loc.get("suffix_to_keep")
                    ? b64_decode(loc.get("suffix_to_keep")->as_str())
                    : "";
            std::string repl = client_dir + suffix;
            if (repl.size() > total || pos + total > data.size()) continue;
            repl.resize(total, '\0');
            data.replace(pos, total, repl);
          }
        }
      }
      std::string target = ext == ".o" ? out_path : stem + ext;
      FILE *fp = fopen(target.c_str(), "wb");
      if (!fp) {
        logf(40, "cannot write %s", target.c_str());
        return 1;
      }
      size_t wrote = fwrite(data.data(), 1, data.size(), fp);
      if (wrote != data.size() || fclose(fp) != 0) {
        // A truncated object must never look like success to make.
        logf(40, "short write to %s: %s", target.c_str(), strerror(errno));
        unlink(target.c_str());
        return 1;
      }
    }
    fputs(serr.c_str(), stderr);
    fputs(sout.c_str(), stdout);
    return 0;
  }
  logf(30, "cloud failed repeatedly; falling back locally");
  return compile_locally(compiler, args, argv);
}
#endif  // YTPU_NO_MAIN
