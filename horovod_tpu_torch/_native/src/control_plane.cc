// Native control plane: HMAC-authenticated TCP key-value store + barriers,
// and a buffered Chrome-trace timeline writer.
//
// The port's copy of horovod_tpu/_native/src/control_plane.cc.  Reference
// parity: the reference's native coordination machinery — the rendezvous KV
// server the launcher runs (horovod/runner/http/http_server.py backed by the
// gloo rendezvous in C++), the HMAC envelope of
// runner/common/service/network.py, and the TimelineWriter thread of
// horovod/common/timeline.cc.  The wire protocol is byte-identical to the
// Python implementation in horovod_tpu_torch/runner/rendezvous.py (and the
// JAX package's):
//
//     <hmac_sha256_hex(secret, payload)> <base64(payload)>\n
//
// payload = flat JSON {"op": PUT|GET|WAIT|DEL|KEYS|BARRIER|PING|SHUTDOWN,...}
//
// Exposed through a plain C API loaded via ctypes; built with the host's g++
// into horovod_tpu_torch/build/ at first use (horovod_tpu_torch/_native).
// LEASE is not served ("unknown op"): the client's renew_lease is
// best-effort, and the driver judges leases by heartbeat values it GETs.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <array>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <set>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// SHA-256 (FIPS 180-4) — self-contained, no OpenSSL dependency.
// ---------------------------------------------------------------------------

struct Sha256 {
  uint32_t h[8];
  uint64_t len = 0;
  uint8_t buf[64];
  size_t buflen = 0;

  Sha256() {
    static const uint32_t init[8] = {
        0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
        0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
    memcpy(h, init, sizeof(init));
  }

  static uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

  void block(const uint8_t* p) {
    static const uint32_t k[64] = {
        0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b,
        0x59f111f1, 0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01,
        0x243185be, 0x550c7dc3, 0x72be5d74, 0x80deb1fe, 0x9bdc06a7,
        0xc19bf174, 0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
        0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da, 0x983e5152,
        0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
        0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc,
        0x53380d13, 0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
        0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3, 0xd192e819,
        0xd6990624, 0xf40e3585, 0x106aa070, 0x19a4c116, 0x1e376c08,
        0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f,
        0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
        0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};
    uint32_t w[64];
    for (int i = 0; i < 16; i++)
      w[i] = (uint32_t(p[i * 4]) << 24) | (uint32_t(p[i * 4 + 1]) << 16) |
             (uint32_t(p[i * 4 + 2]) << 8) | uint32_t(p[i * 4 + 3]);
    for (int i = 16; i < 64; i++) {
      uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
      uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5],
             g = h[6], hh = h[7];
    for (int i = 0; i < 64; i++) {
      uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      uint32_t ch = (e & f) ^ (~e & g);
      uint32_t t1 = hh + S1 + ch + k[i] + w[i];
      uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      uint32_t mj = (a & b) ^ (a & c) ^ (b & c);
      uint32_t t2 = S0 + mj;
      hh = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
  }

  void update(const uint8_t* p, size_t n) {
    len += n;
    while (n > 0) {
      size_t take = std::min(n, sizeof(buf) - buflen);
      memcpy(buf + buflen, p, take);
      buflen += take; p += take; n -= take;
      if (buflen == 64) { block(buf); buflen = 0; }
    }
  }

  void final(uint8_t out[32]) {
    uint64_t bitlen = len * 8;
    uint8_t pad = 0x80;
    update(&pad, 1);
    uint8_t zero = 0;
    while (buflen != 56) update(&zero, 1);
    uint8_t lenb[8];
    for (int i = 0; i < 8; i++) lenb[i] = uint8_t(bitlen >> (56 - i * 8));
    update(lenb, 8);
    for (int i = 0; i < 8; i++) {
      out[i * 4] = uint8_t(h[i] >> 24);
      out[i * 4 + 1] = uint8_t(h[i] >> 16);
      out[i * 4 + 2] = uint8_t(h[i] >> 8);
      out[i * 4 + 3] = uint8_t(h[i]);
    }
  }
};

void hmac_sha256(const std::string& key, const std::string& msg,
                 uint8_t out[32]) {
  uint8_t k[64] = {0};
  if (key.size() > 64) {
    Sha256 kh;
    kh.update((const uint8_t*)key.data(), key.size());
    kh.final(k);
  } else {
    memcpy(k, key.data(), key.size());
  }
  uint8_t ipad[64], opad[64];
  for (int i = 0; i < 64; i++) {
    ipad[i] = k[i] ^ 0x36;
    opad[i] = k[i] ^ 0x5c;
  }
  uint8_t inner[32];
  Sha256 h1;
  h1.update(ipad, 64);
  h1.update((const uint8_t*)msg.data(), msg.size());
  h1.final(inner);
  Sha256 h2;
  h2.update(opad, 64);
  h2.update(inner, 32);
  h2.final(out);
}

std::string hex(const uint8_t* p, size_t n) {
  static const char* d = "0123456789abcdef";
  std::string s(n * 2, '0');
  for (size_t i = 0; i < n; i++) {
    s[i * 2] = d[p[i] >> 4];
    s[i * 2 + 1] = d[p[i] & 15];
  }
  return s;
}

bool const_time_eq(const std::string& a, const std::string& b) {
  if (a.size() != b.size()) return false;
  unsigned char r = 0;
  for (size_t i = 0; i < a.size(); i++) r |= a[i] ^ b[i];
  return r == 0;
}

// ---------------------------------------------------------------------------
// Base64
// ---------------------------------------------------------------------------

const char B64[] =
    "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/";

std::string b64encode(const std::string& in) {
  std::string out;
  out.reserve((in.size() + 2) / 3 * 4);
  size_t i = 0;
  while (i + 2 < in.size()) {
    uint32_t v = (uint8_t(in[i]) << 16) | (uint8_t(in[i + 1]) << 8) |
                 uint8_t(in[i + 2]);
    out += B64[v >> 18]; out += B64[(v >> 12) & 63];
    out += B64[(v >> 6) & 63]; out += B64[v & 63];
    i += 3;
  }
  if (i + 1 == in.size()) {
    uint32_t v = uint8_t(in[i]) << 16;
    out += B64[v >> 18]; out += B64[(v >> 12) & 63]; out += "==";
  } else if (i + 2 == in.size()) {
    uint32_t v = (uint8_t(in[i]) << 16) | (uint8_t(in[i + 1]) << 8);
    out += B64[v >> 18]; out += B64[(v >> 12) & 63];
    out += B64[(v >> 6) & 63]; out += '=';
  }
  return out;
}

int b64val(char c) {
  if (c >= 'A' && c <= 'Z') return c - 'A';
  if (c >= 'a' && c <= 'z') return c - 'a' + 26;
  if (c >= '0' && c <= '9') return c - '0' + 52;
  if (c == '+') return 62;
  if (c == '/') return 63;
  return -1;
}

bool b64decode(const std::string& in, std::string* out) {
  // -1: not base64; -2: skipped ('=' and line breaks).
  static const auto table = [] {
    std::array<int8_t, 256> t;
    t.fill(-1);
    for (int c = 0; c < 256; c++) {
      int v = b64val(char(c));
      if (v >= 0) t[c] = int8_t(v);
    }
    t['='] = t['\n'] = t['\r'] = -2;
    return t;
  }();
  out->clear();
  out->resize(in.size() / 4 * 3 + 3);
  char* o = &(*out)[0];
  size_t n = 0;
  uint32_t acc = 0;
  int bits = 0;
  for (unsigned char c : in) {
    int v = table[c];
    if (v < 0) {
      if (v == -2) continue;
      return false;
    }
    acc = (acc << 6) | uint32_t(v);
    bits += 6;
    if (bits >= 8) {
      bits -= 8;
      o[n++] = char((acc >> bits) & 0xff);
    }
  }
  out->resize(n);
  return true;
}

// ---------------------------------------------------------------------------
// Minimal JSON (flat objects: string keys; string/number/bool/null values;
// arrays of strings) — exactly the shapes the protocol uses.
// ---------------------------------------------------------------------------

struct JsonValue {
  enum Type { STR, NUM, BOOL, NUL } type = NUL;
  std::string str;
  double num = 0;
  bool b = false;
};

bool json_parse_string(const std::string& s, size_t* i, std::string* out) {
  if (s[*i] != '"') return false;
  (*i)++;
  out->clear();
  while (*i < s.size()) {
    char c = s[*i];
    if (c == '"') { (*i)++; return true; }
    if (c == '\\') {
      (*i)++;
      if (*i >= s.size()) return false;
      char e = s[(*i)++];
      switch (e) {
        case '"': out->push_back('"'); break;
        case '\\': out->push_back('\\'); break;
        case '/': out->push_back('/'); break;
        case 'b': out->push_back('\b'); break;
        case 'f': out->push_back('\f'); break;
        case 'n': out->push_back('\n'); break;
        case 'r': out->push_back('\r'); break;
        case 't': out->push_back('\t'); break;
        case 'u': {
          if (*i + 4 > s.size()) return false;
          unsigned cp = 0;
          for (int k = 0; k < 4; k++) {
            char hc = s[(*i)++];
            cp <<= 4;
            if (hc >= '0' && hc <= '9') cp |= hc - '0';
            else if (hc >= 'a' && hc <= 'f') cp |= hc - 'a' + 10;
            else if (hc >= 'A' && hc <= 'F') cp |= hc - 'A' + 10;
            else return false;
          }
          // UTF-8 encode (surrogate pairs for the control plane's flat
          // ASCII-ish payloads are rare; handle BMP directly).
          if (cp < 0x80) out->push_back(char(cp));
          else if (cp < 0x800) {
            out->push_back(char(0xc0 | (cp >> 6)));
            out->push_back(char(0x80 | (cp & 0x3f)));
          } else {
            out->push_back(char(0xe0 | (cp >> 12)));
            out->push_back(char(0x80 | ((cp >> 6) & 0x3f)));
            out->push_back(char(0x80 | (cp & 0x3f)));
          }
          break;
        }
        default: return false;
      }
    } else {
      // A run of plain characters in one append (a reshard chunk's
      // base64 text is megabytes of them).
      size_t j = *i;
      while (j < s.size() && s[j] != '"' && s[j] != '\\') j++;
      out->append(s, *i, j - *i);
      *i = j;
    }
  }
  return false;
}

void json_skip_ws(const std::string& s, size_t* i) {
  while (*i < s.size() && (s[*i] == ' ' || s[*i] == '\t' || s[*i] == '\n' ||
                           s[*i] == '\r'))
    (*i)++;
}

bool json_parse_flat(const std::string& s,
                     std::map<std::string, JsonValue>* out) {
  out->clear();
  size_t i = 0;
  json_skip_ws(s, &i);
  if (i >= s.size() || s[i] != '{') return false;
  i++;
  json_skip_ws(s, &i);
  if (i < s.size() && s[i] == '}') return true;
  while (i < s.size()) {
    std::string key;
    json_skip_ws(s, &i);
    if (!json_parse_string(s, &i, &key)) return false;
    json_skip_ws(s, &i);
    if (i >= s.size() || s[i] != ':') return false;
    i++;
    json_skip_ws(s, &i);
    JsonValue v;
    if (i >= s.size()) return false;
    if (s[i] == '"') {
      v.type = JsonValue::STR;
      if (!json_parse_string(s, &i, &v.str)) return false;
    } else if (s.compare(i, 4, "true") == 0) {
      v.type = JsonValue::BOOL; v.b = true; i += 4;
    } else if (s.compare(i, 5, "false") == 0) {
      v.type = JsonValue::BOOL; v.b = false; i += 5;
    } else if (s.compare(i, 4, "null") == 0) {
      v.type = JsonValue::NUL; i += 4;
    } else {
      v.type = JsonValue::NUM;
      size_t start = i;
      while (i < s.size() && (isdigit(s[i]) || s[i] == '-' || s[i] == '+' ||
                              s[i] == '.' || s[i] == 'e' || s[i] == 'E'))
        i++;
      if (i == start) return false;
      v.num = atof(s.substr(start, i - start).c_str());
    }
    (*out)[key] = v;
    json_skip_ws(s, &i);
    if (i < s.size() && s[i] == ',') { i++; continue; }
    if (i < s.size() && s[i] == '}') return true;
    return false;
  }
  return false;
}

std::string json_escape(const std::string& s) {
  size_t plain = 0;
  while (plain < s.size() && (unsigned char)s[plain] >= 0x20 &&
         s[plain] != '"' && s[plain] != '\\')
    plain++;
  if (plain == s.size()) return s;  // nothing to escape: one copy
  std::string out;
  out.reserve(s.size() + 8);
  out.append(s, 0, plain);
  for (unsigned char c : s.substr(plain)) {
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\n': out += "\\n"; break;
      case '\r': out += "\\r"; break;
      case '\t': out += "\\t"; break;
      case '\b': out += "\\b"; break;
      case '\f': out += "\\f"; break;
      default:
        if (c < 0x20) {
          char buf[8];
          snprintf(buf, sizeof(buf), "\\u%04x", c);
          out += buf;
        } else {
          out.push_back(char(c));
        }
    }
  }
  return out;
}

// ---------------------------------------------------------------------------
// KV store with barriers (semantics identical to rendezvous.py KVStore).
// ---------------------------------------------------------------------------

class KVStore {
 public:
  // Wakes every blocked wait/barrier immediately (server shutdown).
  void shutdown() {
    std::lock_guard<std::mutex> g(mu_);
    shutdown_ = true;
    cv_.notify_all();
  }

  void put(const std::string& k, const std::string& v) {
    std::lock_guard<std::mutex> g(mu_);
    data_[k] = v;
    cv_.notify_all();
  }

  bool get(const std::string& k, std::string* v) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = data_.find(k);
    if (it == data_.end()) return false;
    *v = it->second;
    return true;
  }

  bool wait(const std::string& k, double timeout_s, std::string* v) {
    std::unique_lock<std::mutex> g(mu_);
    auto deadline = std::chrono::steady_clock::now() +
                    std::chrono::duration<double>(timeout_s);
    while (data_.find(k) == data_.end()) {
      if (shutdown_) return false;
      if (cv_.wait_until(g, deadline) == std::cv_status::timeout &&
          data_.find(k) == data_.end())
        return false;
    }
    *v = data_[k];
    return true;
  }

  bool del(const std::string& k) {
    std::lock_guard<std::mutex> g(mu_);
    return data_.erase(k) > 0;
  }

  std::vector<std::string> keys(const std::string& prefix) {
    std::lock_guard<std::mutex> g(mu_);
    std::vector<std::string> out;
    for (auto& kv : data_)
      if (kv.first.compare(0, prefix.size(), prefix) == 0)
        out.push_back(kv.first);
    return out;
  }

  bool barrier(const std::string& name, int count, double timeout_s) {
    std::unique_lock<std::mutex> g(mu_);
    auto& st = barriers_[name];  // pair<generation, arrived>
    int my_gen = st.first;
    st.second++;
    if (st.second >= count) {
      st.first++;
      st.second = 0;
      cv_.notify_all();
      return true;
    }
    auto deadline = std::chrono::steady_clock::now() +
                    std::chrono::duration<double>(timeout_s);
    while (barriers_[name].first == my_gen) {
      bool timed_out =
          shutdown_ ||
          cv_.wait_until(g, deadline) == std::cv_status::timeout;
      if (timed_out && barriers_[name].first == my_gen) {
        auto& cur = barriers_[name];
        if (cur.first == my_gen && cur.second > 0) cur.second--;
        return false;
      }
    }
    return true;
  }

 private:
  std::mutex mu_;
  std::condition_variable cv_;
  std::map<std::string, std::string> data_;
  std::map<std::string, std::pair<int, int>> barriers_;
  bool shutdown_ = false;
};

// ---------------------------------------------------------------------------
// Server
// ---------------------------------------------------------------------------

class ControlPlaneServer {
 public:
  ControlPlaneServer(std::string secret) : secret_(std::move(secret)) {}

  int start(int port) {
    listen_fd_ = socket(AF_INET, SOCK_STREAM, 0);
    if (listen_fd_ < 0) return -1;
    int one = 1;
    setsockopt(listen_fd_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = INADDR_ANY;
    addr.sin_port = htons(uint16_t(port));
    if (bind(listen_fd_, (sockaddr*)&addr, sizeof(addr)) < 0) {
      close(listen_fd_);
      return -1;
    }
    socklen_t len = sizeof(addr);
    getsockname(listen_fd_, (sockaddr*)&addr, &len);
    bound_port_ = ntohs(addr.sin_port);
    if (listen(listen_fd_, 128) < 0) {
      close(listen_fd_);
      return -1;
    }
    running_ = true;
    accept_thread_ = std::thread([this] { accept_loop(); });
    return bound_port_;
  }

  // Signal shutdown without joining (safe to call from a handler thread
  // servicing the SHUTDOWN op): stops accepting, wakes every blocked
  // wait/barrier, and half-closes live connections so their recv returns.
  void request_stop() {
    if (!running_.exchange(false)) return;
    shutdown(listen_fd_, SHUT_RDWR);
    store_.shutdown();
    std::lock_guard<std::mutex> g(reg_->mu);
    for (int fd : reg_->fds) shutdown(fd, SHUT_RDWR);
  }

  // Full teardown (owner thread only): request stop, then wait for the
  // accept loop and every handler thread to drain.  Once reg_->fds is
  // empty every handler has returned from handle_conn (no further access
  // to `this`); their final registry touch is safe because reg_ is a
  // shared_ptr each handler co-owns.  Returns false if handlers failed
  // to drain — the caller must then leak the object rather than free it
  // under a live thread.
  bool stop() {
    request_stop();
    if (accept_thread_.joinable()) accept_thread_.join();
    std::unique_lock<std::mutex> g(reg_->mu);
    return reg_->cv.wait_for(g, std::chrono::seconds(10),
                             [this] { return reg_->fds.empty(); });
  }

  ~ControlPlaneServer() { stop(); }

 private:
  // Liveness record for detached handler threads; shared so handlers can
  // outlive the server object during teardown.
  struct ConnRegistry {
    std::mutex mu;
    std::condition_variable cv;
    std::set<int> fds;
  };

  void accept_loop() {
    while (running_) {
      int fd = accept(listen_fd_, nullptr, nullptr);
      if (fd < 0) {
        if (!running_) break;
        continue;
      }
      {
        std::lock_guard<std::mutex> g(reg_->mu);
        if (!running_) {  // raced with request_stop
          close(fd);
          continue;
        }
        reg_->fds.insert(fd);
      }
      // Handlers detach; the fd registry (not thread handles) is the
      // liveness record, so long-lived servers never accumulate
      // joinable-thread stacks.  Erase BEFORE close: the kernel can
      // recycle the fd number the instant it is closed, and a stale
      // registry entry would alias the new connection.
      auto reg = reg_;
      std::thread([this, reg, fd] {
        handle_conn(fd);
        {
          std::lock_guard<std::mutex> g(reg->mu);
          reg->fds.erase(fd);
        }
        close(fd);
        reg->cv.notify_all();
      }).detach();
    }
    close(listen_fd_);
  }

  // One line from fd, read in blocks into the connection's buffer `buf`
  // (what follows the line stays there for the next call): a reshard
  // chunk's request is megabytes, which one recv a byte would take
  // seconds to read.
  bool read_line(int fd, std::string* buf, std::string* line) {
    size_t scanned = 0;
    char block[1 << 16];
    while (true) {
      size_t nl = buf->find('\n', scanned);
      if (nl != std::string::npos) {
        line->assign(*buf, 0, nl);
        buf->erase(0, nl + 1);
        return true;
      }
      if (buf->size() > (1 << 24)) return false;  // 16 MB guard
      scanned = buf->size();
      ssize_t n = recv(fd, block, sizeof block, 0);
      if (n <= 0) {
        line->swap(*buf);
        buf->clear();
        return !line->empty();
      }
      buf->append(block, size_t(n));
    }
  }

  void send_obj(int fd, const std::string& json) {
    uint8_t mac[32];
    hmac_sha256(secret_, json, mac);
    std::string msg = hex(mac, 32) + " " + b64encode(json) + "\n";
    size_t off = 0;
    while (off < msg.size()) {
      ssize_t n = send(fd, msg.data() + off, msg.size() - off, MSG_NOSIGNAL);
      if (n <= 0) return;
      off += size_t(n);
    }
  }

  void handle_conn(int fd) {
    std::string buf, line;
    while (running_ && read_line(fd, &buf, &line)) {
      if (line.empty() || line == "\r") continue;
      size_t sp = line.find(' ');
      std::string payload;
      if (sp == std::string::npos ||
          !b64decode(line.substr(sp + 1), &payload)) {
        send_obj(fd, "{\"ok\":false,\"error\":\"malformed message\"}");
        break;
      }
      uint8_t mac[32];
      hmac_sha256(secret_, payload, mac);
      if (!const_time_eq(line.substr(0, sp), hex(mac, 32))) {
        send_obj(fd,
                 "{\"ok\":false,\"error\":\"Rendezvous message failed HMAC "
                 "verification\"}");
        break;
      }
      std::map<std::string, JsonValue> req;
      if (!json_parse_flat(payload, &req)) {
        send_obj(fd, "{\"ok\":false,\"error\":\"bad json\"}");
        break;
      }
      std::string op = req.count("op") ? req["op"].str : "";
      if (op == "PUT") {
        store_.put(req["key"].str, req["value"].str);
        send_obj(fd, "{\"ok\":true}");
      } else if (op == "GET") {
        std::string v;
        if (store_.get(req["key"].str, &v))
          send_obj(fd, "{\"ok\":true,\"value\":\"" + json_escape(v) + "\"}");
        else
          send_obj(fd, "{\"ok\":true,\"value\":null}");
      } else if (op == "WAIT") {
        double timeout = req.count("timeout") ? req["timeout"].num : 30.0;
        std::string v;
        if (store_.wait(req["key"].str, timeout, &v))
          send_obj(fd, "{\"ok\":true,\"value\":\"" + json_escape(v) + "\"}");
        else
          send_obj(fd, "{\"ok\":false,\"error\":\"timeout waiting " +
                           json_escape(req["key"].str) + "\"}");
      } else if (op == "DEL") {
        send_obj(fd, store_.del(req["key"].str) ? "{\"ok\":true}"
                                                : "{\"ok\":false}");
      } else if (op == "KEYS") {
        std::string prefix = req.count("prefix") ? req["prefix"].str : "";
        std::string arr = "[";
        bool first = true;
        for (auto& k : store_.keys(prefix)) {
          if (!first) arr += ",";
          arr += "\"" + json_escape(k) + "\"";
          first = false;
        }
        arr += "]";
        send_obj(fd, "{\"ok\":true,\"keys\":" + arr + "}");
      } else if (op == "BARRIER") {
        double timeout = req.count("timeout") ? req["timeout"].num : 30.0;
        int count = req.count("count") ? int(req["count"].num) : 1;
        if (store_.barrier(req["name"].str, count, timeout))
          send_obj(fd, "{\"ok\":true}");
        else
          send_obj(fd, "{\"ok\":false,\"error\":\"barrier timeout\"}");
      } else if (op == "PING") {
        send_obj(fd, "{\"ok\":true,\"value\":\"pong\"}");
      } else if (op == "SHUTDOWN") {
        send_obj(fd, "{\"ok\":true}");
        // Signal-only from a handler thread; the owner's stop() joins.
        request_stop();
        break;
      } else {
        send_obj(fd, "{\"ok\":false,\"error\":\"unknown op\"}");
      }
    }
    // fd is closed by the accept-loop wrapper after deregistration.
  }

  std::string secret_;
  KVStore store_;
  int listen_fd_ = -1;
  int bound_port_ = 0;
  std::atomic<bool> running_{false};
  std::thread accept_thread_;
  std::shared_ptr<ConnRegistry> reg_ = std::make_shared<ConnRegistry>();
};

// ---------------------------------------------------------------------------
// Timeline writer (reference: horovod/common/timeline.cc TimelineWriter —
// dedicated thread, short-circuit buffer, Chrome-trace JSON output).
// ---------------------------------------------------------------------------

class TimelineWriter {
 public:
  TimelineWriter(const std::string& path, int pid) : pid_(pid) {
    f_ = fopen(path.c_str(), "w");
    if (f_) {
      fputs("[\n", f_);
      running_ = true;
      thread_ = std::thread([this] { run(); });
    }
  }

  bool ok() const { return f_ != nullptr; }

  // Field conventions match the Python writer (timeline.py): pid = rank,
  // tid = tensor/activity name (string), dur_us < 0 omitted, scope "" or
  // "p" for instant events, args_json pre-serialized or "".
  void event(const char* name, const char* cat, const char* ph, double ts_us,
             double dur_us, int pid, const char* tid, const char* scope,
             const char* args_json, const char* extra_json = nullptr) {
    if (!f_) return;
    std::string rec = "{\"name\":\"" + json_escape(name) + "\",\"cat\":\"" +
                      json_escape(cat) + "\",\"ph\":\"" + json_escape(ph) +
                      "\"";
    char num[64];
    snprintf(num, sizeof(num), ",\"ts\":%.1f", ts_us);
    rec += num;
    if (dur_us >= 0) {
      snprintf(num, sizeof(num), ",\"dur\":%.1f", dur_us);
      rec += num;
    }
    snprintf(num, sizeof(num), ",\"pid\":%d", pid);
    rec += num;
    rec += ",\"tid\":\"" + json_escape(tid) + "\"";
    if (scope && scope[0]) rec += std::string(",\"s\":\"") + scope + "\"";
    if (args_json && args_json[0])
      rec += std::string(",\"args\":") + args_json;
    // Pre-serialized extra top-level fields ("id" for async/flow event
    // pairing, etc.) — the fixed parameter list above can't grow per
    // Chrome-trace extension, so unknown keys ride through verbatim.
    if (extra_json && extra_json[0])
      rec += std::string(",") + extra_json;
    rec += "}";
    std::lock_guard<std::mutex> g(mu_);
    // Separator-before-record keeps the file strict JSON (no trailing
    // comma) while staying valid-if-truncated for crash dumps.
    if (!first_) queue_ += ",\n";
    first_ = false;
    queue_ += rec;
    cv_.notify_one();
  }

  void close_writer() {
    {
      std::lock_guard<std::mutex> g(mu_);
      if (!running_) return;
      running_ = false;
      cv_.notify_one();
    }
    if (thread_.joinable()) thread_.join();
    if (f_) {
      fputs("\n]\n", f_);
      fclose(f_);
      f_ = nullptr;
    }
  }

  ~TimelineWriter() { close_writer(); }

 private:
  void run() {
    std::string batch;
    while (true) {
      {
        std::unique_lock<std::mutex> g(mu_);
        cv_.wait_for(g, std::chrono::milliseconds(100),
                     [this] { return !queue_.empty() || !running_; });
        batch.swap(queue_);
        if (batch.empty() && !running_) return;
      }
      if (!batch.empty()) {
        fwrite(batch.data(), 1, batch.size(), f_);
        fflush(f_);
        batch.clear();
      }
    }
  }

  FILE* f_ = nullptr;
  int pid_;
  std::mutex mu_;
  std::condition_variable cv_;
  std::string queue_;
  bool first_ = true;
  bool running_ = false;
  std::thread thread_;
};

}  // namespace

// ---------------------------------------------------------------------------
// C API
// ---------------------------------------------------------------------------

extern "C" {

void* hvdtpu_cp_start(const char* secret, int port, int* bound_port) {
  auto* s = new ControlPlaneServer(secret);
  int p = s->start(port);
  if (p < 0) {
    delete s;
    return nullptr;
  }
  if (bound_port) *bound_port = p;
  return s;
}

void hvdtpu_cp_stop(void* handle) {
  auto* s = static_cast<ControlPlaneServer*>(handle);
  if (s->stop()) {
    delete s;
  } else {
    // Handlers failed to drain within the grace period; deleting would
    // free memory a live thread still uses.  Leak deliberately (rare:
    // request_stop half-closes every registered socket, so handlers
    // normally exit promptly).
    fprintf(stderr,
            "[horovod_tpu_torch native] control-plane handlers did not drain; "
            "leaking server object\n");
  }
}

void* hvdtpu_tl_open(const char* path, int pid) {
  auto* w = new TimelineWriter(path, pid);
  if (!w->ok()) {  // unwritable path: report failure so callers can
    delete w;      // fall back to the Python writer
    return nullptr;
  }
  return w;
}

void hvdtpu_tl_event(void* h, const char* name, const char* cat,
                     const char* ph, double ts_us, double dur_us, int pid,
                     const char* tid, const char* scope,
                     const char* args_json) {
  static_cast<TimelineWriter*>(h)->event(name, cat, ph, ts_us, dur_us, pid,
                                         tid, scope, args_json);
}

void hvdtpu_tl_event2(void* h, const char* name, const char* cat,
                      const char* ph, double ts_us, double dur_us, int pid,
                      const char* tid, const char* scope,
                      const char* args_json, const char* extra_json) {
  static_cast<TimelineWriter*>(h)->event(name, cat, ph, ts_us, dur_us, pid,
                                         tid, scope, args_json, extra_json);
}

void hvdtpu_tl_close(void* h) {
  auto* w = static_cast<TimelineWriter*>(h);
  w->close_writer();
  delete w;
}

}  // extern "C"
