// Async parameter server — the TPU-native re-expression of the
// reference's async pserver runtime (listen_and_serv_op.cc:217
// RunAsyncLoop: per-grad optimize block applied on arrival, no
// trainer barriers) including DC-ASGD delay compensation
// (distribute_transpiler.py:1571 _append_dc_asgd_ops: the adjusted
// gradient g' = g + lambda*g*g*(w - w_bak[trainer]), with w_bak
// captured per trainer at param-pull time).
//
// Design notes (vs the reference): the reference splits the ProgramDesc
// into trainer/pserver programs and runs gRPC-transported optimize
// blocks inside the C++ interpreter. Here the dense/sparse update rules
// ARE the server (SGD / Adagrad / row-wise sparse), the transport is
// the same line-framed TCP protocol the C++ master uses, and trainers
// are JAX processes that jit only the gradient computation — the
// optimizer state lives host-side on the server, which is exactly the
// pserver placement in the reference (optimizer ops run on the pserver,
// distribute_transpiler.py:592-837). Sync SPMD training remains the
// first-class path (parallel/); this server exists for the async-SGD
// capability row.
//
// Build: g++ -O2 -std=c++17 -pthread pserver.cc -o pserver_server
// Run:   pserver_server <port> <lr> <sgd|adagrad> <dc_asgd 0|1> [lambda]
//                       [snapshot_path]
//        port 0 picks a free port; prints "PORT <n>" on stdout. With a
//        snapshot_path, state is recovered from it at startup (the
//        go/pserver/service.go:346 shard-checkpoint capability).
//
// Protocol (one request line; binary payloads length-prefixed):
//   INIT <name> <len>\n<f32 bytes>  -> OK NEW | OK EXISTS  (first writer wins)
//   PULL <trainer> <name>           -> OK <len>\n<f32 bytes>
//   PUSH <trainer> <name> <len>\n<f32 bytes>              -> OK <version>
//   PUSHQ <trainer> <name> <n> <scale>\n<i8 bytes>        -> OK <version>
//       (int8-quantized gradient: g[i] = q[i]*scale/127 — 4x less wire
//        than PUSH; quantized-collective lineage, EQuARX-style)
//   PUSHQB <trainer> <name> <n> <bits> <block>\n<f32 scales><codes> -> OK <v>
//       (block-scaled quantized gradient: one f32 abs-max scale per
//        <block> elements, codes int8 or packed int4 nibble pairs when
//        <bits>=4 — 4-8x less wire than PUSH with outliers contained to
//        their own block; same codec as parallel/quantized_collectives.
//        <n> is the UNPADDED element count; scale/code lengths derive
//        from n/bits/block server-side)
//   PUSHROWS <trainer> <name> <nrows> <rowdim>\n<i32 ids><f32 vals> -> OK <v>
//   EXPORT <name>                   -> OK <vlen> <alen> <version>\n
//                                      <f32 value><f32 accum>
//       (full shard-migration state of one param: value + optimizer
//        accumulator + version; per-trainer DC-ASGD baks are staleness
//        references and do not migrate, same as SAVE)
//   IMPORT <name> <vlen> <alen> <version>\n<f32 value><f32 accum> -> OK
//       (absolute overwrite-or-create — the receive half of a pserver
//        shard split/merge. Idempotent by construction: importing the
//        same state twice is a no-op, so the client may safely retry
//        it across a connection loss, unlike PUSH)
//   DELETE <name>                   -> OK GONE | OK ABSENT (idempotent)
//       (the cleanup half of shard migration: the old owner drops its
//        copy AFTER routing switched, so orphaned shards neither leak
//        memory across resizes nor silently absorb pushes from
//        trainers that have not rebound yet — those now fail loudly
//        with ERR unknown param)
//   SAVE                            -> OK | ERR (atomic snapshot to path)
//   STATUS                          -> OK params=N pushes=M
//   QUIT                            -> closes the connection
//
// Optional trace field: a client may append " trace=<id>" (no
// whitespace in <id>) to a PULL/PUSH/PUSHQ/PUSHQB/PUSHROWS header line. The
// field rides AFTER the positionally-parsed tokens, so an old server's
// sscanf ignores it (and an old client simply never sends it); this
// server echoes it at the end of the OK reply line ("OK <v>
// trace=<id>"), which old clients in turn ignore (they read reply
// fields positionally). The id is the telemetry span minted at the
// trainer's step, so a slow or lost exchange is attributable to a
// specific worker step against a specific pserver.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

enum class Opt { kSGD, kAdagrad };

struct Param {
  std::vector<float> value;
  std::vector<float> accum;                        // adagrad G += g^2
  std::map<int, std::vector<float>> bak;           // per-trainer w_bak
  int64_t version = 0;
};

class PServer {
 public:
  PServer(float lr, Opt opt, bool dc_asgd, float lambda,
          std::string snapshot_path)
      : lr_(lr), opt_(opt), dc_asgd_(dc_asgd), lambda_(lambda),
        snapshot_path_(std::move(snapshot_path)) {
    Recover();
  }

  std::string Init(const std::string& name, const std::string& bytes) {
    std::lock_guard<std::mutex> g(mu_);
    if (bytes.size() % sizeof(float) != 0)
      return "ERR payload not a multiple of sizeof(float)\n";
    auto it = params_.find(name);
    if (it != params_.end()) return "OK EXISTS\n";
    Param p;
    p.value.resize(bytes.size() / sizeof(float));
    memcpy(p.value.data(), bytes.data(), bytes.size());
    if (opt_ == Opt::kAdagrad) p.accum.assign(p.value.size(), 0.f);
    params_[name] = std::move(p);
    return "OK NEW\n";
  }

  std::string Pull(int trainer, const std::string& name, std::string* payload) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = params_.find(name);
    if (it == params_.end()) return "ERR unknown param " + name + "\n";
    Param& p = it->second;
    payload->assign(reinterpret_cast<const char*>(p.value.data()),
                    p.value.size() * sizeof(float));
    // DC-ASGD: the staleness reference point is the param value this
    // trainer last SAW — capture it at pull (ref_by_trainer_id analog).
    if (dc_asgd_) p.bak[trainer] = p.value;
    return "OK " + std::to_string(payload->size()) + "\n";
  }

  std::string Push(int trainer, const std::string& name,
                   const std::string& bytes) {
    std::lock_guard<std::mutex> g(mu_);
    size_t n = bytes.size() / sizeof(float);
    return ApplyDense(trainer, name, n,
                      reinterpret_cast<const float*>(bytes.data()));
  }

  // Quantized dense push: int8 payload + one f32 scale, dequantized
  // into a staging buffer and fed through the SAME update path as
  // Push — 4x less trainer→server traffic per gradient.
  std::string PushQuantized(int trainer, const std::string& name,
                            int64_t n, float scale,
                            const std::string& bytes) {
    if (n < 0 || bytes.size() != size_t(n)) return "ERR size mismatch\n";
    const int8_t* q = reinterpret_cast<const int8_t*>(bytes.data());
    std::vector<float> grad(static_cast<size_t>(n));
    const float inv = scale / 127.0f;
    for (int64_t i = 0; i < n; ++i) grad[i] = q[i] * inv;
    std::lock_guard<std::mutex> g(mu_);
    std::string resp = ApplyDense(trainer, name, size_t(n), grad.data());
    if (resp.rfind("OK", 0) == 0) ++qpushes_;
    return resp;
  }

  // Block-scaled quantized dense push: one f32 abs-max scale per
  // `block` elements, codes int8 or packed int4 nibble pairs (bias-8,
  // lo | hi<<4) — the PUSHQB wire verb, sharing its codec with the
  // trainer-side parallel/quantized_collectives encoder. Dequantized
  // into a staging buffer and fed through the SAME update path as
  // Push. A non-finite scale (the encoder poisons blocks that held
  // NaN/Inf) dequantizes its whole block to NaN and surfaces through
  // the update exactly like a NaN f32 push would.
  std::string PushQuantizedBlocks(int trainer, const std::string& name,
                                  int64_t n, int64_t bits, int64_t block,
                                  const std::string& scales_b,
                                  const std::string& codes_b) {
    if (n < 0 || block <= 0 || (bits != 8 && bits != 4) ||
        (bits == 4 && block % 2 != 0))
      return "ERR bad quant header\n";
    int64_t padded = ((n > 0 ? n : 1) + block - 1) / block * block;
    int64_t nblk = padded / block;
    int64_t codes_len = bits == 8 ? padded : padded / 2;
    if (scales_b.size() != size_t(nblk) * sizeof(float) ||
        codes_b.size() != size_t(codes_len))
      return "ERR size mismatch\n";
    const float* scales = reinterpret_cast<const float*>(scales_b.data());
    const float qmax = bits == 8 ? 127.0f : 7.0f;
    std::vector<float> grad(static_cast<size_t>(n));
    if (bits == 8) {
      const int8_t* q = reinterpret_cast<const int8_t*>(codes_b.data());
      for (int64_t i = 0; i < n; ++i)
        grad[i] = q[i] * (scales[i / block] / qmax);
    } else {
      const uint8_t* q = reinterpret_cast<const uint8_t*>(codes_b.data());
      for (int64_t i = 0; i < n; ++i) {
        uint8_t byte = q[i >> 1];
        int code = int((i & 1) ? (byte >> 4) & 0xF : byte & 0xF) - 8;
        grad[i] = code * (scales[i / block] / qmax);
      }
    }
    std::lock_guard<std::mutex> g(mu_);
    std::string resp = ApplyDense(trainer, name, size_t(n), grad.data());
    if (resp.rfind("OK", 0) == 0) ++qpushes_;
    return resp;
  }

  // Sparse rows (distributed-lookup-table update path: pserver-side
  // row-wise optimize, distribute_transpiler.py:1100-1339). Param is
  // [total_rows, rowdim] row-major; ids index rows. DC-ASGD is a dense
  // concept in the reference and is skipped for sparse pushes there too.
  std::string PushRows(const std::string& name, int64_t nrows, int64_t rowdim,
                       const std::string& ids_b, const std::string& vals_b) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = params_.find(name);
    if (it == params_.end()) return "ERR unknown param " + name + "\n";
    Param& p = it->second;
    if (nrows < 0 || rowdim <= 0) return "ERR bad nrows/rowdim\n";
    if (ids_b.size() != size_t(nrows) * sizeof(int32_t) ||
        vals_b.size() != size_t(nrows) * rowdim * sizeof(float))
      return "ERR size mismatch\n";
    const int32_t* ids = reinterpret_cast<const int32_t*>(ids_b.data());
    const float* vals = reinterpret_cast<const float*>(vals_b.data());
    int64_t total_rows = int64_t(p.value.size()) / rowdim;
    // validate every id BEFORE touching the param: a mid-loop ERR would
    // leave a half-applied update the client will retry (double-apply)
    for (int64_t r = 0; r < nrows; ++r)
      if (ids[r] < 0 || ids[r] >= total_rows) return "ERR row id out of range\n";
    for (int64_t r = 0; r < nrows; ++r)
      for (int64_t j = 0; j < rowdim; ++j)
        ApplyOne(&p, size_t(ids[r]) * rowdim + j, vals[r * rowdim + j]);
    ++p.version;
    ++pushes_;
    return "OK " + std::to_string(p.version) + "\n";
  }

  // Shard migration (the go/pserver slice/merge analog re-expressed as
  // a verb pair): EXPORT hands a param's full server-side state to the
  // coordinator, IMPORT installs it absolutely on the new owner.
  std::string Export(const std::string& name, std::string* payload) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = params_.find(name);
    if (it == params_.end()) return "ERR unknown param " + name + "\n";
    const Param& p = it->second;
    payload->assign(reinterpret_cast<const char*>(p.value.data()),
                    p.value.size() * sizeof(float));
    payload->append(reinterpret_cast<const char*>(p.accum.data()),
                    p.accum.size() * sizeof(float));
    return "OK " + std::to_string(p.value.size()) + " " +
           std::to_string(p.accum.size()) + " " +
           std::to_string(p.version) + "\n";
  }

  std::string Import(const std::string& name, int64_t vlen, int64_t alen,
                     int64_t version, const std::string& value_bytes,
                     const std::string& accum_bytes) {
    if (vlen < 0 || alen < 0 ||
        value_bytes.size() != size_t(vlen) * sizeof(float) ||
        accum_bytes.size() != size_t(alen) * sizeof(float))
      return "ERR size mismatch\n";
    Param p;
    p.value.resize(size_t(vlen));
    p.accum.resize(size_t(alen));
    memcpy(p.value.data(), value_bytes.data(), size_t(vlen) * sizeof(float));
    memcpy(p.accum.data(), accum_bytes.data(), size_t(alen) * sizeof(float));
    p.version = version;
    // re-establish the optimizer invariant Init() guarantees (same as
    // Recover): the exporter may run a different optimizer — ApplyOne
    // indexes accum unconditionally under adagrad
    if (opt_ == Opt::kAdagrad && p.accum.size() != p.value.size())
      p.accum.assign(p.value.size(), 0.f);
    if (opt_ == Opt::kSGD) p.accum.clear();
    std::lock_guard<std::mutex> g(mu_);
    // absolute overwrite (NOT first-writer-wins): a rejoining server may
    // hold a stale copy from before its shard moved away — migration
    // must install the authoritative state regardless
    params_[name] = std::move(p);
    return "OK IMPORTED\n";
  }

  std::string Delete(const std::string& name) {
    std::lock_guard<std::mutex> g(mu_);
    return params_.erase(name) ? "OK GONE\n" : "OK ABSENT\n";
  }

  std::string Status() {
    std::lock_guard<std::mutex> g(mu_);
    return "OK params=" + std::to_string(params_.size()) +
           " pushes=" + std::to_string(pushes_) +
           " qpushes=" + std::to_string(qpushes_) + "\n";
  }

  // Checkpoint of params + optimizer accumulators (pserver shard
  // checkpoint, go/pserver/service.go:346; per-trainer DC-ASGD baks are
  // staleness references, meaningless across a restart, so not saved).
  // State is COPIED under the lock and written outside it, so a slow
  // disk never stalls trainer push/pull traffic; the rename is atomic
  // and only happens after every write (incl. fclose flush) succeeded,
  // so a short write (disk full) cannot clobber the previous snapshot.
  std::string Save() {
    if (snapshot_path_.empty()) return "ERR no snapshot path configured\n";
    // serialize concurrent SAVEs BEFORE copying: if the copy happened
    // outside save_mu_, a later-copied (newer) snapshot could be
    // renamed first and then overwritten by an earlier stale copy — an
    // OK'd save would silently lose acknowledged durability
    std::lock_guard<std::mutex> sg(save_mu_);
    std::map<std::string, Param> copy;
    int64_t pushes;
    {
      std::lock_guard<std::mutex> g(mu_);
      for (auto& kv : params_) {
        Param p;
        p.value = kv.second.value;
        p.accum = kv.second.accum;
        p.version = kv.second.version;
        copy[kv.first] = std::move(p);  // baks intentionally dropped
      }
      pushes = pushes_;
    }
    std::string tmp = snapshot_path_ + ".tmp";
    FILE* f = fopen(tmp.c_str(), "wb");
    if (!f) return "ERR cannot open snapshot tmp\n";
    bool ok = fprintf(f, "%zu %ld\n", copy.size(),
                      static_cast<long>(pushes)) > 0;
    for (auto& kv : copy) {
      if (!ok) break;
      const Param& p = kv.second;
      ok = fprintf(f, "%s %zu %zu %ld\n", kv.first.c_str(), p.value.size(),
                   p.accum.size(), static_cast<long>(p.version)) > 0 &&
           fwrite(p.value.data(), sizeof(float), p.value.size(), f) ==
               p.value.size() &&
           fwrite(p.accum.data(), sizeof(float), p.accum.size(), f) ==
               p.accum.size() &&
           fputc('\n', f) != EOF;
    }
    ok = (fclose(f) == 0) && ok;
    if (!ok) {
      remove(tmp.c_str());
      return "ERR snapshot write failed\n";
    }
    if (rename(tmp.c_str(), snapshot_path_.c_str()) != 0)
      return "ERR snapshot rename failed\n";
    return "OK\n";
  }

 private:
  // Shared dense-update core (callers hold mu_): DC-ASGD compensation +
  // the optimizer rule, for both exact and dequantized gradients.
  std::string ApplyDense(int trainer, const std::string& name, size_t n,
                         const float* grad) {
    auto it = params_.find(name);
    if (it == params_.end()) return "ERR unknown param " + name + "\n";
    Param& p = it->second;
    if (n != p.value.size()) return "ERR size mismatch\n";
    const float* bak = nullptr;
    if (dc_asgd_) {
      auto bit = p.bak.find(trainer);
      if (bit != p.bak.end() && bit->second.size() == n)
        bak = bit->second.data();
    }
    for (size_t i = 0; i < n; ++i) {
      float gi = grad[i];
      if (bak)  // g + lambda*g*g*(w - w_bak): 2nd-order delay compensation
        gi += lambda_ * gi * gi * (p.value[i] - bak[i]);
      ApplyOne(&p, i, gi);
    }
    ++p.version;
    ++pushes_;
    return "OK " + std::to_string(p.version) + "\n";
  }

  void Recover() {
    if (snapshot_path_.empty()) return;
    FILE* f = fopen(snapshot_path_.c_str(), "rb");
    if (!f) return;
    size_t n = 0;
    long pushes = 0;
    if (fscanf(f, "%zu %ld", &n, &pushes) != 2) {
      fclose(f);
      fprintf(stderr, "pserver: snapshot header unreadable, starting fresh\n");
      return;
    }
    fgetc(f);  // exactly the header newline
    // cap matches the protocol's 512MB payload bound: a corrupt size
    // field must not bad_alloc the server out of existence at startup
    const size_t kMaxLen = (512u << 20) / sizeof(float);
    // parse into a staging map: recovery is all-or-nothing, matching the
    // writer's atomicity contract — a half-loaded state (some params
    // recovered, pushes_ restored) would silently diverge
    std::unordered_map<std::string, Param> staged;
    bool complete = true;
    for (size_t i = 0; i < n; ++i) {
      char name[256];
      size_t vlen, alen;
      long version;
      // NOTE no trailing '\n' in the format: scanf's '\n' matches a RUN
      // of whitespace and would swallow leading payload bytes that
      // happen to be 0x09-0x0D/0x20, misaligning every later record
      if (fscanf(f, "%255s %zu %zu %ld", name, &vlen, &alen, &version) != 4 ||
          vlen > kMaxLen || alen > kMaxLen) {
        complete = false;
        break;
      }
      fgetc(f);  // exactly the header newline; payload starts next byte
      Param p;
      p.value.resize(vlen);
      p.accum.resize(alen);
      p.version = version;
      if (fread(p.value.data(), sizeof(float), vlen, f) != vlen ||
          (alen && fread(p.accum.data(), sizeof(float), alen, f) != alen)) {
        complete = false;
        break;
      }
      fgetc(f);  // trailing newline after the payload
      // re-establish the optimizer invariant Init() guarantees: the
      // snapshot may come from a server run with a different optimizer
      // (sgd: empty accum) — ApplyOne indexes accum unconditionally
      // under adagrad, so a size mismatch would be an OOB write
      if (opt_ == Opt::kAdagrad && p.accum.size() != p.value.size())
        p.accum.assign(p.value.size(), 0.f);
      if (opt_ == Opt::kSGD) p.accum.clear();
      staged[name] = std::move(p);
    }
    // full-consumption check (mirrors master.cc's snapshot loader): a
    // header whose param-count was corrupted to a SMALLER value parses
    // cleanly above but leaves tail params unread — that is a silent
    // partial load, which the all-or-nothing contract forbids
    bool trailing = complete && fgetc(f) != EOF;
    fclose(f);
    if (!complete || trailing) {
      if (trailing)
        fprintf(stderr,
                "pserver: snapshot has unconsumed bytes after %zu params "
                "(header count corrupted?), starting fresh\n", n);
      else
        fprintf(stderr,
                "pserver: snapshot truncated/corrupt (%zu of %zu params "
                "readable), starting fresh\n", staged.size(), n);
      return;
    }
    params_ = std::move(staged);
    pushes_ = pushes;
  }
  void ApplyOne(Param* p, size_t i, float g) {
    if (opt_ == Opt::kAdagrad) {
      p->accum[i] += g * g;
      p->value[i] -= lr_ * g / (std::sqrt(p->accum[i]) + 1e-6f);
    } else {
      p->value[i] -= lr_ * g;
    }
  }

  std::mutex mu_;
  std::mutex save_mu_;
  std::unordered_map<std::string, Param> params_;
  int64_t pushes_ = 0;
  int64_t qpushes_ = 0;  // subset of pushes_ that arrived quantized
  float lr_;
  Opt opt_;
  bool dc_asgd_;
  float lambda_;
  std::string snapshot_path_;
};

// -- line-framed socket IO (shared shape with master.cc) ---------------------

bool ReadLine(int fd, std::string* line) {
  line->clear();
  char c;
  while (true) {
    ssize_t r = recv(fd, &c, 1, 0);
    if (r <= 0) return false;
    if (c == '\n') return true;
    line->push_back(c);
    if (line->size() > 1 << 20) return false;
  }
}

bool ReadExact(int fd, char* buf, size_t n) {
  size_t got = 0;
  while (got < n) {
    ssize_t r = recv(fd, buf + got, n - got, 0);
    if (r <= 0) return false;
    got += r;
  }
  return true;
}

bool WriteAll(int fd, const char* buf, size_t n) {
  size_t sent = 0;
  while (sent < n) {
    ssize_t r = send(fd, buf + sent, n - sent, MSG_NOSIGNAL);
    if (r <= 0) return false;
    sent += r;
  }
  return true;
}

bool ReadBody(int fd, size_t len, std::string* body) {
  if (len > (512u << 20)) return false;
  body->resize(len);
  return len == 0 || ReadExact(fd, &(*body)[0], len);
}

// Echo a request header's optional " trace=<id>" token at the end of an
// OK reply line (see the protocol note above). ERR replies are left
// untouched — their text is part of the error contract.
std::string WithTrace(std::string resp, const std::string& line) {
  size_t pos = line.rfind(" trace=");
  if (pos == std::string::npos || resp.rfind("OK", 0) != 0) return resp;
  std::string tok = line.substr(pos + 1);
  size_t sp = tok.find_first_of(" \t");
  if (sp != std::string::npos) tok.resize(sp);
  if (!resp.empty() && resp.back() == '\n') resp.pop_back();
  return resp + " " + tok + "\n";
}

void ServeClient(PServer* ps, int fd) {
  std::string line;
  while (ReadLine(fd, &line)) {
    std::string resp, payload;
    char name[256];
    long long a = 0, b = 0, c = 0, d = 0;
    if (sscanf(line.c_str(), "INIT %255s %lld", name, &a) == 2) {
      std::string body;
      if (!ReadBody(fd, a, &body)) break;
      resp = ps->Init(name, body);
    } else if (sscanf(line.c_str(), "PULL %lld %255s", &a, name) == 2) {
      resp = WithTrace(ps->Pull(int(a), name, &payload), line);
    } else if (sscanf(line.c_str(), "PUSH %lld %255s %lld", &a, name, &b) == 3) {
      // retry: at-most-once — replaying a gradient double-applies it
      std::string body;
      if (!ReadBody(fd, b, &body)) break;
      resp = WithTrace(ps->Push(int(a), name, body), line);
    } else if (sscanf(line.c_str(), "PUSHQB %lld %255s %lld %lld %lld",
                      &a, name, &b, &c, &d) == 5) {
      // retry: at-most-once
      // header sanity BEFORE sizing the reads: bits/block combinations
      // the codec cannot produce close the connection (body lengths
      // would be unknowable), and kMaxElems bounds keep every size_t
      // product below 2^64 (same overflow discipline as PUSHROWS)
      const long long kMaxElems = (512ll << 20) / int(sizeof(float));
      if (b < 0 || b > kMaxElems || d <= 0 || d > kMaxElems ||
          (c != 8 && c != 4) || (c == 4 && d % 2 != 0))
        break;
      long long padded = ((b > 0 ? b : 1) + d - 1) / d * d;
      std::string scales, codes;
      if (!ReadBody(fd, size_t(padded / d) * sizeof(float), &scales)) break;
      if (!ReadBody(fd, size_t(c == 8 ? padded : padded / 2), &codes)) break;
      resp = WithTrace(
          ps->PushQuantizedBlocks(int(a), name, b, c, d, scales, codes),
          line);
    } else if (float scale = 0.f;
               sscanf(line.c_str(), "PUSHQ %lld %255s %lld %f",
                      &a, name, &b, &scale) == 4) {
      // retry: at-most-once
      std::string body;
      if (b < 0 || !ReadBody(fd, size_t(b), &body)) break;
      resp = WithTrace(ps->PushQuantized(int(a), name, b, scale, body), line);
    } else if (sscanf(line.c_str(), "PUSHROWS %lld %255s %lld %lld",
                      &a, name, &b, &c) == 4) {
      // retry: at-most-once
      // reject before the size_t casts: a huge b or c would wrap the
      // b*c*sizeof(float) product past 2^64 to a tiny length, slipping
      // under the 512MB ReadBody cap while PushRows later indexes far
      // out of bounds. Bounding each factor by the payload cap keeps
      // every product below 2^64. b == 0 stays legal (PushRows permits
      // an empty sparse gradient and replies OK).
      const long long kMaxElems = (512ll << 20) / int(sizeof(float));
      if (b < 0 || c <= 0 || b > kMaxElems || c > kMaxElems) break;
      std::string ids, vals;
      if (!ReadBody(fd, size_t(b) * sizeof(int32_t), &ids)) break;
      if (!ReadBody(fd, size_t(b) * size_t(c) * sizeof(float), &vals)) break;
      resp = WithTrace(ps->PushRows(name, b, c, ids, vals), line);
    } else if (sscanf(line.c_str(), "EXPORT %255s", name) == 1) {
      resp = ps->Export(name, &payload);
    } else if (sscanf(line.c_str(), "DELETE %255s", name) == 1) {
      resp = ps->Delete(name);
    } else if (sscanf(line.c_str(), "IMPORT %255s %lld %lld %lld",
                      name, &a, &b, &c) == 4) {
      // same overflow discipline as PUSHROWS: bound each length by the
      // payload cap before the size_t arithmetic, and read value/accum
      // as SEPARATE bodies — each gets the full 512MB ReadBody budget,
      // so any param PUSH can carry (value <= cap) stays migratable
      // even with an equally large optimizer accumulator riding along
      const long long kMaxElems = (512ll << 20) / int(sizeof(float));
      if (a < 0 || b < 0 || a > kMaxElems || b > kMaxElems) break;
      std::string vbody, abody;
      if (!ReadBody(fd, size_t(a) * sizeof(float), &vbody)) break;
      if (!ReadBody(fd, size_t(b) * sizeof(float), &abody)) break;
      resp = ps->Import(name, a, b, c, vbody, abody);
    } else if (line == "SAVE") {
      resp = ps->Save();
    } else if (line == "STATUS") {
      resp = ps->Status();
    } else if (line == "QUIT") {
      break;
    } else if (line.rfind("INIT ", 0) == 0 || line.rfind("PUSH", 0) == 0 ||
               line.rfind("IMPORT ", 0) == 0) {
      // payload-carrying header that failed to parse (e.g. name >255
      // chars truncated by %255s): the payload length is unknowable, so
      // the stream is unrecoverable — close rather than desync into
      // interpreting raw floats as commands
      break;
    } else {
      resp = "ERR bad command\n";
    }
    if (!WriteAll(fd, resp.data(), resp.size())) break;
    if (!payload.empty() && !WriteAll(fd, payload.data(), payload.size()))
      break;
  }
  close(fd);
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 3) {
    fprintf(stderr,
            "usage: pserver_server <port> <lr> [sgd|adagrad] [dc_asgd 0|1] "
            "[lambda] [snapshot_path]\n");
    return 1;
  }
  int port = atoi(argv[1]);
  float lr = atof(argv[2]);
  Opt opt = (argc > 3 && std::string(argv[3]) == "adagrad") ? Opt::kAdagrad
                                                            : Opt::kSGD;
  bool dc = argc > 4 && atoi(argv[4]) != 0;
  float lambda = argc > 5 ? atof(argv[5]) : 1.0f;
  std::string snapshot = argc > 6 ? argv[6] : "";
  if (snapshot == "-") snapshot.clear();

  PServer ps(lr, opt, dc, lambda, snapshot);

  int srv = socket(AF_INET, SOCK_STREAM, 0);
  int one = 1;
  setsockopt(srv, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  addr.sin_port = htons(port);
  if (bind(srv, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    perror("bind");
    return 1;
  }
  socklen_t alen = sizeof(addr);
  getsockname(srv, reinterpret_cast<sockaddr*>(&addr), &alen);
  listen(srv, 64);  // before PORT: clients connect the moment they see it
  printf("PORT %d\n", ntohs(addr.sin_port));
  fflush(stdout);

  while (true) {
    int fd = accept(srv, nullptr, nullptr);
    if (fd < 0) continue;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    std::thread(ServeClient, &ps, fd).detach();
  }
}
