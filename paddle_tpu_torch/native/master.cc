// Fault-tolerant dataset task-queue master — the TPU-native equivalent of
// the reference's Go master (go/master/service.go: task lease+timeout
// :341 checkTimeoutFunc, retry-then-discard :313 processFailedTask,
// state snapshot/recover :207/:166). Differences by design: state
// snapshots go to a local/NFS file (atomic rename) instead of etcd, and
// transport is a line-framed TCP protocol instead of Go net/rpc — the
// capability (stateless trainers leasing data shards with crash
// recovery) is the same.
//
// Build: g++ -O2 -std=c++17 -pthread master.cc -o master_server
// Run:   master_server <port> <snapshot_path> <failure_max> <lease_timeout_ms>
//        port 0 picks a free port; the chosen port is printed as
//        "PORT <n>" on stdout.
//
// Protocol (one request per line; payloads length-prefixed, binary-safe):
//   ADD <len>\n<bytes>   -> OK <id>
//   GET                  -> TASK <id> <len>\n<bytes> | WAIT | DONE
//   FIN <id>             -> OK | ERR <msg>
//   FAIL <id>            -> OK (requeue or discard per failure_max)
//   RESET                -> OK <pass>   (requeue all non-discarded; new pass)
//   STATUS               -> OK todo=.. leased=.. done=.. discarded=.. pass=.. total=..
//   QUIT                 -> closes the connection

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <set>
#include <string>
#include <thread>
#include <vector>

namespace {

int64_t now_ms() {
  return std::chrono::duration_cast<std::chrono::milliseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

enum class TaskState { kTodo, kLeased, kDone, kDiscarded };

struct Task {
  int64_t id;
  std::string payload;
  int failures = 0;
  TaskState state = TaskState::kTodo;
  int64_t lease_deadline_ms = 0;
};

class Master {
 public:
  Master(std::string snapshot_path, int failure_max, int64_t lease_timeout_ms)
      : snapshot_path_(std::move(snapshot_path)),
        failure_max_(failure_max),
        lease_timeout_ms_(lease_timeout_ms) {
    Recover();
  }

  std::string Add(const std::string& payload) {
    std::lock_guard<std::mutex> g(mu_);
    Task t;
    t.id = next_id_++;
    t.payload = payload;
    tasks_[t.id] = std::move(t);
    todo_.push_back(next_id_ - 1);
    Snapshot();
    return "OK " + std::to_string(next_id_ - 1) + "\n";
  }

  // Returns the response header; *payload set when a task is leased.
  std::string Get(std::string* payload) {
    std::lock_guard<std::mutex> g(mu_);
    if (todo_.empty()) {
      for (auto& kv : tasks_)
        if (kv.second.state == TaskState::kLeased) return "WAIT\n";
      return "DONE\n";
    }
    int64_t id = todo_.front();
    todo_.pop_front();
    Task& t = tasks_[id];
    t.state = TaskState::kLeased;
    t.lease_deadline_ms = now_ms() + lease_timeout_ms_;
    *payload = t.payload;
    Snapshot();
    return "TASK " + std::to_string(id) + " " +
           std::to_string(t.payload.size()) + "\n";
  }

  std::string Finish(int64_t id) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = tasks_.find(id);
    if (it == tasks_.end()) return "ERR unknown task\n";
    if (it->second.state != TaskState::kLeased)
      return "ERR task not leased\n";
    it->second.state = TaskState::kDone;
    Snapshot();
    return "OK\n";
  }

  std::string Fail(int64_t id) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = tasks_.find(id);
    if (it == tasks_.end()) return "ERR unknown task\n";
    if (it->second.state != TaskState::kLeased)
      return "OK\n";  // double-fail / already timed out: idempotent
    FailLocked(&it->second);
    Snapshot();
    return "OK\n";
  }

  std::string Reset() {
    std::lock_guard<std::mutex> g(mu_);
    ++pass_;
    todo_.clear();
    for (auto& kv : tasks_) {
      if (kv.second.state == TaskState::kDiscarded) continue;
      kv.second.state = TaskState::kTodo;
      kv.second.failures = 0;
      todo_.push_back(kv.first);
    }
    Snapshot();
    return "OK " + std::to_string(pass_) + "\n";
  }

  std::string Status() {
    std::lock_guard<std::mutex> g(mu_);
    int todo = 0, leased = 0, done = 0, discarded = 0;
    for (auto& kv : tasks_) {
      switch (kv.second.state) {
        case TaskState::kTodo: ++todo; break;
        case TaskState::kLeased: ++leased; break;
        case TaskState::kDone: ++done; break;
        case TaskState::kDiscarded: ++discarded; break;
      }
    }
    char buf[160];
    snprintf(buf, sizeof(buf),
             "OK todo=%d leased=%d done=%d discarded=%d pass=%d total=%zu\n",
             todo, leased, done, discarded, pass_, tasks_.size());
    return buf;
  }

  // checkTimeoutFunc analog: requeue (or discard) expired leases.
  void CheckTimeouts() {
    std::lock_guard<std::mutex> g(mu_);
    int64_t now = now_ms();
    bool changed = false;
    for (auto& kv : tasks_) {
      Task& t = kv.second;
      if (t.state == TaskState::kLeased && t.lease_deadline_ms <= now) {
        FailLocked(&t);
        changed = true;
      }
    }
    if (changed) Snapshot();
  }

 private:
  // processFailedTask analog: retry up to failure_max, then discard.
  void FailLocked(Task* t) {
    ++t->failures;
    if (t->failures >= failure_max_) {
      t->state = TaskState::kDiscarded;
    } else {
      t->state = TaskState::kTodo;
      todo_.push_back(t->id);
    }
  }

  // Atomic snapshot (etcd-save analog): text header + binary payloads.
  void Snapshot() {
    if (snapshot_path_.empty()) return;
    std::string tmp = snapshot_path_ + ".tmp";
    FILE* f = fopen(tmp.c_str(), "wb");
    if (!f) return;
    fprintf(f, "%d %ld %zu\n", pass_, static_cast<long>(next_id_),
            tasks_.size());
    for (auto& kv : tasks_) {
      const Task& t = kv.second;
      fprintf(f, "%ld %d %d %zu\n", static_cast<long>(t.id), t.failures,
              static_cast<int>(t.state), t.payload.size());
      fwrite(t.payload.data(), 1, t.payload.size(), f);
      fputc('\n', f);
    }
    fclose(f);
    rename(tmp.c_str(), snapshot_path_.c_str());
  }

  void Recover() {
    if (snapshot_path_.empty()) return;
    FILE* f = fopen(snapshot_path_.c_str(), "rb");
    if (!f) return;
    size_t n = 0;
    long next_id = 0;
    if (fscanf(f, "%d %ld %zu", &pass_, &next_id, &n) != 3) {
      fclose(f);
      pass_ = 0;  // fscanf may have written a partial header into it
      return;
    }
    fgetc(f);  // exactly the header newline
    // staged all-or-nothing parse (matches pserver.cc Recover): a
    // truncated/corrupt snapshot must not leave a silently partial task
    // set, and a corrupt len field must not bad_alloc the master away
    const size_t kMaxLen = 100u << 20;  // matches the ADD payload cap
    std::map<int64_t, Task> staged;
    bool complete = true;
    for (size_t i = 0; i < n; ++i) {
      long id;
      int failures, state;
      size_t len;
      // no trailing '\n' in the format: scanf's '\n' matches a RUN of
      // whitespace and would swallow leading payload bytes that happen
      // to be 0x09-0x0D/0x20, misaligning every later record
      if (fscanf(f, "%ld %d %d %zu", &id, &failures, &state, &len) != 4 ||
          len > kMaxLen) {
        complete = false;
        break;
      }
      fgetc(f);  // exactly the header newline; payload starts next byte
      Task t;
      t.id = id;
      t.failures = failures;
      t.state = static_cast<TaskState>(state);
      t.payload.resize(len);
      if (len && fread(&t.payload[0], 1, len, f) != len) {
        complete = false;
        break;
      }
      fgetc(f);  // trailing newline
      // leases do not survive a master restart: requeue them
      if (t.state == TaskState::kLeased) t.state = TaskState::kTodo;
      staged[t.id] = std::move(t);
    }
    // an undersized header count (corrupted digit) would parse cleanly
    // and silently drop the tail — the file must be fully consumed
    if (complete && fgetc(f) != EOF) complete = false;
    fclose(f);
    if (!complete) {
      fprintf(stderr,
              "master: snapshot truncated/corrupt (%zu of %zu tasks "
              "readable), starting fresh\n", staged.size(), n);
      pass_ = 0;
      next_id_ = 0;
      return;
    }
    next_id_ = next_id;
    for (auto& kv : staged)
      if (kv.second.state == TaskState::kTodo) todo_.push_back(kv.first);
    tasks_ = std::move(staged);
  }

  std::mutex mu_;
  std::map<int64_t, Task> tasks_;
  std::deque<int64_t> todo_;
  int64_t next_id_ = 0;
  int pass_ = 0;
  std::string snapshot_path_;
  int failure_max_;
  int64_t lease_timeout_ms_;
};

// -- line-framed socket IO ---------------------------------------------------

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

void ServeClient(Master* master, int fd) {
  std::string line;
  while (ReadLine(fd, &line)) {
    std::string resp, payload;
    if (line.rfind("ADD ", 0) == 0) {
      size_t len = strtoull(line.c_str() + 4, nullptr, 10);
      if (len > (100u << 20)) break;
      std::string body(len, '\0');
      if (!ReadExact(fd, &body[0], len)) break;
      resp = master->Add(body);
    } else if (line == "GET") {
      resp = master->Get(&payload);
    } else if (line.rfind("FIN ", 0) == 0) {
      resp = master->Finish(strtoll(line.c_str() + 4, nullptr, 10));
    } else if (line.rfind("FAIL ", 0) == 0) {
      resp = master->Fail(strtoll(line.c_str() + 5, nullptr, 10));
    } else if (line == "RESET") {
      resp = master->Reset();
    } else if (line == "STATUS") {
      resp = master->Status();
    } else if (line == "QUIT") {
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
            "usage: master_server <port> <snapshot_path> [failure_max] "
            "[lease_timeout_ms]\n");
    return 1;
  }
  int port = atoi(argv[1]);
  std::string snapshot = argv[2];
  if (snapshot == "-") snapshot.clear();
  int failure_max = argc > 3 ? atoi(argv[3]) : 3;
  int64_t lease_ms = argc > 4 ? atoll(argv[4]) : 60000;

  Master master(snapshot, failure_max, lease_ms);

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

  std::thread timeout_thread([&master]() {
    while (true) {
      std::this_thread::sleep_for(std::chrono::milliseconds(200));
      master.CheckTimeouts();
    }
  });
  timeout_thread.detach();

  while (true) {
    int fd = accept(srv, nullptr, nullptr);
    if (fd < 0) continue;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    std::thread(ServeClient, &master, fd).detach();
  }
}
