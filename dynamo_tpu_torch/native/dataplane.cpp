// dataplane — native (C++) implementation of the worker data plane.
//
// The per-worker TCP server that speaks the two-part frame protocol
// (dynamo_tpu_torch/runtime/wire.py): accepts connections, parses request /
// part / end / stop / kill frames, and streams back whatever the embedding
// process queues — connection lifecycle, framing, buffering and control
// demultiplexing all run in native code on a dedicated epoll thread, while
// request EXECUTION stays with the embedder (the Python asyncio runtime
// invokes its handlers and pushes pre-packed response frames back through
// the C ABI). Python's asyncio server (runtime/component.py _serve_conn)
// remains the reference implementation and test fixture.
//
//   embedder                      libdynamo_dataplane.so
//   --------                      ----------------------
//   dp_start(host, port, cbs) --> bind + epoll thread
//       <-- on_request(sid, endpoint, ctx_id, ctype, payload, streaming,
//                      resume, deadline, priority, trace_id, trace_parent)
//       <-- on_part(sid, data, is_end)        (client-streamed requests)
//       <-- on_control(sid, STOP|KILL|GONE)
//   dp_send(sid, frame_bytes)  --> queued on the stream's connection
//   dp_end(sid)                --> stream done; connection reusable
//
// Reference capability: the reference's native request/response plane
// (lib/runtime/src/pipeline/network/{ingress,egress}, tcp/server.rs,
// codec/two_part.rs — ~2.2k LoC Rust), collapsed onto one duplexed
// connection as the Python data plane does.
//
// Build: dynamo_tpu_torch/native/_build.py at first use (g++ -O2
// -std=c++17 -fPIC -shared, into build/dynamo_tpu_torch/native/)

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <cmath>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include "msgpack.hpp"

using dynwire::Value;

extern "C" {
typedef void (*dp_request_cb)(int64_t sid, const char* endpoint,
                              const char* ctx_id, const char* ctype,
                              const uint8_t* payload, uint64_t len,
                              int streaming, int64_t resume,
                              double deadline, const char* priority,
                              const char* trace_id,
                              const char* trace_parent);
typedef void (*dp_part_cb)(int64_t sid, const uint8_t* data, uint64_t len,
                           int is_end);
typedef void (*dp_control_cb)(int64_t sid, int kind);  // 0 stop 1 kill 2 gone
}

namespace {

constexpr size_t kMaxFrame = 256ull * 1024 * 1024;

struct Conn {
  int fd = -1;
  std::string rbuf;
  size_t rstart = 0;
  std::string wbuf;        // guarded by Server::mu_
  size_t wstart = 0;
  bool want_write = false;
  int64_t cur_sid = 0;     // 0 = idle (no active stream)
  bool streaming = false;  // client still sending parts
};

struct Server {
  int lfd = -1;
  int efd = -1;   // epoll
  int wakefd = -1;
  uint16_t port = 0;
  std::thread loop;
  std::atomic<bool> running{false};
  dp_request_cb on_request = nullptr;
  dp_part_cb on_part = nullptr;
  dp_control_cb on_control = nullptr;

  std::mutex mu_;  // guards conns_ write-side state + sid map + dead list
  std::unordered_map<int, Conn*> conns_;
  std::unordered_map<int64_t, int> sid2fd_;
  int64_t next_sid_ = 1;
  std::vector<int> dead_;

  // ----------------------------------------------------------------
  static void set_nonblock(int fd) {
    fcntl(fd, F_SETFL, fcntl(fd, F_GETFL, 0) | O_NONBLOCK);
  }

  bool start(const char* host, int port_in) {
    lfd = socket(AF_INET, SOCK_STREAM, 0);
    if (lfd < 0) return false;
    int one = 1;
    setsockopt(lfd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(static_cast<uint16_t>(port_in));
    addr.sin_addr.s_addr =
        host && *host ? inet_addr(host) : htonl(INADDR_ANY);
    if (bind(lfd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0)
      return fail_start();
    socklen_t alen = sizeof(addr);
    getsockname(lfd, reinterpret_cast<sockaddr*>(&addr), &alen);
    port = ntohs(addr.sin_port);
    if (listen(lfd, 128) != 0) return fail_start();
    set_nonblock(lfd);
    efd = epoll_create1(0);
    wakefd = eventfd(0, EFD_NONBLOCK);
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.fd = lfd;
    epoll_ctl(efd, EPOLL_CTL_ADD, lfd, &ev);
    ev.events = EPOLLIN;
    ev.data.fd = wakefd;
    epoll_ctl(efd, EPOLL_CTL_ADD, wakefd, &ev);
    running = true;
    loop = std::thread([this] { run(); });
    return true;
  }

  bool fail_start() {
    // close whatever a failed start() opened so retry loops don't leak fds
    if (lfd >= 0) { close(lfd); lfd = -1; }
    if (efd >= 0) { close(efd); efd = -1; }
    if (wakefd >= 0) { close(wakefd); wakefd = -1; }
    return false;
  }

  void stop() {
    running = false;
    wake();
    if (loop.joinable()) loop.join();
    std::lock_guard<std::mutex> g(mu_);
    for (auto& [fd, c] : conns_) {
      close(fd);
      delete c;
    }
    conns_.clear();
    sid2fd_.clear();
    if (lfd >= 0) close(lfd);
    if (efd >= 0) close(efd);
    if (wakefd >= 0) close(wakefd);
  }

  void wake() {
    uint64_t one = 1;
    [[maybe_unused]] ssize_t n = write(wakefd, &one, sizeof(one));
  }

  // ---------------------------------------------------------------- loop
  void run() {
    epoll_event events[128];
    while (running) {
      int n = epoll_wait(efd, events, 128, 100);
      for (int i = 0; i < n; i++) {
        int fd = events[i].data.fd;
        if (fd == lfd) {
          accept_all();
          continue;
        }
        if (fd == wakefd) {
          uint64_t junk;
          while (read(wakefd, &junk, sizeof(junk)) > 0) {
          }
          // cross-thread sends queued: arm EPOLLOUT where needed
          std::lock_guard<std::mutex> g(mu_);
          for (auto& [cfd, c] : conns_) arm(c);
          continue;
        }
        Conn* c;
        {
          std::lock_guard<std::mutex> g(mu_);
          auto it = conns_.find(fd);
          if (it == conns_.end()) continue;
          c = it->second;
        }
        if (events[i].events & (EPOLLHUP | EPOLLERR)) {
          drop(c);
          continue;
        }
        if (events[i].events & EPOLLIN) on_readable(c);
        bool alive;
        {
          std::lock_guard<std::mutex> g(mu_);
          alive = conns_.count(fd) > 0;
        }
        if (alive && (events[i].events & EPOLLOUT)) on_writable(c);
      }
      // deferred closes; finish_drop can cascade via callbacks, so drain
      // by swapped batches
      while (true) {
        std::vector<int> batch;
        {
          std::lock_guard<std::mutex> g(mu_);
          if (dead_.empty()) break;
          batch.swap(dead_);
        }
        for (int fd : batch) finish_drop(fd);
      }
    }
  }

  void accept_all() {
    while (true) {
      int fd = accept(lfd, nullptr, nullptr);
      if (fd < 0) return;
      set_nonblock(fd);
      int one = 1;
      setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      auto* c = new Conn();
      c->fd = fd;
      {
        std::lock_guard<std::mutex> g(mu_);
        conns_[fd] = c;
      }
      epoll_event ev{};
      ev.events = EPOLLIN;
      ev.data.fd = fd;
      epoll_ctl(efd, EPOLL_CTL_ADD, fd, &ev);
    }
  }

  void drop(Conn* c) {
    std::lock_guard<std::mutex> g(mu_);
    dead_.push_back(c->fd);
  }

  void finish_drop(int fd) {
    Conn* c;
    int64_t sid = 0;
    {
      std::lock_guard<std::mutex> g(mu_);
      auto it = conns_.find(fd);
      if (it == conns_.end()) return;
      c = it->second;
      conns_.erase(it);
      sid = c->cur_sid;
      if (sid) sid2fd_.erase(sid);
    }
    epoll_ctl(efd, EPOLL_CTL_DEL, fd, nullptr);
    close(fd);
    delete c;
    if (sid && on_control) on_control(sid, 2);  // gone
  }

  // ---------------------------------------------------------------- read
  void on_readable(Conn* c) {
    char buf[65536];
    while (true) {
      ssize_t n = recv(c->fd, buf, sizeof(buf), 0);
      if (n > 0) {
        c->rbuf.append(buf, static_cast<size_t>(n));
        continue;
      }
      if (n == 0) {
        drop(c);
        return;
      }
      if (errno == EAGAIN || errno == EWOULDBLOCK) break;
      drop(c);
      return;
    }
    while (true) {
      size_t avail = c->rbuf.size() - c->rstart;
      if (avail < 4) break;
      const auto* p =
          reinterpret_cast<const unsigned char*>(c->rbuf.data() + c->rstart);
      size_t len = (size_t(p[0]) << 24) | (size_t(p[1]) << 16) |
                   (size_t(p[2]) << 8) | size_t(p[3]);
      if (len > kMaxFrame) {
        drop(c);
        return;
      }
      if (avail < 4 + len) break;
      try {
        handle_frame(c, c->rbuf.data() + c->rstart + 4, len);
      } catch (const std::exception&) {
        drop(c);
        return;
      }
      c->rstart += 4 + len;
      bool alive;
      {
        std::lock_guard<std::mutex> g(mu_);
        alive = conns_.count(c->fd) > 0;
      }
      if (!alive) return;
    }
    if (c->rstart > 0) {
      c->rbuf.erase(0, c->rstart);
      c->rstart = 0;
    }
  }

  int64_t cur_sid_of(Conn* c) {
    // cur_sid is written by end_stream on the embedder thread — every
    // cross-thread-visible field access goes through mu_
    std::lock_guard<std::mutex> g(mu_);
    return c->cur_sid;
  }

  void handle_frame(Conn* c, const char* data, size_t len) {
    dynwire::Cursor cur{reinterpret_cast<const uint8_t*>(data), len};
    Value v = dynwire::decode(cur);
    if (v.t != Value::T::Arr || v.a.size() != 2) throw std::runtime_error("f");
    const Value& control = v.a[0];
    const Value& payload = v.a[1];
    const Value* kindv = control.get("kind");
    if (!kindv) throw std::runtime_error("kind");
    const std::string& kind = kindv->s;

    if (kind == "request") {
      int64_t sid;
      {
        std::lock_guard<std::mutex> g(mu_);
        sid = next_sid_++;
        c->cur_sid = sid;
        sid2fd_[sid] = c->fd;
      }
      const Value* ep = control.get("endpoint");
      const Value* cid = control.get("context_id");
      const Value* ct = control.get("ctype");
      const Value* st = control.get("streaming");
      // mid-stream failover attempt ordinal (wire.py RESUME_KEY): the
      // embedder's duplicate-context guard needs it to let a higher
      // ordinal supersede a zombie context of the same id
      const Value* rs = control.get("resume");
      // the envelope the embedder's ingress acts on, as the asyncio
      // plane reads it: the absolute deadline (NaN: none), the overload
      // priority ("": interactive) and the span context [trace_id,
      // parent_span_id] ("": absent)
      const Value* dl = control.get("deadline");
      double deadline = std::nan("");
      if (dl && dl->t == Value::T::Double) deadline = dl->d;
      if (dl && dl->t == Value::T::Int) deadline = double(dl->i);
      const Value* pr = control.get("priority");
      const Value* tr = control.get("trace");
      const char* trace_id = "";
      const char* trace_parent = "";
      if (tr && tr->t == Value::T::Arr && tr->a.size() == 2 &&
          tr->a[0].t == Value::T::Str) {
        trace_id = tr->a[0].s.c_str();
        if (tr->a[1].t == Value::T::Str) trace_parent = tr->a[1].s.c_str();
      }
      {
        std::lock_guard<std::mutex> g(mu_);
        c->streaming = st && st->t == Value::T::Bool && st->b;
      }
      if (on_request)
        on_request(sid, ep ? ep->s.c_str() : "",
                   cid && cid->t == Value::T::Str ? cid->s.c_str() : "",
                   ct && ct->t == Value::T::Str ? ct->s.c_str() : "",
                   reinterpret_cast<const uint8_t*>(payload.s.data()),
                   payload.s.size(), c->streaming ? 1 : 0,
                   rs && rs->t == Value::T::Int ? rs->i : 0, deadline,
                   pr && pr->t == Value::T::Str ? pr->s.c_str() : "",
                   trace_id, trace_parent);
    } else if (kind == "part") {
      int64_t sid = cur_sid_of(c);
      if (sid && on_part)
        on_part(sid, reinterpret_cast<const uint8_t*>(payload.s.data()),
                payload.s.size(), 0);
    } else if (kind == "end") {
      int64_t sid;
      {
        std::lock_guard<std::mutex> g(mu_);
        c->streaming = false;
        sid = c->cur_sid;
      }
      if (sid && on_part) on_part(sid, nullptr, 0, 1);
    } else if (kind == "stop") {
      int64_t sid = cur_sid_of(c);
      if (sid && on_control) on_control(sid, 0);
    } else if (kind == "kill") {
      int64_t sid = cur_sid_of(c);
      if (sid && on_control) on_control(sid, 1);
    }
    // unknown kinds ignored (forward compatible)
  }

  // ---------------------------------------------------------------- write
  void arm(Conn* c) {
    // caller holds mu_
    bool want = c->wstart < c->wbuf.size();
    if (want == c->want_write) return;
    c->want_write = want;
    epoll_event ev{};
    ev.events = EPOLLIN | (want ? EPOLLOUT : 0);
    ev.data.fd = c->fd;
    epoll_ctl(efd, EPOLL_CTL_MOD, c->fd, &ev);
  }

  void on_writable(Conn* c) {
    std::unique_lock<std::mutex> g(mu_);
    while (c->wstart < c->wbuf.size()) {
      ssize_t n = send(c->fd, c->wbuf.data() + c->wstart,
                       c->wbuf.size() - c->wstart, MSG_NOSIGNAL);
      if (n > 0) {
        c->wstart += static_cast<size_t>(n);
        continue;
      }
      if (errno == EAGAIN || errno == EWOULDBLOCK) break;
      g.unlock();
      drop(c);
      return;
    }
    if (c->wstart == c->wbuf.size()) {
      c->wbuf.clear();
      c->wstart = 0;
    }
    arm(c);
  }

  // thread-safe: called from the embedder
  void send_frame(int64_t sid, const uint8_t* frame, uint64_t len) {
    {
      std::lock_guard<std::mutex> g(mu_);
      auto it = sid2fd_.find(sid);
      if (it == sid2fd_.end()) return;  // connection gone: drop silently
      auto cit = conns_.find(it->second);
      if (cit == conns_.end()) return;
      cit->second->wbuf.append(reinterpret_cast<const char*>(frame), len);
    }
    wake();
  }

  int64_t backlog(int64_t sid) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = sid2fd_.find(sid);
    if (it == sid2fd_.end()) return -1;
    auto cit = conns_.find(it->second);
    if (cit == conns_.end()) return -1;
    return static_cast<int64_t>(cit->second->wbuf.size()
                                - cit->second->wstart);
  }

  void end_stream(int64_t sid) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = sid2fd_.find(sid);
    if (it == sid2fd_.end()) return;
    auto cit = conns_.find(it->second);
    if (cit != conns_.end() && cit->second->cur_sid == sid) {
      cit->second->cur_sid = 0;
      cit->second->streaming = false;
    }
    sid2fd_.erase(it);
  }
};

}  // namespace

extern "C" {

void* dp_start(const char* host, int port, dp_request_cb on_request,
               dp_part_cb on_part, dp_control_cb on_control) {
  auto* s = new Server();
  s->on_request = on_request;
  s->on_part = on_part;
  s->on_control = on_control;
  if (!s->start(host, port)) {
    delete s;
    return nullptr;
  }
  return s;
}

int dp_port(void* h) { return static_cast<Server*>(h)->port; }

void dp_send(void* h, int64_t sid, const uint8_t* frame, uint64_t len) {
  static_cast<Server*>(h)->send_frame(sid, frame, len);
}

void dp_end(void* h, int64_t sid) {
  static_cast<Server*>(h)->end_stream(sid);
}

int64_t dp_backlog(void* h, int64_t sid) {
  return static_cast<Server*>(h)->backlog(sid);
}

void dp_stop(void* h) {
  auto* s = static_cast<Server*>(h);
  s->stop();
  delete s;
}

}  // extern "C"
