// dynstore — native (C++) implementation of the coordination plane.
//
// Same wire protocol and semantics as the Python reference implementation
// (dynamo_tpu_torch/runtime/store_server.py), which remains the test fixture:
//
// - KV with leases + prefix watches (the etcd role): put/get/get_prefix/
//   create/delete; leases with TTL + keepalive; keys bound to a lease vanish
//   when it expires; watchers get pushed put/delete events.
// - Pub/sub (the NATS core role): subject-based fanout.
// - Work queues (the JetStream role): push/pull-with-ack; unacked messages
//   return to the queue head when their consumer's connection dies.
//
// Single-threaded epoll event loop, non-blocking sockets, per-connection
// read/write buffers — the same single-owner discipline as the asyncio
// fixture, without the interpreter. Reference capability: the reference's
// native runtime transports (lib/runtime/src/transports/{etcd,nats}.rs)
// collapsed into one deployable binary.
//
// Build: dynamo_tpu_torch/native/_build.py at first use (g++ -O2
// -std=c++17, into build/dynamo_tpu_torch/native/)
// Run:   dynstore [--host H] [--port P]   (port 0 = ephemeral; prints
//        "dynstore listening on H:P" on stdout when ready)

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <signal.h>
#include <sys/epoll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <chrono>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <set>
#include <string>
#include <unordered_map>
#include <vector>

#include "msgpack.hpp"

using dynwire::Value;

namespace {

double now_s() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

constexpr double kDefaultTtl = 5.0;
constexpr double kReapInterval = 0.2;

struct QueueMsg {
  int64_t id;
  std::string payload;
};

struct Lease {
  int64_t id;
  double ttl;
  double expires;
  std::set<std::string> keys;
};

struct KeyVal {
  std::string value;
  int64_t lease = -1;  // -1 = no lease
};

struct Conn {
  int fd = -1;
  int64_t id = 0;
  std::string rbuf;
  size_t rstart = 0;
  std::string wbuf;
  size_t wstart = 0;
  bool closing = false;
  std::unordered_map<int64_t, std::string> watches;  // wid -> prefix
  std::set<int64_t> leases;
  std::map<std::pair<std::string, int64_t>, QueueMsg> unacked;
};

class Server {
 public:
  Server(std::string host, int port) : host_(std::move(host)), port_(port) {}

  int run() {
    signal(SIGPIPE, SIG_IGN);
    listen_fd_ = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
    if (listen_fd_ < 0) return perror_ret("socket");
    int one = 1;
    setsockopt(listen_fd_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(static_cast<uint16_t>(port_));
    if (inet_pton(AF_INET, host_.c_str(), &addr.sin_addr) != 1)
      addr.sin_addr.s_addr = INADDR_ANY;
    if (bind(listen_fd_, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0)
      return perror_ret("bind");
    if (listen(listen_fd_, 256) < 0) return perror_ret("listen");
    socklen_t alen = sizeof(addr);
    getsockname(listen_fd_, reinterpret_cast<sockaddr*>(&addr), &alen);
    port_ = ntohs(addr.sin_port);

    ep_ = epoll_create1(0);
    if (ep_ < 0) return perror_ret("epoll_create1");
    epoll_event ev{};
    ev.events = EPOLLIN;
    ev.data.fd = listen_fd_;
    epoll_ctl(ep_, EPOLL_CTL_ADD, listen_fd_, &ev);

    printf("dynstore listening on %s:%d\n", host_.c_str(), port_);
    fflush(stdout);

    std::vector<epoll_event> events(128);
    double next_reap = now_s() + kReapInterval;
    for (;;) {
      double wait = next_reap - now_s();
      int timeout_ms = wait > 0 ? static_cast<int>(wait * 1000) + 1 : 0;
      int n = epoll_wait(ep_, events.data(),
                         static_cast<int>(events.size()), timeout_ms);
      if (n < 0) {
        if (errno == EINTR) continue;
        return perror_ret("epoll_wait");
      }
      for (int i = 0; i < n; ++i) {
        int fd = events[i].data.fd;
        if (fd == listen_fd_) {
          accept_conns();
        } else {
          auto it = conns_.find(fd);
          if (it == conns_.end()) continue;
          Conn* c = it->second.get();
          if (events[i].events & (EPOLLHUP | EPOLLERR)) {
            drop_conn(c);
            continue;
          }
          if (events[i].events & EPOLLIN) on_readable(c);
          if (conns_.count(fd) && (events[i].events & EPOLLOUT))
            on_writable(c);
        }
      }
      if (now_s() >= next_reap) {
        reap_leases();
        next_reap = now_s() + kReapInterval;
      }
      // deferred closes (drop while iterating epoll events is unsafe).
      // finish_drop can cascade: lease expiry -> watcher notify -> failed
      // send -> drop_conn pushes MORE fds onto dead_ — so drain by swapping
      // batches instead of iterating a vector that may reallocate under us
      while (!dead_.empty()) {
        std::vector<int> batch;
        batch.swap(dead_);
        for (int fd : batch) finish_drop(fd);
      }
    }
  }

 private:
  static int perror_ret(const char* what) {
    perror(what);
    return 1;
  }

  // -------------------------------------------------------- connections
  void accept_conns() {
    for (;;) {
      int fd = accept4(listen_fd_, nullptr, nullptr, SOCK_NONBLOCK);
      if (fd < 0) return;
      int one = 1;
      setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      auto c = std::make_unique<Conn>();
      c->fd = fd;
      c->id = next_conn_id_++;
      epoll_event ev{};
      ev.events = EPOLLIN;
      ev.data.fd = fd;
      epoll_ctl(ep_, EPOLL_CTL_ADD, fd, &ev);
      conns_[fd] = std::move(c);
    }
  }

  void drop_conn(Conn* c) {
    if (c->closing) return;
    c->closing = true;
    dead_.push_back(c->fd);
  }

  void finish_drop(int fd) {
    auto it = conns_.find(fd);
    if (it == conns_.end()) return;
    Conn* c = it->second.get();
    cleanup(c);
    epoll_ctl(ep_, EPOLL_CTL_DEL, fd, nullptr);
    close(fd);
    conns_.erase(it);
  }

  void cleanup(Conn* c) {
    // watchers registered by this conn
    for (auto it = watchers_.begin(); it != watchers_.end();) {
      if (std::get<0>(it->second) == c)
        it = watchers_.erase(it);
      else
        ++it;
    }
    // subscriptions
    for (auto& sub : subs_) {
      auto& g = sub.second;
      for (auto it = g.begin(); it != g.end();) {
        if (it->second.first == c)
          it = g.erase(it);
        else
          ++it;
      }
    }
    // unacked queue messages return to the queue HEAD (redelivery)
    std::set<std::string> kicked;
    for (auto& kv : c->unacked) {
      const std::string& qname = kv.first.first;
      queues_[qname].push_front(kv.second);
      kicked.insert(qname);
    }
    c->unacked.clear();
    // parked pulls by this conn
    for (auto& w : queue_waiters_) {
      auto& dq = w.second;
      std::deque<std::pair<Conn*, Value>> keep;
      for (auto& e : dq)
        if (e.first != c) keep.push_back(std::move(e));
      dq = std::move(keep);
    }
    for (const auto& q : kicked) kick_queue(q);
    // leases owned by this connection expire immediately (process death)
    for (int64_t lid : std::set<int64_t>(c->leases)) expire_lease(lid);
  }

  // -------------------------------------------------------- socket IO
  void on_readable(Conn* c) {
    char tmp[65536];
    for (;;) {
      ssize_t k = ::read(c->fd, tmp, sizeof(tmp));
      if (k > 0) {
        c->rbuf.append(tmp, static_cast<size_t>(k));
      } else if (k == 0) {
        drop_conn(c);
        return;
      } else {
        if (errno == EAGAIN || errno == EWOULDBLOCK) break;
        if (errno == EINTR) continue;
        drop_conn(c);
        return;
      }
    }
    // dispatch complete frames
    try {
      Value msg;
      while (dynwire::try_unframe(c->rbuf, c->rstart, msg)) {
        dispatch(c, msg);
        if (c->closing) return;
      }
    } catch (const std::exception&) {
      drop_conn(c);  // malformed framing: kill the connection
      return;
    }
    if (c->rstart > 0) {
      c->rbuf.erase(0, c->rstart);
      c->rstart = 0;
    }
  }

  // slow-consumer policy (NATS semantics the reference inherits,
  // lib/runtime/src/transports/nats.rs): a peer whose unconsumed write
  // backlog exceeds the cap is disconnected rather than growing server
  // memory without bound. Subscribers re-subscribe on reconnect; queue
  // messages are lease-tracked and redelivered to the next consumer.
  static constexpr size_t kMaxWriteBacklog = 8 << 20;  // 8 MiB per conn

  void send(Conn* c, const Value& v) {
    if (c->closing) return;
    if (c->wbuf.size() - c->wstart > kMaxWriteBacklog) {
      fprintf(stderr,
              "dynstore: disconnecting slow consumer fd=%d (backlog %zu)\n",
              c->fd, c->wbuf.size() - c->wstart);
      drop_conn(c);
      return;
    }
    c->wbuf += dynwire::frame(v);
    flush(c);
  }

  void flush(Conn* c) {
    while (c->wstart < c->wbuf.size()) {
      ssize_t k = ::write(c->fd, c->wbuf.data() + c->wstart,
                          c->wbuf.size() - c->wstart);
      if (k > 0) {
        c->wstart += static_cast<size_t>(k);
      } else if (k < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
        break;
      } else if (k < 0 && errno == EINTR) {
        continue;
      } else {
        drop_conn(c);
        return;
      }
    }
    if (c->wstart == c->wbuf.size()) {
      c->wbuf.clear();
      c->wstart = 0;
      arm(c, EPOLLIN);
    } else {
      if (c->wstart > 1 << 20) {
        c->wbuf.erase(0, c->wstart);
        c->wstart = 0;
      }
      arm(c, EPOLLIN | EPOLLOUT);
    }
  }

  void on_writable(Conn* c) { flush(c); }

  void arm(Conn* c, uint32_t flags) {
    epoll_event ev{};
    ev.events = flags;
    ev.data.fd = c->fd;
    epoll_ctl(ep_, EPOLL_CTL_MOD, c->fd, &ev);
  }

  // -------------------------------------------------------- dispatch
  void dispatch(Conn* c, const Value& m) {
    const Value* opv = m.get("op");
    const Value* idv = m.get("id");
    Value rid = idv ? *idv : Value::nil();
    if (!opv || opv->t != Value::T::Str) {
      send(c, err_reply(rid, "missing op"));
      return;
    }
    const std::string& op = opv->s;
    Value reply = Value::map();
    bool deferred = false;
    try {
      if (op == "put") reply = op_put(m);
      else if (op == "create") reply = op_create(m);
      else if (op == "get") reply = op_get(m);
      else if (op == "get_prefix") reply = op_get_prefix(m);
      else if (op == "delete") reply = op_delete(m);
      else if (op == "lease_grant") reply = op_lease_grant(c, m);
      else if (op == "lease_keepalive") reply = op_lease_keepalive(m);
      else if (op == "lease_revoke") reply = op_lease_revoke(m);
      else if (op == "watch") reply = op_watch(c, m);
      else if (op == "subscribe") reply = op_subscribe(c, m);
      else if (op == "publish") reply = op_publish(m);
      else if (op == "q_push") reply = op_q_push(m);
      else if (op == "q_pull") deferred = op_q_pull(c, m, rid, reply);
      else if (op == "q_ack") reply = op_q_ack(c, m);
      else if (op == "q_len") reply = op_q_len(m);
      else if (op == "ping") reply.set("pong", Value::boolean(true));
      else reply = err_body("unknown op '" + op + "'");
    } catch (const std::exception& e) {
      reply = err_body(e.what());
    }
    if (deferred) return;
    if (!reply.get("id")) reply.set("id", rid);
    if (!reply.get("ok")) reply.set("ok", Value::boolean(true));
    send(c, reply);
  }

  // `code` is the machine-readable classification clients branch on
  // (lease-loss terminal vs transient retry); the text is for humans and
  // may be reworded freely.
  static Value err_body(const std::string& msg, const std::string& code = "") {
    Value r = Value::map();
    r.set("ok", Value::boolean(false));
    r.set("error", Value::str(msg));
    if (!code.empty()) r.set("code", Value::str(code));
    return r;
  }
  static Value err_reply(const Value& rid, const std::string& msg) {
    Value r = err_body(msg);
    r.set("id", rid);
    return r;
  }

  static const std::string& want_str(const Value& m, const char* key) {
    const Value* v = m.get(key);
    if (!v || v->t != Value::T::Str)
      throw std::runtime_error(std::string("missing field ") + key);
    return v->s;
  }
  static const std::string& want_data(const Value& m, const char* key) {
    const Value* v = m.get(key);
    if (!v || (v->t != Value::T::Bin && v->t != Value::T::Str))
      throw std::runtime_error(std::string("missing field ") + key);
    return v->s;
  }
  static int64_t want_int(const Value& m, const char* key) {
    const Value* v = m.get(key);
    if (!v || v->t != Value::T::Int)
      throw std::runtime_error(std::string("missing field ") + key);
    return v->i;
  }

  // -------------------------------------------------------- KV ops
  Value op_put(const Value& m) {
    const std::string& key = want_str(m, "key");
    const std::string& value = want_data(m, "value");
    const Value* lv = m.get("lease");
    int64_t lease = (lv && lv->t == Value::T::Int) ? lv->i : -1;
    if (lease >= 0 && !leases_.count(lease)) return err_body("lease not found", "lease_not_found");
    kv_[key] = KeyVal{value, lease};
    if (lease >= 0) leases_[lease].keys.insert(key);
    notify_watchers(key, &value);
    return Value::map();
  }

  Value op_create(const Value& m) {
    const std::string& key = want_str(m, "key");
    auto it = kv_.find(key);
    if (it != kv_.end()) {
      const Value* ov = m.get("or_validate");
      if (ov && ov->t == Value::T::Bool && ov->b &&
          it->second.value == want_data(m, "value")) {
        Value r = Value::map();
        r.set("created", Value::boolean(false));
        return r;
      }
      return err_body("key exists");
    }
    Value r = op_put(m);
    if (!r.truthy_ok() && r.get("ok")) return r;  // lease error from put
    Value out = Value::map();
    out.set("created", Value::boolean(true));
    return out;
  }

  Value op_get(const Value& m) {
    auto it = kv_.find(want_str(m, "key"));
    Value r = Value::map();
    r.set("value", it == kv_.end() ? Value::nil() : Value::bin(it->second.value));
    r.set("found", Value::boolean(it != kv_.end()));
    return r;
  }

  Value op_get_prefix(const Value& m) {
    const std::string& pfx = want_str(m, "prefix");
    Value items = Value::arr();
    // kv_ is a std::map — iteration is already key-sorted like the fixture
    for (auto it = kv_.lower_bound(pfx);
         it != kv_.end() && it->first.compare(0, pfx.size(), pfx) == 0; ++it) {
      Value pair = Value::arr();
      pair.a.push_back(Value::str(it->first));
      pair.a.push_back(Value::bin(it->second.value));
      items.a.push_back(std::move(pair));
    }
    Value r = Value::map();
    r.set("items", std::move(items));
    return r;
  }

  Value op_delete(const Value& m) {
    const std::string& key = want_str(m, "key");
    auto it = kv_.find(key);
    bool deleted = it != kv_.end();
    if (deleted) {
      auto lit = leases_.find(it->second.lease);
      if (lit != leases_.end()) lit->second.keys.erase(key);
      kv_.erase(it);
      notify_watchers(key, nullptr);
    }
    Value r = Value::map();
    r.set("deleted", Value::boolean(deleted));
    return r;
  }

  void notify_watchers(const std::string& key, const std::string* value) {
    for (auto& w : watchers_) {
      Conn* c = std::get<0>(w.second);
      int64_t wid = std::get<1>(w.second);
      const std::string& prefix = std::get<2>(w.second);
      if (key.compare(0, prefix.size(), prefix) != 0) continue;
      Value push = Value::map();
      push.set("push", Value::str("watch"));
      push.set("watch_id", Value::integer(wid));
      push.set("key", Value::str(key));
      push.set("value", value ? Value::bin(*value) : Value::nil());
      push.set("deleted", Value::boolean(value == nullptr));
      send(c, push);
    }
  }

  // -------------------------------------------------------- leases
  Value op_lease_grant(Conn* c, const Value& m) {
    const Value* tv = m.get("ttl");
    double ttl = kDefaultTtl;
    if (tv) {
      if (tv->t == Value::T::Double) ttl = tv->d;
      else if (tv->t == Value::T::Int) ttl = static_cast<double>(tv->i);
    }
    // bind=false grants an ORPHAN lease: not tied to this connection,
    // expires only by TTL — incident beacons/dumps and trace spans must
    // outlive the process (often short-lived or crashing) that wrote them
    const Value* bv = m.get("bind");
    bool bind = !(bv && bv->t == Value::T::Bool && !bv->b);
    int64_t lid = next_lease_id_++;
    leases_[lid] = Lease{lid, ttl, now_s() + ttl, {}};
    if (bind) c->leases.insert(lid);
    Value r = Value::map();
    r.set("lease", Value::integer(lid));
    r.set("ttl", Value::real(ttl));
    return r;
  }

  Value op_lease_keepalive(const Value& m) {
    auto it = leases_.find(want_int(m, "lease"));
    if (it == leases_.end()) return err_body("lease not found", "lease_not_found");
    it->second.expires = now_s() + it->second.ttl;
    return Value::map();
  }

  Value op_lease_revoke(const Value& m) {
    expire_lease(want_int(m, "lease"));
    return Value::map();
  }

  void reap_leases() {
    double now = now_s();
    std::vector<int64_t> expired;
    for (auto& kv : leases_)
      if (kv.second.expires < now) expired.push_back(kv.first);
    for (int64_t lid : expired) expire_lease(lid);
  }

  void expire_lease(int64_t lid) {
    auto it = leases_.find(lid);
    if (it == leases_.end()) return;
    Lease lease = std::move(it->second);
    leases_.erase(it);
    for (auto& conn : conns_) conn.second->leases.erase(lid);
    for (const std::string& key : lease.keys) {
      auto kit = kv_.find(key);
      if (kit != kv_.end() && kit->second.lease == lid) {
        kv_.erase(kit);
        notify_watchers(key, nullptr);
      }
    }
  }

  // -------------------------------------------------------- watches
  Value op_watch(Conn* c, const Value& m) {
    int64_t wid = want_int(m, "watch_id");
    const std::string& prefix = want_str(m, "prefix");
    watchers_[next_watch_gid_++] = std::make_tuple(c, wid, prefix);
    c->watches[wid] = prefix;
    Value msnap = Value::map();
    msnap.set("prefix", Value::str(prefix));
    Value r = op_get_prefix(msnap);
    return r;  // {"items": snapshot}
  }

  // -------------------------------------------------------- pub/sub
  Value op_subscribe(Conn* c, const Value& m) {
    int64_t sid = want_int(m, "sub_id");
    const std::string& subject = want_str(m, "subject");
    subs_[subject][next_sub_gid_++] = {c, sid};
    return Value::map();
  }

  Value op_publish(const Value& m) {
    const std::string& subject = want_str(m, "subject");
    const std::string& payload = want_data(m, "payload");
    int64_t n = 0;
    auto it = subs_.find(subject);
    if (it != subs_.end()) {
      for (auto& g : it->second) {
        Conn* c = g.second.first;
        if (c->closing) continue;
        Value push = Value::map();
        push.set("push", Value::str("msg"));
        push.set("sub_id", Value::integer(g.second.second));
        push.set("subject", Value::str(subject));
        push.set("payload", Value::bin(payload));
        send(c, push);
        ++n;
      }
    }
    Value r = Value::map();
    r.set("delivered", Value::integer(n));
    return r;
  }

  // -------------------------------------------------------- work queues
  Value op_q_push(const Value& m) {
    const std::string& qname = want_str(m, "queue");
    QueueMsg msg{next_queue_msg_id_++, want_data(m, "payload")};
    queues_[qname].push_back(std::move(msg));
    int64_t mid = queues_[qname].back().id;
    kick_queue(qname);
    Value r = Value::map();
    r.set("msg_id", Value::integer(mid));
    return r;
  }

  bool op_q_pull(Conn* c, const Value& m, const Value& rid, Value& reply) {
    const std::string& qname = want_str(m, "queue");
    auto& q = queues_[qname];
    if (!q.empty()) {
      QueueMsg msg = std::move(q.front());
      q.pop_front();
      c->unacked[{qname, msg.id}] = msg;
      reply = Value::map();
      reply.set("msg_id", Value::integer(msg.id));
      reply.set("payload", Value::bin(msg.payload));
      return false;
    }
    queue_waiters_[qname].emplace_back(c, rid);
    return true;  // deferred: reply pushed by kick_queue
  }

  Value op_q_ack(Conn* c, const Value& m) {
    c->unacked.erase({want_str(m, "queue"), want_int(m, "msg_id")});
    return Value::map();
  }

  Value op_q_len(const Value& m) {
    auto it = queues_.find(want_str(m, "queue"));
    Value r = Value::map();
    r.set("len", Value::integer(
        it == queues_.end() ? 0 : static_cast<int64_t>(it->second.size())));
    return r;
  }

  void kick_queue(const std::string& qname) {
    auto qit = queues_.find(qname);
    auto wit = queue_waiters_.find(qname);
    if (qit == queues_.end() || wit == queue_waiters_.end()) return;
    auto& q = qit->second;
    auto& waiters = wit->second;
    while (!q.empty() && !waiters.empty()) {
      auto [c, rid] = std::move(waiters.front());
      waiters.pop_front();
      if (c->closing) continue;
      QueueMsg msg = std::move(q.front());
      q.pop_front();
      c->unacked[{qname, msg.id}] = msg;
      Value push = Value::map();
      push.set("id", rid);
      push.set("ok", Value::boolean(true));
      push.set("msg_id", Value::integer(msg.id));
      push.set("payload", Value::bin(msg.payload));
      send(c, push);
      if (c->closing) {  // send failed: requeue for the next consumer
        q.push_front(std::move(msg));
        c->unacked.erase({qname, msg.id});
      }
    }
  }

  // -------------------------------------------------------- state
  std::string host_;
  int port_;
  int listen_fd_ = -1;
  int ep_ = -1;
  int64_t next_conn_id_ = 1;
  std::unordered_map<int, std::unique_ptr<Conn>> conns_;
  std::vector<int> dead_;

  std::map<std::string, KeyVal> kv_;  // ordered: prefix scans are ranged
  std::unordered_map<int64_t, Lease> leases_;
  int64_t next_lease_id_ = 1;
  std::map<int64_t, std::tuple<Conn*, int64_t, std::string>> watchers_;
  int64_t next_watch_gid_ = 1;
  std::map<std::string, std::map<int64_t, std::pair<Conn*, int64_t>>> subs_;
  int64_t next_sub_gid_ = 1;
  std::unordered_map<std::string, std::deque<QueueMsg>> queues_;
  std::unordered_map<std::string, std::deque<std::pair<Conn*, Value>>>
      queue_waiters_;
  int64_t next_queue_msg_id_ = 1;
};

}  // namespace

int main(int argc, char** argv) {
  std::string host = "0.0.0.0";
  int port = 4222;
  for (int i = 1; i < argc; ++i) {
    std::string a = argv[i];
    if (a == "--host" && i + 1 < argc) host = argv[++i];
    else if (a == "--port" && i + 1 < argc) port = atoi(argv[++i]);
    else {
      fprintf(stderr, "usage: dynstore [--host H] [--port P]\n");
      return 2;
    }
  }
  Server s(host, port);
  return s.run();
}
