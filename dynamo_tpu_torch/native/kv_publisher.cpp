// C ABI KV-event publisher for engine integration.
//
// Native equivalent of the reference's lib/bindings/c (dynamo_llm_init /
// dynamo_kv_event_publish_stored / dynamo_kv_event_publish_removed /
// dynamo_llm_shutdown): an engine-side C library that publishes KV cache
// store/evict events onto the event plane so routers can maintain their
// prefix indexes, without ever blocking the engine's step loop.
//
// Transport: one TCP connection to dynstore speaking the wire protocol
// (dynamo_tpu_torch/runtime/wire.py). Events are published on subject
// "{namespace}.{component}.kv_events" with the same JSON RouterEvent body
// the Python publisher emits (dynamo_tpu_torch/llm/kv_router/publisher.py /
// protocols.py), so Python indexers consume them unchanged.
//
// Threading: publish calls enqueue into an in-memory queue guarded by a
// mutex (cheap, non-blocking); a background thread drains it to the socket;
// a reader thread consumes replies so the server's send buffer never fills.
// This mirrors the reference's mpsc->publisher-task shape
// (lib/llm/src/kv_router/publisher.rs:32-60).

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>

#include "msgpack.hpp"

using dynwire::Value;

namespace {

struct Publisher {
  int fd = -1;
  std::string subject;
  int64_t worker_id = 0;
  std::atomic<int64_t> next_rid{1};

  std::mutex mu;
  std::condition_variable cv;
  std::deque<std::string> queue;  // encoded frames awaiting send
  bool in_flight = false;  // a popped frame is mid-::send (drain must wait)
  bool stopping = false;
  std::thread sender;
  std::thread reader;

  ~Publisher() { stop(); }

  void stop() {
    {
      std::lock_guard<std::mutex> g(mu);
      if (stopping) return;
      stopping = true;
    }
    cv.notify_all();
    if (fd >= 0) shutdown(fd, SHUT_RDWR);
    if (sender.joinable()) sender.join();
    if (reader.joinable()) reader.join();
    if (fd >= 0) close(fd);
    fd = -1;
  }

  void run_sender() {
    for (;;) {
      std::string frame;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] { return stopping || !queue.empty(); });
        if (queue.empty()) return;  // stopping with a drained queue
        frame = std::move(queue.front());
        queue.pop_front();
        in_flight = true;
      }
      size_t off = 0;
      bool ok = true;
      while (off < frame.size()) {
        ssize_t k = ::send(fd, frame.data() + off, frame.size() - off,
                           MSG_NOSIGNAL);
        if (k <= 0) { ok = false; break; }  // connection gone: go dark
        off += static_cast<size_t>(k);
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        in_flight = false;
      }
      cv.notify_all();  // wake a shutdown drain waiting on the last frame
      if (!ok) return;
    }
  }

  void run_reader() {
    // drain replies; content is ignored (publish is fire-and-forget here,
    // like the reference's event plane)
    char buf[16384];
    for (;;) {
      ssize_t k = ::recv(fd, buf, sizeof(buf), 0);
      if (k <= 0) return;
    }
  }

  void enqueue_publish(const std::string& json_payload) {
    Value msg = Value::map();
    msg.set("op", Value::str("publish"));
    msg.set("id", Value::integer(next_rid.fetch_add(1)));
    msg.set("subject", Value::str(subject));
    msg.set("payload", Value::bin(json_payload));
    std::string frame = dynwire::frame(msg);
    {
      std::lock_guard<std::mutex> g(mu);
      if (stopping) return;
      queue.push_back(std::move(frame));
    }
    cv.notify_one();
  }
};

Publisher* g_pub = nullptr;
std::mutex g_mu;

void append_u64(std::string& s, uint64_t v) {
  char buf[24];
  snprintf(buf, sizeof(buf), "%llu", static_cast<unsigned long long>(v));
  s += buf;
}

void append_i64(std::string& s, int64_t v) {
  char buf[24];
  snprintf(buf, sizeof(buf), "%lld", static_cast<long long>(v));
  s += buf;
}

}  // namespace

extern "C" {

// Connect to dynstore at host:port and prepare to publish KV events for
// worker `worker_id` of {ns}.{component}. Returns 0 on success, -1 on error.
int dynamo_llm_init(const char* host, int port, const char* ns,
                    const char* component, int64_t worker_id) {
  std::lock_guard<std::mutex> g(g_mu);
  if (g_pub) return -1;  // already initialized

  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    hostent* he = gethostbyname(host);
    if (!he) {
      close(fd);
      return -1;
    }
    std::memcpy(&addr.sin_addr, he->h_addr, sizeof(addr.sin_addr));
  }
  if (connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0) {
    close(fd);
    return -1;
  }

  auto* p = new Publisher();
  p->fd = fd;
  p->worker_id = worker_id;
  p->subject = std::string(ns) + "." + component + ".kv_events";
  p->sender = std::thread([p] { p->run_sender(); });
  p->reader = std::thread([p] { p->run_reader(); });
  g_pub = p;
  return 0;
}

// Publish a "stored" event: n blocks, each (block_hash=sequence hash,
// tokens_hash=content hash), chained under parent_hash (has_parent=0 for a
// root block), computed under LoRA adapter `lora_id` (0 = base model; the
// caller must have salted the hash chain root per tokens.py
// lora_chain_root — the wire field is the audit trail, matching the
// reference C ABI's end-to-end lora_id, lib/bindings/c/src/lib.rs:253-283).
// Returns 0 on success, -1 if not initialized.
int dynamo_kv_event_publish_stored_v2(int64_t event_id,
                                      const uint64_t* block_hashes,
                                      const uint64_t* tokens_hashes, size_t n,
                                      int has_parent, uint64_t parent_hash,
                                      uint64_t lora_id) {
  std::lock_guard<std::mutex> g(g_mu);
  if (!g_pub) return -1;
  std::string j = "{\"worker_id\": ";
  append_i64(j, g_pub->worker_id);
  j += ", \"event\": {\"event_id\": ";
  append_i64(j, event_id);
  j += ", \"stored\": {\"parent_hash\": ";
  if (has_parent) append_u64(j, parent_hash);
  else j += "null";
  if (lora_id != 0) {
    j += ", \"lora_id\": ";
    append_u64(j, lora_id);
  }
  j += ", \"blocks\": [";
  for (size_t i = 0; i < n; ++i) {
    if (i) j += ", ";
    j += "{\"block_hash\": ";
    append_u64(j, block_hashes[i]);
    j += ", \"tokens_hash\": ";
    append_u64(j, tokens_hashes[i]);
    j += "}";
  }
  j += "]}}}";
  g_pub->enqueue_publish(j);
  return 0;
}

// Base-model variant (lora_id = 0); kept for ABI stability.
int dynamo_kv_event_publish_stored(int64_t event_id,
                                   const uint64_t* block_hashes,
                                   const uint64_t* tokens_hashes, size_t n,
                                   int has_parent, uint64_t parent_hash) {
  return dynamo_kv_event_publish_stored_v2(event_id, block_hashes,
                                           tokens_hashes, n, has_parent,
                                           parent_hash, 0);
}

// Publish a "removed" event for n evicted blocks (sequence hashes).
int dynamo_kv_event_publish_removed(int64_t event_id,
                                    const uint64_t* block_hashes, size_t n) {
  std::lock_guard<std::mutex> g(g_mu);
  if (!g_pub) return -1;
  std::string j = "{\"worker_id\": ";
  append_i64(j, g_pub->worker_id);
  j += ", \"event\": {\"event_id\": ";
  append_i64(j, event_id);
  j += ", \"removed\": {\"block_hashes\": [";
  for (size_t i = 0; i < n; ++i) {
    if (i) j += ", ";
    append_u64(j, block_hashes[i]);
  }
  j += "]}}}";
  g_pub->enqueue_publish(j);
  return 0;
}

// Flush pending events and tear down the connection. Returns 0.
int dynamo_llm_shutdown(void) {
  std::lock_guard<std::mutex> g(g_mu);
  if (!g_pub) return 0;
  // give the sender a moment to drain queued AND in-flight frames before
  // tearing the socket down (a popped frame mid-send still counts)
  for (int i = 0; i < 100; ++i) {
    {
      std::lock_guard<std::mutex> q(g_pub->mu);
      if (g_pub->queue.empty() && !g_pub->in_flight) break;
    }
    std::this_thread::sleep_for(std::chrono::milliseconds(10));
  }
  delete g_pub;
  g_pub = nullptr;
  return 0;
}

}  // extern "C"
