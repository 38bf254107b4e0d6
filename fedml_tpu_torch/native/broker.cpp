// fedml_tpu_torch native topic broker (the port's copy of the JAX
// package's native/broker.cpp; built into fedml_tpu_torch/native/build/).
//
// C++ implementation of the message-fabric broker (same wire protocol
// as fedml_tpu_torch/core/comm/broker.py — u32 frame_len | u8 verb
// (0=sub 1=pub 2=msg) | u16 topic_len | topic utf8 | payload). The
// reference framework rides an external MQTT broker for its control
// plane; this is the self-hosted native runtime piece: the Python
// broker is the in-process/test fabric, this binary is the deployment
// one (thread-per-connection, per-socket write mutex so concurrent
// fan-out never interleaves frames).
//
// Usage: fedml_broker [port]   (0 or absent = ephemeral)
// Prints "LISTENING <port>" on stdout once ready.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <memory>
#include <set>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr uint8_t kVerbSub = 0;
constexpr uint8_t kVerbPub = 1;
constexpr uint8_t kVerbMsg = 2;
constexpr uint32_t kMaxFrame = 1u << 30;  // 1 GB (reference gRPC cap)

struct Conn {
  int fd;
  std::mutex write_mu;
  explicit Conn(int f) : fd(f) {}
};

std::mutex g_mu;
std::map<std::string, std::set<std::shared_ptr<Conn>>> g_subs;

bool read_exact(int fd, void* buf, size_t n) {
  auto* p = static_cast<uint8_t*>(buf);
  while (n > 0) {
    ssize_t r = ::read(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool write_all(int fd, const void* buf, size_t n) {
  auto* p = static_cast<const uint8_t*>(buf);
  while (n > 0) {
    ssize_t w = ::write(fd, p, n);
    if (w <= 0) return false;
    p += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

// Deliver one already-encoded frame to a subscriber (frame interleaving
// guarded by the per-socket mutex; fd may have been invalidated by the
// owner's close — never write to a recycled descriptor).
bool send_frame(const std::shared_ptr<Conn>& c, const std::vector<uint8_t>& frame) {
  std::lock_guard<std::mutex> lk(c->write_mu);
  if (c->fd < 0) return false;
  return write_all(c->fd, frame.data(), frame.size());
}

void drop_conn(const std::shared_ptr<Conn>& c) {
  std::lock_guard<std::mutex> lk(g_mu);
  for (auto& [topic, subs] : g_subs) subs.erase(c);
}

void serve(std::shared_ptr<Conn> c) {
  for (;;) {
    uint32_t len_be;
    if (!read_exact(c->fd, &len_be, 4)) break;
    uint32_t len = ntohl(len_be);
    if (len < 3 || len > kMaxFrame) break;
    std::vector<uint8_t> body(len);
    if (!read_exact(c->fd, body.data(), len)) break;
    uint8_t verb = body[0];
    uint16_t tlen = static_cast<uint16_t>((body[1] << 8) | body[2]);
    if (static_cast<size_t>(3 + tlen) > body.size()) break;
    std::string topic(reinterpret_cast<char*>(body.data()) + 3, tlen);

    if (verb == kVerbSub) {
      std::lock_guard<std::mutex> lk(g_mu);
      g_subs[topic].insert(c);
    } else if (verb == kVerbPub) {
      // re-frame as a DELIVER with identical topic/payload
      std::vector<uint8_t> frame(4 + body.size());
      uint32_t out_be = htonl(static_cast<uint32_t>(body.size()));
      std::memcpy(frame.data(), &out_be, 4);
      std::memcpy(frame.data() + 4, body.data(), body.size());
      frame[4] = kVerbMsg;
      std::vector<std::shared_ptr<Conn>> targets;
      {
        std::lock_guard<std::mutex> lk(g_mu);
        auto it = g_subs.find(topic);
        if (it != g_subs.end())
          targets.assign(it->second.begin(), it->second.end());
      }
      for (auto& t : targets) {
        if (!send_frame(t, frame)) drop_conn(t);
      }
    }
    // unknown verbs are ignored (forward compatibility)
  }
  drop_conn(c);
  // invalidate under the write mutex so a publisher mid-fan-out can't
  // write to a recycled fd number
  {
    std::lock_guard<std::mutex> lk(c->write_mu);
    ::shutdown(c->fd, SHUT_RDWR);
    ::close(c->fd);
    c->fd = -1;
  }
}

}  // namespace

int main(int argc, char** argv) {
  int port = argc > 1 ? std::atoi(argv[1]) : 0;
  int srv = ::socket(AF_INET, SOCK_STREAM, 0);
  if (srv < 0) return 1;
  int one = 1;
  ::setsockopt(srv, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(srv, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) return 2;
  if (::listen(srv, 128) != 0) return 3;
  socklen_t alen = sizeof(addr);
  ::getsockname(srv, reinterpret_cast<sockaddr*>(&addr), &alen);
  std::printf("LISTENING %d\n", ntohs(addr.sin_port));
  std::fflush(stdout);
  for (;;) {
    int fd = ::accept(srv, nullptr, nullptr);
    if (fd < 0) continue;
    ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    std::thread(serve, std::make_shared<Conn>(fd)).detach();
  }
}
