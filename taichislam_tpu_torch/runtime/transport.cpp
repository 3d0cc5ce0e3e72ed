// Native UDP-multicast transport speaking the LCM UDPM wire protocol.
//
// This is the data plane of the multi-drone comm layer
// (taichislam_tpu_torch/utils/comm.py), a copy of the JAX package's
// taichislam_tpu/runtime/transport.cpp. TaichiSLAM links the native LCM C
// library for the same job (taichi_slam/utils/communication.py imports lcm);
// here the native side is self-contained: multicast join,
// short (LC02) and fragmented (LC03) datagrams, background receive thread
// with reassembly, and a poll API surfaced to Python over ctypes
// (taichislam_tpu_torch/runtime/__init__.py). Wire-compatible with real LCM peers.
//
// Build: taichislam_tpu_torch/runtime/__init__.py runs g++ at first use
// (-O2 -shared -fPIC -std=c++17 -pthread) into build/runtime/.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <tuple>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kMagicShort = 0x4C433032;  // "LC02"
constexpr uint32_t kMagicFrag = 0x4C433033;   // "LC03"
constexpr size_t kMaxDatagram = 65499;
constexpr size_t kFragSize = 60000;

uint32_t rd32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}
uint16_t rd16(const uint8_t* p) {
  return (uint16_t(p[0]) << 8) | uint16_t(p[1]);
}
void wr32(std::vector<uint8_t>& b, uint32_t v) {
  b.push_back(v >> 24); b.push_back(v >> 16); b.push_back(v >> 8);
  b.push_back(v);
}
void wr16(std::vector<uint8_t>& b, uint16_t v) {
  b.push_back(v >> 8); b.push_back(v);
}

struct Message {
  std::string channel;
  std::vector<uint8_t> data;
};

struct FragKey {
  uint32_t addr;
  uint16_t port;
  uint32_t seq;
  bool operator<(const FragKey& o) const {
    return std::tie(addr, port, seq) < std::tie(o.addr, o.port, o.seq);
  }
};

struct FragState {
  std::string channel;
  uint32_t total = 0;
  uint16_t nfrag = 0;
  std::map<uint32_t, std::vector<uint8_t>> parts;
  std::chrono::steady_clock::time_point t0;
};

// partial-reassembly bounds: lost fragments (or non-first fragments whose
// header packet never arrived) must not grow frags_ forever on a lossy
// network — real LCM caps its fragment buffers the same way
constexpr auto kFragTtl = std::chrono::seconds(5);
constexpr size_t kFragMaxEntries = 64;

class Transport {
 public:
  Transport(const char* addr, int port, int ttl) {
    fd_ = socket(AF_INET, SOCK_DGRAM, 0);
    int one = 1;
    setsockopt(fd_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
#ifdef SO_REUSEPORT
    setsockopt(fd_, SOL_SOCKET, SO_REUSEPORT, &one, sizeof(one));
#endif
    int rcvbuf = 8 * 1024 * 1024;
    setsockopt(fd_, SOL_SOCKET, SO_RCVBUF, &rcvbuf, sizeof(rcvbuf));

    sockaddr_in bind_addr{};
    bind_addr.sin_family = AF_INET;
    bind_addr.sin_addr.s_addr = htonl(INADDR_ANY);
    bind_addr.sin_port = htons(port);
    ok_ = bind(fd_, (sockaddr*)&bind_addr, sizeof(bind_addr)) == 0;

    ip_mreq mreq{};
    inet_pton(AF_INET, addr, &mreq.imr_multiaddr);
    mreq.imr_interface.s_addr = htonl(INADDR_ANY);
    setsockopt(fd_, IPPROTO_IP, IP_ADD_MEMBERSHIP, &mreq, sizeof(mreq));
    unsigned char t = (unsigned char)ttl, loop = 1;
    setsockopt(fd_, IPPROTO_IP, IP_MULTICAST_TTL, &t, sizeof(t));
    setsockopt(fd_, IPPROTO_IP, IP_MULTICAST_LOOP, &loop, sizeof(loop));

    memset(&dest_, 0, sizeof(dest_));
    dest_.sin_family = AF_INET;
    inet_pton(AF_INET, addr, &dest_.sin_addr);
    dest_.sin_port = htons(port);

    running_ = true;
    rx_thread_ = std::thread([this] { RxLoop(); });
  }

  ~Transport() {
    running_ = false;
    shutdown(fd_, SHUT_RDWR);
    close(fd_);
    if (rx_thread_.joinable()) rx_thread_.join();
  }

  bool ok() const { return ok_; }

  int Publish(const char* channel, const uint8_t* data, size_t len) {
    std::string chan(channel);
    uint32_t seq = seq_++;
    if (chan.size() + 1 + len + 8 <= kMaxDatagram) {
      std::vector<uint8_t> pkt;
      pkt.reserve(8 + chan.size() + 1 + len);
      wr32(pkt, kMagicShort);
      wr32(pkt, seq);
      pkt.insert(pkt.end(), chan.begin(), chan.end());
      pkt.push_back(0);
      pkt.insert(pkt.end(), data, data + len);
      return Send(pkt);
    }
    size_t nfrag = (len + kFragSize - 1) / kFragSize;
    for (size_t f = 0; f < nfrag; f++) {
      size_t off = f * kFragSize;
      size_t n = std::min(kFragSize, len - off);
      std::vector<uint8_t> pkt;
      wr32(pkt, kMagicFrag);
      wr32(pkt, seq);
      wr32(pkt, (uint32_t)len);
      wr32(pkt, (uint32_t)off);
      wr16(pkt, (uint16_t)f);
      wr16(pkt, (uint16_t)nfrag);
      if (f == 0) {
        pkt.insert(pkt.end(), chan.begin(), chan.end());
        pkt.push_back(0);
      }
      pkt.insert(pkt.end(), data + off, data + off + n);
      if (Send(pkt) != 0) return -1;
    }
    return 0;
  }

  // Blocks up to timeout_ms for one complete message. Returns payload size
  // (>= 0) or -1 on timeout. Channel + payload copied into caller buffers.
  long Poll(int timeout_ms, char* channel_out, size_t channel_cap,
            uint8_t* data_out, size_t data_cap) {
    std::unique_lock<std::mutex> lk(mu_);
    if (!cv_.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                      [this] { return !queue_.empty() || !running_; }))
      return -1;
    if (queue_.empty()) return -1;
    Message m = std::move(queue_.front());
    queue_.pop_front();
    lk.unlock();
    strncpy(channel_out, m.channel.c_str(), channel_cap - 1);
    channel_out[channel_cap - 1] = 0;
    size_t n = std::min(m.data.size(), data_cap);
    memcpy(data_out, m.data.data(), n);
    return (long)m.data.size();
  }

 private:
  int Send(const std::vector<uint8_t>& pkt) {
    ssize_t n = sendto(fd_, pkt.data(), pkt.size(), 0, (sockaddr*)&dest_,
                       sizeof(dest_));
    return n == (ssize_t)pkt.size() ? 0 : -1;
  }

  void RxLoop() {
    std::vector<uint8_t> buf(65536);
    while (running_) {
      sockaddr_in src{};
      socklen_t slen = sizeof(src);
      ssize_t n = recvfrom(fd_, buf.data(), buf.size(), 0, (sockaddr*)&src,
                           &slen);
      if (n <= 8) continue;
      HandlePacket(buf.data(), (size_t)n, src);
    }
  }

  void HandlePacket(const uint8_t* p, size_t n, const sockaddr_in& src) {
    uint32_t magic = rd32(p);
    if (magic == kMagicShort) {
      const uint8_t* c = p + 8;
      const uint8_t* end = p + n;
      const uint8_t* z = (const uint8_t*)memchr(c, 0, end - c);
      if (!z) return;
      Deliver({std::string((const char*)c, z - c),
               std::vector<uint8_t>(z + 1, end)});
    } else if (magic == kMagicFrag && n >= 20) {
      uint32_t seq = rd32(p + 4), total = rd32(p + 8), off = rd32(p + 12);
      uint16_t fno = rd16(p + 16), nfrag = rd16(p + 18);
      const uint8_t* body = p + 20;
      size_t blen = n - 20;
      FragKey key{src.sin_addr.s_addr, src.sin_port, seq};
      std::lock_guard<std::mutex> lk(frag_mu_);
      ExpireFragsLocked();
      if (fno == 0) {
        const uint8_t* z = (const uint8_t*)memchr(body, 0, blen);
        if (!z) return;
        FragState st;
        st.channel.assign((const char*)body, z - body);
        st.total = total;
        st.nfrag = nfrag;
        st.t0 = std::chrono::steady_clock::now();
        frags_[key] = std::move(st);
        body = z + 1;
        blen = n - 20 - (body - (p + 20));
      }
      auto it = frags_.find(key);
      if (it == frags_.end()) return;
      it->second.parts[off] = std::vector<uint8_t>(body, body + blen);
      if (it->second.parts.size() == it->second.nfrag) {
        std::vector<uint8_t> data;
        data.reserve(it->second.total);
        for (auto& kv : it->second.parts)
          data.insert(data.end(), kv.second.begin(), kv.second.end());
        std::string chan = it->second.channel;
        uint32_t total_expected = it->second.total;
        frags_.erase(it);
        if (data.size() == total_expected)
          Deliver({std::move(chan), std::move(data)});
      }
    }
  }

  // caller holds frag_mu_
  void ExpireFragsLocked() {
    auto now = std::chrono::steady_clock::now();
    for (auto it = frags_.begin(); it != frags_.end();) {
      if (now - it->second.t0 > kFragTtl)
        it = frags_.erase(it);
      else
        ++it;
    }
    while (frags_.size() > kFragMaxEntries) {
      auto oldest = frags_.begin();
      for (auto it = frags_.begin(); it != frags_.end(); ++it)
        if (it->second.t0 < oldest->second.t0) oldest = it;
      frags_.erase(oldest);
    }
  }

  void Deliver(Message m) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      queue_.push_back(std::move(m));
      while (queue_.size() > 256) queue_.pop_front();
    }
    cv_.notify_one();
  }

  int fd_ = -1;
  bool ok_ = false;
  sockaddr_in dest_{};
  std::atomic<uint32_t> seq_{0};
  std::atomic<bool> running_{false};
  std::thread rx_thread_;
  std::mutex mu_;
  std::condition_variable cv_;
  std::deque<Message> queue_;
  std::mutex frag_mu_;
  std::map<FragKey, FragState> frags_;
};

}  // namespace

extern "C" {

void* tslam_transport_create(const char* addr, int port, int ttl) {
  auto* t = new Transport(addr, port, ttl);
  if (!t->ok()) {
    delete t;
    return nullptr;
  }
  return t;
}

void tslam_transport_destroy(void* h) { delete (Transport*)h; }

int tslam_transport_publish(void* h, const char* channel,
                            const uint8_t* data, size_t len) {
  return ((Transport*)h)->Publish(channel, data, len);
}

long tslam_transport_poll(void* h, int timeout_ms, char* channel_out,
                          size_t channel_cap, uint8_t* data_out,
                          size_t data_cap) {
  return ((Transport*)h)->Poll(timeout_ms, channel_out, channel_cap,
                               data_out, data_cap);
}

}  // extern "C"
