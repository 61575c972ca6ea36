// rtp_edge — native host-edge RTP packetizer for the TPU radiod.
//
// The reference's audio.c runs one send_output per channel per block in its
// demod thread. Our host edge is a single Python loop; at 1000+ channels x
// 50 blocks/s the per-channel numpy conversion + sendto() syscalls dominate
// host CPU. This module packetizes an entire [C, N] block of float audio in
// one call — PCM conversion (s16be / f32be / G.711 mu-law / A-law), RTP
// header assembly (wire format per rtp.c hton_rtp), and one sendmmsg(2)
// batch for all channels — updating per-channel seq/timestamp in place.
//
// Build: g++ -O3 -shared -fPIC rtp_edge.cpp -o librtp_edge.so (see edge.py)

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cerrno>
#include <cstring>
#include <cmath>
#include <mutex>
#include <thread>
#include <vector>

#include <dlfcn.h>
#include <unordered_map>

#include <sys/socket.h>
#include <netinet/in.h>
#include <netinet/ip.h>
#include <poll.h>
#include <arpa/inet.h>
#include <unistd.h>

namespace {

constexpr int MAX_PAYLOAD = 1408;  // samples bytes per packet (under MTU)

struct Packet {
  uint8_t buf[12 + MAX_PAYLOAD];
  size_t len;
};

inline void put_rtp_header(uint8_t *b, uint8_t pt, bool marker, uint16_t seq,
                           uint32_t ts, uint32_t ssrc) {
  b[0] = 0x80;  // V=2, no pad/ext/csrc
  b[1] = (pt & 0x7f) | (marker ? 0x80 : 0);
  b[2] = seq >> 8;
  b[3] = seq & 0xff;
  b[4] = ts >> 24; b[5] = ts >> 16; b[6] = ts >> 8; b[7] = ts;
  b[8] = ssrc >> 24; b[9] = ssrc >> 16; b[10] = ssrc >> 8; b[11] = ssrc;
}

inline int16_t f2s16(float x) {
  float v = x * 32767.0f;
  if (v > 32767.0f) v = 32767.0f;
  if (v < -32768.0f) v = -32768.0f;
  return (int16_t)lrintf(v);
}

inline uint8_t mulaw(float x) {
  const int BIAS = 0x84, CLIP = 32635;
  int s = (int)lrintf(x * 32767.0f);
  int sign = 0;
  if (s < 0) { s = -s; sign = 0x80; }
  if (s > CLIP) s = CLIP;
  s += BIAS;
  int exp = 7;
  for (int m = 0x4000; (s & m) == 0 && exp > 0; exp--, m >>= 1) {}
  int mant = (s >> (exp + 3)) & 0x0f;
  return (uint8_t)~(sign | (exp << 4) | mant);
}

inline uint8_t alaw(float x) {
  int s = (int)lrintf(x * 32767.0f);
  int sign = 0;
  if (s < 0) { s = -s; sign = 0x80; }
  if (s > 32635) s = 32635;
  int exp = 7;
  for (int m = 0x4000; (s & m) == 0 && exp > 0; exp--, m >>= 1) {}
  int mant = (exp == 0) ? (s >> 4) & 0x0f : (s >> (exp + 3)) & 0x0f;
  return (uint8_t)((sign | (exp << 4) | mant) ^ 0xD5);
}

// encoding codes match net/rtp.py Encoding
enum { E_S16LE = 1, E_S16BE = 2, E_OPUS = 3, E_F32LE = 4, E_F16LE = 6,
       E_OPUS_VOIP = 7, E_F32BE = 8, E_F16BE = 9, E_MULAW = 10, E_ALAW = 11 };

// ---- Opus via dlopen("libopus.so.0") — headers absent in this image, the
// runtime library is not; the ABI is stable public API ----
struct OpusEncoderS;  // opaque
typedef OpusEncoderS *(*opus_create_t)(int32_t, int, int, int *);
typedef int32_t (*opus_encode_float_t)(OpusEncoderS *, const float *, int,
                                       unsigned char *, int32_t);
typedef void (*opus_destroy_t)(OpusEncoderS *);
typedef int (*opus_ctl_t)(OpusEncoderS *, int, ...);

struct OpusApi {
  void *dl = nullptr;
  opus_create_t create = nullptr;
  opus_encode_float_t encode = nullptr;
  opus_destroy_t destroy = nullptr;
  opus_ctl_t ctl = nullptr;
  bool ok() const { return create && encode && destroy && ctl; }
};

OpusApi &opus_api() {
  static OpusApi api = [] {
    OpusApi a;
    a.dl = dlopen("libopus.so.0", RTLD_NOW | RTLD_GLOBAL);
    if (a.dl) {
      a.create = (opus_create_t)dlsym(a.dl, "opus_encoder_create");
      a.encode = (opus_encode_float_t)dlsym(a.dl, "opus_encode_float");
      a.destroy = (opus_destroy_t)dlsym(a.dl, "opus_encoder_destroy");
      a.ctl = (opus_ctl_t)dlsym(a.dl, "opus_encoder_ctl");
    }
    return a;
  }();
  return api;
}

struct OpusSlot {
  OpusEncoderS *enc = nullptr;
  int samprate = 0;
  int nch = 0;
  int app = 0;      // OPUS_APPLICATION value (0 = derive from encoding)
  int bitrate = -1; // applied OPUS_SET_BITRATE (-1 = untouched)
  int dtx = -1;     // applied OPUS_SET_DTX
};
// per-(socket, channel) encoder states; freed by rtp_edge_close.
// Opus_mu guards map STRUCTURE (find/insert/erase — references stay
// valid across rehash, so the parallel encode phase reads lock-free).
std::mutex Opus_mu;
std::unordered_map<uint64_t, OpusSlot> Opus_slots;

inline uint64_t slot_key(int fd, int chan) {
  return ((uint64_t)(uint32_t)fd << 32) | (uint32_t)chan;
}

inline OpusSlot &opus_slot(int fd, int chan) {
  std::lock_guard<std::mutex> g(Opus_mu);
  return Opus_slots[slot_key(fd, chan)];
}
// per-socket data destination (sockets are UNCONNECTED so audio and the
// status-port beacons share one source port — stock ka9q clients match
// data<->status sessions on it, pcmrecord.c process_status).
// Edge_mu guards the map against an edge socket opened or closed on
// another thread while the daemon sends its block.
std::mutex Edge_mu;
std::unordered_map<int, sockaddr_in> Edge_dest;

inline bool edge_dest_of(int fd, sockaddr_in *out) {
  std::lock_guard<std::mutex> g(Edge_mu);
  auto it = Edge_dest.find(fd);
  if (it == Edge_dest.end()) return false;
  *out = it->second;
  return true;
}

size_t sample_bytes(int enc) {
  switch (enc) {
    case E_MULAW: case E_ALAW: return 1;
    case E_S16LE: case E_S16BE: case E_F16LE: case E_F16BE: return 2;
    default: return 4;
  }
}

inline uint16_t f2h(float f) {  // float32 -> IEEE half, round to nearest even
  uint32_t x; memcpy(&x, &f, 4);
  uint32_t sign = (x >> 16) & 0x8000;
  int32_t exp = (int32_t)((x >> 23) & 0xff) - 127 + 15;
  uint32_t mant = x & 0x7fffff;
  if (exp <= 0) return (uint16_t)sign;                       // flush to zero
  if (exp >= 31) return (uint16_t)(sign | 0x7c00);           // inf/overflow
  uint32_t h = (uint32_t)(exp << 10) | (mant >> 13);
  uint32_t rem = mant & 0x1fff;
  if (rem > 0x1000 || (rem == 0x1000 && (h & 1))) h++;       // may carry into exp
  return (uint16_t)(sign | h);
}

size_t encode(const float *src, size_t n, int enc, uint8_t *dst) {
  switch (enc) {
    case E_S16BE:
      for (size_t i = 0; i < n; i++) { int16_t v = f2s16(src[i]); dst[2*i] = v >> 8; dst[2*i+1] = v & 0xff; }
      return 2 * n;
    case E_S16LE:
      for (size_t i = 0; i < n; i++) { int16_t v = f2s16(src[i]); dst[2*i] = v & 0xff; dst[2*i+1] = (uint16_t)v >> 8; }
      return 2 * n;
    case E_MULAW:
      for (size_t i = 0; i < n; i++) dst[i] = mulaw(src[i]);
      return n;
    case E_ALAW:
      for (size_t i = 0; i < n; i++) dst[i] = alaw(src[i]);
      return n;
    case E_F16LE:
      for (size_t i = 0; i < n; i++) { uint16_t h = f2h(src[i]); dst[2*i] = h & 0xff; dst[2*i+1] = h >> 8; }
      return 2 * n;
    case E_F16BE:
      for (size_t i = 0; i < n; i++) { uint16_t h = f2h(src[i]); dst[2*i] = h >> 8; dst[2*i+1] = h & 0xff; }
      return 2 * n;
    case E_F32BE:
      for (size_t i = 0; i < n; i++) {
        uint32_t v; memcpy(&v, &src[i], 4);
        dst[4*i] = v >> 24; dst[4*i+1] = v >> 16; dst[4*i+2] = v >> 8; dst[4*i+3] = v;
      }
      return 4 * n;
    default:  // F32LE
      memcpy(dst, src, 4 * n);
      return 4 * n;
  }
}

}  // namespace

extern "C" {

// UDP sender socket connected to ip:port; multicast TTL + loopback set.
int rtp_edge_open(const char *ip, int port, int ttl, int tos) {
  int fd = socket(AF_INET, SOCK_DGRAM, 0);
  if (fd < 0) return -1;
  if (tos) setsockopt(fd, IPPROTO_IP, IP_TOS, &tos, sizeof tos);
  sockaddr_in sa{};
  sa.sin_family = AF_INET;
  sa.sin_port = htons((uint16_t)port);
  if (inet_pton(AF_INET, ip, &sa.sin_addr) != 1) { close(fd); return -2; }
  uint32_t a = ntohl(sa.sin_addr.s_addr);
  if (a >= 0xE0000000u && a < 0xF0000000u) {
    unsigned char t = (unsigned char)(ttl < 0 ? 0 : ttl);
    setsockopt(fd, IPPROTO_IP, IP_MULTICAST_TTL, &t, sizeof t);
    unsigned char loop = 1;
    setsockopt(fd, IPPROTO_IP, IP_MULTICAST_LOOP, &loop, sizeof loop);
  }
  int sz = 4 << 20;
  setsockopt(fd, SOL_SOCKET, SO_SNDBUF, &sz, sizeof sz);
  {
    std::lock_guard<std::mutex> g(Edge_mu);
    Edge_dest[fd] = sa;  // unconnected: sendmmsg carries the address
  }
  return fd;
}

// Send one control/status packet from the SAME socket (and source port)
// as the audio, to the data group's `port` (the beacon path).
int rtp_edge_send_ctl(int fd, const uint8_t *buf, int len, int port) {
  sockaddr_in dst{};
  if (!edge_dest_of(fd, &dst)) return -1;
  dst.sin_port = htons((uint16_t)port);
  ssize_t r = sendto(fd, buf, (size_t)len, 0, (sockaddr *)&dst, sizeof dst);
  return r < 0 ? -1 : (int)r;
}

void rtp_edge_close(int fd) {
  {
    std::lock_guard<std::mutex> g(Opus_mu);
    for (auto it = Opus_slots.begin(); it != Opus_slots.end();) {
      if ((int)(it->first >> 32) == fd) {
        if (it->second.enc) opus_api().destroy(it->second.enc);
        it = Opus_slots.erase(it);
      } else {
        ++it;
      }
    }
  }
  {
    std::lock_guard<std::mutex> g(Edge_mu);
    Edge_dest.erase(fd);
  }
  close(fd);
}

int rtp_edge_has_opus(void) { return opus_api().ok() ? 1 : 0; }

// Packetize + send one block of audio for C channels.
//   audio: [C, nframes * nch] float32 (interleaved if nch=2)
//   send/marker flags, ssrc/pt/encoding/samprate per channel; seq/ts updated
//   in place. ts advances by nframes even for muted channels (audio.c
//   semantics); Opus timestamps tick at 48 kHz regardless of samprate.
// Returns packets sent, or -errno on socket failure.
int rtp_edge_send_block(int fd, const float *audio, int nchan, int nframes,
                        int nch, const uint8_t *send_flag, const uint32_t *ssrc,
                        const uint8_t *pt, const int32_t *encoding,
                        const int32_t *samprate,
                        const int32_t *opus_bitrate, const uint8_t *opus_dtx,
                        const int32_t *opus_app,
                        uint16_t *seq, uint32_t *ts, const uint8_t *marker) {
  std::vector<Packet> pkts;
  pkts.reserve((size_t)nchan * 2);

  // ---- Opus channels: slot management serial, ENCODE IN PARALLEL ----
  // libopus encode is ~0.15 ms/channel: serial tops out near 120 real-time
  // channels, so the per-channel encodes (independent encoder states) fan
  // out over a thread pool — the edge analog of the reference's
  // demod-thread-per-channel encode (audio.c runs in each channel thread).
  std::vector<int> opus_jobs;
  for (int c = 0; c < nchan; c++) {
    bool is_opus = encoding[c] == E_OPUS || encoding[c] == E_OPUS_VOIP;
    if (!is_opus)
      continue;
    uint32_t ts_inc = samprate[c] > 0
                          ? (uint32_t)((int64_t)nframes * 48000 / samprate[c])
                          : (uint32_t)nframes;
    if (!send_flag[c]) {
      ts[c] += ts_inc;
      continue;
    }
    OpusApi &api = opus_api();
    if (!api.ok()) { ts[c] += ts_inc; continue; }
    OpusSlot &slot = opus_slot(fd, c);
    int want_app = opus_app[c] ? opus_app[c]
                               : (encoding[c] == E_OPUS_VOIP ? 2048 : 2049);
    if (slot.enc == nullptr || slot.samprate != samprate[c] ||
        slot.nch != nch || slot.app != want_app) {
      if (slot.enc) api.destroy(slot.enc);
      int err = 0;
      slot.enc = api.create(samprate[c], nch, want_app, &err);
      slot.samprate = samprate[c];
      slot.nch = nch;
      slot.app = want_app;
      slot.bitrate = slot.dtx = -1;
      if (err != 0 || slot.enc == nullptr) { slot.enc = nullptr; ts[c] += ts_inc; continue; }
    }
    if (slot.bitrate != opus_bitrate[c]) {  // OPUS_SET_BITRATE=4002; 0 -> AUTO
      api.ctl(slot.enc, 4002, (int32_t)(opus_bitrate[c] > 0 ? opus_bitrate[c] : -1000));
      slot.bitrate = opus_bitrate[c];
    }
    if (slot.dtx != (int)opus_dtx[c]) {  // OPUS_SET_DTX=4016
      api.ctl(slot.enc, 4016, (int32_t)opus_dtx[c]);
      slot.dtx = (int)opus_dtx[c];
    }
    opus_jobs.push_back(c);
  }
  std::vector<Packet> opus_pkts(opus_jobs.size());
  if (!opus_jobs.empty()) {
    OpusApi &api = opus_api();
    unsigned nthreads = std::thread::hardware_concurrency();
    if (nthreads == 0) nthreads = 2;
    if (nthreads > opus_jobs.size()) nthreads = (unsigned)opus_jobs.size();
    auto worker = [&](unsigned w) {
      for (size_t j = w; j < opus_jobs.size(); j += nthreads) {
        int c = opus_jobs[j];
        // read-only find (operator[] could insert -> data race); phase 1
        // guaranteed the slot exists for every job
        OpusSlot &slot = opus_slot(fd, c);
        Packet &p = opus_pkts[j];
        const float *src = audio + (size_t)c * nframes * nch;
        int32_t r = api.encode(slot.enc, src, nframes, p.buf + 12, MAX_PAYLOAD);
        p.len = r > 0 ? 12 + (size_t)r : 0;
      }
    };
    if (nthreads <= 1) {
      worker(0);
    } else {
      std::vector<std::thread> threads;
      for (unsigned w = 1; w < nthreads; w++) threads.emplace_back(worker, w);
      worker(0);
      for (auto &t : threads) t.join();
    }
    for (size_t j = 0; j < opus_jobs.size(); j++) {
      int c = opus_jobs[j];
      uint32_t ts_inc = samprate[c] > 0
                            ? (uint32_t)((int64_t)nframes * 48000 / samprate[c])
                            : (uint32_t)nframes;
      if (opus_pkts[j].len == 0) { ts[c] += ts_inc; continue; }
      put_rtp_header(opus_pkts[j].buf, pt[c], marker[c], seq[c], ts[c], ssrc[c]);
      seq[c] = (uint16_t)(seq[c] + 1);
      ts[c] += ts_inc;
      pkts.push_back(opus_pkts[j]);
    }
  }

  for (int c = 0; c < nchan; c++) {
    bool is_opus = encoding[c] == E_OPUS || encoding[c] == E_OPUS_VOIP;
    if (is_opus)
      continue;  // handled above
    uint32_t ts_inc = (uint32_t)nframes;
    if (!send_flag[c]) {
      ts[c] += ts_inc;
      continue;
    }
    size_t bytes_per_frame = sample_bytes(encoding[c]) * (size_t)nch;
    int frames_per_pkt = (int)(MAX_PAYLOAD / bytes_per_frame);
    if (frames_per_pkt < 1) frames_per_pkt = 1;
    const float *src = audio + (size_t)c * nframes * nch;
    for (int off = 0; off < nframes; off += frames_per_pkt) {
      int n = nframes - off;
      if (n > frames_per_pkt) n = frames_per_pkt;
      pkts.emplace_back();
      Packet &p = pkts.back();
      put_rtp_header(p.buf, pt[c], marker[c] && off == 0, seq[c], ts[c], ssrc[c]);
      size_t plen = encode(src + (size_t)off * nch, (size_t)n * nch, encoding[c], p.buf + 12);
      p.len = 12 + plen;
      seq[c] = (uint16_t)(seq[c] + 1);
      ts[c] += (uint32_t)n;
    }
  }
  if (pkts.empty()) return 0;

  static thread_local sockaddr_in dst;
  if (!edge_dest_of(fd, &dst)) return -1;
  std::vector<mmsghdr> hdrs(pkts.size());
  std::vector<iovec> iovs(pkts.size());
  for (size_t i = 0; i < pkts.size(); i++) {
    iovs[i] = {pkts[i].buf, pkts[i].len};
    std::memset(&hdrs[i], 0, sizeof(mmsghdr));
    hdrs[i].msg_hdr.msg_iov = &iovs[i];
    hdrs[i].msg_hdr.msg_iovlen = 1;
    hdrs[i].msg_hdr.msg_name = (void *)&dst;
    hdrs[i].msg_hdr.msg_namelen = sizeof(sockaddr_in);
  }
  size_t done = 0;
  while (done < hdrs.size()) {
    int r = sendmmsg(fd, hdrs.data() + done, (unsigned)(hdrs.size() - done), 0);
    if (r <= 0) return -(int)done;  // partial send; caller may count
    done += (size_t)r;
  }
  return (int)pkts.size();
}

// Compacted-egress variant: audio holds only the OPEN channels' rows
// (device-side squelch gather, audio.c:42-110 analog); chan_idx[i] maps
// audio row i -> channel index. Timestamps advance for every channel
// (muted included); only listed rows packetize. PCM encodings only.
int rtp_edge_send_indexed(int fd, const float *audio, int nactive,
                          int nchan_total, int nframes, int nch,
                          const int32_t *chan_idx, const uint32_t *ssrc,
                          const uint8_t *pt, const int32_t *encoding,
                          uint16_t *seq, uint32_t *ts, const uint8_t *marker) {
  std::vector<Packet> pkts;
  pkts.reserve((size_t)nactive * 2);
  static thread_local std::vector<uint8_t> active;
  active.assign((size_t)nchan_total, 0);
  for (int i = 0; i < nactive; i++) {
    int c = chan_idx[i];
    if (c < 0 || c >= nchan_total) continue;
    active[(size_t)c] = 1;
    size_t bytes_per_frame = sample_bytes(encoding[c]) * (size_t)nch;
    int frames_per_pkt = (int)(MAX_PAYLOAD / bytes_per_frame);
    if (frames_per_pkt < 1) frames_per_pkt = 1;
    const float *src = audio + (size_t)i * nframes * nch;  // row i, not c
    for (int off = 0; off < nframes; off += frames_per_pkt) {
      int n = nframes - off;
      if (n > frames_per_pkt) n = frames_per_pkt;
      pkts.emplace_back();
      Packet &p = pkts.back();
      put_rtp_header(p.buf, pt[c], marker[c] && off == 0, seq[c], ts[c], ssrc[c]);
      size_t plen = encode(src + (size_t)off * nch, (size_t)n * nch, encoding[c], p.buf + 12);
      p.len = 12 + plen;
      seq[c] = (uint16_t)(seq[c] + 1);
      ts[c] += (uint32_t)n;
    }
  }
  for (int c = 0; c < nchan_total; c++)
    if (!active[(size_t)c]) ts[c] += (uint32_t)nframes;
  if (pkts.empty()) return 0;
  static thread_local sockaddr_in dst2;
  if (!edge_dest_of(fd, &dst2)) return -1;
  std::vector<mmsghdr> hdrs(pkts.size());
  std::vector<iovec> iovs(pkts.size());
  for (size_t i = 0; i < pkts.size(); i++) {
    iovs[i] = {pkts[i].buf, pkts[i].len};
    std::memset(&hdrs[i], 0, sizeof(mmsghdr));
    hdrs[i].msg_hdr.msg_iov = &iovs[i];
    hdrs[i].msg_hdr.msg_iovlen = 1;
    hdrs[i].msg_hdr.msg_name = (void *)&dst2;
    hdrs[i].msg_hdr.msg_namelen = sizeof(sockaddr_in);
  }
  size_t done = 0;
  while (done < hdrs.size()) {
    int r = sendmmsg(fd, hdrs.data() + done, (unsigned)(hdrs.size() - done), 0);
    if (r <= 0) return -(int)done;
    done += (size_t)r;
  }
  return (int)pkts.size();
}

}  // extern "C"

// ===========================================================================
// rtp_ingest — native at-rate A/D ingest (the recv side of the edge).
//
// The reference's front end writes 129.6 Msps straight from the USB
// completion callback into the shared FFT ring (rx888.c:668-744, async
// transfer ring of queuedepth x reqsize). Our wire analog is an RTP
// stream from the SDR host; one Python recvfrom + np.concatenate per
// packet (runtime/frontends.py RtpSource) is structurally incapable of
// the ~185k pkts/s that rate means. This reader is the native
// equivalent of the rx_callback path:
//
//   reader thread: recvmmsg() batches -> inline RTP header parse ->
//   vectorized payload->f32 conversion straight into a preallocated
//   SPSC float ring (the mirror-buffer analog), RTP timestamp gaps
//   zero-filled, dup/old packets dropped, loss/overrun accounting.
//
//   consumer (the daemon's read_block): blocking ring read with
//   timeout; starvation zero-fills so the engine keeps cadence,
//   exactly like the Python fallback.
//
// A paced native sender (rtp_ingest_blast) is the loopback at-rate bench
// peer: pcmsend semantics (s16be payloads, seq/ts per packet) at a target
// frames/s without Python in the packet loop.
// ===========================================================================

namespace {

struct Ingest {
  int fd = -1;
  int enc = E_S16BE;
  int width = 1;      // floats per frame (1 real, 2 complex I/Q)
  uint32_t ssrc = 0;  // 0 = lock onto the first SSRC seen
  bool locked = false;
  // SPSC float ring: producer = reader thread, consumer = read().
  // Monotonic 64-bit positions (in floats); capacity a power of two.
  std::vector<float> ring;
  size_t cap = 0;
  std::atomic<uint64_t> wr{0};
  std::atomic<uint64_t> rd{0};
  std::mutex m;
  std::condition_variable cv;
  std::thread reader;
  std::atomic<bool> run{false};
  // RTP receive state (rtp.c rtp_process semantics)
  bool init = false;
  uint16_t seq = 0;
  uint32_t ts = 0;  // next expected timestamp (frames)
  // stats
  std::atomic<long long> packets{0}, bytes{0}, gap_frames{0}, dups{0},
      overrun_frames{0}, starve_frames{0}, malformed{0};
};

std::mutex Ingest_mu;
std::unordered_map<int, Ingest *> Ingests;

Ingest *ingest_of(int h) {
  std::lock_guard<std::mutex> g(Ingest_mu);
  auto it = Ingests.find(h);
  return it == Ingests.end() ? nullptr : it->second;
}

size_t ring_space(const Ingest &ig) {
  return ig.cap - (size_t)(ig.wr.load(std::memory_order_relaxed) -
                           ig.rd.load(std::memory_order_acquire));
}

// producer-side: append n floats (or zeros when src == nullptr), dropping
// the NEWEST data on overrun (consumer owns rd; never steal from it)
void ring_write(Ingest &ig, const float *src, size_t n) {
  size_t space = ring_space(ig);
  if (n > space) {
    ig.overrun_frames.fetch_add((long long)((n - space) / ig.width),
                                std::memory_order_relaxed);
    n = space;
  }
  uint64_t w = ig.wr.load(std::memory_order_relaxed);
  size_t pos = (size_t)(w & (ig.cap - 1));
  size_t first = std::min(n, ig.cap - pos);
  if (src) {
    memcpy(ig.ring.data() + pos, src, first * sizeof(float));
    if (n > first) memcpy(ig.ring.data(), src + first, (n - first) * sizeof(float));
  } else {
    memset(ig.ring.data() + pos, 0, first * sizeof(float));
    if (n > first) memset(ig.ring.data(), 0, (n - first) * sizeof(float));
  }
  ig.wr.store(w + n, std::memory_order_release);
}

// payload -> f32 frames; returns frames decoded (0 on unknown encoding)
size_t decode_payload(const uint8_t *p, size_t nbytes, int enc, int width,
                      float *dst, size_t max_floats) {
  size_t nfloats;
  switch (enc) {
    case E_S16BE: {
      nfloats = std::min(nbytes / 2, max_floats);
      constexpr float k = 1.0f / 32767.0f;
      for (size_t i = 0; i < nfloats; i++) {
        int16_t v = (int16_t)((p[2 * i] << 8) | p[2 * i + 1]);
        dst[i] = k * (float)v;
      }
      break;
    }
    case E_S16LE: {
      nfloats = std::min(nbytes / 2, max_floats);
      constexpr float k = 1.0f / 32767.0f;
      for (size_t i = 0; i < nfloats; i++) {
        int16_t v;
        memcpy(&v, p + 2 * i, 2);
        dst[i] = k * (float)v;
      }
      break;
    }
    case E_F32LE: {
      nfloats = std::min(nbytes / 4, max_floats);
      memcpy(dst, p, nfloats * 4);
      break;
    }
    case E_F32BE: {
      nfloats = std::min(nbytes / 4, max_floats);
      for (size_t i = 0; i < nfloats; i++) {
        uint32_t v = ((uint32_t)p[4 * i] << 24) | ((uint32_t)p[4 * i + 1] << 16) |
                     ((uint32_t)p[4 * i + 2] << 8) | p[4 * i + 3];
        memcpy(&dst[i], &v, 4);
      }
      break;
    }
    default:
      return 0;
  }
  return nfloats / (size_t)width;
}

void ingest_loop(Ingest *ig) {
  constexpr int BATCH = 256;
  constexpr size_t PKT_CAP = 65536;
  std::vector<uint8_t> bufs((size_t)BATCH * PKT_CAP);
  std::vector<mmsghdr> hdrs(BATCH);
  std::vector<iovec> iovs(BATCH);
  for (int i = 0; i < BATCH; i++) {
    iovs[i] = {bufs.data() + (size_t)i * PKT_CAP, PKT_CAP};
    memset(&hdrs[i], 0, sizeof(mmsghdr));
    hdrs[i].msg_hdr.msg_iov = &iovs[i];
    hdrs[i].msg_hdr.msg_iovlen = 1;
  }
  std::vector<float> scratch(PKT_CAP / 2 + 8);
  while (ig->run.load(std::memory_order_relaxed)) {
    // wait up to 100 ms for one datagram (the tick that re-checks the run
    // flag), then take all that are queued: MSG_WAITFORONE's semantics from
    // poll + MSG_DONTWAIT, since gVisor's recvmmsg refuses MSG_WAITFORONE
    // with EINVAL
    pollfd pfd{ig->fd, POLLIN, 0};
    if (poll(&pfd, 1, 100) <= 0) continue;
    int n = recvmmsg(ig->fd, hdrs.data(), BATCH, MSG_DONTWAIT, nullptr);
    if (n <= 0) continue;
    for (int i = 0; i < n; i++) {
      const uint8_t *p = bufs.data() + (size_t)i * PKT_CAP;
      size_t len = hdrs[i].msg_len;
      if (len < 12 || (p[0] >> 6) != 2) {
        ig->malformed.fetch_add(1, std::memory_order_relaxed);
        continue;
      }
      size_t off = 12 + 4u * (p[0] & 0x0f);  // skip CSRCs
      if (p[0] & 0x10) {                     // header extension
        if (len < off + 4) { ig->malformed.fetch_add(1, std::memory_order_relaxed); continue; }
        off += 4 + 4u * ((p[off + 2] << 8) | p[off + 3]);
      }
      if (len < off) { ig->malformed.fetch_add(1, std::memory_order_relaxed); continue; }
      uint32_t ssrc = ((uint32_t)p[8] << 24) | ((uint32_t)p[9] << 16) |
                      ((uint32_t)p[10] << 8) | p[11];
      if (ig->ssrc != 0 && ssrc != ig->ssrc) continue;
      if (ig->ssrc == 0) {
        if (!ig->locked) { ig->ssrc = ssrc; ig->locked = true; }
        else if (ssrc != ig->ssrc) continue;
      }
      uint16_t seq = (uint16_t)((p[2] << 8) | p[3]);
      uint32_t ts = ((uint32_t)p[4] << 24) | ((uint32_t)p[5] << 16) |
                    ((uint32_t)p[6] << 8) | p[7];
      size_t frames = decode_payload(p + off, len - off, ig->enc, ig->width,
                                     scratch.data(), scratch.size());
      ig->packets.fetch_add(1, std::memory_order_relaxed);
      ig->bytes.fetch_add((long long)len, std::memory_order_relaxed);
      if (frames == 0) continue;
      if (!ig->init) {
        ig->init = true;
        ig->seq = seq;
        ig->ts = ts;
      }
      uint16_t sd = (uint16_t)(seq - ig->seq);
      if (sd >= 0x8000) {  // old / duplicate
        ig->dups.fetch_add(1, std::memory_order_relaxed);
        continue;
      }
      int32_t tgap = (int32_t)(ts - ig->ts);  // frames lost before this pkt
      if (tgap > 0) {
        size_t fill = std::min((size_t)tgap, ig->cap / (2 * (size_t)ig->width));
        ig->gap_frames.fetch_add(tgap, std::memory_order_relaxed);
        ring_write(*ig, nullptr, fill * (size_t)ig->width);
      }
      ring_write(*ig, scratch.data(), frames * (size_t)ig->width);
      ig->seq = (uint16_t)(seq + 1);
      ig->ts = ts + (uint32_t)frames;
    }
    ig->cv.notify_one();
  }
}

}  // namespace

extern "C" {

// Open a native RTP ingest: bind ip:port (joining when multicast), start
// the reader thread. width: floats/frame (1 real, 2 complex). ssrc 0 =
// lock onto first stream seen. ring_log2: ring capacity = 2^ring_log2
// floats (e.g. 26 -> 64M floats = 256 MB, ~0.5 s at 129.6 Msps real).
// Returns a handle (the socket fd) or <0.
int rtp_ingest_open(const char *ip, int port, int encoding, int width,
                    uint32_t ssrc, int ring_log2, int rcvbuf_mb) {
  if (width < 1 || width > 2 || ring_log2 < 10 || ring_log2 > 31) return -3;
  int fd = socket(AF_INET, SOCK_DGRAM, 0);
  if (fd < 0) return -1;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
  int sz = (rcvbuf_mb > 0 ? rcvbuf_mb : 64) << 20;
  setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &sz, sizeof sz);
  sockaddr_in sa{};
  sa.sin_family = AF_INET;
  sa.sin_port = htons((uint16_t)port);
  if (inet_pton(AF_INET, ip, &sa.sin_addr) != 1) { close(fd); return -2; }
  uint32_t a = ntohl(sa.sin_addr.s_addr);
  bool mcast = a >= 0xE0000000u && a < 0xF0000000u;
  sockaddr_in bindsa = sa;
  if (!mcast && a != INADDR_ANY && a != INADDR_LOOPBACK) {
    // unicast to some other host's address: bind wildcard
    bindsa.sin_addr.s_addr = htonl(INADDR_ANY);
  }
  if (bind(fd, (sockaddr *)&bindsa, sizeof bindsa) < 0) {
    // multicast bind-to-group can fail on some stacks: retry wildcard
    bindsa.sin_addr.s_addr = htonl(INADDR_ANY);
    if (bind(fd, (sockaddr *)&bindsa, sizeof bindsa) < 0) { close(fd); return -4; }
  }
  if (mcast) {
    ip_mreq mr{};
    mr.imr_multiaddr = sa.sin_addr;
    mr.imr_interface.s_addr = htonl(INADDR_ANY);
    if (setsockopt(fd, IPPROTO_IP, IP_ADD_MEMBERSHIP, &mr, sizeof mr) < 0) {
      close(fd);
      return -5;
    }
  }
  auto *ig = new Ingest;
  ig->fd = fd;
  ig->enc = encoding;
  ig->width = width;
  ig->ssrc = ssrc;
  ig->cap = (size_t)1 << ring_log2;
  ig->ring.resize(ig->cap);
  ig->run.store(true);
  ig->reader = std::thread(ingest_loop, ig);
  {
    std::lock_guard<std::mutex> g(Ingest_mu);
    Ingests[fd] = ig;
  }
  return fd;
}

// Blocking read of nfloats into dst. Returns floats actually received;
// on timeout the remainder is zero-filled (starvation accounting) so the
// caller keeps block cadence. A return < nfloats means starvation.
long rtp_ingest_read(int h, float *dst, long nfloats, int timeout_ms) {
  Ingest *ig = ingest_of(h);
  if (!ig || nfloats < 0 || (size_t)nfloats > ig->cap) return -1;
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(timeout_ms);
  size_t have;
  for (;;) {
    have = (size_t)(ig->wr.load(std::memory_order_acquire) -
                    ig->rd.load(std::memory_order_relaxed));
    if (have >= (size_t)nfloats) break;
    std::unique_lock<std::mutex> lk(ig->m);
    if (ig->cv.wait_until(lk, deadline) == std::cv_status::timeout) {
      have = (size_t)(ig->wr.load(std::memory_order_acquire) -
                      ig->rd.load(std::memory_order_relaxed));
      break;
    }
  }
  size_t n = std::min(have, (size_t)nfloats);
  uint64_t r = ig->rd.load(std::memory_order_relaxed);
  size_t pos = (size_t)(r & (ig->cap - 1));
  size_t first = std::min(n, ig->cap - pos);
  memcpy(dst, ig->ring.data() + pos, first * sizeof(float));
  if (n > first) memcpy(dst + first, ig->ring.data(), (n - first) * sizeof(float));
  ig->rd.store(r + n, std::memory_order_release);
  if ((long)n < nfloats) {
    memset(dst + n, 0, ((size_t)nfloats - n) * sizeof(float));
    ig->starve_frames.fetch_add((long long)(((size_t)nfloats - n) / ig->width),
                                std::memory_order_relaxed);
  }
  return (long)n;
}

// out[8]: packets, bytes, gap_frames, dups, overrun_frames, starve_frames,
//         malformed, buffered_floats
void rtp_ingest_stats(int h, long long *out) {
  Ingest *ig = ingest_of(h);
  if (!ig) { memset(out, 0, 8 * sizeof(long long)); return; }
  out[0] = ig->packets.load();
  out[1] = ig->bytes.load();
  out[2] = ig->gap_frames.load();
  out[3] = ig->dups.load();
  out[4] = ig->overrun_frames.load();
  out[5] = ig->starve_frames.load();
  out[6] = ig->malformed.load();
  out[7] = (long long)(ig->wr.load() - ig->rd.load());
}

void rtp_ingest_close(int h) {
  Ingest *ig = nullptr;
  {
    std::lock_guard<std::mutex> g(Ingest_mu);
    auto it = Ingests.find(h);
    if (it != Ingests.end()) { ig = it->second; Ingests.erase(it); }
  }
  if (!ig) return;
  ig->run.store(false);
  if (ig->reader.joinable()) ig->reader.join();
  close(ig->fd);
  delete ig;
}

// Paced loopback/LAN RTP sender for ingest benches and feeders: streams
// `nframes` frames of s16be/f32le test pattern (ramp in frame index, so
// the receiver can verify continuity) to ip:port at pace_fps frames/s
// (0 = flat out), frames_per_pkt per packet. Returns frames sent, <0 on
// error. Runs synchronously — call from a thread.
long long rtp_ingest_blast(const char *ip, int port, int encoding, int width,
                           uint32_t ssrc, int frames_per_pkt,
                           long long nframes, long long pace_fps, int ttl) {
  int fd = rtp_edge_open(ip, port, ttl, 0);
  if (fd < 0) return -1;
  sockaddr_in dst{};
  if (!edge_dest_of(fd, &dst)) { rtp_edge_close(fd); return -1; }
  size_t sbytes = sample_bytes(encoding);
  size_t plen = (size_t)frames_per_pkt * width * sbytes;
  if (12 + plen > 65000) { rtp_edge_close(fd); return -2; }
  constexpr int BATCH = 128;
  std::vector<uint8_t> bufs((size_t)BATCH * (12 + plen));
  std::vector<mmsghdr> hdrs(BATCH);
  std::vector<iovec> iovs(BATCH);
  for (int i = 0; i < BATCH; i++) {
    iovs[i] = {bufs.data() + (size_t)i * (12 + plen), 12 + plen};
    memset(&hdrs[i], 0, sizeof(mmsghdr));
    hdrs[i].msg_hdr.msg_iov = &iovs[i];
    hdrs[i].msg_hdr.msg_iovlen = 1;
    hdrs[i].msg_hdr.msg_name = (void *)&dst;
    hdrs[i].msg_hdr.msg_namelen = sizeof(sockaddr_in);
  }
  uint16_t seq = 0;
  uint32_t ts = 0;
  long long sent = 0;
  auto t0 = std::chrono::steady_clock::now();
  while (sent < nframes) {
    int nb = 0;
    for (; nb < BATCH && sent + (long long)frames_per_pkt * nb < nframes; nb++) {
      uint8_t *b = bufs.data() + (size_t)nb * (12 + plen);
      put_rtp_header(b, 97, false, seq, ts, ssrc);
      seq = (uint16_t)(seq + 1);
      long long base = sent + (long long)frames_per_pkt * nb;
      // pattern: sample value == (frame index mod 2^14) - 2^13, so the
      // receiver can assert continuity after the s16 round trip
      for (int f = 0; f < frames_per_pkt; f++) {
        int16_t v = (int16_t)(((base + f) & 0x3fff) - 0x2000);
        for (int w = 0; w < width; w++) {
          uint8_t *q = b + 12 + ((size_t)f * width + w) * sbytes;
          if (encoding == E_S16BE) { q[0] = (uint8_t)(v >> 8); q[1] = (uint8_t)v; }
          else if (encoding == E_S16LE) { q[0] = (uint8_t)v; q[1] = (uint8_t)(v >> 8); }
          else { float fv = (float)v / 32767.0f; memcpy(q, &fv, 4); }
        }
      }
      ts += (uint32_t)frames_per_pkt;
    }
    int done = 0;
    while (done < nb) {
      int r = sendmmsg(fd, hdrs.data() + done, (unsigned)(nb - done), 0);
      if (r <= 0) {
        // transient loopback/back-pressure errors must not kill a paced
        // feeder mid-stream (a dead sender starves the daemon forever)
        if (r < 0 && (errno == EINTR || errno == EAGAIN || errno == ENOBUFS
                      || errno == ENOMEM)) {
          std::this_thread::sleep_for(std::chrono::milliseconds(1));
          continue;
        }
        rtp_edge_close(fd);
        return sent;
      }
      done += r;
    }
    sent += (long long)frames_per_pkt * nb;
    if (pace_fps > 0) {
      auto target = t0 + std::chrono::nanoseconds(
          (long long)(1e9 * (double)sent / (double)pace_fps));
      std::this_thread::sleep_until(target);
    }
  }
  rtp_edge_close(fd);
  return sent;
}

}  // extern "C"
