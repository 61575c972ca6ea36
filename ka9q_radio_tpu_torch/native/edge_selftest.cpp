// edge_selftest — sanitizer harness for the port's native RTP edge.
//
// The reference ships `make SANITIZE=1` (ASan+UBSan, src/Makefile:50-54)
// as its memory/race story for the C side. This is the analog for
// rtp_edge.cpp: a standalone binary compiled with
// -fsanitize=address,undefined that drives every encode path, the packet
// splitter, the compacted-egress send, the beacon path and the Opus slot
// lifecycle against a loopback socket, then the ingest reader thread with
// malformed packets and a forced ring wrap. This edge has no paced sender
// of its own, so the harness sends the ingest traffic itself, from its one
// thread. Last, the blocking read's wake-up: a read that is waiting for
// the packet that completes its request returns as that packet lands, not
// at its timeout. tests/test_torch_native.py builds and runs it; a
// sanitizer report or a failed check is a non-zero exit.
//
// Build: g++ -std=c++17 -O1 -g -fsanitize=address,undefined \
//            edge_selftest.cpp -o edge_selftest -ldl -lpthread

// The harness includes the edge's source, not only its C interface, so
// that the wake-up check can hold an ingest's mutex (Ingest::m) itself.
#include "rtp_edge.cpp"

#include <chrono>
#include <thread>

static int bound_port(int fd) {
  sockaddr_in sa{};
  socklen_t sl = sizeof sa;
  getsockname(fd, (sockaddr *)&sa, &sl);
  return ntohs(sa.sin_port);
}

int main() {
  // loopback receiver so the sends complete
  int rx = socket(AF_INET, SOCK_DGRAM, 0);
  sockaddr_in sa{};
  sa.sin_family = AF_INET;
  sa.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  sa.sin_port = 0;
  if (bind(rx, (sockaddr *)&sa, sizeof sa) < 0) { perror("bind"); return 2; }
  int port = bound_port(rx);

  int fd = rtp_edge_open("127.0.0.1", port, 1, 0);
  if (fd < 0) { fprintf(stderr, "open fail %d\n", fd); return 2; }

  const int C = 8, NFRAMES = 960, NCH = 2;
  std::vector<float> audio((size_t)C * NFRAMES * NCH);
  for (size_t i = 0; i < audio.size(); i++)
    audio[i] = sinf(0.02f * (float)i) * ((i % 7) ? 1.0f : 37.0f);  // incl. clipping
  std::vector<uint8_t> send(C, 1), marker(C, 1), pt(C, 122);
  std::vector<uint32_t> ssrc(C), ts(C, 0xFFFFFF00u);  // near ts wrap
  std::vector<uint16_t> seq(C, 0xFFFE);               // near seq wrap
  std::vector<int32_t> enc(C), rate(C, 12000);
  std::vector<int32_t> obr(C, 0), oapp(C, 0);
  std::vector<uint8_t> odtx(C, 0);
  for (int c = 0; c < C; c++) ssrc[c] = 100 + c;

  // every PCM encoding incl. odd ones, plus muted channels
  const int encs[] = {1, 2, 4, 6, 8, 9, 10, 11};
  for (int round = 0; round < 4; round++) {
    for (int c = 0; c < C; c++) {
      enc[c] = encs[(c + round) % 8];
      send[c] = (uint8_t)((c + round) % 3 != 0);
    }
    int n = rtp_edge_send_block(fd, audio.data(), C, NFRAMES, NCH, send.data(),
                                ssrc.data(), pt.data(), enc.data(), rate.data(),
                                obr.data(), odtx.data(), oapp.data(),
                                seq.data(), ts.data(), marker.data());
    if (n < 0) { fprintf(stderr, "send fail %d\n", n); return 2; }
  }
  // single-frame edge case and 1-channel layout
  rtp_edge_send_block(fd, audio.data(), C, 1, 1, send.data(), ssrc.data(),
                      pt.data(), enc.data(), rate.data(),
                      obr.data(), odtx.data(), oapp.data(),
                      seq.data(), ts.data(), marker.data());

  // compacted egress: K rows of the open channels, an index out of range
  // and a -1 past the count (both skipped), every PCM encoding
  {
    const int K = 5;
    std::vector<int32_t> idx = {6, 0, 3, C + 4, -1};
    for (int round = 0; round < 8; round++) {
      for (int c = 0; c < C; c++) enc[c] = encs[(c + round) % 8];
      int n = rtp_edge_send_indexed(fd, audio.data(), K, C, NFRAMES, NCH, idx.data(),
                                    ssrc.data(), pt.data(), enc.data(), seq.data(),
                                    ts.data(), marker.data());
      if (n < 0) { fprintf(stderr, "indexed send fail %d\n", n); return 2; }
    }
    rtp_edge_send_indexed(fd, audio.data(), 0, C, NFRAMES, NCH, idx.data(), ssrc.data(),
                          pt.data(), enc.data(), seq.data(), ts.data(), marker.data());
  }

  // a beacon from the audio socket to another port; an unknown fd fails
  {
    uint8_t beacon[300];
    for (int i = 0; i < (int)sizeof beacon; i++) beacon[i] = (uint8_t)i;
    if (rtp_edge_send_ctl(fd, beacon, (int)sizeof beacon, port) != (int)sizeof beacon) {
      fprintf(stderr, "send_ctl fail\n");
      return 2;
    }
    if (rtp_edge_send_ctl(-7, beacon, 4, port) != -1) {
      fprintf(stderr, "send_ctl on a closed edge did not fail\n");
      return 2;
    }
  }

  if (rtp_edge_has_opus()) {
    for (int c = 0; c < C; c++) { enc[c] = (c % 2) ? 3 : 7; send[c] = 1; rate[c] = 48000; }
    for (int round = 0; round < 3; round++)
      rtp_edge_send_block(fd, audio.data(), C, NFRAMES, NCH, send.data(),
                          ssrc.data(), pt.data(), enc.data(), rate.data(),
                          obr.data(), odtx.data(), oapp.data(),
                          seq.data(), ts.data(), marker.data());
    // knob changes exercise the ctl path and encoder recreation
    for (int c = 0; c < C; c++) { rate[c] = 24000; obr[c] = 32000; odtx[c] = 1; oapp[c] = 2048; }
    rtp_edge_send_block(fd, audio.data(), C, 480, NCH, send.data(), ssrc.data(),
                        pt.data(), enc.data(), rate.data(),
                        obr.data(), odtx.data(), oapp.data(),
                        seq.data(), ts.data(), marker.data());
  }

  rtp_edge_close(fd);  // frees the Opus slots
  close(rx);

  // ---- ingest surface: reader thread, ring wrap, malformed packets ----
  {
    int ih = rtp_ingest_open("127.0.0.1", 0, 2 /*s16be*/, 1, 0,
                             14 /*16k-float ring -> forced wrap*/, 4);
    if (ih < 0) { fprintf(stderr, "ingest open fail %d\n", ih); return 2; }
    int iport = bound_port(ih);  // the handle is the bound socket
    int tx = socket(AF_INET, SOCK_DGRAM, 0);
    sockaddr_in da{};
    da.sin_family = AF_INET;
    da.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
    da.sin_port = htons((uint16_t)iport);
    // malformed garbage + truncated headers must be rejected cleanly
    uint8_t junk[32] = {0};
    sendto(tx, junk, 4, 0, (sockaddr *)&da, sizeof da);
    junk[0] = 0x80;
    sendto(tx, junk, 11, 0, (sockaddr *)&da, sizeof da);
    junk[0] = 0x9f;  // version 2, 15 CSRCs + extension, but tiny packet
    sendto(tx, junk, 16, 0, (sockaddr *)&da, sizeof da);
    // real traffic: 704-frame s16be packets of a ramp, enough to wrap the
    // 16k ring several times, with a skipped sequence number (a gap)
    const int FPP = 704;
    std::vector<uint8_t> pkt(12 + 2 * FPP);
    uint32_t ts_in = 0;
    for (int k = 0; k < 290; k++) {
      uint16_t sq = (uint16_t)(k < 100 ? k : k + 1);
      pkt[0] = 0x80;
      pkt[1] = 97;
      pkt[2] = (uint8_t)(sq >> 8);
      pkt[3] = (uint8_t)sq;
      for (int b = 0; b < 4; b++) pkt[4 + b] = (uint8_t)(ts_in >> (24 - 8 * b));
      for (int b = 0; b < 4; b++) pkt[8 + b] = (uint8_t)(7u >> (24 - 8 * b));
      for (int f = 0; f < FPP; f++) {
        int16_t v = (int16_t)(((k * FPP + f) & 0x3fff) - 0x2000);
        pkt[12 + 2 * f] = (uint8_t)((uint16_t)v >> 8);
        pkt[13 + 2 * f] = (uint8_t)v;
      }
      ts_in += (uint32_t)FPP * (k == 99 ? 2u : 1u);
      sendto(tx, pkt.data(), pkt.size(), 0, (sockaddr *)&da, sizeof da);
      if (k % 32 == 31) usleep(1000);
    }
    std::vector<float> out(4096);
    long long total = 0;
    for (int i = 0; i < 8; i++)
      total += rtp_ingest_read(ih, out.data(), (long)out.size(), 50);
    long long st[8];
    rtp_ingest_stats(ih, st);
    if (st[6] < 2) { fprintf(stderr, "malformed not counted\n"); return 2; }
    if (st[0] < 1 || total < 1) { fprintf(stderr, "no ingest traffic read\n"); return 2; }
    rtp_ingest_close(ih);  // joins the reader thread
    rtp_ingest_close(ih);  // a second close is a no-op
    close(tx);
  }
  // ---- ingest read: the packet that fills a waiting read wakes it ----
  // The harness holds the ingest's mutex while the read starts (it has
  // checked the fill, or is about to) and while the filling packet lands,
  // which puts the reader thread's notify in the window between the read's
  // check and its wait, every time. A read that checks the fill outside the
  // mutex misses that notify and sleeps to its 3 s timeout.
  {
    int ih = rtp_ingest_open("127.0.0.1", 0, 2 /*s16be*/, 1, 0, 16, 4);
    if (ih < 0) { fprintf(stderr, "ingest open fail %d\n", ih); return 2; }
    Ingest *ig = ingest_of(ih);
    int tx = socket(AF_INET, SOCK_DGRAM, 0);
    sockaddr_in da{};
    da.sin_family = AF_INET;
    da.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
    da.sin_port = htons((uint16_t)bound_port(ih));
    const int FPP = 256;
    auto send_pkt = [&](int k) {
      std::vector<uint8_t> pkt(12 + 2 * FPP, 0);
      pkt[0] = 0x80;
      pkt[1] = 97;
      pkt[3] = (uint8_t)k;
      uint32_t ts = (uint32_t)(k * FPP);
      for (int b = 0; b < 4; b++) pkt[4 + b] = (uint8_t)(ts >> (24 - 8 * b));
      pkt[11] = 9;
      sendto(tx, pkt.data(), pkt.size(), 0, (sockaddr *)&da, sizeof da);
    };
    auto buffered = [&] {
      long long st[8];
      rtp_ingest_stats(ih, st);
      return st[7];
    };
    auto settle = [&](long long want) {
      for (int i = 0; i < 2000 && buffered() < want; i++) usleep(1000);
      return buffered() == want;
    };
    using clk = std::chrono::steady_clock;
    for (int rep = 0; rep < 3; rep++) {
      send_pkt(2 * rep);
      if (!settle(FPP)) { fprintf(stderr, "first packet not buffered\n"); return 2; }
      std::vector<float> dst(2 * FPP);
      long got = -2;
      clk::time_point done;
      ig->m.lock();
      std::thread reader([&] {
        got = rtp_ingest_read(ih, dst.data(), 2 * FPP, 3000);
        done = clk::now();
      });
      usleep(50000);  // the read is now blocked on the mutex
      send_pkt(2 * rep + 1);
      if (!settle(2 * FPP)) { fprintf(stderr, "second packet not buffered\n"); return 2; }
      clk::time_point freed = clk::now();
      ig->m.unlock();
      reader.join();
      double ms = std::chrono::duration<double, std::milli>(done - freed).count();
      if (got != 2 * FPP || ms > 500.0) {
        fprintf(stderr, "lost wake-up: read %ld of %d floats %.1f ms after the fill "
                "(timeout 3000 ms)\n", got, 2 * FPP, ms);
        return 3;
      }
    }
    rtp_ingest_close(ih);
    close(tx);
  }
  printf("edge_selftest OK\n");
  return 0;
}
