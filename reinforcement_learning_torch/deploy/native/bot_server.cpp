// RLBot bot server: the native deployment bridge.
//
// The reference deploys trained policies into the real game through a C++
// bot process: RLBotCPP's BotManager runs a TCP bot server that the RLBot
// GUI's python shim manages with "add"/"remove" commands
// (reference: RLBotCPP/inc/rlbot/botmanager.h:18-40,
// rlbot/CppPythonAgent.py:25-38), and each bot converts game packets to a
// GameState, infers every tick_skip ticks, and applies the action after
// action_delay ticks (reference: src/RLBotClient.cpp:94-139).
//
// This is the framework's equivalent, self-contained native runtime (no
// Python on the game machine):
//
//   * a TCP server whose command protocol matches the reference shim
//     exactly: "add\n<name>\n<team>\n<index>\n[dll_dir]" / "remove\n<index>"
//     over short-lived connections; the port is written to port.cfg
//     (CppPythonAgent.read_port_from_file).
//   * a binary game-packet channel on the same port (persistent
//     connection, frames tagged 'RLTP'): the packet layout carries the
//     same fields RLBotClient reads from the flatbuffer GameTickPacket
//     (ball phys, per-player phys + boost/flags, boost pad states,
//     secondsElapsed).  A packet frame is answered with one 'RLTC' frame
//     holding the 8-float controls of every managed bot.
//   * per managed bot, the exact GetOutput state machine
//     (tick counting from secondsElapsed at 120Hz, updateAction /
//     action_delay application), AdvancedObs (29 floats/player; mirrors
//     envs/obs.py and reference AdvancedObs.cpp:193-270), the 90-entry
//     DefaultAction table + masks (envs/actions.py,
//     DefaultAction.cpp:3-118), and the native MLP runtime
//     (mlp_infer.cpp) for the policy forward pass.
//
// Build:  g++ -O3 -std=c++17 bot_server.cpp mlp_infer.cpp -o rlt_bot_server
// Run:    rlt_bot_server <policy_blob> [--port N] [--tick-skip 8]
//                        [--action-delay 7] [--port-file port.cfg]
//                        [--stochastic]

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <array>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <map>
#include <string>
#include <vector>

extern "C" {
void* rlt_load_model(const uint8_t* blob, uint64_t len);
void rlt_free_model(void* handle);
int rlt_num_actions(void* handle);
int rlt_num_inputs(void* handle);
int rlt_infer(void* handle, const float* obs, int batch,
              const uint8_t* masks, int32_t* out_actions, float temperature,
              int deterministic, uint64_t seed);
}

namespace {

constexpr uint32_t kPacketMagic = 0x524C5450;   // "RLTP"
constexpr uint32_t kControlsMagic = 0x524C5443; // "RLTC"
constexpr int kNumPads = 34;
constexpr float kPosCoef = 1.0f / 2300.0f;
constexpr float kVelCoef = 1.0f / 2300.0f;
constexpr float kAngVelCoef = 1.0f / 5.5f;
constexpr float kBoostCoef = 0.01f;

struct Vec3 {
  float x = 0, y = 0, z = 0;
};
Vec3 operator-(const Vec3& a, const Vec3& b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
float dot(const Vec3& a, const Vec3& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
Vec3 inv_vec(const Vec3& v, bool inv) {
  return inv ? Vec3{-v.x, -v.y, v.z} : v;
}

struct PlayerInfo {
  Vec3 pos, vel, ang_vel;
  float yaw = 0, pitch = 0, roll = 0;
  float boost = 0;
  int team = 0;
  bool is_on_ground = true, has_jumped = false, has_double_jumped = false,
       is_demoed = false;
  Vec3 fwd, right, up;  // derived

  void derive_basis() {
    // R = Rz(yaw) @ Ry(-pitch) @ Rx(-roll); columns = fwd/right/up
    // (maths.euler_to_rotmat; reference MathTypes.cpp:73-78)
    const float cy = std::cos(yaw), sy = std::sin(yaw);
    const float cp = std::cos(-pitch), sp = std::sin(-pitch);
    const float cr = std::cos(-roll), sr = std::sin(-roll);
    fwd = {cy * cp, sy * cp, -sp};
    right = {cy * sp * sr - sy * cr, sy * sp * sr + cy * cr, cp * sr};
    up = {cy * sp * cr + sy * sr, sy * sp * cr - cy * sr, cp * cr};
  }
  bool has_flip_or_jump() const {
    // CarState::HasFlipOrJump with packet-unknown timers defaulted
    // (matches deploy/rlbot_agent.py build_obs; air_time_since_jump=0)
    return is_on_ground || !has_double_jumped;
  }
};

struct GamePacket {
  float seconds_elapsed = 0;
  Vec3 ball_pos, ball_vel, ball_ang_vel;
  std::vector<PlayerInfo> players;
  uint8_t pad_active[kNumPads];
  float pad_timer[kNumPads];
};

// ---------------------------------------------------------------------------
// DefaultAction table + masks (envs/actions.py; DefaultAction.cpp:3-118)

struct ActionTable {
  std::vector<std::array<float, 8>> table;
  std::vector<uint8_t> ground_mask, air_mask, jump_mask, boost_mask;
  int num_ground = 0;

  ActionTable() {
    const float R_B[] = {0, 1};
    const float R_F[] = {-1, 0, 1};
    for (float throttle : R_F)
      for (float steer : R_F)
        for (float boost : R_B)
          for (float handbrake : R_B) {
            if (boost == 1 && throttle != 1) continue;
            table.push_back(std::array<float, 8>{
                throttle, steer, 0, steer, 0, 0, boost, handbrake});
          }
    num_ground = (int)table.size();
    for (float pitch : R_F)
      for (float yaw : R_F)
        for (float roll : R_F)
          for (float jump : R_B)
            for (float boost : R_B) {
              if (jump == 1 && yaw != 0) continue;
              if (pitch == roll && roll == jump && jump == 0) continue;
              const float handbrake =
                  (jump == 1 && (pitch != 0 || yaw != 0 || roll != 0)) ? 1.f
                                                                       : 0.f;
              table.push_back(std::array<float, 8>{
                  boost, yaw, pitch, yaw, roll, jump, boost, handbrake});
            }
    const int n = (int)table.size();
    ground_mask.assign(n, 0);
    air_mask.assign(n, 0);
    jump_mask.assign(n, 0);
    boost_mask.assign(n, 0);
    for (int i = 0; i < n; i++) {
      jump_mask[i] = table[i][5] > 0;
      boost_mask[i] = table[i][6] > 0;
      ground_mask[i] = i < num_ground;
      // strictly '>' — index num_ground excluded (DefaultAction.cpp:80)
      air_mask[i] = (i > num_ground) && !jump_mask[i];
    }
    for (int i = 0; i < num_ground; i++) {
      const auto& a = table[i];
      if (a[0] == a[6] && ((a[3] != 0) == (a[7] != 0))) air_mask[i] = 1;
    }
  }

  // envs/actions.py action_mask (turtled unknown from packets => false)
  void mask_for(const PlayerInfo& p, uint8_t* out) const {
    const int n = (int)table.size();
    for (int i = 0; i < n; i++) {
      uint8_t base = p.is_on_ground ? ground_mask[i] : air_mask[i];
      if (p.boost == 0 && boost_mask[i]) base = 0;
      if (p.has_flip_or_jump() && jump_mask[i]) base = 1;
      out[i] = base;
    }
  }
};

// ---------------------------------------------------------------------------
// AdvancedObs for the local player row (envs/obs.py AdvancedObs;
// reference AdvancedObs.cpp:193-270)

void player_block(const PlayerInfo& p, const Vec3& ball_pos,
                  const Vec3& ball_vel, bool inv, float* o) {
  const Vec3 pos = inv_vec(p.pos, inv), fwd = inv_vec(p.fwd, inv),
             up = inv_vec(p.up, inv), vel = inv_vec(p.vel, inv),
             ang = inv_vec(p.ang_vel, inv), right = inv_vec(p.right, inv),
             bpos = inv_vec(ball_pos, inv), bvel = inv_vec(ball_vel, inv);
  const Vec3 rel_ball = bpos - pos, rel_vel = bvel - vel;
  int k = 0;
  o[k++] = pos.x * kPosCoef; o[k++] = pos.y * kPosCoef;
  o[k++] = pos.z * kPosCoef;
  o[k++] = fwd.x; o[k++] = fwd.y; o[k++] = fwd.z;
  o[k++] = up.x; o[k++] = up.y; o[k++] = up.z;
  o[k++] = vel.x * kVelCoef; o[k++] = vel.y * kVelCoef;
  o[k++] = vel.z * kVelCoef;
  o[k++] = ang.x * kAngVelCoef; o[k++] = ang.y * kAngVelCoef;
  o[k++] = ang.z * kAngVelCoef;
  o[k++] = dot(fwd, ang) * kAngVelCoef;
  o[k++] = dot(right, ang) * kAngVelCoef;
  o[k++] = dot(up, ang) * kAngVelCoef;
  o[k++] = dot(fwd, rel_ball) * kPosCoef;
  o[k++] = dot(right, rel_ball) * kPosCoef;
  o[k++] = dot(up, rel_ball) * kPosCoef;
  o[k++] = dot(fwd, rel_vel) * kVelCoef;
  o[k++] = dot(right, rel_vel) * kVelCoef;
  o[k++] = dot(up, rel_vel) * kVelCoef;
  o[k++] = p.boost * kBoostCoef;
  o[k++] = p.is_on_ground ? 1.f : 0.f;
  o[k++] = p.has_flip_or_jump() ? 1.f : 0.f;
  o[k++] = p.is_demoed ? 1.f : 0.f;
  o[k++] = p.has_jumped ? 1.f : 0.f;
}

// obs row for player `index`; prev_action = that bot's current controls
void build_obs(const GamePacket& pkt, int index, const float* prev_action,
               std::vector<float>& obs) {
  const int P = (int)pkt.players.size();
  const PlayerInfo& me = pkt.players[index];
  const bool inv = me.team == 1;
  obs.clear();
  obs.reserve(9 + 8 + kNumPads + 29 * P);

  const Vec3 bp = inv_vec(pkt.ball_pos, inv), bv = inv_vec(pkt.ball_vel, inv),
             ba = inv_vec(pkt.ball_ang_vel, inv);
  const float ball9[] = {bp.x * kPosCoef, bp.y * kPosCoef, bp.z * kPosCoef,
                         bv.x * kVelCoef, bv.y * kVelCoef, bv.z * kVelCoef,
                         ba.x * kAngVelCoef, ba.y * kAngVelCoef,
                         ba.z * kAngVelCoef};
  obs.insert(obs.end(), ball9, ball9 + 9);
  obs.insert(obs.end(), prev_action, prev_action + 8);

  // pads arrive in canonical order; reversed for orange
  // (GameState.cpp:110-125; obs value = active ? 1 : 1/(1+timer))
  for (int i = 0; i < kNumPads; i++) {
    const int j = inv ? kNumPads - 1 - i : i;
    obs.push_back(pkt.pad_active[j] ? 1.f : 1.f / (1.f + pkt.pad_timer[j]));
  }

  // self, teammates (index order), opponents (index order)
  std::vector<int> order;
  order.push_back(index);
  for (int j = 0; j < P; j++)
    if (j != index && pkt.players[j].team == me.team) order.push_back(j);
  for (int j = 0; j < P; j++)
    if (pkt.players[j].team != me.team) order.push_back(j);
  float block[29];
  for (int j : order) {
    player_block(pkt.players[j], pkt.ball_pos, pkt.ball_vel, inv, block);
    obs.insert(obs.end(), block, block + 29);
  }
}

// ---------------------------------------------------------------------------
// Per-bot tick-skip / action-delay state machine (RLBotClient.cpp:94-139)

struct Bot {
  std::string name;
  int team = 0;
  int ticks = -1;
  float prev_time = 0;
  bool update_action = true;
  std::array<float, 8> controls{};
  std::array<float, 8> pending{};
};

struct Server {
  void* model = nullptr;
  ActionTable actions;
  std::map<int, Bot> bots;  // by spawn index
  int tick_skip = 8, action_delay = 7;
  bool deterministic = true;
  uint64_t infer_seed = 0;

  void step_bot(int index, Bot& bot, const GamePacket& pkt) {
    if (index >= (int)pkt.players.size()) return;
    const float delta = pkt.seconds_elapsed - bot.prev_time;
    bot.prev_time = pkt.seconds_elapsed;
    const int ticks_elapsed = (int)std::lround(delta * 120.0f);
    if (bot.ticks >= 0) bot.ticks += ticks_elapsed;

    if (bot.update_action) {
      bot.update_action = false;
      std::vector<float> obs;
      build_obs(pkt, index, bot.controls.data(), obs);
      if ((int)obs.size() == rlt_num_inputs(model)) {
        std::vector<uint8_t> mask(actions.table.size());
        actions.mask_for(pkt.players[index], mask.data());
        int32_t a = 0;
        rlt_infer(model, obs.data(), 1, mask.data(), &a, 1.0f,
                  deterministic ? 1 : 0, infer_seed++);
        bot.pending = actions.table[a];
      } else {
        std::fprintf(stderr,
                     "bot %d: obs size %zu != model inputs %d (player "
                     "count mismatch?)\n",
                     index, obs.size(), rlt_num_inputs(model));
      }
    }
    if (bot.ticks >= (action_delay - 1) || bot.ticks == -1)
      bot.controls = bot.pending;
    if (bot.ticks >= tick_skip || bot.ticks == -1) {
      bot.ticks = 0;
      bot.update_action = true;
    }
  }
};

// ---------------------------------------------------------------------------
// Wire protocol

bool read_exact(int fd, void* buf, size_t n) {
  uint8_t* p = (uint8_t*)buf;
  while (n) {
    const ssize_t r = ::read(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= (size_t)r;
  }
  return true;
}

bool write_exact(int fd, const void* buf, size_t n) {
  const uint8_t* p = (const uint8_t*)buf;
  while (n) {
    const ssize_t r = ::write(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= (size_t)r;
  }
  return true;
}

bool read_packet(int fd, GamePacket& pkt) {
  float hdr[1];
  int32_t np;
  if (!read_exact(fd, hdr, sizeof hdr)) return false;
  pkt.seconds_elapsed = hdr[0];
  float ball[9];
  if (!read_exact(fd, ball, sizeof ball)) return false;
  pkt.ball_pos = {ball[0], ball[1], ball[2]};
  pkt.ball_vel = {ball[3], ball[4], ball[5]};
  pkt.ball_ang_vel = {ball[6], ball[7], ball[8]};
  if (!read_exact(fd, &np, sizeof np) || np < 0 || np > 64) return false;
  pkt.players.resize(np);
  for (auto& p : pkt.players) {
    float f[14];
    int32_t team;
    uint8_t flags[4];
    if (!read_exact(fd, f, sizeof f) || !read_exact(fd, &team, sizeof team) ||
        !read_exact(fd, flags, sizeof flags))
      return false;
    p.pos = {f[0], f[1], f[2]};
    p.yaw = f[3]; p.pitch = f[4]; p.roll = f[5];
    p.vel = {f[6], f[7], f[8]};
    p.ang_vel = {f[9], f[10], f[11]};
    p.boost = f[12];
    // f[13] reserved
    p.team = team;
    p.is_on_ground = flags[0];
    p.has_jumped = flags[1];
    p.has_double_jumped = flags[2];
    p.is_demoed = flags[3];
    p.derive_basis();
  }
  int32_t npads;
  if (!read_exact(fd, &npads, sizeof npads) || npads != kNumPads)
    return false;
  for (int i = 0; i < kNumPads; i++) {
    if (!read_exact(fd, &pkt.pad_active[i], 1)) return false;
    if (!read_exact(fd, &pkt.pad_timer[i], 4)) return false;
  }
  return true;
}

void handle_command(Server& srv, const std::string& text) {
  // "add\n<name>\n<team>\n<index>\n[dll_dir]"  |  "remove\n<index>"
  std::vector<std::string> lines;
  size_t start = 0;
  while (start <= text.size()) {
    const size_t nl = text.find('\n', start);
    if (nl == std::string::npos) {
      lines.push_back(text.substr(start));
      break;
    }
    lines.push_back(text.substr(start, nl - start));
    start = nl + 1;
  }
  if (lines.empty()) return;
  if (lines[0] == "add" && lines.size() >= 4) {
    const int team = std::atoi(lines[2].c_str());
    const int index = std::atoi(lines[3].c_str());
    if (!srv.bots.count(index)) {
      Bot b;
      b.name = lines[1];
      b.team = team;
      srv.bots[index] = b;
      std::fprintf(stderr, "added bot '%s' team %d index %d\n",
                   b.name.c_str(), team, index);
    }
  } else if (lines[0] == "remove" && lines.size() >= 2) {
    const int index = std::atoi(lines[1].c_str());
    if (srv.bots.erase(index))
      std::fprintf(stderr, "removed bot index %d\n", index);
  }
}

// Service pending command connections while a packet stream is active.
// The reference BotManager accepts bot add/remove concurrently with the
// game stream (RLBotCPP/src/botmanager.cc); here a single thread polls the
// listen socket between packet frames instead.  Returns false on "quit".
bool drain_command_connections(Server& srv, int lsock) {
  for (;;) {
    pollfd p{lsock, POLLIN, 0};
    if (::poll(&p, 1, 0) <= 0 || !(p.revents & POLLIN)) return true;
    const int cfd = ::accept(lsock, nullptr, nullptr);
    if (cfd < 0) return true;
    // Commands are short one-shot sends; a client that holds the socket
    // open (or trickles bytes) must not stall the packet stream, so each
    // read waits at most 200ms and the connection is dropped on timeout.
    std::string text;
    char buf[512];
    for (;;) {
      pollfd cp{cfd, POLLIN, 0};
      if (::poll(&cp, 1, 200) <= 0 || !(cp.revents & (POLLIN | POLLHUP)))
        break;  // slow or idle client: drop it
      const ssize_t r = ::read(cfd, buf, sizeof buf);
      if (r <= 0) break;
      text.append(buf, (size_t)r);
    }
    ::close(cfd);
    if (text.rfind("quit", 0) == 0) return false;
    // A second packet stream while one is active is not supported; only
    // text commands are serviced here.
    if (text.size() >= 4 && memcmp(text.data(), &kPacketMagic, 4) != 0)
      handle_command(srv, text);
  }
}

// Returns false when the server should shut down ("quit" command).
bool handle_packet_stream(Server& srv, int fd, uint32_t first_magic,
                          int lsock) {
  uint32_t magic = first_magic;
  for (;;) {
    if (magic != kPacketMagic) return true;
    GamePacket pkt;
    if (!read_packet(fd, pkt)) return true;
    for (auto& [index, bot] : srv.bots) srv.step_bot(index, bot, pkt);
    // reply: magic, count, per bot: index + 8 controls
    std::vector<uint8_t> out;
    const uint32_t m = kControlsMagic;
    const int32_t n = (int32_t)srv.bots.size();
    out.insert(out.end(), (uint8_t*)&m, (uint8_t*)&m + 4);
    out.insert(out.end(), (uint8_t*)&n, (uint8_t*)&n + 4);
    for (auto& [index, bot] : srv.bots) {
      const int32_t i32 = index;
      out.insert(out.end(), (uint8_t*)&i32, (uint8_t*)&i32 + 4);
      out.insert(out.end(), (uint8_t*)bot.controls.data(),
                 (uint8_t*)bot.controls.data() + 8 * sizeof(float));
    }
    if (!write_exact(fd, out.data(), out.size())) return true;
    // Between frames, service mid-match add/remove command connections so
    // they don't stall in the listen backlog until the stream closes.
    if (!drain_command_connections(srv, lsock)) return false;
    if (!read_exact(fd, &magic, 4)) return true;
  }
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 2) {
    std::fprintf(stderr,
                 "usage: %s <policy_blob> [--port N] [--tick-skip N] "
                 "[--action-delay N] [--port-file PATH] [--stochastic]\n",
                 argv[0]);
    return 2;
  }
  Server srv;
  int port = 0;
  std::string port_file = "port.cfg";
  for (int i = 2; i < argc; i++) {
    const std::string a = argv[i];
    if (a == "--port" && i + 1 < argc) port = std::atoi(argv[++i]);
    else if (a == "--tick-skip" && i + 1 < argc)
      srv.tick_skip = std::atoi(argv[++i]);
    else if (a == "--action-delay" && i + 1 < argc)
      srv.action_delay = std::atoi(argv[++i]);
    else if (a == "--port-file" && i + 1 < argc) port_file = argv[++i];
    else if (a == "--stochastic") srv.deterministic = false;
  }

  std::ifstream f(argv[1], std::ios::binary);
  if (!f) {
    std::fprintf(stderr, "cannot open policy blob %s\n", argv[1]);
    return 2;
  }
  std::vector<uint8_t> blob((std::istreambuf_iterator<char>(f)),
                            std::istreambuf_iterator<char>());
  srv.model = rlt_load_model(blob.data(), blob.size());
  if (!srv.model) {
    std::fprintf(stderr, "invalid policy blob\n");
    return 2;
  }

  const int lsock = ::socket(AF_INET, SOCK_STREAM, 0);
  const int one = 1;
  ::setsockopt(lsock, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  addr.sin_port = htons((uint16_t)port);
  if (::bind(lsock, (sockaddr*)&addr, sizeof addr) != 0) {
    std::perror("bind");
    return 2;
  }
  socklen_t alen = sizeof addr;
  ::getsockname(lsock, (sockaddr*)&addr, &alen);
  port = ntohs(addr.sin_port);
  {
    std::ofstream pf(port_file);
    pf << port << "\n";
  }
  ::listen(lsock, 8);
  std::fprintf(stderr,
               "rlt_bot_server listening on 127.0.0.1:%d "
               "(tick_skip=%d action_delay=%d inputs=%d actions=%d)\n",
               port, srv.tick_skip, srv.action_delay,
               rlt_num_inputs(srv.model), rlt_num_actions(srv.model));

  for (;;) {
    const int fd = ::accept(lsock, nullptr, nullptr);
    if (fd < 0) continue;
    ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
    uint32_t magic = 0;
    if (!read_exact(fd, &magic, 4)) {
      ::close(fd);
      continue;
    }
    if (magic == kPacketMagic) {
      const bool keep = handle_packet_stream(srv, fd, magic, lsock);
      if (!keep) {
        ::close(fd);
        break;
      }
    } else {
      // text command: magic holds the first 4 bytes already
      std::string text((char*)&magic, 4);
      char buf[512];
      for (;;) {
        const ssize_t r = ::read(fd, buf, sizeof buf);
        if (r <= 0) break;
        text.append(buf, (size_t)r);
      }
      if (text.rfind("quit", 0) == 0) {
        ::close(fd);
        break;
      }
      handle_command(srv, text);
    }
    ::close(fd);
  }
  rlt_free_model(srv.model);
  return 0;
}
