// arena_step.cu: one env step (tick_skip physics ticks) of every arena in one
// launch, on the analytic-plane soccar arena or at full fidelity (the facet
// arena of facets.cuh plus the 4 true planes, and dynamic wheel rays), in
// soccar, heatseeker or snowday (the game mode is a field of Params).
//
// Replaces the TPU kernel `pallas_arena_step` (reinforcement_learning_tpu/
// ops/pallas_step.py:85, the pl.pallas_call at :126), whose body is
// `ctick.step` (ops/ctick.py:2515) -> `ctick.tick` (:2122).  The plain
// PyTorch version of the same function is reinforcement_learning_torch/
// ops/ctick.py; ops/arena_step.py builds, binds and launches this file.
//
// Design: a warp per arena (LANES = 32 lanes; a half-warp with
// -DARENA_STEP_LANES=16), APB arenas per block (4 by default, so 1024
// arenas are 256 blocks over the 132 SMs, one wave).  A block copies its
// arenas' state from the struct-of-arrays buffers (row r of a buffer holds
// one scalar of one car, or of the arena, for every env: element
// [r * E + e]) into shared memory with coalesced reads, unpacks it into
// each warp's ``Work`` (the arena and every per-car scratch array of a
// tick), steps all ticks there, and writes it back the same way.  The facet
// tables, the curves and the arena planes, which lanes index divergently,
// are copied from Params into shared memory once per block.  A tick is the
// plain version's sequence of stages; between stages that depend on each
// other the arena's lanes meet at __syncwarp.  Within a stage the lanes
// take: a car each (state machines, integration, the world contacts and
// their PGS, the car-ball solver), a (car, wheel) each (the suspension
// rays and the friction impulses), a car pair each (box-box and the pair
// solver), a pad each, and (body, facet item) work items spread over all
// lanes for the facet candidates; a sum the plain version takes over cars,
// pairs or pads is then taken by one lane in the same order.  The new
// controls switch in at tick `action_delay`; the per-step latches are
// cleared first; the demo respawn location comes in as one pre-drawn index
// per car.
//
// Dead work is skipped exactly: a facet item (a side's profile band, a
// goal rectangle, a floor or ceiling sheet) whose rows cannot be live for
// the body, a wheel ray's band or rectangle it cannot reach, the PGS rows
// that are not active, and the face clipping and solver of a car pair the
// separating-axis test finds apart.  Each skipped computation yields exact
// zeros or rows no visitor sees in the plain version (facets.cuh,
// `pgs_rows`, `pair_contact`), so the results are bit-equal with the
// thread-per-arena kernel that evaluated everything.
//
// What bounds it: arithmetic.  One env step of 1024 2v2 arenas in play needs
// about 2.4e8 fp32 operations on the plane arena and 2.6e8 at full fidelity
// (ops/opcount.py counts them on the data: the wheel rays, state machines
// and pads of every car and the separating-axis test of every car pair each
// tick; the contact solvers only where there is a contact; each facet query
// only where one of its rows is live) against ~3.6 MB of device memory read
// and written once, so on an H100 the operations bound it (~0.004 ms for
// both at 67 TFLOP/s, against ~0.001 ms for the bytes).  What is left above
// that is the serial chain of a tick on few lanes: the per-car solvers run
// one car to a lane, 4 of 32 lanes, and the ball on one (PERF.md).
//
// Numerics: built with -fmad=false, so no a*b+c is contracted into an FMA
// and every operation rounds as the plain version's elementwise tensor ops
// do; divisions and square roots are IEEE (no --use_fast_math).  What is
// left are last-ulp differences of sinf/cosf/atan2f against PyTorch's;
// chip_smoke.py holds the kernel to the plain version within the
// tolerances of tests/test_ctick.py _assert_close (0.1 uu positions,
// 0.2 uu/s speeds, 0.02 rad/s spins, 1e-4 rotations) and allows a flipped
// boolean in at most 0.1% of arenas of a random state, none in the demo
// and car-car states.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cvec.cuh"
#include "facets.cuh"

namespace {

// ---------------------------------------------------------------------------
// Game constants (constants.py; RocketSim RLConst.h).  Each is the float the
// plain version's Python scalar becomes when it meets a float32 tensor.

constexpr float BT_TO_UU = 50.0f;
constexpr float UU_TO_BT = (float)(1.0 / 50.0);
constexpr float GRAVITY_Z = -650.0f;
constexpr float ARENA_EXTENT_Y = 5120.0f;
constexpr float GOAL_HALF_WIDTH = 892.755f;
constexpr float GOAL_HEIGHT = 642.775f;
constexpr float MESH_COLLISION_MARGIN = 2.0f;
constexpr float SOLVER_ERP2 = 0.8f;
constexpr float BALL_MAX_ANG_SPEED = 6.0f;
constexpr float CAR_MAX_SPEED = 2300.0f;
constexpr float CAR_MAX_ANG_SPEED = 5.5f;
constexpr float BOOST_MAX = 100.0f;
constexpr float BOOST_MIN_TIME = 0.1f;
constexpr float SUPERSONIC_START_SPEED = 2200.0f;
constexpr float SUPERSONIC_MAINTAIN_MIN_SPEED = 2100.0f;
constexpr float SUPERSONIC_MAINTAIN_MAX_TIME = 1.0f;
constexpr float POWERSLIDE_RISE_RATE = 5.0f;
constexpr float POWERSLIDE_FALL_RATE = 2.0f;
constexpr float THROTTLE_TORQUE_BT = (float)(180.0 * 400.0 * (1.0 / 50.0));
constexpr float BRAKE_TORQUE_BT =
    (float)(180.0 * (14.25 + (1.0 / 3.0)) * (1.0 / 50.0));
constexpr float STOPPING_FORWARD_VEL = 25.0f;
constexpr float COASTING_BRAKE_FACTOR = 0.15f;
constexpr float BRAKING_NO_THROTTLE_SPEED_THRESH = 0.01f;
constexpr float THROTTLE_DEADZONE = 0.001f;
constexpr float THROTTLE_AIR_ACCEL = (float)(200.0 / 3.0);
constexpr float JUMP_IMMEDIATE_FORCE = (float)(875.0 / 3.0);
constexpr float JUMP_MIN_TIME = 0.025f;
constexpr float JUMP_RESET_LIMIT = (float)(0.025 + 1.0 / 40.0);
constexpr float JUMP_MAX_TIME = 0.2f;
constexpr float JUMP_PRE_MIN_ACCEL_SCALE = 0.62f;
constexpr float DOUBLEJUMP_MAX_DELAY = 1.25f;
constexpr float FLIP_Z_DAMP_START = 0.15f;
constexpr float FLIP_Z_DAMP_END = 0.21f;
constexpr float FLIP_TORQUE_TIME = 0.65f;
constexpr float FLIP_PITCHLOCK_LIMIT = (float)(0.65 + 0.3);
constexpr float FLIP_INITIAL_VEL_SCALE = 500.0f;
constexpr float FLIP_TORQUE_X = 260.0f;
constexpr float FLIP_TORQUE_Y = 224.0f;
constexpr float FLIP_FORWARD_IMPULSE_MAX_SPEED_SCALE = 1.0f;
constexpr float FLIP_SIDE_SCALE_M1 = (float)(1.9 - 1.0);
constexpr float FLIP_BACKWARD_IMPULSE_MAX_SPEED_SCALE = 2.5f;
constexpr float FLIP_BACKWARD_IMPULSE_SCALE_X = (float)(16.0 / 15.0);
constexpr float CAR_TORQUE_SCALE =
    (float)(2.0 * 3.14159265358979323846 / 65536.0 * 1000.0);
constexpr float CAR_AUTOFLIP_IMPULSE = 200.0f;
constexpr float CAR_AUTOFLIP_TORQUE = 50.0f;
constexpr float CAR_AUTOFLIP_TIME = 0.4f;
constexpr float CAR_AUTOFLIP_NORMZ_THRESH = (float)0.70710678118654752440;
constexpr float CAR_AUTOFLIP_ROLL_THRESH = 2.8f;
constexpr float PI_F = (float)3.14159265358979323846;
constexpr float CAR_AUTOROLL_FORCE = 100.0f;
constexpr float CAR_AUTOROLL_TORQUE = 80.0f;
constexpr float EXTRA_IMPULSE_Z_SCALE = 0.35f;
constexpr float EXTRA_IMPULSE_FWD_KEEP = (float)(1.0 - 0.65);
constexpr float EXTRA_IMPULSE_MAXDELTAVEL = 4600.0f;
constexpr float CAR_RESPAWN_Z = 36.0f;
constexpr float BUMP_MIN_FORWARD_DIST = 64.5f;
constexpr float DODGE_DEADZONE = 0.5f;
constexpr float SUS_STIFFNESS = 500.0f;
constexpr float DAMP_COMPRESSION = 25.0f;
constexpr float DAMP_RELAXATION = 40.0f;
constexpr float ROLLING_FRICTION_SCALE_MAGIC = 113.73963f;
constexpr float SIDE_FRICTION_DAMPING = 0.2f;
constexpr float AIR_TORQUE_PITCH = 130.0f, AIR_TORQUE_YAW = 95.0f,
                AIR_TORQUE_ROLL = 400.0f;
constexpr float AIR_DAMP_PITCH = 30.0f, AIR_DAMP_YAW = 20.0f,
                AIR_DAMP_ROLL = 50.0f;
constexpr float CARBALL_FRICTION = 2.0f;
constexpr float CARCAR_RESTITUTION = 0.1f;
constexpr float CARCAR_FRICTION = 0.09f;
constexpr float PAD_CYL_HEIGHT = 95.0f;
constexpr float PAD_CYL_RAD_BIG_SQ = (float)(208.0 * 208.0);
constexpr float PAD_CYL_RAD_SMALL_SQ = (float)(144.0 * 144.0);
constexpr float PAD_BOX_HEIGHT = 64.0f;
constexpr float PAD_BOX_RAD_BIG = 160.0f;
constexpr float PAD_BOX_RAD_SMALL = 120.0f;
constexpr float PAD_AMOUNT_BIG = 100.0f;
constexpr float PAD_AMOUNT_SMALL = 12.0f;
// dBoxBox
constexpr float SIMD_EPSILON = 1.19209290e-07f;
constexpr float FUDGE_FACTOR = 1.05f;
constexpr float FUDGE2 = 1.0e-5f;

constexpr int MAXC = 8;  // Params.teams slots
constexpr int NPADS = 34;
constexpr int NPLANES = 15;
constexpr int NTRUE_PLANES = 4;
constexpr float ARENA_HEIGHT = 2048.0f;
// floor / ceiling grid clip: -fillet inset + 1 uu (facet_arena.sheet_clip_ok)
__device__ const float SHEET_CLIP[2] = {(float)(-152.0 + 1.0),
                                        (float)(-256.0 + 1.0)};
constexpr int NRESPAWN = 4;

// Game modes on the soccar arena, in ctick.GAME_MODES order, and their
// constants (constants.py Heatseeker, Snowday; RLConst.h:151-185), each the
// float the plain version's Python scalar becomes.
enum { MODE_SOCCAR = 0, MODE_HEATSEEKER = 1, MODE_SNOWDAY = 2 };
constexpr double PI_D = 3.14159265358979323846;
constexpr float TWO_PI_F = (float)(PI_D * 2);
constexpr float HALF_PI_F = (float)(PI_D / 2);
constexpr float UE3_TO_INTS = (float)(32768.0 / PI_D);
constexpr float UE3_BACK = (float)((1.0 / (32768.0 / PI_D)) * 4.0);
constexpr float HS_TARGET_Y = 5120.0f;
constexpr float HS_TARGET_Z = 320.0f;
constexpr float HS_MAX_SPEED = 4600.0f;
constexpr float HS_HORIZONTAL_BLEND = 1.45f;
constexpr float HS_VERTICAL_BLEND = 0.78f;
constexpr float HS_SPEED_BLEND = 0.3f;
constexpr float HS_MAX_TURN_PITCH = (float)(7000.0 * PI_D / 32768.0);
constexpr float HS_TARGET_SPEED_INCREMENT = 85.0f;
constexpr float HS_MIN_SPEEDUP_INTERVAL = 1.0f;
constexpr float HS_WALL_BOUNCE_NORMAL = 0.5f;
constexpr float HS_WALL_BOUNCE_Y = (float)(5120.0 - 300.0);
constexpr float HS_WALL_BOUNCE_FORCE_SCALE = (float)(1.0 / 3.0);
constexpr float HS_WALL_BOUNCE_UP = 0.3f;
constexpr float HS_WALL_BOUNCE_KEEP = (float)(1.0 - 0.3);
constexpr float PUCK_RADIUS = 114.25f;
constexpr float PUCK_HALF_HEIGHT = (float)(62.5 / 2);

constexpr int WALL_YN = 4, WALL_YP = 5, GOAL_XN = 10, GOAL_XP = 11,
              GOAL_CEIL = 12, NET_YN = 13, NET_YP = 14;

enum {
  THROTTLE, STEER, PITCH, YAW, ROLL, JUMP, BOOST, HANDBRAKE
};

enum {
  CV_DRIVE, CV_STEER, CV_PS_STEER, CV_NON_STICKY, CV_LAT, CV_LONG, CV_HB_LAT,
  CV_HB_LONG, CV_EXTRA_IMPULSE, CV_BUMP_GROUND, CV_BUMP_AIR, CV_BUMP_UP,
  NCURVES
};

// Per-arena configuration, all 4-byte floats.  ops/arena_step.py
// (`pack_params`) writes the same fields in the same order; the launcher
// refuses a buffer of another size.
struct Params {
  float teams[MAXC];
  float dt;
  float gravity_z, jump_accel, jump_immediate_force, boost_accel_ground,
      boost_accel_air, boost_used_per_second, respawn_delay,
      bump_cooldown_time, boost_pad_cooldown_big, boost_pad_cooldown_small,
      car_spawn_boost_amount, ball_hit_extra_force_scale, bump_force_scale,
      ball_radius, ball_max_speed, unlimited_flips, unlimited_double_jumps,
      demo_mode, enable_team_demos, car_world_restitution,
      car_world_friction;
  // values the plain version folds in double precision on the host
  float inv_car_mass, inv_ball_mass, friction_scale, sus_dv_scale,
      ball_drag_factor, flip_z_damp_factor, car_world_break, car_ball_touch,
      ball_world_break, ball_inv_inertia, ball_world_restitution,
      ball_world_friction, goal_threshold, neg_ball_r_bt, turn_erp_dt;
  float half_extents[3], hitbox_offset[3], inv_i_local[3], he_eff_bt[3],
      pad_he[3];
  float wheel_offsets[4][3], wheel_radii[4], sus_rest[4], sus_force_scale[4];
  // per-wheel lengths the plain version sums in double precision
  float ray_len[4], sus_min[4], sus_max[4], push_thresh[4];
  float planes[NPLANES][4];
  float true_plane[NPLANES];
  float corners_local[8][3];
  float pad_locs[NPADS][3];
  float pad_is_big[NPADS];
  float respawn_table[NRESPAWN][3];
  Curve curves[NCURVES];
  // full fidelity: the facet arena (use_mesh) and dynamic wheel rays, as
  // 0/1; values folded in double precision like the plain version's
  float use_mesh, dynamic_rays;
  float erp2_over_dt, ball_radius_sq, box_dist_m;
  float he_core[3];                 // half extents - mesh margin
  float core_corners_local[8][3];   // offset + signs * he_core
  facets::Tables facets;
  // the game mode (MODE_*) and the snowday puck's values folded in double
  // precision like the plain version's: its contact break gap, inverse
  // inertia across and along its axis, and ground-stick speed per tick
  float game_mode;
  float snow_break_gap, snow_inv_i_perp, snow_inv_i_axis, snow_stick;
};

// The tables of Params that lanes index divergently, copied into shared
// memory once per block.
struct Tabs {
  facets::Tables facets;
  Curve curves[NCURVES];
  float planes[NPLANES][4];
  facets::Extent extent;  // of the profile bands, for the side culls
};

// Launch shape: LANES lanes per arena (a warp, or a half-warp), APB arenas
// per block.
#ifndef ARENA_STEP_LANES
#define ARENA_STEP_LANES 32
#endif
#ifndef ARENA_STEP_APB
#define ARENA_STEP_APB 4
#endif
constexpr int LANES = ARENA_STEP_LANES;
constexpr int APB = ARENA_STEP_APB;
constexpr int THREADS = LANES * APB;
static_assert(LANES == 32 || LANES == 16 || LANES == 1, "lanes per arena");

// ---------------------------------------------------------------------------
// Buffer layout.  f32 rows: 72 per-car fields x C, then 21 ball rows, then
// 34 pad cooldowns.  i32 rows: 3 per-car fields x C, tick_count, 34 pad
// locks.  u8 rows: 19 per-car fields x C, goal_scored, 34 pad flags.
// ops/arena_step.py (`_f32_rows` etc.) builds the same order.

enum CarF {
  F_JUMP_TIME, F_FLIP_TIME, F_AIR_TIME, F_AIR_TIME_SINCE_JUMP, F_BOOST,
  F_TIME_SPENT_BOOSTING, F_SUPERSONIC_TIME, F_HANDBRAKE_VAL,
  F_AUTO_FLIP_TIMER, F_AUTO_FLIP_TORQUE_SCALE, F_CAR_CONTACT_COOLDOWN,
  F_DEMO_RESPAWN_TIMER,
  F_POS = 12, F_VEL = 15, F_ANG_VEL = 18, F_FLIP_REL_TORQUE = 21,
  F_WORLD_CONTACT_NORMAL = 24, F_BALL_HIT_REL_POS = 27,
  F_BALL_HIT_BALL_POS = 30, F_BALL_HIT_EXTRA_VEL = 33, F_ROT = 36,
  F_LAST_CONTROLS = 45, F_CONTROLS = 53, F_WC_STEER = 61,
  F_WC_ENGINE = 62, F_WC_BRAKE = 63, F_WC_LAT = 64, F_WC_LONG = 68,
  CAR_F = 72
};
enum BallF {
  B_POS = 0, B_VEL = 3, B_ANG_VEL = 6, B_ROT = 9, B_HS = 18, BALL_F = 21
};
enum CarI { I_CONTACT_OTHER, I_HIT_TICK, I_HIT_EXTRA_TICK, CAR_I = 3 };
enum CarB {
  U_ON_GROUND, U_HAS_JUMPED, U_HAS_DOUBLE_JUMPED, U_HAS_FLIPPED,
  U_IS_FLIPPING, U_IS_JUMPING, U_IS_SUPERSONIC, U_IS_AUTO_FLIPPING,
  U_HAS_WORLD_CONTACT, U_IS_DEMOED, U_BALL_HIT_VALID, U_WHEELS = 11,
  U_STEP_BUMP = 15, U_STEP_BUMPED = 16, U_STEP_DEMO = 17,
  U_STEP_DEMOED = 18, CAR_U = 19
};

struct Car {
  V3 pos, vel, ang_vel, flip_rel_torque, world_contact_normal,
      ball_hit_rel_pos, ball_hit_ball_pos, ball_hit_extra_vel;
  M3 rot;
  float jump_time, flip_time, air_time, air_time_since_jump, boost,
      time_spent_boosting, supersonic_time, handbrake_val, auto_flip_timer,
      auto_flip_torque_scale, car_contact_cooldown, demo_respawn_timer;
  float last_controls[8], controls[8];
  float wc_steer, wc_engine, wc_brake, wc_lat[4], wc_long[4];
  int contact_other_id, hit_tick, hit_extra_tick;
  int wheels[4];
  bool on_ground, has_jumped, has_double_jumped, has_flipped, is_flipping,
      is_jumping, is_supersonic, is_auto_flipping, has_world_contact,
      is_demoed, ball_hit_valid, step_bump, step_bumped, step_demo,
      step_demoed;
};

template <int NC>
struct Arena {
  Car car[NC];
  V3 bpos, bvel, bang;
  M3 brot;
  float hs[3];
  float pad_cd[NPADS];
  int pad_locked[NPADS];
  bool pad_active[NPADS];
  int tick_count;
  bool goal_scored;
};

struct Bufs {
  const float* f_in;
  const int32_t* i_in;
  const uint8_t* u_in;
  float* f_out;
  int32_t* i_out;
  uint8_t* u_out;
  const float* controls;   // (8, C, E)
  const int32_t* respawn;  // (C, E)
  int E;
};

__device__ __forceinline__ V3 ld3(const float* b, int r, int E, int e,
                                  int NC) {
  return v3(b[(size_t)(r)*E + e], b[(size_t)(r + NC) * E + e],
            b[(size_t)(r + 2 * NC) * E + e]);
}
__device__ __forceinline__ void st3(float* b, int r, int E, int e, int NC,
                                    V3 v) {
  b[(size_t)(r)*E + e] = v.x;
  b[(size_t)(r + NC) * E + e] = v.y;
  b[(size_t)(r + 2 * NC) * E + e] = v.z;
}

// Unpacks car c of arena e (B may point at a block's shared staging, with
// B.E its stride).
template <int NC>
__device__ void load_car(Car& k, const Bufs& B, int e, int c) {
  const int E = B.E;
  const float* F = B.f_in;
#define FR(field, c) F[(size_t)((field) * NC + (c)) * E + e]
  {
    k.jump_time = FR(F_JUMP_TIME, c);
    k.flip_time = FR(F_FLIP_TIME, c);
    k.air_time = FR(F_AIR_TIME, c);
    k.air_time_since_jump = FR(F_AIR_TIME_SINCE_JUMP, c);
    k.boost = FR(F_BOOST, c);
    k.time_spent_boosting = FR(F_TIME_SPENT_BOOSTING, c);
    k.supersonic_time = FR(F_SUPERSONIC_TIME, c);
    k.handbrake_val = FR(F_HANDBRAKE_VAL, c);
    k.auto_flip_timer = FR(F_AUTO_FLIP_TIMER, c);
    k.auto_flip_torque_scale = FR(F_AUTO_FLIP_TORQUE_SCALE, c);
    k.car_contact_cooldown = FR(F_CAR_CONTACT_COOLDOWN, c);
    k.demo_respawn_timer = FR(F_DEMO_RESPAWN_TIMER, c);
    k.pos = ld3(F, F_POS * NC + c, E, e, NC);
    k.vel = ld3(F, F_VEL * NC + c, E, e, NC);
    k.ang_vel = ld3(F, F_ANG_VEL * NC + c, E, e, NC);
    k.flip_rel_torque = ld3(F, F_FLIP_REL_TORQUE * NC + c, E, e, NC);
    k.world_contact_normal =
        ld3(F, F_WORLD_CONTACT_NORMAL * NC + c, E, e, NC);
    k.ball_hit_rel_pos = ld3(F, F_BALL_HIT_REL_POS * NC + c, E, e, NC);
    k.ball_hit_ball_pos = ld3(F, F_BALL_HIT_BALL_POS * NC + c, E, e, NC);
    k.ball_hit_extra_vel = ld3(F, F_BALL_HIT_EXTRA_VEL * NC + c, E, e, NC);
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) k.rot.m[i][j] = FR(F_ROT + 3 * i + j, c);
    for (int i = 0; i < 8; ++i) {
      k.last_controls[i] = FR(F_LAST_CONTROLS + i, c);
      k.controls[i] = FR(F_CONTROLS + i, c);
    }
    k.wc_steer = FR(F_WC_STEER, c);
    k.wc_engine = FR(F_WC_ENGINE, c);
    k.wc_brake = FR(F_WC_BRAKE, c);
    for (int w = 0; w < 4; ++w) {
      k.wc_lat[w] = FR(F_WC_LAT + w, c);
      k.wc_long[w] = FR(F_WC_LONG + w, c);
    }
    const int32_t* I = B.i_in;
    k.contact_other_id = I[(size_t)(I_CONTACT_OTHER * NC + c) * E + e];
    k.hit_tick = I[(size_t)(I_HIT_TICK * NC + c) * E + e];
    k.hit_extra_tick = I[(size_t)(I_HIT_EXTRA_TICK * NC + c) * E + e];
    const uint8_t* U = B.u_in;
#define UR(field) (U[(size_t)((field) * NC + c) * E + e] != 0)
    k.on_ground = UR(U_ON_GROUND);
    k.has_jumped = UR(U_HAS_JUMPED);
    k.has_double_jumped = UR(U_HAS_DOUBLE_JUMPED);
    k.has_flipped = UR(U_HAS_FLIPPED);
    k.is_flipping = UR(U_IS_FLIPPING);
    k.is_jumping = UR(U_IS_JUMPING);
    k.is_supersonic = UR(U_IS_SUPERSONIC);
    k.is_auto_flipping = UR(U_IS_AUTO_FLIPPING);
    k.has_world_contact = UR(U_HAS_WORLD_CONTACT);
    k.is_demoed = UR(U_IS_DEMOED);
    k.ball_hit_valid = UR(U_BALL_HIT_VALID);
    for (int w = 0; w < 4; ++w) k.wheels[w] = UR(U_WHEELS + w) ? 1 : 0;
    // the per-step latches start cleared (ctick.step)
    k.step_bump = k.step_bumped = k.step_demo = k.step_demoed = false;
#undef UR
  }
#undef FR
}

template <int NC>
__device__ void load_arena(Arena<NC>& a, const Bufs& B, int e) {
  const int E = B.E;
  const float* G = B.f_in + (size_t)CAR_F * NC * E;
#define GR(r) G[(size_t)(r) * E + e]
  a.bpos = v3(GR(B_POS), GR(B_POS + 1), GR(B_POS + 2));
  a.bvel = v3(GR(B_VEL), GR(B_VEL + 1), GR(B_VEL + 2));
  a.bang = v3(GR(B_ANG_VEL), GR(B_ANG_VEL + 1), GR(B_ANG_VEL + 2));
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) a.brot.m[i][j] = GR(B_ROT + 3 * i + j);
  for (int i = 0; i < 3; ++i) a.hs[i] = GR(B_HS + i);
  for (int p = 0; p < NPADS; ++p) a.pad_cd[p] = GR(BALL_F + p);
#undef GR
  const int32_t* I = B.i_in + (size_t)CAR_I * NC * E;
  a.tick_count = I[e];
  for (int p = 0; p < NPADS; ++p) a.pad_locked[p] = I[(size_t)(1 + p) * E + e];
  const uint8_t* U = B.u_in + (size_t)CAR_U * NC * E;
  a.goal_scored = false;  // cleared per step (ctick.step)
  for (int p = 0; p < NPADS; ++p)
    a.pad_active[p] = U[(size_t)(1 + p) * E + e] != 0;
}

template <int NC>
__device__ void store_car(const Car& k, const Bufs& B, int e, int c) {
  const int E = B.E;
  float* F = B.f_out;
#define FW(field, c) F[(size_t)((field) * NC + (c)) * E + e]
  {
    FW(F_JUMP_TIME, c) = k.jump_time;
    FW(F_FLIP_TIME, c) = k.flip_time;
    FW(F_AIR_TIME, c) = k.air_time;
    FW(F_AIR_TIME_SINCE_JUMP, c) = k.air_time_since_jump;
    FW(F_BOOST, c) = k.boost;
    FW(F_TIME_SPENT_BOOSTING, c) = k.time_spent_boosting;
    FW(F_SUPERSONIC_TIME, c) = k.supersonic_time;
    FW(F_HANDBRAKE_VAL, c) = k.handbrake_val;
    FW(F_AUTO_FLIP_TIMER, c) = k.auto_flip_timer;
    FW(F_AUTO_FLIP_TORQUE_SCALE, c) = k.auto_flip_torque_scale;
    FW(F_CAR_CONTACT_COOLDOWN, c) = k.car_contact_cooldown;
    FW(F_DEMO_RESPAWN_TIMER, c) = k.demo_respawn_timer;
    st3(F, F_POS * NC + c, E, e, NC, k.pos);
    st3(F, F_VEL * NC + c, E, e, NC, k.vel);
    st3(F, F_ANG_VEL * NC + c, E, e, NC, k.ang_vel);
    st3(F, F_FLIP_REL_TORQUE * NC + c, E, e, NC, k.flip_rel_torque);
    st3(F, F_WORLD_CONTACT_NORMAL * NC + c, E, e, NC, k.world_contact_normal);
    st3(F, F_BALL_HIT_REL_POS * NC + c, E, e, NC, k.ball_hit_rel_pos);
    st3(F, F_BALL_HIT_BALL_POS * NC + c, E, e, NC, k.ball_hit_ball_pos);
    st3(F, F_BALL_HIT_EXTRA_VEL * NC + c, E, e, NC, k.ball_hit_extra_vel);
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) FW(F_ROT + 3 * i + j, c) = k.rot.m[i][j];
    for (int i = 0; i < 8; ++i) {
      FW(F_LAST_CONTROLS + i, c) = k.last_controls[i];
      FW(F_CONTROLS + i, c) = k.controls[i];
    }
    FW(F_WC_STEER, c) = k.wc_steer;
    FW(F_WC_ENGINE, c) = k.wc_engine;
    FW(F_WC_BRAKE, c) = k.wc_brake;
    for (int w = 0; w < 4; ++w) {
      FW(F_WC_LAT + w, c) = k.wc_lat[w];
      FW(F_WC_LONG + w, c) = k.wc_long[w];
    }
    int32_t* I = B.i_out;
    I[(size_t)(I_CONTACT_OTHER * NC + c) * E + e] = k.contact_other_id;
    I[(size_t)(I_HIT_TICK * NC + c) * E + e] = k.hit_tick;
    I[(size_t)(I_HIT_EXTRA_TICK * NC + c) * E + e] = k.hit_extra_tick;
    uint8_t* U = B.u_out;
#define UW(field, v) U[(size_t)((field) * NC + c) * E + e] = (uint8_t)(v)
    UW(U_ON_GROUND, k.on_ground);
    UW(U_HAS_JUMPED, k.has_jumped);
    UW(U_HAS_DOUBLE_JUMPED, k.has_double_jumped);
    UW(U_HAS_FLIPPED, k.has_flipped);
    UW(U_IS_FLIPPING, k.is_flipping);
    UW(U_IS_JUMPING, k.is_jumping);
    UW(U_IS_SUPERSONIC, k.is_supersonic);
    UW(U_IS_AUTO_FLIPPING, k.is_auto_flipping);
    UW(U_HAS_WORLD_CONTACT, k.has_world_contact);
    UW(U_IS_DEMOED, k.is_demoed);
    UW(U_BALL_HIT_VALID, k.ball_hit_valid);
    for (int w = 0; w < 4; ++w) UW(U_WHEELS + w, k.wheels[w] != 0);
    UW(U_STEP_BUMP, k.step_bump);
    UW(U_STEP_BUMPED, k.step_bumped);
    UW(U_STEP_DEMO, k.step_demo);
    UW(U_STEP_DEMOED, k.step_demoed);
#undef UW
  }
#undef FW
}

template <int NC>
__device__ void store_arena(const Arena<NC>& a, const Bufs& B, int e) {
  const int E = B.E;
  float* G = B.f_out + (size_t)CAR_F * NC * E;
#define GW(r) G[(size_t)(r) * E + e]
  GW(B_POS) = a.bpos.x; GW(B_POS + 1) = a.bpos.y; GW(B_POS + 2) = a.bpos.z;
  GW(B_VEL) = a.bvel.x; GW(B_VEL + 1) = a.bvel.y; GW(B_VEL + 2) = a.bvel.z;
  GW(B_ANG_VEL) = a.bang.x; GW(B_ANG_VEL + 1) = a.bang.y;
  GW(B_ANG_VEL + 2) = a.bang.z;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) GW(B_ROT + 3 * i + j) = a.brot.m[i][j];
  for (int i = 0; i < 3; ++i) GW(B_HS + i) = a.hs[i];
  for (int p = 0; p < NPADS; ++p) GW(BALL_F + p) = a.pad_cd[p];
#undef GW
  int32_t* I = B.i_out + (size_t)CAR_I * NC * E;
  I[e] = a.tick_count;
  for (int p = 0; p < NPADS; ++p) I[(size_t)(1 + p) * E + e] = a.pad_locked[p];
  uint8_t* U = B.u_out + (size_t)CAR_U * NC * E;
  U[e] = (uint8_t)a.goal_scored;
  for (int p = 0; p < NPADS; ++p)
    U[(size_t)(1 + p) * E + e] = (uint8_t)a.pad_active[p];
}

// ---------------------------------------------------------------------------
// Arena planes (ctick.plane_validity, _raycast, _restitution_rhs,
// _contact_vs_static)

__device__ __forceinline__ void plane_validity(V3 pos, bool valid[NPLANES]) {
  bool in_goal_xz = (fabsf(pos.x) < GOAL_HALF_WIDTH) & (pos.z < GOAL_HEIGHT);
  bool behind = fabsf(pos.y) > ARENA_EXTENT_Y;
  for (int p = 0; p < NPLANES; ++p) valid[p] = true;
  valid[WALL_YN] = !(in_goal_xz & (pos.y < 0.f));
  valid[WALL_YP] = !(in_goal_xz & (pos.y > 0.f));
  valid[GOAL_XN] = behind;
  valid[GOAL_XP] = behind;
  valid[GOAL_CEIL] = behind;
  valid[NET_YN] = pos.y < 0.f;
  valid[NET_YP] = pos.y > 0.f;
}

__device__ __forceinline__ float plane_dist(const float* pl, V3 p) {
  return pl[0] * p.x + pl[1] * p.y + pl[2] * p.z + pl[3];
}

__device__ __forceinline__ float comp(V3 v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : v.z);
}

__device__ __forceinline__ V3 plane_n(const float* pl) {
  return v3(pl[0], pl[1], pl[2]);
}

// The full-fidelity flags.  -DARENA_STEP_PLANE_ONLY compiles their branches
// out: a measurement build of what carrying them costs the plane arena
// (kernel_variants.py).
#ifdef ARENA_STEP_PLANE_ONLY
#define FLAG_ON(x) false
#define GAME_MODE(P) MODE_SOCCAR
#else
#define FLAG_ON(x) ((x) != 0.f)
#define GAME_MODE(P) ((int)(P).game_mode)
#endif

// Planes in the world: in mesh mode only the 4 true static planes, which
// lead the table (floor, ceiling, the two side walls); the facet arena
// covers the rest.
__device__ __forceinline__ int world_planes(const Params& P) {
  return FLAG_ON(P.use_mesh) ? NTRUE_PLANES : NPLANES;
}

__device__ void raycast(const Params& P, const Tabs& Tb, V3 start, V3 dir,
                        float max_len, bool& hit, float& dist, V3& n) {
  bool valid[NPLANES];
  plane_validity(start, valid);
  const float big = 1e30f;
  float t_min = big;
  n = vzero();
  for (int p = 0; p < world_planes(P); ++p) {
    const float* pl = Tb.planes[p];
    float dist_p = plane_dist(pl, start);
    float denom = -(dir.x * pl[0] + dir.y * pl[1] + dir.z * pl[2]);
    float t = denom > 1e-6f ? dist_p / fmaxf(denom, 1e-6f) : big;
    t = (valid[p] & (t >= 0.f)) ? t : big;
    if (t < t_min) n = plane_n(pl);
    t_min = fminf(t_min, t);
  }
  hit = t_min <= max_len;
  dist = hit ? t_min : max_len;
}

__device__ __forceinline__ float restitution_rhs(float rel_vel, float coef) {
  float rest = coef * -rel_vel;
  rest = fabsf(rel_vel) < 0.2f ? 0.f : rest;
  return fmaxf(rest, 0.f);
}

// One body against static geometry; returns dv (bt) and dw.
__device__ void contact_vs_static(V3 vel_bt, V3 ang_vel, V3 r, V3 n,
                                  float inv_mass, const M3& iw, float rest_c,
                                  float fric_c, V3 vel_pre_bt, V3 wpre,
                                  int iterations, V3& dv, V3& dw) {
  V3 vel_at = vel_bt + cross(ang_vel, r);
  V3 ang_comp = matvec(iw, cross(r, n));
  float denom = fmaxf(inv_mass + dot(n, cross(ang_comp, r)), 1e-12f);
  float rel_rest = dot(n, vel_pre_bt + cross(wpre, r));
  float rest = restitution_rhs(rel_rest, rest_c);
  V3 tang = vel_at - n * dot(n, vel_at);
  float t_len = norm(tang);
  V3 t_dir = t_len > 1e-9f ? tang * (1.0f / fmaxf(t_len, 1e-9f)) : vzero();
  V3 t_ang = matvec(iw, cross(r, t_dir));
  float t_denom = fmaxf(inv_mass + dot(t_dir, cross(t_ang, r)), 1e-12f);
  dv = vzero();
  dw = vzero();
  float j_n = 0.f, j_t = 0.f;
  for (int it = 0; it < iterations; ++it) {
    V3 v_at = (vel_bt + dv) + cross(ang_vel + dw, r);
    float dj = (rest - dot(n, v_at)) / denom;
    float new_acc = fmaxf(j_n + dj, 0.f);
    V3 imp = n * (new_acc - j_n);
    dv = dv + imp * inv_mass;
    dw = dw + matvec(iw, cross(r, imp));
    j_n = new_acc;
    v_at = (vel_bt + dv) + cross(ang_vel + dw, r);
    float djt = -dot(t_dir, v_at) / t_denom;
    float lim = fric_c * j_n;
    float new_t = clampf(j_t + djt, -lim, lim);
    V3 imp_t = t_dir * (new_t - j_t);
    dv = dv + imp_t * inv_mass;
    dw = dw + matvec(iw, cross(r, imp_t));
    j_t = new_t;
  }
}

// ---------------------------------------------------------------------------
// Suspension raycasts + wheel friction (ctick._wheel_raycasts,
// _calc_friction_impulses, _apply_suspension, _apply_friction_impulses,
// _update_wheels)

struct Rays {
  int hit[4], in_world[4];
  int gi[4];  // ground body: -1 the world (or none), -2 the ball, j car j
  V3 cp[4], n[4], hard[4];
  float susp_len[4], susp_rel_vel[4], clipped_inv[4], extra_push[4];
};

// Ray vs sphere (ctick._ray_sphere): hit, and t (max_len where none).
__device__ __forceinline__ bool ray_sphere(V3 o, V3 d, float max_len,
                                           V3 center, float radius_sq,
                                           float& t) {
  V3 oc = o - center;
  float b = dot(oc, d);
  float c2 = dot(oc, oc) - radius_sq;
  float disc = b * b - c2;
  float tt = -b - sqrtf(fmaxf(disc, 0.f));
  bool hit = (disc > 0.f) & (c2 > 0.f) & (tt >= 0.f) & (tt <= max_len);
  t = hit ? tt : max_len;
  return hit;
}

// Ray vs oriented box, slab method (ctick._ray_obb): hit, t, entry normal.
__device__ __forceinline__ bool ray_obb(V3 o, V3 d, float max_len, V3 center,
                                        const M3& R, const float* he,
                                        float& t, V3& n) {
  V3 lo = mat_t_vec(R, o - center);
  V3 ld = mat_t_vec(R, d);
  float tmin = -INFINITY, tmax = INFINITY, sign = 0.f;
  int entry_ax = 0;
  bool inside_all = true;
  for (int ax = 0; ax < 3; ++ax) {
    float l = comp(lo, ax), dd = comp(ld, ax);
    float safe = fabsf(dd) > 1e-9f ? dd : 1e-9f;
    float t1 = (-he[ax] - l) / safe;
    float t2 = (he[ax] - l) / safe;
    float tmin_ax = fminf(t1, t2), tmax_ax = fmaxf(t1, t2);
    bool inside = (fabsf(l) <= he[ax]) | (fabsf(dd) > 1e-9f);
    inside_all = inside_all & inside;
    if (tmin_ax > tmin) { entry_ax = ax; sign = -signf(dd); }
    tmin = fmaxf(tmin, tmin_ax);
    tmax = fminf(tmax, inside ? tmax_ax : INFINITY);
  }
  bool hit = (tmax >= tmin) & (tmax >= 0.f) & (tmin >= 0.f) &
             (tmin <= max_len) & inside_all;
  n = matvec(R, v3(entry_ax == 0 ? sign : 0.f, entry_ax == 1 ? sign : 0.f,
                   entry_ax == 2 ? sign : 0.f));
  t = hit ? tmin : max_len;
  return hit;
}

__device__ __forceinline__ V3 box_center(const Params& P, const Car& k) {
  return k.pos + matvec(k.rot, v3(P.hitbox_offset[0], P.hitbox_offset[1],
                                  P.hitbox_offset[2]));
}

// Wheel w of car c: its suspension ray against the world planes, the facet
// arena in mesh mode, and with dynamic rays the ball and the other live
// cars' hitboxes (ctick._wheel_raycasts, one wheel).
template <int NC>
__device__ void wheel_ray(const Params& P, const Tabs& Tb,
                          const Arena<NC>& a, int c, int w, const int* alive,
                          const M3& iw, Rays& rc) {
  const Car& k = a.car[c];
  const bool mesh = FLAG_ON(P.use_mesh), dyn = FLAG_ON(P.dynamic_rays);
  V3 up = up_of(k.rot);
  V3 wheel_dir = -up;
  float radius = P.wheel_radii[w];
  float ray_len = P.ray_len[w];
  V3 hard = k.pos + matvec(k.rot, v3(P.wheel_offsets[w][0],
                                     P.wheel_offsets[w][1],
                                     P.wheel_offsets[w][2]));
  bool hit;
  float dist;
  V3 n;
  raycast(P, Tb, hard, wheel_dir, ray_len, hit, dist, n);
  if (mesh) {
    bool fhit;
    float fdist;
    V3 fn;
    facets::raycast(Tb.facets, Tb.extent, hard, wheel_dir, ray_len, fhit,
                    fdist, fn);
    bool closer = fhit & (fdist < dist);
    hit = hit | fhit;
    if (closer) { dist = fdist; n = fn; }
  }
  int gi = -1;
  if (dyn) {
    float bt;
    bool bhit = ray_sphere(hard, wheel_dir, ray_len, a.bpos,
                           P.ball_radius_sq, bt);
    if (bhit & (bt < dist)) {
      hit = true;
      dist = bt;
      n = normalize((hard + wheel_dir * bt) - a.bpos);
      gi = -2;
    }
    for (int j = 0; j < NC; ++j) {
      if (j == c || !alive[j]) continue;
      float ot;
      V3 on;
      bool ohit = ray_obb(hard, wheel_dir, ray_len, box_center(P, a.car[j]),
                          a.car[j].rot, P.half_extents, ot, on);
      if (ohit & (ot < dist)) {
        hit = true;
        dist = ot;
        n = on;
        gi = j;
      }
    }
  }
  bool in_world = hit & (gi == -1);
  V3 cp = hard + wheel_dir * dist;
  float trace_len = dot(hard - cp, up);
  float susp_len = clampf(trace_len - radius, P.sus_min[w], P.sus_max[w]);
  susp_len = hit ? susp_len : P.sus_max[w];
  V3 rel = (cp - k.pos) * UU_TO_BT;
  V3 vel_at = k.vel * UU_TO_BT + cross(k.ang_vel, rel);
  float proj_vel = dot(n, vel_at);
  float denom = dot(n, up);
  bool good = denom > 0.1f;
  float inv = good ? 1.0f / fmaxf(denom, 0.1f) : 10.0f;
  float susp_rel_vel = (hit & good) ? proj_vel * inv : 0.f;
  float clipped_inv = hit ? (good ? inv : 10.0f) : 1.0f;
  float push_thresh = P.push_thresh[w];
  float delta = (trace_len - push_thresh) * UU_TO_BT;
  // extra pushback only against static geometry (btVehicleRL.cpp:184)
  bool needs = in_world & (trace_len < push_thresh);
  float pos_err = 0.2f * -delta / P.dt;
  float vel_err = -proj_vel;
  float ang_term = dot(cross(matvec(iw, cross(rel, n)), rel), n);
  float denom0 = P.inv_car_mass + ang_term;
  float imp = fmaxf((pos_err + vel_err) / fmaxf(denom0, 1e-9f), 0.f);
  rc.hit[w] = hit ? 1 : 0;
  rc.in_world[w] = in_world ? 1 : 0;
  rc.gi[w] = gi;
  rc.cp[w] = cp;
  rc.n[w] = hit ? n : up;
  rc.hard[w] = hard;
  rc.susp_len[w] = susp_len;
  rc.susp_rel_vel[w] = susp_rel_vel;
  rc.clipped_inv[w] = clipped_inv;
  rc.extra_push[w] = needs ? imp / 4.0f : 0.f;
}

// The previous tick's friction impulse of wheel w of car c.  With dynamic
// rays a wheel on the ball or another car uses that body's velocity and
// its mass and inertia (btVehicleRL.cpp:321-387), sampling the ground
// body's point velocity at the car-relative offset for rolling friction,
// as the reference does (ctick._calc_friction_impulses, one wheel).
template <int NC>
__device__ V3 friction_impulse(const Params& P, const Arena<NC>& a, int c,
                               int w, const Rays& rc, const M3* iw) {
  const Car& k = a.car[c];
  const bool dyn_rays = FLAG_ON(P.dynamic_rays);
  V3 up = up_of(k.rot);
  V3 rightv = right_of(k.rot);
  float steer = w < 2 ? k.wc_steer : 0.f;
  float cs = cosf(steer), sn = sinf(steer);
  V3 axle0 = rightv * cs + cross(up, rightv) * sn;
  V3 n = rc.n[w];
  V3 axle = normalize(axle0 - n * dot(axle0, n));
  V3 fwd_dir = normalize(cross(n, axle));
  V3 rel = (rc.cp[w] - k.pos) * UU_TO_BT;
  V3 vel_at = k.vel * UU_TO_BT + cross(k.ang_vel, rel);
  const int gi = rc.gi[w];
  V3 v2_at = vzero(), v2_quirk = vzero(), r_b = vzero();
  float g_inv_mass = 0.f;
  if (dyn_rays) {
    V3 g_vel = vzero(), g_ang = vzero(), g_pos = vzero();
    if (gi == -2) {
      g_vel = a.bvel; g_ang = a.bang; g_pos = a.bpos;
      g_inv_mass = P.inv_ball_mass;
    } else if (gi >= 0) {
      g_vel = a.car[gi].vel; g_ang = a.car[gi].ang_vel;
      g_pos = a.car[gi].pos;
      g_inv_mass = P.inv_car_mass;
    }
    r_b = (rc.cp[w] - g_pos) * UU_TO_BT;
    if (gi != -1) {
      v2_at = g_vel * UU_TO_BT + cross(g_ang, r_b);
      v2_quirk = g_vel * UU_TO_BT + cross(g_ang, rel);
    }
  }
  float rel_vel_side = dot(vel_at - v2_at, axle);
  float ang_term = dot(cross(matvec(iw[c], cross(rel, axle)), rel), axle);
  float jac = P.inv_car_mass + ang_term + g_inv_mass;
  if (dyn_rays) {
    V3 rb_cross = cross(r_b, axle);
    float g_ang_term = 0.f;
    if (gi == -2)
      g_ang_term = dot(cross(rb_cross * P.ball_inv_inertia, r_b), axle);
    else if (gi >= 0)
      g_ang_term = dot(cross(matvec(iw[gi], rb_cross), r_b), axle);
    jac = jac + (gi != -1 ? g_ang_term : 0.f);
  }
  float side = -SIDE_FRICTION_DAMPING * rel_vel_side / fmaxf(jac, 1e-9f);
  float rel_vel_fwd = dot(vel_at - v2_quirk, fwd_dir);
  float brake = k.wc_brake, engine = k.wc_engine;
  float rolling_brake = clampf(-rel_vel_fwd * ROLLING_FRICTION_SCALE_MAGIC,
                               -brake, brake);
  float rolling = engine == 0.f ? (brake > 0.f ? rolling_brake : 0.f)
                                : -engine / P.friction_scale;
  V3 total = fwd_dir * (rolling * k.wc_long[w]) +
             axle * (side * k.wc_lat[w]);
  V3 imp = total * P.friction_scale;
  return rc.hit[w] ? imp : vzero();
}

__device__ void apply_suspension(const Params& P, Car& k, const Rays& rc,
                                 const M3& iw) {
  V3 dv = vzero(), torque = vzero();
  for (int w = 0; w < 4; ++w) {
    float spring = (P.sus_rest[w] - rc.susp_len[w]) * UU_TO_BT *
                   SUS_STIFFNESS * rc.clipped_inv[w];
    float damping = rc.susp_rel_vel[w] < 0.f ? DAMP_COMPRESSION
                                             : DAMP_RELAXATION;
    float force = (spring - damping * rc.susp_rel_vel[w]) *
                  P.sus_force_scale[w];
    force = fmaxf(force, 0.f);
    force = rc.hit[w] ? force : 0.f;
    float base = force * P.dt + rc.extra_push[w];
    V3 imp = rc.n[w] * base;
    V3 rel = (rc.cp[w] - k.pos) * UU_TO_BT;
    dv = dv + imp;
    torque = torque + cross(rel, imp);
  }
  k.vel = k.vel + dv * P.sus_dv_scale;
  k.ang_vel = k.ang_vel + matvec(iw, torque);
}

__device__ void apply_friction_impulses(const Params& P, Car& k,
                                        const Rays& rc, const V3 imps[4],
                                        const M3& iw) {
  V3 up = up_of(k.rot);
  V3 dv = vzero(), torque = vzero();
  for (int w = 0; w < 4; ++w) {
    V3 offset = (rc.cp[w] - k.pos) * UU_TO_BT;
    V3 rel = offset - up * dot(offset, up);
    V3 imp = imps[w] * P.dt;
    dv = dv + imp;
    torque = torque + cross(rel, imp);
  }
  k.vel = k.vel + dv * P.sus_dv_scale;
  k.ang_vel = k.ang_vel + matvec(iw, torque);
}

// Returns sticky acceleration; updates handbrake and the wheel drive state.
__device__ V3 update_wheels(const Params& P, const Curve* cv, Car& k,
                            const Rays& rc, const float* ctl,
                            float fwd_speed, int num_contact) {
  float abs_speed = fabsf(fwd_speed);
  bool hb_input = ctl[HANDBRAKE] > 0.f;
  float hb_val = hb_input ? k.handbrake_val + POWERSLIDE_RISE_RATE * P.dt
                          : k.handbrake_val - POWERSLIDE_FALL_RATE * P.dt;
  hb_val = clampf(hb_val, 0.f, 1.f);
  bool boosting = (ctl[BOOST] > 0.f) & (k.boost > 0.f);
  float real_throttle = boosting ? 1.0f : ctl[THROTTLE];
  float drive_scale = curve(cv[CV_DRIVE], abs_speed);
  float abs_throttle = fabsf(real_throttle);
  bool opposite = (abs_speed > STOPPING_FORWARD_VEL) &
                  (signf(real_throttle) != signf(fwd_speed));
  float engine_nh =
      abs_throttle >= THROTTLE_DEADZONE
          ? ((opposite & (abs_speed > BRAKING_NO_THROTTLE_SPEED_THRESH))
                 ? 0.f : real_throttle)
          : 0.f;
  float brake_nh = abs_throttle >= THROTTLE_DEADZONE
                       ? (opposite ? 1.f : 0.f)
                       : (abs_speed < STOPPING_FORWARD_VEL
                              ? 1.f : COASTING_BRAKE_FACTOR);
  float engine_throttle = hb_input ? real_throttle : engine_nh;
  float real_brake = hb_input ? 0.f : brake_nh;
  drive_scale = num_contact < 3 ? drive_scale / 4.0f : drive_scale;
  float engine_force = engine_throttle * THROTTLE_TORQUE_BT * drive_scale;
  float brake_force = real_brake * BRAKE_TORQUE_BT;
  float steer_angle = curve(cv[CV_STEER], abs_speed);
  float ps_angle = curve(cv[CV_PS_STEER], abs_speed);
  steer_angle = steer_angle + (ps_angle - steer_angle) * hb_val;
  steer_angle = steer_angle * ctl[STEER];

  V3 up = up_of(k.rot);
  V3 rightv = right_of(k.rot);
  float cs = cosf(k.wc_steer), sn = sinf(k.wc_steer);
  V3 steered_right = rightv * cs + cross(up, rightv) * sn;
  bool sticky = real_throttle != 0.f;
  for (int w = 0; w < 4; ++w) {
    V3 lat_dir = w < 2 ? steered_right : rightv;
    V3 long_dir = cross(lat_dir, rc.n[w]);
    V3 rel = rc.hard[w] - k.pos;
    V3 cross_vec = (cross(k.ang_vel, rel * UU_TO_BT) + k.vel * UU_TO_BT) *
                   BT_TO_UU;
    float base_fric = fabsf(dot(cross_vec, lat_dir));
    float fric_input =
        base_fric > 5.0f
            ? base_fric / (fabsf(dot(cross_vec, long_dir)) + base_fric)
            : 0.f;
    float lat_f = curve(cv[CV_LAT], fric_input);
    float long_f = curve(cv[CV_LONG], fric_input);
    float lat_hb =
        lat_f * ((curve(cv[CV_HB_LAT], fric_input) - 1.0f) * hb_val + 1.0f);
    float long_hb =
        long_f * ((curve(cv[CV_HB_LONG], fric_input) - 1.0f) * hb_val + 1.0f);
    bool has_hb = hb_val > 0.f;
    lat_f = has_hb ? lat_hb : lat_f;
    long_f = has_hb ? long_hb : 1.0f;
    float nss = curve(cv[CV_NON_STICKY], rc.n[w].z);
    lat_f = sticky ? lat_f : lat_f * nss;
    long_f = sticky ? long_f : long_f * nss;
    if (rc.hit[w]) {
      k.wc_lat[w] = lat_f;
      k.wc_long[w] = long_f;
    }
  }
  // sticky force only on world contact (not on the ball or a car)
  bool any_world = (rc.in_world[0] | rc.in_world[1] | rc.in_world[2] |
                    rc.in_world[3]) != 0;
  V3 sum_n = vzero();
  for (int w = 0; w < 4; ++w) sum_n = sum_n + (rc.hit[w] ? rc.n[w] : vzero());
  V3 up_dir = norm(sum_n) > 1e-9f ? normalize(sum_n) : up;
  bool full_stick = (real_throttle != 0.f) |
                    (abs_speed > STOPPING_FORWARD_VEL);
  float sticky_scale = 0.5f + (full_stick ? 1.0f - fabsf(up_dir.z) : 0.f);
  V3 sticky_accel = up_dir * (sticky_scale * GRAVITY_Z);
  k.handbrake_val = hb_val;
  k.wc_steer = steer_angle;
  k.wc_engine = engine_force;
  k.wc_brake = brake_force;
  return any_world ? sticky_accel : vzero();
}

// ---------------------------------------------------------------------------
// Car state machines (ctick._update_air_torque, _update_jump,
// _update_auto_flip, _update_double_jump_or_flip, _update_auto_roll,
// _update_boost)

__device__ void update_air_torque(const Car& k, const float* ctl,
                                  bool in_air, bool zero_wheels,
                                  V3& ang_accel, V3& accel,
                                  bool& is_flipping_out) {
  V3 fwd = fwd_of(k.rot), rightv = right_of(k.rot), upv = up_of(k.rot);
  V3 dir_pitch = -rightv, dir_yaw = upv, dir_roll = -fwd;
  bool is_flipping = k.is_flipping & k.has_flipped &
                     (k.flip_time < FLIP_TORQUE_TIME);
  V3 rt = k.flip_rel_torque;
  bool has_rel_torque = (rt.x != 0.f) | (rt.y != 0.f) | (rt.z != 0.f);
  float pitch_in = ctl[PITCH];
  bool flip_cancel = (rt.y != 0.f) & (pitch_in != 0.f) &
                     (signf(rt.y) == signf(pitch_in));
  float pitch_scale =
      flip_cancel ? 1.0f - fminf(fabsf(pitch_in), 1.0f) : 1.0f;
  V3 dodge_torque = v3(rt.x * FLIP_TORQUE_X, rt.y * pitch_scale * FLIP_TORQUE_Y,
                       0.f);
  V3 flip_ang_accel = (is_flipping & has_rel_torque)
                          ? matvec(k.rot, dodge_torque) : vzero();
  bool do_air_control =
      is_flipping ? ((has_rel_torque & flip_cancel) | !has_rel_torque) : true;
  do_air_control = do_air_control & !k.is_auto_flipping & zero_wheels;
  bool pitch_lock = is_flipping |
                    (k.has_flipped & (k.flip_time < FLIP_PITCHLOCK_LIMIT));
  float pts = pitch_lock ? 0.f : 1.f;
  float yaw_in = ctl[YAW], roll_in = ctl[ROLL];
  bool any_input = (pitch_in != 0.f) | (yaw_in != 0.f) | (roll_in != 0.f);
  V3 torque = dir_pitch * (pitch_in * pts * AIR_TORQUE_PITCH) +
              dir_yaw * (yaw_in * AIR_TORQUE_YAW) +
              dir_roll * (roll_in * AIR_TORQUE_ROLL);
  torque = any_input ? torque : vzero();
  float damp_pitch = dot(dir_pitch, k.ang_vel) * AIR_DAMP_PITCH *
                     (1.0f - fabsf(do_air_control ? pitch_in * pts : 0.f));
  float damp_yaw = dot(dir_yaw, k.ang_vel) * AIR_DAMP_YAW *
                   (1.0f - fabsf(do_air_control ? yaw_in : 0.f));
  float damp_roll = dot(dir_roll, k.ang_vel) * AIR_DAMP_ROLL;
  V3 damping = dir_yaw * damp_yaw + dir_pitch * damp_pitch +
               dir_roll * damp_roll;
  V3 control = do_air_control ? (torque - damping) * CAR_TORQUE_SCALE
                              : vzero();
  float throttle = ctl[THROTTLE];
  V3 air_accel = throttle != 0.f ? fwd * (throttle * THROTTLE_AIR_ACCEL)
                                 : vzero();
  ang_accel = in_air ? flip_ang_accel + control : vzero();
  accel = in_air ? air_accel : vzero();
  is_flipping_out = is_flipping & in_air;
}

__device__ void update_jump(const Params& P, Car& k, const float* ctl,
                            bool jump_pressed, V3& dv, V3& accel) {
  bool on_ground = k.on_ground, is_jumping = k.is_jumping;
  bool has_jumped = k.has_jumped;
  float jump_time = k.jump_time;
  bool reset_ok = on_ground & !is_jumping &
                  !(has_jumped & (jump_time < JUMP_RESET_LIMIT));
  has_jumped = has_jumped & !reset_ok;
  jump_time = reset_ok ? 0.f : jump_time;
  bool cont = (jump_time < JUMP_MIN_TIME) |
              ((ctl[JUMP] > 0.f) & (jump_time < JUMP_MAX_TIME));
  bool start = !is_jumping & on_ground & jump_pressed;
  bool new_is_jumping = is_jumping ? cont : start;
  jump_time = start ? 0.f : jump_time;
  V3 upv = up_of(k.rot);
  dv = start ? upv * P.jump_immediate_force : vzero();
  has_jumped = has_jumped | new_is_jumping;
  float accel_scale = jump_time < JUMP_MIN_TIME ? JUMP_PRE_MIN_ACCEL_SCALE
                                                : 1.0f;
  accel = new_is_jumping ? upv * (P.jump_accel * accel_scale) : vzero();
  jump_time = (new_is_jumping | has_jumped) ? jump_time + P.dt : jump_time;
  k.is_jumping = new_is_jumping;
  k.has_jumped = has_jumped;
  k.jump_time = jump_time;
}

__device__ void update_auto_flip(const Params& P, Car& k, bool jump_pressed,
                                 V3& dv, V3& dw) {
  float roll_ang = -atan2f(k.rot.m[2][1], k.rot.m[2][2]);
  float abs_roll = fabsf(roll_ang);
  bool trigger = jump_pressed & k.has_world_contact &
                 (k.world_contact_normal.z > CAR_AUTOFLIP_NORMZ_THRESH) &
                 (abs_roll > CAR_AUTOFLIP_ROLL_THRESH);
  float timer = trigger ? CAR_AUTOFLIP_TIME * (abs_roll / PI_F)
                        : k.auto_flip_timer;
  float scale = trigger ? (roll_ang > 0.f ? 1.f : -1.f)
                        : k.auto_flip_torque_scale;
  bool is_af = trigger | k.is_auto_flipping;
  dv = trigger ? (-up_of(k.rot)) * CAR_AUTOFLIP_IMPULSE : vzero();
  bool active = is_af & (timer > 0.f);
  bool expired = is_af & !active;
  dw = active ? fwd_of(k.rot) * (CAR_AUTOFLIP_TORQUE * scale * P.dt)
              : vzero();
  timer = active ? timer - P.dt : (expired ? 0.f : timer);
  k.is_auto_flipping = is_af & !expired;
  k.auto_flip_timer = timer;
  k.auto_flip_torque_scale = scale;
}

__device__ void update_double_jump_or_flip(const Params& P, Car& k,
                                           const float* ctl,
                                           bool jump_pressed,
                                           float fwd_speed, V3& dv,
                                           bool& z_damp, bool& z_damp_always) {
  bool on_ground = k.on_ground;
  bool air = !on_ground;
  bool has_double_jumped = k.has_double_jumped & !on_ground;
  bool has_flipped = k.has_flipped & !on_ground;
  float air_time = on_ground ? 0.f : k.air_time + P.dt;
  float atsj = on_ground ? 0.f
                         : ((k.has_jumped & !k.is_jumping)
                                ? k.air_time_since_jump + P.dt : 0.f);
  float flip_time = on_ground ? 0.f : k.flip_time;
  bool is_flipping = k.is_flipping;
  bool press_window = air & jump_pressed & (atsj < DOUBLEJUMP_MAX_DELAY);
  float yaw_in = ctl[YAW], pitch_in = ctl[PITCH], roll_in = ctl[ROLL];
  float input_mag = fabsf(yaw_in) + fabsf(pitch_in) + fabsf(roll_in);
  bool is_flip_input = input_mag >= DODGE_DEADZONE;
  bool fresh = !has_double_jumped & !has_flipped;
  bool can_flip = fresh | (P.unlimited_flips != 0.f);
  bool can_dj = fresh | (P.unlimited_double_jumps != 0.f);
  bool can_use = (is_flip_input ? can_flip : can_dj) & !k.is_auto_flipping;
  bool do_flip = press_window & can_use & is_flip_input;
  bool do_dj = press_window & can_use & !is_flip_input;

  float fwd_ratio = fabsf(fwd_speed) / CAR_MAX_SPEED;
  float yaw_roll = yaw_in + roll_in;
  V3 dodge_dir = v3(-pitch_in, yaw_roll, 0.f);
  bool stall = (fabsf(yaw_roll) < 0.1f) & (fabsf(pitch_in) < 0.1f);
  dodge_dir = stall ? vzero() : normalize(dodge_dir);
  V3 new_rel_torque = v3(-dodge_dir.y, dodge_dir.x, 0.f);
  float ddx = fabsf(dodge_dir.x) < 0.1f ? 0.f : dodge_dir.x;
  float ddy = fabsf(dodge_dir.y) < 0.1f ? 0.f : dodge_dir.y;
  bool nonzero_dd = (fabsf(ddx) > 1e-7f) | (fabsf(ddy) > 1e-7f);
  bool backwards = fabsf(fwd_speed) < 100.0f
                       ? (ddx < 0.f) : ((ddx >= 0.f) != (fwd_speed >= 0.f));
  float ivx = ddx * FLIP_INITIAL_VEL_SCALE;
  float ivy = ddy * FLIP_INITIAL_VEL_SCALE;
  float max_x = backwards ? FLIP_BACKWARD_IMPULSE_MAX_SPEED_SCALE
                          : FLIP_FORWARD_IMPULSE_MAX_SPEED_SCALE;
  float vx = ivx * ((max_x - 1.0f) * fwd_ratio + 1.0f);
  float vy = ivy * (FLIP_SIDE_SCALE_M1 * fwd_ratio + 1.0f);
  vx = backwards ? vx * FLIP_BACKWARD_IMPULSE_SCALE_X : vx;
  V3 fwd = fwd_of(k.rot);
  float h = sqrtf(fwd.x * fwd.x + fwd.y * fwd.y);
  float ca = h > 1e-12f ? fwd.x / fmaxf(h, 1e-12f) : 1.0f;
  float sa = h > 1e-12f ? fwd.y / fmaxf(h, 1e-12f) : 0.0f;
  float dvx = vx * ca + vy * sa;
  float dvy = -vx * sa + vy * ca;
  V3 flip_dv = (do_flip & nonzero_dd) ? v3(dvx, dvy, 0.f) : vzero();
  flip_time = do_flip ? 0.f : flip_time;
  has_flipped = has_flipped | do_flip;
  is_flipping = is_flipping | do_flip;
  if (do_flip) k.flip_rel_torque = new_rel_torque;
  V3 dj_dv = do_dj ? up_of(k.rot) * JUMP_IMMEDIATE_FORCE : vzero();
  has_double_jumped = has_double_jumped | do_dj;
  float ftn = (is_flipping | has_flipped) ? flip_time + P.dt : flip_time;
  bool in_window = is_flipping & (ftn <= FLIP_TORQUE_TIME);
  z_damp = in_window & (ftn >= FLIP_Z_DAMP_START);
  z_damp_always = z_damp & (ftn < FLIP_Z_DAMP_END);
  k.has_double_jumped = has_double_jumped;
  k.has_flipped = has_flipped;
  k.air_time = air_time;
  k.air_time_since_jump = atsj;
  k.flip_time = ftn;
  k.is_flipping = is_flipping;
  dv = flip_dv + dj_dv;
}

__device__ void update_auto_roll(const Car& k, const Rays& rc,
                                 int num_contact, V3& accel, V3& ang_accel) {
  V3 upv = up_of(k.rot);
  V3 sum_n = vzero();
  for (int w = 0; w < 4; ++w) sum_n = sum_n + (rc.hit[w] ? rc.n[w] : vzero());
  V3 wheels_up = norm(sum_n) > 1e-9f ? normalize(sum_n) : upv;
  V3 ground_up = num_contact > 0 ? wheels_up : k.world_contact_normal;
  V3 ground_down = -ground_up;
  V3 fdir = fwd_of(k.rot), rdir = right_of(k.rot);
  V3 cross_right = cross(ground_up, fdir);
  V3 cross_fwd = cross(ground_down, cross_right);
  float right_factor = 1.0f - clampf(dot(rdir, cross_right), 0.f, 1.f);
  float fwd_factor = 1.0f - clampf(dot(fdir, cross_fwd), 0.f, 1.f);
  V3 t_dir_right = fdir * (dot(rdir, ground_up) >= 0.f ? -1.f : 1.f);
  V3 t_dir_fwd = rdir * (dot(fdir, ground_up) >= 0.f ? 1.f : -1.f);
  V3 torque = t_dir_right * right_factor + t_dir_fwd * fwd_factor;
  accel = ground_down * CAR_AUTOROLL_FORCE;
  ang_accel = torque * CAR_AUTOROLL_TORQUE;
}

__device__ V3 update_boost(const Params& P, Car& k, const float* ctl) {
  bool boosting_input = ctl[BOOST] > 0.f;
  float tsb = k.time_spent_boosting;
  bool stop = !boosting_input & (tsb >= BOOST_MIN_TIME);
  tsb = tsb > 0.f ? (stop ? 0.f : tsb + P.dt) : (boosting_input ? P.dt : 0.f);
  bool active = (k.boost > 0.f) & (tsb > 0.f);
  float b = active ? fmaxf(k.boost - P.boost_used_per_second * P.dt, 0.f)
                   : k.boost;
  k.boost = fminf(b, BOOST_MAX);
  k.time_spent_boosting = tsb;
  float accel_mag = k.on_ground ? P.boost_accel_ground : P.boost_accel_air;
  return active ? fwd_of(k.rot) * accel_mag : vzero();
}

// ---------------------------------------------------------------------------
// Contacts (ctick._resolve_car_world, _resolve_ball_world, _resolve_car_ball)

__device__ void resolve_car_world(const Params& P, const Tabs& Tb,
                                  const Car& k, const M3& iw, V3 vel_pre,
                                  V3 ang_vel_pre,
                                  V3& dvel, V3& dang, V3& push,
                                  bool& has_contact, V3& normal) {
  bool valid[NPLANES];
  plane_validity(k.pos, valid);
  const float* he = P.half_extents;
  const float* off = P.hitbox_offset;
  V3 corners[8];
  for (int i = 0; i < 8; ++i)
    corners[i] = k.pos + matvec(k.rot, v3(P.corners_local[i][0],
                                          P.corners_local[i][1],
                                          P.corners_local[i][2]));
  dvel = dang = push = vzero();
  V3 nsum = vzero();
  has_contact = false;
  V3 vel_bt = k.vel * UU_TO_BT;
  V3 vel_pre_bt = vel_pre * UU_TO_BT;
  for (int p = 0; p < NPLANES; ++p) {
    const float* pl = Tb.planes[p];
    V3 n = plane_n(pl);
    bool active;
    V3 contact_pt;
    float max_depth;
    if (P.true_plane[p] != 0.f) {
      V3 ldir = mat_t_vec(k.rot, -n);
      V3 sup_local = v3(ldir.x >= 0.f ? off[0] + he[0] : off[0] - he[0],
                        ldir.y >= 0.f ? off[1] + he[1] : off[1] - he[1],
                        ldir.z >= 0.f ? off[2] + he[2] : off[2] - he[2]);
      V3 sup = k.pos + matvec(k.rot, sup_local);
      float d = plane_dist(pl, sup);
      active = valid[p] & (d < P.car_world_break);
      contact_pt = sup;
      max_depth = fmaxf(-d, 0.f);
    } else {
      float ncont = 0.f, cx = 0.f, cy = 0.f, cz = 0.f;
      max_depth = 0.f;
      for (int i = 0; i < 8; ++i) {
        float pen = -plane_dist(pl, corners[i]) + MESH_COLLISION_MARGIN;
        bool act = valid[p] & (pen > 0.f);
        float actf = act ? 1.f : 0.f;
        ncont = ncont + actf;
        cx = cx + actf * corners[i].x;
        cy = cy + actf * corners[i].y;
        cz = cz + actf * corners[i].z;
        max_depth = fmaxf(max_depth, act ? pen : 0.f);
      }
      active = ncont > 0.f;
      float inv_n = 1.0f / fmaxf(ncont, 1.0f);
      contact_pt = v3(cx * inv_n, cy * inv_n, cz * inv_n);
    }
    if (!active) continue;
    V3 r_bt = (contact_pt - k.pos) * UU_TO_BT;
    V3 dv_bt, dw;
    contact_vs_static(vel_bt, k.ang_vel, r_bt, n, P.inv_car_mass, iw,
                      P.car_world_restitution, P.car_world_friction,
                      vel_pre_bt, ang_vel_pre, 10, dv_bt, dw);
    dvel = dvel + dv_bt;
    dang = dang + dw;
    push = push + n * (max_depth * SOLVER_ERP2);
    nsum = nsum + n;
    has_contact = true;
  }
  normal = has_contact ? normalize(nsum) : vzero();
  dvel = dvel * BT_TO_UU;
}

template <int NC>
__device__ void resolve_ball_world(const Params& P, const Tabs& Tb,
                                   Arena<NC>& a, V3 ball_vel_pre, V3& push,
                                   int& touch, V3& navg) {
  bool valid[NPLANES];
  plane_validity(a.bpos, valid);
  float num = 0.f, max_depth = 0.f;
  navg = vzero();
  for (int p = 0; p < NPLANES; ++p) {
    const float* pl = Tb.planes[p];
    float gap = plane_dist(pl, a.bpos) - P.ball_radius;
    bool act = valid[p] & (gap < P.ball_world_break);
    float actf = act ? 1.f : 0.f;
    num = num + actf;
    navg = navg + plane_n(pl) * actf;
    max_depth = fmaxf(max_depth, act ? -gap : 0.f);
  }
  push = vzero();
  touch = num > 0.f;
  if (!touch) return;
  navg = navg * (1.0f / fmaxf(num, 1.0f));
  V3 r_bt = navg * P.neg_ball_r_bt;
  M3 iw = diag3(P.ball_inv_inertia);
  V3 dv_bt, dw;
  contact_vs_static(a.bvel * UU_TO_BT, a.bang, r_bt, navg, P.inv_ball_mass,
                    iw, P.ball_world_restitution, P.ball_world_friction,
                    ball_vel_pre * UU_TO_BT, a.bang, 1, dv_bt, dw);
  a.bvel = a.bvel + dv_bt * BT_TO_UU;
  a.bang = a.bang + dw;
  push = navg * (fmaxf(max_depth, 0.f) * SOLVER_ERP2);
}

// bullet's btPlaneSpace1 first tangent (ctick._plane_space)
__device__ __forceinline__ V3 plane_space(V3 n) {
  if (fabsf(n.z) > 0.70710678f) {
    float k1 = 1.0f / sqrtf(fmaxf(n.y * n.y + n.z * n.z, 1e-12f));
    return v3(0.f, -n.z * k1, n.y * k1);
  }
  float k2 = 1.0f / sqrtf(fmaxf(n.x * n.x + n.y * n.y, 1e-12f));
  return v3(-n.y * k2, n.x * k2, 0.f);
}

// ---------------------------------------------------------------------------
// Full fidelity: 4-slot manifolds against the facet arena, and the joint
// PGS of a car's 8 world rows (ctick.keep_diverse4, _facet_sphere_manifold,
// _facet_box_manifold, _pgs_rows, _resolve_car_world_mesh,
// _resolve_ball_world_mesh)

// Retention of 4 contacts out of the live candidates, in passes: slot 0
// takes the deepest, each later slot the candidate whose least squared
// distance to the kept points is largest; ties go to the lowest index, so
// the result depends only on the set of candidates, not on the order a
// pass sees them in.  The arena's lanes collect the live candidates of a
// body in parallel into its buffer of NBUF (``collect``: every candidate is
// counted, the first NBUF stored); one lane then runs the passes over the
// buffer when it holds them all, or else enumerates the candidates again
// for every pass.  Without the buffer every pass enumerates them again, and
// the full-fidelity kernel took half as long again (PERF.md).  Lives in
// shared memory; flags are int.
template <int NPAY, int DISP>
struct Keep4 {
  static constexpr int NBUF = 8;
  static constexpr int NONE = 1 << 30;
  int pass, n_live;
  int best_idx;
  float best_key, best_pay[NPAY];
  int occ[4];
  int slot_idx[4];
  float slot_pay[4][NPAY];
  int buf_idx[NBUF];
  float buf_d[NBUF], buf_pay[NBUF][NPAY];

  // any lane, concurrently with the others
  __device__ void collect(int idx, float d, const float* pay) {
    const int s = atomicAdd(&n_live, 1);
    if (s < NBUF) {
      buf_idx[s] = idx;
      buf_d[s] = d;
      for (int i = 0; i < NPAY; ++i) buf_pay[s][i] = pay[i];
    }
  }
  __device__ void begin(int s) {
    pass = s;
    best_idx = NONE;
    best_key = s == 0 ? 1e30f : -INFINITY;
  }
  __device__ void visit(int idx, float d, const float* pay) {
    if (pass == 0) {
      if ((d < best_key) | ((d == best_key) & (idx < best_idx))) take(idx, d, pay);
      return;
    }
    for (int q = 0; q < pass; ++q)
      if (slot_idx[q] == idx) return;
    float mind = INFINITY;
    for (int q = 0; q < pass; ++q) {
      const float* k = slot_pay[q];
      float dd = (pay[DISP] - k[DISP]) * (pay[DISP] - k[DISP]) +
                 (pay[DISP + 1] - k[DISP + 1]) * (pay[DISP + 1] - k[DISP + 1]) +
                 (pay[DISP + 2] - k[DISP + 2]) * (pay[DISP + 2] - k[DISP + 2]);
      mind = fminf(mind, dd);
    }
    if ((mind > best_key) | ((mind == best_key) & (idx < best_idx)))
      take(idx, mind, pay);
  }
  __device__ void take(int idx, float key, const float* pay) {
    best_idx = idx;
    best_key = key;
    for (int i = 0; i < NPAY; ++i) best_pay[i] = pay[i];
  }
  // no live candidate: every slot empty, as the passes would leave them
  __device__ void clear() {
    for (int s = 0; s < 4; ++s) {
      occ[s] = 0;
      for (int i = 0; i < NPAY; ++i) slot_pay[s][i] = 0.f;
    }
  }
  // closes the pass; false once a slot stays empty (so do all later ones)
  __device__ bool end() {
    occ[pass] = best_idx != NONE ? 1 : 0;
    slot_idx[pass] = best_idx;
    for (int i = 0; i < NPAY; ++i) slot_pay[pass][i] = occ[pass] ? best_pay[i] : 0.f;
    if (!occ[pass])
      for (int s = pass + 1; s < 4; ++s) {
        occ[s] = 0;
        for (int i = 0; i < NPAY; ++i) slot_pay[s][i] = 0.f;
      }
    return occ[pass] != 0;
  }
  __device__ bool buffered() const { return n_live <= NBUF; }
  __device__ void replay() {
    for (int i = 0; i < n_live; ++i) visit(buf_idx[i], buf_d[i], buf_pay[i]);
  }
};

// Runs the 4 retention passes after a collection; ``gen(keep)`` enumerates
// the live candidates into keep.visit where the buffer overflowed.
template <class K, class G>
__device__ void retain4(K& keep, G& gen) {
  const bool buffered = keep.buffered();
  for (int s = 0; s < 4; ++s) {
    keep.begin(s);
    if (buffered) keep.replay();
    else gen(keep);
    if (!keep.end()) return;
  }
}

// The facet work items of one body: the 3 x 19 (side, band) items, the 4
// goal rectangles, the floor and ceiling sheets.
constexpr int NBAND_ITEMS = facets::NSIDE * facets::NB;
constexpr int NITEMS = NBAND_ITEMS + 4 + 2;

__device__ __forceinline__ facets::BoxQ car_box_q(const Params& P,
                                                  const Car& k) {
  return facets::box_q(box_center(P, k), k.rot, P.half_extents, P.he_core,
                       P.box_dist_m, P.car_world_break);
}

// Car hitbox vs one facet item (facet_arena.box_contacts and
// sheet_box_contacts): visit(idx, dist, payload) for every live row,
// payload (nx, ny, nz, point on the car x, y, z, dist), dispersion over
// the point.
template <class F>
__device__ void box_item(const Params& P, const Tabs& Tb, const Car& k,
                         const facets::BoxQ& q, int item, F& visit) {
  auto v = [&](int idx, V3 n, V3 pa, float dist) {
    const float pay[7] = {n.x, n.y, n.z, pa.x, pa.y, pa.z, dist};
    visit(idx, dist, pay);
  };
  if (item < NBAND_ITEMS) {
    const int side = item / facets::NB, b = item % facets::NB;
    if (!facets::box_band_dead(Tb.facets, Tb.extent, q, side, b))
      facets::box_band(Tb.facets, q, side, b, v);
  } else if (item < NBAND_ITEMS + 4) {
    facets::box_rect(q, item - NBAND_ITEMS, v);
  } else {
    const int sh = item - NBAND_ITEMS - 4;
    const float z0 = sh == 0 ? 0.f : ARENA_HEIGHT, up = sh == 0 ? 1.f : -1.f;
    if (facets::sheet_box_dead(k.pos, k.rot, P.hitbox_offset, P.he_core, z0,
                               up, P.box_dist_m, q.brk))
      return;
    float cx[4], cy[4], dist[4];
    facets::sheet_box(k.pos, k.rot, P.hitbox_offset, P.he_core,
                      P.core_corners_local, z0, up, P.box_dist_m, cx, cy,
                      dist);
    for (int i = 0; i < 4; ++i) {
      if (!((dist[i] < q.brk) &&
            facets::sheet_clip_ok(Tb.facets, cx[i], cy[i], SHEET_CLIP[sh])))
        continue;
      // the lever arm's point on the car: the sheet point + n * dist
      const float pay[7] = {0.f, 0.f, up, cx[i], cy[i],
                            z0 + up * dist[i], dist[i]};
      visit(facets::BOX_ROWS + 4 * sh + i, dist[i], pay);
    }
  }
}

// Ball vs one facet item (facet_arena.sphere_contacts and
// sheet_sphere_contacts): payload (nx, ny, nz, gap), dispersion over n.
template <class F>
__device__ void ball_item(const Tabs& Tb, const facets::SphereQ& q, int item,
                          F& visit) {
  auto v = [&](int idx, V3 n, float gap) {
    const float pay[4] = {n.x, n.y, n.z, gap};
    visit(idx, gap, pay);
  };
  if (item < NBAND_ITEMS) {
    const int side = item / facets::NB, b = item % facets::NB;
    if (!facets::sphere_band_dead(Tb.facets, Tb.extent, q, side, b))
      facets::sphere_band(Tb.facets, q, side, b, v);
  } else if (item < NBAND_ITEMS + 4) {
    facets::sphere_rect(q, item - NBAND_ITEMS, v);
  } else {
    const int sh = item - NBAND_ITEMS - 4;
    const float z0 = sh == 0 ? 0.f : ARENA_HEIGHT, up = sh == 0 ? 1.f : -1.f;
    if (facets::sheet_sphere_dead(q.p, q.radius, q.bg, z0, up)) return;
    float cx[4], cy[4], gap[4];
    facets::sheet_sphere(q.p, q.radius, z0, up, cx, cy, gap);
    for (int i = 0; i < 4; ++i) {
      if (!((gap[i] < q.bg) &&
            facets::sheet_clip_ok(Tb.facets, cx[i], cy[i], SHEET_CLIP[sh])))
        continue;
      const float pay[4] = {0.f, 0.f, up, gap[i]};
      visit(facets::SPHERE_ROWS + 4 * sh + i, gap[i], pay);
    }
  }
}

// The retention of car k's collected facet candidates (one lane).
__device__ __noinline__ void retain_box(const Params& P, const Tabs& Tb,
                                        const Car& k, Keep4<7, 3>& keep) {
  const facets::BoxQ q = car_box_q(P, k);
  auto gen = [&](Keep4<7, 3>& kp) {
    auto visit = [&](int idx, float d, const float* pay) {
      kp.visit(idx, d, pay);
    };
#pragma unroll 1
    for (int item = 0; item < NITEMS; ++item)
      box_item(P, Tb, k, q, item, visit);
  };
  retain4(keep, gen);
}

// The retention of the ball's collected facet candidates (one lane).
__device__ __noinline__ void retain_ball(const Params& P, const Tabs& Tb,
                                         V3 bpos, Keep4<4, 0>& keep) {
  const facets::SphereQ q =
      facets::sphere_q(bpos, P.ball_radius, P.ball_world_break);
  auto gen = [&](Keep4<4, 0>& kp) {
    auto visit = [&](int idx, float d, const float* pay) {
      kp.visit(idx, d, pay);
    };
#pragma unroll 1
    for (int item = 0; item < NITEMS; ++item) ball_item(Tb, q, item, visit);
  };
  retain4(keep, gen);
}

struct Row {
  V3 n, r;
  float dist_bt;
  int act;
};

// One body against static rows, bullet's order: 10 velocity passes of the
// normal rows then the friction rows, then 10 split-impulse position
// passes.  Only the active rows run: the plain version applies an inactive
// row's impulse times 0, which adds exact zeros (its impulse stays finite:
// the accumulated impulse is clamped by fmaxf, which drops a NaN, and its
// friction is 0 while its normal impulse is), and the sums start at +0, so
// adding a zero leaves them as they are.  With no active row the results
// are zeros.
template <int NR>
__device__ void pgs_rows(const Params& P, V3 vel_bt, V3 ang_vel,
                         const Row* rows, float inv_mass, const M3& iw,
                         float restitution, float friction, V3 vel_pre_bt,
                         V3 ang_vel_pre, V3& dv, V3& dw, V3& push, V3& turn) {
  dv = dw = push = turn = vzero();
  int act[NR], any = 0;
  for (int i = 0; i < NR; ++i) {
    act[i] = rows[i].act;
    any |= act[i];
  }
  if (!any) return;
  float jac_inv[NR], rest[NR], t_jac_inv[NR], push_t[NR];
  V3 t_dir[NR];
  for (int i = 0; i < NR; ++i) {
    if (!act[i]) continue;
    const V3 n = rows[i].n, r = rows[i].r;
    V3 ang_comp = matvec(iw, cross(r, n));
    jac_inv[i] = 1.0f / fmaxf(inv_mass + dot(n, cross(ang_comp, r)), 1e-12f);
    rest[i] = restitution_rhs(dot(n, vel_pre_bt + cross(ang_vel_pre, r)),
                              restitution);
    V3 vel_at = vel_bt + cross(ang_vel, r);
    V3 tang = vel_at - n * dot(n, vel_at);
    float t_len = norm(tang);
    t_dir[i] = t_len > 1.49e-8f ? tang * (1.0f / fmaxf(t_len, 1e-12f))
                                : plane_space(n);
    V3 t_ang = matvec(iw, cross(r, t_dir[i]));
    t_jac_inv[i] =
        1.0f / fmaxf(inv_mass + dot(t_dir[i], cross(t_ang, r)), 1e-12f);
    push_t[i] = fmaxf(-rows[i].dist_bt, 0.f) * P.erp2_over_dt;
  }
  float j_n[NR], j_t[NR], j_p[NR];
  for (int i = 0; i < NR; ++i) j_n[i] = j_t[i] = j_p[i] = 0.f;
#pragma unroll 1
  for (int it = 0; it < 10; ++it) {
    for (int i = 0; i < NR; ++i) {
      if (!act[i]) continue;
      const V3 n = rows[i].n, r = rows[i].r;
      float rel = dot(n, (vel_bt + dv) + cross(ang_vel + dw, r));
      float new_acc = fmaxf(j_n[i] + (rest[i] - rel) * jac_inv[i], 0.f);
      float dj = new_acc - j_n[i];
      V3 imp = n * dj;
      dv = dv + imp * inv_mass;
      dw = dw + matvec(iw, cross(r, imp));
      j_n[i] = j_n[i] + dj;
    }
    for (int i = 0; i < NR; ++i) {
      if (!act[i]) continue;
      const V3 r = rows[i].r, td = t_dir[i];
      float rel = dot(td, (vel_bt + dv) + cross(ang_vel + dw, r));
      float lim = friction * j_n[i];
      float new_acc = clampf(j_t[i] + -rel * t_jac_inv[i], -lim, lim);
      float dj = j_n[i] > 0.f ? new_acc - j_t[i] : 0.f;
      V3 imp = td * dj;
      dv = dv + imp * inv_mass;
      dw = dw + matvec(iw, cross(r, imp));
      j_t[i] = j_t[i] + dj;
    }
  }
  V3 pv = vzero(), pw = vzero();
#pragma unroll 1
  for (int it = 0; it < 10; ++it) {
    for (int i = 0; i < NR; ++i) {
      if (!act[i]) continue;
      const V3 n = rows[i].n, r = rows[i].r;
      float rel = dot(n, pv + cross(pw, r));
      float new_acc = fmaxf(j_p[i] + (push_t[i] - rel) * jac_inv[i], 0.f);
      float dj = new_acc - j_p[i];
      V3 imp = n * dj;
      pv = pv + imp * inv_mass;
      pw = pw + matvec(iw, cross(r, imp));
      j_p[i] = j_p[i] + dj;
    }
  }
  push = pv * P.dt;
  turn = pw * P.turn_erp_dt;
}

// Car against the full-fidelity world: the 4 retained facet contacts and
// the 4 true planes' support-vertex contacts, solved jointly.  The
// full-fidelity solvers stay out of line: inlined, their registers and
// stack slowed the plane arena's path in the same binary by a quarter
// (kernel_variants.py, PERF.md).
__device__ __noinline__ void resolve_car_world_mesh(
    const Params& P, const Tabs& Tb, const Car& k, const Keep4<7, 3>& keep,
    const M3& iw, V3 vel_pre, V3 ang_vel_pre, V3& dvel, V3& dang, V3& push,
    V3& turn, bool& has_contact, V3& normal) {
  const float brk = P.car_world_break;
  Row rows[8];
  for (int s = 0; s < 4; ++s) {
    const float* p = keep.slot_pay[s];
    rows[s].n = v3(p[0], p[1], p[2]);
    rows[s].r = (v3(p[3], p[4], p[5]) - k.pos) * UU_TO_BT;
    rows[s].dist_bt = p[6] * UU_TO_BT;
    rows[s].act = keep.occ[s];
  }
  for (int p = 0; p < NTRUE_PLANES; ++p) {
    const float* pl = Tb.planes[p];
    V3 n = plane_n(pl);
    V3 ldir = mat_t_vec(k.rot, -n);
    const float* sl = P.corners_local[(ldir.x >= 0.f ? 4 : 0) +
                                      (ldir.y >= 0.f ? 2 : 0) +
                                      (ldir.z >= 0.f ? 1 : 0)];
    V3 sup = k.pos + matvec(k.rot, v3(sl[0], sl[1], sl[2]));
    float d = plane_dist(pl, sup);
    rows[4 + p].n = n;
    rows[4 + p].r = (sup - k.pos) * UU_TO_BT;
    rows[4 + p].dist_bt = d * UU_TO_BT;
    rows[4 + p].act = d < brk ? 1 : 0;
  }
  V3 dv_bt, push_bt;
  pgs_rows<8>(P, k.vel * UU_TO_BT, k.ang_vel, rows, P.inv_car_mass, iw,
              P.car_world_restitution, P.car_world_friction,
              vel_pre * UU_TO_BT, ang_vel_pre, dv_bt, dang, push_bt, turn);
  has_contact = false;
  V3 nsum = vzero();
  for (int i = 0; i < 8; ++i) {
    has_contact = has_contact | (rows[i].act != 0);
    nsum = nsum + (rows[i].act ? rows[i].n : vzero());
  }
  normal = has_contact ? normalize(nsum) : vzero();
  dvel = dv_bt * BT_TO_UU;
  push = push_bt * BT_TO_UU;
}

// Ball against the full-fidelity world: the merged contact over the 4 true
// planes and the 4 retained facet contacts, 10 solver passes.
template <int NC>
__device__ __noinline__ void resolve_ball_world_mesh(const Params& P,
                                                     const Tabs& Tb,
                                                     Arena<NC>& a,
                                                     const Keep4<4, 0>& keep,
                                                     V3 ball_vel_pre,
                                                     V3& push, int& touch,
                                                     V3& navg) {
  float num = 0.f, max_depth = 0.f;
  navg = vzero();
  for (int p = 0; p < NTRUE_PLANES; ++p) {
    const float* pl = Tb.planes[p];
    float gap = plane_dist(pl, a.bpos) - P.ball_radius;
    bool act = gap < P.ball_world_break;
    float actf = act ? 1.f : 0.f;
    num = num + actf;
    navg = navg + plane_n(pl) * actf;
    max_depth = fmaxf(max_depth, act ? -gap : 0.f);
  }
  for (int s = 0; s < 4; ++s) {
    const float* p = keep.slot_pay[s];
    float occf = keep.occ[s] ? 1.f : 0.f;
    num = num + occf;
    navg = navg + v3(p[0], p[1], p[2]) * occf;
    max_depth = fmaxf(max_depth, keep.occ[s] ? -p[3] : 0.f);
  }
  push = vzero();
  touch = num > 0.f;
  if (!touch) return;
  navg = navg * (1.0f / fmaxf(num, 1.0f));
  V3 r_bt = navg * P.neg_ball_r_bt;
  M3 iw = diag3(P.ball_inv_inertia);
  V3 dv_bt, dw;
  contact_vs_static(a.bvel * UU_TO_BT, a.bang, r_bt, navg, P.inv_ball_mass,
                    iw, P.ball_world_restitution, P.ball_world_friction,
                    ball_vel_pre * UU_TO_BT, a.bang, 10, dv_bt, dw);
  a.bvel = a.bvel + dv_bt * BT_TO_UU;
  a.bang = a.bang + dw;
  push = navg * (fmaxf(max_depth, 0.f) * SOLVER_ERP2);
}

// Car c's car-ball rows (10 coupled normal + friction passes) against the
// ball as the stage found it, and the psyonix extra impulse.  Returns the
// car's impulse on the ball, its moment and the extra velocity (zeros where
// there is none), which the caller sums onto the ball in car order
// (``car_ball_sum``), and whether the car touched.
template <int NC>
__device__ void car_ball(const Params& P, const Curve* cv, Arena<NC>& a,
                         int c, const M3& iwc, int alive_c, V3 car_vel_pre,
                         V3 ball_vel_pre, V3& imp_out, V3& rimp_out,
                         V3& add_out, int& touched) {
  const float* he = P.half_extents;
  M3 iwb = diag3(P.ball_inv_inertia);
  const float mu = CARBALL_FRICTION;
  const V3 bpos = a.bpos, bvel = a.bvel, bang = a.bang;
  {
    Car& k = a.car[c];
    V3 box_center = k.pos + matvec(k.rot, v3(P.hitbox_offset[0],
                                             P.hitbox_offset[1],
                                             P.hitbox_offset[2]));
    V3 local = mat_t_vec(k.rot, bpos - box_center);
    V3 clamped = v3(clampf(local.x, -he[0], he[0]),
                    clampf(local.y, -he[1], he[1]),
                    clampf(local.z, -he[2], he[2]));
    V3 closest = box_center + matvec(k.rot, clamped);
    V3 delta = bpos - closest;
    float dist = norm(delta);
    bool touching = (dist < P.car_ball_touch) & (alive_c != 0);
    touched = touching ? 1 : 0;
    V3 imp_total = vzero();
    if (touching) {
      V3 n = dist > 1e-6f ? normalize(delta) : normalize(bpos - box_center);
      V3 r_car = (closest - k.pos) * UU_TO_BT;
      V3 r_ball = (closest - bpos) * UU_TO_BT;
      V3 v_car = k.vel * UU_TO_BT + cross(k.ang_vel, r_car);
      V3 v_ball = bvel * UU_TO_BT + cross(bang, r_ball);
      float rel_vel = dot(n, v_ball - v_car);
      V3 ta_car = matvec(iwc, cross(r_car, n));
      V3 ta_ball = matvec(iwb, cross(r_ball, n));
      float denom = P.inv_car_mass + P.inv_ball_mass +
                    dot(n, cross(ta_car, r_car)) +
                    dot(n, cross(ta_ball, r_ball));
      V3 rel_t0 = (v_ball - v_car) - n * rel_vel;
      float t_len = norm(rel_t0);
      V3 t_dir = t_len > 1e-9f ? rel_t0 * (1.0f / fmaxf(t_len, 1e-9f))
                               : vzero();
      V3 tt_car = matvec(iwc, cross(r_car, t_dir));
      V3 tt_ball = matvec(iwb, cross(r_ball, t_dir));
      float t_denom = P.inv_car_mass + P.inv_ball_mass +
                      dot(t_dir, cross(tt_car, r_car)) +
                      dot(t_dir, cross(tt_ball, r_ball));
      V3 dvb = vzero(), dwb = vzero(), dvc = vzero(), dwc = vzero();
      float jn_acc = 0.f, jt_acc = 0.f;
      for (int it = 0; it < 10; ++it) {
        float rv = dot(n, (v_ball + dvb + cross(dwb, r_ball)) -
                              (v_car + dvc + cross(dwc, r_car)));
        float djn = -rv / fmaxf(denom, 1e-12f);
        djn = fmaxf(jn_acc + djn, 0.f) - jn_acc;
        jn_acc = jn_acc + djn;
        V3 dimp = n * djn;
        dvb = dvb + dimp * P.inv_ball_mass;
        dwb = dwb + matvec(iwb, cross(r_ball, dimp));
        dvc = dvc - dimp * P.inv_car_mass;
        dwc = dwc + matvec(iwc, cross(r_car, -dimp));
        float rt = dot(t_dir, (v_ball + dvb + cross(dwb, r_ball)) -
                                  (v_car + dvc + cross(dwc, r_car)));
        float djt = -rt / fmaxf(t_denom, 1e-12f);
        djt = clampf(jt_acc + djt, -mu * jn_acc, mu * jn_acc) - jt_acc;
        jt_acc = jt_acc + djt;
        dimp = t_dir * djt;
        dvb = dvb + dimp * P.inv_ball_mass;
        dwb = dwb + matvec(iwb, cross(r_ball, dimp));
        dvc = dvc - dimp * P.inv_car_mass;
        dwc = dwc + matvec(iwc, cross(r_car, -dimp));
      }
      imp_total = n * jn_acc + t_dir * jt_acc;
      imp_out = imp_total;
      rimp_out = cross(r_ball, imp_total);
      k.vel = k.vel + (-imp_total) * P.sus_dv_scale;
      k.ang_vel = k.ang_vel + matvec(iwc, cross(r_car, -imp_total));
    } else {
      imp_out = rimp_out = vzero();
    }
    // psyonix extra impulse; callback-time state reads pre-force velocity
    bool can_extra = touching & ((a.tick_count > k.hit_extra_tick + 1) |
                                 (k.hit_extra_tick > a.tick_count));
    V3 rel_pos = bpos - k.pos;
    V3 rel_v = ball_vel_pre - car_vel_pre;
    float rel_speed = fminf(norm(rel_v), EXTRA_IMPULSE_MAXDELTAVEL);
    V3 hit_dir = normalize(v3(rel_pos.x, rel_pos.y,
                              rel_pos.z * EXTRA_IMPULSE_Z_SCALE));
    V3 fwd = fwd_of(k.rot);
    V3 fwd_adj = fwd * (dot(hit_dir, fwd) * EXTRA_IMPULSE_FWD_KEEP);
    hit_dir = normalize(hit_dir - fwd_adj);
    float factor = curve(cv[CV_EXTRA_IMPULSE], rel_speed);
    V3 added_vel = hit_dir * (rel_speed * factor *
                              P.ball_hit_extra_force_scale);
    bool apply_extra = can_extra & (rel_speed > 0.f);
    add_out = apply_extra ? added_vel : vzero();
    if (touching) {
      k.ball_hit_valid = true;
      k.ball_hit_rel_pos = closest - bpos;
      k.hit_tick = a.tick_count;
      k.ball_hit_ball_pos = bpos;
      k.ball_hit_extra_vel = apply_extra ? added_vel : vzero();
    }
    if (can_extra) k.hit_extra_tick = a.tick_count;
  }
}

// The cars' car-ball impulses onto the ball, summed in car order as the
// plain version sums them; returns the summed extra velocity.
template <int NC>
__device__ V3 car_ball_sum(const Params& P, Arena<NC>& a, const V3* imp,
                           const V3* rimp, const V3* add) {
  V3 sum_imp = vzero(), sum_rimp = vzero(), cache = vzero();
  for (int c = 0; c < NC; ++c) {
    sum_imp = c == 0 ? imp[c] : sum_imp + imp[c];
    sum_rimp = c == 0 ? rimp[c] : sum_rimp + rimp[c];
    cache = c == 0 ? add[c] : cache + add[c];
  }
  a.bvel = a.bvel + sum_imp * (P.inv_ball_mass * BT_TO_UU);
  a.bang = a.bang + matvec(diag3(P.ball_inv_inertia), sum_rimp);
  return cache;
}

// ---------------------------------------------------------------------------
// Game modes (ctick._resolve_ball_world_snowday, _wrap, _round_angle_ue3,
// _hs_steer, _hs_on_hit, _hs_wall_bounce).  Each hook is out of line and
// runs behind the mode test, so soccar keeps its registers and stack.

// The snowday puck against the analytic planes, in either arena (the puck
// never meets the facet arena): the merged contact with the exact support
// distance of its cylinder per plane, its solid-cylinder inertia turned to
// the world, 10 solver passes.  Every plane is a row, masked by its
// validity and its gap.
template <int NC>
__device__ __noinline__ void resolve_ball_world_snowday(const Params& P,
                                                        const Tabs& Tb,
                                                        Arena<NC>& a,
                                                        V3 ball_vel_pre,
                                                        V3& push, int& touch,
                                                        V3& navg) {
  bool valid[NPLANES];
  plane_validity(a.bpos, valid);
  const V3 axis = v3(a.brot.m[0][2], a.brot.m[1][2], a.brot.m[2][2]);
  float num = 0.f, max_depth = 0.f, supp_sum = 0.f;
  navg = vzero();
  for (int p = 0; p < NPLANES; ++p) {
    const float* pl = Tb.planes[p];
    const V3 pn = plane_n(pl);
    const float adn = dot(axis, pn);
    const float support = PUCK_RADIUS * sqrtf(fmaxf(1.f - adn * adn, 0.f)) +
                          PUCK_HALF_HEIGHT * fabsf(adn);
    const float gap = plane_dist(pl, a.bpos) - support;
    const bool act = valid[p] & (gap < P.snow_break_gap);
    const float actf = act ? 1.f : 0.f;
    num = num + actf;
    navg = navg + pn * actf;
    supp_sum = supp_sum + support * actf;
    max_depth = fmaxf(max_depth, act ? -gap : 0.f);
  }
  push = vzero();
  touch = num > 0.f;
  if (!touch) return;
  const float inv_n = 1.0f / fmaxf(num, 1.0f);
  navg = navg * inv_n;
  const V3 r_bt = navg * (-(supp_sum * inv_n) * UU_TO_BT);
  const M3 iw = inv_inertia_world(a.brot, P.snow_inv_i_perp,
                                  P.snow_inv_i_perp, P.snow_inv_i_axis);
  V3 dv_bt, dw;
  contact_vs_static(a.bvel * UU_TO_BT, a.bang, r_bt, navg, P.inv_ball_mass,
                    iw, P.ball_world_restitution, P.ball_world_friction,
                    ball_vel_pre * UU_TO_BT, a.bang, 10, dv_bt, dw);
  a.bvel = a.bvel + dv_bt * BT_TO_UU;
  a.bang = a.bang + dw;
  push = navg * (fmaxf(max_depth, 0.f) * SOLVER_ERP2);
}

// Math::WrapNormalizeFloat into [-mm, mm]; mm2 = 2 mm.
__device__ __forceinline__ float wrap_angle(float x, float mm, float mm2) {
  float r = fmodf(x, mm2);
  r = r > mm ? r - mm2 : r;
  return r < -mm ? r + mm2 : r;
}

// Math::RoundAngleUE3: the float -> int conversion truncates toward zero
// and >> is arithmetic on a negative int, as the plain version's
// .to(int32) and >> are.
__device__ __forceinline__ float round_angle_ue3(float ang) {
  const int r = (int)(ang * UE3_TO_INTS) >> 2;
  return (float)(r & (0x4000 - 1)) * UE3_BACK;
}

// Ball::_PreTickUpdate, heatseeker: while seeking, turn the velocity toward
// the target goal point, quantise its yaw and pitch, and blend the speed
// toward the target speed.
template <int NC>
__device__ __noinline__ void hs_steer(const Params& P, Arena<NC>& a) {
  const float ytd = a.hs[0];
  if (!(ytd != 0.f)) return;
  const V3 vel = a.bvel;
  const float speed = norm(vel);
  const float d2 = sqrtf(vel.x * vel.x + vel.y * vel.y);
  const float v_yaw = atan2f(vel.y, vel.x);
  const float v_pitch = atan2f(vel.z, d2);
  const float gx = 0.f - a.bpos.x;
  const float gy = HS_TARGET_Y * ytd - a.bpos.y;
  const float gz = HS_TARGET_Z - a.bpos.z;
  const float g_yaw = atan2f(gy, gx);
  const float g_pitch = atan2f(gz, sqrtf(gx * gx + gy * gy));
  const float d_yaw = wrap_angle(g_yaw - v_yaw, PI_F, TWO_PI_F);
  const float d_pitch = wrap_angle(g_pitch - v_pitch, HALF_PI_F, PI_F);
  const float f = (speed / HS_MAX_SPEED) * P.dt;
  float new_yaw = wrap_angle(v_yaw + d_yaw * f * HS_HORIZONTAL_BLEND, PI_F,
                             TWO_PI_F);
  float new_pitch = clampf(
      wrap_angle(v_pitch + d_pitch * f * HS_VERTICAL_BLEND, HALF_PI_F, PI_F),
      -HS_MAX_TURN_PITCH, HS_MAX_TURN_PITCH);
  new_yaw = round_angle_ue3(new_yaw);
  new_pitch = round_angle_ue3(new_pitch);
  const float new_speed = speed + (a.hs[1] - speed) * HS_SPEED_BLEND;
  const float cp = cosf(new_pitch), sp = sinf(new_pitch);
  a.bvel = v3(cp * cosf(new_yaw) * new_speed, cp * sinf(new_yaw) * new_speed,
              sp * new_speed);
  a.hs[2] = a.hs[2] + P.dt;
}

// Ball::_OnHit, heatseeker: once per touching car in car order, each call
// reading the one before: the toucher's team sets the target goal, and the
// target speed rises where the target flips after the minimum interval (or
// from idle).  The touched flags and the fold's state are int and float,
// never bool arrays (a bool flag array written in one pass and read in the
// next is what nvcc 12.9 -O3 once miscompiled in car_car).
template <int NC>
__device__ __noinline__ void hs_on_hit(const Params& P, Arena<NC>& a,
                                       const int* touched) {
  float ytd = a.hs[0], tspeed = a.hs[1], tsince = a.hs[2];
#pragma unroll 1
  for (int c = 0; c < NC; ++c) {
    const int t = touched[c];
    const float d = P.teams[c] == 0.f ? 1.f : -1.f;
    const int can_increase =
        (tsince > HS_MIN_SPEEDUP_INTERVAL ? 1 : 0) | (ytd == 0.f ? 1 : 0);
    const int speed_up = t & can_increase & (ytd != d ? 1 : 0);
    ytd = t ? d : ytd;
    tspeed = speed_up ? fminf(tspeed + HS_TARGET_SPEED_INCREMENT, HS_MAX_SPEED)
                      : tspeed;
    tsince = speed_up ? 0.f : tsince;
  }
  a.hs[0] = ytd;
  a.hs[1] = tspeed;
  a.hs[2] = tsince;
}

// Ball::_OnWorldCollision, heatseeker: a world contact deep in the target's
// back wall flips the target and adds a goal-ward bounce to the velocity
// cache.
template <int NC>
__device__ __noinline__ void hs_wall_bounce(Arena<NC>& a, int touch, V3 navg,
                                            V3& cache) {
  const float ytd = a.hs[0];
  const int flip = touch & (ytd != 0.f ? 1 : 0) &
                   (navg.y * ytd <= -HS_WALL_BOUNCE_NORMAL ? 1 : 0) &
                   (a.bpos.y * ytd >= HS_WALL_BOUNCE_Y ? 1 : 0);
  if (!flip) return;
  const float new_ytd = -ytd;
  a.hs[0] = new_ytd;
  const V3 to_goal = normalize(v3(-a.bpos.x, HS_TARGET_Y * new_ytd - a.bpos.y,
                                  HS_TARGET_Z - a.bpos.z));
  const float mag = norm(a.bvel) * HS_WALL_BOUNCE_FORCE_SCALE;
  cache = cache + v3(to_goal.x * HS_WALL_BOUNCE_KEEP * mag,
                     to_goal.y * HS_WALL_BOUNCE_KEEP * mag,
                     (to_goal.z * HS_WALL_BOUNCE_KEEP + HS_WALL_BOUNCE_UP) *
                         mag);
}

// ---------------------------------------------------------------------------
// Car-car: dBoxBox with clamped incident corners (physics/box_box.py
// box_box_clamped_components) and the 4-row pair solver (ctick._pgs_pair)

struct Manifold {
  V3 points[4];
  float depth[4];
  V3 normal;
  bool active[4];
  bool overlap;
};

// face manifold with reference box a and incident box b
__device__ void face_branch(const V3* axa, V3 pa, const float* Sa,
                            const V3* axb, V3 pb, const float* Sb,
                            V3 normal2, int code, int base, V3 pts[4],
                            float deps[4]) {
  float nr[3], anr[3];
  for (int i = 0; i < 3; ++i) {
    nr[i] = dot(axb[i], normal2);
    anr[i] = fabsf(nr[i]);
  }
  int lanr = anr[1] > anr[0] ? (anr[1] > anr[2] ? 1 : 2)
                             : (anr[0] > anr[2] ? 0 : 2);
  int a1 = lanr == 0 ? 1 : 0;
  int a2 = lanr == 2 ? 1 : 2;
  float nr_l = nr[lanr];
  float Sb_l = Sb[lanr];
  V3 center = (pb - pa) + axb[lanr] * (nr_l < 0.f ? Sb_l : -Sb_l);
  int codeN = code - base;
  // codes outside this branch still evaluate (the selects in the plain
  // version pick index 0 for out-of-range codes)
  int code1 = codeN == 0 ? 1 : 0;
  int code2 = codeN == 2 ? 1 : 2;
  V3 Ra1 = axa[code1], Ra2 = axa[code2];
  V3 Rba1 = axb[a1], Rba2 = axb[a2];
  float Sba1 = Sb[a1], Sba2 = Sb[a2];
  float c1 = dot(center, Ra1), c2 = dot(center, Ra2);
  float m11 = dot(Ra1, Rba1), m12 = dot(Ra1, Rba2);
  float m21 = dot(Ra2, Rba1), m22 = dot(Ra2, Rba2);
  float k1 = m11 * Sba1, k2 = m21 * Sba1, k3 = m12 * Sba2, k4 = m22 * Sba2;
  float qxs[4] = {c1 - k1 - k3, c1 - k1 + k3, c1 + k1 + k3, c1 + k1 - k3};
  float qys[4] = {c2 - k2 - k4, c2 - k2 + k4, c2 + k2 + k4, c2 + k2 - k4};
  float r1v = Sa[code1], r2v = Sa[code2];
  float SaN = (codeN >= 0 && codeN <= 2) ? Sa[codeN] : 0.f;
  float det = m11 * m22 - m12 * m21;
  float deti = 1.0f / (fabsf(det) > 0.f ? det : 1.0f);
  for (int q = 0; q < 4; ++q) {
    float qx = clampf(qxs[q], -r1v, r1v);
    float qy = clampf(qys[q], -r2v, r2v);
    float kk1 = (m22 * (qx - c1) - m12 * (qy - c2)) * deti;
    float kk2 = (-m21 * (qx - c1) + m11 * (qy - c2)) * deti;
    kk1 = clampf(kk1, -Sba1, Sba1);
    kk2 = clampf(kk2, -Sba2, Sba2);
    V3 pt = center + Rba1 * kk1 + Rba2 * kk2;
    deps[q] = SaN - dot(normal2, pt);
    pts[q] = pt + pa;
  }
}

// Returns whether the boxes are in contact (the manifold holds an active
// point); only then is the manifold filled.  Apart (``separated`` or no
// axis), every point is inactive, so the plain version's manifold, pair
// solver and bump tests yield exact zeros and no event for the pair
// (``pair_contact``).  Of the two face-clipping branches only the one the
// manifold reads (reference box 1 for codes 1-3, else box 2) runs.
__device__ bool box_box(V3 p1, const M3& R1, const float* he1, V3 p2,
                        const M3& R2, const float* he2, Manifold& mf) {
  V3 d = p2 - p1;
  V3 ax1[3], ax2[3];
  for (int i = 0; i < 3; ++i) {
    ax1[i] = col(R1, i);
    ax2[i] = col(R2, i);
  }
  float pp[3], qq[3], Rr[3][3], Q[3][3];
  for (int i = 0; i < 3; ++i) {
    pp[i] = dot(ax1[i], d);
    qq[i] = dot(ax2[i], d);
  }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      Rr[i][j] = dot(ax1[i], ax2[j]);
      Q[i][j] = fabsf(Rr[i][j]);
    }
  float s = -INFINITY;
  int code = 0;
  bool invert = false, separated = false;
  V3 axis = vzero();
  for (int i = 0; i < 3; ++i) {
    float e2 = he1[i] + (he2[0] * Q[i][0] + he2[1] * Q[i][1] +
                         he2[2] * Q[i][2]);
    float s2 = fabsf(pp[i]) - e2;
    separated |= s2 > 0.f;
    if (s2 > s) { s = s2; code = i + 1; invert = pp[i] < 0.f; axis = ax1[i]; }
  }
  for (int j = 0; j < 3; ++j) {
    float e2 = (he1[0] * Q[0][j] + he1[1] * Q[1][j] + he1[2] * Q[2][j]) +
               he2[j];
    float s2 = fabsf(qq[j]) - e2;
    separated |= s2 > 0.f;
    if (s2 > s) { s = s2; code = j + 4; invert = qq[j] < 0.f; axis = ax2[j]; }
  }
  for (int i = 0; i < 3; ++i) {
    int i1 = i == 0 ? 1 : 0, i2 = i == 2 ? 1 : 2;
    for (int j = 0; j < 3; ++j) {
      int j1 = j == 0 ? 1 : 0, j2 = j == 2 ? 1 : 2;
      float expr1 = pp[i2] * Rr[i1][j] - pp[i1] * Rr[i2][j];
      float e2 = he1[i1] * (Q[i2][j] + FUDGE2) + he1[i2] * (Q[i1][j] + FUDGE2) +
                 he2[j1] * (Q[i][j2] + FUDGE2) + he2[j2] * (Q[i][j1] + FUDGE2);
      float s2 = fabsf(expr1) - e2;
      separated |= s2 > SIMD_EPSILON;
      V3 axv = cross(ax1[i], ax2[j]);
      float length = norm(axv);
      bool ok = length > SIMD_EPSILON;
      float s2n = s2 / fmaxf(length, SIMD_EPSILON);
      V3 axn = axv * (1.0f / fmaxf(length, SIMD_EPSILON));
      if (ok & (s2n * FUDGE_FACTOR > s)) {
        s = s2n; code = 7 + 3 * i + j; invert = expr1 < 0.f; axis = axn;
      }
    }
  }
  V3 normal = invert ? -axis : axis;
  bool is_edge = code > 6;
  float depth_axis = -s;
  mf.normal = normal;
  mf.overlap = false;
  if (separated | (code <= 0)) return false;

  // edge-edge single contact
  V3 pa_e = p1;
  for (int k = 0; k < 3; ++k) {
    float sg = dot(normal, ax1[k]) > 0.f ? 1.f : -1.f;
    pa_e = pa_e + ax1[k] * (sg * he1[k]);
  }
  V3 pb_e = p2;
  for (int k = 0; k < 3; ++k) {
    float sg = dot(normal, ax2[k]) > 0.f ? -1.f : 1.f;
    pb_e = pb_e + ax2[k] * (sg * he2[k]);
  }
  int ecode = code - 7 > 0 ? code - 7 : 0;
  V3 ua = ax1[ecode / 3], ub = ax2[ecode % 3];
  V3 pd = pb_e - pa_e;
  float uaub = dot(ua, ub);
  float q1 = dot(ua, pd);
  float q2 = -dot(ub, pd);
  float dd = 1.0f - uaub * uaub;
  bool good = dd > 1e-4f;
  float ddi = 1.0f / (good ? dd : 1.0f);
  float beta = good ? (uaub * q1 + q2) * ddi : 0.f;
  V3 edge_pt = pb_e + ub * beta;

  V3 pts[4];
  float deps[4];
  bool ref_is_1 = code <= 3;
  if (ref_is_1)
    face_branch(ax1, p1, he1, ax2, p2, he2, normal, code, 1, pts, deps);
  else
    face_branch(ax2, p2, he2, ax1, p1, he1, -normal, code, 4, pts, deps);
  for (int q = 0; q < 4; ++q) {
    V3 pt = ref_is_1 ? pts[q] : pts[q] - normal * deps[q];
    float dp = deps[q];
    bool act;
    if (q == 0) {
      pt = is_edge ? edge_pt : pt;
      dp = is_edge ? depth_axis : dp;
      act = is_edge | (!is_edge & (dp >= 0.f));
    } else {
      act = !is_edge & (dp >= 0.f);
    }
    mf.points[q] = pt;
    mf.depth[q] = dp;
    mf.active[q] = act;
    mf.overlap |= act;
  }
  return mf.overlap;
}

struct PairOut {
  V3 dv0, dw0, dv1, dw1, push0, push1, turn0, turn1;
};

// The 4-row pair solver (ctick._pgs_pair).  Only the active rows run: an
// inactive row's impulse is 0 times a finite value in the plain version,
// which adds exact zeros to sums that start at +0 (as in ``pgs_rows``).
__device__ void pgs_pair(const Params& P, V3 v0, V3 w0, V3 v1, V3 w1,
                         const V3* r0s, const V3* r1s, V3 n,
                         const int* act, const M3& I0, const M3& I1,
                         const float* deps, V3 v0_pre, V3 v1_pre,
                         PairOut& o) {
  const float inv_mass = P.inv_car_mass;
  float jac_inv[4], rest[4], t_jac_inv[4], push_tgt[4];
  V3 t_dir[4];
  for (int p = 0; p < 4; ++p) {
    if (!act[p]) continue;
    V3 r0 = r0s[p], r1 = r1s[p];
    V3 ang0 = matvec(I0, cross(r0, n));
    V3 ang1 = matvec(I1, cross(r1, n));
    float denom = 2.0f * inv_mass + dot(n, cross(ang0, r0)) +
                  dot(n, cross(ang1, r1));
    jac_inv[p] = 1.0f / fmaxf(denom, 1e-12f);
    float rel_rest = dot(n, (v0_pre + cross(w0, r0)) - (v1_pre + cross(w1, r1)));
    rest[p] = restitution_rhs(rel_rest, CARCAR_RESTITUTION);
    V3 rel_v = (v0 + cross(w0, r0)) - (v1 + cross(w1, r1));
    V3 tang = rel_v - n * dot(n, rel_v);
    float t_len = norm(tang);
    V3 td = t_len > 1.49e-8f ? tang * (1.0f / fmaxf(t_len, 1e-12f))
                             : plane_space(n);
    t_dir[p] = td;
    V3 f0 = matvec(I0, cross(r0, td));
    V3 f1 = matvec(I1, cross(r1, td));
    float t_den = 2.0f * inv_mass + dot(td, cross(f0, r0)) +
                  dot(td, cross(f1, r1));
    t_jac_inv[p] = 1.0f / fmaxf(t_den, 1e-12f);
    push_tgt[p] = fmaxf(deps[p], 0.f) * (SOLVER_ERP2 / P.dt);
  }
  V3 dv0 = vzero(), dw0 = vzero(), dv1 = vzero(), dw1 = vzero();
  float j_n[4] = {0.f, 0.f, 0.f, 0.f}, j_t[4] = {0.f, 0.f, 0.f, 0.f};
#define PGS_APPLY(D, R0, R1, DJ)                      \
  {                                                   \
    V3 imp_ = (D) * (DJ);                             \
    dv0 = dv0 + imp_ * inv_mass;                      \
    dw0 = dw0 + matvec(I0, cross((R0), imp_));        \
    dv1 = dv1 - imp_ * inv_mass;                      \
    dw1 = dw1 - matvec(I1, cross((R1), imp_));        \
  }
#pragma unroll 1
  for (int it = 0; it < 10; ++it) {
    for (int p = 0; p < 4; ++p) {
      if (!act[p]) continue;
      V3 r0 = r0s[p], r1 = r1s[p];
      float rel = dot(n, ((v0 + dv0) + cross(w0 + dw0, r0)) -
                             ((v1 + dv1) + cross(w1 + dw1, r1)));
      float dj = (rest[p] - rel) * jac_inv[p];
      float new_acc = fmaxf(j_n[p] + dj, 0.f);
      dj = new_acc - j_n[p];
      PGS_APPLY(n, r0, r1, dj);
      j_n[p] = j_n[p] + dj;
    }
    for (int p = 0; p < 4; ++p) {
      if (!act[p]) continue;
      V3 r0 = r0s[p], r1 = r1s[p], td = t_dir[p];
      float rel = dot(td, ((v0 + dv0) + cross(w0 + dw0, r0)) -
                              ((v1 + dv1) + cross(w1 + dw1, r1)));
      float dj = -rel * t_jac_inv[p];
      float lim = CARCAR_FRICTION * j_n[p];
      float new_acc = clampf(j_t[p] + dj, -lim, lim);
      dj = new_acc - j_t[p];
      dj = j_n[p] > 0.f ? dj : 0.f;
      PGS_APPLY(td, r0, r1, dj);
      j_t[p] = j_t[p] + dj;
    }
  }
  o.dv0 = dv0; o.dw0 = dw0; o.dv1 = dv1; o.dw1 = dw1;
  dv0 = dw0 = dv1 = dw1 = vzero();
  float j_p[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
  for (int it = 0; it < 10; ++it) {
    for (int p = 0; p < 4; ++p) {
      if (!act[p]) continue;
      V3 r0 = r0s[p], r1 = r1s[p];
      float rel = dot(n, (dv0 + cross(dw0, r0)) - (dv1 + cross(dw1, r1)));
      float dj = (push_tgt[p] - rel) * jac_inv[p];
      float new_acc = fmaxf(j_p[p] + dj, 0.f);
      dj = new_acc - j_p[p];
      PGS_APPLY(n, r0, r1, dj);
      j_p[p] = j_p[p] + dj;
    }
  }
#undef PGS_APPLY
  o.push0 = dv0 * P.dt;
  o.push1 = dv1 * P.dt;
  o.turn0 = dw0 * P.turn_erp_dt;
  o.turn1 = dw1 * P.turn_erp_dt;
}

// One car pair's results as the plain version adds them to each car:
// velocity, spin, split-impulse push and turn (already scaled), the bump
// velocity each direction adds to the bumped car, and the events.
struct PairRes {
  V3 dv0, dv1, dw0, dw1, push0, push1, turn0, turn1;
  V3 cache_j, cache_i;    // bump velocity onto j (i bumps j), onto i
  int bump_ij, bump_ji;   // i bumped j, j bumped i
  int demo_ij, demo_ji;   // i demolished j, j demolished i
  int same_team;
};

// Pair (i, j), i < j (ctick._car_car, one pair): the manifold, the pair
// solver, then bump/demo both ways with the pre-force velocities.  Reads
// the state as it was when the car-car stage began.  A pair that is not in
// contact, or with a demolished car, has no active point: its solver adds
// zeros and no bump happens (``overlap`` is false), so its results are
// zeros and no events, as the plain version's.
template <int NC>
__device__ __noinline__ void pair_contact(const Params& P, const Curve* cv,
                                          const Arena<NC>& a, const M3* iw,
                                          const int* alive,
                                          const V3* vel_pre, int i, int j,
                                          PairRes& o) {
  o.dv0 = o.dv1 = o.dw0 = o.dw1 = o.push0 = o.push1 = o.turn0 = o.turn1 =
      o.cache_j = o.cache_i = vzero();
  o.bump_ij = o.bump_ji = o.demo_ij = o.demo_ji = 0;
  o.same_team = P.teams[i] == P.teams[j] ? 1 : 0;
  if (!(alive[i] & alive[j])) return;
  const Car& ci = a.car[i];
  const Car& cj = a.car[j];
  const V3 off = v3(P.hitbox_offset[0], P.hitbox_offset[1],
                    P.hitbox_offset[2]);
  const V3 bc_i = (ci.pos + matvec(ci.rot, off)) * UU_TO_BT;
  const V3 bc_j = (cj.pos + matvec(cj.rot, off)) * UU_TO_BT;
  // Apart for the separating-axis test already: the face axis of box i
  // nearest the centre line carries at least 1/sqrt(3) of the centres'
  // distance D, and the two boxes' extents along it are at most the sum
  // of their bounding radii R, so D^2 > 3 R^2 (with 1% to spare for
  // rounding) makes that axis separating and the pair is apart.
  const V3 dc = bc_j - bc_i;
  const float R = 2.0f * sqrtf(P.he_eff_bt[0] * P.he_eff_bt[0] +
                               P.he_eff_bt[1] * P.he_eff_bt[1] +
                               P.he_eff_bt[2] * P.he_eff_bt[2]);
  if (dot(dc, dc) > 3.03f * R * R) return;
  Manifold mf;
  if (!box_box(bc_i, ci.rot, P.he_eff_bt, bc_j, cj.rot, P.he_eff_bt, mf))
    return;
  const bool overlap = mf.overlap;
  int act[4];
  for (int p = 0; p < 4; ++p) act[p] = mf.active[p] ? 1 : 0;
  V3 n_on_b = -mf.normal;
  V3 pos_i_bt = ci.pos * UU_TO_BT, pos_j_bt = cj.pos * UU_TO_BT;
  V3 posA[4], r0s[4], r1s[4];
  for (int p = 0; p < 4; ++p) {
    posA[p] = mf.points[p] + mf.normal * mf.depth[p];
    r0s[p] = posA[p] - pos_i_bt;
    r1s[p] = mf.points[p] - pos_j_bt;
  }
  PairOut po;
  pgs_pair(P, ci.vel * UU_TO_BT, ci.ang_vel, cj.vel * UU_TO_BT, cj.ang_vel,
           r0s, r1s, n_on_b, act, iw[i], iw[j], mf.depth,
           vel_pre[i] * UU_TO_BT, vel_pre[j] * UU_TO_BT, po);
  o.dv0 = po.dv0 * BT_TO_UU;
  o.dv1 = po.dv1 * BT_TO_UU;
  o.dw0 = po.dw0;
  o.dw1 = po.dw1;
  o.push0 = po.push0 * BT_TO_UU;
  o.push1 = po.push1 * BT_TO_UU;
  o.turn0 = po.turn0;
  o.turn1 = po.turn1;

  // contact points in each body's frame for the bumper test
  bool hwb_i = false, hwb_j = false;
  for (int p = 0; p < 4; ++p) {
    V3 lp_i = mat_t_vec(ci.rot, posA[p] * BT_TO_UU - ci.pos);
    V3 lp_j = mat_t_vec(cj.rot, mf.points[p] * BT_TO_UU - cj.pos);
    hwb_i = hwb_i | (act[p] & (lp_i.x > BUMP_MIN_FORWARD_DIST));
    hwb_j = hwb_j | (act[p] & (lp_j.x > BUMP_MIN_FORWARD_DIST));
  }
  for (int dir = 0; dir < 2; ++dir) {
    const int ia = dir == 0 ? i : j, ib = dir == 0 ? j : i;
    const Car& ka = a.car[ia];
    const Car& kb = a.car[ib];
    V3 va = vel_pre[ia], vb = vel_pre[ib];
    V3 delta_pos = kb.pos - ka.pos;
    bool going_towards = dot(va, delta_pos) > 0.f;
    V3 vel_dir = normalize(va);
    float speed_towards = dot(va, normalize(delta_pos));
    float other_away = dot(vb, vel_dir);
    bool in_cooldown = (ka.contact_other_id == ib + 1) &
                       (ka.car_contact_cooldown > 0.f);
    bool bump = overlap & going_towards & !in_cooldown &
                (speed_towards > other_away) &
                (dir == 0 ? hwb_i : hwb_j);
    bool is_demo;
    if (P.demo_mode == 1.f) is_demo = bump;            // ON_CONTACT
    else if (P.demo_mode == 2.f) is_demo = false;      // DISABLED
    else is_demo = bump & ka.is_supersonic;            // NORMAL
    if ((P.enable_team_demos == 0.f) & (o.same_team != 0)) is_demo = false;
    bool plain_bump = bump & !is_demo;
    bool ground_hit = kb.on_ground;
    float base_scale = ground_hit ? curve(cv[CV_BUMP_GROUND], speed_towards)
                                  : curve(cv[CV_BUMP_AIR], speed_towards);
    V3 hit_up_dir = ground_hit ? up_of(kb.rot) : v3(0.f, 0.f, 1.f);
    V3 bump_imp = vel_dir * base_scale +
                  hit_up_dir * (curve(cv[CV_BUMP_UP], speed_towards) *
                                P.bump_force_scale);
    const V3 cache = plain_bump ? bump_imp : vzero();
    if (dir == 0) {
      o.cache_j = cache; o.bump_ij = bump; o.demo_ij = is_demo;
    } else {
      o.cache_i = cache; o.bump_ji = bump; o.demo_ji = is_demo;
    }
  }
}

// Car c's sums over the pairs, in pair order as the plain version takes
// them: velocity, spin, push, turn, bump velocity; and its events: the
// slot it bumped last (+1, 0: none), demolished, and the per-step latches.
struct CarPairSum {
  V3 dvel, dang, push, turn, cache;
  int got_demoed, bumped_id, l_bump, l_bumped, l_demo, l_demoed;
};

template <int NC>
__device__ CarPairSum pair_sum(const PairRes* pr, int c) {
  CarPairSum s;
  s.dvel = s.dang = s.push = s.turn = s.cache = vzero();
  s.got_demoed = s.bumped_id = s.l_bump = s.l_bumped = s.l_demo =
      s.l_demoed = 0;
  int p = 0;
  for (int i = 0; i < NC; ++i)
    for (int j = i + 1; j < NC; ++j, ++p) {
      const PairRes& o = pr[p];
      if (c == i) {
        s.dvel = s.dvel + o.dv0;
        s.dang = s.dang + o.dw0;
        s.push = s.push + o.push0;
        s.turn = s.turn + o.turn0;
        // direction 1 (j bumps i) reaches car i
        s.cache = s.cache + o.cache_i;
        s.got_demoed = s.got_demoed | o.demo_ji;
        s.bumped_id = max(s.bumped_id, o.bump_ij ? j + 1 : 0);
        if (!o.same_team) {
          s.l_bump |= o.bump_ij;
          s.l_bumped |= o.bump_ji;
          s.l_demo |= o.demo_ij;
          s.l_demoed |= o.demo_ji;
        }
      } else if (c == j) {
        s.dvel = s.dvel + o.dv1;
        s.dang = s.dang + o.dw1;
        s.push = s.push + o.push1;
        s.turn = s.turn + o.turn1;
        // direction 0 (i bumps j) reaches car j
        s.cache = s.cache + o.cache_j;
        s.got_demoed = s.got_demoed | o.demo_ij;
        s.bumped_id = max(s.bumped_id, o.bump_ji ? i + 1 : 0);
        if (!o.same_team) {
          s.l_bump |= o.bump_ji;
          s.l_bumped |= o.bump_ij;
          s.l_demo |= o.demo_ji;
          s.l_demoed |= o.demo_ij;
        }
      }
    }
  return s;
}

// Boost pads with the lock hysteresis (ctick._pads_pickup), in three
// parts: each car's hitbox centre and world half extents, then each pad
// (its collision test over the cars, its state; returns the winning slot
// + 1 where it was picked up, else 0), then each car's boost, summing its
// pickups in pad order.
__device__ void pad_box(const Params& P, const Car& k, V3& bc, V3& ah) {
  V3 off = v3(P.hitbox_offset[0], P.hitbox_offset[1], P.hitbox_offset[2]);
  bc = k.pos + matvec(k.rot, off);
  const M3& R = k.rot;
  ah = v3(fabsf(R.m[0][0]) * P.pad_he[0] + fabsf(R.m[0][1]) * P.pad_he[1] +
              fabsf(R.m[0][2]) * P.pad_he[2],
          fabsf(R.m[1][0]) * P.pad_he[0] + fabsf(R.m[1][1]) * P.pad_he[1] +
              fabsf(R.m[1][2]) * P.pad_he[2],
          fabsf(R.m[2][0]) * P.pad_he[0] + fabsf(R.m[2][1]) * P.pad_he[1] +
              fabsf(R.m[2][2]) * P.pad_he[2]);
}

template <int NC>
__device__ int pad_pickup(const Params& P, Arena<NC>& a, int p,
                          const V3* bc, const V3* ah, const int* alive) {
  const float lx = P.pad_locs[p][0], ly = P.pad_locs[p][1],
              lz = P.pad_locs[p][2];
  const bool big = P.pad_is_big[p] != 0.f;
  const float rad_sq = big ? PAD_CYL_RAD_BIG_SQ : PAD_CYL_RAD_SMALL_SQ;
  const float box_rad = big ? PAD_BOX_RAD_BIG : PAD_BOX_RAD_SMALL;
  bool any_collide = false;
  int winner = 0;
  for (int c = 0; c < NC; ++c) {
    const Car& k = a.car[c];
    float dx = k.pos.x - lx, dy = k.pos.y - ly;
    float d2 = dx * dx + dy * dy;
    bool cyl_hit = (d2 < rad_sq) & (fabsf(k.pos.z - lz) < PAD_CYL_HEIGHT);
    bool aabb_hit = (lx + box_rad > bc[c].x - ah[c].x) &
                    (lx - box_rad < bc[c].x + ah[c].x) &
                    (ly + box_rad > bc[c].y - ah[c].y) &
                    (ly - box_rad < bc[c].y + ah[c].y) &
                    (lz + PAD_BOX_HEIGHT > bc[c].z - ah[c].z) &
                    (lz < bc[c].z + ah[c].z);
    bool lock_c = a.pad_locked[p] == c + 1;
    bool col_c = (lock_c ? aabb_hit : cyl_hit) & (alive[c] != 0);
    any_collide = any_collide | col_c;
    winner = col_c ? c + 1 : winner;
  }
  bool pickup = any_collide & a.pad_active[p];
  a.pad_active[p] = a.pad_active[p] & !pickup;
  if (pickup)
    a.pad_cd[p] = big ? P.boost_pad_cooldown_big : P.boost_pad_cooldown_small;
  a.pad_locked[p] = winner;
  return pickup ? winner : 0;
}

__device__ void pad_gain(const Params& P, Car& k, int c, const int* win) {
  float gained = 0.f;
  for (int p = 0; p < NPADS; ++p) {
    const float amount =
        P.pad_is_big[p] != 0.f ? PAD_AMOUNT_BIG : PAD_AMOUNT_SMALL;
    gained = gained + (win[p] == c + 1 ? amount : 0.f);
  }
  k.boost = fminf(k.boost + gained, BOOST_MAX);
}

// Car::Respawn at the drawn table row, mirrored for orange (ctick._respawn).
__device__ void respawn(const Params& P, Car& k, int slot, int idx) {
  float sx = 0.f, sy = 0.f, syaw = 0.f;
  for (int r = 0; r < NRESPAWN; ++r) {
    if (idx == r) {
      sx = P.respawn_table[r][0];
      sy = P.respawn_table[r][1];
      syaw = P.respawn_table[r][2];
    }
  }
  const bool blue = P.teams[slot] == 0.f;
  k.pos = v3(sx, sy * (blue ? 1.f : -1.f), CAR_RESPAWN_Z);
  k.rot = yaw_mat(syaw + (blue ? 0.f : PI_F));
  k.vel = k.ang_vel = vzero();
  k.on_ground = true;
  for (int w = 0; w < 4; ++w) k.wheels[w] = 0;
  k.has_jumped = k.has_double_jumped = k.has_flipped = k.is_flipping = false;
  k.is_jumping = k.is_supersonic = k.is_auto_flipping = false;
  k.has_world_contact = k.is_demoed = false;
  k.flip_rel_torque = k.world_contact_normal = vzero();
  k.jump_time = k.flip_time = k.air_time = k.air_time_since_jump = 0.f;
  k.time_spent_boosting = k.supersonic_time = k.handbrake_val = 0.f;
  k.auto_flip_timer = k.auto_flip_torque_scale = 0.f;
  k.car_contact_cooldown = k.demo_respawn_timer = 0.f;
  k.boost = P.car_spawn_boost_amount;
  k.contact_other_id = 0;
}

// ---------------------------------------------------------------------------
// One 1/120 s tick (ctick.tick), stage for stage, by the arena's lanes.

__host__ __device__ constexpr int npairs(int nc) {
  return nc > 1 ? nc * (nc - 1) / 2 : 1;
}

// An arena and every per-car scratch array of a tick, in shared memory.
template <int NC>
struct Work {
  Arena<NC> a;
  Car frozen[NC];
  M3 iw[NC];
  int alive[NC], ridx[NC], touched[NC];
  Rays rcs[NC];
  V3 imps[NC][4];
  V3 vel_pre[NC], ang_vel_pre[NC], cw_push[NC], cw_turn[NC];
  V3 cb_imp[NC], cb_rimp[NC], cb_add[NC];
  V3 pad_bc[NC], pad_ah[NC];
  int pad_win[NPADS];
  V3 ball_vel_pre, ball_cache_dv, bw_push;
  Keep4<7, 3> kbox[NC];
  Keep4<4, 0> kball;
  PairRes pairs[npairs(NC)];
};

// Work item i of n per lane; every lane of the arena then meets at SYNC.
#define LANE_FOR(i, n) for (int i = lane; i < (n); i += LANES)
#define SYNC() __syncwarp(mask)

// A measurement build (-DARENA_STEP_STAGE_CLOCKS, kernel_variants.py
// --stages) meets at the end of every stage below, STAGE(i) included, and
// adds the cycles lane 0 spent since the last meeting to stage i's sum.
constexpr int NSTAGES = 11;
#ifdef ARENA_STEP_STAGE_CLOCKS
__device__ unsigned long long g_stage_cycles[NSTAGES];
#define STAGE_CLOCK_START unsigned long long t_stage = clock64();
#define STAGE(i)                                                  \
  {                                                               \
    SYNC();                                                       \
    if (lane == 0) {                                              \
      const unsigned long long t_ = clock64();                    \
      atomicAdd(&g_stage_cycles[i], t_ - t_stage);                \
      t_stage = t_;                                               \
    }                                                             \
  }
#define STAGE_END(i) STAGE(i)
#else
#define STAGE_CLOCK_START
#define STAGE(i)
#define STAGE_END(i) SYNC()
#endif

template <int NC>
__device__ void tick(const Params& P, const Tabs& Tb, Work<NC>& w,
                     const Bufs& B, int e, bool new_controls, int lane,
                     unsigned mask) {
  Arena<NC>& a = w.a;
  const float dt = P.dt;
  const bool mesh = FLAG_ON(P.use_mesh);
  const int mode = GAME_MODE(P);
  const bool ball_facets = mesh && mode != MODE_SNOWDAY;
  STAGE_CLOCK_START

  // controls, demo timer and respawn (Car.cpp:68-87), tick-start copies
  LANE_FOR(c, NC) {
    Car& k = a.car[c];
    float* ctl = k.controls;
    if (new_controls)
      for (int i = 0; i < 8; ++i)
        ctl[i] = B.controls[((size_t)i * NC + c) * B.E + e];
    for (int i = 0; i < 5; ++i) ctl[i] = clampf(ctl[i], -1.f, 1.f);
    for (int i = 5; i < 8; ++i) ctl[i] = ctl[i] > 0.f ? 1.f : 0.f;
    if (k.is_demoed) {
      k.demo_respawn_timer = fmaxf(k.demo_respawn_timer - dt, 0.f);
      if (k.demo_respawn_timer == 0.f) respawn(P, k, c, w.ridx[c]);
    }
    w.alive[c] = k.is_demoed ? 0 : 1;
    w.frozen[c] = k;
    w.iw[c] = inv_inertia_world(k.rot, P.inv_i_local[0], P.inv_i_local[1],
                                P.inv_i_local[2]);
    w.kbox[c].n_live = 0;
  }
  if (lane == 0) w.kball.n_live = 0;
  STAGE_END(0);

  // updateVehicleFirst: every wheel's ray and previous-tick friction, read
  // from the state after the respawns (dynamic rays see the others); and
  // every body's live facet candidates (the car boxes' and the ball's
  // positions hold until the contacts are solved)
  LANE_FOR(cw, NC * 4) {
    const int c = cw >> 2, wh = cw & 3;
    wheel_ray<NC>(P, Tb, a, c, wh, w.alive, w.iw[c], w.rcs[c]);
    w.imps[c][wh] = friction_impulse<NC>(P, a, c, wh, w.rcs[c], w.iw);
  }
  STAGE(1);
  if (mesh) {
    LANE_FOR(it, (NC + (ball_facets ? 1 : 0)) * NITEMS) {
      const int body = it / NITEMS, item = it - body * NITEMS;
      if (body < NC) {
        const Car& k = a.car[body];
        Keep4<7, 3>& kp = w.kbox[body];
        auto col = [&](int idx, float d, const float* pay) {
          kp.collect(idx, d, pay);
        };
        box_item(P, Tb, k, car_box_q(P, k), item, col);
      } else {
        auto col = [&](int idx, float d, const float* pay) {
          w.kball.collect(idx, d, pay);
        };
        ball_item(Tb, facets::sphere_q(a.bpos, P.ball_radius,
                                       P.ball_world_break),
                  item, col);
      }
    }
  }
  STAGE_END(2);

  // each body's 4-slot retention (the lane of car c solves its contacts
  // below; the ball's is read after the next meeting)
  if (mesh) {
    LANE_FOR(b, NC + 1) {
      if (b < NC) {
        if (w.kbox[b].n_live == 0) w.kbox[b].clear();
        else retain_box(P, Tb, a.car[b], w.kbox[b]);
      } else if (ball_facets) {
        if (w.kball.n_live == 0) w.kball.clear();
        else retain_ball(P, Tb, a.bpos, w.kball);
      }
    }
  }
  STAGE(3);

  LANE_FOR(c, NC) {
    Car& k = a.car[c];
    float* ctl = k.controls;
    const Rays& rc = w.rcs[c];
    const V3* imps = w.imps[c];
    const M3& iw = w.iw[c];
    int num_contact = rc.hit[0] + rc.hit[1] + rc.hit[2] + rc.hit[3];
    for (int wh = 0; wh < 4; ++wh) k.wheels[wh] = rc.hit[wh];
    k.on_ground = num_contact >= 3;

    bool jump_pressed = (ctl[JUMP] > 0.f) & !(k.last_controls[JUMP] > 0.f);
    float fwd_speed = dot(k.vel, fwd_of(k.rot));
    V3 sticky = update_wheels(P, Tb.curves, k, rc, ctl, fwd_speed,
                              num_contact);

    bool air_mask = num_contact < 3;
    bool is_flipping;
    V3 air_ang, air_acc;
    update_air_torque(k, ctl, air_mask, num_contact == 0, air_ang, air_acc,
                      is_flipping);
    k.is_flipping = is_flipping & air_mask;

    V3 jdv, jump_acc;
    update_jump(P, k, ctl, jump_pressed, jdv, jump_acc);
    k.vel = k.vel + jdv;

    V3 af_dv, af_dw;
    update_auto_flip(P, k, jump_pressed, af_dv, af_dw);
    k.vel = k.vel + af_dv;
    k.ang_vel = k.ang_vel + af_dw;

    V3 dj_dv;
    bool zdamp_maybe, zdamp_always;
    update_double_jump_or_flip(P, k, ctl, jump_pressed, fwd_speed, dj_dv,
                               zdamp_maybe, zdamp_always);
    V3 vel = k.vel + dj_dv;
    bool do_damp = zdamp_always | (zdamp_maybe & (vel.z < 0.f));
    k.vel = v3(vel.x, vel.y, vel.z * (do_damp ? P.flip_z_damp_factor : 1.f));

    bool ar_cond = (ctl[THROTTLE] != 0.f) &
                   (((num_contact > 0) & (num_contact < 4)) |
                    k.has_world_contact);
    V3 ar_acc, ar_ang;
    update_auto_roll(k, rc, num_contact, ar_acc, ar_ang);
    if (!ar_cond) ar_acc = ar_ang = vzero();
    k.has_world_contact = false;

    // updateVehicleSecond: suspension and friction
    apply_suspension(P, k, rc, iw);
    apply_friction_impulses(P, k, rc, imps, iw);
    V3 boost_acc = update_boost(P, k, ctl);

    // world step; restitution and callbacks read pre-force velocities
    const V3 gravity = v3(0.f, 0.f, P.gravity_z);
    w.vel_pre[c] = k.vel;
    w.ang_vel_pre[c] = k.ang_vel;
    V3 total = gravity + sticky + air_acc + jump_acc + ar_acc + boost_acc;
    V3 total_ang = air_ang + ar_ang;
    k.vel = k.vel + total * dt;
    k.ang_vel = k.ang_vel + total_ang * dt;
  }
  LANE_FOR(p, NPADS) {
    a.pad_cd[p] = fmaxf(a.pad_cd[p] - dt, 0.f);
    a.pad_active[p] = a.pad_cd[p] == 0.f;
  }
  STAGE_END(4);

  // the ball's pre-tick (heatseeker steering), sleeping, gravity and drag;
  // each car against the world
  if (lane == 0) {
    if (mode == MODE_HEATSEEKER) hs_steer(P, a);
    bool ball_awake = (norm(a.bvel) > 0.f) | (norm(a.bang) > 0.f);
    w.ball_vel_pre = a.bvel;
    if (ball_awake)
      a.bvel = (a.bvel + v3(0.f, 0.f, P.gravity_z) * dt) * P.ball_drag_factor;
  }
  LANE_FOR(c, NC) {
    Car& k = a.car[c];
    V3 dv, dw, n;
    bool contact;
    if (mesh)
      resolve_car_world_mesh(P, Tb, k, w.kbox[c], w.iw[c], w.vel_pre[c],
                             w.ang_vel_pre[c], dv, dw, w.cw_push[c],
                             w.cw_turn[c], contact, n);
    else
      resolve_car_world(P, Tb, k, w.iw[c], w.vel_pre[c], w.ang_vel_pre[c],
                        dv, dw, w.cw_push[c], contact, n);
    k.vel = k.vel + dv;
    k.ang_vel = k.ang_vel + dw;
    k.has_world_contact = contact;
    if (contact) k.world_contact_normal = n;
  }
  STAGE_END(5);

  // every car against the ball as the stage found it
  LANE_FOR(c, NC)
    car_ball<NC>(P, Tb.curves, a, c, w.iw[c], w.alive[c], w.vel_pre[c],
                 w.ball_vel_pre, w.cb_imp[c], w.cb_rimp[c], w.cb_add[c],
                 w.touched[c]);
  STAGE_END(6);

  // the ball: the car impulses summed in car order, Ball::_OnHit
  // (heatseeker retargeting), the world contact and its callback (the
  // heatseeker back-wall flip, the snowday ground stick); meanwhile the car
  // pairs, which read no ball state
  if (lane == 0) {
    w.ball_cache_dv = car_ball_sum<NC>(P, a, w.cb_imp, w.cb_rimp, w.cb_add);
    if (mode == MODE_HEATSEEKER) hs_on_hit(P, a, w.touched);
    V3 bw_navg;
    int bw_touch;
    if (mode == MODE_SNOWDAY)
      resolve_ball_world_snowday(P, Tb, a, w.ball_vel_pre, w.bw_push,
                                 bw_touch, bw_navg);
    else if (mesh)
      resolve_ball_world_mesh(P, Tb, a, w.kball, w.ball_vel_pre, w.bw_push,
                              bw_touch, bw_navg);
    else
      resolve_ball_world(P, Tb, a, w.ball_vel_pre, w.bw_push, bw_touch,
                         bw_navg);
    if (mode == MODE_HEATSEEKER) {
      hs_wall_bounce(a, bw_touch, bw_navg, w.ball_cache_dv);
    } else if (mode == MODE_SNOWDAY && bw_touch) {
      a.bvel = a.bvel - bw_navg * P.snow_stick;
    }
  }
  if (NC > 1) {
    LANE_FOR(p, npairs(NC)) {
      int i = 0, q = p;
      while (q >= NC - 1 - i) {
        q -= NC - 1 - i;
        ++i;
      }
      pair_contact<NC>(P, Tb.curves, a, w.iw, w.alive, w.vel_pre, i,
                       i + 1 + q, w.pairs[p]);
    }
  }
  STAGE_END(7);

  LANE_FOR(c, NC) {
    Car& k = a.car[c];
    CarPairSum s;
    if (NC > 1) {
      s = pair_sum<NC>(w.pairs, c);
      k.vel = k.vel + s.dvel;
      k.ang_vel = k.ang_vel + s.dang;
      if (s.bumped_id > 0) {
        k.contact_other_id = s.bumped_id;
        k.car_contact_cooldown = P.bump_cooldown_time;
      }
      k.is_demoed = k.is_demoed | (s.got_demoed != 0);
      if (s.got_demoed) k.demo_respawn_timer = P.respawn_delay;
    }
    // integrate transforms
    V3 pos = k.pos + k.vel * dt + w.cw_push[c];
    k.pos = NC > 1 ? pos + s.push : pos;
    k.rot = integrate_rotation(k.rot, k.ang_vel, dt);
    // split-impulse turn of the world contacts, then of the car pairs
    if (mesh) k.rot = integrate_rotation(k.rot, w.cw_turn[c], 1.0f);
    if (NC > 1) k.rot = integrate_rotation(k.rot, s.turn, 1.0f);

    // supersonic state and speed clamps
    float speed_sq = dot(k.vel, k.vel);
    bool maintain = k.is_supersonic &
                    (k.supersonic_time < SUPERSONIC_MAINTAIN_MAX_TIME);
    float thresh = maintain ? SUPERSONIC_MAINTAIN_MIN_SPEED
                            : SUPERSONIC_START_SPEED;
    bool is_ss = speed_sq >= thresh * thresh;
    k.is_supersonic = is_ss;
    k.supersonic_time = is_ss ? k.supersonic_time + dt : 0.f;
    k.car_contact_cooldown = fmaxf(k.car_contact_cooldown - dt, 0.f);
    for (int i = 0; i < 8; ++i) k.last_controls[i] = k.controls[i];
    k.vel = clamp_norm(NC > 1 ? k.vel + s.cache : k.vel + vzero(),
                       CAR_MAX_SPEED);
    k.ang_vel = clamp_norm(k.ang_vel, CAR_MAX_ANG_SPEED);

    // cars demolished at tick start stay frozen (latches are arena-level
    // in the plain version, so they survive the restore)
    if (!w.alive[c]) {
      bool sb = k.step_bump, sbd = k.step_bumped, sd = k.step_demo,
           sdd = k.step_demoed;
      k = w.frozen[c];
      k.step_bump = sb; k.step_bumped = sbd; k.step_demo = sd;
      k.step_demoed = sdd;
    }
    // this tick's latches (the plain version ORs them in at the tick's
    // end; nothing between reads them)
    if (NC > 1) {
      k.step_bump = k.step_bump | (s.l_bump != 0);
      k.step_bumped = k.step_bumped | (s.l_bumped != 0);
      k.step_demo = k.step_demo | (s.l_demo != 0);
      k.step_demoed = k.step_demoed | (s.l_demoed != 0);
    }
    pad_box(P, k, w.pad_bc[c], w.pad_ah[c]);
  }
  if (lane == 0) {
    bool ball_awake = (norm(a.bvel) > 0.f) | (norm(a.bang) > 0.f);
    if (ball_awake) {
      a.bpos = a.bpos + a.bvel * dt + w.bw_push;
      a.brot = integrate_rotation(a.brot, a.bang, dt);
    }
    a.bvel = clamp_norm(a.bvel + w.ball_cache_dv, P.ball_max_speed);
    a.bang = clamp_norm(a.bang, BALL_MAX_ANG_SPEED);
  }
  STAGE_END(8);

  LANE_FOR(p, NPADS)
    w.pad_win[p] = pad_pickup<NC>(P, a, p, w.pad_bc, w.pad_ah, w.alive);
  STAGE_END(9);
  LANE_FOR(c, NC) pad_gain(P, a.car[c], c, w.pad_win);
  if (lane == 0) {
    a.goal_scored = a.goal_scored | (fabsf(a.bpos.y) > P.goal_threshold);
    a.tick_count = a.tick_count + 1;
  }
  STAGE_END(10);
}

// A block's shared memory: the tables, its arenas' Work, then the staging
// of its arenas' rows of the state buffers (row-major, arena-minor).
template <int NC>
struct Block {
  Tabs tabs;
  Work<NC> work[APB];
};
template <int NC>
struct Rows {
  static constexpr int F = CAR_F * NC + BALL_F + NPADS;
  static constexpr int I = CAR_I * NC + 1 + NPADS;
  static constexpr int U = CAR_U * NC + 1 + NPADS;
};
template <int NC>
constexpr size_t smem_bytes() {
  return sizeof(Block<NC>) +
         APB * (4 * (Rows<NC>::F + Rows<NC>::I) + Rows<NC>::U);
}

__device__ __forceinline__ void copy_words(float* dst, const float* src,
                                           int n, int tid) {
  for (int i = tid; i < n; i += THREADS) dst[i] = src[i];
}

// One env step of APB arenas: arena e0 + j is stepped by lanes
// [j * LANES, (j + 1) * LANES) of the block.
template <int NC>
__global__ void __launch_bounds__(THREADS)
    arena_step_kernel(const __grid_constant__ Params P,
                      const __grid_constant__ Bufs B, int tick_skip,
                      int action_delay) {
  extern __shared__ float4 arena_smem[];
  Block<NC>& S = *reinterpret_cast<Block<NC>*>(arena_smem);
  float* fst = reinterpret_cast<float*>(&S + 1);
  int32_t* ist = reinterpret_cast<int32_t*>(fst + Rows<NC>::F * APB);
  uint8_t* ust = reinterpret_cast<uint8_t*>(ist + Rows<NC>::I * APB);
  const int tid = threadIdx.x;
  const int e0 = blockIdx.x * APB;
  const int na = min(APB, B.E - e0);
  const int E = B.E;

  copy_words(reinterpret_cast<float*>(&S.tabs.facets),
             reinterpret_cast<const float*>(&P.facets),
             sizeof(facets::Tables) / 4, tid);
  copy_words(reinterpret_cast<float*>(S.tabs.curves),
             reinterpret_cast<const float*>(P.curves),
             sizeof(P.curves) / 4, tid);
  copy_words(&S.tabs.planes[0][0], &P.planes[0][0], NPLANES * 4, tid);
  if (tid == 0) S.tabs.extent = facets::band_extent(P.facets);
  // coalesced: neighbouring threads read a row's neighbouring arenas
  for (int x = tid; x < Rows<NC>::F * APB; x += THREADS) {
    const int r = x / APB, j = x - r * APB;
    if (j < na) fst[x] = B.f_in[(size_t)r * E + e0 + j];
  }
  for (int x = tid; x < Rows<NC>::I * APB; x += THREADS) {
    const int r = x / APB, j = x - r * APB;
    if (j < na) ist[x] = B.i_in[(size_t)r * E + e0 + j];
  }
  for (int x = tid; x < Rows<NC>::U * APB; x += THREADS) {
    const int r = x / APB, j = x - r * APB;
    if (j < na) ust[x] = B.u_in[(size_t)r * E + e0 + j];
  }
  __syncthreads();

  const int j = tid / LANES, lane = tid - j * LANES;
  if (j < na) {
    const unsigned mask =
        LANES == 32 ? 0xffffffffu
                    : ((1u << LANES) - 1u) << ((tid & 31) / LANES * LANES);
    Work<NC>& w = S.work[j];
    const Bufs Sb{fst, ist, ust, fst, ist, ust, nullptr, nullptr, APB};
    const int e = e0 + j;
    LANE_FOR(c, NC) {
      load_car<NC>(w.a.car[c], Sb, j, c);
      w.ridx[c] = B.respawn[(size_t)c * E + e];
    }
    if (lane == 0) load_arena<NC>(w.a, Sb, j);
    SYNC();
#pragma unroll 1
    for (int t = 0; t < tick_skip; ++t)
      tick<NC>(P, S.tabs, w, B, e, t == action_delay, lane, mask);
    LANE_FOR(c, NC) store_car<NC>(w.a.car[c], Sb, j, c);
    if (lane == 0) store_arena<NC>(w.a, Sb, j);
  }
  __syncthreads();
  for (int x = tid; x < Rows<NC>::F * APB; x += THREADS) {
    const int r = x / APB, j2 = x - r * APB;
    if (j2 < na) B.f_out[(size_t)r * E + e0 + j2] = fst[x];
  }
  for (int x = tid; x < Rows<NC>::I * APB; x += THREADS) {
    const int r = x / APB, j2 = x - r * APB;
    if (j2 < na) B.i_out[(size_t)r * E + e0 + j2] = ist[x];
  }
  for (int x = tid; x < Rows<NC>::U * APB; x += THREADS) {
    const int r = x / APB, j2 = x - r * APB;
    if (j2 < na) B.u_out[(size_t)r * E + e0 + j2] = ust[x];
  }
}
#undef LANE_FOR
#undef SYNC
#undef STAGE
#undef STAGE_END
#undef STAGE_CLOCK_START

template <int NC>
cudaError_t launch(const Params& P, const Bufs& B, int tick_skip,
                   int action_delay, cudaStream_t stream) {
  const size_t smem = smem_bytes<NC>();
  cudaError_t err = cudaFuncSetAttribute(
      arena_step_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != 0) return err;
  const int blocks = (B.E + APB - 1) / APB;
  arena_step_kernel<NC><<<blocks, THREADS, smem, stream>>>(P, B, tick_skip,
                                                           action_delay);
  return cudaGetLastError();
}

}  // namespace

// Entry points, bound with ctypes by ops/arena_step.py.  The build compiles
// this file once per car count (-DARENA_STEP_NC=n, each object holding one
// instantiation of the kernel, all in parallel) and once for the dispatcher
// (-DARENA_STEP_DISPATCH), and links the objects; without either macro one
// translation unit holds everything.
#define ARENA_STEP_ARGS                                                     \
  const void *params, const float *f_in, const int32_t *i_in,               \
      const uint8_t *u_in, float *f_out, int32_t *i_out, uint8_t *u_out,    \
      const float *controls, const int32_t *respawn, int num_envs,          \
      int tick_skip, int action_delay, void *stream
#define ARENA_STEP_LAUNCHER(N)                                              \
  extern "C" int arena_step_launch_##N(ARENA_STEP_ARGS) {                   \
    Params P = *reinterpret_cast<const Params*>(params);                    \
    Bufs B{f_in,  i_in,     u_in,    f_out, i_out,                          \
           u_out, controls, respawn, num_envs};                             \
    return (int)launch<N>(P, B, tick_skip, action_delay,                    \
                          reinterpret_cast<cudaStream_t>(stream));          \
  }                                                                         \
  extern "C" int arena_step_smem_##N() { return (int)smem_bytes<N>(); }
#define ARENA_STEP_LAUNCHER_OF(N) ARENA_STEP_LAUNCHER(N)

#if defined(ARENA_STEP_NC)
ARENA_STEP_LAUNCHER_OF(ARENA_STEP_NC)
#else
#if defined(ARENA_STEP_DISPATCH)
extern "C" int arena_step_launch_1(ARENA_STEP_ARGS);
extern "C" int arena_step_launch_2(ARENA_STEP_ARGS);
extern "C" int arena_step_launch_4(ARENA_STEP_ARGS);
extern "C" int arena_step_launch_6(ARENA_STEP_ARGS);
extern "C" int arena_step_smem_1();
extern "C" int arena_step_smem_2();
extern "C" int arena_step_smem_4();
extern "C" int arena_step_smem_6();
#else
ARENA_STEP_LAUNCHER(1)
ARENA_STEP_LAUNCHER(2)
ARENA_STEP_LAUNCHER(4)
ARENA_STEP_LAUNCHER(6)
#endif

// Returns a cudaError_t (0 on success); 1000 + n for a Params buffer of the
// wrong size, 2000 + C for an unsupported car count.
extern "C" int arena_step_launch(const void* params, int params_bytes,
                                 const float* f_in, const int32_t* i_in,
                                 const uint8_t* u_in, float* f_out,
                                 int32_t* i_out, uint8_t* u_out,
                                 const float* controls,
                                 const int32_t* respawn, int num_envs,
                                 int num_cars, int tick_skip,
                                 int action_delay, void* stream) {
  if (params_bytes != (int)sizeof(Params)) return 1000 + params_bytes;
  if (num_envs == 0) return 0;
#define ARENA_STEP_CALL(N)                                                  \
  arena_step_launch_##N(params, f_in, i_in, u_in, f_out, i_out, u_out,      \
                        controls, respawn, num_envs, tick_skip,             \
                        action_delay, stream)
  switch (num_cars) {
    case 1: return ARENA_STEP_CALL(1);
    case 2: return ARENA_STEP_CALL(2);
    case 4: return ARENA_STEP_CALL(4);
    case 6: return ARENA_STEP_CALL(6);
    default: return 2000 + num_cars;
  }
#undef ARENA_STEP_CALL
}

extern "C" int arena_step_params_bytes() { return (int)sizeof(Params); }

#ifdef ARENA_STEP_STAGE_CLOCKS
// Copies the stage sums (cycles) to ``out`` (NSTAGES values) and zeroes
// them; returns a cudaError_t.
extern "C" int arena_step_stage_cycles(unsigned long long* out) {
  cudaError_t err =
      cudaMemcpyFromSymbol(out, g_stage_cycles, sizeof(g_stage_cycles));
  if (err != cudaSuccess) return (int)err;
  const unsigned long long zero[NSTAGES] = {};
  return (int)cudaMemcpyToSymbol(g_stage_cycles, zero, sizeof(zero));
}
#endif

// The launch shape: lanes per arena, arenas per block, and the dynamic
// shared memory of a block for ``num_cars`` (-1 for another count).
extern "C" int arena_step_lanes() { return LANES; }
extern "C" int arena_step_arenas_per_block() { return APB; }
extern "C" int arena_step_shared_bytes(int num_cars) {
  switch (num_cars) {
    case 1: return arena_step_smem_1();
    case 2: return arena_step_smem_2();
    case 4: return arena_step_smem_4();
    case 6: return arena_step_smem_6();
    default: return -1;
  }
}
#endif
