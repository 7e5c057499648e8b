"""Rocket League game constants.

Game-constant data replicated from the reference simulator's constant tables
(reference: RocketSim/src/RLConst.h:1-439).  These are *facts about the game*
(verified against real Rocket League by the RocketSim project); every other
module treats this file as the single source of truth.

All values are in unreal units (uu), seconds, and radians unless noted.
The reference simulates in "BT" units (1 bt = 50 uu); we simulate natively in
uu, converting only inside contact-impulse math where inertia terms make the
unit system matter (see physics/contacts.py).
"""

import math

import numpy as np

# ---------------------------------------------------------------------------
# Unit scaling (reference: RocketSim/src/Math/MathTypes/MathTypes.h BulletLink)
BT_TO_UU = 50.0
UU_TO_BT = 1.0 / 50.0

GRAVITY_Z = -650.0

ARENA_EXTENT_X = 4096.0
ARENA_EXTENT_Y = 5120.0  # does not include inner goal
ARENA_HEIGHT = 2048.0

CAR_MASS_BT = 180.0
BALL_MASS_BT = CAR_MASS_BT / 6.0

CAR_COLLISION_FRICTION = 0.3
CAR_COLLISION_RESTITUTION = 0.1

CARBALL_COLLISION_FRICTION = 2.0
CARBALL_COLLISION_RESTITUTION = 0.0

CARWORLD_COLLISION_FRICTION = 0.3
CARWORLD_COLLISION_RESTITUTION = 0.3

CARCAR_COLLISION_FRICTION = 0.09
CARCAR_COLLISION_RESTITUTION = 0.1

# Static arena body material (reference: Arena.cpp:503-509).  Combination
# rules with a static body (reference bullet btManifoldResult.cpp:56-77):
# friction = min(a, b), restitution = max(a, b).
WORLD_RESTITUTION = 0.3
WORLD_FRICTION = 0.6

# Bullet manifold-point lifetime: a contact exists while the narrowphase
# gap is below the pair's contact breaking threshold,
# 0.02 * min(angularMotionDisc of the two shapes) (reference bullet
# btCollisionDispatcher.cpp:70-80, btCollisionShape.cpp:147-149).  For the
# ball sphere the disc is radius + 4uu (ROCKETSIM CHANGE,
# btCollisionShape.cpp:130-133: +0.08bt); for the car box it is
# |half_extents|.  While the gap is inside this margin, approach velocity
# is fully blocked (the vanilla creep allowance is commented out in the
# fork, btSequentialImpulseConstraintSolver.cpp:155-164); positional
# split-impulse pushout applies only at true overlap (cp.distance < 0).
CONTACT_BREAK_FRAC = 0.02
SPHERE_BOUND_EXTRA = 4.0  # uu (= 0.08 bt)
MESH_COLLISION_MARGIN = 2.0  # uu (= 0.04 bt, bullet CONVEX_DISTANCE_MARGIN)

BALL_REST_Z = 93.15
BALL_MAX_ANG_SPEED = 6.0
BALL_DRAG = 0.03  # per-second net velocity drag multiplier
BALL_FRICTION = 0.35
BALL_RESTITUTION = 0.6

CAR_MAX_SPEED = 2300.0
BALL_MAX_SPEED = 6000.0

BOOST_MAX = 100.0
BOOST_USED_PER_SECOND = BOOST_MAX / 3
BOOST_MIN_TIME = 0.1
BOOST_ACCEL_GROUND = 2975.0 / 3.0
BOOST_ACCEL_AIR = 3175.0 / 3.0
BOOST_SPAWN_AMOUNT = BOOST_MAX / 3

CAR_MAX_ANG_SPEED = 5.5

SUPERSONIC_START_SPEED = 2200.0
SUPERSONIC_MAINTAIN_MIN_SPEED = SUPERSONIC_START_SPEED - 100.0
SUPERSONIC_MAINTAIN_MAX_TIME = 1.0

POWERSLIDE_RISE_RATE = 5.0
POWERSLIDE_FALL_RATE = 2.0

THROTTLE_TORQUE_AMOUNT = CAR_MASS_BT * 400.0
BRAKE_TORQUE_AMOUNT = CAR_MASS_BT * (14.25 + (1.0 / 3.0))

STOPPING_FORWARD_VEL = 25.0
COASTING_BRAKE_FACTOR = 0.15
BRAKING_NO_THROTTLE_SPEED_THRESH = 0.01
THROTTLE_DEADZONE = 0.001

THROTTLE_AIR_ACCEL = 200.0 / 3.0

JUMP_ACCEL = 4375.0 / 3.0
JUMP_IMMEDIATE_FORCE = 875.0 / 3.0
JUMP_MIN_TIME = 0.025
JUMP_RESET_TIME_PAD = 1.0 / 40.0
JUMP_MAX_TIME = 0.2
JUMP_PRE_MIN_ACCEL_SCALE = 0.62  # reference: Car.cpp:544
DOUBLEJUMP_MAX_DELAY = 1.25

FLIP_Z_DAMP_120 = 0.35
FLIP_Z_DAMP_START = 0.15
FLIP_Z_DAMP_END = 0.21
FLIP_TORQUE_TIME = 0.65
FLIP_TORQUE_MIN_TIME = 0.41
FLIP_PITCHLOCK_TIME = 1.0
FLIP_PITCHLOCK_EXTRA_TIME = 0.3
FLIP_INITIAL_VEL_SCALE = 500.0
FLIP_TORQUE_X = 260.0  # left/right
FLIP_TORQUE_Y = 224.0  # forward/backward
FLIP_FORWARD_IMPULSE_MAX_SPEED_SCALE = 1.0
FLIP_SIDE_IMPULSE_MAX_SPEED_SCALE = 1.9
FLIP_BACKWARD_IMPULSE_MAX_SPEED_SCALE = 2.5
FLIP_BACKWARD_IMPULSE_SCALE_X = 16.0 / 15.0

BALL_COLLISION_RADIUS_SOCCAR = 91.25

SOCCAR_GOAL_SCORE_BASE_THRESHOLD_Y = 5124.25

CAR_TORQUE_SCALE = 2 * math.pi / (1 << 16) * 1000

CAR_AUTOFLIP_IMPULSE = 200.0
CAR_AUTOFLIP_TORQUE = 50.0
CAR_AUTOFLIP_TIME = 0.4
CAR_AUTOFLIP_NORMZ_THRESH = math.sqrt(0.5)
CAR_AUTOFLIP_ROLL_THRESH = 2.8

CAR_AUTOROLL_FORCE = 100.0
CAR_AUTOROLL_TORQUE = 80.0

BALL_CAR_EXTRA_IMPULSE_Z_SCALE = 0.35
BALL_CAR_EXTRA_IMPULSE_FORWARD_SCALE = 0.65
BALL_CAR_EXTRA_IMPULSE_MAXDELTAVEL_UU = 4600.0

CAR_SPAWN_REST_Z = 17.0
CAR_RESPAWN_Z = 36.0

BUMP_COOLDOWN_TIME = 0.25
BUMP_MIN_FORWARD_DIST = 64.5
DEMO_RESPAWN_TIME = 3.0

# Goal geometry (reference: Arena.cpp:846-849, RLBot wiki values)
GOAL_HALF_WIDTH = 892.755
GOAL_HEIGHT = 642.775
GOAL_DEPTH = 880.0  # inner-goal depth beyond the back wall

# Soccar corner wall: plane |x| + |y| = 8064 (45-degree corner cut)
ARENA_CORNER_INTERCEPT = 8064.0

# Bullet solver tuning used by the reference (reference: Arena.cpp:485-489)
SOLVER_ERP2 = 0.8
# bullet btContactSolverInfo defaults the fork keeps
SPLIT_IMPULSE_TURN_ERP = 0.1
RESTITUTION_VELOCITY_THRESHOLD_UU = 0.2 * BT_TO_UU  # bullet default 0.2 bt/s


# ---------------------------------------------------------------------------
# btRaycastVehicle-derived suspension constants
# (reference: RLConst.h namespace BTVehicle)
class BTVehicle:
    SUSPENSION_FORCE_SCALE_FRONT = 36.0 - (1.0 / 4.0)
    SUSPENSION_FORCE_SCALE_BACK = 54.0 + (1.0 / 4.0) + (1.5 / 100.0)

    SUSPENSION_STIFFNESS = 500.0
    WHEELS_DAMPING_COMPRESSION = 25.0
    WHEELS_DAMPING_RELAXATION = 40.0
    MAX_SUSPENSION_TRAVEL = 12.0
    SUSPENSION_SUBTRACTION = 0.05


ROLLING_FRICTION_SCALE_MAGIC = 113.73963  # reference: btVehicleRL.cpp:369
SIDE_FRICTION_CONTACT_DAMPING = 0.2  # bullet resolveSingleBilateral damping

CAR_AIR_CONTROL_TORQUE = (130.0, 95.0, 400.0)  # pitch, yaw, roll
CAR_AIR_CONTROL_DAMPING = (30.0, 20.0, 50.0)


# ---------------------------------------------------------------------------
# Boost pads (reference: RLConst.h namespace BoostPads)
class BoostPads:
    CYL_HEIGHT = 95.0
    CYL_RAD_BIG = 208.0
    CYL_RAD_SMALL = 144.0

    BOX_HEIGHT = 64.0
    BOX_RAD_BIG = 160.0
    BOX_RAD_SMALL = 120.0

    COOLDOWN_BIG = 10.0
    COOLDOWN_SMALL = 4.0

    BOOST_AMOUNT_BIG = 100.0
    BOOST_AMOUNT_SMALL = 12.0

    LOCS_AMOUNT_SMALL_SOCCAR = 28
    LOCS_AMOUNT_BIG = 6


# Pad order matches the reference arena construction: 6 big pads first, then
# 28 small pads (reference: Arena.cpp:536-556, RLConst.h:215-253).
BOOST_LOCS_BIG_SOCCAR = np.array([
    [-3584.0, 0.0, 73.0],
    [3584.0, 0.0, 73.0],
    [-3072.0, 4096.0, 73.0],
    [3072.0, 4096.0, 73.0],
    [-3072.0, -4096.0, 73.0],
    [3072.0, -4096.0, 73.0],
], dtype=np.float32)

BOOST_LOCS_SMALL_SOCCAR = np.array([
    [0.0, -4240.0, 70.0],
    [-1792.0, -4184.0, 70.0],
    [1792.0, -4184.0, 70.0],
    [-940.0, -3308.0, 70.0],
    [940.0, -3308.0, 70.0],
    [0.0, -2816.0, 70.0],
    [-3584.0, -2484.0, 70.0],
    [3584.0, -2484.0, 70.0],
    [-1788.0, -2300.0, 70.0],
    [1788.0, -2300.0, 70.0],
    [-2048.0, -1036.0, 70.0],
    [0.0, -1024.0, 70.0],
    [2048.0, -1036.0, 70.0],
    [-1024.0, 0.0, 70.0],
    [1024.0, 0.0, 70.0],
    [-2048.0, 1036.0, 70.0],
    [0.0, 1024.0, 70.0],
    [2048.0, 1036.0, 70.0],
    [-1788.0, 2300.0, 70.0],
    [1788.0, 2300.0, 70.0],
    [-3584.0, 2484.0, 70.0],
    [3584.0, 2484.0, 70.0],
    [0.0, 2816.0, 70.0],
    [-940.0, 3308.0, 70.0],
    [940.0, 3308.0, 70.0],
    [-1792.0, 4184.0, 70.0],
    [1792.0, 4184.0, 70.0],
    [0.0, 4240.0, 70.0],
], dtype=np.float32)

BOOST_PAD_LOCS_SOCCAR = np.concatenate(
    [BOOST_LOCS_BIG_SOCCAR, BOOST_LOCS_SMALL_SOCCAR], axis=0)
NUM_BOOST_PADS = 34
BOOST_PAD_IS_BIG = np.array([True] * 6 + [False] * 28)

# Hoops pads (reference: RLConst.h:257-283 — big first, like soccar)
BOOST_LOCS_BIG_HOOPS = np.array([
    [-2176.0, 2944.0, 72.0],
    [2176.0, -2944.0, 72.0],
    [-2176.0, -2944.0, 72.0],
    [-2432.0, 0.0, 72.0],
    [2432.0, 0.0, 72.0],
    [2175.99, 2944.0, 72.0],
], dtype=np.float32)

BOOST_LOCS_SMALL_HOOPS = np.array([
    [1536.0, -1024.0, 64.0],
    [-1280.0, -2304.0, 64.0],
    [0.0, -2816.0, 64.0],
    [-1536.0, -1024.0, 64.0],
    [1280.0, -2304.0, 64.0],
    [-512.0, 512.0, 64.0],
    [-1536.0, 1024.0, 64.0],
    [1536.0, 1024.0, 64.0],
    [1280.0, 2304.0, 64.0],
    [0.0, 2816.0, 64.0],
    [512.0, 512.0, 64.0],
    [512.0, -512.0, 64.0],
    [-512.0, -512.0, 64.0],
    [-1280.0, 2304.0, 64.0],
], dtype=np.float32)

BOOST_PAD_LOCS_HOOPS = np.concatenate(
    [BOOST_LOCS_BIG_HOOPS, BOOST_LOCS_SMALL_HOOPS], axis=0)
NUM_BOOST_PADS_HOOPS = 20
BOOST_PAD_IS_BIG_HOOPS = np.array([True] * 6 + [False] * 14)


# ---------------------------------------------------------------------------
# Kickoff / respawn spawn tables (reference: RLConst.h:284-338)
# Each row: (x, y, yaw).  Blue team; mirror (negate x, y and add pi to yaw)
# for orange.
CAR_SPAWN_LOCATION_AMOUNT = 5
CAR_RESPAWN_LOCATION_AMOUNT = 4

_PI_4 = math.pi / 4

CAR_SPAWN_LOCATIONS_SOCCAR = np.array([
    [-2048.0, -2560.0, _PI_4 * 1],
    [2048.0, -2560.0, _PI_4 * 3],
    [-256.0, -3840.0, _PI_4 * 2],
    [256.0, -3840.0, _PI_4 * 2],
    [0.0, -4608.0, _PI_4 * 2],
], dtype=np.float32)

CAR_RESPAWN_LOCATIONS_SOCCAR = np.array([
    [-2304.0, -4608.0, math.pi / 2],
    [-2688.0, -4608.0, math.pi / 2],
    [2304.0, -4608.0, math.pi / 2],
    [2688.0, -4608.0, math.pi / 2],
], dtype=np.float32)

CAR_SPAWN_LOCATION_AMOUNT_HEATSEEKER = 4

CAR_SPAWN_LOCATIONS_HEATSEEKER = np.array([
    [-1000.0, -4620.0, math.pi / 2],
    [1000.0, -4620.0, math.pi / 2],
    [-2000.0, -4620.0, math.pi / 2],
    [2000.0, -4620.0, math.pi / 2],
], dtype=np.float32)

CAR_SPAWN_LOCATIONS_HOOPS = np.array([
    [-1536.0, -3072.0, _PI_4 * 2],
    [1536.0, -3072.0, _PI_4 * 2],
    [-256.0, -2816.0, _PI_4 * 2],
    [256.0, -2816.0, _PI_4 * 2],
    [0.0, -3200.0, _PI_4 * 2],
], dtype=np.float32)

CAR_RESPAWN_LOCATIONS_HOOPS = np.array([
    [-1920.0, -3072.0, math.pi / 2],
    [-1152.0, -3072.0, math.pi / 2],
    [1920.0, -3072.0, math.pi / 2],
    [1152.0, -3072.0, math.pi / 2],
], dtype=np.float32)


# ---------------------------------------------------------------------------
# Game modes beyond soccar (reference: GameMode.h, RLConst.h:18-20,42,
# 106-110, 124-127, 151-198; Arena.cpp:949-974)

ARENA_EXTENT_X_HOOPS = 8900.0 / 3.0
ARENA_EXTENT_Y_HOOPS = 3581.0
ARENA_HEIGHT_HOOPS = 1820.0

BALL_COLLISION_RADIUS_HOOPS = 96.3831
BALL_COLLISION_RADIUS_DROPSHOT = 100.2565
BALL_HOOPS_Z_VEL = 1000.0       # kickoff z impulse on the hoops ball

HOOPS_GOAL_SCORE_THRESHOLD_Z = 270.0
# BallWithinHoopsGoalXYMarginSq (Arena.cpp:816-825)
HOOPS_GOAL_SCALE_Y = 0.9
HOOPS_GOAL_OFFSET_Y = 2770.0
HOOPS_GOAL_RADIUS = 716.0

BALL_CAR_EXTRA_IMPULSE_Z_SCALE_HOOPS_GROUND = 0.35 * 1.55
BALL_CAR_EXTRA_IMPULSE_Z_SCALE_HOOPS_NORMAL_Z_THRESH = 0.1


class Heatseeker:
    """Reference: RLConst.h namespace Heatseeker (151-175)."""
    INITIAL_TARGET_SPEED = 2900.0
    TARGET_SPEED_INCREMENT = 85.0
    MIN_SPEEDUP_INTERVAL = 1.0
    TARGET_Y = 5120.0
    TARGET_Z = 320.0
    HORIZONTAL_BLEND = 1.45
    VERTICAL_BLEND = 0.78
    SPEED_BLEND = 0.3
    MAX_TURN_PITCH = 7000.0 * math.pi / (1 << 15)
    MAX_SPEED = 4600.0
    WALL_BOUNCE_CHANGE_Y_THRESH = 300.0
    WALL_BOUNCE_CHANGE_Y_NORMAL = 0.5
    WALL_BOUNCE_FORCE_SCALE = 1.0 / 3.0
    WALL_BOUNCE_UP_FRAC = 0.3
    # blue-team start; flip y for orange
    BALL_START_POS = (-1000.0, -2220.0, 92.75)
    BALL_START_VEL = (0.0, -65.0, 650.0)


class Snowday:
    """Reference: RLConst.h namespace Snowday (176-185)."""
    PUCK_RADIUS = 114.25
    PUCK_HEIGHT = 62.5
    PUCK_CIRCLE_POINT_AMOUNT = 20
    PUCK_MASS_BT = 50.0
    PUCK_GROUND_STICK_FORCE = 70.0
    PUCK_FRICTION = 0.1
    PUCK_RESTITUTION = 0.3


# ---------------------------------------------------------------------------
# Piecewise-linear game curves (reference: RLConst.h:342-437).
# Stored as (inputs, outputs) arrays; evaluated piecewise (ops/cvec.curve),
# matching the reference LinearPieceCurve behavior (clamps at both ends).
STEER_ANGLE_FROM_SPEED_CURVE = (
    np.array([0.0, 500.0, 1000.0, 1500.0, 1750.0, 3000.0], np.float32),
    np.array([0.53356, 0.31930, 0.18203, 0.10570, 0.08507, 0.03454],
             np.float32),
)

POWERSLIDE_STEER_ANGLE_FROM_SPEED_CURVE = (
    np.array([0.0, 2500.0], np.float32),
    np.array([0.39235, 0.12610], np.float32),
)

DRIVE_SPEED_TORQUE_FACTOR_CURVE = (
    np.array([0.0, 1400.0, 1410.0], np.float32),
    np.array([1.0, 0.1, 0.0], np.float32),
)

NON_STICKY_FRICTION_FACTOR_CURVE = (
    np.array([0.0, 0.7075, 1.0], np.float32),
    np.array([0.1, 0.5, 1.0], np.float32),
)

LAT_FRICTION_CURVE = (
    np.array([0.0, 1.0], np.float32),
    np.array([1.0, 0.2], np.float32),
)

# Empty in the reference => always 1.0
LONG_FRICTION_CURVE = (
    np.array([0.0, 1.0], np.float32),
    np.array([1.0, 1.0], np.float32),
)

HANDBRAKE_LAT_FRICTION_FACTOR_CURVE = (
    np.array([0.0, 1.0], np.float32),
    np.array([0.1, 0.1], np.float32),
)

HANDBRAKE_LONG_FRICTION_FACTOR_CURVE = (
    np.array([0.0, 1.0], np.float32),
    np.array([0.5, 0.9], np.float32),
)

BALL_CAR_EXTRA_IMPULSE_FACTOR_CURVE = (
    np.array([0.0, 500.0, 2300.0, 4600.0], np.float32),
    np.array([0.65, 0.65, 0.55, 0.30], np.float32),
)

BUMP_VEL_AMOUNT_GROUND_CURVE = (
    np.array([0.0, 1400.0, 2200.0], np.float32),
    np.array([5.0 / 6.0, 1100.0, 1530.0], np.float32),
)

BUMP_VEL_AMOUNT_AIR_CURVE = (
    np.array([0.0, 1400.0, 2200.0], np.float32),
    np.array([5.0 / 6.0, 1390.0, 1945.0], np.float32),
)

BUMP_UPWARD_VEL_AMOUNT_CURVE = (
    np.array([0.0, 1400.0, 2200.0], np.float32),
    np.array([2.0 / 6.0, 278.0, 417.0], np.float32),
)


# ---------------------------------------------------------------------------
# Car body presets (reference: RocketSim/src/Sim/Car/CarConfig/CarConfig.cpp)
# hitbox_size is the FULL box size; hitbox offset does not move the center of
# mass (always local origin).
CAR_CONFIG_NAMES = ("OCTANE", "DOMINUS", "PLANK", "BREAKOUT", "HYBRID", "MERC")

HITBOX_SIZES = np.array([
    [120.507, 86.6994, 38.6591],
    [130.427, 85.7799, 33.8],
    [131.32, 87.1704, 31.8944],
    [133.992, 83.021, 32.8],
    [129.519, 84.6879, 36.6591],
    [123.22, 79.2103, 44.1591],
], dtype=np.float32)

HITBOX_OFFSETS = np.array([
    [13.87566, 0.0, 20.755],
    [9.0, 0.0, 15.75],
    [9.00857, 0.0, 12.0942],
    [12.5, 0.0, 11.75],
    [13.8757, 0.0, 20.755],
    [11.3757, 0.0, 21.505],
], dtype=np.float32)

FRONT_WHEEL_RADS = np.array(
    [12.50, 12.00, 12.50, 13.50, 12.50, 15.00], np.float32)
BACK_WHEEL_RADS = np.array(
    [15.00, 13.50, 17.00, 15.00, 15.00, 15.00], np.float32)
FRONT_WHEEL_SUS_REST = np.array(
    [38.755, 33.95, 31.9242, 29.7, 38.755, 39.505], np.float32)
BACK_WHEEL_SUS_REST = np.array(
    [37.055, 33.85, 27.9242, 29.666, 37.055, 39.105], np.float32)

FRONT_WHEELS_OFFSET = np.array([
    [51.25, 25.90, 20.755],
    [50.30, 31.10, 15.75],
    [49.97, 27.80, 12.0942],
    [51.50, 26.67, 11.75],
    [51.25, 25.90, 20.755],
    [51.25, 25.90, 21.505],
], dtype=np.float32)

BACK_WHEELS_OFFSET = np.array([
    [-33.75, 29.50, 20.755],
    [-34.75, 33.00, 15.75],
    [-35.43, 20.28, 12.0942],
    [-35.75, 35.00, 11.75],
    [-34.00, 29.50, 20.755],
    [-33.75, 29.50, 21.505],
], dtype=np.float32)

DODGE_DEADZONE = 0.5

OCTANE = 0  # index into the preset tables


def kph_to_vel(kph: float) -> float:
    """Convert km/h to uu/s (reference: RLGymCPP/Math.h KPHToVel)."""
    return kph * (250.0 / 9.0)
