"""RLBot python agent: the GameTickPacket -> native bot server bridge.

This is the last mile of the deployment chain (reference:
src/RLBotClient.cpp:62-139 reads the flatbuffers GameTickPacket into a
GameState and infers through InferUnit; rlbot/CppPythonAgent.py:25-38 is
the GUI-side shim).  The official python ``rlbot`` framework hands
agents a ctypes ``GameTickPacket`` (rlbot.utils.structures.
game_data_struct) with the same content as the flatbuffers packet; this
module translates it into the native server's binary packet stream
(deploy/bot_bridge.PacketClient), so ``rlt_bot_server`` can play a real
match:

    RLBot GUI -> RLTNativeAgent (this file, in the rlbot process)
              -> 'RLTP' packet frames over TCP -> rlt_bot_server
              -> per-bot GetOutput state machine + native MLP inference
              -> controls back to rlbot as SimpleControllerState.

``translate_game_tick_packet`` is a pure function over the packet's
attribute structure (duck-typed, so the scripted deployment test drives
it with a fake packet when the rlbot package isn't installed — the real
ctypes struct exposes identical field names).

Boost pads: rlbot's FieldInfo lists pads in its own order; the server
expects the reference's RLConst order.  Like the reference's
location-keyed pad map (RLGymCPP GameState.cpp:11-51), ``build_pad_map``
matches pads by nearest location.
"""

from __future__ import annotations

import numpy as np

from reinforcement_learning_torch import constants as C
from reinforcement_learning_torch.deploy import bot_bridge

NUM_PADS = bot_bridge.NUM_PADS


def build_pad_map(field_pad_locations) -> np.ndarray:
    """Map rlbot FieldInfo pad index -> reference pad index by nearest
    location (GameState.cpp:11-51 equivalent).  ``field_pad_locations``:
    iterable of (x, y, z)."""
    ref = np.asarray(C.BOOST_PAD_LOCS_SOCCAR, np.float32)  # (34, 3)
    out = np.full(len(field_pad_locations), -1, np.int32)
    for i, loc in enumerate(field_pad_locations):
        d = np.linalg.norm(ref[:, :2] - np.asarray(loc[:2], np.float32),
                           axis=1)
        j = int(np.argmin(d))
        if d[j] < 200.0:
            out[i] = j
    return out


def translate_game_tick_packet(packet, pad_map: np.ndarray | None = None):
    """GameTickPacket (rlbot ctypes struct or any object with the same
    attribute names) -> kwargs for PacketClient.send_packet."""
    ball = packet.game_ball.physics
    players = []
    for i in range(packet.num_cars):
        car = packet.game_cars[i]
        ph = car.physics
        players.append(dict(
            pos=(ph.location.x, ph.location.y, ph.location.z),
            yaw=ph.rotation.yaw, pitch=ph.rotation.pitch,
            roll=ph.rotation.roll,
            vel=(ph.velocity.x, ph.velocity.y, ph.velocity.z),
            ang_vel=(ph.angular_velocity.x, ph.angular_velocity.y,
                     ph.angular_velocity.z),
            boost=float(car.boost),
            team=int(car.team),
            # isOnGround = hasWheelContact() alone (RLBotClient.cpp:54);
            # an airborne never-jumped car (drove off a wall) is NOT
            # grounded.
            is_on_ground=bool(getattr(car, "has_wheel_contact", True)),
            has_jumped=bool(getattr(car, "jumped", False)),
            has_double_jumped=bool(getattr(car, "double_jumped", False)),
            is_demoed=bool(getattr(car, "is_demolished", False)),
        ))

    pads_active = np.ones(NUM_PADS, bool)
    pads_timer = np.zeros(NUM_PADS, np.float32)
    n_boosts = int(getattr(packet, "num_boost", 0))
    if pad_map is not None and n_boosts:
        for i in range(min(n_boosts, len(pad_map))):
            j = int(pad_map[i])
            if j < 0:
                continue
            pad = packet.game_boosts[i]
            pads_active[j] = bool(pad.is_active)
            pads_timer[j] = float(pad.timer)

    return dict(
        seconds_elapsed=float(packet.game_info.seconds_elapsed),
        ball_pos=(ball.location.x, ball.location.y, ball.location.z),
        ball_vel=(ball.velocity.x, ball.velocity.y, ball.velocity.z),
        ball_ang_vel=(ball.angular_velocity.x, ball.angular_velocity.y,
                      ball.angular_velocity.z),
        players=players,
        pads_active=pads_active,
        pads_timer=pads_timer,
    )


def controls_to_simple_state(controls, state=None):
    """(8,) control floats -> rlbot SimpleControllerState (or any object
    with the standard attribute names)."""
    if state is None:
        try:
            from rlbot.agents.base_agent import SimpleControllerState
            state = SimpleControllerState()
        except ImportError:  # test double
            class _S:
                pass
            state = _S()
    (state.throttle, state.steer, state.pitch, state.yaw,
     state.roll) = (float(c) for c in controls[:5])
    state.jump = bool(controls[5] > 0)
    state.boost = bool(controls[6] > 0)
    state.handbrake = bool(controls[7] > 0)
    return state


class NativeBridge:
    """Owns the PacketClient + pad map for one rlbot process; shared by
    every RLTNativeAgent instance in it (the server multiplexes bots)."""

    def __init__(self, port: int, field_pad_locations=None):
        self.client = bot_bridge.PacketClient(port)
        self.pad_map = (build_pad_map(field_pad_locations)
                        if field_pad_locations is not None else None)
        self._last_time = None
        self._last_controls = {}

    def step(self, packet) -> dict:
        """Forward one GameTickPacket; returns {bot_index: controls}.
        Deduplicates by seconds_elapsed so multiple agents in one process
        send each game tick once."""
        t = float(packet.game_info.seconds_elapsed)
        if t != self._last_time:
            self._last_time = t
            self._last_controls = self.client.send_packet(
                **translate_game_tick_packet(packet, self.pad_map))
        return self._last_controls


try:  # the rlbot framework is only present on game machines
    from rlbot.agents.base_agent import BaseAgent

    class RLTNativeAgent(BaseAgent):
        """Drop-in rlbot agent backed by the native server.

        Config: point the rlbot GUI at this class; the server must be
        running (deploy/bot_bridge.BotServer or `rlt_bot_server
        <policy.blob>`), with its port in ``port.cfg`` next to the agent
        file — the same convention as the reference shim
        (CppPythonAgent.read_port_from_file)."""
        _bridge = None

        def initialize_agent(self):
            import os
            cfg = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "port.cfg")
            with open(cfg) as f:
                port = int(f.read().strip())
            bot_bridge.add_bot(port, self.name, self.team, self.index)
            fi = self.get_field_info()
            locs = [(fi.boost_pads[i].location.x,
                     fi.boost_pads[i].location.y,
                     fi.boost_pads[i].location.z)
                    for i in range(fi.num_boosts)]
            if RLTNativeAgent._bridge is None:
                RLTNativeAgent._bridge = NativeBridge(port, locs)

        def get_output(self, packet):
            controls = RLTNativeAgent._bridge.step(packet)
            c = controls.get(self.index)
            if c is None:
                return self.convert_output_to_v4([0.0] * 8)
            return controls_to_simple_state(c)

except ImportError:  # pragma: no cover - exercised on game machines only
    BaseAgent = None
    RLTNativeAgent = None
