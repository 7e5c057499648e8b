"""Render sender: stream one arena's state to RocketSimVis over UDP, with
the JSON datagram and endpoint of the reference render path
(Util/RenderSender.cpp:21-122 and python_scripts/render_receiver.py: UDP
127.0.0.1:9273) and its adaptive real-time pacing.  The datagram is the
JAX package's, field for field.
"""

from __future__ import annotations

import json
import socket
import time

import numpy as np
import torch

from reinforcement_learning_torch.device import tree_map
from reinforcement_learning_torch.envs.obs import PAD_PERMUTATION


def arena_on_host(arena, index: int = 0):
    """Arena ``index`` of a batched ``ArenaState``, as numpy arrays."""
    return tree_map(lambda t: t[index].detach().cpu().numpy(), arena)


def _vec(v) -> list:
    a = np.asarray(v, np.float64)
    return [float(a[0]), float(a[1]), float(a[2])]


def _phys(pos, rot, vel, ang_vel) -> dict:
    rot = np.asarray(rot)
    return {
        "pos": _vec(pos),
        "forward": _vec(rot[:, 0]),
        "right": _vec(rot[:, 1]),
        "up": _vec(rot[:, 2]),
        "vel": _vec(vel),
        "ang_vel": _vec(ang_vel),
    }


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


class RenderSender:
    def __init__(self, ip: str = "127.0.0.1", port: int = 9273,
                 time_scale: float = 1.0, step_seconds: float = 8 / 120.0):
        self.addr = (ip, port)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.time_scale = time_scale
        self.step_seconds = step_seconds
        self._last_send = 0.0

    def send(self, arena_state, teams, prev_actions=None,
             ball_touched=None, gamemode: str = "soccar"):
        """Send one arena's state (an ``ArenaState`` of one arena, as
        ``arena_on_host`` gives it), then wait out the rest of its step."""
        cars = tree_map(_host, arena_state.cars)
        teams = _host(teams)
        touched = _host(ball_touched) if ball_touched is not None else None
        players = []
        for i in range(cars.pos.shape[0]):
            players.append({
                "car_id": i + 1,
                "team_num": int(teams[i]),
                "phys": _phys(cars.pos[i], cars.rot[i], cars.vel[i],
                              cars.ang_vel[i]),
                "is_demoed": bool(cars.is_demoed[i]),
                "on_ground": bool(cars.is_on_ground[i]),
                "ball_touched": bool(touched[i])
                if touched is not None else False,
                "has_flip": True,
                "boost_amount": float(cars.boost[i]) / 100.0,
            })

        ball = tree_map(_host, arena_state.ball)
        ball_phys = _phys(ball.pos, ball.rot, ball.vel, ball.ang_vel)
        for k in ("forward", "right", "up"):
            ball_phys.pop(k)

        pads = _host(arena_state.pads.is_active)[PAD_PERMUTATION].tolist()
        out = {
            "gamemode": gamemode,
            "ball_phys": ball_phys,
            "cars": players,
            "boost_pad_states": [bool(p) for p in pads],
        }
        self.sock.sendto(json.dumps(out).encode(), self.addr)
        self._pace()

    def _pace(self):
        """Adaptive real-time pacing (RenderSender.cpp:99-122)."""
        target = self.step_seconds / max(self.time_scale, 1e-6)
        now = time.monotonic()
        if self._last_send > 0:
            remaining = target - (now - self._last_send)
            if remaining > 0:
                time.sleep(remaining)
        self._last_send = time.monotonic()
