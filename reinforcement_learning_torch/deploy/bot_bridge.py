"""The Python side of the native RLBot bot server.

The reference's deployment chain is RLBot GUI -> Python shim
(rlbot/CppPythonAgent.py, "add"/"remove" over TCP) -> C++ bot process
(RLBotCPP BotManager) -> per-tick GetOutput (src/RLBotClient.cpp:94-139).
The native server (``deploy/native/bot_server.cpp``) is that process; this
module drives it:

  * :func:`build_server` / :class:`BotServer`: compile the server (g++,
    into ``build/torch_native/``) and launch it on a policy blob
    (``native.export_policy_blob``);
  * :class:`PacketClient`: streams binary game packets (the 'RLTP'
    frames) and reads back each bot's controls;
  * :func:`add_bot` / :func:`remove_bot`: the shim's command protocol,
    byte for byte the reference's CppPythonAgent messages.

The wire formats are the JAX package's, so either package's client talks
to either server.
"""

from __future__ import annotations

import os
import socket
import struct
import subprocess
import time

import numpy as np

from reinforcement_learning_torch.deploy.native import (CXX_FLAGS,
                                                        NATIVE_DIR,
                                                        build_native)

PACKET_MAGIC = 0x524C5450
CONTROLS_MAGIC = 0x524C5443
NUM_PADS = 34


def build_server() -> str:
    return str(build_native("rlt_bot_server",
                            [NATIVE_DIR / "bot_server.cpp",
                             NATIVE_DIR / "mlp_infer.cpp"], CXX_FLAGS))


class BotServer:
    """The native bot server on an ephemeral port of 127.0.0.1, serving the
    policy blob at ``blob_path``; it writes its port to ``port.cfg`` in
    ``workdir``."""

    def __init__(self, blob_path: str, tick_skip: int = 8,
                 action_delay: int = 7, workdir: str | None = None,
                 stochastic: bool = False):
        binary = build_server()
        self.workdir = workdir or os.getcwd()
        self.port_file = os.path.join(self.workdir, "port.cfg")
        if os.path.exists(self.port_file):
            os.remove(self.port_file)
        args = [binary, blob_path, "--port", "0",
                "--tick-skip", str(tick_skip),
                "--action-delay", str(action_delay),
                "--port-file", self.port_file]
        if stochastic:
            args.append("--stochastic")
        self.proc = subprocess.Popen(args, cwd=self.workdir,
                                     stderr=subprocess.DEVNULL)
        try:
            self.port = self._wait_port()
        except BaseException:
            self.proc.kill()
            self.proc.wait()
            raise

    def _wait_port(self, timeout: float = 10.0) -> int:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if os.path.exists(self.port_file):
                with open(self.port_file) as f:
                    text = f.read().strip()
                if text:
                    return int(text)
            if self.proc.poll() is not None:
                raise RuntimeError(
                    f"bot server exited with {self.proc.returncode}")
            time.sleep(0.01)
        raise TimeoutError("bot server did not write port.cfg")

    def close(self):
        """Ask the server to quit; kill it if it does not within 2 s."""
        try:
            with socket.create_connection(("127.0.0.1", self.port),
                                          timeout=1.0) as s:
                s.send(b"quit")
            self.proc.wait(timeout=2.0)
        except (OSError, subprocess.TimeoutExpired):
            self.proc.kill()
        self.proc.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _command(port: int, message: str):
    with socket.create_connection(("127.0.0.1", port), timeout=2.0) as s:
        s.send(message.encode("ascii"))
    time.sleep(0.05)  # command connections are fire-and-forget


def add_bot(port: int, name: str, team: int, index: int,
            dll_dir: str = "."):
    """CppPythonAgent.run_independently's message, byte for byte."""
    _command(port, f"add\n{name}\n{team}\n{index}\n{dll_dir}")


def remove_bot(port: int, index: int):
    _command(port, f"remove\n{index}")


def pack_packet(seconds_elapsed: float, ball_pos, ball_vel, ball_ang_vel,
                players, pads_active=None, pads_timer=None) -> bytes:
    """One 'RLTP' frame.  ``players``: dicts with pos, yaw, pitch, roll,
    vel, ang_vel, boost, team, and optional is_on_ground / has_jumped /
    has_double_jumped / is_demoed flags."""
    out = bytearray()
    out += struct.pack("<If", PACKET_MAGIC, seconds_elapsed)
    out += np.asarray([*ball_pos, *ball_vel, *ball_ang_vel],
                      "<f4").tobytes()
    out += struct.pack("<i", len(players))
    for p in players:
        vals = [*p["pos"], p["yaw"], p["pitch"], p["roll"], *p["vel"],
                *p["ang_vel"], p["boost"], 0.0]
        out += np.asarray(vals, "<f4").tobytes()
        out += struct.pack("<i", int(p["team"]))
        out += struct.pack("<4B",
                           1 if p.get("is_on_ground", True) else 0,
                           1 if p.get("has_jumped", False) else 0,
                           1 if p.get("has_double_jumped", False) else 0,
                           1 if p.get("is_demoed", False) else 0)
    if pads_active is None:
        pads_active = np.ones(NUM_PADS, bool)
    if pads_timer is None:
        pads_timer = np.zeros(NUM_PADS, np.float32)
    out += struct.pack("<i", NUM_PADS)
    for a, t in zip(pads_active, pads_timer):
        out += struct.pack("<Bf", 1 if a else 0, float(t))
    return bytes(out)


class PacketClient:
    """A persistent game-packet connection to a running bot server."""

    def __init__(self, port: int):
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=10.0)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("bot server closed connection")
            buf += chunk
        return buf

    def send_packet(self, *args, **kwargs) -> dict:
        """Send one game packet (``pack_packet``'s arguments); returns
        {bot index: controls (8,) float32}."""
        self.sock.sendall(pack_packet(*args, **kwargs))
        magic, n = struct.unpack("<Ii", self._read_exact(8))
        if magic != CONTROLS_MAGIC:
            raise ConnectionError(f"bad controls frame magic {magic:#x}")
        out = {}
        for _ in range(n):
            idx, = struct.unpack("<i", self._read_exact(4))
            out[idx] = np.frombuffer(self._read_exact(32), "<f4").copy()
        return out

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass
