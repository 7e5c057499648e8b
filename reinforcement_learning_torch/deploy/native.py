"""The native C++ inference runtime (``deploy/native/mlp_infer.cpp``) and
the blob of policy weights it loads.

A game machine needs neither PyTorch nor a card to play a trained policy:
``export_policy_blob`` writes the shared head and the policy into the
runtime's binary format (magic 0x524C5431, the JAX package's format byte
for byte), and ``NativePolicy`` runs it on the host through ctypes.

The runtime has one activation, ReLU, and the blob has no activation
field, so ``export_policy_blob`` refuses any other activation (the JAX
exporter writes a leaky-ReLU model as a ReLU one).

The C++ is compiled at first use with g++ into ``build/torch_native/``,
under a name keyed on a hash of the sources and flags, written to a
temporary folder first and moved into place, so concurrent builds do not
clash.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import struct
import subprocess
import tempfile
from pathlib import Path

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parent / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX_FLAGS = ("-O3", "-std=c++17")

_MAGIC = 0x524C5431


def build_native(name: str, sources, flags) -> Path:
    """Compile ``sources`` with ``g++ flags`` into ``BUILD_DIR``, unless a
    build of these exact sources and flags exists; returns its path.  A
    failed compile raises ``RuntimeError`` with g++'s output."""
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(Path(src).read_bytes())
    stem, ext = os.path.splitext(name)
    out = BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}{ext}"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        tmp = os.path.join(tmpdir, name)
        proc = subprocess.run(["g++", *flags, *map(str, sources), "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return out


def build_library() -> Path:
    return build_native("libmlp_infer.so", [NATIVE_DIR / "mlp_infer.cpp"],
                        CXX_FLAGS + ("-shared", "-fPIC"))


def blob_from_params(params: dict, num_inputs: int, num_actions: int
                     ) -> bytes:
    """The runtime's blob of a JAX-layout parameter tree
    (``PPOLearner.params_to_jax``, ``checkpoint_converter.load_npz_params``):
    the shared head's layers (if any), the policy's, then its output
    layer, each with its sizes, a LayerNorm flag, a hidden flag, the
    weights (fan_in, fan_out) and bias, and the LayerNorm scale and bias.
    The tree carries no activation: the runtime applies ReLU."""
    layers = []
    if params.get("shared_head") is not None:
        layers += [(layer, True) for layer in params["shared_head"]["layers"]]
    layers += [(layer, True) for layer in params["policy"]["layers"]]
    layers.append((params["policy"]["out"], False))

    out = bytearray()
    out += struct.pack("<I", _MAGIC)
    out += struct.pack("<i", num_inputs)
    out += struct.pack("<i", num_actions)
    out += struct.pack("<i", len(layers))
    for layer, is_hidden in layers:
        w = np.asarray(layer["w"], np.float32)
        b = np.asarray(layer["b"], np.float32)
        has_ln = "ln_scale" in layer
        out += struct.pack("<i", w.shape[0])
        out += struct.pack("<i", w.shape[1])
        out += struct.pack("<i", 1 if has_ln else 0)
        out += struct.pack("<i", 1 if is_hidden else 0)
        out += w.tobytes()
        out += b.tobytes()
        if has_ln:
            out += np.asarray(layer["ln_scale"], np.float32).tobytes()
            out += np.asarray(layer["ln_bias"], np.float32).tobytes()
    return bytes(out)


def export_policy_blob(learner) -> bytes:
    """The runtime's blob of a ``PPOLearner``'s shared head and policy.
    Raises ``ValueError`` unless the learner's activation is ReLU, the one
    the runtime computes."""
    activation = learner.config.activation
    if activation != "relu":
        raise ValueError(f"the native runtime computes ReLU only; this "
                         f"policy uses {activation!r}")
    return blob_from_params(learner.params_to_jax(), learner.obs_size,
                            learner.num_actions)


@functools.lru_cache(maxsize=None)
def _library(path: str):
    lib = ctypes.CDLL(path)
    lib.rlt_load_model.restype = ctypes.c_void_p
    lib.rlt_load_model.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.rlt_infer.restype = ctypes.c_int
    lib.rlt_infer.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
        ctypes.c_float, ctypes.c_int, ctypes.c_uint64]
    lib.rlt_forward_logits.restype = ctypes.c_int
    lib.rlt_forward_logits.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float)]
    lib.rlt_num_actions.restype = ctypes.c_int
    lib.rlt_num_actions.argtypes = [ctypes.c_void_p]
    lib.rlt_num_inputs.restype = ctypes.c_int
    lib.rlt_num_inputs.argtypes = [ctypes.c_void_p]
    lib.rlt_free_model.restype = None
    lib.rlt_free_model.argtypes = [ctypes.c_void_p]
    return lib


class NativePolicy:
    """Policy inference on the host by the C++ runtime."""

    def __init__(self, blob: bytes):
        self._handle = None
        self._lib = _library(str(build_library()))
        self._blob = blob   # the runtime copies it; kept for the caller
        self._handle = self._lib.rlt_load_model(blob, len(blob))
        if not self._handle:
            raise ValueError("invalid policy blob")
        self.num_actions = self._lib.rlt_num_actions(self._handle)
        self.num_inputs = self._lib.rlt_num_inputs(self._handle)

    @classmethod
    def from_params(cls, params: dict, num_inputs: int,
                    num_actions: int) -> "NativePolicy":
        return cls(blob_from_params(params, num_inputs, num_actions))

    @classmethod
    def from_learner(cls, learner) -> "NativePolicy":
        return cls(export_policy_blob(learner))

    def _obs(self, obs) -> np.ndarray:
        obs = np.ascontiguousarray(obs, np.float32)
        if obs.ndim != 2 or obs.shape[1] != self.num_inputs:
            raise ValueError(f"obs must be (batch, {self.num_inputs}), got "
                             f"{obs.shape}")
        return obs

    def logits(self, obs: np.ndarray) -> np.ndarray:
        obs = self._obs(obs)
        out = np.empty((obs.shape[0], self.num_actions), np.float32)
        self._lib.rlt_forward_logits(
            self._handle,
            obs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            obs.shape[0], out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return out

    def infer(self, obs: np.ndarray, masks: np.ndarray | None = None,
              temperature: float = 1.0, deterministic: bool = True,
              seed: int = 0) -> np.ndarray:
        """(batch,) int32 actions: the masked argmax, or a masked softmax
        sample from the runtime's generator seeded with ``seed``."""
        obs = self._obs(obs)
        batch = obs.shape[0]
        out = np.empty((batch,), np.int32)
        mask_arg = None
        if masks is not None:
            masks = np.ascontiguousarray(masks, np.uint8)
            if masks.shape != (batch, self.num_actions):
                raise ValueError(f"masks must be ({batch}, "
                                 f"{self.num_actions}), got {masks.shape}")
            mask_arg = masks.tobytes()
        self._lib.rlt_infer(
            self._handle,
            obs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), batch,
            mask_arg, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            temperature, 1 if deterministic else 0, seed)
        return out

    def close(self):
        if self._handle:
            self._lib.rlt_free_model(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
