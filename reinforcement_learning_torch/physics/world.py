"""Arena world geometry registry, the ``RocketSim::Init`` equivalent.

The reference loads its collision assets once per process
(``RocketSim::Init(meshDir)``, RocketSim.cpp:70-212: load and hash-verify
the ``.cmf`` meshes, build one ``btBvhTriangleMeshShape`` per mesh and the
suspension grids).  Here the baked :class:`~reinforcement_learning_torch.
physics.mesh.MeshGrid` of each game mode is cached per device.

Soccar, heatseeker and snowday collide against the soccar arena; hoops has
its own procedural arena (``mesh.build_hoops_mesh``), as the reference's
mesh selection does (RocketSim.cpp GetArenaCollisionShapes).
"""

from __future__ import annotations

from reinforcement_learning_torch.device import resolve_device
from reinforcement_learning_torch.physics import mesh as meshmod

_GRIDS: dict = {}
_MESH_DIR: str | None = None


def init(mesh_dir: str | None = None, verify_hashes: bool = False) -> None:
    """Point the registry at a directory of real ``.cmf`` assets
    (RocketSim::Init); without one the procedural arenas serve.  With
    ``verify_hashes`` every mesh's hash is checked against the reference's
    known set at once (on the host)."""
    global _MESH_DIR
    _MESH_DIR = mesh_dir
    _GRIDS.clear()
    if verify_hashes and mesh_dir is not None:
        meshmod.load_arena_mesh(mesh_dir, verify_hashes=True, device="cpu")


def get_grid(game_mode: str = "soccar", device=None):
    """The baked MeshGrid of a game mode on ``device`` (default
    ``"cuda"``), baked on first use and kept per (arena, device)."""
    dev = resolve_device(device)
    key = ("hoops" if game_mode == "hoops" else "soccar", dev)
    if key not in _GRIDS:
        _GRIDS[key] = meshmod.load_arena_mesh(_MESH_DIR, game_mode=key[0],
                                              device=dev)
    return _GRIDS[key]


def is_procedural() -> bool:
    """True when the registry serves the procedural arenas (no real
    ``.cmf`` assets configured), the configuration the kernel's closed-form
    facet arena models."""
    return _MESH_DIR is None
