"""Scalar physics formulas for the tick's static constants (numpy).

The plain tick (``ops/ctick.py``) and the CUDA kernel
(``csrc/arena_step.cu``, which receives these values through
``ops/arena_step``) read the hitbox inertia from here, so a physics change
lands in exactly one file.

Everything here is derived from the reference engine's semantics, cited
per function.
"""

from __future__ import annotations

import numpy as np

# Bullet's default collision margin for convex shapes
# (reference: bullet3-3.24 btCollisionMargin.h:22).
CONVEX_DISTANCE_MARGIN = 0.04


def box_effective_half_extents_bt(full_size_uu) -> np.ndarray:
    """Half extents (BT units) of the hitbox as Bullet actually stores them
    for inertia purposes.

    btBoxShape's constructor subtracts the default 0.04 margin from the
    half extents, then ``setSafeMargin`` shrinks the margin to
    ``0.1 * min(half_extents)`` if that is smaller
    (bullet3-3.24 btBoxShape.cpp:17-26, btConvexInternalShape.h:63-78).
    ``getHalfExtentsWithMargin`` — used by ``calculateLocalInertia``
    (btBoxShape.cpp:33-45) — therefore returns

        he - 0.04 + min(0.04, 0.1 * min(he))

    For the octane hitbox this is he - 0.0013409 BT per axis; the
    resulting inverse-inertia diagonal matches the oracle's
    ``btRigidBody::getInvInertiaDiagLocal()`` to 9 significant digits
    (verified against the reference compiled in tools/oracle).
    """
    he = np.asarray(full_size_uu, np.float64) / 2.0 / 50.0
    safe_margin = min(CONVEX_DISTANCE_MARGIN, 0.1 * float(he.min()))
    return he - CONVEX_DISTANCE_MARGIN + safe_margin


def box_inv_inertia_diag_bt(mass: float, full_size_uu) -> np.ndarray:
    """Diagonal inverse inertia of the car hitbox in BT units, replicating
    btBoxShape::calculateLocalInertia on the margin-adjusted extents
    (reference: Car::_BulletSetup, Car.cpp:195-209)."""
    l = 2.0 * box_effective_half_extents_bt(full_size_uu)
    ix = mass / 12.0 * (l[1] ** 2 + l[2] ** 2)
    iy = mass / 12.0 * (l[0] ** 2 + l[2] ** 2)
    iz = mass / 12.0 * (l[0] ** 2 + l[1] ** 2)
    return 1.0 / np.array([ix, iy, iz], np.float64)


def sphere_inertia_bt(mass: float, radius_uu: float) -> float:
    """btSphereShape::calculateLocalInertia: 0.4 m r^2 (the sphere's margin
    IS its radius, so no margin adjustment applies)."""
    return 0.4 * mass * (radius_uu / 50.0) ** 2
