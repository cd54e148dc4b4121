"""Cone sets: a static collection of cone constraints compiled, at trace
time, into one batched projection function.

Counterpart of the ConeConstraint machinery in prox_lib_cone.h:31-66 and
the dispatchers ProxEvalConeCpu/Gpu (:448-468, 633-652).  Design:
constraint indices are static numpy, so we group

  * all separable cones (Zero/NonNeg/NonPos) into boolean masks → one
    fused elementwise pass;
  * SOC / SDP / EXP constraints by (type, size) into (K, L) index
    matrices → one batched projection per group, gathered and scattered
    with static indices.

No per-cone loops, no padding, no dynamic dispatch.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import jax.numpy as jnp

from pogs_tpu.types import Cone, ConeConstraint
from pogs_tpu.cones.projections import (
    project_soc,
    project_sdp_packed,
    project_exp_primal,
    project_exp_dual,
)

_SEPARABLE = (Cone.ZERO, Cone.NON_NEG, Cone.NON_POS)


def is_separable(cone: Cone) -> bool:
    """prox_lib_cone.h:44-48."""
    return cone in _SEPARABLE


def dual_cone(cone: Cone) -> Cone:
    """Self-dual except the exponential pair (pogs.cpp:825-836)."""
    if cone == Cone.EXP_PRIMAL:
        return Cone.EXP_DUAL
    if cone == Cone.EXP_DUAL:
        return Cone.EXP_PRIMAL
    return cone


def validate_cones(constraints: Sequence[ConeConstraint], dim: int) -> None:
    """No index may repeat or exceed dim (prox_lib_cone.h:50-66)."""
    seen = set()
    for con in constraints:
        for i in con.indices:
            if i in seen:
                raise ValueError(f"cone index {i} appears in multiple cones")
            if i < 0 or i >= dim:
                raise ValueError(f"cone index {i} out of range [0, {dim})")
            seen.add(i)
        if con.cone == Cone.SDP:
            L = len(con.indices)
            nmat = int((-1 + np.sqrt(1 + 8 * L)) / 2)
            if nmat * (nmat + 1) // 2 != L:
                raise ValueError(f"SDP cone size {L} is not n(n+1)/2")
        if con.cone in (Cone.EXP_PRIMAL, Cone.EXP_DUAL) and len(con.indices) != 3:
            raise ValueError("exponential cones have exactly 3 indices")
        if con.cone == Cone.SOC and len(con.indices) < 1:
            raise ValueError("SOC cone needs at least 1 index")


class ConeSet:
    """A fixed set of cone constraints over a dim-vector.

    ``project(v)`` projects v onto the product cone (identity on
    coordinates in no cone — i.e. free).  All structure is resolved at
    construction; ``project`` is pure jnp and traces into a handful of
    batched ops.
    """

    def __init__(self, constraints: Sequence[ConeConstraint], dim: int,
                 validate: bool = True):
        constraints = [
            ConeConstraint(c.cone, c.indices) if not isinstance(c, ConeConstraint) else c
            for c in constraints
        ]
        if validate:
            validate_cones(constraints, dim)
        self.constraints = list(constraints)
        self.dim = dim

        # Separable cones → masks.
        self._masks = {}
        for cone in _SEPARABLE:
            idx = [i for c in constraints if c.cone == cone for i in c.indices]
            if idx:
                mask = np.zeros(dim, bool)
                mask[np.asarray(idx)] = True
                self._masks[cone] = mask

        # Structured cones → (type, L) groups of index matrices.
        self._groups: List = []
        for cone in (Cone.SOC, Cone.SDP, Cone.EXP_PRIMAL, Cone.EXP_DUAL):
            by_size = {}
            for c in constraints:
                if c.cone == cone:
                    by_size.setdefault(len(c.indices), []).append(list(c.indices))
            for L, rows in sorted(by_size.items()):
                self._groups.append((cone, np.asarray(rows, np.int32)))

    def __len__(self):
        return len(self.constraints)

    @property
    def is_separable_only(self) -> bool:
        """True when every constraint is Zero/NonNeg/NonPos (no SOC/SDP/EXP)."""
        return not self._groups

    def separable_masks(self):
        """(zero, nonneg, nonpos) boolean numpy masks over the dim-vector.

        For callers that specialize on separable-only cone sets — e.g. the
        LP active-set polish in solver/hsde.py.
        """
        empty = np.zeros(self.dim, bool)
        return (self._masks.get(Cone.ZERO, empty),
                self._masks.get(Cone.NON_NEG, empty),
                self._masks.get(Cone.NON_POS, empty))

    @property
    def is_empty(self):
        return not self.constraints

    def project(self, v):
        """Π_K(v), one batched op per (type, size) group."""
        out = v
        if Cone.ZERO in self._masks:
            out = jnp.where(jnp.asarray(self._masks[Cone.ZERO]), 0.0, out)
        if Cone.NON_NEG in self._masks:
            out = jnp.where(
                jnp.asarray(self._masks[Cone.NON_NEG]), jnp.maximum(out, 0.0), out
            )
        if Cone.NON_POS in self._masks:
            out = jnp.where(
                jnp.asarray(self._masks[Cone.NON_POS]), jnp.minimum(out, 0.0), out
            )
        for cone, idx in self._groups:
            vals = out[idx]  # (K, L) gather with static indices
            if cone == Cone.SOC:
                proj = project_soc(vals)
            elif cone == Cone.SDP:
                L = idx.shape[1]
                nmat = int((-1 + np.sqrt(1 + 8 * L)) / 2)
                # svec coordinates: the ConeSolver transforms SDP rows into
                # the √2-weighted basis where eigh-clamp is the true
                # Euclidean projection.
                proj = project_sdp_packed(vals, nmat, scaled=True)
            elif cone == Cone.EXP_PRIMAL:
                proj = project_exp_primal(vals)
            else:
                proj = project_exp_dual(vals)
            out = out.at[idx].set(proj)
        return out

    def dual(self) -> "ConeSet":
        """The dual cone set. Zero cones dualize to free (dropped),
        mirroring BuildDualCones (pogs.cpp:838-852)."""
        duals = [
            ConeConstraint(dual_cone(c.cone), c.indices)
            for c in self.constraints
            if c.cone != Cone.ZERO
        ]
        return ConeSet(duals, self.dim, validate=False)

    def constrain_average(self, w):
        """Average entries of w within each non-separable cone — the
        equilibration hook (pogs.cpp:758-782): scalings must be uniform
        inside a cone that is not coordinate-wise."""
        for cone, idx in self._groups:
            mean = jnp.mean(w[idx], axis=1, keepdims=True)
            w = w.at[idx].set(jnp.broadcast_to(mean, idx.shape))
        return w

    def distance(self, v):
        """‖v − Π_K(v)‖ — used for residuals and membership tests."""
        return jnp.linalg.norm(v - self.project(v))

    def svec_scale(self) -> np.ndarray:
        """Per-coordinate svec weights: √2 on off-diagonal entries of SDP
        cones, 1 elsewhere.  The solver conjugates the problem by this
        diagonal so packed-space ℓ2 geometry matches matrix Frobenius
        geometry (see project_sdp_packed)."""
        scale = np.ones(self.dim)
        for con in self.constraints:
            if con.cone != Cone.SDP:
                continue
            L = len(con.indices)
            nmat = int((-1 + np.sqrt(1 + 8 * L)) / 2)
            k = 0
            for col in range(nmat):
                for row in range(col, nmat):
                    if row != col:
                        scale[con.indices[k]] = np.sqrt(2.0)
                    k += 1
        return scale

    @property
    def has_sdp(self) -> bool:
        return any(c.cone == Cone.SDP for c in self.constraints)
