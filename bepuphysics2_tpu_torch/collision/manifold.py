"""Contact manifold container shared by all pair testers."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.vec import Vec3


class Manifold(NamedTuple):
    """Convex manifold per pair record: ≤4 contacts sharing one normal (reference
    ConvexContactManifold). The normal points from B to A; contact offsets are
    world-space from A's center."""

    normal: Vec3  # (MP,)
    offset_a: Vec3  # (MP, 4)
    depth: torch.Tensor  # (MP, 4)
    feature: torch.Tensor  # (MP, 4) int32
    contact_mask: torch.Tensor  # (MP, 4) bool

    @staticmethod
    def empty(capacity: int, device=None) -> "Manifold":
        return Manifold(
            normal=Vec3.zeros(capacity, device=device),
            offset_a=Vec3.zeros((capacity, 4), device=device),
            depth=torch.zeros((capacity, 4), dtype=torch.float32, device=device),
            feature=torch.zeros((capacity, 4), dtype=torch.int32, device=device),
            contact_mask=torch.zeros((capacity, 4), dtype=torch.bool, device=device),
        )

    def where(self, mask, other: "Manifold") -> "Manifold":
        """Select records from self where mask (shape (MP,)) else other."""
        m1 = mask[:, None]
        return Manifold(
            normal=self.normal.where(mask, other.normal),
            offset_a=self.offset_a.where(m1, other.offset_a),
            depth=torch.where(m1, self.depth, other.depth),
            feature=torch.where(m1, self.feature, other.feature),
            contact_mask=torch.where(m1, self.contact_mask, other.contact_mask),
        )

    def flipped(self, offset_ab: Vec3) -> "Manifold":
        """The manifold with the pair's roles swapped; ``offset_ab`` = pos_testerA −
        pos_sceneA."""
        return self._replace(
            normal=-self.normal,
            offset_a=Vec3(
                self.offset_a.x + offset_ab.x[:, None],
                self.offset_a.y + offset_ab.y[:, None],
                self.offset_a.z + offset_ab.z[:, None],
            ),
        )
