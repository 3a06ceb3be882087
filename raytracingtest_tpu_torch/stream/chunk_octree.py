"""Dynamic chunk octree: the host-side index of the resident world chunks.

Port of ``raytracingtest_tpu/stream/chunk_octree.py``. The root grows
toward an insert outside it, a chunk inserts by descent, a removal prunes
the ancestors it leaves empty, the root shrinks back while it has one child,
and ``extract_trunk`` compiles the resident set into the packed SVO layout
with the chunks as leaves at their own levels (the layout keeps a leaf mask
at every level, so chunks of mixed sizes need nothing special).

Control-plane code, pure Python and numpy on the host, sized by the number
of resident chunks (hundreds), never by voxels. ``extract_trunk`` returns
the port's ``SVO`` on the CPU, with its parent pointers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from raytracingtest_tpu_torch.ops.octree import (
    CHILD_OFFSETS, SVO, compute_parent_ptr)


@dataclasses.dataclass
class ChunkNode:
    position: np.ndarray              # world coordinates of the low corner
    size: float
    children: Optional[list] = None   # 8 slots, or None
    chunk: object = None              # the payload of a chunk node

    @property
    def is_leaf(self):
        return self.children is None


def _slot(position, node, eps):
    """The child slot of `node` that holds `position`."""
    half = node.size * 0.5
    rel = (position - node.position) / half
    return (int(rel[0] >= 1.0 - eps) | (int(rel[1] >= 1.0 - eps) << 1)
            | (int(rel[2] >= 1.0 - eps) << 2))


class ChunkOctree:
    """An octree that grows and shrinks, keyed by world-space chunk boxes
    (power-of-two sizes on a power-of-two lattice)."""

    def __init__(self, origin=(0.0, 0.0, 0.0), size=1.0):
        self.root = ChunkNode(np.asarray(origin, np.float64), float(size))
        self.n_chunks = 0

    # -- insert ----------------------------------------------------------
    def add_chunk(self, position, size, chunk) -> None:
        position = np.asarray(position, np.float64)
        while not self._contains(self.root, position, size):
            self._grow_towards(position)
        self._insert(self.root, position, float(size), chunk)
        self.n_chunks += 1

    def _contains(self, node, position, size):
        eps = 1e-9
        return bool(
            np.all(position >= node.position - eps)
            and np.all(position + size <= node.position + node.size + eps))

    def _grow_towards(self, position):
        # the old root becomes a child of a root twice its size, whose
        # corner extends toward the target
        r = self.root
        dir_bits = [1 if position[i] < r.position[i] else 0 for i in range(3)]
        new_pos = r.position - np.array([dir_bits[i] * r.size for i in range(3)])
        new_root = ChunkNode(new_pos, r.size * 2.0)
        new_root.children = [None] * 8
        new_root.children[dir_bits[0] | (dir_bits[1] << 1) | (dir_bits[2] << 2)] = r
        self.root = new_root

    def _insert(self, node, position, size, chunk):
        if abs(node.size - size) < 1e-9:
            if node.chunk is not None:
                raise ValueError(f"chunk already present at {position}")
            node.chunk = chunk
            return
        if node.is_leaf:
            node.children = [None] * 8
        slot = _slot(position, node, 1e-9)
        if node.children[slot] is None:
            cpos = node.position + CHILD_OFFSETS[slot] * (node.size * 0.5)
            node.children[slot] = ChunkNode(cpos.astype(np.float64), node.size * 0.5)
        self._insert(node.children[slot], position, size, chunk)

    # -- remove ----------------------------------------------------------
    def remove_chunk(self, position, size) -> bool:
        removed = self._remove(self.root, np.asarray(position, np.float64),
                               float(size))
        if removed:
            self.n_chunks -= 1
            self._simplify_root()
        return removed

    def _remove(self, node, position, size):
        if abs(node.size - size) < 1e-9:
            if node.chunk is None:
                return False
            node.chunk = None
            return True
        if node.is_leaf:
            return False
        slot = _slot(position, node, 1e-9)
        child = node.children[slot]
        if child is None:
            return False
        ok = self._remove(child, position, size)
        if ok and child.chunk is None and (
                child.is_leaf or all(c is None for c in child.children)):
            node.children[slot] = None
        if ok and not node.is_leaf and all(c is None for c in node.children):
            node.children = None
        return ok

    def _simplify_root(self):
        # shrink the root while it has one child subtree and no payload
        while not self.root.is_leaf and self.root.chunk is None:
            kids = [c for c in self.root.children if c is not None]
            if len(kids) != 1:
                break
            self.root = kids[0]

    # -- queries ---------------------------------------------------------
    def find_chunk(self, point):
        """The deepest chunk whose box holds `point`, or None."""
        node = self.root
        found = None
        point = np.asarray(point, np.float64)
        if not self._contains(node, point, 0.0):
            return None
        while node is not None:
            if node.chunk is not None:
                found = node.chunk
            if node.is_leaf:
                break
            node = node.children[_slot(point, node, 0.0)]
        return found

    def chunks(self):
        """Every resident chunk as (position, size, payload), depth first."""
        out = []

        def rec(node):
            if node is None:
                return
            if node.chunk is not None:
                out.append((node.position.copy(), node.size, node.chunk))
            if not node.is_leaf:
                for c in node.children:
                    rec(c)

        rec(self.root)
        return out

    # -- trunk compilation ----------------------------------------------
    def extract_trunk(self) -> Tuple[SVO, list]:
        """The resident-chunk tree as a packed trunk SVO whose leaves are the
        chunks (at their own levels), and the leaf-aligned chunk table of
        (position, size, payload), in one breadth-first pass. The trunk's
        tensors lie on the CPU; its leaf attributes are placeholders."""
        levels = [[self.root]]
        while True:
            nxt = [c for node in levels[-1] if not node.is_leaf
                   for c in node.children if c is not None]
            if not nxt:
                break
            levels.append(nxt)

        # a chunk node is a leaf slot of its parent, so the root, which has
        # no parent, cannot be one (the clipmap never puts a chunk there)
        if self.root.chunk is not None:
            raise ValueError("root-level chunk not representable in trunk")

        # rows: every node but a pure chunk leaf, level by level
        row_of = {}
        flat = []
        level_start = [0]
        for nodes in levels:
            for n in nodes:
                if n.is_leaf and n.chunk is not None:
                    continue
                row_of[id(n)] = len(flat)
                flat.append(n)
            level_start.append(len(flat))

        n_rows = len(flat)
        masks = np.zeros(n_rows, np.int32)
        child_base = np.zeros(n_rows, np.int32)
        leaf_base = np.zeros(n_rows, np.int32)
        chunk_table = []
        for row, n in enumerate(flat):
            if n.is_leaf:
                continue
            vm = lm = 0
            first_child = first_leaf = -1
            for k in range(8):
                c = n.children[k]
                if c is None:
                    continue
                vm |= 1 << k
                if c.is_leaf and c.chunk is not None:
                    lm |= 1 << k
                    if first_leaf < 0:
                        first_leaf = len(chunk_table)
                    chunk_table.append((c.position.copy(), c.size, c.chunk))
                elif c.chunk is not None:
                    raise ValueError("chunk on an interior trunk node is unsupported")
                elif first_child < 0:
                    first_child = row_of[id(c)]
            masks[row] = (vm << 8) | lm
            child_base[row] = max(first_child, 0)
            leaf_base[row] = max(first_leaf, 0)

        n_chunks = len(chunk_table)
        t = torch.from_numpy
        svo = SVO(
            masks=t(masks), child_base=t(child_base), leaf_base=t(leaf_base),
            leaf_albedo=torch.zeros((n_chunks, 3)),
            leaf_normal=torch.zeros((n_chunks, 3)),
            leaf_density=torch.ones(n_chunks),
            depth=len(levels), level_start=tuple(level_start),
            parent_ptr=t(compute_parent_ptr(masks, child_base)))
        return svo, chunk_table
