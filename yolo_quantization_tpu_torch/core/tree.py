"""Softmax hierarchy trees (WordTree), darknet's src/tree.c.

The counterpart of ``yolo_quantization_tpu/core/tree.py``.  A tree file has
one "<name> <parent_index>" line per node; siblings are contiguous and a
*group* starts whenever the parent index changes from the previous line.
Parents precede their children, so ``parent[i] < i``.

- ``softmax_tree`` (the grouped softmax) packs the groups into blocks of
  equal padded size, one block per power of two, and reduces each block
  along its last axis: every group's max and sum run in one fixed order.
  The packing and unpacking are gathers whose gradients are gathers by the
  inverse index, so neither direction adds through atomics (``index_add_``
  or ``scatter_add`` would make training on the card nondeterministic).
- ``hierarchy_predictions`` multiplies each node by its parent, one depth
  level at a time; it is a decode step, and no caller differentiates it.
- The hierarchical targets (``path_rows``, ``sibling_rows``) are built per
  label from each node's ancestor list, so a 9,418-node tree never needs
  its two n x n matrices on the device; ``path_matrix`` and
  ``sibling_matrix`` give them on the host.
- The greedy decode (``hierarchy_top_prediction``) runs on the host in
  numpy, once per detection.
"""

from __future__ import annotations

import functools
from functools import cached_property

import numpy as np
import torch


class HierarchyTree:
    """Immutable hierarchy; hashable, so it can sit in frozen layer specs."""

    def __init__(self, parent: np.ndarray, names: tuple[str, ...] | None = None,
                 leaf: np.ndarray | None = None):
        parent = np.asarray(parent, np.int32)
        n = parent.shape[0]
        if np.any(parent >= np.arange(n)):
            raise ValueError("tree file must list parents before children")
        self.n = int(n)
        self.parent = parent
        self.names = tuple(names) if names is not None else tuple(str(i) for i in range(n))

        # a new group starts where the parent id changes between lines
        group = np.zeros(n, np.int32)
        if n > 1:
            group[1:] = np.cumsum(parent[1:] != parent[:-1])
        self.group = group
        self.groups = int(group[-1]) + 1 if n else 0
        starts = np.r_[0, np.nonzero(np.diff(group))[0] + 1] if n else np.zeros(0, np.int64)
        self.group_offset = starts.astype(np.int32)
        self.group_size = np.diff(np.r_[starts, n]).astype(np.int32)

        # child[i] = the group of i's children, -1 for none
        child = np.full(n, -1, np.int32)
        for i in range(n):
            if parent[i] >= 0:
                child[parent[i]] = group[i]
        self.child = child
        has_parent = parent >= 0
        self.parent_or_self = np.where(has_parent, parent, np.arange(n)).astype(np.int64)

        if leaf is None:
            leaf = np.ones(n, bool)
            leaf[parent[has_parent]] = False
        self.leaf = np.asarray(leaf, bool)

        depth = np.zeros(n, np.int32)
        for i in range(n):
            if parent[i] >= 0:
                depth[i] = depth[parent[i]] + 1
        self.depth = depth
        self.max_depth = int(depth.max()) if n else 0

        self._hash = hash((self.n, parent.tobytes(), self.leaf.tobytes(), self.names))

    def __hash__(self) -> int:
        return self._hash

    def __eq__(self, other) -> bool:
        return (isinstance(other, HierarchyTree) and self.n == other.n
                and np.array_equal(self.parent, other.parent)
                and np.array_equal(self.leaf, other.leaf) and self.names == other.names)

    def __repr__(self) -> str:
        return f"HierarchyTree(n={self.n}, groups={self.groups}, depth={self.max_depth})"

    @cached_property
    def ancestors(self) -> np.ndarray:
        """(n, max_depth + 1) int64: node c, its parent, ..., its root, then
        -1 padding."""
        anc = np.full((self.n, self.max_depth + 1), -1, np.int64)
        anc[:, 0] = np.arange(self.n)
        for d in range(1, self.max_depth + 1):
            prev = anc[:, d - 1]
            ok = prev >= 0
            anc[ok, d] = self.parent[prev[ok]]
        return anc

    @cached_property
    def path_matrix(self) -> np.ndarray:
        """[n, n] bool: path_matrix[c, k] == k is c or an ancestor of c."""
        return path_rows(self, np.arange(self.n))

    @cached_property
    def sibling_matrix(self) -> np.ndarray:
        """[n, n] bool: sibling_matrix[c, k] == k shares a group with c or
        any ancestor of c (the nodes whose deltas a truth label c touches in
        the hierarchical class loss, src/region_layer.c:117-129)."""
        return sibling_rows(self, np.arange(self.n))

    def change_leaves(self, leaf_names) -> "HierarchyTree":
        """Re-mark leaves from a name list (src/tree.c:7-25)."""
        wanted = set(leaf_names)
        return HierarchyTree(self.parent, self.names, np.array([nm in wanted for nm in self.names], bool))


def parse_tree(lines) -> HierarchyTree:
    parents: list[int] = []
    names: list[str] = []
    for line in lines:
        parts = line.strip().split()
        if not parts:
            continue
        names.append(parts[0])
        parents.append(int(parts[1]) if len(parts) > 1 else -1)
    return HierarchyTree(np.asarray(parents, np.int32), tuple(names))


def read_tree(path: str) -> HierarchyTree:
    """Load a darknet .tree file (src/tree.c:83-139)."""
    with open(path) as f:
        return parse_tree(f)


# ---------------------------------------------------------------------------
# Hierarchical targets, row by row
# ---------------------------------------------------------------------------


def path_rows(tree: HierarchyTree, labels):
    """Rows of ``path_matrix`` for ``labels``: numpy bool for a numpy
    argument, float32 on the labels' device for a tensor."""
    if isinstance(labels, torch.Tensor):
        anc = _device_table(tree, "ancestors", labels.device)[labels]         # (..., D+1)
        nodes = torch.arange(tree.n, device=labels.device)
        return (anc[..., None] == nodes).any(-2).to(torch.float32)
    anc = tree.ancestors[np.asarray(labels)]
    return (anc[..., None] == np.arange(tree.n)).any(-2)


def sibling_rows(tree: HierarchyTree, labels):
    """Rows of ``sibling_matrix`` for ``labels`` (as ``path_rows``)."""
    if isinstance(labels, torch.Tensor):
        dev = labels.device
        anc = _device_table(tree, "ancestors", dev)[labels]
        group = _device_table(tree, "group", dev)
        anc_group = torch.where(anc >= 0, group[anc.clamp(min=0)], torch.full_like(anc, -1))
        return (anc_group[..., None] == group).any(-2).to(torch.float32)
    anc = tree.ancestors[np.asarray(labels)]
    anc_group = np.where(anc >= 0, tree.group[np.maximum(anc, 0)], -1)
    return (anc_group[..., None] == tree.group).any(-2)


@functools.lru_cache(maxsize=16)
def _device_table(tree: HierarchyTree, name: str, device: torch.device) -> torch.Tensor:
    # cached across calls: never an inference tensor, which training could not save
    with torch.inference_mode(False):
        return torch.as_tensor(np.asarray(getattr(tree, name), np.int64), device=device)


# ---------------------------------------------------------------------------
# The grouped softmax
# ---------------------------------------------------------------------------


class _Take(torch.autograd.Function):
    """x[:, index] along dim 1, where no column that takes a gradient
    appears twice in ``index``.  The gradient gathers by ``inverse``:
    inverse[c] is the output position holding column c, or len(index) (a
    zero) for a column that holds none or whose gradient is dropped."""

    @staticmethod
    def forward(ctx, x, index, inverse):
        ctx.save_for_backward(inverse)
        return x.index_select(1, index)

    @staticmethod
    def backward(ctx, g):
        (inverse,) = ctx.saved_tensors
        g = torch.cat([g, g.new_zeros(g.shape[0], 1)], dim=1)
        return g.index_select(1, inverse), None, None


@functools.lru_cache(maxsize=16)
def _packing(tree: HierarchyTree, device: torch.device):
    """The groups packed into blocks, one per padded size (a power of two):
    ((size, groups) per block, pack index and its inverse, unpack index and
    its inverse).  Packed slots past a group's end read column n, which
    holds -inf."""
    n = tree.n
    pad = np.maximum(1, 2 ** np.ceil(np.log2(np.maximum(tree.group_size, 1)))).astype(np.int64)
    blocks, pack = [], []
    for size in np.unique(pad):
        gs = np.nonzero(pad == size)[0]
        slots = tree.group_offset[gs][:, None] + np.arange(size)[None, :]
        slots = np.where(np.arange(size)[None, :] < tree.group_size[gs][:, None], slots, n)
        blocks.append((int(size), int(gs.shape[0])))
        pack.append(slots.reshape(-1))
    pack = np.concatenate(pack).astype(np.int64)
    p_len = pack.shape[0]
    real = pack < n
    unpack = np.empty(n, np.int64)
    unpack[pack[real]] = np.nonzero(real)[0]
    pack_inv = np.full(n + 1, p_len, np.int64)
    pack_inv[:n] = unpack
    unpack_inv = np.full(p_len, n, np.int64)
    unpack_inv[unpack] = np.arange(n)
    with torch.inference_mode(False):  # cached: never an inference tensor
        t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
        return tuple(blocks), t(pack), t(pack_inv), t(unpack), t(unpack_inv)


def softmax_tree(x: torch.Tensor, tree: HierarchyTree, temperature: float = 1.0) -> torch.Tensor:
    """Independent softmax within each sibling group, over the last axis
    (forward_softmax_layer's per-group loop, src/softmax_layer.c:41-48)."""
    if temperature != 1.0:
        x = x / temperature
    shape = x.shape
    flat = x.reshape(-1, tree.n)
    rows = flat.shape[0]
    blocks, pack, pack_inv, unpack, unpack_inv = _packing(tree, x.device)
    ext = torch.cat([flat, flat.new_full((rows, 1), float("-inf"))], dim=1)
    packed = _Take.apply(ext, pack, pack_inv)
    probs, at = [], 0
    for size, groups in blocks:
        v = packed[:, at : at + size * groups].reshape(rows, groups, size)
        e = torch.exp(v - torch.amax(v, dim=-1, keepdim=True))
        probs.append((e / torch.sum(e, dim=-1, keepdim=True)).reshape(rows, -1))
        at += size * groups
    return _Take.apply(torch.cat(probs, dim=1), unpack, unpack_inv).reshape(shape)


def hierarchy_predictions(p: torch.Tensor, tree: HierarchyTree, only_leaves: bool = False) -> torch.Tensor:
    """Multiply each node's conditional probability by its ancestors'
    (src/tree.c:37-51); the last axis indexes nodes.  The reference's
    in-order pass equals ``max_depth`` rounds of parent gathers, because
    parents precede their children."""
    parent = _device_table(tree, "parent_or_self", p.device)
    depth = _device_table(tree, "depth", p.device)
    for d in range(1, tree.max_depth + 1):
        p = torch.where(depth == d, p * p.index_select(-1, parent), p)
    if only_leaves:
        p = torch.where(_device_table(tree, "leaf", p.device) > 0, p, p.new_tensor(0.0))
    return p


def hierarchy_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, tree: HierarchyTree) -> torch.Tensor:
    """WordTree classifier loss: minus the sum of the log conditional
    probabilities over the label's ancestor path (the truth vector is 1 on
    the label and every ancestor, src/softmax_layer.c:53-55).  Per-example
    losses."""
    p = softmax_tree(logits, tree)
    return -torch.sum(path_rows(tree, labels) * torch.log(p + 1e-9), dim=-1)


# ---------------------------------------------------------------------------
# Host-side decode (numpy)
# ---------------------------------------------------------------------------


def get_hierarchy_probability(p: np.ndarray, tree: HierarchyTree, c: int) -> float:
    """Joint probability of node c: the product over its ancestor path
    (src/tree.c:27-35); ``p`` holds per-node conditionals."""
    out = 1.0
    while c >= 0:
        out *= float(p[c])
        c = int(tree.parent[c])
    return out


def hierarchy_top_prediction(p: np.ndarray, tree: HierarchyTree, thresh: float) -> int:
    """Greedy root-to-leaf descent that stops where the joint probability
    would drop below ``thresh`` (src/tree.c:53-81)."""
    prob = 1.0
    group = 0
    while True:
        o = int(tree.group_offset[group])
        s = int(tree.group_size[group])
        seg = np.asarray(p[o : o + s])
        max_i = o + int(np.argmax(seg))
        mx = float(seg.max(initial=0.0))
        if prob * mx > thresh:
            prob *= mx
            nxt = int(tree.child[max_i])
            if nxt < 0:
                return max_i
            group = nxt
        elif group == 0:
            return max_i
        else:
            return int(tree.parent[int(tree.group_offset[group])])
