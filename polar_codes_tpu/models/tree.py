"""Code-tree specialization: classify subcodes once, at trace time.

The reference builds a specialized decoder tree with C++ `new`-dispatch at
construction time (fastssc_avx_float.cpp:797-897 createDecoder). The JAX
analogue: classify the (static) frozen set into a tree of node kinds on the
host; decoders then walk the tree in Python *while tracing*, emitting a flat
schedule of batched XLA ops. The tree is static per code, so the traced
program is fully specialized with zero runtime dispatch.

Node kinds (Fast-SSC / Hanif-Ardakani leaf set):
  RATE0  all-frozen subcode               (decode: bits = 0)
  RATE1  no-frozen subcode                (decode: hard decisions)
  REP    repetition: only last bit info   (decode: sign of LLR sum)
  SPC    single parity check: only bit 0 frozen (decode: hard + parity fix)
  BRANCH internal node (f -> left, g -> right, combine)

The reference's extra fused leaves (DoubleRep, TypeFive, ZeroSPC, ROne/ZeroR
shortcuts) are trace-time *schedule* optimizations here; the classifier
exposes the structure (child kinds) so decoders can fuse when profitable.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np


class NodeKind(enum.Enum):
    RATE0 = "rate0"
    RATE1 = "rate1"
    REP = "rep"
    SPC = "spc"
    ENUM = "enum"  # small subcode decoded by exhaustive ML enumeration
    BRANCH = "branch"


@dataclass
class CodeNode:
    """One subcode in the specialization tree.

    offset/length locate the node's span in the codeword; frozen holds the
    node-local frozen positions (sorted, rebased).
    """

    offset: int
    length: int
    frozen: np.ndarray
    kind: NodeKind
    left: Optional["CodeNode"] = None
    right: Optional["CodeNode"] = None

    @property
    def info_count(self) -> int:
        return self.length - len(self.frozen)

    def leaves(self) -> List["CodeNode"]:
        if self.kind != NodeKind.BRANCH:
            return [self]
        return self.left.leaves() + self.right.leaves()

    def node_count(self) -> int:
        if self.kind != NodeKind.BRANCH:
            return 1
        return 1 + self.left.node_count() + self.right.node_count()

    def describe(self, depth: int = 0) -> str:
        """Human-readable tree dump (replaces the PCTree Qt viewer's data)."""
        pad = "  " * depth
        line = f"{pad}{self.kind.value}[{self.offset}:{self.offset + self.length}]"
        if self.kind != NodeKind.BRANCH:
            return line
        return "\n".join(
            [line, self.left.describe(depth + 1), self.right.describe(depth + 1)]
        )


ALL_LEAF_KINDS = frozenset(
    {NodeKind.RATE0, NodeKind.RATE1, NodeKind.REP, NodeKind.SPC}
)


def classify(
    length: int,
    frozen: np.ndarray,
    allowed=ALL_LEAF_KINDS,
    enum_span: int = 0,
    max_enum_k: int = 0,
) -> NodeKind:
    """Leaf classification, matching the reference's dispatch semantics.

    `allowed` restricts which leaf kinds may terminate recursion (the SCAN
    decoders only collapse Rate-0/Rate-1 subtrees, fastsscan_float.cpp).
    With enum_span/max_enum_k set, small mixed-rate subcodes become ENUM
    leaves (exhaustive ML enumeration; subsumes REP and small SPC/RateR
    subtrees in one node)."""
    n_frozen = len(frozen)
    if n_frozen == length and NodeKind.RATE0 in allowed:
        return NodeKind.RATE0
    if n_frozen == 0 and NodeKind.RATE1 in allowed:
        return NodeKind.RATE1
    if length == 1:
        # span-1 nodes are rate-0 or rate-1 by definition
        return NodeKind.RATE0 if n_frozen else NodeKind.RATE1
    if (
        enum_span
        and length <= enum_span
        and 1 <= length - n_frozen <= max_enum_k
    ):
        return NodeKind.ENUM
    if (
        n_frozen == length - 1
        and frozen[-1] == length - 2
        and NodeKind.REP in allowed
    ):
        # all frozen except the last position
        return NodeKind.REP
    if n_frozen == 1 and frozen[0] == 0 and NodeKind.SPC in allowed:
        return NodeKind.SPC
    return NodeKind.BRANCH


def build_tree(
    block_length: int,
    frozen_bit_positions: Sequence[int],
    offset: int = 0,
    allowed=ALL_LEAF_KINDS,
    enum_span: int = 0,
    max_enum_k: int = 0,
) -> CodeNode:
    """Recursively specialize the code defined by (N, frozen set).

    `allowed` restricts the leaf kinds; enum_span/max_enum_k enable ENUM
    leaves (see classify)."""
    frozen = np.sort(np.asarray(frozen_bit_positions, dtype=np.int64))
    kind = classify(block_length, frozen, allowed, enum_span, max_enum_k)
    node = CodeNode(offset=offset, length=block_length, frozen=frozen, kind=kind)
    if kind == NodeKind.BRANCH:
        if block_length == 1:
            raise AssertionError("length-1 node cannot branch")
        half = block_length // 2
        left_frozen = frozen[frozen < half]
        right_frozen = frozen[frozen >= half] - half
        node.left = build_tree(
            half, left_frozen, offset, allowed, enum_span, max_enum_k
        )
        node.right = build_tree(
            half, right_frozen, offset + half, allowed, enum_span, max_enum_k
        )
    return node
