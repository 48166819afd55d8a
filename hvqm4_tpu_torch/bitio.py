"""Bit-level output and Huffman coding for HVQM4 substreams: the writer half
of `hvqm4_tpu/bitio.py`, which the encoder needs.

Bit order is MSB-first per docs/FORMAT.md §4. The reader half is not copied:
the port reads streams only through the C++ planner (`native`).
`tests/test_torch_bitio.py` holds every writer here against its original and
reads the streams back with the JAX package's `HuffReader`.
"""

from __future__ import annotations

import heapq
from collections import Counter


class BitWriter:
    """MSB-first bit writer; zero-pads the final byte."""

    def __init__(self) -> None:
        self._bytes = bytearray()
        self._cur = 0
        self._fill = 0

    def write_bit(self, b: int) -> None:
        self._cur = (self._cur << 1) | (b & 1)
        self._fill += 1
        if self._fill == 8:
            self._bytes.append(self._cur)
            self._cur = 0
            self._fill = 0

    def write_bits(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.write_bit((v >> i) & 1)

    def write_signed(self, v: int, n: int) -> None:
        self.write_bits(v & ((1 << n) - 1), n)

    def getvalue(self) -> bytes:
        out = bytearray(self._bytes)
        if self._fill:
            out.append(self._cur << (8 - self._fill))
        return bytes(out)

    def bit_length(self) -> int:
        return 8 * len(self._bytes) + self._fill


# ---------------------------------------------------------------------------
# Huffman trees.  A tree is nested tuples: leaf = int symbol; internal =
# (child0, child1).  Serialization per FORMAT.md §4.2.
# ---------------------------------------------------------------------------

def write_tree(w: BitWriter, tree) -> None:
    if isinstance(tree, tuple):
        w.write_bit(1)
        write_tree(w, tree[0])
        write_tree(w, tree[1])
    else:
        w.write_bit(0)
        w.write_bits(tree, 8)


def build_tree(symbols) -> "tuple | int | None":
    """Build a Huffman tree from an iterable of emitted symbols.

    Returns None for an empty sequence; a bare leaf for a single distinct
    symbol (degenerate tree, FORMAT.md §4.2). Ties broken deterministically
    so encoder output is reproducible.
    """
    counts = Counter(symbols)
    if not counts:
        return None
    if len(counts) == 1:
        return next(iter(counts))
    heap = [(n, sym, sym) for sym, n in sorted(counts.items())]
    heapq.heapify(heap)
    while len(heap) > 1:
        n0, t0, tree0 = heapq.heappop(heap)
        n1, t1, tree1 = heapq.heappop(heap)
        heapq.heappush(heap, (n0 + n1, min(t0, t1), (tree0, tree1)))
    return heap[0][2]


def code_table(tree) -> dict[int, tuple[int, int]]:
    """symbol -> (bits, nbits). Degenerate tree: 0-bit code."""
    table: dict[int, tuple[int, int]] = {}

    def walk(node, bits: int, n: int) -> None:
        if isinstance(node, tuple):
            walk(node[0], bits << 1, n + 1)
            walk(node[1], (bits << 1) | 1, n + 1)
        else:
            table[node] = (bits, n)

    if tree is not None:
        walk(tree, 0, 0)
    return table


class HuffWriter:
    """Two-pass helper: collect symbols, then serialize tree + codes."""

    def __init__(self) -> None:
        self.symbols: list[tuple[str, int, int]] = []  # (kind, value, nbits)

    def put_symbol(self, s: int) -> None:
        self.symbols.append(("sym", s, 0))

    def put_raw(self, v: int, n: int) -> None:
        """Raw bits interleaved into the same stream (escapes, run lengths)."""
        self.symbols.append(("raw", v, n))

    def encode(self) -> bytes:
        syms = [v for k, v, _ in self.symbols if k == "sym"]
        if not syms:
            if self.symbols:
                raise ValueError("raw bits in a Huffman stream with no symbols")
            return b""
        tree = build_tree(syms)
        table = code_table(tree)
        w = BitWriter()
        write_tree(w, tree)
        for kind, v, n in self.symbols:
            if kind == "sym":
                bits, nb = table[v]
                w.write_bits(bits, nb)
            else:
                w.write_bits(v & ((1 << n) - 1), n)
        return w.getvalue()
