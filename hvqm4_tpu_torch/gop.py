"""GOP structure helpers: display-order patterns ↔ decode order."""

from __future__ import annotations


def reorder_display_to_decode(pattern: str) -> list[tuple[str, int]]:
    """Display-order pattern like 'IBBPBP' → decode-order [(ftype, display_id)].

    Classic MPEG-style rule: an anchor (I/P) is decoded before the B frames
    that precede it in display order.
    """
    out: list[tuple[str, int]] = []
    pending_b: list[int] = []
    anchors = 0

    def flush() -> None:
        # a B is only decodable with two references already decoded
        # (FORMAT.md §10); patterns like "IB" are rejected here so the
        # encoders cannot emit a stream the decoders must refuse
        for b in pending_b:
            if anchors < 2:
                raise ValueError(
                    "B frame without two preceding references in decode "
                    f"order (pattern {pattern!r})")
            out.append(("B", b))
        pending_b.clear()

    for disp, f in enumerate(pattern):
        if f == "B":
            pending_b.append(disp)
        elif f in ("I", "P"):
            out.append((f, disp))
            anchors += 1
            flush()
        else:
            raise ValueError(f"bad frame type {f!r} in pattern {pattern!r}")
    flush()  # trailing Bs: valid iff two anchors are already decoded
    return out
