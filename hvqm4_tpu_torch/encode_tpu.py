"""Full-nest search for the encoder, scored on the device: the port of
`hvqm4_tpu/encode_tpu.py` (module and class keep their names so that a
reader finds the counterpart).

The decoder samples basis vectors from the nest; the encoder's hard problem
is the inverse: for every 4×4 block, find the best nest position/stride.
Exhaustively that is (nest_h·nest_w·4) ≈ 10.6k candidate vectors against
tens of thousands of residuals: a (blocks × 16) @ (16 × candidates) product.
The host encoder samples a few hundred candidates; this module scores ALL of
them on `device`, tiled over candidates so peak memory stays at
`blocks × TILE` scores.

Matching-pursuit selection runs in float; the winning candidates are
re-evaluated on the host with exact integer semantics before they are
committed, so encoded streams remain spec-exact (the decode side never sees
floats).

The scoring picks the same candidate as the JAX search: residuals and centred
candidates are small integers, so every 16-term dot is an integer below 2^24
and exact in any summation order; the gain is then one IEEE f32 multiply and
one f32 divide per element, the first maximum of a tile wins (`argmax`) and a
later tile replaces it only when strictly greater. That needs exact products,
and TF32 keeps 11 significant bits of each input while a second
matching-pursuit round's residuals reach 2,300. The product is therefore
computed in float64, which neither
`torch.backends.cuda.matmul.allow_tf32` nor
`torch.set_float32_matmul_precision` reaches, and converted to f32 (exactly)
before the gain arithmetic: the search does not depend on either global.

Usage (see `encode.VideoEncoder(use_tpu_search=True)`):
    search = NestSearch(nest)                   # per I-frame / GOP, on cuda
    descs, terms, scales = search.best(resids)  # (B,16) -> (B,5),(B,16),(B,)
    # descs = (nx, ny, sxb, syb, off) rows; terms = UNSHIFTED (sample-off)*
    # scale per pixel: callers sum terms across bases and apply the
    # decoder's single >>4 (FORMAT.md §6.2)
"""

from __future__ import annotations

import numpy as np
import torch

TILE = 1024


def search_device(device) -> torch.device:
    """`device` as a torch device; raises when it names a card and there is
    none. Nothing falls back to the CPU: `device="cpu"` asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but CUDA "
                           f"is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


def _all_candidates(nest: np.ndarray):
    """Every (nx, ny, sxb, syb) candidate: descriptors + centered vectors."""
    nh, nw = nest.shape
    i = np.arange(4)
    descs = []
    vecs = []
    for syb in (0, 1):
        for sxb in (0, 1):
            rows = (np.arange(nh)[:, None] + i[None, :] * (syb + 1)) % nh
            cols = (np.arange(nw)[:, None] + i[None, :] * (sxb + 1)) % nw
            # v[y, x, i, j] = nest[rows[y,i], cols[x,j]]
            v = nest[rows[:, None, :, None], cols[None, :, None, :]]
            v = v.reshape(nh * nw, 16).astype(np.int32)
            ny, nx = np.divmod(np.arange(nh * nw), nw)
            off = np.clip(np.round(v.mean(1)), 0, 255).astype(np.int32)
            descs.append(np.stack([nx, ny,
                                   np.full(nh * nw, sxb),
                                   np.full(nh * nw, syb), off], 1))
            vecs.append(v - off[:, None])
    desc = np.concatenate(descs)          # (K, 5): nx, ny, sxb, syb, off
    C = np.concatenate(vecs)              # (K, 16) centered int32
    keep = (C != 0).any(1)                # drop flat candidates
    return desc[keep], C[keep]


class NestSearch:
    """Full-nest matching-pursuit step, batched over blocks on `device`.

    The candidates and their norms go to the device once per nest; `best`
    uploads the residuals, scores them tile by tile and brings back one
    index, dot and norm per residual. `ok` is False for a nest without a
    usable candidate (a constant nest); `best` must not be called then."""

    def __init__(self, nest: np.ndarray, device="cuda"):
        self.device = search_device(device)
        self.desc, C = _all_candidates(nest)
        self.C = C
        self.ok = len(C) > 0
        if not self.ok:
            return
        k = len(C)
        pad = -(-k // TILE) * TILE
        Cf = np.zeros((pad, 16), np.float32)
        Cf[:k] = C.astype(np.float32)
        cc = (Cf * Cf).sum(1)
        cc[k:] = 1.0  # padded rows never win (dot = 0)
        # the transposed candidates in float64 (see the module docstring)
        self._Ct = torch.from_numpy(Cf).to(self.device).double().T.contiguous()
        self._cc = torch.from_numpy(cc).to(self.device)
        self._n_tiles = pad // TILE

    @torch.no_grad()
    def _search(self, R: torch.Tensor):
        """(B, 16) f32 on the device → best index (B,) i64, dot (B,) f32,
        norm (B,) f32, all on the device."""
        B = R.shape[0]
        R64 = R.double()
        best_gain = torch.full((B,), -1.0, device=R.device)
        best_idx = torch.zeros(B, dtype=torch.int64, device=R.device)
        best_dot = torch.zeros(B, device=R.device)
        best_cc = torch.ones(B, device=R.device)
        for t in range(self._n_tiles):
            cct = self._cc[t * TILE:(t + 1) * TILE]
            dots = (R64 @ self._Ct[:, t * TILE:(t + 1) * TILE]).float()
            gains = dots * dots / cct[None, :]
            am = torch.argmax(gains, dim=1)           # the first maximum
            g = gains.gather(1, am[:, None])[:, 0]
            d = dots.gather(1, am[:, None])[:, 0]
            upd = g > best_gain                       # strict: earliest wins
            best_gain = torch.where(upd, g, best_gain)
            best_idx = torch.where(upd, am + t * TILE, best_idx)
            best_dot = torch.where(upd, d, best_dot)
            best_cc = torch.where(upd, cct[am], best_cc)
        return best_idx, best_dot, best_cc

    def best(self, residuals: np.ndarray):
        """(B, 16) residuals → (desc rows (B,5), UNSHIFTED integer terms
        (B,16) = (sample − off)·scale, scales (B,)).

        The decoder sums terms across a block's bases and arithmetic-shifts
        the SUM once (`(Σ terms) >> 4`, FORMAT.md §6.2): returning
        unshifted terms lets callers reproduce that exactly (per-term
        shifting loses up to 1 LSB/pixel per extra basis)."""
        R = torch.from_numpy(np.asarray(residuals, np.float32)).to(self.device)
        idx, dot, cc = self._search(R)
        idx = idx.cpu().numpy()
        scale = np.clip(np.round(16.0 * dot.cpu().numpy() / cc.cpu().numpy()),
                        -128, 127).astype(np.int32)
        C = self.C[idx]                              # (B, 16) int32
        return self.desc[idx], C * scale[:, None], scale
