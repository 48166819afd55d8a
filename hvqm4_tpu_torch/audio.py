"""IMA-ADPCM audio records (reference layer L8, SURVEY.md §2.4; FORMAT.md §8).

Strictly serial per-channel state machine — stays on the host (SURVEY.md §3.5).
Decode is the framework component; `encode_record` exists for the synthetic
corpus generator (`tools/encoder.py`).

The port's copy of `hvqm4_tpu/audio.py`, held against it by
`tests/test_torch_host.py`.
"""

from __future__ import annotations

import struct

import numpy as np

STEP_TABLE = np.array([
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37, 41,
    45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173, 190,
    209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658, 724,
    796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066, 2272,
    2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894, 6484, 7132,
    7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289, 16818, 18500,
    20350, 22385, 24623, 27086, 29794, 32767], np.int32)

INDEX_TABLE = np.array([-1, -1, -1, -1, 2, 4, 6, 8], np.int32)


def _step(nibble: int, pred: int, idx: int) -> tuple[int, int]:
    step = int(STEP_TABLE[idx])
    diff = step >> 3
    if nibble & 1:
        diff += step >> 2
    if nibble & 2:
        diff += step >> 1
    if nibble & 4:
        diff += step
    pred = pred - diff if nibble & 8 else pred + diff
    pred = max(-32768, min(32767, pred))
    idx = max(0, min(88, idx + int(INDEX_TABLE[nibble & 7])))
    return pred, idx


def decode_record(payload: bytes, channels: int) -> np.ndarray:
    """One audio record → interleaved s16 samples, shape (n_samples, channels).

    Bounds-validated like the C oracle: a corrupt record raises
    ContainerError (never IndexError/struct.error, never a huge allocation
    driven by an untrusted count)."""
    from .container import ContainerError

    if len(payload) < 4 + 4 * channels:
        raise ContainerError("audio record too short")
    (n_samples,) = struct.unpack_from(">I", payload, 0)
    off = 4
    pred = []
    idx = []
    for _ in range(channels):
        p, i, _pad = struct.unpack_from(">hBB", payload, off)
        if i > 88:
            raise ContainerError("audio step_index out of range")
        pred.append(p)
        idx.append(i)
        off += 4
    need = (n_samples * channels + 1) // 2
    if len(payload) - off < need:
        raise ContainerError("audio record nibble data truncated")
    out = np.zeros((n_samples, channels), np.int16)
    nib_i = 0
    data = payload[off:]
    for s in range(n_samples):
        for c in range(channels):
            byte = data[nib_i >> 1]
            nib = (byte >> 4) if (nib_i & 1) == 0 else (byte & 0xF)
            nib_i += 1
            pred[c], idx[c] = _step(nib, pred[c], idx[c])
            out[s, c] = pred[c]
    return out


def encode_record(samples: np.ndarray) -> bytes:
    """Interleaved s16 (n, channels) → one audio record payload (corpus tool)."""
    n, channels = samples.shape
    pred = [0] * channels
    idx = [0] * channels
    head = struct.pack(">I", n)
    for c in range(channels):
        head += struct.pack(">hBB", pred[c], idx[c], 0)
    nibbles: list[int] = []
    for s in range(n):
        for c in range(channels):
            target = int(samples[s, c])
            step = int(STEP_TABLE[idx[c]])
            diff = target - pred[c]
            nib = 8 if diff < 0 else 0
            diff = abs(diff)
            if diff >= step:
                nib |= 4
                diff -= step
            if diff >= step >> 1:
                nib |= 2
                diff -= step >> 1
            if diff >= step >> 2:
                nib |= 1
            pred[c], idx[c] = _step(nib, pred[c], idx[c])
            nibbles.append(nib)
    if len(nibbles) % 2:
        nibbles.append(0)
    data = bytes((nibbles[i] << 4) | nibbles[i + 1] for i in range(0, len(nibbles), 2))
    return head + data


def records_to_wav(records: list[np.ndarray], sample_rate: int, path: str) -> None:
    """Concatenate decoded records and write a PCM .wav (CLI convenience)."""
    import wave

    pcm = np.concatenate(records, axis=0) if records else np.zeros((0, 1), np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(pcm.shape[1])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.astype("<i2").tobytes())
