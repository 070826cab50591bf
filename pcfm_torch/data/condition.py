"""Copy of pcfm/data/condition.py (framework-free; the port keeps its own).

TDCR tendon-robot motor conditioning.

Encodes 2- or 3-segment tendon positions (3 tendons per segment) into the
condition vector consumed by the flow models, matching the reference
`condition.py:19-87` semantics: per-segment planar resultant of the three
tendon directions (phase basis 180/300/60 deg, segment 2/3 optionally
yaw-offset), total pull, amplitude (population std around total/3), plus
cross-segment difference/sum features; tendon values are normalized to
[0, 1] by max_pos first.

Implementation is vectorized over segments (one (nseg, 3) matmul against
the direction basis) rather than per-segment scalar code.
"""
from __future__ import annotations

import numpy as np

_PHASE_DEG = np.array([180.0, 300.0, 60.0], dtype=np.float32)

_DIMS = {"raw6": 6, "geom": 10, "raw6+geom": 16,
         "raw9": 9, "geom3": 16, "raw9+geom3": 25}


def _segment_features(mn: np.ndarray, offsets_deg: np.ndarray):
    """mn (nseg, 3) normalized tendon values; offsets_deg (nseg,).

    Returns (vec (nseg, 2), total (nseg,), amp (nseg,)):
      vec   — [cos, sin] resultant of the three tendon phases
      total — sum over tendons
      amp   — rms deviation from total/3 (0 when total <= 0 uses mean 0)
    """
    th = np.deg2rad(_PHASE_DEG[None, :] + offsets_deg[:, None])    # (S,3)
    vec = np.stack([(np.cos(th) * mn).sum(1), (np.sin(th) * mn).sum(1)],
                   axis=1).astype(np.float32)                      # (S,2)
    total = mn.sum(1)
    mean = np.where(total > 0, total / 3.0, 0.0)
    amp = np.sqrt(((mn - mean[:, None]) ** 2).mean(1))
    return vec, total.astype(np.float32), amp.astype(np.float32)


def encode_motors(motors: np.ndarray, enc_mode: str = "raw6+geom",
                  mod2_offset_deg: float = 0.0, max_pos: float = 0.04,
                  mod3_offset_deg: float = 0.0) -> np.ndarray:
    m = np.asarray(motors, dtype=np.float32).reshape(-1)
    if m.shape[0] not in (6, 9):
        raise AssertionError(f"motors dim must be 6 or 9, got {m.shape[0]}")
    nseg = m.shape[0] // 3
    mn = np.clip(m / float(max_pos), 0.0, 1.0).astype(np.float32)

    offsets = np.array([0.0, mod2_offset_deg, mod3_offset_deg][:nseg],
                       dtype=np.float32)
    vec, total, amp = _segment_features(mn.reshape(nseg, 3), offsets)

    per_seg = np.concatenate(
        [np.concatenate([vec[s], [total[s], amp[s]]]) for s in range(nseg)])

    if nseg == 2:
        cross = np.array([total[0] - total[1], total[0] + total[1]],
                         np.float32)
        table = {"raw6": mn, "geom": np.concatenate([per_seg, cross]),
                 "raw6+geom": np.concatenate([mn, per_seg, cross])}
    else:
        cross = np.array([total[0] - total[1], total[1] - total[2],
                          total[0] - total[2], total.sum()], np.float32)
        table = {"raw9": mn, "geom3": np.concatenate([per_seg, cross]),
                 "raw9+geom3": np.concatenate([mn, per_seg, cross])}
    if enc_mode not in table:
        raise ValueError(f"unknown enc_mode={enc_mode} for {nseg}-seg")
    return table[enc_mode].astype(np.float32)


def get_cond_dim(enc_mode: str) -> int:
    if enc_mode in _DIMS:
        return _DIMS[enc_mode]
    n = 9 if ("raw9" in enc_mode or "geom3" in enc_mode) else 6
    return int(encode_motors(np.zeros(n, np.float32), enc_mode).shape[0])
