"""The one traffic generator: a ring of gray frames of a textured plane seen
by a camera that moves from frame to frame, rendered on the device from the
seed and kept on the host as ``uint8``, as a camera delivers them.

A traffic file (``traffic/<name>.json``) gives the motion:

- ``ring``: frames rendered, so that no frame is rendered while the window
  runs.
- ``replay``: ``"ping_pong"`` (the default) replays the ring forward and
  back (0, 1, ..., ring-1, ring-2, ..., 1, 0, 1, ...); ``"loop"`` closes
  the camera's path (the last frame's step leads back to the first frame)
  and replays the ring forward, round and round, so that the camera never
  turns back over its own track.
- ``speed_px``: ``[lo, hi]``, the camera's translation from one frame to the
  next, in pixels of the image.
- ``direction``: ``[dx, dy]`` for a fixed direction of travel, ``null``
  for a direction of its own at every frame, or ``"circle"`` for a heading
  that turns once round, evenly, over the ring.
- ``turn_rad``: ``[lo, hi]``, the in-plane turn from one frame to the next.
- ``zoom``: ``[lo, hi]``, the change of scale from one frame to the next.
- ``batch``: frame pairs per call (pair-wise configurations), else 1.
- ``trace_frames``: frames (or calls) the profiler records in a traced run.

Each per-frame quantity takes one value a step (``ring - 1`` steps, or
``ring`` on a loop) evenly spaced over its range; the seed only orders
them. On a loop the turns, zooms and steps are then shifted so that they
sum to none. So every seed gives the same set of
motions, and the same work, in another order. The seed also places the
camera's start on the texture. The texture (``Texture`` below, a copy of
the repository's analytic test texture) is the configuration's: its
parameters sit in the configuration file.
"""

from __future__ import annotations

import math

import numpy as np
import torch


class Texture:
    """Smooth, corner-rich analytic texture: value(x, y) in [0, 255], a
    band-limited sum of sinusoids."""

    def __init__(self, seed=0, n_waves=24, min_period=6.0, max_period=60.0):
        rng = np.random.default_rng(seed)
        periods = rng.uniform(min_period, max_period, size=n_waves)
        angles = rng.uniform(0, 2 * np.pi, size=n_waves)
        self.fx = np.cos(angles) / periods
        self.fy = np.sin(angles) / periods
        self.phase = rng.uniform(0, 2 * np.pi, size=n_waves)
        self.amp = rng.uniform(0.5, 1.0, size=n_waves)

    def render(self, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
        """Values at float64 texture coordinates ``xs``, ``ys`` (any equal
        shape, on any device), float32."""
        total = torch.zeros(xs.shape, dtype=torch.float32, device=xs.device)
        for fx, fy, ph, amp in zip(self.fx, self.fy, self.phase, self.amp):
            t = fx * xs + fy * ys
            frac = (t - torch.floor(t)).to(torch.float32)
            total += float(amp) * torch.sin(2.0 * math.pi * frac + float(ph))
        return (total / float(np.sum(self.amp)) * 0.5 + 0.5) * 255.0


def _spaced(rng, lo_hi, n):
    lo, hi = (float(v) for v in lo_hi)
    return rng.permutation(np.linspace(lo, hi, n))


def camera_path(traffic: dict, seed: int):
    """Per-frame pose ``(tx, ty, angle, scale)``, each ``[ring]`` float64:
    frame k samples the texture at ``T_k + scale_k R(angle_k) (p - c)`` for
    an image point p, c the image centre."""
    n = int(traffic["ring"])
    loop = traffic.get("replay", "ping_pong") == "loop"
    m = n if loop else n - 1            # steps between frames
    rng = np.random.default_rng(seed)
    start = rng.uniform(-20000.0, 20000.0, size=2)
    speed = _spaced(rng, traffic["speed_px"], m)
    direction = traffic.get("direction")
    if direction is None:
        heading = _spaced(rng, [0.0, 2 * math.pi * (m - 1) / m], m)
    elif direction == "circle":
        heading = rng.uniform(0.0, 2 * math.pi) + 2 * math.pi * np.arange(
            m) / m
    else:
        dx, dy = direction
        heading = np.full(m, math.atan2(dy, dx))
    turn = _spaced(rng, traffic.get("turn_rad", [0.0, 0.0]), m)
    zoom = _spaced(rng, traffic.get("zoom", [1.0, 1.0]), m)
    if loop:
        turn = turn - turn.mean()
        zoom = zoom / np.exp(np.log(zoom).mean())
    angle = np.concatenate([[0.0], np.cumsum(turn)])
    scale = np.concatenate([[1.0], np.cumprod(zoom)])
    # The scene moves by -step in the image when the camera moves by step:
    # the texture point under a pixel moves by +step (in the camera's own
    # axes, so a turned camera keeps travelling along its own heading).
    steps = np.stack([speed * np.cos(heading), speed * np.sin(heading)], -1)
    ca, sa = np.cos(angle[:-1]), np.sin(angle[:-1])
    world = np.stack([ca * steps[:, 0] - sa * steps[:, 1],
                      sa * steps[:, 0] + ca * steps[:, 1]], -1)
    world *= scale[:-1, None]
    if loop:
        world -= world.mean(0)
    pos = np.concatenate([start[None], start[None] + np.cumsum(world, 0)])
    return pos[:n, 0], pos[:n, 1], angle[:n], scale[:n]


def render_ring(texture: Texture, height: int, width: int, traffic: dict,
                seed: int, device, chunk: int = 8) -> np.ndarray:
    """``[ring, height, width]`` uint8 frames on the host, rendered on
    ``device`` a few frames at a time."""
    tx, ty, angle, scale = camera_path(traffic, seed)
    n = len(tx)
    dev = torch.device(device)
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float64, device=dev) - height / 2,
        torch.arange(width, dtype=torch.float64, device=dev) - width / 2,
        indexing="ij")
    out = torch.empty((n, height, width), dtype=torch.uint8, device=dev)
    for k0 in range(0, n, chunk):
        k1 = min(n, k0 + chunk)

        def col(a):
            return torch.as_tensor(a[k0:k1], dtype=torch.float64,
                                   device=dev)[:, None, None]

        c, s, z = col(np.cos(angle)), col(np.sin(angle)), col(scale)
        wx = col(tx) + z * (c * xs - s * ys)
        wy = col(ty) + z * (s * xs + c * ys)
        out[k0:k1] = texture.render(wx, wy).round().clamp(0, 255).to(
            torch.uint8)
    return out.cpu().numpy()


def ping_pong(ring: int, position: int) -> int:
    """Ring index of the ``position``-th frame of the forward-and-back
    replay."""
    if ring == 1:
        return 0
    cycle = 2 * (ring - 1)
    k = position % cycle
    return k if k < ring else cycle - k


def frame_index(traffic: dict, ring: int, position: int) -> int:
    """Ring index of the ``position``-th frame of the traffic's replay."""
    if traffic.get("replay", "ping_pong") == "loop":
        return position % ring
    return ping_pong(ring, position)


def sequence_period(traffic: dict, ring: int) -> int:
    """Frames after which the traffic's replay repeats."""
    if traffic.get("replay", "ping_pong") == "loop":
        return ring
    return max(1, 2 * (ring - 1))
