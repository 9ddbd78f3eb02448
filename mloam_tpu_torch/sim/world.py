"""Synthetic LiDAR world: analytic ray-casting against plane/cylinder
primitives along a smooth trajectory.

The deterministic replay fixture: every end-to-end gate runs against
sequences rendered here, with exact ground truth and exact per-point sweep
timing. Counterpart of ``mloam_tpu/sim/world.py``: random worlds, the
degenerate corridor, smooth / circular / straight trajectories, and objects
that ride with the vehicle (companions) or cross its path (movers).

The world is built from finite rectangles (ground, building walls) and
vertical cylinders (poles, trunks) — structure that exercises both LOAM
feature classes. Scans are rendered with intra-sweep motion distortion: each
azimuth column is ray-cast from the interpolated sensor pose at its firing
time, and ranges are reported in the sensor frame at that time — exactly what
a spinning LiDAR measures.

Worlds, trajectories and range noise are drawn from a ``torch.Generator``;
the same seed does not give the JAX package's world or noise (different
generators: the same distributions, other draws). To compare the two
packages, carry the JAX ``World``/``Trajectory`` across as numpy
(``utils/convert``). Frame i's range noise is drawn from a generator seeded
by ``(noise_seed, i)`` alone, as the JAX package folds i into its key, so a
noisy frame does not depend on the frames rendered before it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from mloam_tpu_torch import resolve_device
from mloam_tpu_torch.core import rotations as rot
from mloam_tpu_torch.core import se3
from mloam_tpu_torch.core.rangeimage import (LidarModel, RangeImage, from_grid,
                                             unit_rays)
from mloam_tpu_torch.core.rotations import _cross
from mloam_tpu_torch.core.se3 import Pose

_BIG = 1e9


class World(NamedTuple):
    rect_center: torch.Tensor  # [P, 3]
    rect_u: torch.Tensor       # [P, 3] half-extent vector 1
    rect_v: torch.Tensor       # [P, 3] half-extent vector 2
    rect_mask: torch.Tensor    # [P]
    cyl_xyr: torch.Tensor      # [Q, 3] center x, y, radius
    cyl_z: torch.Tensor        # [Q, 2] zmin, zmax
    cyl_mask: torch.Tensor     # [Q]


def frame_noise_seed(noise_seed: int, i: int) -> int:
    """The seed of frame i's range noise: a 32-bit mix of ``(noise_seed, i)``
    alone (the CPU generator keeps only a seed's low 32 bits, so the two are
    mixed rather than packed side by side)."""
    return int(np.random.SeedSequence([noise_seed, i]).generate_state(1)[0])


def _uniform(gen: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    """Uniform draw on the CPU from ``gen`` (the same world on any device)."""
    return lo + (hi - lo) * torch.rand(shape, generator=gen, dtype=torch.float32)


def make_world(
    generator: torch.Generator,
    extent: float = 40.0,
    n_walls: int = 24,
    n_poles: int = 12,
    wall_height: float = 4.0,
    device=None,
) -> World:
    """Random structured world: big ground plane, vertical walls at random
    yaw, vertical poles. Deterministic in the generator's state."""
    device = resolve_device(device)
    g = generator
    ground_c = torch.tensor([[0.0, 0.0, 0.0]])
    ground_u = torch.tensor([[extent * 2.0, 0.0, 0.0]])
    ground_v = torch.tensor([[0.0, extent * 2.0, 0.0]])

    # walls: random center (ring between 6 and extent), random yaw, random len
    r = _uniform(g, (n_walls,), 6.0, extent)
    ang = _uniform(g, (n_walls,), -math.pi, math.pi)
    yaw = _uniform(g, (n_walls,), -math.pi, math.pi)
    half_len = _uniform(g, (n_walls,), 2.0, 8.0)
    zeros = torch.zeros(n_walls)
    half_h = torch.full((n_walls,), wall_height / 2)
    wc = torch.stack([r * torch.cos(ang), r * torch.sin(ang), half_h], -1)
    wu = torch.stack([half_len * torch.cos(yaw), half_len * torch.sin(yaw), zeros], -1)
    wv = torch.stack([zeros, zeros, half_h], -1)

    rect_c = torch.cat([ground_c, wc])
    rect_u = torch.cat([ground_u, wu])
    rect_v = torch.cat([ground_v, wv])

    pr = _uniform(g, (n_poles,), 4.0, extent * 0.8)
    pang = _uniform(g, (n_poles,), -math.pi, math.pi)
    cyl_xyr = torch.stack(
        [pr * torch.cos(pang), pr * torch.sin(pang), torch.full((n_poles,), 0.25)], -1)
    cyl_z = torch.tensor([0.0, 5.0]).expand(n_poles, 2).clone()
    w = World(rect_c, rect_u, rect_v, torch.ones(rect_c.shape[0], dtype=torch.bool),
              cyl_xyr, cyl_z, torch.ones(n_poles, dtype=torch.bool))
    return World(*(x.to(device) for x in w))


def make_corridor_world(length: float = 120.0, width: float = 4.0,
                        wall_height: float = 4.0,
                        featured_entry: bool = True,
                        ceiling: bool = True,
                        rails: bool = True,
                        device=None) -> World:
    """Featureless straight corridor along +x: two parallel side walls,
    ground (and ceiling), far end caps. Translation along x is geometrically
    unobservable in the corridor interior (every surface normal is ⊥ x): the
    degenerate scene the solution remapping exists for. Fixed geometry, no
    draw: equal to the JAX package's corridor field by field.

    ``ceiling`` closes the top (a tunnel). ``rails``: four thin strips along
    the corridor (floor curbs and ceiling rails) that add y / z / pitch /
    roll information and none along x, so the weak direction is a canonical
    axis rather than a mix (on a 16-ring sensor with a 20 m range it is z
    for the first ~30 sweeps of the straight course, then x).
    ``featured_entry``: poles over x in [-12, -1] make the entry segment
    fully observable (the estimator learns the speed there; inside, the
    constant-velocity prediction is the only information along x)."""
    device = resolve_device(device)
    half = length / 2.0
    rect_c = torch.tensor([
        [0.0, 0.0, 0.0],                       # ground strip
        [0.0, -width / 2.0, wall_height / 2],  # right wall
        [0.0, width / 2.0, wall_height / 2],   # left wall
        [half, 0.0, wall_height / 2],          # far end cap
        [-5.0, 0.0, wall_height / 2],          # entry back wall (⊥ x)
        [0.0, 0.0, wall_height],               # ceiling (masked if open)
        # longitudinal rails (masked if rails=False)
        [0.0, -width / 2 + 0.6, 0.30],
        [0.0, width / 2 - 0.6, 0.30],
        [0.0, -width / 2 + 0.6, wall_height - 0.30],
        [0.0, width / 2 - 0.6, wall_height - 0.30],
    ])
    rect_u = torch.tensor([[half, 0.0, 0.0]] * 3 + [[0.0, width, 0.0]] * 2
                          + [[half, 0.0, 0.0]] * 5)
    rect_v = torch.tensor([[0.0, width, 0.0]] + [[0.0, 0.0, wall_height / 2]] * 4
                          + [[0.0, width, 0.0]] + [[0.0, 0.12, 0.0]] * 4)
    n_poles = 8
    if featured_entry:
        # x from -12 to -1 in 7 equal steps, as float32 values equal to the
        # JAX package's ``linspace`` (its XLA build rounds three of them an
        # ulp or few away from ``torch.linspace``'s)
        px = torch.tensor([-12.0, -10.428572, -8.857142, -7.2857137, -5.7142854,
                           -4.142857, -2.5714278, -1.0])
        py = torch.where(torch.arange(n_poles) % 2 == 0,
                         torch.tensor(-width / 2 + 0.4), torch.tensor(width / 2 - 0.4))
        cyl_xyr = torch.stack([px, py, torch.full((n_poles,), 0.15)], -1)
        cyl_z = torch.tensor([0.0, wall_height]).expand(n_poles, 2).clone()
        cyl_mask = torch.ones(n_poles, dtype=torch.bool)
    else:
        cyl_xyr = torch.zeros((1, 3))
        cyl_z = torch.zeros((1, 2))
        cyl_mask = torch.zeros(1, dtype=torch.bool)
    rect_mask = torch.tensor([True] * 5 + [bool(ceiling)] + [bool(rails)] * 4)
    w = World(rect_c, rect_u, rect_v, rect_mask, cyl_xyr, cyl_z, cyl_mask)
    return World(*(x.to(device) for x in w))


def _raycast_rects(world: World, o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Min positive hit distance against all rectangles. o,d: [N,3] -> [N]."""
    c, u, v = world.rect_center, world.rect_u, world.rect_v
    n = _cross(u, v)
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-9)
    # t = (c - o)·n / d·n   per (ray, rect)
    denom = d @ n.T
    numer = torch.sum(c * n, -1)[None, :] - o @ n.T
    t = numer / torch.where(torch.abs(denom) < 1e-9, torch.inf, denom)
    hit = o[:, None, :] + t[..., None] * d[:, None, :] - c[None, :, :]
    ulen2 = torch.sum(u * u, -1)
    vlen2 = torch.sum(v * v, -1)
    pu = torch.sum(hit * u[None], -1)
    pv = torch.sum(hit * v[None], -1)
    inside = (torch.abs(pu) <= ulen2[None, :]) & (torch.abs(pv) <= vlen2[None, :])
    ok = inside & (t > 0.05) & world.rect_mask[None, :]
    return torch.min(torch.where(ok, t, _BIG), dim=1).values


def _raycast_cyls(world: World, o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Min positive hit distance against vertical cylinders. [N,3] -> [N]."""
    cxy = world.cyl_xyr[:, :2]
    rad = world.cyl_xyr[:, 2]
    oxy = o[:, None, :2] - cxy[None, :, :]
    dxy = d[:, None, :2]
    a = torch.sum(dxy * dxy, -1)
    b = 2.0 * torch.sum(oxy * dxy, -1)
    cc = torch.sum(oxy * oxy, -1) - (rad ** 2)[None, :]
    disc = b * b - 4 * a * cc
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    a_safe = torch.where(torch.abs(a) < 1e-12, 1e-12, a)
    t0 = (-b - sq) / (2 * a_safe)
    t1 = (-b + sq) / (2 * a_safe)
    t = torch.where(t0 > 0.05, t0, t1)
    z = o[:, None, 2] + t * d[:, None, 2]
    ok = (
        (disc > 0)
        & (t > 0.05)
        & (z >= world.cyl_z[None, :, 0])
        & (z <= world.cyl_z[None, :, 1])
        & world.cyl_mask[None, :]
    )
    return torch.min(torch.where(ok, t, _BIG), dim=1).values


def raycast(world: World, o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """[N] min positive range, _BIG where no hit."""
    return torch.minimum(_raycast_rects(world, o, d), _raycast_cyls(world, o, d))


def sensor_rays(model: LidarModel, dtype=torch.float32, device=None) -> torch.Tensor:
    """[R, C, 3] unit ray directions in the sensor frame (the canonical table
    of core.rangeimage.unit_rays; the simulator casts along it, which makes
    the PackedFrame wire format exactly lossless on sim data)."""
    return unit_rays(model, dtype, device)


def render_scan(
    world: World,
    pose_start: Pose,
    pose_end: Pose,
    model: LidarModel,
    noise_std: float = 0.0,
    generator: torch.Generator | None = None,
) -> RangeImage:
    """Render one distorted sweep.

    Column j fires at s = j/C into the sweep, from pose interp(start, end, s);
    the returned xyz is in the *sensor frame at firing time* (what the device
    measures), gridded [R, C]. ``noise_std`` adds gaussian range noise drawn
    from ``generator`` (on the CPU, then moved to the world's device).
    """
    r, c = model.n_rings, model.n_cols
    dev = world.rect_center.device
    dirs_s = sensor_rays(model, device=dev)  # [R, C, 3]
    s = (torch.arange(c, dtype=torch.float32, device=dev) + 0.5) / c
    pose_cols = se3.interpolate(
        Pose(pose_start.q.expand(c, 4), pose_start.t.expand(c, 3)),
        Pose(pose_end.q.expand(c, 4), pose_end.t.expand(c, 3)),
        s,
    )
    d_world = rot.quat_rotate(pose_cols.q[None, :, :], dirs_s)  # [R, C, 3]
    o_world = pose_cols.t[None, :, :].expand(r, c, 3)
    t_hit = raycast(world, o_world.reshape(-1, 3), d_world.reshape(-1, 3))
    t_hit = t_hit.reshape(r, c)
    if noise_std > 0.0 and generator is not None:
        noise = torch.randn((r, c), generator=generator, dtype=torch.float32)
        t_hit = t_hit + noise_std * noise.to(dev)
    valid = (t_hit < model.max_range) & (t_hit > model.min_range)
    xyz = torch.where(valid[..., None], t_hit[..., None] * dirs_s, 0.0)
    return from_grid(xyz, valid)


class Trajectory(NamedTuple):
    """Smooth parametric trajectory: position/yaw as sums of sinusoids,
    optional roll/pitch wobble."""

    amp: torch.Tensor    # [K, 3] xyz amplitudes
    freq: torch.Tensor   # [K] rad/s
    phase: torch.Tensor  # [K, 3]
    yaw_rate: float
    wobble: float        # roll/pitch amplitude (rad); 0 = planar

    def pose(self, t) -> Pose:
        t = torch.as_tensor(t, dtype=torch.float32, device=self.amp.device)
        arg = self.freq[:, None] * t[..., None, None] + self.phase
        pos = torch.sum(self.amp * torch.sin(arg), dim=-2)
        z = 0.6 + 0.05 * torch.sum(torch.sin(arg[..., 2]), -1)
        pos = torch.cat([pos[..., :2], z[..., None]], -1)
        yaw = self.yaw_rate * t
        roll = self.wobble * torch.sin(1.7 * t + 0.3)
        pitch = self.wobble * torch.sin(2.3 * t + 1.1)
        zero = torch.zeros_like(yaw)
        q_yaw = rot.so3_exp_quat(torch.stack([zero, zero, yaw], -1))
        q_rp = rot.so3_exp_quat(torch.stack([roll, pitch, zero], -1))
        return Pose(rot.quat_multiply(q_yaw, q_rp), pos)


def make_trajectory(generator: torch.Generator, speed_scale: float = 1.0,
                    wobble: float = 0.0, device=None) -> Trajectory:
    device = resolve_device(device)
    amp = torch.tensor([[6.0, 4.0, 0.3], [1.5, 2.0, 0.2], [0.4, 0.3, 0.1]]) * speed_scale
    freq = torch.tensor([0.11, 0.31, 0.83])
    phase = _uniform(generator, (3, 3), 0.0, 2 * math.pi)
    yaw_rate = float(0.25 * speed_scale)
    return Trajectory(amp.to(device), freq.to(device), phase.to(device),
                      yaw_rate, wobble)


def make_loop_trajectory(radius: float = 7.0, period_s: float = 10.0,
                         wobble: float = 0.0, device=None) -> Trajectory:
    """Closed circular trajectory: one lap every ``period_s`` seconds, with
    heading tangent to the circle, so the sensor revisits every point each
    lap with matching yaw (the loop-closure course)."""
    device = resolve_device(device)
    om = 2.0 * math.pi / period_s
    amp = torch.tensor([[radius, radius, 0.0]], device=device)
    freq = torch.tensor([om], device=device)
    phase = torch.tensor([[math.pi / 2.0, 0.0, 0.0]], device=device)
    return Trajectory(amp, freq, phase, yaw_rate=float(om), wobble=wobble)


def make_straight_trajectory(speed: float = 2.0, wobble: float = 0.0,
                             device=None) -> Trajectory:
    """Constant-velocity straight line along +x (the corridor course): one
    very-low-frequency sinusoid whose sin is ~linear over the run."""
    device = resolve_device(device)
    om = 0.01
    amp = torch.tensor([[speed / om, 0.0, 0.0]], device=device)
    freq = torch.tensor([om], device=device)
    phase = torch.tensor([[0.0, math.pi / 2, 0.0]], device=device)
    return Trajectory(amp, freq, phase, yaw_rate=0.0, wobble=wobble)


def _with_cylinders(w: World, xyr: torch.Tensor, z: torch.Tensor,
                    present: torch.Tensor) -> World:
    """``w`` with K more vertical cylinders ([K, 3] x, y, radius; [K, 2] z
    range), present where ``present`` ([K] bool tensor) holds."""
    return w._replace(cyl_xyr=torch.cat([w.cyl_xyr, xyr]),
                      cyl_z=torch.cat([w.cyl_z, z]),
                      cyl_mask=torch.cat([w.cyl_mask, present]))


def render_sequence(
    world: World,
    traj: Trajectory,
    model: LidarModel,
    n_frames: int,
    extrinsic: Pose | None = None,
    t0: float = 0.0,
    device=None,
    noise_std: float = 0.0,
    noise_seed: int = 1234,
    companions: torch.Tensor | None = None,
    companion_z: torch.Tensor | None = None,
    companion_frames: tuple[int, int] | None = None,
    companion_period: tuple[int, int] | None = None,
    movers: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
):
    """Render n_frames sweeps for one lidar mounted at ``extrinsic``
    (base <- lidar), on ``device`` (the GPU unless the caller passes
    another). ``noise_std`` adds gaussian range noise; frame i draws it from
    a generator seeded by ``(noise_seed, i)``. Returns (RangeImage stacked
    [F, ...], gt base poses Pose[F] at sweep starts).

    ``companions`` [K, 3] (x, y, radius in the BASE frame) adds cylinders
    that move rigidly with the vehicle: their returns are static in the
    sensor frame, so scan matching reads them as "no motion".
    ``companion_z`` [K, 2] is each one's z range above the base (default
    0..2); ``companion_frames`` (start, stop) bounds their presence and
    ``companion_period`` (on, period) makes them bursts: present for the
    first ``on`` frames of every ``period``, counted from ``start``.

    ``movers`` = (xyr [K, 3], z [K, 2], vel [K, 2]): cylinders whose
    world-frame centres move at ``vel`` m/s from their initial positions
    (cross-traffic: the dynamic outliers the robust losses are for).

    Whether a companion is present in a frame is a tensor, computed from
    the frame index as the JAX package computes it (no host branch)."""
    device = resolve_device(device)
    world = World(*(x.to(device) for x in world))
    traj = traj._replace(amp=traj.amp.to(device), freq=traj.freq.to(device),
                         phase=traj.phase.to(device))
    if extrinsic is None:
        extrinsic = Pose.identity(device=device)
    if companions is not None:
        companions = companions.to(device, torch.float32)
        k = companions.shape[0]
        companion_z = (torch.tensor([0.0, 2.0], device=device).expand(k, 2)
                       if companion_z is None else companion_z.to(device, torch.float32))
        off = torch.cat([companions[:, :2], torch.zeros((k, 1), device=device)], -1)
    if movers is not None:
        movers = tuple(m.to(device, torch.float32) for m in movers)
    dt = model.scan_period
    imgs, poses = [], []
    with torch.no_grad():
        for i in range(n_frames):
            ts = t0 + i * dt
            base0 = traj.pose(ts)
            base1 = traj.pose(ts + dt)
            w = world
            if movers is not None:
                m_xyr, m_z, m_vel = movers
                pos = m_xyr[:, :2] + m_vel * (ts - t0)
                w = _with_cylinders(
                    w, torch.cat([pos, m_xyr[:, 2:3]], -1), m_z,
                    torch.ones(m_xyr.shape[0], dtype=torch.bool, device=device))
            if companions is not None:
                # centres ride the base pose (xy only: the cylinders stay
                # vertical; yaw turns the offset)
                ctr = rot.quat_rotate(base0.q[None], off) + base0.t[None]
                fi = torch.tensor(float(i), device=device)
                present = torch.ones((), dtype=torch.bool, device=device)
                start = 0
                if companion_frames is not None:
                    start = companion_frames[0]
                    present = (fi >= companion_frames[0]) & (fi < companion_frames[1])
                if companion_period is not None:
                    on, period = companion_period
                    present = present & (torch.remainder(fi - start, float(period)) < on)
                w = _with_cylinders(
                    w, torch.cat([ctr[:, :2], companions[:, 2:3]], -1),
                    companion_z + base0.t[2], present.expand(k))
            p0 = se3.compose(base0, extrinsic)
            p1 = se3.compose(base1, extrinsic)
            gen = (torch.Generator().manual_seed(frame_noise_seed(noise_seed, i))
                   if noise_std > 0.0 else None)
            imgs.append(render_scan(w, p0, p1, model, noise_std, gen))
            poses.append(base0)
    stacked = RangeImage(*(torch.stack(x) for x in zip(*imgs)))
    gt = Pose(torch.stack([p.q for p in poses]), torch.stack([p.t for p in poses]))
    return stacked, gt
