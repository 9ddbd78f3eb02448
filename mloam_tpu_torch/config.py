"""Typed configuration tree.

Replaces the reference's two-tier config system (gflags + yaml loaded via
cv::FileStorage into ~60 mutable globals, ``estimator/src/estimator/
parameters.cpp:123-294`` / ``parameters.h:45-134``) with one immutable
dataclass tree. Static fields (shapes, window sizes, iteration counts) fix
tensor capacities; runtime-tunable scalars (thresholds, resolutions) ride
along as ordinary floats. The tree is the port's own copy of the JAX
package's ``mloam_tpu/config.py`` — same classes, fields and defaults, so a
``dataclasses.asdict`` of either side rebuilds the other
(``utils/convert.config_from_reference``).

Per-platform presets live in ``mloam_tpu_torch/models/platforms.py``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

from mloam_tpu_torch.core.rangeimage import LidarModel


@dataclass(frozen=True)
class SegmenterConfig:
    """Range-image segmentation (reference image_segmenter.hpp params)."""

    ground_rows: int = 7            # rows scanned from the bottom for ground
    ground_angle_deg: float = 10.0  # max slope wrt horizontal to label ground
    segment_theta_deg: float = 60.0  # BFS angle gate (reference segmentTheta)
    min_cluster_size: int = 30
    min_line_num: int = 3           # keep small clusters spanning >= lines
    segment_valid_point_num: int = 5
    label_iters: int = 12           # label-propagation rounds (BFS replacement)


@dataclass(frozen=True)
class FeatureConfig:
    """Curvature feature extraction (reference feature_extract.cpp)."""

    n_sectors: int = 6
    curvature_half_window: int = 5
    edge_threshold: float = 0.1
    max_sharp: int = 2              # per sector
    max_less_sharp: int = 20        # per sector
    max_flat: int = 4               # per sector
    less_flat_leaf: float = 0.2     # voxel leaf for less-flat downsample
    # capacity of the downsampled less-flat set (others derive from
    # n_rings * n_sectors * max_*)
    cap_less_flat: int = 4096


@dataclass(frozen=True)
class TrackerConfig:
    """Scan-to-scan odometry (reference lidar_tracker.cpp)."""

    # one correspondence round (the reference runs 2, lidar_tracker.cpp:44;
    # our constant-velocity warm start makes the rebuild redundant —
    # ATE-neutral on gentle and aggressive motion, demos/ate_variants.py)
    outer_iters: int = 1
    gn_iters: int = 3
    huber_delta: float = 0.1
    # robust loss on the scan-to-scan factors: "huber" (reference default),
    # "gm" (GemanMcClureLoss), "gnc_gm" (graduated surrogate annealed to
    # GM across the GN iterations) — the reference's loss_mode/gnc launch
    # args (mloam_simu_jackal.launch:16-18, impl_loss_function.hpp:94-125).
    # Set on all three solvers at once via config.with_loss_mode().
    loss_mode: str = "huber"
    gm_c: float = 1.0                # GM scale on the SQUARED residual norm
    gnc_mu_init: float = 20.0        # reference test_icp.cpp:64 schedule seed
    dist_sq_threshold: float = 25.0
    nearby_scan: float = 2.5
    deskew: bool = True
    # Degeneracy solution-remapping in the scan-to-scan solve. The
    # reference wrote this for the tracker (lidar_tracker.cpp:131-163,
    # threshold 10) but ships it commented out (:108) — yet the tracker is
    # the FIRST solve on the prediction chain: spurious information that
    # corrupts the scan-to-scan motion (e.g. a companion object moving
    # with the vehicle in an otherwise-degenerate corridor) propagates
    # into the window seed, where the window's own remap can only freeze
    # the already-corrupted value. 0.0 disables (the reference's shipped
    # behavior); the calibrated default engages below the measured
    # corridor information floor while staying far under feature-rich
    # floors (results/corridor; calibration in the
    # models/experiments.py corridor program).
    eig_threshold: float = 0.0
    # frozen-direction purification as in OdometryConfig (only read when
    # eig_threshold > 0; the tracker's per-frame solve carries no
    # persistence state — it ships disabled, matching the reference)
    eig_snap_purity: float | None = 0.8
    # Steady-state fast path: skip the scan-to-scan solve once the window is
    # warm and use the constant-velocity prediction directly; the window GN
    # (scan-to-local-map, a strictly richer problem) refines the pose, and
    # the next prediction is read back off the refined window. The tracker
    # still runs during warm-up and whenever calibration needs per-lidar
    # motions (the reference's tracker also exists mainly to seed the
    # backend, estimator.cpp:423-430).
    skip_steady: bool = False


@dataclass(frozen=True)
class OdometryConfig:
    """Sliding-window backend (reference estimator.cpp)."""

    window_size: int = 6
    opt_window_size: int = 3
    # ATE-validated budget trims (demos/ate_variants.py: gentle + aggressive
    # synthetic motion, 2 seeds): 5->4, 4->3, then 3->2 all ATE-neutral
    # (gentle 0.92/0.82 identical, aggressive 4.22/4.02 vs 4.19/4.03); the
    # warm start from the previous marginalized window does most of the work
    gn_iters: int = 2
    # one correspondence round suffices: unlike the reference (Ceres starts
    # cold each frame, hence 2 rebuild rounds), the window is warm-started
    # from the previous marginalization; verified ATE-neutral on gentle and
    # aggressive synthetic motion
    outer_iters: int = 1
    max_solver_time_s: float = 0.02
    huber_delta: float = 0.1
    # robust loss on the window point factors (see TrackerConfig.loss_mode)
    loss_mode: str = "huber"
    gm_c: float = 1.0
    gnc_mu_init: float = 20.0
    corner_map_leaf: float = 0.2
    surf_map_leaf: float = 0.4
    dist_sq_threshold: float = 1.0   # MIN_MATCH_SQ_DIS
    # Window degeneracy threshold (the reference's eig_thre_ vector,
    # estimator.cpp:1598-1680, tuned PER PLATFORM CONFIG — and round 5
    # established by measurement that it MUST be: no statistic of the
    # measurement Hessian separates "corridor at noise 0.01" (remap must
    # engage; e0 113-156) from "noiseless turning course" (must stay
    # silent; e0 dips 14.7-207). Six gates were measured and ruled out —
    # absolute magnitude, eigengap e0/e1, temporal persistence (turn dips
    # run 42 consecutive frames), direction consistency (cos 0.998 on the
    # slow turn), direction purity (the turn's rotating weak direction
    # passes near canonical axes half the time), and support
    # concentration n_eff (corridor spurious info is noise-tilt spread
    # over ALL wall points: med 339 vs the turn's 117-1069). Record in
    # BENCH_NOTES "Round-5 degeneracy-gate investigation" +
    # demos/probe_{eig_gap,persistence,innovation,support}.py. Eigenvalue
    # magnitude measures HOW MUCH curvature, not WHERE IT COMES FROM.
    #
    # Consequently the DEFAULT ships DISARMED (0.0) — matching the
    # reference's shipped outdoor behavior (its tracker remap is
    # committed disabled, lidar_tracker.cpp:108, and its window
    # thresholds are per-platform yaml) — and the indoor/degenerate
    # operating point (platforms.indoor_degenerate) arms it at the
    # calibrated 175 with the round-5 harm-reduction stack: persistence +
    # purity gating, canonical-axis snapping, and projector-consistent
    # marginalization.
    eig_threshold: float = 0.0
    # Persistence gate: the remap engages only after eig_persist_k
    # consecutive window solves whose shared-mean e0 sits below
    # eig_threshold with a frame-to-frame-consistent weak direction
    # (|dot| > eig_persist_cos); any non-degenerate or
    # direction-inconsistent frame resets the run. Disengagement is
    # immediate. 0 = engage per-frame (the reference's rule).
    eig_persist_k: int = 5
    eig_persist_cos: float = 0.9
    # Support-concentration gate: engage only when the effective support
    # count of curvature along the weak direction,
    # n_eff = (Σ w_i (J_i·v0)²)² / Σ (w_i (J_i·v0)²)², sits BELOW this —
    # spurious information (companion/noise returns in a corridor) is
    # carried by a handful of correspondences, genuine sparse geometry by
    # hundreds. Calibrated via demos/probe_support.py; None disables.
    eig_support_neff: float | None = None
    # Frozen-direction purification: snap a frozen eigvector to the
    # canonical tangent axis it dominates when that component exceeds
    # this bound (degeneracy._projector_from) — removes the measured
    # ~0.3 z-impurity coupling of the corridor's frozen x direction
    # (round-4: ez_max 1.74 m ON vs 0.39 OFF). None disables.
    eig_snap_purity: float | None = 0.8
    # cap on frozen directions per block (degeneracy.block_projector):
    # 1 = freeze only the provably-degenerate leading direction; None =
    # the reference's freeze-all-below rule (safe only with a wide
    # eigengap).
    remap_max_freeze: int | None = 1
    # one SHARED projector across the window blocks (built from the mean
    # non-anchored block) instead of per-block projectors: per-block
    # eigvectors jitter block-to-block, freezing slightly different
    # directions per pose and corrupting RELATIVE window motion (measured:
    # 2.7 m rigid drift -> 7-19 m under per-block freezing; see
    # degeneracy.block_projector)
    remap_shared: bool = True
    # degeneracy-consistent marginalization: also project the MEASUREMENT
    # rows with the solve's eigprojector before Schur-eliminating the
    # pivot, so rejected (frozen-direction) gradients are not stored in
    # the prior — without this, every freezing variant measured WORSE
    # than no remap at all (the stored pull leaks through the frozen
    # vector's impurity into observable axes; see marginalize_pivot)
    remap_project_prior: bool = True
    gauge_weight: float = 30.0       # weak absolute anchor on the pivot pose
    # good-feature selection inside the window solve (the reference's
    # goodFeatureMatching runs in optimizeMap's pure-odometry branch,
    # estimator.cpp:789-848 + 1347-1517): keep ratio over the matched
    # correspondences, selected by logdet gain (gd). 1.0 = all features.
    gf_ratio: float = 1.0
    gf_method: str = "gd"            # gd | rnd | fps (used when gf_ratio < 1)
    # compact the selected correspondences into ~ratio-sized buffers so
    # gf_ratio < 1 shrinks the GN residual/Gram shapes (on-chip ms), not
    # just zero-weights rows — the reference's gf exists to buy solver
    # time (estimator.cpp:1347-1517, 7 ms budget)
    gf_compact: bool = True
    # per-frame feature capacities inside the window stacks
    cap_frame_corner: int = 1024
    cap_frame_surf: int = 2048
    # sort-free compaction bounds (per lidar) applied to the stacked window
    # clouds BEFORE the local-map voxel sort — the argsort over
    # (window_size)*(cap_frame_*) rows is the single most expensive op of the
    # window step; the stacks are typically sparse (masked). Exact whenever
    # the valid count fits; even-stride subsample otherwise. None disables.
    localmap_precap_corner: int | None = 2048
    localmap_precap_surf: int | None = 10240


@dataclass(frozen=True)
class CalibConfig:
    """Online extrinsic calibration (reference initial_extrinsics.cpp +
    estimator.cpp calib branch)."""

    n_pose_buffer: int = 300
    pair_stride: int = 3             # compose tracker motions over K sweeps
    screw_rot_epsilon: float = 0.05
    screw_trans_epsilon: float = 0.1
    rot_converge_sv: float = 0.25    # 2nd-smallest singular value gate
    planar: bool = False
    n_calib_samples: int = 25
    lambda_threshold: float = 70.0   # per-frame calib observability gate
    n_cumu_frames: int = 10          # accumulate frames per calib factor batch


@dataclass(frozen=True)
class MappingConfig:
    """Keyframe mapping backend (reference lidar_mapper_keyframe.cpp)."""

    skip_frames: int = 2             # run mapping every Nth sweep (SKIP_NUM_ODOM_PUB)
    corner_leaf: float = 0.2
    surf_leaf: float = 0.4
    outlier_leaf: float = 0.8
    keyframe_leaf: float = 1.0
    surround_radius: float = 50.0
    # rebuild the cached assembled surround map after moving this far from
    # the assembly center (it also rebuilds on every keyframe insertion);
    # small vs surround_radius, so staleness only trims the far fringe
    surround_rebuild_dist: float = 5.0
    # sort-free compaction bounds (per lidar) for the stacked surround
    # clouds before the assembly voxel sort (same trick as the window's
    # localmap_precap_*): corner stacks are ~90+% padding; surf runs fuller,
    # so its bound is generous. None disables.
    surround_precap_corner: int | None = 8192
    surround_precap_surf: int | None = 65536
    keyframe_dist: float = 1.0
    keyframe_angle_deg: float = 1.0
    outer_iters: int = 2
    gn_iters: int = 10
    # robust loss on the scan-to-map factors (see TrackerConfig.loss_mode)
    loss_mode: str = "huber"
    gm_c: float = 1.0
    gnc_mu_init: float = 20.0
    # mapper-side MAP_EIG_THRE (lidar_mapper_keyframe.cpp:1172-1204) with
    # the same gate semantics as the window's (see OdometryConfig: the
    # default ships DISARMED; platforms.indoor_degenerate arms it) — and
    # its OWN remap knobs/huber delta (round-4 advisor: the mapper read
    # cfg.odometry's, so tuning the odometry remap silently changed
    # mapper behavior)
    eig_threshold: float = 0.0
    # persistence in MAPPER steps (the mapper runs every skip_frames
    # sweeps, so the same wall-clock persistence needs fewer steps)
    eig_persist_k: int = 3
    eig_persist_cos: float = 0.9
    eig_snap_purity: float | None = 0.8
    remap_max_freeze: int | None = 1
    huber_delta: float = 0.1
    trace_threshold: float = 10.0    # reject points with cov trace above
    voxel_trace_threshold: float = 2.0
    max_keyframes: int = 512
    cap_map_corner: int = 32768
    cap_map_surf: int = 65536
    # outlier cloud (segmentation rejects) carried as a third feature class
    # into keyframes for map completeness (reference /laser_cloud_outlier)
    cap_frame_outlier: int = 1024
    gf_method: str = "full"          # full | rnd | fps | gd | gd_float
    gf_ratio: float = 1.0
    # gd_float (lidar_mapper_keyframe.cpp:482-492): when the full-Hessian
    # logdet drops below this degeneracy threshold, back off the keep ratio
    # to ``gf_ratio_degraded`` (keep more features where geometry is weak)
    map_deg_threshold: float = 100.0
    gf_ratio_degraded: float = 0.8
    # prior extrinsic covariance diag [rho;phi] applied to non-reference
    # lidars when no calibrated covariance is available (the reference's
    # uct_ext yaml block * uct_ext_ratio, parameters.cpp:276-283); the
    # calibrated covariance installed at the 1->0 freeze overrides it
    ext_cov_prior_diag: tuple[float, ...] | None = None
    uct_ext_ratio: float = 1.0


@dataclass(frozen=True)
class LoopConfig:
    """Loop closure (reference mloam_loop)."""

    sc_num_rings: int = 20
    sc_num_sectors: int = 60
    sc_max_radius: float = 80.0
    sc_dist_threshold: float = 0.13
    num_exclude_recent: int = 50
    num_candidates: int = 10
    loop_distance_threshold: float = 30.0
    history_search_num: int = 25
    skip_interval: int = 5
    pgo_gn_iters: int = 10
    capacity: int = 256              # keyframe slots in the loop graph
    max_loop_edges: int = 128        # loop-edge slots (overflow drops)
    # 4-DoF PGO (the reference's FourDOFError variants,
    # pose_graph.h:199-289): optimize (x, y, z, yaw) only, roll/pitch held
    # at their odometry estimates. False = full 6-DoF edges.
    dof4: bool = False
    # priorless global registration (FFT yaw-sweep correlation) as a second
    # seed for geometric verification — covers loops whose odometry drift
    # exceeds the pose-seeded convergence basin (the reference's FGR role)
    use_global_registration: bool = True
    # temporal consistency: require N detections implying the same drift
    # correction before accepting (reference checkTemporalConsistency,
    # pose_graph.cpp:330-361, is a disabled stub; 1 = accept immediately)
    temporal_consistency_n: int = 1
    temporal_consistency_tol: float = 2.0   # meters between implied corrections


@dataclass(frozen=True)
class LidarRig:
    """Multi-LiDAR rig: sensor models + extrinsic priors (base <- lidar i).

    ``extrinsic_mode`` mirrors the reference ESTIMATE_EXTRINSIC:
      2 = no prior, full online calibration; 1 = refine a rough prior;
      0 = extrinsics fixed.
    """

    models: tuple[LidarModel, ...] = (LidarModel(),)
    extrinsic_mode: int = 0

    @property
    def n_lidars(self) -> int:
        return len(self.models)


@dataclass(frozen=True)
class MloamConfig:
    rig: LidarRig = field(default_factory=LidarRig)
    segmenter: SegmenterConfig = field(default_factory=SegmenterConfig)
    features: FeatureConfig = field(default_factory=FeatureConfig)
    tracker: TrackerConfig = field(default_factory=TrackerConfig)
    odometry: OdometryConfig = field(default_factory=OdometryConfig)
    calib: CalibConfig = field(default_factory=CalibConfig)
    mapping: MappingConfig = field(default_factory=MappingConfig)
    loop: LoopConfig = field(default_factory=LoopConfig)

    def replace(self, **kw) -> "MloamConfig":
        return dataclasses.replace(self, **kw)


def with_loss_mode(cfg: MloamConfig, mode: str,
                   gm_c: float | None = None) -> MloamConfig:
    """Set the robust loss on all three point-factor solvers at once — the
    counterpart of the reference's single loss_mode/gnc launch-arg pair
    (``estimator/launch/mloam_simu_jackal.launch:16-18``)."""
    kw = {"loss_mode": mode}
    if gm_c is not None:
        kw["gm_c"] = gm_c
    return dataclasses.replace(
        cfg,
        tracker=dataclasses.replace(cfg.tracker, **kw),
        odometry=dataclasses.replace(cfg.odometry, **kw),
        mapping=dataclasses.replace(cfg.mapping, **kw),
    )
